"""The HuggingFace Llama importer (``models/llama_import.py``) on the
CPU: the cases of tests/test_llama_hf_parity.py. A random tiny
``transformers.LlamaForCausalLM`` (built locally, nothing downloaded) is
imported into the port's stacked scope layout; the port's logits match
transformers' at the reference test's tolerance (atol 2e-4, rtol 2e-3:
the same float32 math summed in another order), its greedy generation
equals ``model.generate``'s tokens, and the port's scope equals the JAX
package's import of the same state dict.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models.llama import (LlamaConfig, build_llama,
                                           build_llama_generator)
from paddle_tpu_torch.models.llama_import import load_hf_llama_state

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

DIM, LAYERS, HEADS, KV, FFN, VOCAB, SEQ = 64, 2, 4, 2, 128, 96, 10


def _hf_model():
    hf_cfg = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=DIM, intermediate_size=FFN,
        num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        num_key_value_heads=KV, max_position_embeddings=64,
        rms_norm_eps=1e-6, rope_theta=10000.0, attention_bias=False,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg)
    model.eval()
    return model


def _cfg():
    return LlamaConfig(vocab_size=VOCAB, dim=DIM, n_layers=LAYERS,
                       n_heads=HEADS, n_kv_heads=KV, ffn_hidden=FFN,
                       rope_base=10000.0, norm_eps=1e-6, dtype="float32")


def test_imported_hf_weights_match_logits():
    model = _hf_model()
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(prog, startup):
        toks = tfluid.layers.data(name="toks", shape=[-1, SEQ],
                                  dtype="int64", append_batch_size=False)
        logits, _ = build_llama(_cfg(), toks, None, shard_pp=True)
    scope = tfluid.Scope()
    ids = np.random.RandomState(0).randint(0, VOCAB, (3, SEQ))
    load_hf_llama_state(model.state_dict(), _cfg(), scope)
    ours = tfluid.Executor(tfluid.CPUPlace()).run(
        prog, feed={"toks": ids.astype(np.int64)}, fetch_list=[logits],
        scope=scope, mode="test")[0]
    with torch.no_grad():
        theirs = model(torch.tensor(ids)).logits.float().numpy()
    assert ours.shape == theirs.shape == (3, SEQ, VOCAB)
    np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=2e-3)


def test_imported_weights_generate_like_hf_greedy():
    model = _hf_model()
    prompt_len, new = 6, 6
    gen_p = tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(gen_p,
                                                          tfluid.Program()):
        ptok = tfluid.layers.data(name="ptok", shape=[-1, prompt_len],
                                  dtype="int64", append_batch_size=False)
        gen_out = build_llama_generator(_cfg(), ptok, max_new_tokens=new)
    scope = tfluid.Scope()
    prompt = np.random.RandomState(1).randint(0, VOCAB, (2, prompt_len))
    load_hf_llama_state(model.state_dict(), _cfg(), scope)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        gen_p, feed={"ptok": prompt.astype(np.int64)}, fetch_list=[gen_out],
        scope=scope, mode="test")[0]
    with torch.no_grad():
        hf = model.generate(torch.tensor(prompt), max_new_tokens=new,
                            do_sample=False, use_cache=True,
                            pad_token_id=0).numpy()
    np.testing.assert_array_equal(got, hf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_import_equals_reference_import(dtype):
    """The port's scope (tensors in ``dtype``) holds the JAX package's
    import of the same state dict bit for bit; a shape the config does
    not expect raises, as in the reference."""
    from paddle_tpu import Scope as JScope
    from paddle_tpu.models import llama as jllama
    from paddle_tpu.models.llama_import import load_hf_llama_state as jload
    model = _hf_model()
    sd = model.state_dict()
    jscope, scope = JScope(), tfluid.Scope()
    jload(sd, jllama.LlamaConfig(**vars(_cfg())), jscope, dtype=dtype)
    load_hf_llama_state(sd, _cfg(), scope, dtype=dtype)
    assert sorted(scope.keys()) == sorted(jscope.keys())
    for n in scope.keys():
        t = scope.find_var(n)
        assert str(t.dtype) == f"torch.{dtype}"
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(jscope.find_var(n), np.float32))
    bad = LlamaConfig(**dict(vars(_cfg()), ffn_hidden=FFN * 2))
    with pytest.raises(ValueError, match="expected"):
        load_hf_llama_state(sd, bad, tfluid.Scope())
