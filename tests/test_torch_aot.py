"""AOT export of the torch port (paddle_tpu_torch/io/aot.py): the pruned
inference program exported through ``torch.export`` to
``__compiled__.pt2`` with one symbolic batch dimension, K1 as the
custom operator ``torch.ops.paddle_tpu_torch.flash_fwd`` inside the
graph, and ``CompiledPredictor`` running it without the Program IR.

On the CPU the operator runs K1's plain version, so the predictor's
answers equal the serving engine's at the f32 serving tier (rtol 1e-4 /
atol 1e-4, tests/test_torch_llama_serving.py's), at batch 1 — which
``torch.export`` would have specialized had the example been 1 — and at
other batch sizes.
"""
import ast
import dataclasses
import inspect
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.io import aot
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models import transformer as ttf
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.resilience.checkpoint import ChecksumMismatch
from paddle_tpu_torch.serving import BucketSpec, ServingEngine

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
SEQ = 16
HD64 = dict(d_model=128, n_head=2, n_encoder_layers=2, n_decoder_layers=2,
            d_ff=256)


def _saved_transformer(d):
    """A head-dim-64 Transformer (the kernels' D on the card) with
    lengths, its startup run, saved for inference with buckets."""
    import dataclasses
    cfg = dataclasses.replace(ttf.TRANSFORMER_TINY, **HD64)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        data = lambda n, shape: tfluid.layers.data(  # noqa: E731
            name=n, shape=shape, dtype="int64", append_batch_size=False)
        src, tgt = data("src", [-1, SEQ]), data("tgt", [-1, SEQ])
        logits, _ = ttf.build_transformer(
            cfg, src, tgt, None, src_lengths=data("src_len", [-1]))
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        tfluid.io.save_inference_model(
            d, ["src", "tgt", "src_len"], [logits], exe,
            main_program=main.clone(for_test=True),
            serving_buckets=BucketSpec(batch_sizes=(1, 2, 4)))
    return cfg


def _tf_feed(b, seed):
    r = np.random.RandomState(seed)
    return {"src": r.randint(0, 64, (b, SEQ)).astype(np.int64),
            "tgt": r.randint(0, 64, (b, SEQ)).astype(np.int64),
            "src_len": r.randint(1, SEQ + 1, (b,)).astype(np.int64)}


@pytest.fixture(scope="module")
def transformer_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("aot") / "tf")
    _saved_transformer(d)
    return d


@pytest.mark.parametrize("batch", [1, 3, 4])
def test_predictor_equals_the_engine(transformer_dir, batch):
    pred = aot.load_compiled_predictor(transformer_dir, device="cpu")
    eng = ServingEngine.from_saved_model(transformer_dir,
                                         place=tfluid.CPUPlace())
    try:
        feed = _tf_feed(batch, 10 + batch)
        want = np.concatenate([eng.infer({k: v[i:i + 1]
                                          for k, v in feed.items()})[0]
                               for i in range(batch)])
        got = pred.run(feed)
        assert len(got) == 1 and got[0].shape == (batch, SEQ, 64)
        np.testing.assert_allclose(got[0], want, **TOL)
        t = pred.run(feed, return_numpy=False)[0]
        assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(),
                                                              got[0])
    finally:
        eng.close()


def test_artifact_layout_and_meta(transformer_dir):
    files = set(os.listdir(transformer_dir))
    assert {"__compiled__.pt2", "__compiled_meta__.json", "params.npz",
            "__params_manifest__.json", "__model__.json",
            "__meta__.json"} <= files
    meta = json.load(open(os.path.join(transformer_dir,
                                       "__compiled_meta__.json")))
    assert [s["name"] for s in meta["feed_specs"]] == ["src", "tgt",
                                                       "src_len"]
    assert meta["device"] == "cpu"
    # the graph alone: torch.export.save's example inputs (here the
    # parameters) are not written into the artifact
    assert os.path.getsize(os.path.join(transformer_dir,
                                        "__compiled__.pt2")) < \
        os.path.getsize(os.path.join(transformer_dir, "params.npz")) / 4
    assert meta["param_names"] == sorted(meta["param_names"])
    assert set(meta["param_dtypes"]) == {"float32"}
    pred = aot.CompiledPredictor(transformer_dir, device="cpu")
    assert pred.feed_names == ["src", "tgt", "src_len"]
    assert pred.fetch_names == meta["fetch_names"]
    with pytest.raises(KeyError, match="missing feed 'src_len'"):
        pred.run({"src": np.zeros((1, SEQ), np.int64),
                  "tgt": np.zeros((1, SEQ), np.int64)})


def test_k1_is_one_custom_op_node_of_the_graph(transformer_dir):
    """The exported graph calls K1 through its operator: one node per
    causal decoder self-attention (the padded encoder and cross
    attention take the biased matmul path)."""
    ep = torch.export.load(os.path.join(transformer_dir, "__compiled__.pt2"))
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    k1 = torch.ops.paddle_tpu_torch.flash_fwd.default
    assert targets.count(k1) == HD64["n_decoder_layers"]
    # the batch is one symbol shared by the three feeds
    feeds = [n for n in ep.graph.nodes if n.op == "placeholder"][-3:]
    dims = {str(n.meta["val"].shape[0]) for n in feeds}
    assert len(dims) == 1 and not dims.pop().isdigit()


def test_custom_op_fake_shapes_and_opcheck():
    q = torch.randn(6, 5, 64)
    k, v = torch.randn(6, 7, 64), torch.randn(6, 7, 64)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(x) for x in (q, k, v))
        o, lse = fa.flash_fwd_op(fq, fk, fv, 0.125, True)
        assert o.shape == (6, 5, 64) and o.dtype == torch.float32
        assert lse.shape == (6, 5) and lse.dtype == torch.float32
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd_op(q, k, v, 0.125, True)
    want = fa.ref_attention_lse(q, k, v, 0.125, True)
    assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
    # a CPU tensor runs the plain version: no kernel launch to count
    assert fa.flash_fwd.launches == 0
    torch.library.opcheck(fa.flash_fwd_op, (q, k, v, 0.125, True),
                          test_utils=("test_schema", "test_faketensor"))


def test_attention_without_gradient_calls_the_operator(monkeypatch):
    """With a gradient or without one, attention runs FlashAttention,
    whose forward calls the operator (what an exported graph records);
    with one its backward runs K2/K3 — the same forward values either
    way."""
    calls = []
    real = fa.flash_fwd_op

    def spy(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(fa, "flash_fwd_op", spy)
    q, k, v = (torch.randn(2, 2, 8, 64) for _ in range(3))
    with torch.no_grad():
        o1 = fa.flash_attention(q, k, v, causal=True)
    qg = q.clone().requires_grad_()
    o2 = fa.flash_attention(qg, k, v, causal=True)
    o2.sum().backward()
    assert len(calls) == 2 and torch.equal(o1, o2.detach())
    assert qg.grad is not None


def test_exported_graph_hands_k1_contiguous_inputs(transformer_dir,
                                                   monkeypatch):
    """The predictor's graph gives K1's operator inputs the kernels take
    as they are at batch 1 and 3 (exported at 2): the operator copies
    none. The kernel route is stood in for on the CPU by the plain
    version, so the operator's copy counter is what it is on the card."""
    seen = []

    class Kernel:
        input_copies = 0
        launches_by_kernel = {}

        def __call__(self, q, k, v, scale, causal):
            seen.append(tuple(x.shape for x in (q, k, v)))
            return fa.ref_attention_lse(q, k, v, scale, causal)

    kern = Kernel()
    monkeypatch.setattr(fa, "takes_kernels", lambda q: True)
    monkeypatch.setattr(fa, "flash_fwd", kern)
    pred = aot.load_compiled_predictor(transformer_dir, device="cpu")
    for b in (1, 3):
        pred.run(_tf_feed(b, 30 + b))
    assert {s[0][0] for s in seen} == {2, 6}     # B*H, two heads
    assert kern.input_copies == 0


def test_llama_predictor_any_batch_and_length(tmp_path):
    """LLAMA_TINY's [-1, -1] token feed: one artifact serves several
    batch sizes and lengths, equal to the executor on the same scope."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        tokens = tfluid.layers.data(name="tokens", shape=[-1, -1],
                                    dtype="int64", append_batch_size=False)
        logits, _ = tllama.build_llama(tllama.LLAMA_TINY, tokens)
    infer = main.clone(for_test=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    d = str(tmp_path / "llama")
    with tfluid.scope_guard(scope):
        exe.run(startup)
        tfluid.io.save_inference_model(d, ["tokens"], [logits], exe,
                                       main_program=infer)
        pred = aot.load_compiled_predictor(d, device="cpu")
        for b, t in ((1, 5), (3, 9), (2, 16)):
            tok = np.random.RandomState(b * t).randint(0, 256, (b, t))
            want = exe.run(infer, feed={"tokens": tok},
                           fetch_list=[logits])[0]
            np.testing.assert_allclose(pred.run({"tokens": tok})[0], want,
                                       **TOL)


def test_jax_export_is_refused_by_name_and_its_json_path_loads(tmp_path):
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        x = jfluid.layers.data(name="x", shape=[4])
        y = jfluid.layers.fc(x, size=2)
    exe = jfluid.Executor(jfluid.CPUPlace())
    d = str(tmp_path / "jax")
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        jfluid.io.save_inference_model(d, ["x"], [y], exe, main_program=main)
    assert os.path.exists(os.path.join(d, "__compiled__.stablehlo"))
    with pytest.raises(ValueError, match="JAX export"):
        aot.load_compiled_predictor(d, device="cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        prog, feeds, fetch = tfluid.io.load_inference_model(d, texe)
        out = texe.run(prog, feed={"x": np.ones((2, 4), np.float32)},
                       fetch_list=fetch)[0]
    assert out.shape == (2, 2)


def test_torn_params_are_quarantined(tmp_path):
    d = str(tmp_path / "m")
    _saved_transformer(d)
    with open(os.path.join(d, "params.npz"), "r+b") as f:
        f.seek(-10, os.SEEK_END)
        f.write(b"\x00" * 4)
    with pytest.raises(ChecksumMismatch, match="quarantined"):
        aot.CompiledPredictor(d, device="cpu")
    assert os.listdir(os.path.join(d, "quarantine"))


def test_predictor_needs_no_program_ir():
    """CompiledPredictor's code names no Program IR, registry or lowering
    (the reference's point: io.cc loads, the predictor runs)."""
    src = inspect.getsource(aot.CompiledPredictor)
    names = {n.id for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Name)} | {
        n.attr for n in ast.walk(ast.parse(src))
        if isinstance(n, ast.Attribute)}
    assert not names & {"framework", "registry", "lowering",
                        "lower_program", "Program", "get_op"}


GEN_CFG = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
               ffn_hidden=64, dtype="float32")


def _gen_program(build, prompt_len, **kw):
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(prog, startup):
        ptok = tfluid.layers.data(name="ptok", shape=[-1, prompt_len],
                                  dtype="int64", append_batch_size=False)
        out = build(ptok, **kw)
    return prog, startup, out


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_aot_exports_llama_generator(tmp_path, quant):
    """The generator program (prefill and the decode loop, int8 weights
    too) exports with no warning, and the predictor's greedy tokens
    equal the executor's (reference tests/test_aot_export.py:260)."""
    import warnings
    cfg = tllama.LlamaConfig(**GEN_CFG)
    prompt_len, new = 6, 5
    prog, startup, out = _gen_program(
        lambda p, **kw: tllama.build_llama_generator(cfg, p, **kw),
        prompt_len, max_new_tokens=new, quantize=quant)
    d = str(tmp_path / ("gen_int8" if quant else "gen_f32"))
    exe = tfluid.Executor(tfluid.CPUPlace())
    prompt = (np.arange(2 * prompt_len).reshape(2, prompt_len)
              % (cfg.vocab_size - 4)).astype(np.int64)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        if quant:
            tllama.quantize_generator_weights()
        want = exe.run(prog, feed={"ptok": prompt}, fetch_list=[out],
                       mode="test")[0]
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            tfluid.io.save_inference_model(d, ["ptok"], [out], exe,
                                           main_program=prog)
    got = aot.load_compiled_predictor(d, device="cpu").run(
        {"ptok": prompt})[0]
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, prompt_len + new)


def test_spec_decode_aot_exports(tmp_path):
    """The greedy speculative program (two caches, a bounded round loop)
    exports with no warning — greedy draws nothing — and the predictor
    reproduces the executor's tokens (reference
    tests/test_spec_decode.py:169)."""
    import warnings
    target = tllama.LlamaConfig(**dict(GEN_CFG, vocab_size=97))
    draft = tllama.LlamaConfig(vocab_size=97, dim=16, n_layers=1,
                               n_heads=2, n_kv_heads=1, ffn_hidden=32,
                               dtype="float32")
    prog, startup, out = _gen_program(
        lambda p, **kw: tllama.build_llama_spec_generator(target, draft, p,
                                                          **kw),
        7, max_new_tokens=5, gamma=2)
    d = str(tmp_path / "spec_model")
    exe = tfluid.Executor(tfluid.CPUPlace())
    prompt = (np.arange(14).reshape(2, 7) % 94).astype(np.int64)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        want = exe.run(prog, feed={"ptok": prompt}, fetch_list=[out],
                       mode="test")[0]
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            tfluid.io.save_inference_model(d, ["ptok"], [out], exe,
                                           main_program=prog)
    got = aot.load_compiled_predictor(d, device="cpu").run(
        {"ptok": prompt})[0]
    np.testing.assert_array_equal(got, want)


def test_sampled_spec_aot_export_warns_fixed_seed(tmp_path):
    """Exporting a SAMPLED speculative program warns that the graph uses
    one fixed seed, naming the op (reference
    tests/test_spec_decode.py:521); a greedy one does not (above)."""
    import warnings
    tiny = tllama.LlamaConfig(vocab_size=24, dim=16, n_layers=1, n_heads=2,
                              n_kv_heads=1, ffn_hidden=32, dtype="float32")
    small = dataclasses.replace(tiny, dim=8, ffn_hidden=16)
    prog, startup, out = _gen_program(
        lambda p, **kw: tllama.build_llama_spec_generator(tiny, small, p,
                                                          **kw),
        7, max_new_tokens=4, gamma=2, temperature=0.9)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tfluid.io.save_inference_model(str(tmp_path / "m"), ["ptok"],
                                           [out], exe, main_program=prog)
    msgs = [str(x.message) for x in w]
    assert any("FIXED seed" in m and "llama_spec_generate" in m
               for m in msgs), msgs
