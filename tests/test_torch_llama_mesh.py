"""The port's Llama under a device mesh and its MoE generation, held to
the mesh and MoE cases of tests/test_llama_generate.py (257-590) and the
unsharded program.

The sharded cases run on 4 gloo ranks (one spawned group for the
module, with its own timeout): build_llama(shard_dp, shard_tp) on a
dp x tp = 2 x 2 mesh against the unsharded program (losses rtol 2e-3 /
atol 2e-4, float32; the trained weights, read back as global values,
at the same tolerance), dp x tp generation and W8A8 generation on a dp mesh
token-for-token equal to the single device. MoE generation is held to
the eval forward (tokens exact) and W8A8 MoE to float MoE (the
reference's >= 0.9 agreement) on one device.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.models.llama import (LlamaConfig, build_llama,
                                           build_llama_generator,
                                           quantize_generator_weights,
                                           stack_generator_weights)
from torch_mesh_ranks import shared_ranks

PROMPT, NEW = 6, 5
MCFG = LlamaConfig(vocab_size=64, dim=32, n_layers=2, n_heads=4,
                   n_kv_heads=2, ffn_hidden=48, dtype="float32",
                   moe_experts=4, moe_top_k=2)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return shared_ranks("torch_mesh_cases", "llama_mesh_cases", 4,
                        tmp_path_factory, timeout=180)


def test_shard_dp_tp_steps_match_unsharded(cases):
    np.testing.assert_allclose(cases["llama_ref"], cases["llama_dp_tp"],
                               rtol=2e-3, atol=2e-4)
    for k, v in cases["llama_trained"].items():
        np.testing.assert_allclose(v, cases["llama_trained_ref"][k],
                                   rtol=2e-3, atol=2e-4, err_msg=k)


def test_megatron_placements_and_collectives(cases):
    """wq column-split, wo row-split, the embedding's columns split and
    the Adam moments on their parameter's split; the step all-reduces."""
    pl = cases["llama_tp_placements"]
    assert pl["l0.wq"] == ["R", "S(1)"] and pl["l0.wo"] == ["R", "S(0)"]
    assert pl["tok_emb"] == ["R", "S(1)"]
    assert pl["l0.wq_moment1_0"] == ["R", "S(1)"]
    st = cases["llama_stats"]
    assert st["mesh"] == {"dp": 2, "tp": 2}
    assert st["collectives"].get("all-reduce", 0) > 0


def test_tp_attention_runs_on_local_heads(cases):
    """q, k and v reach attention split on batch (dp) and heads (tp), so
    attention runs on each rank's own heads: nothing gathers them."""
    seen = cases["attention_placements"]
    assert len(seen) == 2 * 3            # 2 layers x 3 steps
    for qkv in seen:
        assert qkv == [["S(0)", "S(2)"]] * 3, qkv


def test_generation_tp_dp_sharded_matches_single_device(cases):
    """Each rank keeps its heads and its column/row blocks of the stacked
    weights; the row-split products are all-reduced over tp."""
    np.testing.assert_array_equal(cases["gen_dp_tp"], cases["gen_ref"])
    assert cases["gen_stats"].get("all-reduce", 0) > 0


def test_quantized_generation_on_dp_mesh(cases):
    np.testing.assert_array_equal(cases["qgen_dp"], cases["qgen_ref"])


def _moe_programs():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tokens = fluid.layers.data(name="tokens", shape=[-1, 16],
                                   dtype="int64", append_batch_size=False)
        targets = fluid.layers.data(name="targets", shape=[-1, 16],
                                    dtype="int64", append_batch_size=False)
        _, loss = build_llama(MCFG, tokens, targets)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    fwd_p = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(fwd_p,
                                                        fluid.Program()):
        ftok = fluid.layers.data(name="ftok", shape=[-1, -1],
                                 dtype="int64", append_batch_size=False)
        logits, _ = build_llama(MCFG, ftok, None)
    gens = []
    for kw in ({}, {"quantize": True}):
        gen_p = fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(gen_p,
                                                            fluid.Program()):
            ptok = fluid.layers.data(name="ptok", shape=[-1, PROMPT],
                                     dtype="int64", append_batch_size=False)
            gens.append((gen_p, build_llama_generator(
                MCFG, ptok, max_new_tokens=NEW, **kw)))
    return main, startup, loss, fwd_p, logits, gens


def _train(main, startup, loss, steps, seed):
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        toks = rng.randint(0, MCFG.vocab_size, (4, 16)).astype(np.int64)
        exe.run(main, feed={"tokens": toks, "targets": np.roll(toks, -1, 1)},
                fetch_list=[loss], scope=scope)
    return exe, scope, rng


def test_moe_generation_matches_eval_forward():
    """Per-layer MoE weights stacked by stack_generator_weights: KV-cache
    decoding emits the tokens of greedy full recompute through the
    training program in test mode (both drop-free)."""
    main, startup, loss, fwd_p, logits, gens = _moe_programs()
    exe, scope, rng = _train(main, startup, loss, 4, 7)
    prompt = rng.randint(0, MCFG.vocab_size, (3, PROMPT)).astype(np.int64)
    seq = prompt.copy()
    for _ in range(NEW):
        lg = exe.run(fwd_p, feed={"ftok": seq}, fetch_list=[logits],
                     mode="test", scope=scope)[0]
        seq = np.concatenate([seq, lg[:, -1, :].argmax(-1)[:, None]], 1)
    stack_generator_weights(MCFG, scope)
    gen_p, gen_out = gens[0]
    got = exe.run(gen_p, feed={"ptok": prompt}, fetch_list=[gen_out],
                  mode="test", scope=scope)[0]
    np.testing.assert_array_equal(got, seq)


def test_moe_quantized_generation_close_to_float():
    """W8A8 MoE: per-expert x output-channel int8 stacks (router float)
    agree with the float MoE generator on >= 90% of tokens."""
    main, startup, loss, _, _, gens = _moe_programs()
    exe, scope, rng = _train(main, startup, loss, 20, 5)
    prompt = rng.randint(0, MCFG.vocab_size, (6, PROMPT)).astype(np.int64)
    stack_generator_weights(MCFG, scope)
    (gen_p, gen_out), (qgen_p, qgen_out) = gens
    ref = exe.run(gen_p, feed={"ptok": prompt}, fetch_list=[gen_out],
                  mode="test", scope=scope)[0]
    quantize_generator_weights(scope)
    wq = scope.find_var("blocks.moe_w_gate")
    assert wq.dtype == torch.int8 and wq.dim() == 4
    assert tuple(scope.find_var("blocks.moe_w_gate@scale").shape) == \
        (2, 4, 1, 48)
    assert scope.find_var("blocks.moe_router").dtype == torch.float32
    got = exe.run(qgen_p, feed={"ptok": prompt}, fetch_list=[qgen_out],
                  mode="test", scope=scope)[0]
    np.testing.assert_array_equal(got[:, :PROMPT], prompt)
    agree = (got == ref).mean()
    assert agree >= 0.9, (agree, got, ref)
