"""The port's MoE FFNs (ops/moe.py), held to the reference's functions
on the same numpy inputs and to the cases of tests/test_moe.py.

Tolerances: combine and dispatch tensors exact, gate positions and
routes integer-exact, float32 outputs within 2e-4 of the reference (and
of the dense per-token reference); the dp x ep sharded step (4 gloo
ranks, one spawned group with its own timeout) matches the single
device's losses to rtol 2e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu_torch as fluid
from paddle_tpu.ops import moe as jmoe
from paddle_tpu_torch.layers import transformer as tfl
from paddle_tpu_torch.ops import moe as tmoe
from torch_mesh_ranks import shared_ranks

T, D, E, H, K = 48, 16, 4, 24, 2


def _silu(x):
    return x * (1.0 / (1.0 + np.exp(-x)))


def _dense_reference(x, wg, w_up, w_gate, w_down, top_k):
    """Per-token dense MoE (no capacity limit) in numpy."""
    t, d = x.shape
    logits = x @ wg
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    order = np.argsort(-probs, axis=-1, kind="stable")[:, :top_k]
    out = np.zeros_like(x)
    for ti in range(t):
        gates = probs[ti, order[ti]]
        gates = gates / gates.sum()
        for gk, ei in zip(gates, order[ti]):
            hidden = _silu(x[ti] @ w_gate[ei]) * (x[ti] @ w_up[ei])
            out[ti] += gk * (hidden @ w_down[ei])
    return out


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(T, D).astype(np.float32),
            "wg": (rng.randn(D, E) * 0.5).astype(np.float32),
            "w_gate": (rng.randn(E, D, H) * 0.2).astype(np.float32),
            "w_up": (rng.randn(E, D, H) * 0.2).astype(np.float32),
            "w_down": (rng.randn(E, H, D) * 0.2).astype(np.float32)}


def _both(fn, *args, **kw):
    j = getattr(jmoe, fn)(*[jnp.asarray(a) for a in args], **kw)
    t = getattr(tmoe, fn)(*[torch.as_tensor(np.array(a)) for a in args],
                          **kw)
    return j, t


def test_top_k_gating_shapes_and_capacity():
    """Combine/dispatch are [T, E, C]; no expert takes more than C
    tokens; every kept token's combine row sums to its renormalised
    gates; combine and dispatch equal the reference's exactly."""
    p = _inputs()
    probs = np.asarray(jmoe._router_probs(jnp.asarray(p["x"]),
                                          jnp.asarray(p["wg"])))
    cap = 6
    (jc, jd, ja), (tc, td, ta) = _both("top_k_gating", probs, K, cap)
    assert tuple(tc.shape) == (T, E, cap) and td.dtype == torch.bool
    assert (td.sum(dim=(0,)) <= 1).all()            # one token a slot
    assert (td.reshape(T, -1).sum(-1) <= K).all()
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_allclose(float(ja), float(ta), rtol=1e-6)
    # ample capacity keeps every token: rows sum to 1
    tc2, _, _ = tmoe.top_k_gating(torch.as_tensor(probs), K, T)
    np.testing.assert_allclose(tc2.sum(dim=(1, 2)).numpy(), 1.0,
                               rtol=1e-6)


def test_top_k_ties_break_toward_the_lower_index():
    """Exact ties route as jax.lax.top_k does: the lower expert index
    first (torch.topk promises no order)."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.3, 0.2, 0.2]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = tmoe._top_k(torch.as_tensor(probs), 2)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("fn", ["_router_probs", "moe_apply",
                                "moe_apply_no_drop", "_topk_combine",
                                "moe_apply_no_drop_q", "top_k_gating"])
def test_moe_functions_match_the_reference(fn):
    """Each function against the reference's on the same inputs: routes
    and combine weights exact, float32 outputs within 2e-4."""
    p = _inputs(1)
    x, wg = p["x"], p["wg"]
    ws = (p["w_gate"], p["w_up"], p["w_down"])
    if fn == "_router_probs":
        j, t = _both(fn, x, wg)
        np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=2e-4,
                                   atol=1e-6)
    elif fn == "moe_apply":
        (jo, ja), (to, ta) = _both(fn, x, wg, *ws, top_k=K, cap_factor=0.75)
        np.testing.assert_allclose(np.asarray(jo), to.numpy(), rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(float(ja), float(ta), rtol=1e-6)
    elif fn == "moe_apply_no_drop":
        j, t = _both(fn, x, wg, *ws, top_k=K)
        np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=2e-4,
                                   atol=2e-5)
    elif fn == "_topk_combine":
        probs = np.asarray(jmoe._router_probs(jnp.asarray(x),
                                              jnp.asarray(wg)))
        j, t = _both(fn, probs, K)
        np.testing.assert_array_equal(np.asarray(j) > 0, t.numpy() > 0)
        np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=1e-6)
    elif fn == "moe_apply_no_drop_q":
        qs, scales = [], {}
        for name, w in zip(("gate", "up", "down"), ws):
            s = np.maximum(np.abs(w).max(axis=1, keepdims=True) / 127.0,
                           1e-10).astype(np.float32)
            qs.append(np.clip(np.round(w / s), -127, 127).astype(np.int8))
            scales[name] = s
        j = jmoe.moe_apply_no_drop_q(
            jnp.asarray(x), jnp.asarray(wg), *map(jnp.asarray, qs),
            {k: jnp.asarray(v) for k, v in scales.items()}, K)
        t = tmoe.moe_apply_no_drop_q(
            torch.as_tensor(x), torch.as_tensor(wg),
            *map(torch.as_tensor, qs),
            {k: torch.as_tensor(v) for k, v in scales.items()}, K)
        np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=2e-4,
                                   atol=2e-5)
    else:
        probs = np.asarray(jmoe._router_probs(jnp.asarray(x),
                                              jnp.asarray(wg)))
        (jc, jd, _), (tc, td, _) = _both(fn, probs, K, 4)
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())


def test_moe_ffn_matches_dense_reference_when_capacity_ample():
    """The moe_ffn op through the executor (training form, capacity
    ample) equals the dense per-token numpy reference; its gradients
    reach the router and every expert table."""
    p = _inputs(2)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[-1, 12, D], dtype="float32",
                              append_batch_size=False)
        out, aux = tfl.moe_ffn(x, num_experts=E, hidden_dim=H, top_k=K,
                               capacity_factor=float(E), name="m")
        loss = fluid.layers.mean(out) + aux
        fluid.optimizer.SGD(learning_rate=0.0).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    for n, k in (("m.router", "wg"), ("m.w_gate", "w_gate"),
                 ("m.w_up", "w_up"), ("m.w_down", "w_down")):
        scope.set(n, torch.as_tensor(p[k]))
    xv = p["x"].reshape(4, 12, D)
    got = exe.run(main, feed={"x": xv},
                  fetch_list=[out] + [f"m.{n}@GRAD" for n in
                                      ("router", "w_gate", "w_up",
                                       "w_down")], scope=scope)
    ref = _dense_reference(p["x"], p["wg"], p["w_up"], p["w_gate"],
                           p["w_down"], K)
    np.testing.assert_allclose(got[0].reshape(T, D), ref, rtol=2e-4,
                               atol=2e-5)
    for g in got[1:]:
        assert np.isfinite(g).all() and np.abs(g).sum() > 0


def test_moe_llama_trains_and_loss_decreases():
    from paddle_tpu_torch.models.llama import LlamaConfig, build_llama
    cfg = LlamaConfig(vocab_size=64, dim=32, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_hidden=48, dtype="float32",
                      moe_experts=4, moe_top_k=2)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        toks = fluid.layers.data("tokens", shape=[-1, 16], dtype="int64",
                                 append_batch_size=False)
        tgt = fluid.layers.data("targets", shape=[-1, 16], dtype="int64",
                                append_batch_size=False)
        _, loss = build_llama(cfg, toks, tgt)
        fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    assert any(op.type == "moe_ffn" for op in main.global_block().ops)
    rng = np.random.RandomState(0)
    data = rng.randint(0, cfg.vocab_size, (4, 17))
    feed = {"tokens": data[:, :-1].astype(np.int64),
            "targets": data[:, 1:].astype(np.int64)}
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(8)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_moe_ffn_refuses_experts_that_do_not_split_over_ep():
    with pytest.raises(ValueError, match="not divisible by the mesh 'ep'"):
        tmoe._check_ep(6, 4)
    tmoe._check_ep(8, 4)


@pytest.fixture(scope="module")
def mesh_cases(tmp_path_factory):
    return shared_ranks("torch_mesh_cases", "moe_mesh_cases", 4,
                        tmp_path_factory, timeout=180)


def test_moe_expert_parallel_sharded_step(mesh_cases):
    """dp x ep = 2 x 2: expert weights sharded over ep, tokens routed
    with the whole batch's capacity and queue order, dispatched by an
    all-to-all over ep; three Adam steps equal the single device's."""
    np.testing.assert_allclose(mesh_cases["moe_ref"],
                               mesh_cases["moe_dp_ep"], rtol=2e-4)
    coll = mesh_cases["moe_stats"]
    assert coll.get("all-to-all", 0) > 0 and coll.get("all-gather", 0) > 0


def test_moe_generation_dp_tp_matches_single_device(mesh_cases):
    """MoE generation with the experts split over tp inside each expert
    (and the batch over dp) emits the single device's tokens."""
    np.testing.assert_array_equal(mesh_cases["moe_gen_ref"],
                                  mesh_cases["moe_gen_dp_tp"])
