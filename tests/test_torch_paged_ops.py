"""The paged-KV step ops (``llama_paged_prefill``,
``llama_paged_prefill_chunk``, ``llama_paged_decode``,
``llama_paged_spec_step``), the JAX package's lowering rules against the
torch port's on the same numpy inputs, on the CPU.

The reference's one-op sweep waives these ops to their dedicated tests
(tests/test_optest_misc.py ``WAIVED``) and exempts them from gradient
checks (tests/test_optest_grad.py: serving steps emit int tokens); this
file is the port's twin of those rows and holds each op to the
reference directly. Weights, prompts and pools are drawn from a seed
with numpy. Tolerances: tokens (NextTok, OutTokens, Emitted, Accepted)
integer-exact; every live page of each pool within the f32 tier (rtol
2e-4, atol 2e-5: float32 sums in another order). Page 0, the null page
that inactive rows write and nothing reads, is not compared.
"""
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu  # noqa: F401  (registers the reference's rules)
from paddle_tpu.core import lowering as jax_lowering
from paddle_tpu.core import registry as jax_registry
import paddle_tpu_torch  # noqa: F401  (registers the port's rules)
from paddle_tpu_torch.core import lowering as pt_lowering
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.models.llama import quantize_generator_weights
from paddle_tpu_torch import Scope

torch.set_num_threads(1)

PAGED_OPS = ("llama_paged_prefill", "llama_paged_prefill_chunk",
             "llama_paged_decode", "llama_paged_spec_step")
TOL = dict(rtol=2e-4, atol=2e-5)
V, D, L, H, G, F = 64, 32, 2, 4, 2, 64
HD = D // H
PS, N_PAGES, MAX_PAGES = 4, 12, 4          # 16 positions a row
ATTRS = {"n_heads": H, "n_kv_heads": G, "rope_base": 10000.0,
         "epsilon": 1e-6, "page_size": PS}
TESTS = pathlib.Path(__file__).resolve().parent
# the port's own test of each paged op, as the reference's sweep names
# its (tests/test_optest_misc.py WAIVED)
WAIVED = {"llama_paged_prefill": "test_torch_decode_serving.py",
          "llama_paged_prefill_chunk": "test_torch_slo_sched.py",
          "llama_paged_decode": "test_torch_decode_serving.py",
          "llama_paged_spec_step": "test_torch_decode_serving.py"}


def _model(rng, prefix="", dim=D, layers=L, heads=H, kv=G, ffn=F):
    hd = dim // heads
    w = lambda *s: (rng.randn(*s) * 0.2).astype(np.float32)  # noqa: E731
    return {prefix + "AttnNorm": 1.0 + w(layers, dim),
            prefix + "Wq": w(layers, dim, heads * hd),
            prefix + "Wk": w(layers, dim, kv * hd),
            prefix + "Wv": w(layers, dim, kv * hd),
            prefix + "Wo": w(layers, heads * hd, dim),
            prefix + "MlpNorm": 1.0 + w(layers, dim),
            prefix + "WGate": w(layers, dim, ffn),
            prefix + "WUp": w(layers, dim, ffn),
            prefix + "WDown": w(layers, ffn, dim),
            prefix + "Emb": w(V, dim),
            prefix + "FinalNorm": 1.0 + w(dim),
            prefix + "LmHead": w(dim, V)}


def _pools(rng, kv=G, hd=HD, layers=L):
    shape = (layers, N_PAGES, PS, kv, hd)
    return ((rng.randn(*shape) * 0.5).astype(np.float32),
            (rng.randn(*shape) * 0.5).astype(np.float32))


def _run(op, ins, attrs):
    """The reference's rule and the port's on the same inputs (numpy in,
    numpy out)."""
    jctx = jax_lowering.LoweringContext(None, "test",
                                        jax.random.PRNGKey(0))
    jout = jax_registry.get_op(op).lower(
        jctx, {s: [jnp.asarray(a)] for s, a in ins.items()}, dict(attrs))
    tctx = pt_lowering.LoweringContext(None, "test", torch.device("cpu"),
                                       0, 1)
    tout = pt_registry.get_op(op).lower(
        tctx, {s: [torch.from_numpy(np.array(a))] for s, a in ins.items()},
        dict(attrs))
    return ({s: np.asarray(v[0]) for s, v in jout.items()},
            {s: v[0].numpy() for s, v in tout.items()})


def _check(jout, tout, live):
    assert set(jout) == set(tout)
    for slot, want in jout.items():
        got = tout[slot]
        assert got.shape == want.shape, slot
        if slot.endswith("PagesOut"):
            np.testing.assert_allclose(got[:, live], want[:, live],
                                       err_msg=slot, **TOL)
        else:
            np.testing.assert_array_equal(got.astype(np.int64),
                                          want.astype(np.int64),
                                          err_msg=slot)


def _table(rows):
    """A [len(rows), MAX_PAGES] int32 table, null (0) past each row's
    pages."""
    t = np.zeros((len(rows), MAX_PAGES), np.int32)
    for i, pages in enumerate(rows):
        t[i, :len(pages)] = pages
    return t


ROWS = [[3, 7, 1, 9], [], [2, 5, 11]]   # the middle slot is inactive
LIVE = sorted(p for r in ROWS for p in r)


def test_prefill_tokens_and_pages():
    rng = np.random.RandomState(0)
    kp, vp = _pools(rng)
    ins = dict(_model(rng),
               Tokens=rng.randint(0, V, (3, 8)).astype(np.int64),
               Lens=np.asarray([8, 1, 5], np.int32), Table=_table(ROWS),
               KPages=kp, VPages=vp)
    _check(*_run("llama_paged_prefill", ins, ATTRS), LIVE)


def test_prefill_chunk_at_offsets():
    rng = np.random.RandomState(1)
    kp, vp = _pools(rng)
    ins = dict(_model(rng),
               Tokens=rng.randint(0, V, (3, 4)).astype(np.int64),
               Lens=np.asarray([4, 1, 3], np.int32),
               Offsets=np.asarray([8, 0, 4], np.int32), Table=_table(ROWS),
               KPages=kp, VPages=vp)
    _check(*_run("llama_paged_prefill_chunk", ins, ATTRS), LIVE)


@pytest.mark.parametrize("steps", [1, 3])
def test_decode_steps(steps):
    rng = np.random.RandomState(2 + steps)
    kp, vp = _pools(rng)
    ins = dict(_model(rng),
               Tokens=rng.randint(0, V, (3,)).astype(np.int64),
               Positions=np.asarray([9, 1, 6], np.int32),
               Table=_table(ROWS), KPages=kp, VPages=vp)
    _check(*_run("llama_paged_decode", ins, dict(ATTRS, steps=steps)), LIVE)


@pytest.mark.parametrize("draft", ["self", "small"])
def test_spec_step(draft):
    rng = np.random.RandomState(6)
    target = _model(rng)
    if draft == "self":
        dkw = dict(dim=D, heads=H, kv=G, ffn=F)
        d_model = {"Draft" + k: v for k, v in target.items()}
    else:
        dkw = dict(dim=16, heads=2, kv=1, ffn=32)
        d_model = _model(rng, prefix="Draft", layers=1, **dkw)
    kp, vp = _pools(rng)
    dkp, dvp = _pools(rng, kv=dkw["kv"], hd=dkw["dim"] // dkw["heads"],
                      layers=L if draft == "self" else 1)
    ins = dict(target, **d_model,
               Tokens=rng.randint(0, V, (3,)).astype(np.int64),
               Prev=rng.randint(0, V, (3,)).astype(np.int64),
               Positions=np.asarray([8, 1, 5], np.int32),
               Table=_table(ROWS), KPages=kp, VPages=vp,
               DraftKPages=dkp, DraftVPages=dvp)
    attrs = dict(ATTRS, gamma=3, draft_n_heads=dkw["heads"],
                 draft_n_kv_heads=dkw["kv"], draft_rope_base=10000.0,
                 draft_epsilon=1e-6)
    _check(*_run("llama_paged_spec_step", ins, attrs), LIVE)


def _quantized(model):
    """The W8A8 serving form of ``model``'s matmul slots: the port's
    ``quantize_generator_weights`` on a scope of the generator names,
    whose recipe is bit-equal to the reference's (test_torch_generate)."""
    names = {"AttnNorm": "attn_norm", "Wq": "wq", "Wk": "wk", "Wv": "wv",
             "Wo": "wo", "MlpNorm": "mlp_norm", "WGate": "w_gate",
             "WUp": "w_up", "WDown": "w_down"}
    scope = Scope()
    for slot, suffix in names.items():
        scope.set(f"blocks.{suffix}", torch.from_numpy(model[slot]))
    for slot, name in (("Emb", "tok_emb"), ("FinalNorm", "final_norm"),
                       ("LmHead", "lm_head")):
        scope.set(name, torch.from_numpy(model[slot]))
    quantize_generator_weights(scope)
    out = dict(model)
    for slot in ("Wq", "Wk", "Wv", "Wo", "WGate", "WUp", "WDown"):
        n = f"blocks.{names[slot]}"
        out[slot] = scope.find_var(n).numpy()
        out[slot + "Scale"] = scope.find_var(n + "@scale").numpy()
    out["LmHead"] = scope.find_var("lm_head").numpy()
    out["LmHeadScale"] = scope.find_var("lm_head@scale").numpy()
    return out


@pytest.mark.parametrize("op", ["llama_paged_prefill", "llama_paged_decode"])
def test_quantized_w8a8(op):
    rng = np.random.RandomState(8)
    model = _quantized(_model(rng))
    kp, vp = _pools(rng)
    if op == "llama_paged_prefill":
        ins = dict(model, Tokens=rng.randint(0, V, (3, 8)).astype(np.int64),
                   Lens=np.asarray([8, 1, 5], np.int32))
        attrs = ATTRS
    else:
        ins = dict(model, Tokens=rng.randint(0, V, (3,)).astype(np.int64),
                   Positions=np.asarray([9, 1, 6], np.int32))
        attrs = dict(ATTRS, steps=2)
    ins.update(Table=_table(ROWS), KPages=kp, VPages=vp)
    _check(*_run(op, ins, attrs), LIVE)


def test_chunks_fill_the_pages_of_one_prefill():
    """Prefilling [0, 4), [4, 8) as chunks writes the pages one 8-token
    prefill writes (within the f32 tier) and ends on its NextTok."""
    rng = np.random.RandomState(9)
    model = _model(rng)
    kp, vp = _pools(rng)
    toks = rng.randint(0, V, (1, 8)).astype(np.int64)
    table = _table([[4, 2]])
    tctx = pt_lowering.LoweringContext(None, "test", torch.device("cpu"),
                                       0, 1)

    def port(op, **extra):
        ins = dict(model, Table=table, **extra)
        return pt_registry.get_op(op).lower(
            tctx, {s: [torch.from_numpy(np.array(a))]
                   for s, a in ins.items()}, dict(ATTRS))

    whole = port("llama_paged_prefill", Tokens=toks,
                 Lens=np.asarray([8], np.int32), KPages=kp, VPages=vp)
    k, v = kp, vp
    for off in (0, 4):
        part = port("llama_paged_prefill_chunk", Tokens=toks[:, off:off + 4],
                    Lens=np.asarray([4], np.int32),
                    Offsets=np.asarray([off], np.int32), KPages=k, VPages=v)
        k, v = (part[s][0].numpy() for s in ("KPagesOut", "VPagesOut"))
    for got, want in ((k, whole["KPagesOut"][0]), (v, whole["VPagesOut"][0])):
        np.testing.assert_allclose(got[:, [4, 2]], want[:, [4, 2]].numpy(),
                                   **TOL)
    assert int(part["NextTok"][0][0]) == int(whole["NextTok"][0][0])


def test_registries_match_the_reference():
    """Each paged op: registered in both packages, a numerics rule in
    both, no infer rule in either (as the reference), and not waiting
    in the port any more."""
    for op in PAGED_OPS:
        assert jax_registry.has_op(op) and pt_registry.has_op(op), op
        assert pt_registry.has_numerics(op) == jax_registry.has_numerics(op)
        assert pt_registry.has_numerics(op)
        assert pt_registry.has_infer(op) == jax_registry.has_infer(op)
        assert op not in pt_registry.WAITING


def test_numerics_rule_matches_the_reference():
    from paddle_tpu.analysis.numcheck import NumInfo as JInfo
    from paddle_tpu_torch.analysis.numcheck import NumInfo as TInfo
    for op in PAGED_OPS:
        for finite in (True, False):
            jins = {"KPages": [JInfo(-1.0, 1.0, finite=finite)],
                    "VPages": [JInfo(-1.0, 1.0, finite=True)]}
            tins = {"KPages": [TInfo(-1.0, 1.0, finite=finite)],
                    "VPages": [TInfo(-1.0, 1.0, finite=True)]}
            want = jax_registry.get_numerics(op)(op, jins, {})
            got = pt_registry.get_numerics(op)(op, tins, {})
            assert set(got) == set(want)
            for slot in want:
                g, w = got[slot][0], want[slot][0]
                assert (g.lo, g.hi, g.finite, g.confident) == \
                    (w.lo, w.hi, w.finite, w.confident), (op, slot)


@pytest.mark.parametrize("op", PAGED_OPS)
def test_waived_op_names_its_own_test(op):
    """As the reference's sweep waives each paged op to a test file that
    exists and mentions it, the port's names its twin."""
    path = TESTS / WAIVED[op]
    assert path.exists(), path
    assert op in path.read_text()
