"""The port's pipeline schedules (``parallel.pipeline``: ``gpipe`` and
``one_f_one_b``), held to tests/test_pipeline.py's five cases and to the
reference's own schedules on the same numpy inputs.

The port's side runs on 4 gloo ranks (one spawned group for the module,
``torch_pipe_cases.pipeline_cases``): pp 4, and dp 2 x pp 2 where the
reference test takes dp 2 x pp 4 on 8 devices, its 4 layers then two a
stage. The reference's side runs here on jax's virtual devices at the
same mesh shapes. Tolerances are the reference tests' own: outputs rtol
1e-5 / atol 1e-5, losses within 1e-5, gradients and dx rtol 1e-4 / atol
1e-5; training lowers the loss below the reference test's fractions.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from paddle_tpu.parallel import make_mesh
from paddle_tpu.parallel.pipeline import gpipe, one_f_one_b
from torch_mesh_ranks import shared_ranks
from torch_pipe_cases import PIPE_CASES, pairs, stage_inputs


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return shared_ranks("torch_pipe_cases", "pipeline_cases", 4,
                        tmp_path_factory, timeout=240)


def _stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _stage_fn2(params, x):
    for i in range(params["w"].shape[0]):
        x = jnp.tanh(x @ params["w"][i] + params["b"][i])
    return x


def _loss_fn(y, tgt):
    return jnp.mean((y - tgt) ** 2)


def _head_loss(lp, y, t):
    logits = y @ lp["head"]
    lse = jax.scipy.special.logsumexp(logits, axis=-1)
    picked = jnp.take_along_axis(logits, t[:, None], axis=1)[:, 0]
    return jnp.mean(lse - picked)


def _sequential(stacked, x):
    for s in range(stacked["w"].shape[0]):
        x = _stage_fn({"w": stacked["w"][s], "b": stacked["b"][s]}, x)
    return x


def _direct(stacked, micro, tgt, loss=_loss_fn, lp=None):
    total = 0.0
    for m in range(micro.shape[0]):
        h = _sequential(stacked, micro[m])
        total = total + (loss(h, tgt[m]) if lp is None
                         else loss(lp, h, tgt[m]))
    return total / micro.shape[0]


def _jnp(c, *keys):
    return [jnp.asarray(c[k]) for k in keys]


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_gpipe_matches_sequential(cases):
    c = stage_inputs(**PIPE_CASES["gpipe"])
    w, b, micro = _jnp(c, "w", "b", "micro")
    stacked = {"w": w, "b": b}
    want = jnp.stack([_sequential(stacked, micro[m])
                      for m in range(micro.shape[0])])
    ref = jax.jit(gpipe(_stage_fn, make_mesh({"pp": 4}),
                        checkpoint_stages=False))(stacked, micro)
    _close(cases["gpipe"], want, rtol=1e-5, atol=1e-5)
    _close(cases["gpipe"], ref, rtol=1e-5, atol=1e-5)


def test_gpipe_grads_and_dp(cases):
    c = stage_inputs(**PIPE_CASES["gpipe_dp"])
    w, b, micro, tgt = _jnp(c, "w", "b", "micro", "tgt")
    stacked = {"w": w, "b": b}
    ls, gs = jax.value_and_grad(lambda p: jnp.mean(
        (jnp.stack([_sequential(p, micro[m])
                    for m in range(micro.shape[0])]) - tgt) ** 2))(stacked)
    piped = gpipe(_stage_fn2, make_mesh({"dp": 2, "pp": 2}))
    lr, gr = jax.jit(jax.value_and_grad(lambda p: jnp.mean(
        (piped(p, micro) - tgt) ** 2)))(
            {"w": jnp.asarray(pairs(c["w"])), "b": jnp.asarray(pairs(c["b"]))})
    for want_l, want_g in ((ls, gs["w"]), (lr, gr["w"].reshape(w.shape))):
        assert abs(cases["gpipe_dp_loss"] - float(want_l)) < 1e-5
        _close(cases["gpipe_dp_grads"]["w"], want_g)
    _close(cases["gpipe_dp_grads"]["b"], gs["b"])
    # 10 SGD steps through the pipeline reduce the loss
    assert cases["gpipe_dp_trained"] < cases["gpipe_dp_loss"] * 0.85


def test_one_f_one_b_matches_autodiff(cases):
    c = stage_inputs(**PIPE_CASES["1f1b"])
    w, b, micro, tgt = _jnp(c, "w", "b", "micro", "tgt")
    stacked = {"w": w, "b": b}
    want_loss, want = jax.value_and_grad(
        lambda p: _direct(p, micro, tgt))(stacked)
    ref_loss, ref = jax.jit(one_f_one_b(_stage_fn, _loss_fn, make_mesh(
        {"pp": 4})))(stacked, micro, tgt)
    for l_, g in ((want_loss, want), (ref_loss, ref)):
        assert abs(cases["1f1b_loss"] - float(l_)) < 1e-5
        for k in ("w", "b"):
            _close(cases["1f1b_grads"][k], g[k])


def test_one_f_one_b_dp_and_training(cases):
    c = stage_inputs(**PIPE_CASES["1f1b_dp"])
    w, b, micro, tgt = _jnp(c, "w", "b", "micro", "tgt")
    want = _direct({"w": w, "b": b}, micro, tgt)
    ref_loss, _ = jax.jit(one_f_one_b(_stage_fn2, _loss_fn, make_mesh(
        {"dp": 2, "pp": 2})))({"w": jnp.asarray(pairs(c["w"])),
                               "b": jnp.asarray(pairs(c["b"]))}, micro, tgt)
    assert abs(cases["1f1b_dp_loss0"] - float(want)) < 1e-5
    assert abs(cases["1f1b_dp_loss0"] - float(ref_loss)) < 1e-5
    assert cases["1f1b_dp_trained"] < cases["1f1b_dp_loss0"] * 0.7


def test_one_f_one_b_loss_params_and_dx(cases):
    c = stage_inputs(**PIPE_CASES["1f1b_head"])
    w, b, head, micro, tgt = _jnp(c, "w", "b", "head", "micro", "tgt")
    want_loss, (want_g, want_lg, want_dx) = jax.value_and_grad(
        lambda p, lp, mx: _direct(p, mx, tgt, _head_loss, lp),
        argnums=(0, 1, 2))({"w": w, "b": b}, {"head": head}, micro)
    step = one_f_one_b(_stage_fn2, _head_loss, make_mesh({"dp": 2, "pp": 2}),
                       loss_params=True, return_dx=True)
    ref_loss, ref_g, ref_lg, ref_dx = jax.jit(step)(
        {"w": jnp.asarray(pairs(c["w"])), "b": jnp.asarray(pairs(c["b"]))},
        {"head": head}, micro, tgt)
    for l_, g, lg, dx in ((want_loss, want_g["w"], want_lg, want_dx),
                          (ref_loss, ref_g["w"].reshape(w.shape), ref_lg,
                           ref_dx)):
        assert abs(cases["head_loss"] - float(l_)) < 1e-5
        _close(cases["head_grads"]["w"], g)
        _close(cases["head_lgrads"], lg["head"])
        _close(cases["head_dx"], dx)
