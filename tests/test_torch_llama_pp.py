"""The port's pipelined Llama: ``build_llama(shard_pp=True)`` (the
layer-stacked ``llama_decoder_stack``, GPipe over a mesh 'pp' axis) and
``pp_schedule="1f1b"`` (``llama_stack_1f1b_loss``, the backward inside
the schedule), held to tests/test_llama_pp.py's five cases and to the
reference's programs on the same weights.

The pipelined cases run on 4 gloo ranks, dp 2 x pp 2 (one spawned group
for the module, ``torch_pipe_cases.llama_pp_cases``), where the
reference test takes dp 2 x pp 4 on 8 devices; the reference's side
runs here at dp 2 x pp 2 on jax's virtual devices, from the initial
state the ranks drew. Tolerances are the reference tests' own: the
pipelined loss within 5e-4 of the single device's, 1F1B on the GPipe
trajectory at rtol 1e-3 / atol 1e-4, training lowering the loss by the
reference test's margins; the port against the reference's programs at
the 1F1B trajectory's tolerance.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.models import llama as jllama
from paddle_tpu.parallel import make_mesh

import paddle_tpu_torch as fluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import llama as tllama
from torch_mesh_ranks import shared_ranks
from torch_pipe_cases import PP_STEPS, llama_data

torch.set_num_threads(1)

CFG = dict(vocab_size=256, dim=64, n_layers=4, n_heads=4, n_kv_heads=2,
           ffn_hidden=128, dtype="float32")
CPU = fluid.CPUPlace()


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return shared_ranks("torch_pipe_cases", "llama_pp_cases", 4,
                        tmp_path_factory, timeout=240)


def _build(pkg, llama, **kw):
    """(main, startup, loss) of the reference test's program in ``pkg``
    (the port or the reference)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        tokens = pkg.layers.data(name="tokens", shape=[-1, 16],
                                 dtype="int64", append_batch_size=False)
        targets = pkg.layers.data(name="targets", shape=[-1, 16],
                                  dtype="int64", append_batch_size=False)
        _, loss = llama.build_llama(llama.LlamaConfig(**CFG), tokens,
                                    targets, shard_pp=True, **kw)
        pkg.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _losses(run, steps):
    return [float(np.asarray(run(llama_data(s))[0]).reshape(()))
            for s in range(steps)]


def _ref_run(state, mesh=None, steps=PP_STEPS, **kw):
    """The reference program's losses over ``steps`` steps from
    ``state``, on one device or through its ParallelExecutor on
    ``mesh``."""
    main, _, loss = _build(jfluid, jllama, **kw)
    scope = jfluid.Scope()
    for n, a in state.items():
        scope.set(n, jnp.asarray(a))
    if mesh is None:
        exe = jfluid.Executor(jfluid.CPUPlace())
        return _losses(lambda f: exe.run(main, feed=f, fetch_list=[loss],
                                         scope=scope), steps)
    pe = jfluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                 scope=scope, mesh=make_mesh(mesh))
    return _losses(lambda f: pe.run(feed=f, fetch_list=[loss.name]), steps)


def _train_single(**kw):
    """The port's program on one device, from the reference's startup
    (its weights carried over as numpy)."""
    main, _, loss = _build(fluid, tllama, **kw)
    _, jstart, _ = _build(jfluid, jllama, **kw)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstart, scope=jscope)
    scope = weights.load_state(fluid.Scope(), {
        n: np.asarray(jscope.find_var(n)) for n in jscope.keys()},
        CPU.device)
    return fluid.Executor(CPU), main, loss, scope


def test_llama_stack_scan_trains_single_device():
    """The stacked op trains on one device (the loop over the layers),
    over the reference test's 100 Adam steps, as the reference's program
    does from the same weights. The two trajectories agree to 1e-4 for
    ~10 steps, then part as float orders do under Adam (0.01 to 0.08
    apart past step 30), so the last step alone is noise (the
    reference's own last 10 losses lie up to 0.16 above its last): the
    mean of the last 10 losses is held within 0.05 of the reference's,
    and 0.2 below the first loss."""
    exe, main, loss, scope = _train_single(shard_dp=True)
    state = weights.dump_state(scope)
    losses = _losses(lambda f: exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope), 100)
    want = _ref_run(state, steps=100, shard_dp=True)
    np.testing.assert_allclose(losses[:PP_STEPS], want[:PP_STEPS],
                               rtol=1e-3, atol=1e-4)
    tail, want_tail = np.mean(losses[-10:]), np.mean(want[-10:])
    assert abs(tail - want_tail) < 0.05, (tail, want_tail)
    assert tail < losses[0] - 0.2, (losses[0], tail)


def test_llama_pp_matches_scan(cases):
    """Same weights, same feed: the dp 2 x pp 2 GPipe loss equals the
    single-device loss, the port's and the reference's."""
    got = cases["gpipe_pp"][0]
    assert abs(got - cases["gpipe_plain"][0]) < 5e-4
    want = _ref_run(cases["init"], shard_dp=True)
    assert abs(got - want[0]) < 5e-4, (got, want[0])


def test_llama_pp_trains(cases):
    """Adam through the pipeline schedule lowers the loss; each stage's
    stacked weights and Adam moments stay on their stage (Shard(0) over
    'pp', replicated over 'dp'), the embedding replicated; the schedule's
    ticks permute activations and the microbatches' gradient and the
    shared output are all-reduced over 'pp'."""
    losses = cases["gpipe_pp"]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.2, (losses[0], losses[-1])
    for tag in ("gpipe", "1f1b"):
        pl = cases[f"{tag}_placements"]
        assert pl["blocks.wq"] == ["R", "S(0)"], pl
        assert pl["blocks.wq_moment1_0"] == ["R", "S(0)"], pl
        assert pl["tok_emb"] == ["R", "R"], pl
        coll = cases[f"{tag}_collectives"]
        assert coll.get("collective-permute", 0) > 0, coll
        assert coll.get("all-reduce", 0) > 0, coll


def test_llama_1f1b_matches_gpipe_trajectory(cases):
    """pp_schedule='1f1b' tracks the GPipe trajectory on dp 2 x pp 2, and
    both track the reference's programs through its ParallelExecutor on
    the same mesh shape from the same weights."""
    g, f = cases["gpipe_pp"][:PP_STEPS], cases["1f1b_pp"]
    assert all(np.isfinite(f)), f
    np.testing.assert_allclose(f, g, rtol=1e-3, atol=1e-4)
    mesh = {"dp": 2, "pp": 2}
    np.testing.assert_allclose(
        f, _ref_run(cases["init"], mesh, shard_dp=True, pp_schedule="1f1b"),
        rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        g, _ref_run(cases["init"], mesh, shard_dp=True), rtol=1e-3,
        atol=1e-4)
    # off the mesh the two programs agree with each other too
    np.testing.assert_allclose(cases["1f1b_plain"], cases["gpipe_plain"],
                               rtol=1e-3, atol=1e-4)


def test_llama_1f1b_on_a_dp_mesh(cases):
    """The 1F1B program on a mesh without a 'pp' axis (dp 4): each rank's
    batch block through every layer, the per-token losses averaged over
    the blocks — the single device's losses, at the dp tier of
    tests/test_parallel.py (rtol 2e-3 / atol 2e-4)."""
    np.testing.assert_allclose(cases["1f1b_dp4"], cases["1f1b_plain"][:3],
                               rtol=2e-3, atol=2e-4)


def test_llama_1f1b_single_device_fallback():
    """Off the mesh the 1F1B program is the loop over the layers plus the
    chunked loss, and ordinary autodiff trains it; its first steps equal
    the reference's 1F1B program on the same weights."""
    exe, main, loss, scope = _train_single(pp_schedule="1f1b")
    state = weights.dump_state(scope)
    losses = _losses(lambda f: exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope), 60)
    assert losses[-1] < losses[0] - 0.15, (losses[0], losses[-1])
    want = _ref_run(state, pp_schedule="1f1b")
    np.testing.assert_allclose(losses[:PP_STEPS], want, rtol=1e-3,
                               atol=1e-4)
    assert main.global_block().ops[1].type == "llama_stack_1f1b_loss"


@pytest.mark.parametrize("op_name, layers, batch, n_micro, match", [
    ("llama_decoder_stack", 6, 8, 0,
     "llama_decoder_stack: 6 layers do not split over the mesh 'pp' axis "
     "of size 4"),
    ("llama_stack_1f1b_loss", 4, 6, 4,
     "llama_stack_1f1b_loss: batch 6 is not divisible by n_micro=4 "
     "microbatches"),
    ("llama_decoder_stack", 4, 4, 0,
     r"llama_decoder_stack: microbatch 1 \(batch 4 / n_micro 4\) is not "
     "divisible by the mesh 'dp' axis of size 2"),
    ("llama_stack_1f1b_loss", 4, 4, 0,
     "llama_stack_1f1b_loss: microbatch 1 is not divisible by the mesh "
     "'dp' axis of size 2")])
def test_pipeline_plan_refuses_as_the_reference(op_name, layers, batch,
                                                n_micro, match):
    """The stacked ops' checks on a dp 2 x pp 4 mesh, worded as the
    reference's (paddle_tpu/ops/transformer_ops.py, both ops' pp
    branches); a batch that splits gets one microbatch a stage."""
    from types import SimpleNamespace
    from paddle_tpu_torch.ops.transformer_ops import pipeline_plan
    mesh = SimpleNamespace(axes={"dp": 2, "pp": 4})
    with pytest.raises(ValueError, match=f"^{match}$"):
        pipeline_plan(op_name, layers, batch, n_micro, mesh)
    assert pipeline_plan(op_name, 4, 8, 0, mesh) == 4
