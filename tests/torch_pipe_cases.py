"""Case functions of the port's pipeline and ring-attention tests, run on
gloo ranks (``torch_mesh_ranks.shared_ranks``), and the numpy inputs
both sides of those tests use. Each case runs on every rank and returns
plain numpy values (rank 0's reach the test). This module imports torch
and the port only: the ranks never import jax or paddle_tpu."""
import numpy as np
import torch
import torch.distributed as dist

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core.executor import to_numpy
from paddle_tpu_torch.parallel import collectives, make_mesh
from paddle_tpu_torch.parallel.pipeline import gpipe, one_f_one_b

CPU = fluid.CPUPlace()


# ----------------------------------------------------------------------
# tests/test_pipeline.py: a tanh stage, stacked over 4 stages
# ----------------------------------------------------------------------
def stage_inputs(seed, n_micro, bias=True, d=8, mb=4, stages=4,
                 head=False):
    """The reference test's numpy draws, in its order: stacked w, b,
    micro, then the targets (float, or class ids with a head)."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(stages, d, d) * 0.3).astype(np.float32)
    b = (rng.randn(stages, d) * 0.1).astype(np.float32) if bias \
        else np.zeros((stages, d), np.float32)
    out = {"w": w, "b": b}
    if head:
        out["head"] = (rng.randn(d, 3) * 0.5).astype(np.float32)
    out["micro"] = rng.randn(n_micro, mb, d).astype(np.float32)
    if head:
        out["tgt"] = rng.randint(0, 3, (n_micro, mb)).astype(np.int64)
    else:
        out["tgt"] = rng.randn(n_micro, mb, d).astype(np.float32)
    return out


PIPE_CASES = {
    "gpipe": dict(seed=0, n_micro=6),
    "gpipe_dp": dict(seed=1, n_micro=5, bias=False),
    "1f1b": dict(seed=3, n_micro=6),
    "1f1b_dp": dict(seed=4, n_micro=5, bias=False),
    "1f1b_head": dict(seed=5, n_micro=6, head=True),
}


def stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def mse(y, tgt):
    return torch.mean((y - tgt) ** 2)


def head_loss(lp, y, t):
    logits = y @ lp["head"]
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(1, t[:, None])[:, 0]
    return torch.mean(lse - picked)


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _gather_stages(mesh, tree, axis="pp"):
    """Rank 0 gets every stage's block of ``tree`` (leaves [1, ...]),
    stacked in stage order: the reference's out_spec P('pp')."""
    mine = (mesh.coordinate(axis), {k: to_numpy(v) for k, v in tree.items()})
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, mine)
    by_stage = dict(got)
    return {k: np.concatenate([by_stage[s][k] for s in sorted(by_stage)])
            for k in tree}


def _dp_block(a, mesh):
    """This rank's block of ``a`` [n_micro, mb, ...] over 'dp' on dim 1."""
    if "dp" not in mesh.axes:
        return a
    n = mesh.axes["dp"]
    size = a.shape[1] // n
    i = mesh.coordinate("dp")
    return a[:, i * size:(i + 1) * size]


def _dp_concat(mesh, a):
    """Rank 0 gets the dp blocks of ``a`` concatenated on dim 1."""
    if "dp" not in mesh.axes:
        return to_numpy(a)
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (mesh.coordinate("dp"), to_numpy(a)))
    blocks = dict(got)
    return np.concatenate([blocks[i] for i in sorted(blocks)], axis=1)


def _dp_mean(mesh, g):
    if "dp" not in mesh.axes:
        return g
    return collectives.all_reduce(g, "dp", "mean", mesh)


def stage_fn2(params, x):
    """A stage of several tanh layers (params lead with the layer axis):
    the 4 layers over the 2 stages of dp 2 x pp 2."""
    for i in range(params["w"].shape[0]):
        x = torch.tanh(x @ params["w"][i] + params["b"][i])
    return x


def pairs(a):
    """[4, ...] layers as [2 stages, 2 layers, ...]."""
    return a.reshape((2, 2) + a.shape[1:])


def _mine(p, mesh, grad=False):
    """This rank's stage [1, ...] of each stacked numpy array of ``p``."""
    me = mesh.coordinate("pp")
    return {k: _t(v[me:me + 1], grad) for k, v in p.items()}


def _layers(grads):
    """[2, 2, ...] stage gradients as [4, ...] layers."""
    return {k: v.reshape((4,) + v.shape[2:]) for k, v in grads.items()}


def pipeline_cases(rank, world):
    """tests/test_pipeline.py's five cases on 4 gloo ranks: pp 4, and
    dp 2 x pp 2 (two layers a stage) where the reference takes dp."""
    out = {}
    pp4 = make_mesh({"pp": 4}, place=CPU)
    dp_pp = make_mesh({"dp": 2, "pp": 2}, place=CPU)

    # gpipe equals sequential (pp 4; every rank passes the global stack)
    c = stage_inputs(**PIPE_CASES["gpipe"])
    piped = gpipe(stage_fn, pp4, checkpoint_stages=False)
    got = piped({"w": _t(c["w"]), "b": _t(c["b"])}, _t(c["micro"]))
    out["gpipe"] = to_numpy(got)

    # gpipe gradients with dp (autograd through the schedule, stages
    # recomputed), then 10 SGD steps
    c = stage_inputs(**PIPE_CASES["gpipe_dp"])
    piped = gpipe(stage_fn2, dp_pp)
    micro = _t(_dp_block(c["micro"], dp_pp))
    tgt = _t(_dp_block(c["tgt"], dp_pp))

    def loss_grads(mine):
        leaves = {k: _t(v, grad=True) for k, v in mine.items()}
        loss = torch.mean((piped(leaves, micro) - tgt) ** 2)
        gw, gb = torch.autograd.grad(loss, [leaves["w"], leaves["b"]])
        return (float(_dp_mean(dp_pp, loss.detach())),
                {"w": _dp_mean(dp_pp, gw), "b": _dp_mean(dp_pp, gb)})

    # each rank holds (and steps) its own stage's [1, 2, ...] block
    me = dp_pp.coordinate("pp")
    mine = {"w": pairs(c["w"])[me:me + 1], "b": pairs(c["b"])[me:me + 1]}
    out["gpipe_dp_loss"], g = loss_grads(mine)
    out["gpipe_dp_grads"] = _layers(_gather_stages(dp_pp, g))
    for _ in range(10):
        _, g = loss_grads(mine)
        mine = {k: mine[k] - 0.5 * to_numpy(g[k]) for k in mine}
    out["gpipe_dp_trained"] = loss_grads(mine)[0]

    # 1F1B equals autodiff (pp 4)
    c = stage_inputs(**PIPE_CASES["1f1b"])
    step = one_f_one_b(stage_fn, mse, pp4)
    loss, grads = step({"w": _t(c["w"]), "b": _t(c["b"])},
                       _t(c["micro"]), _t(c["tgt"]))
    out["1f1b_loss"] = float(loss)
    out["1f1b_grads"] = _gather_stages(pp4, grads)

    # 1F1B with dp, and 40 SGD steps on the schedule's own gradients
    c = stage_inputs(**PIPE_CASES["1f1b_dp"])
    step = one_f_one_b(stage_fn2, mse, dp_pp)
    bx = _t(_dp_block(c["micro"], dp_pp))
    by = _t(_dp_block(c["tgt"], dp_pp))
    mine = _mine({"w": pairs(c["w"]), "b": pairs(c["b"])}, dp_pp)
    out["1f1b_dp_loss0"] = float(step(mine, bx, by)[0])
    for _ in range(40):
        loss, grads = step(mine, bx, by)
        mine = {k: mine[k] - 0.4 * grads[k] for k in mine}
    out["1f1b_dp_trained"] = float(loss)

    # loss_params + dx (dp 2 x pp 2)
    c = stage_inputs(**PIPE_CASES["1f1b_head"])
    step = one_f_one_b(stage_fn2, head_loss, dp_pp, loss_params=True,
                       return_dx=True)
    loss, grads, lgrads, dx = step(
        _mine({"w": pairs(c["w"]), "b": pairs(c["b"])}, dp_pp),
        {"head": _t(c["head"])}, _t(_dp_block(c["micro"], dp_pp)),
        _t(_dp_block(c["tgt"], dp_pp)))
    out["head_loss"] = float(loss)
    out["head_grads"] = _layers(_gather_stages(dp_pp, grads))
    out["head_lgrads"] = to_numpy(lgrads["head"])
    out["head_dx"] = _dp_concat(dp_pp, dx)
    return out


# ----------------------------------------------------------------------
# tests/test_llama_pp.py: the layer-stacked Llama over dp 2 x pp 2
# ----------------------------------------------------------------------
def pp_cfg():
    from paddle_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=256, dim=64, n_layers=4, n_heads=4,
                       n_kv_heads=2, ffn_hidden=128, dtype="float32")


def llama_data(step, b=8, t=16, vocab=256):
    """tests/test_llama_pp.py's ``_data``: a learnable repeat pattern."""
    rng = np.random.RandomState(step)
    toks = rng.randint(0, vocab, (b, t)).astype(np.int64)
    toks[:, 1::2] = toks[:, 0::2]
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


PP_STEPS = 10          # the trajectory the reference test compares
PP_TRAIN_STEPS = 100   # the pipeline's training run (the reference test's)


def llama_pp_cases(rank, world):
    """build_llama(shard_pp, shard_dp) with the GPipe and the 1F1B
    schedules on a dp 2 x pp 2 mesh from one initial state: the first
    losses beside the single device's, PP_STEPS steps of each schedule,
    the GPipe run on to PP_TRAIN_STEPS steps, and where each stage's
    weights and Adam moments live."""
    from torch_mesh_cases import _copy, _init, _llama_train, _state
    cfg = pp_cfg()
    out = {}
    gmain, gstart, gloss = _llama_train(cfg, shard_pp=True, shard_dp=True)
    fmain, _, floss = _llama_train(cfg, shard_pp=True, shard_dp=True,
                                   pp_schedule="1f1b")
    init = _state(_init(gstart))
    out["init"] = init
    feeds = [llama_data(s) for s in range(PP_TRAIN_STEPS)]
    exe = fluid.Executor(CPU)
    for tag, main, loss in (("gpipe", gmain, gloss), ("1f1b", fmain, floss)):
        scope = _copy(init)
        out[f"{tag}_plain"] = [float(np.asarray(exe.run(
            main, feed=f, fetch_list=[loss], scope=scope)[0]).reshape(()))
            for f in feeds[:PP_STEPS]]
        scope = _copy(init)
        pe = fluid.ParallelExecutor(
            loss_name=loss.name, main_program=main, scope=scope,
            mesh=make_mesh({"dp": 2, "pp": 2}, place=CPU))
        steps = PP_TRAIN_STEPS if tag == "gpipe" else PP_STEPS
        with collectives.counting() as seen:
            out[f"{tag}_pp"] = [float(np.asarray(pe.run(
                feed=f, fetch_list=[loss.name])[0]).reshape(()))
                for f in feeds[:steps]]
        out[f"{tag}_collectives"] = dict(seen)
        out[f"{tag}_placements"] = {
            k: [str(p) for p in scope.find_var(k).placements]
            for k in ("blocks.wq", "blocks.wq_moment1_0", "tok_emb")}
        out[f"{tag}_trained"] = {k: to_numpy(scope.find_var(k))
                                 for k in ("blocks.wq", "lm_head")}
    # the 1F1B op on a mesh without a 'pp' axis: each rank's batch block
    # through every layer, the per-token losses averaged over the blocks
    pe = fluid.ParallelExecutor(loss_name=floss.name, main_program=fmain,
                                scope=_copy(init),
                                mesh=make_mesh({"dp": 4}, place=CPU))
    out["1f1b_dp4"] = [float(np.asarray(pe.run(
        feed=f, fetch_list=[floss.name])[0]).reshape(()))
        for f in feeds[:3]]
    return out


# ----------------------------------------------------------------------
# tests/test_attention.py's ring cases and tests/test_llama.py's
# shard_sp case, over sp 4
# ----------------------------------------------------------------------
def ring_inputs(seed, shape, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * scale).astype(np.float32)
            for _ in range(3)]


RING_SHAPE, LONG_SHAPE = (2, 2, 64, 16), (1, 2, 1024, 16)
SP_SEQ = 2048


def _sharded(mesh, arrays, grad=False):
    """Each array as a DTensor split on T (dim 2) over 'sp'."""
    from torch.distributed.tensor import DTensor, Shard
    n, i = mesh.axes["sp"], mesh.coordinate("sp")
    out = []
    for a in arrays:
        t = a.shape[2] // n
        local = torch.tensor(a[:, :, i * t:(i + 1) * t], requires_grad=grad)
        out.append((local, DTensor.from_local(local, mesh.mesh, [Shard(2)],
                                              run_check=False)))
    return out


def ring_cases(rank, world):
    """Ring attention over sp 4: the DTensor entry and the chunk entry
    against each other, causal and not; T 1024 with the gradient of a
    weighted sum through the ring; the sp-split Llama's loss against the
    single device's (the rope-position check); long-context training
    through ``build_llama(shard_sp=True)``; and multihead_attention with
    ``scale=`` set on the ring."""
    from paddle_tpu_torch.parallel.ring_attention import (
        ring_attention, ring_attention_sharded)
    from torch_mesh_cases import _copy, _init, _llama_train, _state
    out = {}
    mesh = make_mesh({"sp": 4}, place=CPU)
    qkv = ring_inputs(0, RING_SHAPE)
    for causal in (False, True):
        (_, q), (_, k), (_, v) = _sharded(mesh, qkv)
        got = ring_attention_sharded(q, k, v, mesh, axis="sp",
                                     causal=causal)
        out[f"ring_{causal}"] = to_numpy(got.full_tensor())
        chunk = ring_attention(q.to_local(), k.to_local(), v.to_local(),
                               "sp", causal=causal, mesh=mesh)
        out[f"chunk_equal_{causal}"] = bool(torch.equal(chunk,
                                                        got.to_local()))
    # T 1024 (256 a rank), and the gradient back round the ring
    long = ring_inputs(1, LONG_SHAPE, 0.3)
    (lq, q), (lk, k), (lv, v) = _sharded(mesh, long, grad=True)
    got = ring_attention_sharded(q, k, v, mesh, axis="sp", causal=True)
    out["long"] = to_numpy(got.full_tensor())
    wts = torch.tensor(np.random.RandomState(2).randn(
        *LONG_SHAPE).astype(np.float32))
    n, i = 4, mesh.coordinate("sp")
    t = LONG_SHAPE[2] // n
    (got.to_local() * wts[:, :, i * t:(i + 1) * t]).sum().backward()
    out["long_grads"] = [_concat_seq(mesh, x.grad) for x in (lq, lk, lv)]

    # the sp-split Llama (LLAMA_TINY, seq 16: 4 tokens a rank) against
    # the single device, SGD(0)
    from paddle_tpu_torch.models.llama import LLAMA_TINY
    main, startup, loss = _llama_train(LLAMA_TINY, shard_sp=True)
    init = _state(_init(startup))
    out["sp_init"] = init
    feed = llama_data(0)
    out["sp_plain"] = float(np.asarray(fluid.Executor(CPU).run(
        main, feed=feed, fetch_list=[loss], scope=_copy(init))[0]))
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                scope=_copy(init), mesh=mesh)
    from paddle_tpu_torch.parallel import spmd
    seen, rule = [], spmd.RULES["multihead_attention"]

    def recording(sp, ctx, ins, attrs, lower):
        seen.append([str(p) for s in ("Q", "K", "V")
                     for p in ins[s][0].placements])
        return rule(sp, ctx, ins, attrs, lower)

    spmd.RULES["multihead_attention"] = recording
    try:
        with collectives.counting() as counts:
            out["sp_pe"] = float(np.asarray(pe.run(
                feed=feed, fetch_list=[loss.name])[0]))
    finally:
        spmd.RULES["multihead_attention"] = rule
    out["sp_attention_placements"] = seen
    out["sp_collectives"] = dict(counts)

    # long-context training: seq 2048 over sp 4, 3 Adam steps on one batch
    from paddle_tpu_torch.models.llama import LlamaConfig
    cfg = LlamaConfig(vocab_size=128, dim=32, n_layers=1, n_heads=2,
                      n_kv_heads=2, ffn_hidden=64, dtype="float32")
    main, startup, loss = _llama_train(cfg, seq=SP_SEQ, shard_sp=True)
    init = _state(_init(startup))
    out["long_init"] = init
    toks = np.random.RandomState(0).randint(0, 128, (2, SP_SEQ)).astype(
        np.int64)
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                scope=_copy(init), mesh=mesh)
    out["long_losses"] = [float(np.asarray(pe.run(
        feed={"tokens": toks, "targets": np.roll(toks, -1, 1)},
        fetch_list=[loss.name])[0])) for _ in range(3)]

    # multihead_attention(scale=0.5) on the ring: 1/sqrt(D) all the same
    feed = dict(zip("qkv", (a.transpose(0, 2, 1, 3) for a in qkv)))
    for scale in (0.5, None):
        prog, o = attention_program(fluid, scale)
        out[f"plain_{scale}"] = fluid.Executor(CPU).run(
            prog, feed=feed, fetch_list=[o], scope=fluid.Scope())[0]
    pe = fluid.ParallelExecutor(main_program=prog, scope=fluid.Scope(),
                                mesh=mesh)
    out["ring_0.5"] = pe.run(feed=feed, fetch_list=[o.name])[0]
    return out


def attention_program(fluid, scale, spec=None):
    """q, k, v [B, 64, 2, 16] split on T over 'sp' into one causal
    multihead_attention with ``scale`` (either package's ``fluid`` and
    PartitionSpec class)."""
    from paddle_tpu_torch.sharding import PartitionSpec
    spec = spec or PartitionSpec
    prog = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog,
                                                        fluid.Program()):
        xs = [fluid.layers.data(name=nm, shape=[-1, 64, 2, 16],
                                dtype="float32", append_batch_size=False)
              for nm in "qkv"]
        for x in xs:
            x.sharding = spec(None, "sp")
        o = fluid.layers.multihead_attention(*xs, causal=True, scale=scale)
    return prog, o


def _concat_seq(mesh, g):
    """Rank 0 gets the 'sp' chunks of ``g`` concatenated on T (dim 2)."""
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (mesh.coordinate("sp"), to_numpy(g)))
    blocks = dict(got)
    return np.concatenate([blocks[i] for i in sorted(blocks)], axis=2)
