"""Case functions the port's mesh tests run on gloo ranks
(``torch_mesh_ranks.run_ranks``). Each runs on every rank of the group
and returns plain Python / numpy values (rank 0's reach the test). This
module imports torch and the port only: the ranks never import jax or
paddle_tpu."""
import os

import numpy as np
import torch
import torch.distributed as dist

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core.executor import to_numpy
from paddle_tpu_torch.parallel import (ShardingTranspiler, collectives,
                                       make_mesh)

CPU = fluid.CPUPlace()


# ----------------------------------------------------------------------
# the MLP and the conv net of tests/test_parallel.py
# ----------------------------------------------------------------------
def build_model():
    img = fluid.layers.data(name="img", shape=[32], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    h = fluid.layers.fc(img, size=64, act="relu")
    h = fluid.layers.fc(h, size=64, act="relu")
    logits = fluid.layers.fc(h, size=4)
    return fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))


def batch(seed, n=32):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 4, (n, 1)).astype(np.int64)
    x = (np.eye(4, 32)[y[:, 0]] * 3 + rng.randn(n, 32) * 0.3).astype(
        np.float32)
    return x, y


def build_conv_bn_model():
    img = fluid.layers.data(name="img", shape=[3, 16, 16], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    h = fluid.layers.conv2d(img, num_filters=8, filter_size=3, padding=1,
                            bias_attr=False)
    h = fluid.layers.batch_norm(h, act="relu")
    h = fluid.layers.pool2d(h, pool_size=2, pool_stride=2, pool_type="max")
    h = fluid.layers.conv2d(h, num_filters=16, filter_size=3, padding=1,
                            bias_attr=False)
    h = fluid.layers.batch_norm(h, act="relu")
    h = fluid.layers.pool2d(h, global_pooling=True, pool_type="avg")
    logits = fluid.layers.fc(h, size=4)
    return fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))


def build_dropout_model():
    img = fluid.layers.data(name="img", shape=[32], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    h = fluid.layers.dropout(fluid.layers.fc(img, size=64, act="relu"),
                             0.3)
    return fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
        fluid.layers.fc(h, size=4), label))


def conv_batch(seed, n=32):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 4, (n, 1)).astype(np.int64)
    x = rng.randn(n, 3, 16, 16).astype(np.float32) * 0.5
    x += y[:, :, None, None] * 0.3
    return x, y


def _programs(build, opt, seed):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = build()
        opt().minimize(loss)
    main.random_seed = startup.random_seed = seed
    return main, startup, loss


def _init(startup):
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)
    return scope


def _state(scope):
    return {k: to_numpy(v) for k, v in scope.vars.items()
            if v is not None}


def _copy(state):
    scope = fluid.Scope()
    for k, v in state.items():
        scope.set(k, torch.as_tensor(np.array(v)))
    return scope


def _gather_flags(flag):
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, flag)
    return flags


def _loss(out):
    return float(np.asarray(out[0]).reshape(()))


def _run_plain(main, scope, loss, batches):
    exe = fluid.Executor(CPU)
    return [_loss(exe.run(main, feed={"img": x, "label": y},
                          fetch_list=[loss], scope=scope))
            for x, y in batches]


def _run_pe(main, scope, loss, batches, axes):
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                scope=scope, mesh=make_mesh(axes, place=CPU))
    return pe, [_loss(pe.run(feed={"img": x, "label": y},
                             fetch_list=[loss.name]))
                for x, y in batches]


def parallel_cases(rank, world):
    """The cases of tests/test_parallel.py on ``world`` ranks."""
    out = {}
    # dp matches single device (and gives the reference its inputs)
    main, startup, loss = _programs(
        build_model, lambda: fluid.optimizer.SGD(learning_rate=0.1), 5)
    init = _state(_init(startup))
    batches = [batch(s) for s in range(5)]
    out["init"], out["batches"] = init, batches
    out["single"] = _run_plain(main, _copy(init), loss, batches)
    pe, out["dp"] = _run_pe(main, _copy(init), loss, batches,
                            {"dp": world})
    out["device_count"] = pe.device_count
    st = pe.compiled_stats([loss.name], feed=dict(zip(("img", "label"),
                                                      batch(0))))
    out["dp_stats"] = st
    # dp trains
    _, out["dp_train"] = _run_pe(main, _copy(init), loss,
                                 [batch(s) for s in range(20)],
                                 {"dp": world})
    # tp matches replicated (lr 0: a pure forward)
    main, startup, loss = _programs(
        build_model, lambda: fluid.optimizer.SGD(learning_rate=0.0), 3)
    init = _state(_init(startup))
    out["tp_ref"] = _run_plain(main, _copy(init), loss, [batch(0)])
    ShardingTranspiler().tensor_parallel(main, axis="tp")
    pe, out["tp"] = _run_pe(main, _copy(init), loss, [batch(0)],
                            {"tp": world})
    out["tp_stats"] = pe.compiled_stats(
        [loss.name], feed=dict(zip(("img", "label"), batch(1))))
    # ZeRO: moments sharded over dp, params replicated
    main, startup, loss = _programs(
        build_model, lambda: fluid.optimizer.Adam(learning_rate=0.01), 4)
    ShardingTranspiler().shard_optimizer(main, axis="dp")
    init = _state(_init(startup))
    out["zero_ref"] = _run_plain(main, _copy(init), loss,
                                 [batch(s) for s in range(10)])
    scope = _copy(init)
    _, out["zero"] = _run_pe(main, scope, loss,
                             [batch(s) for s in range(10)], {"dp": world})
    out["zero_placements"] = {
        k: [str(p) for p in v.placements] for k, v in scope.vars.items()
        if hasattr(v, "placements") and k.startswith("fc_0.w_0")}
    # the sharded scope saved: every rank gathers, rank 0 alone writes
    import tempfile
    d = tempfile.mkdtemp()
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(fluid.Executor(CPU), d, main)
    out["saved"] = os.path.exists(os.path.join(d, "params.npz"))
    whole = {k: to_numpy(scope.find_var(k))       # a collective: all ranks
             for k in ("fc_0.w_0", "fc_0.w_0_moment1_0")}
    if out["saved"]:
        with np.load(os.path.join(d, "params.npz")) as z:
            out["saved_equal"] = all(np.array_equal(z[k], v)
                                     for k, v in whole.items())
    out["saved_by_rank"] = _gather_flags(out["saved"])
    # SyncBN: conv + batch_norm under dp equals single device
    main, startup, loss = _programs(
        build_conv_bn_model,
        lambda: fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9),
        7)
    init = _state(_init(startup))
    batches = [conv_batch(s) for s in range(4)]
    s1, s2 = _copy(init), _copy(init)
    out["bn_single"] = _run_plain(main, s1, loss, batches)
    pe, out["bn_dp"] = _run_pe(main, s2, loss, batches, {"dp": world})
    # the moving statistics (the reference test's ".global_" names)
    stats = sorted(k for k in s1.vars if "batch_norm" in k
                   and ".global_" in k)
    out["bn_stats"] = {k: (to_numpy(s1.find_var(k)),
                           to_numpy(s2.find_var(k))) for k in stats}
    _, out["bn_train"] = _run_pe(main, _copy(init), loss,
                                 [conv_batch(s % 3) for s in range(12)],
                                 {"dp": world})
    out["bn_stats_coll"] = pe.compiled_stats(
        [loss.name], feed=dict(zip(("img", "label"), conv_batch(0))))[
            "collectives"]
    # quantized all-reduce against the exact one
    mesh = make_mesh({"dp": world}, place=CPU)
    grads = np.random.RandomState(0).randn(world, 64).astype(np.float32)
    g = torch.as_tensor(grads[rank])
    approx = collectives.quantized_all_reduce(g, "dp", mesh=mesh)
    again = collectives.quantized_all_reduce(g, "dp", mesh=mesh)
    exact = collectives.all_reduce(g, "dp", mesh=mesh)
    out["qar"] = (approx.numpy(), again.numpy(), exact.numpy(),
                  grads.sum(0))
    # dropout under dp draws the single device's mask (the mask is drawn
    # whole and each rank keeps its rows)
    main, startup, loss = _programs(build_dropout_model,
                                    lambda: fluid.optimizer.SGD(0.1), 8)
    init = _state(_init(startup))
    batches = [batch(s) for s in range(3)]
    out["dropout_ref"] = _run_plain(main, _copy(init), loss, batches)
    _, out["dropout_dp"] = _run_pe(main, _copy(init), loss, batches,
                                   {"dp": world})
    # the distributed table (tests/test_sparse_embedding.py): rows over
    # 'mp' give the replicated table's losses
    main, startup, loss = _programs(build_table_model,
                                    lambda: fluid.optimizer.Adam(0.01), 6)
    init = _state(_init(startup))
    feeds = [table_batch(s) for s in range(3)]
    out["table_ref"] = _table_steps(fluid.Executor(CPU), main, _copy(init),
                                    loss, feeds)
    dmain, _, dloss = _programs(lambda: build_table_model(True),
                                lambda: fluid.optimizer.Adam(0.01), 6)
    scope = _copy(init)
    pe = fluid.ParallelExecutor(loss_name=dloss.name, main_program=dmain,
                                scope=scope,
                                mesh=make_mesh({"mp": world}, place=CPU))
    out["table_mp"] = [_loss(pe.run(feed=f, fetch_list=[dloss.name]))
                       for f in feeds]
    out["table_placements"] = {
        k: [str(p) for p in v.placements] for k, v in scope.vars.items()
        if k.startswith("embedding_0.w_0") and hasattr(v, "placements")}
    out["table_stats"] = pe.compiled_stats([dloss.name], feed=feeds[0])[
        "collectives"]
    return out


TABLE_VOCAB, FIELDS = 64, 4


def build_table_model(distributed=False):
    feat = fluid.layers.data(name="feat", shape=[-1, FIELDS],
                             dtype="int64", append_batch_size=False)
    label = fluid.layers.data(name="label", shape=[-1, 1],
                              dtype="float32", append_batch_size=False)
    emb = fluid.layers.embedding(feat, size=[TABLE_VOCAB, 8],
                                 is_distributed=distributed)
    logit = fluid.layers.fc(fluid.layers.reshape(emb, [-1, FIELDS * 8]),
                            size=1)
    return fluid.layers.mean(
        fluid.layers.sigmoid_cross_entropy_with_logits(logit, label))


def table_batch(step, b=16):
    rng = np.random.RandomState(step)
    ids = rng.randint(0, TABLE_VOCAB, (b, FIELDS)).astype(np.int64)
    return {"feat": ids, "label": (ids[:, :1] % 2 == 0).astype(np.float32)}


def _table_steps(exe, main, scope, loss, feeds):
    return [_loss(exe.run(main, feed=f, fetch_list=[loss], scope=scope))
            for f in feeds]


# ----------------------------------------------------------------------
# Llama and MoE over dp x tp and dp x ep (tests/test_moe.py,
# tests/test_llama_generate.py)
# ----------------------------------------------------------------------
def _llama_cfg(**kw):
    from paddle_tpu_torch.models.llama import LlamaConfig
    base = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                ffn_hidden=64, dtype="float32")
    base.update(kw)
    return LlamaConfig(**base)


def _llama_train(cfg, seq=16, **kw):
    from paddle_tpu_torch.models.llama import build_llama
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tokens = fluid.layers.data(name="tokens", shape=[-1, seq],
                                   dtype="int64", append_batch_size=False)
        targets = fluid.layers.data(name="targets", shape=[-1, seq],
                                    dtype="int64", append_batch_size=False)
        _, loss = build_llama(cfg, tokens, targets, **kw)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    main.random_seed = startup.random_seed = 11
    return main, startup, loss


def _token_feeds(cfg, n, b=4, seq=16, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rng.randint(0, cfg.vocab_size, (b, seq + 1))
        out.append({"tokens": toks[:, :-1].astype(np.int64),
                    "targets": toks[:, 1:].astype(np.int64)})
    return out


def _steps(run, feeds, loss):
    return [_loss(run(f)) for f in feeds]


def _plain_steps(main, scope, loss, feeds):
    exe = fluid.Executor(CPU)
    return _steps(lambda f: exe.run(main, feed=f, fetch_list=[loss],
                                    scope=scope), feeds, loss)


def _pe_steps(main, scope, loss, feeds, axes):
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                scope=scope, mesh=make_mesh(axes, place=CPU))
    return pe, _steps(lambda f: pe.run(feed=f, fetch_list=[loss.name]),
                      feeds, loss)


def _generator(cfg, prompt_len, new, **kw):
    from paddle_tpu_torch.models.llama import build_llama_generator
    gen = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(gen,
                                                        fluid.Program()):
        ptok = fluid.layers.data(name="ptok", shape=[-1, prompt_len],
                                 dtype="int64", append_batch_size=False)
        out = build_llama_generator(cfg, ptok, max_new_tokens=new, **kw)
    return gen, out


def llama_mesh_cases(rank, world):
    """dp x tp Llama steps and the dense mesh generation cases, on 4
    ranks."""
    from paddle_tpu_torch.models.llama import quantize_generator_weights
    out = {}
    # build_llama(shard_dp, shard_tp) against the unsharded program
    cfg = _llama_cfg()
    feeds = _token_feeds(cfg, 3)
    main, startup, loss = _llama_train(cfg)
    init = _state(_init(startup))
    out["llama_ref"] = _plain_steps(main, _copy(init), loss, feeds)
    smain, _, sloss = _llama_train(cfg, shard_dp=True, shard_tp=True)
    scope = _copy(init)
    # the placements q, k and v reach attention with: batch over dp,
    # heads over tp, so the rule runs on each rank's own (no gather)
    from paddle_tpu_torch.parallel import spmd
    seen, rule = [], spmd.RULES["multihead_attention"]

    def recording(sp, ctx, ins, attrs, lower):
        seen.append([[str(p) for p in ins[s][0].placements]
                     for s in ("Q", "K", "V")])
        return rule(sp, ctx, ins, attrs, lower)

    spmd.RULES["multihead_attention"] = recording
    try:
        pe, out["llama_dp_tp"] = _pe_steps(smain, scope, sloss, feeds,
                                           {"dp": 2, "tp": 2})
    finally:
        spmd.RULES["multihead_attention"] = rule
    out["attention_placements"] = seen
    out["llama_tp_placements"] = {
        k: [str(p) for p in scope.find_var(k).placements]
        for k in ("l0.wq", "l0.wo", "tok_emb", "l0.wq_moment1_0")}
    out["llama_stats"] = pe.compiled_stats([sloss.name], feed=feeds[0])
    # the trained dp x tp scope, read back as global values
    out["llama_trained"] = {k: to_numpy(scope.find_var(k))
                            for k in ("l0.wq", "l1.w_down")}
    ref_scope = _copy(init)
    _plain_steps(main, ref_scope, loss, feeds)
    out["llama_trained_ref"] = {k: to_numpy(ref_scope.find_var(k))
                                for k in ("l0.wq", "l1.w_down")}
    # generation: dp x tp tokens equal the single device's
    gcfg = _llama_cfg()
    tmain, tstart, tloss = _llama_train(gcfg, shard_pp=True)
    gscope = _init(tstart)
    exe = fluid.Executor(CPU)
    for f in _token_feeds(gcfg, 2, seed=9):
        exe.run(tmain, feed=f, fetch_list=[tloss], scope=gscope)
    gstate = _state(gscope)
    prompt = np.random.RandomState(5).randint(0, gcfg.vocab_size,
                                              (4, 6)).astype(np.int64)
    gen, gout = _generator(gcfg, 6, 5)
    out["gen_ref"] = np.asarray(exe.run(gen, feed={"ptok": prompt},
                                      fetch_list=[gout], mode="test",
                                      scope=_copy(gstate))[0])
    sgen, sout = _generator(gcfg, 6, 5, shard_tp=True, shard_dp=True)
    pe = fluid.ParallelExecutor(main_program=sgen, scope=_copy(gstate),
                                mesh=make_mesh({"dp": 2, "tp": 2},
                                               place=CPU))
    out["gen_dp_tp"] = pe.run(feed={"ptok": prompt},
                              fetch_list=[sout.name])[0]
    out["gen_stats"] = pe.compiled_stats([sout.name],
                                         feed={"ptok": prompt})[
        "collectives"]
    # quantized generation on a dp mesh equals its own single device
    qscope = _copy(gstate)
    quantize_generator_weights(qscope)
    qgen, qout = _generator(gcfg, 6, 5, quantize=True, shard_dp=True)
    qprompt = np.random.RandomState(13).randint(
        0, gcfg.vocab_size, (8, 6)).astype(np.int64)
    out["qgen_ref"] = np.asarray(exe.run(qgen, feed={"ptok": qprompt},
                                       fetch_list=[qout], mode="test",
                                       scope=qscope)[0])
    pe = fluid.ParallelExecutor(main_program=qgen, scope=qscope,
                                mesh=make_mesh({"dp": 4}, place=CPU))
    out["qgen_dp"] = pe.run(feed={"ptok": qprompt},
                            fetch_list=[qout.name])[0]
    return out


def moe_mesh_cases(rank, world):
    """The MoE Llama at dp x ep against one device (the reference's
    test_moe_expert_parallel_sharded_step, held to the single device),
    and MoE generation at dp x tp, on 4 ranks."""
    from paddle_tpu_torch.models.llama import stack_generator_weights
    out = {}
    mcfg = _llama_cfg(ffn_hidden=48, moe_experts=4, moe_top_k=2)
    mfeeds = _token_feeds(mcfg, 3, seed=5)
    main, startup, loss = _llama_train(mcfg, shard_dp=True)
    minit = _state(_init(startup))
    out["moe_ref"] = _plain_steps(main, _copy(minit), loss, mfeeds)
    pe, out["moe_dp_ep"] = _pe_steps(main, _copy(minit), loss, mfeeds,
                                     {"dp": 2, "ep": 2})
    out["moe_stats"] = pe.compiled_stats([loss.name], feed=mfeeds[0])[
        "collectives"]
    exe = fluid.Executor(CPU)
    prompt = np.random.RandomState(5).randint(0, mcfg.vocab_size,
                                              (4, 6)).astype(np.int64)
    # MoE generation under dp x tp (experts split inside) equals one
    # device's
    mscope = _copy(minit)
    stack_generator_weights(mcfg, mscope)
    mgen, mgout = _generator(mcfg, 6, 5)
    out["moe_gen_ref"] = np.asarray(exe.run(mgen, feed={"ptok": prompt},
                                          fetch_list=[mgout], mode="test",
                                          scope=mscope)[0])
    smgen, smout = _generator(mcfg, 6, 5, shard_tp=True, shard_dp=True)
    pe = fluid.ParallelExecutor(main_program=smgen, scope=mscope,
                                mesh=make_mesh({"dp": 2, "tp": 2},
                                               place=CPU))
    out["moe_gen_dp_tp"] = pe.run(feed={"ptok": prompt},
                                  fetch_list=[smout.name])[0]
    return out
