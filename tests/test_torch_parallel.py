"""The port's ParallelExecutor and sharding transpilers, held to the
cases of tests/test_parallel.py and the distributed table of
tests/test_sparse_embedding.py.

The sharded cases run on 2 gloo ranks (torch_mesh_ranks.run_ranks, one
spawned group for the module, with its own timeout); the ranks import
only torch and the port. Tolerances are the reference tests' own: dp
against one device rtol 2e-3 / atol 2e-4 (the port's single device and
the reference's dp-8 run), tp against replicated rtol 1e-4, conv+BN
under dp (SyncBN) rtol 2e-4 / atol 2e-5, the row-sharded table rtol
2e-4, the quantized all-reduce within 2e-2 of the exact one.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import paddle_tpu_torch as fluid
from paddle_tpu_torch import parallel
from torch_mesh_ranks import shared_ranks

WORLD = 2


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return shared_ranks("torch_mesh_cases", "parallel_cases", WORLD,
                        tmp_path_factory, timeout=180)


@pytest.fixture
def one_rank():
    """A one-rank gloo group in this process (make_mesh starts it),
    destroyed after the test."""
    fresh = not dist.is_initialized()
    yield
    if fresh and dist.is_initialized():
        dist.destroy_process_group()


def _ref_model(jf):
    img = jf.layers.data(name="img", shape=[32], dtype="float32")
    label = jf.layers.data(name="label", shape=[1], dtype="int64")
    h = jf.layers.fc(img, size=64, act="relu")
    h = jf.layers.fc(h, size=64, act="relu")
    logits = jf.layers.fc(h, size=4)
    return jf.layers.mean(jf.layers.softmax_with_cross_entropy(logits,
                                                               label))


def _reference_dp8(init, batches):
    """The reference's dp-8 run from the port's initial weights."""
    import paddle_tpu as jf
    from paddle_tpu.parallel import make_mesh as jmesh
    main, startup = jf.Program(), jf.Program()
    with jf.unique_name.guard(), jf.program_guard(main, startup):
        loss = _ref_model(jf)
        jf.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope = jf.Scope()
    with jf.scope_guard(scope):
        jf.Executor(jf.CPUPlace()).run(startup)
        for k, v in init.items():
            scope.set(k, np.asarray(v))
        pe = jf.ParallelExecutor(loss_name=loss.name, main_program=main,
                                 scope=scope, mesh=jmesh({"dp": 8}))
        return [float(np.asarray(pe.run(feed={"img": x, "label": y},
                                         fetch_list=[loss.name])[0])
                      .reshape(())) for x, y in batches]


def test_data_parallel_trains(cases):
    losses = cases["dp_train"]
    assert cases["device_count"] == WORLD
    assert losses[-1] < losses[0] * 0.6, losses


def test_data_parallel_matches_single_device(cases):
    """Same seed, same data: dp-2 tracks the port's single device and the
    reference's dp-8 run."""
    np.testing.assert_allclose(cases["single"], cases["dp"], rtol=2e-3,
                               atol=2e-4)
    ref = _reference_dp8(cases["init"], cases["batches"])
    np.testing.assert_allclose(ref, cases["dp"], rtol=2e-3, atol=2e-4)


def test_tensor_parallel_matches_replicated(cases):
    np.testing.assert_allclose(cases["tp_ref"], cases["tp"], rtol=1e-4)


def test_zero_optimizer_sharding(cases):
    """Adam moments sharded over dp (Shard(0)), params replicated; the
    losses fall and equal the single device's."""
    losses = cases["zero"]
    assert losses[-1] < losses[0], losses
    np.testing.assert_allclose(cases["zero_ref"], losses, rtol=2e-3,
                               atol=2e-4)
    pl = cases["zero_placements"]
    assert pl["fc_0.w_0"] == ["R"]
    assert pl["fc_0.w_0_moment1_0"] == ["S(0)"]
    assert pl["fc_0.w_0_moment2_0"] == ["S(0)"]


def test_sharded_scope_saves_once_as_global_values(cases):
    """save_persistables over a ParallelExecutor's scope: every rank
    gathers the placed values, rank 0 alone writes, and the file holds
    the global values."""
    assert cases["saved_by_rank"] == [True] + [False] * (WORLD - 1)
    assert cases["saved_equal"]


def test_dropout_under_dp_draws_as_one_device(cases):
    """A dp step's dropout masks are the single device's (rtol 2e-3 /
    atol 2e-4 on the losses, as the dp case)."""
    np.testing.assert_allclose(cases["dropout_ref"], cases["dropout_dp"],
                               rtol=2e-3, atol=2e-4)


def test_distribute_transpiler_compat():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = _ref_model(fluid)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
        t = fluid.DistributeTranspiler()
        t.transpile(trainer_id=0, trainers=8)
        prog = t.get_trainer_program()
    assert prog is main
    assert main.global_block().var("fc_0.w_0_moment1_0").sharding == \
        ("dp", None)
    with pytest.raises(NotImplementedError):
        t.get_pserver_program("127.0.0.1:6174")
    eps = ["a:1", "b:2"]
    assert fluid.transpiler.RoundRobin(eps).dispatch(
        [main.global_block().var(n) for n in ("fc_0.w_0", "fc_1.w_0",
                                              "fc_2.w_0")]) == \
        ["a:1", "b:2", "a:1"]


def test_quantized_all_reduce_close_to_exact(cases):
    approx, again, exact, total = cases["qar"]
    np.testing.assert_allclose(exact, total, rtol=1e-6, atol=1e-6)
    rel = np.abs(approx - exact).max() / np.abs(exact).max()
    assert rel < 2e-2, rel
    np.testing.assert_array_equal(approx, again)


def test_compiled_stats_reports_collectives(cases, one_rank):
    """dp-2's step all-reduces (the gradient sync and the loss mean);
    a one-rank dp mesh issues no collective."""
    st = cases["dp_stats"]
    assert st["mesh"] == {"dp": WORLD}
    assert st["n_kernels"] > 0 and st["flops"] > 0
    coll = st["collectives"]
    assert sum(coll.get(k, 0) for k in
               ("all-reduce", "reduce-scatter", "all-gather")) > 0, coll
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = _ref_model(fluid)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    pe = fluid.ParallelExecutor(
        loss_name=loss.name, main_program=main, scope=scope,
        mesh=parallel.make_mesh({"dp": 1}, place=fluid.CPUPlace()))
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(4, 32).astype(np.float32),
            "label": rng.randint(0, 4, (4, 1)).astype(np.int64)}
    st1 = pe.compiled_stats([loss.name], feed=feed)
    assert st1["mesh"] == {"dp": 1}
    assert not st1["collectives"], st1["collectives"]


def test_compiled_stats_tp_mesh_gathers(cases):
    """The column- and row-split fc pair's partial sums are reduced on
    the activation path."""
    coll = cases["tp_stats"]["collectives"]
    assert sum(coll.values()) >= 2, coll


def test_conv_bn_dp_matches_single_device(cases):
    """SyncBN: dp batch statistics are the global batch's, so the losses
    and the moving statistics equal the single device's."""
    l1s, l2s = cases["bn_single"], cases["bn_dp"]
    np.testing.assert_allclose(l1s, l2s, rtol=2e-4, atol=2e-5)
    assert l1s[-1] < l1s[0], l1s
    assert len(cases["bn_stats"]) == 4
    for k, (a, b) in cases["bn_stats"].items():
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5, err_msg=k)


def test_conv_bn_dp_trains(cases):
    losses = cases["bn_train"]
    assert losses[-1] < losses[0] * 0.7, losses
    coll = cases["bn_stats_coll"]
    assert sum(coll.get(k, 0) for k in
               ("all-reduce", "reduce-scatter", "all-gather")) > 0, coll


def test_distributed_table_matches_replicated(cases):
    """embedding(is_distributed=True): the table and its Adam moments
    are row-sharded over 'mp', and the losses equal the replicated
    table's."""
    np.testing.assert_allclose(cases["table_ref"], cases["table_mp"],
                               rtol=2e-4)
    pl = cases["table_placements"]
    for k in ("embedding_0.w_0", "embedding_0.w_0_moment1_0",
              "embedding_0.w_0_moment2_0"):
        assert pl[k] == ["S(0)"], pl
    assert cases["table_stats"].get("all-reduce", 0) > 0


def test_mesh_larger_than_the_world_raises(one_rank):
    """No fallback to host devices: a mesh the world cannot hold raises,
    naming how to start ranks."""
    mesh = parallel.make_mesh(place=fluid.CPUPlace())
    assert mesh.axes == {"dp": dist.get_world_size()}
    with pytest.raises(ValueError, match="init_distributed"):
        parallel.make_mesh({"dp": dist.get_world_size() + 1},
                           place=fluid.CPUPlace())
    with parallel.mesh_scope(mesh):
        assert parallel.current_mesh() is mesh
        # a host tensor reduces on the host's gloo group
        t = torch.ones(3)
        np.testing.assert_array_equal(
            parallel.collectives.all_reduce(t, "dp").numpy(),
            np.full(3, float(dist.get_world_size())))
    assert parallel.current_mesh() is None
