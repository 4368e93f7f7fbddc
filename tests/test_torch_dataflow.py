"""Dataflow analysis, DCE/CSE and the PADDLE_TPU_OPTIMIZE executor hook
of the torch port (``paddle_tpu_torch.analysis``) against the JAX
package's.

Mirrors tests/test_dataflow.py's TestOpEffects, TestDefUse, TestDCE,
TestCSE, TestExecutorOptimizeHook and TestNewVerifierPasses: each case
asserts on the port what the reference test asserts, on the same
program built with each package's layer code, and that the two
packages agree exactly — effect summaries, def-use sites, liveness,
rewrite reports (every folded/fused/merged/removed record), the op-type
sequence after the rewrite, and the verifier's findings. A rewritten
program's fetches are bit-identical to the original's
(``np.array_equal``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.analysis import dataflow as jdataflow
from paddle_tpu.models import zoo as jzoo

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.analysis import dataflow
from paddle_tpu_torch.analysis.optimize import optimize_program
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.models import zoo as tzoo

torch.set_num_threads(1)

PACKAGES = {"jax": (jfluid, jdataflow, jzoo),
            "torch": (tfluid, dataflow, tzoo)}
CPU = tfluid.CPUPlace()


def _codes(diags, level=None):
    return [d.code for d in diags if level is None or d.level == level]


def _key(diags):
    return [(d.code, d.level, d.block_idx, d.op_idx, d.message)
            for d in diags]


def _build(fluid, build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        extra = build(fluid)
    return main, startup, extra


def _both(build):
    return {k: _build(p[0], build) for k, p in PACKAGES.items()}


def _types(prog):
    return [op.type for op in prog.global_block().ops]


def _records(report):
    return (report.folded, report.fused, report.merged, report.removed,
            report.iterations)


def _optimize_both(build, fetch, **kw):
    """Both packages' programs after ``optimize(fetch, **kw)``:
    {package: (main, startup, build's result, report)}; asserts the two
    rewrites agree record for record and op for op."""
    progs = _both(build)
    out = {}
    for k, (main, startup, extra) in progs.items():
        names = fetch(extra) if callable(fetch) else fetch
        report = (optimize_program(main, fetch_list=names,
                                   device=torch.device("cpu"), **kw)
                  if k == "torch" else main.optimize(fetch_list=names, **kw))
        out[k] = (main, startup, extra, report)
    assert _records(out["torch"][3]) == _records(out["jax"][3])
    assert _types(out["torch"][0]) == _types(out["jax"][0])
    return out


def _gb(fluid):
    return fluid.default_main_program().global_block()


def _regression(fluid, minimize=True):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(x, size=1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    if minimize:
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    else:
        fluid.append_backward(loss)
    return loss


def _effects(eff):
    return (sorted(eff.reads), sorted(eff.writes), sorted(eff.inplace),
            eff.stateful, eff.barrier, eff.has_subblock)


def _all_effects(k, main):
    return [_effects(PACKAGES[k][1].op_effects(op))
            for b in main.blocks for op in b.ops]


# ---------------------------------------------------------------------------
# effect summaries
# ---------------------------------------------------------------------------

class TestOpEffects:
    def test_optimizer_update_is_inplace(self):
        progs = _both(_regression)
        sgd = [op for op in progs["torch"][0].global_block().ops
               if op.type == "sgd"]
        assert sgd
        eff = dataflow.op_effects(sgd[0])
        # ParamOut aliases Param: a read-modify-write
        assert eff.inplace
        assert eff.inplace <= eff.reads and eff.inplace <= eff.writes
        assert _all_effects("torch", progs["torch"][0]) \
            == _all_effects("jax", progs["jax"][0])

    def test_backward_marker_writes_grads_and_is_barrier(self):
        progs = _both(lambda f: _regression(f, minimize=False))
        main, _, loss = progs["torch"]
        bwd = [op for op in main.global_block().ops
               if op.type == "backward"][0]
        eff = dataflow.op_effects(bwd)
        assert eff.barrier
        assert any(n.endswith("@GRAD") for n in eff.writes)
        assert loss.name in eff.reads
        assert _all_effects("torch", main) \
            == _all_effects("jax", progs["jax"][0])

    def test_stateful_and_subblock_flags(self):
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            fluid.layers.dropout(x, dropout_prob=0.5)
            _gb(fluid).append_op("no_such_op", inputs={"X": [x.name]},
                                 outputs={"Out": ["o"]})
        progs = _both(build)
        ops = progs["torch"][0].global_block().ops
        drop = [op for op in ops if op.type == "dropout"][0]
        assert dataflow.op_effects(drop).stateful
        # unknown op types are conservatively stateful
        assert dataflow.op_effects(ops[-1]).stateful
        # the port's statefulness is the reference's, op for op
        assert _all_effects("torch", progs["torch"][0]) \
            == _all_effects("jax", progs["jax"][0])

    def test_statefulness_of_every_shared_op_equals_the_reference(self):
        """Random draws are keyed by their count: an op the reference
        treats as drawing must draw in the port too, or removing or
        merging it would shift later draws in one package only."""
        from paddle_tpu.core import registry as jregistry
        for t in registry.registered_op_types():
            assert registry.get_op(t).stateful \
                == jregistry.get_op(t).stateful, t

    def test_attr_name_refs_cover_while_bindings(self):
        def build(fluid):
            main = fluid.default_main_program()
            gb = main.global_block()
            gb.create_var(name="cond", dtype="bool")
            sub = main.create_block()
            main.rollback()
            gb.append_op("while", attrs={"sub_block": sub,
                                         "condition": "cond",
                                         "carry_names": ["c1", "c2"]})
        progs = _both(build)
        op = progs["torch"][0].global_block().ops[-1]
        eff = dataflow.op_effects(op)
        assert {"cond", "c1", "c2"} <= eff.reads
        assert eff.barrier and eff.has_subblock
        assert dataflow.pinned_names(progs["torch"][0].global_block()) \
            == jdataflow.pinned_names(progs["jax"][0].global_block())


# ---------------------------------------------------------------------------
# def-use chains and liveness
# ---------------------------------------------------------------------------

def _du(k, main):
    du = PACKAGES[k][1].def_use(main)
    return du.defs, du.uses


class TestDefUse:
    def test_sites(self):
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            h = fluid.layers.fc(x, size=4)
            fluid.layers.relu(h)
            return x.name, h.name
        progs = _both(build)
        main, _, (x, h) = progs["torch"]
        du = dataflow.def_use(main)
        assert du.def_sites(0, h)
        assert du.use_sites(0, x)
        assert du.single_def(0, h)
        assert _du("torch", main) == _du("jax", progs["jax"][0])

    def test_def_versions_track_rebinding(self):
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            gb = _gb(fluid)
            gb.append_op("relu", inputs={"X": [x.name]},
                         outputs={"Out": ["t"]})
            gb.append_op("relu", inputs={"X": ["t"]},
                         outputs={"Out": ["t"]})        # rebinds t
            gb.append_op("relu", inputs={"X": ["t"]},
                         outputs={"Out": ["u"]})
            return x.name
        progs = _both(build)
        main, _, x = progs["torch"]
        vers = dataflow.def_versions(main.global_block(), seed_names=[x])
        assert vers[-2]["t"] == 1       # reads the first binding
        assert vers[-1]["t"] == 2       # reads the second binding
        assert vers == jdataflow.def_versions(
            progs["jax"][0].global_block(), seed_names=[x])

    def test_live_sets_backward_transfer(self):
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            h = fluid.layers.fc(x, size=4)
            return h.name, fluid.layers.relu(h).name
        progs = _both(build)
        main, _, (h, r) = progs["torch"]
        gb = main.global_block()
        before, after = dataflow.live_sets(gb, {r})
        assert r in after[-1]
        # h is live right before the relu, dead after the last read
        ridx = [i for i, op in enumerate(gb.ops)
                if r in op.output_names()][0]
        assert h in before[ridx]
        assert h not in after[ridx]
        assert (before, after) == jdataflow.live_sets(
            progs["jax"][0].global_block(), {r})

    @pytest.mark.parametrize("name", tzoo.zoo_model_names())
    def test_train_residuals_equal_the_reference(self, name):
        lv = {}
        for k, (fluid, df, zoo) in PACKAGES.items():
            with fluid.unique_name.guard():
                zp = zoo.build_zoo_program(name)
            lv[k] = df.program_liveness(zp.main,
                                        [v.name for v in zp.fetch_list])
        # se_resnext's zoo entry is a forward program (no optimizer), in
        # the reference too: no backward marker and no residuals
        trains = lv["jax"].backward_idx is not None
        assert (lv["torch"].backward_idx is not None) == trains
        assert bool(lv["torch"].residual_names) == trains
        assert lv["torch"].live_before == lv["jax"].live_before
        assert lv["torch"].live_out == lv["jax"].live_out
        assert lv["torch"].residual_names == lv["jax"].residual_names


# ---------------------------------------------------------------------------
# DCE
# ---------------------------------------------------------------------------

class TestDCE:
    def test_removes_dead_chain(self):
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            live = fluid.layers.fc(x, size=4)
            dead = fluid.layers.fc(x, size=2)        # never fetched
            fluid.layers.relu(dead)                  # consumer of dead
            return live.name, dead.name
        n0 = len(_build(tfluid, build)[0].global_block().ops)
        out = _optimize_both(build, lambda e: [e[0]])
        main, _, (live, dead), report = out["torch"]
        assert report.n_removed >= 2
        assert len(main.global_block().ops) < n0
        produced = {n for op in main.global_block().ops
                    for n in op.output_names()}
        assert live in produced and dead not in produced
        assert sorted(main.global_block().vars) \
            == sorted(out["jax"][0].global_block().vars)

    def test_no_fetch_list_is_noop(self):
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            fluid.layers.fc(x, size=4)
        main = _build(tfluid, build)[0]
        n0 = len(main.global_block().ops)
        report = main.optimize()
        assert not report
        assert len(main.global_block().ops) == n0

    def test_keeps_stateful_ops(self):
        """A dead random op stays: removing it would shift the rng
        stream of every later stateful op."""
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            live = fluid.layers.fc(x, size=4)
            gb = _gb(fluid)
            gb.create_var(name="noise", dtype="float32")
            gb.append_op("gaussian_random", outputs={"Out": ["noise"]},
                         attrs={"shape": [4], "mean": 0.0, "std": 1.0})
            return live.name
        out = _optimize_both(build, lambda e: [e])
        assert "gaussian_random" in _types(out["torch"][0])

    @pytest.mark.parametrize("name", ["transformer", "llama"])
    def test_never_removes_optimizer_or_accumulator_writes(self, name):
        """Every persistable-writing op — optimizer updates (Adam's
        moments and beta powers), LR counters — survives DCE even
        though nothing fetches them."""
        def writers(main):
            persist = {n for n, v in main.global_block().vars.items()
                       if v.persistable}
            return [op.type for op in main.global_block().ops
                    if dataflow.op_effects(op).writes & persist]
        with tfluid.unique_name.guard():
            zp = tzoo.build_zoo_program(name)
        with jfluid.unique_name.guard():
            jzp = jzoo.build_zoo_program(name)
        before = writers(zp.main)
        fetch = [v.name for v in zp.fetch_list]
        report = zp.main.optimize(fetch_list=fetch)
        assert writers(zp.main) == before
        assert "adam" in before
        jreport = jzp.main.optimize(fetch_list=fetch)
        assert _records(report) == _records(jreport)
        assert _types(zp.main) == _types(jzp.main)

    def test_never_removes_fetched_vars(self):
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            return (fluid.layers.fc(x, size=4).name,
                    fluid.layers.fc(x, size=2).name)
        out = _optimize_both(build, lambda e: list(e))
        main, _, (a, b), _ = out["torch"]
        produced = {n for op in main.global_block().ops
                    for n in op.output_names()}
        assert {a, b} <= produced


# ---------------------------------------------------------------------------
# CSE
# ---------------------------------------------------------------------------

def _two_relus(fluid):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    gb = _gb(fluid)
    for out in ("r1", "r2"):
        gb.create_var(name=out, dtype="float32")
        gb.append_op("relu", inputs={"X": [x.name]}, outputs={"Out": [out]})
    return x.name


class TestCSE:
    def test_merges_identical_pure_ops(self):
        def build(fluid):
            _two_relus(fluid)
            gb = _gb(fluid)
            gb.create_var(name="s", dtype="float32")
            gb.append_op("elementwise_add", inputs={"X": ["r1"],
                                                    "Y": ["r2"]},
                         outputs={"Out": ["s"]})
        # pin CSE in isolation: the default pipeline's fusion pass
        # would otherwise absorb the relu->add chain first
        out = _optimize_both(build, ["s"], passes=("cse", "dce"))
        main, report = out["torch"][0], out["torch"][3]
        assert report.n_merged == 1
        add = [op for op in main.global_block().ops
               if op.type == "elementwise_add"][0]
        # both operands now read the surviving binding
        assert add.input("X") == add.input("Y") == ["r1"]

    def test_rebound_name_never_false_merges(self):
        """relu(x) before and after x is rebound reads different
        VALUES — reaching-definition versioning must keep both."""
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            gb = _gb(fluid)
            gb.create_var(name="r1", dtype="float32")
            gb.append_op("relu", inputs={"X": [x.name]},
                         outputs={"Out": ["r1"]})
            gb.append_op("scale", inputs={"X": ["r1"]},
                         outputs={"Out": [x.name]},      # rebinds x
                         attrs={"scale": 2.0})
            gb.create_var(name="r2", dtype="float32")
            gb.append_op("relu", inputs={"X": [x.name]},
                         outputs={"Out": ["r2"]})
            gb.create_var(name="s", dtype="float32")
            gb.append_op("elementwise_add", inputs={"X": ["r1"],
                                                    "Y": ["r2"]},
                         outputs={"Out": ["s"]})
        out = _optimize_both(build, ["s"])
        assert out["torch"][3].n_merged == 0

    def test_stateful_ops_never_merge(self):
        def build(fluid):
            gb = _gb(fluid)
            for out in ("n1", "n2"):
                gb.create_var(name=out, dtype="float32")
                gb.append_op("gaussian_random", outputs={"Out": [out]},
                             attrs={"shape": [4], "mean": 0.0, "std": 1.0})
            gb.create_var(name="s", dtype="float32")
            gb.append_op("elementwise_add", inputs={"X": ["n1"],
                                                    "Y": ["n2"]},
                         outputs={"Out": ["s"]})
        out = _optimize_both(build, ["s"])
        assert out["torch"][3].n_merged == 0
        assert _types(out["torch"][0]).count("gaussian_random") == 2

    def test_fetched_duplicate_kept(self):
        out = _optimize_both(_two_relus, ["r1", "r2"])
        produced = {n for op in out["torch"][0].global_block().ops
                    for n in op.output_names()}
        assert {"r1", "r2"} <= produced

    def test_merged_program_runs_bit_exact(self):
        """The rewritten program's fetch is the original's to the bit."""
        def build(fluid):
            _two_relus(fluid)
            gb = _gb(fluid)
            gb.create_var(name="s", dtype="float32")
            gb.append_op("elementwise_mul", inputs={"X": ["r1"],
                                                    "Y": ["r2"]},
                         outputs={"Out": ["s"]})
        main = _build(tfluid, build)[0]
        feed = {"x": np.random.RandomState(0).randn(3, 8).astype(np.float32)}
        exe = tfluid.Executor(CPU)
        want = exe.run(main, feed=feed, fetch_list=["s"],
                       scope=tfluid.Scope())[0]
        opt = main.clone()
        assert opt.optimize(fetch_list=["s"], passes=("cse", "dce"))
        got = exe.run(opt, feed=feed, fetch_list=["s"],
                      scope=tfluid.Scope())[0]
        assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# executor hook
# ---------------------------------------------------------------------------

def _program_with_dead_op(fluid=tfluid):
    def build(f):
        x = f.layers.data(name="x", shape=[8], dtype="float32")
        live = f.layers.fc(x, size=4)
        f.layers.fc(x, size=2)           # dead
        return live
    return _build(fluid, build)


class TestExecutorOptimizeHook:
    def test_opt_in_runs_clone_and_preserves_results(self, monkeypatch):
        main, startup, live = _program_with_dead_op()
        feed = {"x": np.arange(16, dtype=np.float32).reshape(2, 8)}
        exe, scope = tfluid.Executor(CPU), tfluid.Scope()
        exe.run(startup, scope=scope)
        base = exe.run(main, feed=feed, fetch_list=[live], scope=scope)[0]

        monkeypatch.setenv("PADDLE_TPU_OPTIMIZE", "1")
        exe2 = tfluid.Executor(CPU)
        n_ops = len(main.global_block().ops)
        out = exe2.run(main, feed=feed, fetch_list=[live], scope=scope)[0]
        # numerics identical, caller's program untouched
        assert np.array_equal(base, out)
        assert len(main.global_block().ops) == n_ops
        # the lowered twin actually lost the dead op, as the reference's
        (_, clone), = exe2._opt_cache.values()
        assert len(clone.global_block().ops) < n_ops
        jmain, _, jlive = _program_with_dead_op(jfluid)
        jmain.optimize(fetch_list=[jlive.name])
        assert _types(clone) == _types(jmain)

    def test_opt_clone_cached_across_runs(self, monkeypatch):
        main, startup, live = _program_with_dead_op()
        monkeypatch.setenv("PADDLE_TPU_OPTIMIZE", "1")
        exe, scope = tfluid.Executor(CPU), tfluid.Scope()
        exe.run(startup, scope=scope)
        feed = {"x": np.zeros((2, 8), np.float32)}
        exe.run(main, feed=feed, fetch_list=[live], scope=scope)
        n = exe.total_compiles()
        exe.run(main, feed=feed, fetch_list=[live], scope=scope)
        assert len(exe._opt_cache) == 1
        assert exe.total_compiles() == n
        # a new version of the source program re-derives the clone and
        # drops the stale clone's step
        main._bump()
        exe.run(main, feed=feed, fetch_list=[live], scope=scope)
        assert len(exe._opt_cache) == 1 and exe.total_compiles() == n

    def test_off_by_default(self, monkeypatch):
        monkeypatch.delenv("PADDLE_TPU_OPTIMIZE", raising=False)
        main, startup, live = _program_with_dead_op()
        exe, scope = tfluid.Executor(CPU), tfluid.Scope()
        exe.run(startup, scope=scope)
        exe.run(main, feed={"x": np.zeros((2, 8), np.float32)},
                fetch_list=[live], scope=scope)
        assert not exe._opt_cache

    def test_rewrite_failure_runs_the_original_with_a_warning(
            self, monkeypatch):
        """As in the reference, a failing rewrite degrades to running
        the caller's program — loudly."""
        from paddle_tpu_torch.analysis import optimize as opt_mod
        main, startup, live = _program_with_dead_op()
        monkeypatch.setenv("PADDLE_TPU_OPTIMIZE", "1")

        def broken(*a, **k):
            raise RuntimeError("planted rewrite fault")
        monkeypatch.setattr(opt_mod, "optimize_program", broken)
        exe, scope = tfluid.Executor(CPU), tfluid.Scope()
        exe.run(startup, scope=scope)
        with pytest.warns(UserWarning, match="rewrite failed"):
            out = exe.run(main, feed={"x": np.ones((2, 8), np.float32)},
                          fetch_list=[live], scope=scope)
        assert out[0].shape == (2, 4)
        (_, clone), = exe._opt_cache.values()
        assert clone is main


# ---------------------------------------------------------------------------
# the newer verifier passes
# ---------------------------------------------------------------------------

def _dead_write(fluid):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    gb = _gb(fluid)
    gb.create_var(name="t", dtype="float32")
    gb.append_op("relu", inputs={"X": [x.name]}, outputs={"Out": ["t"]})
    gb.append_op("scale", inputs={"X": [x.name]}, outputs={"Out": ["t"]},
                 attrs={"scale": 2.0})
    return dict(fetch_list=["t"])


def _dead_write_read_between(fluid):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    gb = _gb(fluid)
    gb.create_var(name="t", dtype="float32")
    gb.create_var(name="u", dtype="float32")
    gb.append_op("relu", inputs={"X": [x.name]}, outputs={"Out": ["t"]})
    gb.append_op("relu", inputs={"X": ["t"]}, outputs={"Out": ["u"]})
    gb.append_op("scale", inputs={"X": [x.name]}, outputs={"Out": ["t"]},
                 attrs={"scale": 2.0})
    return dict(fetch_list=["t", "u"])


def _while_program(fluid, sub_input, defined_after):
    main = fluid.default_main_program()
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    gb = main.global_block()
    sub = main.create_block()
    main.rollback()
    sub.append_op("relu", inputs={"X": [sub_input or x.name]},
                  outputs={"Out": ["sub_out" if sub_input else "sub_only"]})
    gb.create_var(name="cond", dtype="bool")
    gb.append_op("while", attrs={"sub_block": sub, "condition": "cond",
                                 "carry_names": []})
    if defined_after:
        gb.create_var(name=sub_input, dtype="float32")
        gb.append_op("relu", inputs={"X": [x.name]},
                     outputs={"Out": [sub_input]})


def _cross_block(fluid):
    _while_program(fluid, "defined_later", True)


def _fetch_of_dead_var(fluid):
    _while_program(fluid, None, False)
    return dict(fetch_list=["sub_only"])


def _no_infer_rule(fluid):
    low = set(registry.registered_op_types())
    missing = sorted(low - set(registry.registered_infer_types()))
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    _gb(fluid).append_op(missing[0], inputs={"X": [x.name]},
                         outputs={"Out": ["o"]})


NEW_PASS_CASES = {
    "dead_write": (_dead_write, "dead-write", "warning"),
    "dead_write_silent_when_read_between": (_dead_write_read_between,
                                            "dead-write", None),
    "use_before_def_cross_block": (_cross_block,
                                   "use-before-def-cross-block", "error"),
    "fetch_of_dead_var": (_fetch_of_dead_var, "fetch-of-dead-var", "error"),
    "no_infer_rule_coverage_lint": (_no_infer_rule, "no-infer-rule",
                                    "warning"),
}


@pytest.mark.parametrize("case", sorted(NEW_PASS_CASES))
def test_new_verifier_pass_as_in_reference(case):
    build, code, level = NEW_PASS_CASES[case]
    progs = _both(build)
    diags = {k: main.verify(**(kw or {}))
             for k, (main, _, kw) in progs.items()}
    if level is None:
        assert code not in _codes(diags["torch"])
    else:
        assert code in _codes(diags["torch"], level)
    # the control-flow cases too, with `while` ported: the same
    # findings, the reference's no-infer-rule warning for it included
    assert _key(diags["torch"]) == _key(diags["jax"])


def test_no_infer_rule_names_the_op():
    main = _build(tfluid, _no_infer_rule)[0]
    op_type = main.global_block().ops[-1].type
    hits = [d for d in main.verify() if d.code == "no-infer-rule"]
    assert hits and hits[0].level == "warning"
    assert op_type in hits[0].message


# ---------------------------------------------------------------------------
# static cost model (tests/test_dataflow.py's TestCostModel and
# TestMemoryOptimizeLog): the port's analysis/cost.py is a copy of the
# reference's, so every number, choice and printed line equals the
# reference's on the same program
# ---------------------------------------------------------------------------

def _mul_program(fluid):
    a = fluid.layers.data(name="a", shape=[4, 6], dtype="float32",
                          append_batch_size=False)
    gb = _gb(fluid)
    w = gb.create_parameter("w", shape=[6, 10])
    gb.create_var(name="mm", dtype="float32")
    gb.append_op("mul", inputs={"X": [a.name], "Y": [w.name]},
                 outputs={"Out": ["mm"]})


def _cost(k, main, fetch, **kw):
    cost = {"jax": jfluid.analysis, "torch": tfluid.analysis}[k]
    return cost.program_cost(main, fetch_list=fetch, **kw)


class TestCostModel:
    def test_matmul_flops_exact(self):
        reps = {k: _cost(k, main, ["mm"])
                for k, (main, _, _) in _both(_mul_program).items()}
        mm = [c for c in reps["torch"].per_op if c.op_type == "mul"][0]
        assert mm.flops == 2 * 4 * 6 * 10
        # bytes: read a (96B) + w (240B), write out (160B)
        assert mm.bytes == (4 * 6 + 6 * 10 + 4 * 10) * 4
        assert reps["torch"].to_dict() == reps["jax"].to_dict()
        assert repr(mm) == repr([c for c in reps["jax"].per_op
                                 if c.op_type == "mul"][0])

    def test_peak_residency_counts_params_plus_live(self):
        tp, jp = (tzoo.build_zoo_program("mnist_mlp"),
                  jzoo.build_zoo_program("mnist_mlp"))
        rep = tfluid.analysis.program_cost(tp.main, fetch_list=tp.fetch_list)
        assert rep.params_bytes > 0
        assert rep.peak_residency_bytes > rep.params_bytes
        assert rep.dead_op_count == 0
        d = rep.to_dict(top_k=5)
        assert len(d["top_ops"]) == 5
        assert d["peak_residency_bytes"] == rep.peak_residency_bytes
        assert d == jfluid.analysis.program_cost(
            jp.main, fetch_list=jp.fetch_list).to_dict(top_k=5)
        assert [c.to_dict() for c in rep.top_ops(4, by="bytes")] == [
            c.to_dict() for c in jfluid.analysis.program_cost(
                jp.main, fetch_list=jp.fetch_list).top_ops(4, by="bytes")]

    def test_remat_recommendations_by_family(self):
        rec = tfluid.analysis.recommend_remat_policy
        assert rec(tzoo.build_zoo_program("resnet").main) == "save_conv_only"
        assert rec(tzoo.build_zoo_program("mnist_mlp").main) == \
            "dots_saveable"
        # inference program: no backward marker, nothing to remat
        assert rec(tzoo.build_zoo_program("se_resnext").main) is None
        assert tfluid.analysis.estimate_remat_residuals(
            tzoo.build_zoo_program("se_resnext").main) == {}

    def test_never_runs_an_op(self, monkeypatch):
        from paddle_tpu_torch.core import lowering

        def no_lowering(*a, **k):
            raise AssertionError("cost model lowered the program")

        monkeypatch.setattr(lowering, "lower_program", no_lowering)
        monkeypatch.setattr(tfluid.core.executor, "lower_program",
                            no_lowering)
        zp = tzoo.build_zoo_program("resnet")
        assert tfluid.analysis.program_cost(
            zp.main, fetch_list=zp.fetch_list).total_flops > 0

    @pytest.mark.parametrize("name", tzoo.zoo_model_names())
    def test_zoo_costs_equal_the_reference(self, name):
        """program_cost's whole report (totals, peak, residual at the
        backward, dead ops, recommendation, top ops by FLOPs and by
        bytes), the residual estimates and the recommendation equal the
        reference's on every zoo entry, at batch 1 and 16."""
        jp, tp = jzoo.build_zoo_program(name), tzoo.build_zoo_program(name)
        for batch in (1, 16):
            want = jfluid.analysis.program_cost(
                jp.main, fetch_list=jp.fetch_list, assume_batch=batch)
            got = tfluid.analysis.program_cost(
                tp.main, fetch_list=tp.fetch_list, assume_batch=batch)
            assert got.to_dict(top_k=20) == want.to_dict(top_k=20)
            assert [c.to_dict() for c in got.per_op] == \
                [c.to_dict() for c in want.per_op]
        assert tfluid.analysis.estimate_remat_residuals(tp.main) == \
            jfluid.analysis.estimate_remat_residuals(jp.main)

    def test_collect_cost_deltas_equal_the_reference(self):
        """optimize_program(collect_cost=True): per-pass FLOPs, bytes and
        op-count deltas, the reference's on the same program."""
        reports = {}
        for k, (main, _, _) in _both(_optimizable).items():
            reports[k] = main.optimize(fetch_list=["out"],
                                       collect_cost=True)
        got, want = reports["torch"], reports["jax"]
        assert got.cost_deltas == want.cost_deltas
        assert got.cost_deltas and all(
            d["n_ops"] <= 0 for d in got.cost_deltas.values())
        assert got.to_dict()["cost_deltas"] == want.to_dict()["cost_deltas"]
        # without the flag, no snapshot
        main = _build(tfluid, _optimizable)[0]
        assert main.optimize(fetch_list=["out"]).cost_deltas is None


def _optimizable(fluid):
    """Foldable constants, a duplicate relu and a dead branch: fold,
    cse and dce each have work."""
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    c = fluid.layers.fill_constant([8], "float32", 2.0)
    c2 = fluid.layers.scale(c, scale=3.0)
    a = fluid.layers.relu(x)
    b = fluid.layers.relu(x)
    fluid.layers.tanh(x)                     # dead
    out = fluid.layers.elementwise_add(fluid.layers.elementwise_add(a, b),
                                       c2)
    fluid.layers.assign(out, output=_gb(fluid).create_var(
        name="out", dtype="float32"))


def _memory_optimize_out(k, main, capsys, **kw):
    fluid = PACKAGES[k][0]
    fluid.memory_optimize(main, **kw)
    return capsys.readouterr().out, main._remat_policy


class TestMemoryOptimizeLog:
    def _train(self, k, name="resnet"):
        return (jzoo if k == "jax" else tzoo).build_zoo_program(name).main

    def test_print_log_reports_estimates(self, capsys):
        out = {k: _memory_optimize_out(k, self._train(k), capsys,
                                       print_log=True)
               for k in PACKAGES}
        text, policy = out["torch"]
        assert "fwd->bwd residuals" in text
        assert "dots_saveable=" in text
        assert "recommended" in text            # chosen != recommended
        assert policy == "dots_saveable"
        assert out["torch"] == out["jax"]

    def test_auto_policy_uses_recommendation(self, capsys):
        main = self._train("torch")
        v = main.version
        tfluid.memory_optimize(main, policy="auto")
        assert main._remat_policy == "save_conv_only" and main.version > v

    def test_auto_without_backward_disables_remat(self, capsys):
        def fwd(fluid):
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            fluid.layers.fc(x, size=4)

        out = {k: _memory_optimize_out(k, main, capsys, policy="auto",
                                       print_log=True)
               for k, (main, _, _) in _both(fwd).items()}
        assert out["torch"][1] is None
        assert "no backward marker" in out["torch"][0]
        assert out["torch"] == out["jax"]

    def test_print_log_false_prints_nothing(self, capsys):
        tfluid.memory_optimize(self._train("torch"), print_log=False)
        assert capsys.readouterr().out == ""

    @pytest.mark.parametrize("name", tzoo.zoo_model_names())
    @pytest.mark.parametrize("policy", ["auto", "nothing_saveable",
                                        "save_conv_only"])
    def test_zoo_log_and_choice_equal_the_reference(self, name, policy,
                                                    capsys):
        out = {k: _memory_optimize_out(k, self._train(k, name), capsys,
                                       policy=policy, print_log=True)
               for k in PACKAGES}
        assert out["torch"] == out["jax"]


def test_flowers_program_auto_policy_is_chip_smokes():
    """chip_smoke.py's flowers_train program (ResNet-50 at 3 x 224², 102
    classes, NHWC, Momentum, AMP O2): the port's static cost, residual
    estimates and ``memory_optimize(policy="auto")`` pick equal the
    reference's on the same program, and the pick is the policy the
    card's phase expects (``chip_smoke.FL_AUTO_POLICY``)."""
    import chip_smoke
    from paddle_tpu.models.resnet import resnet50 as jresnet50
    from paddle_tpu.transpiler import amp_transpile as jamp

    tmain, _, tloss = chip_smoke.resnet_program(
        tfluid, "NHWC", classes=chip_smoke.FL_CLASSES)
    jmain, jstartup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(jmain, jstartup):
        img = jfluid.layers.data(name="img", shape=[3, 224, 224],
                                 dtype="float32")
        label = jfluid.layers.data(name="label", shape=[1], dtype="int64")
        jloss, _, _ = jresnet50(img, label, class_num=chip_smoke.FL_CLASSES,
                                layout="NHWC")
        jfluid.optimizer.Momentum(learning_rate=chip_smoke.RN_LR,
                                  momentum=0.9).minimize(jloss)
    jamp(jmain, level="O2")
    assert str(tmain) == str(jmain)
    batch = chip_smoke.RN_BATCH
    assert tfluid.analysis.program_cost(
        tmain, fetch_list=[tloss], assume_batch=batch).to_dict() == \
        jfluid.analysis.program_cost(
            jmain, fetch_list=[jloss], assume_batch=batch).to_dict()
    assert tfluid.contrib.memory_usage(tmain, batch) == \
        jfluid.contrib.memory_usage(jmain, batch)
    picks = []
    for fluid, main in ((tfluid, tmain), (jfluid, jmain)):
        auto = main.clone()
        fluid.memory_optimize(auto, policy="auto")
        picks.append(auto._remat_policy)
    assert picks == [chip_smoke.FL_AUTO_POLICY] * 2
