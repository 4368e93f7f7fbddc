"""The optimize rewrite of the torch port (``paddle_tpu_torch.analysis.
optimize``: fold, fuse, cse, dce) and its ``fused_elementwise`` op,
against the JAX package's.

Mirrors tests/test_optimize_rewrites.py's TestFold, TestFuse (with
``test_fused_elementwise_gradients_bit_exact``), TestPassSelection and
TestServingOptimize (the ServingEngine and the DecodeEngine), with
``test_load_op_never_folds`` (the ``load`` op, ported with item 'IO,
persistables and Inferencer'). Every case
asserts on the port what the reference case asserts, and that both
packages' reports (every folded/fused/merged/removed record) and the
op-type sequence after the rewrite are the same.

Then the port's own optcheck: optimized against unoptimized in the
port, BIT-exact (``np.array_equal``) in every fetch and every updated
persistable, train and test, on the four ported zoo programs and a
Transformer-base parity model (d_model 512, 2 + 2 layers, dropout 0 and
0.1); the optimized port against the JAX package at the f32 tiers
(outputs rtol 2e-4 / atol 2e-5, gradients rtol 2e-3 / atol 2e-4);
``fused_elementwise`` against the reference's rule on seeded inputs,
one case per step kind (rtol 1e-6 / atol 1e-6: jax's and torch's CPU
``exp``/``tanh``/``log`` may differ in the last bits), and BIT-exact
against the port's own unfused chain; and under AMP O1 and O2 the fold
and fuse admissions and the reports equal the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.analysis import numcheck as jnumcheck
from paddle_tpu.core import registry as jregistry
from paddle_tpu.models import transformer as jtf
from paddle_tpu.models import zoo as jzoo

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.analysis import numcheck
from paddle_tpu_torch.analysis.optimize import (DEFAULT_PASSES,
                                                fold_constants,
                                                fuse_elementwise_chains,
                                                optimize_program,
                                                parse_passes)
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.models import transformer as ttf
from paddle_tpu_torch.models import zoo as tzoo

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
PACKAGES = {"jax": jfluid, "torch": tfluid}
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
RULE_TOL = dict(rtol=1e-6, atol=1e-6)


def _build(fluid, build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        extra = build(fluid)
    return main, startup, extra


def _types(prog):
    return [op.type for op in prog.global_block().ops]


def _records(report):
    return (report.folded, report.fused, report.merged, report.removed,
            report.iterations)


def _gb(fluid):
    return fluid.default_main_program().global_block()


def _var(fluid, name, dtype="float32", **kw):
    return _gb(fluid).create_var(name=name, dtype=dtype, **kw)


def _run(program, fetch, feed=None, state=None, mode="test"):
    """One port run on the CPU; ``state`` ({name: array}) seeds the
    scope. Returns (fetches, {name: array} of the scope after)."""
    scope = weights.load_state(tfluid.Scope(), state or {}, CPU.device)
    out = tfluid.Executor(CPU).run(program, feed=feed or {},
                                   fetch_list=fetch, scope=scope, mode=mode)
    return out, weights.dump_state(scope)


def _optimize_both(build, fetch, **kw):
    """``build`` in both packages, optimized with ``fetch``; the two
    rewrites must agree record for record and op for op. Returns the
    port's (original clone, optimized main, report, build's result)."""
    res = {}
    for k, fluid in PACKAGES.items():
        main, _, extra = _build(fluid, build)
        orig = main.clone(for_test=main._is_test)
        report = (optimize_program(main, fetch_list=fetch,
                                   device=CPU.device, **kw)
                  if k == "torch" else main.optimize(fetch_list=fetch, **kw))
        res[k] = (orig, main, report, extra)
    assert _records(res["torch"][2]) == _records(res["jax"][2])
    assert _types(res["torch"][1]) == _types(res["jax"][1])
    return res["torch"]


def _assert_bit_exact(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        # NaN where both have NaN (0 / 0 in a fixture) is agreement
        assert np.array_equal(g, w, equal_nan=g.dtype.kind == "f")


def _const_chain(fluid):
    """fill_constant -> scale -> elementwise_add(c2, c2): all foldable."""
    gb = _gb(fluid)
    _var(fluid, "c1")
    gb.append_op("fill_constant", outputs={"Out": ["c1"]},
                 attrs={"shape": [4], "value": 2.0, "dtype": "float32"})
    _var(fluid, "c2")
    gb.append_op("scale", inputs={"X": ["c1"]}, outputs={"Out": ["c2"]},
                 attrs={"scale": 3.0})
    _var(fluid, "c3")
    gb.append_op("elementwise_add", inputs={"X": ["c2"], "Y": ["c2"]},
                 outputs={"Out": ["c3"]})


# ---------------------------------------------------------------------------
# constant folding
# ---------------------------------------------------------------------------

class TestFold:
    def test_folds_constant_chain_value_exact(self):
        orig, main, report, _ = _optimize_both(_const_chain, ["c3"])
        assert report.n_folded >= 1
        # the whole chain collapsed to the one constant that matters
        assert _types(main) == ["assign_value"]
        _assert_bit_exact(_run(main, ["c3"])[0], _run(orig, ["c3"])[0])

    def test_stateful_ops_never_fold(self):
        """A random op has no inputs — trivially 'all-constant' — but
        folding it would freeze the draw AND shift the rng stream of
        every later stateful op. It must survive untouched."""
        def build(fluid):
            gb = _gb(fluid)
            _var(fluid, "n")
            gb.append_op("gaussian_random", outputs={"Out": ["n"]},
                         attrs={"shape": [4], "mean": 0.0, "std": 1.0})
            _var(fluid, "y")
            gb.append_op("scale", inputs={"X": ["n"]},
                         outputs={"Out": ["y"]}, attrs={"scale": 2.0})
        _, main, report, _ = _optimize_both(build, ["y"])
        assert report.n_folded == 0
        assert "gaussian_random" in _types(main)

    def test_persistable_inputs_never_fold(self):
        """Initializer-fed persistables are Scope values, not
        compile-time constants — math on them must stay dynamic."""
        def build(fluid):
            _var(fluid, "w", persistable=True, shape=[4])
            _var(fluid, "y")
            _gb(fluid).append_op("scale", inputs={"X": ["w"]},
                                 outputs={"Out": ["y"]},
                                 attrs={"scale": 2.0})
        _, main, report, _ = _optimize_both(build, ["y"])
        assert report.n_folded == 0
        assert "scale" in _types(main)

    def test_dtype_preserved_through_cast_fold(self):
        def build(fluid):
            gb = _gb(fluid)
            _var(fluid, "c1")
            gb.append_op("fill_constant", outputs={"Out": ["c1"]},
                         attrs={"shape": [3], "value": 2.5,
                                "dtype": "float32"})
            _var(fluid, "ci", dtype="int32")
            gb.append_op("cast", inputs={"X": ["c1"]},
                         outputs={"Out": ["ci"]},
                         attrs={"out_dtype": "int32"})
        _, main, report, _ = _optimize_both(build, ["ci"])
        assert report.n_folded >= 1
        op = main.global_block().ops[-1]
        assert op.type == "assign_value" and op.attrs["dtype"] == "int32"
        got = _run(main, ["ci"])[0][0]
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.full((3,), 2, np.int32))

    def test_fold_budget_blocks_large_constants(self):
        """An over-budget result must never be materialized — neither
        spliced into the IR nor tracked for downstream folds."""
        def build(fluid):
            gb = _gb(fluid)
            _var(fluid, "c1")
            gb.append_op("fill_constant", outputs={"Out": ["c1"]},
                         attrs={"shape": [64], "value": 1.0,
                                "dtype": "float32"})
            _var(fluid, "c2")
            gb.append_op("scale", inputs={"X": ["c1"]},
                         outputs={"Out": ["c2"]}, attrs={"scale": 2.0})
        main = _build(tfluid, build)[0]
        assert fold_constants(main, fetch_list=["c2"],
                              budget_bytes=64) == []   # 256 B > 64
        assert _types(main) == ["fill_constant", "scale"]
        # a generous budget folds the same program
        assert len(fold_constants(main, fetch_list=["c2"],
                                  budget_bytes=1 << 20)) == 1

    def test_fold_budget_env_knob(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_FOLD_BUDGET", "8")
        _, main, report, _ = _optimize_both(_const_chain, ["c3"])
        assert report.n_folded == 0
        assert "fill_constant" in _types(main)

    def test_folded_fetch_target_keeps_value(self):
        """Folding an op that writes a fetch target is legal — the
        name keeps an identical binding."""
        _, main, report, _ = _optimize_both(_const_chain, ["c2", "c3"])
        assert report.n_folded >= 1
        got = _run(main, ["c2", "c3"])[0]
        np.testing.assert_array_equal(got[0], np.full((4,), 6.0,
                                                      np.float32))
        np.testing.assert_array_equal(got[1], np.full((4,), 12.0,
                                                      np.float32))

    def test_data_feed_shadow_never_folds(self):
        """An op writing a data var (a feed shadow) must survive: what
        later readers see depends on execution, not the IR."""
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            gb = _gb(fluid)
            _var(fluid, "c1")
            gb.append_op("fill_constant", outputs={"Out": ["c1"]},
                         attrs={"shape": [4], "value": 1.0,
                                "dtype": "float32"})
            gb.append_op("scale", inputs={"X": ["c1"]},
                         outputs={"Out": [x.name]}, attrs={"scale": 2.0})
            _var(fluid, "y")
            gb.append_op("scale", inputs={"X": [x.name]},
                         outputs={"Out": ["y"]}, attrs={"scale": 1.0})
        assert _optimize_both(build, ["y"])[2].n_folded == 0

    def test_load_op_never_folds(self, tmp_path):
        """``load`` reads the filesystem: folding would pin the file's
        optimize-time contents instead of its run-time contents. Neither
        package folds it, and the port's run reads the file as it is at
        run time."""
        path = str(tmp_path / "w.npy")
        np.save(path, np.ones((4,), np.float32))

        def build(fluid):
            gb = _gb(fluid)
            _var(fluid, "w")
            gb.append_op("load", outputs={"Out": ["w"]},
                         attrs={"file_path": path})
            _var(fluid, "y")
            gb.append_op("scale", inputs={"X": ["w"]},
                         outputs={"Out": ["y"]}, attrs={"scale": 2.0})
        _, main, report, _ = _optimize_both(build, ["y"])
        assert report.n_folded == 0 and "load" in _types(main)
        np.save(path, np.full((4,), 5.0, np.float32))
        np.testing.assert_array_equal(_run(main, ["y"])[0][0],
                                      np.full((4,), 10.0, np.float32))

    def test_seq_aware_ops_never_fold(self):
        """The reference refuses to fold its seq-aware ops (``mul``
        among them) even on constant inputs; so does the port, by the
        same ``seq_aware`` flag of its registry."""
        def build(fluid):
            gb = _gb(fluid)
            for n, shape in (("a", [2, 3]), ("b", [3, 2])):
                _var(fluid, n)
                gb.append_op("fill_constant", outputs={"Out": [n]},
                             attrs={"shape": shape, "value": 1.5,
                                    "dtype": "float32"})
            _var(fluid, "m")
            gb.append_op("mul", inputs={"X": ["a"], "Y": ["b"]},
                         outputs={"Out": ["m"]})
        _, main, report, _ = _optimize_both(build, ["m"])
        assert report.n_folded == 0 and "mul" in _types(main)

    def test_fold_refuses_exactly_the_reference_seq_aware_ops(self):
        """The fold refuses an op by its registry's ``seq_aware`` flag,
        as the reference's does, and the port flags exactly the
        reference's seq-aware ops that it registers, no more and no
        fewer (the sequence ops, ``lstm`` and ``gru`` since they were
        ported; ``im2sequence`` when it is)."""
        want = {t for t in jregistry.registered_op_types()
                if jregistry.get_op(t).seq_aware}
        got = {t for t in registry.registered_op_types()
               if registry.get_op(t).seq_aware}
        assert got == want & set(registry.registered_op_types())
        assert {"mul", "lookup_table", "sequence_mask", "quantized_mul",
                "sequence_pool", "lstm", "gru"} <= got

    @staticmethod
    def _fold_devices(monkeypatch, cuda):
        """The devices the fold hands ``fill_constant``'s rule: with
        ``optimize_program(device=cpu)``, then with a direct
        ``Program.optimize``, while ``torch.cuda.is_available()`` says
        ``cuda`` (the spy declines a fold on the card, as none is here
        to run the rule). Returns (given, direct, direct report)."""
        from paddle_tpu_torch.analysis.optimize import _FoldSkip
        seen = []
        real = registry.get_op("fill_constant").lower

        def spy(ctx, ins, attrs):
            seen.append(ctx.device)
            if ctx.device.type == "cuda":
                raise _FoldSkip("no card in this test")
            return real(ctx, ins, attrs)
        monkeypatch.setattr(registry.get_op("fill_constant"), "lower", spy)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
        optimize_program(_build(tfluid, _const_chain)[0],
                         fetch_list=["c3"], device=torch.device("cpu"))
        given = set(seen)
        seen.clear()
        report = _build(tfluid, _const_chain)[0].optimize(fetch_list=["c3"])
        return given, set(seen), report

    def test_fold_runs_the_rule_on_the_given_device(self, monkeypatch):
        """The fold evaluates the op's own rule on the device it is
        given: the rule sees that device in ``ctx.device``. Without a
        card, a direct ``Program.optimize`` folds on the CPU."""
        given, direct, report = self._fold_devices(monkeypatch, False)
        assert given == {torch.device("cpu")}
        assert direct == {torch.device("cpu")} and report.n_folded > 0

    def test_direct_optimize_folds_on_the_card_when_there_is_one(
            self, monkeypatch):
        """A direct ``Program.optimize`` names no device and folds where
        the reference's jax default backend would, on the accelerator:
        the card whenever CUDA is available, so a folded value is the
        card's own bit for bit. A named device still wins."""
        from paddle_tpu_torch.analysis.optimize import default_fold_device
        given, direct, report = self._fold_devices(monkeypatch, True)
        assert default_fold_device() == torch.device("cuda")
        assert given == {torch.device("cpu")}
        assert direct == {torch.device("cuda")} and report.n_folded == 0


# ---------------------------------------------------------------------------
# elementwise-chain fusion
# ---------------------------------------------------------------------------

def _add_relu_model(fluid):
    """data -> elementwise_add(+persistable bias) -> relu, the canonical
    2-link chain."""
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    gb = _gb(fluid)
    _var(fluid, "b", persistable=True, shape=[4])
    _var(fluid, "s")
    gb.append_op("elementwise_add", inputs={"X": [x.name], "Y": ["b"]},
                 outputs={"Out": ["s"]})
    _var(fluid, "r")
    gb.append_op("relu", inputs={"X": ["s"]}, outputs={"Out": ["r"]})


_BIAS = {"b": np.float32([0.5, -0.5, 0.25, -0.25])}


class TestFuse:
    def test_fuses_add_relu_chain_bit_exact(self):
        orig, main, report, _ = _optimize_both(_add_relu_model, ["r"])
        assert report.n_fused == 1
        assert _types(main) == ["fused_elementwise"]
        assert [s["op"] for s in main.global_block().ops[0].attrs["steps"]] \
            == ["elementwise_add", "relu"]
        feed = {"x": np.linspace(-1, 1, 4).astype(np.float32)[None]}
        _assert_bit_exact(_run(main, ["r"], feed, _BIAS)[0],
                          _run(orig, ["r"], feed, _BIAS)[0])

    def test_fetched_interior_node_blocks_fusion(self):
        orig, main, report, _ = _optimize_both(_add_relu_model, ["s", "r"])
        assert report.n_fused == 0
        assert "elementwise_add" in _types(main)
        feed = {"x": np.ones((1, 4), np.float32)}
        _assert_bit_exact(_run(main, ["s", "r"], feed, _BIAS)[0],
                          _run(orig, ["s", "r"], feed, _BIAS)[0])

    def test_single_op_chain_not_fused(self):
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            _var(fluid, "r")
            _gb(fluid).append_op("relu", inputs={"X": [x.name]},
                                 outputs={"Out": ["r"]})
        _, main, report, _ = _optimize_both(build, ["r"])
        assert report.n_fused == 0 and _types(main) == ["relu"]

    def test_empty_program_noop(self):
        assert fuse_elementwise_chains(tfluid.Program(),
                                       fetch_list=["nope"]) == []

    def test_multi_consumer_interior_blocks_fusion(self):
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            gb = _gb(fluid)
            _var(fluid, "s")
            gb.append_op("scale", inputs={"X": [x.name]},
                         outputs={"Out": ["s"]}, attrs={"scale": 2.0})
            _var(fluid, "r")
            gb.append_op("relu", inputs={"X": ["s"]}, outputs={"Out": ["r"]})
            _var(fluid, "t")
            gb.append_op("tanh", inputs={"X": ["s"]}, outputs={"Out": ["t"]})
            _var(fluid, "o")
            gb.append_op("elementwise_add", inputs={"X": ["r"], "Y": ["t"]},
                         outputs={"Out": ["o"]})
        orig, main, _, _ = _optimize_both(build, ["o"])
        # s has two consumers: the scale link must survive
        assert "scale" in _types(main)
        feed = {"x": np.linspace(-2, 2, 4).astype(np.float32)[None]}
        _assert_bit_exact(_run(main, ["o"], feed)[0],
                          _run(orig, ["o"], feed)[0])

    def test_side_input_rebinding_blocks_fusion(self):
        """A chain whose side input is REBOUND between its original read
        and the fusion point would read the wrong version."""
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            gb = _gb(fluid)
            _var(fluid, "y")
            gb.append_op("scale", inputs={"X": [x.name]},
                         outputs={"Out": ["y"]}, attrs={"scale": 1.0})
            _var(fluid, "s")
            gb.append_op("elementwise_add", inputs={"X": [x.name],
                                                    "Y": ["y"]},
                         outputs={"Out": ["s"]})
            gb.append_op("scale", inputs={"X": [x.name]},
                         outputs={"Out": ["y"]}, attrs={"scale": 5.0})
            _var(fluid, "o")
            gb.append_op("elementwise_mul", inputs={"X": ["s"], "Y": ["y"]},
                         outputs={"Out": ["o"]})
            _var(fluid, "z")
            gb.append_op("elementwise_add", inputs={"X": ["o"], "Y": ["y"]},
                         outputs={"Out": ["z"]})
        orig, main, _, _ = _optimize_both(build, ["z"])
        feed = {"x": np.float32([1, 2, 3, 4])[None]}
        _assert_bit_exact(_run(main, ["z"], feed)[0],
                          _run(orig, ["z"], feed)[0])

    def test_eval_dropout_fuses_train_dropout_never(self):
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            gb = _gb(fluid)
            for mode, is_test in (("ev", True), ("tr", False)):
                _var(fluid, f"s_{mode}")
                gb.append_op("scale", inputs={"X": [x.name]},
                             outputs={"Out": [f"s_{mode}"]},
                             attrs={"scale": 2.0})
                _var(fluid, f"d_{mode}")
                _var(fluid, f"m_{mode}")
                gb.append_op("dropout", inputs={"X": [f"s_{mode}"]},
                             outputs={"Out": [f"d_{mode}"],
                                      "Mask": [f"m_{mode}"]},
                             attrs={"dropout_prob": 0.25,
                                    "is_test": is_test})
        orig, main, report, _ = _optimize_both(build, ["d_ev", "d_tr"])
        # eval-mode dropout absorbed; train-mode dropout untouched
        assert _types(main).count("dropout") == 1
        assert report.n_fused == 1
        feed = {"x": np.float32([1, -1, 2, -2])[None]}
        # train mode: the surviving dropout draws the same mask (the
        # draws are keyed by their count, which fusion leaves alone)
        _assert_bit_exact(
            _run(main, ["d_ev", "d_tr"], feed, mode="train")[0],
            _run(orig, ["d_ev", "d_tr"], feed, mode="train")[0])

    def test_dropout_with_live_mask_not_fused(self):
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            gb = _gb(fluid)
            _var(fluid, "s")
            gb.append_op("scale", inputs={"X": [x.name]},
                         outputs={"Out": ["s"]}, attrs={"scale": 2.0})
            _var(fluid, "d")
            _var(fluid, "m")
            gb.append_op("dropout", inputs={"X": ["s"]},
                         outputs={"Out": ["d"], "Mask": ["m"]},
                         attrs={"dropout_prob": 0.25, "is_test": True})
        assert _optimize_both(build, ["d", "m"])[2].n_fused == 0

    def test_stop_gradient_interior_blocks_fusion_under_autodiff(self):
        """The lowering detaches a stop_gradient WRITTEN var; fusing away
        such an interior under a backward marker would drop the gradient
        cut. Without a marker the flag is inert and the chain fuses."""
        def build(fluid, marker):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            gb = _gb(fluid)
            _var(fluid, "s", stop_gradient=True)
            gb.append_op("scale", inputs={"X": [x.name]},
                         outputs={"Out": ["s"]}, attrs={"scale": 2.0})
            _var(fluid, "r")
            gb.append_op("relu", inputs={"X": ["s"]}, outputs={"Out": ["r"]})
            if marker:
                gb.append_op("backward", inputs={"Loss": ["r"]},
                             attrs={"parameter_names": []})
        assert _optimize_both(lambda f: build(f, False),
                              ["r"])[2].n_fused == 1
        assert _optimize_both(lambda f: build(f, True),
                              ["r"])[2].n_fused == 0

    def test_fused_elementwise_gradients_bit_exact(self):
        """A train program (backward marker + SGD) optimized so its
        add->relu chain fuses gives BIT-identical parameter updates — so
        bit-identical gradients: autograd differentiates the fused op's
        torch ops as it does the unfused ones."""
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[6], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            h = fluid.layers.fc(x, size=5, act="relu")
            p = fluid.layers.fc(h, size=1)
            loss = fluid.layers.mean(fluid.layers.square_error_cost(p, y))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
            return loss.name
        main, startup, loss = _build(tfluid, build)
        state = _run(startup, [])[1]
        opt = main.clone(for_test=False)
        jmain = _build(jfluid, build)[0]
        report = opt.optimize(fetch_list=[loss])
        assert _records(report) == _records(
            jmain.optimize(fetch_list=[loss]))
        assert report.n_fused >= 1
        assert "fused_elementwise" in _types(opt)
        feed = {"x": np.random.RandomState(1).randn(4, 6).astype(np.float32),
                "y": np.random.RandomState(2).randn(4, 1).astype(np.float32)}
        f0, s0 = _run(main, [loss], feed, state, mode="train")
        f1, s1 = _run(opt, [loss], feed, state, mode="train")
        _assert_bit_exact(f1, f0)
        assert sorted(s0) == sorted(s1)
        for k in s0:   # SGD updates = -lr * grad: bit-equal updates
            assert np.array_equal(s0[k], s1[k]), k

    def test_identical_fused_chains_cse_merge(self):
        """Fusion feeds CSE: two identical chains collapse to one fused
        op."""
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            gb = _gb(fluid)
            for tag in ("a", "b"):
                _var(fluid, f"s_{tag}")
                gb.append_op("scale", inputs={"X": [x.name]},
                             outputs={"Out": [f"s_{tag}"]},
                             attrs={"scale": 2.0})
                _var(fluid, f"r_{tag}")
                gb.append_op("relu", inputs={"X": [f"s_{tag}"]},
                             outputs={"Out": [f"r_{tag}"]})
            _var(fluid, "o")
            gb.append_op("elementwise_div", inputs={"X": ["r_a"],
                                                    "Y": ["r_b"]},
                         outputs={"Out": ["o"]})
        orig, main, report, _ = _optimize_both(build, ["o"])
        assert report.n_fused == 2 and report.n_merged >= 1
        feed = {"x": np.float32([-1, 1, -2, 2])[None]}
        _assert_bit_exact(_run(main, ["o"], feed)[0],
                          _run(orig, ["o"], feed)[0])


# ---------------------------------------------------------------------------
# fused_elementwise against the reference's rule, one case per step kind
# ---------------------------------------------------------------------------

def _step(op, arg=-1, **attrs):
    return {"op": op, "attrs": attrs, "arg": arg}


# (steps, side-argument shapes); the chain head is [3, 4, 5]
STEP_CASES = {
    "add_trailing": ([_step("elementwise_add", 0)], [(5,)]),
    "sub_axis1": ([_step("elementwise_sub", 0, axis=1)], [(4,)]),
    "mul_axis0_span": ([_step("elementwise_mul", 0, axis=0)], [(3, 4)]),
    "mul_self": ([_step("elementwise_mul", -2)], []),
    "cast_f16": ([_step("cast", out_dtype="float16")], []),
    "scale_bias_after": ([_step("scale", scale=1.5, bias=0.25)], []),
    "scale_bias_before": ([_step("scale", scale=-2.0, bias=0.5,
                                bias_after_scale=False)], []),
    "dropout_downgrade": ([_step("dropout", dropout_prob=0.3,
                                 is_test=True)], []),
    "dropout_upscale": ([_step("dropout", dropout_prob=0.3, is_test=True,
                               dropout_implementation="upscale_in_train")],
                        []),
    "unary_relu": ([_step("relu")], []),
    "unary_sigmoid": ([_step("sigmoid")], []),
    "unary_tanh": ([_step("tanh")], []),
    "unary_exp": ([_step("exp")], []),
    "unary_sqrt_abs": ([_step("abs"), _step("sqrt")], []),
    "unary_square": ([_step("square")], []),
    "unary_leaky_relu": ([_step("leaky_relu", alpha=0.1)], []),
    "unary_gelu": ([_step("gelu", approximate=False)], []),
    "chain_mixed": ([_step("scale", scale=0.5, bias=1.0),
                     _step("elementwise_add", 0), _step("relu"),
                     _step("elementwise_mul", 1, axis=1),
                     _step("dropout", dropout_prob=0.1, is_test=True),
                     _step("tanh")], [(5,), (4, 5)]),
}


def _step_inputs(case):
    steps, sides = STEP_CASES[case]
    r = np.random.RandomState(sorted(STEP_CASES).index(case))
    x = r.randn(3, 4, 5).astype(np.float32)
    args = [r.randn(*s).astype(np.float32) for s in sides]
    return steps, x, args


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_fused_elementwise_equals_the_reference_rule(case):
    import jax.numpy as jnp
    steps, x, args = _step_inputs(case)
    want = jregistry.get_op("fused_elementwise").lower(
        None, {"X": [jnp.asarray(x)], "Args": [jnp.asarray(a) for a in args]},
        {"steps": steps})["Out"][0]
    got = registry.get_op("fused_elementwise").lower(
        None, {"X": [torch.from_numpy(x)],
               "Args": [torch.from_numpy(a) for a in args]},
        {"steps": steps})["Out"][0]
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_allclose(got.numpy(), want, **RULE_TOL)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_fused_elementwise_is_its_chain_bit_for_bit(case):
    """The fused rule replays the standalone rules' torch ops: its
    output equals the unfused chain's run op by op, to the bit."""
    steps, x, args = _step_inputs(case)
    got = registry.get_op("fused_elementwise").lower(
        None, {"X": [torch.from_numpy(x)],
               "Args": [torch.from_numpy(a) for a in args]},
        {"steps": steps})["Out"][0]
    cur = torch.from_numpy(x)

    class Ctx:
        device = torch.device("cpu")
        is_test = True
        mode = "test"

        def next_key(self):
            raise AssertionError("a fused step drew")

        def wants(self, slot):
            return True
    for s in steps:
        rule = registry.get_op(s["op"]).lower
        if s["op"] in ("elementwise_add", "elementwise_sub",
                       "elementwise_mul"):
            y = cur if s["arg"] == -2 else torch.from_numpy(args[s["arg"]])
            cur = rule(Ctx(), {"X": [cur], "Y": [y]}, s["attrs"])["Out"][0]
        else:
            cur = rule(Ctx(), {"X": [cur]}, s["attrs"])["Out"][0]
    assert got.dtype == cur.dtype
    assert torch.equal(got, cur)


def test_fused_elementwise_infer_and_numerics_equal_the_reference():
    """The fused op's infer rule (shape of the head, dtype through the
    cast steps) and numerics rule (each step's interval replayed) give
    the reference's results on a fused Transformer chain."""
    def build(fluid):
        x = fluid.layers.data(name="x", shape=[4, 8], dtype="float32")
        b = fluid.layers.create_parameter([8], "float32", name="b")
        h = fluid.layers.relu(fluid.layers.elementwise_add(
            fluid.layers.scale(x, scale=2.0, bias=1.0), b))
        return fluid.layers.cast(h, "float64").name
    res = {}
    for k, fluid in PACKAGES.items():
        main, _, out = _build(fluid, build)
        main.optimize(fetch_list=[out])
        mod = numcheck if k == "torch" else jnumcheck
        rep = mod.check_program(main, fetch_list=[out])
        info = rep.info(0, out)
        res[k] = (_types(main), (info.lo, info.hi, info.finite, info.dtype,
                                 info.shape))
    assert res["torch"] == res["jax"]
    assert res["torch"][0] == ["fused_elementwise"]


# ---------------------------------------------------------------------------
# pass selection
# ---------------------------------------------------------------------------

class TestPassSelection:
    def test_parse_passes(self):
        assert parse_passes("1") == DEFAULT_PASSES
        assert parse_passes("fold,dce") == ("fold", "dce")
        assert parse_passes(("fuse",)) == ("fuse",)
        with pytest.raises(ValueError):
            parse_passes("fold,bogus")

    def test_isolated_passes_report_only_their_work(self):
        def build(fluid):
            _const_chain(fluid)
            _var(fluid, "r")
            _gb(fluid).append_op("relu", inputs={"X": ["c3"]},
                                 outputs={"Out": ["r"]})
        report = _optimize_both(build, ["r"], passes=("fuse",))[2]
        assert report.n_folded == 0 and report.n_removed == 0
        assert report.passes == ("fuse",)

    @pytest.mark.parametrize("spec", ["1", "fold,fuse,cse,dce", "fold",
                                      "fuse,dce"])
    def test_env_hook_accepts_pass_list(self, monkeypatch, spec):
        monkeypatch.setenv("PADDLE_TPU_OPTIMIZE", spec)
        main = _build(tfluid, _const_chain)[0]
        out = tfluid.Executor(CPU).run(main, fetch_list=["c3"], mode="test",
                                       scope=tfluid.Scope())
        np.testing.assert_array_equal(out[0], np.full((4,), 12.0,
                                                      np.float32))
        # the caller's program is never mutated by the hook
        assert _types(main) == ["fill_constant", "scale", "elementwise_add"]

    def test_collect_cost_deltas_as_the_reference(self):
        """collect_cost=True: the per-pass cost-model deltas of the
        reference's report on the same program (folding turns the ops
        into constants, dce drops the two the fetch no longer reads)."""
        reports = {}
        for fluid in (jfluid, tfluid):
            main = _build(fluid, _const_chain)[0]
            reports[fluid] = main.optimize(fetch_list=["c3"],
                                           collect_cost=True)
        got, want = reports[tfluid], reports[jfluid]
        assert got.cost_deltas == want.cost_deltas
        assert got.cost_deltas["fold"]["bytes"] < 0
        assert got.cost_deltas["dce"]["n_ops"] == -2
        main = _build(tfluid, _const_chain)[0]
        report = main.optimize(fetch_list=["c3"])
        assert report.cost_deltas is None
        assert report.to_dict()["passes"] == list(DEFAULT_PASSES)


# ---------------------------------------------------------------------------
# serving hot path
# ---------------------------------------------------------------------------

@pytest.mark.serving
class TestServingOptimize:
    def _model(self):
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            h = fluid.layers.fc(x, size=16, act="relu")
            return fluid.layers.fc(h, size=10, act="softmax")
        main, startup, pred = _build(tfluid, build)
        scope = tfluid.Scope()
        tfluid.Executor(CPU).run(startup, scope=scope)
        return main.clone(for_test=True), pred, scope

    def test_engine_serves_optimized_clone_identically(self):
        from paddle_tpu_torch import serving
        infer, pred, scope = self._model()
        n0 = len(infer.global_block().ops)
        feed = {"x": np.random.RandomState(0).randn(2, 8).astype(np.float32)}
        kw = dict(scope=scope, place=CPU,
                  buckets=serving.BucketSpec(batch_sizes=(1, 2)),
                  config=serving.ServingConfig(max_wait_ms=5.0))
        with serving.ServingEngine(infer, ["x"], [pred], optimize=False,
                                   **kw) as off:
            assert off.optimize_report is None and off.optimize_ms is None
            assert off.stats()["optimize"] is None
            off.warmup()
            ref = off.infer(feed, timeout=30.0)
        with serving.ServingEngine(infer, ["x"], [pred], **kw) as on:
            assert on.optimize_report is not None
            assert on.optimize_report.n_fused >= 1
            assert on.optimize_ms > 0
            # caller's program untouched; engine serves its own clone
            assert len(infer.global_block().ops) == n0
            assert len(on.program.global_block().ops) < n0
            on.warmup()
            got = on.infer(feed, timeout=30.0)
            on.assert_no_recompiles()
            stats = on.stats()
        assert stats["optimize"]["fused"] >= 1
        assert stats["optimize"] == on.optimize_report.to_dict()
        _assert_bit_exact(got, ref)

    def test_engine_report_equals_the_reference(self):
        """The port's engine rewrites its program as the reference's
        ServingEngine does (the reference's default optimize)."""
        from paddle_tpu import serving as jserving
        from paddle_tpu_torch import serving
        infer, pred, scope = self._model()

        def jbuild(fluid):
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            h = fluid.layers.fc(x, size=16, act="relu")
            return fluid.layers.fc(h, size=10, act="softmax")
        jmain, jstartup, jpred = _build(jfluid, jbuild)
        jscope = jfluid.Scope()
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=jscope)
        jeng = jserving.ServingEngine(jmain.clone(for_test=True), ["x"],
                                      [jpred], scope=jscope,
                                      place=jfluid.CPUPlace(),
                                      auto_start=False)
        teng = serving.ServingEngine(infer, ["x"], [pred], scope=scope,
                                     place=CPU, auto_start=False)
        try:
            assert _records(teng.optimize_report) \
                == _records(jeng.optimize_report)
            assert _types(teng.program) == _types(jeng.program)
            assert teng.stats()["optimize"] == jeng.stats()["optimize"]
        finally:
            jeng.close()
            teng.close()

    def test_decode_engine_optimize_reports(self):
        """DecodeEngine(optimize=True), the default, rewrites each step
        program on a private clone: the single fused-op step programs
        leave the pipeline nothing to rewrite, the wiring still reports,
        and the reports equal the reference engine's."""
        from paddle_tpu import serving as jserving
        from paddle_tpu.models import llama as jllama
        from paddle_tpu_torch import serving
        from paddle_tpu_torch.models.llama import (LlamaConfig,
                                                   build_llama_generator)
        kw = dict(vocab_size=64, dim=16, n_layers=1, n_heads=2,
                  n_kv_heads=1, ffn_hidden=32, dtype="float32")
        cfg = LlamaConfig(**kw)
        prog, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), tfluid.program_guard(prog,
                                                              startup):
            ptok = tfluid.layers.data(name="ptok", shape=[1, 8],
                                      dtype="int64",
                                      append_batch_size=False)
            build_llama_generator(cfg, ptok, max_new_tokens=4)
        scope = tfluid.Scope()
        tfluid.Executor(CPU).run(startup, scope=scope)
        conf = dict(max_batch=2, prompt_buckets=(8,), max_new_tokens=4,
                    page_size=8)
        eng = serving.DecodeEngine(cfg, scope=scope, place=CPU,
                                   config=serving.DecodeConfig(**conf),
                                   auto_start=False)
        jeng = jserving.DecodeEngine(jllama.LlamaConfig(**kw),
                                     scope=jfluid.Scope(),
                                     place=jfluid.CPUPlace(),
                                     config=jserving.DecodeConfig(**conf),
                                     auto_start=False)
        try:
            assert isinstance(eng.optimize_reports, dict)
            assert eng.stats()["optimize"] is None \
                or isinstance(eng.stats()["optimize"], dict)
            assert eng.optimize_reports == jeng.optimize_reports
            assert eng.stats()["optimize"] == jeng.stats()["optimize"]
        finally:
            eng.close()
            jeng.close()


# ---------------------------------------------------------------------------
# the port's optcheck: zoo and Transformer-base, optimized vs unoptimized
# ---------------------------------------------------------------------------

def _check_optimized(main, startup, fetch, feed, mode, jmain=None):
    """Optimize a clone of ``main`` (as the executor hook does) and hold
    it to ``main``: every fetch and every persistable of the scope after
    one step, bit for bit. With ``jmain``, the reference's rewrite of
    the same program must report the same records and ops."""
    state = _run(startup, [])[1]
    opt = main.clone(for_test=main._is_test)
    report = opt.optimize(fetch_list=fetch)
    if jmain is not None:
        jopt = jmain.clone(for_test=jmain._is_test)
        assert _records(report) == _records(jopt.optimize(fetch_list=fetch))
        assert _types(opt) == _types(jopt)
    f0, s0 = _run(main, fetch, feed, state, mode)
    f1, s1 = _run(opt, fetch, feed, state, mode)
    _assert_bit_exact(f1, f0)
    assert sorted(s0) == sorted(s1)
    for k in s0:
        assert np.array_equal(s0[k], s1[k]), k
    # the rewrite never grows a program
    assert len(opt.global_block().ops) <= len(main.global_block().ops)
    return report, (f1, s1)


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name", tzoo.zoo_model_names())
def test_zoo_optimize_bit_exact(name, mode):
    with tfluid.unique_name.guard():
        zp = tzoo.build_zoo_program(name)
    with jfluid.unique_name.guard():
        jzp = jzoo.build_zoo_program(name)
    main = zp.main.clone(for_test=True) if mode == "test" else zp.main
    jmain = jzp.main.clone(for_test=True) if mode == "test" else jzp.main
    fetch = [v.name for v in zp.fetch_list]
    feed = tzoo.example_feed(name, batch=2)
    _check_optimized(main, zp.startup, fetch, feed, mode, jmain)


SRC, TGT, BATCH = 16, 12, 2


def _tf_parity(fluid, tf, dropout, labels=True):
    """The base width at 2 + 2 layers with lengths: noam + Adam."""
    cfg = dataclasses.replace(tf.TRANSFORMER_BASE, n_encoder_layers=2,
                              n_decoder_layers=2, dropout=dropout)

    def build(f):
        data = lambda n, s: f.layers.data(  # noqa: E731
            name=n, shape=s, dtype="int64", append_batch_size=False)
        src, tgt = data("src", [-1, SRC]), data("tgt", [-1, TGT])
        lbl = data("lbl", [-1, TGT]) if labels else None
        logits, loss = tf.build_transformer(
            cfg, src, tgt, lbl, src_lengths=data("src_len", [-1]),
            tgt_lengths=data("tgt_len", [-1]))
        if labels:
            f.optimizer.Adam(f.layers.noam_decay(cfg.d_model, 4),
                             beta1=0.9, beta2=0.98,
                             epsilon=1e-9).minimize(loss)
        return logits.name, (loss.name if labels else None)
    main, startup, (logits, loss) = _build(fluid, build)
    return main, startup, logits, loss, cfg


def _tf_feed(cfg, labels=True):
    r = np.random.RandomState(7)
    feed = {"src": r.randint(0, cfg.src_vocab_size, (BATCH, SRC)),
            "tgt": r.randint(0, cfg.tgt_vocab_size, (BATCH, TGT)),
            "src_len": np.asarray([SRC, 9]), "tgt_len": np.asarray([TGT, 5])}
    if labels:
        feed["lbl"] = r.randint(0, cfg.tgt_vocab_size, (BATCH, TGT))
    return {k: v.astype(np.int64) for k, v in feed.items()}


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_transformer_base_train_step_optimized_bit_exact(dropout):
    """A noam + Adam step of the Transformer-base parity model under
    the PADDLE_TPU_OPTIMIZE rewrite: the loss and every updated
    parameter, Adam moment and LR counter equal the unoptimized step's
    bit for bit — with dropout 0.1 too (train-time dropout is never
    fused, and the surviving draws keep their count)."""
    main, startup, _, loss, cfg = _tf_parity(tfluid, ttf, dropout)
    jmain = _tf_parity(jfluid, jtf, dropout)[0]
    report, _ = _check_optimized(main, startup, [loss], _tf_feed(cfg),
                                 "train", jmain)
    # scale + elementwise_add at the two embeddings, elementwise_add +
    # relu in each layer's feed-forward block
    assert report.n_fused == 6


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_transformer_base_serving_optimized_bit_exact(dropout):
    """The labels-free test clone, as the serving engine rewrites it:
    the logits equal the unoptimized program's bit for bit."""
    main, startup, logits, _, cfg = _tf_parity(tfluid, ttf, dropout,
                                               labels=False)
    jmain = _tf_parity(jfluid, jtf, dropout, labels=False)[0]
    report, _ = _check_optimized(
        main.clone(for_test=True), startup, [logits],
        _tf_feed(cfg, labels=False), "test", jmain.clone(for_test=True))
    assert report.n_fused >= 1


def test_optimized_port_matches_the_jax_package():
    """The optimized port against the JAX package (its own program,
    unoptimized) on the same state, dropout 0: logits at the f32 output
    tier, a train step's loss and updated parameters at the gradient
    tier."""
    tmain, _, tlogits, tloss, cfg = _tf_parity(tfluid, ttf, 0.0)
    jmain, jstartup, jlogits, jloss, _ = _tf_parity(jfluid, jtf, 0.0)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    state = {n: np.asarray(jscope.find_var(n)) for n in jscope.keys()}
    feed = _tf_feed(cfg)
    # serving: the test clone, optimized as the engine does
    tinfer = tmain.clone(for_test=True)
    assert tinfer.optimize(fetch_list=[tlogits]).n_fused >= 1
    got = _run(tinfer, [tlogits], feed, state)[0][0]
    want = np.asarray(jexe.run(jmain.clone(for_test=True), feed=feed,
                               fetch_list=[jlogits], scope=jscope)[0])
    np.testing.assert_allclose(got, want, **OUT_TOL)
    # training: one noam + Adam step, optimized: the loss and every
    # parameter's gradient
    grads = sorted(n for n in tmain.global_block().vars
                   if n.endswith("@GRAD"))
    topt = tmain.clone()
    assert topt.optimize(fetch_list=[tloss] + grads).n_fused >= 1
    got = _run(topt, [tloss] + grads, feed, state, mode="train")[0]
    want = jexe.run(jmain, feed=feed, fetch_list=[jloss] + grads,
                    scope=jscope)
    np.testing.assert_allclose(got[0], np.asarray(want[0]),
                               rtol=GRAD_TOL["rtol"])
    for n, g, w in zip(grads, got[1:], want[1:]):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=n, **GRAD_TOL)


# ---------------------------------------------------------------------------
# AMP: the rewrite gates and reports
# ---------------------------------------------------------------------------

def _amp_model(fluid):
    """An MLP whose bias-add + relu chains follow bf16 products under
    AMP, beside a constant chain the fold may take."""
    x = fluid.layers.data(name="x", shape=[16], dtype="float32")
    h = fluid.layers.fc(input=x, size=8, act="relu")
    out = fluid.layers.fc(input=h, size=4, act="tanh")
    _const_chain(fluid)
    s = fluid.layers.elementwise_add(
        out, fluid.default_main_program().global_block().var("c3"),
        axis=-1)
    return fluid.layers.scale(s, scale=0.5).name


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("model", ["mlp_const", "mnist_mlp", "transformer"])
def test_amp_rewrite_gates_and_reports_equal_the_reference(model, level):
    progs = {}
    for k, fluid in PACKAGES.items():
        if model == "mlp_const":
            main, startup, fetch = _build(fluid, _amp_model)
            fetch, feed = [fetch], {"x": np.random.RandomState(0).randn(
                3, 16).astype(np.float32)}
        else:
            zoo = tzoo if k == "torch" else jzoo
            with fluid.unique_name.guard():
                zp = zoo.build_zoo_program(model)
            main, startup = zp.main, zp.startup
            fetch = [v.name for v in zp.fetch_list]
            feed = tzoo.example_feed(model, batch=2)
        fluid.transpiler.amp_transpile(main, level=level)
        progs[k] = (main, startup, fetch, feed)
    (tmain, tstartup, fetch, feed), jmain = progs["torch"], progs["jax"][0]
    assert numcheck.amp_fold_admissible(tmain) \
        == jnumcheck.amp_fold_admissible(jmain)
    # the fuse gate's verdict on every chain the pass would fuse without
    # AMP (the chains are read off an AMP-off clone's fused ops)
    plain = tmain.clone(for_test=tmain._is_test)
    plain._amp = False
    fuse_elementwise_chains(plain, fetch)
    chains = [(op.input("X")[0], op.attrs["steps"], op.input("Args"))
              for op in plain.global_block().ops
              if op.type == "fused_elementwise"]
    assert chains
    tadmit = numcheck.amp_fuse_admissible(tmain)
    jadmit = jnumcheck.amp_fuse_admissible(jmain)
    verdicts = [tadmit(*c) for c in chains]
    assert verdicts == [jadmit(*c) for c in chains]
    # the reports and the rewritten programs
    topt = tmain.clone(for_test=tmain._is_test)
    jopt = jmain.clone(for_test=jmain._is_test)
    tr = topt.optimize(fetch_list=fetch)
    assert _records(tr) == _records(jopt.optimize(fetch_list=fetch))
    assert _types(topt) == _types(jopt)
    # the admitted rewrite is bit-exact under AMP too
    mode = "train" if any(op.type == "backward"
                          for op in tmain.global_block().ops) else "test"
    state = _run(tstartup, [])[1]
    f0, s0 = _run(tmain, fetch, feed, state, mode)
    f1, s1 = _run(topt, fetch, feed, state, mode)
    _assert_bit_exact(f1, f0)
    for k in s0:
        assert np.array_equal(s0[k], s1[k]), k


# ---------------------------------------------------------------------------
# chip_smoke's pinned reports are the reference's
# ---------------------------------------------------------------------------

def test_chip_smoke_pins_the_reference_reports():
    """chip_smoke.py holds the engine's report on its two serving
    programs to constants; they are what the JAX package's optimize
    reports on the same programs: Transformer-base's labels-free padded
    test clone at 256 tokens (``transformer_serve``) and the 32-layer
    Llama-3-8B-width forward (``serve``), built in both packages."""
    import chip_smoke
    from paddle_tpu.models import llama as jllama
    from paddle_tpu_torch.models import llama as tllama

    def tf_serve(fluid, tf):
        seq = chip_smoke.TF_SEQ
        data = lambda n, s: fluid.layers.data(  # noqa: E731
            name=n, shape=s, dtype="int64", append_batch_size=False)
        logits, _ = tf.build_transformer(
            tf.TRANSFORMER_BASE, data("src", [-1, seq]),
            data("tgt", [-1, seq]), None,
            src_lengths=data("src_len", [-1]),
            tgt_lengths=data("tgt_len", [-1]))
        return logits.name

    def llama_serve(fluid, llama):
        tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                                   dtype="int64", append_batch_size=False)
        return llama.build_llama(llama.LLAMA3_8B, tokens)[0].name

    for build, mods, want in (
            (tf_serve, (jtf, ttf), chip_smoke.TF_SERVE_OPTIMIZE_COUNTS),
            (llama_serve, (jllama, tllama),
             chip_smoke.SERVE_8B_OPTIMIZE_COUNTS)):
        reports = []
        for fluid, mod in zip((jfluid, tfluid), mods):
            main, _, fetch = _build(fluid, lambda f, m=mod: build(f, m))
            infer = main.clone(for_test=True)
            reports.append(infer.optimize(fetch_list=[fetch]))
        assert reports[0].counts() == want
        assert _records(reports[1]) == _records(reports[0])
    # chip_smoke's own build function gives the port's side of that
    # program
    main, _, logits, _, _ = chip_smoke.build_transformer_train(
        tfluid, ttf.TRANSFORMER_BASE, chip_smoke.TF_SEQ, chip_smoke.TF_SEQ,
        True, labels=False)
    report = optimize_program(main.clone(for_test=True),
                              fetch_list=[logits.name])
    assert report.counts() == chip_smoke.TF_SERVE_OPTIMIZE_COUNTS
