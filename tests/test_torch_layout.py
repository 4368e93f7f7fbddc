"""The ``"layout"`` rewrite (``analysis/layout.py``, a copy of the
reference's) on the port's conv zoo entries: the twin of
tests/test_layout.py's ``test_zoo_layout_parity`` and
``test_zoo_layout_combined_pipeline``, through tools/optcheck.py's
comparison rules.

Since item 5 registers the conv, pool, batch_norm and lrn ops, the pass
converts the conv paths for real. For each zoo entry the port's rewrite
makes the same decisions as the reference's (regions converted,
transposes inserted, the rewritten op sequence and attributes), and the
port runs the rewritten program against the original one eagerly on the
CPU, in train and infer modes, from one state and feed: converted
programs within optcheck's tolerances (fetches 1e-7 + 1e-5·max|a|,
state 1e-7 + 1e-4·max|a| plus twice the update's size) and bit-stable
run to run; a program the pass leaves alone bit-exact. SE-ResNeXt's
train-mode values are not compared (``TRAIN_VALUES``).
"""
import os
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.models import zoo as jzoo

from paddle_tpu_torch.core.lowering import lower_program
from paddle_tpu_torch.core.executor import Executor, CPUPlace, Scope
from paddle_tpu_torch.models import zoo as tzoo

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import optcheck  # noqa: E402  (its numpy comparison rules)

torch.set_num_threads(1)

CPU = torch.device("cpu")
CONV_ZOO = ["mnist", "resnet", "vgg", "se_resnext"]
# train-mode SE-ResNeXt at optcheck's batch 2: its last stages' batch
# norms average 8 values a channel (2 at the fourth), where the
# converted program's other reduction order moves a batch_norm output by
# 1.8e-4 and the fetch past the 1e-5 tolerance — in the reference's own
# optcheck as in the port (ROADMAP §3, R2; at batch 8 still 4.4× the
# tolerance). Its train-mode rewrite is held to the reference's
# decisions; its values in infer mode.
TRAIN_VALUES = {"se_resnext": False}


def _state(startup):
    scope = Scope()
    Executor(CPUPlace()).run(startup, scope=scope)
    return {n: v for n, v in scope.vars.items()}


def _run(program, state, feed, fetch_names, mode):
    fn = lower_program(program, fetch_names, mode)
    st = {n: v.clone() for n, v in state.items()}
    fd = {n: torch.as_tensor(v) for n, v in feed.items()}
    new, fetches = fn(st, fd, CPU, 7, 1)
    return ({n: v.detach().numpy().copy() for n, v in new.items()},
            [f.detach().numpy().copy() for f in fetches])


def _ops(program):
    return [(op.type, sorted(op.attrs.get(k) for k in ("data_format",
                                                       "data_layout", "axis")
                             if k in op.attrs))
            for op in program.global_block().ops]


def _check(name, passes):
    tz, jz = tzoo.build_zoo_program(name), jzoo.build_zoo_program(name)
    fetch = [v.name for v in tz.fetch_list]
    feed = tzoo.example_feed(name, batch=2)
    state = _state(tz.startup)
    prev = {n: v.numpy() for n, v in state.items()}
    out = {}
    for label in ("train", "infer"):
        for_test = label == "infer"
        base, opt = (tz.main.clone(for_test=for_test),
                     tz.main.clone(for_test=for_test))
        report = opt.optimize(fetch_list=fetch, passes=passes)
        jopt = jz.main.clone(for_test=for_test)
        jreport = jopt.optimize(fetch_list=fetch, passes=passes)
        assert (report.n_converted, report.n_layout_transposes) == \
            (jreport.n_converted, jreport.n_layout_transposes), label
        assert _ops(opt) == _ops(jopt), label
        out[label] = report
        if not (for_test or TRAIN_VALUES.get(name, True)):
            continue
        mode = "test" if for_test else "train"
        s0, f0 = _run(base, state, feed, fetch, mode)
        s1, f1 = _run(opt, state, feed, fetch, mode)
        if report.n_converted:
            assert optcheck._fetches_close(f0, f1), label
            assert optcheck._state_close(s0, s1, prev), label
            s2, f2 = _run(opt, state, feed, fetch, mode)
            assert optcheck._bit_equal(f1, f2) and \
                optcheck._bit_equal(s1, s2), label
        else:
            assert optcheck._bit_equal(f0, f1) and \
                optcheck._bit_equal(s0, s1), label
    return out


@pytest.mark.parametrize("name", CONV_ZOO + ["mnist_mlp", "fit_a_line"])
def test_zoo_layout_parity(name):
    reports = _check(name, ("layout",))
    converted = any(r.n_converted for r in reports.values())
    # every conv entry has a region worth converting; the others none
    assert converted == (name in CONV_ZOO)
    for r in reports.values():
        if r.n_converted:
            assert r.n_layout_transposes >= 2


@pytest.mark.parametrize("name", CONV_ZOO)
def test_zoo_layout_combined_pipeline(name):
    _check(name, ("layout", "fold", "fuse", "cse", "dce"))


# ---------------------------------------------------------------------------
# the cost-model remat upgrade (tests/test_layout.py's
# TestRematPolicyUpgrade): analysis/cost.py's per-policy estimates and
# recommendation, equal to the reference's
# ---------------------------------------------------------------------------

import paddle_tpu as jfluid  # noqa: E402

import paddle_tpu_torch as tfluid  # noqa: E402
from paddle_tpu_torch.analysis import cost as tcost  # noqa: E402


class TestRematPolicyUpgrade:
    def test_estimates_structure(self):
        est = tcost.estimate_remat_policies(
            tzoo.build_zoo_program("resnet").main)
        assert est == jfluid.analysis.estimate_remat_policies(
            jzoo.build_zoo_program("resnet").main)
        fwd = est.pop("__forward_flops__")
        assert fwd > 0
        assert est["everything_saveable"]["recompute_flops"] == 0
        assert est["nothing_saveable"]["residual_bytes"] == 0
        # nested policies: residuals monotone with permissiveness
        assert est["nothing_saveable"]["residual_bytes"] \
            <= est["save_conv_only"]["residual_bytes"] \
            <= est["dots_saveable"]["residual_bytes"] \
            <= est["everything_saveable"]["residual_bytes"]
        assert est["nothing_saveable"]["recompute_flops"] \
            >= est["save_conv_only"]["recompute_flops"] \
            >= est["dots_saveable"]["recompute_flops"] \
            >= est["everything_saveable"]["recompute_flops"]

    def test_conv_net_agrees_with_heuristic(self):
        assert tcost.recommend_remat_policy(
            tzoo.build_zoo_program("resnet").main) == "save_conv_only"
        assert tcost.recommend_remat_policy(
            tzoo.build_zoo_program("mnist_mlp").main) == "dots_saveable"

    def test_elementwise_net_disagrees_with_heuristic(self):
        """A pure elementwise forward: the old table says recompute
        everything (nothing_saveable); the cost model sees that
        recomputing the whole forward blows the recompute budget and
        recommends no remat instead — in both packages."""
        got = {}
        for fluid in (jfluid, tfluid):
            main = fluid.Program()
            with fluid.unique_name.guard(), fluid.program_guard(
                    main, fluid.Program()):
                x = fluid.layers.data(name="x", shape=[64],
                                      dtype="float32")
                gb = main.global_block()
                gb.create_parameter("w", shape=[64])
                for op, ins, out in (("elementwise_mul", {"X": [x.name],
                                                          "Y": ["w"]}, "y"),
                                     ("tanh", {"X": ["y"]}, "t"),
                                     ("mean", {"X": ["t"]}, "loss")):
                    gb.create_var(name=out, dtype="float32")
                    gb.append_op(op, inputs=ins, outputs={"Out": [out]})
                gb.create_var(name="w@GRAD", dtype="float32")
                gb.append_op("backward", inputs={"Loss": ["loss"]},
                             attrs={"parameter_names": ["w"]})
            cost = jfluid.analysis.cost if fluid is jfluid else tcost
            got[fluid.__name__] = (
                cost._heuristic_remat_policy(
                    cost.estimate_remat_residuals(main)),
                cost.recommend_remat_policy(main),
                cost.estimate_remat_policies(main))
        assert got["paddle_tpu_torch"][:2] == ("nothing_saveable",
                                               "everything_saveable")
        assert got["paddle_tpu_torch"] == got["paddle_tpu"]

    @pytest.mark.parametrize("name", tzoo.zoo_model_names())
    def test_zoo_estimate_remat_policies_equal_the_reference(self, name):
        jp, tp = jzoo.build_zoo_program(name), tzoo.build_zoo_program(name)
        for batch in (1, 8):
            assert tcost.estimate_remat_policies(
                tp.main, assume_batch=batch) == \
                jfluid.analysis.estimate_remat_policies(
                    jp.main, assume_batch=batch)
            assert tcost.recommend_remat_policy(
                tp.main, assume_batch=batch) == \
                jfluid.analysis.recommend_remat_policy(
                    jp.main, assume_batch=batch)
