"""Static numerics (``paddle_tpu_torch.analysis.numcheck``) of the torch
port against the JAX package's.

Mirrors tests/test_numcheck.py's lattice and program cases on the ops
the port registers (the fake-quantize fixture waits for ROADMAP.md item
'Remaining op families and the zoo'; the numlint CLI for item 'Fleet and
analyzers'): every case asserts on the port what the reference case
asserts, and that ``check_program`` gives the reference's report on the
same program built with each package's layer code — every binding's
interval, finiteness, run-time dtype and shape, the ``narrowed`` set,
``finite_safe`` and the findings (code, level, block, op index,
message). Then the zoo sweep: every ported zoo program (the conv nets
since item 5), train and test, with and without AMP O1/O2. All exact.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.analysis import numcheck as jnumcheck
from paddle_tpu.models import zoo as jzoo

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.analysis.numcheck import (
    NumInfo, TOP, add_iv, amp_fold_admissible, amp_fuse_admissible,
    check_program, div_iv, interval, join_iv, mul_iv)
from paddle_tpu_torch.models import zoo as tzoo

torch.set_num_threads(1)

PACKAGES = {"jax": (jfluid, jnumcheck, jzoo),
            "torch": (tfluid, None, tzoo)}


def _codes(report, level=None):
    return [d.code for d in report.findings
            if level is None or d.level == level]


def _snapshot(report):
    """Everything a NumericsReport says, as plain comparable values."""
    def info(v):
        return (v.lo, v.hi, v.finite, v.dtype, v.shape, v.confident)
    return {"vars": {k: info(v) for k, v in report.vars.items()},
            "findings": [(d.code, d.level, d.block_idx, d.op_idx,
                          d.message) for d in report.findings],
            "narrowed": sorted(report.narrowed), "amp": report.amp,
            "finite_safe": report.finite_safe,
            "errors": sorted(report.error_op_idxs)}


def _check_both(fn, amp=None):
    """``fn(fluid)`` builds a program in each package (returning its
    fetch variable); both are checked; their reports must agree.
    Returns the port's (report, fetch name)."""
    snaps = {}
    for k, (fluid, mod, _) in PACKAGES.items():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            out = fn(fluid)
        if amp:
            main._amp = amp
        check = check_program if mod is None else mod.check_program
        rep = check(main, fetch_list=[out])
        snaps[k] = _snapshot(rep)
        if k == "torch":
            result = (rep, out.name, main)
    assert snaps["torch"] == snaps["jax"]
    return result


# ---------------------------------------------------------------------------
# the lattice
# ---------------------------------------------------------------------------

class TestLattice:
    def test_top_is_unbounded_and_unconfident(self):
        assert not TOP.confident and not TOP.bounded and not TOP.finite

    def test_interval_helper_is_confident(self):
        iv = interval(-2.0, 3.0)
        assert iv.confident and iv.finite and iv.mag == 3.0

    def test_add_mul_arithmetic(self):
        a, b = interval(-1.0, 2.0), interval(3.0, 4.0)
        assert add_iv(a, b) == (2.0, 6.0)
        assert mul_iv(a, b) == (-4.0, 8.0)
        assert mul_iv(interval(0.0, np.inf), interval(0.0, 0.0)) \
            == jnumcheck.mul_iv(jnumcheck.interval(0.0, np.inf),
                                jnumcheck.interval(0.0, 0.0))

    def test_div_through_zero_is_unbounded(self):
        lo, hi = div_iv(interval(1.0, 2.0), interval(-1.0, 1.0))
        assert lo == -np.inf and hi == np.inf
        assert div_iv(interval(1.0, 2.0), interval(4.0, 8.0)) == (0.125, 0.5)

    def test_join_is_union(self):
        j = join_iv([interval(-1.0, 0.0), interval(2.0, 5.0)])
        assert (j.lo, j.hi) == (-1.0, 5.0)
        assert j.finite and j.confident
        assert not join_iv([]).confident
        assert isinstance(j, NumInfo)


# ---------------------------------------------------------------------------
# fixture programs
# ---------------------------------------------------------------------------

def _bounded_source(fluid):
    """sigmoid(data) — a provably [0, 1] value to scale up from."""
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    return fluid.layers.sigmoid(x)


def _fp16_overflow(fluid):
    z = fluid.layers.scale(_bounded_source(fluid), scale=1e6)
    return fluid.layers.cast(z, dtype="float16")


def _int8_clip(fluid):
    z = fluid.layers.scale(_bounded_source(fluid), scale=300.0)
    return fluid.layers.cast(z, dtype="int8")


def _log_of_tanh(fluid):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    return fluid.layers.log(fluid.layers.tanh(x))     # [-1, 1] crosses 0


def _bf16_precision(fluid):
    y = fluid.layers.scale(_bounded_source(fluid), scale=1e6)
    # 1e6 fits bf16's exponent but not its 7-bit mantissa
    return fluid.layers.cast(y, dtype="bfloat16")


def _fp16_reduce(fluid):
    x = fluid.layers.data(name="x", shape=[64], dtype="float16")
    return fluid.layers.reduce_sum(x)


def _bounded_clean(fluid):
    return fluid.layers.cast(
        fluid.layers.scale(_bounded_source(fluid), scale=2.0),
        dtype="float16")


def _div_by_relu(fluid):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    return fluid.layers.elementwise_div(x, fluid.layers.relu(x))


class TestFixtures:
    def test_fp16_overflow_fixture_is_error(self):
        rep, _, _ = _check_both(_fp16_overflow)
        assert "fp16-overflow-risk" in _codes(rep, "error")
        assert not rep.finite_safe

    def test_int8_scale_clip_fixture_is_error(self):
        rep, _, _ = _check_both(_int8_clip)
        assert "int8-scale-clip" in _codes(rep, "error")

    def test_domain_hazard_log_of_negative_is_warning(self):
        rep, _, _ = _check_both(_log_of_tanh)
        assert "domain-hazard" in _codes(rep, "warning")

    def test_domain_hazard_div_by_zero_is_warning(self):
        rep, _, _ = _check_both(_div_by_relu)
        assert "domain-hazard" in _codes(rep, "warning")

    def test_cast_precision_loss_is_warning(self):
        rep, _, _ = _check_both(_bf16_precision)
        assert "cast-precision-loss" in _codes(rep, "warning")
        assert not _codes(rep, "error")

    def test_fp16_reduce_without_bound_is_warning(self):
        rep, _, _ = _check_both(_fp16_reduce)
        assert "amp-unprotected-reduce" in _codes(rep, "warning")

    def test_bounded_program_is_clean_and_finite_safe(self):
        rep, _, _ = _check_both(_bounded_clean)
        assert not rep.findings
        assert rep.finite_safe


# ---------------------------------------------------------------------------
# activation clamps
# ---------------------------------------------------------------------------

def _act(name):
    def fn(fluid):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        return getattr(fluid.layers, name)(x)
    return fn


def _cross_entropy(fluid):
    x = fluid.layers.data(name="x", shape=[10], dtype="float32")
    lbl = fluid.layers.data(name="y", shape=[1], dtype="int64")
    return fluid.layers.cross_entropy(input=fluid.layers.softmax(x),
                                      label=lbl)


class TestClamps:
    def _info(self, fn):
        rep, out, _ = _check_both(fn)
        return rep.info(0, out)

    def test_sigmoid_clamps_to_unit(self):
        info = self._info(_act("sigmoid"))
        assert (info.lo, info.hi) == (0.0, 1.0) and info.finite

    def test_tanh_clamps_symmetric(self):
        info = self._info(_act("tanh"))
        assert (info.lo, info.hi) == (-1.0, 1.0)

    def test_relu_clamps_lo(self):
        info = self._info(_act("relu"))
        assert info.lo == 0.0 and info.hi == np.inf

    def test_softmax_bounded_unit(self):
        info = self._info(_act("softmax"))
        assert (info.lo, info.hi) == (0.0, 1.0)

    def test_cross_entropy_is_finite(self):
        info = self._info(_cross_entropy)
        assert info.finite and info.lo >= -1e-6
        assert info.hi < 25.0      # -log(eps), eps=1e-9

    @pytest.mark.parametrize("name", ["exp", "square", "abs", "gelu",
                                      "leaky_relu", "softplus", "sqrt",
                                      "rsqrt", "logsigmoid", "relu6"])
    def test_activation_interval_equals_the_reference(self, name):
        info = self._info(_act(name))
        assert info.confident


# ---------------------------------------------------------------------------
# AMP narrowing + rewrite admission gates
# ---------------------------------------------------------------------------

def _amp_mlp(fluid):
    x = fluid.layers.data(name="x", shape=[16], dtype="float32")
    h = fluid.layers.fc(input=x, size=8, act="relu")
    return fluid.layers.fc(input=h, size=4)


class TestAmpGates:
    def test_o2_narrows_matmul_outputs(self):
        rep, _, _ = _check_both(_amp_mlp, amp="O2")
        assert rep.amp == "O2"
        assert rep.narrowed          # bf16 flow reached some binding

    def test_o1_casts_back_no_narrowing_downstream(self):
        rep, out, _ = _check_both(_amp_mlp, amp="O1")
        assert rep.info(0, out).dtype != "bfloat16"

    def test_fold_gate_open_without_amp(self):
        _, _, main = _check_both(_amp_mlp)
        assert amp_fold_admissible(main) is None

    def test_fold_gate_excludes_matmul_ops_under_amp(self):
        _, _, main = _check_both(_amp_mlp, amp="O2")
        ok = amp_fold_admissible(main)
        assert ok is not None
        for i, op in enumerate(main.global_block().ops):
            if op.type in ("mul", "matmul"):
                assert i not in ok

    def test_fuse_gate_semantics(self):
        _, _, main = _check_both(_amp_mlp, amp="O2")
        admit = amp_fuse_admissible(main)
        gb = main.global_block()
        mul_out = next(op.output("Out")[0] for op in gb.ops
                       if op.type == "mul")        # bf16 under O2
        bias = next(op.input("Y")[0] for op in gb.ops
                    if op.type == "elementwise_add")   # f32 param
        # bf16 head through a NON-flow op: the unfused form upcasts,
        # the fused replay would not — refused
        assert not admit(mul_out,
                         [{"op": "sigmoid", "attrs": {}, "arg": -1}], [])
        # bf16 head + f32 side mixed at the FINAL step: admitted
        assert admit(mul_out,
                     [{"op": "elementwise_add", "attrs": {}, "arg": 0}],
                     [bias])
        # the same mix INTERIOR (a step follows): refused
        assert not admit(mul_out,
                         [{"op": "elementwise_add", "attrs": {}, "arg": 0},
                          {"op": "relu", "attrs": {}, "arg": -1}], [bias])
        # no bf16 anywhere in the chain: any ops admit
        assert admit(bias, [{"op": "sigmoid", "attrs": {}, "arg": -1}], [])

    def test_fuse_gate_open_without_amp(self):
        _, _, main = _check_both(_amp_mlp)
        admit = amp_fuse_admissible(main)
        assert admit("anything", [{"op": "sigmoid", "attrs": {},
                                   "arg": -1}], [])


# ---------------------------------------------------------------------------
# the zoo sweep: the reference's report on every ported zoo program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("amp", [False, "O1", "O2"])
@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name", tzoo.zoo_model_names())
def test_zoo_report_equals_the_reference(name, mode, amp):
    snaps = {}
    for k, (fluid, mod, zoo) in PACKAGES.items():
        with fluid.unique_name.guard():
            zp = zoo.build_zoo_program(name)
        main = zp.main.clone(for_test=True) if mode == "test" else zp.main
        if amp:
            fluid.transpiler.amp_transpile(main, level=amp)
        check = check_program if mod is None else mod.check_program
        rep = check(main, fetch_list=zp.fetch_list)
        snaps[k] = _snapshot(rep)
        if k == "torch":
            assert not rep.errors(), [d.message for d in rep.errors()]
            if amp == "O2":
                assert rep.narrowed
    assert snaps["torch"] == snaps["jax"]
