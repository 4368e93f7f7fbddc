"""The static verifier of the torch port (``paddle_tpu_torch.analysis``)
against the JAX package's, on the same programs built with each
package's layer code.

Mirrors tests/test_analysis.py's TestInference, TestDiagnostics,
TestRegistry and TestExecutorValidation (the conv cases wait for the
port's conv ops): every case asserts what the reference test asserts,
on the port, and that both packages' ``verify`` give the same findings —
(code, level, block, op index, message), the message naming the op and
its variables. ``infer_program`` gives the same shape, dtype, lod level
and confidence for every variable of the four ported zoo programs
(train and test), of TRANSFORMER_BASE and of the full-width
Llama-3-8B serving program (static only: nothing is run). All exact.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.analysis import infer_program as jinfer
from paddle_tpu.core import registry as jregistry
from paddle_tpu.models import llama as jllama
from paddle_tpu.models import transformer as jtf
from paddle_tpu.models import zoo as jzoo

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.analysis import (VerifyError, VerifyWarning, errors,
                                       infer_program, verify_program)
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models import transformer as ttf
from paddle_tpu_torch.models import zoo as tzoo

torch.set_num_threads(1)

PACKAGES = {"jax": (jfluid, jinfer, jzoo, jtf, jllama),
            "torch": (tfluid, infer_program, tzoo, ttf, tllama)}


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
    """``build(fluid)`` in fresh programs under each package: {package:
    (main, startup, what build returned)}."""
    return {k: _build(p[0], build) for k, p in PACKAGES.items()}


def _infos(result):
    return {k: (v.shape, v.dtype, v.lod_level, v.confident)
            for k, v in result.vars.items()}


# ---------------------------------------------------------------------------
# shape/dtype inference engine
# ---------------------------------------------------------------------------

def _mlp(fluid):
    x = fluid.layers.data(name="x", shape=[784], dtype="float32")
    h = fluid.layers.fc(x, size=128, act="relu")
    p = fluid.layers.fc(h, size=10, act="softmax")
    return h.name, p.name, fluid.layers.mean(p).name


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


class TestInference:
    def test_mlp_shapes_propagate(self):
        progs = _both(_mlp)
        main, _, (h, p, loss) = progs["torch"]
        res = infer_program(main)
        assert res.info(0, h).shape == (-1, 128)
        assert res.info(0, p).shape == (-1, 10)
        assert res.info(0, loss).shape == (1,)
        assert res.info(0, p).dtype == "float32"
        assert res.info(0, p).confident
        assert _infos(res) == _infos(jinfer(progs["jax"][0]))

    def test_unknown_op_falls_to_lattice_bottom(self):
        def build(fluid):
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            gb = fluid.default_main_program().global_block()
            gb.create_var(name="mystery_out", dtype="float32")
            gb.append_op("warpctc", inputs={"X": [x.name]},
                         outputs={"Out": ["mystery_out"]})
        progs = _both(build)
        res = infer_program(progs["torch"][0])
        info = res.info(0, "mystery_out")
        assert info.shape is None and not info.confident
        assert _infos(res) == _infos(jinfer(progs["jax"][0]))

    def test_reshape_infers_minus_one(self):
        def build(fluid):
            a = fluid.layers.data(name="a", shape=[4, 6], dtype="float32",
                                  append_batch_size=False)
            return fluid.layers.reshape(a, shape=[-1, 3]).name
        progs = _both(build)
        res = infer_program(progs["torch"][0])
        assert res.info(0, progs["torch"][2]).shape == (8, 3)
        assert _infos(res) == _infos(jinfer(progs["jax"][0]))

    def test_grad_vars_take_param_shapes(self):
        progs = _both(_regression)
        main = progs["torch"][0]
        w = [p.name for p in main.all_parameters() if p.shape == (8, 1)][0]
        res = infer_program(main)
        assert res.info(0, w + "@GRAD").shape == (8, 1)
        assert _infos(res) == _infos(jinfer(progs["jax"][0]))


def _zoo_programs():
    out = []
    for name in tzoo.zoo_model_names():
        for mode in ("train", "test"):
            out.append(pytest.param(name, mode, id=f"{name}-{mode}"))
    return out


def _zoo_pair(name, mode):
    pair = {}
    for k, (fluid, _, zoo, _, _) in PACKAGES.items():
        with fluid.unique_name.guard():
            zp = zoo.build_zoo_program(name)
        main = zp.main.clone(for_test=True) if mode == "test" else zp.main
        pair[k] = (main, zp)
    return pair


@pytest.mark.parametrize("name,mode", _zoo_programs())
def test_zoo_infer_and_verify_equal_the_reference(name, mode):
    """Every var's inferred (shape, dtype, lod level, confidence), and
    the full verifier's findings with the zoo's fetch and feed contract,
    equal the reference's; no error-level finding (the reference's zoo
    sweep)."""
    pair = _zoo_pair(name, mode)
    tmain, tzp = pair["torch"]
    jmain, jzp = pair["jax"]
    assert _infos(infer_program(tmain)) == _infos(jinfer(jmain))
    fetch = [v.name for v in tzp.fetch_list]
    tdiags = tmain.verify(startup_program=tzp.startup, fetch_list=fetch,
                          feed_names=tzp.feed_names)
    jdiags = jmain.verify(startup_program=jzp.startup, fetch_list=fetch,
                          feed_names=jzp.feed_names)
    assert _key(tdiags) == _key(jdiags)
    assert not errors(tdiags), [d.format() for d in errors(tdiags)]


def _transformer_base(fluid, tf, padded, labels):
    seq = 256
    data = lambda n, s: fluid.layers.data(  # noqa: E731
        name=n, shape=s, dtype="int64", append_batch_size=False)
    src, tgt = data("src", [-1, seq]), data("tgt", [-1, seq])
    lbl = data("lbl", [-1, seq]) if labels else None
    kw = dict(src_lengths=data("src_len", [-1]),
              tgt_lengths=data("tgt_len", [-1])) if padded else {}
    logits, loss = tf.build_transformer(tf.TRANSFORMER_BASE, src, tgt, lbl,
                                        **kw)
    if labels:
        lr = fluid.layers.noam_decay(512, 4000)
        fluid.optimizer.Adam(lr, beta1=0.9, beta2=0.98,
                             epsilon=1e-9).minimize(loss)
        return [loss.name]
    return [logits.name]


@pytest.mark.parametrize("padded,labels", [(True, True), (True, False),
                                           (False, False)],
                         ids=["train-lengths", "serve-lengths",
                              "serve-unpadded"])
def test_transformer_base_infer_and_verify_equal_the_reference(padded,
                                                               labels):
    """TRANSFORMER_BASE at full width and depth, 256 tokens: the train
    program (noam + Adam) and the labels-free ``clone(for_test=True)``
    that serving runs."""
    progs = {}
    for k, (fluid, infer, _, tf, _) in PACKAGES.items():
        main, _, fetch = _build(
            fluid, lambda f, tf=tf: _transformer_base(f, tf, padded, labels))
        progs[k] = (main if labels else main.clone(for_test=True), fetch,
                    infer)
    (tmain, fetch, _), (jmain, _, _) = progs["torch"], progs["jax"]
    assert _infos(infer_program(tmain)) == _infos(jinfer(jmain))
    tdiags = tmain.verify(fetch_list=fetch)
    assert _key(tdiags) == _key(jmain.verify(fetch_list=fetch))
    assert not errors(tdiags)
    # what the reference finds on its serving program: tpu-pad on the
    # padded attention's matmuls, no infer rule for multihead_attention
    # (and sequence_mask), tgt_len fed but never read
    assert "no-infer-rule" in _codes(tdiags, "warning")


def test_llama3_8b_width_infer_and_verify_equal_the_reference():
    """The full-width, 32-layer Llama-3-8B serving program (IR only: no
    weights are built)."""
    progs = {}
    for k, (fluid, _, _, _, llama) in PACKAGES.items():
        def build(f, llama=llama):
            tokens = f.layers.data(name="tokens", shape=[-1, -1],
                                   dtype="int64", append_batch_size=False)
            return llama.build_llama(llama.LLAMA3_8B, tokens)[0].name
        main, _, logits = _build(fluid, build)
        progs[k] = (main.clone(for_test=True), logits)
    (tmain, logits), (jmain, _) = progs["torch"], progs["jax"]
    assert _infos(infer_program(tmain)) == _infos(jinfer(jmain))
    tdiags = tmain.verify(fetch_list=[logits])
    assert _key(tdiags) == _key(jmain.verify(fetch_list=[logits]))
    assert "recompile-hazard" in _codes(tdiags, "warning")
    assert not errors(tdiags)


# ---------------------------------------------------------------------------
# one case per diagnostic code (the conv-free cases of the reference)
# ---------------------------------------------------------------------------

def _use_before_def(fluid):
    fluid.layers.data(name="x", shape=[8], dtype="float32")
    fluid.default_main_program().global_block().append_op(
        "relu", inputs={"X": ["never_defined"]}, outputs={"Out": ["r"]})


def _dangling_fetch(fluid):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    h = fluid.layers.fc(x, size=4)
    return dict(fetch_list=[h.name + "_typo"])


def _dangling_feed(fluid):
    fluid.layers.data(name="unused", shape=[8], dtype="float32")
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    fluid.layers.fc(x, size=4)


def _dtype_mismatch(fluid):
    a = fluid.layers.data(name="a", shape=[8], dtype="float32")
    b = fluid.layers.data(name="b", shape=[8], dtype="int64")
    fluid.layers.elementwise_add(a, b)


def _shape_mismatch_mul(fluid):
    a = fluid.layers.data(name="a", shape=[4, 6], dtype="float32",
                          append_batch_size=False)
    gb = fluid.default_main_program().global_block()
    w = gb.create_parameter("w_bad", shape=[7, 3])
    gb.create_var(name="mm_out", dtype="float32")
    gb.append_op("mul", inputs={"X": [a.name], "Y": [w.name]},
                 outputs={"Out": ["mm_out"]})


def _shape_mismatch_reshape(fluid):
    a = fluid.layers.data(name="a", shape=[4, 6], dtype="float32",
                          append_batch_size=False)
    fluid.layers.reshape(a, shape=[5, 5])


def _param_shape_drift(fluid):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    fluid.layers.fc(x, size=4)
    startup = fluid.default_startup_program()
    sv = next(iter(startup.global_block().vars.values()))
    sv.shape = (7, 7)
    return dict(startup_program=startup)


def _dead_op(fluid):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    live = fluid.layers.fc(x, size=4)
    fluid.layers.fc(x, size=2)          # never fetched or consumed
    return dict(fetch_list=[live.name])


def _grad_name_mismatch(fluid):
    _regression(fluid, minimize=False)
    gb = fluid.default_main_program().global_block()
    bwd = [op for op in gb.ops if op.type == "backward"][0]
    bwd.attrs["parameter_names"] = \
        list(bwd.attrs["parameter_names"]) + ["ghost_param"]


def _grad_var_missing(fluid):
    _regression(fluid, minimize=False)
    gb = fluid.default_main_program().global_block()
    del gb.vars[sorted(n for n in gb.vars if n.endswith("@GRAD"))[0]]


def _donation_alias(fluid):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    h = fluid.layers.fc(x, size=8)
    fluid.default_main_program().global_block().append_op(
        "relu", inputs={"X": [h.name]}, outputs={"Out": [x.name]})


def _no_lowering_rule(fluid):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    fluid.default_main_program().global_block().append_op(
        "totally_made_up_op", inputs={"X": [x.name]}, outputs={"Out": ["o"]})


def _tpu_pad(fluid):
    x = fluid.layers.data(name="x", shape=[100], dtype="float32")
    fluid.layers.fc(x, size=7)


def _tpu_pad_aligned(fluid):
    x = fluid.layers.data(name="x", shape=[256], dtype="float32")
    fluid.layers.fc(x, size=128, bias_attr=False)


def _recompile_hazard(fluid):
    fluid.layers.data(name="ragged", shape=[-1, -1, 8], dtype="float32",
                      append_batch_size=False)


def _dead_op_without_fetch(fluid):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    fluid.layers.fc(x, size=4)


# (build function, code expected, level or None: code expected absent)
DIAG_CASES = {
    "use_before_def": (_use_before_def, "use-before-def", "error"),
    "dangling_fetch": (_dangling_fetch, "dangling-fetch", "error"),
    "dangling_feed": (_dangling_feed, "dangling-feed", "warning"),
    "dtype_mismatch": (_dtype_mismatch, "dtype-mismatch", "error"),
    "shape_mismatch_mul": (_shape_mismatch_mul, "shape-mismatch", "error"),
    "shape_mismatch_reshape": (_shape_mismatch_reshape, "shape-mismatch",
                               "error"),
    "param_shape_drift": (_param_shape_drift, "param-shape-drift", "error"),
    "dead_op": (_dead_op, "dead-op", "warning"),
    "dead_op_silent_without_fetch_list": (_dead_op_without_fetch,
                                          "dead-op", None),
    "grad_name_mismatch": (_grad_name_mismatch, "grad-name-mismatch",
                           "error"),
    "grad_var_missing": (_grad_var_missing, "grad-name-mismatch", "error"),
    "donation_alias": (_donation_alias, "donation-alias", "warning"),
    "no_lowering_rule": (_no_lowering_rule, "no-lowering-rule", "error"),
    "tpu_pad_lint": (_tpu_pad, "tpu-pad", "warning"),
    "tpu_pad_silent_when_aligned": (_tpu_pad_aligned, "tpu-pad", None),
    "recompile_hazard": (_recompile_hazard, "recompile-hazard", "warning"),
}


@pytest.mark.parametrize("case", sorted(DIAG_CASES))
def test_diagnostic_as_in_reference(case):
    build, code, level = DIAG_CASES[case]
    progs = _both(build)
    diags = {}
    for k, (main, _, kw) in progs.items():
        diags[k] = main.verify(**(kw or {}))
    if level is None:
        assert code not in _codes(diags["torch"])
    else:
        assert code in _codes(diags["torch"], level)
    assert _key(diags["torch"]) == _key(diags["jax"])


def test_dangling_fetch_hint_names_the_near_miss():
    main, _, kw = _build(tfluid, _dangling_fetch)
    errs = [d for d in main.verify(**kw) if d.code == "dangling-fetch"]
    assert errs and kw["fetch_list"][0][:-len("_typo")] in errs[0].hint


def test_grad_var_missing_names_the_variable():
    main, _, _ = _build(tfluid, _grad_var_missing)
    gb = main.global_block()
    missing = [p.name + "@GRAD" for p in main.all_parameters()
               if p.name + "@GRAD" not in gb.vars]
    msgs = [d.message for d in main.verify()
            if d.code == "grad-name-mismatch" and d.level == "error"]
    assert missing and any(missing[0] in m for m in msgs)


def test_strict_verify_raises_with_the_records():
    main, _, _ = _build(tfluid, _use_before_def)
    with pytest.raises(VerifyError) as e:
        main.verify(strict=True)
    assert "use-before-def" in _codes(e.value.diagnostics)
    # cheap level: the structural subset, which still sees it
    assert "use-before-def" in _codes(main.verify(level="cheap"))


# ---------------------------------------------------------------------------
# registry hygiene
# ---------------------------------------------------------------------------

class TestRegistry:
    def test_duplicate_lowering_registration_rejected(self):
        with pytest.raises(ValueError, match="registered twice"):
            @registry.register_op("relu")
            def shadow(ctx, ins, attrs):
                return {}

    def test_duplicate_infer_registration_rejected(self):
        with pytest.raises(ValueError, match="registered twice"):
            @registry.register_infer("relu")
            def shadow(op, ins, attrs):
                return {}

    def test_duplicate_numerics_registration_rejected(self):
        with pytest.raises(ValueError, match="registered twice"):
            @registry.register_numerics("relu")
            def shadow(op, ins, attrs):
                return {}

    def test_diagnostic_codes_and_levels_are_the_reference_s(self):
        """The vocabulary findings are compared in: every code at the
        reference's level."""
        from paddle_tpu.analysis import CODES as JCODES
        from paddle_tpu_torch.analysis import CODES
        assert {k: v[0] for k, v in CODES.items()} \
            == {k: v[0] for k, v in JCODES.items()}

    def test_registered_op_types_accessor(self):
        types = registry.registered_op_types()
        assert "mul" in types and "fused_elementwise" in types
        assert types == sorted(types)
        assert types == registry.registered_ops()

    def test_infer_and_numerics_rules_cover_what_the_reference_covers(self):
        """On the ops the port registers, the port has an infer rule and
        a numerics rule exactly where the reference has one (126 and 108,
        fused_elementwise, the four paged decode ops, the conv-net ops
        and, since item 7c, the fake quantize pair included), and none
        for an op it lacks."""
        ops = set(registry.registered_op_types())
        ref_infer = set(jregistry.registered_infer_types()) & ops
        ref_num = set(jregistry.registered_numerics_types()) & ops
        assert set(registry.registered_infer_types()) == ref_infer
        assert set(registry.registered_numerics_types()) == ref_num
        assert (len(ref_infer), len(ref_num)) == (126, 108)
        assert registry.get_infer("no_such_op") is None
        assert registry.get_numerics("no_such_op") is None
        assert not registry.has_infer("rms_norm")   # none in the reference


# ---------------------------------------------------------------------------
# executor integration
# ---------------------------------------------------------------------------

CPU = tfluid.CPUPlace()


def _fc_program():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[8], dtype="float32")
        h = tfluid.layers.fc(x, size=4)
    return main, startup, h


class TestExecutorValidation:
    def test_strict_env_raises_before_lowering(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_VALIDATE", "strict")
        exe = tfluid.Executor(CPU)
        with pytest.raises(VerifyError):
            exe.run(_fc_program()[0],
                    feed={"x": np.zeros((2, 8), np.float32)},
                    fetch_list=["not_produced"], scope=tfluid.Scope())

    def test_strict_arg_overrides_env(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_VALIDATE", "0")
        exe = tfluid.Executor(CPU)
        with pytest.raises(VerifyError):
            exe.run(_fc_program()[0],
                    feed={"x": np.zeros((2, 8), np.float32)},
                    fetch_list=["not_produced"], validate="strict",
                    scope=tfluid.Scope())

    def test_default_mode_warns_not_raises(self, monkeypatch):
        # the corrupted fetch dies later, but the cheap validator must
        # have surfaced a VerifyWarning FIRST, not raised
        monkeypatch.delenv("PADDLE_TPU_VALIDATE", raising=False)
        exe = tfluid.Executor(CPU)
        with pytest.warns(VerifyWarning, match="dangling-fetch"):
            with pytest.raises(Exception):
                exe.run(_fc_program()[0],
                        feed={"x": np.zeros((2, 8), np.float32)},
                        fetch_list=["not_produced"], scope=tfluid.Scope())

    def test_off_validates_nothing(self):
        exe = tfluid.Executor(CPU)
        with warnings.catch_warnings():
            warnings.simplefilter("error", VerifyWarning)
            with pytest.raises(RuntimeError, match="startup program"):
                exe.run(_fc_program()[0],
                        feed={"x": np.zeros((2, 8), np.float32)},
                        fetch_list=["not_produced"], validate="0",
                        scope=tfluid.Scope())
        assert not exe._validated

    def test_cheap_level_matches_verify_program(self):
        """The executor's default check is ``verify_program(level=
        "cheap")`` with the run's feed names and fetch list."""
        main, _, _ = _fc_program()
        diags = verify_program(main, fetch_list=["not_produced"],
                               feed_names=["x"], level="cheap")
        assert _codes(errors(diags)) == ["dangling-fetch"]

    def test_validation_cached_per_program_version(self):
        main, startup, h = _fc_program()
        exe, scope = tfluid.Executor(CPU), tfluid.Scope()
        exe.run(startup, scope=scope)
        feed = {"x": np.zeros((2, 8), np.float32)}
        exe.run(main, feed=feed, fetch_list=[h], scope=scope)
        n = len(exe._validated)
        exe.run(main, feed=feed, fetch_list=[h], scope=scope)
        assert len(exe._validated) == n   # second run: cache hit
        main._bump()
        exe.run(main, feed=feed, fetch_list=[h], scope=scope)
        assert len(exe._validated) == n + 1

    def test_strict_passes_clean_program(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_VALIDATE", "strict")
        main, startup, h = _fc_program()
        exe, scope = tfluid.Executor(CPU), tfluid.Scope()
        exe.run(startup, scope=scope)
        out = exe.run(main, feed={"x": np.ones((2, 8), np.float32)},
                      fetch_list=[h], scope=scope)
        assert out[0].shape == (2, 4)

    def test_strict_error_equals_the_reference(self):
        """The VerifyError strict mode raises carries the reference's
        records for the same program and contract."""
        progs = _both(lambda f: f.layers.fc(
            f.layers.data(name="x", shape=[8], dtype="float32"),
            size=4).name)
        diags = {k: p[0].verify(fetch_list=["not_produced"],
                                feed_names=["x"], level="full")
                 for k, p in progs.items()}
        assert "dangling-fetch" in _codes(errors(diags["torch"]))
        assert _key(diags["torch"]) == _key(diags["jax"])
