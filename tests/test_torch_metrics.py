"""The host-side metric modules of the torch port (``metrics.py``,
``average.py``, ``evaluator.py``), copied from the JAX package's numpy
modules, against the JAX package's.

- Every class of ``metrics.py`` fed the same numpy values in both
  packages: the same ``eval()`` (to 1e-12, both are float64 numpy), the
  same ``get_config()``, and the same state after ``reset()``.
- ``WeightedAverage`` (tests/test_trainer.py's case).
- The signature sweep of tests/test_signature_parity.py, over the JAX
  package's own files: every public function and class of
  ``metrics.py``, ``average.py``, ``evaluator.py`` and the detection
  and extras layers takes every argument name the reference's does.
- The evaluators over programs: ``DetectionMAP`` accumulating the
  dataset mAP over two batches (tests/test_eval_ops.py's case),
  ``ChunkEvaluator`` and ``EditDistance``, each equal to the
  reference's.
"""
import ast
import inspect
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from torch_seq_common import make_feed, seqs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = (("jax", jfluid), ("port", tfluid))


def _both(fn):
    """``fn(package)`` in the JAX package and in the port."""
    return [fn(pkg) for _, pkg in PKGS]


def _rng(seed):
    return np.random.RandomState(seed)


METRIC_FEEDS = {
    "Precision": lambda r: [(r.rand(20), r.randint(0, 2, 20))
                            for _ in range(3)],
    "Recall": lambda r: [(r.rand(20), r.randint(0, 2, 20))
                         for _ in range(3)],
    "Accuracy": lambda r: [(np.asarray([r.rand()]), int(r.randint(1, 9)))
                           for _ in range(3)],
    "ChunkEvaluator": lambda r: [tuple(np.asarray([v]) for v in
                                       sorted(r.randint(0, 9, 3))[::-1])
                                 for _ in range(3)],
    "EditDistance": lambda r: [(r.randint(0, 3, 5).astype(np.float32),
                                np.asarray([5])) for _ in range(3)],
    "Auc": lambda r: [(r.rand(30, 2), r.randint(0, 2, 30))
                      for _ in range(3)],
    "DetectionMAP": lambda r: [(r.rand(10), r.randint(0, 2, 10))
                               for _ in range(3)],
}


@pytest.mark.parametrize("name", sorted(METRIC_FEEDS))
def test_metric_matches_reference(name):
    """The same updates into each package's metric: the same eval(),
    config and reset."""
    feeds = METRIC_FEEDS[name](_rng(sorted(METRIC_FEEDS).index(name)))
    ms = _both(lambda pkg: getattr(pkg.metrics, name)())
    for args in feeds:
        for m in ms:
            m.update(*args)
    got, want = ms[1].eval(), ms[0].eval()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    cfg = [m.get_config() for m in ms]
    assert set(cfg[0]) == set(cfg[1])
    for k in cfg[0]:
        np.testing.assert_array_equal(np.asarray(cfg[1][k], dtype=object),
                                      np.asarray(cfg[0][k], dtype=object))
    for m in ms:
        m.reset()
    if name in ("Precision", "Recall", "DetectionMAP", "Auc"):
        assert ms[1].eval() == ms[0].eval() == 0.0


def test_composite_metric_and_base():
    """CompositeMetric fans one update out to its metrics; MetricBase
    leaves update and eval to subclasses, as the reference's does."""
    r = _rng(9)
    preds, labels = r.rand(20), r.randint(0, 2, 20)
    outs = []
    for _, pkg in PKGS:
        comp = pkg.metrics.CompositeMetric()
        comp.add_metric(pkg.metrics.Precision())
        comp.add_metric(pkg.metrics.Recall())
        comp.update(preds, labels)
        outs.append(comp.eval())
        comp.reset()
        assert comp.eval() == [0.0, 0.0]
        with pytest.raises(NotImplementedError):
            pkg.metrics.MetricBase().eval()
    assert outs[0] == outs[1]
    assert tfluid.metrics.__all__ == jfluid.metrics.__all__


def test_weighted_average():
    """tests/test_trainer.py's case, in both packages."""
    for _, pkg in PKGS:
        wa = pkg.average.WeightedAverage()
        wa.add(1.0, 1.0)
        wa.add(3.0, 3.0)
        assert abs(wa.eval() - 2.5) < 1e-9
        wa.reset()
        with pytest.raises(ValueError):
            wa.eval()
        with pytest.raises(ValueError):
            wa.add(np.ones(2), 1.0)


# ---------------------------------------------------------------------------
# signatures (tests/test_signature_parity.py's sweep, over the JAX
# package's own files)
# ---------------------------------------------------------------------------
SIGNATURE_MODULES = [
    ("metrics.py", lambda: tfluid.metrics),
    ("average.py", lambda: tfluid.average),
    ("evaluator.py", lambda: tfluid.evaluator),
    ("layers/detection.py", lambda: tfluid.layers),
    ("layers/extras.py", lambda: tfluid.layers),
    ("models/faster_rcnn.py", lambda: tfluid.models.faster_rcnn),
]


def _public_defs(rel):
    tree = ast.parse(open(os.path.join(REPO, "paddle_tpu", rel)).read())
    for node in tree.body:
        if node.name.startswith("_") if hasattr(node, "name") else True:
            continue
        if isinstance(node, ast.FunctionDef):
            yield node.name, {a.arg for a in node.args.args}
        elif isinstance(node, ast.ClassDef):
            init = next((m for m in node.body if isinstance(m, ast.FunctionDef)
                         and m.name == "__init__"), None)
            args = {a.arg for a in init.args.args} - {"self"} if init \
                else set()
            yield node.name, args


@pytest.mark.parametrize("rel,ns", SIGNATURE_MODULES,
                         ids=[m[0] for m in SIGNATURE_MODULES])
def test_reference_signatures_are_accepted(rel, ns):
    """Every public function and class of the reference module has a
    callable of its name in the port that takes every argument name the
    reference's takes."""
    ns = ns()
    missing, bad = [], []
    for name, ref_args in _public_defs(rel):
        ours = getattr(ns, name, None)
        if ours is None or not callable(ours):
            missing.append(name)
            continue
        target = ours.__init__ if inspect.isclass(ours) else ours
        if target is object.__init__:
            params = set()
        else:
            params = set(inspect.signature(target).parameters)
        if ref_args - params:
            bad.append((name, sorted(ref_args - params)))
    assert not missing and not bad, (missing, bad)


# ---------------------------------------------------------------------------
# the evaluators over programs
# ---------------------------------------------------------------------------
def _evaluator_run(pkg, which, build, feeds):
    """Build ``build(pkg)`` -> (evaluator, fetch vars) in fresh programs,
    run each feed, update the evaluator with the fetches; return it."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ev, fetch = build(pkg)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    with pkg.scope_guard(scope):
        exe.run(startup)
        for feed in feeds:
            out = exe.run(main, feed=make_feed(which, feed),
                          fetch_list=[v.name for v in fetch])
            ev.update(*out)
        return ev, exe


def test_detection_map_dataset_accumulation():
    """evaluator.DetectionMAP accumulates TP/FP across batches and
    reports the DATASET mAP (0.25 here, where the mean of the two
    batches' mAPs is 0.5), equal to the reference's."""
    def build(pkg):
        dv = pkg.layers.data("det", shape=[-1, 4, 6], dtype="float32",
                             append_batch_size=False)
        lv = pkg.layers.data("lab", shape=[1], dtype="float32", lod_level=1)
        bv = pkg.layers.data("box", shape=[4], dtype="float32", lod_level=1)
        ev = pkg.evaluator.DetectionMAP(dv, lv, bv, class_num=2,
                                        background_label=0,
                                        overlap_threshold=0.5)
        return ev, ev.metrics

    det1 = np.zeros((1, 4, 6), np.float32)
    det1[0, 0] = [1, 0.9, 10, 10, 20, 20]
    det1[0, 1:] = [-1, 0, 0, 0, 0, 0]
    det2 = np.zeros((1, 4, 6), np.float32)
    det2[0, 0] = [1, 0.95, 200, 200, 220, 220]
    det2[0, 1:] = [-1, 0, 0, 0, 0, 0]
    feeds = [{"det": det, "lab": seqs([np.array([[1.0]], np.float32)],
                                      np.float32),
              "box": seqs([np.array([box], np.float32)], np.float32)}
             for det, box in ((det1, [10, 10, 20, 20]),
                              (det2, [30, 30, 50, 50]))]
    vals = []
    for which, pkg in PKGS:
        ev, exe = _evaluator_run(pkg, which, build, feeds)
        vals.append(ev.eval(exe))
        ev.reset(exe)
        assert ev.eval(exe) == 0.0
    assert abs(vals[1] - 0.25) < 1e-5
    assert abs(vals[1] - vals[0]) < 1e-6


def test_chunk_and_edit_distance_evaluators_match_the_reference():
    """ChunkEvaluator over chunk_eval's counts and EditDistance over
    edit_distance's distances, two batches each, equal to the
    reference's."""
    def chunk(pkg):
        inf = pkg.layers.data("inf", shape=[1], dtype="int64", lod_level=1)
        lab = pkg.layers.data("lab", shape=[1], dtype="int64", lod_level=1)
        ev = pkg.evaluator.ChunkEvaluator(inf, lab, chunk_scheme="IOB",
                                          num_chunk_types=2)
        return ev, [ev._num_infer, ev._num_label, ev._num_correct]

    def edit(pkg):
        hyp = pkg.layers.data("inf", shape=[1], dtype="int64", lod_level=1)
        ref = pkg.layers.data("lab", shape=[1], dtype="int64", lod_level=1)
        ev = pkg.evaluator.EditDistance(hyp, ref)
        return ev, [ev.distances]

    r = _rng(11)
    feeds = [{"inf": seqs([r.randint(0, 5, (n, 1)) for n in (4, 6, 3)],
                          np.int64),
              "lab": seqs([r.randint(0, 5, (n, 1)) for n in (4, 5, 3)],
                          np.int64)} for _ in range(2)]
    for build in (chunk, edit):
        vals = []
        for which, pkg in PKGS:
            ev, exe = _evaluator_run(pkg, which, build, feeds)
            vals.append(ev.eval(exe))
        np.testing.assert_allclose(vals[1], vals[0], rtol=1e-6)
