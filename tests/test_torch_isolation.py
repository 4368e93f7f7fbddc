"""The torch port stands alone: it never imports jax or the JAX package,
and its entry points run on the card unless the caller asks for the CPU.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.models.llama import LLAMA_TINY, build_llama
from paddle_tpu_torch.serving import ServingEngine

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu", "ml_dtypes")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "tile_sweep.py"]


def _forbidden(module):
    root = module.split(".")[0]
    return root in FORBIDDEN


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_import_loads_no_jax_or_reference_module():
    """In a fresh interpreter, with jax and paddle_tpu made unimportable,
    the whole port still imports — and no such module is loaded."""
    code = r"""
import sys, importlib.abc
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "paddle_tpu",
                                  "ml_dtypes"):
            raise ImportError(f"blocked import of {name}")
for m in [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu", "ml_dtypes")]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())
import paddle_tpu_torch
import paddle_tpu_torch.models.llama, paddle_tpu_torch.serving
import paddle_tpu_torch.weights, paddle_tpu_torch.ops.cuda_build
import paddle_tpu_torch.optimizer, paddle_tpu_torch.regularizer
import paddle_tpu_torch.clip, paddle_tpu_torch.core.backward
import paddle_tpu_torch.ops.optimizer_ops, paddle_tpu_torch.layers.tensor
import paddle_tpu_torch.ops.fused_loss, paddle_tpu_torch.core.amp_policy
import paddle_tpu_torch.transpiler.amp, paddle_tpu_torch.debugger
import paddle_tpu_torch.transpiler.memory_optimization
import paddle_tpu_torch.models.transformer, paddle_tpu_torch.models.zoo
import paddle_tpu_torch.models.mnist, paddle_tpu_torch.models.fit_a_line
import paddle_tpu_torch.ops.sequence, paddle_tpu_torch.layers.math_op_patch
import paddle_tpu_torch.ops.rnn, paddle_tpu_torch.core.sequence
import paddle_tpu_torch.lod_tensor, paddle_tpu_torch.nets
import paddle_tpu_torch.models.ctr, paddle_tpu_torch.models.word2vec
import paddle_tpu_torch.models.recommender
import paddle_tpu_torch.models.stacked_dynamic_lstm
import paddle_tpu_torch.layers.learning_rate_scheduler
import paddle_tpu_torch.layers.metric_op
import paddle_tpu_torch.layers.sequence_layers
import paddle_tpu_torch.analysis, paddle_tpu_torch.analysis.optimize
import paddle_tpu_torch.analysis.numcheck, paddle_tpu_torch.analysis.layout
import paddle_tpu_torch.analysis.lints, paddle_tpu_torch.analysis.verify
import paddle_tpu_torch.io, paddle_tpu_torch.io.aot
import paddle_tpu_torch.io.artifact_store, paddle_tpu_torch.io.device_loader
import paddle_tpu_torch.io.recordio, paddle_tpu_torch.io.batcher
import paddle_tpu_torch.resilience.checkpoint, paddle_tpu_torch.reader
import paddle_tpu_torch.reader.decorator, paddle_tpu_torch.trainer
import paddle_tpu_torch.inferencer, paddle_tpu_torch.data_feeder
import paddle_tpu_torch.layers.io
import paddle_tpu_torch.ops.moe, paddle_tpu_torch.models.llama_import
import paddle_tpu_torch.layers.transformer
import paddle_tpu_torch.ops.transformer_ops
import paddle_tpu_torch.serving.decode_engine, paddle_tpu_torch.serving.kv_pages
import paddle_tpu_torch.serving.sched, paddle_tpu_torch.serving.overload
import paddle_tpu_torch.ops.control_flow, paddle_tpu_torch.ops.crf_ctc
import paddle_tpu_torch.ops.eval_ops, paddle_tpu_torch.layers.control_flow
import paddle_tpu_torch.contrib, paddle_tpu_torch.contrib.decoder
import paddle_tpu_torch.models.machine_translation
import paddle_tpu_torch.models.label_semantic_roles
import paddle_tpu_torch.models.ocr_recognition
import paddle_tpu_torch.profiler, paddle_tpu_torch.concurrency
import paddle_tpu_torch.recordio_writer, paddle_tpu_torch.default_scope_funcs
import paddle_tpu_torch.utils.plot, paddle_tpu_torch.analysis.cost
import paddle_tpu_torch.contrib.memory_usage_calc
import paddle_tpu_torch.dataset.flowers, paddle_tpu_torch.dataset.image
import paddle_tpu_torch.dataset.voc2012, paddle_tpu_torch.dataset.synthetic
import paddle_tpu_torch.cluster, paddle_tpu_torch.cluster.train_fabric
import paddle_tpu_torch.cluster.deploy, paddle_tpu_torch.cluster.membership
import paddle_tpu_torch.analysis.racecheck
import paddle_tpu_torch.analysis.protocheck
import paddle_tpu_torch.analysis.suppress
assert "matplotlib" not in sys.modules and "cv2" not in sys.modules
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu",
                                    "ml_dtypes"))
print(bad)
sys.exit(1 if bad else 0)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stdout + out.stderr


def _names_native_dir(value):
    """Whether a string constant is a path into the repo's ``native/``."""
    return value.rstrip("/") == "native" or value.startswith("native/") \
        or "/native/" in value or value.endswith("/native")


def test_native_sources_are_the_ports_own(tmp_path):
    """F26: the port builds its native libraries from its own copies in
    ``paddle_tpu_torch/csrc/`` — ``recordio.cc`` byte for byte the
    reference's ``native/recordio.cc``, so files cross both ways — and
    no port module names the repo's ``native/`` as a build source. The
    package copied alone, with no ``native/`` beside it, builds its
    recordio and batcher and reads back what it wrote."""
    import shutil
    from paddle_tpu_torch.io import recordio
    assert Path(recordio._CSRC_DIR) == PORT / "csrc"
    assert (PORT / "csrc" / "recordio.cc").read_bytes() == \
        (REPO / "native" / "recordio.cc").read_bytes()
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    _names_native_dir(node.value):
                bad.append(f"{path.name}:{node.lineno}")
    assert not bad, bad
    shutil.copytree(PORT, tmp_path / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = r"""
import numpy as np
from paddle_tpu_torch.io import batcher, recordio
recordio.write_arrays("f.rio", [(np.arange(3) + i,) for i in range(4)])
got = [int(a[0][0]) for a in recordio.array_scanner("f.rio")]
assert got == [0, 1, 2, 3], got
batcher.write_fixed("b.rio", [(np.full(2, i, np.float32),)
                              for i in range(4)], [((2,), np.float32)])
rows = list(batcher.FixedBatcher(["b.rio"], [((2,), np.float32)],
                                 batch_size=2, shuffle_buf=0))
got = sorted(float(r[0][k, 0]) for r in rows for k in range(2))
assert got == [0.0, 1.0, 2.0, 3.0], got
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode == 0, out.stdout + out.stderr


WORKERS = ("net_worker", "proc_worker", "train_worker")


def test_worker_entry_points_run_with_jax_blocked():
    """The three ``python -m paddle_tpu_torch.cluster.*_worker`` entry
    points answer ``--help`` in a fresh interpreter where jax and the
    JAX package cannot be imported, and load neither."""
    code = r"""
import runpy, sys, importlib.abc
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "paddle_tpu",
                                  "ml_dtypes"):
            raise ImportError(f"blocked import of {name}")
sys.meta_path.insert(0, Block())
for worker in %r:
    sys.argv = [worker, "--help"]
    try:
        runpy.run_module("paddle_tpu_torch.cluster." + worker,
                         run_name="__main__", alter_sys=True)
    except SystemExit as e:
        assert e.code in (0, None), (worker, e.code)
    else:
        raise AssertionError(worker + " --help did not exit")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu",
                                    "ml_dtypes"))
sys.exit(1 if bad else 0)
""" % (WORKERS,)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stdout + out.stderr
    for worker in WORKERS:
        assert f"--cpu" in out.stdout and "usage:" in out.stdout


@pytest.mark.parametrize("worker", WORKERS)
def test_worker_without_cuda_exits_naming_the_reason(worker, tmp_path):
    """A worker asked for the card on a machine without CUDA exits
    non-zero, naming the reason; it does not fall back to the host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default place works")
    argv = [sys.executable, "-m", f"paddle_tpu_torch.cluster.{worker}"]
    if worker != "train_worker":
        argv += ["--dir", str(tmp_path)]
    out = subprocess.run(argv + ["--port", "0"] if worker != "proc_worker"
                         else argv, cwd=str(REPO), capture_output=True,
                         text=True, timeout=120, stdin=subprocess.DEVNULL,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 2, out.stdout + out.stderr
    assert "no CUDA device" in out.stderr and "--cpu" in out.stderr


def _tiny_program():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                                   dtype="int64", append_batch_size=False)
        logits, _ = build_llama(LLAMA_TINY, tokens)
    return main.clone(for_test=True), startup, logits


def test_executor_defaults_to_the_card():
    if torch.cuda.is_available():
        assert fluid.Executor().device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fluid.Executor()
    assert fluid.Executor(fluid.CPUPlace()).device == torch.device("cpu")


def test_serving_engine_defaults_to_the_card():
    infer, _, logits = _tiny_program()
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default place works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(infer, ["tokens"], [logits], auto_start=False)


def test_tpu_place_is_the_card():
    assert fluid.TPUPlace is fluid.CUDAPlace
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fluid.TPUPlace().device


def test_later_slices_refuse_loudly():
    """Every slice is lifted: nothing refuses by ROADMAP item any more
    (item 8, the last, brought the cluster and the source checkers);
    training itself runs, with the switches: AMP, the NaN guard, remat policies, the layer-stacked decoder
    (shard_pp), the fused head loss (fused_head_chunk), (item 1b) the
    op library's layers, math_op_patch and the LR schedulers, (item 2)
    the optimize rewrite — the serving engine's default — and the
    verifier, and (item 7d) the cost model and the supporting
    modules."""
    infer, _, logits = _tiny_program()
    # item 2 lifted: the engine optimizes a clone by default, and
    # Program.optimize / Program.verify run
    engine = ServingEngine(infer, ["tokens"], [logits],
                           place=fluid.CPUPlace(), auto_start=False)
    assert engine.optimize_report is not None
    assert engine.program is not infer
    assert engine.stats()["optimize"]["passes"] == ["fold", "fuse", "cse",
                                                    "dce"]
    report = infer.clone(for_test=True).optimize(fetch_list=[logits])
    assert report.counts() == engine.optimize_report.counts()
    assert not fluid.analysis.errors(infer.verify(fetch_list=[logits]))
    # item 7d lifted: the cost model (collect_cost, the analysis
    # names); item 8 lifted: the source checkers
    costed = infer.clone(for_test=True).optimize(fetch_list=[logits],
                                                 collect_cost=True)
    assert costed.cost_deltas is not None
    for name in ("cost", "program_cost", "recommend_remat_policy"):
        assert getattr(fluid.analysis, name) is not None
    for name in ("racecheck", "protocheck"):
        assert getattr(fluid.analysis, name).__name__ == \
            f"paddle_tpu_torch.analysis.{name}"

    def train_program(**kw):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                                       dtype="int64", append_batch_size=False)
            _, loss = build_llama(LLAMA_TINY, tokens, tokens, **kw)
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return main, startup, loss

    exe = fluid.Executor(fluid.CPUPlace())
    feed = {"tokens": np.zeros((1, 8), np.int64)}

    def runs(main, startup, loss):
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        assert np.isfinite(out[0]).all()
        return scope

    main, startup, loss = train_program()
    scope = runs(main, startup, loss)
    # lifted: each switch's step runs
    for attr, value in (("_amp", "O1"), ("_amp", "O2"), ("_nan_guard", True),
                        ("_remat_policy", "nothing_saveable"),
                        ("_remat_policy", "dots_saveable"),
                        ("_remat_policy", "recompute_norms"),
                        ("_remat_policy", "save_conv_only")):
        prog = main.clone()
        setattr(prog, attr, value)
        runs(prog, startup, loss)
    for kw in (dict(fused_head_chunk=64), dict(shard_pp=True),
               dict(shard_pp=True, fused_head_chunk=64, remat=False)):
        runs(*train_program(**kw))
    # item 5 lifted: the conv-net remat policies are taken
    for policy in ("recompute_norms", "save_conv_only"):
        assert fluid.memory_optimize(main.clone(), policy=policy) \
            ._remat_policy == policy
    # still refused, by name
    for policy in ("save_only_these_names", "save_from_both_policies"):
        prog = main.clone()
        prog._remat_policy = policy
        with pytest.raises(NotImplementedError, match=policy):
            exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        with pytest.raises(NotImplementedError, match=policy):
            fluid.memory_optimize(main.clone(), policy=policy)
    # item 7d lifted: "auto" takes the cost model's recommendation
    assert fluid.memory_optimize(main.clone(), policy="auto") \
        ._remat_policy == fluid.analysis.recommend_remat_policy(main)
    # item 6b lifted: the 1F1B program and the sequence split build and
    # run on one device
    for kw in (dict(shard_pp=True, pp_schedule="1f1b"),
               dict(shard_sp=True)):
        runs(*train_program(**kw))
    # item 6a lifted: the mesh knobs and MoE build and run on one device
    runs(*train_program(shard_dp=True, shard_tp=True))
    with fluid.unique_name.guard(), fluid.program_guard(fluid.Program(),
                                                        fluid.Program()):
        tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                                   dtype="int64", append_batch_size=False)
        _, moe_loss = build_llama(
            dataclasses.replace(LLAMA_TINY, moe_experts=4), tokens, tokens)
    assert moe_loss is not None
    # item 1b lifted: a step built from the op library's layers, the
    # operator sugar and a scheduled rate runs
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.dropout(fluid.layers.layer_norm(
            fluid.layers.fc(x, size=8, act="gelu")), 0.1)
        loss = fluid.layers.reduce_mean(h * h) + 1.0
        fluid.optimizer.Adam(fluid.layers.noam_decay(8, 4)).minimize(loss)
    exe.run(startup, scope=scope)
    out = exe.run(main, feed={"x": np.ones((2, 8), np.float32)},
                  fetch_list=[loss], scope=scope)
    assert np.isfinite(out[0]).all()
    # item 7c lifted: a detection program (anchors, proposals, the
    # extras' ops) runs; item 7d lifted: the module-level names
    det_main, det_start = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(det_main,
                                                        det_start):
        img = fluid.layers.data(name="img", shape=[3, 8, 8],
                                dtype="float32")
        feat = fluid.layers.conv2d(img, num_filters=4, filter_size=3,
                                   padding=1)
        boxes, _ = fluid.layers.prior_box(feat, img, min_sizes=[2.0],
                                          aspect_ratios=[2.0], flip=True)
        diff = fluid.layers.minus(feat, feat)
    exe.run(det_start, scope=scope)
    out = exe.run(det_main, feed={"img": np.ones((2, 3, 8, 8), np.float32)},
                  fetch_list=[boxes, diff], scope=scope)
    assert out[0].shape == (8 * 8 * 3, 4) and not out[1].any()
    for name in ("profiler", "dataset", "default_scope_funcs",
                 "recordio_writer", "concurrency"):
        assert getattr(fluid, name).__name__ == f"paddle_tpu_torch.{name}"
    assert str(det_main) == fluid.debugger.program_to_code(det_main)
    assert not hasattr(fluid, "WAITING") and not hasattr(fluid, "waiting")
    assert fluid.cluster.__name__ == "paddle_tpu_torch.cluster"
    # item 7a lifted: a sequence feed, the sequence layers and the
    # recurrent ops run
    seq_main, seq_start = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(seq_main,
                                                        seq_start):
        w = fluid.layers.data(name="w", shape=[1], dtype="int64",
                              lod_level=1)
        proj = fluid.layers.fc(fluid.layers.embedding(w, size=[10, 4]),
                               size=8)
        h, _ = fluid.layers.dynamic_lstm(proj, size=8)
        pooled = fluid.layers.sequence_pool(h, "max")
    exe.run(seq_start, scope=scope)
    out = exe.run(seq_main, feed={"w": fluid.to_sequence_batch(
        [[[1], [2]], [[3]]])}, fetch_list=[pooled], scope=scope)
    assert out[0].shape == (2, 2) and np.isfinite(out[0]).all()
    from paddle_tpu_torch.models import zoo
    # item 5 lifted: the conv nets build; item 7a: the sequence models;
    # item 7b: ocr_recognition and machine_translation; item 7c:
    # faster_rcnn
    assert zoo.build_zoo_program("resnet").fetch_list
    assert zoo.build_zoo_program("stacked_dynamic_lstm").fetch_list
    assert zoo.build_zoo_program("ocr_recognition").fetch_list
    assert zoo.build_zoo_program("machine_translation").fetch_list
    assert zoo.build_zoo_program("faster_rcnn").fetch_list
    # items 4a (the fused generator) and 4b (the paged decode engine)
    # lifted: the generator builders, the paged programs, their layers,
    # the weight tools and the decode-serving names resolve; item 6b
    # lifted: the pipeline schedules and ring attention
    from paddle_tpu_torch.models import llama as tllama
    for name in ("build_llama_generator", "build_llama_spec_generator",
                 "quantize_generator_weights", "stack_generator_weights",
                 "copy_weights_as_draft", "save_decode_model",
                 "load_decode_model", "build_llama_paged_programs",
                 "PagedDecodePrograms"):
        assert callable(getattr(tllama, name))
    for name in ("llama_generate", "llama_spec_generate",
                 "llama_paged_prefill", "llama_paged_prefill_chunk",
                 "llama_paged_decode", "llama_paged_spec_step"):
        assert callable(getattr(fluid.layers, name))
    for name in ("DecodeEngine", "DecodeConfig", "DecodeRequest",
                 "PageAllocator", "PagesExhaustedError", "SLOClass",
                 "FIFOScheduler", "SLOScheduler", "get_scheduler",
                 "priority_rank", "AdmissionController",
                 "BrownoutController", "RetryBudget",
                 "RetryBudgetExhaustedError"):
        assert callable(getattr(fluid.serving, name))
    assert fluid.serving.PRIORITIES["interactive"] == 0
    for fn in (fluid.parallel.gpipe, fluid.parallel.pipeline.one_f_one_b,
               fluid.parallel.ring_attention.ring_attention,
               fluid.parallel.ring_attention.ring_attention_sharded,
               fluid.parallel.ring_attention._merge,
               fluid.layers.llama_stack_1f1b_loss):
        assert callable(fn)
    # item 3 (IO, persistables and Inferencer) lifted: the load op runs;
    # still refused: a JAX AOT artifact; item 7a lifted: sequence readers
    # and feeders; item 8 lifted: replica pools of either engine and
    # remote replicas (tests/test_torch_cluster.py runs them)
    for name in ("serve_cluster", "serve_remotes", "Router", "ReplicaPool",
                 "ProcessReplica", "RemoteReplica", "ReplicaServer",
                 "TrainCoordinator", "DeploymentManager"):
        assert callable(getattr(fluid.cluster, name))
    with fluid.unique_name.guard(), fluid.program_guard(fluid.Program(),
                                                        fluid.Program()):
        reader = fluid.layers.py_reader(capacity=2, shapes=[[-1, 1]],
                                        dtypes=["int64"], lod_levels=[1])
        out = fluid.layers.read_file(reader)      # one var: not a list
        assert out.lod_level == 1
    feed = fluid.DataFeeder(["w"], program=seq_main).feed([([1, 2],), ([3],)])
    assert isinstance(feed["w"], fluid.SequenceBatch)
    import tempfile
    from paddle_tpu_torch.io import load_compiled_predictor
    with tempfile.TemporaryDirectory() as d:
        open(os.path.join(d, "__compiled__.stablehlo"), "wb").close()
        with pytest.raises(ValueError, match="JAX export"):
            load_compiled_predictor(d, device="cpu")


def test_io_entry_points_default_to_the_card(tmp_path):
    """Trainer, Inferencer, from_saved_model, CompiledPredictor and
    DeviceLoader run on the card unless given the CPU: here, without
    CUDA, each raises instead of falling back to the host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default place works")
    infer, startup, logits = _tiny_program()
    d = str(tmp_path / "m")
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(d, ["tokens"], [logits], exe,
                                      main_program=infer)

    def train_func():
        x = fluid.layers.data("x", shape=[2])
        return fluid.layers.mean(fluid.layers.fc(x, size=1))

    cuda = "CUDA is not available"
    with pytest.raises(RuntimeError, match=cuda):
        fluid.Trainer(train_func, lambda: fluid.optimizer.SGD(0.1))
    with pytest.raises(RuntimeError, match=cuda):
        fluid.Inferencer.from_inference_model(d)
    with pytest.raises(RuntimeError, match=cuda):
        ServingEngine.from_saved_model(d, auto_start=False)
    with pytest.raises(RuntimeError, match=cuda):
        fluid.io.load_compiled_predictor(d)
    with pytest.raises(RuntimeError, match=cuda):
        fluid.io.DeviceLoader(lambda: iter([]))


def test_f7_names_resolve(monkeypatch):
    """F7: the reference's top-level ``force_cpu`` and ``release_memory``
    and the ported model modules resolve. ``force_cpu()`` makes the host
    the default place of the process's entry points (an explicit place
    still wins); ``release_memory`` returns the program, as the
    reference's."""
    from paddle_tpu_torch.core import executor
    monkeypatch.setattr(executor, "_FORCED_CPU", False)
    import paddle_tpu_torch.models as models
    for name in ("llama", "llama_import", "transformer", "mnist",
                 "fit_a_line", "zoo"):
        assert getattr(models, name).__name__ == \
            f"paddle_tpu_torch.models.{name}"
    main = fluid.Program()
    assert fluid.release_memory(main) is main
    assert fluid.transpiler.release_memory(main) is main
    fluid.force_cpu()
    assert fluid.Executor().device == torch.device("cpu")
    assert executor.default_place().device == torch.device("cpu")
    from paddle_tpu_torch.analysis.optimize import default_fold_device
    assert default_fold_device() == torch.device("cpu")
    infer, _, logits = _tiny_program()
    engine = ServingEngine(infer, ["tokens"], [logits], auto_start=False)
    assert engine.exe.device == torch.device("cpu")
    engine.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fluid.Executor(fluid.CUDAPlace(0))


def _reference_modules():
    """Every module of the JAX package that has a port file, by dotted
    name under the package (``""`` the package itself)."""
    names = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT)
        if not (REPO / "paddle_tpu" / rel).exists():
            continue
        parts = list(rel.with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_every_reference_module_has_a_port_file():
    """Every module of the JAX package has its port file, but the Pallas
    kernels' module, whose port is ``ops/flash_attention.py``."""
    ref = REPO / "paddle_tpu"
    lacking = sorted(str(p.relative_to(ref)) for p in ref.rglob("*.py")
                     if not (PORT / p.relative_to(ref)).exists())
    assert lacking == ["ops/pallas_attention.py"]
    assert (PORT / "ops" / "flash_attention.py").exists()


@pytest.mark.parametrize("mod", _reference_modules(),
                         ids=lambda m: m or "paddle_tpu")
def test_reference_names_resolve_or_refuse(mod):
    """F7's scan, with every slice lifted: every public name of a
    reference module that has a port file (its ``__all__``, else the
    names the module defines itself, or, for the package, every public
    attribute) is a value in the port — nothing raises
    NotImplementedError by ROADMAP item, nothing a bare AttributeError.
    A subpackage also has every public attribute that is not a module
    checked beside its ``__all__`` (F16: ``layers`` star-imports
    ``extras``, whose names its ``__all__`` leaves out)."""
    import importlib
    import types
    ref = importlib.import_module("paddle_tpu" + (f".{mod}" if mod else ""))
    port = importlib.import_module(
        "paddle_tpu_torch" + (f".{mod}" if mod else ""))
    if hasattr(ref, "__all__"):
        names = list(ref.__all__)
        if hasattr(ref, "__path__"):
            names += [n for n in dir(ref) if not n.startswith("_")
                      and not isinstance(getattr(ref, n), types.ModuleType)]
    elif not mod:
        names = [n for n in dir(ref) if not n.startswith("_")]
    else:
        names = [n for n, v in vars(ref).items() if not n.startswith("_")
                 and not isinstance(v, types.ModuleType)
                 and getattr(v, "__module__", ref.__name__) == ref.__name__]
    missing = [name for name in names if not hasattr(port, name)]
    assert not missing, f"{port.__name__} lacks {missing}"
