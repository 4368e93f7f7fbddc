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
    """What the port has not ported yet raises NotImplementedError naming
    its ROADMAP item; training itself runs, with the switches ported so
    far: AMP, the NaN guard, remat policies, the layer-stacked decoder
    (shard_pp) and the fused head loss (fused_head_chunk)."""
    infer, _, logits = _tiny_program()
    with pytest.raises(NotImplementedError, match="optimize"):
        ServingEngine(infer, ["tokens"], [logits], place=fluid.CPUPlace(),
                      optimize=True, auto_start=False)
    with pytest.raises(NotImplementedError):
        infer.optimize(fetch_list=[logits])

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
                        ("_remat_policy", "dots_saveable")):
        prog = main.clone()
        setattr(prog, attr, value)
        runs(prog, startup, loss)
    for kw in (dict(fused_head_chunk=64), dict(shard_pp=True),
               dict(shard_pp=True, fused_head_chunk=64, remat=False)):
        runs(*train_program(**kw))
    # still refused, by name
    for policy in ("recompute_norms", "save_conv_only"):
        prog = main.clone()
        prog._remat_policy = policy
        with pytest.raises(NotImplementedError, match=policy):
            exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        with pytest.raises(NotImplementedError, match=policy):
            fluid.memory_optimize(main.clone(), policy=policy)
    with pytest.raises(NotImplementedError, match="auto"):
        fluid.memory_optimize(main.clone(), policy="auto")
    for kw, match in ((dict(shard_pp=True, pp_schedule="1f1b"), "1f1b"),
                      (dict(shard_tp=True), "shard_tp")):
        with pytest.raises(NotImplementedError, match=match):
            train_program(**kw)
    with pytest.raises(NotImplementedError, match="MoE"):
        tokens = infer.global_block().var("tokens")
        build_llama(dataclasses.replace(LLAMA_TINY, moe_experts=4), tokens)
