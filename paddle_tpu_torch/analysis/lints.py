"""TPU performance lints — warnings, never errors (port of
``paddle_tpu/analysis/lints.py``, kept verbatim: the lints, their
thresholds and their messages are the reference's, so the two
packages' findings compare one for one; retuning them for a GPU would
be a lint of the port's own).

Two hazards that are invisible in the IR but expensive on the chip:

* **Tile padding.** The MXU consumes (8, 128)-tiled f32 operands (the
  sublane × lane registers; bf16 packs (16, 128)). A matmul operand
  whose last dim is not a multiple of 128, or whose second-minor dim
  is not a multiple of 8, is zero-padded up to the tile in VMEM — the
  FLOPs and bytes for the pad are real. A [batch, 1000] classifier
  head wastes 2.3% of its lanes; a [batch, 10] head wastes 92%.

* **Recompilation.** The executor caches ONE executable per
  (program-version, mode, fetch-set) key and jax re-specializes on
  feed shapes (core/executor.py): every distinct fed shape compiles a
  fresh XLA program. A data var with unknown dims beyond the batch dim
  (or used with per-batch ragged shapes) therefore thrashes the
  compile cache — the classic "first 50 steps take minutes" symptom.
"""
from .diagnostics import Diagnostic, WARNING
from .passes import Pass

__all__ = ["TpuMatmulPadPass", "RecompileHazardPass",
           "DecodeShapeHazardPass", "TpuHostileLayoutPass",
           "LANE_MULTIPLE", "SUBLANE_MULTIPLE"]

LANE_MULTIPLE = 128   # minor-most dim of an MXU operand tile
SUBLANE_MULTIPLE = 8  # second-minor dim (f32; bf16 packs 16)

_MATMUL_OPS = {"mul": ("X", "Y"), "matmul": ("X", "Y")}


def _pad_problems(shape):
    """Misalignment notes for one operand shape (known dims only)."""
    probs = []
    if shape is None or len(shape) < 2:
        return probs
    last, second = shape[-1], shape[-2]
    if last > 0 and last % LANE_MULTIPLE:
        probs.append(f"last dim {last} % {LANE_MULTIPLE} != 0")
    if second > 0 and second % SUBLANE_MULTIPLE:
        probs.append(f"second-minor dim {second} % "
                     f"{SUBLANE_MULTIPLE} != 0")
    return probs


class TpuMatmulPadPass(Pass):
    """Flags matmul/mul operands whose trailing dims are unaligned to
    the MXU tile."""

    name = "tpu-pad"

    def run(self, ctx):
        diags = []
        infer = ctx.infer
        for block in ctx.program.blocks:
            for i, op in enumerate(block.ops):
                slots = _MATMUL_OPS.get(op.type)
                if slots is None:
                    continue
                notes = []
                for slot in slots:
                    for n in op.inputs.get(slot, []):
                        info = infer.info(block.idx, n)
                        for p in _pad_problems(info.shape):
                            notes.append(f"{n}{list(info.shape)}: {p}")
                if notes:
                    diags.append(Diagnostic(
                        WARNING, "tpu-pad",
                        f"op {op.type!r} operands are unaligned to the "
                        f"MXU tile — {'; '.join(notes[:4])}",
                        op_idx=i, block_idx=block.idx,
                        hint=f"pad feature dims to multiples of "
                             f"{LANE_MULTIPLE} (last) / "
                             f"{SUBLANE_MULTIPLE} (second-minor); the "
                             "compiler zero-pads otherwise and the "
                             "padded FLOPs/bytes are real"))
        return diags


class DecodeShapeHazardPass(Pass):
    """Flags the autoregressive-decode anti-pattern: a ``concat``
    along a non-batch axis whose result length is statically unknown —
    the growing-sequence signature of a host-side decode loop
    (``seq = concat([seq, next_token])`` re-fed each step). Every
    iteration then feeds a shape XLA has never seen, so the loop
    compiles a fresh step executable PER TOKEN — the worst recompile
    hazard a serving program can carry, and invisible at any single
    call site. The fix is to keep the dynamism inside a fixed-shape
    buffer: the fused generation ops (llama_generate) or the paged-KV
    decode engine (serving.DecodeEngine), where positions move but
    traced shapes never do."""

    name = "decode-shape-hazard"

    def run(self, ctx):
        diags = []
        infer = ctx.infer
        for block in ctx.program.blocks:
            for i, op in enumerate(block.ops):
                if op.type != "concat":
                    continue
                axis = op.attr("axis")
                if axis in (None, 0):
                    continue          # batch-dim concat is not a loop
                names = op.inputs.get("X", [])
                unknown = []
                for n in names:
                    info = infer.info(block.idx, n)
                    shape = info.shape
                    if shape is None or len(shape) <= axis:
                        continue
                    if shape[axis] is None or shape[axis] < 0:
                        unknown.append(f"{n}{list(shape)}")
                if not unknown:
                    continue
                diags.append(Diagnostic(
                    WARNING, "decode-shape-hazard",
                    f"op 'concat' grows axis {axis} of an "
                    f"unknown-length sequence ({'; '.join(unknown[:3])})"
                    " — the growing-sequence decode pattern recompiles "
                    "a fresh executable every step",
                    op_idx=i, block_idx=block.idx,
                    hint="keep decode dynamism inside a fixed-shape "
                         "buffer: the fused llama_generate program or "
                         "the paged-KV serving.DecodeEngine compile "
                         "once and reuse the executable for every "
                         "step"))
        return diags


class TpuHostileLayoutPass(Pass):
    """Flags programs that run conv/pool ops in NCHW — the TPU-hostile
    layout (every NCHW conv pays an activation layout copy on both
    sides; measured as the #1 kernel/bytes bucket of the NCHW
    ResNet-50 step) — WHEN the layout analysis (analysis/layout.py)
    also finds a profitable conversion region, so the warning always
    comes with the estimated bytes saved and the knob that claims
    them. Programs where conversion would not pay (single isolated
    conv, frontier transposes outweigh the relayout savings) stay
    silent — the lint never recommends a rewrite the cost model would
    itself refuse."""

    name = "tpu-hostile-layout"

    def run(self, ctx):
        from .layout import analyze_layout
        program = ctx.program
        gb = program.global_block()
        hostile = [
            (i, op) for i, op in enumerate(gb.ops)
            if op.type in ("conv2d", "depthwise_conv2d", "pool2d")
            and op.attrs.get("data_format",
                             op.attrs.get("data_layout",
                                          "NCHW")) == "NCHW"]
        if not hostile:
            return []
        plan = analyze_layout(program, fetch_list=ctx.fetch_names,
                              infer_result=ctx.infer)
        selected = plan.selected_regions
        if not selected:
            return []
        i0 = hostile[0][0]
        n_ops = sum(len(r.op_idxs) for r in selected)
        return [Diagnostic(
            WARNING, "tpu-hostile-layout",
            f"{len(hostile)} conv/pool op(s) run in NCHW and the "
            f"layout analysis found {len(selected)} profitable NHWC "
            f"region(s) covering {n_ops} op(s): converting saves an "
            f"estimated {plan.bytes_delta:.3g} bytes of implicit "
            f"relayout copies per step at the price of "
            f"{plan.n_transposes} explicit frontier transpose(s)",
            op_idx=i0, block_idx=0,
            hint="opt in with Program.optimize(passes=('layout', "
                 "'fold', 'fuse', 'cse', 'dce')) or "
                 "PADDLE_TPU_OPTIMIZE=layout,fold,fuse,cse,dce; "
                 "tools/optcheck.py --passes layout gates the "
                 "conversion's numerics")]


class RecompileHazardPass(Pass):
    """Flags data variables whose shape can vary beyond the leading
    batch dim — each distinct fed shape compiles a fresh executable
    against the executor's compile cache."""

    name = "recompile-hazard"

    def run(self, ctx):
        diags = []
        for n, v in ctx.data_vars().items():
            if v.shape is None:
                diags.append(Diagnostic(
                    WARNING, "recompile-hazard",
                    f"data variable {n!r} has no declared shape — "
                    "every fed shape is a fresh XLA compile",
                    hint="declare the shape in layers.data"))
                continue
            unknown = [i for i, d in enumerate(v.shape) if d < 0]
            if [i for i in unknown if i != 0]:
                dims = ", ".join(f"dim {i}" for i in unknown if i != 0)
                diags.append(Diagnostic(
                    WARNING, "recompile-hazard",
                    f"data variable {n!r} {list(v.shape)} has unknown "
                    f"non-batch dims ({dims}) — each distinct fed "
                    "shape compiles a new step executable",
                    hint="pad/bucket to a fixed shape on the host "
                         "(DataFeeder bucketing, SequenceBatch) so "
                         "the executor's (program, feed-shape) cache "
                         "key stays hot"))
        return diags
