"""AOT inference export — the serving path without the framework.

Port of ``paddle_tpu/io/aot.py``. The reference ships a C++ inference
library so a trained model serves without the training stack:
``PaddlePredictor`` / ``CreatePaddlePredictor`` (reference
paddle/fluid/inference/api/paddle_inference_api.h:90,:177) load a
persisted ProgramDesc + params and run them through the C++ executor.

Here ``save_inference_model`` lowers the pruned inference program once
and exports it through ``torch.export`` (non-strict) to one graph of
aten operators and the flash-attention forward K1, which is the custom
operator ``torch.ops.paddle_tpu_torch.flash_fwd`` (ops/flash_attention.py:
on the card it launches the hand-written kernel). Every feed whose shape
starts with -1 shares one symbolic batch dimension (``Dim("b")``), so
one artifact serves any batch size, 1 included: the example batch is 2,
because ``torch.export`` specializes a dimension whose example is 1.
The other -1 dimensions are ``Dim.AUTO``: dynamic where the program
allows it, specialized to the example where it does not (a width that
fixes a weight's shape).

A sequence feed (``lod_level > 0``) enters the graph as its padded
decomposition — data [b, t..., *feature], lengths [b] (or [b, s] at
level 2, plus outer counts [b]) — which the exported step reassembles
into a SequenceBatch, so the artifact takes plain tensors. Each padded
axis is its own dimension, symbolic as the reference's are, so one
artifact serves any padded length. The step is lowered for export
(``lower_program(for_export=True)``): the recurrences (``lstm``,
``gru``, ``crf_decoding``, the ``scan`` of StaticRNN / DynamicRNN) run
torch's ``scan`` over the padded axis, an unbounded ``while`` is torch's
``while_loop`` and ``if_else`` is ``torch.cond``, as the reference
traces ``lax.scan``, ``lax.while_loop`` and ``lax.cond``; a bounded
``while`` never read back, and unrolls. What those ops do not take (a
carry whose shape or dtype changes, a tensor array grown in the carry,
branches whose outputs differ) raises naming F14 and the cause
(ROADMAP.md §3), so ``save_inference_model`` warns "AOT export skipped"
and the JSON program serves. ``linear_chain_crf``, ``warpctc``,
``chunk_eval`` and ``edit_distance`` run their recurrences the same way,
so no op fixes a padded length any more; one that did (a loop over the
axis on the host) would raise naming it. An artifact whose meta holds
``fixed_seq_len`` from an earlier export, which fixed it, is still
served at that length only and refuses any other by name. A fetched
sequence comes back as its padded data.

``CompiledPredictor`` loads that graph and runs it: no Program IR, no op
registry, no lowering. It imports ``torch.export``, numpy and the
operator's registration — nothing else of the package.

Artifact layout (inside the save_inference_model dirname)::

    __compiled__.pt2         the torch.export program (parameters are
                             its inputs, not its constants)
    __compiled_meta__.json   feed names/shapes/dtypes, fetch names,
                             param order and dtypes, the export device
    params.npz               shared with the JSON-program path

A directory the JAX package exported carries ``__compiled__.stablehlo``
instead: ``load_compiled_predictor`` refuses it by name, and its JSON
program still loads through ``load_inference_model``.
"""
import json
import os
import threading

import numpy as np
import torch

__all__ = ["export_compiled", "CompiledPredictor",
           "load_compiled_predictor"]

_ARTIFACT = "__compiled__.pt2"
_META = "__compiled_meta__.json"
_JAX_ARTIFACT = "__compiled__.stablehlo"
# example size of the symbolic batch (torch.export specializes 0 and 1)
_EXAMPLE_BATCH = 2
# torch.export traces under process-wide modes: one export at a time
_EXPORT_LOCK = threading.Lock()


def _warn_if_stochastic(gb):
    """The exported graph bakes in one fixed seed and step (the executor
    advances its step per run; an exported graph has no step counter).
    Deterministic inference — dropout is identity in test mode,
    generation at temperature 0 is argmax — is unaffected; warn loudly
    for anything that still samples."""
    from ..core.registry import draws_rng
    noisy = sorted({op.type for op in gb.ops if draws_rng(op)})
    if noisy:
        import warnings
        warnings.warn(
            f"AOT export: ops {noisy} sample from the rng, but the "
            "exported graph uses one FIXED seed — every run returns the "
            "same draw, and it will differ from the executor's per-step "
            "stream. Serve stochastic programs through the executor, or "
            "export at temperature 0.")


class _StepModule(torch.nn.Module):
    """The test-mode step of a lowered program as ``forward(params,
    feeds) -> tuple(fetches)``, both lists in a fixed name order — the
    function ``torch.export`` traces (here and in the artifact store).
    With ``with_state`` it returns ``(tuple(fetches), new_state)``, the
    dict of persistables the step writes, for the caller to put back in
    its scope. The seed and step are fixed at 0: only a step that draws
    no random numbers gives the executor's answers (the artifact store
    sends any other down the eager path)."""

    def __init__(self, step_fn, param_names, feed_names, device,
                 with_state=False):
        super().__init__()
        self.step_fn = step_fn
        self.param_names = list(param_names)
        self.feed_names = list(feed_names)
        self.device = device
        self.with_state = with_state

    def forward(self, params, feeds):
        state = dict(zip(self.param_names, params))
        feed = dict(zip(self.feed_names, feeds))
        new_state, fetches = self.step_fn(state, feed, self.device, 0, 0)
        if self.with_state:
            return tuple(fetches), dict(new_state)
        return tuple(fetches)


def export_step(step_fn, param_names, params, feed_names, feeds, device,
                dynamic_shapes=None, with_state=False):
    """``torch.export`` (non-strict) of one test-mode step on example
    ``params`` and ``feeds`` (lists of tensors on ``device``), under
    ``torch.no_grad()``. Returns the ExportedProgram."""
    mod = _StepModule(step_fn, param_names, feed_names, device, with_state)
    with _EXPORT_LOCK, torch.no_grad():
        return torch.export.export(
            mod, (list(params), list(feeds)),
            dynamic_shapes=dynamic_shapes, strict=False)


def save_exported(ep):
    """An ExportedProgram as bytes (``torch.export.save``), without its
    example inputs: ``torch.export.save`` writes them too, and here they
    are the parameters (the whole model again, in every artifact)."""
    import io as _io
    ep.example_inputs = None
    buf = _io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def load_exported(blob):
    """The callable graph module of an exported program's bytes."""
    import io as _io
    return torch.export.load(_io.BytesIO(blob)).module()


# example sizes of a sequence feed's padded axes (level 1's time axis;
# level 2's subsequence and time axes): distinct from the batch's and
# the other -1 dims' so no two dims share an example size
_EXAMPLE_SEQ = (7, 3)
# the suffixes of a sequence feed's lengths and outer counts in the
# exported step's flat feed list
_LENGTHS, _COUNTS = "@lengths", "@outer_counts"


def _sequence_step(step_fn, specs):
    """``step_fn`` over the flat feed names of :func:`export_compiled`:
    reassembles each sequence feed's SequenceBatch from its data,
    lengths and counts, and returns a fetched sequence's padded data."""
    from ..core.sequence import SequenceBatch

    def step(state, feed, device, seed, step_no):
        feed = dict(feed)
        for spec in specs:
            n = spec["name"]
            if spec["lod_level"]:
                feed[n] = SequenceBatch(feed.pop(n), feed.pop(n + _LENGTHS),
                                        feed.pop(n + _COUNTS, None))
        new_state, fetches = step_fn(state, feed, device, seed, step_no)
        return new_state, [f.data if isinstance(f, SequenceBatch) else f
                           for f in fetches]
    return step


def _specialized_axes(ep, n_params, flat_names, specs):
    """{feed name: [size]} of each sequence feed whose padded axes the
    export fixed to their example sizes (the placeholder's dims there
    are ints, not symbols)."""
    user = ep.graph_signature.user_inputs
    nodes = {nd.name: nd for nd in ep.graph.nodes if nd.op == "placeholder"}
    fixed = {}
    for spec in specs:
        lod = spec["lod_level"]
        if not lod:
            continue
        node = nodes.get(user[n_params + flat_names.index(spec["name"])])
        shape = node.meta["val"].shape if node is not None else ()
        sizes = [shape[1 + k] for k in range(lod)] if shape else []
        if sizes and all(isinstance(d, int) or d.node.expr.is_number
                         for d in sizes):
            fixed[spec["name"]] = [int(d) for d in sizes]
    return fixed


def export_compiled(dirname, program, feed_names, fetch_names, scope,
                    device, batch_symbol="b", param_names=None):
    """Lower ``program`` (already pruned to the inference slice) to its
    test-mode step of (params, feeds), export it through
    ``torch.export`` on ``device`` with one symbolic leading batch dim
    shared by every feed whose shape starts with -1, and write it into
    ``dirname``. Returns the meta dict.

    A sequence feed enters as its padded decomposition, each padded axis
    a dimension of its own. The step is lowered for export
    (``lower_program(for_export=True)``): the recurrences and the
    control flow become torch's higher-order ops, so the padded axes
    stay symbols and one artifact serves any padded length. An op that
    would fix a feed's padded axis (a loop over it on the host, F14)
    raises ValueError naming it.
    A control-flow form no higher-order op takes (a carry whose shape or
    dtype changes, a tensor array grown in the carry, branches whose
    outputs differ) raises ValueError naming F14 and its cause.

    Raises whatever ``torch.export`` raises if the program is not
    exportable (a value read back to the host, a data-dependent shape)
    — callers that want the JSON-program fallback catch and continue."""
    from ..core.framework import collect_op_input_names
    from ..core.lowering import lower_program

    gb = program.global_block()
    _warn_if_stochastic(gb)
    lowered = step_fn = lower_program(program, list(fetch_names), "test",
                                      for_export=True)
    if param_names is None:
        # persistables the ops actually read (what save_inference_model
        # writes to params.npz)
        referenced = set()
        for op in gb.ops:
            collect_op_input_names(op, referenced)
        param_names = sorted(
            v.name for v in program.list_vars()
            if v.persistable and v.name in referenced
            and scope.find_var(v.name) is not None)
    from .. import weights
    params = []
    for n in param_names:
        val = scope.find_var(n)
        if not isinstance(val, torch.Tensor):
            val = weights.array_to_tensor(val, device,
                                          dtype=gb.var(n).dtype)
        params.append(val.to(device))

    feed_specs = []
    for n in feed_names:
        v = gb.var(n)
        lod = int(getattr(v, "lod_level", 0) or 0)
        if lod > 2:
            raise ValueError(
                f"feed {n!r}: lod_level {lod} > 2 is unsupported "
                "(SequenceBatch nests at most 2 levels)")
        feed_specs.append({"name": n, "shape": [int(s) for s in v.shape],
                           "dtype": v.dtype, "lod_level": lod})
    # each padded axis's example size is one no parameter has and no
    # other axis takes: torch's higher-order ops fakify the tensors their
    # bodies close over anew, and a size shared with one of those would
    # tie the axis to that constant
    taken = {int(d) for p in params for d in p.shape}
    taken |= {_EXAMPLE_BATCH, 2 * _EXAMPLE_BATCH + 1}

    def free(size):
        while size in taken:
            size += 1
        taken.add(size)
        return size

    axes = {spec["name"]: [free(e) for e in
                           _EXAMPLE_SEQ[:spec["lod_level"]][::-1]]
            for spec in feed_specs if spec["lod_level"]}
    if axes:
        step_fn = _sequence_step(step_fn, feed_specs)

    def export(axes):
        flat_names, examples, dyn = _examples(feed_specs, axes, batch_symbol,
                                              device)
        return flat_names, export_step(
            step_fn, param_names, params, flat_names, examples, device,
            dynamic_shapes=([None] * len(params), dyn))

    try:
        flat_names, ep = export(axes)
    except Exception as first:                    # noqa: BLE001
        if len(axes) < 2:
            raise
        # feeds the program combines position by position (one LoD in
        # Fluid, as a tagger's word, predicate and label feeds are) must
        # share their padded length: one example size for every feed's
        # innermost padded axis ties those axes into one symbol, which
        # the artifact then asks of its feeds. If that fails too, the
        # first failure stands
        shared = free(_EXAMPLE_SEQ[0])
        try:
            flat_names, ep = export({n: a[:-1] + [shared]
                                     for n, a in axes.items()})
        except Exception:                         # noqa: BLE001
            raise first from None
    fixed = _specialized_axes(ep, len(params), flat_names, feed_specs)
    if fixed:
        raise ValueError(
            f"feeds {sorted(fixed)}: op {lowered.fixed_by!r} fixes the "
            "padded length when exported (it loops over the padded axis "
            "on the host; ROADMAP.md §3, F14)")
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, _ARTIFACT), "wb") as f:
        f.write(save_exported(ep))
    meta = {"param_names": list(param_names),
            "param_dtypes": [str(p.dtype).replace("torch.", "")
                             for p in params],
            "feed_specs": feed_specs,
            "fetch_names": list(fetch_names),
            "device": str(torch.device(device))}
    with open(os.path.join(dirname, _META), "w") as f:
        json.dump(meta, f)
    return meta


def _examples(feed_specs, axes, batch_symbol, device):
    """The flat feed names, example tensors and dynamic shapes of
    :func:`export_compiled`'s step: one symbolic batch dim shared by
    every feed whose shape starts with -1, the other -1 dims and a
    sequence feed's padded axes (example sizes ``axes[name]``) each
    ``Dim.AUTO``."""
    batch = torch.export.Dim(batch_symbol)
    auto = torch.export.Dim.AUTO
    flat_names, examples, dyn = [], [], []
    for spec in feed_specs:
        n, shape, lod = spec["name"], spec["shape"], spec["lod_level"]
        dt = _torch_dtype(spec["dtype"])
        if not lod:
            ex = [(_EXAMPLE_BATCH if j == 0 else 2 * _EXAMPLE_BATCH + 1)
                  if s == -1 else s for j, s in enumerate(shape)]
            flat_names.append(n)
            examples.append(torch.zeros(ex, dtype=dt, device=device))
            dyn.append({j: (batch if j == 0 else auto)
                        for j, s in enumerate(shape) if s == -1} or None)
            continue
        # data [b, t...(lod), *feature]: the feature dims are the
        # variable's own after its batch dim
        feature = [2 * _EXAMPLE_BATCH + 1 if s == -1 else s
                   for s in shape[1:]]
        flat_names += [n, n + _LENGTHS] + ([n + _COUNTS] if lod == 2
                                           else [])
        examples.append(torch.zeros([_EXAMPLE_BATCH] + axes[n] + feature,
                                    dtype=dt, device=device))
        examples.append(torch.ones([_EXAMPLE_BATCH] + axes[n][:-1],
                                   dtype=torch.int64, device=device))
        dyn.append({0: batch, **{1 + k: auto for k in range(lod)},
                    **{1 + lod + j: auto for j, s in enumerate(shape[1:])
                       if s == -1}})
        dyn.append({0: batch, **{1 + k: auto for k in range(lod - 1)}})
        if lod == 2:
            examples.append(torch.ones([_EXAMPLE_BATCH], dtype=torch.int64,
                                       device=device))
            dyn.append({0: batch})
    return flat_names, examples, dyn


def _torch_dtype(name):
    return getattr(torch, str(name))


def _verify_params_manifest(dirname):
    """Re-hash params.npz against the saved-model manifest
    (``__params_manifest__.json``, written by ``_save_arrays`` with
    the resilience store's discipline). Absent manifest → legacy
    artifact, load unchecked as before. A mismatch quarantines the
    damaged file under ``<dirname>/quarantine/`` — evidence, exactly
    the resilience-store path — and raises ChecksumMismatch."""
    mpath = os.path.join(dirname, "__params_manifest__.json")
    if not os.path.exists(mpath):
        return
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return          # unreadable manifest: no contract to enforce
    want = manifest.get("sha256")
    if not want:
        return
    import hashlib
    ppath = os.path.join(dirname, "params.npz")
    with open(ppath, "rb") as f:
        got = hashlib.sha256(f.read()).hexdigest()
    if got == want:
        return
    from ..resilience.checkpoint import ChecksumMismatch
    import uuid
    qdir = os.path.join(dirname, "quarantine")
    try:
        os.makedirs(qdir, exist_ok=True)
        os.rename(ppath, os.path.join(
            qdir, f"params.npz.{uuid.uuid4().hex[:8]}"))
    except OSError:
        pass            # racing another loader — the raise is the point
    raise ChecksumMismatch(
        f"saved model {dirname}: params.npz sha256 mismatch "
        f"(expected {want[:12]}…, got {got[:12]}…) — torn copy or bit "
        "rot; the damaged file was quarantined, restore the artifact "
        "from its source")


class CompiledPredictor:
    """Runs an exported inference artifact — the ``PaddlePredictor``
    analogue (reference paddle_inference_api.h:90). Needs only this
    module and the K1 operator's registration: no Program IR, no
    registry, no lowering. Runs on the card (``cuda:0``; the host after
    ``force_cpu()``) unless given another ``device`` (``"cpu"``); an
    artifact exported on one device type is moved to the other by
    ``torch.export``'s device pass.

    >>> pred = load_compiled_predictor(dirname)
    >>> outs = pred.run({"img": batch})        # list of np.ndarray
    """

    def __init__(self, dirname, device=None):
        # the K1 operator must be registered before the graph loads
        from ..ops import flash_attention  # noqa: F401
        from .. import weights
        if not os.path.exists(os.path.join(dirname, _ARTIFACT)) and \
                os.path.exists(os.path.join(dirname, _JAX_ARTIFACT)):
            raise ValueError(
                f"{dirname} holds a JAX export ({_JAX_ARTIFACT}), which "
                "torch cannot run; its JSON program still serves through "
                "load_inference_model / ServingEngine.from_saved_model")
        if device is None:
            from ..core.executor import default_place
            device = default_place().device      # raises without CUDA
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CompiledPredictor: CUDA is not available "
                               "on this machine; pass device='cpu'")
        with open(os.path.join(dirname, _META)) as f:
            self._meta = json.load(f)
        with open(os.path.join(dirname, _ARTIFACT), "rb") as f:
            ep = torch.export.load(f)
        if torch.device(self._meta.get("device", "cpu")).type != \
                self.device.type:
            from torch.export.passes import move_to_device_pass
            ep = move_to_device_pass(ep, self.device)
        self._call = ep.module()
        # params ride beside the artifact in params.npz — verified
        # against the saved-model sha256 manifest BEFORE they are read
        # (a torn copy must surface as ChecksumMismatch, never as
        # silently wrong weights), then staged on the device once
        _verify_params_manifest(dirname)
        data = np.load(os.path.join(dirname, "params.npz"))
        self._params = [
            weights.array_to_tensor(data[n.replace("/", "%2F")],
                                    self.device, dtype=dt)
            for n, dt in zip(self._meta["param_names"],
                             self._meta["param_dtypes"])]

    @property
    def feed_names(self):
        return [s["name"] for s in self._meta["feed_specs"]]

    @property
    def fetch_names(self):
        return list(self._meta["fetch_names"])

    def _tensor(self, v, dtype):
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v, dtype=dtype))
        return v.to(self.device, dtype=_torch_dtype(dtype))

    def _sequence(self, spec, v):
        """A sequence feed's (data, lengths[, outer_counts]) tensors from
        a tuple, a dict with those keys, or any value with .data and
        .lengths (a SequenceBatch duck-types; this module never imports
        it); an artifact exported at a fixed padded length
        (``fixed_seq_len``) refuses any other (F14)."""
        n, lod = spec["name"], spec["lod_level"]
        contract = (f"sequence feed {n!r} (lod_level={lod}) needs "
                    + ("(data, lengths, outer_counts)" if lod == 2
                       else "(data, lengths)")
                    + " — a tuple, a dict with those keys, or a "
                    "SequenceBatch-like object")
        explicit = True
        if isinstance(v, (tuple, list)):
            parts = list(v)
        elif isinstance(v, dict):
            parts = [v.get("data"), v.get("lengths"), v.get("outer_counts")]
        elif hasattr(v, "data") and hasattr(v, "lengths") and \
                not isinstance(v, (np.ndarray, torch.Tensor)):
            # a SequenceBatch with outer_counts None derives them from
            # its nonzero lengths (its own sub_counts)
            parts = [v.data, v.lengths, getattr(v, "outer_counts", None)]
            explicit = False
        else:
            raise TypeError(f"{contract}; got {type(v).__name__}")
        if (len(parts) < 2 or parts[0] is None or parts[1] is None
                or (lod == 2 and explicit
                    and (len(parts) < 3 or parts[2] is None))):
            # at level 2 a spelled-out feed must carry outer_counts:
            # inferring them from nonzero lengths miscounts legitimate
            # zero-length subsequences
            raise TypeError(f"{contract}; got an incomplete value")
        data = self._tensor(parts[0], spec["dtype"])
        if data.dim() == lod + len(spec["shape"]) - 1 and \
                spec["shape"][-1] == 1:
            # rows of ids without their trailing unit dim (DataFeeder's
            # form of 1-D rows): the exported graph takes it
            data = data.unsqueeze(-1)
        fixed = spec.get("fixed_seq_len")
        if fixed and list(data.shape[1:1 + lod]) != list(fixed):
            raise ValueError(
                f"sequence feed {n!r} is padded to "
                f"{list(data.shape[1:1 + lod])}, but this artifact was "
                f"exported at the fixed padded length {fixed} (ROADMAP.md "
                "§3, F14): pad to that length (to_sequence_batch("
                "max_len=...)) or serve through the executor")
        out = [data, self._tensor(parts[1], "int64")]
        if lod == 2:
            counts = parts[2] if len(parts) > 2 and parts[2] is not None \
                else (out[1] > 0).sum(-1)
            out.append(self._tensor(counts, "int64"))
        return out

    def run(self, feed, return_numpy=True):
        """feed: dict name -> array (batch size free wherever the saved
        program's feed shape had -1); a sequence feed takes its padded
        decomposition: a (data, lengths[, outer_counts]) tuple, a dict
        with those keys, or a SequenceBatch-like value. Returns the
        fetches in fetch order, as numpy arrays (bfloat16 widened to
        float32) or, with ``return_numpy=False``, as tensors on the
        device."""
        feeds = []
        for spec in self._meta["feed_specs"]:
            n = spec["name"]
            if n not in feed:
                raise KeyError(
                    f"missing feed {n!r}; predictor feeds: "
                    f"{self.feed_names}")
            if spec.get("lod_level", 0):
                feeds += self._sequence(spec, feed[n])
            else:
                feeds.append(self._tensor(feed[n], spec["dtype"]))
        with torch.no_grad():
            outs = self._call(self._params, feeds)
        if not return_numpy:
            return list(outs)
        return [o.float().cpu().numpy() if o.dtype == torch.bfloat16
                else o.cpu().numpy() for o in outs]


def load_compiled_predictor(dirname, device=None):
    """``CreatePaddlePredictor`` analogue (reference
    paddle_inference_api.h:177)."""
    return CompiledPredictor(dirname, device=device)
