"""Flash attention, forward and backward (port of
``paddle_tpu/ops/pallas_attention.py``).

The reference's three Pallas kernels are CUDA kernels here, all on the
tensor cores (``mma.sync``), one source a route:

- K1 ``_fa_kernel`` (the forward), wrapped by :func:`flash_fwd`: bf16
  and fp16 run ``csrc/flash_fwd_mma.cu``, float32
  ``csrc/flash_fwd_f32mma.cu``. Its plain version is
  :func:`ref_attention_lse`, a torch copy of the reference's
  ``_ref_attention_lse``.
- K2 ``_fa_bwd_dq_kernel`` (dQ), wrapped by :func:`flash_bwd_dq`: bf16
  and fp16 run ``csrc/flash_bwd_dq_mma.cu``, float32
  ``csrc/flash_bwd_dq_f32mma.cu``.
- K3 ``_fa_bwd_dkv_kernel`` (dK, dV), wrapped by :func:`flash_bwd_dkv`:
  bf16 and fp16 run ``csrc/flash_bwd_dkv_mma.cu``, float32
  ``csrc/flash_bwd_dkv_f32mma.cu``.

One TF32 or bf16 rounding of the operands cannot meet the float32
tiers, so the float32 kernels split every operand into hi + lo halves
and take each product three times: bf16 halves (``mma.sync`` m16n8k16)
for Q·Kᵀ, P·V, dS·K and dSᵀ·Q, TF32 halves (m16n8k8) for dO·Vᵀ and
Pᵀ·dO, whose bf16 split misses the tier's margin
(tests/test_torch_f32_split.py). :func:`kernel_for` is the routing;
the plain versions of K2 and K3 are :func:`ref_flash_bwd_dq` and
:func:`ref_flash_bwd_dkv`, which recompute P from lse over the whole
score matrix.

On a CUDA tensor a wrapper launches its kernel (or raises — there is no
fallback); on a CPU tensor it runs the plain version. Each wrapper
counts its launches in ``<wrapper>.launches`` and, by kernel symbol, in
``<wrapper>.launches_by_kernel``: one a call, or ceil(B·H / 65535) for
B·H past ``gridDim.y``'s limit, which the launchers start in chunks.

The head dims the kernels take are 64 and every multiple of 128, the
reference's Pallas gate (D % 128 == 0): past 128 each kernel runs its
D = 128 tiles in 128-column slices, one block a slice of its output
(``csrc/mma_sm90.cuh`` ``HEAD_SLICE``). The reference sends the head
dims its Pallas kernels do not take (D % 128 != 0) to its plain path on
every backend (``_flash_fwd``, ``_flash_vjp_bwd``); so does
:class:`FlashAttention` here, decided by the head dim before any
launch: on a CUDA tensor of a head dim that is neither 64 nor a
multiple of 128 it runs :func:`ref_attention_lse` and its gradient the
plain versions of K2 and K3, and counts each call in
``launches_by_kernel["plain"]`` of the wrapper it stands in for
(``launches`` counts kernels only). The wrappers themselves refuse that
head dim on CUDA.

The kernels follow the semantics of ``_ref_attention_lse`` and of
``jax.vjp`` of it, not the Pallas kernels' quirks: causal masking is
bottom-right aligned (``row + tk - tq >= col``; the Pallas kernels mask
top-left, which agrees only when tq == tk), keys past tk never enter the
softmax (the Pallas forward has no key-bounds mask for a ragged tail),
masked entries get dS = 0, and a row with every key masked (causal with
tq > tk) averages V, so its backward has P = 1/tk and dS = 0.

K1 is also the operator ``torch.ops.paddle_tpu_torch.flash_fwd``
(:func:`flash_fwd_op`, a ``torch.library.custom_op`` with a fake
implementation for its shapes), so an exported graph (``torch.export``,
io/aot.py and the artifact store) keeps the kernel as one node: on a
CUDA tensor the operator runs :func:`flash_fwd` (the launcher, counted
as any other launch), on a CPU tensor the plain version.
:class:`FlashAttention` calls it for its forward, so attention with and
without a gradient takes one path. An input the kernels cannot take as
it is (a view an exported graph hands over) is copied by the operator
and counted in ``flash_fwd.input_copies``.

``flash_attention`` and ``attention_with_lse`` are differentiable
through :class:`FlashAttention`, a ``torch.autograd.Function`` whose
backward runs K2 and K3 — the counterpart of the reference's
``jax.custom_vjp``. ``attention_with_lse`` is differentiable in both
outputs, as the reference's plain-jnp version is: since
d lse / d S = P, the lse cotangent folds into the kernels' row term as
delta = rowsum(dO * O) - dlse.
"""
import ctypes
import math
import threading

import torch

from . import cuda_build

__all__ = ["flash_attention", "attention_with_lse", "flash_fwd",
           "flash_bwd_dq", "flash_bwd_dkv", "FlashAttention",
           "ref_attention_lse", "ref_flash_bwd_dq", "ref_flash_bwd_dkv",
           "kernel_for", "takes_kernels", "reset_launch_counts", "NEG_INF",
           "PLAIN", "MAX_GRID_Y", "flash_fwd_op"]

NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# head dims past the kernels' widest tile run in slices of it
HEAD_SLICE = cuda_build.parse_constexprs(
    (cuda_build.CSRC / "mma_sm90.cuh").read_text())["HEAD_SLICE"]
_ALIGN = 16   # bytes: every kernel copies 16 bytes a cp.async
# B*H slices a kernel launch takes (gridDim.y's limit, in the header)
MAX_GRID_Y = cuda_build.parse_constexprs(
    (cuda_build.CSRC / "mma_sm90.cuh").read_text())["MAX_GRID_Y"]
PLAIN = "plain"   # launches_by_kernel's entry for the head-dim gate

# (library under csrc/, C symbol) of the kernel each wrapper launches:
# on float32, on bf16/fp16 inputs
_ROUTES = {
    "flash_fwd": (("flash_fwd_f32mma", "flash_fwd_f32mma"),
                  ("flash_fwd_mma", "flash_fwd_mma")),
    "flash_bwd_dq": (("flash_bwd_dq_f32mma", "flash_bwd_dq_f32mma"),
                     ("flash_bwd_dq_mma", "flash_bwd_dq_mma")),
    "flash_bwd_dkv": (("flash_bwd_dkv_f32mma", "flash_bwd_dkv_f32mma"),
                      ("flash_bwd_dkv_mma", "flash_bwd_dkv_mma")),
}


def _kernel_head_dim(d):
    """Whether the kernels take head dim ``d``: 64, or a multiple of
    :data:`HEAD_SLICE` (128), sliced past it."""
    return d == 64 or (d > 0 and d % HEAD_SLICE == 0)


def kernel_for(wrapper, dtype, d):
    """(library, symbol) of the CUDA kernel that ``wrapper``
    ("flash_fwd", "flash_bwd_dq" or "flash_bwd_dkv") launches on CUDA
    tensors of ``dtype`` and head dim ``d``: bf16 and fp16 go to the
    16-bit tensor-core kernels, float32 to the split-operand ones.
    Raises ValueError for what no kernel takes."""
    if not _kernel_head_dim(d):
        raise ValueError(f"{wrapper} kernels take head dims 64 and the "
                         f"multiples of {HEAD_SLICE}, got {d}")
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"{wrapper} kernels take float32, bfloat16 or "
                         f"float16, got {dtype}")
    return _ROUTES[wrapper][dtype != torch.float32]


def takes_kernels(x):
    """Whether attention on ``x`` ([..., T, D]) goes to the wrappers: a
    CPU tensor takes their plain versions, a CUDA tensor of head dim 64
    or a multiple of 128 their kernels. False only for a CUDA tensor of
    a head dim that is neither 64 nor a multiple of 128, which the
    reference's gate (``pallas_attention.py`` ``_flash_fwd``,
    ``_bwd_shapes_ok``: D % 128 == 0) also sends to its plain path."""
    return x.device.type != "cuda" or _kernel_head_dim(x.shape[-1])


def _misaligned(tensors):
    """The tensors whose data does not start on a 16-byte boundary (a
    contiguous view with a storage offset need not)."""
    return [x for x in tensors if x.data_ptr() % _ALIGN]


def ref_attention_lse(q, k, v, scale, causal, bias=None):
    """[..., T, D] attention returning (out, lse) — the plain version of
    K1, a torch copy of the reference's ``_ref_attention_lse``."""
    s = torch.einsum("...qd,...kd->...qk", q, k).float() * scale
    if bias is not None:
        s = s + bias
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        rows = torch.arange(tq, device=s.device)[:, None]
        cols = torch.arange(tk, device=s.device)[None, :]
        s = s.masked_fill(rows + (tk - tq) < cols, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("...qk,...kd->...qd", (p / l).to(v.dtype), v)
    lse = (m + torch.log(l))[..., 0]
    return o, lse


def _ref_p_ds(q, k, v, do, lse, delta, scale, causal):
    """The backward tile math of the reference's ``_recompute_ds`` over
    the whole [tq, tk] matrix, in float32: P = exp(S - lse) and
    dS = P * (dO V^T - delta) * scale, with masked entries 0 and fully
    masked rows at P = 1/tk, dS = 0 (their lse cannot give P back)."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.einsum("...qd,...kd->...qk", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("...qd,...kd->...qk", dof, vf)
    ds = p * (dp - delta.float()[..., None]) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        rows = torch.arange(tq, device=s.device)[:, None]
        cols = torch.arange(tk, device=s.device)[None, :]
        masked = rows + (tk - tq) < cols
        p = p.masked_fill(masked, 0.0)
        p = torch.where(rows + (tk - tq) < 0, 1.0 / tk, p)
        ds = ds.masked_fill(masked, 0.0)
    return p, ds


def ref_flash_bwd_dq(q, k, v, do, lse, delta, scale, causal):
    """dQ = dS K in q's dtype — the plain version of K2."""
    _, ds = _ref_p_ds(q, k, v, do, lse, delta, scale, causal)
    return torch.einsum("...qk,...kd->...qd", ds, k.float()).to(q.dtype)


def ref_flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal):
    """(dK = dS^T Q, dV = P^T dO) in k's and v's dtype — the plain
    version of K3."""
    p, ds = _ref_p_ds(q, k, v, do, lse, delta, scale, causal)
    dk = torch.einsum("...qk,...qd->...kd", ds, q.float())
    dv = torch.einsum("...qk,...qd->...kd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _check(name, q, k, v, extra=()):
    """The wrappers' shared input contract. q (and each tensor of
    ``extra``): [BH, tq, D]; k, v: [BH, tk, D]; one dtype, one device."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{name} takes [BH, T, D] tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, tq, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    for x in extra:
        if x.shape != q.shape:
            raise ValueError(f"{name}: {tuple(x.shape)} does not match q "
                             f"{tuple(q.shape)}")
    ts = (q, k, v) + tuple(extra)
    if len({x.dtype for x in ts}) != 1:
        raise ValueError(f"{name}: dtypes differ: "
                         f"{[x.dtype for x in ts]}")
    if len({x.device for x in ts}) != 1:
        raise ValueError(f"{name}: devices differ: "
                         f"{[x.device for x in ts]}")


def _check_kernel_inputs(name, tensors, rows):
    """What the CUDA kernels take beyond the shared contract: CUDA
    tensors of a kernel dtype and head dim, contiguous, and 16-byte
    aligned (every kernel copies its tiles by cp.async); float32 row
    vectors
    ``rows`` of shape [BH, tq]. Returns the kernel's (library,
    symbol)."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    route = kernel_for(name, q.dtype, q.shape[2])
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    if _misaligned(tensors):
        raise ValueError(f"{name} ({route[1]}) needs inputs that start on "
                         f"a {_ALIGN}-byte boundary")
    for x in rows:
        if x.dtype != torch.float32 or x.shape != q.shape[:2] \
                or x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{name}: lse/delta must be contiguous "
                             f"float32 [BH, tq] on {q.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return route


def _bind(route, n_ptrs):
    lib, fn_name = route
    fn = getattr(cuda_build.load(lib), fn_name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        # pointers; bh, tq, tk, d, dtype; scale, causal, stream
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _launch(wrapper, route, ptrs, q, tk, scale, causal):
    """Launch ``route``'s kernel with the pointers ``ptrs`` and count its
    launches (one for each chunk of B·H) on ``wrapper``."""
    name = route[1]
    kernel = _bind(route, len(ptrs))
    bh, tq, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = kernel(*ptrs, bh, tq, tk, d, _DTYPE_CODE[q.dtype],
                    float(scale), int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"(bh={bh}, tq={tq}, tk={tk}, d={d}, "
                           f"dtype={q.dtype})")
    _count(wrapper, name, -(-bh // MAX_GRID_Y))


# the counters are read exactly (chip_smoke.py holds launches per path),
# and replica threads of a serving pool dispatch concurrently: a bare
# ``+=`` can lose an increment between its read and its write
_COUNT_LOCK = threading.Lock()


def _count(wrapper, name, n=1):
    """Add ``n`` launches of ``name`` (a kernel symbol, or :data:`PLAIN`,
    which ``launches`` leaves out) to ``wrapper``'s counters, under the
    counters' lock."""
    with _COUNT_LOCK:
        if name != PLAIN:
            wrapper.launches += n
        wrapper.launches_by_kernel[name] += n


def flash_fwd(q, k, v, scale, causal):
    """K1's wrapper. q: [BH, tq, D]; k, v: [BH, tk, D], contiguous, one
    dtype, one device. Returns (o [BH, tq, D] in q's dtype,
    lse [BH, tq] float32). ``flash_fwd.launches`` counts kernel
    launches, ``flash_fwd.launches_by_kernel`` each variant's."""
    _check("flash_fwd", q, k, v)
    if q.device.type == "cpu":
        return ref_attention_lse(q, k, v, scale, causal)
    route = _check_kernel_inputs("flash_fwd", (q, k, v), ())
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch(flash_fwd, route,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr()), q, k.shape[1], scale, causal)
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, scale, causal):
    """K2's wrapper. q, do: [BH, tq, D]; k, v: [BH, tk, D]; lse, delta:
    [BH, tq] float32 (delta = rowsum(dO * O) - dlse). Returns dq in q's
    dtype. ``flash_bwd_dq.launches`` counts kernel launches,
    ``flash_bwd_dq.launches_by_kernel`` each variant's."""
    _check("flash_bwd_dq", q, k, v, (do,))
    if q.device.type == "cpu":
        return ref_flash_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    route = _check_kernel_inputs("flash_bwd_dq", (q, k, v, do),
                                 (lse, delta))
    dq = torch.empty_like(q)
    _launch(flash_bwd_dq, route,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            q, k.shape[1], scale, causal)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal):
    """K3's wrapper; arguments as :func:`flash_bwd_dq`. Returns (dk, dv)
    in k's and v's dtype. ``flash_bwd_dkv.launches`` counts kernel
    launches, ``flash_bwd_dkv.launches_by_kernel`` each variant's."""
    _check("flash_bwd_dkv", q, k, v, (do,))
    if q.device.type == "cpu":
        return ref_flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    route = _check_kernel_inputs("flash_bwd_dkv", (q, k, v, do),
                                 (lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(flash_bwd_dkv, route,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
             dv.data_ptr()), q, k.shape[1], scale, causal)
    return dk, dv


def reset_launch_counts():
    """Zero every wrapper's ``launches`` and ``launches_by_kernel`` (its
    kernels' symbols and :data:`PLAIN`), and ``flash_fwd.input_copies``
    (the inputs :func:`flash_fwd_op` had to copy)."""
    with _COUNT_LOCK:
        for w in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
            w.launches = 0
            w.launches_by_kernel = {sym: 0
                                    for _, sym in _ROUTES[w.__name__]}
            w.launches_by_kernel[PLAIN] = 0
        flash_fwd.input_copies = 0


reset_launch_counts()


def _aligned_copy(x):
    """``x`` itself when the kernels take it (contiguous, on a 16-byte
    boundary), else a contiguous copy, counted."""
    if x.is_contiguous() and not _misaligned((x,)):
        return x
    with _COUNT_LOCK:
        flash_fwd.input_copies += 1
    return x.clone(memory_format=torch.contiguous_format)


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float, causal: bool
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 as a torch operator on [BH, T, D] tensors: the launcher
    :func:`flash_fwd` (CUDA: the kernel, counted; CPU: the plain
    version), or on a CUDA tensor of a head dim the reference sends to
    its plain path (:func:`takes_kernels`) the plain version, counted as
    :data:`PLAIN`."""
    if not takes_kernels(q):
        _count(flash_fwd, PLAIN)
        o, lse = ref_attention_lse(q, k, v, scale, causal)
        return o, lse.contiguous()
    # an exported graph records no copy for a ``.contiguous()`` that was
    # a no-op at its example shapes, so its inputs may arrive as views:
    # each is copied here, and counted in ``flash_fwd.input_copies``
    q, k, v = (_aligned_copy(x) for x in (q, k, v))
    o, lse = flash_fwd(q, k, v, scale, causal)
    return o, lse.contiguous()


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, scale, causal):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:2], dtype=torch.float32))


def _fold(x):
    """[B, H, T, D] → contiguous [B*H, T, D]. The copy comes before the
    reshape, so an exported graph records it at every batch size: a
    reshape that copies at the example's batch is a view at batch 1,
    and a ``.contiguous()`` after it would be recorded as nothing."""
    return x.contiguous().reshape(x.shape[0] * x.shape[1], x.shape[2],
                                  x.shape[3])


class FlashAttention(torch.autograd.Function):
    """q, k, v: [B, H, T, D] → (o [B, H, tq, D], lse [B, H, tq] float32)
    through K1; the backward runs K2 and K3 on the saved q, k, v, o and
    lse. ``scale`` is the softmax scale (already resolved). A CUDA
    tensor of a head dim the reference sends to its plain path
    (:func:`takes_kernels`) runs the plain versions instead, counted as
    :data:`PLAIN`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        b, h, tq, d = q.shape
        qf, kf, vf = _fold(q), _fold(k), _fold(v)
        ctx.plain = not takes_kernels(q)
        o, lse = flash_fwd_op(qf, kf, vf, scale, causal)
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.shapes = (q.shape, k.shape, v.shape)
        return o.reshape(b, h, tq, d), lse.reshape(b, h, tq)

    @staticmethod
    def backward(ctx, do, dlse):
        qf, kf, vf, o, lse = ctx.saved_tensors
        qs, ks, vs = ctx.shapes
        dof = _fold(do.to(qf.dtype))
        # delta = rowsum(dO * O) in float32, outside the kernels as in
        # the reference (_flash_bwd_pallas); the lse cotangent enters
        # through it because d lse / d S = P
        delta = (dof.float() * o.float()).sum(-1)
        if dlse is not None:
            delta = delta - dlse.reshape(delta.shape).float()
        delta = delta.contiguous()
        bwd = (qf, kf, vf, dof, lse, delta, ctx.scale, ctx.causal)
        if ctx.plain:
            dq = ref_flash_bwd_dq(*bwd)
            dk, dv = ref_flash_bwd_dkv(*bwd)
            _count(flash_bwd_dq, PLAIN)
            _count(flash_bwd_dkv, PLAIN)
        else:
            dq = flash_bwd_dq(*bwd)
            dk, dv = flash_bwd_dkv(*bwd)
        return dq.reshape(qs), dk.reshape(ks), dv.reshape(vs), None, None


def attention_with_lse(q, k, v, scale=None, causal=False):
    """Attention that also returns log-sum-exp — the building block
    ring attention merges partial results with. q,k,v: [B, H, T, D].
    ``scale`` 0 or None means 1/sqrt(D), as in the reference.
    Differentiable in both outputs."""
    sc = scale or (1.0 / math.sqrt(q.shape[-1]))
    return FlashAttention.apply(q, k, v, bool(causal), float(sc))


def flash_attention(q, k, v, causal=True, scale=None):
    """q,k,v: [B, H, T, D] → [B, H, T, D], differentiable (K2/K3)."""
    o, _ = attention_with_lse(q, k, v, scale, causal)
    return o
