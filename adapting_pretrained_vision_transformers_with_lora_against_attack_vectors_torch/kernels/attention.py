"""Multi-head attention in two layouts: the CUDA kernels, their gradients,
their plain versions.

Counterpart of the JAX package's ``kernels/attention.py``.
:func:`attention_packed` is its ``fused_attention_packed``: operands are the
q/k/v dense outputs in the packed ``(B, N, H*hd)`` layout, heads as
contiguous hd-wide channel slices; the output has the same layout and feeds
the o-projection unchanged. :func:`fused_attention` is its whole-head
``fused_attention`` over head-major ``(B, H, N, hd)`` operands, with
:func:`attention_auto` as its entry; no model path of either package calls
it. One device code serves both layouts (``csrc/attention_packed.cu`` takes
the operands' strides): the head-major kernel reads ``(B, H, N, hd)`` in
place, without a transposed or padded copy.

Numerics (kernel and plain version alike): scores in f32, scaled by
``hd**-0.5``; max-subtracted f32 softmax; P rounded to the input dtype
before P.V with f32 accumulation. The backward recomputes P and follows
``_attn_bwd_core``: dV = P^T dO (P rounded to v.dtype), dP = dO V^T,
dS = P*(dP - rowsum(dP*P))*scale rounded to q.dtype, dQ = dS K, dK = dS^T Q.
In f32 this equals ``ops.nn.attention``; at bf16 that function rounds the
stored scores to bf16 first, so the two differ by about one bf16 ulp in P.

Dispatch (:func:`attention_packed`): a CPU tensor takes the plain forward,
differentiated by autograd; a CUDA tensor launches the kernel
(``csrc/attention_packed.cu``) or raises. Inside the kernel library the
shape and the direction pick the variant (:func:`kernel_variant` is the same
test in Python). bf16 with hd = 64: the forward at N <= 256 (the ViT path)
runs on ``"wgmma"`` with TMA loads (``csrc/attn_wgmma.cuh``: a warpgroup's
whole score row in its accumulators); the backward at every N, and the
forward past N = 256 (ViT-B/16 at 384 px), on ``"wgmma_stream"``
(``csrc/attn_stream.cuh``: the same products, a CTA's own 64-row tiles held
and the other side streamed through a TMA ring in 64-row blocks, so that its
shared memory does not depend on N; its backward, CTA roles of one
warpgroup, takes a scratch buffer of the rows' statistics that
:func:`_launch_bwd` allocates). bf16 with hd = 32 and N <= 256 runs on
``mma.sync``, both directions; f32 at every N, and bf16 with hd = 32 past
256, on the CUDA cores (``"cuda_core"``: the other side streamed in 64-row
blocks past a CTA's block of rows, register-tiled f32 products).
:func:`kernel_plan` is the ``"cuda_core"`` or ``"wgmma_stream"`` launchers'
plan. The ``wgmma``, ``wgmma_stream`` and ``cuda_core`` forwards also
return the row log-sum-exp ``(B, H, N)`` in f32, and their backwards take
that and the forward's output, so that P needs no second max/sum pass and
``D = rowsum(dO * O)`` no second product
(:func:`attention_bwd_from_saved` is that arithmetic in plain PyTorch; it
differs from :func:`attention_bwd_reference` only by the rounding of O). The
``autograd.Function``s save both; a direct call of a backward wrapper without
them runs the forward kernel first. ``FWD_LAUNCHES`` and ``BWD_LAUNCHES``
count the packed kernel's launches, ``BHND_FWD_LAUNCHES`` and
``BHND_BWD_LAUNCHES`` the head-major kernel's, so a run can show it went
through the kernel. Two uncounted entries, for timing a route against the
code it replaced, which no model path calls: :func:`cc_fwd` and
:func:`cc_bwd` run bf16 hd-64 operands at any N on the ``"cuda_core"`` code
(replaced past N = 256), :func:`wg_bwd` the whole-head ``"wgmma"``
backward at N <= 256 in either layout (replaced by the streamed roles).
"""

from __future__ import annotations

import ctypes

import torch

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
BHND_FWD_LAUNCHES = 0
BHND_BWD_LAUNCHES = 0

HEAD_DIMS = (32, 64)
DIRECTIONS = ("fwd", "bwd")
WGMMA_MAX_N = 256  # the wgmma and mma.sync variants hold a whole score row in registers
MAX_SMEM = 232_448  # dynamic shared memory a block may use on the H100
# the "cuda_core" variant: rows of a streamed block; rows a CTA owns and rows a thread
# owns (a warp twice as many), for the forward and the backward (whose CTAs take the
# dK, dV role or the dQ role)
CC_BLOCK = 64
CC_ROWS = {"fwd": 64, "bwd": 128}
CC_THREAD_ROWS = {"fwd": 4, "bwd": 8}
# the "wgmma_stream" variant, per kernel: warpgroups a CTA (a 64-row tile each) and ring
# stages of two 64 x 64 bf16 tiles (8192 bytes each); the backward's stages also carry
# the dK/dV role's lse2 and D of a block
STREAM_BLOCK = 64
STREAM_WARPGROUPS = {"fwd": 2, "bwd": 1}
STREAM_STAGES = {"fwd": 4, "bwd": 3}
_TILE_BYTES = 64 * 64 * 2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "attention_packed.cu"


def _split(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.reshape(b, n, heads, c // heads).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, H, N, N) f32 probabilities from (B, H, N, hd) operands."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    return e / e.sum(dim=-1, keepdim=True)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernels' forward over head-major
    ``(B, H, N, hd)`` operands (differentiable)."""
    p = _probs(q, k, q.shape[-1] ** -0.5)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def attention_bwd_reference(q, k, v, do):
    """Plain PyTorch version of the kernels' backward over head-major
    operands: ``(dq, dk, dv)``."""
    scale = q.shape[-1] ** -0.5
    p = _probs(q, k, scale)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    row = (dp * p).sum(dim=-1, keepdim=True)
    ds = ((p * (dp - row)) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Row log-sum-exp of the scaled scores, ``(B, H, N)`` f32, from head-major
    operands: what the ``wgmma`` forward kernel writes beside its output."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.logsumexp(s, dim=-1)


def attention_bwd_from_saved(q, k, v, do, o, lse):
    """Plain PyTorch version of the ``wgmma`` backward kernel over head-major
    operands: P from the saved log-sum-exp, ``D = rowsum(dO * O)`` from the
    saved output; every other step and rounding point as in
    :func:`attention_bwd_reference`. Returns ``(dq, dk, dv)``."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    row = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    ds = ((p * (dp - row)) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               heads: int) -> torch.Tensor:
    """Plain PyTorch version of the packed kernel's forward (differentiable)."""
    return _merge(attention_reference(*(_split(t, heads) for t in (q, k, v))))


def attention_packed_bwd_reference(q, k, v, do, heads: int):
    """Plain PyTorch version of the packed kernel's backward: ``(dq, dk, dv)``."""
    grads = attention_bwd_reference(*(_split(t, heads) for t in (q, k, v, do)))
    return tuple(_merge(g) for g in grads)


# --- the CUDA kernel ----------------------------------------------------------

def kernel_variant(dtype: torch.dtype, n: int, hd: int, direction: str = "fwd") -> str:
    """Which device code of ``csrc/attention_packed.cu`` a shape takes in
    ``direction`` (``"fwd"`` or ``"bwd"``; the same test as its C launchers,
    ``fwd_any`` and ``bwd_any``; nothing else chooses): ``"wgmma"``,
    ``"wgmma_stream"``, ``"mma_sync"`` or ``"cuda_core"``. bf16 with hd 64
    takes ``"wgmma"`` forward at N <= 256 and ``"wgmma_stream"`` otherwise
    (the backward at every N). Raises on what no variant takes."""
    if direction not in DIRECTIONS:
        raise ValueError(f"direction {direction!r} is not one of {DIRECTIONS}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} unsupported by the CUDA kernel (takes {HEAD_DIMS})")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {dtype} unsupported by the CUDA kernel")
    if n < 1:
        raise ValueError(f"sequence length {n} unsupported by the CUDA kernel")
    if dtype == torch.bfloat16 and hd == 64:
        return "wgmma" if direction == "fwd" and n <= WGMMA_MAX_N else "wgmma_stream"
    if dtype == torch.bfloat16 and n <= WGMMA_MAX_N:
        return "mma_sync"
    return "cuda_core"


def kernel_plan(dtype: torch.dtype, n: int, hd: int, variant: str = "cuda_core") -> dict:
    """The launchers' plan for one (batch, head) of ``n`` rows at head dim
    ``hd``, per kernel (``"fwd"``, ``"bwd"``): the rows a CTA owns, its
    threads, its CTAs along N (the grid is that by H by B, or for
    ``"wgmma_stream"`` the product; the backward's first half takes the
    dK, dV role, its second the dQ role) and its dynamic shared memory in
    bytes. None of it but the CTAs grows with ``n``.

    ``"cuda_core"`` (``apvt_attn_cc_plan`` returns the launcher's): shared
    tiles are f32 with rows of hd + 4 values: the CTA's own rows (Q; Q and
    dO; K and V), two ring stages of the streamed 64-row blocks (K and V; K
    and V; Q, dO and O), the warps' P / dS rows of 80 values, and the row
    statistics; the backward holds the larger role's.

    ``"wgmma_stream"`` (bf16, hd 64; ``apvt_attn_stream_plan`` returns the
    launcher's), also its warpgroups (two a forward CTA, one a backward CTA)
    and ring stages: 1024 bytes of alignment slack, the own 64 x 64 bf16
    tiles (Q of each warpgroup; K and V, or Q and dO), ``stages`` ring stages
    of two tiles (K, V; Q, dO), the dK/dV role's lse2 and D of each stage,
    and 8 bytes a barrier (own, and full and empty a stage). Only the
    kernels that take ``n`` on this variant: the backward at every N, the
    forward past N = 256."""
    if variant == "wgmma_stream":
        if dtype != torch.bfloat16 or hd != 64:
            raise ValueError(f"the wgmma_stream variant takes bf16 with hd 64, not {dtype} hd {hd}")
        plan = {}
        for name, roles in (("fwd", 1), ("bwd", 2)):
            if kernel_variant(dtype, n, hd, name) != variant:
                continue
            wgs, stages = STREAM_WARPGROUPS[name], STREAM_STAGES[name]
            rows = STREAM_BLOCK * wgs
            own = wgs if name == "fwd" else 2 * wgs  # Q; K and V, or Q and dO
            stats = stages * 2 * STREAM_BLOCK * 4 if name == "bwd" else 0
            plan[name] = {"rows": rows, "warpgroups": wgs, "threads": 128 * wgs,
                          "stages": stages, "ctas": roles * -(-n // rows),
                          "smem": (1024 + (own + 2 * stages) * _TILE_BYTES + stats
                                   + (1 + 2 * stages) * 8)}
        return plan
    if variant != "cuda_core":
        raise ValueError(f"no launcher plan for the {variant!r} variant")
    kernel_variant(dtype, n, hd)
    s, x = (hd + 4) * 4, (CC_BLOCK + 16) * 4
    fwd, bwd = CC_ROWS["fwd"], CC_ROWS["bwd"]
    threads = {name: 16 * CC_ROWS[name] // CC_THREAD_ROWS[name] for name in CC_ROWS}
    dq = (2 * bwd + 4 * CC_BLOCK) * s + bwd * x + 2 * bwd * 4
    dkdv = (2 * bwd + 6 * CC_BLOCK) * s + bwd * x + 3 * CC_BLOCK * 4
    return {"fwd": {"rows": fwd, "threads": threads["fwd"], "ctas": -(-n // fwd),
                    "smem": (fwd + 4 * CC_BLOCK) * s + fwd * x},
            "bwd": {"rows": bwd, "threads": threads["bwd"], "ctas": 2 * -(-n // bwd),
                    "smem": max(dq, dkdv)}}


def stream_work_floats(b: int, n: int, h: int) -> int:
    """f32 values of the ``"wgmma_stream"`` backward's scratch: each head's
    rows padded to 64-row blocks, a block's lse2 (log2 domain) then D."""
    return b * h * -(-n // STREAM_BLOCK) * 2 * STREAM_BLOCK


def _lib():
    from . import _build

    lib = _build.load(_SOURCE)
    if not getattr(lib, "_apvt_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.apvt_attn_packed_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, f, p]
        lib.apvt_attn_packed_fwd.restype = i
        lib.apvt_attn_packed_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, f, p]
        lib.apvt_attn_packed_bwd.restype = i
        lib.apvt_attn_bhnd_fwd.argtypes = lib.apvt_attn_packed_fwd.argtypes
        lib.apvt_attn_bhnd_fwd.restype = i
        lib.apvt_attn_bhnd_bwd.argtypes = lib.apvt_attn_packed_bwd.argtypes
        lib.apvt_attn_bhnd_bwd.restype = i
        lib.apvt_attn_cc_plan.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
        lib.apvt_attn_cc_plan.restype = i
        lib.apvt_attn_stream_plan.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.apvt_attn_stream_plan.restype = i
        lib.apvt_attn_cc_bf16_fwd.argtypes = [p, p, p, p, p, i, i, i, f, p]
        lib.apvt_attn_cc_bf16_fwd.restype = i
        lib.apvt_attn_cc_bf16_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, f, p]
        lib.apvt_attn_cc_bf16_bwd.restype = i
        lib.apvt_attn_wg_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, f, p]
        lib.apvt_attn_wg_bwd.restype = i
        lib.apvt_cuda_error_string.argtypes = [i]
        lib.apvt_cuda_error_string.restype = ctypes.c_char_p
        lib._apvt_typed = True
    return lib


def launcher_plan(hd: int, variant: str = "cuda_core") -> dict:
    """The ``"cuda_core"`` (or ``"wgmma_stream"``, hd 64) launchers' own plan
    at head dim ``hd``: per kernel the rows a CTA owns, its threads and its
    dynamic shared memory (and for ``"wgmma_stream"`` its warpgroups and ring
    stages; its forward kernel takes N > 256, its backward kernel every N)."""
    if variant == "wgmma_stream":
        if hd != 64:
            raise ValueError(f"the wgmma_stream variant takes hd 64, not {hd}")
        out = (ctypes.c_int * 10)()
        _lib().apvt_attn_stream_plan(out)
        keys = ("rows", "warpgroups", "threads", "stages", "smem")
        return {name: {key: out[5 * i + j] for j, key in enumerate(keys)}
                for i, name in enumerate(("fwd", "bwd"))}
    out = (ctypes.c_int * 6)()
    if _lib().apvt_attn_cc_plan(hd, out) != 0:
        raise ValueError(f"head dim {hd} unsupported by the CUDA kernel")
    return {name: {"rows": out[3 * i], "threads": out[3 * i + 1], "smem": out[3 * i + 2]}
            for i, name in enumerate(("fwd", "bwd"))}


def _check(*tensors: torch.Tensor, heads: int | None) -> tuple[int, int, int, int, int]:
    """Validate kernel operands, packed ``(B, N, C)`` with ``heads`` or
    head-major ``(B, H, N, hd)`` with ``heads=None``; returns
    (B, N, H, hd, dtype code)."""
    ref = tensors[0]
    if heads is None:
        if ref.dim() != 4:
            raise ValueError(f"attention wants (B, H, N, hd) operands, got {tuple(ref.shape)}")
        b, heads, n, hd = ref.shape
    else:
        if ref.dim() != 3:
            raise ValueError(f"packed attention wants (B, N, C) operands, got {tuple(ref.shape)}")
        b, n, c = ref.shape
        if heads <= 0 or c % heads:
            raise ValueError(f"channels {c} not divisible by heads {heads}")
        hd = c // heads
    kernel_variant(ref.dtype, n, hd)
    for t in tensors:
        if not t.is_cuda or t.device != ref.device:
            raise ValueError("attention operands must share one CUDA device")
        if t.dtype != ref.dtype or t.shape != ref.shape:
            raise ValueError("attention operands must share shape and dtype")
        if not t.is_contiguous():
            raise ValueError("attention operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("attention operands must be 16-byte aligned")
    return b, n, heads, hd, _DTYPE_CODE[ref.dtype]


def _raise_on(code: int, lib, what: str) -> None:
    if code == -1:
        raise ValueError(f"{what}: unsupported dtype or head dim")
    if code == -2:
        raise RuntimeError(f"{what}: no tensor map could be encoded for these operands")
    if code == -3:
        raise RuntimeError(f"{what}: the wgmma_stream backward was given no scratch buffer")
    if code != 0:
        msg = lib.apvt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _check_lse(lse: torch.Tensor, b: int, h: int, n: int) -> None:
    if lse.shape != (b, h, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("the log-sum-exp must be (B, H, N) float32, contiguous")


def _launch_fwd(q, k, v, heads: int | None):
    """The forward kernel over packed (``heads`` given) or head-major operands:
    ``(o, lse)``; ``lse`` ``(B, H, N)`` f32 is written by the ``wgmma`` and
    ``cuda_core`` variants."""
    b, n, h, hd, code = _check(q, k, v, heads=heads)
    lib = _lib()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = lib.apvt_attn_bhnd_fwd if heads is None else lib.apvt_attn_packed_fwd
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, n, h, hd, code, hd ** -0.5, stream)
    _raise_on(rc, lib, "attention forward")
    return o, lse


def _launch_bwd(q, k, v, do, o, lse, heads: int | None):
    """The backward kernel: ``(dq, dk, dv)``. ``o`` and ``lse`` are the
    forward's; the ``mma_sync`` variant does not read them. For the
    ``wgmma_stream`` variant (bf16 with hd 64, at every N) it allocates the
    scratch of the rows' statistics that the launcher's pre-pass writes."""
    b, n, h, hd, code = _check(q, k, v, do, o, heads=heads)
    _check_lse(lse, b, h, n)
    lib = _lib()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    work = None  # the wgmma_stream backward's lse2 and D of every row
    if kernel_variant(q.dtype, n, hd, "bwd") == "wgmma_stream":
        work = torch.empty(stream_work_floats(b, n, h), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = lib.apvt_attn_bhnd_bwd if heads is None else lib.apvt_attn_packed_bwd
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(),
            lse.data_ptr(), None if work is None else work.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, n, h, hd, code, hd ** -0.5, stream)
    _raise_on(rc, lib, "attention backward")
    return dq, dk, dv


def fused_attention_packed_fwd(q, k, v, heads: int, *, with_lse: bool = False):
    """Launch the forward kernel on CUDA tensors; returns o (B, N, C), or
    ``(o, lse)`` with ``with_lse``."""
    global FWD_LAUNCHES
    o, lse = _launch_fwd(q, k, v, heads)
    FWD_LAUNCHES += 1
    return (o, lse) if with_lse else o


def fused_attention_packed_bwd(q, k, v, do, heads: int, o=None, lse=None):
    """Launch the backward kernel on CUDA tensors; returns (dq, dk, dv).
    Without the forward's ``o`` and ``lse`` the forward kernel runs first."""
    global BWD_LAUNCHES
    if o is None or lse is None:
        o, lse = fused_attention_packed_fwd(q, k, v, heads, with_lse=True)
    grads = _launch_bwd(q, k, v, do, o, lse, heads)
    BWD_LAUNCHES += 1
    return grads


class _PackedAttention(torch.autograd.Function):
    """The kernel pair as one differentiable op; saves q, k, v, the output
    and the row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, heads):
        ctx.heads = heads
        o, lse = fused_attention_packed_fwd(q, k, v, heads, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = fused_attention_packed_bwd(q, k, v, do.contiguous(), ctx.heads, o, lse)
        return dq, dk, dv, None


def fused_attention_packed(q, k, v, heads: int) -> torch.Tensor:
    """The CUDA kernel with its kernel gradient (CUDA tensors only)."""
    return _PackedAttention.apply(q, k, v, heads)


def attention_packed(q, k, v, heads: int) -> torch.Tensor:
    """Packed MHA: the kernel for CUDA tensors, the plain version on the CPU."""
    if q.device.type == "cpu":
        return attention_packed_reference(q, k, v, heads)
    return fused_attention_packed(q, k, v, heads)


# --- the route wgmma_stream replaced, for timing ---------------------------------

def _check_cc(*tensors, heads: int) -> tuple[int, int, int]:
    b, n, h, hd, _ = _check(*tensors, heads=heads)
    if tensors[0].dtype != torch.bfloat16 or hd != 64:
        raise ValueError("the timing entry of the cuda_core route takes bf16 with hd 64")
    return b, n, h


def cc_fwd(q, k, v, heads: int):
    """The forward on the ``"cuda_core"`` device code, packed bf16 with hd 64
    at any N: ``(o, lse)`` (uncounted; for timing it against the
    ``"wgmma_stream"`` code that replaced it past N = 256)."""
    b, n, h = _check_cc(q, k, v, heads=heads)
    lib = _lib()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    rc = lib.apvt_attn_cc_bf16_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                   lse.data_ptr(), b, n, h, 64 ** -0.5,
                                   torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, lib, "attention forward (cuda_core timing entry)")
    return o, lse


def cc_bwd(q, k, v, do, heads: int, o, lse):
    """The backward on the ``"cuda_core"`` device code from the forward's
    ``o`` and ``lse``: ``(dq, dk, dv)`` (uncounted; for timing)."""
    b, n, h = _check_cc(q, k, v, do, o, heads=heads)
    lib = _lib()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = lib.apvt_attn_cc_bf16_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                   o.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                   dv.data_ptr(), b, n, h, 64 ** -0.5,
                                   torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, lib, "attention backward (cuda_core timing entry)")
    return dq, dk, dv


# --- the whole-head backward the streamed roles replaced, for timing ----------

def wg_bwd(q, k, v, do, o, lse, heads: int | None):
    """The backward on the whole-head ``"wgmma"`` device code
    (``csrc/attn_wgmma.cuh:attn_bwd``: one CTA of two warpgroups a head) from
    the forward's ``o`` and ``lse``, packed (``heads`` given) or head-major
    bf16 operands with hd 64 and N <= 256: ``(dq, dk, dv)`` (uncounted; for
    timing it against the ``"wgmma_stream"`` roles that replaced it)."""
    b, n, h, hd, _ = _check(q, k, v, do, o, heads=heads)
    if q.dtype != torch.bfloat16 or hd != 64 or n > WGMMA_MAX_N:
        raise ValueError("the whole-head backward takes bf16 with hd 64 and N <= 256")
    _check_lse(lse, b, h, n)
    lib = _lib()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = lib.apvt_attn_wg_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                              o.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                              dv.data_ptr(), b, n, h, int(heads is None), 64 ** -0.5,
                              torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, lib, "attention backward (whole-head timing entry)")
    return dq, dk, dv


# --- head-major (B, H, N, hd) ---------------------------------------------------

def fused_attention_fwd(q, k, v, *, with_lse: bool = False):
    """Launch the forward kernel on head-major CUDA tensors; returns o
    (B, H, N, hd), or ``(o, lse)`` with ``with_lse``."""
    global BHND_FWD_LAUNCHES
    o, lse = _launch_fwd(q, k, v, None)
    BHND_FWD_LAUNCHES += 1
    return (o, lse) if with_lse else o


def fused_attention_bwd(q, k, v, do, o=None, lse=None):
    """Launch the backward kernel on head-major CUDA tensors; returns
    (dq, dk, dv). Without the forward's ``o`` and ``lse`` the forward kernel
    runs first."""
    global BHND_BWD_LAUNCHES
    if o is None or lse is None:
        o, lse = fused_attention_fwd(q, k, v, with_lse=True)
    grads = _launch_bwd(q, k, v, do, o, lse, None)
    BHND_BWD_LAUNCHES += 1
    return grads


class _Attention(torch.autograd.Function):
    """The head-major kernel pair as one differentiable op; saves q, k, v, the
    output and the row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = fused_attention_fwd(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return fused_attention_bwd(q, k, v, do.contiguous(), o, lse)


def fused_attention(q, k, v) -> torch.Tensor:
    """``softmax(q k^T / sqrt(hd)) v`` over ``(B, H, N, hd)``: the CUDA kernel
    with its kernel gradient (CUDA tensors only)."""
    return _Attention.apply(q, k, v)


def attention_auto(q, k, v) -> torch.Tensor:
    """Head-major MHA: the kernel for CUDA tensors, the plain version on the CPU."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    return fused_attention(q, k, v)
