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
(``csrc/attention_packed.cu``) or raises. Inside the kernel library, bf16
with N <= 256 (the ViT path) runs on the tensor cores; f32, and bf16 with
longer sequences, on the CUDA cores. ``FWD_LAUNCHES`` and
``BWD_LAUNCHES`` count the packed kernel's launches, ``BHND_FWD_LAUNCHES``
and ``BHND_BWD_LAUNCHES`` the head-major kernel's, so a run can show it went
through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
BHND_FWD_LAUNCHES = 0
BHND_BWD_LAUNCHES = 0

HEAD_DIMS = (32, 64)
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


def attention_packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               heads: int) -> torch.Tensor:
    """Plain PyTorch version of the packed kernel's forward (differentiable)."""
    return _merge(attention_reference(*(_split(t, heads) for t in (q, k, v))))


def attention_packed_bwd_reference(q, k, v, do, heads: int):
    """Plain PyTorch version of the packed kernel's backward: ``(dq, dk, dv)``."""
    grads = attention_bwd_reference(*(_split(t, heads) for t in (q, k, v, do)))
    return tuple(_merge(g) for g in grads)


# --- the CUDA kernel ----------------------------------------------------------

def _lib():
    from . import _build

    lib = _build.load(_SOURCE)
    if not getattr(lib, "_apvt_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.apvt_attn_packed_fwd.argtypes = [p, p, p, p, i, i, i, i, i, f, p]
        lib.apvt_attn_packed_fwd.restype = i
        lib.apvt_attn_packed_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, f, p]
        lib.apvt_attn_packed_bwd.restype = i
        lib.apvt_attn_bhnd_fwd.argtypes = lib.apvt_attn_packed_fwd.argtypes
        lib.apvt_attn_bhnd_fwd.restype = i
        lib.apvt_attn_bhnd_bwd.argtypes = lib.apvt_attn_packed_bwd.argtypes
        lib.apvt_attn_bhnd_bwd.restype = i
        lib.apvt_cuda_error_string.argtypes = [i]
        lib.apvt_cuda_error_string.restype = ctypes.c_char_p
        lib._apvt_typed = True
    return lib


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
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} unsupported by the CUDA kernel (takes {HEAD_DIMS})")
    if ref.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {ref.dtype} unsupported by the CUDA kernel")
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
    if code != 0:
        msg = lib.apvt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def fused_attention_packed_fwd(q, k, v, heads: int) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors; returns o (B, N, C)."""
    global FWD_LAUNCHES
    b, n, _, hd, code = _check(q, k, v, heads=heads)
    lib = _lib()
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.apvt_attn_packed_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  b, n, heads, hd, code, hd ** -0.5, stream)
    _raise_on(rc, lib, "attention forward")
    FWD_LAUNCHES += 1
    return o


def fused_attention_packed_bwd(q, k, v, do, heads: int):
    """Launch the backward kernel on CUDA tensors; returns (dq, dk, dv)."""
    global BWD_LAUNCHES
    b, n, _, hd, code = _check(q, k, v, do, heads=heads)
    lib = _lib()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.apvt_attn_packed_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                  b, n, heads, hd, code, hd ** -0.5, stream)
    _raise_on(rc, lib, "attention backward")
    BWD_LAUNCHES += 1
    return dq, dk, dv


class _PackedAttention(torch.autograd.Function):
    """The kernel pair as one differentiable op; saves only q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, heads):
        ctx.heads = heads
        ctx.save_for_backward(q, k, v)
        return fused_attention_packed_fwd(q, k, v, heads)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = fused_attention_packed_bwd(q, k, v, do.contiguous(), ctx.heads)
        return dq, dk, dv, None


def fused_attention_packed(q, k, v, heads: int) -> torch.Tensor:
    """The CUDA kernel with its kernel gradient (CUDA tensors only)."""
    return _PackedAttention.apply(q, k, v, heads)


def attention_packed(q, k, v, heads: int) -> torch.Tensor:
    """Packed MHA: the kernel for CUDA tensors, the plain version on the CPU."""
    if q.device.type == "cpu":
        return attention_packed_reference(q, k, v, heads)
    return fused_attention_packed(q, k, v, heads)


# --- head-major (B, H, N, hd) ---------------------------------------------------

def fused_attention_fwd(q, k, v) -> torch.Tensor:
    """Launch the forward kernel on head-major CUDA tensors; returns o (B, H, N, hd)."""
    global BHND_FWD_LAUNCHES
    b, n, h, hd, code = _check(q, k, v, heads=None)
    lib = _lib()
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.apvt_attn_bhnd_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                b, n, h, hd, code, hd ** -0.5, stream)
    _raise_on(rc, lib, "attention forward")
    BHND_FWD_LAUNCHES += 1
    return o


def fused_attention_bwd(q, k, v, do):
    """Launch the backward kernel on head-major CUDA tensors; returns (dq, dk, dv)."""
    global BHND_BWD_LAUNCHES
    b, n, h, hd, code = _check(q, k, v, do, heads=None)
    lib = _lib()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.apvt_attn_bhnd_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                b, n, h, hd, code, hd ** -0.5, stream)
    _raise_on(rc, lib, "attention backward")
    BHND_BWD_LAUNCHES += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """The head-major kernel pair as one differentiable op; saves only q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return fused_attention_fwd(q, k, v)

    @staticmethod
    def backward(ctx, do):
        return fused_attention_bwd(*ctx.saved_tensors, do.contiguous())


def fused_attention(q, k, v) -> torch.Tensor:
    """``softmax(q k^T / sqrt(hd)) v`` over ``(B, H, N, hd)``: the CUDA kernel
    with its kernel gradient (CUDA tensors only)."""
    return _Attention.apply(q, k, v)


def attention_auto(q, k, v) -> torch.Tensor:
    """Head-major MHA: the kernel for CUDA tensors, the plain version on the CPU."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    return fused_attention(q, k, v)
