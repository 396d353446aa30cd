"""Packed multi-head attention: the CUDA kernel, its gradient, its plain version.

Counterpart of the JAX package's ``kernels/attention.py:fused_attention_packed``.
Operands are the q/k/v dense outputs in the packed ``(B, N, H*hd)`` layout,
heads as contiguous hd-wide channel slices; the output has the same layout
and feeds the o-projection unchanged.

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
``BWD_LAUNCHES`` count kernel launches, so a run can show it went through
the kernel.
"""

from __future__ import annotations

import ctypes

import torch

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

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


def attention_packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's forward (differentiable)."""
    scale = (q.shape[-1] // heads) ** -0.5
    qh, kh, vh = (_split(t, heads) for t in (q, k, v))
    p = _probs(qh, kh, scale)
    o = torch.matmul(p.to(v.dtype).float(), vh.float())
    return _merge(o.to(q.dtype))


def attention_packed_bwd_reference(q, k, v, do, heads: int):
    """Plain PyTorch version of the kernel's backward: ``(dq, dk, dv)``."""
    scale = (q.shape[-1] // heads) ** -0.5
    qh, kh, vh, doh = (_split(t, heads) for t in (q, k, v, do))
    p = _probs(qh, kh, scale)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), doh.float())
    dp = torch.matmul(doh.float(), vh.float().transpose(-1, -2))
    row = (dp * p).sum(dim=-1, keepdim=True)
    ds = ((p * (dp - row)) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, kh.float())
    dk = torch.matmul(ds.transpose(-1, -2), qh.float())
    return (_merge(dq.to(q.dtype)), _merge(dk.to(k.dtype)), _merge(dv.to(v.dtype)))


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
        lib.apvt_cuda_error_string.argtypes = [i]
        lib.apvt_cuda_error_string.restype = ctypes.c_char_p
        lib._apvt_typed = True
    return lib


def _check(*tensors: torch.Tensor, heads: int) -> tuple[int, int, int, int]:
    """Validate kernel operands; returns (B, N, hd, dtype code)."""
    ref = tensors[0]
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
            raise ValueError("packed attention operands must share one CUDA device")
        if t.dtype != ref.dtype or t.shape != ref.shape:
            raise ValueError("packed attention operands must share shape and dtype")
        if not t.is_contiguous():
            raise ValueError("packed attention operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("packed attention operands must be 16-byte aligned")
    return b, n, hd, _DTYPE_CODE[ref.dtype]


def _raise_on(code: int, lib, what: str) -> None:
    if code == -1:
        raise ValueError(f"{what}: unsupported dtype or head dim")
    if code != 0:
        msg = lib.apvt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def fused_attention_packed_fwd(q, k, v, heads: int) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors; returns o (B, N, C)."""
    global FWD_LAUNCHES
    b, n, hd, code = _check(q, k, v, heads=heads)
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
    b, n, hd, code = _check(q, k, v, do, heads=heads)
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
