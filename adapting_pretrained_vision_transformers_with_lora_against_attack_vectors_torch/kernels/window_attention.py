"""Swin window attention: the CUDA kernel, its gradient, its plain version.

Counterpart of the JAX package's ``kernels/window_attention.py:
fused_window_attention`` (``pack=1``). Operands are the qkv projection's raw
output ``(B, nW, n, 3C)`` (head ``h`` at the channel slices ``h*hd``,
``C + h*hd``, ``2C + h*hd``), the gathered relative-position bias
``(heads, n, n)`` and the shift mask ``(nW, n, n)``, both f32; the output
``(B, nW, n, C)`` feeds the output projection unchanged.

Numerics (kernel and plain version alike): scores in f32,
``q k^T * hd**-0.5 + bias[h] + mask[w]``; max-subtracted f32 softmax; P
rounded to the input dtype before P.V with f32 accumulation. The backward
recomputes P and follows ``_bwd_kernel``: dV = P^T dO (P rounded),
dP = dO V^T, dS = P*(dP - rowsum(dP*P)), ds = dS*scale rounded to the input
dtype, dQ = ds K, dK = ds^T Q. These are the Pallas kernel's numerics, not
the JAX XLA path's (``models/swin.py:_window_attention``), which stores the
scores in the compute dtype before adding bias and mask: in f32 the two are
the same; in bf16 they differ by about one bf16 ulp in the scores.

The bias gradient is the plain recompute of ``_dbias_xla``
(:func:`window_attention_dbias`), taken only when autograd asks for it; the
attack path never does. ``DBIAS_CALLS`` counts those recomputes. The mask
gets no gradient.

Dispatch (:func:`window_attention`): a CPU tensor takes the plain forward,
differentiated by autograd; a CUDA tensor launches the kernel
(``csrc/window_attention.cu``) or raises. Which device code a shape takes is
:func:`kernel_variant`, the same test as the C launcher (nothing else
chooses): bf16 with an even head count runs the Hopper kernels (``wgmma`` +
TMA, a CTA per window, head pair and batch chunk), bf16 with an odd head
count the ``mma.sync`` kernels of the first port, f32 the CUDA-core ones.
``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches, so a run can
show it went through the kernel. :func:`mma_sync_fwd` / :func:`mma_sync_bwd`
run the ``mma.sync`` device code at any bf16 shape, uncounted, for timing the
two designs against each other; no model path calls them.
"""

from __future__ import annotations

import ctypes

import torch

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
DBIAS_CALLS = 0

HEAD_DIM = 32
MAX_TOKENS = 64  # window <= 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "window_attention.cu"


def _heads(qkv: torch.Tensor, heads: int):
    """(B, nW, n, 3C) -> q, k, v each (B, nW, heads, n, hd)."""
    b, nw, n, c3 = qkv.shape
    x = qkv.reshape(b, nw, n, 3, heads, c3 // (3 * heads)).permute(3, 0, 1, 4, 2, 5)
    return x[0], x[1], x[2]


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(B, nW, heads, n, hd) -> (B, nW, n, heads*hd)."""
    b, nw, h, n, d = x.shape
    return x.transpose(2, 3).reshape(b, nw, n, h * d)


def _probs(q, k, bias, mask, scale: float) -> torch.Tensor:
    """(B, nW, heads, n, n) f32 probabilities."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + bias.float()[None, None]
    s = s + mask.float()[None, :, None]
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    return e / e.sum(dim=-1, keepdim=True)


def _scale(qkv: torch.Tensor, heads: int) -> float:
    return (qkv.shape[-1] // (3 * heads)) ** -0.5


def window_attention_reference(qkv, bias, mask, heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's forward (differentiable)."""
    q, k, v = _heads(qkv, heads)
    p = _probs(q, k, bias, mask, _scale(qkv, heads))
    o = torch.matmul(p.to(qkv.dtype).float(), v.float())
    return _merge(o.to(qkv.dtype))


def window_attention_bwd_reference(qkv, bias, mask, do, heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's backward: dqkv ``(B, nW, n, 3C)``."""
    scale = _scale(qkv, heads)
    q, k, v = _heads(qkv, heads)
    b, nw, n, c = do.shape
    doh = do.reshape(b, nw, n, heads, c // heads).transpose(2, 3).float()
    p = _probs(q, k, bias, mask, scale)
    dv = torch.matmul(p.to(qkv.dtype).float().transpose(-1, -2), doh)
    dp = torch.matmul(doh, v.float().transpose(-1, -2))
    row = (dp * p).sum(dim=-1, keepdim=True)
    ds = ((p * (dp - row)) * scale).to(qkv.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return torch.cat([_merge(t) for t in (dq, dk, dv)], dim=-1).to(qkv.dtype)


def window_attention_dbias(qkv, bias, mask, do, heads: int) -> torch.Tensor:
    """Bias gradient ``(heads, n, n)`` by recompute (``_dbias_xla``):
    sum over batch and windows of P*(dP - rowsum(dP*P)), unscaled."""
    global DBIAS_CALLS
    DBIAS_CALLS += 1
    q, k, v = _heads(qkv, heads)
    b, nw, n, c = do.shape
    doh = do.to(v.dtype).reshape(b, nw, n, heads, c // heads).transpose(2, 3)
    p = _probs(q, k, bias, mask, _scale(qkv, heads))
    dp = torch.matmul(doh.float(), v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    return ds.sum(dim=(0, 1)).to(bias.dtype)


# --- the CUDA kernel ----------------------------------------------------------

def kernel_variant(dtype: torch.dtype, n: int, heads: int, hd: int = HEAD_DIM) -> str:
    """Which device code of ``csrc/window_attention.cu`` a shape takes (the
    same test as its C launcher; nothing else chooses): ``"wgmma"`` (bf16,
    even head count: two heads of a window are one 128-byte tile row),
    ``"mma_sync"`` (bf16, odd head count) or ``"cuda_core"`` (f32). Raises on
    what no variant takes."""
    if hd != HEAD_DIM:
        raise ValueError(f"head dim {hd} unsupported by the CUDA kernel (takes {HEAD_DIM})")
    if not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"window of {n} tokens unsupported by the CUDA kernel "
                         f"(takes 1 <= n <= {MAX_TOKENS})")
    if heads < 1:
        raise ValueError(f"head count {heads} unsupported by the CUDA kernel")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {dtype} unsupported by the CUDA kernel")
    if dtype == torch.float32:
        return "cuda_core"
    return "wgmma" if heads % 2 == 0 else "mma_sync"


def _lib():
    from . import _build

    lib = _build.load(_SOURCE)
    if not getattr(lib, "_apvt_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.apvt_win_attn_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, f, p]
        lib.apvt_win_attn_fwd.restype = i
        lib.apvt_win_attn_bwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, p]
        lib.apvt_win_attn_bwd.restype = i
        lib.apvt_win_attn_fwd_mma_sync.argtypes = lib.apvt_win_attn_fwd.argtypes
        lib.apvt_win_attn_fwd_mma_sync.restype = i
        lib.apvt_win_attn_bwd_mma_sync.argtypes = lib.apvt_win_attn_bwd.argtypes
        lib.apvt_win_attn_bwd_mma_sync.restype = i
        lib.apvt_win_error_string.argtypes = [i]
        lib.apvt_win_error_string.restype = ctypes.c_char_p
        lib._apvt_typed = True
    return lib


def _check(qkv, bias, mask, heads: int, do=None) -> tuple[int, int, int, int]:
    """Validate kernel operands; returns (B, nW, n, dtype code)."""
    if qkv.dim() != 4:
        raise ValueError(f"window attention wants (B, nW, n, 3C) qkv, got {tuple(qkv.shape)}")
    b, nw, n, c3 = qkv.shape
    if heads <= 0 or c3 % (3 * heads):
        raise ValueError(f"qkv channels {c3} not divisible by 3 * heads ({heads})")
    kernel_variant(qkv.dtype, n, heads, c3 // (3 * heads))
    if tuple(bias.shape) != (heads, n, n) or tuple(mask.shape) != (nw, n, n):
        raise ValueError(f"bias {tuple(bias.shape)} / mask {tuple(mask.shape)} do not fit "
                         f"heads {heads}, {nw} windows of {n} tokens")
    if bias.dtype != torch.float32 or mask.dtype != torch.float32:
        raise ValueError("window attention bias and mask must be float32")
    operands = [qkv, bias, mask]
    if do is not None:
        if tuple(do.shape) != (b, nw, n, c3 // 3) or do.dtype != qkv.dtype:
            raise ValueError("the cotangent must be (B, nW, n, C) in the qkv dtype")
        operands.append(do)
    for t in operands:
        if not t.is_cuda or t.device != qkv.device:
            raise ValueError("window attention operands must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError("window attention operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("window attention operands must be 16-byte aligned")
    return b, nw, n, _DTYPE_CODE[qkv.dtype]


def _raise_on(code: int, lib, what: str) -> None:
    if code == -1:
        raise ValueError(f"{what}: unsupported dtype, head dim or window size")
    if code == -2:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled refused a TMA tensor map")
    if code != 0:
        msg = lib.apvt_win_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _launch_fwd(qkv, bias, mask, heads: int, entry: str) -> torch.Tensor:
    b, nw, n, code = _check(qkv, bias, mask, heads)
    lib = _lib()
    o = torch.empty(b, nw, n, qkv.shape[-1] // 3, dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = getattr(lib, entry)(qkv.data_ptr(), bias.data_ptr(), mask.data_ptr(), o.data_ptr(),
                             b, nw, n, heads, HEAD_DIM, code, HEAD_DIM ** -0.5, stream)
    _raise_on(rc, lib, "window attention forward")
    return o


def _launch_bwd(qkv, bias, mask, do, heads: int, entry: str) -> torch.Tensor:
    b, nw, n, code = _check(qkv, bias, mask, heads, do)
    lib = _lib()
    dqkv = torch.empty_like(qkv)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = getattr(lib, entry)(qkv.data_ptr(), bias.data_ptr(), mask.data_ptr(), do.data_ptr(),
                             dqkv.data_ptr(), b, nw, n, heads, HEAD_DIM, code, HEAD_DIM ** -0.5,
                             stream)
    _raise_on(rc, lib, "window attention backward")
    return dqkv


def fused_window_attention_fwd(qkv, bias, mask, heads: int) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors; returns o (B, nW, n, C)."""
    global FWD_LAUNCHES
    o = _launch_fwd(qkv, bias, mask, heads, "apvt_win_attn_fwd")
    FWD_LAUNCHES += 1
    return o


def fused_window_attention_bwd(qkv, bias, mask, do, heads: int) -> torch.Tensor:
    """Launch the backward kernel on CUDA tensors; returns dqkv (B, nW, n, 3C)."""
    global BWD_LAUNCHES
    dqkv = _launch_bwd(qkv, bias, mask, do, heads, "apvt_win_attn_bwd")
    BWD_LAUNCHES += 1
    return dqkv


def mma_sync_fwd(qkv, bias, mask, heads: int) -> torch.Tensor:
    """The forward on the ``mma.sync`` device code whatever the head count
    (uncounted; for timing it against the Hopper kernel)."""
    return _launch_fwd(qkv, bias, mask, heads, "apvt_win_attn_fwd_mma_sync")


def mma_sync_bwd(qkv, bias, mask, do, heads: int) -> torch.Tensor:
    """The backward on the ``mma.sync`` device code (uncounted; for timing)."""
    return _launch_bwd(qkv, bias, mask, do, heads, "apvt_win_attn_bwd_mma_sync")


class _WindowAttention(torch.autograd.Function):
    """The kernel pair as one differentiable op; saves qkv, bias and mask."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, heads):
        ctx.heads = heads
        ctx.save_for_backward(qkv, bias, mask)
        return fused_window_attention_fwd(qkv, bias, mask, heads)

    @staticmethod
    def backward(ctx, do):
        qkv, bias, mask = ctx.saved_tensors
        do = do.contiguous()
        dqkv = (fused_window_attention_bwd(qkv, bias, mask, do, ctx.heads)
                if ctx.needs_input_grad[0] else None)
        dbias = (window_attention_dbias(qkv, bias, mask, do, ctx.heads)
                 if ctx.needs_input_grad[1] else None)
        return dqkv, dbias, None, None


def fused_window_attention(qkv, bias, mask, heads: int) -> torch.Tensor:
    """The CUDA kernel with its kernel gradient (CUDA tensors only)."""
    return _WindowAttention.apply(qkv, bias, mask, heads)


def window_attention(qkv, bias, mask, heads: int) -> torch.Tensor:
    """Swin window MHA: the kernel for CUDA tensors, the plain version on the CPU."""
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, bias, mask, heads)
    return fused_window_attention(qkv, bias, mask, heads)
