"""Depthwise 7x7 convolution (NHWC, stride 1, SAME, bias-free): the CUDA
kernel, its gradient, its plain version.

Counterpart of the JAX package's ``kernels/dwconv.py:dwconv7``. ``x`` is
``(B, H, W, C)``, ``w`` is ``(7, 7, C)`` (the model's HWIO ``(7, 7, 1, C)``
filter squeezed); the caller adds the conv bias in f32.

Numerics (kernel and plain version alike): the filter is rounded to ``x``'s
dtype first and widened to f32 (so the kernel and the library conv use the
same filter bits), the 49 taps accumulate in f32, the output is rounded once
to ``x``'s dtype. The input gradient is the same convolution of the
cotangent (cast to ``x``'s dtype) with the spatially flipped filter: the
same kernel. The filter gradient is taken only when autograd asks for it, by
the plain version's autograd; the attack path and LoRA training never do.

The plain version (:func:`dwconv7_reference`) is ``F.conv2d`` with
``groups=C`` on operands widened to f32 (on a CUDA tensor that is cuDNN's
f32 path; set ``torch.backends.cudnn.allow_tf32 = False`` to compare).

Dispatch (:func:`dwconv7`): one ``autograd.Function`` for both devices; a
CPU tensor takes the plain version in forward and backward, a CUDA tensor
launches the kernel (``csrc/dwconv7.cu``; f32 and bf16, any H and W, C a
multiple of 8) or raises. ``FWD_LAUNCHES`` counts kernel launches in the
forward role, ``DX_LAUNCHES`` in the input-gradient role, ``DW_CALLS`` the
filter-gradient recomputes.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

FWD_LAUNCHES = 0
DX_LAUNCHES = 0
DW_CALLS = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "dwconv7.cu"


def _taps_f32(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The filter rounded to ``dtype``, then widened: (7, 7, C) f32."""
    return w.to(dtype).float()


def dwconv7_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (differentiable in x and w)."""
    c = x.shape[-1]
    taps = _taps_f32(w, x.dtype).permute(2, 0, 1).reshape(c, 1, 7, 7)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), taps, None, 1, 3, 1, c)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def dwconv7_dw_reference(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Filter gradient ``(7, 7, C)`` in ``w``'s dtype, by the plain version's autograd."""
    global DW_CALLS
    DW_CALLS += 1
    with torch.enable_grad():
        wv = w.detach().requires_grad_(True)
        y = dwconv7_reference(x.detach(), wv)
        (dw,) = torch.autograd.grad(y, wv, g.to(y.dtype))
    return dw


# --- the CUDA kernel ----------------------------------------------------------

def _lib():
    from . import _build

    lib = _build.load(_SOURCE)
    if not getattr(lib, "_apvt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.apvt_dwconv7.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.apvt_dwconv7.restype = i
        lib.apvt_dwconv7_error_string.argtypes = [i]
        lib.apvt_dwconv7_error_string.restype = ctypes.c_char_p
        lib._apvt_typed = True
    return lib


def _launch(x: torch.Tensor, w: torch.Tensor, flip: bool) -> torch.Tensor:
    """The kernel on CUDA operands: x (B, H, W, C), w (7, 7, C), which is
    rounded to x's dtype here and widened in the kernel; ``flip`` reads it
    spatially flipped (the input-gradient role)."""
    if x.dim() != 4 or tuple(w.shape) != (7, 7, x.shape[-1]):
        raise ValueError(f"dwconv7 wants x (B, H, W, C) and w (7, 7, C), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {x.dtype} unsupported by the CUDA kernel")
    b, h, wd, c = x.shape
    if c % 8:
        raise ValueError(f"{c} channels unsupported by the CUDA kernel (takes a multiple of 8)")
    taps = w.to(x.dtype).contiguous()
    for t in (x, taps):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("dwconv7 operands must share one CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("dwconv7 operands must be contiguous and 16-byte aligned")
    lib = _lib()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.apvt_dwconv7(x.data_ptr(), taps.data_ptr(), out.data_ptr(), b, h, wd, c,
                          _DTYPE_CODE[x.dtype], int(flip), stream)
    if rc == -1:
        raise ValueError(f"dwconv7: unsupported dtype or shape {tuple(x.shape)}")
    if rc != 0:
        msg = lib.apvt_dwconv7_error_string(rc).decode()
        raise RuntimeError(f"dwconv7 launch failed: CUDA error {rc} ({msg})")
    return out


def fused_dwconv7_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel in its forward role on CUDA tensors."""
    global FWD_LAUNCHES
    out = _launch(x, w, flip=False)
    FWD_LAUNCHES += 1
    return out


def fused_dwconv7_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel in its input-gradient role: ``g`` (already in x's
    dtype) against the filter read flipped."""
    global DX_LAUNCHES
    out = _launch(g, w, flip=True)
    DX_LAUNCHES += 1
    return out


class _DwConv7(torch.autograd.Function):
    """Forward and input gradient by one function of (x, filter): the kernel
    on CUDA tensors, the plain version on CPU tensors."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.device.type == "cpu":
            return dwconv7_reference(x, w)
        return fused_dwconv7_fwd(x.contiguous(), w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (dwconv7_reference(g, w.flip(0, 1)) if g.device.type == "cpu"
                  else fused_dwconv7_dx(g, w))
        dw = dwconv7_dw_reference(x, w, g) if ctx.needs_input_grad[1] else None
        return dx, dw


def dwconv7(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise 7x7 SAME convolution: the kernel for CUDA tensors (forward
    and input gradient), the plain version on the CPU."""
    return _DwConv7.apply(x, w)
