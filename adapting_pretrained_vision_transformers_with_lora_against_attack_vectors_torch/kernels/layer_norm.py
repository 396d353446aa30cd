"""LayerNorm over the last dimension: the CUDA kernel, its gradient, its plain version.

Replaces no TPU kernel: the JAX package's LayerNorm (``ops/nn.py:layer_norm``)
is an XLA composition. The plain version (:func:`layer_norm_reference`) is
the port's composition of the same function: ``x`` widened to f32,
``F.layer_norm`` in f32 with the parameters widened, the result rounded to
``x``'s dtype. On bf16 operands that is three kernels each way; the kernel
(``csrc/layer_norm.cu``) is one pass each way over bf16 rows, with f32
statistics, an f32 affine and one rounding.

Numerics (kernel): the row's mean, then the mean of its squared deviations,
in f32; ``rstd = rsqrt(var + eps)``; ``y = gamma * (rstd * (x - mean)) +
beta`` as one fused multiply-add, rounded once. The backward re-forms
``x_hat`` from the saved bf16 ``x`` and the f32 ``mean`` and ``rstd``, and
with ``g = dy * gamma`` computes ``dx = rstd * (g - mean(g) - x_hat *
mean(g * x_hat))`` in f32, rounded once: what the composition computes, the
cotangent widened exactly and the f32 ``dx`` rounded once. The parameters'
gradients, taken only when autograd asks for them (the attacks freeze the
parameters, a full fine-tune does not), are per-CTA f32 partial sums of
``dy * x_hat`` and ``dy`` summed in a fixed order by a second kernel
(``layer_norm_param_grads``) and written in the parameters' dtype; no
atomics, so a run repeats bit for bit.

Dispatch (:func:`takes`, which ``ops.nn.layer_norm`` asks): a tensor on the
CPU, an f32 tensor (the kernel takes bf16 alone, by design; on f32 the plain
version is ``F.layer_norm`` itself, the widening casts no-ops) and an empty
one take the plain version; every other tensor on the card goes to the
kernel, made contiguous, and the kernel raises on what it does not take (a
dtype other than bf16, a width outside :func:`kernel_variant`'s, scale and
bias of different dtypes, an operand not 16-byte aligned): nothing falls
back to the plain version on the card. ``FWD_LAUNCHES``, ``BWD_LAUNCHES``
and ``PARAM_GRAD_LAUNCHES`` count the launches of the three kernels.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
PARAM_GRAD_LAUNCHES = 0

# Widths: every multiple of 8 up to 256, a row's vectors masked past C (the
# test configurations' small widths, Swin-B's and ConvNeXt-B's 128, ViT-Ti's
# 192, Swin-B's and ConvNeXt-B's 256), and whole rows of 256 * VEC values
# (ViT-B's 768; Swin-B's and ConvNeXt-B's 512, 1024, 2048).
RAGGED_MAX_C = 256
WHOLE = {512: 2, 768: 3, 1024: 4, 2048: 8}  # C -> 8-value vectors a lane
_PARAM_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_CODE = {"fwd": 0, "bwd": 1, "bwd_params": 2}
_SOURCE = "layer_norm.cu"
_WAVES: dict = {}  # (device, C, parameter code, kernel code) -> the kernel's resident CTAs


def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """The plain version: LayerNorm in f32, cast back to ``x``'s dtype (differentiable)."""
    out = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
    return out.to(x.dtype)


def kernel_variant(dtype: torch.dtype, c: int) -> str:
    """The instantiation of ``csrc/layer_norm.cu`` that takes rows of width
    ``c`` (the C launcher's rule; nothing else chooses): ``"lanes<L>_vec<V>"``,
    L lanes a row (16 up to C = 128, two rows a warp; 32 above), V 16-byte
    vectors a lane. Raises on what no instantiation takes."""
    if dtype != torch.bfloat16:
        raise TypeError(f"dtype {dtype} unsupported by the LayerNorm kernel (takes bfloat16)")
    if not _takes_width(c):
        raise ValueError(f"width {c} unsupported by the LayerNorm kernel (takes multiples of 8 "
                         f"up to {RAGGED_MAX_C} and {sorted(WHOLE)})")
    return f"lanes{_lanes(c)}_vec{WHOLE.get(c, 1)}"


def takes(x: torch.Tensor) -> bool:
    """Whether ``x`` goes to the kernel: every non-empty tensor on the card
    but an f32 one (the kernel then raises on what it does not take)."""
    return _on_card(x) and x.dtype != torch.float32 and x.numel() > 0


def _takes_width(c: int) -> bool:
    return (8 <= c <= RAGGED_MAX_C and c % 8 == 0) or c in WHOLE


def _lanes(c: int) -> int:
    return 16 if c <= 128 else 32


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


# --- the CUDA kernel ----------------------------------------------------------

def _lib():
    from . import _build

    lib = _build.load(_SOURCE)
    if not getattr(lib, "_apvt_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.apvt_layer_norm_wave.argtypes = [i, i, i]
        lib.apvt_layer_norm_wave.restype = i
        lib.apvt_layer_norm_fwd.argtypes = [p, p, p, p, p, p, i, i, i, f, i, p]
        lib.apvt_layer_norm_fwd.restype = i
        lib.apvt_layer_norm_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, p]
        lib.apvt_layer_norm_bwd.restype = i
        lib.apvt_layer_norm_error_string.argtypes = [i]
        lib.apvt_layer_norm_error_string.restype = ctypes.c_char_p
        lib._apvt_typed = True
    return lib


def _check(x: torch.Tensor, scale: torch.Tensor, *others: torch.Tensor) -> tuple[int, int]:
    """Validate kernel operands (``others``: bias or the backward's
    tensors); raises on what the kernel does not take. Returns (rows, C)."""
    c = x.shape[-1]
    kernel_variant(x.dtype, c)
    if scale.dtype not in _PARAM_CODE or tuple(scale.shape) != (c,):
        raise ValueError(f"LayerNorm parameters must be ({c},) float32 or bfloat16, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    for t in (x, scale, *others):
        if not _on_card(t) or t.device != x.device:
            raise ValueError("LayerNorm kernel operands must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError("LayerNorm kernel operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("LayerNorm kernel operands must be 16-byte aligned")
    return x.numel() // c, c


def _raise_on(code: int, lib, what: str) -> None:
    if code == -1:
        raise ValueError(f"{what}: unsupported width, parameter dtype or grid")
    if code != 0:
        msg = lib.apvt_layer_norm_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _grid(lib, x: torch.Tensor, rows: int, c: int, code: int, kernel: str) -> int:
    """One wave (the kernel's resident CTAs an SM times the SMs, asked of the
    card once a kernel, width and device) and no more CTAs than row passes."""
    key = (x.device.index, c, code, kernel)
    wave = _WAVES.get(key)
    if wave is None:
        wave = lib.apvt_layer_norm_wave(c, code, _KERNEL_CODE[kernel])
        _raise_on(min(wave, 0), lib, "LayerNorm occupancy")
        _WAVES[key] = wave
    rows_per_pass = 128 // _lanes(c)
    return min(wave, -(-rows // rows_per_pass))


def _launch_fwd(x, scale, bias, eps: float):
    """(y, mean, rstd): y like x, mean and rstd (rows,) f32."""
    c = x.shape[-1]
    rows = x.numel() // c
    lib = _lib()
    code = _PARAM_CODE[scale.dtype]
    y = torch.empty_like(x)
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    rc = lib.apvt_layer_norm_fwd(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                                 mean.data_ptr(), rstd.data_ptr(), rows, c, code, float(eps),
                                 _grid(lib, x, rows, c, code, "fwd"), _stream(x))
    _raise_on(rc, lib, "LayerNorm forward")
    return y, mean, rstd


def _launch_bwd(x, dy, mean, rstd, scale, params: bool):
    """(dx, dscale, dbias): dx like x; with ``params`` dscale and dbias (C,)
    in the scale's dtype, from the (CTAs, 2, C) f32 partial sums of dy *
    x_hat and dy summed in order by the second kernel the same call
    launches, else None."""
    c = x.shape[-1]
    rows = x.numel() // c
    lib = _lib()
    code = _PARAM_CODE[scale.dtype]
    grid = _grid(lib, x, rows, c, code, "bwd_params" if params else "bwd")
    dx = torch.empty_like(x)
    partials = dscale = dbias = None
    if params:
        partials = torch.empty(grid, 2, c, dtype=torch.float32, device=x.device)
        dscale, dbias = torch.empty_like(scale), torch.empty_like(scale)
    rc = lib.apvt_layer_norm_bwd(x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                 scale.data_ptr(), dx.data_ptr(),
                                 *(t.data_ptr() if params else None
                                   for t in (partials, dscale, dbias)),
                                 rows, c, code, grid, _stream(x))
    _raise_on(rc, lib, "LayerNorm backward")
    return dx, dscale, dbias


def fused_layer_norm_fwd(x, scale, bias, eps: float):
    """Launch the forward kernel on CUDA tensors; returns (y, mean, rstd)."""
    global FWD_LAUNCHES
    _check(x, scale, bias)
    if bias.dtype != scale.dtype or bias.shape != scale.shape:
        raise ValueError(f"LayerNorm scale and bias must share a shape and dtype, got "
                         f"{scale.dtype} and {bias.dtype}")
    out = _launch_fwd(x, scale, bias, eps)
    FWD_LAUNCHES += 1
    return out


def fused_layer_norm_bwd(x, dy, mean, rstd, scale, params: bool):
    """Launch the backward kernel (and, with ``params``, the parameter
    gradients' kernel, in the same call) on CUDA tensors; returns (dx, dscale,
    dbias), the last two None without ``params``."""
    global BWD_LAUNCHES, PARAM_GRAD_LAUNCHES
    rows, _ = _check(x, scale, dy, mean, rstd)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError("the LayerNorm cotangent must be x's shape and dtype")
    if any(t.shape != (rows,) or t.dtype != torch.float32 for t in (mean, rstd)):
        raise ValueError(f"LayerNorm mean and rstd must be ({rows},) float32")
    dx, dscale, dbias = _launch_bwd(x, dy, mean, rstd, scale, params)
    BWD_LAUNCHES += 1
    PARAM_GRAD_LAUNCHES += int(params)
    return dx, dscale, dbias


class _LayerNorm(torch.autograd.Function):
    """The kernel pair as one differentiable op; saves the bf16 x and the f32
    row statistics (half of the f32 copy of x the composition saves)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = fused_layer_norm_fwd(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, rstd = ctx.saved_tensors
        need_x, need_scale, need_bias = ctx.needs_input_grad[:3]
        dx, dscale, dbias = fused_layer_norm_bwd(x, dy.contiguous(), mean, rstd, scale,
                                                 need_scale or need_bias)
        return (dx if need_x else None, dscale if need_scale else None,
                dbias if need_bias else None, None)


def fused_layer_norm(x, scale, bias, eps: float) -> torch.Tensor:
    """The CUDA kernel with its kernel gradient (CUDA tensors only; ``x``
    made contiguous, a no-op at every call site of the models)."""
    return _LayerNorm.apply(x.contiguous(), scale, bias, eps)


def bytes_moved(rows: int, c: int, direction: str, param_bytes: int = 2) -> int:
    """Device bytes the algorithm needs, each read or written once: forward,
    bf16 x read and y written, the scale and bias read, f32 mean and rstd
    written; backward, x and dy read, dx written, the scale and the
    statistics read (no parameter gradients)."""
    stats = 2 * rows * 4
    if direction == "fwd":
        return 2 * rows * c * 2 + 2 * c * param_bytes + stats
    return 3 * rows * c * 2 + c * param_bytes + stats
