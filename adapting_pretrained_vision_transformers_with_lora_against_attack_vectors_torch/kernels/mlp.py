"""LayerNorm-fused MLP over token rows: the CUDA kernels (forward and input
gradient), the parameter gradients, the plain versions.

Counterpart of the JAX package's ``kernels/mlp.py:fused_ln_mlp``:
``gelu(LN(x) @ w1 + b1) @ w2 + b2`` for ``x`` ``(..., D)``, ``w1`` ``(D, M)``,
``w2`` ``(M, D)``, the pre-residual MLP half-block of ConvNeXt (and of a ViT
block) with the LayerNorm folded in. The hidden activation never reaches
device memory.

Numerics (kernels and plain versions alike, ``cd`` = ``x``'s dtype): LN in
f32 (two-pass mean/var), rounded to ``cd``; ``@ w1`` with operands in ``cd``
and f32 accumulation, ``+ b1`` in f32; exact (erf) GELU in f32, rounded to
``cd``; ``@ w2`` with f32 accumulation, ``+ b2`` in f32; rounded to ``cd``.
Backward (dx only in the kernel): LN and ``pre`` recomputed; ``dh = dy @
w2^T`` (f32 accumulation); ``dpre = dh * gelu'(pre)`` rounded to ``cd``;
``@ w1^T`` (f32 accumulation); the f32 LayerNorm backward; rounded once. The
kernels use ``erff``, not the polynomial of the TPU kernel (which exists
because Mosaic has no erf), so they match ``ops.nn.gelu``.

The parameter gradients (:func:`ln_mlp_param_grads`; ``w1``, ``b1``, ``w2``,
``b2``, LN scale and bias) are a plain recompute with the same rounding
points, taken only for the inputs autograd asks for; the attack path asks
for none. ``PARAM_GRAD_CALLS`` counts those recomputes.

Dispatch (:func:`ln_mlp`): one ``autograd.Function`` for both devices; CPU
tensors take the plain versions in forward and backward, CUDA tensors launch
the kernels (``csrc/ln_mlp.cu``) or raise. The kernels take bf16 only, D in
``KERNEL_DIMS`` and M a multiple of ``HIDDEN_MULTIPLE``. A model calls
:func:`ln_mlp` only with bf16 compute (the JAX dtype gate: with f32 compute
its block runs the library composition) and lets an unsupported width raise.
``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.nn import _mm_f32
from . import ln_bwd_f32, ln_fwd_f32

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
PARAM_GRAD_CALLS = 0

KERNEL_DIMS = (128, 256, 384, 512, 768, 1024)
HIDDEN_MULTIPLE = 128
_SOURCE = "ln_mlp.cu"
_SQRT_HALF = 0.7071067811865476


def _gelu_f32(pre: torch.Tensor) -> torch.Tensor:
    """Exact GELU on f32."""
    return 0.5 * pre * (1.0 + torch.erf(pre * _SQRT_HALF))


def _gelu_grad_f32(pre: torch.Tensor) -> torch.Tensor:
    """d/dx [x * Phi(x)] = Phi(x) + x * phi(x)."""
    phi = torch.exp(-0.5 * pre * pre) * 0.3989422804014327
    cdf = 0.5 * (1.0 + torch.erf(pre * _SQRT_HALF))
    return cdf + pre * phi


def ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (differentiable)."""
    cd = x.dtype
    _, _, h = ln_fwd_f32(x.float(), ln_scale, ln_bias, eps)
    pre = _mm_f32(h.to(cd), w1.to(cd)) + b1.float()
    y = _mm_f32(_gelu_f32(pre).to(cd), w2.to(cd)) + b2.float()
    return y.to(cd)


def ln_mlp_bwd_reference(x, ln_scale, ln_bias, w1, b1, w2, dy, eps: float) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: dx in ``x``'s dtype."""
    cd = x.dtype
    normed, rstd, h = ln_fwd_f32(x.float(), ln_scale, ln_bias, eps)
    w1c = w1.to(cd)
    pre = _mm_f32(h.to(cd), w1c) + b1.float()
    dh = _mm_f32(dy.to(cd), w2.to(cd).t())
    dpre = (dh * _gelu_grad_f32(pre)).to(cd)
    dhid = _mm_f32(dpre, w1c.t())
    return ln_bwd_f32(dhid, ln_scale, normed, rstd).to(cd)


def ln_mlp_param_grads(x, ln_scale, ln_bias, w1, b1, w2, b2, dy, eps: float, needs) -> tuple:
    """``(dscale, dbias, dw1, db1, dw2, db2)`` by plain recompute with the
    kernels' rounding points, each in its parameter's dtype; ``None`` where
    ``needs`` (six flags in that order) is false."""
    global PARAM_GRAD_CALLS
    PARAM_GRAD_CALLS += 1
    cd = x.dtype
    d = x.shape[-1]
    x2, g2 = x.reshape(-1, d), dy.reshape(-1, d).to(cd)
    normed, _, h = ln_fwd_f32(x2.float(), ln_scale, ln_bias, eps)
    h_cd, w1c, w2c = h.to(cd), w1.to(cd), w2.to(cd)
    pre = _mm_f32(h_cd, w1c) + b1.float()
    dpre = _mm_f32(g2, w2c.t()) * _gelu_grad_f32(pre)
    dpre_cd = dpre.to(cd)
    out = [None] * 6
    if needs[0] or needs[1]:
        dh_full = _mm_f32(dpre_cd, w1c.t())
        if needs[0]:
            out[0] = (dh_full * normed).sum(0).to(ln_scale.dtype)
        if needs[1]:
            out[1] = dh_full.sum(0).to(ln_bias.dtype)
    if needs[2]:
        out[2] = _mm_f32(h_cd.t(), dpre_cd).to(w1.dtype)
    if needs[3]:
        out[3] = dpre.sum(0).to(b1.dtype)
    if needs[4]:
        out[4] = _mm_f32(_gelu_f32(pre).to(cd).t(), g2).to(w2.dtype)
    if needs[5]:
        out[5] = g2.float().sum(0).to(b2.dtype)
    return tuple(out)


# --- the CUDA kernels ---------------------------------------------------------

def _lib():
    from . import _build

    lib = _build.load(_SOURCE)
    if not getattr(lib, "_apvt_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.apvt_ln_mlp_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, f, p]
        lib.apvt_ln_mlp_fwd.restype = i
        lib.apvt_ln_mlp_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, f, p]
        lib.apvt_ln_mlp_bwd.restype = i
        lib.apvt_ln_mlp_error_string.argtypes = [i]
        lib.apvt_ln_mlp_error_string.restype = ctypes.c_char_p
        lib._apvt_typed = True
    return lib


def _prep(x, ln_scale, ln_bias, w1, b1, w2, b2=None, dy=None):
    """Validate, and cast the parameters as the kernels want them: LN rows
    and biases f32, weights bf16, all contiguous. Returns ``(T, D, M, operands)``."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"dtype {x.dtype} unsupported by the CUDA kernel (takes bfloat16)")
    if x.dim() != 2:
        raise ValueError(f"ln_mlp wants token rows (T, D), got {tuple(x.shape)}")
    t, d = x.shape
    m = w1.shape[-1]
    if d not in KERNEL_DIMS:
        raise ValueError(f"width {d} unsupported by the CUDA kernel (takes {KERNEL_DIMS})")
    if tuple(w1.shape) != (d, m) or tuple(w2.shape) != (m, d) or m % HIDDEN_MULTIPLE:
        raise ValueError(f"weights {tuple(w1.shape)} / {tuple(w2.shape)} do not fit width {d} "
                         f"with a hidden width that is a multiple of {HIDDEN_MULTIPLE}")
    rows = [ln_scale, ln_bias, b1] + ([] if b2 is None else [b2])
    if [tuple(r.shape) for r in rows] != [(d,), (d,), (m,)] + ([] if b2 is None else [(d,)]):
        raise ValueError("LayerNorm rows and biases do not fit the weights")
    if dy is not None and (tuple(dy.shape) != (t, d) or dy.dtype != x.dtype):
        raise ValueError("the cotangent must be (T, D) in x's dtype")
    ops = {"x": x, "ln_scale": ln_scale.float(), "ln_bias": ln_bias.float(),
           "w1": w1.to(torch.bfloat16), "b1": b1.float(), "w2": w2.to(torch.bfloat16)}
    if b2 is not None:
        ops["b2"] = b2.float()
    if dy is not None:
        ops["dy"] = dy
    ops = {k: v.contiguous() for k, v in ops.items()}
    for v in ops.values():
        if not v.is_cuda or v.device != x.device:
            raise ValueError("ln_mlp operands must share one CUDA device")
        if v.data_ptr() % 16:
            raise ValueError("ln_mlp operands must be 16-byte aligned")
    return t, d, m, ops


def _raise_on(code: int, lib, what: str) -> None:
    if code == -1:
        raise ValueError(f"{what}: unsupported shape")
    if code != 0:
        msg = lib.apvt_ln_mlp_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def fused_ln_mlp_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors: x (T, D) bf16 -> (T, D) bf16."""
    global FWD_LAUNCHES
    t, d, m, o = _prep(x, ln_scale, ln_bias, w1, b1, w2, b2=b2)
    lib = _lib()
    out = torch.empty_like(o["x"])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.apvt_ln_mlp_fwd(o["x"].data_ptr(), o["ln_scale"].data_ptr(), o["ln_bias"].data_ptr(),
                             o["w1"].data_ptr(), o["b1"].data_ptr(), o["w2"].data_ptr(),
                             o["b2"].data_ptr(), out.data_ptr(), t, d, m, float(eps), stream)
    _raise_on(rc, lib, "ln_mlp forward")
    FWD_LAUNCHES += 1
    return out


def fused_ln_mlp_bwd(x, ln_scale, ln_bias, w1, b1, w2, dy, eps: float) -> torch.Tensor:
    """Launch the backward kernel on CUDA tensors: dx (T, D) bf16."""
    global BWD_LAUNCHES
    t, d, m, o = _prep(x, ln_scale, ln_bias, w1, b1, w2, dy=dy)
    lib = _lib()
    dx = torch.empty_like(o["x"])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.apvt_ln_mlp_bwd(o["x"].data_ptr(), o["ln_scale"].data_ptr(), o["ln_bias"].data_ptr(),
                             o["w1"].data_ptr(), o["b1"].data_ptr(), o["w2"].data_ptr(),
                             o["dy"].data_ptr(), dx.data_ptr(), t, d, m, float(eps), stream)
    _raise_on(rc, lib, "ln_mlp backward")
    BWD_LAUNCHES += 1
    return dx


class _LnMlp(torch.autograd.Function):
    """The kernel pair as one differentiable op over token rows (T, D); the
    plain versions on CPU tensors. Saves its inputs, recomputes the rest."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2)
        fwd = ln_mlp_reference if x.device.type == "cpu" else fused_ln_mlp_fwd
        return fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)

    @staticmethod
    def backward(ctx, dy):
        x, ln_scale, ln_bias, w1, b1, w2, b2 = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            bwd = ln_mlp_bwd_reference if x.device.type == "cpu" else fused_ln_mlp_bwd
            dx = bwd(x, ln_scale, ln_bias, w1, b1, w2, dy, ctx.eps)
        needs = ctx.needs_input_grad[1:7]
        grads = (ln_mlp_param_grads(x, ln_scale, ln_bias, w1, b1, w2, b2, dy, ctx.eps, needs)
                 if any(needs) else (None,) * 6)
        return (dx, *grads, None)


def ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """``gelu(LN(x) @ w1 + b1) @ w2 + b2`` over ``x`` ``(..., D)``: the kernels
    for CUDA tensors (forward and input gradient), the plain versions on the CPU."""
    d = x.shape[-1]
    y = _LnMlp.apply(x.reshape(-1, d).contiguous(), ln_scale, ln_bias, w1, b1, w2, b2, eps)
    return y.reshape(x.shape)
