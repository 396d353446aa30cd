"""Fused MLP over token rows, with and without the LayerNorm folded in: the
CUDA kernels (forward and input gradient), the parameter gradients, the plain
versions.

Counterpart of the JAX package's ``kernels/mlp.py``: :func:`ln_mlp` is its
``fused_ln_mlp``, ``gelu(LN(x) @ w1 + b1) @ w2 + b2`` for ``x`` ``(..., D)``,
``w1`` ``(D, M)``, ``w2`` ``(M, D)``, the pre-residual MLP half-block of
ConvNeXt (and of a ViT block) with the LayerNorm folded in; :func:`mlp` is
its ``fused_mlp``, the same without the LayerNorm (``h = x``, ``dx = dhid``),
for a block whose LayerNorm stays outside. One device code serves both
(``csrc/ln_mlp.cu``, a template flag). The hidden activation never reaches
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

The parameter gradients (:func:`ln_mlp_param_grads`: ``w1``, ``b1``, ``w2``,
``b2``, LN scale and bias; :func:`mlp_param_grads`: the first four) are a
plain recompute with the same rounding points, each returned in its
parameter's dtype, taken only for the inputs autograd asks for; the attack
path and a frozen base ask for none. ``PARAM_GRAD_CALLS`` and
``MLP_PARAM_GRAD_CALLS`` count those recomputes.

Dispatch (:func:`ln_mlp`, :func:`mlp`): one ``autograd.Function`` each for
both devices; CPU tensors take the plain versions in forward and backward,
CUDA tensors launch the kernels (``csrc/ln_mlp.cu``) or raise. The kernels take bf16 only, D in
``KERNEL_DIMS`` and M a multiple of ``HIDDEN_MULTIPLE``. Inside the library
the shape picks the device code (:func:`kernel_variant` is the same test in
Python): the ``wgmma`` kernels (TMA-fed ring of weight slabs, 64 token rows
per pass, a cluster of two CTAs splitting D at D >= 512) take every shape
but D >= 512 with M not a multiple of 256 and the LayerNorm-fused forward at
D = 128 (measured 3% slower there), which keep the first, ``mma.sync``
kernels (``csrc/ln_mlp_mma.cuh``). A model calls
:func:`ln_mlp` only with bf16 compute (the JAX dtype gate: with f32 compute
its block runs the library composition) and lets an unsupported width raise.
``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count the LN-fused kernels' launches,
``MLP_FWD_LAUNCHES`` and ``MLP_BWD_LAUNCHES`` the plain fused MLP's.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.nn import _mm_f32
from . import ln_bwd_f32, ln_fwd_f32

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
PARAM_GRAD_CALLS = 0
MLP_FWD_LAUNCHES = 0
MLP_BWD_LAUNCHES = 0
MLP_PARAM_GRAD_CALLS = 0

KERNEL_DIMS = (128, 256, 384, 512, 768, 1024)
HIDDEN_MULTIPLE = 128
CLUSTER_MIN_DIM = 512  # from this width on a cluster of two CTAs splits D ...
CLUSTER_HIDDEN_MULTIPLE = 256  # ... and a hidden chunk is 128 columns per CTA of the cluster
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


def mlp_reference(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel without LayerNorm (differentiable)."""
    cd = x.dtype
    pre = _mm_f32(x, w1.to(cd)) + b1.float()
    y = _mm_f32(_gelu_f32(pre).to(cd), w2.to(cd)) + b2.float()
    return y.to(cd)


def mlp_bwd_reference(x, w1, b1, w2, dy) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel without LayerNorm: dx in ``x``'s dtype."""
    cd = x.dtype
    w1c = w1.to(cd)
    pre = _mm_f32(x, w1c) + b1.float()
    dh = _mm_f32(dy.to(cd), w2.to(cd).t())
    dpre = (dh * _gelu_grad_f32(pre)).to(cd)
    return _mm_f32(dpre, w1c.t()).to(cd)


def mlp_param_grads(x, w1, b1, w2, b2, dy, needs) -> tuple:
    """``(dw1, db1, dw2, db2)`` by plain recompute with the kernels' rounding
    points, each in its parameter's dtype; ``None`` where ``needs`` (four
    flags in that order) is false."""
    global MLP_PARAM_GRAD_CALLS
    MLP_PARAM_GRAD_CALLS += 1
    cd = x.dtype
    d = x.shape[-1]
    x2, g2 = x.reshape(-1, d), dy.reshape(-1, d).to(cd)
    pre = _mm_f32(x2, w1.to(cd)) + b1.float()
    out = [None] * 4
    if needs[0] or needs[1]:
        dpre = _mm_f32(g2, w2.to(cd).t()) * _gelu_grad_f32(pre)
        if needs[0]:
            out[0] = _mm_f32(x2.t(), dpre.to(cd)).to(w1.dtype)
        if needs[1]:
            out[1] = dpre.sum(0).to(b1.dtype)
    if needs[2]:
        out[2] = _mm_f32(_gelu_f32(pre).to(cd).t(), g2).to(w2.dtype)
    if needs[3]:
        out[3] = g2.float().sum(0).to(b2.dtype)
    return tuple(out)


# --- the CUDA kernels ---------------------------------------------------------

def _lib():
    from . import _build

    lib = _build.load(_SOURCE)
    if not getattr(lib, "_apvt_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn in (lib.apvt_ln_mlp_fwd, lib.apvt_ln_mlp_bwd):
            fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, f, p]
            fn.restype = i
        for fn in (lib.apvt_mlp_fwd, lib.apvt_mlp_bwd):
            fn.argtypes = [p, p, p, p, p, p, i, i, i, p]
            fn.restype = i
        lib.apvt_ln_mlp_ln_rows.argtypes = [p, p, p, p, p, i, i, f, p]
        lib.apvt_ln_mlp_ln_rows.restype = i
        lib.apvt_ln_mlp_error_string.argtypes = [i]
        lib.apvt_ln_mlp_error_string.restype = ctypes.c_char_p
        lib._apvt_typed = True
    return lib


def kernel_variant(d: int, m: int, what: str = "mlp_fwd") -> str:
    """Which device code of ``csrc/ln_mlp.cu`` a width ``d`` with hidden width
    ``m`` takes for ``what`` (``"ln_mlp_fwd"``, ``"ln_mlp_bwd"``, ``"mlp_fwd"``
    or ``"mlp_bwd"``); the same test as its C launcher, nothing else chooses:
    ``"wgmma"`` or ``"mma_sync"``. Raises on what no kernel takes."""
    if d not in KERNEL_DIMS:
        raise ValueError(f"width {d} unsupported by the CUDA kernel (takes {KERNEL_DIMS})")
    if m < HIDDEN_MULTIPLE or m % HIDDEN_MULTIPLE:
        raise ValueError(f"hidden width {m} unsupported by the CUDA kernel "
                         f"(takes multiples of {HIDDEN_MULTIPLE})")
    if d >= CLUSTER_MIN_DIM and m % CLUSTER_HIDDEN_MULTIPLE:
        return "mma_sync"
    if what == "ln_mlp_fwd" and d == 128:
        return "mma_sync"  # measured 3% slower on wgmma at the ConvNeXt-B stage-1 shape
    return "wgmma"


def _prep(x, w1, b1, w2, *, ln=None, b2=None, dy=None):
    """Validate, and cast the parameters as the kernels want them: LN rows
    (``ln`` = ``(scale, bias)``, absent for the plain MLP) and biases f32,
    weights bf16, all contiguous. Returns ``(T, D, M, operands)``."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"dtype {x.dtype} unsupported by the CUDA kernel (takes bfloat16)")
    if x.dim() != 2:
        raise ValueError(f"the fused MLP wants token rows (T, D), got {tuple(x.shape)}")
    t, d = x.shape
    m = w1.shape[-1]
    if d not in KERNEL_DIMS:
        raise ValueError(f"width {d} unsupported by the CUDA kernel (takes {KERNEL_DIMS})")
    if tuple(w1.shape) != (d, m) or tuple(w2.shape) != (m, d) or m % HIDDEN_MULTIPLE or m == 0:
        raise ValueError(f"weights {tuple(w1.shape)} / {tuple(w2.shape)} do not fit width {d} "
                         f"with a hidden width that is a multiple of {HIDDEN_MULTIPLE}")
    rows = {"b1": (b1, m)}
    if ln is not None:
        rows.update(ln_scale=(ln[0], d), ln_bias=(ln[1], d))
    if b2 is not None:
        rows["b2"] = (b2, d)
    if any(tuple(r.shape) != (n,) for r, n in rows.values()):
        raise ValueError("LayerNorm rows and biases do not fit the weights")
    if dy is not None and (tuple(dy.shape) != (t, d) or dy.dtype != x.dtype):
        raise ValueError("the cotangent must be (T, D) in x's dtype")
    ops = {"x": x, "w1": w1.to(torch.bfloat16), "w2": w2.to(torch.bfloat16),
           **{k: r.float() for k, (r, _) in rows.items()}}
    if dy is not None:
        ops["dy"] = dy
    ops = {k: v.contiguous() for k, v in ops.items()}
    for v in ops.values():
        if not v.is_cuda or v.device != x.device:
            raise ValueError("the fused MLP's operands must share one CUDA device")
        if v.data_ptr() % 16:
            raise ValueError("the fused MLP's operands must be 16-byte aligned")
    return t, d, m, ops


def _raise_on(code: int, lib, what: str) -> None:
    if code == -1:
        raise ValueError(f"{what}: unsupported shape")
    if code == -2:
        raise RuntimeError(f"{what}: no tensor map could be encoded for these operands")
    if code != 0:
        msg = lib.apvt_ln_mlp_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def fused_ln_mlp_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors: x (T, D) bf16 -> (T, D) bf16."""
    global FWD_LAUNCHES
    t, d, m, o = _prep(x, w1, b1, w2, ln=(ln_scale, ln_bias), b2=b2)
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
    t, d, m, o = _prep(x, w1, b1, w2, ln=(ln_scale, ln_bias), dy=dy)
    lib = _lib()
    dx = torch.empty_like(o["x"])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.apvt_ln_mlp_bwd(o["x"].data_ptr(), o["ln_scale"].data_ptr(), o["ln_bias"].data_ptr(),
                             o["w1"].data_ptr(), o["b1"].data_ptr(), o["w2"].data_ptr(),
                             o["dy"].data_ptr(), dx.data_ptr(), t, d, m, float(eps), stream)
    _raise_on(rc, lib, "ln_mlp backward")
    BWD_LAUNCHES += 1
    return dx


def fused_mlp_fwd(x, w1, b1, w2, b2) -> torch.Tensor:
    """Launch the forward kernel without LayerNorm: x (T, D) bf16 -> (T, D) bf16."""
    global MLP_FWD_LAUNCHES
    t, d, m, o = _prep(x, w1, b1, w2, b2=b2)
    lib = _lib()
    out = torch.empty_like(o["x"])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.apvt_mlp_fwd(o["x"].data_ptr(), o["w1"].data_ptr(), o["b1"].data_ptr(),
                          o["w2"].data_ptr(), o["b2"].data_ptr(), out.data_ptr(), t, d, m, stream)
    _raise_on(rc, lib, "mlp forward")
    MLP_FWD_LAUNCHES += 1
    return out


def fused_mlp_bwd(x, w1, b1, w2, dy) -> torch.Tensor:
    """Launch the backward kernel without LayerNorm: dx (T, D) bf16."""
    global MLP_BWD_LAUNCHES
    t, d, m, o = _prep(x, w1, b1, w2, dy=dy)
    lib = _lib()
    dx = torch.empty_like(o["x"])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.apvt_mlp_bwd(o["x"].data_ptr(), o["w1"].data_ptr(), o["b1"].data_ptr(),
                          o["w2"].data_ptr(), o["dy"].data_ptr(), dx.data_ptr(), t, d, m, stream)
    _raise_on(rc, lib, "mlp backward")
    MLP_BWD_LAUNCHES += 1
    return dx


def kernel_ln_rows(x, ln_scale, ln_bias, eps: float) -> tuple:
    """The LN-fused kernels' LayerNorm prologue alone on CUDA tensors: ``(h,
    mean, rstd)``, h (T, D) bf16 as the kernels hand it to their first
    product, mean and rstd (T,) f32. Uncounted; reachable from nothing but
    ``chip_smoke.py`` and ``tools/ln_prologue_diagnose.py``, which hold it
    against the plain version's. (The weights ``_prep`` checks are stand-ins.)"""
    t, d, _, o = _prep(x, torch.empty(x.shape[-1], HIDDEN_MULTIPLE, device=x.device),
                       torch.empty(HIDDEN_MULTIPLE, device=x.device),
                       torch.empty(HIDDEN_MULTIPLE, x.shape[-1], device=x.device),
                       ln=(ln_scale, ln_bias))
    lib = _lib()
    h = torch.empty_like(o["x"])
    stats = torch.empty(2, t, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.apvt_ln_mlp_ln_rows(o["x"].data_ptr(), o["ln_scale"].data_ptr(),
                                 o["ln_bias"].data_ptr(), h.data_ptr(), stats.data_ptr(), t, d,
                                 float(eps), stream)
    _raise_on(rc, lib, "ln_mlp LayerNorm prologue")
    return h, stats[0], stats[1]


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


class _Mlp(torch.autograd.Function):
    """The pair without LayerNorm as one differentiable op over token rows."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        fwd = mlp_reference if x.device.type == "cpu" else fused_mlp_fwd
        return fwd(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            bwd = mlp_bwd_reference if x.device.type == "cpu" else fused_mlp_bwd
            dx = bwd(x, w1, b1, w2, dy)
        needs = ctx.needs_input_grad[1:5]
        grads = mlp_param_grads(x, w1, b1, w2, b2, dy, needs) if any(needs) else (None,) * 4
        return (dx, *grads)


def ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """``gelu(LN(x) @ w1 + b1) @ w2 + b2`` over ``x`` ``(..., D)``: the kernels
    for CUDA tensors (forward and input gradient), the plain versions on the CPU."""
    d = x.shape[-1]
    y = _LnMlp.apply(x.reshape(-1, d).contiguous(), ln_scale, ln_bias, w1, b1, w2, b2, eps)
    return y.reshape(x.shape)


def mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """``gelu(x @ w1 + b1) @ w2 + b2`` over ``x`` ``(..., D)``: the kernels for
    CUDA tensors (forward and input gradient), the plain versions on the CPU."""
    d = x.shape[-1]
    y = _Mlp.apply(x.reshape(-1, d).contiguous(), w1, b1, w2, b2)
    return y.reshape(x.shape)
