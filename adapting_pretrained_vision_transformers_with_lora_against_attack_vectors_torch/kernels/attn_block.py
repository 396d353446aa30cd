"""Fused attention half-block of a ViT layer: the CUDA kernels (forward and
input gradient), the parameter gradients, the plain versions.

Counterpart of the JAX package's ``kernels/attn_block.py:fused_attn_block``:
``LN1 -> q/k/v dense -> multi-head attention -> o dense`` for ``x``
``(B, N, C)``, the pre-residual attention half of a ViT block (the caller
adds the residual). The normalised rows, q, k, v and the probabilities never
reach device memory; the attention output before the o-projection (and, in
the backward, dq/dk/dv) take one round trip through a bf16 scratch tensor,
because the o-projection contracts over all heads while the kernel works a
head per thread block (``csrc/attn_block.cu``).

Numerics (kernels and plain versions alike, ``cd`` = ``x``'s dtype): LN in
f32 (two-pass mean/var), rounded to ``cd``; each projection with operands in
``cd``, f32 accumulation, ``+ bias`` in f32, rounded to ``cd``; scores in f32
scaled by ``hd**-0.5``, max-subtracted f32 softmax, P rounded to ``cd``
before ``P @ v`` (f32 accumulation); the attention output rounded to ``cd``
before the o-projection. Backward (dx only in the kernel): everything up to P
recomputed; ``da = dy @ wo^T`` rounded to ``cd``; the softmax-attention
backward of ``kernels/attention.py`` (dS rounded to ``cd``); dq, dk, dv
rounded to ``cd``; ``dh = dq @ wq^T + dk @ wk^T + dv @ wv^T`` in f32 into the
f32 LayerNorm backward; dx rounded once. Against ``ops.nn.attention`` the
scores stay f32 here (that function rounds the stored scores to ``cd``
first), as in the packed-attention kernel.

The ten parameter gradients (:func:`attn_block_param_grads`: LN scale and
bias, four weights, four biases) are a plain recompute with the same rounding
points, each in its parameter's dtype, taken only for the inputs autograd
asks for; the attack path asks for none. ``PARAM_GRAD_CALLS`` counts those
recomputes.

Dispatch (:func:`attn_block`): one ``autograd.Function`` for both devices;
CPU tensors take the plain versions in forward and backward, CUDA tensors
launch the kernels or raise. The kernels take bf16 only, head dim 64, C in
``KERNEL_DIMS`` and 1 <= N <= 256 (:func:`supported_shape`; the Hopper
kernels' shared memory, :func:`_smem_bytes`, does not depend on N, so the
backward takes every N the forward does: the first port's stopped at 208
for C = 768); anything else raises before any launch. Every supported shape
runs the Hopper device code (:func:`kernel_variant`, the same test as the C
launcher). A model calls :func:`attn_block` only with bf16 compute and only
where the four denses carry no LoRA factors. ``FWD_LAUNCHES`` and
``BWD_LAUNCHES`` count kernel calls (each is two launches in a row: the
per-head kernel and the row-block kernel behind the scratch tensor).
:func:`mma_sync_fwd` / :func:`mma_sync_bwd` run the first port's
``mma.sync`` device code at the ViT-B width, uncounted, for timing the two
designs against each other; no model path calls them.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.nn import _mm_f32
from . import ln_bwd_f32, ln_fwd_f32
from .attention import _merge, _probs, _split, attention_bwd_reference

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
PARAM_GRAD_CALLS = 0

KERNEL_DIMS = (192, 384, 768)
HEAD_DIM = 64
MAX_SEQ = 256
_MAX_SMEM = 232448  # bytes of shared memory a thread block can opt in to
_SOURCE = "attn_block.cu"


def _proj(h_cd, w, b):
    """``ops.nn.dense`` numerics: cd x cd -> f32 accumulation, f32 bias, -> cd."""
    return (_mm_f32(h_cd, w.to(h_cd.dtype)) + b.float()).to(h_cd.dtype)


def _forward_parts(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, heads: int, eps: float):
    """LN, the head-major q/k/v and the f32 probabilities."""
    cd = x.dtype
    normed, rstd, h = ln_fwd_f32(x.float(), ln_scale, ln_bias, eps)
    h_cd = h.to(cd)
    qh, kh, vh = (_split(_proj(h_cd, w, b), heads) for w, b in ((wq, bq), (wk, bk), (wv, bv)))
    p = _probs(qh, kh, qh.shape[-1] ** -0.5)
    return normed, rstd, h_cd, qh, kh, vh, p


def attn_block_reference(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
                         eps: float) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (differentiable)."""
    cd = x.dtype
    _, _, _, _, _, vh, p = _forward_parts(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, heads, eps)
    a = _merge(torch.matmul(p.to(cd).float(), vh.float()).to(cd))
    return _proj(a, wo, bo)


def _backward_parts(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, dy, heads: int, eps: float):
    """The recompute both backward functions share: LN statistics, the
    normalised rows, the attention output, and packed dq, dk, dv in ``cd``."""
    cd = x.dtype
    normed, rstd, h_cd, qh, kh, vh, p = _forward_parts(
        x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, heads, eps)
    a = _merge(torch.matmul(p.to(cd).float(), vh.float()).to(cd))
    da = _mm_f32(dy.to(cd), wo.to(cd).t()).to(cd)
    dq, dk, dv = (_merge(g) for g in attention_bwd_reference(qh, kh, vh, _split(da, heads)))
    return normed, rstd, h_cd, a, dq, dk, dv


def _dh_f32(dq, dk, dv, wq, wk, wv):
    cd = dq.dtype
    return (_mm_f32(dq, wq.to(cd).t()) + _mm_f32(dk, wk.to(cd).t()) + _mm_f32(dv, wv.to(cd).t()))


def attn_block_bwd_reference(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, dy, heads: int,
                             eps: float) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: dx in ``x``'s dtype."""
    normed, rstd, _, _, dq, dk, dv = _backward_parts(
        x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, dy, heads, eps)
    return ln_bwd_f32(_dh_f32(dq, dk, dv, wq, wk, wv), ln_scale, normed, rstd).to(x.dtype)


def attn_block_param_grads(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, dy, heads: int,
                           eps: float, needs) -> tuple:
    """``(dscale, dbias, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo)`` by plain
    recompute with the kernels' rounding points, each in its parameter's
    dtype; ``None`` where ``needs`` (ten flags in that order) is false."""
    global PARAM_GRAD_CALLS
    PARAM_GRAD_CALLS += 1
    cd, c = x.dtype, x.shape[-1]
    g = dy.to(cd)
    normed, _, h_cd, a, dq, dk, dv = _backward_parts(
        x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, g, heads, eps)
    out = [None] * 10
    if needs[0] or needs[1]:
        # the cotangent of the normalised rows in cd, as the rows are
        dh = _dh_f32(dq, dk, dv, wq, wk, wv).to(cd).float()
        if needs[0]:
            out[0] = (dh * normed).reshape(-1, c).sum(0).to(ln_scale.dtype)
        if needs[1]:
            out[1] = dh.reshape(-1, c).sum(0).to(ln_bias.dtype)
    h2 = h_cd.reshape(-1, c)
    for i, (d, w, b) in enumerate(((dq, wq, bq), (dk, wk, bk), (dv, wv, bv))):
        d2 = d.reshape(-1, c)
        if needs[2 + 2 * i]:
            out[2 + 2 * i] = _mm_f32(h2.t(), d2).to(w.dtype)
        if needs[3 + 2 * i]:
            out[3 + 2 * i] = d2.float().sum(0).to(b.dtype)
    g2 = g.reshape(-1, c)
    if needs[8]:
        out[8] = _mm_f32(a.reshape(-1, c).t(), g2).to(wo.dtype)
    if needs[9]:
        out[9] = g2.float().sum(0).to(bo.dtype)
    return tuple(out)


# --- the CUDA kernels ---------------------------------------------------------

_TILE = 64 * 64 * 2          # bytes of a swizzled 64 x 64 bf16 tile
_STAGE = 2 * _TILE + 3 * _TILE  # a ring stage: 128 rows x 64 of x beside a 64 x 192 weight slab


def _smem_bytes(n: int, c: int, backward: bool) -> int:
    """Shared memory of the per-head kernel (``HeadsCfg`` in the source): the
    alignment slack, the Q (2 forward, 4 backward), K, V (and da) tiles of
    the head's 256 padded rows, the ring (3 stages forward, 2 backward), the
    row statistics and the ring's barriers. The same at every ``n`` <= 256
    and every ``c``."""
    stages, tiles = (2, 4 + 4 + 4 + 4) if backward else (3, 2 + 4 + 4)
    stats = (768 if backward else 256) * 4
    return 1024 + tiles * _TILE + stages * _STAGE + stats + 16 * stages


def supported_shape(n: int, c: int, heads: int, *, backward: bool = True) -> bool:
    """Do the kernels take (N, C) with ``heads`` heads (by default: both of them)?"""
    return (c in KERNEL_DIMS and heads * HEAD_DIM == c and 1 <= n <= MAX_SEQ
            and _smem_bytes(n, c, backward) <= _MAX_SMEM)


def kernel_variant(n: int, c: int, heads: int) -> str:
    """Which device code of ``csrc/attn_block.cu`` a shape takes (the same
    test as its C launcher; nothing else chooses): ``"wgmma"`` at every shape
    the kernels take. Raises on what they do not take."""
    if not supported_shape(n, c, heads):
        raise ValueError(f"shape (N={n}, C={c}, heads={heads}) unsupported by the CUDA kernel "
                         f"(takes C in {KERNEL_DIMS} with head dim {HEAD_DIM}, 1 <= N <= {MAX_SEQ})")
    return "wgmma"


def _lib():
    from . import _build

    lib = _build.load(_SOURCE)
    if not getattr(lib, "_apvt_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.apvt_attn_block_fwd.argtypes = [p] * 13 + [i, i, i, i, f, p]
        lib.apvt_attn_block_fwd.restype = i
        lib.apvt_attn_block_bwd.argtypes = [p] * 15 + [i, i, i, i, f, p]
        lib.apvt_attn_block_bwd.restype = i
        lib.apvt_attn_block_fwd_mma_sync.argtypes = lib.apvt_attn_block_fwd.argtypes
        lib.apvt_attn_block_fwd_mma_sync.restype = i
        lib.apvt_attn_block_bwd_mma_sync.argtypes = lib.apvt_attn_block_bwd.argtypes
        lib.apvt_attn_block_bwd_mma_sync.restype = i
        lib.apvt_attn_block_error_string.argtypes = [i]
        lib.apvt_attn_block_error_string.restype = ctypes.c_char_p
        lib._apvt_typed = True
    return lib


def _prep(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, heads: int, *, bo=None, dy=None):
    """Validate, and cast the parameters as the kernels want them: LN rows
    and biases f32, weights bf16, all contiguous. Returns ``(B, N, C, operands)``."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"dtype {x.dtype} unsupported by the CUDA kernel (takes bfloat16)")
    if x.dim() != 3:
        raise ValueError(f"attn_block wants (B, N, C), got {tuple(x.shape)}")
    b, n, c = x.shape
    if not supported_shape(n, c, heads, backward=dy is not None):
        raise ValueError(f"shape (N={n}, C={c}, heads={heads}) unsupported by the CUDA kernel "
                         f"(takes C in {KERNEL_DIMS} with head dim {HEAD_DIM}, 1 <= N <= "
                         f"{MAX_SEQ}, in {_MAX_SMEM} bytes of shared memory)")
    weights = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    rows = {"ln_scale": ln_scale, "ln_bias": ln_bias, "bq": bq, "bk": bk, "bv": bv}
    if bo is not None:
        rows["bo"] = bo
    if (any(tuple(w.shape) != (c, c) for w in weights.values())
            or any(tuple(r.shape) != (c,) for r in rows.values())):
        raise ValueError("attn_block weights must be (C, C), LayerNorm rows and biases (C,)")
    if dy is not None and (dy.shape != x.shape or dy.dtype != x.dtype):
        raise ValueError("the cotangent must have x's shape and dtype")
    ops = {"x": x, **{k: w.to(torch.bfloat16) for k, w in weights.items()},
           **{k: r.float() for k, r in rows.items()}}
    if dy is not None:
        ops["dy"] = dy
    ops = {k: v.contiguous() for k, v in ops.items()}
    for v in ops.values():
        if not v.is_cuda or v.device != x.device:
            raise ValueError("attn_block operands must share one CUDA device")
        if v.data_ptr() % 16:
            raise ValueError("attn_block operands must be 16-byte aligned")
    return b, n, c, ops


def _raise_on(code: int, lib, what: str) -> None:
    if code == -1:
        raise ValueError(f"{what}: unsupported shape")
    if code == -2:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled refused a TMA tensor map")
    if code == -3:
        raise RuntimeError(f"{what}: the compiled kernel holds fewer registers than its "
                           f"warpgroups' setmaxnreg split needs")
    if code != 0:
        msg = lib.apvt_attn_block_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _launch_fwd(entry: str, x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
                eps: float) -> torch.Tensor:
    b, n, c, o = _prep(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, heads, bo=bo)
    lib = _lib()
    scratch, out = torch.empty_like(o["x"]), torch.empty_like(o["x"])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [o[k].data_ptr() for k in ("x", "ln_scale", "ln_bias", "wq", "bq", "wk", "bk", "wv",
                                      "bv", "wo", "bo")]
    rc = getattr(lib, entry)(*ptrs, scratch.data_ptr(), out.data_ptr(), b, n, c, heads,
                             float(eps), stream)
    _raise_on(rc, lib, "attn_block forward")
    return out


def _launch_bwd(entry: str, x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, dy, heads: int,
                eps: float) -> torch.Tensor:
    b, n, c, o = _prep(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, heads, dy=dy)
    lib = _lib()
    dq, dk, dv, dx = (torch.empty_like(o["x"]) for _ in range(4))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [o[k].data_ptr() for k in ("x", "ln_scale", "ln_bias", "wq", "bq", "wk", "bk", "wv",
                                      "bv", "wo", "dy")]
    rc = getattr(lib, entry)(*ptrs, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dx.data_ptr(),
                             b, n, c, heads, float(eps), stream)
    _raise_on(rc, lib, "attn_block backward")
    return dx


def fused_attn_block_fwd(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
                         eps: float) -> torch.Tensor:
    """Launch the forward kernels on CUDA tensors: x (B, N, C) bf16 -> (B, N, C) bf16."""
    global FWD_LAUNCHES
    out = _launch_fwd("apvt_attn_block_fwd", x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo,
                      bo, heads, eps)
    FWD_LAUNCHES += 1
    return out


def fused_attn_block_bwd(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, dy, heads: int,
                         eps: float) -> torch.Tensor:
    """Launch the backward kernels on CUDA tensors: dx (B, N, C) bf16."""
    global BWD_LAUNCHES
    dx = _launch_bwd("apvt_attn_block_bwd", x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, dy,
                     heads, eps)
    BWD_LAUNCHES += 1
    return dx


def mma_sync_fwd(*args) -> torch.Tensor:
    """:func:`fused_attn_block_fwd` on the first port's ``mma.sync`` device
    code, at C = 768 and N > 64 only (uncounted; for timing it against the
    Hopper kernels at the ViT-B shape)."""
    return _launch_fwd("apvt_attn_block_fwd_mma_sync", *args)


def mma_sync_bwd(*args) -> torch.Tensor:
    """:func:`fused_attn_block_bwd` on the ``mma.sync`` device code (uncounted;
    raises where its shared memory does not hold the shape)."""
    return _launch_bwd("apvt_attn_block_bwd_mma_sync", *args)


class _AttnBlock(torch.autograd.Function):
    """The kernel pair as one differentiable op over (B, N, C); the plain
    versions on CPU tensors. Saves its inputs, recomputes the rest."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, heads, eps):
        ctx.heads, ctx.eps = heads, eps
        ctx.save_for_backward(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo)
        if x.device.type == "cpu":
            fwd = attn_block_reference
        else:
            # the backward kernel holds one more tile per head: refuse a shape it
            # cannot take before the first launch, not in the middle of autograd
            if ctx.needs_input_grad[0] and x.dim() == 3 and not supported_shape(x.shape[1], x.shape[2], heads):
                raise ValueError(f"shape (N={x.shape[1]}, C={x.shape[2]}, heads={heads}) "
                                 f"unsupported by the CUDA backward kernel")
            fwd = fused_attn_block_fwd
        return fwd(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, heads, eps)

    @staticmethod
    def backward(ctx, dy):
        *inputs, bo = ctx.saved_tensors
        x = inputs[0]
        dy = dy.to(x.dtype).contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            bwd = attn_block_bwd_reference if x.device.type == "cpu" else fused_attn_block_bwd
            dx = bwd(*inputs, dy, ctx.heads, ctx.eps)
        needs = ctx.needs_input_grad[1:11]
        grads = (attn_block_param_grads(*inputs, bo, dy, ctx.heads, ctx.eps, needs)
                 if any(needs) else (None,) * 10)
        return (dx, *grads, None, None)


def attn_block(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
               eps: float) -> torch.Tensor:
    """``MHA(LN(x) wq,k,v) wo + bo`` over ``x`` ``(B, N, C)``: the kernels for
    CUDA tensors (forward and input gradient), the plain versions on the CPU."""
    return _AttnBlock.apply(x.contiguous(), ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                            heads, eps)
