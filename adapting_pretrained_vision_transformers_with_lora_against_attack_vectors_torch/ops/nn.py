"""Primitive neural-net ops over plain param dicts of tensors.

Counterpart of the JAX package's ``ops/nn.py``. A dense layer's dict holds
``w`` stored ``(in, out)`` and an optional ``b``; it may also carry the
unmerged LoRA factors ``lora_a`` ``(in, r)``, ``lora_b`` ``(r, out)`` and the
scalar ``lora_s`` = alpha / r that :func:`..ops.lora.attach` inserts, in
which case :func:`dense` computes ``x @ W + s * (x @ A) @ B + b``.

Matmuls take operands in the compute dtype and accumulate in f32; the
output is rounded to the compute dtype once, at the end, as the JAX
``dense`` does with ``preferred_element_type``. The plain layer fuses the
bias into the GEMM (``F.linear``), whose epilogue adds it in f32 before that
single rounding. With unmerged LoRA factors, ``x @ W``, the LoRA branch and
the bias are summed in f32 and rounded once.

LoRA dropout (training form only): a dict that also carries ``lora_drop``, a
:class:`LoRADropout`, gets inverted dropout on the adapter branch alone; the
frozen ``x @ W`` path sees the undropped input. Mode ``"input"`` masks ``x``
before ``@ A`` (PEFT's ``lora_dropout`` placement), ``"post_a"`` masks the
rank-r projection ``x @ A`` instead (the JAX package's documented variant:
as unbiased, C/r-fold less mask work). Masks come from the object's own
``torch.Generator`` on the tensor's device, so a run is reproducible from its
seed; the streams are not those of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
import torch.nn.functional as F

from ..kernels import layer_norm as ln_kernel
from .quant import int8_matmul

Params = Mapping[str, Any]

DROPOUT_MODES = ("input", "post_a")


@dataclasses.dataclass
class LoRADropout:
    """Inverted dropout for one dense's adapter branch: rate, placement and
    the stream the masks are drawn from."""

    rate: float
    mode: str
    generator: torch.Generator
    # under a mesh (``parallel.mesh``): (this rank's part, parts) of the
    # global draw along the leading (batch) dim and, for a dense whose input
    # is split over the model axis, along the last dim; (0, 1) = all of it
    rows: tuple[int, int] = (0, 1)
    cols: tuple[int, int] = (0, 1)

    def __post_init__(self):
        if self.mode not in DROPOUT_MODES:
            raise ValueError(f"dropout mode {self.mode!r} (takes {DROPOUT_MODES})")
        if not 0.0 <= self.rate < 1.0:
            raise ValueError(f"dropout rate {self.rate} outside [0, 1)")

    def scale(self, shape, device) -> torch.Tensor:
        """f32 multiplier ``mask / keep`` of ``shape``: E[scale] = 1. The mask
        is this rank's block of the mask over the global shape."""
        keep = 1.0 - self.rate
        (r, nr), (c, nc) = self.rows, self.cols
        full = (shape[0] * nr, *shape[1:-1], shape[-1] * nc)
        mask = torch.rand(full, generator=self.generator, device=device) < keep
        mask = mask[r * shape[0]:(r + 1) * shape[0], ..., c * shape[-1]:(c + 1) * shape[-1]]
        return mask.float() / keep


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, *,
               dtype=torch.float32) -> dict:
    """Truncated-normal kernel (+-2 sigma, std 1/sqrt(in)) + zero bias,
    stored as ``(in, out)``."""
    w = torch.empty(in_dim, out_dim, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=generator)
    return {"w": (w * in_dim ** -0.5).to(dtype), "b": torch.zeros(out_dim, dtype=dtype)}


class _MmF32(torch.autograd.Function):
    """``torch.mm(..., out_dtype=float32)`` with a gradient: the f32 cotangent
    is rounded to the operands' dtype, and each operand's gradient is one
    GEMM with f32 accumulation, returned in that dtype."""

    @staticmethod
    def forward(ctx, x2d, w):
        ctx.save_for_backward(x2d, w)
        return torch.mm(x2d, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        gc = g.to(x2d.dtype)
        dx = torch.mm(gc, w.t()) if ctx.needs_input_grad[0] else None
        dw = torch.mm(x2d.t(), gc) if ctx.needs_input_grad[1] else None
        return dx, dw


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as an f32 result, never rounded to the operands' dtype.

    On CUDA the GEMM writes its f32 accumulator (``out_dtype``); on the CPU
    the operands are widened first, which is the same math: a product of two
    bf16 values is exact in f32."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype != torch.float32:
        y = _MmF32.apply(x2d, w)
    else:
        y = torch.mm(x2d.float(), w.float())
    return y.reshape(*lead, w.shape[-1])


def dense(p: Params, x: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    """Linear layer ``x @ W + b`` with the optional unmerged-LoRA branch."""
    cd = compute_dtype or x.dtype
    if "w_q" in p:
        # the W8A8 attack-time path: f32 product and bias, one rounding to cd
        y = int8_matmul(x.to(cd), p["w_q"], p["w_s"])
        if "b" in p:
            y = y + p["b"].float()
        return y.to(cd)
    if "lora_a" not in p:
        return F.linear(x.to(cd), p["w"].to(cd).t(), p["b"].to(cd) if "b" in p else None)
    return dense_f32(p, x, compute_dtype=cd).to(cd)


def dense_f32(p: Params, x: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    """:func:`dense` (float ``w`` only) before its final rounding: operands in
    the compute dtype, the products, the LoRA branch and the bias summed in
    f32. A tensor-parallel row-split projection adds these partial sums up
    across ranks and rounds once (``models.vit``)."""
    cd = compute_dtype or x.dtype
    w = p["w"].to(cd)
    xc = x.to(cd)
    y = _mm_f32(xc, w)
    if "lora_a" not in p:
        return y + p["b"].float() if "b" in p else y
    drop = p.get("lora_drop")
    xb = xc
    if drop is not None and drop.mode == "input":
        xb = xc * drop.scale(xc.shape, xc.device).to(cd)
    xa = _mm_f32(xb, p["lora_a"].to(cd))
    if drop is not None and drop.mode == "post_a":
        xa = xa * drop.scale(xa.shape, xa.device)
    y = y + p["lora_s"].float() * _mm_f32(xa.to(cd), p["lora_b"].to(cd))
    if "b" in p:
        y = y + p["b"].float()
    return y


def layer_norm_init(dim: int, *, dtype=torch.float32) -> dict:
    return {"scale": torch.ones(dim, dtype=dtype), "bias": torch.zeros(dim, dtype=dtype)}


def layer_norm(p: Params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dimension in float32, rounded to the input dtype.

    A tensor on the CPU, an f32 tensor (the kernel takes bf16 alone, by
    design) and an empty one take the plain version: ``F.layer_norm`` on the
    widened input, which on an f32 tensor is ``F.layer_norm`` itself. Every
    other tensor on the card goes to ``kernels/layer_norm``'s one-pass kernel
    (``layer_norm.takes``), which raises on what it does not take."""
    scale, bias = p["scale"], p["bias"]
    if ln_kernel.takes(x):
        return ln_kernel.fused_layer_norm(x, scale, bias, eps)
    return ln_kernel.layer_norm_reference(x, scale, bias, eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multi-head scaled dot-product attention over ``(B, H, N, hd)``.

    As in the JAX package, the scores are stored in the input dtype before
    the f32 softmax, and the probabilities are rounded to it before P.V.
    """
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q, k.transpose(-1, -2))
    probs = torch.softmax(scores.float() * scale, dim=-1)
    return torch.matmul(probs.to(q.dtype), v)
