"""Primitive neural-net ops over plain param dicts of tensors.

Counterpart of the JAX package's ``ops/nn.py``. A dense layer's dict holds
``w`` stored ``(in, out)`` and an optional ``b``; it may also carry the
unmerged LoRA factors ``lora_a`` ``(in, r)``, ``lora_b`` ``(r, out)`` and the
scalar ``lora_s`` = alpha / r that :func:`..ops.lora.attach` inserts, in
which case :func:`dense` computes ``x @ W + s * (x @ A) @ B + b``.

Matmuls run in the compute dtype with f32 accumulation. The bias is added
before the single rounding to the compute dtype: in f32 that is the JAX
order exactly; in bf16 the plain layer fuses the bias into the GEMM
(``F.linear``), whose epilogue adds it in f32 before rounding the output once.
LoRA dropout comes with the training stages.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F

Params = Mapping[str, Any]


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, *,
               dtype=torch.float32) -> dict:
    """Truncated-normal kernel (+-2 sigma, std 1/sqrt(in)) + zero bias,
    stored as ``(in, out)``."""
    w = torch.empty(in_dim, out_dim, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=generator)
    return {"w": (w * in_dim ** -0.5).to(dtype), "b": torch.zeros(out_dim, dtype=dtype)}


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the operands' dtype (f32 accumulation inside the GEMM),
    widened to f32 for the sums that follow."""
    return torch.matmul(x, w).float()


def dense(p: Params, x: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    """Linear layer ``x @ W + b`` with the optional unmerged-LoRA branch."""
    cd = compute_dtype or x.dtype
    w = p["w"].to(cd)
    xc = x.to(cd)
    if "lora_a" not in p:
        return F.linear(xc, w.t(), p["b"].to(cd) if "b" in p else None)
    y = _mm_f32(xc, w)
    xa = _mm_f32(xc, p["lora_a"].to(cd))
    y = y + p["lora_s"].float() * _mm_f32(xa.to(cd), p["lora_b"].to(cd))
    if "b" in p:
        y = y + p["b"].float()
    return y.to(cd)


def layer_norm_init(dim: int, *, dtype=torch.float32) -> dict:
    return {"scale": torch.ones(dim, dtype=dtype), "bias": torch.zeros(dim, dtype=dtype)}


def layer_norm(p: Params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in float32, cast back to the input dtype."""
    out = F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(), p["bias"].float(), eps)
    return out.to(x.dtype)


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
