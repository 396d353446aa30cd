"""Hand-written CUDA kernels and their plain PyTorch versions.

Each wrapper takes the kernel for a CUDA tensor (or raises) and the plain
version only for a tensor on the CPU. Kernels are compiled from ``csrc/`` on
first use, never at import. The two attention kernels are the only attention
path of their backbones; the ConvNeXt kernels (``dwconv``, ``mlp``) are
opt-in fields of ``ConvNeXtConfig`` (``use_dw_kernel``, ``fuse_ln_mlp``), as
in the JAX package, with the library composition as the default. The
LayerNorm kernel (``layer_norm``) replaces no TPU kernel: it takes every bf16
LayerNorm of every backbone on the card (``ops.nn.layer_norm``).

This package root holds the numerics shared by several kernels' plain
versions, as the JAX package's ``kernels/__init__.py`` does: the f32
LayerNorm forward and backward.
"""

from __future__ import annotations

import torch


def ln_fwd_f32(xf: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    """f32 row LayerNorm (two-pass mean/var).

    ``xf``: (..., D) float32; ``scale``/``bias``: broadcastable rows of any
    dtype. Returns ``(normed, rstd, h_f32)`` so a backward can reuse the
    normalised rows."""
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    normed = xc * rstd
    return normed, rstd, normed * scale.float() + bias.float()


def ln_bwd_f32(dh: torch.Tensor, scale: torch.Tensor, normed: torch.Tensor,
               rstd: torch.Tensor) -> torch.Tensor:
    """Input gradient of :func:`ln_fwd_f32`:
    ``dx = rstd * (dn - mean(dn) - normed * mean(dn * normed))``."""
    dn = dh * scale.float()
    m1 = dn.mean(dim=-1, keepdim=True)
    m2 = (dn * normed).mean(dim=-1, keepdim=True)
    return rstd * (dn - m1 - normed * m2)
