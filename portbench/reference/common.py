"""Plain PyTorch building blocks of the references, shared by every family.

Everything here is written from the published model descriptions in plain
``torch`` operations, in float32, and imports nothing of the program under
test. Products run with TF32 off (:func:`exact_matmuls`), so an f32 product
is an f32 product on the card too.

``lowp="fp8"`` turns every product of a forward pass and of its backward
pass into a product of float8 (e4m3) operands, each row (or column) scaled to
the format's largest value, accumulated in f32: the benchmark's control, the
reference computed one precision below the bf16 the configurations state.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3 value
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def exact_matmuls():
    """f32 products in f32 inside the block (TF32 off), restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to :data:`FP8_MAX`), back in f32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8MatMul(torch.autograd.Function):
    """``a @ b`` over float8 operands (rows of ``a``, columns of ``b``), and
    its two backward products over float8 operands too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(fp8_round(a, -1), fp8_round(b, -2))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = torch.matmul(fp8_round(g, -1), fp8_round(b.transpose(-1, -2), -2))
        db = torch.matmul(fp8_round(a.transpose(-1, -2), -1), fp8_round(g, -2))
        return _unbroadcast(da, a.shape), _unbroadcast(db, b.shape)


def _unbroadcast(g: torch.Tensor, shape) -> torch.Tensor:
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


def matmul(a: torch.Tensor, b: torch.Tensor, lowp: str | None = None) -> torch.Tensor:
    """``a @ b`` in f32, or over float8 operands with ``lowp="fp8"``."""
    if lowp is None:
        return torch.matmul(a, b)
    if lowp != "fp8":
        raise ValueError(f"lowp {lowp!r}: None or 'fp8'")
    return _Fp8MatMul.apply(a, b)


def dense(p: dict, x: torch.Tensor, lowp=None, lora=None) -> torch.Tensor:
    """``x @ w + b`` with ``w`` stored (in, out); ``lora``: ``(a, b, scale,
    mask)`` of an unmerged adapter, ``mask`` the dropout multiplier of the
    adapter branch's input or None."""
    y = matmul(x, p["w"], lowp)
    if lora is not None:
        a, b, s, mask = lora
        xb = x if mask is None else x * mask
        y = y + s * matmul(matmul(xb, a, lowp), b, lowp)
    return y + p["b"] if "b" in p else y


def layer_norm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU of BERT, ViT and Swin."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def softmax_attention(q, k, v, scale: float, add=None, lowp=None) -> torch.Tensor:
    """softmax(q kᵀ · scale + add) v over the last two axes."""
    s = matmul(q, k.transpose(-1, -2), lowp) * scale
    if add is not None:
        s = s + add
    return matmul(torch.softmax(s, dim=-1), v, lowp)


def unit_images(u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> f32 in [0, 1], the quotient correctly rounded."""
    return u8.to(torch.float32) / torch.full((), 255.0, device=u8.device)


def normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def sub(flat: dict, prefix: str) -> dict:
    """The leaves under ``prefix/`` of a flat '/'-path tree, prefix removed."""
    n = len(prefix) + 1
    return {p[n:]: v for p, v in flat.items() if p.startswith(prefix + "/")}


def layer(flat: dict, index) -> dict:
    """Layer ``index`` of leaves stacked on their leading axes."""
    return {p: v[index] for p, v in flat.items()}


def pgd(forward, x0: torch.Tensor, labels: torch.Tensor, noise: torch.Tensor, *,
        eps: float, alpha: float, steps: int) -> torch.Tensor:
    """L-inf PGD (Madry et al.) with a random start: ``x += alpha·sign(∇x
    CE_sum)``, each step projected onto the eps-ball around ``x0`` intersected
    with [0, 1]. ``forward(unit images) -> logits``; ``noise`` the start."""
    lo, hi = (x0 - eps).clamp_min(0.0), (x0 + eps).clamp_max(1.0)
    x = torch.clamp(x0 + noise, lo, hi)
    for _ in range(steps):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            loss = F.cross_entropy(forward(xg), labels, reduction="sum")
            (g,) = torch.autograd.grad(loss, xg)
        x = torch.clamp(x + alpha * torch.sign(g), lo, hi).detach()
    return x
