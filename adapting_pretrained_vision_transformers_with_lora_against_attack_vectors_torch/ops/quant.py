"""W8A8 dynamic quantization for the attack-time forward and backward.

Counterpart of the JAX package's ``ops/quant.py``, with its arithmetic step
for step, so that one quantized tree gives the same int8 operands in both
packages: dense WEIGHTS are quantized to int8 offline (symmetric, one scale
per output channel) and ACTIVATIONS dynamically, one scale per row, inside
the forward, so both operands of each product are int8 and the product is
an exact int32 contraction (``torch._int_mm``, cuBLASLt's int8 GEMM on the
card; the JAX package contracts with ``lax.dot_general`` outside any Pallas
kernel, so a library product is the counterpart here too).

Scope: adversarial generation (gradients with respect to the IMAGES).
Training keeps full precision. The backward's input-gradient product runs in
int8 as well: the weight scales fold into the cotangent before it is
quantized per row. The activation quantizer is straight-through (the
standard W8A8 estimator): ``d/dx [dequant(int8(x)) @ W_q] ~= W^T``. There is
no gradient for ``w_q`` (int8) and a zero one for ``w_s``, as in JAX.

Rounding: ``torch.round`` rounds half to even, as ``jnp.round`` does; f32
division and the int32 -> f32 conversion round to nearest on both devices,
so a CPU and a CUDA run of :func:`int8_matmul` agree bit for bit.

cuBLASLt's int8 GEMM takes more than 16 rows and K and N multiples of 8
(PyTorch's CUDA ``_int_mm`` checks this). :func:`int_mm` pads a shape that
misses these limits with zero rows and columns on every device, which
leaves the int32 result exact, and slices the result back; it never falls
back to a float product. It does the same on every device, so the CPU
tests run the padding and layout code that the card runs.

Usage::

    qtree = quant.quantize_dense_tree(merged_tree, vit.QUANT_TARGETS_DEFAULT)
    model = entry.from_tree(qtree, cfg)   # its denses now run W8A8

``ops.nn.dense`` dispatches on the ``w_q`` leaf, as it does on ``lora_a``.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F

from ..utils import trees

_QMAX = 127.0
_MIN_ROWS = 17  # cuBLASLt's int8 GEMM wants more than 16 rows
_ALIGN = 8  # ... and K and N multiples of 8


def _over_qmax(absmax: torch.Tensor) -> torch.Tensor:
    """``max(absmax, 1e-12) / 127`` rounded once. The divisor is a tensor on
    ``absmax``'s device: CUDA divides by a CPU scalar as a product with its
    reciprocal, which can land one ulp away from the quotient."""
    return torch.clamp(absmax, min=1e-12) / absmax.new_full((), _QMAX)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., in, out) float -> (int8 (..., in, out), f32 per-output-channel
    scales (..., out)): ``w ~= w_q * w_s[..., None, :]``."""
    wf = w.float()
    scale = _over_qmax(wf.abs().amax(dim=-2))
    q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -_QMAX, _QMAX)
    return q.to(torch.int8), scale


def _quantize_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 quantization, one f32 scale per row (the last
    axis is reduced): ``(int8 like x, f32 (..., 1))``."""
    xf = x.float()
    scale = _over_qmax(xf.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(xf / scale), -_QMAX, _QMAX)
    return q.to(torch.int8), scale


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> int32 (M, N) through ``torch._int_mm``.

    ``b`` goes in column-major, as the transposed view of an (N, K) tensor:
    cuBLASLt's int8 GEMM refuses some row-major shapes and runs the ones it
    takes several times slower (``chip_smoke.py`` phase 9 times both). A
    row-major ``b`` is copied once; the backward's ``w_q.t()`` is already
    column-major. A shape that misses the GEMM's limits is zero-padded."""
    (m, k), n = a.shape, b.shape[1]
    mp, kp, np_ = max(m, _MIN_ROWS), _round_up(k, _ALIGN), _round_up(n, _ALIGN)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    bt = b.t()
    if (kp, np_) != (k, n) or not bt.is_contiguous():
        bt = F.pad(bt, (0, kp - k, 0, np_ - n)).contiguous()
    out = torch._int_mm(a.contiguous(), bt.t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def _contract_last(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) x int8 (K, N) -> int32 (..., N)."""
    lead = q.shape[:-1]
    return int_mm(q.reshape(-1, q.shape[-1]), w).reshape(*lead, w.shape[1])


def _forward(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor) -> torch.Tensor:
    q_x, s_x = _quantize_act(x)
    return _contract_last(q_x, w_q).float() * (s_x * w_s)


def _input_grad(g: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """dx = g @ W^T with W = w_q * w_s: the channel scales fold into the
    cotangent, which is quantized per row and contracted in int8."""
    q_g, s_g = _quantize_act(g.float() * w_s)
    return (_contract_last(q_g, w_q.t()).float() * s_g).to(dtype)


class _Int8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_q, w_s):
        ctx.save_for_backward(w_q, w_s)
        ctx.x_dtype = x.dtype
        return _forward(x, w_q, w_s)

    @staticmethod
    def backward(ctx, g):
        w_q, w_s = ctx.saved_tensors
        dx = _input_grad(g, w_q, w_s, ctx.x_dtype) if ctx.needs_input_grad[0] else None
        return dx, None, torch.zeros_like(w_s) if ctx.needs_input_grad[2] else None


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor) -> torch.Tensor:
    """``x @ (w_q * w_s)`` with both product operands int8; f32 output.

    ``x``: (..., in) float; ``w_q``: (in, out) int8; ``w_s``: (out,) f32."""
    return _Int8Matmul.apply(x, w_q, w_s)


# --- tree-level weight quantization ------------------------------------------

QUANT_SKIP_KEYS = ("lora_a", "lora_b", "lora_s", "lora_rng", "lora_rng_pa", "lora_p")


def quantize_dense_tree(params: Mapping[str, Any], targets: tuple[str, ...]):
    """Replace each target dense's ``w`` with ``w_q`` / ``w_s`` leaves.

    ``targets`` are param-root-relative subtree paths, as LoRA addresses them
    (``("blocks/attn/q", "blocks/mlp/fc1")``); stacked (depth, in, out)
    weights get (depth, out) scales. Merge any LoRA adapter first
    (``ops.lora.merge``): an unmerged tree raises, because the int8 product
    would skip the adapter branch."""
    flat = trees.flatten_with_paths(params)
    out = dict(flat)
    for target in targets:
        w_path = f"{target}/w"
        if w_path not in flat:
            raise KeyError(f"quantize target {target!r}: no leaf {w_path!r}")
        for skip in QUANT_SKIP_KEYS:
            if f"{target}/{skip}" in flat:
                raise ValueError(
                    f"quantize target {target!r} carries an unmerged LoRA "
                    f"branch ({skip}); ops.lora.merge it first")
        w_q, w_s = quantize_weight(torch.as_tensor(flat[w_path]))
        del out[w_path]
        out[f"{target}/w_q"] = w_q
        out[f"{target}/w_s"] = w_s
    return trees.unflatten_from_paths(out)
