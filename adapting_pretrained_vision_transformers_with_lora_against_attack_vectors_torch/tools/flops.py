"""Operations of the ViT programs the measurement tools time, counted from the
config's shapes: the yardstick of every MFU the port reports.

The JAX tools carry constants reckoned for the TPU kernel, which pads the 197
tokens of ViT-B/16 to 256 (``bench.py``'s 0.86 TF an image for PGD-10). This
count takes the config's own N (the patches and the CLS token) with no
padding, so that every variant of a program reads one yardstick. A
multiply-add is two operations. Per image:

* a dense of (in, out) over R rows: 2·R·in·out, forward, input gradient and
  weight gradient alike; the patch embedding runs over the patches, the
  blocks over N tokens, the head over the CLS token;
* the attention core: 4·N²·D forward (QKᵀ and PV over every head), 8·N²·D
  backward (dV, dP, dQ, dK);
* a rank-r LoRA branch on a target dense: 2·R·r·(in + out) for each of the
  forward, the input gradient and the factors' gradient.

The backward passes: ``input`` is the attack's (the gradient with respect to
the images: every dense's input gradient, the patch embedding's too, and no
weight gradient); ``full`` is a full fine-tune's (no image gradient; every
weight's gradient); ``lora`` is the LoRA defense's (no image gradient; the
factors' gradients only, the base frozen). Element-wise work (LayerNorm,
GELU, softmax, the quantizers) is not counted, and the W8A8 variant counts
the same model work as bf16.
"""

from __future__ import annotations

from ..models import vit

# NVIDIA H100 SXM: dense bf16 tensor-core rate (data sheet, without sparsity)
PEAK_NAME = "NVIDIA H100 SXM bf16 dense"
PEAK_FLOPS = 989.4e12


def _dense(rows: int, d_in: int, d_out: int) -> int:
    return 2 * rows * d_in * d_out


def _patches(cfg: vit.ViTConfig) -> tuple[int, int, int]:
    """(rows, in, out) of the patch embedding."""
    return cfg.num_patches, cfg.patch_size * cfg.patch_size * 3, cfg.hidden_dim


def _block_denses(cfg: vit.ViTConfig) -> dict[str, tuple[int, int, int]]:
    n, d, m = cfg.seq_len, cfg.hidden_dim, cfg.mlp_dim
    return {"blocks/attn/q": (n, d, d), "blocks/attn/k": (n, d, d),
            "blocks/attn/v": (n, d, d), "blocks/attn/o": (n, d, d),
            "blocks/mlp/fc1": (n, d, m), "blocks/mlp/fc2": (n, m, d)}


def _branch(cfg: vit.ViTConfig, rank: int, targets) -> int:
    """One pass of the rank-``rank`` branches over every block."""
    shapes = _block_denses(cfg)
    return cfg.depth * sum(2 * shapes[t][0] * rank * (shapes[t][1] + shapes[t][2])
                           for t in targets) if rank else 0


def _core(cfg: vit.ViTConfig) -> int:
    return 4 * cfg.seq_len * cfg.seq_len * cfg.hidden_dim


def _all_denses(cfg: vit.ViTConfig) -> int:
    """Every dense once: the patch embedding, the blocks and the head."""
    blocks = cfg.depth * sum(_dense(*s) for s in _block_denses(cfg).values())
    return _dense(*_patches(cfg)) + blocks + _dense(1, cfg.hidden_dim, cfg.num_classes)


def forward(cfg: vit.ViTConfig, *, rank: int = 0,
            targets=vit.LORA_TARGETS_DEFAULT) -> int:
    """FLOP per image of one forward pass (``rank`` > 0: unmerged LoRA on ``targets``)."""
    return _all_denses(cfg) + cfg.depth * _core(cfg) + _branch(cfg, rank, targets)


def backward(cfg: vit.ViTConfig, kind: str, *, rank: int = 0,
             targets=vit.LORA_TARGETS_DEFAULT) -> int:
    """FLOP per image of one backward pass: ``kind`` = "input", "full" or "lora"."""
    dx = _all_denses(cfg) + cfg.depth * 2 * _core(cfg) + _branch(cfg, rank, targets)
    if kind == "input":
        return dx
    dx -= _dense(*_patches(cfg))  # the images ask no gradient in training
    if kind == "full":
        return dx + _all_denses(cfg)
    if kind == "lora":
        return dx + _branch(cfg, rank, targets)
    raise ValueError(f"backward kind {kind!r}: input, full or lora")


def pgd(cfg: vit.ViTConfig, steps: int, *, rank: int = 0,
        targets=vit.LORA_TARGETS_DEFAULT) -> int:
    """FLOP per image of PGD-``steps``: a forward and an input gradient a step."""
    kw = dict(rank=rank, targets=targets)
    return steps * (forward(cfg, **kw) + backward(cfg, "input", **kw))


def train_step(cfg: vit.ViTConfig, mode: str, *, rank: int = 8,
               targets=vit.LORA_TARGETS_DEFAULT) -> int:
    """FLOP per image of one training step: ``mode`` "full", or "lora" /
    "lora_pa" (rank-``rank`` factors on ``targets``, the base frozen)."""
    if mode == "full":
        return forward(cfg) + backward(cfg, "full")
    if mode in ("lora", "lora_pa"):
        kw = dict(rank=rank, targets=targets)
        return forward(cfg, **kw) + backward(cfg, "lora", **kw)
    raise ValueError(f"train mode {mode!r}: full, lora or lora_pa")


def mfu_pct(images_per_s: float, flop_per_image: float, peak: float = PEAK_FLOPS) -> float:
    """Achieved share of ``peak``, in percent."""
    return 100.0 * images_per_s * flop_per_image / peak


def roofline_images_per_s(flop_per_image: float, peak: float = PEAK_FLOPS) -> float:
    """Images/s at 100% of ``peak``."""
    return peak / flop_per_image
