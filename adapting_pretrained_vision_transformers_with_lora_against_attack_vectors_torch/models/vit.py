"""Vision Transformer (ViT) as an ``nn.Module`` — the flagship backbone.

Counterpart of the JAX package's ``models/vit.py``. Param trees keep the
JAX layout at the boundary: :func:`init` returns the nested dict the JAX
``vit.init`` returns (blocks stacked on axis 0, dense weights ``(in, out)``),
so LoRA adapters keyed ``"blocks/attn/q"`` apply to it unchanged;
:func:`params_from_jax` turns such a tree (from either package's
checkpoint) into a :class:`ViT` with one module per layer, and
:func:`params_to_jax` turns it back.

The attention core is :func:`..kernels.attention.attention_packed` on the
packed q/k/v dense outputs: the CUDA kernel on the card, its plain version
on the CPU. The q/k/v projections stay three denses so params map 1:1.

**The dispatch rule of the three opt-in kernels** (the JAX one).
``fuse_attn_block``, ``fuse_ln_mlp`` and ``use_fused_mlp`` are config fields,
off by default. With a field off the block runs the library composition
around the packed-attention kernel. With a field on and bf16 compute, the
block calls the kernel's wrapper: ``fuse_attn_block`` gives the attention
half to :func:`..kernels.attn_block.attn_block` (LN1, q/k/v, attention and
the o-projection in one op) and implies the LN-fused MLP half;
``fuse_ln_mlp`` gives the MLP half with its LN2 to
:func:`..kernels.mlp.ln_mlp`; ``use_fused_mlp`` gives the MLP half behind a
library LN2 to :func:`..kernels.mlp.mlp`. On a CUDA tensor a wrapper launches
the hand-written kernel, and a shape the kernel does not take, a failed build
or a failed launch raises (nothing gives way to the library path); on a CPU
tensor it runs the kernel's plain version. A half whose denses carry
unmerged LoRA factors (``lora_a``) takes the unfused path for that half, so
with the default q/k/v/o adapter targets ``fuse_attn_block`` leaves the
attention half unfused and still fuses the MLP half. With f32 compute the
fields do nothing, as in JAX. There is no memory gate. ``remat`` recomputes
each block in the backward pass (``torch.utils.checkpoint``) instead of
keeping its activations.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from ..kernels.attention import attention_packed
from ..kernels.attn_block import attn_block
from ..kernels.mlp import ln_mlp, mlp
from ..ops.nn import LoRADropout
from ..ops.nn import dense, dense_init, gelu, layer_norm, layer_norm_init
from ..utils import trees


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Static architecture description (the fields that change the math)."""

    image_size: int = 224
    patch_size: int = 16
    hidden_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    num_classes: int = 21
    layer_norm_eps: float = 1e-12  # HF ViT default
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = False  # recompute each block on the backward pass
    # the three opt-in kernels (module docstring); bf16 compute only
    use_fused_mlp: bool = False
    fuse_attn_block: bool = False
    fuse_ln_mlp: bool = False

    @property
    def num_patches(self) -> int:
        side, p = divmod(self.image_size, self.patch_size)
        if p:
            raise ValueError("image_size must be divisible by patch_size")
        return side * side

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # CLS token

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    def with_classes(self, num_classes: int) -> "ViTConfig":
        return dataclasses.replace(self, num_classes=num_classes)


VIT_B16 = ViTConfig()
VIT_TINY = ViTConfig(hidden_dim=192, depth=12, num_heads=3, mlp_dim=768)
VIT_TEST = ViTConfig(image_size=32, patch_size=8, hidden_dim=64, depth=2,
                     num_heads=2, mlp_dim=128, num_classes=10,
                     compute_dtype="float32")

# LoRA target subtrees (PEFT's query/key/value/output.dense); one path covers
# every stacked layer.
LORA_TARGETS_DEFAULT = ("blocks/attn/q", "blocks/attn/k", "blocks/attn/v", "blocks/attn/o")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# --- JAX-layout param trees ----------------------------------------------------

def _block_init(g: torch.Generator, cfg: ViTConfig, dtype) -> dict:
    d, m = cfg.hidden_dim, cfg.mlp_dim
    return {
        "ln1": layer_norm_init(d, dtype=dtype),
        "attn": {t: dense_init(g, d, d, dtype=dtype) for t in ("q", "k", "v", "o")},
        "ln2": layer_norm_init(d, dtype=dtype),
        "mlp": {"fc1": dense_init(g, d, m, dtype=dtype),
                "fc2": dense_init(g, m, d, dtype=dtype)},
    }


def init(cfg: ViTConfig, generator: torch.Generator | None = None, *,
         device=None) -> dict:
    """Seeded random params in the JAX layout (blocks stacked on axis 0)."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    dtype = _dtype(cfg.param_dtype)
    d = cfg.hidden_dim
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    proj = dense_init(g, patch_dim, d, dtype=dtype)
    pos = torch.randn(1, cfg.seq_len, d, generator=g) * 0.02
    per_layer = [trees.flatten_with_paths(_block_init(g, cfg, dtype))
                 for _ in range(cfg.depth)]
    blocks = trees.unflatten_from_paths(
        {p: torch.stack([layer[p] for layer in per_layer]) for p in per_layer[0]})
    tree = {
        "embed": {"proj": proj, "cls": torch.zeros(1, 1, d, dtype=dtype),
                  "pos": pos.to(dtype)},
        "blocks": blocks,
        "final_ln": layer_norm_init(d, dtype=dtype),
        "head": dense_init(g, d, cfg.num_classes, dtype=dtype),
    }
    return trees.map_leaves(lambda t: t.to(device), tree) if device is not None else tree


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 from the JAX loader
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))


# --- modules --------------------------------------------------------------------

class Leaves(nn.Module):
    """The leaves of one JAX subtree (a dense or a LayerNorm) as parameters,
    under their JAX names (``w``, ``b``, ``scale``, ``lora_a``...).

    The dropout leaves of ``ops.lora.attach``'s training form (a seed and a
    rate) are not parameters: they become this dense's
    :class:`..ops.nn.LoRADropout` stream, which :meth:`tree` hands to
    ``dense`` while the module is in training mode."""

    def __init__(self, leaves: Mapping[str, torch.Tensor]):
        super().__init__()
        self.dropout = None
        for key, mode in (("lora_rng", "input"), ("lora_rng_pa", "post_a")):
            if key in leaves:
                gen = torch.Generator(leaves[key].device).manual_seed(int(leaves[key]))
                self.dropout = LoRADropout(float(leaves["lora_p"]), mode, gen)
        for name, t in leaves.items():
            if name not in ("lora_rng", "lora_rng_pa", "lora_p"):
                self.register_parameter(name, nn.Parameter(t, requires_grad=t.is_floating_point()))

    def leaves(self) -> dict:
        return dict(self.named_parameters(recurse=False))

    def tree(self) -> dict:
        out = self.leaves()
        if self.training and self.dropout is not None:
            out["lora_drop"] = self.dropout
        return out


def _sub(flat: Mapping[str, torch.Tensor], prefix: str) -> dict:
    n = len(prefix) + 1
    return {p[n:]: v for p, v in flat.items() if p.startswith(prefix + "/")}


class Block(nn.Module):
    """Pre-LN transformer block: x + MHA(LN1(x)), then x + MLP(LN2(x))."""

    def __init__(self, cfg: ViTConfig, flat: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Leaves(_sub(flat, "ln1"))
        self.attn = nn.ModuleDict({t: Leaves(_sub(flat, f"attn/{t}"))
                                   for t in ("q", "k", "v", "o")})
        self.ln2 = Leaves(_sub(flat, "ln2"))
        self.mlp = nn.ModuleDict({t: Leaves(_sub(flat, f"mlp/{t}")) for t in ("fc1", "fc2")})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, cd, eps = self.cfg, x.dtype, self.cfg.layer_norm_eps
        kernel_dtype = cd == torch.bfloat16  # the JAX gate: 2-byte compute dtypes only
        ap = {t: self.attn[t].tree() for t in ("q", "k", "v", "o")}
        if cfg.fuse_attn_block and kernel_dtype and all("lora_a" not in p for p in ap.values()):
            ln1 = self.ln1.tree()
            x = x + attn_block(x, ln1["scale"], ln1["bias"], ap["q"]["w"], ap["q"]["b"],
                               ap["k"]["w"], ap["k"]["b"], ap["v"]["w"], ap["v"]["b"],
                               ap["o"]["w"], ap["o"]["b"], cfg.num_heads, eps)
        else:
            h = layer_norm(self.ln1.tree(), x, eps=eps)
            q, k, v = (dense(ap[t], h, compute_dtype=cd) for t in ("q", "k", "v"))
            x = x + dense(ap["o"], attention_packed(q, k, v, cfg.num_heads), compute_dtype=cd)

        fc1, fc2 = self.mlp["fc1"].tree(), self.mlp["fc2"].tree()
        plain_mlp = kernel_dtype and "lora_a" not in fc1 and "lora_a" not in fc2
        ln2 = self.ln2.tree()
        if (cfg.fuse_attn_block or cfg.fuse_ln_mlp) and plain_mlp:
            return x + ln_mlp(x, ln2["scale"], ln2["bias"], fc1["w"], fc1["b"], fc2["w"],
                              fc2["b"], eps)
        h = layer_norm(ln2, x, eps=eps)
        if cfg.use_fused_mlp and plain_mlp:
            return x + mlp(h, fc1["w"], fc1["b"], fc2["w"], fc2["b"])
        h = gelu(dense(fc1, h, compute_dtype=cd))
        return x + dense(fc2, h, compute_dtype=cd)


class ViT(nn.Module):
    """ViT over NHWC images; built from a flat JAX-layout tree."""

    def __init__(self, cfg: ViTConfig, flat: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.proj = Leaves(_sub(flat, "embed/proj"))
        self.cls = nn.Parameter(flat["embed/cls"])
        self.pos = nn.Parameter(flat["embed/pos"])
        blocks = _sub(flat, "blocks")
        self.blocks = nn.ModuleList(
            Block(cfg, {p: v[i] for p, v in blocks.items()}) for i in range(cfg.depth))
        self.final_ln = Leaves(_sub(flat, "final_ln"))
        self.head = Leaves(_sub(flat, "head"))

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """Normalized images (B, H, W, 3) -> final-LN tokens (B, N+1, D)."""
        cfg = self.cfg
        cd = _dtype(cfg.compute_dtype)
        x = dense(self.proj.tree(), _patchify(cfg, images.to(cd)), compute_dtype=cd)
        cls = self.cls.to(cd).expand(x.shape[0], 1, cfg.hidden_dim)
        x = torch.cat([cls, x], dim=1) + self.pos.to(cd)
        for block in self.blocks:
            if cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        return layer_norm(self.final_ln.tree(), x, eps=cfg.layer_norm_eps)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """Classification logits (float32, CLS-token head)."""
        toks = self.features(images)
        return dense(self.head.tree(), toks[:, 0], compute_dtype=toks.dtype).float()


def _patchify(cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, P*P*C), row-major patch pixels, channel last."""
    b, h, w, c = images.shape
    p = cfg.patch_size
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


# --- the JAX <-> module boundary ---------------------------------------------------

def params_from_jax(flat, cfg: ViTConfig) -> ViT:
    """JAX-layout tree (flat '/' paths or nested; numpy arrays or tensors;
    blocks stacked on axis 0) -> :class:`ViT`, on the tensors' device."""
    return ViT(cfg, {p: _as_tensor(v) for p, v in trees.flatten_with_paths(flat).items()})


def params_to_jax(model: ViT) -> dict[str, torch.Tensor]:
    """Inverse of :func:`params_from_jax`: flat '/' paths -> CPU tensors,
    blocks stacked on axis 0."""
    out = {f"embed/proj/{k}": v for k, v in model.proj.leaves().items()}
    out["embed/cls"], out["embed/pos"] = model.cls, model.pos
    per_layer = [trees.flatten_with_paths(
        {"ln1": b.ln1.leaves(), "ln2": b.ln2.leaves(),
         "attn": {t: m.leaves() for t, m in b.attn.items()},
         "mlp": {t: m.leaves() for t, m in b.mlp.items()}}) for b in model.blocks]
    for p in per_layer[0]:
        out[f"blocks/{p}"] = torch.stack([layer[p] for layer in per_layer])
    out.update({f"final_ln/{k}": v for k, v in model.final_ln.leaves().items()})
    out.update({f"head/{k}": v for k, v in model.head.leaves().items()})
    return {p: v.detach().cpu() for p, v in out.items()}


def features(cfg: ViTConfig, model: ViT, images: torch.Tensor) -> torch.Tensor:
    """Final-LN token features (B, N+1, D) (the JAX ``vit.features`` signature)."""
    return model.features(images)


def apply(cfg: ViTConfig, model: ViT, images: torch.Tensor) -> torch.Tensor:
    """Forward pass to float32 logits (the JAX ``vit.apply`` signature)."""
    return model(images)
