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
unmerged LoRA factors (``lora_a``) or a W8A8 quantized form (``w_q``,
:mod:`..ops.quant`) takes the unfused path for that half, so
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
from ..ops.nn import dense, dense_f32, dense_init, gelu, layer_norm, layer_norm_init
from ..parallel import mesh as pmesh
from ..parallel.tp import copy_to_model, reduce_from_model
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
VIT_B16_384 = ViTConfig(image_size=384)  # google/vit-base-patch16-384: 577 tokens
VIT_TINY = ViTConfig(hidden_dim=192, depth=12, num_heads=3, mlp_dim=768)
VIT_TEST = ViTConfig(image_size=32, patch_size=8, hidden_dim=64, depth=2,
                     num_heads=2, mlp_dim=128, num_classes=10,
                     compute_dtype="float32")

# LoRA target subtrees (PEFT's query/key/value/output.dense); one path covers
# every stacked layer.
LORA_TARGETS_DEFAULT = ("blocks/attn/q", "blocks/attn/k", "blocks/attn/v", "blocks/attn/o")
# the W8A8 attack-path targets (ops/quant.py): the denses that carry nearly
# all of the encoder's operations; the patch embedding and the head stay float
QUANT_TARGETS_DEFAULT = ("blocks/attn/q", "blocks/attn/k", "blocks/attn/v",
                         "blocks/attn/o", "blocks/mlp/fc1", "blocks/mlp/fc2")


def lora_target_paths(targets: tuple[str, ...] = ("q", "k", "v", "o")) -> tuple[str, ...]:
    """The adapter paths of short target names (``q k v o fc1 fc2 head``)."""
    mapping = {"q": "blocks/attn/q", "k": "blocks/attn/k", "v": "blocks/attn/v",
               "o": "blocks/attn/o", "fc1": "blocks/mlp/fc1", "fc2": "blocks/mlp/fc2",
               "head": "head"}
    return tuple(mapping[t] for t in targets)


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

    def __init__(self, leaves: Mapping[str, torch.Tensor], shard_dims: Mapping[str, int] = None):
        super().__init__()
        self.dropout = None
        # {leaf name: dim} of the leaves this rank holds a model-axis slice of
        self.shard_dims = dict(shard_dims or {})
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


def _plain_dense(p: Mapping) -> bool:
    """A dense the fused kernels can take: a float ``w``, neither unmerged
    LoRA factors (``lora_a``) nor a W8A8 quantized form (``w_q``)."""
    return "lora_a" not in p and "w_q" not in p


def _sub(flat: Mapping[str, torch.Tensor], prefix: str) -> dict:
    n = len(prefix) + 1
    return {p[n:]: v for p, v in flat.items() if p.startswith(prefix + "/")}


class Block(nn.Module):
    """Pre-LN transformer block: x + MHA(LN1(x)), then x + MLP(LN2(x))."""

    def __init__(self, cfg: ViTConfig, flat: Mapping[str, torch.Tensor],
                 dims: Mapping[str, int] = None, group=None, tp: int = 1):
        super().__init__()
        self.cfg, self.group, self.tp = cfg, group, tp
        dims = dims or {}
        self.ln1 = Leaves(_sub(flat, "ln1"))
        self.attn = nn.ModuleDict({t: Leaves(_sub(flat, f"attn/{t}"), _sub(dims, f"attn/{t}"))
                                   for t in ("q", "k", "v", "o")})
        self.ln2 = Leaves(_sub(flat, "ln2"))
        self.mlp = nn.ModuleDict({t: Leaves(_sub(flat, f"mlp/{t}"), _sub(dims, f"mlp/{t}"))
                                  for t in ("fc1", "fc2")})

    def _copy(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.tp == 1 else copy_to_model(t, self.group)

    def _dense_tree(self, leaves: Leaves) -> dict:
        """A dense's tree; under tp > 1 its whole LoRA leaves (``lora_a`` of
        a column split, ``lora_b`` of a row split, ``lora_s``) go through
        :func:`copy_to_model`: each rank's gradient of them is partial. The
        bias of a row split is added after the reduce and stays as it is."""
        p = leaves.tree()
        if self.tp == 1:
            return p
        return {k: copy_to_model(v, self.group)
                if k.startswith("lora_") and k != "lora_drop" and k not in leaves.shard_dims
                else v for k, v in p.items()}

    def _row_out(self, partial: torch.Tensor, bias, cd) -> torch.Tensor:
        """The row-split projection's output: the ranks' partial sums (f32)
        added up, the bias added once, one rounding to ``cd``."""
        y = reduce_from_model(partial.float(), self.group)
        return (y + bias.float() if bias is not None else y).to(cd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, cd, eps, tp = self.cfg, x.dtype, self.cfg.layer_norm_eps, self.tp
        heads = cfg.num_heads // tp  # this rank's heads
        kernel_dtype = cd == torch.bfloat16  # the JAX gate: 2-byte compute dtypes only
        ap = {t: self._dense_tree(self.attn[t]) for t in ("q", "k", "v", "o")}
        if cfg.fuse_attn_block and kernel_dtype and all(_plain_dense(p) for p in ap.values()):
            if tp > 1:
                raise ValueError(f"attn_block takes square (C, C) weights; under a model axis of "
                                 f"{tp} a rank's q/k/v/o are (C, C/{tp}) and (C/{tp}, C)")
            ln1 = self.ln1.tree()
            x = x + attn_block(x, ln1["scale"], ln1["bias"], ap["q"]["w"], ap["q"]["b"],
                               ap["k"]["w"], ap["k"]["b"], ap["v"]["w"], ap["v"]["b"],
                               ap["o"]["w"], ap["o"]["b"], cfg.num_heads, eps)
        else:
            h = self._copy(layer_norm(self.ln1.tree(), x, eps=eps))
            q, k, v = (dense(ap[t], h, compute_dtype=cd) for t in ("q", "k", "v"))
            a = attention_packed(q, k, v, heads)
            if tp == 1:
                x = x + dense(ap["o"], a, compute_dtype=cd)
            else:
                o = {n: t for n, t in ap["o"].items() if n != "b"}
                x = x + self._row_out(dense_f32(o, a, compute_dtype=cd), ap["o"].get("b"), cd)

        fc1, fc2 = self._dense_tree(self.mlp["fc1"]), self._dense_tree(self.mlp["fc2"])
        plain_mlp = kernel_dtype and _plain_dense(fc1) and _plain_dense(fc2)
        ln2 = self.ln2.tree()
        # under tp > 1 the fused kernels take a zero b2 and the bias goes in
        # once after the reduce, so that its gradient is every rank's
        b2 = fc2["b"] if tp == 1 else torch.zeros_like(fc2["b"])
        if (cfg.fuse_attn_block or cfg.fuse_ln_mlp) and plain_mlp:
            y = ln_mlp(self._copy(x), self._copy(ln2["scale"]), self._copy(ln2["bias"]),
                       fc1["w"], fc1["b"], fc2["w"], b2, eps)
            return x + (y if tp == 1 else self._row_out(y, fc2["b"], cd))
        h = self._copy(layer_norm(ln2, x, eps=eps))
        if cfg.use_fused_mlp and plain_mlp:
            y = mlp(h, fc1["w"], fc1["b"], fc2["w"], b2)
            return x + (y if tp == 1 else self._row_out(y, fc2["b"], cd))
        h = gelu(dense(fc1, h, compute_dtype=cd))
        if tp == 1:
            return x + dense(fc2, h, compute_dtype=cd)
        w2 = {n: t for n, t in fc2.items() if n != "b"}
        return x + self._row_out(dense_f32(w2, h, compute_dtype=cd), fc2.get("b"), cd)


class ViT(nn.Module):
    """ViT over NHWC images; built from a flat JAX-layout tree.

    Under a mesh whose model axis is ``tp`` > 1 (``parallel.mesh``), each
    block holds this rank's slices by the JAX rules and runs the Megatron
    split: q/k/v column slices (``num_heads / tp`` heads, on which the
    packed-attention kernel runs), the o-projection a row slice whose f32
    partial sums one all-reduce adds up, and the MLP likewise (fc1 columns,
    fc2 rows). LoRA follows the rules: q/k/v/fc1 ``lora_b`` column slices
    with ``lora_a`` whole, o/fc2 ``lora_a`` row slices with ``lora_b`` whole,
    so the adapter branch's partial sum joins the same all-reduce. The fused
    MLPs (``use_fused_mlp``, ``fuse_ln_mlp``) run on the local slices, their
    output bias once, after the reduce; ``attn_block`` takes square (C, C)
    weights only, so a half-block it would fuse raises under tp > 1 (with
    LoRA factors on q/k/v/o it is not fused, and ``fuse_attn_block`` still
    fuses the MLP half)."""

    def __init__(self, cfg: ViTConfig, flat: Mapping[str, torch.Tensor], mesh=None):
        super().__init__()
        self.cfg = cfg
        tp = pmesh.axis_size(mesh, pmesh.MODEL_AXIS)
        if cfg.num_heads % tp:
            raise ValueError(f"{cfg.num_heads} heads do not divide over the model axis of {tp}")
        if tp > 1 and any(p.endswith("/w_q") for p in flat):
            raise NotImplementedError("W8A8 denses (ops.quant) under a model axis > 1")
        group = pmesh.axis_group(mesh, pmesh.MODEL_AXIS) if tp > 1 else None
        # the stacked leaves' split dims, one less in a block's own leaves
        dims = {p: d - 1 for p, d in _sub(pmesh.model_dims(mesh, flat), "blocks").items()}
        flat = pmesh.shard_tree(mesh, flat)
        self.proj = Leaves(_sub(flat, "embed/proj"))
        self.cls = nn.Parameter(flat["embed/cls"])
        self.pos = nn.Parameter(flat["embed/pos"])
        blocks = _sub(flat, "blocks")
        self.blocks = nn.ModuleList(
            Block(cfg, {p: v[i] for p, v in blocks.items()}, dims, group, tp)
            for i in range(cfg.depth))
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

def bind_mesh(model: nn.Module, mesh) -> nn.Module:
    """Record ``mesh`` on a model built from a tree (``model.mesh``, which the
    steps and attacks read) and give every LoRA dropout stream its block of
    the global draw: this rank's rows on the data axis and, where the mask
    covers a dense input that is split over the model axis (mode ``input``
    with ``lora_a`` row-split), its columns. In mode ``post_a`` the mask
    covers the whole rank-r ``x @ lora_a``, of which each rank of the group
    holds a partial sum: every rank draws the same mask, so the sum over the
    group is the mask times the whole product."""
    model.mesh = mesh
    rows = (pmesh.axis_rank(mesh, pmesh.DATA_AXIS), pmesh.axis_size(mesh, pmesh.DATA_AXIS))
    tp = (pmesh.axis_rank(mesh, pmesh.MODEL_AXIS), pmesh.axis_size(mesh, pmesh.MODEL_AXIS))
    for m in model.modules():
        if isinstance(m, Leaves) and m.dropout is not None:
            m.dropout.rows = rows
            if m.dropout.mode == "input" and m.shard_dims.get("lora_a") == 0:
                m.dropout.cols = tp
    return model


def params_from_jax(flat, cfg: ViTConfig, mesh=None) -> ViT:
    """JAX-layout tree (flat '/' paths or nested; numpy arrays or tensors;
    blocks stacked on axis 0) -> :class:`ViT`, on the tensors' device. Under
    ``mesh`` the module holds this rank's slices (the class docstring)."""
    flat = {p: _as_tensor(v) for p, v in trees.flatten_with_paths(flat).items()}
    return bind_mesh(ViT(cfg, flat, mesh), mesh)


def params_to_jax(model: ViT) -> dict[str, torch.Tensor]:
    """Inverse of :func:`params_from_jax`: flat '/' paths -> CPU tensors,
    blocks stacked on axis 0; under a model axis the slices are gathered
    first (every rank of the model group must call it)."""
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
    out = pmesh.gather_tree(pmesh.mesh_of(model), {p: v.detach() for p, v in out.items()})
    return {p: v.cpu() for p, v in out.items()}


def features(cfg: ViTConfig, model: ViT, images: torch.Tensor) -> torch.Tensor:
    """Final-LN token features (B, N+1, D) (the JAX ``vit.features`` signature)."""
    return model.features(images)


def apply(cfg: ViTConfig, model: ViT, images: torch.Tensor) -> torch.Tensor:
    """Forward pass to float32 logits (the JAX ``vit.apply`` signature)."""
    return model(images)
