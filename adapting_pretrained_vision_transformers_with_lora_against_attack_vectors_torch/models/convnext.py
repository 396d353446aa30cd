"""ConvNeXt (ConvNeXt-B flagship) as ``nn.Module``s.

Counterpart of the JAX package's ``models/convnext.py``. Param trees keep the
JAX layout at the boundary: :func:`init` returns the nested dict the JAX
``convnext.init`` returns, with each stage's blocks stacked on one leading
depth axis, conv filters HWIO (the depthwise filter ``(7, 7, 1, dim)``) and
dense weights ``(in, out)``, so LoRA adapters keyed
``"stages/{s}/blocks/pwconv1"`` apply to it unchanged;
:func:`params_from_jax` turns such a tree into a :class:`ConvNeXt` with one
module per block, and :func:`params_to_jax` turns it back.

Activations stay channels-last ``(B, H, W, C)`` throughout, as in JAX: the
pointwise layers are ``ops.nn.dense`` on the last axis, and the stem (4x4,
stride 4) and the downsamples (2x2, stride 2), whose patches do not overlap,
are a reshape plus a matrix product. A conv bias is added in f32 and the sum
rounded once more, as the JAX ``_conv`` does.

**The dispatch rule of the two kernels** (the JAX one). ``use_dw_kernel``
and ``fuse_ln_mlp`` are opt-in config fields, off by default. With a field
off the block runs the library composition (``F.conv2d`` with ``groups=C``;
``layer_norm`` -> ``dense`` -> ``gelu`` -> ``dense``). With a field on and
bf16 compute (JAX: a 2-byte compute dtype), the block calls the kernel's wrapper
(:func:`..kernels.dwconv.dwconv7`, :func:`..kernels.mlp.ln_mlp`): on a CUDA
tensor that launches the hand-written kernel, and a shape the kernel does
not take, a failed build or a failed launch raises (nothing gives way to the
library path); on a CPU tensor it runs the kernel's plain version.
``fuse_ln_mlp`` applies only while ``pwconv1``/``pwconv2`` carry no unmerged
LoRA factors. With f32 compute the fields do nothing, as in JAX. There is
no memory gate: the kernels take all four ConvNeXt-B stages.

Under a mesh (``parallel.mesh``) ConvNeXt is fully replicated: no rule of
``vit_param_rules`` matches its tree (``pwconv1``/``pwconv2``, not
``mlp/fc1``/``mlp/fc2``), so every rank of a model group holds every
parameter whole and computes the same logits; only the data axis splits the
batch. :func:`params_from_jax` raises if a rule ever splits one of its
leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import mlp as _kmlp
from ..kernels.dwconv import dwconv7
from ..ops.nn import dense, dense_init, gelu, layer_norm, layer_norm_init
from ..utils import trees
from ..parallel import mesh as pmesh
from .vit import Leaves, _as_tensor, _plain_dense, _sub, bind_mesh


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    """Static architecture description (the JAX fields, under their names)."""

    image_size: int = 224
    depths: tuple[int, ...] = (3, 3, 27, 3)
    dims: tuple[int, ...] = (128, 256, 512, 1024)
    num_classes: int = 21
    layer_norm_eps: float = 1e-6
    layer_scale_init: float = 1e-6
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # a compiler option of the JAX package (scan vs unrolled blocks); accepted
    # so that configs carry over, and ignored: the blocks are a Python loop
    unroll_layers: bool = False
    # each block's LayerNorm + pointwise MLP through kernels/mlp.py:ln_mlp
    fuse_ln_mlp: bool = False
    # each block's depthwise 7x7 through kernels/dwconv.py:dwconv7
    use_dw_kernel: bool = False

    def with_classes(self, num_classes: int) -> "ConvNeXtConfig":
        return dataclasses.replace(self, num_classes=num_classes)


CONVNEXT_B = ConvNeXtConfig()
CONVNEXT_T = ConvNeXtConfig(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768))
CONVNEXT_TEST = ConvNeXtConfig(image_size=32, depths=(2, 2), dims=(16, 32),
                               num_classes=10, compute_dtype="float32")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# --- JAX-layout param trees ----------------------------------------------------

def _trunc_normal(g: torch.Generator, shape, dtype) -> torch.Tensor:
    """Truncated normal (+-2 sigma) * 0.02, the JAX init of the conv filters."""
    w = torch.empty(*shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=g)
    return (w * 0.02).to(dtype)


def _block_init(g: torch.Generator, dim: int, cfg: ConvNeXtConfig, dtype) -> dict:
    return {
        "dwconv": {"w": _trunc_normal(g, (7, 7, 1, dim), dtype),
                   "b": torch.zeros(dim, dtype=dtype)},
        "norm": layer_norm_init(dim, dtype=dtype),
        "pwconv1": dense_init(g, dim, 4 * dim, dtype=dtype),
        "pwconv2": dense_init(g, 4 * dim, dim, dtype=dtype),
        "gamma": torch.full((dim,), cfg.layer_scale_init, dtype=dtype),
    }


def init(cfg: ConvNeXtConfig, generator: torch.Generator | None = None, *,
         device=None) -> dict:
    """Seeded random params in the JAX layout (blocks stacked on a depth axis)."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    dtype = _dtype(cfg.param_dtype)
    stages = {}
    for s, depth in enumerate(cfg.depths):
        dim = cfg.dims[s]
        per_block = [trees.flatten_with_paths(_block_init(g, dim, cfg, dtype))
                     for _ in range(depth)]
        stage = {"blocks": trees.unflatten_from_paths(
            {p: torch.stack([b[p] for b in per_block]) for p in per_block[0]})}
        if s > 0:
            stage["downsample"] = {
                "norm": layer_norm_init(cfg.dims[s - 1], dtype=dtype),
                "conv": {"w": _trunc_normal(g, (2, 2, cfg.dims[s - 1], dim), dtype),
                         "b": torch.zeros(dim, dtype=dtype)}}
        stages[str(s)] = stage
    tree = {
        "stem": {"conv": {"w": _trunc_normal(g, (4, 4, 3, cfg.dims[0]), dtype),
                          "b": torch.zeros(cfg.dims[0], dtype=dtype)},
                 "norm": layer_norm_init(cfg.dims[0], dtype=dtype)},
        "stages": stages,
        "final_ln": layer_norm_init(cfg.dims[-1], dtype=dtype),
        "head": dense_init(g, cfg.dims[-1], cfg.num_classes, dtype=dtype),
    }
    return trees.map_leaves(lambda t: t.to(device), tree) if device is not None else tree


# --- the convolutions ----------------------------------------------------------

def _add_bias(out: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The conv bias, added in f32 and rounded to the activation dtype."""
    return (out.float() + b.float()).to(out.dtype)


def _patch_conv(p: Mapping[str, torch.Tensor], x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k, stride k, VALID convolution of (B, H, W, C) by an HWIO filter:
    the patches do not overlap, so it is a reshape and one matrix product
    (the product rounded to x's dtype, then the bias as in :func:`_add_bias`)."""
    b, h, w, c = x.shape
    patches = x.reshape(b, h // k, k, w // k, k, c).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(b, h // k, w // k, k * k * c)
    out = F.linear(patches, p["w"].to(x.dtype).reshape(k * k * c, -1).t())
    return _add_bias(out, p["b"])


def _dwconv_library(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The library path of the depthwise 7x7: ``F.conv2d`` with ``groups=C``
    on the channels-last tensor (an NCHW view of it), filter in x's dtype."""
    c = x.shape[-1]
    wf = w.to(x.dtype).reshape(7, 7, c).permute(2, 0, 1).reshape(c, 1, 7, 7)
    return F.conv2d(x.permute(0, 3, 1, 2), wf, None, 1, 3, 1, c).permute(0, 2, 3, 1)


# --- modules --------------------------------------------------------------------

class Block(nn.Module):
    """x + gamma * MLP(LN(dwconv7(x))) over (B, H, W, C)."""

    def __init__(self, cfg: ConvNeXtConfig, flat: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.dwconv = Leaves(_sub(flat, "dwconv"))
        self.norm = Leaves(_sub(flat, "norm"))
        self.pwconv1 = Leaves(_sub(flat, "pwconv1"))
        self.pwconv2 = Leaves(_sub(flat, "pwconv2"))
        self.gamma = nn.Parameter(flat["gamma"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, cd = self.cfg, x.dtype
        dim = x.shape[-1]
        kernel_dtype = cd == torch.bfloat16  # the JAX gate: 2-byte compute dtypes only
        if cfg.use_dw_kernel and kernel_dtype:
            h = dwconv7(x, self.dwconv.w.reshape(7, 7, dim))
        else:
            h = _dwconv_library(x, self.dwconv.w)
        h = _add_bias(h, self.dwconv.b)
        p1, p2 = self.pwconv1.tree(), self.pwconv2.tree()
        if cfg.fuse_ln_mlp and kernel_dtype and _plain_dense(p1) and _plain_dense(p2):
            h = _kmlp.ln_mlp(h, self.norm.scale, self.norm.bias, p1["w"], p1["b"],
                             p2["w"], p2["b"], cfg.layer_norm_eps)
        else:
            h = layer_norm(self.norm.tree(), h, eps=cfg.layer_norm_eps)
            h = gelu(dense(p1, h, compute_dtype=cd))
            h = dense(p2, h, compute_dtype=cd)
        return x + self.gamma.to(cd) * h


class Stage(nn.Module):
    """An optional downsample (LN, then 2x2 stride-2 conv) and the stage's blocks."""

    def __init__(self, cfg: ConvNeXtConfig, s: int, flat: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.downsample = (nn.ModuleDict({t: Leaves(_sub(flat, f"downsample/{t}"))
                                          for t in ("norm", "conv")}) if s > 0 else None)
        blocks = _sub(flat, "blocks")
        self.blocks = nn.ModuleList(
            Block(cfg, {p: v[i] for p, v in blocks.items()}) for i in range(cfg.depths[s]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = layer_norm(self.downsample["norm"].tree(), x, eps=self.cfg.layer_norm_eps)
            x = _patch_conv(self.downsample["conv"].tree(), x, 2)
        for block in self.blocks:
            x = block(x)
        return x


class ConvNeXt(nn.Module):
    """ConvNeXt over NHWC images; built from a flat JAX-layout tree."""

    def __init__(self, cfg: ConvNeXtConfig, flat: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.stem = nn.ModuleDict({t: Leaves(_sub(flat, f"stem/{t}")) for t in ("conv", "norm")})
        self.stages = nn.ModuleList(Stage(cfg, s, _sub(flat, f"stages/{s}"))
                                    for s in range(len(cfg.depths)))
        self.final_ln = Leaves(_sub(flat, "final_ln"))
        self.head = Leaves(_sub(flat, "head"))

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """Normalized images (B, H, W, 3) -> the pre-pool feature map (B, H', W', C_last)."""
        cfg = self.cfg
        x = _patch_conv(self.stem["conv"].tree(), images.to(_dtype(cfg.compute_dtype)), 4)
        x = layer_norm(self.stem["norm"].tree(), x, eps=cfg.layer_norm_eps)
        for stage in self.stages:
            x = stage(x)
        return x

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """Classification logits (float32): mean pool, final LN, head."""
        x = self.features(images)
        pooled = x.float().mean(dim=(1, 2)).to(x.dtype)
        pooled = layer_norm(self.final_ln.tree(), pooled, eps=self.cfg.layer_norm_eps)
        return dense(self.head.tree(), pooled, compute_dtype=pooled.dtype).float()


# --- the JAX <-> module boundary ---------------------------------------------------

def params_from_jax(flat, cfg: ConvNeXtConfig, mesh=None) -> ConvNeXt:
    """JAX-layout tree (flat '/' paths or nested; numpy arrays or tensors;
    blocks stacked on a depth axis) -> :class:`ConvNeXt`, on the tensors' device.
    Under ``mesh`` every parameter stays whole (the module docstring)."""
    flat = {p: _as_tensor(v) for p, v in trees.flatten_with_paths(flat).items()}
    pmesh.require_replicated(mesh, flat, 'ConvNeXt')
    return bind_mesh(ConvNeXt(cfg, flat), mesh)


def params_to_jax(model: ConvNeXt) -> dict[str, torch.Tensor]:
    """Inverse of :func:`params_from_jax`: flat '/' paths -> CPU tensors,
    blocks stacked on a depth axis."""
    out = {}
    for t, m in model.stem.items():
        out.update({f"stem/{t}/{k}": v for k, v in m.leaves().items()})
    for s, stage in enumerate(model.stages):
        per_block = [trees.flatten_with_paths(
            {"dwconv": b.dwconv.leaves(), "norm": b.norm.leaves(), "pwconv1": b.pwconv1.leaves(),
             "pwconv2": b.pwconv2.leaves(), "gamma": b.gamma}) for b in stage.blocks]
        for p in per_block[0]:
            out[f"stages/{s}/blocks/{p}"] = torch.stack([blk[p] for blk in per_block])
        if stage.downsample is not None:
            for t, m in stage.downsample.items():
                out.update({f"stages/{s}/downsample/{t}/{k}": v for k, v in m.leaves().items()})
    out.update({f"final_ln/{k}": v for k, v in model.final_ln.leaves().items()})
    out.update({f"head/{k}": v for k, v in model.head.leaves().items()})
    return {p: v.detach().cpu() for p, v in out.items()}


def features(cfg: ConvNeXtConfig, model: ConvNeXt, images: torch.Tensor) -> torch.Tensor:
    """The pre-pool feature map (the JAX ``convnext.features`` signature)."""
    return model.features(images)


def apply(cfg: ConvNeXtConfig, model: ConvNeXt, images: torch.Tensor) -> torch.Tensor:
    """Forward pass to float32 logits (the JAX ``convnext.apply`` signature)."""
    return model(images)


def lora_target_paths(cfg: ConvNeXtConfig) -> tuple[str, ...]:
    """Every stage's pointwise layers (factors stacked on the depth axis)."""
    return tuple(f"stages/{s}/blocks/{t}" for s in range(len(cfg.depths))
                 for t in ("pwconv1", "pwconv2"))
