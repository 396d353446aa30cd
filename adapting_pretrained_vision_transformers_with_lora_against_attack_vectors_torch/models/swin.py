"""Swin Transformer (Swin-B flagship) as ``nn.Module``s.

Counterpart of the JAX package's ``models/swin.py``. Param trees keep the
JAX layout at the boundary: :func:`init` returns the nested dict the JAX
``swin.init`` returns, with each stage's blocks stacked on two leading axes
``(depth // 2, 2, ...)`` (shift pairs) and dense weights ``(in, out)``, so
LoRA adapters keyed ``"stages/{s}/blocks/attn/qkv"`` apply to it unchanged;
:func:`params_from_jax` turns such a tree into a :class:`Swin` with one
module per block, and :func:`params_to_jax` turns it back.

The stages run window-resident, as in the JAX package: the feature map is
partitioned into windows once per stage; a shifted block permutes the token
rows into the shifted-window layout with one ``index_select`` each way
(``_shift_perms``) instead of ``roll``; a stage whose resolution equals the
window (Swin-B stage 4) has no shift and no mask. The attention core is
:func:`..kernels.window_attention.window_attention` on the raw qkv
projection, with the gathered bias ``(heads, n, n)`` and the shift mask
``(nW, n, n)`` (zeros for unshifted blocks), both f32: the CUDA kernel on
the card, its plain version on the CPU.

``use_fused_mlp`` is an opt-in config field, off by default, with the ViT's
dispatch rule (``models/vit.py``): on, with bf16 compute and no unmerged LoRA
factors on fc1/fc2, a block's MLP behind its library LN2 is
:func:`..kernels.mlp.mlp` (the kernel on a CUDA tensor or an error, the plain
version on a CPU tensor); with f32 compute the field does nothing. There is
no memory gate: the kernel takes all four Swin-B stages (the JAX dispatch
leaves stage 4 to XLA because its weights do not fit the TPU's fast memory).

Under a mesh (``parallel.mesh``) Swin is fully replicated, as in the JAX
package: the rules' patterns match ``mlp/fc1/w`` and ``mlp/fc2/w``, but they
key on the leaf's rank (3 or 2 for a weight, 2 or 1 for a bias) and Swin's
stacked leaves are ``(pairs, 2, in, out)``, rank 4 (biases rank 3), so no
rule applies (``attn/qkv`` and ``attn/proj`` match none anyway). Every rank
of a model group holds every parameter whole and the window kernel runs
unchanged; only the data axis splits the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..kernels.mlp import mlp
from ..kernels.window_attention import window_attention
from ..ops.nn import dense, dense_init, gelu, layer_norm, layer_norm_init
from ..utils import trees
from ..parallel import mesh as pmesh
from .vit import Leaves, _as_tensor, _plain_dense, _sub, bind_mesh


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """Static architecture description (the fields that change the math)."""

    image_size: int = 224
    patch_size: int = 4
    window: int = 7
    embed_dim: int = 128
    depths: tuple[int, ...] = (2, 2, 18, 2)
    num_heads: tuple[int, ...] = (4, 8, 16, 32)
    mlp_ratio: float = 4.0
    num_classes: int = 21
    layer_norm_eps: float = 1e-5
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    use_fused_mlp: bool = False  # the fused MLP kernel (module docstring); bf16 compute only

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    def stage_dim(self, s: int) -> int:
        return self.embed_dim * (2 ** s)

    def stage_res(self, s: int) -> int:
        return self.image_size // self.patch_size // (2 ** s)

    def with_classes(self, num_classes: int) -> "SwinConfig":
        return dataclasses.replace(self, num_classes=num_classes)


SWIN_B = SwinConfig()
SWIN_T = SwinConfig(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24))
# CI-sized config: 32px input, 2 stages, one pair each, window 4.
SWIN_TEST = SwinConfig(image_size=32, patch_size=4, window=4, embed_dim=32,
                       depths=(2, 2), num_heads=(2, 4), num_classes=10,
                       compute_dtype="float32")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# --- static window geometry (numpy; the same arrays as the JAX package's) -----

def _rel_pos_index(window: int) -> np.ndarray:
    """(W^2, W^2) indices into the (2W-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def _window_layout_order(res: int, window: int) -> np.ndarray:
    """(res^2,) spatial flat index held at each window-layout position."""
    nw = res // window
    return (np.arange(res * res).reshape(nw, window, nw, window)
            .transpose(0, 2, 1, 3).reshape(-1))


def _shift_perms(res: int, window: int, shift: int) -> tuple[np.ndarray, np.ndarray]:
    """``(perm, inv)`` over window-layout token positions folding
    ``roll(-shift) ∘ partition`` into one gather:
    ``x_shifted = x_layout[perm]``, ``x_layout = x_shifted[inv]``."""
    base = _window_layout_order(res, window)
    spatial_to_pos = np.argsort(base)
    rolled = np.roll(np.arange(res * res).reshape(res, res),
                     (-shift, -shift), (0, 1)).reshape(-1)
    perm = spatial_to_pos[rolled[base]]
    return perm, np.argsort(perm)


def _shift_attn_mask(res: int, window: int, shift: int) -> np.ndarray:
    """(num_windows, W^2, W^2) additive mask of the shifted windows: -100
    between tokens from different regions of the rolled map."""
    img = np.zeros((res, res), np.int32)
    cnt = 0
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    nw = res // window
    wins = img.reshape(nw, window, nw, window).transpose(0, 2, 1, 3)
    wins = wins.reshape(nw * nw, window * window)
    diff = wins[:, :, None] != wins[:, None, :]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


# --- JAX-layout param trees ----------------------------------------------------

def _block_init(g: torch.Generator, dim: int, mlp_dim: int, window: int, heads: int,
                dtype) -> dict:
    table = torch.randn((2 * window - 1) ** 2, heads, generator=g) * 0.02
    return {
        "ln1": layer_norm_init(dim, dtype=dtype),
        "attn": {"qkv": dense_init(g, dim, 3 * dim, dtype=dtype),
                 "proj": dense_init(g, dim, dim, dtype=dtype),
                 "bias_table": table.to(dtype)},
        "ln2": layer_norm_init(dim, dtype=dtype),
        "mlp": {"fc1": dense_init(g, dim, mlp_dim, dtype=dtype),
                "fc2": dense_init(g, mlp_dim, dim, dtype=dtype)},
    }


def init(cfg: SwinConfig, generator: torch.Generator | None = None, *,
         device=None) -> dict:
    """Seeded random params in the JAX layout (blocks stacked (pairs, 2, ...))."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    dtype = _dtype(cfg.param_dtype)
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    stages = {}
    for s, depth in enumerate(cfg.depths):
        if depth % 2:
            raise ValueError("Swin stages must have even depth (shift pairs)")
        dim = cfg.stage_dim(s)
        per_block = [trees.flatten_with_paths(_block_init(
            g, dim, int(dim * cfg.mlp_ratio), cfg.window, cfg.num_heads[s], dtype))
            for _ in range(depth)]
        blocks = trees.unflatten_from_paths({
            p: torch.stack([b[p] for b in per_block]).reshape(
                depth // 2, 2, *per_block[0][p].shape) for p in per_block[0]})
        stage = {"blocks": blocks}
        if s < cfg.num_stages - 1:
            stage["merge"] = {"norm": layer_norm_init(4 * dim, dtype=dtype),
                              "reduce": {"w": dense_init(g, 4 * dim, 2 * dim, dtype=dtype)["w"]}}
        stages[str(s)] = stage
    last = cfg.stage_dim(cfg.num_stages - 1)
    tree = {
        "embed": {"proj": dense_init(g, patch_dim, cfg.embed_dim, dtype=dtype),
                  "norm": layer_norm_init(cfg.embed_dim, dtype=dtype)},
        "stages": stages,
        "final_ln": layer_norm_init(last, dtype=dtype),
        "head": dense_init(g, last, cfg.num_classes, dtype=dtype),
    }
    return trees.map_leaves(lambda t: t.to(device), tree) if device is not None else tree


# --- modules --------------------------------------------------------------------

class Block(nn.Module):
    """Pre-LN Swin block in window layout: (B, nW, n, C) -> same."""

    def __init__(self, cfg: SwinConfig, heads: int, flat: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg, self.heads = cfg, heads
        self.ln1 = Leaves(_sub(flat, "ln1"))
        self.attn = nn.ModuleDict({t: Leaves(_sub(flat, f"attn/{t}")) for t in ("qkv", "proj")})
        self.bias_table = nn.Parameter(flat["attn/bias_table"])
        self.ln2 = Leaves(_sub(flat, "ln2"))
        self.mlp = nn.ModuleDict({t: Leaves(_sub(flat, f"mlp/{t}")) for t in ("fc1", "fc2")})

    def forward(self, x: torch.Tensor, rel_index: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        cd, eps = x.dtype, self.cfg.layer_norm_eps
        h = layer_norm(self.ln1.tree(), x, eps=eps)
        qkv = dense(self.attn["qkv"].tree(), h, compute_dtype=cd)
        bias = self.bias_table[rel_index].permute(2, 0, 1).float().contiguous()
        out = window_attention(qkv, bias, mask, self.heads)
        x = x + dense(self.attn["proj"].tree(), out, compute_dtype=cd)
        h = layer_norm(self.ln2.tree(), x, eps=eps)
        fc1, fc2 = self.mlp["fc1"].tree(), self.mlp["fc2"].tree()
        if (self.cfg.use_fused_mlp and cd == torch.bfloat16
                and _plain_dense(fc1) and _plain_dense(fc2)):
            return x + mlp(h, fc1["w"], fc1["b"], fc2["w"], fc2["b"])
        h = gelu(dense(fc1, h, compute_dtype=cd))
        return x + dense(fc2, h, compute_dtype=cd)


class Stage(nn.Module):
    """The blocks of one stage (shift pairs) and its patch merging."""

    def __init__(self, cfg: SwinConfig, s: int, flat: Mapping[str, torch.Tensor], device):
        super().__init__()
        self.cfg = cfg
        res, window = cfg.stage_res(s), cfg.window
        self.windowed = res > window
        blocks = _sub(flat, "blocks")
        self.blocks = nn.ModuleList(
            Block(cfg, cfg.num_heads[s], {p: v[i // 2, i % 2] for p, v in blocks.items()})
            for i in range(cfg.depths[s]))
        self.merge = (nn.ModuleDict({t: Leaves(_sub(flat, f"merge/{t}"))
                                     for t in ("norm", "reduce")})
                      if s < cfg.num_stages - 1 else None)
        n, nw = window * window, (res // window) ** 2
        self.register_buffer("zeros", torch.zeros(nw, n, n, device=device), persistent=False)
        if self.windowed:
            shift = window // 2
            perm, inv = _shift_perms(res, window, shift)
            for name, arr in (("mask", _shift_attn_mask(res, window, shift)),
                              ("perm", perm), ("inv", inv)):
                self.register_buffer(name, torch.from_numpy(arr).to(device), persistent=False)

    def forward(self, x: torch.Tensor, rel_index: torch.Tensor) -> torch.Tensor:
        """(B, res, res, C) -> (B, res/2, res/2, 2C), or (B, res, res, C) last."""
        cfg, window = self.cfg, self.cfg.window
        res = x.shape[1]
        x = _partition(x, window)

        def reperm(h, idx):
            b, nw, n, c = h.shape
            return h.reshape(b, nw * n, c).index_select(1, idx).reshape(b, nw, n, c)

        for i in range(0, len(self.blocks), 2):
            x = self.blocks[i](x, rel_index, self.zeros)
            if self.windowed:
                x = reperm(self.blocks[i + 1](reperm(x, self.perm), rel_index, self.mask),
                           self.inv)
            else:
                x = self.blocks[i + 1](x, rel_index, self.zeros)
        x = _unpartition(x, window, res)
        if self.merge is None:
            return x
        b, r, _, d = x.shape
        x = x.reshape(b, r // 2, 2, r // 2, 2, d)
        # timm concat order: (0,0), (1,0), (0,1), (1,1)
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0],
                       x[:, :, 0, :, 1], x[:, :, 1, :, 1]], dim=-1)
        x = layer_norm(self.merge["norm"].tree(), x, eps=cfg.layer_norm_eps)
        return dense(self.merge["reduce"].tree(), x, compute_dtype=x.dtype)


class Swin(nn.Module):
    """Swin over NHWC images; built from a flat JAX-layout tree. The static
    window geometry (index, masks, permutations) lives on the tree's device."""

    def __init__(self, cfg: SwinConfig, flat: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        device = flat["head/w"].device
        self.embed = nn.ModuleDict({t: Leaves(_sub(flat, f"embed/{t}")) for t in ("proj", "norm")})
        self.stages = nn.ModuleList(Stage(cfg, s, _sub(flat, f"stages/{s}"), device)
                                    for s in range(cfg.num_stages))
        self.final_ln = Leaves(_sub(flat, "final_ln"))
        self.head = Leaves(_sub(flat, "head"))
        self.register_buffer("rel_index",
                             torch.from_numpy(_rel_pos_index(cfg.window)).to(device),
                             persistent=False)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """Normalized images (B, H, W, 3) -> final-LN tokens (B, res^2, C_last)."""
        cfg = self.cfg
        cd, p, eps = _dtype(cfg.compute_dtype), cfg.patch_size, cfg.layer_norm_eps
        b, hh, ww, c = images.shape
        x = images.to(cd).reshape(b, hh // p, p, ww // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = dense(self.embed["proj"].tree(), x.reshape(b, hh // p, ww // p, p * p * c),
                  compute_dtype=cd)
        x = layer_norm(self.embed["norm"].tree(), x, eps=eps)
        for stage in self.stages:
            x = stage(x, self.rel_index)
        b, r, _, d = x.shape
        return layer_norm(self.final_ln.tree(), x.reshape(b, r * r, d), eps=eps)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """Classification logits (float32, mean-pooled tokens)."""
        toks = self.features(images)
        return dense(self.head.tree(), toks.mean(dim=1), compute_dtype=toks.dtype).float()


def _partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nW, window^2, C)."""
    b, h, w, c = x.shape
    nh, nw = h // window, w // window
    x = x.reshape(b, nh, window, nw, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nh * nw, window * window, c)


def _unpartition(x: torch.Tensor, window: int, res: int) -> torch.Tensor:
    b, _, _, c = x.shape
    nh = res // window
    x = x.reshape(b, nh, nh, window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, res, res, c)


# --- the JAX <-> module boundary ---------------------------------------------------

def params_from_jax(flat, cfg: SwinConfig, mesh=None) -> Swin:
    """JAX-layout tree (flat '/' paths or nested; numpy arrays or tensors;
    blocks stacked (pairs, 2, ...)) -> :class:`Swin`, on the tensors' device.
    Under ``mesh`` every parameter stays whole (the module docstring)."""
    flat = {p: _as_tensor(v) for p, v in trees.flatten_with_paths(flat).items()}
    pmesh.require_replicated(mesh, flat, 'Swin')
    return bind_mesh(Swin(cfg, flat), mesh)


def params_to_jax(model: Swin) -> dict[str, torch.Tensor]:
    """Inverse of :func:`params_from_jax`: flat '/' paths -> CPU tensors,
    blocks stacked (pairs, 2, ...)."""
    out = {}
    for t, m in model.embed.items():
        out.update({f"embed/{t}/{k}": v for k, v in m.leaves().items()})
    for s, stage in enumerate(model.stages):
        per_block = [trees.flatten_with_paths(
            {"ln1": b.ln1.leaves(), "ln2": b.ln2.leaves(),
             "attn": {**{t: m.leaves() for t, m in b.attn.items()}, "bias_table": b.bias_table},
             "mlp": {t: m.leaves() for t, m in b.mlp.items()}}) for b in stage.blocks]
        for p in per_block[0]:
            stacked = torch.stack([blk[p] for blk in per_block])
            out[f"stages/{s}/blocks/{p}"] = stacked.reshape(
                len(per_block) // 2, 2, *stacked.shape[1:])
        if stage.merge is not None:
            for t, m in stage.merge.items():
                out.update({f"stages/{s}/merge/{t}/{k}": v for k, v in m.leaves().items()})
    out.update({f"final_ln/{k}": v for k, v in model.final_ln.leaves().items()})
    out.update({f"head/{k}": v for k, v in model.head.leaves().items()})
    return {p: v.detach().cpu() for p, v in out.items()}


def features(cfg: SwinConfig, model: Swin, images: torch.Tensor) -> torch.Tensor:
    """Final-norm tokens (B, res^2, C_last) (the JAX ``swin.features`` signature)."""
    return model.features(images)


def apply(cfg: SwinConfig, model: Swin, images: torch.Tensor) -> torch.Tensor:
    """Forward pass to float32 logits (the JAX ``swin.apply`` signature)."""
    return model(images)


def lora_target_paths(cfg: SwinConfig) -> tuple[str, ...]:
    """Every stage's qkv and proj (factors stacked on the (pairs, 2) axes)."""
    return tuple(f"stages/{s}/blocks/attn/{t}" for s in range(cfg.num_stages)
                 for t in ("qkv", "proj"))
