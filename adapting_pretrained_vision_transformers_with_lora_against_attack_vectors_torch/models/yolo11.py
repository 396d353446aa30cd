"""YOLO11-cls (the CNN + attention classifier of the zoo) as ``nn.Module``s.

Counterpart of the JAX package's ``models/yolo11.py``: the published
ultralytics ``yolo11-cls.yaml`` architecture, a Conv stem ladder (P1..P5),
C3k2 CSP blocks, a C2PSA position-sensitive attention stage and the Classify
head (1x1 Conv to ``head_width``, global average pool, linear).

Param trees keep the JAX layout at the boundary: :func:`init` returns the
nested dict the JAX ``yolo11.init`` returns, every conv ``{"w": (k, k,
in/groups, out) HWIO, "bn": {"scale", "bias", "mean", "var"}}`` and repeated
members keyed ``"0"``, ``"1"``...; the module tree mirrors it, so a
parameter's name with ``.`` for ``/`` is its JAX path
(``c2psa.m.0.attn.qkv.w`` is ``c2psa/m/0/attn/qkv/w``) and the head's
parameters are under ``head.``.

BatchNorm runs in inference form, as in JAX: its statistics are parameters
of the tree (a full fine-tune trains them, as the JAX package does), there
are no running buffers and no batch statistics, so attacks and evaluation
are deterministic. The rounding order is the JAX one:

* a conv runs in the compute dtype (``F.conv2d`` over the channels-last
  tensor), its output rounded to that dtype, then widened to f32;
* an unmerged LoRA branch (1x1 stride-1 convs only: a channel matmul) adds
  ``s * ((x @ A) rounded to the compute dtype) @ B`` in f32, with the
  training-form dropout of ``ops.nn.dense`` (modes ``input`` and ``post_a``);
* BN is ``(out - mean) * rsqrt(var + eps) * scale + bias`` in f32, cast to
  the compute dtype; SiLU is ``x * sigmoid(x)`` in the compute dtype;
* C2PSA attention: f32 scores, scaled, f32 softmax, probabilities rounded to
  the compute dtype before P.V; a plain product (49 tokens at 224 px), no
  kernel in either package;
* the head pools the compute-dtype map (an f32 mean, rounded) and the
  classifier takes f32 accumulation plus an f32 bias.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nn import _mm_f32
from ..utils import trees
from .vit import Leaves, _as_tensor, _sub

# (depth_mult, width_mult, max_channels)
SCALES = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}


@dataclasses.dataclass(frozen=True)
class YOLO11Config:
    """Static architecture description (the JAX fields, under their names)."""

    image_size: int = 224
    scale: str = "n"
    num_classes: int = 21
    head_width: int = 1280
    bn_eps: float = 1e-3
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    def with_classes(self, num_classes: int) -> "YOLO11Config":
        return dataclasses.replace(self, num_classes=num_classes)

    @property
    def widths(self) -> tuple[int, ...]:
        """Channel widths for the 5 Conv ladder stops + C3k2 outputs."""
        _, w, mc = SCALES[self.scale]

        def ch(c):
            return int(math.ceil(min(c, mc) * w / 8) * 8)

        return tuple(ch(c) for c in (64, 128, 256, 256, 512, 512, 512, 1024, 1024))

    @property
    def n_bottlenecks(self) -> int:
        d, _, _ = SCALES[self.scale]
        return max(round(2 * d), 1)


YOLO11N_CLS = YOLO11Config(scale="n")
YOLO11S_CLS = YOLO11Config(scale="s")
YOLO11_TEST = YOLO11Config(image_size=64, scale="n", num_classes=10,
                           head_width=128, compute_dtype="float32")

# the stages in order: (tree key, kind, stride or c3k)
_LADDER = (("stem0", "conv", 2), ("stem1", "conv", 2), ("c3k2_0", "c3k2", False),
           ("down0", "conv", 2), ("c3k2_1", "c3k2", False), ("down1", "conv", 2),
           ("c3k2_2", "c3k2", True), ("down2", "conv", 2), ("c3k2_3", "c3k2", True),
           ("c2psa", "c2psa", None))


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# --- JAX-layout param trees ----------------------------------------------------

class _Init:
    """Leaf factory of :func:`init`: seeded draws on the CPU, moved to
    ``device``; on the ``meta`` device, shapes only (no draw, no storage)."""

    def __init__(self, g: torch.Generator, dtype, device):
        self.g, self.dtype = g, dtype
        self.device = torch.device(device) if device is not None else None
        self.meta = self.device is not None and self.device.type == "meta"

    def _put(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.device is not None else t

    def trunc_normal(self, shape, std: float) -> torch.Tensor:
        """Truncated normal (+-2 sigma) times ``std``."""
        if self.meta:
            return torch.empty(shape, dtype=self.dtype, device="meta")
        w = torch.empty(*shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=self.g)
        return self._put((w * std).to(self.dtype))

    def full(self, shape, value: float) -> torch.Tensor:
        if self.meta:
            return torch.empty(shape, dtype=self.dtype, device="meta")
        return self._put(torch.full(shape, value, dtype=self.dtype))

    def conv(self, k: int, c_in: int, c_out: int, *, groups: int = 1) -> dict:
        fan_in = k * k * (c_in // groups)
        return {"w": self.trunc_normal((k, k, c_in // groups, c_out), (2.0 / fan_in) ** 0.5),
                "bn": {"scale": self.full((c_out,), 1.0), "bias": self.full((c_out,), 0.0),
                       "mean": self.full((c_out,), 0.0), "var": self.full((c_out,), 1.0)}}

    def bottleneck(self, c: int, *, e: float) -> dict:
        c_ = int(c * e)
        return {"cv1": self.conv(3, c, c_), "cv2": self.conv(3, c_, c)}

    def c3k(self, c: int, n: int) -> dict:
        c_ = c // 2
        return {"cv1": self.conv(1, c, c_), "cv2": self.conv(1, c, c_),
                "cv3": self.conv(1, 2 * c_, c),
                "m": {str(i): self.bottleneck(c_, e=1.0) for i in range(n)}}

    def c3k2(self, c_in: int, c_out: int, n: int, *, c3k: bool) -> dict:
        c = int(c_out * (0.5 if c3k else 0.25))
        cv1 = self.conv(1, c_in, 2 * c)
        cv2 = self.conv(1, (2 + n) * c, c_out)
        m = {str(i): self.c3k(c, 2) if c3k else self.bottleneck(c, e=0.5) for i in range(n)}
        return {"cv1": cv1, "cv2": cv2, "m": m}

    def psablock(self, dim: int) -> dict:
        heads = max(dim // 64, 1)
        key_dim = int(dim // heads * 0.5)
        return {"attn": {"qkv": self.conv(1, dim, dim + heads * key_dim * 2),
                         "pe": self.conv(3, dim, dim, groups=dim),
                         "proj": self.conv(1, dim, dim)},
                "ffn1": self.conv(1, dim, dim * 2), "ffn2": self.conv(1, dim * 2, dim)}

    def c2psa(self, c: int, n: int) -> dict:
        c_ = c // 2
        return {"cv1": self.conv(1, c, 2 * c_), "cv2": self.conv(1, 2 * c_, c),
                "m": {str(i): self.psablock(c_) for i in range(n)}}


def init(cfg: YOLO11Config, generator: torch.Generator | None = None, *,
         device=None) -> dict:
    """Seeded random params in the JAX layout. ``device="meta"`` gives the
    tree's shapes and dtypes without drawing or allocating."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    mk = _Init(g, _dtype(cfg.param_dtype), device)
    W, n = cfg.widths, cfg.n_bottlenecks
    return {
        "stem0": mk.conv(3, 3, W[0]),                        # P1/2
        "stem1": mk.conv(3, W[0], W[1]),                     # P2/4
        "c3k2_0": mk.c3k2(W[1], W[2], n, c3k=False),
        "down0": mk.conv(3, W[2], W[3]),                     # P3/8
        "c3k2_1": mk.c3k2(W[3], W[4], n, c3k=False),
        "down1": mk.conv(3, W[4], W[5]),                     # P4/16
        "c3k2_2": mk.c3k2(W[5], W[6], n, c3k=True),
        "down2": mk.conv(3, W[6], W[7]),                     # P5/32
        "c3k2_3": mk.c3k2(W[7], W[8], n, c3k=True),
        "c2psa": mk.c2psa(W[8], n),
        "head": {"conv": mk.conv(1, W[8], cfg.head_width),
                 "linear": {"w": mk.trunc_normal((cfg.head_width, cfg.num_classes), 0.02),
                            "b": mk.full((cfg.num_classes,), 0.0)}},
    }


# --- modules --------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` in x's dtype."""
    return x * torch.sigmoid(x)


class Conv(Leaves):
    """conv -> [unmerged LoRA on a 1x1 stride-1 conv] -> BN affine in f32 ->
    cast -> [SiLU], over (B, H, W, C). Its own leaves (``w``, the LoRA
    factors and their dropout stream) are :class:`..models.vit.Leaves`; the
    BN leaves are the ``bn`` child."""

    def __init__(self, flat: Mapping[str, torch.Tensor], eps: float, *, stride: int = 1,
                 groups: int = 1, act: bool = True):
        super().__init__({k: v for k, v in flat.items() if "/" not in k})
        self.bn = Leaves(_sub(flat, "bn"))
        self.eps, self.stride, self.groups, self.act = eps, stride, groups, act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = x.dtype
        w = self.w.to(cd)
        k = w.shape[0]
        out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None, self.stride, k // 2,
                       1, self.groups).permute(0, 2, 3, 1).float()
        p = self.tree()
        if "lora_a" in p and k == 1 and self.stride == 1 and self.groups == 1:
            drop = p.get("lora_drop")
            xb = x
            if drop is not None and drop.mode == "input":
                xb = x * drop.scale(x.shape, x.device).to(cd)
            xa = _mm_f32(xb, p["lora_a"][0, 0].to(cd)).to(cd)
            if drop is not None and drop.mode == "post_a":
                xa = xa * drop.scale(xa.shape, xa.device).to(cd)
            out = out + p["lora_s"].reshape(()).float() * _mm_f32(xa, p["lora_b"][0, 0].to(cd))
        bn = self.bn
        inv = torch.rsqrt(bn.var.float() + self.eps)
        out = ((out - bn.mean.float()) * inv * bn.scale.float() + bn.bias.float()).to(cd)
        return silu(out) if self.act else out


def _conv(flat, prefix: str, cfg: YOLO11Config, **kw) -> Conv:
    return Conv(_sub(flat, prefix), cfg.bn_eps, **kw)


def _members(flat) -> list[str]:
    """The member keys under ``m``, in numeric order."""
    return sorted({p.split("/", 1)[0] for p in _sub(flat, "m")}, key=int)


class Bottleneck(nn.Module):
    """x + cv2(cv1(x))."""

    def __init__(self, flat, cfg: YOLO11Config):
        super().__init__()
        self.cv1, self.cv2 = _conv(flat, "cv1", cfg), _conv(flat, "cv2", cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.cv2(self.cv1(x))


class C3k(nn.Module):
    """CSP triple conv around its bottlenecks."""

    def __init__(self, flat, cfg: YOLO11Config):
        super().__init__()
        self.cv1, self.cv2, self.cv3 = (_conv(flat, t, cfg) for t in ("cv1", "cv2", "cv3"))
        self.m = nn.ModuleDict({i: Bottleneck(_sub(flat, f"m/{i}"), cfg)
                                for i in _members(flat)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv1(x)
        for block in self.m.values():
            a = block(a)
        return self.cv3(torch.cat([a, self.cv2(x)], dim=-1))


class C3k2(nn.Module):
    """cv1, split in halves, a chain of bottlenecks (or C3k blocks) on the
    second half, cv2 over every intermediate."""

    def __init__(self, flat, cfg: YOLO11Config, c3k: bool):
        super().__init__()
        self.cv1, self.cv2 = _conv(flat, "cv1", cfg), _conv(flat, "cv2", cfg)
        block = C3k if c3k else Bottleneck
        self.m = nn.ModuleDict({i: block(_sub(flat, f"m/{i}"), cfg) for i in _members(flat)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.cv1(x)
        c = h.shape[-1] // 2
        ys = [h[..., :c], h[..., c:]]
        for block in self.m.values():
            ys.append(block(ys[-1]))
        return self.cv2(torch.cat(ys, dim=-1))


class Attention(nn.Module):
    """C2PSA attention over the H*W tokens plus a depthwise positional conv
    on v. The qkv channels are interleaved per head as ``[q | k | v]``; the
    head count is ``max(C // 64, 1)`` and the key width is read off the qkv
    weight, as in JAX."""

    def __init__(self, flat, cfg: YOLO11Config):
        super().__init__()
        dim = flat["qkv/w"].shape[-2]
        self.qkv = _conv(flat, "qkv", cfg, act=False)
        self.pe = _conv(flat, "pe", cfg, groups=dim, act=False)
        self.proj = _conv(flat, "proj", cfg, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        heads = max(c // 64, 1)
        head_dim = c // heads
        key_dim = (self.qkv.w.shape[-1] - c) // (2 * heads)
        qkv = self.qkv(x).reshape(b, hh * ww, heads, 2 * key_dim + head_dim)
        q, k, v = qkv.split((key_dim, key_dim, head_dim), dim=-1)
        scores = torch.matmul(q.transpose(1, 2).float(), k.permute(0, 2, 3, 1).float())
        probs = torch.softmax(scores * key_dim ** -0.5, dim=-1)
        out = torch.matmul(probs.to(x.dtype), v.transpose(1, 2))  # (b, heads, n, head_dim)
        out = out.transpose(1, 2).reshape(b, hh, ww, c)
        out = out + self.pe(v.reshape(b, hh, ww, c))
        return self.proj(out)


class PSABlock(nn.Module):
    def __init__(self, flat, cfg: YOLO11Config):
        super().__init__()
        self.attn = Attention(_sub(flat, "attn"), cfg)
        self.ffn1 = _conv(flat, "ffn1", cfg)
        self.ffn2 = _conv(flat, "ffn2", cfg, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        return x + self.ffn2(self.ffn1(x))


class C2PSA(nn.Module):
    def __init__(self, flat, cfg: YOLO11Config):
        super().__init__()
        self.cv1, self.cv2 = _conv(flat, "cv1", cfg), _conv(flat, "cv2", cfg)
        self.m = nn.ModuleDict({i: PSABlock(_sub(flat, f"m/{i}"), cfg)
                                for i in _members(flat)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.cv1(x)
        c = h.shape[-1] // 2
        a, b = h[..., :c], h[..., c:]
        for block in self.m.values():
            b = block(b)
        return self.cv2(torch.cat([a, b], dim=-1))


class Classify(nn.Module):
    """1x1 conv -> mean pool -> linear (f32 accumulation, f32 bias)."""

    def __init__(self, flat, cfg: YOLO11Config):
        super().__init__()
        self.conv = _conv(flat, "conv", cfg)
        self.linear = Leaves(_sub(flat, "linear"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        pooled = x.float().mean(dim=(1, 2)).to(x.dtype)
        return _mm_f32(pooled, self.linear.w.to(x.dtype)) + self.linear.b.float()


class YOLO11(nn.Module):
    """YOLO11-cls over NHWC images; built from a flat JAX-layout tree."""

    def __init__(self, cfg: YOLO11Config, flat: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for key, kind, arg in _LADDER:
            sub = _sub(flat, key)
            if kind == "conv":
                mod = Conv(sub, cfg.bn_eps, stride=arg)
            elif kind == "c3k2":
                mod = C3k2(sub, cfg, arg)
            else:
                mod = C2PSA(sub, cfg)
            self.add_module(key, mod)
        self.head = Classify(_sub(flat, "head"), cfg)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """Normalized images (B, H, W, 3) -> the C2PSA output map (B, H/32, W/32, C)."""
        x = images.to(_dtype(self.cfg.compute_dtype))
        for key, _, _ in _LADDER:
            x = getattr(self, key)(x)
        return x

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """Classification logits (float32)."""
        return self.head(self.features(images))


# --- the JAX <-> module boundary ---------------------------------------------------

def params_from_jax(flat, cfg: YOLO11Config) -> YOLO11:
    """JAX-layout tree (flat '/' paths or nested; numpy arrays or tensors)
    -> :class:`YOLO11`, on the tensors' device."""
    return YOLO11(cfg, {p: _as_tensor(v) for p, v in trees.flatten_with_paths(flat).items()})


def params_to_jax(model: YOLO11) -> dict[str, torch.Tensor]:
    """Inverse of :func:`params_from_jax`: flat '/' paths -> CPU tensors
    (the module tree is the JAX tree, so a name with '/' for '.' is the path)."""
    return {n.replace(".", "/"): p.detach().cpu() for n, p in model.named_parameters()}


def features(cfg: YOLO11Config, model: YOLO11, images: torch.Tensor) -> torch.Tensor:
    """The pre-head feature map (the JAX ``yolo11.features`` signature)."""
    return model.features(images)


def apply(cfg: YOLO11Config, model: YOLO11, images: torch.Tensor) -> torch.Tensor:
    """Forward pass to float32 logits (the JAX ``yolo11.apply`` signature)."""
    return model(images)


def lora_target_paths(cfg: YOLO11Config) -> tuple[str, ...]:
    """LoRA on the attention stage's projections (the transformer-like part)."""
    return tuple(f"c2psa/m/{i}/attn/{t}" for i in range(cfg.n_bottlenecks)
                 for t in ("qkv", "proj"))
