"""Plain reference of the Swin family (Liu et al., 2021; the
``microsoft/swin-*-patch4-window7-*`` checkpoints' architecture), float32.

Patch embedding (a dense over each 4x4x3 patch, then LayerNorm), four stages
of pre-LN blocks ``x + proj(W-MSA(LN1(x)))``, ``x + MLP(LN2(x))`` over 7x7
windows, every second block of a stage on windows shifted by 3 (the map
rolled by -3, an additive mask of -100 between tokens of different regions,
rolled back after), a relative position bias from a (2W-1)² table, patch
merging between stages (the 2x2 neighbours concatenated in timm's order,
LayerNorm, a dense without bias), a final LayerNorm, mean pooling and a dense
head. A stage whose map is one window has no shift. Parameters are a flat
'/'-path tree in the JAX layout (:func:`layout`): each stage's blocks stacked
on ``(depth // 2, 2)`` axes, dense weights ``(in, out)``.
"""

from __future__ import annotations

import dataclasses

import torch

from . import common as C


@dataclasses.dataclass(frozen=True)
class Cfg:
    image_size: int
    patch_size: int
    window: int
    embed: int
    depths: tuple
    heads: tuple
    mlp_ratio: float
    classes: int
    eps: float

    def dim(self, s: int) -> int:
        return self.embed * 2 ** s

    def res(self, s: int) -> int:
        return self.image_size // self.patch_size // 2 ** s


def config(d: dict) -> Cfg:
    """The configuration file's published widths (HF ``SwinConfig`` keys)."""
    return Cfg(d["image_size"], d["patch_size"], d["window_size"], d["embed_dim"],
               tuple(d["depths"]), tuple(d["num_heads"]), d["mlp_ratio"], d["num_labels"],
               d["layer_norm_eps"])


def port_fields(d: dict) -> dict:
    return {"image_size": d["image_size"], "patch_size": d["patch_size"],
            "window": d["window_size"], "embed_dim": d["embed_dim"],
            "depths": tuple(d["depths"]), "num_heads": tuple(d["num_heads"]),
            "mlp_ratio": d["mlp_ratio"], "num_classes": d["num_labels"],
            "layer_norm_eps": d["layer_norm_eps"], "compute_dtype": d["compute_dtype"]}


def layout(cfg: Cfg) -> dict:
    out = {"embed/proj/w": ((cfg.patch_size ** 2 * 3, cfg.embed), "dense"),
           "embed/proj/b": ((cfg.embed,), "small"),
           "embed/norm/scale": ((cfg.embed,), "scale"), "embed/norm/bias": ((cfg.embed,), "small")}
    last = len(cfg.depths) - 1
    for s, depth in enumerate(cfg.depths):
        c, m, lead = cfg.dim(s), int(cfg.dim(s) * cfg.mlp_ratio), (depth // 2, 2)
        pre = f"stages/{s}/blocks"
        for ln in ("ln1", "ln2"):
            out[f"{pre}/{ln}/scale"] = ((*lead, c), "scale")
            out[f"{pre}/{ln}/bias"] = ((*lead, c), "small")
        for name, (i, o) in (("attn/qkv", (c, 3 * c)), ("attn/proj", (c, c)),
                             ("mlp/fc1", (c, m)), ("mlp/fc2", (m, c))):
            out[f"{pre}/{name}/w"] = ((*lead, i, o), "dense")
            out[f"{pre}/{name}/b"] = ((*lead, o), "small")
        out[f"{pre}/attn/bias_table"] = ((*lead, (2 * cfg.window - 1) ** 2, cfg.heads[s]), "small")
        if s < last:
            out[f"stages/{s}/merge/norm/scale"] = ((4 * c,), "scale")
            out[f"stages/{s}/merge/norm/bias"] = ((4 * c,), "small")
            out[f"stages/{s}/merge/reduce/w"] = ((4 * c, 2 * c), "dense")
    c = cfg.dim(last)
    out["final_ln/scale"], out["final_ln/bias"] = ((c,), "scale"), ((c,), "small")
    out["head/w"], out["head/b"] = ((c, cfg.classes), "dense"), ((cfg.classes,), "small")
    return out


def rel_index(window: int, device) -> torch.Tensor:
    """(W², W²) indices into the (2W-1)² bias table."""
    ij = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                    indexing="ij")).reshape(2, -1)
    rel = (ij[:, :, None] - ij[:, None, :]).permute(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).to(device)


def windows(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nW, w², C), windows row-major."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // w) * (ww // w), w * w, c)


def unwindows(x: torch.Tensor, w: int, res: int) -> torch.Tensor:
    b, _, _, c = x.shape
    n = res // w
    return x.reshape(b, n, n, w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(b, res, res, c)


def shift_mask(res: int, w: int, shift: int, device) -> torch.Tensor:
    """(nW, w², w²): -100 between tokens of different regions of the rolled map."""
    img = torch.zeros(res, res)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    ids = windows(img[None, :, :, None], w)[0, :, :, 0]
    return torch.where(ids[:, :, None] != ids[:, None, :], -100.0, 0.0).to(device)


def block(p: dict, x: torch.Tensor, cfg: Cfg, heads: int, shift: int, lowp=None) -> torch.Tensor:
    """One block on the (B, H, W, C) map."""
    b, res, _, c = x.shape
    w, hd = cfg.window, c // heads
    y = C.layer_norm(C.sub(p, "ln1"), x, cfg.eps)
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    y = windows(y, w)
    nw, n = y.shape[1], y.shape[2]
    qkv = C.dense(C.sub(p, "attn/qkv"), y, lowp).reshape(b, nw, n, 3, heads, hd)
    q, k, v = qkv.permute(3, 0, 1, 4, 2, 5)  # each (B, nW, heads, n, hd)
    bias = p["attn/bias_table"][rel_index(w, x.device)].permute(2, 0, 1)  # (heads, n, n)
    add = bias[None, None]
    if shift:
        add = add + shift_mask(res, w, shift, x.device)[None, :, None]
    a = C.softmax_attention(q, k, v, hd ** -0.5, add, lowp)
    a = C.dense(C.sub(p, "attn/proj"), a.transpose(2, 3).reshape(b, nw, n, c), lowp)
    a = unwindows(a, w, res)
    if shift:
        a = torch.roll(a, (shift, shift), (1, 2))
    x = x + a
    y = C.layer_norm(C.sub(p, "ln2"), x, cfg.eps)
    return x + C.dense(C.sub(p, "mlp/fc2"), C.gelu(C.dense(C.sub(p, "mlp/fc1"), y, lowp)), lowp)


def forward(params: dict, cfg: Cfg, x: torch.Tensor, *, lowp=None, lora=None,
            masks=None) -> torch.Tensor:
    """Normalized NHWC images -> f32 logits (no adapter: ``lora`` must be None)."""
    if lora is not None:
        raise NotImplementedError("the Swin reference has no adapter branch")
    b, hh, ww, ch = x.shape
    p = cfg.patch_size
    x = x.reshape(b, hh // p, p, ww // p, p, ch).permute(0, 1, 3, 2, 4, 5)
    x = C.dense(C.sub(params, "embed/proj"), x.reshape(b, hh // p, ww // p, p * p * ch), lowp)
    x = C.layer_norm(C.sub(params, "embed/norm"), x, cfg.eps)
    for s, depth in enumerate(cfg.depths):
        blocks = C.sub(params, f"stages/{s}/blocks")
        windowed = cfg.res(s) > cfg.window
        for i in range(depth):
            shift = cfg.window // 2 if windowed and i % 2 else 0
            x = block(C.layer(blocks, (i // 2, i % 2)), x, cfg, cfg.heads[s], shift, lowp)
        if s < len(cfg.depths) - 1:
            r = x.shape[1]
            x = x.reshape(b, r // 2, 2, r // 2, 2, x.shape[-1])
            x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0], x[:, :, 0, :, 1],
                           x[:, :, 1, :, 1]], dim=-1)
            x = C.layer_norm(C.sub(params, f"stages/{s}/merge/norm"), x, cfg.eps)
            x = C.dense(C.sub(params, f"stages/{s}/merge/reduce"), x, lowp)
    x = C.layer_norm(C.sub(params, "final_ln"), x.reshape(b, -1, x.shape[-1]), cfg.eps)
    return C.dense(C.sub(params, "head"), x.mean(dim=1), lowp)


def port_leaf(name: str) -> tuple[str, tuple | None]:
    """``stages.2.blocks.5.attn.qkv.w`` -> (``stages/2/blocks/attn/qkv/w``, (2, 1))."""
    parts = name.split(".")
    if parts[0] == "stages" and parts[2] == "blocks":
        i = int(parts[3])
        rest = parts[4:]
        if rest == ["bias_table"]:
            rest = ["attn", "bias_table"]
        return f"stages/{parts[1]}/blocks/" + "/".join(rest), (i // 2, i % 2)
    return "/".join(parts), None


def stacked(path: str) -> int:
    """How many leading axes of the leaf at ``path`` stack blocks: (pairs, 2)."""
    return 2 if "/blocks/" in path else 0
