"""Pretrained-weight import: HF, timm and ultralytics state dicts -> param trees.

Counterpart of the JAX package's ``models/hf_import.py``, with its names,
key maps and errors. Each importer takes a state dict (torch tensors or numpy
arrays, any float dtype; every value becomes an f32 CPU tensor, as the JAX
``_as_numpy`` makes it an f32 array) and returns the backbone's JAX-layout
nested tree of f32 CPU tensors, which ``entry.from_tree`` takes:

* HF ``ViTForImageClassification`` / a head-less ``ViTModel`` (DINOv1) and
  the inverse :func:`hf_from_vit_params`; HF ``SwinForImageClassification``
  and ``ConvNextForImageClassification``;
* timm's ``vit_*``, ``swin_*`` and ``convnext_*`` naming;
* ultralytics YOLO11-cls (``model.N...``) and the inverse
  :func:`ultralytics_from_yolo11_params`.

Layout conversions: torch ``nn.Linear`` stores ``(out, in)``, the trees
``(in, out)``; a torch conv ``(O, I, kh, kw)`` becomes HWIO; the stride-P
patch conv becomes the ``(P*P*C, D)`` patch-matmul kernel in (row, col,
channel) pixel order; per-layer tensors stack on a leading depth axis (Swin:
``(pairs, 2, ...)``). The ViT importers hold the learned position table to
the config's tokens (197 rows at 224 px, 577 at 384) and raise
``ValueError`` on a table of another size.

:func:`load_checkpoint_state_dict` reads a file or an HF model directory:
``.safetensors`` with the port's own reader (``utils/checkpoint``), ``.pth``
/ ``.bin`` with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from ..utils import checkpoint, trees
from .vit import ViTConfig, _as_tensor

# (framework path in block i, HF template) for per-layer tensors
_LAYER_MAP = {
    "ln1/scale": "vit.encoder.layer.{i}.layernorm_before.weight",
    "ln1/bias": "vit.encoder.layer.{i}.layernorm_before.bias",
    "attn/q/w": "vit.encoder.layer.{i}.attention.attention.query.weight",
    "attn/q/b": "vit.encoder.layer.{i}.attention.attention.query.bias",
    "attn/k/w": "vit.encoder.layer.{i}.attention.attention.key.weight",
    "attn/k/b": "vit.encoder.layer.{i}.attention.attention.key.bias",
    "attn/v/w": "vit.encoder.layer.{i}.attention.attention.value.weight",
    "attn/v/b": "vit.encoder.layer.{i}.attention.attention.value.bias",
    "attn/o/w": "vit.encoder.layer.{i}.attention.output.dense.weight",
    "attn/o/b": "vit.encoder.layer.{i}.attention.output.dense.bias",
    "ln2/scale": "vit.encoder.layer.{i}.layernorm_after.weight",
    "ln2/bias": "vit.encoder.layer.{i}.layernorm_after.bias",
    "mlp/fc1/w": "vit.encoder.layer.{i}.intermediate.dense.weight",
    "mlp/fc1/b": "vit.encoder.layer.{i}.intermediate.dense.bias",
    "mlp/fc2/w": "vit.encoder.layer.{i}.output.dense.weight",
    "mlp/fc2/b": "vit.encoder.layer.{i}.output.dense.bias",
}


def _as_f32(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """Every value as an f32 CPU tensor (bf16 and integer entries too)."""
    out = {}
    for k, v in state_dict.items():
        t = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v, order="C"))
        out[k] = t.float()
    return out


def _getter(sd: dict, what: str, dtype):
    def get(name):
        if name not in sd:
            raise KeyError(f"missing {name!r} in {what} state dict")
        return sd[name].to(dtype)

    return get


def _t(x: torch.Tensor) -> torch.Tensor:
    """(out, in) -> (in, out)."""
    return x.T.contiguous()


def _hwio(x: torch.Tensor) -> torch.Tensor:
    """torch conv (O, I, kh, kw) -> (kh, kw, I, O)."""
    return x.permute(2, 3, 1, 0).contiguous()


def _patch_kernel(conv_w: torch.Tensor, p: int) -> torch.Tensor:
    """(D, C, P, P) -> (P*P*C, D), the order of ``models.vit._patchify``."""
    d, c = conv_w.shape[:2]
    return conv_w.permute(2, 3, 1, 0).reshape(p * p * c, d).contiguous()


def _stack(per_block: list[dict], lead: tuple[int, ...] = ()) -> dict:
    """Per-block nested dicts -> one nested dict stacked on a leading axis,
    reshaped to ``lead`` when given (Swin's ``(pairs, 2)``)."""
    flat = [trees.flatten_with_paths(b) for b in per_block]
    out = {}
    for p in flat[0]:
        s = torch.stack([f[p] for f in flat])
        out[p] = s.reshape(*lead, *s.shape[1:]) if lead else s
    return trees.unflatten_from_paths(out)


def _nested(params) -> dict:
    """A tree given flat ('/' paths) or nested -> nested."""
    return trees.unflatten_from_paths(trees.flatten_with_paths(params))


def _position_table(pos: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """The checkpoint's learned position table ``(1, rows, D)``, whose rows
    must be the config's tokens (the patches and the CLS token): a table of
    another resolution (197 rows at 224 px, 577 at 384) is a named error
    here, not a failed add downstream."""
    if pos.dim() != 3 or pos.shape[1] != cfg.seq_len:
        raise ValueError(f"position table {tuple(pos.shape)} != config's {cfg.seq_len} rows "
                         f"({cfg.image_size} px, patch {cfg.patch_size}): a checkpoint of "
                         "another image size?")
    return pos


def vit_params_from_hf(state_dict: Mapping, cfg: ViTConfig, *, dtype=torch.float32,
                       prefix: str = "vit.", allow_missing_head: bool = False) -> dict:
    """HF ``ViTForImageClassification`` state dict -> ViT param tree.

    ``prefix``: backbone key prefix, ``"vit."`` for
    ``ViTForImageClassification``, ``""`` for a bare ``ViTModel`` (the DINOv1
    checkpoints are head-less ViTModels; ``allow_missing_head=True`` then
    zero-inits the classifier)."""
    sd = _as_f32(state_dict)

    def get(name):
        name = prefix + name.removeprefix("vit.") if name.startswith("vit.") else name
        if name not in sd:
            raise KeyError(f"missing {name!r} in state dict "
                           f"(have e.g. {sorted(sd)[:3]}...)")
        return sd[name].to(dtype)

    conv_w = get("vit.embeddings.patch_embeddings.projection.weight")  # (D, C, P, P)
    d, _, p, _ = conv_w.shape
    if (p, d) != (cfg.patch_size, cfg.hidden_dim):
        raise ValueError(f"checkpoint geometry ({d=}, {p=}) != config "
                         f"({cfg.hidden_dim}, {cfg.patch_size})")
    pos = _position_table(get("vit.embeddings.position_embeddings"), cfg)
    stacked = {}
    for path, tmpl in _LAYER_MAP.items():
        layers = [get(tmpl.format(i=i)) for i in range(cfg.depth)]
        stacked[path] = torch.stack([_t(a) if path.endswith("/w") else a for a in layers])

    if "classifier.weight" in sd:
        head_w = _t(sd["classifier.weight"].to(dtype))
        head_b = sd["classifier.bias"].to(dtype)
        if head_w.shape[1] != cfg.num_classes:
            raise ValueError(f"classifier has {head_w.shape[1]} classes, "
                             f"config expects {cfg.num_classes}")
    elif allow_missing_head:
        head_w = torch.zeros(cfg.hidden_dim, cfg.num_classes, dtype=dtype)
        head_b = torch.zeros(cfg.num_classes, dtype=dtype)
    else:
        raise KeyError("missing 'classifier.weight' "
                       "(pass allow_missing_head=True for backbone-only "
                       "checkpoints like DINO)")
    return {
        "embed": {
            "proj": {"w": _patch_kernel(conv_w, p),
                     "b": get("vit.embeddings.patch_embeddings.projection.bias")},
            "cls": get("vit.embeddings.cls_token"),
            "pos": pos,
        },
        "blocks": trees.unflatten_from_paths(stacked),
        "final_ln": {"scale": get("vit.layernorm.weight"), "bias": get("vit.layernorm.bias")},
        "head": {"w": head_w, "b": head_b},
    }


def hf_from_vit_params(params, cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """Inverse of :func:`vit_params_from_hf`: an HF-named state dict of
    contiguous f32 CPU tensors."""
    def f32(x):
        return _as_tensor(x).detach().cpu().float()

    params = _nested(params)
    p, d = cfg.patch_size, cfg.hidden_dim
    proj_w = f32(params["embed"]["proj"]["w"]).reshape(p, p, 3, d).permute(3, 2, 0, 1)
    sd = {
        "vit.embeddings.patch_embeddings.projection.weight": proj_w.contiguous(),
        "vit.embeddings.patch_embeddings.projection.bias": f32(params["embed"]["proj"]["b"]),
        "vit.embeddings.cls_token": f32(params["embed"]["cls"]),
        "vit.embeddings.position_embeddings": f32(params["embed"]["pos"]),
        "vit.layernorm.weight": f32(params["final_ln"]["scale"]),
        "vit.layernorm.bias": f32(params["final_ln"]["bias"]),
        "classifier.weight": _t(f32(params["head"]["w"])),
        "classifier.bias": f32(params["head"]["b"]),
    }
    stacked = trees.flatten_with_paths(params["blocks"])
    for path, tmpl in _LAYER_MAP.items():
        arr = f32(stacked[path])
        for i in range(cfg.depth):
            sd[tmpl.format(i=i)] = _t(arr[i]) if path.endswith("/w") else arr[i].contiguous()
    return sd


def swin_params_from_hf(state_dict: Mapping, cfg, *, dtype=torch.float32) -> dict:
    """HF ``SwinForImageClassification`` state dict -> Swin param tree. HF
    stores separate q/k/v projections; the tree fuses them into one ``qkv``
    kernel (concatenated on the output axis, order q|k|v). Per-stage blocks
    stack as ``(pairs, 2, ...)``."""
    get = _getter(_as_f32(state_dict), "Swin", dtype)
    stages = {}
    for s, depth in enumerate(cfg.depths):
        prefix = f"swin.encoder.layers.{s}"
        per_block = []
        for j in range(depth):
            bp = f"{prefix}.blocks.{j}"
            q, k, v = (f"{bp}.attention.self.{t}" for t in ("query", "key", "value"))
            per_block.append({
                "ln1": {"scale": get(f"{bp}.layernorm_before.weight"),
                        "bias": get(f"{bp}.layernorm_before.bias")},
                "attn": {
                    "qkv": {"w": torch.cat([_t(get(f"{n}.weight")) for n in (q, k, v)], dim=-1),
                            "b": torch.cat([get(f"{n}.bias") for n in (q, k, v)])},
                    "proj": {"w": _t(get(f"{bp}.attention.output.dense.weight")),
                             "b": get(f"{bp}.attention.output.dense.bias")},
                    "bias_table": get(f"{bp}.attention.self.relative_position_bias_table"),
                },
                "ln2": {"scale": get(f"{bp}.layernorm_after.weight"),
                        "bias": get(f"{bp}.layernorm_after.bias")},
                "mlp": {"fc1": {"w": _t(get(f"{bp}.intermediate.dense.weight")),
                                "b": get(f"{bp}.intermediate.dense.bias")},
                        "fc2": {"w": _t(get(f"{bp}.output.dense.weight")),
                                "b": get(f"{bp}.output.dense.bias")}},
            })
        stage = {"blocks": _stack(per_block, (depth // 2, 2))}
        if s < len(cfg.depths) - 1:
            stage["merge"] = {
                "norm": {"scale": get(f"{prefix}.downsample.norm.weight"),
                         "bias": get(f"{prefix}.downsample.norm.bias")},
                "reduce": {"w": _t(get(f"{prefix}.downsample.reduction.weight"))},
            }
        stages[str(s)] = stage
    return {
        "embed": {
            "proj": {"w": _patch_kernel(get("swin.embeddings.patch_embeddings.projection.weight"),
                                        cfg.patch_size),
                     "b": get("swin.embeddings.patch_embeddings.projection.bias")},
            "norm": {"scale": get("swin.embeddings.norm.weight"),
                     "bias": get("swin.embeddings.norm.bias")},
        },
        "stages": stages,
        "final_ln": {"scale": get("swin.layernorm.weight"), "bias": get("swin.layernorm.bias")},
        "head": {"w": _t(get("classifier.weight")), "b": get("classifier.bias")},
    }


def convnext_params_from_hf(state_dict: Mapping, cfg, *, dtype=torch.float32) -> dict:
    """HF ``ConvNextForImageClassification`` state dict -> ConvNeXt param
    tree: conv weights HWIO, per-stage blocks stacked on a leading axis."""
    get = _getter(_as_f32(state_dict), "ConvNeXt", dtype)
    stages = {}
    for s, depth in enumerate(cfg.depths):
        prefix = f"convnext.encoder.stages.{s}"
        per_block = []
        for j in range(depth):
            bp = f"{prefix}.layers.{j}"
            per_block.append({
                "dwconv": {"w": _hwio(get(f"{bp}.dwconv.weight")), "b": get(f"{bp}.dwconv.bias")},
                "norm": {"scale": get(f"{bp}.layernorm.weight"),
                         "bias": get(f"{bp}.layernorm.bias")},
                "pwconv1": {"w": _t(get(f"{bp}.pwconv1.weight")), "b": get(f"{bp}.pwconv1.bias")},
                "pwconv2": {"w": _t(get(f"{bp}.pwconv2.weight")), "b": get(f"{bp}.pwconv2.bias")},
                "gamma": get(f"{bp}.layer_scale_parameter"),
            })
        stage = {"blocks": _stack(per_block)}
        if s > 0:
            stage["downsample"] = {
                "norm": {"scale": get(f"{prefix}.downsampling_layer.0.weight"),
                         "bias": get(f"{prefix}.downsampling_layer.0.bias")},
                "conv": {"w": _hwio(get(f"{prefix}.downsampling_layer.1.weight")),
                         "b": get(f"{prefix}.downsampling_layer.1.bias")},
            }
        stages[str(s)] = stage
    return {
        "stem": {"conv": {"w": _hwio(get("convnext.embeddings.patch_embeddings.weight")),
                          "b": get("convnext.embeddings.patch_embeddings.bias")},
                 "norm": {"scale": get("convnext.embeddings.layernorm.weight"),
                          "bias": get("convnext.embeddings.layernorm.bias")}},
        "stages": stages,
        "final_ln": {"scale": get("convnext.layernorm.weight"),
                     "bias": get("convnext.layernorm.bias")},
        "head": {"w": _t(get("classifier.weight")), "b": get("classifier.bias")},
    }


def load_checkpoint_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A state dict (f32 CPU tensors) from ``.safetensors``, a torch ``.pth``
    / ``.bin`` (the reference's checkpoint format), or an HF model directory
    holding ``model.safetensors`` or ``pytorch_model.bin``."""
    if os.path.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                return load_checkpoint_state_dict(cand)
        raise FileNotFoundError(f"no weights file in {path}")
    if path.endswith(".safetensors"):
        return _as_f32(checkpoint.load_tensors(path)[0])
    return _as_f32(torch.load(path, map_location="cpu", weights_only=True))


# --- timm-format importers ----------------------------------------------------
# timm's published state-dict naming; held by round trips on synthetic state
# dicts, as in the JAX package (the HF importers are the forward-parity path).

def swin_params_from_timm(state_dict: Mapping, cfg, *, dtype=torch.float32) -> dict:
    """timm ``swin_*_patch4_window7_224`` state dict -> Swin param tree
    (timm already stores the fused qkv, rows q;k;v)."""
    sd = _as_f32(state_dict)
    get = _getter(sd, "timm Swin", dtype)
    stages = {}
    for s, depth in enumerate(cfg.depths):
        per_block = []
        for j in range(depth):
            bp = f"layers.{s}.blocks.{j}"
            per_block.append({
                "ln1": {"scale": get(f"{bp}.norm1.weight"), "bias": get(f"{bp}.norm1.bias")},
                "attn": {
                    "qkv": {"w": _t(get(f"{bp}.attn.qkv.weight")), "b": get(f"{bp}.attn.qkv.bias")},
                    "proj": {"w": _t(get(f"{bp}.attn.proj.weight")),
                             "b": get(f"{bp}.attn.proj.bias")},
                    "bias_table": get(f"{bp}.attn.relative_position_bias_table"),
                },
                "ln2": {"scale": get(f"{bp}.norm2.weight"), "bias": get(f"{bp}.norm2.bias")},
                "mlp": {"fc1": {"w": _t(get(f"{bp}.mlp.fc1.weight")),
                                "b": get(f"{bp}.mlp.fc1.bias")},
                        "fc2": {"w": _t(get(f"{bp}.mlp.fc2.weight")),
                                "b": get(f"{bp}.mlp.fc2.bias")}},
            })
        stage = {"blocks": _stack(per_block, (depth // 2, 2))}
        if s < len(cfg.depths) - 1:
            stage["merge"] = {
                "norm": {"scale": get(f"layers.{s}.downsample.norm.weight"),
                         "bias": get(f"layers.{s}.downsample.norm.bias")},
                "reduce": {"w": _t(get(f"layers.{s}.downsample.reduction.weight"))},
            }
        stages[str(s)] = stage
    head = "head.fc" if "head.fc.weight" in sd else "head"
    return {
        "embed": {
            "proj": {"w": _patch_kernel(get("patch_embed.proj.weight"), cfg.patch_size),
                     "b": get("patch_embed.proj.bias")},
            "norm": {"scale": get("patch_embed.norm.weight"), "bias": get("patch_embed.norm.bias")},
        },
        "stages": stages,
        "final_ln": {"scale": get("norm.weight"), "bias": get("norm.bias")},
        "head": {"w": _t(get(f"{head}.weight")), "b": get(f"{head}.bias")},
    }


def convnext_params_from_timm(state_dict: Mapping, cfg, *, dtype=torch.float32) -> dict:
    """timm ``convnext_*`` state dict -> ConvNeXt param tree."""
    get = _getter(_as_f32(state_dict), "timm ConvNeXt", dtype)
    stages = {}
    for s, depth in enumerate(cfg.depths):
        per_block = []
        for j in range(depth):
            bp = f"stages.{s}.blocks.{j}"
            per_block.append({
                "dwconv": {"w": _hwio(get(f"{bp}.conv_dw.weight")),
                           "b": get(f"{bp}.conv_dw.bias")},
                "norm": {"scale": get(f"{bp}.norm.weight"), "bias": get(f"{bp}.norm.bias")},
                "pwconv1": {"w": _t(get(f"{bp}.mlp.fc1.weight")), "b": get(f"{bp}.mlp.fc1.bias")},
                "pwconv2": {"w": _t(get(f"{bp}.mlp.fc2.weight")), "b": get(f"{bp}.mlp.fc2.bias")},
                "gamma": get(f"{bp}.gamma"),
            })
        stage = {"blocks": _stack(per_block)}
        if s > 0:
            stage["downsample"] = {
                "norm": {"scale": get(f"stages.{s}.downsample.0.weight"),
                         "bias": get(f"stages.{s}.downsample.0.bias")},
                "conv": {"w": _hwio(get(f"stages.{s}.downsample.1.weight")),
                         "b": get(f"stages.{s}.downsample.1.bias")},
            }
        stages[str(s)] = stage
    return {
        "stem": {"conv": {"w": _hwio(get("stem.0.weight")), "b": get("stem.0.bias")},
                 "norm": {"scale": get("stem.1.weight"), "bias": get("stem.1.bias")}},
        "stages": stages,
        "final_ln": {"scale": get("head.norm.weight"), "bias": get("head.norm.bias")},
        "head": {"w": _t(get("head.fc.weight")), "b": get("head.fc.bias")},
    }


def vit_params_from_timm(state_dict: Mapping, cfg: ViTConfig, *, dtype=torch.float32,
                         allow_missing_head: bool = False) -> dict:
    """timm ``vit_*`` / DINO-release state dict -> ViT param tree. timm fuses
    qkv (rows q;k;v); the tree keeps separate projections, so the fused
    tensors split on the output axis."""
    sd = _as_f32(state_dict)
    get = _getter(sd, "timm ViT", dtype)
    pos = _position_table(get("pos_embed"), cfg)
    per = {k: [] for k in _LAYER_MAP}
    for i in range(cfg.depth):
        bp = f"blocks.{i}"
        qw, kw, vw = get(f"{bp}.attn.qkv.weight").chunk(3, dim=0)  # (3D, D) rows q;k;v
        qb, kb, vb = get(f"{bp}.attn.qkv.bias").chunk(3, dim=0)
        for path, t in (("ln1/scale", get(f"{bp}.norm1.weight")),
                        ("ln1/bias", get(f"{bp}.norm1.bias")),
                        ("attn/q/w", _t(qw)), ("attn/q/b", qb), ("attn/k/w", _t(kw)),
                        ("attn/k/b", kb), ("attn/v/w", _t(vw)), ("attn/v/b", vb),
                        ("attn/o/w", _t(get(f"{bp}.attn.proj.weight"))),
                        ("attn/o/b", get(f"{bp}.attn.proj.bias")),
                        ("ln2/scale", get(f"{bp}.norm2.weight")),
                        ("ln2/bias", get(f"{bp}.norm2.bias")),
                        ("mlp/fc1/w", _t(get(f"{bp}.mlp.fc1.weight"))),
                        ("mlp/fc1/b", get(f"{bp}.mlp.fc1.bias")),
                        ("mlp/fc2/w", _t(get(f"{bp}.mlp.fc2.weight"))),
                        ("mlp/fc2/b", get(f"{bp}.mlp.fc2.bias"))):
            per[path].append(t.contiguous())
    if "head.weight" in sd:
        head = {"w": _t(get("head.weight")), "b": get("head.bias")}
    elif allow_missing_head:
        head = {"w": torch.zeros(cfg.hidden_dim, cfg.num_classes, dtype=dtype),
                "b": torch.zeros(cfg.num_classes, dtype=dtype)}
    else:
        raise KeyError("missing 'head.weight' (pass allow_missing_head=True "
                       "for backbone-only checkpoints like DINO releases)")
    return {
        "embed": {
            "proj": {"w": _patch_kernel(get("patch_embed.proj.weight"), cfg.patch_size),
                     "b": get("patch_embed.proj.bias")},
            "cls": get("cls_token"),
            "pos": pos,
        },
        "blocks": trees.unflatten_from_paths({k: torch.stack(v) for k, v in per.items()}),
        "final_ln": {"scale": get("norm.weight"), "bias": get("norm.bias")},
        "head": head,
    }


# --- ultralytics-format importer (YOLO11-cls) ----------------------------------

# ultralytics yolo11-cls.yaml layer index -> models.yolo11 tree key
_YOLO11_LAYER_KEYS = (
    ("0", "stem0"), ("1", "stem1"), ("2", "c3k2_0"), ("3", "down0"),
    ("4", "c3k2_1"), ("5", "down1"), ("6", "c3k2_2"), ("7", "down2"),
    ("8", "c3k2_3"), ("9", "c2psa"), ("10", "head"),
)


def yolo11_params_from_ultralytics(state_dict: Mapping, cfg, *, dtype=torch.float32,
                                   allow_missing_head: bool = False) -> dict:
    """ultralytics YOLO11-cls state dict -> YOLO11 param tree.

    Takes the naming of ``YOLO('yolo11n-cls.pt').model.state_dict()``
    (``model.N....``, or ``model.model.N....`` when the whole wrapper was
    pickled): a Conv carries ``.conv.weight`` (OIHW -> HWIO) and
    ``.bn.{weight,bias,running_mean,running_var}``; C3k2/C3k/C2PSA members
    index through ``.m.N.``; the Classify head is ``10.conv`` +
    ``10.linear``. A head whose class count differs from ``cfg.num_classes``
    needs ``allow_missing_head=True`` and zero-inits the classifier (the
    other importers' convention). The tree is checked against the config's
    shapes (``models.yolo11.init`` on the meta device): a missing or extra
    path raises ``KeyError``, another scale ``ValueError``."""
    from . import yolo11

    sd = _as_f32(state_dict)
    while sd and not any(k.split(".")[0].isdigit() for k in sd):
        stripped = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
        if not stripped:
            raise ValueError("unrecognized ultralytics state-dict naming: "
                             f"e.g. {next(iter(sd))!r}")
        sd = stripped

    def conv(prefix):
        return {"w": _hwio(sd[f"{prefix}.conv.weight"]).to(dtype),
                "bn": {"scale": sd[f"{prefix}.bn.weight"].to(dtype),
                       "bias": sd[f"{prefix}.bn.bias"].to(dtype),
                       "mean": sd[f"{prefix}.bn.running_mean"].to(dtype),
                       "var": sd[f"{prefix}.bn.running_var"].to(dtype)}}

    def n_members(prefix):
        pat = prefix + ".m."
        idxs = {int(k[len(pat):].split(".")[0]) for k in sd if k.startswith(pat)}
        if idxs != set(range(len(idxs))):
            raise KeyError(f"non-contiguous member indices under {pat!r}")
        return len(idxs)

    def bottleneck(prefix):
        return {"cv1": conv(f"{prefix}.cv1"), "cv2": conv(f"{prefix}.cv2")}

    def c3k(prefix):
        return {"cv1": conv(f"{prefix}.cv1"), "cv2": conv(f"{prefix}.cv2"),
                "cv3": conv(f"{prefix}.cv3"),
                "m": {str(i): bottleneck(f"{prefix}.m.{i}") for i in range(n_members(prefix))}}

    def c3k2(prefix, with_c3k):
        sub = c3k if with_c3k else bottleneck
        return {"cv1": conv(f"{prefix}.cv1"), "cv2": conv(f"{prefix}.cv2"),
                "m": {str(i): sub(f"{prefix}.m.{i}") for i in range(n_members(prefix))}}

    def psablock(prefix):
        return {"attn": {t: conv(f"{prefix}.attn.{t}") for t in ("qkv", "pe", "proj")},
                "ffn1": conv(f"{prefix}.ffn.0"), "ffn2": conv(f"{prefix}.ffn.1")}

    params = {
        "stem0": conv("0"), "stem1": conv("1"),
        "c3k2_0": c3k2("2", False), "down0": conv("3"),
        "c3k2_1": c3k2("4", False), "down1": conv("5"),
        "c3k2_2": c3k2("6", True), "down2": conv("7"),
        "c3k2_3": c3k2("8", True),
        "c2psa": {"cv1": conv("9.cv1"), "cv2": conv("9.cv2"),
                  "m": {str(i): psablock(f"9.m.{i}") for i in range(n_members("9"))}},
    }
    lin_w = sd.get("10.linear.weight")
    if lin_w is not None and lin_w.shape[0] == cfg.num_classes:
        linear = {"w": _t(lin_w).to(dtype), "b": sd["10.linear.bias"].to(dtype)}
    elif allow_missing_head:
        linear = {"w": torch.zeros(cfg.head_width, cfg.num_classes, dtype=dtype),
                  "b": torch.zeros(cfg.num_classes, dtype=dtype)}
    else:
        have = "missing" if lin_w is None else f"{lin_w.shape[0]}-class"
        raise KeyError(f"checkpoint head is {have}, config wants "
                       f"{cfg.num_classes} classes (pass "
                       "allow_missing_head=True to zero-init the classifier)")
    params["head"] = {"conv": conv("10.conv"), "linear": linear}

    # shape guard: a scale or width mismatch is a named error here, not a
    # failed product downstream
    got = trees.flatten_with_paths(params)
    want = trees.flatten_with_paths(yolo11.init(cfg, device="meta"))
    if set(got) != set(want):
        missing = sorted(set(want) - set(got))[:5]
        extra = sorted(set(got) - set(want))[:5]
        raise KeyError(f"param-tree mismatch: missing={missing} extra={extra}")
    for path, leaf in got.items():
        if tuple(leaf.shape) != tuple(want[path].shape):
            raise ValueError(f"{path}: checkpoint shape {tuple(leaf.shape)} != config "
                             f"shape {tuple(want[path].shape)} — wrong model scale?")
    return params


def ultralytics_from_yolo11_params(params, cfg) -> dict[str, torch.Tensor]:
    """Inverse of :func:`yolo11_params_from_ultralytics`: an ultralytics-named
    state dict of contiguous CPU tensors (the params' dtype)."""
    params = _nested(params)
    sd: dict[str, torch.Tensor] = {}

    def leaf(x):
        return _as_tensor(x).detach().cpu()

    def put_conv(prefix, p):
        sd[f"{prefix}.conv.weight"] = leaf(p["w"]).permute(3, 2, 0, 1).contiguous()
        for ours, theirs in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                             ("var", "running_var")):
            sd[f"{prefix}.bn.{theirs}"] = leaf(p["bn"][ours])

    def put_tree(prefix, p):
        if "w" in p and "bn" in p:
            put_conv(prefix, p)
            return
        for key, sub in p.items():
            name = {"ffn1": "ffn.0", "ffn2": "ffn.1"}.get(key, key)
            put_tree(f"{prefix}.{name}", sub)

    for idx, key in _YOLO11_LAYER_KEYS:
        if key == "head":
            put_conv(f"{idx}.conv", params["head"]["conv"])
            sd[f"{idx}.linear.weight"] = _t(leaf(params["head"]["linear"]["w"]))
            sd[f"{idx}.linear.bias"] = leaf(params["head"]["linear"]["b"])
        else:
            put_tree(idx, params[key])
    return {f"model.{k}": v for k, v in sd.items()}
