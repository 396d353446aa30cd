"""Plain reference of the ViT family (Dosovitskiy et al., 2021; the
``google/vit-base-patch16-*`` checkpoints' architecture), float32.

Pre-LN encoder: patch embedding (a dense over each 16x16x3 patch, its pixels
row-major and channel last), a CLS token, learned position embeddings, then
``depth`` blocks ``x + MHA(LN1(x))``, ``x + MLP(LN2(x))`` with the exact GELU,
a final LayerNorm, and a dense head on the CLS token. Parameters are a flat
'/'-path tree in the JAX layout the benchmark makes (:func:`layout`): dense
weights ``(in, out)``, the blocks' leaves stacked on a leading ``depth``
axis. An unmerged LoRA adapter (``lora``) adds ``s · (drop(x) @ A) @ B`` to
its target denses, with PEFT's placement of the dropout on the branch's
input.
"""

from __future__ import annotations

import dataclasses

import torch

from . import common as C

TARGETS = ("q", "k", "v", "o")  # the LoRA targets of the studies: PEFT's query/key/value/output


@dataclasses.dataclass(frozen=True)
class Cfg:
    image_size: int
    patch_size: int
    hidden: int
    depth: int
    heads: int
    mlp: int
    classes: int
    eps: float

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


def config(d: dict) -> Cfg:
    """The configuration file's published widths (HF ``ViTConfig`` keys)."""
    return Cfg(d["image_size"], d["patch_size"], d["hidden_size"], d["num_hidden_layers"],
               d["num_attention_heads"], d["intermediate_size"], d["num_labels"],
               d["layer_norm_eps"])


def port_fields(d: dict) -> dict:
    """{the program's config field: the file's value}: what the harness
    holds the program's configuration to before it runs."""
    return {"image_size": d["image_size"], "patch_size": d["patch_size"],
            "hidden_dim": d["hidden_size"], "depth": d["num_hidden_layers"],
            "num_heads": d["num_attention_heads"], "mlp_dim": d["intermediate_size"],
            "num_classes": d["num_labels"], "layer_norm_eps": d["layer_norm_eps"],
            "compute_dtype": d["compute_dtype"]}


def layout(cfg: Cfg) -> dict:
    """{path: (shape, kind)} of every parameter; ``kind`` says how the
    benchmark draws it (``portbench.core.weights``)."""
    d, m, L = cfg.hidden, cfg.mlp, cfg.depth
    out = {"embed/proj/w": ((cfg.patch_size ** 2 * 3, d), "dense"),
           "embed/proj/b": ((d,), "small"),
           "embed/cls": ((1, 1, d), "small"), "embed/pos": ((1, cfg.tokens, d), "small")}
    for ln in ("ln1", "ln2"):
        out[f"blocks/{ln}/scale"] = ((L, d), "scale")
        out[f"blocks/{ln}/bias"] = ((L, d), "small")
    for t in TARGETS:
        out[f"blocks/attn/{t}/w"] = ((L, d, d), "dense")
        out[f"blocks/attn/{t}/b"] = ((L, d), "small")
    out["blocks/mlp/fc1/w"], out["blocks/mlp/fc1/b"] = ((L, d, m), "dense"), ((L, m), "small")
    out["blocks/mlp/fc2/w"], out["blocks/mlp/fc2/b"] = ((L, m, d), "dense"), ((L, d), "small")
    out["final_ln/scale"], out["final_ln/bias"] = ((d,), "scale"), ((d,), "small")
    out["head/w"], out["head/b"] = ((d, cfg.classes), "dense"), ((cfg.classes,), "small")
    return out


def lora_paths(cfg: Cfg) -> tuple[str, ...]:
    """The adapter's target denses, in the order the adapter is drawn."""
    return tuple(f"blocks/attn/{t}" for t in TARGETS)


def mask_shape(cfg: Cfg, path: str, batch: int) -> tuple[int, ...]:
    """The shape of a target dense's input, over which its dropout is drawn."""
    return (batch, cfg.tokens, cfg.hidden)


def patchify(cfg: Cfg, x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    p = cfg.patch_size
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def forward(params: dict, cfg: Cfg, x: torch.Tensor, *, lowp=None, lora=None,
            masks=None) -> torch.Tensor:
    """Normalized NHWC images -> f32 logits. ``lora``: {target path:
    (A (depth, in, r), B (depth, r, out), scale)}; ``masks(path, layer)``:
    the dropout multiplier of that dense's branch input, or None."""
    emb = C.sub(params, "embed")
    h = C.dense(C.sub(params, "embed/proj"), patchify(cfg, x), lowp)
    h = torch.cat([emb["cls"].expand(h.shape[0], 1, cfg.hidden), h], dim=1) + emb["pos"]
    blocks = C.sub(params, "blocks")
    hd = cfg.hidden // cfg.heads
    for i in range(cfg.depth):
        p = C.layer(blocks, i)

        def lin(name, t, _p=p, _i=i):
            path = f"blocks/{name}"
            ad = None
            if lora is not None and path in lora:
                a, b, s = lora[path]
                ad = (a[_i], b[_i], s, masks(path, _i) if masks is not None else None)
            return C.dense(C.sub(_p, name), t, lowp, ad)

        y = C.layer_norm(C.sub(p, "ln1"), h, cfg.eps)
        q, k, v = (lin(f"attn/{t}", y).reshape(y.shape[0], -1, cfg.heads, hd).transpose(1, 2)
                   for t in ("q", "k", "v"))
        a = C.softmax_attention(q, k, v, hd ** -0.5, lowp=lowp)
        h = h + lin("attn/o", a.transpose(1, 2).reshape(y.shape))
        y = C.layer_norm(C.sub(p, "ln2"), h, cfg.eps)
        h = h + lin("mlp/fc2", C.gelu(lin("mlp/fc1", y)))
    h = C.layer_norm(C.sub(params, "final_ln"), h, cfg.eps)
    return C.dense(C.sub(params, "head"), h[:, 0], lowp)


def port_leaf(name: str) -> tuple[str, int | None]:
    """The program module's parameter name -> (tree path, layer or None):
    ``blocks.3.attn.q.lora_a`` -> (``blocks/attn/q/lora_a``, 3)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return "blocks/" + "/".join(parts[2:]), int(parts[1])
    if parts[0] == "proj":
        return "embed/proj/" + parts[1], None
    if parts[0] in ("cls", "pos"):
        return "embed/" + parts[0], None
    return "/".join(parts), None


def stacked(path: str) -> int:
    """How many leading axes of the leaf at ``path`` stack layers."""
    return 1 if path.startswith("blocks/") else 0
