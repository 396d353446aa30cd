"""LoRA adapters as transformations of dict trees of tensors.

Counterpart of the JAX package's ``ops/lora.py``, with the same conventions
so one adapter means the same thing to both packages:

* an adapter is ``{target_path: {"a": ..., "b": ...}}`` keyed by the JAX
  param paths (``"blocks/attn/q"``...); with stacked encoder blocks the
  factors carry the leading stack axes (depth for ViT, ``(pairs, 2)`` for
  Swin), which ``torch.matmul`` broadcasts over;
* ``W`` is ``(in, out)``, so ``a`` is ``(*lead, in, r)`` and ``b`` is
  ``(*lead, r, out)``;
* :func:`attach` inserts the factors for the unmerged path of
  :func:`..ops.nn.dense`; :func:`merge` folds ``dW = s * A B`` into ``W``.

``attach(..., dropout_seed=...)`` is the training form: each target also gets
a seed leaf (``lora_rng`` for mode ``"input"``, ``lora_rng_pa`` for
``"post_a"``, the JAX package's leaf names) with one distinct seed per target
and per stacked layer, and the rate ``lora_p``. A model built from such a
tree (``models.vit.Leaves``) turns each seed into an independent
``torch.Generator`` stream and applies the dropout while the module is in
training mode; the eval form (no seed) is the identity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import torch

from ..utils import trees

_LORA_LEAVES = ("lora_a", "lora_b", "lora_s", "lora_rng", "lora_rng_pa", "lora_p")
_SEED_STRIDE = 1_000_003  # between the seed ranges of two base seeds


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """Static adapter hyperparameters."""

    rank: int = 8
    alpha: float = 16.0
    targets: tuple[str, ...] = ()  # '/'-joined paths of dense subtrees
    dropout: float = 0.1  # applied to the adapter branch during training
    # "input": PEFT-exact placement, the mask on the adapter branch's input x;
    # "post_a": the mask on the rank-r projection x @ A (see ops.nn.dense)
    dropout_mode: str = "input"

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def init(generator: torch.Generator, params, cfg: LoRAConfig, *,
         dtype=torch.float32) -> dict:
    """Fresh adapter: A ~ U(-1/sqrt(in), 1/sqrt(in)) (PEFT's kaiming bound),
    B = 0, so the initial delta is zero."""
    adapter = {}
    for path in cfg.targets:
        w = trees.get_path(params, path)["w"]
        *lead, d_in, d_out = w.shape
        bound = (1.0 / d_in) ** 0.5
        a = torch.empty(*lead, d_in, cfg.rank, dtype=torch.float32, device=w.device)
        a.uniform_(-bound, bound, generator=generator)
        adapter[path] = {"a": a.to(dtype),
                         "b": torch.zeros(*lead, cfg.rank, d_out, dtype=dtype, device=w.device)}
    return adapter


def attach(params, adapter: Mapping, cfg: LoRAConfig, *, dropout_seed: int | None = None):
    """Insert the factors (and the scale ``s``, with the factors' leading
    axes) into the param tree for the unmerged compute path.

    ``dropout_seed``: when given and ``cfg.dropout > 0`` (training form), each
    target also carries the seeds of its dropout streams, one per stacked
    layer and distinct across targets, and the rate; omit it for the eval
    form (identity)."""
    out = params
    first = 0
    for path, fac in adapter.items():
        lead = fac["a"].shape[:-2]
        device = fac["a"].device
        s = torch.full(lead, cfg.scale, dtype=torch.float32, device=device)
        extra = {}
        if dropout_seed is not None and cfg.dropout > 0:
            n_lead = math.prod(lead) if lead else 1
            seeds = dropout_seed * _SEED_STRIDE + first + torch.arange(n_lead, dtype=torch.int64)
            first += n_lead
            key = "lora_rng_pa" if cfg.dropout_mode == "post_a" else "lora_rng"
            extra = {key: seeds.reshape(lead).to(device),
                     "lora_p": torch.full(lead, cfg.dropout, dtype=torch.float32, device=device)}

        def add(sub, fac=fac, s=s, extra=extra):
            new = dict(sub)
            new["lora_a"], new["lora_b"], new["lora_s"] = fac["a"], fac["b"], s
            new.update(extra)
            return new

        out = trees.update_path(out, path, add)
    return out


def detach(params):
    """Strip the ``lora_*`` leaves (inverse of :func:`attach`, the training
    form's dropout leaves included)."""
    flat = trees.flatten_with_paths(params)
    kept = {p: v for p, v in flat.items() if p.rsplit("/", 1)[-1] not in _LORA_LEAVES}
    return trees.unflatten_from_paths(kept)


def delta(fac: Mapping, scale: float) -> torch.Tensor:
    """dW = scale * A B with arbitrary leading (stacked-layer) axes."""
    return scale * torch.matmul(fac["a"], fac["b"])


def merge(params, adapter: Mapping, cfg: LoRAConfig, *, sign: float = 1.0):
    """Fold ``sign * dW`` into the base kernels (sign=-1 un-merges)."""
    out = params
    for path, fac in adapter.items():
        def fold(sub, fac=fac):
            new = dict(sub)
            new["w"] = sub["w"] + sign * delta(fac, cfg.scale).to(sub["w"].dtype)
            return new

        out = trees.update_path(out, path, fold)
    return out


def merge_many(params, adapters: Sequence[Mapping], cfgs: Sequence[LoRAConfig]):
    """Compose adapters by summed deltas (each merge is a weight addition)."""
    out = params
    for adapter, cfg in zip(adapters, cfgs):
        out = merge(out, adapter, cfg)
    return out


def num_params(adapter: Mapping) -> int:
    return trees.tree_count_params(adapter)
