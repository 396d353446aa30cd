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

LoRA dropout (the training form of ``attach``) comes with the training
stages.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from ..utils import trees

_LORA_LEAVES = ("lora_a", "lora_b", "lora_s")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """Static adapter hyperparameters."""

    rank: int = 8
    alpha: float = 16.0
    targets: tuple[str, ...] = ()  # '/'-joined paths of dense subtrees
    # carried so that adapter_config.json round-trips; dropout itself comes
    # with the training stages
    dropout: float = 0.0

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


def attach(params, adapter: Mapping, cfg: LoRAConfig):
    """Insert the factors (and the scale ``s``, with the factors' leading
    axes) into the param tree for the unmerged compute path."""
    out = params
    for path, fac in adapter.items():
        lead = fac["a"].shape[:-2]
        s = torch.full(lead, cfg.scale, dtype=torch.float32, device=fac["a"].device)

        def add(sub, fac=fac, s=s):
            new = dict(sub)
            new["lora_a"], new["lora_b"], new["lora_s"] = fac["a"], fac["b"], s
            return new

        out = trees.update_path(out, path, add)
    return out


def detach(params):
    """Strip the ``lora_*`` leaves (inverse of :func:`attach`)."""
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
