"""BiLoRA: frequency-domain low-parameter adapters.

Counterpart of the JAX package's ``ops/bilora.py`` (the reference's
``train_bilora.ipynb`` ``BiLoRALinear``): each task's adapter is ``n_frq``
learnable complex coefficients scattered into a sparse 2-D spectrum over a
weight matrix, and the weight delta is

    dW = alpha * Re(ifft2(spectrum))

The spectrum positions are drawn from the task id, exactly as the JAX
package draws them (:func:`_positions`), so an adapter means the same thing
to both packages; deltas of different tasks compose by addition
(:func:`merge_many`), as LoRA merges do.

:func:`apply_delta` works on JAX-layout dict trees and is differentiable in
the coefficients. A module built from such a tree (``entry.from_tree``)
wraps each leaf in a new ``nn.Parameter``, which cuts the graph; to train
the coefficients through a module, feed ``W + dW`` into it with
``torch.func.functional_call(model, module_params(model, adapter, cfg),
(images,))``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ..utils import trees

_SEED_MUL = 2654435761  # the JAX package's uint32 task-seed multiplier


@dataclasses.dataclass(frozen=True)
class BiLoRAConfig:
    """Static adapter hyperparameters (reference defaults: n_frq=100, alpha=1.0)."""

    n_frq: int = 100
    alpha: float = 1.0
    targets: tuple[str, ...] = ()
    task_id: int = 0


def _positions(task_id: int, n_frq: int, rows: int, cols: int) -> np.ndarray:
    """The task's (n, 2) int32 spectrum positions: a task-seeded draw without
    replacement over the flat spectrum. The seed is the JAX package's
    ``uint32(task_id) * uint32(2654435761) + 1``, whose uint32 arithmetic
    wraps modulo 2**32; here it is computed on Python integers."""
    if not 0 <= task_id < 2 ** 32:
        raise OverflowError(f"task_id {task_id} is not a uint32")
    rng = np.random.default_rng((task_id * _SEED_MUL + 1) % 2 ** 32)
    flat = rng.choice(rows * cols, size=min(n_frq, rows * cols), replace=False)
    return np.stack([flat // cols, flat % cols], axis=1).astype(np.int32)


def init(params, cfg: BiLoRAConfig, *, dtype=torch.float32) -> dict:
    """Zero coefficients (dW = 0) per target, with the weight's leading axes."""
    adapter = {}
    for path in cfg.targets:
        w = trees.get_path(params, path)["w"]
        *lead, d_in, d_out = w.shape
        n = min(cfg.n_frq, d_in * d_out)
        adapter[path] = {"re": torch.zeros(*lead, n, dtype=dtype, device=w.device),
                         "im": torch.zeros(*lead, n, dtype=dtype, device=w.device)}
    return adapter


def delta(fac: Mapping, path_positions: np.ndarray, shape: tuple,
          alpha: float) -> torch.Tensor:
    """dW = alpha * Re(ifft2(scatter(coeffs))) for one target.

    ``fac['re']`` / ``fac['im']``: (*lead, n) coefficients; ``shape``: the
    target weight's shape (*lead, in, out). The 2-D transform runs over the
    last two axes of each leading (stacked-layer) index."""
    *lead, d_in, d_out = shape
    re = fac["re"]
    pos = torch.as_tensor(path_positions, dtype=torch.long, device=re.device)
    spec = torch.zeros(*lead, d_in, d_out, dtype=torch.complex64, device=re.device)
    spec[..., pos[:, 0], pos[:, 1]] = torch.complex(re.float(), fac["im"].float())
    return alpha * torch.fft.ifft2(spec).real.to(re.dtype)


def apply_delta(params, adapter: Mapping, cfg: BiLoRAConfig):
    """W <- W + dW per target: the merged tree, differentiable in the
    coefficients (the training and the eval form)."""
    out = params
    for path, fac in adapter.items():
        w = trees.get_path(params, path)["w"]
        d = delta(fac, _positions(cfg.task_id, cfg.n_frq, w.shape[-2], w.shape[-1]),
                  tuple(w.shape), cfg.alpha)
        out = trees.update_path(out, path,
                                lambda sub, d=d: {**sub, "w": sub["w"] + d.to(sub["w"].dtype)})
    return out


def merge_many(params, adapters: Sequence[Mapping], cfgs: Sequence[BiLoRAConfig]):
    """Compose several per-task adapters by summed deltas."""
    out = params
    for adapter, cfg in zip(adapters, cfgs):
        out = apply_delta(out, adapter, cfg)
    return out


def num_params(adapter: Mapping) -> int:
    return trees.tree_count_params(adapter)


def _module_leaves(model: nn.Module, path: str) -> list[str]:
    """Names of the module parameters that hold the JAX-layout leaf ``path``,
    in the order of the leaf's flattened leading axes: a ``ModuleList`` that
    the path does not index by number (``blocks`` in ``"blocks/attn/q/w"``)
    is the stacked axis, and its layers follow the tree's row-major order
    (Swin's ``(pairs, 2)`` stack included)."""
    found = [("", model)]
    for part in path.split("/"):
        if any(isinstance(mod, nn.ModuleList) for _, mod in found) and not part.isdigit():
            found = [(f"{name}{i}.", child) for name, mod in found
                     for i, child in enumerate(mod)]
        step = []
        for name, mod in found:
            child = mod[int(part)] if isinstance(mod, nn.ModuleList) else getattr(mod, part, None)
            if child is None:
                raise KeyError(f"{path!r}: the module has no {name}{part}")
            step.append((f"{name}{part}.", child))
        found = step
    return [name[:-1] for name, _ in found]


def module_params(model: nn.Module, adapter: Mapping, cfg: BiLoRAConfig) -> dict:
    """``{parameter name: W + dW}`` for ``torch.func.functional_call(model,
    ...)``: each target's delta over the module's own weights, one layer per
    index of the coefficients' flattened leading axes, differentiable in the
    coefficients."""
    out = {}
    for path, fac in adapter.items():
        names = _module_leaves(model, f"{path}/w")
        n = fac["re"].shape[-1]
        flat = {k: fac[k].reshape(len(names), n) for k in ("re", "im")}
        d_in, d_out = model.get_parameter(names[0]).shape
        d = delta(flat, _positions(cfg.task_id, cfg.n_frq, d_in, d_out),
                  (len(names), d_in, d_out), cfg.alpha)
        for i, name in enumerate(names):
            w = model.get_parameter(name)
            out[name] = w + d[i].to(w.dtype)
    return out
