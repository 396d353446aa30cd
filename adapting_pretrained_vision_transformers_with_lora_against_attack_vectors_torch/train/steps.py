"""The train step and the eval step.

Counterpart of the JAX package's ``train/steps.py``. Both steps take uint8
images, turn them into [0,1] floats and normalize them on the device, and
take a ``valid`` mask (1 for real samples, 0 for the padding of a final
batch). Their metrics are sums kept on the device, so a loop can add them up
there and fetch once per epoch: no step copies a scalar to the host.

* :func:`make_train_step`: one optimizer update; mean cross-entropy over the
  ``valid`` rows; optional train-time augmentation before the normalization.
  What is trainable is what the :class:`TrainState` names: the whole model
  (base fine-tune) or the adapter factors and the head (LoRA), the rest of
  the module frozen. The JAX step is a pure function of a donated state;
  here the module's parameters and the optimizer's moments are updated in
  place, which keeps one copy of each on the device, so whoever wants to
  keep a set of parameters must clone it.
* :func:`make_eval_step`: the summed cross-entropy and a (C, C) confusion
  matrix (rows = true class, cols = predicted).

Under a mesh (the model's, ``parallel.mesh``) each rank holds its rows of
the global batch: the loss divides by the global valid count (the local
counts summed over ``"data"``), the trainable gradients are summed over
``"data"`` before the optimizer step, so one step is the JAX package's
global-mean step, and the metrics are summed over ``"data"``. Within a model
group no gradient is reduced again: a split leaf keeps its own slice's
gradient, and a whole leaf already gets the same gradient on every rank
(``parallel.tp``). The augmentation's draws are the draws over the global
batch, of which each rank keeps its rows.

While a profiler records, a train step opens its span (``train.step``,
``utils.observability.span``) and within it one span a phase: ``train.input``
(unit floats, augmentation, normalization), ``train.forward`` (the forward
and the loss), ``train.backward`` (the gradients, summed over ``"data"``),
``train.optimizer`` (the lr and the update) and ``train.metrics``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from ..attacks.common import IMAGENET, Normalizer, to_unit_floats
from ..parallel import mesh as pmesh
from ..utils.observability import span


@dataclasses.dataclass
class TrainState:
    """Everything a train step changes, in place: the named trainable
    tensors (leaves of the module the forward runs), their optimizer, the
    lr schedule (``update count -> lr``, or ``None``) and the update count;
    under a mesh, the mesh and ``{name: dim}`` of the tensors this rank holds
    a model-axis slice of (``utils.checkpoint`` gathers and slices by it)."""

    trainable: dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    schedule: Optional[Callable[[int], float]] = None
    step: int = 0
    mesh: Any = None
    shard_dims: dict[str, int] = dataclasses.field(default_factory=dict)

    @classmethod
    def create(cls, model: torch.nn.Module, names, make_optimizer) -> "TrainState":
        """Freeze every parameter of ``model`` but those in ``names`` (``None``
        = train them all) and build their optimizer with
        ``make_optimizer(tensors) -> (optimizer, schedule)``. A frozen
        parameter asks no gradient of the kernels' ``autograd.Function``s."""
        keep = None if names is None else set(names)
        trainable = {}
        for name, p in model.named_parameters():
            p.requires_grad_(p.is_floating_point() and (keep is None or name in keep))
            if p.requires_grad:
                trainable[name] = p
        if keep is not None and keep - set(trainable):
            raise KeyError(f"not float parameters of the model: {sorted(keep - set(trainable))}")
        optimizer, schedule = make_optimizer(trainable.values())
        dims = {f"{prefix}.{leaf}" if prefix else leaf: d
                for prefix, mod in model.named_modules()
                for leaf, d in getattr(mod, "shard_dims", {}).items()}
        return cls(trainable, optimizer, schedule, mesh=pmesh.mesh_of(model),
                   shard_dims={n: d for n, d in dims.items() if n in trainable})


def _sum_over_data(tensors, mesh) -> None:
    """Sum equal-dtype tensors over the data axis in place, in one call."""
    if pmesh.axis_size(mesh, pmesh.DATA_AXIS) == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    pmesh.all_reduce(flat, mesh, pmesh.DATA_AXIS)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def make_train_step(forward: Callable[[Any, torch.Tensor], torch.Tensor], model, *,
                    normalize: Optional[Normalizer] = IMAGENET,
                    generator: Optional[torch.Generator] = None,
                    augment: Optional[Callable] = None) -> Callable:
    """Build ``(state, images, labels, valid) -> (state, metrics)``.

    ``forward(model, normalized_images) -> logits``, with ``model`` the
    module whose parameters ``state.trainable`` names. ``augment``:
    ``(images_01, generator) -> images_01``, applied on the device before the
    normalization (``data.augment.train_augment``); it needs ``generator``,
    on the images' device. Metrics are sums (``loss_sum``, ``correct``,
    ``count``), device tensors, so they add up across batches exactly."""
    if augment is not None and generator is None:
        raise ValueError("augment requires a generator")
    mesh = pmesh.mesh_of(model)

    def train_step(state: TrainState, images, labels, valid):
        with span("train.step"):
            with span("train.input"):
                x = to_unit_floats(images)
                if augment is not None:
                    x = (augment(x, generator) if mesh is None
                         else augment(x, generator, rows=pmesh.data_rows(mesh, x.shape[0])))
                if normalize is not None:
                    x = normalize(x)
            with span("train.forward"):
                labels, valid = labels.long(), valid.float()
                logits = forward(model, x).float()
                ce = F.cross_entropy(logits, labels, reduction="none")
                count = pmesh.all_reduce(valid.sum(), mesh, pmesh.DATA_AXIS)
                loss = (ce * valid).sum() / count.clamp_min(1.0)
            with span("train.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                grads = [p.grad for p in state.trainable.values() if p.grad is not None]
                for dtype in {g.dtype for g in grads}:
                    _sum_over_data([g for g in grads if g.dtype == dtype], mesh)
            with span("train.optimizer"):
                if state.schedule is not None:
                    lr = state.schedule(state.step)
                    for group in state.optimizer.param_groups:
                        group["lr"] = lr
                state.optimizer.step()
                state.step += 1
            with span("train.metrics"), torch.no_grad():
                correct = ((logits.argmax(dim=-1) == labels).float() * valid).sum()
                sharded = pmesh.axis_size(mesh, pmesh.DATA_AXIS) > 1
                local = (ce * valid).sum() if sharded else None
                _sum_over_data([correct, *([local] if local is not None else [])], mesh)
                loss_sum = local if sharded else loss.detach() * count
                metrics = {"loss_sum": loss_sum, "correct": correct, "count": count}
        return state, metrics

    return train_step


def make_eval_step(forward: Callable[[Any, torch.Tensor], torch.Tensor], num_classes: int, *,
                   normalize: Optional[Normalizer] = IMAGENET) -> Callable:
    """``(params, images, labels, valid) -> (loss_sum, confusion)``.

    ``forward(params, normalized_images) -> logits``; ``valid`` is a float
    mask (B,), 1 for real samples and 0 for padding. Under the model's mesh
    both sums are over the global batch."""

    @torch.no_grad()
    def eval_step(params, images, labels, valid):
        x = to_unit_floats(images)
        logits = forward(params, normalize(x) if normalize is not None else x).float()
        labels = labels.long()
        valid = valid.float()
        ce = F.cross_entropy(logits, labels, reduction="none")
        preds = logits.argmax(dim=-1)
        conf = torch.zeros(num_classes * num_classes, dtype=torch.float32, device=logits.device)
        conf.index_add_(0, labels * num_classes + preds, valid)
        loss_sum = (ce * valid).sum()
        _sum_over_data([loss_sum, conf], pmesh.mesh_of(params))
        return loss_sum, conf.reshape(num_classes, num_classes)

    return eval_step
