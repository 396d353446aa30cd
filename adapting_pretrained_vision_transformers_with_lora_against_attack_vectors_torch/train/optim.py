"""Optimizer factories matching the reference's training recipes.

Counterpart of the JAX package's ``train/optim.py``:

* base fine-tune: AdamW(lr=1e-4, weight_decay=1e-4) + StepLR(step=20,
  gamma=0.1) by epoch;
* LoRA defense: Adam(lr=1e-4), no schedule.

Each factory returns ``(optimizer, schedule)``: a stock ``torch.optim``
optimizer over the given tensors and a function ``step count -> lr`` (or
``None``). The train step sets the lr from the count of updates made
**before** the one it is about to make, as an optax schedule is evaluated, so
both packages apply the same lr to the same update.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

Schedule = Callable[[int], float]


def steplr_schedule(base_lr: float, *, step_size_epochs: int, gamma: float,
                    steps_per_epoch: int) -> Schedule:
    """torch ``StepLR`` semantics: lr * gamma^(epoch // step_size)."""

    def schedule(count: int) -> float:
        epoch = count // steps_per_epoch
        return base_lr * gamma ** (epoch // step_size_epochs)

    return schedule


def adamw_steplr(params: Iterable[torch.Tensor], lr: float = 1e-4, *, weight_decay: float = 1e-4,
                 step_size_epochs: int = 20, gamma: float = 0.1,
                 steps_per_epoch: int = 1) -> tuple[torch.optim.Optimizer, Schedule]:
    sched = steplr_schedule(lr, step_size_epochs=step_size_epochs, gamma=gamma,
                            steps_per_epoch=steps_per_epoch)
    return torch.optim.AdamW(list(params), lr=lr, weight_decay=weight_decay), sched


def lora_adam(params: Iterable[torch.Tensor],
              lr: float = 1e-4) -> tuple[torch.optim.Optimizer, Optional[Schedule]]:
    return torch.optim.Adam(list(params), lr=lr), None
