"""Faults planted under the timed path, to show that a run which has one
comes out not correct: ``plant(kind, name, after)`` patches the program in
this process and returns the function that takes the patch out again. The
patched attack or step runs soundly for its first ``after`` calls (a path
that switches once warmed up) and with the fault from then on.

* ``unchanged_state``: a step returns its state unchanged (the attack's
  gradient reads zero, so no pixel moves; the training step restores every
  trained tensor after its update);
* ``half_batch``: half of each batch left out, the mean taken over the rest
  (the attack attacks the first half and returns the second as it came;
  the training step sees the first half only);
* ``altered_answer``: an answer altered where it is produced (the first
  adversarial image replaced by the second; in training, the first image's
  logits negated where the model produces them).

There is no exchange between chips to leave out: every cell runs on one.
"""

from __future__ import annotations

import torch

from portbench.drivers import common

NAMES = ("unchanged_state", "half_batch", "altered_answer")


def plant(kind: str, name: str, after: int = 0):
    if name not in NAMES:
        raise ValueError(f"fault {name!r}: one of {NAMES}")
    calls = [0]

    def live() -> bool:
        """Whether this call (one batch or step) has the fault."""
        calls[0] += 1
        return calls[0] > after

    if kind == "attack":
        return _attack(name, live)
    if kind == "train":
        return _train(name, live)
    raise ValueError(f"kind {kind!r}: attack or train")


def _patch(module, attr, value):
    original = getattr(module, attr)
    setattr(module, attr, value)
    return lambda: setattr(module, attr, original)


def _attack(name: str, live):
    whitebox = common.port("attacks.whitebox")
    if name == "unchanged_state":
        original = whitebox._loss_grad

        def zero_grad(apply_fn, normalize):
            grad = original(apply_fn, normalize)
            if not live():
                return grad
            return lambda x, params, labels: torch.zeros_like(grad(x, params, labels))

        return _patch(whitebox, "_loss_grad", zero_grad)
    original = whitebox.pgd
    if name == "half_batch":
        def pgd(apply_fn, params, images, labels, **kw):
            if not live():
                return original(apply_fn, params, images, labels, **kw)
            h = images.shape[0] // 2
            return torch.cat([original(apply_fn, params, images[:h], labels[:h], **kw), images[h:]])
    else:
        def pgd(apply_fn, params, images, labels, **kw):
            adv = original(apply_fn, params, images, labels, **kw)
            return torch.cat([adv[1:2], adv[1:]]) if live() else adv
    return _patch(whitebox, "pgd", pgd)


def _train(name: str, live):
    steps = common.port("train.steps")
    original = steps.make_train_step

    def make(forward, model, **kw):
        on = [False]  # whether the step under way has the fault
        if name == "altered_answer":
            inner = forward

            def forward(m, x):
                y = inner(m, x)
                return torch.cat([-y[:1], y[1:]]) if on[0] else y

        step = original(forward, model, **kw)

        def faulty(state, images, labels, valid):
            on[0] = live()
            if not on[0] or name == "altered_answer":
                return step(state, images, labels, valid)
            if name == "half_batch":
                h = images.shape[0] // 2
                return step(state, images[:h], labels[:h], valid[:h])
            kept = {n: p.detach().clone() for n, p in state.trainable.items()}
            state, m = step(state, images, labels, valid)  # unchanged_state
            with torch.no_grad():
                for n, p in state.trainable.items():
                    p.copy_(kept[n])
            return state, m

        return faulty

    return _patch(steps, "make_train_step", make)
