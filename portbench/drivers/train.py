"""Training steps: the ``train-loras`` stage's step (``mode`` "lora") and the
``train`` stage's (``mode`` "full").

Set-up builds the training object as the stages do, over f32 parameters
made on the device from the seed, with bf16 compute (the configuration's):

* ``lora``: ``train.loop.lora_trainer`` (a rank-r adapter on the family's
  targets, drawn from the seed, with its dropout streams from the seed; the
  head trained; Adam), as ``train_lora_adapter`` builds it;
* ``full``: the module over copies of the parameters, every one trained by
  AdamW with the StepLR schedule, and ``data.augment.train_augment`` on the
  device with a generator seeded ``seed · 1000 + 17``, as
  ``train_base_model`` builds it.

The step is the program's ``train.steps.make_train_step``, in training mode.
A unit is one step as ``train.loop.fit`` runs it: a uint8 batch from the
host pool to the device, the step, its metric sums added up on the device;
the window ends with the host fetch of the count that ``fit`` makes once an
epoch. Unlike ``fit``'s pageable copy, which waits for the card before each
step, the pool sits in pinned memory and is copied without a wait, so the
host runs ahead of the card by as many steps as the launch queue holds and
a short stall of the shared host does not reach the rate.

The check reads two runs of ``CHECKED_STEPS`` steps, each through the
window's own call on the program's own object: ``start``, set-up's warm-up
from the seed's start, and ``last``, the window's last steps. Of each it
reads, from the program's state, each step's loss, each leaf's gradient at
its first step as the optimizer holds it (the change of Adam's first moment
over 1 - beta1) and each leaf's change over the run. At the start of
``last`` it copies the trained tensors and Adam's moments; the reference
follows ``start`` from the seed and ``last`` from that copy, its streams
advanced by the draws of the steps before. Numbers: ``loss_gap`` (the worst
step's relative loss gap), ``grad_gap`` and ``change_gap`` (the worst
leaf's gap of norms over the larger of that leaf's reference norm and the
median leaf's), ``grad_gap_median`` and ``change_gap_median`` (the median
leaf's gap), ``last``'s with the suffix ``.last``; the change leaves out
leaves whose reference gradient is under a thousandth of the median leaf's
at every step of the run (the key bias under softmax). The cell's limits
file names the numbers compared.

With ``control``, the program's readings are replaced by the reference's
computed with float8 (e4m3) products, from the same starts (the control one
precision below bf16; the program has no such path of its own).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from ..core import weights
from ..reference import train as RT
from . import common

CHECKED_STEPS = 3  # the steps of each run the check follows
NOUGHT = 1e-3  # a leaf's gradient under this share of the median leaf's is nought


class Driver:
    def __init__(self, cell, seed: int, device, *, control: bool = False):
        self.cell, self.seed, self.device, self.control = cell, seed, torch.device(device), control
        t = cell.traffic
        self.batch, self.mode = t["batch"], t["mode"]
        self.trace_units = t["trace_units"]
        self.k, self.sums, self.run, self.runs = 0, None, None, {}
        self.readings, self.setup_peak_bytes = {}, 0

    def setup(self) -> None:
        t0 = time.perf_counter()
        cell, t = self.cell, self.cell.traffic
        entry, cfg = common.program(cell)
        trees = common.port("utils.trees")
        steps = common.port("train.steps")
        normalizer = common.port("attacks.common").Normalizer(*entry.normalization)
        fam = cell.family
        self.rcfg = fam.config(cell.config)
        self.tree = weights.make(fam.layout(self.rcfg), self.seed, self.device,
                                 getattr(torch, t["param_dtype"]))
        nested = trees.unflatten_from_paths(self.tree)
        generator = augment = None
        if self.mode == "lora":
            lora = common.port("ops.lora")
            lcfg = lora.LoRAConfig(rank=t["rank"], alpha=t["alpha"],
                                   targets=entry.lora_targets(cfg), dropout=t["dropout"],
                                   dropout_mode="input")
            model, state, _ = common.port("train.loop").lora_trainer(
                entry, cfg, nested, lcfg, lr=t["lr"], train_head=t["train_head"],
                seed=self.seed, device=self.device)
        elif self.mode == "full":
            optim = common.port("train.optim")
            model = entry.from_tree(trees.map_leaves(
                lambda x: x.to(self.device, copy=True), nested), cfg)
            state = steps.TrainState.create(model, None, lambda ps: optim.adamw_steplr(
                ps, t["lr"], weight_decay=t["weight_decay"], step_size_epochs=t["steplr_epochs"],
                gamma=t["steplr_gamma"], steps_per_epoch=t["steps_per_epoch"]))
            generator = torch.Generator(self.device).manual_seed(RT.augment_seed(self.seed))
            augment = common.port("data.augment").train_augment
        else:
            raise ValueError(f"mode {self.mode!r}: lora or full")
        inner = state.optimizer.step

        def optimizer_step(*args, **kwargs):
            with record_function("optimizer_step"):
                return inner(*args, **kwargs)

        state.optimizer.step = optimizer_step
        self.model, self.state = model, state
        self.step = steps.make_train_step(lambda m, x: entry.apply(cfg, m, x), model,
                                          normalize=normalizer, generator=generator,
                                          augment=augment)
        model.train()
        self.images, self.labels = common.host_pool(
            self.seed, self.batch, self.rcfg.image_size, self.rcfg.classes)
        self.valid = np.ones(self.batch, np.float32)
        # the pool in pinned host memory, copied without a wait: the host
        # dispatches the next steps while the card runs this one
        pin = self.device.type == "cuda"
        host = lambda a: torch.from_numpy(a).pin_memory() if pin else torch.from_numpy(a)  # noqa: E731
        self.feed = [(host(self.images[i]), host(self.labels[i])) for i in range(len(self.images))]
        self.feed_valid = host(self.valid)
        self.phases = {"built_s": time.perf_counter() - t0}
        self._open("start")
        for _ in range(CHECKED_STEPS):
            self.unit()
        common.sync(self.device)
        gc.collect()
        gc.freeze()  # set-up's objects out of the collector's way in the window
        if self.device.type == "cuda":  # the window's peak, without set-up's copies
            self.setup_peak_bytes = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.phases["warm_s"] = time.perf_counter() - t0

    def closing(self) -> int:
        """Mark the window's last units, which the check reads; read the
        allocator's peak over the steps dispatched so far, before the check's
        copies."""
        if self.device.type == "cuda":
            self.readings["window_memory_peak_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
        self._open("last")
        return CHECKED_STEPS

    def _open(self, name: str) -> None:
        """Start reading a run of checked steps at the program's state now."""
        named, opt = self.state.trainable, self.state.optimizer
        with torch.no_grad():
            run = {"k0": self.k, "names": list(named), "losses": [],
                   "params": [p.detach().clone() for p in named.values()],
                   "m": [opt.state[p]["exp_avg"].clone() for p in named.values()]
                   if opt.state else None}
            if name != "start":  # the reference follows this run from the program's state
                run["v"] = [opt.state[p]["exp_avg_sq"].clone() for p in named.values()]
        self.run = self.runs[name] = run

    def _read(self, run: dict, metrics: dict) -> None:
        """One checked step's readings, kept on the device until the check."""
        t = len(run["losses"])
        run["losses"].append(metrics["loss_sum"] / metrics["count"])
        named, opt = self.state.trainable, self.state.optimizer
        with torch.no_grad():
            if t == 0:
                beta1 = opt.param_groups[0]["betas"][0]
                m1 = [opt.state[p]["exp_avg"] for p in named.values()]
                if run["m"] is not None:
                    m1 = torch._foreach_sub(m1, torch._foreach_mul(run["m"], beta1))
                run["grad1"] = torch._foreach_norm(torch._foreach_div(m1, 1 - beta1))
            if t == CHECKED_STEPS - 1:
                run["change"] = torch._foreach_norm(torch._foreach_sub(
                    [p.detach() for p in named.values()], run["params"]))
                if "v" not in run:
                    run["params"] = run["m"] = None
                self.run = None

    def _by_leaf(self, names, norms) -> dict:
        return {self.cell.family.port_leaf(n): float(v) for n, v in zip(names, norms)}

    def unit(self) -> int:
        k, self.k = self.k, self.k + 1
        images, labels = self.feed[k % len(self.feed)]
        with record_function("batch_to_device"):
            images, labels, valid = (a.to(self.device, non_blocking=True)
                                     for a in (images, labels, self.feed_valid))
        with record_function("train_step"):
            self.state, m = self.step(self.state, images, labels, valid)
        self.sums = m if self.sums is None else {n: self.sums[n] + m[n] for n in m}
        if self.run is not None:
            self._read(self.run, m)
        return self.batch

    def drain(self) -> None:
        if self.sums is not None:
            float(self.sums["count"].cpu())  # the fetch fit makes once an epoch
        common.sync(self.device)

    def counters(self) -> dict:
        return common.counters()

    def release(self) -> None:
        self.model = self.state = self.step = self.sums = self.feed = None
        gc.unfreeze()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _tree(self, names, tensors) -> dict:
        """The program's named tensors in the reference's layout: {path:
        tensor}, the layers of a stacked leaf stacked in order."""
        by_path: dict = {}
        for n, t in zip(names, tensors):
            path, layer = self.cell.family.port_leaf(n)
            by_path.setdefault(path, {})[layer] = t.float()
        out = {}
        for path, layers in by_path.items():
            if None in layers:
                out[path] = layers[None]
                continue
            keys = sorted(layers)
            lead = tuple(max(k[a] for k in keys) + 1 for a in range(len(keys[0]))) \
                if isinstance(keys[0], tuple) else (len(keys),)
            out[path] = torch.stack([layers[k] for k in keys]).reshape(
                *lead, *layers[keys[0]].shape)
        return out

    def check(self) -> tuple[dict, int]:
        """({number: reading}, checked steps that fail a limit)."""
        t = self.cell.traffic
        kw = dict(mode=self.mode, weight_decay=t.get("weight_decay", 0.0), seed=self.seed,
                  rank=t.get("rank", 8), alpha=t.get("alpha", 16.0),
                  dropout=t.get("dropout", 0.0))
        kw["lr"] = (RT.steplr(t["lr"], step_size_epochs=t["steplr_epochs"],
                              gamma=t["steplr_gamma"], steps_per_epoch=t["steps_per_epoch"])
                    if "steplr_epochs" in t else t["lr"])
        limits = self.cell.limits["numbers"]
        values, failed, self.program_values = {}, 0, {}
        for name, run in self.runs.items():
            suffix = "" if name == "start" else "." + name
            done = "change" in run
            k0 = run["k0"]
            batches = [(torch.from_numpy(self.images[k % len(self.images)]).to(self.device),
                        torch.from_numpy(self.labels[k % len(self.labels)]).to(self.device))
                       for k in range(k0, k0 + CHECKED_STEPS)]
            start = None
            if "v" in run:
                start = {"t0": k0, **{key: self._tree(run["names"], run[key])
                                      for key in ("m", "v")},
                         "train": self._tree(run["names"], run["params"])}
            ref = RT.follow(self.cell.family, self.rcfg, self.tree, batches, start=start, **kw)
            if done:
                prog = ([float(x) for x in run["losses"]],
                        self._by_leaf(run["names"], run["grad1"]),
                        self._by_leaf(run["names"], run["change"]))
            else:  # a run the window never finished: past every limit
                prog = ([0.0] * CHECKED_STEPS, {}, {})
            got, bad = numbers(*prog, ref, limits, suffix)
            if self.control:
                self.program_values.update(got)
                low = RT.follow(self.cell.family, self.rcfg, self.tree, batches, start=start,
                                lowp="fp8", **kw)
                got, bad = numbers(low["losses"], low["grad1"], low["change"], ref, limits,
                                   suffix)
            values.update(got)
            failed += bad
        return values, failed


def numbers(losses, grad1, change, ref, limits, suffix: str = "") -> tuple[dict, int]:
    """The compared numbers of a run of checked steps from the program's
    readings and the reference's (:func:`portbench.reference.train.follow`),
    named with ``suffix``, and how many of its steps fail a limit."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(losses, ref["losses"])]
    keep = {leaf for leaf in ref["change"]
            if any(g.get(leaf, 0.0) >= NOUGHT * RT.median(g.values()) for g in ref["grads"])}
    grad, moved = RT.leaf_gaps(grad1, ref["grad1"]), RT.leaf_gaps(change, ref["change"], keep)
    out = {"loss_gap" + suffix: max(gaps),
           "grad_gap" + suffix: max(grad.values()),
           "change_gap" + suffix: max(moved.values()),
           "grad_gap_median" + suffix: RT.median(grad.values()),
           "change_gap_median" + suffix: RT.median(moved.values())}
    lim = {n: limits[n] for n in out if n in limits}
    bad = any(out[n] > v for n, v in lim.items() if not n.startswith("loss_gap"))
    loss_lim = lim.get("loss_gap" + suffix, float("inf"))
    failed = len(gaps) if bad else sum(g > loss_lim for g in gaps)
    return out, failed
