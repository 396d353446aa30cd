"""Adversarial dataset generation: the ``attack`` stage's hot path.

Set-up builds the model as the stage does for the card (every float leaf in
the traffic's ``param_dtype``, the configuration's compute dtype) over
parameters made on the device from the seed, the attack through the
program's ``attacks.whitebox.make_pgd``, and a host pool of uint8 batches
and labels from the seed. A unit is one batch, as
``attacks.generate.generate_adversarial_split`` runs it: the uint8 batch to
the device, the random start drawn from a generator seeded ``seed · 100003 +
k`` for batch k (``attacks/generate``'s rule), the attack, and the
adversarial batch back with ``.cpu()``. PNG encoding is left out (host codec
work).

The check follows the program step by step from its own states. The
window's last ``CLOSING`` batches are run once its time is up, and
``CHECKED`` of them, drawn from the seed, are recorded: each state of the
attack (the [0, 1] images that the attack hands to the ``normalize`` it was
given, once a step: ``attacks.whitebox.make_pgd``'s interface) is copied to
pinned host memory as it goes, and the adversarial batch is kept. A program
that stopped calling ``normalize`` once a step could not be followed, and
says so on standard error. After the window the
plain reference (f32, TF32 off) works out again, from the same clean images
and the same seeded start, the start and, at each recorded state, the input
gradient, and reads per image:

* ``start_gap``: how far the program's first state lies from the reference's
  projected random start (exact: 0);
* ``step_miss``: the share of pixels whose next state (the output, after the
  last step) is none of the three whole steps -alpha, 0, +alpha from the
  state, each projected onto the eps-ball around the clean image intersected
  with [0, 1] (exact: 0);
* ``ascent_lost`` (``_first``: at the first step only): over the pixels
  whose move the next state tells, the |gradient|-weighted share whose move
  is not the sign of the reference's gradient at the program's own state:
  the first-order ascent the program gives up, the worst step
  (``ascent_lost_upto<k>``: the worst of steps 1 to k);
* ``ball_excess``: how far an output pixel lies outside the ball (exact: 0).

Which numbers are compared, and their limits, are the cell's limits file's;
the number reported is the worst image's.
"""

from __future__ import annotations

import gc
import random
import sys
import time

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..core import weights
from ..reference import common as C
from . import common

SEED_STRIDE = 100003  # batch k's start generator: seed * SEED_STRIDE + k
WARMUP_UNITS = 1  # set-up's batches, on the cell's own shapes
CLOSING, CHECKED = 4, 2  # the window's last batches, and how many of them are checked
UPTO = "ascent_lost_upto"  # a number's name: the worst of steps 1 to the number after it
# (all of them, in an attack of fewer steps)


class Driver:
    def __init__(self, cell, seed: int, device, *, control: bool = False):
        self.cell, self.seed, self.device, self.control = cell, seed, torch.device(device), control
        t = cell.traffic
        self.batch, self.steps = t["batch"], t["steps"]
        self.eps, self.alpha = t["eps_over_255"] / 255, t["alpha_over_255"] / 255
        self.trace_units = t["trace_units"]
        self.outputs, self.k = {}, 0
        self.tail = None  # batches run since the window's time ran out
        self.slot = None  # the recording slot of the batch under way

    def setup(self) -> None:
        t0 = time.perf_counter()
        cell, t = self.cell, self.cell.traffic
        entry, cfg = common.program(cell)
        whitebox = common.port("attacks.whitebox")
        normalizer = common.port("attacks.common").Normalizer(*entry.normalization)
        fam = cell.family
        self.rcfg = fam.config(cell.config)
        self.tree = weights.make(fam.layout(self.rcfg), self.seed, self.device,
                                 getattr(torch, t["param_dtype"]))
        tree = self.tree
        if self.control:  # the program's own W8A8 path: the benchmark's control
            tree = common.port("ops.quant").quantize_dense_tree(tree, cell.config["w8a8_targets"])
        self.model = entry.from_tree(tree, cfg)

        def normalize(x):
            if self.slot is not None:
                self._record(x)
            return normalizer(x)

        self.attack = whitebox.make_pgd(entry.apply, cfg, eps=self.eps, alpha=self.alpha,
                                        steps=self.steps, normalize=normalize)
        self.images, self.labels = common.host_pool(
            self.seed, self.batch, self.rcfg.image_size, self.rcfg.classes)
        size = self.rcfg.image_size
        self.picks = sorted(random.Random(self.seed).sample(range(CLOSING), CHECKED))
        self.rec = torch.empty((CHECKED, self.steps, self.batch, size, size, 3),
                               pin_memory=self.device.type == "cuda")
        self.rec_steps = [0] * CHECKED
        self.rec_odd = False  # a state of another shape, or more states than steps
        self.phases = {"built_s": time.perf_counter() - t0}
        for _ in range(WARMUP_UNITS):
            self.unit()
        common.sync(self.device)
        self.phases["warm_s"] = time.perf_counter() - t0

    def closing(self) -> int:
        """Mark the window's last units, of which the check reads ``CHECKED``."""
        self.tail = 0
        return CLOSING

    def _gen(self, k: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(self.seed * SEED_STRIDE + k)

    def _record(self, x: torch.Tensor) -> None:
        """Copy the attack's state ``x`` to the batch's slot, asynchronously."""
        j, t = self.slot, self.rec_steps[self.slot]
        if t >= self.steps or x.shape != self.rec.shape[2:]:
            self.rec_odd = True
            return
        self.rec[j, t].copy_(x.detach(), non_blocking=True)
        self.rec_steps[j] = t + 1

    def unit(self) -> int:
        k, self.k = self.k, self.k + 1
        i = k % len(self.images)
        c = self.tail
        self.slot = self.picks.index(c) if c in self.picks else None
        if c is not None:
            self.tail = c + 1
        with record_function("batch_to_device"):
            images = torch.from_numpy(self.images[i]).to(self.device)
            labels = torch.from_numpy(self.labels[i]).to(self.device)
        with record_function("attack_call"):
            adv = self.attack(self.model, images, labels, self._gen(k))
        with record_function("fetch_to_host"):
            adv = adv.cpu()
        if self.slot is not None:
            self.outputs[self.slot] = (k, adv)
        self.slot = None
        return self.batch

    def drain(self) -> None:
        common.sync(self.device)

    def counters(self) -> dict:
        return common.counters()

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.model = self.attack = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> tuple[dict, int]:
        """({number: its worst reading}, recorded images that fail a limit)."""
        fam, rcfg = self.cell.family, self.rcfg
        params = {p: v.float() for p, v in self.tree.items()}
        limits = self.cell.limits["numbers"]
        upto = [(min(int(n[len(UPTO):]), self.steps), n) for n in limits if n.startswith(UPTO)]
        names = ("start_gap", "step_miss", "ascent_lost_first", "ascent_lost", "ball_excess",
                 *(n for _, n in upto))
        per_image = {n: [] for n in names}
        self.by_step = []
        with C.exact_matmuls():
            for j in range(CHECKED):
                out = self.outputs.get(j)
                if (out is None or self.rec_odd or self.rec_steps[j] != self.steps
                        or out[1].shape != self.rec.shape[2:]):
                    print(f"portbench: checked batch {j}: the attack handed normalize "
                          f"{self.rec_steps[j]} states of {self.steps} steps"
                          f"{' (or states of another shape)' if self.rec_odd else ''}"
                          f"{'' if out is not None else ', and never finished'}: "
                          "the check cannot follow it", file=sys.stderr)
                    for v in per_image.values():  # a batch that never ran, or states or an
                        v.append(1.0)             # output that do not fit: past every limit
                    continue
                k, out = out[0], out[1].to(self.device, torch.float32)
                i = k % len(self.images)
                x0 = C.unit_images(torch.from_numpy(self.images[i]).to(self.device))
                labels = torch.from_numpy(self.labels[i]).to(self.device)
                noise = torch.empty(x0.shape, device=self.device).uniform_(
                    -self.eps, self.eps, generator=self._gen(k))
                lo, hi = (x0 - self.eps).clamp_min(0.0), (x0 + self.eps).clamp_max(1.0)
                states = self.rec[j].to(self.device)
                start = torch.clamp(x0 + noise, lo, hi)
                per_image["start_gap"] += (states[0] - start).abs().flatten(1).amax(1).tolist()
                miss = torch.zeros(self.batch, device=self.device)
                lost = torch.zeros(self.batch, device=self.device)
                steps = []
                for t in range(self.steps):
                    x_t, x_next = states[t], states[t + 1] if t + 1 < self.steps else out
                    # the program's move: the one whole step (-1, 0, +1) that gives x_next
                    hits = torch.stack([torch.clamp(x_t + self.alpha * torch.full_like(x_t, s),
                                                    lo, hi) == x_next for s in (-1.0, 0.0, 1.0)])
                    miss = torch.maximum(miss, (~hits.any(0)).flatten(1).float().mean(1))
                    known = hits.sum(0) == 1
                    move = hits.float().argmax(0) - 1.0
                    with torch.enable_grad():
                        x = x_t.detach().requires_grad_(True)
                        loss = F.cross_entropy(fam.forward(params, rcfg, C.normalize(x)), labels,
                                               reduction="sum")
                        (g,) = torch.autograd.grad(loss, x)
                    w = g.abs() * known
                    wrong = (move != torch.sign(g)).float()
                    share = (w * wrong).flatten(1).sum(1) / w.flatten(1).sum(1).clamp_min(1e-30)
                    lost = torch.maximum(lost, share)
                    steps.append(float(share.max()))
                    if t == 0:
                        per_image["ascent_lost_first"] += share.tolist()
                    for n in (n for k, n in upto if k == t + 1):
                        per_image[n] += lost.tolist()
                self.by_step.append(steps)
                per_image["step_miss"] += miss.tolist()
                per_image["ascent_lost"] += lost.tolist()
                excess = torch.maximum(lo - out, out - hi).clamp_min(0.0)
                per_image["ball_excess"] += excess.flatten(1).amax(1).tolist()
        n_images = len(per_image["ball_excess"])
        failed = sum(any(per_image[n][j] > lim for n, lim in limits.items())
                     for j in range(n_images))
        worst = {n: max(v) for n, v in per_image.items()}
        return worst, failed
