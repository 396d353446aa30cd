"""End-to-end accuracy parity: the port's side of the experiment.

The repository's ``tools/parity_e2e.py`` runs one tiny experiment twice,
HF ``transformers`` + PEFT (``TorchSide``) against the JAX package
(``JaxSide``):

  corpus -> fine-tune ViT -> FGSM/PGD generation -> per-attack LoRA ->
  composability matrix

and holds every (variant, dataset) accuracy cell to ±0.5%. :class:`PortSide`
is a third side with the same methods, run by the port's own modules: the
HF init imported through ``models/hf_import.py``, the base fine-tune through
``train/steps.py`` with ``train/optim.py``'s AdamW + StepLR, the attacks
through ``attacks/whitebox.py``, the LoRA defense on the attached adapter
(``ops/lora.py``) with its init and its result through ``ops/peft_io.py``,
and the merged variants through ``eval/compose.build_variant_params``.

It follows that file's pinned protocol: dropout 0 (the ViT has none, LoRA
dropout 0), PGD without a random start, shared batch orders, final-epoch
weights, uint8-truncated adversarial images, the LoRA init (factors and the
``SEQ_CLS`` classifier copy) read from a PEFT directory.
:func:`run_port_side` drives the four stages on one :class:`PortSide`; the
root script ``parity_e2e_torch.py`` runs it beside the other two sides (on
the CPU, at the tiny geometry or with ``--full`` at ViT-B/224), and
``chip_smoke.py`` runs it at ViT-B/224 on the card beside the CPU. This
module keeps its own copy of ``make_corpus``, ``batch_orders``,
``FULL_HF_CFG`` and ``LORA_TARGETS``, because the port imports nothing that
imports JAX.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch

from ..attacks import common, whitebox
from ..data import synthetic
from ..eval.compose import build_variant_params
from ..models import hf_import, vit
from ..ops import lora, peft_io
from ..train import optim
from ..train.loop import read_adapter
from ..train.steps import TrainState, make_train_step
from ..utils import trees

N_CLASSES = 12
IMG = 32

# the tiny HF-compatible geometry of the experiment (12 labels)
HF_CFG = dict(image_size=IMG, patch_size=8, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=128, num_labels=N_CLASSES)
# the production ViT-B/224 geometry (google/vit-base-patch16-224's shape), 12 labels
FULL_HF_CFG = dict(image_size=224, patch_size=16, hidden_size=768, num_hidden_layers=12,
                   num_attention_heads=12, intermediate_size=3072, num_labels=N_CLASSES)
# the reference's five LoRA target families (PEFT's query/key/value/output.dense
# with suffix matching): attention q/k/v/o and the MLP's second dense
LORA_TARGETS = ("blocks/attn/q", "blocks/attn/k", "blocks/attn/v", "blocks/attn/o",
                "blocks/mlp/fc2")
ATTACKS = ("fgsm", "pgd")
# the composability matrix: variant -> the adapters merged into the base
VARIANTS = {"base": (), "lora_fgsm": ("fgsm",), "lora_pgd": ("pgd",), "fgsm+pgd": ("fgsm", "pgd")}


def make_corpus(n_train: int, n_val: int, n_test: int, *, image_size: int = IMG):
    """Hard-style synthetic corpus, in memory: ``{split: (NHWC uint8, int64 labels)}``."""
    out = {}
    for si, (split, n) in enumerate((("train", n_train), ("val", n_val), ("test", n_test))):
        rng = np.random.default_rng((1234, si))
        xs, ys = [], []
        for ci in range(N_CLASSES):
            for _ in range(n):
                xs.append(synthetic._render_hard(ci, rng, image_size))
                ys.append(ci)
        out[split] = (np.stack(xs), np.asarray(ys, np.int64))
    return out


def batch_orders(rng: np.random.Generator, n: int, batch: int, epochs: int):
    """One shared shuffle per epoch -> list of index arrays (remainder dropped)."""
    orders = []
    for _ in range(epochs):
        perm = rng.permutation(n)
        orders.append([perm[i:i + batch] for i in range(0, n - batch + 1, batch)])
    return orders


def vit_config(hf_cfg: dict) -> vit.ViTConfig:
    """The port's f32 ViT config of an HF ``ViTConfig``'s fields."""
    return vit.ViTConfig(
        image_size=hf_cfg["image_size"], patch_size=hf_cfg["patch_size"],
        hidden_dim=hf_cfg["hidden_size"], depth=hf_cfg["num_hidden_layers"],
        num_heads=hf_cfg["num_attention_heads"], mlp_dim=hf_cfg["intermediate_size"],
        num_classes=hf_cfg["num_labels"], compute_dtype="float32")


class PortSide:
    """The experiment through the port, from an HF ``ViTForImageClassification``
    state dict (the other sides' init), on ``device`` (the card unless the
    caller asks for the CPU). The model trains copies: the state dict is left
    as it was."""

    def __init__(self, hf_state_dict, *, hf_cfg: dict = HF_CFG, device="cuda"):
        self.device = torch.device(device)
        self.cfg = vit_config(hf_cfg)
        # the importer's tree holds views of the state dict's tensors (a module
        # built over a tree trains those tensors in place)
        tree = hf_import.vit_params_from_hf(
            {k: v.detach().clone() for k, v in hf_state_dict.items()}, self.cfg)
        self.model = vit.params_from_jax(tree, self.cfg).to(self.device)

    def _apply(self, model, x):
        return vit.apply(self.cfg, model, x)

    def _batch(self, x_uint8, y):
        return (torch.from_numpy(np.ascontiguousarray(x_uint8)).to(self.device),
                torch.from_numpy(np.asarray(y)).to(self.device))

    def _train(self, model, state, data, orders) -> list[float]:
        step = make_train_step(self._apply, model, normalize=common.IMAGENET)
        x, y = data
        losses = []
        for epoch in orders:
            for idx in epoch:
                images, labels = self._batch(x[idx], y[idx])
                valid = torch.ones(len(idx), device=self.device)
                _, metrics = step(state, images, labels, valid)
                losses.append(float(metrics["loss_sum"] / metrics["count"]))
        return losses

    def train_base(self, corpus, orders, lr, wd) -> list[float]:
        """AdamW + StepLR(20 epochs, 0.1) over every parameter, the shared
        batch orders; the per-step losses."""
        steps = len(orders[0])
        state = TrainState.create(self.model, None, lambda ps: optim.adamw_steplr(
            ps, lr, weight_decay=wd, step_size_epochs=20, gamma=0.1, steps_per_epoch=steps))
        losses = self._train(self.model, state, corpus["train"], orders)
        self.model.requires_grad_(False)
        self.tree = trees.unflatten_from_paths(
            {p: v.clone() for p, v in vit.params_to_jax(self.model).items()})
        return losses

    @torch.no_grad()
    def accuracy(self, model, x_uint8, y) -> float:
        hits = 0
        for i in range(0, len(y), 64):
            images, _ = self._batch(x_uint8[i:i + 64], y[i:i + 64])
            logits = self._apply(model, common.IMAGENET(common.to_unit_floats(images)))
            hits += int((logits.argmax(-1).cpu().numpy() == y[i:i + 64]).sum())
        return hits / len(y)

    def attack_split(self, x_uint8, y, *, kind, eps, alpha, steps) -> np.ndarray:
        """FGSM / PGD without a random start against the trained base; the
        adversarial images uint8-truncated as the PNG writer stores them."""
        if kind == "fgsm":
            run = whitebox.make_fgsm(vit.apply, self.cfg, eps=eps)
        else:
            run = whitebox.make_pgd(vit.apply, self.cfg, eps=eps, alpha=alpha, steps=steps,
                                    random_start=False)
        out = np.empty_like(x_uint8)
        for i in range(0, len(y), 64):
            images, labels = self._batch(x_uint8[i:i + 64], y[i:i + 64])
            out[i:i + 64] = common.uint8_quantize(run(self.model, images, labels).cpu())
        return out

    def train_lora(self, init_adapter_dir: str, adv, orders, lr, out_dir: str) -> str:
        """The adapter factors and the classifier copy from the PEFT directory
        ``init_adapter_dir``, trained with Adam over the trained (frozen)
        base; written to ``out_dir`` by the port's PEFT writer, which is
        returned."""
        adapter, lcfg, head = peft_io.load_peft_adapter(init_adapter_dir, depth=self.cfg.depth)
        lcfg = lora.LoRAConfig(rank=lcfg.rank, alpha=lcfg.alpha, targets=lcfg.targets,
                               dropout=0.0)
        put = lambda t: t.to(self.device).clone()  # noqa: E731
        base = trees.map_leaves(put, dict(self.tree, head=head))
        attached = lora.attach(base, {p: trees.map_leaves(put, fac) for p, fac in adapter.items()},
                               lcfg)
        model = vit.params_from_jax(attached, self.cfg)
        names = [n for n, _ in model.named_parameters()
                 if n.rsplit(".", 1)[-1] in ("lora_a", "lora_b") or n.startswith("head.")]
        state = TrainState.create(model, names, lambda ps: optim.lora_adam(ps, lr))
        self._train(model, state, adv, orders)
        trained = read_adapter(vit.params_to_jax(model), lcfg, head=True)
        peft_io.save_peft_adapter(trained["adapter"], lcfg, out_dir, head=trained["head"])
        return out_dir

    def merged(self, adapter_dirs):
        """The base with the adapters of ``adapter_dirs`` merged (summed
        deltas, the last adapter's classifier), as eval-compose builds a
        variant; the base itself for no directory."""
        adapters = {d: peft_io.load_peft_adapter(d, depth=self.cfg.depth) for d in adapter_dirs}
        tree = build_variant_params(self.tree, list(adapter_dirs), adapters)
        return vit.params_from_jax(tree, self.cfg).to(self.device)


def accuracy_matrix(accuracy, variant, test, adv_test) -> dict:
    """``{variant: {dataset: accuracy}}`` over :data:`VARIANTS` and the clean
    and each attack's test set: ``variant(combo)`` builds a variant's model
    and ``accuracy(model, x_uint8, y)`` scores it; ``test`` is the clean
    ``(images, labels)``, ``adv_test[attack]`` that attack's images."""
    datasets = {"clean": test, **{k: (x, test[1]) for k, x in adv_test.items()}}
    matrix = {}
    for vname, combo in VARIANTS.items():
        model = variant(combo)
        matrix[vname] = {dname: accuracy(model, *data) for dname, data in datasets.items()}
    return matrix


def run_port_side(side: PortSide, corpus, orders, lora_orders,
                  lora_init: Callable[[PortSide, str, int], str], workdir: str, *,
                  eps: float, alpha: float, pgd_steps: int, lr: float, wd: float) -> dict:
    """The experiment's four stages on ``side``: (1) the base fine-tune over
    ``orders``; (2) FGSM and PGD (no random start) on the train and test
    splits, uint8-truncated; (3) one LoRA adapter an attack, trained over
    ``lora_orders`` on that attack's train split from the PEFT directory
    ``lora_init(side, attack, index)`` (called after stage 1, so that it may
    read the trained head) and written under ``workdir``; (4) the accuracy of
    each of :data:`VARIANTS` on the clean and the two adversarial test sets.

    Returns ``{"losses": per-step base losses, "adv": {attack: {split: uint8
    NHWC}}, "adapters": {attack: directory}, "matrix": {variant: {dataset:
    accuracy}}, "seconds": {stage: wall seconds}}``.
    """
    seconds = {}
    t = time.perf_counter()
    losses = side.train_base(corpus, orders, lr, wd)
    seconds["base"] = time.perf_counter() - t

    t = time.perf_counter()
    adv = {kind: {split: side.attack_split(*corpus[split], kind=kind, eps=eps, alpha=alpha,
                                           steps=pgd_steps)
                  for split in ("train", "test")}
           for kind in ATTACKS}
    seconds["attacks"] = time.perf_counter() - t

    t = time.perf_counter()
    adapters = {}
    for i, kind in enumerate(ATTACKS):
        adapters[kind] = side.train_lora(lora_init(side, kind, i),
                                         (adv[kind]["train"], corpus["train"][1]), lora_orders,
                                         lr, os.path.join(workdir, f"port_{kind}"))
    seconds["lora"] = time.perf_counter() - t

    t = time.perf_counter()
    matrix = accuracy_matrix(side.accuracy, lambda combo: side.merged([adapters[a] for a in combo]),
                             corpus["test"], {k: adv[k]["test"] for k in ATTACKS})
    seconds["matrix"] = time.perf_counter() - t
    return {"losses": losses, "adv": adv, "adapters": adapters, "matrix": matrix,
            "seconds": seconds}
