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
``SEQ_CLS`` classifier copy) read from a PEFT directory. This module keeps
its own copy of ``make_corpus`` and ``batch_orders``, because the port
imports nothing that imports JAX; ``tests/test_torch_parity_e2e.py`` runs
the three sides.
"""

from __future__ import annotations

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


class PortSide:
    """The experiment through the port, from an HF ``ViTForImageClassification``
    state dict (the other sides' init), on ``device``."""

    def __init__(self, hf_state_dict, *, hf_cfg: dict = HF_CFG, device="cpu"):
        self.device = torch.device(device)
        self.cfg = vit.ViTConfig(
            image_size=hf_cfg["image_size"], patch_size=hf_cfg["patch_size"],
            hidden_dim=hf_cfg["hidden_size"], depth=hf_cfg["num_hidden_layers"],
            num_heads=hf_cfg["num_attention_heads"], mlp_dim=hf_cfg["intermediate_size"],
            num_classes=hf_cfg["num_labels"], compute_dtype="float32")
        tree = hf_import.vit_params_from_hf(hf_state_dict, self.cfg)
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
