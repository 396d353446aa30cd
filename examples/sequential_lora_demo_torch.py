"""Sequential LoRA stacking with the PyTorch port: the reference's
``infLora.ipynb`` workflow, the counterpart of ``sequential_lora_demo.py``.

1. fine-tune LoRA-1 on clean data and MERGE it into the base;
2. treat the merged model as a new base; fine-tune LoRA-2 (another rank)
   on Gaussian-noise-corrupted data; merge again;
3. print the clean/noisy accuracy of the base, stage 1 and stage 2.

It runs on the CUDA card unless ``--device cpu`` is given (a few seconds
there, with the synthetic dataset):

    python examples/sequential_lora_demo_torch.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.nn.functional as F

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks.common import from_uint8
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks.corruptions import gaussian_noise
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data import synthetic
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data.loader import Loader, MetadataIndex
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import registry
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import lora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import trees
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils.vocab import LabelVocabulary


def load_arrays(root, split, vocab, device):
    idx = MetadataIndex(os.path.join(root, split, "metadata.csv"), vocab)
    xs, ys = [], []
    for b in Loader(idx, batch_size=32, image_size=32, resize=32):
        keep = b.valid > 0
        xs.append(from_uint8(b.images)[keep])
        ys.append(b.labels[keep])
    return (torch.from_numpy(np.concatenate(xs)).to(device),
            torch.from_numpy(np.concatenate(ys)).long().to(device))


def train_lora_merge(entry, cfg, base, x, y, *, rank, steps=60, lr=5e-3, seed=0):
    """Train an adapter (and the head) on ``(x, y)`` against the frozen
    ``base`` tree; return the tree with the adapter merged and the head."""
    lcfg = lora.LoRAConfig(rank=rank, alpha=16.0, targets=entry.lora_targets(cfg), dropout=0.0)
    adapter = lora.init(torch.Generator().manual_seed(seed), base, lcfg)
    tree = lora.attach(base, adapter, lcfg)
    model = entry.from_tree(trees.map_leaves(lambda t: t.to(x.device, copy=True), tree), cfg)
    for n, p in model.named_parameters():
        p.requires_grad_(n.startswith("head.") or n.endswith((".lora_a", ".lora_b")))
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=lr)
    for _ in range(steps):
        loss = F.cross_entropy(entry.apply(cfg, model, x), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    flat = entry.to_tree(model)
    trained = {p: {"a": flat[f"{p}/lora_a"], "b": flat[f"{p}/lora_b"]} for p in lcfg.targets}
    merged = lora.merge(base, trained, lcfg)
    merged["head"] = {k: flat[f"head/{k}"] for k in base["head"]}
    return merged


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    name = ap.parse_args(argv).device
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device found; pass --device cpu")

    root = tempfile.mkdtemp()
    synthetic.make_synthetic_dataset(root, n_per_class={"train": 16, "val": 4, "test": 8},
                                     image_size=32)
    vocab = LabelVocabulary.from_classes(synthetic.DEFAULT_CLASSES)
    entry = registry.get_model("vit_test")
    cfg = entry.config(len(vocab))
    base = entry.init(cfg, torch.Generator().manual_seed(0))

    x_tr, y_tr = load_arrays(root, "train", vocab, device)
    x_te, y_te = load_arrays(root, "test", vocab, device)
    x_te_noisy = gaussian_noise(x_te, torch.Generator(device).manual_seed(7), sigma=0.3)
    x_tr_noisy = gaussian_noise(x_tr, torch.Generator(device).manual_seed(8), sigma=0.3)

    def acc(tree, x, y):
        model = entry.from_tree(trees.map_leaves(lambda t: t.to(device), tree), cfg)
        with torch.no_grad():
            return float((entry.apply(cfg, model, x).argmax(-1) == y).float().mean())

    out = {}

    def report(stage, label, tree):
        out[stage] = {"clean": acc(tree, x_te, y_te), "noisy": acc(tree, x_te_noisy, y_te)}
        print(f"{label}: clean={out[stage]['clean']:.3f} noisy={out[stage]['noisy']:.3f}")

    report(0, "stage 0 (random base)", base)
    stage1 = train_lora_merge(entry, cfg, base, x_tr, y_tr, rank=4, seed=1)
    report(1, "stage 1 (LoRA-1 r=4 on clean, merged)", stage1)
    stage2 = train_lora_merge(entry, cfg, stage1, x_tr_noisy, y_tr, rank=16, seed=2)
    report(2, "stage 2 (+LoRA-2 r=16 on noisy, merged)", stage2)
    return out


if __name__ == "__main__":
    main()
