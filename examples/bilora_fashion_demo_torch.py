"""BiLoRA on FashionMNIST with the PyTorch port: the reference's
``train_bilora.ipynb`` workflow, the counterpart of ``bilora_fashion_demo.py``.
A frozen backbone gets a per-task frequency-domain adapter (n_frq learnable
spectral coefficients, dW = alpha * Re(ifft2(spectrum))) and a trained head.

It reads real FashionMNIST IDX files under ``./fashion_data`` (the
reference's layout) when they are there, and otherwise writes a synthetic
class-coded IDX fixture (nothing is downloaded). It runs on the CUDA card
unless ``--device cpu`` is given:

    python examples/bilora_fashion_demo_torch.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.nn.functional as F

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data import fashion
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import registry
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import bilora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import trees


def get_data(device, limit=128):
    try:
        tr_x, tr_y = fashion.load_split("./fashion_data", "train", limit=limit)
        te_x, te_y = fashion.load_split("./fashion_data", "test", limit=limit // 2)
        print("using real FashionMNIST from ./fashion_data")
    except FileNotFoundError:
        print("no ./fashion_data — generating a synthetic IDX fixture")
        root = tempfile.mkdtemp()
        rng = np.random.default_rng(0)

        def make(n, img_name, lbl_name):
            labels = (np.arange(n) % 10).astype(np.uint8)
            images = rng.integers(0, 40, (n, 28, 28), dtype=np.uint8)
            for i, c in enumerate(labels):
                images[i, 4 + c * 2: 10 + c * 2, 6:22] = 220
            fashion.write_idx(os.path.join(root, img_name), images)
            fashion.write_idx(os.path.join(root, lbl_name), labels)

        make(limit, "train-images-idx3-ubyte", "train-labels-idx1-ubyte")
        make(limit // 2, "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
        tr_x, tr_y = fashion.load_split(root, "train")
        te_x, te_y = fashion.load_split(root, "test")
    as_t = lambda a: torch.from_numpy(a).to(device)
    return (as_t(fashion.to_rgb_float(tr_x, image_size=32)), as_t(tr_y).long(),
            as_t(fashion.to_rgb_float(te_x, image_size=32)), as_t(te_y).long())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    name = ap.parse_args(argv).device
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device found; pass --device cpu")

    x_tr, y_tr, x_te, y_te = get_data(device)
    entry = registry.get_model("vit_test")
    cfg = entry.config(10)
    base = trees.map_leaves(lambda t: t.to(device),
                            entry.init(cfg, torch.Generator().manual_seed(0)))

    bcfg = bilora.BiLoRAConfig(n_frq=100, alpha=1.0, task_id=0,
                               targets=("blocks/attn/q", "blocks/attn/v"))
    coeffs = bilora.init(base, bcfg)
    print("BiLoRA trainable params:", bilora.num_params(coeffs),
          "spectral coefficients + head")

    # the frozen backbone takes W + dW through functional_call, so the
    # coefficients keep their gradient; the head trains in place
    model = entry.from_tree(trees.map_leaves(lambda t: t.clone(), base), cfg)
    for n, p in model.named_parameters():
        p.requires_grad_(n.startswith("head."))
    leaves = [t.requires_grad_() for fac in coeffs.values() for t in fac.values()]
    opt = torch.optim.Adam(leaves + list(model.head.parameters()), lr=5e-3)
    losses = []
    for i in range(80):
        logits = torch.func.functional_call(model, bilora.module_params(model, coeffs, bcfg),
                                            (x_tr,))
        loss = F.cross_entropy(logits, y_tr)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % 20 == 0:
            losses.append(float(loss.detach()))
            print(f"step {i}: loss {losses[-1]:.4f}")

    def acc(tree):
        with torch.no_grad():
            logits = entry.apply(cfg, entry.from_tree(tree, cfg), x_te)
        return float((logits.argmax(-1) == y_te).float().mean())

    merged = bilora.apply_delta(base, {p: {k: t.detach() for k, t in fac.items()}
                                       for p, fac in coeffs.items()}, bcfg)
    merged["head"] = {k: t.detach().clone() for k, t in model.head.leaves().items()}
    out = {"losses": losses, "base": acc(base), "bilora": acc(merged)}
    print(f"test accuracy: base {out['base']:.3f} -> BiLoRA {out['bilora']:.3f}")
    return out


if __name__ == "__main__":
    main()
