"""CLI: argparse subcommands over the library modules.

Counterpart of the JAX package's ``cli/main.py`` for the stages ported so
far (``synth-data``, ``attack``), with its flags, defaults and paths:

* base checkpoints: ``{out}/{model}/{source}/{model}_best_model_finetuned.safetensors``
  + ``class_mappings.txt`` (as the JAX ``train`` stage writes them)
* adversarial data: ``{adv_root}/{model}/{source}/{split}/{attack}/images``
  + ``metadata.csv``

There is no kernel switch: a model on a CUDA device always runs the CUDA
attention kernel, a model on the CPU its plain version.
"""

from __future__ import annotations

import argparse
import os
import sys


def _common_data_args(p):
    p.add_argument("--data_root", required=True,
                   help="processed dataset root ({split}/metadata.csv)")
    p.add_argument("--sources", nargs="+", default=None,
                   help="filter metadata by source column")


def _eval_resize(image_size: int) -> int:
    """Resize(256) before CenterCrop(224), scaled to the model input size."""
    return int(round(image_size * 256 / 224))


def _device(args):
    import torch

    if args.device == "auto":
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(args.device)


def _build_vocab(args, splits=("train", "val", "test")):
    from ..data.io import filter_metadata, read_metadata
    from ..utils.vocab import LabelVocabulary

    frames = []
    for split in splits:
        meta = os.path.join(args.data_root, split, "metadata.csv")
        if os.path.exists(meta):
            frames.append(filter_metadata(read_metadata(meta), args.sources))
    if not frames:
        raise SystemExit(f"no metadata.csv under {args.data_root}")
    return LabelVocabulary.from_metadata_frames(frames)


def _load_model(args, device):
    """Checkpoint (written by either package) -> (entry, cfg, model, vocab)."""
    import torch

    from ..models.registry import get_model
    from ..utils import checkpoint as ckpt
    from ..utils import trees
    from ..utils.vocab import LabelVocabulary

    if not args.model_path.endswith(".safetensors"):
        raise SystemExit("--model_path takes a .safetensors checkpoint")
    mapping = os.path.join(os.path.dirname(args.model_path), "class_mappings.txt")
    vocab = (LabelVocabulary.load(mapping) if os.path.exists(mapping)
             else _build_vocab(args))
    entry = get_model(args.model)
    cfg = entry.config(len(vocab))
    tree, _ = ckpt.load_pytree(args.model_path)
    # "auto": bf16 params on CUDA (the attack path's working dtype), f32 on CPU
    pdt = args.param_dtype
    if pdt == "auto":
        pdt = "bf16" if device.type == "cuda" else "f32"
    target = torch.bfloat16 if pdt == "bf16" else torch.float32
    tree = trees.map_leaves(
        lambda t: t.to(target) if t.is_floating_point() else t, tree)
    model = entry.from_tree(tree, cfg).to(device)
    return entry, cfg, model, vocab


def _loaders_for(args, vocab, splits, *, batch_size, image_size):
    from ..data.loader import Loader, MetadataIndex

    out = {}
    for split in splits:
        meta = os.path.join(args.data_root, split, "metadata.csv")
        if not os.path.exists(meta):
            out[split] = None
            continue
        idx = MetadataIndex(meta, vocab, root_dir=args.data_root, sources=args.sources)
        out[split] = Loader(idx, batch_size=batch_size, image_size=image_size,
                            resize=_eval_resize(image_size))
    return out


# --- subcommands -------------------------------------------------------------

def cmd_synth_data(args):
    from ..data import synthetic

    synthetic.make_synthetic_dataset(
        args.output_dir, n_per_class=args.n_per_class,
        image_size=args.image_size, style=args.style)
    print(f"synthetic dataset written to {args.output_dir}")


def cmd_attack(args):
    from ..attacks import generate, whitebox
    from ..attacks.common import Normalizer
    from ..data.io import filter_metadata, read_metadata
    from ..models.registry import get_normalization

    device = _device(args)
    entry, cfg, model, vocab = _load_model(args, device)
    normalize = Normalizer(*get_normalization(args.model))
    source = "_".join(args.sources) if args.sources else "all"

    attacks = {}
    if "fgsm" in args.attacks:
        f = whitebox.make_fgsm(entry.apply, cfg, eps=args.epsilon, normalize=normalize)
        # FGSM is deterministic: the per-batch generator is not used
        attacks["fgsm"] = lambda p, im, lb, gen, _f=f: _f(p, im, lb)
    if "pgd" in args.attacks:
        attacks["pgd"] = whitebox.make_pgd(
            entry.apply, cfg, eps=args.epsilon, alpha=args.alpha,
            steps=args.steps, normalize=normalize)

    loaders = _loaders_for(args, vocab, args.splits, batch_size=args.batch_size,
                           image_size=cfg.image_size)
    for split in args.splits:
        loader = loaders[split]
        if loader is None:
            print(f"skip {split}: no metadata")
            continue
        clean_meta = filter_metadata(
            read_metadata(os.path.join(args.data_root, split, "metadata.csv")),
            args.sources)
        for name, fn in attacks.items():
            out_dir = generate.attack_output_dir(
                args.output_dir, args.model, source, split, name)
            meta = generate.generate_adversarial_split(
                fn, model, loader, out_dir=out_dir, clean_metadata=clean_meta,
                seed=args.seed, device=device)
            print(f"{name} {split}: {len(meta)} adversarial images -> {out_dir}")


# --- parser ------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="apvt-lora-torch",
        description="PyTorch/CUDA LoRA-robustness pipeline for vision transformers")
    p.add_argument("--device", default="auto",
                   help="'auto' (CUDA when available, else CPU), 'cuda', "
                        "'cuda:N' or 'cpu'. Must precede the subcommand.")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("synth-data", help="generate a synthetic dataset")
    sp.add_argument("--output_dir", required=True)
    sp.add_argument("--n_per_class", type=int, default=8)
    sp.add_argument("--image_size", type=int, default=64)
    sp.add_argument("--style", default="default", choices=["default", "hard"],
                    help="'hard' = 12 glyph-coded confusable classes "
                         "(non-robust fine features, for robustness runs)")
    sp.set_defaults(fn=cmd_synth_data)

    sp = sub.add_parser("attack", help="FGSM/PGD adversarial generation")
    _common_data_args(sp)
    sp.add_argument("--model", default="google_vit")
    sp.add_argument("--model_path", required=True, help="base checkpoint (.safetensors)")
    sp.add_argument("--batch_size", type=int, default=32)
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--param_dtype", default="auto", choices=("auto", "f32", "bf16"),
                    help="model parameter dtype. auto = bf16 on CUDA, f32 on CPU")
    sp.add_argument("--output_dir", default="./adv")
    sp.add_argument("--attacks", nargs="+", default=["fgsm", "pgd"],
                    choices=["fgsm", "pgd"])
    sp.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    sp.add_argument("--epsilon", type=float, default=8 / 255)
    sp.add_argument("--alpha", type=float, default=3 / 255)
    sp.add_argument("--steps", type=int, default=30)
    sp.set_defaults(fn=cmd_attack)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
