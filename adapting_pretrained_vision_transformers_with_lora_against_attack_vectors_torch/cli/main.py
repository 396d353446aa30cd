"""CLI: argparse subcommands over the library modules.

Counterpart of the JAX package's ``cli/main.py`` for the stages ported so
far (``synth-data``, ``attack``, ``eval-compose``), with its flags, defaults
and paths:

* base checkpoints: ``{out}/{model}/{source}/{model}_best_model_finetuned.safetensors``
  + ``class_mappings.txt`` (as the JAX ``train`` stage writes them)
* adversarial data: ``{adv_root}/{model}/{source}/{split}/{attack}/images``
  + ``metadata.csv``
* adapters: ``{lora_root}/{model}/{source}/{attack}/rank{r}_best_adapter``
  (PEFT format); the composability matrix: ``{output_dir}/test_results.json``

The attention kernels have no switch: a ViT or Swin on a CUDA device always
runs its CUDA attention kernel, on the CPU the plain version. ConvNeXt's two
kernels are opt-in config fields, as in the JAX package: ``--fused_block``
sets ``fuse_ln_mlp`` (the LayerNorm-fused MLP kernel); ``use_dw_kernel`` (the
depthwise 7x7 kernel) has no flag in either CLI and is set on the config.
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


def _apply_kernel_flags(args, cfg):
    """``--fused_block``: the backbone's fused-block field (ConvNeXt:
    ``fuse_ln_mlp``); an error for a backbone that has none, as in JAX."""
    import dataclasses

    if not getattr(args, "fused_block", False):
        return cfg
    if not hasattr(cfg, "fuse_ln_mlp"):
        raise SystemExit(f"--fused_block unsupported for {args.model}")
    return dataclasses.replace(cfg, fuse_ln_mlp=True)


def _load_checkpoint(args, device, *, auto_dtype: str):
    """Checkpoint (written by either package) -> (entry, cfg, tree, vocab);
    float leaves in ``--param_dtype`` (``auto_dtype`` for "auto"), on ``device``."""
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
    cfg = _apply_kernel_flags(args, entry.config(len(vocab)))
    tree, _ = ckpt.load_pytree(args.model_path)
    pdt = auto_dtype if args.param_dtype == "auto" else args.param_dtype
    target = torch.bfloat16 if pdt == "bf16" else torch.float32
    tree = trees.map_leaves(
        lambda t: t.to(device, target) if t.is_floating_point() else t.to(device), tree)
    return entry, cfg, tree, vocab


def _eval_loader(meta, vocab, *, root_dir, sources=None, batch_size, image_size):
    from ..data.loader import Loader, MetadataIndex

    return Loader(MetadataIndex(meta, vocab, root_dir=root_dir, sources=sources),
                  batch_size=batch_size, image_size=image_size,
                  resize=_eval_resize(image_size))


def _loaders_for(args, vocab, splits, *, batch_size, image_size):
    out = {}
    for split in splits:
        meta = os.path.join(args.data_root, split, "metadata.csv")
        out[split] = (_eval_loader(meta, vocab, root_dir=args.data_root, sources=args.sources,
                                   batch_size=batch_size, image_size=image_size)
                      if os.path.exists(meta) else None)
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
    # "auto": bf16 params on CUDA (the attack path's working dtype), f32 on CPU
    entry, cfg, tree, vocab = _load_checkpoint(
        args, device, auto_dtype="bf16" if device.type == "cuda" else "f32")
    model = entry.from_tree(tree, cfg)
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


def cmd_eval_compose(args):
    from ..attacks.common import Normalizer
    from ..eval import compose
    from ..models.registry import get_normalization

    device = _device(args)
    # "auto": f32 params on every device for this stage (accuracy parity);
    # the compute dtype stays the model config's
    entry, cfg, tree, vocab = _load_checkpoint(args, device, auto_dtype="f32")
    source = "_".join(args.sources) if args.sources else "all"
    loader_args = dict(batch_size=args.batch_size, image_size=cfg.image_size)

    # clean test loader + auto-discovered attack test sets
    loaders = {}
    clean_meta = os.path.join(args.data_root, "test", "metadata.csv")
    if os.path.exists(clean_meta):
        loaders["clean"] = _eval_loader(clean_meta, vocab, root_dir=args.data_root,
                                        sources=args.sources, **loader_args)
    adv_base = os.path.join(args.adv_root, args.model, source, "test")
    if os.path.isdir(adv_base):
        for attack in sorted(os.listdir(adv_base)):
            meta = os.path.join(adv_base, attack, "metadata.csv")
            if os.path.exists(meta):
                loaders[attack] = _eval_loader(meta, vocab, root_dir=os.path.join(adv_base, attack),
                                               **loader_args)

    adapters = compose.find_lora_adapters(
        os.path.join(args.lora_root, args.model, source), args.attacks, args.rank)
    if not adapters:
        print("warning: no adapters found; evaluating base only")
    missing = [a for a in args.attacks if a not in adapters]
    if missing and adapters:
        print(f"warning: no adapter for {missing} — every variant "
              f"containing them is omitted from the matrix")

    results = compose.run_composability_eval(
        entry, tree, adapters, loaders, len(vocab), test_mode=args.test_mode,
        normalize=Normalizer(*get_normalization(args.model)), cfg=cfg, device=device,
        out_path=os.path.join(args.output_dir, "test_results.json"))
    print(compose.format_summary_table(results))


# --- parser ------------------------------------------------------------------

def _model_args(sp, auto_help: str) -> None:
    """Data, checkpoint and batch flags shared by the stages that load a model."""
    _common_data_args(sp)
    sp.add_argument("--model", default="google_vit")
    sp.add_argument("--model_path", required=True, help="base checkpoint (.safetensors)")
    sp.add_argument("--batch_size", type=int, default=32)
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--param_dtype", default="auto", choices=("auto", "f32", "bf16"),
                    help=f"model parameter dtype. {auto_help}")
    sp.add_argument("--fused_block", action="store_true",
                    help="ConvNeXt: each block's LayerNorm + pointwise MLP through the "
                         "hand-written LN-fused MLP kernel (CUDA + bf16 compute; its plain "
                         "version on the CPU). Off by default")


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
    _model_args(sp, "auto = bf16 on CUDA, f32 on CPU")
    sp.add_argument("--output_dir", default="./adv")
    sp.add_argument("--attacks", nargs="+", default=["fgsm", "pgd"],
                    choices=["fgsm", "pgd"])
    sp.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    sp.add_argument("--epsilon", type=float, default=8 / 255)
    sp.add_argument("--alpha", type=float, default=3 / 255)
    sp.add_argument("--steps", type=int, default=30)
    sp.set_defaults(fn=cmd_attack)

    sp = sub.add_parser("eval-compose", help="LoRA composability matrix")
    _model_args(sp, "auto = f32 on every device (the compute dtype stays the "
                    "model config's)")
    sp.add_argument("--adv_root", default="./adv")
    sp.add_argument("--lora_root", default="./loras")
    sp.add_argument("--output_dir", default="./eval_out")
    sp.add_argument("--attacks", nargs="+", default=["fgsm", "pgd"])
    sp.add_argument("--rank", type=int, default=8)
    sp.add_argument("--test_mode", default="all",
                    choices=["all", "base_only", "individual_only", "combinations_only"])
    sp.set_defaults(fn=cmd_eval_compose)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
