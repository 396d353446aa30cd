"""CLI: argparse subcommands over the library modules.

Counterpart of the JAX package's ``cli/main.py`` for the five pipeline
stages (``synth-data``, ``train``, ``attack``, ``train-lora``,
``eval-compose``) and the other attack stages (``autoattack``,
``patch-attack``, ``rp2-attack``), with its flags, defaults and paths:

* base checkpoints: ``{out}/{model}/{source}/{model}_best_model_finetuned.safetensors``
  + ``class_mappings.txt`` (``train`` writes them, as the JAX stage does;
  either package reads the other's); ``--model_path`` and ``train
  --checkpoint`` also take a local pretrained checkpoint (an HF model
  directory, ``pytorch_model.bin``, the reference's ``.pth``) through
  ``models.pretrained.load_pretrained``
* adversarial data: ``{adv_root}/{model}/{source}/{split}/{attack}/images``
  + ``metadata.csv`` (``attack`` = ``fgsm``, ``pgd``, ``autoattack``,
  ``patch_circle``, ``patch_square``, ``rp2``); RP2's per-class patches:
  ``{adv_root}/{model}/{source}/{split}/rp2/patches/rp2_patch_<class>.png``
* adapters: ``{lora_root}/{model}/{source}/{attack}/rank{r}_best_adapter``
  (PEFT format); the composability matrix: ``{output_dir}/test_results.json``

The stages run on the card: without CUDA the CLI stops with an error unless
``--device cpu`` is given.

The packed and window attention kernels have no switch: a ViT or Swin on a
CUDA device always runs its CUDA attention kernel, on the CPU the plain
version. The other kernels are opt-in config fields, as in the JAX package:
``--fused_block`` sets ``fuse_attn_block`` where the backbone has it (the ViT
family: the fused attention half-block, which implies the LN-fused MLP) and
else ``fuse_ln_mlp`` (ConvNeXt: the LayerNorm-fused MLP kernel);
``--fused_mlp`` sets ``use_fused_mlp`` (the fused MLP behind a library
LayerNorm); ``use_dw_kernel`` (the depthwise 7x7 kernel) has no flag in
either CLI and is set on the config.
"""

from __future__ import annotations

import argparse
import json
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

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device found. The stages run on the "
                         f"card; pass --device cpu (before the subcommand) to run on the CPU")
    return device


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
    """``--fused_mlp``: ``use_fused_mlp``. ``--fused_block``: the backbone's
    fused-block field, ``fuse_attn_block`` where it has one (the ViT family),
    else ``fuse_ln_mlp`` (ConvNeXt). An error for a backbone without the
    field, as in JAX."""
    import dataclasses

    def enable(cfg, cli_name, field):
        if field is None or not hasattr(cfg, field):
            raise SystemExit(f"{cli_name} unsupported for {args.model}")
        return dataclasses.replace(cfg, **{field: True})

    if getattr(args, "fused_mlp", False):
        cfg = enable(cfg, "--fused_mlp", "use_fused_mlp")
    if getattr(args, "fused_block", False):
        cfg = enable(cfg, "--fused_block", next(
            (f for f in ("fuse_attn_block", "fuse_ln_mlp") if hasattr(cfg, f)), None))
    return cfg


def _load_checkpoint(args, device, *, auto_dtype: str):
    """``--model_path`` -> (entry, cfg, tree, vocab); float leaves in
    ``--param_dtype`` (``auto_dtype`` for "auto"), on ``device``.

    A path ending in ``.safetensors`` is a param tree written by either
    package; any other local checkpoint (an HF model directory,
    ``pytorch_model.bin``, the reference's ``.pth``) goes through
    ``models.pretrained.load_pretrained``, as in the JAX CLI."""
    import torch

    from ..models.pretrained import load_pretrained
    from ..models.registry import get_model
    from ..utils import checkpoint as ckpt
    from ..utils import trees
    from ..utils.vocab import LabelVocabulary

    mapping = os.path.join(os.path.dirname(args.model_path), "class_mappings.txt")
    vocab = (LabelVocabulary.load(mapping) if os.path.exists(mapping)
             else _build_vocab(args))
    if args.model_path.endswith(".safetensors"):
        entry = get_model(args.model)
        cfg = entry.config(len(vocab))
        tree, _ = ckpt.load_pytree(args.model_path)
    else:
        entry, cfg, tree = load_pretrained(args.model, len(vocab), args.model_path)
    cfg = _apply_kernel_flags(args, cfg)
    pdt = auto_dtype if args.param_dtype == "auto" else args.param_dtype
    target = torch.bfloat16 if pdt == "bf16" else torch.float32
    tree = trees.map_leaves(
        lambda t: t.to(device, target) if t.is_floating_point() else t.to(device), tree)
    return entry, cfg, tree, vocab


def _rehead(tree, num_classes: int):
    """The importers' convention for a checkpoint whose class count is not
    ``num_classes``: a new, zero-initialized classifier. That is ``head`` for
    a flat head and ``head/linear`` for a nested one (YOLO11, whose
    ``head/conv`` is kept)."""
    import torch

    from ..utils import trees

    path = "head" if "w" in tree["head"] else "head/linear"
    w = trees.get_path(tree, path)["w"]
    if w.shape[-1] == num_classes:
        return tree
    return trees.set_path(tree, path, {"w": torch.zeros(w.shape[0], num_classes, dtype=w.dtype),
                                       "b": torch.zeros(num_classes, dtype=w.dtype)})


def _eval_loader(meta, vocab, *, root_dir, sources=None, batch_size, image_size, resize=None,
                 shuffle=False, seed=0):
    from ..data.loader import Loader, MetadataIndex

    return Loader(MetadataIndex(meta, vocab, root_dir=root_dir, sources=sources),
                  batch_size=batch_size, image_size=image_size,
                  resize=resize if resize is not None else _eval_resize(image_size),
                  shuffle=shuffle, seed=seed)


def _loaders_for(args, vocab, splits, *, batch_size, image_size, resize=None,
                 shuffle_train=False):
    out = {}
    for split in splits:
        meta = os.path.join(args.data_root, split, "metadata.csv")
        out[split] = (_eval_loader(meta, vocab, root_dir=args.data_root, sources=args.sources,
                                   batch_size=batch_size, image_size=image_size, resize=resize,
                                   shuffle=split == "train" and shuffle_train, seed=args.seed)
                      if os.path.exists(meta) else None)
    return out


# --- subcommands -------------------------------------------------------------

def cmd_synth_data(args):
    from ..data import synthetic

    synthetic.make_synthetic_dataset(
        args.output_dir, n_per_class=args.n_per_class,
        image_size=args.image_size, style=args.style)
    print(f"synthetic dataset written to {args.output_dir}")


def cmd_train(args):
    import torch

    from ..models.pretrained import load_pretrained
    from ..models.registry import get_model
    from ..train import loop
    from ..utils import checkpoint as ckpt
    from ..utils import trees

    device = _device(args)
    vocab = _build_vocab(args)
    gen = torch.Generator().manual_seed(args.seed)
    if args.checkpoint is not None and args.checkpoint.endswith(".safetensors"):
        entry = get_model(args.model)
        cfg = entry.config(len(vocab))
        params, _ = ckpt.load_pytree(args.checkpoint)
        params = _rehead(trees.map_leaves(
            lambda t: t.float() if t.is_floating_point() else t, params), len(vocab))
    else:  # an HF directory, .bin or .pth through the importers; None: random init
        entry, cfg, params = load_pretrained(args.model, len(vocab), args.checkpoint,
                                             generator=gen)
    loaders = _loaders_for(args, vocab, ("train", "val", "test"), batch_size=args.batch_size,
                           image_size=cfg.image_size, resize=args.resize, shuffle_train=True)
    source = "_".join(args.sources) if args.sources else "all"
    out_dir = os.path.join(args.output_dir, args.model, source)
    summary = loop.train_base_model(
        entry, params, loaders["train"], loaders["val"], loaders["test"], vocab,
        out_dir=out_dir, epochs=args.epochs, lr=args.learning_rate,
        weight_decay=args.weight_decay, model_name=args.model, source=source,
        resume=args.resume, resume_save_s=args.resume_save_s, seed=args.seed, cfg=cfg,
        device=device)
    print(json.dumps({k: v for k, v in summary.items() if k != "history"}, indent=2,
                     default=str))


def _attack_model(args):
    """(device, entry, cfg, model, vocab, normalize, source) of the attack
    stages: "auto" = bf16 params on CUDA (the attack path's working dtype),
    f32 on the CPU."""
    from ..attacks.common import Normalizer
    from ..models.registry import get_normalization

    device = _device(args)
    entry, cfg, tree, vocab = _load_checkpoint(
        args, device, auto_dtype="bf16" if device.type == "cuda" else "f32")
    source = "_".join(args.sources) if args.sources else "all"
    return (device, entry, cfg, entry.from_tree(tree, cfg), vocab,
            Normalizer(*get_normalization(args.model)), source)


def _clean_metadata(args, split):
    from ..data.io import filter_metadata, read_metadata

    return filter_metadata(read_metadata(os.path.join(args.data_root, split, "metadata.csv")),
                           args.sources)


def _training_subset(loader, size: int):
    """The first ``size`` real samples of a split as [0,1] floats and labels
    on the host (the reference's ``patch_sample_size``), or (None, None)."""
    import numpy as np

    xs, ys, n = [], [], 0
    for b in loader:
        keep = b.valid > 0
        xs.append(b.images[keep].astype(np.float32) / 255.0)
        ys.append(b.labels[keep])
        n += int(keep.sum())
        if n >= size:
            break
    if not xs or n == 0:
        return None, None
    return np.concatenate(xs)[:size], np.concatenate(ys)[:size]


def cmd_attack(args):
    from ..attacks import generate, whitebox

    device, entry, cfg, model, vocab, normalize, source = _attack_model(args)

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
        clean_meta = _clean_metadata(args, split)
        for name, fn in attacks.items():
            out_dir = generate.attack_output_dir(
                args.output_dir, args.model, source, split, name)
            meta = generate.generate_adversarial_split(
                fn, model, loader, out_dir=out_dir, clean_metadata=clean_meta,
                seed=args.seed, device=device)
            print(f"{name} {split}: {len(meta)} adversarial images -> {out_dir}")


def cmd_autoattack(args):
    from ..attacks import autoattack as aa
    from ..attacks import generate

    device, entry, cfg, model, vocab, normalize, source = _attack_model(args)
    suite = aa.make_autoattack(
        entry.apply, cfg,
        aa.AutoAttackConfig(eps=args.epsilon, n_iter=args.n_iter,
                            square_queries=args.square_queries, attacks=tuple(args.suite)),
        normalize=normalize)
    loaders = _loaders_for(args, vocab, args.splits, batch_size=args.batch_size,
                           image_size=cfg.image_size)
    for split in args.splits:
        loader = loaders[split]
        if loader is None:
            continue
        out_dir = generate.attack_output_dir(args.output_dir, args.model, source, split,
                                             "autoattack")
        meta = generate.generate_adversarial_split(
            suite, model, loader, out_dir=out_dir, clean_metadata=_clean_metadata(args, split),
            seed=args.seed, device=device)
        print(f"autoattack {split}: {len(meta)} images -> {out_dir}")
    # wall-clock attribution per (stage, survivors): the first call and the
    # mean of the others
    rows = []
    for (name, bucket), ts in sorted(suite.stats.items()):
        warm = ts[1:]
        warm_s = f"{sum(warm) / len(warm):8.2f}" if warm else "       —"
        print(f"  {name:8s} bucket={bucket:<4d} calls={len(ts):<4d} "
              f"first={ts[0]:8.2f}s warm_mean={warm_s}s")
        rows.append({"stage": name, "bucket": bucket, "calls": len(ts),
                     "first_s": round(ts[0], 3),
                     "warm_mean_s": round(sum(warm) / len(warm), 3) if warm else None,
                     "total_s": round(sum(ts), 3)})
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump({"model": args.model, "n_iter": args.n_iter,
                       "square_queries": args.square_queries, "suite": list(args.suite),
                       "total_attributed_s": round(sum(r["total_s"] for r in rows), 1),
                       "stages": rows}, f, indent=2)
        print(f"wrote {args.stats_json}")


def cmd_patch_attack(args):
    import torch

    from ..attacks import generate
    from ..attacks import patch as patch_mod

    device, entry, cfg, model, vocab, normalize, source = _attack_model(args)

    def make_pcfg(shape):
        return patch_mod.PatchConfig(
            patch_size=args.patch_size, shape=shape, rotation_max_deg=args.rotation_max,
            scale_min=args.scale_min, scale_max=args.scale_max,
            learning_rate=args.learning_rate, iters=args.max_iter,
            batch_size=args.batch_size, targeted=args.targeted)

    # one trainer and one applier for every patch type: the shape mask is a
    # runtime argument
    base_cfg = make_pcfg(args.patch_type[0])
    train_fn = patch_mod.make_train_patch(entry.apply, cfg, base_cfg, normalize=normalize)
    apply_fn = patch_mod.make_apply_patch(base_cfg)
    loaders = _loaders_for(args, vocab, args.splits, batch_size=args.batch_size,
                           image_size=cfg.image_size)
    # split outer, patch type inner: the training subset depends on the split only
    for split in args.splits:
        loader = loaders[split]
        if loader is None:
            continue
        images, labels = _training_subset(loader, args.patch_sample_size)
        if images is None:
            print(f"skip {split}: no samples after filtering")
            continue
        images = torch.from_numpy(images).to(device)
        labels = torch.from_numpy(labels).to(device)
        clean_meta = _clean_metadata(args, split)
        for patch_type in args.patch_type:
            mask = patch_mod.patch_mask(make_pcfg(patch_type))
            # every patch type trains from the same seed
            patch, losses = train_fn(model, images, labels,
                                     torch.Generator(device).manual_seed(args.seed), mask)
            print(f"{patch_type} {split}: patch trained (final loss {float(losses[-1]):.4f})")

            def attack(p, im, lb, gen, _patch=patch, _mask=mask):
                scale = torch.empty((), device=im.device).uniform_(
                    args.scale_min_apply, args.scale_max_apply, generator=gen)
                return apply_fn(im, _patch, gen, scale, _mask)

            out_dir = generate.attack_output_dir(args.output_dir, args.model, source, split,
                                                 f"patch_{patch_type}")
            meta = generate.generate_adversarial_split(
                attack, model, loader, out_dir=out_dir, clean_metadata=clean_meta,
                seed=args.seed, device=device)
            print(f"patch_{patch_type} {split}: {len(meta)} images")


def cmd_rp2_attack(args):
    import numpy as np
    import torch

    from ..attacks import generate, rp2

    device, entry, cfg, model, vocab, normalize, source = _attack_model(args)
    pcfg = rp2.rp2_config(patch_size=args.patch_size, image_size=cfg.image_size,
                          iters=args.max_iter, learning_rate=args.learning_rate,
                          batch_size=args.batch_size)
    loaders = _loaders_for(args, vocab, args.splits, batch_size=args.batch_size,
                           image_size=cfg.image_size)

    def train_patches(split, loader):
        """(classes, P, P, 3) patches trained on ``split`` (mid-gray for a
        class without enough samples), or None."""
        images, labels = _training_subset(loader, args.patch_sample_size)
        if images is None:
            print(f"rp2 {split}: no samples after filtering")
            return None
        patches = rp2.train_rp2_patches(entry.apply, cfg, model, images, labels, cfg=pcfg,
                                        normalize=normalize, seed=args.seed, device=device)
        rp2.save_class_patches(
            patches, os.path.join(args.output_dir, args.model, source, split, "rp2", "patches"),
            cfg=pcfg, class_names=dict(enumerate(vocab.classes)))
        if not patches:
            print(f"rp2 {split}: no class had enough samples")
            return None
        return torch.from_numpy(np.stack([
            patches.get(c, np.full((pcfg.patch_size, pcfg.patch_size, 3), 0.5, np.float32))
            for c in range(len(vocab))])).to(device)

    # --patch_train_split: one sticker per class, trained on that split and
    # applied to every split (the reference retrains per split)
    shared = None
    if args.patch_train_split:
        tl = loaders.get(args.patch_train_split) or _loaders_for(
            args, vocab, (args.patch_train_split,), batch_size=args.batch_size,
            image_size=cfg.image_size)[args.patch_train_split]
        if tl is None:
            print(f"rp2 {args.patch_train_split}: no samples after filtering")
            return
        shared = train_patches(args.patch_train_split, tl)
        if shared is None:
            return
    apply_fn = rp2.make_sign_constrained_apply(pcfg)
    for split in args.splits:
        loader = loaders[split]
        if loader is None:
            continue
        patch_arr = shared if shared is not None else train_patches(split, loader)
        if patch_arr is None:
            continue

        def attack(p, im, lb, gen, _pa=patch_arr):
            # each example gets its own class's patch (a physical per-sign sticker)
            return apply_fn(im, _pa[lb.long()], gen, pcfg.scale_max)

        out_dir = generate.attack_output_dir(args.output_dir, args.model, source, split, "rp2")
        meta = generate.generate_adversarial_split(
            attack, model, loader, out_dir=out_dir, clean_metadata=_clean_metadata(args, split),
            seed=args.seed, device=device)
        print(f"rp2 {split}: {len(meta)} images -> {out_dir}")


def cmd_train_lora(args):
    from ..ops import lora
    from ..train import loop

    device = _device(args)
    # "auto": f32 params for the optimizer; the compute dtype stays the model config's
    entry, cfg, tree, vocab = _load_checkpoint(args, device, auto_dtype="f32")
    source = "_".join(args.sources) if args.sources else "all"
    loader_args = dict(batch_size=args.batch_size, image_size=cfg.image_size)

    all_results, failed = {}, []
    for attack in args.attacks:
        adv_dir = os.path.join(args.adv_root, args.model, source, "train", attack)
        meta = os.path.join(adv_dir, "metadata.csv")
        if not os.path.exists(meta):
            print(f"skip {attack}: {meta} missing")
            continue
        train_loader = _eval_loader(meta, vocab, root_dir=adv_dir, shuffle=True, seed=args.seed,
                                    **loader_args)
        val_dir = os.path.join(args.adv_root, args.model, source, "val", attack)
        val_meta = os.path.join(val_dir, "metadata.csv")
        if os.path.exists(val_meta):
            val_loader = _eval_loader(val_meta, vocab, root_dir=val_dir, **loader_args)
        else:
            print(f"{attack}: no val split: best adapter = final epoch")
            val_loader = None

        for rank in args.ranks:
            # one broken (attack, rank) pair must not end the sweep, but the
            # stage must not report success either: the exit code is 1
            try:
                lcfg = lora.LoRAConfig(rank=rank, alpha=args.lora_alpha,
                                       targets=entry.lora_targets(cfg),
                                       dropout=args.lora_dropout,
                                       dropout_mode=args.lora_dropout_mode)
                out_dir = os.path.join(args.output_dir, args.model, source, attack)
                res = loop.train_lora_adapter(
                    entry, tree, lcfg, train_loader, val_loader, vocab, out_dir=out_dir,
                    epochs=args.epochs, lr=args.learning_rate, model_name=args.model, cfg=cfg,
                    seed=args.seed, device=device)
            except Exception as e:  # noqa: BLE001
                import traceback

                traceback.print_exc()
                all_results.setdefault(attack, {})[f"rank{rank}"] = {"error": str(e)}
                failed.append(f"{attack} rank{rank}")
                continue
            res.pop("best_trainable", None)
            all_results.setdefault(attack, {})[f"rank{rank}"] = {
                k: v for k, v in res.items() if k != "history"}
            bva = res["best_val_accuracy"]
            print(f"{attack} rank{rank}: best val acc "
                  + (f"{bva:.4f}" if bva is not None else "n/a (no val split)"))
        results_path = os.path.join(args.output_dir, args.model, source, attack, "results.json")
        os.makedirs(os.path.dirname(results_path), exist_ok=True)
        with open(results_path, "w") as f:
            json.dump(all_results[attack], f, indent=2, default=str)

    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "global_results.json"), "w") as f:
        json.dump(all_results, f, indent=2, default=str)
    if failed:
        print(f"train-lora: failed for {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


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
    sp.add_argument("--model_path", required=True,
                    help="base checkpoint: a .safetensors param tree written by either package, "
                         "or a local pretrained checkpoint (an HF model directory, "
                         "pytorch_model.bin, the reference's .pth; HF, timm or ultralytics "
                         "naming)")
    sp.add_argument("--batch_size", type=int, default=32)
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--param_dtype", default="auto", choices=("auto", "f32", "bf16"),
                    help=f"model parameter dtype. {auto_help}")
    sp.add_argument("--fused_mlp", action="store_true",
                    help="ViT family and Swin: each block's MLP through the hand-written fused MLP "
                         "kernel (CUDA + bf16 compute; its plain version on the CPU). Off by "
                         "default")
    sp.add_argument("--fused_block", action="store_true",
                    help="ViT family: each block's attention half (LayerNorm, q/k/v, attention, "
                         "o-projection) and MLP half (LayerNorm + MLP) through the hand-written "
                         "fused kernels; ConvNeXt: each block's LayerNorm + pointwise MLP through "
                         "the LN-fused MLP kernel (CUDA + bf16 compute; the plain versions on "
                         "the CPU). Off by default")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="apvt-lora-torch",
        description="PyTorch/CUDA LoRA-robustness pipeline for vision transformers")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; an error without a CUDA device), 'cuda:N' or "
                        "'cpu'. Must precede the subcommand.")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("synth-data", help="generate a synthetic dataset")
    sp.add_argument("--output_dir", required=True)
    sp.add_argument("--n_per_class", type=int, default=8)
    sp.add_argument("--image_size", type=int, default=64)
    sp.add_argument("--style", default="default", choices=["default", "hard"],
                    help="'hard' = 12 glyph-coded confusable classes "
                         "(non-robust fine features, for robustness runs)")
    sp.set_defaults(fn=cmd_synth_data)

    sp = sub.add_parser("train", help="base fine-tune")
    _common_data_args(sp)
    sp.add_argument("--model", default="google_vit")
    sp.add_argument("--batch_size", type=int, default=32)
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--checkpoint", default=None,
                    help="weights to start from: a .safetensors param tree written by either "
                         "package, or a local pretrained checkpoint (an HF model directory, "
                         "pytorch_model.bin, the reference's .pth; HF, timm or ultralytics "
                         "naming). A .safetensors tree's classifier of another class count is "
                         "replaced by a zero-initialized one (default: random init from --seed)")
    sp.add_argument("--output_dir", default="./train_out")
    sp.add_argument("--epochs", type=int, default=1)
    sp.add_argument("--learning_rate", type=float, default=1e-4)
    sp.add_argument("--weight_decay", type=float, default=1e-4)
    sp.add_argument("--resize", type=int, default=None,
                    help="pre-crop shorter-side resize (default: scales the "
                         "reference's 256/224 ratio to the model input size)")
    sp.add_argument("--resume", action="store_true",
                    help="continue from {out}/resume.* if present")
    sp.add_argument("--resume_save_s", type=float, default=600.0,
                    help="write resume state at most this often (seconds; 0 = every epoch)")
    sp.set_defaults(fn=cmd_train)

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

    sp = sub.add_parser("autoattack", help="AutoAttack standard suite")
    _model_args(sp, "auto = bf16 on CUDA, f32 on CPU")
    sp.add_argument("--output_dir", default="./adv")
    sp.add_argument("--splits", nargs="+", default=["test"])
    sp.add_argument("--epsilon", type=float, default=0.031)
    sp.add_argument("--n_iter", type=int, default=100)
    sp.add_argument("--square_queries", type=int, default=5000)
    sp.add_argument("--suite", nargs="+", default=["apgd-ce", "apgd-t", "fab-t", "square"])
    sp.add_argument("--stats_json", default=None,
                    help="write the per-(stage, bucket) wall attribution as JSON (bucket = "
                         "the stage's survivor count)")
    sp.set_defaults(fn=cmd_autoattack)

    sp = sub.add_parser("patch-attack", help="EOT adversarial patch")
    _model_args(sp, "auto = bf16 on CUDA, f32 on CPU")
    sp.add_argument("--output_dir", default="./adv")
    sp.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    sp.add_argument("--patch_type", nargs="+", default=["circle", "square"],
                    choices=["circle", "square"])
    sp.add_argument("--patch_size", type=int, default=24)
    sp.add_argument("--patch_sample_size", type=int, default=500)
    sp.add_argument("--scale_min", type=float, default=0.05)
    sp.add_argument("--scale_max", type=float, default=1.0)
    sp.add_argument("--rotation_max", type=float, default=22.5)
    sp.add_argument("--learning_rate", type=float, default=5.0)
    sp.add_argument("--max_iter", type=int, default=500)
    sp.add_argument("--targeted", action="store_true")
    sp.add_argument("--scale_min_apply", type=float, default=0.1)
    sp.add_argument("--scale_max_apply", type=float, default=0.5)
    sp.set_defaults(fn=cmd_patch_attack)

    sp = sub.add_parser("rp2-attack", help="per-class physical perturbation")
    _model_args(sp, "auto = bf16 on CUDA, f32 on CPU")
    sp.add_argument("--output_dir", default="./adv")
    sp.add_argument("--splits", nargs="+", default=["test"])
    sp.add_argument("--patch_size", type=int, default=32)
    sp.add_argument("--patch_sample_size", type=int, default=500)
    sp.add_argument("--learning_rate", type=float, default=0.1)
    sp.add_argument("--max_iter", type=int, default=500)
    sp.add_argument("--patch_train_split", default="",
                    help="train per-class patches ONCE on this split and apply them to every "
                         "--splits entry (physical-sticker semantics); empty = per-split "
                         "retraining like the reference")
    sp.set_defaults(fn=cmd_rp2_attack)

    sp = sub.add_parser("train-lora", help="per-attack LoRA defense")
    _model_args(sp, "auto = f32 on every device (the compute dtype stays the "
                    "model config's)")
    sp.add_argument("--adv_root", default="./adv")
    sp.add_argument("--output_dir", default="./loras")
    sp.add_argument("--attacks", nargs="+", default=["fgsm", "pgd"])
    sp.add_argument("--ranks", nargs="+", type=int, default=[8, 16, 32])
    sp.add_argument("--lora_alpha", type=float, default=16.0)
    sp.add_argument("--lora_dropout", type=float, default=0.1)
    sp.add_argument("--lora_dropout_mode", default="input", choices=["input", "post_a"],
                    help="'input' = PEFT-exact mask placement; 'post_a' = mask the rank-r "
                         "projection instead (ops/nn.dense)")
    sp.add_argument("--epochs", type=int, default=4)
    sp.add_argument("--learning_rate", type=float, default=1e-4)
    sp.set_defaults(fn=cmd_train_lora)

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
    _device(args)  # every stage: no CUDA device and no --device cpu is an error
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
