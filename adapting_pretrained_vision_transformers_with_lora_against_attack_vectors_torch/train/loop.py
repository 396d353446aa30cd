"""Epoch-level trainers: base fine-tune and per-attack LoRA defense.

Counterpart of the JAX package's ``train/loop.py``, around the steps of
:mod:`.steps`:

* :func:`evaluate`: batches go to the device as uint8, the loss sum and the
  confusion matrix add up there, and the totals cross to the host once;
* :func:`fit`: the shared epoch engine. Batches cross to the device as uint8
  and are normalized there; metrics add up on the device and cross to the
  host once per epoch; the final partial batch is padded and masked;
* :func:`train_base_model`: AdamW + StepLR, best-on-val-accuracy
  checkpointing, resume, test metrics and result files;
* :func:`train_lora_adapter`: the base frozen, the adapter factors (and, like
  PEFT ``SEQ_CLS``, a copy of the head) the only trainable tensors, best and
  final adapter in PEFT format.

The module is built **once** per run and its parameters are trained in
place: a module rebuilt from a tree would hold fresh leaves the optimizer
does not know. What a trainer keeps (the best parameters) it therefore reads
out of the module as real copies (``entry.to_tree``).

Every function takes ``mesh=None`` with the JAX package's meaning: pass a
``parallel.mesh`` mesh (every rank calls the function) and each batch is
split over its data axis; the trainers build the module on the mesh
(``from_tree(..., mesh=)``: model-axis slices by the rules). Rank 0 alone
logs, writes the metrics and writes checkpoints and adapter directories;
the snapshots are full trees (gathered), the same on every rank.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Optional

import torch

from ..attacks.common import Normalizer
from ..models.registry import ModelEntry, get_normalization
from ..ops import lora
from ..parallel import mesh as pmesh
from ..utils import checkpoint, trees
from ..utils.vocab import LabelVocabulary
from . import optim
from .metrics import confusion_matrix_metrics
from .steps import TrainState, make_eval_step, make_train_step


@dataclasses.dataclass
class FitResult:
    state: TrainState
    best_params: Any
    best_val_accuracy: Optional[float]
    best_epoch: int
    history: list[dict]
    eval_step: Callable


def _device_batch(batch, device, mesh=None):
    """This rank's rows of a uint8 batch, on ``device``."""
    arrays = pmesh.shard_batch(mesh, batch.images, batch.labels, batch.valid)
    return tuple(torch.as_tensor(a).to(device) for a in arrays)


def _check_mesh(model, mesh) -> None:
    if pmesh.mesh_of(model) is not mesh:
        raise ValueError("the model was built on another mesh than the one given "
                         "(entry.from_tree(..., mesh=mesh))")


def evaluate(eval_step, params, loader, *, device, mesh=None) -> dict:
    """Run ``eval_step`` over a loader of ``Batch``es on ``device``; returns
    accuracy, weighted F1, mean loss and support (of the global batch under
    ``mesh``, on which ``params`` must be built)."""
    device = torch.device(device)
    _check_mesh(params, mesh)
    loss_sum = conf_sum = None
    for batch in loader:
        images, labels, valid = _device_batch(batch, device, mesh)
        loss, conf = eval_step(params, images, labels, valid)
        loss_sum = loss if loss_sum is None else loss_sum + loss
        conf_sum = conf if conf_sum is None else conf_sum + conf
    if conf_sum is None:
        return {"accuracy": 0.0, "f1": 0.0, "loss": 0.0, "support": 0.0}
    m = confusion_matrix_metrics(conf_sum.cpu().numpy())
    m["loss"] = float(loss_sum.cpu()) / max(m["support"], 1.0)
    return m


def fit(
    forward: Callable[[Any, torch.Tensor], torch.Tensor],
    model: torch.nn.Module,
    state: TrainState,
    train_loader,
    val_loader,
    *,
    epochs: int,
    num_classes: int,
    normalize: Optional[Normalizer],
    snapshot: Callable[[], Any],
    device,
    mesh=None,
    on_epoch_end: Optional[Callable[[int, dict, TrainState, tuple], None]] = None,
    log: Callable[[str], None] = print,
    metrics=None,
    generator: Optional[torch.Generator] = None,
    augment=None,
    start_epoch: int = 0,
    init_best: Optional[tuple] = None,
) -> FitResult:
    """Shared epoch engine: train ``epochs`` epochs, track best-on-val params.

    ``forward(model, normalized_images) -> logits``; ``state`` names what is
    trained (``TrainState.create``). ``snapshot()`` returns a real copy of
    what the caller wants kept as "the parameters" (the step updates the
    module in place, so a reference would follow it). ``metrics``: optional
    ``utils.observability.MetricsLogger``; each epoch record is appended as a
    JSONL event. ``device``: where the batches go; it has no default, so
    that no caller trains on the CPU without saying so. ``generator`` /
    ``augment``: see ``make_train_step``.
    ``start_epoch`` / ``init_best``: resume a run mid-way, carrying the best
    so far so that a worse later epoch cannot overwrite it. The module is in
    training mode inside the train loop (LoRA dropout) and in eval mode for
    validation and on return. ``mesh``: the one ``model`` is built on; every
    rank calls ``fit``, ``on_epoch_end`` and ``snapshot`` run on every rank,
    ``log`` and ``metrics`` on rank 0 only."""
    device = torch.device(device)
    _check_mesh(model, mesh)
    main = pmesh.is_main(mesh)
    train_step = make_train_step(forward, model, normalize=normalize, generator=generator,
                                 augment=augment)
    eval_step = make_eval_step(forward, num_classes, normalize=normalize)
    if init_best is not None:
        best_params, best_acc, best_epoch = init_best
    else:
        best_params, best_acc, best_epoch = None, -1.0, -1
    history: list[dict] = []

    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        loss_sum = correct = count = None
        model.train()
        for batch in train_loader:
            images, labels, valid = _device_batch(batch, device, mesh)
            state, m = train_step(state, images, labels, valid)
            if loss_sum is None:
                loss_sum, correct, count = m["loss_sum"], m["correct"], m["count"]
            else:
                loss_sum, correct, count = (loss_sum + m["loss_sum"], correct + m["correct"],
                                            count + m["count"])
        model.eval()
        n = float(count.cpu()) if count is not None else 0.0
        seconds = time.time() - t0
        rec = {
            "epoch": epoch,
            "train_loss": float(loss_sum.cpu()) / max(n, 1.0) if n else 0.0,
            "train_accuracy": float(correct.cpu()) / max(n, 1.0) if n else 0.0,
            "seconds": seconds,
            "images_per_second": n / seconds if seconds > 0 else 0.0,
        }
        if val_loader is not None:
            val = evaluate(eval_step, model, val_loader, device=device, mesh=mesh)
            rec.update({f"val_{k}": v for k, v in val.items()})
            if val["accuracy"] > best_acc:
                best_acc, best_epoch = val["accuracy"], epoch
                best_params = snapshot()
        history.append(rec)
        if main:
            log(f"epoch {epoch}: loss {rec['train_loss']:.4f} "
                f"acc {rec['train_accuracy']:.4f}"
                + (f" val_acc {rec.get('val_accuracy', 0):.4f}" if val_loader else "")
                + f" ({rec['seconds']:.1f}s)")
        if metrics is not None and main:
            metrics.log("epoch", step=epoch, **{k: v for k, v in rec.items() if k != "epoch"})
        if on_epoch_end is not None:
            on_epoch_end(epoch, rec, state, (best_params, best_acc, best_epoch))

    model.eval()
    if best_epoch < 0:  # no val loader: final params are "best"
        best_params, best_acc, best_epoch = snapshot(), None, epochs - 1
    return FitResult(state, best_params, best_acc, best_epoch, history, eval_step)


def train_base_model(
    entry: ModelEntry,
    params,
    train_loader,
    val_loader,
    test_loader,
    vocab: LabelVocabulary,
    *,
    out_dir: str,
    device,
    epochs: int = 1,
    lr: float = 1e-4,
    weight_decay: float = 1e-4,
    steplr_epochs: int = 20,
    steplr_gamma: float = 0.1,
    model_name: Optional[str] = None,
    source: str = "all",
    resume: bool = False,
    resume_save_s: float = 600.0,
    augment: bool = True,
    seed: int = 0,
    mesh=None,
    cfg=None,
    log: Callable[[str], None] = print,
) -> dict:
    """Full fine-tune of ``params`` (a JAX-layout tree) on ``device``, which
    the caller must name (``"cuda"`` for the card; ``"cpu"`` only on purpose).
    ``mesh``: see the module docstring (the files are rank 0's, and are the
    files a single-process run writes).

    Files under ``out_dir``: ``class_mappings.txt``, best and final model
    checkpoints (safetensors, readable by either package), ``metrics.jsonl``
    and ``training_results.csv``; the summary is returned.

    ``resume=True`` continues from ``{out_dir}/resume.*`` (parameters,
    optimizer moments, update count), written atomically. Resume state is
    written on the first epoch completed after (re)start, on the final epoch,
    and otherwise at most every ``resume_save_s`` seconds (0 = every epoch):
    a host that kills the process faster than the interval still makes one
    epoch of progress per attempt. ``augment=True`` applies the train-time
    augmentation (rotation / resized crop / flip / color jitter) on the
    device, with draws from ``seed``."""
    from ..data.augment import train_augment
    from ..utils.observability import MetricsLogger

    if train_loader is None:
        raise ValueError("no train split found (train/metadata.csv missing "
                         "or empty after source filtering)")
    device = torch.device(device)
    model_name = model_name or entry.name
    cfg = cfg if cfg is not None else entry.config(len(vocab))
    normalize = Normalizer(*get_normalization(model_name))
    forward = lambda m, x: entry.apply(cfg, m, x)
    # leaves of its own: the step trains in place and must not write into the caller's tree
    model = entry.from_tree(
        trees.map_leaves(lambda t: torch.as_tensor(t).to(device, copy=True), params), cfg,
        mesh=mesh)
    steps_per_epoch = max(len(train_loader), 1)
    state = TrainState.create(model, None, lambda ps: optim.adamw_steplr(
        ps, lr, weight_decay=weight_decay, step_size_epochs=steplr_epochs, gamma=steplr_gamma,
        steps_per_epoch=steps_per_epoch))
    generator = torch.Generator(device).manual_seed(seed * 1000 + 17) if augment else None

    main = pmesh.is_main(mesh)
    os.makedirs(out_dir, exist_ok=True)
    if main:
        vocab.save(os.path.join(out_dir, "class_mappings.txt"))

    resume_prefix = os.path.join(out_dir, "resume")
    start_epoch, init_best = 0, None
    if resume and checkpoint.train_state_exists(resume_prefix):
        meta = checkpoint.load_train_state(resume_prefix, state)
        start_epoch = int(meta.get("epoch", -1)) + 1
        best_path = resume_prefix + ".best.safetensors"
        if os.path.exists(best_path):
            b_params, b_meta = checkpoint.load_pytree(best_path)
            init_best = (trees.flatten_with_paths(b_params),
                         float(b_meta.get("val_accuracy", -1.0)), int(b_meta.get("epoch", -1)))
        if main:
            log(f"resuming from epoch {start_epoch} (step {state.step})")

    with MetricsLogger(os.path.join(out_dir, "metrics.jsonl") if main else None) as metrics:
        metrics.log("train_start", model=model_name, source=source,
                    epochs=epochs, lr=lr, start_epoch=start_epoch)
        # t = -inf: the first epoch completed after (re)start always saves
        last_save = {"t": float("-inf"), "best_epoch": init_best[2] if init_best else -1}

        def save_resume(epoch, rec, st, best):
            best_params, best_acc, best_epoch = best
            if epoch != epochs - 1 and time.time() - last_save["t"] < resume_save_s:
                return
            checkpoint.save_train_state(st, resume_prefix, meta={"epoch": epoch})
            if best_epoch > last_save["best_epoch"] and main:
                checkpoint.save_pytree(best_params, resume_prefix + ".best.safetensors",
                                       meta={"epoch": best_epoch, "val_accuracy": best_acc})
                last_save["best_epoch"] = best_epoch
            last_save["t"] = time.time()

        result = fit(forward, model, state, train_loader, val_loader, epochs=epochs,
                     num_classes=len(vocab), normalize=normalize, device=device, mesh=mesh,
                     log=log, metrics=metrics, generator=generator,
                     augment=train_augment if augment else None,
                     snapshot=lambda: entry.to_tree(model), start_epoch=start_epoch,
                     init_best=init_best, on_epoch_end=save_resume)

    best_path = os.path.join(out_dir, f"{model_name}_best_model_finetuned.safetensors")
    final_tree = entry.to_tree(model)  # a collective under a model axis: every rank
    if main:
        checkpoint.save_pytree(result.best_params, best_path,
                               meta={"model": model_name, "source": source,
                                     "classes": list(vocab.classes),
                                     "best_epoch": result.best_epoch,
                                     "best_val_accuracy": result.best_val_accuracy})
        checkpoint.save_pytree(final_tree,
                               os.path.join(out_dir, f"{model_name}_final_model.safetensors"))

    summary = {
        "model": model_name, "source": source, "epochs": epochs,
        "best_epoch": result.best_epoch,
        "best_val_accuracy": result.best_val_accuracy,
        "history": result.history,
        "checkpoint": best_path,
    }
    if test_loader is not None:
        best_model = entry.from_tree(trees.map_leaves(
            lambda t: torch.as_tensor(t).to(device), result.best_params), cfg, mesh=mesh)
        test = evaluate(result.eval_step, best_model, test_loader, device=device, mesh=mesh)
        summary["test_accuracy"] = test["accuracy"]
        summary["test_f1"] = test["f1"]
        if main:
            log(f"test: acc {test['accuracy']:.4f} f1 {test['f1']:.4f}")

    if main:
        _write_results_csv(os.path.join(out_dir, "training_results.csv"), summary,
                           append=start_epoch > 0)
    return summary


def read_adapter(flat: dict, lora_cfg: lora.LoRAConfig, *, head: bool) -> dict:
    """``{"adapter": {path: {"a", "b"}}[, "head": {...}]}`` out of a flat
    JAX-layout tree that carries the attached factors (``entry.to_tree`` of a
    module built from ``ops.lora.attach``)."""
    out = {"adapter": {path: {"a": flat[f"{path}/lora_a"], "b": flat[f"{path}/lora_b"]}
                       for path in lora_cfg.targets}}
    if head:
        out["head"] = trees.unflatten_from_paths(
            {p[len("head/"):]: v for p, v in flat.items() if p.startswith("head/")})
    return out


def lora_trainer(entry: ModelEntry, cfg, base_params, lora_cfg: lora.LoRAConfig, *, lr: float,
                 train_head: bool, seed: int, device, mesh=None):
    """What :func:`train_lora_adapter` trains: ``(model, state, snapshot)``.

    ``model`` is built once from the base tree with a fresh adapter attached
    in its training form (on ``device``, with leaves of its own: training
    never writes into the caller's tree); ``state`` names the adapter factors
    and, with ``train_head``, the head, every other parameter frozen;
    ``snapshot()`` reads the adapter (and head) back out as real copies
    (whole, under ``mesh``: every rank draws the whole adapter from ``seed``
    and the module keeps its slices)."""
    base_d = trees.map_leaves(lambda t: torch.as_tensor(t).to(device), base_params)
    adapter = lora.init(torch.Generator(device).manual_seed(seed), base_d, lora_cfg)
    attached = lora.attach(base_d, adapter, lora_cfg, dropout_seed=seed)
    model = entry.from_tree(trees.map_leaves(lambda t: t.clone(), attached), cfg, mesh=mesh)
    names = [n for n, _ in model.named_parameters()
             if n.rsplit(".", 1)[-1] in ("lora_a", "lora_b")
             or (train_head and n.split(".", 1)[0] == "head")]
    state = TrainState.create(model, names, lambda ps: optim.lora_adam(ps, lr))
    return model, state, lambda: read_adapter(entry.to_tree(model), lora_cfg, head=train_head)


def train_lora_adapter(
    entry: ModelEntry,
    base_params,
    lora_cfg: lora.LoRAConfig,
    train_loader,
    val_loader,
    vocab: LabelVocabulary,
    *,
    out_dir: str,
    device,
    epochs: int = 4,
    lr: float = 1e-4,
    train_head: bool = True,
    seed: int = 0,
    mesh=None,
    model_name: Optional[str] = None,
    cfg=None,
    log: Callable[[str], None] = print,
) -> dict:
    """Per-attack LoRA defense training on ``device``, which the caller must
    name (``"cuda"`` for the card; ``"cpu"`` only on purpose). ``mesh``: see
    the module docstring (rank 0 writes the adapter directories).

    The trainable tensors are the adapter factors (plus, like PEFT
    ``SEQ_CLS``, the classifier head when ``train_head``: the module holds
    its own copy, the caller's ``base_params`` stay as they are); every other
    parameter is frozen, so no kernel recomputes a parameter gradient for it.
    LoRA dropout (``lora_cfg.dropout``, streams from ``seed``) acts in
    training mode only. Saves ``rank{r}_best_adapter/`` and
    ``rank{r}_final_adapter/`` in PEFT format."""
    from ..ops import peft_io

    device = torch.device(device)
    model_name = model_name or entry.name
    cfg = cfg if cfg is not None else entry.config(len(vocab))
    normalize = Normalizer(*get_normalization(model_name))
    model, state, snapshot = lora_trainer(entry, cfg, base_params, lora_cfg, lr=lr,
                                          train_head=train_head, seed=seed, device=device,
                                          mesh=mesh)

    result = fit(lambda m, x: entry.apply(cfg, m, x), model, state, train_loader, val_loader,
                 epochs=epochs, num_classes=len(vocab), normalize=normalize, device=device,
                 mesh=mesh, log=log, snapshot=snapshot)

    r = lora_cfg.rank
    final = snapshot()
    for tag, tree in (("best", result.best_params), ("final", final)):
        if pmesh.is_main(mesh):
            peft_io.save_peft_adapter(tree["adapter"], lora_cfg,
                                      os.path.join(out_dir, f"rank{r}_{tag}_adapter"),
                                      head=tree.get("head"))
    return {
        "model": model_name, "rank": r,
        "best_epoch": result.best_epoch,
        "best_val_accuracy": result.best_val_accuracy,
        "history": result.history,
        "adapter_dir": os.path.join(out_dir, f"rank{r}_best_adapter"),
        "best_trainable": result.best_params,
    }


def _write_results_csv(path: str, summary: dict, *, append: bool = False) -> None:
    import csv

    rows = summary.get("history", [])
    if not rows:
        return
    keys = sorted({k for r in rows for k in r})
    # resumed runs append so that the epochs before the restart stay in the file
    mode = "a" if append and os.path.exists(path) else "w"
    with open(path, mode, newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        if mode == "w":
            w.writeheader()
        for r in rows:
            w.writerow(r)
