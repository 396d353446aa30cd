"""LoRA composability evaluation: the study's accuracy matrix.

Counterpart of the JAX package's ``eval/compose.py``: the base model, each
per-attack adapter and every 2-way, 3-way and all-way combination, merged,
evaluated on the clean test set and on every attack's adversarial test set;
the results go to a JSON file and an aligned summary table.

* Merging N adapters is one sum of deltas ``W + Σ s_i A_i B_i``
  (``ops.lora.merge_many``); the last merged adapter's classifier head wins,
  as PEFT's sequential ``merge_and_unload`` does.
* :func:`make_device_variants` puts the base tree and every adapter
  on the device once; each variant is merged there, in the params' dtype
  (f32 for this stage), and wrapped in the backbone's module. Nothing is
  compiled.
* ``test_mode`` selects ``all`` / ``base_only`` / ``individual_only`` /
  ``combinations_only``, as the reference CLI does.
* ``mesh=`` (``parallel.mesh``, every rank calling): each variant is merged
  whole, then built on the mesh (this rank's slices by the rules), as the
  JAX package merges and then places by the mesh; batches split over the
  data axis; rank 0 logs and writes the JSON.
"""

from __future__ import annotations

import glob
import itertools
import json
import os
from typing import Callable, Mapping, Optional, Sequence

import torch

from ..attacks.common import Normalizer
from ..data.loader import CachedLoader, Loader
from ..models.registry import ModelEntry, get_normalization
from ..ops import lora, peft_io
from ..parallel import mesh as pmesh
from ..train.loop import evaluate
from ..train.steps import make_eval_step
from ..utils import trees


def enumerate_variants(attacks: Sequence[str], *, test_mode: str = "all"
                       ) -> list[tuple[str, tuple[str, ...]]]:
    """(variant_name, adapters-to-merge) pairs in the reference order: base,
    each individual, all C(n,2), C(n,3), then the full set."""
    variants: list[tuple[str, tuple[str, ...]]] = []
    if test_mode in ("all", "base_only"):
        variants.append(("base", ()))
    if test_mode in ("all", "individual_only"):
        variants.extend((f"lora_{a}", (a,)) for a in attacks)
    if test_mode in ("all", "combinations_only"):
        for k in (2, 3):
            if len(attacks) > k:
                variants.extend(("+".join(c), c) for c in itertools.combinations(attacks, k))
        if len(attacks) >= 2:
            variants.append(("+".join(attacks), tuple(attacks)))
    seen, out = set(), []
    for name, combo in variants:  # the full set may equal a C(k) combination
        if name not in seen:
            seen.add(name)
            out.append((name, combo))
    return out


def build_variant_params(base_params, combo: Sequence[str], adapters: Mapping[str, tuple]):
    """Merge the named adapters into the base tree. ``adapters[name]`` is
    ``(adapter, LoRAConfig, head-or-None)``; the last merged head wins."""
    params = lora.merge_many(base_params, [adapters[a][0] for a in combo],
                             [adapters[a][1] for a in combo])
    for a in reversed(combo):
        head = adapters[a][2]
        if head is not None:
            params = dict(params)
            params["head"] = head
            break
    return params


def find_lora_adapters(lora_root: str, attacks: Sequence[str], rank: int, *,
                       tag: str = "best", model: Optional[str] = None,
                       source: Optional[str] = None,
                       log: Callable[[str], None] = print) -> dict[str, tuple]:
    """Discover and load per-attack adapter directories.

    Takes the flat layout (``{lora_root}/{attack}/rank{r}_{tag}_adapter``)
    and the reference's nested one (``{lora_root}/{model}/{source}/{attack}/
    ...``, pinned to ``model``/``source`` when given, globbed otherwise).
    Found and missing adapters are logged."""
    found = {}
    suffix = f"rank{rank}_{tag}_adapter"
    for attack in attacks:
        candidates = [os.path.join(lora_root, attack, suffix)]
        candidates.extend(sorted(glob.glob(os.path.join(
            lora_root, model or "*", source or "*", attack, suffix))))
        hit = next((d for d in candidates if os.path.isdir(d)), None)
        if hit is None:
            log(f"find_lora_adapters: no {attack!r} adapter ({suffix}) under {lora_root}")
            continue
        log(f"find_lora_adapters: {attack} <- {hit}")
        found[attack] = peft_io.load_peft_adapter(hit)
    return found


def make_device_variants(entry: ModelEntry, cfg, base_params,
                         adapters: Mapping[str, tuple], device, mesh=None):
    """``combo -> model``: base and adapters resident on ``device`` once,
    each variant merged there (whole) and wrapped by ``entry.from_tree``
    (on ``mesh``)."""
    def put(tree):
        return trees.map_leaves(lambda t: torch.as_tensor(t).to(device), tree)

    base_d = put(base_params)
    # adapter keys are '/'-joined paths themselves: map the factors per key
    ads_d = {name: ({path: put(fac) for path, fac in ad.items()}, lcfg,
                    None if head is None else put(head))
             for name, (ad, lcfg, head) in adapters.items()}

    def variant(combo: Sequence[str]):
        return entry.from_tree(build_variant_params(base_d, combo, ads_d), cfg, mesh=mesh)

    return variant


def run_composability_eval(
    entry: ModelEntry,
    base_params,
    adapters: Mapping[str, tuple],
    dataloaders: Mapping[str, object],
    num_classes: int,
    *,
    device,
    test_mode: str = "all",
    normalize: Optional[Normalizer] = None,
    out_path: Optional[str] = None,
    mesh=None,
    cfg=None,
    log: Callable[[str], None] = print,
) -> dict:
    """The full matrix: every variant × every dataset, on ``device``, which
    the caller must name (``"cuda"`` for the card; ``"cpu"`` only on purpose).

    ``base_params``: the backbone's JAX-layout tree; ``dataloaders``:
    ``{"clean": loader, "<attack>": loader, ...}`` yielding ``Batch``es.
    Returns ``{variant: {dataset: {accuracy, f1, loss, support}}}`` and
    optionally writes it as JSON (the reference's ``test_results.json``)."""
    cfg = cfg if cfg is not None else entry.config(num_classes)
    device = torch.device(device)
    normalize = normalize or Normalizer(*get_normalization(entry.name))
    eval_step = make_eval_step(lambda m, x: entry.apply(cfg, m, x), num_classes,
                               normalize=normalize)
    # each dataset is read once per variant: decode it once and replay it
    dataloaders = {k: CachedLoader(v) if isinstance(v, Loader) else v
                   for k, v in dataloaders.items()}
    variant = make_device_variants(entry, cfg, base_params, adapters, device, mesh)
    main = pmesh.is_main(mesh)

    results: dict[str, dict] = {}
    for name, combo in enumerate_variants(tuple(adapters), test_mode=test_mode):
        model = variant(combo)
        results[name] = {}
        for ds_name, loader in dataloaders.items():
            m = evaluate(eval_step, model, loader, device=device, mesh=mesh)
            results[name][ds_name] = {k: m[k] for k in ("accuracy", "f1", "loss", "support")}
        if main:
            log(f"{name}: " + "  ".join(
                f"{d}={results[name][d]['accuracy']:.4f}" for d in dataloaders))

    if out_path and main:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)
    return results


def format_summary_table(results: Mapping[str, Mapping[str, Mapping]]) -> str:
    """Aligned console table of accuracies (variants × datasets)."""
    if not results:
        return "(no results)"
    datasets = list(next(iter(results.values())))
    name_w = max(len("MODEL VARIANT"), max(len(n) for n in results)) + 2
    col_w = max(12, max(len(d) for d in datasets) + 2)
    lines = ["MODEL VARIANT".ljust(name_w) + "".join(d.ljust(col_w) for d in datasets)]
    lines.append("-" * (name_w + col_w * len(datasets)))
    for name, per_ds in results.items():
        row = name.ljust(name_w)
        for d in datasets:
            acc = per_ds.get(d, {}).get("accuracy")
            row += (f"{acc:.4f}".ljust(col_w) if acc is not None else "-".ljust(col_w))
        lines.append(row)
    return "\n".join(lines)
