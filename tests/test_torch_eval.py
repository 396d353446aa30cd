"""The port's eval stage against the JAX package's: variant enumeration,
confusion-matrix metrics, the eval step and the composability matrix on
``vit_test``, ``swin_test`` and ``convnext_test`` (f32).

The matrix runs on the same params, adapters, heads and uint8 batches in
both packages (a padded last batch included): accuracy and support must be
equal, F1 and mean loss within rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data.loader import Batch as TBatch
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data.loader import CachedLoader as TCached
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.eval import compose as tcompose
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import registry as tregistry
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import lora as tlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.train import metrics as tmetrics
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.train import steps as tsteps
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import trees as ttrees
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.data.loader import Batch as JBatch
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.eval import compose as jcompose
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.models import registry as jregistry
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.ops import lora as jlora
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.train import metrics as jmetrics
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.train import steps as jsteps
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import trees as jtrees

CLASSES = 4


@pytest.mark.parametrize("attacks", [(), ("fgsm",), ("fgsm", "pgd"), ("a", "b", "c"),
                                     ("a", "b", "c", "d")])
@pytest.mark.parametrize("mode", ["all", "base_only", "individual_only", "combinations_only"])
def test_enumerate_variants_matches_jax(attacks, mode):
    assert tcompose.enumerate_variants(attacks, test_mode=mode) == \
        jcompose.enumerate_variants(attacks, test_mode=mode)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_confusion_matrix_metrics_match_jax(seed):
    conf = np.random.default_rng(seed).integers(0, 9, (5, 5)).astype(np.float32)
    conf[seed] = 0  # a class with no support
    assert tmetrics.confusion_matrix_metrics(conf) == jmetrics.confusion_matrix_metrics(conf)


def test_eval_step_counts_only_valid_rows():
    logits = torch.tensor([[2.0, 0.0, 0.0], [0.0, 3.0, 0.0], [0.0, 0.0, 1.0], [5.0, 0.0, 0.0]])
    step = tsteps.make_eval_step(lambda p, x: logits, 3, normalize=None)
    loss, conf = step(None, torch.zeros(4, 2, 2, 3, dtype=torch.uint8),
                      torch.tensor([0, 2, 2, 1]), torch.tensor([1.0, 1.0, 1.0, 0.0]))
    want = np.zeros((3, 3), np.float32)
    want[0, 0] = want[2, 1] = want[2, 2] = 1
    np.testing.assert_array_equal(conf.numpy(), want)
    ce = torch.nn.functional.cross_entropy(logits[:3], torch.tensor([0, 2, 2]), reduction="sum")
    torch.testing.assert_close(loss, ce)


def _batches(seed, size, n=6, b=4):
    """n uint8 images as batches of b, the last one padded (valid = 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(0, n, b):
        m = min(b, n - k)
        images = np.zeros((b, size, size, 3), np.uint8)
        images[:m] = rng.integers(0, 256, (m, size, size, 3), dtype=np.uint8)
        labels = np.zeros(b, np.int32)
        labels[:m] = rng.integers(0, CLASSES, m)
        valid = (np.arange(b) < m).astype(np.float32)
        out.append((images, labels, valid))
    return out


@pytest.mark.parametrize("name", ["vit_test", "swin_test", "convnext_test"])
def test_composability_matrix_matches_jax(name):
    jentry = jregistry.get_model(name)
    jcfg = jentry.config(CLASSES)
    jparams = jentry.init(jax.random.key(0), jcfg)
    flat = {p: np.array(v) for p, v in jtrees.flatten_with_paths(jparams).items()}
    targets = jentry.lora_targets(jcfg)
    rng = np.random.default_rng(7)
    adapters_np = {}
    for attack in ("fgsm", "pgd"):
        ad = {}
        for path in targets:
            *lead, di, do = flat[f"{path}/w"].shape
            ad[path] = {"a": rng.standard_normal((*lead, di, 4)).astype(np.float32) * 0.3,
                        "b": rng.standard_normal((*lead, 4, do)).astype(np.float32) * 0.3}
        d = flat["head/w"].shape[0]
        head = ({"w": rng.standard_normal((d, CLASSES)).astype(np.float32),
                 "b": rng.standard_normal(CLASSES).astype(np.float32)} if attack == "pgd" else None)
        adapters_np[attack] = (ad, head)
    data = {ds: _batches(i, jcfg.image_size) for i, ds in enumerate(("clean", "fgsm", "pgd"))}

    jad = {a: ({p: {k: jnp.asarray(v) for k, v in f.items()} for p, f in ad.items()},
               jlora.LoRAConfig(rank=4, alpha=16.0, targets=targets), head)
           for a, (ad, head) in adapters_np.items()}
    want = jcompose.run_composability_eval(
        jentry, jparams, jad, {ds: [JBatch(*b, []) for b in bs] for ds, bs in data.items()},
        CLASSES, cfg=jcfg, log=lambda s: None)

    tentry = tregistry.get_model(name)
    tad = {a: ({p: {k: torch.from_numpy(v) for k, v in f.items()} for p, f in ad.items()},
               tlora.LoRAConfig(rank=4, alpha=16.0, targets=targets),
               None if head is None else {k: torch.from_numpy(v) for k, v in head.items()})
           for a, (ad, head) in adapters_np.items()}
    got = tcompose.run_composability_eval(
        tentry, ttrees.unflatten_from_paths(ttrees.map_leaves(torch.from_numpy, flat)), tad,
        {ds: [TBatch(*b, []) for b in bs] for ds, bs in data.items()}, CLASSES,
        cfg=tentry.config(CLASSES), device="cpu", log=lambda s: None)

    assert list(got) == list(want) == ["base", "lora_fgsm", "lora_pgd", "fgsm+pgd"]
    for variant in want:
        assert list(got[variant]) == list(want[variant]) == ["clean", "fgsm", "pgd"]
        for ds, m in want[variant].items():
            g = got[variant][ds]
            assert g["accuracy"] == m["accuracy"] and g["support"] == m["support"] == 6
            np.testing.assert_allclose(g["f1"], m["f1"], rtol=1e-4)
            np.testing.assert_allclose(g["loss"], m["loss"], rtol=1e-4)
    table = tcompose.format_summary_table(got)
    assert table == jcompose.format_summary_table(want)


def test_build_variant_params_last_head_wins():
    base = {"blocks": {"attn": {"q": {"w": torch.zeros(2, 3, 3)}}}, "head": {"w": torch.zeros(3, 2)}}
    cfg = tlora.LoRAConfig(rank=1, alpha=2.0, targets=("blocks/attn/q",))
    ad = {"blocks/attn/q": {"a": torch.ones(2, 3, 1), "b": torch.ones(2, 1, 3)}}
    heads = {"x": {"w": torch.full((3, 2), 1.0)}, "y": {"w": torch.full((3, 2), 2.0)}}
    adapters = {"x": (ad, cfg, heads["x"]), "y": (ad, cfg, heads["y"]), "z": (ad, cfg, None)}
    p = tcompose.build_variant_params(base, ("x", "y", "z"), adapters)
    assert p["head"] is heads["y"]
    assert torch.equal(p["blocks"]["attn"]["q"]["w"], torch.full((2, 3, 3), 6.0))
    assert torch.equal(base["blocks"]["attn"]["q"]["w"], torch.zeros(2, 3, 3))


def test_find_lora_adapters_both_layouts(tmp_path):
    from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.ops import peft_io

    cfg = tlora.LoRAConfig(rank=4, targets=("stages/0/blocks/attn/qkv",))
    ad = {"stages/0/blocks/attn/qkv": {"a": torch.ones(1, 2, 3, 4), "b": torch.ones(1, 2, 4, 9)}}
    peft_io.save_peft_adapter(ad, cfg, str(tmp_path / "flat" / "fgsm" / "rank4_best_adapter"))
    peft_io.save_peft_adapter(ad, cfg, str(tmp_path / "nested" / "swin" / "all" / "pgd" /
                                           "rank4_best_adapter"))
    logs = []
    flat = tcompose.find_lora_adapters(str(tmp_path / "flat"), ["fgsm", "pgd"], 4, log=logs.append)
    assert list(flat) == ["fgsm"] and any("no 'pgd'" in m for m in logs)
    nested = tcompose.find_lora_adapters(str(tmp_path / "nested"), ["pgd"], 4, model="swin",
                                         source="all", log=logs.append)
    assert torch.equal(nested["pgd"][0]["stages/0/blocks/attn/qkv"]["b"], torch.ones(1, 2, 4, 9))
    assert tcompose.find_lora_adapters(str(tmp_path / "nested"), ["pgd"], 4, model="vit",
                                       log=logs.append) == {}


class _Counting:
    """A loader stand-in that counts its passes."""

    def __init__(self, batches, shuffle=False):
        self.batches, self.shuffle, self.passes = batches, shuffle, 0
        self.index, self.image_size = [0] * len(batches), 2

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        self.passes += 1
        yield from self.batches


@pytest.mark.parametrize("shuffle,max_bytes,passes", [(False, 1 << 20, 1), (True, 1 << 20, 3),
                                                      (False, 1, 3)])
def test_cached_loader_pass_through_rules(shuffle, max_bytes, passes):
    inner = _Counting(["a", "b"], shuffle=shuffle)
    cached = TCached(inner, max_bytes=max_bytes)
    for _ in range(3):
        assert list(cached) == ["a", "b"]
    assert inner.passes == passes and len(cached) == 2
