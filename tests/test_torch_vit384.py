"""ViT-B/16 at 384 px (``google_vit_384``, google/vit-base-patch16-384) on
the port's normal path, on the CPU.

* The registry entry holds the benchmark configuration file's widths
  (``portbench/configs/vit_b16_384.json`` through the plain reference's
  ``port_fields``): 577 tokens of head dim 64.
* The packed attention's variant at 577 tokens is the streamed forward.
* The port against the plain reference (``portbench/reference/vit.py``) on
  seeded random weights at image 384, patch 16 and a small width, so 577
  tokens through the same patch and position code: logits, the input
  gradient and a PGD-2 batch; the attack's spans open as at 224 px.
* The CLI's ``attack --model google_vit_384`` builds its PGD through
  ``attacks.whitebox.make_pgd`` with the entry's config, as the benchmark's
  cell does by registry name (``portbench/drivers/common.program``).
"""

import dataclasses
import json
import os
import sys

import pytest
import torch
import torch.nn.functional as F

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.attacks import whitebox
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.cli.main import main as tmain
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data.io import read_metadata
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.kernels import attention
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import registry
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.models import vit
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import checkpoint, trees
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils.vocab import LabelVocabulary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from portbench.reference import common as C  # noqa: E402
from portbench.reference import vit as rvit  # noqa: E402

EPS, ALPHA = 8 / 255, 3 / 255
# 384 px and patch 16 as published, a CPU-sized width: 577 tokens, head dim 32
SMALL = dataclasses.replace(vit.VIT_B16_384, hidden_dim=64, depth=2, num_heads=2, mlp_dim=128,
                            num_classes=5, compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the workers share the cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _config_file():
    with open(os.path.join(REPO, "portbench", "configs", "vit_b16_384.json")) as f:
        return json.load(f)


def test_the_registry_entry_holds_the_configuration_files_widths():
    conf = _config_file()
    entry = registry.get_model(conf["registry"])
    cfg = entry.config(conf["num_labels"])
    want = rvit.port_fields(conf)
    assert {k: getattr(cfg, k) for k in want} == want
    assert (cfg.seq_len, cfg.head_dim, cfg.num_patches) == (577, 64, 576)
    assert rvit.config(conf).tokens == cfg.seq_len
    base = registry.get_model("google_vit")
    assert cfg == dataclasses.replace(base.config(conf["num_labels"]), image_size=384)
    assert entry.family == "vit" and entry.normalization == base.normalization
    assert entry.lora_targets(cfg) == base.lora_targets(base.config(21)) == vit.LORA_TARGETS_DEFAULT
    assert (entry.init, entry.from_tree, entry.apply) == (base.init, base.from_tree, base.apply)


def test_the_384_px_config_takes_the_streamed_forward_and_224_the_register_one():
    """The bf16 route each registry config's own shape takes: 577 tokens the
    streamed forward, 197 the register-resident one; both the streamed
    backward."""
    for name, want in (("google_vit_384", "wgmma_stream"), ("google_vit", "wgmma")):
        cfg = registry.get_model(name).config(21)
        assert attention.kernel_variant(torch.bfloat16, cfg.seq_len, cfg.head_dim, "fwd") == want
        assert attention.kernel_variant(torch.bfloat16, cfg.seq_len, cfg.head_dim,
                                        "bwd") == "wgmma_stream"


@pytest.fixture(scope="module")
def small():
    """(reference config, flat tree, the port's model) on seeded random weights."""
    tree = trees.flatten_with_paths(vit.init(SMALL, torch.Generator().manual_seed(5)))
    conf = {"image_size": 384, "patch_size": 16, "hidden_size": SMALL.hidden_dim,
            "num_hidden_layers": SMALL.depth, "num_attention_heads": SMALL.num_heads,
            "intermediate_size": SMALL.mlp_dim, "num_labels": SMALL.num_classes,
            "layer_norm_eps": SMALL.layer_norm_eps, "compute_dtype": "float32"}
    rcfg = rvit.config(conf)
    assert rcfg.tokens == SMALL.seq_len == 577
    assert set(tree) == set(rvit.layout(rcfg))
    # the position table moved off its init, so that a wrong row would show
    tree["embed/pos"] = torch.randn(tree["embed/pos"].shape, generator=torch.Generator().manual_seed(6))
    return rcfg, tree, vit.params_from_jax(tree, SMALL)


def _images(n=2, seed=0):
    return torch.rand((n, 384, 384, 3), generator=torch.Generator().manual_seed(seed))


def test_the_port_matches_the_plain_reference_at_384_px(small):
    """Logits and the input gradient of the summed cross-entropy. Both sides
    are f32 on the CPU; they differ only in the order of their sums (the
    port's packed attention and denses against the reference's per-head
    products), a few ulp through two blocks: 5e-6 on the logits (of size
    1-2.4) and 1.5e-5 of the largest on the gradient, ten times the largest
    differences seen over three seeds (4.8e-7, 1.5e-6); bf16 products would
    miss both by a thousand times."""
    rcfg, tree, model = small
    x = C.normalize(_images())
    labels = torch.tensor([1, 3])
    logits, grads = [], []
    for fwd in (lambda t: vit.apply(SMALL, model, t), lambda t: rvit.forward(tree, rcfg, t)):
        xg = x.clone().requires_grad_(True)
        out = fwd(xg)
        (g,) = torch.autograd.grad(F.cross_entropy(out, labels, reduction="sum"), xg)
        logits.append(out.detach())
        grads.append(g)
    torch.testing.assert_close(logits[0], logits[1], atol=5e-6, rtol=5e-6)
    scale = grads[1].abs().max()
    assert scale > 0
    assert ((grads[0] - grads[1]).abs().max() / scale) < 1.5e-5


def test_a_pgd2_batch_matches_the_plain_reference_at_384_px(small):
    """The port's PGD-2 (``make_pgd``, as the attack stage makes it) against
    the reference's from the same start. A pixel can part only where the
    two sides' gradients differ in sign, which f32 rounding does only for a
    gradient within a few ulp of zero: none parted over three seeds, and at
    most 1e-5 of the pixels (9 of 884,736) may."""
    rcfg, tree, model = small
    x0, labels = _images(seed=1), torch.tensor([0, 4])
    noise = torch.empty(x0.shape).uniform_(-EPS, EPS, generator=torch.Generator().manual_seed(2))
    run = whitebox.make_pgd(vit.apply, SMALL, eps=EPS, alpha=ALPHA, steps=2)
    got = run(model, x0, labels, noise=noise)
    want = C.pgd(lambda x: rvit.forward(tree, rcfg, C.normalize(x)), x0, labels, noise,
                 eps=EPS, alpha=ALPHA, steps=2)
    apart = (got - want).abs() > 1e-6
    assert apart.float().mean() <= 1e-5
    assert (got - x0).abs().max() <= EPS + 1e-6
    assert not torch.equal(got, torch.clamp(x0 + noise, 0, 1))  # the steps moved it


def test_the_attacks_spans_open_at_384_px_as_at_224(small):
    """An eager PGD-2 batch at 577 tokens opens the spans the 224-px cells'
    do: the start, then each step with its forward, backward and update."""
    from torch.profiler import ProfilerActivity, profile

    _, _, model = small
    run = whitebox.make_pgd(vit.apply, SMALL, eps=EPS, alpha=ALPHA, steps=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(model, _images(1), torch.tensor([2]), torch.Generator().manual_seed(0))
    spans = sorted(((ev.name, ev.time_range.start, -ev.time_range.end) for ev in prof.events()
                    if ev.name.startswith("apvt.")), key=lambda s: s[1:])
    step = ["apvt.attack.step", "apvt.attack.forward", "apvt.attack.backward",
            "apvt.attack.update"]
    assert [s[0] for s in spans] == ["apvt.attack.start", *step * 2]


def test_the_cli_attack_stage_takes_google_vit_384(tmp_path, monkeypatch):
    """``attack --model google_vit_384`` builds the model from the registry
    entry at 384 px (its widths cut here to ``SMALL``'s, for the CPU) and
    its PGD through ``make_pgd``, and writes 384-px adversarial images."""
    data, out = str(tmp_path / "data"), str(tmp_path / "adv")
    assert tmain(["--device", "cpu", "synth-data", "--output_dir", data,
                  "--n_per_class", "1", "--image_size", "48"]) == 0
    entry = registry.get_model("google_vit_384")
    monkeypatch.setitem(registry._REGISTRY, "google_vit_384", dataclasses.replace(
        entry, config=lambda n: dataclasses.replace(SMALL, num_classes=n)))
    built = []
    make_pgd = whitebox.make_pgd

    def recorded(entry_apply, cfg, **kw):
        built.append((entry_apply, cfg, kw["steps"]))
        return make_pgd(entry_apply, cfg, **kw)

    monkeypatch.setattr(whitebox, "make_pgd", recorded)
    ck = str(tmp_path / "ck" / "google_vit_384.safetensors")
    vocab = LabelVocabulary.from_metadata_frames(
        [read_metadata(os.path.join(data, s, "metadata.csv")) for s in ("train", "val", "test")])
    checkpoint.save_pytree(vit.init(SMALL.with_classes(len(vocab)),
                                    torch.Generator().manual_seed(1)), ck)
    assert tmain(["--device", "cpu", "attack", "--data_root", data, "--model", "google_vit_384",
                  "--model_path", ck, "--splits", "test", "--batch_size", "4",
                  "--attacks", "pgd", "--steps", "2", "--output_dir", out]) == 0
    assert len(built) == 1
    apply_fn, cfg, steps = built[0]
    assert apply_fn is vit.apply and steps == 2
    assert (cfg.image_size, cfg.seq_len) == (384, 577)
    images = os.path.join(out, "google_vit_384", "all", "test", "pgd", "images")
    from PIL import Image

    first = sorted(os.listdir(images))[0]
    assert Image.open(os.path.join(images, first)).size == (384, 384)
