"""The plain references held against the program on the CPU at the
families' test sizes (f32 compute on both sides), part by part and through
the benchmark's own runs."""

import time

import pytest
import torch

from portbench.core import bench, spec, weights
from portbench.drivers import common
from portbench.reference import common as C
from portbench.tests import tiny


def _build(name: str, seed: int = 3):
    """(family, its config, the tree, the program's model and entry and config)."""
    conf = tiny.TINY_CONFIGS[name]
    fam = spec.load_module(spec.ROOT, "reference", conf["family"])
    rcfg = fam.config(conf)
    tree = weights.make(fam.layout(rcfg), seed, torch.device("cpu"), torch.float32)
    entry = common.port("models.registry").get_model(conf["registry"])
    pcfg = entry.config(conf["num_labels"])
    assert {k: getattr(pcfg, k) for k in fam.port_fields(conf)} == fam.port_fields(conf)
    return fam, rcfg, tree, entry.from_tree(dict(tree), pcfg), entry, pcfg


def _images(rcfg, n=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, rcfg.image_size, rcfg.image_size, 3), generator=g)


@pytest.mark.parametrize("name", sorted(tiny.TINY_CONFIGS))
def test_forward_matches_the_program(name):
    fam, rcfg, tree, model, entry, pcfg = _build(name)
    x = C.normalize(_images(rcfg))
    with torch.no_grad():
        want = entry.apply(pcfg, model, x)
        got = fam.forward(tree, rcfg, x)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5), (got - want).abs().max()


@pytest.mark.parametrize("name", sorted(tiny.TINY_CONFIGS))
def test_input_gradient_matches_the_program(name):
    fam, rcfg, tree, model, entry, pcfg = _build(name)
    x0 = C.normalize(_images(rcfg))
    labels = torch.tensor([1, 2, 3])
    grads = []
    for fwd in (lambda x: entry.apply(pcfg, model, x), lambda x: fam.forward(tree, rcfg, x)):
        x = x0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.nn.functional.cross_entropy(fwd(x), labels), x)
        grads.append(g)
    assert torch.allclose(grads[1], grads[0], atol=1e-6, rtol=1e-4)


def test_fp8_control_changes_the_forward():
    fam, rcfg, tree, *_ = _build("vit_tiny")
    x = C.normalize(_images(rcfg))
    exact, low = fam.forward(tree, rcfg, x), fam.forward(tree, rcfg, x, lowp="fp8")
    gap = ((low - exact).abs().max() / exact.abs().max()).item()
    assert 1e-3 < gap < 0.5


def test_fp8_round_keeps_the_slice_scale():
    x = torch.tensor([[1.0, -448.0, 3.3], [1e-3, 2e-3, -4e-3]])
    y = C.fp8_round(x, -1)
    assert y[0, 1] == -448.0 and y[1, 2] == pytest.approx(-4e-3)
    assert (y - x).abs().max() <= 0.07 * x.abs().amax(-1).max()


@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
def test_a_run_of_each_tiny_cell_is_correct(cell, tiny_root):
    """The benchmark's whole run on the CPU: the program and the reference
    agree to f32 rounding in every compared number."""
    line = bench.run(spec.cell(cell, tiny_root), 2 ** 31 + 11, 0.05, False, "cpu",
                     time.perf_counter())
    assert line["correct"], line["checks"]
    assert all(c["value"] < 1e-4 for c in line["checks"].values()), line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("name", sorted(tiny.TINY_CONFIGS))
def test_pgd_matches_the_programs(name):
    """The reference's whole PGD against the program's, from the same start."""
    fam, rcfg, tree, model, entry, pcfg = _build(name)
    whitebox = common.port("attacks.whitebox")
    x0 = _images(rcfg, n=4, seed=1)
    labels = torch.tensor([0, 1, 2, 3])
    eps, alpha = 8 / 255, 3 / 255
    noise = torch.empty(x0.shape).uniform_(-eps, eps, generator=torch.Generator().manual_seed(2))
    run = whitebox.make_pgd(entry.apply, pcfg, eps=eps, alpha=alpha, steps=5)
    want = run(model, x0, labels, noise=noise)
    got = C.pgd(lambda x: fam.forward(tree, rcfg, C.normalize(x)), x0, labels, noise,
                eps=eps, alpha=alpha, steps=5)
    assert ((got - want).abs() > 1e-6).float().mean() < 0.01


@pytest.mark.parametrize("n", [1, 4])
def test_the_augmentation_skip_draws_what_a_call_draws(n):
    """The reference advances the augmentation's stream over the steps it
    does not follow by exactly the draws of ``train_augment``."""
    from portbench.reference import augment as A

    called, skipped = (torch.Generator().manual_seed(5) for _ in range(2))
    for _ in range(3):
        A.train_augment(torch.rand((n, 8, 8, 3)), called)
    A.skip(skipped, n, torch.device("cpu"), 3)
    assert torch.equal(called.get_state(), skipped.get_state())
