"""The frozen yardsticks: the FLOP counts and the roofline bounds."""

import pytest

from portbench.core import spec
from portbench.flops import swin as swin_flops
from portbench.flops import vit as vit_flops
from portbench.reference import swin, vit


def _config(name):
    import json
    import os

    with open(os.path.join(spec.ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port_flops():
    from portbench.drivers import common

    return common.port("tools.flops"), common.port("models.vit")


def test_vit_count_equals_the_ports(port_flops):
    flops, pvit = port_flops
    cfg = vit.config(_config("vit_b16_224"))
    pcfg = pvit.VIT_B16.with_classes(21)
    assert vit_flops.pgd(cfg, 30) == flops.pgd(pcfg, 30)
    assert vit_flops.pgd(cfg, 10) == flops.pgd(pcfg, 10)
    for mode in ("full", "lora"):
        assert vit_flops.train_step(cfg, mode) == flops.train_step(pcfg, mode)
    head = 2 * cfg.hidden * cfg.classes
    assert vit_flops.train_step(cfg, "lora", train_head=True) == flops.train_step(pcfg, "lora") + head


def test_swin_b_forward_is_the_published_count():
    cfg = swin.config(_config("swin_b_224"))
    gmac = swin_flops.forward(cfg) / 2e9
    assert abs(gmac - 15.4) / 15.4 < 0.02
    assert abs(gmac - 15.43) < 0.005  # 12·C²·T + 98·C·T a block, the embedding, 3 mergings
    assert swin_flops.pgd(cfg, 30) == 30 * (swin_flops.forward(cfg) + swin_flops.backward_input(cfg))


@pytest.mark.parametrize("reader, shape, ms", [
    ("packed_attn_fwd_roofline.attack", (64, 197, 12, 64, 2), 0.0231),
    ("packed_attn_bwd_roofline.attack", (64, 197, 12, 64, 2), 0.0405),
    ("window_attn_fwd_roofline.attack", (64, 4, 49, 512, 16, 2), 0.0154),
    ("window_attn_bwd_roofline.attack", (64, 4, 49, 512, 16, 2), 0.0269),
    ("window_attn_fwd_roofline.attack", (64, 64, 49, 128, 4, 2), 0.0615),
    ("window_attn_bwd_roofline.attack", (64, 64, 49, 128, 4, 2), 0.1076),
])
def test_bounds_reproduce_the_kernel_table(reader, shape, ms):
    """PERF.md's kernel table: packed attention at (64, 197, 12, 64), window
    attention at Swin-B's stage 3 (64, 4, 49, 1536 / 16 heads) and stage 1
    (64, 64, 49, 384 / 4 heads), bf16, in ms to four places."""
    mod = spec.load_module(spec.ROOT, "metrics", reader)
    assert round(mod.bound_s(*shape) * 1e3, 4) == ms


def test_window_pass_sums_the_stages():
    mod = spec.load_module(spec.ROOT, "metrics", "window_attn_fwd_roofline.attack")
    cfg = swin.config(_config("swin_b_224"))
    stage = [mod.bound_s(64, (cfg.res(s) // 7) ** 2, 49, cfg.dim(s), cfg.heads[s], 2)
             for s in range(4)]
    assert mod.pass_s(cfg, 64, 2) == pytest.approx(sum(d * b for d, b in zip(cfg.depths, stage)))


def test_a_roofline_reads_nothing_off_the_path_and_fails_on_half_the_evidence():
    """A kernel off the path (no launches, no device time) reads nothing; a
    kernel renamed away from the reader's pattern, or a counter gone, fails
    the run instead of leaving the metric out."""
    from portbench.core import roofline
    from portbench.core.trace import Trace

    def trace(ops, counters):
        return Trace(ops=ops, spans=[], units=1, wall_s=1.0, counters=counters)

    gemm = ("sm90_gemm", 0.0, 100.0)
    assert roofline.kernel_pct(trace([], {"k.N": 3}), "attn", "k.N", lambda n: n) is None
    assert roofline.kernel_pct(trace([gemm], {}), "attn", "k.N", lambda n: n) is None
    with pytest.raises(ValueError):
        roofline.kernel_pct(trace([gemm], {"k.N": 3}), "attn", "k.N", lambda n: n)
    with pytest.raises(ValueError):
        roofline.kernel_pct(trace([gemm, ("attn_fwd", 100.0, 150.0)], {}), "attn", "k.N",
                            lambda n: n)
    share = roofline.kernel_pct(trace([gemm, ("attn_fwd", 100.0, 150.0)], {"k.N": 2}),
                                "attn", "k.N", lambda n: n * 10e-6)
    assert share == pytest.approx(40.0)
