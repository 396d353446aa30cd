"""The ViT-B/16 384-px cell (``vit_b16_384.pgd30_b64``): its frozen
yardsticks (the FLOP count at 577 tokens, packed attention's roofline
bounds there, and the forward's reader on the streamed kernel) on the CPU, and on the card its W8A8 control, not
correct on three seeds, beside a sound run that is. The card test is marked
``card`` and skips without one; ``python -m pytest portbench/tests -m card``
runs it on the chip (about 4 minutes for this cell)."""

import json
import os
import time

import pytest

from portbench.core import bench, spec
from portbench.core.bench import Readings
from portbench.core.trace import Trace
from portbench.flops import vit as vit_flops
from portbench.reference import vit

CELL = "vit_b16_384.pgd30_b64"
FWD = "packed_attn_fwd_roofline.attack"
SEEDS = (3100000001, 3100000002, 3100000003)


def _config(name):
    with open(os.path.join(spec.ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_the_count_is_the_ports_at_577_tokens():
    """577 tokens, and PGD-30 is 30 forwards and input gradients an image,
    the port's own count at its ``google_vit_384`` config."""
    from portbench.drivers import common

    flops, pvit = common.port("tools.flops"), common.port("models.vit")
    cfg = vit.config(_config("vit_b16_384"))
    assert cfg.tokens == 577
    assert vit_flops.pgd(cfg, 30) == 30 * (vit_flops.forward(cfg) + vit_flops.backward(cfg, "input"))
    assert vit_flops.pgd(cfg, 30) == flops.pgd(pvit.VIT_B16_384.with_classes(21), 30)
    # the attention core grows with N², the denses with N: 8.6x and 2.9x the 224-px model's
    small = vit.config(_config("vit_b16_224"))
    assert vit_flops._core(cfg) / vit_flops._core(small) == pytest.approx(8.58, abs=0.01)
    assert vit_flops._all_denses(cfg) / vit_flops._all_denses(small) == pytest.approx(2.93, abs=0.01)


@pytest.mark.parametrize("reader, shape, ms", [
    (FWD, (64, 577, 12, 64, 2), 0.0677),
    (FWD, (8, 577, 12, 64, 2), 0.0085),
    ("packed_attn_bwd_roofline.attack", (64, 577, 12, 64, 2), 0.1323),
])
def test_bounds_at_577_tokens(reader, shape, ms):
    """Packed attention at (64 and 8, 577, 12, 64), bf16, in ms to four
    places: the bytes bound the forward, the operations the backward."""
    mod = spec.load_module(spec.ROOT, "metrics", reader)
    assert round(mod.bound_s(*shape) * 1e3, 4) == ms


def test_the_forward_roofline_reads_the_streamed_kernel_at_577_tokens():
    """In this cell every packed forward runs on the streamed kernel
    (``wgs::stream_fwd``), which the forward's reader matches and times
    against ``attention.FWD_LAUNCHES``, at the cell's own (64, 577) bound."""
    mod = spec.load_module(spec.ROOT, "metrics", FWD)
    cell = spec.cell(CELL)
    assert any(m["name"] == FWD for m in cell.per_layer)
    op = ("void apvt::wgs::stream_fwd(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
          "CUtensorMap_st, float*, int, int, int, float)", 0.0, 100.0)
    trace = Trace(ops=[op], spans=[], units=1, wall_s=1.0, counters={"attention.FWD_LAUNCHES": 1})
    share = mod.read(Readings(cell, setup_s=1.0, window_s=1.0, units=1, images=64, trace=trace))
    assert share == pytest.approx(100 * mod.bound_s(64, 577, 12, 64, 2) / 100e-6)


@pytest.mark.card
def test_the_w8a8_control_is_not_correct_at_384_px(card):
    c = spec.cell(CELL)
    for seed in SEEDS:
        control = bench.run(c, seed, 0.5, False, card, time.perf_counter(), control=True)
        assert not control["correct"], control["checks"]
    sound = bench.run(c, SEEDS[0], 0.5, False, card, time.perf_counter())
    assert sound["correct"], sound["checks"]
