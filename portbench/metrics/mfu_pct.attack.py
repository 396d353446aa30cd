"""The attack step's share of the card's bf16 peak, in percent: the family's
frozen count of a PGD image's operations (``portbench/flops/<family>.py``)
times the window's adversarial images a second, over 989.4 TFLOP/s."""

from portbench.core import roofline


def read(r):
    cfg = r.cell.family.config(r.cell.config)
    return roofline.mfu_pct(r.cell.flops.pgd(cfg, r.cell.traffic["steps"]), r.images / r.window_s)
