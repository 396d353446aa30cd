"""The training step's share of the card's bf16 peak, in percent: the
family's frozen count of a step's operations an image (``full``, or ``lora``
with the trained head's gradient) times the window's training images a
second, over 989.4 TFLOP/s."""

from portbench.core import roofline


def read(r):
    t = r.cell.traffic
    cfg = r.cell.family.config(r.cell.config)
    kw = {"rank": t["rank"], "train_head": t["train_head"]} if t["mode"] == "lora" else {}
    return roofline.mfu_pct(r.cell.flops.train_step(cfg, t["mode"], **kw), r.images / r.window_s)
