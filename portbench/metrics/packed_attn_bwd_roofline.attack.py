"""Packed attention's backward (``kernels/attention`` -> ``csrc/attention_packed.cu``)
against its roofline, in percent, over the traced attack batches: the
launches (the program's ``attention.BWD_LAUNCHES``) times the least time a
launch can take, over the device time of the kernels that implement it (the
statistics pre-pass included).

A launch at (B, N, H, hd) is at least max(8·N²·D·B ÷ 989.4 TFLOP/s, bytes ÷
3.35 TB/s), D = H·hd: the function's own inputs and outputs, q, k, v and dO
read once and dq, dk, dv written once, in the compute dtype (o and the
log-sum-exp the forward saved are left out: a kernel can recompute them)."""

from portbench.core import roofline

PATTERN = r"attn_bwd|wgs::stream_(?:bwd|stats)|cc::bwd"
COUNTER = "attention.BWD_LAUNCHES"


def bound_s(b: int, n: int, h: int, hd: int, elt: int) -> float:
    d = h * hd
    return roofline.bound_s(8 * n * n * d * b, 7 * b * n * d * elt)


def read(r):
    c = r.cell
    cfg = c.family.config(c.config)
    elt = 2 if c.config["compute_dtype"] == "bfloat16" else 4
    one = bound_s(c.traffic["batch"], cfg.tokens, cfg.heads, cfg.hidden // cfg.heads, elt)
    return roofline.kernel_pct(r.trace, PATTERN, COUNTER, lambda calls: calls * one)
