"""Packed attention's forward (``kernels/attention`` -> ``csrc/attention_packed.cu``)
against its roofline, in percent, over the traced attack batches: the
launches (the program's ``attention.FWD_LAUNCHES``) times the least time a
launch can take, over the device time of the kernels that implement it.

A launch at (B, N, H, hd) is at least max(4·N²·D·B ÷ 989.4 TFLOP/s, bytes ÷
3.35 TB/s), D = H·hd: the function's own input and output, q, k and v read
once and o written once, in the compute dtype (the log-sum-exp the kernel
saves for its backward is left out: a kernel need not write it)."""

from portbench.core import roofline

PATTERN = r"attn_fwd|wgs::stream_fwd|cc::fwd"
COUNTER = "attention.FWD_LAUNCHES"


def bound_s(b: int, n: int, h: int, hd: int, elt: int) -> float:
    d = h * hd
    return roofline.bound_s(4 * n * n * d * b, 4 * b * n * d * elt)


def read(r):
    c = r.cell
    cfg = c.family.config(c.config)
    elt = 2 if c.config["compute_dtype"] == "bfloat16" else 4
    one = bound_s(c.traffic["batch"], cfg.tokens, cfg.heads, cfg.hidden // cfg.heads, elt)
    return roofline.kernel_pct(r.trace, PATTERN, COUNTER, lambda calls: calls * one)
