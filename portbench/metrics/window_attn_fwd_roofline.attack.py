"""Window attention's forward (``kernels/window_attention`` ->
``csrc/window_attention.cu``) against its roofline, in percent, over the
traced attack batches: the model passes (the program's
``window_attention.FWD_LAUNCHES`` over the blocks a pass) times the least
time of a pass's launches, over the device time of the kernels.

A launch on stage s, (B, nW, n, C) with ``heads`` heads, is at least
max(4·n²·C·B·nW ÷ 989.4 TFLOP/s, bytes ÷ 3.35 TB/s): the packed qkv read
and the output written once in the compute dtype, the f32 bias (heads, n, n)
and mask (nW, n, n) read once. A pass has depth_s launches of stage s."""

from portbench.core import roofline

PATTERN = r"win_fwd"
COUNTER = "window_attention.FWD_LAUNCHES"


def bound_s(b: int, nw: int, n: int, c: int, heads: int, elt: int) -> float:
    rows = b * nw * n
    nbytes = rows * 3 * c * elt + rows * c * elt + (heads + nw) * n * n * 4
    return roofline.bound_s(4 * n * n * c * b * nw, nbytes)


def pass_s(cfg, b: int, elt: int) -> float:
    n = cfg.window ** 2
    return sum(depth * bound_s(b, (cfg.res(s) // cfg.window) ** 2, n, cfg.dim(s), cfg.heads[s], elt)
               for s, depth in enumerate(cfg.depths))


def read(r):
    c = r.cell
    cfg = c.family.config(c.config)
    elt = 2 if c.config["compute_dtype"] == "bfloat16" else 4
    one = pass_s(cfg, c.traffic["batch"], elt) / sum(cfg.depths)  # a pass's mean launch
    return roofline.kernel_pct(r.trace, PATTERN, COUNTER, lambda calls: calls * one)
