"""Peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit) and the
least time a piece of work can take on it."""

PEAK_BF16_FLOPS = 989.4e12  # tensor cores, bf16 dense
PEAK_HBM_BYTES = 3.35e12  # HBM3


def bound_s(flop: float, nbytes: float) -> float:
    """The larger of the compute bound and the memory bound, in seconds."""
    return max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def mfu_pct(flop_per_image: float, images_per_s: float) -> float:
    """Achieved share of the bf16 peak, in percent."""
    return 100.0 * flop_per_image * images_per_s / PEAK_BF16_FLOPS


def kernel_pct(trace, pattern: str, counter: str, least_s) -> float | None:
    """A kernel's share of its roofline over a trace, in percent: its
    launches (the program's ``counter``) times ``least_s(launches)``, the
    least time they can take, over the device time of the operations that
    match ``pattern``. None where the trace holds no device operation, or
    neither the kernel nor its counter shows (the kernel is off the path);
    an error where only one of them shows (a kernel renamed away from the
    pattern, or a counter gone)."""
    if not trace.ops:
        return None
    seconds, calls = trace.kernel_s(pattern), trace.counters.get(counter, 0)
    if not seconds and not calls:
        return None
    if not seconds or not calls:
        raise ValueError(f"{counter} counted {calls} launches, and operations matching "
                         f"{pattern!r} took {seconds} s on the device: one without the other")
    return 100.0 * least_s(calls) / seconds
