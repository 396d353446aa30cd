"""The device memory that the training steps hold at their peak, in GiB: the
caching allocator's peak of allocated bytes from the window's start (set-up's
peak reset) to its closing steps, before the check copies the state. Nothing
where no card was read."""


def read(r):
    peak = r.taken.get("window_memory_peak_bytes")
    return peak / 2 ** 30 if peak else None
