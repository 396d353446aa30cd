"""The general machinery of the benchmark: cells resolved from data files,
weights from the seed, the measured window, the trace's reduction."""
