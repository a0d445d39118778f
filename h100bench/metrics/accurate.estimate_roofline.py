"""The estimation product's (quantize.estimate_gemm) share of its roofline:
its least time over the device time of the program's gemmul8.estimate
spans."""
from h100bench import counts_accurate


def read(ctx):
    return counts_accurate.roofline_pct(ctx, "estimate", "estimate")
