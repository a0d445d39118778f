"""The upper-bound extraction's (quantize.extract_ub_plane on A and B)
share of its roofline: both operands' least extraction time over the device
time of the program's gemmul8.extract spans."""
from h100bench import counts_accurate


def read(ctx):
    return counts_accurate.roofline_pct(ctx, "extract", "extract")
