"""K6's (kernels.encode_planes_fp8) share of its roofline on the FP8 cells:
both operands' least encode time over the device time of the program's
gemmul8.encode spans."""
from h100bench import counts_fp8


def read(ctx):
    return counts_fp8.roofline_pct(ctx, "encode", "encode")
