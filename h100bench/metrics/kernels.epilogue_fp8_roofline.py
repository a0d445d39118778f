"""K3's (kernels.fused_epilogue_fp8) share of its roofline, over the device
time of the program's gemmul8.epilogue spans."""
from h100bench import counts_fp8


def read(ctx):
    return counts_fp8.roofline_pct(ctx, "epilogue", "epilogue")
