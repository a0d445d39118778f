"""The encode stage's (K1, kernels.encode_planes) share of its roofline."""
from h100bench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "encode")
