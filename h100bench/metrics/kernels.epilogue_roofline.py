"""The epilogue's (K2 csrc/epilogue.cu on real cells, K4 csrc/complex.cu on
complex ones) share of its roofline."""
from h100bench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "epilogue")
