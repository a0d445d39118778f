"""The int8 products' (core.residue_matmul: torch._int_mm) share of their
roofline."""
from h100bench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "products")
