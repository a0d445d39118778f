"""The 3nu FP8 products' (fp8.residue_matmul_fp8: torch._scaled_mm) share of
their roofline, over the device time of the program's gemmul8.products
spans."""
from h100bench import counts_fp8


def read(ctx):
    return counts_fp8.roofline_pct(ctx, "products", "products")
