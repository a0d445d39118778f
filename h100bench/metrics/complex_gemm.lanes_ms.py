"""Device time a complex call spends building the (Re+Im) lanes
(complex_gemm._quantize_complex, beside its encode launches), on the
complex cells."""
from h100bench import readers


def read(ctx):
    return readers.device_ms(ctx, "lanes")
