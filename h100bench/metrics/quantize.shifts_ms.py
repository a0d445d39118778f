"""Device time a call in the shifts (quantize.shift_fast,
complex_gemm._shift_complex_fast: plain torch)."""
from h100bench import readers


def read(ctx):
    return readers.device_ms(ctx, "shifts")
