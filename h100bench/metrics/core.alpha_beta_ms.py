"""Device time a call of the operations launched inside the program's
gemmul8.alpha_beta span (core.ab_epilogue, complex_gemm._gemm_cplx)."""
from h100bench import spans


def read(ctx):
    return spans.device_ms(ctx, "alpha_beta")
