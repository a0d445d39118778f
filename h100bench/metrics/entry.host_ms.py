"""The host's time a call in the entry (core.gemm, complex_gemm.gemm_complex),
before the synchronise."""
from h100bench import readers


def read(ctx):
    return readers.host_ms(ctx)
