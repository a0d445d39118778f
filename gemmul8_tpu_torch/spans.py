"""Named spans of a call's stages on torch.profiler's clock.

While a torch.profiler profile runs, each stage of an emulated GEMM opens a
user annotation named `gemmul8.<layer>` (torch.profiler.record_function),
in the same trace as the kernels it launches. A device operation belongs
to the innermost gemmul8.* span open on its thread when it was launched.
The layers:

  entry       the public entries and the emulation routines (gemm, syrk,
              herk, emulate_matmul and its striped and complex forms,
              padding)
  shifts      the per-row and per-column shifts (fast, robust, accurate);
              in accurate mode the maxima of the estimation product and
              the shifts taken from them
  extract     accurate mode's upper-bound planes of |A| and |B| (real, or
              the three 3M lanes of a complex operand)
  estimate    accurate mode's estimation product of those planes
  encode      the residue-plane encoders (K1, K6, K6c)
  lanes       the complex (Re+Im) lane of the INT8 3M scheme
  products    the exact low-precision products (INT8: the wgmma kernel K7;
              FP8: torch._scaled_mm) and their K-chunked sums
  epilogue    the fused mod + CRT + descale kernels (K2, K3, K4, K5, K3r)
  alpha_beta  alpha op(A) op(B) + beta C

With no profiler running a span checks torch.autograd._profiler_enabled()
and does nothing more: no allocation, no synchronisation, no change to any
output bit.
"""
from __future__ import annotations

import functools

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

LAYERS = ("entry", "shifts", "extract", "estimate", "encode", "lanes",
          "products", "epilogue", "alpha_beta")
PREFIX = "gemmul8."


class span:
    """The span of one layer: `@span("shifts")` on a function, or
    `with span("shifts"):` around a block."""

    def __init__(self, layer: str):
        if layer not in LAYERS:
            raise ValueError(f"span: unknown layer {layer!r}; one of {LAYERS}")
        self.layer, self.name = layer, PREFIX + layer
        self._open: list = []

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with record_function(name):
                return fn(*args, **kwargs)

        spanned.span = self.layer
        return spanned

    def __enter__(self):
        rf = None
        if _profiler_enabled():
            rf = record_function(self.name)
            rf.__enter__()
        self._open.append(rf)
        return self

    def __exit__(self, *exc):
        rf = self._open.pop()
        if rf is not None:
            rf.__exit__(*exc)
        return False
