"""Runtime configuration from the GEMMUL8_* environment contract of the
reference's hook (src/hook.cu:20-38, 283-310), read on every call: the
counterpart of gemmul8_tpu/config.py.

  GEMMUL8_NUM_MOD_S / _D / _C / _Z : num_moduli per dtype (f32/f64/c64/c128)
  GEMMUL8_FASTMODE_S / _D / _C / _Z: 1 = fast (norm-based shifts), 0 = accurate,
                                     2|robust = scale-invariant fast shifts
  GEMMUL8_BACKEND                  : INT8 (default) or FP8
  GEMMUL8_EPILOGUE                 : auto (default) | ff | f64
  GEMMUL8_SKIP_SCALE_A / _B        : per-side operand-plane reuse in the hook
                                     (1 = cache, 0 = requantize every call);
                                     unset sides follow GEMMUL8_EAGER_CACHE,
                                     default 0 (off): torch tensors are
                                     mutable, and a write through .data, a
                                     numpy view or DLPack leaves the version
                                     counter the cache keys on unchanged.
"""
from __future__ import annotations

import dataclasses
import os

from . import tables

_DTYPE_SUFFIX = {"float32": "S", "float64": "D", "complex64": "C",
                 "complex128": "Z"}


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    num_moduli: int = 8
    fastmode: bool | str = True
    backend: str = tables.Backend.INT8
    epilogue: str = "auto"

    def validate(self, dtype_name: str) -> bool:
        lo, hi = tables.VALID_RANGE[dtype_name]
        return lo <= self.num_moduli <= hi


def env_config(dtype_name: str) -> GemmConfig | None:
    """A GemmConfig for `dtype_name` ("float32", "float64", "complex64",
    "complex128") from the GEMMUL8_* variables, or None (native
    fallthrough, as the reference hook does) when GEMMUL8_NUM_MOD_* is unset
    or out of the dtype's range."""
    sfx = _DTYPE_SUFFIX[dtype_name]
    nm = os.environ.get(f"GEMMUL8_NUM_MOD_{sfx}")
    if nm is None:
        return None
    fm_raw = os.environ.get(f"GEMMUL8_FASTMODE_{sfx}", "1").lower()
    fastmode: bool | str
    if fm_raw in ("0", "false", "accurate", "accu"):
        fastmode = False
    elif fm_raw in ("2", "robust"):
        fastmode = "robust"
    elif fm_raw in ("1", "true", "fast"):
        fastmode = True
    else:
        # an unknown spelling must not silently pick fast mode
        raise ValueError(
            f"GEMMUL8_FASTMODE_{sfx}={fm_raw!r}: use 1/fast, 0/accurate, "
            f"or 2/robust")
    cfg = GemmConfig(
        num_moduli=int(nm),
        fastmode=fastmode,
        backend=os.environ.get("GEMMUL8_BACKEND", tables.Backend.INT8).upper(),
        epilogue=os.environ.get("GEMMUL8_EPILOGUE", "auto").lower(),
    )
    return cfg if cfg.validate(dtype_name) else None


def cache_enabled(side: str) -> bool:
    """Whether the hook reuses side "A"'s or "B"'s planes across calls:
    GEMMUL8_SKIP_SCALE_{side} ("1"/"0"), else GEMMUL8_EAGER_CACHE, else off
    (the reference's opt-in default, hook.cu:20-38)."""
    v = os.environ.get(f"GEMMUL8_SKIP_SCALE_{side}")
    if v is None:
        v = os.environ.get("GEMMUL8_EAGER_CACHE", "0")
    return v.lower() not in ("0", "false")
