"""Calibrated accuracy model and (num_moduli, fastmode) chooser.

The counterpart of gemmul8_tpu/accuracy_model.py: the same model, constants
and answers, computed in numpy over the port's tables (no tensor is
involved, so nothing here runs on a device).

The reference exposes ``num_moduli`` as a raw dial and leaves picking it to
the user (include/gemmul8.hpp:30 documents only the valid range; guidance
lives in the paper: ~14-16 moduli for FP64-grade DGEMM). This module adds
what the reference lacks: a measured model of the max relative error as a
function of ``num_moduli`` AND the shift mode, plus an inverse -- "give me
the cheapest setting that hits this accuracy".

Model
-----
For protocol data (testing/make_matrix.hpp:73-79: phi < 0 standard normal,
else (U-0.5) * e^(N*phi))::

    log2(max_rel_err)  ~=  C[mode]  +  s[mode] * spread_bits  -  log2(P_nu)/2

where ``P_nu`` is the product of the first ``nu`` moduli (each INT8 modulus
contributes ~8 bits, each FP8 modulus ~9-10), ``C[mode]`` is the calibrated
worst-case intercept and ``spread_bits`` measures the data's exponent
spread (protocol mapping: ~5.5 bits per unit of phi; 0 for normal data).
The 1/2 is structural: the integer budget log2(P) splits evenly between the
two operands' quantizations (NUMERICS.md section 2).

Calibration (committed CSVs, benchmarks/results/):
  * fast (the reference formula):   C = 24.7, s = 1.2   -- phi <~ 1.5 only;
    at phi >= 4 the formula's probabilistic slack collapses (measured
    intercepts blow past 50-78: oz2_calib_INT8_f64_fastrobust_cpu_r4.csv,
    phi=4 rows) so the model declares fast INVALID past
    ``FAST_SPREAD_LIMIT`` instead of extrapolating.
  * robust (scale-invariant fast):  C = 24.0, s = 0.8   -- bounded growth
    at any measured spread (the f32 phi=4 rows pin the slope at 0.8;
    f64 phi=4 worst intercept 36.2 sits under 24 + 0.8*22 = 41.6).
  * accurate (two-phase estimation): C = 21.0, s = 0.9  -- best base
    intercept; its max-rel-err still grows with spread because spread data
    puts small-|c| elements under a row/col-scaled quantization grid (an
    output-conditioning effect no shift choice removes).

Sources: round-4 sweeps oz2_calib_{INT8,FP8}_f64_{fastrobust,accu}_cpu_r4.csv
and oz2_calib_INT8_f32_accu_cpu_r4.csv (phi in {-1, 0, 2, 4}, k in
{1024, 4096}), plus the round-2 fast/robust sweeps
(oz2_results_INT8_{f32,f64}_accuracy_cpu_round2*.csv, phi in
{-1, 0, 0.5, 1, 2, 4}, k to 2^14). The constants are the worst observed
intercept per mode across BOTH backends; tests/test_accuracy_model.py
re-validates the envelope against every committed CSV row.

The model is advisory: it predicts the protocol's max elementwise relative
error on random data, not a rigorous bound for adversarial inputs.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from . import tables

# the torch dtypes the model answers for, by their numpy names
_TORCH_DTYPES = {torch.float32: "float32", torch.float64: "float64",
                 torch.complex64: "complex64", torch.complex128: "complex128"}


def _dtype_name(dtype) -> str:
    """numpy's name of a numpy or torch dtype ("float64" for either)."""
    return np.dtype(_TORCH_DTYPES.get(dtype, dtype)).name

#: calibrated worst-case intercepts per shift mode (see module docstring)
CALIBRATED_C = {"fast": 24.7, "robust": 24.0, "accu": 21.0}

#: spread sensitivity per mode: modeled penalty = s * spread_bits
#: (fast's 1.2 is pinned by the f32 phi=2 sweep rows -- the formula's
#: degradation is superlinear in spread even inside its valid domain)
SPREAD_FACTOR = {"fast": 1.2, "robust": 0.8, "accu": 0.9}

#: the reference fast formula's calibrated domain: phi <~ 1.5 (~8 spread
#: bits). Beyond, measured errors leave the linear model entirely -- f32 at
#: phi=2 lands 13-33x WORSE than native f32 (round-2 sweep, nu=13 row err
#: 0.13), and by phi=4 the f64 intercepts blow past 50-78. The model
#: refuses rather than extrapolating; the chooser switches to robust.
FAST_SPREAD_LIMIT = 8.0

#: protocol mapping from the generator's phi to spread_bits (e^(N*phi) with
#: |N| <~ 3.5 spans ~ phi * 5.5 bits of exponent around the median)
BITS_PER_PHI = 5.5

#: modeled native-GEMM max relative error per output dtype on protocol data:
#: f64 ~ 2^-36 (CPU f64 sweeps, k-independent: small-denominator entries
#: dominate), f32 ~ 2^-10 (CPU f32 native row; also conservative for the TPU
#: native f32 path, which is a single bf16 pass at ~2^-13 .. 2^-10).
NATIVE_ERR_BITS = {"float64": -36.0, "float32": -10.0,
                   "complex128": -36.0, "complex64": -10.0}

#: the emulation's output-dtype floor sits ~5-6.5 bits above eps on protocol
#: data (rounding of the inverse-scaled result is amplified on entries whose
#: |c| is small relative to their row/col scale): measured f32 floor 2^-18.4
#: (eps 2^-23.25), f64 floor 2^-45.9 .. -48.9 (eps 2^-52.4). 6.6 bits covers
#: the worst committed row (accu nu=19 at 2^-45.9).
FLOOR_AMPLIFICATION_BITS = 6.6

#: exponent-spread data lifts the floor further (small-|c| entries under a
#: row/col-scaled grid), but the measured lift SATURATES: the worst
#: committed floor-region rows sit 2.5-5 bits above the flat floor
#: (f64 robust nu=20 at phi=0.5: +2.5; f32 robust nu=13 at phi=4: +4.95)
#: -- so the model couples the floor to min(spread, 5.5) rather than
#: tracking spread 1:1
FLOOR_SPREAD_CAP = 5.5


class ModuliChoice(NamedTuple):
    """choose_moduli's answer: the num_moduli dial AND the fastmode argument
    to pass to gemm()/syrk()/summa_gemm(), plus the modeled error."""
    num_moduli: int
    fastmode: Union[bool, str]
    modeled_rel_err: float


def _mode_key(fastmode) -> str:
    if fastmode is True:
        return "fast"
    if fastmode == "robust":
        return "robust"
    if fastmode is False:
        return "accu"
    raise ValueError(f"fastmode must be True, False or 'robust', "
                     f"got {fastmode!r}")


def log2_P(num_moduli: int, backend: str = tables.Backend.INT8) -> float:
    """log2 of the product of the first ``num_moduli`` moduli.

    NOT the same quantity as tables.log2P, which is the reference's shift
    constant log2(P-1)/2 - 0.5 (halved and offset, f32-rounded-down)."""
    mods = tables.moduli(backend)
    if not 1 <= num_moduli <= len(mods):
        raise ValueError(f"num_moduli must be in [1, {len(mods)}]")
    return sum(math.log2(p) for p in mods[:num_moduli])


def _modeled_bits(num_moduli, backend, spread_bits, mode):
    c = CALIBRATED_C[mode] + SPREAD_FACTOR[mode] * spread_bits
    if mode == "fast" and spread_bits > FAST_SPREAD_LIMIT:
        return math.inf          # outside the fast formula's calibrated domain
    return c - log2_P(num_moduli, backend) / 2.0


def modeled_max_rel_err(num_moduli: int, *,
                        backend: str = tables.Backend.INT8,
                        spread_bits: float = 0.0,
                        out_dtype=np.float64,
                        fastmode: Union[bool, str] = True) -> float:
    """Modeled max elementwise relative error at ``num_moduli``/``fastmode``.

    Floored at the output dtype's roundoff (the emulation cannot beat the
    precision of the dtype it returns; ``out_dtype`` numpy or torch, as
    choose_moduli's ``dtype``); ``inf`` for fast mode outside its
    calibrated spread domain (use robust or accurate there).
    """
    bits = _modeled_bits(num_moduli, backend, spread_bits,
                         _mode_key(fastmode))
    real = {"complex64": "float32",
            "complex128": "float64"}.get(_dtype_name(out_dtype),
                                         _dtype_name(out_dtype))
    # spread data lifts the output-rounding floor too, saturating around
    # ~2.5 bits on the committed rows (see FLOOR_SPREAD_CAP)
    floor_bits = (math.log2(np.finfo(np.dtype(real)).eps)
                  + FLOOR_AMPLIFICATION_BITS
                  + min(spread_bits, FLOOR_SPREAD_CAP))
    return 2.0 ** max(bits, floor_bits) if bits != math.inf else math.inf


def choose_moduli(target_rel_err: Optional[float] = None, *,
                  dtype=np.float64,
                  backend: str = tables.Backend.INT8,
                  spread_bits: float = 0.0,
                  margin_bits: float = 3.0) -> ModuliChoice:
    """Cheapest (num_moduli, fastmode) whose modeled error beats the target.

    Args:
      target_rel_err: desired max elementwise relative error. ``None`` means
        "match the native GEMM of ``dtype``" (f64: ~2^-36; f32: ~2^-10 --
        the measured native max-rel-err on protocol data, which is what the
        reference's accuracy tables compare against).
      dtype: output dtype (numpy, or torch's float32, float64, complex64,
        complex128); bounds the valid num_moduli range
        (tables.VALID_RANGE, reference include/gemmul8.hpp:30) and the
        roundoff floor.
      backend: "INT8" (default) or "FP8".
      spread_bits: the data's exponent spread (protocol mapping:
        ~5.5 * phi; 0 for normal-ish data).
      margin_bits: safety margin on top of the calibrated model (default 3).

    Returns:
      ModuliChoice(num_moduli, fastmode, modeled_rel_err). The chooser
      prefers the cheapest num_moduli; between fast and robust (identical
      runtime cost) it takes whichever models fewer moduli, breaking ties
      toward fast (reference parity). Accurate mode costs an extra
      estimation GEMM and is never auto-chosen; pass fastmode=False
      yourself when you need its intercept.

    Raises:
      ValueError: if no valid setting reaches the target; the message
        reports the best achievable modeled error.
    """
    dname = _dtype_name(dtype)
    if dname not in tables.VALID_RANGE:
        raise TypeError(f"unsupported dtype {dname}")
    lo, hi = tables.VALID_RANGE[dname]
    real = {"complex64": "float32", "complex128": "float64"}.get(dname, dname)
    if target_rel_err is None:
        target_rel_err = 2.0 ** NATIVE_ERR_BITS[dname]
    if target_rel_err <= 0:
        raise ValueError("target_rel_err must be positive")
    target_bits = math.log2(target_rel_err)
    # the output dtype's own rounding (amplified by the data's exponent
    # spread -- see modeled_max_rel_err) caps what any num_moduli can
    # deliver: refuse rather than under-deliver
    floor_bits = (math.log2(np.finfo(np.dtype(real)).eps)
                  + FLOOR_AMPLIFICATION_BITS
                  + min(spread_bits, FLOOR_SPREAD_CAP))
    if target_bits < floor_bits:
        raise ValueError(
            f"target 2^{target_bits:.1f} is below the {real} output floor "
            f"(~2^{floor_bits:.1f}: dtype roundoff plus protocol-data "
            f"amplification at spread_bits={spread_bits:g}); use a wider "
            f"output dtype or relax the target")
    best = math.inf
    for nu in range(lo, hi + 1):
        for mode, fm in (("fast", True), ("robust", "robust")):
            bits = (_modeled_bits(nu, backend, spread_bits, mode)
                    + margin_bits)
            best = min(best, bits)
            if bits <= target_bits:
                return ModuliChoice(nu, fm, 2.0 ** max(bits, floor_bits))
    raise ValueError(
        f"no num_moduli in [{lo}, {hi}] reaches target 2^{target_bits:.1f} "
        f"for {dname}/{backend} (best modeled: 2^{best:.1f}); consider "
        f"fastmode=False (accurate mode) or relaxing the target")
