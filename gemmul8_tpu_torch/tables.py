"""Typed accessors for the CRT/moduli constant tables.

The counterpart of gemmul8_tpu/tables.py for the rows the real INT8 fast path
reads: moduli lists, P = -prod(p) in double-double and as exact 26-bit chunks,
invP, log2P (f32 round-down) and the CRT coefficients qPi in f64 and
double-double form. The data module is a verbatim copy of the JAX package's
generated literals, so every accessor is bit-equal to its counterpart.
"""
from __future__ import annotations

import functools

import numpy as np

from . import _tables_data as D

NUM_MODULI_MAX = D.NUM_MODULI_MAX
MAX_EXP = D.MAX_EXP
NOT_KARATSUBA = D.NOT_KARATSUBA

#: valid num_moduli range per output dtype (reference: include/gemmul8.hpp:30)
VALID_RANGE = {"float32": (2, 13), "float64": (2, 20),
               "complex64": (2, 13), "complex128": (2, 20)}


class Backend:
    """Low-precision plane encoding. INT8 runs on the int8 tensor cores."""
    INT8 = "INT8"
    FP8 = "FP8"


@functools.lru_cache(maxsize=None)
def moduli(backend: str = Backend.INT8) -> tuple[int, ...]:
    return tuple(getattr(D, f"MODULI_{backend}"))


@functools.lru_cache(maxsize=None)
def p_is_double(backend: str = Backend.INT8) -> int:
    """num_moduli threshold at/below which P fits a single f64 in the CRT wrap."""
    return getattr(D, f"P_IS_DOUBLE_{backend}")


@functools.lru_cache(maxsize=None)
def P_dd(num_moduli: int, backend: str = Backend.INT8) -> tuple[float, float]:
    """(hi, lo) double-double of -prod(moduli[:num_moduli])."""
    return tuple(getattr(D, f"P_DD_{backend}")[num_moduli - 2])


@functools.lru_cache(maxsize=None)
def P_q26(num_moduli: int, backend: str = Backend.INT8) -> tuple[float, float, float]:
    """(Pa, Pb, Pc): -prod as exact 26-bit chunks Pa, Pb plus RN remainder Pc.
    Pa*q, Pb*q are exact f64 products for |q| < 2^26."""
    return tuple(getattr(D, f"P_Q26_{backend}")[num_moduli - 2])


@functools.lru_cache(maxsize=None)
def invP(num_moduli: int, backend: str = Backend.INT8) -> float:
    return getattr(D, f"INVP_{backend}")[num_moduli - 2]


@functools.lru_cache(maxsize=None)
def log2P(num_moduli: int, backend: str = Backend.INT8) -> float:
    """f32 round-down of log2(P-1)/2 - 0.5 (as f64-representable value)."""
    return getattr(D, f"LOG2P_{backend}")[num_moduli - 2]


@functools.lru_cache(maxsize=None)
def qPi_f64(num_moduli: int, backend: str = Backend.INT8) -> np.ndarray:
    """[num_moduli] f64 CRT coefficients q_i * P/p_i (RN)."""
    return np.asarray(getattr(D, f"QPI_1_{backend}")[num_moduli - 2], dtype=np.float64)


@functools.lru_cache(maxsize=None)
def qPi_dd(num_moduli: int, backend: str = Backend.INT8) -> np.ndarray:
    """[num_moduli, 2] double-double CRT coefficients (common-grid split: the hi
    parts accumulate error-free against int8 residues)."""
    return np.asarray(getattr(D, f"QPI_2_{backend}")[num_moduli - 2], dtype=np.float64)
