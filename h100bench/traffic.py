"""The one generator of the benchmark's operands: it reads a mix's
traffic/<mix>.json and a configuration's dtype, and makes every operand on
the device from the seed, each matrix in one or two large calls of a
torch.Generator on that device.

A mix names m, n, k, phi (the reference's difficulty: phi < 0 standard
normal, else (U - 0.5) exp(phi N), testing/make_matrix.hpp:73-79; a complex
matrix takes two such parts), alpha and beta, whether C is given, and how
many operand sets the calls take in turn, so that no call finds its inputs
in L2 from the call before.
"""
from __future__ import annotations

import hashlib

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "complex128": torch.complex128, "complex64": torch.complex64}


def substream(seed: int, *parts) -> int:
    """A 63-bit generator seed for one matrix, from the run's seed and the
    matrix's place: the same seed gives the same inputs."""
    h = hashlib.blake2b(repr((int(seed), *parts)).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def phi_matrix(gen: torch.Generator, rows: int, cols: int, phi: float,
               dtype: torch.dtype) -> torch.Tensor:
    """A (rows, cols) matrix of `dtype` on gen's device."""
    real = torch.empty(0, dtype=dtype).real.dtype
    parts = 2 if dtype.is_complex else 1
    shape = (parts, rows, cols)
    z = torch.randn(shape, generator=gen, dtype=real, device=gen.device)
    if phi >= 0:
        u = torch.rand(shape, generator=gen, dtype=real, device=gen.device)
        z = (u - 0.5) * torch.exp(z * phi)
    return torch.complex(z[0], z[1]) if dtype.is_complex else z[0]


def operand_sets(traffic: dict, dtype_name: str, seed: int,
                 device) -> list[dict]:
    """traffic["operand_sets"] sets of {"a", "b", "c"} (c None unless the mix
    gives C), each matrix from its own substream of the seed."""
    dtype = DTYPES[dtype_name]
    m, n, k, phi = traffic["m"], traffic["n"], traffic["k"], traffic["phi"]
    shapes = {"a": (m, k), "b": (k, n)}
    if traffic["c"]:
        shapes["c"] = (m, n)
    gen = torch.Generator(device=device)
    sets = []
    for s in range(traffic["operand_sets"]):
        ops = {"c": None}
        for name, (rows, cols) in shapes.items():
            gen.manual_seed(substream(seed, s, name))
            ops[name] = phi_matrix(gen, rows, cols, phi, dtype)
        sets.append(ops)
    return sets
