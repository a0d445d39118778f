"""The examples of the JAX package (examples/*.py), on the port: one module
per script, under the same name, with the script's sizes, seeds, printed
lines, asserts and final OK.

    python -m gemmul8_tpu_torch.examples.<name> [--device cpu]

  dgemm_int8            the exact 4x3x5 golden DGEMM
  fp8_backend           nu 6, 9 and 13 on backend="FP8"
  planar_complex        gemm_planar with trans_a="C" against gemm
  compat_gemmlt         compat.gemm, gemmLt and workSize on column-major
                        ld-strided buffers
  blas3_tour            syr2k, her2k, symm, hemm, trtri
  iterative_refinement  an f32 inverse refined with emulated residuals
  lu_solver             solve at nu=14 and nu=6 with refinement, trsm
  dense_linalg          qr, lstsq, svd, eigh, inv and the nu dial
  hook_training         an MLP trained under the interposer, twice
  distributed_summa     SUMMA over a torch.distributed mesh (torchrun for
                        more than one rank)

Each module's main(device=None) runs on the card ("cuda") unless the caller
passes device="cpu", and returns the arrays and numbers it prints or
asserts on.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import core


def device_of(device) -> torch.device:
    """The example's device: the card unless `device` names another; the
    card raises when CUDA is not available."""
    return core._device("cuda" if device is None else device)


def to_numpy(x) -> np.ndarray:
    """A tensor's values as a numpy array on the host."""
    return x.detach().cpu().resolve_conj().numpy()


def cli(main, argv=None):
    """Run an example's main() from the command line."""
    ap = argparse.ArgumentParser(description=main.__module__)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    return main(device=args.device)
