"""gemmul8_tpu_torch: the PyTorch/CUDA port of gemmul8_tpu.

Emulated SGEMM/DGEMM and CGEMM/ZGEMM (Ozaki scheme II, fast, robust and
accurate mode; INT8 residue planes or the FP8 backend's e4m3 split planes;
complex through the 3M scheme), syrk, herk, batched GEMM and the rest of
BLAS level 3 built on GEMM (syr2k, her2k, symm, hemm) on an NVIDIA H100,
with hand-written CUDA kernels for the residue-plane encoders (complex: one
lane encoder for Re, Im and Re+Im on each backend), the fused mod + CRT +
descale epilogues, the FP8 reassembly and the complex epilogues. Precomputed
operands (precompute/gemm_quantized), memory-bounded striping of big real
products, per-phase timing, the reference's compat entries
(compat.gemm/gemmLt/workSize), a matmul interposer for torch programs
(install/emulate), the accuracy model and num_moduli chooser
(choose_moduli, modeled_max_rel_err) and the comparison baselines
(compare.matmul_bf16x9, compare.matmul_os1_int8), the dense solvers on
the emulated GEMM: triangular solve and product, LU and Cholesky with their
solves, inverse, iterative refinement (trsm, trmm, getrf, lu_solve, solve,
potrf, potrs, posv, inv, trtri), blocked Householder QR and least squares
(geqrf, ormqr, qr, lstsq) and the block-Jacobi svd and eigh, and the
distributed SUMMA GEMM over a torch.distributed device mesh
(gemmul8_tpu_torch.parallel: summa_gemm, summa_gemm_planar, make_mesh),
which the solvers' mesh= argument runs their updates through.
Bit-equal to gemmul8_tpu on the CPU; the solvers' small native pieces
(torch.linalg) are the one exception, so they are equal given the same
native results.
"""
from . import compare, compat, tables
from .accuracy_model import choose_moduli, modeled_max_rel_err
from .blas3 import (hemm, hemm_planar, her2k, her2k_planar, symm,
                    symm_planar, syr2k)
from .complex_gemm import gemm_batched_planar, gemm_planar, herk, herk_planar
from .config import GemmConfig, env_config
from .core import (QuantizedOperand, gemm, gemm_batched, gemm_quantized,
                   gemm_with_phases, matmul, precompute, syrk, work_bytes)
from .eig import eigh, svd
from .hook import emulate, install, refresh, uninstall
from .kernels import LAUNCHES, reset_launches
from .qr import geqrf, lstsq, ormqr, qr
from .solvers import (getrf, inv, lu_solve, posv, potrf, potrs, solve, trmm,
                      trsm, trtri)
from .tables import Backend

__all__ = ["gemm", "matmul", "syrk", "gemm_batched", "gemm_planar",
           "gemm_batched_planar", "herk", "herk_planar", "precompute",
           "gemm_quantized", "QuantizedOperand", "work_bytes",
           "gemm_with_phases", "GemmConfig", "env_config", "compat",
           "install", "uninstall", "refresh", "emulate", "Backend",
           "tables", "compare", "choose_moduli", "modeled_max_rel_err",
           "syr2k", "her2k", "symm", "hemm", "her2k_planar", "hemm_planar",
           "symm_planar", "trsm", "trmm", "getrf", "lu_solve", "solve",
           "potrf", "potrs", "posv", "inv", "trtri", "geqrf", "ormqr", "qr",
           "lstsq", "svd", "eigh", "LAUNCHES", "reset_launches"]
