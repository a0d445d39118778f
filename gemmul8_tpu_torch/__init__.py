"""gemmul8_tpu_torch: the PyTorch/CUDA port of gemmul8_tpu.

Emulated SGEMM/DGEMM and CGEMM/ZGEMM (Ozaki scheme II, fast, robust and
accurate mode; INT8 residue planes, or for real operands the FP8 backend's
e4m3 split planes; complex through the 3M scheme), syrk, herk and batched
GEMM on an NVIDIA H100, with hand-written CUDA kernels for the residue-plane
encoders, the fused mod + CRT + descale epilogues and the complex epilogues.
Precomputed operands (precompute/gemm_quantized), memory-bounded striping of
big real products, per-phase timing, the reference's compat entries
(compat.gemm/gemmLt/workSize) and a matmul interposer for torch programs
(install/emulate). Bit-equal to gemmul8_tpu on the CPU.
"""
from . import compat
from .complex_gemm import gemm_batched_planar, gemm_planar, herk, herk_planar
from .config import GemmConfig, env_config
from .core import (QuantizedOperand, gemm, gemm_batched, gemm_quantized,
                   gemm_with_phases, matmul, precompute, syrk, work_bytes)
from .hook import emulate, install, refresh, uninstall
from .kernels import LAUNCHES, reset_launches
from .tables import Backend

__all__ = ["gemm", "matmul", "syrk", "gemm_batched", "gemm_planar",
           "gemm_batched_planar", "herk", "herk_planar", "precompute",
           "gemm_quantized", "QuantizedOperand", "work_bytes",
           "gemm_with_phases", "GemmConfig", "env_config", "compat",
           "install", "uninstall", "refresh", "emulate", "Backend",
           "LAUNCHES", "reset_launches"]
