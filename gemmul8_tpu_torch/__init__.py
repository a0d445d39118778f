"""gemmul8_tpu_torch: the PyTorch/CUDA port of gemmul8_tpu.

Emulated SGEMM/DGEMM and CGEMM/ZGEMM (Ozaki scheme II, fast, robust and
accurate mode; INT8 residue planes, or for real operands the FP8 backend's
e4m3 split planes; complex through the 3M scheme), syrk, herk and batched
GEMM on an NVIDIA H100, with hand-written CUDA kernels for the residue-plane
encoders, the fused mod + CRT + descale epilogues and the complex epilogues.
Bit-equal to gemmul8_tpu on the CPU.
"""
from .complex_gemm import gemm_batched_planar, gemm_planar, herk, herk_planar
from .core import gemm, gemm_batched, matmul, syrk
from .kernels import LAUNCHES, reset_launches
from .tables import Backend

__all__ = ["gemm", "matmul", "syrk", "gemm_batched", "gemm_planar",
           "gemm_batched_planar", "herk", "herk_planar", "Backend",
           "LAUNCHES", "reset_launches"]
