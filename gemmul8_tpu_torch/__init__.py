"""gemmul8_tpu_torch: the PyTorch/CUDA port of gemmul8_tpu.

Emulated SGEMM/DGEMM and CGEMM/ZGEMM (Ozaki scheme II, fast mode; INT8
residue planes, or for real operands the FP8 backend's e4m3 split planes;
complex through the 3M scheme) and herk on an NVIDIA H100, with hand-written
CUDA kernels for the residue-plane encoders, the fused mod + CRT + descale
epilogues and the complex epilogues. Bit-equal to gemmul8_tpu on the CPU.
"""
from .complex_gemm import gemm_planar, herk, herk_planar
from .core import gemm, matmul
from .kernels import LAUNCHES, reset_launches
from .tables import Backend

__all__ = ["gemm", "matmul", "gemm_planar", "herk", "herk_planar", "Backend",
           "LAUNCHES", "reset_launches"]
