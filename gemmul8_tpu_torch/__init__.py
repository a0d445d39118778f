"""gemmul8_tpu_torch: the PyTorch/CUDA port of gemmul8_tpu.

Emulated SGEMM/DGEMM (Ozaki scheme II, INT8 residue planes, fast mode) on an
NVIDIA H100, with hand-written CUDA kernels for the residue-plane encoder and
the fused mod + CRT + descale epilogue. Bit-equal to gemmul8_tpu on the CPU.
"""
from .core import gemm, matmul
from .kernels import LAUNCHES, reset_launches
from .tables import Backend

__all__ = ["gemm", "matmul", "Backend", "LAUNCHES", "reset_launches"]
