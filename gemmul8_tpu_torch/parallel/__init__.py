"""Distributed emulated GEMM over a torch.distributed device mesh (the
counterpart of gemmul8_tpu/parallel/)."""
from .summa import (make_mesh, summa_bytes_moved, summa_gemm,  # noqa: F401
                    summa_gemm_planar, summa_work_bytes)

__all__ = ["summa_gemm", "summa_gemm_planar", "make_mesh", "summa_work_bytes",
           "summa_bytes_moved"]
