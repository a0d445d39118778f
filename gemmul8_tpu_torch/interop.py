"""torch_gemm and emulate_torch: the names of gemmul8_tpu/interop.py, here
thin ones over the emulator and the hook's mode, on CUDA and CPU tensors
alike, with no numpy or JAX round trip.

  * ``torch_gemm(a, b, ...)``: emulated A @ B of two 2-D tensors on their
    device (the emulator of core.gemm, whose bits it gives), differentiable
    for real and complex dtypes (hook.emulated_matmul);
  * ``emulate_torch(...)``: hook.emulate, the context manager that routes
    eligible matmuls (``a @ b``, torch.matmul/mm/bmm, F.linear and so
    nn.Linear) through the emulator.

Unlike the JAX package's versions these take CUDA tensors, differentiate
complex products (torch's convention), and materialize a tensor's conjugate
or negative bit instead of failing on it (interop.py:180).
"""
from __future__ import annotations

import torch

from . import config, hook, tables


def torch_gemm(a: torch.Tensor, b: torch.Tensor, *, num_moduli: int | None = 8,
               fastmode=True, backend: str = tables.Backend.INT8):
    """Emulated C = A @ B of 2-D f32/f64/c64/c128 tensors of one dtype on
    one device (CUDA or the CPU), differentiable. num_moduli=None reads the
    GEMMUL8_* environment contract of the dtype."""
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        raise TypeError("torch_gemm expects torch tensors")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"torch_gemm expects 2-D tensors, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    name = hook._ELIGIBLE.get(a.dtype)
    if name is None or a.dtype != b.dtype:
        raise TypeError(f"unsupported/mismatched dtypes {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if num_moduli is None:
        cfg = config.env_config(name)
    else:
        cfg = config.GemmConfig(num_moduli=num_moduli, fastmode=fastmode,
                                backend=backend)
        cfg = cfg if cfg.validate(name) else None
    if cfg is None:
        raise ValueError(f"num_moduli={num_moduli} out of range for {name}")
    return hook.emulated_matmul(a, b, cfg)


def emulate_torch(num_moduli: int | None = 8, fastmode=True,
                  backend: str = tables.Backend.INT8) -> hook.emulate:
    """Context manager: inside the block, eligible torch matmuls run through
    the emulated GEMM (hook.emulate); ``mode.intercepted`` counts them.
    num_moduli=None defers to the GEMMUL8_* environment contract."""
    return hook.emulate(num_moduli, fastmode, backend)
