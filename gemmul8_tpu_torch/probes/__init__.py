"""Counterparts of the JAX package's probe tools, run on the card.

  fused     tools/probe_fused.py     the batched exact int8 product,
                                     K-sequential and A-stationary
  matmul3   tools/probe_matmul3.py   the same product on flat plane views
  epilogue  tools/probe_epilogue.py  the tensor-core CRT epilogue against K2

the factorization benchmark

  solver_flops  benchmarks/solver_flops.py  getrf, potrf, geqrf TFLOP/s
                                            beside cuSOLVER's

and, with no tool behind it,

  epilogue_tiles                     the design choices of K2, K4, K6
                                     and K8, each undone in turn and timed
  summa_mesh                         chip_smoke.py's SUMMA cases on a mesh
                                     of ranks sharing the card (a worker
                                     module, no table of its own)

Each runs as `python -m gemmul8_tpu_torch.probes.<name>` on a CUDA card and
prints a table; chip_smoke.py drives the first three's main() functions and
reads the rows they return.
"""
