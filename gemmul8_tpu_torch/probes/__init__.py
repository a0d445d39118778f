"""Counterparts of the JAX package's probe tools, run on the card.

  fused     tools/probe_fused.py     the batched exact int8 product,
                                     K-sequential and A-stationary
  matmul3   tools/probe_matmul3.py   the same product on flat plane views
  epilogue  tools/probe_epilogue.py  the tensor-core CRT epilogue against K2

the five benchmarks

  accuracy      benchmarks/accuracy.py      the k x phi x nu error sweep
                                            against a longdouble oracle
  flops         benchmarks/flops.py         square sizes x nu TFLOP/s with
                                            the four phases
  big_flops     benchmarks/big_flops.py     16384^3 through the striped
                                            driver under a budget
  power         benchmarks/power.py         watts and GFLOPS/W from one
                                            streaming nvidia-smi
  solver_flops  benchmarks/solver_flops.py  getrf, potrf, geqrf TFLOP/s
                                            beside cuSOLVER's

the public API's on-hardware checks

  device_stress  tools/device_stress.py      random gemm and gemm_planar
                                             trials against the host f64
                                             product (--against-cpu: and
                                             the CPU path's bits)
  blas3_perf     tools/probe_blas3_perf.py   syr2k and her2k against the
                                             naive two-GEMM forms, timed

and, with no tool behind it,

  epilogue_tiles                     the design choices of K2, K4, K6
                                     and K8, each undone in turn and timed
  summa_mesh                         chip_smoke.py's SUMMA cases on a mesh
                                     of ranks sharing the card (a worker
                                     module, no table of its own)

Each runs as `python -m gemmul8_tpu_torch.probes.<name>` on a CUDA card and
prints a table (the benchmarks and blas3_perf write their CSV under
gemmul8_tpu_torch/_results/, power prints JSON; device_stress prints a
line a trial and exits 1 on a failure); chip_smoke.py drives the tools'
and the benchmarks' functions and reads the rows they return.
"""
