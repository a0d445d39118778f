"""The benchmark of gemmul8_tpu_torch on one NVIDIA H100 (BENCHMARK.json at
the root of the checkout names its cells): run one with
`python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`."""
