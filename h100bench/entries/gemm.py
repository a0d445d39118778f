"""The entry a user calls: gemmul8_tpu_torch.gemm (complex operands route
to complex_gemm.gemm_complex inside it), with the configuration's mode and
the mix's alpha, beta and C."""
from __future__ import annotations


def make(config: dict, traffic: dict, device):
    """call(ops) -> alpha op(A) op(B) + beta C from the program."""
    import gemmul8_tpu_torch as gt

    kw = dict(num_moduli=config["num_moduli"], fastmode=config["fastmode"],
              backend=config["backend"], epilogue=config["epilogue"],
              alpha=traffic["alpha"], beta=traffic["beta"], device=device)

    def call(ops):
        return gt.gemm(ops["a"], ops["b"], c=ops["c"], **kw)

    return call
