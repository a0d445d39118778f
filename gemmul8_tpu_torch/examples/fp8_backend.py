"""FP8-backend DGEMM: residues split into fp8-e4m3-exact pairs and triples
(the port of examples/fp8_backend.py).

Analog of the reference's Backend::FP8 sample (sample/dgemm_cuBLASLt_fp8.cu):
the wide FP8 moduli (up to 1089) pack about 10 bits per modulus against
INT8's 8, so fewer moduli reach the same accuracy (nu=13 about native f64).
On the card the planes are e4m3 and the products run on the FP8 tensor
cores (torch._scaled_mm).

    python -m gemmul8_tpu_torch.examples.fp8_backend [--device cpu]
"""
import numpy as np

import gemmul8_tpu_torch as gt

from . import cli, device_of, to_numpy


def main(device=None) -> dict:
    device = device_of(device)
    rng = np.random.default_rng(5)
    a = rng.standard_normal((48, 256))
    b = rng.standard_normal((256, 32))
    ref = a @ b
    out = {}
    for nu in (6, 9, 13):
        c = to_numpy(gt.gemm(a, b, num_moduli=nu, backend="FP8",
                             device=device))
        err = np.max(np.abs(c - ref) / np.abs(ref))
        print(f"FP8 backend nu={nu:2d}: max rel err {err:.3e}")
        out[nu] = dict(c=c, err=err)
    print("OK")
    return out


if __name__ == "__main__":
    cli(main)
