"""The least time of each stage of an emulated GEMM on the FP8 backend on one
H100, under the conventions of counts.py (its peaks and its bound): K6's
encode into e4m3 split planes, the 3nu FP8 products into an f32 stack, and
K3's reassembly and CRT. Counted from the shapes by the algorithm, never read
from a kernel. The FP8 moduli, their split and the limb counts are written
out here, as counts.py writes out the INT8 ones, so that no change to the
program moves the yardstick.

The per-layer rooflines of the FP8 cells read the device time of the
program's own spans (spans.device_ms): roofline_pct divides a stage's least
time by it.
"""
from __future__ import annotations

from h100bench import counts, spans

# the FP8 backend's moduli, in order (the reference's table.hpp): the first
# NOT_KARATSUBA are perfect squares, split by their square roots; the rest
# take the Karatsuba triple of base 16
FP8_MODULI = (1089, 1024, 961, 841, 625, 529, 511, 509, 503, 499, 491, 487,
              481, 479, 467, 463, 461, 457, 449, 443)
NOT_KARATSUBA = 6
# 20-bit limbs of the encoder's scaled integer, by the number of moduli
ENCODE_LIMBS = {2: 2, 3: 2, 4: 3, 5: 3, 6: 3, 7: 3, 8: 4, 9: 4, 10: 4,
                11: 4, 12: 4, 13: 5, 14: 5, 15: 5, 16: 5, 17: 6, 18: 6,
                19: 6, 20: 6}
# 16-bit limbs of the epilogue's CRT accumulator on the FP8 plan, by output
# mantissa bits and the number of moduli
EPILOGUE_LIMBS = {
    53: {2: 3, 3: 3, 4: 4, 5: 5, 6: 5, 7: 6, 8: 6, 9: 7, 10: 7, 11: 7,
         12: 7, 13: 7, 14: 7, 15: 7, 16: 7, 17: 7, 18: 7, 19: 7, 20: 7},
    24: {2: 3, 3: 3, 4: 4, 5: 5, 6: 5, 7: 5, 8: 5, 9: 5, 10: 5, 11: 5,
         12: 5, 13: 5},
}
# the products of the e4m3 planes stay exact in f32 while k <= 2^16
K_CHUNK = 1 << 16
# NVIDIA H100 SXM data sheet: the dense e4m3 tensor-core rate, equal to int8's
PEAK_FP8_OPS = 1979e12
# per FP8 modulus and element, the encoder's split of the residue and its
# emission: for a square modulus a conversion, two multiplies, rint and a
# subtraction; for a Karatsuba one |r|, an add, a shift, a sign select (2), a
# shift and a subtraction, an add and three conversions to f32 (about 8
# either way); then three conversions to e4m3 and three stores
SPLIT_OPS = 8 + 3 + 3


def _moduli_ops(nu: int, per_modulus: int, per_pow2: int) -> int:
    """The sum over the first nu FP8 moduli of per_modulus, or per_pow2 for
    the power-of-two modulus 1024."""
    return sum(per_pow2 if p & (p - 1) == 0 else per_modulus
               for p in FP8_MODULI[:nu])


def encode(rows: int, cols: int, n_shifts: int, nu: int,
           itemsize: int) -> tuple[float, str]:
    """One K6 encode of a (rows, cols) real operand into 3nu e4m3 planes.
    Bytes: the operand read once, its n_shifts int32 shifts, the planes
    written once. 32-bit operations per element: counts.encode's chain up to
    the moduli (loads, the f32 scale, the components, the carry) on the FP8
    limbs; per modulus the limb dot (nl - 1 multiply-adds), the reduction
    (4) and the wrap (2), or a 3-op mask for p = 1024; then the split
    (SPLIT_OPS). f64 operations: as counts.encode."""
    nl = ENCODE_LIMBS[nu]
    f64 = itemsize == 8
    ops32 = (2 + (0 if f64 else 3) + (3 if f64 else 1) * 20 + 2
             + 4 * (nl - 1) + _moduli_ops(nu, nl - 1 + 6, 3)
             + SPLIT_OPS * nu)
    ops64 = 10 if f64 else 0
    n = rows * cols
    return counts.bound(n * ops32, n * ops64,
                        n * (itemsize + 3 * nu) + 4 * n_shifts)


def products(nu: int, m: int, n: int, k: int) -> tuple[float, str]:
    """The 3nu exact e4m3 products (m, k) x (k, n) -> f32: 2 m n k
    tensor-core operations each at the FP8 rate, or the planes read once
    and the f32 products written once."""
    t_ops = 2.0 * 3 * nu * m * n * k / PEAK_FP8_OPS
    t_bytes = 3 * nu * (m * k + k * n + 4 * m * n) / counts.PEAK_BYTES
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def _reassemble_ops(nu: int) -> int:
    """32-bit operations per element of K3's reassembly in exact f32 steps:
    per modulus each of the three lane products brought near its wrap (3
    each); the recombine (square: 2; Karatsuba: 3); the final wrap (4), or
    for p = 1024 the bias add and a 2-op mask (3)."""
    return sum(9 + (2 if i < NOT_KARATSUBA else 3)
               + (3 if p & (p - 1) == 0 else 4)
               for i, p in enumerate(FP8_MODULI[:nu]))


def epilogue(m: int, n: int, nu: int, out_bits: int) -> tuple[float, str]:
    """One K3 epilogue of 3nu f32 lane products at (m, n). Bytes: the
    products read once, the shifts, the output written once. 32-bit
    operations per element: 3nu loads, two shift loads and the store; the
    reassembly; one CRT pipeline on the FP8 plan's limbs (counts._crt_ops).
    f64 operations (f64 out): 5 per limb."""
    L = EPILOGUE_LIMBS[out_bits][nu]
    f64 = out_bits == 53
    ops32 = 3 * nu + 3 + _reassemble_ops(nu) + counts._crt_ops(nu, L, f64)
    bytes_ = m * n * (12 * nu + (8 if f64 else 4)) + 4 * (m + n)
    return counts.bound(m * n * ops32, m * n * (5 * L if f64 else 0), bytes_)


def stages(config: dict, traffic: dict) -> dict[str, tuple[float, str]]:
    """The least time of one real FP8 call's stages, in seconds, with what
    bounds each: K6 on A and on B, the 3nu products, K3. Only the route with
    k <= 2^16 (one product stack, then K3) is counted."""
    m, n, k = traffic["m"], traffic["n"], traffic["k"]
    nu = config["num_moduli"]
    itemsize, out_bits, is_complex = counts.DTYPES[config["dtype"]]
    if config["backend"] != "FP8" or is_complex:
        raise ValueError("FP8 counts cover the real FP8 backend only")
    if k > K_CHUNK:
        raise ValueError(f"FP8 counts cover k <= {K_CHUNK} (one K3 epilogue)")
    enc_a, enc_b = encode(m, k, m, nu, itemsize), encode(k, n, n, nu, itemsize)
    return {"encode": (enc_a[0] + enc_b[0],
                       enc_a[1] if enc_a[1] == enc_b[1] else "mixed"),
            "products": products(nu, m, n, k),
            "epilogue": epilogue(m, n, nu, out_bits)}


def roofline_pct(ctx, stage: str, layer: str):
    """A stage's share of its roofline: the least time stages() gives it
    from the cell's shapes, times the traced calls, over the device time of
    the program's `layer` spans in them (%); None where the run holds no
    span to read."""
    ms = spans.device_ms(ctx, layer)
    if not ms:
        return None
    return 100.0 * stages(ctx.config, ctx.traffic)[stage][0] * 1e3 / ms
