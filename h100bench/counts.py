"""The least time each stage of an emulated GEMM could take on one H100: the
larger of its operations over the published peak and its bytes over the
memory bandwidth, counted from the shapes by the algorithm and never read
from a kernel, so that the count stays whatever implements the stage.

Each count follows the Ozaki-scheme-II step it bounds: every input byte read
once, every output byte written once, and per element the 32-bit and f64
operations the step cannot do without (the conventions of the port's
chip_smoke.py bounds, which PERF.md's kernel table uses). The moduli and the
limb counts are the INT8 backend's, written out here so that no change to the
program moves the yardstick.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit: the int8
# tensor-core rate, HBM3 bandwidth, 32-bit operations outside the tensor
# cores (67 TFLOP/s of f32 counting an FMA as two) and f64 operations outside
# the tensor cores (34 TFLOP/s, FMA as two)
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
PEAK_OPS32 = 67e12 / 2
PEAK_OPS64 = 34e12 / 2

# the INT8 backend's moduli, in order (the reference's table.hpp)
INT8_MODULI = (256, 255, 253, 251, 247, 241, 239, 233, 229, 227, 223, 217,
               211, 199, 197, 193, 191, 181, 179, 173)
# 20-bit limbs of the encoder's scaled integer, by the number of moduli
ENCODE_LIMBS = {2: 2, 3: 2, 4: 2, 5: 3, 6: 3, 7: 3, 8: 3, 9: 3, 10: 4,
                11: 4, 12: 4, 13: 4, 14: 4, 15: 5, 16: 5, 17: 5, 18: 5,
                19: 5, 20: 6}
# 16-bit limbs of the epilogue's CRT accumulator, by output mantissa bits
# and the number of moduli
EPILOGUE_LIMBS = {
    53: {2: 2, 3: 3, 4: 3, 5: 4, 6: 4, 7: 5, 8: 5, 9: 6, 10: 6, 11: 7,
         12: 7, 13: 7, 14: 7, 15: 7, 16: 7, 17: 7, 18: 7, 19: 7, 20: 7},
    24: {2: 2, 3: 3, 4: 3, 5: 4, 6: 4, 7: 5, 8: 5, 9: 5, 10: 5, 11: 5,
         12: 5, 13: 5},
}
# per modulus, the 3M recombine from three wrapped lanes: re, a subtraction
# and two conditional corrections (compare and select, 2 each); im, two
# subtractions and the same corrections
RECOMBINE_OPS = 5 + 6

# dtype name -> (bytes of one real component, mantissa bits, complex)
DTYPES = {"float64": (8, 53, False), "float32": (4, 24, False),
          "complex128": (8, 53, True), "complex64": (4, 24, True)}


def bound(ops32: float, ops64: float, bytes_: float) -> tuple[float, str]:
    """(seconds, "operations" or "bytes"): the larger least time."""
    t_ops = max(ops32 / PEAK_OPS32, ops64 / PEAK_OPS64)
    t_bytes = bytes_ / PEAK_BYTES
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def _moduli_ops(nu: int, per_modulus: int, per_pow2: int) -> int:
    """The sum over the first nu moduli of per_modulus, or per_pow2 for the
    power-of-two modulus 256."""
    return sum(per_pow2 if p & (p - 1) == 0 else per_modulus
               for p in INT8_MODULI[:nu])


def encode(rows: int, cols: int, n_shifts: int, nu: int,
           itemsize: int) -> tuple[float, str]:
    """One encode of a (rows, cols) real operand into nu int8 planes. Bytes:
    the operand read once, its n_shifts int32 shifts, the planes written
    once. 32-bit operations per element: two loads; for f32 the scale (3
    multiplies); per f32 component 20 (sign, exponent and mantissa fields,
    the clamped bit position, limb index and offset, the mantissa's two limb
    parts, the fraction into the joint carry, two limb adds); the carry's
    floor (2); a balanced carry pass (4 per limb boundary); per modulus the
    limb dot (nl - 1 multiply-adds), the reduction (4), the wrap (2) and the
    store (1), or for p = 256 a mask (3) and the store. f64 operations per
    element (f64 input): the scale (3 multiplies) and the split into three
    f32 components (3 conversions down, 2 up, 2 subtractions)."""
    nl = ENCODE_LIMBS[nu]
    f64 = itemsize == 8
    ops32 = (2 + (0 if f64 else 3) + (3 if f64 else 1) * 20 + 2
             + 4 * (nl - 1) + _moduli_ops(nu, nl - 1 + 7, 4))
    ops64 = 10 if f64 else 0
    n = rows * cols
    return bound(n * ops32, n * ops64, n * (itemsize + nu) + 4 * n_shifts)


def products(count: int, m: int, n: int, k: int) -> tuple[float, str]:
    """`count` exact int8 products (m, k) x (k, n) -> int32: 2 m n k
    tensor-core operations each at the int8 rate, or the planes read once
    and the int32 products written once."""
    t_ops = 2.0 * count * m * n * k / PEAK_INT8_OPS
    t_bytes = count * (m * k + k * n + 4 * m * n) / PEAK_BYTES
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def _crt_ops(nu: int, L: int, f64: bool) -> int:
    """32-bit operations per element of one CRT pipeline from wrapped
    residues to the output value: L multiply-adds per modulus into the limbs;
    two carry passes (4 per limb boundary); the quotient from the top three
    limbs (8); the fold (L multiply-adds); the emit, per limb: f32 out 14 and
    a final add, f64 out 13."""
    return nu * L + 8 * (L - 1) + 8 + L + (13 * L if f64 else 14 * L + 1)


def epilogue(m: int, n: int, nu: int, out_bits: int) -> tuple[float, str]:
    """One real epilogue of nu int32 products at (m, n). Bytes: the planes
    read once, the shifts, the output written once. 32-bit operations per
    element: nu loads, two shift loads and the store; per modulus the
    reduction of any int32 (4) and the wrap (2), or a 3-op mask for p = 256;
    one CRT pipeline. f64 operations (f64 out): 5 per limb."""
    L = EPILOGUE_LIMBS[out_bits][nu]
    f64 = out_bits == 53
    ops32 = nu + 3 + _moduli_ops(nu, 6, 3) + _crt_ops(nu, L, f64)
    bytes_ = m * n * (4 * nu + (8 if f64 else 4)) + 4 * (m + n)
    return bound(m * n * ops32, m * n * (5 * L if f64 else 0), bytes_)


def complex_epilogue(m: int, n: int, nu: int,
                     out_bits: int) -> tuple[float, str]:
    """One complex epilogue of 3nu int32 lane products at (m, n). Bytes:
    the lanes read once, the shifts, Re and Im written once. 32-bit
    operations per element: 3nu loads, two shift loads, two stores; per
    modulus three reductions with their wraps and the 3M recombine; two CRT
    pipelines. f64 operations (f64 out): 5 per limb in each pipeline."""
    L = EPILOGUE_LIMBS[out_bits][nu]
    f64 = out_bits == 53
    ops32 = (3 * nu + 4 + 3 * _moduli_ops(nu, 6, 3) + RECOMBINE_OPS * nu
             + 2 * _crt_ops(nu, L, f64))
    bytes_ = m * n * (12 * nu + 2 * (8 if f64 else 4)) + 4 * (m + n)
    return bound(m * n * ops32, m * n * (10 * L if f64 else 0), bytes_)


def stages(config: dict, traffic: dict) -> dict[str, tuple[float, str]]:
    """The least time of one call's encode, products and epilogue stages,
    in seconds, with what bounds each: a real call encodes A and B once
    each, runs nu products and one epilogue; a complex (3M) call encodes the
    real and imaginary parts of each (the (Re+Im) lane is the lanes stage's,
    not counted here), runs 3nu products and one complex epilogue (nu <= 16:
    the only complex route these counts cover)."""
    m, n, k = traffic["m"], traffic["n"], traffic["k"]
    nu = config["num_moduli"]
    itemsize, out_bits, is_complex = DTYPES[config["dtype"]]
    parts = 2 if is_complex else 1
    enc_a, enc_b = encode(m, k, m, nu, itemsize), encode(k, n, n, nu, itemsize)
    enc = (parts * (enc_a[0] + enc_b[0]),
           enc_a[1] if enc_a[1] == enc_b[1] else "mixed")
    if is_complex:
        if nu > 16:
            raise ValueError("complex counts cover nu <= 16 (one K4 epilogue)")
        return {"encode": enc, "products": products(3 * nu, m, n, k),
                "epilogue": complex_epilogue(m, n, nu, out_bits)}
    return {"encode": enc, "products": products(nu, m, n, k),
            "epilogue": epilogue(m, n, nu, out_bits)}


def flops(config: dict, traffic: dict) -> float:
    """The emulated call's floating-point operations, by the reference's
    convention (testing/test_flops.hpp): 2 m n k real, 8 m n k complex."""
    per = 8 if DTYPES[config["dtype"]][2] else 2
    return float(per * traffic["m"] * traffic["n"] * traffic["k"])
