"""The least time of accurate mode's two scaling stages on one H100, under
the conventions of counts.py (its peaks and its bound): the upper-bound
extraction of |A| and |B| and their estimation product. Counted from the
shapes by the algorithm, never read from a kernel.

The extraction reads each operand once and writes its int8 bound plane and
int32 pre-shifts once; its few operations an element (an absolute value,
the maximum, a scale, a rounding up) lie far below its bytes, so its least
time is its bytes. The estimation product is one exact int8 product of the
two bound planes into int32, counted as counts.products counts one plane.

The per-layer rooflines of the accurate cells read the device time of the
program's own spans (spans.device_ms): roofline_pct divides a stage's least
time by it.
"""
from __future__ import annotations

from h100bench import counts, spans


def extract(rows: int, cols: int, n_shifts: int,
            itemsize: int) -> tuple[float, str]:
    """One operand's upper-bound plane: the (rows, cols) operand read once
    (itemsize bytes an element), its int8 bound plane written once (1 byte
    an element), its n_shifts int32 pre-shifts written once."""
    return (rows * cols * (itemsize + 1) + 4 * n_shifts) / counts.PEAK_BYTES, \
        "bytes"


def estimate(m: int, n: int, k: int) -> tuple[float, str]:
    """The estimation product of A's (m, k) and B's (k, n) int8 bound planes
    into int32: 2 m n k operations at the int8 rate, or both planes read
    and the int32 product written once."""
    return counts.products(1, m, n, k)


def stages(config: dict, traffic: dict) -> dict[str, tuple[float, str]]:
    """The least time of one real INT8 accurate call's scaling stages, in
    seconds, with what bounds each: the extraction of A's rows and B's
    columns, and one estimation product."""
    m, n, k = traffic["m"], traffic["n"], traffic["k"]
    itemsize, _, is_complex = counts.DTYPES[config["dtype"]]
    if config["backend"] != "INT8" or is_complex or config["fastmode"]:
        raise ValueError("accurate counts cover the real INT8 backend in "
                         "accurate mode only")
    ext_a, ext_b = extract(m, k, m, itemsize), extract(k, n, n, itemsize)
    return {"extract": (ext_a[0] + ext_b[0], "bytes"),
            "estimate": estimate(m, n, k)}


def roofline_pct(ctx, stage: str, layer: str):
    """A stage's share of its roofline: the least time stages() gives it
    from the cell's shapes, times the traced calls, over the device time of
    the program's `layer` spans in them (%); None where the run holds no
    span to read."""
    ms = spans.device_ms(ctx, layer)
    if not ms:
        return None
    return 100.0 * stages(ctx.config, ctx.traffic)[stage][0] * 1e3 / ms
