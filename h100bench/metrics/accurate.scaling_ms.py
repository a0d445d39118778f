"""Device time a call of all of accurate mode's scaling: the operations
launched inside the program's gemmul8.extract (the bound planes),
gemmul8.estimate (their product) and gemmul8.shifts (the product's maxima
and the shifts from them) spans. None where the program opens no extract
or estimate span."""
from h100bench import spans


def read(ctx):
    parts = [spans.device_ms(ctx, layer)
             for layer in ("extract", "estimate", "shifts")]
    if parts[0] is None or parts[1] is None:
        return None
    return sum(p or 0.0 for p in parts)
