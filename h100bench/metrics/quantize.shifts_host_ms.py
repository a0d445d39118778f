"""The host's time a call inside the program's gemmul8.shifts spans
(quantize.shift_fast and its callers): the enqueue of the shifts' plain
torch operations and the waits on the card inside them."""
from h100bench import spans


def read(ctx):
    return spans.host_ms(ctx, "shifts")
