"""Runtime calls a call that hold the host until the card has drained
(synchronises, synchronous copies) inside the program's gemmul8.entry span:
each a stall of the enqueue, where the card idles until the host has
queued the next operation."""
from h100bench import spans


def read(ctx):
    return spans.entry_syncs(ctx)
