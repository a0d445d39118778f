"""The share of the untraced window in which the card runs nothing."""
from h100bench import readers


def read(ctx):
    return readers.idle_pct(ctx)
