"""Device operations (kernels, copies, fills) a call launched inside the
program's gemmul8.entry span: each one more enqueue for the host."""
from h100bench import spans


def read(ctx):
    return spans.entry_ops(ctx)
