"""Shared steps of the tests that hold the port's examples and benchmark
probes against the JAX package's scripts: run a script in-process through
runpy with its standard output captured, and record what the public
functions an example calls return (in either package) while it runs."""
import contextlib
import io
import os
import runpy
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_script(rel_path, argv=(), run_name="__main__"):
    """Run ROOT/rel_path as a script (its `if __name__ == "__main__"`
    block included) with sys.argv set; returns (printed lines, the
    script's globals)."""
    path = os.path.join(ROOT, rel_path)
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [path, *argv]
    try:
        with contextlib.redirect_stdout(buf):
            glb = runpy.run_path(path, run_name=run_name)
    finally:
        sys.argv = saved
    return buf.getvalue().splitlines(), glb


def run_port(main, **kw):
    """An example's main(device="cpu") with its standard output captured:
    (printed lines, returned dict). It runs on one torch thread: the
    examples' products are small, and the lane's workers share the cores."""
    buf = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(buf):
            out = main(device="cpu", **kw)
    finally:
        torch.set_num_threads(threads)
    return buf.getvalue().splitlines(), out


@contextlib.contextmanager
def spied(module, names, with_args=False):
    """Record (name, output) of every call of module.<name> for each name
    while the block runs, in call order; with_args: (name, output, args)."""
    calls = []
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((name, out, args) if with_args else (name, out))
            return out
        return call

    for n in names:
        setattr(module, n, wrap(n, saved[n]))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def host(x):
    """A torch tensor, JAX array or numpy array as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().resolve_conj().resolve_neg().numpy()
    return np.ascontiguousarray(x)


def leaves(out):
    """The arrays of one call's output (a tuple's in order)."""
    return [host(o) for o in out] if isinstance(out, (tuple, list)) \
        else [host(out)]


def assert_bits(got, ref, what=""):
    """got and ref hold the same dtype, shape and bits."""
    got, ref = host(got), host(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (
        what, got.dtype, ref.dtype, got.shape, ref.shape)
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8),
                                  err_msg=what)


def assert_calls_bits(port_calls, jax_calls):
    """The two packages made the same calls in the same order, and each
    output of one holds the other's bits."""
    assert [n for n, _ in port_calls] == [n for n, _ in jax_calls]
    for i, ((name, p), (_, j)) in enumerate(zip(port_calls, jax_calls)):
        for x, y in zip(leaves(p), leaves(j)):
            assert_bits(x, y, f"call {i} {name}")


def max_relerr(got, ref):
    """max |got - ref| / max |ref| over two arrays."""
    got, ref = host(got), host(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
