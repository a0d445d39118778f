"""Transparent matmul interposer for PyTorch programs ("hook mode").

The counterpart of gemmul8_tpu/hook.py and of the reference's LD_PRELOAD
cuBLAS interposer (src/hook.cu:609-730, 846-1055), whose best-known users are
PyTorch programs. install() replaces the function entries every torch matmul
goes through -- torch.matmul, torch.mm, torch.bmm, Tensor.__matmul__ (the
`@` operator), Tensor.matmul/mm/bmm and torch.nn.functional.linear (so
nn.Linear) -- process-wide, so calls made on any thread are seen. Eligible
calls run the Ozaki-II emulator on the operands' own device (CUDA or CPU):

  * both operands plain torch tensors of one dtype in f32/f64/c64/c128, on
    one device, the device CUDA or the CPU;
  * 2-D @ 2-D goes to core.emulate_matmul or
    complex_gemm.emulate_matmul_complex; equal leading batch dims (bmm, or
    matmul on (..., m, k) @ (..., k, n)) go to the same per batch element;
  * everything else falls through to the native call, as the reference's
    dlsym(RTLD_NEXT) fallthrough does (hook.cu:625-629): broadcast batches,
    vectors, integer and half dtypes, tensors with a __torch_function__ of
    their own, and a dtype whose num_moduli is unset or out of range.

Config is read on every call: install()'s explicit override, else the
GEMMUL8_* environment contract per dtype (config.env_config), the
reference's re-read-per-call contract (hook.cu:283-310).

An intercepted product is differentiable: a torch.autograd.Function whose
backward GEMMs are emulated too (the JAX hook's custom VJP, hook.py:94-109).
Complex gradients follow torch's convention, G @ B^H and A^H @ G, computed
as conj(conj(G) @ B^T) and conj(A^T @ conj(G)) so that they are the JAX
hook's gradients (JAX's convention is their conjugate) conjugated, bit for
bit. A tensor with its conjugate or negative bit set (A.mH, A.conj()) is
materialized before use.

Where this differs from the JAX package:

  * it intercepts CUDA tensors, and CPU tensors, with no numpy or JAX round
    trip (gemmul8_tpu.interop refuses CUDA tensors and routes through JAX);
  * the operand-plane cache (the reference's skip-scal Info_t cache,
    hook.cu:87-107) is OFF unless GEMMUL8_SKIP_SCALE_A/B or
    GEMMUL8_EAGER_CACHE=1 turn it on: torch tensors are mutable, and a write
    through .data, a numpy view or DLPack leaves the version counter it keys
    on unchanged. Cached and uncached calls give the same bits;
  * torch has no trace cache, so an environment change takes effect on the
    next call by itself and refresh() does nothing;
  * complex operands on the FP8 backend are emulated as real ones are.
"""
from __future__ import annotations

import functools
import threading
import weakref
from typing import Optional

import torch

from . import complex_gemm, config, core

_ELIGIBLE = {torch.float32: "float32", torch.float64: "float64",
             torch.complex64: "complex64", torch.complex128: "complex128"}

# the re-entrancy depth is per thread: the emulator's own products on this
# thread are never intercepted, while other threads' calls still are
_state = threading.local()
_lock = threading.Lock()
# install()'s override is process-wide, like the patched entries
_overrides: Optional[config.GemmConfig] = None
_patches: list = []
# emulated products (intercepted calls and their backward GEMMs), calls that
# fell through to native, plane-cache hits
COUNTS = {"emulated": 0, "native": 0, "cache_hits": 0}


def _count(key: str) -> None:
    with _lock:
        COUNTS[key] += 1


class _Internal:
    """The emulator's own scope on this thread: nothing is intercepted."""

    def __enter__(self):
        _state.depth = getattr(_state, "depth", 0) + 1

    def __exit__(self, *exc):
        _state.depth -= 1


def _config(dtype_name: str) -> Optional[config.GemmConfig]:
    cfg = _overrides if _overrides is not None else \
        config.env_config(dtype_name)
    return cfg if cfg is not None and cfg.validate(dtype_name) else None


# ---------------------------------------------------------------------------
# operand-plane cache (off by default): keyed on the owner tensor's identity,
# storage, version counter, shape, strides, dtype and device, how the owner
# became the operand, the side and the config; evicted when the owner dies
# ---------------------------------------------------------------------------

_plane_cache: dict = {}
_CACHE_MAX = 8


def clear_plane_cache() -> None:
    """Drop all cached operand planes (the skip-scal cache)."""
    with _lock:
        _plane_cache.clear()


def _cached_operand(x2d, side, cfg, owner, canon):
    key = (id(owner), owner.data_ptr(), owner._version, tuple(owner.shape),
           owner.stride(), owner.dtype, str(owner.device), side, canon, cfg)
    with _lock:
        hit = _plane_cache.get(key)
    if hit is not None:
        _count("cache_hits")
        return hit
    q = core.precompute(x2d, side, num_moduli=cfg.num_moduli,
                        backend=cfg.backend, device=x2d.device)
    with _lock:
        if len(_plane_cache) >= _CACHE_MAX:
            _plane_cache.pop(next(iter(_plane_cache)))
        _plane_cache[key] = q
    weakref.finalize(owner, _plane_cache.pop, key, None)
    return q


# ---------------------------------------------------------------------------
# the emulated product and its gradients
# ---------------------------------------------------------------------------

def _emulate_2d(a, b, cfg, owners=None):
    with _Internal():
        if a.dtype.is_complex:
            return complex_gemm.emulate_matmul_complex(
                a, b, num_moduli=cfg.num_moduli, fastmode=cfg.fastmode,
                backend=cfg.backend, epilogue=cfg.epilogue)
        cache = {s: config.cache_enabled(s) for s in "AB"}
        if (owners is not None and cfg.fastmode is True and a.shape[1] > 0
                and any(cache.values())):
            qa, qb = (
                _cached_operand(x, s, cfg, *own) if cache[s]
                else core.precompute(x, s, num_moduli=cfg.num_moduli,
                                     backend=cfg.backend, device=x.device)
                for x, s, own in ((a, "A", owners[0]), (b, "B", owners[1])))
            return core.gemm_quantized(qa, qb, out_dtype=a.dtype,
                                       epilogue=cfg.epilogue)
        return core.emulate_matmul(
            a, b, num_moduli=cfg.num_moduli, fastmode=cfg.fastmode,
            backend=cfg.backend, epilogue=cfg.epilogue)


def _emulate(a, b, cfg, owners=None):
    """Emulated a @ b of 2-D operands, or of (B, m, k) and (B, k, n) ones
    element by element (no plane cache)."""
    if a.dim() == 2:
        return _emulate_2d(a, b, cfg, owners)
    if a.shape[0] == 0:
        return core.empty_batch(a, b)
    return core.batched(lambda x, y: _emulate_2d(x, y, cfg), a, b)


def _transposed_product(x, y, cfg, conj_x):
    """x @ y with x the cotangent-side operand; for complex operands the
    product of the conjugates, conjugated (see the module docstring)."""
    _count("emulated")
    if not x.dtype.is_complex:
        return _emulate(x, y, cfg)
    if conj_x:
        return torch.conj_physical(_emulate(torch.conj_physical(x), y, cfg))
    return torch.conj_physical(_emulate(x, torch.conj_physical(y), cfg))


class _EmulatedMatmul(torch.autograd.Function):
    """out = a @ b with the forward and both backward GEMMs emulated. The
    backward runs wherever autograd runs it (on the card, its worker
    threads): it calls the emulator itself, not an intercepted entry."""

    @staticmethod
    def forward(ctx, a, b, cfg, owners):
        ctx.save_for_backward(a, b)
        ctx.cfg = cfg
        return _emulate(a, b, cfg, owners)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _transposed_product(g, b.mT, ctx.cfg, conj_x=True)
        if ctx.needs_input_grad[1]:
            gb = _transposed_product(a.mT, g, ctx.cfg, conj_x=False)
        return ga, gb, None, None


def emulated_matmul(a: torch.Tensor, b: torch.Tensor,
                    cfg: config.GemmConfig, owners=None) -> torch.Tensor:
    """Emulated a @ b for (..., m, k) @ (..., k, n) tensors of one
    eligible dtype and equal leading dims, differentiable, on the operands'
    device. owners: ((owner, how), (owner, how)) of each side for the plane
    cache, or None."""
    a, b = (x.resolve_conj().resolve_neg() for x in (a, b))
    lead, (m, k), n = a.shape[:-2], a.shape[-2:], b.shape[-1]
    if lead:
        a, b, owners = a.reshape(-1, m, k), b.reshape(-1, k, n), None
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        out = _EmulatedMatmul.apply(a, b, cfg, owners)
    else:
        out = _emulate(a, b, cfg, owners)
    _count("emulated")
    return out.reshape(*lead, m, n)


# ---------------------------------------------------------------------------
# the intercepted entries
# ---------------------------------------------------------------------------

def _intercept(a, b, ndim, owners):
    """The emulated a @ b, or None for the native call."""
    if getattr(_state, "depth", 0):
        return None
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        return None
    if torch.overrides.has_torch_function((a, b)):
        return None
    name = _ELIGIBLE.get(a.dtype)
    if (name is None or b.dtype != a.dtype or a.device != b.device
            or a.device.type not in ("cuda", "cpu")):
        return None
    if a.dim() < 2 or a.dim() != b.dim() or (ndim and a.dim() != ndim):
        return None
    if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        return None
    cfg = _config(name)
    if cfg is None:
        return None
    return emulated_matmul(a, b, cfg, owners if a.dim() == 2 else None)


def _matmul_entry(orig, ndim=None):
    @functools.wraps(orig)
    def wrapped(a, b, *args, **kwargs):
        if not args and not kwargs:
            out = _intercept(a, b, ndim, ((a, "N"), (b, "N")))
            if out is not None:
                return out
        _count("native")
        return orig(a, b, *args, **kwargs)
    return wrapped


def _linear_entry(orig):
    @functools.wraps(orig)
    def wrapped(input, weight, bias=None):
        # linear is x @ W^T (+ bias), over x's leading dims
        if (isinstance(input, torch.Tensor) and isinstance(weight, torch.Tensor)
                and input.dim() >= 2 and weight.dim() == 2):
            x2 = input.reshape(-1, input.shape[-1])
            out = _intercept(x2, weight.mT, 2,
                             ((input, "linear"), (weight, "linear")))
            if out is not None:
                out = out.reshape(*input.shape[:-1], weight.shape[0])
                return out if bias is None else out + bias
        _count("native")
        return orig(input, weight, bias)
    return wrapped


# the matmul entries install() replaces, each with the operand rank it
# takes (None: matmul's 2-D or equal-batch N-D)
_ENTRIES = ((torch, "matmul", None), (torch, "mm", 2), (torch, "bmm", 3),
            (torch.Tensor, "__matmul__", None), (torch.Tensor, "matmul", None),
            (torch.Tensor, "mm", 2), (torch.Tensor, "bmm", 3))


def _patch() -> None:
    for owner, name, ndim in _ENTRIES:
        orig = getattr(owner, name)
        setattr(owner, name, _matmul_entry(orig, ndim))
        _patches.append((owner, name, orig))
    orig = torch.nn.functional.linear
    torch.nn.functional.linear = _linear_entry(orig)
    _patches.append((torch.nn.functional, "linear", orig))


def _unpatch() -> None:
    while _patches:
        owner, name, orig = _patches.pop()
        setattr(owner, name, orig)


def installed() -> bool:
    return bool(_patches)


def install(num_moduli: Optional[int] = None, fastmode=None,
            backend: Optional[str] = None) -> None:
    """Install the interposer process-wide. With no arguments each call's
    config comes from the GEMMUL8_* variables of its dtype (a dtype without
    GEMMUL8_NUM_MOD_* stays native); num_moduli sets one override for every
    eligible dtype (fastmode default True, backend default INT8)."""
    global _overrides
    with _lock:
        _overrides = None if num_moduli is None else config.GemmConfig(
            num_moduli=num_moduli,
            fastmode=True if fastmode is None else fastmode,
            backend=(backend or "INT8").upper())
        if not _patches:
            _patch()


def uninstall() -> None:
    """Restore the native entries and drop the override."""
    global _overrides
    with _lock:
        _unpatch()
        _overrides = None


def refresh() -> None:
    """Kept for the JAX package's API: config is read on every call, so an
    environment change needs no refresh."""


class emulate:
    """Context manager: route eligible matmuls through the emulator inside
    the block, and restore the previous state after it.

        with gemmul8_tpu_torch.emulate(num_moduli=8) as mode:
            y = model(x)          # nn.Linear and @ run emulated
        mode.intercepted          # products emulated in the block (any
                                  # thread, backward GEMMs included)

    num_moduli=None defers to the GEMMUL8_* environment contract."""

    def __init__(self, num_moduli: Optional[int] = None, fastmode=True,
                 backend: str = "INT8"):
        self._args = (num_moduli, fastmode, backend)
        self._start = self._end = None

    @property
    def intercepted(self) -> int:
        if self._start is None:
            return 0
        end = COUNTS["emulated"] if self._end is None else self._end
        return end - self._start

    def __enter__(self):
        self._prev = (installed(), _overrides)
        self._start, self._end = COUNTS["emulated"], None
        install(*self._args)
        return self

    def __exit__(self, *exc):
        global _overrides
        self._end = COUNTS["emulated"]
        was_installed, prev = self._prev
        if was_installed:
            _overrides = prev
        else:
            uninstall()
