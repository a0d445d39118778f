"""Name parity: the port covers the JAX package's whole public surface.

For every module of gemmul8_tpu (a pkgutil walk), every public name the
module defines itself -- functions and classes whose __module__ is that
module, and the names its own top-level statements assign (constants and
counters) -- has a counterpart of the same name in the gemmul8_tpu_torch
module of the same path. Names a module imports do not count. Where the
counterpart is not a same-name twin, ALLOWLIST names it and says why.
A name added to the JAX package later without a twin fails this test."""
import ast
import importlib
import importlib.util
import inspect
import pkgutil
import sys

import pytest

import gemmul8_tpu
import gemmul8_tpu_torch

JAX, PORT = "gemmul8_tpu", "gemmul8_tpu_torch"

# JAX name (module path, or module.name) -> (counterpart in the port, why)
ALLOWLIST = {
    "pallas_kernels": (
        "kernels",
        "the Pallas kernels' module: its counterpart is the hand-written CUDA "
        "kernels' module. fused_epilogue, fused_epilogue_fp8, "
        "fused_epilogue_complex and fused_recombine_3m keep their names; "
        "encode_planes_tiles and encode_planes_fp8_tiles are "
        "kernels.encode_planes and kernels.encode_planes_fp8; "
        "encode_supported, the Pallas encoders' tile-alignment gate, has no "
        "counterpart since the CUDA encoders take any shape (their vector "
        "stores are chosen by kernels._encode_vec)"),
    "quantize.encode_planes": (
        "core.encode_side, kernels.encode_planes, kernels.encode_planes_fp8",
        "the dispatch between the Pallas encoder and its XLA fallback: the "
        "port's entries call the side encoder (core.encode_side), which "
        "launches the CUDA encoder of the backend"),
    "hook.cache_hits": (
        "hook.COUNTS['cache_hits']",
        "the interposer's counters live in one dict, beside the emulated and "
        "native counts"),
    "models.mlp.init_params": (
        "models.mlp.MLP, models.mlp.from_jax_params",
        "the nn.Module idiom: the module makes its own parameters; JAX PRNG "
        "keys have no torch counterpart, so JAX parameters come over through "
        "from_jax_params"),
    "models.mlp.forward": (
        "models.mlp.MLP.forward",
        "the nn.Module idiom: forward is the module's method"),
}

# the counterparts each allowlist entry names, as (module, attribute path)
COUNTERPARTS = {
    "pallas_kernels": [("kernels", "fused_epilogue"),
                       ("kernels", "fused_epilogue_fp8"),
                       ("kernels", "fused_epilogue_complex"),
                       ("kernels", "fused_recombine_3m"),
                       ("kernels", "encode_planes"),
                       ("kernels", "encode_planes_fp8"),
                       ("kernels", "_encode_vec")],
    "quantize.encode_planes": [("core", "encode_side"),
                               ("kernels", "encode_planes"),
                               ("kernels", "encode_planes_fp8")],
    "hook.cache_hits": [("hook", "COUNTS")],
    "models.mlp.init_params": [("models.mlp", "MLP"),
                               ("models.mlp", "from_jax_params")],
    "models.mlp.forward": [("models.mlp", "MLP.forward")],
}


def own_names(mod) -> set:
    """The public names `mod` defines itself: functions and classes whose
    __module__ is mod (through functools wrappers), and the names its own
    top-level assignments bind."""
    names = set()
    for name, value in vars(mod).items():
        if name.startswith("_"):
            continue
        target = inspect.unwrap(value) if callable(value) else value
        if (inspect.isfunction(target) or inspect.isclass(target)) and \
                getattr(value, "__module__", None) == mod.__name__:
            names.add(name)
    for node in ast.parse(inspect.getsource(mod)).body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        for t in targets:
            if isinstance(t, ast.Name) and not t.id.startswith("_"):
                names.add(t.id)
    return names


def missing(jax_mod, port_mod, rel: str) -> list:
    """The names of jax_mod with no same-name twin in port_mod and no
    allowlist entry (rel is the module's path inside the package)."""
    if rel in ALLOWLIST:
        return []
    return sorted(n for n in own_names(jax_mod)
                  if not hasattr(port_mod, n) and f"{rel}.{n}" not in ALLOWLIST)


def jax_modules() -> list:
    """Every module path of the JAX package, relative to it."""
    return sorted(info.name[len(JAX) + 1:] for info in
                  pkgutil.walk_packages(gemmul8_tpu.__path__, JAX + "."))


def _twin(rel: str):
    entry = ALLOWLIST.get(rel)
    return importlib.import_module(f"{PORT}.{entry[0] if entry else rel}")


def test_walk_finds_every_module():
    mods = jax_modules()
    assert {"core", "ff", "tables", "_tables_data", "pallas_kernels",
            "parallel.summa", "models.mlp"} <= set(mods)


@pytest.mark.parametrize("rel", jax_modules())
def test_module_has_its_twins(rel):
    jax_mod = importlib.import_module(f"{JAX}.{rel}")
    port_mod = _twin(rel)
    assert missing(jax_mod, port_mod, rel) == []


def test_package_surface():
    """The package's own names (its __init__ re-exports included) all have
    a twin at the port's top level."""
    public = [n for n in vars(gemmul8_tpu) if not n.startswith("_")
              and not inspect.ismodule(getattr(gemmul8_tpu, n))]
    assert [n for n in public if not hasattr(gemmul8_tpu_torch, n)] == []


@pytest.mark.parametrize("key", sorted(ALLOWLIST))
def test_allowlist_entry_is_live(key):
    """Each entry names a JAX module or a name the walk finds without a
    same-name twin, and each counterpart it gives exists in the port."""
    rel, _, name = key.rpartition(".")
    if key in jax_modules():
        importlib.import_module(f"{JAX}.{key}")
        assert not importlib.util.find_spec(f"{PORT}.{key}")
    else:
        jax_mod = importlib.import_module(f"{JAX}.{rel}")
        assert name in own_names(jax_mod)
        assert not hasattr(importlib.import_module(f"{PORT}.{rel}"), name)
    for mod, path in COUNTERPARTS[key]:
        obj = importlib.import_module(f"{PORT}.{mod}")
        for part in path.split("."):
            obj = getattr(obj, part)
    from gemmul8_tpu_torch import hook
    assert "cache_hits" in hook.COUNTS


def test_allowlist_is_exactly_these_entries():
    assert set(ALLOWLIST) == set(COUNTERPARTS) == {
        "pallas_kernels", "quantize.encode_planes", "hook.cache_hits",
        "models.mlp.init_params", "models.mlp.forward"}


def test_last_pieces_are_ported():
    """The names this walk found missing before the last module slice."""
    from gemmul8_tpu_torch import ff, tables
    for name in ("crt_limbs", "two_prod_const", "LIMB_BITS"):
        assert hasattr(ff, name)
    for name in ("num_mat", "mod_pow2", "qPi_f32x", "P_f32x", "invP_f32"):
        assert hasattr(tables, name)


def _write_pair(tmp_path, jax_src, port_src):
    """A fake JAX module and its twin, imported from tmp_path."""
    for name, src in (("fake_jax_mod", jax_src), ("fake_port_mod", port_src)):
        (tmp_path / f"{name}.py").write_text(src)
    sys.path.insert(0, str(tmp_path))
    try:
        return (importlib.import_module("fake_jax_mod"),
                importlib.import_module("fake_port_mod"))
    finally:
        sys.path.remove(str(tmp_path))
        for name in ("fake_jax_mod", "fake_port_mod"):
            sys.modules.pop(name, None)


def test_new_name_without_twin_fails(tmp_path):
    """A later function, class, constant or counter in a JAX module with no
    twin is reported; imported names and private ones are not."""
    jax_mod, port_mod = _write_pair(
        tmp_path,
        "import functools\nfrom math import sqrt\nfrom os.path import join\n"
        "LIMIT = 3\ncounter = 0\n_private = 1\n"
        "def old(): pass\ndef new_fn(): pass\nclass NewClass: pass\n"
        "@functools.lru_cache(maxsize=None)\ndef cached(n): return n\n",
        "LIMIT = 3\ndef old(): pass\n")
    assert missing(jax_mod, port_mod, "fake") == [
        "NewClass", "cached", "counter", "new_fn"]


def test_removed_twin_fails(monkeypatch):
    """Taking a ported name away makes its module's case fail."""
    from gemmul8_tpu import ff as jff
    from gemmul8_tpu_torch import ff as tff
    assert missing(jff, tff, "ff") == []
    monkeypatch.delattr(tff, "crt_limbs")
    assert missing(jff, tff, "ff") == ["crt_limbs"]
