"""The port's import arrows point one way: the kernel layer (kernels and the
arithmetic modules under it) imports neither entry module (core,
complex_gemm), at top level or inside a function. The residue arithmetic
both layers use (_wrap, mod_reduce, _recombine_3m) lives in quantize, and
the entry modules re-export it under their old names.
"""
import ast
import importlib
import inspect

import pytest

ENTRIES = {"core", "complex_gemm"}


@pytest.mark.parametrize("module,name", [("core", "mod_reduce"),
                                         ("core", "_wrap"),
                                         ("complex_gemm", "_recombine_3m")])
def test_entry_modules_reexport_quantizes_residue_arithmetic(module, name):
    from gemmul8_tpu_torch import quantize
    entry = importlib.import_module(f"gemmul8_tpu_torch.{module}")
    assert getattr(entry, name) is getattr(quantize, name)
    assert getattr(quantize, name).__module__ == "gemmul8_tpu_torch.quantize"


def _imported_modules(tree):
    """The gemmul8_tpu_torch modules an AST imports, anywhere in it, by
    their name inside the package."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level == 1 and not base:      # from . import x, y
                out.update(a.name for a in node.names)
            elif node.level == 1:                 # from .x import y
                out.add(base.split(".")[0])
            elif base.startswith("gemmul8_tpu_torch"):
                rest = base.split(".")[1:]
                out.update(rest[:1] or [a.name for a in node.names])
        elif isinstance(node, ast.Import):
            for a in node.names:
                parts = a.name.split(".")
                if parts[0] == "gemmul8_tpu_torch" and len(parts) > 1:
                    out.add(parts[1])
    return out


def test_imported_modules_reads_every_form():
    src = ("from . import core, tables\nfrom .complex_gemm import x\n"
           "def f():\n    from gemmul8_tpu_torch.ff import y\n"
           "    import gemmul8_tpu_torch.fp8\n"
           "    from gemmul8_tpu_torch import kernels\n")
    assert _imported_modules(ast.parse(src)) == {
        "core", "tables", "complex_gemm", "ff", "fp8", "kernels"}


@pytest.mark.parametrize("module", ["kernels", "fp8", "ff", "quantize"])
def test_kernel_layer_imports_no_entry_module(module):
    mod = importlib.import_module(f"gemmul8_tpu_torch.{module}")
    assert _imported_modules(ast.parse(inspect.getsource(mod))) & ENTRIES \
        == set()
