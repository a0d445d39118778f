"""The gemmul8.* spans of gemmul8_tpu_torch on the CPU: under torch.profiler
each route's stages appear named and nested (entry outermost, every other
stage inside it); with no profiler running record_function is never
entered; and a profiler running changes no output bit."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gemmul8_tpu_torch as gt
from gemmul8_tpu_torch import complex_gemm, core, fp8, kernels, quantize, spans

RNG = np.random.default_rng(1801)
A = RNG.standard_normal((40, 70))
B = RNG.standard_normal((70, 24))
C = RNG.standard_normal((40, 24))
ZA = A + 1j * RNG.standard_normal(A.shape)
ZB = B + 1j * RNG.standard_normal(B.shape)
# SGEMM's operands: the float64 ones rounded, so that both dtypes take the
# same shapes and scales
A32, B32, C32 = (x.astype(np.float32) for x in (A, B, C))

STAGES = {"entry", "shifts", "encode", "products", "epilogue", "alpha_beta"}
# accurate mode's scaling adds the bound planes and their product
ACCURATE = STAGES | {"extract", "estimate"}
# route: (the entry's arguments, the layers whose spans the call opens);
# "fn" names another entry than gemm
ROUTES = {
    "real": (dict(a=A, b=B, num_moduli=16, epilogue="ff"), STAGES),
    "striped": (dict(a=A, b=B, num_moduli=16, epilogue="ff", m_block=16,
                     n_block=8), STAGES),
    "alpha_beta": (dict(a=A, b=B, num_moduli=16, alpha=-1.0, beta=1.0, c=C,
                        epilogue="ff"), STAGES),
    "complex": (dict(a=ZA, b=ZB, num_moduli=16, trans_b="N", epilogue="ff"),
                STAGES | {"lanes"}),
    "fp8": (dict(a=A, b=B, num_moduli=12, backend="FP8", epilogue="ff"),
            STAGES),
    # SGEMM at the benchmark's 8 moduli on the card's int32-limb epilogue:
    # the f32 routes of the shifts, encode and epilogue
    "sgemm": (dict(a=A32, b=B32, num_moduli=8, epilogue="ff"), STAGES),
    "sgemm_alpha_beta": (dict(a=A32, b=B32, num_moduli=8, alpha=-1.0,
                              beta=1.0, c=C32, epilogue="ff"), STAGES),
    "accurate": (dict(a=A, b=B, num_moduli=16, fastmode=False,
                      epilogue="ff"), ACCURATE),
    "accurate_striped": (dict(a=A, b=B, num_moduli=16, fastmode=False,
                              epilogue="ff", m_block=16, n_block=8),
                         ACCURATE),
    "accurate_complex": (dict(a=ZA, b=ZB, num_moduli=16, fastmode=False,
                              trans_b="N", epilogue="ff"),
                         ACCURATE | {"lanes"}),
    "accurate_syrk": (dict(fn=gt.syrk, a=A, num_moduli=16, fastmode=False,
                           epilogue="ff"), ACCURATE - {"alpha_beta"}),
}


def call(route):
    kw = dict(ROUTES[route][0])
    fn = kw.pop("fn", gt.gemm)
    operands = [kw.pop(k) for k in ("a", "b") if k in kw]
    return fn(*operands, device="cpu", **kw)


def traced_spans(route, tmp_path):
    """(output, the call's gemmul8.* spans as (layer, start, end))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = call(route)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [(e["name"][len(spans.PREFIX):], e["ts"], e["ts"] + e["dur"])
                 for e in events if e.get("cat") == "user_annotation"
                 and e["name"].startswith(spans.PREFIX)]


def inside(x, y):
    return y[1] <= x[1] and x[2] <= y[2]


@pytest.mark.parametrize("route", list(ROUTES))
def test_spans_named_and_nested(route, tmp_path):
    _, found = traced_spans(route, tmp_path)
    assert {s[0] for s in found} == ROUTES[route][1]
    outer = [s for s in found if not any(inside(s, t) for t in found
                                         if t is not s)]
    assert [s[0] for s in outer] == ["entry"]
    entry = outer[0]
    assert all(inside(s, entry) for s in found)
    # each stage of the product sits in an emulation routine's entry span:
    # of the entry and alpha_beta spans around it, the innermost is entry
    for s in found:
        if s[0] in ("shifts", "extract", "estimate", "encode", "products",
                    "epilogue", "lanes"):
            around = [t for t in found if t[0] in ("entry", "alpha_beta")
                      and inside(s, t)]
            assert min(around, key=lambda t: t[2] - t[1])[0] == "entry", s
    if route == "alpha_beta":
        ab = next(s for s in found if s[0] == "alpha_beta")
        assert not any(inside(s, ab) for s in found if s is not ab)
    if route == "complex":
        lanes = [s for s in found if s[0] == "lanes"]
        assert all(any(inside(e, x) for x in lanes)
                   for e in found if e[0] == "encode")


@pytest.mark.parametrize("f32, f64", [("sgemm", "real"),
                                      ("sgemm_alpha_beta", "alpha_beta")])
def test_float32_opens_the_float64_spans(f32, f64, tmp_path):
    """An SGEMM call opens the spans of the DGEMM call on the same shapes,
    in the same order and nesting: entry, shifts, encode (A, then B),
    products, epilogue, with alpha_beta after the entry's emulation."""
    def outline(route):
        out, found = traced_spans(route, tmp_path)
        found.sort(key=lambda s: (s[1], -s[2]))
        return out.dtype, [(s[0], sum(inside(s, t) for t in found
                                      if t is not s)) for s in found]
    dtype32, spans32 = outline(f32)
    dtype64, spans64 = outline(f64)
    assert (dtype32, dtype64) == (torch.float32, torch.float64)
    assert spans32 == spans64
    assert {s[0] for s in spans32} == STAGES


@pytest.mark.parametrize("route", list(ROUTES))
def test_accurate_scaling_spans_sit_in_shifts(route, tmp_path):
    """Accurate mode's bound planes and estimation product each open their
    own span inside a gemmul8.shifts span, and every such shifts span holds
    both (the three layers partition its scaling); a fast call opens
    neither."""
    _, found = traced_spans(route, tmp_path)
    scaling = [s for s in found if s[0] in ("extract", "estimate")]
    if "extract" in ROUTES[route][1]:
        shifts = [s for s in found if s[0] == "shifts"]
        assert shifts and scaling
        assert all(any(inside(s, t) for t in shifts) for s in scaling)
        for t in shifts:
            assert {s[0] for s in scaling if inside(s, t)} == {"extract",
                                                               "estimate"}
    else:
        assert scaling == []


@pytest.mark.parametrize("route", list(ROUTES))
def test_no_profiler_never_enters_a_span(route, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(spans, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    out = call(route)
    assert out.shape == (40, 40 if route == "accurate_syrk" else 24)


@pytest.mark.parametrize("route", list(ROUTES))
def test_profiler_changes_no_bit(route, tmp_path):
    plain = call(route)
    traced, _ = traced_spans(route, tmp_path)
    assert traced.dtype == plain.dtype
    np.testing.assert_array_equal(torch.view_as_real(traced).numpy()
                                  if traced.is_complex() else traced.numpy(),
                                  torch.view_as_real(plain).numpy()
                                  if plain.is_complex() else plain.numpy())


@pytest.mark.parametrize("fn, layer", [
    (core.shifts, "shifts"), (complex_gemm.shifts, "shifts"),
    (core.emulate_matmul_blocked, "entry"), (core._syrk, "entry"),
    (complex_gemm._herk, "entry"),
    (core._chunked_residue_acc, "products"),
    (fp8.residue_matmul_fp8, "products"),
    (fp8._chunked_residue_acc, "products"),
    (kernels.encode_planes_fp8, "encode"), (kernels.encode_lanes_fp8, "encode"),
    (kernels.fused_epilogue_fp8, "epilogue"),
    (kernels.reassemble_fp8, "epilogue"),
    (quantize.shift_fast, "shifts"),
    (quantize.extract_ub_plane, "extract"),
    (complex_gemm._extract_ub_lanes, "extract"),
    (quantize.estimate_gemm, "estimate")])
def test_other_routes_carry_their_span(fn, layer):
    assert fn.span == layer
    assert fn.__wrapped__.__name__ == fn.__name__


def test_span_as_a_context_manager(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = spans.span("encode")
        with s:
            with s:
                torch.ones(3).sum()
        assert s._open == []
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert names.count("gemmul8.encode") == 2
    with spans.span("lanes") as s:
        assert s._open == [None]


def test_unknown_layer_is_refused():
    with pytest.raises(ValueError):
        spans.span("kernels")
