"""The port's spans (``smfft_tpu_torch.trace``) on the CPU: what the public
calls, the ops and the launch wrappers record, the threads' parents, the
switch, the clock against ``torch.profiler``'s, and the collector; and the
``__global__`` each kernel entry declares, by which a launch span names its
kernel on the card and ptxas's report names its instantiations."""

from __future__ import annotations

import gc
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

import smfft_tpu_torch as S
from smfft_tpu_torch import api
from smfft_tpu_torch import trace
from smfft_tpu_torch.ops import _cuda
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import real as R

from torch_launch_path import launch_path


@pytest.fixture(autouse=True)
def recording_off():
    """Each test starts and ends with recording off."""
    trace.stop()
    yield
    trace.stop()


def _spans(rec) -> list[dict]:
    return [rec.span(i) for i in range(len(rec))]


def _children(spans, i) -> list[dict]:
    return [s for s in spans if s["parent"] == i]


def _c(*shape):
    g = torch.Generator().manual_seed(7)
    return torch.complex(torch.randn(shape, generator=g),
                         torch.randn(shape, generator=g))


def _r(*shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(8))


def test_recording_is_off_at_import_and_calls_record_nothing():
    assert trace.on is False
    before = len(trace._log)
    api.fft(_c(4, 256))
    api.rfft(_r(2, 256))
    assert len(trace._log) == before
    trace.start()
    assert len(trace.stop()) == 0


# public call: (the call, the op under it, its n, its rows)
CALLS = {
    "fft": (lambda: api.fft(_c(4, 256)), "op:ordered_c2c", 256, 4),
    "ifft": (lambda: api.ifft(_c(2, 3, 512)), "op:ordered_c2c", 512, 6),
    "ifft_unordered": (lambda: api.ifft_unordered(_c(4, 256)),
                       "op:fft_complex", 256, 4),
    "rfft": (lambda: api.rfft(_r(3, 2, 256)), "op:rfft", 256, 6),
    "irfft": (lambda: api.irfft(_c(4, 129)), "op:irfft", 256, 4),
    "convolve_real": (lambda: api.convolve_real(_r(2, 512), _c(257)),
                      "op:convolve", 512, 2),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_a_public_call_records_its_call_and_op(name):
    run, op, n, rows = CALLS[name]
    trace.start()
    run()
    spans = _spans(trace.stop())
    roots = [i for i, s in enumerate(spans) if s["parent"] == -1]
    assert len(roots) == 1
    root = spans[roots[0]]
    assert root["name"] == f"call:{name}"
    assert root["attrs"] == {"n": n, "rows": rows}
    ops = _children(spans, roots[0])
    assert [s["name"] for s in ops] == [op]
    assert root["start"] <= ops[0]["start"] <= ops[0]["end"] <= root["end"]
    assert all(s["root"] == roots[0] and s["thread"] == 0 for s in spans)


# N-D call: (the call, its row calls in order, its n, its rows)
NDIM_CALLS = {
    "fft2": (lambda: S.fft2(_c(2, 128, 256)), ["fft", "fft"], 256, 256),
    "ifft2": (lambda: S.ifft2(_c(128, 256)), ["ifft", "ifft"], 256, 128),
    "fftn": (lambda: S.fftn(_c(32, 64, 128)), ["fft"] * 3, 128, 2048),
    "ifftn": (lambda: S.ifftn(_c(64, 128), axes=(0,)), ["ifft"], 128, 64),
    "rfft2": (lambda: S.rfft2(_r(128, 256)), ["rfft", "fft"], 256, 128),
    "rfftn": (lambda: S.rfftn(_r(32, 64, 256)), ["rfft", "fft", "fft"],
              256, 2048),
    "irfft2": (lambda: S.irfft2(_c(128, 129)), ["ifft", "irfft"], 256, 128),
    "irfftn": (lambda: S.irfftn(_c(32, 64, 129), n=256),
               ["ifft", "ifft", "irfft"], 256, 2048),
}


@pytest.mark.parametrize("name", sorted(NDIM_CALLS))
def test_an_nd_call_is_a_root_over_its_row_calls(name):
    run, kids, n, rows = NDIM_CALLS[name]
    trace.start()
    run()
    spans = _spans(trace.stop())
    roots = [i for i, s in enumerate(spans) if s["parent"] == -1]
    assert [spans[i]["name"] for i in roots] == [f"call:{name}"]
    assert spans[0]["attrs"] == {"n": n, "rows": rows}
    calls = _children(spans, 0)
    assert [s["name"] for s in calls] == [f"call:{k}" for k in kids]
    assert all(spans[0]["start"] <= s["start"] <= s["end"] <= spans[0]["end"]
               for s in calls)


def test_fft_large_at_a_row_size_nests_call_fft():
    trace.start()
    api.fft_large(_c(2, 1024))
    spans = _spans(trace.stop())
    assert [(s["name"], s["parent"]) for s in spans] == [
        ("call:fft_large", -1), ("call:fft", 0), ("op:ordered_c2c", 1)]
    assert spans[1]["attrs"] == {"n": 1024, "rows": 2}
    assert spans[0]["start"] <= spans[1]["start"]
    assert spans[1]["end"] <= spans[0]["end"]


def test_unordered_fft_records_the_op_that_bypasses_autograd():
    trace.start()
    api.fft(_c(4, 256), ordered=False)
    spans = _spans(trace.stop())
    assert [s["name"] for s in spans] == ["call:fft", "op:fft_complex"]


def test_a_call_that_raises_closes_its_span():
    trace.start()
    with pytest.raises(ValueError):
        api.fft(_c(3, 100))
    api.fft(_c(4, 256))
    spans = _spans(trace.stop())
    assert [(s["name"], s["parent"]) for s in spans] == [
        ("call:fft", -1), ("call:fft", -1), ("op:ordered_c2c", 1)]
    assert spans[0]["attrs"] == {"n": 100, "rows": 3}


def test_spans_nest_by_their_times():
    trace.start()
    outer = trace.now()
    inner = trace.now()
    trace.record(inner, "op:inner")
    trace.record(outer, "call:outer")
    after = trace.now()
    trace.record(after, "call:after")
    spans = _spans(trace.stop())
    assert [(s["name"], s["parent"], s["root"]) for s in spans] == [
        ("call:outer", -1, 0), ("op:inner", 0, 0), ("call:after", -1, 2)]


def test_two_threads_never_take_each_others_parents():
    barrier = threading.Barrier(2)

    def work(tag):
        outer = trace.now()
        barrier.wait()
        inner = trace.now()
        barrier.wait()
        trace.record(inner, f"op:{tag}")
        barrier.wait()
        trace.record(outer, f"call:{tag}")

    trace.start()
    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = _spans(trace.stop())
    assert len(spans) == 4
    for tag in "ab":
        i = next(i for i, s in enumerate(spans) if s["name"] == f"call:{tag}")
        op = next(s for s in spans if s["name"] == f"op:{tag}")
        assert spans[i]["parent"] == -1
        assert op["parent"] == i and op["root"] == i
        assert op["thread"] == spans[i]["thread"]
    assert len({s["thread"] for s in spans}) == 2


def test_start_and_stop_are_idempotent():
    trace.start()
    t = trace.now()
    anchor = trace._anchor
    trace.start()
    assert trace.on and trace._anchor == anchor
    trace.record(t, "call:x", torch.zeros(8))
    first = trace.stop()
    assert trace.on is False and len(first) == 1
    assert first.span(0)["attrs"] == {"n": 8, "rows": 1}
    assert len(trace.stop()) == 0     # while off: empty records
    trace.record(t, "call:x", torch.zeros(8))   # while off: nothing
    trace.start()
    assert len(trace.stop()) == 0


def test_spans_lie_on_the_profilers_clock():
    """A span inside a ``record_function`` region lies inside that event's
    interval on the profiler's clock, within 20 us."""
    act = torch.profiler.ProfilerActivity
    trace.start()
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        with torch.profiler.record_function("smfft_region"):
            time.sleep(0.002)
            t = trace.now()
            time.sleep(0.001)
            trace.record(t, "op:inside")
            time.sleep(0.002)
    span = trace.stop().span(0)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "smfft_region"]
    assert len(ev) == 1
    tol = 20_000
    assert ev[0].start_ns() - tol <= span["start"]
    assert span["end"] <= ev[0].end_ns() + tol
    assert span["end"] - span["start"] >= 1_000_000


def test_recording_creates_no_object_the_collector_tracks():
    xs = [torch.zeros(rows, 1024) for rows in range(1, 5)]
    trace.start()
    gc.collect()
    before = len(gc.get_objects())
    for i in range(100_000):
        trace.record(trace.now(), "call:fft", xs[i % 4])
    grown = len(gc.get_objects()) - before
    rec = trace.stop()
    assert len(rec) == 100_000
    assert grown < 100
    assert len(rec.attrs) == 4


def _stand_in(x):
    """A launch wrapper's shape: entry, alloc, tables, the call."""
    sp = trace.on and trace.now()
    a = t = c = out = b = n = 0
    try:
        b, n = x.shape
        a = sp and trace.now()
        out = torch.empty_like(x)
        t = sp and trace.now()
        c = sp and trace.now()
        _stand_in.count += 1
    finally:
        if sp:
            trace.launched(sp, a, t, c, out, "launch:c2c", "interleaved",
                           False, b, n)
    return out


_stand_in.count = 0


def test_a_launch_site_counts_and_records_its_children():
    x = _c(4, 256)
    _stand_in(x)
    assert _stand_in.count == 1
    trace.start()
    _stand_in(x)
    spans = _spans(trace.stop())
    assert _stand_in.count == 2
    assert spans[0]["name"] == "launch:c2c"
    assert spans[0]["attrs"] == {"rows": 4, "n": 256,
                                 "variant": "interleaved", "exact": False}
    kids = _children(spans, 0)
    assert [s["name"] for s in kids] == ["alloc", "tables", "call"]
    assert kids[0]["attrs"] == {"bytes": 4 * 256 * 8}
    assert all(spans[0]["start"] <= k["start"] <= k["end"] <= spans[0]["end"]
               for k in kids)


class _Lib:
    """The kernel library's entry points, each doing nothing and returning
    ``err``."""

    def __init__(self, err=0):
        self.err = err

    def smfft_error_string(self, err):
        return b"stand-in error"

    def __getattr__(self, name):
        return lambda *args: self.err


@pytest.fixture
def card_path(monkeypatch):
    """The CUDA branch of the launch wrappers on CPU tensors: the one
    launch path stood in (``launch_path``), every entry point returning
    0."""
    return launch_path(monkeypatch, _Lib())


@pytest.mark.parametrize("kernel", ["c2c", "r2c", "c2r"])
def test_a_launch_wrapper_records_launch_tables_alloc_and_call(card_path,
                                                               kernel):
    fn, args, kw, variant, out_bytes = {
        "c2c": (C.launch, (_c(8, 256),), {}, "interleaved", 8 * 256 * 8),
        "r2c": (R.launch_r2c, (_r(8, 256),), {"layout": "numpy"}, "numpy",
                8 * 129 * 8),
        "c2r": (R.launch_c2r, (_c(8, 129),), {"n": 256, "layout": "numpy"},
                "numpy", 8 * 256 * 4),
    }[kernel]
    before = _cuda.KERNELS[kernel].count
    trace.start()
    fn(*args, **kw)
    spans = _spans(trace.stop())
    assert _cuda.KERNELS[kernel].count == before + 1
    assert spans[0]["name"] == f"launch:{kernel}"
    assert spans[0]["attrs"] == {"rows": 8, "n": 256, "variant": variant,
                                 "exact": False}
    kids = _children(spans, 0)
    assert [s["name"] for s in kids] == ["alloc", "tables", "call"]
    assert kids[0]["attrs"] == {"bytes": out_bytes}
    assert len(spans) == 4


def test_a_launch_that_fails_is_recorded_and_not_counted(card_path):
    """The library call's error passes out of the launch with its span and
    its children recorded, the ``call`` child ending with the launch; no
    kernel ran, so the count stays.  The first launch builds the plan, so
    the second's error is the run's."""
    C.launch(_c(8, 256))
    card_path.err = 700
    before = _cuda.C2C_RUN.count
    trace.start()
    with pytest.raises(RuntimeError, match="stand-in error"):
        C.launch(_c(8, 256))
    spans = _spans(trace.stop())
    assert _cuda.C2C_RUN.count == before
    assert [(s["name"], s["parent"]) for s in spans] == [
        ("launch:c2c", -1), ("alloc", 0), ("tables", 0), ("call", 0)]
    assert spans[3]["end"] == spans[0]["end"]


def test_a_launch_that_fails_in_its_checks_records_what_began(card_path):
    """A check that raises before the output is allocated: the launch
    alone, not counted."""
    before = _cuda.R2C.count
    trace.start()
    with pytest.raises(ValueError, match="layout"):
        R.launch_r2c(_r(8, 256), layout="no such layout")
    spans = _spans(trace.stop())
    assert _cuda.R2C.count == before
    assert [s["name"] for s in spans] == ["launch:r2c"]
    assert spans[0]["attrs"]["variant"] == "no such layout"


def _odd_pair(b, w):
    """A planar pair of (b, w) views of one flat float32 buffer, each at an
    odd float offset: 4-byte, not 8-byte, aligned."""
    flat = torch.zeros(2 * b * w + 3)
    xr, xi = flat[1:1 + b * w].view(b, w), flat[3 + b * w:].view(b, w)
    assert xr.data_ptr() % 8 == xi.data_ptr() % 8 == 4
    return xr, xi


@pytest.mark.parametrize("kernel", ["c2c", "c2c_multiple", "conv",
                                    "bluestein", "c2r"])
def test_a_planar_pair_at_an_odd_float_offset_is_launched(card_path, kernel):
    """The kernels read a pair's planes a float at a time, so the row check
    asks them for a float's alignment only, on a plan's hit as at its
    build; lone rows, loaded in 8-byte words, still need 8 bytes."""
    from smfft_tpu_torch.ops import chirp as CH
    from smfft_tpu_torch.ops import convolve as CV
    from smfft_tpu_torch.ops import multiple as M
    fn, w, kw = {
        "c2c": (C.launch, 256, {}),
        "c2c_multiple": (M.launch_multiple, 256, {"loops": 1}),
        "conv": (CV.launch_conv, 256,
                 {"h": torch.ones(1, 256, dtype=torch.complex64)}),
        "bluestein": (CH.launch_bluestein, 256, {"n": 100, "m": 256}),
        "c2r": (R.launch_c2r, 128, {"n": 256}),
    }[kernel]
    before = _cuda.KERNELS[kernel].count
    fn(*_odd_pair(4, w), **kw)
    fn(*_odd_pair(4, w), **kw)
    assert _cuda.KERNELS[kernel].count == before + 2
    with pytest.raises(ValueError, match="x must be 8-byte aligned"):
        R.launch_r2c(_odd_pair(4, 256)[0])


def test_rfft_large_records_its_passes_its_split_and_their_buffers(
        card_path, monkeypatch):
    """A traced (2, 2^21) ``rfft_large`` on the card path (pair mode, the
    "three" plan): the call, its op, and its launches named by their place
    in the plan: pass 1, then the fused tail (passes 2 and 3 in one
    launch), naming the pair split it does and the L2 hand-off.  The
    intermediate and the spectrum are each the ``alloc`` of the launch
    that first writes it, with its bytes, and no ``z`` is made."""
    from smfft_tpu_torch.ops import fourstep_fused as FF
    monkeypatch.setattr(C, "is_cpu", lambda t: False)
    monkeypatch.setattr(FF, "_operand", lambda t, n, name: (0, None, 0))
    n = 1 << 21
    fused, tails = FF.launch_pass.fused, FF.launch_pass.tails
    trace.start()
    out = api.rfft_large(_r(2, n), precision="highest")
    spans = _spans(trace.stop())
    assert FF.launch_pass.fused == fused + 1
    assert FF.launch_pass.tails == tails + 1
    assert out.shape == (2, n // 2 + 1)
    assert [s["name"] for s in spans if s["parent"] == -1] == [
        "call:rfft_large"]
    assert spans[0]["attrs"] == {"n": n, "rows": 2}
    assert [s["name"] for s in _children(spans, 0)] == ["op:rfft_large"]
    launches = [i for i, s in enumerate(spans)
                if s["name"].startswith("launch:")]
    assert [(spans[i]["name"], spans[i]["attrs"]["variant"],
             spans[i]["parent"]) for i in launches] == [
        ("launch:fourstep_pass", "radix=128 pass=1/3", 1),
        ("launch:fourstep_pass",
         "radix=128+128 pass=2-3/3 split=pair tail=l2", 1)]
    assert spans[launches[0]]["attrs"]["rows"] == 1   # one pair of trials
    allocs = [[k["attrs"]["bytes"] for k in _children(spans, i)
               if k["name"] == "alloc"] for i in launches]
    assert allocs == [[n * 8], [2 * (n // 2 + 1) * 8]]
    assert all([k["name"] for k in _children(spans, i)][-2:]
               == ["tables", "call"] for i in launches)


def test_a_fused_column_launch_records_its_passes_and_its_buffers(
        card_path, monkeypatch):
    """A traced ``fftn`` over the leading axis of a (4096, 64) grid on the
    card path: the column route's one launch, pass A carrying pass B
    through L2, named ``axis=col radix=64+64 pass=1-2/2 tail=l2``, with the
    output and the intermediate the ``alloc`` of that launch, and the
    fused launch counted."""
    import smfft_tpu_torch as S
    from smfft_tpu_torch.ops import fourstep_fused as FF
    monkeypatch.setattr(C, "is_cpu", lambda t: False)
    monkeypatch.setattr(FF, "_operand", lambda t, n, name: (0, None, 0))
    fused = FF.run_columns.fused
    x = _c(4096, 64)
    trace.start()
    S.fftn(x, axes=(0,))
    spans = _spans(trace.stop())
    assert FF.run_columns.fused == fused + 1
    launches = [i for i, s in enumerate(spans)
                if s["name"].startswith("launch:")]
    assert [(spans[i]["name"], spans[i]["attrs"]["variant"])
            for i in launches] == [("launch:fourstep_pass",
                                    "axis=col radix=64+64 pass=1-2/2 "
                                    "tail=l2")]
    kids = _children(spans, launches[0])
    assert [k["name"] for k in kids] == ["alloc", "tables", "call"]
    assert kids[0]["attrs"] == {"bytes": 2 * 4096 * 64 * 8}


@pytest.mark.parametrize("rows,mode", [(2, "pair"), (1, "halfc")])
def test_irfft_large_records_its_merge_its_passes_and_their_buffers(
        card_path, monkeypatch, rows, mode):
    """The inverse on the card path: the merge makes ``z``, the first pass
    the intermediate and the last pass the signal (one allocation for
    both planes of a pair), each the ``alloc`` of its launch."""
    from smfft_tpu_torch.ops import fourstep_fused as FF
    monkeypatch.setattr(C, "is_cpu", lambda t: False)
    monkeypatch.setattr(FF, "_operand", lambda t, n, name: (0, None, 0))
    n = 1 << 21
    L = n // 2 if mode == "halfc" else n       # a Z row's points
    trace.start()
    out = api.irfft_large(_c(rows, n // 2 + 1), n=n, precision="highest")
    spans = _spans(trace.stop())
    assert out.shape == (rows, n) and out.dtype == torch.float32
    launches = [i for i, s in enumerate(spans)
                if s["name"].startswith("launch:")]
    assert [spans[i]["attrs"]["variant"] for i in launches] == [
        f"{mode}_merge"] + [f"radix={128 if mode == 'pair' else 1024} "
                            f"pass={k}/{3 if mode == 'pair' else 2}"
                            for k in range(1, 4 if mode == "pair" else 3)]
    allocs = [sum(k["attrs"]["bytes"] for k in _children(spans, i)
                  if k["name"] == "alloc") for i in launches]
    z = L * 8                                  # one Z row, complex64
    assert allocs == ([z, z, 0, n * 4 * 2] if mode == "pair"
                      else [z, z, n * 4])


def test_huge_n_recording_stays_off_at_import():
    """A fresh process that imports the port and runs the huge-N real
    path records nothing: recording is off until ``trace.start``."""
    code = ("import torch\n"
            "from smfft_tpu_torch import api, trace\n"
            "from smfft_tpu_torch.ops import real_fused\n"
            "assert trace.on is False\n"
            "x = torch.rand((2, 1 << 15))\n"
            "api.irfft_large(api.rfft_large(x))\n"
            "assert trace.on is False and len(trace._log) == 0\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


# the ``__global__``s that csrc/*.cu defines: the name after the
# qualifiers and ``__launch_bounds__(...)``
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^()]*\)\s*)?"
                     r"(\w+)\s*\(")


def _defined_globals() -> set[str]:
    return {m.group(1) for src in sorted(_cuda.CSRC.glob("*.cu"))
            for m in _GLOBAL.finditer(src.read_text())}


@pytest.mark.parametrize("kernel", sorted(_cuda.KERNELS))
def test_each_kernel_entry_declares_the_global_it_launches(kernel):
    """A kernel's declaration names the one ``__global__`` its library call
    launches, and ``csrc/*.cu`` defines it; the helpers launch none."""
    function = _cuda.KERNELS[kernel].function
    assert function and function in _defined_globals()
    assert _cuda.LAUNCHED[f"launch:{kernel}"] == function
    assert all(e.function is None for e in _cuda.ENTRIES if not e.kernel)


def test_every_global_is_some_entrys_and_the_lookup_covers_the_kernels():
    """The port has one list of its kernels: every ``__global__`` of
    ``csrc/*.cu`` is one entry's, no two entries share one, the lookup by
    launch span covers ``parallel.dryrun.KERNELS``, and every launch span
    a wrapper of ``ops/*`` records is in it."""
    from smfft_tpu_torch.parallel import dryrun
    functions = [e.function for e in _cuda.KERNELS.values()]
    assert len(set(functions)) == len(functions) == 12
    assert set(functions) == _defined_globals()
    assert set(_cuda.LAUNCHED) == {f"launch:{k}" for k in dryrun.KERNELS}
    recorded = {m.group(1) for src in (_cuda.CSRC.parent / "ops").glob("*.py")
                for m in re.finditer(r'"(launch:\w+)"', src.read_text())}
    assert recorded == set(_cuda.LAUNCHED)


def test_the_register_report_of_a_build_log_is_unchanged():
    """On a saved excerpt of an H100 build's ptxas log (the first
    instantiation of each kernel, flag set, precision and spill state), the
    report built from the declared names reads line for line as the report
    of the kernels' names written out did (``ptxas_excerpt.report``)."""
    data = Path(__file__).parent / "data"
    log = (data / "ptxas_excerpt.log").read_text()
    want = (data / "ptxas_excerpt.report").read_text().splitlines()
    assert len(want) == log.count("Compiling entry function") == 45
    assert _cuda.register_report(log) == want
