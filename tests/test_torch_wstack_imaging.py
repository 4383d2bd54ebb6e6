"""The wide-field imaging deployment on the CPU: the port's ``ifft2`` then
``fft2`` of a w-layer grid held against the plain reference
(``smfft_tpu_torch/reference/wstack_imaging.py``), the reference's
independence from the port, the op layer's copy counter and the column
route's counter (a power-of-two grid copies nothing, a stride of 3 keeps
the copy path), and the span trees of a traced ``ifft2`` on both paths."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

import smfft_tpu_torch as S
from smfft_tpu_torch import api, trace
from smfft_tpu_torch.parallel import dryrun
from smfft_tpu_torch.reference import wstack_imaging as ref

REF_PATH = Path(ref.__file__)

# max |got - expected| / rms(expected) over a grid, the number the
# benchmark's cell compares.  fp32 rounds each stage and twiddle of the two
# passes at 6e-8; over log2(rows * n) <= 18 stages the port reads at most
# 1.7e-6 here (image and round trip), and 2e-5 leaves 10x above that.
# Rounding the grid, the image and the predicted grid to bfloat16 (4e-3)
# reads 8.6e-3 or more: 400x over.
TOL = 2e-5

GRIDS = [(256, 256), (512, 256), (256, 1024)]


@pytest.fixture(autouse=True)
def recording_off():
    """Each test starts and ends with recording off."""
    trace.stop()
    yield
    trace.stop()


def _grid(rows: int, n: int, seed: int = 0) -> torch.Tensor:
    """A grid uniform in [-1, 1) in both parts, as the benchmark's cell
    makes it."""
    g = torch.Generator().manual_seed(1000 * seed + rows + n)
    return torch.view_as_complex(torch.rand((rows, n, 2), generator=g) * 2 - 1)


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    rms = want.abs().square().mean().sqrt()
    return float((got.to(want.dtype) - want).abs().max() / rms)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    r = torch.view_as_real(t).to(torch.bfloat16).to(torch.float32)
    return torch.view_as_complex(r.contiguous())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("rows,n", GRIDS)
def test_image_and_predict_match_the_reference(rows, n, seed):
    x = _grid(rows, n, seed)
    img = S.ifft2(x, norm="backward", precision="highest")
    grid = S.fft2(img, precision="highest")
    want_img = ref.image(x)
    want_grid = ref.predict(want_img)
    assert img.shape == grid.shape == (rows, n)
    assert img.dtype == grid.dtype == torch.complex64
    assert img.is_contiguous() and grid.is_contiguous()
    assert _err(img, want_img) < TOL
    assert _err(grid, want_grid) < TOL
    # the exact round trip returns the grid
    assert _err(want_grid, x.to(torch.complex128)) < 1e-12
    # the bfloat16 control fails the same tolerance
    ctrl_img = _bf16(torch.fft.ifft2(_bf16(x)))
    ctrl_grid = _bf16(torch.fft.fft2(ctrl_img))
    assert _err(ctrl_img, want_img) > 100 * TOL
    assert _err(ctrl_grid, want_grid) > 100 * TOL


def test_the_reference_imports_nothing_of_the_port_and_no_jax():
    tree = ast.parse(REF_PATH.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names and set(names) <= {"__future__", "torch"}
    for name in names:
        top = name.split(".")[0]
        assert top not in ("jax", "smfft_tpu", "smfft_tpu_torch"), name
        assert "ops" not in name.split(".") and "csrc" not in name


@pytest.mark.parametrize("call", ["fft2", "ifft2"])
@pytest.mark.parametrize("rows,n", GRIDS)
def test_a_2d_transform_of_a_power_of_two_grid_copies_nothing(call, rows, n):
    """The leading axis runs as column passes at its stride n
    (``ops/fourstep_fused.run_columns``), the last axis as its row call:
    no byte copied and one column route a call, recording on or off."""
    x = _grid(rows, n)
    fn = getattr(S, call)
    for record in (False, True):
        if record:
            trace.start()
        before = dryrun.copied_bytes(), dryrun.column_routes()
        fn(x)
        assert dryrun.copied_bytes() - before[0] == 0
        assert dryrun.column_routes() - before[1] == 1
        trace.stop()


@pytest.mark.parametrize("call", ["fft2", "ifft2"])
@pytest.mark.parametrize("rows,n", GRIDS)
def test_a_2d_transform_copies_the_grid_twice(call, rows, n):
    """Where an axis's trailing stride is no power of two, the copy path
    stays: a 2-D transform over the first two axes of a stack of three
    grids (strides 3n and 3) copies the transposed view before the pass
    over the first axis and again before the pass over the second:
    2 * rows * n * 3 * 8 bytes, recording on or off, and no column
    route."""
    x = _grid(rows, n * 3).reshape(rows, n, 3)
    fn = getattr(S, call)
    for record in (False, True):
        if record:
            trace.start()
        before = dryrun.copied_bytes(), dryrun.column_routes()
        got = fn(x, axes=(0, 1))
        assert dryrun.copied_bytes() - before[0] == 2 * rows * n * 3 * 8
        assert dryrun.column_routes() == before[1]
        trace.stop()
        want = getattr(torch.fft, call)(x.to(torch.complex128), dim=(0, 1))
        assert _err(got, want) < TOL


def test_row_calls_on_contiguous_rows_copy_nothing():
    x = _grid(4, 256)
    before = dryrun.copied_bytes()
    api.fft(x)
    api.ifft(x)
    api.fft(x, ordered=False)
    api.rfft(x.real.contiguous())
    assert dryrun.copied_bytes() == before
    # a conjugate view is copied once, resolved in the same pass
    api.fft(x.conj())
    assert dryrun.copied_bytes() - before == 4 * 256 * 8


def _step(x, **kw):
    """The cell's step: the image, then the grid predicted from it."""
    return S.fft2(S.ifft2(x, norm="backward", **kw), **kw)


def test_an_imaging_step_at_16384_is_one_column_launch_a_call(monkeypatch):
    """The cell's step on its 16384^2 grid on the card path, the pass
    kernel stood in (its outputs made, nothing computed, the grid never
    written) and each row call by a fresh grid: one launch of the pass
    kernel a call, radix 128 carrying radix 128 (the fused column launch),
    ``run_columns.fused`` counted twice, no byte copied."""
    from tests.torch_launch_path import column_launches
    log = column_launches(monkeypatch, compute=False)
    for name in ("fft", "ifft"):
        monkeypatch.setattr(api, name, lambda x, **kw: torch.empty_like(x))
    x = torch.empty((16384, 16384), dtype=torch.complex64)
    before = (dryrun.copied_bytes(), dryrun.column_routes(),
              dryrun.column_fused())
    y = _step(x)
    assert y.shape == x.shape and y.dtype == torch.complex64
    assert [(p.radix, p.then.radix, at) for p, at in log] == [
        (128, 128, (1, 2, "col"))] * 2
    assert (dryrun.copied_bytes() - before[0], dryrun.column_routes()
            - before[1], dryrun.column_fused() - before[2]) == (0, 2, 2)


@pytest.mark.parametrize("rows,n,kw,launches", [
    (4096, 64, {}, 1), (16384, 32, {}, 1), (4096, 32, {}, 2),
    (4096, 64, {"precision": "exact"}, 2)])
def test_an_imaging_step_with_stand_in_launchers(monkeypatch, rows, n, kw,
                                                 launches):
    """The cell's step on the card path, the pass kernel stood in by its
    plain function: one launch a call where the two column passes fuse
    (fp32, a slab of columns at the stride), two where the grid is
    narrower than a slab or the tier is "exact"; the grids are the CPU
    path's, and the round trip returns the grid."""
    from tests.torch_launch_path import column_launches
    x = _grid(rows, n, seed=3)
    cpu = _step(x, **kw)
    log = column_launches(monkeypatch)
    fused = dryrun.column_fused()
    got = _step(x, **kw)
    assert len(log) == 2 * launches
    assert dryrun.column_fused() - fused == (2 if launches == 1 else 0)
    assert torch.equal(got, cpu)
    assert _err(got, x) < TOL


def _tree(fn):
    """The spans of one traced call of ``fn``."""
    trace.start()
    fn()
    rec = trace.stop()
    spans = [rec.span(i) for i in range(len(rec))]
    roots = [i for i, s in enumerate(spans) if s["parent"] == -1]
    return spans, roots


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s["parent"] == i]


def test_a_traced_ifft2_is_a_root_over_a_row_call_and_a_column_route():
    """The last axis first, its row call around ``op:ordered_c2c``, then
    the leading axis's column route, recorded as its row call (``n`` the
    axis's length) around ``op:column_c2c``.  No copy.  (On the CPU the
    plain versions launch nothing; the route's launches and buffers are
    pinned in tests/test_torch_fourstep.py.)"""
    rows, n = 256, 512
    x = _grid(rows, n)
    spans, roots = _tree(lambda: S.ifft2(x, norm="backward",
                                         precision="highest"))
    assert [spans[i]["name"] for i in roots] == ["call:ifft2"]
    assert spans[0]["attrs"] == {"n": n, "rows": rows}
    calls = _children(spans, 0)
    assert [spans[i]["name"] for i in calls] == ["call:ifft", "call:ifft"]
    assert [spans[i]["attrs"] for i in calls] == [
        {"n": n, "rows": rows}, {"n": rows, "rows": n}]
    ops = [_children(spans, i) for i in calls]
    assert [[spans[j]["name"] for j in o] for o in ops] == [
        ["op:ordered_c2c"], ["op:column_c2c"]]
    assert not [s for s in spans if s["name"] == "copy"]
    assert spans[calls[0]]["end"] <= spans[calls[1]]["start"]


def test_a_traced_ifft2_is_a_root_over_two_row_calls_and_their_copies():
    """On the copy path (a stack of three grids, strides 3n and 3): a root
    over one row call an axis, each around ``op:ordered_c2c`` and its copy
    of the transposed view."""
    rows, n = 256, 512
    x = _grid(rows, n * 3).reshape(rows, n, 3)
    spans, roots = _tree(lambda: S.ifft2(x, axes=(0, 1), norm="backward",
                                         precision="highest"))
    assert [spans[i]["name"] for i in roots] == ["call:ifft2"]
    assert spans[0]["attrs"] == {"n": 3, "rows": rows * n}
    calls = _children(spans, 0)
    assert [spans[i]["name"] for i in calls] == ["call:ifft", "call:ifft"]
    # each pass runs over an axis moved last: its rows are the others
    assert [spans[i]["attrs"] for i in calls] == [
        {"n": rows, "rows": n * 3}, {"n": n, "rows": rows * 3}]
    for i in calls:
        ops = _children(spans, i)
        assert [spans[j]["name"] for j in ops] == ["op:ordered_c2c"]
        copies = [s for s in spans if s["parent"] == ops[0]
                  and s["name"] == "copy"]
        assert [s["attrs"] for s in copies] == [{"bytes": rows * n * 3 * 8}]
        assert spans[i]["start"] <= copies[0]["start"] <= copies[0]["end"] \
            <= spans[i]["end"]
