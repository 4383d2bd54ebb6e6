"""N-D transforms and spectral helpers of smfft_tpu_torch (``ndim.py``)
on CPU tensors, against ``smfft_tpu.ndim`` and float64 numpy.

The same numpy-seeded inputs go through the JAX module with
``backend="xla"`` (one call per shape and function, cached for the
module: each call compiles for about half a second) and through the
port's plain versions, parametrised on the port's side.  Tolerances:
1e-4 * max|ref| against the JAX package; against float64 numpy the
summed bound of the passes, sum over the transformed axes of bound(m) =
2e-7 * m^0.75 * 8 (m the axis length), times max|ref|.  The revblock
form ``fftn(ordered=False)`` is held against the JAX package's pallas
backend in interpret mode, whose layout the port follows.
"""

import ast
import functools
import importlib
import itertools
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smfft_tpu.ops.pallas_c2c as PC

import smfft_tpu_torch as T
from smfft_tpu_torch.parallel import dryrun as DR

JN = importlib.import_module("smfft_tpu.ndim")
ROOT = Path(__file__).resolve().parent.parent

# complex (3, 64, 128) for 2-D and single-axis passes, (32, 32, 64) for a
# transform over every axis; real (4, 64, 256) and (2, 32, 64, 128)
C2 = (3, 64, 128)
C3 = (32, 32, 64)
R2 = (4, 64, 256)
R3 = (2, 32, 64, 128)
HALF = (4, 129)          # hfft input: n = 256 by default


def bound(m):
    return 2e-7 * m ** 0.75 * 8


def summed_bound(shape, axes):
    return sum(bound(shape[a]) for a in axes)


@functools.lru_cache(maxsize=None)
def data(shape, kind, seed=0):
    rng = np.random.default_rng(seed + len(shape) * 100 + shape[-1])
    x = rng.random(shape) - 0.5
    if kind == "complex":
        x = x + 1j * (rng.random(shape) - 0.5)
        return x.astype(np.complex64)
    return x.astype(np.float32)


@functools.lru_cache(maxsize=None)
def spectrum(shape, axes):
    """The complex64 half spectrum of data(shape, "real") over axes
    (default: the last two, irfft2's)."""
    x = data(shape, "real").astype(np.float64)
    return np.fft.rfftn(x, axes=(-2, -1) if axes is None else axes).astype(
        np.complex64)


@functools.lru_cache(maxsize=None)
def jax_ref(name, shape, kind, **kw):
    """The JAX module's function on data(shape, kind) (for the C2R
    inverses: on spectrum(shape, axes)), backend="xla"."""
    if name.startswith("irfft"):
        x = spectrum(shape, kw.get("axes"))
    else:
        x = data(shape, kind)
    return np.asarray(getattr(JN, name)(jnp.asarray(x), backend="xla", **kw))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a.astype(np.complex128) - b).max() / np.abs(b).max())


# (name, shape, kind, kw, numpy oracle, axes of the summed bound)
CASES = {
    "fft2": ("fft2", C2, "complex", {},
             lambda x: np.fft.fft2(x), (1, 2)),
    "ifft2": ("ifft2", C2, "complex", {},
              lambda x: np.fft.ifft2(x), (1, 2)),
    "ifft2_raw": ("ifft2", C2, "complex", {"norm": None},
                  lambda x: np.fft.ifft2(x) * 64 * 128, (1, 2)),
    "fftn_all": ("fftn", C3, "complex", {},
                 lambda x: np.fft.fftn(x), (0, 1, 2)),
    "fftn_mid": ("fftn", C2, "complex", {"axes": 1},
                 lambda x: np.fft.fftn(x, axes=(1,)), (1,)),
    "fftn_first_last": ("fftn", C3, "complex", {"axes": (-1, 0)},
                        lambda x: np.fft.fftn(x, axes=(-1, 0)), (0, 2)),
    "ifftn_all": ("ifftn", C3, "complex", {},
                  lambda x: np.fft.ifftn(x), (0, 1, 2)),
    "ifftn_mid": ("ifftn", C2, "complex", {"axes": (1,)},
                  lambda x: np.fft.ifftn(x, axes=(1,)), (1,)),
    "rfft2": ("rfft2", R2, "real", {},
              lambda x: np.fft.rfft2(x), (1, 2)),
    "rfft2_outer": ("rfft2", R3, "real", {"axes": (1, 3)},
                    lambda x: np.fft.rfft2(x, axes=(1, 3)), (1, 3)),
    "rfftn": ("rfftn", R3, "real", {"axes": (1, 2, 3)},
              lambda x: np.fft.rfftn(x, axes=(1, 2, 3)), (1, 2, 3)),
    "rfftn_last2": ("rfftn", R3, "real", {"axes": (-2, -1)},
                    lambda x: np.fft.rfftn(x, axes=(-2, -1)), (2, 3)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_c2c_and_r2c_match_jax_and_numpy(case):
    name, shape, kind, kw, oracle, axes = CASES[case]
    x = data(shape, kind)
    got = getattr(T, name)(torch.from_numpy(x), **kw).numpy()
    ref = jax_ref(name, shape, kind, **kw)
    want = oracle(x.astype(np.complex128 if kind == "complex"
                           else np.float64))
    assert got.shape == ref.shape == want.shape
    assert got.dtype == np.complex64
    assert rel(got, ref) <= 1e-4
    ax = axes or tuple(range(len(shape)))
    assert rel(got, want) <= summed_bound(shape, ax)


@pytest.mark.parametrize("name,shape,axes", [
    ("irfft2", R2, None), ("irfftn", R3, (1, 2, 3)),
    ("irfftn", R3, (-2, -1)), ("irfft2", R3, (1, 3))])
def test_c2r_matches_jax_and_numpy(name, shape, axes):
    """irfft2 / irfftn of rfftn's output: the C2C inverse over the leading
    axes and the C2R kernel over the last, with numpy's normalization."""
    x = data(shape, "real")
    kw = {} if axes is None else {"axes": axes}
    spec = spectrum(shape, axes)
    got = getattr(T, name)(torch.from_numpy(spec), **kw).numpy()
    ref = jax_ref(name, shape, "real", **kw)
    ax = axes if axes is not None else (len(shape) - 2, len(shape) - 1)
    want = getattr(np.fft, name)(spec.astype(np.complex128), axes=ax,
                                 s=[shape[a] for a in ax])
    assert got.shape == ref.shape == want.shape == shape
    assert got.dtype == np.float32
    assert rel(got, ref) <= 1e-4
    assert rel(got, want) <= summed_bound(shape, ax)
    assert rel(got, x) <= summed_bound(shape, ax) * 2


def test_c2c_round_trips():
    x = torch.from_numpy(data(C3, "complex"))
    for fwd, inv in ((T.fft2, T.ifft2), (T.fftn, T.ifftn)):
        assert rel(inv(fwd(x)), x.numpy()) <= 2 * summed_bound(C3, (0, 1, 2))


@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
@pytest.mark.parametrize("n", [None, 128, 512])
def test_hfft_matches_jax_and_numpy(norm, n):
    """hfft on the C2R kernel (conj, raw C2R, 2 * scale): n pads or
    truncates the half-spectrum to n/2 + 1 bins."""
    x = data(HALF, "complex")
    got = T.hfft(torch.from_numpy(x), n=n, norm=norm).numpy()
    ref = jax_ref("hfft", HALF, "complex", n=n, norm=norm)
    want = np.fft.hfft(x.astype(np.complex128), n=n, norm=norm)
    m = n or 256
    assert got.shape == ref.shape == want.shape == (4, m)
    assert got.dtype == np.float32
    assert rel(got, ref) <= 1e-4
    assert rel(got, want) <= bound(m)


@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
@pytest.mark.parametrize("n", [None, 128, 512])
def test_ihfft_matches_jax_and_numpy(norm, n):
    x = data((4, 256), "real")
    got = T.ihfft(torch.from_numpy(x), n=n, norm=norm).numpy()
    ref = jax_ref("ihfft", (4, 256), "real", n=n, norm=norm)
    want = np.fft.ihfft(x.astype(np.float64), n=n, norm=norm)
    m = n or 256
    assert got.shape == ref.shape == want.shape == (4, m // 2 + 1)
    assert got.dtype == np.complex64
    assert rel(got, ref) <= 1e-4
    assert rel(got, want) <= bound(m)


def test_unordered_fftn_is_the_pallas_revblock_layout():
    """fftn(ordered=False) over one axis at N = 256 equals the JAX
    package's pallas output (interpret mode): revblock, which the port
    follows (its xla backend is digit-reversed instead)."""
    x = data((4, 256), "complex")
    PC.set_interpret(True)
    try:
        ref = np.asarray(JN.fftn(jnp.asarray(x), axes=-1, ordered=False,
                                 backend="pallas"))
    finally:
        PC.set_interpret(False)
    got = T.fftn(torch.from_numpy(x), axes=-1, ordered=False).numpy()
    assert rel(got, ref) <= 1e-4
    assert rel(got, np.fft.fft(x.astype(np.complex128))) > 0.1


@pytest.mark.parametrize("shape,axes", [
    ((5,), None), ((7, 4), None), ((4, 9), 1), ((5, 7, 3), (0, 2)),
    ((6, 5), -1), ((3, 8), (-2,))])
@pytest.mark.parametrize("which", ["fftshift", "ifftshift"])
def test_shifts_match_numpy_at_any_length(shape, axes, which):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    got = getattr(T, which)(torch.from_numpy(x), axes=axes).numpy()
    np.testing.assert_array_equal(got, getattr(np.fft, which)(x, axes=axes))
    np.testing.assert_array_equal(
        got, np.asarray(getattr(JN, which)(jnp.asarray(x), axes=axes)))


def test_shifts_undo_each_other_on_complex_rows():
    x = torch.from_numpy(data((3, 5, 7), "complex"))
    assert torch.equal(T.ifftshift(T.fftshift(x)), x)


@pytest.mark.parametrize("n,d", [(8, 1.0), (9, 0.1), (1024, 1 / 48000)])
@pytest.mark.parametrize("which", ["fftfreq", "rfftfreq"])
def test_frequencies_match_jax(n, d, which):
    got = getattr(T, which)(n, d)
    ref = np.asarray(getattr(JN, which)(n, d))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# Error texts: the port raises what the JAX package raises, word for word.
# ---------------------------------------------------------------------------


ERRORS = {
    "repeated_axis": lambda m, x: m.fftn(x, axes=(1, -2)),
    "unordered_two_axes": lambda m, x: m.fftn(x, axes=(1, 2),
                                               ordered=False),
    "rfft2_last_axis": lambda m, x: m.rfft2(x.real, axes=(2, 1)),
    "rfftn_last_axis": lambda m, x: m.rfftn(x.real, axes=(0, 1)),
    "irfftn_last_axis": lambda m, x: m.irfftn(x, axes=(2, 0)),
    "irfft2_last_axis": lambda m, x: m.irfft2(x, axes=(0, 1)),
    "hfft_norm": lambda m, x: m.hfft(x, norm="sideways"),
    "ihfft_norm": lambda m, x: m.ihfft(x.real, norm="sideways"),
    "fft2_size": lambda m, x: m.fft2(x[:, :, :100]),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_error_texts_match_jax(case):
    x = data(C2, "complex")
    with pytest.raises(ValueError) as jax_err:
        ERRORS[case](JN, jnp.asarray(x))
    with pytest.raises(ValueError) as port_err:
        ERRORS[case](T, torch.from_numpy(x))
    assert str(port_err.value).split(";")[0] == \
        str(jax_err.value).split(";")[0]


def test_irfft2_with_a_length_that_does_not_fit_raises():
    spec = torch.from_numpy(data((4, 64, 129), "complex"))
    with pytest.raises(ValueError, match="n=512 takes 257 bins"):
        T.irfft2(spec, n=512)


def test_packing_rule_raises_as_the_pallas_path_does():
    """An axis of 32 C2C points, or of 64 real samples, packs 4
    transforms a row: a batch that is not a multiple of 4 raises."""
    with pytest.raises(ValueError, match="multiple of 4"):
        T.fftn(torch.from_numpy(data((3, 32), "complex")), axes=-1)
    with pytest.raises(ValueError, match="multiple of 4"):
        T.ihfft(torch.from_numpy(data((3, 64), "real")))


# ---------------------------------------------------------------------------
# The column route: a C2C over a leading axis at a power-of-two stride runs
# as column passes at that stride (ops/fourstep_fused.run_columns), with no
# copy; any other stride keeps the copy of the transposed view.
# ---------------------------------------------------------------------------


def counters():
    return DR.copied_bytes(), DR.column_routes()


def moved(before):
    """(bytes copied, column routes run) since ``before``."""
    now = counters()
    return now[0] - before[0], now[1] - before[1]


# (M, K): the axis's length and its stride; one pass to M = 2048, two above
COLUMN_GRIDS = [(32, 4), (2048, 2), (4096, 4), (16384, 2)]


@pytest.mark.parametrize("shape", COLUMN_GRIDS)
@pytest.mark.parametrize("name", ["fftn", "ifftn"])
def test_column_route_over_the_leading_axis_matches_jax_and_torch(name,
                                                                  shape):
    x = data(shape, "complex")
    before = counters()
    got = getattr(T, name)(torch.from_numpy(x), axes=(0,))
    assert moved(before) == (0, 1)
    ref = jax_ref(name, shape, "complex", axes=(0,))
    want = getattr(torch.fft, name)(torch.from_numpy(x).to(torch.complex128),
                                    dim=0).numpy()
    assert got.shape == shape and got.dtype == torch.complex64
    assert got.is_contiguous()
    assert rel(got.numpy(), ref) <= 1e-4
    assert rel(got.numpy(), want) <= bound(shape[0])


@pytest.mark.parametrize("m", [32, 2048, 4096, 16384])
@pytest.mark.parametrize("name,kw", [("fft2", {}), ("ifft2", {}),
                                     ("ifft2", {"norm": None})])
def test_column_route_in_2d_transforms_matches_jax_and_torch(name, kw, m):
    """fft2 / ifft2 of an (M, 32) grid: the row call over the last axis,
    then the column route over the first; ``norm`` scales the first
    column pass (None: the raw inverse)."""
    shape = (m, 32)
    x = data(shape, "complex")
    before = counters()
    got = getattr(T, name)(torch.from_numpy(x), **kw).numpy()
    assert moved(before) == (0, 1)
    ref = jax_ref(name, shape, "complex", **kw)
    want = getattr(np.fft, name)(x.astype(np.complex128))
    if kw.get("norm", "backward") is None:
        want = want * x.size
    assert rel(got, ref) <= 1e-4
    assert rel(got, want) <= summed_bound(shape, (0, 1))


@pytest.mark.parametrize("axes", list(itertools.permutations((0, 1, 2))))
@pytest.mark.parametrize("name", ["fftn", "ifftn"])
def test_column_route_over_every_axis_order_of_a_3d_grid(name, axes):
    """(B, M, K) = (32, 256, 64) in each axis order: the last axis's row
    call first, then a column route a leading axis (strides 16384 and
    64), in the order given."""
    shape = (32, 256, 64)
    x = data(shape, "complex")
    before = counters()
    got = getattr(T, name)(torch.from_numpy(x), axes=axes).numpy()
    assert moved(before) == (0, 2)
    ref = jax_ref(name, shape, "complex", axes=axes)
    want = getattr(np.fft, name)(x.astype(np.complex128), axes=axes)
    assert rel(got, ref) <= 1e-4
    assert rel(got, want) <= summed_bound(shape, axes)


@pytest.mark.parametrize("norm", [None, "backward"])
def test_column_route_exact_tier_rounds_once(norm):
    """"exact" computes both column passes in float64 (the card's
    complex128 intermediate) and rounds once: within one ulp(max|X|) of
    float64, where the fp32 tier is not."""
    x = torch.from_numpy(data((4096, 32), "complex"))
    want = torch.fft.ifft2(x.to(torch.complex128))
    if norm is None:
        want = want * x.numel()
    got = T.ifft2(x, norm=norm, precision="exact")
    top = want.abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 23)
    assert got.dtype == torch.complex64
    assert (got.to(torch.complex128) - want).abs().max().item() <= ulp
    fp32 = T.ifft2(x, norm=norm)
    assert (fp32.to(torch.complex128) - want).abs().max().item() > ulp


def test_a_stride_that_is_no_power_of_two_keeps_the_copy_path():
    """fftn over the first axis of (256, 96): a stride of 96 is no power
    of two, so the axis moves last and its transposed view is copied once
    (256 * 96 * 8 bytes), with no column route."""
    x = data((256, 96), "complex")
    before = counters()
    got = T.fftn(torch.from_numpy(x), axes=(0,)).numpy()
    assert moved(before) == (256 * 96 * 8, 0)
    want = np.fft.fft(x.astype(np.complex128), axis=0)
    assert rel(got, want) <= bound(256)
    assert rel(got, jax_ref("fftn", (256, 96), "complex", axes=(0,))) <= 1e-4


@pytest.mark.parametrize("call,copies", [
    (lambda x: T.fftn(x, axes=0, ordered=False), True),
    (lambda x: T.fftn(x, axes=0, backend="spec"), False),
    (lambda x: T.rfft2(x.real.contiguous()), True),
    (lambda x: T.irfft2(x[:, :65].contiguous(), n=128), True)])
def test_the_column_route_leaves_other_calls_on_the_copy_path(call, copies):
    """Unordered output, the spec backend (which transforms the transposed
    view as it is) and the real 2-D transforms (half-spectrum stride n/2 +
    1) run no column route."""
    before = counters()
    call(torch.from_numpy(data((128, 128), "complex")))
    copied, routes = moved(before)
    assert routes == 0 and (copied > 0) == copies


def test_the_column_route_leaves_its_input_as_it_was():
    """The first column pass runs in place only on the row call's own
    result, never on the caller's tensor."""
    x = torch.from_numpy(data((4096, 4), "complex"))
    keep = x.clone()
    T.fftn(x, axes=(0,))
    T.ifft2(torch.from_numpy(data((2048, 32), "complex")))
    T.fftn(x.conj(), axes=(0,))
    assert torch.equal(x, keep)


@pytest.mark.parametrize("shape,kw", [
    ((4096, 2), {"norm": "backward"}), ((4096, 2), {"norm": None}),
    ((4096, 2), {"precision": "exact"}), ((64, 32, 2), {})])
def test_gradcheck_through_the_column_route(shape, kw):
    """The route's Function: the backward of a transform of scale s is
    the raw transform of the other direction at scale s, by the column
    route again."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.random(shape) + 1j * rng.random(shape)
                         ).requires_grad_(True)
    before = counters()
    assert torch.autograd.gradcheck(
        lambda v: T.ifftn(v, axes=tuple(range(len(shape) - 1)), **kw),
        (x,), fast_mode=True)
    assert moved(before)[1] > 0


def fused_count():
    return DR.column_fused()


@pytest.mark.parametrize("name", ["fftn", "ifftn"])
@pytest.mark.parametrize("shape,ax,kw,fused", [
    ((4096, 64), 0, {}, True), ((8192, 64), 0, {}, True),
    ((16384, 32), 0, {}, True), ((2, 4096, 128), 1, {}, True),
    ((4096, 32), 0, {}, False), ((16384, 16), 0, {}, False),
    ((4096, 64), 0, {"precision": "exact"}, False)])
def test_column_route_launches_with_stand_in_launchers(monkeypatch, name,
                                                       shape, ax, kw, fused):
    """The card path of the column route over the leading axis (the pass
    kernel stood in by its plain function): one launch, pass A carrying
    pass B (``run_columns.fused`` counted), where the plan is fp32 and a
    slab of W columns fits the stride (W = 64 at M = 4096 and 8192, 32 at
    16384; a batch of two grids over the middle axis too); two launches where the stride is narrower or the tier is
    "exact"; the values are the CPU path's."""
    from tests.torch_launch_path import column_launches
    x = torch.from_numpy(data(shape, "complex"))
    cpu = getattr(T, name)(x, axes=(ax,), **kw)
    log = column_launches(monkeypatch)
    before, routes = fused_count(), DR.column_routes()
    got = getattr(T, name)(x, axes=(ax,), **kw)
    assert DR.column_routes() - routes == 1
    assert fused_count() - before == int(fused)
    assert [p.then is not None for p, _ in log] == ([True] if fused
                                                    else [False, False])
    assert [at for _, at in log] == ([(1, 2, "col")] if fused
                                     else [(1, 2, "col"), (2, 2, "col")])
    assert torch.equal(got, cpu)


@pytest.mark.parametrize("name", ["fftn", "ifftn"])
def test_a_16384_square_column_call_is_one_launch(monkeypatch, name):
    """The imaging cell's grid, 16384^2 (made, never written: the stand-in
    launcher makes its outputs and computes nothing): the column route over
    the leading axis is one launch of radix 128 carrying radix 128, no
    byte copied, ``run_columns.fused`` counted once."""
    from tests.torch_launch_path import column_launches
    x = torch.empty((16384, 16384), dtype=torch.complex64)
    log = column_launches(monkeypatch, compute=False)
    before = counters() + (fused_count(),)
    y = getattr(T, name)(x, axes=(0,))
    assert y.shape == x.shape and y.dtype == torch.complex64
    assert [(p.radix, p.then.radix, at) for p, at in log] == [
        (128, 128, (1, 2, "col"))]
    assert moved(before[:2]) == (0, 1) and fused_count() - before[2] == 1


# ---------------------------------------------------------------------------
# Gradients and real-input promotion.
# ---------------------------------------------------------------------------


def test_gradcheck_fft2():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((4, 32, 32))
                         + 1j * rng.random((4, 32, 32))).requires_grad_(True)
    assert torch.autograd.gradcheck(T.fft2, (x,), fast_mode=True)


def test_gradcheck_rfft2():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((4, 64, 64))).requires_grad_(True)
    assert torch.autograd.gradcheck(T.rfft2, (x,), fast_mode=True)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.bool_,
                                   np.float16])
def test_rfft2_promotes_real_inputs_as_jax_does(dtype):
    rng = np.random.default_rng(7)
    x = (rng.random(R2) * 20 - 10).astype(dtype)
    got = T.rfft2(torch.from_numpy(x))
    ref = np.asarray(JN.rfft2(jnp.asarray(x), backend="xla"))
    assert got.dtype == torch.complex64 and ref.dtype == np.complex64
    assert rel(got.numpy(), ref) <= 1e-4


def all_names(package):
    """The string literals of ``__all__`` in a package's __init__.py, read
    by AST (no import)."""
    tree = ast.parse((ROOT / package / "__init__.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__"
                        for t in node.targets)):
            return {elt.value for elt in node.value.elts}
    raise AssertionError(f"{package}/__init__.py has no __all__")


def test_public_names_cover_the_jax_package():
    """smfft_tpu_torch.__all__ holds every name of smfft_tpu.__all__ (57),
    the 14 of ndim.py and the 8 of dct.py among them, and each is bound."""
    jax_names, port_names = all_names("smfft_tpu"), all_names(
        "smfft_tpu_torch")
    assert len(jax_names) == 57
    assert jax_names <= port_names, sorted(jax_names - port_names)
    assert port_names == set(T.__all__)
    assert all(hasattr(T, name) for name in port_names)
