"""The C2C op of smfft_tpu_torch (its plain PyTorch version, which CPU
tensors run) against smfft_tpu's pallas kernels and float64 numpy.

The same seeded numpy inputs go through both packages.  The JAX side runs
``pallas_c2c.fft_planar`` in interpret mode, as its own tests do, up to
N = 4096 in every layout.  Above that the interpreter traces each kernel
for tens of seconds to minutes on a CPU (N = 8192: 8-34 s, N = 16384:
40-290 s), so at N = 8192 / 16384 the JAX reference is its plain backend
(``backend="xla"``, ordered) with the revblock permutation applied
explicitly.  Tolerances: tol(n) = 5e-7 * n^0.75 * 8 against numpy (the JAX
suite's), 2 * tol(n) against JAX, since both sides sit within tol(n) of
the oracle.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smfft_tpu
import smfft_tpu.ops.pallas_c2c as PC

from smfft_tpu_torch.ops import _cuda
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import fourstep_fused as FF
from smfft_tpu_torch.ops import real as R
from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES

from conftest import max_abs_err
from torch_launch_path import launch_path

INTERPRET_MAX = 4096


@pytest.fixture(autouse=True, scope="module")
def interpret_mode():
    PC.set_interpret(True)
    yield
    PC.set_interpret(False)


def tol(n):
    return 5e-7 * n ** 0.75 * 8


def rand_planar(rng, n, rows=None):
    """Seeded (rows, max(n, 128)) fp32 planes, uniform in [-0.5, 0.5)."""
    if rows is None:
        rows = 16 if n > 4096 else 32
    shape = (rows, max(n, 128))
    return ((rng.random(shape) - 0.5).astype(np.float32),
            (rng.random(shape) - 0.5).astype(np.float32))


def as_transforms(vr, vi, n):
    """Row layout -> complex128 (transforms, n)."""
    return (vr.astype(np.float64) + 1j * vi).reshape(-1, n)


def revblock(a, n):
    """Natural (b, n) -> revblock: position k2*128 + k1 holds k1*C + k2."""
    c = max(1, n // 128)
    return a if c == 1 else a.reshape(-1, 128, c).transpose(0, 2, 1).reshape(
        -1, n)


def port_planar(vr, vi, n, **kw):
    o_r, o_i = C.fft_planar(torch.from_numpy(vr), torch.from_numpy(vi), n,
                            **kw)
    return as_transforms(o_r.numpy(), o_i.numpy(), n)


def jax_planar(vr, vi, n, **kw):
    o_r, o_i = PC.fft_planar(jnp.asarray(vr), jnp.asarray(vi), n, **kw)
    return as_transforms(np.asarray(o_r), np.asarray(o_i), n)


def jax_xla(x, inverse):
    """smfft_tpu's plain backend, ordered, unnormalized."""
    xd = jnp.asarray(x.astype(np.complex64))
    if inverse:
        return np.asarray(smfft_tpu.ifft(xd, backend="xla", norm=None))
    return np.asarray(smfft_tpu.fft(xd, backend="xla"))


def numpy_ref(x, inverse):
    return np.fft.ifft(x) * x.shape[-1] if inverse else np.fft.fft(x)


@pytest.mark.parametrize("n", SUPPORTED_C2C_SIZES)
@pytest.mark.parametrize("inverse", [False, True])
def test_ordered(rng, n, inverse):
    vr, vi = rand_planar(rng, n)
    x = as_transforms(vr, vi, n)
    got = port_planar(vr, vi, n, inverse=inverse, ordered=True)
    assert max_abs_err(got, numpy_ref(x, inverse)) < tol(n)
    if n <= INTERPRET_MAX:
        ref = jax_planar(vr, vi, n, inverse=inverse, ordered=True)
    else:
        ref = jax_xla(x, inverse)
    assert max_abs_err(got, ref) < 2 * tol(n)


@pytest.mark.parametrize("n", [n for n in SUPPORTED_C2C_SIZES if n >= 256])
@pytest.mark.parametrize("inverse", [False, True])
def test_revblock_out(rng, n, inverse):
    """Kernel A unordered: out[k2*128 + k1] = X[k1*C + k2]."""
    vr, vi = rand_planar(rng, n)
    x = as_transforms(vr, vi, n)
    got = port_planar(vr, vi, n, inverse=inverse, ordered=False)
    assert max_abs_err(got, revblock(numpy_ref(x, inverse), n)) < tol(n)
    if n <= INTERPRET_MAX:
        ref = jax_planar(vr, vi, n, inverse=inverse, ordered=False)
    else:
        ref = revblock(jax_xla(x, inverse), n)
    assert max_abs_err(got, ref) < 2 * tol(n)


@pytest.mark.parametrize("n", [n for n in SUPPORTED_C2C_SIZES if n >= 256])
@pytest.mark.parametrize("inverse", [False, True])
def test_revblock_in(rng, n, inverse):
    """Kernel B: revblock in, natural out."""
    vr, vi = rand_planar(rng, n)
    z = as_transforms(vr, vi, n)          # the revblock-ordered rows
    c = n // 128
    natural = z.reshape(-1, c, 128).transpose(0, 2, 1).reshape(-1, n)
    got = port_planar(vr, vi, n, inverse=inverse, rev_in=True)
    assert max_abs_err(got, numpy_ref(natural, inverse)) < tol(n)
    if n <= INTERPRET_MAX:
        ref = jax_planar(vr, vi, n, inverse=inverse, rev_in=True)
    else:
        ref = jax_xla(natural, inverse)
    assert max_abs_err(got, ref) < 2 * tol(n)


@pytest.mark.parametrize("n", [64, 1024])
@pytest.mark.parametrize("mode", [{"ordered": True}, {"ordered": False},
                                  {"rev_in": True, "inverse": True}])
def test_fused_scale(rng, n, mode):
    vr, vi = rand_planar(rng, n)
    got = port_planar(vr, vi, n, scale=0.25, **mode)
    want = port_planar(vr * 0.25, vi * 0.25, n, **mode)
    assert max_abs_err(got, want) < 1e-6
    ref = jax_planar(vr, vi, n, scale=jnp.float32(0.25), **mode)
    assert max_abs_err(got, ref) < 2 * tol(n)


@pytest.mark.parametrize("n,pack", [(32, 4), (64, 2)])
def test_packing_divisibility(n, pack):
    with pytest.raises(ValueError, match=f"multiple of {pack}"):
        C.fft_complex(torch.zeros((3, n), dtype=torch.complex64))
    with pytest.raises(ValueError, match=f"multiple of {pack}"):
        PC.fft_pallas(jnp.zeros((3, n), jnp.complex64))
    assert C.fft_complex(torch.zeros((pack, n),
                                     dtype=torch.complex64)).shape == (pack, n)


@pytest.mark.parametrize("n", [32, 256, 4096, 16384])
def test_unordered_round_trip(rng, n):
    """fft(ordered=False) |> kernel B inverse == N * x, no reordering."""
    vr, vi = rand_planar(rng, n, rows=8)
    x = torch.from_numpy(as_transforms(vr, vi, n).astype(np.complex64))
    u = C.fft_complex(x, ordered=False)
    back = C.fft_complex(u, inverse=True, rev_in=True, scale=1.0 / n)
    assert max_abs_err(back.numpy(), x.numpy()) < tol(n)


def test_complex_matches_planar(rng):
    n = 512
    vr, vi = rand_planar(rng, n)
    x = torch.from_numpy(as_transforms(vr, vi, n).astype(np.complex64))
    got = C.fft_complex(x.reshape(4, 8, n), ordered=False).reshape(-1, n)
    assert max_abs_err(got.numpy(), port_planar(vr, vi, n)) == 0.0
    ref = np.asarray(PC.fft_pallas(jnp.asarray(x.numpy()), ordered=False))
    assert max_abs_err(got.numpy(), ref) < 2 * tol(n)
    back = C.fft_complex(got, inverse=True, rev_in=True)
    ref_back = np.asarray(PC.ifft_pallas_rev(jnp.asarray(ref)))
    assert max_abs_err(back.numpy(), ref_back) < 2 * tol(n) * n


def test_plain_version_never_calls_torch_fft(rng, monkeypatch):
    """torch.fft is the oracle, never the implementation."""
    def boom(*a, **k):
        raise AssertionError("torch.fft called")
    for name in ("fft", "ifft"):
        monkeypatch.setattr(torch.fft, name, boom)
    vr, vi = rand_planar(rng, 1024)
    port_planar(vr, vi, 1024, ordered=True)


def test_cpu_tensor_never_reaches_kernel(rng, monkeypatch):
    """CPU tensors run the plain version: no build, no launch."""
    def boom():
        raise AssertionError("kernel library requested for a CPU tensor")
    monkeypatch.setattr(_cuda, "library", boom)
    before = _cuda.C2C_RUN.count
    vr, vi = rand_planar(rng, 256)
    port_planar(vr, vi, 256, ordered=True)
    assert _cuda.C2C_RUN.count == before


# ---------------------------------------------------------------------------
# The launch plan cache and the launch path, on CPU tensors with the one
# launch path stood in: the library, the row check, the stream accessor and
# the current device; the guard recorded.
# ---------------------------------------------------------------------------


class _PlanLib:
    """The kernel library's C2C entry points, recording their calls, and
    the R2C and pass kernels', recorded as runs."""

    def __init__(self):
        self.prepared, self.runs, self.err = [], [], 0

    def smfft_c2c_plan_bytes(self):
        return 40

    def smfft_c2c_prepare(self, *args):
        self.prepared.append(args)
        return self.err

    def smfft_c2c_run(self, *args):
        self.runs.append(args)
        return 0

    smfft_r2c = smfft_fourstep_pass = smfft_c2c_run

    def smfft_error_string(self, err):
        return b"stand-in error"


@pytest.fixture
def plan_path(monkeypatch):
    """The card path on CPU tensors (``launch_path``), with an empty plan
    cache; the current device is 0, so a tensor's device is another one
    (-1) unless a test says otherwise."""
    lib = _PlanLib()
    lib.streams, lib.guards = [], []

    def raw_stream(index):
        lib.streams.append(index)
        return 1000 + len(lib.streams)

    def guard(d):
        lib.guards.append(d)
        return contextlib.nullcontext()
    monkeypatch.setattr(torch.cuda, "device", guard)
    return launch_path(monkeypatch, lib, current=lambda: 0,
                       stream=raw_stream)


def _rows_c(b, n, device=None):
    x = torch.zeros((b, n), dtype=torch.complex64)
    if device is not None:
        x.get_device = lambda: device
    return x


def test_one_key_builds_one_plan(plan_path):
    plans, count = C.launch.plans, _cuda.C2C_RUN.count
    x = _rows_c(8, 256)
    C.launch(x)
    C.launch(x)
    assert (C.launch.plans, _cuda.C2C_RUN.count) == (plans + 1, count + 2)
    assert len(plan_path.prepared) == 1 and len(plan_path.runs) == 2
    # both runs take the one prepared plan's constants
    assert plan_path.runs[0][0] == plan_path.runs[1][0]
    assert plan_path.prepared[0][0] == plan_path.runs[0][0]
    assert plan_path.prepared[0][1:7] == (256, 0, 1, 0, 0, 0)


_KEYED = {
    "n": ((_rows_c(8, 512),), {}),
    "layout": ((torch.zeros(8, 256), torch.zeros(8, 256)), {}),
    "device": ((_rows_c(8, 256, device=3),), {}),
    "inverse": ((_rows_c(8, 256),), {"inverse": True}),
    "rev_in": ((_rows_c(8, 256),), {"rev_in": True}),
    "rev_out": ((_rows_c(8, 256),), {"rev_out": True}),
    "exact": ((_rows_c(8, 256),), {"exact": True}),
}


@pytest.mark.parametrize("field", list(_KEYED))
def test_each_keyed_field_builds_a_plan(plan_path, field):
    C.launch(_rows_c(8, 256))
    plans = C.launch.plans
    args, kw = _KEYED[field]
    C.launch(*args, **kw)
    assert C.launch.plans == plans + 1
    assert len(C._plans) == 2
    C.launch(*args, **kw)
    assert C.launch.plans == plans + 1


def test_batch_and_scale_ride_with_each_launch(plan_path):
    plans = C.launch.plans
    C.launch(_rows_c(8, 256))
    C.launch(_rows_c(24, 256), scale=0.5)
    C.launch(_rows_c(3, 256), scale=2)
    assert C.launch.plans == plans + 1
    assert [r[5:7] for r in plan_path.runs] == [(8, 1.0), (24, 0.5),
                                                (3, 2.0)]


def test_planar_launch_passes_both_planes(plan_path):
    xr, xi = torch.zeros(8, 256), torch.ones(8, 256)
    o_r, o_i = C.launch(xr, xi)
    run = plan_path.runs[0]
    assert run[1:5] == (xr.data_ptr(), xi.data_ptr(), o_r.data_ptr(),
                        o_i.data_ptr())
    assert plan_path.prepared[0][3] == 0
    x = _rows_c(8, 256)
    y = C.launch(x)
    assert plan_path.runs[1][1:5] == (x.data_ptr(), None, y.data_ptr(), None)
    assert plan_path.prepared[1][3] == 1


def test_plan_cache_keeps_its_size(plan_path, monkeypatch):
    """Past PLAN_SLOTS the least recently used plan goes; a plan used
    since it was built stays."""
    monkeypatch.setattr(C, "PLAN_SLOTS", 3)
    sizes = (256, 512, 1024)
    for n in sizes:
        C.launch(_rows_c(8, n))
    C.launch(_rows_c(8, 256))      # 256 is now the most recently used
    plans = C.launch.plans
    C.launch(_rows_c(8, 2048))     # evicts 512
    assert len(C._plans) == 3
    assert sorted(k[0] for k in C._plans) == [256, 1024, 2048]
    C.launch(_rows_c(8, 256))
    assert C.launch.plans == plans + 1
    C.launch(_rows_c(8, 512))
    assert C.launch.plans == plans + 2
    assert len(C._plans) == 3
    for n in SUPPORTED_C2C_SIZES:
        C.launch(_rows_c(128, n))
        assert len(C._plans) == 3
    # at its own size: nothing goes before the cache is full, then one
    # plan a miss
    monkeypatch.setattr(C, "PLAN_SLOTS", 64)
    monkeypatch.setattr(C, "_plans", {})
    keys = [(n, dict(inverse=i, rev_in=r, rev_out=o, exact=e))
            for n in SUPPORTED_C2C_SIZES for i in (False, True)
            for r in (False, True) for o in (False, True)
            for e in (False, True)]
    for i, (n, kw) in enumerate(keys[:70]):
        C.launch(_rows_c(128, n), **kw)
        assert len(C._plans) == min(i + 1, 64)


def _one_launch(kernel: str, monkeypatch):
    """A launch of ``kernel`` on CPU rows, as a function of no argument."""
    if kernel == "c2c":
        x = _rows_c(8, 256)
        return lambda: C.launch(x)
    if kernel == "r2c":
        x = torch.zeros(8, 256)
        return lambda: R.launch_r2c(x)
    monkeypatch.setattr(FF, "_operand", lambda t, n, name: (0, None, 0))
    n = 1 << 15
    x = torch.zeros((2, n), dtype=torch.complex64)
    return lambda: FF.launch_pass(x, x, n, FF.default_passes(n)[0])


@pytest.mark.parametrize("kernel", ["c2c", "r2c", "fourstep_pass"])
def test_stream_is_read_and_guard_taken_per_launch(plan_path, monkeypatch,
                                                   kernel):
    """Every launch reads its device's current stream and passes it last;
    the guard is taken only where the tensor's device is not the current
    one, for the C2C plan's prepare too."""
    launch = _one_launch(kernel, monkeypatch)
    launch()
    launch()
    assert plan_path.streams == [-1, -1]
    assert [r[-1] for r in plan_path.runs] == [1001, 1002]
    # one guard a launch on another device, and the C2C plan's prepare
    guards = [-1] * (3 if kernel == "c2c" else 2)
    assert plan_path.guards == guards
    monkeypatch.setattr(_cuda, "_current_device", lambda: -1)
    launch()
    assert plan_path.guards == guards
    assert plan_path.runs[-1][-1] == 1003


def test_a_failed_build_caches_nothing(plan_path):
    plan_path.err = 700
    plans, count = C.launch.plans, _cuda.C2C_RUN.count
    with pytest.raises(RuntimeError, match="stand-in error"):
        C.launch(_rows_c(8, 256))
    assert (C.launch.plans, _cuda.C2C_RUN.count) == (plans, count)
    assert not C._plans and not plan_path.runs
    plan_path.err = 0
    C.launch(_rows_c(8, 256))
    assert (C.launch.plans, _cuda.C2C_RUN.count) == (plans + 1, count + 1)


def test_launch_refuses_what_the_plan_cannot_carry(plan_path):
    """The checks a plan's key cannot hold run on every launch: a hit
    refuses a conjugate view, rows that are not 2-D or contiguous, and a
    planar pair that differs."""
    x = _rows_c(8, 256)
    C.launch(x)
    with pytest.raises(ValueError, match="conjugate view"):
        C.launch(x.conj())
    C.launch(torch.zeros(8, 256), torch.zeros(8, 256))
    with pytest.raises(ValueError, match="planar pair"):
        C.launch(torch.zeros(8, 256), torch.zeros(4, 256))
    assert len(plan_path.runs) == 2


def test_cpu_tensor_never_builds_a_plan(rng, monkeypatch):
    """CPU tensors run the plain version through fft_complex and
    fft_planar: no plan, no library."""
    def boom():
        raise AssertionError("kernel library requested for a CPU tensor")
    monkeypatch.setattr(_cuda, "library", boom)
    plans, count = C.launch.plans, _cuda.C2C_RUN.count
    x = torch.from_numpy(as_transforms(*rand_planar(rng, 256), 256)
                         .astype(np.complex64))
    C.fft_complex(x)
    C.fft_complex(x.conj(), inverse=True, scale=0.5)
    port_planar(*rand_planar(rng, 256), 256, ordered=True)
    assert (C.launch.plans, _cuda.C2C_RUN.count) == (plans, count)


def test_fft_complex_hands_the_plan_resolved_rows(plan_path, monkeypatch):
    """fft_complex's card path: contiguous rows go to the launch as they
    are; a conjugate view or a strided input is resolved first, and the
    output takes the input's shape."""
    monkeypatch.setattr(C, "is_cpu", lambda t: False)
    x = _rows_c(8, 256)
    y = C.fft_complex(x)
    assert plan_path.runs[-1][1] == x.data_ptr() and y.shape == x.shape
    z = torch.zeros((2, 256, 4), dtype=torch.complex64).transpose(1, 2)
    for v in (z, z.contiguous().conj()):
        y = C.fft_complex(v, ordered=False)
        assert plan_path.runs[-1][1] not in (v.data_ptr(), None)
        assert y.shape == (2, 4, 256)
    assert C.launch.plans >= 1 and len(C._plans) == 2
    with pytest.raises(ValueError, match="multiple of 4"):
        C.fft_complex(_rows_c(3, 32))
