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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smfft_tpu
import smfft_tpu.ops.pallas_c2c as PC

from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES

from conftest import max_abs_err

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
    from smfft_tpu_torch.ops import _cuda

    def boom():
        raise AssertionError("kernel library requested for a CPU tensor")
    monkeypatch.setattr(_cuda, "library", boom)
    before = C.launch.count
    vr, vi = rand_planar(rng, 256)
    port_planar(vr, vi, 256, ordered=True)
    assert C.launch.count == before
