"""Overlap-save linear convolution of smfft_tpu_torch (``signal.py``:
``fftconvolve``, ``oaconvolve``, ``fftcorrelate``) against smfft_tpu's
functions of the same names and numpy / scipy in float64.

The same seeded numpy signals and taps go through both packages; the JAX
side runs its fused convolution kernels in interpret mode
(``backend="pallas"``), as tests/test_signal.py does.  Tolerances: each
output sample is one fused circular convolution of an n_fft-point frame,
so tol(n_fft) = 5e-7 * n_fft^0.75 * 8 scaled by the data's magnitude
(uniform in [-1, 1), taps likewise, so |y| <= K): tol(n_fft) * sqrt(K)
against float64, twice that against the JAX function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

import smfft_tpu.ops.pallas_c2c as PC
import smfft_tpu.signal as JS

import smfft_tpu_torch as T
from smfft_tpu_torch import signal as TS
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import convolve as CV
from smfft_tpu_torch.ops import real as R

from conftest import max_abs_err


@pytest.fixture(autouse=True, scope="module")
def interpret_mode():
    PC.set_interpret(True)
    yield
    PC.set_interpret(False)


def bound(k, n_fft=None):
    n = n_fft or TS._pick_nfft(k)
    return 5e-7 * n ** 0.75 * 8 * np.sqrt(k)


def rand(rng, *shape, complex_=False):
    x = rng.random(shape) * 2 - 1
    if complex_:
        x = x + 1j * (rng.random(shape) * 2 - 1)
        return x.astype(np.complex64)
    return x.astype(np.float32)


def to_jax(x):
    if np.iscomplexobj(x):
        return jax.lax.complex(jnp.asarray(np.ascontiguousarray(x.real)),
                               jnp.asarray(np.ascontiguousarray(x.imag)))
    return jnp.asarray(x)


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_fftconvolve_matches_jax_and_numpy(rng, complex_, mode):
    """Both paths (real: R2C taps + the real fused kernel; complex: C2C
    taps + the complex one), batched, in the three modes."""
    b, t, k = 2, 1500, 65
    x = rand(rng, b, t, complex_=complex_)
    h = rand(rng, k, complex_=complex_)
    got = T.fftconvolve(torch.from_numpy(x), torch.from_numpy(h),
                        mode=mode).numpy()
    ref = np.asarray(JS.fftconvolve(to_jax(x), to_jax(h), mode=mode,
                                    backend="pallas"))
    want = np.stack([scipy.signal.convolve(r.astype(np.complex128 if
                                                     complex_ else
                                                     np.float64),
                                           h.astype(np.complex128 if
                                                    complex_ else
                                                    np.float64), mode=mode)
                     for r in x])
    assert got.shape == ref.shape == want.shape
    assert got.dtype == (np.complex64 if complex_ else np.float32)
    assert max_abs_err(got, want) < bound(k)
    assert max_abs_err(got, ref) < 2 * bound(k)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_fftcorrelate_matches_jax_and_scipy(rng, mode):
    t, k = 2000, 40
    for complex_ in (False, True):
        x = rand(rng, t, complex_=complex_)
        h = rand(rng, k, complex_=complex_)
        got = T.fftcorrelate(torch.from_numpy(x), torch.from_numpy(h),
                             mode=mode).numpy()
        ref = np.asarray(JS.fftcorrelate(to_jax(x), to_jax(h), mode=mode,
                                         backend="pallas"))
        want = scipy.signal.correlate(x.astype(np.complex128),
                                      h.astype(np.complex128), mode=mode)
        assert got.shape == ref.shape == want.shape
        assert max_abs_err(got, want) < bound(k)
        assert max_abs_err(got, ref) < 2 * bound(k)


def test_one_dim_long_filter_and_n_fft(rng):
    """A 1-D signal, a filter that needs a larger frame (K = 250 -> 1024),
    an explicit n_fft, and oaconvolve as the same function."""
    x = rand(rng, 1000)
    h = rand(rng, 250)
    assert TS._pick_nfft(250) == JS._pick_nfft(250) == 1024
    got = T.fftconvolve(torch.from_numpy(x), torch.from_numpy(h)).numpy()
    want = np.convolve(x.astype(np.float64), h.astype(np.float64))
    assert got.shape == want.shape
    assert max_abs_err(got, want) < bound(250)
    got = T.oaconvolve(torch.from_numpy(x), torch.from_numpy(h),
                       n_fft=2048).numpy()
    assert max_abs_err(got, want) < bound(250, 2048)
    assert T.oaconvolve is T.fftconvolve


def test_pick_nfft_and_pad_taps_match_jax(rng):
    for k in (1, 33, 64, 65, 129, 250, 1024, 4097):
        assert TS._pick_nfft(k) == JS._pick_nfft(k)
    with pytest.raises(ValueError, match="too long"):
        TS._pick_nfft(5000)
    with pytest.raises(ValueError, match="too long"):
        JS._pick_nfft(5000)
    for complex_ in (False, True):
        h = rand(rng, 33, complex_=complex_)
        got = TS._pad_taps(torch.from_numpy(h), 256, real=not complex_)
        ref = JS._pad_taps(to_jax(h), 256, real=not complex_)
        assert got.dtype == (torch.complex64 if complex_ else torch.float32)
        assert got.shape == ref.shape == (1, 256)
        assert np.array_equal(got.numpy(), np.asarray(ref))


def test_errors_match_jax(rng):
    x = rand(rng, 2, 300)
    cases = [(dict(mode="circular"), "mode must be"),
             (dict(n_fft=128), "unsupported"),
             (dict(n_fft=300), "unsupported")]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            T.fftconvolve(torch.from_numpy(x), torch.ones(9), **kw)
        with pytest.raises(ValueError, match=match):
            JS.fftconvolve(jnp.asarray(x), jnp.ones(9), **kw)
    with pytest.raises(ValueError, match="1-D taps"):
        T.fftconvolve(torch.from_numpy(x), torch.ones(2, 9))
    with pytest.raises(ValueError, match=r"\(T,\) or \(B, T\)"):
        T.fftconvolve(torch.zeros(2, 2, 300), torch.ones(9))
    with pytest.raises(ValueError, match="mode must be"):
        T.fftcorrelate(torch.from_numpy(x), torch.ones(9), mode="x")


def test_one_kernel_call_for_the_frames_and_one_for_the_taps(rng,
                                                             monkeypatch):
    """The framing makes one batch: one fused convolution for the whole
    stream, plus one transform of the taps (R2C real, C2C complex)."""
    calls = []
    for mod, name in ((CV, "conv_rows"), (CV, "conv_real_rows"),
                      (R, "rfft_rows"), (C, "fft_complex")):
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    T.fftconvolve(torch.from_numpy(rand(rng, 3, 4000)),
                  torch.from_numpy(rand(rng, 129)))
    assert sorted(calls) == ["conv_real_rows", "rfft_rows"]
    calls.clear()
    T.fftconvolve(torch.from_numpy(rand(rng, 4000, complex_=True)),
                  torch.from_numpy(rand(rng, 129, complex_=True)))
    assert sorted(calls) == ["conv_rows", "fft_complex"]
