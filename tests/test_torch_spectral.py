"""The spectral layer of smfft_tpu_torch (``ops/spectral.py`` and the
spectral half of ``signal.py``: ``power_pencil_planar``, ``get_window``,
``power_spectrum``, ``periodogram``, ``welch``, ``spectrogram``, ``stft`` /
``istft``, ``hilbert`` / ``envelope``) against smfft_tpu's functions of the
same names and numpy / scipy in float64.

The same seeded numpy inputs go through both packages; the JAX side runs
its Pallas kernels in interpret mode (``backend="pallas"``), as
tests/test_spectral.py does, except ``power_spectrum`` at n = 8192, which
takes its plain backend (``backend="xla"``: the Pallas interpreter is slow
above 4096).  Tolerances: a power bin is |X|^2 with X an n-point transform
of data in [-0.5, 0.5), whose fp32 error is tol(n) = 5e-7 * n^0.75 * 8, so
a bin is within 2 tol(n) max|X| + tol(n)^2 of float64, twice that of the
JAX function; scaled spectra (periodogram, Welch, spectrogram) are held
relative to their largest bin at 1e-5 against scipy, as
tests/test_spectral.py holds the JAX package.  Windows are float64 math
rounded once to float32: 1e-6 (kaiser 1e-5) of scipy, equal to JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

import smfft_tpu.ops.pallas_c2c as PC
import smfft_tpu.signal as JS
from smfft_tpu.ops import spectral as JSP

import smfft_tpu_torch as T
from smfft_tpu_torch import signal as TS
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import convolve as CV
from smfft_tpu_torch.ops import real as R
from smfft_tpu_torch.ops import spectral as SP

from conftest import max_abs_err

WINDOWS = ("boxcar", "hann", "hamming", "blackman", "bartlett")


@pytest.fixture(autouse=True, scope="module")
def interpret_mode():
    PC.set_interpret(True)
    yield
    PC.set_interpret(False)


def tol(n):
    return 5e-7 * n ** 0.75 * 8


def power_tol(n, x_max):
    return 2 * tol(n) * x_max + tol(n) ** 2


def rand_r(rng, *shape):
    return (rng.random(shape) - 0.5).astype(np.float32)


def np_power(x, w=None):
    """float64 oracle: one-sided power bins 0..n/2-1, slot 0 = DC^2, and
    max|X|."""
    xw = x.astype(np.float64) if w is None else x.astype(np.float64) * w
    spec = np.fft.rfft(xw, axis=-1)
    return np.abs(spec[..., :x.shape[-1] // 2]) ** 2, np.abs(spec).max()


def rel_err(got, want):
    return max_abs_err(got, want) / float(np.max(np.abs(want)))


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("windowed", [False, True])
def test_power_pencil_planar_matches_jax_and_numpy(rng, n, windowed):
    """The power kernel's function (plain version on the CPU) against
    ops/spectral.power_pencil_planar (interpret mode) and float64, on a
    batch ragged against the JAX kernel's 128-row slab."""
    x = rand_r(rng, 19, n)
    w = np.array(JS.get_window("hann", n)) if windowed else None
    got = SP.power_pencil_planar(
        torch.from_numpy(x), n,
        window=None if w is None else torch.from_numpy(w))
    ref = np.asarray(JSP.power_pencil_planar(
        jnp.asarray(x), n, window=None if w is None else jnp.asarray(w)))
    want, x_max = np_power(x, w)
    assert got.dtype == torch.float32 and got.shape == ref.shape == (19, n // 2)
    assert max_abs_err(got.numpy(), want) < power_tol(n, x_max)
    assert max_abs_err(got.numpy(), ref) < 2 * power_tol(n, x_max)


def test_power_pencil_planar_errors_match_jax():
    for n in (192, 128, 8192):
        with pytest.raises(ValueError, match="wrong FFT length"):
            SP.power_pencil_planar(torch.zeros(8, n), n)
        with pytest.raises(ValueError, match="wrong FFT length"):
            JSP.power_pencil_planar(jnp.zeros((8, n), jnp.float32), n)
    with pytest.raises(ValueError, match=r"window must be shape \(256,\), "
                                         r"got \(128,\)"):
        SP.power_pencil_planar(torch.zeros(8, 256), 256,
                               window=torch.zeros(128))
    with pytest.raises(ValueError, match=r"window must be shape \(256,\), "
                                         r"got \(128,\)"):
        JSP.power_pencil_planar(jnp.zeros((8, 256), jnp.float32), 256,
                                window=jnp.zeros(128))
    with pytest.raises(ValueError, match="expected row width 512"):
        SP.power_pencil_planar(torch.zeros(8, 256), 512)


@pytest.mark.parametrize("name", WINDOWS + (("kaiser", 8.6), ("kaiser", 3.0)))
@pytest.mark.parametrize("periodic", [True, False])
def test_get_window_matches_jax_and_scipy(name, periodic):
    n = 256
    got = T.get_window(name, n, periodic=periodic)
    ref = np.asarray(JS.get_window(name, n, periodic=periodic))
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert np.array_equal(got.numpy(), ref)
    want = ss.get_window(name, n, fftbins=periodic)
    lim = 1e-5 if isinstance(name, tuple) else 1e-6
    assert max_abs_err(got.numpy(), want) < lim


def test_get_window_arrays_and_errors():
    w = np.linspace(0, 1, 64)
    for arr in (w, torch.from_numpy(w)):
        got = T.get_window(arr, 64)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), w.astype(np.float32))
    with pytest.raises(ValueError, match=r"must have shape \(32,\)"):
        T.get_window(w, 32)
    with pytest.raises(ValueError, match=r"must have shape \(32,\)"):
        JS.get_window(w, 32)
    with pytest.raises(ValueError, match="unknown window"):
        T.get_window("triangle", 64)
    with pytest.raises(ValueError, match="unknown window"):
        JS.get_window("triangle", 64)


@pytest.mark.parametrize("n,precision", [(256, None), (1024, "high"),
                                         (512, "exact"), (8192, None)])
def test_power_spectrum_matches_jax_and_numpy(rng, n, precision):
    """The fused path (256 <= n <= 4096, fp32 tiers), and rfft + square
    ("exact"; n = 8192), batched over two leading axes, windowed."""
    x = rand_r(rng, 2, 3, n)
    w = np.array(JS.get_window("hamming", n))
    got = T.power_spectrum(torch.from_numpy(x), window=torch.from_numpy(w),
                           precision=precision)
    ref = np.asarray(JS.power_spectrum(
        jnp.asarray(x), window=jnp.asarray(w),
        backend="pallas" if n <= 4096 else "xla", precision=precision))
    want, x_max = np_power(x, w)
    assert got.dtype == torch.float32 and got.shape == ref.shape == (2, 3,
                                                                     n // 2)
    assert max_abs_err(got.numpy(), want) < power_tol(n, x_max)
    assert max_abs_err(got.numpy(), ref) < 2 * power_tol(n, x_max)


def test_power_spectrum_errors_match_jax():
    for n in (128, 100, 32768):
        with pytest.raises(ValueError, match="wrong FFT length"):
            T.power_spectrum(torch.zeros(2, n))
        with pytest.raises(ValueError, match="wrong FFT length"):
            JS.power_spectrum(jnp.zeros((2, n)))


@pytest.mark.parametrize("scaling", ["density", "spectrum"])
@pytest.mark.parametrize("window,detrend", [("hann", "constant"),
                                            ("boxcar", False)])
def test_periodogram_matches_jax_and_scipy(rng, scaling, window, detrend):
    n = 1024
    x = rand_r(rng, 3, n) + 0.25
    f, pxx = T.periodogram(torch.from_numpy(x), fs=100.0, window=window,
                           detrend=detrend, scaling=scaling)
    jf, jp = JS.periodogram(jnp.asarray(x), fs=100.0, window=window,
                            detrend=detrend, scaling=scaling,
                            backend="pallas")
    f_ref, p_ref = ss.periodogram(x.astype(np.float64), fs=100.0,
                                  window=window, detrend=detrend,
                                  scaling=scaling, axis=-1)
    assert f.shape == (n // 2,) and pxx.shape == (3, n // 2)
    assert np.array_equal(f.numpy(), np.asarray(jf))
    assert max_abs_err(f.numpy(), f_ref[:n // 2]) < 1e-5
    assert rel_err(pxx.numpy(), p_ref[..., :n // 2]) < 1e-5
    assert rel_err(pxx.numpy(), np.asarray(jp)) < 2e-5


def test_welch_matches_jax_and_scipy(rng):
    fs, n = 1000.0, 512
    t = np.arange(8192) / fs
    x = (np.sin(2 * np.pi * 123.0 * t)
         + 0.1 * rng.standard_normal((2, t.size))).astype(np.float32)
    f, pxx = T.welch(torch.from_numpy(x), fs=fs, nperseg=n)
    jf, jp = JS.welch(jnp.asarray(x), fs=fs, nperseg=n, backend="pallas")
    f_ref, p_ref = ss.welch(x.astype(np.float64), fs=fs, nperseg=n)
    assert pxx.shape == (2, n // 2)
    assert np.array_equal(f.numpy(), np.asarray(jf))
    assert max_abs_err(f.numpy(), f_ref[:n // 2]) < 1e-5
    assert rel_err(pxx.numpy(), p_ref[..., :n // 2]) < 1e-5
    assert rel_err(pxx.numpy(), np.asarray(jp)) < 2e-5
    # the 123 Hz tone lands in its bin
    peak = f.numpy()[np.argmax(pxx.numpy(), axis=-1)]
    assert np.all(np.abs(peak - 123.0) < fs / n)


def test_welch_spectrum_scaling_and_errors(rng):
    x = rand_r(rng, 4096)
    _, pxx = T.welch(torch.from_numpy(x), nperseg=256, noverlap=64,
                     window="blackman", scaling="spectrum", detrend=False)
    _, p_ref = ss.welch(x.astype(np.float64), nperseg=256, noverlap=64,
                        window="blackman", scaling="spectrum", detrend=False)
    assert rel_err(pxx.numpy(), p_ref[:128]) < 1e-5
    for kw, match in ((dict(noverlap=256), "noverlap"),
                      (dict(scaling="psd"), "scaling must be"),
                      (dict(detrend="linear"), "detrend must be")):
        with pytest.raises(ValueError, match=match):
            T.welch(torch.from_numpy(x), nperseg=256, **kw)
        with pytest.raises(ValueError, match=match):
            JS.welch(jnp.asarray(x), nperseg=256, **kw)
    with pytest.raises(ValueError, match="signal length 100 < frame length"):
        T.welch(torch.zeros(100), nperseg=256)


def test_spectrogram_matches_jax_and_scipy(rng):
    fs, n = 256.0, 256
    t = np.arange(4096) / fs
    x = (np.sin(2 * np.pi * 60.0 * t)
         + 0.1 * rng.standard_normal(t.size)).astype(np.float32)
    f, times, sxx = T.spectrogram(torch.from_numpy(x), fs=fs, nperseg=n)
    jf, jt, js = JS.spectrogram(jnp.asarray(x), fs=fs, nperseg=n,
                                backend="pallas")
    f_ref, t_ref, s_ref = ss.spectrogram(x.astype(np.float64), fs=fs,
                                         window="hann", nperseg=n,
                                         noverlap=n // 2)
    frames = 1 + (x.size - n) // (n // 2)
    assert sxx.shape == (frames, n // 2) and times.shape == (frames,)
    assert np.array_equal(times.numpy(), np.asarray(jt))
    assert max_abs_err(times.numpy(), t_ref) < 1e-4
    assert rel_err(sxx.numpy(), s_ref[:n // 2].T) < 1e-5
    assert rel_err(sxx.numpy(), np.asarray(js)) < 2e-5
    peak = f.numpy()[np.argmax(sxx.numpy(), axis=-1)]
    assert np.all(np.abs(peak - 60.0) < fs / n)


def test_stft_matches_jax_and_numpy(rng):
    n, hop = 256, 64
    x = rand_r(rng, 2, 2048)
    z = T.stft(torch.from_numpy(x), n_fft=n, hop_length=hop)
    ref = np.asarray(JS.stft(jnp.asarray(x), n_fft=n, hop_length=hop,
                             backend="pallas"))
    w = np.asarray(JS.get_window("hann", n), np.float64)
    frames = 1 + (x.shape[-1] - n) // hop
    assert z.dtype == torch.complex64 and z.shape == ref.shape == (
        2, frames, n // 2 + 1)
    idx = np.arange(frames)[:, None] * hop + np.arange(n)[None, :]
    want = np.fft.rfft(x.astype(np.float64)[:, idx] * w)
    assert max_abs_err(z.numpy(), want) < tol(n)
    assert max_abs_err(z.numpy(), ref) < 2 * tol(n)


@pytest.mark.parametrize("hop", [64, 128])
def test_istft_round_trip_matches_jax(rng, hop):
    n = 256
    x = rand_r(rng, 2, 2048)
    z = T.stft(torch.from_numpy(x), n_fft=n, hop_length=hop)
    y = T.istft(z, n_fft=n, hop_length=hop, length=x.shape[-1])
    ref = np.asarray(JS.istft(jnp.asarray(z.numpy()), n_fft=n,
                              hop_length=hop, length=x.shape[-1],
                              backend="pallas"))
    assert y.dtype == torch.float32 and y.shape == x.shape == ref.shape
    # exact wherever the window-square overlap covers (the interior)
    assert max_abs_err(y.numpy()[:, n:-n], x[:, n:-n]) < 2 * tol(n)
    assert max_abs_err(y.numpy(), ref) < 2 * tol(n)
    full = T.istft(z, n_fft=n, hop_length=hop)
    assert full.shape[-1] == (z.shape[-2] - 1) * hop + n


@pytest.mark.parametrize("n", [64, 1024])
def test_hilbert_and_envelope_match_jax_and_scipy(rng, n):
    x = rand_r(rng, 4, n)
    a = T.hilbert(torch.from_numpy(x))
    ref = np.asarray(JS.hilbert(jnp.asarray(x), backend="pallas"))
    want = ss.hilbert(x.astype(np.float64), axis=-1)
    assert a.dtype == torch.complex64 and a.shape == x.shape
    assert max_abs_err(a.numpy(), want) < tol(n)
    assert max_abs_err(a.numpy(), ref) < 2 * tol(n)
    e = T.envelope(torch.from_numpy(x))
    assert e.dtype == torch.float32
    assert max_abs_err(e.numpy(), np.abs(want)) < tol(n)
    assert max_abs_err(e.numpy(), np.asarray(JS.envelope(
        jnp.asarray(x), backend="pallas"))) < 2 * tol(n)
    with pytest.raises(ValueError, match="wrong FFT length"):
        T.hilbert(torch.zeros(4, 100))
    with pytest.raises(ValueError, match="real input"):
        T.hilbert(torch.zeros(4, 64, dtype=torch.complex64))


def test_hilbert_keeps_the_convolution_gradient(rng):
    """hilbert runs api.convolve, whose gradient it keeps: d/dx of
    sum(Im hilbert(x) * g) is -H(g) (the Hilbert transform is
    anti-self-adjoint), checked against torch.fft autograd."""
    n = 256
    x = torch.from_numpy(rand_r(rng, 2, n)).requires_grad_(True)
    g = torch.from_numpy(rand_r(rng, 2, n))
    (gx,) = torch.autograd.grad((T.hilbert(x).imag * g).sum(), x)
    xr = x.detach().clone().requires_grad_(True)
    mask = torch.zeros(n)
    mask[0], mask[1:n // 2], mask[n // 2] = 1, 2, 1
    (rx,) = torch.autograd.grad(
        (torch.fft.ifft(torch.fft.fft(xr) * mask).imag * g).sum(), xr)
    assert max_abs_err(gx.numpy(), rx.numpy()) < tol(n)


class _FakeCard:
    """Runs the CUDA branch of every dispatch on the CPU: ``is_cpu`` says
    False, and each kernel's launcher is replaced by a stand-in that counts
    its calls and returns the plain version's result."""

    def __init__(self, monkeypatch):
        self.calls = {}
        monkeypatch.setattr(C, "is_cpu", lambda t: False)
        fakes = {
            (SP, "launch_power"): SP.power_plain,
            (R, "launch_r2c"): R.r2c_plain,
            (C, "launch"): lambda x, xi=None, **kw: (
                torch.complex(*C.plain(x.real, x.imag, **kw)) if xi is None
                else C.plain(x, xi, **kw)),
            (CV, "launch_conv"): lambda x, xi=None, *, h, exact=False: (
                torch.complex(*CV.conv_plain(x.real, x.imag, h.real, h.imag,
                                             exact))),
        }
        for (mod, name), fn in fakes.items():
            monkeypatch.setattr(mod, name, self._counting(name, fn))

    def _counting(self, name, fn):
        def run(*a, **kw):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*a, **kw)
        return run

    def take(self):
        calls, self.calls = self.calls, {}
        return calls


def test_cuda_tensors_route_to_the_power_kernel(rng, monkeypatch):
    """On a CUDA tensor power_spectrum launches the power kernel once per
    call in the fp32 tiers at 256 <= n <= 4096 (and periodogram, Welch and
    spectrogram through it), the R2C kernel for "exact" and n = 8192, and
    hilbert the fused convolution: proved with the launch counts of the
    CUDA branch, run here with stand-in launchers."""
    card = _FakeCard(monkeypatch)
    x = torch.from_numpy(rand_r(rng, 3, 1024))
    for precision in (None, "highest", "high", "fast"):
        T.power_spectrum(x, window=T.get_window("hann", 1024),
                         precision=precision)
        assert card.take() == {"launch_power": 1}, precision
    T.periodogram(x)
    T.welch(x.reshape(-1), nperseg=256)
    T.spectrogram(x.reshape(-1), nperseg=512)
    assert card.take() == {"launch_power": 3}
    T.power_spectrum(x, precision="exact")
    T.power_spectrum(torch.from_numpy(rand_r(rng, 2, 8192)))
    assert card.take() == {"launch_r2c": 2}
    T.stft(x.reshape(-1), n_fft=256)
    assert card.take() == {"launch_r2c": 1}
    T.hilbert(x)
    assert card.take() == {"launch_conv": 1}
