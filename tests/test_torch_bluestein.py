"""Arbitrary-length transforms of smfft_tpu_torch (``ops/chirp.py``,
``bluestein.py``, ``planar.fft_any``, ``signal.resample``) against
smfft_tpu's functions of the same names and numpy / scipy in float64.

The same seeded numpy inputs go through both packages.  The JAX side runs
``chirp.bluestein_planar`` (its fused kernel) in interpret mode, as
tests/test_bluestein.py does, and its other functions on their default CPU
backend (the composed chirp -> convolve -> chirp form).  Tolerances: an
n-point Bluestein DFT is a pair of m-point transforms (m >= 2n - 1) of data
in [-0.5, 0.5), so tol(m) = 5e-7 * m^0.75 * 8 against float64 and twice
that against the JAX function; the "exact" tier within 2 ulp of max|X|.
The chirp and filter constants are the state both packages carry: equal to
JAX's to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

import smfft_tpu.bluestein as JB
import smfft_tpu.ops.pallas_c2c as PC
import smfft_tpu.planar as JPL
import smfft_tpu.signal as JS
from smfft_tpu.ops import chirp as JCH

import smfft_tpu_torch as T
from smfft_tpu_torch import bluestein as TB
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import chirp as CH

from conftest import max_abs_err

SIZES = (3, 7, 12, 100, 129, 500, 1000, 1536, 4097)


def tol(m):
    return 5e-7 * m ** 0.75 * 8


def ulp(v):
    return 2.0 ** (np.floor(np.log2(v)) - 23)


def rand_c(rng, *shape):
    return (rng.random(shape) - 0.5
            + 1j * (rng.random(shape) - 0.5)).astype(np.complex64)


def to_jax(x):
    return jax.lax.complex(jnp.asarray(np.ascontiguousarray(x.real)),
                           jnp.asarray(np.ascontiguousarray(x.imag)))


def conv_len(n):
    return TB._conv_length(2 * n - 1)


@pytest.mark.parametrize("n", [100, 1000])
def test_bluestein_planar_matches_jax_kernel(rng, n):
    """bluestein_planar (the kernel's plain version on the CPU) against the
    JAX kernel in interpret mode and float64, on ragged rows; the pad lanes
    are exactly zero, even when the input's are not."""
    m, np_ = conv_len(n), CH.n_pad(n)
    x = rand_c(rng, 12, n)
    vr = np.zeros((12, np_), np.float32)
    vi = np.zeros((12, np_), np.float32)
    vr[:, :n], vi[:, :n] = x.real, x.imag
    PC.set_interpret(True)
    try:
        jr, ji = JCH.bluestein_planar(jnp.asarray(vr), jnp.asarray(vi), n, m)
    finally:
        PC.set_interpret(False)
    ref = np.asarray(jr) + 1j * np.asarray(ji)
    vr[:, n:] = 7.0  # not read
    o_r, o_i = CH.bluestein_planar(torch.from_numpy(vr),
                                   torch.from_numpy(vi), n, m)
    got = o_r.numpy() + 1j * o_i.numpy()
    want = np.fft.fft(x.astype(np.complex128))
    assert o_r.shape == o_i.shape == (12, np_)
    assert max_abs_err(got[:, :n], want) < tol(m)
    assert max_abs_err(got, ref) < 2 * tol(m)
    assert np.all(got[:, n:] == 0) and np.all(ref[:, n:] == 0)
    with pytest.raises(ValueError, match=f"padded row width {np_}"):
        CH.bluestein_planar(torch.zeros(2, n), torch.zeros(2, n), n, m)


@pytest.mark.parametrize("n", SIZES)
def test_fft_any_and_ifft_any_match_jax_and_numpy(rng, n):
    m = conv_len(n)
    x = rand_c(rng, 4, n)
    x64 = x.astype(np.complex128)
    y = T.fft_any(torch.from_numpy(x))
    assert y.dtype == torch.complex64 and y.shape == x.shape
    assert max_abs_err(y.numpy(), np.fft.fft(x64)) < tol(m)
    assert max_abs_err(y.numpy(), np.asarray(JB.fft_any(to_jax(x)))) \
        < 2 * tol(m)
    yi = T.ifft_any(torch.from_numpy(x))
    assert max_abs_err(yi.numpy(), np.fft.ifft(x64)) < tol(m) / n
    assert max_abs_err(yi.numpy(), np.asarray(JB.ifft_any(to_jax(x)))) \
        < 2 * tol(m) / n
    raw = T.ifft_any(torch.from_numpy(x), norm=None)
    assert max_abs_err(raw.numpy(), np.fft.ifft(x64) * n) < tol(m)


@pytest.mark.parametrize("n", [12, 1000, 4097])
def test_exact_tier_within_2_ulp(rng, n):
    x = rand_c(rng, 4, n)
    want = np.fft.fft(x.astype(np.complex128))
    got = T.fft_any(torch.from_numpy(x), precision="exact").numpy()
    assert max_abs_err(got, want) <= 2 * ulp(np.abs(want).max())
    want = np.fft.ifft(x.astype(np.complex128))
    got = T.ifft_any(torch.from_numpy(x), precision="exact").numpy()
    assert max_abs_err(got, want) <= 2 * ulp(np.abs(want).max())


def test_fft_any_small_and_power_of_two_sizes(rng):
    x = np.array([[3.0 + 1j], [-2.0 + 0.5j]], np.complex64)
    for fn in (T.fft_any, T.ifft_any):
        assert np.array_equal(fn(torch.from_numpy(x)).numpy(), x)
    x = rand_c(rng, 2, 256)
    got = T.fft_any(torch.from_numpy(x))
    assert max_abs_err(got.numpy(), np.fft.fft(x.astype(np.complex128))) \
        < tol(256)
    assert np.array_equal(got.numpy(), T.fft(torch.from_numpy(x)).numpy())
    back = T.ifft_any(got)
    assert max_abs_err(back.numpy(), x) < tol(256)
    # real input is taken as complex64, as in the JAX package
    xr = rng.random((2, 100)).astype(np.float32)
    assert max_abs_err(T.fft_any(torch.from_numpy(xr)).numpy(),
                       np.fft.fft(xr.astype(np.float64))) < tol(256)


def test_spec_backend_is_the_composed_form(rng):
    x = rand_c(rng, 3, 100)
    for fn, want in ((T.fft_any, np.fft.fft(x.astype(np.complex128))),
                     (T.ifft_any, np.fft.ifft(x.astype(np.complex128)))):
        got = fn(torch.from_numpy(x), backend="spec")
        assert max_abs_err(got.numpy(), want) < tol(256)


@pytest.mark.parametrize("n", [9000, 16384 + 3])
def test_too_long_raises_like_jax(n):
    for fn in (T.fft_any, T.ifft_any):
        with pytest.raises(ValueError, match="wrong FFT length"):
            fn(torch.zeros(1, n, dtype=torch.complex64))
    with pytest.raises(ValueError, match="wrong FFT length"):
        JB.fft_any(jnp.zeros((1, n), jnp.complex64))
    with pytest.raises(ValueError, match="wrong FFT length"):
        CH.bluestein_plain(torch.zeros(1, n), torch.zeros(1, n), n, 16384)


@pytest.mark.parametrize("n", [12, 100, 129, 1000])
def test_rfft_any_irfft_any_match_numpy(rng, n):
    x = (rng.random((3, n)) - 0.5).astype(np.float32)
    s = T.rfft_any(torch.from_numpy(x))
    want = np.fft.rfft(x.astype(np.float64))
    assert s.shape == (3, n // 2 + 1)
    assert max_abs_err(s.numpy(), want) < tol(conv_len(n))
    assert max_abs_err(s.numpy(), np.asarray(JB.rfft_any(jnp.asarray(x)))) \
        < 2 * tol(conv_len(n))
    back = T.irfft_any(s, n=n)
    assert back.dtype == torch.float32 and back.shape == x.shape
    assert max_abs_err(back.numpy(), x) < tol(conv_len(n))
    want = np.fft.irfft(s.numpy().astype(np.complex128), n)
    assert max_abs_err(back.numpy(), want) < tol(conv_len(n))
    raw = T.irfft_any(s, n=n, norm=None)
    assert max_abs_err(raw.numpy(), want * n) < tol(conv_len(n)) * n


def test_rfft_any_irfft_any_power_of_two_and_errors(rng):
    x = (rng.random((4, 512)) - 0.5).astype(np.float32)
    s = T.rfft_any(torch.from_numpy(x))
    assert np.array_equal(s.numpy(), T.rfft(torch.from_numpy(x)).numpy())
    assert max_abs_err(T.irfft_any(s).numpy(), x) < tol(512)
    with pytest.raises(ValueError, match="expects real"):
        T.rfft_any(torch.zeros(2, 100, dtype=torch.complex64))
    with pytest.raises(ValueError, match="needed for n=100"):
        T.irfft_any(torch.zeros(2, 40, dtype=torch.complex64), n=100)


def test_czt_matches_jax_and_numpy(rng):
    n = 60
    x = rand_c(rng, 2, n)
    got = T.czt(torch.from_numpy(x))
    assert max_abs_err(got.numpy(), np.fft.fft(x.astype(np.complex128))) \
        < 1e-4
    assert max_abs_err(got.numpy(), np.asarray(JB.czt(to_jax(x)))) < 1e-4
    # a spiral contour (|w| != 1), scipy.signal.czt semantics
    # (its 64-point convolution packs two rows: an even batch, as in the
    # JAX package's fused path)
    n, m = 40, 25
    x = rand_c(rng, 2, n)
    w = 1.001 * np.exp(-2j * np.pi / 50)
    a = 0.998 * np.exp(2j * np.pi * 0.03)
    got = T.czt(torch.from_numpy(x), m=m, w=w, a=a).numpy()
    want = ss.czt(x.astype(np.complex128), m=m, w=w, a=a)
    assert got.shape == (2, m)
    assert max_abs_err(got, want) / np.abs(want).max() < 1e-5
    assert max_abs_err(got, np.asarray(JB.czt(to_jax(x), m=m, w=w, a=a))) \
        / np.abs(want).max() < 1e-5


def test_zoom_fft_matches_jax_and_scipy(rng):
    n, m = 400, 128
    x = rand_c(rng, 3, n)
    got = T.zoom_fft(torch.from_numpy(x), [0.1, 0.4], m=m).numpy()
    want = ss.zoom_fft(x.astype(np.complex128), [0.1, 0.4], m=m)
    assert got.shape == (3, m)
    assert max_abs_err(got, want) < 1e-4
    assert max_abs_err(got, np.asarray(JB.zoom_fft(to_jax(x), [0.1, 0.4],
                                                   m=m))) < 1e-4
    got = T.zoom_fft(torch.from_numpy(x), 2.0).numpy()
    assert max_abs_err(got, np.fft.fft(x.astype(np.complex128))) < 1e-4


@pytest.mark.parametrize("n,num", [(1000, 768), (100, 129), (128, 100),
                                   (99, 250), (1000, 1000), (64, 32)])
def test_resample_matches_jax_and_scipy(rng, n, num):
    """Down- and upsampling across odd and even lengths (the Nyquist split
    and fold), real and complex rows, along the last axis and axis 0 (four
    rows: the C2C kernel's packing rule at 32 points)."""
    m = max(conv_len(n) if n & (n - 1) else n,
            conv_len(num) if num & (num - 1) else num)
    x = (rng.random((4, n)) - 0.5).astype(np.float32)
    got = T.resample(torch.from_numpy(x), num)
    want = ss.resample(x.astype(np.float64), num, axis=-1)
    assert got.dtype == torch.float32 and got.shape == (4, num)
    assert max_abs_err(got.numpy(), want) < tol(m)
    ref = np.asarray(JS.resample(jnp.asarray(x), num))
    assert max_abs_err(got.numpy(), ref) < 2 * tol(m)
    xc = rand_c(rng, n, 4)
    got = T.resample(torch.from_numpy(xc), num, axis=0)
    want = ss.resample(xc.astype(np.complex128), num, axis=0)
    assert got.dtype == torch.complex64 and got.shape == (num, 4)
    assert max_abs_err(got.numpy(), want) < tol(m)


@pytest.mark.parametrize("n", [100, 128, 1000])
def test_planar_fft_any_matches_jax_and_numpy(rng, n):
    np_ = CH.n_pad(n)
    x = rand_c(rng, 2, 3, n)
    vr = np.zeros((2, 3, np_), np.float32)
    vi = np.zeros_like(vr)
    vr[..., :n], vi[..., :n] = x.real, x.imag
    o_r, o_i = T.planar.fft_any(torch.from_numpy(vr), torch.from_numpy(vi),
                                n=n)
    got = o_r.numpy() + 1j * o_i.numpy()
    assert o_r.shape == (2, 3, np_)
    assert max_abs_err(got[..., :n], np.fft.fft(x.astype(np.complex128))) \
        < tol(conv_len(n))
    assert np.all(got[..., n:] == 0)
    PC.set_interpret(True)
    try:
        jr, ji = JPL.fft_any(jnp.asarray(vr), jnp.asarray(vi), n=n)
    finally:
        PC.set_interpret(False)
    assert max_abs_err(got, np.asarray(jr) + 1j * np.asarray(ji)) \
        < 2 * tol(conv_len(n))


def test_planar_fft_any_errors_match_jax():
    for fn in (T.planar.fft_any, JPL.fft_any):
        zeros = np.zeros((2, 128), np.float32)
        a = (torch.from_numpy(zeros) if fn is T.planar.fft_any
             else jnp.asarray(zeros))
        with pytest.raises(ValueError, match="expected padded row width 256"
                                             " for n=200"):
            fn(a, a, n=200)
        with pytest.raises(ValueError, match="planar pair shapes differ"):
            fn(a, a[:1])


def test_constants_equal_jax():
    """The chirp, the filter response and the conventions that build them:
    equal to the JAX package's _chirp_consts (fp32 planar, the filter in
    revblock order there, natural here) and _bluestein_consts.  (Below m =
    128 the JAX function has no revblock map: see the next test.)"""
    for n in (3, 12):
        m2, w2, fb = TB._bluestein_consts(n)
        jm, jw, jfb = JB._bluestein_consts(n)
        assert m2 == jm and np.array_equal(w2, jw) and np.array_equal(fb, jfb)
    for n in (33, 100, 1000, 4097):
        m = conv_len(n)
        assert m == JB._conv_length(2 * n - 1)
        assert CH.n_pad(n) == JCH._n_pad(n)
        w, h = CH.chirp_consts(n, m)
        pre_r, pre_i, hr, hi, post_r, post_i = JCH._chirp_consts(n, m)
        np_ = JCH._n_pad(n)
        assert np.array_equal(w.real.astype(np.float32), pre_r[0, :n])
        assert np.array_equal(w.imag.astype(np.float32), pre_i[0, :n])
        assert np.array_equal(pre_r, post_r) and np.array_equal(pre_i, post_i)
        assert not pre_r[0, n:np_].any() and not pre_i[0, n:np_].any()
        c = m // 128
        rev = (np.arange(m) % 128) * c + np.arange(m) // 128
        assert np.array_equal(h.real[rev].astype(np.float32), hr[0])
        assert np.array_equal(h.imag[rev].astype(np.float32), hi[0])
        m2, w2, fb = TB._bluestein_consts(n)
        jm, jw, jfb = JB._bluestein_consts(n)
        assert m2 == jm
        assert np.array_equal(w2, jw) and np.array_equal(fb, jfb)


@pytest.mark.parametrize("n", [3, 12, 31])
def test_jax_fused_bluestein_fails_below_m_128_port_does_not(rng, n):
    """Reference fault: smfft_tpu's fused Bluestein path (backend="pallas")
    fails for n <= 32, whose convolution length m = 32 / 64 is below one
    128-lane row: ``ops/chirp._chirp_consts`` fills its revblock index map
    for m // 128 = 0 columns, so the map is uninitialised memory and the
    gather raises IndexError.  The port keeps the response in natural
    order and is right there."""
    x = rand_c(rng, 8, n)
    PC.set_interpret(True)
    try:
        with pytest.raises(IndexError):
            JB.fft_any(to_jax(x), backend="pallas")
    finally:
        PC.set_interpret(False)
    got = T.fft_any(torch.from_numpy(x))
    assert max_abs_err(got.numpy(), np.fft.fft(x.astype(np.complex128))) \
        < tol(conv_len(n))


def test_plain_version_is_the_kernels_contract(rng):
    """bluestein_plain on rows wider than n (the kernel's ld), forward and
    inverse with a fused scale, planar and complex, both tiers."""
    n, m, ld = 100, 256, 160
    x = rand_c(rng, 5, n)
    xr = np.full((5, ld), 3.0, np.float32)
    xi = np.full((5, ld), -1.0, np.float32)
    xr[:, :n], xi[:, :n] = x.real, x.imag
    for inverse, scale, want in (
            (False, None, np.fft.fft(x.astype(np.complex128))),
            (True, 0.5, np.fft.ifft(x.astype(np.complex128)) * n * 0.5)):
        for exact in (False, True):
            o_r, o_i = CH.bluestein_plain(torch.from_numpy(xr),
                                          torch.from_numpy(xi), n, m,
                                          inverse=inverse, scale=scale,
                                          exact=exact)
            assert o_r.dtype == torch.float32 and o_r.shape == (5, ld)
            got = o_r.numpy() + 1j * o_i.numpy()
            assert max_abs_err(got[:, :n], want) < tol(m)
            assert not got[:, n:].any()
            rows = torch.from_numpy(xr + 1j * xi)
            yc = CH.bluestein_rows(rows.to(torch.complex64), None, n, m,
                                   inverse=inverse, scale=scale, exact=exact)
            assert np.array_equal(yc.numpy(), got.astype(np.complex64))


def test_cuda_tensors_route_to_the_bluestein_kernel(rng, monkeypatch):
    """On a CUDA tensor fft_any / ifft_any / rfft_any / irfft_any /
    planar.fft_any launch the Bluestein kernel once per call at a length
    that is not a supported power of two, and the C2C kernel at one that
    is; resample from 1000 to 768 samples launches it twice: proved with
    the launch counts of the CUDA branch, run here with stand-in
    launchers."""
    calls = {}

    def counting(name, fn):
        def run(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return run

    def fake_bluestein(x, xi=None, **kw):
        if xi is None:
            return torch.complex(*CH.bluestein_plain(x.real, x.imag, **kw))
        return CH.bluestein_plain(x, xi, **kw)

    def fake_c2c(x, xi=None, **kw):
        return torch.complex(*C.plain(x.real, x.imag, **kw))

    monkeypatch.setattr(C, "is_cpu", lambda t: False)
    monkeypatch.setattr(CH, "launch_bluestein",
                        counting("bluestein", fake_bluestein))
    monkeypatch.setattr(C, "launch", counting("c2c", fake_c2c))

    def take():
        out = dict(calls)
        calls.clear()
        return out

    x = torch.from_numpy(rand_c(rng, 4, 1000))
    for precision in (None, "exact"):
        T.fft_any(x, precision=precision)
        T.ifft_any(x, precision=precision)
        assert take() == {"bluestein": 2}
    T.rfft_any(x.real.contiguous())
    T.irfft_any(x[:, :51], n=100)
    vr = torch.zeros(3, 1024)
    T.planar.fft_any(vr, vr, n=1000)
    assert take() == {"bluestein": 3}
    T.fft_any(torch.from_numpy(rand_c(rng, 4, 1024)))
    assert take() == {"c2c": 1}
    y = T.resample(x.real.contiguous(), 768)
    assert take() == {"bluestein": 2}
    assert y.shape == (4, 768)
