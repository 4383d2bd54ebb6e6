"""The fused convolution of smfft_tpu_torch (``ops/convolve.py``, the plain
PyTorch versions of ``csrc/conv.cu``'s kernels, which CPU tensors run;
``api.convolve`` / ``convolve_real`` with their gradients;
``planar.convolve``) against smfft_tpu and float64 numpy.

The same seeded numpy inputs and filters go through both packages; the JAX
side runs ``ops/convolve.py``'s Pallas kernels in interpret mode, as
tests/test_convolve.py does, at that file's sizes.  Tolerances: tol(n) =
5e-7 * n^0.75 * 8 against numpy (the bound tests/test_convolve.py states
for a forward transform, a product and an inverse), 2 * tol(n) against the
JAX function (both sit within tol(n) of the oracle).  Gradients are checked
in float64, where the plain versions compute in float64: ``gradcheck``'s
defaults, and 1e-9 against ``torch.autograd`` through ``torch.fft`` (the
float64 rounding of a few transforms of O(1) data is about 1e-13).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smfft_tpu
import smfft_tpu.ops.pallas_c2c as PC
import smfft_tpu.planar as JP
from smfft_tpu.ops import convolve as JCV

import smfft_tpu_torch as T
from smfft_tpu_torch.ops import convolve as CV

from conftest import max_abs_err


@pytest.fixture(autouse=True, scope="module")
def interpret_mode():
    PC.set_interpret(True)
    yield
    PC.set_interpret(False)


def tol(n):
    return 5e-7 * n ** 0.75 * 8


def rand_c(rng, *shape):
    return (rng.random(shape) + 1j * rng.random(shape)
            - 0.5 - 0.5j).astype(np.complex64)


def rand_r(rng, *shape):
    return (rng.random(shape) * 2 - 1).astype(np.float32)


def half_response(rng, *lead, n):
    """rfft of a random real filter: an rfft-style response (..., n/2+1)."""
    return np.fft.rfft(rand_r(rng, *lead, n).astype(np.float64)).astype(
        np.complex64)


def to_jax(x):
    return jax.lax.complex(jnp.asarray(np.ascontiguousarray(x.real)),
                           jnp.asarray(np.ascontiguousarray(x.imag)))


def oracle(x, h):
    return np.fft.ifft(np.fft.fft(x.astype(np.complex128)) * h.astype(
        np.complex128))


def real_oracle(x, h):
    return np.fft.irfft(np.fft.rfft(x.astype(np.float64)) * h.astype(
        np.complex128), x.shape[-1])


@pytest.mark.parametrize("n", [32, 64, 128, 512, 2048])
def test_convolve_planar_matches_jax(rng, n):
    """convolve_planar on the JAX row layout (128/n transforms a row below
    128) and api.convolve on complex rows."""
    b = max(2, 256 // n) * max(1, 128 // n)
    x = rand_c(rng, b, n)
    h = rand_c(rng, n)
    row = max(n, 128)
    vr, vi = (np.ascontiguousarray(p).reshape(-1, row)
              for p in (x.real, x.imag))
    o_r, o_i = CV.convolve_planar(torch.from_numpy(vr), torch.from_numpy(vi),
                                  torch.from_numpy(h.real.copy()),
                                  torch.from_numpy(h.imag.copy()), n)
    got = (o_r.numpy() + 1j * o_i.numpy()).reshape(b, n)
    j_r, j_i = JCV.convolve_planar(jnp.asarray(vr), jnp.asarray(vi),
                                   jnp.asarray(h.real), jnp.asarray(h.imag),
                                   n)
    ref = (np.asarray(j_r) + 1j * np.asarray(j_i)).reshape(b, n)
    assert max_abs_err(got, ref) < 2 * tol(n)
    assert max_abs_err(got, oracle(x, h)) < tol(n)
    y = T.convolve(torch.from_numpy(x), torch.from_numpy(h))
    assert y.dtype == torch.complex64 and y.shape == (b, n)
    assert max_abs_err(y.numpy(), oracle(x, h)) < tol(n)


@pytest.mark.parametrize("n,m", [(64, 2), (512, 3)])
def test_filter_bank_matches_jax(rng, n, m):
    """The bank: every signal against every filter, (m, B, n)."""
    b = max(8, 128 // n * 2)
    x = rand_c(rng, b, n)
    hs = rand_c(rng, m, n)
    got = T.convolve(torch.from_numpy(x), torch.from_numpy(hs)).numpy()
    ref = np.asarray(JCV.convolve_bank_pallas(to_jax(x), to_jax(hs)))
    assert got.shape == ref.shape == (m, b, n)
    assert max_abs_err(got, ref) < 2 * tol(n)
    for j in range(m):
        assert max_abs_err(got[j], oracle(x, hs[j])) < tol(n)
    row = max(n, 128)
    o_r, o_i = CV.convolve_bank_planar(
        torch.from_numpy(np.ascontiguousarray(x.real).reshape(-1, row)),
        torch.from_numpy(np.ascontiguousarray(x.imag).reshape(-1, row)),
        torch.from_numpy(hs.real.copy()), torch.from_numpy(hs.imag.copy()),
        n)
    assert o_r.shape == (m, b * n // row, row)
    assert max_abs_err((o_r.numpy() + 1j * o_i.numpy()).reshape(m, b, n),
                       got) < 2 * tol(n)


@pytest.mark.parametrize("n", [256, 512, 2048])
def test_real_convolve_matches_jax(rng, n):
    """r2c -> packed product -> c2r: convolve_real_planar and
    api.convolve_real against the JAX kernel and numpy."""
    b = 16
    x = rand_r(rng, b, n)
    h = half_response(rng, n=n)
    got = CV.convolve_real_planar(torch.from_numpy(x),
                                  torch.from_numpy(h.real.copy()),
                                  torch.from_numpy(h.imag.copy()), n).numpy()
    ref = np.asarray(JCV.convolve_real_pallas(jnp.asarray(x), to_jax(h)))
    assert got.shape == ref.shape == (b, n)
    assert max_abs_err(got, ref) < 2 * tol(n)
    assert max_abs_err(got, real_oracle(x, h)) < tol(n)
    y = T.convolve_real(torch.from_numpy(x), torch.from_numpy(h))
    assert y.dtype == torch.float32
    assert max_abs_err(y.numpy(), got) < tol(n)


def test_real_filter_bank_matches_jax(rng):
    n, m, b = 512, 3, 16
    x = rand_r(rng, b, n)
    hs = half_response(rng, m, n=n)
    got = T.convolve_real(torch.from_numpy(x), torch.from_numpy(hs)).numpy()
    ref = np.asarray(JCV.convolve_real_bank_pallas(jnp.asarray(x),
                                                   to_jax(hs)))
    assert got.shape == ref.shape == (m, b, n)
    assert max_abs_err(got, ref) < 2 * tol(n)
    for j in range(m):
        assert max_abs_err(got[j], real_oracle(x, hs[j])) < tol(n)
    bank = CV.convolve_real_bank_planar(torch.from_numpy(x),
                                        torch.from_numpy(hs.real.copy()),
                                        torch.from_numpy(hs.imag.copy()), n)
    assert max_abs_err(bank.numpy(), got) < tol(n)


def test_api_matches_jax_api(rng):
    """smfft_tpu.convolve / convolve_real (pallas backend) against the
    port's on a batch of leading shape (2, 4), single and bank."""
    n = 256
    x = rand_c(rng, 2, 4, n)
    h = rand_c(rng, 2, n)
    for hh in (h[0], h):
        got = T.convolve(torch.from_numpy(x), torch.from_numpy(hh)).numpy()
        ref = np.asarray(smfft_tpu.convolve(to_jax(x), to_jax(hh),
                                            backend="pallas"))
        assert got.shape == ref.shape
        assert max_abs_err(got, ref) < 2 * tol(n)
    xr = rand_r(rng, 2, 4, n)
    hr = half_response(rng, 2, n=n)
    for hh in (hr[0], hr):
        got = T.convolve_real(torch.from_numpy(xr),
                              torch.from_numpy(hh)).numpy()
        ref = np.asarray(smfft_tpu.convolve_real(jnp.asarray(xr),
                                                 to_jax(hh),
                                                 backend="pallas"))
        assert got.shape == ref.shape
        assert max_abs_err(got, ref) < 2 * tol(n)


@pytest.mark.parametrize("n", [64, 512])
def test_planar_convolve(rng, n):
    """planar.convolve packs rows below N = 128 and matches JAX's
    planar.convolve at 512.  The JAX function does not pack and fails at
    N = 64 (a reference fault, ROADMAP §C), pinned here."""
    x = rand_c(rng, 2, 8, n)
    h = rand_c(rng, n)
    o_r, o_i = T.planar.convolve(torch.from_numpy(x.real.copy()),
                                 torch.from_numpy(x.imag.copy()),
                                 torch.from_numpy(h.real.copy()),
                                 torch.from_numpy(h.imag.copy()))
    got = o_r.numpy() + 1j * o_i.numpy()
    assert got.shape == x.shape
    assert max_abs_err(got, oracle(x, h)) < tol(n)
    args = (jnp.asarray(x.real), jnp.asarray(x.imag), jnp.asarray(h.real),
            jnp.asarray(h.imag))
    if n < 128:
        with pytest.raises(TypeError, match="cannot reshape"):
            JP.convolve(*args)
        return
    j_r, j_i = JP.convolve(*args)
    assert max_abs_err(got, np.asarray(j_r) + 1j * np.asarray(j_i)) \
        < 2 * tol(n)


def test_identity_filter_and_ignored_imaginary_parts(rng):
    """H = 1 is the identity (the folded 1/N and 1/L); the real form
    ignores Im H[0] and Im H[n/2], as the JAX package does."""
    n = 1024
    x = rand_c(rng, 8, n)
    y = T.convolve(torch.from_numpy(x), torch.ones(n, dtype=torch.complex64))
    assert max_abs_err(y.numpy(), x) < tol(n)
    xr = rand_r(rng, 8, n)
    h = np.ones(n // 2 + 1, np.complex64)
    h[0] += 3j
    h[-1] -= 5j
    y = T.convolve_real(torch.from_numpy(xr), torch.from_numpy(h))
    assert max_abs_err(y.numpy(), xr) < tol(n)
    ref = np.asarray(JCV.convolve_real_pallas(jnp.asarray(xr), to_jax(h)))
    assert max_abs_err(ref, xr) < tol(n)


def test_exact_tier_plain(rng):
    """"exact" computes in float64 and rounds once: within one ulp of the
    largest output of the float64 oracle."""
    n = 512
    x = rand_c(rng, 4, n)
    h = rand_c(rng, 2, n)
    want = np.stack([oracle(x, hj) for hj in h])
    got = T.convolve(torch.from_numpy(x), torch.from_numpy(h),
                     precision="exact").numpy()
    assert max_abs_err(got, want) <= np.spacing(np.float32(np.abs(
        want).max()))
    xr = rand_r(rng, 4, n)
    hr = half_response(rng, n=n)
    want = real_oracle(xr, hr)
    got = T.convolve_real(torch.from_numpy(xr), torch.from_numpy(hr),
                          precision="exact").numpy()
    assert max_abs_err(got, want) <= np.spacing(np.float32(np.abs(
        want).max()))


def test_spec_backend_agrees(rng):
    n = 128
    x = torch.from_numpy(rand_c(rng, 4, n))
    h = torch.from_numpy(rand_c(rng, 2, n))
    a = T.convolve(x, h)
    b = T.convolve(x, h, backend="spec")
    assert max_abs_err(a.numpy(), b.numpy()) < 2 * tol(n)
    n = 256
    xr = torch.from_numpy(rand_r(rng, 4, n))
    hr = torch.from_numpy(half_response(rng, n=n))
    assert max_abs_err(T.convolve_real(xr, hr).numpy(),
                       T.convolve_real(xr, hr, backend="spec").numpy()) \
        < 2 * tol(n)


@pytest.fixture
def one_thread():
    """gradcheck runs about 1500 forwards on tiny tensors: one intra-op
    thread keeps them from thrashing when several test workers share the
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("bank", [False, True])
def test_complex_gradients(rng, one_thread, bank):
    """Gradients for x and h: gradcheck in float64, and torch.autograd
    through the torch.fft composition."""
    n = 32
    x = torch.from_numpy(rand_c(rng, 4, n).astype(np.complex128))
    h = torch.from_numpy(rand_c(rng, *((2,) if bank else ()), n).astype(
        np.complex128))
    x.requires_grad_(True)
    h.requires_grad_(True)
    assert torch.autograd.gradcheck(T.convolve, (x, h))
    g = torch.from_numpy(rand_c(rng, *T.convolve(x, h).shape).astype(
        np.complex128))
    gx, gh = torch.autograd.grad(T.convolve(x, h), (x, h), g)
    spec = torch.fft.fft(x)
    ref = torch.fft.ifft(spec[None] * h[:, None] if bank else spec * h)
    rx, rh = torch.autograd.grad(ref, (x, h), g)
    assert torch.allclose(gx, rx, atol=1e-9)
    assert torch.allclose(gh, rh, atol=1e-9)


@pytest.mark.parametrize("bank", [False, True])
def test_real_gradients(rng, one_thread, bank):
    """The real form's gradients, including the half-spectrum weights of
    the filter gradient and the ignored imaginary parts of DC and
    Nyquist."""
    n = 256
    x = torch.from_numpy(rand_r(rng, 1 if bank else 2, n).astype(
        np.float64))
    h = torch.from_numpy(rand_c(rng, *((2,) if bank else ()),
                                n // 2 + 1).astype(np.complex128))
    x.requires_grad_(True)
    h.requires_grad_(True)
    assert torch.autograd.gradcheck(T.convolve_real, (x, h))
    g = torch.from_numpy(rand_r(rng, *T.convolve_real(x, h).shape).astype(
        np.float64))
    gx, gh = torch.autograd.grad(T.convolve_real(x, h), (x, h), g)
    spec = torch.fft.rfft(x)
    ref = torch.fft.irfft(spec[None] * h[:, None] if bank else spec * h, n)
    rx, rh = torch.autograd.grad(ref, (x, h), g)
    assert torch.allclose(gx, rx, atol=1e-9)
    assert torch.allclose(gh, rh, atol=1e-9)


def test_shape_errors_match_jax(rng):
    x = rand_c(rng, 8, 512)
    cases = [
        (T.convolve, smfft_tpu.convolve, rand_c(rng, 8, 100),
         rand_c(rng, 100), "wrong FFT length"),
        (T.convolve, smfft_tpu.convolve, x, rand_c(rng, 256),
         "natural-order frequency"),
        (T.convolve, smfft_tpu.convolve, x, rand_c(rng, 2, 2, 512),
         "natural-order frequency"),
        (T.convolve_real, smfft_tpu.convolve_real, rand_r(rng, 8, 512),
         rand_c(rng, 256), "rfft-style"),
        (T.convolve_real, smfft_tpu.convolve_real, rand_r(rng, 8, 128),
         rand_c(rng, 65), "wrong FFT length"),
    ]
    for port, ref, xx, hh, match in cases:
        with pytest.raises(ValueError, match=match):
            port(torch.from_numpy(xx), torch.from_numpy(hh))
        jx = jnp.asarray(xx) if xx.dtype == np.float32 else to_jax(xx)
        with pytest.raises(ValueError, match=match):
            ref(jx, to_jax(hh))
    for port, ref in ((CV.convolve_planar, JCV.convolve_planar),
                      (CV.convolve_bank_planar, JCV.convolve_bank_planar)):
        with pytest.raises(ValueError, match="wrong FFT length"):
            port(torch.zeros(8, 128), torch.zeros(8, 128), torch.zeros(96),
                 torch.zeros(96), 96)
        with pytest.raises(ValueError, match="wrong FFT length"):
            ref(jnp.zeros((8, 128)), jnp.zeros((8, 128)), jnp.zeros(96),
                jnp.zeros(96), 96)
    with pytest.raises(ValueError, match="real convolve supports"):
        CV.convolve_real_planar(torch.zeros(8, 128), torch.zeros(65),
                                torch.zeros(65), 128)
    with pytest.raises(ValueError, match="real convolve supports"):
        JCV.convolve_real_planar(jnp.zeros((8, 128)), jnp.zeros(65),
                                 jnp.zeros(65), 128)
    with pytest.raises(ValueError, match="multiple of 4"):
        T.convolve(torch.zeros(3, 32, dtype=torch.complex64),
                   torch.zeros(32, dtype=torch.complex64))


def test_cpu_tensor_never_reaches_kernels(rng, monkeypatch):
    from smfft_tpu_torch.ops import _cuda

    def boom(*a, **k):
        raise AssertionError("a kernel was requested for a CPU tensor")
    monkeypatch.setattr(_cuda, "library", boom)
    monkeypatch.setattr(CV, "launch_conv", boom)
    monkeypatch.setattr(CV, "launch_conv_real", boom)
    x = torch.from_numpy(rand_c(rng, 4, 256))
    T.convolve(x, torch.from_numpy(rand_c(rng, 2, 256)))
    T.convolve_real(x.real.contiguous(),
                    torch.from_numpy(half_response(rng, n=256)))
    T.planar.convolve(x.real, x.imag, x.real[0], x.imag[0])


def test_launchers_refuse_cpu_tensors():
    x = torch.zeros(4, 256, dtype=torch.complex64)
    h = torch.zeros(1, 256, dtype=torch.complex64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        CV.launch_conv(x, h=h)
    with pytest.raises(ValueError, match="h must be"):
        CV.launch_conv(x, h=h[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        CV.launch_conv_real(torch.zeros(4, 256),
                            h=torch.zeros(1, 128, dtype=torch.complex64))
    with pytest.raises(ValueError, match="real convolve supports"):
        CV.launch_conv_real(torch.zeros(4, 128), h=h)


def test_plain_versions_never_call_torch_fft(rng, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("torch.fft called")
    for name in ("fft", "ifft", "rfft", "irfft"):
        monkeypatch.setattr(torch.fft, name, boom)
    x = torch.from_numpy(rand_c(rng, 4, 512))
    T.convolve(x, torch.from_numpy(rand_c(rng, 2, 512)))
    T.convolve_real(x.real.contiguous(),
                    torch.from_numpy(rand_c(rng, 257)))
