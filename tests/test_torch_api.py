"""Public API of smfft_tpu_torch (complex, real and planar) on CPU
tensors, against smfft_tpu's pallas backend (interpret mode) and float64
numpy; norms, precision tiers, the spec backend, autograd and the no-JAX
import.

Tolerances: tol(n) = 5e-7 * n^0.75 * 8 against numpy, 2 * tol(n) against
JAX.  JAX comparisons use sizes whose interpret-mode kernels trace in about
a second; every size is checked against numpy.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smfft_tpu
import smfft_tpu.ops.pallas_c2c as PC
import smfft_tpu.planar as JPL

import smfft_tpu_torch as T
from smfft_tpu_torch import api
from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES, SUPPORTED_REAL_SIZES

from conftest import max_abs_err

ROOT = Path(__file__).resolve().parent.parent
JAX_SIZES = (32, 128, 1024)


@pytest.fixture(autouse=True, scope="module")
def interpret_mode():
    PC.set_interpret(True)
    yield
    PC.set_interpret(False)


def tol(n):
    return 5e-7 * n ** 0.75 * 8


def rand_c(rng, shape):
    return (rng.random(shape) - 0.5 + 1j * (rng.random(shape) - 0.5)
            ).astype(np.complex64)


def revblock_to_natural(a, n):
    c = max(1, n // 128)
    return a if c == 1 else a.reshape(-1, c, 128).transpose(0, 2, 1).reshape(
        a.shape)


def jax_call(fn, x, **kw):
    return np.asarray(fn(jnp.asarray(x), backend="pallas", **kw))


@pytest.mark.parametrize("n", SUPPORTED_C2C_SIZES)
def test_complex_api(rng, n):
    x = rand_c(rng, (8 if n > 4096 else 16, n))
    x64 = x.astype(np.complex128)
    xt = torch.from_numpy(x)
    y = T.fft(xt)
    assert y.dtype == torch.complex64 and y.shape == xt.shape
    assert max_abs_err(y.numpy(), np.fft.fft(x64)) < tol(n)
    assert max_abs_err(T.ifft(xt).numpy(), np.fft.ifft(x64)) < tol(n) / n
    assert max_abs_err(T.ifft(xt, norm=None).numpy(),
                       np.fft.ifft(x64) * n) < tol(n)
    u = T.fft(xt, ordered=False)
    assert max_abs_err(revblock_to_natural(u.numpy(), n),
                       np.fft.fft(x64)) < tol(n)
    assert max_abs_err(T.ifft_unordered(u).numpy(), x) < tol(n)
    if n in JAX_SIZES:
        assert max_abs_err(y.numpy(), jax_call(smfft_tpu.fft, x)) < 2 * tol(n)
        assert max_abs_err(u.numpy(), jax_call(smfft_tpu.fft, x,
                                               ordered=False)) < 2 * tol(n)
        ref = jax_call(smfft_tpu.ifft, x, norm=None)
        assert max_abs_err(T.ifft(xt, norm=None).numpy(), ref) < 2 * tol(n)
        ref = jax_call(smfft_tpu.ifft_unordered, u.numpy())
        assert max_abs_err(T.ifft_unordered(u).numpy(), ref) < 2 * tol(n) / n


@pytest.mark.parametrize("n", SUPPORTED_C2C_SIZES)
def test_planar_api(rng, n):
    """planar.* at every size against numpy, including N = 32 / 64, where
    smfft_tpu.planar raises (see ROADMAP section C)."""
    x = rand_c(rng, (8 if n > 4096 else 16, n))
    x64 = x.astype(np.complex128)
    vr = torch.from_numpy(np.ascontiguousarray(x.real))
    vi = torch.from_numpy(np.ascontiguousarray(x.imag))
    o = T.planar.fft(vr, vi)
    got = o[0].numpy() + 1j * o[1].numpy()
    assert max_abs_err(got, np.fft.fft(x64)) < tol(n)
    o = T.planar.ifft(vr, vi)
    assert max_abs_err(o[0].numpy() + 1j * o[1].numpy(),
                       np.fft.ifft(x64)) < tol(n) / n
    o = T.planar.ifft(vr, vi, norm=None)
    assert max_abs_err(o[0].numpy() + 1j * o[1].numpy(),
                       np.fft.ifft(x64) * n) < tol(n)
    ur, ui = T.planar.fft(vr, vi, ordered=False)
    u = ur.numpy() + 1j * ui.numpy()
    assert max_abs_err(revblock_to_natural(u, n), np.fft.fft(x64)) < tol(n)
    br, bi = T.planar.ifft_unordered(ur, ui)
    assert max_abs_err(br.numpy() + 1j * bi.numpy(), x) < tol(n)
    if n in (128, 1024):
        jr, ji = JPL.fft(jnp.asarray(vr.numpy()), jnp.asarray(vi.numpy()))
        want = np.asarray(jr) + 1j * np.asarray(ji)
        assert max_abs_err(got, want) < 2 * tol(n)


def test_jax_planar_fails_below_128_port_does_not():
    """The reference fault recorded in ROADMAP section C: smfft_tpu.planar
    does not pack 128/N transforms per row at N = 32."""
    z = np.zeros((8, 32), np.float32)
    with pytest.raises(TypeError, match="cannot reshape"):
        JPL.fft(jnp.asarray(z), jnp.asarray(z))
    o_r, _ = T.planar.fft(torch.zeros(8, 32), torch.zeros(8, 32))
    assert o_r.shape == (8, 32)


@pytest.mark.parametrize("n", [64, 512])
def test_batch_shapes(rng, n):
    x = rand_c(rng, (2, 3, 4, n))
    xt = torch.from_numpy(x)
    y = T.fft(xt)
    assert y.shape == (2, 3, 4, n)
    assert max_abs_err(y.numpy(), np.fft.fft(x.astype(np.complex128))) \
        < tol(n)
    assert max_abs_err(T.ifft(y).numpy(), x) < tol(n)
    o_r, o_i = T.planar.ifft(*T.planar.fft(xt.real, xt.imag))
    assert o_r.shape == (2, 3, 4, n)
    assert max_abs_err(o_r.numpy() + 1j * o_i.numpy(), x) < tol(n)
    ref = jax_call(smfft_tpu.fft, x)
    assert max_abs_err(y.numpy(), ref) < 2 * tol(n)


def test_packing_rule_in_api():
    with pytest.raises(ValueError, match="multiple of 4"):
        T.fft(torch.zeros((2, 3, 32), dtype=torch.complex64))
    with pytest.raises(ValueError, match="multiple of 2"):
        T.planar.fft(torch.zeros(3, 64), torch.zeros(3, 64))


@pytest.mark.parametrize("precision", ["highest", "exact", "high", "fast",
                                       None])
def test_precision_tiers_accepted(rng, precision):
    """Every tier is accepted; "high" meets the reference's 1e-4 gate."""
    for n in (1024, 4096):
        x = rand_c(rng, (8, n))
        y = T.fft(torch.from_numpy(x), precision=precision)
        assert max_abs_err(y.numpy(), np.fft.fft(x.astype(np.complex128))) \
            < 1e-4


def test_default_precision_warns(monkeypatch):
    monkeypatch.setattr(api, "_warned_precisions", set())
    x = torch.zeros((4, 256), dtype=torch.complex64)
    with pytest.warns(UserWarning, match="precision='default'"):
        T.fft(x, precision="default")


def test_bad_arguments_raise():
    x = torch.zeros((4, 256), dtype=torch.complex64)
    with pytest.raises(ValueError, match="unknown precision"):
        T.fft(x, precision="bf16")
    with pytest.raises(ValueError, match="unknown backend"):
        T.fft(x, backend="pallas")
    with pytest.raises(ValueError, match="norm"):
        T.ifft(x, norm="ortho")
    with pytest.raises(ValueError, match="shapes differ"):
        T.planar.fft(torch.zeros(4, 256), torch.zeros(2, 256))


@pytest.mark.parametrize("n", [32, 256])
def test_spec_backend(rng, n):
    from smfft_tpu_torch.models.cooley_tukey import bit_reverse_indices
    x = rand_c(rng, (4, n))
    x64 = x.astype(np.complex128)
    xt = torch.from_numpy(x)
    assert max_abs_err(T.fft(xt, backend="spec").numpy(), np.fft.fft(x64)) \
        < tol(n)
    u = T.fft(xt, ordered=False, backend="spec")
    assert max_abs_err(u.numpy(), np.fft.fft(x64)[:, bit_reverse_indices(n)]) \
        < tol(n)
    assert max_abs_err(T.ifft_unordered(u, backend="spec").numpy(), x) \
        < tol(n)
    assert max_abs_err(T.ifft(xt, backend="spec", norm=None).numpy(),
                       np.fft.ifft(x64) * n) < tol(n)
    ref = np.asarray(smfft_tpu.fft(jnp.asarray(x), backend="spec"))
    assert max_abs_err(T.fft(xt, backend="spec").numpy(), ref) < 2 * tol(n)


@pytest.mark.parametrize("n", [32, 256])
@pytest.mark.parametrize("which", ["fft", "ifft", "ifft_raw"])
def test_autograd_gradcheck(n, which):
    """gradcheck (complex128, plain version) and agreement with torch.fft's
    own gradients: the backward of a forward transform is the raw inverse
    (PyTorch's conjugate convention), not the same transform."""
    fn = {"fft": lambda a: T.fft(a),
          "ifft": lambda a: T.ifft(a),
          "ifft_raw": lambda a: T.ifft(a, norm=None)}[which]
    ref = {"fft": lambda a: torch.fft.fft(a),
           "ifft": lambda a: torch.fft.ifft(a),
           "ifft_raw": lambda a: torch.fft.ifft(a) * n}[which]
    rng = np.random.default_rng(n)
    b = 4 if n == 32 else 1
    x = torch.from_numpy(rng.random((b, n)) + 1j * rng.random((b, n)))
    x.requires_grad_(True)
    assert torch.autograd.gradcheck(fn, (x,))
    g = torch.from_numpy(rng.random((b, n)) + 1j * rng.random((b, n)))
    (gx,) = torch.autograd.grad(fn(x), x, g)
    (gr,) = torch.autograd.grad(ref(x), x, g)
    assert torch.allclose(gx, gr, atol=1e-10)


def test_import_loads_no_jax():
    code = ("import sys, smfft_tpu_torch, smfft_tpu_torch.verify, "
            "smfft_tpu_torch.native, smfft_tpu_torch.ops._cuda, "
            "smfft_tpu_torch.planar; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'smfft_tpu' or m.startswith('smfft_tpu.') "
            "for m in sys.modules), 'smfft_tpu imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sources_name_no_jax():
    for path in (ROOT / "smfft_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import smfft_tpu ", "import smfft_tpu.",
                                     "from smfft_tpu ", "from smfft_tpu.")), \
                f"{path}: {s}"


# ---------------------------------------------------------------------------
# Real transforms: api.rfft / irfft / fft_packed_real, planar.rfft / irfft.
# The JAX side runs its pallas backend in interpret mode up to n = 4096 and
# its plain backend (backend="xla") at 8192 / 16384, as in
# tests/test_torch_real.py; tolerances as above.
# ---------------------------------------------------------------------------

REAL_INTERPRET_MAX = 4096


def rand_r(rng, shape):
    return (rng.random(shape) - 0.5).astype(np.float32)


def jax_backend(n):
    return "pallas" if n <= REAL_INTERPRET_MAX else "xla"


@pytest.mark.parametrize("n", SUPPORTED_REAL_SIZES)
def test_real_api(rng, n):
    """rfft, fft_packed_real and irfft (numpy and packed layouts, norm
    "backward" and None) against smfft_tpu.api and numpy."""
    L = n // 2
    x = rand_r(rng, (8, n))
    x64 = x.astype(np.float64)
    xt = torch.from_numpy(x)
    full = np.fft.rfft(x64)
    y = T.rfft(xt)
    assert y.dtype == torch.complex64 and y.shape == (8, L + 1)
    assert max_abs_err(y.numpy(), full) < tol(n)
    pk = T.fft_packed_real(xt)
    assert pk.shape == (8, L)
    assert max_abs_err(pk.numpy()[:, 1:], full[:, 1:L]) < tol(n)
    assert max_abs_err(pk.numpy()[:, 0].real, full[:, 0].real) < tol(n)
    assert max_abs_err(pk.numpy()[:, 0].imag, full[:, L].real) < tol(n)
    back = T.irfft(y)
    assert back.dtype == torch.float32 and back.shape == (8, n)
    assert max_abs_err(back.numpy(), x) < tol(n)
    raw = T.irfft(y, norm=None)
    assert max_abs_err(raw.numpy(), x * L) < tol(n) * L
    assert max_abs_err(T.irfft(pk, packed=True).numpy(), x) < tol(n)
    assert max_abs_err(T.irfft(pk, n=n, packed=True, norm=None).numpy(),
                       x * L) < tol(n) * L
    be = jax_backend(n)
    ref = np.asarray(smfft_tpu.rfft(jnp.asarray(x), backend=be))
    assert max_abs_err(y.numpy(), ref) < 2 * tol(n)
    ref = np.asarray(smfft_tpu.irfft(jnp.asarray(y.numpy()), n=n,
                                     backend=be, norm=None))
    assert max_abs_err(raw.numpy(), ref) < 2 * tol(n) * L
    if n in (64, 1024, 16384):
        ref = np.asarray(smfft_tpu.fft_packed_real(jnp.asarray(x),
                                                   backend=be))
        assert max_abs_err(pk.numpy(), ref) < 2 * tol(n)
        ref = np.asarray(smfft_tpu.irfft(jnp.asarray(pk.numpy()), n=n,
                                         backend=be, packed=True))
        assert max_abs_err(T.irfft(pk, packed=True).numpy(), ref) \
            < 2 * tol(n)


@pytest.mark.parametrize("n", [n for n in SUPPORTED_REAL_SIZES if n >= 256])
def test_planar_real_api(rng, n):
    """planar.rfft / planar.irfft, natural and revblock, against
    smfft_tpu.planar (n <= 4096) or the JAX plain backend, and numpy."""
    L = n // 2
    x = rand_r(rng, (8, n))
    xt = torch.from_numpy(x)
    full = np.fft.rfft(x.astype(np.float64))
    pk = np.concatenate([full[:, :1].real + 1j * full[:, L:].real,
                         full[:, 1:L]], axis=1)
    hr, hi = T.planar.rfft(xt)
    got = hr.numpy() + 1j * hi.numpy()
    assert hr.shape == (8, L)
    assert max_abs_err(got, pk) < tol(n)
    ur, ui = T.planar.rfft(xt, ordered=False)
    c = max(1, L // 128)
    rev = pk if c == 1 else pk.reshape(-1, 128, c).transpose(
        0, 2, 1).reshape(-1, L)
    assert max_abs_err(ur.numpy() + 1j * ui.numpy(), rev) < tol(n)
    assert max_abs_err(T.planar.irfft(hr, hi).numpy(), x) < tol(n)
    assert max_abs_err(T.planar.irfft(ur, ui, in_natural=False).numpy(),
                       x) < tol(n)
    raw = T.planar.irfft(hr, hi, norm=None).numpy()
    assert max_abs_err(raw, x * L) < tol(n) * L
    if n <= REAL_INTERPRET_MAX:
        jr, ji = JPL.rfft(jnp.asarray(x))
        ref = np.asarray(jr) + 1j * np.asarray(ji)
        jraw = np.asarray(JPL.irfft(jr, ji, norm=None))
    else:
        ref = np.asarray(smfft_tpu.fft_packed_real(jnp.asarray(x),
                                                   backend="xla"))
        jraw = np.asarray(smfft_tpu.irfft(jnp.asarray(ref), n=n,
                                          backend="xla", packed=True,
                                          norm=None))
    assert max_abs_err(got, ref) < 2 * tol(n)
    assert max_abs_err(raw, jraw) < 2 * tol(n) * L
    if n == 1024:
        jr, ji = JPL.rfft(jnp.asarray(x), ordered=False)
        assert max_abs_err(ur.numpy() + 1j * ui.numpy(),
                           np.asarray(jr) + 1j * np.asarray(ji)) < 2 * tol(n)
        jback = np.asarray(JPL.irfft(jr, ji, in_natural=False))
        assert max_abs_err(T.planar.irfft(ur, ui, in_natural=False).numpy(),
                           jback) < 2 * tol(n)


@pytest.mark.parametrize("n", [128, 2048])
def test_real_batch_shapes(rng, n):
    L = n // 2
    x = rand_r(rng, (2, 3, 4, n))
    xt = torch.from_numpy(x)
    y = T.rfft(xt)
    assert y.shape == (2, 3, 4, L + 1)
    assert max_abs_err(y.numpy(), np.fft.rfft(x.astype(np.float64))) < tol(n)
    if n < 256:  # larger n: test_real_api holds the same kernels to JAX
        ref = np.asarray(smfft_tpu.rfft(jnp.asarray(x), backend="pallas"))
        assert max_abs_err(y.numpy(), ref) < 2 * tol(n)
    assert T.irfft(y).shape == (2, 3, 4, n)
    assert max_abs_err(T.irfft(y).numpy(), x) < tol(n)
    assert T.fft_packed_real(xt).shape == (2, 3, 4, L)
    if n >= 256:
        hr, hi = T.planar.rfft(xt)
        assert hr.shape == (2, 3, 4, L)
        assert max_abs_err(T.planar.irfft(hr, hi).numpy(), x) < tol(n)


def test_real_size_errors():
    """The reference's size switch and the planar n >= 256 rule, as in
    smfft_tpu."""
    for n in (48, 32768):
        with pytest.raises(ValueError, match="Error wrong FFT length!"):
            T.rfft(torch.zeros(4, n))
        with pytest.raises(ValueError, match="Error wrong FFT length!"):
            smfft_tpu.rfft(jnp.zeros((4, n), jnp.float32), backend="xla")
        with pytest.raises(ValueError, match="Error wrong FFT length!"):
            T.fft_packed_real(torch.zeros(4, n))
    with pytest.raises(ValueError, match="Error wrong FFT length!"):
        T.irfft(torch.zeros(4, 25, dtype=torch.complex64))
    with pytest.raises(ValueError, match="Error wrong FFT length!"):
        smfft_tpu.irfft(jnp.zeros((4, 25), jnp.complex64), backend="xla")
    with pytest.raises(ValueError, match="takes 129 bins"):
        T.irfft(torch.zeros(4, 65, dtype=torch.complex64), n=256)
    for fn, jfn, shape in ((T.planar.rfft, JPL.rfft, (4, 128)),):
        with pytest.raises(ValueError, match="Error wrong FFT length!"):
            fn(torch.zeros(shape))
        with pytest.raises(ValueError, match="Error wrong FFT length!"):
            jfn(jnp.zeros(shape, jnp.float32))
    z = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="Error wrong FFT length!"):
        T.planar.irfft(z, z)
    with pytest.raises(ValueError, match="Error wrong FFT length!"):
        JPL.irfft(jnp.zeros((4, 64)), jnp.zeros((4, 64)))
    with pytest.raises(ValueError, match="norm"):
        T.irfft(torch.zeros(4, 129, dtype=torch.complex64), norm="ortho")
    with pytest.raises(ValueError, match="unknown precision"):
        T.rfft(torch.zeros(4, 256), precision="bf16")


@pytest.mark.parametrize("packed", [False, True])
def test_real_spec_backend(rng, packed):
    n = 256
    x = rand_r(rng, (4, n))
    xt = torch.from_numpy(x)
    fn = T.fft_packed_real if packed else T.rfft
    jfn = smfft_tpu.fft_packed_real if packed else smfft_tpu.rfft
    got = fn(xt, backend="spec")
    assert max_abs_err(got.numpy(), fn(xt).numpy()) < 2 * tol(n)
    ref = np.asarray(jfn(jnp.asarray(x), backend="spec"))
    assert max_abs_err(got.numpy(), ref) < 2 * tol(n)
    back = T.irfft(got, n=n, backend="spec", packed=packed, norm=None)
    assert max_abs_err(back.numpy(), x * (n // 2)) < tol(n) * n
    assert max_abs_err(T.irfft(got, n=n, backend="spec",
                               packed=packed).numpy(), x) < tol(n)


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("which", ["rfft", "irfft", "irfft_raw"])
def test_real_autograd(n, which):
    """gradcheck (float64, plain versions) and agreement with torch.fft's
    gradients, which follow PyTorch's conjugate convention (the JAX rules
    conjugate instead)."""
    L = n // 2
    rng = np.random.default_rng(n)
    b = 4
    if which == "rfft":
        x = torch.from_numpy(rng.random((b, n)))
        fn, ref = T.rfft, torch.fft.rfft
        g = torch.from_numpy(rng.random((b, L + 1))
                             + 1j * rng.random((b, L + 1)))
    else:
        x = torch.from_numpy(rng.random((b, L + 1))
                             + 1j * rng.random((b, L + 1)))
        norm = "backward" if which == "irfft" else None
        scale = 1.0 if which == "irfft" else float(L)

        def fn(a):
            return T.irfft(a, norm=norm)

        def ref(a):
            return torch.fft.irfft(a, n) * scale
        g = torch.from_numpy(rng.random((b, n)))
    x.requires_grad_(True)
    assert torch.autograd.gradcheck(fn, (x,))
    (gx,) = torch.autograd.grad(fn(x), x, g)
    (gr,) = torch.autograd.grad(ref(x), x, g)
    assert torch.allclose(gx, gr, atol=1e-10)


def test_packed_real_has_no_gradient():
    x = torch.zeros(4, 256, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        T.fft_packed_real(x).abs().sum().backward()
    h = torch.zeros(4, 128, dtype=torch.complex64, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        T.irfft(h, packed=True).sum().backward()


@pytest.mark.parametrize("n", [512, 16384])
def test_exact_tier_c2c_cpu(rng, n):
    """precision="exact" on the CPU runs the plain version in float64 and
    rounds once: within the tier's 2 ulp of max|X| (here within 1)."""
    x = rand_c(rng, (8, n))
    want = np.fft.fft(x.astype(np.complex128))
    ulp = np.spacing(np.float32(np.abs(want).max()))
    y = T.fft(torch.from_numpy(x), precision="exact")
    assert y.dtype == torch.complex64
    assert max_abs_err(y.numpy(), want) <= ulp
    o_r, o_i = T.planar.ifft(torch.from_numpy(x.real.copy()),
                             torch.from_numpy(x.imag.copy()), norm=None,
                             precision="exact")
    want = np.fft.ifft(x.astype(np.complex128)) * n
    assert max_abs_err(o_r.numpy() + 1j * o_i.numpy(), want) <= np.spacing(
        np.float32(np.abs(want).max()))


# A real input to the C2C entry points and a real spectrum to irfft: the
# port promotes it to complex64, as the JAX package does.  The JAX side
# runs its pallas backend (interpret mode) at n = 256 and "xla" at 2^15.
REAL_INPUT_CASES = {
    "fft": (T.fft, smfft_tpu.fft, 256, "pallas"),
    "ifft": (T.ifft, smfft_tpu.ifft, 256, "pallas"),
    "ifft_unordered": (T.ifft_unordered, smfft_tpu.ifft_unordered, 256,
                       "pallas"),
    "fft_large": (T.fft_large, smfft_tpu.fft_large, 1 << 15, "xla"),
    "ifft_large": (T.ifft_large, smfft_tpu.ifft_large, 1 << 15, "xla"),
    "irfft": (T.irfft, smfft_tpu.irfft, 129, "pallas"),
}


@pytest.mark.parametrize("entry", list(REAL_INPUT_CASES))
def test_real_input_promoted(rng, entry):
    """A float32 input gives exactly the output of its complex64 copy, and
    the JAX function's output on the same numpy input within 2 tol(n)."""
    port, ref, width, be = REAL_INPUT_CASES[entry]
    rows = 1 if width > 1 << 14 else 2
    x = (rng.random((rows, width)) - 0.5).astype(np.float32)
    got = port(torch.from_numpy(x))
    same = port(torch.from_numpy(x.astype(np.complex64)))
    assert got.dtype == same.dtype
    assert torch.equal(got, same)
    want = np.asarray(ref(jnp.asarray(x), backend=be))
    n = 256 if entry == "irfft" else width
    assert max_abs_err(got.numpy(), want) < 2 * tol(n)


# Integer, bool and half-precision inputs to the real entry points: the
# port promotes them to float32, as the JAX package does (backend="xla"),
# and the result's dtype is the float32 input's.
PROMOTED_DTYPES = (np.int32, np.int64, np.bool_, np.float16)
_H256 = np.fft.rfft(np.hanning(256)).astype(np.complex64)
_TAPS = np.hanning(33).astype(np.float32)
REAL_ENTRY_CASES = {
    "rfft": (T.rfft, smfft_tpu.rfft, (4, 256), ()),
    "fft_packed_real": (T.fft_packed_real, smfft_tpu.fft_packed_real,
                        (4, 256), ()),
    "convolve_real": (T.convolve_real, smfft_tpu.convolve_real, (4, 256),
                      (_H256,)),
    "rfft_large": (T.rfft_large, smfft_tpu.rfft_large, (2, 1 << 15), ()),
    "fftconvolve": (T.fftconvolve, smfft_tpu.fftconvolve, (2, 3000),
                    (_TAPS,)),
}


@pytest.mark.parametrize("dtype", PROMOTED_DTYPES)
@pytest.mark.parametrize("entry", list(REAL_ENTRY_CASES))
def test_real_entry_promotes_like_jax(entry, dtype):
    """C.4: rfft, fft_packed_real, convolve_real, rfft_large and the
    real path of fftconvolve take int32 / int64 / bool / float16 rows and
    return what the JAX package returns within 1e-4 * max|ref|."""
    port, ref, shape, extra = REAL_ENTRY_CASES[entry]
    rng = np.random.default_rng(11)
    x = (rng.random(shape) * 20 - 10).astype(dtype)
    got = port(torch.from_numpy(x), *map(torch.from_numpy, extra))
    want = np.asarray(ref(jnp.asarray(x), *map(jnp.asarray, extra),
                          backend="xla"))
    f32 = port(torch.from_numpy(x.astype(np.float32)),
               *map(torch.from_numpy, extra))
    assert got.dtype == f32.dtype and str(got.dtype)[6:] == str(want.dtype)
    assert torch.equal(got, f32)
    assert max_abs_err(got.numpy(), want) <= 1e-4 * np.abs(want).max()

