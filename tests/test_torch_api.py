"""Public API of smfft_tpu_torch (complex and planar) on CPU tensors,
against smfft_tpu's pallas backend (interpret mode) and float64 numpy;
norms, precision tiers, the spec backend, autograd and the no-JAX import.

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
from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES

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
    """Every tier runs the same fp32 kernel; "high" meets the reference's
    1e-4 gate."""
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
