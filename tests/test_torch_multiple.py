"""The reuse loops of smfft_tpu_torch (``ops/multiple.py``: the plain
PyTorch versions of ``csrc/multiple.cu``'s two kernels, which CPU tensors
run) against smfft_tpu and float64 numpy.

The same seeded numpy inputs go through both packages.  The JAX side runs
``pallas_c2c.fft_planar(multiple_iters=k)`` in interpret mode and the
pencil loops through their own CPU route, as their own tests do.
Tolerances: each transform adds fp32 rounding of about 2e-7 * N^0.75 * 8
(tol(n), the JAX suite's bound at 5e-7), and the error of k + 1 chained
unitary-scaled transforms grows about as sqrt(k + 1), so the bound against
numpy is tol(n) * (k + 1) (linear, a safe over-estimate of sqrt), and
against the JAX function twice that, since both sit within it of the
oracle.
"""

import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smfft_tpu.ops.pallas_c2c as PC
from smfft_tpu.ops import pencil

from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import multiple as M

from conftest import max_abs_err


@pytest.fixture(autouse=True, scope="module")
def interpret_mode():
    PC.set_interpret(True)
    yield
    PC.set_interpret(False)


def tol(n):
    return 5e-7 * n ** 0.75 * 8


def rand_planes(rng, rows, width):
    return [(rng.random((rows, width)) - 0.5).astype(np.float32)
            for _ in range(2)]


def rev(a):
    """Natural (b, n) -> revblock: position k2*128 + k1 holds k1*c + k2."""
    b, n = a.shape
    c = max(1, n // 128)
    return a if c == 1 else a.reshape(b, 128, c).transpose(0, 2, 1).reshape(
        b, n)


def unrev(a):
    b, n = a.shape
    c = max(1, n // 128)
    return a if c == 1 else a.reshape(b, c, 128).transpose(0, 2, 1).reshape(
        b, n)


def b1_oracle(x, k, rev_in, ordered):
    """fft_planar(multiple_iters=k) in float64: k re-applications of kernel
    A (natural -> revblock) times 1/sqrt(n), each revblock row read as
    natural input, then the final transform in fft_planar's layouts."""
    n = x.shape[-1]
    y = x.astype(np.complex128)
    for _ in range(k):
        y = rev(np.fft.fft(y)) / math.sqrt(n)
    if rev_in:
        return np.fft.fft(unrev(y))
    out = np.fft.fft(y)
    return out if ordered else rev(out)


MODES = [("rev_out", False, False), ("ordered", False, True),
         ("rev_in", True, False)]


@pytest.mark.parametrize("n", [64, 512])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("mode,rev_in,ordered", MODES)
def test_fft_planar_multiple_matches_jax(rng, n, k, mode, rev_in, ordered):
    """ops.c2c.fft_planar(multiple_iters=k) against the JAX function in
    interpret mode and the float64 oracle with the revblock feedback."""
    row = max(n, 128)
    vr, vi = rand_planes(rng, 8, row)
    o_r, o_i = C.fft_planar(torch.from_numpy(vr), torch.from_numpy(vi), n,
                            rev_in=rev_in, ordered=ordered,
                            multiple_iters=k)
    got = o_r.numpy() + 1j * o_i.numpy()
    j_r, j_i = PC.fft_planar(jnp.asarray(vr), jnp.asarray(vi), n,
                             rev_in=rev_in, ordered=ordered,
                             multiple_iters=k)
    ref = np.asarray(j_r) + 1j * np.asarray(j_i)
    assert got.shape == ref.shape == (8, row)
    assert max_abs_err(got, ref) < 2 * tol(n) * (k + 1)
    x = (vr + 1j * vi).reshape(-1, n)
    want = b1_oracle(x, k, rev_in, ordered).reshape(8, row)
    assert max_abs_err(got, want) < tol(n) * (k + 1)


def test_b1_feedback_is_revblock_not_natural(rng):
    """Pins the re-application order: above N = 128 each re-application
    feeds kernel A's revblock output back as natural input.  The loop of
    natural-order transforms computes something else, and the JAX function
    agrees with the revblock loop."""
    n, k = 512, 2
    vr, vi = rand_planes(rng, 8, n)
    x = vr + 1j * vi
    j_r, j_i = PC.fft_planar(jnp.asarray(vr), jnp.asarray(vi), n,
                             ordered=True, multiple_iters=k)
    ref = np.asarray(j_r) + 1j * np.asarray(j_i)
    natural = x.astype(np.complex128)
    for _ in range(k + 1):
        natural = np.fft.fft(natural) / math.sqrt(n)
    natural *= math.sqrt(n)  # the final transform is unscaled
    assert max_abs_err(ref, natural) > 1.0
    assert max_abs_err(ref, b1_oracle(x, k, False, True)) < tol(n) * (k + 1)
    got = M.multiple_plain(torch.from_numpy(vr), torch.from_numpy(vi),
                           loops=k, fb_rev=True, last_rev=True)
    assert max_abs_err(got[0].numpy() + 1j * got[1].numpy(), ref) \
        < 2 * tol(n) * (k + 1)


def test_fft_planar_multiple_scale_and_exact(rng):
    """The fused input scale, the inverse direction and the "exact" tier
    (computed in float64, rounded once) of the B1 form."""
    n, k = 256, 2
    vr, vi = rand_planes(rng, 4, n)
    x = (vr + 1j * vi).astype(np.complex128)
    want = x * 0.5
    for _ in range(k):
        want = rev(np.fft.ifft(want) * n) / math.sqrt(n)
    want = np.fft.ifft(want) * n
    for exact in (False, True):
        o_r, o_i = C.fft_planar(torch.from_numpy(vr), torch.from_numpy(vi),
                                n, inverse=True, ordered=True, scale=0.5,
                                exact=exact, multiple_iters=k)
        err = max_abs_err(o_r.numpy() + 1j * o_i.numpy(), want)
        assert err < (np.spacing(np.float32(np.abs(want).max())) if exact
                      else tol(n) * (k + 1))


@pytest.mark.parametrize("n", [32, 256])
@pytest.mark.parametrize("iters", [2, 5])
def test_multiple_pencil_planar_matches_jax(rng, n, iters):
    """iters natural-order transforms, each times 1/sqrt(n), one transform
    per row at any n (no row packing below 128)."""
    vr, vi = rand_planes(rng, 8, n)
    o_r, o_i = M.multiple_pencil_planar(torch.from_numpy(vr),
                                        torch.from_numpy(vi), n, iters)
    got = o_r.numpy() + 1j * o_i.numpy()
    j_r, j_i = pencil.multiple_pencil_planar(jnp.asarray(vr),
                                             jnp.asarray(vi), n, iters)
    assert max_abs_err(got, np.asarray(j_r) + 1j * np.asarray(j_i)) \
        < 2 * tol(n) * iters
    want = (vr + 1j * vi).astype(np.complex128)
    for _ in range(iters):
        want = np.fft.fft(want) / math.sqrt(n)
    assert max_abs_err(got, want) < tol(n) * iters
    # (F / sqrt(n))^4 = I
    if iters == 2:
        back = M.multiple_pencil_planar(o_r, o_i, n, 2)
        assert max_abs_err(back[0].numpy() + 1j * back[1].numpy(),
                           vr + 1j * vi) < tol(n) * 4


@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("iters", [2, 4])
def test_multiple_real_pencil_planar_matches_jax(rng, n, iters):
    """iters/2 R2C -> C2R round trips at scale 1/L return the input."""
    x = (rng.random((8, n)) - 0.5).astype(np.float32)
    got = M.multiple_real_pencil_planar(torch.from_numpy(x), n,
                                        iters).numpy()
    ref = np.asarray(pencil.multiple_real_pencil_planar(jnp.asarray(x), n,
                                                        iters))
    assert max_abs_err(got, ref) < 2 * tol(n) * iters
    assert max_abs_err(got, x) < tol(n) * iters


def test_inverse_pencil_and_zero_iters(rng):
    """The pencil form's inverse direction, and iters = 0, which returns
    the input as the JAX loop does."""
    n = 128
    vr, vi = rand_planes(rng, 4, n)
    o_r, o_i = M.multiple_pencil_planar(torch.from_numpy(vr),
                                        torch.from_numpy(vi), n, 3,
                                        inverse=True)
    j_r, j_i = pencil.multiple_pencil_planar(jnp.asarray(vr),
                                             jnp.asarray(vi), n, 3,
                                             inverse=True)
    assert max_abs_err(o_r.numpy() + 1j * o_i.numpy(),
                       np.asarray(j_r) + 1j * np.asarray(j_i)) < 6 * tol(n)
    z_r, z_i = M.multiple_pencil_planar(torch.from_numpy(vr),
                                        torch.from_numpy(vi), n, 0)
    assert np.array_equal(z_r.numpy(), vr) and np.array_equal(z_i.numpy(),
                                                              vi)
    x = torch.from_numpy((rng.random((4, 256)) - 0.5).astype(np.float32))
    assert torch.equal(M.multiple_real_pencil_planar(x, 256, 0), x)


@pytest.mark.parametrize("call,match", [
    (lambda m, z: m(z(8, 96), z(8, 96), 96, 2), "wrong FFT length"),
    (lambda m, z: m(z(8, 8192), z(8, 8192), 8192, 2), "wrong FFT length"),
    (lambda m, z: m(z(8, 256), z(8, 256), 512, 2), "row width 512"),
])
def test_pencil_errors_match_jax(call, match):
    for fn, zeros in ((M.multiple_pencil_planar, torch.zeros),
                      (pencil.multiple_pencil_planar,
                       lambda *s: jnp.zeros(s, jnp.float32))):
        with pytest.raises(ValueError, match=match):
            call(fn, zeros)


@pytest.mark.parametrize("args,match", [
    ((512, 3), "iters must be even"),
    ((128, 2), "wrong FFT length"),
    ((8192, 2), "wrong FFT length"),
    ((1024, 2), "row width 1024"),
])
def test_real_pencil_errors_match_jax(args, match):
    n, iters = args
    width = 512 if match.startswith("row") else n
    for fn, zeros in ((M.multiple_real_pencil_planar, torch.zeros),
                      (pencil.multiple_real_pencil_planar,
                       lambda *s: jnp.zeros(s, jnp.float32))):
        with pytest.raises(ValueError, match=match):
            fn(zeros(8, width), n, iters)


def test_cpu_tensor_never_reaches_kernels(rng, monkeypatch):
    """CPU tensors run the plain versions: no build, no launch."""
    from smfft_tpu_torch.ops import _cuda

    def boom(*a, **k):
        raise AssertionError("a kernel was requested for a CPU tensor")
    monkeypatch.setattr(_cuda, "library", boom)
    monkeypatch.setattr(M, "launch_multiple", boom)
    monkeypatch.setattr(M, "launch_real_multiple", boom)
    vr, vi = (torch.from_numpy(p) for p in rand_planes(rng, 4, 256))
    C.fft_planar(vr, vi, 256, multiple_iters=2)
    M.multiple_pencil_planar(vr, vi, 256, 3)
    M.multiple_real_pencil_planar(vr, 256, 2)


def test_launchers_refuse_cpu_tensors_and_bad_shapes():
    x = torch.zeros(4, 256)
    with pytest.raises(ValueError, match="CUDA tensor"):
        M.launch_multiple(x, x, loops=1)
    with pytest.raises(ValueError, match="loops must be"):
        M.launch_multiple(x, x, loops=-1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        M.launch_real_multiple(x, 1)
    with pytest.raises(ValueError, match="wrong FFT length"):
        M.launch_real_multiple(torch.zeros(4, 8192), 1)


def test_plain_versions_never_call_torch_fft(rng, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("torch.fft called")
    for name in ("fft", "ifft", "rfft", "irfft"):
        monkeypatch.setattr(torch.fft, name, boom)
    vr, vi = (torch.from_numpy(p) for p in rand_planes(rng, 4, 512))
    M.multiple_plain(vr, vi, loops=2, fb_rev=True, last_rev=True)
    M.real_multiple_plain(vr, 2)


def test_new_modules_import_without_jax():
    """The port's new modules load no JAX (checked in a fresh process)."""
    code = ("import sys; import smfft_tpu_torch, smfft_tpu_torch.signal, "
            "smfft_tpu_torch.ops.multiple, smfft_tpu_torch.ops.convolve; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'smfft_tpu.')) or m == 'smfft_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stdout + out.stderr
