"""The real-transform op of smfft_tpu_torch (the plain PyTorch versions of
the R2C / C2R kernels, which CPU tensors run) against smfft_tpu and
float64 numpy; the wrappers' input checks; the torch spec.

The same seeded numpy inputs go through both packages.  The JAX side runs
``pallas_real.rfft_fused_planar`` / ``irfft_fused_planar`` in interpret
mode, as its own tests do, at n = 256 … 4096; at 8192 / 16384 (where the
interpreter takes minutes on a CPU) the JAX reference is its plain backend
(``backend="xla"``) with the revblock map applied here.  Tolerances:
tol(n) = 5e-7 * n^0.75 * 8 against numpy (the JAX suite's, in
tests/test_pallas_real.py), 2 * tol(n) against JAX, since both sides sit
within tol(n) of the oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smfft_tpu
import smfft_tpu.models.real as JRM
import smfft_tpu.ops.pallas_c2c as PC
import smfft_tpu.ops.pallas_real as PR

import smfft_tpu_torch as T
from smfft_tpu_torch.models import real as TRM
from smfft_tpu_torch.ops import real as R
from smfft_tpu_torch.params import SUPPORTED_REAL_SIZES

from conftest import max_abs_err

INTERPRET_MAX = 4096


@pytest.fixture(autouse=True, scope="module")
def interpret_mode():
    PC.set_interpret(True)
    yield
    PC.set_interpret(False)


def tol(n):
    return 5e-7 * n ** 0.75 * 8


def rand_real(rng, n, rows=8):
    return (rng.random((rows, n)) - 0.5).astype(np.float32)


def revblock(a, L):
    """Natural (b, L) -> revblock at size L."""
    c = max(1, L // 128)
    return a if c == 1 else a.reshape(-1, 128, c).transpose(0, 2, 1).reshape(
        -1, L)


def packed_of(full):
    """numpy rfft layout (b, L+1) -> packed (b, L), slot 0 = DC + i Nyq."""
    L = full.shape[-1] - 1
    return np.concatenate([full[:, :1].real + 1j * full[:, L:].real,
                           full[:, 1:L]], axis=1)


def planar(pair):
    return pair[0].numpy() + 1j * pair[1].numpy()


@pytest.mark.parametrize("n", [n for n in SUPPORTED_REAL_SIZES if n >= 256])
@pytest.mark.parametrize("ordered", [True, False])
def test_plain_matches_jax_fused(rng, n, ordered):
    """r2c_plain / c2r_plain against rfft_fused_planar / irfft_fused_planar
    in natural (ordered / in_natural) and revblock order."""
    L = n // 2
    x = rand_real(rng, n)
    layout = "planar" if ordered else "planar_rev"

    def in_layout(pk):
        return pk if ordered else revblock(pk, L)

    got = planar(R.r2c_plain(torch.from_numpy(x), layout))
    assert max_abs_err(got, in_layout(packed_of(np.fft.rfft(
        x.astype(np.float64))))) < tol(n)
    if n <= INTERPRET_MAX:
        jr, ji = PR.rfft_fused_planar(jnp.asarray(x), ordered=ordered)
        ref = np.asarray(jr) + 1j * np.asarray(ji)
        jback = np.asarray(PR.irfft_fused_planar(jr, ji, n,
                                                 in_natural=ordered))
    else:
        full = np.asarray(smfft_tpu.rfft(jnp.asarray(x), backend="xla"))
        ref = in_layout(packed_of(full))
        jback = np.asarray(smfft_tpu.irfft(jnp.asarray(full), n=n,
                                           backend="xla", norm=None))
    assert max_abs_err(got, ref) < 2 * tol(n)
    # C2R of the JAX spectrum, raw contract: (n/2) * x
    back = R.c2r_plain(torch.from_numpy(ref.real.astype(np.float32)),
                       torch.from_numpy(ref.imag.astype(np.float32)), n=n,
                       layout=layout).numpy()
    assert max_abs_err(back / L, x) < tol(n)
    assert max_abs_err(back, jback) < 2 * tol(n) * L


@pytest.mark.parametrize("n", SUPPORTED_REAL_SIZES)
def test_plain_every_layout(rng, n):
    """Every layout of both plain versions against float64 numpy, the C2R
    scale, and the C2R ignoring the imaginary parts of DC and Nyquist in
    the numpy layout."""
    L = n // 2
    x = rand_real(rng, n, rows=5)
    xt = torch.from_numpy(x)
    full = np.fft.rfft(x.astype(np.float64))
    pk = packed_of(full)
    want = {"planar": pk, "planar_rev": revblock(pk, L), "packed": pk,
            "numpy": full}
    for layout in R.LAYOUTS:
        got = R.r2c_plain(xt, layout)
        got_np = planar(got) if isinstance(got, tuple) else got.numpy()
        assert max_abs_err(got_np, want[layout]) < tol(n), layout
        args = got if isinstance(got, tuple) else (got,)
        raw = R.c2r_plain(*args, n=n, layout=layout)
        assert max_abs_err(raw.numpy(), x * L) < tol(n) * L, layout
        norm = R.c2r_plain(*args, n=n, layout=layout, scale=1.0 / L)
        assert max_abs_err(norm.numpy(), x) < tol(n), layout
    noisy = full.astype(np.complex64)
    noisy[:, 0] += 3j
    noisy[:, L] -= 5j
    back = R.c2r_plain(torch.from_numpy(noisy), n=n, layout="numpy",
                       scale=1.0 / L)
    assert max_abs_err(back.numpy(), x) < tol(n)


@pytest.mark.parametrize("n", [64, 1024, 16384])
def test_exact_tier_plain(rng, n):
    """The "exact" plain versions compute in float64 and round once: within
    one ulp of the largest output of the float64 oracle."""
    L = n // 2
    x = rand_real(rng, n)
    full = np.fft.rfft(x.astype(np.float64))
    got = R.r2c_plain(torch.from_numpy(x), "numpy", exact=True)
    assert got.dtype == torch.complex64
    ulp = np.spacing(np.float32(np.abs(full).max()))
    assert max_abs_err(got.numpy(), full) <= ulp
    back = R.c2r_plain(got, n=n, layout="numpy", scale=1.0 / L, exact=True)
    assert back.dtype == torch.float32
    want = np.fft.irfft(got.numpy().astype(np.complex128), n)
    assert max_abs_err(back.numpy(), want) <= np.spacing(
        np.float32(np.abs(want).max()))


@pytest.mark.parametrize("n", [256, 4096])
def test_planar_entry_points(rng, n):
    """rfft_planar / irfft_planar (the rfft_fused_planar /
    irfft_fused_planar counterparts): revblock by default, the raw scale,
    and the n >= 256 rule."""
    L = n // 2
    x = rand_real(rng, n)
    vr, vi = R.rfft_planar(torch.from_numpy(x))
    jr, ji = PR.rfft_fused_planar(jnp.asarray(x))
    assert max_abs_err(planar((vr, vi)), np.asarray(jr) + 1j * np.asarray(
        ji)) < 2 * tol(n)
    back = R.irfft_planar(vr, vi, n)
    assert max_abs_err(back.numpy(), x * L) < tol(n) * L
    with pytest.raises(ValueError, match="rfft_fused requires"):
        R.rfft_planar(torch.zeros(8, 128))
    with pytest.raises(ValueError, match="rfft_fused requires"):
        PR.rfft_fused_planar(jnp.zeros((8, 128), jnp.float32))
    with pytest.raises(ValueError, match="irfft_fused requires"):
        R.irfft_planar(torch.zeros(8, 64), torch.zeros(8, 64), 128)


@pytest.mark.parametrize("n", [64, 512])
@pytest.mark.parametrize("packed", [False, True])
def test_spec_models_match_jax(rng, n, packed):
    """The torch spec (models/real.py on models/stockham.py) against the
    JAX package's spec, and both layout converters."""
    x = rand_real(rng, n)
    got = TRM.rfft_spec(torch.from_numpy(x), packed=packed).numpy()
    ref = np.asarray(JRM.rfft_spec(jnp.asarray(x), packed=packed))
    assert max_abs_err(got, ref) < 2 * tol(n)
    spec = got.astype(np.complex64)
    back = TRM.irfft_spec(torch.from_numpy(spec), n, packed=packed).numpy()
    jback = np.asarray(JRM.irfft_spec(jnp.asarray(spec), n, packed=packed))
    assert max_abs_err(back, jback) < 2 * tol(n) * n
    assert max_abs_err(back / (n // 2), x) < tol(n)
    norm = TRM.irfft_spec(torch.from_numpy(spec), n, packed=packed,
                          normalize=True).numpy()
    assert max_abs_err(norm, x) < tol(n)
    if packed:
        full = TRM.packed_to_numpy_layout(torch.from_numpy(spec)).numpy()
        assert np.array_equal(full, np.asarray(JRM.packed_to_numpy_layout(
            jnp.asarray(spec))))
        again = TRM.numpy_to_packed_layout(torch.from_numpy(full)).numpy()
        assert np.array_equal(again, spec)
        assert np.array_equal(again, np.asarray(JRM.numpy_to_packed_layout(
            jnp.asarray(full))))
    z = TRM.pack_real(torch.from_numpy(x)).numpy()
    assert np.array_equal(z, np.asarray(JRM.pack_real(jnp.asarray(x))))


def test_plain_version_never_calls_torch_fft(rng, monkeypatch):
    """torch.fft is the oracle, never the implementation."""
    def boom(*a, **k):
        raise AssertionError("torch.fft called")
    for name in ("fft", "ifft", "rfft", "irfft"):
        monkeypatch.setattr(torch.fft, name, boom)
    x = torch.from_numpy(rand_real(rng, 1024))
    for layout in R.LAYOUTS:
        got = R.r2c_plain(x, layout)
        args = got if isinstance(got, tuple) else (got,)
        R.c2r_plain(*args, n=1024, layout=layout)


def test_cpu_tensor_never_reaches_kernels(rng, monkeypatch):
    """CPU tensors run the plain versions: no build, no launch, through
    every real entry point."""
    from smfft_tpu_torch.ops import _cuda

    def boom(*a, **k):
        raise AssertionError("a kernel was requested for a CPU tensor")
    monkeypatch.setattr(_cuda, "library", boom)
    monkeypatch.setattr(R, "launch_r2c", boom)
    monkeypatch.setattr(R, "launch_c2r", boom)
    x = torch.from_numpy(rand_real(rng, 512))
    y = T.rfft(x)
    T.irfft(y)
    T.irfft(T.fft_packed_real(x), packed=True)
    T.planar.irfft(*T.planar.rfft(x, ordered=False), in_natural=False)
    R.irfft_rows(*R.rfft_rows(x, "planar"), n=512, layout="planar")


def test_launchers_refuse_what_they_cannot_take():
    """The wrappers check device, dtype, shape and layout before they ask
    for the kernel library, so these refusals show on the CPU too."""
    x = torch.zeros(4, 256)
    with pytest.raises(ValueError, match="CUDA tensor"):
        R.launch_r2c(x)
    with pytest.raises(ValueError, match="wrong FFT length"):
        R.launch_r2c(torch.zeros(4, 96))
    with pytest.raises(ValueError, match="unknown layout"):
        R.launch_r2c(x, "interleaved")
    with pytest.raises(ValueError, match="CUDA tensor"):
        R.launch_c2r(torch.zeros(4, 128), torch.zeros(4, 128), n=256)
    with pytest.raises(ValueError, match="wrong FFT length"):
        R.launch_c2r(torch.zeros(4, 24), torch.zeros(4, 24), n=48)
    with pytest.raises(ValueError, match="CUDA tensor"):
        R.launch_c2r(torch.zeros(4, 129, dtype=torch.complex64), n=256,
                     layout="numpy")


@pytest.mark.parametrize("n,pack", [(64, 4), (128, 2)])
def test_small_n_batch_rule(n, pack):
    """At n = 64 / 128 the JAX package's half-size transform packs 128/L
    rows: the same batches are refused by both packages."""
    with pytest.raises(ValueError, match=f"multiple of {pack}"):
        T.rfft(torch.zeros(3, n))
    with pytest.raises(ValueError, match=f"multiple of {pack}"):
        smfft_tpu.rfft(jnp.zeros((3, n), jnp.float32), backend="pallas")
    with pytest.raises(ValueError, match=f"multiple of {pack}"):
        T.irfft(torch.zeros(3, n // 2 + 1, dtype=torch.complex64))
    with pytest.raises(ValueError, match=f"multiple of {pack}"):
        smfft_tpu.irfft(jnp.zeros((3, n // 2 + 1), jnp.complex64),
                        backend="pallas")
    assert T.rfft(torch.zeros(pack, n)).shape == (pack, n // 2 + 1)
