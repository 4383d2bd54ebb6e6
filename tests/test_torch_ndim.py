"""N-D transforms and spectral helpers of smfft_tpu_torch (``ndim.py``)
on CPU tensors, against ``smfft_tpu.ndim`` and float64 numpy.

The same numpy-seeded inputs go through the JAX module with
``backend="xla"`` (one call per shape and function, cached for the
module: each call compiles for about half a second) and through the
port's plain versions, parametrised on the port's side.  Tolerances:
1e-4 * max|ref| against the JAX package; against float64 numpy the
summed bound of the passes, sum over the transformed axes of bound(m) =
2e-7 * m^0.75 * 8 (m the axis length), times max|ref|.  The revblock
form ``fftn(ordered=False)`` is held against the JAX package's pallas
backend in interpret mode, whose layout the port follows.
"""

import ast
import functools
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smfft_tpu.ops.pallas_c2c as PC

import smfft_tpu_torch as T

JN = importlib.import_module("smfft_tpu.ndim")
ROOT = Path(__file__).resolve().parent.parent

# complex (3, 64, 128) for 2-D and single-axis passes, (32, 32, 64) for a
# transform over every axis; real (4, 64, 256) and (2, 32, 64, 128)
C2 = (3, 64, 128)
C3 = (32, 32, 64)
R2 = (4, 64, 256)
R3 = (2, 32, 64, 128)
HALF = (4, 129)          # hfft input: n = 256 by default


def bound(m):
    return 2e-7 * m ** 0.75 * 8


def summed_bound(shape, axes):
    return sum(bound(shape[a]) for a in axes)


@functools.lru_cache(maxsize=None)
def data(shape, kind, seed=0):
    rng = np.random.default_rng(seed + len(shape) * 100 + shape[-1])
    x = rng.random(shape) - 0.5
    if kind == "complex":
        x = x + 1j * (rng.random(shape) - 0.5)
        return x.astype(np.complex64)
    return x.astype(np.float32)


@functools.lru_cache(maxsize=None)
def spectrum(shape, axes):
    """The complex64 half spectrum of data(shape, "real") over axes
    (default: the last two, irfft2's)."""
    x = data(shape, "real").astype(np.float64)
    return np.fft.rfftn(x, axes=(-2, -1) if axes is None else axes).astype(
        np.complex64)


@functools.lru_cache(maxsize=None)
def jax_ref(name, shape, kind, **kw):
    """The JAX module's function on data(shape, kind) (for the C2R
    inverses: on spectrum(shape, axes)), backend="xla"."""
    if name.startswith("irfft"):
        x = spectrum(shape, kw.get("axes"))
    else:
        x = data(shape, kind)
    return np.asarray(getattr(JN, name)(jnp.asarray(x), backend="xla", **kw))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a.astype(np.complex128) - b).max() / np.abs(b).max())


# (name, shape, kind, kw, numpy oracle, axes of the summed bound)
CASES = {
    "fft2": ("fft2", C2, "complex", {},
             lambda x: np.fft.fft2(x), (1, 2)),
    "ifft2": ("ifft2", C2, "complex", {},
              lambda x: np.fft.ifft2(x), (1, 2)),
    "ifft2_raw": ("ifft2", C2, "complex", {"norm": None},
                  lambda x: np.fft.ifft2(x) * 64 * 128, (1, 2)),
    "fftn_all": ("fftn", C3, "complex", {},
                 lambda x: np.fft.fftn(x), (0, 1, 2)),
    "fftn_mid": ("fftn", C2, "complex", {"axes": 1},
                 lambda x: np.fft.fftn(x, axes=(1,)), (1,)),
    "fftn_first_last": ("fftn", C3, "complex", {"axes": (-1, 0)},
                        lambda x: np.fft.fftn(x, axes=(-1, 0)), (0, 2)),
    "ifftn_all": ("ifftn", C3, "complex", {},
                  lambda x: np.fft.ifftn(x), (0, 1, 2)),
    "ifftn_mid": ("ifftn", C2, "complex", {"axes": (1,)},
                  lambda x: np.fft.ifftn(x, axes=(1,)), (1,)),
    "rfft2": ("rfft2", R2, "real", {},
              lambda x: np.fft.rfft2(x), (1, 2)),
    "rfft2_outer": ("rfft2", R3, "real", {"axes": (1, 3)},
                    lambda x: np.fft.rfft2(x, axes=(1, 3)), (1, 3)),
    "rfftn": ("rfftn", R3, "real", {"axes": (1, 2, 3)},
              lambda x: np.fft.rfftn(x, axes=(1, 2, 3)), (1, 2, 3)),
    "rfftn_last2": ("rfftn", R3, "real", {"axes": (-2, -1)},
                    lambda x: np.fft.rfftn(x, axes=(-2, -1)), (2, 3)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_c2c_and_r2c_match_jax_and_numpy(case):
    name, shape, kind, kw, oracle, axes = CASES[case]
    x = data(shape, kind)
    got = getattr(T, name)(torch.from_numpy(x), **kw).numpy()
    ref = jax_ref(name, shape, kind, **kw)
    want = oracle(x.astype(np.complex128 if kind == "complex"
                           else np.float64))
    assert got.shape == ref.shape == want.shape
    assert got.dtype == np.complex64
    assert rel(got, ref) <= 1e-4
    ax = axes or tuple(range(len(shape)))
    assert rel(got, want) <= summed_bound(shape, ax)


@pytest.mark.parametrize("name,shape,axes", [
    ("irfft2", R2, None), ("irfftn", R3, (1, 2, 3)),
    ("irfftn", R3, (-2, -1)), ("irfft2", R3, (1, 3))])
def test_c2r_matches_jax_and_numpy(name, shape, axes):
    """irfft2 / irfftn of rfftn's output: the C2C inverse over the leading
    axes and the C2R kernel over the last, with numpy's normalization."""
    x = data(shape, "real")
    kw = {} if axes is None else {"axes": axes}
    spec = spectrum(shape, axes)
    got = getattr(T, name)(torch.from_numpy(spec), **kw).numpy()
    ref = jax_ref(name, shape, "real", **kw)
    ax = axes if axes is not None else (len(shape) - 2, len(shape) - 1)
    want = getattr(np.fft, name)(spec.astype(np.complex128), axes=ax,
                                 s=[shape[a] for a in ax])
    assert got.shape == ref.shape == want.shape == shape
    assert got.dtype == np.float32
    assert rel(got, ref) <= 1e-4
    assert rel(got, want) <= summed_bound(shape, ax)
    assert rel(got, x) <= summed_bound(shape, ax) * 2


def test_c2c_round_trips():
    x = torch.from_numpy(data(C3, "complex"))
    for fwd, inv in ((T.fft2, T.ifft2), (T.fftn, T.ifftn)):
        assert rel(inv(fwd(x)), x.numpy()) <= 2 * summed_bound(C3, (0, 1, 2))


@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
@pytest.mark.parametrize("n", [None, 128, 512])
def test_hfft_matches_jax_and_numpy(norm, n):
    """hfft on the C2R kernel (conj, raw C2R, 2 * scale): n pads or
    truncates the half-spectrum to n/2 + 1 bins."""
    x = data(HALF, "complex")
    got = T.hfft(torch.from_numpy(x), n=n, norm=norm).numpy()
    ref = jax_ref("hfft", HALF, "complex", n=n, norm=norm)
    want = np.fft.hfft(x.astype(np.complex128), n=n, norm=norm)
    m = n or 256
    assert got.shape == ref.shape == want.shape == (4, m)
    assert got.dtype == np.float32
    assert rel(got, ref) <= 1e-4
    assert rel(got, want) <= bound(m)


@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
@pytest.mark.parametrize("n", [None, 128, 512])
def test_ihfft_matches_jax_and_numpy(norm, n):
    x = data((4, 256), "real")
    got = T.ihfft(torch.from_numpy(x), n=n, norm=norm).numpy()
    ref = jax_ref("ihfft", (4, 256), "real", n=n, norm=norm)
    want = np.fft.ihfft(x.astype(np.float64), n=n, norm=norm)
    m = n or 256
    assert got.shape == ref.shape == want.shape == (4, m // 2 + 1)
    assert got.dtype == np.complex64
    assert rel(got, ref) <= 1e-4
    assert rel(got, want) <= bound(m)


def test_unordered_fftn_is_the_pallas_revblock_layout():
    """fftn(ordered=False) over one axis at N = 256 equals the JAX
    package's pallas output (interpret mode): revblock, which the port
    follows (its xla backend is digit-reversed instead)."""
    x = data((4, 256), "complex")
    PC.set_interpret(True)
    try:
        ref = np.asarray(JN.fftn(jnp.asarray(x), axes=-1, ordered=False,
                                 backend="pallas"))
    finally:
        PC.set_interpret(False)
    got = T.fftn(torch.from_numpy(x), axes=-1, ordered=False).numpy()
    assert rel(got, ref) <= 1e-4
    assert rel(got, np.fft.fft(x.astype(np.complex128))) > 0.1


@pytest.mark.parametrize("shape,axes", [
    ((5,), None), ((7, 4), None), ((4, 9), 1), ((5, 7, 3), (0, 2)),
    ((6, 5), -1), ((3, 8), (-2,))])
@pytest.mark.parametrize("which", ["fftshift", "ifftshift"])
def test_shifts_match_numpy_at_any_length(shape, axes, which):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    got = getattr(T, which)(torch.from_numpy(x), axes=axes).numpy()
    np.testing.assert_array_equal(got, getattr(np.fft, which)(x, axes=axes))
    np.testing.assert_array_equal(
        got, np.asarray(getattr(JN, which)(jnp.asarray(x), axes=axes)))


def test_shifts_undo_each_other_on_complex_rows():
    x = torch.from_numpy(data((3, 5, 7), "complex"))
    assert torch.equal(T.ifftshift(T.fftshift(x)), x)


@pytest.mark.parametrize("n,d", [(8, 1.0), (9, 0.1), (1024, 1 / 48000)])
@pytest.mark.parametrize("which", ["fftfreq", "rfftfreq"])
def test_frequencies_match_jax(n, d, which):
    got = getattr(T, which)(n, d)
    ref = np.asarray(getattr(JN, which)(n, d))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# Error texts: the port raises what the JAX package raises, word for word.
# ---------------------------------------------------------------------------


ERRORS = {
    "repeated_axis": lambda m, x: m.fftn(x, axes=(1, -2)),
    "unordered_two_axes": lambda m, x: m.fftn(x, axes=(1, 2),
                                               ordered=False),
    "rfft2_last_axis": lambda m, x: m.rfft2(x.real, axes=(2, 1)),
    "rfftn_last_axis": lambda m, x: m.rfftn(x.real, axes=(0, 1)),
    "irfftn_last_axis": lambda m, x: m.irfftn(x, axes=(2, 0)),
    "irfft2_last_axis": lambda m, x: m.irfft2(x, axes=(0, 1)),
    "hfft_norm": lambda m, x: m.hfft(x, norm="sideways"),
    "ihfft_norm": lambda m, x: m.ihfft(x.real, norm="sideways"),
    "fft2_size": lambda m, x: m.fft2(x[:, :, :100]),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_error_texts_match_jax(case):
    x = data(C2, "complex")
    with pytest.raises(ValueError) as jax_err:
        ERRORS[case](JN, jnp.asarray(x))
    with pytest.raises(ValueError) as port_err:
        ERRORS[case](T, torch.from_numpy(x))
    assert str(port_err.value).split(";")[0] == \
        str(jax_err.value).split(";")[0]


def test_irfft2_with_a_length_that_does_not_fit_raises():
    spec = torch.from_numpy(data((4, 64, 129), "complex"))
    with pytest.raises(ValueError, match="n=512 takes 257 bins"):
        T.irfft2(spec, n=512)


def test_packing_rule_raises_as_the_pallas_path_does():
    """An axis of 32 C2C points, or of 64 real samples, packs 4
    transforms a row: a batch that is not a multiple of 4 raises."""
    with pytest.raises(ValueError, match="multiple of 4"):
        T.fftn(torch.from_numpy(data((3, 32), "complex")), axes=-1)
    with pytest.raises(ValueError, match="multiple of 4"):
        T.ihfft(torch.from_numpy(data((3, 64), "real")))


# ---------------------------------------------------------------------------
# Gradients and real-input promotion.
# ---------------------------------------------------------------------------


def test_gradcheck_fft2():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((4, 32, 32))
                         + 1j * rng.random((4, 32, 32))).requires_grad_(True)
    assert torch.autograd.gradcheck(T.fft2, (x,), fast_mode=True)


def test_gradcheck_rfft2():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((4, 64, 64))).requires_grad_(True)
    assert torch.autograd.gradcheck(T.rfft2, (x,), fast_mode=True)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.bool_,
                                   np.float16])
def test_rfft2_promotes_real_inputs_as_jax_does(dtype):
    rng = np.random.default_rng(7)
    x = (rng.random(R2) * 20 - 10).astype(dtype)
    got = T.rfft2(torch.from_numpy(x))
    ref = np.asarray(JN.rfft2(jnp.asarray(x), backend="xla"))
    assert got.dtype == torch.complex64 and ref.dtype == np.complex64
    assert rel(got.numpy(), ref) <= 1e-4


def all_names(package):
    """The string literals of ``__all__`` in a package's __init__.py, read
    by AST (no import)."""
    tree = ast.parse((ROOT / package / "__init__.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__"
                        for t in node.targets)):
            return {elt.value for elt in node.value.elts}
    raise AssertionError(f"{package}/__init__.py has no __all__")


def test_public_names_cover_the_jax_package():
    """smfft_tpu_torch.__all__ holds every name of smfft_tpu.__all__ (57),
    the 14 of ndim.py and the 8 of dct.py among them, and each is bound."""
    jax_names, port_names = all_names("smfft_tpu"), all_names(
        "smfft_tpu_torch")
    assert len(jax_names) == 57
    assert jax_names <= port_names, sorted(jax_names - port_names)
    assert port_names == set(T.__all__)
    assert all(hasattr(T, name) for name in port_names)
