"""DCT / DST of smfft_tpu_torch (``dct.py``, types 1-4, both norms, and
the N-D forms) on CPU tensors, against ``smfft_tpu.dct`` and float64
scipy.fft.

The same numpy-seeded inputs go through the JAX module with
``backend="xla"`` (one call per function, type, size and norm, cached for
the module) and through the port's plain versions.  Tolerances: 1e-4 *
max|ref| against the JAX package; against scipy in float64, bound(m) *
max|ref| with bound(m) = 2e-7 * m^0.75 * 8 and m the length of the pass's
kernel: n for types 2 and 3, 2(n - 1) for DCT-I, 2(n + 1) for DST-I, 2n
for type 4; summed over the axes of an N-D transform.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft
import torch

import smfft_tpu_torch as T

JD = importlib.import_module("smfft_tpu.dct")
TD = importlib.import_module("smfft_tpu_torch.dct")

FUNCS = ("dct", "idct", "dst", "idst")
# (type, n) for each function family: DCT-I takes n = 2^m + 1, DST-I
# n = 2^m - 1, type 4 n down to 16 (a length-2n C2C pass)
SIZES = {
    "dct": [(1, 33), (1, 129), (2, 64), (2, 256), (3, 64), (3, 256), (4, 16),
            (4, 64)],
    "dst": [(1, 31), (1, 127), (2, 64), (2, 256), (3, 64), (3, 256), (4, 16),
            (4, 64)],
}
CASES = [(f, t, n, norm) for f in FUNCS for t, n in SIZES[f.lstrip("i")]
         for norm in (None, "ortho")]


def bound(m):
    return 2e-7 * m ** 0.75 * 8


def kernel_length(family, t, n):
    if t == 1:
        return 2 * (n - 1) if family == "dct" else 2 * (n + 1)
    return 2 * n if t == 4 else n


@functools.lru_cache(maxsize=None)
def data(shape, seed=0):
    rng = np.random.default_rng(seed + sum(shape))
    return (rng.random(shape) - 0.5).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_ref(name, shape, **kw):
    return np.asarray(getattr(JD, name)(jnp.asarray(data(shape)),
                                        backend="xla", **kw))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("name,t,n,norm", CASES)
def test_matches_jax_and_scipy(name, t, n, norm):
    x = data((4, n))
    got = getattr(T, name)(torch.from_numpy(x), type=t, norm=norm).numpy()
    ref = jax_ref(name, (4, n), type=t, norm=norm)
    want = getattr(scipy.fft, name)(x.astype(np.float64), type=t, norm=norm)
    assert got.shape == ref.shape == want.shape == (4, n)
    assert got.dtype == np.float32
    assert rel(got, ref) <= 1e-4
    assert rel(got, want) <= bound(kernel_length(name.lstrip("i"), t, n))


@pytest.mark.parametrize("family", ["dct", "dst"])
@pytest.mark.parametrize("t", [1, 2, 3, 4])
@pytest.mark.parametrize("norm", [None, "ortho"])
def test_round_trip(family, t, norm):
    """idct(dct(x, type=t, norm=m), type=t, norm=m) == x (and for the
    DST), scipy.fft's contract."""
    n = dict(SIZES[family])[t]      # the larger size of each type
    x = torch.from_numpy(data((4, n), seed=1))
    fwd, inv = getattr(T, family), getattr(T, "i" + family)
    back = inv(fwd(x, type=t, norm=norm), type=t, norm=norm)
    assert rel(back, x) <= 2 * bound(kernel_length(family, t, n))


@pytest.mark.parametrize("name", ["dctn", "idctn", "dstn", "idstn"])
@pytest.mark.parametrize("axes", [None, (-2, -1), 0])
@pytest.mark.parametrize("norm", [None, "ortho"])
def test_nd_matches_jax_and_scipy(name, axes, norm):
    shape = (64, 256)
    x = data(shape)
    got = getattr(T, name)(torch.from_numpy(x), axes=axes, norm=norm).numpy()
    ref = jax_ref(name, shape, axes=axes, norm=norm)
    want = getattr(scipy.fft, name)(x.astype(np.float64), axes=axes,
                                    norm=norm)
    assert rel(got, ref) <= 1e-4
    ax = (0, 1) if axes in (None, (-2, -1)) else (axes,)
    assert rel(got, want) <= sum(bound(shape[a]) for a in ax)


def test_nd_type_4_over_a_middle_axis():
    x = data((4, 32, 64))
    got = T.dctn(torch.from_numpy(x), type=4, axes=1).numpy()
    want = scipy.fft.dctn(x.astype(np.float64), type=4, axes=1)
    assert rel(got, want) <= bound(64)


# ---------------------------------------------------------------------------
# Error texts (the JAX package's, word for word) and the packing rule.
# ---------------------------------------------------------------------------


ERRORS = {
    "dct_type2_n": lambda m, x: m.dct(x[:, :100]),
    "dst_type3_n": lambda m, x: m.dst(x[:, :48], type=3),
    "dct1_n": lambda m, x: m.dct(x[:, :32], type=1),
    "dst1_n": lambda m, x: m.idst(x[:, :33], type=1),
    "dct4_n": lambda m, x: m.idct(x[:, :24], type=4),
    "dct4_too_long": lambda m, x: m.dct(x[:, :16384], type=4),
    "dct_type": lambda m, x: m.dct(x[:, :64], type=5),
    "idct_type": lambda m, x: m.idct(x[:, :64], type=0),
    "dst_type": lambda m, x: m.dst(x[:, :64], type=7),
    "idst_type": lambda m, x: m.idst(x[:, :64], type=-1),
    "dctn_repeated_axis": lambda m, x: m.dctn(x[:, :64], axes=(0, -2)),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_error_texts_match_jax(case):
    x = data((4, 16384))
    with pytest.raises(ValueError) as jax_err:
        ERRORS[case](JD, jnp.asarray(x))
    with pytest.raises(ValueError) as port_err:
        ERRORS[case](TD, torch.from_numpy(x))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("fn", [
    lambda x: T.dct(x[:, :16], type=4), lambda x: T.dst(x[:, :16], type=4),
    lambda x: T.dct(x[:, :33], type=1), lambda x: T.idst(x[:, :31], type=1),
    lambda x: T.dct(x[:, :64], type=2)])
def test_packing_rule_raises_as_the_pallas_path_does(fn):
    """DCT-IV at n = 16 (a 32-point C2C) and type 1 / 2 on a 64-point
    real transform pack 4 transforms a row: a batch of 3 raises."""
    with pytest.raises(ValueError, match="multiple of 4"):
        fn(torch.from_numpy(data((3, 64))))


# ---------------------------------------------------------------------------
# Gradients, real-input promotion and the device tables.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [2, 3])
def test_gradcheck_dct(t):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.random((4, 64))).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a: T.dct(a, type=t), (x,),
                                    fast_mode=True)


def test_float64_input_stays_float64():
    x = data((4, 256)).astype(np.float64)
    got = T.dct(torch.from_numpy(x))
    assert got.dtype == torch.float64
    assert rel(got.numpy(), scipy.fft.dct(x)) <= 1e-12


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.bool_,
                                   np.float16])
@pytest.mark.parametrize("t", [1, 2, 3, 4])
def test_promotes_real_inputs_as_jax_does(dtype, t):
    n = {1: 33, 2: 256, 3: 256, 4: 64}[t]
    rng = np.random.default_rng(9)
    x = (rng.random((4, n)) * 20 - 10).astype(dtype)
    got = T.dct(torch.from_numpy(x), type=t)
    ref = np.asarray(JD.dct(jnp.asarray(x), type=t, backend="xla"))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert rel(got.numpy(), ref) <= 1e-4


def test_tables_are_made_once_per_size_and_device():
    x = torch.from_numpy(data((4, 512)))
    TD.dct(x)
    before = TD._device_rows.cache_info()
    TD.dct(x)
    TD.idct(x)
    after = TD._device_rows.cache_info()
    assert after.misses == before.misses
    c, s = TD._rows(TD._twiddles, 512, x)
    assert c.dtype == torch.float32 and c.shape == (257,)
    want = np.cos(np.pi * np.arange(257) / 1024.0).astype(np.float32)
    np.testing.assert_array_equal(c.numpy(), want)
