"""Faults of the JAX package that the port does not share, pinned: the JAX
call shows the fault, the port's call on the same numpy input is right.
The JAX package is not changed.

* "exact" on the JAX package's plain backend: ``smfft_tpu.fft(x,
  precision="exact", backend="xla")`` raises ``KeyError`` (its matmul
  tiers list no "exact"); the port's "exact" tier is within 2 ulp of
  max|X| of float64 numpy.
* The JAX inverses read every ``norm`` but "backward" as the raw inverse:
  ``smfft_tpu.ifft(y, norm="ortho")`` equals ``norm=None``.  The port
  raises ``ValueError`` instead, which
  ``tests/test_torch_api.py::test_bad_arguments_raise`` (``ifft``) and
  ``test_real_size_errors`` (``irfft``) pin; this file pins the JAX side,
  for ``ifft`` and for the N-D inverse ``ifft2``, whose port raises too.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smfft_tpu

import smfft_tpu_torch as T


def ulp(v):
    return 2.0 ** (np.floor(np.log2(v)) - 23)


@pytest.fixture
def x(rng):
    return (rng.random((2, 1024)) - 0.5
            + 1j * (rng.random((2, 1024)) - 0.5)).astype(np.complex64)


def test_exact_tier_fails_on_jax_xla_backend_port_does_not(x):
    with pytest.raises(KeyError, match="exact"):
        smfft_tpu.fft(jnp.asarray(x), precision="exact", backend="xla")
    got = T.fft(torch.from_numpy(x), precision="exact").numpy()
    want = np.fft.fft(x.astype(np.complex128))
    assert np.abs(got - want).max() <= 2 * ulp(np.abs(want).max())


def test_jax_ifft_ortho_is_the_raw_inverse(x):
    y = jnp.asarray(x)
    ortho = np.asarray(smfft_tpu.ifft(y, norm="ortho", backend="xla"))
    raw = np.asarray(smfft_tpu.ifft(y, norm=None, backend="xla"))
    np.testing.assert_array_equal(ortho, raw)
    numpy_ortho = np.fft.ifft(x.astype(np.complex128), norm="ortho")
    assert np.abs(ortho - numpy_ortho).max() > 1.0


def test_jax_ifft2_ortho_is_the_raw_inverse_port_raises():
    """smfft_tpu.ndim.ifft2(norm="ortho") returns the raw inverse: at (3,
    64, 128) its max is sqrt(64 * 128) ~ 90.51 times numpy's ortho result.
    The port's ifft2 / ifftn / irfft2 raise on "ortho" instead."""
    jn = importlib.import_module("smfft_tpu.ndim")
    rng = np.random.default_rng(3)
    x = (rng.random((3, 64, 128)) - 0.5
         + 1j * (rng.random((3, 64, 128)) - 0.5)).astype(np.complex64)
    ortho = np.asarray(jn.ifft2(jnp.asarray(x), norm="ortho",
                                backend="xla"))
    numpy_ortho = np.fft.ifft2(x.astype(np.complex128), norm="ortho")
    ratio = np.abs(ortho).max() / np.abs(numpy_ortho).max()
    assert abs(ratio - np.sqrt(64 * 128)) <= 1e-4 * np.sqrt(64 * 128)
    raw = np.fft.ifft2(x.astype(np.complex128)) * (64 * 128)
    assert np.abs(ortho - raw).max() <= 1e-4 * np.abs(raw).max()
    t = torch.from_numpy(x)
    for fn in (T.ifft2, T.ifftn, T.irfft2):
        with pytest.raises(ValueError, match="norm must be"):
            fn(t[..., :65] if fn is T.irfft2 else t, norm="ortho")
