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
  ``test_real_size_errors`` (``irfft``) pin; this file pins the JAX side.
"""

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
