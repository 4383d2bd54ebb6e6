"""Plan layer of smfft_tpu_torch against smfft_tpu: size tables, plan
fields, the "Error wrong FFT length!" contract, the plan round trip and
bit-identical twiddle tables."""

import dataclasses

import numpy as np
import pytest
import torch

import smfft_tpu
import smfft_tpu.ops.pallas_c2c as PC
from smfft_tpu import params as JP

import smfft_tpu_torch as T
from smfft_tpu_torch import params as TP
from smfft_tpu_torch.ops import c2c as C


def test_size_tables_equal():
    assert TP.SUPPORTED_C2C_SIZES == JP.SUPPORTED_C2C_SIZES
    assert TP.SUPPORTED_REAL_SIZES == JP.SUPPORTED_REAL_SIZES
    assert T.SUPPORTED_C2C_SIZES == smfft_tpu.SUPPORTED_C2C_SIZES


@pytest.mark.parametrize("kind", ["c2c", "r2c", "c2r"])
def test_plan_fields_equal(kind):
    sizes = (TP.SUPPORTED_C2C_SIZES if kind == "c2c"
             else TP.SUPPORTED_REAL_SIZES)
    for n in sizes:
        for direction in ("forward", "inverse"):
            for ordered in (True, False):
                tp = TP.plan_for(n, direction, kind, ordered)
                jp = JP.plan_for(n, direction, kind, ordered)
                assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
                assert (tp.exp, tp.core_n, tp.sign) == (jp.exp, jp.core_n,
                                                        jp.sign)


@pytest.mark.parametrize("n", [16, 96, 32768])
def test_wrong_length_raises(n):
    with pytest.raises(ValueError, match="Error wrong FFT length!"):
        TP.FFTParams(n=n)
    with pytest.raises(ValueError, match="Error wrong FFT length!"):
        T.fft(torch.zeros((4, n), dtype=torch.complex64))
    with pytest.raises(ValueError, match="Error wrong FFT length!"):
        T.planar.fft(torch.zeros((4, n)), torch.zeros((4, n)))


@pytest.mark.parametrize("n", TP.SUPPORTED_C2C_SIZES)
def test_plan_from_jax_round_trip(n):
    for direction in ("forward", "inverse"):
        jp = smfft_tpu.plan_for(n, direction, "c2c", False)
        tp = TP.plan_from_jax(dataclasses.asdict(jp))
        assert tp == TP.plan_for(n, direction, "c2c", False)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


def test_plan_from_jax_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown plan fields"):
        TP.plan_from_jax({"n": 256, "tile": 8})


@pytest.mark.parametrize("n", TP.SUPPORTED_C2C_SIZES)
@pytest.mark.parametrize("inverse", [False, True])
def test_tables_bit_identical(n, inverse):
    """The port's tables, built from a plan carried over from JAX, are the
    same fp32 bits as pallas_c2c._tables."""
    jp = smfft_tpu.plan_for(n, "inverse" if inverse else "forward")
    tp = TP.plan_from_jax(dataclasses.asdict(jp))
    mine = C.tables(tp.core_n, tp.direction == "inverse")
    ref = PC._tables(n, inverse)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a.dtype == np.float32 and a.shape == b.shape
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("n", [32, 1024, 16384])
def test_kernel_twiddle_table(n):
    """The kernel's W_N^m table: fp32 rounding of the float64 values, and
    its rows k2 * n1 agree with the (C, 128) twiddle table."""
    tab = TP.twiddle_table(n, False)
    ang = -2.0 * np.pi * np.arange(n) / n
    assert tab.dtype == np.float32 and tab.shape == (n, 2)
    assert np.array_equal(tab[:, 0], np.cos(ang).astype(np.float32))
    assert np.array_equal(tab[:, 1], np.sin(ang).astype(np.float32))
    inv = TP.twiddle_table(n, True)
    assert np.array_equal(inv[:, 0], tab[:, 0])
    assert np.array_equal(inv[:, 1], -tab[:, 1])
    if n >= 256:
        _, _, t_re, t_im, _, _ = C.tables(n, False)
        m = (np.arange(n // 128)[:, None] * np.arange(128)[None, :]) % n
        np.testing.assert_allclose(tab[m, 0], t_re, atol=1e-6)
        np.testing.assert_allclose(tab[m, 1], t_im, atol=1e-6)
