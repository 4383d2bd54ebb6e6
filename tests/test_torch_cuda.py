"""The Hopper C2C kernel on the card: against its plain PyTorch version and
the float64 ``torch.fft`` oracle, plus the wrapper's input checks.

Every test here needs an NVIDIA GPU and nvcc; without them each skips (the
decision is taken inside the fixture, never at import).  On the GPU
machine run:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which this file
does not use.)
"""

import numpy as np
import pytest
import torch

from smfft_tpu_torch import api, planar
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def bound(n):
    """The fp32 error bound the TPU kernels met on their chip."""
    return 2e-7 * n ** 0.75 * 8


def rand_c(b, n, dev, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random((b, n)) - 0.5 + 1j * (rng.random((b, n)) - 0.5))
    return torch.from_numpy(x.astype(np.complex64)).to(dev)


def to_revblock(x):
    b, n = x.shape
    c = max(1, n // 128)
    return x if c == 1 else x.reshape(b, 128, c).transpose(1, 2).reshape(b, n)


def oracle(x, inverse):
    x64 = x.to(torch.complex128)
    return torch.fft.ifft(x64) * x.shape[-1] if inverse else torch.fft.fft(x64)


@pytest.mark.parametrize("n", SUPPORTED_C2C_SIZES)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("mode", ["ordered", "rev_out", "rev_in", "rev_both"])
def test_kernel_matches_plain_and_oracle(dev, n, inverse, mode):
    rev_in, rev_out = mode in ("rev_in", "rev_both"), mode in ("rev_out",
                                                                 "rev_both")
    b = 37 if n >= 128 else 132  # ragged against every per-block count
    x = rand_c(b, n, dev, seed=n)
    xin = to_revblock(x) if rev_in else x
    want = oracle(x, inverse)
    want = to_revblock(want) if rev_out else want
    pr, pi = C.c2c_plain(xin.real, xin.imag, inverse=inverse, rev_in=rev_in,
                         rev_out=rev_out, scale=0.5)
    got_c = C.launch(xin.contiguous(), inverse=inverse, rev_in=rev_in,
                     rev_out=rev_out, scale=0.5)
    gr, gi = C.launch(xin.real.contiguous(), xin.imag.contiguous(),
                      inverse=inverse, rev_in=rev_in, rev_out=rev_out,
                      scale=0.5)
    torch.cuda.synchronize()
    for got in (got_c, torch.complex(gr, gi)):
        assert (got - torch.complex(pr, pi)).abs().max().item() < bound(n)
        assert (got.to(torch.complex128) - 0.5 * want).abs().max().item() \
            < bound(n)


def test_api_goes_through_kernel(dev):
    x = rand_c(64, 1024, dev)
    before = C.launch.count
    y = api.fft(x)
    o_r, o_i = planar.ifft(x.real.contiguous(), x.imag.contiguous())
    back = api.ifft_unordered(api.fft(x, ordered=False))
    assert C.launch.count == before + 4
    assert (y.to(torch.complex128) - oracle(x, False)).abs().max() < bound(1024)
    want = oracle(x, True) / 1024
    assert (torch.complex(o_r, o_i) - want).abs().max() < bound(1024)
    assert (back - x).abs().max() < bound(1024)


def test_autograd_on_card(dev):
    x = rand_c(8, 256, dev).requires_grad_(True)
    g = rand_c(8, 256, dev, seed=1)
    (api.fft(x) * g.conj()).real.sum().backward()
    xr = x.detach().clone().requires_grad_(True)
    (torch.fft.fft(xr) * g.conj()).real.sum().backward()
    assert (x.grad - xr.grad).abs().max() < bound(256)


def test_wrapper_rejects_what_it_cannot_take(dev):
    x = rand_c(4, 256, dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        C.launch(x.cpu())
    with pytest.raises(TypeError, match="complex64"):
        C.launch(x.to(torch.complex128))
    with pytest.raises(ValueError, match="contiguous"):
        C.launch(x.t().contiguous().t())
    with pytest.raises(ValueError, match="wrong FFT length"):
        C.launch(rand_c(4, 96, dev))
    with pytest.raises(ValueError, match="planar pair"):
        C.launch(x.real.contiguous(), x.imag[:2].contiguous())


def test_offsets_past_2_31_points(dev):
    """Planar planes of more than 2^31 points (8.6 GB each): the rows at
    the end are only reachable with 64-bit offsets."""
    n = 16384
    b = (1 << 31) // n + 8
    xr = torch.zeros((b, n), device=dev)
    xi = torch.zeros((b, n), device=dev)
    tail = rand_c(8, n, dev, seed=3)
    xr[-8:], xi[-8:] = tail.real, tail.imag
    o_r, o_i = C.launch(xr, xi)
    torch.cuda.synchronize()
    got = torch.complex(o_r[-8:], o_i[-8:])
    assert (got.to(torch.complex128) - oracle(tail, False)).abs().max() \
        < bound(n)
    assert o_r[:8].abs().max().item() == 0.0


def test_launches_on_current_stream(dev):
    x = rand_c(64, 512, dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = api.fft(x)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert (y.to(torch.complex128) - oracle(x, False)).abs().max() < bound(512)
