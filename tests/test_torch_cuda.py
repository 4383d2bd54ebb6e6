"""The Hopper kernels on the card (C2C, R2C, C2R; fp32 and "exact"):
against their plain PyTorch versions and the float64 ``torch.fft``
oracle, plus the wrappers' input checks.

Every test here needs an NVIDIA GPU and nvcc; without them each skips (the
decision is taken inside the fixture, never at import).  On the GPU
machine run:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which this file
does not use.)
"""

import math

import numpy as np
import pytest
import torch

from smfft_tpu_torch import api, planar
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import real as R
from smfft_tpu_torch.params import SUPPORTED_C2C_SIZES, SUPPORTED_REAL_SIZES

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


def ulp(v):
    return 2.0 ** (math.floor(math.log2(v)) - 23)


@pytest.mark.parametrize("n", SUPPORTED_C2C_SIZES)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("mode", ["ordered", "rev_out", "rev_in", "rev_both"])
def test_exact_tier_within_2_ulp(dev, n, inverse, mode):
    """precision="exact": <= 2 ulp of max|X| from float64 torch.fft on 64
    rows, complex64 and planar, every size, direction and layout."""
    rev_in = mode in ("rev_in", "rev_both")
    rev_out = mode in ("rev_out", "rev_both")
    x = rand_c(64, n, dev, seed=n + 7)
    want = oracle(x, inverse)
    u = ulp(want.abs().max().item())
    want = to_revblock(want) if rev_out else want
    xin = to_revblock(x) if rev_in else x
    kw = dict(inverse=inverse, rev_in=rev_in, rev_out=rev_out, exact=True)
    got_c = C.launch(xin.contiguous(), **kw)
    gr, gi = C.launch(xin.real.contiguous(), xin.imag.contiguous(), **kw)
    torch.cuda.synchronize()
    for got in (got_c, torch.complex(gr, gi)):
        assert (got.to(torch.complex128) - want).abs().max().item() <= 2 * u


def rand_r(b, n, dev, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((b, n)) - 0.5).astype(
        np.float32)).to(dev)


def max_err(a, b):
    if isinstance(a, tuple):
        return max(max_err(u, v) for u, v in zip(a, b))
    return (a.to(torch.complex128) - b.to(torch.complex128)).abs().max().item()


@pytest.mark.parametrize("n", SUPPORTED_REAL_SIZES)
@pytest.mark.parametrize("layout", R.LAYOUTS)
@pytest.mark.parametrize("exact", [False, True])
def test_real_kernels_match_plain_and_oracle(dev, n, layout, exact):
    """Both real kernels in every layout against their plain versions, on
    a batch ragged against every rows-per-block count, and against float64
    torch.fft.rfft / irfft."""
    L = n // 2
    b = 4096 // L + 37 if L < 4096 else 37
    x = rand_r(b, n, dev, seed=n)
    got = R.launch_r2c(x, layout, exact)
    plain = R.r2c_plain(x, layout, exact)
    torch.cuda.synchronize()
    assert max_err(got, plain) < bound(n)
    pr, pi = R.from_layout(*(got if isinstance(got, tuple) else (got, None)),
                           layout, L)
    want = torch.fft.rfft(x.double())
    assert max_err(R.to_layout(pr, pi, "numpy"), want) < bound(n)
    # C2R at numpy's scale (1/L), so its output is x
    args = got if isinstance(got, tuple) else (got,)
    back = R.launch_c2r(*args, n=n, layout=layout, scale=1.0 / L,
                        exact=exact)
    plain_back = R.c2r_plain(*args, n=n, layout=layout, scale=1.0 / L,
                             exact=exact)
    torch.cuda.synchronize()
    assert max_err(back, plain_back) < bound(n)
    spec = R.to_layout(pr, pi, "numpy").to(torch.complex128)
    want_back = torch.fft.irfft(spec, n)
    assert max_err(back, want_back) < bound(n)
    if exact:
        assert max_err(R.to_layout(pr, pi, "numpy")[:64], want[:64]) \
            <= 2 * ulp(want[:64].abs().max().item())
        assert max_err(back[:64], want_back[:64]) \
            <= 2 * ulp(want_back[:64].abs().max().item())


def test_real_api_goes_through_kernels(dev):
    x = rand_r(64, 1024, dev)
    c0, r0, i0 = C.launch.count, R.launch_r2c.count, R.launch_c2r.count
    y = api.rfft(x)
    pk = api.fft_packed_real(x)
    hr, hi = planar.rfft(x)
    back = planar.irfft(hr, hi)
    ur, ui = planar.rfft(x, ordered=False)
    back2 = planar.irfft(ur, ui, in_natural=False)
    x2 = api.irfft(y)
    x3 = api.irfft(pk, packed=True)
    assert R.launch_r2c.count == r0 + 4
    assert R.launch_c2r.count == i0 + 4
    assert C.launch.count == c0
    want = torch.fft.rfft(x.double())
    assert max_err(y, want) < bound(1024)
    for z in (back, back2, x2, x3):
        assert (z - x).abs().max().item() < bound(1024)


@pytest.mark.parametrize("which", ["rfft", "irfft"])
def test_real_autograd_on_card(dev, which):
    if which == "rfft":
        x = rand_r(8, 256, dev).requires_grad_(True)
        g = rand_c(8, 129, dev, seed=1)
        fn, ref = api.rfft, torch.fft.rfft
    else:
        x = rand_c(8, 129, dev).requires_grad_(True)
        g = rand_r(8, 256, dev, seed=1)
        fn, ref = api.irfft, torch.fft.irfft
    (gx,) = torch.autograd.grad(fn(x), x, g)
    xr = x.detach().clone().requires_grad_(True)
    (gr,) = torch.autograd.grad(ref(xr), xr, g)
    assert (gx - gr).abs().max() < bound(256)


def test_real_launchers_refuse_what_they_cannot_take(dev):
    x = rand_r(4, 256, dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        R.launch_r2c(x.cpu())
    with pytest.raises(TypeError, match="float32"):
        R.launch_r2c(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        R.launch_r2c(rand_r(256, 4, dev).t())
    with pytest.raises(ValueError, match="aligned"):
        R.launch_r2c(torch.zeros(4 * 256 + 1, device=dev)[1:].view(4, 256))
    with pytest.raises(ValueError, match="wrong FFT length"):
        R.launch_r2c(rand_r(4, 96, dev))
    hr, hi = R.launch_r2c(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        R.launch_c2r(hr.cpu(), hi.cpu(), n=256)
    with pytest.raises(TypeError, match="float32"):
        R.launch_c2r(hr.double(), hi.double(), n=256)
    with pytest.raises(ValueError, match="contiguous"):
        R.launch_c2r(hr.t().contiguous().t(), hi, n=256)
    with pytest.raises(ValueError, match="planar pair"):
        R.launch_c2r(hr, hi[:2].contiguous(), n=256)
    with pytest.raises(ValueError, match="two planes"):
        R.launch_c2r(hr, n=256)
    with pytest.raises(TypeError, match="complex64"):
        R.launch_c2r(hr, n=256, layout="packed")
    with pytest.raises(ValueError, match="129"):
        R.launch_c2r(torch.complex(hr, hi), n=256, layout="numpy")


def test_real_offsets_past_2_31_floats(dev):
    """A real plane of more than 2^31 floats (8.6 GB): the last rows are
    reachable only with 64-bit offsets, in both kernels."""
    n = 16384
    b = (1 << 31) // n + 8
    x = torch.zeros((b, n), device=dev)
    tail = rand_r(8, n, dev, seed=3)
    x[-8:] = tail
    hr, hi = R.launch_r2c(x)
    torch.cuda.synchronize()
    want = torch.fft.rfft(tail.double())
    got = R.to_layout(hr[-8:], hi[-8:], "numpy")
    assert max_err(got, want) < bound(n)
    assert hr[:8].abs().max().item() == 0.0
    del x
    back = R.launch_c2r(hr, hi, n=n, scale=1.0 / (n // 2))
    torch.cuda.synchronize()
    assert (back[-8:] - tail).abs().max().item() < bound(n)
    assert back[:8].abs().max().item() == 0.0
