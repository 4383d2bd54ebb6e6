"""The Hopper kernels on the card (C2C, R2C, C2R; fp32 and "exact"):
against their plain PyTorch versions and the float64 ``torch.fft``
oracle, plus the wrappers' input checks, ptxas's spill report and the
real wrappers' launches inside a CUDA graph.

Every test here needs an NVIDIA GPU and nvcc; without them each skips (the
decision is taken inside the fixture, never at import).  On the GPU
machine run:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which this file
does not use.)
"""

import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from smfft_tpu_torch import api, planar
from smfft_tpu_torch.ops import _cuda
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import real as R
from smfft_tpu_torch.parallel import dryrun as DR
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


def test_api_goes_through_kernel(dev, monkeypatch):
    """Four C2C launches of four keys: four plans built, then none on a
    second round of the same calls."""
    monkeypatch.setattr(C, "_plans", {})
    x = rand_c(64, 1024, dev)
    before, plans = _cuda.C2C_RUN.count, C.launch.plans
    y = api.fft(x)
    o_r, o_i = planar.ifft(x.real.contiguous(), x.imag.contiguous())
    back = api.ifft_unordered(api.fft(x, ordered=False))
    assert _cuda.C2C_RUN.count == before + 4
    assert C.launch.plans == plans + 4
    api.fft(x)
    planar.ifft(x.real.contiguous(), x.imag.contiguous())
    api.ifft_unordered(api.fft(x, ordered=False))
    assert _cuda.C2C_RUN.count == before + 8
    assert C.launch.plans == plans + 4
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


@pytest.mark.parametrize("n", SUPPORTED_C2C_SIZES)
@pytest.mark.parametrize("layout", ["interleaved", "planar"])
@pytest.mark.parametrize("exact", [False, True])
def test_plan_miss_and_hit_agree(dev, monkeypatch, n, layout, exact):
    """A plan's first launch (built: a miss) and its second (a hit) give
    the same bits, within the oracle's bound, in every order and
    direction, with a scale."""
    monkeypatch.setattr(C, "_plans", {})
    b = 37 if n >= 128 else 132
    x = rand_c(b, n, dev, seed=n + 11)
    for inverse in (False, True):
        want = oracle(x, inverse) * 0.25
        for rev_in, rev_out in ((False, False), (True, False),
                                (False, True), (True, True)):
            xin = to_revblock(x) if rev_in else x
            w = to_revblock(want) if rev_out else want
            kw = dict(inverse=inverse, rev_in=rev_in, rev_out=rev_out,
                      scale=0.25, exact=exact)
            args = ((xin.contiguous(),) if layout == "interleaved" else
                    (xin.real.contiguous(), xin.imag.contiguous()))
            plans = C.launch.plans
            first = C.launch(*args, **kw)
            assert C.launch.plans == plans + 1
            second = C.launch(*args, **kw)
            assert C.launch.plans == plans + 1
            torch.cuda.synchronize()
            if layout == "planar":
                first, second = torch.complex(*first), torch.complex(*second)
            assert torch.equal(torch.view_as_real(first),
                               torch.view_as_real(second))
            assert (first.to(torch.complex128) - w).abs().max().item() \
                < bound(n)


def test_plan_takes_conjugate_and_strided_inputs(dev):
    """fft_complex resolves a conjugate view or a strided input before the
    plan: the same bits as the resolved copies."""
    x = rand_c(64, 1024, dev, seed=5)
    for v in (x.conj(), x.t().contiguous().t(),
              torch.cat([x, x], dim=1)[:, ::2]):
        got = C.fft_complex(v, ordered=True)
        want = C.fft_complex(v.resolve_conj().contiguous(), ordered=True)
        torch.cuda.synchronize()
        assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))
    got = api.fft(x.conj())
    assert (got.to(torch.complex128) - oracle(x.conj(), False)).abs().max() \
        < bound(1024)


@pytest.mark.parametrize("kernel", ["c2c", "c2c_multiple", "conv",
                                    "bluestein", "c2r"])
def test_planar_pairs_at_an_odd_float_offset(dev, kernel):
    """A pair's planes need only a float's alignment: views of one flat
    buffer at odd float offsets give the bits of their aligned copies, at
    a plan's build and at its hit."""
    from smfft_tpu_torch.ops import chirp as CH
    from smfft_tpu_torch.ops import convolve as CV
    from smfft_tpu_torch.ops import multiple as M
    fn, w, kw = {
        "c2c": (C.launch, 256, {}),
        "c2c_multiple": (M.launch_multiple, 256, {"loops": 1}),
        "conv": (CV.launch_conv, 256, {"h": rand_c(1, 256, dev, seed=3)}),
        "bluestein": (CH.launch_bluestein, 256, {"n": 100, "m": 256}),
        "c2r": (R.launch_c2r, 128, {"n": 256}),
    }[kernel]
    b = 37
    flat = torch.view_as_real(rand_c(1, b * w + 2, dev, seed=4)).flatten()
    xr, xi = flat[1:1 + b * w].view(b, w), flat[3 + b * w:][:b * w].view(b, w)
    assert xr.data_ptr() % 8 == xi.data_ptr() % 8 == 4
    def planes(out):
        return out if isinstance(out, tuple) else (out,)
    want = planes(fn(xr.clone(), xi.clone(), **kw))
    for _ in range(2):
        got = planes(fn(xr, xi, **kw))
        torch.cuda.synchronize()
        assert all(torch.equal(g, v) for g, v in zip(got, want))


def test_plan_reads_the_stream_per_call(dev, monkeypatch):
    """A plan holds no stream: a launch under torch.cuda.stream(s) lands on
    s (it waits for a copy queued on s behind a long sleep, and an event
    on s orders it), and the next launch on the default stream takes the
    default stream's handle."""
    seen = []
    raw = _cuda._raw_stream
    monkeypatch.setattr(_cuda, "_raw_stream",
                        lambda i: seen.append(raw(i)) or seen[-1])
    src = rand_c(64, 512, dev, seed=9)
    want = oracle(src, False)
    x = torch.zeros_like(src)
    default = torch.cuda.current_stream()
    api.fft(x)
    side = torch.cuda.Stream()
    side.wait_stream(default)
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        x.copy_(src)
        y = api.fft(x)
        done = torch.cuda.Event()
        done.record(side)
    y2 = api.fft(src)
    default.wait_event(done)
    torch.cuda.synchronize()
    assert seen == [default.cuda_stream, side.cuda_stream,
                    default.cuda_stream]
    for got in (y, y2):
        assert (got.to(torch.complex128) - want).abs().max() < bound(512)


def test_plan_on_another_device_takes_the_guard(dev):
    """An input on a device other than the current one: its plan is built
    and run under that device's guard."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    x = rand_c(64, 1024, torch.device("cuda:1"), seed=4)
    assert torch.cuda.current_device() == 0
    for _ in range(2):
        y = api.fft(x)
        torch.cuda.synchronize(1)
        assert y.device == x.device
        assert (y.to(torch.complex128) - oracle(x, False)).abs().max() \
            < bound(1024)
    assert any(k[3] == 1 for k in C._plans)


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
    c0, r0, i0 = _cuda.C2C_RUN.count, _cuda.R2C.count, _cuda.C2R.count
    y = api.rfft(x)
    pk = api.fft_packed_real(x)
    hr, hi = planar.rfft(x)
    back = planar.irfft(hr, hi)
    ur, ui = planar.rfft(x, ordered=False)
    back2 = planar.irfft(ur, ui, in_natural=False)
    x2 = api.irfft(y)
    x3 = api.irfft(pk, packed=True)
    assert _cuda.R2C.count == r0 + 4
    assert _cuda.C2R.count == i0 + 4
    assert _cuda.C2C_RUN.count == c0
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


@pytest.mark.parametrize("n", SUPPORTED_REAL_SIZES)
@pytest.mark.parametrize("layout", R.LAYOUTS)
@pytest.mark.parametrize("exact", [False, True])
def test_c2r_kernel_one_row_past_a_block(dev, n, layout, exact):
    """The C2R kernel on a batch one row past a block (the second block
    holds one live row), every layout and tier: against its plain version
    and float64 torch.fft.irfft on every row, "exact" within 2 ulp; the
    numpy layout's imaginary parts of DC and Nyquist are ignored."""
    from smfft_tpu_torch.models import hcore as H
    L = n // 2
    b = H.c2r_geometry(L, exact)["F"] + 1
    rng = np.random.default_rng(n + exact)
    x = rng.random((b, n)) - 0.5
    full = np.fft.rfft(x).astype(np.complex64)
    nat = R.from_layout(torch.from_numpy(full).to(dev), None, "numpy", L)
    src = R.to_layout(*nat, layout)
    args = tuple(t.contiguous() for t in (src if isinstance(src, tuple)
                                          else (src,)))
    if layout == "numpy":
        args[0][:, 0] += 0.5j
        args[0][:, L] -= 0.25j
    got = R.launch_c2r(*args, n=n, layout=layout, scale=1.0 / L,
                       exact=exact)
    plain = R.c2r_plain(*args, n=n, layout=layout, scale=1.0 / L,
                        exact=exact)
    want = torch.fft.irfft(R.to_layout(*nat, "numpy").to(torch.complex128),
                           n)
    torch.cuda.synchronize()
    assert got.shape == (b, n) and bool(torch.isfinite(got).all())
    assert max_err(got, plain) < bound(n)
    assert max_err(got, want) < bound(n)
    if exact:
        assert max_err(got, want) <= 2 * ulp(want.abs().max().item())


def test_c2r_fp32_instantiations_do_not_spill(dev):
    """ptxas's report of the library: every fp32 instantiation of the C2R
    kernel at L <= 4096 spills nothing."""
    _cuda.library()
    lines = [ln for ln in _cuda.register_report()
             if re.match(r"c2r_kernel<(\d+)> fp32", ln)
             and int(re.match(r"c2r_kernel<(\d+)", ln)[1]) <= 4096]
    assert len(lines) == 8, lines  # L = 32..4096
    assert all(ln.endswith(" 0 bytes of spill stores") for ln in lines), \
        lines


@pytest.mark.parametrize("which", ["r2c", "c2r"])
def test_real_launchers_replay_in_a_cuda_graph(dev, which):
    """After one warm-up call, a launch of the R2C or C2R wrapper is
    captured in a CUDA graph and its replay equals the eager result: the
    wrappers make no synchronous host-to-device copy (their tables are
    on the device once made), which capture would refuse."""
    n = 1024
    x = rand_r(64, n, dev, seed=5)
    hr, hi = R.launch_r2c(x)
    if which == "r2c":
        def run():
            return R.launch_r2c(x, "planar")
    else:
        def run():
            return R.launch_c2r(hr, hi, n=n, scale=1.0 / (n // 2))
    eager = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    eager if isinstance(eager, tuple) else (eager,)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The reuse loops (csrc/multiple.cu) and the fused convolutions (csrc/conv.cu)
# ---------------------------------------------------------------------------

from smfft_tpu_torch import signal  # noqa: E402
from smfft_tpu_torch.ops import convolve as CV  # noqa: E402
from smfft_tpu_torch.ops import multiple as M  # noqa: E402

MULTIPLE_FORMS = {
    # fft_planar(multiple_iters=3), revblock out, fused input scale
    "b1_rev_out": dict(loops=3, fb_rev=True, last_rev=True, rev_out=True,
                       scale=0.5),
    # fft_planar(multiple_iters=2, rev_in=True), inverse
    "b1_rev_in": dict(loops=2, fb_rev=True, last_rev=False, inverse=True),
    # multiple_pencil_planar(iters=4): natural feedback, 1/sqrt(n) each
    "b2": dict(loops=3),
}


@pytest.mark.parametrize("n", SUPPORTED_C2C_SIZES)
@pytest.mark.parametrize("form", list(MULTIPLE_FORMS))
@pytest.mark.parametrize("exact", [False, True])
def test_multiple_kernel_matches_plain(dev, n, form, exact):
    """c2c_multiple_kernel in both layouts on a ragged batch against its
    plain version; the error of loops + 1 chained transforms grows at most
    linearly, so the bound is bound(n) * (loops + 1)."""
    kw = dict(MULTIPLE_FORMS[form])
    if form == "b2":
        kw["scale"] = 1.0 / math.sqrt(n)
    b = 2 * max(1, 4096 // n) + 3
    x = rand_c(b, n, dev, seed=n + 11)
    plain = torch.complex(*M.multiple_plain(x.real, x.imag, exact=exact,
                                            **kw))
    got_c = M.launch_multiple(x, exact=exact, **kw)
    gr, gi = M.launch_multiple(x.real.contiguous(), x.imag.contiguous(),
                               exact=exact, **kw)
    torch.cuda.synchronize()
    lim = bound(n) * (kw["loops"] + 1)
    for got in (got_c, torch.complex(gr, gi)):
        assert max_err(got, plain) < lim
    if form == "b2":
        # four applications of F / sqrt(n) are the identity
        assert max_err(got_c, x) < lim


def reuse_bound(n, loops):
    """The chained bound of loops + 1 transforms, each unitary up to its
    1/sqrt(N): rounding adds like a random walk, twice sqrt(loops + 1)
    times one transform's bound (chip_smoke.py's reuse_bound)."""
    return 2.0 * bound(n) * math.sqrt(loops + 1)


# the fft_planar form (revblock hand-offs; revblock out, or revblock in
# with the last hand-off natural) and the pencil form (natural throughout)
REUSE_FORMS = {
    "fft_planar": dict(fb_rev=True, last_rev=True, rev_out=True, scale=0.5),
    "fft_planar_rev_in": dict(fb_rev=True, last_rev=False, inverse=True),
    "pencil": dict(),
}


@pytest.mark.parametrize("n", SUPPORTED_C2C_SIZES)
@pytest.mark.parametrize("form", list(REUSE_FORMS))
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("loops", [0, 1, 2, 99])
def test_multiple_kernel_loops_match_float64(dev, n, form, exact, loops):
    """c2c_multiple_kernel on a ragged batch, complex64 and planar, after
    loops + 1 transforms: within the chained bound of the plain version
    computed in float64 (the same hand-offs, layouts and scales)."""
    kw = dict(REUSE_FORMS[form], loops=loops)
    if form == "pencil":
        kw["scale"] = 1.0 / math.sqrt(n)
    b = max(1, 4096 // n) + 3 * max(1, 128 // n) + 1
    x = rand_c(b, n, dev, seed=n + loops)
    want = torch.complex(*M.multiple_plain(x.real.double(), x.imag.double(),
                                           **kw))
    got_c = M.launch_multiple(x, exact=exact, **kw)
    gr, gi = M.launch_multiple(x.real.contiguous(), x.imag.contiguous(),
                               exact=exact, **kw)
    torch.cuda.synchronize()
    for got in (got_c, torch.complex(gr, gi)):
        assert max_err(got, want) < reuse_bound(n, loops)


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("pairs", [1, 2, 50])
def test_real_multiple_kernel_pairs_match_float64(dev, n, pairs):
    """real_multiple_kernel on a ragged batch after ``pairs`` round trips:
    within the chained bound of 2 * pairs transforms of the plain version
    computed in float64, and so of x."""
    b = max(1, 8192 // n) + 3
    x = rand_r(b, n, dev, seed=n + pairs)
    got = M.launch_real_multiple(x, pairs)
    torch.cuda.synchronize()
    lim = reuse_bound(n, 2 * pairs - 1)
    want = M.real_multiple_plain(x.double(), pairs)
    assert (got.double() - want).abs().max().item() < lim
    assert (got - x).abs().max().item() < lim


def test_multiple_entry_points_count_launches(dev):
    """fft_planar(multiple_iters), multiple_pencil_planar and
    multiple_real_pencil_planar each launch their reuse kernel once and
    nothing else."""
    x = rand_c(64, 512, dev)
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    before = (_cuda.C2C_RUN.count, _cuda.C2C_MULTIPLE.count,
              _cuda.REAL_MULTIPLE.count)
    o = C.fft_planar(xr, xi, 512, ordered=True, multiple_iters=3)
    p = M.multiple_pencil_planar(xr, xi, 512, 4)
    r = M.multiple_real_pencil_planar(xr, 512, 4)
    torch.cuda.synchronize()
    assert (_cuda.C2C_RUN.count, _cuda.C2C_MULTIPLE.count,
            _cuda.REAL_MULTIPLE.count) == (before[0], before[1] + 2,
                                           before[2] + 1)
    plain = M.multiple_plain(xr, xi, loops=3, fb_rev=True, last_rev=True)
    assert max_err(o, plain) < bound(512) * 4
    assert max_err(torch.complex(*p), x) < bound(512) * 4
    assert (r - xr).abs().max().item() < bound(512) * 4


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("pairs", [1, 3])
def test_real_multiple_kernel_matches_plain(dev, n, pairs):
    b = max(1, 8192 // n) + 5
    x = rand_r(b, n, dev, seed=n)
    got = M.launch_real_multiple(x, pairs)
    torch.cuda.synchronize()
    assert (got - M.real_multiple_plain(x, pairs)).abs().max().item() \
        < bound(n) * pairs
    assert (got - x).abs().max().item() < bound(n) * pairs


@pytest.mark.parametrize("n", SUPPORTED_C2C_SIZES)
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("exact", [False, True])
def test_conv_kernel_matches_plain_and_oracle(dev, n, m, exact):
    """conv_kernel, complex64 and planar, ragged batch, single and bank,
    against its plain version and float64 torch.fft; "exact" within 2 ulp
    of max|y|."""
    b = 2 * max(1, 4096 // n) + 3
    x = rand_c(b, n, dev, seed=n)
    h = rand_c(m, n, dev, seed=n + 1)
    hd = CV.device_response(h, 1.0 / n, exact, dev)
    got_c = CV.launch_conv(x, h=hd, exact=exact)
    gr, gi = CV.launch_conv(x.real.contiguous(), x.imag.contiguous(), h=hd,
                            exact=exact)
    hs = h / n
    plain = torch.complex(*CV.conv_plain(x.real, x.imag, hs.real, hs.imag,
                                         exact))
    want = torch.fft.ifft(torch.fft.fft(x.to(torch.complex128))[None]
                          * h.to(torch.complex128)[:, None])
    torch.cuda.synchronize()
    for got in (got_c, torch.complex(gr, gi)):
        assert got.shape == (m, b, n)
        assert max_err(got, plain) < bound(n)
        assert max_err(got, want) < bound(n)
        if exact:
            assert max_err(got, want) <= 2 * ulp(want.abs().max().item())


@pytest.mark.parametrize("n", [s for s in SUPPORTED_REAL_SIZES if s >= 256])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("exact", [False, True])
def test_conv_real_kernel_matches_plain_and_oracle(dev, n, m, exact):
    L = n // 2
    b = 2 * max(1, 4096 // L) + 3
    x = rand_r(b, n, dev, seed=n)
    h = torch.fft.rfft(rand_r(m, n, dev, seed=n + 1).double()).to(
        torch.complex64)
    got = CV.conv_real_rows(x, h, exact)
    pk = CV.pack_real_response(h) / L
    plain = CV.conv_real_plain(x, pk.real, pk.imag, exact)
    want = torch.fft.irfft(torch.fft.rfft(x.double())[None]
                           * h.to(torch.complex128)[:, None], n)
    torch.cuda.synchronize()
    assert got.shape == (m, b, n)
    assert max_err(got, plain) < bound(n)
    assert max_err(got, want) < bound(n)
    if exact:
        assert max_err(got, want) <= 2 * ulp(want.abs().max().item())


def conv_rows_a_block(m):
    """Rows a block of the convolutions at M points (N, or L = n/2 for the
    real kernel): the row kernels' 256 threads of M / E (E = 16, 32 at
    16384), one row of 512 threads from 8192 on (RowGeometry)."""
    return max(1, 256 // (m // (32 if m >= 16384 else 16)))


@pytest.mark.parametrize("n", SUPPORTED_C2C_SIZES)
@pytest.mark.parametrize("m", [1, 2, 5])
def test_conv_kernel_bank_one_row_past_a_block(dev, n, m):
    """conv_kernel's single-filter and bank forms, complex64 and planar,
    on a batch one row past a block: every filter's rows against the
    plain version and float64 torch.fft, the lone row of the last block
    included."""
    b = conv_rows_a_block(n) + 1
    x = rand_c(b, n, dev, seed=n + m)
    h = rand_c(m, n, dev, seed=n + m + 1)
    hd = CV.device_response(h, 1.0 / n, False, dev)
    got_c = CV.launch_conv(x, h=hd)
    gr, gi = CV.launch_conv(x.real.contiguous(), x.imag.contiguous(), h=hd)
    hs = h / n
    plain = torch.complex(*CV.conv_plain(x.real, x.imag, hs.real, hs.imag))
    want = torch.fft.ifft(torch.fft.fft(x.to(torch.complex128))[None]
                          * h.to(torch.complex128)[:, None])
    torch.cuda.synchronize()
    for got in (got_c, torch.complex(gr, gi)):
        assert got.shape == (m, b, n)
        assert max_err(got, plain) < bound(n)
        assert max_err(got, want) < bound(n)


@pytest.mark.parametrize("n", [s for s in SUPPORTED_REAL_SIZES if s >= 256])
@pytest.mark.parametrize("m", [1, 2, 5])
def test_conv_real_kernel_bank_one_row_past_a_block(dev, n, m):
    """conv_real_kernel's single-filter and bank forms on a batch one row
    past a block, against the plain version and float64 torch.fft."""
    b = conv_rows_a_block(n // 2) + 1
    x = rand_r(b, n, dev, seed=n + m)
    h = torch.fft.rfft(rand_r(m, n, dev, seed=n + m + 1).double()).to(
        torch.complex64)
    got = CV.conv_real_rows(x, h)
    pk = CV.pack_real_response(h) / (n // 2)
    plain = CV.conv_real_plain(x, pk.real, pk.imag)
    want = torch.fft.irfft(torch.fft.rfft(x.double())[None]
                           * h.to(torch.complex128)[:, None], n)
    torch.cuda.synchronize()
    assert got.shape == (m, b, n)
    assert max_err(got, plain) < bound(n)
    assert max_err(got, want) < bound(n)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("m", [1, 2, 5])
def test_conv_exact_at_16384(dev, real, m):
    """The "exact" tier at N = n = 16384 (fp64 arithmetic, fp32 storage
    of the complex kernel's registers and rows), single and bank: within
    2 ulp of max|y| of float64 torch.fft."""
    n = 16384
    if real:
        x = rand_r(3, n, dev, seed=m)
        h = torch.fft.rfft(rand_r(m, n, dev, seed=m + 1).double()).to(
            torch.complex64)
        got = CV.conv_real_rows(x, h, exact=True)
        want = torch.fft.irfft(torch.fft.rfft(x.double())[None]
                               * h.to(torch.complex128)[:, None], n)
    else:
        x = rand_c(3, n, dev, seed=m)
        h = rand_c(m, n, dev, seed=m + 1)
        got = CV.conv_rows(x, None, h, exact=True)
        want = torch.fft.ifft(torch.fft.fft(x.to(torch.complex128))[None]
                              * h.to(torch.complex128)[:, None])
    torch.cuda.synchronize()
    assert got.shape == (m, 3, n)
    assert max_err(got, want) <= 2 * ulp(want.abs().max().item())


def test_conv_fp32_instantiations_do_not_spill(dev):
    """ptxas's report of the library: every fp32 instantiation of both
    convolutions at M <= 4096 points (N, or L = n/2), single-filter and
    bank, spills nothing."""
    _cuda.library()

    def points(ln):
        m = re.match(r"conv(?:_real)?_kernel<(\d+)", ln)
        return int(m[1]) if m else 0

    lines = [ln for ln in _cuda.register_report()
             if 0 < points(ln) <= 4096 and " fp32:" in ln]
    # N = 32..4096 and L = 128..4096, each single and bank
    assert len(lines) == 2 * 8 + 2 * 6, lines
    assert all(ln.endswith(" 0 bytes of spill stores") for ln in lines), \
        lines


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("bank", [False, True])
def test_convolve_api_forward_and_backward_on_card(dev, real, bank):
    """api.convolve / convolve_real: one fused launch forward; backward
    the fused kernel with conj(H) once per filter for x and two transforms
    (x and g) for h; gradients against torch.autograd through torch.fft."""
    n = 512
    if real:
        x = rand_r(16, n, dev).requires_grad_(True)
        h = torch.fft.rfft(rand_r(3, n, dev, seed=1).double()).to(
            torch.complex64)
        h = (h if bank else h[0]).requires_grad_(True)
        fn = api.convolve_real
        counter = _cuda.CONV_REAL
        tr = _cuda.R2C
        ref = lambda a, f: torch.fft.irfft(  # noqa: E731
            torch.fft.rfft(a)[None] * f[:, None] if bank
            else torch.fft.rfft(a) * f, n)
    else:
        x = rand_c(16, n, dev).requires_grad_(True)
        h = rand_c(3, n, dev, seed=1)
        h = (h if bank else h[0]).requires_grad_(True)
        fn = api.convolve
        counter = _cuda.CONV
        tr = _cuda.C2C_RUN
        ref = lambda a, f: torch.fft.ifft(  # noqa: E731
            torch.fft.fft(a)[None] * f[:, None] if bank
            else torch.fft.fft(a) * f)
    c0, t0 = counter.count, tr.count
    y = fn(x, h)
    assert counter.count == c0 + 1 and tr.count == t0
    g = (rand_r if real else rand_c)(y.numel() // n, n, dev,
                                     seed=2).reshape(y.shape)
    gx, gh = torch.autograd.grad(y, (x, h), g)
    torch.cuda.synchronize()
    assert counter.count == c0 + 1 + (3 if bank else 1)
    assert tr.count == t0 + 2
    rx, rh = torch.autograd.grad(ref(x, h), (x, h), g)
    # relative to the largest gradient: fp32 transforms of O(sqrt(n))
    # spectra, summed over the batch for h
    assert max_err(gx, rx) < 1e-4 * rx.abs().max().item()
    assert max_err(gh, rh) < 1e-4 * rh.abs().max().item()


def test_fftconvolve_on_card_counts(dev):
    """Overlap-save: one fused launch for all frames plus one transform of
    the taps (R2C for real data, C2C for complex)."""
    x = rand_r(4, 20000, dev)
    taps = rand_r(1, 129, dev, seed=5)[0]
    c0, r0 = _cuda.CONV_REAL.count, _cuda.R2C.count
    y = signal.fftconvolve(x, taps)
    torch.cuda.synchronize()
    assert (_cuda.CONV_REAL.count, _cuda.R2C.count) == (c0 + 1, r0 + 1)
    want = torch.stack([torch.from_numpy(np.convolve(
        row.double().cpu().numpy(), taps.double().cpu().numpy()))
        for row in x]).to(dev)
    assert y.shape == want.shape
    assert (y.double() - want).abs().max().item() < bound(512) * 12
    xc = rand_c(2, 20000, dev)
    tc = rand_c(1, 129, dev, seed=6)[0]
    c0, k0 = _cuda.CONV.count, _cuda.C2C_RUN.count
    yc = signal.fftconvolve(xc, tc, mode="same")
    torch.cuda.synchronize()
    assert (_cuda.CONV.count, _cuda.C2C_RUN.count) == (c0 + 1, k0 + 1)
    assert yc.shape == xc.shape


def test_new_launchers_refuse_what_they_cannot_take(dev):
    x = rand_c(4, 256, dev)
    h = CV.device_response(rand_c(2, 256, dev), 1 / 256, False, dev)
    with pytest.raises(ValueError, match="h must be"):
        CV.launch_conv(x, h=h.to(torch.complex128))
    with pytest.raises(ValueError, match=r"h must be \(m, 256\)"):
        CV.launch_conv(x, h=h[:, :128].contiguous())
    with pytest.raises(TypeError, match="complex64"):
        CV.launch_conv(x.to(torch.complex128), h=h)
    with pytest.raises(ValueError, match="CUDA tensor"):
        CV.launch_conv(x.cpu(), h=h.cpu())
    with pytest.raises(TypeError, match="float32"):
        CV.launch_conv_real(x.real.double().contiguous(), h=h[:, :128]
                            .contiguous())
    with pytest.raises(ValueError, match="pairs must be"):
        M.launch_real_multiple(x.real.contiguous(), 0)
    with pytest.raises(ValueError, match="wrong FFT length"):
        M.launch_real_multiple(rand_r(4, 128, dev), 1)
    with pytest.raises(TypeError, match="complex64"):
        M.launch_multiple(x.to(torch.complex128), loops=1)


# ---------------------------------------------------------------------------
# The power spectrum (csrc/spectral.cu) and Bluestein (csrc/chirp.cu)
# ---------------------------------------------------------------------------

import smfft_tpu_torch as T  # noqa: E402
from smfft_tpu_torch.ops import chirp as CH  # noqa: E402
from smfft_tpu_torch.ops import spectral as SP  # noqa: E402

# chip_smoke.py's sizes, and one for each convolution length m they miss
# (64, 128, 1024, 8192): every instantiation of the kernel
BLUESTEIN_SIZES = (3, 17, 40, 100, 129, 300, 1000, 1536, 3000, 4097, 6000,
                   8191)


def conv_len(n):
    return max(32, 1 << (2 * n - 2).bit_length())


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("windowed", [False, True])
def test_power_kernel_matches_plain_and_oracle(dev, n, windowed):
    """power_kernel on a batch ragged against every rows-per-block count,
    against its plain version and float64 torch.fft.rfft squared: within
    2 bound(n) max|X| + bound(n)^2."""
    L = n // 2
    b = 4096 // L + 37
    x = rand_r(b, n, dev, seed=n)
    w = rand_r(1, n, dev, seed=n + 1)[0] + 0.5 if windowed else None
    got = SP.launch_power(x, w)
    plain = SP.power_plain(x, w)
    spec = torch.fft.rfft(x.double() if w is None else x.double() * w)
    want = spec.abs().square()[:, :L]
    want[:, 0] = spec[:, 0].real.square()
    torch.cuda.synchronize()
    lim = 2 * bound(n) * spec.abs().max().item() + bound(n) ** 2
    assert got.shape == (b, L)
    assert max_err(got, plain) < lim
    assert max_err(got, want) < lim


@pytest.mark.parametrize("n", BLUESTEIN_SIZES)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("exact", [False, True])
def test_bluestein_kernel_matches_plain_and_oracle(dev, n, inverse, exact):
    """bluestein_kernel, complex64 rows and planar n_pad-wide rows, ragged
    batch, forward and inverse (scale 1/n), against its plain version and
    float64 torch.fft within bound(m); "exact" within 2 ulp of max|X|; the
    pad lanes exactly 0."""
    m = conv_len(n)
    b = 2 * max(1, 4096 // m) + 3
    x = rand_c(b, n, dev, seed=n)
    scale = 1.0 / n if inverse else None
    kw = dict(n=n, m=m, inverse=inverse, scale=scale, exact=exact)
    got = CH.launch_bluestein(x, **kw)
    np_ = CH.n_pad(n)
    vr = torch.full((b, np_), 3.0, device=dev)
    vi = torch.full((b, np_), -1.0, device=dev)
    vr[:, :n], vi[:, :n] = x.real, x.imag
    pr, pi = CH.launch_bluestein(vr, vi, **kw)
    plain = torch.complex(*CH.bluestein_plain(x.real, x.imag, **kw))
    x64 = x.to(torch.complex128)
    want = torch.fft.ifft(x64) if inverse else torch.fft.fft(x64)
    torch.cuda.synchronize()
    for y in (got, torch.complex(pr[:, :n], pi[:, :n])):
        assert max_err(y, plain) < bound(m)
        assert max_err(y, want) < bound(m)
        if exact:
            assert max_err(y, want) <= 2 * ulp(want.abs().max().item())
    assert not pr[:, n:].any() and not pi[:, n:].any()


def test_spectral_and_bluestein_apis_go_through_kernels(dev):
    """power_spectrum (fp32 tiers), periodogram, welch and spectrogram
    launch the power kernel once a call; "exact" the R2C kernel; fft_any,
    ifft_any, planar.fft_any once each and resample twice the Bluestein
    kernel; nothing else runs."""
    x = rand_r(64, 1024, dev)
    before = DR.counts()

    def delta():
        now = DR.counts()
        return {k: now[k] - before[k]
                for k in ("power", "bluestein", "r2c", "c2c")}
    p = T.power_spectrum(x, window=T.get_window("hann", 1024))
    T.periodogram(x)
    T.welch(x.reshape(-1), nperseg=512)
    T.spectrogram(x.reshape(-1), nperseg=256)
    assert delta() == {"power": 4, "bluestein": 0, "r2c": 0, "c2c": 0}
    pe = T.power_spectrum(x, window=T.get_window("hann", 1024),
                          precision="exact")
    assert delta()["r2c"] == 1
    assert max_err(p, pe) < 2 * bound(1024) * 32 + bound(1024) ** 2
    xc = rand_c(32, 1000, dev)
    y = T.fft_any(xc)
    back = T.ifft_any(y)
    vr = torch.zeros((32, 1024), device=dev)
    vr[:, :1000] = xc.real
    o_r, o_i = T.planar.fft_any(vr, torch.zeros_like(vr), n=1000)
    r = T.resample(x[:, :1000].contiguous(), 768)
    torch.cuda.synchronize()
    assert delta() == {"power": 4, "bluestein": 5, "r2c": 1, "c2c": 0}
    assert max_err(back, xc) < bound(2048)
    assert r.shape == (64, 768)


def test_power_and_bluestein_launchers_refuse_what_they_cannot_take(dev):
    x = rand_r(4, 256, dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        SP.launch_power(x.cpu())
    with pytest.raises(TypeError, match="float32"):
        SP.launch_power(x.double())
    with pytest.raises(ValueError, match="wrong FFT length"):
        SP.launch_power(rand_r(4, 8192, dev))
    with pytest.raises(ValueError, match="window"):
        SP.launch_power(x, torch.ones(128, device=dev))
    xc = rand_c(4, 100, dev)
    with pytest.raises(ValueError, match="wrong FFT length"):
        CH.launch_bluestein(xc, n=100, m=128)
    with pytest.raises(TypeError, match="complex64"):
        CH.launch_bluestein(xc.to(torch.complex128), n=100, m=256)
    with pytest.raises(ValueError, match="ld >= 100"):
        CH.launch_bluestein(xc[:, :50].contiguous(), n=100, m=256)
    with pytest.raises(ValueError, match="planar pair"):
        CH.launch_bluestein(xc.real.contiguous(), xc.imag[:2].contiguous(),
                            n=100, m=256)


# ---------------------------------------------------------------------------
# Huge N: fourstep_pass_kernel (csrc/fourstep.cu) and real_huge_kernel
# (csrc/real_huge.cu).
# ---------------------------------------------------------------------------

from smfft_tpu_torch.ops import fourstep_fused as FF  # noqa: E402
from smfft_tpu_torch.ops import hugefft  # noqa: E402
from smfft_tpu_torch.ops import real_fused as RFU  # noqa: E402

# every plan at a size, and every radix 16..2048 among their passes
HUGE_CASES = [(1 << 15, None), (1 << 17, None), (1 << 18, "two:revisit"),
              (1 << 18, "three"), (1 << 20, None), (1 << 21, "two:fold"),
              (1 << 21, "five"), (1 << 22, None)]


def huge_plain(x, n, passes, inverse, scale, exact):
    """The plan's plain version on the card (complex in and out)."""
    def run(xr, xi):
        y = FF.passes_plain(torch.complex(xr, xi), n, passes, inverse, scale)
        return y.real, y.imag
    return torch.complex(*C.at_tier(run, exact, x.real, x.imag))


@pytest.mark.parametrize("n,plan", HUGE_CASES)
@pytest.mark.parametrize("exact", [False, True])
def test_fourstep_pass_matches_plain_and_oracle(dev, n, plan, exact):
    b = 3
    x = rand_c(b, n, dev, seed=n % 1009)
    passes = FF.default_passes(n) if plan is None else hugefft.passes(n,
                                                                     plan)
    for inverse in (False, True):
        want = oracle(x, inverse) * 0.5
        plain = huge_plain(x, n, passes, inverse, 0.5, exact)
        got_c = FF.run_passes(x, n, passes, inverse=inverse, scale=0.5,
                              exact=exact)
        gr, gi = FF.run_passes((x.real.contiguous(), x.imag.contiguous()), n,
                               passes, inverse=inverse, scale=0.5,
                               exact=exact)
        torch.cuda.synchronize()
        for got in (got_c, torch.complex(gr, gi)):
            assert max_err(got, plain) < bound(n)
            assert max_err(got, want) < bound(n)
            if exact:
                assert max_err(got, want) <= 2 * ulp(want.abs().max().item())


def test_fourstep_factors_plan_and_pass1(dev):
    """The strided two-pass (B22/B23) and its pass-1 intermediate."""
    n1 = n2 = 512
    n = n1 * n2
    x = rand_c(2, n, dev, seed=5)
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    o_r, o_i = FF.fft_large_planar(xr, xi, factors=(n1, n2), scale=0.25)
    assert max_err(torch.complex(o_r, o_i), oracle(x, False) * 0.25) \
        < bound(n)
    br, bi = FF.large_pass1_planar(xr, xi, n1, n2, scale=0.25)
    want = huge_plain(x, n, FF.factors_plan(n1, n2)[:1], False, 0.25,
                      False).reshape(-1, n1)
    assert max_err(torch.complex(br, bi), want) < bound(n1)


@pytest.mark.parametrize("n", [1 << 15, 1 << 18])
@pytest.mark.parametrize("mode", ["pair", "halfc"])
@pytest.mark.parametrize("layout", ["planar", "packed", "numpy"])
@pytest.mark.parametrize("exact", [False, True])
def test_real_huge_matches_plain_and_oracle(dev, n, mode, layout, exact):
    for b in (1, 4):
        x = rand_r(b, n, dev, seed=b)
        got = RFU.rfft_large_rows(x, layout, exact, mode)
        plain = RFU.rfft_large_rows(x.cpu(), layout, exact, mode)
        pr, pi = R.from_layout(*(got if isinstance(got, tuple)
                                 else (got, None)), layout, n // 2)
        spec = R.to_layout(pr, pi, "numpy")
        want = torch.fft.rfft(x.double())
        back = RFU.irfft_large_rows(*(got if isinstance(got, tuple)
                                      else (got, None)), n, layout, exact,
                                    2.0 / n, mode)
        torch.cuda.synchronize()
        got_t = got if isinstance(got, tuple) else (got,)
        plain_t = plain if isinstance(plain, tuple) else (plain,)
        assert max(max_err(g, p.to(dev)) for g, p in zip(got_t, plain_t)) \
            < bound(n)
        assert max_err(spec, want) < bound(n)
        assert max_err(back, x) < bound(n)
        if exact:
            assert max_err(spec, want) <= 2 * ulp(want.abs().max().item())


def test_large_apis_go_through_kernels_and_backward(dev):
    """fft_large / ifft_large launch the pass kernel once a pass and
    nothing else; rfft_large in pair mode is its plan's passes alone, the
    last one splitting (``launch_pass.fused``), and irfft_large adds one
    real_huge launch (the merge); sizes <= 16384 run the row kernels; the
    backward of fft_large is a kernel run too."""
    import smfft_tpu_torch as T
    n = 1 << 18
    x = rand_c(2, n, dev, seed=3)
    xr = rand_r(4, 1 << 16, dev, seed=4)
    fs = {"pass": _cuda.FOURSTEP_PASS, "real": _cuda.REAL_HUGE,
          "c2c": _cuda.C2C_RUN, "r2c": _cuda.R2C}
    before = {k: f.count for k, f in fs.items()}
    fused = FF.launch_pass.fused

    def delta():
        return {k: f.count - before[k] for k, f in fs.items()}
    y = T.fft_large(x)
    back = T.ifft_large(y)
    hr, hi = T.planar.rfft_large(xr)
    xb = T.planar.irfft_large(hr, hi)
    torch.cuda.synchronize()
    two = len(FF.default_passes(n))
    assert delta() == {"pass": 2 * two + 4, "real": 1, "c2c": 0, "r2c": 0}
    assert FF.launch_pass.fused - fused == 1
    assert max_err(back, x) < bound(n)
    assert max_err(xb, xr) < bound(1 << 16)
    T.fft_large(x[:, :16384].contiguous())
    T.rfft_large(xr[:, :4096].contiguous())
    assert delta()["c2c"] == 1 and delta()["r2c"] == 1
    xg = x.clone().requires_grad_(True)
    (T.fft_large(xg).abs() ** 2).sum().backward()
    x64 = x.to(torch.complex128).requires_grad_(True)
    (torch.fft.fft(x64).abs() ** 2).sum().backward()
    rel = (xg.grad - x64.grad).abs().max() / x64.grad.abs().max()
    assert rel.item() < 1e-5


@pytest.mark.parametrize("rows", [4, 3])
def test_rfft_large_matches_the_deployments_reference_and_records_buffers(
        dev, rows):
    """The periodicity-search call (``api.rfft_large``, "highest") at 2^21
    samples a trial, pair mode (4 rows) and halfc (3), held to the plain
    reference as the CPU tests hold it (2e-5 of the spectrum's rms,
    tests/test_torch_periodicity.py).  Traced, the intermediate, ``z``
    (halfc only: the pair split is the last pass's) and the spectrum are
    each the ``alloc`` of the launch that first writes it, with its bytes
    (rows * n * 4 for either Z layout)."""
    from smfft_tpu_torch import trace
    from smfft_tpu_torch.reference import periodicity_search as ref
    n = 1 << 21
    x = rand_r(rows, n, dev, seed=rows) * 2
    trace.start()
    try:
        y = api.rfft_large(x, precision="highest")
        torch.cuda.synchronize()
    finally:
        rec = trace.stop()
    want = ref.expected(x)
    rms = want.abs().square().mean().sqrt()
    assert ((y.to(want.dtype) - want).abs().max() / rms).item() < 2e-5
    allocs = [rec.span(i)["attrs"]["bytes"] for i in range(len(rec))
              if rec.span(i)["name"] == "alloc"]
    zs = 1 if RFU.choose_mode(rows, n) == "pair" else 2
    assert allocs == [rows * n * 4] * zs + [rows * (n // 2 + 1) * 8]


def test_huge_launchers_refuse_what_they_cannot_take(dev):
    n = 1 << 15
    x = rand_c(2, n, dev)
    p = FF.default_passes(n)[0]
    with pytest.raises(ValueError, match="CUDA tensor"):
        FF.launch_pass(x.cpu(), x, n, p)
    with pytest.raises(TypeError, match="complex64 or complex128"):
        FF.launch_pass(x.real.contiguous(), x, n, p)
    with pytest.raises(ValueError, match="contiguous"):
        FF.launch_pass(x[:, ::2], x, n, p)
    with pytest.raises(ValueError, match="rows"):
        FF.launch_pass(x, x[:1].contiguous(), n, p)
    with pytest.raises(ValueError, match="unknown mode"):
        RFU.launch_real_huge("split", x, x, n)
    last = FF.pair_split_plan(n)[-1]
    spec = torch.empty((5, n // 2), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError, match="do not match"):
        FF.launch_pass(x, spec, n, last)
    with pytest.raises(ValueError, match="last pass"):
        FF.launch_pass(x, spec[:2], n, dataclasses.replace(p, split="pair"))
    with pytest.raises(ValueError, match="do not match"):
        RFU.launch_real_huge("halfc_split", x[:, :n // 2].contiguous(),
                             torch.empty((3, n // 2), dtype=torch.complex64,
                                         device=dev), n)


# Tile edges of the pass kernel's persistent grid: fewer tiles than SMs, a
# ragged last tile, many tiles a block, a one-buffer radix (1024 / 2048).
TILE_EDGES = [(1 << 11, 3, (32, 64)), (1 << 15, 1, (256, 128)),
              (1 << 15, 64, (256, 128)), (1 << 16, 5, (2048, 32)),
              (1 << 20, 2, (1024, 1024))]


def fused_case(x, layout, exact, mode=None):
    """rfft_large_rows on the card and its plain version on the card, the
    spectra as numpy rows, and the launches it made (passes, split passes,
    real_huge)."""
    before = (_cuda.FOURSTEP_PASS.count, FF.launch_pass.fused,
              _cuda.REAL_HUGE.count)
    got = RFU.rfft_large_rows(x, layout, exact, mode)
    torch.cuda.synchronize()
    launched = tuple(a - b for a, b in zip(
        (_cuda.FOURSTEP_PASS.count, FF.launch_pass.fused,
         _cuda.REAL_HUGE.count), before))
    plain = RFU.rfft_large_plain(x, layout, exact, mode)
    n = x.shape[1]

    def nat(t):
        return R.to_layout(*R.from_layout(
            *(t if isinstance(t, tuple) else (t, None)), layout, n // 2),
            "numpy")
    return nat(got), nat(plain), launched


# the pair-mode R2C with the split in its last pass: rowfour's 256 x 128
# (2^15), three passes 128^3 (2^21), the cell's 256 x 256 x 128 (2^23) and
# 256^3 (2^24); "two:revisit" 512 x 512 (2^18) keeps the split a launch of
# its own (radix 512); one to three pairs of rows
@pytest.mark.parametrize("n", [1 << 15, 1 << 18, 1 << 21, 1 << 23, 1 << 24])
@pytest.mark.parametrize("b", [2, 4, 6])
@pytest.mark.parametrize("layout", ["planar", "packed", "numpy"])
@pytest.mark.parametrize("exact", [False, True])
def test_fused_split_matches_plain_and_oracle(dev, n, b, layout, exact):
    x = rand_r(b, n, dev, seed=n % 1009 + b)
    got, plain, launched = fused_case(x, layout, exact)
    want = torch.fft.rfft(x.double())
    fused = int(FF.default_passes(n)[-1].radix <= FF.SPLIT_MAX_RADIX)
    # the fp32 three-pass plans (2^21 .. 2^24) as pass 1 and the fused tail
    plan = FF.tail_plan(n, FF.pair_split_plan(n), exact)
    assert launched == (len(plan), fused, 1 - fused)
    assert max_err(got, plain) < bound(n)
    assert max_err(got, want) < bound(n)
    if exact:
        assert max_err(got, want) <= 2 * ulp(want.abs().max().item())


# Tile edges of the split: tiles spanning rows with a ragged last one
# (2^11: radix 32, 32 pairs a row, 128 a tile; 2^12: radix 64; 2^13:
# radix 64 under 128), an odd batch whose last q row is left out, one
# pair of rows, and radix 128 under rowfour's 512 (2^16).
SPLIT_EDGES = [(1 << 11, 5), (1 << 11, 6), (1 << 12, 1), (1 << 12, 2),
               (1 << 13, 3), (1 << 16, 3)]


@pytest.mark.parametrize("n,b", SPLIT_EDGES)
@pytest.mark.parametrize("exact", [False, True])
def test_fused_split_tile_edges(dev, n, b, exact):
    x = rand_r(b, n, dev, seed=b + 17)
    # tones at bins 0, S/2, S, L - S/2 and L: transforms 0 and S/2, which
    # pair with themselves, and their neighbours' mirrors; each |X| of
    # about the noise's sqrt(n / 12), which bound(n) is drawn for
    s = n // FF.default_passes(n)[-1].radix
    t = torch.arange(n, device=dev, dtype=torch.float64)
    for k in (0, s // 2, s, n // 2 - s // 2, n // 2):
        x += (torch.cos(2 * math.pi * k * t / n) / math.sqrt(n)).float()
    for layout in ("planar", "numpy"):
        got, plain, launched = fused_case(x, layout, exact, "pair")
        want = torch.fft.rfft(x.double())
        assert launched == (len(FF.default_passes(n)), 1, 0)
        assert max_err(got, plain) < bound(n)
        assert max_err(got, want) < bound(n)
        if exact:
            assert max_err(got, want) <= 2 * ulp(want.abs().max().item())


# the fused tail: 2^21 .. 2^24 (pass 1 of radix 128 .. 1024, then pass 2
# and the split pass in one launch), three trials (pair mode pads a zero
# row; the last q row is left out), each spectrum layout
TAIL_N = [1 << 21, 1 << 22, 1 << 23, 1 << 24]


def pair_three_launches(x, layout):
    """The pair-mode R2C as the three launches of ``pair_split_plan``: the
    plan the fused tail replaces."""
    b, n = x.shape
    b2 = -(-b // 2)
    if 2 * b2 > b:
        x = torch.cat([x, torch.zeros_like(x[:1])])
    plan = FF.pair_split_plan(n)
    tmp = FF.launch_pass((x[:b2], x[b2:]), lambda: torch.empty(
        (b2, n), dtype=torch.complex64, device=x.device), n, plan[0])
    FF.launch_pass(tmp, tmp, n, plan[1])
    return FF.launch_pass(tmp, RFU._alloc_spec(layout, b, n // 2, x.device),
                          n, plan[2])


def tail_counts():
    return (_cuda.FOURSTEP_PASS.count, FF.launch_pass.tails,
            FF.launch_pass.fused, _cuda.REAL_HUGE.count)


@pytest.mark.parametrize("n", TAIL_N)
@pytest.mark.parametrize("layout", ["numpy", "planar", "packed"])
def test_fused_tail_matches_the_three_launches(dev, n, layout):
    """The pair-mode R2C makes two launches, the second a fused tail, where
    ``pair_split_plan`` makes three; its spectra agree with the three
    launches' to 8 ulp(max|X|) (the plans round differently: pass 1 of
    another radix from 2^23 on, the tail another kernel below) and with
    float64 within bound(n); a second call (the next epoch of the tail's
    device words) and a call on another stream (words of its own) give the
    same spectra bit for bit."""
    x = rand_r(3, n, dev, seed=n % 997)

    def nat(t):
        return R.to_layout(*R.from_layout(
            *(t if isinstance(t, tuple) else (t, None)), layout, n // 2),
            "numpy")
    before = tail_counts()
    got = nat(RFU.rfft_large_rows(x, layout, mode="pair"))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(tail_counts(), before)) \
        == (2, 1, 1, 0)
    again = nat(RFU.rfft_large_rows(x, layout, mode="pair"))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = nat(RFU.rfft_large_rows(x, layout, mode="pair"))
    torch.cuda.current_stream().wait_stream(side)
    three = nat(pair_three_launches(x, layout))
    torch.cuda.synchronize()
    want = torch.fft.rfft(x.double())
    assert torch.equal(got, again) and torch.equal(got, other)
    assert max_err(got, three) <= 8 * ulp(want.abs().max().item())
    assert max_err(got, want) < bound(n)
    assert FF.tail_waits() >= 0


def test_fused_tail_replays_in_a_cuda_graph(dev):
    """The pair R2C at 2^21, captured in a CUDA graph on a stream, replayed
    twice on new inputs with an eager call on the same stream (the same
    device words) between: each replay's spectra equal the eager call's on
    its input bit for bit, since the kernel keeps its epoch and its ticket
    on the device."""
    n = 1 << 21
    x = rand_r(3, n, dev, seed=21)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        RFU.rfft_large_rows(x, "numpy", mode="pair")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        out = RFU.rfft_large_rows(x, "numpy", mode="pair")
    for seed in (22, 23):
        with torch.cuda.stream(s):
            x.copy_(rand_r(3, n, dev, seed=seed))
            graph.replay()
            got = out.clone()
            eager = RFU.rfft_large_rows(x, "numpy", mode="pair")
        torch.cuda.synchronize()
        assert torch.equal(got, eager)
        assert max_err(got, torch.fft.rfft(x.double())) < bound(n)


def test_main_path_rfft_large_makes_two_launches(dev):
    """``api.rfft_large`` of the periodicity search's trials (pair mode,
    numpy layout) at 2^23: pass 1 and the fused tail, two launches of the
    pass kernel a call."""
    n = 1 << 23
    x = rand_r(4, n, dev, seed=23)
    c0 = DR.counts()
    y = api.rfft_large(x, precision="highest")
    torch.cuda.synchronize()
    done = {k: v - c0[k] for k, v in DR.counts().items() if v != c0[k]}
    assert done == {"fourstep_pass": 2}
    assert max_err(y, torch.fft.rfft(x.double())) < bound(n)


@pytest.mark.parametrize("n,exact", [(1 << 23, True), (1 << 25, False),
                                     (1 << 26, False)])
def test_fused_tail_stays_out_of_its_bounds(dev, n, exact):
    """The "exact" tier (complex128 intermediates) and sizes whose fused
    plan would take a pass-1 radix over 1024 (2^25, 2^26) keep the three
    launches, the last with the split."""
    x = rand_r(2, n, dev, seed=n % 991)
    before = tail_counts()
    got = RFU.rfft_large_rows(x, "numpy", exact, "pair")
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(tail_counts(), before)) \
        == (3, 0, 1, 0)
    assert max_err(got, torch.fft.rfft(x.double())) < bound(n)


# ptxas's report of every plain pass instantiation (CUDA 12.8, sm_90a):
# the split pass is an overload of its own, and leaves these as they are
PLAIN_PASS_REGISTERS = {
    "<16> fp32": (71, 0), "<16> fp64": (112, 0),
    "<32> fp32": (78, 0), "<32> fp64": (146, 0),
    "<64> fp32": (74, 0), "<64> fp64": (142, 0),
    "<128> fp32": (75, 0), "<128> fp64": (128, 0),
    "<256> fp32": (78, 0), "<256> fp64": (136, 0),
    "<512> fp32": (88, 0), "<512> fp64": (148, 0),
    "<1024> fp32": (127, 0), "<1024> fp64": (232, 0),
    "<2048> fp32": (128, 428), "<2048> fp64": (254, 0)}


def test_plain_pass_instantiations_keep_their_registers(dev):
    """Each plain ``fourstep_pass_kernel`` instantiation has the registers
    and spill stores it had before the split pass was added; the split
    instantiations (R = 16..256, both tiers) are reported apart."""
    _cuda.library()
    got = {}
    for ln in _cuda.register_report():
        m = re.match(r"fourstep_pass_kernel(<\d+(?:,split)?> fp\d\d): "
                     r"(\d+) registers, (\d+) bytes", ln)
        if m:
            got[m[1]] = (int(m[2]), int(m[3]))
    assert {k: v for k, v in got.items() if "split" not in k} \
        == PLAIN_PASS_REGISTERS
    assert sorted(k for k in got if "split" in k) == sorted(
        f"<{r},split> {t}" for r in (16, 32, 64, 128, 256)
        for t in ("fp32", "fp64"))


@pytest.mark.parametrize("n,b,rs", TILE_EDGES)
@pytest.mark.parametrize("exact", [False, True])
def test_fourstep_tile_edges(dev, n, b, rs, exact):
    x = rand_c(b, n, dev, seed=b)
    passes = FF.plan(rs)
    for inverse in (False, True):
        got = FF.run_passes(x, n, passes, inverse=inverse, scale=0.5,
                            exact=exact)
        plain = huge_plain(x, n, passes, inverse, 0.5, exact)
        want = oracle(x, inverse) * 0.5
        torch.cuda.synchronize()
        assert max_err(got, plain) < bound(n)
        assert max_err(got, want) < bound(n)
        if exact:
            assert max_err(got, want) <= 2 * ulp(want.abs().max().item())


@pytest.mark.parametrize("entry", ["fft", "ifft", "ifft_unordered",
                                   "fft_large", "ifft_large", "irfft"])
def test_real_input_promoted_on_card(dev, entry):
    """A float32 input gives exactly the output of its complex64 copy (the
    kernels are deterministic), within bound(n) of float64."""
    import smfft_tpu_torch as T
    n = {"fft_large": 1 << 15, "ifft_large": 1 << 15}.get(entry, 256)
    x = rand_r(4, n // 2 + 1 if entry == "irfft" else n, dev, seed=7)
    fn = getattr(T, entry)
    got = fn(x)
    same = fn(x.to(torch.complex64))
    x64 = x.to(torch.complex128)
    if entry == "ifft_unordered":
        # revblock in: position k2*128 + k1 holds X[k1*2 + k2]
        x64 = x64.reshape(4, 2, 128).transpose(1, 2).reshape(4, n)
    ref = {"fft": torch.fft.fft, "fft_large": torch.fft.fft,
           "irfft": torch.fft.irfft}.get(entry, torch.fft.ifft)
    torch.cuda.synchronize()
    assert torch.equal(got, same)
    assert max_err(got, ref(x64)) < bound(n)


# ---------------------------------------------------------------------------
# c2c_kernel and the R2C kernel on the Hopper core (csrc/hcore.cuh)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,rows", [(32, 128), (64, 64)])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
def test_c2c_packed_rows_at_block_edges(dev, n, rows, exact, inverse):
    """N = 32 / 64 pack 128 / 64 rows into a block: batches of 1 row, one
    short of a block, a block, one past it, and a ragged several, against
    the plain version and float64 (and "exact" within 2 ulp(max|X|))."""
    for b in (1, rows - 1, rows, rows + 1, 3 * rows + 5):
        x = rand_c(b, n, dev, seed=b)
        got = C.launch(x, inverse=inverse, exact=exact)
        plain = torch.complex(*C.plain(x.real, x.imag, inverse=inverse,
                                       exact=exact))
        want = oracle(x, inverse)
        torch.cuda.synchronize()
        assert max_err(got, plain) < bound(n)
        assert max_err(got, want) < bound(n)
        if exact:
            assert max_err(got, want) <= 2 * ulp(want.abs().max().item())


@pytest.mark.parametrize("kind", ["c2c", "c2c_planar", "c2c_rev_in",
                                  "c2c_rev_out", "r2c_planar",
                                  "r2c_planar_rev", "r2c_numpy"])
def test_input_view_with_offset(dev, kind):
    """The input is a contiguous view at an offset into a larger tensor:
    the output is a fresh tensor that overlaps no input, equal to the plain
    version, and the input is left as it was."""
    n = 1024
    if kind.startswith("c2c"):
        big = rand_c(40, n, dev, seed=11)
        x = big[3:35]
        before = big.clone()
        kw = dict(rev_in=kind == "c2c_rev_in", rev_out=kind == "c2c_rev_out")
        if kind == "c2c_planar":
            bigr, bigi = big.real.contiguous(), big.imag.contiguous()
            before = torch.complex(bigr, bigi)
            o = C.launch(bigr[3:35], bigi[3:35], **kw)
            outs, bigs = o, (bigr, bigi)
            got = torch.complex(*o)
        else:
            got = C.launch(x, **kw)
            outs, bigs = (got,), (big,)
        want = torch.complex(*C.plain(x.real, x.imag, **kw))
        after = torch.complex(*bigs) if len(bigs) == 2 else bigs[0]
    else:
        layout = kind[4:]
        big = rand_r(40, n, dev, seed=12)
        before = big.clone()
        x = big[3:35]
        o = R.launch_r2c(x, layout)
        outs = o if isinstance(o, tuple) else (o,)
        bigs = (big,)
        got, want = o, R.r2c_plain(x, layout)
        after = big
    torch.cuda.synchronize()
    for out in outs:
        for b in bigs:
            lo, hi = b.data_ptr(), b.data_ptr() + b.numel() * b.element_size()
            assert not lo <= out.data_ptr() < hi
    assert max_err(got, want) < bound(n)
    assert torch.equal(after, before)


@pytest.mark.parametrize("n", SUPPORTED_REAL_SIZES)
def test_r2c_layouts_agree_bit_for_bit(dev, n):
    """The four layouts are one kernel's X stored four ways: the same bits
    once mapped to the natural packed spectrum."""
    x = rand_r(2 * (4096 // (n // 2)) + 3 if n <= 8192 else 5, n, dev,
               seed=n + 1)
    nat = None
    for layout in R.LAYOUTS:
        got = R.launch_r2c(x, layout)
        pr, pi = R.from_layout(*(got if isinstance(got, tuple)
                                 else (got, None)), layout, n // 2)
        if nat is None:
            nat = (pr, pi)
        else:
            assert torch.equal(pr, nat[0]) and torch.equal(pi, nat[1])


# ---------------------------------------------------------------------------
# N-D transforms and the DCT / DST (ndim.py, dct.py): compositions over the
# C2C, R2C and C2R kernels, and the real entry points' input promotion
# ---------------------------------------------------------------------------


def launches_of(fn):
    """fn()'s output and the kernels it launched, {name: launches}."""
    before = DR.counts()
    out = fn()
    torch.cuda.synchronize()
    after = DR.counts()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def rel_err(got, want):
    return max_err(got, want) / want.abs().max().item()


def test_fft2_on_card_runs_two_c2c_launches(dev):
    """fft2 / ifft2 over the first two axes of a (64, 128, 3) stack, whose
    strides 384 and 3 are no powers of two (the copy path): one c2c launch
    an axis and no other kernel, each after a copy of the transposed view;
    every element against the plain versions (the same call on the CPU
    copy) and float64 torch.fft within the summed bound."""
    x = rand_c(64 * 128, 3, dev, seed=21).reshape(64, 128, 3)
    lim = bound(64) + bound(128)
    for fn, oracle_fn in ((T.fft2, torch.fft.fft2),
                          (T.ifft2, torch.fft.ifft2)):
        copied = DR.copied_bytes()
        y, ran = launches_of(lambda: fn(x, axes=(0, 1)))
        assert ran == {"c2c": 2}
        assert DR.copied_bytes() - copied == 2 * x.nbytes
        assert rel_err(y, fn(x.cpu(), axes=(0, 1)).to(dev)) <= lim
        assert rel_err(y, oracle_fn(x.to(torch.complex128), dim=(0, 1))) \
            <= lim


def test_fft2_on_card_runs_a_c2c_launch_and_a_column_pass(dev):
    """fft2 / ifft2 of (5, 64, 128): the row kernel over the last axis,
    then one column pass of radix 64 at stride 128 over the first, in
    place on the row kernel's result; no copy."""
    x = rand_c(5 * 64, 128, dev, seed=21).reshape(5, 64, 128)
    keep = x.clone()
    lim = bound(64) + bound(128)
    for fn, oracle_fn in ((T.fft2, torch.fft.fft2),
                          (T.ifft2, torch.fft.ifft2)):
        copied, routes = DR.copied_bytes(), DR.column_routes()
        y, ran = launches_of(lambda: fn(x))
        assert ran == {"c2c": 1, "fourstep_pass": 1}
        assert (DR.copied_bytes() - copied, DR.column_routes() - routes) \
            == (0, 1)
        assert rel_err(y, fn(x.cpu()).to(dev)) <= lim
        assert rel_err(y, oracle_fn(x.to(torch.complex128))) <= lim
    assert torch.equal(x, keep)


@pytest.mark.parametrize("m,exact", [(4096, False), (4096, True),
                                     (16384, False)])
def test_column_passes_match_plain_and_torch_fft2(dev, m, exact):
    """The column route over the first axis of an (m, m) grid (two passes,
    64 x 64 or 128 x 128, the first twiddled blind to the column; one
    launch in fp32, the fused column launch, two in "exact"), both
    directions, in place on an owned input and not: against the passes'
    plain version on the card and float64 torch.fft; "exact" within one
    ulp(max|X|).  Then fft2 of the grid against torch.fft.fft2."""
    n = m * m
    x = rand_c(m, m, dev, seed=m % 1009)
    keep = x.clone()
    plan = FF.column_plan(m, m, exact=True)
    assert [p.radix for p in plan] == list(FF.radices(m, 2))
    assert len(FF.column_plan(m, m, exact)) == (2 if exact else 1)
    x64 = x.to(torch.complex128)
    for inverse in (False, True):
        scale = 1.0 / m if inverse else 1.0
        want = (torch.fft.ifft(x64, dim=0) if inverse
                else torch.fft.fft(x64, dim=0))
        plain = huge_plain(x.reshape(1, n), n, plan, inverse, scale, exact)
        for own in (False, True):
            src = x.reshape(1, n).clone() if own else x.reshape(1, n)
            got = FF.run_columns(src, m, m, inverse=inverse, scale=scale,
                                 exact=exact, own=own)
            torch.cuda.synchronize()
            assert got is not src and got.shape == (1, n)
            assert rel_err(got, plain) <= bound(m)
            assert rel_err(got.view(m, m), want) <= bound(m)
            if exact:
                top = want.abs().max().item()
                assert max_err(got.view(m, m), want) <= ulp(top)
            del got, src
        del want, plain
    assert torch.equal(x, keep)
    if not exact:
        y = T.fft2(x)
        assert rel_err(y, torch.fft.fft2(x64)) <= 2 * bound(m)


def test_column_route_on_a_3d_grid(dev):
    """fftn of a (B, M, K) = (32, 4096, 64) grid in three axis orders: the
    row kernel over the last axis, then the column routes over the middle
    (two passes at stride 64 in one launch, the fused column launch) and
    the first (one pass at stride 2^18); against the same call on the CPU
    copy and float64 torch.fft.fftn."""
    x = rand_c(32 * 4096, 64, dev, seed=31).reshape(32, 4096, 64)
    lim = bound(32) + bound(4096) + bound(64)
    for axes in ((0, 1, 2), (1, 0, 2), (2, 1, 0)):
        y, ran = launches_of(lambda: T.fftn(x, axes=axes))
        assert ran == {"c2c": 1, "fourstep_pass": 2}
        assert rel_err(y, T.fftn(x.cpu(), axes=axes).to(dev)) <= lim
        assert rel_err(y, torch.fft.fftn(x.to(torch.complex128), dim=axes)) \
            <= lim


def test_an_imaging_step_copies_nothing(dev):
    """ifft2 then fft2 of a 4096^2 grid, the benchmark's imaging step at a
    sixteenth of its size: 2 c2c launches and 2 of the pass kernel (the
    fused column launch), two column routes, no byte copied; the round
    trip returns the grid."""
    x = rand_c(4096, 4096, dev, seed=41)
    copied, routes = DR.copied_bytes(), DR.column_routes()
    grid, ran = launches_of(lambda: T.fft2(T.ifft2(x, norm="backward")))
    assert ran == {"c2c": 2, "fourstep_pass": 2}
    assert (DR.copied_bytes() - copied, DR.column_routes() - routes) == (0, 2)
    assert rel_err(grid, x) <= 4 * bound(4096)


# the fused column launch through the N-D calls: (call, shape, axes) at
# every M it is instantiated for (4096, 8192, 16384), square and not, a
# batch of grids, the leading axis of a 3-D grid
FUSED_COLUMN_CALLS = [
    ("fft2", (4096, 4096), None), ("ifft2", (8192, 8192), None),
    ("fft2", (16384, 16384), None), ("ifft2", (16384, 256), None),
    ("fft2", (4096, 8192), None), ("ifft2", (8192, 64), None),
    ("fft2", (3, 4096, 128), (1, 2)), ("ifft2", (2, 16384, 32), (1, 2)),
    ("fftn", (16384, 32, 32), None), ("ifftn", (4096, 32, 64), None),
    ("fftn", (8192, 4, 128), (0,)), ("ifftn", (2, 8192, 64), (1,))]


def _fused_column_call(name, x, axes):
    fn = getattr(T, name)
    return fn(x) if axes is None else fn(x, axes=axes)


@pytest.mark.parametrize("name,shape,axes", FUSED_COLUMN_CALLS)
def test_fused_column_launch_through_the_nd_calls(dev, monkeypatch, name,
                                                  shape, axes):
    """Each leading axis of M > 2048 with a slab of columns at its stride
    runs as one launch of the pass kernel (``run_columns.fused`` counted
    once a route); the result is the two launches' bit for bit (the same
    arithmetic) and float64 torch.fft's within the summed bound; a second
    call (the device words' next epoch) gives the same; the waits are read
    after a synchronize."""
    n_last = shape[-1]
    x = rand_c(math.prod(shape) // n_last, n_last, dev,
               seed=sum(shape) % 997).reshape(shape)
    dims = tuple(range(x.dim())) if axes is None else axes
    fused0 = DR.column_fused()
    y, ran = launches_of(lambda: _fused_column_call(name, x, axes))
    lead = [a for a in dims if a != x.dim() - 1]
    fused = [a for a in lead if x.shape[a] > 2048]
    assert DR.column_fused() - fused0 == len(fused) >= 1
    assert ran.get("fourstep_pass") == len(lead)
    again = _fused_column_call(name, x, axes)
    # the column route's plans as two launches (the "exact" tier's plan at
    # the fp32 tier)
    plan = FF.column_plan
    monkeypatch.setattr(FF, "column_plan",
                        lambda m, k, exact=False: plan(m, k, True))
    two = _fused_column_call(name, x, axes)
    torch.cuda.synchronize()
    assert torch.equal(y, again) and torch.equal(y, two)
    oracle = getattr(torch.fft, name)
    want = oracle(x.to(torch.complex128), dim=dims)
    assert rel_err(y, want) <= sum(bound(x.shape[a]) for a in dims)
    assert FF.column_waits() >= 0


def test_fused_column_launch_replays_in_a_cuda_graph(dev):
    """ifft2 of a 4096^2 grid captured in a CUDA graph on a stream after
    one warm-up, replayed on new grids with an eager call on the same
    stream (the same device words) between: each replay equals the eager
    call bit for bit, since the launch keeps its epoch and its ticket on
    the device."""
    x = rand_c(4096, 4096, dev, seed=25)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        T.ifft2(x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        out = T.ifft2(x)
    for seed in (26, 27):
        with torch.cuda.stream(s):
            x.copy_(rand_c(4096, 4096, dev, seed=seed))
            graph.replay()
            got = out.clone()
            eager = T.ifft2(x)
        torch.cuda.synchronize()
        assert torch.equal(got, eager)
        want = torch.fft.ifft2(x.to(torch.complex128))
        assert rel_err(got, want) <= 2 * bound(4096)


@pytest.mark.parametrize("shape", [(4096, 4096), (16384, 64)])
def test_exact_column_route_keeps_two_launches(dev, shape):
    """The "exact" tier keeps the two launches and their complex128
    intermediate (no fused launch counted), within one ulp(max|X|) of
    float64."""
    x = rand_c(*shape, dev, seed=shape[1] % 991)
    fused0 = DR.column_fused()
    y, ran = launches_of(lambda: T.fftn(x, axes=(0,), precision="exact"))
    assert ran == {"fourstep_pass": 2}
    assert DR.column_fused() == fused0
    want = torch.fft.fft(x.to(torch.complex128), dim=0)
    assert max_err(y, want) <= ulp(want.abs().max().item())


def test_fused_column_launch_registers(dev):
    """ptxas's report names the fused column launch's three instantiations
    (``<RA,RB,cols>``: 64 x 64, 128 x 64, 128 x 128), fp32 alone, and
    leaves the plain, split and tail instantiations' lines as they were."""
    _cuda.library()
    got = [ln for ln in _cuda.register_report() if ",cols>" in ln]
    assert sorted(ln.split(" fp32")[0] for ln in got) == sorted(
        f"fourstep_pass_kernel<{a},{b},cols>"
        for a, b in FF.COLUMN_PAIRS)
    tail = [ln for ln in _cuda.register_report() if ",tail>" in ln]
    assert tail == ["fourstep_pass_kernel<128,128,split,tail> fp32: 128 "
                    "registers, 0 bytes of spill stores"]


def test_rfft_large_launches_carry_tw_lo_one(dev, monkeypatch):
    """Every launch of the periodicity search's ``rfft_large`` (pass 1 and
    the fused tail at 2^23) hands the C entry tw_lo = 1, so its twiddle
    mask is tw_s - 1 as before the column route, and two calls agree bit
    for bit."""
    entry = _cuda.bound(_cuda.FOURSTEP_PASS)
    seen = []

    def recording(*args):
        seen.append(args[19])  # tw_lo, after tw_s
        return entry(*args)
    n = 1 << 23
    x = rand_r(4, n, dev, seed=23)
    monkeypatch.setattr(_cuda.FOURSTEP_PASS, "fn", recording)
    y = api.rfft_large(x, precision="highest")
    monkeypatch.setattr(_cuda.FOURSTEP_PASS, "fn", entry)
    again = api.rfft_large(x, precision="highest")
    torch.cuda.synchronize()
    assert seen == [1, 1]
    assert torch.equal(y, again)


@pytest.mark.parametrize("tw_lo", [3, 128])
def test_the_pass_entry_refuses_a_tw_lo_it_cannot_take(dev, tw_lo):
    """tw_lo must be a power of two no larger than tw_s."""
    n = 1 << 12
    x = rand_c(2, n, dev, seed=7)
    p = FF.Pass(64, ("col", 64), ("col", 64), 64, True, tw_lo=tw_lo)
    with pytest.raises(RuntimeError, match="fourstep pass launch"):
        FF.launch_pass(x, x.clone(), n, p)


def test_rfft2_irfft2_on_card(dev):
    """rfft2: one r2c launch and one c2c; irfft2: one c2c and one c2r
    (6 images: the 64-point C2C axis packs 2 transforms a row)."""
    x = rand_r(6 * 64, 256, dev, seed=22).reshape(6, 64, 256)
    lim = bound(64) + bound(256)
    spec, ran = launches_of(lambda: T.rfft2(x))
    assert ran == {"r2c": 1, "c2c": 1}
    assert rel_err(spec, T.rfft2(x.cpu()).to(dev)) <= lim
    assert rel_err(spec, torch.fft.rfft2(x.double())) <= lim
    back, ran = launches_of(lambda: T.irfft2(spec))
    assert ran == {"c2c": 1, "c2r": 1}
    assert rel_err(back, T.irfft2(spec.cpu()).to(dev)) <= lim
    assert rel_err(back, x) <= 2 * lim


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_hfft_ihfft_on_card(dev, norm):
    """hfft: one c2r launch; ihfft: one r2c launch (37 rows)."""
    h = rand_c(37, 129, dev, seed=23)
    y, ran = launches_of(lambda: T.hfft(h, norm=norm))
    assert ran == {"c2r": 1}
    assert rel_err(y, T.hfft(h.cpu(), norm=norm).to(dev)) <= bound(256)
    assert rel_err(y, torch.fft.hfft(h.to(torch.complex128), norm=norm)) \
        <= bound(256)
    x = rand_r(37, 256, dev, seed=24)
    z, ran = launches_of(lambda: T.ihfft(x, norm=norm))
    assert ran == {"r2c": 1}
    assert rel_err(z, torch.fft.ihfft(x.double(), norm=norm)) <= bound(256)


# (function, type, n, the kernel it launches once, that kernel's length)
DCT_CARD_CASES = [
    ("dct", 1, 1025, "r2c", 2048), ("dct", 2, 1024, "r2c", 1024),
    ("dct", 3, 1024, "c2r", 1024), ("dct", 4, 512, "c2c", 1024),
    ("idct", 2, 1024, "c2r", 1024), ("idct", 3, 1024, "r2c", 1024),
    ("dst", 1, 1023, "r2c", 2048), ("dst", 2, 1024, "r2c", 1024),
    ("dst", 3, 1024, "c2r", 1024), ("dst", 4, 512, "c2c", 1024),
    ("idst", 1, 1023, "r2c", 2048), ("idst", 4, 512, "c2c", 1024),
]


@pytest.mark.parametrize("name,t,n,kernel,m", DCT_CARD_CASES)
@pytest.mark.parametrize("norm", [None, "ortho"])
def test_dct_on_card_runs_one_kernel(dev, name, t, n, kernel, m, norm):
    """Each DCT / DST type is one launch of the kernel its recipe names
    (type 1 and 2 forward: R2C; type 3 and the type 2 inverse: C2R; type
    4: C2C of length 2n), on 37 rows; against the plain version on the
    CPU copy and the plain version in float64, within bound(m)."""
    x = rand_r(37, n, dev, seed=25 + t)
    fn = getattr(T, name)
    y, ran = launches_of(lambda: fn(x, type=t, norm=norm))
    assert ran == {kernel: 1}
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert rel_err(y, fn(x.cpu(), type=t, norm=norm).to(dev)) <= bound(m)
    want = fn(x.cpu().double(), type=t, norm=norm)
    assert rel_err(y.cpu(), want) <= bound(m)


def test_dctn_on_card_runs_one_r2c_an_axis(dev):
    x = rand_r(64, 256, dev, seed=31)
    y, ran = launches_of(lambda: T.dctn(x, axes=(-2, -1)))
    assert ran == {"r2c": 2}
    want = T.dctn(x.cpu().double(), axes=(-2, -1))
    assert rel_err(y.cpu(), want) <= bound(64) + bound(256)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float16])
@pytest.mark.parametrize("entry", ["rfft", "convolve_real", "fftconvolve"])
def test_real_entry_promotes_on_card(dev, entry, dtype):
    """C.4 on the card: int32 and float16 rows give exactly the result of
    their float32 copy (the kernels are deterministic)."""
    x = (rand_r(4, 1024, dev, seed=41) * 20).to(dtype)
    extra = {"rfft": (),
             "convolve_real": (T.rfft(rand_r(1, 1024, dev, seed=42))[0],),
             "fftconvolve": (rand_r(1, 33, dev, seed=43)[0],)}[entry]
    fn = getattr(T, entry)
    got = fn(x, *extra)
    f32 = fn(x.to(torch.float32), *extra)
    torch.cuda.synchronize()
    assert got.dtype == f32.dtype
    assert torch.equal(got, f32)


def test_real_kernel_operand_check_still_raises(dev):
    """The promotion is at the entry points: the R2C wrapper itself keeps
    refusing anything but float32."""
    for dtype in (torch.int32, torch.float16):
        with pytest.raises(TypeError, match="float32"):
            R.launch_r2c(torch.zeros((4, 256), dtype=dtype, device=dev))


# ---------------------------------------------------------------------------
# parallel/ on the card: a world of one under NCCL in this process, and a
# 2-rank gloo world spawned on cuda:0 (NCCL takes one rank a card)
# ---------------------------------------------------------------------------

from smfft_tpu_torch import parallel as TP  # noqa: E402
from smfft_tpu_torch.parallel import sharding as TPS  # noqa: E402


@pytest.fixture(scope="module")
def nccl_one():
    """A process group of one rank under NCCL (tcp rendezvous on a free
    localhost port), destroyed after this module's parallel tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    yield TP.batch_mesh(), TP.batch_mesh(axis_name="fft")
    dist.destroy_process_group()


@pytest.mark.parametrize("name", ["fft", "ifft", "rfft", "irfft",
                                  "convolve", "convolve_bank"])
def test_parallel_sharded_on_card_world_of_one(nccl_one, name):
    """sharded_* under NCCL: one launch of its kernel, the shard on the
    card, every element equal to the plain version of the same rows."""
    mesh, _ = nccl_one
    x = rand_c(64, 1024, "cuda", seed=51)
    xr = rand_r(64, 1024, "cuda", seed=52)
    hb = rand_c(3, 1024, "cuda", seed=53)
    spec = api.rfft(xr)
    call, kernel, ref = {
        "fft": (lambda: TP.sharded_fft(x, mesh), "c2c",
                lambda: api.fft(x.cpu())),
        "ifft": (lambda: TP.sharded_fft(x, mesh, inverse=True), "c2c",
                 lambda: api.ifft(x.cpu())),
        "rfft": (lambda: TPS.sharded_rfft(xr, mesh), "r2c",
                 lambda: api.rfft(xr.cpu())),
        "irfft": (lambda: TPS.sharded_irfft(spec, mesh, 1024), "c2r",
                  lambda: api.irfft(spec.cpu(), 1024)),
        "convolve": (lambda: TP.sharded_convolve(x, hb[0], mesh), "conv",
                     lambda: api.convolve(x.cpu(), hb[0].cpu())),
        "convolve_bank": (lambda: TP.sharded_convolve(x, hb, mesh), "conv",
                          lambda: api.convolve(x.cpu(), hb.cpu())),
    }[name]
    y, ran = launches_of(call)
    assert ran == {kernel: 1}
    local = y.to_local()
    assert local.device.type == "cuda" and y.device_mesh.size() == 1
    want = ref()
    assert local.shape == want.shape
    assert max_err(local.cpu(), want) <= bound(1024)


@pytest.mark.parametrize("n", [1 << 15, 1 << 20])
def test_parallel_distributed_on_card_world_of_one(nccl_one, n):
    """distributed_fft / ifft (natural, transposed, the C-layout round
    trip) and distributed_rfft / irfft under NCCL: two c2c launches a
    C2C, no other kernel, within the bound of float64 torch.fft."""
    _, fmesh = nccl_one
    x = rand_c(1, n, "cuda", seed=54)[0]
    want = torch.fft.fft(x.to(torch.complex128))
    y, ran = launches_of(lambda: TP.distributed_fft(x, fmesh))
    assert ran == {"c2c": 2}
    assert max_err(y.full_tensor(), want) <= bound(n)
    c, ran = launches_of(lambda: TP.distributed_fft(
        x, fmesh, transposed_output=True))
    assert ran == {"c2c": 2}
    n1, n2 = TP.plan_distributed(n, 1)
    assert max_err(c.full_tensor(), want.reshape(n2, n1).T) <= bound(n)
    back, ran = launches_of(lambda: TP.distributed_ifft(
        c, fmesh, transposed_input=True))
    assert ran == {"c2c": 2}
    assert max_err(back.full_tensor(), x) <= 2 * bound(n) * 2 ** 0.5 / n ** 0.5
    xr = rand_r(2, 2 * n, "cuda", seed=55)
    h, ran = launches_of(lambda: TP.distributed_rfft(xr, fmesh))
    assert ran == {"c2c": 2}
    hw = torch.fft.rfft(xr.double())
    hp = h.full_tensor()
    assert max_err(hp[:, 1:], hw[:, 1:-1]) <= bound(2 * n)
    assert max_err(hp[:, 0], torch.complex(hw[:, 0].real, hw[:, -1].real)) \
        <= bound(2 * n)
    r, ran = launches_of(lambda: TP.distributed_irfft(h, fmesh))
    assert ran == {"c2c": 2}
    assert max_err(r.full_tensor(), xr) <= 2 * bound(2 * n) / n ** 0.5


def test_parallel_gloo_ranks_on_one_card(tmp_path):
    """Two gloo ranks spawned on cuda:0: the shards on the card, the
    exchanges through gloo, each rank two c2c launches a distributed C2C,
    the outputs within the bound of float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    n = 1 << 20
    calls = [dict(key="fft", fn="distributed_fft",
                  args=[("rand", (n,), "complex64", 5), "MESH"]),
             dict(key="back", fn="distributed_ifft",
                  args=[("ref", "fft"), "MESH"]),
             dict(key="rfft", fn="distributed_rfft",
                  args=[("rand", (2, n), "float32", 6), "MESH"]),
             dict(key="sharded", fn="sharded_fft", axis="batch",
                  args=[("rand", (64, 1024), "complex64", 7), "MESH"])]
    ranks = DR.spawn_world(2, DR.run_calls, (calls, "cuda"), device="cuda",
                           workdir=str(tmp_path), timeout=300)
    for r in ranks:
        assert r["counts"]["c2c"] == 2 * 3 + 1
        assert sum(r["counts"].values()) == r["counts"]["c2c"]
        assert all(rec["local_device"] == "cuda" and rec["mesh_size"] == 2
                   for rec in r["calls"].values())
    got = ranks[0]["calls"]
    x = torch.from_numpy(DR.rand_input((n,), "complex64", 5))
    assert max_err(torch.from_numpy(got["fft"]["full"]),
                   torch.fft.fft(x.to(torch.complex128))) <= bound(n)
    assert max_err(torch.from_numpy(got["back"]["full"]), x) \
        <= 2 * bound(n) * 2 ** 0.5 / n ** 0.5
    xr = torch.from_numpy(DR.rand_input((2, n), "float32", 6)).double()
    hp = torch.from_numpy(got["rfft"]["full"])
    assert max_err(hp[:, 1:], torch.fft.rfft(xr)[:, 1:-1]) <= bound(n)


def test_parallel_matched_filter_example_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    import matched_filter_torch
    before = DR.counts()
    assert matched_filter_torch.main(
        ["--streams", "64", "--length", "4096", "--selfcheck"]) == 0
    after = DR.counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"r2c": 1, "conv_real": 1}


def test_an_acceleration_plane_of_the_published_bank(dev):
    """``accel_plane`` of 2 trials of 2^20 samples at zmax 200 (201
    templates of 233 taps, segments of 2048): one launch of the bank's
    plane form at m = 201, held against the plain
    reference's direct correlation in float64.  max |got - want| /
    rms(want) reads 1.2-1.4e-05 at 2^23 samples on the card (the fp32
    spectrum's error, then the bank's transforms); 5e-5 leaves room above
    that, and bfloat16 storage of the spectrum reads 2e-2 or more."""
    from smfft_tpu_torch import accel
    from smfft_tpu_torch.reference import accel_search as ref
    g = torch.Generator(device=dev).manual_seed(22)
    x = torch.rand((2, 1 << 20), generator=g, device=dev) * 2 - 1
    spec = api.rfft_large(x)
    before = DR.counts()
    plane = accel.accel_plane(spec)
    torch.cuda.synchronize()
    after = DR.counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"conv_plane": 1}
    assert plane.shape == (2, 201, (1 << 19) + 1)
    want = ref.plane(ref.spectrum(x), 200, 2)
    rms = want.square().mean().sqrt()
    assert ((plane.double() - want).abs().max() / rms).item() < 5e-5


# the plane form's tolerance: ``test_torch_accel.TOL``, max |got - want| /
# rms(want) over a plane
PLANE_TOL = 5e-5


def _plane_err(got, want):
    want = want.double()
    return ((got.double() - want).abs().max() / want.square().mean().sqrt()
            ).item()


@pytest.mark.parametrize("zmax,samples,rows,precision,dtype", [
    (8, 1 << 16, 2, None, torch.complex64),
    (8, 1 << 16, 2, "exact", torch.complex64),
    (30, 1 << 16, 2, None, torch.complex64),
    (30, 1 << 16, 2, "exact", torch.complex64),
    (200, 1 << 16, 2, None, torch.complex64),
    (200, 1 << 16, 2, "exact", torch.complex64),
    (30, 256, 3, None, torch.complex64),       # 129 bins, one segment of 512
    (200, 2000, 2, "exact", torch.complex64),  # 1001 bins under 2048
    (8, 2 * (216 * 40 - 1), 2, None, torch.complex64),  # L = 40 hops
    (8, 2 * 216 * 40, 2, None, torch.complex64),        # one bin more
    (30, 1 << 15, 1, None, torch.complex64),   # a single trial, (L,) in
    (8, 1 << 15, 2, None, torch.complex128),
])
def test_the_plane_form_matches_the_reference_and_the_cpu_path(
        dev, zmax, samples, rows, precision, dtype):
    """``accel_plane`` of a CUDA spectrum: one ``conv_plane`` launch, no
    ``conv``, held against the float64 reference's direct correlation and
    the CPU path (framing, the plain bank, crop and power) on the same
    spectrum.  zmax 8 / 30 / 200 take segments of 256 / 512 / 2048 (hop
    216 / 450 / 1816)."""
    from smfft_tpu_torch import accel
    from smfft_tpu_torch.reference import accel_search as ref
    g = torch.Generator(device=dev).manual_seed(samples + zmax + rows)
    x = torch.rand((rows, samples), generator=g, device=dev,
                   dtype=torch.float64) * 2 - 1
    spec = ref.spectrum(x)
    arg = spec.to(dtype)
    if rows == 1:
        arg = arg[0]
    before = DR.counts()
    plane = accel.accel_plane(arg, zmax=zmax, precision=precision)
    torch.cuda.synchronize()
    after = DR.counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"conv_plane": 1}
    m, bins = zmax + 1, samples // 2 + 1
    want_shape = (m, bins) if rows == 1 else (rows, m, bins)
    assert plane.shape == want_shape and plane.dtype == torch.float32
    plane = plane.reshape(rows, m, bins)
    assert _plane_err(plane, ref.plane(spec, zmax, 2)) < PLANE_TOL
    cpu = accel.accel_plane(arg.cpu(), zmax=zmax, precision=precision)
    assert _plane_err(plane.cpu(), cpu.reshape(rows, m, bins)) < PLANE_TOL


def test_the_plane_form_does_not_spill(dev):
    """ptxas's report: the fp32 plane form at n = 256..8192 spills
    nothing, and the bank form it sits beside keeps its 120 registers at
    2048."""
    _cuda.library()
    report = _cuda.register_report()
    plane = [ln for ln in report if ln.startswith("conv_plane_kernel<")
             and " fp32:" in ln and int(ln.split("<")[1].split(">")[0])
             <= 8192]
    assert len(plane) == 6, report
    assert all(ln.endswith(" 0 bytes of spill stores") for ln in plane), \
        plane
    assert "conv_kernel<2048,bank> fp32: 120 registers, 0 bytes of spill " \
        "stores" in report


@pytest.mark.parametrize("m", [1, 201])
def test_the_bank_at_the_plane_forms_shape_matches_plain_and_oracle(dev, m):
    """``api.convolve`` of 37 rows of 2048 points against the published
    bank's 201 responses (and one): the bank form runs ``bank_loop``, the
    loop it shares with the plane form.  Every filter's rows against the
    plain version and float64 torch.fft within bound(n)."""
    n, b = 2048, 37
    x = rand_c(b, n, dev, seed=23)
    h = rand_c(m, n, dev, seed=24)
    got = api.convolve(x, h if m > 1 else h[0]).reshape(m, b, n)
    hs = h / n
    plain = torch.complex(*CV.conv_plain(x.real, x.imag, hs.real, hs.imag))
    want = torch.fft.ifft(torch.fft.fft(x.to(torch.complex128))[None]
                          * h.to(torch.complex128)[:, None])
    torch.cuda.synchronize()
    assert max_err(got, plain) < bound(n)
    assert max_err(got, want) < bound(n)


def test_each_launch_runs_one_kernel_of_its_declared_name(dev):
    """Under ``torch.profiler`` (CUDA activity), one call reaching each
    kernel entry: every counted launch is exactly one device operation named
    ``<function><template arguments>`` by its entry's declared
    ``__global__``, and the launch spans in start order name the port's
    kernels in start order (the benchmark's idle split ties them so)."""
    from smfft_tpu_torch import accel, trace
    n = 1024
    x, xr = rand_c(4, n, dev, seed=1), rand_r(4, n, dev, seed=2)
    half = rand_r(4, n // 2, dev, seed=3), rand_r(4, n // 2, dev, seed=4)
    x100 = rand_c(4, 100, dev, seed=5)
    big = rand_c(2, 1 << 15, dev, seed=6)
    hr, hi = planar.rfft_large(rand_r(2, 1 << 16, dev, seed=7))
    spec = torch.fft.rfft(rand_r(1, 1 << 16, dev, seed=8))
    ones = torch.ones(1, n, dtype=torch.complex64, device=dev)
    calls = {
        "c2c": lambda: C.launch(x),
        "r2c": lambda: R.launch_r2c(xr),
        "c2r": lambda: R.launch_c2r(*half, n=n),
        "c2c_multiple": lambda: M.launch_multiple(x, loops=2),
        "real_multiple": lambda: M.launch_real_multiple(xr, 1),
        "conv": lambda: CV.launch_conv(x, h=ones),
        "conv_real": lambda: CV.launch_conv_real(xr, h=ones[:, :n // 2]),
        "power": lambda: SP.launch_power(xr),
        "bluestein": lambda: CH.launch_bluestein(x100, n=100, m=256),
        "fourstep_pass": lambda: T.fft_large(big),
        "real_huge": lambda: planar.irfft_large(hr, hi),
        "conv_plane": lambda: accel.accel_plane(spec, zmax=8),
    }
    assert set(calls) == set(_cuda.KERNELS)
    for fn in calls.values():     # the tables, plans and banks, built once
        fn()
    torch.cuda.synchronize()
    before = DR.counts()
    act = torch.profiler.ProfilerActivity
    trace.start()
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
    rec = trace.stop()
    after = DR.counts()
    launched = {k: after[k] - before[k] for k in after}
    assert all(launched[k] >= 1 for k in calls), launched
    cuda = torch.autograd.DeviceType.CUDA
    ops = sorted((e.start_ns(), e.name().removeprefix("void ").replace(
        "(anonymous namespace)::", ""))
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == cuda)
    functions = [e.function for e in _cuda.KERNELS.values()]
    for k, e in _cuda.KERNELS.items():
        ran = [name for _, name in ops if name.startswith(e.function + "<")]
        assert len(ran) == launched[k], (k, ran, launched[k])
    port = [name for _, name in ops
            if any(name.startswith(f + "<") for f in functions)]
    spans = sorted((int(rec.start[i]), rec.names[rec.name[i]])
                   for i in range(len(rec))
                   if rec.names[rec.name[i]].startswith("launch:"))
    assert len(spans) == len(port) == sum(launched.values())
    for (_, span), name in zip(spans, port):
        assert name.startswith(_cuda.LAUNCHED[span] + "<"), (span, name)
