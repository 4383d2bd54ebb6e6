"""The huge-N transforms of smfft_tpu_torch (ops/fourstep.py,
fourstep_fused.py, rowfour.py, hugefft.py, real_fused.py; api / planar
``*_large``) on the CPU, where every kernel runs as its plain version.

Inputs come from a numpy seed and go through both packages: the JAX
package's Pallas kernels in interpret mode at the smallest size of each
plan (as tests/test_fourstep.py runs them), its ``backend="xla"`` four-step
where interpret mode is slow, and float64 numpy.  Tolerances: relative
error against numpy < 2e-6 (the JAX tests' bar), absolute error within
2e-7 N^0.75 8 (the bound the TPU kernels met), and the port-vs-JAX
difference within the sum of both packages' errors against numpy.  The
card's own tests are in tests/test_torch_cuda.py (``cuda`` marker).
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smfft_tpu as S
import smfft_tpu_torch as T
from smfft_tpu.ops import fourstep as JFS
from smfft_tpu_torch.ops import _cuda
from smfft_tpu_torch.ops import c2c as C
from smfft_tpu_torch.ops import fourstep as FS
from smfft_tpu_torch.ops import fourstep_fused as FF
from smfft_tpu_torch.ops import hugefft, rowfour
from smfft_tpu_torch.ops import real as R
from smfft_tpu_torch.ops import real_fused as RF


@pytest.fixture
def interpret():
    import smfft_tpu.ops.pallas_c2c as PC
    PC.set_interpret(True)
    try:
        yield
    finally:
        PC.set_interpret(False)


def bound(n):
    return 2e-7 * n ** 0.75 * 8


def rel(got, want):
    want = np.asarray(want, np.complex128)
    return np.abs(np.asarray(got, np.complex128) - want).max() / \
        np.abs(want).max()


def err(a, b):
    return float(np.abs(np.asarray(a, np.complex128)
                        - np.asarray(b, np.complex128)).max())


def planes(b, n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((b, n)) - 0.5).astype(np.float32),
            (rng.random((b, n)) - 0.5).astype(np.float32))


def agree(port, jax_out, want, n):
    """Both within the bound of float64 and of each other."""
    e_p, e_j = err(port, want), err(jax_out, want)
    assert rel(port, want) < 2e-6 and e_p < bound(n)
    assert err(port, jax_out) <= e_p + e_j


def cplx(o):
    return np.asarray(o[0]) + 1j * np.asarray(o[1])


# ---------------------------------------------------------------------------
# Sizes, factors, exact twiddles.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1 << 10, 1 << 20, 1 << 21, 1 << 28])
def test_split_factors_match_jax(n):
    assert FS.split_factors(n) == JFS.split_factors(n)


@pytest.mark.parametrize("n", [3 << 20, 1 << 29, 512])
def test_split_factors_errors_match_jax(n):
    with pytest.raises(ValueError, match="Error wrong FFT length!") as e:
        FS.split_factors(n)
    with pytest.raises(ValueError) as ej:
        JFS.split_factors(n)
    assert str(e.value) == str(ej.value)


@pytest.mark.parametrize("n", [32, 1 << 30, 3 << 20])
def test_real_size_errors_match_jax(n):
    with pytest.raises(ValueError) as e:
        FS._check_real_n(n)
    with pytest.raises(ValueError) as ej:
        JFS._check_real_n(n)
    assert str(e.value) == str(ej.value)


@pytest.mark.parametrize("n", [1 << 15, 1 << 28])
@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_tables_bit_identical_to_jax(n, inverse):
    for a, b in zip(FS._twiddle_tables(n, inverse),
                    JFS._twiddle_tables(n, inverse)):
        assert np.array_equal(a, b)
    wr, wi = FS._half_root_planar(1 << 16, inverse)
    jr, ji = JFS._half_root_planar(1 << 16, inverse)
    assert err(wr.numpy() + 1j * wi.numpy(),
               np.asarray(jr) + 1j * np.asarray(ji)) < 2e-7


def test_twiddle_rows_exact_modular():
    """Integer exponent reduction at an N where fp32 angles lose ~8 bits
    (tests/test_fourstep.py's case)."""
    n = 1 << 26
    rows = torch.tensor([0, 1, 12345, (1 << 20) - 1])
    got = FS.twiddle_rows(torch.ones((4, 512), dtype=torch.complex64), rows,
                          n, False)
    k = np.arange(512, dtype=np.float64)
    want = np.exp(-2j * np.pi * (rows.numpy()[:, None] * k) / n)
    assert err(got, want) < 1e-6


# ---------------------------------------------------------------------------
# Against the Pallas kernels in interpret mode.
# ---------------------------------------------------------------------------


def test_rowfour_matches_jax(interpret):
    """B17 at 2^15: forward, scaled inverse, odd batch 9."""
    from smfft_tpu.ops import rowfour as JRF
    n = 1 << 15
    xr, xi = planes(9, n, 1)
    want = np.fft.fft(xr.astype(np.float64) + 1j * xi)
    o = rowfour.fft_rowfour_planar(torch.from_numpy(xr), torch.from_numpy(xi))
    j = JRF.fft_rowfour_planar(jnp.array(xr), jnp.array(xi))
    agree(cplx(o), cplx(j), want, n)
    back = rowfour.fft_rowfour_planar(*o, inverse=True, scale=1.0 / n)
    assert err(cplx(back), xr + 1j * xi) < 1e-5


def test_rowfour_multiple_iters_matches_jax(interpret):
    """multiple_iters = 2 applies the transform twice: N x[-t]."""
    from smfft_tpu.ops import rowfour as JRF
    n = 1 << 15
    xr, xi = planes(2, n, 2)
    x = xr.astype(np.float64) + 1j * xi
    want = np.fft.fft(np.fft.fft(x))
    o = rowfour.fft_rowfour_planar(torch.from_numpy(xr), torch.from_numpy(xi),
                                   multiple_iters=2)
    j = JRF.fft_rowfour_planar(jnp.array(xr), jnp.array(xi),
                               multiple_iters=2)
    e_p, e_j = err(cplx(o), want), err(cplx(j), want)
    assert rel(cplx(o), want) < 4e-6
    assert err(cplx(o), cplx(j)) <= e_p + e_j


def test_fourstep_fused_and_pass1_match_jax(interpret):
    """B22/B23 at 2^18 (factors 512 x 512), the pass-1 intermediate too."""
    from smfft_tpu.ops import fourstep_fused as JFF
    n1 = n2 = 512
    n = n1 * n2
    xr, xi = planes(2, n, 3)
    o = FF.fft_large_planar(torch.from_numpy(xr), torch.from_numpy(xi),
                            factors=(n1, n2))
    j = JFF.fft_large_planar(jnp.array(xr), jnp.array(xi))
    agree(cplx(o), cplx(j), np.fft.fft(xr.astype(np.float64) + 1j * xi), n)
    # Bmat[b, t2, k1] = W_N^(t2 k1) DFT_n1 over t1 of x[b, t1 n2 + t2]
    br, bi = FF.large_pass1_planar(torch.from_numpy(xr),
                                   torch.from_numpy(xi), n1, n2)
    f1 = [jnp.asarray(t) for t in JFF._twiddle_split_tables(n, n1, n2,
                                                            False)]
    jbr, jbi = JFF._build_pass1(n, n1, n2, JFF._pass_tile(n1, n2), False,
                                "highest")(
        jnp.array(xr.reshape(-1, n2)), jnp.array(xi.reshape(-1, n2)), *f1)
    a = (xr.astype(np.float64) + 1j * xi).reshape(2, n1, n2)
    k = np.arange(n1)
    want = (np.fft.fft(a, axis=1).transpose(0, 2, 1)
            * np.exp(-2j * np.pi * np.arange(n2)[:, None] * k / n)
            ).reshape(-1, n1)
    agree(cplx((br, bi)), cplx((jbr, jbi)), want, n1)


@pytest.mark.parametrize("plan", ["two:revisit", "two:fold", "three"])
def test_hugefft_matches_jax_at_2_18(interpret, plan):
    """B18-B21 at the smallest size of each plan; the inverse with 1/N."""
    from smfft_tpu.ops import hugefft as JHF
    n = 1 << 18
    xr, xi = planes(2, n, 4)
    want = np.fft.fft(xr.astype(np.float64) + 1j * xi)
    o = hugefft.fft_huge_planar(torch.from_numpy(xr), torch.from_numpy(xi),
                                plan=plan)
    j = JHF.fft_huge_planar(jnp.array(xr), jnp.array(xi), plan=plan)
    agree(cplx(o), cplx(j), want, n)
    back = hugefft.fft_huge_planar(*o, inverse=True, scale=1.0 / n,
                                   plan=plan)
    assert err(cplx(back), xr + 1j * xi) < 2e-5


@pytest.mark.parametrize("mode,n", [("pair", 1 << 15), ("halfc", 1 << 16)])
def test_real_large_planar_matches_jax(interpret, mode, n):
    """B24-B26, packed planar, both modes, both directions, at the
    smallest n whose JAX transform avoids the 16384-point row kernel
    (90 s in interpret mode): 2^15 pair, 2^16 halfc."""
    from smfft_tpu.ops import real_fused as JRF
    x = planes(2, n, 5)[0]
    spec = np.fft.rfft(x.astype(np.float64))
    want = spec[:, :n // 2].copy()
    want[:, 0] = spec[:, 0].real + 1j * spec[:, -1].real
    o = RF.rfft_large_planar(torch.from_numpy(x), mode=mode)
    j = JRF.rfft_large_planar(jnp.array(x), mode=mode)
    agree(cplx(o), cplx(j), want, n)
    back = RF.irfft_large_planar(*o, n, mode=mode)
    jback = JRF.irfft_large_planar(*j, n, mode=mode)
    agree(back.numpy(), np.asarray(jback), x, n)


def test_planar_and_api_large_match_jax(interpret):
    """planar.fft_large / ifft_large and api.fft_large against the JAX
    package's (backend="pallas")."""
    n = 1 << 15
    xr, xi = planes(2, n, 6)
    x = xr + 1j * xi
    want = np.fft.fft(x.astype(np.complex128))
    o = T.planar.fft_large(torch.from_numpy(xr), torch.from_numpy(xi))
    from smfft_tpu import planar as JP
    j = JP.fft_large(jnp.array(xr), jnp.array(xi))
    agree(cplx(o), cplx(j), want, n)
    back = T.planar.ifft_large(*o)
    assert err(cplx(back), x) < 1e-5
    y = T.fft_large(torch.from_numpy(x[0].astype(np.complex64)))
    jy = S.fft_large(jnp.array(x[0].astype(np.complex64)), backend="pallas")
    agree(y.numpy(), np.asarray(jy), want[0], n)
    assert err(T.ifft_large(y).numpy(), x[0]) < 1e-5


# ---------------------------------------------------------------------------
# Against the JAX package's backend="xla" four-step and numpy.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,plan", [(1 << 21, "five"), (1 << 22, "three")])
def test_hugefft_five_and_three_pass_match_xla(n, plan):
    xr, xi = planes(1, n, 7)
    x = xr + 1j * xi
    want = np.fft.fft(x.astype(np.complex128))
    o = hugefft.fft_huge_planar(torch.from_numpy(xr), torch.from_numpy(xi),
                                plan=plan)
    j = JFS.fft_four_step(jnp.array(x.astype(np.complex64)), backend="xla")
    agree(cplx(o), np.asarray(j), want, n)


@pytest.mark.parametrize("packed", [False, True])
def test_rfft_large_matches_xla(packed):
    n = 1 << 16
    x = planes(3, n, 8)[0]
    y = T.rfft_large(torch.from_numpy(x), packed=packed)
    j = S.rfft_large(jnp.array(x), backend="xla", packed=packed)
    spec = np.fft.rfft(x.astype(np.float64))
    if packed:
        spec = spec[:, :n // 2].copy()
        spec[:, 0] = spec[:, 0].real + 1j * np.fft.rfft(x.astype(
            np.float64))[:, -1].real
    agree(y.numpy(), np.asarray(j), spec, n)
    back = T.irfft_large(y, n=n, packed=packed)
    jb = S.irfft_large(j, n=n, backend="xla", packed=packed)
    agree(back.numpy(), np.asarray(jb), x, n)


def test_spec_backend_matches_auto():
    n = 1 << 15
    xr, xi = planes(2, n, 9)
    x = torch.from_numpy(xr + 1j * xi)
    a = T.fft_large(x)
    s = T.fft_large(x, backend="spec")
    assert err(a, s) < 2 * bound(n)
    r = torch.from_numpy(xr)
    assert err(T.rfft_large(r), T.rfft_large(r, backend="spec")) < 2 * bound(n)
    assert err(T.irfft_large(T.rfft_large(r), backend="spec"), xr) < bound(n)


# ---------------------------------------------------------------------------
# Gradients.
# ---------------------------------------------------------------------------


def test_large_gradients_match_torch_fft():
    n = 1 << 15
    rng = np.random.default_rng(10)
    x = torch.from_numpy((rng.random((2, n)) - 0.5 + 1j * (
        rng.random((2, n)) - 0.5)).astype(np.complex64))
    r = torch.from_numpy((rng.random((2, n)) - 0.5).astype(np.float32))
    h = torch.fft.rfft(r.double()).to(torch.complex64)
    cases = [(T.fft_large, torch.fft.fft, x, {}),
             (T.ifft_large, torch.fft.ifft, x, {}),
             (T.rfft_large, torch.fft.rfft, r, {}),
             (T.irfft_large, torch.fft.irfft, h, {"n": n})]
    for ours, ref, v, kw in cases:
        a = v.clone().requires_grad_(True)
        (ours(a, **kw).abs() ** 2).sum().backward()
        b = v.clone().to(torch.complex128 if v.is_complex()
                         else torch.float64).requires_grad_(True)
        (ref(b, **kw).abs() ** 2).sum().backward()
        assert rel(a.grad.numpy(), b.grad.numpy()) < 1e-5, ours.__name__


def test_large_gradcheck_float64():
    """gradcheck through the huge-N autograd Functions at a small size
    (N = 1024, the smallest four-step split)."""
    from smfft_tpu_torch import api
    rng = np.random.default_rng(11)
    n = 1024
    x = torch.from_numpy(rng.random((1, n)) - 0.5 + 1j * (
        rng.random((1, n)) - 0.5)).requires_grad_(True)
    for inverse, scale in ((False, None), (True, 1.0 / n)):
        assert torch.autograd.gradcheck(
            lambda v: api._LargeC2C.apply(v, inverse, scale, False, "auto"),
            (x,), eps=1e-6, atol=1e-5, fast_mode=True)
    r = torch.from_numpy(rng.random((1, 512)) - 0.5).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda v: api._RFFTLarge.apply(v, False, "auto"), (r,), eps=1e-6,
        atol=1e-5, fast_mode=True)
    h = torch.fft.rfft(r.detach()).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda v: api._IRFFTLarge.apply(v, 512, False, "auto", 0.5), (h,),
        eps=1e-6, atol=1e-5, fast_mode=True)


def test_packed_large_layouts_refuse_backward():
    r = torch.rand((1, 1 << 15), requires_grad=True)
    with pytest.raises(NotImplementedError, match="packed"):
        T.rfft_large(r, packed=True).abs().sum().backward()


# ---------------------------------------------------------------------------
# Plumbing.
# ---------------------------------------------------------------------------


def test_size_errors_match_jax():
    from smfft_tpu.ops import hugefft as JHF
    cases = [((1, 3 * (1 << 18)), None), ((1, 1 << 16), None),
             ((1, 1 << 19), "five")]
    for shape, plan in cases:
        z = np.zeros(shape, np.float32)
        with pytest.raises(ValueError) as e:
            hugefft.fft_huge_planar(torch.from_numpy(z), torch.from_numpy(z),
                                    plan=plan)
        with pytest.raises(ValueError) as ej:
            JHF.fft_huge_planar(jnp.array(z), jnp.array(z), plan=plan)
        assert str(e.value) == str(ej.value)
    # the JAX package runs its transpose pass before this check
    with pytest.raises(ValueError, match="two-pass plan caps at N=2097152"):
        hugefft.fft_huge_planar(torch.zeros((1, 1 << 22)),
                                torch.zeros((1, 1 << 22)), plan="two:fold")
    z = torch.zeros((1, 1 << 14))
    with pytest.raises(ValueError, match="starts at 32768"):
        T.planar.rfft_large(torch.zeros((1, 128)))
    with pytest.raises(ValueError, match="rowfour supports"):
        rowfour.fft_rowfour_planar(torch.zeros((1, 1 << 18)),
                                   torch.zeros((1, 1 << 18)))
    with pytest.raises(ValueError, match="norm"):
        T.ifft_large(torch.zeros(1 << 15, dtype=torch.complex64),
                     norm="ortho")
    with pytest.raises(ValueError, match="norm"):
        T.irfft_large(torch.zeros((1 << 14) + 1, dtype=torch.complex64),
                      norm="ortho")
    with pytest.raises(ValueError, match="wrong FFT length"):
        T.fft_large(torch.zeros(3 << 15, dtype=torch.complex64))
    assert z.shape == (1, 1 << 14)


def test_row_sizes_route_to_row_functions():
    rng = np.random.default_rng(12)
    x = torch.from_numpy((rng.random((2, 1024)) + 1j * rng.random(
        (2, 1024))).astype(np.complex64))
    assert torch.equal(T.fft_large(x), T.fft(x))
    assert torch.equal(T.ifft_large(x), T.ifft(x))
    r = x.real.contiguous()
    assert torch.equal(T.rfft_large(r), T.rfft(r))
    for n in (32, 1024):
        v = torch.cat([r, r])[:, :n].contiguous()  # 4 rows: 128/32
        assert torch.equal(T.planar.fft_large(v, v)[0], T.planar.fft(v, v)[0])
    assert torch.equal(T.planar.rfft_large(r)[0], T.planar.rfft(r)[0])


def test_mode_chosen_by_padded_rows(interpret):
    """pair runs ceil(b/2) rows of n points, halfc b rows of n/2: halfc at
    b = 1 (the JAX package pads b = 1 to 16 pair rows), pair at b = 16,
    halfc at n = 2^29."""
    from smfft_tpu.ops import real_fused as JRF
    # the reference fault (ROADMAP section C): b = 1 runs 2 * 8 pair rows
    # of n points, 32x halfc's one row of n/2; both agree with numpy
    assert JRF._pair_dims(1) == (8, 8)
    n = 1 << 16
    x = planes(1, n, 14)[0]
    spec = np.fft.rfft(x.astype(np.float64))
    want = spec[:, :n // 2].copy()
    want[:, 0] = spec[:, 0].real + 1j * spec[:, -1].real
    e_j = err(cplx(JRF.rfft_large_planar(jnp.array(x))), want)
    e_p = err(cplx(RF.rfft_large_planar(torch.from_numpy(x))), want)
    print(f"b = 1, n = 2^16 vs float64: reference (pair, 16 rows) {e_j:.3e},"
          f" port (halfc, 1 row) {e_p:.3e}")
    assert max(e_j, e_p) < bound(n)
    n = 1 << 20
    assert RF.choose_mode(1, n) == "halfc"
    assert RF.choose_mode(16, n) == "pair"
    assert RF.choose_mode(3, n) == "halfc"
    assert RF.choose_mode(16, 1 << 29) == "halfc"
    with pytest.raises(ValueError, match="pair mode"):
        RF.rfft_large_rows(torch.zeros((2, 1 << 29)), mode="pair")


def _spec_layout(spec, n):
    return ("planar" if isinstance(spec, tuple) else
            "packed" if spec.shape[-1] == n // 2 else "numpy")


def _store_spec(spec, xr, xi, n):
    """Packed planar spectra into ``spec`` in its layout, its rows."""
    rows = (spec[0] if isinstance(spec, tuple) else spec).shape[0]
    out = R.to_layout(xr[:rows], xi[:rows], _spec_layout(spec, n))
    for d, s in zip(spec if isinstance(spec, tuple) else (spec,),
                    out if isinstance(out, tuple) else (out,)):
        d.copy_(s)


def _fake_launch_pass(src, dst, n, p, *, inverse=False, scale=1.0,
                      exact=False, at=None):
    dst = dst() if callable(dst) else dst
    x = torch.complex(*src) if isinstance(src, tuple) else src
    y = FF.pass_plain(x.to(torch.complex128 if exact else torch.complex64),
                      n, p, inverse, scale)
    if p.then:
        FF.launch_pass.tails += 1
    if (p.then or p).split:
        _store_spec(dst, *y, n)
        FF.launch_pass.fused += 1
    elif isinstance(dst, tuple):
        dst[0].copy_(y.real)
        dst[1].copy_(y.imag)
    else:
        dst.copy_(y)
    _cuda.FOURSTEP_PASS.count += 1
    return dst


def _fake_launch_real_huge(mode, z, spec, n, *, scale=1.0, exact=False):
    z = z() if callable(z) else z
    spec = spec() if callable(spec) else spec
    L = n // 2
    layout = _spec_layout(spec, n)
    sp = spec if isinstance(spec, tuple) else (spec, None)
    if mode.endswith("split"):
        _store_spec(spec, *(RF.pair_split_plain(z, 2 * z.shape[0])
                            if mode == "pair_split"
                            else RF.halfc_split_plain(z, n)), n)
    else:
        xr, xi = R.from_layout(*sp, layout, L)
        z.copy_(RF.pair_merge_plain(xr, xi, z.shape[0], scale)
                if mode == "pair_merge" else
                RF.halfc_merge_plain(xr, xi, n, scale))
    _cuda.REAL_HUGE.count += 1
    return spec if mode.endswith("split") else z


@pytest.mark.parametrize("b", [1, 3, 4])
def test_card_path_plumbing_with_stand_in_launchers(monkeypatch, b):
    """The CUDA branch's buffers (intermediates in place, the halfc row
    viewed as complex, the pair planes, odd batches), run on the CPU with
    stand-in launchers that do each launch's plain function: results equal
    numpy, and the counts are the plan's passes, +1 merge, +1 split in
    halfc mode (the pair split is the last pass's)."""
    monkeypatch.setattr(C, "is_cpu", lambda t: False)
    monkeypatch.setattr(FF, "launch_pass", _fake_launch_pass)
    monkeypatch.setattr(RF, "launch_real_huge", _fake_launch_real_huge)
    monkeypatch.setattr(_cuda.FOURSTEP_PASS, "count", 0)
    monkeypatch.setattr(_cuda.REAL_HUGE, "count", 0)
    FF.launch_pass.fused = 0
    n = 1 << 15
    xr, xi = planes(b, n, 13)
    x = torch.from_numpy(xr + 1j * xi)
    want = np.fft.fft(x.numpy().astype(np.complex128))
    assert rel(T.fft_large(x).numpy(), want) < 2e-6
    o = T.planar.ifft_large(torch.from_numpy(xr), torch.from_numpy(xi))
    assert rel(cplx(o), np.fft.ifft(xr.astype(np.float64) + 1j * xi)) < 2e-6
    assert _cuda.FOURSTEP_PASS.count == 4
    r = torch.from_numpy(xr)
    spec = np.fft.rfft(xr.astype(np.float64))
    for layout in RF.SPEC_LAYOUTS:
        for mode in RF.MODES:
            s = RF.rfft_large_rows(r, layout, mode=mode)
            nat = R.to_layout(*R.from_layout(
                *(s if isinstance(s, tuple) else (s, None)), layout, n // 2),
                "numpy")
            assert rel(nat.numpy(), spec) < 2e-6
            back = RF.irfft_large_rows(*(s if isinstance(s, tuple)
                                         else (s, None)), n, layout,
                                       scale=2.0 / n, mode=mode)
            assert err(back.numpy(), xr) < bound(n)
    assert _cuda.REAL_HUGE.count == 9
    assert FF.launch_pass.fused == 3


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("layout", RF.SPEC_LAYOUTS)
@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("n", [1 << 15, 1 << 18, 1 << 20, 1 << 21])
def test_split_pass_is_the_pair_split_of_the_last_pass(monkeypatch, n, b,
                                                       layout, exact):
    """The pair-mode R2C's last pass with the split (rowfour's 256 x 128
    at 2^15, "two:revisit" at 2^18 and 2^20, three passes at 2^21): the
    split pass's plain version is ``pair_split_plain`` of the plain last
    pass at every radix, the plan takes it to radix 256 (2^15, 2^21) and
    leaves the split a launch of its own above (512 at 2^18, 1024 at
    2^20), and the card path with stand-in launchers gives the CPU path's
    spectra bit for bit, in each layout and tier, with the plan's
    launches (at 2^21 in fp32 its last two in one, the fused tail)."""
    import dataclasses
    plan = FF.default_passes(n)
    last = dataclasses.replace(plan[-1], split="pair")
    fused = plan[-1].radix <= FF.SPLIT_MAX_RADIX
    assert FF.pair_split_plan(n) == (plan[:-1] + (last,) if fused else plan)
    xr, xi = planes(b // 2, n, n % 997 + b)
    ctype = torch.complex128 if exact else torch.complex64
    z = FF.passes_plain(torch.from_numpy(xr + 1j * xi).to(ctype), n,
                        plan[:-1])
    got = FF.pass_plain(z, n, last)
    want = RF.pair_split_plain(FF.pass_plain(z, n, plan[-1]), b)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    x = torch.from_numpy(np.concatenate([xr, xi]))
    cpu = RF.rfft_large_rows(x, layout, exact)
    monkeypatch.setattr(C, "is_cpu", lambda t: False)
    monkeypatch.setattr(FF, "launch_pass", _fake_launch_pass)
    monkeypatch.setattr(RF, "launch_real_huge", _fake_launch_real_huge)
    monkeypatch.setattr(_cuda.FOURSTEP_PASS, "count", 0)
    monkeypatch.setattr(_cuda.REAL_HUGE, "count", 0)
    FF.launch_pass.fused = FF.launch_pass.tails = 0
    card = RF.rfft_large_rows(x, layout, exact)
    tail = int(any(p.then for p in FF.tail_plan(
        n, FF.pair_split_plan(n), exact)))
    assert tail == (n == 1 << 21 and not exact)
    assert (_cuda.FOURSTEP_PASS.count, FF.launch_pass.fused,
            FF.launch_pass.tails, _cuda.REAL_HUGE.count) == (
        len(plan) - tail, int(fused), tail, int(not fused))
    for c, k in zip(*(t if isinstance(t, tuple) else (t,)
                      for t in (cpu, card))):
        assert torch.equal(c, k)
    nat = R.to_layout(*R.from_layout(*(card if isinstance(card, tuple)
                                       else (card, None)), layout, n // 2),
                      "numpy")
    assert rel(nat.numpy(), np.fft.rfft(x.double().numpy())) < 2e-6


@pytest.mark.parametrize("n", [1 << 12, 1 << 21])
@pytest.mark.parametrize("layout", RF.SPEC_LAYOUTS)
def test_fused_tail_plain_equals_the_three_pass_plan(n, layout):
    """The fused tail's plan (pass 2 carrying the split pass, one launch)
    has the plain version of the three-pass plan, bit for bit: at a small
    N, whose three-pass plan the tail never takes on the card, and at
    2^21, where it does; an odd batch (its last q row left out), in each
    spectrum layout."""
    import dataclasses
    plan = FF.plan(FF.radices(n, 3))
    plan = plan[:-1] + (dataclasses.replace(plan[-1], split="pair"),)
    fused = plan[:1] + (dataclasses.replace(plan[1], then=plan[2]),)
    if n == 1 << 21:
        assert FF.tail_plan(n, plan) == fused
    b = 3
    xr, xi = planes(2, n, n % 991)
    z = torch.from_numpy(xr + 1j * xi).to(torch.complex64)
    want = FF.passes_plain(z, n, plan)
    got = FF.passes_plain(z, n, fused)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(
        R.to_layout(got[0][:b], got[1][:b], layout),
        R.to_layout(want[0][:b], want[1][:b], layout)))
    with pytest.raises(ValueError, match="fused tail"):
        FF.pass_plain(z, n, dataclasses.replace(fused[1], tw_s=0))


# ---------------------------------------------------------------------------
# The column route (column_plan, run_columns): a C2C over an axis of M
# points at stride K of (B, M K) rows, the first pass's twiddle blind to the
# column (tw_lo = K).
# ---------------------------------------------------------------------------


def axis_dft(x, inverse=False):
    """The explicit DFT over axis 1 of a (B, M, K) tensor, complex128."""
    m = x.shape[1]
    j = torch.arange(m, dtype=torch.float64)
    sign = 1.0 if inverse else -1.0
    w = torch.exp(sign * 2j * np.pi * torch.outer(j, j) / m)
    return torch.einsum("jm,bmk->bjk", w, x.to(torch.complex128))


def column_grid(b, m, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((b, m, k)) - 0.5 + 1j * (rng.random((b, m, k)) - 0.5)
    return torch.from_numpy(x)


# (B, M, K, R1, R2): R1 = R2, R1 > R2, and one column (K = 1)
TW_LO_CASES = [(1, 256, 8, 16, 16), (3, 256, 32, 16, 16),
               (2, 512, 4, 32, 16), (2, 1024, 1, 32, 32)]


@pytest.mark.parametrize("b,m,k,r1,r2", TW_LO_CASES)
@pytest.mark.parametrize("inverse", [False, True])
def test_pass_plain_with_tw_lo_matches_an_explicit_dft(b, m, k, r1, r2,
                                                        inverse):
    """Pass A of radix R1 over columns of stride R2 K, its twiddle's
    exponent (c mod R2 K) with the low log2 K bits cleared, is
    W_M^(b k_a) times an R1-point DFT, whatever the column; pass B of
    radix R2 lands the axis's DFT in natural order.  In float64 against
    the explicit DFT (the scale on the input of pass A)."""
    n = m * k
    pa = FF.Pass(r1, ("col", r2 * k), ("col", r2 * k), r2 * k, True,
                 tw_lo=k)
    pb = FF.Pass(r2, ("col", k), ("col", r1 * k), 0, False)
    x = column_grid(b, m, k, m + k)
    y = FF.pass_plain(x.reshape(b, n), n, pa, inverse, 0.5)
    # pass A alone: point (d, k_a, col) is W_M^(d k_a) * DFT_R1 over j of
    # x[b, d + j R2, col]
    xa = x.reshape(b, r1, r2, k)
    sign = 1.0 if inverse else -1.0
    ja = torch.arange(r1, dtype=torch.float64)
    w1 = torch.exp(sign * 2j * np.pi * torch.outer(ja, ja) / r1)
    d = torch.arange(r2, dtype=torch.float64)
    tw = torch.exp(sign * 2j * np.pi * torch.outer(ja, d) / m)
    want_a = 0.5 * torch.einsum("aj,bjdk->badk", w1, xa) * tw[None, :, :,
                                                              None]
    assert err(y.reshape(b, r1, r2, k), want_a) < 1e-12
    got = FF.pass_plain(y, n, pb, inverse)
    assert err(got.reshape(b, m, k), 0.5 * axis_dft(x, inverse)) < 1e-10
    # tw_lo = 1 there would twiddle each column by its own index: wrong
    per_column = dataclasses.replace(pa, tw_lo=1)
    first = FF.pass_plain(x.reshape(b, n), n, per_column, inverse, 0.5)
    wrong = FF.pass_plain(first, n, pb, inverse)
    assert (k == 1) == (err(wrong.reshape(b, m, k),
                            0.5 * axis_dft(x, inverse)) < 1e-10)


@pytest.mark.parametrize("m,k", [(32, 4), (2048, 1), (4096, 64),
                                 (8192, 2), (16384, 16384)])
def test_column_plan_is_one_pass_to_2048_then_two(m, k):
    plan = FF.column_plan(m, k)
    if m <= FF.MAX_RADIX:
        assert plan == (FF.Pass(m, ("col", k), ("col", k), 0, True),)
        return
    r1, r2 = FF.radices(m, 2)
    assert (r1, r2) == {4096: (64, 64), 8192: (128, 64),
                        16384: (128, 128)}[m]
    two = (FF.Pass(r1, ("col", r2 * k), ("col", r2 * k), r2 * k, True,
                   tw_lo=k),
           FF.Pass(r2, ("col", k), ("col", r1 * k), 0, False))
    # fp32 with a slab of columns at the stride: the two passes in one
    # launch, the first carrying the second; "exact" keeps two
    fits = k >= FF.column_slab(r1, r2)
    assert plan == ((dataclasses.replace(two[0], then=two[1]),) if fits
                    else two)
    assert FF.column_plan(m, k, exact=True) == two
    # no pass of an existing plan carries tw_lo
    assert all(p.tw_lo == 1 for n in (1 << 15, 1 << 21, 1 << 23)
               for plan in (FF.default_passes(n), FF.pair_split_plan(n))
               for p in plan)


def _recording_launch_pass(log):
    """A stand-in launcher that records (src, dst, pass, at, dst's dtype)
    and does the pass's plain function."""
    def launch(src, dst, n, p, *, inverse=False, scale=1.0, exact=False,
               at=None):
        made = callable(dst)
        dst = dst() if made else dst
        log.append((src, dst, made, p, at))
        y = FF.pass_plain(src.to(torch.complex128 if exact
                                 else torch.complex64), n, p, inverse, scale)
        dst.copy_(y)
        return dst
    return launch


# (M, K, own, exact) -> (in place first, intermediate dtype)
RUN_COLUMN_CASES = [(4096, 4, False, False), (4096, 4, True, False),
                    (4096, 4, True, True), (1024, 8, True, False),
                    (1024, 8, False, False)]


@pytest.mark.parametrize("m,k,own,exact", RUN_COLUMN_CASES)
def test_run_columns_buffers_on_the_card_path(monkeypatch, m, k, own, exact):
    """The card branch on CPU tensors with a stand-in launcher: an input
    the caller owns takes the first pass in place (one pass: the output is
    the input), else the first pass makes the intermediate (complex128 for
    "exact"); the last pass makes the output; every launch names the
    column axis in its span."""
    monkeypatch.setattr(C, "is_cpu", lambda t: False)
    log = []
    monkeypatch.setattr(FF, "launch_pass", _recording_launch_pass(log))
    b, n = 3, m * k
    x0 = column_grid(b, m, k, 5).to(torch.complex64)
    x = x0.reshape(b, n).clone()
    calls = FF.run_columns.calls
    y = FF.run_columns(x, m, k, inverse=True, scale=1.0 / m, exact=exact,
                       own=own)
    assert FF.run_columns.calls == calls + 1
    assert [e[3] for e in log] == list(FF.column_plan(m, k))
    assert [e[4] for e in log] == [(i + 1, len(log), "col")
                                   for i in range(len(log))]
    first = log[0]
    assert first[0] is x
    if len(log) == 1:
        assert (y is x) == own and first[2] != own
    else:
        in_place = own and not exact
        assert (first[1] is x) == in_place and first[2] != in_place
        assert first[1].dtype == (torch.complex128 if exact
                                  else torch.complex64)
        assert log[1][0] is first[1] and log[1][2] and log[1][1] is y
    assert y.dtype == torch.complex64
    want = axis_dft(x0, inverse=True) / m
    assert err(y.reshape(b, m, k), want) < bound(m) * want.abs().max().item()


def test_register_report_labels_the_split_pass():
    """ptxas's report names the pass kernel's split instantiations and its
    fused tails apart from the plain ones, whose labels stay as they were,
    and the convolutions' bank form as before."""
    entries = [("_ZN12_GLOBAL__N_120fourstep_pass_kernelILi128ELb0ELb0EEEvNS_"
                "8PassArgsEdPKN8PassTileIXT_EXT0_EE1CES6_S6_i", 40, 0),
               ("_ZN12_GLOBAL__N_120fourstep_pass_kernelILi128ELb1ELb1EEEvNS_"
                "8PassArgsEdPKN8PassTileIXT_EXT0_EE1CES6_S6_i", 90, 8),
               ("_ZN12_GLOBAL__N_120fourstep_pass_kernelILi256ELi128ELb0ELb1E"
                "Lb1EEEvNS_8PassArgsES1_NS_8SplitOutENS_8TailSyncEPK6float2S6_"
                "S6_S6_", 120, 0),
               ("_ZN12_GLOBAL__N_111conv_kernelILi1024ELb0ELb1EEEvPK6float2",
                64, 0)]
    log = "".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {name}\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes "
        "spill loads\n"
        f"ptxas info    : Used {regs} registers, 400 bytes cmem[0]\n"
        for name, regs, spill in entries)
    assert _cuda.register_report(log) == [
        "fourstep_pass_kernel<128> fp32: 40 registers, 0 bytes of spill "
        "stores",
        "fourstep_pass_kernel<128,split> fp64: 90 registers, 8 bytes of "
        "spill stores",
        "fourstep_pass_kernel<256,128,split,tail> fp32: 120 registers, 0 "
        "bytes of spill stores",
        "conv_kernel<1024,bank> fp32: 64 registers, 0 bytes of spill stores"]


def test_cpu_run_never_touches_the_cuda_module():
    """The huge-N CPU path asks for no kernel library, calls no entry
    point and counts no launch (the module itself is imported by every
    op module, and builds nothing at import)."""
    code = ("import sys, torch, smfft_tpu_torch as T\n"
            "from smfft_tpu_torch.ops import _cuda\n"
            "def boom():\n"
            "    raise AssertionError('kernel library requested')\n"
            "_cuda.library = boom\n"
            "x = torch.rand((2, 1 << 15))\n"
            "T.irfft_large(T.rfft_large(x))\n"
            "T.planar.ifft_large(*T.planar.fft_large(x, x))\n"
            "assert _cuda._lib is None\n"
            "assert not any(e.fn or e.count for e in _cuda.ENTRIES)\n"
            "assert 'jax' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
