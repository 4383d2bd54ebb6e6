"""The periodicity-search deployment on the CPU: ``api.rfft_large`` of DM
trials held against the plain reference
(``smfft_tpu_torch/reference/periodicity_search.py``) in both packing
modes, the reference's independence from the port, and the plan that the
deployment's call (128 trials of 2^23 samples) runs on the card; then the
harmonic sum that follows it (``periodicity.harmonic_sum``) against its
plain reference (``smfft_tpu_torch/reference/periodicity.py``): the plain
path's SNR and counts, planted signals, bad arguments, its spans and
bytes, and the card branch's two launches on CPU tensors."""

from __future__ import annotations

import ast
import math
import re
import sys
from pathlib import Path

import pytest
import torch

import smfft_tpu_torch as S
from smfft_tpu_torch import api, periodicity, trace
from smfft_tpu_torch.ops import fourstep_fused as FF
from smfft_tpu_torch.ops import hugefft
from smfft_tpu_torch.ops import real_fused as RF
from smfft_tpu_torch.ops import harmonic as HS
from smfft_tpu_torch.parallel import dryrun
from smfft_tpu_torch.reference import periodicity as href
from smfft_tpu_torch.reference import periodicity_search as ref

REF_PATH = Path(ref.__file__)

# max |got - expected| / rms(expected) over a call's bins, the number the
# benchmark's cell compares.  fp32 rounds each pass and twiddle at 6e-8;
# over the log2 n <= 21 stages and the split the port reads at most 1.9e-6
# here (max over every bin), and 2e-5 leaves 10x above that.  Rounding the
# input and spectrum to bfloat16 (4e-3) reads 9.9e-3 or more: 500x over.
TOL = 2e-5


def _trials(rows: int, n: int) -> torch.Tensor:
    """DM trials uniform in [-1, 1), as the benchmark's cell makes them."""
    g = torch.Generator().manual_seed(1000 * rows + n.bit_length())
    return torch.rand((rows, n), generator=g) * 2 - 1


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    rms = want.abs().square().mean().sqrt()
    return float((got.to(want.dtype) - want).abs().max() / rms)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    if not t.is_complex():
        return t.to(torch.bfloat16).to(torch.float32)
    r = torch.view_as_real(t).to(torch.bfloat16).to(torch.float32)
    return torch.view_as_complex(r.contiguous())


# (rows, mode forced or None): 4 rows choose pair; odd rows choose halfc;
# 3 rows forced to pair pad one zero row
CASES = [(4, None), (3, None), (1, None), (3, "pair")]


@pytest.mark.parametrize("rows,mode", CASES)
@pytest.mark.parametrize("log_n", [15, 18, 21])
def test_rfft_large_matches_the_reference(log_n, rows, mode):
    n = 1 << log_n
    x = _trials(rows, n)
    want = ref.expected(x)
    if mode is None:
        got = api.rfft_large(x, precision="highest")
    else:
        got = RF.rfft_large_rows(x, "numpy", mode=mode)
    assert got.shape == want.shape == (rows, n // 2 + 1)
    assert got.dtype == torch.complex64
    assert _err(got, want) < TOL
    # the bfloat16 control fails the same tolerance
    assert _err(_bf16(torch.fft.rfft(_bf16(x), dim=-1)), want) > 100 * TOL


def test_modes_the_cases_take():
    n = 1 << 21
    assert [mode or RF.choose_mode(rows, n) for rows, mode in CASES] == [
        "pair", "halfc", "halfc", "pair"]


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    return names


def test_the_reference_imports_nothing_of_the_port_and_no_jax():
    names = _imports(REF_PATH)
    assert names and set(names) <= {"__future__", "torch"}
    for name in names:
        top = name.split(".")[0]
        assert top not in ("jax", "smfft_tpu", "smfft_tpu_torch"), name


def test_the_cells_call_runs_pair_mode_on_the_three_pass_plan():
    """128 trials of 2^23 samples a call: pair mode (a tie at an even
    batch), the "three" plan of 2^23 = 256 x 256 x 128 with the pair split
    in its last pass, so three pass launches a step and no split launch."""
    rows, n = 128, 1 << 23
    assert RF.choose_mode(rows, n) == "pair"
    assert hugefft.default_plan(n) == "three"
    passes = FF.pair_split_plan(n)
    assert [p.radix for p in passes] == [256, 256, 128]
    assert [p.split for p in passes] == [None, None, "pair"]
    assert len(passes) == 3


# ---------------------------------------------------------------------------
# The harmonic sum (periodicity.harmonic_sum) on the plain path.
# ---------------------------------------------------------------------------

# max |got - want| / rms(want) over a call's SNR, the number the benchmark's
# cell compares.  From a complex64 spectrum the plain path reads at most
# 1.5e-6 here ("exact" 5.8e-7: the spectrum's own rounding): float32 Q at
# 6e-8 and up to 32 float32 additions before the mean is taken off, against
# an SNR whose rms is about 1; 2e-5 leaves 13x above that.  Rounding the
# spectrum to bfloat16 (4e-3) reads 2.7e-2 or more: over 1000x.
HTOL = 2e-5


@pytest.fixture
def recording_off():
    trace.stop()
    yield
    trace.stop()


def _spectra(rows: int, n: int, seed: int) -> torch.Tensor:
    """complex64 spectra of uniform trials, from the reference's float64
    transform."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((rows, n), generator=g, dtype=torch.float64) * 2 - 1
    return href.spectrum(x).to(torch.complex64)


def _snr_err(got: torch.Tensor, want: torch.Tensor) -> float:
    rms = want.square().mean().sqrt()
    return float((got.to(want.dtype) - want).abs().max() / rms)


@pytest.mark.parametrize("precision", [None, "exact"])
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("harmonics", [1, 8, 32])
@pytest.mark.parametrize("log_n", [10, 12, 14])
def test_harmonic_sum_matches_the_reference(log_n, harmonics, rows,
                                            precision):
    """The SNR within HTOL of the float64 reference, the bfloat16 spectrum
    outside it, and the counts tie-aware: the reference's SNR at the
    program's count is within HTOL of the reference's best."""
    n = 1 << log_n
    spec = _spectra(rows, n, 100 * log_n + harmonics + rows)
    want, _ = href.harmonic_sum(spec, harmonics)
    snr, count = S.harmonic_sum(spec, harmonics=harmonics,
                                precision=precision, return_counts=True)
    assert snr.shape == count.shape == (rows, n + 1)
    assert snr.dtype == torch.float32 and count.dtype == torch.uint8
    assert _snr_err(snr, want) < HTOL
    at = href.snr_at(spec, harmonics, count)
    assert not at.isnan().any()
    assert _snr_err(at, want) < HTOL
    assert 1 <= int(count.min()) and int(count.max()) <= harmonics
    assert torch.equal(S.harmonic_sum(spec, harmonics=harmonics,
                                      precision=precision), snr)
    r = torch.view_as_real(spec).to(torch.bfloat16).to(torch.float32)
    bf = S.harmonic_sum(torch.view_as_complex(r.contiguous()),
                        harmonics=harmonics)
    assert _snr_err(bf, want) > 100 * HTOL


def test_a_single_spectrum_gives_a_single_row():
    spec = _spectra(1, 1 << 12, 7)
    snr, count = S.harmonic_sum(spec[0], harmonics=16, return_counts=True)
    want, want_count = S.harmonic_sum(spec, harmonics=16, return_counts=True)
    assert snr.shape == count.shape == ((1 << 12) + 1,)
    assert torch.equal(snr, want[0]) and torch.equal(count, want_count[0])
    # complex128 is taken as complex64
    assert torch.equal(S.harmonic_sum(spec.to(torch.complex128),
                                      harmonics=16), want)


def test_the_fundamentals_at_either_end():
    """i = 0 sums Q[0] ``harmonics`` times: its best is sqrt(H) (Q0 - mu) /
    sigma at H = 32 when Q0 > mu, at H = 1 otherwise; a fundamental past
    (M - 1) / 2 has one harmonic, past (M - 1) / 3 two: its SNR is the
    single point's, its count 1, until it runs out."""
    n = 1 << 12
    spec = _spectra(2, n, 11)
    q = href.interbin(spec)
    m = q.shape[1]
    mu = q.mean(-1)
    sigma = q.std(-1, correction=0)
    snr, count = S.harmonic_sum(spec, return_counts=True)
    for t in range(2):
        z = float((q[t, 0] - mu[t]) / sigma[t])
        best, h = (math.sqrt(32) * z, 32) if z > 0 else (z, 1)
        assert snr[t, 0].item() == pytest.approx(best, rel=1e-5, abs=1e-5)
        assert count[t, 0].item() == h
    tail = torch.arange((m - 1) // 2 + 1, m)
    single = (q[:, tail] - mu[:, None]) / sigma[:, None]
    assert _snr_err(snr[:, tail], single) < HTOL
    assert (count[:, tail] == 1).all()
    two = torch.arange((m - 1) // 3 + 1, (m - 1) // 2 + 1)
    assert (count[:, two] <= 2).all()
    s2 = (q[:, two] + q[:, 2 * two] - 2 * mu[:, None]) / (
        math.sqrt(2) * sigma[:, None])
    s1 = (q[:, two] - mu[:, None]) / sigma[:, None]
    assert _snr_err(snr[:, two], torch.maximum(s1, s2)) < HTOL


def test_the_interbin_point_of_a_half_bin_sinusoid():
    """A sinusoid at k0 + 1/2 bins puts nearly all of its power, (n/2)^2,
    at the half bin: Q[2k0 + 1] = (pi^2/16) |X_k0 - X_k0+1|^2 reads it,
    while the whole bins beside it read 4/pi^2 of it."""
    n, k0 = 1 << 12, 300
    t = torch.arange(n, dtype=torch.float64)
    x = torch.cos(2 * math.pi * (k0 + 0.5) * t / n)[None]
    spec = href.spectrum(x).to(torch.complex64)
    q = HS.interbin_plain(spec)
    x0, x1 = spec[0, k0].to(torch.complex128), spec[0, k0 + 1].to(
        torch.complex128)
    formula = math.pi ** 2 / 16 * abs(x0 - x1) ** 2
    assert q[0, 2 * k0 + 1].item() == pytest.approx(formula, rel=1e-6)
    assert q[0, 2 * k0 + 1].item() == pytest.approx(n * n / 4, rel=1e-3)
    for k in (2 * k0, 2 * k0 + 2):
        assert q[0, k].item() / (n * n / 4) == pytest.approx(
            4 / math.pi ** 2, rel=2e-3)
    m = 2 * (n // 2 + 1) - 1
    assert q[0, m].item() == 0
    want = href.interbin(spec)
    assert (q[:, :m].double() - want).abs().max() <= 1e-6 * want.max()
    snr = S.harmonic_sum(spec + _spectra(1, n, 3), harmonics=8)
    assert snr[0].argmax().item() == 2 * k0 + 1


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("bins", [2, 3, 1025, 2049])
def test_q_is_the_interbinned_power_at_every_half_bin(bins, exact):
    """The layout both kernels share: a trial's row of Q is 2L points,
    Q[2k] = |X_k|^2 and Q[2k + 1] = (pi^2/16) |X_k - X_{k+1}|^2 as the
    reference forms them, the last point (past M) 0."""
    spec = _spectra(2, 2 * bins - 2, bins)
    q = HS.interbin_plain(spec, exact)
    m = 2 * bins - 1
    assert q.shape == (2, 2 * bins)
    assert q.dtype == (torch.float64 if exact else torch.float32)
    assert q[:, m].eq(0).all()
    want = href.interbin(spec)
    assert (q[:, :m].double() - want).abs().max() <= 1e-6 * want.max()


def _kernel_constant(name: str) -> int:
    src = (Path(periodicity.__file__).parent / "csrc" /
           "periodicity.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("harmonics", [1, 2, 7, 32])
@pytest.mark.parametrize("bins", [2, 3, 5, 33, 1025, 2049, 4097, 8193, 70001,
                                  131073])
def test_the_kernels_loops_reach_every_bin_and_fundamental_once(bins,
                                                                harmonics):
    """A model of ``csrc/periodicity.cu``'s loops.  ``interbin_kernel``'s
    PARTS runs of a trial's bins (a block each, its threads stepping by
    THREADS) write every pair (Q[2k], Q[2k + 1]) once.
    ``harmonic_sum_kernel``'s tiles of THREADS * PER_THREAD fundamentals,
    PER_THREAD a thread at a stride of THREADS, each thread stopping at
    the first past M, form every fundamental's SNR once; its harmonics h i,
    h <= H_max(i), lie in Q's M points (never the last point of the row),
    and a trial sums as many terms as the benchmark's work module counts:
    ``harmonics`` + sum_h (M - 1) // h."""
    parts, threads, per = (_kernel_constant(k) for k in
                           ("PARTS", "THREADS", "PER_THREAD"))
    m = 2 * bins - 1
    writes = torch.zeros(bins, dtype=torch.int64)
    run = -(-bins // parts)
    for p in range(parts):
        writes[p * run:min(p * run + run, bins)] += 1
    assert writes.eq(1).all()
    tile = threads * per
    formed = torch.zeros(m, dtype=torch.int64)
    for first in range(0, m, tile):
        live = torch.ones(threads, dtype=torch.bool)
        for j in range(per):
            i = first + j * threads + torch.arange(threads)
            live &= i < m
            formed[i[live]] += 1
    assert formed.eq(1).all()
    i = torch.arange(m)
    hmax = torch.where(i == 0, harmonics,
                       torch.clamp((m - 1) // i.clamp_min(1), max=harmonics))
    assert (hmax * i <= m - 1).all() and (hmax >= 1).all()
    assert int(hmax.sum()) == harmonics + sum(
        (m - 1) // h for h in range(1, harmonics + 1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a_pulse_train_peaks_at_its_fundamental_with_many_harmonics(seed):
    """Zero-mean Gaussian pulses every 128 samples over uniform noise:
    harmonics at every 128th bin whose power falls with their number, so
    the best SNR of the trial is at the fundamental, 256 half bins, summed
    over more than one harmonic, and above any single point's."""
    n, period = 1 << 14, 128
    g = torch.Generator().manual_seed(seed)
    t = torch.arange(n, dtype=torch.float64)
    pulse = torch.exp(-0.5 * (((t % period) - period / 2) / 2.0) ** 2)
    x = torch.rand((2, n), generator=g, dtype=torch.float64) * 2 - 1 \
        + 0.5 * (pulse - pulse.mean())
    spec = href.spectrum(x).to(torch.complex64)
    snr, count = S.harmonic_sum(spec, return_counts=True)
    single = S.harmonic_sum(spec, harmonics=1)
    for r in range(2):
        i = snr[r].argmax().item()
        assert i == 2 * n // period
        assert count[r, i].item() > 1
        assert snr[r, i] > single[r].max()


def test_a_sinusoid_at_a_whole_bin_takes_one_harmonic():
    n, k0 = 1 << 14, 1000
    g = torch.Generator().manual_seed(4)
    t = torch.arange(n, dtype=torch.float64)
    x = torch.rand((1, n), generator=g, dtype=torch.float64) * 2 - 1 \
        + 0.5 * torch.cos(2 * math.pi * k0 * t / n)
    snr, count = S.harmonic_sum(href.spectrum(x).to(torch.complex64),
                                return_counts=True)
    assert snr[0].argmax().item() == 2 * k0
    assert count[0, 2 * k0].item() == 1


@pytest.mark.parametrize("bad", [
    dict(spectrum=torch.zeros(2, 100)),                          # real
    dict(spectrum=torch.zeros(2, 3, 100, dtype=torch.complex64)),
    dict(spectrum=torch.zeros(2, 1, dtype=torch.complex64)),     # L = 1
    dict(spectrum=torch.zeros((), dtype=torch.complex64)),
    dict(harmonics=0),
    dict(harmonics=33),
    dict(harmonics=2.0),
    dict(harmonics=True),
    dict(precision="no such tier"),
])
def test_harmonic_sum_bad_arguments_raise(bad):
    args = dict(spectrum=torch.ones(2, 100, dtype=torch.complex64))
    args.update(bad)
    with pytest.raises(ValueError):
        S.harmonic_sum(args.pop("spectrum"), **args)


def _spans(rec) -> list[dict]:
    return [rec.span(i) for i in range(len(rec))]


@pytest.mark.parametrize("counts", [False, True])
def test_the_plain_path_records_its_passes_and_counts_their_bytes(
        recording_off, counts):
    """call:harmonic_sum (n = M, rows = trials) holds op:harmonic_sum,
    which holds interbin, stats and sum in turn; their bytes add up to the
    counter's rise, which it counts with recording off too."""
    rows, n = 3, 1 << 12
    spec = _spectra(rows, n, 5)
    bins, m = n // 2 + 1, n + 1
    q = rows * 2 * bins * 4
    out = rows * m * (5 if counts else 4)
    want = [rows * bins * 8 + q, q, q + out]
    before = dryrun.harmonic_bytes()
    S.harmonic_sum(spec, return_counts=counts)
    assert dryrun.harmonic_bytes() - before == sum(want)
    trace.start()
    S.harmonic_sum(spec, return_counts=counts)
    spans = _spans(trace.stop())
    assert [(s["name"], s["parent"]) for s in spans] == [
        ("call:harmonic_sum", -1), ("op:harmonic_sum", 0), ("interbin", 1),
        ("stats", 1), ("sum", 1)]
    assert spans[0]["attrs"] == {"n": m, "rows": rows}
    assert [s["attrs"]["bytes"] for s in spans[2:]] == want


# ---------------------------------------------------------------------------
# The card branch on CPU tensors: the launch wrappers, the two launches.
# ---------------------------------------------------------------------------


class _HarmonicLib:
    """The library's entry points stood in: the two kernels' record their
    arguments and return 0; the others return 0."""

    def __init__(self):
        self.calls = []

    def smfft_interbin(self, *args):
        self.calls.append(("interbin", args))
        return 0

    def smfft_harmonic_sum(self, *args):
        self.calls.append(("harmonic_sum", args))
        return 0

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.mark.parametrize("precision,counts", [(None, False), (None, True),
                                              ("exact", False)])
def test_the_card_branch_is_two_launches(monkeypatch, recording_off,
                                         precision, counts):
    """``harmonic_sum`` of a spectrum that is not on the CPU: the op holds
    ``launch:interbin`` then ``launch:harmonic_sum`` (each with ``alloc``
    and ``call``) and no plain pass; exactly one launch of each kernel,
    the spectrum read in place, Q and the partial sums handed from the
    first to the second; ``harmonic_bytes`` rises by the spectrum read, Q
    and the partial sums written and read, and the outputs written."""
    sys.path.insert(0, str(Path(__file__).parent))
    from torch_launch_path import launch_path
    from smfft_tpu_torch.ops import c2c as C
    lib = launch_path(monkeypatch, _HarmonicLib())
    monkeypatch.setattr(C, "is_cpu", lambda t: False)
    rows, n, harmonics = 3, 1 << 12, 32 if counts else 7
    bins, m = n // 2 + 1, n + 1
    exact = precision == "exact"
    spec = _spectra(rows, n, 6)
    counts_before, moved = dryrun.counts(), dryrun.harmonic_bytes()
    trace.start()
    out = S.harmonic_sum(spec, harmonics=harmonics, precision=precision,
                         return_counts=counts)
    spans = _spans(trace.stop())
    after = dryrun.counts()
    assert {k: after[k] - counts_before[k] for k in after
            if after[k] != counts_before[k]} == {"interbin": 1,
                                                 "harmonic_sum": 1}
    snr = out[0] if counts else out
    assert snr.shape == (rows, m) and snr.dtype == torch.float32
    (k1, a1), (k2, a2) = lib.calls
    assert (k1, k2) == ("interbin", "harmonic_sum")
    assert a1[0] == spec.data_ptr()
    assert a1[3:6] == (rows, bins, int(exact))
    assert a2[0] == a1[1] and a2[1] == a1[2] and a2[2] == snr.data_ptr()
    assert a2[3] == (out[1].data_ptr() if counts else None)
    assert a2[4:8] == (rows, bins, harmonics, int(exact))
    q = rows * 2 * bins * (8 if exact else 4)
    part = rows * HS.PARTS * 16
    assert dryrun.harmonic_bytes() - moved == (
        rows * bins * 8 + 2 * (q + part) + rows * m * (5 if counts else 4))
    assert [(s["name"], s["parent"]) for s in spans] == [
        ("call:harmonic_sum", -1), ("op:harmonic_sum", 0),
        ("launch:interbin", 1), ("alloc", 2), ("call", 2),
        ("launch:harmonic_sum", 1), ("alloc", 5), ("call", 5)]
    assert spans[2]["attrs"] == {"rows": rows, "n": bins, "variant": "power",
                                 "exact": exact}
    assert spans[3]["attrs"] == {"bytes": q + part}
    assert spans[5]["attrs"] == {"rows": rows, "n": m, "variant":
                                 f"harmonics={harmonics} counts={int(counts)}",
                                 "exact": exact}
    assert spans[6]["attrs"] == {"bytes": rows * m * (5 if counts else 4)}


@pytest.mark.parametrize("call,bad,match", [
    ("interbin", dict(x=torch.zeros(2, 100)), "x must be complex64"),
    ("interbin", dict(x=torch.zeros(2, 1, dtype=torch.complex64)),
     "x must be complex64"),
    ("interbin", dict(x=torch.zeros(100, dtype=torch.complex64)),
     "x must be complex64"),
    ("interbin", dict(), "x must be a CUDA tensor"),
    ("harmonic_sum", dict(harmonics=0), "harmonics must be"),
    ("harmonic_sum", dict(harmonics=33), "harmonics must be"),
    ("harmonic_sum", dict(q=torch.zeros(2, 201)), "q must be"),
    ("harmonic_sum", dict(q=torch.zeros(2, 2)), "q must be"),
    ("harmonic_sum", dict(q=torch.zeros(200)), "q must be"),
    ("harmonic_sum", dict(part=torch.zeros(2, 32, 2)), "part must be"),
    ("harmonic_sum", dict(part=torch.zeros(3, 32, 2, dtype=torch.float64)),
     "part must be"),
    ("harmonic_sum", dict(), "x must be a CUDA tensor"),
    ("harmonic_sum", dict(q=torch.zeros(2, 200, dtype=torch.float64)),
     "x must be a CUDA tensor"),
])
def test_the_launch_wrappers_check_their_arguments(call, bad, match):
    """Each wrapper raises before any launch: a spectrum that is not
    complex64 (trials, bins >= 2), harmonics outside 1..32, a Q that is
    not (trials, 2 bins), partial sums that are not float64 (trials, 32,
    2), and a CPU tensor, which only the plain path takes."""
    from smfft_tpu_torch.ops import _cuda
    before = (_cuda.INTERBIN.count, _cuda.HARMONIC_SUM.count)
    with pytest.raises(ValueError, match=match):
        if call == "interbin":
            args = dict(x=torch.zeros(2, 100, dtype=torch.complex64))
            args.update(bad)
            HS.launch_interbin(args.pop("x"), **args)
        else:
            args = dict(q=torch.zeros(2, 200),
                        part=torch.zeros(2, 32, 2, dtype=torch.float64))
            args.update(bad)
            HS.launch_harmonic_sum(args.pop("q"), args.pop("part"), **args)
    assert (_cuda.INTERBIN.count, _cuda.HARMONIC_SUM.count) == before
