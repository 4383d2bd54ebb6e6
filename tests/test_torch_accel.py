"""The Fourier-domain acceleration search on the CPU: ``accel_plane`` held
against the plain reference (``smfft_tpu_torch/reference/accel_search.py``:
the bank as one long DFT a template, the plane as the correlation summed
over q bin by bin), the cached bank, a planted accelerated sinusoid, the
overlap-save framing that ``signal.py`` and the plane share, and the spans
and counters of the call."""

from __future__ import annotations

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import smfft_tpu_torch as S
from smfft_tpu_torch import accel, trace
from smfft_tpu_torch.parallel import dryrun
from smfft_tpu_torch.reference import accel_search as ref
from smfft_tpu_torch.signal import overlap_save_frames, overlap_save_valid

# max |got - want| / rms(want) over a plane, the number the benchmark's
# cell compares.  From a complex64 spectrum the fp32 bank transforms read
# at most 5.7e-6 here (the spectrum's own rounding at 6e-8 and the
# segments' forward and inverse transforms); 5e-5 leaves 9x above that.
# Rounding the spectrum to bfloat16 (4e-3) reads 2.2e-2 or more: over 400x.
TOL = 5e-5


@pytest.fixture(autouse=True)
def recording_off():
    trace.stop()
    yield
    trace.stop()


def _trials(rows: int, n: int, seed: int) -> torch.Tensor:
    """DM trials uniform in [-1, 1), as the benchmark's cell makes them."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand((rows, n), generator=g, dtype=torch.float64) * 2 - 1


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    rms = want.square().mean().sqrt()
    return float((got.to(want.dtype) - want).abs().max() / rms)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    r = torch.view_as_real(t.to(torch.complex64)).to(torch.bfloat16)
    return torch.view_as_complex(r.to(torch.float32).contiguous())


@pytest.mark.parametrize("zmax", [8, 16, 30])
@pytest.mark.parametrize("log_n", [12, 13, 14, 15])
def test_accel_plane_matches_the_reference(log_n, zmax):
    n = 1 << log_n
    spec = ref.spectrum(_trials(2, n, 100 * log_n + zmax))
    want = ref.plane(spec, zmax, 2)
    got = S.accel_plane(spec.to(torch.complex64), zmax=zmax, dz=2)
    m = 2 * zmax // 2 + 1
    assert got.shape == want.shape == (2, m, n // 2 + 1)
    assert got.dtype == torch.float32
    assert _err(got, want) < TOL
    # the bfloat16 control fails the same tolerance
    assert _err(ref.plane(_bf16(spec), zmax, 2), want) > 100 * TOL


@pytest.mark.parametrize("n,zmax", [
    (64, 16),      # 33 bins, one segment of 256
    (256, 30),     # 129 bins, one segment of 512
    (512, 30),     # 257 bins, one segment of 512
])
def test_a_spectrum_shorter_than_a_segment(n, zmax):
    spec = ref.spectrum(_trials(3, n, n + zmax))
    want = ref.plane(spec, zmax, 2)
    got = S.accel_plane(spec.to(torch.complex64), zmax=zmax)
    assert n // 2 + 1 < accel.choose_nfft(2 * accel.half_width(zmax) + 1)
    assert _err(got, want) < TOL


@pytest.mark.parametrize("zmax,dz,segment", [(8, 2, 256), (30, 2, 512),
                                             (64, 4, 1024)])
def test_a_wider_bank_takes_longer_segments(zmax, dz, segment):
    """Each bank's segment length, and its plane against the reference."""
    k = 2 * accel.half_width(zmax) + 1
    assert accel.choose_nfft(k) == segment
    spec = ref.spectrum(_trials(2, 1 << 12, zmax + dz))
    want = ref.plane(spec, zmax, dz)
    got = S.accel_plane(spec.to(torch.complex64), zmax=zmax, dz=dz)
    assert _err(got, want) < TOL


def test_the_port_end_to_end_from_the_trials():
    """The deployment's step at a small size: ``rfft_large`` of the trials,
    then the plane, against the float64 reference of the trials."""
    x = _trials(2, 1 << 15, 11).to(torch.float32)
    got = S.accel_plane(S.rfft_large(x, precision="highest"), zmax=30,
                        precision="highest")
    assert _err(got, ref.plane(ref.spectrum(x), 30, 2)) < TOL


def test_a_single_spectrum_and_complex128_input():
    spec = ref.spectrum(_trials(1, 4096, 5))
    both = S.accel_plane(spec, zmax=8)
    one = S.accel_plane(spec[0], zmax=8)
    assert one.shape == (9, 2049) and torch.equal(one, both[0])


@pytest.mark.parametrize("zmax", [0, 8, 30])
def test_the_cached_bank_is_the_references(zmax):
    """The port sums the midpoint rule as products of chirps by shifts; the
    reference takes one DFT of 2^20 points a template.  Both are float64
    sums of 2^20 unit terms, which round at 2^-52 each: they agree to
    1e-12 (3e-16 read)."""
    got = accel.templates(zmax, 2)
    want = ref.templates(zmax, 2)
    w = accel.half_width(zmax)
    assert got.shape == want.shape == (zmax + 1, 2 * w + 1)
    assert got.dtype == torch.complex128
    assert (got - want).abs().max().item() <= 1e-12
    # z = 0: the response of a steady sinusoid, delta at q = 0, up to the
    # sum's rounding
    zero = got[zmax // 2]
    delta = torch.zeros_like(zero)
    delta[w] = 1
    assert (zero - delta).abs().max().item() <= 1e-15


def test_the_bank_is_built_once_per_grid_and_device():
    before = dryrun.accel_banks()
    a = accel.templates(6, 2)
    b = accel.templates(6.0, 2.0, "cpu")
    assert a is b
    assert dryrun.accel_banks() == before + 1
    accel.templates(6, 3)
    assert dryrun.accel_banks() == before + 2


def test_an_accelerated_sinusoid_peaks_at_its_drift_and_mean_bin():
    """cos(2 pi (r0 s/n + (z/2)(s/n)^2)) drifts from bin r0 by z bins over
    the trial: its power collects at template z, bin r0 + z/2, among
    noise."""
    n, r0, z = 1 << 15, 3000, 20
    s = torch.arange(n, dtype=torch.float64) / n
    x = torch.cos(2 * math.pi * (r0 * s + z / 2 * s * s))
    x = x + 0.5 * (_trials(1, n, 3)[0])
    plane = S.accel_plane(S.rfft_large(x[None].float()), zmax=30)[0]
    j, r = divmod(int(plane.argmax()), plane.shape[-1])
    zs = accel.z_grid(30, 2)
    assert zs[j] == z
    assert abs(r - (r0 + z // 2)) <= 1
    # the steady template (z = 0) sees a fraction of it
    assert plane[zs.index(0)].max() < 0.5 * plane[j, r]


@pytest.mark.parametrize("k,start", [(5, 0), (5, 2), (5, 4), (33, 16),
                                     (33, 0)])
@pytest.mark.parametrize("length", [1, 100, 257])
def test_overlap_save_frames_give_the_linear_convolution(k, start, length):
    """Frames of 64 points, each convolved circularly with the taps: their
    valid parts hold outputs start .. start + length - 1 of the linear
    convolution (zero beyond both ends of the row), for the framing that
    ``fftconvolve`` and ``accel_plane`` share."""
    rng = np.random.default_rng(k * 1000 + start + length)
    x = rng.standard_normal((2, 200)) + 1j * rng.standard_normal((2, 200))
    h = rng.standard_normal(k) + 1j * rng.standard_normal(k)
    n = 64
    fx, frames = overlap_save_frames(torch.from_numpy(x), k, n, start,
                                     length)
    hf = np.fft.fft(np.pad(h, (0, n - k)))
    y = torch.from_numpy(np.fft.ifft(np.fft.fft(fx.numpy()) * hf))
    hop = n - k + 1
    got = overlap_save_valid(y, 2, frames, k).reshape(2, frames * hop)
    want = np.stack([np.convolve(r, h) for r in x])
    want = np.pad(want, ((0, 0), (0, start + length)))[:, start:start + length]
    assert np.abs(got[:, :length].numpy() - want).max() < 1e-12


def test_the_segment_length_of_the_published_bank():
    """zmax 200: 201 templates of 233 taps; segments of 2048 (n log2 n /
    hop: 12.93 at 1024, 12.41 at 2048, 12.72 at 4096), 2310 a trial of
    2^22 + 1 bins."""
    k = 2 * accel.half_width(200) + 1
    assert (len(accel.z_grid(200, 2)), k) == (201, 233)
    assert accel.choose_nfft(k) == 2048
    assert -(-((1 << 22) + 1) // (2048 - k + 1)) == 2310


@pytest.mark.parametrize("bad", [
    dict(spectrum=torch.zeros(2, 100)),                 # real
    dict(spectrum=torch.zeros(2, 3, 100, dtype=torch.complex64)),
    dict(spectrum=torch.zeros(2, 0, dtype=torch.complex64)),
    dict(zmax=10, dz=3),                                 # 20/3 steps
    dict(zmax=-2),
    dict(dz=0),
])
def test_bad_arguments_raise(bad):
    args = dict(spectrum=torch.zeros(2, 100, dtype=torch.complex64),
                zmax=8, dz=2)
    args.update(bad)
    with pytest.raises(ValueError):
        S.accel_plane(args.pop("spectrum"), **args)


def _spans(rec) -> list[dict]:
    return [rec.span(i) for i in range(len(rec))]


def test_the_call_records_its_passes_and_counts_their_bytes():
    """call:accel_plane (n = bins, rows = trials) holds op:accel_plane,
    which holds frame, the bank's call:convolve, crop and power in turn;
    the passes' bytes add up to the counter's rise, which it counts with
    recording off too."""
    rows, n, zmax = 2, 1 << 12, 8
    spec = ref.spectrum(_trials(rows, n, 1)).to(torch.complex64)
    S.accel_plane(spec, zmax=zmax)                      # the bank, built
    bins, m, k = n // 2 + 1, zmax + 1, 2 * accel.half_width(zmax) + 1
    nf = accel.choose_nfft(k)
    hop = nf - k + 1
    frames = -(-bins // hop)
    frame = (rows * bins * 8 + rows * ((frames - 1) * hop + nf) * 8
             + 2 * rows * frames * nf * 8)
    conv = rows * frames * nf * 8 * (1 + m) + m * nf * 8
    crop, power = rows * m * bins * 12, rows * m * bins * 8
    before = dryrun.plane_bytes()
    S.accel_plane(spec, zmax=zmax)
    assert dryrun.plane_bytes() - before == frame + conv + crop + power

    trace.start()
    S.accel_plane(spec, zmax=zmax)
    spans = _spans(trace.stop())
    root = spans[0]
    assert root["name"] == "call:accel_plane" and root["parent"] == -1
    assert root["attrs"] == {"n": bins, "rows": rows}
    op = [i for i, s in enumerate(spans) if s["parent"] == 0]
    assert [spans[i]["name"] for i in op] == ["op:accel_plane"]
    kids = [s for s in spans if s["parent"] == op[0]]
    assert [s["name"] for s in kids] == ["frame", "call:convolve", "crop",
                                         "power"]
    assert [s["attrs"].get("bytes") for s in kids] == [frame, None, crop,
                                                       power]
    assert kids[1]["attrs"] == {"n": nf, "rows": rows * frames}
    assert "op:convolve" in {s["name"] for s in spans}
    assert all(s["root"] == 0 for s in spans)


def test_the_reference_imports_nothing_of_the_port_and_no_jax():
    tree = ast.parse(Path(ref.__file__).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names and set(names) <= {"__future__", "math", "torch"}


# ---------------------------------------------------------------------------
# The plane form's wrapper and the op's card branch, on CPU tensors.
# ---------------------------------------------------------------------------


def _wrapper_args(**bad):
    args = dict(x=torch.zeros(2, 1000, dtype=torch.complex64),
                h=torch.zeros(9, 256, dtype=torch.complex64), k=41)
    args.update(bad)
    return args


@pytest.mark.parametrize("bad,match", [
    (dict(x=torch.zeros(2, 1000)), "x must be complex64"),
    (dict(x=torch.zeros(2, 1000, dtype=torch.complex128)),
     "x must be complex64"),
    (dict(x=torch.zeros(2, 3, 1000, dtype=torch.complex64)),
     "x must be complex64"),
    (dict(x=torch.zeros(1000, dtype=torch.complex64)), "x must be complex64"),
    (dict(k=256), "1 <= k < n"),
    (dict(k=300), "1 <= k < n"),
    (dict(k=0), "1 <= k < n"),
    (dict(h=torch.zeros(256, dtype=torch.complex64)), r"h must be \(m, n\)"),
    (dict(h=torch.zeros(9, 300, dtype=torch.complex64)),
     r"h must be \(m, n\)"),
    (dict(h=torch.zeros(9, 128, dtype=torch.complex64)),
     r"h must be \(m, n\)"),
    (dict(h=torch.zeros(0, 256, dtype=torch.complex64)),
     r"h must be \(m, 256\)"),
    (dict(h=torch.zeros(9, 256, dtype=torch.complex128)),
     "h must be contiguous torch.complex64"),
    (dict(), "x must be a CUDA tensor"),
])
def test_the_plane_forms_wrapper_checks_its_arguments(bad, match):
    """``launch_conv_plane`` raises before any launch: a spectrum that is
    not complex64 (T, L), k outside [1, n), a response that is not (m, n)
    at a segment length from 256 or not of the tier's type, and a CPU
    tensor, which only the plain composition of ``accel_plane`` takes."""
    from smfft_tpu_torch.ops import _cuda
    from smfft_tpu_torch.ops import convolve as CV
    before = _cuda.CONV_PLANE.count
    with pytest.raises(ValueError, match=match):
        CV.launch_conv_plane(**_wrapper_args(**bad))
    assert _cuda.CONV_PLANE.count == before


def test_the_launch_counts_carry_the_plane_form():
    """``dryrun.counts()`` keys every kernel's declaration, the plane form
    last."""
    counts = dryrun.counts()
    assert list(counts)[-1] == "conv_plane"
    assert len(counts) == 12 and "conv" in counts


class _PlaneLib:
    """The library's entry points stood in: ``smfft_conv_plane`` records
    its arguments and returns 0; the others return 0."""

    def __init__(self):
        self.calls = []

    def smfft_conv_plane(self, *args):
        self.calls.append(args)
        return 0

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.mark.parametrize("precision", [None, "exact"])
def test_the_card_branch_is_one_launch_of_the_plane_form(monkeypatch,
                                                        precision):
    """``accel_plane`` of a spectrum that is not on the CPU: the op holds
    one ``launch:conv_plane`` and no framing, convolution, crop or power;
    the launch reads the spectrum in place, passes the segment length of
    ``choose_nfft``, the taps, the templates and the CPU path's unscaled
    responses; ``plane_bytes`` rises by
    the segments read, the responses once and the plane written."""
    import sys
    sys.path.insert(0, str(Path(__file__).parent))
    from torch_launch_path import launch_path
    from smfft_tpu_torch.ops import _cuda
    from smfft_tpu_torch.ops import c2c as C
    lib = launch_path(monkeypatch, _PlaneLib())
    monkeypatch.setattr(C, "is_cpu", lambda t: False)
    rows, n, zmax = 2, 1 << 12, 8
    spec = ref.spectrum(_trials(rows, n, 2)).to(torch.complex64)
    bins, m, k = n // 2 + 1, zmax + 1, 2 * accel.half_width(zmax) + 1
    nf = accel.choose_nfft(k)
    frames = -(-bins // (nf - k + 1))
    exact = precision == "exact"
    counts, moved = dryrun.counts(), dryrun.plane_bytes()
    trace.start()
    out = S.accel_plane(spec, zmax=zmax, precision=precision)
    spans = _spans(trace.stop())
    assert out.shape == (rows, m, bins) and out.dtype == torch.float32
    after = dryrun.counts()
    assert {c: after[c] - counts[c] for c in after
            if after[c] != counts[c]} == {"conv_plane": 1}
    (args,) = lib.calls
    h = accel.responses(zmax, 2, nf, exact, "cpu")
    assert args[0] == spec.data_ptr() and args[1] == out.data_ptr()
    assert args[2:7] == (rows, bins, nf, k, m)
    assert args[7] == h.data_ptr() and args[9] == int(exact)
    assert h.dtype == (torch.complex128 if exact else torch.complex64)
    assert dryrun.plane_bytes() - moved == (rows * frames * nf * 8 + h.nbytes
                                            + rows * m * bins * 4)
    assert [(s["name"], s["parent"]) for s in spans] == [
        ("call:accel_plane", -1), ("op:accel_plane", 0),
        ("launch:conv_plane", 1), ("alloc", 2), ("tables", 2), ("call", 2)]
    assert spans[2]["attrs"] == {"rows": rows * frames, "n": nf,
                                 "variant": "plane", "exact": exact}
    assert spans[3]["attrs"] == {"bytes": out.nbytes}
    # the responses are the CPU path's, built once and served from the
    # cache
    S.accel_plane(spec, zmax=zmax, precision=precision)
    assert lib.calls[1][7] == h.data_ptr()
