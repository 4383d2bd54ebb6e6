"""The port's verification CLI and host harness, on the CPU.

``python -m smfft_tpu_torch.verify N nFFTs nRuns inverse reorder
[--kind c2c|r2c|c2r] --device cpu`` runs the plain versions here (no GPU)
and must print PASSED; without ``--device cpu`` it must refuse to run.  The
harness copied into ``smfft_tpu_torch/native`` must give the numpy
fallback's statistics.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from smfft_tpu_torch import native, verify

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("args", [["256", "64", "1", "0", "1"],
                                  ["256", "64", "1", "1", "0"],
                                  ["32", "6", "1", "0", "0"]])
def test_verify_cli_passes(args):
    proc = subprocess.run(
        [sys.executable, "-m", "smfft_tpu_torch.verify", *args,
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PASSED" in proc.stdout
    assert "GB/s" not in proc.stdout  # no device metric from a CPU run


def test_verify_fails_on_wrong_output(monkeypatch, capsys):
    from smfft_tpu_torch import api
    monkeypatch.setattr(api, "fft", lambda a, **kw: a)
    assert verify.main(["128", "8", "1", "0", "1", "--device", "cpu"]) == 1
    assert "FAILED" in capsys.readouterr().out


@pytest.mark.parametrize("args", [["256", "8", "1", "--kind", "r2c"],
                                  ["256", "8", "1", "--kind", "c2r"],
                                  ["64", "6", "1", "--kind", "r2c",
                                   "--precision", "exact"]])
def test_verify_real_kinds_pass(args):
    """--kind r2c (packed output, Compare_R2C_output) and --kind c2r (raw
    (N/2)-scaled output, Compare_C2R_output) on the CPU's plain versions."""
    proc = subprocess.run(
        [sys.executable, "-m", "smfft_tpu_torch.verify", *args,
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PASSED" in proc.stdout
    assert f"kind={args[4]}" in proc.stdout


@pytest.mark.parametrize("kind", ["r2c", "c2r"])
def test_verify_real_kinds_fail_on_wrong_output(monkeypatch, capsys, kind):
    from smfft_tpu_torch import api
    if kind == "r2c":
        monkeypatch.setattr(api, "fft_packed_real",
                            lambda a, **kw: torch.zeros(
                                a.shape[0], a.shape[1] // 2,
                                dtype=torch.complex64))
    else:
        monkeypatch.setattr(api, "irfft", lambda a, n, **kw: torch.zeros(
            a.shape[0], n))
    assert verify.main(["128", "8", "1", "--kind", kind, "--device",
                        "cpu"]) == 1
    assert "FAILED" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["256", "8"], ["256", "8", "--kind", "r2c"],
                                  ["256", "8", "--device", "cuda"]])
def test_verify_refuses_without_gpu(monkeypatch, capsys, argv):
    """Without a GPU and without --device cpu the harness runs nothing:
    it exits non-zero and names the missing device."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from smfft_tpu_torch import api

    def boom(*a, **k):
        raise AssertionError("a transform ran")
    for name in ("fft", "ifft", "fft_packed_real", "irfft"):
        monkeypatch.setattr(api, name, boom)
    assert verify.main(argv) != 0
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and "--device cpu" in out.err
    assert "PASSED" not in out.out


def test_native_library_builds_from_own_copy():
    lib = native.get_lib()
    assert lib is not None, "g++ build of the port's harness failed"
    assert Path(lib._name).parent == ROOT / "smfft_tpu_torch" / "native"


def test_native_compare_matches_numpy_fallback():
    re = native.generate_uniform(4096, 7).reshape(16, 256)
    im = native.generate_uniform(4096, 8).reshape(16, 256)
    want = (re + 1j * im).astype(np.complex64) * 40.0
    got = want.copy()
    got[::3] += np.float32(3e-4)
    got[5, 7] += np.complex64(0.5 - 2j)
    a = native.compare(got, want, 1e-4)
    b = native.compare_np(got, want, 1e-4)
    assert a["error_count"] == b["error_count"] > 0
    for key in ("total_error", "mean_error", "max_error"):
        assert a[key] == pytest.approx(b[key], rel=1e-5)


def test_generate_uniform_seeded():
    a = native.generate_uniform(1000, seed=42)
    assert np.array_equal(a, native.generate_uniform(1000, seed=42))
    assert not np.array_equal(a, native.generate_uniform(1000, seed=43))
    assert a.min() >= -0.5 and a.max() <= 0.5


def test_native_real_compares_match_numpy_fallback():
    """compare_r2c_packed and compare_real: the C harness and the numpy
    fallback agree, and each catches a planted error."""
    x = native.generate_uniform(16 * 256, 9).reshape(16, 256)
    full = np.fft.rfft(x.astype(np.float64)).astype(np.complex64)
    packed = np.concatenate([full[:, :1].real + 1j * full[:, 128:].real,
                             full[:, 1:128]], axis=1).astype(np.complex64)
    packed[3, 0] += np.complex64(0.5j)   # a wrong Nyquist
    packed[7, 9] += np.complex64(2e-3)
    got = native.compare_r2c_packed(packed, full)
    assert got["error_count"] == 2
    raw = (x * 128).astype(np.float32)
    raw[2, 5] += 1.0
    got_real = native.compare_real(raw, x, got_scale=128)
    assert got_real["error_count"] == 1
    lib = native.get_lib()
    try:
        native._lib = None
        native._tried = True
        want = native.compare_r2c_packed(packed, full)
        want_real = native.compare_real(raw, x, got_scale=128)
    finally:
        native._lib = lib
    for a, b in ((got, want), (got_real, want_real)):
        assert a["error_count"] == b["error_count"]
        for key in ("total_error", "mean_error", "max_error"):
            assert a[key] == pytest.approx(b[key], rel=1e-5)
