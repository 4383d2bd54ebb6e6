"""The port's verification CLI and host harness, on the CPU.

``python -m smfft_tpu_torch.verify N nFFTs nRuns inverse reorder`` runs the
plain version here (no GPU) and must print PASSED; the harness copied into
``smfft_tpu_torch/native`` must give the numpy fallback's statistics.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

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


@pytest.mark.parametrize("kind", ["r2c", "c2r"])
def test_real_kinds_not_ported(kind):
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        verify.main(["256", "8", "--kind", kind])


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
