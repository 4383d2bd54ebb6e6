"""The port's example runs end to end on the CPU (``--device cpu``: the
kernels' plain versions), detects its planted signals, and detects the
same template and lag in every stream as the JAX example on the same seed."""

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--streams", "8", "--length", "1024", "--templates", "4",
        "--klen", "128", "--snr", "1.0", "--selfcheck"]


def examples():
    if str(ROOT / "examples") not in sys.path:
        sys.path.insert(0, str(ROOT / "examples"))
    import matched_filter
    import matched_filter_torch
    return matched_filter, matched_filter_torch


def jax_detections(module, argv):
    """Run the JAX example's main and read its detections (``det_tpl``,
    ``det_off``) from its frame as it returns; the example itself only
    prints them."""
    seen = {}

    def watch(frame, event, arg):
        if event == "return" and frame.f_code is module.main.__code__:
            seen.update(frame.f_locals)

    sys.setprofile(watch)
    try:
        rc = module.main(argv)
    finally:
        sys.setprofile(None)
    return rc, seen["det_tpl"], seen["det_off"]


def test_matched_filter_torch_example(capsys):
    _, port = examples()
    assert port.main(ARGV + ["--device", "cpu"]) == 0
    assert "SELFCHECK PASSED" in capsys.readouterr().out


def test_matched_filter_torch_detects_what_jax_detects():
    jax_example, port = examples()
    rc, jax_tpl, jax_off = jax_detections(jax_example, ARGV)
    assert rc == 0
    got = {}
    assert port.main(ARGV + ["--device", "cpu"], result=got) == 0
    np.testing.assert_array_equal(got["det_tpl"], jax_tpl)
    np.testing.assert_array_equal(got["det_off"], jax_off)


def test_matched_filter_torch_needs_the_card_unless_told(monkeypatch,
                                                         capsys):
    """No silent CPU path: without a card and without --device cpu the
    example exits non-zero and says why."""
    _, port = examples()
    monkeypatch.setattr(port.torch.cuda, "is_available", lambda: False)
    assert port.main(ARGV) == 2
    assert "no CUDA device" in capsys.readouterr().err
