"""The periodicity-search deployment on the CPU: ``api.rfft_large`` of DM
trials held against the plain reference
(``smfft_tpu_torch/reference/periodicity_search.py``) in both packing
modes, the reference's independence from the port, and the plan that the
deployment's call (128 trials of 2^23 samples) runs on the card."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from smfft_tpu_torch import api
from smfft_tpu_torch.ops import fourstep_fused as FF
from smfft_tpu_torch.ops import hugefft
from smfft_tpu_torch.ops import real_fused as RF
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


def test_the_reference_imports_nothing_of_the_port_and_no_jax():
    tree = ast.parse(REF_PATH.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
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
