"""Static FFT plans and constant tables (numpy only).

The plan layer of the reference's template classes (``fft_exp``,
``fft_length``, ``fft_direction``, ``fft_reorder``;
SMFFT_CooleyTukey_C2C/SM_FFT_parameters.cuh:1-390): a frozen, hashable
:class:`FFTParams` per (size, direction, kind, ordered), with the same
fields, size tables and "Error wrong FFT length!" contract as
``smfft_tpu.params``.  Importing this module loads no framework, so the
JAX package and this port start from the same plans and the same numbers.

Twiddles are computed in float64 and rounded once to fp32 (the reference
recomputes ``sincosf`` under ``--use_fast_math``; that is deliberately not
replicated), which keeps the fp32 error near numpy's.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Literal

import numpy as np

SUPPORTED_C2C_SIZES: tuple[int, ...] = (32, 64, 128, 256, 512, 1024, 2048,
                                        4096, 8192, 16384)
SUPPORTED_REAL_SIZES: tuple[int, ...] = (64, 128, 256, 512, 1024, 2048,
                                         4096, 8192, 16384)

Direction = Literal["forward", "inverse"]
Kind = Literal["c2c", "r2c", "c2r"]

# The mixed-radix split each plan carries.  The values are the JAX
# package's defaults, kept so that a plan's fields equal the reference
# plan's; the Hopper kernel picks its own radix-8/4/2 stage ladder.
_FACTORS: dict[int, tuple[int, ...]] = {
    32: (32,),
    64: (64,),
    128: (16, 8),
    256: (16, 16),
    512: (32, 16),
    1024: (32, 32),
    2048: (64, 32),
    4096: (16, 16, 16),
    8192: (32, 16, 16),
    16384: (32, 32, 16),
}


@dataclasses.dataclass(frozen=True)
class FFTParams:
    """Frozen, hashable FFT plan.

    * ``n``         — transform length (the real length for r2c/c2r,
                      whose complex core runs at n // 2).
    * ``direction`` — "forward" | "inverse".
    * ``kind``      — "c2c" | "r2c" | "c2r".
    * ``ordered``   — natural-order output if True (reference
                      ``fft_reorder=1``); the unordered layout otherwise.
    * ``radices``   — the mixed-radix split of the core length.
    """

    n: int
    direction: Direction = "forward"
    kind: Kind = "c2c"
    ordered: bool = True
    radices: tuple[int, ...] = ()

    def __post_init__(self):
        if self.kind == "c2c":
            if self.n not in SUPPORTED_C2C_SIZES:
                raise ValueError(
                    f"Error wrong FFT length! c2c n={self.n} not in "
                    f"{SUPPORTED_C2C_SIZES}"
                )
        else:
            if self.n not in SUPPORTED_REAL_SIZES:
                raise ValueError(
                    f"Error wrong FFT length! {self.kind} n={self.n} not in "
                    f"{SUPPORTED_REAL_SIZES}"
                )
        core_n = self.n if self.kind == "c2c" else self.n // 2
        if not self.radices:
            object.__setattr__(self, "radices", _FACTORS[core_n])
        if math.prod(self.radices) != core_n:
            raise ValueError(f"prod{self.radices} != core size {core_n}")

    @property
    def exp(self) -> int:
        return self.n.bit_length() - 1

    @property
    def core_n(self) -> int:
        """Length of the underlying complex transform."""
        return self.n if self.kind == "c2c" else self.n // 2

    @property
    def sign(self) -> float:
        """Twiddle exponent sign: -1 forward (e^{-2πi nk/N}), +1 inverse."""
        return -1.0 if self.direction == "forward" else +1.0


@lru_cache(maxsize=None)
def plan_for(
    n: int,
    direction: Direction = "forward",
    kind: Kind = "c2c",
    ordered: bool = True,
) -> FFTParams:
    """Cached plan constructor (the reference's static size switch,
    SMFFT_CooleyTukey_C2C/FFT-GPU-32bit.cu:599-659)."""
    return FFTParams(n=n, direction=direction, kind=kind, ordered=ordered)


def plan_from_jax(fields: dict) -> FFTParams:
    """Rebuild a plan from the JAX package's ``FFTParams`` fields, given as
    plain values (``dataclasses.asdict`` of a ``smfft_tpu`` plan).  An FFT
    has no weights: the plan and its tables are the state both packages
    share."""
    names = {f.name for f in dataclasses.fields(FFTParams)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown plan fields {sorted(unknown)}")
    kw = dict(fields)
    if "radices" in kw:
        kw["radices"] = tuple(int(r) for r in kw["radices"])
    return FFTParams(**kw)


@lru_cache(maxsize=None)
def twiddle_table(n: int, inverse: bool) -> np.ndarray:
    """W_N^m = exp(±2πi m / N) for m = 0..N-1 as an (N, 2) fp32 (re, im)
    array: float64 angles, rounded once.  The Hopper kernel reads every
    stage twiddle from this table."""
    sign = +1.0 if inverse else -1.0
    ang = sign * 2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    tab = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    tab.setflags(write=False)
    return tab
