"""Feature flags — the analogue of the reference's debug.h.

Read from the environment once at import, with programmatic overrides for
tests (assign to the fields of :data:`flags`).

Flags:
  SMFFT_DEBUG      — verbose prints from harness and build paths
  SMFFT_TESTING    — run the golden comparison in ``verify``
  SMFFT_PRECISION  — default precision tier when a call passes None
"""

from __future__ import annotations

import dataclasses
import os


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("0", "false", "no", "off", "")


@dataclasses.dataclass
class Flags:
    debug: bool = _env_bool("SMFFT_DEBUG", False)
    testing: bool = _env_bool("SMFFT_TESTING", True)
    precision: str = os.environ.get("SMFFT_PRECISION", "highest")


flags = Flags()


def debug_print(*args) -> None:
    """printf gated on the DEBUG flag (reference debug.h:1 usage)."""
    if flags.debug:
        print("[smfft]", *args)
