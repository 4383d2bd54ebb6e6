"""What the run ran on: the card's name, count and power limit."""

from __future__ import annotations

import subprocess

import torch


def power_limit(index: int = 0) -> str:
    """``nvidia-smi``'s power limit of card ``index`` ("700.00 W"), or
    "unknown" where it cannot be read."""
    try:
        done = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return done.stdout.strip() or "unknown"


def describe(device: str, count: int) -> dict:
    """The result line's ``device``: platform, kind, count; the power limit
    rides along (the driver ignores keys it does not read)."""
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": count, "power_limit": power_limit(0)}
    return {"platform": device, "kind": device, "count": count}


def memory_peak(device: str) -> int:
    """Peak bytes allocated on the fullest card used so far."""
    if device != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(i)
               for i in range(torch.cuda.device_count()))
