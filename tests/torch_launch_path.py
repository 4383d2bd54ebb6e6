"""The port's one launch path (``smfft_tpu_torch/ops/_cuda.py``) stood in
for CPU tensors, so that tests reach the card branch of the launch wrappers
without a card."""

from __future__ import annotations

from smfft_tpu_torch.ops import _cuda
from smfft_tpu_torch.ops import c2c as C


def launch_path(monkeypatch, lib, current=lambda: -1,
                stream=lambda index: 0):
    """Stand in the launch path through ``monkeypatch``: each declared entry
    point bound to ``lib``'s attribute of its symbol (None: unbound), the
    current device and the raw stream to the functions given, the row check
    to CPU tensors, and the C2C plan cache emptied.  Returns ``lib``."""
    for e in _cuda.ENTRIES:
        monkeypatch.setattr(e, "fn", getattr(lib, e.symbol, None))
    monkeypatch.setattr(_cuda, "_current_device", current)
    monkeypatch.setattr(_cuda, "_raw_stream", stream)
    monkeypatch.setattr(_cuda, "_CARD", "cpu")
    monkeypatch.setattr(C, "_plans", {})
    return lib
