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


class _CardC2C:
    """``ops/c2c`` as ``ops/fourstep_fused`` sees it, every tensor on the
    card branch."""

    def __getattr__(self, name):
        return getattr(C, name)

    @staticmethod
    def is_cpu(t):
        return False


def column_launches(monkeypatch, compute: bool = True) -> list:
    """Stand in the huge-N passes' card branch through ``monkeypatch``:
    ``ops/fourstep_fused`` takes its card path for CPU tensors (the row
    calls keep theirs), and each launch of the pass kernel appends (its
    Pass, its ``at``) to the list returned, makes its outputs, and with
    ``compute`` writes its plain function (``pass_plain``) into them."""
    import torch

    from smfft_tpu_torch.ops import fourstep_fused as FF
    log = []

    def launch(src, dst, n, p, *, inverse=False, scale=1.0, exact=False,
               at=None, mid=None):
        dst = dst() if callable(dst) else dst
        if callable(mid):
            mid()
        log.append((p, at))
        if compute:
            dst.copy_(FF.pass_plain(
                src.to(torch.complex128 if exact else torch.complex64), n,
                p, inverse, scale))
        return dst
    monkeypatch.setattr(FF, "C", _CardC2C())
    monkeypatch.setattr(FF, "launch_pass", launch)
    return log
