"""idle_caller_ms.blocks: ``idle_caller_ms`` in the cell that reports
``gbps.blocks``."""

from h100bench import spec

_base = spec.load_module(spec.ROOT / "layers" / "idle_caller_ms.py")
start, stop, read = _base.start, _base.stop, _base.read
