"""idle_api_ms.blocks: ``idle_api_ms`` in the cell that reports
``gbps.blocks``."""

from h100bench import spec

_base = spec.load_module(spec.ROOT / "layers" / "idle_api_ms.py")
start, stop, read = _base.start, _base.stop, _base.read
