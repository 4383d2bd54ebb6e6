"""idle_launch_ms.blocks: ``idle_launch_ms`` in the cell that reports
``gbps.blocks``."""

from h100bench import spec

_base = spec.load_module(spec.ROOT / "layers" / "idle_launch_ms.py")
start, stop, read = _base.start, _base.stop, _base.read
