"""device_idle.blocks: ``device_idle`` (the share of the traced window in
which no operation ran on the card) in the cell that reports
``gbps.blocks``."""

from h100bench import spec

read = spec.load_module(spec.ROOT / "layers" / "device_idle.py").read
