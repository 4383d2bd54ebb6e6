"""host_ms.blocks: ``host_ms`` (mean host time a step inside the public
calls) in the cell that reports ``gbps.blocks``."""

from h100bench import spec

read = spec.load_module(spec.ROOT / "layers" / "host_ms.py").read
