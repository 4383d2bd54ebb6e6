"""gbps.blocks: ``gbps`` (bytes of every step over the window's wall time)
in the cell whose step the host's issue of the call holds as long as the
kernel, under a bound of its own so that its spread does not widen the
bulk cells'."""

from h100bench import spec

read = spec.load_module(spec.ROOT / "end_to_end" / "gbps.py").read
