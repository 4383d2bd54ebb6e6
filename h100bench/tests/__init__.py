"""CPU tests of the benchmark harness: ``python -m pytest h100bench/tests``."""
