"""The H100 benchmark of smfft_tpu_torch, driven by ``BENCHMARK.json``.

One process runs one cell once (``python3 -m h100bench.run --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``).  Each configuration,
traffic mix, work count and metric reader is a file of its own under this
directory, found by the name ``BENCHMARK.json`` gives it; ``README.md``
says how to add one.
"""
