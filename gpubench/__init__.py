"""The benchmark of ``repro_torch`` on NVIDIA GPUs: one command runs one
cell of ``BENCHMARK.json`` once (``python3 -m gpubench.run``).  README.md
says how it is driven and extended."""
