"""The benchmark of the PyTorch port (``repro_torch``): ``run.py`` runs one
cell of ``BENCHMARK.json``; see ``PERF.md`` for what it measures."""
