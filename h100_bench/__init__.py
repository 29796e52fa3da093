"""The benchmark of challenge_tpu_torch on NVIDIA H100 cards (see
``run.py``; the cells are listed in ``BENCHMARK.json``)."""
