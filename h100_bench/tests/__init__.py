"""The benchmark's own tests (``python3 -m pytest h100_bench/tests``)."""
