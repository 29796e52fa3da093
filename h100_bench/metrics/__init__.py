"""Per-layer metrics: ``<name>.py`` holds ``read(ctx) -> float | None`` of
the metric of that name in ``BENCHMARK.json``; ``work.py`` holds the
frozen work counts and peaks they share."""
