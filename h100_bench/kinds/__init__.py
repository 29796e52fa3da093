"""Runners of the traffic kinds: ``<kind>.py`` holds ``run(cell) -> dict``
for the traffic files whose ``kind`` it is."""
