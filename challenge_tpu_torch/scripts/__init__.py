"""Runnable demonstrations of the port, counterparts of the scripts in the
repository's ``scripts/`` directory; each runs with
``python -m challenge_tpu_torch.scripts.<name>``.
"""
