"""Experiment launchers of lsfa_tpu_torch, run with ``python -m``."""
