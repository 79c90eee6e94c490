"""The benchmark of lsfa_tpu_torch on an NVIDIA H100: see ``benchmark/run.py``."""
