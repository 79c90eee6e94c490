"""Host-side utilities of lsfa_tpu_torch."""
