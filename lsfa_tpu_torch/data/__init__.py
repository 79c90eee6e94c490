"""Host-side batch assembly for training."""
