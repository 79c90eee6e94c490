"""The host-side data plane: the native compressed-video decoder's binding,
per-video payloads, evaluation and training batch assembly, datasets."""
