"""Streaming inference and detection post-processing."""
