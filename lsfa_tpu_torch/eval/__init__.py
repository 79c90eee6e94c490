"""Streaming inference, detection post-processing, the evaluation loops
over videos and VID scoring."""
