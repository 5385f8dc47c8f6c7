"""Tensor ops of the port; the hand-written CUDA kernels build on first use
(ops/_build.py), never at import."""
