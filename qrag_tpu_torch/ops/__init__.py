"""Ops of the port: plain-torch ops and the CUDA kernels' wrappers."""
