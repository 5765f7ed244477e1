"""Metric math on tensors, and the hand-written CUDA kernels under ``cuda/``."""
