"""Batched SoA rigid-body physics and its CUDA kernel."""
