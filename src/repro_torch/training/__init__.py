"""Serving steps of the port (training waits for its backward kernels)."""
