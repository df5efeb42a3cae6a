"""Measurement scripts for the port, run on the CUDA card."""
