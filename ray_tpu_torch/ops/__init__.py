"""Compute ops: transformer layers and the two attention kernels
(flash-attention forward, paged decode attention) with their plain
PyTorch versions."""
