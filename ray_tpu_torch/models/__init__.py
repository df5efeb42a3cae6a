"""Llama-family inference: the model, its dense-slot decode path, its
paged-KV decode path, and the numpy parameter converter."""
