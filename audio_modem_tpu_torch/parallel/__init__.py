"""Batched multi-stream decode and the turbo receive round."""
