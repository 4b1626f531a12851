"""Batched box-ADMM kernels (hand-written for Hopper)."""
