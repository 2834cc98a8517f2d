"""Homomorphic integer circuits over encrypted words (PyTorch)."""
