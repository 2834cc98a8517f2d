"""Exact negacyclic torus-polynomial arithmetic (PyTorch)."""
