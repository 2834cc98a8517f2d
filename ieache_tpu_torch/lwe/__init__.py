"""LWE encryption and decryption of bits on torch tensors."""
