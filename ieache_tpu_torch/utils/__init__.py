"""Host utilities of the port (the normative threefry PRNG)."""
