"""On-disk formats of the port (the IEK1 container)."""
