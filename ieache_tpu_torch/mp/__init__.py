"""The six-role protocol of the port: key plane (Dragonfly SAE, AES key
wrap), BER transport, the four node roles and their in-process
simulation, with the Cloud evaluating on an explicit device."""
