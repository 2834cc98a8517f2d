"""The plain reference that decides ``correct``.

It imports nothing of the program, nor ``jax``: the secret keys are
worked out again from the run's seed words with a frozen copy of the key
derivation (:mod:`.keys`), the answer ciphertexts the program produced
are decrypted with them, and each lane is held to the value of the
expression on plain integers under the evaluator's documented semantics
(:mod:`.answer`).
"""
