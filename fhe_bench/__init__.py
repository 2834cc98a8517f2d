"""The benchmark of ``ieache_tpu_torch`` on the card.

Run one cell from the root of a checkout::

    python3 -m fhe_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root names the cells; everything a cell uses
is found by name: its configuration in ``configs/``, its traffic mix in
``traffic/`` and each metric's reader in ``metrics/``.  The plain
reference that decides ``correct`` is ``reference/``; ``tests/`` holds
the CPU tests.
"""
