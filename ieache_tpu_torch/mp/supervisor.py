"""Process supervision — the reference's respawn loops (C23).

The port's own copy of :mod:`ieache_tpu.mp.supervisor`, pinned to it by
``tests/test_torch_mp.py``.

Counterpart of the ``*_dynamic.py`` wrappers
(``/root/reference/Client1/client_dynamic.py:8-13``,
``Cloud/cloud_dynamic2.py`` etc.: infinite
``while True: os.system('python3 worker.py')`` loops) and the systemd
units that run them (``Client1/Services/MP.service:1-10``).  This
version adds bounded restarts, backoff, and structured logging;
deploy/ contains the systemd unit templates.
"""

from __future__ import annotations

import logging
import subprocess
import sys
import time

log = logging.getLogger("ieache.supervisor")


def supervise(cmd, max_restarts: int | None = None,
              delay: float = 1.0, backoff: float = 2.0,
              max_delay: float = 60.0) -> int:
    """Run `cmd` forever (or max_restarts times), restarting on exit.

    Returns the last exit code when max_restarts is exhausted.
    """
    restarts = 0
    cur_delay = delay
    code = 0
    while True:
        t0 = time.time()
        log.info("starting %s (restart %d)", cmd, restarts)
        proc = subprocess.run(cmd)
        code = proc.returncode
        ran_for = time.time() - t0
        log.warning("process exited code=%s after %.1fs", code, ran_for)
        restarts += 1
        if max_restarts is not None and restarts >= max_restarts:
            return code
        # reset backoff after a healthy run
        cur_delay = delay if ran_for > 30 else min(
            cur_delay * backoff, max_delay
        )
        time.sleep(cur_delay)


def main():
    logging.basicConfig(level=logging.INFO)
    if len(sys.argv) < 2:
        print("usage: python -m ieache_tpu_torch.mp.supervisor <cmd> [args...]")
        sys.exit(2)
    sys.exit(supervise(sys.argv[1:]))


if __name__ == "__main__":
    main()
