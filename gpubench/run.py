"""Runs one cell of the port's benchmark once and prints its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON); the lines before it on standard error record the card,
its clocks and power limit beside the window, the kernels' launches, and
last, each number the correctness check compared with its limit.
"""

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
ROOT = Path(__file__).resolve().parents[1]
# the checkout's root and the port's sources; not this folder, whose
# module names would shadow the standard library's
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

if __name__ == "__main__":
    from gpubench.harness import main
    sys.exit(main(t_start=T_START))
