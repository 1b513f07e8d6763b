"""The benchmark's command, run from the repository root:

    python3 -m slam_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output (``harness``).
"""

import os
import time


def _process_start() -> float:
    """The process's start as wall-clock seconds (Linux: its start tick
    after boot), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


_PROCESS_START = _process_start()

# one process with few threads: one intra-op thread
os.environ["OMP_NUM_THREADS"] = "1"

import sys  # noqa: E402

from slam_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(_PROCESS_START))
