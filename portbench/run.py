"""One run of one cell of the port's benchmark:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA device. Without one
it exits with 2 and prints no result. See ``portbench/harness.py``.
"""

import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import cache_env, main  # noqa: E402

if __name__ == "__main__":
    cache_env()
    sys.exit(main(t_start=T_START))
