"""Run one cell of BENCHMARK.json once:

    python perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. It prints JSON lines as it goes and the result
as the last line of standard output; the numbers that decide ``correct``,
each beside its limit, are the last lines of standard error. Build and
compile caches stay inside the checkout (``build/``).
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("OMP_NUM_THREADS", "1")  # one process, few threads: the card does the work
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench.harness import main, process_start  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], process_start()))
