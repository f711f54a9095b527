"""The readings a cell's limits are set from, on the card, in one process:

    python perfbench/calibrate.py --workload NAME --seeds 1 2 ... \
        [--control-seeds 1 2 3]

For each seed it builds the cell's program from that seed, runs the calls
that the check reads (the waves a window samples, each a whole wave at the
cell's own load), frees the program and prints the numbers that the output
check compares (the lower readings). For each control seed it also prints
the control's: the float32 reference against the same reference computed
with float8 products (the upper readings). Every line is JSON; the
last one is the summary per number: the largest sound reading and the
smallest control reading.
"""

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("calibration reads the card; none is available", file=sys.stderr)
        return 3
    spec = harness.CellSpec(args.workload)
    device = torch.device("cuda", 0)
    harness.log(card=harness.card(0), workload=args.workload)
    _build.build()
    sound, control = {}, {}
    for seed in args.seeds:
        t0 = time.time()
        cell = spec.driver().Cell(spec.config, spec.mix, seed, device)
        cell.setup()
        torch.cuda.reset_peak_memory_stats()
        # A call's wave depends on (seed, index) alone: the sampled calls
        # are those a window would make at these indices.
        records = [cell.call(i) for i in sorted(cell.sampled)]
        cell.release()
        got, low = cell.readings(records, control=seed in args.control_seeds)
        harness.log(seed=seed, sound=got, control=low, seconds=time.time() - t0,
                    reference_peak_bytes=torch.cuda.max_memory_allocated())
        for k, v in got.items():
            if isinstance(v, float):
                sound[k] = max(sound.get(k, 0.0), v)
        for k, v in (low or {}).items():
            control[k] = min(control.get(k, float("inf")), v)
        del cell
    harness.log(summary={k: {"lower": sound[k], "upper": control.get(k)} for k in sound})
    return 0


if __name__ == "__main__":
    sys.exit(main())
