"""Aggregate dry-run artifacts into the EXPERIMENTS.md roofline tables; the
counterpart of ``repro.launch.roofline_table``.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline_table [--dir artifacts/dryrun]
Emits a markdown table per mesh + a bottleneck summary + hillclimb-candidate
ranking (worst roofline fraction / most collective-bound / paper-representative).
Rows keep the reference's keys, so rows of either package's dry run read
alike; the collective term is the H100's NVLink where the reference's is
the TPU's ICI.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def load_rows(directory):
    rows = []
    for p in sorted(Path(directory).glob("*.json")):
        try:
            rows.append(json.loads(p.read_text()))
        except json.JSONDecodeError:
            continue
    return rows


def fmt_table(rows, mesh):
    out = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "useful | mem/dev (adj) GiB | MFU-at-bound |",
        "|------|-------|-----------|----------|--------------|----------|"
        "--------|-------------------|--------------|",
    ]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r.get("mesh") != mesh or "skipped" in r:
            continue
        mem = (r.get("mem_per_device_adjusted")
               or (r["arg_bytes"] + r["temp_bytes"])) / 2**30
        useful = r.get("useful_ratio")
        mfu = r.get("roofline_fraction", 0.0)
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.3f} | "
            f"{r['dominant']} | "
            f"{useful:.2f} | {mem:.1f} | {mfu * 100:.1f}% |"
            if useful is not None else
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.3f} | "
            f"{r['dominant']} | - | {mem:.1f} | {mfu * 100:.1f}% |"
        )
    return "\n".join(out)


def candidates(rows):
    """Hillclimb picks: worst roofline fraction, most collective-bound,
    paper-representative (largest CP/LCD-style serialization: decode)."""
    single = [r for r in rows if r.get("mesh") == "16x16" and "skipped" not in r]
    if not single:
        return {}
    worst = min(single, key=lambda r: r.get("roofline_fraction", 1.0))
    coll = max(single, key=lambda r: r.get("collective_s", 0.0)
               / max(r.get("bound_s", 1e-9), 1e-9))
    return {"worst_roofline_fraction": f"{worst['arch']} x {worst['shape']} "
                                       f"({worst['roofline_fraction'] * 100:.1f}%)",
            "most_collective_bound": f"{coll['arch']} x {coll['shape']} "
                                     f"(NVLink {coll['collective_s']:.3f}s of "
                                     f"bound {coll['bound_s']:.3f}s)"}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    args = ap.parse_args()
    rows = load_rows(args.dir)
    for mesh in ("16x16", "2x16x16"):
        n = sum(1 for r in rows if r.get("mesh") == mesh and "skipped" not in r)
        print(f"\n### mesh {mesh} ({n} cells)\n")
        print(fmt_table(rows, mesh))
    print("\n### hillclimb candidates\n")
    for k, v in candidates(rows).items():
        print(f"- {k}: {v}")


if __name__ == "__main__":
    main()
