#!/usr/bin/env python3
"""Dry-run every (arch x shape) cell of the port, in parallel processes,
then print ``analysis.report``'s tables of the records.

    python3 tools/dryrun_sweep.py [--mesh single|multi|both] [--rules train]
                                  [--kind train|prefill|decode] [--jobs 8]
                                  [--out results/dryrun_torch]

Each cell is one ``python -m repro_torch.launch.dryrun`` process with the
card hidden (``CUDA_VISIBLE_DEVICES`` empty): the dry run needs none.  A
cell's process that fails or outlives ``--timeout`` is reported and the
sweep goes on; the exit code is 1 if any did.  ``--kind`` keeps the
cells of one kind of shape, and prints each record's argument bytes (the
cache's in a decode cell) exactly.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    from repro_torch.analysis import report
    from repro_torch.configs import cells

    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--rules", default="train")
    ap.add_argument("--kind", default=None,
                    choices=("train", "prefill", "decode"))
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", default=str(ROOT / "results" / "dryrun_torch"))
    args = ap.parse_args()
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    todo = [(a.name, s.name, m) for a, s, _ in cells() for m in meshes
            if args.kind in (None, s.kind)]

    def one(cell):
        arch, shape, mesh = cell
        t0 = time.perf_counter()
        try:
            out = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", mesh, "--rules",
                 args.rules, "--out", args.out, "--force"], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=args.timeout)
            rc, text = out.returncode, out.stdout + out.stderr
        except subprocess.TimeoutExpired:
            rc, text = "timeout", ""
        print(f"[sweep] {arch} {shape} {mesh}: rc {rc} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if rc != 0:
            print(text[-2000:], flush=True)
        return rc == 0

    with ThreadPoolExecutor(args.jobs) as pool:
        ok = list(pool.map(one, todo))
    recs = report.load(args.out)
    for mesh in meshes:
        print(f"\n### Roofline ({mesh}, {args.rules} rules)\n")
        print(report.roofline_table(recs, mesh, args.rules))
    print("\n### Dry-run summary\n")
    print(report.dryrun_table([r for r in recs
                               if r.get("rules", "train") == args.rules
                               and r["status"] in ("ok", "skipped")]))
    if args.kind:
        names = {(a, s, m) for a, s, m in todo}
        for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
            if (r["arch"], r["shape"], r["mesh"]) in names and r[
                    "status"] == "ok":
                print(f"[sweep] {r['arch']} {r['shape']} {r['mesh']}: "
                      f"argument_bytes={r['memory']['argument_bytes']} "
                      f"peak_bytes={r['memory']['peak_bytes']}", flush=True)
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
