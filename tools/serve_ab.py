#!/usr/bin/env python3
"""Time the port's ``serve`` of one architecture in two checkouts, on one card.

    python3 tools/serve_ab.py --arch mamba2-370m OLD_ROOT NEW_ROOT

Each checkout root holds ``src/repro_torch``.  The script runs the two in
turns, old, new, new, old, each in a process of its own (so each imports
and builds its own kernels, into its own ``build/kernels``), and each
process serves the full-width model once to warm up and once timed, at
``--batch``, ``--prompt`` and ``--gen``.  It prints the card's name and
power limit, then one JSON line per run with ``serve``'s own
``prefill_s`` and ``decode_s_per_token``.  Comparing two versions within
one call, in that order, keeps the card and its host the same for both.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.launch.serve import serve
serve({arch!r}, smoke=False, batch={batch}, prompt=256, gen=2)
out = serve({arch!r}, smoke=False, batch={batch}, prompt={prompt}, gen={gen})
print(json.dumps({{"prefill_ms": out["prefill_s"] * 1e3,
                  "decode_ms_per_token": out["decode_s_per_token"] * 1e3}}))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    for label in ("old", "new", "new", "old"):
        src = str(Path(getattr(args, label)).resolve() / "src")
        code = CHILD.format(src=src, arch=args.arch, batch=args.batch,
                            prompt=args.prompt, gen=args.gen)
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": label, "arch": args.arch, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
