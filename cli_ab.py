#!/usr/bin/env python3
"""The command-line renderer of two checkouts on one card, in turns:

    python3 cli_ab.py OTHER_DIR

OTHER_DIR is a checkout of another commit, unpacked into a directory that
.gitignore lists:

    mkdir -p _ab/parent && git archive <commit> | tar -x -C _ab/parent

For each spp of SPPS (chip_smoke's phase 10 frame, 4, and the CLI's
default, 50), `python -m jet_pbrt_tpu_torch.cli 1 SPP --size 1024` runs as
a fresh process in each tree: once untimed (its kernel builds and its
assets), then in the order other, this, this, other. Prints each run's
process wall and the render time the CLI prints (its first call's set-up
included), their medians, and fails unless the two trees' BMPs are equal
byte for byte. Prints the card's name and power limit first. Needs one
GPU.
"""
from __future__ import annotations

import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

SPPS = (4, 50)
ORDER = ("other", "this", "this", "other")
ROOT = os.path.dirname(os.path.abspath(__file__))
RENDER_S = re.compile(r"render finished on cuda in ([0-9.]+) s")


def run_cli(tree: str, spp: int, out: str) -> tuple[float, float]:
    """(process wall s, render s as the CLI prints it) of one CLI run."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "jet_pbrt_tpu_torch.cli", "1", str(spp),
         "--size", "1024", "--out", out], cwd=tree,
        env=dict(os.environ, PYTHONPATH=tree), capture_output=True,
        text=True, timeout=900)
    wall = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    found = RENDER_S.search(text)
    if proc.returncode != 0 or found is None:
        raise AssertionError(f"the CLI in {tree} exited {proc.returncode}:\n"
                             f"{text}")
    return wall, float(found.group(1))


def main(argv) -> int:
    if len(argv) != 1 or not os.path.isdir(argv[0]):
        raise SystemExit(__doc__)
    trees = {"other": os.path.abspath(argv[0]), "this": ROOT}
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for spp in SPPS:
            bmps = {}
            for who, tree in trees.items():
                run_cli(tree, spp, os.path.join(tmp, who))
                with open(os.path.join(tmp, who + ".bmp"), "rb") as f:
                    bmps[who] = f.read()
            if bmps["this"] != bmps["other"]:
                raise AssertionError(f"cli 1 {spp}: the two trees' BMPs "
                                     "differ")
            runs = {"this": [], "other": []}
            for who in ORDER:
                runs[who].append(run_cli(trees[who], spp,
                                         os.path.join(tmp, who)))
            med = {who: (statistics.median(w for w, _ in r),
                         statistics.median(s for _, s in r))
                   for who, r in runs.items()}
            print(f"cli 1 {spp} --size 1024, order {' '.join(ORDER)}: "
                  + "; ".join(f"{who} (process wall s, render s) {runs[who]}, "
                              f"medians {med[who][0]:.3f} / {med[who][1]:.3f}"
                              for who in ("other", "this"))
                  + "; BMPs equal byte for byte", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
