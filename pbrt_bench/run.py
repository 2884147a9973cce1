"""Run one cell of the port's benchmark once.

    python3 pbrt_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. It prints one JSON object as its last line:
with --trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer
metrics read from a torch.profiler trace. It exits non-zero, printing no
result, where there is no CUDA device or fewer than the cell asks for,
where the program cannot be imported, and where JAX or the JAX package was
loaded into this process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache a run builds lives at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from pbrt_bench import core

    cell = core.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = core.execute(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), T_START)
    bad = core.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in this process: {bad}",
              file=sys.stderr)
        return 3
    core.report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
