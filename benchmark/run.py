"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Exits non-zero, printing no result, without CUDA or with fewer cards
than the cell asks for, when a kernel library is built inside the timed
window, or when JAX or the JAX package is loaded.
"""

import os
import sys
import time
from pathlib import Path

# one process with few threads: the host's math libraries run on one thread
# each, so no idle pool spins beside the engine's host work
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this directory, is where modules come from
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]
sys.path.insert(0, str(ROOT))


def process_start() -> float:
    """The process's start, in seconds since the epoch (Linux /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def main(argv=None) -> int:
    import argparse

    start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the run lives at a fixed path in the checkout
    cache = ROOT / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)

    from benchmark import harness, spec

    bench = spec.load_benchmark()
    cell = spec.find_workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card and does not fall back",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(
            args.workload, bench=bench, config=spec.load_config(cell["config"]),
            traffic=spec.load_traffic(cell["traffic"]),
            limits=spec.load_limits(args.workload), seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), device="cuda", process_start=start)
    except harness.Failure as exc:
        print(f"run failed: {exc}", file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
