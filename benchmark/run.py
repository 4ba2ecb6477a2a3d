"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are found by name through ``BENCHMARK.json``. The run builds
or reuses the program's kernels in the checkout's ``build/``, sets up, warms
up, measures whole batches for ``--seconds``, checks the answers against
the plain reference (``harness/check.py``), and prints the numbers it compared beside their limits
as the last lines of standard error and one JSON object as the last line of
standard output. It exits 2 without a result when the card, the program or
a file is missing, and 3 when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _caches() -> None:
    """Every compile cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches()
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import torch

    from harness import cells, runner

    try:
        benchmark = cells.spec(ROOT)
        chips = cells.cell(benchmark, args.workload)["workload"]["chips"]
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import successiveconvexification_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is not in this checkout: {e}",
              file=sys.stderr)
        return 2

    result = runner.run_cell(benchmark, args.workload, args.seed,
                             args.seconds, bool(args.trace), device="cuda",
                             t_start=T_START)
    found = runner.forbidden_modules()
    if found:
        print(f"benchmark: loaded in this process: {found}", file=sys.stderr)
        return 3
    parts = result.pop("setup_parts")
    print("set-up ended at (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items())
        + f"; host side on CPU {result['host_cpu']}", file=sys.stderr)
    for i, b in enumerate(result.pop("batches")):
        print(f"batch {i}: {b['wall_s']:.3f} s, {b['lockstep']} lockstep "
              f"iterations ({b['cold']} cold), {b['converged']}/{b['lanes']} "
              "converged", file=sys.stderr)
    print("reference solve: " + ", ".join(
        f"{k} {v:.3f}" for k, v in result.pop("check_s").items()),
        file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
