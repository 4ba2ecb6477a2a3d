"""Read the numbers that ``correct`` compares on many seeds in one process:
the program's (the lower readings) and the control's (the upper ones).

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 \
        [--seconds S] [--control-seeds 1,2] [--out PATH]

One ``runner.Session`` (the kernels, the nominal, the warm-up are paid
once), then for each seed one window of ``--seconds`` (one batch at the
default 1) through ``Session.measure``, the path a run of ``run.py`` takes,
judged the same way; on ``--control-seeds`` the control's numbers too
(``checks`` entries named ``control.<number>``). One JSON object a window
goes to standard output and to ``--out``. The benchmark's runs do not run
this.
"""

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def read(workload: str, seeds, seconds: float = 1.0, control_seeds=(),
         device="cuda", emit=print, **session_kw) -> None:
    """Emit one record a seed; ``session_kw`` (``config_over``,
    ``mix_over``) shrinks the sizes for a test on the CPU."""
    from harness import cells, runner

    s = runner.Session(cells.spec(ROOT), workload, device, **session_kw)
    emit({"setup_parts": s.setup_parts, "host_cpu": s.host_cpu})
    for seed in seeds:
        res = s.measure(seed, seconds, False, control=seed in control_seeds)
        emit({"seed": seed, "correct": res["correct"],
              "batches": res["batches"], "check_s": res["check_s"],
              "checks": res["checks"]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT)]
    out = open(args.out, "w") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def ints(text):
        return [int(x) for x in text.split(",") if x]

    try:
        read(args.workload, ints(args.seeds), args.seconds,
             ints(args.control_seeds), emit=emit)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
