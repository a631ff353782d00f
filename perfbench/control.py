"""The output check's two readings, for setting its limits: in one
process, for each seed, a short window of the cell at its own load (one
chunk of the mix, every request finished), then the widest gap of the
program's served tokens and, over the same sample, of the control (the
reference in the program's place, its products in float8 e4m3: the
precision below the served bfloat16).  Prints one JSON line per seed.

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13

The benchmark's runs never run it.  Needs a card, as run.py does.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        print("perfbench/control.py needs a CUDA device", file=sys.stderr)
        return 2
    bench = harness.benchmark(CHECKOUT)
    for seed in args.seeds:
        t = time.perf_counter()
        ctx = harness.context(bench, args.workload, seed=seed, seconds=0.0,
                              trace=False, device="cuda", t0=t,
                              control=True)
        rec = harness.run(ctx)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "program_widest_gap": rec.checks["widest_gap"]["value"],
            "control_widest_gap": rec.control_widest_gap,
            "schedule_mismatches": rec.checks["schedule_mismatches"][
                "value"],
            "failed": rec.failed, "attempted": rec.attempted,
            "checked_tokens": rec.checked_tokens,
            "seconds": time.perf_counter() - t}), flush=True)
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
