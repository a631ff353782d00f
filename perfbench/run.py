"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Every cell of ``BENCHMARK.json`` names a
configuration, a traffic mix and the chips it needs; the run serves the mix
through ``repro_torch`` (imported from ``src/``) on the card, checks the
served output against the plain reference, and prints one JSON line last
on standard output: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``).  The numbers compared with the
reference are printed, each with its limit, as the last lines on standard
error.  Without a card, or with fewer cards than the cell asks for, it
exits with code 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(CHECKOUT / "build" / "perfbench" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness, yardstick
    bench = harness.benchmark(CHECKOUT)
    cell = harness.cell_of(bench, args.workload)

    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"perfbench: cell {args.workload} needs {cell['chips']} "
              f"CUDA device(s); found {found}", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}", flush=True)

    ctx = harness.context(bench, args.workload, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          device="cuda", t0=T0)
    torch.cuda.init()
    ctx.marks.append(("torch and the card", time.perf_counter()))
    rec = harness.run(ctx)
    # read once the window is over: nvidia-smi's own start-up varies
    print(f"name, power.limit: {power_limit()}", flush=True)
    last = T0
    phases = []
    for phase, t in ctx.marks:
        phases.append(f"{phase} {t - last:.3f} s")
        last = t
    print("set-up: " + ", ".join(phases), flush=True)
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": rec.memory_peak_bytes}
    if ctx.trace:
        if rec.trace is None or rec.trace.busy_s <= 0:
            print("perfbench: the device trace holds no operation",
                  file=sys.stderr)
            return 3
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
    out = harness.result(bench, ctx, rec, device)
    found = harness.loaded_forbidden()
    if found:
        print(f"perfbench: modules that must not load did: {found}",
              file=sys.stderr)
        return 4
    chunks = 1 + max((x.chunk for x in rec.reqs), default=-1)
    print(f"window: {rec.window_s:.3f} s, {chunks} chunks, "
          f"{len(rec.reqs)} requests, {len(rec.drains)} drains; set-up "
          f"{rec.setup_s:.3f} s; peak memory {rec.memory_peak_bytes} B; "
          f"checked {rec.checked_tokens} served tokens", flush=True)
    held, reserved, pool, page = yardstick.kv_pages(rec)
    print(f"KV pool at its fullest: {held} pages written ({held * page} B) "
          f"of {reserved} reserved by the rows in use, of {pool} in the "
          f"pool; a page {page} B", flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
