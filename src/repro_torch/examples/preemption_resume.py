"""Preemption/resume demo, on the port — stop training mid-run, restart,
bit-exact convergence (the port of the top-level
``examples/preemption_resume.py``).

Simulates a node preemption by stopping the training process after a step
(``--stop-after``: checkpoint, then exit), restarts it from the atomic
checkpoint with ``--resume`` and checks that the final loss matches an
uninterrupted run (the restart-exact contract of the deterministic data
pipeline + atomic checkpoints).  Each run is its own
``python -m repro_torch.launch.train`` process.

    PYTHONPATH=src python -m repro_torch.examples.preemption_resume --device cpu
    PYTHONPATH=src python -m repro_torch.examples.preemption_resume   # card
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List, Optional

SRC = Path(__file__).resolve().parents[2]


def run_train(steps, ckpt_dir, device, resume=False, stop_after=0,
              timeout=1200):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "minicpm-2b", "--reduced", "--steps", str(steps),
           "--batch", "4", "--seq", "64", "--lr", "3e-3",
           "--ckpt-dir", ckpt_dir, "--ckpt-every", "20",
           "--log-every", "20", "--device", device]
    if resume:
        cmd.append("--resume")
    if stop_after:
        cmd += ["--stop-after", str(stop_after)]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{r.stderr[-1500:]}")
    last = [ln for ln in r.stdout.splitlines() if ln.startswith("{")][-1]
    return json.loads(last)


def main(argv: Optional[List[str]] = None) -> float:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.preemption_resume")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = tempfile.mkdtemp(prefix="guardian_preempt_")
    try:
        print("1) uninterrupted run: 60 steps")
        ref = run_train(60, f"{base}/ref", args.device)

        print("2) preempted run: stopped after 40 steps (checkpoint at 40)")
        run_train(60, f"{base}/pre", args.device, stop_after=40)

        print("3) restart with --resume: continues 40 -> 60")
        res = run_train(60, f"{base}/pre", args.device, resume=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)

    print(f"   reference final loss: {ref['final_loss']:.6f}")
    print(f"   restarted final loss: {res['final_loss']:.6f}")
    diff = abs(ref["final_loss"] - res["final_loss"])
    print(f"   |diff| = {diff:.2e}  (restart-exact: {diff < 1e-5})")
    if not diff < 1e-5:
        raise AssertionError(f"restart not exact: |diff| = {diff:.2e}")
    return diff


if __name__ == "__main__":
    main()
