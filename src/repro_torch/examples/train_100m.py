"""End-to-end training driver example, on the port — a ~100M-param dense
LM trained for a few hundred steps on the deterministic synthetic stream,
with Guardian fencing active, checkpoints, and restart (the port of the
top-level ``examples/train_100m.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_100m --tiny --device cpu
    PYTHONPATH=src python -m repro_torch.examples.train_100m             # card

``--tiny`` trains the reduced config for 60 steps (seconds on a CPU); the
full run is 12 x d768 at batch 4 x 256 tokens, lr 6e-4, resuming from its
checkpoints.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional


def register_demo():
    """~100M params: 12 x d768 llama-style decoder, 32k vocab."""
    from repro_torch.configs import ModelConfig, list_archs, register

    if "demo-100m" not in list_archs():
        register(ModelConfig(
            name="demo-100m", family="dense", n_layers=12, d_model=768,
            n_heads=12, n_kv_heads=12, d_ff=2048, vocab=32_000,
            head_dim=64, norm="rmsnorm", act="silu", dtype="float32",
            source="examples/train_100m"))


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "guardian_100m_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.launch import train as T

    register_demo()
    if args.tiny:
        train_argv = ["--arch", "demo-100m", "--reduced",
                      "--steps", "60", "--batch", "8", "--seq", "128",
                      "--lr", "3e-3", "--ckpt-dir", args.ckpt_dir,
                      "--ckpt-every", "25", "--log-every", "10"]
    else:
        train_argv = ["--arch", "demo-100m",
                      "--steps", str(args.steps), "--batch", "4",
                      "--seq", "256", "--lr", "6e-4",
                      "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
                      "--log-every", "10", "--resume"]
    summary = T.main(train_argv + ["--device", args.device])
    print(f"loss {summary['first_loss']:.3f} -> "
          f"{summary['final_loss']:.3f} over {summary['steps']} steps; "
          f"checkpoints in {args.ckpt_dir} (restart with --resume)")
    return summary


if __name__ == "__main__":
    main()
