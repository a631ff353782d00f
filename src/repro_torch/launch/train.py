"""Training driver — restart-exact, on one device; the port of
``repro/launch/train.py``, flag for flag, plus ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --steps 300 --batch 8 --seq 256 --reduced --ckpt-dir ckpt \
        --device cpu

The device defaults to ``cuda``; without a card, pass ``--device cpu``.
What it exercises, as the reference does:
* deterministic data (restart reproduces the exact token stream);
* AdamW + cosine / WSD / constant schedule, global-norm clipping
  (:func:`repro_torch.launch.steps.build_train_step`, remat off), the
  step compiled as the reference jits it: one CUDA graph per batch shape
  for forward, backward and the update
  (:func:`repro_torch.launch.steps.compile_train_step`);
* atomic async checkpointing + ``--resume`` auto-restart;
* a per-step watchdog (a step over ``--straggler-factor`` x the trailing
  median is logged and counted);
* a preemption hook (SIGTERM -> final checkpoint -> clean stop; the
  previous handler is restored when :func:`main` returns);
* Guardian fencing on the training data paths (``--no-guard`` for the
  unfenced run).

Prints ``step … loss …`` lines and ends with one JSON summary line, whose
keys are the reference's.  ``host_index`` / ``host_count`` are 0 / 1: the
port trains on one device.
"""

from __future__ import annotations

import argparse
import json
import signal
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "constant"])
    ap.add_argument("--no-guard", action="store_true")
    ap.add_argument("--policy", default="bitwise",
                    choices=["bitwise", "modulo", "check"])
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stop-after", type=int, default=0,
                    help="simulate preemption: checkpoint and exit after "
                         "this step (schedule still spans --steps)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: cuda; the CPU "
                         "only when asked)")
    return ap.parse_args(argv)


def make_schedule(args: argparse.Namespace):
    from repro_torch.optim import constant, cosine, wsd

    n = args.steps
    return {"cosine": lambda: cosine(args.lr, n // 10, n),
            "wsd": lambda: wsd(args.lr, n // 10, int(n * 0.7),
                               n - n // 10 - int(n * 0.7)),
            "constant": lambda: constant(args.lr)}[args.schedule]()


def main(argv: Optional[List[str]] = None,
         params: Optional[Dict[str, Any]] = None,
         wrap_step: Optional[Callable] = None) -> dict:
    """Train as the flags say; ``params`` (on ``--device``, updated in
    place) stands in for the weights drawn from ``--seed`` — e.g. the
    reference's, converted.  ``wrap_step``, when given, is handed the
    compiled step and returns what the loop calls in its place (a
    caller's hook to time or inspect each step).  Returns the summary."""
    args = parse_args(argv)

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.fence import FencePolicy
    from repro_torch.data import DataConfig, make_source
    from repro_torch.launch.steps import build_train_step, \
        compile_train_step

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device here (pass "
                           "--device cpu to train on the CPU)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    step_fn = build_train_step(
        cfg, shape, guard_enabled=not args.no_guard,
        policy=FencePolicy(args.policy), remat=False,
        schedule=make_schedule(args), device=device)
    train_step = compile_train_step(step_fn)
    if wrap_step is not None:
        train_step = wrap_step(train_step)

    source = make_source(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch, seed=args.seed,
                                    host_index=0, host_count=1))

    if params is None:
        params = step_fn.api.init(
            torch.Generator(device=device).manual_seed(args.seed), device)
    opt_state = step_fn.opt.init(params)
    start_step = 0

    store = CheckpointStore(args.ckpt_dir) if args.ckpt_dir else None
    if store and args.resume and store.latest_step() is not None:
        (params, opt_state), start_step = store.restore((params, opt_state))
        print(f"resumed from step {start_step}")

    # preemption hook: checkpoint on SIGTERM, then stop cleanly
    preempted = {"flag": False}

    def on_sigterm(_sig, _frm):
        preempted["flag"] = True
    previous = signal.signal(signal.SIGTERM, on_sigterm)

    times, stragglers = [], 0
    losses: List[float] = []
    try:
        for step in range(start_step, args.steps):
            t0 = time.time()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in source.batch(step).items()}
            params, opt_state, out = train_step(params, opt_state, batch)
            loss = float(out["loss"])
            dt = time.time() - t0
            times.append(dt)
            losses.append(loss)
            if len(times) > 10:
                med = statistics.median(times[-50:])
                if dt > args.straggler_factor * med:
                    stragglers += 1
                    print(f"[watchdog] step {step} took {dt:.3f}s "
                          f"(median {med:.3f}s) — straggler #{stragglers}")
            if step % args.log_every == 0:
                print(f"step {step:6d} loss {loss:.4f} "
                      f"({dt * 1e3:.0f} ms/step)")
            if store and (step + 1) % args.ckpt_every == 0:
                store.save_async(step + 1, (params, opt_state))
            if preempted["flag"] or (args.stop_after
                                     and step + 1 >= args.stop_after):
                print(f"[preemption] stopping at step {step + 1} — "
                      "checkpointing")
                if store:
                    store.wait()
                    store.save(step + 1, (params, opt_state))
                summary = {"final_loss": losses[-1],
                           "first_loss": losses[0], "steps": len(losses),
                           "stragglers": stragglers,
                           "preempted_at": step + 1}
                print(json.dumps(summary))
                return summary
        if store:
            store.wait()
            store.save(args.steps, (params, opt_state))
    finally:
        signal.signal(signal.SIGTERM, previous)
    summary = {"final_loss": losses[-1] if losses else None,
               "first_loss": losses[0] if losses else None,
               "steps": len(losses), "stragglers": stragglers}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
