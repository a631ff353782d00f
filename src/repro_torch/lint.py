"""``python -m repro_torch.lint`` — static bounds audit of the port's kernels,
trusted serve steps and train step.

Runs the verifier (:mod:`repro_torch.core.verifier`) over

* every hand-written kernel, audited through its plain version in
  :mod:`repro_torch.kernels.ref` — the function each CUDA kernel is held
  against — as a fence-aware tenant kernel against the *symbolic* row, so
  a PROVEN verdict holds for every tenant partition;
* the slab serve steps (``launch/steps.py`` ``build_trusted_serve_steps``
  over the slab cache) in extent mode on a reduced stablelm-3b, built like
  the reference's ``_serve_fixture``: 4 rows, 4 slots of one 64-token
  page, the single-tenant guard (slots, pages and the vocab fenced into
  their pow2 extents);
* the paged serve steps in extent mode on a reduced stablelm-3b: 4 rows,
  8 physical and 8 virtual pages, a vocab fence of 256;
* the train step (``launch/steps.py`` ``build_train_step``) in extent
  mode on a reduced stablelm-3b at (seq 32, batch 2), remat off, with the
  params as the arena, as the reference's ``_audit_train_step`` builds it:
  the embedding gather (K3) and its scatter-add gradient (K3's backward,
  a declared store into the table's rows) inside the table, whose 256
  rows are the guard's vocab partition;

every access into the arena, the pool or the params — the kernels'
declared accesses included — proven inside the accessed operand or a
guard partition.

Per audit it prints the verifier's site table (PROVEN / FENCED / REFUTED
and why).  Every audit of the reference runs (``NOT_PORTED`` is empty).
``--strict`` exits nonzero on a refuted site, an audit
error, or an audit whose proven fraction fell below the committed
``results/lint_torch.baseline.json``; ``--write-baseline`` rewrites that
file after an intended change.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.verifier import SandboxProof, verify

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_BASELINE = _REPO_ROOT / "results" / "lint_torch.baseline.json"


def _f32(*shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32)


def _i32(*shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Kernel audits (kernels/ref.py plain versions, symbolic row mode)
# ---------------------------------------------------------------------------

def _audit_gather_rows() -> SandboxProof:
    from repro_torch.kernels import ref

    def kernel(table, base, mask, idx):
        return table, ref.gather_rows_ref(table, idx, base, mask)

    return verify(kernel, (_f32(256, 8), _i32(), _i32(), _i32(16)),
                  arena_argnums=(0,), bound_argnums=(1, 2))


def _audit_scatter_pages() -> SandboxProof:
    from repro_torch.kernels import ref

    def kernel(k_pool, base, mask, v_pool, k_src, v_src, page_ids):
        ref.scatter_pages_ref(k_pool, v_pool, k_src, v_src, page_ids, base,
                              mask)
        return k_pool, None

    args = (_f32(64, 8, 2, 4), _i32(), _i32(), _f32(64, 8, 2, 4),
            _f32(4, 8, 2, 4), _f32(4, 8, 2, 4), _i32(4, 1))
    return verify(kernel, args, arena_argnums=(0, 3), bound_argnums=(1, 2))


def _audit_paged_attention() -> SandboxProof:
    from repro_torch.kernels import ref

    def kernel(k_pages, base, mask, q, v_pages, page_table, seq_lens):
        B = q.shape[0]
        return k_pages, ref.paged_attention_ref(
            q, k_pages, v_pages, page_table, seq_lens, base.expand(B),
            mask.expand(B))

    args = (_f32(64, 8, 2, 4), _i32(), _i32(), _f32(2, 4, 4),
            _f32(64, 8, 2, 4), _i32(2, 4), _i32(2))
    return verify(kernel, args, arena_argnums=(0, 4), bound_argnums=(1, 2))


def _audit_moe_histogram() -> SandboxProof:
    from repro_torch.kernels import ref

    def kernel(arena, base, mask, expert_ids):
        # the counts land in a tensor of the kernel's own; ids fenced
        # outside [0, E) are dropped, never addressed
        return arena, ref.moe_histogram_ref(expert_ids, 16, base, mask)

    return verify(kernel, (_f32(256), _i32(), _i32(), _i32(8, 2)),
                  arena_argnums=(0,), bound_argnums=(1, 2))


def _audit_flash_attention() -> SandboxProof:
    from repro_torch.kernels import ref

    def kernel(arena, base, mask, q, k, v):
        # dense attention addresses nothing from data: 0 sites
        return arena, ref.flash_attention_ref(q, k, v)

    args = (_f32(256), _i32(), _i32(), _f32(2, 8, 4, 4), _f32(2, 8, 2, 4),
            _f32(2, 8, 2, 4))
    return verify(kernel, args, arena_argnums=(0,), bound_argnums=(1, 2))


# ---------------------------------------------------------------------------
# Step audits (launch/steps.py, extent mode, reduced config)
# ---------------------------------------------------------------------------

def slab_serve_fixture(arch: str = "stablelm-3b", batch: int = 4,
                       max_len: int = 64):
    """The slab serve steps' operands at a reduced ``arch``, as the
    reference's lint builds them (``repro/lint.py`` ``_serve_fixture``):
    ``(bundle, pool, params, meta, guard)`` — a slab pool of
    ``pow2(batch)`` slots of ``max_len`` tokens (float32, as the engine
    serves), the single-tenant BITWISE guard with static vocab, kv, state,
    expert and page partitions.  CPU tensors: the proof traces on fakes of
    their shapes."""
    from repro_torch.configs import get_config
    from repro_torch.core.fence import FenceParams, FencePolicy
    from repro_torch.launch.steps import build_trusted_serve_steps, \
        split_cache_pool
    from repro_torch.models import get_model
    from repro_torch.models import kvcache as KV
    from repro_torch.models.guard import GuardSpec

    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    cache = api.init_cache(batch, max_len, dtype=torch.float32,
                           device="cpu")
    pool, meta = split_cache_pool(cache)
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    slots = KV._pow2_at_least(batch)
    vocab = KV._pow2_at_least(cfg.vocab)
    guard = GuardSpec(
        policy=FencePolicy.BITWISE,
        vocab=FenceParams(base=0, size=vocab),
        kv=FenceParams(base=0, size=slots),
        state=FenceParams(base=0, size=slots),
        expert=(FenceParams(base=0, size=KV._pow2_at_least(
            cfg.moe.num_experts)) if cfg.moe else None),
        page=FenceParams(base=0, size=KV._pow2_at_least(
            max(max_len // KV.PAGE_SIZE, 1))))
    bundle = build_trusted_serve_steps(api, "lint")
    return bundle, pool, params, meta, guard


def paged_serve_fixture(arch: str = "stablelm-3b", batch: int = 4,
                        n_phys: int = 8, n_virt: int = 8):
    """The paged serve steps' operands at a reduced ``arch``: ``(bundle,
    pool, params, meta, guard)`` — a global pool of ``n_phys`` pages, one
    page per row, a BITWISE guard with static vocab (256), kv (``n_virt``
    virtual pages) and page (``n_phys``) partitions and a page map.  CPU
    tensors: the proof traces on fakes of their shapes."""
    from repro_torch.configs import get_config
    from repro_torch.core.fence import FenceParams, FencePolicy
    from repro_torch.launch.steps import build_trusted_serve_steps, \
        split_cache_pool
    from repro_torch.models import get_model
    from repro_torch.models import kvcache as KV
    from repro_torch.models.guard import GuardSpec

    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    cache = api.init_global_cache(batch, KV.PAGE_SIZE, n_phys,
                                  device="cpu")
    pool, meta = split_cache_pool(cache)
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    guard = GuardSpec(
        policy=FencePolicy.BITWISE,
        vocab=FenceParams(base=0, size=256),
        kv=FenceParams(base=0, size=n_virt),
        expert=(FenceParams(base=0, size=cfg.moe.num_experts)
                if cfg.moe else None),
        page=FenceParams(base=0, size=n_phys),
        page_map=_i32(n_virt))
    bundle = build_trusted_serve_steps(api, "lint.paged")
    return bundle, pool, params, meta, guard


def step_operands(fixture, step: str) -> Tuple:
    """A step's operands over a :func:`slab_serve_fixture` or a
    :func:`paged_serve_fixture`: a 1,024-slot
    arena, the pool, the weights, the meta, the tokens (B for a decode, B
    x 16 for a prefill) and the guard."""
    _, pool, params, meta, guard = fixture
    B = (meta.kv if hasattr(meta, "kv") else meta).slot_ids.shape[0]
    x = _i32(B) if step == "decode" else {"tokens": _i32(B, 16)}
    return (_f32(1024), pool, params, meta, x, guard)


def _audit_step(fixture_fn: Callable, step: str
                ) -> Callable[[], SandboxProof]:
    def audit() -> SandboxProof:
        fixture = fixture_fn()
        fn = getattr(fixture[0], f"{step}_fn")
        return verify(fn, step_operands(fixture, step), arena_argnums=(0, 1),
                      mode="extent")
    return audit


def train_fixture():
    """The reference's train-audit operands: a reduced stablelm-3b's
    train step at (seq 32, batch 2), remat off, on the CPU, its params,
    optimizer state and a (2, 33) token batch.  Returns ``(step,
    operands)``."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.steps import build_train_step

    cfg = get_config("stablelm-3b").reduced()
    step = build_train_step(cfg, ShapeConfig("lint", "train", 32, 2),
                            remat=False, device="cpu")
    params = step.api.init(torch.Generator().manual_seed(0), "cpu")
    return step, (params, step.opt.init(params), {"tokens": _i32(2, 33)})


def _audit_train_step() -> SandboxProof:
    # the params are the tainted arena: every dynamic access into the
    # weights (the embedding gather and its scatter-add gradient) must
    # land inside them
    step, operands = train_fixture()
    return verify(step.fn, operands, arena_argnums=(0,), mode="extent")


#: audit name -> thunk returning a SandboxProof
AUDITS: Tuple[Tuple[str, Callable[[], SandboxProof]], ...] = (
    ("kernels.gather_rows", _audit_gather_rows),
    ("kernels.scatter_pages", _audit_scatter_pages),
    ("kernels.paged_attention", _audit_paged_attention),
    ("kernels.moe_histogram", _audit_moe_histogram),
    ("kernels.flash_attention", _audit_flash_attention),
    ("steps.serve.prefill", _audit_step(slab_serve_fixture, "prefill")),
    ("steps.serve.decode", _audit_step(slab_serve_fixture, "decode")),
    ("steps.serve.paged.prefill",
     _audit_step(paged_serve_fixture, "prefill")),
    ("steps.serve.paged.decode", _audit_step(paged_serve_fixture, "decode")),
    ("steps.train", _audit_train_step),
)

#: audits of the reference whose code the port lacks, with what is missing
NOT_PORTED: Tuple[Tuple[str, str], ...] = ()


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def run_audits(only: Optional[str] = None,
               ) -> Tuple[Dict[str, Dict], List[str]]:
    """Run every audit (optionally those whose name starts with
    ``only``), printing the site tables.  Returns ``(summaries,
    errors)``."""
    summaries: Dict[str, Dict] = {}
    errors: List[str] = []
    for name, thunk in AUDITS:
        if only and not name.startswith(only):
            continue
        print(f"== {name}")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                proof = thunk()
        except Exception as e:  # noqa: BLE001 — report, don't crash the CLI
            errors.append(f"{name}: {type(e).__name__}: {e}")
            print(f"  ERROR {type(e).__name__}: {e}\n")
            continue
        s = proof.summary()
        summaries[name] = {k: s[k] for k in
                           ("sites", "proven", "fenced", "refuted",
                            "proven_fraction", "fully_proven", "mode")}
        print(proof.format_table())
        print(f"  -> {s['proven']}/{s['sites']} proven, "
              f"{s['fenced']} fenced, {s['refuted']} refuted "
              f"({'symbolic ' if s['symbolic'] else ''}{s['mode']} mode)\n")
    for name, why in NOT_PORTED:
        if not only or name.startswith(only):
            print(f"== {name}\n  NOT PORTED: {why}\n")
    return summaries, errors


def compare_baseline(summaries: Dict[str, Dict],
                     baseline: Dict[str, Dict]) -> List[str]:
    """Regressions of the proven fraction and the refuted count against
    the committed baseline."""
    problems = []
    for name, old in baseline.items():
        new = summaries.get(name)
        if new is None:
            problems.append(f"{name}: in baseline but no longer audited")
            continue
        if new["proven_fraction"] < old["proven_fraction"]:
            problems.append(
                f"{name}: proven fraction regressed "
                f"{old['proven_fraction']} -> {new['proven_fraction']}")
        if new["refuted"] > old.get("refuted", 0):
            problems.append(
                f"{name}: refuted sites {old.get('refuted', 0)} -> "
                f"{new['refuted']}")
    return problems


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="Static bounds audit of the port's kernels, "
                    "trusted serve steps and train step.")
    p.add_argument("--strict", action="store_true",
                   help="exit nonzero on refuted sites, audit errors, or "
                        "proven-fraction regressions vs the baseline")
    p.add_argument("--write-baseline", action="store_true",
                   help="write the baseline from this run")
    p.add_argument("--baseline", type=pathlib.Path,
                   default=DEFAULT_BASELINE)
    p.add_argument("--only", metavar="PREFIX",
                   help="run only the audits whose name starts with PREFIX")
    args = p.parse_args(argv)

    summaries, errors = run_audits(args.only)
    problems: List[str] = list(errors)
    problems += [f"{n}: {s['refuted']} refuted site(s)"
                 for n, s in summaries.items() if s["refuted"]]
    if args.write_baseline:
        args.baseline.parent.mkdir(parents=True, exist_ok=True)
        args.baseline.write_text(json.dumps(summaries, indent=2,
                                            sort_keys=True) + "\n")
        print(f"baseline written: {args.baseline}")
    elif args.baseline.exists():
        baseline = json.loads(args.baseline.read_text())
        if args.only:   # a partial run compares what it audited
            baseline = {n: b for n, b in baseline.items()
                        if n in summaries}
        problems += compare_baseline(summaries, baseline)
    elif args.strict:
        problems.append(f"baseline {args.baseline} missing "
                        "(run with --write-baseline and commit it)")

    total = sum(s["sites"] for s in summaries.values())
    proven = sum(s["proven"] for s in summaries.values())
    print(f"lint: {len(summaries)} audits, {proven}/{total} sites proven, "
          f"{len(NOT_PORTED)} not ported, {len(problems)} problem(s)")
    for m in problems:
        print(f"  PROBLEM {m}")
    return 1 if problems and args.strict else 0


if __name__ == "__main__":
    sys.exit(main())
