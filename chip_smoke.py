#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card and the CUDA toolkit
(``nvcc``), and imports nothing of JAX or of the JAX package.  Phases, in
order (any failure exits non-zero):

1. device and build — the card's name and power limit, the torch version,
   and the build of every kernel of ``src/repro_torch/kernels/csrc`` for
   ``sm_90a`` (into ``build/repro_torch/``);
2. each kernel against its plain PyTorch version at the main path's shapes
   (stablelm-3b: H = KH = 32, D = 80, 64-token pages, a 50,304-row vocab
   under a 65,536 fence, a ragged prefill length), forged ids included,
   with its time, the plain version's, the library call's where one
   exists, and the bound — the least time the card could take for the
   same bytes or operations;
3. full width against the CPU at two layers: stablelm-3b at full width,
   2 layers, float32, prefill + 4 decode steps on the card through the
   kernels and on the CPU through the plain versions, from the same
   weights — greedy ids equal, logits within a stated tolerance;
4. the main path at full width and full depth: stablelm-3b (bf16 weights
   from a seeded generator, float32 page pool) through
   ``make_shared_manager(paged=True)``, ``ServeEngine(paged=True)`` and
   ``serve_continuous``, 3 tenants and 8 staggered requests — every request
   served with its token count, every kernel launched, no plain version
   run.

The last three lines of standard output are the kernel table as one JSON
object, the card's ``name, power.limit``, and the result object.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# The card's published peaks (NVIDIA H100 SXM data sheet, dense), used for
# the bounds: bytes over the HBM rate, operations over the rate of their
# type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

STABLELM_FENCE_VOCAB = 65_536      # pow2(50,304): the serve path's fence


def log(*a) -> None:
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bound_ms(n_bytes: float, flops: float, dtype: str):
    """(ms, 'bytes' | 'operations'): the larger of the two least times."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, timed with CUDA
    events around each call.  Before each call the 50 MB L2 is flushed (the
    main path meets every operand cold: each layer reads its own pool view
    and weights) and the stream is held busy for ~0.5 ms, so the host has
    enqueued the call's kernels before the start event fires and the
    interval holds device time, not Python launch overhead."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / iters


# --------------------------------------------------------------------- #
# Phase 2: each kernel against its plain version                        #
# --------------------------------------------------------------------- #

def check_kernels(torch, cfg):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels._build import per_id
    from repro_torch.kernels.gather_rows import gather_rows
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.scatter_pages import scatter_pages
    import torch.nn.functional as F

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1234)
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, S, page, P = 8, 57, 64, 64          # max_batch 8, ragged prefill
    i32 = dict(dtype=torch.int32, device=dev)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    rows = []

    # ---- K3 gather_rows: prefill token ids under the vocab fence ------ #
    table = randn(cfg.vocab, cfg.d_model, dtype=torch.bfloat16)
    ids = torch.randint(0, cfg.vocab, (B * S,), generator=gen, **i32)
    ids[::7] = torch.randint(cfg.vocab, STABLELM_FENCE_VOCAB, ids[::7].shape,
                             generator=gen, **i32)    # forged: past the table
    ids[3::11] -= 1 << 20                              # forged: negative
    mask = STABLELM_FENCE_VOCAB - 1
    out = gather_rows(table, ids, 0, mask)
    want = ref.gather_rows_ref(table, ids, per_id(0, ids.numel(), dev),
                               per_id(mask, ids.numel(), dev))
    nan_rows = int(out.isnan().all(dim=1).sum())
    fenced = (ids & mask)
    if not torch.equal(out.isnan(), want.isnan()) or not torch.equal(
            torch.nan_to_num(out), torch.nan_to_num(want)):
        raise AssertionError("gather_rows disagrees with its plain version")
    if nan_rows != int((fenced >= cfg.vocab).sum()):
        raise AssertionError("gather_rows: past-the-table ids not NaN rows")
    err = (torch.nan_to_num(out).float()
           - torch.nan_to_num(want).float()).abs().max().item()
    in_table = fenced < cfg.vocab
    ok_ids = fenced[in_table]
    # bytes: the in-table rows read, every output row written, the ids read
    n_bytes = ((int(in_table.sum()) + ids.numel()) * cfg.d_model * 2
               + ids.numel() * 4)
    rows.append(dict(
        name="gather_rows", route="cuda",
        source="src/repro_torch/kernels/csrc/gather_rows.cu",
        replaces="src/repro/kernels/fenced_gather.py:48",
        max_abs_err=err, tolerance="exact (NaN rows where the fenced id "
                                   "is past the table)",
        ms=cuda_ms(torch, lambda: gather_rows(table, ids, 0, mask)),
        plain_ms=cuda_ms(torch, lambda: ref.gather_rows_ref(
            table, ids, per_id(0, ids.numel(), dev),
            per_id(mask, ids.numel(), dev))),
        library_ms=cuda_ms(torch, lambda: table.index_select(0, ok_ids)),
        library_call="Tensor.index_select of the in-table rows",
        shape=f"table {tuple(table.shape)} bf16, {ids.numel()} ids",
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(n_bytes, 0.0, "bfloat16")))))
    log(f"K3 gather_rows ok: {nan_rows} NaN rows for ids past the "
        f"{cfg.vocab}-row table under the {STABLELM_FENCE_VOCAB} fence")

    # ---- K2 scatter_pages: prefill page write, forged + parked rows --- #
    k_pool = randn(P, page, KH, D)
    v_pool = randn(P, page, KH, D)
    k_src, v_src = randn(B, S, KH, D), randn(B, S, KH, D)
    # virtual space of 64 pages: scratch [0, 4) -> garbage page 0;
    # tenant0 [16, 32) -> phys 1..16; tenant1 [32, 48) -> phys 17..32
    page_map = torch.zeros(64, **i32)
    page_map[16:32] = torch.arange(1, 17, **i32)
    page_map[32:48] = torch.arange(17, 33, **i32)
    page_ids = torch.tensor([[16], [21], [33], [40], [0], [1], [2], [3]],
                            **i32)
    page_ids[1, 0] = 45          # forged: tenant0's row names tenant1's id
    base = torch.tensor([16, 16, 32, 32, 0, 0, 0, 0], **i32)
    msk = torch.tensor([15, 15, 15, 15, 3, 3, 3, 3], **i32)
    kk, vv = k_pool.clone(), v_pool.clone()
    scatter_pages(kk, vv, k_src, v_src, page_ids, base, msk, page_map)
    kr, vr = k_pool.clone(), v_pool.clone()
    ref.scatter_pages_ref(kr, vr, k_src, v_src, page_ids, base, msk,
                          page_map)
    if not (torch.equal(kk, kr) and torch.equal(vv, vr)):
        raise AssertionError("scatter_pages disagrees with its plain version")
    err = max((kk - kr).abs().max().item(), (vv - vr).abs().max().item())
    phys = ref.resolve_pages(page_ids, base[:, None], msk[:, None],
                             page_map, P).reshape(-1)
    written = set(int(p) for p in phys)
    if not 1 <= int(phys[1]) <= 16:        # tenant0's physical pages
        raise AssertionError("scatter_pages: forged id left its extent")
    untouched = [p for p in range(P) if p not in written]
    if not (torch.equal(kk[untouched], k_pool[untouched])
            and torch.equal(vv[untouched], v_pool[untouched])):
        raise AssertionError("scatter_pages wrote outside the fenced pages")
    # bytes, K and V: for each kept page its S source tokens read and the
    # whole page written (the padding is zero-filled, not read), plus the
    # ids and fence operands
    tok_bytes = KH * D * 4
    n_bytes = (2 * len(written) * (S + page) * tok_bytes
               + phys.numel() * 12)
    last = {int(p): i for i, p in enumerate(phys)}    # last writer wins
    uniq = torch.tensor(list(last), dtype=torch.long, device=dev)
    rows_kept = torch.tensor(list(last.values()), dtype=torch.long,
                             device=dev)
    kv2 = torch.stack([k_pool, v_pool])
    pages2 = torch.stack([F.pad(k_src, (0, 0, 0, 0, 0, page - S)),
                          F.pad(v_src, (0, 0, 0, 0, 0, page - S))]
                         )[:, rows_kept]
    rows.append(dict(
        name="scatter_pages", route="cuda",
        source="src/repro_torch/kernels/csrc/scatter_pages.cu",
        replaces="src/repro/kernels/fenced_scatter.py:53",
        max_abs_err=err, tolerance="exact (a copy)",
        ms=cuda_ms(torch, lambda: scatter_pages(
            kk, vv, k_src, v_src, page_ids, base, msk, page_map)),
        plain_ms=cuda_ms(torch, lambda: ref.scatter_pages_ref(
            kr, vr, k_src, v_src, page_ids, base, msk, page_map)),
        library_ms=cuda_ms(torch, lambda: kv2.index_copy_(1, uniq, pages2)),
        library_call="Tensor.index_copy_ of the kept padded K and V pages",
        shape=f"pools ({P},{page},{KH},{D}) f32, src ({B},{S},{KH},{D})",
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(n_bytes, 0.0, "float32")))))
    log(f"K2 scatter_pages ok: {len(written)} distinct pages written, "
        f"forged id wrapped into its extent, {len(untouched)} pages "
        "untouched")

    # ---- K4 flash_attention: ragged prefill --------------------------- #
    q = randn(B, S, H, D, dtype=torch.bfloat16)
    k = randn(B, S, KH, D, dtype=torch.bfloat16)
    v = randn(B, S, KH, D, dtype=torch.bfloat16)
    out = flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    err = (out.float() - want.float()).abs().max().item()
    # one bf16 ulp at outputs in [2, 4): an early causal row averages only
    # a few V rows of N(0, 1) values
    if not err <= 2e-2:
        raise AssertionError(f"flash_attention error {err} > 2e-2")
    n_bytes = 4 * B * S * H * D * 2
    flops = 4 * B * H * D * S * (S + 1) / 2
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:84",
        max_abs_err=err, tolerance="2e-2 (bf16 output, one ulp at |out| < 4)",
        ms=cuda_ms(torch, lambda: flash_attention(q, k, v)),
        plain_ms=cuda_ms(torch, lambda: ref.flash_attention_ref(q, k, v)),
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        library_call="F.scaled_dot_product_attention(is_causal=True)",
        shape=f"q/k/v ({B},{S},{H},{D}) bf16",
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(n_bytes, flops, "bfloat16")))))
    log(f"K4 flash_attention ok: max |err| {err:.3g} (tolerance 2e-2)")

    # ---- K1 paged_attention: decode over the f32 pool, bf16 query ----- #
    qd = randn(B, H, D, dtype=torch.bfloat16)
    table_ids = torch.randint(0, 64, (B, 4), generator=gen, **i32)  # forged
    lens = torch.randint(17, 81, (B,), generator=gen, **i32)
    base = torch.tensor([16, 16, 32, 32, 16, 32, 0, 0], **i32)
    msk = torch.tensor([15, 15, 15, 15, 15, 15, 3, 3], **i32)
    out = paged_attention(qd, k_pool, v_pool, table_ids, lens, base, msk,
                          page_map)
    want = ref.paged_attention_ref(qd, k_pool, v_pool, table_ids, lens,
                                   base, msk, page_map)
    err = (out.float() - want.float()).abs().max().item()
    # Both sides round K/V to bf16 and accumulate in f32, so they differ
    # only where accumulation order flips an output's last bf16 bit.  The
    # control skips that rounding (f32 K/V under the bf16 query): it moves
    # about half the outputs by one bf16 ulp, up to ~8e-3 at these values,
    # and must fail the tolerance, or the check could not see the fault.
    tol = 1e-3
    ctrl = ref.paged_attention_ref(qd.float(), k_pool, v_pool, table_ids,
                                   lens, base, msk, page_map).to(qd.dtype)
    ctrl_err = (ctrl.float() - want.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"paged_attention error {err} > {tol}")
    if not ctrl_err > tol:
        raise AssertionError(f"paged_attention control (no K/V rounding) "
                             f"error {ctrl_err} <= {tol}: the tolerance "
                             "cannot see the rounding")
    phys = ref.resolve_pages(table_ids, base[:, None], msk[:, None],
                             page_map, P)
    own = set(int(p) for p in phys.reshape(-1)) | {0}
    k2, v2 = k_pool.clone(), v_pool.clone()
    foreign = [p for p in range(P) if p not in own]
    k2[foreign], v2[foreign] = 12345.0, -999.0
    out2 = paged_attention(qd, k2, v2, table_ids, lens, base, msk, page_map)
    if not torch.equal(out, out2):
        raise AssertionError("paged_attention read outside the fence")
    # bytes: each held K and V token row read once (f32), q read and out
    # written (bf16), the page table and the per-row lens/base/mask read
    n_bytes = (2 * int(lens.sum()) * KH * D * 4 + 2 * B * H * D * 2
               + table_ids.numel() * 4 + 3 * B * 4)
    flops = 4 * int(lens.sum()) * H * D
    rows.append(dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/fenced_paged_attention.py:173",
        max_abs_err=err, tolerance=f"{tol} (bf16 output; the control "
                                   f"without K/V rounding: {ctrl_err:.3g})",
        ms=cuda_ms(torch, lambda: paged_attention(
            qd, k_pool, v_pool, table_ids, lens, base, msk, page_map)),
        plain_ms=cuda_ms(torch, lambda: ref.paged_attention_ref(
            qd, k_pool, v_pool, table_ids, lens, base, msk, page_map)),
        library_ms=None, library_call=None,
        shape=f"q ({B},{H},{D}) bf16, pool ({P},{page},{KH},{D}) f32",
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(n_bytes, flops, "float32")))))
    log(f"K1 paged_attention ok: max |err| {err:.3g} (tolerance {tol}; "
        f"the control without K/V rounding errs by {ctrl_err:.3g}); "
        f"{len(foreign)} foreign pages clobbered, output unchanged")
    for r in rows:
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms ({r['library_call']})"
        log(f"  {r['name']}, {r['shape']}: max |err| {r['max_abs_err']:.3g}"
            f" (tolerance {r['tolerance']}); kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


# --------------------------------------------------------------------- #
# Phase 3: full width, 2 layers, card against CPU                       #
# --------------------------------------------------------------------- #

def check_full_width(torch, cfg):
    from repro_torch.core.fence import FenceParams, FencePolicy
    from repro_torch.models import get_model
    from repro_torch.models import kvcache as KV
    from repro_torch.models.guard import GuardSpec

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    api = get_model(cfg2)
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = api.init(gen, "cuda")
    cpu_params = {
        "embed": {k: v.cpu() for k, v in params["embed"].items()},
        "layers": [{g: {k: v.cpu() for k, v in sub.items()}
                    for g, sub in lp.items()} for lp in params["layers"]],
        "norm_f": {k: v.cpu() for k, v in params["norm_f"].items()},
    }
    B, S, P, max_len = 2, 24, 16, 128
    page_map = torch.zeros(P, dtype=torch.int32)
    page_map[4:8] = torch.tensor([1, 2, 3, 4])
    page_map[8:12] = torch.tensor([5, 6, 7, 8])
    table = torch.tensor([[4, 5], [8, 9]], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator()
                         .manual_seed(3), dtype=torch.int32)

    def run(device, p):
        guard = GuardSpec(
            policy=FencePolicy.BITWISE,
            vocab=FenceParams(0, STABLELM_FENCE_VOCAB),
            kv=FenceParams(base=torch.tensor([4, 8], dtype=torch.int32,
                                             device=device),
                           size=torch.tensor([4, 4], dtype=torch.int32,
                                             device=device)),
            page=FenceParams(0, P), page_map=page_map.to(device))
        cache = KV.init_global_kv_cache(cfg2, B, max_len, P, device=device)
        cache = dataclasses.replace(cache, page_table=table.to(device))
        cache, logits = api.prefill(p, cache, {"tokens": toks.to(device)},
                                    guard=guard)
        outs, ids = [logits.float().cpu()], [logits.argmax(-1).cpu()]
        nxt = logits.argmax(-1).to(torch.int32)
        for _ in range(4):
            cache, logits = api.decode(p, cache, nxt, guard=guard)
            outs.append(logits.float().cpu())
            ids.append(logits.argmax(-1).cpu())
            nxt = logits.argmax(-1).to(torch.int32)
        return torch.stack(outs), torch.stack(ids)

    logits_gpu, ids_gpu = run("cuda", params)
    logits_cpu, ids_cpu = run("cpu", cpu_params)
    err = (logits_gpu - logits_cpu).abs().max().item()
    tol = 2e-3
    if not torch.equal(ids_gpu, ids_cpu):
        raise AssertionError(f"greedy ids differ card vs CPU: "
                             f"{ids_gpu.tolist()} vs {ids_cpu.tolist()}")
    if not err <= tol:
        raise AssertionError(f"full-width logits differ by {err} > {tol}")
    log(f"full width x 2 layers (f32): card vs CPU greedy ids equal over "
        f"prefill + 4 decodes, max |logit err| {err:.3g} (tolerance {tol})")


# --------------------------------------------------------------------- #
# Phase 4: the main path at full width and depth                        #
# --------------------------------------------------------------------- #

def run_main_path(torch, cfg):
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import ServeEngine, make_shared_manager, \
        serve_continuous

    t0 = time.perf_counter()
    mgr = make_shared_manager(1, max_batch=8, max_len=256, paged=True)
    eng = ServeEngine(cfg, max_batch=8, max_len=256, manager=mgr,
                      paged=True, seed=0)
    for t in range(3):
        eng.register_tenant(f"tenant{t}", 16)
    rng = torch.Generator().manual_seed(11)
    want = {}
    for i in range(8):
        plen = int(torch.randint(16, 65, (1,), generator=rng))
        prompt = torch.randint(0, cfg.vocab, (plen,), generator=rng)
        rid = eng.submit(f"tenant{i % 3}", prompt.tolist(), max_new=16,
                         arrive=i // 2)
        want[rid] = 16
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"main path set-up: {setup_s:.1f} s (weights, pool, manager); "
        f"pool {eng._pool.buf['k'].numel() * 8 / 1e9:.2f} GB")

    _build.reset_counts()
    t0 = time.perf_counter()
    outs = serve_continuous([eng], max_new_tokens=16)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _build.KERNELS.values()}
    plain = {k.name: k.plain_calls for k in _build.KERNELS.values()}

    if sorted(outs) != sorted(want):
        raise AssertionError(f"served {sorted(outs)}, want {sorted(want)}")
    for rid, toks in outs.items():
        if len(toks) != want[rid] or not all(0 <= t < cfg.vocab
                                             for t in toks):
            raise AssertionError(f"request {rid}: bad tokens {toks}")
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a kernel never launched: {launches}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the card: {plain}")
    n_tok = sum(len(t) for t in outs.values())
    stats = mgr.scheduler.stats
    cycles = eng.manager.telemetry.registry.counter("drain_cycles")
    log(f"main path: {len(outs)} requests x 16 tokens in {wall:.2f} s "
        f"({n_tok / wall:.1f} tokens/s); {cycles} drain cycles, "
        f"{int(stats.total_launches)} scheduler launches, "
        f"{eng.decode_steps} decode steps; kernel launches {launches}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    smi = smi_line()
    log(f"device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {len(built)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s ({', '.join(sorted(built))})")

    cfg = get_config("stablelm-3b")
    rows = check_kernels(torch, cfg)
    log("kernels: " + ", ".join(r["name"] for r in rows))
    check_full_width(torch, cfg)
    launches = run_main_path(torch, cfg)

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    table = [{k: (launches[r["name"]] if k == "launches" else r[k])
              for k in keys} for r in rows]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
