#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card and the CUDA toolkit
(``nvcc``), and imports nothing of JAX or of the JAX package.  Two serve
paths run, each at full width: the dense stablelm-3b and the MoE
qwen3-moe-30b-a3b.  Phases, in order (any failure exits non-zero):

1. device and build — the card's name and power limit, the torch version,
   the build of every kernel of ``src/repro_torch/kernels/csrc`` for
   ``sm_90a`` (into ``build/repro_torch/``, one ``nvcc`` per source, all
   started together) and K4's, K1's, K5's and K2's ``-Xptxas -v`` reports
   (registers, spills);
2. each kernel against its plain PyTorch version at each path's shapes —
   stablelm-3b (H = KH = 32, D = 80, a 50,304-row vocab under a 65,536
   fence) and qwen3-moe-30b-a3b (H = 32 over KH = 4, so G = 8, D = 128, a
   151,936-row vocab under a 262,144 fence), 64-token pages, a ragged
   prefill length — forged ids included; K4 in bf16 (tensor cores) and
   f32 (CUDA cores) at one key tile (S = 57) and four (S = 193), K3 under a
   scalar, the identity and a per-id fence; K1 in bf16 and f32 at 17-80
   held tokens and at max_len 256 (a full row, seq_len 0, page boundaries,
   lengths inside a tile and a cluster rank's share), at every cluster
   size, and under the identity fence by value; K5 at decode (8, 8),
   prefill (512, 8) and past one CTA (2,048 and 8,192 tokens) under three
   fences; K2 in f32 on its original inputs, then (inputs from the second
   generator) every (source, pool) dtype pair at S = 57 with strided ids
   and at S = 193 over four pages, under an int, the identity, a per-row
   and a per-id fence, exact, pages not written unchanged, and the main
   path's prefill write (bf16 K/V into the f32 layer view through
   ``write_prefill_kv`` under a per-row BITWISE guard) timed and counted
   — with its time, the plain version's, the library call's where
   one exists, the bound (the least time the card could take for the same
   bytes or operations), the card's launch floor (a one-element fill_,
   timed the same way) and, for K1, K2 and K5, the device operations a
   call puts on the card, counted by ``torch.profiler`` (one each);
3. full width against the CPU at two layers, for each path: float32,
   prefill + 4 decode steps on the card through the kernels and on the CPU
   through the plain versions, from the same weights — greedy ids equal,
   logits within a stated tolerance (the MoE path also prints the smallest
   top-k routing margin it met, so a routing tie can be told from a fault);
4. each main path at full width and full depth (bf16 weights from a seeded
   generator, float32 page pool) through ``make_shared_manager(paged=True)``,
   ``ServeEngine(paged=True)`` and ``serve_continuous``, 3 tenants and 8
   staggered requests x 16 tokens — every request served with its token
   count, every kernel of the path launched (counts set to 0 just before
   the path and read just after), no plain version run.  stablelm-3b runs
   first and is freed before qwen3-moe-30b-a3b (61 GB of weights) is
   built; the MoE path also prints its decode-step time against the bytes
   floor, its peak memory and the (token, k) assignments capacity dropped;
   a solo rerun under ``torch.profiler`` gives the device's busy share and
   each of the port's kernels' device time.

The last three lines of standard output are the kernel table as one JSON
object, the card's ``name, power.limit``, and the result object.

    python3 chip_smoke.py --ab PARENT

builds both trees' kernels and prints phase 2's kernel times of the
checkout at PARENT and of this one, run in the order parent, this, this,
parent on this card (a same-card A/B), with no result line.  The main
path's prefill write is timed in both trees by this file's code, against
each tree's port.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import statistics
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

PATHS = ("stablelm-3b", "qwen3-moe-30b-a3b")
KERNEL_NAMES = ("paged_attention", "scatter_pages", "gather_rows",
                "flash_attention", "moe_histogram")


def log(*a) -> None:
    print(*a, flush=True)


def pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


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


def ptxas_report(build, source: str, keep) -> str:
    """Registers, spills and shared memory of each kernel in ``source``
    whose mangled name holds one of ``keep``, from the ``-Xptxas -v`` log
    kept beside its library."""
    text = build._lib_path(source).with_suffix(".so.log").read_text()
    found, name = {}, None
    for line in text.splitlines():
        if "Performance Loss" in line:      # e.g. wgmma serialized
            found.setdefault(line.split("'")[-2], []).append(
                line.split(":", 1)[-1].split(" in the function")[0].strip())
        elif "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("spill" in line or "Used" in line):
            found.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return "; ".join(f"{n}: {', '.join(v)}" for n, v in found.items()
                     if any(k in n for k in keep))


def launch_floor_ms(torch) -> float:
    """The card's launch floor: the time of the smallest device operation
    a call can be (an in-place fill of one element), measured with
    :func:`cuda_ms` like every kernel row."""
    x = torch.zeros(1, device="cuda")
    return cuda_ms(torch, lambda: x.fill_(1.0))


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

#: K1's float32 ordering slack: the kernel sums each row's scores, its
#: P.V and the cluster's partials in another order than the plain
#: version; an f32 query measures that difference directly (K1_F32_TOL
#: holds it)
K1_SLACK = 1e-5
K1_F32_TOL = 1e-4


def device_ops_per_call(torch, fn, calls: int = 10) -> float:
    """Device operations (kernels, memsets, copies) one call of ``fn``
    puts on the card: those ``torch.profiler`` records over ``calls``
    calls, divided by ``calls``.  The count is taken in a second profiling
    session: the first one of a process can start recording late."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / calls


def half_ulp_bf16(torch, x):
    """Half a bfloat16 ulp at each |x| (float32): 2^(e - 9) for |x| in
    [2^(e-1), 2^e); 0 at x = 0."""
    x = x.float().abs()
    _, e = torch.frexp(x)
    return torch.where(x > 0, torch.ldexp(torch.ones_like(x), e - 9),
                       torch.zeros_like(x))


def check_paged_attention(torch, q, k_pool, v_pool, table, lens, base, msk,
                          page_map):
    """K1 on one case, against the plain version in float32 on K/V
    rounded to q's type: a bf16 output within half a bf16 ulp (of the
    larger of the two values) plus K1_SLACK, and the control without K/V
    rounding must break that bound; an f32 output within K1_F32_TOL.
    Then every page the fence does not reach is clobbered and the output
    must not move.  Returns the output, its worst error and error/bound,
    the control's error/bound and the number of pages clobbered."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention

    bf16 = q.dtype == torch.bfloat16
    out = paged_attention(q, k_pool, v_pool, table, lens, base, msk,
                          page_map)
    want = ref.paged_attention_ref(
        q.float(), k_pool.to(q.dtype).float(), v_pool.to(q.dtype).float(),
        table, lens, base, msk, page_map)

    def err_ratio(got):
        err = (got.float() - want).abs()
        bound = (half_ulp_bf16(torch, torch.maximum(want.abs(),
                                                    got.float().abs()))
                 + K1_SLACK) if bf16 else K1_F32_TOL
        return err.max().item(), (err / bound).max().item()

    err, ratio = err_ratio(out)
    if not ratio <= 1.0:
        raise AssertionError(f"paged_attention ({q.dtype}) error {err} "
                             f"exceeds its bound ({ratio:.3f}x)")
    ctrl_ratio = None
    if bf16:
        ctrl = ref.paged_attention_ref(q.float(), k_pool, v_pool, table,
                                       lens, base, msk, page_map).to(q.dtype)
        ctrl_ratio = err_ratio(ctrl)[1]
        if not ctrl_ratio > 1.0:
            raise AssertionError(
                f"paged_attention control (no K/V rounding) within the "
                f"bound ({ctrl_ratio:.3f}x): the bound cannot see the "
                "rounding")
    P = k_pool.shape[0]
    phys = ref.resolve_pages(table, base[:, None], msk[:, None], page_map, P)
    own = set(int(p) for p in phys.reshape(-1)) | {0}
    k2, v2 = k_pool.clone(), v_pool.clone()
    foreign = [p for p in range(P) if p not in own]
    k2[foreign], v2[foreign] = 12345.0, -999.0
    if not torch.equal(out, paged_attention(q, k2, v2, table, lens, base,
                                            msk, page_map)):
        raise AssertionError("paged_attention read outside the fence")
    return dict(out=out, err=err, ratio=ratio, ctrl_ratio=ctrl_ratio,
                foreign=len(foreign))


def check_kernels(torch, cfg):
    """Rows of the kernel table at ``cfg``'s serve shapes (max_batch 8,
    64-token pages, a 64-page pool, a ragged 57-token prefill)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gather_rows import gather_rows
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.scatter_pages import scatter_pages
    import torch.nn.functional as F

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1234)
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, S, page, P = 8, 57, 64, 64          # max_batch 8, ragged prefill
    fence_vocab = pow2(cfg.vocab)
    i32 = dict(dtype=torch.int32, device=dev)
    tag = f" [{cfg.name}]"

    # inputs of the checks added later (K3's per-id fences, K4 at S = 193
    # and in f32) come from their own generator, so every other check
    # keeps the inputs ``gen`` has always given it
    more = torch.Generator(device=dev).manual_seed(4321)

    def randn(*shape, dtype=torch.float32, generator=gen):
        return torch.randn(*shape, generator=generator, device=dev).to(dtype)

    rows = []

    def row(name, source, replaces, **kw):
        rows.append(dict(kernel=name, path=cfg.name, route="cuda",
                         source=f"src/repro_torch/kernels/csrc/{source}",
                         replaces=f"src/repro/kernels/{replaces}", **kw))

    # ---- K3 gather_rows: prefill token ids under the vocab fence ------ #
    table = randn(cfg.vocab, cfg.d_model, dtype=torch.bfloat16)
    ids = torch.randint(0, cfg.vocab, (B * S,), generator=gen, **i32)
    ids[::7] = torch.randint(cfg.vocab, fence_vocab, ids[::7].shape,
                             generator=gen, **i32)    # forged: past the table
    ids[3::11] -= 1 << 20                              # forged: negative
    mask = fence_vocab - 1
    # The fence in both of the kernel's forms, each held exactly against
    # the plain version: the serve path's scalar vocab fence (by value),
    # the identity fence (negative ids wrap once), and one (base, mask) per
    # id — a quarter of the fence each, the last quarter reaching past the
    # table, so NaN rows come from both forms.
    quarter = fence_vocab // 4
    per_base = torch.tensor([0, 2 * quarter, 3 * quarter], **i32)[
        torch.randint(0, 3, (B * S,), generator=more, device=dev)]
    per_mask = torch.full((B * S,), quarter - 1, **i32)
    nan_rows, err = {}, 0.0
    for form, (fb, fm) in (("scalar", (0, mask)), ("identity", (0, -1)),
                           ("per-id", (per_base, per_mask))):
        out = gather_rows(table, ids, fb, fm)
        want = ref.gather_rows_ref(table, ids, fb, fm)
        if not torch.equal(out.isnan(), want.isnan()) or not torch.equal(
                torch.nan_to_num(out), torch.nan_to_num(want)):
            raise AssertionError(f"gather_rows disagrees with its plain "
                                 f"version under the {form} fence")
        err = max(err, (torch.nan_to_num(out).float()
                        - torch.nan_to_num(want).float()).abs().max().item())
        row_ids = ref.fence_ref(ids, fb, fm)
        row_ids = torch.where(row_ids < 0, row_ids + cfg.vocab, row_ids)
        nan_rows[form] = int(out.isnan().all(dim=1).sum())
        if nan_rows[form] != int(((row_ids < 0) | (row_ids >= cfg.vocab))
                                 .sum()):
            raise AssertionError(f"gather_rows under the {form} fence: "
                                 "ids outside the table not NaN rows")
    fenced = (ids & mask)
    in_table = fenced < cfg.vocab
    ok_ids = fenced[in_table]
    # bytes: the in-table rows read, every output row written, the ids read
    n_bytes = ((int(in_table.sum()) + ids.numel()) * cfg.d_model * 2
               + ids.numel() * 4)
    row("gather_rows", "gather_rows.cu", "fenced_gather.py:48",
        max_abs_err=err, tolerance="exact (NaN rows where the fenced id "
                                   "is past the table)",
        ms=cuda_ms(torch, lambda: gather_rows(table, ids, 0, mask)),
        plain_ms=cuda_ms(torch, lambda: ref.gather_rows_ref(
            table, ids, 0, mask)),
        library_ms=cuda_ms(torch, lambda: table.index_select(0, ok_ids)),
        library_call="Tensor.index_select of the in-table rows",
        shape=f"table {tuple(table.shape)} bf16, {ids.numel()} ids",
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(n_bytes, 0.0, "bfloat16"))))
    log(f"K3 gather_rows ok{tag}: equal to its plain version under the "
        f"scalar {fence_vocab} fence ({nan_rows['scalar']} NaN rows for ids "
        f"past the {cfg.vocab}-row table), the identity fence "
        f"({nan_rows['identity']}) and per-id fences of {quarter} rows "
        f"({nan_rows['per-id']})")
    del table

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
    row("scatter_pages", "scatter_pages.cu", "fenced_scatter.py:53",
        max_abs_err=err, tolerance="exact (a copy)",
        ms=cuda_ms(torch, lambda: scatter_pages(
            kk, vv, k_src, v_src, page_ids, base, msk, page_map)),
        plain_ms=cuda_ms(torch, lambda: ref.scatter_pages_ref(
            kr, vr, k_src, v_src, page_ids, base, msk, page_map)),
        library_ms=cuda_ms(torch, lambda: kv2.index_copy_(1, uniq, pages2)),
        library_call="Tensor.index_copy_ of the kept padded K and V pages",
        shape=f"pools ({P},{page},{KH},{D}) f32, src ({B},{S},{KH},{D})",
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(n_bytes, 0.0, "float32"))))
    # K2's bytes alone: one copy_ of the kept padded K and V pages into
    # as many contiguous pool pages, with no lookups and no fence
    bytes_ms = cuda_ms(torch, lambda: kv2[:, :len(last)].copy_(pages2))
    log(f"K2 scatter_pages ok{tag}: {len(written)} distinct pages written, "
        f"forged id wrapped into its extent, {len(untouched)} pages "
        f"untouched; its bytes alone (one copy_ of the kept padded pages) "
        f"take {bytes_ms:.5f} ms")

    # ---- K4 flash_attention: ragged prefill --------------------------- #
    # bf16 (the tensor-core kernel) and f32 (the CUDA-core kernel), at one
    # key tile (S = 57) and at four (S = 193, ragged: the online-softmax
    # rescale across tiles), each against the plain version.  bf16: one
    # bf16 ulp at outputs in [2, 4) (an early causal row averages only a
    # few V rows of N(0, 1) values), which also covers the kernel's bf16
    # rounding of P (tests/test_torch_kernels.py emulates it); f32: the
    # sums run in another order than the plain version's.
    tols = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {(bf16, S): tuple(randn(B, S, h, D, dtype=bf16)
                              for h in (H, KH, KH))}
    for dt, s_len in ((bf16, 193), (f32, S), (f32, 193)):
        cases[(dt, s_len)] = tuple(randn(B, s_len, h, D, dtype=dt,
                                         generator=more)
                                   for h in (H, KH, KH))
    errs = {}
    for (dt, s_len), (q, k, v) in cases.items():
        got = flash_attention(q, k, v)
        want = ref.flash_attention_ref(q, k, v)
        err = (got.float() - want.float()).abs().max().item()
        if not err <= tols[dt]:
            raise AssertionError(f"flash_attention {dt} S={s_len}: "
                                 f"error {err} > {tols[dt]}")
        errs[(dt, s_len)] = err
    q, k, v = cases[(bf16, S)]
    n_bytes = 2 * B * S * (2 * H + 2 * KH) * D
    flops = 4 * B * H * D * S * (S + 1) / 2
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row("flash_attention", "flash_attention.cu", "flash_attention.py:84",
        max_abs_err=max(errs[(bf16, S)], errs[(bf16, 193)]),
        tolerance="2e-2 (bf16 output, one ulp at |out| < 4)",
        ms=cuda_ms(torch, lambda: flash_attention(q, k, v)),
        plain_ms=cuda_ms(torch, lambda: ref.flash_attention_ref(q, k, v)),
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=KH != H)),
        library_call="F.scaled_dot_product_attention(is_causal=True)",
        shape=f"q ({B},{S},{H},{D}), k/v ({B},{S},{KH},{D}) bf16",
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(n_bytes, flops, "bfloat16"))))
    # four key tiles, timed for the log only
    q4, k4, v4 = cases[(bf16, 193)]
    qt, kt, vt = (t.transpose(1, 2) for t in (q4, k4, v4))
    ms_193 = cuda_ms(torch, lambda: flash_attention(q4, k4, v4))
    sdpa_193 = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=KH != H))
    log(f"K4 flash_attention ok{tag}: max |err| bf16 "
        f"{errs[(bf16, S)]:.3g} (S={S}) / {errs[(bf16, 193)]:.3g} (S=193), "
        f"tolerance 2e-2; f32 {errs[(f32, S)]:.3g} / {errs[(f32, 193)]:.3g},"
        f" tolerance 1e-4; bf16 at S=193: kernel {ms_193:.5f} ms, "
        f"scaled_dot_product_attention {sdpa_193:.5f} ms")

    # ---- K1 paged_attention: decode over the f32 pool ----------------- #
    # The main row: a bf16 query, the inputs ``gen`` has always given K1
    # (17-80 held tokens a row, forged table ids, per-row fences).  More
    # cases from ``more``: a (8, 4) table at the main path's max_len 256
    # with a full row (all four pages), a row with seq_len 0, lengths on a
    # page boundary and lengths ending inside a 32-token tile and inside a
    # cluster rank's share; each in bf16 and in f32.
    qd = randn(B, H, D, dtype=torch.bfloat16)
    table_ids = torch.randint(0, 64, (B, 4), generator=gen, **i32)  # forged
    lens = torch.randint(17, 81, (B,), generator=gen, **i32)
    base = torch.tensor([16, 16, 32, 32, 16, 32, 0, 0], **i32)
    msk = torch.tensor([15, 15, 15, 15, 15, 15, 3, 3], **i32)
    cov_table = torch.randint(0, 64, (B, 4), generator=more, **i32)
    cov_lens = torch.tensor([256, 0, 64, 128, 100, 17, 211, 255], **i32)
    k1_cases = {
        ("bf16", "main"): (qd, table_ids, lens),
        ("bf16", "max_len 256"): (randn(B, H, D, dtype=torch.bfloat16,
                                        generator=more), cov_table, cov_lens),
        ("f32", "main"): (randn(B, H, D, generator=more), table_ids, lens),
        ("f32", "max_len 256"): (randn(B, H, D, generator=more), cov_table,
                                 cov_lens),
    }
    k1 = {case: check_paged_attention(torch, q_, k_pool, v_pool, t_, l_,
                                      base, msk, page_map)
          for case, (q_, t_, l_) in k1_cases.items()}
    # the fence by value: the identity fence on the resolved physical
    # pages gives the per-row fenced result bit for bit
    phys = ref.resolve_pages(table_ids, base[:, None], msk[:, None],
                             page_map, P)
    if not torch.equal(paged_attention(qd, k_pool, v_pool, phys, lens, 0,
                                       -1),
                       k1[("bf16", "main")]["out"]):
        raise AssertionError("paged_attention under the scalar identity "
                             "fence differs from the per-row fence")
    main = k1[("bf16", "main")]
    # bytes: each held K and V token row read once (f32), q read and out
    # written (bf16), the page table and the per-row lens/base/mask read
    n_bytes = (2 * int(lens.sum()) * KH * D * 4 + 2 * B * H * D * 2
               + table_ids.numel() * 4 + 3 * B * 4)
    flops = 4 * int(lens.sum()) * H * D
    call = (lambda: paged_attention(qd, k_pool, v_pool, table_ids, lens,
                                    base, msk, page_map))
    ops = device_ops_per_call(torch, call)
    if ops != 1:
        raise AssertionError(f"paged_attention: {ops:g} device operations "
                             "a call, want 1")
    row("paged_attention", "paged_attention.cu",
        "fenced_paged_attention.py:173",
        max_abs_err=main["err"],
        tolerance=f"1/2 bf16 ulp + {K1_SLACK:g} of the f32 plain version "
                  f"on bf16-rounded K/V (worst error/bound "
                  f"{main['ratio']:.3f}; the control without K/V rounding "
                  f"{main['ctrl_ratio']:.3g})",
        ms=cuda_ms(torch, call),
        plain_ms=cuda_ms(torch, lambda: ref.paged_attention_ref(
            qd, k_pool, v_pool, table_ids, lens, base, msk, page_map)),
        library_ms=None, library_call=None,
        device_ops=ops,
        shape=f"q ({B},{H},{D}) bf16, pool ({P},{page},{KH},{D}) f32",
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(n_bytes, flops, "float32"))))
    # K1's bytes alone: one index_select of the held K and V token rows
    # (every KV head), the same bytes the kernel reads, with no chain of
    # lookups before them and no math after
    held = torch.cat([phys[r, t // page] * page + t % page
                      for r in range(B)
                      for t in [torch.arange(int(lens[r]), device=dev)]])
    kv_rows = torch.stack([k_pool, v_pool]).view(2, P * page, KH * D)
    bytes_ms = cuda_ms(torch, lambda: kv_rows.index_select(1, held))
    log(f"K1's bytes alone{tag}: one index_select of the {held.numel()} "
        f"held K and V token rows takes {bytes_ms:.5f} ms")
    q256 = k1_cases[("bf16", "max_len 256")][0]
    call_256 = (lambda: paged_attention(q256, k_pool, v_pool, cov_table,
                                        cov_lens, base, msk, page_map))
    ms_256 = cuda_ms(torch, call_256)
    # every cluster size the kernel can launch, each checked as above and
    # timed on the main row's inputs and on the max_len 256 lengths
    K1 = sys.modules["repro_torch.kernels.paged_attention"]
    chosen, sweep = K1.cluster_size, []
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        for c in (1, 2, 4, 8):
            K1.cluster_size = lambda pairs, n_sm, c=c: c
            for q_, t_, l_ in (k1_cases[("bf16", "main")],
                               k1_cases[("bf16", "max_len 256")]):
                check_paged_attention(torch, q_, k_pool, v_pool, t_, l_,
                                      base, msk, page_map)
            sweep.append(f"C={c} {cuda_ms(torch, call):.5f} / "
                         f"{cuda_ms(torch, call_256):.5f} ms")
    finally:
        K1.cluster_size = chosen
    log(f"K1 cluster sizes{tag} (main inputs / max_len 256 lengths; the "
        f"path runs C={chosen(B * KH, n_sm)}): " + ", ".join(sweep))
    log(f"K1 paged_attention ok{tag}: " + "; ".join(
        f"{dt} {name}: max |err| {r['err']:.3g}, error/bound {r['ratio']:.3f}"
        + (f", control without K/V rounding {r['ctrl_ratio']:.3g}"
           if dt == "bf16" else "")
        + f", {r['foreign']} foreign pages clobbered, output unchanged"
        for (dt, name), r in k1.items())
        + f"; bound 1/2 bf16 ulp + {K1_SLACK:g} (bf16), {K1_F32_TOL:g} (f32);"
        f" the identity fence by value equals the per-row fence; lengths "
        f"{cov_lens.tolist()}: kernel {ms_256:.5f} ms; "
        f"{ops:g} device operation(s) a call")

    if cfg.moe is not None:
        check_moe_histogram(torch, cfg, gen, more, row)
    # K2's added checks and the main path's prefill write come last: they
    # draw from ``more`` after every earlier check has drawn its inputs
    check_scatter_pages_forms(torch, cfg, more, k_pool, v_pool, page_map)
    check_prefill_write(torch, cfg, more)
    for r in rows:
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms ({r['library_call']})"
        log(f"  {r['kernel']} [{r['path']}], {r['shape']}: max |err| "
            f"{r['max_abs_err']:.3g}"
            f" (tolerance {r['tolerance']}); kernel {r['ms']:.5f} ms, plain "
            f"{r['plain_ms']:.5f} ms, library {lib}, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})"
            + (f", {r['device_ops']:g} device operation(s) a call"
               if "device_ops" in r else ""))
    return rows


def check_moe_histogram(torch, cfg, gen, more, row):
    """K5 at the MoE path's shapes: router ids over E experts, forged past
    E and negative, under the serve path's fence ``(0, pow2(E) - 1)``, the
    identity fence and a fence whose base is E (every id pinned past the
    experts: all counts zero), each held exactly against the plain
    version.  The prefill's (512, 8) ids come from ``gen`` (the row's
    original inputs); from ``more``, the decode's (8, 8) and two sizes
    past the one-CTA threshold, so the cluster route (2 and 8 CTAs) is
    checked too.  Adds its row through ``row``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_histogram import cluster_ctas, \
        moe_histogram

    E, K = cfg.moe.num_experts, cfg.moe.top_k

    def draw(T, g):
        ids = torch.randint(0, E, (T, K), generator=g, dtype=torch.int32,
                            device="cuda")
        ids[::5, 0] = torch.randint(E, 1 << 20, ids[::5, 0].shape,
                                    generator=g, dtype=torch.int32,
                                    device="cuda")
        ids[1::7, 1] = -torch.randint(1, 1 << 20, ids[1::7, 1].shape,
                                      generator=g, dtype=torch.int32,
                                      device="cuda")
        return ids

    T = 512
    ids = draw(T, gen)
    cases = {"prefill": ids}
    for name, t in (("decode", 8), ("2 CTAs", 2048), ("8 CTAs", 8192)):
        cases[name] = draw(t, more)
    serve = (0, pow2(E) - 1)
    for case, c_ids in cases.items():
        for name, (base, mask) in (("serve", serve), ("identity", (0, -1)),
                                   ("past the experts", (E, E - 1))):
            out = moe_histogram(c_ids, E, base, mask)
            want = ref.moe_histogram_ref(c_ids, E, base, mask)
            if not torch.equal(out, want):
                raise AssertionError(
                    f"moe_histogram ({case}, {tuple(c_ids.shape)}) "
                    f"disagrees with its plain version under the {name} "
                    "fence")
            fenced = (c_ids & mask) | base
            n_in = int(((fenced >= 0) & (fenced < E)).sum())
            if int(out.sum()) != n_in:
                raise AssertionError(
                    f"moe_histogram ({case}) under the {name} fence counts "
                    f"{int(out.sum())}, want {n_in}")
        if int(moe_histogram(c_ids, E, E, E - 1).sum()) != 0:
            raise AssertionError("moe_histogram counted past the experts")
    base, mask = serve
    fenced = (ids & mask) | base
    in_range = fenced[(fenced >= 0) & (fenced < E)].reshape(-1)
    # bytes: the ids read once, the counts written once
    n_bytes = ids.numel() * 4 + E * 4
    call = (lambda: moe_histogram(ids, E, base, mask))
    ops = device_ops_per_call(torch, call)
    if ops != 1:
        raise AssertionError(f"moe_histogram: {ops:g} device operations "
                             "a call, want 1")
    row("moe_histogram", "moe_histogram.cu", "moe_dispatch.py:50",
        max_abs_err=0.0, tolerance="exact (integer counts)",
        ms=cuda_ms(torch, call),
        plain_ms=cuda_ms(torch, lambda: ref.moe_histogram_ref(
            ids, E, base, mask)),
        library_ms=cuda_ms(torch, lambda: torch.bincount(in_range,
                                                         minlength=E)),
        library_call="torch.bincount of the in-range fenced ids",
        device_ops=ops, shape=f"ids ({T},{K}) int32, E = {E}",
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(n_bytes, 0.0, "float32"))))
    times = {case: cuda_ms(torch, lambda c=c: moe_histogram(c, E, base,
                                                             mask))
             for case, c in cases.items() if case != "prefill"}
    log(f"K5 moe_histogram ok [{cfg.name}]: equal to its plain version "
        f"under the serve fence {serve}, the identity fence and the "
        f"base = {E} fence (all counts 0), at " + ", ".join(
            f"{case} {tuple(c.shape)} ({cluster_ctas(c.numel())} CTA"
            f"{'s' if cluster_ctas(c.numel()) > 1 else ''})"
            for case, c in cases.items())
        + f"; {int((ids >= E).sum())} forged ids past E, "
        f"{int((ids < 0).sum())} negative in the prefill's; "
        f"{ops:g} device operation(s) a call; kernel "
        + ", ".join(f"{case} {ms:.5f} ms" for case, ms in times.items()))


#: K2's fence forms: (base, mask) by value, or built per row / per id
K2_FENCES = ("int", "identity", "per-row", "per-id")


def check_scatter_pages_forms(torch, cfg, gen, k_pool, v_pool, page_map):
    """K2 exactly against its plain version in every form the kernel
    takes: each (source, pool) dtype pair (bf16 into the f32 pool is the
    serve path's), a one-page prefill (S = 57) whose ids are a strided
    column slice of an (8, 4) page table and a four-page one (S = 193),
    each under an int fence by value, the identity fence by value, per-row
    (B,) and per-id (B, n) fences — forged ids, duplicate destinations
    within and across rows and parked rows on page 0 included.  After
    each call the pages no id resolves to must be unchanged.  Inputs come
    from ``gen``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.scatter_pages import scatter_pages

    dev = "cuda"
    i32 = dict(dtype=torch.int32, device=dev)
    B, page, P = 8, 64, 64
    KH, D = cfg.n_kv_heads, cfg.head_dim
    table = torch.randint(0, 64, (B, 4), generator=gen, **i32)
    table[1, 2] = 45               # forged: tenant0's row names tenant1's id
    table[2, 1:] = table[2, 0]     # duplicates within a row
    table[1, 0] = table[0, 0]      # and across rows of one tenant
    base = torch.tensor([16, 16, 32, 32, 0, 0, 0, 0], **i32)
    msk = torch.tensor([15, 15, 15, 15, 3, 3, 3, 3], **i32)
    base_id = base[:, None].repeat(1, 4)
    base_id[0, 3] = 32             # one page of row 0 in another extent
    fences = {"int": (16, 15), "identity": (0, -1),
              "per-row": (base, msk),
              "per-id": (base_id, msk[:, None].repeat(1, 4))}
    srcs = {s_len: [torch.randn(B, s_len, KH, D, generator=gen, device=dev)
                    for _ in range(2)] for s_len in (57, 193)}
    f32, bf16 = torch.float32, torch.bfloat16

    def per_row(v):   # a (B,) fence broadcast over the pages
        return v[:, None] if isinstance(v, torch.Tensor) and v.dim() == 1 \
            else v

    n_checks, written = 0, {}
    for src_dt in (f32, bf16):
        for pool_dt in (f32, bf16):
            pools = (k_pool.to(pool_dt), v_pool.to(pool_dt))
            for s_len, n in ((57, 1), (193, 4)):
                ids = table[:, :n]           # n = 1: a strided slice
                ks, vs = (x.to(src_dt) for x in srcs[s_len])
                for form in K2_FENCES:
                    fb, fm = fences[form]
                    fb_n = fb[:, :n] if isinstance(fb, torch.Tensor) \
                        and fb.dim() == 2 else fb
                    fm_n = fm[:, :n] if isinstance(fm, torch.Tensor) \
                        and fm.dim() == 2 else fm
                    kk, vv = (x.clone() for x in pools)
                    scatter_pages(kk, vv, ks, vs, ids, fb_n, fm_n, page_map)
                    kr, vr = (x.clone() for x in pools)
                    ref.scatter_pages_ref(kr, vr, ks, vs, ids, fb_n, fm_n,
                                          page_map)
                    what = (f"scatter_pages {src_dt} into {pool_dt}, S = "
                            f"{s_len}, {form} fence")
                    if not (torch.equal(kk, kr) and torch.equal(vv, vr)):
                        raise AssertionError(f"{what}: differs from its "
                                             "plain version")
                    phys = ref.resolve_pages(ids, per_row(fb_n),
                                             per_row(fm_n), page_map, P)
                    hit = set(int(x) for x in phys.reshape(-1))
                    rest = [x for x in range(P) if x not in hit]
                    if not (torch.equal(kk[rest], pools[0][rest])
                            and torch.equal(vv[rest], pools[1][rest])):
                        raise AssertionError(f"{what}: wrote outside the "
                                             "fenced pages")
                    if form == "per-row" and n == 4 and \
                            not 1 <= int(phys[1, 2]) <= 16:
                        raise AssertionError(f"{what}: forged id left its "
                                             "extent")
                    written[(s_len, form)] = len(hit)
                    n_checks += 1
    ks, vs = (x.to(bf16) for x in srcs[193])
    kk, vv = k_pool.clone(), v_pool.clone()
    ms_193 = cuda_ms(torch, lambda: scatter_pages(kk, vv, ks, vs, table,
                                                  base, msk, page_map))
    log(f"K2 scatter_pages forms ok [{cfg.name}]: {n_checks} cases equal to "
        "the plain version (f32/bf16 sources into f32/bf16 pools; S = 57 "
        "with strided ids, S = 193 over 4 pages; fences "
        + ", ".join(K2_FENCES) + "), pages not written unchanged; distinct "
        "pages written " + ", ".join(f"S={k[0]} {k[1]}: {v}"
                                     for k, v in written.items())
        + f"; bf16 into f32 at S = 193 (per-row fence): {ms_193:.5f} ms")


def prefill_write_row(torch, cfg, gen):
    """The main path's prefill page write, as one layer of a prefill
    makes it: bf16 K/V (8, 57, KH, D) written by ``write_prefill_kv`` into
    the f32 layer view (64, 64, KH, D) of a two-layer pool under a per-row
    BITWISE guard with a page map (tenant rows, one forged id, four parked
    rows on the scratch extent).  Checks the write exactly against the
    plain version on the operands ``kernel_fence`` gives, and that the
    other layer is untouched; returns its time, device operations per
    call (under that guard and with no guard), the plain version's time,
    the bytes bound and the operands.  Uses only entry points every tree
    of the port has, so the same-card A/B times it on both."""
    from repro_torch.core.fence import FenceParams, FencePolicy
    from repro_torch.kernels import ref
    from repro_torch.models import kvcache as KV
    from repro_torch.models.guard import GuardSpec, kernel_fence

    dev = "cuda"
    i32 = dict(dtype=torch.int32, device=dev)
    B, S, P = 8, 57, 64
    KH, D = cfg.n_kv_heads, cfg.head_dim
    cache = KV.init_global_kv_cache(cfg, B, 256, P, n_layers=2, device=dev)
    for pool in (cache.k, cache.v):
        pool.copy_(torch.randn(pool.shape, generator=gen, device=dev))
    table = torch.randint(0, 64, (B, 4), generator=gen, **i32)
    table[:, 0] = torch.tensor([16, 45, 33, 40, 0, 1, 2, 3], **i32)
    cache = dataclasses.replace(cache, page_table=table)
    page_map = torch.zeros(64, **i32)
    page_map[16:32] = torch.arange(1, 17, **i32)
    page_map[32:48] = torch.arange(17, 33, **i32)
    guard = GuardSpec(
        policy=FencePolicy.BITWISE, vocab=FenceParams(0, pow2(cfg.vocab)),
        kv=FenceParams(base=torch.tensor([16, 16, 32, 32, 0, 0, 0, 0], **i32),
                       size=torch.tensor([16, 16, 16, 16, 4, 4, 4, 4], **i32)),
        page=FenceParams(0, P), page_map=page_map)
    k_new, v_new = (torch.randn(B, S, KH, D, generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
    ids, fb, fm, pm = kernel_fence(guard, cache.page_table[:, :1])
    kr, vr = cache.k[1].clone(), cache.v[1].clone()
    ref.scatter_pages_ref(kr, vr, k_new, v_new, ids, fb, fm, pm)
    k0, v0 = cache.k[0].clone(), cache.v[0].clone()

    def call():
        KV.write_prefill_kv(cache, 1, k_new, v_new, guard)

    call()
    if not (torch.equal(cache.k[1], kr) and torch.equal(cache.v[1], vr)
            and torch.equal(cache.k[0], k0) and torch.equal(cache.v[0], v0)):
        raise AssertionError(f"write_prefill_kv [{cfg.name}] differs from "
                             "the plain page write")
    phys = ref.resolve_pages(ids, fb[:, None], fm[:, None], pm, P)
    kept = len(set(int(x) for x in phys.reshape(-1)))
    # bytes: for each kept page of K and V its S bf16 source tokens read
    # and the whole f32 page written, plus the ids and per-row fences
    n_bytes = (2 * kept * (S * KH * D * 2 + 64 * KH * D * 4)
               + ids.numel() * 4 + 2 * B * 4)
    ops = device_ops_per_call(torch, call)
    ops_none = device_ops_per_call(
        torch, lambda: KV.write_prefill_kv(cache, 1, k_new, v_new, None))
    ms = cuda_ms(torch, call)
    plain_ms = cuda_ms(torch, lambda: ref.scatter_pages_ref(
        kr, vr, k_new, v_new, ids, fb, fm, pm))
    bound, by = bound_ms(n_bytes, 0.0, "float32")
    return dict(ms=ms, ops=ops, ops_none=ops_none, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, n_bytes=n_bytes, kept=kept,
                cache=cache, operands=(k_new, v_new, ids, fb, fm, pm))


def check_prefill_write(torch, cfg, gen):
    """The main path's prefill write (:func:`prefill_write_row`): one
    device operation a call under the per-row BITWISE guard and with no
    guard, as K2 alone under those operands and under the identity fence
    by value; logs its time beside K2's alone, the plain version's and the
    bound."""
    from repro_torch.kernels.scatter_pages import scatter_pages

    w = prefill_write_row(torch, cfg, gen)
    cache = w["cache"]
    k_new, v_new, ids, fb, fm, pm = w["operands"]
    k1, v1 = cache.k[1], cache.v[1]

    def kernel():
        scatter_pages(k1, v1, k_new, v_new, ids, fb, fm, pm)

    ops_k = device_ops_per_call(torch, kernel)
    ops_id = device_ops_per_call(torch, lambda: scatter_pages(
        k1, v1, k_new, v_new, ids, 0, -1, pm))
    counts = {"write_prefill_kv, BITWISE guard": w["ops"],
              "write_prefill_kv, no guard": w["ops_none"],
              "scatter_pages, per-row fence": ops_k,
              "scatter_pages, identity fence": ops_id}
    if any(v != 1 for v in counts.values()):
        raise AssertionError(f"prefill write [{cfg.name}]: device "
                             f"operations a call {counts}, want 1 each")
    kernel_ms = cuda_ms(torch, kernel)
    log(f"prefill write [{cfg.name}] (bf16 K/V (8, 57, {cfg.n_kv_heads}, "
        f"{cfg.head_dim}) into the f32 layer view, per-row BITWISE guard, "
        f"{w['kept']} kept pages): write_prefill_kv {w['ms']:.5f} ms, K2 "
        f"alone {kernel_ms:.5f} ms, plain {w['plain_ms']:.5f} ms, bound "
        f"{w['bound_ms']:.5f} ms ({w['n_bytes'] / 1e6:.2f} MB, "
        f"{w['bound_by']}); equal to the plain page write; device "
        "operations a call: " + ", ".join(f"{k} {v:g}"
                                          for k, v in counts.items()))
    del w["cache"], w["operands"]
    return w


# --------------------------------------------------------------------- #
# Phase 3: full width, 2 layers, card against CPU                       #
# --------------------------------------------------------------------- #

def check_full_width(torch, cfg):
    from repro_torch.core.fence import FenceParams, FencePolicy
    from repro_torch.models import get_model
    from repro_torch.models import kvcache as KV
    from repro_torch.models import moe as MT
    from repro_torch.models.guard import GuardSpec

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    api = get_model(cfg2)
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = api.init(gen, "cuda")

    def to_cpu(x):
        if isinstance(x, dict):
            return {k: to_cpu(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to_cpu(v) for v in x]
        return x.cpu()

    cpu_params = to_cpu(params)
    B, S, P, max_len = 2, 24, 16, 128
    page_map = torch.zeros(P, dtype=torch.int32)
    page_map[4:8] = torch.tensor([1, 2, 3, 4])
    page_map[8:12] = torch.tensor([5, 6, 7, 8])
    table = torch.tensor([[4, 5], [8, 9]], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator()
                         .manual_seed(3), dtype=torch.int32)

    # the smallest gap between the K-th and (K+1)-th router probability
    # met on the card: a routing decision closer than float error could
    # flip between the card and the CPU
    margins = []
    top_k = MT._top_k

    def top_k_margin(probs, k):
        vals, idx = top_k(probs, k + 1)
        if probs.is_cuda:
            margins.append((vals[:, k - 1] - vals[:, k]).min())
        return vals[:, :k], idx[:, :k]

    def run(device, p):
        guard = GuardSpec(
            policy=FencePolicy.BITWISE,
            vocab=FenceParams(0, pow2(cfg.vocab)),
            kv=FenceParams(base=torch.tensor([4, 8], dtype=torch.int32,
                                             device=device),
                           size=torch.tensor([4, 4], dtype=torch.int32,
                                             device=device)),
            expert=(FenceParams(0, pow2(cfg.moe.num_experts))
                    if cfg.moe else None),
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

    MT._top_k = top_k_margin
    try:
        logits_gpu, ids_gpu = run("cuda", params)
        logits_cpu, ids_cpu = run("cpu", cpu_params)
    finally:
        MT._top_k = top_k
    err = (logits_gpu - logits_cpu).abs().max().item()
    tol = 2e-3
    margin = f"; smallest top-{cfg.moe.top_k} routing margin " \
        f"{min(float(m) for m in margins):.3g}" if margins else ""
    if not torch.equal(ids_gpu, ids_cpu):
        raise AssertionError(f"greedy ids differ card vs CPU{margin}: "
                             f"{ids_gpu.tolist()} vs {ids_cpu.tolist()}")
    if not err <= tol:
        raise AssertionError(f"full-width logits differ by {err} > {tol}"
                             f"{margin}")
    log(f"full width x 2 layers (f32) [{cfg.name}]: card vs CPU greedy ids "
        f"equal over prefill + 4 decodes, max |logit err| {err:.3g} "
        f"(tolerance {tol}){margin}")


# --------------------------------------------------------------------- #
# Phase 4: the main paths at full width and depth                       #
# --------------------------------------------------------------------- #

def decode_floor_bytes(params) -> int:
    """Bytes one decode step must read from device memory at least: every
    layer weight (the capacity dispatch multiplies every expert, tokens or
    not), the final norm and the LM head; the embedding table only for its
    8 rows, which are left out."""
    def size(x):
        if isinstance(x, dict):
            return sum(size(v) for v in x.values())
        if isinstance(x, list):
            return sum(size(v) for v in x)
        return x.numel() * x.element_size()

    head = params["embed"].get("head", params["embed"]["table"])
    return size(params["layers"]) + size(params["norm_f"]) + size(head)


class RouteTally:
    """Within ``with``: wraps the MoE router (``models.moe.route``) to add
    up, with no host sync, every call's routed and capacity-dropped
    (token, k) assignments, and for a prefill (T > B tokens) the split
    between rows serving a request and parked rows — rows whose kv fence
    is the engine's scratch extent.  :meth:`read` syncs once."""

    def __init__(self, torch, eng):
        from repro_torch.models import moe as MT
        self.torch, self.MT, self.route = torch, MT, MT.route
        self.B, self.scratch = eng.max_batch, eng._scratch.base
        self.sums, self.routed = [], 0

    def _route(self, cfg, p, xf, guard=None, capacity_factor=2.0):
        torch, B = self.torch, self.B
        r = self.route(cfg, p, xf, guard, capacity_factor)
        dropped = (~r.keep).reshape(B, -1).sum(dim=1)
        prefill = xf.shape[0] > B
        parked = (guard.kv.base == self.scratch) & prefill
        served = ~parked & prefill
        per_row = r.keep[0].numel() * xf.shape[0] // B
        self.sums.append(torch.stack([
            dropped.sum(), torch.where(served, dropped, 0).sum(),
            torch.where(parked, dropped, 0).sum(),
            served.sum() * per_row, parked.sum() * per_row]))
        self.routed += r.keep.numel()
        return r

    def __enter__(self):
        self.MT.route = self._route
        return self

    def __exit__(self, *exc):
        self.MT.route = self.route

    def read(self) -> dict:
        names = ("dropped", "served_dropped", "parked_dropped", "served",
                 "parked")
        sums = self.torch.stack(self.sums).sum(dim=0).tolist() \
            if self.sums else [0] * len(names)
        return dict(zip(names, sums), routed=self.routed)


class GreedyGap:
    """Within ``with``: wraps the LM head (``models.layers.lm_logits``) to
    keep, with no host sync, the gap between the two largest logits of
    every row at every step — the margin by which each greedy token beat
    its runner-up, so a token that moves with a kernel's rounding can be
    told from a fault.  :meth:`read` syncs once."""

    def __init__(self, torch):
        from repro_torch.models import layers
        self.torch, self.layers, self.head = torch, layers, layers.lm_logits
        self.gaps = []

    def _head(self, cfg, p, x):
        logits = self.head(cfg, p, x)
        top = logits.float().topk(2, dim=-1).values
        self.gaps.append((top[..., 0] - top[..., 1]).reshape(-1))
        return logits

    def __enter__(self):
        self.layers.lm_logits = self._head
        return self

    def __exit__(self, *exc):
        self.layers.lm_logits = self.head

    def read(self):
        """(smallest gap, 1st percentile, number of row-steps)"""
        g = self.torch.cat(self.gaps)
        return g.min().item(), g.quantile(0.01).item(), g.numel()


def run_main_path(torch, cfg):
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import ServeEngine, make_shared_manager, \
        serve_continuous
    from repro_torch.models import moe as MT
    from repro_torch.models import transformer as TF

    torch.cuda.reset_peak_memory_stats()
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
    log(f"main path set-up [{cfg.name}]: {setup_s:.1f} s (weights, pool, "
        f"manager); pool {eng._pool.buf['k'].numel() * 8 / 1e9:.2f} GB, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")

    # CUDA events around each decode step: device-side step intervals,
    # recorded on the stream (no host sync)
    model = MT if cfg.moe else TF
    decode = model.decode
    steps = []

    def timed_decode(*a, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = decode(*a, **kw)
        e.record()
        steps.append((s, e))
        return out

    model.decode = timed_decode
    _build.reset_counts()
    try:
        with RouteTally(torch, eng) as tally, GreedyGap(torch) as gap:
            t0 = time.perf_counter()
            outs = serve_continuous([eng], max_new_tokens=16)[0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        model.decode = decode
    launches = {k.name: k.launches for k in _build.KERNELS.values()}
    plain = {k.name: k.plain_calls for k in _build.KERNELS.values()}

    if sorted(outs) != sorted(want):
        raise AssertionError(f"served {sorted(outs)}, want {sorted(want)}")
    for rid, toks in outs.items():
        if len(toks) != want[rid] or not all(0 <= t < cfg.vocab
                                             for t in toks):
            raise AssertionError(f"request {rid}: bad tokens {toks}")
    path_kernels = {"gather_rows", "scatter_pages", "flash_attention",
                    "paged_attention"} | ({"moe_histogram"} if cfg.moe
                                          else set())
    if any(launches[k] == 0 for k in path_kernels):
        raise AssertionError(f"a kernel never launched: {launches}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the card: {plain}")
    n_tok = sum(len(t) for t in outs.values())
    stats = mgr.scheduler.stats
    cycles = eng.manager.telemetry.registry.counter("drain_cycles")
    n_dec = eng.decode_steps
    n_pre = int(stats.total_launches) - n_dec
    L = cfg.n_layers
    per_step = {"gather_rows": n_pre + n_dec, "scatter_pages": L * n_pre,
                "flash_attention": L * n_pre, "paged_attention": L * n_dec,
                "moe_histogram": L * (n_pre + n_dec) if cfg.moe else 0}
    if launches != per_step:
        raise AssertionError(f"launches {launches} differ from the "
                             f"per-step count {per_step}")
    log(f"main path [{cfg.name}]: {len(outs)} requests x 16 tokens in "
        f"{wall:.2f} s ({n_tok / wall:.1f} tokens/s); {cycles} drain "
        f"cycles, {n_pre} prefills, {n_dec} decode steps; kernel launches "
        f"{launches} (per prefill: K3 1, K2 {L}, K4 {L}"
        f"{f', K5 {L}' if cfg.moe else ''}; per decode step: K3 1, K1 {L}"
        f"{f', K5 {L}' if cfg.moe else ''})")
    served = json.dumps([[int(t) for t in outs[r]] for r in sorted(outs)])
    smallest, pct1, n_gaps = gap.read()
    log(f"tokens [{cfg.name}]: sha256 "
        f"{hashlib.sha256(served.encode()).hexdigest()[:16]} of the served "
        f"tokens in request order; greedy top-1 over top-2 logit gap "
        f"smallest {smallest:.3g}, 1st percentile {pct1:.3g} over {n_gaps} "
        "row-steps")
    ms = sorted(s.elapsed_time(e) for s, e in steps)
    floor = decode_floor_bytes(eng.params)
    floor_ms = floor / HBM_BYTES_PER_S * 1e3
    log(f"decode step [{cfg.name}]: median {statistics.median(ms):.2f} ms, "
        f"min {ms[0]:.2f} ms, max {ms[-1]:.2f} ms over {len(ms)} steps; "
        f"floor {floor / 1e9:.2f} GB read = {floor_ms:.2f} ms at 3.35 TB/s "
        f"({floor_ms / statistics.median(ms):.1%} of the median); peak "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if cfg.moe is not None:
        t = tally.read()
        log(f"capacity [{cfg.name}]: dropped {t['dropped']} of {t['routed']}"
            f" (token, k) assignments; in prefills {t['served_dropped']} of "
            f"{t['served']} in rows serving a request (their right-padding "
            f"included) and {t['parked_dropped']} of {t['parked']} in "
            f"parked rows; {t['dropped'] - t['served_dropped'] - t['parked_dropped']}"
            " in decode steps")
    solo_rerun(torch, cfg, eng, outs)
    return {"launches": launches, "tokens_per_s": n_tok / wall}


def solo_rerun(torch, cfg, eng, outs):
    """The longer prompt of the last wave (requests 6 and 7 join rows 6
    and 7 in one prefill, padded to the longer, while rows 0-5 hold
    earlier requests and sit parked for that step) served again alone —
    in row 0, the other 7 rows parked, the prefill the same length —
    under ``torch.profiler`` for the device's share of the wall time.  A
    dense model's tokens cannot depend on the other rows; an MoE model's
    can, through the expert capacity the step's tokens share: ranks are
    given in (row, position) order, so the 6 parked rows ahead of row 6
    claim their experts' slots first."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import serve_continuous

    reqs = {r.rid: r for r in eng._requests}
    first = max((6, 7), key=lambda rid: len(reqs[rid].prompt))
    rid = eng.submit(reqs[first].tenant, reqs[first].prompt.tolist(),
                     max_new=16)
    with RouteTally(torch, eng) as tally, profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solo = serve_continuous([eng], max_new_tokens=16)[0][rid]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    same = solo == outs[first]
    diff = "" if same else ", first differing token " + str(next(
        i for i, (a, b) in enumerate(zip(solo, outs[first])) if a != b))
    drops = ""
    if cfg.moe is not None:
        t = tally.read()
        drops = f"; capacity dropped {t['dropped']} of {t['routed']} " \
            "assignments"
    log(f"solo rerun [{cfg.name}]: request {first} ({len(reqs[first].prompt)}"
        f"-token prompt) alone gives {'the same' if same else 'other'} "
        f"tokens as co-batched{diff}{drops}")

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kern) / 1e3
    if not busy_ms:
        log(f"profile [{cfg.name}]: the profiler saw no device time: "
            "device share not measured")
        return
    top = sorted(kern, key=dev_us, reverse=True)[:6]
    ours = [e for e in kern if any(f"{k}_" in e.key for k in KERNEL_NAMES)]
    log(f"profile [{cfg.name}]: 1 prefill + 15 decode steps in {wall * 1e3:.0f}"
        f" ms of wall time under the profiler, device busy {busy_ms:.1f} ms "
        f"({busy_ms / (wall * 1e3):.1%}); top device time: " + "; ".join(
            f"{e.key[:60]} {dev_us(e) / 1e3:.1f} ms x{e.count}" for e in top)
        + "; the port's kernels: " + "; ".join(
            f"{e.key.split('(')[0][:40]} {dev_us(e) / 1e3:.2f} ms x{e.count}"
            for e in sorted(ours, key=dev_us, reverse=True)))


# A worker of the same-card A/B: phase 2 of the checkout at argv[1], run
# with that checkout's own chip_smoke.py and kernels, then the main path's
# prefill write timed by this file's (argv[2]) code against that
# checkout's port; prints each row's (label, path, value) as one JSON line.
_AB_WORKER = """
import importlib.util, json, sys
tree, this = sys.argv[1], sys.argv[2]
sys.path[:0] = [tree, tree + "/src"]
import torch
import chip_smoke as cs
spec = importlib.util.spec_from_file_location("chip_smoke_this", this)
mine = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mine)
from repro_torch.configs import get_config
from repro_torch.kernels import _build
torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all()
rows = []
for name in cs.PATHS:
    cfg = get_config(name)
    rows += [[r["kernel"], r["path"], r["ms"]]
             for r in cs.check_kernels(torch, cfg)]
    w = mine.prefill_write_row(
        torch, cfg, torch.Generator(device="cuda").manual_seed(8765))
    rows += [["write_prefill_kv (main path), ms", name, w["ms"]],
             ["write_prefill_kv (main path), device ops", name, w["ops"]]]
print("AB " + json.dumps(rows))
"""


def same_card_ab(parent: Path) -> int:
    """``python3 chip_smoke.py --ab PARENT``: phase 2's kernel times of a
    checkout of another tree (``PARENT``, e.g. the parent commit unpacked
    with ``git archive``) and of this one, on this card in one call, in
    the order parent, this, this, parent, each in a process of its own.
    Prints a row per kernel and path with the four times."""
    order = [("parent", parent), ("this", ROOT), ("this", ROOT),
             ("parent", parent)]
    runs = []
    for label, tree in order:
        proc = subprocess.run([sys.executable, "-c", _AB_WORKER, str(tree),
                               str(ROOT / "chip_smoke.py")],
                              capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")]
        runs.append({(k, p): v for k, p, v in json.loads(line[-1][3:])})
        log(f"A/B run {len(runs)} ({label}, {tree}) done")
    log("A/B (ms unless named, in the order "
        + ", ".join(lb for lb, _ in order) + "; — where a tree lacks the "
        "row):")
    keys = list(dict.fromkeys(k for r in runs for k in r))
    for key in keys:
        log(f"  {key[0]} [{key[1]}]: " + ", ".join(
            "—" if key not in r else f"{r[key]:g}" if "ops" in key[0]
            else f"{r[key]:.5f}" for r in runs))
    return 0


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
    # the bf16 instantiations the paths run (D / 16 = 5 and 8), and f32
    log("K4 ptxas: " + ptxas_report(_build, "flash_attention.cu",
                                    ("ILi5E", "ILi8E", "f32")))
    log("K1 ptxas: " + ptxas_report(_build, "paged_attention.cu",
                                    ("paged_attention_kernel",)))
    log("K5 ptxas: " + ptxas_report(_build, "moe_histogram.cu",
                                    ("moe_histogram_kernel",)))
    log("K2 ptxas: " + ptxas_report(_build, "scatter_pages.cu",
                                    ("scatter_pages_kernel",)))
    if len(sys.argv) == 3 and sys.argv[1] == "--ab":
        return same_card_ab(Path(sys.argv[2]).resolve())

    cfgs = [get_config(name) for name in PATHS]
    floor = launch_floor_ms(torch)
    log(f"launch floor: {floor:.5f} ms (one-element fill_, the smallest "
        "device operation a call can be, timed as the kernels are)")
    rows = []
    for cfg in cfgs:
        rows += check_kernels(torch, cfg)
    for r in rows:
        log(f"  {r['kernel']} [{r['path']}]: {r['ms']:.5f} ms = "
            f"{r['ms'] / floor:.2f}x the launch floor")
    # a kernel's first row carries its name, a later path's row is
    # named kernel@path
    seen = set()
    for r in rows:
        r["name"] = r["kernel"] if r["kernel"] not in seen \
            else f"{r['kernel']}@{r['path']}"
        seen.add(r["kernel"])
    log("kernels: " + ", ".join(r["name"] for r in rows))
    for cfg in cfgs:
        check_full_width(torch, cfg)
        gc.collect()
        torch.cuda.empty_cache()
    paths = {}
    for cfg in cfgs:
        # each path's engine, manager and pool are freed before the next
        # is built (qwen3-moe's 61 GB of weights need the room)
        paths[cfg.name] = run_main_path(torch, cfg)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"after [{cfg.name}]: {torch.cuda.memory_allocated() / 1e9:.2f}"
            " GB still allocated")

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    table = [{k: (paths[r["path"]]["launches"][r["kernel"]]
                  if k == "launches" else r[k]) for k in keys}
             for r in rows]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
