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
   call puts on the card, counted by ``torch.profiler`` (one each); then
   each kernel called through its custom op ``repro_torch::<kernel>`` on
   CUDA tensors and on CPU copies: one launch and no plain call on the
   card, one plain call and no launch on the CPU, the two equal (K2, K3,
   K5 exactly, K1 and K4 in float32 within 1e-4);
3. full width against the CPU at two layers, for each path: float32,
   prefill + 4 decode steps on the card through the kernels and on the CPU
   through the plain versions, from the same weights — greedy ids equal,
   logits within a stated tolerance (the MoE path also prints the smallest
   top-k routing margin it met, so a routing tie can be told from a fault);
   then, at the same size on the card, the compiled steps (one CUDA graph
   per step key, ``core/stepgraph.py``) against eager: a prefill's and a
   decode's logits bit-identical on the first call and on a replay, equal
   served tokens, a page table forged with a co-tenant's virtual ids
   leaving the co-tenant's pages byte-identical replay after replay, and
   decode graphs replayed after an elastic grow and after a co-tenant's
   eviction writing only the tenants' pages, every pool byte equal to
   eager; and (once) a step calling ``.item()`` refused at capture with
   its name;
4. each main path at full width and full depth (bf16 weights from a seeded
   generator, float32 page pool) through ``make_shared_manager(paged=True)``,
   ``ServeEngine(paged=True)`` and ``serve_continuous``, 3 tenants and 8
   staggered requests x 16 tokens, served twice on one engine: eager
   (``jit_trusted`` off, with the routing and logit-gap hooks), then
   compiled (the default) — equal tokens per request, drain cycles,
   prefill and decode counts and kernel launches, every request served
   with its token count, every kernel of the path launched as many times
   as the per-step count says (counts set to 0 just before each run and
   read just after), no plain version run.  Each run prints its
   decode-step time (CUDA events around the manager's dispatch) against
   the bytes floor, tokens/s and peak memory; the compiled run its graphs,
   capture seconds and graph-pool bytes.  stablelm-3b runs first and is
   freed before qwen3-moe-30b-a3b (61 GB of weights) is built; the MoE
   path also prints the (token, k) assignments capacity dropped; a
   compiled solo rerun under ``torch.profiler`` gives the device's busy
   share and each of the port's kernels' device time.

6. trusted steps proven on the card (inside phase 4: stablelm-3b at full
   depth after its runs, with its weights; qwen3-moe-30b-a3b at phase 3's
   depth of 2 layers before its full-size engine is built): the serve
   steps registered with the extent-mode proof obligation
   (``register_verified_steps``, before the engine registers its own)
   serve phase 4's trace compiled; each step signature is proven at its
   first dispatch on fake tensors of the card — its seconds, its site
   table (equal to ``sandbox_report``'s), and the kernels' launches and
   ``torch.cuda.memory_allocated()`` before and after, unchanged — and
   tokens, drain cycles, prefill and decode counts, launches and graphs
   equal the ``verify=False`` run's; a decode step whose page index skips
   the fence raises ``GuardianStaticViolation`` at its first dispatch,
   before any capture, launching and allocating nothing.

5. the tenant-kernel plane (after phase 3, before phase 4's full-size
   paths): a ``GuardianManager`` with a 1 GiB f32 arena and four tenants
   of 2**26 slots (one for NONE, the standalone fast path) loads the
   simulated libraries (``core/libsim.py``) as sandboxed tenant kernels —
   gemm 1024^3, dot / axpby / isamax at n = 2**24, a 2**16-point FFT, a
   2**22-nonzero SpMV whose column ids are loaded from the arena — and
   runs each under NONE, BITWISE, MODULO and CHECK, solo and four-wide
   fused, every launch through one CUDA graph per key (captured at the
   key's first call, replayed after; the CPU side runs the same compiled
   path): results, captured and replayed, equal the port's on the CPU
   for the same seeded inputs (axpby's stored bytes and isamax's ids
   exactly, float reductions within 1e-5 normwise); each plane holds one
   graph per key, their pools together under 4 GiB; a forged-pointer
   kernel of one tenant, replaying its key alone and as one row of a
   four-wide fused step, leaves the other three partitions byte-identical
   but for their own rows' stores, every partition equal to the CPU's
   (under CHECK its stores roll back, are counted by kind and it is
   quarantined); a NONE launch past the arena, captured and replayed,
   loads NaN, leaves every byte of the arena as it was and the context
   usable; on a small arena, a fused key replays across an elastic move
   (the moved tenant fenced at its new row, the tenant registered into
   its old extent untouched) and across a change of tenant set (one
   graph), and a NONE graph does not survive a second tenant's arrival —
   each card = CPU byte for byte.  It prints each launch round's device
   time (CUDA events, the stream held busy first), wall time and device
   operations, the bytes it allocated, its peak above the start and the
   CHECK rollback log, each plane's graphs, captures, capture seconds and
   pool bytes, the same rounds for the kernels called unfenced — eagerly
   and captured by this script into a CUDA graph per round — and the
   ladders of each policy's time over the captured unfenced kernels (by
   device, kernel and wall time, the eager row beside), over the eager
   ones and over NONE's.

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

import collections
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


def device_ops_per_call(torch, fn, calls: int = 10,
                        sessions: int = 3) -> float:
    """Device operations (kernels, memsets, copies) one call of ``fn``
    puts on the card: those ``torch.profiler`` records over ``calls``
    calls, divided by ``calls``, the most that any of ``sessions``
    profiling sessions recorded.  The profiler can drop a record (the
    first session of a process starts recording late, and a later one has
    been seen to miss one launch of ten) but never makes one up, and the
    card is idle at each session's start and end, so the largest count is
    the true one.  The first session is thrown away."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(1 + sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts.append(sum(
            e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA))
    return max(counts[1:]) / calls


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


def check_ops(torch, cfg):
    """K1-K5 called through their custom ops ``repro_torch::<kernel>`` at
    ``cfg``'s widths, on CUDA tensors and on CPU copies of the same
    inputs: the CUDA call adds one launch and no plain call, the CPU call
    one plain call and no launch, and the two agree (K2, K3, K5 exactly,
    K1 and K4 in float32 within 1e-4).  K5 runs on the MoE path only, as
    in the path.  Also the host's time to enqueue one call through the
    op's dispatcher and one straight to its CUDA implementation (the
    dispatcher's cost on an eager step), alternating, 200 calls each."""
    import importlib
    from repro_torch.kernels import _build

    gen = torch.Generator().manual_seed(99)
    H, KH, D, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    i32 = torch.int32

    def rand(*shape):
        return torch.randn(*shape, generator=gen)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=i32)

    pool = (rand(8, 64, KH, D), rand(8, 64, KH, D))
    # each op's full argument list, as its schema orders it
    cases = {
        "gather_rows": ((rand(1024, d), ints(-1100, 1300, 64), None, None,
                         0, 2047), 0.0),
        "scatter_pages": ((*pool, rand(2, 70, KH, D), rand(2, 70, KH, D),
                           ints(0, 64, 2, 2), None, None, 0, 7, None), 0.0),
        "flash_attention": ((rand(2, 40, H, D), rand(2, 40, KH, D),
                             rand(2, 40, KH, D)), 1e-4),
        "paged_attention": ((rand(2, H, D), *pool, ints(0, 64, 2, 2),
                             ints(1, 129, 2), None, None, 0, 7, None), 1e-4),
    }
    if cfg.moe is not None:
        E = cfg.moe.num_experts
        cases["moe_histogram"] = ((ints(-3, pow2(E) + 3, 16, cfg.moe.top_k),
                                   E, 0, pow2(E) - 1), 0.0)

    def moved(args, dev):
        return tuple(a.clone().to(dev) if isinstance(a, torch.Tensor)
                     else a for a in args)

    def host_us(fn, n: int = 200) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        return host / n * 1e6

    errs, hosts = [], []
    for name, (args, tol) in cases.items():
        kern = _build.KERNELS[name]
        op = getattr(torch.ops.repro_torch, name)
        outs = {}
        for dev in ("cuda", "cpu"):
            before = (kern.launches, kern.plain_calls)
            a = moved(args, dev)
            out = op(*a)
            outs[dev] = (a[0], a[1]) if out is None else (out,)
            torch.cuda.synchronize()
            want = (before[0] + (dev == "cuda"), before[1] + (dev == "cpu"))
            if (kern.launches, kern.plain_calls) != want:
                raise AssertionError(
                    f"{name} op on {dev}: (launches, plain calls) "
                    f"{(kern.launches, kern.plain_calls)}, want {want}")
        for g, w in zip(outs["cuda"], outs["cpu"]):
            g = g.cpu()
            if not torch.equal(g.isnan(), w.isnan()):
                raise AssertionError(f"{name} op: NaN rows differ")
            err = (torch.nan_to_num(g).double()
                   - torch.nan_to_num(w).double()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{name} op: card vs CPU error {err} "
                                     f"> {tol}")
            errs.append(f"{name} {err:.3g}")
        a = moved(args, "cuda")
        direct = importlib.import_module(f"repro_torch.kernels.{name}")._cuda
        via_op, straight = [], []
        for _ in range(3):
            via_op.append(host_us(lambda: op(*a)))
            straight.append(host_us(lambda: direct(*a)))
        hosts.append(f"{name} {statistics.median(via_op):.1f} / "
                     f"{statistics.median(straight):.1f}")
    log(f"ops [{cfg.name}]: each kernel through its repro_torch op, one "
        "launch on CUDA tensors and one plain call on CPU tensors, card vs "
        "CPU max |err|: " + ", ".join(errs) + "; host µs to enqueue a call "
        "through the op / straight to its CUDA implementation (median of "
        "3 x 200 calls): " + ", ".join(hosts))


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
# Phase 3 (compiled): steps as CUDA graphs against eager, at phase 3's    #
# size                                                                  #
# --------------------------------------------------------------------- #

def compiled_engine(torch, cfg2, device, tenants):
    """A fresh f32 engine at ``cfg2`` (seed 0: every engine gets the same
    weights) with ``tenants`` ``{name: (pages, policy)}``."""
    from repro_torch.launch.serve import ServeEngine, make_shared_manager

    mgr = make_shared_manager(1, max_batch=8, max_len=256, paged=True,
                              device=device)
    eng = ServeEngine(cfg2, max_batch=8, max_len=256, manager=mgr,
                      paged=True, seed=0, device=device)
    for t, (pages, policy) in tenants.items():
        eng.register_tenant(t, pages, policy=policy)
    return mgr, eng


def drive(eng, hook=None, max_new_tokens=8):
    """``serve_continuous`` for one engine, with ``hook(cycle)`` at each
    cycle boundary."""
    st = eng._cont_begin(max_new_tokens)
    while st.cycles < 200:
        if hook is not None:
            hook(st.cycles)
        eng._cont_leave(st)
        joiners = eng._cont_join(st)
        h = eng._cont_dispatch(st, joiners)
        if h[0] is None and h[1] is None and not eng._cont_waiting(st):
            break
        eng.manager.run_queued()
        eng._cont_finish(st, *h)
    else:
        raise AssertionError("the trace did not drain in 200 cycles")
    return eng._cont_finalize(st), st.cycles


def probe_logits(torch, eng, compiled: bool, rounds: int):
    """A prefill and a decode step that hand back their logits, launched
    through ``eng``'s manager as trusted steps on one prepared batch (two
    rows serving a request, six parked), ``rounds`` times each: eager, or
    compiled (the first round warms up and captures, later rounds
    replay).  Each round rewrites the same pool bytes."""
    from repro_torch.launch.steps import join_cache_pool, split_cache_pool

    mgr, api = eng.manager, eng.api
    names = ("probe.prefill", "probe.decode")
    if names[0] not in mgr.pointer_to_symbol:
        def step(run):
            def fn(arena, pool, params, meta, x, guard):
                cache, logits = run(params, join_cache_pool(pool, meta), x,
                                    guard=guard)
                new_pool, new_meta = split_cache_pool(cache)
                return arena, new_pool, (new_meta, logits)
            return fn
        for name, run in zip(names, (api.prefill, api.decode)):
            mgr.register_trusted_kernel(name, step(run), resident_argnums=(1,),
                                        pool_arena=eng._steps.pool_name)
        st = eng._cont_begin(1)
        for t, p in (("t0", [5, 17, 29, 41, 53, 65, 77]), ("t1", [3] * 40)):
            eng.submit(t, p, max_new=1)
        joiners = eng._cont_join(st)
        eng._probe = (st, joiners)
    st, joiners = eng._probe
    rows = [r if i in joiners else None for i, r in enumerate(st.rows)]
    guard = eng._guard_for_rows(rows)
    plen = max(len(st.rows[i].prompt) for i in joiners)
    toks = torch.zeros((eng.max_batch, plen), dtype=torch.int32)
    for i in joiners:
        toks[i, :len(st.rows[i].prompt)] = torch.tensor(st.rows[i].prompt)
    meta = eng._cont_meta(st, set(joiners))
    mgr.jit_trusted = compiled
    out = []
    for _ in range(rounds):
        pre = eng._client.launch_kernel(names[0], args=(
            eng.params, meta, {"tokens": toks.to(eng.device)}, guard))
        mgr.run_queued()
        new_meta, logits = pre.result
        dec = eng._client.launch_kernel(names[1], args=(
            eng.params, new_meta, logits.argmax(-1).to(torch.int32), guard))
        mgr.run_queued()
        out.append((logits, dec.result[1]))
    return out, joiners


def fence_scenario(torch, cfg2, device, name: str, compiled: bool):
    """One served trace whose decode graph replays after the fence rows
    moved: ``grow`` (a one-page tenant grows mid-run) or ``evict`` (a
    co-tenant is quarantined and evicted mid-run).  Returns the tokens,
    the cycles, the pool without page 0 (the allocator's garbage page,
    where parked rows' duplicate writes race) and whether every page
    written lies in some tenant's extent at some cycle of the run."""
    tenants = ({"a": (16, None), "b": (1, None)} if name == "grow" else
               {t: (8, None) for t in "abc"})
    mgr, eng = compiled_engine(torch, cfg2, device, tenants)
    mgr.jit_trusted = compiled
    owners = ["b" if i % 3 == 0 else "a" for i in range(8)] \
        if name == "grow" else ["abc"[i % 3] for i in range(8)]
    rids = [eng.submit(o, [(7 * i + 3 * j) % 997 + 1 for j in range(20)],
                       max_new=3 + i % 4, arrive=i // 2)
            for i, o in enumerate(owners)]
    owned = {0}

    def hook(cycle):
        pm = eng._pool.pages.page_map
        for t in tenants:
            if t in mgr.bounds.tenants():
                part = mgr.bounds.lookup(t)
                owned.update(int(pm[v]) for v in range(part.base, part.end))
        if name == "evict" and cycle == 3:
            eng.quarantine_tenant("b", reason="phase 3 compiled check")
            eng.evict_tenant("b")

    out, cycles = drive(eng, hook)
    if name == "grow" and mgr.bounds.lookup("b").size <= 1:
        raise AssertionError("the grow scenario never grew")
    if name == "evict" and not eng.rejected:
        raise AssertionError("the evict scenario dropped no request")
    k, v = eng._pool.buf["k"], eng._pool.buf["v"]
    written = ((k != 0) | (v != 0)).flatten(2).any(dim=2).any(dim=0)
    inside = set(written.nonzero().flatten().tolist()) <= owned
    return ([out.get(r) for r in rids], cycles, k[:, 1:].clone(),
            v[:, 1:].clone(), inside, mgr.jit_cache_stats()["graphs"])


def check_uncapturable(torch):
    """A trusted step that syncs with the host (``.item()``) cannot be
    captured: the compiled path raises with the step's name, and the card
    stays usable."""
    from repro_torch.core.manager import GuardianManager
    from repro_torch.core.stepgraph import StepCaptureError

    mgr = GuardianManager(total_slots=64)
    mgr.register_trusted_kernel(
        "uncapturable", lambda arena, x: (arena, x * x.sum().item()))
    client = mgr.register_tenant("t", 8)
    for attempt in range(2):        # a retry fails again, never runs eager
        client.launch_kernel("uncapturable",
                             args=(torch.ones(4, device="cuda"),))
        try:
            mgr.synchronize()
        except StepCaptureError as err:
            if "'uncapturable'" not in str(err):
                raise AssertionError(f"the capture error names no step: "
                                     f"{err}")
            cause = str(err.__cause__).splitlines()[0][:120]
        else:
            raise AssertionError(f"a step calling .item() ran (attempt "
                                 f"{attempt + 1})")
    x = torch.arange(4.0, device="cuda")
    if (x * 2).sum().item() != 12.0:
        raise AssertionError("the card is unusable after a failed capture")
    log(f"compiled steps: a step calling .item() raises StepCaptureError "
        f"naming it, twice ({cause}); the card stays usable")


def check_compiled(torch, cfg, device: str = "cuda"):
    """Phase 3's size (float32, two layers, full width) through the
    compiled path on the card: (1) a prefill's and a decode's logits,
    compiled — first call and replay — bit-identical to eager, and the
    served tokens of a trace equal; (2) a page table forged with a
    co-tenant's virtual ids leaves the co-tenant's pages as they were,
    replay after replay; (3) decode graphs replayed after an elastic grow
    and after a co-tenant's eviction write only pages of the tenants'
    extents, and every pool byte and token equals the eager run's."""
    import dataclasses as dc

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    mgr, eng = compiled_engine(torch, cfg2, device,
                               {"t0": (16, None), "t1": (16, None)})
    # the rows serving a request: a parked row's decode appends its K/V
    # to the garbage page, where the parked rows' writes race (an MoE
    # model's parked rows write different values), so its logits are not
    # deterministic, eager or compiled — and never emitted
    (eager,), rows = probe_logits(torch, eng, False, 1)
    comp, _ = probe_logits(torch, eng, True, 2)
    for i, (pre, dec) in enumerate(comp):
        diff = [(a[rows] - b[rows]).abs().max().item()
                for a, b in ((pre, eager[0]), (dec, eager[1]))]
        if any(diff):
            raise AssertionError(
                f"[{cfg.name}] compiled logits ({'replay' if i else 'first'}"
                f" call) of the serving rows differ from eager by {diff}")
    parked = [r for r in range(eng.max_batch) if r not in rows]
    race = max((dec[parked] - eager[1][parked]).abs().max().item()
               for _, dec in comp)
    probes = sum(mgr.pointer_to_symbol[n].jit_cache[k].replays
                 for n in ("probe.prefill", "probe.decode")
                 for k in mgr.pointer_to_symbol[n].jit_cache)
    trace = [(f"t{i % 2}", [(11 * i + j) % 509 + 1 for j in range(9 + 5 * i)],
              i // 2) for i in range(6)]
    toks = []
    for compiled in (False, True):
        mgr.jit_trusted = compiled
        rids = [eng.submit(t, p, max_new=6, arrive=a) for t, p, a in trace]
        out = drive(eng)[0]
        toks.append([out[r] for r in rids])
    if toks[0] != toks[1]:
        raise AssertionError(f"[{cfg.name}] compiled tokens differ: "
                             f"{toks[1]} vs {toks[0]}")
    log(f"compiled [{cfg.name}] f32 x 2 layers: prefill and decode logits "
        f"of the {len(rows)} serving rows, first call and replay ({probes} "
        f"replays), bit-identical to eager (the parked rows' decode logits "
        f"differ by up to {race:.3g}); a {len(trace)}-request trace serves "
        "equal tokens")

    # (2) a forged page table, replay after replay
    mgr, eng = compiled_engine(torch, cfg2, device,
                               {"victim": (4, None), "forger": (4, None)})
    eng.submit("victim", list(range(1, 40)), max_new=3)
    drive(eng, max_new_tokens=3)
    vp = mgr.bounds.lookup("victim")
    pm = eng._pool.pages.page_map
    phys = [int(pm[v]) for v in range(vp.base, vp.end)]
    kept = [eng._pool.buf[n][:, phys].clone() for n in ("k", "v")]
    meta = eng._cont_meta

    def forged(st, active):
        m = meta(st, active)
        rows = [i for i, r in enumerate(st.rows)
                if r is not None and r.tenant == "forger" and i in active]
        table = m.page_table.clone()
        table[rows] = torch.arange(vp.base, vp.base + table.shape[1],
                                   dtype=torch.int32, device=table.device)
        return dc.replace(m, page_table=table)

    eng._cont_meta = forged
    eng.submit("forger", list(range(2, 60)), max_new=6)
    drive(eng, max_new_tokens=6)
    decode = mgr.pointer_to_symbol[eng._steps.decode_name].jit_cache
    replays = sum(g.replays for g in decode.values())
    if replays < 4:
        raise AssertionError(f"forged decode replayed {replays} times")
    for n, before in zip(("k", "v"), kept):
        if not torch.equal(eng._pool.buf[n][:, phys], before):
            raise AssertionError(f"[{cfg.name}] a forged page table wrote "
                                 f"the co-tenant's {n} pages under replay")
    log(f"compiled [{cfg.name}]: a page table forged with the co-tenant's "
        f"virtual ids over {replays} decode replays left its {len(phys)} "
        "physical pages byte-identical")

    # (3) replays after the fence rows moved
    for name in ("grow", "evict"):
        runs = [fence_scenario(torch, cfg2, device, name, c)
                for c in (False, True)]
        (te, ce, ke, ve, ie, _), (tc, cc, kc, vc, ic, graphs) = runs
        if not (ie and ic):
            raise AssertionError(f"[{cfg.name}] {name}: a page outside the "
                                 "tenants' extents was written")
        if te != tc or ce != cc or not (torch.equal(ke, kc)
                                        and torch.equal(ve, vc)):
            raise AssertionError(f"[{cfg.name}] {name}: compiled run differs"
                                 f" from eager (tokens {tc} vs {te})")
        what = "an elastic grow" if name == "grow" \
            else "a co-tenant eviction"
        log(f"compiled [{cfg.name}]: decode replayed after {what} "
            f"({graphs} graphs, {cc} cycles): only pages of the tenants' "
            "extents written, pool and tokens equal to eager")


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


def path_trace(torch, cfg):
    """The main path's 8 seeded requests: (tenant, prompt, arrival cycle),
    prompts of 16-64 tokens, two arriving per cycle."""
    rng = torch.Generator().manual_seed(11)
    trace = []
    for i in range(8):
        plen = int(torch.randint(16, 65, (1,), generator=rng))
        prompt = torch.randint(0, cfg.vocab, (plen,), generator=rng)
        trace.append((f"tenant{i % 3}", prompt.tolist(), i // 2))
    return trace


class DispatchTimes:
    """Within ``with``: CUDA events around the manager's dispatch of each
    of ``eng``'s decode steps — outside any capture, so they time eager
    steps and graph replays alike — and the host's wall time of the same
    dispatch, with the part of it spent flattening a compiled step's
    operands and keying its resident tensors.  A dispatch that captured a
    new graph (its first call: the eager warm-up, then the capture on the
    host) is kept apart."""

    def __init__(self, torch, eng):
        self.torch, self.eng, self.mgr = torch, eng, eng.manager
        self.steps, self.captures, self.host, self.keying = [], [], [], []
        self._keying = 0.0

    def _timed(self, req):
        if req.name != self.eng._steps.decode_name:
            return self.execute(req)
        ev = self.torch.cuda.Event
        s, e = ev(enable_timing=True), ev(enable_timing=True)
        graphs = self.mgr.jit_cache_stats()["graphs"]
        self._keying = 0.0
        t0 = time.perf_counter()
        s.record()
        out = self.execute(req)
        e.record()
        host = time.perf_counter() - t0
        if self.mgr.jit_cache_stats()["graphs"] > graphs:
            self.captures.append((s, e))
        else:
            self.steps.append((s, e))
            self.host.append(host * 1e3)
            self.keying.append(self._keying * 1e3)
        return out

    def _operands(self, *a, **kw):
        t0 = time.perf_counter()
        ops = self.trusted_operands(*a, **kw)
        ops.key = self._key(ops.key)
        self._keying += time.perf_counter() - t0
        return ops

    def _key(self, key):
        def timed():
            t0 = time.perf_counter()
            out = key()
            self._keying += time.perf_counter() - t0
            return out
        return timed

    def __enter__(self):
        self.execute = self.mgr._execute_request
        self.trusted_operands = self.mgr._trusted_operands
        self.mgr._execute_request = self._timed
        self.mgr._trusted_operands = self._operands
        return self

    def __exit__(self, *exc):
        del self.mgr._execute_request
        del self.mgr._trusted_operands

    def read(self):
        """(sorted replay/eager step ms, capture-step ms, median host ms of
        a dispatch, median ms of it flattening and keying operands)"""
        med = statistics.median
        return (sorted(s.elapsed_time(e) for s, e in self.steps),
                [s.elapsed_time(e) for s, e in self.captures],
                med(self.host) if self.host else 0.0,
                med(self.keying) if self.keying else 0.0)


def serve_run(torch, cfg, eng, trace, compiled: bool) -> dict:
    """One run of ``trace`` through ``serve_continuous`` on ``eng``: eager
    (the manager's ``jit_trusted`` off) with the diagnostic hooks, or
    compiled (one CUDA graph per step key, no hook: under a graph a hook
    would run once, at the capture).  Checks every request's tokens and
    that the kernels' launches equal the per-step counts with no plain
    version run; returns what the two runs are compared on and print."""
    import contextlib
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve_continuous

    mgr = eng.manager
    mgr.jit_trusted = compiled
    reg, stats = mgr.telemetry.registry, mgr.scheduler.stats
    cycles0, dec0 = reg.counter("drain_cycles"), eng.decode_steps
    graphs0 = mgr.jit_cache_stats()["graphs"]
    steps0 = int(stats.total_launches)
    rids = [eng.submit(t, p, max_new=16, arrive=a) for t, p, a in trace]
    with contextlib.ExitStack() as hooks:
        times = hooks.enter_context(DispatchTimes(torch, eng))
        tally = gap = None
        if not compiled:
            tally = hooks.enter_context(RouteTally(torch, eng))
            gap = hooks.enter_context(GreedyGap(torch))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        t0 = time.perf_counter()
        outs = serve_continuous([eng], max_new_tokens=16)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _build.KERNELS.values()}
    plain = {k.name: k.plain_calls for k in _build.KERNELS.values()}
    tokens = [outs.get(r) for r in rids]
    for rid, toks in zip(rids, tokens):
        if toks is None or len(toks) != 16 or not all(0 <= t < cfg.vocab
                                                      for t in toks):
            raise AssertionError(f"request {rid}: bad tokens {toks}")
    path_kernels = {"gather_rows", "scatter_pages", "flash_attention",
                    "paged_attention"} | ({"moe_histogram"} if cfg.moe
                                          else set())
    if any(launches[k] == 0 for k in path_kernels):
        raise AssertionError(f"a kernel never launched: {launches}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the card: {plain}")
    n_dec = eng.decode_steps - dec0
    n_pre = int(stats.total_launches) - steps0 - n_dec
    L = cfg.n_layers
    per_step = {"gather_rows": n_pre + n_dec, "scatter_pages": L * n_pre,
                "flash_attention": L * n_pre, "paged_attention": L * n_dec,
                "moe_histogram": L * (n_pre + n_dec) if cfg.moe else 0}
    if launches != per_step:
        raise AssertionError(f"launches {launches} differ from the "
                             f"per-step count {per_step}")
    step_ms, capture_ms, host_ms, keying_ms = times.read()
    return {"tokens": tokens, "cycles": reg.counter("drain_cycles") - cycles0,
            "prefills": n_pre, "decodes": n_dec, "launches": launches,
            "graphs": mgr.jit_cache_stats()["graphs"] - graphs0,
            "outs": dict(zip(rids, tokens)), "rids": rids, "wall": wall,
            "step_ms": step_ms, "capture_ms": capture_ms,
            "host_ms": host_ms, "keying_ms": keying_ms,
            "peak": torch.cuda.max_memory_allocated(),
            "tally": tally, "gap": gap}


def run_main_path(torch, cfg, smi: str):
    """Phase 4 for one path: the trace served twice on one engine, first
    eager, then compiled; the two runs must give equal tokens per request,
    drain cycles, prefill and decode counts and kernel launches."""
    from repro_torch.launch.serve import ServeEngine, make_shared_manager

    if cfg.moe is not None:
        # the MoE path is proven at phase 3's depth, before its 61 GB of
        # weights are built
        proof_phase(torch, dataclasses.replace(cfg, n_layers=2), smi)
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mgr = make_shared_manager(1, max_batch=8, max_len=256, paged=True)
    eng = ServeEngine(cfg, max_batch=8, max_len=256, manager=mgr,
                      paged=True, seed=0)
    for t in range(3):
        eng.register_tenant(f"tenant{t}", 16)
    trace = path_trace(torch, cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"main path set-up [{cfg.name}]: {setup_s:.1f} s (weights, pool, "
        f"manager); pool {eng._pool.buf['k'].numel() * 8 / 1e9:.2f} GB, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    runs = {mode: serve_run(torch, cfg, eng, trace, mode == "compiled")
            for mode in ("eager", "compiled")}
    eager, comp = runs["eager"], runs["compiled"]
    for key in ("tokens", "cycles", "prefills", "decodes", "launches"):
        if eager[key] != comp[key]:
            raise AssertionError(f"[{cfg.name}] compiled {key} differ from "
                                 f"eager: {comp[key]} vs {eager[key]}")
    L = cfg.n_layers
    n_tok = sum(len(t) for t in comp["tokens"])
    log(f"main path [{cfg.name}]: {len(trace)} requests x 16 tokens, eager "
        f"and compiled on one engine with equal tokens; {comp['cycles']} "
        f"drain cycles, {comp['prefills']} prefills, {comp['decodes']} "
        f"decode steps each; kernel launches {comp['launches']} in each run "
        f"(per prefill: K3 1, K2 {L}, K4 {L}{f', K5 {L}' if cfg.moe else ''}"
        f"; per decode step: K3 1, K1 {L}{f', K5 {L}' if cfg.moe else ''})")
    served = json.dumps(eager["tokens"])
    smallest, pct1, n_gaps = eager["gap"].read()
    log(f"tokens [{cfg.name}]: sha256 "
        f"{hashlib.sha256(served.encode()).hexdigest()[:16]} of the served "
        f"tokens in request order; greedy top-1 over top-2 logit gap "
        f"smallest {smallest:.3g}, 1st percentile {pct1:.3g} over {n_gaps} "
        "row-steps (eager run)")
    floor = decode_floor_bytes(eng.params)
    floor_ms = floor / HBM_BYTES_PER_S * 1e3
    graphs = mgr.jit_cache_stats()
    for mode, r in runs.items():
        ms = r["step_ms"]
        med = statistics.median(ms)
        first = f"; first (warm-up + capture) {r['capture_ms'][0]:.2f} ms" \
            if r["capture_ms"] else ""
        log(f"decode step [{cfg.name}, {mode}]: median {med:.2f} ms, min "
            f"{ms[0]:.2f} ms, max {ms[-1]:.2f} ms over {len(ms)} steps"
            f"{first}; floor {floor / 1e9:.2f} GB read = {floor_ms:.2f} ms "
            f"at 3.35 TB/s ({floor_ms / med:.1%} of the median); the host's "
            f"wall time of a dispatch median {r['host_ms']:.2f} ms"
            + (f", {r['keying_ms']:.2f} ms of it flattening the operands and "
               "keying the resident ones" if mode == "compiled" else "")
            + "; "
            f"{n_tok / r['wall']:.1f} tokens/s ({r['wall']:.2f} s); peak "
            f"memory {r['peak'] / 1e9:.2f} GB; {smi}")
    per = {n: graphs["per_kernel"][n] for n in (eng._steps.prefill_name,
                                                 eng._steps.decode_name)}
    log(f"graphs [{cfg.name}]: {graphs['graphs']} captured ("
        f"{per[eng._steps.prefill_name]} prefill lengths, "
        f"{per[eng._steps.decode_name]} decode), "
        f"{graphs['graph_capture_s']:.2f} s capturing, "
        f"{graphs['graph_pool_bytes'] / 1e9:.3f} GB reserved by their "
        f"memory pools, {graphs['graph_evictions']} evicted")
    if cfg.moe is not None:
        t = eager["tally"].read()
        log(f"capacity [{cfg.name}]: dropped {t['dropped']} of {t['routed']}"
            f" (token, k) assignments; in prefills {t['served_dropped']} of "
            f"{t['served']} in rows serving a request (their right-padding "
            f"included) and {t['parked_dropped']} of {t['parked']} in "
            f"parked rows; {t['dropped'] - t['served_dropped'] - t['parked_dropped']}"
            " in decode steps (eager run)")
    solo_rerun(torch, cfg, eng, comp["outs"], comp["rids"], smi)
    if cfg.moe is None:
        # full depth, the same weights and trace: the compiled run above
        # is the verify=False run the proven one must equal
        proof_phase(torch, cfg, smi, params=eng.params, reference=comp)
    return {"launches": comp["launches"],
            "tokens_per_s": n_tok / comp["wall"]}


def solo_rerun(torch, cfg, eng, outs, rids, smi: str):
    """The longer prompt of the last wave (requests 6 and 7 join rows 6
    and 7 in one prefill, padded to the longer, while rows 0-5 hold
    earlier requests and sit parked for that step) served again alone —
    in row 0, the other 7 rows parked, the prefill the same length, with
    compiled steps (the graphs of the compiled run replay) —
    under ``torch.profiler`` for the device's share of the wall time.  A
    dense model's tokens cannot depend on the other rows; an MoE model's
    can, through the expert capacity the step's tokens share: ranks are
    given in (row, position) order, so the 6 parked rows ahead of row 6
    claim their experts' slots first (the eager run's capacity line
    counts the drops; no hook runs under a graph)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import serve_continuous

    reqs = {r.rid: r for r in eng._requests}
    first = max(rids[6:8], key=lambda rid: len(reqs[rid].prompt))
    rid = eng.submit(reqs[first].tenant, reqs[first].prompt.tolist(),
                     max_new=16)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solo = serve_continuous([eng], max_new_tokens=16)[0][rid]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    same = solo == outs[first]
    diff = "" if same else ", first differing token " + str(next(
        i for i, (a, b) in enumerate(zip(solo, outs[first])) if a != b))
    log(f"solo rerun [{cfg.name}]: request {rids.index(first)} "
        f"({len(reqs[first].prompt)}"
        f"-token prompt) alone gives {'the same' if same else 'other'} "
        f"tokens as co-batched{diff}")

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
    log(f"profile [{cfg.name}, compiled]: 1 prefill + 15 decode steps in "
        f"{wall * 1e3:.0f} ms of wall time under the profiler, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / (wall * 1e3):.1%}) on {smi}; top "
        "device time: " + "; ".join(
            f"{e.key[:60]} {dev_us(e) / 1e3:.1f} ms x{e.count}" for e in top)
        + "; the port's kernels: " + "; ".join(
            f"{e.key.split('(')[0][:40]} {dev_us(e) / 1e3:.2f} ms x{e.count}"
            for e in sorted(ours, key=dev_us, reverse=True)))


# --------------------------------------------------------------------- #
# Phase 6: trusted steps proven on the card (extent mode)               #
# --------------------------------------------------------------------- #

class ProofWatch:
    """Within ``with``: wraps the manager's proof obligation
    (``_verify_trusted``) and keeps, for each proof it computes (a cached
    one is skipped), the step's name and operands, the seconds it took,
    the proof, and the kernels' launch total and
    ``torch.cuda.memory_allocated()`` just before and just after it."""

    def __init__(self, torch, mgr):
        self.torch, self.mgr = torch, mgr
        self.records = []

    def _verify(self, entry, call_args, arg_sig=None):
        from repro_torch.kernels import _build

        torch = self.torch
        n = len(entry.proofs)
        torch.cuda.synchronize()
        launches = sum(k.launches for k in _build.KERNELS.values())
        mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        proof = self.verify(entry, call_args, arg_sig)
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
        if len(entry.proofs) > n:
            self.records.append(dict(
                name=entry.name, args=call_args, seconds=seconds,
                proof=proof, launches=(launches, sum(
                    k.launches for k in _build.KERNELS.values())),
                memory=(mem, torch.cuda.memory_allocated())))
        return proof

    def __enter__(self):
        self.verify = self.mgr._verify_trusted
        self.mgr._verify_trusted = self._verify
        return self

    def __exit__(self, *exc):
        del self.mgr._verify_trusted


def site_summary(proof) -> str:
    """A proof's site table with equal rows counted once."""
    rows = collections.Counter(
        f"{s.verdict.upper()} {s.kind.name.lower()} {s.prim} "
        f"idx∈{s.interval} target {s.target}" for s in proof.sites)
    return "; ".join(f"{r} x{n}" for r, n in rows.items()) or "no sites"


def unfenced_decode(decode_fn):
    """A decode step whose page index skips the fence: the K/V append
    writes the page map's entry with no kv and no page partition."""
    def step(arena, pool, params, meta, toks, guard):
        return decode_fn(arena, pool, params, meta, toks,
                         dataclasses.replace(guard, kv=None, page=None))
    return step


def proof_phase(torch, cfg, smi: str, params=None, reference=None):
    """Phase 6 for one path: the steps of an engine registered with the
    extent-mode proof obligation (``register_verified_steps``, before the
    engine) serve phase 4's trace compiled.  Each step signature is proven
    at its first dispatch, on fake tensors of the card: no launch and no
    allocation during the proof, its site table equal to
    ``sandbox_report``'s; tokens, drain cycles, prefill and decode counts,
    launches and graphs equal a ``verify=False`` run (``reference``, else
    one made here on a fresh engine with the same weights); and a decode
    step whose page index skips the fence raises before any capture."""
    from repro_torch.core.verifier import GuardianStaticViolation
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import ServeEngine, make_shared_manager, \
        register_verified_steps
    from repro_torch.models import get_model

    if params is None:
        params = get_model(cfg).init(
            torch.Generator(device="cuda").manual_seed(0), "cuda")
    trace = path_trace(torch, cfg)

    def engine(verified: bool):
        mgr = make_shared_manager(1, max_batch=8, max_len=256, paged=True)
        bundle = register_verified_steps(mgr, cfg, max_batch=8,
                                         max_len=256) if verified else None
        eng = ServeEngine(cfg, max_batch=8, max_len=256, manager=mgr,
                          paged=True, params=params)
        for t in range(3):
            eng.register_tenant(f"tenant{t}", 16)
        return mgr, eng, bundle

    if reference is None:
        _, eng0, _ = engine(False)
        reference = serve_run(torch, cfg, eng0, trace, compiled=True)
        del eng0
        gc.collect()
    mgr, eng, bundle = engine(True)
    names = (eng._steps.prefill_name, eng._steps.decode_name)
    if names != (bundle.prefill_name, bundle.decode_name) or not all(
            mgr.pointer_to_symbol[n].verify for n in names):
        raise AssertionError("the engine's steps are not the verified ones")
    with ProofWatch(torch, mgr) as watch:
        run = serve_run(torch, cfg, eng, trace, compiled=True)
    for key in ("tokens", "cycles", "prefills", "decodes", "launches",
                "graphs"):
        if run[key] != reference[key]:
            raise AssertionError(f"[{cfg.name}] verify=True {key} differ "
                                 f"from verify=False: {run[key]} vs "
                                 f"{reference[key]}")
    if {r["name"] for r in watch.records} != set(names):
        raise AssertionError(f"[{cfg.name}] steps proven: "
                             f"{[r['name'] for r in watch.records]}")
    for r in watch.records:
        proof = r["proof"]
        report = mgr.sandbox_report(r["name"], r["args"])
        if not proof.fully_proven or report.summary() != proof.summary() \
                or report.format_table() != proof.format_table():
            raise AssertionError(f"[{cfg.name}] {r['name']}: proof "
                                 f"{proof.summary()} vs sandbox_report "
                                 f"{report.summary()}")
        if r["launches"][0] != r["launches"][1] \
                or r["memory"][0] != r["memory"][1]:
            raise AssertionError(f"[{cfg.name}] the proof of {r['name']} "
                                 f"launched {r['launches']} or allocated "
                                 f"{r['memory']}")
        kind = "decode" if r["name"] == names[1] else \
            f"prefill of {r['args'][2]['tokens'].shape[1]} tokens"
        log(f"proof [{cfg.name}, {cfg.n_layers} layers, {kind}]: "
            f"{r['seconds']:.2f} s, {len(proof.sites)} sites, "
            f"{proof.n_proven} proven, {proof.n_fenced} fenced, "
            f"{proof.n_refuted} refuted ({proof.n_eqns} graph nodes); "
            f"kernel launches {r['launches'][0]} -> {r['launches'][1]}, "
            f"memory_allocated {r['memory'][0]} -> {r['memory'][1]} bytes; "
            f"sites: {site_summary(proof)}")
    log(f"proven serve [{cfg.name}]: tokens, {run['cycles']} drain "
        f"cycles, {run['prefills']} prefills, {run['decodes']} decode steps,"
        f" launches {run['launches']} and {run['graphs']} graphs equal to "
        f"the verify=False run; proofs {sum(r['seconds'] for r in watch.records):.2f} s"
        f" in all; {smi}")
    # the negative control, on the same manager and the decode's operands
    name = "serve.decode.unfenced"
    mgr.register_trusted_kernel(name, unfenced_decode(bundle.decode_fn),
                                resident_argnums=(1,),
                                pool_arena=bundle.pool_name, verify=True)
    args = next(r["args"] for r in watch.records if r["name"] == names[1])
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _build.KERNELS.values()}
    mem, graphs = torch.cuda.memory_allocated(), \
        mgr.jit_cache_stats()["graphs"]
    eng._client.launch_kernel(name, args=args)
    try:
        mgr.run_queued()
    except GuardianStaticViolation as e:
        refused = str(e).splitlines()[0].rstrip(":")
    else:
        raise AssertionError(f"[{cfg.name}] the unfenced decode ran")
    torch.cuda.synchronize()
    if ({k.name: k.launches for k in _build.KERNELS.values()} != launches
            or mgr.pointer_to_symbol[name].jit_cache
            or mgr.jit_cache_stats()["graphs"] != graphs
            or torch.cuda.memory_allocated() != mem):
        raise AssertionError(f"[{cfg.name}] the refused step launched, "
                             "allocated or captured")
    log(f"unfenced decode [{cfg.name}]: refused at its first dispatch "
        f"before any capture, nothing launched or allocated: {refused}")
    del eng, mgr
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# Phase 5: tenant kernels — the sandboxed launch plane                  #
# --------------------------------------------------------------------- #

#: a shared GPU of four tenants: a 1 GiB f32 arena, 2**26 slots each
TENANT_SIZES = dict(arena=1 << 28, tenants=4, gemm=1024, n=1 << 24,
                    fft=1 << 16, nnz=1 << 22, rows=1 << 16, evil=1 << 20)
TENANT_POLICIES = ("none", "bitwise", "modulo", "check")
TOL_F32 = 1e-5


def tenant_inputs(sz, seed: int = 1234):
    """Each tenant's library operands, seeded, as host arrays (uniform in
    [0, 1) so every reduction sums positive terms; SpMV columns in
    range)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    g, n = sz["gemm"], sz["n"]
    out = []
    for _ in range(sz["tenants"]):
        out.append({
            "a": rng.random(g * g, np.float32),
            "b": rng.random(g * g, np.float32),
            "x": rng.random(n, np.float32),
            "y": rng.random(n, np.float32),
            "fx": rng.random(2 * sz["fft"], np.float32) - 0.5,
            "vals": rng.random(sz["nnz"], np.float32),
            "cols": rng.integers(0, sz["rows"], sz["nnz"]).astype(
                np.float32),
            "sx": rng.random(sz["rows"], np.float32),
        })
    return out


def evil(arena, target, n: int):
    """A tenant kernel that stores at an address of its choosing."""
    import torch
    idx = target + torch.arange(n, dtype=torch.int32, device=arena.device)
    arena[idx] = 999.0
    return arena, None


def probe(arena, ptr, n: int):
    """Loads and stores at ``ptr`` (past the arena in the NONE check)."""
    import torch
    idx = ptr + torch.arange(n, dtype=torch.int32, device=arena.device)
    vals = torch.take(arena, idx.long())
    arena[idx] = 7.0
    return arena, vals


class TenantPlane:
    """One manager of the tenant phase: a policy, its tenants (one for
    NONE — the standalone fast path — else four), every library kernel
    registered, each tenant's operands uploaded through validated
    ``memcpy_h2d``."""

    def __init__(self, torch, policy: str, device: str, sz, inputs):
        from repro_torch.core import FencePolicy, GuardianManager, \
            ThresholdPolicy
        from repro_torch.core.libsim import register_all_libraries
        self.torch, self.policy, self.sz = torch, policy, sz
        self.mgr = GuardianManager(
            total_slots=sz["arena"], policy=(
                FencePolicy.BITWISE if policy == "none"
                else FencePolicy(policy)), device=device,
            quarantine_policy=ThresholdPolicy(quarantine_after=sz["evil"]))
        register_all_libraries(self.mgr)
        n_t = 1 if policy == "none" else sz["tenants"]
        part = sz["arena"] // sz["tenants"]
        self.clients, self.ptrs = [], []
        for t in range(n_t):
            c = self.mgr.register_tenant(f"t{t}", part)
            c.module_load("evil", evil)
            c.module_load("probe", probe)
            ptr = {k: c.malloc(v.size) for k, v in inputs[t].items()}
            for k, v in inputs[t].items():
                c.memcpy_h2d(ptr[k], v)
            g = sz["gemm"]
            ptr["c"], ptr["out"] = c.malloc(g * g), c.malloc(1)
            ptr["fo"], ptr["sy"] = c.malloc(2 * sz["fft"]), c.malloc(
                sz["rows"])
            self.clients.append(c)
            self.ptrs.append(ptr)
        self.mgr.synchronize()

    def ops(self):
        torch, sz = self.torch, self.sz
        g, n = sz["gemm"], sz["n"]
        alpha = torch.tensor(2.0, device=self.mgr.device)
        beta = torch.tensor(0.5, device=self.mgr.device)
        return [
            ("gemm", "grdblas.gemm", ("a", "b", "c"), (g, g, g)),
            ("dot", "grdblas.dot", ("x", "y", "out"), (n,)),
            ("axpby", "grdblas.axpby", ("x", "y"), (alpha, beta, n)),
            ("isamax", "grdblas.isamax", ("x",), (n,)),
            ("fft", "grdfft.c2c", ("fx", "fo"), (sz["fft"],)),
            ("spmv", "grdsparse.csr_spmv", ("vals", "cols", "sx", "sy"),
             (sz["nnz"], sz["rows"])),
        ]

    def launch(self, op, tenants):
        """One launch of ``op`` by each of ``tenants``, then a drain;
        returns the request handles."""
        _, name, ptr_keys, args = op
        reqs = [self.clients[t].launch_kernel(
            name, ptrs=[self.ptrs[t][k] for k in ptr_keys], args=args)
            for t in tenants]
        self.mgr.run_queued()
        return reqs

    def read(self, t, key, n=None):
        p = self.ptrs[t][key]
        return self.mgr.arena.unsafe_read_range(
            p.addr, p.length if n is None else n)

    def partition(self, t):
        part = self.mgr.bounds.lookup(f"t{t}")
        return self.mgr.arena.buf[part.base:part.end]


class Unfenced:
    """The library kernels as written, called on the arena with no
    sandbox — no fence, no guard, no drain: the unfenced baseline that a
    policy's overhead is read against (its inputs are in range)."""

    def __init__(self, plane):
        self.plane = plane

    def launch(self, op, tenants):
        _, name, ptr_keys, args = op
        mgr = self.plane.mgr
        fn = mgr.pointer_to_symbol[name].fn
        for t in tenants:
            ptrs = [self.plane.ptrs[t][k].addr_on(mgr.device)
                    for k in ptr_keys]
            mgr.arena.buf, _ = fn(mgr.arena.buf, *ptrs, *args)


class CapturedUnfenced:
    """:class:`Unfenced`'s calls captured by this script into one CUDA
    graph per (op, tenants), replayed from the second call on — the
    compiled unfenced baseline the compiled policies are read against.
    The first call runs them eagerly on a side stream (cuBLAS and cuFFT
    set up there), then captures.  The graphs share one memory pool
    (their replays run one after the other, and nothing they compute is
    read); the pointers are constants of a graph, as these tenants never
    move."""

    def __init__(self, torch, plane):
        self.torch, self.eager = torch, Unfenced(plane)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = {}

    def launch(self, op, tenants):
        torch = self.torch
        key = (op[0], tuple(tenants))
        graph = self.graphs.get(key)
        if graph is not None:
            graph.replay()
            return
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.eager.launch(op, tenants)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            self.eager.launch(op, tenants)
        self.graphs[key] = graph


def _tenant_results(plane, reqs_by_op):
    """What the phase compares between the card and the CPU."""
    out = {}
    for t in range(len(plane.clients)):
        out[f"c{t}"] = plane.read(t, "c")
        out[f"out{t}"] = plane.read(t, "out")
        out[f"y{t}"] = plane.read(t, "y")
        out[f"fo{t}"] = plane.read(t, "fo")
        out[f"sy{t}"] = plane.read(t, "sy")
    for name, reqs in reqs_by_op.items():
        for i, r in enumerate(reqs):
            if r.result is not None:
                out[f"{name}.result{i}"] = r.result
    return out


def _compare(torch, card, cpu, label) -> float:
    """Worst normwise error of the float reductions (max |card - cpu| /
    max |cpu|); stored elementwise bytes (axpby's y) and integer results
    must be equal exactly."""
    worst = 0.0
    for k, want in cpu.items():
        got = card[k].detach().cpu()
        want = want.detach().cpu()
        if k.startswith("y") or not want.is_floating_point():
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: {k} differs from the CPU")
            continue
        scale = max(float(want.abs().max()), 1e-30)
        err = float((got - want).abs().max()) / scale
        if not err <= TOL_F32:
            raise AssertionError(f"{label}: {k} normwise error {err:.3g} > "
                                 f"{TOL_F32}")
        worst = max(worst, err)
    return worst


def _tenant_round(plane, tenants):
    return {op[0]: plane.launch(op, tenants) for op in plane.ops()}


def _time_op(torch, plane, op, tenants, reps: int = 3):
    """(device ms, wall ms, MB allocated, MB of peak above the start) of
    one launch round: CUDA events around the launches and the drain, the
    stream held busy first so the host has enqueued the work before the
    start event fires; the wall time is a host clock around the same
    round ending in a synchronize, without the hold."""
    dev, wall = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plane.launch(op, tenants)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        plane.launch(op, tenants)
        b.record()
        torch.cuda.synchronize()
        dev.append(a.elapsed_time(b))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()["allocated_bytes.all.allocated"]
    plane.launch(op, tenants)
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_stats()["allocated_bytes.all.allocated"] \
        - before
    peak = torch.cuda.max_memory_allocated() - base
    busy, n_ops = _busy_ms(torch, plane, op, tenants)
    return dict(dev=statistics.median(dev), wall=statistics.median(wall),
                alloc=alloc / 2**20, peak=peak / 2**20, busy=busy,
                ops=n_ops, rounds=2 * reps + 5)


def _busy_ms(torch, plane, op, tenants, rounds: int = 3):
    """(kernel time, device operations) of one launch round, summed by
    ``torch.profiler`` over ``rounds`` rounds in one session and divided
    by them, after a session that is thrown away (a session can start
    recording late); ``(nan, 0)`` when it records no device time."""
    from torch.profiler import ProfilerActivity, profile
    for n in (1, rounds):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                plane.launch(op, tenants)
            torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) for e in kern)
    if not us:
        return float("nan"), 0
    return us / 1e3 / rounds, sum(e.count for e in kern) / rounds


def tenant_plane(torch, sz=None, device: str = "cuda", smi: str = ""):
    """Phase 5: the tenant-kernel plane on the card at a shared GPU's size
    — a 1 GiB arena, four tenants of 2**26 slots, the simulated libraries
    at working sets of 2**22 slots and more — under NONE, BITWISE, MODULO
    and CHECK, solo and four-wide fused, every launch a replay of one CUDA
    graph per key (the CPU side runs the same compiled path).  Each
    policy's results on the card equal the port's on the CPU for the same
    seeded inputs; the graph count equals the number of keys; a
    forged-pointer kernel, replayed, leaves the other partitions
    byte-identical; under CHECK the rogue's rows roll back, are counted by
    kind and it is quarantined; a NONE launch past the arena leaves the
    context usable; on a small arena a fused key replays across an elastic
    move (fenced at the new row) and a change of tenant set (one graph),
    and a NONE graph never outlives a second tenant's arrival.  Prints the
    device and wall time, the device operations, the bytes allocated and
    the rollback bytes of each launch round, each plane's graphs, capture
    seconds and pool bytes, and the ladders over the unfenced kernels
    captured into graphs, over them called eagerly, and over NONE."""
    sz = dict(TENANT_SIZES if sz is None else sz)
    t_start = time.perf_counter()
    inputs = tenant_inputs(sz)
    arena_mb = sz["arena"] * 4 / 2**20
    log(f"tenant plane: {arena_mb:.0f} MB arena, {sz['tenants']} tenants "
        f"x {sz['arena'] // sz['tenants']} slots; gemm {sz['gemm']}^3, "
        f"dot/axpby/isamax n = {sz['n']}, fft n = {sz['fft']}, spmv nnz "
        f"= {sz['nnz']} over {sz['rows']} rows ({smi})")
    ladder = {}
    pool_total = 0
    for policy in TENANT_POLICIES:
        card = TenantPlane(torch, policy, device, sz, inputs)
        cpu = TenantPlane(torch, policy, "cpu", sz, inputs)
        everyone = list(range(len(card.clients)))
        rounds = (("solo", [0]), ("x4", everyone if policy != "none"
                                  else [0, 0, 0, 0]))
        worst = 0.0
        # each round twice: the first call of a key captures its graph,
        # the second replays it, and both must equal the CPU's
        for label, tenants in rounds + rounds:
            reqs_card = _tenant_round(card, tenants)
            reqs_cpu = _tenant_round(cpu, tenants)
            worst = max(worst, _compare(
                torch, _tenant_results(card, reqs_card),
                _tenant_results(cpu, reqs_cpu), f"{policy} {label}"))
        st = card.mgr.scheduler.stats
        if policy != "none" and st.fused_steps != 2 * len(card.ops()):
            raise AssertionError(f"{policy}: {st.fused_steps} fused steps, "
                                 f"want {2 * len(card.ops())}")
        log(f"  [{policy}] card = CPU, compiled, each round captured then "
            f"replayed: float reductions within {worst:.3g} normwise "
            f"(tolerance {TOL_F32}), axpby bytes and isamax ids exact; "
            f"drain steps fused {st.fused_steps}, single {st.single_steps}, "
            f"check {st.check_steps}, proven {st.proven_steps}")
        if device == "cuda" and policy == "none":
            for base in ("unfenced", "captured"):
                plane = Unfenced(card) if base == "unfenced" \
                    else CapturedUnfenced(torch, card)
                for label, tenants in rounds:
                    for op in card.ops():
                        t = _time_op(torch, plane, op, tenants)
                        ladder[(base, label, op[0])] = t
                        log(f"  [{base}] {op[0]:6s} {label:4s}: device "
                            f"{t['dev']:.4f} ms, wall {t['wall']:.4f} ms, "
                            f"kernels {t['busy']:.4f} ms in {t['ops']:g} "
                            f"device ops a round; allocated "
                            f"{t['alloc']:.1f} MB, peak +{t['peak']:.1f} MB")
                del plane
        if device == "cuda":
            for label, tenants in rounds:
                for op in card.ops():
                    fused0 = st.fused_steps
                    rb0 = st.rollback_bytes
                    t = _time_op(torch, card, op, tenants)
                    rb = (st.rollback_bytes - rb0) / t["rounds"] / 2**20
                    fused = (st.fused_steps - fused0) / t["rounds"]
                    ladder[(policy, label, op[0])] = t
                    log(f"  [{policy}] {op[0]:6s} {label:4s}: device "
                        f"{t['dev']:.4f} ms, wall {t['wall']:.4f} ms, "
                        f"kernels {t['busy']:.4f} ms in {t['ops']:g} device "
                        f"ops a round; allocated {t['alloc']:.1f} MB, peak "
                        f"+{t['peak']:.1f} MB (arena {arena_mb:.0f} MB); "
                        f"rollback log {rb:.2f} MB; fused steps {fused:g} "
                        "a round")
        _tenant_isolation(torch, card, cpu, policy, sz)
        pool_total += _tenant_graphs(card, policy, len(card.ops()))
        card_ops = card.ops()
        del card, cpu
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    if pool_total >= 4 * 2**30:
        raise AssertionError(f"the tenant graphs' pools total "
                             f"{pool_total / 2**30:.2f} GiB, over 4 GiB")
    log(f"  tenant graphs' pools of the four planes together: "
        f"{pool_total / 2**20:.1f} MB (limit 4096 MB)")
    for policy in TENANT_POLICIES[1:]:
        _replay_isolation(torch, policy, device)
    _stale_native(torch, device)
    if ladder:
        _tenant_ladders(ladder, [op[0] for op in card_ops], smi)
    log(f"tenant plane: ok in {time.perf_counter() - t_start:.1f} s")


def _tenant_graphs(plane, policy, n_ops) -> int:
    """Checks that the plane holds one graph per key and prints its
    graphs, captures, capture seconds and pool bytes; returns the pool
    bytes.  The keys: one per op and round width (NONE never fuses, so
    its four-wide round replays the solo key), and the isolation check's
    two (its solo and four-wide forged-pointer launches; under NONE the
    probe)."""
    st = plane.mgr.jit_cache_stats()
    keys = n_ops * (1 if policy == "none" else 2) + (
        1 if policy == "none" else 2)
    if st["graphs"] != keys or st["graph_evictions"]:
        raise AssertionError(f"{policy}: {st['graphs']} graphs "
                             f"({st['graph_evictions']} evicted) for "
                             f"{keys} keys")
    log(f"  [{policy}] graphs: {st['graphs']} for {keys} keys, "
        f"{st['graphs'] + st['graph_evictions']} captures in "
        f"{st['graph_capture_s']:.3f} s, pool "
        f"{st['graph_pool_bytes'] / 2**20:.1f} MB (one pool for the plane)")
    return st["graph_pool_bytes"]


def _tenant_ladders(ladder, ops, smi) -> None:
    """Each policy's time over the unfenced kernels captured into graphs
    (the compiled baseline: device, kernel and wall time), with the eager
    unfenced row beside it; then over the eager unfenced kernels and over
    NONE (device and kernel time)."""
    # over the unfenced kernels: the fence's overhead; over NONE: what a
    # policy costs beyond jnp's out-of-range semantics, which NONE keeps
    # and an unfenced kernel does not
    blocks = [("captured", k) for k in ("dev", "busy", "wall")] + [
        (over, k) for over in ("unfenced", "none") for k in ("dev", "busy")]
    what = {"dev": "device time", "busy": "kernel time", "wall": "wall"}
    log("  ladders: captured = the unfenced kernels captured by this script "
        "into one CUDA graph per round, unfenced = the same calls eager, "
        "each policy = the port's compiled launches")
    for over, key in blocks:
        log(f"  ladder ({what[key]} / {over}'s; x4 of {over} = four "
            f"unfused calls; {smi}):")
        rows = (("unfenced",) if over == "captured" else ()) \
            + TENANT_POLICIES
        for row in (r for r in rows if r != over):
            parts = []
            for lb in ("solo", "x4"):
                for op in ops:
                    r = ladder[(row, lb, op)][key] / ladder[(over, lb, op)][key]
                    parts.append(f"{op} {r:.2f}x ({lb})")
            log(f"    {row:8s} " + ", ".join(parts))


#: the elastic scenarios' small arena: 16 tenant extents of 2**12 slots
REPLAY_SIZES = dict(arena=1 << 16, part=1 << 12, n=64)


def _replay_scenario(torch, policy: str, device: str):
    """A fused key replayed across an elastic move and a change of tenant
    set: t0..t3 store at their own buffers (the capture, then a replay);
    the elastic plane relocates t3, and t4 registers into t3's old
    extent; the four replay the key with t3's pointer forged at t4's
    buffer; then t0, t1, t2 and t4 — another set of four, the same
    signature — replay it.  Returns the arena, the partitions and the
    facts the checks read."""
    import numpy as np
    from repro_torch.core import FencePolicy, GuardianManager, \
        ThresholdPolicy
    from repro_torch.core.stepgraph import StepGraph
    sz = REPLAY_SIZES
    n = sz["n"]
    mgr = GuardianManager(
        total_slots=sz["arena"], policy=FencePolicy(policy), device=device,
        quarantine_policy=ThresholdPolicy(quarantine_after=1 << 30))
    clients, bufs = {}, {}

    def join(t, pad=0):
        clients[t] = mgr.register_tenant(t, sz["part"])
        clients[t].module_load("evil", evil)
        if pad:     # t3's buffer sits past the offset its forgery wraps to
            clients[t].malloc(pad)
        bufs[t] = clients[t].malloc(n)
        clients[t].memcpy_h2d(bufs[t], np.full(n, 5.0, np.float32))

    def replay(who, forged=None):
        for t in who:
            if t == "t3" and forged is not None:
                clients[t].launch_kernel("evil", args=(
                    torch.tensor(forged, dtype=torch.int32), n))
            else:
                clients[t].launch_kernel("evil", ptrs=[bufs[t]], args=(n,))
        mgr.run_queued()

    for t in ("t0", "t1", "t2", "t3"):
        join(t, pad=2 * n if t == "t3" else 0)
    four = ["t0", "t1", "t2", "t3"]
    replay(four)
    replay(four)
    old = mgr.bounds.lookup("t3")
    new = mgr.elastic.relocate("t3", sz["part"])
    join("t4")
    replay(four, forged=bufs["t4"].addr)
    replay(["t0", "t1", "t2", "t4"])
    mgr.synchronize()
    graphs = [g for g in mgr.scheduler._fused_cache.values()
              if isinstance(g, StepGraph)]
    parts = {t: mgr.bounds.lookup(t) for t in clients}
    return dict(
        arena=mgr.arena.buf.cpu(), parts=parts, old=old, new=new,
        t4_buf=bufs["t4"].addr, t3_buf=bufs["t3"].addr - old.base,
        graphs=len(graphs),
        all_graphs=mgr.jit_cache_stats()["graphs"],
        replays=[g.replays for g in graphs],
        log=mgr.violog.counts("t3"),
        state=mgr.quarantine.state_of("t3").name)


def _replay_isolation(torch, policy: str, device: str) -> None:
    """:func:`_replay_scenario` on the card and on the CPU: every byte of
    the arena equal, t4's extent (t3's old one) holding exactly its own
    bytes, t3's forged stores fenced at its new row (wrapped there, or
    under CHECK rolled back and counted), one graph replayed three
    times."""
    sz = REPLAY_SIZES
    card = _replay_scenario(torch, policy, device)
    cpu = _replay_scenario(torch, policy, "cpu")
    where = f"[{policy}] elastic move between replays"
    if not torch.equal(card["arena"], cpu["arena"]):
        raise AssertionError(f"{where}: the card's arena differs from the "
                             "CPU's")
    arena, parts, n = card["arena"], card["parts"], sz["n"]
    if parts["t4"].base != card["old"].base:
        raise AssertionError(f"{where}: t4 did not land in t3's old extent")
    off = card["t4_buf"] - parts["t4"].base
    t4 = arena[parts["t4"].base:parts["t4"].end]
    want = torch.zeros_like(t4)
    want[off:off + n] = 999.0           # its own stores of the last replay
    if not torch.equal(t4, want):
        raise AssertionError(f"{where}: t4's extent (t3's old one) was "
                             "written by t3 — a replay fenced at the old row")
    # t3's new extent: its own buffer, moved with it, holds its stores of
    # the first two replays; its forged stores wrapped to the offset of
    # t4's buffer in the row (BITWISE, MODULO) or were rolled back (CHECK)
    want = torch.zeros_like(t4)
    want[card["t3_buf"]:card["t3_buf"] + n] = 999.0
    if policy != "check":
        want[off:off + n] = 999.0
    if not torch.equal(arena[card["new"].base:card["new"].end], want):
        raise AssertionError(f"{where}: t3's new extent is not its own "
                             "stores plus its forgery fenced at the new row")
    if policy == "check":
        if card["log"]["scatter"] != n:
            raise AssertionError(f"{where}: the forged stores were not "
                                 f"counted ({card['log']})")
        detail = f"rolled back, {n} counted, {card['state']}"
    else:
        detail = "wrapped into its new extent"
    if not (card["graphs"] == card["all_graphs"] == 1
            and card["replays"] == [3]):
        raise AssertionError(f"{where}: {card['graphs']} fused graphs "
                             f"replayed {card['replays']} times, want one "
                             "replayed 3 times")
    log(f"  {where}: card = CPU byte for byte; t3 moved "
        f"[{card['old'].base}, {card['old'].end}) -> [{card['new'].base}, "
        f"{card['new'].end}), t4 registered into the old extent; the "
        f"replay's forged stores of t3 at t4's buffer were {detail}, t4's "
        "extent holds only its own bytes; the sets {t0..t3} and {t0, t1, "
        "t2, t4} replayed one graph (1 graph, captured once, replayed 3 "
        "times)")


def _stale_native(torch, device: str) -> None:
    """A NONE (unfenced) graph captured and replayed by a standalone
    tenant, then a second tenant joins: the next launch, forged at the
    newcomer's buffer, runs fenced — no NONE graph survives the join —
    on the card and on the CPU, byte for byte."""
    import numpy as np
    from repro_torch.core import GuardianManager
    from repro_torch.core.stepgraph import StepGraph
    sz = REPLAY_SIZES
    n = sz["n"]
    out = []
    for dev in (device, "cpu"):
        mgr = GuardianManager(total_slots=sz["arena"], device=dev)
        solo = mgr.register_tenant("solo", sz["part"])
        solo.module_load("evil", evil)
        p = solo.malloc(n)
        for _ in range(2):
            solo.launch_kernel("evil", ptrs=[p], args=(n,))
            mgr.run_queued()
        cache = mgr.pointer_to_symbol["evil"].jit_cache
        native = [g.replays for k, g in cache.items()
                  if k[0] == "native" and isinstance(g, StepGraph)]
        late = mgr.register_tenant("late", sz["part"])
        q = late.malloc(n)
        late.memcpy_h2d(q, np.full(n, 5.0, np.float32))
        solo.launch_kernel("evil", args=(
            torch.tensor(q.addr, dtype=torch.int32), n))
        mgr.synchronize()
        modes = sorted({k[0] for k, g in cache.items()
                        if isinstance(g, StepGraph)})
        out.append((native, modes, mgr.arena.buf.cpu(),
                    mgr.bounds.lookup("late")))
    (native, modes, arena, part), cpu = out[0], out[1]
    where = "[none] a NONE graph, then a second tenant"
    if native != [1] or modes != ["bitwise"] or cpu[0] != native \
            or cpu[1] != modes:
        raise AssertionError(f"{where}: NONE graphs {native}, graphs after "
                             f"the join {modes} (CPU: {cpu[:2]})")
    want = torch.zeros(part.size)
    want[q.addr - part.base:q.addr - part.base + n] = 5.0
    if not (torch.equal(arena, cpu[2])
            and torch.equal(arena[part.base:part.end], want)):
        raise AssertionError(f"{where}: the newcomer's extent changed, or "
                             "card != CPU")
    log(f"  {where}: the NONE graph (captured, replayed once) was purged at "
        "the join; the forged launch ran as a BITWISE graph, the "
        "newcomer's extent byte-identical; card = CPU byte for byte")


def _tenant_isolation(torch, card, cpu, policy, sz):
    """The forged-pointer attack (BITWISE, MODULO, CHECK) or the NONE
    probe past the arena, on the card and on the CPU."""
    if policy == "none":
        past = torch.tensor(sz["arena"] + 5, dtype=torch.int32)
        outs = []
        for plane in (card, cpu):
            snap = plane.mgr.arena.buf.clone()
            for _ in range(2):              # the capture, then a replay
                r = plane.launch(("probe", "probe", (), (past, 4096)),
                                 [0])[0]
                plane.mgr.synchronize()
                # every store fell past the arena and was dropped: no
                # byte of the arena moved, slot 0 (where a dropped store
                # is redirected with the value already there) included
                if not torch.equal(plane.mgr.arena.buf, snap):
                    raise AssertionError(
                        f"NONE past the arena: the arena changed on the "
                        f"{plane.mgr.device}")
            outs.append(r.result.cpu())
            del snap
            # the context stays usable: another launch and a synchronize
            plane.launch(plane.ops()[1], [0])
            plane.mgr.synchronize()
        if not (torch.equal(outs[0].isnan(), outs[1].isnan())
                and outs[0].isnan().all()):
            raise AssertionError("NONE past the arena: card != CPU")
        log(f"  [none] a launch 5 slots past the {sz['arena']}-slot arena, "
            "captured then replayed, loads NaN and drops its stores, as the "
            "reference (the arena byte-identical before and after, on the "
            "card and the CPU); the next launch and synchronize run")
        return
    n_t = sz["tenants"]
    rogue = n_t - 1
    victim = card.ptrs[0]["x"].addr
    # first a four-wide fused round in which every tenant stores at its
    # own x buffer and the rogue at t0's, then the rogue alone; the
    # fused round stays under the quarantine threshold, the two together
    # reach it.  Each attack replays its key: a round of the same
    # signature in which the rogue too stores at its own buffer captures
    # it first
    rounds = (("x4", sz["evil"] // 2, list(range(n_t))),
              ("solo", sz["evil"], [rogue]))
    st = card.mgr.scheduler.stats

    def attack(plane, n, tenants, forged):
        for t in tenants:
            target = victim if forged and t == rogue \
                else plane.ptrs[t]["x"].addr
            plane.clients[t].launch_kernel(
                "evil", args=(torch.tensor(target, dtype=torch.int32), n))
        plane.mgr.run_queued()

    total = 0
    for label, n, tenants in rounds:
        for plane in (card, cpu):
            attack(plane, n, tenants, forged=False)
        snaps = {id(p): [p.partition(t).clone() for t in range(n_t)]
                 for p in (card, cpu)}
        fused0 = st.fused_steps
        for plane in (card, cpu):
            attack(plane, n, tenants, forged=True)
        card.mgr.synchronize()
        total += n
        if len(tenants) > 1 and not (st.fused_steps == fused0 + 1
                                     and st.batch_widths[-1] == n_t):
            raise AssertionError(f"{policy} {label}: the attack did not "
                                 f"run as one {n_t}-wide fused step")
        # every partition, on the card and on the CPU, is what it held
        # before plus exactly the stores its own rows may make (the
        # timing rounds ran on the card alone, so the two planes' bytes
        # differ; what the attack changed may not)
        for plane in (card, cpu):
            where = f"{policy} {label} ({plane.mgr.device})"
            for t in range(n_t):
                want = snaps[id(plane)][t].clone()
                if t == rogue and policy != "check":
                    # both fences wrap an address into the row by its
                    # offset modulo the row's size
                    at = victim % want.numel()
                    want[at:at + n] = 999.0
                elif t != rogue and t in tenants:   # its own, legit stores
                    at = plane.ptrs[t]["x"].addr \
                        - plane.mgr.bounds.lookup(f"t{t}").base
                    want[at:at + n] = 999.0
                if not torch.equal(plane.partition(t), want):
                    raise AssertionError(
                        f"{where}: tenant t{t}'s partition is not what "
                        "its own stores leave" + (
                            " (the forged stores landed elsewhere than "
                            "wrapped, or were not rolled back)"
                            if t == rogue else ""))
        counts = card.mgr.violog.counts(f"t{rogue}")
        if counts != cpu.mgr.violog.counts(f"t{rogue}"):
            raise AssertionError(f"{policy} {label}: ViolationLog rows "
                                 "differ")
        state = card.mgr.quarantine.state_of(f"t{rogue}")
        if policy == "check":
            want_state = "QUARANTINED" if total >= sz["evil"] else "ACTIVE"
            if not (counts["scatter"] == total
                    and state.name == want_state
                    and cpu.mgr.quarantine.state_of(f"t{rogue}") is state):
                raise AssertionError(
                    f"check {label}: rogue not counted / {want_state} "
                    f"({counts}, {state})")
            detail = (f"its {n} stores rolled back, {total} counted "
                      f"({counts}), {state.name}")
        else:
            detail = f"its {n} stores wrapped into its own partition"
        others = ("the other three tenants' own stores landed, nothing "
                  "else of their partitions moved" if len(tenants) > 1
                  else "the other three partitions byte-identical")
        log(f"  [{policy}] forged pointer of t{rogue} at t0's buffer, "
            f"{label}, a replay, on the card and the CPU: {others}; "
            f"{detail}")


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
    if len(sys.argv) == 2 and sys.argv[1] == "--tenants":
        # a development switch: phase 5 alone, after the build, to iterate
        # on the tenant plane without paying for the serve paths
        tenant_plane(torch, smi=smi)
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--proofs":
        # a development switch: the op checks and phase 6 alone (each with
        # its own verify=False run), after the build
        for cfg in (get_config(name) for name in PATHS):
            check_ops(torch, cfg)
            proof_phase(torch, cfg if cfg.moe is None else
                        dataclasses.replace(cfg, n_layers=2), smi)
        return 0

    cfgs = [get_config(name) for name in PATHS]
    floor = launch_floor_ms(torch)
    log(f"launch floor: {floor:.5f} ms (one-element fill_, the smallest "
        "device operation a call can be, timed as the kernels are)")
    rows = []
    for cfg in cfgs:
        rows += check_kernels(torch, cfg)
        check_ops(torch, cfg)
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
        check_compiled(torch, cfg)
        gc.collect()
        torch.cuda.empty_cache()
    check_uncapturable(torch)
    tenant_plane(torch, smi=smi)
    paths = {}
    for cfg in cfgs:
        # each path's engine, manager and pool are freed before the next
        # is built (qwen3-moe's 61 GB of weights need the room)
        paths[cfg.name] = run_main_path(torch, cfg, smi)
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
