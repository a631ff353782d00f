#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card and the CUDA toolkit
(``nvcc``), and imports nothing of JAX or of the JAX package.  Four serve
paths run, each at full width: the dense stablelm-3b, the MoE
qwen3-moe-30b-a3b and, in phase 8, the hybrid zamba2-7b and the xLSTM
xlstm-350m; phase 9 trains minicpm-2b, phase 10 runs the vision
qwen2-vl-2b and the encoder-decoder seamless-m4t-medium through the
model API, phase 11 trains the recurrent families and the MoE
variants and decodes stablelm-3b over a float8 pool, and phase 12 runs
the reference's step bundles (``build_prefill_step`` /
``build_decode_step``) at stablelm-3b's full width over the reference's
32k shapes, and phase 13 holds the dry run (``repro_torch.launch.dryrun``)
against the card.  Phases, in order (any failure exits non-zero):

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
   timed the same way) and, for K1, K2, K4 and K5, the device operations
   a call puts on the card, counted by ``torch.profiler`` (one each); then
   each kernel called through its custom op ``repro_torch::<kernel>`` on
   CUDA tensors and on CPU copies: one launch and no plain call on the
   card, one plain call and no launch on the CPU, the two equal (K2, K3,
   K5 exactly, K1 and K4 in float32 within 1e-4);
3. full width against the CPU at two layers, for each path: float32,
   prefill + 4 decode steps on the card through the kernels and on the CPU
   through the plain versions, from the same weights — greedy ids equal,
   logits within a stated tolerance (the MoE path also prints the smallest
   top-k routing margin it met, so a routing tie can be told from a fault)
   — over the global paged pool and, from the same weights, over the slab
   pool (``api.init_cache``: 8 rows, 16 slots, a forged slot id, the
   ``permute`` prefill write, K1 over the flattened layer view, each
   layer's K1 call held against its plain version);
   then, at the same size on the card, the compiled steps (one CUDA graph
   per step key, ``core/stepgraph.py``) against eager: a prefill's and a
   decode's logits bit-identical on the first call and on a replay, equal
   served tokens, a page table forged with a co-tenant's virtual ids
   leaving the co-tenant's pages byte-identical replay after replay, and
   decode graphs replayed after an elastic grow and after a co-tenant's
   eviction writing only the tenants' pages, every pool byte equal to
   eager; and (once) a step calling ``.item()`` refused at capture with
   its name; for stablelm-3b, sampled decode (temperature 0.7, top-k 50)
   on the paged path, card = CPU token for token from the same weights,
   after the draw itself: JAX's stream, a known-answer vector (the first
   16 uniforms of one key exact, its Gumbel values within 2 ulp of JAX's)
   and, at 8 rows x the vocab, the uniforms card = CPU bit for bit and the
   Gumbel noise within 2 ulp; then the control plane at the same size
   (``control plane [...]``): a latency-critical tenant behind a
   best-effort flood, a one-page tenant that stalls, a withdrawal, the
   violation log grown from 4 rows to 8 between two fused CHECK launches
   and a forged launch of a tenant in a new row replaying the second one's
   graph, its counts in its row and its class quarantining it mid-run —
   card = CPU in tokens, drain cycles, every span and the SLO ledger, the
   registry's logical snapshot, the elastic events and the violation
   counts;
4. each main path at full width and full depth (bf16 weights from a seeded
   generator, float32 page pool) through ``make_shared_manager(paged=True)``,
   ``ServeEngine(paged=True)`` and ``serve_continuous``, 3 tenants and 8
   staggered requests x 16 tokens, served twice on one engine: eager
   (``jit_trusted`` off, with the routing and logit-gap hooks), then
   compiled (the default) — equal tokens per request, drain cycles,
   prefill and decode counts and kernel launches, every request served
   with its token count, every kernel of the path launched as many times
   as the per-step count says (counts set to 0 just before each run and
   read just after), no plain version run, every request span closed and
   reconciled (its phases summing to its end-to-end cycles, none left
   open; the sampled runs below too).  Each run prints its
   decode-step time (CUDA events around the manager's dispatch) against
   the bytes floor, tokens/s and peak memory; the compiled run its graphs,
   capture seconds and graph-pool bytes.  stablelm-3b runs first and is
   freed before qwen3-moe-30b-a3b (61 GB of weights) is built; the MoE
   path also prints the (token, k) assignments capacity dropped; a
   compiled solo rerun under ``torch.profiler`` gives the device's busy
   share and each of the port's kernels' device time.  stablelm-3b's
   trace is then served sampled (temperature 0.7, top-k 50) on its
   weights, eager, compiled and compiled on a second engine of the same
   seed: equal tokens, every eager draw inside its row's top k, the decode
   step's time beside the greedy run's.

7. slab lockstep serving through the command line (inside phase 4, after
   stablelm-3b's phase 6, on its weights): ``repro_torch.launch.serve``'s
   ``main`` driven in-process at full width and depth four times —
   ``--tenants 3 --requests 6 --tokens 16`` compiled, the same with
   ``--no-jit``, ``--engines 2 --tenants 1 --requests 2`` and ``--policies
   modulo,check`` — each run's kernel counts set to 0 just before its
   serving call and read just after: K3, K4 and K1 launched as the steps
   count them, no plain version; compiled and eager equal in tokens,
   decode steps and launches; the two engines' lockstep fused into one
   device step, one graph for the decode.  Each run prints its decode-step
   time (one engine), tokens/s and graphs.  Then a request whose slot id
   is forged to a co-tenant's base leaves the co-tenant's slots
   byte-equal, and K1 over the slab view is checked and timed at the slab
   path's shapes (its row of the kernel table).  Last,
   ``repro_torch.examples.multi_tenant_serving`` at full width and depth
   on the same weights: solo = co-located generations, a forged slot
   leaving the victim's KV rows byte-identical.

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
   ones and over NONE's.  Then the structural tenant kernels
   (``structural_plane``): a ``while_loop`` list walk whose trip count is
   the arena's data, a ``scan`` over 16 chunks of 65,536 slots of axpy +
   dot and a ``cond`` storing in one branch, under every policy, solo and
   four-wide, captured then replayed on other lists and the other branch
   (a ``while`` and a ``cond`` are CUDA-graph conditional nodes), card =
   CPU; a forged pointer inside each body leaves the other partitions'
   bytes as they were, wraps into the forger's partition or, under
   CHECK, rolls back exactly; each kernel's device and wall time over its
   memory operations unrolled on the host and captured, and over NONE;
   and a ``cond`` nested in a ``while_loop`` under 16 keys of one
   manager (48 conditional nodes, more than torch's 32 streams), card =
   CPU after every launch — in a process of its own beside phase 12's
   (host work for the most part: each key's bodies traced).

   Phase 2 also holds the recurrent families' kernels, after the two
   main paths', with the same checks (``check_kernels`` picks the kernels
   a family's path runs): K3 at zamba2-7b's and xlstm-350m's tables, and
   at zamba2-7b's shapes (H = KH = 32, D = 112: K4's KSTEPS = 7
   instantiation, K1 at G = 1) K4 in bf16 and f32 at S = 57 and 193
   under the path's window (4,096, past S), windows inside S (32, 100)
   and ``causal=False``, and K1 on phase 2's K1 cases under the path's
   window, a window of 32 and none, each at every cluster size and one
   device operation a call — where K and V set to NaN before the rows'
   windows leave the output bit-equal (those positions are never read).
   The rows of forms on no path (K4 under window 32 and not causal, K1
   under window 32) report 0 launches.  Then the ops check at zamba2-7b's
   widths.

8. the recurrent families (after phase 4's paths are freed): (a) the
   reduced zamba2-7b and xlstm-350m, float32, card against CPU on the
   same weights through phase 3's slab run (8 rows, a forged slot id, each
   KV layer's K1 call held against its plain version) — a 38-token
   prefill past the reduced hybrid's 32-token window and 8 decode steps,
   so the windowed K4 and K1 run — logits within 1e-4, greedy ids equal,
   the launches counted; (b) the same at
   full width and reduced depth (zamba2-7b at 7 layers: a group of 6 and
   a 1-layer Mamba tail; xlstm-350m at 2), within 2e-3; (c) each at full
   width and depth (81 / 24 layers, bf16 weights from a seeded
   generator) through a slab ``ServeEngine`` (``max_batch`` 8,
   ``max_len`` 256, a 16-slot f32 pool, 3 tenants, six 12-64-token
   prompts, 16 new tokens) and ``serve_engines``, eager then compiled on
   two engines of one seed (a hybrid engine's decode positions carry
   across its waves, as the reference's do) — equal tokens, decode steps
   and launches, K3 / K4 / K1 launched as the steps count them, no plain
   version — printing decode-step times against the bytes floor (the
   shared block counted once per invocation, with and without the rows'
   state traffic), tokens/s and a compiled decode step's device
   operations; (d) on the zamba2-7b engine, a forged slot id leaves the
   victim's KV and state slots byte-equal, an eviction zeroes a tenant's
   slots in every pool, and a full tenant grows through the elastic
   plane, its KV and state slots moved by the relocation step.

9. training (right after phase 11, in its process: after the serve
   paths this one's cache stays split too finely, on the default
   stream, for the compiled step's warm-up on its side stream): (a)
   minicpm-2b and qwen3-moe-30b-a3b at full
   width and 2 layers, float32, the train guard (BITWISE; qwen3-moe's
   expert fence and K5 too), a 2 x 64-token batch: the loss and every
   gradient leaf on the card (K3 and K4 launched, their backwards in
   PyTorch) against the CPU from the same weights — the loss within 1e-5
   relative, each leaf within 1e-4 of its max |value|; then minicpm-2b's
   compiled step (``compile_train_step``: one CUDA graph for forward,
   backward and AdamW) against eager, 5 steps of 2 x 64 tokens under WSD
   from one seed's weights: two eager runs give the card's own spread,
   and the compiled run holds every loss within 1e-5 relative and every
   param and moment leaf within 1e-4 of its max |value| (or the spread,
   if larger), one graph, a replay's launches equal to an eager step's,
   whether each run is bit-equal printed; the same with the steps'
   batches at 64, 64, 32, 64 and 32 tokens: two graphs in the step's
   one pool, each replayed after the other was captured; (b) minicpm-2b at
   full width and depth (40 layers, bf16, 2.72 B params) trained 10 steps
   through ``repro_torch.launch.train``'s ``main`` in-process (the
   compiled step; AdamW + WSD
   at peak lr 6e-4, batch 4 x 512, SyntheticLM seed 0, BITWISE guard,
   remat off), counts set to 0 just before and read just after — every
   loss finite, the last below the first, K3 once and K4 40 times a step,
   one graph — then the same weights with ``--no-guard``; then the same
   step eagerly (``step_fn.fn``) 5 steps from the same weights: the
   compiled losses within 1e-5 relative of eager's (or the measured
   spread), the compiled replays' and the eager step's times by CUDA
   events, the capture's seconds, the reserved bytes after the warm-up
   and after its release, the graph pool's bytes and the peaks; it
   prints the losses, the
   peak memory, the CLI's step times and their guarded/native ratio, then
   (the same weights again) the step's forward / backward / optimizer
   times by CUDA events, guarded and native steps alternating, tokens/s,
   the model's TFLOP/s and share of the bf16 peak against the step's
   floor, and a step's device operations; (c) the restart contract at 2
   layers, bf16, under the compiled step: 6 steps against 3 +
   ``save_async`` / ``wait`` / ``restore`` + 3 (the restored tensors
   captured afresh), the final losses within 1e-5, and whether params
   and moments are bit-identical; (e) a train step whose loss calls
   ``.item()`` refused at capture, twice, naming it, the card usable
   after.  Phase 2 holds K3 and K4 at (b)'s shapes
   too (K3 over the 122,753 x 2,304 table under its 131,072 fence with
   2,048 ids; K4 bf16 at (4, 512, 36, 64), causal), rows named
   ``kernel@minicpm-2b/train``, and times both backwards.

10. the vision and encoder-decoder families (after phase 8), through the
   model API (the reference's engine serves neither): (a) qwen2-vl-2b and
   seamless-m4t-medium at full width and 2 layers (seamless: 2 encoder +
   2 decoder), float32, one seed's weights on both devices — 2 rows,
   prefill (qwen2-vl: 16 patches on a 4 x 4 grid, M-RoPE components
   differing, + 8 text tokens; seamless: 64 frames, 16 target tokens, an
   8-slot pool where row 1 names row 0's slot) + 4 greedy decode steps,
   card against CPU within phase 3's 2e-3, the forged row's cross K/V at
   its own fenced slot on both devices, launches counted; the loss and
   every gradient leaf within phase 9 (a)'s bounds; (b) each at full
   width and depth in bf16 on the API's defaults (a bf16 slab cache —
   K1 reads it as it is): qwen2-vl-2b (28 layers, 1.78 B params) B = 4
   with 256 patches on a 16 x 16 grid + 64 text tokens, seamless (12 +
   12 layers, 0.88 B) B = 4 with 1,024 frames + 32 target tokens, a
   prefill and 16 greedy decode steps, counts set to 0 just before and
   read just after — K3 once a step, K4 once a layer of the prefill
   (seamless: 36 — its encoder's and cross-attention's not causal, the
   cross-attention over 1,024 keys), K1 once a layer a step (seamless:
   24, self and cross), each form's launches split by call site — every
   logit finite, every greedy id in the vocabulary; it prints the
   prefill's and each step's wall time on the stream (CUDA events around
   eager API calls: the host's time to launch them), the device busy
   time of a prefill and of a step (``torch.profiler``) against the
   step's bytes floor, tokens/s, peak memory, a step's device operations
   and seamless's unpadded 256,206-row LM head's time.  Phase 2 holds
   their kernels at
   (b)'s shapes (rows kernel@qwen2-vl-2b / kernel@seamless-m4t-medium):
   K3 over both tables, K1 on a bf16 pool at qwen2-vl's decode (every
   cluster size) and seamless's cross view, and K4 in bf16 and f32 at
   qwen2-vl's prefill, seamless's encoder and its cross shape (32
   queries over 1,024 keys), K4 not causal over key lengths that end
   inside a key tile (32 over 1,000, 57 over 193, 70 over 5), held for
   the log; and K1 over stablelm-3b's main case with
   its pool in bf16, beside its f32 row.  A bf16-pool row's control
   (:func:`k1_bf16_math`: bf16 sums instead of widening to float32) must
   break its bound.

11. training the recurrent families, the MoE variants and the float8 KV
   pool (right after phase 2, in a process of its own started with this
   one's cache released: after the serve paths the cache stays split too
   finely for the MoE step's 768 MiB buffers): (a) card against CPU in
   f32 at full width —
   xlstm-350m at 2 layers, zamba2-7b at 7 (a group of 6 and a 1-layer
   tail), qwen3-moe-30b-a3b at 2 with the ``einsum`` dispatch — the loss
   within 1e-5 relative and every gradient leaf within 1e-4 of its max
   |value|, as phase 9 (a); then the compiled step against eager as
   phase 9 (a)'s, for xlstm-350m at 2 layers, zamba2-7b at 7 and
   qwen3-moe-30b-a3b at 2 (its two f32 copies and a graph pool need this
   process's whole card; its remat variants are held in (b)); (b)
   xlstm-350m (12 of its 24 layers since PR 29) and zamba2-7b at
   full width and 27 layers (its 81 do not train on one card: 4 groups
   and a 3-layer tail) trained 3 steps in bf16 through
   ``repro_torch.launch.train``'s ``main`` (compiled) at batch 4 x 512
   (the depth
   set on the registered config, the CLI having no depth flag), counts
   set to 0 just before and read just after (K3 once a step, K4 once a
   shared-attention call, one graph), then ``--no-guard`` for 2 steps —
   losses, the
   CLI's step time, its guarded/native ratio, tokens/s and peak memory —
   and the compiled step against the same step run eagerly: 3 eager
   steps of zamba2-7b from the same weights on the same batches (the
   compiled losses within 1e-5 relative or (a)'s spread); for
   xlstm-350m, whose eager step takes 11-23 s of host time, one eager
   step from a copy of the state and batch its first replay started
   from (the loss so, every param and moment leaf within 1e-4 of its max
   |value| or (a)'s spread); both step times by CUDA events, the
   capture's and its instantiation's seconds, the graph pool; then
   qwen3-moe-30b-a3b at
   full width and 2 layers, bf16, batch 4 x 512: the scatter and einsum
   dispatches' loss and gradients held together at bf16 tolerance, and
   the train step of each with remat off, ``nothing`` and ``dots``
   (step time by CUDA events, peak memory, launches), each run eagerly
   twice (the spread) and compiled from the seed's weights over the same
   4 batches: the compiled losses within 1e-5 relative and every param
   and moment leaf within 1e-4 of its max |value| (or the spread), one
   graph, a replay's launches equal to an eager step's, its replays'
   time; (c) stablelm-3b at
   full width and depth over a float8 e4m3 slab pool and an f32 one on
   the same weights: a 64-token prefill and 8 decode steps, the fp8
   run's counts (K3, K4 once a layer of the prefill, K1 once a layer a
   step, no plain version), every logit finite and correlated > 0.98
   with the f32 pool's (the reference's H3), each pool's decode step
   time and device busy time.  Phase 2 holds K1 over a float8 pool at
   stablelm-3b's slab shape (launches: (c)'s) and at qwen3-moe's GQA
   shape (on no path), every cluster size, bf16 and f32 queries, and K2
   storing f32 and bf16 sources into a float8 pool in its forms check.

12. the reference's step bundles (right after phase 11, in a process of
   its own: the 43 GB bf16 pool needs the card's memory whole): (a)
   stablelm-3b and qwen3-moe-30b-a3b at full width and 2 layers, float32,
   through ``build_prefill_step`` / ``build_decode_step`` on
   ``make_local_mesh()`` (``kv_dtype`` "f32", the bundles' BITWISE guard
   — the MoE family's expert fence and K5 too): a 4 x 64 (MoE: 4 x 32)
   prefill and 4 greedy decode steps, card against CPU from the same
   weights — greedy ids equal, logits within phase 3's 2e-3, the
   launches counted; ``compress_roundtrip`` of a (50,304 x 2,560) float32
   tensor card = CPU bit for bit, and ``tree_compress_psum`` over a
   one-rank NCCL group equal to the round trip leaf by leaf; (b)
   stablelm-3b at full width and depth (32 layers, bf16 weights from a
   seeded generator) at the reference's ``prefill_32k`` / ``decode_32k``
   with the global batch cut to 4 (each cut printed), over a bf16 pool
   (42.95 GB, the reference's default) and a float8 one, each bundle
   guarded (``make_guard``, BITWISE) and with ``guard_enabled=False``:
   the prefill bundle at its spec (4 x 32,768) guarded, native, native,
   guarded; the prefill bundle filling the cache with 4 x 32,704 tokens
   (511 pages a row); 16 decode bundle steps guarded, native, native,
   guarded from that cache (the float8 pool fed the bf16 pool's tokens);
   counts set to 0 just before a pool's run and read just after — every
   K1 / K3 / K4 call launched its kernel, no plain version, every logit
   finite, guarded logits bit-equal to native ones — printing the
   prefill's wall and tokens/s, the decode step's median (min-max)
   against its bytes floor, guarded / native, the launches a call, peak
   memory and the greedy ids the float8 pool shares with the bf16
   pool's; then, the counts read, each pool at its last layer (a view
   past 2^31 elements into the pool tensor): its K / V slabs at 8
   positions of every row equal to what the model wrote, value for
   value, and to the plain projection of the layer's input within a stated
   bound (the layer before's weights, the control, breaking it), and K1
   over the view with the decode step's q held against its plain
   version, with its control and the pages outside the fence clobbered.
   Phase 2 holds K1 over the bf16 and the float8 layer view (4,096
   pages, each row's 512 followed by 512 outside its table,
   32,704-32,720 held tokens), K4 at (4, 32,768, 32, 80) bf16 causal
   (its plain version, whose scores would take 550 GB whole, on (row,
   head, query block) triples, the first and last blocks among them,
   within half a bf16 ulp plus 2^-5 of the row's output RMS, a dropped
   far key tile as the control; its plain time the whole call one (row,
   head) at a time) and K3 over the prefill's
   131,072 ids, rows ``kernel@stablelm-3b/32k`` (``/32k-fp8``), launches
   from (b).  Then K1 and K4 at stablelm-3b's per-device shapes on the
   16 x 16 mesh, as the dry run's partitioned ``decode_32k`` /
   ``prefill_32k`` traces give them (:func:`mesh_kernel_calls`: q (8, 2,
   80) over the (65,536, 64, 2, 80) bf16 layer view the partition gathers
   over the data axis, a cluster of 8; K4 at (2, 32,768, 2, 80)), held
   and timed as the 32k rows are, rows ``kernel@stablelm-3b/16x16``,
   launches 0 (the partitioned program is traced, not run).

13. the dry run (``repro_torch.launch.dryrun``): (a) in two processes of
   its own started after the build, beside the other phases (host work
   only: traces on fake tensors), one single-pod cell per family
   (:data:`DRYRUN_CELLS`: stablelm-3b ``train_4k``, qwen3-moe-30b-a3b
   ``decode_32k``, zamba2-7b ``prefill_32k``, xlstm-350m ``long_500k``,
   qwen2-vl-2b ``decode_32k``, seamless-m4t-medium ``prefill_32k``),
   traced whole at full depth (unpartitioned, the whole program: the
   costs, the liveness walk, the per-op counts and the launches equal on
   CUDA and CPU fakes) and, the first three at 8, 12 and 12 layers,
   partitioned over a fake process group of 256 ranks (rank 0's program,
   DTensor) and traced on CUDA fakes and on CPU fakes: the cost, memory,
   collectives and roofline blocks (per-device FLOPs, bytes, temp,
   collectives by kind), the liveness walk, the per-op counts and the
   launches equal, a difference naming the op, each cell's trace seconds
   printed, its lines printed after phase 12's; (b) in phase 12's
   process, after it: stablelm-3b at 32 layers, 4 x 32,768, a bf16 slab
   pool, guarded, on the 1 x 1 mesh, each bundle's dry run on CUDA fakes
   against one real step — argument bytes equal to the params, cache and
   inputs allocated for it, the kernels' launches equal to the trace's
   (K3 once and K1 32 times a decode step, K3 once and K4 32 times a
   prefill), the predicted peak (argument + temp + output - alias)
   within 10 % of ``max_memory_allocated`` over the step, its gap printed
   with its sign — and, printed only, the trace's counted aten ops
   beside ``torch.profiler``'s device operations for the step and the
   roofline's least time beside phase 12's step time.  Phase 2's bounds
   read the kernels' cost rules of ``repro_torch.launch.graph_analysis``,
   the rules the dry run counts with.

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

import atexit
import collections
import contextlib
import dataclasses
import gc
import hashlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
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


def rule_bound(cost, dtype: str) -> dict:
    """``bound_ms`` / ``bound_by`` of a kernel call's work as its cost rule
    counts it (``repro_torch.launch.graph_analysis``: the rule the dry run
    reads), given the counts the call's data needs."""
    return dict(zip(("bound_ms", "bound_by"),
                    bound_ms(cost.bytes, cost.flops, dtype)))


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


def tree_leaves(x) -> list:
    """The leaves of a nested operand (dicts, lists, cache dataclasses)."""
    from repro_torch.core.stepgraph import tree_flatten
    return tree_flatten(x)[1]


def tree_to(x, device):
    """A nested operand with every tensor leaf moved to ``device``."""
    from repro_torch.core.stepgraph import tree_flatten, tree_unflatten
    struct, leaves = tree_flatten(x)
    return tree_unflatten(struct, [t.to(device) for t in leaves])


def tree_bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x))


@contextlib.contextmanager
def uncounted():
    """Within ``with``: kernel calls made to hold a kernel against its
    plain version leave every kernel's counts as they were."""
    from repro_torch.kernels import _build
    kept = {k: (k.launches, k.plain_calls) for k in _build.KERNELS.values()}
    try:
        yield
    finally:
        for k, (n, m) in kept.items():
            k.launches, k.plain_calls = n, m


def hold_card_vs_cpu(label, card, cpu, tol: float, note: str = "") -> float:
    """A run's ``(logits, greedy ids)`` on the card against the CPU's: the
    ids equal, the logits within ``tol``.  Returns the logits' max error."""
    (logits_gpu, ids_gpu), (logits_cpu, ids_cpu) = card, cpu
    err = (logits_gpu - logits_cpu).abs().max().item()
    if not ids_gpu.equal(ids_cpu):
        raise AssertionError(f"{label}: greedy ids differ card vs CPU{note}: "
                             f"{ids_gpu.tolist()} vs {ids_cpu.tolist()}")
    if not err <= tol:
        raise AssertionError(f"{label}: logits differ card vs CPU by {err} "
                             f"> {tol}{note}")
    return err


# --------------------------------------------------------------------- #
# Phase 2: each kernel against its plain version                        #
# --------------------------------------------------------------------- #

#: K1's float32 ordering slack: the kernel sums each row's scores, its
#: P.V and the cluster's partials in another order than the plain
#: version; an f32 query measures that difference directly (K1_F32_TOL
#: holds it)
K1_SLACK = 1e-5
K1_F32_TOL = 1e-4


#: CUgraphNodeType values of the nodes that are device operations:
#: kernels, copies and memsets
GRAPH_OP_NODES = (0, 1, 2)


def device_ops_per_call(torch, fn) -> int:
    """Device operations (kernels, copies, memsets) one call of ``fn``
    puts on the card: the kernel, copy and memset nodes of a CUDA graph
    that captures one call, after a warm-up call on a side stream.  A
    capture holds every operation the call enqueues, so the count does not
    vary from run to run; ``torch.profiler`` can drop a record (one launch
    of ten, in every session of a row, has been seen on the card)."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(g, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    kind = ctypes.c_int(0)
    count = 0
    if n.value and cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    for node in nodes:
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        count += kind.value in GRAPH_OP_NODES
    graph.reset()
    return count


def half_ulp_bf16(torch, x):
    """Half a bfloat16 ulp at each |x| (float32): 2^(e - 9) for |x| in
    [2^(e-1), 2^e); 0 at x = 0."""
    x = x.float().abs()
    _, e = torch.frexp(x)
    return torch.where(x > 0, torch.ldexp(torch.ones_like(x), e - 9),
                       torch.zeros_like(x))


def check_paged_attention(torch, q, k_pool, v_pool, table, lens, base, msk,
                          page_map, window: int = 0):
    """K1 on one case, against the plain version in float32 on K/V
    rounded to q's type: a bf16 output within half a bf16 ulp (of the
    larger of the two values) plus K1_SLACK, and the control without K/V
    rounding (over a bf16 pool: with bf16 sums, :func:`k1_bf16_math`)
    must break that bound; an f32 output within K1_F32_TOL.
    Then every page the fence does not reach is clobbered and the output
    must not move.  ``window`` is K1's sliding window (0: none).  Returns
    the output, its worst error and error/bound, the control's
    error/bound and the number of pages clobbered."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention

    bf16 = q.dtype == torch.bfloat16
    out = paged_attention(q, k_pool, v_pool, table, lens, base, msk,
                          page_map, window=window)
    want = ref.paged_attention_ref(
        q.float(), k_pool.to(q.dtype).float(), v_pool.to(q.dtype).float(),
        table, lens, base, msk, page_map, window=window)

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
    if bf16 and k_pool.dtype != torch.float32:
        # a bf16 or float8 pool has no K/V rounding to miss: the control
        # sums in bf16 instead of widening to float32
        ctrl_ratio = err_ratio(k1_bf16_math(
            torch, q, k_pool, v_pool, table, lens, base, msk, page_map,
            window))[1]
        if not ctrl_ratio > 1.0:
            raise AssertionError(
                f"paged_attention control (bf16 sums) within the bound "
                f"({ctrl_ratio:.3f}x): the bound cannot see the rounding")
    elif bf16:
        ctrl = ref.paged_attention_ref(q.float(), k_pool, v_pool, table,
                                       lens, base, msk, page_map,
                                       window=window).to(q.dtype)
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
    if k_pool.element_size() == 1:
        # a float8 pool's pages are clobbered through its bytes: 448, -448
        k2.view(torch.uint8)[foreign], v2.view(torch.uint8)[foreign] = \
            0x7E, 0xFE
    else:
        k2[foreign], v2[foreign] = 12345.0, -999.0
    if not torch.equal(out, paged_attention(q, k2, v2, table, lens, base,
                                            msk, page_map, window=window)):
        raise AssertionError("paged_attention read outside the fence")
    return dict(out=out, err=err, ratio=ratio, ctrl_ratio=ctrl_ratio,
                foreign=len(foreign))


def k1_bf16_math(torch, q, k_pool, v_pool, table, lens, base, msk,
                 page_map=None, window: int = 0):
    """K1's function with its scores and probabilities rounded to bf16:
    what a kernel that summed a bf16 pool without widening it to float32
    would give.  The control of the bf16-pool rows (the K/V rounding
    control of the f32-pool rows has nothing to round there)."""
    from repro_torch.kernels import ref
    B, H, D = q.shape
    P, page, KH, _ = k_pool.shape
    phys = ref.resolve_pages(table, base[:, None], msk[:, None], page_map,
                             P).long()
    S = phys.shape[1] * page
    k = ref.take_pages(k_pool, phys).reshape(B, S, KH, D).to(q.dtype)
    v = ref.take_pages(v_pool, phys).reshape(B, S, KH, D).to(q.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(B, KH, H // KH, D), k) \
        * (1.0 / math.sqrt(D))
    pos = torch.arange(S, device=q.device)
    lens = lens[:, None]
    valid = pos[None, :] < lens
    if window > 0:
        valid = valid & (pos[None, :] >= lens - window)
    s = s.float().masked_fill(~valid[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgs,bskd->bkgd", p, v).reshape(B, H, D)


def k1_pool_row(torch, row, path, q, k_pool, v_pool, table, lens, base,
                msk, page_map=None, window: int = 0, chk=None, ops=None,
                **kw):
    """A K1 row over ``k_pool`` / ``v_pool`` (float32, bfloat16 or float8
    e4m3) under ``window`` (0: none), held against the plain version by
    :func:`check_paged_attention` (``chk``, where the caller has held the
    case already), one device operation a call (``ops``, where counted
    already), timed, with its bytes and operations bound: each distinct K
    and V token row the output needs read once in the pool's type
    (:func:`k1_held`), q read and out written, the table and the per-row
    lens / base / mask read; operations: each row's query against each
    position it walks.  Returns the check."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.launch.graph_analysis import paged_attention_cost

    B, H, D = q.shape
    P, page, KH, _ = k_pool.shape
    if chk is None:
        chk = check_paged_attention(torch, q, k_pool, v_pool, table, lens,
                                    base, msk, page_map, window=window)
    call = (lambda: paged_attention(q, k_pool, v_pool, table, lens, base,
                                    msk, page_map, window=window))
    if ops is None:
        ops = device_ops_per_call(torch, call)
    if ops != 1:
        raise AssertionError(f"paged_attention [{path}]: {ops:g} device "
                             "operations a call, want 1")
    phys = ref.resolve_pages(table, base[:, None], msk[:, None], page_map, P)
    pairs, k_tok, v_tok = k1_held(phys, lens, page, window)
    cost = paged_attention_cost(q, k_pool, table, base, msk,
                                positions=pairs, k_tokens=k_tok,
                                v_tokens=v_tok)
    pool = {torch.bfloat16: "bf16", torch.float8_e4m3fn: "fp8 e4m3"}.get(
        k_pool.dtype, "f32")
    qt = "bf16" if q.dtype == torch.bfloat16 else "f32"
    what = "scores and P rounded to bf16" if pool != "f32" \
        else "no K/V rounding"
    ctrl = "" if chk["ctrl_ratio"] is None else \
        f"; the control ({what}) {chk['ctrl_ratio']:.3g}"
    row("paged_attention", "paged_attention.cu",
        "fenced_paged_attention.py:173", device_ops=ops,
        max_abs_err=chk["err"],
        tolerance=(f"1/2 bf16 ulp + {K1_SLACK:g} of the f32 plain version "
                   f"on K/V rounded to bf16 (worst error/bound "
                   f"{chk['ratio']:.3f}{ctrl})"
                   if q.dtype == torch.bfloat16 else f"{K1_F32_TOL:g}")
        + f"; {chk['foreign']} pages outside the fence clobbered, output "
          "unchanged",
        ms=cuda_ms(torch, call),
        plain_ms=cuda_ms(torch, lambda: ref.paged_attention_ref(
            q, k_pool, v_pool, table, lens, base, msk, page_map,
            window=window)),
        library_ms=None, library_call=None,
        shape=f"q ({B},{H},{D}) {qt}, pool ({P},{page},{KH},{D}) "
              f"{pool}, lengths {min(lens.tolist())}-{max(lens.tolist())}"
              + (f", window {window}" if window else ""),
        **kw, **rule_bound(cost, "float32"))
    return chk


def k4_err(torch, path, q, k, v, causal: bool, window: int = 0) -> float:
    """K4 on one case (q's dtype; ``causal``; Skv = k's length, its own
    when not causal; ``window``) against the plain version: within 2e-2
    in bf16 (one ulp at |out| < 4, which also covers the kernel's bf16
    rounding of P), 1e-4 in f32 (the sums run in another order).  Returns
    the max error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-4
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"flash_attention [{path}] ({q.dtype}, Sq "
                             f"{q.shape[1]}, Skv {k.shape[1]}, causal "
                             f"{causal}, window {window}): error {err} > "
                             f"{tol}")
    return err


def k4_form_row(torch, row, path, q, k, v, causal: bool, window: int = 0,
                err=None, **kw):
    """A K4 row in one form (q's dtype; ``causal``; Skv = k's length;
    ``window``), held by :func:`k4_err` (``err``, where the caller has held
    its cases already), one device operation a call, timed against the
    plain version and ``scaled_dot_product_attention`` on the same inputs
    (the band as a boolean mask where a window cuts inside S), with its
    bound: q, k, v read and the output written once; QK^T and PV over the
    band's (query, key) pairs.  Returns the error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.graph_analysis import flash_attention_cost
    import torch.nn.functional as F

    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    if err is None:
        err = k4_err(torch, path, q, k, v, causal, window)
    call = (lambda: flash_attention(q, k, v, causal=causal, window=window))
    ops = device_ops_per_call(torch, call)
    if ops != 1:
        raise AssertionError(f"flash_attention [{path}]: {ops:g} device "
                             "operations a call, want 1")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = KH != H
    if window and window < Sq:
        band = band_mask(torch, Sq, window, causal)
        pairs = int(band.sum())
        lib = (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band, enable_gqa=gqa))
        lib_call = "F.scaled_dot_product_attention(attn_mask=band)"
    else:
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
        lib = (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=gqa))
        lib_call = (f"F.scaled_dot_product_attention(is_causal={causal}"
                    + (", enable_gqa=True)" if gqa else ")"))
    cost = flash_attention_cost(q, k, causal, window, pairs=pairs)
    row("flash_attention", "flash_attention.cu", "flash_attention.py:84",
        device_ops=ops, max_abs_err=err,
        tolerance="2e-2 (bf16 output, one ulp at |out| < 4)" if bf16
        else "1e-4 (f32)",
        ms=cuda_ms(torch, call),
        plain_ms=cuda_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, causal=causal, window=window), iters=5),
        library_ms=cuda_ms(torch, lib), library_call=lib_call,
        shape=f"q ({B},{Sq},{H},{D}), k/v ({B},{Skv},{KH},{D}) "
              f"{'bf16' if bf16 else 'f32'}, "
              + ("causal" if causal else "not causal")
              + (f", window {window}" if window else ""),
        **kw, **rule_bound(cost, "bfloat16" if bf16 else "float32"))
    return err


def check_kernels(torch, cfg):
    """Rows of the kernel table at ``cfg``'s serve shapes (max_batch 8,
    64-token pages, a 64-page pool — the shape of the slab path's layer
    view, 16 slots x 4 pages — a ragged 57-token prefill), for the kernels
    ``cfg``'s family runs: K3 always; K4 and K1 where it attends (not
    ssm); K2 where its path is paged (dense, MoE; the slab write is plain
    PyTorch); K5 with experts.  K4 and K1 run under the config's window
    (0: none).  A windowed config also gets rows under a window inside the
    lengths and K4's ``causal=False`` form: forms on no path, whose rows
    carry their own 0 launches."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gather_rows import gather_rows
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.scatter_pages import scatter_pages
    from repro_torch.launch import graph_analysis as GA
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

    def row(kernel, source, replaces, **kw):
        rows.append(dict(kernel=kernel, path=cfg.name, route="cuda",
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
    cost = GA.gather_rows_cost(table, ids, rows=int(in_table.sum()))
    row("gather_rows", "gather_rows.cu", "fenced_gather.py:48",
        max_abs_err=err, tolerance="exact (NaN rows where the fenced id "
                                   "is past the table)",
        ms=cuda_ms(torch, lambda: gather_rows(table, ids, 0, mask)),
        plain_ms=cuda_ms(torch, lambda: ref.gather_rows_ref(
            table, ids, 0, mask)),
        library_ms=cuda_ms(torch, lambda: table.index_select(0, ok_ids)),
        library_call="Tensor.index_select of the in-table rows",
        shape=f"table {tuple(table.shape)} bf16, {ids.numel()} ids",
        **rule_bound(cost, "bfloat16"))
    log(f"K3 gather_rows ok{tag}: equal to its plain version under the "
        f"scalar {fence_vocab} fence ({nan_rows['scalar']} NaN rows for ids "
        f"past the {cfg.vocab}-row table), the identity fence "
        f"({nan_rows['identity']}) and per-id fences of {quarter} rows "
        f"({nan_rows['per-id']})")
    del table
    if cfg.family == "ssm":
        log_rows(rows)
        return rows

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
    paged = cfg.family in ("dense", "moe")
    if paged:
        kk, vv = k_pool.clone(), v_pool.clone()
        scatter_pages(kk, vv, k_src, v_src, page_ids, base, msk, page_map)
        kr, vr = k_pool.clone(), v_pool.clone()
        ref.scatter_pages_ref(kr, vr, k_src, v_src, page_ids, base, msk,
                              page_map)
        if not (torch.equal(kk, kr) and torch.equal(vv, vr)):
            raise AssertionError("scatter_pages disagrees with its plain "
                                 "version")
        err = max((kk - kr).abs().max().item(), (vv - vr).abs().max().item())
        phys = ref.resolve_pages(page_ids, base[:, None], msk[:, None],
                                 page_map, P).reshape(-1)
        written = set(int(p) for p in phys)
        if not 1 <= int(phys[1]) <= 16:        # tenant0's physical pages
            raise AssertionError("scatter_pages: forged id left its extent")
        untouched = [p for p in range(P) if p not in written]
        if not (torch.equal(kk[untouched], k_pool[untouched])
                and torch.equal(vv[untouched], v_pool[untouched])):
            raise AssertionError("scatter_pages wrote outside the fenced "
                                 "pages")
        # bytes, K and V: for each kept page its S source tokens read and the
        # whole page written (the padding is zero-filled, not read), plus the
        # ids and fence operands
        cost = GA.scatter_pages_cost(k_pool, k_src, page_ids, base, msk,
                                     pages=len(written))
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
            library_ms=cuda_ms(torch, lambda: kv2.index_copy_(1, uniq,
                                                              pages2)),
            library_call="Tensor.index_copy_ of the kept padded K and V pages",
            shape=f"pools ({P},{page},{KH},{D}) f32, src ({B},{S},{KH},{D})",
            **rule_bound(cost, "float32"))
        # K2's bytes alone: one copy_ of the kept padded K and V pages into
        # as many contiguous pool pages, with no lookups and no fence
        bytes_ms = cuda_ms(torch, lambda: kv2[:, :len(last)].copy_(pages2))
        log(f"K2 scatter_pages ok{tag}: {len(written)} distinct pages "
            f"written, forged id wrapped into its extent, {len(untouched)} "
            f"pages untouched; its bytes alone (one copy_ of the kept padded "
            f"pages) take {bytes_ms:.5f} ms")

    # ---- K4 flash_attention: ragged prefill --------------------------- #
    # bf16 (the tensor-core kernel) and f32 (the CUDA-core kernel), at one
    # key tile (S = 57) and at four (S = 193, ragged: the online-softmax
    # rescale across tiles), each against the plain version, in every
    # (window, causal) form: the path's (the config's window), and for a
    # windowed config the window inside S (32, 100) and the non-causal
    # form, whole and windowed.  bf16: one bf16 ulp at outputs in [2, 4)
    # (an early causal row averages only a few V rows of N(0, 1) values),
    # which also covers the kernel's bf16 rounding of P
    # (tests/test_torch_kernels.py emulates it); f32: the sums run in
    # another order than the plain version's.
    bf16, f32 = torch.bfloat16, torch.float32
    w_path = cfg.attn_window
    forms = [(w_path, True)] + ([(32, True), (100, True), (0, False),
                                 (32, False)] if w_path else [])
    cases = {(bf16, S): tuple(randn(B, S, h, D, dtype=bf16)
                              for h in (H, KH, KH))}
    for dt, s_len in ((bf16, 193), (f32, S), (f32, 193)):
        cases[(dt, s_len)] = tuple(randn(B, s_len, h, D, dtype=dt,
                                         generator=more)
                                   for h in (H, KH, KH))
    errs = {(dt, s_len, w, causal): k4_err(torch, cfg.name, q, k, v,
                                           causal, w)
            for (dt, s_len), (q, k, v) in cases.items()
            for w, causal in forms}

    k4_form_row(torch, row, cfg.name, *cases[(bf16, S)], True,
                window=w_path, err=max(errs[(bf16, S, w_path, True)],
                                       errs[(bf16, 193, w_path, True)]))
    if w_path:
        k4_form_row(torch, row, cfg.name, *cases[(bf16, 193)], True,
                    window=32, err=errs[(bf16, 193, 32, True)],
                    name=f"flash_attention@{cfg.name}/window", launches=0)
        k4_form_row(torch, row, cfg.name, *cases[(bf16, S)], False,
                    err=errs[(bf16, S, 0, False)],
                    name=f"flash_attention@{cfg.name}/non-causal",
                    launches=0)
    # four key tiles, timed for the log only
    q4, k4, v4 = cases[(bf16, 193)]
    ms_193 = cuda_ms(torch, lambda: flash_attention(q4, k4, v4,
                                                    window=w_path))
    qt, kt, vt = (t.transpose(1, 2) for t in (q4, k4, v4))
    band = band_mask(torch, 193, w_path, True) \
        if w_path and w_path < 193 else None
    sdpa_193 = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=band, is_causal=band is None,
        enable_gqa=KH != H))
    log(f"K4 flash_attention ok{tag}: max |err| " + "; ".join(
        f"{'bf16' if dt == bf16 else 'f32'} S={s_len}"
        f"{f' window {w}' if w else ''} {'causal' if c else 'not causal'} "
        f"{e:.3g}" for (dt, s_len, w, c), e in errs.items())
        + f"; tolerance 2e-2 (bf16), 1e-4 (f32); bf16 at S=193: kernel "
        f"{ms_193:.5f} ms, scaled_dot_product_attention {sdpa_193:.5f} ms")

    # ---- K1 paged_attention: decode over the f32 pool ----------------- #
    # The main row: a bf16 query, the inputs ``gen`` has always given K1
    # (17-80 held tokens a row, forged table ids, per-row fences).  More
    # cases from ``more``: a (8, 4) table at the main path's max_len 256
    # with a full row (all four pages), a row with seq_len 0, lengths on a
    # page boundary and lengths ending inside a 32-token tile and inside a
    # cluster rank's share; each in bf16 and in f32.  Each under the
    # path's window, and for a windowed config also under a window of 32,
    # inside every length past it, and under none (0).
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
    windows = [w_path] + ([32, 0] if w_path else [])
    k1 = {(dt, name, w): check_paged_attention(
              torch, q_, k_pool, v_pool, t_, l_, base, msk, page_map,
              window=w)
          for w in windows for (dt, name), (q_, t_, l_) in k1_cases.items()}
    # the fence by value: the identity fence on the resolved physical
    # pages gives the per-row fenced result bit for bit
    phys = ref.resolve_pages(table_ids, base[:, None], msk[:, None],
                             page_map, P)
    if not torch.equal(paged_attention(qd, k_pool, v_pool, phys, lens, 0,
                                       -1, window=w_path),
                       k1[("bf16", "main", w_path)]["out"]):
        raise AssertionError("paged_attention under the scalar identity "
                             "fence differs from the per-row fence")
    phys_cov = ref.resolve_pages(cov_table, base[:, None], msk[:, None],
                                 page_map, P)
    q256 = k1_cases[("bf16", "max_len 256")][0]
    calls = {(name, w): (lambda q_=q_, t_=t_, l_=l_, w=w: paged_attention(
                 q_, k_pool, v_pool, t_, l_, base, msk, page_map, window=w))
             for w in windows
             for name, (q_, t_, l_) in (("main", (qd, table_ids, lens)),
                                        ("max_len 256", (q256, cov_table,
                                                         cov_lens)))}
    ops = {}
    for (name, w), call in calls.items():
        ops[(name, w)] = device_ops_per_call(torch, call)
        if ops[(name, w)] != 1:
            raise AssertionError(f"paged_attention ({name}, window {w}): "
                                 f"{ops[(name, w)]:g} device operations a "
                                 "call, want 1")

    k1_pool_row(torch, row, cfg.name, qd, k_pool, v_pool, table_ids, lens,
                base, msk, page_map, window=w_path,
                chk=k1[("bf16", "main", w_path)], ops=ops[("main", w_path)])
    nan_at = 0
    if w_path:
        k1_pool_row(torch, row, cfg.name, q256, k_pool, v_pool, cov_table,
                    cov_lens, base, msk, page_map, window=32,
                    chk=k1[("bf16", "max_len 256", 32)],
                    ops=ops[("max_len 256", 32)],
                    name=f"paged_attention@{cfg.name}/window", launches=0)
        # positions before a row's band are never loaded: NaN K and V at
        # every one that no row's band covers leave the output bit-equal
        k_nan, v_nan, nan_at = nan_before_window(torch, k_pool, v_pool,
                                                 phys_cov, cov_lens, 32)
        if not torch.equal(calls[("max_len 256", 32)](),
                           paged_attention(q256, k_nan, v_nan, cov_table,
                                           cov_lens, base, msk, page_map,
                                           window=32)):
            raise AssertionError(f"paged_attention{tag}: a position before "
                                 "the window moved the output")
        del k_nan, v_nan
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
    ms_256 = cuda_ms(torch, calls[("max_len 256", w_path)])
    # every cluster size the kernel can launch, each checked as above and
    # timed on the main row's inputs and on the max_len 256 lengths, under
    # each window
    K1 = sys.modules["repro_torch.kernels.paged_attention"]
    chosen, sweep = K1.cluster_size, []
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        for c in (1, 2, 4, 8):
            K1.cluster_size = lambda pairs, n_sm, c=c: c
            for w in windows:
                for q_, t_, l_ in (k1_cases[("bf16", "main")],
                                   k1_cases[("bf16", "max_len 256")]):
                    check_paged_attention(torch, q_, k_pool, v_pool, t_, l_,
                                          base, msk, page_map, window=w)
                sweep.append(
                    f"C={c}{f' window {w}' if w else ''} "
                    f"{cuda_ms(torch, calls[('main', w)]):.5f} / "
                    f"{cuda_ms(torch, calls[('max_len 256', w)]):.5f} ms")
    finally:
        K1.cluster_size = chosen
    log(f"K1 cluster sizes{tag} (main inputs / max_len 256 lengths; the "
        f"path runs C={chosen(B * KH, n_sm)}): " + ", ".join(sweep))
    log(f"K1 paged_attention ok{tag}: " + "; ".join(
        f"{dt} {name}{f' window {w}' if w else ''}: max |err| "
        f"{r['err']:.3g}, error/bound {r['ratio']:.3f}"
        + (f", control without K/V rounding {r['ctrl_ratio']:.3g}"
           if dt == "bf16" else "")
        + f", {r['foreign']} foreign pages clobbered, output unchanged"
        for (dt, name, w), r in k1.items())
        + f"; bound 1/2 bf16 ulp + {K1_SLACK:g} (bf16), {K1_F32_TOL:g} (f32);"
        f" the identity fence by value equals the per-row fence; lengths "
        f"{cov_lens.tolist()}: kernel {ms_256:.5f} ms; "
        + ", ".join(f"{n:g} device operation(s) a call ({name}"
                    f"{f', window {w}' if w else ''})"
                    for (name, w), n in ops.items())
        + (f"; NaN K/V at the {nan_at} positions before the window 32 that "
           "no band covers leave the output bit-equal" if w_path else ""))

    if cfg.family == "dense":
        # the main row's case over the pool in bf16 (the model API's
        # default cache), beside the f32 row: a form on no path here
        chk = k1_pool_row(torch, row, cfg.name, qd, k_pool.bfloat16(),
                          v_pool.bfloat16(), table_ids, lens, base, msk,
                          page_map, name=f"paged_attention@{cfg.name}"
                          "/bf16-pool", launches=0)
        log(f"K1 on a bf16 pool ok{tag}: the main row's inputs, max |err| "
            f"{chk['err']:.3g}, error/bound {chk['ratio']:.3f}, the bf16-"
            f"math control {chk['ctrl_ratio']:.3g}")
    if cfg.moe is not None:
        check_moe_histogram(torch, cfg, gen, more, row)
    # K2's added checks and the main path's prefill write come last: they
    # draw from ``more`` after every earlier check has drawn its inputs
    if paged:
        check_scatter_pages_forms(torch, cfg, more, k_pool, v_pool, page_map)
        check_prefill_write(torch, cfg, more)
    log_rows(rows)
    return rows


def log_rows(rows) -> None:
    for r in rows:
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms ({r['library_call']})"
        log(f"  {r.get('name', r['kernel'])} [{r['path']}], {r['shape']}: "
            f"max |err| {r['max_abs_err']:.3g}"
            f" (tolerance {r['tolerance']}); kernel {r['ms']:.5f} ms, plain "
            f"{r['plain_ms']:.5f} ms, library {lib}, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})"
            + (f", {r['device_ops']:g} device operation(s) a call"
               if "device_ops" in r else ""))


def band_mask(torch, S, window, causal):
    """K4's band as ``scaled_dot_product_attention``'s boolean mask (True
    attends): key j <= query i when ``causal``, j > i - window when
    ``window`` > 0."""
    pos = torch.arange(S, device="cuda")
    band = torch.ones(S, S, dtype=torch.bool, device="cuda")
    if causal:
        band &= pos[None, :] <= pos[:, None]
    if window:
        band &= pos[None, :] > pos[:, None] - window
    return band


def k1_walk(n: int, window: int, cap: int):
    """(lo, hi, attends) for a K1 row of ``n`` held tokens over ``cap``
    positions: the positions [lo, hi) the kernel and its plain version
    read — the band, the last ``window`` (all when 0) of the held tokens —
    or, when the band holds no position (``n`` <= 0, or a band past the
    table), every position, whose V the row's uniform mean needs and
    whose K it does not (``attends`` False)."""
    lo, hi = 0, (min(n, cap) if n > 0 else cap)
    if window > 0 and n > 0:
        lo = max(n - window, 0)
        if lo >= hi:
            return 0, cap, False
    return lo, hi, n > 0


def k1_held(phys, lens, page: int, window: int = 0):
    """(pairs, K tokens, V tokens) of a K1 call through each row's
    resolved pages ``phys``: the (row, position) pairs it walks
    (:func:`k1_walk`), and the distinct (page, position) pairs whose K and
    whose V the output needs — a token that several rows read (a shared
    or a garbage page) is one token of bytes."""
    cap = phys.shape[1] * page
    pairs, k_seen, v_seen = 0, set(), set()
    for pg, n in zip(phys.tolist(), lens.tolist()):
        lo, hi, attends = k1_walk(n, window, cap)
        at = {(pg[t // page], t % page) for t in range(lo, hi)}
        pairs += hi - lo
        v_seen |= at
        if attends:
            k_seen |= at
    return pairs, len(k_seen), len(v_seen)


def nan_before_window(torch, k_pool, v_pool, phys, lens, window: int):
    """Copies of the pools with NaN K and V at every position that lies
    before some row's band and that no row reads (:func:`k1_walk`, through
    each row's resolved pages ``phys``), and the number of such
    positions."""
    page = k_pool.shape[1]
    cap = phys.shape[1] * page
    read, before = set(), set()
    for pg, n in zip(phys.tolist(), lens.tolist()):
        lo, hi, attends = k1_walk(n, window, cap)
        read.update((pg[t // page], t % page) for t in range(lo, hi))
        if attends:
            before.update((pg[t // page], t % page) for t in range(lo))
    at = sorted(before - read)
    k, v = k_pool.clone(), v_pool.clone()
    if at:
        idx = tuple(torch.tensor(c, device=k_pool.device) for c in zip(*at))
        k[idx], v[idx] = float("nan"), float("nan")
    return k, v, len(at)

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
                             rand(2, 40, KH, D), True, cfg.attn_window),
                            1e-4),
        "paged_attention": ((rand(2, H, D), *pool, ints(0, 64, 2, 2),
                             ints(1, 129, 2), None, None, 0, 7, None,
                             cfg.attn_window), 1e-4),
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
    from repro_torch.launch.graph_analysis import moe_histogram_cost
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
    cost = moe_histogram_cost(ids, E)
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
        **rule_bound(cost, "float32"))
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
    serve path's; since PR 25 also into a float8 e4m3 pool, compared byte
    for byte, its sources scaled so a share passes 464 and is stored as
    NaN, as jnp's cast stores it), a one-page prefill (S = 57) whose ids
    are a strided
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
    f32, bf16, fp8 = torch.float32, torch.bfloat16, torch.float8_e4m3fn

    def per_row(v):   # a (B,) fence broadcast over the pages
        return v[:, None] if isinstance(v, torch.Tensor) and v.dim() == 1 \
            else v

    def raw(t):       # a float8 pool's bytes (NaN compares equal)
        return t.view(torch.uint8) if t.dtype == fp8 else t

    n_checks, written = 0, {}
    for src_dt in (f32, bf16):
        for pool_dt in (f32, bf16, fp8):
            pools = (k_pool.to(pool_dt), v_pool.to(pool_dt))
            scale = 150.0 if pool_dt == fp8 else 1.0
            for s_len, n in ((57, 1), (193, 4)):
                ids = table[:, :n]           # n = 1: a strided slice
                ks, vs = ((x * scale).to(src_dt) for x in srcs[s_len])
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
                    if not (torch.equal(raw(kk), raw(kr))
                            and torch.equal(raw(vv), raw(vr))):
                        raise AssertionError(f"{what}: differs from its "
                                             "plain version")
                    phys = ref.resolve_pages(ids, per_row(fb_n),
                                             per_row(fm_n), page_map, P)
                    hit = set(int(x) for x in phys.reshape(-1))
                    rest = [x for x in range(P) if x not in hit]
                    if not (torch.equal(raw(kk)[rest], raw(pools[0])[rest])
                            and torch.equal(raw(vv)[rest],
                                            raw(pools[1])[rest])):
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
        "the plain version (f32/bf16 sources into f32/bf16/fp8 pools; S = "
        "57 with strided ids, S = 193 over 4 pages; fences "
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
    from repro_torch.launch.graph_analysis import scatter_pages_cost
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
    n_bytes = scatter_pages_cost(cache.k[1], k_new, ids, fb, fm,
                                 pages=kept).bytes
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

def slab_full_width(torch, cfg, api, S: int = 24, steps: int = 4):
    """Phase 3's slab leg, as a ``run(device, params)`` like the paged
    leg's: the engine's slab geometry (8 rows, 16 slots of 4 pages, the
    ``(64, page, KH, D)`` layer view K1 reads), tenants a [8, 12) and b
    [12, 16), rows 0-2 serving (row 1's slot forged into b's extent), rows
    3-7 in scratch slots 0-4; an ``S``-token prefill in the ``permute``
    formulation, then ``steps`` decode steps.  Any slab cache: a KV slab,
    a recurrent state pool (ssm) or both (hybrid), the slot ids set on
    each half, the state fenced as the KV.  On the card, each KV layer's
    K1 call over the slab view (the rows' ids and lengths after the
    prefill, the config's window) is held against K1's plain version, with
    every slab no row addresses clobbered; those calls leave the kernel
    counts as they were.  No two rows share a slot here: rows sharing one
    sum their slabs (``permute``), in another order on the card than on
    the CPU, which the CPU tests hold instead (tests/test_torch_slab.py)."""
    from repro_torch.core.fence import FenceParams, FencePolicy, FenceTable
    from repro_torch.core.partition import Partition
    from repro_torch.models import kvcache as KV
    from repro_torch.models.guard import GuardSpec

    B, max_len, slots = 8, 256, 16
    parts = [Partition("a", 8, 4), Partition("b", 12, 4),
             Partition("scratch", 0, 8)]
    cols = torch.tensor([0, 0, 1] + [2] * 5, dtype=torch.int32)
    slot_ids = torch.tensor([8, 13, 12, 0, 1, 2, 3, 4], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator()
                         .manual_seed(5), dtype=torch.int32)

    def run(device, p):
        kv = FenceTable.from_partitions(parts, with_magic=True,
                                        device=device).gather(cols)
        guard = GuardSpec(
            policy=FencePolicy.BITWISE, vocab=FenceParams(0, pow2(cfg.vocab)),
            kv=kv, state=kv,
            expert=(FenceParams(0, pow2(cfg.moe.num_experts))
                    if cfg.moe else None),
            page=FenceParams(0, max_len // KV.PAGE_SIZE))
        cache = KV.with_slot_ids(
            api.init_cache(B, max_len, dtype=torch.float32, slots=slots,
                           device=device), slot_ids.to(device))
        cache, logits = api.prefill(p, cache, {"tokens": toks.to(device)},
                                    guard=guard)
        if device == "cuda":
            with uncounted():
                check_slab_view(torch, cfg, cache, guard)
        outs, ids = [logits.float().cpu()], [logits.argmax(-1).cpu()]
        nxt = logits.argmax(-1).to(torch.int32)
        for _ in range(steps):
            cache, logits = api.decode(p, cache, nxt, guard=guard)
            outs.append(logits.float().cpu())
            ids.append(logits.argmax(-1).cpu())
            nxt = logits.argmax(-1).to(torch.int32)
        return torch.stack(outs), torch.stack(ids)

    return run


def check_slab_view(torch, cfg, cache, guard):
    """K1 over a slab cache's flattened layer views, each layer, as the
    next decode step calls it: the ids of the step's
    :class:`SlabDecodePlan` (identity fence), lengths ``seq_lens + 1``
    (the write position clamped to the slab's last slot, as the hybrid's
    decode does), the config's window, an f32 query (the model's K/V, not
    random ones, so phase 2's bf16 control has no margin to break) —
    against the plain version within K1_F32_TOL, every page no row
    addresses clobbered (``check_paged_attention``).  A state pool alone
    holds no K/V and is skipped."""
    from repro_torch.models import kvcache as KV

    kv = getattr(cache, "kv", cache)
    if not hasattr(kv, "k"):
        return
    clamped = dataclasses.replace(
        kv, seq_lens=torch.clamp(kv.seq_lens, max=kv.max_len - 1))
    plan = KV.decode_plan(clamped, guard)
    lens = torch.clamp(kv.seq_lens + 1, max=kv.max_len)
    B = kv.slot_ids.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(99)
    zero = torch.zeros(B, dtype=torch.int32, device="cuda")
    for layer in range(kv.k.shape[0]):
        k_l, v_l = (x[layer].flatten(0, 1) for x in (kv.k, kv.v))
        q = torch.randn(B, cfg.n_heads, cfg.head_dim, generator=gen,
                        device="cuda")
        check_paged_attention(torch, q, k_l, v_l, plan.view_pages, lens,
                              zero, zero - 1, None, window=cfg.attn_window)


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

    cpu_params = tree_to(params, "cpu")
    run_slab = slab_full_width(torch, cfg, api)
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
    tol = 2e-3
    try:
        for layout, fn in (("paged", run), ("slab", run_slab)):
            margins.clear()
            card = fn("cuda", params)
            cpu = fn("cpu", cpu_params)
            margin = f"; smallest top-{cfg.moe.top_k} routing margin " \
                f"{min(float(m) for m in margins):.3g}" if margins else ""
            err = hold_card_vs_cpu(f"{layout} full width", card, cpu, tol,
                                   margin)
            log(f"full width x 2 layers (f32) [{cfg.name}, {layout}]: card "
                f"vs CPU greedy ids equal over prefill + 4 decodes, max "
                f"|logit err| {err:.3g} (tolerance {tol}){margin}")
    finally:
        MT._top_k = top_k


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
    meta = eng._cont_meta(rows)
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

    def forged(rows, lens=None):
        m = meta(rows, lens)
        at = [i for i, r in enumerate(rows)
              if r is not None and r.tenant == "forger"]
        table = m.page_table.clone()
        table[at] = torch.arange(vp.base, vp.base + table.shape[1],
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

#: the sampled runs' temperature and top-k
SAMPLED_T, SAMPLED_K = 0.7, 50


#: the first 16 uniforms and Gumbel values (float32 bits) of key
#: ``PRNGKey(2024)`` at shape (2, 8), as JAX's ``jax.random.uniform(key,
#: shape, minval=tiny)`` and ``jax.random.gumbel(key, shape)`` give them
#: (tests/test_torch_sampling.py records them from JAX)
KNOWN_KEY_SEED, KNOWN_SHAPE = 2024, (2, 8)
KNOWN_UNIFORM_BITS = (
    0x3d8f50b0, 0x3decf180, 0x3f5930a4, 0x3e30a378, 0x3f66fbee, 0x3f203300,
    0x3e306798, 0x3d9401b0, 0x3f30b7b2, 0x3f3ef54c, 0x3d285280, 0x3f6a63ea,
    0x3ecf7550, 0x3f2424a0, 0x3cb3da00, 0x3f0191c6)
KNOWN_GUMBEL_BITS = (
    0xbf7a690d, 0xbf44c496, 0x3fe7181a, 0xbf105643, 0x4011948e, 0x3f41f664,
    0xbf1087a8, 0xbf774a7e, 0x3f7e18c3, 0x3f9d13ae, 0xbf948eee, 0x401b68ac,
    0x3dd0118e, 0x3f4f99eb, 0xbfab82df, 0x3ec4bc86)


def words_f32(torch, words):
    """float32 values of 32-bit words (a CPU tensor)."""
    w = torch.tensor([x - (1 << 32) if x >= 1 << 31 else x for x in words],
                     dtype=torch.int32)
    return w.view(torch.float32)


def gumbel_ulps(torch, a, b) -> float:
    """The largest |a - b| in float32 ulps of the larger of |a|, |b| and 1
    (near G = 0 the outer log's argument sits near 1, whose ulp bounds a
    last-ulp ``log``)."""
    a, b = a.double().cpu(), b.double().cpu()
    scale = torch.maximum(torch.maximum(a.abs(), b.abs()),
                          torch.ones_like(a)).float()
    ulp = torch.nextafter(scale, torch.full_like(scale, math.inf)) - scale
    return float(((a - b).abs() / ulp.double()).max())


def check_draw(torch, cfg, device: str = "cuda"):
    """The draw is JAX's stream on the card: the known-answer vector (the
    first 16 uniforms exact, Gumbel values within 2 ulp of JAX's), and at
    the sampled step's shape (8 rows x the vocab) the card's uniforms
    bit-equal to the CPU's and its Gumbel noise within 2 ulp."""
    from repro_torch.launch import sampling as SA

    kt = SA.key_tensor(SA.key(KNOWN_KEY_SEED), device)
    u = SA.uniform(kt, KNOWN_SHAPE).cpu().reshape(-1)
    g = SA.gumbel(kt, KNOWN_SHAPE).cpu().reshape(-1)
    if not torch.equal(u, words_f32(torch, KNOWN_UNIFORM_BITS)):
        raise AssertionError(f"known-answer uniforms differ from JAX's: "
                             f"{u.tolist()}")
    known = gumbel_ulps(torch, g, words_f32(torch, KNOWN_GUMBEL_BITS))
    if known > 2:
        raise AssertionError(f"known-answer Gumbel values {known} ulp from "
                             "JAX's")
    shape = (8, cfg.vocab)
    _, sub = SA.split(SA.key(0x5EED))
    card = (SA.uniform(SA.key_tensor(sub, device), shape),
            SA.gumbel(SA.key_tensor(sub, device), shape))
    host = (SA.uniform(SA.key_tensor(sub, "cpu"), shape),
            SA.gumbel(SA.key_tensor(sub, "cpu"), shape))
    if not torch.equal(card[0].cpu(), host[0]):
        raise AssertionError(f"[{cfg.name}] the draw's uniforms differ card "
                             "vs CPU")
    drift = gumbel_ulps(torch, card[1], host[1])
    if drift > 2:
        raise AssertionError(f"[{cfg.name}] Gumbel noise {drift} ulp apart "
                             "card vs CPU")
    exact = float((card[1].cpu() == host[1]).double().mean())
    log(f"sampled draw [{cfg.name}]: known answer (PRNGKey({KNOWN_KEY_SEED})"
        f", {KNOWN_SHAPE}) — 16 uniforms = JAX's bit for bit, Gumbel within "
        f"{known:.0f} ulp of JAX's; at 8 x {cfg.vocab}: uniforms card = CPU "
        f"bit for bit, Gumbel within {drift:.0f} ulp ({exact:.1%} bit-equal)")


def check_sampled(torch, cfg, device: str = "cuda"):
    """Phase 3's size (float32, two layers, full width): a sampled engine
    (temperature 0.7, top-k 50) on the card and one on the CPU, with the
    same weights and seed, serve a trace on the paged continuous path to
    the same tokens — the draw is the same stream (JAX's) on both."""
    from repro_torch.launch.serve import ServeEngine, make_shared_manager

    check_draw(torch, cfg, device)
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    trace = [(f"t{i % 2}", [(13 * i + j) % 509 + 1 for j in range(7 + 3 * i)],
              i // 2) for i in range(6)]
    toks, params = {}, None
    for dev in (device, "cpu"):
        mgr = make_shared_manager(1, max_batch=8, max_len=256, paged=True,
                                  device=dev)
        eng = ServeEngine(cfg2, max_batch=8, max_len=256, manager=mgr,
                          paged=True, seed=0, device=dev,
                          temperature=SAMPLED_T, top_k=SAMPLED_K,
                          params=None if params is None
                          else tree_to(params, dev))
        params = eng.params if params is None else params
        for t in ("t0", "t1"):
            eng.register_tenant(t, 16)
        rids = [eng.submit(t, p, max_new=8, arrive=a) for t, p, a in trace]
        out = drive(eng, max_new_tokens=8)[0]
        toks[dev] = [out[r] for r in rids]
        spans_reconciled(mgr.telemetry, f"sampled [{cfg.name}] on {dev}")
    if toks[device] != toks["cpu"]:
        raise AssertionError(f"[{cfg.name}] sampled tokens card != CPU: "
                             f"{toks[device]} vs {toks['cpu']}")
    log(f"sampled [{cfg.name}] f32 x 2 layers, temperature {SAMPLED_T}, "
        f"top-k {SAMPLED_K}: {len(trace)} requests x 8 tokens, card = CPU "
        f"token for token ({sum(map(len, toks['cpu']))} tokens), compiled "
        "steps on both")


def spans_reconciled(tel, label: str) -> int:
    """Every request span of ``tel`` closed, terminal, its phase
    components summing to its end-to-end cycles; returns the count."""
    if tel.spans.open_count():
        raise AssertionError(f"{label}: {tel.spans.open_count()} spans "
                             "left open")
    for sp in tel.spans.closed:
        comps = sp.components()
        if sp.outcome not in ("complete", "evicted", "withdrawn") \
                or sum(comps.values()) != sp.e2e_cycles:
            raise AssertionError(f"{label}: span {sp.to_dict()} does not "
                                 "reconcile")
    return len(tel.spans.closed)


# --------------------------------------------------------------------- #
# Phase 3 (control plane): partitions, classes, spans and the violation  #
# log on the card against the CPU                                       #
# --------------------------------------------------------------------- #

def control_plane_run(torch, cfg2, device, params) -> dict:
    """One multi-tenant scenario on the paged continuous path (compiled
    steps): a latency-critical tenant arriving behind a best-effort flood
    (preempt and hold phases), a one-page tenant whose second and third
    requests stall on its extent, a request withdrawn before it ran, and
    two CHECK probe tenants whose fused launch is keyed while the
    violation log is full (4 rows); three more tenants grow the log to 8,
    the probes' fused launch runs again (a fresh graph: the key holds the
    log's identity) and then a forged launch of a best-effort tenant in a
    new row replays that graph — its counts land in its new row and its
    class's threshold quarantines it mid-run, closing its spans
    ``evicted``.  Returns what the card and the CPU are compared on."""
    from repro_torch.core import FencePolicy, TenantClassPolicy, \
        ThresholdPolicy
    from repro_torch.launch.serve import ServeEngine, make_shared_manager

    mgr = make_shared_manager(
        2, max_batch=2, max_len=256, paged=True, device=device,
        max_tenants=4,
        quarantine_policy=ThresholdPolicy(quarantine_after=1 << 30))
    eng = ServeEngine(cfg2, max_batch=2, max_len=256, manager=mgr,
                      paged=True, seed=0, device=device, params=params)
    eng.register_tenant("lc", 4, tenant_class=TenantClassPolicy
                        .latency_critical(queue_age_budget=2))
    probes = {t: mgr.register_tenant(t, 2, policy=FencePolicy.CHECK)
              for t in ("p0", "p1")}
    for c in probes.values():
        c.module_load("evil", evil)
    capacity = [mgr.violog.capacity, len(mgr.violog.tenants())]

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    def probe_launch(pairs):
        for t, target in pairs:
            mgr._clients[t].launch_kernel("evil", args=(i32(target), 2))

    lc_base = mgr.bounds.lookup("lc").base
    fused = mgr.scheduler._fused_cache
    graphs = [len(fused)]
    probe_launch([("p0", mgr.bounds.lookup("p0").base), ("p1", lc_base)])
    mgr.run_queued()
    graphs.append(len(fused))
    eng.register_tenant("be0", 1)
    eng.register_tenant("be1", 2)
    eng.register_tenant("rogue", 2, policy=FencePolicy.CHECK,
                        tenant_class=TenantClassPolicy.best_effort(
                            quarantine_after=1))
    mgr._clients["rogue"].module_load("evil", evil)
    capacity += [mgr.violog.capacity, mgr.violog.row_of("rogue")]
    prompts = [[(11 * i + 5 * j) % 487 + 1 for j in range(6 + 4 * (i % 3))]
               for i in range(9)]
    rids = {"be0": [eng.submit("be0", prompts[i], max_new=4)
                    for i in range(3)],
            "be1": [eng.submit("be1", prompts[3 + i], max_new=5)
                    for i in range(2)],
            "rogue": [eng.submit("rogue", prompts[5], max_new=6),
                      eng.submit("rogue", prompts[6], max_new=6, arrive=2)],
            "lc": [eng.submit("lc", prompts[7], max_new=3, arrive=1),
                   eng.submit("lc", prompts[8], max_new=3, arrive=3)]}
    late = eng.submit("be1", prompts[0], max_new=2, arrive=50)
    withdrawn = [eng.withdraw(late), eng.withdraw(late)]
    drains = {"n": 0}
    orig = mgr.run_queued

    def wrapped(*a, **k):
        res = orig(*a, **k)
        drains["n"] += 1
        if drains["n"] == 2:
            probe_launch([("p0", mgr.bounds.lookup("p0").base),
                          ("p1", lc_base)])
        elif drains["n"] == 3:
            graphs.append(len(fused))
            probe_launch([("p0", mgr.bounds.lookup("p0").base),
                          ("rogue", lc_base)])
        return res

    from repro_torch.launch.serve import serve_continuous
    mgr.run_queued = wrapped
    try:
        out = serve_continuous([eng], max_new_tokens=8)[0]
    finally:
        mgr.run_queued = orig
    graphs.append(len(fused))
    tel = mgr.telemetry
    n_spans = spans_reconciled(tel, f"control plane [{cfg2.name}] on "
                                    f"{device}")
    snap = mgr.violog.snapshot()
    return {
        "tokens": {t: [out.get(r) for r in rs] for t, rs in rids.items()},
        "drains": drains["n"], "withdrawn": withdrawn,
        "spans": [sp.to_dict() for sp in tel.spans.closed],
        "ledger": tel.spans.to_dict(), "n_spans": n_spans,
        "registry": tel.registry.snapshot(include_timing=False),
        "elastic": (list(mgr.elastic.events), dict(mgr.elastic.stats)),
        "violations": {t: mgr.violog.counts(t, snap=snap)
                       for t in sorted(mgr.violog.tenants())},
        "rows": {t: mgr.violog.row_of(t)
                 for t in sorted(mgr.violog.tenants())},
        "capacity": capacity, "graphs": graphs,
        "states": {t: mgr.quarantine.state_of(t).name
                   for t in ("lc", "be0", "be1", "rogue", "p0", "p1")}}


def check_control_plane(torch, cfg, device: str = "cuda"):
    """Phase 3's size (float32, two layers, full width, paged, compiled):
    :func:`control_plane_run` on the card and on the CPU with the same
    weights; tokens, drain cycles, every span and the ledger, the
    registry's logical snapshot, the elastic events and stats, the
    violation counts and rows must be equal, and the scenario's phases
    must all show."""
    from repro_torch.launch.serve import ServeEngine

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = ServeEngine(cfg2, max_batch=2, max_len=256, seed=0,
                         device=device, paged=True).params
    t0 = time.perf_counter()
    card = control_plane_run(torch, cfg2, device, params)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = control_plane_run(torch, cfg2, "cpu", tree_to(params, "cpu"))
    for key in card:
        if card[key] != cpu[key]:
            raise AssertionError(f"control plane [{cfg.name}]: {key} card "
                                 f"!= CPU: {card[key]} vs {cpu[key]}")
    comps = collections.Counter()
    for sp in card["spans"]:
        comps.update({k: v for k, v in sp["components"].items() if v})
    outcomes = collections.Counter(sp["outcome"] for sp in card["spans"])
    vio = card["violations"]
    want = {"preempt": comps["preempt"] > 0, "hold": comps["hold"] > 0,
            "stall": comps["stall"] > 0,
            "withdrawn": card["withdrawn"] == [True, False]
            and outcomes["withdrawn"] == 1,
            "evicted": outcomes["evicted"] == 2
            and card["states"]["rogue"] == "QUARANTINED",
            "grown": card["capacity"][:3] == [4, 4, 8]
            and card["capacity"][3] >= 4,
            "counts": vio["p1"]["scatter"] == 4
            and vio["rogue"]["scatter"] == 2 and vio["p0"]["scatter"] == 0,
            "replayed": card["graphs"] == [0, 1, 2, 2]}
    if not all(want.values()):
        raise AssertionError(f"control plane [{cfg.name}]: a phase did not "
                             f"show: {want}; {card}")
    log(f"control plane [{cfg.name}] f32 x 2 layers, paged, compiled: "
        f"{card['n_spans']} spans ({dict(outcomes)}), every one reconciled; "
        f"phases {dict(comps)}; violation log grown 4 -> 8 rows (the "
        f"forged launch's counts in row {card['rows']['rogue']}: "
        f"{vio['rogue']}), the fused CHECK key keyed anew after the growth "
        f"and replayed (fused graphs {card['graphs']}); {card['drains']} "
        "drain cycles; card = CPU in tokens, drain cycles, spans, ledger, "
        "registry, elastic events and violation counts; the card's run "
        f"{card_s:.2f} s")


def sampled_path(torch, cfg, params, trace, greedy, smi: str):
    """Phase 4's sampled run: the main path's trace at full depth on the
    greedy engine's weights, temperature 0.7 and top-k 50, served eager,
    compiled, and compiled on a second engine of the same seed — equal
    tokens from all three; every draw of the eager run inside its row's
    top k (a draw's logit at or above the row's k-th largest); the decode
    step's time beside the greedy run's."""
    from repro_torch.launch import sampling
    from repro_torch.launch.serve import ServeEngine, make_shared_manager, \
        serve_continuous

    real = sampling.sample
    inside = []

    def checked(logits, key, temperature, top_k=0):
        out = real(logits, key, temperature, top_k)
        lg = logits.float()
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1]
        inside.append((lg.gather(1, out.long()[:, None])[:, 0]
                       >= kth).all())
        return out

    runs = {}
    for name, compiled in (("eager", False), ("compiled", True),
                           ("compiled, a second engine", True)):
        mgr = make_shared_manager(1, max_batch=8, max_len=256, paged=True,
                                  jit_trusted=compiled)
        eng = ServeEngine(cfg, max_batch=8, max_len=256, manager=mgr,
                          paged=True, seed=0, params=params,
                          temperature=SAMPLED_T, top_k=SAMPLED_K)
        for t in range(3):
            eng.register_tenant(f"tenant{t}", 16)
        rids = [eng.submit(t, p, max_new=16, arrive=a) for t, p, a in trace]
        if not compiled:
            sampling.sample = checked
        try:
            with DispatchTimes(torch, eng) as times:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = serve_continuous([eng], max_new_tokens=16)[0]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            sampling.sample = real
        spans = spans_reconciled(mgr.telemetry, f"sampled [{cfg.name}, "
                                 f"{name}]")
        runs[name] = dict(tokens=[outs[r] for r in rids], spans=spans,
                          step_ms=times.read()[0], wall=wall,
                          step=eng._steps.decode_name)
        if name == "compiled, a second engine":
            # the sampled step's device time, profiled as the greedy one
            # is, and the draw's own at the step's shape
            step_ops = decode_step_ops(torch, serve_paged_on(eng))
            logits = torch.randn(8, cfg.vocab, device="cuda").to(
                eng.params["embed"]["table"].dtype)
            key = sampling.key_tensor(sampling.key(7), "cuda")
            draw_ops = profiled_call(torch, lambda: real(
                logits, key, SAMPLED_T, SAMPLED_K))
        del eng, mgr, times
        gc.collect()
        torch.cuda.empty_cache()
    toks = [r["tokens"] for r in runs.values()]
    if not (toks[0] == toks[1] == toks[2]):
        raise AssertionError(f"[{cfg.name}] sampled tokens differ between "
                             "eager, compiled and a second engine")
    if not inside or not bool(torch.stack(inside).all()):
        raise AssertionError(f"[{cfg.name}] a sampled token outside its "
                             f"row's top {SAMPLED_K}")
    n_tok = sum(map(len, toks[0]))
    same = sum(a == b for x, y in zip(toks[0], greedy["tokens"])
               for a, b in zip(x, y))
    med = statistics.median
    comp = runs["compiled"]
    log(f"sampled [{cfg.name}, {cfg.n_layers} layers, paged, "
        f"{comp['step'].split('[')[0]}, temperature {SAMPLED_T}, top-k "
        f"{SAMPLED_K}]: {len(trace)} requests x 16 tokens; eager, compiled "
        f"and a second compiled engine of one seed serve equal tokens; "
        f"{len(inside)} eager decode steps, every draw inside its row's top "
        f"{SAMPLED_K}; {same} of {n_tok} tokens equal the greedy run's; "
        f"every span of the three runs closed and reconciled "
        f"({sum(r['spans'] for r in runs.values())} spans); "
        f"decode step median {med(comp['step_ms']):.2f} ms compiled "
        f"(greedy {med(greedy['step_ms']):.2f} ms), "
        f"{med(runs['eager']['step_ms']):.2f} ms eager (greedy "
        f"{med(greedy['eager_step_ms']):.2f} ms); "
        f"{n_tok / comp['wall']:.1f} tokens/s compiled — {smi}")

    def ops(per):
        return "not measured (the profiler saw no device time)" \
            if per is None else f"{per[0]:.1f} device operations, " \
            f"{per[1]:.3f} ms of device time"
    log(f"sampled step profile [{cfg.name}, compiled]: a sampled decode "
        f"step {ops(step_ops)}; the greedy step {ops(greedy['step_ops'])} "
        "(each a step of one request, 8 rows); the draw alone "
        f"(launch.sampling.sample, 8 x {cfg.vocab} logits, eager) "
        f"{ops(draw_ops)} a call — {smi}")


def run_example(torch, cfg, params, smi: str):
    """Phase 7's line for ``repro_torch.examples.multi_tenant_serving`` at
    full width and depth on phase 4's weights: three slab engines, solo =
    co-located generations, a forged slot leaving the victim's KV rows as
    they were."""
    import contextlib
    import io
    from repro_torch.examples import multi_tenant_serving as MT

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = MT.main(["--full"], params=params)
    torch.cuda.synchronize()
    if not res["solo_identical"] or res["victim_changed"]:
        raise AssertionError(f"multi-tenant example: {res}")
    gens = res["generations"]
    log(f"multi-tenant example [{cfg.name}, {cfg.n_layers} layers, full "
        f"width, slab, compiled]: {len(gens)} tenants x "
        f"{len(next(iter(gens.values())))} tokens co-located, tenant0's "
        "generations alone identical, a forged slot at the victim's rows "
        "left its KV rows byte-identical; "
        f"{time.perf_counter() - t0:.1f} s — {smi}")


def decode_floor_bytes(params) -> int:
    """Bytes one decode step must read from device memory at least: every
    layer weight (the capacity dispatch multiplies every expert, tokens or
    not), the final norm and the LM head; the embedding table only for its
    8 rows, which are left out."""
    head = params["embed"].get("head", params["embed"]["table"])
    return (tree_bytes(params["layers"]) + tree_bytes(params["norm_f"])
            + tree_bytes(head))


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
    spans = spans_reconciled(mgr.telemetry, f"main path [{cfg.name}, "
                             f"{'compiled' if compiled else 'eager'}]")
    return {"tokens": tokens, "cycles": reg.counter("drain_cycles") - cycles0,
            "spans": spans,
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
        f"; per decode step: K3 1, K1 {L}{f', K5 {L}' if cfg.moe else ''}); "
        f"every request span closed and reconciled ({comp['spans']} spans "
        "after both runs: components sum to e2e, none open)")
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
    per = decode_step_ops(torch, serve_paged_on(eng))
    log(f"decode step ops [{cfg.name}, paged, compiled]: "
        + ("not measured (the profiler saw no device time)" if per is None
           else f"{per[0]:.1f} device operations, {per[1]:.2f} ms of "
                f"device time a step (one request); {smi}"))
    slab = None
    if cfg.moe is None:
        comp["eager_step_ms"] = eager["step_ms"]
        comp["step_ops"] = per
        sampled_path(torch, cfg, eng.params, trace, comp, smi)
        # full depth, the same weights and trace: the compiled run above
        # is the verify=False run the proven one must equal
        proof_phase(torch, cfg, smi, params=eng.params, reference=comp)
        # phase 7 on the same weights
        slab = run_slab_path(torch, cfg, eng.params, smi)
        run_example(torch, cfg, eng.params, smi)
    return {"launches": comp["launches"],
            "tokens_per_s": n_tok / comp["wall"], "slab": slab}


def serve_paged_on(eng):
    """``serve(n)`` for :func:`decode_step_ops`: one 12-token request
    served on ``eng`` for a prefill and ``n`` decode steps."""
    from repro_torch.launch.serve import serve_continuous

    def serve(n):
        eng.submit("tenant0", list(range(1, 13)), max_new=n + 1)
        serve_continuous([eng], max_new_tokens=n + 1)
    return serve


def profiled_call(torch, fn, n: int = 10):
    """Device operations and device ms of one call of ``fn``, from
    ``torch.profiler`` over ``n`` calls (after one unprofiled call), or
    None when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    ms = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in dev) / 1e3
    return (sum(e.count for e in dev) / n, ms / n) if ms else None


def decode_step_ops(torch, serve):
    """Device operations and device time of one compiled decode step, from
    ``torch.profiler``: ``serve(n)`` serves one 12-token request for a
    prefill and ``n`` decode steps (its graphs captured by a first,
    unprofiled call); the difference of the runs with 9 and 1 decode
    steps, over 8.  Returns (ops, device ms) per step, or None when the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    serve(1)
    torch.cuda.synchronize()
    got = []
    for n in (1, 9):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            serve(n)
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        got.append((sum(e.count for e in dev), sum(
            getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
            for e in dev) / 1e3))
    (o1, t1), (o9, t9) = got
    if not t9:
        return None
    return (o9 - o1) / 8, (t9 - t1) / 8


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
# Phase 7: slab lockstep serving through the command line               #
# --------------------------------------------------------------------- #

#: the four runs of the port's ``main`` at full width: the defaults'
#: trace, its eager twin, two co-hosted engines, mixed policies
SLAB_RUNS = (
    ("compiled", ["--tenants", "3", "--requests", "6", "--tokens", "16"]),
    ("eager", ["--tenants", "3", "--requests", "6", "--tokens", "16",
               "--no-jit"]),
    ("engines 2", ["--engines", "2", "--tenants", "1", "--requests", "2",
                   "--tokens", "16"]),
    ("modulo,check", ["--tenants", "3", "--requests", "6", "--tokens", "16",
                      "--policies", "modulo,check"]),
)


def drive_main(torch, cfg, argv, params):
    """One in-process run of ``repro_torch.launch.serve.main`` (``--arch``
    ``cfg.name``, on the card, ``params=`` the given weights).  Around its
    serving call: the kernels' counts set to 0 just before and read just
    after, the wall time, and — one engine — CUDA events around each
    decode step's dispatch.  Returns what the run printed and measured."""
    import contextlib
    import io
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as SV

    seen = {}
    serve_cli = SV.serve_cli

    def measured(args, engines):
        with contextlib.ExitStack() as hooks:
            if len(engines) == 1:
                seen["times"] = hooks.enter_context(
                    DispatchTimes(torch, engines[0]))
            torch.cuda.synchronize()
            _build.reset_counts()
            t0 = time.perf_counter()
            outs = serve_cli(args, engines)
            torch.cuda.synchronize()
            seen["wall"] = time.perf_counter() - t0
        seen["launches"] = {k.name: k.launches
                            for k in _build.KERNELS.values()}
        seen["plain"] = {k.name: k.plain_calls
                         for k in _build.KERNELS.values()}
        seen["engines"], seen["outs"] = engines, outs
        return outs

    out = io.StringIO()
    SV.serve_cli = measured
    try:
        with contextlib.redirect_stdout(out):
            SV.main(["--arch", cfg.name] + argv, params=params)
    finally:
        SV.serve_cli = serve_cli
    seen["printed"] = out.getvalue().splitlines()
    return seen


def check_slab_run(cfg, label, run, tokens: int = 16):
    """A slab run's gates: every request served ``tokens`` ids inside the
    vocab; K3, K4 and K1 launched exactly as the steps count them (K2 and
    K5 never: the slab write is plain PyTorch, the model dense), no plain
    version run on the card.  Returns (prefills, decode steps)."""
    engines, outs = run["engines"], run["outs"]
    for out in outs:
        for rid, toks in out.items():
            if len(toks) != tokens or not all(0 <= t < cfg.vocab
                                              for t in toks):
                raise AssertionError(f"slab [{label}] request {rid}: bad "
                                     f"tokens {toks}")
    n_pre = len(engines)
    n_dec = sum(e.decode_steps for e in engines)
    L = cfg.n_layers
    want = {"gather_rows": n_pre + n_dec, "flash_attention": L * n_pre,
            "paged_attention": L * n_dec, "scatter_pages": 0,
            "moe_histogram": 0}
    if run["launches"] != want:
        raise AssertionError(f"slab [{label}]: launches {run['launches']} "
                             f"differ from the per-step count {want}")
    if any(run["plain"].values()):
        raise AssertionError(f"slab [{label}]: plain versions ran on the "
                             f"card: {run['plain']}")
    return n_pre, n_dec


def slab_kernel_row(torch, cfg):
    """K1 over the slab layer view at the full-size slab path's shapes —
    8 rows, 16 slots of 4 pages (a (64, 64, KH, D) f32 view), a bf16
    query, the identity fence, ids ``slot * 4 + page`` of four rows on
    three tenants' slots and four rows parked on the scratch slot 0, 28
    held tokens (a 12-token prompt and 16 steps) — checked and timed as
    phase 2's rows, the bound counting the scratch slot's tokens once."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.launch.graph_analysis import paged_attention_cost

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(2024)
    B, H, KH, D, page, P = 8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        64, 4
    i32 = dict(dtype=torch.int32, device=dev)
    k_view = torch.randn(16 * P, page, KH, D, generator=gen, device=dev)
    v_view = torch.randn(16 * P, page, KH, D, generator=gen, device=dev)
    q = torch.randn(B, H, D, generator=gen, device=dev).to(torch.bfloat16)
    slots = torch.tensor([8, 10, 12, 9, 0, 0, 0, 0], **i32)
    ids = slots[:, None] * P + torch.arange(P, **i32)[None, :]
    lens = torch.full((B,), 28, **i32)
    zero = torch.zeros(B, **i32)
    chk = check_paged_attention(torch, q, k_view, v_view, ids, lens, zero,
                                zero - 1, None)
    call = (lambda: paged_attention(q, k_view, v_view, ids, lens, 0, -1))
    # bytes: the four rows on the scratch slot read its tokens once
    pairs, k_tok, v_tok = k1_held(ids, lens, page)
    cost = paged_attention_cost(q, k_view, ids, positions=pairs,
                                k_tokens=k_tok, v_tokens=v_tok)
    return dict(
        kernel="paged_attention", path=f"{cfg.name}/slab", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/fenced_paged_attention.py:173",
        max_abs_err=chk["err"],
        tolerance=f"1/2 bf16 ulp + {K1_SLACK:g} of the f32 plain version "
                  f"on bf16-rounded K/V (worst error/bound "
                  f"{chk['ratio']:.3f}; control {chk['ctrl_ratio']:.3g})",
        ms=cuda_ms(torch, call),
        plain_ms=cuda_ms(torch, lambda: ref.paged_attention_ref(
            q, k_view, v_view, ids, lens, zero, zero - 1)),
        library_ms=None, library_call=None,
        shape=f"q ({B},{H},{D}) bf16, slab view ({16 * P},{page},{KH},{D})"
              " f32, identity fence",
        **rule_bound(cost, "float32"))


def run_slab_path(torch, cfg, params, smi: str) -> dict:
    """Phase 7: the port's ``main`` at full width and depth on phase 4's
    weights, four runs (``SLAB_RUNS``): compiled and eager give equal
    tokens, decode steps and launches; two engines fuse each lockstep into
    one device step, with one graph for the decode; every run's kernel
    launches equal its per-step count.  Then a forged slot id aimed at a
    co-tenant's extent leaves the co-tenant's slots byte-equal.  Prints
    the decode-step times, tokens/s and graphs; returns the compiled
    run's launches and the K1 slab-view row."""
    runs = {}
    for label, argv in SLAB_RUNS:
        run = runs[label] = drive_main(torch, cfg, argv, params)
        n_pre, n_dec = check_slab_run(cfg, label, run)
        mgr = run["engines"][0].manager
        st = mgr.scheduler.stats
        graphs = mgr.jit_cache_stats()
        n_tok = sum(len(t) for out in run["outs"] for t in out.values())
        line = (f"slab [{cfg.name}, {label}]: {n_tok} tokens from "
                f"{sum(len(o) for o in run['outs'])} requests, {n_pre} "
                f"prefill(s), {n_dec} decode steps, "
                f"{int(st.total_launches)} scheduler launches, mean step "
                f"width {st.mean_batch_width:.1f}, fused steps "
                f"{st.fused_steps}; launches {run['launches']}; "
                f"{n_tok / run['wall']:.1f} tokens/s ({run['wall']:.2f} s); "
                f"graphs {graphs['graphs']} (fused {graphs['fused_entries']})"
                f", {graphs['graph_capture_s']:.2f} s capturing")
        if "times" in run:
            ms, cap, host, _ = run["times"].read()
            if ms:
                line += (f"; decode step median {statistics.median(ms):.2f}"
                         f" ms, min {ms[0]:.2f}, max {ms[-1]:.2f} over "
                         f"{len(ms)} steps")
            if cap:
                line += f"; first (warm-up + capture) {cap[0]:.2f} ms"
            line += f"; host wall of a dispatch median {host:.2f} ms"
        log(line + f"; {smi}")
        log(f"  printed: {run['printed'][-1]}")
        if label == "engines 2":
            if st.fused_steps != 1 + 16 or st.single_steps:
                raise AssertionError(
                    f"slab [engines 2]: {st.fused_steps} fused and "
                    f"{st.single_steps} single steps, want 17 and 0")
            if graphs["fused_entries"] != 2:
                raise AssertionError(
                    f"slab [engines 2]: {graphs['fused_entries']} fused "
                    "graphs, want 2 (the prefill's and one decode's)")
    comp, eager = runs["compiled"], runs["eager"]
    for key in ("outs", "launches"):
        if comp[key] != eager[key]:
            raise AssertionError(f"slab: compiled {key} differ from eager: "
                                 f"{comp[key]} vs {eager[key]}")
    if [e.decode_steps for e in comp["engines"]] != \
            [e.decode_steps for e in eager["engines"]]:
        raise AssertionError("slab: compiled decode steps differ from eager")
    same = comp["outs"] == runs["modulo,check"]["outs"]
    log(f"slab [{cfg.name}]: compiled and eager runs equal (tokens, decode "
        f"steps, launches); the modulo,check run gives "
        f"{'the same' if same else 'other'} tokens as the BITWISE run")

    # a forged slot id: a request of tenant1 aimed at tenant0's slots
    eng = comp["engines"][0]
    victim = eng.manager.bounds.lookup("tenant0")
    kept = [eng._pool.buf[n][:, victim.base:victim.end].clone()
            for n in ("k", "v")]
    if not any(bool((t != 0).any()) for t in kept):
        raise AssertionError("slab: tenant0's slots hold nothing to guard")
    rid = eng.submit("tenant1", list(range(1, 13)))
    req = next(r for r in eng._requests if r.rid == rid)
    req.slot = victim.base
    out = eng.run(max_new_tokens=4)
    for n, before in zip(("k", "v"), kept):
        if not torch.equal(eng._pool.buf[n][:, victim.base:victim.end],
                           before):
            raise AssertionError(f"slab: a forged slot id wrote tenant0's "
                                 f"{n} slots")
    if len(out.get(rid, [])) != 4:
        raise AssertionError(f"slab: the forged request served {out}")
    log(f"slab [{cfg.name}]: a request of tenant1 with its slot forged to "
        f"tenant0's base {victim.base} served 4 tokens (compiled) and left "
        f"tenant0's {victim.size} slots byte-equal across all "
        f"{cfg.n_layers} layers")

    def serve_slab(n):
        eng.submit("tenant2", list(range(1, 13)))
        eng.run(max_new_tokens=n)

    per = decode_step_ops(torch, serve_slab)
    log(f"decode step ops [{cfg.name}, slab, compiled]: "
        + ("not measured (the profiler saw no device time)" if per is None
           else f"{per[0]:.1f} device operations, {per[1]:.2f} ms of "
                f"device time a step (one request); {smi}"))
    launches = comp["launches"]
    del runs, run, comp, eager, eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "row": slab_kernel_row(torch, cfg)}


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

    # an engine of an earlier phase that only the cyclic collector frees
    # goes now, not while a proof is watched for allocations
    gc.collect()
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
    """An unfenced launcher's calls (:class:`Unfenced`,
    :class:`StructUnfenced`) captured by this script into one CUDA graph
    per (op, tenants), replayed from the second call on — the compiled
    unfenced baseline the compiled policies are read against.
    The first call runs them eagerly on a side stream (cuBLAS and cuFFT
    set up there), then captures.  The graphs share one memory pool
    (their replays run one after the other, and nothing they compute is
    read); the pointers are constants of a graph, as these tenants never
    move."""

    def __init__(self, torch, eager):
        self.torch, self.eager = torch, eager
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


def tenant_plane(torch, sz=None, device: str = "cuda", smi: str = "",
                 ss=None, nested: bool = True):
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
    and a NONE graph never outlives a second tenant's arrival; then the
    structural kernels (:func:`structural_plane`).  Prints the
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
                    else CapturedUnfenced(torch, Unfenced(card))
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
    structural_plane(torch, sz, device, smi, ss, nested)
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


# --------------------------------------------------------------------- #
# Phase 5 (structural): tenant kernels with a while_loop, a scan, a cond #
# --------------------------------------------------------------------- #

#: the structural kernels' sizes on the card: a list of ``list`` nodes
#: walked by a while_loop (its trip count is the arena's data; at most
#: ``cap`` hops), a scan over ``chunks`` chunks of ``chunk`` slots of
#: BLAS-1, and a cond storing ``cond`` slots in one branch
STRUCT_SIZES = dict(list=256, cap=1024, chunks=16, chunk=1 << 16,
                    cond=1 << 16)


def st_chase(arena, lst, cap, n: int):
    """A ``while_loop`` walking a list: node k holds the next node's
    index at lst + k (-1 ends the list), each visit is marked at
    lst + n + k; at most ``cap`` hops."""
    import torch
    from torch._higher_order_ops.while_loop import while_loop

    def cond(a, k, h):
        return (k >= 0) & (h < cap)

    def body(a, k, h):
        p = (lst + k).reshape(1)
        nxt = a.index_select(0, p)[0].to(torch.int32)
        a = a.index_put((p + n,), (h + 1).to(a.dtype).reshape(1))
        return a, nxt, h + 1

    zero = torch.zeros((), dtype=torch.int32, device=arena.device)
    a, _, h = while_loop(cond, body, (arena, zero.clone(), zero))
    return a, h


def st_axpy(arena, x, y, alpha, chunks: int, c: int):
    """A ``scan`` over ``chunks`` chunks of ``c`` slots: y += alpha * x in
    place (the arena carried), each chunk's dot stacked, their sum
    carried."""
    import torch
    from torch._higher_order_ops.scan import scan

    def body(carry, j):
        a, acc = carry
        idx = j * c + torch.arange(c, dtype=torch.int32, device=a.device)
        xv = a.index_select(0, x + idx)
        yv = a.index_select(0, y + idx)
        d = torch.dot(xv, yv)
        return (a.index_put((y + idx,), alpha * xv + yv), acc + d), d

    (a, acc), ys = scan(body, (arena, torch.zeros((), device=arena.device)),
                        torch.arange(chunks, dtype=torch.int32,
                                     device=arena.device))
    return a, (acc, ys)


def st_store(arena, p, flag, n: int):
    """A ``cond`` that stores 7.0 at p .. p + n in its true branch only."""
    import torch

    def store(a, q):
        idx = q + torch.arange(n, dtype=torch.int32, device=a.device)
        return a.index_put((idx,), torch.full((n,), 7.0, device=a.device))

    return torch.cond(flag > 0, store, lambda a, q: a.clone(),
                      (arena, p)), None


def st_nested(arena, p, n: int):
    """A ``cond`` nested in a ``while``: over k < n, 1.0 stored at
    p + n + k where the slot p + k is positive."""
    import torch
    from torch._higher_order_ops.while_loop import while_loop

    def cond(a, k):
        return k < n

    def body(a, k):
        v = a.index_select(0, (p + k).reshape(1))[0]

        def mark(a, k):
            return a.index_put(((p + n + k).reshape(1),),
                               torch.ones(1, device=a.device))

        return torch.cond(v > 0, mark, lambda a, k: a.clone(), (a, k)), \
            k + 1

    zero = torch.zeros((), dtype=torch.int32, device=arena.device)
    return while_loop(cond, body, (arena, zero))[0], None


def many_conditional_nodes(torch, device: str, keys: int = 16):
    """One manager captures the ``cond``-in-``while`` kernel under
    ``keys`` operand signatures (its static length), fenced by BITWISE:
    a graph each, with a ``while`` node and two ``if`` nodes nested in its
    body — 3 * keys conditional nodes, more than torch's pool of 32
    streams, each body captured while the manager's own capture stream
    is capturing.  Each key is captured, then replayed on other data, and
    the buffer held against the CPU's after every launch."""
    import numpy as np
    from repro_torch.core import FencePolicy, GuardianManager
    from repro_torch.core.stepgraph import StepGraph
    rnd = np.random.default_rng(3)
    planes = []
    for dev in (device, "cpu"):
        mgr = GuardianManager(total_slots=1 << 16,
                              policy=FencePolicy.BITWISE, device=dev)
        c = mgr.register_tenant("t0", 1 << 12)
        # an idle co-tenant: t0 runs fenced, not on the native fast path
        mgr.register_tenant("t1", 1 << 12)
        c.module_load("nested", st_nested)
        planes.append((mgr, c, c.malloc(4 * keys)))
    for n in range(1, keys + 1):
        for _ in range(2):     # captured, then replayed on other signs
            signs = np.where(rnd.random(4 * keys) > 0.5, 1.0,
                             -1.0).astype(np.float32)
            got = []
            for mgr, c, buf in planes:
                c.memcpy_h2d(buf, signs)
                c.launch_kernel("nested", ptrs=[buf], args=(n,))
                mgr.synchronize()
                got.append(mgr.arena.unsafe_read_range(
                    buf.addr, buf.length).cpu())
            if not torch.equal(*got):
                raise AssertionError(f"nested conditional nodes: key {n} "
                                     "card != CPU")
    mgr = planes[0][0]
    graphs = [g for cache in [mgr.scheduler._fused_cache] + [
        e.jit_cache for e in mgr.pointer_to_symbol.values()]
        for g in cache.values() if isinstance(g, StepGraph)]
    if len(graphs) != keys or (device == "cuda" and not all(
            g.graph is not None and g.replays for g in graphs)):
        raise AssertionError(f"nested conditional nodes: {len(graphs)} "
                             f"graphs, want {keys}, each replayed")
    log(f"  nested conditional nodes: one manager, {keys} keys of a cond "
        f"inside a while_loop under BITWISE ({3 * keys} conditional nodes, "
        "two nesting depths), each captured then replayed, card = CPU "
        "after every launch")


def st_lists(ss, n_t, rnd):
    """Each tenant's list: a walk over a random order of ``length`` of the
    ``list`` nodes from node 0; returns the next-pointer arrays."""
    import numpy as np
    out = []
    for t in range(n_t):
        length = int(rnd.integers(ss["list"] // 4, ss["list"]))
        order = rnd.permutation(np.arange(1, ss["list"]))[:length - 1]
        nxt = np.zeros(ss["list"], np.float32)
        prev = 0
        for k in order:
            nxt[prev] = k
            prev = int(k)
        nxt[prev] = -1
        out.append(nxt)
    return out


class StructPlane:
    """Phase 5's structural plane: one manager of a policy with the
    tenant phase's arena and tenants, each tenant's list, x, y and store
    buffers uploaded through ``memcpy_h2d``."""

    def __init__(self, torch, policy: str, device: str, sz, ss):
        import numpy as np
        from repro_torch.core import FencePolicy, GuardianManager, \
            ThresholdPolicy
        self.torch, self.sz, self.ss = torch, sz, ss
        self.mgr = GuardianManager(
            total_slots=sz["arena"], policy=(
                FencePolicy.BITWISE if policy == "none"
                else FencePolicy(policy)), device=device,
            quarantine_policy=ThresholdPolicy(quarantine_after=1 << 40))
        n_t = 1 if policy == "none" else sz["tenants"]
        rnd = np.random.default_rng(99)
        m = ss["chunks"] * ss["chunk"]
        self.clients, self.ptrs = [], []
        for t, nxt in enumerate(st_lists(ss, n_t, rnd)):
            c = self.mgr.register_tenant(f"t{t}", sz["arena"] // sz["tenants"])
            for name, fn in (("chase", st_chase), ("axpy", st_axpy),
                             ("store", st_store)):
                c.module_load(name, fn)
            p = {"lst": c.malloc(2 * ss["list"]), "x": c.malloc(m),
                 "y": c.malloc(m), "s": c.malloc(ss["cond"])}
            c.memcpy_h2d(p["lst"], nxt)
            c.memcpy_h2d(p["x"], rnd.random(m, np.float32))
            c.memcpy_h2d(p["y"], rnd.random(m, np.float32))
            self.clients.append(c)
            self.ptrs.append(p)
        self.mgr.synchronize()

    def ops(self, flag: int = 1):
        torch, ss = self.torch, self.ss
        return [
            ("chase", (("lst",), (torch.tensor(ss["cap"], dtype=torch.int32),
                                  ss["list"]))),
            ("axpy", (("x", "y"), (torch.tensor(2.0), ss["chunks"],
                                   ss["chunk"]))),
            ("store", (("s",), (torch.tensor(flag, dtype=torch.int32),
                                ss["cond"]))),
        ]

    def launch(self, op, tenants, forged=None):
        """``op`` by each of ``tenants``, then a drain; ``forged`` (tenant,
        address) aims that tenant's stored-to pointer (axpy's y, the
        store's) at the address.  Returns the requests."""
        name, (keys, args) = op
        reqs = []
        for t in tenants:
            c, p = self.clients[t], self.ptrs[t]
            if forged is not None and forged[0] == t and name != "chase":
                addr = self.torch.tensor(forged[1], dtype=self.torch.int32)
                reqs.append(c.launch_kernel(
                    name, ptrs=[p[j] for j in keys[:-1]],
                    args=(addr, *args)))
                continue
            reqs.append(c.launch_kernel(name, ptrs=[p[j] for j in keys],
                                        args=args))
        self.mgr.run_queued()
        return reqs

    def set_list(self, t, nxt):
        self.clients[t].memcpy_h2d(self.ptrs[t]["lst"], nxt)
        self.mgr.synchronize()

    def read(self, t, key, n=None):
        p = self.ptrs[t][key]
        return self.mgr.arena.unsafe_read_range(
            p.addr, p.length if n is None else n)

    def partition(self, t):
        part = self.mgr.bounds.lookup(f"t{t}")
        return self.mgr.arena.buf[part.base:part.end]


def _walk(nxt, cap):
    """The hops a list walk makes on the host (the trip count)."""
    k, h = 0, 0
    while k >= 0 and h < cap:
        k, h = int(nxt[k]), h + 1
    return h


class StructUnfenced:
    """The structural kernels' memory operations with no sandbox — no
    fence, no guard, no conditional node: each loop unrolled on the host to
    the trip count it takes on the plane's data (the list's walk, the
    scan's chunks, the branch taken).  Captured by
    :class:`CapturedUnfenced`, the baseline the compiled policies'
    structural launches are read against."""

    def __init__(self, torch, plane):
        self.torch, self.plane = torch, plane

    def launch(self, op, tenants):
        torch, plane, ss = self.torch, self.plane, self.plane.ss
        arena = plane.mgr.arena.buf
        dev = arena.device
        for t in tenants:
            p = {k: v.addr for k, v in plane.ptrs[t].items()}
            if op[0] == "chase":
                k = torch.zeros(1, dtype=torch.int32, device=dev)
                for h in range(plane.hops[t]):
                    q = p["lst"] + k
                    nxt = arena.index_select(0, q)
                    arena.index_put_((q + ss["list"],), torch.full(
                        (1,), float(h + 1), device=dev))
                    k = nxt.to(torch.int32)
            elif op[0] == "axpy":
                c = ss["chunk"]
                ii = torch.arange(c, dtype=torch.int32, device=dev)
                ds = []
                for j in range(ss["chunks"]):
                    xv = arena.index_select(0, p["x"] + j * c + ii)
                    yv = arena.index_select(0, p["y"] + j * c + ii)
                    ds.append(torch.dot(xv, yv))
                    arena.index_put_((p["y"] + j * c + ii,), 2.0 * xv + yv)
                torch.stack(ds).sum()
            else:
                arena.index_put_((p["s"] + torch.arange(
                    ss["cond"], dtype=torch.int32, device=dev),),
                    torch.full((ss["cond"],), 7.0, device=dev))


def _struct_results(plane, reqs_by_op):
    out = {}
    for t in range(len(plane.clients)):
        out[f"lst{t}"] = plane.read(t, "lst")
        out[f"y{t}"] = plane.read(t, "y")
        out[f"s{t}"] = plane.read(t, "s")
    for name, reqs in reqs_by_op.items():
        for i, r in enumerate(reqs):
            if name == "chase":
                out[f"chase.hops{i}"] = r.result
            elif name == "axpy":
                out[f"axpy.acc{i}"], out[f"axpy.ys{i}"] = r.result
    return out


def structural_plane(torch, sz=None, device: str = "cuda", smi: str = "",
                     ss=None, nested: bool = True):
    """Phase 5's structural kernels at the tenant phase's size (a 1 GiB
    arena, four tenants of 2**26 slots): a ``while_loop`` list walk whose
    trip count is the arena's data, a ``scan`` over BLAS-1 chunks and a
    ``cond`` that stores in one branch, under NONE, BITWISE, MODULO and
    CHECK, solo and four-wide, each round captured then replayed on
    other lists (other trip counts) and the other branch, every launch a
    replay of the manager's graphs with conditional nodes, card = CPU;
    then a forged pointer inside each body (the list's last node, axpy's
    y, the store's address) solo and four-wide: the other partitions
    keep their bytes, the forger's stores wrap into its own partition or,
    under CHECK, roll back exactly and are counted.  Prints each kernel's
    device and wall time a round over the unfenced kernels unrolled and
    captured by this script, and over NONE.  Then, with ``nested``,
    :func:`many_conditional_nodes` (``main`` runs it in a process of its
    own, beside phase 12's)."""
    import numpy as np
    from repro_torch.core.stepgraph import StepGraph
    sz = dict(TENANT_SIZES if sz is None else sz)
    ss = dict(STRUCT_SIZES if ss is None else ss)
    t_start = time.perf_counter()
    log(f"structural tenant kernels: while_loop list walk of up to "
        f"{ss['list']} nodes (cap {ss['cap']} hops), scan over "
        f"{ss['chunks']} x {ss['chunk']} slots of axpy + dot, cond storing "
        f"{ss['cond']} slots; {sz['arena'] * 4 / 2**20:.0f} MB arena, "
        f"{sz['tenants']} tenants ({smi})")
    ladder = {}
    for policy in TENANT_POLICIES:
        card = StructPlane(torch, policy, device, sz, ss)
        cpu = StructPlane(torch, policy, "cpu", sz, ss)
        n_t = len(card.clients)
        rounds = (("solo", [0]), ("x4", list(range(n_t)) if n_t > 1
                                   else [0, 0, 0, 0]))
        rnd = np.random.default_rng(5)
        worst = 0.0
        for label, tenants in rounds:
            for rep in range(2):
                if rep:      # other lists, so the replay walks other counts
                    for t, nxt in enumerate(st_lists(ss, n_t, rnd)):
                        card.set_list(t, nxt)
                        cpu.set_list(t, nxt)
                res = [{op[0]: plane.launch(op, tenants)
                        for op in plane.ops(flag=1 - rep)}
                       for plane in (card, cpu)]
                worst = max(worst, _compare(
                    torch, _struct_results(card, res[0]),
                    _struct_results(cpu, res[1]),
                    f"structural {policy} {label}"))
        graphs = [g for cache in [card.mgr.scheduler._fused_cache] + [
            e.jit_cache for e in card.mgr.pointer_to_symbol.values()]
            for g in cache.values() if isinstance(g, StepGraph)]
        if device == "cuda" and not all(g.graph is not None and g.replays
                                        for g in graphs):
            raise AssertionError(f"structural {policy}: a launch ran "
                                 "outside a replayed CUDA graph")
        log(f"  [{policy}] structural card = CPU, each round captured then "
            f"replayed on other lists and the other branch: floats within "
            f"{worst:.3g} normwise, lists, marks, axpy's y and the stores "
            f"exact; {len(graphs)} graphs, each replayed "
            f"({sum(g.replays for g in graphs)} replays)")
        if policy != "none":
            # before the timing rounds, which run on the card alone
            _struct_isolation(torch, card, cpu, policy, ss)
        if device == "cuda":
            card.hops = [_walk(card.read(t, "lst", ss["list"]).cpu()
                               .numpy(), ss["cap"]) for t in range(n_t)]
            bases = [("captured", CapturedUnfenced(
                torch, StructUnfenced(torch, card)))] \
                if policy == "none" else []
            for base, plane in bases + [(policy, card)]:
                for label, tenants in rounds:
                    for op in card.ops():
                        t = _time_op(torch, plane, op, tenants)
                        ladder[(base, label, op[0])] = t
                        log(f"  [{base}] {op[0]:6s} {label:4s}: device "
                            f"{t['dev']:.4f} ms, wall {t['wall']:.4f} ms, "
                            f"kernels {t['busy']:.4f} ms in {t['ops']:g} "
                            "device ops a round")
        del card, cpu
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    if ladder:
        for over in ("captured", "none"):
            for key in ("dev", "wall"):
                log(f"  structural ladder ({key} / {over}'s; {smi}):")
                for row in ("none", "bitwise", "modulo", "check"):
                    if row == over:
                        continue
                    ratio = {(lb, op): ladder[(row, lb, op)][key]
                             / ladder[(over, lb, op)][key]
                             for lb in ("solo", "x4")
                             for op in ("chase", "axpy", "store")}
                    log(f"    {row:8s} " + ", ".join(
                        f"{op} {r:.2f}x ({lb})"
                        for (lb, op), r in ratio.items()))
    if nested:
        many_conditional_nodes(torch, device)
    log(f"structural tenant kernels: ok in "
        f"{time.perf_counter() - t_start:.1f} s")


def _struct_isolation(torch, card, cpu, policy, ss):
    """The forged pointers inside the bodies: the rogue's list ends in a
    node pointing at t0's list, its axpy's y and its store's address are
    t0's buffers.  Solo: every other partition keeps its bytes; under
    CHECK the rogue's too (its stores rolled back), elsewhere its stores
    land in its own partition.  Four-wide: the card's arena equals the
    CPU's, and t0's buffers hold exactly its own round's stores."""
    import numpy as np
    n_t = len(card.clients)
    rogue = n_t - 1
    victim = {k: card.ptrs[0][k].addr for k in ("lst", "y", "s")}
    counts0 = card.mgr.violog.counts(f"t{rogue}")["scatter"]
    for plane in (card, cpu):
        nxt = plane.read(rogue, "lst", ss["list"]).cpu().numpy().copy()
        last = int(np.nonzero(nxt == -1)[0][0])
        nxt[last] = victim["lst"] - plane.ptrs[rogue]["lst"].addr
        plane.set_list(rogue, nxt)
    for label, tenants in (("solo", [rogue]), ("x4", list(range(n_t)))):
        snaps = {id(p): [p.partition(t).clone() for t in range(n_t)]
                 for p in (card, cpu)}
        before = {k: card.read(0, k).clone() for k in ("lst", "x", "y")}
        for plane in (card, cpu):
            for op in plane.ops(flag=1):
                target = victim["y"] if op[0] == "axpy" else victim["s"]
                plane.launch(op, tenants, forged=(rogue, target))
            plane.mgr.synchronize()
        for t in range(n_t):
            if not torch.equal(card.partition(t).cpu(), cpu.partition(t)):
                raise AssertionError(f"structural {policy} forged {label}: "
                                     f"t{t}'s partition card != CPU")
        for plane in (card, cpu):
            snap = snaps[id(plane)]
            for t in range(n_t):
                same = torch.equal(plane.partition(t), snap[t])
                if label == "solo" and (t != rogue or policy == "check") \
                        and not same:
                    raise AssertionError(
                        f"structural {policy} forged solo "
                        f"({plane.mgr.device}): t{t}'s partition changed")
        if label == "x4":
            y = card.read(0, "y").cpu()
            want = before["y"].cpu() + 2.0 * before["x"].cpu()
            s = card.read(0, "s").cpu()
            if not (torch.equal(y, want) and bool((s == 7.0).all())):
                raise AssertionError(f"structural {policy} forged x4: t0's "
                                     "y or store buffer holds the rogue's "
                                     "stores")
    counts = card.mgr.violog.counts(f"t{rogue}")
    if counts != cpu.mgr.violog.counts(f"t{rogue}"):
        raise AssertionError(f"structural {policy}: ViolationLog rows "
                             "differ card vs CPU")
    caught = counts["scatter"] - counts0
    if policy == "check" and not caught:
        raise AssertionError("structural check: the forged stores were not "
                             "counted")
    log(f"  [{policy}] structural forged pointers of t{rogue} (its list's "
        "last node at t0's list, its axpy's y and its store at t0's "
        "buffers), solo and four-wide, replays, card = CPU byte for byte: "
        + ("its stores rolled back exactly (its partition byte-identical), "
           f"{caught} stores counted" if policy == "check" else
           "its stores wrapped into its own partition")
        + "; the other partitions keep their bytes, t0's buffers hold only "
        "its own stores")


# --------------------------------------------------------------------- #
# Phase 2 (recurrent families) and phase 8: the recurrent families      #
# --------------------------------------------------------------------- #

#: the recurrent families' paths: zamba2-7b (hybrid: Mamba2 blocks and a
#: shared, windowed attention block) and xlstm-350m (ssm: mLSTM / sLSTM)
RECURRENT = ("zamba2-7b", "xlstm-350m")


def recurrent_card_vs_cpu(torch, cfg, label, prompt: int, steps: int,
                          tol: float):
    """Phase 8 (a) / (b): ``cfg`` (float32) through phase 3's slab run
    (:func:`slab_full_width`, a ``prompt``-token prefill and ``steps``
    greedy decode steps) on the card through the kernels and on the CPU
    through the plain versions, from the same weights (drawn on the CPU,
    copied to the card): greedy ids equal, logits within ``tol``, and the
    kernels the card ran counted (no plain version)."""
    from repro_torch.kernels import _build
    from repro_torch.models import get_model

    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(11), "cpu")
    run = slab_full_width(torch, cfg, api, S=prompt, steps=steps)
    _build.reset_counts()
    card = run("cuda", tree_to(params, "cuda"))
    launches = {k.name: k.launches for k in _build.KERNELS.values()}
    plain = sum(k.plain_calls for k in _build.KERNELS.values())
    err = hold_card_vs_cpu(label, card, run("cpu", params), tol)
    if plain:
        raise AssertionError(f"{label}: {plain} plain calls on the card")
    want = {"gather_rows": 1 + steps}
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.attn_every
        want.update(flash_attention=g, paged_attention=g * steps)
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    log(f"{label} [{cfg.name}, {cfg.n_layers} layers, d {cfg.d_model}, "
        f"f32]: card vs CPU greedy ids equal over a {prompt}-token prefill "
        f"+ {steps} decodes of 8 rows, max |logit err| {err:.3g} (tolerance "
        f"{tol}); launches on the card {want}"
        + (f" (window {cfg.attn_window})" if cfg.attn_window else ""))


def recurrent_floor_bytes(eng) -> dict:
    """The bytes one decode step of ``eng`` must move at least: every
    weight it reads once per use (the hybrid's shared block once per
    invocation), the final norm and the LM head (the embedding's 8 rows
    left out); and each row's state read and written (SSM / conv, or the
    mLSTM / sLSTM state) — the K/V history of the shared block is left
    out (at most 80 tokens a row)."""
    p, cfg = eng.params, eng.cfg
    head = p["embed"].get("head", p["embed"]["table"])
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.attn_every
        weights = (tree_bytes(p["mamba"]) + tree_bytes(p.get("mamba_tail",
                                                            []))
                   + g * tree_bytes(p["shared_attn"]))
        pools = eng._pool.buf["state"]["pools"]
    else:
        weights = tree_bytes(p["mlstm"]) + tree_bytes(p["slstm"])
        pools = eng._pool.buf["pools"]
    state = sum(2 * eng.max_batch * t[:, 0].numel() * t.element_size()
                for t in pools.values())
    return {"weights": weights + tree_bytes(p["norm_f"]) + tree_bytes(head),
            "state": state}


def recurrent_serve(torch, cfg, smi: str):
    """Phase 8 (c): ``cfg`` at full width and depth through a slab
    ``ServeEngine`` (``max_batch`` 8, ``max_len`` 256, a 16-slot f32 pool,
    3 tenants of 2 slots, six 12-64-token prompts, 16 new tokens) and
    ``serve_engines``, served eager, then compiled on a second engine of
    the same seed (a hybrid engine's decode positions carry across its
    waves, as the reference's do): equal tokens, decode steps and
    launches; every kernel of the path launched as the steps count it
    (counts set to 0 just before each run and read just after), no plain
    version.  Prints set-up, decode-step times against the bytes floor,
    tokens/s, graphs and the device operations of a compiled decode step.
    Returns the compiled engine and its run's launches."""
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import ServeEngine, serve_engines

    gen = torch.Generator().manual_seed(8)
    lens = [12, 64, 37, 20, 51, 28]
    prompts = [torch.randint(1, cfg.vocab, (n,), generator=gen).tolist()
               for n in lens]
    g = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    runs, eng = {}, None
    for mode in ("eager", "compiled"):
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, max_batch=8, max_len=256, seed=0,
                          jit_steps=mode == "compiled")
        for t in range(3):
            eng.register_tenant(f"tenant{t}", 2)
        torch.cuda.synchronize()
        pool_gb = tree_bytes(eng._pool.buf) / 1e9
        log(f"recurrent set-up [{cfg.name}, {mode}]: "
            f"{time.perf_counter() - t0:.1f} s (weights, pool, manager); "
            f"{cfg.n_layers} layers, pool {pool_gb:.2f} GB, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        graphs0 = eng.manager.jit_cache_stats()["graphs"]
        dec0 = eng.decode_steps
        rids = [eng.submit(f"tenant{i % 3}", p)
                for i, p in enumerate(prompts)]
        with DispatchTimes(torch, eng) as times:
            torch.cuda.synchronize()
            _build.reset_counts()
            t1 = time.perf_counter()
            out = serve_engines([eng], max_new_tokens=16)[0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        launches = {k.name: k.launches for k in _build.KERNELS.values()}
        plain = {k.name: k.plain_calls for k in _build.KERNELS.values()}
        toks = [out.get(r) for r in rids]
        for rid, t in zip(rids, toks):
            if t is None or len(t) != 16 or not all(0 <= x < cfg.vocab
                                                    for x in t):
                raise AssertionError(f"recurrent [{cfg.name}] request "
                                     f"{rid}: bad tokens {t}")
        n_dec = eng.decode_steps - dec0
        want = {"gather_rows": 1 + n_dec, "flash_attention": g,
                "paged_attention": g * n_dec, "scatter_pages": 0,
                "moe_histogram": 0}
        if launches != want:
            raise AssertionError(f"recurrent [{cfg.name}, {mode}]: launches "
                                 f"{launches} differ from the per-step "
                                 f"count {want}")
        if any(plain.values()):
            raise AssertionError(f"recurrent [{cfg.name}, {mode}]: plain "
                                 f"versions ran on the card: {plain}")
        step_ms, capture_ms, host_ms, _ = times.read()
        del times                      # it holds the engine
        runs[mode] = dict(tokens=toks, decodes=n_dec, launches=launches,
                          wall=wall, step_ms=step_ms, capture_ms=capture_ms,
                          host_ms=host_ms,
                          graphs=eng.manager.jit_cache_stats()["graphs"]
                          - graphs0, peak=torch.cuda.max_memory_allocated())
    eager, comp = runs["eager"], runs["compiled"]
    for key in ("tokens", "decodes", "launches"):
        if eager[key] != comp[key]:
            raise AssertionError(f"recurrent [{cfg.name}]: compiled {key} "
                                 f"differ from eager: {comp[key]} vs "
                                 f"{eager[key]}")
    floor = recurrent_floor_bytes(eng)
    w_ms = floor["weights"] / HBM_BYTES_PER_S * 1e3
    ws_ms = (floor["weights"] + floor["state"]) / HBM_BYTES_PER_S * 1e3
    n_tok = sum(len(t) for t in comp["tokens"])
    log(f"recurrent [{cfg.name}]: {len(prompts)} requests (prompts {lens}) "
        f"x 16 tokens in one lockstep wave, eager and compiled (two engines "
        f"of one seed) with equal tokens; 1 prefill, {comp['decodes']} "
        f"decode steps "
        f"each; kernel launches {comp['launches']} in each run"
        + (f" (per prefill: K3 1, K4 {g}; per decode step: K3 1, K1 {g}; "
           f"window {cfg.attn_window})" if g else
           " (per prefill and per decode step: K3 1)"))
    for mode, r in runs.items():
        ms = r["step_ms"]
        med = statistics.median(ms)
        first = (f"; first (warm-up + capture) {r['capture_ms'][0]:.2f} ms"
                 if r["capture_ms"] else "")
        log(f"decode step [{cfg.name}, slab, {mode}]: median {med:.2f} ms, "
            f"min {ms[0]:.2f} ms, max {ms[-1]:.2f} ms over {len(ms)} steps"
            f"{first}; floor {floor['weights'] / 1e9:.2f} GB of weights = "
            f"{w_ms:.2f} ms at 3.35 TB/s ({w_ms / med:.1%} of the median), "
            f"with the rows' state read and written "
            f"{(floor['weights'] + floor['state']) / 1e9:.2f} GB = "
            f"{ws_ms:.2f} ms ({ws_ms / med:.1%}); host wall of a dispatch "
            f"median {r['host_ms']:.2f} ms; {n_tok / r['wall']:.1f} tokens/s"
            f" ({r['wall']:.2f} s); graphs {r['graphs']}; peak memory "
            f"{r['peak'] / 1e9:.2f} GB; {smi}")

    def serve_one(n):
        eng.submit("tenant2", list(range(1, 13)))
        eng.run(max_new_tokens=n)

    per = decode_step_ops(torch, serve_one)
    log(f"decode step ops [{cfg.name}, slab, compiled]: "
        + ("not measured (the profiler saw no device time)" if per is None
           else f"{per[0]:.1f} device operations, {per[1]:.2f} ms of "
                f"device time a step (one request); {smi}"))
    return eng, comp["launches"]


def _slot_rows(eng, part):
    """Copies of every pool tensor's slots of partition ``part``."""
    return [t[:, part.base:part.end].clone()
            for t in tree_leaves(eng._pool.buf)]


def recurrent_fences(torch, eng):
    """Phase 8 (d), on the full-size zamba2-7b engine: a request of
    tenant1 whose slot id is forged to tenant0's base leaves every pool's
    tenant0 slots (KV slabs, SSM and conv state) byte-equal; tenant2's
    eviction zeroes its slots in every pool; then tenant0, full, takes a
    third request and grows through the elastic plane into the freed
    room: the relocation step moves its KV and state slots to the new
    extent (the old slots zeroed), and the grown tenant's requests
    serve."""
    victim = eng.manager.bounds.lookup("tenant0")
    kept = _slot_rows(eng, victim)
    if not all(bool((t != 0).any()) for t in kept):
        raise AssertionError("recurrent fences: tenant0's slots hold "
                             "nothing to guard")
    rid = eng.submit("tenant1", list(range(1, 13)))
    next(r for r in eng._requests if r.rid == rid).slot = victim.base
    out = eng.run(max_new_tokens=4)
    if any(not torch.equal(a, b) for a, b in zip(
            _slot_rows(eng, victim), kept)):
        raise AssertionError("recurrent fences: a forged slot id wrote "
                             "tenant0's slots")
    if len(out.get(rid, [])) != 4:
        raise AssertionError(f"recurrent fences: the forged request served "
                             f"{out}")
    # tenant2 evicted: its slots in every pool zeroed, the room tenant0
    # grows into
    gone = eng.manager.bounds.lookup("tenant2")
    eng.quarantine_tenant("tenant2", reason="phase 8 eviction")
    eng.evict_tenant("tenant2")
    if any(bool((t != 0).any()) for t in _slot_rows(eng, gone)):
        raise AssertionError("recurrent fences: the eviction left tenant2's "
                             "slots unscrubbed")
    old = eng.manager.bounds.lookup("tenant0")
    before = _slot_rows(eng, old)
    reloc0 = eng.manager.elastic.stats["relocations"]
    rids = [eng.submit("tenant0", list(range(2, 2 + n))) for n in (9, 17, 33)]
    new = eng.manager.bounds.lookup("tenant0")
    moved = eng.manager.elastic.stats["relocations"] - reloc0
    if new.size != 2 * old.size or new.base == old.base or moved != 1:
        raise AssertionError(f"recurrent fences: tenant0 {old.base}+"
                             f"{old.size} -> {new.base}+{new.size}, "
                             f"{moved} relocations")
    for t, b in zip(tree_leaves(eng._pool.buf), before):
        if not torch.equal(t[:, new.base:new.base + old.size], b) or \
                bool((t[:, old.base:old.end] != 0).any()):
            raise AssertionError("recurrent fences: the relocation did not "
                                 "move tenant0's slots")
    out = eng.run(max_new_tokens=4)
    if any(len(out.get(r, [])) != 4 for r in rids):
        raise AssertionError(f"recurrent fences: the grown tenant served "
                             f"{out}")
    log(f"recurrent fences [{eng.cfg.name}]: a request of tenant1 with its "
        f"slot forged to tenant0's base {victim.base} served 4 tokens and "
        f"left tenant0's {victim.size} slots byte-equal in all "
        f"{len(kept)} pool tensors (KV slabs, SSM and conv state); "
        f"tenant2's eviction zeroed its {gone.size} slots in every pool; "
        f"tenant0 grew {old.base}+{old.size} -> {new.base}+{new.size} with "
        "one relocation step, its KV and state slots moved and the old ones "
        "zeroed, and its 3 requests served 4 tokens each")


def recurrent_phase(torch, smi: str) -> dict:
    """Phase 8: (a) the reduced configs, f32, card against CPU (a 38-token
    prefill past the reduced hybrid's 32-token window, 8 decode steps, so
    the windowed K4 and K1 run); (b) full width at reduced depth, f32, card
    against CPU (zamba2-7b at 7 layers: one group of 6 and a 1-layer Mamba
    tail; xlstm-350m at 2 layers); (c) each at full width and depth through
    the slab engine, eager then compiled; (d) the fence scenarios on
    zamba2-7b.  Returns each path's launches."""
    from repro_torch.configs import get_config

    paths = {}
    for name in RECURRENT:
        cfg = get_config(name)
        recurrent_card_vs_cpu(torch, cfg.reduced(), "recurrent (a) reduced",
                              38, 8, 1e-4)
        depth = 7 if cfg.family == "hybrid" else 2
        recurrent_card_vs_cpu(
            torch, dataclasses.replace(cfg, n_layers=depth, dtype="float32"),
            "recurrent (b) full width", 38, 4, 2e-3)
        gc.collect()
        torch.cuda.empty_cache()
    for name in RECURRENT:
        cfg = get_config(name)
        eng, launches = recurrent_serve(torch, cfg, smi)
        if cfg.family == "hybrid":
            recurrent_fences(torch, eng)
        paths[name] = {"launches": launches}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return paths


# --------------------------------------------------------------------- #
# Phase 9: training on the card                                         #
# --------------------------------------------------------------------- #

TRAIN_ARCH = "minicpm-2b"
#: phase 9 (b)'s full-size run: the CLI's flags (train_100m.py's full-run
#: lr, minicpm-2b's WSD schedule, batch 4 x 512 tokens, remat off)
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--steps", "10", "--batch", "4",
              "--seq", "512", "--lr", "6e-4", "--schedule", "wsd",
              "--log-every", "1", "--device", "cuda"]


def loss_and_grads(torch, api, params, toks, guard, **kw):
    """``api.loss`` (remat off, ``kw`` as its options) and the gradient of
    every param leaf, as the train step takes them; ``toks`` is the
    batch's tokens or the whole batch (a dict: the vision and
    encoder-decoder families')."""
    from repro_torch.core.stepgraph import tree_flatten, tree_unflatten
    struct, leaves = tree_flatten(params)
    req = [p.detach().requires_grad_() for p in leaves]
    batch = toks if isinstance(toks, dict) else {"tokens": toks}
    loss = api.loss(tree_unflatten(struct, req), batch, guard=guard,
                    remat=False, **kw)
    return loss.detach(), torch.autograd.grad(loss, req)


def train_launches(cfg) -> dict:
    """The kernels one forward of ``cfg``'s training loss launches: K3
    once; K4 once a layer (dense, MoE) or once a group (the hybrid's
    shared attention); K5 once a MoE layer."""
    want = {"gather_rows": 1}
    if cfg.family in ("dense", "moe"):
        want["flash_attention"] = cfg.n_layers
    if cfg.family == "hybrid":
        want["flash_attention"] = cfg.n_layers // cfg.attn_every
    if cfg.moe:
        want["moe_histogram"] = cfg.n_layers
    return want


def train_card_vs_cpu(torch, name: str, n_layers: int = 2,
                      label: str = "train (a)", **loss_kw) -> None:
    """Phase 9 (a) (and 11 (a)): ``name`` at full width and ``n_layers``
    layers, float32, the train guard (BITWISE), a 2 x 64-token SyntheticLM
    batch, ``loss_kw`` as the loss's options: the loss and every gradient
    leaf on the card (K3 and K4 launched, their backwards in PyTorch)
    against the CPU (their plain versions), from one seed's weights drawn
    on the CPU.  The loss within 1e-5 relative, each leaf's max |error|
    within 1e-4 of that leaf's max |value|."""
    from repro_torch.checkpoint.store import _flatten_with_paths
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_guard
    from repro_torch.models import get_model

    cfg = dataclasses.replace(get_config(name), n_layers=n_layers,
                              dtype="float32")
    api = get_model(cfg)
    guard = make_guard(cfg, ShapeConfig("phase9", "train", 64, 2))
    tag = f"{label} [{name}" + "".join(f", {k} {v}" for k, v in
                                       loss_kw.items()) + "]"
    toks = torch.from_numpy(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=64, global_batch=2, seed=5)).batch(0)[
            "tokens"])
    params = api.init(torch.Generator().manual_seed(13), "cpu")
    _build.reset_counts()
    loss_g, grads_g = loss_and_grads(torch, api, tree_to(params, "cuda"),
                                     toks.cuda(), guard, **loss_kw)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _build.KERNELS.values()
                if k.launches}
    plain = sum(k.plain_calls for k in _build.KERNELS.values())
    want = train_launches(cfg)
    if launches != want or plain:
        raise AssertionError(f"{tag}: launches {launches}, plain calls "
                             f"{plain}; want {want}, none")
    loss_c, grads_c = loss_and_grads(torch, api, params, toks, guard,
                                     **loss_kw)
    rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    if not rel <= 1e-5:
        raise AssertionError(f"{tag}: loss {float(loss_g)} on the card, "
                             f"{float(loss_c)} on the CPU")
    # the leaves' checkpoint keys, in tree_flatten's order (sorted keys)
    keys = [k for k, _ in _flatten_with_paths(params)]
    worst, named = 0.0, {}
    for key, g, c in zip(keys, grads_g, grads_c):
        err = (g.cpu() - c).abs().max().item()
        scale = c.abs().max().item()
        ratio = err / scale if scale else err
        if not ratio <= 1e-4:
            raise AssertionError(f"{tag}: gradient of {key} off by "
                                 f"{err:.3g} (max |grad| {scale:.3g})")
        worst = max(worst, ratio)
        if key in ("embed/table", "layers/0/attn/wq", "layers/1/attn/wv",
                   "shared_attn/attn/wq", "mlstm/0/wq", "slstm/0/r"):
            named[key] = ratio
    del grads_g
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{tag[:-1]}, {n_layers} layers, d {cfg.d_model}, f32, BITWISE "
        f"guard]: card vs CPU loss {float(loss_g):.6f} / {float(loss_c):.6f}"
        f" (relative error {rel:.3g}, tolerance 1e-5); {len(keys)} gradient "
        f"leaves, worst max |err| / max |grad| {worst:.3g} (tolerance 1e-4)"
        f"; named leaves: " + ", ".join(
            f"{k} {v:.3g}" for k, v in named.items())
        + f"; launches on the card {launches}")


def log_memory(torch, label: str) -> None:
    """The card's allocated and reserved bytes and, past 1 GB allocated,
    the largest live CUDA tensors the garbage collector sees (by shape and
    dtype) with the types of what refers to the largest — a phase that
    needs the card's memory names what an earlier one left."""
    gc.collect()
    torch.cuda.empty_cache()
    alloc = torch.cuda.memory_allocated() / 1e9
    line = (f"{label}: {alloc:.2f} GB allocated, "
            f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    if alloc > 1.0:
        from torch._subclasses.fake_tensor import is_fake
        # fake tensors left by a trace hold no memory, and their sizes
        # may be symbols
        nbytes = {id(o): (o, o.numel() * o.element_size())
                  for o in gc.get_objects()
                  if isinstance(o, torch.Tensor) and o.is_cuda
                  and not is_fake(o)}
        live = [(t, n) for t, n in nbytes.values() if isinstance(n, int)]
        size = collections.Counter()
        for t, n in live:
            size[f"{tuple(t.shape)} {t.dtype}"] += n / 1e9
        big = max(live, key=lambda tn: tn[1], default=(None, 0))[0]
        refs = [type(r).__name__ for r in gc.get_referrers(big)] \
            if big is not None else []
        line += (f"; {len(live)} live CUDA tensors, largest: "
                 + ", ".join(f"{k} {v:.2f} GB" for k, v in
                             size.most_common(4))
                 + f"; the largest is referred to by {refs[:6]}")
    log(line)


def run_train_cli(torch, argv, hold=None):
    """``repro_torch.launch.train.main(argv)`` in-process, its kernel
    counts set to 0 just before and read just after: (summary, the step
    lines' (loss, ms), launches, peak GB, the compiled step's record).
    The record holds each call's exact loss and time by CUDA events
    around it (``main``'s ``wrap_step``), the graphs (:func:`graph_line`),
    the launches a replay adds and the eager step (``step``).  With
    ``hold`` it also holds copies of call ``hold``'s params, optimizer
    state and batch, and of the params and optimizer state it handed
    back, with its loss (``held``: the state an eager step is then run
    from, and what it must reach)."""
    import io
    import re
    from repro_torch.kernels import _build
    from repro_torch.launch import train as T

    out = io.StringIO()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    made, calls, held = [], [], []

    def clone(x):
        return tree_map_tensors(lambda t: t.clone(), x)

    def wrap(compiled):
        made.append(compiled)

        def call(params, opt_state, batch):
            if len(calls) == hold:
                held.append(clone((params, opt_state, batch)))
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            res = compiled(params, opt_state, batch)
            b.record()
            calls.append((res[2]["loss"], a, b))
            if len(held) == 1:
                held.append(clone(res))
            return res
        return call

    with contextlib.redirect_stdout(out):
        summary = T.main(argv, wrap_step=wrap)
    torch.cuda.synchronize()
    if len(made) != 1:
        raise AssertionError(f"train CLI: {len(made)} compiled steps")
    graphs = list(made[0].graphs.values())
    record = {"losses": [float(x) for x, _, _ in calls],
              "ms": [a.elapsed_time(b) for _, a, b in calls],
              "graphs": graph_line(made[0]), "n_graphs": len(graphs),
              "replay": {k.name: n for k, n in graphs[0].launches.items()}
              if graphs else None, "step": made[0].step,
              "held": held or None}
    del made, graphs, calls
    launches = {k.name: k.launches for k in _build.KERNELS.values()
                if k.launches}
    plain = sum(k.plain_calls for k in _build.KERNELS.values())
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = [(float(m.group(1)), float(m.group(2))) for m in (
        re.match(r"step +\d+ loss (\S+) \((\d+) ms/step\)", ln)
        for ln in out.getvalue().splitlines()) if m]
    if plain:
        raise AssertionError(f"train CLI: {plain} plain calls on the card")
    if record["n_graphs"] != 1:
        raise AssertionError(f"train CLI: {record['graphs']}, want one "
                             "graph for its one batch shape")
    record["peak"] = peak
    gc.collect()
    torch.cuda.empty_cache()
    return summary, steps, launches, peak, record


def tree_map_tensors(fn, x):
    """``x`` (dicts, lists, tuples of tensors and other leaves) with
    ``fn`` applied to every tensor."""
    import torch
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: tree_map_tensors(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map_tensors(fn, v) for v in x)
    return x


def train_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of a train step: 6 N per token over the matmul params
    (the embedding gather excluded, the tied LM head included once), plus
    attention's QK^T and PV over the causal band, forward and backward
    (3 x 2 x 2 x S^2 / 2 x H x D per sequence and layer)."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    per_layer = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d \
        + 3 * d * f
    n = L * per_layer + cfg.vocab * d
    attn = 6 * 2 * (seq * seq / 2) * cfg.n_heads * cfg.head_dim * L \
        * (tokens // seq)
    return 6 * n * tokens + attn


def train_split(torch, cfg, reps: int = 3):
    """Phase 9 (b), timed by part: the train step's forward (the loss),
    backward (its gradient) and optimizer (AdamW's update, applied) with
    CUDA events, guarded (BITWISE) and native steps alternating on one set
    of weights, after a warm-up step of each; then one guarded step's
    device operations (``torch.profiler``).  Returns ``({guarded: [(fwd,
    bwd, opt) ms per step]}, device operations, params, bytes of the
    optimizer's update)``."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.stepgraph import tree_flatten, tree_unflatten
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import make_schedule, parse_args
    from repro_torch.optim import apply_updates

    args = parse_args(TRAIN_ARGV)
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    steps = {g: build_train_step(cfg, shape, guard_enabled=g, remat=False,
                                 schedule=make_schedule(args))
             for g in (True, False)}
    api = steps[True].api
    params = api.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    opt_state = steps[True].opt.init(params)
    struct, leaves = tree_flatten(params)
    n_params = sum(t.numel() for t in leaves)
    # the update's bytes: params read and written, gradients read, the
    # float32 moments read and written
    opt_bytes = sum(t.numel() * (3 * t.element_size() + 16) for t in leaves)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))
    times = {True: [], False: []}
    for i in range(2 * (reps + 1)):
        guarded = i % 2 == 0
        step = steps[guarded]
        toks = torch.from_numpy(data.batch(i)["tokens"]).cuda()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        req = [p.detach().requires_grad_() for p in leaves]
        ev[0].record()
        loss = api.loss(tree_unflatten(struct, req), {"tokens": toks},
                        guard=step.guard, remat=False)
        ev[1].record()
        grads = torch.autograd.grad(loss, req)
        ev[2].record()
        del req
        updates, opt_state = step.opt.update(
            tree_unflatten(struct, list(grads)), opt_state, params)
        del grads
        apply_updates(params, updates)
        del updates
        ev[3].record()
        torch.cuda.synchronize()
        if i >= 2:
            times[guarded].append(tuple(ev[j].elapsed_time(ev[j + 1])
                                        for j in range(3)))
    prof = profile_step(torch, lambda: steps[True].fn(
        params, opt_state, {"tokens": toks}))
    del params, opt_state, leaves, loss
    gc.collect()
    torch.cuda.empty_cache()
    return times, prof, n_params, opt_bytes


#: phase 9's device-time classes, by kernel name (first match)
STEP_CLASSES = (
    ("GEMMs", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_",
               "cublas")),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("K4", ("flash_attention",)),
    ("K1", ("paged_attention",)),
    ("K3", ("gather_rows",)),
    ("index_put / scatter", ("index", "scatter")),
    ("softmax / reductions", ("softmax", "reduce", "norm")),
)


def profile_step(torch, fn, sessions: int = 2) -> dict:
    """One call of ``fn`` (a train step) under ``torch.profiler``, after a
    warm-up call: its device operations, device busy time, that time by
    class (:data:`STEP_CLASSES`, the rest "elementwise / other") and the
    top kernels — from the session that recorded the most operations (the
    profiler can drop a record, never makes one up)."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        ops = sum(e.count for e in kern)
        if best is None or ops > best[0]:
            best = (ops, kern)
    ops, kern = best
    by_class = collections.Counter()
    for e in kern:
        name = e.key.lower()
        cls = next((c for c, keys in STEP_CLASSES
                    if any(k in name for k in keys)), "elementwise / other")
        by_class[cls] += dev_us(e) / 1e3
    top = sorted(kern, key=dev_us, reverse=True)[:8]
    return {"ops": ops, "busy_ms": sum(dev_us(e) for e in kern) / 1e3,
            "by_class": dict(by_class.most_common()),
            "top": [(e.key[:70], dev_us(e) / 1e3, e.count) for e in top]}


def train_full(torch, smi: str) -> dict:
    """Phase 9 (b): minicpm-2b at full width and depth (40 layers, bf16,
    2.72 B params) trained 10 steps by ``repro_torch.launch.train``'s
    ``main`` in-process (AdamW + WSD, peak lr 6e-4, batch 4 x 512,
    SyntheticLM seed 0, BITWISE guard, remat off), then the same weights
    (the same seed) with ``--no-guard``; gates: every loss finite, the
    last below the first, K3 once and K4 once a layer per step.  Then the
    step by part and its device operations (:func:`train_split`).
    Returns the guarded run's launches."""
    from repro_torch.configs import get_config

    cfg = get_config(TRAIN_ARCH)
    n_steps, batch, seq = 10, 4, 512
    tokens = batch * seq
    log_memory(torch, "train (b), before the CLI runs")
    summary, lines, launches, peak, cli = run_train_cli(torch, TRAIN_ARGV)
    losses = [x for x, _ in lines]
    want = {"gather_rows": n_steps, "flash_attention": n_steps * cfg.n_layers}
    if launches != want:
        raise AssertionError(f"train (b): launches {launches}, want {want}")
    if not (len(losses) == n_steps and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"train (b): losses {losses}")
    _, lines_n, launches_n, peak_n, cli_n = run_train_cli(
        torch, TRAIN_ARGV + ["--no-guard"])
    # the same step eagerly from the same weights on the same batches,
    # the compiled run held against it within (a)'s spread
    eager, eager_ms, eager_peak = eager_cli_loop(torch, TRAIN_ARGV, 5)
    compiled_cli_line(
        f"train (b) compiled [{TRAIN_ARCH}, {cfg.n_layers} layers, "
        f"guarded]", cli, eager, eager_ms, eager_peak,
        "an earlier run's eager step: 342.8 ms of device busy time", smi)
    log(f"train (b) compiled [{TRAIN_ARCH}, native]: replays by CUDA "
        f"events median {statistics.median(cli_n['ms'][1:]):.2f} ms (first "
        f"call {cli_n['ms'][0]:.1f} ms); {cli_n['graphs']}; launches a "
        f"replay {cli_n['replay']} (guarded {cli['replay']}); peak "
        f"{cli_n['peak']:.2f} GB")
    wall = statistics.median(ms for _, ms in lines[1:])
    wall_n = statistics.median(ms for _, ms in lines_n[1:])
    log_memory(torch, "train (b), before the step by part")
    times, prof, n_params, opt_bytes = train_split(torch, cfg)
    step_ms = {g: statistics.median(sum(t) for t in ts)
               for g, ts in times.items()}
    flops = train_flops(cfg, tokens, seq)
    peak_tf = PEAK_FLOPS["bfloat16"] / 1e12
    floor_c = flops / PEAK_FLOPS["bfloat16"] * 1e3
    floor_o = opt_bytes / HBM_BYTES_PER_S * 1e3
    log(f"train (b) [{TRAIN_ARCH}, {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params, {cfg.dtype}, batch {batch} x "
        f"{seq}]: "
        "losses " + ", ".join(f"{x:.4f}" for x in losses)
        + f" (first {summary['first_loss']:.4f} -> last "
        f"{summary['final_loss']:.4f}); launches {launches} "
        f"({launches['gather_rows'] // n_steps} K3 / "
        f"{launches['flash_attention'] // n_steps} K4 a step); peak "
        f"{peak:.2f} GB (native run {peak_n:.2f} GB, launches "
        f"{launches_n})")
    log(f"train (b) [{TRAIN_ARCH}]: CLI step (host clock to the loss on "
        f"the host, steps 1-9) median {wall:.0f} ms guarded, {wall_n:.0f} "
        f"ms native -> guarded/native {wall / wall_n:.4f}")
    for g in (True, False):
        log(f"train (b) [{TRAIN_ARCH}, {'guarded' if g else 'native'}]: "
            "forward / backward / optimizer ms (CUDA events) per step: "
            + "; ".join("/".join(f"{x:.2f}" for x in t) for t in times[g])
            + f"; median step {step_ms[g]:.2f} ms")
    log(f"train (b) [{TRAIN_ARCH}]: guarded/native step (device) "
        f"{step_ms[True] / step_ms[False]:.4f}; {tokens / step_ms[True] * 1e3:.0f}"
        f" tokens/s guarded; model {flops / 1e12:.2f} TFLOP a step (6 N "
        f"tokens + attention) = {flops / step_ms[True] / 1e9:.1f} TFLOP/s, "
        f"{flops / step_ms[True] / 1e9 / peak_tf:.1%} of {peak_tf:.0f} "
        f"TFLOP/s bf16; floor {floor_c:.1f} ms compute + {floor_o:.1f} ms "
        f"for the optimizer's {opt_bytes / 1e9:.1f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {floor_c + floor_o:.1f} ms "
        f"({(floor_c + floor_o) / step_ms[True]:.1%} of the step); on {smi}")
    log(f"train (b) [{TRAIN_ARCH}]: a guarded step under the profiler: "
        f"{prof['ops']} device operations, device busy "
        f"{prof['busy_ms']:.1f} ms; by class: " + ", ".join(
            f"{c} {ms:.1f} ms" for c, ms in prof["by_class"].items())
        + "; top kernels: " + "; ".join(
            f"{k} {ms:.2f} ms x{n}" for k, ms, n in prof["top"]))
    return {"launches": launches}


def train_restart(torch) -> None:
    """Phase 9 (c): the restart contract on the card under the compiled
    step, minicpm-2b at 2 layers and full width, bf16, the train guard,
    batch 2 x 128: 6 steps uninterrupted against 3 steps, ``save_async``
    / ``wait`` / ``restore`` into fresh tensors, 3 steps (the restored
    tensors get a graph of their own, the stale one is dropped).  Gate: the final losses
    within 1e-5 (``examples/preemption_resume.py``'s bound); prints
    whether every param and moment is bit-identical."""
    import tempfile
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.stepgraph import tree_flatten
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import build_train_step, \
        compile_train_step
    from repro_torch.optim import wsd

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2)
    step = build_train_step(cfg, ShapeConfig("phase9", "train", 128, 2),
                            remat=False, schedule=wsd(6e-4, 1, 3, 2))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=128,
                                  global_batch=2, seed=0))

    def fresh():
        p = step.api.init(torch.Generator(device="cuda").manual_seed(0),
                          "cuda")
        return p, step.opt.init(p)

    def run(fn, start, stop, params, opt_state):
        loss = None
        for s in range(start, stop):
            params, opt_state, out = fn(params, opt_state, {
                "tokens": torch.from_numpy(data.batch(s)["tokens"]).cuda()})
            loss = float(out["loss"])
        return params, opt_state, loss

    whole, parted = compile_train_step(step), compile_train_step(step)
    pa, sa, loss_a = run(whole, 0, 6, *fresh())
    pb, sb, _ = run(parted, 0, 3, *fresh())
    with tempfile.TemporaryDirectory() as d:
        store = CheckpointStore(d)
        store.save_async(3, (pb, sb))
        store.wait()
        del pb, sb
        (pb, sb), at = store.restore(fresh())
    before = next(iter(parted.graphs.values()))
    pb, sb, loss_b = run(parted, at, 6, pb, sb)
    graphs = (len(whole.graphs), len(parted.graphs),
              next(iter(parted.graphs.values())) is not before)
    del before
    diff = abs(loss_a - loss_b)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_flatten((pa, sa))[1], tree_flatten((pb, sb))[1]))
    if not diff < 1e-5 or graphs != (1, 1, True):
        raise AssertionError(f"train (c): restarted run's loss {loss_b} vs "
                             f"{loss_a} uninterrupted; graphs {graphs}")
    log(f"train (c) [{TRAIN_ARCH}, 2 layers, {cfg.dtype}, compiled]: 6 "
        f"steps {loss_a:.6f}, "
        f"3 + checkpoint (save_async, wait, restore) + 3 {loss_b:.6f}: "
        f"|diff| {diff:.3g} (tolerance 1e-5); params and moments "
        f"bit-identical: {same}; one graph each, the restored tensors' "
        f"graph captured afresh and the stale one dropped")
    del pa, sa, pb, sb, whole, parted
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# Phases 9 and 11: the compiled train step                              #
# --------------------------------------------------------------------- #

#: a compiled step's loss against the eager step's (relative), unless the
#: card's own eager-against-eager spread is larger
COMPILED_LOSS_TOL = 1e-5
#: a compiled step's param and moment leaves against the eager step's:
#: max |error| over the leaf's max |value| (phase 9 (a)'s bound), unless
#: the eager spread is larger
COMPILED_LEAF_TOL = 1e-4
#: the worst relative loss difference between two eager runs, and between
#: a compiled and an eager run, that this process's (a) checks measured:
#: the full-size checks' loss bound is stated from them (and their leaf
#: bound from the worst eager-against-eager leaf, ``leaf``)
TRAIN_SPREAD = {"eager": 0.0, "compiled": 0.0}
TRAIN_LEAF_SPREAD = {"leaf": 0.0}


def step_loop(torch, fn, params, opt_state, batches):
    """``fn`` (a train step, eager or compiled) over ``batches`` from
    ``params`` / ``opt_state``, each call between CUDA events, the kernel
    counts set to 0 just before: ``(params, opt_state, losses, ms,
    launches, plain calls)``."""
    from repro_torch.kernels import _build
    losses, events = [], []
    _build.reset_counts()
    for batch in batches:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        params, opt_state, out = fn(params, opt_state, batch)
        b.record()
        losses.append(out["loss"])
        events.append((a, b))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _build.KERNELS.values()
                if k.launches}
    plain = sum(k.plain_calls for k in _build.KERNELS.values())
    return (params, opt_state, [float(x) for x in losses],
            [a.elapsed_time(b) for a, b in events], launches, plain)


def leaf_gap(torch, got, want):
    """``(worst max |got - want| / max |want| over the leaves, every leaf
    bit-equal)``."""
    worst, same = 0.0, True
    for a, b in zip(got, want):
        if torch.equal(a, b):
            continue
        same = False
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        worst = max(worst, err / scale if scale else err)
    return worst, same


def loss_gap(got, want) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(got, want))


def graph_line(compiled) -> str:
    """A compiled train step's graphs: count, warm-up, capture and
    ``capture_end`` seconds, the reserved bytes after the warm-up, after
    its release and the graph pool's."""
    gs = list(compiled.graphs.values())
    return f"{len(gs)} graph(s): " + ", ".join(
        f"warm-up (the eager first run, to the card's sync) "
        f"{g.warm_s:.3f} s, capture {g.capture_s:.3f} s (capture_end, "
        f"which instantiates, {g.instantiate_s:.3f} s), reserved after "
        f"the warm-up {g.warm_reserved / 1e9:.2f} GB, after its release "
        f"{g.capture_reserved / 1e9:.2f} GB, graph pool "
        f"{g.pool_bytes / 1e9:.2f} GB" for g in gs)


def train_compiled_vs_eager(torch, name: str, n_layers: int = 2,
                            label: str = "train (a)", steps: int = 5,
                            seqs=None, **kw) -> None:
    """Phase 9 (a) (and 11 (a)) compiled: ``name`` at full width and
    ``n_layers`` layers, float32, the train guard (BITWISE), ``kw`` as
    ``build_train_step``'s options (remat off unless given), AdamW under
    WSD (peak 6e-4: warm-up, plateau and decay inside the steps) over
    ``steps`` SyntheticLM batches of 2 x 64 tokens, each run from one
    seed's weights drawn on the card.  Two eager runs give the card's own
    spread, then ``compile_train_step``'s run.  Gates: one graph; every
    loss within 1e-5 relative of the first eager run's and every param and
    moment leaf within 1e-4 of its max |value| — or within the eager
    spread where it is larger; the launches of a replay equal an eager
    step's (K3, K4, K5), no plain version.  Prints whether each run is
    bit-equal to the first.  ``seqs`` gives each step's batch its own
    length (a prefix of its 64 tokens): then one graph per length, all
    captured into one pool, each replayed after the others."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import build_train_step, \
        compile_train_step
    from repro_torch.optim import wsd

    cfg = dataclasses.replace(get_config(name), n_layers=n_layers,
                              dtype="float32")
    seqs = list(seqs or [64] * steps)
    steps = len(seqs)
    tag = f"{label} compiled [{name}, {n_layers} layers" + "".join(
        f", {k} {v}" for k, v in kw.items()) + (
        f", lengths {'/'.join(map(str, seqs))}" if len(set(seqs)) > 1
        else "")
    kw.setdefault("remat", False)
    step = build_train_step(cfg, ShapeConfig("phase9", "train", 64, 2),
                            schedule=wsd(6e-4, 1, 2, 2), **kw)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=2, seed=5))
    batches = [{"tokens": torch.from_numpy(
        data.batch(i)["tokens"][:, :seqs[i] + 1]).cuda()}
        for i in range(steps)]

    def fresh():
        p = step.api.init(torch.Generator(device="cuda").manual_seed(13),
                          "cuda")
        return p, step.opt.init(p)

    pa, sa, loss_a, ms_a, launch_a, plain_a = step_loop(
        torch, step.fn, *fresh(), batches)
    want = tree_leaves((pa, sa))
    pb, sb, loss_b, _, _, _ = step_loop(torch, step.fn, *fresh(), batches)
    spread, same_b = leaf_gap(torch, tree_leaves((pb, sb)), want)
    spread_loss = loss_gap(loss_b, loss_a)
    del pb, sb
    gc.collect()
    torch.cuda.empty_cache()
    compiled = compile_train_step(step)
    pc, sc, loss_c, ms_c, launch_c, plain_c = step_loop(
        torch, compiled, *fresh(), batches)
    gap, same_c = leaf_gap(torch, tree_leaves((pc, sc)), want)
    gap_loss = loss_gap(loss_c, loss_a)
    loss_tol = max(COMPILED_LOSS_TOL, spread_loss)
    leaf_tol = max(COMPILED_LEAF_TOL, spread)
    graphs = list(compiled.graphs.values())
    replays = [{k.name: n for k, n in g.launches.items()} for g in graphs]
    replay = replays[0] if replays else None
    per_step = {k: n // steps for k, n in launch_a.items()}
    line = graph_line(compiled)
    n_graphs = len(graphs)
    del pa, sa, pc, sc, want, compiled, graphs
    gc.collect()
    torch.cuda.empty_cache()
    if n_graphs != len(set(seqs)) or any(r != per_step for r in replays) \
            or launch_c != launch_a or plain_a or plain_c:
        raise AssertionError(f"{tag}]: {line}; launches a replay "
                             f"{replays}, an eager step {per_step}; plain "
                             f"calls {plain_a} / {plain_c}")
    if not (gap_loss <= loss_tol and gap <= leaf_tol):
        raise AssertionError(
            f"{tag}]: losses {loss_c} compiled, {loss_a} eager (relative "
            f"{gap_loss:.3g}, tolerance {loss_tol:.3g}); worst leaf "
            f"{gap:.3g} (tolerance {leaf_tol:.3g})")
    TRAIN_SPREAD["eager"] = max(TRAIN_SPREAD["eager"], spread_loss)
    TRAIN_SPREAD["compiled"] = max(TRAIN_SPREAD["compiled"], gap_loss)
    TRAIN_LEAF_SPREAD["leaf"] = max(TRAIN_LEAF_SPREAD["leaf"], spread)
    log(f"{tag}, d {cfg.d_model}, f32, batch 2 x {max(seqs)}, {steps} steps]: eager "
        f"twice — losses relative {spread_loss:.3g}, worst leaf "
        f"{spread:.3g}, bit-equal {same_b and loss_b == loss_a}; compiled "
        f"vs eager — losses " + ", ".join(f"{x:.6f}" for x in loss_c)
        + f" (relative {gap_loss:.3g}, tolerance {loss_tol:.3g}), worst "
        f"param / moment leaf max |err| / max |value| {gap:.3g} "
        f"(tolerance {leaf_tol:.3g}), bit-equal {same_c and loss_c == loss_a}"
        f"; {line}; launches a replay {replay} = an eager step's, no plain "
        f"version; step (CUDA events, steps 2-{steps}) median eager "
        f"{statistics.median(ms_a[1:]):.2f} ms, compiled "
        f"{statistics.median(ms_c[1:]):.2f} ms (first call, warm-up and "
        f"capture, {ms_c[0]:.1f} ms)")


def eager_cli_loop(torch, argv, steps: int):
    """The step ``repro_torch.launch.train.main(argv)`` compiles, run
    eagerly (``step_fn.fn``) ``steps`` times from the same weights on the
    same batches: ``(losses, ms by CUDA events, peak GB)``."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.fence import FencePolicy
    from repro_torch.data import DataConfig, make_source
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import make_schedule, parse_args

    args = parse_args(argv)
    cfg = get_config(args.arch)
    step = build_train_step(
        cfg, ShapeConfig("train", "train", args.seq, args.batch),
        guard_enabled=not args.no_guard, policy=FencePolicy(args.policy),
        remat=False, schedule=make_schedule(args))
    source = make_source(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch, seed=args.seed,
                                    host_index=0, host_count=1))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = step.api.init(
        torch.Generator(device="cuda").manual_seed(args.seed), "cuda")
    batches = ({k: torch.from_numpy(v).cuda()
                for k, v in source.batch(i).items()} for i in range(steps))
    _, _, losses, ms, _, _ = step_loop(torch, step.fn, params,
                                       step.opt.init(params), batches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return losses, ms, peak


def compiled_cli_line(tag: str, cli: dict, eager: list, eager_ms: list,
                      eager_peak: float, busy: str, smi: str) -> None:
    """Hold a CLI run's compiled losses against the eager loop's on its
    first steps — within 1e-5 relative, or the largest eager-against-eager
    or compiled-against-eager loss difference (i) measured in this
    process, if larger — and log both step times (CUDA events), the
    capture, the pool and the peaks."""
    n = len(eager)
    gap = loss_gap(cli["losses"][:n], eager)
    bound = max(COMPILED_LOSS_TOL, *TRAIN_SPREAD.values())
    if not gap <= bound:
        raise AssertionError(f"{tag}: compiled losses {cli['losses'][:n]}, "
                             f"eager {eager} (relative {gap:.3g}, bound "
                             f"{bound:.3g})")
    replays = cli["ms"][1:]
    log(f"{tag}: compiled (the CLI) vs eager (step_fn.fn, the same weights "
        f"and batches) on {n} steps — losses relative {gap:.3g} (bound "
        f"{bound:.3g}: 1e-5 or the measured spread), bit-equal "
        f"{cli['losses'][:n] == eager}; step by CUDA events: compiled "
        f"replays " + "/".join(f"{x:.2f}" for x in replays)
        + f" ms, median {statistics.median(replays):.2f} ms (first call, "
        f"warm-up and capture, {cli['ms'][0]:.1f} ms); eager "
        + "/".join(f"{x:.2f}" for x in eager_ms) + " ms, median of steps "
        f"2-{n} {statistics.median(eager_ms[1:]):.2f} ms; {busy}; "
        f"{cli['graphs']}; peak {cli['peak']:.2f} GB compiled, "
        f"{eager_peak:.2f} GB eager; on {smi}")


def held_vs_eager(torch, tag: str, cli: dict, busy: str, smi: str) -> None:
    """Hold a CLI run's first replay (``run_train_cli(..., hold=1)``)
    against one eager step (``step_fn.fn``) from a copy of the state that
    replay started from, on a copy of its batch: the loss within
    :func:`compiled_cli_line`'s bound, every param and moment leaf within
    1e-4 of its max |value| or the largest eager-against-eager leaf
    difference (i) measured in this process, if larger; logs both step
    times (CUDA events), the capture, the pool and the peak."""
    from repro_torch.core.stepgraph import tree_flatten
    (params, opt_state, batch), (want_p, want_s, want_out) = cli.pop("held")
    step = cli.pop("step")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    params, opt_state, out = step.fn(params, opt_state, batch)
    b.record()
    torch.cuda.synchronize()
    eager_ms = a.elapsed_time(b)
    loss, want_loss = float(out["loss"]), float(want_out["loss"])
    gap_loss = loss_gap([want_loss], [loss])
    gap, same = leaf_gap(torch, tree_flatten((want_p, want_s))[1],
                         tree_flatten((params, opt_state))[1])
    del params, opt_state, batch, want_p, want_s, out, want_out, step
    gc.collect()
    torch.cuda.empty_cache()
    loss_tol = max(COMPILED_LOSS_TOL, *TRAIN_SPREAD.values())
    leaf_tol = max(COMPILED_LEAF_TOL, TRAIN_LEAF_SPREAD["leaf"])
    if not (gap_loss <= loss_tol and gap <= leaf_tol):
        raise AssertionError(
            f"{tag}: the first replay's loss {want_loss}, an eager step "
            f"from the same state {loss} (relative {gap_loss:.3g}, bound "
            f"{loss_tol:.3g}); worst leaf {gap:.3g} (bound {leaf_tol:.3g})")
    replays = cli["ms"][1:]
    log(f"{tag}: the first replay vs one eager step (step_fn.fn) from a "
        f"copy of the state and batch it started from — loss relative "
        f"{gap_loss:.3g} (bound {loss_tol:.3g}: 1e-5 or the measured "
        f"spread), worst param / moment leaf max |err| / max |value| "
        f"{gap:.3g} (bound {leaf_tol:.3g}), bit-equal "
        f"{same and loss == want_loss}; step by CUDA events: compiled "
        f"replays " + "/".join(f"{x:.2f}" for x in replays)
        + f" ms (first call, warm-up and capture, {cli['ms'][0]:.1f} ms); "
        f"eager {eager_ms:.2f} ms; {busy}; {cli['graphs']}; peak "
        f"{cli['peak']:.2f} GB compiled; on {smi}")


def check_uncapturable_train(torch) -> None:
    """A train step whose loss calls ``.item()`` (minicpm-2b at 2 layers)
    cannot be compiled: ``compile_train_step``'s call raises
    ``StepCaptureError`` naming the step, and so does the next call (it
    runs nothing); the card stays usable."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.stepgraph import StepCaptureError
    from repro_torch.launch.steps import build_train_step, \
        compile_train_step

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2)
    base = build_train_step(cfg, ShapeConfig("phase9", "train", 64, 2),
                            remat=False)

    def item_loss_step(params, opt_state, batch):
        params, opt_state, out = base.fn(params, opt_state, batch)
        if out["loss"].item() != out["loss"].item():
            raise AssertionError("a NaN loss")
        return params, opt_state, out

    compiled = compile_train_step(dataclasses.replace(base,
                                                      fn=item_loss_step))
    params = base.api.init(torch.Generator(device="cuda").manual_seed(1),
                           "cuda")
    opt_state = base.opt.init(params)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 65), device="cuda",
                                     dtype=torch.int32)}
    causes = []
    for attempt in range(2):
        try:
            compiled(params, opt_state, batch)
        except StepCaptureError as err:
            if "'item_loss_step'" not in str(err):
                raise AssertionError(f"the capture error names no step: "
                                     f"{err}")
            causes.append(str(err).splitlines()[0][:160])
        else:
            raise AssertionError(f"a train step calling .item() ran "
                                 f"compiled (attempt {attempt + 1})")
    del params, opt_state, compiled
    gc.collect()
    torch.cuda.empty_cache()
    x = torch.arange(4.0, device="cuda")
    if (x * 2).sum().item() != 12.0:
        raise AssertionError("the card is unusable after a failed capture")
    log(f"train (e): a train step calling .item() raises StepCaptureError "
        f"naming it ({causes[0]}), and again on the next call without "
        f"running ({causes[1] == causes[0]}); the card stays usable")


def train_phase(torch, smi: str) -> dict:
    """Phase 9: (a) card against CPU, then minicpm-2b's compiled step
    against eager; (b) the full-size runs; (c) the restart; (e) the
    uncapturable step.  Returns (b)'s launches."""
    t0 = time.perf_counter()
    for name in (TRAIN_ARCH, "qwen3-moe-30b-a3b"):
        train_card_vs_cpu(torch, name)
    train_compiled_vs_eager(torch, TRAIN_ARCH)
    # two batch lengths: a graph each in the one pool, each replayed
    # after the other was captured
    train_compiled_vs_eager(torch, TRAIN_ARCH, seqs=(64, 64, 32, 64, 32))
    log(f"phase 9 (a): {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    path = train_full(torch, smi)
    log(f"phase 9 (b): {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    train_restart(torch)
    check_uncapturable_train(torch)
    log(f"phase 9 (c), (e): {time.perf_counter() - t1:.1f} s; phase 9: "
        f"{time.perf_counter() - t0:.1f} s")
    return path


def train_kernel_rows(torch) -> list:
    """Phase 2's rows at the training shapes of phase 9 (b) (minicpm-2b,
    batch 4 x 512): K3 over the 122,753 x 2,304 bf16 table under its
    131,072 vocab fence with 2,048 SyntheticLM ids, and K4 in bf16 at (4,
    512, 36, 64), causal — each against its plain version, with its time,
    bound and library call; and each kernel's backward (PyTorch, the
    gradient the train step takes) timed for the log."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import ref
    from repro_torch.kernels.gather_rows import gather_rows, \
        gather_rows_backward_op
    from repro_torch.launch.graph_analysis import gather_rows_cost

    cfg = get_config(TRAIN_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(2222)
    B, S, H, D = 4, 512, cfg.n_heads, cfg.head_dim
    path = f"{TRAIN_ARCH}/train"
    rows = []

    def row(kernel, source, replaces, **kw):
        rows.append(dict(kernel=kernel, path=path, route="cuda",
                         name=f"{kernel}@{path}",
                         source=f"src/repro_torch/kernels/csrc/{source}",
                         replaces=f"src/repro/kernels/{replaces}", **kw))

    # K3: the step's 2,048 input ids (SyntheticLM, seed 0, step 0)
    table = torch.randn(cfg.vocab, cfg.d_model, generator=gen,
                        device="cuda").to(torch.bfloat16)
    ids = torch.from_numpy(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B)).batch(0)["tokens"][
            :, :-1].reshape(-1).copy()).cuda()
    mask = pow2(cfg.vocab) - 1
    out = gather_rows(table, ids, 0, mask)
    want = ref.gather_rows_ref(table, ids, 0, mask)
    if not torch.equal(out, want):
        raise AssertionError("gather_rows at the training shape disagrees "
                             "with its plain version")
    n = ids.numel()
    grad = torch.randn(n, cfg.d_model, generator=gen,
                       device="cuda").to(torch.bfloat16)
    bwd_ms = cuda_ms(torch, lambda: gather_rows_backward_op(
        table, grad, ids, None, None, 0, mask))
    row("gather_rows", "gather_rows.cu", "fenced_gather.py:48",
        max_abs_err=0.0, tolerance="exact",
        ms=cuda_ms(torch, lambda: gather_rows(table, ids, 0, mask)),
        plain_ms=cuda_ms(torch, lambda: ref.gather_rows_ref(
            table, ids, 0, mask)),
        library_ms=cuda_ms(torch, lambda: table.index_select(0, ids)),
        library_call="Tensor.index_select",
        shape=f"table {tuple(table.shape)} bf16, {n} ids, fence {mask + 1}",
        **rule_bound(gather_rows_cost(table, ids), "bfloat16"))
    del table, grad

    # K4: the step's attention, bf16, causal
    q, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    k4_form_row(torch, row, path, q, k, v, True)
    do = torch.randn(B, S, H, D, generator=gen,
                     device="cuda").to(torch.bfloat16)
    k4_bwd_ms = cuda_ms(torch, lambda: ref.flash_attention_grad_ref(
        q, k, v, do), iters=5)
    log_rows(rows)
    log(f"backwards at the training shapes (PyTorch, the train step's): "
        f"K3's fenced scatter-add {bwd_ms:.5f} ms, K4's recompute "
        f"{k4_bwd_ms:.5f} ms a call")
    return rows


# --------------------------------------------------------------------- #
# Phase 2 (vision and encoder-decoder families) and phase 10            #
# --------------------------------------------------------------------- #

#: the vision (qwen2-vl-2b: M-RoPE, patches fused into the embeddings) and
#: encoder-decoder (seamless-m4t-medium: an encoder, a cross-attention
#: pool) families' paths
FAMILIES = ("qwen2-vl-2b", "seamless-m4t-medium")
#: phase 10 (b)'s serving shapes: rows, image patches on a side x side
#: grid and text tokens (vlm), source frames and target tokens (encdec),
#: greedy decode steps
VLM_SIDE, VLM_TEXT = 16, 64
ED_FRAMES, ED_TGT = 1024, 32
FAMILY_B, FAMILY_STEPS = 4, 16


def mrope_grid(torch, B: int, S: int, side: int, device):
    """qwen2-vl positions (B, S, 3): ``side`` x ``side`` patches at (t=0,
    h=i // side, w=i % side) — three components that differ — then the
    text, every component at ``side + (i - side**2)``."""
    n = side * side
    pos = torch.zeros(S, 3, dtype=torch.int32)
    i = torch.arange(n, dtype=torch.int32)
    pos[:n, 1], pos[:n, 2] = i // side, i % side
    pos[n:] = (side + torch.arange(S - n, dtype=torch.int32))[:, None]
    return pos.expand(B, S, 3).contiguous().to(device)


def family_kernel_rows(torch) -> list:
    """Phase 2's rows at phase 10 (b)'s shapes: K3 over qwen2-vl-2b's
    151,936 x 1,536 and seamless-m4t-medium's 256,206 x 1,024 bf16 tables
    (fence 262,144) with the prefill's ids; K1 on a bf16 pool at qwen2-vl's
    decode (q (4, 12, 128), G = 6, each row's 8 pages of a 32-page slab
    view, 321-336 held tokens; every cluster size checked) and at
    seamless's cross-attention (q (4, 16, 64), G = 1, 16 pages a row of a
    64-page view, 1,024 frames); K4 in bf16 and f32 at qwen2-vl's prefill
    (4 x 320, causal), seamless's encoder (4 x 1,024, not causal) and its
    cross-attention (32 queries over 1,024 keys, not causal).  The f32
    forms run on no main path (phase 10 (a) only): their rows carry 0
    launches; the K1 cross row and the K4 encoder and cross rows carry
    their forms' own launches, filled in from phase 10 (b)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.gather_rows import gather_rows
    from repro_torch.launch.graph_analysis import gather_rows_cost

    K1 = sys.modules["repro_torch.kernels.paged_attention"]
    gen = torch.Generator(device="cuda").manual_seed(2468)
    i32 = dict(dtype=torch.int32, device="cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def row_of(path):
        """The row function of ``path``'s rows (named kernel@path unless
        a form's name is given)."""
        def row(kernel, source, replaces, name=None, **kw):
            rows.append(dict(kernel=kernel, path=path, route="cuda",
                             name=name or f"{kernel}@{path}",
                             source=f"src/repro_torch/kernels/csrc/{source}",
                             replaces=f"src/repro/kernels/{replaces}", **kw))
        return row

    vlm, ed = (get_config(n) for n in FAMILIES)
    B = FAMILY_B
    # K3: the prefill's ids under the vocab fence
    for cfg, n in ((vlm, VLM_SIDE ** 2 + VLM_TEXT), (ed, ED_TGT)):
        table = randn(cfg.vocab, cfg.d_model, dtype=bf16)
        ids = torch.randint(0, cfg.vocab, (B * n,), generator=gen, **i32)
        mask = pow2(cfg.vocab) - 1
        if not torch.equal(gather_rows(table, ids, 0, mask),
                           ref.gather_rows_ref(table, ids, 0, mask)):
            raise AssertionError(f"gather_rows [{cfg.name}] disagrees with "
                                 "its plain version")
        row_of(cfg.name)(
            "gather_rows", "gather_rows.cu", "fenced_gather.py:48",
            max_abs_err=0.0, tolerance="exact",
            ms=cuda_ms(torch, lambda: gather_rows(table, ids, 0, mask)),
            plain_ms=cuda_ms(torch, lambda: ref.gather_rows_ref(
                table, ids, 0, mask)),
            library_ms=cuda_ms(torch, lambda: table.index_select(0, ids)),
            library_call="Tensor.index_select",
            shape=f"table {tuple(table.shape)} bf16, {ids.numel()} ids, "
                  f"fence {mask + 1}",
            **rule_bound(gather_rows_cost(table, ids), "bfloat16"))
        del table

    # K1 on a bf16 pool: qwen2-vl's decode over the slab view (4 slots x
    # 8 pages), each row its own slot's pages; seamless's cross view (4
    # slots x 16 pages of 64 frames)
    zeros, ident = torch.zeros(B, **i32), torch.full((B,), -1, **i32)
    for cfg, pages, lens in (
            (vlm, 8, torch.randint(VLM_SIDE ** 2 + VLM_TEXT + 1,
                                   VLM_SIDE ** 2 + VLM_TEXT + FAMILY_STEPS
                                   + 1, (B,), generator=gen, **i32)),
            (ed, ED_FRAMES // 64, torch.full((B,), ED_FRAMES, **i32))):
        H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        k_pool, v_pool = (randn(B * pages, 64, KH, D, dtype=bf16)
                          for _ in range(2))
        table = (torch.arange(B, **i32)[:, None] * pages
                 + torch.arange(pages, **i32)[None, :])
        q = randn(B, H, D, dtype=bf16)
        cross = cfg.family == "encdec"
        chk = k1_pool_row(torch, row_of(cfg.name), cfg.name, q, k_pool,
                          v_pool, table,
                          lens, zeros, ident,
                          **({"name": f"paged_attention@{cfg.name}/cross",
                              "form": "paged_attention/cross"}
                             if cross else {}))
        chosen, sweep = K1.cluster_size, []
        try:
            for c in (1, 2, 4, 8):
                K1.cluster_size = lambda pairs, n_sm, c=c: c
                for qq in (q, q.float()):
                    r = check_paged_attention(torch, qq, k_pool, v_pool,
                                              table, lens, zeros, ident,
                                              None)
                    sweep.append(f"C={c} {'bf16' if qq is q else 'f32'} q "
                                 f"{r['ratio']:.3f}")
        finally:
            K1.cluster_size = chosen
        log(f"K1 on a bf16 pool ok [{cfg.name}{'/cross' if cross else ''}]"
            f": bf16 q max |err| {chk['err']:.3g}, error/bound "
            f"{chk['ratio']:.3f}, the bf16-math control "
            f"{chk['ctrl_ratio']:.3g}"
            f", {chk['foreign']} foreign pages clobbered, output unchanged;"
            f" every cluster size (error/bound): " + ", ".join(sweep))

    # K4: qwen2-vl's prefill (causal), seamless's encoder and cross
    S_v = VLM_SIDE ** 2 + VLM_TEXT
    for dt in (bf16, f32):
        tag = "" if dt == bf16 else "/f32"
        extra = {} if dt == bf16 else {"launches": 0}
        q = randn(B, S_v, vlm.n_heads, vlm.head_dim, dtype=dt)
        k, v = (randn(B, S_v, vlm.n_kv_heads, vlm.head_dim, dtype=dt)
                for _ in range(2))
        k4_form_row(torch, row_of(vlm.name), vlm.name, q, k, v, True,
                    name=f"flash_attention@{vlm.name}{tag}", **extra)
        H, D = ed.n_heads, ed.head_dim
        k, v = (randn(B, ED_FRAMES, ed.n_kv_heads, D, dtype=dt)
                for _ in range(2))
        for form, Sq in (("encoder", ED_FRAMES), ("cross", ED_TGT)):
            q = randn(B, Sq, H, D, dtype=dt)
            k4_form_row(torch, row_of(ed.name), ed.name, q, k, v, False,
                        name=f"flash_attention@{ed.name}/{form}{tag}",
                        **(extra or {"form": f"flash_attention/{form}"}))
    # K4 over a key length of its own that ends inside a 64-key tile,
    # longer and shorter than Sq (a partial last key tile masked at Skv)
    ragged = []
    for dt in (bf16, f32):
        for Sq, Skv in ((ED_TGT, 1000), (57, 193), (70, 5)):
            q = randn(B, Sq, ed.n_heads, ed.head_dim, dtype=dt)
            k, v = (randn(B, Skv, ed.n_kv_heads, ed.head_dim, dtype=dt)
                    for _ in range(2))
            err = k4_err(torch, ed.name, q, k, v, False)
            ragged.append(f"{'bf16' if dt == bf16 else 'f32'} {Sq} over "
                          f"{Skv} {err:.3g}")
    log(f"K4 over a ragged key length ok [{ed.name}], not causal, max "
        f"|err|: " + ", ".join(ragged))
    log_rows(rows)
    return rows


def family_batch(torch, cfg, B: int, n_src: int, S: int, gen, device,
                 dtype):
    """A batch of ``cfg``'s family, drawn on the CPU from ``gen``: vision
    — ``S`` tokens whose first ``n_src`` positions are patches on a
    square grid (``mrope_grid``), the patches ~ N(0, 0.02); encoder-
    decoder — ``n_src`` frames ~ N(0, 1) and ``S`` target ids."""
    if cfg.family == "vlm":
        side = math.isqrt(n_src)
        return {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                        dtype=torch.int32).to(device),
                "patches": (torch.randn(B, n_src, cfg.d_model, generator=gen)
                            * 0.02).to(dtype).to(device),
                "positions": mrope_grid(torch, B, S, side, device)}
    return {"src": torch.randn(B, n_src, cfg.d_model, generator=gen)
            .to(dtype).to(device),
            "tgt": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                 dtype=torch.int32).to(device)}


def family_card_vs_cpu(torch, name: str) -> None:
    """Phase 10 (a): ``name`` at full width and 2 layers (seamless: 2
    encoder + 2 decoder), float32, weights from one seed drawn on the CPU
    and copied to the card.  Serving, f32 caches: 2 rows — qwen2-vl a
    prefill of 16 patches on a 4 x 4 grid and 8 text tokens, seamless 64
    frames and 16 target tokens over an 8-slot pool whose row 1 names row
    0's slot (fenced into its own partition) — then 4 greedy decode steps
    (the vision rows' M-RoPE positions continuing past the grid): greedy
    ids equal and logits within phase 3's 2e-3, the seamless cross pools'
    written slots within 1e-4 and the slots no row owns zero, the forged
    row's frames at its own fenced slot, on both devices; the kernels
    launched as the steps count them, no plain version on the card.
    Training: the train guard, a 2-row batch, the loss within 1e-5
    relative and every gradient leaf within 1e-4 of its max |value|
    (phase 9 (a)'s bounds)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.fence import FenceParams, FencePolicy, FenceTable
    from repro_torch.core.partition import Partition
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_guard
    from repro_torch.models import encdec as ED
    from repro_torch.models import get_model
    from repro_torch.models import kvcache as KV
    from repro_torch.models.guard import GuardSpec

    base_cfg = get_config(name)
    cfg = dataclasses.replace(base_cfg, n_layers=2,
                              enc_layers=min(base_cfg.enc_layers, 2),
                              dtype="float32")
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(17), "cpu")
    vlm = cfg.family == "vlm"
    B, steps = 2, 4
    n_src, S = (16, 24) if vlm else (64, 16)
    batch = family_batch(torch, cfg, B, n_src, S + steps + 1,
                         torch.Generator().manual_seed(19), "cpu",
                         torch.float32)
    serve = {k: (v[:, :S] if k in ("tokens", "positions", "tgt") else v)
             for k, v in batch.items()}
    parts = [Partition("a", 4, 2), Partition("b", 6, 2)]
    slot_ids = torch.tensor([4, 4], dtype=torch.int32)   # row 1 forged

    def run(device, p):
        kv = FenceTable.from_partitions(parts, with_magic=True,
                                        device=device).gather(
            torch.tensor([0, 1], dtype=torch.int32))
        guard = GuardSpec(policy=FencePolicy.BITWISE,
                          vocab=FenceParams(0, pow2(cfg.vocab)), kv=kv,
                          page=FenceParams(0, 1))
        if vlm:
            cache = api.init_cache(B, 64, dtype=torch.float32, slots=8,
                                   device=device)
        else:
            shape = (cfg.n_layers, 8, n_src, cfg.n_kv_heads, cfg.head_dim)
            cache = ED.EncDecCache(
                kv=KV.init_kv_cache(cfg, B, 64, slots=8,
                                    dtype=torch.float32, device=device),
                cross_k=torch.zeros(shape, device=device),
                cross_v=torch.zeros(shape, device=device),
                src_lens=torch.zeros(B, dtype=torch.int32, device=device))
        cache = KV.with_slot_ids(cache, slot_ids.to(device))
        cache, logits = api.prefill(
            p, cache, {k: v.to(device) for k, v in serve.items()},
            guard=guard)
        outs, ids = [logits.float().cpu()], [logits.argmax(-1).cpu()]
        for i in range(steps):
            kw = {"positions": batch["positions"][:, S + i, :1].to(device)} \
                if vlm else {}
            cache, logits = api.decode(p, cache,
                                       logits.argmax(-1).to(torch.int32),
                                       guard=guard, **kw)
            outs.append(logits.float().cpu())
            ids.append(logits.argmax(-1).cpu())
        pools = None if vlm else (cache.cross_k.cpu(), cache.cross_v.cpu())
        return (torch.stack(outs), torch.stack(ids)), pools

    _build.reset_counts()
    card, card_pools = run("cuda", tree_to(params, "cuda"))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _build.KERNELS.values()
                if k.launches}
    plain = sum(k.plain_calls for k in _build.KERNELS.values())
    L = cfg.n_layers
    want = ({"gather_rows": 1 + steps, "flash_attention": L,
             "paged_attention": L * steps} if vlm else
            {"gather_rows": 1 + steps,
             "flash_attention": cfg.enc_layers + 2 * L,
             "paged_attention": 2 * L * steps})
    if launches != want or plain:
        raise AssertionError(f"family (a) [{name}]: launches {launches}, "
                             f"plain calls {plain}; want {want}, none")
    cpu, cpu_pools = run("cpu", params)
    tol = 2e-3
    err = hold_card_vs_cpu(f"family (a) [{name}]", card, cpu, tol)
    note = ""
    if not vlm:
        pool_err = 0.0
        for c, h in zip(card_pools, cpu_pools):
            pool_err = max(pool_err, (c - h).abs().max().item())
            for pools in (c, h):
                if pools[:, [0, 1, 2, 3, 5, 7]].any():
                    raise AssertionError(f"family (a) [{name}]: a cross "
                                         "pool slot no row owns was written")
                if torch.equal(pools[:, 4], pools[:, 6]):
                    raise AssertionError(f"family (a) [{name}]: the forged "
                                         "row's frames not at its own slot")
        if not pool_err <= 1e-4:
            raise AssertionError(f"family (a) [{name}]: cross pools differ "
                                 f"card vs CPU by {pool_err}")
        note = (f"; row 1's slot id 4 (row 0's) fenced to 6: the cross "
                f"pools' slots 4 and 6 within {pool_err:.3g} card vs CPU, "
                "slots no row owns zero, its cross reads (its logits) "
                "equal the CPU's")
    log(f"family (a) [{name}, {L} layers"
        + ("" if vlm else f" + {cfg.enc_layers} encoder") + f", d "
        f"{cfg.d_model}, f32]: card vs CPU greedy ids equal over prefill + "
        f"{steps} decodes of {B} rows ("
        + (f"{n_src} patches on a 4 x 4 grid + {S - n_src} text tokens, "
           "M-RoPE components differing" if vlm else
           f"{n_src} frames, {S} target tokens")
        + f"), max |logit err| {err:.3g} (tolerance {tol}){note}; launches "
        f"on the card {launches}")

    # training: loss and every gradient leaf
    guard = make_guard(cfg, ShapeConfig("phase10", "train", S, B))
    train = {k: (v[:, :S + 1] if k in ("tokens", "tgt") else
                 v[:, :S] if k == "positions" else v)
             for k, v in batch.items()}
    _build.reset_counts()
    loss_g, grads_g = loss_and_grads(torch, api, tree_to(params, "cuda"),
                                     tree_to(train, "cuda"), guard)
    torch.cuda.synchronize()
    plain = sum(k.plain_calls for k in _build.KERNELS.values())
    if plain:
        raise AssertionError(f"family (a) train [{name}]: {plain} plain "
                             "calls on the card")
    loss_c, grads_c = loss_and_grads(torch, api, params, train, guard)
    rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    if not rel <= 1e-5:
        raise AssertionError(f"family (a) train [{name}]: loss "
                             f"{float(loss_g)} on the card, {float(loss_c)}"
                             " on the CPU")
    worst = 0.0
    for i, (g, c) in enumerate(zip(grads_g, grads_c)):
        e, scale = (g.cpu() - c).abs().max().item(), c.abs().max().item()
        ratio = e / scale if scale else e
        if not ratio <= 1e-4:
            raise AssertionError(f"family (a) train [{name}]: gradient leaf "
                                 f"{i} off by {e:.3g} (max |grad| "
                                 f"{scale:.3g})")
        worst = max(worst, ratio)
    log(f"family (a) train [{name}]: card vs CPU loss {float(loss_g):.6f} / "
        f"{float(loss_c):.6f} (relative error {rel:.3g}, tolerance 1e-5); "
        f"{len(grads_c)} gradient leaves, worst max |err| / max |grad| "
        f"{worst:.3g} (tolerance 1e-4)")
    del grads_g
    gc.collect()
    torch.cuda.empty_cache()


class FormTally:
    """Within ``with``: each of ``sites`` — (module, function name,
    kernel, form) — wrapped to add to ``counts[form]`` the launches its
    kernel made inside the call (the wrapper's own count, before and
    after), so one kernel's launches split by the call site that made
    them."""

    def __init__(self, sites):
        from repro_torch.kernels import _build
        self.sites, self.kernels = sites, _build.KERNELS
        self.counts = collections.Counter()

    def __enter__(self):
        self.kept = []
        for mod, fn, kernel, form in self.sites:
            orig = getattr(mod, fn)
            self.kept.append((mod, fn, orig))

            def wrapped(*a, _orig=orig, _k=kernel, _f=form, **kw):
                before = self.kernels[_k].launches
                out = _orig(*a, **kw)
                self.counts[_f] += self.kernels[_k].launches - before
                return out
            setattr(mod, fn, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, fn, orig in self.kept:
            setattr(mod, fn, orig)


def family_floor_bytes(cfg, params, cache, B: int) -> dict:
    """The bytes one decode step must move at least: every weight it reads
    (vision: the layers, the final norm and the LM head; encoder-decoder:
    the decoder's layers — the encoder runs at prefill only — the final
    norm and the LM head; the embedding table for its B rows only, left
    out), the held K/V of every layer at the step's lengths (the cache's
    type), and the encoder-decoder's cross K/V of every layer."""
    head = params["embed"].get("head", params["embed"]["table"])
    layers = params["layers"] if cfg.family == "vlm" else params["dec"]
    weights = (tree_bytes(layers) + tree_bytes(params["norm_f"])
               + tree_bytes(head))
    kv = cache.kv if cfg.family == "encdec" else cache
    el = kv.k.element_size()
    held = int(kv.seq_lens.sum()) + B
    kv_bytes = 2 * cfg.n_layers * held * cfg.n_kv_heads * cfg.head_dim * el
    cross = 0
    if cfg.family == "encdec":
        cross = (2 * cfg.n_layers * int(cache.src_lens.sum())
                 * cfg.n_kv_heads * cfg.head_dim
                 * cache.cross_k.element_size())
    return {"weights": weights, "kv": kv_bytes, "cross": cross}


def family_full(torch, name: str, smi: str) -> dict:
    """Phase 10 (b): ``name`` at full width and depth, bf16 weights from a
    seeded generator, on the model API's defaults (a bf16 slab cache;
    seamless's 1,024-frame cross pools): B = 4 — qwen2-vl 256 patches on a
    16 x 16 grid + 64 text tokens, seamless 1,024 frames + 32 target
    tokens — a prefill, then 16 greedy decode steps (qwen2-vl's positions
    continuing past the grid), counts set to 0 just before the prefill and
    read after the last step: K3 once a step, K4 once a layer of the
    prefill (seamless: the encoder's and the cross-attention's not
    causal), K1 once a layer a step (seamless: the self- and the
    cross-attention), no plain version; every logit finite, every greedy
    id in the vocabulary.  Prints the prefill's and each decode step's
    wall time on the stream (CUDA events around the eager API calls: with
    a thousand or more small device operations a step, the host's time to
    launch them), then the device busy time and operations of one decode
    step and of one prefill (``torch.profiler``, uncounted), the step's
    busy time against its bytes floor at 3.35 TB/s, tokens/s and the peak
    memory; seamless also its LM head's time.  Returns the run's launches, each
    kernel's and each seamless form's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import encdec as ED
    from repro_torch.models import get_model
    from repro_torch.models import layers as LM

    cfg = get_config(name)
    api = get_model(cfg)
    vlm = cfg.family == "vlm"
    B, steps = FAMILY_B, FAMILY_STEPS
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = api.init(torch.Generator(device="cuda").manual_seed(23), "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    gen = torch.Generator().manual_seed(29)
    if vlm:
        S = VLM_SIDE ** 2 + VLM_TEXT
        batch = family_batch(torch, cfg, B, VLM_SIDE ** 2, S + steps, gen,
                             "cuda", LM.dtype_of(cfg))
        positions = batch.pop("positions")
        batch["tokens"] = batch["tokens"][:, :S]
        batch["positions"] = positions[:, :S]
        cache = api.init_cache(B, pow2(S + steps), device="cuda")
    else:
        S = ED_TGT
        batch = family_batch(torch, cfg, B, ED_FRAMES, S, gen, "cuda",
                             LM.dtype_of(cfg))
        cache = api.init_cache(B, pow2(S + steps), device="cuda")
    sites = [] if vlm else [
        (ED, "encode", "flash_attention", "encoder"),
        (LM, "full_attention", "flash_attention", "non-causal"),
        (ED, "cross_decode_attention", "paged_attention", "cross")]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * steps + 2)]
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    with FormTally(sites) as tally:
        torch.cuda.synchronize()
        _build.reset_counts()
        ev[0].record()
        cache, logits = api.prefill(params, cache, batch)
        ev[1].record()
        prefill_launches = {k.name: k.launches for k in _build.KERNELS.values()
                            if k.launches}
        ids = [logits.argmax(-1)]
        finite &= torch.isfinite(logits).all()
        floor = family_floor_bytes(cfg, params, cache, B)
        step_launches, wall0 = [], time.perf_counter()
        for i in range(steps):
            kw = {"positions": positions[:, S + i, :1]} if vlm else {}
            before = {k.name: k.launches for k in _build.KERNELS.values()}
            ev[2 + 2 * i].record()
            cache, logits = api.decode(params, cache,
                                       ids[-1].to(torch.int32), **kw)
            ev[3 + 2 * i].record()
            step_launches.append({k.name: k.launches - before[k.name]
                                  for k in _build.KERNELS.values()
                                  if k.launches - before[k.name]})
            ids.append(logits.argmax(-1))
            finite &= torch.isfinite(logits).all()
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall0
        launches = {k.name: k.launches for k in _build.KERNELS.values()
                    if k.launches}
        plain = sum(k.plain_calls for k in _build.KERNELS.values())
    # each form's launches: K4's in the encoder and in the cross-attention
    # (non-causal calls outside the encoder), K1's over the cross pool
    forms = {} if vlm else {
        "flash_attention/encoder": tally.counts["encoder"],
        "flash_attention/cross": tally.counts["non-causal"]
        - tally.counts["encoder"],
        "paged_attention/cross": tally.counts["cross"]}
    peak = torch.cuda.max_memory_allocated() / 1e9
    prefill_ms = ev[0].elapsed_time(ev[1])
    step_ms = [ev[2 + 2 * i].elapsed_time(ev[3 + 2 * i])
               for i in range(steps)]
    ids = torch.stack(ids).cpu()
    L = cfg.n_layers
    want_prefill = {"gather_rows": 1, "flash_attention": L} if vlm else \
        {"gather_rows": 1, "flash_attention": cfg.enc_layers + 2 * L}
    want_step = {"gather_rows": 1, "paged_attention": L if vlm else 2 * L}
    if plain or prefill_launches != want_prefill or any(
            s != want_step for s in step_launches):
        raise AssertionError(
            f"family (b) [{name}]: plain calls {plain}, launches per prefill "
            f"{prefill_launches} (want {want_prefill}), per step "
            f"{step_launches} (want {want_step})")
    if not vlm and forms != {"flash_attention/encoder": cfg.enc_layers,
                             "flash_attention/cross": L,
                             "paged_attention/cross": L * steps}:
        raise AssertionError(f"family (b) [{name}]: forms {forms}")
    if not bool(finite) or not bool(((ids >= 0) & (ids < cfg.vocab)).all()):
        raise AssertionError(f"family (b) [{name}]: a logit not finite or a "
                             "greedy id outside the vocabulary")
    nxt = ids[-1].to(torch.int32).cuda()
    kw = {"positions": positions[:, S + steps - 1, :1]} if vlm else {}
    with uncounted():
        step = profile_step(torch, lambda: api.decode(params, cache, nxt,
                                                      **kw))
        pre = profile_step(torch, lambda: api.prefill(params, cache, batch))
    floor_ms = sum(floor.values()) / HBM_BYTES_PER_S * 1e3
    head_note = ""
    if not vlm:
        head = params["embed"].get("head", params["embed"]["table"])
        x = torch.randn(B, cfg.d_model, generator=torch.Generator(
            device="cuda").manual_seed(31), device="cuda").to(head.dtype)
        with uncounted():
            head_ms = cuda_ms(torch, lambda: x @ head)
        head_floor = tree_bytes(head) / HBM_BYTES_PER_S * 1e3
        head_note = (f"; its LM head ({B} x {cfg.d_model} @ {cfg.d_model} x "
                     f"{cfg.vocab}, bf16, unpadded) {head_ms:.5f} ms against "
                     f"its bytes' {head_floor:.5f} ms")
    med = statistics.median(step_ms)
    log(f"family (b) [{name}, {L} layers"
        + ("" if vlm else f" + {cfg.enc_layers} encoder")
        + f", {n_params / 1e9:.2f} B params ({tree_bytes(params) / 1e9:.2f} "
        f"GB), {cfg.dtype}, the API's bf16 slab cache]: B = {B}, "
        + (f"{VLM_SIDE ** 2} patches on a {VLM_SIDE} x {VLM_SIDE} grid + "
           f"{VLM_TEXT} text tokens" if vlm else
           f"{ED_FRAMES} frames + {S} target tokens")
        + f"; wall on the stream (eager API calls, host-bound): prefill "
        f"{prefill_ms:.3f} ms, decode step {med:.3f} ms median (min "
        f"{min(step_ms):.3f}, max {max(step_ms):.3f}) over {steps} greedy "
        f"steps, {med * 1e3 / step['ops']:.1f} us a device operation; "
        f"device busy (profiler): prefill {pre['busy_ms']:.3f} ms in "
        f"{pre['ops']} operations, decode step {step['busy_ms']:.3f} ms in "
        f"{step['ops']} operations ("
        + ", ".join(f"{c} {ms:.3f}" for c, ms in step["by_class"].items())
        + "; the top kernels " + ", ".join(
            f"{k[:48]} {ms:.3f} ms x{n}" for k, ms, n in step["top"][:4])
        + f") against a bytes floor of {floor_ms:.4f} ms (weights "
        f"{floor['weights'] / 1e9:.3f} GB, KV {floor['kv'] / 1e6:.2f} MB"
        + ("" if vlm else f", cross KV {floor['cross'] / 1e6:.1f} MB")
        + f" at 3.35 TB/s; {floor['weights'] / HBM_BYTES_PER_S * 1e3:.4f} "
        f"ms for the weights alone); {B * steps / wall:.1f} tokens/s "
        f"(wall); peak {peak:.2f} GB; launches per prefill "
        f"{prefill_launches}, per decode step {step_launches[0]}"
        + (f" (forms: {forms})" if forms else "")
        + f"; every logit finite, every greedy id in [0, {cfg.vocab})"
        f"{head_note} — {smi}")
    out = {"launches": launches}
    if not vlm:
        out["forms"] = forms
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_phase(torch, smi: str) -> dict:
    """Phase 10: (a) each family at full width and 2 layers, card against
    CPU; (b) each at full width and depth, bf16, on the API's defaults.
    Returns each path's launches."""
    t0 = time.perf_counter()
    for name in FAMILIES:
        family_card_vs_cpu(torch, name)
    paths = {}
    for name in FAMILIES:
        paths[name] = family_full(torch, name, smi)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return paths


# --------------------------------------------------------------------- #
# Phase 2 (the float8 pool) and phase 11: training the recurrent        #
# families, the MoE variants, the float8 KV pool                        #
# --------------------------------------------------------------------- #

#: phase 11 (b)'s recurrent training runs: each family at full width and
#: this depth (xlstm-350m's full 24; zamba2-7b's 81 layers do not train on
#: one card — 4 groups of 6 and a 3-layer tail), through the CLI
#: xlstm-350m at 12 of its 24 layers since PR 29, to keep the run
#: inside its time (its 24-layer runs took 115.6-141.9 s of it)
FAMILY_TRAIN = {"xlstm-350m": 12, "zamba2-7b": 27}
#: the CLI's flags of phase 11 (b)'s runs (batch 4 x 512, remat off)
FAMILY_ARGV = ["--steps", "3", "--batch", "4", "--seq", "512", "--lr",
               "6e-4", "--log-every", "1", "--device", "cuda"]
#: the eager steps phase 11 (b) runs beside each compiled CLI run, from
#: the same weights on the same batches; none beside xlstm-350m's, whose
#: eager step takes 11-23 s of host time on an H100 80GB HBM3 at 700 W:
#: one eager step from a copy of the state its first replay started from
#: is held against that replay instead (:func:`held_vs_eager`)
FAMILY_EAGER = {"xlstm-350m": 0, "zamba2-7b": 3}
#: the eager CLI step (host clock, ms) an earlier run measured at the same
#: flags on an H100 80GB HBM3 at 700 W (PERF.md §5), and its depth
FAMILY_EAGER_BEFORE = {"xlstm-350m": (11360, 24), "zamba2-7b": (446, 27)}
#: the MoE variants' model: qwen3-moe-30b-a3b at full width and 2 layers
MOE_TRAIN = ("qwen3-moe-30b-a3b", 2)
#: the float8 decode path: stablelm-3b at full depth over a slab pool
FP8_PATH = "stablelm-3b/fp8"


def fp8_kernel_rows(torch) -> list:
    """Phase 2's K1 rows over a float8 e4m3 pool: at stablelm-3b's slab
    shape (q (8, 32, 80) bf16, the 16-slot x 4-page layer view) and at
    qwen3-moe-30b-a3b's GQA shape (G = 8, D = 128), 17-80 held tokens,
    forged table ids, per-row fences — each against the plain version
    (bf16 query: 1/2 bf16 ulp + K1_SLACK, the bf16-math control past it),
    at every cluster size and with an f32 query (1e-4), one device
    operation a call, timed, with its bound (one byte an element).  The
    stablelm-3b row's launches come from phase 11 (c); the GQA shape is on
    no path here (0)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention

    gen = torch.Generator(device="cuda").manual_seed(8888)
    i32 = dict(dtype=torch.int32, device="cuda")
    fp8 = torch.float8_e4m3fn
    rows = []
    K1 = sys.modules["repro_torch.kernels.paged_attention"]
    for name in PATHS:
        cfg = get_config(name)
        B, H, KH, D, page, P = 8, cfg.n_heads, cfg.n_kv_heads, \
            cfg.head_dim, 64, 64

        def row(kernel, source, replaces, **kw):
            path = FP8_PATH if FP8_PATH.startswith(name + "/") else name
            rows.append(dict(kernel=kernel, path=path, route="cuda",
                             source=f"src/repro_torch/kernels/csrc/{source}",
                             replaces=f"src/repro/kernels/{replaces}", **kw))

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")

        k_pool, v_pool = (randn(P, page, KH, D).to(fp8) for _ in range(2))
        q = randn(B, H, D).to(torch.bfloat16)
        table = torch.randint(0, P, (B, 4), generator=gen, **i32)
        lens = torch.randint(17, 81, (B,), generator=gen, **i32)
        base = torch.tensor([16, 16, 32, 32, 16, 32, 0, 0], **i32)
        msk = torch.tensor([15, 15, 15, 15, 15, 15, 3, 3], **i32)
        args = (k_pool, v_pool, table, lens, base, msk, None)
        chosen, errs = K1.cluster_size, []
        try:
            for c in (1, 2, 4, 8):
                K1.cluster_size = lambda pairs, n_sm, c=c: c
                for q_ in (q, q.float()):
                    errs.append(check_paged_attention(torch, q_, *args)[
                        "ratio"])
        finally:
            K1.cluster_size = chosen
        chk = k1_pool_row(torch, row, name, q, *args,
                          name=f"paged_attention@{name}/fp8-pool",
                          **({} if cfg.moe is None else {"launches": 0}))
        if not torch.equal(chk["out"], paged_attention(
                q, k_pool.float(), v_pool.float(), table, lens, base, msk)):
            raise AssertionError(f"paged_attention [{name}]: the fp8 pool "
                                 "differs from the same pool widened to f32")
        log(f"K1 on an fp8 pool ok [{name}]: max |err| {chk['err']:.3g}, "
            f"error/bound {chk['ratio']:.3f}, the bf16-math control "
            f"{chk['ctrl_ratio']:.3g}; every cluster size 1-8, bf16 and f32 "
            f"queries, worst error/bound {max(errs):.3f}; equal bit for bit "
            "to the kernel over the pool widened to f32")
    log_rows(rows)
    return rows


@contextlib.contextmanager
def at_depth(name: str, n_layers: int):
    """Within ``with``: the registered config ``name`` at ``n_layers``
    layers (the training CLI has no depth flag, as the reference's has
    none)."""
    from repro_torch.configs import base
    base.get_config(name)
    kept = base._REGISTRY[name]
    base._REGISTRY[name] = dataclasses.replace(kept, n_layers=n_layers)
    try:
        yield base._REGISTRY[name]
    finally:
        base._REGISTRY[name] = kept


def family_train_full(torch, name: str, smi: str) -> dict:
    """Phase 11 (b): ``name`` at full width and :data:`FAMILY_TRAIN`'s
    depth (bf16), trained 3 steps by ``repro_torch.launch.train``'s
    ``main`` in-process (compiled; :data:`FAMILY_ARGV`: AdamW + cosine at
    6e-4, batch 4 x 512, SyntheticLM seed 0, BITWISE guard, remat off),
    counts set to 0 just before and read just after, then with
    ``--no-guard`` on the same weights, stopped after 2 steps
    (``--stop-after``: the same schedule); then the compiled step held
    against eager: :data:`FAMILY_EAGER`'s eager steps from the same
    weights on the same batches, or, where it asks for none, one eager
    step from a copy of the state the first replay started from
    (:func:`held_vs_eager`).  Gates: every loss finite; K3 once a step,
    K4 once a shared-attention call; one graph a run; the compiled losses
    (and a held step's params and moments) within the bounds of
    :func:`compiled_cli_line`.  Returns the guarded run's launches."""
    argv = ["--arch", name] + FAMILY_ARGV
    n_steps, tokens = 3, 4 * 512
    side = FAMILY_EAGER[name]
    with at_depth(name, FAMILY_TRAIN[name]) as cfg:
        want = {k: n_steps * v for k, v in train_launches(cfg).items()}
        summary, lines, launches, peak, cli = run_train_cli(
            torch, argv, hold=None if side else 1)
        _, lines_n, launches_n, peak_n, cli_n = run_train_cli(
            torch, argv + ["--no-guard", "--stop-after", "2"])
        if side:
            eager, eager_ms, eager_peak = eager_cli_loop(torch, argv, side)
    losses = [x for x, _ in lines] + [x for x, _ in lines_n]
    want_n = {k: v // n_steps * 2 for k, v in want.items()}
    if launches != want or launches_n != want_n:
        raise AssertionError(f"families train (b) [{name}]: launches "
                             f"{launches} / {launches_n}, want {want} / "
                             f"{want_n}")
    if not (len(losses) == n_steps + 2
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"families train (b) [{name}]: losses {losses}")
    ms = {g: statistics.median(m for _, m in ls[1:])
          for g, ls in ((True, lines), (False, lines_n))}
    log(f"families train (b) [{name}, {cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.dtype}, batch 4 x 512]: losses guarded "
        + ", ".join(f"{x:.4f}" for x, _ in lines) + "; native "
        + ", ".join(f"{x:.4f}" for x, _ in lines_n)
        + f"; CLI step (host clock to the loss on the host, steps 1-2 / "
        f"1) median {ms[True]:.0f} ms guarded, {ms[False]:.0f} ms native -> "
        f"guarded/native {ms[True] / ms[False]:.4f}; "
        f"{tokens / ms[True] * 1e3:.0f} tokens/s guarded; peak "
        f"{peak:.2f} GB (native {peak_n:.2f} GB); launches {launches}; on "
        f"{smi}")
    tag = f"families train (b) compiled [{name}, {cfg.n_layers} layers, " \
        "guarded]"
    before_ms, before_depth = FAMILY_EAGER_BEFORE[name]
    before = (f"an earlier run's eager CLI step at {before_depth} layers: "
              f"{before_ms} ms")
    if side:
        compiled_cli_line(tag, cli, eager, eager_ms, eager_peak, before,
                          smi)
    else:
        held_vs_eager(torch, tag, cli, before, smi)
    log(f"families train (b) compiled [{name}, native]: replays by CUDA "
        f"events " + "/".join(f"{x:.2f}" for x in cli_n["ms"][1:])
        + f" ms (first call {cli_n['ms'][0]:.1f} ms); {cli_n['graphs']}; "
        f"launches a replay {cli_n['replay']} (guarded {cli['replay']})")
    return {"launches": launches}


def moe_variants(torch, smi: str) -> None:
    """Phase 11 (b): qwen3-moe-30b-a3b at full width (128 experts, top-8,
    d 2,048) and 2 layers, bf16, batch 4 x 512 (C = 256 slots an expert),
    the BITWISE guard, one seed's weights: the loss and every gradient of
    the ``scatter`` and ``einsum`` dispatches held together at bf16
    tolerance (loss within 1e-2 relative, each leaf's max |error| within
    5e-2 of its max |value|); then the train step (AdamW) of each dispatch
    with remat off, ``nothing`` and ``dots``, each run three times from
    the seed's weights over the same 4 batches: eagerly (its steps 2-4
    timed by CUDA events, the peak memory, the launches a step), eagerly
    again (the card's own spread) and compiled (``compile_train_step``).
    Gates, as :func:`train_compiled_vs_eager`'s: one graph; the compiled
    losses within 1e-5 relative of the first eager run's and every param
    and moment leaf within 1e-4 of its max |value| — or the eager spread,
    where larger; a replay's launches equal to an eager step's (K5 once a
    MoE layer a forward), no plain version.  Prints whether each run is
    bit-equal to the first and the compiled replays' times."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import build_train_step, \
        compile_train_step

    name, depth = MOE_TRAIN
    cfg = dataclasses.replace(get_config(name), n_layers=depth)
    shape = ShapeConfig("phase11", "train", 512, 4)
    steps = {(d, r, p): build_train_step(cfg, shape, remat=r,
                                         moe_dispatch=d, remat_policy=p)
             for d in ("scatter", "einsum")
             for r, p in ((False, "nothing"), (True, "nothing"),
                          (True, "dots"))}
    api = next(iter(steps.values())).api
    guard = next(iter(steps.values())).guard
    opt = next(iter(steps.values())).opt

    def fresh():
        p = api.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
        return p, opt.init(p)

    params = fresh()[0]
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=512,
                                  global_batch=4))
    toks = torch.from_numpy(data.batch(0)["tokens"]).cuda()
    got = {d: loss_and_grads(torch, api, params, toks, guard, dispatch=d)
           for d in ("scatter", "einsum")}
    rel = abs(float(got["einsum"][0]) - float(got["scatter"][0])) \
        / abs(float(got["scatter"][0]))
    worst = 0.0
    for a, b in zip(got["einsum"][1], got["scatter"][1]):
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        worst = max(worst, err / scale if scale else err)
    if not (rel <= 1e-2 and worst <= 5e-2):
        raise AssertionError(f"moe variants: einsum vs scatter loss "
                             f"relative {rel:.3g}, worst leaf {worst:.3g}")
    log(f"moe variants [{name}, {depth} layers, {cfg.dtype}, batch 4 x 512, C "
        f"{max(int(2 * cfg.moe.top_k * 2048 / cfg.moe.num_experts), 8)}]: "
        f"loss scatter {float(got['scatter'][0]):.5f} / einsum "
        f"{float(got['einsum'][0]):.5f} (relative {rel:.3g}, tolerance "
        f"1e-2); {len(got['scatter'][1])} gradient leaves, worst max |err| "
        f"/ max |grad| {worst:.3g} (tolerance 5e-2)")
    del got, params
    batches = [{"tokens": torch.from_numpy(data.batch(i)["tokens"]).cuda()}
               for i in range(4)]
    for (d, r, p), step in steps.items():
        tag = f"moe variants [{name}, dispatch {d}, remat {p if r else 'off'}]"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pa, sa, loss_a, ms_a, launch_a, plain_a = step_loop(
            torch, step.fn, *fresh(), batches)
        peak = torch.cuda.max_memory_allocated() / 1e9
        want = tree_leaves((pa, sa))
        pb, sb, loss_b, _, _, plain_b = step_loop(torch, step.fn, *fresh(),
                                                  batches)
        spread, same_b = leaf_gap(torch, tree_leaves((pb, sb)), want)
        spread_loss = loss_gap(loss_b, loss_a)
        del pb, sb
        gc.collect()
        torch.cuda.empty_cache()
        # the compiled run's peak above the first run's state, held here
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        compiled = compile_train_step(step)
        pc, sc, loss_c, ms_c, launch_c, plain_c = step_loop(
            torch, compiled, *fresh(), batches)
        peak_c = (torch.cuda.max_memory_allocated() - held) / 1e9
        gap, same_c = leaf_gap(torch, tree_leaves((pc, sc)), want)
        gap_loss = loss_gap(loss_c, loss_a)
        line = graph_line(compiled)
        graphs = list(compiled.graphs.values())
        replay = {k.name: n for k, n in graphs[0].launches.items()} \
            if graphs else None
        per_step = {k: n // len(batches) for k, n in launch_a.items()}
        del pa, sa, pc, sc, want, compiled, graphs
        loss_tol = max(COMPILED_LOSS_TOL, spread_loss)
        leaf_tol = max(COMPILED_LEAF_TOL, spread)
        if line[0] != "1" or replay != per_step or launch_c != launch_a \
                or per_step.get("moe_histogram", 0) < depth \
                or plain_a or plain_b or plain_c:
            raise AssertionError(f"{tag} compiled: {line}; launches a "
                                 f"replay {replay}, an eager step "
                                 f"{per_step}; plain calls {plain_a} / "
                                 f"{plain_b} / {plain_c}")
        if not (gap_loss <= loss_tol and gap <= leaf_tol):
            raise AssertionError(
                f"{tag}: losses {loss_c} compiled, {loss_a} eager (relative "
                f"{gap_loss:.3g}, tolerance {loss_tol:.3g}); worst leaf "
                f"{gap:.3g} (tolerance {leaf_tol:.3g})")
        times = ms_a[1:]
        log(f"{tag}: step (CUDA events) "
            + "/".join(f"{t:.2f}" for t in times)
            + f" ms, median {statistics.median(times):.2f} ms, "
            f"{2048 / statistics.median(times) * 1e3:.0f} tokens/s; peak "
            f"{peak:.2f} GB; launches a step {per_step}; eager twice — "
            f"losses relative {spread_loss:.3g}, worst leaf {spread:.3g}, "
            f"bit-equal {same_b and loss_b == loss_a}; compiled vs eager — "
            f"losses relative {gap_loss:.3g} (tolerance {loss_tol:.3g}), "
            f"worst param / moment leaf max |err| / max |value| {gap:.3g} "
            f"(tolerance {leaf_tol:.3g}), bit-equal "
            f"{same_c and loss_c == loss_a}; compiled replays "
            + "/".join(f"{t:.2f}" for t in ms_c[1:])
            + f" ms, median {statistics.median(ms_c[1:]):.2f} ms (first call "
            f"{ms_c[0]:.1f} ms), peak {peak_c:.2f} GB above the eager run's "
            f"state held for the comparison, {line}, launches a replay = "
            f"an eager step's; on {smi}")
    del steps, batches
    gc.collect()
    torch.cuda.empty_cache()


def fp8_decode(torch, smi: str) -> dict:
    """Phase 11 (c): stablelm-3b at full width and depth (32 layers, bf16
    weights from a seeded generator) through the model API over a slab
    pool of 4 rows x 256 tokens, in float8 e4m3 and in float32 on the same
    weights: a 64-token prefill and 8 greedy decode steps, both pools fed
    the f32 run's tokens; the float8 run's kernel counts set to 0 just
    before its prefill and read after its last step — K3 once a call, K4
    once a layer of the prefill, K1 once a layer a step, no plain
    version.  Gates: every logit finite, each step's logits correlated
    with the f32 pool's above 0.98 (the reference's H3).  Prints each
    pool's decode step time (CUDA events around ``api.decode``) and its
    device busy time (``torch.profiler``) against the step's bytes floor.
    Returns the float8 run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import get_model

    name = FP8_PATH.split("/")[0]
    cfg = get_config(name)
    api = get_model(cfg)
    params = api.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    B, S, steps, max_len = 4, 64, 8, 256
    toks = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(3))
    runs, nxt_f32 = {}, []
    with torch.no_grad():
        for pool, dt in (("f32", torch.float32),
                         ("fp8", torch.float8_e4m3fn)):
            cache = api.init_cache(B, max_len, dtype=dt, device="cuda")
            torch.cuda.synchronize()
            _build.reset_counts()
            cache, lg = api.prefill(params, cache, {"tokens": toks})
            logits, ms = [lg.float()], []
            for i in range(steps):
                nxt = lg.argmax(-1).to(torch.int32) if pool == "f32" \
                    else nxt_f32[i]
                nxt_f32.append(nxt) if pool == "f32" else None
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                cache, lg = api.decode(params, cache, nxt)
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
                logits.append(lg.float())
            launches = {k.name: k.launches for k in _build.KERNELS.values()
                        if k.launches}
            plain = sum(k.plain_calls for k in _build.KERNELS.values())
            with uncounted():
                prof = profiled_call(torch, lambda: api.decode(
                    params, cache, nxt))
            runs[pool] = (logits, ms, launches, plain, prof,
                          tree_bytes(cache))
            del cache
    want = {"gather_rows": 1 + steps, "flash_attention": cfg.n_layers,
            "paged_attention": cfg.n_layers * steps}
    launches, plain = runs["fp8"][2], runs["fp8"][3]
    if launches != want or plain:
        raise AssertionError(f"fp8 decode: launches {launches}, plain "
                             f"{plain}; want {want}, none")
    corr = []
    for a, b in zip(runs["f32"][0], runs["fp8"][0]):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError("fp8 decode: a logit is not finite")
        corr.append(torch.corrcoef(torch.stack([a.reshape(-1),
                                                b.reshape(-1)]))[0, 1].item())
    if not min(corr) > 0.98:
        raise AssertionError(f"fp8 decode: correlation {min(corr):.4f}")
    same = [int((a.argmax(-1) == b.argmax(-1)).sum())
            for a, b in zip(runs["f32"][0], runs["fp8"][0])]
    # the step's bytes floor: the weights once, each row's held K and V
    # (prompt + step tokens, every layer) in the pool's type
    w_bytes = tree_bytes(params)
    held = B * (S + steps // 2) * cfg.n_layers * 2 * cfg.n_kv_heads \
        * cfg.head_dim
    for pool, size in (("f32", 4), ("fp8", 1)):
        logits, ms, _, _, prof, pool_bytes = runs[pool]
        floor = (w_bytes + held * size) / HBM_BYTES_PER_S * 1e3
        dev = "not measured" if prof is None else \
            f"{prof[1]:.3f} ms busy, {prof[0]:g} device operations"
        log(f"fp8 decode [{name}, {cfg.n_layers} layers, {pool} slab pool "
            f"of {pool_bytes / 1e9:.2f} GB, B {B}, prompt {S}]: decode step "
            f"(CUDA events around api.decode) median "
            f"{statistics.median(ms):.3f} ms; device {dev}; bytes floor "
            f"{floor:.3f} ms (weights + the held K/V); on {smi}")
    log(f"fp8 decode [{name}]: logits finite, correlation with the f32 "
        f"pool per call (prefill, then 8 steps) "
        + ", ".join(f"{c:.5f}" for c in corr)
        + f" (gate > 0.98); greedy ids equal {same} of {B}; launches "
        f"{launches}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches}


def families_train_phase(torch, smi: str) -> dict:
    """Phase 11: (a) card against CPU, f32, at full width — xlstm-350m at
    2 layers, zamba2-7b at 7 (a group of 6 and a 1-layer tail) and
    qwen3-moe-30b-a3b at 2 with the ``einsum`` dispatch (phase 9 (a) held
    its scatter dispatch) — the loss and every gradient; (b) the recurrent
    families' training runs and the MoE variants; (c) the float8 decode.
    Returns each path's launches.  Order: (a), the MoE variants, (c),
    then (b)'s two runs."""
    t0 = time.perf_counter()
    label = "families train (a)"
    train_card_vs_cpu(torch, "xlstm-350m", label=label)
    train_card_vs_cpu(torch, "zamba2-7b", n_layers=7, label=label)
    train_card_vs_cpu(torch, MOE_TRAIN[0], label=label, dispatch="einsum")
    # the compiled step against eager (phase 9 (a)'s MoE model too: two
    # of its f32 copies and a graph pool need the card's memory whole;
    # its remat variants are held in bf16 by the MoE variants below)
    train_compiled_vs_eager(torch, "xlstm-350m", label=label)
    train_compiled_vs_eager(torch, "zamba2-7b", n_layers=7, label=label)
    train_compiled_vs_eager(torch, MOE_TRAIN[0], label=label)
    log(f"phase 11 (a): {time.perf_counter() - t0:.1f} s")
    # the MoE variants' optimizer takes 768 MiB blocks, so they run before
    # the recurrent runs split the cache into smaller ones; zamba2-7b,
    # the largest (64 GB peak), runs last
    log_memory(torch, "moe variants, before")
    moe_variants(torch, smi)
    log_memory(torch, "fp8 decode, before")
    paths = {FP8_PATH: fp8_decode(torch, smi)}
    for name in FAMILY_TRAIN:
        log_memory(torch, f"families train (b) [{name}], before")
        t1 = time.perf_counter()
        paths[f"{name}/train"] = family_train_full(torch, name, smi)
        log(f"families train (b) [{name}]: {time.perf_counter() - t1:.1f} s")
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    return paths


# A phase in a process of its own, from the checkout at argv[1]: the code
# put in for CODE leaves the phase's paths' launches in ``paths`` (with
# ``cs``, ``torch`` and ``smi`` in scope); the phase's lines pass through
# and ``paths`` comes back as one JSON line.
_WORKER = """
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import torch
import chip_smoke as cs
from repro_torch.kernels import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build_all()
smi = cs.smi_line()
CODE
print("PATHS " + json.dumps(paths), flush=True)
"""


def phase_worker(torch, phase: int, code: str) -> dict:
    """Phase ``phase`` in a process of its own (``code`` as
    :data:`_WORKER` takes it), started with this process's cache released,
    while the card's memory is whole.  After the serve paths ~75 GB of
    this process's cache stay reserved (held by ~1 GB of allocations the
    collector does not see) in pieces that neither the MoE optimizer's
    768 MiB buffers (phase 11) nor a compiled train step's warm-up, whose
    side stream cannot reuse them (phase 9), could take.  Returns the
    worker's paths' launches."""
    gc.collect()
    torch.cuda.empty_cache()
    log_memory(torch, f"before phase {phase} (this process)")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c",
                             _WORKER.replace("CODE", code), str(ROOT)],
                            stdout=subprocess.PIPE, text=True)
    paths = None
    for line in proc.stdout:
        if line.startswith("PATHS "):
            paths = json.loads(line[len("PATHS "):])
        else:
            print(line, end="", flush=True)
    if proc.wait() != 0 or paths is None:
        raise AssertionError(f"phase {phase}'s worker failed (exit "
                             f"{proc.returncode})")
    log(f"phase {phase}'s process: {time.perf_counter() - t0:.1f} s")
    return paths


# --------------------------------------------------------------------- #
# Phase 2 (the 32k rows) and phase 12: the reference's step bundles       #
# --------------------------------------------------------------------- #

#: phase 12's model, at full width and depth over the reference's 32k
#: serving shapes with the batch cut to fit one card
BUNDLE_ARCH = "stablelm-3b"
BUNDLE_BATCH = 4
#: decode bundle steps a run, and the prompts the prefill bundle fills
#: the decode cache with: 511 of a row's 512 pages, room for the steps
BUNDLE_STEPS = 16
BUNDLE_PROMPT = 32_704
#: the paths of phase 12 (b), one per pool type (the reference's kv_dtype)
BUNDLE_PATHS = {"bf16": f"{BUNDLE_ARCH}/32k", "f8": f"{BUNDLE_ARCH}/32k-fp8"}


def bundle_shapes():
    """The reference's ``prefill_32k`` and ``decode_32k`` with the global
    batch cut to :data:`BUNDLE_BATCH` (from 32 and 128)."""
    from repro_torch.configs import SHAPES
    return {kind: dataclasses.replace(SHAPES[f"{kind}_32k"],
                                      global_batch=BUNDLE_BATCH)
            for kind in ("prefill", "decode")}


#: K4's slack at 32k keys, as a share of each query row's output RMS: the
#: kernel rounds P to bf16 (a relative error of at most 2^-8 a weight,
#: ~0.45 * 2^-8 RMS), so its output moves by ~0.0018 of the row's RMS at
#: one sigma and ~0.008 at the ~4.5 sigma of the ~10^5 sampled elements;
#: leaving out one 64-key tile of 32k moves a late row by ~sqrt(64 / n)
#: = 0.044 of its RMS at one sigma
K4_LONG_SLACK = 2 ** -5
#: K4's keys a tile (``kBK`` of ``csrc/flash_attention.cu``)
K4_TILE = 64


def k4_long_row(torch, row, path, q, k, v, samples: int = 8, blk: int = 128):
    """K4 (causal, bf16) at a length whose plain version cannot hold its
    scores whole (S x S floats a (row, head): 4.3 GB at 32,768, 550 GB the
    call): held against the plain math in float32 on (row, head, query
    block of ``blk``) triples — the first two and the last blocks of two
    (row, head) pairs and ``samples`` drawn at random — each computed
    alone over the keys its block attends, within half a bf16 ulp (of the
    larger of the two values) plus :data:`K4_LONG_SLACK` times the query
    row's output RMS; the control, the plain version with the first key
    tile left out on the last blocks (a dropped far tile), must break that
    bound.  Its plain time is the whole call's, the plain version run one
    (row, head) at a time; timed against
    ``scaled_dot_product_attention(is_causal=True)`` on the whole call,
    with its bound.  One device operation a call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.graph_analysis import flash_attention_cost
    import torch.nn.functional as F

    B, S, H, D = q.shape
    nb = S // blk
    call = (lambda: flash_attention(q, k, v, causal=True))
    out = call()
    gen = torch.Generator().manual_seed(5)
    picks = [(0, 0, 0), (B - 1, H - 1, 1), (0, 0, nb - 1),
             (B - 1, H // 2, nb - 1)] + [
        tuple(int(torch.randint(0, n, (1,), generator=gen))
              for n in (B, H, nb)) for _ in range(samples)]

    def plain_block(b, h, qb, drop: int = 0):
        lo, hi = qb * blk, (qb + 1) * blk
        s = (q[b, lo:hi, h].float() @ k[b, :hi, h].float().T) \
            / math.sqrt(D)
        qpos = torch.arange(lo, hi, device="cuda")[:, None]
        kpos = torch.arange(hi, device="cuda")[None, :]
        s = torch.where((kpos <= qpos) & (kpos >= drop), s,
                        torch.full((), -1e30, device="cuda"))
        return torch.softmax(s, dim=-1) @ v[b, :hi, h].float()

    def err_ratio(got, want):
        got = got.float()
        err = (got - want).abs()
        bound = (half_ulp_bf16(torch, torch.maximum(want.abs(), got.abs()))
                 + K4_LONG_SLACK * want.square().mean(-1, keepdim=True)
                 .sqrt())
        return err.max().item(), (err / bound).max().item()

    err = ratio = ctrl = 0.0
    for b, h, qb in picks:
        want = plain_block(b, h, qb)
        e, r = err_ratio(out[b, qb * blk:(qb + 1) * blk, h], want)
        err, ratio = max(err, e), max(ratio, r)
        if qb == nb - 1:
            ctrl = max(ctrl, err_ratio(
                plain_block(b, h, qb, drop=K4_TILE).to(torch.bfloat16),
                want)[1])
    if not ratio <= 1.0:
        raise AssertionError(f"flash_attention [{path}]: error {err} exceeds "
                             f"its bound ({ratio:.3f}x) on the sampled "
                             "(row, head, block) triples")
    if not ctrl > 1.0:
        raise AssertionError(f"flash_attention [{path}]: the control (the "
                             f"first key tile left out) within the bound "
                             f"({ctrl:.3f}x): the bound cannot see a "
                             "dropped tile")
    ops = device_ops_per_call(torch, call)
    if ops != 1:
        raise AssertionError(f"flash_attention [{path}]: {ops:g} device "
                             "operations a call, want 1")

    def plain():
        for b in range(B):
            for h in range(H):
                ref.flash_attention_ref(q[b:b + 1, :, h:h + 1],
                                        k[b:b + 1, :, h:h + 1],
                                        v[b:b + 1, :, h:h + 1], causal=True)

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = S * (S + 1) // 2
    row("flash_attention", "flash_attention.cu", "flash_attention.py:84",
        device_ops=ops, max_abs_err=err,
        tolerance=(f"1/2 bf16 ulp + {K4_LONG_SLACK:g} x the query row's "
                   f"output RMS of the f32 plain version, on {len(picks)} "
                   f"(row, head, {blk}-query block) triples, the first and "
                   f"last blocks among them (worst error/bound {ratio:.3f};"
                   f" the control (the first {K4_TILE}-key tile left out, "
                   f"last blocks) {ctrl:.3g})"),
        ms=cuda_ms(torch, call, iters=5, warmup=1),
        plain_ms=cuda_ms(torch, plain, iters=1, warmup=0),
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters=5, warmup=1),
        library_call="F.scaled_dot_product_attention(is_causal=True)",
        shape=f"q/k/v ({B},{S},{H},{D}) bf16, causal; plain version one "
              "(row, head) at a time",
        **rule_bound(flash_attention_cost(q, k, True, pairs=pairs),
                     "bfloat16"))
    return err


def bundle_kernel_rows(torch) -> list:
    """Phase 2's rows at phase 12 (b)'s shapes (stablelm-3b, 4 rows over
    32,768 tokens): K1 over the bf16 and the float8 layer view (4,096
    pages, q (4, 32, 80) bf16, 32,704-32,720 held tokens, each row's 512
    pages through the page table, 512 foreign pages after each), each
    against its plain version with its control and the
    fence check (:func:`check_paged_attention`); K4 at
    (4, 32,768, 32, 80) bf16 causal (:func:`k4_long_row`); K3 over the
    50,304 x 2,560 bf16 table with the prefill's 131,072 ids under the
    65,536 fence, against ``index_select``.  Launches: phase 12 (b)'s."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.gather_rows import gather_rows
    from repro_torch.launch.graph_analysis import gather_rows_cost

    cfg = get_config(BUNDLE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(3232)
    B, S, H, KH, D = BUNDLE_BATCH, bundle_shapes()["prefill"].seq_len, \
        cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    page = 64
    P = S // page
    i32 = dict(dtype=torch.int32, device="cuda")
    rows = []

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    # K1 over each pool type's layer view: slot b's pages 2 P b + p, each
    # row's P pages followed by P its table does not reach (the foreign
    # pages the fence check clobbers; K1 takes a pow2 pool)
    q = randn(B, H, D)
    table = (torch.arange(B, **i32)[:, None] * 2 * P
             + torch.arange(P, **i32)[None, :])
    lens = torch.tensor([BUNDLE_PROMPT, BUNDLE_PROMPT + 5,
                         BUNDLE_PROMPT + 10, BUNDLE_PROMPT + 16], **i32)
    base = torch.zeros(B, **i32)
    msk = torch.full((B,), -1, **i32)
    for kv_dtype, path in BUNDLE_PATHS.items():
        dt = torch.bfloat16 if kv_dtype == "bf16" else torch.float8_e4m3fn

        def row(kernel, source, replaces, path=path, **kw):
            rows.append(dict(kernel=kernel, path=path, route="cuda",
                             name=f"{kernel}@{path}",
                             source=f"src/repro_torch/kernels/csrc/{source}",
                             replaces=f"src/repro/kernels/{replaces}", **kw))

        k_pool, v_pool = (randn(2 * B * P, page, KH, D, dtype=dt)
                          for _ in range(2))
        k1_pool_row(torch, row, path, q, k_pool, v_pool, table, lens, base,
                    msk)
        del k_pool, v_pool
    path = BUNDLE_PATHS["bf16"]

    def row(kernel, source, replaces, **kw):
        rows.append(dict(kernel=kernel, path=path, route="cuda",
                         name=f"{kernel}@{path}",
                         source=f"src/repro_torch/kernels/csrc/{source}",
                         replaces=f"src/repro/kernels/{replaces}", **kw))

    qkv = [randn(B, S, H, D) for _ in range(3)]
    k4_long_row(torch, row, path, *qkv)
    del qkv
    gc.collect()
    torch.cuda.empty_cache()
    # K3: the prefill bundle's ids under the vocab fence
    table = randn(cfg.vocab, cfg.d_model)
    ids = torch.randint(0, cfg.vocab, (B * S,), generator=gen, **i32)
    mask = pow2(cfg.vocab) - 1
    if not torch.equal(gather_rows(table, ids, 0, mask),
                       ref.gather_rows_ref(table, ids, 0, mask)):
        raise AssertionError(f"gather_rows [{path}] disagrees with its "
                             "plain version")
    n = ids.numel()
    row("gather_rows", "gather_rows.cu", "fenced_gather.py:48",
        max_abs_err=0.0, tolerance="exact",
        ms=cuda_ms(torch, lambda: gather_rows(table, ids, 0, mask)),
        plain_ms=cuda_ms(torch, lambda: ref.gather_rows_ref(
            table, ids, 0, mask)),
        library_ms=cuda_ms(torch, lambda: table.index_select(0, ids)),
        library_call="Tensor.index_select",
        shape=f"table {tuple(table.shape)} bf16, {n} ids, fence {mask + 1}",
        **rule_bound(gather_rows_cost(table, ids), "bfloat16"))
    log_rows(rows)
    return rows


#: the production mesh whose per-device kernel shapes phase 2 times
MESH_PATH = f"{BUNDLE_ARCH}/16x16"


def mesh_kernel_calls(torch) -> dict:
    """K1's and K4's operands in rank 0's program of :data:`BUNDLE_ARCH`'s
    ``decode_32k`` / ``prefill_32k`` bundles on the 16 x 16 mesh, as the
    dry run's partitioned trace gives them (at 2 layers: every layer's
    calls alike; CPU fakes, host work only): kind -> (the op's argument
    values, fakes for its tensors; its calls a step at full depth)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import graph_analysis as GA
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_step

    full = get_config(BUNDLE_ARCH)
    cfg = dataclasses.replace(full, n_layers=2)
    mesh = make_production_mesh()
    out = {}
    for kind, op in (("decode", "paged_attention"),
                     ("prefill", "flash_attention")):
        bundle = build_step(cfg, SHAPES[f"{kind}_32k"], mesh)
        with mesh.open("cpu") as device_mesh:
            fn, specs = bundle.partitioned(device_mesh)
            gm = GA.trace_step(fn, specs, "cpu")
        nodes = [n for n in gm.graph.nodes if n.op == "call_function"
                 and str(n.target) == f"repro_torch.{op}.default"]
        out[kind] = ([GA._value(gm, a) for a in nodes[0].args],
                     len(nodes) // cfg.n_layers * full.n_layers)
    return out


def mesh_kernel_rows(torch) -> list:
    """Phase 2's K1 and K4 rows at :data:`BUNDLE_ARCH`'s per-device shapes
    on the 16 x 16 mesh (:func:`mesh_kernel_calls`): K1 over the bf16
    layer view the partition gathers whole over the data axis (its slot
    pages, its KV heads split over the model axis: 8 rows x 2 KV heads,
    so the wrapper picks a cluster above 1), each row's 512 pages then
    512 foreign ones, against its plain version with its control and the
    fence check; K4 causal at the prefill's (2, 32,768, 2, 80) bf16
    (:func:`k4_long_row`).  No run launches them at these shapes (the
    partitioned program is traced, not run): launches 0 here, the trace's
    calls a step logged beside them."""
    calls = mesh_kernel_calls(torch)
    gen = torch.Generator(device="cuda").manual_seed(1616)
    i32 = dict(dtype=torch.int32, device="cuda")
    rows = []

    def row(kernel, source, replaces, **kw):
        rows.append(dict(kernel=kernel, path=MESH_PATH, route="cuda",
                         name=f"{kernel}@{MESH_PATH}",
                         source=f"src/repro_torch/kernels/csrc/{source}",
                         replaces=f"src/repro/kernels/{replaces}",
                         launches=0, **kw))

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    (q, k_view, _, table, *_), n_k1 = calls["decode"]
    B, H, D = q.shape
    P = table.shape[1]
    q = randn(q.shape)
    k_pool, v_pool = (randn(k_view.shape, k_view.dtype) for _ in range(2))
    table = (torch.arange(B, **i32)[:, None] * 2 * P
             + torch.arange(P, **i32)[None, :])
    lens = BUNDLE_PROMPT + torch.arange(B, **i32) * 2
    k1_pool_row(torch, row, MESH_PATH, q, k_pool, v_pool, table, lens,
                torch.zeros(B, **i32), torch.full((B,), -1, **i32))
    del k_pool, v_pool
    (q, k, v, *_), n_k4 = calls["prefill"]
    k4_long_row(torch, row, MESH_PATH, *(randn(t.shape) for t in (q, k, v)))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"mesh rows [{MESH_PATH}]: the partitioned decode_32k / "
        f"prefill_32k traces' per-device calls a step: paged_attention "
        f"{n_k1} at q {tuple(calls['decode'][0][0].shape)}, pool view "
        f"{tuple(k_view.shape)}; flash_attention {n_k4} at q "
        f"{tuple(calls['prefill'][0][0].shape)}")
    log_rows(rows)
    return rows


def counts() -> dict:
    """Every kernel's (launches, plain calls) as they stand."""
    from repro_torch.kernels import _build
    return {k.name: (k.launches, k.plain_calls)
            for k in _build.KERNELS.values()}


def counted_call(fn, *args):
    """``fn(*args)`` and the kernels' (launches, plain calls) it made."""
    before = counts()
    out = fn(*args)
    after = counts()
    return out, {k: (after[k][0] - before[k][0], after[k][1] - before[k][1])
                 for k in after if after[k] != before[k]}


def bundles_card_vs_cpu(torch, name: str, prompt: int, steps: int = 4,
                        tol: float = 2e-3) -> None:
    """Phase 12 (a): ``name`` at full width and 2 layers, float32, its
    ``build_prefill_step`` / ``build_decode_step`` bundles (``kv_dtype``
    "f32", the bundles' BITWISE guard — the MoE family's expert fence and
    K5 too) over a cache of 128 tokens a row: a 4 x ``prompt`` prefill and
    ``steps`` greedy decode steps on the card through the kernels and on
    the CPU through the plain versions, from the same weights — greedy ids
    equal, logits within phase 3's ``tol``, every kernel of the path
    launched on the card and no plain version run there."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_decode_step, \
        build_prefill_step

    cfg = dataclasses.replace(get_config(name), n_layers=2, dtype="float32")
    B, max_len = BUNDLE_BATCH, 128
    # each device's bundles on its own one-device mesh
    bundles = {dev: [build(cfg, ShapeConfig("bundle", kind, max_len, B),
                           make_local_mesh(dev), kv_dtype="f32")
                     for build, kind in ((build_prefill_step, "prefill"),
                                         (build_decode_step, "decode"))]
               for dev in ("cuda", "cpu")}
    api = bundles["cuda"][0].api
    params = api.init(torch.Generator(device="cuda").manual_seed(7), "cuda")
    cpu_params = tree_to(params, "cpu")
    toks = torch.randint(0, cfg.vocab, (B, prompt), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(12))
    made = collections.Counter()

    def run(device, p):
        pre, dec = bundles[device]
        cache = api.init_cache(B, max_len, dtype=torch.float32,
                               device=device)
        (cache, lg), n = counted_call(pre.fn, p, cache,
                                      {"tokens": toks.to(device)})
        made.update({k: v[0] for k, v in n.items()}) if device == "cuda" \
            else None
        outs, ids = [lg.float().cpu()], [lg.argmax(-1).cpu()]
        for _ in range(steps):
            (cache, lg), n = counted_call(
                dec.fn, p, cache, lg.argmax(-1).to(torch.int32))
            if device == "cuda":
                made.update({k: v[0] for k, v in n.items()})
                if any(v[1] for v in n.values()):
                    raise AssertionError(f"bundles (a) [{name}]: a plain "
                                         f"version ran on the card: {n}")
            outs.append(lg.float().cpu())
            ids.append(lg.argmax(-1).cpu())
        return torch.stack(outs), torch.stack(ids)

    with torch.no_grad():
        card = run("cuda", params)
        cpu = run("cpu", cpu_params)
    want = {"gather_rows": 1 + steps, "flash_attention": cfg.n_layers,
            "paged_attention": cfg.n_layers * steps}
    if cfg.moe:
        want["moe_histogram"] = cfg.n_layers * (1 + steps)
    if dict(made) != want:
        raise AssertionError(f"bundles (a) [{name}]: launches {dict(made)}, "
                             f"want {want}")
    err = hold_card_vs_cpu(f"bundles (a) [{name}]", card, cpu, tol)
    log(f"bundles (a) [{name}, full width x 2 layers, f32, kv_dtype f32]: "
        f"prefill bundle on {B} x {prompt} + {steps} decode bundle steps, "
        f"card vs CPU greedy ids equal, max |logit err| {err:.3g} "
        f"(tolerance {tol}); launches {dict(made)}")
    del params, cpu_params
    gc.collect()
    torch.cuda.empty_cache()


def compress_card_vs_cpu(torch) -> None:
    """Phase 12 (a): ``compress_roundtrip`` of a (50,304 x 2,560) float32
    tensor (stablelm-3b's embedding gradient) on the card equal to the
    CPU's bit for bit, and ``tree_compress_psum`` over a one-rank NCCL
    group on the card (codes and scales all-gathered) equal, leaf by
    leaf, to the round trip."""
    import os
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import compress_roundtrip, \
        init_error_feedback, tree_compress_psum

    cfg = get_config(BUNDLE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(99)
    x = torch.randn(cfg.vocab, cfg.d_model, generator=gen, device="cuda")
    approx, resid = compress_roundtrip(x)
    approx_c, resid_c = compress_roundtrip(x.cpu())
    if not (torch.equal(approx.cpu(), approx_c)
            and torch.equal(resid.cpu(), resid_c)):
        raise AssertionError("compress_roundtrip: the card differs from the "
                             "CPU")
    grads = {"embed": x, "wd": torch.randn(cfg.d_ff, cfg.d_model,
                                           generator=gen, device="cuda"),
             "norm": torch.randn(7, generator=gen, device="cuda")}
    # one rank, an in-process store: NCCL bootstraps over loopback only
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        t0 = time.perf_counter()
        red, err = tree_compress_psum(grads, init_error_feedback(grads),
                                      dist.group.WORLD)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        dist.destroy_process_group()
    for name, g in grads.items():
        a, r = compress_roundtrip(g)
        if not (torch.equal(red[name], a) and torch.equal(err[name], r)):
            raise AssertionError(f"tree_compress_psum [{name}]: differs "
                                 "from the round trip on one rank")
    log(f"bundles (a) compression: compress_roundtrip of "
        f"({cfg.vocab}, {cfg.d_model}) f32 card = CPU bit for bit; "
        f"tree_compress_psum over a one-rank NCCL group = the round trip "
        f"leaf by leaf (3 leaves, int8 codes and f32 scales gathered, "
        f"{ms:.1f} ms host wall, first call)")


#: the token positions of phase 12 (b)'s pool checks, in every row: the
#: first page's ends, the second's start, the middle and the last held
#: page (a row holds 32,704 tokens after the fill, pages 0-510)
POOL_CHECK_POS = (0, 1, 63, 64, 4095, 16384, 32640, BUNDLE_PROMPT - 1)
#: the plain projection's slack, as a share of each (K or V) element
#: pair's norm: the model rounds x @ W to bf16 before RoPE (at most 2^-8
#: of each element, 2^-8 * sqrt 2 of the pair carried through the
#: rotation), doubled for the products' own summation order
PROJ_SLACK = 2 ** -6


@contextlib.contextmanager
def last_layer_taps(torch, params, pos):
    """While the block runs, what the model's own calls give its last
    layer: the normed input of its QKV projection and its K / V (after
    RoPE, as handed to the pool write) at the token positions ``pos`` of
    a prompt, and the first q its decode attention is given.  Taps the
    calls as ``models.transformer`` makes them (module attributes),
    restored on the way out."""
    from repro_torch.models import kvcache as KV, layers as LY
    last, n_layers = params["layers"][-1]["attn"], len(params["layers"])
    taps = {}
    idx = torch.tensor(pos, device="cuda")
    qkv, write, attend = (LY.qkv_proj, KV.write_prefill_kv,
                          KV.paged_decode_attention)

    def qkv_tap(cfg, p, x):
        if p is last and x.shape[1] > max(pos):
            taps["x"] = x[:, idx].clone()
        return qkv(cfg, p, x)

    def write_tap(cache, layer, k_new, v_new, *args, **kw):
        if layer == n_layers - 1 and k_new.shape[1] > max(pos):
            taps["k"], taps["v"] = k_new[:, idx].clone(), v_new[:, idx].clone()
        return write(cache, layer, k_new, v_new, *args, **kw)

    def attend_tap(cache, layer, q, *args, **kw):
        if layer == n_layers - 1 and "q" not in taps:
            taps["q"] = q[:, 0].clone()
        return attend(cache, layer, q, *args, **kw)

    LY.qkv_proj, KV.write_prefill_kv, KV.paged_decode_attention = \
        qkv_tap, write_tap, attend_tap
    try:
        yield taps
    finally:
        LY.qkv_proj, KV.write_prefill_kv, KV.paged_decode_attention = \
            qkv, write, attend


def pool_checks(torch, cfg, params, cache, taps, path) -> str:
    """Phase 12 (b)'s checks of the bundle's own pool at its last layer
    (the layer view lies past 2^31 elements into the pool tensor), after
    the fill prefill (``taps`` from :func:`last_layer_taps`, at
    :data:`POOL_CHECK_POS` in every row):

    * the pool's slabs at those (row, position) places hold the K / V the
      model wrote, in the pool's type, value for value; the layer
      before's must differ (a misplaced layer view would pass otherwise);
    * that K / V is the plain projection of the layer's input (float32
      products, RoPE at the position), within half a bf16 ulp plus
      :data:`PROJ_SLACK` of each element pair's norm; the control, the
      layer before's weights, must break the bound;
    * K1 over the last layer's view of the pool, with the decode step's
      q, each row's first 511 pages (the 512th, past the fill, outside
      the fence) and 32,704 held tokens:
      :func:`check_paged_attention` (its bound, its control, the pages
      outside the fence clobbered).

    Returns a line of what was checked."""
    from repro_torch.kernels import ref

    L, B = cfg.n_layers, BUNDLE_BATCH
    k_pool, v_pool = cache.k, cache.v
    page, P = cache.page_size, cache.pages_per_slot
    pos = torch.tensor(POOL_CHECK_POS, device="cuda")
    slots = cache.slot_ids.long()[:, None]
    pages = cache.page_table.long().gather(
        1, (pos // page)[None, :].expand(B, -1))
    offs = (pos % page)[None, :]
    for name, pool in (("k", k_pool), ("v", v_pool)):
        # value for value: the one-hot placement sums a -0 with +0s
        want = ref.to_pool(taps[name], pool.dtype).float()
        if not torch.equal(pool[L - 1][slots, pages, offs].float(), want):
            raise AssertionError(f"bundles (b) [{path}]: the last layer's "
                                 f"{name} slabs differ from what the model "
                                 "wrote")
        if torch.equal(pool[L - 2][slots, pages, offs].float(), want):
            raise AssertionError(f"bundles (b) [{path}]: the layer before "
                                 f"holds the same {name} slabs: the check "
                                 "cannot tell a layer from another")
    D, KH = cfg.head_dim, cfg.n_kv_heads
    freqs = (1.0 / cfg.rope_theta ** (torch.arange(
        0, D, 2, dtype=torch.float64, device="cuda") / D)).float()
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x = taps["x"].float()

    def project(p, name):
        y = x @ p["w" + name].float()
        if p.get("b" + name) is not None:
            y = y + p["b" + name].float()
        y = y.reshape(B, len(POOL_CHECK_POS), KH, D)
        if name == "k":
            y1, y2 = y.chunk(2, dim=-1)
            y = torch.cat([y1 * cos - y2 * sin, y2 * cos + y1 * sin], -1)
        return y

    def proj_ratio(want, got):
        got = got.float()
        y1, y2 = want.chunk(2, dim=-1)
        pair = (y1.square() + y2.square()).sqrt().repeat(1, 1, 1, 2)
        bound = (half_ulp_bf16(torch, torch.maximum(want.abs(), got.abs()))
                 + PROJ_SLACK * pair)
        return ((want - got).abs() / bound).max().item()

    ratio = ctrl = 0.0
    for name in ("k", "v"):
        ratio = max(ratio, proj_ratio(
            project(params["layers"][-1]["attn"], name), taps[name]))
        ctrl = max(ctrl, proj_ratio(
            project(params["layers"][-2]["attn"], name), taps[name]))
    if not ratio <= 1.0:
        raise AssertionError(f"bundles (b) [{path}]: the last layer's K / V "
                             f"are not the plain projection of its input "
                             f"({ratio:.3f}x the bound)")
    if not ctrl > 1.0:
        raise AssertionError(f"bundles (b) [{path}]: the layer before's "
                             f"projection within the bound ({ctrl:.3f}x)")
    k_view, v_view = (t[L - 1].flatten(0, 1) for t in (k_pool, v_pool))
    if k_view.storage_offset() < 2 ** 31:
        raise AssertionError(f"bundles (b) [{path}]: the last layer's view "
                             f"starts at element {k_view.storage_offset()}")
    i32 = dict(dtype=torch.int32, device="cuda")
    table = (cache.slot_ids[:, None] * P
             + torch.arange(P - 1, **i32)[None, :])
    chk = check_paged_attention(
        torch, taps["q"], k_view, v_view, table,
        torch.full((B,), BUNDLE_PROMPT, **i32), torch.zeros(B, **i32),
        torch.full((B,), -1, **i32), None)
    return (f"the last layer's K / V slabs at {len(POOL_CHECK_POS)} "
            f"positions x {B} rows = what the model wrote, value for value "
            f"(the layer before's differ); = the plain projection of the layer's "
            f"input within 1/2 bf16 ulp + {PROJ_SLACK:g} x the pair norm "
            f"(worst error/bound {ratio:.3f}, the layer before's weights "
            f"{ctrl:.3g}); K1 over the last layer's view (element "
            f"{k_view.storage_offset()} of the pool, past 2^31) with the "
            f"decode step's q, {P - 1} pages a row, {BUNDLE_PROMPT} tokens: "
            f"max |err| {chk['err']:.3g}, worst error/bound "
            f"{chk['ratio']:.3f}"
            + ("" if chk["ctrl_ratio"] is None else
               f", the control {chk['ctrl_ratio']:.3g}")
            + f", {chk['foreign']} pages outside the fence clobbered, "
              "output unchanged")


def bundles_full(torch, smi: str) -> dict:
    """Phase 12 (b): stablelm-3b at full width and depth (32 layers, bf16
    weights from a seeded generator) through ``build_prefill_step`` and
    ``build_decode_step`` at the reference's ``prefill_32k`` /
    ``decode_32k`` with the batch cut to 4, over a bf16 pool (the
    reference's default) and a float8 one, each bundle built guarded
    (``make_guard``, BITWISE) and with ``guard_enabled=False``.  Per pool:
    the prefill bundle at its spec (4 x 32,768) guarded, native, native,
    guarded (CUDA events around ``fn``); the prefill bundle fills the
    cache with the first 32,704 tokens (511 pages a row); then 16 decode
    bundle steps guarded, native, native, guarded, each pass from the
    filled cache and fed the first pass's tokens (the float8 pool the
    bf16 pool's).  Counts set to 0 just before a pool's run and read just
    after.  Gates: every K1 / K3 / K4 call launched its kernel and no
    plain version ran (K3 once a call, K4 once a layer of a prefill, K1
    once a layer a step); every logit finite; guarded logits bit-equal to
    native ones (a one-tenant guard is the identity on in-range ids);
    then, the counts read, the bundle's own pool held at its last layer
    by :func:`pool_checks` (slabs = what the model wrote = the plain
    projection of the layer's input, K1 over the layer's view past 2^31
    elements).  Prints the prefill's wall and tokens/s, the decode step's median
    (min-max) against its bytes floor, the launches per call, guarded /
    native, peak memory and the greedy ids the float8 pool shares with the
    bf16 pool's.  Returns each path's launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import describe, make_local_mesh
    from repro_torch.launch.steps import build_decode_step, \
        build_prefill_step

    cfg = get_config(BUNDLE_ARCH)
    shapes = bundle_shapes()
    mesh = make_local_mesh()
    for kind, sh in shapes.items():
        log(f"bundles (b): the reference's {sh.name} ({sh.seq_len} tokens) "
            f"with global_batch cut from "
            f"{ {'prefill': 32, 'decode': 128}[kind]} to {sh.global_batch} "
            f"(one card; {describe(mesh)})")
    B, S = BUNDLE_BATCH, shapes["prefill"].seq_len
    api = build_prefill_step(cfg, shapes["prefill"], mesh).api
    params = api.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    w_bytes = tree_bytes(params)
    toks = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                         dtype=torch.int32,
                         generator=torch.Generator(device="cuda")
                         .manual_seed(3))
    paths, feed, ids_bf16 = {}, None, None
    for kv_dtype, path in BUNDLE_PATHS.items():
        bundles = {(kind, g): build(cfg, shapes[kind], mesh,
                                    guard_enabled=g, kv_dtype=kv_dtype)
                   for kind, build in (("prefill", build_prefill_step),
                                       ("decode", build_decode_step))
                   for g in (True, False)}
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        spec = bundles[("prefill", True)].in_specs[1]
        cache0 = api.init_cache(B, S, dtype=spec.k.dtype, device="cuda")
        if tuple(cache0.k.shape) != tuple(spec.k.shape):
            raise AssertionError(f"bundles (b): cache {tuple(cache0.k.shape)}"
                                 f" against the spec {tuple(spec.k.shape)}")
        per_call, plain = {}, 0
        torch.cuda.synchronize()
        _build.reset_counts()

        def timed(kind, g, *args):
            nonlocal plain
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out, n = counted_call(bundles[(kind, g)].fn, params, *args)
            b.record()
            torch.cuda.synchronize()
            per_call.setdefault(kind, {k: v[0] for k, v in n.items()})
            plain += sum(v[1] for v in n.values())
            if {k: v[0] for k, v in n.items()} != per_call[kind]:
                raise AssertionError(f"bundles (b) [{path}]: a {kind} call "
                                     f"launched {n}, another "
                                     f"{per_call[kind]}")
            if not torch.isfinite(out[1]).all():
                raise AssertionError(f"bundles (b) [{path}]: a {kind} logit "
                                     "is not finite")
            return out, a.elapsed_time(b)

        with torch.no_grad():
            # the prefill bundle at its spec: guarded, native, native,
            # guarded (the first call also warms the libraries up)
            pre = []
            for g in (True, False, False, True):
                # the returned cache is the pool's: keep only the logits
                lg, ms = timed("prefill", g, cache0, {"tokens": toks})
                pre.append((g, lg[1], ms))
                del lg
            if not torch.equal(pre[0][1], pre[1][1]):
                raise AssertionError(f"bundles (b) [{path}]: guarded prefill "
                                     "logits differ from native ones")
            pre_ms = [ms for _, _, ms in pre]
            del pre
            with last_layer_taps(torch, params, POOL_CHECK_POS) as taps:
                (filled, lg), fill_ms = timed(
                    "prefill", True, cache0,
                    {"tokens": toks[:, :BUNDLE_PROMPT].contiguous()})
            logits0 = lg.float()
            # the first pool's first pass picks the tokens every pass of
            # every pool is fed
            tokens = feed or [lg.argmax(-1).to(torch.int32)]
            dec = {True: [], False: []}
            for g in (True, False, False, True):
                cache, ms, lgs = filled, [], []
                for i in range(BUNDLE_STEPS):
                    (cache, lg), t = timed("decode", g, cache, tokens[i])
                    ms.append(t)
                    lgs.append(lg.float())
                    if len(tokens) == i + 1 < BUNDLE_STEPS:
                        tokens.append(lg.argmax(-1).to(torch.int32))
                dec[g].append((lgs, ms))
            for i, (a, b) in enumerate(zip(dec[True][0][0],
                                           dec[False][0][0])):
                if not torch.equal(a, b):
                    raise AssertionError(f"bundles (b) [{path}]: guarded "
                                         f"decode logits differ from native "
                                         f"ones at step {i}")
            launches = {k.name: k.launches for k in _build.KERNELS.values()
                        if k.launches}
            peak = torch.cuda.max_memory_allocated()
            # the pool checks, after the counts are read: the first step
            # once more (its K / V go past the fill, to page 511) for its
            # last layer's q
            with last_layer_taps(torch, params, POOL_CHECK_POS) as more:
                bundles[("decode", True)].fn(params, filled, tokens[0])
            taps["q"] = more["q"]
            checked = pool_checks(torch, cfg, params, filled, taps, path)
            del cache, filled, taps, more
        pool_bytes = 2 * cache0.k.numel() * cache0.k.element_size()
        elem = cache0.k.element_size()
        del cache0
        gc.collect()
        torch.cuda.empty_cache()
        want = {"prefill": {"gather_rows": 1,
                            "flash_attention": cfg.n_layers},
                "decode": {"gather_rows": 1,
                           "paged_attention": cfg.n_layers}}
        if per_call != want or plain:
            raise AssertionError(f"bundles (b) [{path}]: launches a call "
                                 f"{per_call}, plain calls {plain}; want "
                                 f"{want}, none")
        ids = [logits0.argmax(-1)] + [x.argmax(-1) for x in dec[True][0][0]]
        if feed is None:
            feed, ids_bf16, agree = tokens, ids, ""
        else:
            same = sum(int((a == b).sum()) for a, b in zip(ids, ids_bf16))
            agree = (f"; greedy ids equal to the bf16 pool's: {same} of "
                     f"{B * (1 + BUNDLE_STEPS)} (the fill prefill's and each "
                     f"step's, fed the bf16 run's tokens; not a gate: ties)")
        # the decode step's bytes floor: the weights once and each row's
        # held K and V (every layer) in the pool's type, at the first and
        # the last step
        per_tok = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * elem
        floors = [(w_bytes + B * (BUNDLE_PROMPT + i + 1) * per_tok)
                  / HBM_BYTES_PER_S * 1e3 for i in (0, BUNDLE_STEPS - 1)]
        steps_g = [t for _, ms in dec[True] for t in ms]
        steps_n = [t for _, ms in dec[False] for t in ms]
        med_g, med_n = statistics.median(steps_g), statistics.median(steps_n)
        log(f"bundles (b) [{path}, {cfg.n_layers} layers, bf16 weights "
            f"{w_bytes / 1e9:.2f} GB, {kv_dtype} pool {pool_bytes / 1e9:.2f} "
            f"GB]: prefill bundle at {B} x {S} (CUDA events around fn) "
            f"guarded {pre_ms[0]:.1f} (first call) / {pre_ms[3]:.1f} ms, "
            f"native {pre_ms[1]:.1f} / {pre_ms[2]:.1f} ms, "
            f"{B * S * 1e3 / pre_ms[3]:.0f} tokens/s guarded, guarded / "
            f"native {pre_ms[3] / pre_ms[2]:.4f} (the last two calls); fill "
            f"prefill ({B} x {BUNDLE_PROMPT}) {fill_ms:.1f} ms; on {smi}")
        log(f"bundles (b) [{path}]: decode step (CUDA events around the "
            f"decode bundle's fn; {BUNDLE_STEPS} steps, 2 passes each) "
            f"guarded median {med_g:.3f} ms ({min(steps_g):.3f}-"
            f"{max(steps_g):.3f}), native median {med_n:.3f} ms "
            f"({min(steps_n):.3f}-{max(steps_n):.3f}), guarded / native "
            f"{med_g / med_n:.4f}; bytes floor {floors[0]:.3f}-"
            f"{floors[1]:.3f} ms (weights + held K/V at 3.35 TB/s), guarded "
            f"median / floor {med_g / statistics.mean(floors):.2f}; "
            f"{B * 1e3 / med_g:.1f} tokens/s{agree}; on {smi}")
        paths[path] = {"launches": launches, "per_call": per_call,
                       "peak": peak, "decode_ms": (med_g, med_n),
                       "prefill_ms": (pre_ms[3], pre_ms[2])}
        log(f"bundles (b) [{path}]: launches a call {per_call}, plain calls "
            f"0; guarded logits = native bit for bit (prefill, {BUNDLE_STEPS}"
            f" decode steps); peak memory {peak / 1e9:.2f} GB; launches "
            f"over the run {launches}")
        log(f"bundles (b) [{path}]: the pool after the fill: {checked}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def bundles_phase(torch, smi: str) -> dict:
    """Phase 12: (a) the bundles card against CPU at 2 layers for
    stablelm-3b and qwen3-moe-30b-a3b, and the compression card against
    CPU and over a one-rank NCCL group; (b) stablelm-3b at full depth over
    the 32k shapes.  Returns (b)'s paths' launches."""
    t0 = time.perf_counter()
    bundles_card_vs_cpu(torch, BUNDLE_ARCH, prompt=64)
    bundles_card_vs_cpu(torch, "qwen3-moe-30b-a3b", prompt=32)
    compress_card_vs_cpu(torch)
    log_memory(torch, "bundles (b), before")
    paths = bundles_full(torch, smi)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    return paths


# --------------------------------------------------------------------- #
# Phase 13: the dry run (``repro_torch.launch.dryrun``) on the card       #
# --------------------------------------------------------------------- #

#: phase 13 (a)'s cells: one production-mesh cell per family, and the
#: depth its partitioned trace takes (None: every layer).  Each cell is
#: also traced whole (unpartitioned) at full depth.
#: Partitioned at full depth on an H100 host, zamba2-7b took 442 s on
#: CUDA and CPU fakes alone and 1,110 s beside the other phases,
#: stablelm-3b 215 s, so those three are cut; a layer's trace is alike at
#: any depth.
DRYRUN_CELLS = (("stablelm-3b", "train_4k", 8),
                ("qwen3-moe-30b-a3b", "decode_32k", 12),
                ("zamba2-7b", "prefill_32k", 12),
                ("xlstm-350m", "long_500k", None),
                ("qwen2-vl-2b", "decode_32k", None),
                ("seamless-m4t-medium", "prefill_32k", None))
#: phase 13 (b): the predicted peak against ``max_memory_allocated``
DRYRUN_PEAK_TOL = 0.10

#: phase 13 (a)'s (2, 4) rows: the reference's per-device FLOPs, total
#: collective bytes and temp bytes (XLA's ``memory_analysis``) of each
#: family x kind step bundle partitioned on (data=2, model=4), reduced
#: configs at ``tests/test_torch_dryrun_mesh.py``'s shapes, as that test's
#: reference subprocess gives them (jax on the CPU: the card has no JAX;
#: the test holds these figures equal to its subprocess's)
DRYRUN_REFERENCE_24 = {
    ("dense", "train"): (15728640.0, 759136.0, 402656),
    ("dense", "prefill"): (3170312.0, 114696.0, 107528),
    ("dense", "decode"): (114688.0, 35968.0, 78920),
    ("moe", "train"): (16580608.0, 927580.0, 453200),
    ("moe", "prefill"): (4841480.0, 221704.0, 183920),
    ("moe", "decode"): (265216.0, 40800.0, 82736),
    ("hybrid", "train"): (16338944.0, 2029048.0, 1529904),
    ("hybrid", "prefill"): (3391496.0, 326888.0, 291696),
    ("hybrid", "decode"): (111104.0, 48176.0, 75424),
    ("ssm", "train"): (12881920.0, 1105508.0, 927624),
    ("ssm", "prefill"): (3929088.0, 37872.0, 116032),
    ("ssm", "decode"): (136768.0, 14024.0, 14304),
    ("vlm", "train"): (79691776.0, 1675856.0, 1621016),
    ("vlm", "prefill"): (17866760.0, 655512.0, 751064),
    ("vlm", "decode"): (155648.0, 115200.0, 145744),
    ("encdec", "train"): (745537536.0, 5895084.0, 18749664),
    ("encdec", "prefill"): (187719688.0, 1458216.0, 8964384),
    ("encdec", "decode"): (376832.0, 561280.0, 1248584),
}
#: the test's bounds and pins for those rows (the test holds these equal
#: to its own): per-device FLOPs within DRYRUN_FLOPS_TOL of the
#: reference's, or at a pinned ratio (within 1 %); the collective and
#: temp ratios torch 2.13 gives, printed beside this torch's
DRYRUN_FLOPS_TOL = 0.02
DRYRUN_FLOPS_PINNED = {
    ("dense", "train"): 0.883, ("moe", "train"): 0.891,
    ("vlm", "train"): 0.921, ("ssm", "decode"): 0.832,
    ("vlm", "prefill"): 0.823934, ("encdec", "train"): 1.096262}
DRYRUN_COLL_PINNED = {
    ("dense", "train"): 0.662, ("dense", "decode"): 0.561,
    ("moe", "prefill"): 0.781, ("moe", "decode"): 0.597,
    ("hybrid", "train"): 0.474, ("hybrid", "prefill"): 0.949,
    ("hybrid", "decode"): 1.262,
    ("ssm", "train"): 1.353, ("ssm", "prefill"): 1.071,
    ("ssm", "decode"): 1.442,
    ("vlm", "train"): 1.131, ("vlm", "prefill"): 0.775,
    ("vlm", "decode"): 0.895,
    ("encdec", "train"): 0.927, ("encdec", "prefill"): 1.174,
    ("encdec", "decode"): 0.505}
DRYRUN_TEMP_PINNED = {
    ("dense", "train"): 0.759, ("dense", "prefill"): 0.462,
    ("dense", "decode"): 0.321,
    ("moe", "train"): 0.883, ("moe", "prefill"): 0.642,
    ("moe", "decode"): 0.306,
    ("hybrid", "train"): 0.851, ("hybrid", "prefill"): 1.161,
    ("hybrid", "decode"): 0.682,
    ("ssm", "train"): 0.650, ("ssm", "prefill"): 1.068,
    ("ssm", "decode"): 3.519,
    ("vlm", "train"): 0.764, ("vlm", "prefill"): 0.305,
    ("vlm", "decode"): 0.680,
    ("encdec", "train"): 0.772, ("encdec", "prefill"): 0.089,
    ("encdec", "decode"): 0.316}


def first_difference(gm_a, gm_b) -> str:
    """The first node at which two traced graphs differ (its op and its
    results' shapes and dtypes), for a message."""
    def sig(n):
        from repro_torch.launch.graph_analysis import _tensors
        return (str(n.target), [(tuple(t.shape), str(t.dtype))
                                for t in _tensors(n.meta.get("val"))])
    a = [sig(n) for n in gm_a.graph.nodes if n.op == "call_function"]
    b = [sig(n) for n in gm_b.graph.nodes if n.op == "call_function"]
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"node {i}: {x} against {y}"
    return f"{len(a)} against {len(b)} nodes"


def dryrun_devices(torch, smi: str) -> None:
    """Phase 13 (a), partitioned: each of :data:`DRYRUN_CELLS` at its
    depth on the single-pod mesh,
    partitioned (rank 0 of 256 over a fake process group, DTensor) and
    traced by the dry run on CUDA fakes and on CPU fakes in this process:
    the cost, memory, collectives and roofline blocks (per-device FLOPs,
    bytes, temp, collectives by kind), the traced graph's liveness walk,
    the per-op counts and the launches equal; a difference names the
    op."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as DR, graph_analysis as GA

    t0 = time.perf_counter()
    for arch, shape, layers in DRYRUN_CELLS:
        cfg = get_config(arch)
        got = {}
        for dev in ("cuda", "cpu"):
            with at_depth(arch, layers or cfg.n_layers):
                cell = DR.trace_cell(arch, shape, device=dev)
            got[dev] = (DR.reckon(cell), GA.peak_live_bytes(
                cell.gm, cell.bundle.donate_argnums), cell)
        (a, mem_a, ca), (b, mem_b, cb) = got["cuda"], got["cpu"]
        ops_a, ops_b = a["trace"]["ops"], b["trace"]["ops"]
        diff = sorted(k for k in set(ops_a) | set(ops_b)
                      if ops_a.get(k) != ops_b.get(k))
        if diff:
            raise AssertionError(
                f"dry run (a) [{arch} x {shape}]: per-op counts on cuda / "
                "cpu fakes differ: " + ", ".join(
                    f"{k} {ops_a.get(k, 0)} / {ops_b.get(k, 0)}"
                    for k in diff))
        for block in ("cost", "memory", "collectives", "roofline"):
            if a[block] != b[block]:
                raise AssertionError(
                    f"dry run (a) [{arch} x {shape}]: the {block} block on "
                    f"cuda fakes {a[block]} against cpu fakes {b[block]}; "
                    + first_difference(ca.gm, cb.gm))
        if mem_a != mem_b or a["trace"]["launches"] != b["trace"]["launches"]:
            raise AssertionError(
                f"dry run (a) [{arch} x {shape}]: traced memory {mem_a} / "
                f"{mem_b}, launches {a['trace']['launches']} / "
                f"{b['trace']['launches']}; " + first_difference(ca.gm, cb.gm))
        m, c, col = a["memory"], a["cost"], a["collectives"]
        log(f"dry run (a) [{arch} x {shape}, {cell.cfg.n_layers} layers, mesh "
            f"{a['mesh']}, partitioned over {a['chips']} ranks]: cuda fakes "
            "= cpu fakes: "
            f"{sum(ops_a.values())} ops of {len(ops_a)} kinds, launches "
            f"{a['trace']['launches']}, flops/dev "
            f"{c['flops_per_device']:.6e}, bytes/dev "
            f"{c['bytes_per_device']:.6e}, argument / output / alias / temp "
            f"{m['argument_bytes']} / {m['output_bytes']} / "
            f"{m['alias_bytes']} / {m['temp_bytes']} B a device, "
            f"collectives {col['total']:.6e} B a device ("
            + ", ".join(f"{k} {v:.6e} B x {col['counts'][k]}"
                        for k, v in sorted(col['per_kind'].items()))
            + f"), collective term {a['roofline']['collective_s']:.6f} s, "
            f"loops {a['method']['loops']}; trace {ca.lower_s:.1f} s (cuda) "
            f"/ {cb.lower_s:.1f} s (cpu) on the host of {smi}")
        del got, ca, cb
        gc.collect()
    log(f"phase 13 (a), partitioned: {time.perf_counter() - t0:.1f} s")
    dryrun_partition_24(smi)


def dryrun_partition_24(smi: str) -> None:
    """Phase 13 (a), (2, 4), host work only: every family x kind step
    bundle partitioned on a (data=2, model=4) mesh, run with real
    collectives by 8 gloo ranks on the CPU (``tests/_partition_run.py``:
    spawned processes over a ``FileStore`` in a temporary directory, the
    loopback device) against the unpartitioned step, every float leaf
    within its bound and ids equal, and the embedding gradient's block;
    then each bundle traced as rank 0 over a fake group and its
    per-device FLOPs, collective bytes and temp bytes printed against
    :data:`DRYRUN_REFERENCE_24`.  A numeric mismatch, or FLOPs outside
    the test's bound and off its pin, fails; collective and temp ratios
    away from torch 2.13's pins are marked, not failed."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _partition_run as PR
    from repro_torch.launch import graph_analysis as GA, mesh as MT

    t0 = time.perf_counter()
    cases = [("embed_grad",)] + [(f, k) for f in (*sorted(PR.FAMILIES),
                                                  PR.FEW_EXPERTS)
                                 for k in PR.KINDS]
    with tempfile.TemporaryDirectory() as tmp:
        got = PR.run(2, 4, cases, tmp)
    worst = 0.0
    for case, r in got.items():
        if "error" in r:
            raise AssertionError(f"dry run (a) (2, 4) [{case}]: a rank "
                                 f"failed: {r['error'][-3000:]}")
        bad = {k: v for k, v in r["leaves"].items()
               if (v != 0 if isinstance(v, int) else v > PR.TOL)}
        if bad:
            raise AssertionError(f"dry run (a) (2, 4) [{case}]: partitioned "
                                 f"against unpartitioned: {bad}")
        worst = max([worst] + [v for v in r["leaves"].values()
                               if isinstance(v, float)])
    log(f"dry run (a) (2, 4), real collectives: {len(cases)} cases (every "
        "family x train / prefill / decode, the 2-expert MoE, the "
        "embedding gradient's block) on 8 gloo ranks equal to the "
        f"unpartitioned steps: float leaves within {worst:.2e} of their "
        f"largest entry (bound {PR.TOL}), ids and counts equal; "
        f"{time.perf_counter() - t0:.1f} s on the host of {smi}")
    mesh = MT.Mesh(("data", "model"), {"data": 2, "model": 4})
    outside = []
    for (fam, kind), (rf, rc, rt) in DRYRUN_REFERENCE_24.items():
        bt = PR.bundle(fam, kind, 2, 4, kv_dtype="bf16")
        with mesh.open("cpu") as dm:
            fn, specs = bt.partitioned(dm)
            gm = GA.trace_step(fn, specs, "cpu")
        c = GA.GraphCostModel(gm).analyze()
        temp = GA.peak_live_bytes(gm, bt.donate_argnums).temp
        f, k, t = c.flops / rf, c.collective_bytes / rc, temp / rt
        pin = DRYRUN_FLOPS_PINNED.get((fam, kind))
        ok = abs(f - 1) < DRYRUN_FLOPS_TOL or (
            pin is not None and abs(f / pin - 1) < 0.01)
        if not ok:
            outside.append(f"{fam}/{kind} {f:.4f}")

        def was(ratio, pins, what):
            pinned = pins.get((fam, kind))
            if pinned is None:
                return f"{what} {ratio:.4f}"
            mark = "" if abs(ratio / pinned - 1) < 0.01 else \
                ", differs from torch 2.13's"
            return f"{what} {ratio:.4f} (2.13: {pinned}{mark})"

        log(f"dry run (a) (2, 4) [{fam} x {kind}]: flops/dev {c.flops:.6e} "
            f"/ reference {rf:.6e} = {f:.4f} ("
            + (f"pin {pin}" if pin is not None else
               f"bound {DRYRUN_FLOPS_TOL}") + ("" if ok else ", OUTSIDE")
            + f"); collectives {c.collective_bytes:.6e} / {rc:.6e} B: "
            + was(k, DRYRUN_COLL_PINNED, "ratio") + f"; temp {temp} / "
            f"{rt} B: " + was(t, DRYRUN_TEMP_PINNED, "ratio"))
        del gm
        gc.collect()
    if outside:
        raise AssertionError("dry run (a) (2, 4): per-device FLOPs outside "
                             "the test's bound and off its pin: "
                             + ", ".join(outside))
    log(f"phase 13 (a), (2, 4): {time.perf_counter() - t0:.1f} s")


def dryrun_whole(torch, smi: str) -> None:
    """Phase 13 (a), whole: each of :data:`DRYRUN_CELLS` at full depth on
    the single-pod mesh, its step unpartitioned (the whole program), on
    CUDA fakes and on CPU fakes: the costs, the liveness walk, the per-op
    counts and the launches equal; a difference names the op."""
    from repro_torch.launch import dryrun as DR, graph_analysis as GA

    t0 = time.perf_counter()
    for arch, shape, _ in DRYRUN_CELLS:
        got = {}
        for dev in ("cuda", "cpu"):
            cfg, _, _, bundle = DR.build_cell(arch, shape, device=dev)
            t1 = time.perf_counter()
            gm = GA.trace_step(bundle.step, bundle.in_specs, dev)
            model = GA.GraphCostModel(gm)
            got[dev] = (model, model.analyze(), GA.peak_live_bytes(
                gm, bundle.donate_argnums), gm, time.perf_counter() - t1)
        (ma, ca, mem_a, ga, sa), (mb, cb, mem_b, gb, sb) = \
            got["cuda"], got["cpu"]
        diff = sorted(k for k in set(ma.ops) | set(mb.ops)
                      if ma.ops.get(k) != mb.ops.get(k))
        if diff:
            raise AssertionError(
                f"dry run (a) whole [{arch} x {shape}]: per-op counts on "
                "cuda / cpu fakes differ: " + ", ".join(
                    f"{k} {ma.ops.get(k, 0)} / {mb.ops.get(k, 0)}"
                    for k in diff))
        if (ca.flops, ca.vector_flops, ca.bytes, mem_a, ma.launches) != \
                (cb.flops, cb.vector_flops, cb.bytes, mem_b, mb.launches):
            raise AssertionError(
                f"dry run (a) whole [{arch} x {shape}]: cuda fakes flops "
                f"{ca.flops}, bytes {ca.bytes}, {mem_a}, launches "
                f"{ma.launches} against cpu fakes {cb.flops}, {cb.bytes}, "
                f"{mem_b}, {mb.launches}; " + first_difference(ga, gb))
        log(f"dry run (a) whole [{arch} x {shape}, {cfg.n_layers} layers, "
            f"unpartitioned]: cuda fakes = cpu fakes: "
            f"{sum(ma.ops.values())} ops of {len(ma.ops)} kinds, launches "
            f"{ma.launches}, flops {ca.flops:.6e}, bytes {ca.bytes:.6e}, "
            f"the trace's peak {mem_a.peak / 1e9:.2f} GB; trace {sa:.1f} s "
            f"(cuda) / {sb:.1f} s (cpu) on the host of {smi}")
        del got, ga, gb
        gc.collect()
    log(f"phase 13 (a), whole: {time.perf_counter() - t0:.1f} s")


def dryrun_vs_card(torch, smi: str, paths=None) -> None:
    """Phase 13 (b): the dry run of phase 12's model (stablelm-3b, 32
    layers, 4 x 32,768, a bf16 slab pool, guarded) on the card's 1 x 1
    mesh, held against one real step of each bundle: argument bytes equal
    to the bytes of the params, cache and inputs allocated for the step;
    the kernels' launches in the step equal to the trace's; the predicted
    peak (argument + temp + output - alias) within
    :data:`DRYRUN_PEAK_TOL` of ``max_memory_allocated`` over the step.
    Printed, not gated: the trace's counted aten ops beside the device
    operations ``torch.profiler`` sees, the roofline's least time beside
    phase 12's step time (``paths``, when phase 12 ran)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun as DR, graph_analysis as GA

    t0 = time.perf_counter()
    cfg = get_config(BUNDLE_ARCH)
    shapes = bundle_shapes()
    cells = {kind: DR.trace_cell(BUNDLE_ARCH, shape=shapes[kind],
                                 device="cuda", local=True)
             for kind in ("decode", "prefill")}
    res = {kind: DR.reckon(cell) for kind, cell in cells.items()}
    gc.collect()
    torch.cuda.empty_cache()
    api = cells["decode"].bundle.api
    B, S = BUNDLE_BATCH, shapes["prefill"].seq_len
    params = api.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    cache = api.init_cache(B, S, dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    inputs = {"decode": torch.randint(0, cfg.vocab, (B,), device="cuda",
                                      dtype=torch.int32, generator=gen),
              "prefill": {"tokens": torch.randint(
                  0, cfg.vocab, (B, S), device="cuda", dtype=torch.int32,
                  generator=gen)}}
    measured = (paths or {}).get(BUNDLE_PATHS["bf16"], {})
    for kind in ("decode", "prefill"):
        cell, r = cells[kind], res[kind]
        fn = cell.bundle.fn
        held = tree_bytes(params) + tree_bytes(cache) + \
            tree_bytes(inputs[kind])
        if r["memory"]["argument_bytes"] != held:
            raise AssertionError(
                f"dry run (b) [{kind}]: argument bytes "
                f"{r['memory']['argument_bytes']}, the step's tensors "
                f"{held}")
        with torch.no_grad():
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            _build.reset_counts()
            out = fn(params, cache, inputs[kind])
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            launches = {k.name: k.launches for k in _build.KERNELS.values()
                        if k.launches}
            plain = sum(k.plain_calls for k in _build.KERNELS.values())
            del out
        if launches != r["trace"]["launches"] or plain:
            raise AssertionError(
                f"dry run (b) [{kind}]: the step launched {launches} "
                f"({plain} plain calls), the trace predicts "
                f"{r['trace']['launches']}")
        mem = r["memory"]
        predicted = mem["peak_live_bytes_per_device"]
        gap = (predicted - peak) / peak
        if abs(gap) > DRYRUN_PEAK_TOL:
            raise AssertionError(
                f"dry run (b) [{kind}]: predicted peak {predicted} B against "
                f"max_memory_allocated {peak} B ({gap:+.2%}, tolerance "
                f"{DRYRUN_PEAK_TOL:.0%})")
        with torch.no_grad():
            prof = profiled_call(torch, lambda: fn(params, cache,
                                                   inputs[kind]), n=1)
        least = max(r["roofline"]["compute_s"],
                    r["roofline"]["memory_s"]) * 1e3
        step = measured.get(f"{kind}_ms")
        log(f"dry run (b) [{BUNDLE_ARCH}, {kind}, {B} x {S}, bf16 pool, "
            f"guarded, mesh 1x1, cuda fakes]: argument bytes {held} = the "
            f"step's params + cache + inputs; launches {launches} = the "
            f"trace's; predicted peak {predicted / 1e9:.3f} GB (argument "
            f"{mem['argument_bytes'] / 1e9:.3f} + temp "
            f"{mem['temp_bytes'] / 1e9:.3f} + output "
            f"{mem['output_bytes'] / 1e9:.3f} - alias "
            f"{mem['alias_bytes'] / 1e9:.3f}) against max_memory_allocated "
            f"{peak / 1e9:.3f} GB over the step ({before / 1e9:.3f} GB "
            f"allocated before it): {gap:+.2%}, tolerance "
            f"{DRYRUN_PEAK_TOL:.0%}; on {smi}")
        log(f"dry run (b) [{kind}]: not gated: {GA.non_view_ops(cell.gm)} "
            "counted aten ops in the trace, "
            + ("not measured (the profiler saw no device time)"
               if prof is None else f"{prof[0]:.0f} device operations "
               f"(torch.profiler, one step, {prof[1]:.3f} ms busy)")
            + f"; the roofline's least time {least:.3f} ms "
              f"({r['roofline']['bottleneck']}-bound: flops "
              f"{r['cost']['flops_per_device']:.6e}, bytes "
              f"{r['cost']['bytes_per_device']:.6e}) beside phase 12's "
            + (f"guarded {kind} step {step[0]:.3f} ms" if step else
               "step time: not measured in this run")
            + f"; on {smi}")
    del params, cache, inputs, cells
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 13 (b): {time.perf_counter() - t0:.1f} s")


# A worker of phase 13 (a): host work only (traces on fakes), run beside
# the other phases from the start, argv[2] "partitioned" or "whole"; its
# lines are printed after phase 12's.
_PHASE13A_WORKER = """
import sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import torch
import chip_smoke as cs
(cs.dryrun_devices if sys.argv[2] == "partitioned" else cs.dryrun_whole)(
    torch, cs.smi_line())
"""

# Phase 5's nested conditional nodes in a process of their own, beside
# phase 12's: host work for the most part (each key's ``cond`` and
# ``while_loop`` traced, on the card and the CPU), microseconds of the
# card's time, a few MB of its memory.
_NESTED_WORKER = """
import sys, time
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import torch
import chip_smoke as cs
from repro_torch.kernels import _build
_build.build_all()
t0 = time.perf_counter()
cs.many_conditional_nodes(torch, "cuda")
cs.log(f"nested conditional nodes: {time.perf_counter() - t0:.1f} s, in a "
       "process of their own beside phase 12's")
"""


def start_side_worker(code: str, *args: str):
    """``code`` (with the checkout at argv[1], ``args`` after it) in a
    process of its own beside this one, its output kept in a file; killed
    at exit if it is still running."""
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, "-c", code, str(ROOT), *args],
                            stdout=out, stderr=out, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out


def finish_side_worker(started, what: str, keep=None) -> None:
    """Wait for a side worker and print its lines (those starting with
    one of ``keep``, when given, unless it failed); its failure fails
    here."""
    proc, out = started
    rc = proc.wait()
    out.seek(0)
    for line in out:
        if rc != 0 or keep is None or line.startswith(keep):
            print(line, end="", flush=True)
    if rc != 0:
        raise AssertionError(f"{what}'s worker failed (exit {rc})")


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
    if cfg.moe is None:
        rows.append(["eager decode step, ms", name, mine.eager_decode_row(
            torch, cfg, torch.Generator(device="cuda").manual_seed(4321))])
print("AB " + json.dumps(rows))
"""


def eager_decode_row(torch, cfg, gen) -> float:
    """The model's eager decode step at full width and depth (bf16 weights
    from ``gen``) through the model API over a float32 pool of 4 rows x
    256 tokens after a 64-token prefill: the median ms of 24 steps after 4
    of warm-up, each on the host's clock from the call to the card's end
    (the step is host-bound: the Python of every layer).  Uses only entry
    points every tree of the port has, so the same-card A/B times it on
    both."""
    from repro_torch.models import get_model

    api = get_model(cfg)
    params = api.init(gen, "cuda")
    B, S = 4, 64
    toks = torch.randint(0, cfg.vocab, (B, S), device="cuda", generator=gen)
    ms = []
    with torch.no_grad():
        cache = api.init_cache(B, 256, dtype=torch.float32, device="cuda")
        cache, lg = api.prefill(params, cache, {"tokens": toks})
        for i in range(28):
            nxt = lg.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, lg = api.decode(params, cache, nxt)
            torch.cuda.synchronize()
            if i >= 4:
                ms.append((time.perf_counter() - t0) * 1e3)
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return statistics.median(ms)


def same_card_ab(parent: Path) -> int:
    """``python3 chip_smoke.py --ab PARENT``: phase 2's kernel times, the
    main path's prefill write and the dense path's eager decode step
    (:func:`eager_decode_row`) of a checkout of another tree (``PARENT``,
    e.g. the parent commit unpacked with ``git archive``) and of this
    one, on this card in one call, in the order parent, this, this,
    parent, each in a process of its own.  Prints a row per kernel and
    path with the four times."""
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
    # the bf16 instantiations the paths run (D / 16 = 5, 7 and 8), and f32
    log("K4 ptxas: " + ptxas_report(_build, "flash_attention.cu",
                                    ("ILi5E", "ILi7E", "ILi8E", "f32")))
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

    if len(sys.argv) == 2 and sys.argv[1] == "--families-train":
        # a development switch: phase 2's K1 fp8 rows and phase 11 alone,
        # after the build
        fp8_kernel_rows(torch)
        families_train_phase(torch, smi)
        return 0

    if len(sys.argv) == 2 and sys.argv[1] == "--bundles":
        # a development switch: phase 2's 32k rows and phase 12 alone,
        # after the build
        bundle_kernel_rows(torch)
        mesh_kernel_rows(torch)
        phase_worker(torch, 12, "paths = cs.bundles_phase(torch, smi)"
                     "\ncs.dryrun_vs_card(torch, smi, paths)")
        return 0

    if len(sys.argv) == 2 and sys.argv[1] == "--dryrun":
        # a development switch: phase 13 alone, after the build
        dryrun_devices(torch, smi)
        dryrun_whole(torch, smi)
        dryrun_vs_card(torch, smi)
        return 0

    if len(sys.argv) == 2 and sys.argv[1] == "--train":
        # a development switch: phase 2's training rows and phase 9 alone,
        # after the build
        train_kernel_rows(torch)
        train_phase(torch, smi)
        return 0

    # phase 13 (a) (the dry run on cuda and cpu fakes: host work only) runs
    # beside the other phases from here, in processes of their own
    dryrun = [start_side_worker(_PHASE13A_WORKER, part)
              for part in ("partitioned", "whole")]
    t_phase = time.perf_counter()
    cfgs = [get_config(name) for name in PATHS]
    floor = launch_floor_ms(torch)
    log(f"launch floor: {floor:.5f} ms (one-element fill_, the smallest "
        "device operation a call can be, timed as the kernels are)")
    rows = []
    for cfg in cfgs:
        rows += check_kernels(torch, cfg)
        check_ops(torch, cfg)
    for name in RECURRENT:
        rows += check_kernels(torch, get_config(name))
    check_ops(torch, get_config(RECURRENT[0]))
    rows += train_kernel_rows(torch)
    rows += family_kernel_rows(torch)
    rows += fp8_kernel_rows(torch)
    rows += bundle_kernel_rows(torch)
    rows += mesh_kernel_rows(torch)
    for r in rows:
        log(f"  {r['kernel']} [{r['path']}]: {r['ms']:.5f} ms = "
            f"{r['ms'] / floor:.2f}x the launch floor")
    # a kernel's first row carries its name, a later path's row is
    # named kernel@path
    seen = set()
    for r in rows:
        if "name" not in r:
            r["name"] = r["kernel"] if r["kernel"] not in seen \
                else f"{r['kernel']}@{r['path']}"
        seen.add(r["kernel"])
    log("kernels: " + ", ".join(r["name"] for r in rows))
    log(f"phase 2: {time.perf_counter() - t_phase:.1f} s")
    # phase 11 (training the recurrent families, the MoE variants, the
    # float8 pool) runs now, in a process of its own
    # phase 11 and then phase 9 (training) run now, in a process of their
    # own
    phase11 = phase_worker(
        torch, 11, "paths = cs.families_train_phase(torch, smi)\n"
        "paths[cs.TRAIN_ARCH + '/train'] = cs.train_phase(torch, smi)")
    # phase 12 (the step bundles at 32k) right after it, in a process of
    # its own too: its 43 GB pool needs the card's memory whole; phase 5's
    # nested conditional nodes (host work, a few MB) beside it
    nested = start_side_worker(_NESTED_WORKER)
    phase12 = phase_worker(torch, 12, "paths = cs.bundles_phase(torch, smi)"
                           "\ncs.dryrun_vs_card(torch, smi, paths)")
    finish_side_worker(nested, "phase 5's nested conditional nodes")
    t_phase = time.perf_counter()
    for cfg in cfgs:
        check_full_width(torch, cfg)
        check_compiled(torch, cfg)
        if cfg.moe is None:
            check_sampled(torch, cfg)
            check_control_plane(torch, cfg)
        gc.collect()
        torch.cuda.empty_cache()
    check_uncapturable(torch)
    log(f"phase 3: {time.perf_counter() - t_phase:.1f} s")
    tenant_plane(torch, smi=smi, nested=False)
    t_phase = time.perf_counter()
    paths = {}
    for cfg in cfgs:
        # each path's engine, manager and pool are freed before the next
        # is built (qwen3-moe's 61 GB of weights need the room)
        paths[cfg.name] = run_main_path(torch, cfg, smi)
        slab = paths[cfg.name]["slab"]
        if slab is not None:
            # the slab path's K1 row, named kernel@path/slab
            r = slab["row"]
            r["name"] = f"paged_attention@{r['path']}"
            rows.append(r)
            paths[r["path"]] = slab
            log(f"  paged_attention [{r['path']}], {r['shape']}: max |err| "
                f"{r['max_abs_err']:.3g} (tolerance {r['tolerance']}); "
                f"kernel {r['ms']:.5f} ms = {r['ms'] / floor:.2f}x the "
                f"launch floor, plain {r['plain_ms']:.5f} ms, bound "
                f"{r['bound_ms']:.5f} ms ({r['bound_by']}); launches on "
                f"the slab path {slab['launches']}")
        gc.collect()
        torch.cuda.empty_cache()
        log(f"after [{cfg.name}]: {torch.cuda.memory_allocated() / 1e9:.2f}"
            " GB still allocated")
    log(f"phases 4, 6 and 7: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    paths.update(recurrent_phase(torch, smi))
    log(f"phase 8: {time.perf_counter() - t_phase:.1f} s")
    # phase 10: the vision and encoder-decoder families
    log_memory(torch, "before phase 10")
    paths.update(family_phase(torch, smi))
    paths.update(phase11)
    paths.update(phase12)
    # phase 13 (b) ran in phase 12's process; (a)'s lines now
    for worker in dryrun:
        finish_side_worker(worker, "phase 13 (a)", ("dry run", "phase 13"))
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s since the build "
        "began")

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    def launches(r):
        """The row's launches on its path's main run (a row on no path
        carries its own 0; a row of one form of a kernel on its path, that
        form's launches)."""
        if "launches" in r:
            return r["launches"]
        if "form" in r:
            return paths[r["path"]]["forms"][r["form"]]
        return paths[r["path"]]["launches"][r["kernel"]]

    table = [{k: launches(r) if k == "launches" else r[k] for k in keys}
             for r in rows]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
