"""chip_smoke.py — the quickest proof that the PyTorch/CUDA port runs on a GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card
    python3 chip_smoke.py --seed 1   # the same with other random weights,
                                     # prompts and data
    python3 chip_smoke.py --logit-floor 0 1 2 3 4
                                     # only phase 10's plain witness (the
                                     # model's own prefill-vs-decode logit
                                     # gap) at these seeds; no kernels
    python3 chip_smoke.py --logit-floor 0 1 2 3 4 --arch mixtral-8x7b
                                     # the same for phase 22's, 23's or
                                     # (--arch zamba2-1.2b, with the
                                     # states' gaps) 25's model

Drives ``repro_torch`` (never JAX, never the ``repro`` package) on the
card, phase by phase; any mismatch raises and the script exits non-zero:

1. Device: the card's name and power limit (``nvidia-smi``), then every
   kernel built from its ``src/repro_torch/kernels/<name>/csrc`` source
   with ``nvcc`` for ``sm_90a``, all builds started together; from
   ``ptxas -v``'s report, fwd_wgmma's registers and spill bytes at each
   head dim (a spill fails the run) and ptxas's lines on serialised wgmma;
   decode_cluster's registers and spill bytes for each of its 32
   instantiations (a spill fails the run); then scan_fwd's registers and spill bytes for each of its four
   instantiations (float32 and bfloat16, cp.async pieces or plain loads),
   the chunk geometry its library reports (``ops.scan_tile()``) and the
   blocks an SM takes (a spill, or fewer than two blocks, fails the run).
2. Kernel vs plain: the kernel's wrapper against its plain PyTorch version
   on the same card tensors, bit for bit (integer-valued data: float32
   sums below 2**24 are exact in any order, so the tolerance is zero), at
   N = 2**22 rows, fan-out 5, 8 slots × 2**20 buckets (a 64 MiB carry, 80
   MiB of rows — bigger than the 50 MB L2) across {device wire, host wire}
   × {sum, count, min, max} × {dense, hashed} plus ``channel_base=2`` in a
   4-channel carry (the paired float2 reduction) and ``channel_base=1`` in
   a 3-channel carry (an odd C: the scalar pair), with late pairs and
   negative window indices; then the
   join's geometry: a carry 4,099 buckets wider than the key space
   (``carry_buckets > num_buckets``, a narrow join side) for sum and count
   at channel bases 0 and 2, the rows past the key space untouched, and
   one 4-channel carry folded at base 0 and then at base 2, the second
   fold leaving channels 0-1 as the first left them; then at the main
   path's own shape (one 65,536-record Linear Road micro-batch).
   The fold is called as the main path calls it, through a step of
   ``make_fold_step``.  Times are CUDA-event medians of 20 calls after
   warm-up; the device time and the device records a fold come from
   torch.profiler (every record: kernels and any fill or set), and each
   timed fold must put exactly one record on the card (one cooperative
   launch, whatever the kind).  At the main shape also the host time a
   call (``perf_counter`` over 1,000 calls, then one synchronize) and the
   route read from the trace.
3. Main path: ``linear-road-lav`` (see
   ``src/repro_torch/workloads/linear_road.py``: 50 expressways, 10,000
   segment keys, 50,000 vehicles, 1,000,000 position reports over 10
   minutes, sliding 5-minute windows every minute, mean speed) through
   ``Pipeline.from_source(prefix=...)`` → ``build(device="cuda")`` →
   ``run(...)`` with ``RunOptions(overlap=True)`` on an in-memory event
   log.  Every sink object must equal a numpy oracle exactly, and the
   kernel's launch count must equal the fold steps the run made.
   ``reduced`` (from Linear Road): 10 minutes instead of 3 hours; about
   30x fewer vehicles per expressway than the benchmark (1,000 against
   the order of 10^4), so finalization weighs more per report; LAV as
   the count-weighted mean of the window's reports, not the mean of
   per-minute averages; no tolls, accidents or historical queries.
4. Sessions on the host wire: a per-vehicle ``Windowing.session(30.0)``
   job on the card, byte-identical to the same job with ``device="cpu"``.
5. hash_combine vs plain: the kernel's wrapper against its plain PyTorch
   version on the same card tensors over N in {2**16, 2**24}, B in {32,
   1000, 4096, 65536}, D in {1, 4, 16}, with about 20% invalid rows and
   keys below 0 and at or above B.  Integer-valued float32 must be
   bit-identical (float32 sums below 2**24 are exact in any order).
   Real-valued float32 in [0, 1) must agree within rtol 1e-4 (atol
   1e-4): both versions sum in float32 in an unordered (atomic) order,
   whose rounding error grows like sqrt(m / 12) ulp over m terms — under
   2e-5 of the sum at the largest m here (4.2e5 terms in one bucket).
   bfloat16 within rtol 2e-2 (atol 1e-2), the reference's own bfloat16
   kernel tolerance: both sum in float32 and round once, so they differ
   by at most one bfloat16 step where the float32 sums straddle a
   rounding boundary.  Per shape it prints the wrapper's time (CUDA
   events), the kernel's device time (torch.profiler), the byte bound,
   the plain version's time and one PyTorch call's (``bincount`` with
   weights for D = 1, ``index_add_`` for D > 1, over the kept rows).
6. Main path of the batch plane: ``wordcount-hibench-large`` (see
   ``src/repro_torch/workloads/wordcount.py``: 2**28 token ids uniform
   over 1,000 words, 8 worker shards, HiBench's wordcount ``large``
   profile) through ``Pipeline.from_source(shards=...)`` →
   ``build(device="cuda")`` → ``run()``: equal to the ``np.bincount``
   oracle exactly, one hash_combine launch per run; tokens/s over three
   runs from the host's shards, the host-to-device copy of the shards
   alone, three runs from shards already on the card, and one of those
   under torch.profiler for the kernel's and all device work's share.
   Before it, the kernel alone at that shape (the UDF's outputs),
   bit-identical to the plain version.
7. Hashed key space: 2**20 tokens over a 2**16-id vocabulary into 1,024
   hashed buckets, ``device="cuda"`` against ``device="cpu"``: equal
   results, ``sent`` and per-bucket collision counts.

8. Flash attention forward vs plain: the kernel's wrapper (fwd_wgmma for
   bfloat16 at head dims 64, 128 and 256, fwd_rows otherwise) against
   ``chunked_attention`` on the same card tensors over B 1-3, GQA groups
   1, 2 and 8, head dims 64, 96, 128 and 256, causal on and off (off at
   each of fwd_wgmma's head dims), windows none, 16 (under one key tile)
   and 4096, softcap none and 50, ragged Sq and Skv (10, 300, 777, 1000,
   8191; Skv under one tile, rows with no live key), float32 and
   bfloat16, the main path's two shapes (B = 1, Hq = 16, Hkv = 8, S =
   8192, D = 256, bfloat16, softcap 50, window 4096 and none), and phase
   26's two geometries at S = 8191, causal, bfloat16 (internvl2-2b: Hq =
   16 over Hkv = 8 at D = 128; musicgen-medium: 24 over 24 at D = 64).
   Tolerance (``FA_TOL``): bfloat16 within atol 5e-3 + rtol 2e-2 element by element
   and a relative L2 error ``||got - want|| / ||want||`` of at most 5e-3
   — the tensor cores take P rounded to bfloat16 (up to 2^-9 max|v|
   absolute per element, about 2e-3 relative L2), and the outputs round
   to bfloat16 (one step, at most 2^-7 relative); float32 within atol
   1e-4 + rtol 1e-4 and relative L2 1e-3 (float32 FMAs in another order).
   Each case also holds three planted faults to the same tolerance and
   fails unless every one is rejected (the plain version computing what a
   kernel with that fault would): one 64-key V tile zeroed (a tile left
   out of P V); a stale ring slot (the middle key tile's K and V replaced
   by those of the tile its slot held before, as a consumer that read
   before the slot's barrier completed); a dropped diagonal tile (each
   128-row q tile without its last live key tile).  Per shape: the error,
   its relative L2 and the RMS of the plain output, the wrapper's time
   (CUDA events), the kernel's device time (torch.profiler) and the
   operation/byte bound; at the main path's shapes only, the plain
   version's time and ``scaled_dot_product_attention``'s (GQA via
   ``enable_gqa``, the window as a boolean mask; it has no softcap, so
   the yardstick omits it).
9. Split-K decode vs plain: ``decode_attention`` (``decode_cluster``: one
   launch of thread-block clusters whose blocks split each row's live
   range and merge through distributed shared memory) against
   ``decode_ref`` over B 1-8, GQA groups 1-8 (8 at head dim 128 as
   qwen3-32b, 160 as stablelm-12b), per-row lengths from 1 to S_max
   (including S_max), windows none, 16, 1000 and 4096, softcap none and
   50, S_max up to 8320, caches at byte 0, 2 (bfloat16) and 4 (float32,
   head dim 33) of 16, and phase 26's two geometries at length 8,193
   (internvl2-2b: 16 q over 8 kv heads of 128; musicgen-medium: 24 over
   24 of 64).  Tolerance (``FD_TOL``): the kernel sums in float32
   like its plain version and rounds once, so bfloat16 within atol 1e-4 +
   rtol 1e-2 and relative L2 5e-3, float32 as in phase 8.  From the
   geometry the library reports (``decode_geometry``: cluster size, keys
   a tile, ring slots), up to three planted faults in row 0, each where it
   changes the output and each required to fail the tolerance: a rank's
   partial dropped from the merge, a stale ring slot (rank 0's tile
   ``slots`` read as tile 0), every rank's ragged last tile dropped.
   Three calls must be equal bit for bit, the last two after a call at
   another cluster size (held to the same tolerance).  Per case the
   wrapper's time (CUDA events) and its host time per call, the kernel's
   device time (torch.profiler) and the byte bound; at the main path's
   shape the plain version's and SDPA's time (a length mask, no softcap),
   the device time at cluster sizes 8 and 16, and one allocation a call
   (the output).  A case with caches off a 16-byte boundary must take at
   most 3x the device time of aligned copies of them.  Last, a row of
   length 0 (outside the wrapper's contract, lengths >= 1): the kernel
   must answer 0, as the reference's ``flash_decode`` does.
10. Gemma 2 9B at full width (``configs.get("gemma2-9b")``: 42 layers,
   d_model 3584, 9,241,401,344 parameters in bfloat16, random weights
   from the seed — no checkpoint is in the repository): one 8,192-token
   prompt through ``prefill_forward``, then 16 greedy ``decode_step``s
   from its cache; the launch counts must be 42 forward and 42 x 16
   decode launches.  One windowed and one global layer's real q, k, v
   (prefill) and q, caches, lengths (first decode step) are captured and
   each kernel is held against its plain version on them (the planted
   faults are reported there, not required to fail); a profile of one
   decode step must hold exactly one ``decode_cluster`` launch a layer and
   no other decode kernel.  Logits, each pair within ``LOGIT_TOL`` (atol
   0.2022 + rtol 0.05 element by element, max |diff| 0.25, relative L2
   0.04; atol from the plain path's own gap over seeds 0-4, read with
   ``--logit-floor``; the float32 logits lie under 30, the final softcap):
   the last prefill logits against those of decoding the last token from
   a prefill one token shorter, with the kernels and again with the plain
   versions in their places (the model's own bfloat16 path rounds at other
   places in prefill and decode); and kernel against plain on each path —
   the 8,192-token prefill, and the decode step on one cache; all four are
   printed before any failure is raised.
   Prefill tokens/s, decode ms per step and peak device memory.
11. Batched serving at full width: ``BatchedServer`` with 4 slots and
   ``max_len`` 128 on 8 requests of 16-token prompts and 16 new tokens
   (``SERVE``: two rounds, the second in slots the first freed);
   every request drains, 8 x 16 tokens served, decode launches = 42 x
   the decode steps (admission included), forward launches = 42 x the
   prefills (none: admission runs decode steps); tokens/s and the share
   of the wall spent in admission.
12. Selective scan vs plain: ``mamba_scan.ops.scan`` against
   ``selective_scan_ref`` on the same card tensors over B in {1, 2, 4},
   L in {1, 63, 777, 8191}, D in {128, 1000, 8192}, N in {4, 8, 16},
   float32 and bfloat16, B and C as strided column slices of one
   (B, L, 256 + 2N) tensor (the model's x_proj output) or contiguous, Δ =
   |N(0, 1)|·0.1 + 0.01 and a random negative A (never the model's
   -(1..N)); then cases on the kernel's seams, from the geometry its
   library reports (channels a block, steps a lane, steps a chunk): L
   inside one lane segment, a chunk less one, a chunk and one, two chunks
   and a segment and one, with D past a whole number of blocks (u's rows
   16-byte aligned, so cp.async with a partial last piece, or not, so
   plain loads); and the main shape (B = 1, L = D = 8192, N = 16,
   float32, Δ log-uniform in [1e-3, 1e-1], a memory of up to 2,000
   steps).  Tolerance (``SCAN_TOL``, about twice the card's readings): the
   kernel takes exp(Δ·A) as exp2 of Δ times A·log2(e) (at most 2 ulp
   against expf's 1 a step) and sums y over N in another order, so the
   float32 state drifts from the plain version's by a random walk over
   the state's memory, 1/(Δ|A|) steps: relative L2 1e-6 on y and 2.5e-6
   on h_final, element by element atol + rtol (2e-5 + 1e-4 on y, 3e-6 +
   1e-4 on h); bfloat16 inputs are upcast alike, and y rounds once, so one
   bfloat16 step (rtol 1e-2, relative L2 6e-5).  Each case holds planted
   faults on the kernel's seams to the same limits and fails unless every
   one is rejected (the plain version computing what a kernel with that
   fault would; each planted only where it changes the result): the state
   zeroed before a step in mid-sequence (a chunk boundary: a carry lost
   between chunks); one lane's segment started from zero at a segment
   boundary inside a chunk (a lost scan prefix); every chunk's lanes past
   the first started from their prefix alone, without the carry's decayed
   term; and one channel's step skipped.  Per case: errors, the wrapper's
   time (CUDA events), the kernel's device time (torch.profiler) and the
   bound (bytes, or the exp2 calls over the special-function units); at
   the main shape the plain version's time; no PyTorch call computes a
   selective scan, so there is no library time.
13. Falcon Mamba 7B at full width (``configs.get("falcon-mamba-7b")``: 64
   Mamba-1 layers, d_model 4096, d_inner 8192, N = 16, 7,273,709,568
   parameters in bfloat16, random weights from the seed) after Gemma's
   are freed: one 8,192-token prompt through ``prefill_forward`` (64 scan
   launches, counts set to 0 just before), then 16 greedy
   ``decode_step``s (none: decode is the reference's plain recurrence).
   The first and last layer's real scan inputs are captured and the
   kernel held against the plain version on them (faults reported, not
   required to fail).  The last prefill logits against decoding the last
   token after an 8,191-token prefill (``MAMBA_LOGIT_TOL``), and every
   layer's ssm and conv states after the prompt both ways
   (``MAMBA_STATE_TOL``), with the kernel and again with the plain scan
   in every layer (the second witness: the model's own bfloat16 floor),
   and kernel against plain on each path.  Prefill tokens/s (cold and
   warm), decode ms per step, a torch.profiler split of one prefill and
   one decode step, peak device memory.
14. Batched serving on Falcon Mamba 7B: ``BatchedServer`` as in phase 11;
   every request drains, 8 x 16 tokens served, 0 scan launches (admission
   runs decode steps, as in the reference); tokens/s and admission's
   share of the wall.

15. The paper's batch job on the host: ``Coordinator.run_job`` with the
   paper's §IV-C configuration (``PAPER_JOB``: 4 Mappers, 2 Reducers,
   combiner and Finalizer, 50 MB buffers, 5 MB multipart, fan-in 100, 75%
   spill threshold; the pools as the reference's Fig. 6 bench sets them)
   on Fig. 6's second-largest input, 4 MiB of ``synth_corpus`` text over 5,000
   words (one line: the Splitter extends every range to the next newline,
   so one mapper reads it all, as in the reference), with the combiner on
   and off.  The Finalizer's object must
   equal a ``collections.Counter`` oracle, and the same tokens counted by
   the array pipeline built with ``device="cuda"`` (one hash_combine
   launch, counts set to 0 just before).  Prints each job's wall, the
   per-role phase times (download, process, upload) and the spill bytes.
16. The job service on the card: one ``JobServer`` with three tenants on
   one shared ingest of phase 3's Linear Road log (1,000,000 reports,
   65,536-record segments): ``lav`` (phase 3's program), per-segment
   report counts a minute (``tumbling(60)``, ``count``) and the 100
   fastest segments every 5 minutes (``tumbling(300)``, ``mean``,
   ``top_k(100)``), each built with ``device="cuda"``.  When the log has
   drained every job must be PARKED and the pool at 0 replicas; two more
   minutes of reports (200,000, from seed + 16) are appended, which
   cold-restores every job, and the service runs to completion.  Each log
   segment must be read exactly once, fused_fold's launches (counts set to
   0 just before) must equal the jobs' fold steps, no pair may be late,
   every tenant's sinks must equal, byte for byte, its program run alone
   on a private store over the whole log, built both with ``device="cuda"``
   and with ``device="cpu"`` (every fold through the plain version), and
   ``lav``'s must equal phase 3's numpy oracle over the whole log.  Prints aggregate and per-tenant
   records/s, cold-restore latency (p50, max), the pool's compute seconds,
   ``JobServer.stats()``, and the device work of the appended part
   (torch.profiler, CUDA activity only) against its wall.  Both phases'
   other times are host times.

17. A stage DAG on the card: ``congestion_chain`` (see
   ``src/repro_torch/workloads/linear_road.py``) over phase 3's 1,000,000
   reports — reports per segment per minute (``tumbling(60)``, ``count``,
   10,000 segment keys) teed into a device edge (``sliding(300, 60)``
   ``mean`` of the per-minute counts, ``top_k(100)``) and a host edge
   (``key_by`` the expressway, ``tumbling(300)`` ``sum``, a 64-bucket
   stage).  Both sinks must equal, byte for byte, the program built with
   ``device="cpu"`` (every fold through the plain version) and the numpy
   oracles (the top-k ties broken toward the segment the log showed
   first, as ``top_k_buckets`` breaks them); fused_fold's launches
   (counts set to 0 just before) must equal the fold steps of all three
   stages.  A second card run under one torch.profiler session puts each
   device-edge handoff between two synchronizes in its own
   ``record_function`` range and fails on any device-to-host copy (a
   ``Memcpy DtoH`` record) launched from those ranges (matched to the
   CUDA calls made inside them by correlation id), on any host read of
   a tensor there, or when the ranges launched no device record at all.
   Prints records/s, the folds per stage, the device edge's host time
   (first run) and device time (second run).
18. A windowed join on the card: ``toll_inputs_join`` — per segment and
   minute, the mean speed from one log ⋈ the report count from another
   (phase 3's reports written under two prefixes; 2,000,000 records
   through one ``JoinSource``).  Both sides fold into one (8 × 10,000, 4)
   carry at channel bases 0 and 2 (each side's first three folds are
   checked to leave the other pair untouched); the sinks must equal the
   ``device="cpu"`` build and the numpy oracle; launches must equal the
   fold steps.  Prints records/s and the (segment, minute) pairs under 40
   mph with more than 50 reports.  Both phases' times are host times
   unless said otherwise.

19. Group mode on a stream: ``segment_median_pipeline`` (see
   ``src/repro_torch/workloads/linear_road.py``) over phase 3's 1,000,000
   reports — the median speed per segment (10,000 keys) over
   ``sliding(300, 60)``, ``reduce(median_reduce, mode="group",
   capacity=2**17)``, 8 workers, 8 slots: every report of a window is
   buffered on the card (an 8 x 8 x 2**17 record carry, 67 MB) and the
   median runs over each segment's full list when the window finalizes.
   No record may be dropped past capacity and no pair may be late; the
   sinks must equal the ``device="cpu"`` build byte for byte and a numpy
   median oracle (integer speeds: the medians are exact).  Prints
   records/s, the host time of the folds (``step``) and of the
   finalizations (``finalize_slot``), their device time (a second card
   run under torch.profiler, each call between two synchronizes, which
   must emit the same sinks; the device records each call launched),
   and the carry's bytes.
20. The combiner-off word count on the card: ``wordcount-hibench-large``
   (phase 6's 2**28 tokens, 8 workers) through ``group_pipeline`` —
   ``reduce("sum", mode="group", capacity=C)``, every token through the
   grouping shuffle to its word's partition — with C sized from the
   shards (``group_capacity``) so nothing drops.  Three runs from
   device-resident shards, each equal to the ``np.bincount`` oracle and
   to phase 6b's ``hash_combine`` counts exactly, with 0 ``hash_combine``
   launches; prints their median wall against phase 6b's (the combiner
   on, the same shards on the card) and the peak device memory.  Then a
   real-valued witness: worker 0's sorted tokens with values uniform in
   [0, 1) through ``segment_reduce("sum")`` on the card and on the CPU —
   how many of the 1,000 sums differ bit-wise, and the largest relative
   difference, which must stay within ``REAL_SUM_RTOL`` (1e-4).
   Group mode has no kernel in either package (the reference refuses
   ``backend="pallas"`` for group plans), so phases 19-20 add no entry
   to the kernels line.
21. The backends (``engine/compile.py``).  ``linear-road-lav`` again (phase
   3's log) under ``backend="vmap"`` with 8 simulated workers: sinks equal
   phase 3's ``"fused"`` run window by window, ``fused_fold`` launches =
   fold steps, and at the main shape one vmap fold step (the ``(8, per,
   5)`` wire into the ``(8, per, 2)`` carry) puts exactly one record on
   the card, the fold kernel — no copy of the carry or the wire — into the
   same carry storage; its CUDA-event, device (torch.profiler) and host
   times beside the fused step's.  Then ``backend="shard_map"`` in a world
   of one NCCL rank (``init_process_group("nccl")`` through a file store):
   the paper's word count (phase 6's 2**28 tokens as the flat data the
   rank is handed) equal to phase 6b's counts with one ``hash_combine``
   launch, and ``linear-road-lav`` equal to phase 3's sinks with
   ``fused_fold`` launches = fold steps; every NCCL collective the runs
   call (``all_to_all_single``, ``all_gather``, ``all_reduce``) counted,
   and the shard_map fold step (partial, fold, reduce-scatter, stats
   ``all_reduce``) timed against the fused one at the main shape.  Phase
   21 adds no kernel: its launches are of the two already listed.

22. qwen2-moe-a2.7b at full size (``configs.get("qwen2-moe-a2.7b")``: 24
   layers, d_model 2048, 16 heads of 128 (GQA group 1), 60 routed experts
   top-4 of d_ff 1408 and a shared expert of 5632 behind a sigmoid gate,
   14,315,634,688 parameters in bfloat16, random weights from the seed)
   after the earlier models are freed: one 8,192-token prompt through
   ``prefill_forward`` at the published capacity_factor 1.25 (24
   ``fwd_wgmma`` launches, counts set to 0 just before), then 16 greedy
   ``decode_step``s (24 x 16 ``decode_cluster`` launches); the pairs each
   layer's dispatch dropped; decode ms a step against the time to read
   the routed experts' weights once (the reference's formulation runs
   every expert over its capacity rows).  Layer 0's real q, k, v and
   decode inputs are captured and each kernel held against its plain
   version (faults reported, not required to fail).  Layer 0's real MoE
   input h: the dispatch on the card (``buf_tok``, ``buf_valid``,
   ``buf_w``, ``pair_slot``, ``xb``, drops per expert) must equal the
   CPU's bit for bit given the same routing; two bfloat16 calls must agree
   bit for bit (the combine gathers; no atomics); the bfloat16 layer is
   held against the same layer in float32 on the same h, with identical
   routing, within ``MOE_LAYER_REL_L2``.  Then the witness at
   capacity_factor E / k, where no pair drops (asserted): the last
   prefill logits against decoding the last token after a prefill one
   token shorter, with the kernels and with the plain versions, and
   kernel against plain on each path, within ``MOE_LOGIT_TOL`` (read with
   ``--logit-floor ... --arch``); how many (token, slot) routing choices
   differ between the kernel and the plain prefill, layer by layer; a
   profile of one decode step must hold exactly one ``decode_cluster`` a
   layer.  A torch.profiler split of one decode step and one prefill
   (router, dispatch, expert GEMMs, combine, shared expert, attention
   kernels, ``unembed``, the rest; each MoE part in its own
   ``record_function`` range, its device records matched by correlation
   id), prefill tokens/s and peak memory.  Then ``BatchedServer`` as in
   phase 11 (4 slots, 8 requests of 16 + 16 tokens): every request
   drains, decode launches = 24 x the decode steps.
23. mixtral-8x7b at full width, its depth cut to 8 of 32 layers (46.7e9
   bfloat16 parameters, 87.0 GiB, do not fit the card's 80 GB; 8 layers
   hold 11,872,305,152, 22.1 GiB): d_model 4096, 32 q / 8 kv heads of 128
   (GQA group 4), window 4096 on every layer, 8 experts top-2 of d_ff
   14336.  Phase 22's checks, without the serving: 8 ``fwd_wgmma``
   launches over the 8,192-token prompt (the windowed forward), 8 x 16
   ``decode_cluster`` launches, drops per layer, the dispatch and layer
   checks, the witness and kernel-vs-plain logits, tokens/s.
   Phases 22-23 add no kernel: the reference computes MoE outside any
   Pallas kernel (``jnp.einsum``), so the expert products are
   ``torch.bmm``; their launch counts are printed on earlier lines.

24. Training: gemma2-9b at full width (d_model 3584, 16 q / 8 kv heads
   of 256, d_ff 14336, vocab 256,000, window 4096 on even layers,
   softcaps 50 and 30, tied embeddings), its depth cut to 4 of 42 layers
   (``TRAIN``: 1.71e9 parameters; 8 layers fit under 80 GB — bfloat16
   parameters and gradients, float32 moments and the update's float32
   gradients, the float32 logits and ``unembed``'s float32 table with
   their gradients at B = 1, S = 4096 — but their 25 GB checkpoint kept
   the script too near its time limit once phase 25 came), random
   weights from the seed, remat on.  First two gradient checks at one layer of
   the same widths, its q projection drawn 8 times larger so that scores
   reach the softcap's curve; the loss as a relative gap and each leaf as
   a relative L2 error, each within ``GRAD_FLOOR_FACTOR`` (2) times its
   own floor, and a planted fault (a backward that drops the softcap)
   outside some leaf's limit.  (1) On a 256-token prompt, the card's path
   (``fwd_wgmma`` forward, the chunked backward) against the CPU's plain
   autograd of the same bfloat16 parameters; the floor is the plain
   version on the card.  (2) At the main path's shape, B = 1 and S =
   4096 (four blocks of 1024 keys in the backward), on the card: the
   card's path and the plain version in blocks against the plain version
   in float32 with the keys in one block (no online-softmax rescaling);
   the floor is the plain version in bfloat16 in one block.  Then the
   main path:
   the reference's synthetic corpus (``make_store_with_corpus`` →
   ``PackedLMDataset`` → ``Prefetcher``), ``AdamW`` on ``cosine_schedule``,
   ``Trainer.run`` for 6 steps at B = 1, S = 4096 (counts set to 0 just
   before): finite losses and grad norms, ``fwd_wgmma`` launches = layers
   x steps x microbatches x 2 (the forward and remat's recompute), no
   decode launch; then 2 steps of ``make_train_step`` at microbatches 2
   (B = 2) with their launches; a profiled step; step walls, tokens/s,
   the final checkpoint's time and peak memory.  Restart, at one layer of
   the full widths (the 4-layer state is 17 GB a checkpoint, and three
   runs' checkpoints in host memory would not fit): a checkpoint's
   snapshot, write and restore times, restored bit for bit; a run of 4
   steps preempted at step 2 (two 11 GB checkpoints: at the preemption
   and at the end; the periodic cadence is held against the reference's
   Trainer on the CPU), resumed by a fresh ``Trainer`` from its bfloat16
   checkpoint, whose losses and state must equal an uninterrupted run's
   bit for bit for the two steps after the restore.  Last, a world of one NCCL
   rank at the reduced width (float32): ``make_shardmap_train_step``'s
   int8 all-reduce within half a quantization step of the gradients, its
   compressed step within ``lr`` of ``make_train_step``'s parameters with
   the same loss, and its mean step equal bit for bit.  Phase 24 adds no
   kernel: the reference trains attention through its chunked path, which
   is the port's backward; the forward launches are of ``fwd_wgmma``.

25. zamba2-1.2b whole (``configs.get("zamba2-1.2b")``: 38 Mamba-2 layers,
   d_model 2048, d_inner 4096, 64 SSD heads of 64, ssm_state 64, conv 4;
   one shared attention block, 32 heads of 64 (GQA group 1, no window, no
   softcap) and a GELU GLU of 8192, run after layers 5, 11, 17, 23, 29
   and 35 with one set of weights and six KV caches; 1,170,308,864
   parameters in bfloat16, random weights from the seed) after the
   earlier models are freed: one 8,192-token prompt through
   ``prefill_forward`` (6 ``fwd_wgmma`` launches, counts set to 0 just
   before), then 16 greedy ``decode_step``s (6 x 16 ``decode_cluster``
   launches).  The first shared call's real q, k, v and decode inputs are
   captured and each kernel held against its plain version (faults
   reported, not required to fail).  (d) Layer 0's real SSD input
   (``_ssd_chunked``, float32) on the card against the CPU within
   ``ZAMBA_SSD_REL_L2``, and its closed-form recurrence between the 128
   chunks against the reference's sequential scan within the same limit,
   as captured and with the log decays scaled by 1e-3 (random weights'
   chunk decays underflow, which would leave nothing to carry).  (a, b) The last prefill logits against decoding
   the last token after an 8,191-token prefill, with the kernels and with
   the plain versions, and kernel against plain on each path, within
   ``ZAMBA_LOGIT_TOL``; every layer's ssm and conv state and row 8,191 of
   the six calls' k and v both ways, and kernel against plain, within
   ``ZAMBA_STATE_TOL`` (both limits twice the plain path's floor over seeds
   0-4, ``--logit-floor 0 1 2 3 4 --arch zamba2-1.2b``).  (c) Two planted
   faults on the kernel path, each required to break its limit by
   ``ZAMBA_FAULT_FACTOR``: the last chunk padded before the softplus (the
   8,191-token prompt pads one step, whose dt is then softplus(dt_bias)
   rather than 0) and a decode walk without the last call of the shared
   block.  A torch.profiler split of one decode step and one prefill
   (in/out projections, conv + SiLU + softplus, the SSD's intra-chunk,
   chunk-state, recurrence and off-diagonal parts, the gated norm, the
   shared block's GEMMs, ``unembed``; each in its own ``record_function``
   range, its device records matched by correlation id; the attention
   kernels by name, which must count 6 ``fwd_wgmma`` a prefill and 6
   ``decode_cluster`` a step); warm prefill tokens/s, decode ms, busy
   shares and peak memory.  Then ``BatchedServer`` as in phase 11: every
   request drains, decode launches = 6 x the decode steps.  Phase 25 adds
   no kernel: the reference computes the SSD outside any Pallas kernel
   (``jnp.einsum`` and ``lax.scan``), so the port computes it with
   PyTorch tensor operations.
26. The reference's last two architectures whole, one after the other
   (``EMBED``), each with random weights from the seed: internvl2-2b
   (``configs.get("internvl2-2b")``: 24 layers, d_model 2048, 16 q / 8 kv
   heads of 128, rope theta 1e6, RMSNorm, a SiLU GLU of 8192, an untied
   92,553-word head; 1,889,144,832 parameters; ``input_mode
   "embeddings"``, the vision frontend a stub) prefills 8,192 patch
   embeddings (standard normal times 0.02, the embed table's scale) and
   then decodes 16 greedy tokens as ids through the embed table — the
   text after an image; musicgen-medium (48 layers, d_model 1536, 24
   heads of 64, GQA group 1, LayerNorm with biases at eps 1e-5, a GELU
   GLU of 6144, an untied 2,048-word head; 1,818,378,240 parameters; a
   token model, as the reference configures it: EnCodec codes) prefills
   8,192 codes and decodes 16.  Per model, as phase 10: the main path's
   launches (one ``fwd_wgmma`` a layer a prefill, one ``decode_cluster``
   a layer a step, counts set to 0 just before), layer 0's captured
   attention inputs against the plain versions with their times, bound
   and SDPA's; the warm 8,191-position prefill; the last prefill logits
   against decoding the last position after an 8,191-position prefill —
   for internvl2 a (1, 1, d) embedding, so the two models drive both of
   ``decode_step``'s input rules — with the kernels and with the plain
   versions, and kernel against plain on each path, within
   ``EMBED_LOGIT_TOL`` (twice the plain path's floor over seeds 0-4,
   ``--logit-floor 0 1 2 3 4 --arch internvl2-2b`` or ``musicgen-medium``);
   one planted fault, the decode step's input multiplied by sqrt(d_model)
   (an embed scale where the config has none), which must break a limit
   by ``EMBED_FAULT_FACTOR``; a torch.profiler split of one decode step
   and one prefill (attention projections, norms, MLP, ``unembed``, the
   attention kernels by name), busy shares and peak memory.  Then
   ``BatchedServer`` on internvl2-2b as in phase 11 (token prompts, the
   reference's serving): every request drains, decode launches = 24 x the
   decode steps.  No new kernel: both models attend through ``fwd_wgmma``
   and ``decode_cluster``.

Before the last line it prints one JSON object ``{"kernels": [...]}``
(per kernel: launches on its main path, error, kernel / plain / bound /
library times at its main path's shape; ``fused_fold``'s entry also has
``host_us`` and ``device_ops_per_fold``); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without a result when torch sees no CUDA device or when the
repository's sources are missing.  The kernels line's ``launches`` for the
two attention kernels are phase 10's (its main path, counts set to 0 just
before it); their times are the mean of the windowed and the global
layer's shapes captured there.  The fifth entry, ``mamba_scan``, has
phase 13's launches and the mean times of its first and last layer's
captured shapes (``library_ms`` null: no PyTorch call computes a
selective scan).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time
from contextlib import nullcontext

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
REPS = 20
HOST_CALLS = 1000               # fold calls timed on the host clock
BIG_N = 1 << 22
BIG_BUCKETS = 1 << 20
FANOUT = 5
N_SLOTS = 8
HC_NS = (1 << 16, 1 << 24)
HC_BUCKETS = (32, 1000, 4096, 65536)
HC_DS = (1, 4, 16)
HC_KERNELS = ("combine_shared", "combine_global", "round_to_bf16")
HASHED = {"n_tokens": 1 << 20, "vocab": 1 << 16, "buckets": 1024}
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
FD_KERNELS = ("decode_cluster",)
# atol, rtol, relative L2 (||got - want|| / ||want||) of kernel vs plain
FA_TOL = {"bfloat16": (5e-3, 2e-2, 5e-3), "float32": (1e-4, 1e-4, 1e-3)}
FD_TOL = {"bfloat16": (1e-4, 1e-2, 5e-3), "float32": (1e-4, 1e-4, 1e-3)}
FAULT_TILE = 64                 # keys of the forward's planted skipped tile
FA_REPS = 5
FA_CASES = [  # b, hq, hkv, sq, skv, d, causal, window, softcap, dtype
    (1, 8, 8, 1000, 1000, 64, True, None, None, "bfloat16"),
    (2, 16, 8, 1000, 1000, 128, True, 16, 50.0, "bfloat16"),
    (1, 16, 2, 1000, 8191, 256, False, None, 50.0, "bfloat16"),
    (1, 16, 8, 8191, 8191, 256, True, 4096, 50.0, "bfloat16"),
    (1, 4, 2, 500, 500, 96, True, 64, 50.0, "bfloat16"),
    (1, 8, 1, 1000, 1000, 256, True, 4096, None, "float32"),
    (2, 4, 4, 1000, 1000, 64, False, 16, 50.0, "float32"),
    (1, 8, 4, 777, 777, 128, True, None, None, "float32"),
    (3, 8, 1, 8191, 8191, 64, True, 16, 50.0, "bfloat16"),
    (1, 16, 2, 8191, 8191, 128, False, None, None, "bfloat16"),
    (3, 8, 8, 1000, 777, 64, False, None, 50.0, "bfloat16"),
    (1, 8, 1, 1000, 1000, 256, True, 16, None, "bfloat16"),
    (3, 16, 8, 300, 10, 256, True, 16, 50.0, "bfloat16"),
    (1, 16, 8, 8192, 8192, 256, True, 4096, 50.0, "bfloat16"),
    (1, 16, 8, 8192, 8192, 256, True, None, 50.0, "bfloat16"),
    (1, 16, 8, 8191, 8191, 128, True, None, None, "bfloat16"),  # internvl2
    (1, 24, 24, 8191, 8191, 64, True, None, None, "bfloat16"),  # musicgen
]
FD_CASES = [  # b, hq, hkv, s_max, d, window, softcap, dtype, cache shift
    (1, 16, 8, 8320, 256, None, 50.0, "bfloat16", 0),
    (4, 16, 8, 8320, 256, 4096, 50.0, "bfloat16", 0),
    (8, 16, 8, 8320, 256, 16, None, "bfloat16", 0),
    (2, 8, 8, 1000, 64, None, None, "float32", 0),
    (3, 16, 2, 4096, 128, 4096, 50.0, "float32", 0),
    (5, 32, 8, 2048, 128, 16, 50.0, "bfloat16", 0),
    (6, 56, 8, 1024, 128, None, None, "bfloat16", 0),
    (1, 4, 4, 1, 64, None, None, "bfloat16", 0),
    (4, 64, 8, 4096, 128, None, None, "bfloat16", 0),    # qwen3-32b, group 8
    (2, 32, 8, 4096, 160, 1000, None, "bfloat16", 0),    # stablelm-12b
    (8, 16, 8, 4096, 256, None, 50.0, "bfloat16", 2),    # caches at byte 2
    (3, 21, 3, 500, 33, 100, 30.0, "float32", 4),        # rows off 16 bytes
    (1, 16, 8, 8193, 128, None, None, "bfloat16", 0),    # internvl2-2b
    (1, 24, 24, 8193, 64, None, None, "bfloat16", 0),    # musicgen-medium
]
GEMMA = {"arch": "gemma2-9b", "prompt": 8192, "decode_steps": 16,
         "phase": 10}
# every serving: two rounds through the 4 slots, the second admitted into
# slots the first freed (over stale k/v cells and Mamba states); 16 + 16
# tokens a request keep it at 152 decode steps, as 4 x (32 + 32) would
SERVE = {"slots": 4, "max_len": 128, "requests": 8, "prompt": 16,
         "max_new": 16}
# two logit vectors at full width: atol + rtol element by element, and a
# max |diff| and relative L2 of about twice the largest gap read on the
# card.  atol is twice the largest element excess max(|diff| - rtol |want|)
# of the plain path's own prefill vs decode gap (no kernels; the floor of
# bfloat16 rounding carried through 42 layers) over seeds 0-4
# (``--logit-floor 0 1 2 3 4``, on an H100 80GB HBM3 at 700 W): excess
# 0.09301 / 0.09236 / 0.1011 / 0.09171 / 0.09966, max |diff| 0.1032 /
# 0.1063 / 0.1106 / 0.1039 / 0.107, relative L2 0.0188 / 0.01872 /
# 0.02022 / 0.01935 / 0.02011 (kernel vs plain was 0.1173 / 0.0208 at seed
# 0), so max_abs and rel_l2 stay
LOGIT_TOL = {"atol": 0.2022, "rtol": 0.05, "max_abs": 0.25, "rel_l2": 0.04}
# exp2 results per second on the special-function units: H100 SXM, 16 a
# clock per SM (NVIDIA's CUDA documentation, arithmetic instruction
# throughput), 132 SMs at the 1.98 GHz boost clock
SFU_EXP_PER_S = 132 * 16 * 1.98e9
SCAN_DT_RANK = 256              # falcon-mamba-7b's dt_rank: B, C row stride
SCAN_REPS = 5
# atol, rtol, relative L2 of kernel vs plain, for y and for h_final: about
# twice the largest reading on the card (float32 y relative L2 4.8e-7 and
# max |err| 6.7e-6 at RMS 1.18; h 1.1e-6 and 1.4e-6; bfloat16 y 2.7e-5,
# one bf16 step)
SCAN_TOL = {"float32": {"y": (2e-5, 1e-4, 1e-6), "h": (3e-6, 1e-4, 2.5e-6)},
            "bfloat16": {"y": (1e-5, 1e-2, 6e-5),
                         "h": (3e-6, 1e-4, 2.5e-6)}}
SCAN_CASES = [  # batch, L, D, N, dtype, strided B and C
    (1, 1, 128, 4, "float32", False),
    (2, 63, 1000, 8, "float32", True),
    (4, 63, 8192, 16, "bfloat16", False),
    (1, 777, 128, 16, "bfloat16", True),
    (4, 777, 1000, 4, "float32", False),
    (2, 777, 8192, 8, "bfloat16", True),
    (1, 8191, 1000, 16, "bfloat16", True),
    (2, 8191, 128, 4, "float32", True),
    (1, 8191, 8192, 16, "float32", True),
]
SCAN_MAIN = (1, 8192, 8192, 16, "float32", False)
MAMBA = {"arch": "falcon-mamba-7b", "prompt": 8192, "decode_steps": 16}
# Falcon Mamba prefill vs decode at full width: limits on the logits and
# on every layer's SSM (float32) and conv (bfloat16) state, about twice the
# largest gap read on the card — the plain scan in the kernel's place gave
# the same gaps to the last bit (logits max |diff| 0.0950, relative L2
# 0.0175; worst-layer state relative L2 0.0090 ssm, 0.0104 conv), so they
# are the floor of the model's own bfloat16 path
MAMBA_LOGIT_TOL = {"atol": 0.1, "rtol": 0.05, "max_abs": 0.2,
                   "rel_l2": 0.035}
MAMBA_STATE_TOL = {"ssm": 0.02, "conv": 0.021}  # relative L2, worst layer
# the mixture-of-experts models: qwen2-moe-a2.7b whole, mixtral-8x7b at full
# width with its depth cut to 8 of 32 layers (46.7e9 bf16 parameters, 87.0
# GiB, do not fit 80 GB; 8 layers hold 11.9e9, 22.1 GiB)
QWEN_MOE = {"arch": "qwen2-moe-a2.7b", "prompt": 8192, "decode_steps": 16,
            "layers": None, "phase": 22}
MIXTRAL = {"arch": "mixtral-8x7b", "prompt": 8192, "decode_steps": 16,
           "layers": 8, "phase": 23}
# whole-model logits of the MoE models (prefill vs decode at a capacity
# factor where nothing drops, kernel vs plain on each path), every path
# routed by the plain prefill's expert choices (``_MoeProbe.replay``):
# routing is discontinuous, and with free routing a rounding difference
# near a tie moves a token to another expert outright (a quarter of the
# choices by layer 10 of qwen2-moe-a2.7b with random weights), so the
# gap would measure routing chaos rather than the kernels.  As
# ``LOGIT_TOL``: atol twice the largest element excess max(|diff| - rtol
# |want|) of the plain path's own replayed prefill-vs-decode gap over
# seeds 0-4, max_abs and rel_l2 twice its largest max |diff| and relative
# L2 (``--logit-floor 0 1 2 3 4 --arch ...``, on an H100 80GB HBM3 at 700
# W).  qwen2-moe-a2.7b: excess 0.04188 / 0.05126 / 0.05021 / 0.03963 /
# 0.05854, max |diff| 0.05 / 0.05272 / 0.0564 / 0.0577 / 0.06862, relative
# L2 0.01252 / 0.0132 / 0.01257 / 0.01249 / 0.01452.  mixtral-8x7b (8
# layers): excess 0.05064 / 0.05561 / 0.05137 / 0.04721 / 0.04788, max
# |diff| 0.06273 / 0.06373 / 0.08003 / 0.05522 / 0.06063, relative L2
# 0.01135 / 0.01168 / 0.01345 / 0.01047 / 0.01125
MOE_LOGIT_TOL = {
    "qwen2-moe-a2.7b": {"atol": 0.1171, "rtol": 0.05, "max_abs": 0.1372,
                        "rel_l2": 0.02904},
    "mixtral-8x7b": {"atol": 0.1112, "rtol": 0.05, "max_abs": 0.1601,
                     "rel_l2": 0.0269},
}
# one MoE layer in bfloat16 against the same layer in float32 on the same
# input (identical routing): relative L2 of the output.  bfloat16 rounds the
# dispatch buffers, the gate and up products and their activated product,
# each at most 2^-9 relative, and the weights themselves are the same
MOE_LAYER_REL_L2 = 1e-2
# (this cannot tell a bfloat16-rounded down product: that adds ~1e-3 in
# quadrature to ~4e-3).  So ``_experts``' down product is held against the
# float32 product of the same bfloat16 operands, relative L2: float32
# accumulation in another order reads 1.7e-6 (qwen2-moe-a2.7b) and 1.7e-5
# (mixtral-8x7b's 14,336-long sums), a bfloat16-rounded product 1.7e-3,
# which the check must reject (H100 80GB HBM3, 700 W)
MOE_DOWN_REL_L2 = 1e-4
# zamba2-1.2b (phase 25): 38 Mamba-2 layers and the shared attention block
# after layers 5, 11, 17, 23, 29 and 35, whole
ZAMBA = {"arch": "zamba2-1.2b", "prompt": 8192, "decode_steps": 16,
         "phase": 25}
# prefill vs decode and kernel vs plain at full size, as ``LOGIT_TOL``:
# atol twice the largest element excess of the plain path's own gap over
# seeds 0-4 (``--logit-floor 0 1 2 3 4 --arch zamba2-1.2b``, on an H100
# 80GB HBM3 at 700 W: excess 0.07836 / 0.07244 / 0.06852 / 0.07589 /
# 0.07256, max |diff| 0.08069 / 0.08583 / 0.08055 / 0.08641 / 0.08172,
# relative L2 0.02016 / 0.0221 / 0.02211 / 0.0224 / 0.02236), max_abs and
# rel_l2 twice its largest max |diff| and relative L2
ZAMBA_LOGIT_TOL = {"atol": 0.1567, "rtol": 0.05, "max_abs": 0.1728,
                   "rel_l2": 0.0448}
# every layer's ssm (float32) and conv (bfloat16) state and row S-1 of the
# six shared-block calls' k and v (bfloat16), relative L2 of the worst
# layer or call: twice the plain path's largest over the same seeds (ssm
# 0.0312 / 0.0312 / 0.0294 / 0.03226 / 0.0273, conv 0.0185 / 0.0188 /
# 0.0169 / 0.01881 / 0.0155, k and v 0.019 / 0.0209 / 0.0228 / 0.0221 /
# 0.0211; the largest printed as 0.03226, 0.01881, 0.02275)
ZAMBA_STATE_TOL = {"ssm": 0.06452, "conv": 0.03763, "sa": 0.0455}
# the SSD on layer 0's captured input, the card against the CPU, float32
# both (no TF32): relative L2 of y and of the final state (7.1e-7 and
# 4.9e-7 read on the card)
ZAMBA_SSD_REL_L2 = 1e-5
# each planted fault must break one of check (b)'s limits by at least this
# factor.  Random weights forget within a few tokens (dt near 0.7, A down
# to -64), so one decode step's own decay wipes most of what a fault did
# to the prefill's state: the pad fault read 3.0x the ssm limit
ZAMBA_FAULT_FACTOR = 2.0
# phase 26: the reference's last two architectures, whole — internvl2-2b's
# prompt is patch embeddings, musicgen-medium's EnCodec codes (token ids)
EMBED = ({"arch": "internvl2-2b", "prompt": 8192, "decode_steps": 16,
          "phase": 26},
         {"arch": "musicgen-medium", "prompt": 8192, "decode_steps": 16,
          "phase": 26})
# prefill vs decode and kernel vs plain at full size, as ``LOGIT_TOL``:
# atol twice the largest element excess of the plain path's own gap over
# seeds 0-4, max_abs and rel_l2 twice its largest max |diff| and relative
# L2 (``--logit-floor 0 1 2 3 4 --arch ...``, on an H100 80GB HBM3 at 700
# W).  internvl2-2b: excess 0.04928 / 0.05594 / 0.05305 / 0.06637 /
# 0.06397, max |diff| 0.05572 / 0.06585 / 0.06089 / 0.06732 / 0.06633,
# relative L2 0.01433 / 0.01614 / 0.0155 / 0.01606 / 0.01679.
# musicgen-medium: excess 0.04081 / 0.04017 / 0.05614 / 0.05087 /
# 0.03662, max |diff| 0.05191 / 0.04704 / 0.05778 / 0.05326 / 0.04795,
# relative L2 0.01964 / 0.01912 / 0.02092 / 0.02003 / 0.01924
EMBED_LOGIT_TOL = {
    "internvl2-2b": {"atol": 0.1327, "rtol": 0.05, "max_abs": 0.1346,
                     "rel_l2": 0.03358},
    "musicgen-medium": {"atol": 0.1123, "rtol": 0.05, "max_abs": 0.1156,
                        "rel_l2": 0.04184},
}
# the planted fault must break one of the logit limits by this factor
EMBED_FAULT_FACTOR = 2.0


def _median_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_us(ev) -> float:
    return getattr(ev, "device_time_total",
                   getattr(ev, "cuda_time_total", 0.0))


def _kernel_device_us(torch, fn, names, reps: int = REPS) -> str:
    """Device time of the named kernels per ``fn()`` call, from
    torch.profiler's CUDA trace; "not measured" when the trace holds no
    device time for them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_us(ev) for ev in prof.key_averages()
                if any(n in ev.key for n in names))
    return f"{total / reps:.2f} us" if total > 0 else "not measured"


def _device_records(torch, fn, reps: int = REPS) -> tuple:
    """Per ``fn()`` call, from torch.profiler's CUDA trace: the device time
    in us and the number of the records it puts on the card (kernels,
    fills, sets, copies), and their names.  The profiler drops a record
    now and then, so each name counts as its records a call rounded to a
    whole number, each taking that name's mean time; and it has missed a
    whole session (no device record at all), or most of one (a name with
    records in fewer than half the calls, which would round to none),
    which is traced again, up to three traces in all."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace() -> list:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return [ev for ev in prof.events()
                if ev.device_type == DeviceType.CUDA]

    fn()
    torch.cuda.synchronize()
    # ``fn`` puts the same work on the card each call, so a trace with no
    # device record, or a name recorded in fewer than half the calls, is a
    # capture that missed most of the session: take it again
    for _ in range(3):
        by_name = defaultdict(list)
        for ev in trace():
            by_name[ev.name[:60]].append(_device_us(ev))
        if by_name and all(2 * len(t) >= reps for t in by_name.values()):
            break
    per_call = {name: round(len(times) / reps)
                for name, times in by_name.items()}
    return (sum(statistics.fmean(by_name[n]) * k
                for n, k in per_call.items()),
            sum(per_call.values()), sorted(by_name))


def _fold_route(records: int, names) -> str:
    """How a fold reached the card, read from its trace: one cooperative
    kernel, or several device records (a fill before the kernel, ...)."""
    if records == 1 and names and all("fold_kernel" in n for n in names):
        return "one cooperative launch"
    return f"{records:g} device records"


def _fold_step(ops, kw, device):
    """The fold as the main path calls it, ``call(rows, carry, minw)``: a
    step of ``ops.make_fold_step`` (made once, as a plan makes it), or the
    one-off ``ops.fold`` in a checkout that has no ``make_fold_step``."""
    if not hasattr(ops, "make_fold_step"):
        return lambda rows, carry, minw: ops.fold(rows, carry, minw, **kw)
    step = ops.make_fold_step(**kw, device=device)
    if kw["host_wire"]:
        return lambda rows, carry, minw: step(rows, carry)
    return step


def fold_times(torch, ops, ref, rows, carry, minw, kw, *,
               host_calls: int = 0) -> dict:
    """The fold's numbers on one input, called as the main path calls it
    (``_fold_step``): the wrapper's time a call (CUDA events, median of
    ``REPS``), the device time and device records a fold (torch.profiler,
    every record: the kernels and any fill or set), the route, the plain
    version's time, one PyTorch call's (``_library_call``), the bound; with
    ``host_calls``, the host time a call (``perf_counter`` over that many
    calls, then one synchronize)."""
    call = _fold_step(ops, kw, carry.device)
    scratch = carry.clone()

    def fn():
        return call(rows, scratch, minw)

    ms = _median_ms(fn)
    device_us, records, names = _device_records(torch, fn)
    plain_ms = _median_ms(lambda: ref(rows, carry, minw, **kw))
    flat, vals = _expanded_pairs(rows, host_wire=kw["host_wire"],
                                 min_window=minw,
                                 num_buckets=kw["num_buckets"],
                                 carry_buckets=kw["carry_buckets"],
                                 hashed=kw["hashed"])
    lib_ms = _median_ms(_library_call(carry.clone(), flat, vals, kw["kind"],
                                      kw["channel_base"]))
    bound, by = _bound_ms(rows, flat)
    out = {"ms": ms, "device_us": device_us, "device_ops_per_fold": records,
           "route": _fold_route(records, names), "device_records": names,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": lib_ms, "cells_hit": _cells_hit(flat),
           "live_pairs": int(flat.numel())}
    if host_calls:
        out["host_us"] = 1e3 * _host_ms(torch, fn, host_calls)
    return out


def _wire_rows(rng, n, *, host_wire, keymax):
    """Integer-valued wire rows: device wire ``[last, n_windows, key,
    value, valid]`` with negative window indices near the stream start, or
    host wire ``[slot, key, value, valid]``; about 10% invalid."""
    if host_wire:
        cols = [rng.integers(0, N_SLOTS, n), rng.integers(0, keymax, n),
                rng.integers(-20, 100, n), rng.random(n) > 0.1]
    else:
        cols = [rng.integers(-6, 3 * N_SLOTS, n),
                rng.integers(1, FANOUT + 1, n), rng.integers(0, keymax, n),
                rng.integers(-20, 100, n), rng.random(n) > 0.1]
    return np.stack(cols, axis=1).astype(np.float32)


def _carry(rng, size, channels, kind):
    carry = rng.integers(0, 5, (size, channels)).astype(np.float32)
    if kind in ("min", "max"):      # the carry contract: count 0 -> value 0
        for b in range(0, channels, 2):
            carry[:, b] = np.where(carry[:, b + 1] > 0, carry[:, b], 0.0)
    return carry


def _expanded_pairs(rows, *, host_wire, min_window, num_buckets,
                    carry_buckets, hashed):
    """The live (flat id, value) pairs of a batch, pre-expanded — the input
    of the one-call "scatter only" yardstick (not used by the port)."""
    import torch
    from repro_torch.kernels.fused_fold.ref import murmur_bucket
    if host_wire:
        bucket = murmur_bucket(rows[:, 1], num_buckets, hashed)
        live = rows[:, 3] > 0
        flat = rows[:, 0].to(torch.int64) * carry_buckets + bucket
        return flat[live], rows[:, 2][live]
    j = torch.arange(FANOUT, device=rows.device)
    widx = rows[:, 0].to(torch.int64)[:, None] - j[None, :]
    live = (rows[:, 4] > 0)[:, None] & (j[None, :] < rows[:, 1][:, None]) \
        & (widx >= min_window)
    bucket = murmur_bucket(rows[:, 2], num_buckets, hashed).to(torch.int64)
    flat = torch.remainder(widx, N_SLOTS) * carry_buckets + bucket[:, None]
    vals = rows[:, 3][:, None].expand(flat.shape)
    return flat[live], vals[live]


def _library_call(carry, flat, vals, kind, base):
    """One PyTorch call computing the scatter part of the fold: index_add_
    of [value-or-1, 1] pairs, or scatter_reduce_ of the extremum."""
    import torch
    if kind in ("sum", "count"):
        pair = torch.stack([torch.ones_like(vals) if kind == "count"
                            else vals, torch.ones_like(vals)], dim=1)
        return lambda: carry[:, base:base + 2].index_add_(0, flat, pair)
    reduce = "amin" if kind == "min" else "amax"
    col = carry[:, base].contiguous()
    return lambda: col.scatter_reduce_(0, flat, vals, reduce=reduce)


def _cells_hit(flat) -> int:
    """Number of distinct carry cells among the live pairs' flat ids."""
    import torch
    return int(torch.unique(flat).numel())


def _bound_ms(rows, flat) -> tuple[float, str]:
    """Least time for the fold on this batch's data: every row read once,
    and only the carry cells its live pairs hit (the distinct ``flat``
    ids) read and written once in their two channels, plus the 12-byte
    stats, over HBM bandwidth; against two float32 adds per live pair over
    the float32 peak."""
    cells = _cells_hit(flat)
    nbytes = rows.numel() * 4 + 2 * cells * 2 * 4 + 12
    ops = flat.numel() * 2
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def phase_kernel(torch, ops, ref, device) -> float:
    """Phase 2, large shape: bit-identity over the whole sweep and the
    per-kind times.  Returns the largest absolute error seen."""
    rng = np.random.default_rng(SEED)
    worst = 0.0
    cases = [(hw, kind, hashed, 0, 2) for hw in (False, True)
             for kind in ("sum", "count", "min", "max")
             for hashed in (False, True)]
    # the upper pair of a 4-channel carry (paired reduction), and an odd
    # channel count at an odd base (the kernel's scalar pair)
    cases += [(False, "sum", False, 2, 4), (False, "sum", False, 1, 3),
              (True, "count", True, 1, 3)]
    for host_wire, kind, hashed, base, channels in cases:
        keymax = (1 << 24) if hashed else BIG_BUCKETS
        rows = torch.from_numpy(_wire_rows(rng, BIG_N, host_wire=host_wire,
                                           keymax=keymax)).to(device)
        carry0 = torch.from_numpy(_carry(rng, N_SLOTS * BIG_BUCKETS,
                                         channels, kind)).to(device)
        kw = dict(fanout=1 if host_wire else FANOUT, n_slots=N_SLOTS,
                  num_buckets=BIG_BUCKETS, carry_buckets=BIG_BUCKETS,
                  channel_base=base, hashed=hashed, host_wire=host_wire,
                  kind=kind)
        minw = 2
        want_c, want_s = ref(rows, carry0, minw, **kw)
        got_c, got_s = ops.fold(rows, carry0.clone(), minw, **kw)
        torch.cuda.synchronize()
        err = float((got_c - want_c).abs().max())
        worst = max(worst, err)
        label = (f"{'host' if host_wire else 'device'}-wire {kind} "
                 f"{'hashed' if hashed else 'dense'} base={base}/C={channels}")
        if not (torch.equal(got_c, want_c) and torch.equal(got_s, want_s)):
            raise AssertionError(f"fused_fold != plain version: {label}: "
                                 f"stats {got_s.tolist()} vs "
                                 f"{want_s.tolist()}, max |err| {err}")
        if not host_wire and int(want_s[0]) == 0:
            raise AssertionError(f"{label}: no late pairs exercised")
        if base:
            untouched = [c for c in range(channels) if c not in (base,
                                                                 base + 1)]
            if not torch.equal(got_c[:, untouched], carry0[:, untouched]):
                raise AssertionError(f"{label}: touched other channels")
        if hashed or base:
            print(f"kernel-check {label}: bit-identical, stats "
                  f"{got_s.tolist()}")
            continue
        t = fold_times(torch, ops, ref, rows, carry0, minw, kw)
        if t["route"] != "one cooperative launch":
            raise AssertionError(f"{label}: a fold put "
                                 f"{t['device_ops_per_fold']:g} records on "
                                 f"the card, not one: {t['device_records']}")
        print(f"kernel-check {label}: bit-identical, stats "
              f"{got_s.tolist()}; N={BIG_N} carry="
              f"{N_SLOTS * BIG_BUCKETS}x{channels}: kernel {t['ms']:.4f} ms "
              f"(device time {t['device_us']:.2f} us in "
              f"{t['device_ops_per_fold']:g} device records a fold: "
              f"{t['route']}), plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['cells_hit']} "
              f"cells hit by {t['live_pairs']} live pairs), scatter only "
              f"{t['library_ms']:.4f} ms")
    return max(worst, _join_cases(torch, ops, ref, device, rng))


def _join_cases(torch, ops, ref, device, rng) -> float:
    """Phase 2, the join's and the handoff's geometry at the large shape:
    a carry wider than the key space (``carry_buckets > num_buckets``, a
    narrow join side) for sum and count at channel bases 0 and 2, rows
    past the side's keys untouched; then one 4-channel carry folded at
    base 0 and again at base 2 (a join's two sides), the second fold
    leaving channels 0-1 as the first left them.  Bit-identical to the
    plain version.  Returns the largest absolute error."""
    wide = BIG_BUCKETS + 4099
    worst = 0.0

    def kw(kind, base):
        return dict(fanout=FANOUT, n_slots=N_SLOTS, num_buckets=BIG_BUCKETS,
                    carry_buckets=wide, channel_base=base, hashed=False,
                    host_wire=False, kind=kind)

    carry0 = torch.from_numpy(_carry(rng, N_SLOTS * wide, 4,
                                     "sum")).to(device)
    rows = [torch.from_numpy(_wire_rows(rng, BIG_N, host_wire=False,
                                        keymax=BIG_BUCKETS)).to(device)
            for _ in range(2)]
    for kind in ("sum", "count"):
        for base in (0, 2):
            want_c, want_s = ref(rows[0], carry0, 2, **kw(kind, base))
            got_c, got_s = ops.fold(rows[0], carry0.clone(), 2,
                                    **kw(kind, base))
            torch.cuda.synchronize()
            err = float((got_c - want_c).abs().max())
            worst = max(worst, err)
            past = got_c.view(N_SLOTS, wide, 4)[:, BIG_BUCKETS:]
            if not (torch.equal(got_c, want_c) and torch.equal(got_s, want_s)
                    and torch.equal(past, carry0.view(N_SLOTS, wide, 4)
                                    [:, BIG_BUCKETS:])):
                raise AssertionError(f"fused_fold != plain version with "
                                     f"carry_buckets={wide} > num_buckets="
                                     f"{BIG_BUCKETS}, {kind} base={base}")
            print(f"kernel-check device-wire {kind} carry_buckets={wide} > "
                  f"num_buckets={BIG_BUCKETS} base={base}/C=4: "
                  f"bit-identical, stats {got_s.tolist()}, rows past the "
                  f"key space untouched")
    want, _ = ref(rows[0], carry0, 2, **kw("sum", 0))
    want, want_s = ref(rows[1], want, 2, **kw("count", 2))
    got, _ = ops.fold(rows[0], carry0.clone(), 2, **kw("sum", 0))
    left = got[:, :2].clone()
    got, got_s = ops.fold(rows[1], got, 2, **kw("count", 2))
    torch.cuda.synchronize()
    worst = max(worst, float((got - want).abs().max()))
    if not (torch.equal(got, want) and torch.equal(got_s, want_s)
            and torch.equal(got[:, :2], left)):
        raise AssertionError("a 4-channel carry folded at base 0 then base 2 "
                             "differs from the plain version")
    print("kernel-check join sides: one 4-channel carry folded at base 0 "
          "(sum) then base 2 (count): bit-identical, channels 0-1 untouched "
          "by the second fold")
    return worst


def lr_batch(torch, lr, device):
    """One main-path-shaped fold input: the first 65,536 Linear Road
    reports as device-wire rows, as the coordinator ships them."""
    ts, seg, speed = lr.position_reports(SEED, **lr.FULL)
    n = lr.BATCH_RECORDS
    ts, seg, speed = ts[:n], seg[:n], speed[:n]
    last = np.floor(ts / lr.WINDOW_SLIDE).astype(np.int64)
    first = np.floor((ts - lr.WINDOW_SIZE) / lr.WINDOW_SLIDE) \
        .astype(np.int64) + 1
    base = (int(first.min()) // lr.N_SLOTS) * lr.N_SLOTS
    rows = np.stack([last - base, last - first + 1, seg, speed,
                     np.ones(n)], axis=1).astype(np.float32)
    nb = lr.num_segments(lr.FULL["n_xways"])
    carry = torch.zeros((lr.N_SLOTS * nb, 2), dtype=torch.float32,
                        device=device)
    return torch.from_numpy(rows).to(device), carry, nb


def phase_kernel_main_shape(torch, ops, ref, lr, device) -> dict:
    """Phase 2, main-path shape: bit-identity and the times the kernels
    line reports."""
    rows, carry, nb = lr_batch(torch, lr, device)
    kw = dict(fanout=FANOUT, n_slots=lr.N_SLOTS, num_buckets=nb,
              carry_buckets=nb, channel_base=0, hashed=False,
              host_wire=False, kind="sum")
    minw = -(2 ** 31)
    want_c, want_s = ref(rows, carry, minw, **kw)
    got_c, got_s = ops.fold(rows, carry.clone(), minw, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got_c, want_c) and torch.equal(got_s, want_s)):
        raise AssertionError("fused_fold != plain version at the main "
                             "path's shape")
    t = fold_times(torch, ops, ref, rows, carry, minw, kw,
                   host_calls=HOST_CALLS)
    print(f"kernel-check main-path shape rows={tuple(rows.shape)} carry="
          f"{tuple(carry.shape)} pairs={int(got_s[1])}: bit-identical; "
          f"kernel {t['ms']:.4f} ms per wrapper call (CUDA events), host "
          f"{t['host_us']:.2f} us a call ({HOST_CALLS} calls, then one "
          f"synchronize); device time {t['device_us']:.2f} us in "
          f"{t['device_ops_per_fold']:g} device records a fold "
          f"(torch.profiler: {', '.join(t['device_records'])}); route: "
          f"{t['route']}; plain {t['plain_ms']:.4f} ms, bound "
          f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['cells_hit']} of "
          f"{carry.shape[0]} cells hit by {t['live_pairs']} live pairs), "
          f"scatter only {t['library_ms']:.4f} ms", flush=True)
    if t["route"] != "one cooperative launch":
        raise AssertionError(f"a fold put {t['device_ops_per_fold']:g} "
                             f"records on the card, not one: "
                             f"{t['device_records']}")
    return {"max_abs_err": float((got_c - want_c).abs().max()),
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "host_us",
                                 "device_ops_per_fold")}}


def phase_main_path(torch, ops, lr) -> tuple:
    """Phase 3: linear-road-lav end to end on the card.  Returns the fused
    fold's launches during the run, the event log's store and the sink
    objects."""
    from repro_torch.core import (AutoscalerConfig, MemoryStore,
                                  MetadataStore, MeteredPool, ServerlessPool)
    from repro_torch.pipeline import RunOptions
    from repro_torch.streaming import write_event_log

    t0 = time.perf_counter()
    ts, seg, speed = lr.position_reports(SEED, **lr.FULL)
    store = MemoryStore()
    n = write_event_log(store, "linear-road/reports",
                        lr.records(ts, seg, speed), segment_records=65536)
    print(f"main-path: {n} position reports, "
          f"{lr.num_segments(lr.FULL['n_xways'])} segments, event log "
          f"written in {time.perf_counter() - t0:.1f} s")
    built = lr.lav_pipeline("linear-road/reports").build(
        device="cuda", job_id="linear-road-lav",
        **lr.build_options(lr.FULL["n_xways"]))
    pool = MeteredPool(ServerlessPool("stream-mapper",
                                      AutoscalerConfig(max_scale=8)))
    ops.fold.launches = 0
    report = built.run(store=store, meta=MetadataStore(), pool=pool,
                       options=RunOptions(overlap=True))
    launches = ops.fold.launches
    if report.error is not None:
        raise AssertionError(f"main path failed: {report.error}")
    if launches != report.folds or report.folds < report.batches:
        raise AssertionError(f"fused_fold launched {launches} times for "
                             f"{report.folds} fold steps over "
                             f"{report.batches} micro-batches")
    if report.late_dropped:
        raise AssertionError(f"{report.late_dropped} late pairs dropped; the "
                             f"oracle assumes none")
    oracle = lr.lav_oracle(ts, seg, speed)
    outputs = built.collect_outputs(store)
    want = {f"lav/linear-road-lav/window-{start:.3f}-"
            f"{start + lr.WINDOW_SIZE:.3f}": means
            for start, means in oracle.items()}
    if set(outputs) != set(want):
        raise AssertionError(f"sink windows differ from the oracle's: "
                             f"{sorted(set(outputs) ^ set(want))[:4]}")
    n_values = 0
    for key, blob in outputs.items():
        got = dict(json.loads(line) for line in blob.splitlines())
        if got != want[key]:
            bad = [k for k in want[key] if got.get(k) != want[key][k]][:3]
            raise AssertionError(f"{key}: LAV differs from the oracle at "
                                 f"{bad}")
        n_values += len(got)
    share = pool.meter.pool_seconds / report.wall_time
    print(f"main-path linear-road-lav: {report.records_in} records in "
          f"{report.wall_time:.3f} s = {report.records_per_sec:.0f} "
          f"records/s; {report.batches} micro-batches, {report.folds} "
          f"folds, {launches} fused_fold launches; {report.windows_emitted} "
          f"windows emitted ({n_values} segment means == oracle), "
          f"{report.late_dropped} late dropped; fold launches took "
          f"{pool.meter.pool_seconds:.3f} s = {100 * share:.2f}% of wall "
          f"time; p50/p99 close-to-emit {report.p50_emit_latency * 1e3:.2f}/"
          f"{report.p99_emit_latency * 1e3:.2f} ms")
    return launches, store, outputs


def phase_sessions(ops) -> None:
    """Phase 4: a per-vehicle session job on the host wire, card vs CPU,
    byte for byte."""
    from repro_torch.core import MemoryStore
    from repro_torch.pipeline import Pipeline, Windowing

    rng = np.random.default_rng(SEED + 1)
    pings = []
    for v in range(200):
        t = float(rng.uniform(0, 30.0))
        while t < 1800.0:
            for _ in range(int(rng.integers(5, 20))):        # one trip
                pings.append((t, f"vehicle-{v}", float(rng.integers(0, 101))))
                t += float(rng.uniform(0.5, 8.0))
            t += float(rng.uniform(60.0, 180.0))             # parked > gap
    pings.sort()
    pipe = (Pipeline.from_source(records=pings, batch_records=4096)
            .key_by().window(Windowing.session(30.0)).reduce("mean")
            .sink("trips/"))
    out = {}
    for device in ("cuda", "cpu"):
        before = ops.fold.launches
        built = pipe.build(num_buckets=256, n_workers=4, n_slots=4,
                           job_id="trips", device=device)
        outputs, report = built.run(store=MemoryStore())
        out[device] = outputs
        print(f"sessions on {device}: {len(pings)} pings, "
              f"{report.windows_emitted} sessions, "
              f"{ops.fold.launches - before} fused_fold launches")
    if not out["cuda"] or out["cuda"] != out["cpu"]:
        raise AssertionError("session sinks differ between cuda and cpu")
    print(f"sessions: {len(out['cuda'])} session objects byte-identical "
          f"between device='cuda' and device='cpu'")


def _hc_inputs(torch, rng, n, buckets, d, device):
    """Sweep inputs: keys over ``[-B/10, 1.1 B)`` (some outside the bucket
    range), about 20% invalid rows, integer values 0-8 (``(n,)`` for
    ``d == 1``)."""
    spill = max(buckets // 10, 1)
    keys = torch.from_numpy(rng.integers(-spill, buckets + spill, n,
                                         dtype=np.int32)).to(device)
    ints = rng.integers(0, 9, (n, d) if d > 1 else n, dtype=np.int8)
    vals = torch.from_numpy(ints).to(device).to(torch.float32)
    valid = torch.from_numpy(rng.random(n, dtype=np.float32) > 0.2).to(device)
    return keys, vals, valid


def _hc_bound_ms(keys, vals, valid, buckets) -> tuple[float, str]:
    """Least time for the combine on these inputs: keys (4 B) and valid
    flags (1 B) of every row read once, the values of the rows it keeps
    (valid, key in range) read once, and the (B, D) output written once,
    over HBM bandwidth; against one float32 add per kept value over the
    float32 peak."""
    d = 1 if vals.dim() == 1 else vals.shape[1]
    kept = int((valid & (keys >= 0) & (keys < buckets)).sum())
    esize = vals.element_size()
    nbytes = keys.numel() * 4 + valid.numel() + kept * d * esize \
        + buckets * d * esize
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = kept * d / FP32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def _hc_library_call(torch, keys, vals, valid, buckets):
    """One PyTorch call computing the combine over the kept rows (kept
    beforehand): ``bincount`` with weights for D = 1, ``index_add_`` into
    a zeroed (B, D) for D > 1."""
    kept = valid & (keys >= 0) & (keys < buckets)
    k, v = keys[kept].long(), vals[kept]
    if v.dim() == 1:
        return lambda: torch.bincount(k, weights=v, minlength=buckets)
    out = torch.zeros((buckets, v.shape[1]), dtype=v.dtype, device=v.device)
    return lambda: out.index_add_(0, k, v)


def _hc_times(torch, hc, hc_ref, keys, vals, valid, buckets) -> dict:
    """Wrapper, device, plain, library and bound times of one shape."""
    ms = _median_ms(lambda: hc.combine(keys, vals, buckets, valid))
    plain_ms = _median_ms(lambda: hc_ref(keys, vals, buckets, valid))
    lib_ms = _median_ms(_hc_library_call(torch, keys, vals, valid, buckets))
    device_us = _kernel_device_us(
        torch, lambda: hc.combine(keys, vals, buckets, valid),
        names=HC_KERNELS)
    bound, by = _hc_bound_ms(keys, vals, valid, buckets)
    return {"ms": ms, "device": device_us, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": by}


def phase_hash_combine(torch, hc, hc_ref, device) -> float:
    """Phase 5: kernel vs plain over the sweep, with per-shape times.
    Returns the largest absolute error of the integer-valued checks."""
    rng = np.random.default_rng(SEED + 5)
    worst = 0.0
    for n in HC_NS:
        for buckets in HC_BUCKETS:
            for d in HC_DS:
                keys, vals, valid = _hc_inputs(torch, rng, n, buckets, d,
                                               device)
                label = f"N={n} B={buckets} D={d}"
                got = hc.combine(keys, vals, buckets, valid)
                want = hc_ref(keys, vals, buckets, valid)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                worst = max(worst, err)
                if not torch.equal(got, want):
                    raise AssertionError(f"hash_combine != plain version "
                                         f"(integer values): {label}, max "
                                         f"|err| {err}")
                real = torch.rand(vals.shape, device=device)
                got_r = hc.combine(keys, real, buckets, valid)
                want_r = hc_ref(keys, real, buckets, valid)
                torch.testing.assert_close(got_r, want_r, rtol=1e-4,
                                           atol=1e-4)
                err_r = float((got_r - want_r).abs().max())
                rel_r = float(((got_r - want_r).abs()
                               / want_r.abs().clamp(min=1.0)).max())
                half = real.to(torch.bfloat16)
                got_h = hc.combine(keys, half, buckets, valid)
                want_h = hc_ref(keys, half, buckets, valid)
                if got_h.dtype != torch.bfloat16:
                    raise AssertionError(f"{label}: bf16 in, "
                                         f"{got_h.dtype} out")
                torch.testing.assert_close(got_h.float(), want_h.float(),
                                           rtol=2e-2, atol=1e-2)
                err_h = float((got_h.float() - want_h.float()).abs().max())
                t = _hc_times(torch, hc, hc_ref, keys, vals, valid, buckets)
                print(f"hash_combine {label}: integer bit-identical; real "
                      f"max |err| {err_r:.3g} (rel {rel_r:.3g}); bf16 max "
                      f"|err| {err_h:.3g}; kernel {t['ms']:.4f} ms per "
                      f"wrapper call (device time {t['device']}), plain "
                      f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} "
                      f"ms ({t['bound_by']}), library "
                      f"{t['library_ms']:.4f} ms", flush=True)
                del keys, vals, valid, real, half
    return worst


def phase_hash_combine_main_shape(torch, hc, hc_ref, wc, shards_dev) -> dict:
    """Phase 6a: the kernel at the main path's shape (2**28 records,
    D = 1, B = 1000), bit-identical to the plain version, with the times
    the kernels line reports."""
    from repro_torch.core.mapreduce import wordcount_map_factory
    from repro_torch.engine.plan import map_shards
    keys, vals, valid = map_shards(shards_dev,
                                   wordcount_map_factory(wc.VOCAB),
                                   shards_dev.shape[0])
    got = hc.combine(keys, vals, wc.VOCAB, valid)
    want = hc_ref(keys, vals, wc.VOCAB, valid)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("hash_combine != plain version at the main "
                             "path's shape")
    t = _hc_times(torch, hc, hc_ref, keys, vals, valid, wc.VOCAB)
    print(f"hash_combine main-path shape N={keys.numel()} B={wc.VOCAB} "
          f"D=1: bit-identical; kernel {t['ms']:.4f} ms per wrapper call "
          f"(device time {t['device']}, torch.profiler), plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}), bincount {t['library_ms']:.4f} ms",
          flush=True)
    return {"max_abs_err": float((got - want).abs().max()), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}


def _timed_run(torch, built, data) -> tuple[float, object]:
    """Host wall time of one ``built.run(data)``, ending in a
    synchronise, and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = built.run(data)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def phase_wordcount(torch, hc, wc, shards) -> tuple:
    """Phase 6b: wordcount-hibench-large end to end on the card.  Returns
    hash_combine's launches during the run, the counts (on the host) and
    the median wall of the runs from device-resident shards."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = shards.shape[0] * shards.shape[1]
    t0 = time.perf_counter()
    oracle = wc.oracle(shards)
    print(f"wordcount: oracle (np.bincount over {n} tokens) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    built = wc.pipeline(shards).build(num_buckets=wc.VOCAB,
                                      n_workers=shards.shape[0],
                                      device="cuda", job_id=wc.NAME)
    hc.combine.launches = 0
    wall, (counts, stats) = _timed_run(torch, built, None)
    launches = hc.combine.launches
    if launches != 1:
        raise AssertionError(f"hash_combine launched {launches} times in "
                             f"one batch run; the design launches it once")
    got = counts.cpu().numpy()
    if got.shape != (wc.VOCAB,) or not np.array_equal(got, oracle):
        bad = np.flatnonzero(got[:wc.VOCAB] != oracle)[:4]
        raise AssertionError(f"word counts differ from the oracle at "
                             f"{bad.tolist()} (shape {got.shape})")
    if int(stats.sent) != n or int(stats.dropped) != 0:
        raise AssertionError(f"stats sent={int(stats.sent)} "
                             f"dropped={int(stats.dropped)} for {n} tokens")
    print(f"main-path {wc.NAME}: {n} tokens in {wall:.4f} s = "
          f"{n / wall:.0f} tokens/s (first run, shards handed over from the "
          f"host); {launches} hash_combine launch; counts == np.bincount "
          f"oracle for all {wc.VOCAB} words (min {int(oracle.min())}, max "
          f"{int(oracle.max())})", flush=True)
    walls = [wall] + [_timed_run(torch, built, None)[0] for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shards_dev = torch.from_numpy(shards).to(built.device)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    dev_walls = []
    for _ in range(3):
        dwall, (counts2, _) = _timed_run(torch, built, shards_dev)
        dev_walls.append(dwall)
        if not torch.equal(counts2, counts):
            raise AssertionError("a run on device-resident shards gave "
                                 "other counts")
    med = statistics.median(walls)
    print(f"main-path {wc.NAME} walls from host shards "
          f"{[round(w, 4) for w in walls]} s (median {med:.4f} s = "
          f"{n / med:.0f} tokens/s); the {shards.nbytes} B host-to-device "
          f"copy alone {copy_s:.4f} s = {100 * copy_s / med:.1f}% of the "
          f"median; walls from device-resident shards "
          f"{[round(w, 4) for w in dev_walls]} s", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall2, _ = _timed_run(torch, built, shards_dev)
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA]
    kernel_us = sum(_device_us(ev) for ev in events
                    if any(k in ev.key for k in HC_KERNELS))
    device_us = sum(_device_us(ev) for ev in events)
    print(f"main-path {wc.NAME} profiled run on device-resident shards: "
          f"wall {wall2:.4f} s; hash_combine kernels {kernel_us / 1e3:.3f} "
          f"ms = {100 * kernel_us / 1e6 / med:.2f}% of the median wall "
          f"from host shards; all device work {device_us / 1e3:.3f} ms = "
          f"{100 * device_us / 1e6 / wall2:.1f}% of this run's wall",
          flush=True)
    for ev in sorted(events, key=_device_us, reverse=True)[:8]:
        print(f"  device {_device_us(ev) / 1e3:9.3f} ms  {ev.key[:90]}")
    return launches, counts.cpu(), statistics.median(dev_walls)


def phase_hashed(torch, hc, wc) -> None:
    """Phase 7: hashed key space with exact collision accounting, card
    against CPU."""
    shards = wc.token_shards(SEED + 7, n_tokens=HASHED["n_tokens"],
                             vocab=HASHED["vocab"])
    out = {}
    for device in ("cuda", "cpu"):
        before = hc.combine.launches
        built = wc.pipeline(shards, vocab=HASHED["vocab"]).build(
            num_buckets=HASHED["buckets"], n_workers=shards.shape[0],
            key_space="hashed", device=device)
        counts, stats = built.run()
        out[device] = (counts.cpu(), int(stats.sent),
                       stats.bucket_collisions.cpu())
        print(f"hashed on {device}: {HASHED['n_tokens']} tokens over "
              f"{HASHED['vocab']} ids into {HASHED['buckets']} buckets, "
              f"{int(stats.collisions)} colliding ids, "
              f"{hc.combine.launches - before} hash_combine launches",
              flush=True)
    (gc, gs, gcol), (cc, cs, ccol) = out["cuda"], out["cpu"]
    if not (torch.equal(gc, cc) and gs == cs and torch.equal(gcol, ccol)):
        raise AssertionError("hashed word count differs between cuda and "
                             "cpu")
    if int(gcol.sum()) == 0:
        raise AssertionError("hashed phase exercised no collisions")
    print("hashed: counts, sent and per-bucket collisions equal between "
          "device='cuda' and device='cpu'")


def _kernel_us(torch, fn, names, reps=FA_REPS) -> tuple:
    """Device time per ``fn()`` call of the named kernels, each launched
    once a call, from torch.profiler's CPU and CUDA trace: the mean
    duration of each kernel's records, summed over the kernels, and the
    records it holds (the trace may miss a launch's record at the edge of
    the window); (None, 0) when the trace holds no device time for one of
    them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_name = {}
    for ev in prof.key_averages():
        for n in names:
            if n in ev.key and ev.count:
                count, total = per_name.get(n, (0, 0.0))
                per_name[n] = (count + ev.count, total + _device_us(ev))
    if set(per_name) != set(names) or \
            any(t <= 0 for _, t in per_name.values()):
        return None, 0
    return (sum(t / c for c, t in per_name.values()),
            sum(c for c, _ in per_name.values()))


def _device_us_per_call(torch, fn, names, reps=FA_REPS) -> str:
    """``_kernel_us`` as text: the time and the records it rests on, or
    "not measured"."""
    us, records = _kernel_us(torch, fn, names, reps)
    if us is None:
        return "not measured"
    return f"{us:.2f} us ({records} of {reps * len(names)} records)"


def _profile_step(torch, fn, label) -> None:
    """One call of ``fn`` under torch.profiler: its host wall, the device
    time of all its kernels, their count, and the largest by device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA]
    device_us = sum(_device_us(ev) for ev in events)
    kernels = sum(ev.count for ev in events)
    print(f"{label} under torch.profiler: wall {wall * 1e3:.3f} ms, device "
          f"work {device_us / 1e3:.3f} ms = {100 * device_us / 1e6 / wall:.1f}"
          f"% busy, {kernels} kernels", flush=True)
    for ev in sorted(events, key=_device_us, reverse=True)[:6]:
        print(f"  device {_device_us(ev) / 1e3:9.3f} ms  x{ev.count:<5d} "
              f"{ev.key[:80]}")
    return events


def _fa_tensors(torch, rng, shapes, dtype, device):
    """Standard-normal card tensors of ``shapes`` from the numpy seed."""
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(device, getattr(torch, dtype)) for s in shapes]


def _live_keys(sq, skv, causal, window) -> np.ndarray:
    """Live keys per query row of the forward mask (query i and key j both
    count from 0)."""
    i = np.arange(sq, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = np.minimum(skv, i + 1) if causal else np.full_like(i, skv)
    return np.maximum(hi - lo, 0)


def _peak(dtype: str) -> float:
    return BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S


def _fa_bound_ms(q, k, causal, window, dtype) -> tuple[float, str]:
    """Least time for one forward call on these shapes: q, k, v read and o
    written once over HBM bandwidth, against 4·D operations (Q K^T and
    P V) per live (query, key) pair of every q head over the dtype's peak
    (bf16 tensor cores, or float32 outside them)."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    pairs = int(_live_keys(sq, skv, causal, window).sum()) * b * hq
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, 4 * d * pairs / _peak(dtype)
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def _fd_live(lengths, s_max, window) -> np.ndarray:
    lens = np.asarray(lengths, np.int64)
    lo = np.maximum(0, lens - window) if window else np.zeros_like(lens)
    return np.maximum(np.minimum(lens, s_max) - lo, 0)


def _fd_bound_ms(q, kc, lengths, window, dtype) -> tuple[float, str]:
    """Least time for one decode call on these inputs: each row's live
    cache positions of K and V read once, q read and o written once, the
    lengths read once; against 4·D operations per live key of every q
    head."""
    b, hq, d = q.shape
    hkv, s_max = kc.shape[1], kc.shape[2]
    live = int(_fd_live(lengths, s_max, window).sum())
    esize = q.element_size()
    nbytes = 2 * live * hkv * d * esize + 2 * q.numel() * esize + 4 * b
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, 4 * d * live * hq / _peak(
        dtype)
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def _sdpa_forward(torch, q, k, v, causal, window, scale):
    """One ``scaled_dot_product_attention`` call for the same mask (no
    softcap: it has none).  Not used by the port."""
    import torch.nn.functional as F
    sq, skv = q.shape[2], k.shape[2]
    mask = None
    if window:
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(skv, device=q.device)[None, :]
        mask = qp - kp < window
        if causal:
            mask &= qp >= kp
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        scale=scale, enable_gqa=True)


def _sdpa_decode(torch, q, kc, vc, lengths, window, scale):
    """One ``scaled_dot_product_attention`` call over the whole caches
    with each row's live range as a boolean mask.  Not used by the port."""
    import torch.nn.functional as F
    kp = torch.arange(kc.shape[2], device=q.device)[None, :]
    lens = lengths.long()[:, None]
    mask = kp < lens
    if window:
        mask &= kp >= lens - window
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=mask, scale=scale, enable_gqa=True)


def _errors(torch, got, want, tol) -> dict:
    """Max |err|, relative L2 error ``||got - want|| / ||want||`` and the
    RMS of ``want``, and whether ``got`` is finite and lies within ``tol``
    = (atol, rtol, relative L2) of ``want``, element by element and as a
    whole."""
    atol, rtol, rel_l2 = tol
    g, w = got.float(), want.float()
    err = (g - w).abs()
    norm, err_norm = float(w.norm()), float(err.norm())
    out = {"max": float(err.max()) if err.numel() else 0.0,
           "rel_l2": err_norm / norm if norm > 0 else err_norm,
           "rms": norm / max(w.numel(), 1) ** 0.5}
    out["ok"] = (bool(torch.isfinite(g).all())
                 and not bool((err > atol + rtol * w.abs()).any())
                 and out["rel_l2"] <= rel_l2)
    return out


def _held(torch, got, want, faults, tol, label, *, must_reject) -> tuple:
    """The kernel's output against the plain version's, and the plain
    version with each planted fault (``faults``: what was planted -> that
    output) against the same: the tolerance must pass the kernel and
    (where ``must_reject``) reject every fault.  Returns the kernel's error
    summary and each fault's."""
    e = _errors(torch, got, want, tol)
    if not e["ok"]:
        raise AssertionError(f"{label}: kernel != plain version, max |err| "
                             f"{e['max']:.3g}, relative L2 "
                             f"{e['rel_l2']:.3g} (atol, rtol, relative L2 = "
                             f"{tol})")
    fs = {}
    for what, faulty in faults.items():
        f = fs[what] = _errors(torch, faulty, want, tol)
        if must_reject and f["ok"]:
            raise AssertionError(f"{label}: the tolerance {tol} passes the "
                                 f"planted fault ({what}: max |err| "
                                 f"{f['max']:.3g}, relative L2 "
                                 f"{f['rel_l2']:.3g})")
    return e, fs


def _err_text(e, fs, tol) -> str:
    text = (f"max |err| {e['max']:.3g}, relative L2 {e['rel_l2']:.3g} at "
            f"RMS |want| {e['rms']:.3g} (atol {tol[0]} + rtol {tol[1]}, "
            f"relative L2 {tol[2]})")
    for what, f in fs.items():
        text += (f"; planted fault, {what}: {f['max']:.3g} / "
                 f"{f['rel_l2']:.3g} "
                 f"{'rejected' if not f['ok'] else 'PASSES'}")
    return text


def _fa_faults(torch, fa, fa_ref, q, k, v, kw) -> dict:
    """The plain version with a planted fault each, as a kernel with that
    fault would compute, with fwd_wgmma's tile as its library reports it
    (where fwd_rows runs: 128-row q tiles, ``FAULT_TILE`` keys, two slots):

    * a skipped V tile: V's ``FAULT_TILE`` keys at the middle zeroed (a
      tile left out of P V);
    * a stale slot: the middle key tile j's K and V replaced by those of
      tile j - stages, which its ring slot held before (a consumer that
      read the slot before its full barrier completed; zeros where j is
      one of the first tiles);
    * a dropped diagonal tile: each q tile without its last live key tile
      (the loop one tile short; rows left with no key give 0)."""
    sq, skv, d = q.shape[2], k.shape[2], q.shape[3]
    rows, keys, stages = fa.forward_tile(q.dtype, d) or (128, FAULT_TILE, 2)
    t0 = (skv // 2) // FAULT_TILE * FAULT_TILE
    v_zero = v.clone()
    v_zero[:, :, t0:t0 + FAULT_TILE] = 0
    j = (skv // 2) // keys
    src = (j - stages) * keys
    k_stale, v_stale = k.clone(), v.clone()
    for x, stale in ((k, k_stale), (v, v_stale)):
        dst = stale[:, :, j * keys:(j + 1) * keys]
        dst.copy_(x[:, :, src:src + dst.shape[2]] if src >= 0
                  else torch.zeros_like(dst))
    dropped = torch.empty_like(q)
    for q0 in range(0, sq, rows):
        hi = min(skv, q0 + rows) if kw["causal"] else skv
        cut = max(0, (hi - 1) // keys * keys)
        dropped[:, :, q0:q0 + rows] = fa_ref(
            q[:, :, q0:q0 + rows], k[:, :, :cut], v[:, :, :cut], q_offset=q0,
            **kw)
    return {f"V tile [{t0}, {t0 + FAULT_TILE}) zeroed":
            fa_ref(q, k, v_zero, **kw),
            f"stale slot (tile {j} of {keys} keys read as "
            f"{f'tile {src // keys}' if src >= 0 else 'zeros'})":
            fa_ref(q, k_stale, v_stale, **kw),
            f"dropped diagonal tile (each {rows}-row q tile's last live "
            f"{keys}-key tile)": dropped}


def _fa_case(torch, fa, fa_ref, q, k, v, causal, window, cap, dtype, label,
             *, timed, must_reject=True, reps=FA_REPS) -> dict:
    """Forward kernel vs plain on (q, k, v): the error, the planted faults
    (``_fa_faults``) and the times.  Plain and library times only where
    ``timed``."""
    kw = dict(causal=causal, window=window, softcap=cap)
    tol = FA_TOL[dtype]
    e, fs = _held(torch, fa.attention(q, k, v, **kw), fa_ref(q, k, v, **kw),
                  _fa_faults(torch, fa, fa_ref, q, k, v, kw), tol, label,
                  must_reject=must_reject)
    ms = _median_ms(lambda: fa.attention(q, k, v, **kw), reps=reps)
    plain_ms = lib_ms = None
    if timed:
        plain_ms = _median_ms(lambda: fa_ref(q, k, v, **kw), reps=reps,
                              warmup=1)
        lib_ms = _median_ms(_sdpa_forward(torch, q, k, v, causal, window,
                                          q.shape[-1] ** -0.5), reps=reps)
    name = fa.forward_kernel(q.dtype, q.shape[-1])
    device_us = _device_us_per_call(
        torch, lambda: fa.attention(q, k, v, **kw), (name,), reps)
    bound, by = _fa_bound_ms(q, k, causal, window, dtype)
    print(f"flash-fwd {label}: {_err_text(e, fs, tol)}; {name} {ms:.4f} ms "
          f"per wrapper call (device time {device_us}), bound {bound:.4f} "
          f"ms ({by}), {_plain_text(plain_ms, lib_ms)}", flush=True)
    return {"max_abs_err": e["max"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


def _plain_text(plain_ms, lib_ms) -> str:
    if plain_ms is None:
        return "plain and sdpa timed at the main path's shapes only"
    return f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms"


def _main_shape(b, hq, hkv, s, d) -> bool:
    """The Gemma 2 9B main path's attention shape (B = 1, 16 q heads, 8 kv
    heads, head_dim 256, the prompt's length or more)."""
    return (b, hq, hkv, d) == (1, 16, 8, 256) and s >= GEMMA["prompt"]


def wgmma_build_report(torch, build, fa) -> None:
    """Phase 1: ptxas's registers and spill bytes for fwd_wgmma at each
    head dim it takes, from the build's report, and how many of ptxas's
    lines say it serialised wgmma instructions; a spill fails the run."""
    log = build.build_log("flash_attention")
    want = [d for d in range(1, fa.MAX_HEAD_DIM + 1)
            if fa.forward_tile(torch.bfloat16, d)]
    found = {}
    for fn, usage in build.ptxas_usage(log).items():
        head_dim = re.search(r"fwd_wgmmaILi(\d+)E", fn)
        if head_dim:
            found[int(head_dim.group(1))] = usage
    if sorted(found) != want:
        raise AssertionError(f"ptxas reported fwd_wgmma at head dims "
                             f"{sorted(found)}, want {want}")
    serialized = sum("serialized" in line for line in log.splitlines())
    for d, usage in sorted(found.items()):
        rows, keys, stages = fa.forward_tile(torch.bfloat16, d)
        print(f"ptxas: fwd_wgmma<{d}> ({rows}-row q tiles, {keys}-key K/V "
              f"tiles, {stages} ring slots) {usage.get('registers')} "
              f"registers, "
              f"{usage.get('spill_stores')} bytes spill stores, "
              f"{usage.get('spill_loads')} bytes spill loads", flush=True)
        if usage.get("spill_stores") != 0 or usage.get("spill_loads") != 0:
            raise AssertionError(f"fwd_wgmma<{d}> spills: {usage}")
    print(f"ptxas: {serialized} lines on wgmma instructions serialised",
          flush=True)


def scan_build_report(torch, build, sc) -> None:
    """Phase 1: ptxas's registers and spill bytes for every scan_fwd
    instantiation (float32 and bfloat16, cp.async pieces and plain loads),
    the chunk geometry the library reports and the blocks an SM takes; a
    spill, or fewer than two blocks an SM, fails the run."""
    found = {}
    for fn, usage in build.ptxas_usage(build.build_log("mamba_scan")).items():
        inst = re.search(r"scan_fwdI(f|13__nv_bfloat16)Lb([01])E", fn)
        if inst:
            found[("float32" if inst.group(1) == "f" else "bfloat16",
                   "cp.async" if inst.group(2) == "1" else "plain loads")] = \
                usage
    if len(found) != 4:
        raise AssertionError(f"ptxas reported scan_fwd instantiations "
                             f"{sorted(found)}, want 4")
    channels, items, chunk = sc.scan_tile()
    for (dtype, path), usage in sorted(found.items()):
        print(f"ptxas: scan_fwd<{dtype}, {path}> ({channels} channels a "
              f"block, {items} steps a lane, {chunk}-step chunks) "
              f"{usage.get('registers')} registers, "
              f"{usage.get('spill_stores')} bytes spill stores, "
              f"{usage.get('spill_loads')} bytes spill loads", flush=True)
        if usage.get("spill_stores") != 0 or usage.get("spill_loads") != 0:
            raise AssertionError(f"scan_fwd<{dtype}, {path}> spills: {usage}")
    for dtype in (torch.float32, torch.bfloat16):
        blocks = sc.blocks_per_sm(dtype)
        print(f"scan_fwd at {str(dtype).split('.')[-1]}: {blocks} blocks an "
              f"SM", flush=True)
        if blocks < 2:
            raise AssertionError(f"scan_fwd fits {blocks} block(s) an SM at "
                                 f"{dtype}, want 2")


def decode_build_report(build) -> None:
    """Phase 1: ptxas's registers, stack frame and spill bytes for every
    decode_cluster instantiation (float32 and bfloat16, 1, 2, 4 or 8
    dimensions a lane, GQA groups up to 1, 2, 4 or 8); a spill or a stack
    frame (an array in local memory on the hot path) fails the run."""
    found = {}
    for fn, usage in build.ptxas_usage(
            build.build_log("flash_attention")).items():
        inst = re.search(r"decode_clusterI(f|13__nv_bfloat16)Li(\d)ELi(\d)E",
                         fn)
        if inst:
            found[("float32" if inst.group(1) == "f" else "bfloat16",
                   int(inst.group(2)), int(inst.group(3)))] = usage
    if len(found) != 32:
        raise AssertionError(f"ptxas reported decode_cluster instantiations "
                             f"{sorted(found)}, want 32")
    for (dtype, epl, group), usage in sorted(found.items()):
        print(f"ptxas: decode_cluster<{dtype}, {epl} dims a lane, group <= "
              f"{group}> {usage.get('registers')} registers, "
              f"{usage.get('stack_frame')} bytes stack frame, "
              f"{usage.get('spill_stores')} bytes spill stores, "
              f"{usage.get('spill_loads')} bytes spill loads", flush=True)
        if any(usage.get(k) != 0 for k in ("stack_frame", "spill_stores",
                                           "spill_loads")):
            raise AssertionError(f"decode_cluster<{dtype}, {epl}, {group}> "
                                 f"uses local memory: {usage}")


def phase_flash_forward(torch, fa, fa_ref, device) -> float:
    """Phase 8: the forward kernel vs its plain version over the sweep.
    Returns the largest absolute error."""
    rng = np.random.default_rng(SEED + 8)
    worst = 0.0
    for b, hq, hkv, sq, skv, d, causal, window, cap, dtype in FA_CASES:
        q, k, v = _fa_tensors(torch, rng, [(b, hq, sq, d), (b, hkv, skv, d),
                                           (b, hkv, skv, d)], dtype, device)
        label = (f"B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} D={d} "
                 f"causal={causal} window={window} softcap={cap} {dtype}")
        worst = max(worst, _fa_case(
            torch, fa, fa_ref, q, k, v, causal, window, cap, dtype, label,
            timed=_main_shape(b, hq, hkv, sq, d))["max_abs_err"])
        del q, k, v
    return worst


def _fd_tiles(length, s_max, window, geometry) -> list:
    """Row ``length``'s live keys as the decode kernel cuts them at its
    geometry (cluster, keys a tile, slots): per rank of the cluster, its
    tiles as (first key, keys)."""
    cluster, keys, _ = geometry
    lo = max(0, length - window) if window else 0
    live = max(min(length, s_max) - lo, 0)
    per = -(-live // cluster)
    ranks = []
    for r in range(cluster):
        r0 = lo + r * per
        n = max(0, min(lo + live, r0 + per) - r0)
        ranks.append([(k0, min(keys, r0 + n - k0))
                      for k0 in range(r0, r0 + n, keys)])
    return ranks


def _fd_faults(torch, fd_ref, q, kc, vc, lengths, kw, geometry) -> dict:
    """The plain version with a planted fault each in row 0, as a kernel
    with that fault would compute it at the library's geometry, each
    planted only where it changes the output (the faulty row is attention
    over the key list the fault leaves, in the list's order):

    * a rank dropped: rank 1's partial (rank 0's where the cluster is one
      block) left out of the merge;
    * a stale slot: rank 0's tile ``slots`` read from its slot's previous
      tile, tile 0 (a consumer that read before the full barrier);
    * ragged tails dropped: every rank's last tile, where it is shorter
      than a tile, left out."""
    cluster, keys, slots = geometry
    ranks = _fd_tiles(int(lengths[0]), kc.shape[2], kw["window"], geometry)

    def rows(tiles):
        return [k for k0, nk in tiles for k in range(k0, k0 + nk)]

    every = [rows(t) for t in ranks]
    lists = {}
    r = 1 if cluster > 1 else 0
    if every[r]:
        lists[f"rank {r} of {cluster} dropped (keys [{every[r][0]}, "
              f"{every[r][-1] + 1}))"] = [
            k for i, ks in enumerate(every) if i != r for k in ks]
    if len(ranks[0]) > slots:
        (s0, _), (st, nt) = ranks[0][0], ranks[0][slots]
        lists[f"stale slot (keys [{st}, {st + nt}) read as [{s0}, "
              f"{s0 + nt}), {slots} slots of {keys} keys)"] = (
            rows(ranks[0][:slots]) + list(range(s0, s0 + nt))
            + rows(ranks[0][slots + 1:]) + [k for ks in every[1:] for k in ks])
    tails = [t[-1] for t in ranks if t and t[-1][1] < keys]
    if tails:
        cut = {k for k0, nk in tails for k in range(k0, k0 + nk)}
        lists[f"ragged tails dropped ({len(tails)} of {cluster} ranks, "
              f"{len(cut)} keys)"] = [k for ks in every for k in ks
                                      if k not in cut]
    base = fd_ref(q, kc, vc, lengths, **kw)
    faults = {}
    for what, idx in lists.items():
        faulty = base.clone()
        faulty[0] = 0
        if idx:
            ii = torch.tensor(idx, device=kc.device)
            faulty[0] = fd_ref(q[:1], kc[:1, :, ii], vc[:1, :, ii],
                               torch.tensor([len(idx)], dtype=torch.int32,
                                            device=q.device),
                               softcap=kw["softcap"])[0]
        faults[what] = faulty
    return faults


def _host_ms(torch, fn, reps: int = REPS) -> float:
    """Host time per ``fn()`` call, without waiting for the device: what
    the wrapper costs the caller (checks, the ctypes call, the launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * host / reps


def _fd_repeat(torch, fa, q, kc, vc, lengths, kw, cluster, want, tol,
               label) -> str:
    """Three calls bit for bit equal, the last two after a call at another
    cluster size (held to the same tolerance: only the order of the sums
    moves)."""
    first = fa.decode_attention(q, kc, vc, lengths, **kw)
    other = 2 if cluster == 1 else 1
    moved = fa._decode_cuda(q, kc, vc, lengths, kw["window"], kw["softcap"],
                            q.shape[-1] ** -0.5, cluster=other)
    again = [fa.decode_attention(q, kc, vc, lengths, **kw) for _ in range(2)]
    if not all(torch.equal(first, a) for a in again):
        raise AssertionError(f"{label}: repeat calls differ after a call at "
                             f"cluster size {other}")
    e = _errors(torch, moved, want, tol)
    if not e["ok"]:
        raise AssertionError(f"{label}: at cluster size {other} max |err| "
                             f"{e['max']:.3g}, relative L2 {e['rel_l2']:.3g}")
    return (f"3 calls equal bit for bit (the last two after one at cluster "
            f"size {other}, max |err| {e['max']:.3g} there)")


def _fd_case(torch, fa, fd_ref, q, kc, vc, lengths, window, cap, dtype,
             label, *, timed, must_reject=True, reps=FA_REPS) -> dict:
    """Decode kernel vs plain on these inputs: the error, the planted
    faults (``_fd_faults``), repeat calls, and the times (the wrapper's
    with CUDA events and on the host, the kernel's device time).  Plain
    and library times, and the kernel's device time at cluster sizes 8
    and 16, only where ``timed``."""
    kw = dict(window=window, softcap=cap)
    tol = FD_TOL[dtype]
    lens = lengths.cpu().numpy()
    s_max = kc.shape[2]
    geometry = fa.decode_geometry(q, kc)
    want = fd_ref(q, kc, vc, lengths, **kw)
    e, fs = _held(torch, fa.decode_attention(q, kc, vc, lengths, **kw), want,
                  _fd_faults(torch, fd_ref, q, kc, vc, lengths, kw, geometry),
                  tol, label, must_reject=must_reject)
    repeat = _fd_repeat(torch, fa, q, kc, vc, lengths, kw, geometry[0], want,
                        tol, label)
    call = lambda: fa.decode_attention(q, kc, vc, lengths, **kw)  # noqa: E731
    ms = _median_ms(call, reps=reps)
    host = _host_ms(torch, call)
    plain_ms = lib_ms = None
    sizes = ""
    if timed:
        plain_ms = _median_ms(lambda: fd_ref(q, kc, vc, lengths, **kw),
                              reps=reps, warmup=1)
        lib_ms = _median_ms(_sdpa_decode(torch, q, kc, vc, lengths, window,
                                         q.shape[-1] ** -0.5), reps=reps)
        for c in (8, 16):
            try:
                us, _ = _kernel_us(torch, lambda: fa._decode_cuda(
                    q, kc, vc, lengths, window, cap, q.shape[-1] ** -0.5,
                    cluster=c), FD_KERNELS, reps)
                sizes += (f"; at cluster size {c} "
                          f"{'not measured' if us is None else f'{us:.2f} us'}")
            except RuntimeError as err:
                sizes += f"; cluster size {c} refused ({err})"
    us, records = _kernel_us(torch, call, FD_KERNELS, reps)
    bound, by = _fd_bound_ms(q, kc, lens, window, dtype)
    print(f"flash-decode {label}: {_err_text(e, fs, tol)}; {repeat}; "
          f"geometry (cluster, keys a tile, slots) {geometry}; "
          f"decode_cluster {ms:.4f} ms per wrapper call, host "
          f"{host:.4f} ms per call, device time "
          f"{'not measured' if us is None else f'{us:.2f} us'} ({records} "
          f"of {reps} records){sizes}; bound {bound:.4f} ms ({by}; "
          f"{int(_fd_live(lens, s_max, window).sum())} live keys), "
          f"{_plain_text(plain_ms, lib_ms)}", flush=True)
    return {"max_abs_err": e["max"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "device_us": us, "host_ms": host}


def _fd_caches(torch, rng, b, hkv, s_max, d, dtype, shift, device):
    """Standard-normal K and V caches (b, hkv, s_max, d) whose data start
    ``shift`` bytes past a 16-byte boundary (views into a larger tensor)."""
    n = b * hkv * s_max * d
    out = []
    for _ in range(2):
        flat = _fa_tensors(torch, rng, [(n + 16,)], dtype, device)[0]
        off = shift // flat.element_size()
        out.append(flat[off:off + n].view(b, hkv, s_max, d))
        if out[-1].data_ptr() % 16 != shift:
            raise AssertionError(f"cache at byte {out[-1].data_ptr() % 16}"
                                 f" of 16, want {shift}")
    return out


def phase_flash_decode(torch, fa, fd_ref, device) -> float:
    """Phase 9: the decode kernel vs its plain version over the sweep.
    Returns the largest absolute error."""
    rng = np.random.default_rng(SEED + 9)
    worst = 0.0
    for b, hq, hkv, s_max, d, window, cap, dtype, shift in FD_CASES:
        q = _fa_tensors(torch, rng, [(b, hq, d)], dtype, device)[0]
        kc, vc = _fd_caches(torch, rng, b, hkv, s_max, d, dtype, shift,
                            device)
        lens = rng.integers(1, s_max + 1, b)
        lens[0] = s_max
        lens[-1] = 1 if b > 1 else lens[-1]
        lengths = torch.from_numpy(lens.astype(np.int32)).to(device)
        label = (f"B={b} Hq={hq} Hkv={hkv} S_max={s_max} D={d} lengths "
                 f"{lens.tolist()} window={window} softcap={cap} {dtype}"
                 + (f" caches at byte {shift} of 16" if shift else ""))
        main = _main_shape(b, hq, hkv, s_max, d)
        out = _fd_case(torch, fa, fd_ref, q, kc, vc, lengths, window, cap,
                       dtype, label, timed=main)
        worst = max(worst, out["max_abs_err"])
        if main:
            # the wrapper allocates the output and nothing else
            before = torch.cuda.memory_stats()["allocation.all.allocated"]
            fa.decode_attention(q, kc, vc, lengths, window=window,
                                softcap=cap)
            allocs = torch.cuda.memory_stats()["allocation.all.allocated"] \
                - before
            if allocs != 1:
                raise AssertionError(f"flash-decode {label}: {allocs} "
                                     f"allocations a call, want 1 (out)")
            print(f"flash-decode {label}: 1 allocation a call (the output)",
                  flush=True)
        if shift:
            # the same inputs from 16-byte aligned copies of the caches
            ka, va = kc.clone(), vc.clone()
            aligned, _ = _kernel_us(torch, lambda: fa.decode_attention(
                q, ka, va, lengths, window=window, softcap=cap), FD_KERNELS)
            ratio = None if aligned is None or out["device_us"] is None \
                else out["device_us"] / aligned
            print(f"flash-decode {label}: device time "
                  f"{out['device_us']} us against {aligned} us from aligned "
                  f"copies of the caches (x{ratio})", flush=True)
            if ratio is not None and ratio > 3:
                raise AssertionError(f"flash-decode {label}: {ratio:.2f}x "
                                     f"the aligned caches' device time")
            del ka, va
        del q, kc, vc
    # outside the wrapper's contract (lengths >= 1): a row of length 0
    # attends to no key, and the kernel answers 0 as the reference's
    # flash_decode does (its plain version, the mean of V)
    q, kc, vc = _fa_tensors(torch, rng, [(2, 4, 64), (2, 2, 128, 64),
                                         (2, 2, 128, 64)], "float32", device)
    lengths = torch.tensor([0, 5], dtype=torch.int32, device=device)
    for window in (None, 3):
        got = fa.decode_attention(q, kc, vc, lengths, window=window)
        want = fd_ref(q, kc, vc, lengths, window=window)
        if bool(got[0].any()) or not bool(torch.allclose(
                got[1], want[1], rtol=1e-4, atol=1e-4)):
            raise AssertionError(f"flash-decode length-0 row, window "
                                 f"{window}: row 0 {got[0].abs().max()}, "
                                 f"row 1 off by {(got[1] - want[1]).abs().max()}")
    print("flash-decode length-0 row (q (2, 4, 64), caches (2, 2, 128, 64), "
          "lengths [0, 5], window none and 3): the kernel gives 0 for row 0 "
          "as the reference's flash_decode does; row 1 equals the plain "
          "version", flush=True)
    return worst


def _mean_times(a: dict, b: dict) -> dict:
    """Per-launch means over the windowed and the global layer's shapes."""
    out = {key: None if a[key] is None or b[key] is None
           else (a[key] + b[key]) / 2
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    out["max_abs_err"] = max(a["max_abs_err"], b["max_abs_err"])
    out["bound_by"] = a["bound_by"] if a["bound_by"] == b["bound_by"] \
        else "operations" if "operations" in (a["bound_by"], b["bound_by"]) \
        else "bytes"
    return out


def _plain_witness(fa_ref, fd_ref, params, cfg, toks, max_len, probe=None,
                   caches=False):
    """The plain versions in the kernels' places: the last prefill logits
    of ``toks`` and those of decoding its last token after a prefill one
    token shorter (how far the model's own bfloat16 path moves prefill
    from decode without the kernels).  With ``probe`` (an MoE model's
    ``_MoeProbe``) the first prefill's expert choices are recorded, left
    in ``probe.routes``, and replayed in the shorter prefill and the
    decode step, so that both paths route every token alike.  With
    ``caches``, also the two caches: the full prefill's, and the shorter
    prefill's after the decode step."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decode_step, prefill_forward
    calls = attn_mod.attention, attn_mod.decode_attention
    attn_mod.attention, attn_mod.decode_attention = fa_ref, fd_ref
    try:
        if probe:
            probe.record = True
        last, full = prefill_forward(params, toks, cfg, max_len)
        if not caches:
            del full
        if probe:
            probe.record = False
            probe.replay = [r[:-1] for r in probe.routes]
        _, short = prefill_forward(params, toks[:, :-1], cfg, max_len)
        if probe:
            probe.replay = [r[-1:] for r in probe.routes]
        via_decode = decode_step(params, short, toks[:, -1:], cfg)[0]
    finally:
        attn_mod.attention, attn_mod.decode_attention = calls
    if caches:
        return last, via_decode, full, short
    return last, via_decode


def _lm_inputs(torch, cfg, spec, seed, device):
    """A language-model phase's random weights and prompt at ``seed``:
    token ids, or for an embeddings config (1, prompt, d) patch
    embeddings, standard normal times 0.02 (the embed table's scale) in
    the compute dtype."""
    from repro_torch.models import init_params
    params = init_params(seed, cfg, device=device)
    rng = np.random.default_rng(seed + spec["phase"])
    if cfg.input_mode == "embeddings":
        x = rng.standard_normal((1, spec["prompt"], cfg.d_model),
                                dtype=np.float32) * np.float32(0.02)
        return params, torch.from_numpy(x).to(device, cfg.compute_dtype_)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, spec["prompt"]),
                                         dtype=np.int64)).to(device)
    return params, toks


def logit_floor(torch, seeds, device, arch=GEMMA["arch"]) -> None:
    """``--logit-floor``: the plain witness of phase 10 (or, with
    ``--arch``, of phase 22 or 23, at a capacity where nothing drops and
    with the prefill's expert choices replayed, or of phase 25 or 26)
    alone — no kernel is built or run — at each seed, and the element
    excess max(|diff| - rtol |want|) that ``LOGIT_TOL``'s (or
    ``MOE_LOGIT_TOL``'s, ``ZAMBA_LOGIT_TOL``'s, ``EMBED_LOGIT_TOL``'s) atol
    is set from (twice the largest over the
    seeds); for zamba2 also the states' gaps ``ZAMBA_STATE_TOL`` is set
    from (twice the largest)."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention.ref import (chunked_attention,
                                                         decode_ref)
    from repro_torch.models import moe as moe_mod
    spec = {s["arch"]: s for s in (GEMMA, QWEN_MOE, MIXTRAL, ZAMBA,
                                   *EMBED)}[arch]
    if spec is GEMMA:
        cfg, tol = configs.get(arch), LOGIT_TOL
    elif spec is ZAMBA:
        cfg, tol = configs.get(arch), ZAMBA_LOGIT_TOL
    elif spec in EMBED:
        cfg, tol = configs.get(arch), EMBED_LOGIT_TOL[arch]
    else:
        cfg, tol = _no_drop(_moe_config(spec)), MOE_LOGIT_TOL[arch]
    max_len = spec["prompt"] + spec["decode_steps"]
    excess, states = [], []
    for seed in seeds:
        params, toks = _lm_inputs(torch, cfg, spec, seed, device)
        with _MoeProbe(moe_mod) as probe:
            out = _plain_witness(
                chunked_attention, decode_ref, params, cfg, toks, max_len,
                probe if cfg.is_moe else None, caches=spec is ZAMBA)
            drops = sum(probe.take_drops())
        last, via_decode = out[:2]
        if spec is ZAMBA:
            states.append(_zamba_state_gaps(
                torch, f"seed {seed}, plain: {toks.shape[1] - 1}-token "
                f"prefill + one decode step vs {toks.shape[1]}-token "
                f"prefill", out[3], out[2], toks.shape[1] - 1, None, []))
        del params, out
        diff = (via_decode - last).abs()
        over = float((diff - tol["rtol"] * last.abs()).max())
        excess.append(over)
        beyond = int((diff > tol["atol"] + tol["rtol"] * last.abs()).sum())
        print(f"logit floor, {arch}, seed {seed}: plain prefill vs decode "
              f"max |diff| {float(diff.max()):.4g}, relative L2 "
              f"{float(diff.norm() / last.norm()):.4g}, element excess "
              f"max(|diff| - {tol['rtol']} |want|) {over:.4g}, {beyond} "
              f"beyond atol {tol['atol']} + rtol {tol['rtol']}; argmax "
              f"{int(last.argmax())} / {int(via_decode.argmax())}; "
              f"{drops} pairs dropped", flush=True)
        torch.cuda.empty_cache()
    print(f"logit floor, {arch}: largest element excess {max(excess):.4g} "
          f"over seeds {list(seeds)}; twice it {2 * max(excess):.4g}",
          flush=True)
    if states:
        worst = {name: max(g[name] for g in states) for name in states[0]}
        print(f"state floor, {arch}: largest worst-layer relative L2 "
              f"{ {k: float(f'{v:.4g}') for k, v in worst.items()} }; "
              f"twice it { {k: float(f'{2 * v:.4g}') for k, v in worst.items()} }",
              flush=True)


def _lm_main_path(torch, fa, params, toks, cfg, spec, tag, layers) -> dict:
    """A language model's main path as a user drives it: the launch
    counts set to 0, one prefill of ``toks`` and ``spec["decode_steps"]``
    greedy decode steps.  The attention inputs of the first ``layers``
    layers are captured in the prefill and the first decode step, and an
    MoE model's first MoE layer's parameters and input in the prefill;
    the capture wrappers come off before the timed decode steps, which
    run with only the launch counters.  Checks the launches, shapes and
    finite logits and prints the times.  Returns ``last``, the captures
    (``fwd``, ``dec``, ``moe``) and the launch counts."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decode_step, prefill_forward
    from repro_torch.models import transformer as tf_mod

    n, steps = spec["prompt"], spec["decode_steps"]
    max_len = n + steps
    run = {"fwd": [], "dec": [], "moe": []}
    calls = attn_mod.attention, attn_mod.decode_attention, tf_mod.moe_forward
    fwd_call, dec_call, moe_call = calls

    def fwd_capture(q, k, v, **kw):
        if len(run["fwd"]) < layers:
            run["fwd"].append((q, k, v, kw))
        return fwd_call(q, k, v, **kw)

    def dec_capture(q, kc, vc, lengths, **kw):
        if len(run["dec"]) < layers:
            run["dec"].append((q, kc.clone(), vc.clone(), lengths.clone(),
                               kw))
        return dec_call(q, kc, vc, lengths, **kw)

    def moe_capture(p, h, c):
        if not run["moe"]:
            run["moe"].append((p, h))
        return moe_call(p, h, c)

    attn_mod.attention, attn_mod.decode_attention = fwd_capture, dec_capture
    tf_mod.moe_forward = moe_capture
    try:
        fa.attention.launches = 0
        fa.decode_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = prefill_forward(params, toks, cfg, max_len)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        token = last.argmax(dim=-1, keepdim=True)
        t0 = time.perf_counter()
        logits, cache = decode_step(params, cache, token, cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    finally:
        attn_mod.attention, attn_mod.decode_attention, \
            tf_mod.moe_forward = calls
    token = logits.argmax(dim=-1, keepdim=True)
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        logits, cache = decode_step(params, cache, token, cfg)
        token = logits.argmax(dim=-1, keepdim=True)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    fwd_launches = fa.attention.launches
    dec_launches = fa.decode_attention.launches
    peak = torch.cuda.max_memory_allocated()
    calls = _attn_calls(cfg)
    if fwd_launches != calls or dec_launches != calls * steps:
        raise AssertionError(f"{tag}: {fwd_launches} forward and "
                             f"{dec_launches} decode launches, want "
                             f"{calls} and {calls * steps}")
    if not (bool(torch.isfinite(last).all())
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{tag}: non-finite logits")
    if tuple(last.shape) != (1, cfg.vocab) or int(
            cache["lengths"][0]) != max_len:
        raise AssertionError(f"{tag}: logits {tuple(last.shape)}, length "
                             f"{int(cache['lengths'][0])}")
    step_ms = 1e3 * decode_s / (steps - 1)
    bound = ""
    if cfg.is_moe:
        bound_ms = _expert_bytes(cfg) / HBM_BYTES_PER_S * 1e3
        bound = (f" against {bound_ms:.3f} ms to read the routed experts' "
                 f"{_expert_bytes(cfg) / 1e9:.2f} GB once at "
                 f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s "
                 f"({step_ms / bound_ms:.1f}x)")
    print(f"{tag}: first prefill of {n} tokens in {prefill_s:.4f} s = "
          f"{n / prefill_s:.0f} tokens/s; first decode step {first_s:.4f} s "
          f"(both include one-time library and allocator set-up); "
          f"{steps - 1} further decode steps in {decode_s:.4f} s = "
          f"{step_ms:.3f} ms per step (B=1, cache {n + 1}-{max_len - 1})"
          f"{bound}; {fwd_launches} flash forward and {dec_launches} flash "
          f"decode launches; peak device memory {peak / 2**30:.2f} GiB",
          flush=True)
    run.update(last=last, fwd_launches=fwd_launches,
               dec_launches=dec_launches)
    return run


def _kernel_cases(torch, fa, fa_ref, fd_ref, run, tag) -> tuple:
    """The attention kernels against their plain versions on the layer
    inputs ``_lm_main_path`` captured (faults reported, not required to
    fail): the forward's and the decode's times, layer by layer."""
    fwd_t, dec_t = [], []
    for layer, (q, k, v, kw) in enumerate(run.pop("fwd")):
        label = (f"{tag} layer {layer} prefill q{tuple(q.shape)} "
                 f"k{tuple(k.shape)} window={kw['window']}")
        fwd_t.append(_fa_case(torch, fa, fa_ref, q.contiguous(),
                              k.contiguous(), v.contiguous(), True,
                              kw["window"], kw["softcap"], "bfloat16", label,
                              timed=True, must_reject=False))
    for layer, (q, kc, vc, lengths, kw) in enumerate(run.pop("dec")):
        label = (f"{tag} layer {layer} decode q{tuple(q.shape)} "
                 f"cache{tuple(kc.shape)} lengths {lengths.tolist()} "
                 f"window={kw['window']}")
        dec_t.append(_fd_case(torch, fa, fd_ref, q.contiguous(), kc, vc,
                              lengths, kw["window"], kw["softcap"],
                              "bfloat16", label, timed=True,
                              must_reject=False))
    return fwd_t, dec_t


def _attn_calls(cfg) -> int:
    """The attention calls of one pass: one a layer, or for zamba2 one a
    call of the shared block."""
    from repro_torch.models.transformer import _shared_attn_positions
    if cfg.layer_kind == "attn":
        return cfg.n_layers
    return len(_shared_attn_positions(cfg))


def _one_decode_kernel_a_layer(torch, events, step, cfg, tag) -> None:
    """A profiled decode step ran exactly one ``decode_cluster`` an
    attention call and no other decode kernel: the decode is one launch a
    call.  torch.profiler drops a record of a trace now and then (it never
    adds one), so while the fullest trace so far holds fewer decode
    records than calls, ``step()`` (the same decode step) is traced
    again, up to three traces in all, and the fullest is checked."""
    calls = _attn_calls(cfg)

    def records(evs) -> dict:
        return {ev.key: ev.count for ev in evs if "decode" in ev.key}

    for _ in range(2):
        held = sum(records(events).values())
        if held >= calls:
            break
        again = _profile_step(torch, step, f"{tag}: the decode step traced "
                              f"again ({held} decode records of {calls})")
        if sum(records(again).values()) > held:
            events = again
    decode_kernels = records(events)
    if len(decode_kernels) != 1 or \
            set(decode_kernels.values()) != {calls} or \
            not any(FD_KERNELS[0] in k for k in decode_kernels):
        raise AssertionError(f"{tag}: one decode step ran the decode "
                             f"kernels {decode_kernels}, want "
                             f"{FD_KERNELS[0]} x {calls}")
    print(f"{tag}: the decode step's profile holds "
          f"{list(decode_kernels.values())[0]} {FD_KERNELS[0]} records (of "
          f"{calls} launches) and no other decode kernel", flush=True)


def _witness_gaps(torch, tag, n, tol, via_decode, last, plain_via,
                  plain_last, plain_dec, failures) -> None:
    """The four logit checks of a model phase: prefill vs decode with the
    kernels and with the plain versions, and kernel vs plain on each
    path."""
    for what, got, want in (
            ("kernels: last prefill logits vs decoding the last token after "
             f"a {n - 1}-token prefill", via_decode, last),
            ("plain versions: the same (the model's own bfloat16 path)",
             plain_via, plain_last),
            (f"prefill of {n} tokens, kernel vs plain", last, plain_last),
            (f"decode step on one {n - 1}-token cache, kernel vs plain",
             via_decode, plain_dec)):
        _logit_gap(torch, tag, what, got, want, tol, failures)


def phase_gemma(torch, fa, fa_ref, fd_ref, device):
    """Phase 10: Gemma 2 9B at full width — prefill, decode, the kernels
    on captured layer inputs, and prefill-then-decode agreement.  Returns
    (params, cfg, forward launches, decode launches, forward times, decode
    times)."""
    from repro_torch import configs
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decode_step, prefill_forward

    cfg = configs.get(GEMMA["arch"])
    windows = attn_mod.window_schedule(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, toks = _lm_inputs(torch, cfg, GEMMA, SEED, device)
    torch.cuda.synchronize()
    print(f"gemma: {cfg.name} at full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_params()} parameters, {cfg.param_dtype}) "
          f"with random weights from seed {SEED} in "
          f"{time.perf_counter() - t0:.1f} s; windows of layers 0-3 "
          f"{windows[:4]}", flush=True)
    n = GEMMA["prompt"]
    max_len = n + GEMMA["decode_steps"]

    # the main path, layers 0 (windowed) and 1 (global) captured, and the
    # kernels on their inputs
    run = _lm_main_path(torch, fa, params, toks, cfg, GEMMA, "gemma", 2)
    last = run["last"]
    fwd_t, dec_t = _kernel_cases(torch, fa, fa_ref, fd_ref, run, "gemma")

    # prefill-then-decode: the last prompt token's logits both ways, the
    # second prefill timed warm, the decode step under the profiler
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, short_cache = prefill_forward(params, toks[:, :-1], cfg, max_len)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"gemma: warm prefill of {n - 1} tokens in {warm_s:.4f} s = "
          f"{(n - 1) / warm_s:.0f} tokens/s", flush=True)
    out = {}
    events = _profile_step(torch, lambda: out.update(
        logits=decode_step(params, short_cache, toks[:, -1:], cfg)[0]),
        f"gemma: one decode step (B=1, cache {n})")
    via_decode = out["logits"]
    _one_decode_kernel_a_layer(
        torch, events, lambda: decode_step(params, short_cache, toks[:, -1:],
                                           cfg), cfg, "gemma")

    # the second witness: the same paths with the plain versions in the
    # kernels' places — kernel vs plain on each path, and how far the
    # model's own bfloat16 path moves prefill from decode without them
    calls = attn_mod.attention, attn_mod.decode_attention
    attn_mod.attention, attn_mod.decode_attention = fa_ref, fd_ref
    try:
        plain_dec = decode_step(params, short_cache, toks[:, -1:], cfg)[0]
    finally:
        attn_mod.attention, attn_mod.decode_attention = calls
    del short_cache
    plain_last, plain_via_decode = _plain_witness(fa_ref, fd_ref, params,
                                                  cfg, toks, max_len)
    failures = []
    _witness_gaps(torch, "gemma", n, LOGIT_TOL, via_decode, last,
                  plain_via_decode, plain_last, plain_dec, failures)
    if failures:
        raise AssertionError("; ".join(failures))
    _profile_step(torch, lambda: prefill_forward(params, toks[:, :-1], cfg,
                                                 max_len),
                  f"gemma: one prefill of {n - 1} tokens")
    return (params, cfg, run["fwd_launches"], run["dec_launches"],
            _mean_times(*fwd_t), _mean_times(*dec_t))


def _serve_requests(torch, params, cfg, device, seed):
    """``BatchedServer`` on ``SERVE``'s requests until it drains: the
    server and the run's numbers (wall, tokens served, batched steps,
    admission steps and seconds)."""
    from repro_torch.launch.serve import BatchedServer, Request
    server = BatchedServer(cfg, params, SERVE["slots"], SERVE["max_len"],
                           device=device)
    rng = np.random.default_rng(seed)
    reqs = [Request(id=i, prompt=rng.integers(0, cfg.vocab, SERVE["prompt"],
                                              dtype=np.int32),
                    max_new=SERVE["max_new"])
            for i in range(SERVE["requests"])]
    for r in reqs:
        server.submit(r)
    admit, run = server._admit, {"admit_s": 0.0, "admit_steps": 0}

    def timed_admit():
        t = time.perf_counter()
        waiting = len(server.queue)
        admit()
        run["admit_steps"] += (waiting - len(server.queue)) * (
            SERVE["prompt"] - 1)
        run["admit_s"] += time.perf_counter() - t

    server._admit = timed_admit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = batched = 0
    while any(server.slots) or server.queue:
        served += server.step()
        batched += 1
        if batched > 10_000:
            raise AssertionError("serving did not drain")
    torch.cuda.synchronize()
    run.update(wall=time.perf_counter() - t0, served=served, batched=batched)
    del server._admit       # the closure held the server in a cycle
    want = SERVE["requests"] * SERVE["max_new"]
    if served != want or not all(r.done and len(r.tokens) == 1 +
                                 SERVE["max_new"] for r in reqs):
        raise AssertionError(f"serving {cfg.name}: {served} tokens served, "
                             f"want {want}")
    return server, run


def _serve_text(cfg, run) -> str:
    steps = run["batched"] + run["admit_steps"]
    return (f"{SERVE['requests']} requests x {SERVE['max_new']} new tokens "
            f"({SERVE['prompt']}-token prompts, {SERVE['slots']} slots, "
            f"max_len {SERVE['max_len']}) at full width: {run['served']} "
            f"tokens in {run['wall']:.3f} s = "
            f"{run['served'] / run['wall']:.1f} tokens/s; {run['batched']} "
            f"batched steps + {run['admit_steps']} admission steps = {steps} "
            f"decode steps ({1e3 * run['wall'] / steps:.1f} ms each); "
            f"admission {run['admit_s']:.3f} s = "
            f"{100 * run['admit_s'] / run['wall']:.1f}% of the wall")


def phase_serving(torch, fa, params, cfg, device) -> None:
    """Phase 11: BatchedServer at full width on ``SERVE``'s requests."""
    fa.attention.launches = 0
    fa.decode_attention.launches = 0
    server, run = _serve_requests(torch, params, cfg, device, SEED + 11)
    fwd, dec = fa.attention.launches, fa.decode_attention.launches
    decode_steps = run["batched"] + run["admit_steps"]
    if dec != cfg.n_layers * decode_steps or fwd != 0:
        raise AssertionError(f"serving: {dec} decode launches for "
                             f"{decode_steps} decode steps, {fwd} forward "
                             f"launches for no prefill")
    _profile_step(torch, lambda: server._admit_step(1, 0),
                  f"serving: one admission step (B={SERVE['slots']})")
    print(f"serving: {_serve_text(cfg, run)}; {dec} flash decode launches "
          f"(= {cfg.n_layers} x {decode_steps}), {fwd} flash forward "
          f"launches", flush=True)


# ---------------------------------------------------------------------------
# Phases 12-14: the Mamba-1 selective scan and Falcon Mamba 7B
# ---------------------------------------------------------------------------

def _scan_inputs(torch, gen, b, length, d, n, dtype, strided, device, *,
                 model_delta=False):
    """u, delta, A, B, C, D on the card from ``gen``.  Δ = |N(0, 1)|·0.1 +
    0.01 and A = -(|N(0, 1)| + 0.5), as the reference's kernel tests draw
    them; ``model_delta`` draws Δ log-uniform in [1e-3, 1e-1] instead, the
    range of Falcon Mamba's initial step, where the state remembers up to
    2,000 steps.  ``strided`` makes B and C column slices of one
    (b, L, SCAN_DT_RANK + 2N) tensor, as the model's x_proj output is."""
    cast = getattr(torch, dtype)
    f = dict(device=device, generator=gen)
    u = torch.randn(b, length, d, **f)
    if model_delta:
        lo, hi = np.log(1e-3), np.log(1e-1)
        delta = torch.exp(torch.rand(b, length, d, **f) * (hi - lo) + lo)
    else:
        delta = torch.randn(b, length, d, **f).abs_().mul_(0.1).add_(0.01)
    a = -(torch.randn(d, n, **f).abs_() + 0.5)
    if strided:
        dbc = torch.randn(b, length, SCAN_DT_RANK + 2 * n, **f).to(cast)
        bm = dbc[..., SCAN_DT_RANK:SCAN_DT_RANK + n]
        cm = dbc[..., SCAN_DT_RANK + n:]
    else:
        bm = torch.randn(b, length, n, **f).to(cast)
        cm = torch.randn(b, length, n, **f).to(cast)
    return u.to(cast), delta.to(cast), a, bm, cm, torch.randn(d, **f)


def _scan_faults(torch, ref, x, want, tile):
    """The plain version with a planted fault each, as a kernel with that
    fault would compute, placed on the kernel's seams as its library reports
    them (``tile`` = channels, steps a lane owns, steps a chunk).  Each is
    planted only where it changes the result:

    * the state zeroed before a step in mid-sequence: a chunk boundary (a
      carry lost between chunks), or L / 2 where L < two chunks;
    * one lane's segment started from zero at a segment boundary inside a
      chunk (a lost warp-scan prefix; the lanes after it are right);
    * every chunk's lanes past the first started from their prefix alone,
      without the carry's decayed term (h_start = h_excl, not P_excl ·
      h_carry + h_excl), so only the first lane of a chunk sees the carry;
    * one channel's step skipped (Δ = 0 there: the state passes through
      unchanged).

    ``want`` is the plain version's (y, h_final) on ``x``.  Returns (what,
    y, h_final) triples."""
    _, items, chunk = tile
    u, delta, a, bm, cm, dv = x
    length, d = u.shape[1], u.shape[2]

    def part(s, e, h0=None):
        return ref(u[:, s:e], delta[:, s:e], a, bm[:, s:e], cm[:, s:e], dv,
                   h0=h0)

    faults = []
    if length > 1:
        t0 = (length // 2) // chunk * chunk if length >= 2 * chunk \
            else length // 2
        y1, _ = part(0, t0)
        y2, h2 = part(t0, length)
        faults.append((f"state zeroed before step {t0}"
                       f"{' (a chunk boundary)' if t0 % chunk == 0 else ''}",
                       torch.cat([y1, y2], dim=1), h2))
    if length > items:
        c = (length // 2) // chunk * chunk
        span = min(length, c + chunk) - c
        t1 = c + items * max(1, (span // items) // 2)
        y_ok, h_ok = want
        e1 = min(length, t1 + items)
        y_seg, h_seg = part(t1, e1)
        faults.append((f"lane segment at steps {t1}-{e1 - 1} started from "
                       f"zero (a lost warp-scan prefix)",
                       torch.cat([y_ok[:, :t1], y_seg, y_ok[:, e1:]], dim=1),
                       h_seg if e1 == length else h_ok))
    if length > chunk + items:
        ys, carry = [], None
        for c in range(0, length, chunk):
            e, s1 = min(length, c + chunk), min(length, c + items)
            y0, h0 = part(c, s1, carry)
            ys.append(y0)
            carry = h0
            if s1 < e:
                _, excl = part(c, s1)
                y1, carry = part(s1, e, excl)
                ys.append(y1)
        faults.append(("every chunk's lanes past the first started from "
                       "h_excl alone (the carry's decayed term dropped)",
                       torch.cat(ys, dim=1), carry))
    t2, c2 = length // 2, d // 2
    skipped = delta.clone()
    skipped[:, t2, c2] = 0
    yf, hf = ref(u, skipped, a, bm, cm, dv)
    faults.append((f"channel {c2}'s step {t2} skipped", yf, hf))
    return faults


def _scan_bound_ms(x) -> tuple[float, str]:
    """Least time for one scan on these inputs: u, delta, B, C, A and D
    read once, y and h_final written once, over HBM bandwidth; against the
    L·D·N exp2 calls over the special-function units' rate and the 5
    float32 operations per (t, d, n) (Δ·A, the state's multiply-add, Δu·B,
    the y multiply-add) over the float32 peak, whichever is larger."""
    u, _, a, bm, _, dv = x
    b, length, d = u.shape
    n = a.shape[1]
    es = u.element_size()
    nbytes = ((3 * u.numel() + 2 * b * length * n) * es
              + (a.numel() + dv.numel() + b * d * n) * 4)
    work = b * length * d * n
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = max(work / SFU_EXP_PER_S, 5 * work / FP32_OPS_PER_S)
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def _scan_case(torch, sc, ref, x, label, *, timed, must_reject=True) -> dict:
    """Scan kernel vs plain on ``x`` = (u, delta, A, B, C, D): y and
    h_final within ``SCAN_TOL``, and each planted fault (``_scan_faults``,
    on the seams of the library's ``scan_tile()``) held to the same limits
    (rejected where ``must_reject``); the times.  The plain version's time
    only where ``timed``: no single PyTorch call computes a selective scan,
    so there is no library time."""
    tol = SCAN_TOL[str(x[0].dtype).split(".")[-1]]
    y, h = sc.scan(*x)
    y_r, h_r = ref(*x)
    ey, eh = _errors(torch, y, y_r, tol["y"]), _errors(torch, h, h_r, tol["h"])
    if not (ey["ok"] and eh["ok"]):
        raise AssertionError(
            f"{label}: scan kernel != plain version: y max |err| "
            f"{ey['max']:.3g} relative L2 {ey['rel_l2']:.3g}, h max |err| "
            f"{eh['max']:.3g} relative L2 {eh['rel_l2']:.3g} (limits {tol})")
    faults = []
    for what, yf, hf in _scan_faults(torch, ref, x, (y_r, h_r),
                                     sc.scan_tile()):
        fy, fh = _errors(torch, yf, y_r, tol["y"]), _errors(torch, hf, h_r,
                                                            tol["h"])
        rejected = not (fy["ok"] and fh["ok"])
        if must_reject and not rejected:
            raise AssertionError(f"{label}: the limits {tol} pass the "
                                 f"planted fault '{what}' (y max |err| "
                                 f"{fy['max']:.3g}, relative L2 "
                                 f"{fy['rel_l2']:.3g})")
        faults.append(f"{what}: y {fy['max']:.3g} / {fy['rel_l2']:.3g}, h "
                      f"{fh['max']:.3g} / {fh['rel_l2']:.3g} "
                      f"{'rejected' if rejected else 'PASSES'}")
    del y, h, y_r, h_r
    ms = _median_ms(lambda: sc.scan(*x), reps=SCAN_REPS)
    device_us = _device_us_per_call(torch, lambda: sc.scan(*x),
                                    ("scan_fwd",), SCAN_REPS)
    bound, by = _scan_bound_ms(x)
    plain_ms = (_median_ms(lambda: ref(*x), reps=3, warmup=1) if timed
                else None)
    plain = (f"plain {plain_ms:.4f} ms, library: none (no PyTorch call "
             f"computes a selective scan)" if timed
             else "plain timed at the main shapes only")
    print(f"mamba-scan {label}: y max |err| {ey['max']:.3g}, relative L2 "
          f"{ey['rel_l2']:.3g} at RMS |want| {ey['rms']:.3g}; h max |err| "
          f"{eh['max']:.3g}, relative L2 {eh['rel_l2']:.3g} at RMS "
          f"{eh['rms']:.3g} (limits {tol}); planted faults, y / h max |err| "
          f"/ relative L2: {'; '.join(faults)}; kernel {ms:.4f} ms per "
          f"wrapper call (device time {device_us}), bound {bound:.4f} ms "
          f"({by}), {plain}", flush=True)
    return {"max_abs_err": max(ey["max"], eh["max"]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def _scan_label(x, strided) -> str:
    u, a = x[0], x[2]
    return (f"B={u.shape[0]} L={u.shape[1]} D={u.shape[2]} N={a.shape[1]} "
            f"{str(u.dtype).split('.')[-1]}"
            f"{' strided B/C (row stride %d)' % x[3].stride(1) if strided else ''}")


def _seam_cases(tile) -> list:
    """Sweep cases on the kernel's seams, from its library's geometry: L
    inside one lane segment, a chunk less one, a chunk and one, two chunks
    and a segment and one; D past a whole number of blocks, with u's rows
    16-byte aligned (cp.async pieces, a partial last piece) or not (plain
    loads)."""
    channels, items, chunk = tile
    aligned_d = 1000 // channels * channels + 4
    plain_d = aligned_d + 1
    if aligned_d % channels == 0 or plain_d % channels == 0:
        raise AssertionError(f"seam cases want D off the {channels}-channel "
                             f"blocks, got {aligned_d} and {plain_d}")
    return [(2, max(1, items // 2), plain_d, 16, "float32", True),
            (1, chunk - 1, 1000, 16, "bfloat16", True),
            (3, chunk + 1, aligned_d, 16, "float32", False),
            (2, chunk + 1, plain_d, 4, "bfloat16", False),
            (2, 2 * chunk + items + 1, aligned_d, 8, "float32", True)]


def phase_scan(torch, sc, ref, device) -> float:
    """Phase 12: the scan kernel vs its plain version over the sweep, its
    seams and the main shape.  Returns the largest absolute error."""
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    worst = 0.0
    for b, length, d, n, dtype, strided in (
            SCAN_CASES + _seam_cases(sc.scan_tile()) + [SCAN_MAIN]):
        main = (b, length, d, n, dtype, strided) == SCAN_MAIN
        x = _scan_inputs(torch, gen, b, length, d, n, dtype, strided, device,
                         model_delta=main)
        label = _scan_label(x, strided) + (
            " (main shape, Δ log-uniform in [1e-3, 1e-1])" if main else "")
        worst = max(worst, _scan_case(torch, sc, ref, x, label,
                                      timed=main)["max_abs_err"])
        del x
    return worst


def _logit_gap(torch, tag, what, got, want, tol, failures) -> None:
    """Two logit vectors within ``tol``: atol + rtol element by element,
    max |diff| and relative L2; a miss is appended to ``failures``."""
    diff = (got - want).abs()
    worst, rel = float(diff.max()), float(diff.norm() / want.norm())
    beyond = int((diff > tol["atol"] + tol["rtol"] * want.abs()).sum())
    print(f"{tag} logits, {what}: max |diff| {worst:.4g}, relative L2 "
          f"{rel:.3g} over |logits| <= {float(want.abs().max()):.4g}, "
          f"{beyond} beyond atol + rtol (limits {tol}); argmax "
          f"{int(want.argmax())} / {int(got.argmax())}", flush=True)
    if worst > tol["max_abs"] or rel > tol["rel_l2"] or beyond:
        failures.append(f"{tag} logits, {what}: max |diff| {worst:.4g}, "
                        f"relative L2 {rel:.3g}, {beyond} beyond atol + "
                        f"rtol")


def _state_gap(torch, what, got, want, tol, failures,
               tag="falcon-mamba") -> dict:
    """Per-layer relative L2 of two caches' ssm and conv states; the worst
    layer of each is held to ``tol`` (None: only printed).  Returns the
    worst of each."""
    worst = {}
    for name in ("ssm", "conv"):
        g, w = got["mamba"][name].float(), want["mamba"][name].float()
        rel = [float((g[i] - w[i]).norm() / w[i].norm())
               for i in range(g.shape[0])]
        layer = int(np.argmax(rel))
        worst[name] = rel[layer]
        limit = "printed" if tol is None else tol[name]
        print(f"{tag} {name} states, {what}: worst layer {layer} "
              f"relative L2 {rel[layer]:.3g} (limit {limit}), median "
              f"{statistics.median(rel):.3g}, max |diff| "
              f"{float((g - w).abs().max()):.4g} over |state| <= "
              f"{float(w.abs().max()):.4g}", flush=True)
        if tol is not None and rel[layer] > tol[name]:
            failures.append(f"{name} states, {what}: layer {layer} relative "
                            f"L2 {rel[layer]:.3g}")
    return worst


def phase_falcon_mamba(torch, sc, ref, device):
    """Phase 13: Falcon Mamba 7B at full width — prefill, decode, the
    kernel on captured layer inputs, and prefill-then-decode agreement of
    the logits and of every layer's states, with the plain scan as the
    second witness.  Returns (params, cfg, scan launches, scan times)."""
    from types import SimpleNamespace

    from repro_torch import configs
    from repro_torch.models import decode_step, init_params, prefill_forward
    from repro_torch.models import mamba as mamba_mod

    cfg = configs.get(MAMBA["arch"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(SEED, cfg, device=device)
    torch.cuda.synchronize()
    print(f"falcon-mamba: {cfg.name} at full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, d_inner {cfg.d_inner_}, N "
          f"{cfg.ssm_state}, vocab {cfg.vocab}, {cfg.n_params()} "
          f"parameters, {cfg.param_dtype}) with random weights from seed "
          f"{SEED} in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(SEED + 13)
    n, steps = MAMBA["prompt"], MAMBA["decode_steps"]
    max_len = n + steps
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n),
                                         dtype=np.int64)).to(device)

    # capture the real scan inputs of the first and the last layer
    keep = (0, cfg.n_layers - 1)
    captured, calls = {}, [0]

    def capture(*x):
        if calls[0] in keep:
            captured[calls[0]] = x
        calls[0] += 1
        return sc.scan(*x)

    mamba_mod.scan_ops = SimpleNamespace(scan=capture,
                                         decode_step=sc.decode_step)
    try:
        sc.scan.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = prefill_forward(params, toks, cfg, max_len)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = sc.scan.launches
        token = last.argmax(dim=-1, keepdim=True)
        t0 = time.perf_counter()
        logits, cache = decode_step(params, cache, token, cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        token = logits.argmax(dim=-1, keepdim=True)
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            logits, cache = decode_step(params, cache, token, cfg)
            token = logits.argmax(dim=-1, keepdim=True)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        launches = sc.scan.launches
    finally:
        mamba_mod.scan_ops = sc
    peak = torch.cuda.max_memory_allocated()
    if prefill_launches != cfg.n_layers or launches != prefill_launches:
        raise AssertionError(f"falcon-mamba: {prefill_launches} scan "
                             f"launches in the prefill and "
                             f"{launches - prefill_launches} in {steps} "
                             f"decode steps, want {cfg.n_layers} and 0")
    if not (bool(torch.isfinite(last).all())
            and bool(torch.isfinite(logits).all())):
        raise AssertionError("falcon-mamba: non-finite logits")
    if tuple(last.shape) != (1, cfg.vocab) or int(
            cache["lengths"][0]) != max_len:
        raise AssertionError(f"falcon-mamba: logits {tuple(last.shape)}, "
                             f"length {int(cache['lengths'][0])}")
    print(f"falcon-mamba: first prefill of {n} tokens in {prefill_s:.4f} s "
          f"= {n / prefill_s:.0f} tokens/s; first decode step "
          f"{first_s:.4f} s (both include one-time library and allocator "
          f"set-up); {steps - 1} further decode steps in {decode_s:.4f} s "
          f"= {1e3 * decode_s / (steps - 1):.3f} ms per step (B=1, state "
          f"after {n + 1}-{max_len - 1} tokens); {prefill_launches} scan "
          f"launches in the prefill ({cfg.n_layers} layers), "
          f"{launches - prefill_launches} in the decode steps (decode is "
          f"plain tensor operations, as in the reference); peak device "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    del cache

    # the kernel on the captured layer inputs (u is the conv output cast
    # to float32, Δ float32, B and C float32 copies of x_proj's slices)
    times = []
    for layer in keep:
        x = captured.pop(layer)
        times.append(_scan_case(
            torch, sc, ref, x, f"falcon-mamba layer {layer} prefill "
            f"{_scan_label(x, False)}", timed=True, must_reject=False))
        del x

    # prefill-then-decode: the last prompt token's logits and the states
    # after the whole prompt, both ways; then the same with the plain scan
    # in the kernel's place
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, short = prefill_forward(params, toks[:, :-1], cfg, max_len)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"falcon-mamba: warm prefill of {n - 1} tokens in {warm_s:.4f} s "
          f"= {(n - 1) / warm_s:.0f} tokens/s", flush=True)
    out = {}
    _profile_step(torch, lambda: out.update(
        logits=decode_step(params, short, toks[:, -1:], cfg)[0]),
        f"falcon-mamba: one decode step (B=1, state after {n - 1} tokens)")
    via_decode = out["logits"]
    last, full = prefill_forward(params, toks, cfg, max_len)
    t0 = time.perf_counter()
    mamba_mod.scan_ops = SimpleNamespace(scan=ref,
                                         decode_step=sc.decode_step)
    try:
        plain_last, plain_full = prefill_forward(params, toks, cfg, max_len)
        _, plain_short = prefill_forward(params, toks[:, :-1], cfg, max_len)
        plain_via = decode_step(params, plain_short, toks[:, -1:], cfg)[0]
    finally:
        mamba_mod.scan_ops = sc
    torch.cuda.synchronize()
    print(f"falcon-mamba: the second witness (two prefills and a decode "
          f"step with the plain scan in every layer) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    failures = []
    for what, got, want in (
            (f"kernel: last prefill logits vs decoding the last token after "
             f"a {n - 1}-token prefill", via_decode, last),
            ("plain scan: the same (the model's own bfloat16 path)",
             plain_via, plain_last),
            (f"prefill of {n} tokens, kernel vs plain", last, plain_last),
            (f"decode step after a {n - 1}-token prefill, kernel vs plain",
             via_decode, plain_via)):
        _logit_gap(torch, "falcon-mamba", what, got, want, MAMBA_LOGIT_TOL,
                   failures)
    for what, got, want in (
            (f"kernel: {n - 1}-token prefill + one decode step vs {n}-token "
             f"prefill", short, full),
            ("plain scan: the same", plain_short, plain_full),
            (f"{n}-token prefill, kernel vs plain", full, plain_full)):
        _state_gap(torch, what, got, want, MAMBA_STATE_TOL, failures)
    if failures:
        raise AssertionError("falcon-mamba: " + "; ".join(failures))
    del short, full, plain_short, plain_full
    _profile_step(torch, lambda: prefill_forward(params, toks[:, :-1], cfg,
                                                 max_len),
                  f"falcon-mamba: one prefill of {n - 1} tokens")
    return params, cfg, launches, _mean_times(*times)


def phase_mamba_serving(torch, sc, params, cfg, device) -> None:
    """Phase 14: BatchedServer on Falcon Mamba 7B at full width."""
    sc.scan.launches = 0
    server, run = _serve_requests(torch, params, cfg, device, SEED + 14)
    if sc.scan.launches != 0:
        raise AssertionError(f"mamba serving: {sc.scan.launches} scan "
                             f"launches, want 0 (admission runs decode "
                             f"steps)")
    _profile_step(torch, lambda: server._admit_step(1, 0),
                  f"mamba serving: one admission step (B={SERVE['slots']})")
    print(f"mamba serving: {_serve_text(cfg, run)}; 0 scan launches — "
          f"admission and generation are decode steps, as in the "
          f"reference, so the kernel is exercised by phases 12-13",
          flush=True)


# -- phases 15-16: the paper's serverless system ------------------------------

#: the paper's §IV-C job configuration, as the reference's benchmarks set it
#: (``benchmarks/common.py``'s ``PAPER_JOB``, copied as data): combiner and
#: Finalizer on, 50 MB input/output buffers, 5 MB multipart, merge fan-in
#: 100, 75% spill threshold, 4 Mappers / 2 Reducers
MB = 1024 * 1024
PAPER_JOB = dict(n_mappers=4, n_reducers=2, run_combiner=True,
                 run_finalizer=True, input_buffer_bytes=50 * MB,
                 output_buffer_bytes=50 * MB, multipart_bytes=5 * MB,
                 merge_fan_in=100, spill_threshold=0.75)
#: the Coordinator's pools as the reference's Fig. 6 bench sets them: a
#: Knative-like 0.08 s activation, 16 instances, no speculation
PAPER_POOL = dict(cold_start=0.08, max_scale=16, scale_to_zero_grace=10.0)
#: Fig. 6's largest input: bytes of synth_corpus text over 5,000 words
# Fig. 6's second-largest input: its largest, 16 MiB, took 67-74 s with
# the combiner on and off on an H100 host, which the script's 1,200 s
# limit no longer leaves room for
PAPER_BYTES = 4 * MB
PAPER_VOCAB = 5000
#: phase 16: the service's log (phase 3's), then two more minutes appended
SERVICE_APPEND_MINUTES = 2
#: phase 20: real-valued float32 segment sums, card against the CPU's left
#: fold, about 33,500 terms a key: rounding error grows like sqrt(m) ulp
#: (~1e-5 of the sum at this m), so 1e-4 leaves a 10x margin
REAL_SUM_RTOL = 1e-4


def paper_corpus(n_bytes: int, seed: int) -> str:
    """Fig. 6's corpus: the seeded Zipf text over 5,000 words, cut at
    ``n_bytes``.  The reference bench's ``corpus_of_bytes`` draws
    ``n_bytes / 6`` words, which at 5,000 words is shorter than
    ``n_bytes`` (10,489,110 B for 16 MiB); this draws enough words to
    fill all of it."""
    from repro_torch.data import synth_corpus
    words = synth_corpus(max(64, n_bytes // 3), vocab_words=PAPER_VOCAB,
                         seed=seed)
    if len(words) < n_bytes:
        raise AssertionError(f"{len(words)} B of text for {n_bytes}")
    return words[:n_bytes]


def phase_batch_job(torch, hc, device, n_bytes: int = PAPER_BYTES) -> int:
    """Phase 15: the paper's host batch job (Coordinator → Splitter → 4
    Mappers → 2 Reducers → Finalizer) on Fig. 6's largest input, combiner
    on and off; the Finalizer's object against a Counter oracle and against
    the same tokens counted by the array pipeline on the card.  Returns
    hash_combine's launches in that count."""
    from collections import Counter

    from repro_torch.core import (AutoscalerConfig, Coordinator,
                                  MemoryStore, MetadataStore,
                                  make_wordcount_job, read_final_output)
    from repro_torch.core.mapreduce import wordcount_map_factory
    from repro_torch.pipeline import Pipeline

    t0 = time.perf_counter()
    corpus = paper_corpus(n_bytes, SEED)
    words = corpus.split()
    oracle = dict(Counter(words))
    print(f"batch-job: {len(corpus.encode())} B of text, {len(words)} "
          f"words, {len(oracle)} distinct, made in "
          f"{time.perf_counter() - t0:.2f} s (host)", flush=True)
    spill = {}
    finals = {}
    for combine in (True, False):
        store, meta = MemoryStore(), MetadataStore()
        store.put("input/corpus.txt", corpus.encode())
        coord = Coordinator(store, meta,
                            autoscaler=AutoscalerConfig(**PAPER_POOL),
                            speculative_execution=False)
        cfg = make_wordcount_job(job_id=f"paper-combiner-"
                                 f"{'on' if combine else 'off'}",
                                 **{**PAPER_JOB, "run_combiner": combine})
        t0 = time.perf_counter()
        report = coord.run_job(cfg)
        wall = time.perf_counter() - t0
        if report.state.value != "DONE":
            raise AssertionError(f"batch job {cfg.job_id} ended "
                                 f"{report.state.value}: {report.error}")
        got = read_final_output(cfg, store)
        if got != oracle:
            bad = sorted(k for k in set(got) | set(oracle)
                         if got.get(k) != oracle.get(k))[:4]
            raise AssertionError(f"the Finalizer's counts differ from the "
                                 f"Counter oracle at {bad}")
        finals[combine] = got
        mappers = [t.times for t in report.task_results
                   if t.role == "mapper"]
        spill[combine] = sum(t.bytes_out for t in mappers)
        phases = "; ".join(
            f"{role} download {v['downloading']:.4f} process "
            f"{v['processing']:.4f} upload {v['uploading']:.4f} s"
            for role, v in report.phase_times().items())
        print(f"batch-job combiner {'on' if combine else 'off'} (host): "
              f"wall {wall:.3f} s ({report.wall_time:.3f} s in run_job, the "
              f"pools' 0.08 s activations included); "
              f"mapper bytes in {[t.bytes_in for t in mappers]}; "
              f"{sum(t.spills for t in mappers)} spills, {spill[combine]} "
              f"spill bytes, {sum(t.records_out for t in mappers)} spilled "
              f"records; per-task means: {phases}; Finalizer object == "
              f"Counter oracle ({len(got)} words)", flush=True)
    if not spill[True] < spill[False]:
        raise AssertionError("the combiner did not reduce spill bytes")
    vocab = {w: i for i, w in enumerate(sorted(oracle))}
    nb = 1 << max(1, (len(vocab) - 1).bit_length())
    tok = np.fromiter((vocab[w] for w in words), np.int64, len(words))
    n_workers = 8
    pad = (-len(tok)) % n_workers
    tok = np.concatenate([tok, np.full(pad, -1, np.int64)])
    shards = np.stack([tok.reshape(n_workers, -1),
                       np.ones((n_workers, len(tok) // n_workers),
                               np.int64)], axis=-1)
    shards_dev = torch.from_numpy(shards).to(device)
    built = (Pipeline.from_source(shards=shards_dev)
             .map(wordcount_map_factory(nb)).reduce("sum")
             .build(num_buckets=nb, n_workers=n_workers, device=device))
    hc.combine.launches = 0
    counts, stats = built.run()
    launches = hc.combine.launches
    if launches != 1:
        raise AssertionError(f"the card word count launched hash_combine "
                             f"{launches} times; the design launches it once")
    counts = counts.cpu().numpy()
    card = {w: int(counts[i]) for w, i in vocab.items()}
    if card != finals[True] or int(counts.sum()) != len(words):
        raise AssertionError("the card word count differs from the "
                             "Finalizer's object")
    print(f"batch-job: the Finalizer's object == the array pipeline's count "
          f"on the card ({len(words)} tokens into {nb} buckets, {launches} "
          f"hash_combine launch); combiner on {spill[True]} / off "
          f"{spill[False]} spill bytes ({spill[True] / spill[False]:.4f})",
          flush=True)
    return launches


def _segment_counting_store(store_cls, prefix: str):
    """A fresh ``store_cls`` that counts its GETs of keys under ``prefix``
    (an event log's segments) in ``segment_gets``."""
    from collections import Counter

    class SegmentCountingStore(store_cls):
        def __init__(self):
            super().__init__()
            self.segment_gets = Counter()

        def get(self, key, *args, **kwargs):
            if key.startswith(prefix):
                self.segment_gets[key] += 1
            return super().get(key, *args, **kwargs)

    return SegmentCountingStore()


def service_programs(lr, n_xways: int, device) -> dict:
    """Phase 16's three tenants' programs over one Linear Road log:
    ``lav`` (phase 3's job), per-segment report counts a minute (volume),
    and the 100 fastest segments by mean speed every 5 minutes (top-k
    emission on the device).  Windowed aggregates are count, sum and mean
    in both packages, so no tenant folds a min or a max (phase 2 checks
    the kernel's extremum kinds)."""
    from repro_torch.pipeline import Pipeline, Windowing
    opts = lr.build_options(n_xways)

    def tenant(window, agg, sink, job_id, top=None):
        pipe = (Pipeline.from_source(batch_records=lr.BATCH_RECORDS)
                .key_by().window(window).reduce(agg))
        if top:
            pipe = pipe.top_k(top)
        return pipe.sink(sink).build(device=device, job_id=job_id, **opts)

    return {
        "traffic-lav": lr.lav_pipeline("linear-road/reports").build(
            device=device, job_id="linear-road-lav", **opts),
        "traffic-volume": tenant(Windowing.tumbling(60.0), "count",
                                 "volume/", "segment-volume"),
        "traffic-fastest": tenant(Windowing.tumbling(300.0), "mean",
                                  "fastest/", "fastest-segments", top=100),
    }


def phase_job_service(torch, ops, lr, device, full=None) -> int:
    """Phase 16: one JobServer on the card, three tenants on one shared
    ingest of phase 3's Linear Road log; scale to zero after the log
    drains, two more minutes appended, cold restores, and every tenant's
    sinks against its program run alone over the whole log, built for the
    card and for the CPU (the fold's plain version).  Returns the
    fused_fold launches of the service's run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import MemoryStore, MetadataStore
    from repro_torch.pipeline import RunOptions
    from repro_torch.service import JobServer, ParkPolicy
    from repro_torch.streaming import StreamSource, write_event_log

    full = full or lr.FULL
    prefix = "linear-road/reports"
    ts, seg, speed = lr.position_reports(SEED, **full)
    ts2, seg2, speed2 = lr.position_reports(
        SEED + 16, **dict(full, minutes=SERVICE_APPEND_MINUTES))
    ts2 = ts2 + full["minutes"] * 60.0
    first = lr.records(ts, seg, speed)
    second = lr.records(ts2, seg2, speed2)
    store = _segment_counting_store(MemoryStore, prefix + "/")
    write_event_log(store, prefix, first, segment_records=lr.BATCH_RECORDS)
    programs = service_programs(lr, full["n_xways"], device)
    server = JobServer(store, MetadataStore(),
                       park_policy=ParkPolicy(idle_seconds=0.0))
    for tenant, program in programs.items():
        server.add_tenant(tenant)
        server.submit(tenant, program, source_prefix=prefix)
    ops.fold.launches = 0
    t0 = time.perf_counter()
    while server.step():
        pass
    wall1 = time.perf_counter() - t0
    states = {jid: j.state for jid, j in server.jobs.items()}
    replicas = server.pool.stats()["replicas"]
    if set(states.values()) != {"PARKED"} or replicas != 0:
        raise AssertionError(f"after the log drained: states {states}, "
                             f"{replicas} pool replicas (want all PARKED, "
                             f"0 replicas)")
    n1 = {jid: j.report.records_in for jid, j in server.jobs.items()}
    print(f"service: {len(first)} reports into {len(programs)} tenants in "
          f"{wall1:.3f} s (host wall) = "
          f"{sum(n1.values()) / wall1:.0f} records/s aggregate; every job "
          f"PARKED, pool at {replicas} replicas", flush=True)
    write_event_log(store, prefix, second, segment_records=lr.BATCH_RECORDS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        final = server.run_until_complete()
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    launches = ops.fold.launches
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA]
    device_us = sum(_device_us(ev) for ev in events)
    fold_us = sum(_device_us(ev) for ev in events
                  if "fold_kernel" in ev.key)
    jobs = server.jobs
    folds = sum(j.report.folds for j in jobs.values())
    if set(final.values()) != {"DONE"}:
        raise AssertionError(f"service ended with {final}: "
                             f"{[j.error for j in jobs.values()]}")
    if launches != folds or launches < sum(j.report.batches
                                           for j in jobs.values()):
        raise AssertionError(f"fused_fold launched {launches} times for "
                             f"{folds} fold steps")
    reads = store.segment_gets
    n_segments = len(store.list_objects(prefix + "/segment-"))
    if len(reads) != n_segments or set(reads.values()) != {1}:
        raise AssertionError(f"log segments read {dict(reads)}; want each "
                             f"of {n_segments} exactly once")
    late = {jid: j.report.late_dropped for jid, j in jobs.items()}
    if any(late.values()):
        raise AssertionError(f"late pairs dropped: {late}")
    colds = sorted(t for j in jobs.values() for t in j.cold_start_latencies)
    total = len(first) + len(second)
    print(f"service: {len(second)} more reports appended; cold restores "
          f"{len(colds)}, latency p50 "
          f"{1e3 * colds[len(colds) // 2]:.3f} ms, max "
          f"{1e3 * colds[-1]:.3f} ms (host); the rest in {wall2:.3f} s; "
          f"{launches} fused_fold launches = {folds} fold steps; each of "
          f"{n_segments} log segments read once", flush=True)
    busy = (f"{device_us / 1e3:.3f} ms = {device_us / 1e4 / wall2:.3f}% "
            f"busy, fused_fold {fold_us / 1e3:.3f} ms" if device_us > 0
            else "not measured")
    print(f"service: device work in the appended part (torch.profiler, "
          f"CUDA only, {wall2:.3f} s of wall): {busy}", flush=True)
    for jid, job in jobs.items():
        rep = job.report
        busy = sum(rep.batch_latencies)
        print(f"service tenant {job.tenant.name} ({jid}): {rep.records_in} "
              f"records, {rep.batches} batches, {rep.folds} folds, "
              f"{rep.windows_emitted} windows; {rep.records_in / busy:.0f} "
              f"records/s over its {busy:.3f} s of driver time; pool "
              f"{job.meter.pool_seconds:.3f} s (host)", flush=True)
    print(f"service: {total * len(jobs) / (wall1 + wall2):.0f} records/s "
          f"aggregate over both parts (host wall {wall1 + wall2:.3f} s); "
          f"pool compute {sum(j.meter.pool_seconds for j in jobs.values()):.3f}"
          f" s; JobServer.stats() {json.dumps(server.stats())}", flush=True)
    def alone(program):
        private = MemoryStore()
        write_event_log(private, prefix, first,
                        segment_records=lr.BATCH_RECORDS)
        write_event_log(private, prefix, second,
                        segment_records=lr.BATCH_RECORDS)
        t0 = time.perf_counter()
        report = program.run(StreamSource(store=private, prefix=prefix,
                                          batch_records=lr.BATCH_RECORDS),
                             store=private, meta=MetadataStore(),
                             options=RunOptions(overlap=True))
        if report.error is not None:
            raise AssertionError(f"{program.job_id} alone failed: "
                                 f"{report.error}")
        return program.collect_outputs(private), time.perf_counter() - t0

    # each tenant's program built again for the CPU folds through the
    # plain version, so the card's sinks are held against it, not only
    # against the same card-built program run alone
    plain = service_programs(lr, full["n_xways"], "cpu")
    for tenant, program in programs.items():
        card, card_s = alone(program)
        want, plain_s = alone(plain[tenant])
        ns = f"tenants/{tenant}/"
        got = {k[len(ns):]: v for k, v in
               {m.key: store.get(m.key) for out in program.output_prefixes()
                for m in store.list_objects(ns + out)}.items()}
        if not want or got != want or card != want:
            raise AssertionError(
                f"tenant {tenant}: service sinks == plain {got == want}, "
                f"card alone == plain {card == want} ({len(got)} / "
                f"{len(card)} / {len(want)} objects)")
        print(f"service tenant {tenant}: {len(got)} sink objects "
              f"byte-identical to the program run alone on the card "
              f"({card_s:.3f} s) and built for the CPU, the fold's plain "
              f"version ({plain_s:.3f} s), over all {total} reports (host)",
              flush=True)
    lav = programs["traffic-lav"]
    oracle = lr.lav_oracle(np.concatenate([ts, ts2]),
                           np.concatenate([seg, seg2]),
                           np.concatenate([speed, speed2]))
    ns = "tenants/traffic-lav/"
    for start, means in oracle.items():
        key = (f"{ns}lav/{lav.job_id}/window-{start:.3f}-"
               f"{start + lr.WINDOW_SIZE:.3f}")
        got = dict(json.loads(line) for line in store.get(key).splitlines())
        if got != means:
            raise AssertionError(f"{key}: LAV differs from phase 3's oracle")
    print(f"service tenant traffic-lav: {len(oracle)} windows == phase 3's "
          f"numpy oracle over the whole log", flush=True)
    return launches


def _lr_log(lr, records, prefixes):
    """A fresh in-memory store holding ``records`` as an event log under
    each of ``prefixes``, in Linear Road micro-batch segments."""
    from repro_torch.core import MemoryStore
    from repro_torch.streaming import write_event_log
    store = MemoryStore()
    for prefix in prefixes:
        write_event_log(store, prefix, records,
                        segment_records=lr.BATCH_RECORDS)
    return store


def _drive(program, store):
    """One streaming run of ``program`` over its bound logs in ``store``:
    ``(report, sinks, host wall)``."""
    from repro_torch.core import MetadataStore
    from repro_torch.pipeline import RunOptions
    t0 = time.perf_counter()
    report = program.run(store=store, meta=MetadataStore(),
                         options=RunOptions(overlap=True))
    wall = time.perf_counter() - t0
    if report.error is not None:
        raise AssertionError(f"{program.job_id} failed: {report.error}")
    return report, program.collect_outputs(store), wall


EDGE_RANGE = "device-edge handoff"


def _launched_in(prof, name, events=None) -> tuple[list, int, list]:
    """The device records (kernels, copies, sets) that the CUDA calls the
    host made inside the ``record_function(name)`` ranges of ``prof``
    launched, matched to those calls by CUPTI correlation id; the number
    of ranges; and every device record of the trace.  A record counts by
    the call that queued it, not by where its timestamp falls: a copy the
    coordinator queued outside every range (a checkpoint's, a stats
    drain's) was seen to land inside one.  Only ``correlation_id`` links a record
    to its call; ``linked_correlation_id`` counts in another id space,
    and its values collide with the calls' ids.  ``events``: the trace's
    events, where the caller has read them already (reading them is slow
    on a long trace)."""
    from torch.autograd import DeviceType
    if events is None:
        events = prof.profiler.kineto_results.events()
    windows = [(ev.start_ns(), ev.end_ns()) for ev in events
               if ev.name() == name and ev.device_type() == DeviceType.CPU]
    calls = {ev.correlation_id() for ev in events
             if ev.device_type() == DeviceType.CPU
             and ev.name().startswith("cu")
             and any(lo <= ev.start_ns() <= hi for lo, hi in windows)}
    calls.discard(0)
    on_device = [ev for ev in events if ev.device_type() == DeviceType.CUDA
                 and ev.name() != name]
    inside = [ev for ev in on_device if ev.correlation_id() in calls]
    return inside, len(windows), on_device


def phase_congestion_chain(torch, ops, lr, device, full=None) -> int:
    """Phase 17: ``congestion_chain`` (a tee'd stage DAG) over phase 3's
    reports on the card.  The sinks of both branches must equal the same
    program built with ``device="cpu"`` (every fold through the plain
    version) byte for byte, and the numpy oracles; fused_fold's launches
    (counts set to 0 just before) must equal the fold steps of all
    stages; the device edge's handoffs must copy nothing to the host.
    Returns the launches of the card run."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.streaming import StreamingCoordinator

    full = full or lr.FULL
    prefix = "linear-road/reports"
    ts, seg, speed = lr.position_reports(SEED, **full)
    records = lr.records(ts, seg, speed)
    opts = lr.build_options(full["n_xways"])

    def program(dev):
        return lr.congestion_chain(prefix).build(device=dev,
                                                 job_id="congestion", **opts)

    card = program("cuda")
    print("congestion_chain:\n" + card.explain(), flush=True)
    # one card run, in one torch.profiler session: each device-edge
    # handoff runs between two synchronizes inside its own record_function
    # range, so the device work it queued (and any copy to the host it
    # made) is launched by CUDA calls inside that range, and Python reads
    # of a tensor are counted there too; its host time is that of the
    # call alone, the synchronizes excluded
    folds, reads = Counter(), Counter()
    edge_ms = []
    names = ("cpu", "tolist", "item", "numpy")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    orig_fold = StreamingCoordinator._fold
    orig_edge = StreamingCoordinator._handoff_device

    def counted_fold(self, si, *args, **kwargs):
        folds[si] += 1
        return orig_fold(self, si, *args, **kwargs)

    def reading(name):
        def call(t, *a, **k):
            reads[name] += 1
            return saved[name](t, *a, **k)
        return call

    def profiled_edge(self, *args, **kwargs):
        torch.cuda.synchronize()
        with record_function(EDGE_RANGE):
            for n in names:
                setattr(torch.Tensor, n, reading(n))
            t0 = time.perf_counter()
            try:
                orig_edge(self, *args, **kwargs)
            finally:
                edge_ms.append(1e3 * (time.perf_counter() - t0))
                for n in names:
                    setattr(torch.Tensor, n, saved[n])
            torch.cuda.synchronize()

    StreamingCoordinator._fold = counted_fold
    StreamingCoordinator._handoff_device = profiled_edge
    try:
        store = _lr_log(lr, records, (prefix,))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ops.fold.launches = 0
            report, got, wall = _drive(card, store)
            launches = ops.fold.launches
    finally:
        StreamingCoordinator._fold = orig_fold
        StreamingCoordinator._handoff_device = orig_edge
    if launches != report.folds or launches != sum(folds.values()):
        raise AssertionError(f"fused_fold launched {launches} times for "
                             f"{report.folds} fold steps ({dict(folds)})")
    if report.late_dropped:
        raise AssertionError(f"{report.late_dropped} late pairs dropped; the "
                             f"oracles assume none")
    print(f"congestion_chain on the card: {report.records_in} reports in "
          f"{wall:.3f} s = {report.records_in / wall:.0f} records/s (host "
          f"wall, under torch.profiler, a synchronize either side of each "
          f"device handoff); {report.batches} micro-batches; folds per "
          f"stage {[folds[i] for i in range(len(card.stages))]} = "
          f"{launches} fused_fold launches; {report.handoffs} handoffs "
          f"({len(edge_ms)} on the device edge: host time "
          f"{sum(edge_ms):.3f} ms in all, median "
          f"{statistics.median(edge_ms):.3f} ms, first {edge_ms[0]:.3f} ms, "
          f"max {max(edge_ms):.3f} ms); {report.windows_emitted} windows "
          f"emitted", flush=True)

    inside, n_windows, on_device = _launched_in(prof, EDGE_RANGE)
    dtoh = [ev for ev in inside if "DtoH" in ev.name()]
    if n_windows != len(edge_ms) or not inside:
        raise AssertionError(f"the device edge's handoffs were not measured: "
                             f"{n_windows} ranges for {len(edge_ms)} "
                             f"handoffs, {len(inside)} device records "
                             f"launched in them")
    if dtoh or sum(reads.values()):
        raise AssertionError(f"the device edge copied to the host: "
                             f"{len(dtoh)} DtoH copies, {dict(reads)} tensor "
                             f"reads over {n_windows} handoffs")
    dev_us = sum(ev.duration_ns() for ev in inside) / 1e3
    work = Counter(ev.name()[:48] for ev in inside)
    print(f"congestion_chain device edge: {n_windows} handoffs, 0 "
          f"device-to-host copies (torch.profiler Memcpy DtoH records "
          f"launched from their windows; "
          f"{sum('DtoH' in ev.name() for ev in on_device)} in the whole "
          f"run) and 0 tensor reads on the host; device time "
          f"{dev_us / 1e3:.3f} ms in all = {dev_us / n_windows:.2f} us a "
          f"handoff (rows + fold, {len(inside)} device records); device work "
          f"there: {dict(work)}", flush=True)

    plain, want, plain_wall = _drive(program("cpu"),
                                     _lr_log(lr, records, (prefix,)))
    if not want or got != want:
        diff = sorted(set(got) ^ set(want))[:4] or [
            k for k in want if got.get(k) != want[k]][:4]
        raise AssertionError(f"congestion_chain: card sinks != plain "
                             f"(device='cpu') sinks: {diff}")
    top, volume = lr.congestion_oracle(ts, seg)
    oracle = {}
    for start, rows in top.items():
        oracle[f"congested/congestion/window-{start:.3f}-"
               f"{start + lr.WINDOW_SIZE:.3f}"] = [list(r) for r in rows]
    for start, per in volume.items():
        oracle[f"xway-volume/congestion/window-{start:.3f}-"
               f"{start + lr.WINDOW_SIZE:.3f}"] = per
    if set(got) != set(oracle):
        raise AssertionError(f"congestion_chain windows differ from the "
                             f"oracle's: {sorted(set(got) ^ set(oracle))[:4]}")
    for key, blob in got.items():
        rows = [json.loads(line) for line in blob.splitlines()]
        if key.startswith("xway-volume/"):
            rows = dict(rows)
        if rows != oracle[key]:
            raise AssertionError(f"{key}: differs from the numpy oracle")
    n_top = sum(1 for k in got if k.startswith("congested/"))
    print(f"congestion_chain: {len(got)} sink objects ({n_top} top-"
          f"{lr.TOP_K} windows, {len(got) - n_top} expressway windows) "
          f"byte-identical to the program built with device='cpu' "
          f"({plain_wall:.3f} s, {plain.records_in / plain_wall:.0f} "
          f"records/s) and equal to the numpy oracles", flush=True)
    return launches


def phase_toll_join(torch, ops, lr, device, full=None) -> int:
    """Phase 18: ``toll_inputs_join`` — mean speed ⋈ report count per
    segment per minute, over phase 3's reports written under two
    prefixes — on the card.  Both sides fold into one 4-channel carry at
    channel bases 0 and 2 (checked on each side's first folds: the other
    pair untouched), sized apart (``num_buckets=(left, right)``) so the
    narrower side's carry is wider than its key space; the sinks must equal the program built with
    ``device="cpu"`` byte for byte, and the numpy oracle; fused_fold's
    launches (counts set to 0 just before) must equal the fold steps.
    Returns the launches of the card run."""
    from collections import Counter

    from repro_torch.engine.plan import CompiledStreamAggregate

    full = full or lr.FULL
    prefixes = ("linear-road/speeds", "linear-road/counts")
    ts, seg, speed = lr.position_reports(SEED, **full)
    records = lr.records(ts, seg, speed)
    opts = lr.build_options(full["n_xways"])
    # per-side key tables: the speed side's fits the segments, the count
    # side's is rounded up to a power of two; the shared carry takes the
    # wider, so the speed side folds with carry_buckets != num_buckets
    n_seg = opts["num_buckets"]
    opts["num_buckets"] = (n_seg, 1 << (n_seg - 1).bit_length())

    def program(dev):
        return lr.toll_inputs_join(*prefixes).build(
            device=dev, job_id="toll-inputs", **opts)

    card = program("cuda")
    sides = card.stages[0].sides
    carry = sides[0].compiled.init_carry()
    geometry = [(sp.channel_base, sp.compiled.plan.key_space.num_buckets,
                 sp.compiled.plan.carry_buckets) for sp in sides]
    wide = opts["num_buckets"][1]
    if geometry != [(0, n_seg, wide), (2, wide, wide)] or \
            tuple(carry.shape) != (sides[0].compiled.plan.window.n_slots
                                   * wide, 4):
        raise AssertionError(f"join sides (channel base, num_buckets, "
                             f"carry_buckets) {geometry} with a "
                             f"{tuple(carry.shape)} carry")
    bases, checked = Counter(), Counter()
    orig_step = CompiledStreamAggregate.step

    def checked_step(self, rows, carry, min_window=None):
        base = self.plan.reduce.channel_base
        bases[base] += 1
        if checked[base] >= 3:
            return orig_step(self, rows, carry, min_window)
        checked[base] += 1
        other = [c for c in range(carry.shape[1]) if c not in (base,
                                                                base + 1)]
        before = carry[:, other].clone()
        out = orig_step(self, rows, carry, min_window)
        if not torch.equal(out[0][:, other], before):
            raise AssertionError(f"a fold at channel base {base} touched "
                                 f"channels {other}")
        return out

    CompiledStreamAggregate.step = checked_step
    try:
        store = _lr_log(lr, records, prefixes)
        ops.fold.launches = 0
        report, got, wall = _drive(card, store)
        launches = ops.fold.launches
    finally:
        CompiledStreamAggregate.step = orig_step
    if launches != report.folds or set(bases) != {0, 2}:
        raise AssertionError(f"fused_fold launched {launches} times for "
                             f"{report.folds} fold steps (per channel base "
                             f"{dict(bases)})")
    if report.late_dropped:
        raise AssertionError(f"{report.late_dropped} late pairs dropped")
    plain, want, plain_wall = _drive(program("cpu"),
                                     _lr_log(lr, records, prefixes))
    if not want or got != want:
        raise AssertionError("toll_inputs_join: card sinks != plain "
                             "(device='cpu') sinks")
    oracle = lr.toll_inputs_oracle(ts, seg, speed)
    slow_busy = 0
    for start, per in oracle.items():
        key = (f"toll-inputs/toll-inputs/window-{start:.3f}-"
               f"{start + lr.MINUTE:.3f}")
        rows = dict(json.loads(line) for line in got[key].splitlines())
        if rows != per:
            raise AssertionError(f"{key}: differs from the numpy oracle")
        slow_busy += sum(1 for mean, n in rows.values()
                         if mean < 40.0 and n > 50)
    if len(got) != len(oracle):
        raise AssertionError(f"{len(got)} join windows, oracle "
                             f"{len(oracle)}")
    print(f"toll_inputs_join on the card: {report.records_in} records "
          f"(two logs of {len(records)}) in {wall:.3f} s = "
          f"{report.records_in / wall:.0f} records/s (host wall); "
          f"{report.batches} micro-batches, {launches} fused_fold launches "
          f"= {report.folds} fold steps ({bases[0]} at channel base 0, "
          f"{bases[2]} at base 2 — num_buckets {n_seg} / {wide} — one "
          f"{tuple(carry.shape)} carry; the first "
          f"{checked[0]} + {checked[2]} left the other pair untouched); "
          f"{len(got)} windows byte-identical to device='cpu' "
          f"({plain_wall:.3f} s, {plain.records_in / plain_wall:.0f} "
          f"records/s) and equal to the numpy oracle; (segment, minute) "
          f"pairs under 40 mph with more than 50 reports: {slow_busy}",
          flush=True)
    return launches


# -- phases 19-20: group mode -------------------------------------------------

def _wrapped_calls(torch, cls, names, host, profiled):
    """Wrap methods ``names`` of ``cls`` so each call adds its host time
    to ``host[name]``; with ``profiled``, each call also runs between two
    synchronizes inside a ``record_function(name)`` range, so the device
    work it queued lies in that range's time window (the synchronizes are
    not in the host time).  Returns the originals, to put back."""
    from torch.profiler import record_function
    saved = {n: getattr(cls, n) for n in names}

    def wrapped(name):
        def call(self, *args, **kwargs):
            if profiled:
                torch.cuda.synchronize()
            with record_function(name) if profiled else nullcontext():
                t0 = time.perf_counter()
                out = saved[name](self, *args, **kwargs)
                host[name] += time.perf_counter() - t0
                if profiled:
                    torch.cuda.synchronize()
            return out
        return call

    for n in names:
        setattr(cls, n, wrapped(n))
    return saved


def phase_segment_median(torch, ops, lr, full=None) -> None:
    """Phase 19: ``segment_median_pipeline`` — the median speed per
    segment over sliding 5-minute windows, group mode with
    ``median_reduce``, 8 workers, 8 slots, ``capacity`` 2**17 — over phase
    3's 1,000,000 reports on the card.  No buffer may drop a record and no
    pair may be late; the sinks must equal the program built with
    ``device="cpu"`` byte for byte and the numpy median oracle.  A second
    card run under torch.profiler, each fold and finalization between
    two synchronizes, gives their device time (and must emit the same
    sinks)."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine.plan import CompiledStreamGroup

    full = full or lr.FULL
    prefix = "linear-road/reports"
    ts, seg, speed = lr.position_reports(SEED, **full)
    records = lr.records(ts, seg, speed)
    opts = lr.build_options(full["n_xways"])

    def program(dev):
        return lr.segment_median_pipeline(prefix).build(
            device=dev, job_id="segment-median", **opts)

    card = program("cuda")
    carry = card.stages[0].sides[0].compiled.init_carry()
    carry_bytes = sum(t.numel() * t.element_size() for t in carry.values())
    if {t.device.type for t in carry.values()} != {"cuda"}:
        raise AssertionError("the group carry is not on the card")
    del carry
    names = ("step", "finalize_slot")
    host, host_p = defaultdict(float), defaultdict(float)
    saved = _wrapped_calls(torch, CompiledStreamGroup, names, host, False)
    try:
        folds_before = ops.fold.launches
        report, got, wall = _drive(card, _lr_log(lr, records, (prefix,)))
    finally:
        for n in names:
            setattr(CompiledStreamGroup, n, saved[n])
    saved = _wrapped_calls(torch, CompiledStreamGroup, names, host_p, True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            report_p, got_p, wall_p = _drive(
                program("cuda"), _lr_log(lr, records, (prefix,)))
    finally:
        for n in names:
            setattr(CompiledStreamGroup, n, saved[n])
    device = {}
    for n in names:
        inside, n_windows, _ = _launched_in(prof, n)
        device[n] = (sum(ev.duration_ns() for ev in inside) / 1e6,
                     n_windows)
    if device["step"][1] != report_p.folds or not all(
            ms > 0 for ms, _ in device.values()):
        raise AssertionError(f"the profiled run's calls were not measured: "
                             f"{device} for {report_p.folds} folds")
    if report.capacity_dropped or report.late_dropped:
        raise AssertionError(f"segment median dropped "
                             f"{report.capacity_dropped} records past "
                             f"capacity and {report.late_dropped} late pairs")
    if ops.fold.launches != folds_before:
        raise AssertionError("a group-mode run launched fused_fold")
    plain, want, plain_wall = _drive(program("cpu"),
                                     _lr_log(lr, records, (prefix,)))
    if not want or got != want or got_p != want:
        diff = sorted(set(got) ^ set(want))[:4] or [
            k for k in want if got.get(k) != want[k]][:4]
        raise AssertionError(f"segment median: card sinks != plain "
                             f"(device='cpu') sinks: {diff}")
    oracle = lr.median_oracle(ts, seg, speed)
    if len(got) != len(oracle):
        raise AssertionError(f"{len(got)} median windows, oracle "
                             f"{len(oracle)}")
    for start, per in oracle.items():
        key = (f"median-speed/segment-median/window-{start:.3f}-"
               f"{start + lr.WINDOW_SIZE:.3f}")
        if dict(json.loads(line) for line in got[key].splitlines()) != per:
            raise AssertionError(f"{key}: differs from the numpy median "
                                 f"oracle")
    (step_ms, n_steps), (fin_ms, n_fin) = device["step"], \
        device["finalize_slot"]
    print(f"segment_median (group mode, median_reduce) on the card: "
          f"{report.records_in} reports in {wall:.3f} s = "
          f"{report.records_in / wall:.0f} records/s (host wall); "
          f"{report.batches} micro-batches; {n_steps} folds (step): host "
          f"{host['step']:.3f} s in all, device {step_ms:.3f} ms; {n_fin} "
          f"finalizations (finalize_slot): host {host['finalize_slot']:.3f} "
          f"s, device {fin_ms:.3f} ms (device: torch.profiler's records "
          f"launched from each call of a second card run, {wall_p:.3f} s, whose "
          f"calls took {host_p['step']:.3f} / "
          f"{host_p['finalize_slot']:.3f} s of host time between "
          f"synchronizes); carry {carry_bytes} B (8 workers x {lr.N_SLOTS} "
          f"slots x {lr.MEDIAN_CAPACITY} records); "
          f"{report.records_expanded} (report, window) pairs buffered, 0 "
          f"dropped, 0 late, 0 fused_fold launches; {len(got)} windows "
          f"byte-identical to device='cpu' ({plain_wall:.3f} s, "
          f"{plain.records_in / plain_wall:.0f} records/s) and equal to the "
          f"numpy median oracle", flush=True)


def phase_group_wordcount(torch, hc, wc, shards, combined, combined_wall
                          ) -> None:
    """Phase 20: the combiner-off word count, ``wordcount-hibench-large``
    through ``group_pipeline`` — every token crosses the grouping shuffle
    — with ``capacity`` sized from the shards so nothing drops.  Each of
    three runs from device-resident shards must equal the ``np.bincount``
    oracle and phase 6b's ``hash_combine`` counts exactly, with 0
    combiner launches; prints their median wall against phase 6b's."""
    n = shards.shape[0] * shards.shape[1]
    t0 = time.perf_counter()
    cap = wc.group_capacity(shards)
    oracle = wc.oracle(shards)
    print(f"group wordcount: capacity {cap} (the most tokens one worker "
          f"sends one partition; send buffers {shards.shape[0]} x "
          f"{shards.shape[0]} x {cap}) and the oracle in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    built = wc.group_pipeline(shards, cap).build(
        num_buckets=wc.VOCAB, n_workers=shards.shape[0], device="cuda",
        job_id=wc.NAME + "-group")
    shards_dev = torch.from_numpy(shards).to(built.device)
    hc.combine.launches = 0
    walls = []
    for _ in range(3):
        torch.cuda.reset_peak_memory_stats()
        wall, ((gk, gv, gvalid), stats) = _timed_run(torch, built,
                                                     shards_dev)
        walls.append(wall)
        if int(stats.dropped) or int(stats.sent) != n:
            raise AssertionError(f"group word count sent {int(stats.sent)} "
                                 f"of {n} tokens, dropped "
                                 f"{int(stats.dropped)}")
        keys = gk[gvalid].long()
        if keys.numel() != wc.VOCAB or torch.unique(keys).numel() \
                != wc.VOCAB:
            raise AssertionError(f"{keys.numel()} groups for {wc.VOCAB} "
                                 f"words")
        got = torch.zeros(wc.VOCAB, dtype=gv.dtype, device=gv.device)
        got[keys] = gv[gvalid]
        got = got.cpu()
        if not np.array_equal(got.numpy(), oracle) \
                or not torch.equal(got, combined):
            raise AssertionError("the group word count differs from the "
                                 "oracle or from hash_combine's counts")
    if hc.combine.launches:
        raise AssertionError(f"the combiner-off run launched hash_combine "
                             f"{hc.combine.launches} times")
    # the same reduction over real values: the card sums a key's segment
    # in its own fixed order, the CPU (and the reference) left to right
    from repro_torch.engine import stages
    keys = torch.sort(shards_dev[0, :, 0])[0]
    vals = torch.rand(keys.shape, generator=torch.Generator(
        device=keys.device).manual_seed(SEED), device=keys.device)
    starts = torch.cat([torch.ones(1, dtype=torch.int32, device=keys.device),
                        (keys[1:] != keys[:-1]).to(torch.int32)])
    card_sums = stages.segment_reduce("sum", keys, vals, starts)[1].cpu()
    cpu_sums = stages.segment_reduce("sum", keys.cpu(), vals.cpu(),
                                     starts.cpu())[1]
    differ = int((card_sums != cpu_sums).sum())
    rel = float(((card_sums - cpu_sums).abs()
                 / cpu_sums.abs().clamp(min=1e-30)).max())
    if rel > REAL_SUM_RTOL:
        raise AssertionError(f"real-valued segment sums: card vs CPU "
                             f"relative difference {rel:.3g} > "
                             f"{REAL_SUM_RTOL}")
    med = statistics.median(walls)
    print(f"group wordcount real-valued witness: worker 0's {keys.numel()} "
          f"sorted tokens with values uniform in [0, 1), segment_reduce "
          f"'sum' on the card against the CPU: {differ} of {wc.VOCAB} sums "
          f"differ bit-wise, max relative difference {rel:.3g} (limit "
          f"{REAL_SUM_RTOL})", flush=True)
    print(f"main-path {wc.NAME} combiner off (group mode): {n} tokens, "
          f"walls from device-resident shards "
          f"{[round(w, 4) for w in walls]} s (median {med:.4f} s = "
          f"{n / med:.0f} tokens/s) against phase 6b's combiner "
          f"{combined_wall:.4f} s ({med / combined_wall:.1f}x); 0 "
          f"hash_combine launches, 0 dropped; {wc.VOCAB} word counts == "
          f"np.bincount oracle == hash_combine's; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)


def _by_window(outputs) -> dict:
    """Sink objects keyed by their window (the job id taken out)."""
    return {key.rsplit("/", 1)[1]: blob for key, blob in outputs.items()}


def _drive_lav(torch, ops, lr, store, sinks, label, **build):
    """linear-road-lav over phase 3's log under another backend: its sinks
    must equal phase 3's window by window and every fold step must be one
    ``fused_fold`` launch.  Returns the built program and the report."""
    from repro_torch.core import MetadataStore
    from repro_torch.pipeline import RunOptions
    opts = lr.build_options(lr.FULL["n_xways"])
    opts.update(build)
    built = lr.lav_pipeline("linear-road/reports").build(
        job_id=f"linear-road-lav-{label}", **opts)
    ops.fold.launches = 0
    report = built.run(store=store, meta=MetadataStore(),
                       options=RunOptions(overlap=True))
    launches = ops.fold.launches
    if report.error is not None:
        raise AssertionError(f"{label}: {report.error}")
    got = _by_window(built.collect_outputs(store))
    if got != _by_window(sinks):
        bad = sorted(k for k in set(got) | set(_by_window(sinks))
                     if got.get(k) != _by_window(sinks).get(k))[:3]
        raise AssertionError(f"{label}: sinks differ from the fused run's "
                             f"at {bad}")
    if launches != report.folds or report.folds < report.batches:
        raise AssertionError(f"{label}: fused_fold launched {launches} "
                             f"times for {report.folds} fold steps")
    print(f"backends {label} linear-road-lav: {report.records_in} records "
          f"in {report.wall_time:.3f} s = {report.records_per_sec:.0f} "
          f"records/s; {len(got)} windows == the fused run's; "
          f"{report.folds} fold steps, {launches} fused_fold launches",
          flush=True)
    return built, report


def _step_times(torch, ops, step, rows, carry, minw,
                host_calls: int = 1000) -> dict:
    """One plan's fold step at the main shape: CUDA-event median, host time
    a call (``perf_counter`` over ``host_calls`` calls, then a
    synchronize), and per call the ``fused_fold`` launches and the
    caching allocator's allocations (a copy of the carry or the wire would
    be one more)."""
    def fn():
        return step(rows, carry, minw)
    ms = _median_ms(fn)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    launches = ops.fold.launches
    t0 = time.perf_counter()
    for _ in range(host_calls):
        fn()
    host_us = (time.perf_counter() - t0) / host_calls * 1e6
    torch.cuda.synchronize()
    return {"ms": ms, "host_us": host_us,
            "launches": (ops.fold.launches - launches) / host_calls,
            "allocs": (torch.cuda.memory_stats().get(
                "allocation.all.allocated", 0) - allocs) / host_calls}


def _profiled_steps(torch, steps: dict, reps: int = REPS) -> dict:
    """Every step of ``steps`` (label → call) ``reps`` times inside
    ``record_function(label)`` ranges of ONE torch.profiler session (CPU
    and CUDA; a later session in a long process has been seen to record
    nothing): per label the device records a call (matched to the calls
    by CUPTI correlation id, ``_launched_in``), their names and their
    device time a call.  Each step also runs ``reps`` times unlabelled at
    the session's start: the trace's first milliseconds have come back
    without device records."""
    from torch.profiler import ProfilerActivity, profile, record_function
    for fn in steps.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in steps.values():
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
        for label, fn in steps.items():
            for _ in range(reps):
                with record_function(label):
                    fn()
            torch.cuda.synchronize()
    out = {}
    for label in steps:
        inside, n_ranges, _ = _launched_in(prof, label)
        out[label] = {"records": len(inside) / max(n_ranges, 1),
                      "names": sorted({ev.name()[:48] for ev in inside}),
                      "device_us": sum(ev.duration_ns() for ev in inside)
                      / 1e3 / max(n_ranges, 1)}
    return out


def _times_text(t, d=None) -> str:
    text = (f"{t['ms']:.4f} ms a step (events), host {t['host_us']:.1f} us "
            f"a call, {t['launches']:g} fused_fold launch(es) and "
            f"{t['allocs']:g} allocation(s) a call")
    if d is not None:
        text += (f", device {d['device_us']:.2f} us in {d['records']:g} "
                 f"record(s) {d['names']}")
    return text


class _Collectives:
    """Counts the ``torch.distributed`` calls the worker axis makes while
    it is entered (the module attributes are swapped for counting
    wrappers, and put back on exit)."""

    NAMES = ("all_to_all_single", "all_gather", "all_reduce")

    def __init__(self, dist):
        self.dist = dist
        self.counts = dict.fromkeys(self.NAMES, 0)

    def __enter__(self):
        self.saved = {n: getattr(self.dist, n) for n in self.NAMES}
        for name, fn in self.saved.items():
            def counted(*args, _fn=fn, _name=name, **kwargs):
                self.counts[_name] += 1
                return _fn(*args, **kwargs)
            setattr(self.dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)


def phase_backends(torch, ops, hc, lr, wc, store, sinks, shards, counts,
                   device) -> None:
    """Phase 21: ``backend="vmap"`` and ``backend="shard_map"`` (a world of
    one NCCL rank) on the card, each against the fused runs of phases 3
    and 6b."""
    import tempfile

    import torch.distributed as dist
    n_workers = lr.build_options(lr.FULL["n_xways"])["n_workers"]
    fused_built = lr.lav_pipeline("linear-road/reports").build(
        device=device, job_id="linear-road-lav-steps",
        **lr.build_options(lr.FULL["n_xways"]))
    vmap_built, _ = _drive_lav(torch, ops, lr, store, sinks, "vmap",
                               device=device, backend="vmap")
    rows, carry, _nb = lr_batch(torch, lr, device)
    minw = -(2 ** 31)
    fused = fused_built.stages[0].sides[0].compiled
    vmapped = vmap_built.stages[0].sides[0].compiled
    vrows = rows.view(n_workers, -1, rows.shape[1])
    vcarry = vmapped.init_carry()
    fcarry = carry.clone()
    ptr = vcarry.data_ptr()
    ft = _step_times(torch, ops, fused.step, rows, fcarry, minw)
    vt = _step_times(torch, ops, vmapped.step, vrows, vcarry, minw)
    out, _ = vmapped.step(vrows, vcarry, minw)
    if out is not vcarry or vcarry.data_ptr() != ptr:
        raise AssertionError("the vmap step did not fold in place")
    if vt["launches"] != 1 or vt["allocs"] != ft["allocs"]:
        raise AssertionError(f"a vmap fold step made {vt['launches']} "
                             f"fused_fold launches and {vt['allocs']} "
                             f"allocations (fused: {ft['allocs']}): not one "
                             f"launch without a copy")

    root = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{root}/pg",
                            rank=0, world_size=1)
    try:
        with _Collectives(dist) as coll:
            data = torch.from_numpy(shards.reshape(-1, shards.shape[-1]))
            built = wc.pipeline(shards).build(
                num_buckets=wc.VOCAB, n_workers=1, device=device,
                backend="shard_map", job_id=f"{wc.NAME}-shard_map")
            hc.combine.launches = 0
            wall, (got, stats) = _timed_run(torch, built, data)
            launches = hc.combine.launches
            if launches != 1:
                raise AssertionError(f"shard_map word count: {launches} "
                                     f"hash_combine launches, not 1")
            if not torch.equal(got.cpu(), counts):
                raise AssertionError("shard_map word counts differ from "
                                     "phase 6b's")
            if int(stats.sent) != data.shape[0]:
                raise AssertionError(f"shard_map sent {int(stats.sent)}")
            wall2, (got2, _) = _timed_run(torch, built, data)
            if not torch.equal(got2.cpu(), counts):
                raise AssertionError("a second shard_map word count "
                                     "differs")
            print(f"backends shard_map (world of 1, NCCL) {wc.NAME}: "
                  f"{data.shape[0]} tokens in {wall:.4f} s, then "
                  f"{wall2:.4f} s (host data handed over; the first run's "
                  f"first collective also sets NCCL up); counts == phase "
                  f"6b's; {launches} hash_combine launch a run; "
                  f"collectives {coll.counts} over the two runs",
                  flush=True)
        with _Collectives(dist) as coll:
            sm_built, report = _drive_lav(
                torch, ops, lr, store, sinks, "shard_map", device=device,
                backend="shard_map", n_workers=1)
            print(f"backends shard_map linear-road-lav collectives "
                  f"{coll.counts} ({report.folds} fold steps, "
                  f"{report.windows_emitted} windows)", flush=True)
        sharded = sm_built.stages[0].sides[0].compiled
        scarry = sharded.init_carry()
        st = _step_times(torch, ops, sharded.step, rows, scarry, minw)
        prof = _profiled_steps(torch, {
            "fused step": lambda: fused.step(rows, fcarry, minw),
            "vmap step": lambda: vmapped.step(vrows, vcarry, minw),
            "shard_map step": lambda: sharded.step(rows, scarry, minw)})
    finally:
        dist.destroy_process_group()
    pf, pv = prof["fused step"], prof["vmap step"]
    if pf["records"] and (round(pv["records"]) != 1 or not all(
            "fold_kernel" in n for n in pv["names"])):
        raise AssertionError(f"a vmap fold step put {pv['records']:g} "
                             f"records on the card ({pv['names']}), not the "
                             f"one fold kernel")
    traced = "" if pf["records"] else (" (the trace recorded no device "
                                       "record: device time not measured)")
    print(f"backends fold step at the main shape ({tuple(rows.shape)} wire, "
          f"{n_workers} workers): fused {_times_text(ft, pf)}; vmap "
          f"{_times_text(vt, pv)}, carry {tuple(vcarry.shape)} folded in "
          f"place{traced}", flush=True)
    print(f"backends fold step at the main shape, world of 1: shard_map "
          f"{_times_text(st, prof['shard_map step'])}; the partial, "
          f"reduce-scatter and stats all_reduce add "
          f"{st['ms'] - ft['ms']:.4f} ms a step (events), "
          f"{st['host_us'] - ft['host_us']:.1f} us of host", flush=True)


# ---------------------------------------------------------------------------
# Phases 22-23: mixture-of-experts serving (qwen2-moe-a2.7b, mixtral-8x7b)
# ---------------------------------------------------------------------------

#: the MoE layer's parts, each a module-level function of
#: ``repro_torch.models.moe`` that ``_moe_split`` puts in a profiler range
MOE_PARTS = {"_route": "router", "_dispatch": "dispatch",
             "_experts": "expert GEMMs", "_combine": "combine",
             "_shared_expert": "shared expert"}


def _moe_config(spec):
    """The phase's configuration: the published one, its depth cut to
    ``spec["layers"]`` where that is set."""
    from repro_torch import configs
    cfg = configs.get(spec["arch"])
    return cfg.replace(n_layers=spec["layers"]) if spec["layers"] else cfg


def _no_drop(cfg):
    """``cfg`` at capacity_factor E / k: cap >= the tokens of any call, so
    no pair drops (the witness of prefill against decode)."""
    return cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)


def _expert_bytes(cfg) -> int:
    """The routed experts' weight bytes: what one decode step of the
    reference's formulation reads, every expert over its capacity rows."""
    return (cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.expert_d_ff
            * cfg.param_dtype_.itemsize)


class _MoeProbe:
    """Wraps ``moe._route`` and ``moe._dispatch`` while a phase runs.
    Counts each call's dropped pairs (device tensors, read after the
    run); records each call's expert choices where ``record`` is set;
    and, while ``replay`` holds choices, routes each call to the next of
    them — the router's probabilities of this call gathered at those
    experts and renormalised as ``_route`` does — so that two paths whose
    activations differ by rounding route every token alike.  Never on a
    timed run: each call adds launches."""

    def __init__(self, moe_mod):
        self.moe = moe_mod
        self.route, self.dispatch = moe_mod._route, moe_mod._dispatch
        self.record, self.replay = False, []
        self.routes, self.drops = [], []

    def __enter__(self):
        def route(router_w, x_flat, cfg):
            weights, experts, aux = self.route(router_w, x_flat, cfg)
            if self.replay:
                chosen = self.replay.pop(0)
                if chosen.shape != experts.shape:
                    raise AssertionError(f"replayed routes "
                                         f"{tuple(chosen.shape)} for "
                                         f"{tuple(experts.shape)}")
                probs = (x_flat.float() @ router_w).softmax(dim=-1)
                weights = probs.gather(1, chosen)
                weights = weights / weights.sum(dim=-1, keepdim=True) \
                    .clamp(min=1e-9)
                experts = chosen
            if self.record:
                self.routes.append(experts)
            return weights, experts, aux

        def dispatch(x, weights, experts, e, cap):
            out = self.dispatch(x, weights, experts, e, cap)
            self.drops.append(experts.numel() - out.buf_valid.sum())
            return out

        self.moe._route, self.moe._dispatch = route, dispatch
        return self

    def __exit__(self, *exc):
        self.moe._route, self.moe._dispatch = self.route, self.dispatch

    def take_drops(self) -> list:
        """The dropped pairs of each call since the last take."""
        out = [int(d) for d in self.drops]
        self.drops = []
        return out

    def take_routes(self) -> list:
        out, self.routes = self.routes, []
        return out


def _range_split(torch, fn, label, parts, kernels) -> dict:
    """One call of ``fn`` under torch.profiler with each of ``parts`` —
    (module, attribute, range name): the function ``module.attribute``
    run inside ``record_function(range name)`` — in its own range: the
    device time and records each range's CUDA calls launched
    (``_launched_in``), then the records of ``kernels`` (names) outside
    every range, and the rest; the host wall and the busy share.  Returns
    {name: (ms, records)}, with the records of each of ``kernels``
    (wherever they were launched) that a CUDA call of the host queued —
    matched by CUPTI correlation id, as ``_launched_in`` matches them —
    under ``("launches", name)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(f, name):
        def call(*a, **k):
            with record_function(name):
                return f(*a, **k)
        return call

    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in parts]
    for (mod, attr, name), (_, _, f) in zip(parts, saved):
        setattr(mod, attr, ranged(f, name))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for mod, attr, f in saved:
            setattr(mod, attr, f)
    ranges = list(dict.fromkeys(name for _, _, name in parts))
    split, seen = {}, set()
    events = prof.profiler.kineto_results.events()
    on_device = []
    for name in ranges:
        inside, _, on_device = _launched_in(prof, name, events)
        split[name] = (sum(ev.end_ns() - ev.start_ns() for ev in inside)
                       / 1e6, len(inside))
        seen.update(id(ev) for ev in inside)
    on_device = [ev for ev in on_device if ev.name() not in ranges
                 and ev.device_type() == DeviceType.CUDA]
    attn = [ev for ev in on_device if id(ev) not in seen and any(
        k in ev.name() for k in kernels)]
    split["attention kernels"] = (
        sum(ev.end_ns() - ev.start_ns() for ev in attn) / 1e6, len(attn))
    total = sum(ev.end_ns() - ev.start_ns() for ev in on_device) / 1e6
    split["other"] = (total - sum(ms for ms, _ in split.values()),
                      len(on_device) - sum(c for _, c in split.values()))
    print(f"{label} under torch.profiler: wall {wall * 1e3:.3f} ms, device "
          f"work {total:.3f} ms = {100 * total / 1e3 / wall:.1f}% busy, "
          f"{len(on_device)} device records; split: " + "; ".join(
              f"{name} {ms:.3f} ms ({n})" for name, (ms, n) in split.items()),
          flush=True)
    launched = {ev.correlation_id() for ev in events
                if ev.device_type() == DeviceType.CPU
                and ev.name().startswith("cu")}
    launched.discard(0)
    for k in kernels:
        split[("launches", k)] = sum(k in ev.name() and ev.correlation_id()
                                     in launched for ev in on_device)
    return split


def _moe_split(torch, fn, label) -> None:
    """One call of ``fn`` under torch.profiler with each MoE part in its
    own range, and ``unembed`` in one (``_range_split``): the device time
    of the records each range's CUDA calls launched, the attention
    kernels' by name, the rest; the host wall and the busy share."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf_mod
    parts = [(moe_mod, n, f"moe {part}") for n, part in MOE_PARTS.items()]
    _range_split(torch, fn, label, parts + [(tf_mod, "unembed", "unembed")],
                 ("fwd_wgmma", "fwd_rows", "decode_cluster"))


def _down_product_check(torch, moe_mod, cfg, lp, xb, label) -> None:
    """``_experts`` on one layer's real buffers keeps the down product in
    float32, as the reference's ``preferred_element_type`` does: its
    output is float32 and within ``MOE_DOWN_REL_L2`` of the float32
    product of the same bfloat16 operands, and that same product rounded
    to bfloat16 (the fault this check is for) must fall outside it."""
    from repro_torch.models.layers import _act
    cd = cfg.compute_dtype_
    xe = xb.to(cd)
    hid = _act(cfg.activation, torch.bmm(xe, lp["w_gate"].to(cd))) * \
        torch.bmm(xe, lp["w_up"].to(cd))
    want = torch.bmm(hid.float(), lp["w_down"].float())
    del hid
    yb = moe_mod._experts(lp, xe, cfg)
    gap = float((yb.float() - want).norm() / want.norm())
    rounded = float((want.to(cd).float() - want).norm() / want.norm())
    print(f"{label}: the expert GEMMs' output is {yb.dtype}; relative L2 "
          f"{gap:.3g} against the float32 product of the same "
          f"{cd} operands (limit {MOE_DOWN_REL_L2}); a {cd}-rounded "
          f"product reads {rounded:.3g}", flush=True)
    if yb.dtype != torch.float32 or gap > MOE_DOWN_REL_L2 or \
            rounded <= MOE_DOWN_REL_L2:
        raise AssertionError(f"{label}: the down product is {yb.dtype} at "
                             f"relative L2 {gap:.3g} (a rounded one reads "
                             f"{rounded:.3g}; limit {MOE_DOWN_REL_L2})")


def _moe_layer_checks(torch, moe_mod, cfg, lp, h, label) -> None:
    """One MoE layer's real input ``h`` (captured in the prefill): the
    dispatch on the card against the CPU's bit for bit given the same
    routing, two calls bit for bit, and the bfloat16 layer against the
    same layer in float32 on the same input (identical routing)."""
    d, e = cfg.d_model, cfg.n_experts
    flat = h.reshape(-1, d)
    t = flat.shape[0]
    cap = moe_mod.expert_capacity(cfg, t)
    weights, experts, _ = moe_mod._route(lp["router"], flat, cfg)
    shape = (1, t, cfg.top_k)
    card = moe_mod._dispatch(flat[None], weights.reshape(shape),
                             experts.reshape(shape), e, cap)
    host = moe_mod._dispatch(flat[None].cpu(), weights.reshape(shape).cpu(),
                             experts.reshape(shape).cpu(), e, cap)
    differ = [name for name, a, b in zip(card._fields, card, host)
              if not torch.equal(a.cpu(), b)]
    counts = torch.bincount(experts.flatten(), minlength=e)
    kept = card.buf_valid.view(e, cap).sum(dim=1)
    drops = (counts - kept).cpu()
    host_drops = (torch.bincount(experts.flatten().cpu(), minlength=e)
                  - host.buf_valid.view(e, cap).sum(dim=1))
    print(f"{label}: dispatch of {t} tokens x top-{cfg.top_k} into {e} "
          f"experts x cap {cap}: card vs CPU "
          f"{'equal bit for bit' if not differ else f'DIFFER in {differ}'}"
          f" (buf_tok, buf_valid, buf_w, pair_slot, xb); {int(drops.sum())} "
          f"pairs dropped, by expert (nonzero) "
          f"{ {i: int(v) for i, v in enumerate(drops.tolist()) if v} }; "
          f"tokens a expert min / max {int(counts.min())} / "
          f"{int(counts.max())}", flush=True)
    if differ or not torch.equal(drops, host_drops):
        raise AssertionError(f"{label}: the card's dispatch differs from "
                             f"the CPU's in {differ or ['drops']}")
    del host
    _down_product_check(torch, moe_mod, cfg, lp, card.xb[0], label)
    del card
    y, aux = moe_mod.moe_forward(lp, h, cfg)
    again, _ = moe_mod.moe_forward(lp, h, cfg)
    f32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    lp32 = {k: ({kk: vv.float() for kk, vv in v.items()}
                if isinstance(v, dict) else v.float()) for k, v in lp.items()}
    _, experts32, _ = moe_mod._route(lp32["router"], flat.float(), f32)
    y32, aux32 = moe_mod.moe_forward(lp32, h.float(), f32)
    del lp32
    rel = float((y.float() - y32).norm() / y32.norm())
    same_route = torch.equal(experts, experts32)
    print(f"{label}: two bfloat16 calls "
          f"{'equal bit for bit' if torch.equal(y, again) else 'DIFFER'}; "
          f"bfloat16 layer vs float32 layer on the same input: routing "
          f"{'identical' if same_route else 'DIFFERS'}, max |diff| "
          f"{float((y.float() - y32).abs().max()):.4g} at RMS "
          f"{float(y32.norm()) / y32.numel() ** 0.5:.4g}, relative L2 "
          f"{rel:.3g} (limit {MOE_LAYER_REL_L2}); aux {float(aux):.6g} / "
          f"{float(aux32):.6g}", flush=True)
    if not torch.equal(y, again) or not same_route or \
            rel > MOE_LAYER_REL_L2:
        raise AssertionError(f"{label}: repeat calls, routing or the "
                             f"bfloat16 layer (relative L2 {rel:.3g}) failed")


def phase_moe(torch, fa, fa_ref, fd_ref, device, spec):
    """Phases 22-23: a mixture-of-experts model at full width — the main
    path's launches and times, drops per layer in an untimed run, the
    attention kernels on one layer's captured inputs, one MoE layer's
    dispatch and output checked on its captured input, and prefill-vs-
    decode and kernel-vs-plain logits at a capacity where nothing drops,
    with the plain prefill's expert choices replayed on every path (a
    rounding difference near a routing tie would otherwise move a token
    to another expert; the free-routing gap and flips are printed).
    Returns (params, cfg)."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decode_step, prefill_forward
    from repro_torch.models import moe as moe_mod

    cfg = _moe_config(spec)
    tag = cfg.name
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, toks = _lm_inputs(torch, cfg, spec, SEED, device)
    torch.cuda.synchronize()
    full = _moe_config(dict(spec, layers=None))
    print(f"{tag}: {cfg.n_layers} of {full.n_layers} layers at full width "
          f"(d_model {cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} kv "
          f"heads of {cfg.head_dim_}, {cfg.n_experts} experts top-"
          f"{cfg.top_k} of d_ff {cfg.expert_d_ff}, {cfg.n_shared_experts} "
          f"shared slices, window {cfg.sliding_window or 0}; "
          f"{cfg.n_params()} of {full.n_params()} parameters, "
          f"{cfg.param_dtype}) with random weights from seed {SEED} in "
          f"{time.perf_counter() - t0:.1f} s; capacity_factor "
          f"{cfg.capacity_factor}", flush=True)
    n, steps = spec["prompt"], spec["decode_steps"]
    max_len = n + steps

    # the main path at the published capacity factor, layer 0 captured
    run = _lm_main_path(torch, fa, params, toks, cfg, spec, tag, 1)

    # drops per layer, in an untimed prefill and decode step
    with _MoeProbe(moe_mod) as probe:
        last, cache = prefill_forward(params, toks, cfg, max_len)
        decode_step(params, cache, last.argmax(dim=-1, keepdim=True), cfg)
        drops = probe.take_drops()
    del cache
    prefill_drops, decode_drops = drops[:cfg.n_layers], drops[cfg.n_layers:]
    if len(decode_drops) != cfg.n_layers:
        raise AssertionError(f"{tag}: {len(drops)} MoE calls for a prefill "
                             f"and a decode step of {cfg.n_layers} layers")
    pairs = n * cfg.top_k * cfg.n_layers
    print(f"{tag}: prefill pairs dropped per layer at capacity_factor "
          f"{cfg.capacity_factor} (cap {moe_mod.expert_capacity(cfg, n)} "
          f"of {n * cfg.top_k} pairs over {cfg.n_experts} experts): "
          f"{prefill_drops} = {sum(prefill_drops)} of {pairs} "
          f"({100 * sum(prefill_drops) / pairs:.2f}%); a decode step "
          f"{sum(decode_drops)} (cap {moe_mod.expert_capacity(cfg, 1)})",
          flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_forward(params, toks[:, :-1], cfg, max_len)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"{tag}: warm prefill of {n - 1} tokens at capacity_factor "
          f"{cfg.capacity_factor} in {warm_s:.4f} s = "
          f"{(n - 1) / warm_s:.0f} tokens/s", flush=True)

    # the kernels and one MoE layer on layer 0's captured inputs
    _kernel_cases(torch, fa, fa_ref, fd_ref, run, tag)
    lp, h = run.pop("moe")[0]
    _moe_layer_checks(torch, moe_mod, cfg, lp, h, f"{tag} layer 0 MoE")
    del lp, h, run
    torch.cuda.empty_cache()

    # the witness at a capacity where nothing drops.  The plain prefill's
    # expert choices are recorded and replayed on every other path (the
    # plain witness's shorter prefill and decode step, the kernel prefill,
    # shorter prefill and decode step, the plain decode on the kernel's
    # cache); the kernel prefill is also run with free routing, and its
    # flips and gap printed
    wcfg = _no_drop(cfg)
    calls = attn_mod.attention, attn_mod.decode_attention
    with _MoeProbe(moe_mod) as probe:
        plain_last, plain_via = _plain_witness(fa_ref, fd_ref, params, wcfg,
                                               toks, max_len, probe)
        routes = probe.take_routes()
        probe.record = True
        free_last = prefill_forward(params, toks, wcfg, max_len)[0]
        probe.record = False
        free_routes = probe.take_routes()
        probe.replay = list(routes)
        last = prefill_forward(params, toks, wcfg, max_len)[0]
        probe.replay = [r[:-1] for r in routes]
        _, short = prefill_forward(params, toks[:, :-1], wcfg, max_len)
        probe.replay = [r[-1:] for r in routes]
        via_decode = decode_step(params, short, toks[:, -1:], wcfg)[0]
        probe.replay = [r[-1:] for r in routes]
        attn_mod.attention, attn_mod.decode_attention = fa_ref, fd_ref
        try:
            plain_dec = decode_step(params, short, toks[:, -1:], wcfg)[0]
        finally:
            attn_mod.attention, attn_mod.decode_attention = calls
        witness_drops = probe.take_drops()
        unused = len(probe.replay)
    flips = [int((a != b).sum()) for a, b in zip(free_routes, routes)]
    print(f"{tag}: free routing — (token, slot) choices that differ between "
          f"the kernel and the plain {n}-token prefill, per layer: {flips} "
          f"(of {n * cfg.top_k} a layer); {sum(witness_drops)} pairs "
          f"dropped over the {len(witness_drops)} MoE calls of the witness "
          f"runs at capacity_factor {wcfg.capacity_factor:g}", flush=True)
    free = (free_last - plain_last).abs()
    print(f"{tag} logits, prefill of {n} tokens, kernel vs plain with free "
          f"routing (a reading, not a check): max |diff| "
          f"{float(free.max()):.4g}, relative L2 "
          f"{float(free.norm() / plain_last.norm()):.3g}", flush=True)
    tol, failures = MOE_LOGIT_TOL[spec["arch"]], []
    if sum(witness_drops) or unused:
        failures.append(f"{sum(witness_drops)} pairs dropped at "
                        f"capacity_factor {wcfg.capacity_factor:g}, "
                        f"{unused} replayed routes unused")
    _witness_gaps(torch, tag, n, tol, via_decode, last, plain_via,
                  plain_last, plain_dec, failures)
    if failures:
        raise AssertionError("; ".join(failures))

    # where the time goes: the decode step and a prefill, split by part
    _moe_split(torch, lambda: decode_step(params, short, toks[:, -1:], wcfg),
               f"{tag}: one decode step (B=1, cache {n - 1})")
    step = lambda: decode_step(params, short, toks[:, -1:], wcfg)  # noqa: E731
    events = _profile_step(torch, step, f"{tag}: the same step")
    _one_decode_kernel_a_layer(torch, events, step, cfg, tag)
    del short
    _moe_split(torch, lambda: prefill_forward(params, toks[:, :-1], cfg,
                                              max_len),
               f"{tag}: one prefill of {n - 1} tokens at capacity_factor "
               f"{cfg.capacity_factor}")
    return params, cfg


def phase_moe_serving(torch, fa, params, cfg, device) -> None:
    """Phase 22's serving: BatchedServer on qwen2-moe-a2.7b."""
    fa.attention.launches = 0
    fa.decode_attention.launches = 0
    server, run = _serve_requests(torch, params, cfg, device, SEED + 22)
    fwd, dec = fa.attention.launches, fa.decode_attention.launches
    decode_steps = run["batched"] + run["admit_steps"]
    if dec != cfg.n_layers * decode_steps or fwd != 0:
        raise AssertionError(f"{cfg.name} serving: {dec} decode launches "
                             f"for {decode_steps} decode steps, {fwd} "
                             f"forward launches for no prefill")
    print(f"{cfg.name} serving: {_serve_text(cfg, run)}; {dec} flash decode "
          f"launches (= {cfg.n_layers} x {decode_steps}), {fwd} flash "
          f"forward launches", flush=True)


# ---------------------------------------------------------------------------
# phase 24: training
# ---------------------------------------------------------------------------

#: phase 24's run: gemma2-9b at full width, its depth cut (``layers``);
#: the gradient checks at one layer, on a short sequence (``grad_seq``)
#: against the CPU and at the main path's shape on the card; the restart
#: at one layer (``restart_*``); the NCCL world of one at the reduced width
TRAIN = {"arch": "gemma2-9b", "phase": 24, "layers": 4, "batch": 1,
         "seq": 4096, "steps": 6, "mb_steps": 2, "microbatches": 2,
         "peak_lr": 1e-4, "warmup": 2, "corpus_words": 200_000,
         "grad_seq": 256, "wq_boost": 8.0, "restart_steps": 4,
         "preempt_at": 2, "ckpt_every": 5}
#: the gradient checks' limit: the loss's relative gap and each leaf's
#: relative L2 error may be at most this many times that quantity's own
#: floor (the plain version's gap to the same reference)
GRAD_FLOOR_FACTOR = 2.0


def _leaf_names(tree, prefix="") -> list:
    """Dotted paths of ``tree``'s leaves in ``optim.tree.tree_leaves``
    order (dict keys sorted, list indices in order)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _train_batches(cfg, batch, seq, seed):
    """The reference's synthetic corpus through the training data
    pipeline: ``make_store_with_corpus`` → ``PackedLMDataset`` →
    ``Prefetcher``."""
    from repro_torch.data import (HashTokenizer, PackedLMDataset,
                                  Prefetcher, make_store_with_corpus)
    store, prefix = make_store_with_corpus(TRAIN["corpus_words"], seed=seed)
    return Prefetcher(iter(PackedLMDataset(
        store, prefix, HashTokenizer(cfg.vocab), batch=batch, seq_len=seq,
        seed=seed)))


def _grads(torch, params, batch, cfg):
    """(loss, every gradient leaf) of ``models.loss_fn``."""
    from repro_torch.models import loss_fn
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.runtime.train_step import value_and_grad
    (loss, _), grads = value_and_grad(loss_fn, params, batch, cfg)
    return float(loss), tree_leaves(grads)


def _gaps(torch, got, want) -> list:
    """The loss's relative gap, then each leaf's ``||got - want|| /
    ||want||`` in float64 on ``got``'s device (``want`` moved there a
    leaf at a time); ``got`` and ``want`` are ``_grads`` results."""
    out = [abs(got[0] - want[0]) / abs(want[0])]
    for g, w in zip(got[1], want[1]):
        w = w.to(g.device, torch.float64)
        out.append(float((g.double() - w).norm() / w.norm().clamp(
            min=1e-30)))
    return out


def _hold_grads(label, names, floor, checked: dict, fault) -> list:
    """Print the loss's and every leaf's floor, limit (GRAD_FLOOR_FACTOR x
    its own floor), each checked path's gap and the planted fault's; a
    checked gap over its limit, or a fault inside every limit, is a
    failure."""
    failures, caught = [], []
    for i, name in enumerate(["loss"] + names):
        limit = GRAD_FLOOR_FACTOR * floor[i]
        cells = "  ".join(f"{k} {v[i]:.3e}" for k, v in checked.items())
        print(f"  {name:28s} floor {floor[i]:.3e}  limit {limit:.3e}  "
              f"{cells}  fault {fault[i]:.3e}")
        failures += [f"{label}: {k} {name} {v[i]:.3e} > {limit:.3e}"
                     for k, v in checked.items() if not v[i] <= limit]
        if fault[i] > limit:
            caught.append(name)
    print(f"  the planted fault (no softcap in the backward) falls outside "
          f"the limit at {caught}", flush=True)
    if not caught:
        failures.append(f"{label}: the planted fault (no softcap in the "
                        f"backward) passed every limit")
    return failures


def _train_grad_check(torch, fa, fa_ref, cfg, device) -> list:
    """The gradient at one layer of the full widths, bfloat16, in two
    checks; the card's path is ``fwd_wgmma`` forward and the chunked
    backward, and a planted fault — a backward that drops the softcap —
    must fall outside a limit in each.  The layer's q projection is drawn
    ``wq_boost`` times larger, so that the scores reach the softcap's
    curve (unit-variance random weights give scores of ~N(0, 1), where
    tanh(s/50) is linear and no check could see it).

    1. ``grad_seq`` tokens (one block of keys) against the CPU's plain
       autograd of the same parameters; the floor is the plain version on
       the card against the CPU (the same function, other GEMMs).
    2. The main path's shape, B = 1 and S = ``seq`` (``cfg.attn_chunk``
       keys a block: four blocks, and the online softmax's rescaling
       between them in the backward), on the card, against the plain
       version in float32 (the parameters upcast) with the keys in one
       block — one softmax, no rescaling; the floor is the plain version
       in bfloat16 with the keys in one block.  Checked: the kernel path
       and the plain version in blocks (the main path's plain gradient)."""
    from unittest import mock
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import init_params
    from repro_torch.optim.tree import tree_map
    one = cfg.replace(n_layers=1)
    params = init_params(SEED, one, device=device)
    params["layers"][0]["attn"]["wq"] = \
        params["layers"][0]["attn"]["wq"] * TRAIN["wq_boost"]
    names = _leaf_names(params)
    rng = np.random.default_rng(SEED + TRAIN["phase"])
    failures, want_launches = [], 2 if one.remat else 1

    def no_softcap(*args, **kw):
        return fa_ref(*args, **dict(kw, softcap=None))

    def kernel_runs(batch):
        """The kernel path's (loss, gradient), its forward launches, and
        the planted fault's (loss, gradient)."""
        before = fa.attention.launches
        got = _grads(torch, params, batch, one)
        launches = fa.attention.launches - before
        with mock.patch.object(fa, "chunked_attention", no_softcap):
            faulty = _grads(torch, params, batch, one)
        if launches != want_launches:
            failures.append(f"a checked step made {launches} forward "
                            f"launches, not {want_launches} (remat "
                            f"{one.remat}: the forward and the recompute)")
        return got, launches, faulty

    toks = rng.integers(0, cfg.vocab, (1, TRAIN["grad_seq"] + 1))
    batch = {"inputs": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    on_card = {k: v.to(device) for k, v in batch.items()}
    t0 = time.perf_counter()
    want = _grads(torch, tree_map(lambda t: t.cpu(), params), batch, one)
    want = (want[0], [w.float() for w in want[1]])
    cpu_s = time.perf_counter() - t0
    got, launches, faulty = kernel_runs(on_card)
    kernel, fault = _gaps(torch, got, want), _gaps(torch, faulty, want)
    k_loss = got[0]
    del got, faulty
    with mock.patch.object(attn_mod, "attention", fa_ref):
        plain = _grads(torch, params, on_card, one)
    print(f"{cfg.name} train, gradient check 1: 1 layer at full width, "
          f"{TRAIN['grad_seq']} tokens, bfloat16, wq x"
          f"{TRAIN['wq_boost']:g}, against the CPU's plain autograd "
          f"({cpu_s:.1f} s); loss card {k_loss:.6f}, card "
          f"plain {plain[0]:.6f}, CPU {want[0]:.6f}; {launches} forward "
          f"launch(es); floor: the card's plain version", flush=True)
    failures += _hold_grads("gradient check 1", names,
                            _gaps(torch, plain, want), {"kernel": kernel},
                            fault)
    del plain, want

    s = TRAIN["seq"]
    toks = rng.integers(0, cfg.vocab, (1, s + 1))
    on_card = {"inputs": torch.from_numpy(toks[:, :-1]).to(device),
               "labels": torch.from_numpy(toks[:, 1:]).to(device)}
    f32 = one.replace(param_dtype="float32", compute_dtype="float32",
                      attn_chunk=s)
    with mock.patch.object(attn_mod, "attention", fa_ref):
        want = _grads(torch, tree_map(lambda t: t.float(), params),
                      on_card, f32)
        floor = _gaps(torch, _grads(torch, params, on_card,
                                    one.replace(attn_chunk=s)), want)
        blocks = _gaps(torch, _grads(torch, params, on_card, one), want)
    got, launches, faulty = kernel_runs(on_card)
    kernel, fault = _gaps(torch, got, want), _gaps(torch, faulty, want)
    print(f"{cfg.name} train, gradient check 2: 1 layer at full width, "
          f"B = 1, S = {s} (the main path's shape), bfloat16, wq x"
          f"{TRAIN['wq_boost']:g}, on the card; keys in blocks of "
          f"{one.attn_chunk} ({-(-s // one.attn_chunk)} blocks) against the "
          f"plain version in float32 with the keys in one block; loss "
          f"kernel {got[0]:.6f}, float32 {want[0]:.6f}; {launches} forward "
          f"launch(es); floor: the plain version in bfloat16, keys in one "
          f"block", flush=True)
    failures += _hold_grads("gradient check 2", names, floor,
                            {"kernel": kernel, "plain in blocks": blocks},
                            fault)
    return failures


def _step_walls(log) -> list:
    """Per-step walls (s) from a Trainer's cumulative ``steps_per_s``,
    logged every step."""
    ends = [m["step"] / m["steps_per_s"] for m in log]
    return [b - a for a, b in zip([0.0] + ends[:-1], ends)]


def _ckpt_text(timings) -> str:
    """A checkpointer's saves: bytes, snapshot ms and write s each."""
    return ", ".join(f"step {t['step']}: {t['bytes'] / 1e9:.2f} GB, "
                     f"snapshot {t['snapshot_s'] * 1e3:.0f} ms, write "
                     f"{t.get('write_s', float('nan')):.2f} s"
                     for t in timings)


def _train_restart(torch, cfg, device) -> list:
    """Restart at one layer of the full widths (bfloat16): an
    uninterrupted run of ``restart_steps`` (the Trainer's step function on
    the same batches, with no checkpoint); a Trainer preempted at
    ``preempt_at`` with a checkpoint every ``ckpt_every`` steps; a fresh
    Trainer resumed from its bfloat16 checkpoint — whose losses and
    parameters, moments, count and step must equal the uninterrupted
    run's bit for bit.  Prints every checkpoint's snapshot and write times
    and the resume's (the restore's) time."""
    from repro_torch.core.storage import MemoryStore
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.runtime import (PreemptionError, Trainer,
                                     TrainerConfig, init_train_state,
                                     make_train_step)
    one = cfg.replace(n_layers=1)
    n, at = TRAIN["restart_steps"], TRAIN["preempt_at"]
    opt = AdamW(lr=cosine_schedule(TRAIN["peak_lr"], TRAIN["warmup"], n))
    tc = TrainerConfig(checkpoint_every=TRAIN["ckpt_every"], log_every=1)

    def batches():
        return _train_batches(one, TRAIN["batch"], TRAIN["seq"], SEED)

    step, it = make_train_step(one, opt), batches()
    ref_state = init_train_state(SEED, one, opt, device)
    ref_losses = []
    for _ in range(n):
        ref_state, m = step(ref_state, next(it))
        ref_losses.append(float(m["loss"]))
    failures = []
    first = Trainer(one, opt, MemoryStore(), tcfg=tc, seed=SEED,
                    device=device)
    try:
        first.run(batches(), n, preempt_at=at)
        failures.append(f"run() did not raise PreemptionError at {at}")
    except PreemptionError:
        pass
    first.close()
    saves = list(first.ckpt.timings)
    store = first.store
    del first
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    second = Trainer(one, opt, store, tcfg=tc, seed=SEED, device=device)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    it = batches()
    for _ in range(second.start_step):      # the data cursor's replay
        next(it)
    state = second.run(it, n)
    second.close()
    saves += second.ckpt.timings
    losses = [m["loss"] for m in second.metrics_log]
    same = [bool(a.dtype == b.dtype and torch.equal(a, b)) for a, b in
            zip(tree_leaves(ref_state), tree_leaves(state))]
    gaps = [float((a.double() - b.double()).abs().max())
            for a, b in zip(tree_leaves(ref_state), tree_leaves(state))]
    del second, store
    print(f"{cfg.name} train, restart at one layer of the full widths: "
          f"preempted at {at} (checkpoints every {TRAIN['ckpt_every']} "
          f"steps, MemoryStore, 4 shards: {_ckpt_text(saves)}); a fresh "
          f"Trainer resumed at the saved step from the bfloat16 checkpoint "
          f"in {resume_s:.2f} s (its state made, then restored); losses "
          f"after the restart {[f'{x:.6f}' for x in losses]} against "
          f"{[f'{x:.6f}' for x in ref_losses[at:]]}; {sum(same)} of "
          f"{len(same)} state tensors equal bit for bit (largest gap "
          f"{max(gaps):.3e})", flush=True)
    if losses != ref_losses[at:] or not all(same):
        failures.append(f"the continued run differs from the uninterrupted "
                        f"one: losses {losses} vs {ref_losses[at:]}, "
                        f"{len(same) - sum(same)} tensors differ (largest "
                        f"gap {max(gaps):.3e})")
    return failures


def _train_world_of_one(torch, device) -> list:
    """``make_shardmap_train_step`` in a world of one NCCL rank at the
    reduced width (float32): the int8 all-reduce of the gradients within
    half a quantization step of the gradients, leaf by leaf; one
    compressed step's loss equal to ``make_train_step``'s and its
    parameters within ``lr`` (Adam's first step is lr times about the
    sign of each element, which int8 keeps or rounds to 0); the mean
    all-reduce's step equal to ``make_train_step``'s bit for bit."""
    import tempfile
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.engine.compile import DistributedAxis
    from repro_torch.optim import AdamW, compressed_psum
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.runtime import init_train_state, make_train_step
    from repro_torch.runtime.train_step import make_shardmap_train_step
    cfg = configs.get_reduced(TRAIN["arch"])
    lr = 1e-3
    opt = AdamW(lr=lr)
    state = init_train_state(SEED, cfg, opt, device=device)
    rng = np.random.default_rng(SEED + TRAIN["phase"] + 1)
    toks = rng.integers(0, cfg.vocab, (2, 129)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    on_card = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    root = tempfile.mkdtemp(prefix="chip_smoke_train_pg_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{root}/pg",
                            rank=0, world_size=1)
    failures = []
    try:
        axis = DistributedAxis(None)
        _, grads = _grads(torch, state.params, on_card, cfg)
        tree = dict(enumerate(grads))
        reduced = tree_leaves(compressed_psum(tree, axis))
        worst = 0.0
        for g, r in zip(grads, reduced):
            half = max(float(g.abs().max()) / 127 / 2, 1e-30)
            gap = float((r - g).abs().max())
            worst = max(worst, gap / half)
        plain, pm = make_train_step(cfg, opt)(state, batch)
        mean, mm = make_shardmap_train_step(cfg, opt, axis)(state, batch)
        comp, cm = make_shardmap_train_step(cfg, opt, axis,
                                            compress_grads=True)(state, batch)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    p_leaves = tree_leaves(plain.params)
    mean_equal = all(torch.equal(a, b) for a, b in
                     zip(p_leaves, tree_leaves(mean.params)))
    comp_gap = max(float((a - b).abs().max()) for a, b in
                   zip(p_leaves, tree_leaves(comp.params)))
    print(f"{cfg.name} (reduced, float32) train step in a world of one "
          f"NCCL rank: int8 all-reduce error at most {worst:.4f} of half a "
          f"quantization step; compressed step's loss {float(cm['loss']):.6f}"
          f" vs {float(pm['loss']):.6f}, parameters within "
          f"{comp_gap:.3e} (lr {lr:g}); mean all-reduce step equal bit for "
          f"bit: {mean_equal}", flush=True)
    if not worst <= 1.0 + 1e-5:
        failures.append(f"int8 all-reduce error {worst:.4f} half-steps")
    if float(cm["loss"]) != float(pm["loss"]) or not comp_gap <= lr + 1e-6:
        failures.append(f"compressed step: loss {float(cm['loss'])} vs "
                        f"{float(pm['loss'])}, parameter gap {comp_gap}")
    if not mean_equal or float(mm["loss"]) != float(pm["loss"]):
        failures.append("the mean all-reduce step differs from "
                        "make_train_step's in a world of one")
    return failures


def phase_train(torch, fa, fa_ref, device) -> None:
    """Phase 24: gemma2-9b training at full width (``TRAIN["layers"]`` of
    42 layers, bfloat16 parameters, float32 moments, remat) through the
    Trainer on the synthetic corpus; the gradient check, the restart
    check and the world of one.  Every check's numbers print before any
    failure is raised."""
    from repro_torch import configs
    from repro_torch.core.storage import MemoryStore
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import Trainer, TrainerConfig, make_train_step

    full = configs.get(TRAIN["arch"])
    cfg = full.replace(n_layers=TRAIN["layers"])
    failures = _train_grad_check(torch, fa, fa_ref, cfg, device)
    torch.cuda.empty_cache()

    steps, b, s = TRAIN["steps"], TRAIN["batch"], TRAIN["seq"]
    opt = AdamW(lr=cosine_schedule(TRAIN["peak_lr"], TRAIN["warmup"],
                                   steps + TRAIN["mb_steps"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, opt, MemoryStore(),
                      tcfg=TrainerConfig(checkpoint_every=10 ** 9,
                                         log_every=1),
                      seed=SEED, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"{cfg.name} train: {cfg.n_layers} of {full.n_layers} layers at "
          f"full width (d_model {cfg.d_model}, {cfg.n_heads} q / "
          f"{cfg.n_kv_heads} kv heads of {cfg.head_dim_}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, window {cfg.sliding_window} on even layers, "
          f"softcaps {cfg.attn_softcap:g} / {cfg.final_softcap:g}, tied "
          f"embeddings), {cfg.n_params()} parameters in {cfg.param_dtype}, "
          f"float32 moments, remat {cfg.remat}; state made in "
          f"{init_s:.1f} s", flush=True)
    fa.attention.launches = 0
    fa.decode_attention.launches = 0
    t0 = time.perf_counter()
    state = trainer.run(_train_batches(cfg, b, s, SEED), steps)
    run_s = time.perf_counter() - t0
    launches = fa.attention.launches
    decode_launches = fa.decode_attention.launches
    walls = _step_walls(trainer.metrics_log)
    losses = [m["loss"] for m in trainer.metrics_log]
    norms = [m["grad_norm"] for m in trainer.metrics_log]
    trainer.close()
    final = _ckpt_text(trainer.ckpt.timings)
    del trainer
    want = cfg.n_layers * steps * 1 * 2
    warm = statistics.median(walls[1:])
    print(f"{cfg.name} train: {steps} Trainer steps at B = {b}, S = {s} "
          f"(microbatches 1): losses {[f'{x:.4f}' for x in losses]}, grad "
          f"norms {[f'{x:.3f}' for x in norms]}; step walls "
          f"{[f'{w * 1e3:.1f}' for w in walls]} ms (median after the first "
          f"{warm * 1e3:.1f} ms = {b * s / warm:.0f} tokens/s); run() {run_s:.1f} s with the "
          f"final checkpoint ({final}); fwd_wgmma launches {launches} (= layers x "
          f"steps x microbatches x 2 with remat: the forward and the "
          f"recompute = {want}), decode launches {decode_launches}",
          flush=True)
    if launches != want or decode_launches:
        failures.append(f"{launches} forward launches (want {want}), "
                        f"{decode_launches} decode launches (want 0)")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        failures.append(f"non-finite loss or grad norm: {losses}, {norms}")

    mb = TRAIN["microbatches"]
    step = make_train_step(cfg, opt, mb)
    it = _train_batches(cfg, b * mb, s, SEED + 1)
    fa.attention.launches = 0
    mb_walls, mb_losses = [], []
    for _ in range(TRAIN["mb_steps"]):
        batch = {k: v.reshape((mb, b) + v.shape[1:])
                 for k, v in next(it).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        mb_losses.append(float(m["loss"]))
        mb_walls.append(time.perf_counter() - t0)
    mb_launches, mb_want = fa.attention.launches, \
        cfg.n_layers * TRAIN["mb_steps"] * mb * 2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{cfg.name} train: {TRAIN['mb_steps']} steps at microbatches "
          f"{mb} (B = {b * mb}): losses {[f'{x:.4f}' for x in mb_losses]}, "
          f"walls {[f'{w * 1e3:.1f}' for w in mb_walls]} ms; fwd_wgmma "
          f"launches {mb_launches} (want {mb_want}); peak device memory "
          f"{peak:.2f} GiB over the whole loop", flush=True)
    if mb_launches != mb_want or not all(np.isfinite(mb_losses)):
        failures.append(f"microbatches {mb}: {mb_launches} launches (want "
                        f"{mb_want}), losses {mb_losses}")
    one_step = make_train_step(cfg, opt)
    batch = next(_train_batches(cfg, b, s, SEED + 2))
    _profile_step(torch, lambda: one_step(state, batch),
                  f"{cfg.name} train step (B = {b}, S = {s})")
    del state, step, one_step
    torch.cuda.empty_cache()

    failures += _train_restart(torch, cfg, device)
    torch.cuda.empty_cache()
    failures += _train_world_of_one(torch, device)
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"{cfg.name} train: " + "; ".join(failures))


# ---------------------------------------------------------------------------
# phase 25: zamba2-1.2b
# ---------------------------------------------------------------------------

def _zamba_parts(mamba_mod, attn_mod, tf_mod) -> list:
    """The profile split's ranges (``_range_split``): the Mamba-2
    mixer's parts, the shared block's GEMMs (its q, k, v and output
    projections and its MLP) and ``unembed``; the attention kernels are
    counted by name."""
    return [(mamba_mod, "linear", "in/out projections"),
            (mamba_mod, "_mamba2_inputs", "conv + SiLU + softplus"),
            (mamba_mod, "_ssd_intra", "SSD intra-chunk"),
            (mamba_mod, "_ssd_chunk_states", "SSD chunk states"),
            (mamba_mod, "_ssd_recurrence", "SSD recurrence"),
            (mamba_mod, "_ssd_off_diag", "SSD off-diagonal"),
            (mamba_mod, "_gated_norm", "gated norm"),
            (attn_mod, "linear", "shared block GEMMs"),
            (tf_mod, "glu_mlp", "shared block GEMMs"),
            (tf_mod, "unembed", "unembed")]


def _clone_cache(cache: dict) -> dict:
    return {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                else v.clone()) for k, v in cache.items()}


def _zamba_state_gaps(torch, what, got, want, row, tol, failures) -> dict:
    """Every layer's ssm and conv state (``_state_gap``) and row ``row``
    of every shared-block call's k and v of two zamba2 caches, the worst
    layer or call held to ``tol`` (None: only printed).  Returns the
    worst of each (ssm, conv, sa)."""
    worst = _state_gap(torch, what, got, want, tol, failures, tag="zamba2")
    rel = []
    for name in ("sa_k", "sa_v"):
        g = got[name][:, :, :, row].float()
        w = want[name][:, :, :, row].float()
        rel += [float((g[i] - w[i]).norm() / w[i].norm())
                for i in range(g.shape[0])]
    call = int(np.argmax(rel))
    worst["sa"] = rel[call]
    limit = "printed" if tol is None else tol["sa"]
    print(f"zamba2 shared-block k and v at row {row}, {what}: worst "
          f"{'sa_k' if call < len(rel) // 2 else 'sa_v'} call "
          f"{call % (len(rel) // 2)} relative L2 {rel[call]:.3g} (limit "
          f"{limit}), median {statistics.median(rel):.3g}", flush=True)
    if tol is not None and rel[call] > tol["sa"]:
        failures.append(f"shared-block k and v, {what}: relative L2 "
                        f"{rel[call]:.3g}")
    return worst


def _sequential_recurrence(torch, states, log_decay):
    """The recurrence between chunks as the reference's ``lax.scan``
    runs it, one chunk a step: s_z = exp(a_{z-1}) s_{z-1} + S_{z-1} from
    s_0 = 0.  Returns (the state entering each chunk, the final state)."""
    s = torch.zeros_like(states[:, 0])
    entering = []
    for z in range(states.shape[1]):
        entering.append(s)
        s = torch.exp(log_decay[:, z])[..., None, None] * s + states[:, z]
    return torch.stack(entering, dim=1), s


def _zamba_ssd_check(torch, mamba_mod, args, failures) -> None:
    """Check (d): ``_ssd_chunked`` on layer 0's captured input, the card
    against the CPU in float32, and the card's time; and on the card its
    closed-form recurrence between chunks against the reference's
    sequential one, on the same input's chunk states."""
    *tensors, chunk = args
    x, dt, a, bm, _ = tensors
    b, slen, h, p = x.shape
    shape = (b, slen // chunk, chunk)
    dA_cum = torch.cumsum(dt.reshape(*shape, h) * a, dim=2)
    states = mamba_mod._ssd_chunk_states(x.reshape(*shape, h, p),
                                         dt.reshape(*shape, h), dA_cum,
                                         bm.reshape(*shape, -1))
    # random weights' chunks decay by exp(-45) or less, so the carried
    # state underflows to 0; the log decays scaled by 1e-3 carry it
    # through all the chunks
    for scale in (1.0, 1e-3):
        decay = dA_cum[:, :, -1] * scale
        closed = mamba_mod._ssd_recurrence(states, decay)
        scan = _sequential_recurrence(torch, states, decay)
        rec = [float((c - w).norm() / w.norm().clamp(min=1e-30))
               for c, w in zip(closed, scan)]
        print(f"zamba2 layer 0 SSD recurrence over {shape[1]} chunks on "
              f"the card, log decays x {scale:g} (chunk decay "
              f"{float(torch.exp(decay).min()):.3g}-"
              f"{float(torch.exp(decay).max()):.3g}), closed form vs the "
              f"reference's sequential scan: relative L2 of the entering "
              f"states {rec[0]:.3g}, of the final state {rec[1]:.3g} (limit "
              f"{ZAMBA_SSD_REL_L2})", flush=True)
        if not max(rec) <= ZAMBA_SSD_REL_L2:
            failures.append(f"the SSD recurrence vs the sequential scan, "
                            f"log decays x {scale:g}: relative L2 {rec}")
    del states, closed, scan
    y, s = mamba_mod._ssd_chunked(*tensors, chunk)
    t0 = time.perf_counter()
    want_y, want_s = mamba_mod._ssd_chunked(*(t.cpu() for t in tensors),
                                            chunk)
    cpu_s = time.perf_counter() - t0
    ms = _median_ms(lambda: mamba_mod._ssd_chunked(*tensors, chunk), reps=5)
    gaps = [float((g.cpu() - w).norm() / w.norm())
            for g, w in ((y, want_y), (s, want_s))]
    print(f"zamba2 layer 0 SSD on its captured input x{tuple(x.shape)} "
          f"{x.dtype}, chunk {chunk}: card vs CPU relative L2 y {gaps[0]:.3g}"
          f", final state {gaps[1]:.3g} (limit {ZAMBA_SSD_REL_L2}); the "
          f"card's _ssd_chunked {ms:.3f} ms (CUDA events, median of 5), the "
          f"CPU's {cpu_s:.2f} s", flush=True)
    if not max(gaps) <= ZAMBA_SSD_REL_L2 or \
            not bool(torch.isfinite(y).all()):
        failures.append(f"the SSD on the card vs the CPU: relative L2 "
                        f"{gaps}")


def _fault_ratio(torch, what, logits, cache, last, full, row,
                 failures) -> None:
    """Check (b) on a planted fault's decode logits and cache, against
    the kernel prefill's (``last``, ``full``): the largest of its gaps
    over its limit (logits max |diff| and relative L2, the worst layer's
    ssm and conv state, the worst call's k and v at ``row``) must reach
    ``ZAMBA_FAULT_FACTOR``."""
    gaps = _zamba_state_gaps(torch, f"planted fault {what}", cache, full,
                             row, None, [])
    diff = (logits - last).abs()
    ratios = {"logits max |diff|": float(diff.max()) /
              ZAMBA_LOGIT_TOL["max_abs"],
              "logits relative L2": float(diff.norm() / last.norm()) /
              ZAMBA_LOGIT_TOL["rel_l2"]}
    names = {"ssm": "ssm state", "conv": "conv state",
             "sa": "shared-block k and v"}
    ratios.update({names[name]: gap / ZAMBA_STATE_TOL[name]
                   for name, gap in gaps.items()})
    worst = max(ratios, key=ratios.get)
    print(f"zamba2 planted fault {what}: logits max |diff| "
          f"{float(diff.max()):.4g}, relative L2 "
          f"{float(diff.norm() / last.norm()):.3g}; gap over limit "
          f"{ {k: float(f'{v:.3g}') for k, v in ratios.items()} }: the "
          f"largest, {worst}, {ratios[worst]:.3g}x (must be >= "
          f"{ZAMBA_FAULT_FACTOR:g}x)", flush=True)
    if ratios[worst] < ZAMBA_FAULT_FACTOR:
        failures.append(f"planted fault {what} not rejected: "
                        f"{ratios[worst]:.3g}x its limit")


def _zamba_faults(torch, params, cfg, toks, max_len, last, full, short,
                  failures) -> None:
    """Check (c): two planted faults on the kernel path, each held to
    check (b) against the kernel prefill's last logits and cache, each
    required to break a limit by ``ZAMBA_FAULT_FACTOR``.  (1) The last chunk padded before the
    softplus: the pad's dt is softplus(dt_bias), so the state decays
    through the pad (the prompt of S - 1 tokens pads one step).  (2) The
    decode walk without its last call of the shared block."""
    import torch.nn.functional as F

    from repro_torch.models import decode_step, prefill_forward
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import transformer as tf_mod

    n = toks.shape[1]
    forward, ssd, walk = (tf_mod.mamba2_forward, mamba_mod._ssd_chunked,
                          tf_mod._layer_walk)

    def padded_before(p, x, c, chunk=64, return_state=False):
        def fault_ssd(xs, dt_p, a, b_p, c_p, chunk_):
            dt_p = dt_p.clone()
            dt_p[:, x.shape[1]:] = F.softplus(p["dt_bias"])
            return ssd(xs, dt_p, a, b_p, c_p, chunk_)
        mamba_mod._ssd_chunked = fault_ssd
        try:
            return forward(p, x, c, chunk, return_state)
        finally:
            mamba_mod._ssd_chunked = ssd

    tf_mod.mamba2_forward = padded_before
    try:
        _, bad = prefill_forward(params, toks[:, :-1], cfg, max_len)
        got = decode_step(params, bad, toks[:, -1:], cfg)[0]
    finally:
        tf_mod.mamba2_forward = forward
    _fault_ratio(torch, f"(1), the {n - 1}-token prompt padded before the "
                 f"softplus", got, bad, last, full, n - 1, failures)
    del bad

    def without_last_call(c):
        out = walk(c)
        i = max(i for i, (_, si) in enumerate(out) if si is not None)
        out[i] = (out[i][0], None)
        return out

    bad = _clone_cache(short)
    tf_mod._layer_walk = without_last_call
    try:
        got = decode_step(params, bad, toks[:, -1:], cfg)[0]
    finally:
        tf_mod._layer_walk = walk
    _fault_ratio(torch, "(2), the decode step without the last call of the "
                 "shared block", got, bad, last, full, n - 1, failures)


def phase_zamba(torch, fa, fa_ref, fd_ref, device):
    """Phase 25: zamba2-1.2b whole — the main path's launches and times,
    the attention kernels on the first shared call's captured inputs,
    the SSD on layer 0's captured input against the CPU, prefill-vs-decode
    and kernel-vs-plain logits and states, two planted faults, and a
    profile split of a decode step and a prefill.  Every check prints
    before any failure is raised.  Returns (params, cfg)."""
    from repro_torch import configs
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decode_step, prefill_forward
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import transformer as tf_mod

    cfg = configs.get(ZAMBA["arch"])
    tag = cfg.name
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, toks = _lm_inputs(torch, cfg, ZAMBA, SEED, device)
    torch.cuda.synchronize()
    positions = tf_mod._shared_attn_positions(cfg)
    print(f"{tag}: whole ({cfg.n_layers} Mamba-2 layers, d_model "
          f"{cfg.d_model}, d_inner {cfg.d_inner_}, "
          f"{cfg.d_inner_ // cfg.mamba_head_dim} SSD heads of "
          f"{cfg.mamba_head_dim}, ssm_state {cfg.ssm_state}, conv "
          f"{cfg.conv_kernel}; the shared block ({cfg.n_heads} heads of "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff} {cfg.activation} GLU) after "
          f"layers {positions}; vocab {cfg.vocab}; {cfg.n_params()} "
          f"parameters in {cfg.param_dtype}) with random weights from seed "
          f"{SEED} in {time.perf_counter() - t0:.1f} s", flush=True)
    n, steps = ZAMBA["prompt"], ZAMBA["decode_steps"]
    max_len = n + steps

    # the main path, the first shared call's attention inputs captured,
    # and layer 0's SSD input
    ssd, captured = mamba_mod._ssd_chunked, []

    def ssd_capture(*args):
        if not captured:
            captured.append(args)
        return ssd(*args)

    mamba_mod._ssd_chunked = ssd_capture
    try:
        run = _lm_main_path(torch, fa, params, toks, cfg, ZAMBA, tag, 1)
    finally:
        mamba_mod._ssd_chunked = ssd
    failures = []
    _zamba_ssd_check(torch, mamba_mod, captured.pop(), failures)
    fwd_t, dec_t = _kernel_cases(torch, fa, fa_ref, fd_ref, run, tag)
    torch.cuda.empty_cache()

    # prefill-then-decode: the warm prefill of n - 1 tokens timed, the
    # decode step on a copy of its cache profiled
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, short = prefill_forward(params, toks[:, :-1], cfg, max_len)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"{tag}: warm prefill of {n - 1} tokens in {warm_s:.4f} s = "
          f"{(n - 1) / warm_s:.0f} tokens/s", flush=True)
    out, stepped = {}, _clone_cache(short)
    events = _profile_step(torch, lambda: out.update(
        logits=decode_step(params, stepped, toks[:, -1:], cfg)[0]),
        f"{tag}: one decode step (B=1, cache {n - 1})")
    # traced again on a fresh copy: the step writes the Mamba states in place
    _one_decode_kernel_a_layer(
        torch, events, lambda: decode_step(params, _clone_cache(short),
                                           toks[:, -1:], cfg), cfg, tag)
    via_decode = out["logits"]
    last, full = prefill_forward(params, toks, cfg, max_len)

    # the second witness: the plain versions in the kernels' places
    calls = attn_mod.attention, attn_mod.decode_attention
    attn_mod.attention, attn_mod.decode_attention = fa_ref, fd_ref
    try:
        plain_dec = decode_step(params, _clone_cache(short), toks[:, -1:],
                                cfg)[0]
    finally:
        attn_mod.attention, attn_mod.decode_attention = calls
    plain_last, plain_via, plain_full, plain_short = _plain_witness(
        fa_ref, fd_ref, params, cfg, toks, max_len, caches=True)
    _witness_gaps(torch, tag, n, ZAMBA_LOGIT_TOL, via_decode, last,
                  plain_via, plain_last, plain_dec, failures)
    for what, got, want in (
            (f"kernels: {n - 1}-token prefill + one decode step vs {n}-token"
             f" prefill", stepped, full),
            ("plain versions: the same", plain_short, plain_full),
            (f"{n}-token prefill, kernel vs plain", full, plain_full)):
        _zamba_state_gaps(torch, what, got, want, n - 1, ZAMBA_STATE_TOL,
                          failures)
    del plain_full, plain_short, stepped
    _zamba_faults(torch, params, cfg, toks, max_len, last, full, short,
                  failures)
    del full
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"{tag}: " + "; ".join(failures))

    # where the time goes: a decode step and a prefill, split by part,
    # the attention kernels' device records counted by name
    parts = _zamba_parts(mamba_mod, attn_mod, tf_mod)
    kernels = ("fwd_wgmma", "decode_cluster")
    stepped = _clone_cache(short)
    del short
    split = _range_split(torch, lambda: decode_step(
        params, stepped, toks[:, -1:], cfg), f"{tag}: one decode step (B=1, "
        f"cache {n - 1})", parts, kernels)
    dec_records = split[("launches", "decode_cluster")]
    del stepped
    split = _range_split(torch, lambda: prefill_forward(
        params, toks[:, :-1], cfg, max_len), f"{tag}: one prefill of "
        f"{n - 1} tokens", parts, kernels)
    fwd_records = split[("launches", "fwd_wgmma")]
    calls_n = _attn_calls(cfg)
    print(f"{tag}: device records by name in the profiled runs: "
          f"{fwd_records} fwd_wgmma a prefill, {dec_records} decode_cluster "
          f"a decode step (want {calls_n} each); peak device memory over "
          f"the phase {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    if fwd_records != calls_n or dec_records != calls_n:
        raise AssertionError(f"{tag}: {fwd_records} fwd_wgmma records a "
                             f"prefill, {dec_records} decode_cluster a step, "
                             f"want {calls_n}")
    _profile_step(torch, lambda: prefill_forward(params, toks[:, :-1], cfg,
                                                 max_len),
                  f"{tag}: the same prefill")
    return params, cfg


def phase_zamba_serving(torch, fa, params, cfg, device) -> None:
    """Phase 25's serving: BatchedServer on zamba2-1.2b."""
    fa.attention.launches = 0
    fa.decode_attention.launches = 0
    server, run = _serve_requests(torch, params, cfg, device, SEED + 25)
    fwd, dec = fa.attention.launches, fa.decode_attention.launches
    decode_steps = run["batched"] + run["admit_steps"]
    calls = _attn_calls(cfg)
    if dec != calls * decode_steps or fwd != 0:
        raise AssertionError(f"{cfg.name} serving: {dec} decode launches "
                             f"for {decode_steps} decode steps, {fwd} "
                             f"forward launches for no prefill")
    _profile_step(torch, lambda: server._admit_step(1, 0),
                  f"{cfg.name} serving: one admission step "
                  f"(B={SERVE['slots']})")
    print(f"{cfg.name} serving: {_serve_text(cfg, run)}; {dec} flash decode "
          f"launches (= {calls} x {decode_steps}), {fwd} flash forward "
          f"launches", flush=True)


def _embed_parts(attn_mod, tf_mod) -> list:
    """Phase 26's profile split (``_range_split``): the attention layer's
    q, k, v and output projections, the norms, the GLU MLP and
    ``unembed``; the attention kernels are counted by name."""
    return [(attn_mod, "linear", "attention projections"),
            (tf_mod, "_apply_norm", "norms"),
            (tf_mod, "glu_mlp", "MLP"),
            (tf_mod, "unembed", "unembed")]


def _embed_fault(torch, params, cfg, toks, short, last, tol,
                 failures) -> None:
    """The planted fault: the decode step's input multiplied by
    sqrt(d_model) — an embed scale where the config has none — on the
    last prompt position, held against the kernel prefill's last logits;
    the larger of its max |diff| and relative L2 over their limits must
    reach ``EMBED_FAULT_FACTOR``."""
    from repro_torch.models import decode_step
    from repro_torch.models import transformer as tf_mod

    scale = cfg.d_model ** 0.5
    embed_inputs = tf_mod._embed_inputs

    def scaled(params, inputs, cfg, *, decode=False):
        x = embed_inputs(params, inputs, cfg, decode=decode)
        return x * scale if decode else x

    tf_mod._embed_inputs = scaled
    try:
        got = decode_step(params, short, toks[:, -1:], cfg)[0]
    finally:
        tf_mod._embed_inputs = embed_inputs
    diff = (got - last).abs()
    ratios = {"max |diff|": float(diff.max()) / tol["max_abs"],
              "relative L2": float(diff.norm() / last.norm()) /
              tol["rel_l2"]}
    worst = max(ratios, key=ratios.get)
    print(f"{cfg.name} planted fault (the decode step's input times "
          f"sqrt(d_model) = {scale:.2f}): logits max |diff| "
          f"{float(diff.max()):.4g}, relative L2 "
          f"{float(diff.norm() / last.norm()):.3g}; gap over limit "
          f"{ {k: float(f'{v:.3g}') for k, v in ratios.items()} }: the "
          f"largest, {worst}, {ratios[worst]:.3g}x (must be >= "
          f"{EMBED_FAULT_FACTOR:g}x)", flush=True)
    if ratios[worst] < EMBED_FAULT_FACTOR:
        failures.append(f"planted fault not rejected: {ratios[worst]:.3g}x "
                        f"its limit")


def phase_embed(torch, fa, fa_ref, fd_ref, device, spec):
    """Phase 26, one model whole: the main path's launches and times,
    the attention kernels on layer 0's captured inputs, the warm prefill,
    prefill-vs-decode and kernel-vs-plain logits, the planted fault, and
    a profile split of a decode step and a prefill.  Every check prints
    before any failure is raised.  Returns (params, cfg)."""
    from repro_torch import configs
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decode_step, prefill_forward
    from repro_torch.models import transformer as tf_mod

    cfg = configs.get(spec["arch"])
    tag, tol = cfg.name, EMBED_LOGIT_TOL[spec["arch"]]
    started = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, toks = _lm_inputs(torch, cfg, spec, SEED, device)
    torch.cuda.synchronize()
    prompt = "patch embeddings" if toks.dim() == 3 else "token ids"
    print(f"{tag}: whole ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads of {cfg.head_dim_}, "
          f"rope theta {cfg.rope_theta:g}, {cfg.norm} at eps "
          f"{cfg.norm_eps:g}, {cfg.activation} GLU of {cfg.d_ff}, untied "
          f"{cfg.vocab}-word head; {cfg.n_params()} parameters in "
          f"{cfg.param_dtype}) with random weights from seed {SEED} in "
          f"{time.perf_counter() - started:.1f} s; prompt "
          f"{tuple(toks.shape)} {prompt} in {toks.dtype}", flush=True)
    n = spec["prompt"]
    max_len = n + spec["decode_steps"]

    # the main path, layer 0's attention inputs captured, and the kernels
    # on them
    run = _lm_main_path(torch, fa, params, toks, cfg, spec, tag, 1)
    last = run["last"]
    _kernel_cases(torch, fa, fa_ref, fd_ref, run, tag)

    # prefill-then-decode: the warm prefill of n - 1 positions timed, the
    # decode step on its cache profiled.  Every decode step below writes
    # row n - 1 of ``short`` before it reads it, so they share the cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, short = prefill_forward(params, toks[:, :-1], cfg, max_len)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"{tag}: warm prefill of {n - 1} positions in {warm_s:.4f} s = "
          f"{(n - 1) / warm_s:.0f} tokens/s", flush=True)
    out = {}
    events = _profile_step(torch, lambda: out.update(
        logits=decode_step(params, short, toks[:, -1:], cfg)[0]),
        f"{tag}: one decode step on a {tuple(toks[:, -1:].shape)} input "
        f"(B=1, cache {n - 1})")
    _one_decode_kernel_a_layer(
        torch, events, lambda: decode_step(params, short, toks[:, -1:], cfg),
        cfg, tag)
    via_decode = out["logits"]

    # the second witness: the plain versions in the kernels' places
    calls = attn_mod.attention, attn_mod.decode_attention
    attn_mod.attention, attn_mod.decode_attention = fa_ref, fd_ref
    try:
        plain_dec = decode_step(params, short, toks[:, -1:], cfg)[0]
    finally:
        attn_mod.attention, attn_mod.decode_attention = calls
    plain_last, plain_via = _plain_witness(fa_ref, fd_ref, params, cfg,
                                           toks, max_len)
    failures = []
    _witness_gaps(torch, tag, n, tol, via_decode, last, plain_via,
                  plain_last, plain_dec, failures)
    _embed_fault(torch, params, cfg, toks, short, last, tol, failures)
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"{tag}: " + "; ".join(failures))

    # where the time goes: a decode step and a prefill, split by part,
    # the attention kernels' device records counted by name
    parts, kernels = _embed_parts(attn_mod, tf_mod), ("fwd_wgmma",
                                                      "decode_cluster")
    split = _range_split(torch, lambda: decode_step(
        params, short, toks[:, -1:], cfg), f"{tag}: one decode step (B=1, "
        f"cache {n - 1})", parts, kernels)
    dec_records = split[("launches", "decode_cluster")]
    del short
    split = _range_split(torch, lambda: prefill_forward(
        params, toks[:, :-1], cfg, max_len), f"{tag}: one prefill of "
        f"{n - 1} positions", parts, kernels)
    print(f"{tag}: device records by name in the profiled runs: "
          f"{split[('launches', 'fwd_wgmma')]} fwd_wgmma a prefill, "
          f"{dec_records} decode_cluster a decode step (launches: "
          f"{run['fwd_launches']} and {run['dec_launches']} over "
          f"{spec['decode_steps']} steps, counted by the wrappers; a trace "
          f"may drop records); peak device memory over the phase "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {tag} "
          f"done in {time.perf_counter() - started:.1f} s", flush=True)
    return params, cfg


def phase_embed_serving(torch, fa, params, cfg, device) -> None:
    """Phase 26's serving: BatchedServer on internvl2-2b, token prompts
    through the embed table, as the reference's class serves it."""
    fa.attention.launches = 0
    fa.decode_attention.launches = 0
    server, run = _serve_requests(torch, params, cfg, device, SEED + 26)
    fwd, dec = fa.attention.launches, fa.decode_attention.launches
    decode_steps = run["batched"] + run["admit_steps"]
    if dec != cfg.n_layers * decode_steps or fwd != 0:
        raise AssertionError(f"{cfg.name} serving: {dec} decode launches "
                             f"for {decode_steps} decode steps, {fwd} "
                             f"forward launches for no prefill")
    _profile_step(torch, lambda: server._admit_step(1, 0),
                  f"{cfg.name} serving: one admission step "
                  f"(B={SERVE['slots']})")
    print(f"{cfg.name} serving: {_serve_text(cfg, run)}; {dec} flash decode "
          f"launches (= {cfg.n_layers} x {decode_steps}), {fwd} flash "
          f"forward launches", flush=True)


def main(argv=None) -> int:
    global SEED
    parser = argparse.ArgumentParser(description="Build, check and drive "
                                     "the PyTorch/CUDA port on one card.")
    parser.add_argument("--seed", type=int, default=SEED,
                        help="seed of every random weight, prompt and input "
                             f"(default {SEED})")
    parser.add_argument("--logit-floor", type=int, nargs="+",
                        metavar="SEED",
                        help="only measure phase 10's plain witness (the "
                             "model's own prefill-vs-decode logit gap, no "
                             "kernels) at these seeds, and exit")
    parser.add_argument("--arch", default=GEMMA["arch"],
                        choices=[GEMMA["arch"], QWEN_MOE["arch"],
                                 MIXTRAL["arch"], ZAMBA["arch"]]
                        + [spec["arch"] for spec in EMBED],
                        help="the model of --logit-floor: phase 10's "
                             "(default), 22's, 23's, 25's or 26's")
    args = parser.parse_args(argv)
    SEED = args.seed
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if args.logit_floor:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
        logit_floor(torch, args.logit_floor, torch.device("cuda"),
                    args.arch)
        return 0
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_fold import ops
    from repro_torch.kernels.fused_fold.ref import fused_streaming_fold_ref
    from repro_torch.kernels.hash_combine import ops as hc
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import (chunked_attention,
                                                         decode_ref)
    from repro_torch.kernels.hash_combine.ref import hash_combine_ref
    from repro_torch.kernels.mamba_scan import ops as sc
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
    from repro_torch.workloads import linear_road as lr
    from repro_torch.workloads import wordcount as wc

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; seed {SEED}")

    started = time.perf_counter()

    def mark(phases: str) -> None:
        print(f"[phases {phases} done at "
              f"{time.perf_counter() - started:.1f} s]", flush=True)

    t0 = time.perf_counter()
    _build.build_all(["fused_fold", "hash_combine", "flash_attention",
                      "mamba_scan"])
    print(f"fused_fold, hash_combine, flash_attention and mamba_scan built "
          f"together (nvcc, sm_90a, one process each) in "
          f"{time.perf_counter() - t0:.1f} s")
    wgmma_build_report(torch, _build, fa)
    decode_build_report(_build)
    ops.library()
    hc.library()
    fa.library()
    sc.library()
    scan_build_report(torch, _build, sc)
    mark("1")

    worst = phase_kernel(torch, ops, fused_streaming_fold_ref, device)
    main_shape = phase_kernel_main_shape(torch, ops, fused_streaming_fold_ref,
                                         lr, device)
    launches, lr_store, lr_sinks = phase_main_path(torch, ops, lr)
    phase_sessions(ops)
    mark("2-4")

    hc_worst = phase_hash_combine(torch, hc, hash_combine_ref, device)
    t0 = time.perf_counter()
    shards = wc.token_shards(SEED, **wc.FULL)
    print(f"wordcount: {shards.shape} int32 shards generated on the host in "
          f"{time.perf_counter() - t0:.2f} s")
    hc_shape = phase_hash_combine_main_shape(
        torch, hc, hash_combine_ref, wc, torch.from_numpy(shards).to(device))
    torch.cuda.empty_cache()
    hc_launches, hc_counts, hc_wall = phase_wordcount(torch, hc, wc, shards)
    phase_hashed(torch, hc, wc)
    torch.cuda.empty_cache()
    mark("5-7")

    fa_worst = phase_flash_forward(torch, fa, chunked_attention, device)
    fd_worst = phase_flash_decode(torch, fa, decode_ref, device)
    torch.cuda.empty_cache()
    params, cfg, fa_launches, fd_launches, fa_shape, fd_shape = phase_gemma(
        torch, fa, chunked_attention, decode_ref, device)
    torch.cuda.empty_cache()
    phase_serving(torch, fa, params, cfg, device)
    del params
    torch.cuda.empty_cache()
    mark("8-11")

    sc_worst = phase_scan(torch, sc, selective_scan_ref, device)
    torch.cuda.empty_cache()
    params, cfg, sc_launches, sc_shape = phase_falcon_mamba(
        torch, sc, selective_scan_ref, device)
    torch.cuda.empty_cache()
    phase_mamba_serving(torch, sc, params, cfg, device)
    del params
    torch.cuda.empty_cache()
    mark("12-14")

    phase_batch_job(torch, hc, device)
    phase_job_service(torch, ops, lr, device)
    phase_congestion_chain(torch, ops, lr, device)
    phase_toll_join(torch, ops, lr, device)
    torch.cuda.empty_cache()
    mark("15-18")
    phase_segment_median(torch, ops, lr)
    torch.cuda.empty_cache()
    phase_group_wordcount(torch, hc, wc, shards, hc_counts, hc_wall)
    torch.cuda.empty_cache()
    phase_backends(torch, ops, hc, lr, wc, lr_store, lr_sinks, shards,
                   hc_counts, device)
    del shards, lr_store
    torch.cuda.empty_cache()
    mark("19-21")

    params, cfg = phase_moe(torch, fa, chunked_attention, decode_ref, device,
                            QWEN_MOE)
    torch.cuda.empty_cache()
    phase_moe_serving(torch, fa, params, cfg, device)
    del params
    torch.cuda.empty_cache()
    params, cfg = phase_moe(torch, fa, chunked_attention, decode_ref, device,
                            MIXTRAL)
    del params
    torch.cuda.empty_cache()
    mark("22-23")

    phase_train(torch, fa, chunked_attention, device)
    torch.cuda.empty_cache()
    mark("24")

    params, cfg = phase_zamba(torch, fa, chunked_attention, decode_ref,
                              device)
    torch.cuda.empty_cache()
    phase_zamba_serving(torch, fa, params, cfg, device)
    del params
    torch.cuda.empty_cache()
    mark("25")

    for spec in EMBED:
        params, cfg = phase_embed(torch, fa, chunked_attention, decode_ref,
                                  device, spec)
        torch.cuda.empty_cache()
        if cfg.input_mode == "embeddings":
            phase_embed_serving(torch, fa, params, cfg, device)
        del params
        torch.cuda.empty_cache()
    mark("26")

    kernel = {"name": "fused_fold", "route": "cuda",
              "source": "src/repro_torch/kernels/fused_fold/csrc/"
                        "fused_fold.cu",
              "replaces": "src/repro/kernels/fused_fold/kernel.py:64",
              "launches": launches}
    kernel.update(main_shape)
    kernel["max_abs_err"] = max(worst, main_shape["max_abs_err"])
    combine = {"name": "hash_combine", "route": "cuda",
               "source": "src/repro_torch/kernels/hash_combine/csrc/"
                         "hash_combine.cu",
               "replaces": "src/repro/kernels/hash_combine/kernel.py:36",
               "launches": hc_launches}
    combine.update(hc_shape)
    combine["max_abs_err"] = max(hc_worst, hc_shape["max_abs_err"])
    forward = {"name": "flash_attention_fwd", "route": "cuda",
               "source": "src/repro_torch/kernels/flash_attention/csrc/"
                         "flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention/kernel.py:37",
               "launches": fa_launches}
    forward.update(fa_shape)
    forward["max_abs_err"] = max(fa_worst, fa_shape["max_abs_err"])
    decode = {"name": "decode_cluster", "route": "cuda",
              "source": "src/repro_torch/kernels/flash_attention/csrc/"
                        "flash_attention.cu",
              "replaces": "src/repro/kernels/flash_attention/kernel.py:156",
              "launches": fd_launches}
    decode.update(fd_shape)
    decode["max_abs_err"] = max(fd_worst, fd_shape["max_abs_err"])
    scan = {"name": "mamba_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan/kernel.py:33",
            "launches": sc_launches}
    scan.update(sc_shape)
    scan["max_abs_err"] = max(sc_worst, sc_shape["max_abs_err"])
    print(json.dumps({"kernels": [kernel, combine, forward, decode, scan]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
