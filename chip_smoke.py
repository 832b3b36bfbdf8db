#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA GPU.

    python3 chip_smoke.py

1. Builds every kernel of the port from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all started together) and prints the build time.
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   same inputs, and times the kernel, the plain version and PyTorch library
   calls computing the same function (timed only, never used by the port)
   beside the least time the card could take.  ``rank_counts``: exact
   counts, L1 and L2, fp32 and bf16, at the evaluation chunk (B = 256
   queries, E = 14,951, k = 50) and at a Freebase-scale table (B = 4,096,
   E = 1,000,000), then on tie-stress inputs at the evaluation chunk (each
   gold row planted exactly and one ulp off, so counts hang on single
   ulps; under L2 the tensor-core screen must re-check some pairs in
   order).  Per case: the kernels' own time (``torch.profiler``; L2 is a
   per-row pre-pass and the main kernel), the wrapper call's (CUDA
   events), the share of pairs the L2 screen re-checked, and the main
   kernel's registers and shared memory; library call ``torch.cdist`` +
   compare + sum, split in two calls at E = 1e6, whose 4.1e9 outputs one
   call's grid cannot hold.
   ``transe_score`` forward and backward (kernel times from
   ``torch.profiler``, as the wrappers sync for their id checks; the
   backward's is the sum of its two kernels per call): equal
   bits (max_abs_err 0), L1 and
   L2, fp32 and bf16, at the training step's shape (4 workers x 256
   triplets over the stacked FB15k tables, 4 x 14,951 entity rows) and at
   2**20 triplets over a 1,000,000-row table; the backward run twice must
   give the same bits.  Library calls timed beside them: gathers +
   ``torch.linalg.vector_norm`` + ``clamp`` (forward) and autograd of the
   same (backward).
3. Training path, through ``kg.fit`` over a synthetic graph with FB15k's
   entity, relation and triplet counts: TransE at ``kg.make_configs``'
   defaults (dim 50, L1, margin 1, lr 0.01, per-epoch normalization,
   uniform negatives, 4 workers, batch 256, balanced split), SGD with the
   ``average`` Reduce and BGD, a few epochs each, from the seeded init.
   The ``transe_score`` counters are zeroed just before and read just
   after.  Checks: both kernels launched once per step, as the schedule
   predicts; each paradigm's loss fell; the SGD-trained filtered mean rank
   beats the init's; a same-seed rerun of one epoch gives the same bits;
   one SGD epoch on the CPU (plain versions) and on the card (kernels) from
   the same params and draws agree (tolerance below).
4. Serving path, on the SGD-trained artifact, through the entry points a
   user calls: save -> load; filtered top-k tail/head queries, relation
   queries and scores for 1,024 pairs; ``rank()``;
   ``kg.evaluate(kb, engine="device")``.  The ``rank_counts`` counter is
   zeroed just before and read just after.  Checks: fingerprints survive
   the round trip, answers are well formed and agree with the host
   reference protocol on a slice of the test split, and the kernel path
   agrees with the plain-scorer path on the whole split.
5. Training with evaluation and resume, at the training path's width,
   through ``kg.fit``: run A, SGD for 4 epochs with ``eval_every=2`` and
   async checkpoints every 2 epochs; run B, SGD for 2 epochs with a
   checkpoint, then ``resume=True`` to 4; BGD for 1 epoch with a
   checkpoint, then resumed to 3.  All three kernels' counters are zeroed
   just before and read just after.  Checks: A, resumed B and the
   untraced SGD run of the training path give the same bits (params and
   loss history), as do the resumed BGD run and the training path's; A's
   trace entries equal a later ``kg.evaluate`` exactly (the last entry,
   and the best entry against ``best_params``), at epochs [1, 3] and merge
   rounds [2, 4]; the steps on disk and each manifest's ``config``
   (``resume_config``); ``transe_score`` forward and backward launched
   once per step and ``rank_counts`` as two evaluations predict; a bf16
   cast of A's artifact answers ``query_tails`` and ``score`` as the CPU
   does and keeps its fingerprint off the card.  Reports epoch seconds,
   each boundary evaluation's seconds, the seconds the loop waits in
   ``save_async`` and in the final wait, and the resume's restore seconds.

6. The device pipeline (``pipeline="device"``), at the training path's
   width, through ``kg.fit``: (a) SGD ``average`` with ``merge_every=2``
   and ``repartition_every=2``, 4 epochs, ``block_epochs=4`` on the whole
   split (its loss checked), and on the cut split (below) in blocks of 4
   and of 2; (b) BGD, 3 epochs in one block; (c) one merge
   round of (a)'s configuration (2 epochs) on the cut split (the first
   sixteenth of the training split, ``DEPTH_CUT``) on the CPU and on the
   card, from fit's seed-0 init and the port's own draws, and the
   counter-based draws (``core/keys.py``) alone on 2**20 counters on
   both; (d) one block of (a) through ``mapreduce.make_block_fn`` under
   ``torch.cuda.set_sync_debug_mode("error")`` (its losses read after),
   the peak memory of a block with ``donate_params`` on and off
   (``torch.cuda.max_memory_allocated``), and a block under
   ``torch.profiler``; (e) (a)'s cut-split run with ``eval_every=2`` (over
   the whole test split) and checkpoints every 2 epochs, and a run of 2
   epochs resumed to 4.  All three kernels' counters are zeroed just
   before and read just after.  Checks: (a)'s two block sizes, (e)'s
   traced run and its resumed run give (a)'s cut-split bits,
   as do (c)'s CPU and card rounds (params and losses) and draws; the
   block under the sync check raises nothing and gives (a)'s first two
   losses; (e)'s trace entries lie at merge rounds [1, 2] and its last
   equals a later ``kg.evaluate``; the manifests carry
   ``pipeline="device"``; each loss fell; (f) ``transe_score`` forward and
   backward launched once a step on the card and ``rank_counts`` 232
   times an evaluation.  Reports epoch seconds, the block's idle
   share, launches and device→host copies a step beside the host
   pipeline's profile of the training path, and the peak memory.

7. The live server (``serve.KGServer``), at the training path's width, on
   the SGD-trained artifact saved and loaded fresh (its graph's known
   index cold), with the BGD-trained artifact as a second tenant and as
   the swap target, at the batching configs of
   ``benchmarks/bench_latency.py`` (``unbatched``, ``batch16_wait1ms``,
   ``batch64_wait2ms``; k = 10).  All three kernels' counters are zeroed
   just before and read just after (no kernel lies on this path: 0
   expected).  (a) Start-up: one wave filling each bucket, then one
   filtered query, on an unwarmed server, then ``KGServer(kb,
   warm=True)`` timed as its known-index build and its engine calls, and
   the same waves warm; the shapes the cold waves met plus those warm-up
   met are every warmed shape.  (b) Parity, on ``batch64_wait2ms`` with
   ``pause``/``resume`` composing exact waves: tails, heads and
   relations, unfiltered, filtered and with an explicit exclusion, waves
   of 1–64 (every bucket), each answer bitwise equal to the engine on the
   same single query at ``chunk=1``, and again from the cache.  (c)
   Capacity: 2,048 distinct ``tails`` queries submitted at once, per
   config (512 on ``unbatched``, ``LIVE_LOAD``).  (d) An open loop per
   config: 2,000 seeded Poisson arrivals (500 on ``unbatched``) at half
   of (c)'s capacity over 500 distinct pairs (repeats hit the
   cache): offered and sustained QPS, p50/p99 over all answers and over
   misses, hit rate, waves by bucket, the allocator's device allocations
   (``num_device_alloc``) across the stream, and no steady-state
   recompile.  (e) On ``batch16_wait1ms``: the second tenant answers with
   its own bits; then ``swap()`` to it halfway through an open loop:
   every answer carries one of the two fingerprints and equals that
   artifact's engine, the cache is invalidated once, and no shape is
   new; the swap, its warm-up and its exclusion width are timed.  Every
   served tenant's tables are on the card; every future's wait is
   bounded.

8. The model family and joint negatives (``model_family_path``), at the
   training path's width on phase 6's cut split, through ``kg.fit``: (a)
   TransH, SGD ``average`` 1 epoch and BGD 1, host pipeline; (b)
   DistMult, the same; (c) TransE with ``negatives="joint"``:
   bench_async's joint-48 (SGD, L2, ``neg_candidates=48``,
   ``merge_every=2``) on the device pipeline, 4 epochs in blocks of 4 on
   the whole split (its loss is checked, and on the cut split it does not
   fall in 4 epochs), and in blocks of 4 and of 2 on the cut split (the
   same bits), and the full pool (C = 256) under BGD,
   L1, 1 epoch, host pipeline; (d) each of the three SGD artifacts saved,
   loaded, queried (filtered tails and heads, relations, scores on 1,024
   pairs), ranked (``rank()``) and evaluated (``kg.evaluate(kb,
   engine="device")``), the device engine against the host protocol on a
   slice of the test split; (e) the DistMult artifact as a ``KGServer``
   tenant, waves of 1–64 (every bucket), each served answer bitwise equal
   to the engine at ``chunk=1``.  All three kernels' counters are zeroed
   just before and read just after: ``transe_score`` forward and backward
   0 (no kernel lies on these objectives), ``rank_counts`` 232 for each of
   the TransE artifact's ``rank()`` and evaluation.  Then, per model, a
   same-seed rerun of 20 steps of the engine's epoch function (same bits)
   and its profile (launches a step, idle share), and one SGD epoch on
   the CPU and on the card from the same params and draws (within 1e-5).
   Checks: each loss fell where its run took more than one epoch; the two
   block sizes give the same bits; every trained table is on the card.

9. The sparse delta transport (``sparse_transport_path``,
   ``merge_transport="sparse"``): the compact SGD step on the
   ``transe_score`` kernels, the packed-delta Reduce and sparse BGD, each
   run beside its dense twin.  (a) At phase 3's width and configuration
   (where the capacity clamps to the whole table, so only the compact
   step differs from dense): SGD ``average`` on the host pipeline,
   ``SGD_EPOCHS`` epochs on the whole split (phase 3's SGD run: its loss
   history is held to phase 3's bits and checked to fall; over 2 epochs
   it need not, as an epoch's mean loss can rise by more than 2 epochs
   of training lower it); then on phase 6's
   cut split BGD, 1 epoch; the device pipeline's SGD ``merge_every=2``,
   ``repartition_every=2``, 4 epochs, dense in one block and sparse in
   blocks of 4 and 2; one sparse block under
   ``torch.cuda.set_sync_debug_mode("error")``, the peak memory of a
   sparse block with ``donate_params`` on and off, and a sparse block
   under ``torch.profiler``; the SGD and BGD sparse artifacts evaluated.
   (b) On the cut split, TransH and DistMult, 1 SGD epoch on the host
   pipeline, and joint-48
   TransE for one merge round on the device pipeline.  (c) The
   million-entity cell of ``benchmarks/bench_scale.py`` (``SIZES[1e6]``
   and ``task=roundtrip``): ``random_kg(1e6, 50,000, 100 relations, 16
   held out, seed 5)``, TransE dim 16, 4 workers, batch 4,096, SGD
   ``average``, lr 0.05, device pipeline, 2 epochs in one block per
   transport (twice each), its three byte counts per Reduce and the
   delta capacity, each run's peak memory, then ``kg.evaluate(kb,
   engine="device")`` of the sparse artifact against all 1e6 entities.
   All three kernels' counters are zeroed just before and read just
   after.  Checks: every sparse run gives its dense twin's bits, and the
   sparse runs give each other's across block sizes; the sync-checked
   block raises nothing and gives the dense run's first losses; the
   block makes no device→host copy; ``transe_score`` forward and backward
   launched once a step of every TransE run (none for TransH, DistMult
   and joint) and ``rank_counts`` as the evaluations' chunks predict; the
   1e6 evaluation's metrics are finite and in range.  Reports epoch
   seconds per transport, the profile (launches a step, idle share,
   device→host copies a step) and peak memory.

10. Bounded staleness and sharded tables (``stale_sharded_path``). (a)
   At phase 3's width, SGD ``average`` on the device pipeline with a
   Reduce every epoch, 3 epochs: ``staleness=1`` and ``staleness=2`` on
   the whole split (their losses checked), then on phase 6's cut split
   the synchronous run, ``staleness=0``, ``staleness=1`` in one block and
   in blocks of 2, and ``staleness=1`` on the sparse transport; one stale
   block per transport
   under ``torch.cuda.set_sync_debug_mode("error")``; a stale block's and
   a synchronous block's peak memory and profile.  (b)
   ``benchmarks/bench_async.py``'s ``sync``, ``stale-1`` and ``stale-2``
   cells at its own configuration (``synthetic_kg(1, 300, 10, 6000)``,
   dim 64, L2, batch 270, 4 workers, lr 32, 32 epochs, ``eval_every=2``,
   device pipeline): each cell's final filtered mean rank and whether it
   lies within 1.3 times the sync cell's (the bench's band), and its
   2-epoch block's ms; then 2 rounds of ``staleness=1`` on the CPU and on
   the card, and the refresh phases drawn on both.  (c) Sharded tables
   at phase 3's width on phase 6's cut split, each run beside its
   replicated twin: SGD on the
   sparse transport, host pipeline, 2 epochs, ``average`` and
   ``random``; phase 6's device configuration on the sparse transport;
   BGD sparse, 1 epoch; and ``staleness=1`` sharded against (a)'s sparse
   run.  Then on the sharded SGD artifact
   ``kg.evaluate(kb, engine="device", table_sharding="sharded",
   n_workers=4)`` against the
   replicated evaluation with ``fused=False`` and the fused one, sharded
   filtered ``query_tails`` / ``query_heads`` of 1,024 pairs at k = 10
   against the replicated engine, and the launches of an evaluation per
   layout (profiled on two chunks).  (d) Phase 9 (c)'s 1e6-entity cell on
   the sparse transport per layout (peak memory each), and its sharded
   ``kg.evaluate`` against the replicated one, fused and plain.  All
   three kernels' counters are zeroed just before and read just after.
   Checks: ``staleness=0`` gives the synchronous bits and ``staleness=1``
   does not; block sizes, transports, layouts, evaluations and answers
   give equal bits; the CPU and the card give equal bits and phases; the
   sync-checked blocks raise nothing and give the runs' first losses;
   ``transe_score`` forward and backward launched once a step of every
   TransE run on the card, ``rank_counts`` once a chunk side of every
   evaluation that takes it (the sharded scan and ``fused=False`` take
   none).

11. The online tier (``online_path``), at phase 3's width and
   configuration: benchmarks/bench_online.py's entity holdout (every
   train triple touching a seeded 10 % of the entities moves to the
   delta), a base fit on the rest (SGD ``average``, device pipeline,
   sparse transport, 2 epochs), then ``kb.update(delta, scope="cold",
   epochs=4)`` (4 workers) with its ``plan()`` timed apart, the same
   update through ``delta_dir=`` and ``mapreduce.train`` on the plan,
   a ``scope="touched"`` update, a small update (300 delta triples) on
   the CPU and on the card, the chain's second link, its
   ``load_chain`` on the card and a copy with a link removed; one masked
   block under ``torch.cuda.set_sync_debug_mode("error")`` and one
   profiled; ``kg.evaluate(kb, engine="device")`` of the base and both
   updates on the held-out entities' test triples; and a
   ``RefreshDaemon`` folding 300 triples into a live ``KGServer`` at
   phase 7's ``batch16_wait1ms`` config under a 16 s query stream at
   1,000 QPS.
   All three kernels' counters are zeroed just before and read just
   after.  Checks: frozen rows of both updates bitwise the base's; the
   same seed gives the same fingerprint; ``update()`` is
   ``mapreduce.train`` on its plan bitwise; the small update gives the
   same bits on the CPU and the card; the sync-checked block raises
   nothing and gives the train's first loss, and a block makes no
   device→host copy; the chain reloads to its tip's fingerprint and the
   broken copy is refused; the cold update's filtered mean rank on the
   held-out entities beats the base's; every served answer is bitwise
   the engine of the artifact its fingerprint names, with answers from
   both, no steady-state recompile, ``flush(timeout=...)`` true and the
   daemon stopped; every kernel launched on the path.  Reports plan,
   update, fine-tune epoch, ``load_chain`` and evaluation seconds,
   launches a step and the block's idle share, delta bytes on disk
   against the full save, and p50/p99 across the swap, beside the card's
   name and power limit.

12. Entry points (``entry_points_path``): ``repro_torch.launch.train.main``
   in this process at phase 3's entity count and 1/``DEPTH_CUT`` of its
   triplets (the launcher's own synthetic graph: 15 relations, dim 48,
   batch 256, 4 workers), SGD on the device pipeline for 2 epochs with a checkpoint,
   ``--kg-eval-engine device``, a 300-triple ``--kg-update`` (5 new
   entities) and ``--kg-serve --kg-requests 500``, alone on the host and
   the card.  All three kernels' counters are zeroed just before
   ``main`` and read just after it.  Then, started at once (2 host
   threads each), the same training on a 60,000-triplet graph through
   ``python -m repro_torch.launch.train`` and the three examples at cut
   epochs, beside the direct fit and ``main`` on the subprocess's
   arguments.  Checks: the checkpoint equals a direct ``kg.fit`` with the
   same arguments bitwise; the serve line shows ``steady_recompiles=0``;
   the update applied; the subprocess exits 0 with the final-loss line
   of ``main`` on its arguments; each example exits 0 with its closing
   line.  Reports ``main``'s seconds and serve p50/p99.

13. The shard_map backend (``shard_map_path``), at phase 3's
   configuration on phase 6's cut split (no loss is checked here): (a) a one-rank NCCL mesh in this process holding all
   4 workers: host SGD ``average`` and ``random`` under both
   ``reduce_impl``s and BGD (1 epoch each), the device pipeline's SGD
   (``merge_every=2``, ``repartition_every=2``, one round) dense under
   both Reduces and sparse, BGD, ``kg.evaluate`` and 1,024 filtered
   top-k queries, each against its vmap twin, the twins run first;
   (b) 2 gloo ranks sharing
   the card (``python3 chip_smoke.py --shard-rank SPEC RANK``, the
   kernels built before they start, the graph handed over as a file):
   the device SGD round under ``allgather``, a BGD epoch and the
   evaluation.  All three kernels' counters are zeroed just before (a)'s
   shard_map runs, after the twins, and read just after them; the ranks
   count only their own runs and write the counts to a file.  Checks:
   (a) every pair the vmap bits; (b) SGD the vmap bits, BGD within rtol
   1e-4 / atol 1e-5, the evaluation exact, the ranks equal; every rank's
   join bounded.
   Reports the epoch seconds beside vmap's, the bytes of a dense
   ``average`` Reduce under each ``reduce_impl`` and the gloo seconds
   (gloo over one card, not a multi-GPU speed).
   Then item 12d on both meshes, on the cut split with the entity count
   padded to a multiple of W (14,952: one entity no triplet names), so
   the entity table divides into the workers' row blocks: (a) on the NCCL
   rank, device SGD with ``staleness=2`` (``block_epochs`` 4,
   ``merge_every`` 2, 4 epochs) under the dense, sparse and sparse +
   ``"sharded"`` transports, sparse + ``"sharded"`` device SGD (2 epochs)
   and BGD (1), ``kg.evaluate`` and the 1,024 filtered top-k queries on a
   sharded engine over the mesh, and a sharded ``KGServer`` over the mesh
   (warm-up, waves of 1, 3 and 16, filtered and not, a burst of
   ``SHARD_SERVER_REQUESTS``, the first wave again from the cache); (b)
   on the 2 gloo ranks, a stale sparse + sharded round (4 epochs), a
   sharded sparse SGD round, a sharded evaluation, each rank's resting
   bytes of the tables after a sharded block, and the live server over
   the mesh (rank 0 serving ``SHARD_SERVER_REQUESTS`` requests, rank 1
   following).  Checks: every run and query the vmap twin's bits, every
   served answer the direct engine call's bits, ``steady_recompiles`` 0,
   each rank resting its own half of the entity table and the whole
   relation table, ``transe_score`` and its backward launched on the
   stale and sharded runs.  Reports their epoch seconds beside vmap's,
   the evaluation seconds and the server's p50/p99.

14. LM serving (``lm_serving_path``) for the dense and vlm families,
   through ``models.registry.make_task``, ``DecoderTask.init`` from
   ``torch.Generator(device="cuda").manual_seed(0)``, ``prefill`` /
   ``decode_step`` and ``serve.engine.Engine``, with the configs' dtypes
   (bf16 activations over fp32 parameters): (a) qwen3-4b at full width
   (36 layers, d_model 2,560, 32 heads over 8 KV heads, head_dim 128,
   d_ff 9,728, vocab 151,936, qk-norm, theta 1e6): ``Engine.generate`` of
   32 greedy tokens on 4 prompts of 128 tokens, twice (equal ids), the
   same wave prefilled and decoded by hand (its logits' argmax is the
   ids; prefill seconds, decode ms a step), profiled waves of 1 and 5
   new tokens (launches a decode step, the device's idle share), then 1
   prompt of 4,096 tokens (the flash path, once a layer) and 8 decode
   steps; (b)
   gemma2-2b at full width (26 layers, d_model 2,304, 8 heads over 4 KV
   heads, head_dim 256, vocab 256,000, window 4,096, softcaps 50 / 30,
   sandwich norms, ``embed_scale``): a 4,100-token prompt (past the
   window, not a multiple of it) and 8 decode steps, each step's logits
   against the teacher-forced forward over the 4,108 tokens (logits at
   the last 9 positions only) within ``LM_BF16_TOL``, with equal greedy
   ids wherever the forward's top-2 gap exceeds it; (c) qwen3-4b at full
   width with fp32 activations (a 32-token prompt, 4 decode steps against
   the forward), then smollm-135m, gemma2-9b and llava-next-mistral-7b at
   reduced width, decode against the forward and the card against the
   CPU, within ``LM_FP32_TOL``; (d) ``python -m repro_torch.launch.serve
   --arch qwen3-4b --batch 4 --prompt-len 16 --max-new 32`` in a process
   of its own, its two printed lines read back.  Each model is freed
   before the next is built.  All three kernels' counters are zeroed just
   before (a) and read after (c): no kernel lies on this path (0
   expected).  Reports prefill seconds, decode ms a step, tokens/s and
   peak memory for (a) and (b), and the phase's seconds by part, beside
   the card's name and power limit.

15. LM serving for the moe family (``lm_moe_path``: MLA latent attention
   and the scatter MoE FFN), through the same entry points, bf16
   activations over fp32 parameters: (a) qwen2-moe-a2.7b at its full
   published width and depth (24 layers, d_model 2,048, 16 heads, 60
   routed experts in 64 padded rows plus 4 shared, top-4, moe_d_ff
   1,408, vocab 151,936, capacity factor 1.25; 15,146,059,776
   parameters): ``Engine.generate`` of 32 greedy tokens on 4 prompts of
   128, twice (equal ids), profiled waves of 1 and 5 new tokens, the wave
   by hand (prefill s, decode ms a step), and its prefill again with the
   MoE tapped for the share of (token, expert) pairs the capacity dropped
   (42 slots an expert against a mean of 34.1 pairs); (b)
   deepseek-v2-236b at its full published width cut to
   ``MOE_DEEPSEEK_LAYERS`` = 3 layers (the dense first layer and 2 MoE
   layers: d_model 5,120, 128 heads, MLA kv_lora 512 and q_lora 1,536,
   160 routed experts plus 2 shared, top-6, moe_d_ff 1,536, routed
   scaling 16, vocab 102,400; 9,330,795,520 parameters; its 60 layers
   would not fit one card), the same wave, then 1 prompt of 2,100 tokens
   (MLA's expanded path on the flash loop, once a layer) and 4 decode
   steps; (c) each of those models again at capacity factor E / K
   (dropless): decode against the teacher-forced forward with fp32
   activations within ``LM_FP32_TOL``, and with bf16 activations within
   ``LM_BF16_TOL`` where every layer's routed set agrees (the positions
   whose set flips are counted and printed), then both archs at reduced
   width against the CPU; (d) ``python -m repro_torch.launch.serve --arch
   qwen2-moe-a2.7b --batch 4 --prompt-len 16 --max-new 16`` in a process
   of its own.  The three kernels' counters are zeroed before (a) and
   read after (c): no kernel lies on this path (0 expected).

16. LM serving for the ssm and hybrid families (``lm_recurrent_path``:
   Mamba-2's SSD mixer and Griffin's RG-LRU block), through the same
   entry points, bf16 activations over fp32 parameters, each model at
   its full published width and depth: (a) recurrentgemma-9b (38 layers,
   12 x (rec, rec, local) + (rec, rec); d_model 4,096, RG-LRU width
   4,096 in 16 gate blocks, 16 heads over 1 KV head, head_dim 256,
   window 2,048, gelu MLP 12,288, vocab 256,000; 8,578,519,040
   parameters): ``Engine.generate`` of 32 greedy tokens on 4 prompts of
   128, twice (equal ids), profiled waves of 1 and 5 new tokens, the wave
   by hand, then 1 prompt of 4,100 tokens (past the window and not a
   multiple of it; the RG-LRU scan over all of it) and 8 decode steps
   against the teacher-forced forward over the 4,108 tokens within
   ``REC_BF16_TOL`` (``LM_BF16_TOL`` here); (b) mamba2-130m (24 SSD
   layers, d_model 768, state 128, 24 heads of 64, chunk 256, vocab
   50,280; 128,983,488 parameters): the same wave, then 1 x 4,100 (17
   chunks, the last one padded) and ``REC_SSM_STEPS`` = 96 decode steps,
   past ``GEN_MARGIN``, each timed (steps 1-8 against 89-96: a
   fixed-size state), the last 8 against the forward within its own
   ``REC_BF16_TOL``; (c) each model
   again with fp32 activations, the wave's prefill and 8 decode steps and
   the long prompt's last 8 steps against the forward within
   ``REC_FP32_TOL`` (``LM_FP32_TOL`` but for mamba2's own), then both
   archs at reduced width against the CPU within ``LM_FP32_TOL``;
   (d) ``python -m repro_torch.launch.serve --arch mamba2-130m --batch 4
   --prompt-len 16 --max-new 16`` in a process of its own.  The three
   kernels' counters are zeroed before (a) and read after (c): no kernel
   lies on this path (0 expected).

17. LM serving for the encoder-decoder (``lm_encdec_path``), through the
   same entry points, bf16 activations over fp32 parameters, at
   whisper-base's full published width and depth (6 encoder and 6
   decoder layers, d_model 512, 8 heads, d_ff 2,048, LayerNorm and GELU,
   vocab 51,865; 70,627,840 parameters), over 1,500 post-conv frames (the
   30 s window; the conv frontend is a stub, as in the reference): (a)
   the encoder alone, then ``Engine.generate`` of 32 greedy tokens on 4
   prompts of 16, twice (equal ids), profiled waves of 1 and 5 new
   tokens, the wave by hand (prefill s, decode ms a step) against the
   teacher-forced forward within ``LM_BF16_TOL``; (b) 1 prompt of 384
   tokens and 64 decode steps, which fill ``decoder_len`` 448 (the
   self-KV cache's L + GEN_MARGIN slots) exactly: a 65th step must raise,
   and the last 8 steps agree with the forward; (c) fp32 activations,
   the wave's and the long prompt's prefill and 8 decode steps against
   the forward within ``LM_FP32_TOL``, then reduced width on the card
   against the CPU; (d) ``python -m repro_torch.launch.serve --arch
   whisper-base --batch 4 --prompt-len 16 --max-new 16`` in a process of
   its own.  The kernels' counters are zeroed before (a) and read after
   (c): none lies on this path (0 expected).

18. LM training (``lm_train_path``), bf16 activations over fp32
   parameters: (a) smollm-135m at its full width and depth (30 layers,
   d_model 576, 9 heads over 3 KV heads, vocab 49,152) through
   ``train.loop.Trainer`` on the token pipeline, B = 8 x 512 tokens,
   adamw at the launcher's defaults but ``--lr 1e-3`` (``TRAIN_LR``), 16
   steps: the mean loss of the last 4 steps below that of the first 4;
   one more step profiled and two timed; a forward and backward's peak
   memory with the chunked cross entropy against the full one; 8 steps
   uninterrupted against ``ft.run_with_recovery`` over 4 steps and a
   checkpoint, a failure injected at step 4 and a fresh ``Trainer``
   resumed from that checkpoint to 8 (one restart; the resumed steps'
   losses equal, the parameters bitwise or within the reference's own
   rtol 1e-6 / atol 1e-7); (b)
   whisper-base at full width, ``make_train_step`` on
   ``EncDecTask.loss`` with 1,500 frames and 448 tokens, B = 4, at its
   ``train_microbatches`` (2), timed and profiled, then in fp32 the
   gradients of microbatches 2 against 1 on the same batch within
   ``TRAIN_MB_TOL``, every parameter's finite and nonzero; (c) ``python
   -m repro_torch.launch.train --arch smollm-135m --steps 4`` in a
   process of its own, its last line in the reference's form.  The two
   launcher processes (phase 17's and this one) start with phase 17 and
   run beside both phases' in-process parts.  The
   kernels' counters are zeroed before (a) and read after (b): none lies
   on this path (0 expected).

19. The LM mesh and the cross-pod merge (``lm_mesh_path``): (a)
   ``core/local_sgd.outer_merge`` over 2 gloo ranks sharing the card
   (``python3 chip_smoke.py --mesh-rank SPEC RANK``), each pod holding
   smollm-135m's parameter tree (the seeded init plus a pod-seeded step):
   average without and with int8 compression, with outer momentum, with
   a dead pod, random and miniloss_global with and without one, every
   merged tree bitwise against the same formulas over all pods' trees in
   one process; (b) the expert-parallel MoE dispatch
   (``models/moe._apply_moe_shardmap``) of one qwen2-moe-a2.7b MoE layer
   at full width (d 2,048, 60 experts padded to 64, top-4, ffn 1,408) in
   fp32 over 4 gloo ranks (a 2 x 2 (data, model) mesh) sharing the card,
   B = 4 x 128 tokens, at cf = E / K: each rank's rows within
   ``MESH_MOE_TOL`` of the scatter path on the whole batch, the dispatch
   taken, a call's time and its collectives' wire bytes (both ranks
   groups start together and run beside (c)); (c) ``train.loop.Trainer``
   over a one-rank NCCL mesh (``launch.mesh.make_mesh_for_devices(1)``)
   against the mesh-less ``Trainer``: smollm-135m at full width and depth,
   4 adamw steps of 8 x 512 tokens, losses and parameters bitwise; (d)
   ``python -m repro_torch.launch.dryrun --arch smollm-135m --shape
   train_4k`` on the (16, 16) and (2, 16, 16) meshes, each in a process
   of its own that sees no card (started with phase 17): exit 0, status
   ok, peak under 16 GB a device, the analytic model FLOPs, traced FLOPs
   above 0.  The kernels' counters are zeroed before (c) and read after
   it: none lies on this path (0 expected).

Prints the card's name and power limit, one JSON line with the kernel table
and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without a CUDA device, outside a checkout of the repository, or when
any phase fails.  Details go to ``chiprun_out/chip_smoke.json``.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))

FB15K = dict(n_entities=14951, n_relations=1345, n_triplets=592213)
DIM = 50
# host seconds the graph may take, else cut it.  At 60 a host whose probe
# took 6.1 s or more cut the graph, and the checked losses then trained
# on other data than the runs that had checked them; the full size takes
# 43-58 s on the hosts of an H100 80GB HBM3 at 700 W seen so far.
GRAPH_BUDGET_S = 90.0
PROBE_TRIPLETS = 60000
N_QUERY_PAIRS = 1024
HOST_CHECK_ROWS = 512
KERNEL_CASES = ((14951, 256), (1_000_000, 4096))   # (E, B)
# transe_score cases: (W, B, E, R); W = 1 is one unstacked table.  The
# last is the sparse transport's compact step at the training step's
# shape: tables of the 4B entity and 2B relation rows a batch references
TRANSE_CASES = ((4, 256, FB15K["n_entities"], FB15K["n_relations"]),
                (1, 1 << 20, 1_000_000, FB15K["n_relations"]),
                (4, 256, 4 * 256, 2 * 256))
TRAIN = dict(n_workers=4, batch_size=256)   # kg.make_configs' defaults
# Phases 6, 8-10 and 13 run the training path's configuration many times
# over, each run beside its twin.  Their runs whose loss is not checked
# keep its widths (every entity and relation, dim 50, 4 workers, batch
# 256) and its valid and test splits, and train on the first 1/DEPTH_CUT
# of its training split (the cut split), each epoch 1/DEPTH_CUT of its
# steps.  A loss checked to fall trains on the whole split: a cut epoch
# ends in a Reduce before the loss settles, and the next can start higher.
# An eighth since the moe serving phase joined: with a quarter the whole
# script took 1,060 s of its 1,200 s limit on an H100 80GB HBM3 at 700 W.
# A sixteenth since the recurrent LM serving phase joined: with an eighth
# it took 884 s there on a slow host.
DEPTH_CUT = 16
SGD_EPOCHS, BGD_EPOCHS = 4, 3
# phase 6: the device pipeline's SGD configuration, and the counters its
# draws are held on, CPU against card
DEVICE_SGD = dict(strategy="average", pipeline="device", merge_every=2,
                  repartition_every=2)
DRAW_COUNTERS = 1 << 20
# One SGD epoch on the CPU (plain versions) against the card (kernels),
# from the same params and draws.  The kernels equal their plain versions
# bitwise, and every other operation of a step is an elementwise IEEE op,
# an in-order sum or a correctly rounded root (util.sqrt_rn) on both
# devices, and the epoch's loss a fixed-order tree (util.pairwise_mean),
# so params and loss are expected to agree bitwise.  The gates allow for
# one ulp somewhere flipping an L1 sign, which moves one entry by
# 2 * lr / B = 7.8e-5: params within 1e-4, loss within rtol 1e-5.  Phase 6
# holds the device pipeline's round to equal bits.
CPU_EPOCH_PARAM_TOL, CPU_EPOCH_LOSS_RTOL = 1e-4, 1e-5
# phase 7: the live server, at the batching configs of
# benchmarks/bench_latency.py (label, max_batch, max_wait_us)
LIVE_CONFIGS = (("unbatched", 1, 0), ("batch16_wait1ms", 16, 1000),
                ("batch64_wait2ms", 64, 2000))
LIVE_K = 10
LIVE_BURST, LIVE_ARRIVALS, LIVE_UNIQUE = 2048, 2000, 500
# (burst, arrivals) of a config that serves one query a wave: at ~120
# completions/s its full burst and open loop took 51 s of a 884 s script
# on an H100 80GB HBM3 at 700 W, so it runs a quarter of each since the
# recurrent LM serving phase joined
LIVE_LOAD = {"unbatched": (512, 500)}
LIVE_SWAP_ARRIVALS = 1000
LIVE_TIMEOUT_S = 60         # every future's wait
# wave sizes that fill every bucket of 64, most of them partly
PARITY_SIZES = (1, 2, 3, 5, 9, 17, 33, 64)
PARITY_CELLS = (("tails", "plain"), ("tails", "filtered"),
                ("tails", "exclude"), ("heads", "plain"),
                ("heads", "filtered"), ("heads", "exclude"),
                ("relations", "plain"))
# phase 8: the model family and joint negatives, at phase 3's width; the
# joint objective's two cells are benchmarks/bench_async.py's joint-48
# (SGD, L2, merge_every=2, device pipeline) and the full pool under BGD
FAMILY_SGD_EPOCHS, FAMILY_BGD_EPOCHS, JOINT_EPOCHS = 1, 1, 4
FAMILY_RERUN_STEPS = 20
JOINT_SGD = dict(negatives="joint", neg_candidates=48, norm="l2",
                 pipeline="device", merge_every=2)
JOINT_BGD = dict(negatives="joint", norm="l1")
# (label, model, options) of the same-seed rerun and the CPU-against-card
# epoch (the joint cell on the host pipeline)
FAMILY_CELLS = (("transh", "transh", {}), ("distmult", "distmult", {}),
                ("transe_joint48", "transe", JOINT_SGD))
# One SGD epoch on the CPU and on the card from the same params and
# draws.  Autograd's backward sums a gather's duplicate rows and a
# broadcast's reduction in each device's own order, so the two may differ
# in the last bits of a few rows: within 1e-5.
FAMILY_CPU_TOL = 1e-5
# phase 9: the sparse transport; (c) is benchmarks/bench_scale.py's
# SIZES[1_000_000] row and its task=roundtrip (n_entities, n_triplets,
# batch, epochs; relations, held-out triples, graph seed, dim, lr)
SPARSE_DEVICE = dict(DEVICE_SGD, merge_transport="sparse")
SCALE_CELL = dict(n_entities=1_000_000, n_triplets=50_000, batch=4_096,
                  epochs=2, n_relations=100, n_eval=16, seed=5, dim=16,
                  learning_rate=0.05)
# phase 10: bounded staleness at phase 3's width (SGD average on the
# device pipeline, a Reduce every epoch), and benchmarks/bench_async.py's
# sync / stale-1 / stale-2 cells at its own configuration (graph seed and
# sizes, dim, norm, batch, workers, lr, epochs, eval_every, the 1.3 quality
# band around the sync cell's final rank), its blocks timed as the bench
# does (the median of rounds of calls, round-robin over the cells)
STALE_EPOCHS = 3
STALE_SGD = dict(strategy="average", pipeline="device", merge_every=1)
ASYNC_CELL = dict(graph=(1, 300, 10, 6000), dim=64, norm="l2",
                  batch_size=270, n_workers=4, learning_rate=32.0,
                  epochs=32, eval_every=2, ref_band=1.3)
ASYNC_STALENESS = (("sync", 0), ("stale-1", 1), ("stale-2", 2))
ASYNC_REPEATS, ASYNC_ITERS = 3, 5
# phase 11: the online tier at phase 3's width (TransE dim 50, L1, 4
# workers).  The holdout is benchmarks/bench_online.py's _split_holdout:
# every train triple touching a seeded DELTA_FRAC of the entities
ONLINE_DELTA_FRAC, ONLINE_HOLDOUT_SEED = 0.10, 7
ONLINE_BASE = dict(strategy="average", pipeline="device",
                   merge_transport="sparse", block_epochs=2)
ONLINE_UPDATE = dict(epochs=4, seed=1, n_workers=4)
ONLINE_SMALL = 300          # delta triples of the small updates
# the query stream across the refresh: long enough that the refresh
# (an update and the new graph's known index, ~6 s) ends inside it
ONLINE_STREAM = dict(arrivals=16000, rate=1000.0, after=200)
# phase 12: the launcher at phase 3's entity count and 1/DEPTH_CUT of its
# triplets (its own synthetic graph: 15 relations, dim 48, batch 256, 4
# workers, as the launcher fixes them), a small update delta and the
# examples' cut epochs.  Cut since the moe serving phase joined: at the
# full count the launcher's graph build alone took 31-57 s of host time.
ENTRY_GRAPH = dict(entities=FB15K["n_entities"],
                   triplets=FB15K["n_triplets"] // DEPTH_CUT, epochs=2)
ENTRY_REQUESTS = 500
ENTRY_DELTA = dict(triples=300, new_entities=5, seed=11)
ENTRY_EXAMPLE_EPOCHS = 4
# the launcher's subprocess trains a graph of the probe's triplet count,
# held against main() in this process on the same arguments
ENTRY_SUBPROCESS_TRIPLETS = PROBE_TRIPLETS
# each subprocess's host threads: four start at once on the card's host
ENTRY_SUBPROCESS_THREADS = 2
ENTRY_SUBPROCESS_S = 180    # the launcher subprocess's and examples' bound
# phase 13: the shard_map backend; gloo ranks sharing the one card
SHARD_GLOO_RANKS = 2
SHARD_M1_BACKEND = "nccl"    # the one-rank mesh of (a)
SHARD_COLLECTIVE_S = 120    # a collective's timeout in every rank
SHARD_RANK_S = 240          # every gloo rank's bound
# phase 13's item-12d runs: bounded staleness and sharded tables
SHARD_STALE = dict(strategy="average", pipeline="device", merge_every=2,
                   block_epochs=4, staleness=2)
SHARD_STALE_EPOCHS = 4
SHARDED = dict(merge_transport="sparse", table_sharding="sharded")
SHARD_TRANSPORTS = {"dense": {}, "sparse": dict(merge_transport="sparse"),
                    "sharded": SHARDED}
SHARD_SERVER_REQUESTS = 300
SHARD_SERVER_WAVES = ((1, False), (3, True), (16, False), (16, True))
DEVICE = "cuda"
# the CUDA kernels of each transe_score wrapper call, timed as their sum
TRANSE_KERNELS = {"fwd": ("transe_score_fwd_kernel",),
                  "bwd": ("transe_score_bwd_grads_kernel",
                          "transe_score_bwd_rows_kernel")}
# NVIDIA H100 data sheet, dense rates.  "fp32" counts an FMA as two
# operations (SMs x 128 lanes x 2 x boost clock); "fp32_issue" is the FP32
# instruction rate, one per lane a clock (SMs x 128 x clock: 132 x 128 x
# 1.98 GHz on the SXM, 114 x 128 x 1.755 GHz on the PCIe card), the rate of
# work that cannot contract into FMAs; "tf32" and "bf16" are the tensor
# cores'; "bytes" the HBM rate.
PEAKS = {
    "H100 PCIe": {"fp32": 51e12, "fp32_issue": 25.6e12, "tf32": 378e12,
                  "bf16": 756e12, "bytes": 2.0e12},
    "H100": {"fp32": 67e12, "fp32_issue": 33.45e12, "tf32": 495e12,
             "bf16": 989e12, "bytes": 3.35e12},
}


def fail(msg):
    raise RuntimeError(msg)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name):
    for key, rates in PEAKS.items():
        if key in name:
            return rates
    print(f"no peak rates on record for {name!r}: bounds use the H100 SXM's",
          flush=True)
    return PEAKS["H100"]


def cuda_ms(torch, fn, reps, warmup=1):
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back runs
    (CUDA events), after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_out(torch, fn):
    """``(fn(), device milliseconds of that one run)`` (CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def kernel_ms(torch, fn, reps, names, sessions=3):
    """Device milliseconds per call of ``fn`` in each CUDA kernel whose name
    holds one of ``names``, ``{name: ms}``, over ``reps`` calls
    (``torch.profiler``, device activity only; one warm-up call first):
    for each name the mean over the launches the profiler recorded (it has
    been seen to drop a few of 50 records, and once every record of one
    kernel in a session).  A session that recorded no launch of a name, or
    more than one per call, is run again, up to ``sessions`` in all; then
    it fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out, counts = {}, {}
        for name in names:
            us, count = 0.0, 0
            for ev in prof.key_averages():
                if ev.device_type == torch.autograd.DeviceType.CUDA and \
                        name in ev.key:
                    us += getattr(ev, "self_device_time_total", None) or \
                        ev.self_cuda_time_total
                    count += ev.count
            counts[name] = count
            out[name] = us / 1e3 / max(count, 1)
        if all(0 < n <= reps for n in counts.values()):
            return out
        print(f"the profiler saw {counts} launches in {reps} calls: "
              "profiling again", flush=True)
    fail(f"the profiler saw {counts} launches in {reps} calls, in each of "
         f"{sessions} sessions")


def profile_busy(torch, fn):
    """Wall seconds of ``fn`` (ending in a synchronize) under
    ``torch.profiler`` with device activity only, the device's busy
    seconds within it, and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None) or \
                ev.self_cuda_time_total
            if us > 0:
                kernels.append((us, ev.count, ev.key))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels) / 1e6
    return {"wall_s": wall_s, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall_s,
            "launches": sum(k[1] for k in kernels),
            "dtoh_copies": sum(n for _, n, key in kernels
                               if "Memcpy DtoH" in key),
            "top": [{"kernel": key[:90], "launches": n, "ms": us / 1e3}
                    for us, n, key in kernels[:10]]}


def wall(torch, fn):
    """(result, host seconds) of ``fn``, ending in a device synchronize."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rank_counts_bound(B, E, k, itemsize, norm, rates):
    """Least milliseconds for one rank_counts call, ``(ms, "bytes"|
    "operations")``: the larger of its bytes (each input read once, the
    output written once) over the memory rate and its operations.

    L1 runs on the CUDA cores, two FP32 instructions per element pair
    (subtract, add of the absolute value: they cannot contract into an FMA)
    and a compare per pair, at the FP32 instruction rate.  L2 is the larger
    of the contraction ``2·B·E·k`` at the tensor cores' rate for the input
    type (TF32 for fp32, bf16) and its CUDA-core work at the instruction
    rate: at least 4 operations per pair of epilogue and the in-order sums
    of squares, ``2·k·(B + E)``."""
    nbytes = (B + E) * k * itemsize + B * 4 + B * 4
    issue = rates["fp32_issue"]
    if norm == "l1":
        t_ops = (2 * B * E * k + B * E) / issue
    else:
        tensor = rates["tf32" if itemsize == 4 else "bf16"]
        t_ops = max(2 * B * E * k / tensor,
                    (4 * B * E + 2 * k * (B + E)) / issue)
    t_bytes = nbytes / rates["bytes"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rank_inputs(torch, E, B, norm, dtype, seed=None):
    """The kernel phase's inputs: a TransE-range table, queries ``h + r``
    (unit-norm r), and gold distances to random rows, on the device."""
    from repro_torch.core.models import dissimilarity

    g = torch.Generator(device=DEVICE).manual_seed(E if seed is None
                                                   else seed)
    bound = 6.0 / DIM ** 0.5           # the TransE init range
    table = (torch.rand(E, DIM, generator=g, device=DEVICE) * 2 - 1) * bound
    rel = torch.randn(B, DIM, generator=g, device=DEVICE)
    rel = rel / rel.norm(dim=1, keepdim=True)
    heads = torch.randint(0, E, (B,), generator=g, device=DEVICE)
    golds = torch.randint(0, E, (B,), generator=g, device=DEVICE)
    tab = table.to(dtype).contiguous()
    q = (table[heads] + rel).to(dtype).contiguous()
    gold = dissimilarity(q.float() - tab[golds].float(), norm).contiguous()
    return q, tab, gold


def plain_distance(torch, q, rows, norm):
    """The plain version's distance of each query to its row (``(B, k)``
    each), its operations in its order: in-order sums, L2 expanded."""
    from repro_torch.kernels.ref import l2_distance

    q, rows = q.float(), rows.float()
    if norm == "l1":
        d = (q[:, 0] - rows[:, 0]).abs()
        for j in range(1, q.shape[1]):
            d = d + (q[:, j] - rows[:, j]).abs()
        return d
    qq, qe, ee = q[:, 0] * q[:, 0], q[:, 0] * rows[:, 0], \
        rows[:, 0] * rows[:, 0]
    for j in range(1, q.shape[1]):
        qq = qq + q[:, j] * q[:, j]
        qe = qe + q[:, j] * rows[:, j]
        ee = ee + rows[:, j] * rows[:, j]
    return l2_distance(qq, qe, ee)


def tie_stress_inputs(torch, E, B, norm, dtype, copies=8, seed=1):
    """Inputs whose counts hang on single ulps: each query's gold row is
    written into ``copies`` other rows of the table, half of them exact
    copies and half one ulp off in one coordinate (up or down), and the
    gold distance is the plain version's own arithmetic for the gold row.
    So ``copies`` pairs a query sit exactly at, or one ulp from, its
    threshold."""
    q, tab, _ = rank_inputs(torch, E, B, norm, dtype, seed=seed)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    perm = torch.randperm(E, generator=g, device=DEVICE)
    golds, slots = perm[:B], perm[B:B * (copies + 1)].view(B, copies)
    src = tab[golds]                                         # (B, k)
    rows = src[:, None, :].expand(B, copies, DIM).clone()
    half = copies // 2
    col = torch.randint(0, DIM, (B, copies - half), generator=g,
                        device=DEVICE)
    up = torch.rand(B, copies - half, generator=g, device=DEVICE) < 0.5
    off = rows[:, half:, :]
    ints = {2: torch.int16, 4: torch.int32}[tab.element_size()]
    bits = off.gather(2, col[..., None]).view(ints)
    # one ulp up or down in magnitude; a zero steps up only
    zero = (bits == 0) | (bits == torch.iinfo(ints).min)
    step = torch.where(up[..., None] | zero, 1, -1).to(ints)
    off.scatter_(2, col[..., None], (bits + step).view(tab.dtype))
    tab = tab.clone()
    tab[slots.reshape(-1)] = rows.reshape(-1, DIM)
    gold = plain_distance(torch, q, tab[golds], norm).contiguous()
    return q, tab.contiguous(), gold


def rank_case(torch, q, tab, gold, norm, rates, timed):
    """One rank_counts case: counts against the plain version, the share of
    pairs the L2 screen re-checked, the kernel's attributes and, if
    ``timed``, the kernel's, the plain version's and the library call's
    times beside the bound."""
    from repro_torch.kernels import rank_topk, ref

    (B, k), E = q.shape, tab.shape[0]
    rechecked = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    got = rank_topk.rank_counts(q, tab, gold, norm=norm,
                                recheck_counter=rechecked)
    small = B * E < 1e8
    # at the large shape the plain version's one timed run is this one
    want, want_ms = cuda_ms_out(
        torch, lambda: ref.rank_counts_ref(q, tab, gold, norm))
    bound_ms, bound_by = rank_counts_bound(B, E, k, tab.element_size(), norm,
                                           rates)
    case = {
        "B": B, "E": E, "k": k, "norm": norm,
        "dtype": str(q.dtype).replace("torch.", ""),
        "count_mismatches": int((got != want).sum()),
        "max_abs_err": int((got - want).abs().max()),
        "mean_count": float(want.float().mean()),
        "rechecked_share": int(rechecked) / (B * E) if norm == "l2" else None,
        "kernel": rank_topk.kernel_info(q.dtype, norm, k, B, E),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if timed:
        call = lambda: rank_topk.rank_counts(q, tab, gold, norm=norm)
        reps = 50 if small else 5
        # the kernels' own device time per call (the profiler), and the
        # wrapper call's (CUDA events: at the evaluation chunk that is set
        # by the host's launch overhead, not the card)
        case["kernels_ms"] = kernel_ms(torch, call, reps,
                                       rank_topk.KERNELS[norm])
        case["ms"] = sum(case["kernels_ms"].values())
        case["call_ms"] = cuda_ms(torch, call, reps=reps)
        case["plain_ms"] = cuda_ms(torch, lambda: ref.rank_counts_ref(
            q, tab, gold, norm), reps=3, warmup=0) if small else want_ms
        qf, tf = q.float(), tab.float()
        p = 1.0 if norm == "l1" else 2.0
        # cdist's grid holds < 2**31 outputs: one call per part
        parts = -(-B * E // 2**31)
        case["library_ms"] = cuda_ms(torch, lambda: sum(
            (torch.cdist(qf, t, p=p) < gold[:, None]).sum(1)
            for t in tf.chunk(parts)),
            reps=5 if small else 1, warmup=1 if small else 0)
        case["library_calls"] = parts
    return case


def kernel_phase(torch, rates):
    """rank_counts at every KERNEL_CASES shape, L1 and L2, fp32 and bf16,
    timed; then the tie-stress inputs at the evaluation chunk, checked."""
    cases = []
    for E, B in KERNEL_CASES:
        for norm in ("l1", "l2"):
            for dtype in (torch.float32, torch.bfloat16):
                case = rank_case(torch, *rank_inputs(torch, E, B, norm, dtype),
                                 norm, rates, timed=True)
                print("rank_counts " + json.dumps(case), flush=True)
                cases.append(case)
        torch.cuda.empty_cache()
    E, B = KERNEL_CASES[0]
    for norm in ("l1", "l2"):
        for dtype in (torch.float32, torch.bfloat16):
            case = rank_case(torch, *tie_stress_inputs(torch, E, B, norm,
                                                       dtype),
                             norm, rates, timed=False)
            case["tie_stress"] = True
            print("rank_counts " + json.dumps(case), flush=True)
            cases.append(case)
            if norm == "l2" and not case["rechecked_share"]:
                fail(f"the L2 screen re-checked no pair of the tie-stress "
                     f"inputs: {case}")
    bad = [c for c in cases if c["count_mismatches"]]
    if bad:
        fail(f"rank_counts kernel disagrees with its plain version: {bad}")
    return cases


def bits_equal(a, b):
    """Same dtype, shape and bits (NaN payloads and signed zeros too)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return bool(torch.equal(a.contiguous().view(ints),
                            b.contiguous().view(ints)))


def max_err(got, want):
    return max(float((a.float() - b.float()).abs().max()) if a.numel()
               else 0.0 for a, b in zip(got, want))


def transe_bounds(n, k, itemsize, norm, dense_rows, rates):
    """Least milliseconds of one transe_score forward and one backward
    kernel over ``n`` triplets: the larger of bytes over the memory rate
    and fp32 operations over the fp32 rate, each ``(ms, "bytes"|
    "operations")``.

    Forward bytes: five k-rows per triplet, the (n, 5) int32 ids, three
    fp32 outputs.  Operations: u and v (2 each per column), |x| or x² and
    the add into the sum (2 each per column), the hinge (3), and for L2
    two adds and two roots.  Backward bytes: the five rows, the ids, four
    fp32 per-triplet inputs (g, loss, d_pos, d_neg), the sorted scatter
    rows and their order (2 x 5n int32), and the dense gradient, each of
    its ``dense_rows`` rows written once (the kernel writes the untouched
    rows' zeros too).  Operations: u and v (4 per column), their signs or
    quotients (2), the scaling (2), gu + gv (1), one add per contribution
    (5), and the scale per triplet (1)."""
    flops, bw = rates["fp32"], rates["bytes"]
    row = k * itemsize
    out = []
    for nbytes, ops in (
            (n * (5 * row + 5 * 4 + 3 * 4),
             n * (8 * k + 3 + (4 if norm == "l2" else 0))),
            (n * (5 * row + 5 * 4 + 4 * 4 + 2 * 5 * 4) + dense_rows * row,
             n * (14 * k + 1))):
        t_bytes, t_ops = nbytes / bw, ops / flops
        out.append((max(t_bytes, t_ops) * 1e3,
                    "bytes" if t_bytes >= t_ops else "operations"))
    return out


def transe_library(torch, ent, rel, idx, norm):
    """One PyTorch formulation of the forward (gathers, vector_norm, clamp)
    on flat tables and worker-offset ids, and a closure timing autograd
    of it (the backward).  Timed only; the port never calls it."""
    from repro_torch.util import worker_offsets

    k = ent.shape[-1]
    flat_e = ent.detach().reshape(-1, k).requires_grad_()
    flat_r = rel.detach().reshape(-1, k).requires_grad_()
    ix = idx.long()
    if ent.dim() == 3:
        eo, ro = worker_offsets(ix, ent.shape[1], rel.shape[1])
        ix = ix + torch.stack([eo, ro, eo, eo, eo], dim=-1)
    ix = ix.reshape(-1, 5)
    p = 1 if norm == "l1" else 2

    def fwd():
        h, t, nh, nt = (flat_e[ix[:, c]].float() for c in (0, 2, 3, 4))
        r = flat_r[ix[:, 1]].float()
        d_pos = torch.linalg.vector_norm(h + r - t, ord=p, dim=-1)
        d_neg = torch.linalg.vector_norm(nh + r - nt, ord=p, dim=-1)
        return torch.clamp(1.0 + d_pos - d_neg, min=0.0)

    with torch.enable_grad():
        out = fwd()
    g = torch.full_like(out, 1.0 / idx.shape[-2])

    def bwd():
        return torch.autograd.grad(out, [flat_e, flat_r], grad_outputs=g,
                                   retain_graph=True)

    def nograd_fwd():
        with torch.no_grad():
            return fwd()

    return nograd_fwd, bwd


def transe_kernel_phase(torch, rates):
    """``transe_score`` forward and backward against their plain versions
    (equal bits), the backward twice (equal bits), and the times."""
    from repro_torch.kernels import ref, transe_score as ts

    cases = []
    for W, B, E, R in TRANSE_CASES:
        g = torch.Generator(device=DEVICE).manual_seed(E + B)
        lead = (W,) if W > 1 else ()
        bound = 6.0 / DIM ** 0.5           # the TransE init range
        ent32 = (torch.rand(*lead, E, DIM, generator=g, device=DEVICE)
                 * 2 - 1) * bound
        rel32 = torch.randn(*lead, R, DIM, generator=g, device=DEVICE)
        rel32 = rel32 / rel32.norm(dim=-1, keepdim=True)
        idx = torch.stack(
            [torch.randint(0, n, (*lead, B), generator=g, device=DEVICE)
             for n in (E, R, E, E, E)], dim=-1).to(torch.int32).contiguous()
        n = W * B
        small = n <= 4096
        for norm in ("l1", "l2"):
            for dtype in (torch.float32, torch.bfloat16):
                ent, rel = ent32.to(dtype), rel32.to(dtype)
                fwd = ts.transe_score(ent, rel, idx, margin=1.0, norm=norm)
                gs = torch.full(idx.shape[:-1], 1.0 / B, device=DEVICE)
                bwd = ts.transe_score_bwd(ent, rel, idx, gs, *fwd, norm=norm)
                bwd2 = ts.transe_score_bwd(ent, rel, idx, gs, *fwd,
                                           norm=norm)
                want_f = ref.transe_score_ref(ent, rel, idx, 1.0, norm)
                want_b = ref.transe_score_bwd_ref(ent, rel, idx, gs, *fwd,
                                                  norm)
                torch.cuda.synchronize()
                reps = 50 if small else 5
                lib_f, lib_b = transe_library(torch, ent, rel, idx, norm)
                (fb, fby), (bb, bby) = transe_bounds(
                    n, DIM, ent.element_size(), norm,
                    ent.shape[:-1].numel() + rel.shape[:-1].numel(), rates)
                case = {
                    "W": W, "B": B, "E": E, "R": R, "k": DIM, "norm": norm,
                    "dtype": str(dtype).replace("torch.", ""),
                    "active_hinges": float((fwd[0] > 0).float().mean()),
                    "fwd_max_abs_err": max_err(fwd, want_f),
                    "fwd_bitwise": all(map(bits_equal, fwd, want_f)),
                    "bwd_max_abs_err": max_err(bwd, want_b),
                    "bwd_bitwise": all(map(bits_equal, bwd, want_b)),
                    "bwd_repeat_bitwise": all(map(bits_equal, bwd, bwd2)),
                    "fwd_ms": sum(kernel_ms(torch, lambda: ts.transe_score(
                        ent, rel, idx, margin=1.0, norm=norm), reps,
                        TRANSE_KERNELS["fwd"]).values()),
                    # the backward's kernels, each per call, and their sum
                    "bwd_kernels_ms": kernel_ms(
                        torch, lambda: ts.transe_score_bwd(
                            ent, rel, idx, gs, *fwd, norm=norm), reps,
                        TRANSE_KERNELS["bwd"]),
                    # the wrappers' calls: id range checks (one host sync
                    # each) and the backward's sorts included
                    "fwd_call_ms": cuda_ms(torch, lambda: ts.transe_score(
                        ent, rel, idx, margin=1.0, norm=norm), reps),
                    "bwd_call_ms": cuda_ms(torch, lambda: ts.transe_score_bwd(
                        ent, rel, idx, gs, *fwd, norm=norm), reps),
                    "fwd_plain_ms": cuda_ms(torch, lambda: (
                        ref.transe_score_ref(ent, rel, idx, 1.0, norm)),
                        3 if small else 1, warmup=0),
                    "bwd_plain_ms": cuda_ms(torch, lambda: (
                        ref.transe_score_bwd_ref(ent, rel, idx, gs, *fwd,
                                                 norm)),
                        3 if small else 1, warmup=0),
                    "fwd_library_ms": cuda_ms(torch, lib_f, reps),
                    "bwd_library_ms": cuda_ms(torch, lib_b, reps),
                    "fwd_bound_ms": fb, "fwd_bound_by": fby,
                    "bwd_bound_ms": bb, "bwd_bound_by": bby,
                    # the backward's per-triplet (n, 2, k) fp32 gu, gv
                    "bwd_scratch_bytes": n * 2 * DIM * 4,
                }
                case["bwd_ms"] = sum(case["bwd_kernels_ms"].values())
                print("transe_score " + json.dumps(case), flush=True)
                cases.append(case)
                del fwd, bwd, bwd2, want_f, want_b, lib_f, lib_b
        del ent32, rel32, idx
        torch.cuda.empty_cache()
    bad = [c for c in cases if not (c["fwd_bitwise"] and c["bwd_bitwise"]
                                    and c["bwd_repeat_bitwise"])]
    if bad:
        fail(f"transe_score kernels disagree with their plain versions or "
             f"with themselves: {bad}")
    return cases


def build_graph():
    """The FB15k-size synthetic graph, its triplet count cut (and the cut
    printed) when the probe says the full size would take the host over
    GRAPH_BUDGET_S seconds."""
    from repro_torch.data import kg as kg_data

    t0 = time.perf_counter()
    kg_data.synthetic_kg(0, FB15K["n_entities"], FB15K["n_relations"],
                         PROBE_TRIPLETS)
    probe_s = time.perf_counter() - t0
    full = FB15K["n_triplets"]
    estimate = probe_s * full / PROBE_TRIPLETS
    n_triplets = full
    if estimate > GRAPH_BUDGET_S:
        n_triplets = int(PROBE_TRIPLETS * GRAPH_BUDGET_S / probe_s)
        n_triplets = max(PROBE_TRIPLETS, n_triplets - n_triplets % 1000)
        print(f"graph cut: n_triplets {full} -> {n_triplets} (a "
              f"{PROBE_TRIPLETS}-triplet probe took {probe_s:.2f} s, full "
              f"size estimated at {estimate:.1f} s > {GRAPH_BUDGET_S:.0f} s "
              "of host time)", flush=True)
    t0 = time.perf_counter()
    graph = kg_data.synthetic_kg(0, FB15K["n_entities"],
                                 FB15K["n_relations"], n_triplets)
    seconds = time.perf_counter() - t0
    return graph, {"n_triplets_asked": n_triplets, "probe_s": probe_s,
                   "build_s": seconds, "train": len(graph.train),
                   "valid": len(graph.valid), "test": len(graph.test)}


def depth_cut(graph):
    """``graph`` with the first 1/DEPTH_CUT of its training split."""
    from repro_torch.data import kg as kg_data

    return kg_data.KG(graph.n_entities, graph.n_relations,
                      graph.train[:len(graph.train) // DEPTH_CUT],
                      graph.valid, graph.test)


def check_topk(res, n, k, label, known=None):
    import numpy as np

    if res.ids.shape != (n, k) or res.energies.shape != (n, k):
        fail(f"{label}: shapes {res.ids.shape} {res.energies.shape}")
    if not np.all(np.isfinite(res.energies)):
        fail(f"{label}: non-finite energies")
    if np.any(np.diff(res.energies, axis=1) < 0):
        fail(f"{label}: energies not ascending")
    if known is not None:
        for i, row in enumerate(known):
            if set(res.ids[i].tolist()) & set(row.tolist()):
                fail(f"{label}: a known (excluded) id was served, query {i}")


def training_path(torch, graph):
    """The training main path (``kg.fit``, SGD then BGD), its checks, the
    same-seed rerun and the CPU-against-card epoch.  Returns the SGD and
    BGD results, the path's info, its kernel launches and the init's
    metrics."""
    from repro_torch import kg
    from repro_torch.core.models import KGConfig, get_model
    from repro_torch.data import kg as kg_data
    from repro_torch.kernels import transe_score as ts

    info = {}
    model = get_model("transe")
    cfg = KGConfig(graph.n_entities, graph.n_relations, dim=DIM)
    init = model.init_params(torch.Generator().manual_seed(0), cfg,
                             device=DEVICE)           # fit's seed-0 init
    init_kb = kg.KnowledgeBase(model="transe", params=init, graph=graph,
                               norm="l1")
    init_metrics, info["init_evaluate_s"] = wall(
        torch, lambda: kg.evaluate(init_kb, engine="device"))
    print("init metrics " + json.dumps(init_metrics), flush=True)
    steps = len(graph.train) // TRAIN["n_workers"] // TRAIN["batch_size"]
    epoch_s = {"sgd": [], "bgd": []}

    def timer(paradigm):
        last = [time.perf_counter()]

        def callback(epoch, loss):         # loss is a float: synchronized
            now = time.perf_counter()
            epoch_s[paradigm].append(now - last[0])
            last[0] = now
        return callback

    ts.transe_score.launches = 0                      # --- training path ---
    ts.transe_score_bwd.launches = 0
    t_start = time.perf_counter()
    sgd = kg.fit(graph, "transe", "sgd", strategy="average",
                 epochs=SGD_EPOCHS, seed=0, callback=timer("sgd"),
                 device=DEVICE, **TRAIN)
    bgd = kg.fit(graph, "transe", "bgd", epochs=BGD_EPOCHS, seed=0,
                 callback=timer("bgd"), device=DEVICE, **TRAIN)
    launches = (ts.transe_score.launches,
                ts.transe_score_bwd.launches)         # --- end ---
    info["train_path_s"] = time.perf_counter() - t_start
    info["steps_per_epoch"] = steps
    info["epoch_s"] = epoch_s
    info["loss_history"] = {"sgd": sgd.loss_history,
                            "bgd": bgd.loss_history}
    info["launches"] = dict(zip(("transe_score", "transe_score_bwd"),
                                launches))
    info["launches_per_epoch"] = {
        name: n / (SGD_EPOCHS + BGD_EPOCHS)
        for name, n in info["launches"].items()}
    print("training " + json.dumps(info), flush=True)
    predicted = steps * (SGD_EPOCHS + BGD_EPOCHS)
    if launches != (predicted, predicted):
        fail(f"transe_score launches {launches} on the training path; the "
             f"schedule predicts {predicted} each (one per step)")
    for name, res in (("sgd", sgd), ("bgd", bgd)):
        hist = res.loss_history
        if not all(map(math.isfinite, hist)) or not hist[-1] < hist[0]:
            fail(f"{name} loss did not fall: {hist}")

    # the same seed twice: the same bits
    a = kg.fit(graph, epochs=1, seed=0, device=DEVICE, **TRAIN)
    b = kg.fit(graph, epochs=1, seed=0, device=DEVICE, **TRAIN)
    info["rerun_bitwise"] = a.loss_history == b.loss_history and all(
        bits_equal(a.params[n], b.params[n]) for n in a.params)
    if not info["rerun_bitwise"]:
        fail("a same-seed rerun of one SGD epoch gave other bits")

    # one SGD epoch on the CPU (plain versions) and on the card (kernels),
    # from the same params and the same injected draws
    part = kg_data.PARTITIONERS["balanced"](0, graph.train,
                                            TRAIN["n_workers"])
    pos = kg_data.epoch_batches(0, 0, part, TRAIN["batch_size"])
    neg = model.make_negatives(torch.as_tensor(pos), cfg,
                               generator=torch.Generator().manual_seed(1))
    draws = lambda epoch: (neg.numpy(), None)
    card, info["card_epoch_s"] = wall(torch, lambda: kg.fit(
        graph, epochs=1, seed=0, params=init, draws=draws, device=DEVICE,
        **TRAIN))
    t0 = time.perf_counter()
    host = kg.fit(graph, epochs=1, seed=0, device="cpu", draws=draws,
                  params={n: t.cpu() for n, t in init.items()}, **TRAIN)
    info["cpu_epoch_s"] = time.perf_counter() - t0
    info["cpu_vs_card"] = {
        "param_max_abs_err": max_err(
            [card.params[n].cpu() for n in sorted(card.params)],
            [host.params[n] for n in sorted(host.params)]),
        "params_bitwise": all(bits_equal(card.params[n].cpu(),
                                         host.params[n])
                              for n in card.params),
        "loss": [card.loss_history[0], host.loss_history[0]],
        "param_tol": CPU_EPOCH_PARAM_TOL, "loss_rtol": CPU_EPOCH_LOSS_RTOL}
    print("cpu vs card epoch " + json.dumps(info["cpu_vs_card"]),
          flush=True)
    # where an SGD epoch's time goes: the device's busy share and kernels
    info["sgd_epoch_profile"] = profile_busy(torch, lambda: kg.fit(
        graph, epochs=1, seed=0, params=init, draws=draws, device=DEVICE,
        **TRAIN))
    prof = info["sgd_epoch_profile"]
    prof["dtoh_copies_per_step"] = prof["dtoh_copies"] / steps
    print("sgd epoch profile " + json.dumps(prof), flush=True)
    c = info["cpu_vs_card"]
    if c["param_max_abs_err"] > CPU_EPOCH_PARAM_TOL or abs(
            c["loss"][0] - c["loss"][1]) > CPU_EPOCH_LOSS_RTOL * abs(
                c["loss"][1]):
        fail(f"the CPU and card SGD epochs disagree: {c}")
    return sgd, bgd, info, launches, init_metrics


def serving_path(torch, graph, kb):
    """The serving main path on ``kb``: save/load, queries, rank(),
    evaluate, and the checks of the module docstring."""
    import numpy as np

    from repro_torch import kg
    from repro_torch.core import eval as host_eval
    from repro_torch.core import eval_device
    from repro_torch.kernels import rank_topk

    info = {}
    test = graph.test
    tails_known, heads_known = graph.eval_filter_candidates()

    rank_topk.rank_counts.launches = 0                # --- serving path ---
    t_start = time.perf_counter()
    fp = kb.fingerprint()
    with tempfile.TemporaryDirectory() as tmp:
        kb.save(tmp)
        kb, info["load_s"] = wall(
            torch, lambda: kg.KnowledgeBase.load(tmp, device=DEVICE))
    if kb.fingerprint() != fp:
        fail(f"fingerprint changed across save/load: {fp} -> "
             f"{kb.fingerprint()}")
    pairs = test[:N_QUERY_PAIRS]
    h, r, t = pairs[:, 0], pairs[:, 1], pairs[:, 2]
    tails, info["query_tails_s"] = wall(
        torch, lambda: kb.query_tails(h, r, k=10, filtered=True))
    heads, info["query_heads_s"] = wall(
        torch, lambda: kb.query_heads(t, r, k=10, filtered=True))
    rels, info["query_relations_s"] = wall(
        torch, lambda: kb.query_relations(h, t, k=10))
    scores, info["score_s"] = wall(torch, lambda: kb.score(h, r, t))
    # the same calls again: the first of each pays one-time set-up
    for name, call in (
            ("query_tails", lambda: kb.query_tails(h, r, k=10,
                                                   filtered=True)),
            ("query_heads", lambda: kb.query_heads(t, r, k=10,
                                                   filtered=True)),
            ("query_relations", lambda: kb.query_relations(h, t, k=10)),
            ("score", lambda: kb.score(h, r, t))):
        info[f"{name}_warm_s"] = wall(torch, call)[1]
    n = len(pairs)
    check_topk(tails, n, 10, "query_tails",
               graph.known_candidate_masks(pairs[:, :2], "tail"))
    check_topk(heads, n, 10, "query_heads",
               graph.known_candidate_masks(pairs[:, 1:], "head"))
    check_topk(rels, n, 10, "query_relations")
    top1 = kb.score(h, r, tails.ids[:, 0])
    if not np.array_equal(top1, tails.energies[:, 0]):
        fail("query_tails energies disagree with score() of the same "
             "triplets")
    if scores.shape != (n,) or not np.all(np.isfinite(scores)):
        fail("score(): bad output")

    before = rank_topk.rank_counts.launches
    ranks, info["rank_s"] = wall(torch, lambda: kb.engine().rank(
        test, "tail", cand_masks=tails_known))
    info["rank_launches"] = rank_topk.rank_counts.launches - before
    if info["rank_launches"] == 0:
        fail("rank() did not go through the rank_counts kernel")

    before = rank_topk.rank_counts.launches
    metrics, info["evaluate_s"] = wall(
        torch, lambda: kg.evaluate(kb, engine="device"))
    info["evaluate_launches"] = rank_topk.rank_counts.launches - before
    if info["evaluate_launches"] == 0:
        fail("kg.evaluate did not go through the rank_counts kernel")
    print("metrics " + json.dumps(metrics), flush=True)
    main_launches = rank_topk.rank_counts.launches    # --- end ---
    info["serving_path_s"] = time.perf_counter() - t_start
    info["metrics"] = metrics
    n_q = len(test)
    for key in ("entity_raw", "entity_filtered", "relation_prediction"):
        row = metrics[key]
        if row["n"] != (2 * n_q if key.startswith("entity") else n_q) or \
                not 1 <= row["mean_rank"] <= graph.n_entities:
            fail(f"metrics[{key}] malformed: {row}")
    if not 0 <= metrics["triplet_classification_acc"] <= 1:
        fail("triplet classification accuracy out of [0, 1]")

    # the kernel path against the plain-scorer path, whole test split
    masks = (tails_known, heads_known)
    fused, info["ranks_fused_s"] = wall(torch, lambda: (
        eval_device.entity_ranks_device(kb.params, test, "l1", masks)))
    plain, info["ranks_plain_s"] = wall(torch, lambda: (
        eval_device.entity_ranks_device(kb.params, test, "l1", masks,
                                        fused=False)))
    np.testing.assert_array_equal(ranks, fused["filtered_ranks"]["tail"])
    got = host_eval._metrics_from_ranks(np.concatenate(
        [fused["raw_ranks"]["tail"], fused["raw_ranks"]["head"]])).row()
    if got != metrics["entity_raw"]:
        fail("evaluate's raw metrics differ from the rank vectors'")
    diffs = {}
    for group in ("raw_ranks", "filtered_ranks"):
        for side in ("tail", "head"):
            d = np.abs(fused[group][side].astype(np.int64)
                       - plain[group][side])
            diffs[f"{group}.{side}"] = {"queries": int((d > 0).sum()),
                                        "max": int(d.max())}
    info["fused_vs_plain"] = diffs
    print("fused vs plain-scorer rank differences " + json.dumps(diffs),
          flush=True)
    for key, d in diffs.items():
        if d["queries"] >= 0.001 * n_q or d["max"] > 3:
            fail(f"fused ranks differ too much from the plain path: {key} "
                 f"{d}")

    # the device engine against the host reference protocol, on a slice
    rows = test[:HOST_CHECK_ROWS]
    host = host_eval.entity_inference(
        kb.params, rows, "l1", graph.known_set(),
        known_index=graph.known_index(), return_ranks=True)
    dev = eval_device.entity_ranks_device(
        kb.params, rows, "l1", (tails_known[:HOST_CHECK_ROWS],
                                heads_known[:HOST_CHECK_ROWS]), fused=False)
    for group in ("raw_ranks", "filtered_ranks"):
        for side in ("tail", "head"):
            if not np.array_equal(host[group][side], dev[group][side]):
                fail(f"device engine differs from the host protocol: "
                     f"{group}.{side}")
    return info, main_launches


def same_run(a, b):
    """Two TrainResults with the same loss history and the same bits."""
    return a.loss_history == b.loss_history and all(
        bits_equal(a.params[n], b.params[n]) for n in b.params)


class StepTimer:
    """Host seconds of each call to the methods named in ``targets``
    (``{label: (owner, attribute)}``), timed by wrapping them for the
    span of a ``with`` block; the calls themselves are unchanged."""

    def __init__(self, targets):
        self.targets = targets
        self.seconds = {label: [] for label in targets}
        self._saved = {}

    def __enter__(self):
        for label, (owner, attr) in self.targets.items():
            orig = getattr(owner, attr)
            self._saved[label] = orig

            def timed(*args, _orig=orig, _label=label, **kw):
                t0 = time.perf_counter()
                try:
                    return _orig(*args, **kw)
                finally:
                    self.seconds[_label].append(time.perf_counter() - t0)
            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for label, (owner, attr) in self.targets.items():
            setattr(owner, attr, self._saved[label])
        return False


def eval_resume_path(torch, graph, sgd, bgd):
    """Training with evaluation and resume (item 5 of the module
    docstring).  Returns the path's info and its launches of each
    kernel."""
    import numpy as np

    from repro_torch import kg
    from repro_torch.core import eval_device, mapreduce
    from repro_torch.core import trace as trace_lib
    from repro_torch.kernels import rank_topk, transe_score as ts
    from repro_torch.train import checkpoint as ckpt_lib

    info = {"filter_index_cached_before": None in graph._filter_cands}
    steps = len(graph.train) // TRAIN["n_workers"] // TRAIN["batch_size"]
    marks = []                     # (epoch, perf_counter) per callback

    def callback(epoch, loss):     # loss is a float: synchronized
        marks.append((epoch, time.perf_counter()))

    timer = StepTimer({
        "record": (trace_lib.TraceRecorder, "record"),
        "save_async": (ckpt_lib.AsyncSaver, "save_async"),
        "finish": (mapreduce._CheckpointWriter, "finish"),
        "restore": (ckpt_lib, "restore"),
    })
    sgd_kw = dict(strategy="average", seed=0, device=DEVICE, **TRAIN)
    bgd_kw = dict(seed=0, device=DEVICE, **TRAIN)
    dirs = {name: tempfile.TemporaryDirectory() for name in "ABC"}
    t_phase = time.perf_counter()
    try:
        ts.transe_score.launches = 0          # --- eval/resume path ---
        ts.transe_score_bwd.launches = 0
        rank_topk.rank_counts.launches = 0
        with timer:
            t0 = time.perf_counter()
            a = kg.fit(graph, "transe", "sgd", epochs=SGD_EPOCHS,
                       eval_every=2, ckpt_dir=dirs["A"].name,
                       checkpoint_every=2, callback=callback, **sgd_kw)
            info["run_a_s"] = time.perf_counter() - t0
            a_marks, a_records = list(marks), len(timer.seconds["record"])
            a_saves = list(timer.seconds["save_async"])
            a_finish = list(timer.seconds["finish"])
            kg.fit(graph, "transe", "sgd", epochs=2, ckpt_dir=dirs["B"].name,
                   checkpoint_every=2, **sgd_kw)
            t0 = time.perf_counter()
            b = kg.fit(graph, "transe", "sgd", epochs=SGD_EPOCHS,
                       ckpt_dir=dirs["B"].name, resume=True, **sgd_kw)
            info["resume_b_s"] = time.perf_counter() - t0
            kg.fit(graph, "transe", "bgd", epochs=1, ckpt_dir=dirs["C"].name,
                   checkpoint_every=1, **bgd_kw)
            c = kg.fit(graph, "transe", "bgd", epochs=BGD_EPOCHS,
                       ckpt_dir=dirs["C"].name, resume=True, **bgd_kw)
        launches = {"rank_counts": rank_topk.rank_counts.launches,
                    "transe_score": ts.transe_score.launches,
                    "transe_score_bwd": ts.transe_score_bwd.launches}
        # --- end ---
        on_disk = {name: sorted(int(e.split("_")[1])
                                for e in os.listdir(d.name))
                   for name, d in dirs.items()}
        configs = {}
        for name, d in dirs.items():
            for step in on_disk[name]:
                _, _, extra = ckpt_lib.restore(d.name, step=step)
                configs[f"{name}{step}"] = extra["config"]
    finally:
        for d in dirs.values():
            d.cleanup()

    # epoch seconds of run A: between callbacks, less the evaluation and
    # the save that ran at the boundary in between
    rec, sav = timer.seconds["record"][:a_records], a_saves
    boundary = {1: rec[0] + sav[0], 3: rec[1] + sav[1]}
    epoch_s = []
    for (e0, t0), (e1, t1) in zip(a_marks, a_marks[1:]):
        epoch_s.append(t1 - t0 - boundary.get(e0, 0.0))
    walls = [e.wall_clock for e in a.trace.entries]
    info.update(
        steps_per_epoch=steps,
        epoch_s_after_first=epoch_s,
        eval_s=rec, eval_wall_clock=walls,
        eval_wall_clock_deltas=[walls[0]] + [
            y - x for x, y in zip(walls, walls[1:])],
        save_async_wait_s=sav, finish_wait_s=a_finish,
        restore_s=timer.seconds["restore"],
        steps_on_disk=on_disk, launches=launches,
        loss_history={"A": a.loss_history, "B": b.loss_history,
                      "C": c.loss_history},
        trace_epochs=a.trace.epochs(),
        merge_rounds=[e.merge_round for e in a.trace.entries],
        best_epoch=a.best_epoch)

    # checks: observing and resuming change nothing
    info["bitwise"] = {"A_vs_untraced": same_run(a, sgd),
                       "B_resumed_vs_untraced": same_run(b, sgd),
                       "bgd_resumed_vs_untraced": same_run(c, bgd)}
    print("eval/resume " + json.dumps(info), flush=True)
    if not all(info["bitwise"].values()):
        fail(f"a traced or resumed run gave other bits: {info['bitwise']}")
    if info["trace_epochs"] != [1, 3] or info["merge_rounds"] != [2, 4]:
        fail(f"trace epochs {info['trace_epochs']} and merge rounds "
             f"{info['merge_rounds']}, expected [1, 3] and [2, 4]")
    if on_disk != {"A": [2, 4], "B": [2, 4], "C": [1, 3]}:
        fail(f"checkpoint steps on disk {on_disk}")
    want_cfg = {
        "sgd": mapreduce.resume_config(*kg.make_configs(
            graph, "transe", "sgd", strategy="average", **TRAIN)),
        "bgd": mapreduce.resume_config(*kg.make_configs(
            graph, "transe", "bgd", **TRAIN))}
    for key, cfg in configs.items():
        if cfg != want_cfg["bgd" if key.startswith("C") else "sgd"]:
            fail(f"manifest {key} holds config {cfg}")
    info["runs_s"] = time.perf_counter() - t_phase
    per_eval = 2 * eval_device.shard_layout(len(graph.test),
                                            eval_device.DEFAULT_CHUNK, 1)[0]
    predicted = {"rank_counts": 2 * per_eval,
                 "transe_score": steps * (2 * SGD_EPOCHS + BGD_EPOCHS),
                 "transe_score_bwd": steps * (2 * SGD_EPOCHS + BGD_EPOCHS)}
    info["launches_predicted"] = predicted
    if launches != predicted:
        fail(f"launches {launches} on the eval/resume path; the schedule "
             f"predicts {predicted}")

    # the trace against later evaluations of the same params
    last, info["posthoc_evaluate_s"] = wall(
        torch, lambda: kg.evaluate(a.kb, engine="device"))
    best = kg.evaluate(a.best_params, "transe", graph, engine="device")
    info["trace_equals_evaluate"] = {
        "last": last == a.trace.entries[-1].metrics,
        "best": best == a.trace.best().metrics}
    if not all(info["trace_equals_evaluate"].values()):
        fail(f"trace entries differ from a later kg.evaluate: "
             f"{info['trace_equals_evaluate']}")

    # bf16 serving on the card, against the CPU
    kb16 = kg.KnowledgeBase(
        model="transe", graph=graph, norm="l1",
        params={n: t.to(torch.bfloat16) for n, t in a.params.items()})
    cpu16 = kg.KnowledgeBase(
        model="transe", graph=graph, norm="l1",
        params={n: t.cpu() for n, t in kb16.params.items()})
    pairs = graph.test[:N_QUERY_PAIRS]
    h, r, t = pairs[:, 0], pairs[:, 1], pairs[:, 2]
    tails, info["bf16_query_tails_s"] = wall(
        torch, lambda: kb16.query_tails(h, r, k=10))
    check_topk(tails, len(pairs), 10, "bf16 query_tails")
    scores = kb16.score(h, r, t)
    few = slice(0, 64)
    want = cpu16.query_tails(h[few], r[few], k=10)
    info["bf16"] = {
        "energies_dtype": str(tails.energies.dtype),
        "tails_equal_cpu": bool(
            np.array_equal(tails.ids[few], want.ids)
            and np.array_equal(tails.energies[few], want.energies)),
        "score_equal_cpu": bool(np.array_equal(
            scores, cpu16.score(h, r, t))),
        "fingerprint_equal_cpu": kb16.fingerprint() == cpu16.fingerprint(),
        "fingerprint_differs_from_fp32": kb16.fingerprint()
        != a.kb.fingerprint()}
    print("bf16 serving " + json.dumps(info["bf16"]), flush=True)
    if not (all(v for k, v in info["bf16"].items() if k != "energies_dtype")
            and tails.energies.dtype == np.float32
            and scores.dtype == np.float32
            and np.all(np.isfinite(scores))):
        fail(f"bf16 serving on the card: {info['bf16']}")
    info["phase_s"] = time.perf_counter() - t_phase
    return info, launches


def device_pipeline_path(torch, graph, cut):
    """The device pipeline (item 6 of the module docstring), its CPU round
    on ``cut``.  Returns the path's info and its launches of each
    kernel."""
    from repro_torch import kg
    from repro_torch.core import eval_device, keys, mapreduce
    from repro_torch.core.models import get_model
    from repro_torch.data import kg as kg_data
    from repro_torch.kernels import rank_topk, transe_score as ts
    from repro_torch.train import checkpoint as ckpt_lib

    info = {}
    steps = len(graph.train) // TRAIN["n_workers"] // TRAIN["batch_size"]
    cut_steps = len(cut.train) // TRAIN["n_workers"] // TRAIN["batch_size"]
    sgd_kw = dict(seed=0, device=DEVICE, **TRAIN, **DEVICE_SGD)
    bgd_kw = dict(seed=0, device=DEVICE, pipeline="device", **TRAIN)
    marks = {}

    def timer(label):                   # loss is a float: synchronized
        marks[label] = [(None, time.perf_counter())]
        return lambda epoch, loss: marks[label].append(
            (epoch, time.perf_counter()))

    kcfg, mcfg = kg.make_configs(graph, "transe", "sgd", block_epochs=2,
                                 **TRAIN, **DEVICE_SGD)
    part = torch.as_tensor(kg_data.PARTITIONERS["balanced"](
        0, graph.train, TRAIN["n_workers"]), device=DEVICE)
    init = get_model("transe").init_params(
        torch.Generator().manual_seed(0), kcfg, device=DEVICE)
    dirs = {name: tempfile.TemporaryDirectory() for name in "DE"}
    card_epochs, cut_epochs, n_evals = 0, 0, 0
    t_phase = time.perf_counter()
    try:
        ts.transe_score.launches = 0          # --- device pipeline path ---
        ts.transe_score_bwd.launches = 0
        rank_topk.rank_counts.launches = 0
        # (a) the loss over the whole split, and block invariance on the
        # cut split, against a4's twin there
        a4 = kg.fit(graph, "transe", "sgd", epochs=4, block_epochs=4,
                    callback=timer("a4"), **sgd_kw)
        a4_cut = kg.fit(cut, "transe", "sgd", epochs=4, block_epochs=4,
                        **sgd_kw)
        a2 = kg.fit(cut, "transe", "sgd", epochs=4, block_epochs=2,
                    callback=timer("a2"), **sgd_kw)
        # (b) BGD
        b = kg.fit(graph, "transe", "bgd", epochs=3, block_epochs=3,
                   callback=timer("b"), **bgd_kw)
        # (c) one merge round on the card (the CPU's below)
        c_card = kg.fit(cut, "transe", "sgd", epochs=2, block_epochs=2,
                        **sgd_kw)
        card_epochs += 4 + 3
        cut_epochs += 4 + 4 + 2
        # (d) one block with any host sync an error
        block_fn = mapreduce.make_block_fn(mcfg, kcfg, part, seed=0,
                                           donate=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            params, losses = block_fn(dict(init), range(2))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        info["sync_checked_block_losses"] = losses.tolist()
        # the peak memory of a block, donation on and off
        peaks_b = {}
        for label, donate in (("donate_on", True), ("donate_off", False)):
            fn = mapreduce.make_block_fn(mcfg, kcfg, part, seed=0,
                                         donate=donate)
            given = {n: t.clone() for n, t in init.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            out, _ = fn(given, range(2))
            torch.cuda.synchronize()
            peaks_b[label] = {"before_bytes": before,
                              "peak_bytes": torch.cuda.max_memory_allocated(),
                              "tables_bytes": sum(t.numel() * t.element_size()
                                                  for t in init.values())}
            del given, out
        info["block_peak_memory"] = peaks_b
        # the same block under the profiler
        prof = profile_busy(torch, lambda: block_fn(dict(init), range(2)))
        prof.update(epochs=2, steps=2 * steps,
                    launches_per_epoch=prof["launches"] / 2,
                    dtoh_copies_per_step=prof["dtoh_copies"] / (2 * steps))
        info["block_profile"] = prof
        card_epochs += 2 + 2 + 2 + 2
        # (e) evaluation, checkpoints and resume, on the cut split (the
        # evaluations over the whole test split), against a4's twin
        e_traced = kg.fit(cut, "transe", "sgd", epochs=4, block_epochs=4,
                          eval_every=2, ckpt_dir=dirs["D"].name,
                          checkpoint_every=2, **sgd_kw)
        kg.fit(cut, "transe", "sgd", epochs=2, block_epochs=4,
               ckpt_dir=dirs["E"].name, checkpoint_every=2, **sgd_kw)
        e_resumed = kg.fit(cut, "transe", "sgd", epochs=4, block_epochs=4,
                           ckpt_dir=dirs["E"].name, resume=True, **sgd_kw)
        cut_epochs += 4 + 2 + 2
        n_evals += 2
        launches = {"rank_counts": rank_topk.rank_counts.launches,
                    "transe_score": ts.transe_score.launches,
                    "transe_score_bwd": ts.transe_score_bwd.launches}
        # --- end ---
        on_disk = {name: sorted(int(e.split("_")[1])
                                for e in os.listdir(d.name))
                   for name, d in dirs.items()}
        manifests = {}
        for name, d in dirs.items():
            for step in on_disk[name]:
                _, _, extra = ckpt_lib.restore(d.name, step=step)
                manifests[f"{name}{step}"] = (extra["pipeline"],
                                              extra["config"])
    finally:
        for d in dirs.values():
            d.cleanup()
    info["runs_s"] = time.perf_counter() - t_phase

    # (c) the CPU's round, and the draws alone
    t0 = time.perf_counter()
    c_cpu = kg.fit(cut, "transe", "sgd", epochs=2, block_epochs=2,
                   **dict(sgd_kw, device="cpu"))
    info["cpu_round_s"] = time.perf_counter() - t0
    wkeys = keys.fold_in(keys.device_keys(0)[1], torch.arange(4))
    draws = {
        "bits": lambda d: keys.random_bits(wkeys.to(d), DRAW_COUNTERS, d),
        "uniform": lambda d: keys.uniform(wkeys.to(d), DRAW_COUNTERS, d),
        "randint": lambda d: keys.randint(wkeys.to(d), DRAW_COUNTERS, 1,
                                          graph.n_entities, d),
        "permutation": lambda d: keys.permutation(wkeys.to(d),
                                                  DRAW_COUNTERS, d)}
    info["draws_cpu_equal_card"] = {
        name: bool(torch.equal(fn(DEVICE).cpu(), fn("cpu")))
        for name, fn in draws.items()}
    info["cpu_vs_card_round"] = {
        "params_bitwise": all(bits_equal(c_card.params[n].cpu(),
                                         c_cpu.params[n])
                              for n in c_cpu.params),
        "param_max_abs_err": max_err(
            [c_card.params[n].cpu() for n in sorted(c_card.params)],
            [c_cpu.params[n] for n in sorted(c_cpu.params)]),
        "losses": [c_card.loss_history, c_cpu.loss_history],
        "losses_bitwise": c_card.loss_history == c_cpu.loss_history}

    def per_epoch(label, epochs_per_block):
        m = marks[label]
        return [(t1 - t0) / epochs_per_block
                for (_, t0), (_, t1) in zip(m, m[1:])]

    info.update(
        steps_per_epoch=steps, launches=launches,
        epoch_s={"sgd_block4": per_epoch("a4", 2),
                 "sgd_block2_cut": per_epoch("a2", 2),
                 "bgd_block3": per_epoch("b", 3)},
        callback_epochs={k: [e for e, _ in v[1:]] for k, v in marks.items()},
        loss_history={"a": a4.loss_history, "b": b.loss_history},
        steps_on_disk=on_disk,
        trace_epochs=e_traced.trace.epochs(),
        merge_rounds=[e.merge_round for e in e_traced.trace.entries],
        bitwise={"block4_vs_block2": same_run(a4_cut, a2),
                 "traced_vs_untraced": same_run(e_traced, a4_cut),
                 "resumed_vs_unbroken": same_run(e_resumed, a4_cut),
                 "sync_checked_block_vs_fit": info[
                     "sync_checked_block_losses"] == a4.loss_history[:2]})
    predicted = {"rank_counts": n_evals * 2 * eval_device.shard_layout(
                     len(graph.test), eval_device.DEFAULT_CHUNK, 1)[0],
                 "transe_score": steps * card_epochs
                 + cut_steps * cut_epochs,
                 "transe_score_bwd": steps * card_epochs
                 + cut_steps * cut_epochs}
    info["launches_predicted"] = predicted
    print("device pipeline " + json.dumps(info), flush=True)
    if not all(info["bitwise"].values()):
        fail(f"device-pipeline runs that should agree gave other bits: "
             f"{info['bitwise']}")
    c = info["cpu_vs_card_round"]
    if not (c["params_bitwise"] and c["losses_bitwise"]
            and all(info["draws_cpu_equal_card"].values())):
        fail(f"the CPU and the card disagree on a device-pipeline round or "
             f"its draws: {c} {info['draws_cpu_equal_card']}")
    if info["trace_epochs"] != [1, 3] or info["merge_rounds"] != [1, 2]:
        fail(f"trace epochs {info['trace_epochs']} and merge rounds "
             f"{info['merge_rounds']}, expected [1, 3] and [1, 2]")
    if info["callback_epochs"] != {"a4": [1, 3], "a2": [1, 3], "b": [2]}:
        fail(f"callbacks at {info['callback_epochs']}")
    if on_disk != {"D": [2, 4], "E": [2, 4]}:
        fail(f"checkpoint steps on disk {on_disk}")
    want_cfg = mapreduce.resume_config(kcfg, mcfg)
    for key, (pipeline, cfg) in manifests.items():
        if pipeline != "device" or cfg != want_cfg:
            fail(f"manifest {key}: pipeline {pipeline!r}, config {cfg}")
    for name, hist in info["loss_history"].items():
        if not all(map(math.isfinite, hist)) or not hist[-1] < hist[0]:
            fail(f"device pipeline {name}: loss did not fall: {hist}")
    if launches != predicted:
        fail(f"launches {launches} on the device pipeline path; the "
             f"schedule predicts {predicted}")
    if info["block_profile"]["dtoh_copies"] != 0:
        fail(f"a device-pipeline block made "
             f"{info['block_profile']['dtoh_copies']} device-to-host copies")
    last = kg.evaluate(e_traced.kb, engine="device")
    if last != e_traced.trace.entries[-1].metrics:
        fail("the device pipeline's last trace entry differs from a later "
             "kg.evaluate")
    info["phase_s"] = time.perf_counter() - t_phase
    return info, launches


def answer_bits(ans, ids, energies):
    """A served answer with the given ids and the same energy bits."""
    import numpy as np

    return np.array_equal(ans.ids, ids) and np.array_equal(
        ans.energies.view(np.uint32), np.asarray(energies).view(np.uint32))


def live_percentiles(lats):
    import numpy as np

    if not lats:
        return {"n": 0, "p50_ms": None, "p99_ms": None}
    arr = np.asarray(lats, np.float64) * 1e3
    return {"n": len(lats), "p50_ms": float(np.percentile(arr, 50)),
            "p99_ms": float(np.percentile(arr, 99))}


def live_wave(srv, kind, queries):
    """Submit ``queries`` (``(a, b, options)`` triples) while admission is
    paused, then release them: the batcher admits exactly this set as one
    wave (the cache cleared first, so none of them is a hit)."""
    srv.clear_cache()
    srv.pause()
    futs = [srv.submit(kind, a, b, **kw) for a, b, kw in queries]
    srv.resume()
    return [f.result(timeout=LIVE_TIMEOUT_S) for f in futs]


def live_stream(srv, pairs, rate, n, seed, midway=None):
    """An open-loop stream: ``n`` single ``tails`` queries at Poisson
    arrivals of ``rate`` a second (seeded), each drawn from ``pairs``; the
    sender never waits for an answer.  ``midway`` runs on a thread of its
    own from the stream's half.  Returns the submitted pairs, the answers
    and the stream's rates."""
    import threading

    import numpy as np

    rng = np.random.default_rng(seed)
    at = np.cumsum(rng.exponential(1.0 / rate, n))
    pick = pairs[rng.integers(0, len(pairs), n)]
    futs, side = [], None
    t0 = time.perf_counter()
    for i in range(n):
        delay = at[i] - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        futs.append(srv.submit("tails", pick[i, 0], pick[i, 1]))
        if midway is not None and i == n // 2:
            side = threading.Thread(target=midway)
            side.start()
    sent = time.perf_counter() - t0
    answers = [f.result(timeout=LIVE_TIMEOUT_S) for f in futs]
    done = time.perf_counter() - t0
    if side is not None:
        side.join(timeout=LIVE_TIMEOUT_S)
        if side.is_alive():
            fail("the mid-stream call did not return")
    return pick, answers, {"offered_qps": n / sent,
                           "sustained_qps": n / done, "span_s": done}


def live_delta(before, after):
    """What the server did between two ``ServerStats``."""
    waves = after.waves - before.waves
    rows = after.cache_misses - before.cache_misses
    return {
        "waves": waves, "mean_wave": rows / waves if waves else 0.0,
        "bucket_waves": {b: n - before.bucket_waves.get(b, 0)
                         for b, n in after.bucket_waves.items()
                         if n != before.bucket_waves.get(b, 0)},
        "cache_hits": after.cache_hits - before.cache_hits,
        "cache_misses": rows,
        "steady_recompiles": after.steady_recompiles
        - before.steady_recompiles,
    }


def serving_live_path(torch, sgd, bgd):
    """The live server (item 7 of the module docstring).  Returns the
    path's info and its launches of each kernel."""
    import numpy as np

    from repro_torch import kg
    from repro_torch.data import kg as kg_data
    from repro_torch.kernels import rank_topk, transe_score as ts
    from repro_torch.serve import KGServer, kg_engine

    info = {}
    t_phase = time.perf_counter()
    dirs = {name: tempfile.TemporaryDirectory() for name in ("sgd", "bgd")}
    config = {cfg[0]: cfg for cfg in LIVE_CONFIGS}
    servers = []

    def server(kb, label, **kw):
        _, max_batch, wait_us = config[label]
        srv = KGServer(kb, max_batch=max_batch, max_wait_us=wait_us,
                       default_k=LIVE_K, **kw)
        servers.append(srv)
        return srv

    def on_card(srv, *tenants):
        for name in tenants:
            if srv.tenant_kb(name).engine().device.type != "cuda":
                fail(f"tenant {name!r} is not served from the card")

    def bucket_waves(srv):
        """One unfiltered tails wave filling each bucket, then one
        filtered query: the seconds of each wave's service."""
        with StepTimer({"wave": (KGServer, "_execute")}) as timer:
            for bucket in srv.buckets:
                live_wave(srv, "tails",
                          [(h, r, {}) for h, r, _ in pairs[:bucket]])
            live_wave(srv, "tails", [(pairs[0, 0], pairs[0, 1],
                                      {"filtered": True})])
            # the timer records a wave after its futures resolve
            if not srv.drain(timeout=LIVE_TIMEOUT_S):
                fail("the server did not drain")
        seconds = timer.seconds["wave"]
        return dict(zip(map(str, srv.buckets), seconds)), seconds[-1]

    try:
        rank_topk.rank_counts.launches = 0      # --- live serving path ---
        ts.transe_score.launches = 0
        ts.transe_score_bwd.launches = 0
        sgd.kb.save(dirs["sgd"].name)
        bgd.kb.save(dirs["bgd"].name)

        def load(name):
            return kg.KnowledgeBase.load(dirs[name].name, device=DEVICE)

        kb_bgd = load("bgd")
        graph = kb_bgd.graph
        fp = {"sgd": sgd.kb.fingerprint(), "bgd": kb_bgd.fingerprint()}
        _, first = np.unique(graph.test[:, :2], axis=0, return_index=True)
        pairs = graph.test[np.random.default_rng(0).permutation(first)]

        # (a) start-up: cold waves on an unwarmed server first (nothing in
        # this process has run these shapes), then the warm server's
        # warm-up, split into the known index and the engine calls
        cold = server(load("sgd"), "batch64_wait2ms")
        on_card(cold, "default")
        shapes0 = kg_engine.shapes_seen()
        cold_waves, cold_filtered = bucket_waves(cold)
        cold_shapes = kg_engine.shapes_seen() - shapes0
        cold.stop()
        kb = load("sgd")
        if kb.fingerprint() != fp["sgd"]:
            fail("the SGD artifact's fingerprint changed across save/load")
        engine_calls = ("query_tails", "query_heads", "query_relations")
        with StepTimer({"known_index": (kg_data.KG, "known_index"),
                        **{name: (kg_engine.KGQueryEngine, name)
                           for name in engine_calls}}) as timer:
            t0 = time.perf_counter()
            live = server(kb, "batch64_wait2ms", warm=True)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
        on_card(live, "default")
        st = live.stats()
        warm_waves, warm_filtered = bucket_waves(live)
        info["startup"] = {
            "warm_s": warm_s,
            "known_index_s": sum(timer.seconds["known_index"]),
            "engine_calls_s": sum(sum(timer.seconds[n])
                                  for n in engine_calls),
            "engine_calls": sum(len(timer.seconds[n])
                                for n in engine_calls),
            "warm_compiles": st.warm_compiles, "cold_shapes": cold_shapes,
            "ex_width": live._ex_width(live._tenants["default"]),
            "buckets": list(live.buckets),
            "cold_wave_s": cold_waves, "warm_wave_s": warm_waves,
            "cold_first_filtered_s": cold_filtered,
            "warm_first_filtered_s": warm_filtered}
        print("live start-up " + json.dumps(info["startup"]), flush=True)
        n_shapes = 5 * len(live.buckets)
        if st.warm_compiles + cold_shapes != n_shapes:
            fail(f"warm-up ran {st.warm_compiles} new shapes after the "
                 f"cold server's {cold_shapes}; {n_shapes} expected")

        # (b) parity: each served answer against the engine on the same
        # single query at chunk=1, at every bucket, fresh then cached
        eng, E = kb.engine(), kb.n_entities
        cols = {"tails": (0, 1), "heads": (2, 1), "relations": (0, 2)}
        cells, fresh, lo = {}, {}, 0
        for kind, mode in PARITY_CELLS:
            before = live.stats()
            queries, direct = [], []
            for size in PARITY_SIZES:
                wave_q = []
                for row in pairs[lo:lo + size]:
                    a, b = (int(row[c]) for c in cols[kind])
                    kw, ex = {}, None
                    if mode == "filtered":
                        kw = {"filtered": True}
                        ex = (graph.known_candidate_masks(
                            np.array([[a, b]]), "tail") if kind == "tails"
                            else graph.known_candidate_masks(
                                np.array([[b, a]]), "head"))
                    elif mode == "exclude":
                        kw = {"exclude": sorted({(a * 7 + j * 131) % E
                                                 for j in range(5)})}
                        ex = np.array([kw["exclude"]], np.int32)
                    if kind == "relations":
                        want = eng.query_relations([a], [b], k=LIVE_K,
                                                   chunk=1)
                    else:
                        call = (eng.query_tails if kind == "tails"
                                else eng.query_heads)
                        want = call([a], [b], k=LIVE_K, exclude=ex,
                                    chunk=1)
                    wave_q.append((a, b, kw))
                    direct.append((want.ids[0], want.energies[0]))
                lo += size
                for ans, (ids, en), (_, _, kw) in zip(
                        live_wave(live, kind, wave_q), direct[-size:],
                        wave_q):
                    if ans.cached or not answer_bits(ans, ids, en):
                        fail(f"a served {kind} answer ({mode}) differs "
                             f"from the engine's at wave size {size}")
                    if set(kw.get("exclude", ())) & set(ans.ids.tolist()):
                        fail(f"an excluded id was served ({kind})")
                queries += wave_q
            for _ in range(2):      # the cell again: the second pass hits
                futs = [live.submit(kind, a, b, **kw)
                        for a, b, kw in queries]
                answers = [f.result(timeout=LIVE_TIMEOUT_S) for f in futs]
            for ans, (ids, en) in zip(answers, direct):
                if not ans.cached or not answer_bits(ans, ids, en):
                    fail(f"a cached {kind} answer ({mode}) differs from "
                         "the engine's")
            cell = f"{kind}-{mode}"
            cells[cell] = len(queries)
            fresh[cell] = live_delta(before, live.stats())[
                "steady_recompiles"]
        info["parity"] = {"queries": cells, "sizes": list(PARITY_SIZES),
                          "new_shapes": fresh}
        print("live parity " + json.dumps(info["parity"]), flush=True)
        # explicit 5-id exclusions pad to width 8, a width warm-up does
        # not run (as in the reference): at most one new shape a bucket,
        # fewer where a direct call at chunk=1 met the shape first
        for cell, n in fresh.items():
            if n > (len(live.buckets) if cell.endswith("exclude") else 0):
                fail(f"the parity waves of {cell} met {n} new shapes")

        # (c) capacity and (d) an open loop at half of it, per config
        info["configs"] = {}
        hot = pairs[:LIVE_UNIQUE, :2]
        for label, _, _ in LIVE_CONFIGS:
            srv = live if label == "batch64_wait2ms" else server(
                kb, label, warm=True)
            on_card(srv, "default")
            srv.clear_cache()
            before = srv.stats()
            burst, arrivals = LIVE_LOAD.get(label,
                                            (LIVE_BURST, LIVE_ARRIVALS))
            t0 = time.perf_counter()
            futs = [srv.submit("tails", h, r)
                    for h, r in pairs[:burst, :2]]
            for f in futs:
                f.result(timeout=LIVE_TIMEOUT_S)
            burst_s = time.perf_counter() - t0
            cap = {"completions_per_s": burst / burst_s, "queries": burst,
                   "span_s": burst_s, **live_delta(before, srv.stats())}
            srv.clear_cache()
            before = srv.stats()
            allocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
            _, answers, rates = live_stream(
                srv, hot, 0.5 * cap["completions_per_s"], arrivals, seed=1)
            allocs = torch.cuda.memory_stats().get(
                "num_device_alloc", 0) - allocs
            after = srv.stats()
            misses = [a.latency_s for a in answers if not a.cached]
            info["configs"][label] = {"capacity": cap, "open_loop": {
                **rates,
                "all": live_percentiles([a.latency_s for a in answers]),
                "misses": live_percentiles(misses),
                "hit_rate": 1 - len(misses) / len(answers),
                "num_device_alloc_delta": allocs,
                **live_delta(before, after)}}
            print(f"live {label} " + json.dumps(info["configs"][label]),
                  flush=True)
            recompiles = info["configs"][label]["open_loop"][
                "steady_recompiles"] + cap["steady_recompiles"]
            if recompiles:
                fail(f"{label}: {recompiles} steady-state recompiles")

        # (e) a second tenant, then a hot swap under load
        srv = server(kb, "batch16_wait1ms", warm=True)
        srv.add_tenant("bgd", kb_bgd)
        on_card(srv, "default", "bgd")
        want = kb_bgd.engine().query_tails(hot[:32, 0], hot[:32, 1],
                                           k=LIVE_K)
        mine = kb.engine().query_tails(hot[:32, 0], hot[:32, 1], k=LIVE_K)
        for i, (a, b) in enumerate(hot[:32]):
            ans = srv.submit("tails", a, b, tenant="bgd").result(
                timeout=LIVE_TIMEOUT_S)
            if ans.fingerprint != fp["bgd"] or not answer_bits(
                    ans, want.ids[i], want.energies[i]):
                fail("the second tenant did not answer with its own bits")
        if np.array_equal(want.energies, mine.energies):
            fail("the two artifacts give the same answers: the swap check "
                 "could not tell them apart")
        srv.clear_cache()
        before = srv.stats()
        rate = 0.5 * info["configs"]["batch16_wait1ms"]["capacity"][
            "completions_per_s"]
        # the swap's parts, timed on its own thread: the exclusion width
        # (a pass over the known index) and the new tenant's warm-up
        with StepTimer({name: (KGServer, name) for name in (
                "swap", "_ex_width", "_warm_tenant")}) as timer:
            pick, answers, rates = live_stream(
                srv, hot, rate, LIVE_SWAP_ARRIVALS, seed=2,
                midway=lambda: srv.swap(kb_bgd))
        after = srv.stats()
        by_fp = {}
        for (a, b), ans in zip(pick, answers):
            by_fp.setdefault(ans.fingerprint, []).append((a, b, ans))
        if set(by_fp) - set(fp.values()):
            fail(f"answers under unknown fingerprints {set(by_fp)}")
        for name, art in (("sgd", kb), ("bgd", kb_bgd)):
            group = by_fp.get(fp[name], [])
            if not group:
                fail(f"no answer from the {name} artifact across the swap")
            res = art.engine().query_tails(
                [g[0] for g in group], [g[1] for g in group], k=LIVE_K,
                chunk=64)
            for i, (_, _, ans) in enumerate(group):
                if not answer_bits(ans, res.ids[i], res.energies[i]):
                    fail(f"an answer stamped {name} differs from that "
                         "artifact's engine")
        info["swap"] = {
            **rates, "answers": {name: len(by_fp.get(key, []))
                                 for name, key in fp.items()},
            "cache_invalidations": after.cache_invalidations
            - before.cache_invalidations,
            "swaps": after.swaps - before.swaps,
            "all": live_percentiles([a.latency_s for a in answers]),
            "misses": live_percentiles([a.latency_s for a in answers
                                        if not a.cached]),
            "swap_s": sum(timer.seconds["swap"]),
            "warm_s": sum(timer.seconds["_warm_tenant"]),
            "ex_width_s": max(timer.seconds["_ex_width"]),
            **live_delta(before, after)}
        print("live swap " + json.dumps(info["swap"]), flush=True)
        if info["swap"]["cache_invalidations"] != 1 or \
                after.steady_recompiles != 0:
            fail(f"swap: {info['swap']}")
        launches = {"rank_counts": rank_topk.rank_counts.launches,
                    "transe_score": ts.transe_score.launches,
                    "transe_score_bwd": ts.transe_score_bwd.launches}
    finally:                                    # --- end ---
        for srv in servers:
            srv.stop()
        for d in dirs.values():
            d.cleanup()
    info["launches"] = launches
    info["phase_s"] = time.perf_counter() - t_phase
    return info, launches


def family_serving(torch, graph, kb, label):
    """Item 8(d) on one artifact: save/load, filtered queries, scores,
    ``rank()``, ``kg.evaluate(kb, engine="device")`` and the device engine
    against the host protocol on a slice of the test split.  Returns the
    artifact's info and its metrics."""
    import numpy as np

    from repro_torch import kg
    from repro_torch.core import eval as host_eval
    from repro_torch.core import eval_device

    info = {}
    test = graph.test
    tails_known, heads_known = graph.eval_filter_candidates()
    fp = kb.fingerprint()
    with tempfile.TemporaryDirectory() as tmp:
        kb.save(tmp)
        kb, info["load_s"] = wall(
            torch, lambda: kg.KnowledgeBase.load(tmp, device=DEVICE))
    if kb.fingerprint() != fp:
        fail(f"{label}: fingerprint changed across save/load")
    if not all(t.is_cuda for t in kb.params.values()):
        fail(f"{label}: the loaded artifact's tables are not on the card")
    pairs = test[:N_QUERY_PAIRS]
    h, r, t = pairs[:, 0], pairs[:, 1], pairs[:, 2]
    tails, info["query_tails_s"] = wall(
        torch, lambda: kb.query_tails(h, r, k=10, filtered=True))
    heads, info["query_heads_s"] = wall(
        torch, lambda: kb.query_heads(t, r, k=10, filtered=True))
    rels, info["query_relations_s"] = wall(
        torch, lambda: kb.query_relations(h, t, k=10))
    scores, info["score_s"] = wall(torch, lambda: kb.score(h, r, t))
    n = len(pairs)
    check_topk(tails, n, 10, f"{label} query_tails",
               graph.known_candidate_masks(pairs[:, :2], "tail"))
    check_topk(heads, n, 10, f"{label} query_heads",
               graph.known_candidate_masks(pairs[:, 1:], "head"))
    check_topk(rels, n, 10, f"{label} query_relations")
    # the tail side scores each candidate with score()'s operations
    if not np.array_equal(kb.score(h, r, tails.ids[:, 0]),
                          tails.energies[:, 0]):
        fail(f"{label}: query_tails energies disagree with score()")
    if scores.shape != (n,) or not np.all(np.isfinite(scores)):
        fail(f"{label}: score(): bad output")
    ranks, info["rank_s"] = wall(torch, lambda: kb.engine().rank(
        test, "tail", cand_masks=tails_known))
    metrics, info["evaluate_s"] = wall(
        torch, lambda: kg.evaluate(kb, engine="device"))
    n_q = len(test)
    for key in ("entity_raw", "entity_filtered", "relation_prediction"):
        row = metrics[key]
        if row["n"] != (2 * n_q if key.startswith("entity") else n_q) or \
                not 1 <= row["mean_rank"] <= graph.n_entities:
            fail(f"{label}: metrics[{key}] malformed: {row}")
    if not 0 <= metrics["triplet_classification_acc"] <= 1:
        fail(f"{label}: triplet classification accuracy out of [0, 1]")
    if ranks.shape != (n_q,) or ranks.min() < 1:
        fail(f"{label}: rank() gave malformed ranks")
    # the device engine against the host reference protocol, on a slice
    rows = test[:HOST_CHECK_ROWS]
    host = host_eval.entity_inference(
        kb.params, rows, kb.norm, graph.known_set(), model=kb.model,
        known_index=graph.known_index(), return_ranks=True)
    dev = eval_device.entity_ranks_device(
        kb.params, rows, kb.norm, (tails_known[:HOST_CHECK_ROWS],
                                   heads_known[:HOST_CHECK_ROWS]),
        model=kb.model, fused=False)
    for group in ("raw_ranks", "filtered_ranks"):
        for side in ("tail", "head"):
            if not np.array_equal(host[group][side], dev[group][side]):
                fail(f"{label}: the device engine differs from the host "
                     f"protocol: {group}.{side}")
    return info, metrics


def family_server_parity(torch, kb):
    """Item 8(e): a DistMult tenant in ``KGServer``, waves filling every
    bucket; each served answer against the engine on the same single
    query at ``chunk=1``, bit for bit.  Returns the answers checked."""
    import numpy as np

    from repro_torch.serve import KGServer

    graph = kb.graph
    eng = kb.engine()
    srv = KGServer(kb, max_batch=64, max_wait_us=2000, default_k=LIVE_K)
    checked = 0
    try:
        if srv.tenant_kb("default").engine().device.type != "cuda":
            fail("the DistMult tenant is not served from the card")
        cols = {"tails": (0, 1), "heads": (2, 1), "relations": (0, 2)}
        lo = 0
        for kind, mode in (("tails", "plain"), ("heads", "filtered"),
                           ("relations", "plain")):
            for size in PARITY_SIZES:
                wave_q, direct = [], []
                for row in graph.test[lo:lo + size]:
                    a, b = (int(row[c]) for c in cols[kind])
                    kw, ex = {}, None
                    if mode == "filtered":
                        kw = {"filtered": True}
                        ex = graph.known_candidate_masks(
                            np.array([[b, a]]), "head")
                    if kind == "relations":
                        want = eng.query_relations([a], [b], k=LIVE_K,
                                                   chunk=1)
                    else:
                        call = (eng.query_tails if kind == "tails"
                                else eng.query_heads)
                        want = call([a], [b], k=LIVE_K, exclude=ex,
                                    chunk=1)
                    wave_q.append((a, b, kw))
                    direct.append((want.ids[0], want.energies[0]))
                lo += size
                for ans, (ids, en) in zip(live_wave(srv, kind, wave_q),
                                          direct):
                    if ans.cached or not answer_bits(ans, ids, en):
                        fail(f"a served DistMult {kind} answer ({mode}) "
                             f"differs from the engine's at wave size "
                             f"{size}")
                    checked += 1
        st = srv.stats()
        if any(st.bucket_waves.get(b, 0) == 0 for b in srv.buckets):
            fail(f"the DistMult waves left a bucket empty: "
                 f"{st.bucket_waves}")
    finally:
        srv.stop()
    return checked


def model_family_path(torch, graph, joint_graph):
    """The model family and joint negatives (item 8 of the module
    docstring), joint-48's SGD run whose loss is checked on
    ``joint_graph``, its block-invariance pair on ``graph``.  Returns the
    path's info and its launches of each kernel."""
    from repro_torch import kg
    from repro_torch.core import eval_device, mapreduce
    from repro_torch.core.models import KGConfig, get_model
    from repro_torch.data import kg as kg_data
    from repro_torch.kernels import rank_topk, transe_score as ts

    info = {}
    steps = len(graph.train) // TRAIN["n_workers"] // TRAIN["batch_size"]
    base_kw = dict(seed=0, device=DEVICE, **TRAIN)
    marks = {}

    def timer(label):                   # loss is a float: synchronized
        marks[label] = [time.perf_counter()]
        return lambda epoch, loss: marks[label].append(time.perf_counter())

    t_phase = time.perf_counter()
    rank_topk.rank_counts.launches = 0        # --- model family path ---
    ts.transe_score.launches = 0
    ts.transe_score_bwd.launches = 0
    runs = {}
    for model in ("transh", "distmult"):      # (a), (b): host pipeline
        runs[f"{model}_sgd"] = kg.fit(
            graph, model, "sgd", strategy="average",
            epochs=FAMILY_SGD_EPOCHS, callback=timer(f"{model}_sgd"),
            **base_kw)
        runs[f"{model}_bgd"] = kg.fit(
            graph, model, "bgd", epochs=FAMILY_BGD_EPOCHS,
            callback=timer(f"{model}_bgd"), **base_kw)
    # (c) TransE with joint negatives: joint-48 on the device pipeline,
    # its loss over the whole split in blocks of 4, and block invariance
    # (blocks of 4 and of 2) on the cut split; the full pool under BGD on
    # the host pipeline
    runs["joint_sgd_block4"] = kg.fit(
        joint_graph, "transe", "sgd", epochs=JOINT_EPOCHS, block_epochs=4,
        callback=timer("joint_sgd_block4"), **base_kw, **JOINT_SGD)
    joint_cut = {blocks: kg.fit(
        graph, "transe", "sgd", epochs=JOINT_EPOCHS, block_epochs=blocks,
        callback=timer(f"joint_cut_block{blocks}"), **base_kw, **JOINT_SGD)
        for blocks in (4, 2)}
    runs["joint_bgd"] = kg.fit(graph, "transe", "bgd",
                               epochs=FAMILY_BGD_EPOCHS,
                               callback=timer("joint_bgd"), **base_kw,
                               **JOINT_BGD)
    # (d) each SGD artifact saved, loaded, queried, ranked, evaluated
    served, metrics = {}, {}
    for label, res in (("transh", runs["transh_sgd"]),
                       ("distmult", runs["distmult_sgd"]),
                       ("transe_joint", runs["joint_sgd_block4"])):
        served[label], metrics[label] = family_serving(
            torch, res.kb.graph, res.kb, label)
    # (e) a DistMult tenant in the live server
    parity_answers = family_server_parity(torch, runs["distmult_sgd"].kb)
    launches = {"rank_counts": rank_topk.rank_counts.launches,
                "transe_score": ts.transe_score.launches,
                "transe_score_bwd": ts.transe_score_bwd.launches}
    # --- end ---
    info["runs_s"] = time.perf_counter() - t_phase
    # the TransE artifact is ranked twice through the kernel: rank() and
    # kg.evaluate, each both sides of every test chunk
    predicted = {"rank_counts": 2 * 2 * eval_device.shard_layout(
                     len(graph.test), eval_device.DEFAULT_CHUNK, 1)[0],
                 "transe_score": 0, "transe_score_bwd": 0}
    info.update(launches=launches, launches_predicted=predicted,
                served=served, metrics=metrics,
                server_parity_answers=parity_answers,
                loss_history={k: v.loss_history for k, v in runs.items()},
                joint_cut_loss_history={b: r.loss_history
                                        for b, r in joint_cut.items()})
    per_block = {"joint_sgd_block4": 4, "joint_cut_block4": 4,
                 "joint_cut_block2": 2}
    info["epoch_s"] = {
        k: [(t1 - t0) / per_block.get(k, 1) for t0, t1 in zip(m, m[1:])]
        for k, m in marks.items()}
    for label, res in list(runs.items()) + [
            (f"joint_cut_block{b}", r) for b, r in joint_cut.items()]:
        if not all(t.is_cuda for t in res.params.values()):
            fail(f"{label}: a trained table is not on the card")
        if not all(map(math.isfinite, res.loss_history)):
            fail(f"{label}: non-finite loss {res.loss_history}")

    # a same-seed rerun of FAMILY_RERUN_STEPS steps of each model through
    # the engine's epoch function, and its profile
    part = kg_data.PARTITIONERS["balanced"](0, graph.train,
                                            TRAIN["n_workers"])
    pos = kg_data.epoch_batches(0, 0, part, TRAIN["batch_size"])
    info["steps_per_epoch"] = steps
    info["joint_sgd_steps_per_epoch"] = (len(joint_graph.train)
                                         // TRAIN["n_workers"]
                                         // TRAIN["batch_size"])
    info["rerun_bitwise"], info["step_profile"] = {}, {}
    info["cpu_vs_card"] = {}
    for label, model, opts in FAMILY_CELLS:
        # the host pipeline's form of the cell
        opts = {k: v for k, v in opts.items()
                if k not in ("pipeline", "merge_every")}
        kcfg, mcfg = kg.make_configs(graph, model, "sgd", **TRAIN, **opts)
        m = get_model(model)
        init = m.init_params(torch.Generator().manual_seed(0), kcfg,
                             device=DEVICE)
        neg = m.make_negatives(torch.as_tensor(pos), kcfg,
                               generator=torch.Generator().manual_seed(1))
        p20 = torch.as_tensor(pos[:, :FAMILY_RERUN_STEPS], device=DEVICE)
        n20 = neg[:, :FAMILY_RERUN_STEPS].to(DEVICE)
        epoch_fn = mapreduce.make_epoch_fn(mcfg, kcfg, check_ids=False)
        a = epoch_fn(init, p20, n20, None)
        b = epoch_fn(init, p20, n20, None)
        info["rerun_bitwise"][label] = bits_equal(a[1], b[1]) and all(
            bits_equal(a[0][n], b[0][n]) for n in a[0])
        prof = profile_busy(torch, lambda: epoch_fn(init, p20, n20, None))
        prof["launches_per_step"] = prof["launches"] / FAMILY_RERUN_STEPS
        prof["dtoh_copies_per_step"] = (prof["dtoh_copies"]
                                        / FAMILY_RERUN_STEPS)
        info["step_profile"][label] = prof
        # one SGD epoch on the CPU and on the card, same params and draws
        draws = lambda epoch: (neg.numpy(), None)
        card, card_s = wall(torch, lambda: kg.fit(
            graph, model, epochs=1, seed=0, params=init, draws=draws,
            device=DEVICE, **TRAIN, **opts))
        t0 = time.perf_counter()
        host = kg.fit(graph, model, epochs=1, seed=0, device="cpu",
                      draws=draws, params={n: t.cpu() for n, t in
                                           init.items()},
                      **TRAIN, **opts)
        info["cpu_vs_card"][label] = {
            "card_epoch_s": card_s, "cpu_epoch_s": time.perf_counter() - t0,
            "param_max_abs_err": max_err(
                [card.params[n].cpu() for n in sorted(card.params)],
                [host.params[n] for n in sorted(host.params)]),
            "params_bitwise": all(bits_equal(card.params[n].cpu(),
                                             host.params[n])
                                  for n in card.params),
            "loss": [card.loss_history[0], host.loss_history[0]],
            "loss_bitwise": card.loss_history == host.loss_history}
    info["bitwise"] = {
        "joint_block4_vs_block2": same_run(joint_cut[4], joint_cut[2]),
        **{f"rerun_{k}": v for k, v in info["rerun_bitwise"].items()}}
    info["phase_s"] = time.perf_counter() - t_phase
    print("model family " + json.dumps(info), flush=True)

    if launches != predicted:
        fail(f"launches {launches} on the model-family path; the path "
             f"predicts {predicted}")
    if not all(info["bitwise"].values()):
        fail(f"model-family runs that should agree gave other bits: "
             f"{info['bitwise']}")
    for label, c in info["cpu_vs_card"].items():
        if c["param_max_abs_err"] > FAMILY_CPU_TOL or abs(
                c["loss"][0] - c["loss"][1]) > FAMILY_CPU_TOL * abs(
                    c["loss"][1]):
            fail(f"the CPU and card SGD epochs of {label} disagree: {c}")
    for label, hist in info["loss_history"].items():
        if not all(map(math.isfinite, hist)):
            fail(f"{label}: non-finite loss {hist}")
        if len(hist) > 1 and not hist[-1] < hist[0]:
            fail(f"{label}: loss did not fall: {hist}")
    return info, launches


def random_kg(torch, n_entities, n_triplets, n_relations, n_eval, seed):
    """``benchmarks/bench_scale.py::random_kg`` rebuilt in numpy (the port
    imports nothing of the reference): uniform-random triplets as int32
    arrays, the train split first, then the valid and test splits."""
    import numpy as np

    from repro_torch.data import kg as kg_data

    rng = np.random.default_rng(seed)

    def draw(n):
        return np.stack([rng.integers(0, n_entities, n),
                         rng.integers(0, n_relations, n),
                         rng.integers(0, n_entities, n)],
                        axis=1).astype(np.int32)

    return kg_data.KG(n_entities, n_relations, draw(n_triplets),
                      draw(n_eval), draw(n_eval))


def scale_bytes(torch, graph, kcfg, mcfg, part):
    """bench_scale's three byte counts per Reduce (``_wire_bytes``): dense
    ``W·n_rows·(k + 2)·4`` (W tables and two touch stats), sparse
    ``W·C·(k + 3)·4`` (the capacity buffers: values, id, count, loss) and
    touched ``n_touched·(k + 3)·4`` with the rows each worker's epoch-0
    batches and negatives reference — here the device pipeline's own
    epoch-0 draws, as the run took them."""
    from repro_torch.core import keys, mapreduce, negative
    from repro_torch.core.models import get_model
    from repro_torch.data import kg as kg_data

    W, B = mcfg.n_workers, mcfg.batch_size
    model = get_model(mcfg.model)
    k_data, k_neg, _, _ = keys.device_keys(0)
    pos = kg_data.device_epoch_batches(keys.fold_in(k_data, 0), part, B)
    wkeys = keys.fold_in(keys.fold_in(k_neg, 0),
                         torch.arange(W, device=part.device))
    uniform, offset = negative.device_draws(wkeys, pos.shape[:-1],
                                            kcfg.n_entities, part.device)
    neg = model.make_negatives(pos, kcfg, None, uniform=uniform,
                               offset=offset)
    steps = part.shape[1] // B
    sizes = {"ent": kcfg.n_entities, "rel": kcfg.n_relations}
    out = {"dense_merge_bytes": 0, "sparse_merge_bytes": 0,
           "touched_merge_bytes": 0, "capacity": {}, "touched_rows": {}}
    for name, role in sorted(model.param_roles().items()):
        n_rows, k = sizes[role], kcfg.dim
        cap = mapreduce._delta_capacity(mcfg, n_rows, steps, 1, role)
        cols = (0, 2) if role == "ent" else (1,)
        touched = [int(torch.unique(torch.cat(
            [t[w][..., c].reshape(-1) for t in (pos, neg) for c in cols])
            ).numel()) for w in range(W)]
        out["dense_merge_bytes"] += W * n_rows * (k + 2) * 4
        out["sparse_merge_bytes"] += W * cap * (k + 3) * 4
        out["touched_merge_bytes"] += sum(touched) * (k + 3) * 4
        out["capacity"][name] = cap
        out["touched_rows"][name] = touched
    return out


def sparse_transport_path(torch, full, graph, sgd_history):
    """The sparse delta transport (item 9 of the module docstring), its
    host SGD pair on ``full`` (phase 3's SGD run, whose loss history was
    ``sgd_history``), the rest on ``graph``.  Returns the path's info and
    its launches of each kernel."""
    from repro_torch import kg
    from repro_torch.core import eval_device, mapreduce
    from repro_torch.core.models import get_model
    from repro_torch.data import kg as kg_data
    from repro_torch.kernels import rank_topk, transe_score as ts

    info = {}
    steps = len(graph.train) // TRAIN["n_workers"] // TRAIN["batch_size"]
    full_steps = (len(full.train) // TRAIN["n_workers"]
                  // TRAIN["batch_size"])
    base_kw = dict(seed=0, device=DEVICE, **TRAIN)
    dense_dev = dict(base_kw, **DEVICE_SGD)
    sparse_dev = dict(base_kw, **SPARSE_DEVICE)
    marks = {}

    def timer(label):                   # loss is a float: synchronized
        marks[label] = [time.perf_counter()]
        return lambda epoch, loss: marks[label].append(time.perf_counter())

    def pair(label, *args, on=graph, **kw):
        """A run on each transport: ``(dense, sparse)``."""
        return tuple(kg.fit(on, *args, merge_transport=t,
                            callback=timer(f"{label}_{t}"), **kw)
                     for t in ("dense", "sparse"))

    kcfg, mcfg = kg.make_configs(graph, "transe", "sgd", block_epochs=2,
                                 **TRAIN, **SPARSE_DEVICE)
    part = torch.as_tensor(kg_data.PARTITIONERS["balanced"](
        0, graph.train, TRAIN["n_workers"]), device=DEVICE)
    init = get_model("transe").init_params(
        torch.Generator().manual_seed(0), kcfg, device=DEVICE)
    scale = random_kg(torch, SCALE_CELL["n_entities"],
                      SCALE_CELL["n_triplets"], SCALE_CELL["n_relations"],
                      SCALE_CELL["n_eval"], SCALE_CELL["seed"])
    scale_kw = dict(seed=0, device=DEVICE, n_workers=TRAIN["n_workers"],
                    batch_size=SCALE_CELL["batch"], dim=SCALE_CELL["dim"],
                    learning_rate=SCALE_CELL["learning_rate"],
                    strategy="average", pipeline="device",
                    block_epochs=SCALE_CELL["epochs"])
    scale_steps = (len(scale.train) // TRAIN["n_workers"]
                   // SCALE_CELL["batch"])
    runs, evals, peaks_b = {}, {}, {}
    t_phase = time.perf_counter()
    ts.transe_score.launches = 0           # --- sparse transport path ---
    ts.transe_score_bwd.launches = 0
    rank_topk.rank_counts.launches = 0
    # (a) phase 3's configuration (its loss checked: on the whole split)
    runs["sgd"] = pair("sgd", "transe", "sgd", strategy="average",
                       epochs=SGD_EPOCHS, on=full, **base_kw)
    runs["bgd"] = pair("bgd", "transe", "bgd", epochs=1, **base_kw)
    dense4 = kg.fit(graph, "transe", "sgd", epochs=4, block_epochs=4,
                    callback=timer("device_dense"), **dense_dev)
    sparse4 = kg.fit(graph, "transe", "sgd", epochs=4, block_epochs=4,
                     callback=timer("device_sparse_block4"), **sparse_dev)
    sparse2 = kg.fit(graph, "transe", "sgd", epochs=4, block_epochs=2,
                     callback=timer("device_sparse_block2"), **sparse_dev)
    full_epochs, card_epochs = 2 * SGD_EPOCHS, 2 * 1 + 3 * 4
    block_fn = mapreduce.make_block_fn(mcfg, kcfg, part, seed=0,
                                       donate=True, with_overflow=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, losses, overflow = block_fn(dict(init), range(2))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    info["sync_checked_block"] = {"losses": losses.tolist(),
                                  "overflow": int(overflow)}
    for label, donate in (("donate_on", True), ("donate_off", False)):
        fn = mapreduce.make_block_fn(mcfg, kcfg, part, seed=0,
                                     donate=donate)
        given = {n: t.clone() for n, t in init.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out, _ = fn(given, range(2))
        torch.cuda.synchronize()
        peaks_b[label] = {"before_bytes": before,
                          "peak_bytes": torch.cuda.max_memory_allocated()}
        del given, out
    prof = profile_busy(torch, lambda: block_fn(dict(init), range(2)))
    prof.update(epochs=2, steps=2 * steps,
                launches_per_step=prof["launches"] / (2 * steps),
                dtoh_copies_per_step=prof["dtoh_copies"] / (2 * steps))
    card_epochs += 2 * 4
    for label in ("sgd", "bgd"):
        evals[label] = kg.evaluate(runs[label][1].kb, engine="device")
    # (b) the other models and joint-48, one epoch or merge round each
    for model in ("transh", "distmult"):
        runs[model] = pair(model, model, "sgd", strategy="average",
                           epochs=1, **base_kw)
    runs["joint48"] = pair("joint48", "transe", "sgd", epochs=2,
                           block_epochs=2, **dict(base_kw, **JOINT_SGD))
    # (c) the million-entity cell, each transport twice
    scale_runs = {}
    for rep in (0, 1):
        for t in ("dense", "sparse"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res, sec = wall(torch, lambda: kg.fit(
                scale, "transe", "sgd", epochs=SCALE_CELL["epochs"],
                merge_transport=t, **scale_kw))
            scale_runs.setdefault(t, []).append(
                (res, sec, torch.cuda.max_memory_allocated()))
    scale_epochs = 2 * 2 * SCALE_CELL["epochs"]
    scale_metrics, scale_eval_s = wall(torch, lambda: kg.evaluate(
        scale_runs["sparse"][0][0].kb, engine="device"))
    launches = {"rank_counts": rank_topk.rank_counts.launches,
                "transe_score": ts.transe_score.launches,
                "transe_score_bwd": ts.transe_score_bwd.launches}
    # --- end ---
    info["runs_s"] = time.perf_counter() - t_phase
    eval_chunks = lambda g: 2 * eval_device.shard_layout(
        len(g.test), eval_device.DEFAULT_CHUNK, 1)[0]
    predicted = {
        "rank_counts": 2 * eval_chunks(graph) + eval_chunks(scale),
        "transe_score": full_steps * full_epochs + steps * card_epochs
        + scale_steps * scale_epochs,
        "transe_score_bwd": full_steps * full_epochs + steps * card_epochs
        + scale_steps * scale_epochs}

    def per_epoch(label, epochs_per_block):
        m = marks[label]
        return [(t1 - t0) / epochs_per_block for t0, t1 in zip(m, m[1:])]

    # the callback fires once a block on the device pipeline, and
    # repartition_every=2 slices every block there at 2 epochs
    block_epochs = {"device_dense": 2, "device_sparse_block4": 2,
                    "device_sparse_block2": 2, "joint48_dense": 2,
                    "joint48_sparse": 2}

    skcfg, smcfg = kg.make_configs(scale, "transe", "sgd",
                                   merge_transport="sparse", **{
                                       k: v for k, v in scale_kw.items()
                                       if k not in ("seed", "device")})
    spart = torch.as_tensor(kg_data.PARTITIONERS["balanced"](
        0, scale.train, TRAIN["n_workers"]), device=DEVICE)
    info.update(
        steps_per_epoch=steps, sgd_steps_per_epoch=full_steps,
        launches=launches, launches_predicted=predicted,
        epoch_s={k: per_epoch(k, block_epochs.get(k, 1)) for k in marks},
        block_peak_memory=peaks_b, block_profile=prof,
        loss_history={k: [r.loss_history for r in v]
                      for k, v in runs.items()},
        metrics_sgd_sparse=evals["sgd"],
        scale={"graph": {"n_entities": scale.n_entities,
                         "n_relations": scale.n_relations,
                         "train": len(scale.train),
                         "test": len(scale.test)},
               "steps_per_epoch": scale_steps,
               "seconds": {t: [r[1] for r in v]
                           for t, v in scale_runs.items()},
               "epoch_s": {t: [r[1] / SCALE_CELL["epochs"] for r in v]
                           for t, v in scale_runs.items()},
               "peak_bytes": {t: [r[2] for r in v]
                              for t, v in scale_runs.items()},
               "tables_bytes": sum(
                   t.numel() * t.element_size()
                   for t in scale_runs["dense"][0][0].params.values()),
               **scale_bytes(torch, scale, skcfg, smcfg, spart),
               "evaluate_s": scale_eval_s, "metrics": scale_metrics,
               "loss_history": {t: v[0][0].loss_history
                                for t, v in scale_runs.items()}})
    info["bitwise"] = {
        **{f"{k}_sparse_vs_dense": same_run(*v) for k, v in runs.items()},
        "device_sparse_vs_dense": same_run(sparse4, dense4),
        "device_sparse_block4_vs_block2": same_run(sparse4, sparse2),
        "sync_checked_block_vs_fit": info["sync_checked_block"][
            "losses"] == dense4.loss_history[:2],
        "scale_sparse_vs_dense": same_run(scale_runs["sparse"][0][0],
                                          scale_runs["dense"][0][0]),
        "scale_reruns": same_run(scale_runs["sparse"][0][0],
                                 scale_runs["sparse"][1][0])
        and same_run(scale_runs["dense"][0][0], scale_runs["dense"][1][0]),
        "sgd_vs_phase3": runs["sgd"][0].loss_history == sgd_history,
        "sparse_sgd_metrics_vs_dense_params": evals["sgd"] == kg.evaluate(
            runs["sgd"][0].kb, engine="device")}
    info["phase_s"] = time.perf_counter() - t_phase
    print("sparse transport " + json.dumps(info), flush=True)

    if not all(info["bitwise"].values()):
        fail(f"sparse-transport runs that should agree gave other bits: "
             f"{info['bitwise']}")
    if launches != predicted:
        fail(f"launches {launches} on the sparse-transport path; the path "
             f"predicts {predicted}")
    if prof["dtoh_copies"] != 0 or info["sync_checked_block"]["overflow"]:
        fail(f"a sparse block made {prof['dtoh_copies']} device-to-host "
             f"copies, overflow {info['sync_checked_block']['overflow']}")
    for label, (dense, sparse) in runs.items():
        if not all(t.is_cuda for t in sparse.params.values()):
            fail(f"{label}: a sparse-trained table is not on the card")
        if not all(map(math.isfinite, sparse.loss_history)):
            fail(f"{label}: non-finite sparse loss {sparse.loss_history}")
    hist = runs["sgd"][1].loss_history
    if not hist[-1] < hist[0]:
        fail(f"the sparse SGD loss did not fall: {hist}")
    ent = scale_metrics["entity_filtered"]
    if not (ent["n"] == 2 * SCALE_CELL["n_eval"]
            and 1 <= ent["mean_rank"] <= SCALE_CELL["n_entities"]
            and all(math.isfinite(v) for v in ent.values())):
        fail(f"the 1e6-entity evaluation is out of range: {ent}")
    return info, launches


def block_memory(torch, fn, state):
    """``(before, peak)`` bytes of one call of ``fn(state)`` on the card:
    memory allocated before it and the peak during it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn(state)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return {"before_bytes": before, "peak_bytes": peak}


def stale_state(params, W):
    """A stale block's input state: the global view and W local copies."""
    from repro_torch.core import mapreduce

    return (dict(params), mapreduce._broadcast(params, W))


def async_cells(torch, info):
    """Phase 10 (b): benchmarks/bench_async.py's sync, stale-1 and stale-2
    cells at its own configuration, each cell's trajectory (its final
    filtered mean rank) and its steady-state 2-epoch block (ms, the median
    of ASYNC_REPEATS rounds of ASYNC_ITERS calls, round-robin over the
    cells); then 2 rounds of S = 1 on the CPU and on the card, and the
    refresh phases drawn on both.  Returns the card epochs and evaluations
    it ran."""
    import numpy as np

    from repro_torch import kg
    from repro_torch.core import keys, mapreduce
    from repro_torch.core.models import get_model
    from repro_torch.data import kg as kg_data

    c = ASYNC_CELL
    graph = kg_data.synthetic_kg(*c["graph"])
    fit_kw = dict(n_workers=c["n_workers"], batch_size=c["batch_size"],
                  dim=c["dim"], norm=c["norm"],
                  learning_rate=c["learning_rate"], pipeline="device")
    steps = len(graph.train) // c["n_workers"] // c["batch_size"]
    rows, blocks = {}, {}
    for name, S in ASYNC_STALENESS:
        res = kg.fit(graph, "transe", "sgd", epochs=c["epochs"],
                     block_epochs=c["epochs"], seed=0, device=DEVICE,
                     eval_every=c["eval_every"], staleness=S, **fit_kw)
        rows[name] = {
            "staleness": S,
            "final_rank": res.trace.entries[-1].metrics[
                "entity_filtered"]["mean_rank"],
            "curve": [e.metrics["entity_filtered"]["mean_rank"]
                      for e in res.trace.entries],
            "loss_history": res.loss_history}
        kcfg, mcfg = kg.make_configs(graph, "transe", "sgd", staleness=S,
                                     block_epochs=c["eval_every"], **fit_kw)
        part = torch.as_tensor(kg_data.PARTITIONERS["balanced"](
            0, graph.train, c["n_workers"]), device=DEVICE)
        init = get_model("transe").init_params(
            torch.Generator().manual_seed(0), kcfg, device=DEVICE)
        fn = mapreduce.make_block_fn(mcfg, kcfg, part, seed=0)
        state = stale_state(init, c["n_workers"]) if S else init
        blocks[name] = (fn, state)
        fn(state, range(c["eval_every"]))            # warm-up
    samples = {name: [] for name in blocks}
    for _ in range(ASYNC_REPEATS):
        for name, (fn, state) in blocks.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ASYNC_ITERS):
                fn(state, range(c["eval_every"]))
            torch.cuda.synchronize()
            samples[name].append((time.perf_counter() - t0) / ASYNC_ITERS)
    target = rows["sync"]["final_rank"] * c["ref_band"]
    for name, row in rows.items():
        row["block_ms"] = float(np.median(samples[name])) * 1e3
        row["block_ms_samples"] = [s * 1e3 for s in samples[name]]
        row["in_band"] = row["final_rank"] <= target
    # 2 rounds of S = 1 on the CPU and on the card, from the same init
    kcfg, _ = kg.make_configs(graph, "transe", "sgd", staleness=1, **fit_kw)
    init = get_model("transe").init_params(
        torch.Generator().manual_seed(0), kcfg, device="cpu")
    two = {dev: kg.fit(graph, "transe", "sgd", epochs=2, block_epochs=2,
                       seed=0, device=dev, staleness=1,
                       params={n: t.to(dev) for n, t in init.items()},
                       **fit_kw)
           for dev in ("cpu", DEVICE)}
    k = keys.stale_key(0)
    offsets = {S: [keys.stale_offsets(k, 4096, S, dev).cpu()
                   for dev in ("cpu", DEVICE)] for S in (1, 2)}
    info["async"] = {
        "graph": {"train": len(graph.train), "test": len(graph.test)},
        "steps_per_epoch": steps, "cells": rows, "ref_band": c["ref_band"],
        "cpu_vs_card": {
            "params_bitwise": all(bits_equal(two[DEVICE].params[n].cpu(),
                                             two["cpu"].params[n])
                                  for n in init),
            "losses": [two[DEVICE].loss_history, two["cpu"].loss_history],
            "losses_bitwise": (two[DEVICE].loss_history
                               == two["cpu"].loss_history),
            "offsets_bitwise": all(torch.equal(a, b)
                                   for a, b in offsets.values())}}
    n_blocks = 1 + ASYNC_REPEATS * ASYNC_ITERS
    card_epochs = (len(ASYNC_STALENESS) * (c["epochs"]
                                           + n_blocks * c["eval_every"])
                   + 2)
    n_evals = len(ASYNC_STALENESS) * (c["epochs"] // c["eval_every"])
    return graph, steps * card_epochs, n_evals


def stale_sharded_path(torch, graph, cut):
    """Bounded staleness and sharded tables (item 10 of the module
    docstring), the runs of (a) held bitwise against another and the
    sharded pairs of (c) on ``cut``.  Returns the path's
    info and its launches of each kernel."""
    import numpy as np

    from repro_torch import kg
    from repro_torch.core import eval_device, mapreduce
    from repro_torch.core.models import get_model
    from repro_torch.data import kg as kg_data
    from repro_torch.kernels import rank_topk, transe_score as ts

    info = {}
    W = TRAIN["n_workers"]
    steps = len(graph.train) // W // TRAIN["batch_size"]
    cut_steps = len(cut.train) // W // TRAIN["batch_size"]
    base_kw = dict(seed=0, device=DEVICE, **TRAIN)
    stale_kw = dict(base_kw, **STALE_SGD)
    marks = {}

    def timer(label):                   # loss is a float: synchronized
        marks[label] = [(-1, time.perf_counter())]
        return lambda epoch, loss: marks[label].append(
            (epoch, time.perf_counter()))

    def stale_fit(label, S, blocks=STALE_EPOCHS, on=graph, **kw):
        return kg.fit(on, "transe", "sgd", epochs=STALE_EPOCHS,
                      block_epochs=blocks, staleness=S,
                      callback=timer(label), **dict(stale_kw, **kw))

    kcfg, _ = kg.make_configs(graph, "transe", "sgd", **TRAIN)
    part = torch.as_tensor(kg_data.PARTITIONERS["balanced"](
        0, graph.train, W), device=DEVICE)
    init = get_model("transe").init_params(
        torch.Generator().manual_seed(0), kcfg, device=DEVICE)
    scale = random_kg(torch, SCALE_CELL["n_entities"],
                      SCALE_CELL["n_triplets"], SCALE_CELL["n_relations"],
                      SCALE_CELL["n_eval"], SCALE_CELL["seed"])
    scale_kw = dict(seed=0, device=DEVICE, n_workers=W,
                    batch_size=SCALE_CELL["batch"], dim=SCALE_CELL["dim"],
                    learning_rate=SCALE_CELL["learning_rate"],
                    strategy="average", pipeline="device",
                    merge_transport="sparse",
                    block_epochs=SCALE_CELL["epochs"])
    scale_steps = len(scale.train) // W // SCALE_CELL["batch"]
    eval_chunks = lambda g: 2 * eval_device.shard_layout(
        len(g.test), eval_device.DEFAULT_CHUNK, 1)[0]
    runs, secs = {}, {}
    t_phase = time.perf_counter()
    ts.transe_score.launches = 0         # --- stale and sharded path ---
    ts.transe_score_bwd.launches = 0
    rank_topk.rank_counts.launches = 0
    # (a) staleness at FB15k width: S = 1 and 2, whose losses are checked,
    # over the whole split; the runs held bitwise against another (the
    # synchronous run, S = 0, blocks of 2, the sparse transport) on the
    # cut split, beside a twin of S = 1 there
    runs["s1"] = stale_fit("s1", 1)
    runs["s2"] = stale_fit("s2", 2)
    runs["sync"] = kg.fit(cut, "transe", "sgd", epochs=STALE_EPOCHS,
                          block_epochs=STALE_EPOCHS, callback=timer("sync"),
                          **stale_kw)
    runs["s0"] = stale_fit("s0", 0, on=cut)
    runs["s1_cut"] = stale_fit("s1_cut", 1, on=cut)
    runs["s1_block2"] = stale_fit("s1_block2", 1, blocks=2, on=cut)
    runs["s1_sparse"] = stale_fit("s1_sparse", 1, merge_transport="sparse",
                                  on=cut)
    card_epochs = 2 * STALE_EPOCHS
    cut_epochs = 5 * STALE_EPOCHS
    blocks = {}
    for label, S, transport in (("sync", 0, "dense"), ("s1", 1, "dense"),
                                ("s1_sparse", 1, "sparse")):
        kc, mc = kg.make_configs(graph, "transe", "sgd", staleness=S,
                                 merge_transport=transport, block_epochs=2,
                                 **TRAIN, **STALE_SGD)
        blocks[label] = (mapreduce.make_block_fn(
            mc, kc, part, seed=0, with_overflow=True), S)
    sync_checked = {}
    for label in ("s1", "s1_sparse"):
        fn, S = blocks[label]
        state = stale_state(init, W)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, losses, overflow = fn(state, range(2))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        sync_checked[label] = {"losses": losses.tolist(),
                               "overflow": int(overflow)}
    state = None        # its locals would count in the blocks' peaks below
    card_epochs += 2 * 2
    peaks_b, profs = {}, {}
    for label in ("sync", "s1"):
        fn, S = blocks[label]
        make = (lambda: stale_state(init, W)) if S else (lambda: dict(init))
        peaks_b[label] = block_memory(
            torch, lambda st: fn(st, range(2)), make())
        state = make()
        prof = profile_busy(torch, lambda: fn(state, range(2)))
        state = None
        prof.update(steps=2 * steps,
                    launches_per_step=prof["launches"] / (2 * steps),
                    dtoh_copies_per_step=prof["dtoh_copies"] / (2 * steps))
        profs[label] = prof
    card_epochs += 2 * 2 * 2
    # (b) bench_async's cells at their own configuration
    async_graph, async_launches, async_evals = async_cells(torch, info)
    # (c) sharded tables at FB15k width, each beside its replicated twin
    pairs = {}

    def pair(label, *args, **kw):
        pairs[label] = tuple(
            kg.fit(cut, *args, table_sharding=t,
                   callback=timer(f"{label}_{t}"), **kw)
            for t in ("replicated", "sharded"))

    for strategy in ("average", "random"):
        pair(f"sgd_host_{strategy}", "transe", "sgd", epochs=2,
             strategy=strategy, merge_transport="sparse", **base_kw)
    pair("sgd_device", "transe", "sgd", epochs=4, block_epochs=4,
         **dict(base_kw, **SPARSE_DEVICE))
    pair("bgd_host", "transe", "bgd", epochs=1, merge_transport="sparse",
         **base_kw)
    runs["s1_sparse_sharded"] = stale_fit(
        "s1_sparse_sharded", 1, merge_transport="sparse",
        table_sharding="sharded", on=cut)
    cut_epochs += 2 * (2 + 2 + 4 + 1) + STALE_EPOCHS
    kb = pairs["sgd_host_average"][1].kb
    evals = {}
    for label, kw in (("sharded", dict(table_sharding="sharded",
                                       n_workers=W)),
                      ("replicated", dict(fused=False)),
                      ("fused", {})):
        evals[label], secs[f"evaluate_{label}"] = wall(
            torch, lambda: kg.evaluate(kb, engine="device", **kw))
    pairs_q = graph.test[:N_QUERY_PAIRS]
    answers = {}
    for label, kw in (("replicated", {}),
                      ("sharded", dict(table_sharding="sharded",
                                       n_workers=W))):
        answers[label], secs[f"queries_{label}"] = wall(torch, lambda: (
            kb.query_tails(pairs_q[:, 0], pairs_q[:, 1], k=10,
                           filtered=True, **kw),
            kb.query_heads(pairs_q[:, 2], pairs_q[:, 1], k=10,
                           filtered=True, **kw)))
    # (d) bench_scale's 1e6-entity cell, sparse, per layout
    scale_runs = {}
    for layout in ("replicated", "sharded"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, sec = wall(torch, lambda: kg.fit(
            scale, "transe", "sgd", epochs=SCALE_CELL["epochs"],
            table_sharding=layout, **scale_kw))
        scale_runs[layout] = (res, sec, torch.cuda.max_memory_allocated())
    scale_evals = {}
    for label, kw in (("sharded", dict(table_sharding="sharded",
                                       n_workers=W)),
                      ("replicated", {}), ("replicated_plain",
                                           dict(fused=False))):
        scale_evals[label], secs[f"scale_evaluate_{label}"] = wall(
            torch, lambda: kg.evaluate(scale_runs["sharded"][0].kb,
                                       engine="device", **kw))
    launches = {"rank_counts": rank_topk.rank_counts.launches,
                "transe_score": ts.transe_score.launches,
                "transe_score_bwd": ts.transe_score_bwd.launches}
    # --- end ---
    info["runs_s"] = time.perf_counter() - t_phase
    scale_epochs = 2 * SCALE_CELL["epochs"]
    train_launches = (steps * card_epochs + cut_steps * cut_epochs
                      + async_launches + scale_steps * scale_epochs)
    predicted = {"rank_counts": async_evals * eval_chunks(async_graph)
                 + eval_chunks(graph) + eval_chunks(scale),
                 "transe_score": train_launches,
                 "transe_score_bwd": train_launches}
    # the launches of one evaluation, per layout, measured on the first
    # two chunks of the test split
    sub = kg_data.KG(graph.n_entities, graph.n_relations, graph.train,
                     graph.valid, graph.test[:2 * eval_device.DEFAULT_CHUNK])
    eval_prof = {}
    for label, kw in (("sharded", dict(table_sharding="sharded",
                                       n_workers=W)),
                      ("replicated", dict(fused=False))):
        p = profile_busy(torch, lambda: eval_device.entity_ranks_device(
            kb.params, sub.test, "l1", model="transe", **kw))
        p["launches_per_chunk"] = p["launches"] / 2
        p["launches_per_evaluation"] = (p["launches_per_chunk"]
                                        * eval_chunks(graph) / 2)
        p.pop("top")
        eval_prof[label] = p

    def per_epoch(label):               # each callback ends a block
        m = marks[label]
        return [(t1 - t0) / (e1 - e0) for (e0, t0), (e1, t1) in zip(m, m[1:])]
    tables_bytes = sum(t.numel() * t.element_size() for t in init.values())
    info.update(
        steps_per_epoch=steps, launches=launches,
        launches_predicted=predicted,
        cut_steps_per_epoch=cut_steps,
        epoch_s={k: per_epoch(k) for k in marks},
        sync_checked_blocks=sync_checked,
        block_peak_memory={"tables_bytes": tables_bytes, **peaks_b},
        block_profile=profs, evaluate_s=secs, evaluate_profile=eval_prof,
        loss_history={k: v.loss_history for k, v in runs.items()},
        scale={"steps_per_epoch": scale_steps,
               "seconds": {t: r[1] for t, r in scale_runs.items()},
               "peak_bytes": {t: r[2] for t, r in scale_runs.items()},
               "metrics": scale_evals["sharded"]})
    same_answer = lambda a, b: (np.array_equal(a.ids, b.ids) and
                                np.array_equal(a.energies, b.energies))
    info["bitwise"] = {
        "s0_vs_sync": same_run(runs["s0"], runs["sync"]),
        "s1_block6_vs_block2": same_run(runs["s1_cut"], runs["s1_block2"]),
        "s1_sparse_vs_dense": same_run(runs["s1_sparse"], runs["s1_cut"]),
        "s1_sync_checked_vs_fit": sync_checked["s1"]["losses"]
        == runs["s1"].loss_history[:2],
        "s1_sparse_sync_checked_vs_fit": sync_checked["s1_sparse"][
            "losses"] == runs["s1"].loss_history[:2],
        **{f"{k}_sharded_vs_replicated": same_run(*v)
           for k, v in pairs.items()},
        "s1_sparse_sharded_vs_replicated": same_run(
            runs["s1_sparse_sharded"], runs["s1_sparse"]),
        "evaluate_sharded_vs_replicated": evals["sharded"]
        == evals["replicated"],
        "evaluate_sharded_vs_fused_l1": evals["sharded"] == evals["fused"],
        "query_tails_sharded": same_answer(answers["sharded"][0],
                                           answers["replicated"][0]),
        "query_heads_sharded": same_answer(answers["sharded"][1],
                                           answers["replicated"][1]),
        "scale_sharded_vs_replicated": same_run(
            scale_runs["sharded"][0], scale_runs["replicated"][0]),
        "scale_evaluate_sharded_vs_replicated": scale_evals["sharded"]
        == scale_evals["replicated"] == scale_evals["replicated_plain"],
        "async_cpu_vs_card": all(v for k, v in info["async"][
            "cpu_vs_card"].items() if k != "losses")}
    info["stale_differs_from_sync"] = not same_run(runs["s1_cut"],
                                                   runs["sync"])
    info["phase_s"] = time.perf_counter() - t_phase
    print("stale and sharded " + json.dumps(info), flush=True)

    if not all(info["bitwise"].values()):
        fail(f"stale or sharded runs that should agree gave other bits: "
             f"{info['bitwise']}")
    if not info["stale_differs_from_sync"]:
        fail("the S = 1 run gave the synchronous run's bits")
    if launches != predicted:
        fail(f"launches {launches} on the stale and sharded path; the path "
             f"predicts {predicted}")
    for label, c in sync_checked.items():
        if c["overflow"]:
            fail(f"the sync-checked {label} block overflowed: {c}")
    if profs["s1"]["dtoh_copies"] != 0:
        fail(f"a stale block made {profs['s1']['dtoh_copies']} "
             "device-to-host copies")
    for label, res in list(runs.items()) + [
            (f"{k}_sharded", v[1]) for k, v in pairs.items()]:
        if not all(t.is_cuda for t in res.params.values()):
            fail(f"{label}: a trained table is not on the card")
        if not all(map(math.isfinite, res.loss_history)):
            fail(f"{label}: non-finite loss {res.loss_history}")
    for label in ("s1", "s2"):
        hist = runs[label].loss_history
        if not hist[-1] < hist[0]:
            fail(f"the {label} loss did not fall: {hist}")
    for label, a in zip(("tails", "heads"), answers["sharded"]):
        check_topk(a, N_QUERY_PAIRS, 10, f"sharded {label}")
    return info, launches


def holdout_split(graph, frac, seed):
    """``(base graph, delta, is_cold)``: benchmarks/bench_online.py's
    entity holdout.  Every train triple touching a seeded ``frac`` of the
    entities moves to the delta, so those entities get no training signal
    in the base (exactly the rows ``scope="cold"`` frees); the base keeps
    the whole id space, so the update grows no table."""
    import numpy as np

    from repro_torch.data import kg as kg_data

    rng = np.random.default_rng(seed)
    cold = rng.choice(graph.n_entities, int(graph.n_entities * frac),
                      replace=False)
    is_cold = np.zeros(graph.n_entities, bool)
    is_cold[cold] = True
    hit = is_cold[graph.train[:, 0]] | is_cold[graph.train[:, 2]]
    base = kg_data.KG(graph.n_entities, graph.n_relations,
                      graph.train[~hit], graph.valid, graph.test)
    return base, np.asarray(graph.train[hit], np.int32), is_cold


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def online_path(torch, graph):
    """The online tier (item 11 of the module docstring).  Returns the
    path's info and its launches of each kernel."""
    import shutil

    import numpy as np

    from repro_torch import kg
    from repro_torch.core import mapreduce
    from repro_torch.data import kg as kg_data
    from repro_torch.kernels import rank_topk, transe_score as ts
    from repro_torch.online import OnlineUpdater, RefreshDaemon
    from repro_torch.serve import KGServer

    info = {"card": smi_line()}
    W = TRAIN["n_workers"]
    base_graph, delta, is_cold = holdout_split(graph, ONLINE_DELTA_FRAC,
                                               ONLINE_HOLDOUT_SEED)
    held = graph.test[is_cold[graph.test[:, 0]] | is_cold[graph.test[:, 2]]]
    eval_graph = kg_data.KG(graph.n_entities, graph.n_relations,
                            graph.train, graph.valid, held)
    small = delta[:ONLINE_SMALL]
    info["split"] = {"base_train": len(base_graph.train),
                     "delta": len(delta), "held_entities": int(is_cold.sum()),
                     "held_test": len(held)}
    _, first = np.unique(graph.test[:, :2], axis=0, return_index=True)
    hot = graph.test[np.sort(first)[:LIVE_UNIQUE], :2]
    tmp = tempfile.TemporaryDirectory()
    chain = os.path.join(tmp.name, "chain")
    servers, daemons = [], []
    t_phase = time.perf_counter()
    ts.transe_score.launches = 0               # --- online path ---
    ts.transe_score_bwd.launches = 0
    rank_topk.rank_counts.launches = 0
    try:
        base_res, fit_s = wall(torch, lambda: kg.fit(
            base_graph, "transe", "sgd", epochs=2, seed=0, device=DEVICE,
            **TRAIN, **ONLINE_BASE))
        base = base_res.kb
        # (a) the cold update: its plan and its run timed apart, the same
        # seed again through a delta chain, and mapreduce.train on the plan
        up = OnlineUpdater(base, scope="cold", **ONLINE_UPDATE)
        plan, plan_s = wall(torch, lambda: up.plan(delta))
        cold, update_s = wall(torch, lambda: up.update(delta))
        chained = base.update(delta, scope="cold", delta_dir=chain,
                              **ONLINE_UPDATE)
        direct = mapreduce.train(
            plan.delta_kg, plan.kcfg, plan.mcfg, epochs=plan.epochs,
            seed=plan.seed, params=plan.params,
            update_mask=plan.update_mask, model=base.model, device=DEVICE)
        # (b) the touched update
        tplan = OnlineUpdater(base, scope="touched",
                              **ONLINE_UPDATE).plan(delta)
        touched, touched_s = wall(torch, lambda: base.update(
            delta, scope="touched", **ONLINE_UPDATE))
        # (c) a small update on the CPU and on the card
        on_cpu = kg.KnowledgeBase(base.model, {n: t.cpu() for n, t in
                                               base.params.items()},
                                  graph=base.graph, norm=base.norm)
        small_cpu = on_cpu.update(small, **ONLINE_UPDATE)
        small_card = base.update(small, **ONLINE_UPDATE)
        # (d) the chain's second link, its reload, a broken copy
        tip = chained.update(small, delta_dir=chain, epochs=2, seed=2,
                             n_workers=W)
        reloaded, load_s = wall(torch, lambda: kg.KnowledgeBase.load_chain(
            chain, device=DEVICE))
        broken = os.path.join(tmp.name, "broken")
        shutil.copytree(chain, broken)
        shutil.rmtree(os.path.join(broken, "step_0000000001"))
        try:
            kg.KnowledgeBase.load_chain(broken, device=DEVICE)
            broken_refused = False
        except ValueError:
            broken_refused = True
        # (e) one masked block under the sync check, one profiled
        steps = (len(delta) // plan.mcfg.n_workers) // plan.mcfg.batch_size
        part = torch.as_tensor(kg_data.PARTITIONERS["balanced"](
            plan.seed, plan.delta_kg.train, plan.mcfg.n_workers),
            device=DEVICE)
        block_fn = mapreduce.make_block_fn(
            plan.mcfg, plan.kcfg, part, seed=plan.seed, with_overflow=True,
            update_mask=plan.update_mask)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, losses, overflow = block_fn(dict(plan.params), range(1))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        prof = profile_busy(torch, lambda: block_fn(dict(plan.params),
                                                    range(1)))
        prof.update(steps=steps, launches_per_step=prof["launches"] / steps,
                    dtoh_copies_per_step=prof["dtoh_copies"] / steps)
        # (f) the held-out entities' test triples, before and after
        ranks, eval_s = {}, {}
        for label, kb in (("base", base), ("cold", cold),
                          ("touched", touched)):
            m, eval_s[label] = wall(torch, lambda kb=kb: kg.evaluate(
                kb, kg=eval_graph, engine="device"))
            ranks[label] = m["entity_filtered"]["mean_rank"]
        # (g) a refresh into a live server under a query stream
        _, max_batch, wait_us = dict(
            (c[0], c) for c in LIVE_CONFIGS)["batch16_wait1ms"]
        srv = KGServer(cold, max_batch=max_batch, max_wait_us=wait_us,
                       default_k=LIVE_K, warm=True)
        servers.append(srv)
        daemon = RefreshDaemon(srv, epochs=2, seed=5, n_workers=W)
        daemons.append(daemon)
        daemon.start()
        flushed = {}

        def refresh():
            daemon.submit(delta[-ONLINE_SMALL:])
            t0 = time.perf_counter()
            flushed["ok"] = daemon.flush(timeout=LIVE_TIMEOUT_S)
            flushed["s"] = time.perf_counter() - t0

        before = srv.stats()
        pick, answers, rates = live_stream(
            srv, hot, ONLINE_STREAM["rate"], ONLINE_STREAM["arrivals"],
            seed=4, midway=refresh)
        late = hot[:ONLINE_STREAM["after"]]
        futs = [srv.submit("tails", a, b) for a, b in late]
        late_answers = [f.result(timeout=LIVE_TIMEOUT_S) for f in futs]
        after = srv.stats()
        arts = {cold.fingerprint(): cold, daemon.kb.fingerprint(): daemon.kb}
        by_fp = {}
        for (a, b), ans in zip(np.concatenate([pick, late]),
                               answers + late_answers):
            by_fp.setdefault(ans.fingerprint, []).append((a, b, ans))
        served_bitwise = set(by_fp) <= set(arts) and len(arts) == 2
        for key, group in by_fp.items():
            if key not in arts:
                continue
            res = arts[key].engine().query_tails(
                [g[0] for g in group], [g[1] for g in group], k=LIVE_K,
                chunk=64)
            served_bitwise &= all(
                answer_bits(ans, res.ids[i], res.energies[i])
                for i, (_, _, ans) in enumerate(group))
        stopped = daemon.stop(timeout=LIVE_TIMEOUT_S)
        launches = {"rank_counts": rank_topk.rank_counts.launches,
                    "transe_score": ts.transe_score.launches,
                    "transe_score_bwd": ts.transe_score_bwd.launches}
    finally:                                   # --- end ---
        for daemon in daemons:
            daemon.stop(timeout=LIVE_TIMEOUT_S)
        for srv in servers:
            srv.stop()
    chain_bytes = {step: dir_bytes(os.path.join(chain, f"step_{step:010d}"))
                   for step in (0, 1, 2)}
    tmp.cleanup()

    frozen, free_rows = {}, {}
    for label, kb2, p in (("cold", cold, plan), ("touched", touched, tplan)):
        frozen[label] = all(
            bits_equal(kb2.params[n][~torch.as_tensor(m, device=DEVICE)],
                       base.params[n][~torch.as_tensor(m, device=DEVICE)])
            for n, m in p.update_mask.items())
        free_rows[label] = {n: int(m.sum()) for n, m in
                            p.update_mask.items()}
    info.update({
        "fit_s": fit_s, "plan_s": plan_s, "update_s": update_s,
        "touched_update_s": touched_s, "epochs": ONLINE_UPDATE["epochs"],
        "epoch_s": update_s / ONLINE_UPDATE["epochs"],
        "workers": plan.mcfg.n_workers, "batch": plan.mcfg.batch_size,
        "steps_per_epoch": steps, "free_rows": free_rows,
        "masked_block": prof,
        "sync_checked_block": {"losses": losses.tolist(),
                               "overflow": int(overflow)},
        "chain_bytes": {"base_full_save": chain_bytes[0],
                        "delta_cold": chain_bytes[1],
                        "delta_small": chain_bytes[2]},
        "load_chain_s": load_s,
        "filtered_mean_rank_held_out": ranks, "evaluate_s": eval_s,
        "refresh": {**rates, "flushed": flushed.get("ok"),
                    "flush_s": flushed.get("s"),
                    "answers": {("before" if a is cold else "after"):
                                len(by_fp.get(k, []))
                                for k, a in arts.items()},
                    "across_swap": live_percentiles(
                        [a.latency_s for a in answers]),
                    "across_swap_misses": live_percentiles(
                        [a.latency_s for a in answers if not a.cached]),
                    "refreshes": daemon.refreshes, "daemon_stopped": stopped,
                    **live_delta(before, after)},
        "checks": {
            "frozen_rows_bitwise": frozen,
            "same_seed_same_fingerprint":
                chained.fingerprint() == cold.fingerprint(),
            "update_equals_direct_train": all(
                bits_equal(cold.params[n], direct.params[n])
                for n in cold.params),
            "small_update_cpu_equals_card": all(
                bits_equal(small_card.params[n].cpu(), small_cpu.params[n])
                for n in small_cpu.params)
            and small_card.fingerprint() == small_cpu.fingerprint(),
            "sync_checked_block_equals_train":
                losses.tolist()[0] == direct.loss_history[0],
            "chain_reloads_to_tip":
                reloaded.fingerprint() == tip.fingerprint(),
            "broken_chain_refused": broken_refused,
            "served_bitwise": served_bitwise,
        },
        "launches": launches,
        "phase_s": time.perf_counter() - t_phase})
    print("online " + json.dumps(info), flush=True)

    checks = info["checks"]
    failed = [k for k, v in checks.items()
              if not (all(v.values()) if isinstance(v, dict) else v)]
    if failed:
        fail(f"online checks failed: {failed}: {checks}")
    if info["sync_checked_block"]["overflow"]:
        fail(f"the sync-checked masked block overflowed: {info}")
    if prof["dtoh_copies"] != 0:
        fail(f"a masked block made {prof['dtoh_copies']} device-to-host "
             "copies")
    if not (flushed.get("ok") and stopped and daemon.refreshes == 1):
        fail(f"the refresh did not complete: {info['refresh']}")
    if after.steady_recompiles != 0:
        fail(f"{after.steady_recompiles} steady-state recompiles across "
             "the refresh")
    if not ranks["cold"] < ranks["base"]:
        fail(f"the cold update's filtered mean rank {ranks['cold']} on the "
             f"held-out entities does not beat the base's {ranks['base']}")
    for label, kb2 in (("cold", cold), ("touched", touched),
                       ("reloaded", reloaded), ("refreshed", daemon.kb)):
        if not all(t.is_cuda for t in kb2.params.values()):
            fail(f"{label}: a table is not on the card")
        if not all(bool(torch.isfinite(t).all())
                   for t in kb2.params.values()):
            fail(f"{label}: non-finite tables")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} launched {n} times on the online path")
    return info, launches


def _tee_stdout(fn):
    """``(result, printed text)`` of ``fn``, its prints shown as well."""
    import contextlib
    import io

    class Tee(io.StringIO):
        def write(self, s):
            sys.__stdout__.write(s)
            return super().write(s)

    buf = Tee()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def _subprocess_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        env[var] = str(ENTRY_SUBPROCESS_THREADS)
    return env


def _start(cmds, logdir):
    """Start every ``(label, argv)`` at once, from the checkout's root,
    output to a file each under ``logdir``: ``(start time, [(label, log,
    process)])``."""
    procs = []
    try:
        for label, argv in cmds:
            log = open(os.path.join(logdir, label), "w+")
            procs.append((label, log, subprocess.Popen(
                argv, cwd=ROOT, env=_subprocess_env(), stdout=log,
                stderr=subprocess.STDOUT)))
    except BaseException:
        _join((0.0, procs), 0)
        raise
    return time.perf_counter(), procs


def _join(started, timeout):
    """Join every started process within ``timeout`` seconds in all, kill
    what is left: ``{label: (returncode, output, seconds since start)}``."""
    t0, procs = started
    out = {}
    deadline = time.monotonic() + timeout
    try:
        for label, log, p in procs:
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            log.seek(0)
            out[label] = (rc, log.read(), time.perf_counter() - t0)
    finally:
        for _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return out


def entry_points_path(torch):
    """The launcher and the examples (item 12 of the module docstring).
    Returns the path's info and its launches of each kernel."""
    import numpy as np

    from repro_torch import kg
    from repro_torch.kernels import rank_topk, transe_score as ts
    from repro_torch.launch import train as launch
    from repro_torch.train import checkpoint as ckpt_lib

    info = {"card": smi_line()}
    tmp = tempfile.TemporaryDirectory()
    rng = np.random.default_rng(ENTRY_DELTA["seed"])
    n, new = ENTRY_DELTA["triples"], ENTRY_DELTA["new_entities"]
    delta = np.stack([
        np.concatenate([rng.integers(0, ENTRY_GRAPH["entities"], n - new),
                        np.arange(ENTRY_GRAPH["entities"],
                                  ENTRY_GRAPH["entities"] + new)]),
        rng.integers(0, 15, n),
        rng.integers(0, ENTRY_GRAPH["entities"], n)], 1)
    delta_path = os.path.join(tmp.name, "delta.tsv")
    with open(delta_path, "w") as f:
        f.writelines(f"{h}\t{r}\t{t}\n" for h, r, t in delta)
    def train_argv(triplets):
        return ["--kg", "transe", "--kg-entities",
                str(ENTRY_GRAPH["entities"]), "--kg-triplets", str(triplets),
                "--kg-epochs", str(ENTRY_GRAPH["epochs"]), "--kg-pipeline",
                "device", "--device", DEVICE]

    ckpt = os.path.join(tmp.name, "ckpt")
    argv = train_argv(ENTRY_GRAPH["triplets"]) + [
        "--kg-ckpt-dir", ckpt, "--kg-eval-engine", "device", "--kg-serve",
        "--kg-requests", str(ENTRY_REQUESTS), "--kg-update", delta_path]
    sub_argv = train_argv(ENTRY_SUBPROCESS_TRIPLETS)
    t_phase = time.perf_counter()
    ts.transe_score.launches = 0               # --- entry points path ---
    ts.transe_score_bwd.launches = 0
    rank_topk.rank_counts.launches = 0
    (res, printed), main_s = wall(torch, lambda: _tee_stdout(
        lambda: launch.main(argv)))
    launches = {"rank_counts": rank_topk.rank_counts.launches,
                "transe_score": ts.transe_score.launches,
                "transe_score_bwd": ts.transe_score_bwd.launches}
    # --- end ---
    # once main has been timed alone: the launcher in a subprocess on a
    # smaller graph and the three examples at cut epochs, started at once,
    # beside the direct fit that main's checkpoint is held against and
    # main() on the subprocess's arguments (untimed)
    py = sys.executable
    started = _start([
        ("launcher", [py, "-m", "repro_torch.launch.train"] + sub_argv),
        ("quickstart", [py, "examples/torch_quickstart.py", "--save-dir",
                        os.path.join(tmp.name, "kb"), "--device", DEVICE]),
        ("train_mapreduce_kg", [py, "examples/torch_train_mapreduce_kg.py",
                                "--epochs", str(ENTRY_EXAMPLE_EPOCHS),
                                "--eval-engine", "device", "--device",
                                DEVICE]),
        ("online_update", [py, "examples/torch_online_update.py",
                           "--epochs", str(ENTRY_EXAMPLE_EPOCHS),
                           "--update-epochs", "2", "--chain-dir",
                           os.path.join(tmp.name, "chain"), "--device",
                           DEVICE])], tmp.name)
    try:
        direct = kg.fit(
            res.kb.graph, model="transe", paradigm="sgd", n_workers=4,
            strategy="average", merge_transport="dense",
            table_sharding="replicated", partitioner=None, staleness=0,
            negatives="pertriplet", neg_candidates=0, backend="vmap",
            batch_size=256, dim=48, learning_rate=5e-2,
            epochs=ENTRY_GRAPH["epochs"], seed=0, device=DEVICE,
            pipeline="device", block_epochs=ENTRY_GRAPH["epochs"],
            merge_every=1, repartition_every=None)
        _, sub_printed = _tee_stdout(lambda: launch.main(sub_argv))
    finally:
        procs = _join(started, ENTRY_SUBPROCESS_S)
    tree, extra = ckpt_lib.load_tree(ckpt, ckpt_lib.latest_step(ckpt))
    tmp.cleanup()
    final, sub_final = (next(line for line in text.splitlines()
                             if "final loss" in line)
                        for text in (printed, sub_printed))
    served = next(line for line in printed.splitlines()
                  if line.startswith(f"served {ENTRY_REQUESTS} queries"))
    pct = {k: float(served.split(f"{k}=")[1].split("ms")[0])
           for k in ("p50", "p99")}
    examples = {label: {"rc": rc, "s": s, "tail": text[-600:]}
                for label, (rc, text, s) in procs.items()}
    info.update({
        "argv": argv, "subprocess_argv": sub_argv, "main_s": main_s,
        "final_line": final, "subprocess_final_line": sub_final,
        "served_line": served, "serve_ms": pct,
        "graph": {"train": len(res.kb.graph.train),
                  "entities": res.kb.graph.n_entities},
        "subprocesses": examples,
        "checks": {
            "checkpoint_equals_direct_fit": all(
                np.asarray(tree[n]).tobytes()
                == direct.params[n].cpu().numpy().tobytes()
                for n in direct.params)
            and extra["loss_history"] == direct.loss_history,
            "steady_recompiles_0": "steady_recompiles=0" in served,
            "update_applied": "applied --kg-update" in printed,
            "subprocess_same_final_line":
                procs["launcher"][0] == 0
                and sub_final in procs["launcher"][1],
            "quickstart": procs["quickstart"][0] == 0
            and "entity inference (filtered)" in procs["quickstart"][1],
            "train_mapreduce_kg": procs["train_mapreduce_kg"][0] == 0
            and "hits@10 retention" in procs["train_mapreduce_kg"][1],
            "online_update": procs["online_update"][0] == 0
            and "(bit-identical)" in procs["online_update"][1]
            and "steady_recompiles=0" in procs["online_update"][1],
            "on_the_card": all(t.is_cuda for t in res.params.values()),
        },
        "launches": launches,
        "phase_s": time.perf_counter() - t_phase})
    print(f"entry points on {info['card']}: launcher main {main_s:.2f} s "
          f"(graph build, {ENTRY_GRAPH['epochs']} device-pipeline epochs, "
          f"evaluation, update, {ENTRY_REQUESTS} served queries; alone on "
          "the host and the card), serve "
          f"p50 {pct['p50']} ms p99 {pct['p99']} ms", flush=True)
    print("entry_points " + json.dumps(info), flush=True)
    failed = [k for k, v in info["checks"].items() if not v]
    if failed:
        fail(f"entry point checks failed: {failed}: "
             f"{json.dumps(examples)[-3000:]}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{name} launched {count} times on the entry points path")
    return info, launches


def _graph_file(graph, path):
    import numpy as np

    np.savez(path, train=graph.train, valid=graph.valid, test=graph.test,
             sizes=np.array([graph.n_entities, graph.n_relations]))


def _load_graph(path):
    import numpy as np

    from repro_torch.data import kg as kg_data

    z = np.load(path)
    return kg_data.KG(int(z["sizes"][0]), int(z["sizes"][1]), z["train"],
                      z["valid"], z["test"])


def _host_params(res):
    return {n: t.cpu().numpy() for n, t in res.params.items()}


def _shard_runs(torch, graph, mesh, timed):
    """Phase 13's runs on ``mesh`` (``mesh=None``: the vmap twins):
    ``{label: result}``, with each run's seconds in ``timed``."""
    from repro_torch import kg

    shard = {} if mesh is None else dict(backend="shard_map", mesh=mesh)
    runs = {}

    def run(label, paradigm, epochs, **kw):
        res, s = wall(torch, lambda: kg.fit(
            graph, "transe", paradigm, epochs=epochs, seed=0, device=DEVICE,
            **TRAIN, **shard, **kw))
        timed[label] = s
        runs[label] = res

    run("device_sgd_dense", "sgd", 2, reduce_impl="allgather",
        block_epochs=2, **DEVICE_SGD)
    run("device_bgd", "bgd", 1, pipeline="device", block_epochs=1)
    return runs


def shard_graph(graph):
    """``graph`` with its entity count padded to a multiple of the
    workers (one entity no triplet names, for FB15k's 14,951), so a
    sharded entity table rests in the workers' row blocks."""
    from repro_torch.data import kg as kg_data

    W = TRAIN["n_workers"]
    return kg_data.KG(graph.n_entities + (-graph.n_entities) % W,
                      graph.n_relations, graph.train, graph.valid,
                      graph.test)


def _twelve_d_runs(torch, graph, mesh, timed, labels=None):
    """Phase 13's item-12d training runs on ``mesh`` (``None``: the vmap
    twins), those in ``labels`` (default all): ``{label: result}``, each
    run's seconds in ``timed``."""
    from repro_torch import kg

    shard = {} if mesh is None else dict(backend="shard_map", mesh=mesh)
    cells = {f"stale_{name}": ("sgd", SHARD_STALE_EPOCHS,
                               dict(SHARD_STALE, **extra))
             for name, extra in SHARD_TRANSPORTS.items()}
    cells["sharded_sgd"] = ("sgd", 2, dict(DEVICE_SGD, block_epochs=2,
                                           **SHARDED))
    cells["sharded_bgd"] = ("bgd", 1, dict(pipeline="device",
                                           block_epochs=1, **SHARDED))
    runs = {}
    for label, (paradigm, epochs, kw) in cells.items():
        if labels is not None and label not in labels:
            continue
        runs[label], timed[label] = wall(torch, lambda: kg.fit(
            graph, "transe", paradigm, epochs=epochs, seed=0, device=DEVICE,
            **TRAIN, **shard, **kw))
    return runs


def shard_server_queries(graph, n, seed):
    """``n`` (head, relation, filtered) tail queries of the test split."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = graph.test[rng.choice(len(graph.test), n, replace=False)]
    return [(int(h), int(r), bool(i % 2)) for i, (h, r) in
            enumerate(rows[:, :2])]


def shard_server(torch, kb, mesh, queries):
    """The live server over ``mesh`` (sharded tables, W workers), driven
    from this rank (the mesh's rank 0; every other rank constructs the
    same server and stops it): warm-up, the waves of
    ``SHARD_SERVER_WAVES`` (admission paused, so each is one wave), the
    ``queries`` as one burst, then the first wave again from the cache.
    Returns ``(checks, stats)``: every answer the direct engine call's
    bits on this artifact, the cached one the fresh one's, no steady
    recompile."""
    import numpy as np

    from repro_torch.serve import KGServer

    def direct(qs):
        out = {}
        for filt in (False, True):
            sel = [(h, r) for h, r, f in qs if f == filt]
            if sel:
                h, r = np.array(sel).T
                res = kb.query_tails(h, r, k=LIVE_K, filtered=filt)
                out.update({(int(a), int(b), filt): (res.ids[i],
                                                     res.energies[i])
                            for i, (a, b) in enumerate(sel)})
        return out

    waves = []
    for i, (size, filt) in enumerate(SHARD_SERVER_WAVES):
        waves.append([(h, r, filt) for h, r, _ in
                      queries[i * 16:i * 16 + size]])
    want = direct([q for w in waves for q in w] + list(queries))
    srv = KGServer(kb, max_batch=16, max_wait_us=1000, default_k=LIVE_K,
                   n_workers=TRAIN["n_workers"], table_sharding="sharded",
                   backend="shard_map", mesh=mesh)
    checks, answers = {}, []
    try:
        warm = srv.warmup(kinds=("tails",))
        for wave in waves + waves[:1]:
            srv.pause()
            futs = [srv.submit("tails", h, r, filtered=f) for h, r, f in wave]
            srv.resume()
            answers.append([f.result(timeout=LIVE_TIMEOUT_S) for f in futs])
        futs = [srv.submit("tails", h, r, filtered=f) for h, r, f in queries]
        burst = [f.result(timeout=LIVE_TIMEOUT_S) for f in futs]
        stats = srv.stats()
    finally:
        srv.stop()
    checks["waves_equal_engine"] = all(
        answer_bits(a, *want[q]) for wave, got in zip(waves, answers)
        for q, a in zip(wave, got))
    checks["burst_equals_engine"] = all(
        answer_bits(a, *want[q]) for q, a in zip(queries, burst))
    checks["cached_equals_fresh"] = all(
        a.cached and not b.cached and answer_bits(a, b.ids, b.energies)
        for a, b in zip(answers[-1], answers[0]))
    checks["steady_recompiles_0"] = stats.steady_recompiles == 0
    return checks, {"p50_ms": stats.p50_ms, "p99_ms": stats.p99_ms,
                    "warm_compiles": warm,
                    "waves": stats.waves, "mean_wave": stats.mean_wave,
                    "bucket_waves": stats.bucket_waves,
                    "steady_recompiles": stats.steady_recompiles,
                    "requests": stats.requests}


def shard_resting(torch, graph, mesh):
    """One sharded sparse SGD block driven directly over ``mesh``: the
    tables this rank rests after it, their bytes and rows."""
    from repro_torch import kg
    from repro_torch.core import mapreduce
    from repro_torch.core.models import get_model
    from repro_torch.data import kg as kg_data
    from repro_torch.parallel import sharding
    from repro_torch.parallel import util as par

    W = TRAIN["n_workers"]
    kcfg, mcfg = kg.make_configs(graph, "transe", "sgd", **TRAIN,
                                 backend="shard_map", block_epochs=2,
                                 **DEVICE_SGD, **SHARDED)
    model = get_model("transe")
    params = model.init_params(torch.Generator().manual_seed(0), kcfg,
                               device=DEVICE)
    lo, hi = par.local_workers(mesh, W)
    part = kg_data.PARTITIONERS[mcfg.partition](0, graph.train, W)[lo:hi]
    layout = mapreduce.resting_layout(mcfg, kcfg, model)
    block = mapreduce.make_block_fn(
        mcfg, kcfg, torch.as_tensor(part, device=DEVICE), model=model,
        seed=0, mesh=mesh)
    rest, _ = block(sharding.place(params, layout, W, mesh), range(2))
    torch.cuda.synchronize()
    return {"layout": layout,
            "rows": sharding.resting_rows(kcfg.n_entities, W, mesh),
            "bytes": {n: sharding.resident_bytes({n: t})
                      for n, t in rest.items()},
            "whole_bytes": {n: t.numel() * t.element_size()
                            for n, t in params.items()},
            "ent": rest["ent"].cpu().numpy()}


def shard_rank(spec_path, rank):
    """One gloo rank of phase 13 (b), run as ``python3 chip_smoke.py
    --shard-rank SPEC RANK`` by ``shard_map_path``: the device-pipeline
    SGD round, a BGD epoch and the evaluation over an M-rank mesh that
    shares the one card; writes its results, seconds and launch counts
    to the spec's output prefix."""
    import pickle
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import kg
    from repro_torch.kernels import rank_topk, transe_score as ts
    from repro_torch.parallel import util as par

    global DEVICE
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    DEVICE = spec["device"]
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    else:                      # a rehearsal on the CPU: nothing to sync
        torch.cuda.synchronize = lambda: None
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", store=dist.FileStore(spec["store"], spec["M"]),
        world_size=spec["M"], rank=rank,
        timeout=timedelta(seconds=SHARD_COLLECTIVE_S))
    try:
        mesh = par.workers_mesh(spec["M"], DEVICE)
        graph = _load_graph(spec["graph"])
        ts.transe_score.launches = 0
        ts.transe_score_bwd.launches = 0
        rank_topk.rank_counts.launches = 0
        timed = {}
        runs = _shard_runs(torch, graph, mesh, timed)
        metrics, timed["evaluate"] = wall(torch, lambda: kg.evaluate(
            runs["device_sgd_dense"].kb, engine="device",
            backend="shard_map", mesh=mesh, n_workers=TRAIN["n_workers"]))
        # item 12d over the gloo mesh
        sgraph = shard_graph(graph)
        runs.update(_twelve_d_runs(torch, sgraph, mesh, timed,
                                   ("stale_sharded", "sharded_sgd")))
        kb = runs["sharded_sgd"].kb
        sharded_metrics, timed["evaluate_sharded"] = wall(
            torch, lambda: kg.evaluate(
                kb, engine="device", backend="shard_map", mesh=mesh,
                n_workers=TRAIN["n_workers"], table_sharding="sharded"))
        resting = shard_resting(torch, sgraph, mesh)
        server = None
        queries = shard_server_queries(sgraph, SHARD_SERVER_REQUESTS, 5)
        t0 = time.perf_counter()
        if par.mesh_rank(mesh) == 0:
            server = shard_server(torch, kb, mesh, queries)
        else:
            from repro_torch.serve import KGServer

            KGServer(kb, max_batch=16, max_wait_us=1000, default_k=LIVE_K,
                     n_workers=TRAIN["n_workers"], table_sharding="sharded",
                     backend="shard_map", mesh=mesh).stop(
                         timeout=SHARD_COLLECTIVE_S)
        timed["server"] = time.perf_counter() - t0
        out = {"params": {k: _host_params(r) for k, r in runs.items()},
               "loss": {k: r.loss_history for k, r in runs.items()},
               "metrics": metrics, "sharded_metrics": sharded_metrics,
               "resting": resting, "server": server, "seconds": timed,
               "launches": {"rank_counts": rank_topk.rank_counts.launches,
                            "transe_score": ts.transe_score.launches,
                            "transe_score_bwd":
                                ts.transe_score_bwd.launches}}
    finally:
        dist.destroy_process_group()
    name = f"{spec['out']}.rank{rank}"
    with open(name + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(name + ".tmp", name)


def shard_map_path(torch, graph):
    """The shard_map backend (item 13 of the module docstring).  Returns
    the path's info and its launches of each kernel."""
    import pickle
    from datetime import timedelta

    import numpy as np
    import torch.distributed as dist

    from repro_torch import kg
    from repro_torch.kernels import rank_topk, transe_score as ts
    from repro_torch.parallel import util as par

    info = {"card": smi_line()}
    W = TRAIN["n_workers"]
    tmp = tempfile.TemporaryDirectory()
    same = lambda a, b: all(bits_equal(a.params[n], b.params[n])
                            for n in a.params) \
        and a.loss_history == b.loss_history
    rng = np.random.default_rng(3)
    pairs = graph.test[rng.choice(len(graph.test), N_QUERY_PAIRS,
                                  replace=False)]
    sgraph = shard_graph(graph)
    t_phase = time.perf_counter()
    host_sgd = (("host_sgd_average", {}),
                ("host_sgd_random", dict(strategy="random")))
    device_sgd = (("device_sgd_psum", {}),
                  ("device_sgd_sparse", dict(merge_transport="sparse")))
    # (a) NCCL, one rank in this process, all W workers in it
    dist.init_process_group(
        SHARD_M1_BACKEND,
        store=dist.FileStore(os.path.join(tmp.name, "m1"), 1),
        world_size=1, rank=0, timeout=timedelta(seconds=SHARD_COLLECTIVE_S))
    try:
        mesh = par.workers_mesh(1, DEVICE)
        par.all_gather(torch.zeros(1, device=DEVICE), mesh)   # communicator
        # the vmap twins first, outside the path's counts
        twin_s, want = {}, {}
        vmap_runs = _shard_runs(torch, graph, None, twin_s)
        for label, kw in host_sgd:
            twin, twin_s[label] = wall(torch, lambda kw=kw: kg.fit(
                graph, "transe", "sgd", epochs=1, seed=0, device=DEVICE,
                **TRAIN, **kw))
            want[f"{label}_allgather"] = want[f"{label}_psum"] = twin
        want["host_bgd"], twin_s["host_bgd"] = wall(torch, lambda: kg.fit(
            graph, "transe", "bgd", epochs=1, seed=0, device=DEVICE,
            **TRAIN))
        want["device_sgd_psum"] = vmap_runs["device_sgd_dense"]
        want["device_sgd_sparse"], twin_s["device_sgd_sparse"] = wall(
            torch, lambda: kg.fit(
                graph, "transe", "sgd", epochs=2, seed=0, device=DEVICE,
                block_epochs=2, **TRAIN, **DEVICE_SGD,
                merge_transport="sparse"))
        kb = vmap_runs["device_sgd_dense"].kb
        want_m, twin_s["evaluate"] = wall(torch, lambda: kg.evaluate(
            kb, engine="device"))
        want_q = kb.query_tails(pairs[:, 0], pairs[:, 1], k=LIVE_K,
                                filtered=True)
        # item 12d's twins, on the padded graph
        vmap_12d = _twelve_d_runs(torch, sgraph, None, twin_s)
        kb12 = vmap_12d["sharded_sgd"].kb
        want_m12, twin_s["evaluate_sharded"] = wall(
            torch, lambda: kg.evaluate(kb12, engine="device", n_workers=W,
                                       table_sharding="sharded"))
        want_q12 = kb12.query_tails(pairs[:, 0], pairs[:, 1], k=LIVE_K,
                                    filtered=True)
        ts.transe_score.launches = 0           # --- shard_map path ---
        ts.transe_score_bwd.launches = 0
        rank_topk.rank_counts.launches = 0
        timed, got = {}, {}
        shard_runs = _shard_runs(torch, graph, mesh, timed)
        for label, kw in host_sgd:
            for impl in ("allgather", "psum"):
                got[f"{label}_{impl}"], timed[f"{label}_{impl}"] = wall(
                    torch, lambda kw=kw, impl=impl: kg.fit(
                        graph, "transe", "sgd", epochs=1, seed=0,
                        device=DEVICE, backend="shard_map", mesh=mesh,
                        reduce_impl=impl, **TRAIN, **kw))
        got["host_bgd"], timed["host_bgd"] = wall(torch, lambda: kg.fit(
            graph, "transe", "bgd", epochs=1, seed=0, device=DEVICE,
            backend="shard_map", mesh=mesh, **TRAIN))
        for label, kw in device_sgd:
            got[label], timed[label] = wall(torch, lambda kw=kw: kg.fit(
                graph, "transe", "sgd", epochs=2, seed=0, device=DEVICE,
                block_epochs=2, backend="shard_map", mesh=mesh, **TRAIN,
                **DEVICE_SGD, **kw))
        got_m, timed["evaluate"] = wall(torch, lambda: kg.evaluate(
            kb, engine="device", backend="shard_map", mesh=mesh,
            n_workers=W))
        got_q, timed["query_tails"] = wall(torch, lambda: kb.query_tails(
            pairs[:, 0], pairs[:, 1], k=LIVE_K, filtered=True,
            backend="shard_map", mesh=mesh, n_workers=W))
        # item 12d: staleness, sharded tables and the live server
        before_12d = (ts.transe_score.launches,
                      ts.transe_score_bwd.launches)
        got_12d = _twelve_d_runs(torch, sgraph, mesh, timed)
        nccl_launches_12d = {
            "transe_score": ts.transe_score.launches - before_12d[0],
            "transe_score_bwd": ts.transe_score_bwd.launches
            - before_12d[1]}
        got_m12, timed["evaluate_sharded"] = wall(torch, lambda: kg.evaluate(
            kb12, engine="device", backend="shard_map", mesh=mesh,
            n_workers=W, table_sharding="sharded"))
        got_q12, timed["query_tails_sharded"] = wall(
            torch, lambda: kb12.query_tails(
                pairs[:, 0], pairs[:, 1], k=LIVE_K, filtered=True,
                backend="shard_map", mesh=mesh, n_workers=W,
                table_sharding="sharded"))
        t0 = time.perf_counter()
        server_ok, server_stats = shard_server(
            torch, kb12, mesh, shard_server_queries(
                sgraph, SHARD_SERVER_REQUESTS, 5))
        timed["server"] = time.perf_counter() - t0
        nccl_launches = {"rank_counts": rank_topk.rank_counts.launches,
                         "transe_score": ts.transe_score.launches,
                         "transe_score_bwd": ts.transe_score_bwd.launches}
        # --- end ---
    finally:
        dist.destroy_process_group()
    pairs_ok = {label: same(got[label], want[label]) for label in got}
    for label in vmap_runs:
        pairs_ok[label] = same(shard_runs[label], vmap_runs[label])
    pairs_ok["evaluate"] = got_m == want_m
    pairs_ok["query_tails"] = bool(
        (got_q.ids == want_q.ids).all()
        and got_q.energies.tobytes() == want_q.energies.tobytes())
    for label in vmap_12d:
        pairs_ok[label] = same(got_12d[label], vmap_12d[label])
    pairs_ok["evaluate_sharded"] = got_m12 == want_m12
    pairs_ok["query_tails_sharded"] = bool(
        (got_q12.ids == want_q12.ids).all()
        and got_q12.energies.tobytes() == want_q12.energies.tobytes())
    pairs_ok.update({f"server_{k}": v for k, v in server_ok.items()})
    # (b) M = 2 gloo ranks sharing the card, against (a)'s vmap twins
    M = SHARD_GLOO_RANKS
    _graph_file(graph, os.path.join(tmp.name, "graph.npz"))
    spec = {"M": M, "store": os.path.join(tmp.name, "gloo"),
            "graph": os.path.join(tmp.name, "graph.npz"),
            "out": os.path.join(tmp.name, "rank"), "device": DEVICE}
    with open(os.path.join(tmp.name, "spec"), "wb") as f:
        pickle.dump(spec, f)
    procs = _join(_start(
        [(f"rank{r}", [sys.executable, os.path.abspath(__file__),
                       "--shard-rank", os.path.join(tmp.name, "spec"),
                       str(r)]) for r in range(M)], tmp.name), SHARD_RANK_S)
    bad = {k: v[1][-3000:] for k, v in procs.items() if v[0] != 0}
    if bad:
        tmp.cleanup()
        fail(f"gloo ranks failed: {bad}")
    ranks = []
    for r in range(M):
        with open(f"{spec['out']}.rank{r}", "rb") as f:
            ranks.append(pickle.load(f))
    tmp.cleanup()
    gloo_ok = {}
    for r, out in enumerate(ranks):
        sgd = vmap_runs["device_sgd_dense"]
        gloo_ok[f"rank{r}_sgd_allgather_bitwise"] = all(
            out["params"]["device_sgd_dense"][n].tobytes()
            == sgd.params[n].cpu().numpy().tobytes() for n in sgd.params) \
            and out["loss"]["device_sgd_dense"] == sgd.loss_history
        bgd = vmap_runs["device_bgd"]
        gloo_ok[f"rank{r}_bgd_within_tolerance"] = all(
            np.allclose(out["params"]["device_bgd"][n],
                        bgd.params[n].cpu().numpy(), rtol=1e-4, atol=1e-5)
            for n in bgd.params)
        gloo_ok[f"rank{r}_evaluate_exact"] = out["metrics"] == want_m
        gloo_ok[f"rank{r}_equals_rank0"] = all(
            out["params"][k][n].tobytes() == ranks[0]["params"][k][n].tobytes()
            for k in out["params"] for n in out["params"][k])
        for label in ("stale_sharded", "sharded_sgd"):
            twin = vmap_12d[label]
            gloo_ok[f"rank{r}_{label}_bitwise"] = all(
                out["params"][label][n].tobytes()
                == twin.params[n].cpu().numpy().tobytes()
                for n in twin.params) \
                and out["loss"][label] == twin.loss_history
        gloo_ok[f"rank{r}_evaluate_sharded_exact"] = (
            out["sharded_metrics"] == want_m12)
        rest = out["resting"]
        lo, hi = rest["rows"]
        gloo_ok[f"rank{r}_rests_own_rows"] = rest["ent"].tobytes() == (
            vmap_12d["sharded_sgd"].params["ent"].cpu().numpy()[lo:hi]
            .tobytes())
        gloo_ok[f"rank{r}_rests_1_of_M"] = (
            rest["layout"] == {"ent": "row", "rel": "whole"}
            and rest["bytes"]["ent"] * M == rest["whole_bytes"]["ent"]
            and rest["bytes"]["rel"] == rest["whole_bytes"]["rel"])
    gloo_server_ok, gloo_server = ranks[0]["server"]
    gloo_ok.update({f"server_{k}": v for k, v in gloo_server_ok.items()})
    gloo_launches = {k: sum(out["launches"][k] for out in ranks)
                     for k in ranks[0]["launches"]}
    launches = {k: nccl_launches[k] + gloo_launches[k] for k in nccl_launches}
    E, R, k = graph.n_entities, graph.n_relations, DIM
    reduce_bytes = {
        # the all-gathered output buffers of one dense `average` Reduce:
        # every worker's table, touch counts and loss, per table
        "allgather": sum(4 * W * n * (k + 1) + 4 * W for n in (E, R)),
        # the psum Reduce's three all-reduced buffers per table: the touch
        # total (N,), the weighted sum and the plain sum (N, k)
        "psum": sum(4 * n * (2 * k + 1) for n in (E, R))}
    epoch_s = {
        "vmap_dense": twin_s["device_sgd_dense"] / 2,
        "shard_dense_allgather": timed["device_sgd_dense"] / 2,
        "shard_dense_psum": timed["device_sgd_psum"] / 2,
        "vmap_sparse": twin_s["device_sgd_sparse"] / 2,
        "shard_sparse": timed["device_sgd_sparse"] / 2}
    epochs_12d = {f"stale_{t}": SHARD_STALE_EPOCHS for t in SHARD_TRANSPORTS}
    epochs_12d.update(sharded_sgd=2, sharded_bgd=1)
    for label, n in epochs_12d.items():
        epoch_s[f"vmap_{label}"] = twin_s[label] / n
        epoch_s[f"shard_{label}"] = timed[label] / n
    eval_s = {"vmap_sharded": twin_s["evaluate_sharded"],
              "shard_sharded": timed["evaluate_sharded"],
              "vmap_replicated": twin_s["evaluate"],
              "shard_replicated": timed["evaluate"]}
    gloo_s = {f"rank{r}": out["seconds"] for r, out in enumerate(ranks)}
    resting = {f"rank{r}": {"rows": out["resting"]["rows"],
                            "bytes": out["resting"]["bytes"],
                            "whole_bytes": out["resting"]["whole_bytes"]}
               for r, out in enumerate(ranks)}
    info.update({
        "nccl_m1": {"seconds": timed, "vmap_seconds": twin_s,
                    "epoch_s": epoch_s, "evaluate_s": eval_s,
                    "bitwise_vmap": pairs_ok, "launches": nccl_launches,
                    "launches_12d": nccl_launches_12d,
                    "server": server_stats},
        "gloo_m2_one_card": {"seconds": gloo_s, "checks": gloo_ok,
                             "launches": gloo_launches,
                             "resting": resting, "server": gloo_server,
                             "process_s": {k: v[2] for k, v in
                                           procs.items()}},
        "entities_12d": sgraph.n_entities,
        "reduce_bytes": reduce_bytes,
        "steps_per_epoch": len(graph.train) // W // TRAIN["batch_size"],
        "launches": launches,
        "phase_s": time.perf_counter() - t_phase})
    print(f"shard_map on {info['card']}: NCCL M=1 device-pipeline epoch s "
          f"{json.dumps(epoch_s)}; bytes a dense average Reduce "
          f"{json.dumps(reduce_bytes)}; gloo over one card, M={M}: "
          f"{json.dumps(gloo_s)}", flush=True)
    print(f"shard_map 12d on {info['card']}: evaluation s "
          f"{json.dumps(eval_s)}; server over the NCCL mesh p50/p99 ms "
          f"{server_stats['p50_ms']}/{server_stats['p99_ms']}, over the "
          f"gloo mesh {gloo_server['p50_ms']}/{gloo_server['p99_ms']}; "
          f"resting bytes a gloo rank {json.dumps(resting)}", flush=True)
    print("shard_map " + json.dumps(info), flush=True)
    failed = [k for k, v in {**pairs_ok, **gloo_ok}.items() if not v]
    if failed:
        fail(f"shard_map checks failed: {failed}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{name} launched {count} times on the shard_map path")
    for name, count in nccl_launches_12d.items():
        if count <= 0:
            fail(f"{name} launched {count} times on the stale and sharded "
                 "runs")
    return info, launches


# ---------------------------------------------------------------------------
# phase 14: LM serving (the dense and vlm families)
# ---------------------------------------------------------------------------

# the published widths each full-width run must have
LM_SHAPES = {
    "qwen3-4b": dict(n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
                     head_dim=128, d_ff=9728, vocab_size=151936,
                     qk_norm=True, rope_theta=1e6),
    "gemma2-2b": dict(n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
                      head_dim=256, d_ff=9216, vocab_size=256000,
                      window=4096, attn_softcap=50.0, final_softcap=30.0,
                      post_norms=True, embed_scale=True),
}
LM_A = dict(batch=4, prompt=128, new=32, long_prompt=4096, long_steps=8)
LM_B = dict(prompt=4100, steps=8)        # past gemma2's 4,096 window
LM_C = dict(batch=2, prompt=32, steps=4)
LM_PROFILE_STEPS = 4                    # decode steps of the profiled wave
LM_REDUCED = ("smollm-135m", "gemma2-9b", "llava-next-mistral-7b")
LM_REDUCED_RUN = dict(batch=2, prompt=8, steps=6)
LM_LAUNCHER = ["--arch", "qwen3-4b", "--batch", "4", "--prompt-len", "16",
               "--max-new", "32"]
LM_LAUNCHER_S = 180
# bf16 decode against the teacher-forced forward, gemma2-2b at full width:
# 2.5 times the 0.081 measured on an H100 (logits up to 7.4)
LM_BF16_TOL = 0.2
# fp32 decode against the teacher-forced forward, and the card against the
# CPU (TF32 off): measured at most 1.3e-5 (qwen3-4b at full width, logits
# up to 5.2) and 2.0e-6 (the CPU, reduced llava) on an H100
LM_FP32_TOL = 1e-4


# ---------------------------------------------------------------------------
# phase 15: LM serving for the moe family (MLA and the scatter MoE FFN)
# ---------------------------------------------------------------------------

LM_SHAPES.update({
    "qwen2-moe-a2.7b": dict(n_layers=24, d_model=2048, n_heads=16,
                            n_kv_heads=16, head_dim=128, vocab_size=151936,
                            n_experts=60, n_shared_experts=4, top_k=4,
                            moe_d_ff=1408, capacity_factor=1.25),
    # cut in depth (MOE_DEEPSEEK_LAYERS): every width as published
    "deepseek-v2-236b": dict(d_model=5120, n_heads=128, d_ff=12288,
                             vocab_size=102400, use_mla=True,
                             kv_lora_rank=512, q_lora_rank=1536,
                             qk_nope_head_dim=128, qk_rope_head_dim=64,
                             v_head_dim=128, n_experts=160,
                             n_shared_experts=2, top_k=6, moe_d_ff=1536,
                             first_k_dense=1, routed_scaling=16.0,
                             capacity_factor=1.25),
})
# deepseek-v2-236b's 60 layers hold 236 B parameters: one MoE layer's
# experts are 3.77 B (15.1 GB in fp32), so the card holds the dense first
# layer and 2 MoE layers (9.33 B parameters, 37.3 GB)
MOE_DEEPSEEK_LAYERS = 3
MOE_PARAMS = {"qwen2-moe-a2.7b": 15_146_059_776,
              "deepseek-v2-236b": 9_330_795_520}
MOE_A = dict(batch=4, prompt=128, new=32)
MOE_LONG = dict(prompt=2100, steps=4)   # past _DENSE_MAX: the flash loop
MOE_C = dict(batch=2, prompt=32, steps=4)
MOE_REDUCED = ("qwen2-moe-a2.7b", "deepseek-v2-236b")
MOE_LAUNCHER = ["--arch", "qwen2-moe-a2.7b", "--batch", "4", "--prompt-len",
                "16", "--max-new", "16"]


def lm_config(arch, **overrides):
    """``arch``'s config at full width, with ``overrides``."""
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get_config(arch), **overrides)


def lm_params(torch, arch, cfg, published=True):
    """A seeded ``DecoderTask`` and its parameters on the card, and the
    init seconds; ``published``: check the config's widths against
    ``LM_SHAPES``."""
    from repro_torch.models import registry

    task = registry.make_task(cfg, DEVICE)
    params, init_s = wall(torch, lambda: task.init(
        torch.Generator(device=DEVICE).manual_seed(0)))
    want = LM_SHAPES.get(arch, {}) if published else {}
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        fail(f"{arch}: widths {got} are not the published {want}")
    for name, p in params.named_parameters():
        if p.device.type != torch.device(DEVICE).type or \
                p.dtype != cfg.param_dtype:
            fail(f"{arch}: {name} is {p.dtype} on {p.device}")
    return task, params, init_s


def lm_prompts(cfg, B, L, seed):
    import numpy as np

    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32)


def lm_free(torch):
    """Return a freed model's memory to the card; its host seconds."""
    import gc

    t0 = time.perf_counter()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return time.perf_counter() - t0


def lm_steps(torch, task, params, toks, Lp, steps, patch=None):
    """Prefill ``toks[:, :Lp]``, then decode ``toks[:, Lp:Lp + steps]``
    one by one: the logits of every call (B, steps + 1, V), the prefill's
    seconds and the decode's ms a step."""
    n_vis = 0 if patch is None else patch.shape[1]
    batch = {"tokens": toks[:, :Lp]}
    if patch is not None:
        batch["patch_embeds"] = patch
    (caches, logits), prefill_s = wall(torch,
                                       lambda: task.prefill(params, batch))
    out = [logits[:, 0]]
    t0 = time.perf_counter()
    for t in range(steps):
        logits, caches = task.decode_step(params, {
            "tokens": toks[:, Lp + t:Lp + t + 1], "pos": Lp + t + n_vis},
            caches)
        out.append(logits[:, 0])
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    return torch.stack(out, dim=1), prefill_s, decode_ms


def lm_forward_logits(torch, params, toks, last, patch=None):
    """The teacher-forced forward over ``toks``: logits at the last
    ``last`` text positions only (B, last, V)."""
    n_vis = 0 if patch is None else patch.shape[1]
    B, L = toks.shape
    positions = torch.arange(L + n_vis, device=params.device)[None].expand(
        B, -1)
    with torch.no_grad():
        hidden, _, _ = params.forward(
            torch.as_tensor(toks, device=params.device), positions,
            patch_embeds=patch)
        return params.logits(hidden[:, -last:])


def lm_agreement(torch, got, want, tol):
    """Max abs difference of two logit stacks, the largest logit, and the
    positions whose ids differ although the reference's top-2 gap exceeds
    ``tol``."""
    top2 = torch.topk(want.float(), 2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    differ = (got.argmax(-1) != want.argmax(-1)) & (gap > tol)
    return {"max_abs_err": float((got - want).abs().max()),
            "max_abs_logit": float(want.abs().max()),
            "min_top2_gap": float(gap.min()),
            "ids_differ_past_tol": int(differ.sum())}


def lm_card_against_cpu(torch, arch):
    """``arch`` at reduced width on the card: decode against its
    teacher-forced forward, and against the same parameters' decode on
    the CPU (``LM_REDUCED_RUN``'s wave)."""
    from repro_torch.models.transformer import DecoderLM

    R = LM_REDUCED_RUN
    cfg = lm_config(arch).reduced()
    task, params, _ = lm_params(torch, arch, cfg, published=False)
    patch = None
    if cfg.vision_tokens:
        from repro_torch.models import vlm_stub
        patch = vlm_stub.synthetic_patch_embeds(
            torch.Generator(device=DEVICE).manual_seed(1), R["batch"],
            cfg.vision_tokens, cfg.d_model, cfg.dtype)
    toks = torch.as_tensor(lm_prompts(cfg, R["batch"],
                                      R["prompt"] + R["steps"], 4),
                           device=DEVICE)
    got, _, _ = lm_steps(torch, task, params, toks, R["prompt"],
                         R["steps"], patch)
    want = lm_forward_logits(torch, params, toks, R["steps"] + 1, patch)
    host = DecoderLM(cfg, "cpu")
    host.load_state_dict({k: v.cpu() for k, v in
                          params.state_dict().items()})
    on_host, _, _ = lm_steps(torch, type(task)(cfg, "cpu"), host,
                             toks.cpu(), R["prompt"], R["steps"],
                             None if patch is None else patch.cpu())
    return {"forward": lm_agreement(torch, got, want, LM_FP32_TOL),
            "cpu": lm_agreement(torch, got.cpu(), on_host, LM_FP32_TOL)}


def lm_launcher(argv, n_tokens, ok, label, started=None):
    """``python -m repro_torch.launch.serve argv`` in a process of its
    own (or the one ``started`` already runs): its exit code, seconds and
    two printed lines, checked into ``ok`` (``n_tokens`` generated, 16
    ids shown)."""
    import re

    if started is None:
        with tempfile.TemporaryDirectory() as logdir:
            rc, out, seconds = _join(_start([("serve", [
                sys.executable, "-m", "repro_torch.launch.serve"] + argv)],
                logdir), LM_LAUNCHER_S)["serve"]
    else:
        rc, out, seconds = _join(started, LM_LAUNCHER_S)["serve"]
    lines = out.strip().splitlines()[-2:]
    m1 = re.match(r"^generated (\d+) tokens in (\d+\.\d\d)s "
                  r"\((\d+\.\d) tok/s incl\. compile\)$",
                  lines[0] if lines else "")
    m2 = re.match(r"^first sequence: \[(\d+(, \d+)*)\]$",
                  lines[1] if len(lines) > 1 else "")
    ok["d_launcher_exit_0"] = rc == 0
    ok["d_launcher_lines"] = bool(m1 and m2) and \
        int(m1.group(1)) == n_tokens and len(m2.group(1).split(", ")) == 16
    if rc != 0:
        print(out[-4000:], flush=True)
    print(f"{label} (d) python -m repro_torch.launch.serve "
          f"{' '.join(argv)}: exit {rc} in {seconds:.1f} s: {lines}",
          flush=True)
    return {"rc": rc, "seconds": seconds, "lines": lines}


def lm_serving_path(torch):
    """LM serving (item 14 of the module docstring).  Returns the path's
    info and its launches of each kernel (none lies on it: 0 expected)."""
    import numpy as np

    from repro_torch.kernels import rank_topk, transe_score as ts
    from repro_torch.models import attention
    from repro_torch.serve import engine as engine_lib

    t_phase = time.perf_counter()
    card = smi_line()
    info = {"card": card, "part_s": {}, "free_s": []}
    ok = {}

    marks = [t_phase]

    def part_done(label):
        """Keep the seconds since the last part ended, freeing included."""
        marks.append(time.perf_counter())
        info["part_s"][label] = marks[-1] - marks[-2]

    rank_topk.rank_counts.launches = 0             # --- LM serving path ---
    ts.transe_score.launches = 0
    ts.transe_score_bwd.launches = 0

    # (a) qwen3-4b at full width, bf16 activations
    arch = "qwen3-4b"
    torch.cuda.reset_peak_memory_stats()
    task, params, init_s = lm_params(torch, arch, lm_config(arch))
    a = {"params": sum(p.numel() for p in params.parameters()),
         "init_s": init_s}
    eng = engine_lib.Engine(task, params)
    B, Lp, n = LM_A["batch"], LM_A["prompt"], LM_A["new"]
    prompts = lm_prompts(task.cfg, B, Lp, 0)
    gcfg = engine_lib.GenerateConfig(max_new_tokens=n)
    ids, a["generate_first_s"] = wall(torch, lambda: eng.generate(prompts,
                                                                  gcfg))
    again, a["generate_s"] = wall(torch, lambda: eng.generate(prompts, gcfg))
    a["tokens_per_s"] = B * n / a["generate_s"]
    ok["a_ids_shape"] = ids.shape == (B, n) and bool(
        ((ids >= 0) & (ids < task.cfg.vocab_size)).all())
    ok["a_generate_deterministic"] = bool((ids == again).all())
    # where a decode step's time goes: launches and the device's idle share
    # of a short wave, less its prefill (the profiler's own processing of a
    # 32-token wave's ~130,000 launches took ~25 s)
    profiled = {}
    for label, new_tokens in (("prefill", 1), ("wave", 1 + LM_PROFILE_STEPS)):
        prof = profile_busy(torch, lambda: eng.generate(
            prompts, engine_lib.GenerateConfig(max_new_tokens=new_tokens)))
        profiled[label] = {k: prof[k] for k in (
            "wall_s", "device_busy_s", "idle_share", "launches")}
    a["generate_profile"] = profiled
    a["launches_a_token"] = (profiled["wave"]["launches"]
                             - profiled["prefill"]["launches"]) \
        / LM_PROFILE_STEPS
    # the same wave by hand: prefill, then each greedy id decoded
    toks = torch.as_tensor(np.concatenate([prompts, ids], 1), device=DEVICE)
    logits, a["prefill_s"], a["decode_ms"] = lm_steps(
        torch, task, params, toks, Lp, n - 1)
    ok["a_ids_are_the_argmax"] = bool(
        (logits.argmax(-1).cpu().numpy() == ids).all())
    ok["a_finite"] = bool(torch.isfinite(logits).all())
    a["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # B = 1, a prompt long enough for the flash path
    flash_calls = []
    real_flash = attention._sdpa_flash
    attention._sdpa_flash = lambda *args: flash_calls.append(1) or \
        real_flash(*args)
    try:
        torch.cuda.reset_peak_memory_stats()
        long = torch.as_tensor(lm_prompts(
            task.cfg, 1, LM_A["long_prompt"] + LM_A["long_steps"], 1),
            device=DEVICE)
        logits, a["long_prefill_s"], a["long_decode_ms"] = lm_steps(
            torch, task, params, long, LM_A["long_prompt"],
            LM_A["long_steps"])
    finally:
        attention._sdpa_flash = real_flash
    a["long_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    a["long_flash_calls"] = len(flash_calls)
    ok["a_long_took_the_flash_path"] = len(flash_calls) == \
        task.cfg.n_layers
    ok["a_long_finite"] = bool(torch.isfinite(logits).all())
    info["a_qwen3_4b"] = a
    print(f"lm_serving (a) {arch} on {card}: {a['params']:,} parameters, "
          f"init {init_s:.2f} s; B={B} x {Lp} prompt: prefill "
          f"{a['prefill_s']:.4f} s, decode {a['decode_ms']:.2f} ms a step, "
          f"generate {n} tokens {a['generate_s']:.3f} s "
          f"({a['tokens_per_s']:.1f} tok/s; profiled: idle share "
          f"{a['generate_profile']['wave']['idle_share']:.3f}, "
          f"{a['launches_a_token']:.0f} launches a decode step), peak "
          f"{a['peak_gb']:.2f} GB; "
          f"B=1 x {LM_A['long_prompt']}: prefill {a['long_prefill_s']:.3f} "
          f"s, decode {a['long_decode_ms']:.2f} ms a step, peak "
          f"{a['long_peak_gb']:.2f} GB", flush=True)
    del task, params, eng, logits, toks, long
    info["free_s"].append(lm_free(torch))
    part_done("a")

    # (b) gemma2-2b at full width: a prompt past the window, decode against
    # the teacher-forced forward
    arch = "gemma2-2b"
    torch.cuda.reset_peak_memory_stats()
    task, params, init_s = lm_params(torch, arch, lm_config(arch))
    b = {"params": sum(p.numel() for p in params.parameters()),
         "init_s": init_s}
    Lp, steps = LM_B["prompt"], LM_B["steps"]
    toks = torch.as_tensor(lm_prompts(task.cfg, 1, Lp + steps, 2),
                           device=DEVICE)
    got, b["prefill_s"], b["decode_ms"] = lm_steps(torch, task, params,
                                                   toks, Lp, steps)
    b["tokens_per_s"] = 1e3 / b["decode_ms"]
    want, b["forward_s"] = wall(torch, lambda: lm_forward_logits(
        torch, params, toks, steps + 1))
    b["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    b.update(lm_agreement(torch, got, want, LM_BF16_TOL))
    ok["b_decode_matches_forward"] = b["max_abs_err"] <= LM_BF16_TOL
    ok["b_ids_agree_past_tol"] = b["ids_differ_past_tol"] == 0
    ok["b_finite"] = bool(torch.isfinite(got).all())
    info["b_gemma2_2b"] = b
    print(f"lm_serving (b) {arch} on {card}: {b['params']:,} parameters; "
          f"1 x {Lp} prompt: prefill {b['prefill_s']:.3f} s, decode "
          f"{b['decode_ms']:.2f} ms a step ({b['tokens_per_s']:.1f} tok/s), "
          f"forward over {Lp + steps} {b['forward_s']:.3f} s, peak "
          f"{b['peak_gb']:.2f} GB; decode against the forward: max abs err "
          f"{b['max_abs_err']:.4g} (tolerance {LM_BF16_TOL}) on logits up "
          f"to {b['max_abs_logit']:.3g}, smallest top-2 gap "
          f"{b['min_top2_gap']:.3g}", flush=True)
    del task, params, got, want, toks
    info["free_s"].append(lm_free(torch))
    part_done("b")

    # (c) qwen3-4b at full width in fp32; the other archs at reduced width,
    # on the card and against the CPU
    arch = "qwen3-4b"
    task, params, init_s = lm_params(torch, arch,
                                     lm_config(arch, dtype=torch.float32))
    Lp, steps = LM_C["prompt"], LM_C["steps"]
    toks = torch.as_tensor(lm_prompts(task.cfg, LM_C["batch"], Lp + steps, 3),
                           device=DEVICE)
    got, _, _ = lm_steps(torch, task, params, toks, Lp, steps)
    want = lm_forward_logits(torch, params, toks, steps + 1)
    c = {"qwen3-4b_fp32": lm_agreement(torch, got, want, LM_FP32_TOL)}
    ok["c_qwen3_fp32_decode_matches_forward"] = \
        c["qwen3-4b_fp32"]["max_abs_err"] <= LM_FP32_TOL
    del task, params, got, want, toks
    info["free_s"].append(lm_free(torch))
    part_done("c_fp32")
    for arch in LM_REDUCED:
        c[arch] = lm_card_against_cpu(torch, arch)
        ok[f"c_{arch}_decode_matches_forward"] = \
            c[arch]["forward"]["max_abs_err"] <= LM_FP32_TOL
        ok[f"c_{arch}_card_matches_cpu"] = \
            c[arch]["cpu"]["max_abs_err"] <= LM_FP32_TOL
    info["c"] = c
    print(f"lm_serving (c) on {card}: decode against the forward and the "
          f"card against the CPU, max abs err (tolerance {LM_FP32_TOL}): "
          + json.dumps({k: ({"forward": v["forward"]["max_abs_err"],
                             "cpu": v["cpu"]["max_abs_err"]}
                            if "cpu" in v else v["max_abs_err"])
                        for k, v in c.items()}), flush=True)
    info["free_s"].append(lm_free(torch))
    part_done("c_reduced")
    launches = {"rank_counts": rank_topk.rank_counts.launches,
                "transe_score": ts.transe_score.launches,
                "transe_score_bwd": ts.transe_score_bwd.launches}
    # --- end ---

    # (d) the launcher, in a process of its own
    info["d_launcher"] = lm_launcher(LM_LAUNCHER, 4 * 32, ok, "lm_serving")

    part_done("d")
    info["phase_s"] = time.perf_counter() - t_phase
    info["ok"] = ok
    print(f"lm_serving took {info['phase_s']:.1f} s on {smi_line()} (by "
          f"part: {json.dumps(info['part_s'])})", flush=True)
    print("lm_serving " + json.dumps(info), flush=True)
    failed = [k for k, v in ok.items() if not v]
    if failed:
        fail(f"lm_serving checks failed: {failed}")
    for name, count in launches.items():
        if count != 0:
            fail(f"{name} launched {count} times on the LM serving path, "
                 "where no kernel lies")
    return info, launches


class MoeTap:
    """While entered, keeps every ``apply_moe`` call's routed experts
    (T, K) and keep mask (T·K,), by wrapping ``moe._route`` and
    ``moe._slots`` (looked up at call time); keeping a tensor makes no
    host sync."""

    def __init__(self, moe):
        self.moe, self.experts, self.keeps = moe, [], []

    def __enter__(self):
        route, slots = self.route, self.slots = \
            self.moe._route, self.moe._slots

        def tapped_route(*args):
            out = route(*args)
            self.experts.append(out[1])
            return out

        def tapped_slots(*args):
            out = slots(*args)
            self.keeps.append(out[2])
            return out

        self.moe._route, self.moe._slots = tapped_route, tapped_slots
        return self

    def __exit__(self, *exc):
        self.moe._route, self.moe._slots = self.route, self.slots


def moe_routed_sets(torch, experts, B, n_moe):
    """Each MoE layer's routed set at every position, (n_moe, B, L, K)
    sorted along K, from a tap's experts over one prefill and its decode
    steps (each call's (B·L_call, K) in call order, layer by layer)."""
    calls = [e.reshape(B, -1, e.shape[-1]) for e in experts]
    layers = [torch.cat(calls[i::n_moe], dim=1) for i in range(n_moe)]
    return torch.sort(torch.stack(layers), dim=-1).values


def moe_decode_against_forward(torch, moe, task, params, toks, Lp, steps,
                               tol):
    """Decode against the teacher-forced forward at a dropless capacity:
    the agreement, the positions (of all, prompt included) where some
    layer's routed set differs, and the compared positions' error where
    every layer's set agrees."""
    B = toks.shape[0]
    n_moe = sum(1 for b in params.layers if not b.kind.endswith(":dense"))
    with MoeTap(moe) as dec:
        got, _, _ = lm_steps(torch, task, params, toks, Lp, steps)
    with MoeTap(moe) as fwd:
        want = lm_forward_logits(torch, params, toks, steps + 1)
    dec_sets = moe_routed_sets(torch, dec.experts, B, n_moe)
    fwd_sets = moe_routed_sets(torch, fwd.experts, B, n_moe)
    flips = (dec_sets != fwd_sets).any(dim=-1).any(dim=0)      # (B, L)
    out = lm_agreement(torch, got, want, tol)
    agree = ~flips[:, Lp - 1:]                                  # compared
    err = (got - want).abs().amax(dim=-1)
    out["flipped_positions"] = int(flips.sum())
    out["positions"] = int(flips.numel())
    out["dropped_pairs"] = int(sum(int((~k).sum()) for k in
                                   dec.keeps + fwd.keeps))
    out["max_abs_err_where_routing_agrees"] = float(
        err[agree].max()) if bool(agree.any()) else None
    out["compared_positions_agreeing"] = int(agree.sum())
    # stricter: no flip at the position or before it
    before = ~torch.cummax(flips.int(), dim=1).values.bool()[:, Lp - 1:]
    out["max_abs_err_where_no_flip_up_to_it"] = float(
        err[before].max()) if bool(before.any()) else None
    return out


def lm_moe_path(torch):
    """LM serving for the moe family (item 15 of the module docstring).
    Returns the path's info and its launches of each kernel (none lies on
    it: 0 expected)."""
    import dataclasses

    import numpy as np

    from repro_torch.kernels import rank_topk, transe_score as ts
    from repro_torch.models import attention, moe
    from repro_torch.serve import engine as engine_lib

    t_phase = time.perf_counter()
    card = smi_line()
    info = {"card": card, "part_s": {}, "free_s": []}
    ok = {}
    marks = [t_phase]

    def part_done(label):
        """Keep the seconds since the last part ended, freeing included."""
        marks.append(time.perf_counter())
        info["part_s"][label] = marks[-1] - marks[-2]

    rank_topk.rank_counts.launches = 0          # --- LM moe serving path ---
    ts.transe_score.launches = 0
    ts.transe_score_bwd.launches = 0

    c = {}
    for part, arch, overrides in (
            ("a", "qwen2-moe-a2.7b", {}),
            ("b", "deepseek-v2-236b", {"n_layers": MOE_DEEPSEEK_LAYERS})):
        torch.cuda.reset_peak_memory_stats()
        task, params, init_s = lm_params(torch, arch,
                                         lm_config(arch, **overrides))
        cfg = task.cfg
        r = {"params": sum(p.numel() for p in params.parameters()),
             "init_s": init_s, "layers": [b.kind for b in params.layers]}
        ok[f"{part}_params"] = r["params"] == MOE_PARAMS[arch]
        if part == "b":
            ok["b_depth_cut"] = r["layers"] == ["global:dense"] + [
                "global"] * (MOE_DEEPSEEK_LAYERS - 1)
        # the serving wave, twice
        eng = engine_lib.Engine(task, params)
        B, Lp, n = MOE_A["batch"], MOE_A["prompt"], MOE_A["new"]
        prompts = lm_prompts(cfg, B, Lp, 0)
        gcfg = engine_lib.GenerateConfig(max_new_tokens=n)
        ids, r["generate_first_s"] = wall(torch, lambda: eng.generate(
            prompts, gcfg))
        again, r["generate_s"] = wall(torch, lambda: eng.generate(prompts,
                                                                  gcfg))
        r["tokens_per_s"] = B * n / r["generate_s"]
        ok[f"{part}_ids_shape"] = ids.shape == (B, n) and bool(
            ((ids >= 0) & (ids < cfg.vocab_size)).all())
        ok[f"{part}_generate_deterministic"] = bool((ids == again).all())
        profiled = {}
        for label, new_tokens in (("prefill", 1),
                                  ("wave", 1 + LM_PROFILE_STEPS)):
            prof = profile_busy(torch, lambda: eng.generate(
                prompts, engine_lib.GenerateConfig(max_new_tokens=new_tokens)))
            profiled[label] = {k: prof[k] for k in (
                "wall_s", "device_busy_s", "idle_share", "launches")}
        r["generate_profile"] = profiled
        r["launches_a_token"] = (profiled["wave"]["launches"]
                                 - profiled["prefill"]["launches"]) \
            / LM_PROFILE_STEPS
        # the same wave by hand; then its prefill again, tapped, for the
        # share of (token, expert) pairs the capacity dropped
        toks = torch.as_tensor(np.concatenate([prompts, ids], 1),
                               device=DEVICE)
        logits, r["prefill_s"], r["decode_ms"] = lm_steps(
            torch, task, params, toks, Lp, n - 1)
        ok[f"{part}_ids_are_the_argmax"] = bool(
            (logits.argmax(-1).cpu().numpy() == ids).all())
        ok[f"{part}_finite"] = bool(torch.isfinite(logits).all())
        with MoeTap(moe) as tap:
            task.prefill(params, {"tokens": toks[:, :Lp]})
        dropped = sum(int((~k).sum()) for k in tap.keeps)
        pairs = sum(k.numel() for k in tap.keeps)
        r["prefill_capacity"] = moe.capacity_of(B * Lp, cfg)
        r["prefill_mean_pairs_an_expert"] = B * Lp * cfg.top_k / \
            cfg.n_experts
        r["prefill_dropped_share"] = dropped / pairs
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del eng, logits, toks
        if part == "b":
            # B = 1, a prompt long enough for MLA's expanded path to take
            # the flash loop (once a layer)
            flash_calls = []
            real_flash = attention._sdpa_flash
            attention._sdpa_flash = lambda *args: flash_calls.append(1) or \
                real_flash(*args)
            try:
                torch.cuda.reset_peak_memory_stats()
                long = torch.as_tensor(lm_prompts(
                    cfg, 1, MOE_LONG["prompt"] + MOE_LONG["steps"], 1),
                    device=DEVICE)
                logits, r["long_prefill_s"], r["long_decode_ms"] = lm_steps(
                    torch, task, params, long, MOE_LONG["prompt"],
                    MOE_LONG["steps"])
            finally:
                attention._sdpa_flash = real_flash
            r["long_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            r["long_flash_calls"] = len(flash_calls)
            ok["b_long_took_the_flash_path"] = len(flash_calls) == \
                cfg.n_layers
            ok["b_long_finite"] = bool(torch.isfinite(logits).all())
            del logits, long
        info[part] = r
        long_text = (f"; B=1 x {MOE_LONG['prompt']}: prefill "
                     f"{r['long_prefill_s']:.3f} s ({r['long_flash_calls']} "
                     f"flash calls), decode {r['long_decode_ms']:.2f} ms a "
                     f"step, peak {r['long_peak_gb']:.2f} GB"
                     if part == "b" else "")
        print(f"lm_moe ({part}) {arch} ({cfg.n_layers} layers) on {card}: "
              f"{r['params']:,} parameters, init {init_s:.2f} s; B={B} x "
              f"{Lp} prompt: prefill {r['prefill_s']:.4f} s, decode "
              f"{r['decode_ms']:.2f} ms a step, generate {n} tokens "
              f"{r['generate_s']:.3f} s ({r['tokens_per_s']:.1f} tok/s; "
              f"profiled: idle share "
              f"{profiled['wave']['idle_share']:.3f}, "
              f"{r['launches_a_token']:.0f} launches a decode step), peak "
              f"{r['peak_gb']:.2f} GB; the prefill dropped "
              f"{r['prefill_dropped_share']:.4f} of its (token, expert) "
              f"pairs (capacity {r['prefill_capacity']} an expert, mean "
              f"{r['prefill_mean_pairs_an_expert']:.1f})" + long_text,
              flush=True)
        part_done(part)

        # (c) the same parameters at cf = E / K (dropless): decode against
        # the teacher-forced forward in fp32, and in the config's bf16
        # where every layer's routed set agrees
        dropless = cfg.n_experts / cfg.top_k
        toks = torch.as_tensor(lm_prompts(cfg, MOE_C["batch"],
                                          MOE_C["prompt"] + MOE_C["steps"],
                                          3), device=DEVICE)
        for label, dtype, tol in (("fp32", torch.float32, LM_FP32_TOL),
                                  ("bf16", cfg.dtype, LM_BF16_TOL)):
            params.cfg = dataclasses.replace(cfg, dtype=dtype,
                                             capacity_factor=dropless)
            res = moe_decode_against_forward(
                torch, moe, task, params, toks, MOE_C["prompt"],
                MOE_C["steps"], tol)
            c[f"{arch}_{label}"] = res
            if label == "fp32":
                ok[f"c_{arch}_fp32_decode_matches_forward"] = \
                    res["max_abs_err"] <= tol
            else:
                ok[f"c_{arch}_bf16_decode_matches_forward"] = \
                    res["compared_positions_agreeing"] > 0 and \
                    res["max_abs_err_where_routing_agrees"] <= tol
            ok[f"c_{arch}_{label}_dropless"] = res["dropped_pairs"] == 0
        params.cfg = cfg
        del task, params, toks
        info["free_s"].append(lm_free(torch))
        part_done(f"c_{part}")
    for arch in MOE_REDUCED:
        c[f"{arch}_reduced"] = lm_card_against_cpu(torch, arch)
        ok[f"c_{arch}_reduced_decode_matches_forward"] = \
            c[f"{arch}_reduced"]["forward"]["max_abs_err"] <= LM_FP32_TOL
        ok[f"c_{arch}_reduced_card_matches_cpu"] = \
            c[f"{arch}_reduced"]["cpu"]["max_abs_err"] <= LM_FP32_TOL
    info["c"] = c
    print(f"lm_moe (c) on {card}: decode against the forward at cf = E / K "
          f"(fp32 tolerance {LM_FP32_TOL}, bf16 {LM_BF16_TOL} where the "
          "routing agrees) and the reduced card against the CPU: "
          + json.dumps({k: {f: v[f] for f in (
              "max_abs_err", "max_abs_err_where_routing_agrees",
              "flipped_positions", "positions") if f in v}
              if "cpu" not in v else {"forward": v["forward"]["max_abs_err"],
                                      "cpu": v["cpu"]["max_abs_err"]}
              for k, v in c.items()}), flush=True)
    info["free_s"].append(lm_free(torch))
    part_done("c_reduced")
    launches = {"rank_counts": rank_topk.rank_counts.launches,
                "transe_score": ts.transe_score.launches,
                "transe_score_bwd": ts.transe_score_bwd.launches}
    # --- end ---

    # (d) the launcher at qwen2-moe-a2.7b's full width, in a process of its
    # own (after every model of this process is freed)
    info["d_launcher"] = lm_launcher(MOE_LAUNCHER, 4 * 16, ok, "lm_moe")
    part_done("d")
    info["phase_s"] = time.perf_counter() - t_phase
    info["ok"] = ok
    print(f"lm_moe took {info['phase_s']:.1f} s on {smi_line()} (by part: "
          f"{json.dumps(info['part_s'])})", flush=True)
    print("lm_moe " + json.dumps(info), flush=True)
    failed = [k for k, v in ok.items() if not v]
    if failed:
        fail(f"lm_moe checks failed: {failed}")
    for name, count in launches.items():
        if count != 0:
            fail(f"{name} launched {count} times on the LM moe serving "
                 "path, where no kernel lies")
    return info, launches



# ---------------------------------------------------------------------------
# phase 16: LM serving for the ssm and hybrid families (SSD and RG-LRU)
# ---------------------------------------------------------------------------

LM_SHAPES.update({
    "mamba2-130m": dict(n_layers=24, d_model=768, d_ff=0, vocab_size=50280,
                        pattern=("ssm",), ssm_state=128, ssm_expand=2,
                        ssm_head_dim=64, ssm_chunk=256, conv_kernel=4),
    "recurrentgemma-9b": dict(n_layers=38, d_model=4096, n_heads=16,
                              n_kv_heads=1, head_dim=256, d_ff=12288,
                              vocab_size=256000,
                              pattern=("rec", "rec", "local"), window=2048,
                              rglru_width=4096, rglru_blocks=16,
                              conv_kernel=4, embed_scale=True, act="gelu"),
})
REC_PARAMS = {"mamba2-130m": 128_983_488,
              "recurrentgemma-9b": 8_578_519_040}
REC_A = dict(batch=4, prompt=128, new=32)
# past recurrentgemma's 2,048 window and not a multiple of it; mamba2's 17
# chunks of 256, the last one padded
REC_LONG = dict(prompt=4100, steps=8)
REC_SSM_STEPS = 96          # mamba2's decode past GEN_MARGIN
REC_COMPARED = 8            # decode steps held against the forward, and
                            # timed at each end of mamba2's 96
REC_REDUCED = ("mamba2-130m", "recurrentgemma-9b")
REC_LAUNCHER = ["--arch", "mamba2-130m", "--batch", "4", "--prompt-len",
                "16", "--max-new", "16"]
# decode against the teacher-forced forward.  bf16: recurrentgemma-9b at
# LM_BF16_TOL (measured 0.1698 on logits up to 26.2, 1 x 4,100, on an
# H100); mamba2-130m at its own bound, as the reference's own bf16 decode
# differs from its forward by up to 0.47 there (full width, a 300-token
# prompt, 12 steps, on the CPU; the port's 0.467), which the SSD's
# exp(dt * A) of A down to -16 amplifies from bf16's rounding of dt
# (measured 0.5565 on logits up to 2.57, 1 x 4,100 + 96 steps, on an
# H100).  fp32: mamba2-130m at its own bound, under the reference's
# decode-against-forward bound of 2e-3 (tests/test_serve_consistency.py),
# as the SSD's cumsum-difference segment sums (the reference's form) lose
# ~1e-4 of the exponent over a 256-position chunk (measured 1.9e-4 on
# logits up to 2.69, B = 4 x 128, on an H100; the reference's own 7.6e-5
# at 300 tokens on the CPU)
REC_BF16_TOL = {"recurrentgemma-9b": LM_BF16_TOL, "mamba2-130m": 1.0}
REC_FP32_TOL = {"recurrentgemma-9b": LM_FP32_TOL, "mamba2-130m": 1e-3}


def rec_long(torch, task, params, toks, Lp, tol):
    """Prefill ``toks[:, :Lp]`` (B = 1), then decode the rest of ``toks``
    teacher-forced, synchronizing after each step; the last
    ``REC_COMPARED`` steps' logits against the forward over all of
    ``toks`` within ``tol``.  Returns the agreement, the prefill's
    seconds, each decode step's ms and the forward's seconds."""
    (caches, logits), prefill_s = wall(
        torch, lambda: task.prefill(params, {"tokens": toks[:, :Lp]}))
    out, step_ms = [], []
    for t in range(toks.shape[1] - Lp):
        t0 = time.perf_counter()
        logits, caches = task.decode_step(params, {
            "tokens": toks[:, Lp + t:Lp + t + 1], "pos": Lp + t}, caches)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits[:, 0])
    got = torch.stack(out[-REC_COMPARED:], dim=1)
    want, forward_s = wall(torch, lambda: lm_forward_logits(
        torch, params, toks, REC_COMPARED))
    agree = lm_agreement(torch, got, want, tol)
    agree["finite"] = bool(torch.isfinite(got).all())
    return agree, prefill_s, step_ms, forward_s


def lm_recurrent_path(torch):
    """LM serving for the ssm and hybrid families (item 16 of the module
    docstring).  Returns the path's info and its launches of each kernel
    (none lies on it: 0 expected)."""
    import dataclasses

    import numpy as np

    from repro_torch.kernels import rank_topk, transe_score as ts
    from repro_torch.serve import engine as engine_lib

    t_phase = time.perf_counter()
    card = smi_line()
    info = {"card": card, "part_s": {}, "free_s": []}
    ok = {}
    marks = [t_phase]

    def part_done(label):
        """Keep the seconds since the last part ended, freeing included."""
        marks.append(time.perf_counter())
        info["part_s"][label] = marks[-1] - marks[-2]

    rank_topk.rank_counts.launches = 0     # --- LM recurrent serving path ---
    ts.transe_score.launches = 0
    ts.transe_score_bwd.launches = 0

    c = {}
    for part, arch in (("a", "recurrentgemma-9b"), ("b", "mamba2-130m")):
        torch.cuda.reset_peak_memory_stats()
        task, params, init_s = lm_params(torch, arch, lm_config(arch))
        cfg = task.cfg
        r = {"params": sum(p.numel() for p in params.parameters()),
             "init_s": init_s, "layers": [b.kind for b in params.layers]}
        ok[f"{part}_params"] = r["params"] == REC_PARAMS[arch]
        ok[f"{part}_layers"] = r["layers"] == list(cfg.layer_kinds) and \
            len(r["layers"]) == cfg.n_layers
        # the serving wave, twice
        eng = engine_lib.Engine(task, params)
        B, Lp, n = REC_A["batch"], REC_A["prompt"], REC_A["new"]
        prompts = lm_prompts(cfg, B, Lp, 0)
        gcfg = engine_lib.GenerateConfig(max_new_tokens=n)
        ids, r["generate_first_s"] = wall(torch, lambda: eng.generate(
            prompts, gcfg))
        again, r["generate_s"] = wall(torch, lambda: eng.generate(prompts,
                                                                  gcfg))
        r["tokens_per_s"] = B * n / r["generate_s"]
        ok[f"{part}_ids_shape"] = ids.shape == (B, n) and bool(
            ((ids >= 0) & (ids < cfg.vocab_size)).all())
        ok[f"{part}_generate_deterministic"] = bool((ids == again).all())
        profiled = {}
        for label, new_tokens in (("prefill", 1),
                                  ("wave", 1 + LM_PROFILE_STEPS)):
            prof = profile_busy(torch, lambda: eng.generate(
                prompts, engine_lib.GenerateConfig(max_new_tokens=new_tokens)))
            profiled[label] = {k: prof[k] for k in (
                "wall_s", "device_busy_s", "idle_share", "launches", "top")}
        r["generate_profile"] = profiled
        r["launches_a_token"] = (profiled["wave"]["launches"]
                                 - profiled["prefill"]["launches"]) \
            / LM_PROFILE_STEPS
        # the same wave by hand
        toks = torch.as_tensor(np.concatenate([prompts, ids], 1),
                               device=DEVICE)
        logits, r["prefill_s"], r["decode_ms"] = lm_steps(
            torch, task, params, toks, Lp, n - 1)
        ok[f"{part}_ids_are_the_argmax"] = bool(
            (logits.argmax(-1).cpu().numpy() == ids).all())
        ok[f"{part}_finite"] = bool(torch.isfinite(logits).all())
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del eng, logits
        # B = 1, a prompt past the window (the RG-LRU scan over all of
        # it; mamba2's last chunk padded), then decode against the
        # teacher-forced forward; mamba2 decodes past GEN_MARGIN
        torch.cuda.reset_peak_memory_stats()
        Ll = REC_LONG["prompt"]
        steps = REC_SSM_STEPS if part == "b" else REC_LONG["steps"]
        long = torch.as_tensor(lm_prompts(cfg, 1, Ll + steps, 1),
                               device=DEVICE)
        r["long"], r["long_prefill_s"], step_ms, r["forward_s"] = rec_long(
            torch, task, params, long, Ll, REC_BF16_TOL[arch])
        r["long_decode_ms"] = sum(step_ms) / len(step_ms)
        r["long_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        ok[f"{part}_long_decode_matches_forward"] = \
            r["long"]["max_abs_err"] <= REC_BF16_TOL[arch]
        ok[f"{part}_long_ids_agree_past_tol"] = \
            r["long"]["ids_differ_past_tol"] == 0
        ok[f"{part}_long_finite"] = r["long"]["finite"]
        tail = ""
        if part == "b":
            first = step_ms[:REC_COMPARED]
            last = step_ms[-REC_COMPARED:]
            r["decode_ms_first"] = sum(first) / len(first)
            r["decode_ms_last"] = sum(last) / len(last)
            r["decode_last_over_first"] = r["decode_ms_last"] / \
                r["decode_ms_first"]
            r["long_step_ms"] = step_ms
            ok["b_decoded_past_gen_margin"] = steps > task.GEN_MARGIN + 1
            tail = (f"; {steps} decode steps: steps 1-{REC_COMPARED} "
                    f"{r['decode_ms_first']:.2f} ms, steps "
                    f"{steps - REC_COMPARED + 1}-{steps} "
                    f"{r['decode_ms_last']:.2f} ms a step (ratio "
                    f"{r['decode_last_over_first']:.3f})")
        info[part] = r
        print(f"lm_recurrent ({part}) {arch} on {card}: {r['params']:,} "
              f"parameters ({cfg.n_layers} layers), init {init_s:.2f} s; "
              f"B={B} x {Lp} prompt: prefill {r['prefill_s']:.4f} s, decode "
              f"{r['decode_ms']:.2f} ms a step, generate {n} tokens "
              f"{r['generate_s']:.3f} s ({r['tokens_per_s']:.1f} tok/s; "
              f"profiled: idle share {profiled['wave']['idle_share']:.3f}, "
              f"{r['launches_a_token']:.0f} launches a decode step), peak "
              f"{r['peak_gb']:.2f} GB; 1 x {Ll}: prefill "
              f"{r['long_prefill_s']:.3f} s, decode "
              f"{r['long_decode_ms']:.2f} ms a step, forward over "
              f"{Ll + steps} {r['forward_s']:.3f} s, peak "
              f"{r['long_peak_gb']:.2f} GB; the last {REC_COMPARED} steps "
              f"against the forward: max abs err "
              f"{r['long']['max_abs_err']:.4g} (tolerance "
              f"{REC_BF16_TOL[arch]}) on logits up to "
              f"{r['long']['max_abs_logit']:.3g}" + tail, flush=True)
        part_done(part)

        # (c) the same parameters with fp32 activations: the wave's
        # prefill and decode steps, and the long prompt's last steps,
        # against the teacher-forced forward
        tol = REC_FP32_TOL[arch]
        params.cfg = dataclasses.replace(cfg, dtype=torch.float32)
        wave = toks[:, :Lp + REC_COMPARED]
        got, _, _ = lm_steps(torch, task, params, wave, Lp, REC_COMPARED)
        want = lm_forward_logits(torch, params, wave, REC_COMPARED + 1)
        c[f"{arch}_fp32"] = lm_agreement(torch, got, want, tol)
        c[f"{arch}_fp32_long"] = rec_long(torch, task, params, long, Ll,
                                          tol)[0]
        for key in ("fp32", "fp32_long"):
            ok[f"c_{arch}_{key}_decode_matches_forward"] = \
                c[f"{arch}_{key}"]["max_abs_err"] <= tol
        params.cfg = cfg
        del task, params, toks, wave, long, got, want
        info["free_s"].append(lm_free(torch))
        part_done(f"c_{part}")
    for arch in REC_REDUCED:
        c[f"{arch}_reduced"] = lm_card_against_cpu(torch, arch)
        ok[f"c_{arch}_reduced_decode_matches_forward"] = \
            c[f"{arch}_reduced"]["forward"]["max_abs_err"] <= LM_FP32_TOL
        ok[f"c_{arch}_reduced_card_matches_cpu"] = \
            c[f"{arch}_reduced"]["cpu"]["max_abs_err"] <= LM_FP32_TOL
    info["c"] = c
    print(f"lm_recurrent (c) on {card}: fp32 decode against the forward "
          f"(B={REC_A['batch']} x {REC_A['prompt']} and 1 x {Ll}, the last "
          f"{REC_COMPARED} steps; tolerance {json.dumps(REC_FP32_TOL)}) and "
          f"the reduced card against the CPU ({LM_FP32_TOL}), max abs err: "
          + json.dumps({k: ({"forward": v["forward"]["max_abs_err"],
                             "cpu": v["cpu"]["max_abs_err"]}
                            if "cpu" in v else
                            {"max_abs_err": v["max_abs_err"],
                             "max_abs_logit": v["max_abs_logit"]})
                        for k, v in c.items()}), flush=True)
    info["free_s"].append(lm_free(torch))
    part_done("c_reduced")
    launches = {"rank_counts": rank_topk.rank_counts.launches,
                "transe_score": ts.transe_score.launches,
                "transe_score_bwd": ts.transe_score_bwd.launches}
    # --- end ---

    # (d) the launcher at mamba2-130m's full width, in a process of its own
    info["d_launcher"] = lm_launcher(REC_LAUNCHER, 4 * 16, ok,
                                     "lm_recurrent")
    part_done("d")
    info["phase_s"] = time.perf_counter() - t_phase
    info["ok"] = ok
    print(f"lm_recurrent took {info['phase_s']:.1f} s on {smi_line()} (by "
          f"part: {json.dumps(info['part_s'])})", flush=True)
    print("lm_recurrent " + json.dumps(info), flush=True)
    failed = [k for k, v in ok.items() if not v]
    if failed:
        fail(f"lm_recurrent checks failed: {failed}")
    for name, count in launches.items():
        if count != 0:
            fail(f"{name} launched {count} times on the LM recurrent "
                 "serving path, where no kernel lies")
    return info, launches


# ---------------------------------------------------------------------------
# phase 17: LM serving for the encoder-decoder (whisper-base)
# ---------------------------------------------------------------------------

LM_SHAPES.update({
    "whisper-base": dict(n_layers=6, n_encoder_layers=6, d_model=512,
                         n_heads=8, d_ff=2048, vocab_size=51865,
                         decoder_len=448),
    "smollm-135m": dict(n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
                        d_ff=1536, vocab_size=49152),
})
ENC_PARAMS = 70_627_840
ENC_FRAMES = 1500           # whisper's 30 s window after the conv stub
ENC_A = dict(batch=4, prompt=16, new=32)
# 384 + 64 = decoder_len: the prompt and the decode steps fill the self-KV
# cache (L + GEN_MARGIN slots) exactly, and one step more raises
ENC_LONG = dict(prompt=384, steps=64)
ENC_LAUNCHER = ["--arch", "whisper-base", "--batch", "4", "--prompt-len",
                "16", "--max-new", "16"]


def start_lm_launchers():
    """Start phase 17's serve launcher, phase 18's train launcher and phase
    19's two production dry-runs, once for all three phases, each in a
    process of its own: they run beside the phases' in-process parts, and
    each phase joins its own.  Returns ``{"serve": started, "train":
    started, "dryrun16": started, "dryrun2x16": started, "dryrun_dir":
    the dry-runs' output directory}``."""
    if not _LM_LAUNCHERS:
        import atexit
        import shutil

        logdir = tempfile.mkdtemp(prefix="chip_smoke_lm_")
        records = os.path.join(logdir, "dryrun")
        _LM_LAUNCHERS["dryrun_dir"] = records
        # the dry-runs see no card (CUDA_VISIBLE_DEVICES empty)
        dryrun = ["env", "CUDA_VISIBLE_DEVICES=", sys.executable, "-m",
                  "repro_torch.launch.dryrun", "--arch", "smollm-135m",
                  "--shape", "train_4k", "--out", records]
        for label, argv in (
                ("serve", [sys.executable, "-m", "repro_torch.launch.serve"]
                 + ENC_LAUNCHER),
                ("train", [sys.executable, "-m", "repro_torch.launch.train"]
                 + TRAIN_LAUNCHER),
                ("dryrun16", dryrun),
                ("dryrun2x16", dryrun + ["--multi-pod"])):
            _LM_LAUNCHERS[label] = _start([(label, argv)], logdir)
        # a phase that fails before joining its launcher leaves none
        # running
        atexit.register(lambda: [_join(started, 0) for label, started in
                                 _LM_LAUNCHERS.items()
                                 if label != "dryrun_dir"
                                 and started[1][0][2].poll() is None])
        atexit.register(shutil.rmtree, logdir, True)
    return _LM_LAUNCHERS


_LM_LAUNCHERS = {}


def encdec_frames(torch, cfg, B, seed, frames=None):
    """Seeded standard-normal post-conv frames (B, frames, d) on the card
    (``ENC_FRAMES`` of them by default)."""
    frames = ENC_FRAMES if frames is None else frames
    return torch.randn((B, frames, cfg.d_model), device=DEVICE,
                       generator=torch.Generator(device=DEVICE).manual_seed(
                           seed))


def encdec_steps(torch, task, params, frames, toks, Lp, steps):
    """Prefill ``toks[:, :Lp]`` against ``frames``, then decode ``steps``
    tokens teacher-forced, synchronizing after each: the logits of every
    call (B, steps + 1, V), the prefill's seconds, each step's ms and the
    caches."""
    (caches, logits), prefill_s = wall(torch, lambda: task.prefill(
        params, {"frames": frames, "tokens": toks[:, :Lp]}))
    out, step_ms = [logits[:, 0]], []
    for t in range(steps):
        t0 = time.perf_counter()
        logits, caches = task.decode_step(params, {
            "tokens": toks[:, Lp + t:Lp + t + 1], "pos": Lp + t}, caches)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits[:, 0])
    return torch.stack(out, dim=1), prefill_s, step_ms, caches


def encdec_forward_logits(torch, params, frames, toks, last):
    """The teacher-forced forward over ``toks`` against ``frames``: logits
    at the last ``last`` positions (B, last, V)."""
    B, L = toks.shape
    positions = torch.arange(L, dtype=torch.int32, device=DEVICE)[
        None].expand(B, L)
    with torch.no_grad():
        memory = params.encode(frames)
        hidden, _ = params.decode_stack(toks, positions, memory)
        return params.logits(hidden[:, -last:])


def encdec_card_against_cpu(torch):
    """whisper-base at reduced width on the card: decode against its
    teacher-forced forward, and against the same parameters' decode on
    the CPU (``LM_REDUCED_RUN``'s wave over 64 frames)."""
    from repro_torch.models.encdec import EncDecLM

    R = LM_REDUCED_RUN
    cfg = lm_config("whisper-base").reduced()
    task, params, _ = lm_params(torch, "whisper-base", cfg, published=False)
    frames = encdec_frames(torch, cfg, R["batch"], 4, frames=64)
    toks = torch.as_tensor(lm_prompts(cfg, R["batch"],
                                      R["prompt"] + R["steps"], 4),
                           device=DEVICE)
    got, _, _, _ = encdec_steps(torch, task, params, frames, toks,
                                R["prompt"], R["steps"])
    want = encdec_forward_logits(torch, params, frames, toks,
                                 R["steps"] + 1)
    host = EncDecLM(cfg, "cpu")
    host.load_state_dict({k: v.cpu() for k, v in
                          params.state_dict().items()})
    on_host, _, _, _ = encdec_steps(torch, type(task)(cfg, "cpu"), host,
                                    frames.cpu(), toks.cpu(), R["prompt"],
                                    R["steps"])
    return {"forward": lm_agreement(torch, got, want, LM_FP32_TOL),
            "cpu": lm_agreement(torch, got.cpu(), on_host, LM_FP32_TOL)}


def lm_encdec_path(torch):
    """LM serving for the encoder-decoder (item 17 of the module
    docstring).  Returns the path's info and its launches of each kernel
    (none lies on it: 0 expected)."""
    import dataclasses

    import numpy as np

    from repro_torch.kernels import rank_topk, transe_score as ts
    from repro_torch.serve import engine as engine_lib

    arch = "whisper-base"
    t_phase = time.perf_counter()
    card = smi_line()
    info = {"card": card, "part_s": {}, "free_s": []}
    ok = {}
    marks = [t_phase]

    def part_done(label):
        """Keep the seconds since the last part ended, freeing included."""
        marks.append(time.perf_counter())
        info["part_s"][label] = marks[-1] - marks[-2]

    launchers = start_lm_launchers()
    rank_topk.rank_counts.launches = 0     # --- LM encoder-decoder path ---
    ts.transe_score.launches = 0
    ts.transe_score_bwd.launches = 0

    # (a) the serving wave at full width and depth
    torch.cuda.reset_peak_memory_stats()
    task, params, init_s = lm_params(torch, arch, lm_config(arch))
    cfg = task.cfg
    a = {"params": sum(p.numel() for p in params.parameters()),
         "init_s": init_s, "layers": [len(params.enc), len(params.dec)]}
    ok["a_params"] = a["params"] == ENC_PARAMS
    ok["a_layers"] = a["layers"] == [cfg.n_encoder_layers, cfg.n_layers]
    B, Lp, n = ENC_A["batch"], ENC_A["prompt"], ENC_A["new"]
    frames = encdec_frames(torch, cfg, B, 2)
    with torch.no_grad():
        memory, a["encode_s"] = wall(torch, lambda: params.encode(frames))
    ok["a_encoder_output"] = tuple(memory.shape) == (
        B, ENC_FRAMES, cfg.d_model) and memory.dtype == cfg.dtype and \
        bool(torch.isfinite(memory).all())
    del memory
    eng = engine_lib.Engine(task, params)
    prompts = lm_prompts(cfg, B, Lp, 0)
    extra = {"frames": frames}
    gcfg = engine_lib.GenerateConfig(max_new_tokens=n)
    ids, a["generate_first_s"] = wall(torch, lambda: eng.generate(
        prompts, gcfg, extra_batch=extra))
    again, a["generate_s"] = wall(torch, lambda: eng.generate(
        prompts, gcfg, extra_batch=extra))
    a["tokens_per_s"] = B * n / a["generate_s"]
    ok["a_ids_shape"] = ids.shape == (B, n) and bool(
        ((ids >= 0) & (ids < cfg.vocab_size)).all())
    ok["a_generate_deterministic"] = bool((ids == again).all())
    profiled = {}
    for label, new_tokens in (("prefill", 1), ("wave", 1 + LM_PROFILE_STEPS)):
        prof = profile_busy(torch, lambda: eng.generate(
            prompts, engine_lib.GenerateConfig(max_new_tokens=new_tokens),
            extra_batch=extra))
        profiled[label] = {k: prof[k] for k in (
            "wall_s", "device_busy_s", "idle_share", "launches", "top")}
    a["generate_profile"] = profiled
    a["launches_a_token"] = (profiled["wave"]["launches"]
                             - profiled["prefill"]["launches"]) \
        / LM_PROFILE_STEPS
    # the same wave by hand, and against the teacher-forced forward
    toks = torch.as_tensor(np.concatenate([prompts, ids], 1), device=DEVICE)
    logits, a["prefill_s"], step_ms, _ = encdec_steps(
        torch, task, params, frames, toks, Lp, n - 1)
    a["decode_ms"] = sum(step_ms) / len(step_ms)
    ok["a_ids_are_the_argmax"] = bool(
        (logits.argmax(-1).cpu().numpy() == ids).all())
    ok["a_finite"] = bool(torch.isfinite(logits).all())
    a["bf16"] = lm_agreement(torch, logits, encdec_forward_logits(
        torch, params, frames, toks[:, :Lp + n - 1], n), LM_BF16_TOL)
    ok["a_decode_matches_forward"] = a["bf16"]["max_abs_err"] <= LM_BF16_TOL
    ok["a_ids_agree_past_tol"] = a["bf16"]["ids_differ_past_tol"] == 0
    a["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del eng, logits
    info["a"] = a
    print(f"lm_encdec (a) {arch} on {card}: {a['params']:,} parameters "
          f"({cfg.n_encoder_layers} + {cfg.n_layers} layers), init "
          f"{init_s:.2f} s; B={B} x {ENC_FRAMES} frames: encode "
          f"{a['encode_s']:.4f} s; {Lp}-token prompts: prefill "
          f"{a['prefill_s']:.4f} s, decode {a['decode_ms']:.2f} ms a step, "
          f"generate {n} tokens {a['generate_s']:.3f} s "
          f"({a['tokens_per_s']:.1f} tok/s; profiled: idle share "
          f"{profiled['wave']['idle_share']:.3f}, "
          f"{a['launches_a_token']:.0f} launches a decode step), peak "
          f"{a['peak_gb']:.2f} GB; decode against the forward: max abs err "
          f"{a['bf16']['max_abs_err']:.4g} (tolerance {LM_BF16_TOL}) on "
          f"logits up to {a['bf16']['max_abs_logit']:.3g}", flush=True)
    part_done("a")

    # (b) B = 1: a prompt and decode steps that fill decoder_len; one more
    # step raises
    torch.cuda.reset_peak_memory_stats()
    Ll, steps = ENC_LONG["prompt"], ENC_LONG["steps"]
    long = torch.as_tensor(lm_prompts(cfg, 1, Ll + steps + 1, 1),
                           device=DEVICE)
    f1 = encdec_frames(torch, cfg, 1, 3)
    logits, b_prefill_s, step_ms, caches = encdec_steps(
        torch, task, params, f1, long, Ll, steps)
    b = {"prefill_s": b_prefill_s, "decode_ms": sum(step_ms) / steps,
         "cache_slots": caches[0].self_kv.k.shape[1]}
    ok["b_fills_decoder_len"] = Ll + steps == cfg.decoder_len == \
        b["cache_slots"] == Ll + task.GEN_MARGIN
    try:
        task.decode_step(params, {"tokens": long[:, -1:], "pos": Ll + steps},
                         caches)
        ok["b_step_past_the_cache_raises"] = False
    except ValueError as e:
        ok["b_step_past_the_cache_raises"] = "GEN_MARGIN" in str(e)
    b["bf16"] = lm_agreement(torch, logits[:, -REC_COMPARED:],
                             encdec_forward_logits(
                                 torch, params, f1, long[:, :Ll + steps],
                                 REC_COMPARED), LM_BF16_TOL)
    b["bf16"]["finite"] = bool(torch.isfinite(logits).all())
    ok["b_decode_matches_forward"] = b["bf16"]["max_abs_err"] <= LM_BF16_TOL
    ok["b_ids_agree_past_tol"] = b["bf16"]["ids_differ_past_tol"] == 0
    ok["b_finite"] = b["bf16"]["finite"]
    b["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    info["b"] = b
    print(f"lm_encdec (b) on {card}: 1 x {Ll} prompt: prefill "
          f"{b['prefill_s']:.4f} s, {steps} decode steps "
          f"{b['decode_ms']:.2f} ms a step into {b['cache_slots']} slots "
          f"(step {steps + 1} raises: "
          f"{ok['b_step_past_the_cache_raises']}), peak {b['peak_gb']:.2f} "
          f"GB; the last {REC_COMPARED} steps against the forward: max abs "
          f"err {b['bf16']['max_abs_err']:.4g} on logits up to "
          f"{b['bf16']['max_abs_logit']:.3g}", flush=True)
    part_done("b")

    # (c) fp32 activations: the wave's prefill and 8 decode steps, and the
    # long prompt's first 8, against the forward; then reduced width on
    # the card against the CPU
    c = {}
    params.cfg = dataclasses.replace(cfg, dtype=torch.float32)
    for key, f, t, L0 in (("wave", frames, toks, Lp), ("long", f1, long, Ll)):
        got, _, _, _ = encdec_steps(torch, task, params, f,
                                    t[:, :L0 + REC_COMPARED], L0,
                                    REC_COMPARED)
        want = encdec_forward_logits(torch, params, f,
                                     t[:, :L0 + REC_COMPARED],
                                     REC_COMPARED + 1)
        c[f"fp32_{key}"] = lm_agreement(torch, got, want, LM_FP32_TOL)
        ok[f"c_fp32_{key}_decode_matches_forward"] = \
            c[f"fp32_{key}"]["max_abs_err"] <= LM_FP32_TOL
    params.cfg = cfg
    del task, params, toks, long, frames, f1, caches, got, want
    info["free_s"].append(lm_free(torch))
    c["reduced"] = encdec_card_against_cpu(torch)
    ok["c_reduced_decode_matches_forward"] = \
        c["reduced"]["forward"]["max_abs_err"] <= LM_FP32_TOL
    ok["c_reduced_card_matches_cpu"] = \
        c["reduced"]["cpu"]["max_abs_err"] <= LM_FP32_TOL
    info["c"] = c
    print(f"lm_encdec (c) on {card}: fp32 decode against the forward (B={B}"
          f" x {Lp} and 1 x {Ll}, {REC_COMPARED} steps) and the reduced "
          f"card against the CPU, tolerance {LM_FP32_TOL}, max abs err: "
          + json.dumps({"wave": c["fp32_wave"]["max_abs_err"],
                        "long": c["fp32_long"]["max_abs_err"],
                        "reduced_forward":
                            c["reduced"]["forward"]["max_abs_err"],
                        "reduced_cpu": c["reduced"]["cpu"]["max_abs_err"]}),
          flush=True)
    info["free_s"].append(lm_free(torch))
    part_done("c")
    launches = {"rank_counts": rank_topk.rank_counts.launches,
                "transe_score": ts.transe_score.launches,
                "transe_score_bwd": ts.transe_score_bwd.launches}
    # --- end ---

    # (d) the serve launcher at whisper-base's full width, in a process of
    # its own (started with the phase)
    info["d_launcher"] = lm_launcher(ENC_LAUNCHER, 4 * 16, ok, "lm_encdec",
                                     launchers["serve"])
    part_done("d")
    info["phase_s"] = time.perf_counter() - t_phase
    info["ok"] = ok
    print(f"lm_encdec took {info['phase_s']:.1f} s on {smi_line()} (by "
          f"part: {json.dumps(info['part_s'])})", flush=True)
    print("lm_encdec " + json.dumps(info), flush=True)
    failed = [k for k, v in ok.items() if not v]
    if failed:
        fail(f"lm_encdec checks failed: {failed}")
    for name, count in launches.items():
        if count != 0:
            fail(f"{name} launched {count} times on the LM encoder-decoder "
                 "path, where no kernel lies")
    return info, launches


# ---------------------------------------------------------------------------
# phase 18: LM training (smollm-135m and whisper-base)
# ---------------------------------------------------------------------------

TRAIN_LM = dict(batch=8, seq=512, steps=16)
# adamw at the launcher's defaults (warmup steps // 20, cosine decay over
# the run) but --lr 1e-3: at the default 3e-3 the loss at smollm's full
# width rises from step 5 and stays above its start for 32 steps, in the
# reference too; at 1e-3 the mean of the last 4 of 16 steps lay 0.0127
# below the first 4's (10.8977 against 10.9104) on an H100 80GB HBM3 at
# 700 W (tools/lm_lr_probe.py; PERF.md §6)
TRAIN_LR = 1e-3
TRAIN_RESUME_AT = 4         # the checkpoint a resumed run starts from
TRAIN_FAIL_AT = 6           # the step whose batch the injector fails
TRAIN_ENC = dict(batch=4, tokens=448)
TRAIN_LAUNCHER = ["--arch", "smollm-135m", "--steps", "4"]
TRAIN_LAUNCHER_S = 180
# a resumed run against the uninterrupted one, where not bitwise: the
# reference's own tolerance (tests/test_fault_tolerance.py)
TRAIN_RESUME_TOL = dict(rtol=1e-6, atol=1e-7)
# microbatches=2 against 1 in fp32: the loss, and each gradient relative
# to its largest entry (TF32 off)
TRAIN_MB_TOL = 1e-4


def train_launcher(ok):
    """``python -m repro_torch.launch.train`` on ``TRAIN_LAUNCHER`` in a
    process of its own (started with phase 17, else now), joined: its
    exit code, seconds and last line, checked into ``ok`` (the
    reference's ``final loss: X (start Y)``)."""
    import re

    rc, out, seconds = _join(start_lm_launchers()["train"],
                             TRAIN_LAUNCHER_S)["train"]
    lines = out.strip().splitlines()
    last = lines[-1] if lines else ""
    ok["c_launcher_exit_0"] = rc == 0
    ok["c_launcher_line"] = bool(re.match(
        r"^final loss: \d+\.\d{4} \(start \d+\.\d{4}\)$", last))
    if rc != 0:
        print(out[-4000:], flush=True)
    print(f"lm_train (c) python -m repro_torch.launch.train "
          f"{' '.join(TRAIN_LAUNCHER)}: exit {rc} in {seconds:.1f} s: "
          f"{last!r}", flush=True)
    return {"rc": rc, "seconds": seconds, "lines": lines[-3:]}


def same_params(torch, a, b):
    """Max abs difference of two named-parameter dicts, and whether they
    are the same bits."""
    err = max(float((a[k].float().cpu() - b[k].float().cpu()).abs().max())
              for k in a)
    return {"max_abs_err": err,
            "bitwise": all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a),
            "within_tol": all(torch.allclose(a[k].float().cpu(),
                                             b[k].float().cpu(),
                                             **TRAIN_RESUME_TOL) for k in a)}


def lm_train_path(torch):
    """LM training (item 18 of the module docstring).  Returns the path's
    info and its launches of each kernel (none lies on it: 0 expected)."""
    import dataclasses

    import numpy as np

    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import rank_topk, transe_score as ts
    from repro_torch.models import registry
    from repro_torch.train import ft, loop, losses
    from repro_torch.train import optimizer as opt_lib

    t_phase = time.perf_counter()
    card = smi_line()
    info = {"card": card, "part_s": {}, "free_s": []}
    ok = {}
    marks = [t_phase]

    def part_done(label):
        """Keep the seconds since the last part ended, freeing included."""
        marks.append(time.perf_counter())
        info["part_s"][label] = marks[-1] - marks[-2]

    rank_topk.rank_counts.launches = 0     # --- LM training path ---
    ts.transe_score.launches = 0
    ts.transe_score_bwd.launches = 0

    # (a) smollm-135m at full width and depth through Trainer on the
    # token pipeline, adamw at the launcher's defaults (but TRAIN_LR) for
    # 16 steps
    arch = "smollm-135m"
    cfg = lm_config(arch)
    task, params, _ = lm_params(torch, arch, cfg)
    del params
    Bt, Lt, steps = TRAIN_LM["batch"], TRAIN_LM["seq"], TRAIN_LM["steps"]
    opt_cfg = opt_lib.OptConfig(name="adamw", learning_rate=TRAIN_LR,
                                warmup_steps=max(steps // 20, 1),
                                decay_steps=steps)

    def trainer(n, d, ckpt_every):
        # decay_steps stays the 16-step run's, so a shorter run is the
        # first n steps of that run
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=Lt, global_batch=Bt, seed=0))
        return loop.Trainer(task, pipe, opt_cfg, loop.TrainConfig(
            steps=n, log_every=0, ckpt_every=ckpt_every, ckpt_dir=d))

    a = {}
    # the 16-step run: its loss checked to fall
    torch.cuda.reset_peak_memory_stats()
    full = trainer(steps, None, 0)
    (params, state), a["run_s"] = wall(
        torch, lambda: full.run(seed=0, resume=False))
    a["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    h = full.history
    a["history"] = h
    a["loss_first4"] = float(np.mean(h[:4]))
    a["loss_last4"] = float(np.mean(h[-4:]))
    ok["a_loss_finite"] = bool(np.isfinite(h).all())
    ok["a_loss_fell"] = a["loss_last4"] < a["loss_first4"]
    # one more step, profiled, and two timed
    step_fn = full.step_fn
    batch = full.pipeline.batch(steps)
    prof = profile_busy(torch, lambda: step_fn(params, state, batch))
    a["step_profile"] = {k: prof[k] for k in (
        "wall_s", "device_busy_s", "idle_share", "launches", "top")}
    _, two_s = wall(torch, lambda: [step_fn(params, state, batch)
                                    for _ in range(2)])
    a["step_s"] = two_s / 2
    a["tokens_per_s"] = Bt * Lt / a["step_s"]
    # chunked cross entropy against the full one: peak memory of a
    # forward and backward at this shape (ce_chunk 1,024 >= L is one
    # chunk, recomputed in the backward), and at a 128-token chunk
    a["ce_peak_gb"] = {}
    chunked = losses.chunked_cross_entropy
    for label, t, fn in (
            ("chunked", task, chunked),
            ("chunk128", registry.make_task(
                dataclasses.replace(cfg, ce_chunk=128), DEVICE), chunked),
            ("full", task, lambda hh, y, u, chunk:
                losses.full_cross_entropy(hh, y, u))):
        losses.chunked_cross_entropy = fn
        try:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loop.value_and_grad(t, params, batch)
            torch.cuda.synchronize()
            a["ce_peak_gb"][label] = (torch.cuda.max_memory_allocated()
                                      - base) / 1e9
        finally:
            losses.chunked_cross_entropy = chunked
    del params, state, step_fn
    info["free_s"].append(lm_free(torch))
    # 8 steps uninterrupted, against 4 steps and a checkpoint, a failure
    # injected at step 4 and a fresh Trainer resumed from that checkpoint
    # to 8 (ft.run_with_recovery)
    at = TRAIN_RESUME_AT
    unbroken = trainer(2 * at, None, 0)
    p_u, _ = unbroken.run(seed=0, resume=False)
    p_u = {k: v.clone() for k, v in loop.named_params(p_u).items()}
    injector = ft.FailureInjector(fail_at=(at,))
    tries, restarts = [], []
    with tempfile.TemporaryDirectory() as tmp:
        def make_loop():
            tr = trainer(2 * at, tmp, at)
            tries.append(tr)
            batch_of = tr.pipeline.batch

            def batch_fn(step):
                injector.maybe_fail(step)
                return batch_of(step)

            tr.pipeline.batch = batch_fn
            return lambda: tr.run(seed=0)

        (p_f, _), a["recovery_s"] = wall(torch, lambda: ft.run_with_recovery(
            make_loop, max_restarts=2,
            on_restart=lambda n, e: restarts.append(str(e))))
    a["restarts"] = restarts
    a["tries_steps"] = [len(t.history) for t in tries]
    ok["a_recovered_once"] = len(restarts) == 1 and \
        "injected failure" in restarts[0]
    ok["a_resumed_from_step_4"] = a["tries_steps"] == [at, at]
    ok["a_resumed_losses_equal"] = tries[-1].history == \
        unbroken.history[at:] == h[at:2 * at]
    a["resume"] = same_params(torch, loop.named_params(p_f), p_u)
    ok["a_resume_equals_uninterrupted"] = a["resume"]["within_tol"]
    info["a"] = a
    print(f"lm_train (a) {arch} on {card}: B={Bt} x {Lt}, adamw, {steps} "
          f"steps in {a['run_s']:.2f} s; "
          f"a step {a['step_s']:.4f} s ({a['tokens_per_s']:.0f} tok/s; "
          f"profiled: idle share {a['step_profile']['idle_share']:.3f}, "
          f"{a['step_profile']['launches']} launches), peak "
          f"{a['peak_gb']:.2f} GB; loss {h[0]:.4f} -> {h[-1]:.4f} (mean of "
          f"the first 4 {a['loss_first4']:.4f}, the last 4 "
          f"{a['loss_last4']:.4f}); a forward and backward's peak over the "
          f"parameters: " + json.dumps(a["ce_peak_gb"]) + f"; "
          f"{len(restarts)} restart(s) after a failure at step {at}, the "
          f"tries' steps {a['tries_steps']}, in {a['recovery_s']:.2f} s; "
          f"resumed against uninterrupted at step {2 * at}: "
          + json.dumps(a["resume"]), flush=True)
    del task, full, unbroken, tries, p_u, p_f
    info["free_s"].append(lm_free(torch))
    part_done("a")

    # (b) whisper-base at full width: a step of make_train_step on
    # EncDecTask.loss (1,500 frames, 448 tokens, B = 4, train_microbatches
    # 2), then microbatches 2 against 1 on the same batch in fp32
    arch = "whisper-base"
    cfg = lm_config(arch)
    torch.cuda.reset_peak_memory_stats()
    task, params, _ = lm_params(torch, arch, cfg)
    B, L = TRAIN_ENC["batch"], TRAIN_ENC["tokens"]
    batch = {"frames": encdec_frames(torch, cfg, B, 5),
             "tokens": torch.as_tensor(lm_prompts(cfg, B, L, 5),
                                       device=DEVICE)}
    b = {"microbatches": cfg.train_microbatches}
    step_fn = loop.make_train_step(task, opt_lib.OptConfig(name="adamw"),
                                   cfg.train_microbatches)
    state = opt_lib.init(loop.named_params(params),
                         opt_lib.OptConfig(name="adamw"))
    (_, state, m), b["first_step_s"] = wall(
        torch, lambda: step_fn(params, state, batch))
    prof = profile_busy(torch, lambda: step_fn(params, state, batch))
    b["step_profile"] = {k: prof[k] for k in (
        "wall_s", "device_busy_s", "idle_share", "launches", "top")}
    _, b["step_s"] = wall(torch, lambda: step_fn(params, state, batch))
    b["tokens_per_s"] = B * L / b["step_s"]
    b["loss"] = float(m["loss"])
    b["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    ok["b_loss_finite"] = bool(np.isfinite(b["loss"]))
    params.cfg = dataclasses.replace(cfg, dtype=torch.float32)
    l1, g1 = loop.loss_and_grads(task, params, batch, 1)
    l2, g2 = loop.loss_and_grads(task, params, batch, cfg.train_microbatches)
    params.cfg = cfg
    b["fp32_loss"] = [float(l1), float(l2)]
    b["zero_or_nonfinite_grads"] = [
        k for k, g in g1.items()
        if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0]
    ok["b_every_grad_finite_nonzero"] = not b["zero_or_nonfinite_grads"] \
        and len(g1) == sum(1 for _ in params.parameters())
    b["mb_loss_err"] = abs(float(l2) - float(l1))
    b["mb_grad_rel_err"] = max(
        float((g2[k] - g1[k]).abs().max() / g1[k].abs().max()) for k in g1)
    ok["b_microbatches_match"] = b["mb_loss_err"] <= TRAIN_MB_TOL and \
        b["mb_grad_rel_err"] <= TRAIN_MB_TOL
    info["b"] = b
    print(f"lm_train (b) {arch} on {card}: B={B} x {ENC_FRAMES} frames x "
          f"{L} tokens, microbatches {b['microbatches']}: a step "
          f"{b['step_s']:.4f} s ({b['tokens_per_s']:.0f} tok/s; first "
          f"{b['first_step_s']:.3f} s; profiled: idle share "
          f"{b['step_profile']['idle_share']:.3f}, "
          f"{b['step_profile']['launches']} launches), peak "
          f"{b['peak_gb']:.2f} GB, loss {b['loss']:.4f}; fp32 microbatches "
          f"2 against 1: loss {b['fp32_loss']}, max grad err "
          f"{b['mb_grad_rel_err']:.3g} of each gradient's largest entry "
          f"(tolerance {TRAIN_MB_TOL}); zero or non-finite gradients: "
          f"{b['zero_or_nonfinite_grads']}", flush=True)
    del task, params, state, step_fn, batch, g1, g2
    info["free_s"].append(lm_free(torch))
    part_done("b")
    launches = {"rank_counts": rank_topk.rank_counts.launches,
                "transe_score": ts.transe_score.launches,
                "transe_score_bwd": ts.transe_score_bwd.launches}
    # --- end ---

    # (c) the training launcher at smollm-135m's full width, in a process
    # of its own
    info["c_launcher"] = train_launcher(ok)
    part_done("c")
    info["phase_s"] = time.perf_counter() - t_phase
    info["ok"] = ok
    print(f"lm_train took {info['phase_s']:.1f} s on {smi_line()} (by "
          f"part: {json.dumps(info['part_s'])})", flush=True)
    print("lm_train " + json.dumps(info), flush=True)
    failed = [k for k, v in ok.items() if not v]
    if failed:
        fail(f"lm_train checks failed: {failed}")
    for name, count in launches.items():
        if count != 0:
            fail(f"{name} launched {count} times on the LM training path, "
                 "where no kernel lies")
    return info, launches


MESH_OUTER_RANKS = 2
MESH_OUTER_CASES = (
    ("average-none", dict(strategy="average", compress="none")),
    ("average-int8", dict(strategy="average", compress="int8")),
    ("average-int8-mom", dict(strategy="average", compress="int8",
                              outer_momentum=0.9)),
    ("average-int8-live", dict(strategy="average", compress="int8"), True),
    ("average-none-live", dict(strategy="average", compress="none"), True),
    ("random", dict(strategy="random", compress="none")),
    ("random-live", dict(strategy="random", compress="none"), True),
    ("miniloss", dict(strategy="miniloss_global", compress="none")),
    ("miniloss-live", dict(strategy="miniloss_global", compress="none"),
     True),
)
MESH_MOE = dict(arch="qwen2-moe-a2.7b", batch=4, seq=128)
MESH_MOE_TOL = 1e-5
MESH_MOE_REPS = 5
MESH_TRAIN = dict(batch=8, seq=512, steps=4)
MESH_RANK_S = 300           # every mesh rank's bound
MESH_DRYRUN_S = 600         # the dry-run subprocesses' bound (started early)
MESH_DRYRUN_GB = 16.0
MESH_REDUCED = False        # a CPU rehearsal's reduced widths, in the ranks


def mesh_config(arch, reduced=False, **overrides):
    """``arch``'s full-width config (reduced in a CPU rehearsal)."""
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get_config(arch, reduced=reduced),
                               **overrides)


def mesh_outer_params(torch, pod: int, reduced=False):
    """Pod ``pod``'s smollm-135m parameter tree on the card: the seeded
    init (the shared anchor) plus a pod-seeded step of 1e-3."""
    from repro_torch.models import registry
    from repro_torch.train import loop

    cfg = mesh_config("smollm-135m", reduced)
    model = registry.make_task(cfg, DEVICE).init(
        torch.Generator(device=DEVICE).manual_seed(0))
    anchor = {k: v.clone() for k, v in loop.named_params(model).items()}
    del model
    gen = torch.Generator(device=DEVICE).manual_seed(100 + pod)
    params = {k: a + 1e-3 * torch.randn(a.shape, generator=gen,
                                        device=DEVICE)
              for k, a in anchor.items()}
    return anchor, params


def mesh_outer_expected(torch, case, pods, anchor, losses, draws, live):
    """The merge of every pod's tree computed in one process, the
    reference's formulas over the pod axis in pod order: (merged,
    momentum or None)."""
    from repro_torch.core import local_sgd

    cfg = local_sgd.OuterConfig(**case)
    M = len(pods)
    lv = [torch.tensor(float(x), device=DEVICE) for x in live]
    n_live = torch.clamp_min(sum(lv[1:], lv[0]), 1.0)
    if cfg.strategy == "average":
        mom0 = {k: torch.zeros_like(a) for k, a in anchor.items()} \
            if cfg.outer_momentum > 0 else None
        merged, mom = {}, None if mom0 is None else {}
        for k, a in anchor.items():
            deltas = [p[k] - a for p in pods]
            if cfg.compress == "none":
                parts = [d * lv[i] for i, d in enumerate(deltas)]
                mean = sum(parts[1:], parts[0]) / n_live
            else:
                amax = [torch.max(torch.abs(d)) * lv[i]
                        for i, d in enumerate(deltas)]
                gmax = torch.stack(amax).max()
                scale = gmax / 127.0 + 1e-12
                qs = [torch.where(lv[i] > 0, torch.clamp(torch.round(
                    d / scale), -127, 127).to(torch.int8),
                    torch.zeros_like(d, dtype=torch.int8)).to(torch.int32)
                    for i, d in enumerate(deltas)]
                acc = sum(qs[1:], qs[0])
                dt = a.dtype
                mean = acc.to(dt) * scale.to(dt) / n_live
            if mom0 is not None:
                mu = cfg.outer_momentum
                mom[k] = mu * mom0[k] + mean
                step = mu * mom[k] + mean
            else:
                step = mean
            merged[k] = a + cfg.outer_lr * step
        return merged, mom
    W = M
    pri = [float(draws[i]) if cfg.strategy == "random"
           else -float(losses[i]) for i in range(M)]
    score = [(pri[i] if live[i] > 0 else float("-inf")) * W - i
             for i in range(M)]
    win = max(range(M), key=lambda i: (score[i], -i))
    return {k: pods[win][k].clone() for k in anchor}, None


def mesh_rank(spec_path, rank):
    """One gloo rank of phase 19, run as ``python3 chip_smoke.py
    --mesh-rank SPEC RANK`` by ``lm_mesh_path``: (a) ``outer_merge`` over a
    ("pod",) mesh, every case against the one-process formula on all
    pods' trees; (b) the expert-parallel MoE dispatch over a (data, model)
    mesh against the scatter path on the whole batch.  Writes its
    results to the spec's output prefix."""
    import faulthandler
    import pickle
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    faulthandler.enable()       # a crash prints its Python stack

    sys.path.insert(0, os.path.join(ROOT, "src"))
    global DEVICE
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    # a rank that hangs shows where, before its bound kills it
    faulthandler.dump_traceback_later(spec["bound_s"] - 20, exit=True)
    DEVICE = spec["device"]
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    else:                      # a rehearsal on the CPU: nothing to sync
        torch.cuda.synchronize = lambda: None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", store=dist.FileStore(spec["store"], spec["M"]),
        world_size=spec["M"], rank=rank,
        timeout=timedelta(seconds=SHARD_COLLECTIVE_S))
    try:
        out = (_mesh_outer_rank if spec["suite"] == "outer"
               else _mesh_moe_rank)(torch, spec, rank, init_device_mesh)
    finally:
        dist.destroy_process_group()
    name = f"{spec['out']}.rank{rank}"
    with open(name + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(name + ".tmp", name)


def _mesh_outer_rank(torch, spec, rank, init_device_mesh):
    from repro_torch.core import local_sgd

    M = spec["M"]
    mesh = init_device_mesh(DEVICE, (M,), mesh_dim_names=("pod",))
    pods = []
    for pod in range(M):
        anchor, params = mesh_outer_params(torch, pod, spec["reduced"])
        pods.append(params)
    losses = [2.0 + 0.25 * ((3 * i) % M) for i in range(M)]
    draws = [((7 * i + 3) % 11) / 11.0 for i in range(M)]
    dead = [1.0] * (M - 1) + [0.0]
    res = {"n_params": sum(t.numel() for t in anchor.values())}
    for label, case, *live in MESH_OUTER_CASES:
        cfg = local_sgd.OuterConfig(**case)
        live = dead if live else [1.0] * M
        t0 = time.perf_counter()
        merged, new = local_sgd.outer_merge(
            pods[rank], local_sgd.OuterState.init(anchor, cfg), cfg,
            mesh=mesh, local_loss=losses[rank], draw=draws[rank],
            liveness=live[rank] if live != [1.0] * M else None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        want, want_mom = mesh_outer_expected(torch, case, pods, anchor,
                                             losses, draws, live)
        bits = all(bits_equal(merged[k], want[k]) for k in want)
        if want_mom is not None:
            bits = bits and all(bits_equal(new.momentum[k], want_mom[k])
                                for k in want_mom)
        res[label] = {"bitwise": bits, "seconds": seconds,
                      "max_abs_err": max_err([merged[k] for k in want],
                                             list(want.values()))}
    return res


def mesh_moe_inputs(torch, cfg, seed=0):
    """One MoE layer's parameters at ``cfg``'s width and a batch of
    tokens' activations, seeded, on the card (fp32)."""
    from repro_torch.models import moe

    p = moe.init_moe(torch.Generator(device=DEVICE).manual_seed(seed), cfg,
                     DEVICE)
    x = torch.randn((MESH_MOE["batch"], MESH_MOE["seq"], cfg.d_model),
                    generator=torch.Generator(device=DEVICE).manual_seed(
                        seed + 1), device=DEVICE)
    return p, x


def _mesh_moe_rank(torch, spec, rank, init_device_mesh):
    import dataclasses

    import torch.distributed as dist

    from repro_torch.models import moe
    from repro_torch.parallel import util as par
    from repro_torch.roofline import hlo_cost

    mesh = init_device_mesh(DEVICE, (2, 2), mesh_dim_names=("data", "model"))
    base = mesh_config(MESH_MOE["arch"], spec["reduced"])
    cfg = dataclasses.replace(base, dtype=torch.float32,
                              capacity_factor=base.n_experts / base.top_k,
                              sharding_profile="fsdp_tp")
    p, x = mesh_moe_inputs(torch, cfg)
    with torch.no_grad():
        want, want_aux = moe._apply_moe_scatter(p, x, cfg)
    # this rank's block of experts, whole over data: what
    # parallel.util.local_params hands the dispatch under fsdp_tp.  Cut by
    # hand: DTensor's gathers are functional collectives, which crash on
    # CUDA tensors over gloo (a SIGSEGV in wait_tensor, torch 2.11 on the
    # H100); they ran in the CPU tests and over NCCL in (c)
    e_loc = moe.padded_experts(cfg) // 2
    j = mesh.get_local_rank("model")
    with torch.no_grad():
        for name in ("wi", "wg", "wo"):
            block = getattr(p, name)[j * e_loc:(j + 1) * e_loc].clone()
            setattr(p, name, torch.nn.Parameter(block, requires_grad=False))
    rows = x.shape[0] // 2
    lo = mesh.get_local_rank("data") * rows
    x_loc = x[lo:lo + rows].contiguous()
    calls = []
    real = moe._apply_moe_shardmap

    def dispatch():
        with par.use_mesh(mesh, ("data",), cfg.sharding_profile), \
                torch.no_grad():
            return moe.apply_moe(p, x_loc, cfg)

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    moe._apply_moe_shardmap = counted
    try:
        out, aux = dispatch()
    finally:
        moe._apply_moe_shardmap = real
    mode = hlo_cost.CostMode()
    with mode:
        dispatch()
    cost = hlo_cost.analyze(mode)
    times = []
    for _ in range(MESH_MOE_REPS):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dispatch()
        torch.cuda.synchronize()
        dist.barrier()
        times.append(time.perf_counter() - t0)
    return {"calls": len(calls), "e_loc": int(p.wi.shape[0]),
            "max_abs_err": max_err([out], [want[lo:lo + rows]]),
            "aux_err": abs(float(aux) - float(want_aux)),
            "call_ms": 1e3 * min(times), "call_ms_all": [1e3 * t for t in
                                                         times],
            "wire_bytes": cost.coll_wire_bytes,
            "collectives": {k: [cost.coll_counts[k], cost.coll_by_op[k]]
                            for k in cost.coll_by_op},
            "flops": cost.flops, "bytes": cost.bytes_accessed,
            "tokens": int(x_loc.shape[0] * x_loc.shape[1])}


def mesh_dryrun_check(ok, label, rc, out, seconds, records_dir, tag):
    """A production dry-run subprocess's record checked as the slow test
    checks it: exit 0, ``status`` ok, the peak under 16 GB, the model
    FLOPs the analytic count and traced FLOPs positive."""
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.roofline import analysis

    path = os.path.join(records_dir, tag, "smollm-135m__train_4k.json")
    rec = {}
    if rc == 0 and os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
    else:
        print(out[-4000:], flush=True)
    want = analysis.model_flops(configs.get_config("smollm-135m"),
                                registry.SHAPES["train_4k"])
    ok[f"d_{label}_exit_0"] = rc == 0
    ok[f"d_{label}_ok"] = rec.get("status") == "ok"
    ok[f"d_{label}_peak_under_16gb"] = rec.get("memory", {}).get(
        "peak_per_device_gb", 1e9) < MESH_DRYRUN_GB
    ok[f"d_{label}_model_flops"] = rec.get("roofline", {}).get(
        "model_flops") == want
    ok[f"d_{label}_flops"] = rec.get("hlo_cost", {}).get("flops", 0) > 0
    return {"rc": rc, "seconds": seconds,
            "record": {k: rec.get(k) for k in (
                "status", "memory", "hlo_cost", "roofline", "lower_s",
                "compile_s", "depth_traced")}}


def lm_mesh_path(torch):
    """The LM mesh (item 19 of the module docstring).  Returns the path's
    info and its launches of each kernel (none lies on it: 0 expected)."""
    import pickle
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import rank_topk, transe_score as ts
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.models import registry
    from repro_torch.parallel import util as par
    from repro_torch.train import loop
    from repro_torch.train import optimizer as opt_lib

    t_phase = time.perf_counter()
    card = smi_line()
    info = {"card": card, "part_s": {}}
    ok = {}
    marks = [t_phase]

    def part_done(label):
        marks.append(time.perf_counter())
        info["part_s"][label] = marks[-1] - marks[-2]

    rank_topk.rank_counts.launches = 0     # --- LM mesh path ---
    ts.transe_score.launches = 0
    ts.transe_score_bwd.launches = 0

    # (a) and (b): the gloo rank groups, started together, sharing the card
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_")
    cmds = []
    specs = {}
    for suite, M in (("outer", MESH_OUTER_RANKS), ("moe", 4)):
        spec = {"suite": suite, "M": M, "device": DEVICE,
                "reduced": MESH_REDUCED, "bound_s": MESH_RANK_S,
                "store": os.path.join(tmp.name, f"store_{suite}"),
                "out": os.path.join(tmp.name, f"res_{suite}")}
        specs[suite] = spec
        path = os.path.join(tmp.name, f"spec_{suite}")
        with open(path, "wb") as f:
            pickle.dump(spec, f)
        cmds += [(f"{suite}{r}", [sys.executable, os.path.join(
            ROOT, "chip_smoke.py"), "--mesh-rank", path, str(r)])
            for r in range(M)]
    started = _start(cmds, tmp.name)

    # (c) Trainer over a one-rank NCCL mesh against the mesh-less Trainer,
    # smollm-135m at full width, bitwise
    arch = "smollm-135m"
    cfg = lm_config(arch)
    c = {}
    Bt, Lt, steps = MESH_TRAIN["batch"], MESH_TRAIN["seq"], \
        MESH_TRAIN["steps"]
    opt_cfg = opt_lib.OptConfig(name="adamw", learning_rate=TRAIN_LR,
                                warmup_steps=1, decay_steps=steps)

    def train(mesh):
        task = registry.make_task(cfg, DEVICE)
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=Lt, global_batch=Bt, seed=0))
        tr = loop.Trainer(task, pipe, opt_cfg, loop.TrainConfig(
            steps=steps, log_every=0), mesh=mesh)
        (params, _), seconds = wall(torch, lambda: tr.run(seed=0,
                                                          resume=False))
        return tr.history, par.full_tree(loop.named_params(params)), seconds

    h0, p0, c["plain_s"] = train(None)
    dist.init_process_group(
        "nccl" if DEVICE == "cuda" else "gloo",
        store=dist.FileStore(os.path.join(tmp.name, "nccl"), 1),
        world_size=1, rank=0, timeout=timedelta(seconds=SHARD_COLLECTIVE_S))
    try:
        mesh = make_mesh_for_devices(1, device=DEVICE)
        h1, p1, c["mesh_s"] = train(mesh)
    finally:
        dist.destroy_process_group()
    c["history"], c["mesh_history"] = h0, h1
    ok["c_losses_bitwise"] = h0 == h1
    ok["c_params_bitwise"] = set(p0) == set(p1) and all(
        bits_equal(p0[k], p1[k]) for k in p0)
    ok["c_params_on_card"] = all(t.device.type == torch.device(DEVICE).type
                                 for t in p1.values())
    c["max_abs_err"] = max_err([p1[k] for k in p0], list(p0.values()))
    info["c"] = c
    print(f"lm_mesh (c) {arch} Trainer over a one-rank NCCL (1, 1) mesh on "
          f"{card}: {steps} steps of {Bt} x {Lt} tokens, losses {h1} "
          f"against {h0}, max param err {c['max_abs_err']}; "
          f"{c['mesh_s']:.2f} s against {c['plain_s']:.2f} s", flush=True)
    del p0, p1
    lm_free(torch)
    part_done("c")
    launches = {"rank_counts": rank_topk.rank_counts.launches,
                "transe_score": ts.transe_score.launches,
                "transe_score_bwd": ts.transe_score_bwd.launches}
    # --- end ---

    joined = _join(started, MESH_RANK_S)
    res = {}
    for suite, spec in specs.items():
        res[suite] = []
        for r in range(spec["M"]):
            rc, out, seconds = joined[f"{suite}{r}"]
            ok[f"rank_{suite}{r}_exit_0"] = rc == 0
            name = f"{spec['out']}.rank{r}"
            if rc != 0 or not os.path.exists(name):
                print(out[-4000:], flush=True)
                res[suite].append(None)
                continue
            with open(name, "rb") as f:
                res[suite].append(pickle.load(f))
    tmp.cleanup()
    a = {"ranks": MESH_OUTER_RANKS}
    for r, got in enumerate(res["outer"]):
        for label, *_ in MESH_OUTER_CASES:
            cell = (got or {}).get(label, {})
            ok[f"a_{label}_rank{r}_bitwise"] = bool(cell.get("bitwise"))
        a[f"rank{r}"] = got
    info["a"] = a
    if res["outer"][0]:
        print(f"lm_mesh (a) outer_merge over {MESH_OUTER_RANKS} gloo ranks "
              f"on {card}, smollm-135m's {res['outer'][0]['n_params']:,} "
              f"parameters: " + ", ".join(
                  f"{label} {res['outer'][0][label]['seconds']:.3f} s "
                  f"bitwise={res['outer'][0][label]['bitwise']}"
                  for label, *_ in MESH_OUTER_CASES), flush=True)
    b = {"ranks": res["moe"]}
    for r, got in enumerate(res["moe"]):
        got = got or {}
        ok[f"b_rank{r}_expert_parallel"] = got.get("calls") == 1
        ok[f"b_rank{r}_matches_scatter"] = got.get(
            "max_abs_err", 1e9) <= MESH_MOE_TOL and got.get(
            "aux_err", 1e9) <= MESH_MOE_TOL
    info["b"] = b
    if res["moe"][0]:
        g = res["moe"][0]
        print(f"lm_mesh (b) qwen2-moe-a2.7b MoE layer (d 2048, 64 padded "
              f"experts, top-4, ffn 1408) over a 2 x 2 gloo mesh on {card}: "
              f"{g['tokens']} tokens a rank, {g['e_loc']} experts a rank, "
              f"max err {max(x['max_abs_err'] for x in res['moe'] if x)} "
              f"against the scatter path, a call {g['call_ms']:.2f} ms "
              f"(best of {MESH_MOE_REPS}), {g['wire_bytes']:.0f} wire bytes "
              f"a call ({g['collectives']})", flush=True)
    part_done("ab")

    # (d) the production dry-runs, started with phase 17
    runs = start_lm_launchers()
    d = {}
    for label, tag in (("dryrun16", "pod16x16"),
                       ("dryrun2x16", "pod2x16x16")):
        rc, out, seconds = _join(runs[label], MESH_DRYRUN_S)[label]
        d[label] = mesh_dryrun_check(ok, label, rc, out, seconds,
                                     _LM_LAUNCHERS["dryrun_dir"], tag)
        r = d[label]["record"]
        if r.get("status") == "ok":
            print(f"lm_mesh (d) dry-run smollm-135m x train_4k on {tag}: "
                  f"{seconds:.1f} s, peak {r['memory']['peak_per_device_gb']}"
                  f" GB a device, {r['hlo_cost']['flops']:.4g} FLOPs a "
                  f"device, bottleneck {r['roofline']['bottleneck']} "
                  "(modelled on the H100 SXM data sheet, not measured)",
                  flush=True)
    info["d"] = d
    part_done("d")
    info["phase_s"] = time.perf_counter() - t_phase
    info["ok"] = ok
    print(f"lm_mesh took {info['phase_s']:.1f} s on {smi_line()} (by part: "
          f"{json.dumps(info['part_s'])})", flush=True)
    failed = [k for k, v in ok.items() if not v]
    if failed:
        fail(f"lm_mesh checks failed: {failed}")
    for name, count in launches.items():
        if count != 0:
            fail(f"{name} launched {count} times on the LM mesh path, "
                 "where no kernel lies")
    return info, launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build   # fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every run whose training split does not divide over the workers
    # says so; these splits are known not to
    warnings.filterwarnings("ignore", message="batch_size=.* does not "
                            "divide", category=UserWarning)
    smi = smi_line()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    rates = peaks(name)
    t_start = time.perf_counter()
    phase_s = {}

    def phase(label, fn, *args):
        """``fn(*args)``, its seconds kept and its start and end on
        stderr, where they show whatever stops the script."""
        t0 = time.perf_counter()
        print(f"chip_smoke: {label} starts at {t0 - t_start:.1f} s",
              file=sys.stderr, flush=True)
        out = fn(*args)
        phase_s[label] = time.perf_counter() - t0
        print(f"chip_smoke: {label} took {phase_s[label]:.1f} s",
              file=sys.stderr, flush=True)
        return out

    report = phase("build", build.build_all)
    build_s = phase_s["build"]
    print(f"kernel build: {build_s:.2f} s", flush=True)
    for lib, rep in report.items():
        print(f"nvcc {lib} ({rep['seconds']:.2f} s):\n{rep['nvcc']}",
              flush=True)

    cases = phase("rank_counts", kernel_phase, torch, rates)
    ts_cases = phase("transe_score", transe_kernel_phase, torch, rates)
    graph, graph_info = phase("graph", build_graph)
    print("graph " + json.dumps(graph_info), flush=True)
    cut = depth_cut(graph)
    sgd, bgd, train_info, ts_launches, init_metrics = phase(
        "training", training_path, torch, graph)
    info, launches = phase("serving", serving_path, torch, graph, sgd.kb)
    resume_info, phase_launches = phase("eval_resume", eval_resume_path,
                                        torch, graph, sgd, bgd)
    device_info, device_launches = phase(
        "device_pipeline", device_pipeline_path, torch, graph, cut)
    live_info, live_launches = phase("serving_live", serving_live_path,
                                     torch, sgd, bgd)
    family_info, family_launches = phase("model_family", model_family_path,
                                         torch, cut, graph)
    sparse_info, sparse_launches = phase(
        "sparse_transport", sparse_transport_path, torch, graph, cut,
        sgd.loss_history)
    stale_info, stale_launches = phase("stale_sharded", stale_sharded_path,
                                       torch, graph, cut)
    online_info, online_launches = phase("online", online_path, torch,
                                         graph)
    entry_info, entry_launches = phase("entry_points", entry_points_path,
                                       torch)
    shard_info, shard_launches = phase("shard_map", shard_map_path, torch,
                                       cut)
    lm_info, lm_launches = phase("lm_serving", lm_serving_path, torch)
    moe_info, moe_launches = phase("lm_moe", lm_moe_path, torch)
    rec_info, rec_launches = phase("lm_recurrent", lm_recurrent_path, torch)
    enc_info, enc_launches = phase("lm_encdec", lm_encdec_path, torch)
    train_lm_info, train_lm_launches = phase("lm_train", lm_train_path,
                                             torch)
    mesh_info, mesh_launches = phase("lm_mesh", lm_mesh_path, torch)
    info.update(build_s=build_s, graph=graph_info, training=train_info,
                phase_s=phase_s, depth_cut={
                    "divisor": DEPTH_CUT, "train": len(cut.train),
                    "phases": ["device_pipeline", "model_family",
                               "sparse_transport", "stale_sharded",
                               "shard_map"]},
                init_metrics=init_metrics, eval_resume=resume_info,
                device_pipeline=device_info, serving_live=live_info,
                model_family=family_info, sparse_transport=sparse_info,
                stale_sharded=stale_info, online=online_info,
                entry_points=entry_info, shard_map=shard_info,
                lm_serving=lm_info, lm_moe=moe_info, lm_recurrent=rec_info,
                lm_encdec=enc_info, lm_train=train_lm_info,
                lm_mesh=mesh_info)
    init_rank = init_metrics["entity_filtered"]["mean_rank"]
    trained_rank = info["metrics"]["entity_filtered"]["mean_rank"]
    print(f"filtered mean rank: init {init_rank}, SGD-trained "
          f"{trained_rank}", flush=True)
    # A weak gate: a few epochs at lr 0.01 barely move unit-norm rows.  The
    # evidence that the updates are right is the CPU-against-card epoch
    # above and the CPU tests against the reference.
    if not trained_rank < init_rank:
        fail(f"the SGD-trained filtered mean rank {trained_rank} does not "
             f"beat the init's {init_rank}")

    from repro_torch.kernels import rank_topk

    main_case = next(c for c in cases if c["E"] == FB15K["n_entities"]
                     and c["norm"] == "l1" and c["dtype"] == "float32"
                     and not c.get("tie_stress"))
    kernels = [{
        "name": "rank_counts", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rank_topk.cu",
        "replaces": "src/repro/kernels/rank_topk.py:65",
        "launches": launches + phase_launches["rank_counts"]
        + device_launches["rank_counts"] + live_launches["rank_counts"]
        + family_launches["rank_counts"] + sparse_launches["rank_counts"]
        + stale_launches["rank_counts"] + online_launches["rank_counts"]
        + entry_launches["rank_counts"] + shard_launches["rank_counts"]
        + lm_launches["rank_counts"] + moe_launches["rank_counts"]
        + rec_launches["rank_counts"] + enc_launches["rank_counts"]
        + train_lm_launches["rank_counts"] + mesh_launches["rank_counts"],
        "launches_by_path": {"serving": launches,
                             "eval_resume": phase_launches["rank_counts"],
                             "device_pipeline":
                                 device_launches["rank_counts"],
                             "serving_live": live_launches["rank_counts"],
                             "model_family":
                                 family_launches["rank_counts"],
                             "sparse_transport":
                                 sparse_launches["rank_counts"],
                             "stale_sharded": stale_launches["rank_counts"],
                             "online": online_launches["rank_counts"],
                             "entry_points": entry_launches["rank_counts"],
                             "shard_map": shard_launches["rank_counts"],
                             "lm_serving": lm_launches["rank_counts"],
                             "lm_moe": moe_launches["rank_counts"],
                             "lm_recurrent": rec_launches["rank_counts"],
                             "lm_encdec": enc_launches["rank_counts"],
                             "lm_train": train_lm_launches["rank_counts"],
                             "lm_mesh": mesh_launches["rank_counts"]},
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "count_mismatches": sum(c["count_mismatches"] for c in cases),
        "ms": main_case["ms"], "call_ms": main_case["call_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "kernels": list(rank_topk.KERNELS["l1"]),
        "kernel": main_case["kernel"],
        "cases": cases,
    }]
    # the training step's shape: 4 workers x 256 triplets, L1, fp32
    step = next(c for c in ts_cases if c["W"] == TRAIN["n_workers"]
                and c["norm"] == "l1" and c["dtype"] == "float32")
    # the sparse transport's compact step: the same batch over the 4B / 2B
    # rows it references
    compact = next(c for c in ts_cases if c["E"] == 4 * TRAIN["batch_size"]
                   and c["norm"] == "l1" and c["dtype"] == "float32")
    for kname, key, replaces, n in (
            ("transe_score", "fwd", "src/repro/kernels/transe_score.py:54",
             ts_launches[0]),
            ("transe_score_bwd", "bwd", "src/repro/kernels/ops.py:68",
             ts_launches[1])):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/transe_score.cu",
            "replaces": replaces,
            "launches": n + phase_launches[kname] + device_launches[kname]
            + live_launches[kname] + family_launches[kname]
            + sparse_launches[kname] + stale_launches[kname]
            + online_launches[kname] + entry_launches[kname]
            + shard_launches[kname] + lm_launches[kname]
            + moe_launches[kname] + rec_launches[kname]
            + enc_launches[kname] + train_lm_launches[kname]
            + mesh_launches[kname],
            "launches_by_path": {"training": n,
                                 "eval_resume": phase_launches[kname],
                                 "device_pipeline": device_launches[kname],
                                 "serving_live": live_launches[kname],
                                 "model_family": family_launches[kname],
                                 "sparse_transport":
                                     sparse_launches[kname],
                                 "stale_sharded": stale_launches[kname],
                                 "online": online_launches[kname],
                                 "entry_points": entry_launches[kname],
                                 "shard_map": shard_launches[kname],
                                 "lm_serving": lm_launches[kname],
                                 "lm_moe": moe_launches[kname],
                                 "lm_recurrent": rec_launches[kname],
                                 "lm_encdec": enc_launches[kname],
                                 "lm_train": train_lm_launches[kname],
                                 "lm_mesh": mesh_launches[kname]},
            "kernels": list(TRANSE_KERNELS[key]),
            "max_abs_err": max(c[f"{key}_max_abs_err"] for c in ts_cases),
            "ms": step[f"{key}_ms"], "plain_ms": step[f"{key}_plain_ms"],
            "bound_ms": step[f"{key}_bound_ms"],
            "bound_by": step[f"{key}_bound_by"],
            "library_ms": step[f"{key}_library_ms"],
            "compact_step": {f: compact[f"{key}_{f}"] for f in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "cases": [{k: v for k, v in c.items()
                       if not k.startswith("fwd_" if key == "bwd"
                                           else "bwd_")}
                      for c in ts_cases],
        })
    device = {"platform": "gpu", "kind": name,
              "count": torch.cuda.device_count()}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"nvidia_smi": smi, "device": device, "kernels": kernels,
                   "main_path": info}, f, indent=1)
    print(json.dumps({k: info[k] for k in info
                      if k not in ("metrics", "init_metrics", "training",
                                   "eval_resume", "device_pipeline",
                                   "serving_live", "model_family",
                                   "sparse_transport", "stale_sharded",
                                   "online", "entry_points", "shard_map",
                                   "lm_serving", "lm_moe",
                                   "lm_recurrent", "lm_encdec",
                                   "lm_train", "lm_mesh")}),
          flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-rank"]:
        shard_rank(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    sys.exit(main())
