"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits non-zero:

1. the device (nvidia-smi's name and power limit, torch and CUDA versions);
2. the build of the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, in bf16 and f32, within 3e-2 (bf16) and 2e-5 (f32),
   absolute and relative; SGMV also at the measurement path's 32 adapters
   with skewed ids (one past capacity, empty ones, ids outside [0, N)),
   and its sort kernel bit for bit against ``sgmv.segments_plain``;
   SGMV with whole-prompt arrival ranks (the whole prompt's capacity
   rule under a sequence cut, ``check_sgmv_arrival``) at B 8 x S 512,
   d 3072, r 8, o 3072 and 1024, N 4, bf16, with ids spread over the
   adapters and with every request on adapter 0 (1920 of 4096 tokens
   dropped): on the whole prompt's own ranks bit for bit the call
   without them, each of 4 sequence slices against its rows of the plain
   version of the whole prompt, and the slices together against the
   whole prompt, bit for bit or within bf16's 3e-2 (which of the two is
   printed);
   flash-decode and the fused flash-decode+LoRA,
   whose attention outputs are weighted means of V and shrink with the
   row's length, also within 1e-2 (bf16) and 2e-5 (f32) of each output
   row's largest magnitude; the fused kernel with its delta at two sizes
   (one that dominates the output, one of the attention's size), also with
   an f32 bank under bf16 attention and with a ragged bank
   (``ops.fused_decode``), bitwise equal to flash-decode on an all-base
   batch, raising on an expand dim other than H*D, and at the measurement
   path's widest points (batch 32, 4096 positions, 32 adapters, ranks 8,
   16 and 32) on the inputs that path draws, where plain flash-decode is
   held too (full and ragged lengths); flash-decode (B 8, S 512, ragged
   lengths, per row) and BGMV (the q and v projections' widths) at the
   published shapes of gemma3-1b, qwen1.5-4b, internlm2-20b,
   musicgen-medium, internvl2-2b and olmoe-1b-7b (16 heads of 128 on 16
   KV heads, d 2048, as moonshot), and SGMV at gemma3's d 1152, T 1024;
   the MoE FFN (``moe.apply_moe``) against its dropless oracle
   ``apply_moe_ref`` at olmoe-1b-7b's published widths, bf16, at T 8 (the
   decode step's) and T 512 (T*k 4096, the largest dropless size);
   ``quantize_kv`` on the card bit for bit its CPU result; flash-decode's
   int8 mode against ``flash_decode_int8_plain`` at ``INT8_SHAPES``
   (phi4-mini's serving shape, gemma3-1b's global layer, olmoe-1b-7b's G 1,
   B 32 at S 4096), q in bf16 and in f32, full and ragged lengths (0 and 1
   among them) on a cache with other values past each row's length (the
   output bit for bit the clean cache's), q in bf16 within bf16's 3e-2 and
   1e-2 of each row's largest value (the JAX arithmetic rounds P times
   v_scale to bf16, which the kernel does against each split's running
   max, the plain version against the row's global max), q in f32 within
   f32's 2e-5 of the plain version with exact q . k (``check_int8``: a
   pre-pass gives the kernel the row's max, and both take q . k's exact
   f32 value), its largest departure printed, and against the plain
   version's einsum-order q . k within 2e-5 plus that version's own
   rounding flips;
   flash-decode in bf16 and in int8 over LONG_S (32768)
   positions at phi4-mini's heads, B 8; flash-decode, the fused kernel and
   the int8 mode past 8 query heads per KV head (``HEAD_GROUP_SHAPES``:
   recurrentgemma-9b's 16 heads on 1 KV head of 256 at 512 and 2048 rows,
   a group of 12, 24 heads of 256 on 1 KV head and 16 of 200), and
   flash-decode and the fused kernel at head dim 8,
   in bf16 and f32, ragged lengths with 0 among them, per row (the int8
   mode with q in bf16 and f32, at the tolerance of q's dtype; at head dim
   8 it runs padded on its 16 instance); in bf16 at head dims 200 and 256
   also the log-sum-exp mode, and the profiler's name of each call's split
   kernel held to the tensor-core pass at D 256 (``require_d256_pass``,
   also for phase 6's ``gemma3_*``/``rgemma_*`` rows and 13c's D 256
   rows); and flash-decode, the fused kernel
   and the int8 mode at every head dim 1..256 (``check_head_dims``: one
   without an instance runs the next larger one, padded) and at head dims
   257, 320, 384, 512, 576 and 1024 (``WIDE_DIMS``, the wide path), 1, 4
   or 16 query heads a KV head by turns, q in bf16 and f32, per row; and
   the products the JAX package keeps in f32 (``layers.matmul_f32``) at
   phi4-mini's decode shapes (T 8; the MLP's gate and up, the untied
   logits over 200192 columns) within 1e-5 of the f32 product of the bf16
   values, each timed beside the bf16 product and the upcast one
   (``check_products_f32``);
4. teacher forcing at phi4-mini's published widths, f32, 4 layers:
   decode after ``prefill(tokens[:, :-1])`` must match ``prefill(tokens)``
   to a relative error below 2e-4; then the same for each of the five
   other dense architectures and recurrentgemma-9b at its published
   widths, f32, its depth cut (``VARIANTS``: gemma3 8 layers on 624-token
   prompts, past its 512 window; recurrentgemma 6 layers, two (rglru,
   rglru, local) repeats, on 2175-token prompts, past its 2048 window, its
   local layers' flash-decode at 16 heads on 1 KV head over a wrapped
   rolling buffer and its rglru layers' O(1) decode from the scanned
   state; the others 2 layers; internvl2 after 256 image embeddings),
   each printed with its cut, SGMV, BGMV and flash-decode launched; then
   the MoE architectures (``MOE_VARIANTS``): olmoe-1b-7b 4 layers,
   moonshot-v1-16b-a3b 2 layers, and olmoe-1b-7b 4 layers with int8
   experts, on 4x32-token prompts (both prefills dropless); then
   mamba2-2.7b at its published widths, f32, 4 of its 64 layers, on
   4x512-token prompts (the prefill of 512 positions runs two chunks of
   256, the one of 513 three of 171), launching no kernel wrapper; then
   phi4-mini 4 layers with an int8 KV cache (``Model(kv_quant=True)``):
   decode against prefill, and against the same decode with the int8
   mode's plain version, each within 2e-2
   (tests/test_consistency_int8.py:48);
5. serving: ``repro_torch.launch.serve.serve`` with the launcher's default
   flags (8 adapters, 4 slots, rank 8, dataset small, 30 s horizon) on the
   published phi4-mini-3.8b (32 layers, bf16, weights from seed 0), every
   step a replay of the executor's captured CUDA graph; at least 12
   requests must finish, and the path's launches must be the warmup
   step's plus the replays'; then the replayed step against the eager
   ``decode_step`` from the same cache, cloned, over 4 steps with mixed
   adapter ids (-1 among them), the last two past the cache's end: logits
   and every layer's K/V bit for bit (else within bf16's 3e-2, the largest
   difference printed).  Phase 5b does the same for the published
   gemma3-1b (26 layers, 21 of them local on 512-row rolling buffers,
   bf16), whose replay must launch BGMV 52 and flash-decode 26 times and
   whose last two checked steps also wrap the rolling buffers; phase 6b
   times its step as phase 6 times phi4-mini's.  Phases 5c and 6c do the
   same for the published olmoe-1b-7b (16 layers, 64 experts of 1024,
   top-8, bf16; BGMV 32 and flash-decode 16 launches a replay), and 6c
   also splits its step's device time into the expert products, the MoE
   FFN's other kernels (routing, dispatch, combine), attention, BGMV, the
   dense products and the rest (``step_split``), and prints the step's
   bound (``step_bound``: its weights and recurrent states over the HBM
   rate, against the dense expert products' operations).  Phase 5d serves the published phi4-mini
   on an int8 KV cache as phase 5 serves it (BGMV 64 and flash-decode 32
   launches a replay, the replay bit for bit the eager step) and times its
   step; phase 6d times phi4-mini's replayed step at B 8 over caches of
   LONG_S positions filled from a seeded generator (no prefill), once in
   bf16 and once in int8, each beside its byte bound (``decode_bound``:
   weights and the whole cache over the HBM rate) and with flash-decode's
   share of its busy time.  Phase 5e serves the published
   recurrentgemma-9b (38 layers: 26 rglru on conv and lru states, 12
   local on 512-row rolling buffers, 16 heads on 1 KV head; bf16) as
   phase 5b serves gemma3 (BGMV 24 and flash-decode 12 launches a replay,
   the replay bit for bit the eager step, states included), and phase 6e
   times its step, splits it as 6c splits olmoe's (``step_split``: the
   RG-LRU mixer's products and its other kernels, attention, BGMV, the
   dense products, the rest) and prints its bound (weights, and its
   states read once and written once).  Phase 5f
   serves the published mamba2-2.7b (64 ssd layers on conv_x, conv_bc and
   f32 ssm states, no attention, no LoRA; bf16) as phase 5e serves
   recurrentgemma, its replay launching no kernel wrapper and bit for bit
   the eager step, states included, and phase 6f times its step, splits
   it (the SSD mixer's products and its other kernels, the dense
   products, the rest) and prints its bound (``step_bound``: 5.40 GB of
   weights and 2 x 1.36 GB of states at 8 rows);
6. the served model's decode step three ways: the eager step's wall, the
   replayed step's wall (as ``TorchExecutor.step`` times it) and device
   span (CUDA events), and the device time of each by kernel group from
   the profiler, failing if a kernel the step launched shows no device
   time under its own name, over eager steps and over replays; then per
   kernel at the main path's
   shapes: its time, its plain version's, the least time the card could
   take (bound), and a PyTorch library call's (for the fused kernel, which
   no single PyTorch call computes, the unfused flash-decode + BGMV + add
   sequence instead, as ``unfused_ms``); BGMV also at the v projection's
   width (``o1024_*``), flash-decode's split and combine kernels apart
   from the profiler (``split_ms``, ``combine_ms``), SDPA also on
   transposed views of the port's cache (``library_on_views_ms``; the
   ``library_ms`` yardstick gets head-major copies), ragged SGMV apart
   (``ragged_ms``), SGMV's sort and product kernels apart from the
   profiler (``sort_ms``, ``product_ms``) beside the torch.sort path the
   sort replaced (``sort_plain_ms``), SGMV at N 1 beside the two matrix
   products that compute it there (``n1_library_two_matmuls_ms``: two
   calls, not one) and at the measurement path's prefill shape
   (``measure_*``: T 4096, r 16, N 32, random ids), the fused kernel also
   at the measurement path's widest point (``grid_*``: batch 32, 4096
   positions, rank 32, 32 adapters) beside the unfused sequence, and
   beside every row the per-launch floor
   (``floor_ms``: a 1-element in-place op, replayed the same way); BGMV and
   flash-decode also at gemma3-1b's serving shapes (``gemma3_*``: d 1152,
   o 1024 and 256; 4 heads of D 256 on 1 KV head, beside SDPA) and
   olmoe-1b-7b's (``olmoe_*``: d 2048, o 2048; 16 heads of D 128 on 16 KV
   heads, beside SDPA); flash-decode also at recurrentgemma-9b's shape
   (``rgemma_*``: 16 heads of D 256 on 1 KV head, over 512 rows and the
   2048-row window, beside SDPA, and beside 8 heads on the same K/V,
   ``*_g8_ms``); flash-decode also over LONG_S positions
   (``s32768_*``), and its int8 mode's row (``flash_decode_int8``) at the
   serving shape and over LONG_S positions, beside SDPA over the bf16 cache
   of the same shape (no PyTorch call takes an int8 cache with scales);
   flash-decode on the wide path (``d512_*``: B 8, S 512, 16 heads of 512
   on 4 KV heads), beside its bound and SDPA, whose backend is printed;
7. the measurement path: ``repro_torch.bench.kernels_bench`` times the
   fused kernel (and SGMV for prefill) over its (batch, seq, rank) grid at
   phi4-mini-3.8b's published widths, fits a ``MeasuredStepTimes``, and
   the port's Digital Twin sweeps placements (``find_optimal_placement``,
   32 adapters of ranks 8/16/32 at 3.2 req/s each, dataset small, 60 s
   horizon) with the analytic step-time fit of the synthetic H100 profile
   and with the measured surface, each on the sweep's default twin
   (``FastTwin``), and the measured sweep once more on the object-mode
   ``DigitalTwin`` (``fast=False``), which must give the same (N*, G*),
   throughput and curve; each sweep's (N*, G*), twin runs and wall are
   printed.  The measured surface times one layer's launch, not a model
   step.  Phase 7b runs the paper's creation phase on the card's host with
   W = min(8, CPUs) sweep workers: ``build_pipeline`` at its defaults (40
   scenarios, 96 adapters, 150 s horizon, the forest, the synthetic H100
   profile), the same scenarios labelled on phase 7's measured surface
   (``est.with_measured(mst)``, through ``SweepRunner`` with W - 1
   workers; cut to the rounds that fit its 120 s budget, the cut printed)
   and a forest fitted on the first 80 %; each pipeline's held-out sMAPE
   and ``recommend`` on phase 7's pool beside phase 7's (N*, G*); the
   first 4 scenarios labelled serially (in a thread, beside the rest),
   equal to the runner's labels.  It fails on a
   non-finite feature or label, N* or G* below 1, or an inference of 50
   ms or more;
8. training, after the serving models are freed: 8a, one
   ``make_train_step`` step of phi4-mini-3.8b at its published widths,
   2 layers, f32 (TF32 off), on 2 x 128 tokens of the seeded
   ``TokenPipeline`` in 2 microbatches, on the card and on the CPU from
   the same weights: loss, gradient norm and every gradient leaf within
   2e-4 (||card - cpu||_2 / ||cpu||_2; tests/test_consistency.py:39), the
   worst leaf printed; 8b, the published phi4-mini-3.8b (32 layers, bf16,
   4.45B parameters) trained 8 steps on batches 0..7 of 2 x 512 tokens
   (AdamW lr 3e-4, one warmup step), printing each step's loss and
   gradient norm, the step's median wall (steps 2..8) and the update's
   part of it, tokens/s, the share of 989 TFLOP/s that 6 N tokens reach
   (N: the parameters but the input embedding), and the peak memory
   beside the reckoning, then a ninth step under the profiler split into
   the update, the cuBLAS products and the rest (``train_split``).  It
   fails on a non-finite loss or norm, a last loss not below the first,
   a kernel launch (training runs none of the port's kernels), or a
   parameter left unchanged (but a norm scale of ones, which bf16 cannot
   move by an AdamW step of 3e-4);
9. the loop around the training step (``phase_checkpoint``): phi4-mini at
   its published widths, 2 layers, bf16, through ``FaultTolerantLoop``
   over 6 steps of 2 x 512 tokens with async checkpoints every 3 (2 kept)
   and a crash injected at step 4: one restart, resumed from step 3, the
   AdamW step at 6; the same 6 steps without a crash bit for bit the same
   parameters, m and v; the newest checkpoint restored onto the CPU bit
   for bit; the free disk checked for two checkpoints first; then
   ``python -m repro_torch.launch.train --reduced`` to step 20 and again
   to 30 on one directory, the second resuming from step 20.  Prints the
   checkpoint's bytes, each save's snapshot and write seconds, the
   resume's and the CPU restore's, and the steps' walls;
10. the sharded decode: 10a, flash-decode's log-sum-exp mode
   (``flash_decode_lse``, its own combine instance) against its plain
   versions at ``LSE_SHAPES`` (phi4-mini's and olmoe-1b-7b's serving
   shapes, head groups, a padded and a wide head dim) in every mode (q, K, V in bf16 and f32; the int8
   mode with q in bf16 and f32), ragged lengths with 0 (-inf there), its
   output bit for bit the call without it, and its row of the kernel
   table timed at phi4-mini's serving shape beside ``aten.
   _scaled_dot_product_efficient_attention(compute_log_sumexp=True)``;
   10b, phi4-mini's heads over LONG_S positions (bf16 and int8 caches) cut
   into SHARD_SLICES slices, each slice's kernel and
   ``attention.combine_shards`` held to the unsharded kernel, with the
   microseconds of the unsharded call, each slice and the combine beside
   their byte bounds; 10c, phi4-mini-3.8b at its published widths decoded
   under ``make_plan(cfg, make_single_device_mesh(), "decode",
   global_batch=8)`` on the NCCL world-size-1 group, SHARD_STEPS steps
   over SHARD_CACHE positions after a prefill, each step's logits within
   2e-4 of the step without a plan (bitwise equality printed), with each
   step's wall and the collectives a step; 10d, the same for the MoE, SSM
   and hybrid architectures at their published widths (``PLANNED_ARCHS``:
   olmoe-1b-7b whole, 16 of mamba2-2.7b's 64 layers, 6 of
   recurrentgemma-9b's 38), their experts expert-parallel and their
   mixers width-tensor-parallel over the group of one, with the phase's
   seconds against its budget; 10e, the sharded prefill: phi4-mini-3.8b
   at its published widths prefills BATCH x PREFILL_S tokens under
   ``make_plan(cfg, make_single_device_mesh(), "prefill",
   global_batch=BATCH)`` on the NCCL world-size-1 group (its weights
   gathered whole, the ring over a group of one, SGMV with whole-prompt
   arrival ranks), ``pad_cache`` lays the cache out for the decode plan,
   and a model under the decode plan decodes SHARD_STEPS steps from it; the
   logits, the padded cache and every step bit for bit those of the
   model without a plan, with both prefills' eager walls, the planned
   prefill's collectives and SGMV's launches; 10f, sharded training:
   phi4-mini-3.8b at its published widths (its weights FSDP-cut and
   gathered whole at their use, the sequence over ``model``) and 16 of
   mamba2-2.7b's 64 layers (width-tensor-parallel, FSDP over ``data``),
   bf16, TRAIN_PLAN_STEPS steps of TRAIN_BATCH under ``make_plan(cfg,
   make_single_device_mesh(), "train", global_batch=2, remat=True)`` on
   the NCCL world-size-1 group (each layer recomputed in backward, as
   the JAX dry-run's train cells ask) against the same steps without a
   plan from the
   same weights and batches: each step's loss and gradient norm within
   2e-4 (bitwise equality printed), the parameters' largest relative
   departure after the steps, both walls a step, the collectives a step
   by kind (forward, and backward with its recompute), both peaks, no
   kernel launched, the phase's seconds against its budget.  Every
   number of the phase is printed beside the card's name and power limit;
11. gradient compression (``phase_compression``): phi4-mini-3.8b at its
   published widths (bf16, weights from seed 0) takes one training step
   of TRAIN_BATCH, and its bf16 gradients go through
   ``compressed_grad_sync`` COMPRESS_CALLS times on the NCCL
   world-size-1 group, the residual carried.  Each call's synced
   gradients must be ``(g.float() + r).to(bf16)`` bit for bit (one shard:
   the ring is the identity, no collective), every residual within half
   its leaf's grid step (plus the f32 roundings of x / s and q * s,
   2**-15 s) and not all zero, and the last call on the
   COMPRESS_CPU_LEAVES largest leaves, copied to the host, bit for bit
   the host run of the same function (q, scale, synced and residual).
   Prints the synchronised ms of each sync of the whole tree and their
   median against the byte bound (each gradient and residual read once,
   each synced gradient and new residual written once, over the HBM
   rate), the peak memory, and the phase's seconds against its budget,
   beside the card's name and power limit;
12. the loop around the planned training step (``phase_checkpoint_plan``):
   phase 9's model, batches and crash under ``make_plan(cfg,
   make_single_device_mesh(), "train", global_batch=2, remat=True)`` on
   the NCCL
   world-size-1 group, through the planned ``FaultTolerantLoop`` (each
   save gathers every cut leaf whole over the group of one, rank 0
   writes): one restart, resumed from step 3; the same planned steps
   without a crash bit for bit the same parameters, m and v; the newest
   checkpoint restored without a plan and under the plan into fresh
   models, one more step from each bit for bit one more step of the
   crashed run; each save one gather a cut leaf and the card's memory
   grown by at most its largest leaf.  Prints the checkpoint's bytes,
   each save's snapshot (its gathers included) and write seconds, the
   resume's and both restores' seconds, against its budget, beside the
   card's name and power limit;
13. the dry-run's cells (``phase_cells``): 13a builds every cell of the
   ten architectures, each of its ``applicable_shapes`` on the
   production meshes (16, 16) and (2, 16, 16) as ``MeshShape``s (66
   cells), with ``launch.steps.build_step`` on ``meta`` and prints a line
   a cell: its ``cell_id``, its plan's axes, ``cell_bytes`` a device by
   argument group, ``model_flops_for`` and whether the arguments fit one
   card; then each cell whole (no mesh).  It fails if the card's
   allocated bytes moved.  13b takes each decode cell whose whole
   arguments hold within half the card (the six of gemma3-1b,
   mamba2-2.7b and recurrentgemma-9b at ``decode_32k`` and
   ``long_500k``), builds it on the card (``device="cuda"``, seed 0; the
   paper's 32 adapters of rank 16), fills its cache with seeded draws
   (``fill_cache``: K/V, rolling buffers and recurrent states), ``pos``
   16 short of the end, and runs ``bundle.fn`` for 3 eager steps: the
   real arguments' bytes equal to 13a's meta count to the byte, the peak
   memory beside them, each step's wall (CUDA events) beside
   ``decode_bound``, every logit finite, and exactly 2 BGMV and 1
   flash-decode launches an attention layer a step (none on mamba2); one
   cell is freed before the next is built.  13c holds BGMV (T 128 and
   T 1, 32 adapters of rank 16, at gemma3-1b's and recurrentgemma-9b's
   q and v widths) and flash-decode at 13b's cache shapes against their
   plain versions within phase 3's tolerances (bf16 3e-2, and 1e-2 of
   each row's largest value; flash-decode on as many rows as the plain
   version's f32 K and V take in half the free memory, the count
   printed) and times each (CUDA graph replay) beside its bound and, for
   flash-decode, SDPA on head-major copies.  The phase prints its
   seconds against its 180 s budget, beside the card's name and power
   limit;
14. the dry-run's records against the card (``phase_dryrun``): 14a
   counts each cell 13b ran with ``launch.dryrun.run_cell`` whole on
   ``meta`` (no mesh, on the host; the full depth only, no probes) and
   prints its roofline terms at the
   card's rates (``launch.roofline``) beside 13b's measured eager walls,
   and its ``total_bytes_per_device`` beside 13b's measured peak memory;
   it fails if a predicted argument byte count differs from 13b's real
   one.  14b runs the hill-climb's ``kv_int8`` variant of gemma3-1b's
   ``decode_32k`` (its global layers' caches int8) built whole on the
   card, CELL_STEPS eager steps from ``pos`` CELL_TAIL short of the end
   (flash-decode's int8 mode on the global layers): every logit finite,
   the launches exact, the real arguments' bytes equal to the record's,
   its walls and peak beside its dry-run record.  14c counts
   ``DRYRUN_META_CELLS`` (one cell of each step kind) on each production
   mesh as rank 0 of a fake process group on ``meta``, by the two probes
   alone (the JAX dry-run's ``--no-full``: its roofline, no memory
   report; the full-depth counts and their agreement with the probes
   are the CPU dry-run's and tests'), and prints each record's line, the
   card's allocated bytes unmoved.  The phase prints
   its seconds against DRYRUN_BUDGET_S, beside the card's name and power
   limit.

Launch counts are zeroed just before each path a user drives (teacher
forcing through ``Model.prefill``/``decode_step`` in phase 4, for each
architecture, serving in phases 5, 5b, 5c, 5d, 5e and 5f, measurement in
phase 7, training in phases 8a, 8b and 9, the sharded decode in phase
10c and for each architecture of 10d, the sharded prefill in 10e,
sharded training in 10f, the planned training loop in 12, each cell of
13b, the variant of 14b) and read just after it.  SGMV,
BGMV and flash-decode must have launched in phase 4, BGMV and
flash-decode in phases 5, 5b, 5c, 5d and 5e, the fused kernel and SGMV
in phase 7, BGMV and flash-decode's log-sum-exp mode in phase 10c and on
10d's planned olmoe, BGMV and flash-decode on 10d's planned
recurrentgemma, on 13b's gemma3 and recurrentgemma cells and on 14b's
variant (flash-decode in its int8 mode there), SGMV on
10e's planned prefill; mamba2's paths (phase 4, 5f, 10d, 13b) must launch none,
having no attention and no LoRA, and so must training's (8a, 8b, 9, 10f
and 12).  Each kernel's
``launches`` in the kernel table is the count of the path it serves
(``path``); the int8 mode counts as flash-decode, on the int8 paths
(``serving_int8``, ``teacher_forcing_int8``, ``dryrun_variant``), and
flash-decode's row
counts the others; the log-sum-exp mode (``flash_decode_lse``, on
``sharded_decode``) is a wrapper of its own and counts its own launches.
Float32 products run in full f32 (TF32 off) wherever parity is checked.  The last two lines are the kernel table and the
device, as JSON.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

sys.path.insert(0, str(SRC))
# the card's rates, read where the dry-run's roofline reads them (the H100
# SXM data sheet's): HBM bytes/s and peak FLOP/s by dtype
from repro_torch.launch.roofline import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.roofline import \
    PEAK_FLOPS_BY_DTYPE as PEAK_FLOPS  # noqa: E402
from repro_torch.kernels import cost as kernel_cost  # noqa: E402
TOL = {"bfloat16": 3e-2, "float32": 2e-5}
ROW_TOL = {"bfloat16": 1e-2, "float32": 2e-5}   # relative to a row's scale
KERNEL_ROWS = {  # name -> (source, TPU kernel it replaces)
    "bgmv": ("src/repro_torch/kernels/csrc/bgmv.cu",
             "src/repro/kernels/bgmv.py:54"),
    "sgmv": ("src/repro_torch/kernels/csrc/sgmv.cu",
             "src/repro/kernels/sgmv.py:77"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:95"),
    "flash_decode_lora": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                          "src/repro/kernels/flash_decode.py:205"),
    # the int8 mode of flash-decode (the JAX package's int8 decode,
    # src/repro/models/attention.py:271-314, is plain jnp)
    "flash_decode_int8": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                          "src/repro/kernels/flash_decode.py:95"),
    # flash-decode with its log-sum-exp (fd_combine_lse_kernel), the body
    # of the sequence-sharded decode (the JAX package's
    # decode_attention_sharded, src/repro/models/attention.py:256-314, is
    # plain jnp)
    "flash_decode_lse": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:95"),
}
# a row's wrapper, where it is not the row's name: the int8 mode counts its
# launches as flash_decode's
KERNEL_WRAPPER = {"flash_decode_int8": "flash_decode"}
# the path each kernel is counted on, and the kernels each path must launch
KERNEL_PATH = {"bgmv": "serving", "sgmv": "teacher_forcing",
               "flash_decode": "serving",
               "flash_decode_lora": "measurement",
               "flash_decode_int8": "serving_int8",
               "flash_decode_lse": "sharded_decode"}
PATH_KERNELS = {"teacher_forcing": ("sgmv", "bgmv", "flash_decode"),
                "serving": ("bgmv", "flash_decode"),
                "measurement": ("flash_decode_lora", "sgmv"),
                "sharded_decode": ("bgmv", "flash_decode_lse"),
                "sharded_prefill": ("sgmv",)}
# main-path shapes (phi4-mini-3.8b serving: max_batch 8, cache 512, 4 slots)
D_MODEL, Q_OUT, V_OUT, RANK, SLOTS = 3072, 3072, 1024, 8, 4
HEADS, KV_HEADS, HEAD_DIM, BATCH, CACHE = 24, 8, 128, 8, 512
PREFILL_T = 1024
RAGGED_RANKS = (8, 3, 5, 1)                     # a ragged bank of SLOTS
# The fused delta at two sizes: with ``lora_bank``'s draws it is about
# N(0, scale^2), against attention outputs of about 0.05-0.1 (1 where a
# row's length is 1).  At 2.0 the delta dominates and a fault in the LoRA
# epilogue shows; at 0.05 it is the attention's size and a fault in the
# attention part shows too.
FUSED_SCALES = {"delta-sized": 2.0, "attention-sized": 0.05}
# the measurement path's widest points: batch, positions, adapters, ranks
GRID_B, GRID_S, GRID_N, GRID_RANKS = 32, 4096, 32, (8, 16, 32)
# its widest SGMV prefill: tokens and rank (at N = GRID_N, random ids)
MEASURE_T, MEASURE_RANK = 4096, 16
MEASURE_TOKENS = (512, 2048, MEASURE_T)   # its prefill token counts
# the other dense architectures: phase 3 holds the kernels at their shapes,
# phase 4 teacher-forces each at its published widths, f32, its depth cut
# to these layers (gemma3: its 5 local + 1 global repeat and the 2-local
# remainder), on B x S tokens (gemma3: 624-token prompts, past its 512
# window; 625 and 624 split into whole chunks of 125 and 208 queries)
VARIANTS = {"gemma3-1b": (8, 625), "qwen1.5-4b": (2, 33),
            "internlm2-20b": (2, 33), "musicgen-medium": (2, 33),
            "internvl2-2b": (2, 33),
            # two (rglru, rglru, local) repeats on 2175-token prompts, past
            # the 2048 window (2176 and 2175 split into whole chunks of 136
            # and 145 queries)
            "recurrentgemma-9b": (6, 2176)}
SERVED_VARIANT = "gemma3-1b"    # served at its published widths (phase 5b)
# the MoE architectures: olmoe-1b-7b served at its published widths (phase
# 5c); phase 3 holds the MoE FFN at its widths at these token counts (the
# decode step's, and the largest dropless one: T*k = 4096); phase 4
# teacher-forces each (arch, layers, int8 experts) at published widths, f32,
# on 4x32-token prompts (4*33*k <= 4096: both prefills dropless)
MOE_ARCH = "olmoe-1b-7b"
MOE_TOKENS = (8, 512)
MOE_VARIANTS = (("olmoe-1b-7b", 4, False), ("moonshot-v1-16b-a3b", 2, False),
                ("olmoe-1b-7b", 4, True))
MOE_RANGE = "moe_ffn"           # phase 6c's profiler range around the MoE FFN
# the int8 KV cache: phase 3 holds the int8 mode at these (label, B, S, H,
# KV, D): phi4-mini's serving shape, gemma3-1b's global layer, olmoe-1b-7b's
# G 1, and the measurement path's widest batch and length; phase 6d times
# phi4-mini's replayed step at B 8 over caches of LONG_S positions, in bf16
# and in int8
INT8_SHAPES = (("phi4-mini-3.8b", BATCH, CACHE, HEADS, KV_HEADS, HEAD_DIM),
               ("gemma3-1b global", BATCH, CACHE, 4, 1, 256),
               ("olmoe-1b-7b", BATCH, CACHE, 16, 16, 128),
               (f"B {GRID_B} S {GRID_S}", GRID_B, GRID_S, HEADS, KV_HEADS,
                HEAD_DIM))
LONG_S = 32768
# recurrentgemma-9b, served at its published widths (phase 5e): its
# flash-decode has 16 query heads on 1 KV head of 256, two head groups of 8
# in the split pass.  Phase 3 holds flash-decode, the fused kernel and the
# int8 mode at these (label, H, KV, D, S), B 8: its shape at 512 rows (the
# serving cache) and over the whole 2048-row window, a group of 12 (two of
# 6) and head dim 8 (a bf16 row one 16-byte copy; not in the int8 mode);
# phase 6 times its shape beside 8 heads on the same K/V (one group)
HYBRID_ARCH = "recurrentgemma-9b"
# mamba2-2.7b, attention-free (no LoRA, none of the kernels): phase 4
# teacher-forces it at its published widths, f32, its depth cut to these
# layers, on 4 x SSM_TF_S tokens (512 positions: two chunks of 256; 513:
# three of 171); phase 5f serves it at its published widths
SSM_ARCH = "mamba2-2.7b"
SSM_TF_LAYERS, SSM_TF_S = 4, 513
# a head dim without an instance (H, KV, D), timed in phase 6 at B 8 over
# CACHE positions: 96, a public head dim, on the 128 instance, padded
PADDED_SHAPE = (32, 32, 96)
# head dims past 256 (the wide path), held in phase 3 in every mode; phase
# 6 times one (H, KV, D) of them at B 8 over CACHE positions
WIDE_DIMS = (257, 320, 384, 512, 576, 1024)
WIDE_SHAPE = (16, 4, 512)
HEAD_GROUP_SHAPES = (("recurrentgemma-9b", 16, 1, 256, CACHE),
                     ("recurrentgemma-9b window", 16, 1, 256, 2048),
                     ("G 12", 24, 2, 128, CACHE), ("D 8", 8, 2, 8, CACHE),
                     ("G 24", 24, 1, 256, CACHE), ("D 200", 16, 1, 200, CACHE))
# the split kernel of a bf16 call at head dims 129..256: an instance of the
# 256 one, whose code is the tensor-core pass split_mma_d256 (plain, fused,
# log-sum-exp; padded), by its demangled or its mangled name
D256_SPLIT = re.compile(r"fd_split(?:_pad)?_kernel(?:<__nv_bfloat16,\s*"
                        r"(?:\(int\))?256\b|I13__nv_bfloat16Li256E)")
# training (phase 8): phi4-mini-3.8b at its published widths.  8a: its
# depth cut to TRAIN_CHECK_LAYERS, f32, one step of TRAIN_CHECK_BATCH
# (rows, tokens) in TRAIN_CHECK_MICRO microbatches on the card against the
# same step on the CPU; 8b: all 32 layers, bf16, TRAIN_STEPS steps of
# TRAIN_BATCH at lr TRAIN_LR with one warmup step
TRAIN_ARCH = "phi4-mini-3.8b"
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_MICRO = 2, (2, 128), 2
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = (2, 512), 8, 3e-4
# phase 9: TRAIN_CHECK_LAYERS layers in bf16, CKPT_STEPS steps of
# TRAIN_BATCH, a checkpoint every CKPT_EVERY steps (the last CKPT_KEEP
# kept), a crash injected at step CKPT_FAIL; the launcher run to each of
# LAUNCH_STEPS on one directory, a checkpoint every LAUNCH_EVERY steps
CKPT_STEPS, CKPT_EVERY, CKPT_KEEP, CKPT_FAIL = 6, 3, 2, 4
LAUNCH_STEPS, LAUNCH_EVERY = (20, 30), 10
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
# phase 10, the sharded decode.  10a holds flash-decode's log-sum-exp mode
# at these (label, H, KV, D), B 8 over CACHE positions, beside phi4-mini's
# serving shape: olmoe-1b-7b's (10d's planned path, one query head per KV
# head), head groups (recurrentgemma-9b's 16 heads on 1 KV head of
# 256), a padded head dim (96 on the 128 instance) and the wide path (512);
# 10b cuts phi4-mini's LONG_S cache (phase 6d's) into SHARD_SLICES
# sequence slices; 10c decodes phi4-mini at its published widths under the
# world-size-1 plan over SHARD_CACHE positions, SHARD_STEPS steps after a
# prompt of the rest
LSE_SHAPES = (("phi4-mini-3.8b", HEADS, KV_HEADS, HEAD_DIM),
              ("olmoe-1b-7b", 16, 16, 128),
              ("head groups", 16, 1, 256), ("padded D 96", 32, 32, 96),
              ("wide D 512", 16, 4, 512))
SHARD_SLICES = 4
SHARD_CACHE, SHARD_STEPS = 512, 4
# 10d decodes these at their published widths under the same plan, their
# depth cut to the layers given (None: all of them), and holds each
# planned path to launching exactly these kernels: olmoe's 16 layers
# (BGMV and the log-sum-exp mode on its sequence-sharded caches), 16 of
# mamba2's 64 (no attention, no LoRA: none), 6 of recurrentgemma's 38
# (two (rglru, rglru, local) repeats: BGMV and plain flash-decode on the
# local layers' replicated rolling buffers)
PLANNED_ARCHS = (("olmoe-1b-7b", None), ("mamba2-2.7b", 16),
                 ("recurrentgemma-9b", 6))
PLANNED_KERNELS = {"olmoe-1b-7b": ("bgmv", "flash_decode_lse"),
                   "mamba2-2.7b": (),
                   "recurrentgemma-9b": ("bgmv", "flash_decode")}
PLANNED_BUDGET_S = 120
# 10e prefills BATCH x PREFILL_S tokens of phi4-mini under the world-size-1
# prefill plan (phase 3 holds SGMV with whole-prompt arrival ranks at this
# prompt's shape, ARRIVAL_SLICES sequence slices of it)
PREFILL_S, ARRIVAL_SLICES = 512, 4
PREFILL_BUDGET_S = 90
# the log-sum-exp mode's two kernels: the split pass and its own combine
FD_LSE_KERNELS = ("fd_split_kernel", "fd_combine_lse_kernel")
# 10f trains these at their published widths (bf16, depth cut to the
# layers given; None: all) TRAIN_PLAN_STEPS steps of TRAIN_BATCH under the
# world-size-1 train plan against the same steps without a plan, each
# step's loss and gradient norm within TRAIN_PLAN_TOL (relative)
TRAIN_PLAN_ARCHS = (("phi4-mini-3.8b", None), ("mamba2-2.7b", 16))
TRAIN_PLAN_STEPS, TRAIN_PLAN_TOL, TRAIN_PLAN_BUDGET_S = 3, 2e-4, 120
# phase 11 syncs phi4-mini's gradients COMPRESS_CALLS times, the residual
# carried, and runs the last call's COMPRESS_CPU_LEAVES largest leaves
# again on the host
COMPRESS_CALLS, COMPRESS_CPU_LEAVES, COMPRESS_BUDGET_S = 3, 2, 60
# phase 12 runs phase 9's loop under the world-size-1 train plan; a save
# may grow the card's allocated memory by its largest leaf, rounded up to
# the allocator's 2 MiB
CKPT_PLAN_BUDGET_S, ALLOC_SLACK = 120, 2 << 20
# phase 13, the dry-run's cells: 13a builds every (architecture x
# applicable shape x CELL_MESHES mesh) cell on meta, CELL_COUNT of them;
# 13b runs, whole on the card, each decode cell whose whole arguments take
# at most CELL_ROOM of the card's memory (a decode step's temporaries are
# a layer's activations of B rows; a prefill or train cell also holds the
# whole batch's activations, B x S x d a layer, which ``cell_bytes`` does
# not count), CELL_STEPS eager steps from ``pos`` CELL_TAIL short of the
# cache's end; 13c holds BGMV at CELL_TOKENS tokens and flash-decode at
# 13b's shapes against their plain versions and times them
CELL_MESHES = {"pod1": ((16, 16), ("data", "model")),
               "pod2": ((2, 16, 16), ("pod", "data", "model"))}
CELL_COUNT, CELL_ROOM, CELL_STEPS, CELL_TAIL = 66, 0.5, 3, 16
CELL_TOKENS, CELLS_BUDGET_S = (128, 1), 180
# phase 14, the dry-run's records: 14b runs the hill-climb's DRYRUN_VARIANT
# of DRYRUN_VARIANT_CELL whole on the card; 14c counts DRYRUN_META_CELLS,
# one of each step kind, on both production meshes on meta, by the probes
DRYRUN_VARIANT, DRYRUN_VARIANT_CELL = "kv_int8", ("gemma3_1b", "decode_32k")
DRYRUN_META_CELLS = (("mamba2_2p7b", "train_4k"),
                     ("gemma3_1b", "prefill_32k"), ("gemma3_1b", "decode_32k"))
DRYRUN_BUDGET_S = 90


def say(*parts) -> None:
    print(*parts, flush=True)


# --------------------------------------------------------------------------- #
# phase 3: each kernel against its plain version
# --------------------------------------------------------------------------- #

class Inputs:
    """Seeded draws on the card."""

    def __init__(self, seed: int):
        self.gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(self, *shape, dtype, std=1.0):
        t = torch.randn(shape, generator=self.gen, device="cuda")
        return (t * std).to(dtype)

    def lora_bank(self, n, d, r, o, dtype):
        return (self.normal(n, d, r, dtype=dtype, std=d ** -0.5),
                self.normal(n, r, o, dtype=dtype, std=r ** -0.5))


def held(got, want, dtype_name, per_row=False):
    """Elementwise to TOL, absolute and relative; with ``per_row`` each
    output row (last axis) also to ROW_TOL of its own largest magnitude.
    Returns whether it held, the largest departure and the largest
    row-relative one (0 without ``per_row``)."""
    diff = (got.float() - want.float()).abs()
    tol = TOL[dtype_name]
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    rel = 0.0
    if per_row:
        scale = want.float().abs().amax(-1).clamp(min=1e-30)
        rel = (diff.amax(-1) / scale).max().item()
        ok = ok and rel <= ROW_TOL[dtype_name]
    return ok, diff.max().item(), rel


def check(name, got, want, dtype_name, errs, exact=False, per_row=False):
    """``held``, printed; ``exact``: bit for bit."""
    torch.cuda.synchronize()
    if exact:
        ok, how = torch.equal(got, want), "bitwise"
        err = (got.float() - want.float()).abs().max().item()
    else:
        ok, err, rel = held(got, want, dtype_name, per_row)
        how = f"tol={TOL[dtype_name]}"
        if per_row:
            how += f", row-relative {rel:.3e} (tol={ROW_TOL[dtype_name]})"
    say(f"  {name} [{dtype_name}] max_abs_err={err:.3e} {how} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} [{dtype_name}] disagrees with its plain "
                             f"version: max_abs_err={err}")
    kernel = name.split()[0]
    errs[kernel] = max(errs.get(kernel, 0.0), err)


def phase_kernels():
    from repro_torch.kernels import bgmv, flash_decode, ref, sgmv
    errs = {}
    inp = Inputs(seed=1)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        ids = torch.tensor([0, 1, 2, 3, -1, 0, 1, 2], dtype=torch.int32,
                           device="cuda")
        x = inp.normal(BATCH, D_MODEL, dtype=dtype)
        for o in (Q_OUT, V_OUT):
            a, b = inp.lora_bank(SLOTS, D_MODEL, RANK, o, dtype)
            check(f"bgmv o={o}", bgmv.bgmv(x, a, b, ids),
                  bgmv.bgmv_plain(x, a, b, ids), dn, errs)

        x = inp.normal(PREFILL_T, D_MODEL, dtype=dtype)
        a, b = inp.lora_bank(SLOTS, D_MODEL, RANK, Q_OUT, dtype)
        ids = torch.randint(-1, SLOTS, (PREFILL_T,), generator=inp.gen,
                            device="cuda", dtype=torch.int32)
        check("sgmv dense", sgmv.sgmv(x, a, b, ids),
              ref.sgmv_ref(x, a, b, ids), dn, errs)
        ranks = torch.tensor([8, 3, 5, 1], dtype=torch.int32, device="cuda")
        ragged = sgmv.sgmv(x, a, b, ids, ranks=ranks)
        check("sgmv ragged", ragged, ref.sgmv_ref(x, a, b, ids, ranks=ranks),
              dn, errs)
        am, bm = ref.mask_ragged(a, b, ranks)
        check("sgmv ragged vs dense on the masked bank", ragged,
              sgmv.sgmv(x, am, bm, ids), dn, errs, exact=True)
        same = torch.zeros(PREFILL_T, dtype=torch.int32, device="cuda")
        over = sgmv.sgmv(x, a, b, same)
        cap = ref.sgmv_capacity(PREFILL_T, SLOTS)
        check(f"sgmv overflow (cap {cap})", over,
              ref.sgmv_ref(x, a, b, same), dn, errs)
        if not (bool((over[cap:] == 0).all()) and bool(over[:cap].any())):
            raise AssertionError("sgmv: tokens past capacity must get 0")
        skew = check_sgmv_skewed(inp, x, dtype, dn, errs)
        for name, i, n in (("random ids", ids, SLOTS),
                           ("one adapter", same, SLOTS),
                           (f"N {GRID_N} skewed", skew, GRID_N)):
            check(f"sgmv sort kernel, {name}",
                  torch.cat(sgmv.segments(i, n)),
                  torch.cat(sgmv.segments_plain(i, n)), dn, errs, exact=True)

        q = inp.normal(BATCH, HEADS, HEAD_DIM, dtype=dtype)
        k = inp.normal(BATCH, CACHE, KV_HEADS, HEAD_DIM, dtype=dtype)
        v = inp.normal(BATCH, CACHE, KV_HEADS, HEAD_DIM, dtype=dtype)
        lengths = torch.tensor([1, 64, 100, 257, 300, 480, 512, 600],
                               dtype=torch.int32, device="cuda")
        check("flash_decode ragged lengths",
              flash_decode.flash_decode(q, k, v, lengths),
              flash_decode.flash_decode_plain(q, k, v, lengths), dn, errs,
              per_row=True)
        check("flash_decode length 0", flash_decode.flash_decode(q, k, v, 0),
              torch.zeros_like(q), dn, errs, exact=True)
        check_fused(inp, q, k, v, lengths, dtype, dn, errs)
        check_variant_shapes(inp, lengths, dtype, dn, errs)
    del q, k, v
    check_sgmv_measure(inp, errs)
    check_sgmv_arrival(inp, errs)
    check_fused_grid(errs)
    check_moe(inp, errs)
    check_quantize_kv(inp, errs)
    check_flash_decode_int8(inp, errs)
    check_long(errs)
    check_head_groups(errs)
    check_head_dims(errs)
    check_products_f32(inp)
    return errs


def check_products_f32(inp):
    """The products the JAX package keeps in f32 (``layers.matmul_f32``:
    cuBLAS's ``out_dtype`` overload, the bf16 weights read as they are) at
    phi4-mini's decode shapes: T 8 rows of the MLP's gate and up (d 3072 ->
    8192) and the untied logits (-> 200192), each against the f32 product
    of the bf16 values on the card (TF32 off) within a relative error of
    1e-5 (max |got - want| / max |want|); each timed (``graph_ms``)
    beside the bf16 product cast after (the port before this check's
    products) and the product of both operands upcast."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    cfg = get_config("phi4-mini-3.8b")
    x = inp.normal(BATCH, cfg.d_model, dtype=torch.bfloat16)
    for name, width in (("mlp gate", cfg.d_ff), ("mlp up", cfg.d_ff),
                        ("logits", layers.pad_vocab(cfg.vocab_size))):
        w = inp.normal(cfg.d_model, width, dtype=torch.bfloat16,
                       std=cfg.d_model ** -0.5)
        got = layers.matmul_f32(x, w)
        want = x.float() @ w.float()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        ok = got.dtype == torch.float32 and rel <= 1e-5
        # a second weight where one fits the 50 MB L2
        sets = [(x, w), (x, w.clone())] if w.nbytes <= 64e6 else [(x, w)]
        times = [graph_ms(fn, sets, calls=8) for fn in (
            layers.matmul_f32, lambda a, b: (a @ b).float(),
            lambda a, b: a.float() @ b.float())]
        say(f"  matmul_f32 {name} ({BATCH}x{cfg.d_model} @ {cfg.d_model}x"
            f"{width}) rel {rel:.3e} (tol 1e-5) -> {'ok' if ok else 'FAIL'};"
            f" {times[0] * 1e3:.2f} us (bf16 product cast after "
            f"{times[1] * 1e3:.2f}, both operands upcast "
            f"{times[2] * 1e3:.2f})")
        if not ok:
            raise AssertionError(f"matmul_f32 {name}: rel {rel}")
        del w, got, want, sets


def int8_cache(inp, bsz, s, kv, d):
    """An int8 K or V cache and its f16 scales: ``quantize_kv`` of bf16
    normals."""
    from repro_torch.models.attention import quantize_kv
    return quantize_kv(inp.normal(bsz, s, kv, d, dtype=torch.bfloat16))


def check_int8(name, got, q, k, v, length, ks, vs, errs):
    """The int8 mode's output ``got`` against ``flash_decode_int8_plain``
    at the tolerance of q's dtype, per row.  q in bf16 at bf16's: the
    kernel rounds P times v_scale to bf16 against each split's running
    max, the plain version against the row's.  q in f32 at f32's 2e-5
    against the plain version with ``exact_dot``: a pre-pass gives the
    kernel the row's max and both take q . k's exact f32 value, so both
    round the same terms; its largest departure is kept as ``f32q_int8``.
    Against the plain version that sums q . k in the einsum's f32 order
    (the JAX package's arithmetic, its order XLA's), the terms within
    that order's rounding of a bf16 rounding boundary round the other way:
    there each value must lie within 2e-5 plus the plain version's own
    departure between its two sums (``f32q_int8_vs_f32_dot`` keeps the
    largest departure)."""
    from repro_torch.kernels import flash_decode
    plain = flash_decode.flash_decode_int8_plain
    if q.dtype == torch.bfloat16:
        check(name, got, plain(q, k, v, length, ks, vs), "bfloat16", errs,
              per_row=True)
        return
    exact = plain(q, k, v, length, ks, vs, exact_dot=True)
    check(f"{name} vs exact q.k", got, exact, "float32", errs, per_row=True)
    errs["f32q_int8"] = max(errs.get("f32q_int8", 0.0),
                            (got - exact).abs().max().item())
    want = plain(q, k, v, length, ks, vs)
    flips = (exact - want).abs()
    diff = (got - want).abs()
    tol = TOL["float32"]
    past = diff > tol + tol * want.abs()
    ok = bool((diff <= tol + tol * want.abs() + flips).all())
    say(f"    vs the einsum-order q.k: max_abs_err={diff.max().item():.3e}, "
        f"{int(past.sum())} of {diff.numel()} values past 2e-5, each within "
        f"the plain version's own departure between the two sums "
        f"(largest {flips.max().item():.3e}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: a departure from the einsum-order "
                             "plain version that its rounding flips do not "
                             "cover")
    errs["f32q_int8_vs_f32_dot"] = max(errs.get("f32q_int8_vs_f32_dot", 0.0),
                                       diff.max().item())


def check_quantize_kv(inp, errs):
    """``quantize_kv`` on the card bit for bit its CPU result, on bf16 and
    f32 K/V of phi4-mini's serving shape (a row of zeros among them)."""
    from repro_torch.models.attention import quantize_kv
    for dtype in (torch.bfloat16, torch.float32):
        x = inp.normal(BATCH, CACHE, KV_HEADS, HEAD_DIM, dtype=dtype,
                       std=3.0)
        x[0, 0, 0] = 0
        q, sc = quantize_kv(x)
        want_q, want_s = quantize_kv(x.cpu())
        dn = str(dtype).split(".")[1]
        check("quantize_kv int8 values, card vs CPU", q.cpu(), want_q, dn,
              errs, exact=True)
        check("quantize_kv f16 scales, card vs CPU", sc.cpu(), want_s, dn,
              errs, exact=True)


def check_flash_decode_int8(inp, errs):
    """The int8 mode against ``flash_decode_int8_plain`` at each of
    ``INT8_SHAPES``, q in bf16 and in f32, at the tolerance of q's dtype
    (``check_int8``): the full cache, ragged lengths (0 and 1 among them,
    others ending inside tiles) on a cache whose positions past each row's
    length hold other int8 values and scales (finite), which must give the
    output of the clean cache bit for bit, and length 0 (exactly 0)."""
    from repro_torch.kernels import flash_decode
    fd = flash_decode.flash_decode
    for label, bsz, s, h, kv, d in INT8_SHAPES:
        k, ks = int8_cache(inp, bsz, s, kv, d)
        v, vs = int8_cache(inp, bsz, s, kv, d)
        tile = flash_decode.tile_positions(d, 1)
        ragged = torch.randint(0, s + 1, (bsz,), generator=inp.gen,
                               device="cuda", dtype=torch.int32)
        ragged[:5] = torch.tensor([0, 1, tile - 1, tile + 1, s],
                                  device="cuda")
        past = torch.arange(s, device="cuda")[None, :] >= ragged[:, None]
        dirty = [t.clone() for t in (k, v, ks, vs)]
        for t in dirty[:2]:
            t[past] = torch.randint(-127, 128, t[past].shape,
                                    generator=inp.gen, device="cuda",
                                    dtype=torch.int8)
        for t in dirty[2:]:
            t[past] = (torch.rand(t[past].shape, generator=inp.gen,
                                  device="cuda") * 4 + 0.01).half()
        for qdt in (torch.bfloat16, torch.float32):
            qn = str(qdt).split(".")[1]
            q = inp.normal(bsz, h, d, dtype=qdt)
            name = f"flash_decode_int8 {label} H {h} KV {kv} D {d} q {qn}"
            check_int8(f"{name} full", fd(q, k, v, s, ks, vs), q, k, v, s,
                       ks, vs, errs)
            got = fd(q, *dirty[:2], ragged, *dirty[2:])
            check_int8(f"{name} ragged, garbage past the lengths", got, q,
                       *dirty[:2], ragged, *dirty[2:], errs)
            check(f"{name} ragged, garbage vs clean cache", got,
                  fd(q, k, v, ragged, ks, vs), qn, errs, exact=True)
            check(f"{name} length 0", fd(q, k, v, 0, ks, vs),
                  torch.zeros_like(q), qn, errs, exact=True)
        del k, v, ks, vs, dirty
        torch.cuda.empty_cache()


def check_long(errs):
    """Flash-decode at phi4-mini's heads over LONG_S positions (B 8), the
    caches phase 6d decodes over: the bf16 kernel (whose split plan had not
    run past 4096 positions on the card) and the int8 mode against their
    plain versions, full and ragged lengths."""
    from repro_torch.kernels import flash_decode
    inp = Inputs(seed=6)
    ragged = torch.randint(1, LONG_S + 1, (BATCH,), generator=inp.gen,
                           device="cuda", dtype=torch.int32)
    ragged[:2] = torch.tensor([LONG_S - 1, 1], device="cuda")
    q = inp.normal(BATCH, HEADS, HEAD_DIM, dtype=torch.bfloat16)
    k = inp.normal(BATCH, LONG_S, KV_HEADS, HEAD_DIM, dtype=torch.bfloat16)
    v = inp.normal(BATCH, LONG_S, KV_HEADS, HEAD_DIM, dtype=torch.bfloat16)
    for name, length in (("full", LONG_S), ("ragged", ragged)):
        check(f"flash_decode B {BATCH} S {LONG_S} {name} lengths",
              flash_decode.flash_decode(q, k, v, length),
              flash_decode.flash_decode_plain(q, k, v, length), "bfloat16",
              errs, per_row=True)
    from repro_torch.models.attention import quantize_kv
    (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
    for name, length in (("full", LONG_S), ("ragged", ragged)):
        check_int8(f"flash_decode_int8 B {BATCH} S {LONG_S} {name} lengths",
                   flash_decode.flash_decode(q, k, v, length, ks, vs), q, k,
                   v, length, ks, vs, errs)
    del k, v, ks, vs
    torch.cuda.empty_cache()


def check_head_groups(errs):
    """Flash-decode, the fused kernel and the int8 mode past 8 query heads
    per KV head, and flash-decode at head dim 8 (``HEAD_GROUP_SHAPES``, B
    8): q, K and V in bf16 and f32, ragged lengths (0, 1, a tile's edges,
    the whole cache, past it) held per row; the fused kernel with ids with
    -1 at both delta sizes and bitwise flash-decode on an all-base batch;
    the int8 mode with q in bf16 and f32 (``check_int8``; head dim 8 on
    its 16 instance, padded)."""
    from repro_torch.kernels import flash_decode
    inp = Inputs(seed=9)
    fd, fused = flash_decode.flash_decode, flash_decode.flash_decode_lora
    ids = torch.tensor([0, 1, 2, 3, -1, 0, -1, 2], dtype=torch.int32,
                       device="cuda")
    for label, h, kv, d, s in HEAD_GROUP_SHAPES:
        name = f"{label} H {h} KV {kv} D {d} S {s}"
        tile = flash_decode.tile_positions(d, 2)
        lengths = torch.tensor([0, 1, tile - 1, tile + 1, s // 2 + 3, s - 1,
                                s, s + 40], dtype=torch.int32, device="cuda")
        dx = 4096 if h == 16 else 1024
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            q = inp.normal(BATCH, h, d, dtype=dtype)
            k = inp.normal(BATCH, s, kv, d, dtype=dtype)
            v = inp.normal(BATCH, s, kv, d, dtype=dtype)
            check(f"flash_decode {name} ragged lengths", fd(q, k, v, lengths),
                  flash_decode.flash_decode_plain(q, k, v, lengths), dn, errs,
                  per_row=True)
            x = inp.normal(BATCH, dx, dtype=dtype)
            a, b = inp.lora_bank(SLOTS, dx, RANK, h * d, dtype)
            for size, scale in FUSED_SCALES.items():
                check(f"flash_decode_lora {name} ids with -1, {size}",
                      fused(q, k, v, lengths, x, a, b, ids, scale),
                      flash_decode.flash_decode_lora_plain(
                          q, k, v, lengths, x, a, b, ids, scale), dn, errs,
                      per_row=True)
            check(f"flash_decode_lora {name} all-base vs flash_decode",
                  fused(q, k, v, lengths, x, a, b, torch.full_like(ids, -1)),
                  fd(q, k, v, lengths), dn, errs, exact=True)
            if dtype == torch.bfloat16 and \
                    flash_decode.mma256_pass(d, dtype, 2):
                check_d256_lse(name, q, k, v, lengths, errs)
                # the split kernel's name: plain at each shape, the fused
                # and log-sum-exp calls at the first
                calls = [("flash_decode", fd, (q, k, v, lengths))]
                if label == HEAD_GROUP_SHAPES[0][0]:
                    calls += [("flash_decode_lora", fused,
                               (q, k, v, lengths, x, a, b, ids)),
                              ("flash_decode_lse",
                               flash_decode.flash_decode_lse,
                               (q, k, v, lengths))]
                for label_, fn, args in calls:
                    require_d256_pass(f"{label_} {name}", fn, args)
        (k, ks), (v, vs) = (int8_cache(inp, BATCH, s, kv, d)
                            for _ in range(2))
        for qdt in (torch.bfloat16, torch.float32):
            q = inp.normal(BATCH, h, d, dtype=qdt)
            check_int8(f"flash_decode_int8 {name} q "
                       f"{str(qdt).split('.')[1]} ragged lengths",
                       fd(q, k, v, lengths, ks, vs), q, k, v, lengths, ks,
                       vs, errs)
    torch.cuda.empty_cache()


def check_d256_lse(name, q, k, v, lengths, errs):
    """The log-sum-exp mode in bf16 on the tensor-core pass at D 256 (or
    padded onto it): its f32 output rounded to bf16 bit for bit the call
    without it, and output and log-sum-exp against the plain version's at
    bf16's tolerance (the output per row)."""
    from repro_torch.kernels import flash_decode
    out, lse = flash_decode.flash_decode_lse(q, k, v, lengths)
    check(f"flash_decode_lse {name} out in bfloat16, the call without it",
          out.to(q.dtype), flash_decode.flash_decode(q, k, v, lengths),
          "bfloat16", errs, exact=True)
    want, want_lse = flash_decode.flash_decode_plain(q, k, v, lengths,
                                                     return_lse=True)
    check(f"flash_decode_lse {name} out", out, want, "bfloat16", errs,
          per_row=True)
    check_lse_values(f"flash_decode_lse {name} lse", lse, want_lse,
                     "bfloat16", errs)


def require_d256_pass(label, fn, args):
    """That one call ``fn(*args)`` (bf16, a head dim 129..256) launches the
    tensor-core pass at D 256: its split kernel, named by the profiler, is
    an instance of the 256 bf16 one (``D256_SPLIT``), whose only code is
    ``split_mma_d256``.  A profile that records no split kernel is taken
    once more; after two, the line starts with ``PROFILER_EMPTY_SESSION``
    and nothing is held."""
    fn(*args)
    torch.cuda.synchronize()
    names = []
    for _ in range(2):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and "fd_split" in e.key})
        if names:
            break
    if not names:
        say(f"PROFILER_EMPTY_SESSION {label}: no split kernel recorded")
        return
    ok = any(D256_SPLIT.search(n) for n in names)
    say(f"  {label}: split kernel {names[0][:80]} -> the tensor-core pass "
        f"at D 256: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: split kernel {names} is not the "
                             "bf16 pass at D 256")


def check_head_dims(errs):
    """Flash-decode, the fused kernel and the int8 mode at every head dim
    1..256 (one without an instance runs the next larger one, padded) and
    at WIDE_DIMS (past 256: the wide path): B
    4, S 300, 2 KV heads and 1, 4 or 16 query heads a KV head by turns
    (16: two head groups), lengths 0, 1, one past a tile and S; q, K and V
    in bf16 and f32, the int8 mode with q in bf16 and f32 on
    ``quantize_kv`` of bf16 K/V; each held per row at the tolerance of q's
    dtype (the int8 mode with q in f32 against the plain version with
    exact q . k, as ``check_int8``; with q in bf16 below D 8 elementwise
    only), the fused kernel with ids with -1, bitwise flash-decode on its
    base rows.  One line per kernel, dtype and path (instances, wide): the
    dims held and the largest departure, with its dim; a departure past
    the tolerance raises."""
    from repro_torch.kernels import flash_decode
    inp = Inputs(seed=10)
    fd, fused = flash_decode.flash_decode, flash_decode.flash_decode_lora
    bsz, kv, s, dx = 4, 2, 300, 64
    ids = torch.tensor([0, -1, 1, 2], dtype=torch.int32, device="cuda")
    worst = {}
    for d in list(range(1, flash_decode.MAX_INSTANCE_DIM + 1)) + \
            list(WIDE_DIMS):
        h = kv * (1, 4, 16)[d % 3]
        cases = []
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            tile = flash_decode.tile_positions(d, 2 if dn == "bfloat16"
                                               else 4)
            lengths = torch.tensor([0, 1, tile + 1, s], dtype=torch.int32,
                                   device="cuda")
            q = inp.normal(bsz, h, d, dtype=dtype)
            k = inp.normal(bsz, s, kv, d, dtype=dtype)
            v = inp.normal(bsz, s, kv, d, dtype=dtype)
            attn = fd(q, k, v, lengths)
            cases.append(("flash_decode", dn, attn,
                          flash_decode.flash_decode_plain(q, k, v, lengths)))
            x = inp.normal(bsz, dx, dtype=dtype)
            a, b = inp.lora_bank(SLOTS, dx, RANK, h * d, dtype)
            got = fused(q, k, v, lengths, x, a, b, ids, 0.5)
            cases.append(("flash_decode_lora", dn, got,
                          flash_decode.flash_decode_lora_plain(
                              q, k, v, lengths, x, a, b, ids, 0.5)))
            if not torch.equal(got[1], attn[1]):
                raise AssertionError(f"flash_decode_lora at D {d} [{dn}]: "
                                     "a base row is not flash-decode's")
            (k8, ks), (v8, vs) = (int8_cache(inp, bsz, s, kv, d)
                                  for _ in range(2))
            lengths = torch.tensor([0, 1, flash_decode.tile_positions(d, 1)
                                    + 1, s], dtype=torch.int32, device="cuda")
            cases.append(("flash_decode_int8", dn,
                          fd(q, k8, v8, lengths, ks, vs),
                          flash_decode.flash_decode_int8_plain(
                              q, k8, v8, lengths, ks, vs,
                              exact_dot=dtype == torch.float32)))
        torch.cuda.synchronize()
        for name, dn, got, want in cases:
            # a row of fewer than 8 values can have as its largest a sum
            # that cancels, against which the int8 mode's bf16 rounding
            # with q in bf16 (each split's max) is not small: elementwise
            ok, err, rel = held(got, want, dn, per_row=d >= 8
                                or dn == "float32"
                                or name != "flash_decode_int8")
            if not ok:
                raise AssertionError(
                    f"{name} at D {d}, H {h}, KV {kv} [{dn}] disagrees with "
                    f"its plain version: max_abs_err={err}, row-relative "
                    f"{rel}")
            w = worst.setdefault((name, dn, flash_decode.is_wide(d)),
                                 [0.0, 0, 0.0])
            if err >= w[0]:
                w[:2] = err, d
            w[2] = max(w[2], rel)
            errs[name] = max(errs.get(name, 0.0), err)
            if name == "flash_decode_int8" and dn == "float32":
                errs["f32q_int8"] = max(errs.get("f32q_int8", 0.0), err)
    for (name, dn, wide), (err, d, rel) in worst.items():
        exact = (" (vs the plain version with exact q.k)"
                 if name == "flash_decode_int8" and dn == "float32" else "")
        dims = (f"head dims {', '.join(map(str, WIDE_DIMS))} (wide path)"
                if wide else
                f"every head dim 1..{flash_decode.MAX_INSTANCE_DIM}")
        say(f"  {name} {dims} [{dn}]{exact} max_abs_err={err:.3e} (at D "
            f"{d}), row-relative {rel:.3e} (tol={TOL[dn]}, row "
            f"{ROW_TOL[dn]}) -> ok")
    torch.cuda.empty_cache()


def check_moe(inp, errs):
    """The MoE FFN (``moe.apply_moe``: routing, dispatch into the (E, C, d)
    buffer, the expert products, the combine) against its dropless oracle
    ``apply_moe_ref`` at olmoe-1b-7b's published widths (d 2048, 64
    experts of 1024, top-8), bf16, x ~ N(0, 1) as after the norm, at each
    of ``MOE_TOKENS``; the aux loss finite."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(MOE_ARCH)
    kw = dict(top_k=cfg.top_k, n_experts=cfg.n_experts)
    p = moe.init_moe(inp.gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                     torch.bfloat16, "cuda")
    for t in MOE_TOKENS:
        x = inp.normal(t, cfg.d_model, dtype=torch.bfloat16)
        cap = moe.capacity(t, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        out, aux = moe.apply_moe(p, x, capacity_factor=cfg.capacity_factor,
                                 **kw)
        if not math.isfinite(float(aux)):
            raise AssertionError(f"apply_moe T {t}: aux {float(aux)}")
        check(f"apply_moe {MOE_ARCH} T {t} (capacity {cap}, dropless)",
              out, moe.apply_moe_ref(p, x, **kw), "bfloat16", errs)
    del p
    torch.cuda.empty_cache()


def check_variant_shapes(inp, lengths, dtype, dn, errs):
    """Flash-decode (B 8, S 512, ragged lengths, per row) and BGMV (T 8, the
    q and v projections' widths, N 4, r 8) at each other dense
    architecture's published shapes and olmoe-1b-7b's (16 heads of 128 on
    16 KV heads, d 2048; moonshot's are the same), and SGMV at gemma3's d
    1152, T 1024: gemma3's D 256 with 4 heads on 1 KV head, internlm2's
    group of 6, qwen1.5's, musicgen's and olmoe's group of 1, musicgen's
    D 64."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import bgmv, flash_decode, ref, sgmv
    ids = torch.tensor([0, 1, 2, 3, -1, 0, 1, 2], dtype=torch.int32,
                       device="cuda")
    for arch in (*VARIANTS, MOE_ARCH):
        cfg = get_config(arch)
        h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        q = inp.normal(BATCH, h, d, dtype=dtype)
        k = inp.normal(BATCH, CACHE, kv, d, dtype=dtype)
        v = inp.normal(BATCH, CACHE, kv, d, dtype=dtype)
        check(f"flash_decode {arch} H {h} KV {kv} D {d} ragged lengths",
              flash_decode.flash_decode(q, k, v, lengths),
              flash_decode.flash_decode_plain(q, k, v, lengths), dn, errs,
              per_row=True)
        x = inp.normal(BATCH, cfg.d_model, dtype=dtype)
        for o in (h * d, kv * d):
            a, b = inp.lora_bank(SLOTS, cfg.d_model, RANK, o, dtype)
            check(f"bgmv {arch} d={cfg.d_model} o={o}",
                  bgmv.bgmv(x, a, b, ids), bgmv.bgmv_plain(x, a, b, ids), dn,
                  errs)
    cfg = get_config(SERVED_VARIANT)
    o = cfg.n_heads * cfg.resolved_head_dim
    x = inp.normal(PREFILL_T, cfg.d_model, dtype=dtype)
    a, b = inp.lora_bank(SLOTS, cfg.d_model, RANK, o, dtype)
    t_ids = torch.randint(-1, SLOTS, (PREFILL_T,), generator=inp.gen,
                          device="cuda", dtype=torch.int32)
    check(f"sgmv {SERVED_VARIANT} d={cfg.d_model} o={o} T {PREFILL_T}",
          sgmv.sgmv(x, a, b, t_ids), ref.sgmv_ref(x, a, b, t_ids), dn, errs)


def check_sgmv_skewed(inp, x, dtype, dn, errs):
    """SGMV at the measurement path's adapter count with skew: adapter 5
    past its capacity, adapters 10-31 empty, some ids outside [0, N);
    dense, ragged, and ragged bitwise dense on the masked bank.  Returns
    the ids."""
    from repro_torch.kernels import ref, sgmv
    t, n = x.shape[0], GRID_N
    cap = ref.sgmv_capacity(t, n)
    over = cap + 44
    ids = torch.cat([
        torch.full((over,), 5, device="cuda"),
        torch.randint(0, 10, (t - over - 40,), generator=inp.gen,
                      device="cuda"),
        torch.tensor([-1, n, n + 8, -5] * 10, device="cuda")])
    ids = ids[torch.randperm(t, generator=inp.gen, device="cuda")]
    ids = ids.to(torch.int32)
    a, b = inp.lora_bank(n, D_MODEL, MEASURE_RANK, Q_OUT, dtype)
    got = sgmv.sgmv(x, a, b, ids)
    check(f"sgmv N {n} skewed (cap {cap})", got, ref.sgmv_ref(x, a, b, ids),
          dn, errs)
    fives = torch.nonzero(ids == 5).flatten()
    if not (bool((got[fives[cap:]] == 0).all())
            and bool((got[(ids < 0) | (ids >= n)] == 0).all())):
        raise AssertionError("sgmv: tokens past capacity or without an "
                             "adapter must get 0")
    ranks = torch.randint(1, MEASURE_RANK + 1, (n,), generator=inp.gen,
                          device="cuda", dtype=torch.int32)
    ragged = sgmv.sgmv(x, a, b, ids, ranks=ranks)
    check(f"sgmv N {n} skewed ragged", ragged,
          ref.sgmv_ref(x, a, b, ids, ranks=ranks), dn, errs)
    am, bm = ref.mask_ragged(a, b, ranks)
    check(f"sgmv N {n} skewed ragged vs dense on the masked bank", ragged,
          sgmv.sgmv(x, am, bm, ids), dn, errs, exact=True)
    return ids


def check_sgmv_arrival(inp, errs):
    """SGMV with whole-prompt arrival ranks at the sharded prefill's shape
    (BATCH x PREFILL_S tokens, d 3072, r 8, N 4, bf16), at both LoRA
    widths the prefill gives it (q's Q_OUT and v's V_OUT, which tile
    differently): ids spread over the adapters, and every request on
    adapter 0 (cap 2176 of 4096: 1920 dropped).  On the whole prompt's own
    arrival ranks the call is the one without them, bit for bit; each of
    ARRIVAL_SLICES sequence slices, with its tokens' whole-prompt arrival
    ranks (``sgmv.arrival_ranks``) and capacity, against its rows of the
    plain version of the whole prompt; the slices in the prompt's order
    against the whole prompt: bit for bit, else within bf16's 3e-2
    (printed).  Records in ``errs`` whether the slices were bitwise
    (``sgmv_arrival_bitwise``)."""
    from repro_torch.kernels import ref, sgmv
    dt, dn = torch.bfloat16, "bfloat16"
    t, s_loc = BATCH * PREFILL_S, PREFILL_S // ARRIVAL_SLICES
    cap = ref.sgmv_capacity(t, SLOTS)
    x = inp.normal(t, D_MODEL, dtype=dt)
    x3 = x.reshape(BATCH, PREFILL_S, D_MODEL)
    bitwise = True
    for o in (Q_OUT, V_OUT):
        a, b = inp.lora_bank(SLOTS, D_MODEL, RANK, o, dt)
        for label, ids in (
                ("spread", torch.arange(BATCH, device="cuda") % SLOTS),
                ("one adapter", torch.zeros(BATCH, device="cuda"))):
            label = f"o {o} {label}"
            ids = ids.to(torch.int32)
            per_token = ids.repeat_interleave(PREFILL_S)
            whole = sgmv.sgmv(x, a, b, per_token)
            plain = ref.sgmv_ref(x, a, b, per_token).reshape(
                BATCH, PREFILL_S, o)
            own = ref._bucket_positions(per_token, SLOTS).to(torch.int32)
            check(f"sgmv arrival {label}, whole prompt's own ranks",
                  sgmv.sgmv(x, a, b, per_token, arrival=own), whole, dn,
                  errs, exact=True)
            parts = []
            for i in range(ARRIVAL_SLICES):
                lo = i * s_loc
                arrival = sgmv.arrival_ranks(ids, 0, BATCH, PREFILL_S, lo,
                                             s_loc)
                xp = x3[:, lo:lo + s_loc].reshape(-1, D_MODEL).contiguous()
                tp = ids.repeat_interleave(s_loc)
                got = sgmv.sgmv(xp, a, b, tp, arrival=arrival, cap=cap)
                check(f"sgmv arrival {label}, slice {i} of {ARRIVAL_SLICES}",
                      got, plain[:, lo:lo + s_loc].reshape(-1, o), dn, errs)
                parts.append(got.reshape(BATCH, s_loc, o))
            sliced = torch.stack(parts, 1).reshape(t, o)
            torch.cuda.synchronize()
            same = torch.equal(sliced, whole)
            bitwise = bitwise and same
            dropped = int((per_token >= 0).sum()) - int(
                (ref._bucket_positions(per_token, SLOTS) < cap).sum())
            check(f"sgmv arrival {label}, {ARRIVAL_SLICES} slices against "
                  f"the whole prompt ({dropped} of {t} tokens dropped, "
                  f"bitwise {same})", sliced, whole, dn, errs)
            if "one adapter" in label and not (dropped == t - cap and bool(
                    (whole[cap:] == 0).all()) and bool(whole[:cap].any())):
                raise AssertionError("sgmv arrival: the whole prompt must "
                                     "drop the tokens past its capacity")
    errs["sgmv_arrival_bitwise"] = bitwise


def check_sgmv_measure(inp, errs):
    """SGMV at the measurement path's prefill shapes (``kernels_bench``'s
    pf_grid and its ragged arm): T 512, 2048 and 4096 at N 32, r 16,
    d = o = 3072, ids drawn from [0, N), bf16; dense, ragged (its ranks
    4/8/12), and ragged bitwise dense on the masked bank."""
    from repro_torch.kernels import ref, sgmv
    dt, dn = torch.bfloat16, "bfloat16"
    a, b = inp.lora_bank(GRID_N, D_MODEL, MEASURE_RANK, Q_OUT, dt)
    ranks = ((torch.arange(GRID_N, device="cuda") % 3 + 1)
             * (MEASURE_RANK // 4)).to(torch.int32)
    am, bm = ref.mask_ragged(a, b, ranks)
    for t in MEASURE_TOKENS:
        x = inp.normal(t, D_MODEL, dtype=dt)
        ids = torch.randint(0, GRID_N, (t,), generator=inp.gen,
                            device="cuda", dtype=torch.int32)
        check(f"sgmv T {t} N {GRID_N} r {MEASURE_RANK}",
              sgmv.sgmv(x, a, b, ids), ref.sgmv_ref(x, a, b, ids), dn, errs,
              per_row=True)
        ragged = sgmv.sgmv(x, a, b, ids, ranks=ranks)
        check(f"sgmv T {t} N {GRID_N} ragged", ragged,
              ref.sgmv_ref(x, a, b, ids, ranks=ranks), dn, errs,
              per_row=True)
        check(f"sgmv T {t} N {GRID_N} ragged vs dense on the masked bank",
              ragged, sgmv.sgmv(x, am, bm, ids), dn, errs, exact=True)


def check_fused(inp, q, k, v, lengths, dtype, dn, errs):
    """The fused flash-decode+LoRA kernel at the serving shapes."""
    from repro_torch.kernels import flash_decode, ops, ref
    fd, plain = flash_decode.flash_decode_lora, \
        flash_decode.flash_decode_lora_plain
    x = inp.normal(BATCH, D_MODEL, dtype=dtype)
    ids = torch.tensor([0, 1, 2, 3, -1, 0, -1, 2], dtype=torch.int32,
                       device="cuda")
    a, b = inp.lora_bank(SLOTS, D_MODEL, RANK, HEADS * HEAD_DIM, dtype)
    ranks = torch.tensor(RAGGED_RANKS, dtype=torch.int32, device="cuda")
    am, bm = ref.mask_ragged(a, b, ranks)
    if dtype == torch.bfloat16:
        a32, b32 = inp.lora_bank(SLOTS, D_MODEL, RANK, HEADS * HEAD_DIM,
                                 torch.float32)
    for size, scale in FUSED_SCALES.items():
        check(f"flash_decode_lora ids with -1, {size}",
              fd(q, k, v, lengths, x, a, b, ids, scale),
              plain(q, k, v, lengths, x, a, b, ids, scale), dn, errs,
              per_row=True)
        check(f"flash_decode_lora ragged bank (ops.fused_decode), {size}",
              ops.fused_decode(q, k, v, lengths, x, a, b, ids, scale,
                               ranks=ranks),
              plain(q, k, v, lengths, x, am, bm, ids, scale), dn, errs,
              per_row=True)
        if dtype == torch.bfloat16:
            check(f"flash_decode_lora f32 bank, {size}",
                  fd(q, k, v, lengths, x, a32, b32, ids, scale),
                  plain(q, k, v, lengths, x, a32, b32, ids, scale), dn, errs,
                  per_row=True)
    base = torch.full_like(ids, -1)
    check("flash_decode_lora all-base vs flash_decode",
          fd(q, k, v, lengths, x, a, b, base),
          flash_decode.flash_decode(q, k, v, lengths), dn, errs, exact=True)
    wide = inp.normal(SLOTS, RANK, HEADS * HEAD_DIM + 8, dtype=dtype)
    try:
        fd(q, k, v, lengths, x, a, wide, ids)
    except ValueError as e:
        say(f"  flash_decode_lora expand dim {wide.shape[-1]}: raises ({e})")
    else:
        raise AssertionError("flash_decode_lora took an expand dim != H*D")


def check_fused_grid(errs):
    """The fused kernel at the measurement path's widest points (phase 7):
    batch 32 (768 combine blocks), 4096 positions (the longest split
    plan), 32 adapters and each rank of the grid, on the bf16 inputs that
    ``kernels_bench`` draws there.  Those are all N(0, 1), so the delta is
    about N(0, dx * rank) and hides the attention (about 0.03): each point
    is also held at a scale that shrinks the delta to the attention's
    size.  The errors are kept apart (``flash_decode_lora_grid``): at
    scale 1 the outputs reach about 10^3, where a bf16 step is 4-8."""
    from repro_torch.bench import kernels_bench as kb
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode, ops
    w = kb.Widths.of(get_config("phi4-mini-3.8b"))
    gen = torch.Generator(device="cuda").manual_seed(4)
    for rank in GRID_RANKS:
        q, k, v, x, a, b, idx = kb._decode_data(
            gen, GRID_B, GRID_S, rank, GRID_N, h=w.h, kv=w.kv, d=w.d,
            dx=w.dx)
        if rank == GRID_RANKS[0]:
            # plain flash-decode on the same split plan: the full cache, and
            # ragged lengths that end inside tiles and chunks
            ragged = torch.randint(0, GRID_S + 1, (GRID_B,), generator=gen,
                                   device="cuda", dtype=torch.int32)
            ragged[:4] = torch.tensor([1, 63, 64, GRID_S], device="cuda")
            for name, length in (("full", GRID_S), ("ragged", ragged)):
                check(f"flash_decode B {GRID_B} S {GRID_S} {name} lengths",
                      flash_decode.flash_decode(q, k, v, length),
                      flash_decode.flash_decode_plain(q, k, v, length),
                      "bfloat16", errs, per_row=True)
        for size, scale in (("path's scale 1", 1.0), (
                "attention-sized", 0.05 / math.sqrt(w.dx * rank))):
            check(f"flash_decode_lora_grid B {GRID_B} S {GRID_S} r {rank} "
                  f"N {GRID_N}, {size}",
                  ops.fused_decode(q, k, v, GRID_S, x, a, b, idx, scale),
                  flash_decode.flash_decode_lora_plain(
                      q, k, v, GRID_S, x, a, b, idx, scale),
                  "bfloat16", errs, per_row=True)
        del q, k, v
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# phase 4: teacher forcing at full width
# --------------------------------------------------------------------------- #

def teacher_force(cfg, s, expert_quant=False):
    """Decode after ``prefill(tokens[:, :-1])`` against ``prefill(tokens)``
    on 4 rows of ``s`` seeded tokens (and, for a VLM, seeded image
    embeddings first), 4 adapters, int8 experts with ``expert_quant``: the
    relative error of the logits, and whether the full prefill's logits
    are finite."""
    from repro_torch.models import Model
    model = Model(cfg, device="cuda", seed=0, expert_quant=expert_quant)
    lora = model.init_lora(SLOTS, RANK, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (4, s), generator=gen,
                           device="cuda")
    img = None
    if cfg.n_image_tokens:
        img = torch.randn((4, cfg.n_image_tokens, cfg.d_model),
                          generator=gen, device="cuda")
    ids = torch.arange(4, dtype=torch.int32, device="cuda")   # 4 adapters
    full, _ = model.prefill(lora, tokens, ids, img_embeds=img)
    _, cache = model.prefill(lora, tokens[:, :-1], ids, img_embeds=img)
    dec, _ = model.decode_step(lora, model.pad_cache(cache, 4),
                               tokens[:, -1:], ids)
    rel = ((dec - full).abs().max() / (full.abs().max() + 1e-9)).item()
    return rel, bool(torch.isfinite(full).all())


def phase_parity():
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b"), n_layers=4,
                              dtype="float32")
    rel, finite = teacher_force(cfg, 33)
    ok = finite and rel < 2e-4
    say(f"  teacher forcing, {cfg.n_layers} layers at d={cfg.d_model}, f32: "
        f"rel={rel:.3e} (limit 2e-4) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"teacher forcing: rel={rel}")


def phase_parity_int8(ops):
    """Teacher forcing of phi4-mini (4 layers, published widths, f32) with
    its KV cache in int8 (``Model(kv_quant=True)``): decode after
    ``prefill(tokens[:, :-1])`` against ``prefill(tokens)``, whose attention
    reads the unquantized K/V, within the JAX test's 2e-2
    (tests/test_consistency_int8.py:48); and the same decode with the int8
    mode's plain version in place of the kernel, within 2e-2 too.  Returns
    the launch counts of the kernel run."""
    from unittest import mock
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd_mod
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b"), n_layers=4,
                              dtype="float32")
    model = Model(cfg, device="cuda", seed=0, kv_quant=True)
    lora = model.init_lora(SLOTS, RANK, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (4, 33), generator=gen,
                           device="cuda")
    ids = torch.arange(4, dtype=torch.int32, device="cuda")
    ops.reset_launches()
    full, _ = model.prefill(lora, tokens, ids)
    _, cache = model.prefill(lora, tokens[:, :-1], ids)
    dec, _ = model.decode_step(lora, model.pad_cache(cache, 4),
                               tokens[:, -1:], ids)
    counts = ops.launch_counts()

    def plain(q, k, v, length, k_scale=None, v_scale=None):
        return fd_mod.flash_decode_int8_plain(q, k, v, length, k_scale,
                                              v_scale)
    with mock.patch.object(fd_mod, "flash_decode", plain):
        dec_plain, _ = model.decode_step(lora, model.pad_cache(cache, 4),
                                         tokens[:, -1:], ids)

    def rel(a, b):
        return ((a - b).abs().max() / (b.abs().max() + 1e-9)).item()
    rel_tf, rel_plain = rel(dec, full), rel(dec, dec_plain)
    int8 = cache["layers"][0]["k"].dtype == torch.int8
    ok = (int8 and bool(torch.isfinite(full).all()) and rel_tf < 2e-2
          and rel_plain < 2e-2)
    say(f"  teacher forcing, int8 KV cache, {cfg.n_layers} layers at "
        f"d={cfg.d_model}, f32, prompt 4x32: decode vs prefill rel="
        f"{rel_tf:.3e} (limit 2e-2), kernel vs plain attention rel="
        f"{rel_plain:.3e} (limit 2e-2) -> {'ok' if ok else 'FAIL'}; "
        f"launches {counts}")
    if not ok:
        raise AssertionError(f"int8 teacher forcing: rel {rel_tf}, "
                             f"against the plain attention {rel_plain}")
    require_launched("int8 teacher forcing", counts,
                     PATH_KERNELS["teacher_forcing"])
    del model
    torch.cuda.empty_cache()
    return counts


def phase_parity_variants(ops):
    """Teacher forcing for each of ``VARIANTS`` at its published widths,
    f32, its depth cut, as ``phase_parity`` (internvl2 with its 256 image
    embeddings); the launch counts are zeroed before each and SGMV, BGMV
    and flash-decode must have launched.  Returns the counts summed over
    them."""
    from repro_torch.configs import get_config
    total = dict.fromkeys(ops.launch_counts(), 0)
    for arch, (n_layers, s) in VARIANTS.items():
        published = get_config(arch)
        cfg = dataclasses.replace(published, n_layers=n_layers,
                                  dtype="float32")
        ops.reset_launches()
        rel, finite = teacher_force(cfg, s)
        counts = ops.launch_counts()
        ok = finite and rel < 2e-4
        prompt = f"4x{s - 1}" + (f" after {cfg.n_image_tokens} image "
                                 "embeddings" if cfg.n_image_tokens else "")
        say(f"  teacher forcing {arch}, {n_layers} of {published.n_layers} "
            f"layers ({'/'.join(cfg.layer_kinds)}) at d={cfg.d_model}, f32, "
            f"prompt {prompt}: rel={rel:.3e} (limit 2e-4) -> "
            f"{'ok' if ok else 'FAIL'}; launches {counts}")
        if not ok:
            raise AssertionError(f"teacher forcing {arch}: rel={rel}")
        require_launched(f"{arch} teacher forcing", counts,
                         PATH_KERNELS["teacher_forcing"])
        total = {k: total[k] + n for k, n in counts.items()}
        torch.cuda.empty_cache()
    return total


def phase_parity_moe(ops):
    """Teacher forcing for each of ``MOE_VARIANTS`` at its published
    widths, f32, its depth cut, on 4x32-token prompts, as
    ``phase_parity_variants``.  Returns the counts summed over them."""
    from repro_torch.configs import get_config
    total = dict.fromkeys(ops.launch_counts(), 0)
    for arch, n_layers, quant in MOE_VARIANTS:
        published = get_config(arch)
        cfg = dataclasses.replace(published, n_layers=n_layers,
                                  dtype="float32")
        ops.reset_launches()
        rel, finite = teacher_force(cfg, 33, expert_quant=quant)
        counts = ops.launch_counts()
        ok = finite and rel < 2e-4
        experts = "int8" if quant else "f32"
        say(f"  teacher forcing {arch}, {n_layers} of {published.n_layers} "
            f"layers at d={cfg.d_model}, {cfg.n_experts} experts of "
            f"{cfg.d_ff} ({experts}), top-{cfg.top_k}, f32, prompt 4x32: "
            f"rel={rel:.3e} (limit 2e-4) -> {'ok' if ok else 'FAIL'}; "
            f"launches {counts}")
        if not ok:
            raise AssertionError(f"teacher forcing {arch} ({experts} "
                                 f"experts): rel={rel}")
        require_launched(f"{arch} teacher forcing", counts,
                         PATH_KERNELS["teacher_forcing"])
        total = {k: total[k] + n for k, n in counts.items()}
        torch.cuda.empty_cache()
    return total


def phase_parity_ssd(ops):
    """Teacher forcing of mamba2-2.7b at its published widths, f32, its
    depth cut to SSM_TF_LAYERS (all 64 layers would take 11.3 GB in f32),
    on 4 x SSM_TF_S tokens, as ``phase_parity``: the decode after a prefill
    chunked in two chunks of 256 against a prefill chunked in three of
    171.  The path launches none of the kernel wrappers.  Returns its
    launch counts."""
    from repro_torch.configs import get_config
    published = get_config(SSM_ARCH)
    cfg = dataclasses.replace(published, n_layers=SSM_TF_LAYERS,
                              dtype="float32")
    ops.reset_launches()
    rel, finite = teacher_force(cfg, SSM_TF_S)
    counts = ops.launch_counts()
    ok = finite and rel < 2e-4
    say(f"  teacher forcing {SSM_ARCH}, {cfg.n_layers} of "
        f"{published.n_layers} layers (ssd) at d={cfg.d_model}, d_inner="
        f"{cfg.d_inner}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, f32, "
        f"prompt 4x{SSM_TF_S - 1}: rel={rel:.3e} (limit 2e-4) -> "
        f"{'ok' if ok else 'FAIL'}; launches {counts} (none expected: no "
        f"attention, no LoRA)")
    if not ok:
        raise AssertionError(f"teacher forcing {SSM_ARCH}: rel={rel}")
    if any(counts.values()):
        raise AssertionError(f"{SSM_ARCH} teacher forcing launched "
                             f"{counts}")
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------- #
# phase 6: timing
# --------------------------------------------------------------------------- #

# device kernel (as the profiler names it) -> the wrapper that launches it;
# the fused wrapper launches flash-decode's two kernels
KERNEL_NAMES = {"bgmv_kernel": "bgmv", "sgmv_kernel": "sgmv",
                "sgmv_segments_kernel": "sgmv",
                "fd_split_kernel": "flash_decode",
                "fd_split_int8_kernel": "flash_decode",
                "fd_combine_kernel": "flash_decode",
                "fd_lora_shrink_kernel": "flash_decode_lora"}
FD_KERNELS = ("fd_split_kernel", "fd_combine_kernel")  # flash-decode's two
FD_INT8_KERNELS = ("fd_split_int8_kernel", "fd_combine_kernel")  # int8 mode
# the int8 mode with q in f32: pre-pass, split pass, combine
FD_INT8_F32_KERNELS = ("fd_int8_max_kernel", "fd_split_int8_any_kernel",
                       "fd_combine_kernel")
FD_PAD_KERNELS = ("fd_split_pad_kernel", "fd_combine_kernel")  # padded D
FD_WIDE_KERNELS = ("fd_split_wide_kernel", "fd_combine_kernel")  # D > 256
FUSED_KERNELS = FD_KERNELS + ("fd_lora_shrink_kernel",)  # the fused three
SGMV_KERNELS = ("sgmv_segments_kernel", "sgmv_kernel")  # SGMV's sort, product
GEMM_WORDS = ("gemm", "nvjet", "cutlass", "xmma")  # cuBLAS kernel names


def phase_step(executor, ops, n=10):
    """One decode step of the serving executor (8 rows), three ways from
    the same executor and cache: the eager ``decode_step``'s
    wall, the replayed graph's wall (host clock around ``n`` synchronised
    ``executor.decode`` calls, as ``TorchExecutor.step`` times them) and its
    device span (CUDA events around ``n`` back-to-back replays), and where
    the device time goes in each (torch.profiler, 3 steps).  The replayed
    step's busy share is its profiled device busy time over that wall:
    the profiler's own tracing of ~2,600 kernels a step stretches the wall
    of the window it profiles.  Returns the launches of one step and the
    step's numbers."""
    model, lora, cache = executor.model, executor.lora, executor.cache
    idx = torch.arange(8, dtype=torch.int32, device="cuda") % SLOTS
    idx_host = idx.cpu().numpy()

    def eager():
        model.decode_step(lora, cache, executor.tokens, idx)

    def replay():
        executor.decode(idx_host)
    # the split pass of each cache layout the model has (int8 or not)
    quant = [blk.kv_quant for blk in model.layers]
    absent = {"fd_split_int8_kernel": not any(quant),
              "fd_split_kernel": all(quant)}
    absent = tuple(k for k, no in absent.items() if no)
    ops.reset_launches()
    eager()
    per_step = ops.launch_counts()
    say(f"  launches per decode step: {per_step}; per replay: "
        f"{executor.graph_launches}")
    if executor.graph_launches != {k: c for k, c in per_step.items() if c}:
        raise AssertionError("the captured step launches other kernels than "
                             "the eager step")
    stats = {"eager_ms": wall_ms(eager, n), "replay_ms": wall_ms(replay, n)}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        executor.graph.replay()
    end.record()
    torch.cuda.synchronize()
    stats["replay_span_ms"] = start.elapsed_time(end) / n
    busy_e, wall_e, _ = profile_step(eager, per_step, "eager", absent)
    busy_r, wall_r, groups = profile_step(replay, per_step, "replayed",
                                          absent)
    stats.update(replay_groups_ms={g: us / 1e3 for g, us in groups.items()},
                 replay_flash_decode_share=groups.get("flash_decode", 0.0)
                 / busy_r)
    stats.update(eager_busy_ms=busy_e / 1e3, replay_busy_ms=busy_r / 1e3,
                 replay_busy_share=busy_r / 1e3 / stats["replay_ms"],
                 replay_span_share=stats["replay_span_ms"] / stats[
                     "replay_ms"])
    say(f"  decode step: eager {stats['eager_ms']:.2f} ms wall (mean of "
        f"{n}), device busy {busy_e / 1e3:.2f} ms = {busy_e * 3 / wall_e:.1%}"
        f" of the profiled wall; replayed {stats['replay_ms']:.2f} ms wall "
        f"(mean of {n}), {stats['replay_span_ms']:.2f} ms a replay by CUDA "
        f"events ({stats['replay_span_share']:.1%} of the wall), device busy"
        f" {busy_r / 1e3:.2f} ms = {stats['replay_busy_share']:.1%} of the "
        f"wall ({busy_r * 3 / wall_r:.1%} of the profiled wall)")
    return per_step, stats


def wall_ms(fn, n):
    """Host-clock ms of one synchronised call, mean of ``n`` after one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def profile_step(step, per_step, label, absent=(), steps=3):
    """Device busy µs per step (the union of the device's kernel and copy
    intervals: kernels chained as programmatic dependents overlap, so
    their sum counts some time twice), the profiled wall µs of ``steps``
    steps (torch.profiler) and the µs a step by kernel group, printing
    those groups and the largest kernels; fails if a kernel the step
    launched (``per_step``; but those in ``absent``, the split pass of a
    cache layout the model does not have) shows no device time under its
    own name, which a renamed kernel, or one the profiler did not see
    inside a graph, would."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups, kernels, seen = {}, [], {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total / steps
        kernels.append((us, e.key))
        name = next((k for k in KERNEL_NAMES if k in e.key), None)
        if name is not None:
            seen[name] = seen.get(name, 0.0) + us
        group = KERNEL_NAMES[name] if name is not None else (
            "gemm" if any(w in e.key.lower() for w in GEMM_WORDS) else "other")
        groups[group] = groups.get(group, 0.0) + us
    missing = [k for k, wrapper in KERNEL_NAMES.items()
               if per_step.get(wrapper, 0) and k not in absent
               and not seen.get(k, 0.0) > 0]
    if missing:
        raise AssertionError(f"kernels launched in the {label} step have no "
                             f"profiled device time: {missing}")
    busy, end = 0.0, -math.inf
    for t0, t1 in sorted((e.time_range.start, e.time_range.end)
                         for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    say(f"  {label} step, device time per step by group (us): "
        + ", ".join(f"{g} {us:.1f}" for g, us in
                    sorted(groups.items(), key=lambda kv: -kv[1]))
        + f"; {len(kernels)} kernel names; busy (union) {busy / steps:.1f}")
    for us, key in sorted(kernels, reverse=True)[:6]:
        say(f"    {us:9.1f} us  {key[:90]}")
    return busy / steps, wall_us, groups


def check_replay(executor, steps=4):
    """The executor's replayed step against the eager ``decode_step`` from
    the same cache, cloned: ``steps`` consecutive steps with mixed adapter
    ids (base rows, -1, among them) from ``pos`` = S - 2, so the last two
    run past the global caches' end (write skipped, all of S attended) and
    wrap a local layer's rolling buffer of S rows (rows 0 and 1 written).
    The logits of every step and every layer's K and V must be equal bit
    for bit (the same kernels and GEMMs), or else, should cuBLAS pick
    another algorithm under capture, within bf16's 3e-2; the largest
    difference is printed either way."""
    model, lora, cache = executor.model, executor.lora, executor.cache
    s = executor.cache_len
    cache["pos"].fill_(s - 2)
    eager = {"pos": cache["pos"].clone(),
             "layers": [{k: v.clone() for k, v in c.items()}
                        for c in cache["layers"]]}
    ids = torch.tensor([[0, 1, 2, 3, -1, 0, 1, 2], [3, -1, 2, 1, 0, -1, 3, 3],
                        [-1, -1, 1, 1, 2, 2, 0, 3], [2, 3, 0, 1, -1, 3, -1, 0]],
                       dtype=torch.int32)
    pairs = []
    for i in range(steps):
        got = executor.decode(ids[i % len(ids)].numpy()).clone()
        want, _ = model.decode_step(lora, eager, executor.tokens,
                                    ids[i % len(ids)].cuda())
        pairs.append((f"logits step {i}", got, want))
    for n, (c, e) in enumerate(zip(cache["layers"], eager["layers"])):
        pairs += [(f"{key} layer {n}", c[key], e[key]) for key in c]
    torch.cuda.synchronize()
    worst = max([((g.float() - w.float()).abs().max().item(), name)
                 for name, g, w in pairs], key=lambda t: t[0])
    bitwise = all(torch.equal(g, w) for _, g, w in pairs)
    ok = bitwise or all(torch.allclose(g.float(), w.float(), rtol=TOL[
        "bfloat16"], atol=TOL["bfloat16"]) for _, g, w in pairs)
    pos = (int(cache["pos"]), int(eager["pos"]))
    ok = ok and pos == (s - 2 + steps,) * 2 and \
        bool(torch.isfinite(pairs[steps - 1][1]).all())
    say(f"  replay vs eager, {steps} steps from pos {s - 2} (S {s}), ids "
        f"with -1, logits and {len(pairs) - steps} cache tensors: "
        f"{'bitwise' if bitwise else 'not bitwise'}, largest difference "
        f"{worst[0]:.3e} ({worst[1]}), pos {pos} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"replayed step disagrees with the eager step: "
                             f"{worst}, pos {pos}")


# the parts of a decode step (``step_split``): a mixer's own (the ops run
# inside its profiler range: ``MIXERS``), then the port's kernels, the
# other cuBLAS products and the rest
MIXERS = {  # mixer -> (module, function, profiler range, its parts)
    "moe": ("moe", "apply_moe", MOE_RANGE, ("expert_bmm", "moe_glue")),
    "rglru": ("rglru", "apply_rglru", "rglru_mixer",
              ("rglru_gemm", "rglru_glue")),
    "ssd": ("ssm", "apply_ssd", "ssd_mixer", ("ssd_gemm", "ssd_glue")),
}
STEP_PARTS = ("flash_decode", "bgmv", "dense_gemm", "other_glue")
MATMUL_OPS = ("aten::mm", "aten::matmul", "aten::addmm", "aten::bmm")


def step_part(kernel, mixer, op):
    """The part of the step a kernel belongs to: one of the port's own
    kernels; inside the MoE FFN (``mixer`` "moe") a batched product
    (``aten::bmm``: the expert products) or anything else it launches
    (routing, dispatch, combine, aux loss); inside the RG-LRU mixer
    (``mixer`` "rglru") a matrix product (its x, gate and output
    projections) or anything else (the conv, the gates, the recurrence);
    inside the SSD mixer (``mixer`` "ssd") a matrix product (its z, x, bc,
    dt and output projections, the state's update and read-out) or
    anything else (the convs, softplus, decay, gate, casts, the state
    writes); another cuBLAS product; any other kernel (norms, RoPE,
    casts, the cache write)."""
    name = next((k for k in KERNEL_NAMES if k in kernel), None)
    if name is not None:
        return KERNEL_NAMES[name]
    if mixer == "moe":
        return "expert_bmm" if op == "aten::bmm" else "moe_glue"
    if mixer in ("rglru", "ssd"):
        return f"{mixer}_gemm" if op in MATMUL_OPS else f"{mixer}_glue"
    if any(w in kernel.lower() for w in GEMM_WORDS):
        return "dense_gemm"
    return "other_glue"


def step_split(executor, mixer, steps=3):
    """Where the device time of a decode step goes, by the mixer's parts
    and ``STEP_PARTS``, in ms a step.  The eager step is profiled with
    every call of the mixer (``moe.apply_moe``, ``rglru.apply_rglru`` or
    ``ssm.apply_ssd``, wrapped here for this profile only) inside its
    profiler range, and
    each kernel an op launched is charged to that op's part; a kernel no
    op launched (the port's own kernels, launched by their binding) goes
    by its name.  The replayed graph launches the same kernels without
    their ops, so each kernel name's replayed time is split as that name's
    eager time was.  Every part has device time but the port's kernels
    that the step does not launch (mamba2 launches none).  Also prints
    the mixer's glue's largest kernels."""
    import importlib
    from unittest import mock
    module_name, fn_name, range_name, own = MIXERS[mixer]
    module = importlib.import_module(f"repro_torch.models.{module_name}")
    parts = own + STEP_PARTS
    glue = own[1]
    model, lora, cache = executor.model, executor.lora, executor.cache
    idx = torch.arange(8, dtype=torch.int32, device="cuda") % SLOTS
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    inner = getattr(module, fn_name)

    def marked(*args, **kw):
        with torch.profiler.record_function(range_name):
            return inner(*args, **kw)

    def eager():
        model.decode_step(lora, cache, executor.tokens, idx)
    with mock.patch.object(module, fn_name, marked):
        eager()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(steps):
                eager()
            torch.cuda.synchronize()
    by_name = {}   # kernel -> part -> µs, over the eager steps
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        anc, inside = e, False
        while anc is not None and not inside:
            inside, anc = anc.name == range_name, anc.cpu_parent
        for k in e.kernels:
            shares = by_name.setdefault(k.name, dict.fromkeys(parts, 0.0))
            shares[step_part(k.name, mixer if inside else None,
                             e.name)] += k.duration

    def split(profile):
        out = dict.fromkeys(parts, 0.0)
        for e in profile.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA or \
                    e.key == range_name:   # the range's own device span
                continue
            ms = e.self_device_time_total / steps / 1e3
            shares = by_name.get(e.key)
            if not shares or not sum(shares.values()):
                shares = {step_part(e.key, None, ""): 1.0}
            total = sum(shares.values())
            for part, w in shares.items():
                out[part] += ms * w / total
        return out
    eager_ms = split(prof)
    launched = set(executor.graph_launches)
    if not all(eager_ms[p] > 0 for p in parts
               if p not in KERNEL_NAMES.values() or p in launched):
        raise AssertionError(f"a part of the {mixer} step has no device "
                             f"time: {eager_ms}")
    largest = sorted(((v[glue] / steps, k) for k, v in by_name.items()
                      if v[glue]), reverse=True)
    idx_host = idx.cpu().numpy()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            executor.decode(idx_host)
        torch.cuda.synchronize()
    replay_ms = split(prof)
    for label, got in (("eager", eager_ms), ("replayed", replay_ms)):
        say(f"  {label} step by part (ms): " + ", ".join(
            f"{p} {ms:.3f}" for p, ms in got.items())
            + f"; total {sum(got.values()):.3f}")
    say(f"  {glue}: {len(largest)} kernel names; the largest:")
    for us, key in largest[:8]:
        say(f"    {us:9.1f} us  {key[:90]}")
    return {"eager_split_ms": eager_ms, "replay_split_ms": replay_ms}


def weight_bytes(model):
    """The bytes of weights a decode step reads once (every parameter but
    an untied embedding table, of which it reads a few rows), and of them
    the MoE experts'."""
    weights = experts = 0
    for name, p in model.named_parameters():
        if name == "embed.embed" and not model.cfg.tie_embeddings:
            continue
        weights += p.numel() * p.element_size()
        if ".moe.w_" in name:
            experts += p.numel() * p.element_size()
    return weights, experts


def step_bound(model, cache, batch=8):
    """The least time of one decode step of ``batch`` rows: the bytes of
    every weight it reads once (all parameters but an untied embedding
    table, of which it reads ``batch`` rows) and of the recurrent states
    of ``cache`` (an rglru or ssd layer's), read once and written once,
    over the HBM rate, against the operations of the dense (E, C, d)
    expert products at C = batch * k (dropless) over the bf16 peak."""
    cfg = model.cfg
    weights, experts = weight_bytes(model)
    state = 2 * sum(t.numel() * t.element_size()
                    for blk, c in zip(model.layers, cache["layers"])
                    if blk.slot_key(c) is None for t in c.values())
    flops = 2 * 3 * cfg.n_experts * batch * cfg.top_k * cfg.d_model \
        * cfg.d_ff * cfg.n_layers
    ms, by = bound(weights + state, flops, "bfloat16")
    out = {"weight_gb": weights / 1e9, "expert_weight_gb": experts / 1e9,
           "weights_ms": weights / HBM_BYTES_PER_S * 1e3,
           "state_rw_gb": state / 1e9,
           "state_ms": state / HBM_BYTES_PER_S * 1e3,
           "dispatch_tflop": flops / 1e12,
           "dispatch_ms": flops / PEAK_FLOPS["bfloat16"] * 1e3,
           "bound_ms": ms, "bound_by": by}
    say(f"  step bound: {out['weight_gb']:.2f} GB of weights "
        f"({out['expert_weight_gb']:.2f} GB experts) = "
        f"{out['weights_ms']:.2f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
        f"recurrent states read and written {out['state_rw_gb']:.3f} GB "
        f"= {out['state_ms']:.3f} ms; "
        f"dense dispatch {out['dispatch_tflop']:.3f} TFLOP (0 without "
        f"experts) = {out['dispatch_ms']:.3f} ms at "
        f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s; bound {ms:.2f} ms "
        f"by {by}")
    return out


def graph_ms(fn, arg_sets, calls=32, reps=5):
    """Device time of one call: ``calls`` calls cycling over ``arg_sets``
    (distinct copies, so that the set outgrows the 50 MB L2 where it can)
    captured in a CUDA graph and replayed, timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    n = max(calls, len(arg_sets))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


def copies(make, set_bytes):
    """Enough distinct input sets to hold about 100 MB (at most 256)."""
    return [make() for _ in range(max(1, min(256, math.ceil(1e8 / set_bytes))))]


def profiled_ms(fn, arg_sets, names, calls=20):
    """Device time per call of each kernel in ``names`` (a substring of the
    profiler's kernel name), over ``calls`` eager calls.  A session that
    records none of a kernel's launches (one, after ``phase_step``'s
    session, once recorded no device time at all; cause not known) prints
    a line that starts with ``PROFILER_EMPTY_SESSION`` and is made once
    more; a second empty session raises."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for session in (1, 2):
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(calls):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        out = dict.fromkeys(names, 0.0)
        seen = []
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                seen.append(e.key[:60])
                for n in names:
                    if n in e.key:
                        out[n] += e.self_device_time_total / calls / 1e3
        if all(v > 0 for v in out.values()):
            return out
        say(f"PROFILER_EMPTY_SESSION {session}: no device time for {names}: "
            f"{out}; device keys seen: {seen[:8]}")
    raise AssertionError(f"no profiled device time for {names}")


def bound(bytes_moved, flops, dtype_name):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def phase_timing():
    from repro_torch.configs import get_config
    from repro_torch.kernels import bgmv, flash_decode, ref, sgmv
    import torch.nn.functional as F
    dt = torch.bfloat16
    inp = Inputs(seed=3)
    rows = {}

    def lora_sets(t, o, n=SLOTS, r=RANK, ids=None, d=D_MODEL):
        """Input sets of a LoRA kernel and the bound of one call."""
        if ids is None:
            ids = (torch.arange(t, device="cuda") % n).to(torch.int32)

        def make():
            x = inp.normal(t, d, dtype=dt)
            a, b = inp.lora_bank(n, d, r, o, dt)
            return x, a, b, ids
        n_used = int(torch.unique(ids[(ids >= 0) & (ids < n)]).numel())
        flops, nbytes = kernel_cost.lora_cost(t, d, r, o, n_used)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        return copies(make, nbytes), b_ms, b_by

    def lora_row(name, kernel, plain, t, o):
        sets, b_ms, b_by = lora_sets(t, o)
        rows[name] = {"ms": graph_ms(kernel, sets),
                      "plain_ms": graph_ms(plain, sets),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": None}
        return sets

    # the per-launch floor: a 1-element in-place op, captured and replayed
    # like every row below; no kernel launch takes less
    one = torch.zeros(1, device="cuda")
    floor = graph_ms(lambda z: z.add_(1.0), [(one,)])
    # BGMV at the q projection's shape (o 3072) and the v projection's
    # (o 1024): each runs 32 times a decode step
    lora_row("bgmv", bgmv.bgmv, bgmv.bgmv_plain, BATCH, V_OUT)
    v_row = rows.pop("bgmv")
    lora_row("bgmv", bgmv.bgmv, bgmv.bgmv_plain, BATCH, Q_OUT)
    rows["bgmv"].update({"o1024_ms": v_row["ms"],
                         "o1024_plain_ms": v_row["plain_ms"],
                         "o1024_bound_ms": v_row["bound_ms"]})
    sets = lora_row("sgmv", sgmv.sgmv, ref.sgmv_ref, PREFILL_T, Q_OUT)
    # ragged SGMV (row 3 of the TPU kernels) on the same inputs
    ranks = torch.tensor(RAGGED_RANKS, dtype=torch.int32, device="cuda")
    rows["sgmv"]["ragged_ms"] = graph_ms(
        lambda x, a, b, i: sgmv.sgmv(x, a, b, i, ranks=ranks), sets)
    rows["sgmv"]["ragged_plain_ms"] = graph_ms(
        lambda x, a, b, i: ref.sgmv_ref(x, a, b, i, ranks=ranks), sets)
    # its two kernels apart (profiler), and the sort's plain version (the
    # torch.sort + searchsorted that the sort kernel replaced)
    split = profiled_ms(sgmv.sgmv, sets, SGMV_KERNELS)
    rows["sgmv"]["sort_ms"] = split["sgmv_segments_kernel"]
    rows["sgmv"]["product_ms"] = split["sgmv_kernel"]
    rows["sgmv"]["sort_plain_ms"] = graph_ms(
        lambda x, a, b, i: sgmv.segments_plain(i, SLOTS), sets)
    # at N 1 the function is two matrix products, (x @ A[0]) @ B[0]: the
    # library yardstick there (two calls, h rounded to bf16 between them)
    sets, b_ms, _ = lora_sets(PREFILL_T, Q_OUT, n=1)
    rows["sgmv"].update({
        "n1_ms": graph_ms(sgmv.sgmv, sets), "n1_bound_ms": b_ms,
        "n1_library_two_matmuls_ms": graph_ms(
            lambda x, a, b, i: (x @ a[0]) @ b[0], sets)})
    # the measurement path's prefill shape: T 4096, r 16, N 32, random ids
    ids = torch.randint(0, GRID_N, (MEASURE_T,), generator=inp.gen,
                        device="cuda", dtype=torch.int32)
    sets, b_ms, _ = lora_sets(MEASURE_T, Q_OUT, n=GRID_N, r=MEASURE_RANK,
                              ids=ids)
    rows["sgmv"].update({"measure_ms": graph_ms(sgmv.sgmv, sets),
                         "measure_bound_ms": b_ms})
    # whole-prompt arrival ranks at phase 3's shape (BATCH x PREFILL_S
    # tokens, 4 adapters spread over the requests): the whole prompt with
    # its own arrival ranks beside the same call without them, one of
    # ARRIVAL_SLICES sequence slices with the whole prompt's, and the
    # plain version of the whole
    t = BATCH * PREFILL_S
    req = (torch.arange(BATCH, device="cuda") % SLOTS).to(torch.int32)
    ids = req.repeat_interleave(PREFILL_S)
    own = ref._bucket_positions(ids, SLOTS).to(torch.int32)
    sets, _, _ = lora_sets(t, Q_OUT, ids=ids)
    s_loc = PREFILL_S // ARRIVAL_SLICES
    part = sgmv.arrival_ranks(req, 0, BATCH, PREFILL_S, s_loc, s_loc)
    cap = ref.sgmv_capacity(t, SLOTS)
    p_ids = req.repeat_interleave(s_loc)
    p_sets, _, _ = lora_sets(BATCH * s_loc, Q_OUT, ids=p_ids)

    def arrival_bound(tokens):
        """x, the 4 adapters' banks and y once, ids and arrival ranks (4
        bytes each a token); nothing dropped (ids spread)."""
        flops, nbytes = kernel_cost.lora_cost(tokens, D_MODEL, RANK, Q_OUT,
                                              SLOTS, id_bytes=8)
        return bound(nbytes, flops, "bfloat16")
    b_ms, b_by = arrival_bound(t)
    p_ms, _ = arrival_bound(BATCH * s_loc)
    rows["sgmv"].update({
        "arrival_ms": graph_ms(
            lambda x, a, b, i: sgmv.sgmv(x, a, b, i, arrival=own), sets),
        "arrival_no_argument_ms": graph_ms(sgmv.sgmv, sets),
        "arrival_plain_ms": graph_ms(
            lambda x, a, b, i: ref.sgmv_ref(x, a, b, i), sets),
        "arrival_bound_ms": b_ms, "arrival_bound_by": b_by,
        "arrival_slice_ms": graph_ms(
            lambda x, a, b, i: sgmv.sgmv(x, a, b, i, arrival=part, cap=cap),
            p_sets),
        "arrival_slice_bound_ms": p_ms})
    del sets, p_sets

    lengths = torch.full((BATCH,), CACHE, dtype=torch.int32, device="cuda")

    def fd_sets(heads, kv_heads, head_dim, s=CACHE):
        """Flash-decode's input maker and sets at B 8 over all ``s``
        positions (512), the bound of one call and its bytes, and the
        library yardstick's sets: (B, heads, S, D), the layout change made
        here, outside the timed calls."""
        full = torch.full((BATCH,), s, dtype=torch.int32, device="cuda")

        def make():
            return (inp.normal(BATCH, heads, head_dim, dtype=dt),
                    inp.normal(BATCH, s, kv_heads, head_dim, dtype=dt),
                    inp.normal(BATCH, s, kv_heads, head_dim, dtype=dt),
                    full)
        flops, nbytes = kernel_cost.flash_decode_cost(BATCH, s, heads,
                                                      kv_heads, head_dim)
        sets = copies(make, nbytes)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        lib_sets = [(q[:, :, None], k.transpose(1, 2).contiguous(),
                     v.transpose(1, 2).contiguous()) for q, k, v, _ in sets]
        return make, sets, b_ms, b_by, nbytes, lib_sets

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True)

    make_fd, sets, b_ms, b_by, nbytes, lib_sets = fd_sets(HEADS, KV_HEADS,
                                                          HEAD_DIM)
    # the same call on the cache as the port lays it out, (B, S, KV, D),
    # through transposed views: no copy
    view_sets = [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2))
                 for q, k, v, _ in sets]
    split = profiled_ms(flash_decode.flash_decode, sets, FD_KERNELS)
    rows["flash_decode"] = {
        "ms": graph_ms(flash_decode.flash_decode, sets),
        "plain_ms": graph_ms(flash_decode.flash_decode_plain, sets),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": graph_ms(sdpa, lib_sets),
        "library_on_views_ms": graph_ms(sdpa, view_sets),
        "split_ms": split["fd_split_kernel"],
        "combine_ms": split["fd_combine_kernel"]}

    rows["flash_decode_int8"] = int8_rows(make_fd, sdpa)
    rows["flash_decode"].update(long_bf16_times(sdpa))

    # fused: the same attention plus a rank-8 delta from 4 adapters
    ids = (torch.arange(BATCH, device="cuda") % SLOTS).to(torch.int32)
    expand = HEADS * HEAD_DIM

    def make_fused():
        x = inp.normal(BATCH, D_MODEL, dtype=dt)
        a, b = inp.lora_bank(SLOTS, D_MODEL, RANK, expand, dt)
        return make_fd() + (x, a, b, ids)
    n_used = int(torch.unique(ids).numel())
    flops_f, nbytes_f = kernel_cost.flash_decode_lora_cost(
        BATCH, CACHE, HEADS, KV_HEADS, HEAD_DIM, D_MODEL, RANK, n_used)
    sets = copies(make_fused, nbytes_f)
    b_ms, b_by = bound(nbytes_f, flops_f, "bfloat16")

    def unfused(q, k, v, length, x, a, b, i):
        # the JAX bench's yardstick: base attention, a separate LoRA
        # launch, the add
        return flash_decode.flash_decode(q, k, v, length) \
            + bgmv.bgmv(x, a, b, i).reshape(q.shape)
    split = profiled_ms(flash_decode.flash_decode_lora, sets, FUSED_KERNELS)
    rows["flash_decode_lora"] = {
        "ms": graph_ms(flash_decode.flash_decode_lora, sets),
        "split_ms": split["fd_split_kernel"],
        "shrink_ms": split["fd_lora_shrink_kernel"],
        "combine_ms": split["fd_combine_kernel"],
        "plain_ms": graph_ms(flash_decode.flash_decode_lora_plain, sets),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,          # no single PyTorch call computes it
        "unfused_ms": graph_ms(unfused, sets)}
    rows["flash_decode_lora"].update(fused_grid_times(unfused))
    del sets

    # the other served architectures' shapes: gemma3-1b's BGMV at d 1152 (q
    # projection o 1024, v projection o 256) and flash-decode at 4 heads of
    # D 256 on 1 KV head; olmoe-1b-7b's BGMV at d 2048 (q and v projections
    # both o 2048) and flash-decode at 16 heads of D 128 on 16 KV heads
    for arch, name in ((SERVED_VARIANT, "gemma3"), (MOE_ARCH, "olmoe")):
        cfg = get_config(arch)
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        for o in sorted({h * hd, kv * hd}, reverse=True):
            prefix = name if o == h * hd else f"{name}_o{o}"
            g_sets, b_ms, _ = lora_sets(BATCH, o, d=cfg.d_model)
            rows["bgmv"].update({
                f"{prefix}_ms": graph_ms(bgmv.bgmv, g_sets),
                f"{prefix}_plain_ms": graph_ms(bgmv.bgmv_plain, g_sets),
                f"{prefix}_bound_ms": b_ms})
        _, g_sets, b_ms, _, _, g_lib = fd_sets(h, kv, hd)
        if hd == 256:
            require_d256_pass(f"flash_decode {name}_*",
                              flash_decode.flash_decode, g_sets[0])
        rows["flash_decode"].update({
            f"{name}_ms": graph_ms(flash_decode.flash_decode, g_sets),
            f"{name}_plain_ms": graph_ms(flash_decode.flash_decode_plain,
                                         g_sets),
            f"{name}_bound_ms": b_ms,
            f"{name}_library_ms": graph_ms(sdpa, g_lib)})
        del g_sets, g_lib
    # recurrentgemma-9b's BGMV (its local layers' q and v projections: d
    # 4096, o 4096 and 256); its flash-decode is hybrid_fd_times'
    cfg = get_config(HYBRID_ARCH)
    hd = cfg.resolved_head_dim
    for o in (cfg.n_heads * hd, cfg.n_kv_heads * hd):
        prefix = "rgemma" if o == cfg.n_heads * hd else f"rgemma_o{o}"
        g_sets, b_ms, _ = lora_sets(BATCH, o, d=cfg.d_model)
        rows["bgmv"].update({
            f"{prefix}_ms": graph_ms(bgmv.bgmv, g_sets),
            f"{prefix}_plain_ms": graph_ms(bgmv.bgmv_plain, g_sets),
            f"{prefix}_bound_ms": b_ms})
        del g_sets
    rows["flash_decode"].update(hybrid_fd_times(fd_sets, sdpa))
    rows["flash_decode"].update(padded_fd_times(fd_sets, sdpa))
    rows["flash_decode"].update(wide_fd_times(fd_sets, sdpa))

    for r in rows.values():
        r["floor_ms"] = floor
    return rows


def hybrid_fd_times(fd_sets, sdpa):
    """Flash-decode at recurrentgemma-9b's shape (16 heads of 256 on 1 KV
    head: one block of the tensor-core pass at D 256 reads the KV head's
    K and V for all 16) over 512 rows (``rgemma_*``) and the 2048-row
    window (``rgemma_s2048_*``): its time, its plain version's, its bound
    and SDPA's; and beside each the kernel with 8 heads on the same K/V
    (``*_g8_ms``: half the heads, the same bytes of K and V), which shows
    what the other 8 heads cost."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode
    cfg = get_config(HYBRID_ARCH)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    out = {}
    for prefix, s in (("rgemma", CACHE), ("rgemma_s2048", cfg.local_window)):
        _, sets, b_ms, _, _, lib = fd_sets(h, kv, hd, s)
        require_d256_pass(f"flash_decode {prefix}_*",
                          flash_decode.flash_decode, sets[0])
        out.update({
            f"{prefix}_ms": graph_ms(flash_decode.flash_decode, sets),
            f"{prefix}_plain_ms": graph_ms(flash_decode.flash_decode_plain,
                                           sets),
            f"{prefix}_bound_ms": b_ms,
            f"{prefix}_library_ms": graph_ms(sdpa, lib)})
        del sets, lib
        _, sets, b_ms, _, _, _ = fd_sets(h // 2, kv, hd, s)
        out.update({f"{prefix}_g8_ms": graph_ms(flash_decode.flash_decode,
                                                sets),
                    f"{prefix}_g8_bound_ms": b_ms})
        del sets
        torch.cuda.empty_cache()
    return out


def padded_fd_times(fd_sets, sdpa):
    """Flash-decode at a head dim without an instance (``PADDED_SHAPE``: B
    8, S 512, 32 heads of 96 on 32 KV heads, run on the 128 instance,
    padded, on tensor cores): its time, its plain version's, its bound,
    SDPA's, its split and combine kernels apart (profiler), and the same
    heads at D 128 (``d96_as_d128_*``: the instance it runs, unpadded,
    over 4/3 the bytes)."""
    from repro_torch.kernels import flash_decode
    fd = flash_decode.flash_decode
    h, kv, d = PADDED_SHAPE
    _, sets, b_ms, _, _, lib = fd_sets(h, kv, d)
    split = profiled_ms(fd, sets, FD_PAD_KERNELS)
    out = {"d96_ms": graph_ms(fd, sets),
           "d96_plain_ms": graph_ms(flash_decode.flash_decode_plain, sets),
           "d96_bound_ms": b_ms, "d96_library_ms": graph_ms(sdpa, lib),
           "d96_split_ms": split[FD_PAD_KERNELS[0]],
           "d96_combine_ms": split[FD_PAD_KERNELS[1]]}
    del sets, lib
    _, sets, b_ms, _, _, _ = fd_sets(h, kv, 128)
    out.update(d96_as_d128_ms=graph_ms(fd, sets), d96_as_d128_bound_ms=b_ms)
    del sets
    torch.cuda.empty_cache()
    return out


def sdpa_backend(fn, args):
    """The backend PyTorch picks for the SDPA call ``fn(*args)``, from the
    device kernels one call launches under the profiler: its name
    (flash, efficient, cudnn or math) and the kernels' names.  A session
    that records no device kernel (as ``profiled_ms`` sees at times) is
    made once more; after two, the backend is "not identified"."""
    fn(*args)
    torch.cuda.synchronize()
    for _ in range(2):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        if names:
            break
    else:
        return "not identified", []
    low = " ".join(names).lower()
    for backend, words in (("flash", ("flash",)),
                           ("efficient", ("fmha", "efficient", "cutlassf")),
                           ("cudnn", ("cudnn",))):
        if any(w in low for w in words):
            return backend, names
    return "math", names


def wide_fd_times(fd_sets, sdpa):
    """Flash-decode on the wide path (``WIDE_SHAPE``: B 8, S 512, 16 heads
    of 512 on 4 KV heads; no config of the repo has such a D): its time,
    its plain version's, its bound, SDPA's (on head-major copies, with the
    backend PyTorch picks), and its split and combine kernels apart
    (profiler)."""
    from repro_torch.kernels import flash_decode
    fd = flash_decode.flash_decode
    h, kv, d = WIDE_SHAPE
    _, sets, b_ms, _, _, lib = fd_sets(h, kv, d)
    split = profiled_ms(fd, sets, FD_WIDE_KERNELS)
    backend, names = sdpa_backend(sdpa, lib[0])
    say(f"  SDPA at D {d}: the {backend} backend ({', '.join(names)[:300]})")
    out = {"d512_ms": graph_ms(fd, sets),
           "d512_plain_ms": graph_ms(flash_decode.flash_decode_plain, sets),
           "d512_bound_ms": b_ms, "d512_library_ms": graph_ms(sdpa, lib),
           "d512_library_backend": backend,
           "d512_split_ms": split[FD_WIDE_KERNELS[0]],
           "d512_combine_ms": split[FD_WIDE_KERNELS[1]]}
    del sets, lib
    torch.cuda.empty_cache()
    return out


def int8_bound(bsz, h, kv, d, s, q_bytes=2):
    """The int8 mode's bound over all ``s`` positions: q (``q_bytes`` an
    element: bf16, or 4 for f32) read and the output written, int8 K and V
    and their f16 scales read once; 4*G*D operations a (position, KV head)
    against the peak of q's type."""
    flops, nbytes = kernel_cost.flash_decode_cost(
        bsz, s, h, kv, d, q_bytes, kv_bytes=1, scale_bytes=2)
    return bound(nbytes, flops, "bfloat16" if q_bytes == 2 else "float32")


def int8_rows(make_fd, sdpa):
    """The int8 mode's row: its time, its plain version's, its split and
    combine kernels (profiled) and its bound at phi4-mini's serving shape
    (B 8, S 512, all positions, q bf16) and over LONG_S positions
    (``s32768_*``), on ``quantize_kv`` of the bf16 inputs ``make_fd``
    draws.  Its library yardstick is ``scaled_dot_product_attention`` over
    the bf16 cache of the same shape (head-major copies): it reads twice
    the K/V bytes, and no single PyTorch call takes an int8 cache with its
    scales."""
    from repro_torch.kernels import flash_decode
    from repro_torch.models.attention import quantize_kv
    fd = flash_decode.flash_decode

    def int8_set(q, k, v, length):
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        return q, k8, v8, length, ks, vs
    bf16 = copies(make_fd, BATCH * CACHE * KV_HEADS * HEAD_DIM * 2)
    sets = [int8_set(*args) for args in bf16]
    lib_sets = [(q[:, :, None], k.transpose(1, 2).contiguous(),
                 v.transpose(1, 2).contiguous()) for q, k, v, _ in bf16]
    del bf16
    split = profiled_ms(fd, sets, FD_INT8_KERNELS)
    b_ms, b_by = int8_bound(BATCH, HEADS, KV_HEADS, HEAD_DIM, CACHE)
    row = {"ms": graph_ms(fd, sets),
           "plain_ms": graph_ms(flash_decode.flash_decode_int8_plain, sets),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": graph_ms(sdpa, lib_sets),
           "library_call": "scaled_dot_product_attention (GQA) on the bf16 "
                           "cache of the same shape: twice the K/V bytes",
           "split_ms": split["fd_split_int8_kernel"],
           "combine_ms": split["fd_combine_kernel"]}
    # q in f32: the pre-pass, the split pass against the row's max, the
    # combine
    sets = [(q.float(), *rest) for q, *rest in sets]
    split = profiled_ms(fd, sets, FD_INT8_F32_KERNELS)
    b_ms, _ = int8_bound(BATCH, HEADS, KV_HEADS, HEAD_DIM, CACHE, q_bytes=4)
    row.update(f32q_ms=graph_ms(fd, sets),
               f32q_plain_ms=graph_ms(flash_decode.flash_decode_int8_plain,
                                      sets),
               f32q_bound_ms=b_ms,
               **{f"f32q_{k.split('_kernel')[0]}_ms": split[k]
                  for k in FD_INT8_F32_KERNELS})
    del sets, lib_sets
    gen = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((BATCH, HEADS, HEAD_DIM), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kv = [torch.randn((BATCH, LONG_S, KV_HEADS, HEAD_DIM), generator=gen,
                      device="cuda", dtype=torch.bfloat16) for _ in range(2)]
    lib = [(q[:, :, None], kv[0].transpose(1, 2).contiguous(),
            kv[1].transpose(1, 2).contiguous())]
    row["s32768_library_ms"] = graph_ms(sdpa, lib)
    del lib
    sets = [int8_set(q, *kv, LONG_S)]
    del kv
    b_ms, _ = int8_bound(BATCH, HEADS, KV_HEADS, HEAD_DIM, LONG_S)
    row.update(s32768_ms=graph_ms(fd, sets),
               s32768_plain_ms=graph_ms(flash_decode.flash_decode_int8_plain,
                                        sets, calls=4),
               s32768_bound_ms=b_ms)
    del sets
    torch.cuda.empty_cache()
    return row


def long_bf16_times(sdpa):
    """Plain flash-decode (bf16) over LONG_S positions at phi4-mini's heads,
    B 8: its time, its plain version's, SDPA's (head-major copies) and its
    bound, beside the int8 mode's ``s32768_*``."""
    from repro_torch.kernels import flash_decode
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
               for shape in ((BATCH, HEADS, HEAD_DIM),
                             (BATCH, LONG_S, KV_HEADS, HEAD_DIM),
                             (BATCH, LONG_S, KV_HEADS, HEAD_DIM)))
    sets = [(q, k, v, LONG_S)]
    flops, nbytes = kernel_cost.flash_decode_cost(BATCH, LONG_S, HEADS,
                                                  KV_HEADS, HEAD_DIM)
    b_ms, _ = bound(nbytes, flops, "bfloat16")
    out = {"s32768_ms": graph_ms(flash_decode.flash_decode, sets),
           "s32768_plain_ms": graph_ms(flash_decode.flash_decode_plain, sets,
                                       calls=4),
           "s32768_bound_ms": b_ms,
           "s32768_library_ms": graph_ms(sdpa, [(
               q[:, :, None], k.transpose(1, 2).contiguous(),
               v.transpose(1, 2).contiguous())])}
    del q, k, v, sets
    torch.cuda.empty_cache()
    return out


def fused_grid_times(unfused):
    """The fused kernel beside the unfused sequence and plain flash-decode
    at the measurement path's widest point (batch 32, 4096 positions, rank
    32, 32 adapters; one input set, 537 MB of K and V), and at two other
    of its points at rank 32 (batch 32 at 1024 positions, batch 8 at
    4096), on the inputs that path draws.  Fused minus plain is what the
    LoRA epilogue adds to the attention there."""
    from repro_torch.bench import kernels_bench as kb
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode
    w = kb.Widths.of(get_config("phi4-mini-3.8b"))
    rank = max(GRID_RANKS)
    out = {}
    for prefix, bsz, s in (("grid", GRID_B, GRID_S), ("b32_s1024", GRID_B, 1024),
                           ("b8_s4096", 8, GRID_S)):
        gen = torch.Generator(device="cuda").manual_seed(5)
        q, k, v, x, a, b, idx = kb._decode_data(gen, bsz, s, rank, GRID_N,
                                                h=w.h, kv=w.kv, d=w.d,
                                                dx=w.dx)
        sets = [(q, k, v, s, x, a, b, idx)]
        out[f"{prefix}_ms"] = graph_ms(flash_decode.flash_decode_lora, sets)
        out[f"{prefix}_unfused_ms"] = graph_ms(unfused, sets)
        out[f"{prefix}_fd_ms"] = graph_ms(
            lambda q, k, v, length, *_: flash_decode.flash_decode(q, k, v,
                                                                  length),
            sets)
        if prefix == "grid":
            flops, nbytes = kernel_cost.flash_decode_lora_cost(
                bsz, s, w.h, w.kv, w.d, w.dx, rank,
                int(torch.unique(idx).numel()))
            out["grid_bound_ms"], _ = bound(nbytes, flops, "bfloat16")
        del q, k, v, sets
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# phase 7: the measurement path
# --------------------------------------------------------------------------- #

# 3.2 req/s per adapter: the saturating rate of
# benchmarks/fig2_loaded_adapters.py (the paper's Fig. 2 sweep)
PLACEMENT_POOL = dict(n=32, ranks=(8, 16, 32), rates=(3.2,))
PLACEMENT_SWEEP = dict(dataset="small", horizon=60.0, seed=0)


def phase_measure(ops):
    """Kernel launches at full width -> MeasuredStepTimes -> the port's
    twin -> (N*, G*), beside the analytic fit's.  Returns the launch
    counts of the path, the analytic estimators, the measured surface and
    the (N*, G*) of the analytic and the measured sweep (on FastTwin)."""
    from repro_torch.bench import kernels_bench as kb
    from repro_torch.configs import get_config
    from repro_torch.core import (collect_benchmark, collect_memmax,
                                  find_optimal_placement, fit_estimators,
                                  make_adapter_pool)
    from repro_torch.serving.executor import HardwareProfile, \
        SyntheticExecutor
    t0 = time.perf_counter()
    widths = kb.Widths.of(get_config("phi4-mini-3.8b"))
    ops.reset_launches()
    rows = kb.collect_kernel_rows(device="cuda", smoke=False, widths=widths)
    counts = ops.launch_counts()
    t_rows = time.perf_counter() - t0
    say(f"  {len(rows)} rows at {widths} in {t_rows:.1f} s; launches on "
        f"the measurement path: {counts}")
    for r in rows:
        say("    " + json.dumps(r))
    values = [r["t"] if "t" in r else r["mult"] for r in rows]
    if not all(math.isfinite(x) and x > 0 for x in values):
        raise AssertionError("measurement rows must be positive times")

    mst = kb.fit_rows(rows)
    c = mst.decode
    dec = [r for r in rows if r["kind"] == "decode"]
    resid = [float(c @ [1.0, r["batch"], r["batch"] * r["seq"],
                        r["batch"] * r["rank"]]) - r["t"] for r in dec]
    say(f"  MeasuredStepTimes: c0 {c[0] * 1e6:.3f} us, cB {c[1] * 1e6:.4f}"
        f" us, cBS {c[2] * 1e9:.5f} ns, cBr {c[3] * 1e6:.5f} us (mean_seq "
        f"{mst.mean_seq:.1f}, mean_rank {mst.mean_rank:.2f}); prefill "
        f"{mst.prefill_per_token * 1e9:.4f} ns/token; adapters "
        f"{mst.adapters[0]:.5f} + {mst.adapters[1]:.6f}*A")
    say(f"  decode fit: rms residual "
        f"{math.sqrt(sum(x * x for x in resid) / len(resid)) * 1e6:.2f} us"
        f" over t of {min(r['t'] for r in dec) * 1e6:.2f}-"
        f"{max(r['t'] for r in dec) * 1e6:.2f} us")
    if not (all(map(math.isfinite, list(c) + list(mst.adapters)))
            and math.isfinite(mst.prefill_per_token)):
        raise AssertionError("the measured fit is not finite")

    # base estimators of Eq. (1), fitted as repro.core.pipeline fits them
    profile = HardwareProfile()
    ranks = {i: (8, 16, 32)[i % 3] for i in range(96)}
    ex = SyntheticExecutor(profile, ranks, slots=32, n_adapters=96, seed=0)
    est = fit_estimators(collect_benchmark(ex, 32, 96, ranks),
                         collect_memmax(profile, seed=0), 32, 96)
    pool = make_adapter_pool(PLACEMENT_POOL["n"], PLACEMENT_POOL["ranks"],
                             PLACEMENT_POOL["rates"])
    sweeps = {}
    for label, surface, fast in (("analytic", None, True),
                                 ("measured", mst, True),
                                 ("measured", mst, False)):
        twin = "FastTwin" if fast else "object-mode DigitalTwin"
        t1 = time.perf_counter()
        res = find_optimal_placement(est, pool, measured_step_times=surface,
                                     fast=fast, **PLACEMENT_SWEEP)
        wall = time.perf_counter() - t1
        if res.best is None or not res.throughput > 0:
            raise AssertionError(f"{label} sweep ({twin}) found no placement")
        say(f"  placement ({label} step times, {twin}): N* {res.n_adapters}"
            f", G* {res.slots}, throughput {res.throughput:.1f} tok/s (ideal "
            f"{res.best.ideal:.1f}), {len(res.curve)} twin runs in "
            f"{wall:.3f} s")
        sweeps[(label, fast)] = res
    # the sweep's default twin against the object-mode one: the same
    # (N*, G*), throughput and curve, exactly
    fast, legacy = (tuple([(p.n_adapters, p.slots, p.throughput, p.ideal,
                            p.starved) for p in sweeps[("measured", f)].curve])
                    for f in (True, False))
    if fast != legacy:
        raise AssertionError("the measured sweep's curve differs between "
                             f"FastTwin and DigitalTwin: {fast} != {legacy}")
    say("  measured sweep: FastTwin and the object-mode twin give the same "
        "(N*, G*), throughput and curve")
    say("  note: the measured surface times one layer's fused launch (and "
        "the host's synchronise), not a model step, so the two placements "
        "are not comparable: the measured one shows how small that "
        "surface is")
    say(f"  phase wall {time.perf_counter() - t0:.1f} s")
    placements = {label: (sweeps[(label, True)].n_adapters,
                          sweeps[(label, True)].slots)
                  for label in ("analytic", "measured")}
    return counts, est, mst, placements


# the creation phase's size (repro.core.pipeline.build_pipeline's defaults)
# and phase 7b's budget for it
PIPELINE_SIZE = dict(n_scenarios=40, max_adapters=96, horizon=150.0)
PIPELINE_BUDGET_S = 120.0
SERIAL_CHECK = 4        # scenarios labelled serially as well (7b (d))


def phase_pipeline(est, mst, placements):
    """Phase 7b, the paper's creation phase (Fig. 1) on the card's host:
    (a) ``build_pipeline`` at its defaults (the analytic fit of the
    synthetic H100 profile), its scenarios labelled by W sweep workers;
    (b) the same scenarios labelled on phase 7's measured surface
    (``est.with_measured(mst)``) by W - 1 workers and a forest fitted on
    the first 80 %; (c) each pipeline's held-out sMAPE and ``recommend``
    on phase 7's pool beside phase 7's sweeps; (d) the first SERIAL_CHECK
    scenarios of (b) labelled serially, equal to the runner's labels.
    (d) is the longest single piece (each scenario's sweep one after
    another), so it runs in a thread of this process beside (a) and (b),
    a CPU core left to it.  (b) is labelled in two runner calls, the
    first W - 1 scenarios, then as many more rounds as the budget
    leaves, judged from the first call's wall (a scenario's labels do
    not depend on the call: its seed is its index).  Fails on a
    non-finite feature or label, an N* or G* below 1, an inference of 50
    ms or more, or serial labels that differ."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core import (MODEL_ZOO, PlacementPipeline, SweepRunner,
                                  TARGET_NAMES, WorkloadSpec, build_pipeline,
                                  label_scenarios, make_adapter_pool,
                                  scenario_grid)
    from repro_torch.serving.metrics import smape_vec
    t0 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    size = PIPELINE_SIZE
    say(f"  W = {workers} sweep workers; {size['n_scenarios']} scenarios, "
        f"{size['max_adapters']} adapters, {size['horizon']:.0f} s horizon")
    measured_est = est.with_measured(mst)
    scenarios = scenario_grid(limit=size["n_scenarios"], seed=0)
    label = dict(max_adapters=size["max_adapters"], horizon=size["horizon"])

    def serial():
        t1 = time.perf_counter()
        xd, yd, _ = label_scenarios(measured_est, scenarios[:SERIAL_CHECK],
                                    seed=0, **label)
        return xd, yd, time.perf_counter() - t1

    with ThreadPoolExecutor(1) as thread:
        check = thread.submit(serial)          # (d), beside (a) and (b)

        # (a) the JAX package's creation phase, as it runs it
        t1 = time.perf_counter()
        analytic = build_pipeline(n_workers=workers)
        say(f"  (a) build_pipeline (analytic fit, synthetic h100-llama8b "
            f"profile): {time.perf_counter() - t1:.1f} s")

        # (b) the same scenarios on the measured surface
        w_b = max(workers - 1, 1)
        runner = SweepRunner(measured_est, n_workers=w_b)
        t1 = time.perf_counter()
        xs, ys, _ = label_scenarios(measured_est, scenarios[:w_b],
                                    runner=runner, seed=0, **label)
        first = time.perf_counter() - t1
        left = PIPELINE_BUDGET_S - (time.perf_counter() - t0)
        n = min(len(scenarios), w_b * (1 + max(int(left // first), 0)))
        rest = 0.0
        if n > w_b:
            t1 = time.perf_counter()
            xr, yr, _ = label_scenarios(measured_est, scenarios[w_b:n],
                                        runner=runner, seed=w_b, **label)
            xs, ys = np.concatenate([xs, xr]), np.concatenate([ys, yr])
            rest = time.perf_counter() - t1
        xd, yd, t_serial = check.result()
    if n < len(scenarios):
        say(f"  (b) cut: {n} of {len(scenarios)} scenarios labelled on the "
            f"measured surface ({w_b} workers; the first {w_b} took "
            f"{first:.1f} s; budget {PIPELINE_BUDGET_S:.0f} s)")
    if not (np.all(np.isfinite(xs)) and np.all(np.isfinite(ys))):
        raise AssertionError("phase 7b: a non-finite feature or label")
    model = MODEL_ZOO["forest"]()
    n_train = max(int(0.8 * len(xs)), 1)
    model.fit(xs[:n_train], ys[:n_train])
    report = {}
    if len(xs) > n_train:
        pred = np.asarray(model.predict(xs[n_train:]))
        for j, name in enumerate(TARGET_NAMES):
            report[f"smape_{name}"] = smape_vec(pred[:, j], ys[n_train:, j])
    measured = PlacementPipeline(est=measured_est, model=model,
                                 model_name="forest", fit_report=report)
    at_pool = int(np.sum(ys[:, 1] >= size["max_adapters"]))
    say(f"  (b) {len(xs)} scenarios labelled on the measured surface in "
        f"{first + rest:.1f} s ({first:.1f} s the first {w_b}); N* "
        f"labels {sorted(set(ys[:, 1].astype(int).tolist()))}, G* labels "
        f"{sorted(set(ys[:, 2].astype(int).tolist()))}; {at_pool} of "
        f"{len(xs)} at the pool's size ({size['max_adapters']}): the "
        "surface times one layer's launch, not a model step")

    # (c) each pipeline on phase 7's pool
    pool = make_adapter_pool(PLACEMENT_POOL["n"], PLACEMENT_POOL["ranks"],
                             PLACEMENT_POOL["rates"])
    stats = WorkloadSpec(pool, PLACEMENT_SWEEP["dataset"]).length_stats()
    rates, ranks = [a.rate for a in pool], [a.rank for a in pool]
    out = {}
    for name, pipe in (("analytic", analytic), ("measured", measured)):
        rec = pipe.recommend(rates, ranks, stats)
        smape = {k: round(v, 3) for k, v in pipe.fit_report.items()}
        say(f"  (c) {name} pipeline: held-out sMAPE {smape}; recommend on "
            f"phase 7's pool: throughput {rec['throughput']:.1f} tok/s, N* "
            f"{rec['served_adapters']}, G* {rec['adapter_slots']}, "
            f"inference {rec['inference_ms']:.3f} ms; phase 7's {name} "
            f"sweep: N* {placements[name][0]}, G* {placements[name][1]}")
        if not (math.isfinite(rec["throughput"])
                and all(math.isfinite(v) for v in pipe.fit_report.values())):
            raise AssertionError(f"phase 7b: {name} pipeline not finite")
        if rec["served_adapters"] < 1 or rec["adapter_slots"] < 1:
            raise AssertionError(f"phase 7b: {name} recommends N* or G* < 1")
        if rec["inference_ms"] >= 50.0:
            raise AssertionError(f"phase 7b: {name} recommend took "
                                 f"{rec['inference_ms']} ms")
        out[name] = rec

    # (d) determinism on the card's host
    if not (np.array_equal(xd, xs[:SERIAL_CHECK])
            and np.array_equal(yd, ys[:SERIAL_CHECK])):
        raise AssertionError("phase 7b: serial labels differ from the "
                             f"runner's: {yd.tolist()} != "
                             f"{ys[:SERIAL_CHECK].tolist()}")
    say(f"  (d) the first {SERIAL_CHECK} scenarios labelled serially in "
        f"{t_serial:.1f} s, beside (a) and (b): equal to the runner's "
        "labels")
    wall = time.perf_counter() - t0
    say(f"  phase 7b wall {wall:.1f} s with W = {workers} (budget "
        f"{PIPELINE_BUDGET_S:.0f} s)")
    return out


# --------------------------------------------------------------------------- #

# --------------------------------------------------------------------------- #
# phase 8: training
# --------------------------------------------------------------------------- #

def train_batches(cfg, rows, tokens):
    """The seeded ``TokenPipeline`` of ``rows`` x ``tokens`` (seed 0)."""
    from repro_torch.data import DataConfig, TokenPipeline
    return TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=tokens, global_batch=rows,
                                    seed=0))


def host_available_gb() -> float:
    """The host's available memory (``MemAvailable``), GB."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def phase_train_check(ops):
    """Phase 8a: one ``train_step`` of phi4-mini at its published widths,
    ``TRAIN_CHECK_LAYERS`` layers, f32 (TF32 off), on ``TRAIN_CHECK_BATCH``
    tokens of the seeded pipeline in ``TRAIN_CHECK_MICRO`` microbatches, on
    the card and on the CPU from the same weights: the loss, the gradient
    norm and every gradient leaf (the f32 mean AdamW gets) within
    ||card - cpu||_2 / ||cpu||_2 <= 2e-4 (tests/test_consistency.py:39),
    the worst leaf printed; the card's step launches no kernel wrapper.
    Returns the card step's launch counts."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.training import (TrainConfig, init_train_state,
                                      make_train_step)
    published = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(published, n_layers=TRAIN_CHECK_LAYERS,
                              dtype="float32")
    rows, tokens = TRAIN_CHECK_BATCH
    batch = train_batches(cfg, rows, tokens).batch_at(0)
    tcfg = TrainConfig(microbatches=TRAIN_CHECK_MICRO)
    card = Model(cfg, device="cuda", seed=0)
    cpu = copy.deepcopy(card).to("cpu")
    cpu.device = torch.device("cpu")
    n_params = sum(p.numel() for p in card.parameters())
    ops.reset_launches()
    t0 = time.perf_counter()
    card_step = make_train_step(card, tcfg)
    _, card_info = card_step(init_train_state(card, tcfg), batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    say(f"  8a: {cfg.n_layers} of {published.n_layers} layers at d="
        f"{cfg.d_model}, vocab {cfg.vocab_size}, f32, {n_params / 1e9:.2f}B "
        f"parameters; batch {rows}x{tokens} in {TRAIN_CHECK_MICRO} "
        f"microbatches; card step {card_s:.1f} s; host memory available "
        f"before the CPU step {host_available_gb():.1f} GB")
    t0 = time.perf_counter()
    cpu_step = make_train_step(cpu, tcfg)
    _, cpu_info = cpu_step(init_train_state(cpu, tcfg), batch)
    cpu_s = time.perf_counter() - t0

    def rel(got, want):
        return ((got.double() - want.double()).norm()
                / want.double().norm().clamp(min=1e-30)).item()
    errs = {k: rel(card_info[k].cpu(), cpu_info[k])
            for k in ("loss", "grad_norm", "lr")}
    worst, worst_name = -1.0, ""
    for name, want in cpu_step.grads.items():
        e = rel(card_step.grads[name].cpu(), want)
        if e > worst:
            worst, worst_name = e, name
    ok = max(errs.values()) <= 2e-4 and worst <= 2e-4
    say(f"  8a: CPU step {cpu_s:.1f} s; loss {card_info['loss'].item():.6f} "
        f"(CPU {cpu_info['loss'].item():.6f}), rel {errs['loss']:.3e}; "
        f"grad_norm {card_info['grad_norm'].item():.6f}, rel "
        f"{errs['grad_norm']:.3e}; worst gradient leaf {worst_name} rel "
        f"{worst:.3e} (limit 2e-4) -> {'ok' if ok else 'FAIL'}; launches "
        f"{launches}")
    if not ok:
        raise AssertionError(f"8a: the card's step departs from the CPU's: "
                             f"{errs}, {worst_name} {worst}")
    if any(launches.values()):
        raise AssertionError(f"8a: the train step launched {launches}")
    del card, cpu, card_step, cpu_step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


TRAIN_RANGE = "adamw_update"   # phase 8b's profiler range around the update
TRAIN_PARTS = ("update", "gemm", "other")


def train_split(step, opt, batch):
    """Where the device time of a train step goes: one more step (a ninth,
    after the eight timed ones) under the profiler, every call of
    ``adamw_update`` inside the range ``TRAIN_RANGE`` (wrapped here for
    this step only).  Its wall (synchronised), the kernels it launched,
    the device's busy time and its share of the wall, and the busy time by
    part: the update's kernels, the other cuBLAS products (the layers'
    projections and MLP, attention's f32 einsums, the unembedding; forward,
    recomputation and backward) and the rest (norms, RoPE, softmax, the
    SwiGLU, casts, the loss's glue, the embedding's gradient); the rest's
    largest kernels printed.  Fails if the profiler saw no device time."""
    from unittest import mock
    from repro_torch.training import train_lib
    inner = train_lib.adamw_update

    def marked(*args, **kw):
        with torch.profiler.record_function(TRAIN_RANGE):
            return inner(*args, **kw)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with mock.patch.object(train_lib, "adamw_update", marked):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            _, info = step(opt, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    # each kernel name's share of each part, from the ops that launched it
    # (an op nested in another may list the same kernel: the shares weigh
    # the name's device time from ``key_averages``, which counts it once)
    shares, kernels = {}, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        anc, inside = e, False
        while anc is not None and not inside:
            inside, anc = anc.name == TRAIN_RANGE, anc.cpu_parent
        for k in e.kernels:
            part = ("update" if inside else "gemm" if any(
                w in k.name.lower() for w in GEMM_WORDS) else "other")
            w = shares.setdefault(k.name, dict.fromkeys(TRAIN_PARTS, 0.0))
            w[part] += k.duration
    parts = dict.fromkeys(TRAIN_PARTS, 0.0)
    other, busy = {}, 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                e.key == TRAIN_RANGE:
            continue
        ms = e.self_device_time_total / 1e3
        busy += ms
        kernels += e.count
        w = shares.get(e.key)
        if not w or not sum(w.values()):
            w = {"gemm" if any(g in e.key.lower() for g in GEMM_WORDS)
                 else "other": 1.0}
        total = sum(w.values())
        for part, x in w.items():
            parts[part] += ms * x / total
        if w.get("other"):
            other[e.key] = ms * w["other"] / total
    if busy <= 0:
        raise AssertionError("8b: the profiler saw no device time")
    out = {"profiled_wall_ms": wall, "busy_ms": busy,
           "busy_share": busy / wall, "kernels": kernels,
           "split_ms": parts, "loss": info["loss"].item()}
    say(f"  8b profiled step (a ninth): wall {wall:.1f} ms, busy "
        f"{busy:.1f} ms ({busy / wall:.1%}), {kernels} kernels; update "
        f"{parts['update']:.1f}, cuBLAS products {parts['gemm']:.1f}, the "
        f"rest {parts['other']:.1f} ms; the rest's largest:")
    for ms, key in sorted(((v, k) for k, v in other.items()),
                          reverse=True)[:8]:
        say(f"    {ms:8.2f} ms  {key[:90]}")
    return out


def phase_train(ops, card):
    """Phase 8b: phi4-mini-3.8b published (32 layers, bf16, untied, weights
    from seed 0) trained ``TRAIN_STEPS`` steps on batches 0.. of
    ``TRAIN_BATCH`` (AdamW at lr ``TRAIN_LR``, one warmup step, the other
    defaults; one microbatch).  Prints each step's loss and gradient norm,
    the median step wall (synchronised, steps 2..) and the update's device
    span in it (CUDA events around ``adamw_update``), tokens/s, the share of
    989 TFLOP/s that 6 N tokens a step reach (N: the parameters but the
    input embedding), and the peak memory beside the reckoning.  Fails on a
    non-finite loss or norm, a last loss not below the first, a kernel
    launch, or a parameter left unchanged, unless it is a 1-D tensor of
    ones whose AdamW step stays under half the bf16 spacing below 1.0
    (a norm scale: bf16 without master weights cannot move it).  Then a
    ninth step under the profiler (``train_split``).  Returns its numbers
    and the eight steps' launch counts."""
    from unittest import mock
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, make_train_step,
                                      train_lib)
    cfg = get_config(TRAIN_ARCH)
    rows, tokens = TRAIN_BATCH
    pipe = train_batches(cfg, rows, tokens)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR, warmup_steps=1))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    say(f"  8b: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"before the model")
    model = Model(cfg, device="cuda", seed=0)
    opt = init_train_state(model, tcfg)
    params = train_lib.trainable(model)
    step = make_train_step(model, tcfg)
    n_all = sum(p.numel() for p in params.values())
    n_flop = n_all - model.embed["embed"].numel()
    p_gb = sum(p.numel() * p.element_size() for p in params.values()) / 1e9
    mv_gb = sum(2 * 4 * p.numel() for p in params.values()) / 1e9
    before = {n: p.detach().to("cpu", copy=True)
              for n, p in params.items()}

    spans = []
    real_update = train_lib.adamw_update

    def timed_update(*args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = real_update(*args, **kw)
        end.record()
        spans.append((start, end))
        return out

    losses, norms, walls = [], [], []
    ops.reset_launches()
    with mock.patch.object(train_lib, "adamw_update", timed_update):
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt, info = step(opt, pipe.batch_at(i))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(info["loss"].item())
            norms.append(info["grad_norm"].item())
            say(f"  8b step {i + 1}: loss {losses[-1]:.4f}, grad_norm "
                f"{norms[-1]:.4f}, lr {info['lr'].item():.3e}, "
                f"{walls[-1]:.1f} ms")
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    update_ms = [s.elapsed_time(e) for s, e in spans]
    step_ms = float(np.median(walls[1:]))
    upd_ms = float(np.median(update_ms[1:]))
    tok = rows * tokens
    stats = {"arch": TRAIN_ARCH, "layers": cfg.n_layers, "dtype": cfg.dtype,
             "batch": [rows, tokens], "steps": TRAIN_STEPS,
             "losses": losses, "grad_norms": norms, "step_walls_ms": walls,
             "update_ms": update_ms, "step_ms": step_ms,
             "update_ms_median": upd_ms,
             "tokens_per_s": tok / step_ms * 1e3,
             "params": n_all, "flop_params": n_flop,
             "flops_per_step": 6 * n_flop * tok,
             "flop_share_bf16_peak": 6 * n_flop * tok / (step_ms / 1e3)
             / PEAK_FLOPS["bfloat16"],
             "peak_gb": peak_gb, "params_gb": p_gb, "grads_gb": p_gb,
             "moments_gb": mv_gb, "reckoned_gb": 2 * p_gb + mv_gb,
             "card": card}
    say(f"  8b: {n_all / 1e9:.2f}B parameters ({n_flop / 1e9:.2f}B without "
        f"the input embedding); step {step_ms:.1f} ms (median of steps 2-"
        f"{TRAIN_STEPS}), update {upd_ms:.1f} ms of it; "
        f"{stats['tokens_per_s']:.0f} tokens/s; 6*N*tokens "
        f"{stats['flops_per_step'] / 1e12:.1f} TFLOP a step, "
        f"{stats['flop_share_bf16_peak']:.1%} of 989 TFLOP/s; peak "
        f"{peak_gb:.1f} GB against {stats['reckoned_gb']:.1f} GB reckoned "
        f"(parameters {p_gb:.1f}, gradients {p_gb:.1f}, f32 m and v "
        f"{mv_gb:.1f}) before activations; launches {launches}; card {card}")

    frozen = []
    bound = tcfg.optimizer.lr * (2 + tcfg.optimizer.weight_decay)
    for name, p in params.items():
        if torch.equal(before[name], p.detach().cpu()):
            if not (p.dim() == 1 and bool((p == 1).all())
                    and bound < 2.0 ** -9):
                raise AssertionError(f"8b: parameter {name} did not change")
            frozen.append(name)
    say(f"  8b: {len(params) - len(frozen)} of {len(params)} parameters "
        f"changed; {len(frozen)} norm scales of ones did not (an AdamW step "
        f"under {bound:.1e} < half the bf16 spacing below 1.0, "
        f"{2.0 ** -9:.2e})")
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"8b: non-finite loss or norm: {losses}, "
                             f"{norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"8b: the loss did not fall: {losses}")
    if any(launches.values()):
        raise AssertionError(f"8b: the train steps launched {launches}")
    stats.update(train_split(step, opt, pipe.batch_at(TRAIN_STEPS)))
    del model, opt, step, params, before
    gc.collect()
    torch.cuda.empty_cache()
    return stats, launches


def phase_checkpoint(ops, card):
    """Phase 9: the loop around the training step.  phi4-mini-3.8b at its
    published widths, ``TRAIN_CHECK_LAYERS`` layers, bf16, untied, weights
    from seed 0, trained on ``TRAIN_BATCH`` batches (AdamW at lr
    ``TRAIN_LR``, one warmup step).  Run A: ``FaultTolerantLoop.
    run_with_restarts`` over ``CKPT_STEPS`` steps, a checkpoint every
    ``CKPT_EVERY`` (async, the last ``CKPT_KEEP`` kept), a crash injected at
    step ``CKPT_FAIL``: one restart, resumed from step ``CKPT_EVERY``, the
    AdamW step at ``CKPT_STEPS``.  Run B: the same steps from the same seed
    without a crash or a checkpoint; its parameters, m and v bit for bit
    run A's.  The newest checkpoint restored onto the CPU bit for bit the
    card's state.  Before any save the free space under ``CKPT_DIR`` must
    hold two checkpoints.  Then ``python -m repro_torch.launch.train
    --reduced`` run to each of ``LAUNCH_STEPS`` on one directory, the
    second printing ``resumed from step`` the first's end.  Prints the
    bytes of a checkpoint, each save's snapshot and write seconds, the
    resume's and the CPU restore's seconds and the steps' walls; the
    directory is removed at the end.  Returns the numbers and run A's
    launch counts (none: training runs no kernel of the port's)."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.configs import get_config
    from repro_torch.launch.fault_tolerance import FaultTolerantLoop, FTConfig
    from repro_torch.models import Model
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, make_train_step,
                                      train_lib)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TRAIN_CHECK_LAYERS)
    rows, tokens = TRAIN_BATCH
    pipe = train_batches(cfg, rows, tokens)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR, warmup_steps=1))
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    try:
        model = Model(cfg, device="cuda", seed=0)
        state = {"params": train_lib.trainable(model),
                 "opt": init_train_state(model, tcfg)}
        leaves = _flatten(state).values()
        ckpt_bytes = sum(t.numel() * t.element_size() for t in leaves)
        free = shutil.disk_usage(CKPT_DIR).free
        say(f"  9: {cfg.n_layers} of {get_config(TRAIN_ARCH).n_layers} "
            f"layers at d={cfg.d_model}, {cfg.dtype}, "
            f"{sum(p.numel() for p in state['params'].values()) / 1e9:.2f}B "
            f"parameters; a checkpoint {ckpt_bytes / 1e9:.2f} GB "
            f"({len(leaves)} leaves); {free / 1e9:.1f} GB free under "
            f"{CKPT_DIR}")
        if free < 2 * ckpt_bytes:
            raise RuntimeError(f"9: {free / 1e9:.1f} GB free under "
                               f"{CKPT_DIR}, two checkpoints need "
                               f"{2 * ckpt_bytes / 1e9:.1f} GB")
        step_fn = make_train_step(model, tcfg)

        def one(s, batch):
            return {"params": s["params"],
                    "opt": step_fn(s["opt"], batch)[0]}

        loop = FaultTolerantLoop(FTConfig(
            str(CKPT_DIR / "run_a"), checkpoint_every=CKPT_EVERY,
            keep=CKPT_KEEP), state)
        resume = loop.resume_or_init
        resumes = []

        def timed_resume(init_fn):
            t0 = time.perf_counter()
            out = resume(init_fn)
            torch.cuda.synchronize()
            resumes.append(time.perf_counter() - t0)
            return out
        loop.resume_or_init = timed_resume
        ops.reset_launches()
        out_a = loop.run_with_restarts(lambda: state, one, pipe.batch_at,
                                       CKPT_STEPS, failure_at=CKPT_FAIL)
        launches = ops.launch_counts()
        rep = loop.report
        step_a = int(out_a["opt"]["step"])
        say(f"  9 run A: restarts {rep.restarts}, resumed from "
            f"{rep.resumed_from}, {rep.steps_run} steps run, AdamW step "
            f"{step_a}; committed {loop.mgr.steps()}; step walls (ms) "
            + ", ".join(f"{t * 1e3:.1f}" for t in rep.step_times)
            + "; saves " + ", ".join(
                f"step {t['step']}: snapshot {t['snapshot_s']:.2f} s, write "
                f"{t['write_s']:.2f} s" for t in loop.mgr.timings)
            + f"; resume (restore + copy onto the card) {resumes[-1]:.2f} s;"
            f" launches {launches}")
        if (rep.restarts, rep.resumed_from, step_a) != (1, CKPT_EVERY,
                                                        CKPT_STEPS):
            raise AssertionError(f"9 run A: restarts {rep.restarts}, "
                                 f"resumed from {rep.resumed_from}, step "
                                 f"{step_a}")
        if any(launches.values()):
            raise AssertionError(f"9: the train steps launched {launches}")

        model_b = Model(cfg, device="cuda", seed=0)
        opt_b = init_train_state(model_b, tcfg)
        step_b = make_train_step(model_b, tcfg)
        for i in range(CKPT_STEPS):
            opt_b, _ = step_b(opt_b, pipe.batch_at(i))
        flat_a = _flatten(out_a)
        flat_b = _flatten({"params": train_lib.trainable(model_b),
                           "opt": opt_b})
        differ = [k for k, t in flat_a.items()
                  if not torch.equal(t, flat_b[k])]
        say(f"  9 run B (no crash, no checkpoint): {len(flat_b) - len(differ)}"
            f" of {len(flat_b)} leaves bit for bit run A's")
        if differ:
            raise AssertionError(f"9: run A departs from run B: {differ[:5]}")
        del model_b, opt_b, step_b, flat_b

        t0 = time.perf_counter()
        on_cpu = _flatten(loop.mgr.restore(out_a, device="cpu"))
        restore_s = time.perf_counter() - t0
        differ = [k for k, t in flat_a.items()
                  if on_cpu[k].device.type != "cpu"
                  or not torch.equal(on_cpu[k], t.cpu())]
        say(f"  9: step {loop.mgr.latest_step()} restored onto the CPU in "
            f"{restore_s:.2f} s; {len(on_cpu) - len(differ)} of "
            f"{len(on_cpu)} leaves bit for bit the card's")
        if differ:
            raise AssertionError(f"9: the CPU restore departs: {differ[:5]}")
        stats = {"arch": TRAIN_ARCH, "layers": cfg.n_layers,
                 "dtype": cfg.dtype, "batch": [rows, tokens],
                 "checkpoint_bytes": ckpt_bytes, "saves": loop.mgr.timings,
                 "resume_s": resumes[-1], "cpu_restore_s": restore_s,
                 "step_walls_ms": [t * 1e3 for t in rep.step_times],
                 "restarts": rep.restarts, "resumed_from": rep.resumed_from,
                 "card": card}
        del model, state, out_a, flat_a, on_cpu, loop
        gc.collect()
        torch.cuda.empty_cache()

        launch_dir = CKPT_DIR / "launcher"
        env = {**os.environ, "PYTHONPATH": str(SRC)}
        for n in LAUNCH_STEPS:
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                 TRAIN_ARCH, "--reduced", "--steps", str(n),
                 "--checkpoint-every", str(LAUNCH_EVERY), "--checkpoint-dir",
                 str(launch_dir)], env=env, cwd=ROOT, capture_output=True,
                text=True, timeout=600)
            if run.returncode:
                raise AssertionError(f"9 launcher --steps {n}: exit "
                                     f"{run.returncode}: {run.stderr[-2000:]}")
            lines = run.stdout.strip().splitlines()
            say(f"  9 launcher --steps {n} ({time.perf_counter() - t0:.1f} s):"
                f" " + " | ".join(lines))
            resumed = [ln for ln in lines if ln.startswith("resumed from")]
            want = [] if n == LAUNCH_STEPS[0] else \
                [f"resumed from step {LAUNCH_STEPS[0]}"]
            if resumed != want or not lines[-1].startswith(f"done: {n} steps"):
                raise AssertionError(f"9 launcher --steps {n}: {lines}")
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return stats, launches


def phase_serve(arch, ops, kv_quant=False):
    """Serve ``arch`` at its published widths (bf16, weights from seed 0;
    with ``kv_quant`` an int8 KV cache) with the launcher's default flags,
    every step but the warmup a replay of the executor's captured step; at
    least 12 requests must finish, the logits be finite, BGMV and
    flash-decode have launched where the model has attention layers
    (mamba2 has none: its path launches no kernel wrapper), and the
    launches be the warmup's and the replays'; then ``check_replay``.
    Returns the executor and the serving path's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_parser, report, serve
    args = build_parser().parse_args([])   # the launcher's defaults
    t0 = time.perf_counter()
    ops.reset_launches()
    metrics, executor = serve(get_config(arch), args, kv_quant=kv_quant)
    serve_launches = ops.launch_counts()
    wall = time.perf_counter() - t0
    say(report(metrics))
    logits = executor.last_logits
    say(f"  wall {wall:.1f} s; launches on the serving path: "
        f"{serve_launches}; {executor.replays} replays of the captured step, "
        f"{executor.graph_launches} each, after one eager warmup step")
    if metrics.n_finished < 12:
        raise AssertionError(f"served only {metrics.n_finished} requests")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("serving produced non-finite logits")
    # decode batches of 8 rows on 4 slots stay at T <= 4N: BGMV, not SGMV
    if attention_layers(executor.model.cfg):
        require_launched("serving", serve_launches, PATH_KERNELS["serving"])
    # every step but the warmup was a replay, counted by the executor
    if executor.replays == 0 or serve_launches != {
            k: executor.graph_launches.get(k, 0) * (executor.replays + 1)
            for k in serve_launches}:
        raise AssertionError("the serving path's launches are not the "
                             "warmup's and the replays'")
    check_replay(executor)
    return executor, serve_launches


def serve_variant(arch, phase, ops, kv_quant=False):
    """Phase 5``phase``: serve ``arch`` at its published widths
    (``phase_serve``; with ``kv_quant`` on an int8 KV cache), hold each
    replay to one BGMV launch per LoRA target and one flash-decode per
    attention layer (an rglru or ssd layer launches neither), and time its
    replayed step (``phase_step``; phase 6``phase``,
    or part of 5``phase`` with ``kv_quant``).  Returns the executor, the
    serving path's launches and the step's numbers."""
    from repro_torch.configs import get_config
    cache = ("an int8 KV cache" if kv_quant else "a bf16 KV cache"
             if attention_layers(get_config(arch)) else "no KV cache")
    say(f"phase 5{phase}: serving {arch} (published widths, bf16, {cache})")
    executor, launches = phase_serve(arch, ops, kv_quant)
    n_attn = attention_layers(executor.model.cfg)
    want = {k: n for k, n in (("bgmv", 2 * n_attn),
                              ("flash_decode", n_attn)) if n}
    if executor.graph_launches != want:
        raise AssertionError(f"{arch}: a replay launches "
                             f"{executor.graph_launches}, not {want}")
    if kv_quant:
        say(f"  {arch}'s replayed step on the int8 cache, {CACHE} positions")
    else:
        say(f"phase 6{phase}: {arch}'s replayed step (bf16)")
    _, stats = phase_step(executor, ops)
    return executor, launches, stats


def fill_cache(cache, seed, pos):
    """Fill every cache tensor with seeded draws, as a long prompt would
    leave it without running one: a global layer's K/V bf16 normals, or
    in an int8 cache their ``quantize_kv`` with its scales (the same
    normals for both from one seed); every other leaf (a local layer's
    rolling ``k_loc``/``v_loc``, an rglru layer's ``conv``/``lru``, an
    ssd layer's ``conv_x``/``conv_bc``/``ssm`` states) normals in its own
    dtype; set the device ``pos``."""
    from repro_torch.models.attention import quantize_kv
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for c in cache["layers"]:
        for name, t in c.items():
            if name.endswith("_scale"):
                continue            # drawn with its int8 tensor
            quant = f"{name}_scale" in c
            x = torch.randn(t.shape, generator=gen, device="cuda",
                            dtype=torch.bfloat16 if quant else t.dtype)
            if quant:
                x, scale = quantize_kv(x)
                c[f"{name}_scale"].copy_(scale)
            t.copy_(x)
            del x
    cache["pos"].fill_(pos)
    torch.cuda.synchronize()


def decode_bound(model, cache):
    """The least time of one decode step over ``cache``: the bytes of every
    weight it reads (as ``step_bound``) and of every K/V and scale tensor
    of the cache, read once in full, over the HBM rate."""
    weights, _ = weight_bytes(model)
    kv = sum(t.numel() * t.element_size()
             for c in cache["layers"] for t in c.values())
    return {"weight_gb": weights / 1e9, "kv_gb": kv / 1e9,
            "weights_ms": weights / HBM_BYTES_PER_S * 1e3,
            "kv_ms": kv / HBM_BYTES_PER_S * 1e3,
            "bound_ms": (weights + kv) / HBM_BYTES_PER_S * 1e3}


def phase_long_step(ops):
    """Phase 6d: phi4-mini's replayed decode step (published widths, bf16
    weights, B 8) over caches of LONG_S positions, once with a bf16 cache
    and once with an int8 one, one after the other, the first freed: the
    caches filled by ``fill_cache`` (no prefill), ``pos`` 16 short of the
    end (the timed steps run past it: the write skipped, all LONG_S
    positions attended).  Each step's wall, span, busy time and
    flash-decode's share (``phase_step``) beside its byte bound
    (``decode_bound``).  Returns {"bf16": ..., "int8": ...} and the int8
    run's launches per step."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving.executor import TorchExecutor
    cfg = get_config("phi4-mini-3.8b")
    out, launches = {}, {}
    for label, quant in (("bf16", False), ("int8", True)):
        t0 = time.perf_counter()
        model = Model(cfg, device="cuda", seed=0, kv_quant=quant)
        lora = model.init_lora(SLOTS, RANK, seed=0)
        executor = TorchExecutor(model, lora, max_batch=BATCH,
                                 cache_len=LONG_S, device="cuda")
        fill_cache(executor.cache, seed=7, pos=LONG_S - 16)
        say(f"  {label} KV cache of {LONG_S} positions: built and filled in "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
        launches, stats = phase_step(executor, ops)
        stats.update(decode_bound(model, executor.cache))
        stats["busy_over_bound"] = stats["replay_busy_ms"] / stats["bound_ms"]
        say(f"  {label} step over {LONG_S} positions: wall "
            f"{stats['replay_ms']:.2f} ms, span {stats['replay_span_ms']:.2f}"
            f", busy {stats['replay_busy_ms']:.2f} (flash-decode "
            f"{stats['replay_flash_decode_share']:.1%}); bound "
            f"{stats['bound_ms']:.2f} ms ({stats['weight_gb']:.2f} GB of "
            f"weights, {stats['kv_gb']:.2f} GB of K/V), busy "
            f"{stats['busy_over_bound']:.2f}x it")
        out[label] = stats
        del executor, model, lora
        torch.cuda.empty_cache()
    return out, launches


# --------------------------------------------------------------------------- #
# phase 10: the sharded decode
# --------------------------------------------------------------------------- #

def check_lse_values(name, got, want, dtype_name, errs):
    """A log-sum-exp against its plain version: -inf (a length of 0) at
    the same places, the rest finite and within TOL of ``dtype_name``."""
    torch.cuda.synchronize()
    empty = torch.isneginf(want)
    ok = torch.equal(torch.isneginf(got), empty)
    g, w = got[~empty], want[~empty]
    tol = TOL[dtype_name]
    ok = ok and bool(torch.isfinite(g).all()) and \
        torch.allclose(g, w, rtol=tol, atol=tol)
    err = (g - w).abs().max().item()
    say(f"  {name} [{dtype_name}] max_abs_err={err:.3e} tol={tol}, "
        f"{int(empty.sum())} rows at -inf -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} [{dtype_name}] disagrees with its plain "
                             f"version: max_abs_err={err}")
    errs["flash_decode_lse"] = max(errs.get("flash_decode_lse", 0.0), err)


def check_lse_mode(errs):
    """Phase 10a: flash-decode's log-sum-exp mode against its plain
    versions at ``LSE_SHAPES``, B 8 over CACHE positions, ragged lengths
    with 0 and 1 among them: the bf16/f32 mode (q, K, V in bf16 and in
    f32) and the int8 mode (q in bf16 and in f32; f32 against the plain
    version with exact q . k), at the tolerance of q's dtype.  Its output
    (f32, the merge before the cast) rounded to q's dtype is bit for bit
    the call without the log-sum-exp (the same split pass, the same merge
    in a combine kernel of its own)."""
    from repro_torch.kernels import flash_decode
    from repro_torch.models.attention import quantize_kv
    fd, fd_lse = flash_decode.flash_decode, flash_decode.flash_decode_lse
    inp = Inputs(seed=10)
    lengths = torch.randint(1, CACHE + 1, (BATCH,), generator=inp.gen,
                            device="cuda", dtype=torch.int32)
    lengths[:3] = torch.tensor([0, 1, CACHE], device="cuda")
    for label, h, kv, d in LSE_SHAPES:
        q = inp.normal(BATCH, h, d, dtype=torch.float32)
        k = inp.normal(BATCH, CACHE, kv, d, dtype=torch.float32)
        v = inp.normal(BATCH, CACHE, kv, d, dtype=torch.float32)
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        for dt in (torch.bfloat16, torch.float32):
            dn = str(dt).split(".")[1]
            qd = q.to(dt)
            for mode, kv_args in (("", (k.to(dt), v.to(dt))),
                                  (" int8", (k8, v8))):
                scales = (ks, vs) if mode else ()
                out, lse = fd_lse(qd, *kv_args, lengths, *scales)
                check(f"flash_decode_lse{mode} {label} out in {dn}, the "
                      "call without it", out.to(dt),
                      fd(qd, *kv_args, lengths, *scales), dn, errs,
                      exact=True)
                if mode:
                    want, want_lse = flash_decode.flash_decode_int8_plain(
                        qd, *kv_args, lengths, *scales,
                        exact_dot=dt == torch.float32, return_lse=True)
                else:
                    want, want_lse = flash_decode.flash_decode_plain(
                        qd, *kv_args, lengths, return_lse=True)
                check(f"flash_decode_lse{mode} {label} out", out, want, dn,
                      errs, per_row=True)
                check_lse_values(f"flash_decode_lse{mode} {label} lse", lse,
                                 want_lse, dn, errs)
        del q, k, v, k8, v8, ks, vs
    torch.cuda.empty_cache()


def lse_row(card):
    """The log-sum-exp mode's row at phi4-mini's serving shape (B 8, S
    CACHE, all positions, bf16): its time, the same call's without the
    log-sum-exp on the same inputs (``no_lse_ms``), its plain version's,
    its two kernels (profiled), its bound (q, K and V read once, the f32
    output and the log-sum-exp written) and ``torch.ops.aten.
    _scaled_dot_product_efficient_attention`` with ``compute_log_sumexp``
    on the same inputs, its K and V repeated to H heads (it takes no
    GQA), or None where that call does not run."""
    from repro_torch.kernels import flash_decode
    inp = Inputs(seed=11)
    dt = torch.bfloat16

    def make():
        return (inp.normal(BATCH, HEADS, HEAD_DIM, dtype=dt),
                inp.normal(BATCH, CACHE, KV_HEADS, HEAD_DIM, dtype=dt),
                inp.normal(BATCH, CACHE, KV_HEADS, HEAD_DIM, dtype=dt),
                CACHE)
    flops, nbytes = kernel_cost.flash_decode_cost(
        BATCH, CACHE, HEADS, KV_HEADS, HEAD_DIM, out_bytes=4, lse=True)
    sets = copies(make, nbytes)
    b_ms, b_by = bound(nbytes, flops, "bfloat16")

    lse_call = flash_decode.flash_decode_lse

    def plain(q, k, v, length):
        return flash_decode.flash_decode_plain(q, k, v, length,
                                               return_lse=True)
    split = profiled_ms(lse_call, sets, FD_LSE_KERNELS)
    row = {"ms": graph_ms(lse_call, sets),
           "no_lse_ms": graph_ms(flash_decode.flash_decode, sets),
           "plain_ms": graph_ms(plain, sets),
           "bound_ms": b_ms, "bound_by": b_by,
           "split_ms": split["fd_split_kernel"],
           "combine_ms": split["fd_combine_lse_kernel"]}
    g = HEADS // KV_HEADS
    lib_sets = [(q[:, :, None],
                 k.transpose(1, 2).repeat_interleave(g, 1).contiguous(),
                 v.transpose(1, 2).repeat_interleave(g, 1).contiguous())
                for q, k, v, _ in sets[:8]]

    def library(q, k, v):
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            q, k, v, None, True)
    try:
        got = library(*lib_sets[0])
        ref, ref_lse = lse_call(*sets[0])
        torch.cuda.synchronize()
        lib_err = (got[1][:, :, 0] - ref_lse).abs().max().item()
        row.update(library_ms=graph_ms(library, lib_sets),
                   library_call="aten._scaled_dot_product_efficient_"
                                "attention(compute_log_sumexp=True), K/V "
                                f"repeated to {HEADS} heads",
                   library_lse_max_abs_diff=lib_err)
    except RuntimeError as e:   # the call does not take these inputs
        say(f"  _scaled_dot_product_efficient_attention does not run here: "
            f"{str(e).splitlines()[0][:160]}")
        row.update(library_ms=None, library_call="none")
    say(f"  flash_decode_lse at B {BATCH} S {CACHE}: {row['ms'] * 1e3:.2f} us"
        f" (split {row['split_ms'] * 1e3:.2f}, combine "
        f"{row['combine_ms'] * 1e3:.2f}; without the log-sum-exp "
        f"{row['no_lse_ms'] * 1e3:.2f}); plain {row['plain_ms'] * 1e3:.2f} "
        f"us; bound {b_ms * 1e3:.3f} us by {b_by}; library "
        f"{row['library_ms']} ms ({row['library_call']}); {card}")
    return row


def phase_shard_slices(errs, card):
    """Phase 10b: the arithmetic every rank of a sequence-sharded cache
    runs, in one process: phi4-mini's heads (B 8, H 24, KV 8, D 128) over
    LONG_S positions, a bf16 and an int8 cache (q bf16), cut into
    SHARD_SLICES slices (contiguous copies); each slice's flash-decode with
    its log-sum-exp (its output in f32), then ``attention.combine_shards``
    over the stacked slices and one cast to bf16, as
    ``decode_attention_sharded`` does, held to the unsharded kernel at
    bf16's tolerance and per row
    (each int8 slice rounds P * v_scale against its own max, as the JAX
    body does), full and ragged lengths (a ragged row ends in an earlier
    slice: the later ones weigh 0).  Prints the unsharded call's, each
    slice's and the combine's microseconds beside their byte bounds.
    Returns the timings."""
    from repro_torch.kernels import flash_decode
    from repro_torch.models.attention import combine_shards, quantize_kv
    fd, fd_lse = flash_decode.flash_decode, flash_decode.flash_decode_lse
    inp = Inputs(seed=6)
    n, s_loc = SHARD_SLICES, LONG_S // SHARD_SLICES
    ragged = torch.randint(1, LONG_S + 1, (BATCH,), generator=inp.gen,
                           device="cuda", dtype=torch.int32)
    ragged[:2] = torch.tensor([LONG_S - 1, 1], device="cuda")
    q = inp.normal(BATCH, HEADS, HEAD_DIM, dtype=torch.bfloat16)
    k = inp.normal(BATCH, LONG_S, KV_HEADS, HEAD_DIM, dtype=torch.bfloat16)
    v = inp.normal(BATCH, LONG_S, KV_HEADS, HEAD_DIM, dtype=torch.bfloat16)
    stacked = {"max": lambda t: t.amax(0, keepdim=True),
               "sum": lambda t: t.sum(0, keepdim=True)}

    def reduce(t, op):
        return stacked[op](t)
    out = {}
    for cache in ("bf16", "int8"):
        if cache == "int8":
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
            whole_kv = (k, v, ks, vs)
        else:
            whole_kv = (k, v)
        slices = [tuple(t[:, i * s_loc:(i + 1) * s_loc].contiguous()
                        for t in whole_kv) for i in range(n)]

        def slice_lengths(length):
            if isinstance(length, int):
                return [min(max(length - i * s_loc, 0), s_loc)
                        for i in range(n)]
            return [(length - i * s_loc).clamp(0, s_loc) for i in range(n)]

        def sharded(length):
            parts = [fd_lse(q, sl[0], sl[1], li, *sl[2:])
                     for sl, li in zip(slices, slice_lengths(length))]
            return combine_shards(torch.stack([p[0] for p in parts]),
                                  torch.stack([p[1] for p in parts]),
                                  reduce)[0].to(q.dtype)
        for name, length in (("full", LONG_S), ("ragged", ragged)):
            check(f"flash_decode_lse {n} slices {cache} B {BATCH} S {LONG_S}"
                  f" {name} lengths, against the unsharded kernel",
                  sharded(length), fd(q, k, v, length, *whole_kv[2:]),
                  "bfloat16", errs, per_row=True)
        kv_bytes = sum(t.numel() * t.element_size() for t in whole_kv)
        io = 2 * BATCH * HEADS * HEAD_DIM * 2
        whole_ms = graph_ms(lambda: fd(q, *whole_kv[:2], LONG_S,
                                       *whole_kv[2:]), [()], calls=8, reps=3)
        slice_ms = [graph_ms(lambda sl=sl: fd_lse(q, sl[0], sl[1], s_loc,
                                                  *sl[2:]),
                             [()], calls=8, reps=3) for sl in slices]
        parts = [fd_lse(q, sl[0], sl[1], s_loc, *sl[2:]) for sl in slices]
        outs = torch.stack([p[0] for p in parts])
        lses = torch.stack([p[1] for p in parts])
        comb_ms = graph_ms(lambda: combine_shards(outs, lses, reduce)
                           .to(q.dtype), [()])
        comb_bytes = outs.numel() * 4 + lses.numel() * 4 + io // 2
        lib_us = None
        if cache == "bf16":   # the library's log-sum-exp call on slice 0
            g = HEADS // KV_HEADS
            lib = (q[:, :, None],
                   slices[0][0].transpose(1, 2).repeat_interleave(g, 1)
                   .contiguous(),
                   slices[0][1].transpose(1, 2).repeat_interleave(g, 1)
                   .contiguous())
            try:
                lib_us = graph_ms(
                    lambda: torch.ops.aten
                    ._scaled_dot_product_efficient_attention(
                        *lib, None, True), [()], calls=8, reps=3) * 1e3
            except RuntimeError as e:   # the call does not take them
                say(f"  _scaled_dot_product_efficient_attention does not "
                    f"run on a slice: {str(e).splitlines()[0][:160]}")
            del lib
        out[cache] = {
            "whole_us": whole_ms * 1e3,
            "whole_bound_us": (kv_bytes + io) / HBM_BYTES_PER_S * 1e6,
            "slice_us": [t * 1e3 for t in slice_ms],
            "slice_bound_us": (kv_bytes / n + io) / HBM_BYTES_PER_S * 1e6,
            "slice_library_us": lib_us,
            "combine_us": comb_ms * 1e3,
            "combine_bound_us": comb_bytes / HBM_BYTES_PER_S * 1e6}
        o = out[cache]
        say(f"  {cache} cache of {LONG_S} positions in {n} slices: unsharded "
            f"{o['whole_us']:.1f} us (bound {o['whole_bound_us']:.1f}); "
            f"slices {', '.join(f'{t:.1f}' for t in o['slice_us'])} us "
            f"(bound {o['slice_bound_us']:.1f} each; library "
            f"{o['slice_library_us']}); combine "
            f"{o['combine_us']:.1f} us (bound {o['combine_bound_us']:.2f}); "
            f"{card}")
        del slices, parts, outs, lses
    del q, k, v, whole_kv
    torch.cuda.empty_cache()
    return out


def planned_pair(cfg, plan):
    """A model of ``cfg`` without a plan and one under ``plan`` (bf16,
    weights from seed 0), the LoRA banks, and both models' caches after a
    prefill of BATCH x (SHARD_CACHE - SHARD_STEPS) tokens on the model
    without a plan, padded to SHARD_CACHE rows (for the planned model cut
    by ``shard_cache``); with the tokens and adapter ids."""
    from repro_torch.models import Model
    from repro_torch.models.sharding import shard_cache
    ref = Model(cfg, device="cuda", seed=0)
    model = Model(cfg, device="cuda", seed=0, plan=plan)
    lora = ref.init_lora(SLOTS, RANK, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(12)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SHARD_CACHE),
                           generator=gen, device="cuda")
    idx = (torch.arange(BATCH, device="cuda") % SLOTS).to(torch.int32)
    _, cache = ref.prefill(lora, tokens[:, :SHARD_CACHE - SHARD_STEPS], idx)
    cache = ref.pad_cache(cache, SHARD_STEPS)
    planned = shard_cache(cache, plan)
    torch.cuda.synchronize()
    return ref, model, lora, cache, planned, tokens, idx


def decode_against_plan(ops, ref, model, lora, cache, planned, tokens, idx,
                        label, prompt=SHARD_CACHE - SHARD_STEPS):
    """SHARD_STEPS decode steps of ``model`` (under a plan, on ``planned``)
    and then of ``ref`` (without, on ``cache``), after the prompt in
    ``tokens``: each planned step's logits finite and within 2e-4 (rel,
    tests/test_consistency.py:39) of the step without a plan.  Returns the
    numbers (the max rel, whether every step was bitwise equal, each
    path's first step's wall and the median of the others, host clock,
    synchronised; the collectives a step; the host time a planned step
    spends in them and in ``attention.combine_shards``, ``host_spans``)
    and the planned path's launch counts."""
    from repro_torch.models.sharding import COLLECTIVES, reset_collectives
    walls = {"plan": [], "no_plan": []}
    got, spans = [], []
    ops.reset_launches()
    reset_collectives()
    for i in range(SHARD_STEPS):
        t1 = time.perf_counter()
        with host_spans() as span:
            logits, _ = model.decode_step(
                lora, planned, tokens[:, prompt + i:prompt + i + 1], idx)
            torch.cuda.synchronize()
        walls["plan"].append(time.perf_counter() - t1)
        got.append(logits)
        spans.append(span)
    launches = ops.launch_counts()
    collectives = {k: n / SHARD_STEPS for k, n in COLLECTIVES.items()}
    rels, bitwise = [], True
    for i in range(SHARD_STEPS):
        t1 = time.perf_counter()
        want, _ = ref.decode_step(lora, cache,
                                  tokens[:, prompt + i:prompt + i + 1], idx)
        torch.cuda.synchronize()
        walls["no_plan"].append(time.perf_counter() - t1)
        if not bool(torch.isfinite(got[i]).all()):
            raise AssertionError(f"{label}: step {i} under the plan: "
                                 "non-finite logits")
        rel = ((got[i] - want).abs().max()
               / want.abs().max().clamp(min=1e-9)).item()
        rels.append(rel)
        bitwise = bitwise and torch.equal(got[i], want)
        if rel >= 2e-4:
            raise AssertionError(f"{label}: step {i} under the plan departs "
                                 f"from the step without it: rel {rel:.3e}")
    stats = {"steps": SHARD_STEPS, "positions": prompt + SHARD_STEPS,
             "max_rel": max(rels), "bitwise": bitwise,
             "plan_first_step_ms": walls["plan"][0] * 1e3,
             "no_plan_first_step_ms": walls["no_plan"][0] * 1e3,
             "plan_step_ms": float(np.median(walls["plan"][1:])) * 1e3,
             "no_plan_step_ms":
                 float(np.median(walls["no_plan"][1:])) * 1e3,
             "collectives_per_step": collectives,
             **{f"plan_{k}_host_ms": float(np.median(
                 [sp[k] for sp in spans[1:]])) * 1e3 for k in spans[0]}}
    n_coll = sum(collectives.values())
    stats["host_us_per_collective"] = 1e3 * (
        stats["plan_collectives_host_ms"]
        + stats["plan_combine_collectives_host_ms"]) / max(n_coll, 1)
    return stats, launches


def say_planned(label, stats, launches, card):
    say(f"  {label}: {SHARD_STEPS} steps under the plan against the steps "
        f"without: max rel {stats['max_rel']:.3e} (tol 2e-4), bitwise "
        f"{stats['bitwise']}; step wall {stats['plan_step_ms']:.2f} ms "
        f"under the plan, {stats['no_plan_step_ms']:.2f} ms without (median"
        f" of steps 2-{SHARD_STEPS}, eager, host clock; the first "
        f"{stats['plan_first_step_ms']:.2f} and "
        f"{stats['no_plan_first_step_ms']:.2f}); collectives a step "
        f"{stats['collectives_per_step']}; launches {launches}; {card}")
    say(f"  {label}: host time of a planned step (median of steps "
        f"2-{SHARD_STEPS}, with the spans on): "
        f"{stats['plan_collectives_host_ms']:.2f} ms in the collectives "
        f"outside the combine, {stats['plan_combine_host_ms']:.2f} ms in "
        f"combine_shards, of which "
        f"{stats['plan_combine_collectives_host_ms']:.2f} ms in its "
        f"all-reduces; {stats['host_us_per_collective']:.1f} us a "
        f"collective; {card}")


def phase_sharded_step(ops, card):
    """Phase 10c: phi4-mini-3.8b at its published widths (32 layers, bf16,
    weights from seed 0) decoding under ``make_plan(cfg,
    make_single_device_mesh(), "decode", global_batch=BATCH)`` on the NCCL
    world-size-1 group (``init_cuda_group``), so that every collective of
    the tensor-parallel step runs (over groups of one): a model without a
    plan prefills BATCH x (SHARD_CACHE - SHARD_STEPS) tokens, its cache is
    padded to SHARD_CACHE rows and cut by ``shard_cache``, and both models
    decode SHARD_STEPS steps, 4 adapters on the batch's rows, the planned
    one first (``decode_against_plan``).  Returns the numbers and the
    sharded path's launch counts."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_cuda_group, make_single_device_mesh
    from repro_torch.models.sharding import make_plan
    cfg = get_config("phi4-mini-3.8b")
    t0 = time.perf_counter()
    init_cuda_group()
    try:
        plan = make_plan(cfg, make_single_device_mesh(), "decode",
                         global_batch=BATCH)
        pair = planned_pair(cfg, plan)
        say(f"  plan {plan.mode}: batch over {plan.batch_axes}, width over "
            f"{plan.width_axis!r}, cache over {plan.cache_seq_axes}; built, "
            f"prefilled and cut in {time.perf_counter() - t0:.1f} s; {card}")
        stats, launches = decode_against_plan(ops, *pair, label=cfg.name)
        say_planned(cfg.name, stats, launches, card)
        del pair
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return stats, launches


def phase_planned_archs(ops, card):
    """Phase 10d: the MoE, SSM and hybrid architectures under the
    world-size-1 plan, as phase 10c decodes phi4-mini: each of
    ``PLANNED_ARCHS`` at its published widths (bf16, its depth cut to the
    layers given) decodes SHARD_STEPS steps under ``make_plan(cfg,
    make_single_device_mesh(), "decode", global_batch=BATCH)`` against the
    model without a plan (``decode_against_plan``): olmoe's experts
    through the expert-parallel ``apply_moe``, mamba2's and
    recurrentgemma's mixers width-tensor-parallel.  Returns {arch: the
    numbers} and {arch: the planned path's launch counts}."""
    import dataclasses as dc
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_cuda_group, make_single_device_mesh
    from repro_torch.models.sharding import make_plan
    t0 = time.perf_counter()
    stats, launches = {}, {}
    init_cuda_group()
    try:
        for arch, layers in PLANNED_ARCHS:
            t1 = time.perf_counter()
            published = get_config(arch)
            cfg = dc.replace(published, n_layers=layers or published.n_layers)
            plan = make_plan(cfg, make_single_device_mesh(), "decode",
                             global_batch=BATCH)
            pair = planned_pair(cfg, plan)
            label = f"{arch} ({cfg.n_layers} of {published.n_layers} layers)"
            stats[arch], launches[arch] = decode_against_plan(
                ops, *pair, label=label)
            stats[arch]["layers"] = cfg.n_layers
            stats[arch]["seconds"] = time.perf_counter() - t1
            say_planned(label, stats[arch], launches[arch], card)
            del pair
            gc.collect()
            torch.cuda.empty_cache()
            need = PLANNED_KERNELS[arch]
            require_launched(f"planned {arch}", launches[arch], need)
            extra = [k for k, n in launches[arch].items()
                     if n and k not in need]
            if extra:
                raise AssertionError(f"planned {arch} launched {extra}, "
                                     f"not only {need}")
    finally:
        dist.destroy_process_group()
    wall = time.perf_counter() - t0
    say(f"  phase 10d took {wall:.1f} s (budget {PLANNED_BUDGET_S} s); "
        f"{card}")
    return stats, launches


def phase_planned_prefill(ops, card):
    """Phase 10e: phi4-mini-3.8b at its published widths (32 layers, bf16,
    weights from seed 0) prefills BATCH x PREFILL_S tokens (4 adapters on
    the batch's rows) under ``make_plan(cfg, make_single_device_mesh(),
    "prefill", global_batch=BATCH)`` on the NCCL world-size-1 group: each
    weight gathered whole at its use, the ring and the last row over
    groups of one, SGMV with whole-prompt arrival ranks.  ``pad_cache``
    lays its cache out for the decode plan of the same mesh, from which a model under
    that plan decodes SHARD_STEPS steps (``decode_against_plan``).  Held
    against the model without a plan, bit for bit: the prefill's logits,
    the padded cache and every step.  The two prefills run twice each
    (planned first), the second walls printed; the launch counts and
    collectives are those of the first planned prefill.  Returns the
    numbers and the planned prefill's launch counts."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_cuda_group, make_single_device_mesh
    from repro_torch.models import Model
    from repro_torch.models.sharding import (COLLECTIVES, make_plan,
                                             reset_collectives)
    cfg = get_config("phi4-mini-3.8b")
    t0 = time.perf_counter()
    init_cuda_group()
    try:
        mesh = make_single_device_mesh()
        ref = Model(cfg, device="cuda", seed=0)
        pre = Model(cfg, device="cuda", seed=0, plan=make_plan(
            cfg, mesh, "prefill", global_batch=BATCH))
        dec = Model(cfg, device="cuda", seed=0, plan=make_plan(
            cfg, mesh, "decode", global_batch=BATCH))
        lora = ref.init_lora(SLOTS, RANK, seed=0)
        gen = torch.Generator(device="cuda").manual_seed(13)
        tokens = torch.randint(0, cfg.vocab_size,
                               (BATCH, PREFILL_S + SHARD_STEPS),
                               generator=gen, device="cuda")
        idx = (torch.arange(BATCH, device="cuda") % SLOTS).to(torch.int32)
        prompt = tokens[:, :PREFILL_S]
        walls = {"plan": [], "no_plan": []}
        for i in range(2):
            if i == 0:
                ops.reset_launches()
                reset_collectives()
            t1 = time.perf_counter()
            got, planned = pre.prefill(lora, prompt, idx)
            torch.cuda.synchronize()
            walls["plan"].append(time.perf_counter() - t1)
            if i == 0:
                launches = ops.launch_counts()
                collectives = dict(COLLECTIVES)
            t1 = time.perf_counter()
            want, cache = ref.prefill(lora, prompt, idx)
            torch.cuda.synchronize()
            walls["no_plan"].append(time.perf_counter() - t1)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("planned prefill: non-finite logits")
        logits_bitwise = torch.equal(got, want)
        planned = pre.pad_cache(planned, SHARD_STEPS)
        cache = ref.pad_cache(cache, SHARD_STEPS)
        cache_bitwise = all(torch.equal(a[n], b[n]) for a, b in zip(
            planned["layers"], cache["layers"]) for n in b)
        rel = ((got - want).abs().max() / want.abs().max()).item()
        say(f"  planned prefill of {BATCH}x{PREFILL_S} tokens: logits "
            f"bitwise {logits_bitwise} (max rel {rel:.3e}), padded cache "
            f"bitwise {cache_bitwise}; eager wall {walls['plan'][1] * 1e3:.1f}"
            f" ms under the plan, {walls['no_plan'][1] * 1e3:.1f} ms without "
            f"(second calls, host clock, synchronised; the first "
            f"{walls['plan'][0] * 1e3:.1f} and "
            f"{walls['no_plan'][0] * 1e3:.1f}); collectives {collectives}; "
            f"launches {launches}; {card}")
        stats, dec_launches = decode_against_plan(
            ops, ref, dec, lora, cache, planned, tokens, idx,
            label=f"{cfg.name} after the planned prefill", prompt=PREFILL_S)
        say_planned(f"{cfg.name} after the planned prefill", stats,
                    dec_launches, card)
        if not (logits_bitwise and cache_bitwise and stats["bitwise"]):
            raise AssertionError(
                f"planned prefill -> pad_cache -> decode at world size 1 is "
                f"not the path without a plan bit for bit: logits "
                f"{logits_bitwise}, cache {cache_bitwise}, decode "
                f"{stats['bitwise']}")
        require_launched("sharded decode after the planned prefill",
                         dec_launches, PATH_KERNELS["sharded_decode"])
        del ref, pre, dec, planned, cache
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    say(f"  phase 10e took {wall:.1f} s (budget {PREFILL_BUDGET_S} s); "
        f"{card}")
    stats.update({
        "prompt": [BATCH, PREFILL_S], "logits_bitwise": logits_bitwise,
        "cache_bitwise": cache_bitwise, "prefill_collectives": collectives,
        "plan_prefill_ms": walls["plan"][1] * 1e3,
        "no_plan_prefill_ms": walls["no_plan"][1] * 1e3,
        "plan_first_prefill_ms": walls["plan"][0] * 1e3,
        "no_plan_first_prefill_ms": walls["no_plan"][0] * 1e3,
        "seconds": wall})
    return stats, launches


def train_plan_run(cfg, plan, tcfg, pipe):
    """TRAIN_PLAN_STEPS steps of ``cfg`` (bf16, weights from seed 0) under
    ``plan`` (None: without one) on batches 0.. of ``pipe``: the losses,
    gradient norms and synchronised step walls, the collectives of each
    step's forward (``train_loss``) and of the rest of it (backward with
    its recompute, ``sync_grads`` and the norm), the peak memory, and the
    parameters after the steps on the host."""
    from repro_torch.models import Model
    from repro_torch.models.sharding import COLLECTIVES, reset_collectives
    from repro_torch.training import init_train_state, make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device="cuda", seed=0, plan=plan)
    opt = init_train_state(model, tcfg)
    step = make_train_step(model, tcfg)
    loss_of = model.train_loss
    forward = []

    def counted(batch):
        reset_collectives()
        loss = loss_of(batch)
        forward.append(dict(COLLECTIVES))
        reset_collectives()
        return loss
    model.train_loss = counted
    out = {"losses": [], "norms": [], "walls_ms": [], "forward": forward,
           "rest": []}
    for i in range(TRAIN_PLAN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, info = step(opt, pipe.batch_at(i))
        torch.cuda.synchronize()
        out["walls_ms"].append((time.perf_counter() - t0) * 1e3)
        out["rest"].append(dict(COLLECTIVES))
        out["losses"].append(info["loss"].item())
        out["norms"].append(info["grad_norm"].item())
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["params"] = {n: p.detach().to("cpu", copy=True)
                     for n, p in model.named_parameters()}
    del model, opt, step, info
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_plan(ops, card):
    """Phase 10f: sharded training at world size 1.  Each of
    ``TRAIN_PLAN_ARCHS`` at its published widths (bf16, weights from seed
    0, depth cut as given: phi4-mini whole, its weights FSDP-cut and
    gathered whole at their use, the sequence cut over ``model``; mamba2
    width-tensor-parallel with FSDP over ``data``) trains
    TRAIN_PLAN_STEPS steps of TRAIN_BATCH under ``make_plan(cfg,
    make_single_device_mesh(), "train", global_batch=rows)`` on the NCCL
    world-size-1 group, then the same steps without a plan from the same
    weights and batches (AdamW at lr TRAIN_LR, one warmup step).  Each
    step's loss and gradient norm must be within TRAIN_PLAN_TOL of the
    step without a plan (whether they are bitwise is printed), and the
    path must launch no kernel; prints the parameters' largest relative
    departure after the steps, both walls a step, the collectives a step
    by kind (forward; backward with its recompute, the gradients' sums
    and the norm) and both peaks.  Returns {arch: the numbers} and the
    launch counts."""
    import dataclasses as dc
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_cuda_group, make_single_device_mesh
    from repro_torch.models.sharding import make_plan
    from repro_torch.training import AdamWConfig, TrainConfig
    t0 = time.perf_counter()
    rows, tokens = TRAIN_BATCH
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR, warmup_steps=1))
    stats = {}
    ops.reset_launches()
    init_cuda_group()
    try:
        for arch, layers in TRAIN_PLAN_ARCHS:
            t1 = time.perf_counter()
            published = get_config(arch)
            cfg = dc.replace(published, n_layers=layers or published.n_layers)
            pipe = train_batches(cfg, rows, tokens)
            plan = make_plan(cfg, make_single_device_mesh(), "train",
                             global_batch=rows, remat=True)
            got = train_plan_run(cfg, plan, tcfg, pipe)
            want = train_plan_run(cfg, None, tcfg, pipe)
            rel = {k: max(abs(a - b) / abs(b) for a, b in
                          zip(got[k], want[k])) for k in ("losses", "norms")}
            worst, worst_name = -1.0, ""
            for name, p in want["params"].items():
                a = got["params"][name].cuda().float()
                b = p.cuda().float()
                r = ((a - b).norm() / b.norm().clamp(min=1e-30)).item()
                if r > worst:
                    worst, worst_name = r, name
            del a, b
            label = f"{arch} ({cfg.n_layers} of {published.n_layers} layers)"
            st = {"layers": cfg.n_layers, "batch": [rows, tokens],
                  "plan": {"batch": plan.batch_axes, "seq": plan.seq_axis,
                           "width": plan.width_axis, "fsdp": plan.fsdp_axes},
                  "losses": got["losses"], "no_plan_losses": want["losses"],
                  "grad_norms": got["norms"], "no_plan_grad_norms":
                  want["norms"], "loss_rel": rel["losses"],
                  "grad_norm_rel": rel["norms"],
                  "bitwise": got["losses"] == want["losses"]
                  and got["norms"] == want["norms"],
                  "param_rel_worst": worst, "param_rel_worst_leaf":
                  worst_name, "plan_step_ms": got["walls_ms"],
                  "no_plan_step_ms": want["walls_ms"],
                  "forward_collectives": got["forward"][-1],
                  "backward_collectives": got["rest"][-1],
                  "plan_peak_gb": got["peak_gb"],
                  "no_plan_peak_gb": want["peak_gb"], "card": card}
            del got, want
            gc.collect()
            st["seconds"] = time.perf_counter() - t1
            stats[arch] = st
            say(f"  10f {label}: losses {st['losses']} against "
                f"{st['no_plan_losses']}, grad norms {st['grad_norms']} "
                f"against {st['no_plan_grad_norms']}: max rel "
                f"{st['loss_rel']:.3e} and {st['grad_norm_rel']:.3e} (tol "
                f"{TRAIN_PLAN_TOL}), bitwise {st['bitwise']}; parameters "
                f"after {TRAIN_PLAN_STEPS} steps: largest relative departure"
                f" {worst:.3e} ({worst_name}); {card}")
            say(f"  10f {label}: step walls "
                f"{', '.join(f'{t:.1f}' for t in st['plan_step_ms'])} ms "
                f"under the plan, "
                f"{', '.join(f'{t:.1f}' for t in st['no_plan_step_ms'])} ms "
                f"without (synchronised, host clock); collectives a step: "
                f"forward {st['forward_collectives']}, backward with its "
                f"recompute, the gradients' sums and the norm "
                f"{st['backward_collectives']}; peak "
                f"{st['plan_peak_gb']:.1f} GB under the plan, "
                f"{st['no_plan_peak_gb']:.1f} GB without; {card}")
            if not all(math.isfinite(v) for v in st["losses"]
                       + st["grad_norms"]):
                raise AssertionError(f"10f {arch}: non-finite loss or norm")
            if max(rel.values()) > TRAIN_PLAN_TOL:
                raise AssertionError(f"10f {arch}: the planned steps depart "
                                     f"from the steps without a plan: {rel}")
    finally:
        dist.destroy_process_group()
    launches = ops.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"10f: the train steps launched {launches}")
    wall = time.perf_counter() - t0
    say(f"  phase 10f took {wall:.1f} s (budget {TRAIN_PLAN_BUDGET_S} s); "
        f"launches {launches}; {card}")
    stats["seconds"] = wall
    return stats, launches


def compression_bytes(grads, carried: bool) -> int:
    """The bytes one ``compressed_grad_sync`` of ``grads`` must move: each
    gradient (and, ``carried``, its f32 residual) read once, each synced
    gradient and f32 new residual written once."""
    return sum(g.numel() * (2 * g.element_size() + 4 + 4 * carried)
               for g in grads.values())


def phase_compression(ops, card):
    """Phase 11: phi4-mini-3.8b at its published widths (bf16, weights from
    seed 0) takes one step of TRAIN_BATCH as phase 8b trains it; its bf16
    gradients (``TrainStep.grads``) go through ``compressed_grad_sync``
    COMPRESS_CALLS times on the NCCL world-size-1 group, the residual
    carried, after the model and its AdamW state are freed.  Fails unless
    each call's synced gradients are ``(g.float() + r).to(dtype)`` bit
    for bit, every new residual is within s / 2 + 2**-15 s of 0 (s: its
    leaf's scale) and not all zero, the last call on the
    COMPRESS_CPU_LEAVES largest leaves equals the host run of the same
    function on the same inputs bit for bit (q and scale of
    ``_quantize``, the synced gradient and the residual), no collective
    was issued and no kernel launched.  Returns its numbers."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_cuda_group
    from repro_torch.models import Model
    from repro_torch.models.sharding import COLLECTIVES, reset_collectives
    from repro_torch.training import (AdamWConfig, TrainConfig, _quantize,
                                      compressed_grad_sync, init_train_state,
                                      make_train_step)
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    rows, tokens = TRAIN_BATCH
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR, warmup_steps=1))
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(cfg, device="cuda", seed=0)
    opt = init_train_state(model, tcfg)
    step = make_train_step(model, tcfg)
    opt, info = step(opt, train_batches(cfg, rows, tokens).batch_at(0))
    loss = info["loss"].item()
    grads = step.grads
    del model, opt, step, info
    gc.collect()
    torch.cuda.empty_cache()
    elements = sum(g.numel() for g in grads.values())
    dtypes = sorted({str(g.dtype) for g in grads.values()})
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    reset_collectives()
    init_cuda_group()
    walls, bounds, residual = [], [], None
    try:
        group = dist.group.WORLD
        n = dist.get_world_size(group)
        for c in range(COMPRESS_CALLS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            synced, new_residual = compressed_grad_sync(grads, group, n,
                                                        residual)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
            bounds.append(compression_bytes(grads, residual is not None)
                          / HBM_BYTES_PER_S * 1e3)
            worst = 0.0
            for k, g in grads.items():
                g32 = g.float() if residual is None else \
                    g.float() + residual[k]
                if not torch.equal(synced[k], g32.to(g.dtype)):
                    raise AssertionError(f"11: call {c + 1}: {k} synced is "
                                         f"not (g + r) in {g.dtype}")
                s = _quantize(g32)[1]
                r = new_residual[k].abs().amax()
                if not r > 0 or r > s * (0.5 + 2.0 ** -15):
                    raise AssertionError(f"11: call {c + 1}: {k}'s residual "
                                         f"{r.item():.3e} against its scale "
                                         f"{s.item():.3e}")
                worst = max(worst, (r / s).item())
            say(f"  11 call {c + 1}: {walls[-1]:.2f} ms for {len(grads)} "
                f"leaves ({elements / 1e9:.3f}B elements), byte bound "
                f"{bounds[-1]:.2f} ms; synced bit for bit g + r; largest "
                f"residual {worst:.6f} of its leaf's scale; {card}")
            if c < COMPRESS_CALLS - 1:
                residual = new_residual
            del synced
        collectives = dict(COLLECTIVES)
    finally:
        dist.destroy_process_group()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = ops.launch_counts()
    if any(collectives.values()) or any(launches.values()):
        raise AssertionError(f"11: collectives {collectives}, launches "
                             f"{launches} at world size 1")
    largest = sorted(grads, key=lambda k: grads[k].numel())
    host = []
    for k in largest[-COMPRESS_CPU_LEAVES:]:
        t1 = time.perf_counter()
        g32 = grads[k].float() + residual[k]
        q, s = _quantize(g32)
        cg, cr = grads[k].cpu(), residual[k].cpu()
        cq, cs = _quantize(cg.float() + cr)
        csynced, cres = compressed_grad_sync({k: cg}, None, 1, {k: cr})
        same = {"q": torch.equal(q.cpu(), cq),
                "scale": torch.equal(s.cpu().view(torch.int32),
                                     cs.view(torch.int32)),
                "synced": torch.equal(g32.to(grads[k].dtype).cpu(),
                                      csynced[k]),
                "residual": torch.equal(
                    new_residual[k].cpu().view(torch.int32),
                    cres[k].view(torch.int32))}
        host.append({"leaf": k, "elements": grads[k].numel(), **same,
                     "seconds": time.perf_counter() - t1})
        say(f"  11 host run of call {COMPRESS_CALLS}, {k} "
            f"({grads[k].numel() / 1e6:.1f}M elements): bit for bit "
            f"{same} ({host[-1]['seconds']:.1f} s)")
        if not all(same.values()):
            raise AssertionError(f"11: {k} on the card departs from the "
                                 f"host run: {same}")
        del g32, q, cg, cr, cq, csynced, cres
    ms = float(np.median(walls))
    bound_ms = float(np.median(bounds))
    del grads, residual, new_residual
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    stats = {"arch": TRAIN_ARCH, "batch": [rows, tokens], "loss": loss,
             "leaves": len(largest), "elements": elements, "dtypes": dtypes,
             "calls": COMPRESS_CALLS, "sync_ms": walls, "bound_ms": bounds,
             "sync_ms_median": ms, "bound_ms_median": bound_ms,
             "peak_gb": peak_gb, "host_checks": host, "seconds": wall,
             "budget_s": COMPRESS_BUDGET_S, "card": card}
    say(f"  11: {ms:.2f} ms a sync of the whole tree (median of "
        f"{COMPRESS_CALLS}, synchronised, host clock) against a byte bound "
        f"of {bound_ms:.2f} ms ({ms / bound_ms:.1f}x); peak "
        f"{peak_gb:.1f} GB; phase 11 took {wall:.1f} s (budget "
        f"{COMPRESS_BUDGET_S} s); {card}")
    return stats


def phase_checkpoint_plan(ops, card):
    """Phase 12: phase 9's loop under a train plan.  phi4-mini-3.8b at its
    published widths, ``TRAIN_CHECK_LAYERS`` layers, bf16, weights from
    seed 0, on ``TRAIN_BATCH`` batches (AdamW at lr ``TRAIN_LR``, one
    warmup step), under ``make_plan(cfg, make_single_device_mesh(),
    "train", global_batch=rows)`` on the NCCL world-size-1 group.  Run A:
    the planned ``FaultTolerantLoop`` (``specs`` from
    ``train_state_specs``) over ``CKPT_STEPS`` steps, a checkpoint every
    ``CKPT_EVERY`` (async, the last ``CKPT_KEEP`` kept; each leaf gathered
    whole over the group of one), a crash at step ``CKPT_FAIL``: one
    restart, resumed from step ``CKPT_EVERY``.  Run B: the same planned
    steps without a crash or a checkpoint; its parameters, m and v bit for
    bit run A's.  The newest checkpoint restored twice, into a fresh
    ``Model(cfg)`` without a plan and into a fresh planned one, and one
    more step from each bit for bit one more planned step of run A.  Each
    save issues one gather a cut leaf and grows the card's allocated
    memory by at most its largest leaf (``ALLOC_SLACK`` over).  Before any
    save the free space under ``CKPT_DIR`` must hold two checkpoints; the
    directory is removed at the end.  Prints the checkpoint's bytes, each
    save's snapshot (its gathers included) and write seconds, its gathers
    and memory growth, the resume's and both restores' seconds and the
    steps' walls, against ``CKPT_PLAN_BUDGET_S``.  Returns the numbers and
    run A's launch counts (none)."""
    import torch.distributed as dist
    from repro_torch.checkpoint import copy_into
    from repro_torch.checkpoint.manager import _flatten, _leaf_specs
    from repro_torch.configs import get_config
    from repro_torch.launch.fault_tolerance import FaultTolerantLoop, FTConfig
    from repro_torch.launch.mesh import (init_cuda_group,
                                         make_single_device_mesh)
    from repro_torch.models import Model
    from repro_torch.models.sharding import (COLLECTIVES, make_plan,
                                             reset_collectives)
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, make_train_step,
                                      train_lib, train_state_specs)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TRAIN_CHECK_LAYERS)
    rows, tokens = TRAIN_BATCH
    pipe = train_batches(cfg, rows, tokens)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR, warmup_steps=1))
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    init_cuda_group()
    try:
        plan = make_plan(cfg, make_single_device_mesh(), "train",
                         global_batch=rows, remat=True)

        def build(seed, plan):
            """(the model's train state, its specs, its step on a state)."""
            model = Model(cfg, device="cuda", seed=seed, plan=plan)
            state = {"params": train_lib.trainable(model),
                     "opt": init_train_state(model, tcfg)}
            step_fn = make_train_step(model, tcfg)

            def one(s, batch):
                return {"params": s["params"],
                        "opt": step_fn(s["opt"], batch)[0]}
            return state, train_state_specs(model, state), one

        state, specs, one = build(0, plan)
        leaves = _flatten(state)
        sizes = {k: t.numel() * t.element_size() for k, t in leaves.items()}
        ckpt_bytes, largest = sum(sizes.values()), max(sizes.values())
        cut = sum(any(e is not None for e in sp)
                  for sp in _leaf_specs(state, specs).values())
        free = shutil.disk_usage(CKPT_DIR).free
        say(f"  12: {cfg.n_layers} of {get_config(TRAIN_ARCH).n_layers} "
            f"layers at d={cfg.d_model}, {cfg.dtype}, under the train plan "
            f"(batch {plan.batch_axes}, sequence {plan.seq_axis!r}, FSDP "
            f"{plan.fsdp_axes}); a checkpoint {ckpt_bytes / 1e9:.2f} GB "
            f"({len(leaves)} leaves, {cut} cut, the largest "
            f"{largest / 1e9:.2f} GB); {free / 1e9:.1f} GB free under "
            f"{CKPT_DIR}")
        if free < 2 * ckpt_bytes:
            raise RuntimeError(f"12: {free / 1e9:.1f} GB free under "
                               f"{CKPT_DIR}, two checkpoints need "
                               f"{2 * ckpt_bytes / 1e9:.1f} GB")
        loop = FaultTolerantLoop(FTConfig(
            str(CKPT_DIR / "run_a"), checkpoint_every=CKPT_EVERY,
            keep=CKPT_KEEP), state, specs=specs, plan=plan)
        resume, save = loop.resume_or_init, loop.mgr.save
        resumes, gathers, growth = [], [], []

        def timed_resume(init_fn):
            t1 = time.perf_counter()
            out = resume(init_fn)
            torch.cuda.synchronize()
            resumes.append(time.perf_counter() - t1)
            return out

        def measured_save(*args, **kwargs):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_collectives()
            save(*args, **kwargs)
            growth.append(torch.cuda.max_memory_allocated() - base)
            gathers.append(COLLECTIVES["weight_gather"])
        loop.resume_or_init, loop.mgr.save = timed_resume, measured_save
        ops.reset_launches()
        out_a = loop.run_with_restarts(lambda: state, one, pipe.batch_at,
                                       CKPT_STEPS, failure_at=CKPT_FAIL)
        launches = ops.launch_counts()
        rep = loop.report
        step_a = int(out_a["opt"]["step"])
        say(f"  12 run A: restarts {rep.restarts}, resumed from "
            f"{rep.resumed_from}, {rep.steps_run} steps run, AdamW step "
            f"{step_a}; committed {loop.mgr.steps()}; step walls (ms) "
            + ", ".join(f"{t * 1e3:.1f}" for t in rep.step_times)
            + "; saves " + ", ".join(
                f"step {t['step']}: snapshot {t['snapshot_s']:.2f} s "
                f"({g} gathers, the card's memory +{b / 1e9:.2f} GB), write "
                f"{t['write_s']:.2f} s" for t, g, b in
                zip(loop.mgr.timings, gathers, growth))
            + f"; resume (rank 0's step, restore + copy onto the card) "
            f"{resumes[-1]:.2f} s; launches {launches}; {card}")
        if (rep.restarts, rep.resumed_from, step_a) != (1, CKPT_EVERY,
                                                        CKPT_STEPS):
            raise AssertionError(f"12 run A: restarts {rep.restarts}, "
                                 f"resumed from {rep.resumed_from}, step "
                                 f"{step_a}")
        if any(launches.values()):
            raise AssertionError(f"12: the train steps launched {launches}")
        if any(g != cut for g in gathers) or \
                max(growth) > largest + ALLOC_SLACK:
            raise AssertionError(f"12: saves gathered {gathers} (want {cut})"
                                 f" and grew the card's memory by {growth} "
                                 f"(at most {largest} + {ALLOC_SLACK})")

        state_b, _, one_b = build(0, plan)
        for i in range(CKPT_STEPS):
            state_b = one_b(state_b, pipe.batch_at(i))
        flat_a, flat_b = _flatten(out_a), _flatten(state_b)
        differ = [k for k, t in flat_a.items()
                  if not torch.equal(t, flat_b[k])]
        say(f"  12 run B (no crash, no checkpoint): "
            f"{len(flat_b) - len(differ)} of {len(flat_b)} leaves bit for "
            f"bit run A's")
        if differ:
            raise AssertionError(f"12: run A departs from run B: "
                                 f"{differ[:5]}")
        del state_b, one_b, flat_b
        gc.collect()
        torch.cuda.empty_cache()

        flat_a = _flatten(one(out_a, pipe.batch_at(CKPT_STEPS)))
        restores = {}
        for label, p in (("unplanned", None), ("planned", plan)):
            state_r, specs_r, one_r = build(1, p)
            t1 = time.perf_counter()
            copy_into(state_r, loop.mgr.restore(state_r, specs=specs_r,
                                                plan=p))
            torch.cuda.synchronize()
            restores[label] = time.perf_counter() - t1
            flat_r = _flatten(one_r(state_r, pipe.batch_at(CKPT_STEPS)))
            differ = [k for k, t in flat_a.items()
                      if not torch.equal(t, flat_r[k])]
            same = len(flat_r) - len(differ)
            say(f"  12: step {CKPT_STEPS} restored {label} in "
                f"{restores[label]:.2f} s (restore + copy onto the card), "
                f"then step {CKPT_STEPS + 1}: {same} of {len(flat_r)} leaves"
                f" bit for bit run A's step {CKPT_STEPS + 1}; {card}")
            if differ:
                raise AssertionError(f"12: the {label} restore's step "
                                     f"departs: {differ[:5]}")
            del state_r, one_r, flat_r
            gc.collect()
            torch.cuda.empty_cache()
        stats = {"arch": TRAIN_ARCH, "layers": cfg.n_layers,
                 "dtype": cfg.dtype, "batch": [rows, tokens],
                 "checkpoint_bytes": ckpt_bytes, "largest_leaf_bytes": largest,
                 "leaves": len(leaves), "cut_leaves": cut,
                 "saves": loop.mgr.timings, "save_gathers": gathers,
                 "save_memory_growth_bytes": growth,
                 "resume_s": resumes[-1], "restore_s": restores,
                 "step_walls_ms": [t * 1e3 for t in rep.step_times],
                 "restarts": rep.restarts, "resumed_from": rep.resumed_from,
                 "card": card}
        del state, out_a, flat_a, loop
    finally:
        dist.destroy_process_group()
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    stats["seconds"] = time.perf_counter() - t0
    say(f"  phase 12 took {stats['seconds']:.1f} s (budget "
        f"{CKPT_PLAN_BUDGET_S} s); {card}")
    return stats, launches


# --------------------------------------------------------------------------- #
# phase 13: the dry-run's cells
# --------------------------------------------------------------------------- #

def _gb(nbytes) -> str:
    return f"{nbytes / 1e9:.3f} GB"


def _by_group(counts) -> str:
    """``cell_bytes``' counts, in GB, group by group."""
    return ", ".join(f"{k} {_gb(v)}" for k, v in counts.items())


def phase_cells_meta(card):
    """13a: every cell of the ten architectures on meta: ``build_step``
    on each production mesh (``MeshShape``), one line a cell with its id,
    its plan's axes, ``cell_bytes`` a device by group, ``model_flops_for``
    and whether the arguments fit one device; then each (architecture,
    shape) whole (no mesh), and whether 13b takes it.  Fails if a byte was
    allocated on the card.  Returns (the cells 13b takes, their whole
    counts)."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.roofline import model_flops_for
    from repro_torch.launch.steps import build_step, cell_bytes, cell_id
    from repro_torch.models import applicable_shapes
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    n, take, whole = 0, [], {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            flops = model_flops_for(cfg, shape)
            for pod, (dims, names) in CELL_MESHES.items():
                b = build_step(cfg, shape, MeshShape(dims, names))
                got, plan = cell_bytes(b), b.plan
                axes = {"batch": plan.batch_axes, "seq": plan.seq_axis,
                        "width": plan.width_axis, "fsdp": plan.fsdp_axes,
                        "cache_seq": plan.cache_seq_axes}
                say(f"  {cell_id(arch, shape.name, pod == 'pod2')}: plan "
                    f"{axes}; a device {_by_group(got)}; "
                    f"model {flops:.6e} FLOP; fits one device "
                    f"{got['total'] <= total}")
                n += 1
                del b
            w = cell_bytes(build_step(cfg, shape, None))
            fits = shape.kind == "decode" and w["total"] <= CELL_ROOM * total
            whole[arch, shape.name] = w
            if fits:
                take.append((arch, shape.name))
            say(f"  {arch}:{shape.name} whole: {_gb(w['total'])} "
                f"({_by_group(w)}); "
                f"{'taken by 13b' if fits else 'not taken'}")
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    say(f"  {n} cells on meta; the card's allocated bytes {before} before, "
        f"{after} after; {total / 1e9:.2f} GB on the card, 13b takes decode"
        f" cells within {CELL_ROOM:.0%} of it: {take}; {card}")
    if n != CELL_COUNT:
        raise AssertionError(f"13a built {n} cells, not {CELL_COUNT}")
    if after != before:
        raise AssertionError(f"13a allocated {after - before} bytes on the "
                             "card")
    return take, whole


def _arg_bytes(bundle):
    """The bytes of the bundle's real arguments by group, counted from the
    tensors themselves (not through ``cell_bytes``)."""
    from repro_torch.launch.steps import ARG_GROUPS

    def leaves(tree):
        if isinstance(tree, dict):
            return [t for v in tree.values() for t in leaves(v)]
        if isinstance(tree, (list, tuple)):
            return [t for v in tree for t in leaves(v)]
        return [tree]
    out = dict.fromkeys(ARG_GROUPS, 0)
    for group, arg in zip(bundle.meta["args"], bundle.args):
        for t in leaves(arg):
            if t.device.type != "cuda":
                raise AssertionError(f"an argument on {t.device}")
            out[group] += t.numel() * t.element_size()
    out["total"] = sum(out[g] for g in ARG_GROUPS)
    return out


def phase_cells_run(ops, card, take, whole):
    """13b: each cell 13a takes, built whole on the card (weights, LoRA
    banks and inputs from seed 0), its cache filled by ``fill_cache``
    (every leaf kind), ``pos`` CELL_TAIL short of the end, then
    CELL_STEPS eager steps of ``bundle.fn``: the real arguments' bytes
    equal to 13a's meta count to the byte, the peak memory beside it, each
    step's wall (CUDA events) beside ``decode_bound``, every logit finite,
    and exactly 2 BGMV and 1 flash-decode launches an attention layer a
    step (none on an attention-free architecture).  One cell is freed
    before the next is built.  Returns the stats, the launches summed
    over the cells, and flash-decode's shapes {(B, S, H, KV, D): the
    cells}."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_step
    from repro_torch.models import SHAPES
    stats, total, fd_shapes = {}, dict.fromkeys(ops.KERNELS, 0), {}
    for arch, name in take:
        cfg, shape = get_config(arch), SHAPES[name]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        b = build_step(cfg, shape, None, device="cuda", seed=0)
        real, want = _arg_bytes(b), whole[arch, name]
        if real != want:
            raise AssertionError(f"{arch}:{name}: real arguments {real} "
                                 f"against the meta count {want}")
        cache = b.args[2]
        fill_cache(cache, seed=11, pos=shape.seq_len - CELL_TAIL)
        built = time.perf_counter() - t0
        for fd in {(*c[k].shape[:2], cfg.n_heads, *c[k].shape[2:])
                   for c in cache["layers"] for k in ("k", "k_loc")
                   if k in c}:
            fd_shapes.setdefault(fd, set()).add(f"{arch}:{name}")
        bnd = decode_bound(b.model, cache)
        start = [torch.cuda.Event(enable_timing=True)
                 for _ in range(CELL_STEPS + 1)]
        finite = []
        ops.reset_launches()
        start[0].record()
        for i in range(CELL_STEPS):
            logits, stepped = b.fn(*b.args)
            start[i + 1].record()
            finite.append(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        finite = all(bool(f) for f in finite)
        walls = [start[i].elapsed_time(start[i + 1])
                 for i in range(CELL_STEPS)]
        attn = attention_layers(cfg)
        want_l = {k: 0 for k in launches}
        if attn:
            want_l.update(bgmv=2 * attn * CELL_STEPS,
                          flash_decode=attn * CELL_STEPS)
        for k, v in launches.items():
            total[k] += v
        peak = torch.cuda.max_memory_allocated() - base
        st = {"arg_bytes": real, "peak_bytes": peak, "step_ms": walls,
              "bound_ms": bnd["bound_ms"], "built_s": built,
              "launches": launches, "finite": finite,
              "logits_shape": list(logits.shape), "pos": int(cache["pos"])}
        stats[f"{arch}:{name}"] = st
        say(f"  {arch}:{name}: arguments {real['total']} B, equal to the "
            f"meta count by group; peak {_gb(peak)} above the "
            f"{_gb(base)} allocated before; built and filled in {built:.1f} s; steps "
            f"{', '.join(f'{w:.2f}' for w in walls)} ms against a bound of "
            f"{bnd['bound_ms']:.3f} ms ({bnd['weight_gb']:.2f} GB weights, "
            f"{bnd['kv_gb']:.2f} GB cache); logits {tuple(logits.shape)} "
            f"finite {finite}; launches {launches}; {card}")
        if not finite:
            raise AssertionError(f"{arch}:{name}: non-finite logits")
        if launches != want_l:
            raise AssertionError(f"{arch}:{name}: launches {launches}, "
                                 f"want {want_l}")
        del b, cache, logits, stepped
    gc.collect()
    torch.cuda.empty_cache()
    return stats, total, fd_shapes


def _fd_rows(bsz, s, h, kv, d):
    """How many of a (B, S, KV, D) cache's rows ``flash_decode_plain``
    takes at once in half the card's free memory: a row's f32 K and V,
    and three f32 score arrays of its H heads."""
    free, _ = torch.cuda.mem_get_info()
    per_row = 4 * s * (2 * kv * d + 3 * h)
    return max(1, min(bsz, int(free / 2 // per_row)))


def phase_cells_kernels(card, errs, fd_shapes):
    """13c: BGMV (CELL_TOKENS tokens, DRYRUN_ADAPTER_SLOTS adapters of
    rank DRYRUN_LORA_RANK, at gemma3-1b's and recurrentgemma-9b's q and v
    widths, ids over [-1, N)) and flash-decode at 13b's shapes (ragged
    lengths, the first row full) against their plain versions under phase
    3's tolerances (bf16 3e-2, and 1e-2 of each row's largest value);
    where the plain version of a whole cache does not fit, on the rows
    that do, the count printed.  Then each timed (CUDA graph replay,
    ``graph_ms``), beside its bound and, for flash-decode, SDPA on
    head-major copies.  Returns the rows' keys for the kernel table."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import (DRYRUN_ADAPTER_SLOTS,
                                            DRYRUN_LORA_RANK)
    from repro_torch.kernels import bgmv, flash_decode
    import torch.nn.functional as F
    dt, es = torch.bfloat16, 2
    inp = Inputs(seed=13)
    n, r = DRYRUN_ADAPTER_SLOTS, DRYRUN_LORA_RANK
    out = {"bgmv": {}, "flash_decode": {}}
    for arch in ("gemma3-1b", "recurrentgemma-9b"):
        cfg = get_config(arch)
        hd, d = cfg.resolved_head_dim, cfg.d_model
        for o in (cfg.n_heads * hd, cfg.n_kv_heads * hd):
            for t in CELL_TOKENS:
                ids = torch.randint(-1, n, (t,), generator=inp.gen,
                                    device="cuda", dtype=torch.int32)
                ids[0] = 0

                def make():
                    x = inp.normal(t, d, dtype=dt)
                    a, bb = inp.lora_bank(n, d, r, o, dt)
                    return x, a, bb, ids
                sets = copies(make, (t * d + n * r * (d + o)) * es)
                label = f"cells_{cfg.name}_t{t}_o{o}"
                x, a, bb, _ = sets[0]
                check(f"bgmv {label}", bgmv.bgmv(x, a, bb, ids),
                      bgmv.bgmv_plain(x, a, bb, ids), "bfloat16", errs,
                      per_row=True)
                used = int(torch.unique(ids[ids >= 0]).numel())
                rows = int((ids >= 0).sum())
                flops, nbytes = kernel_cost.lora_cost(t, d, r, o, used,
                                                      rows=rows)
                b_ms, b_by = bound(nbytes, flops, "bfloat16")
                row = {"ms": graph_ms(bgmv.bgmv, sets),
                       "plain_ms": graph_ms(bgmv.bgmv_plain, sets),
                       "bound_ms": b_ms}
                out["bgmv"].update({f"{label}_{k}": v
                                    for k, v in row.items()})
                say(f"  bgmv {label}: {row['ms'] * 1e3:.2f} us (plain "
                    f"{row['plain_ms'] * 1e3:.2f}, bound {b_ms * 1e3:.3f} "
                    f"us by {b_by}); {card}")
                del sets, x, a, bb
    for (bsz, s, h, kv, d), cells in sorted(fd_shapes.items()):
        label = f"cells_b{bsz}_s{s}_h{h}_kv{kv}_d{d}"
        q = inp.normal(bsz, h, d, dtype=dt)
        k = inp.normal(bsz, s, kv, d, dtype=dt)
        v = inp.normal(bsz, s, kv, d, dtype=dt)
        lengths = torch.randint(1, s + 1, (bsz,), generator=inp.gen,
                                device="cuda", dtype=torch.int32)
        lengths[0] = s
        rows = _fd_rows(bsz, s, h, kv, d)
        got = flash_decode.flash_decode(q, k, v, lengths)[:rows]
        want = flash_decode.flash_decode_plain(q[:rows], k[:rows], v[:rows],
                                               lengths[:rows])
        check(f"flash_decode {label} ({rows} of {bsz} rows against the "
              "plain version)", got, want, "bfloat16", errs, per_row=True)
        del got, want
        torch.cuda.empty_cache()
        sets = [(q, k, v, s)]
        if d == 256:
            require_d256_pass(f"flash_decode {label}",
                              flash_decode.flash_decode, sets[0])
        flops, nbytes = kernel_cost.flash_decode_cost(bsz, s, h, kv, d)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        big = nbytes > 2e8          # fewer calls a graph for large caches
        row = {"ms": graph_ms(flash_decode.flash_decode, sets),
               "plain_ms": graph_ms(flash_decode.flash_decode_plain, sets,
                                    calls=2 if big else 32),
               "bound_ms": b_ms}
        torch.cuda.empty_cache()
        lib = [(q[:, :, None], k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous())]
        del k, v, sets
        row["library_ms"] = graph_ms(
            lambda qq, kk, vv: F.scaled_dot_product_attention(
                qq, kk, vv, enable_gqa=True), lib, calls=4 if big else 32)
        backend, _ = sdpa_backend(
            lambda qq, kk, vv: F.scaled_dot_product_attention(
                qq, kk, vv, enable_gqa=True), lib[0])
        del lib, q
        torch.cuda.empty_cache()
        out["flash_decode"].update({f"{label}_{k_}": v_
                                    for k_, v_ in row.items()})
        say(f"  flash_decode {label} (the cells {sorted(cells)}): "
            f"{row['ms'] * 1e3:.2f} us (plain {row['plain_ms'] * 1e3:.2f}, "
            f"bound {b_ms * 1e3:.3f} us by {b_by}, SDPA "
            f"{row['library_ms'] * 1e3:.2f} us, {backend}); {card}")
    return out


def phase_cells(ops, card, errs):
    """Phase 13: 13a, 13b and 13c, the phase's seconds against
    CELLS_BUDGET_S.  Returns the stats, 13b's launches and 13c's rows."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    say("phase 13a: every dry-run cell on meta (build_step, cell_bytes, "
        "model_flops_for)")
    take, whole = phase_cells_meta(card)
    t_meta = time.perf_counter() - t0
    say("phase 13b: the cells one card holds whole, 3 eager decode steps "
        "each")
    stats, launches, fd_shapes = phase_cells_run(ops, card, take, whole)
    say(f"  launches over 13b's cells: {launches}")
    say("phase 13c: BGMV and flash-decode at the cells' shapes against "
        "their plain versions, timed")
    rows = phase_cells_kernels(card, errs, fd_shapes)
    wall = time.perf_counter() - t0
    say(f"  phase 13 took {wall:.1f} s (13a {t_meta:.1f} s; budget "
        f"{CELLS_BUDGET_S} s); {card}")
    return {"cells": stats, "seconds": wall, "meta_seconds": t_meta,
            "budget_s": CELLS_BUDGET_S, "card": card}, launches, rows


def _terms_ms(r) -> str:
    """A record's roofline terms, in ms."""
    return (f"compute {r['compute_s'] * 1e3:.4f}, memory "
            f"{r['memory_s'] * 1e3:.4f}, collective "
            f"{r['collective_s'] * 1e3:.4f} ms: step "
            f"{r['step_time_s'] * 1e3:.4f} ms, {r['bottleneck']}")


def _count_cell(arch, name, multi_pod=False, **kw):
    """``run_cell`` of one cell, raising where it failed."""
    from repro_torch.launch.dryrun import run_cell
    rec = run_cell(arch, name, multi_pod, **kw)
    if not rec["ok"]:
        raise AssertionError(f"{rec['cell']}: {rec['error']}\n"
                             f"{rec['traceback']}")
    return rec


def phase_dryrun_whole(card, cells):
    """14a: each cell 13b ran (``cells``, its stats by ``arch:shape``)
    counted whole on meta: its roofline terms beside 13b's eager walls,
    its ``total_bytes_per_device`` beside 13b's peak; fails where the
    predicted argument bytes differ from 13b's real ones.  Returns the
    records' numbers by cell."""
    from repro_torch.launch.dryrun import NO_MESH
    out = {}
    for key, st in cells.items():
        arch, name = key.split(":")
        rec = _count_cell(arch, name, mesh=NO_MESH, probes=False)
        mem, r = rec["memory"], rec["roofline"]
        real = st["arg_bytes"]["total"]
        if mem["argument_size_in_bytes"] != real:
            raise AssertionError(f"{key}: predicted argument bytes "
                                 f"{mem['argument_size_in_bytes']:.0f}, "
                                 f"13b's real ones {real}")
        wall = float(np.median(st["step_ms"][1:]))   # the warm steps
        out[key] = {"roofline": r, "memory": mem, "cost": rec["cost"],
                    "measured_step_ms": st["step_ms"],
                    "measured_peak_bytes": st["peak_bytes"],
                    "count_s": rec["elapsed_s"]}
        say(f"  {key} whole: predicted {_terms_ms(r)}; measured warm eager "
            f"median {wall:.3f} ms ({wall / (r['step_time_s'] * 1e3):.1f}x"
            f" the predicted step); predicted {_gb(mem['total_bytes_per_device'])}"
            f" a device (arguments {_gb(mem['argument_size_in_bytes'])}, "
            f"equal to 13b's real ones; temporaries "
            f"{_gb(mem['temp_size_in_bytes'])}) against 13b's measured "
            f"peak {_gb(st['peak_bytes'])}; counted in "
            f"{rec['elapsed_s']:.1f} s; {card}")
    return out


def phase_dryrun_variant(ops, card):
    """14b: the hill-climb's DRYRUN_VARIANT of DRYRUN_VARIANT_CELL, its
    dry-run record (whole, on meta), then the cell built whole on the card
    under the variant (seed 0), its cache filled, CELL_STEPS eager steps
    from ``pos`` CELL_TAIL short of the end: the real arguments' bytes
    equal to the record's, an int8 global cache, every logit finite and
    the launches exact (2 BGMV and 1 flash-decode an attention layer a
    step).  Returns its stats and launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import NO_MESH
    from repro_torch.launch.hillclimb import VARIANTS
    from repro_torch.launch.steps import build_step
    from repro_torch.models import SHAPES
    arch, name = DRYRUN_VARIANT_CELL
    over = VARIANTS[DRYRUN_VARIANT]
    rec = _count_cell(arch, name, mesh=NO_MESH, probes=False,
                      plan_overrides=over)
    cfg, shape = get_config(arch), SHAPES[name]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    b = build_step(cfg, shape, None, plan_overrides=over, device="cuda",
                   seed=0)
    real = _arg_bytes(b)
    if real["total"] != rec["memory"]["argument_size_in_bytes"]:
        raise AssertionError(f"{arch}:{name} [{DRYRUN_VARIANT}]: real "
                             f"arguments {real}, the record's "
                             f"{rec['memory']['argument_size_in_bytes']}")
    cache = b.args[2]
    if not any(c["k"].dtype == torch.int8 for c in cache["layers"]
               if "k" in c):
        raise AssertionError(f"{DRYRUN_VARIANT}: no int8 global cache")
    fill_cache(cache, seed=11, pos=shape.seq_len - CELL_TAIL)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(CELL_STEPS + 1)]
    finite = []
    ops.reset_launches()
    events[0].record()
    for i in range(CELL_STEPS):
        logits, _ = b.fn(*b.args)
        events[i + 1].record()
        finite.append(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    walls = [events[i].elapsed_time(events[i + 1])
             for i in range(CELL_STEPS)]
    peak = torch.cuda.max_memory_allocated() - base
    attn = attention_layers(cfg)
    want = dict.fromkeys(launches, 0)
    want.update(bgmv=2 * attn * CELL_STEPS, flash_decode=attn * CELL_STEPS)
    finite = all(bool(f) for f in finite)
    r, mem = rec["roofline"], rec["memory"]
    say(f"  {arch}:{name} [{DRYRUN_VARIANT}]: predicted {_terms_ms(r)}; "
        f"measured eager steps {', '.join(f'{w:.2f}' for w in walls)} ms; "
        f"predicted {_gb(mem['total_bytes_per_device'])} a device "
        f"(arguments {_gb(mem['argument_size_in_bytes'])}, equal to the "
        f"real ones) against a measured peak of {_gb(peak)}; logits "
        f"{tuple(logits.shape)} finite {finite}; launches {launches}; "
        f"{card}")
    if not finite:
        raise AssertionError(f"{DRYRUN_VARIANT}: non-finite logits")
    if launches != want:
        raise AssertionError(f"{DRYRUN_VARIANT}: launches {launches}, want "
                             f"{want}")
    del b, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"cell": rec["cell"], "variant": DRYRUN_VARIANT,
            "roofline": r, "memory": mem, "cost": rec["cost"],
            "step_ms": walls, "peak_bytes": peak, "arg_bytes": real,
            "launches": launches}, launches


def phase_dryrun_meta(card):
    """14c: DRYRUN_META_CELLS on each production mesh, counted as rank 0
    of it on meta by the probes (``run_cell(full=False)``): each record's
    line; fails if a cell
    fails or the card's allocated bytes moved.  Returns the records'
    numbers by cell."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = {}
    for arch, name in DRYRUN_META_CELLS:
        for multi_pod in (False, True):
            rec = _count_cell(arch, name, multi_pod=multi_pod, full=False)
            r = rec["roofline"]
            out[rec["cell"]] = {"roofline": r, "cost": rec["cost"],
                                "count_s": rec["elapsed_s"]}
            say(f"  OK {rec['cell']} mesh {rec['mesh']}: "
                f"{_terms_ms(r)}; collectives "
                f"{rec['cost']['collectives']}; counted in "
                f"{rec['elapsed_s']:.1f} s")
    torch.cuda.synchronize()
    if torch.cuda.memory_allocated() != before:
        raise AssertionError("14c allocated on the card")
    return out


def phase_dryrun(ops, card, cells):
    """Phase 14: 14a, 14b and 14c, the phase's seconds against
    DRYRUN_BUDGET_S.  Returns the stats and 14b's launches."""
    t0 = time.perf_counter()
    say("phase 14a: 13b's cells counted whole on meta (run_cell) against "
        "13b's measurements")
    whole = phase_dryrun_whole(card, cells)
    say(f"phase 14b: the hill-climb's {DRYRUN_VARIANT} variant of "
        f"{':'.join(DRYRUN_VARIANT_CELL)} whole on the card")
    variant, launches = phase_dryrun_variant(ops, card)
    say("phase 14c: a cell of each step kind on each production mesh, as "
        "rank 0 on meta")
    meta = phase_dryrun_meta(card)
    wall = time.perf_counter() - t0
    say(f"  phase 14 took {wall:.1f} s (budget {DRYRUN_BUDGET_S} s); "
        f"{card}")
    if wall > DRYRUN_BUDGET_S:
        raise AssertionError(f"phase 14 took {wall:.1f} s, over its "
                             f"{DRYRUN_BUDGET_S} s budget")
    return {"whole": whole, "variant": variant, "meta": meta,
            "seconds": wall, "budget_s": DRYRUN_BUDGET_S,
            "card": card}, launches


@contextlib.contextmanager
def host_spans():
    """The host seconds spent, while open, in the plan's collectives
    (``sharding.all_reduce``/``all_gather``/``reduce_scatter`` as the
    model, the experts and the mixers call them) and in
    ``attention.combine_shards``: a dict of ``collectives`` (outside the
    combine), ``combine`` (the whole call) and ``combine_collectives``
    (its all-reduces), filled as the calls return."""
    from unittest import mock
    from repro_torch.models import attention, sharding, transformer
    span = {"collectives": 0.0, "combine": 0.0, "combine_collectives": 0.0}
    inside = []

    def timed(fn, key):
        def call(*args, **kwargs):
            name = "combine_" + key if inside and key == "collectives" \
                else key
            if key == "combine":
                inside.append(1)
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                span[name] += time.perf_counter() - t
                if key == "combine":
                    inside.pop()
        return call
    with contextlib.ExitStack() as stack:
        for module, name, key in (
                (transformer, "all_reduce", "collectives"),
                (transformer, "all_gather", "collectives"),
                (sharding, "all_reduce", "collectives"),
                (sharding, "all_gather", "collectives"),
                (sharding, "reduce_scatter", "collectives"),
                (attention, "combine_shards", "combine")):
            stack.enter_context(mock.patch.object(
                module, name, timed(getattr(module, name), key)))
        yield span


def attention_layers(cfg) -> int:
    """The layers with attention, a KV cache and LoRA (global, local)."""
    from repro_torch.models.transformer import ATTENTION_KINDS
    return sum(k in ATTENTION_KINDS for k in cfg.layer_kinds)


def require_launched(path, counts, names) -> None:
    missing = [k for k in names if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: "
                             f"{missing}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build, ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    say("phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    say("phase 2: kernel build")
    t0 = time.perf_counter()
    build.kernels()
    say(f"  built {', '.join(KERNEL_ROWS)} into {build.BUILD_DIR} in "
        f"{time.perf_counter() - t0:.1f} s")

    say("phase 3: kernels against their plain versions")
    errs = phase_kernels()
    say(f"  the int8 mode with q in f32: largest departure from its plain "
        f"version with exact q.k {errs['f32q_int8']:.3e} (tol 2e-5); from "
        f"the einsum-order one {errs['f32q_int8_vs_f32_dot']:.3e}, each "
        f"value within its rounding flips")

    say("phase 4: teacher forcing at full width")
    ops.reset_launches()
    phase_parity()
    tf_launches = ops.launch_counts()
    say(f"  launches on the teacher-forcing path: {tf_launches}")
    require_launched("teacher forcing", tf_launches,
                     PATH_KERNELS["teacher_forcing"])
    torch.cuda.empty_cache()
    tfv_launches = phase_parity_variants(ops)
    say(f"  launches on the {len(VARIANTS)} teacher-forcing paths: "
        f"{tfv_launches}")
    tfm_launches = phase_parity_moe(ops)
    say(f"  launches on the MoE teacher-forcing paths: {tfm_launches}")
    tfs_launches = phase_parity_ssd(ops)
    tf8_launches = phase_parity_int8(ops)

    say("phase 5: serving phi4-mini-3.8b (published widths, bf16)")
    executor, serve_launches = phase_serve("phi4-mini-3.8b", ops)

    say("phase 6: timing at the main path's shapes (bf16)")
    per_step, step_stats = phase_step(executor, ops)
    say("  step " + json.dumps(step_stats))
    del executor
    torch.cuda.empty_cache()

    executor, variant_launches, variant_stats = serve_variant(
        SERVED_VARIANT, "b", ops)
    say(f"  step {SERVED_VARIANT} " + json.dumps(variant_stats))
    del executor
    torch.cuda.empty_cache()

    executor, moe_launches, moe_stats = serve_variant(MOE_ARCH, "c", ops)
    moe_stats.update(step_split(executor, "moe"))
    moe_stats.update(step_bound=step_bound(executor.model, executor.cache))
    say(f"  step {MOE_ARCH} " + json.dumps(moe_stats))
    del executor
    torch.cuda.empty_cache()

    executor, int8_launches, int8_stats = serve_variant(
        "phi4-mini-3.8b", "d", ops, kv_quant=True)
    say("  step phi4-mini-3.8b int8 KV cache " + json.dumps(int8_stats))
    del executor
    torch.cuda.empty_cache()
    say(f"phase 6d: phi4-mini-3.8b's replayed step over {LONG_S} positions,"
        " bf16 against int8 KV cache")
    long_stats, long_launches = phase_long_step(ops)
    say("  step 32k " + json.dumps(long_stats))

    executor, hybrid_launches, hybrid_stats = serve_variant(HYBRID_ARCH, "e",
                                                            ops)
    hybrid_stats.update(step_split(executor, "rglru"))
    hybrid_stats.update(step_bound=step_bound(executor.model,
                                              executor.cache))
    say(f"  step {HYBRID_ARCH} " + json.dumps(hybrid_stats))
    del executor
    torch.cuda.empty_cache()

    executor, ssm_launches, ssm_stats = serve_variant(SSM_ARCH, "f", ops)
    ssm_stats.update(step_split(executor, "ssd"))
    ssm_stats.update(step_bound=step_bound(executor.model, executor.cache))
    bnd = ssm_stats["step_bound"]["bound_ms"]
    say(f"  {SSM_ARCH} replayed step: wall {ssm_stats['replay_ms']:.2f} ms, "
        f"span {ssm_stats['replay_span_ms']:.2f}, busy "
        f"{ssm_stats['replay_busy_ms']:.2f}; bound {bnd:.2f} ms (weights and "
        f"states), busy {ssm_stats['replay_busy_ms'] / bnd:.2f}x it")
    say(f"  step {SSM_ARCH} " + json.dumps(ssm_stats))
    del executor
    torch.cuda.empty_cache()
    rows = phase_timing()
    for name, r in rows.items():
        extra = {k: v for k, v in r.items() if k not in
                 ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
                 and not isinstance(v, str)}
        steps = long_launches if name in KERNEL_WRAPPER else per_step
        say(f"  {name}: {r['ms'] * 1e3:.2f} us (plain {r['plain_ms'] * 1e3:.2f}"
            f" us, bound {r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}, "
            f"library {r['library_ms']}), "
            f"{steps[KERNEL_WRAPPER.get(name, name)]} per decode step"
            + "".join(f", {k} {v * 1e3:.2f} us" for k, v in extra.items()))
    torch.cuda.empty_cache()

    say("phase 7: measurement path (kernel launches -> MeasuredStepTimes ->"
        " Digital Twin -> (N*, G*))")
    measure_launches, est, mst, placements = phase_measure(ops)
    require_launched("measurement", measure_launches,
                     PATH_KERNELS["measurement"])
    say("phase 7b: the placement-model creation phase (twin sweeps over a "
        "scenario grid -> labelled dataset -> forest -> recommend)")
    phase_pipeline(est, mst, placements)

    say("phase 8: training phi4-mini-3.8b (train_loss -> autograd -> AdamW)")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    say(f"  {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated after "
        f"the serving phases")
    check_launches = phase_train_check(ops)
    train_stats, train_launches = phase_train(ops, card)
    say("  train " + json.dumps(train_stats))

    say("phase 9: the loop around the training step (checkpoints, the "
        "fault-tolerant loop, the train launcher)")
    ckpt_stats, ckpt_launches = phase_checkpoint(ops, card)
    say("  checkpoint " + json.dumps(ckpt_stats))

    say("phase 10: the sharded decode (flash-decode's log-sum-exp, "
        f"{SHARD_SLICES} emulated sequence slices, the world-size-1 plan)")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    check_lse_mode(errs)
    rows["flash_decode_lse"] = lse_row(card)
    slice_stats = phase_shard_slices(errs, card)
    shard_stats, shard_launches = phase_sharded_step(ops, card)
    require_launched("sharded decode", shard_launches,
                     PATH_KERNELS["sharded_decode"])
    rows["flash_decode_lse"]["slices"] = slice_stats
    say("  sharded " + json.dumps({**shard_stats, "slices": slice_stats}))
    say("phase 10d: the MoE, SSM and hybrid architectures under the "
        "world-size-1 plan")
    planned_stats, planned_launches = phase_planned_archs(ops, card)
    say("  planned " + json.dumps(planned_stats))
    say("phase 10e: the sharded prefill (phi4-mini-3.8b under the "
        "world-size-1 prefill plan -> pad_cache -> the decode plan)")
    prefill_stats, prefill_launches = phase_planned_prefill(ops, card)
    require_launched("sharded prefill", prefill_launches,
                     PATH_KERNELS["sharded_prefill"])
    say("  prefill " + json.dumps(prefill_stats))
    say("phase 10f: sharded training (phi4-mini-3.8b and mamba2-2.7b under "
        "the world-size-1 train plan against the steps without one)")
    train_plan_stats, train_plan_launches = phase_train_plan(ops, card)
    say("  train plan " + json.dumps(train_plan_stats))
    say(f"  phase 10 took {time.perf_counter() - t0:.1f} s")
    say("phase 11: gradient compression (phi4-mini-3.8b's gradients through"
        " compressed_grad_sync on the world-size-1 group, the residual "
        "carried)")
    say("  compression " + json.dumps(phase_compression(ops, card)))
    say("phase 12: the loop around the planned training step (phase 9 under"
        " the world-size-1 train plan: saves gathered whole, the resume "
        "and restores onto a plan and onto none)")
    ckpt_plan_stats, ckpt_plan_launches = phase_checkpoint_plan(ops, card)
    say("  checkpoint plan " + json.dumps(ckpt_plan_stats))
    say("phase 13: the dry-run's cells (every cell on meta; the cells one "
        "card holds whole, decoded at their full shapes)")
    cells_stats, cells_launches, cells_rows = phase_cells(ops, card, errs)
    say("  cells " + json.dumps(cells_stats))
    for name, extra in cells_rows.items():
        rows[name].update(extra)
    say("phase 14: the dry-run's records (run_cell: counts on meta, the "
        "roofline at the card's rates) against the card")
    dryrun_stats, dryrun_launches = phase_dryrun(ops, card,
                                                 cells_stats["cells"])
    say("  dryrun " + json.dumps(dryrun_stats))

    paths = {"teacher_forcing": tf_launches, "serving": serve_launches,
             "measurement": measure_launches,
             "teacher_forcing_variants": tfv_launches,
             "teacher_forcing_moe": tfm_launches,
             "serving_" + SERVED_VARIANT: variant_launches,
             "serving_" + MOE_ARCH: moe_launches,
             "teacher_forcing_int8": tf8_launches,
             "serving_int8": int8_launches,
             "serving_" + HYBRID_ARCH: hybrid_launches,
             "teacher_forcing_" + SSM_ARCH: tfs_launches,
             "serving_" + SSM_ARCH: ssm_launches,
             "training_check": check_launches, "training": train_launches,
             "training_loop": ckpt_launches,
             "sharded_decode": shard_launches,
             **{"sharded_decode_" + a: c
                for a, c in planned_launches.items()},
             "sharded_prefill": prefill_launches,
             "sharded_training": train_plan_launches,
             "training_loop_planned": ckpt_plan_launches,
             "dryrun_cells": cells_launches,
             "dryrun_variant": dryrun_launches}
    rows["flash_decode_lora"]["grid_max_abs_err"] = \
        errs["flash_decode_lora_grid"]
    rows["sgmv"]["arrival_slices_bitwise"] = errs["sgmv_arrival_bitwise"]
    rows["flash_decode_int8"].update(
        f32q_max_abs_err=errs["f32q_int8"],
        f32q_vs_f32_dot_max_abs_err=errs["f32q_int8_vs_f32_dot"])
    table = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        path, wrapper = KERNEL_PATH[name], KERNEL_WRAPPER.get(name, name)
        # the int8 mode's launches are flash_decode's on the int8 paths,
        # flash_decode's on the others those of the bf16 and f32 caches
        own = {p: c for p, c in paths.items()
               if ("int8" in p or p == "dryrun_variant")
               == (name in KERNEL_WRAPPER)}
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": own[path][wrapper],
                      "path": path,
                      **{f"launches_{p}": c[wrapper] for p, c in own.items()},
                      "max_abs_err": errs[name], **rows[name]})
    say(json.dumps({"kernels": table}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
