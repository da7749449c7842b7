#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (the port's quickest proof
that it still starts, builds and computes the right bits on the card).

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Device: the card's name, count and ``nvidia-smi`` name/power limit.
   Exits non-zero without a CUDA device.
2. Build every CUDA kernel of the main paths from ``src/repro_torch/kernels/
   csrc`` (nine sources, one ``nvcc`` each, in parallel) and print the
   build time and ``ptxas`` resource lines (by instance for the kernels
   redesigned for Hopper: flash_attention, fxp_svm_model, fxp_mlp_model,
   fxp_mlp_fleet, fxp_svm_fleet, fxp_layer, fxp_qmatmul and
   tree_ensemble), and, where the toolkit's ``cuobjdump`` exists, the count
   of tensor-core MMA instructions in the SASS: HGMMA (warpgroup MMA) in
   each bf16 flash_attention instance, IMMA in each MLP megakernel
   instance and in each instance of the integer tile (fxp_qmatmul,
   fxp_layer's wide route; a bf16 flash instance without HGMMA, or an 8-
   or 16-bit MLP instance or a tile instance without IMMA, fails).  Then
   the data: D6 ("har") and D5 ("pendigits") from their seeds, and the D6
   tree trained by the port's CART (``max_depth=12``).
3. Each kernel against its plain PyTorch version on the card, bit for bit,
   at the main paths' shapes, every container width, values at qmin/qmax,
   int32-wrapping sums and batches 1..65536:
   * ``fxp_layer`` (561x64, 64x6, 561x6 layers, every activation, shifts 0
     and width-1) and ``fxp_mlp_model`` (561->64->6);
   * ``fxp_layer``'s narrow route: N in {1, 6, 10, 31, 32, 33} x K in
     {1, 8, 300, 561} at every activation, batches 1..65536, A a row slice
     (not 16-byte aligned), and at N 6 and 32 the largest K whose weights
     fit the narrow route beside the first K past it (the wide route); at
     least one case's int32 dot must wrap;
   * the MLP megakernels' tensor-core body at every container width: K not
     a multiple of 32 (561, 8, 33), N not a multiple of 8 (6, 10), widths
     at the routing predicate's limit (weights streamed), 8 layers, batches
     1..65536 around the 16-row tile, fleets of 2 and 8 whose slices start
     off a 16-byte boundary (M 3089, K 561), a logistic fleet (561 -> 6),
     full-range and edge values; at least one case's int32 dot must wrap;
   * ``fxp_qmatmul`` on the int8 tensor-core tile, at every container
     width: M in {1, 7, 64, 3089, 65536} x K in {8, 33, 561} x N in {6,
     300, 301}, the regimes in turn (all three at M 7), A a row slice every
     other case; K 40000 with full-range values (an s32 partial wraps); at
     least one case's int32 dot must wrap at 16 and at 32 bits;
   * ``fxp_layer``'s wide route (the same tile) at 561x64 on row slices of
     A that are not 16-byte aligned, M 7, 3089 and 65536;
   * ``fxp_svm_model``: poly and rbf at the D6 shapes (S=300, F=561, C=6)
     and the D5 shapes (S=300, F=8, C=10), nonzero random q(gamma) and
     q(coef0), degrees 1-3; and the cluster's split of the support vectors
     at S in {1, 31, 33, 300, 1696} (1696: the fit predicate's limit) x
     batches {1, 31, 3089, 65536};
   * ``tree_ensemble``: the trained D6 tree on float rows with NaN and
     +-inf values, and on int8, int16 and int32 containers (int32 rows in
     [2^24, 2^31), where the cast rounds, among them), batches 1..65536,
     with the node table in shared memory and, the budget lowered to 0
     nodes, in device memory;
   * ``fxp_mlp_fleet``: E in {2, 8} stacked 561->64->6 MLPs, one schedule
     for all and one per model, ragged and full batches, and full-range
     values whose int32 sums wrap;
   * ``fxp_svm_fleet``: poly and rbf, E = 2 (D6 shapes) and E = 4 (D5
     shapes, 3298 rows), each model its own formats, q(gamma), q(coef0)
     and degree; on the cluster body, E in {1, 2, 4, 8} x S in {1, 31, 33,
     300, 1696} x batches {1, 31, 3298, 65536} (D6 width where the plain
     version is cheap, D5 width elsewhere), and each slot of an E = 4
     launch at path D's shape against ``fxp_svm_model`` of that model;
   * ``pwl_activation``: the four variants on random values and on +-0,
     +-inf, NaN, subnormals and the segment edges 1.0, 2.375 and 5.0, on
     the (3089, 64) hidden layer, ragged shapes and an unaligned tensor, in
     float32, float16 and bfloat16 (bit for bit in each); with the fused
     bias (-0, +-inf and NaN among its values) at widths 1, 6, 7, 33, 64,
     561 and 4864 that cross the kernel's 16-byte vectors, rows 1..65536
     (4864: 1, 4 and 8192) and an unaligned view; and ``silu_pwl4`` at
     path E's decode (4, 4864) and bf16 prefill (8192, 4864) gate shapes;
   * ``flash_attention`` (not bit for bit: the two sum in other orders):
     float32 within 2e-5 and bfloat16 within 3e-2 of its plain version
     (scores materialized in float32, full float32 products), and in
     bfloat16 also every output row within 4e-2 of the row's largest
     |value| (at S 2048 a row averages ~2000 keys and is ~20x smaller than
     3e-2 allows for); causal and full, dh 32/64/128/192 (192: MLA's q/k
     width), S in {1, 7, 63, 64,
     65, 129, 2048}, BH 1 and BH 56 (4 x 14 heads) with K/V of 56 rows
     (G 1) and of 8 rows (G 7, the grouped form path E launches); head dims
     56, 80 and 112 (zero-padded to the next instance) in float32, bf16 and
     float16, and float16 at dh 64 (the float32 instance, rounded once:
     within 2^-8, one float16 ulp below 8); and with a sliding window
     (scores masked where q - k >= window, the key tiles before a query
     tile's window skipped), causal and full, float32 and bf16, windows 1,
     63, 64, 65, S - 1, S and S + 1 at S 300 and 2048, at (BH 56, dh 64,
     G 7) and zamba2's (BH 32, dh 112 padded to 128).  Two
     controls at (56, 2048, 64) bf16 causal G 7, printed beside the
     kernel's readings: the plain version with P rounded to bf16 (what the
     kernel does) must pass both bounds, and with one key tile dropped from
     the last 64 rows must fail the row bound.
3T. The block-size tuner (``kernels/tune.py``), its file pointed at a
   fresh ``build/chip_smoke_tune_cache.json`` for the run (every process
   the run starts inherits it).  Each tuned kernel at its main path's shape
   in fxp16 (fxp_qmatmul (m, 561) x (561, 300), fxp_layer's wide route 561
   x 64 and narrow route 561 x 6, fxp_mlp_model 561->64->6, fxp_svm_model
   D6 rbf, fxp_mlp_fleet 8 x 561->64->6 with schedules of their own,
   fxp_svm_fleet 4 x D5 rbf, 3298 rows in place of 3089) at 1, 64, 3089 and
   65536 rows: the tuner's own lookup sweeps every candidate with the ops
   wrappers' CUDA-event runner (each candidate's ms printed, today's and
   the chosen marked), and every candidate equals the plain version bit
   for bit; every candidate again at 8 and 32 bits (65 and 3089 rows; at
   32 bits also a 200->64->6 MLP, where the 64-row instance fits).  Then
   ``clear_memory_cache`` and the same lookups through the ops wrappers:
   answered from the file, no sweep launch.  Two processes tune six
   fxp_qmatmul shapes into the file at once: every key of both and every
   earlier key persist.  ``pretune`` of an fxp32 MLP and logistic model
   over the ladder 1..64 and 4096: one new key a bucket each, and predicts
   of 1-3089 rows then make no sweep launch.  Sweep launches count only in
   ``tune.sweep_launches`` (printed with the sweeps' seconds at the end of
   the run), so every launch count of phase 4 holds as before; the main
   paths' wrappers tune their own shapes as they first meet them.
4. The main paths, each with every launch count set to 0 just before it
   and read just after it:
   A. a seeded 561->64->6 MLP and a 561x6 logistic model on D6, compiled
      for ``backend="cuda"`` at fxp32, fxp16, fxp16_pwl4, auto16 and auto8
      (auto* calibrated on 256 train rows); ``predict`` on the 3089-row
      test split and the batch ladder 1..64.  Every MLP predict is one
      megakernel launch, every logistic predict one fxp_layer launch; the
      forced per-layer route (``REPRO_MEGAKERNEL_VMEM=0``) gives the same
      labels with two fxp_layer launches; ``flt`` runs too.
   B. the D6 tree, a D6 svm-linear (561x6), D6 svm-poly (degree 2, coef0
      1.0) and svm-rbf with 300 prototypes and gamma = 1/(F var(x)), and
      the same two kernel SVMs on D5 (300x8x10), duals fitted by float64
      least squares on 2000 train rows.  Tree and svm-linear at the five
      tags and ``flt``, kernel SVMs at fxp32, fxp16, auto16 and auto8.  One
      tree_ensemble launch per tree predict, one fxp_svm_model launch per
      kernel-SVM predict (the megakernel route), one fxp_layer launch per
      quantized svm-linear predict; the forced per-layer SVM route gives the
      same labels with one fxp_qmatmul and one fxp_layer launch.
   F. (after B) C emission: every quantized artifact of A and B emits
      its freestanding fixed-point C, built by the host's C compiler (in
      parallel) and replayed on the test rows; its labels must equal the
      ``cuda`` artifact's on every row.  The measured C sections are
      printed beside the artifact's flash and SRAM model.
   C. the flt D6 MLP with a pwl2, pwl4 or rational sigmoid on ``cuda``:
      one pwl_activation launch per predict (the hidden layer's bias added
      in it), labels equal to the plain route's (the same model on
      ``ref``) on every row whose float64 top-2 gap is at least 1e-4.
   D. the serving plane: one ``InferenceService`` on the card hosting 8 D6
      MLPs (auto16, each calibrated on its own 2000 train rows), 2 D6
      logistic models (fxp16), 4 D5 rbf SVMs (fxp32) and the D6 tree
      (fxp16).  ``enable_fleet()`` must form exactly three fleets; 6 client
      threads send 360 requests of 1-64 rows, and every response must equal
      its member's own ``predict``.  Each fleet stacks at least once, none
      falls back, fxp_mlp_fleet and fxp_svm_fleet launch, and the tree is
      served by its own worker.
   E. the dense LM stack: qwen2-0.5b at its published widths with seeded
      weights.  A bf16 prefill (batch 4 x 2048 tokens) makes exactly 24
      flash_attention launches, one per layer, each on the 2 KV heads (G 7,
      K/V not repeated); with the weights in float32
      its logits are within 1e-4 (relative) of the same forward with the
      attention through the materialized-scores oracle, and in bf16 no
      further from the float32 logits than 1.5x the oracle route; in
      float32, decode over the KV cache matches the forward within 2e-3
      (batch 2, 12 steps); an
      ``InferenceService`` serves it at ``flt`` and at fxp8/qnm with an
      int8 KV cache and the pwl4 gate, ``generate`` (batch 4, 32 tokens)
      launches no flash_attention, and its tokens are serve_step's argmax;
      at the pwl4 gate every layer's gate is one pwl_activation launch
      (silu_pwl4) per step and per forward, and the artifact's logits
      through that route are within 1e-4 of the op-by-op gate's in float32
      and, in bf16, no further from the float32 logits than 1.5x the
      op-by-op gate.
   G. the paper's pipeline on D6 at full width (after E): ``train_mlp``
      (561->64->6), ``train_logistic``, ``train_linear_svm`` and
      ``train_kernel_svm`` (rbf and poly, 400 prototypes) train on the card
      (seconds and flt test accuracy printed); each, with main()'s CART
      tree, must beat chance (1/6) by 0.5 in flt test accuracy, and the
      trained MLP must beat path A's untrained one.  Each model is compiled
      at fxp16 and auto8 on ``cuda`` and saved with its C (``include_c``)
      into the git-ignored ``build/pipeline/``; each archive is loaded on
      the card (load time printed), its labels on the 3089 test rows equal
      the saved artifact's bit for bit, one launch of its kernel
      (fxp_mlp_model, fxp_layer, fxp_svm_model or tree_ensemble) per
      predict, and the carried C equals ``emit_c()``.  A fresh
      ``InferenceService`` hosts the 12 loaded archives behind
      ``serve_http`` on 127.0.0.1; 8 client threads send every test row of
      every endpoint in requests of 1, 16 and 256 rows in turns, and every
      HTTP label must equal the in-process label; ``/v1/health`` and
      ``/v1/stats`` must answer; requests/s and p50/p99 are printed beside
      the same requests in process.  An archive with one byte flipped must
      raise ``ArtifactIntegrityError``.
   H. the LM trainer (after G; ``CUBLAS_WORKSPACE_CONFIG`` is set at the
      script's start for its resume check).  H1: qwen2-0.5b at its
      published widths (bf16 parameters, float32 moments, the config's
      remat) trains 24 steps of ``make_train_step`` at batch 8 x 512 from
      a seeded init on ``synthetic_token_stream`` (the training route:
      ``full_attention``, the gate op by op; no kernel launches in a
      step); every loss and grad norm is finite, the mean of the last five
      losses is below the first five's, step 0's loss is within 1e-2 of
      the cross-entropy of ``forward``'s logits through the kernel route
      on the same batch, and the kernel route with grad on raises
      (flash_attention and pwl_activation).  It prints ms per step (median
      of the steps after the third), tokens/s, the model-FLOPs share
      (``roofline.analytic_cost`` over the step time and the bf16 peak),
      peak memory and one step under torch.profiler (device time by kind,
      top kernels and ops, launches, the device's idle share).  H2: the
      trained weights through path E's prefill checks (24 flash_attention
      launches at 4 x 2048), their held-out loss below the initial
      weights', ``generate`` through the ``lm`` lowering, and the
      checkpoint codec timed on a 64 MB slice of the trained embedding
      table (restored onto the card bit for bit; the full state's save
      time projected).  H3: ``python -m repro_torch.launch.train`` at the
      reduced config in its own process (exit 0, steps 10 and 20
      committed, the held-out loss of step 20's weights below the
      initial's); a run to 20 against a run to 10 resumed to 20 under
      ``torch.use_deterministic_algorithms(True)`` (final parameters and
      losses bit for bit, or the op without a deterministic kernel named
      and the last loss within rtol 1e-5); and the float32 step-0 loss and
      gradients on the card within 1e-4 of the host's.
   I. the rest of the attention family (after H), one model at a time at
      its published widths with seeded weights (FAMILY_RUNS):
      deepseek-v3-671b (MLA, MoE with a shared expert and the aux-free
      router, 3 dense layers; depth 61 -> 4, prefill 2 x 8192 crossing its
      moe_prefill_chunk, decode 4 x 32 at flt and fxp8/qnm/int8-KV/pwl4),
      grok-1-314b (8 experts, GeGLU; depth 64 -> 2, prefill 4 x 2048,
      decode 4 x 32), llava-next-mistral-7b (full depth, 2880 image
      embeddings before 1216 tokens a row, batch 2; decode 4 x 32) and
      hubert-xlarge (full depth, 4 x 1500 audio frames, encoder-only).  In
      float32 at one row of FAMILY_CHECK_SEQ positions the kernel route is
      within 1e-4 of the oracle's attention (up to the first token whose
      experts differ between the two runs, none expected), decode matches
      forward within 2e-3 (the MoE capacity raised until nothing drops),
      and the MoE routing tables (top-k, weights, slot_token, token_slots,
      token_weights) on the card equal the host's bit for bit from the same
      scores with experts that overflow; the bf16 kernel route is within
      1.5x the oracle route's distance from those float32 logits (a MoE
      model's bf16 routes on the float32 run's experts).  Then the bf16
      prefill at the model's traffic: one flash_attention launch per layer
      (MLA on the dh-192 instance), the last launch's first query heads
      against the plain version (FLASH_CHECK_HEADS, bf16 bounds), finite
      logits, first-call seconds, ms, peak memory, the bound from
      ``roofline.analytic_cost`` and a torch.profiler breakdown (device
      time by kind, launches, idle share); and ``generate`` through an
      InferenceService: no flash_attention launch, one silu_pwl4 launch a
      step per gated MLP or expert stack at the pwl4 gate, deepseek-v3's
      latent cache int8 there.  Grep ``4I`` for the lines.
   J. the recurrent half of the LM stack (after I), one model at a time at
      its published widths with seeded weights, depth cut (RECURRENT_RUNS):
      zamba2-7b (25 of 81 layers: 4 groups of 5 Mamba2 layers, each
      followed by the one shared attention + MLP block with its window of
      4096, then 1 Mamba2 layer) and rwkv6-1.6b (8 of 24 layers).
      In float32: zamba2's prefill at 1 x 6144 (past the window) through
      the kernel within 1e-4 of the oracle's attention, its decode over 1 x
      64 steps within 2e-3 of the forward; rwkv6's decode against forward
      in float64 within 1e-6 (its float32 distance printed).  Then the bf16
      prefill (zamba2 2 x 8192, 4 windowed flash_attention launches, the
      last held to the plain version on its first heads; rwkv6 4 x 2048,
      no attention), profiled as in I; ``generate`` (4 x 32) through an
      InferenceService at flt and fxp8/qnm/int8-KV/pwl4 (two silu_pwl4 or
      pwl4 launches a Mamba2 or RWKV layer a step there); and
      ``launch/train.py`` at the reduced config for 3 steps in its own
      process.  Grep ``4J`` for the lines.
   K. data-parallel classifier serving over a mesh (after J; MESH_ARTS:
      path A's MLP at fxp16 and auto8 and logistic at fxp16, path B's
      depth-12 tree and D6 rbf SVM at fxp16, all on the card).  K1:
      ``spmd`` over ``make_serving_mesh()`` (every visible card) at 1, 3,
      64, 3089 and 65536 rows: labels and ``predict_with_stats`` counts
      equal the single-device artifact's bit for bit, one launch of the
      kernel a replica a predict (twice that on the first padded call: the
      pad-row probe), ``predict`` ms at 3089 and 65536 rows beside the
      single-device artifact's (in turns), and on two or more cards each
      replica's launch in a torch.profiler trace of its own card.  K2:
      ``fused`` over ``make_host_mesh(4)`` with the same artifacts: one
      launch a call untracked; 12 calls under a FaultPlan that faults
      ``mesh.replica`` on replica 0 three times (evicted after two, a
      failed probe, then re-admitted): labels bit for bit, 4 launches a
      call, the tracker's snapshot with an eviction, a probe and a
      re-admission; at ``Target(batch_policy="fixed", batch_size=64)``
      capacity 256 and 257 rows raise the reference's error.  K3: one
      InferenceService with the MLP registered single-device, on the K1
      mesh and on the K2 mesh (a second K1 registration a cache hit; three
      cache keys); 8 client threads send 240 requests of 1, 16 and 256
      rows to each endpoint in turn, every label equal to the
      single-device artifact's; requests/s and p50/p99 printed; the fused
      endpoint's snapshot has ``replica_health``.  K4: ``launch/serve.py
      --classifier mlp --dp <cards>`` serves (in process); ``--dp <cards +
      1>`` raises ``make_serving_mesh``'s error.  Grep ``4K`` for the
      lines.
   L. the LM on a device mesh (after K; DTensor, one process a card).  L1:
      ``launch/dryrun.py`` plans the 31 runnable cells on ``pod`` and on
      ``multipod`` and qwen2-0.5b's train_4k on dp64tp4, each cell's
      argument bytes a device printed against this card's memory (a cell
      over it is a finding, not a failure), its dominant roofline term and
      its plan time.  L2-L4 run on a ('data', 'model') mesh of every card
      through ``launch.mesh.run_on_mesh``: (1, 1) on one card, in this
      process (world size 1, NCCL); (2, 2) on four, a process a card.  L2:
      path H's run (qwen2-0.5b, 8 x 512, lr 1e-3) from a seeded init, 3
      float32 steps under the mesh with the loss and grad norm each within
      1e-4 relative of the single-device ``make_train_step`` from the same
      weights and batches, then 24 steps with bf16 parameters (finite, the
      loss falling, no kernel launched): ms/step, tokens/s, peak memory a
      card, launches of one profiled step, beside path H's.  L3 (elastic,
      in memory): the float32 state after step 3 under mesh A gathered and
      placed under mesh B for step 4, then back under A for step 5, each
      within 1e-4 of the single-device steps (one card: A (1, 1), B the
      single-device trainer; four: A (4, 1), B (2, 2)); then the same
      legs through the checkpoint files at ``tests/test_elastic.py``'s
      width (2 layers, d_model 64, batch 8 x 16): ``CheckpointManager``
      saves the (params, optimizer state) of each leg and restores it into
      a tree placed for the next (the ``like``), each leaf placed as its
      ``like`` and each step within 1e-4 of the single-device steps.  L4: the bf16
      prefill (4 x 2048) under rules makes exactly 24 flash_attention
      launches on each rank (its local heads) and is no further from the
      float32 logits than 1.5x the single-device kernel route; 8 float32
      ``serve_step``s (batch 4) from a cache placed by ``cache_specs``
      within 2e-3 of the single-device decode.  Grep ``4L`` for the lines.
   L5. the attention families on path L's mesh (after L; (1, 1) on one
      card, in this process; (2, 2) on four, a process a card).  L5a, in
      float32 at the CPU tests' widths (d_model 512, 8 heads over 2 KV
      heads, vocabulary 512; L5A_CASES): grok-1 with ``tp`` experts,
      deepseek-v3 (MLA, a dense layer, the aux-free router, a shared
      expert) with ``ep`` and with 8 ``ep2d`` experts, llava-next and
      hubert: ``loss_and_grads``, one ``make_train_step``, ``forward`` and
      four ``serve_step``s (none for hubert) under the mesh, each within
      1e-4 of the single device on the same card (every gradient leaf of
      its leaf's largest value; the stepped parameters absolute, where the
      gradient is at least 1e-6), and the experts of every token equal.
      L5b, in bf16 at published widths with seeded weights and the pwl4
      gate (L5B_RUNS: deepseek-v3 4 of 61 layers at 2 x 4096, grok-1 2 of
      64 at 4 x 2048, llava-next 2 of 32 at 2 x (2880 image embeddings +
      1216 tokens), hubert 2 of 48 at 4 x 1500; decode 4 x 32 but for
      hubert): rank 0's single-device prefill and decode first, the
      weights then placed leaf by leaf (the full tree freed as the placed
      one grows); the sharded prefill makes one flash_attention launch a
      layer on each rank (deepseek-v3's on the dh-192 instance) and one
      pwl_activation a gated MLP or expert stack, its last flash launch's
      first heads held to the plain version, its logits finite and equal
      to the single device's on (1, 1) (on four cards their distance is
      printed with the count of token routings that pick other experts
      than one card's and the distance before each row's first, and the
      bytes a MoE layer call sends, counted from DTensor's collectives);
      the sharded decode one pwl_activation a gated stack a step;
      ms, device time, launches and idle share of one profiled prefill,
      decode ms/token, parameter bytes a card and peak memory (under 75
      GiB).  The last pwl_activation launch of each sharded prefill is held
      to its plain version bit for bit, and on (1, 1) the sharded decode
      equals the single device's too.  Grep ``4L5`` for the lines.
   L6. the hybrid and RWKV on path L's mesh (after L5, the same mesh).
      L6a, in float32 at the CPU tests' widths (L6A_CASES: zamba2, one
      group of 2 Mamba2 layers with the shared block and a tail of 1, 32
      SSM heads in 2 groups; rwkv6, 2 layers of 8 heads; batch 8 x 64):
      L5a's readings against one card, each within 1e-4, or for rwkv6
      within one card's own float32 distance from a float64 run of the
      same weights where that is further (RWKV's float32 gradients are
      resolved to ~3e-4 here); and rwkv6 in float64, each within 1e-4.  L6b, in bf16 at
      published widths with the pwl4 gate (L6B_RUNS: zamba2 13 of 81
      layers at 2 x 8192, past its window of 4096; rwkv6 4 of 24 at 4 x
      2048; decode 4 x 32): L5b's readings, with one flash_attention launch
      a shared-block call (its window) and two pwl_activation launches a
      Mamba2 or RWKV layer on each rank, the last of each held to its plain
      version, and on four cards the bytes a Mamba2 and an RWKV layer
      send.  Grep ``4L6`` for the lines.
   In A, B and D, labels equal the plain versions' on the card (in D, each
   member's own predict); in A and B the rows where ``ref`` and ``cuda``
   differ are printed as information.
5. Timing with CUDA events after warm-up: flash_attention at the prefill's
   shape (BH 56, S 2048, dh 64, bf16 causal), with K/V of 8 rows (G 7, as
   path E launches it) and of 56, beside its plain version, its bound and
   ``scaled_dot_product_attention`` (the library yardstick, with
   ``enable_gqa`` for the grouped form), and its dh-192 instance at path
   I's MLA shape (BH 256, S 8192, v padded from 128; its first heads held
   to the plain version) beside the MLA function's bound and that library
   call (kept as ``dh192_*`` in the record), and with a window of 4096 at
   path J's zamba2 shape (BH 64, S 8192, dh 112; its first heads held to
   the plain version) beside the window's bound, the same kernel without
   the window and ``scaled_dot_product_attention`` with the boolean window
   mask (kept as ``window_*``), at the longdoc cell's shapes (BH 32, G 4,
   dh 128, causal, S 8192 and 24960; the first heads at 8192 held to the
   plain version) beside their bounds (kept as ``longdoc_*``), the
   prefill forward and the kernel's share of it, decode ms/token at both
   served targets; each recorded kernel's device time from a
   torch.profiler trace besides (below ~0.04 ms the CUDA-event loop
   measures the host's launch cost), and fxp_svm_model's at fxp16 rbf
   at every timed batch, fxp_layer's at the logistic head (fxp16, 3089 and
   65536 rows), at the SVM per-layer route's decision stage (3089 x 300
   x 6 and 65536 rows) and on its wide route at the per-layer MLP's first
   layer (561 x 64, fxp16, auto8 and fxp32), fxp_qmatmul's and
   tree_ensemble's at 3089 and 65536 rows (the tree on the container the
   lowering passes it); each kernel and its plain version
   at batches 1, 64, 3089 and 65536 (the fleet kernels at 3089 or 3298 and
   65536, fxp_svm_fleet also at a 64-row serving round, beside eight
   fxp_mlp_model and four fxp_svm_model launches), beside the bound;
   ``predict`` end to end and by stage (pageable and pinned rows); the
   host time of ``FleetStack.predict_device`` beside the time until the
   card is done (equal times would mean a hidden synchronization); the
   device activities of one fxp16 tree predict beside the route of the
   first tree lowering (a float32 cast before the kernel); and the
   first serving record: 8 D6 MLP endpoints, 8 client threads each sending
   500 one-row requests one at a time, fleet off and on.  pwl_activation's
   record is path C's hidden layer with the fused bias (beside the unfused
   pair); path E's pwl4 gate is timed at its decode and prefill shapes
   beside the op-by-op gate, a bf16 prefill forward at the pwl4 gate and
   one fxp8/qnm/int8-KV/pwl4 decode step are profiled with the gate
   through the kernel and op by op (launches, device activities, the
   kernel's device time a layer against its bytes bound), decode ms/token
   of that artifact is taken with the two routes in turns, and path C's
   predict is profiled (device time by kernel, activities, launches)
   beside its lowering with the bias added outside the kernel at 1, 64,
   3089 and 65536 rows.  Phase 5 times each kernel at today's blocking;
   last, path A's fxp16 MLP and logistic ``predict`` at 1 and 3089 rows
   with the tuner's warm lookup beside the same calls with today's
   blocking passed as an override, in turns.  The JSON record of each
   tuned kernel gains phase 3T's choice at its main shape (``blocks``,
   ``blocks_ms``) beside today's (``blocks_today``, ``blocks_today_ms``).

The lines before the last are a JSON ``{"kernels": [...]}`` record and the
``nvidia-smi`` name/power-limit line; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# deterministic cuBLAS for path H's resume check; set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT8_TENSOR_OPS_PER_S = 1979e12  # dense int8 tensor-core rate (data sheet)
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores (data sheet)
BF16_TENSOR_OPS_PER_S = 989.4e12  # dense bf16 tensor-core rate (data sheet)
INT32_LANES_PER_SM = 64  # Hopper SM: 64 INT32 lanes, one IMAD (2 ops) each
TAGS = {
    "fxp32": dict(number_format="fxp32"),
    "fxp16": dict(number_format="fxp16"),
    "fxp16_pwl4": dict(number_format="fxp16", sigmoid="pwl4"),
    "auto16": dict(number_format="auto16"),
    "auto8": dict(number_format="auto8"),
}
TREE_TAGS = tuple(TAGS) + ("flt",)  # tree and svm-linear
SVM_TAGS = ("fxp32", "fxp16", "auto16", "auto8")  # kernel SVMs
BATCHES = (1, 7, 64, 3089, 65536)
TIMED_BATCHES = (1, 64, 3089, 65536)
LADDER = (1, 2, 4, 8, 16, 32, 64)
N_CALIBRATION = 256
N_PROTOTYPES = 300
N_FIT_ROWS = 2000
TREE_DEPTH = 12  # benchmarks/common.py:40
FLASH_LENGTHS = (1, 7, 63, 64, 65, 129, 2048)  # around the 64-wide tiles
# pwl_activation's fused bias: widths that cross the 4- and 8-value
# vectors of its 16-byte loads (1, D5-like 6 and 7, 33), path C's hidden
# layer (64), D6's 561 and qwen2-0.5b's d_ff (4864, at the LM's rows), at
# batches 1..65536
PWL_BIAS_COLS = (1, 6, 7, 33, 64, 561, 4864)
PWL_BIAS_ROWS = (1, 7, 3089, 65536)
# (BH, group G): one head, and qwen2-0.5b's 14 heads x batch 4, ungrouped
# and with its 2 KV heads (G = 7, as path E launches it)
FLASH_HEADS = ((1, 1), (56, 1), (56, 7))
# bf16 flash_attention against its plain version: max abs error, and max
# over rows of (max |error| in the row) / (max |value| in the row); see
# PERF.md (Findings) for the readings that set the row bound
FLASH_BF16_ATOL, FLASH_BF16_ROW_RTOL = 3e-2, 4e-2
# query heads of a large flash_attention launch held against the plain
# version (its float32 scores: 2 GiB at S 8192)
FLASH_CHECK_HEADS = 8
# float16 flash_attention runs the float32 instance and rounds its output
# once to float16: one float16 ulp of an output below 8 in magnitude
FLASH_FP16_ATOL = 2.0 ** -8
# head dims between the kernel's instances (deepseek-v3 56, hubert 80,
# zamba2 112): zero-padded to the next instance by the wrapper
FLASH_PADDED_DIMS = (56, 80, 112)
# sliding windows: ragged and tile-aligned S, each with windows 1, 63, 64,
# 65, S - 1, S and S + 1; at (BH 56, dh 64, G 7) and at zamba2's dh 112
# (padded to 128) with 32 heads, ungrouped
FLASH_WINDOW_LENGTHS = (300, 2048)
FLASH_WINDOW_HEADS = ((64, 56, 7), (112, 32, 1))  # (dh, BH, G)
SVM_LENGTHS = (1, 31, 33, 300, 1696)  # 1696: the fit predicate's limit
SVM_BATCHES = (1, 31, 3089, 65536)
SVM_FLEET_SIZES = (1, 2, 4, 8)
SVM_FLEET_BATCHES = (1, 31, 3298, 65536)  # 3298: the D5 test split
# fxp_layer around its narrow route (N <= 32): N at 1, the main paths' 6
# and 10 classes, and the bucket edges; K at 1, D5's 8, the SVM decision
# stage's 300 and D6's 561; batches 1..65536
LAYER_NS = (1, 6, 10, 31, 32, 33)
LAYER_KS = (1, 8, 300, 561)
LAYER_BATCHES = (1, 7, 31, 64, 3089, 65536)
# fxp_qmatmul on the int8 tensor-core tile (csrc/fxp_tile.cuh): K at D5's
# 8, one past a k32 step and D6's 561; N at the 6 classes, the 300
# prototypes and one past them
QMATMUL_KS = (8, 33, 561)
QMATMUL_NS = (6, 300, 301)
LM_ARCH = "qwen2-0.5b"  # src/repro_torch/configs/qwen2_0_5b.py, full width
LM_BATCH, LM_SEQ = 4, 2048  # the bf16 prefill
LM_DECODE_BATCH, LM_DECODE_STEPS = 2, 12  # the float32 decode-vs-forward check
LM_GEN_BATCH, LM_GEN_TOKENS = 4, 32  # generate on each served target
# the kernels redesigned for Hopper: their ptxas lines by instance
REDESIGNED = ("flash_attention", "fxp_svm_model", "fxp_mlp_model",
              "fxp_mlp_fleet", "fxp_svm_fleet", "fxp_layer", "fxp_qmatmul",
              "tree_ensemble")
# tensor-core MMA in the SASS: (library, instance name part, opcode); each
# instance whose name holds the part must issue the opcode
TENSOR_CORE_SASS = (("flash_attention", "4bf16", "HGMMA"),  # bf16:: instances
                    ("fxp_mlp_model", "mma_kernel", "IMMA"),
                    ("fxp_mlp_fleet", "mma_kernel", "IMMA"),
                    ("fxp_qmatmul", "fxp_qmatmul_kernel", "IMMA"),
                    ("fxp_layer", "fxp_layer_kernel", "IMMA"))


def log(*args):
    print(*args, flush=True)


def row_rel_err(got, want):
    """Max over the rows of (max |got - want| in the row) / (max |want| in
    the row), in float32: an attention output's error against the row's own
    scale, which at S 2048 is ~20x below an absolute bound of 3e-2."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1).clamp_min(1e-30)
    return float((err / scale).max()) if err.numel() else 0.0


def attention_control(torch, q, k, v, p_bf16=False, drop=None):
    """Causal attention with float32 scores as the plain version computes
    it, changed in one way: ``p_bf16`` rounds the unnormalized p to bf16
    before P.V (l sums the float32 p), ``drop=(a, b, r)`` masks keys
    [a, b) from rows r.. (a fault that loses one key tile)."""
    s, dh = q.shape[1], q.shape[2]
    scale = float(np.float32(1.0 / math.sqrt(dh)))
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    pos = torch.arange(s, device=q.device)
    masked = pos[None, :] > pos[:, None]
    if drop is not None:
        a, b, r = drop
        masked = masked | ((pos[:, None] >= r) & (pos[None, :] >= a)
                           & (pos[None, :] < b))
    scores = scores.masked_fill(masked, -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    del scores
    l = p.sum(-1, keepdim=True)
    if p_bf16:
        p = p.to(torch.bfloat16).float()
    return (torch.einsum("bqk,bkd->bqd", p, v.float()) / l).to(q.dtype)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Device:
    """Phase 1: what we run on, and the peak rates the bounds use."""

    def __init__(self, torch):
        self.name = torch.cuda.get_device_name(0)
        self.count = torch.cuda.device_count()
        self.smi_line = smi("name,power.limit")
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.max_sm_mhz = float(smi("clocks.max.sm").split()[0])
        self.int32_ops_per_s = (self.sms * INT32_LANES_PER_SM * 2
                                * self.max_sm_mhz * 1e6)
        log(f"device: {self.name} x{self.count}; nvidia-smi: {self.smi_line}")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{self.sms} SMs, clocks.max.sm {self.max_sm_mhz:.0f} MHz")
        log(f"peaks used for bounds: HBM {HBM_BYTES_PER_S / 1e12} TB/s; int32 "
            f"CUDA cores {self.int32_ops_per_s / 1e12:.2f} Top/s "
            f"({self.sms} SMs x {INT32_LANES_PER_SM} lanes x 2 ops x "
            f"{self.max_sm_mhz:.0f} MHz); int8 tensor cores "
            f"{INT8_TENSOR_OPS_PER_S / 1e12:.0f} Top/s; float32 "
            f"{FP32_OPS_PER_S / 1e12:.0f} Tflop/s")

    def int_peak(self, bits: int) -> float:
        """Peak integer rate for a container width."""
        return INT8_TENSOR_OPS_PER_S if bits == 8 else self.int32_ops_per_s

    def mma_peak(self, bits: int) -> float:
        """Peak rate of a container width's products on the MLP
        megakernels' route: int8 tensor cores at 8 bits, four int8 MMAs per
        product at 16 bits (split bytes), the CUDA cores at 32 bits."""
        return {8: INT8_TENSOR_OPS_PER_S, 16: INT8_TENSOR_OPS_PER_S / 4,
                32: self.int32_ops_per_s}[bits]

    def tile_peak(self, bits: int) -> float:
        """Peak rate of a container width's products on the integer tile of
        fxp_qmatmul and fxp_layer's wide route: every width on the int8
        tensor cores, one, four or ten int8 MMAs a product (byte planes
        whose pairs i + j <= 3 survive mod 2^32)."""
        return INT8_TENSOR_OPS_PER_S / {8: 1, 16: 4, 32: 10}[bits]

    def bound(self, nbytes: int, ops: int, peak: float):
        """(bound_ms, bound_by): the larger of bytes over the memory rate and
        operations over the peak rate for the operand type."""
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# --------------------------------------------------------------------------
# launch counts
# --------------------------------------------------------------------------
def reset_launches(K):
    for fn in K.launchers.values():
        fn.launches = 0


def launch_counts(K):
    return {name: fn.launches for name, fn in K.launchers.items()}


def expect_launches(K, before, want, what):
    """Fail unless the launches since ``before`` are exactly ``want``
    (kernels not named: none)."""
    now = launch_counts(K)
    got = {n: now[n] - before[n] for n in now}
    expected = {n: want.get(n, 0) for n in now}
    if got != expected:
        raise AssertionError(f"{what}: launches {got}, expected {expected}")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------
def _ints(rng, shape, bits, regime):
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    if regime == "mid":
        mag = {8: 3, 16: 7, 32: 12}[bits]
        lo, hi = -(2 ** mag), 2 ** mag - 1
    v = rng.randint(lo, hi + 1, shape, dtype=np.int64)
    if regime == "edge":  # only the container's extremes and their neighbours
        v = np.choose(rng.randint(0, 5, shape), [lo, lo + 1, -1, hi - 1, hi])
    return v.astype({8: np.int8, 16: np.int16, 32: np.int32}[bits])


def _mid_shift(bits, k):
    """A shift that lands a 'mid' accumulator inside the container."""
    mag = {8: 3, 16: 7, 32: 12}[bits]
    return max(0, min(31, 2 * mag + math.ceil(math.log2(k)) // 2 - (bits - 4)))


def non_finite_rows(x, tree):
    """A copy of the float rows ``x`` whose first rows hold NaN and +-inf
    in the patterns the tree kernel must treat as the TPU kernel does."""
    x = np.array(x, np.float32)
    root, f = int(tree.feature[0]), x.shape[1]
    x[0, 5] = np.nan
    x[1, f - 1] = np.inf
    x[2, root] = -np.inf  # a single -inf: left exactly at its feature
    x[3, (root + 1) % f] = -np.inf
    x[4, [0, 2]] = -np.inf
    x[5, :] = np.inf
    x[6, root] = np.inf
    return x


def pwl_edges():
    """Values the PWL kernel must treat as the reference does: +-0, +-inf,
    NaN, subnormals and the smallest normal, the segment edges 1.0, 2.375
    and 5.0 with their float32 neighbours, and the float32 extremes."""
    f32 = np.finfo(np.float32)
    vals = [0.0, np.inf, np.nan, 1e-45, 1e-39, float(f32.tiny),
            float(f32.max)]
    for v in np.asarray([1.0, 2.375, 5.0], np.float32):
        vals += [v, np.nextafter(v, np.float32(0)),
                 np.nextafter(v, np.float32(9))]
    vals = np.asarray(vals, np.float32)
    return np.concatenate([vals, -vals])


class KernelCheck:
    """Phase 3: every comparison of a kernel with its plain version."""

    NAMES = ("fxp_layer", "fxp_mlp_model", "fxp_qmatmul", "fxp_svm_model",
             "tree_ensemble", "pwl_activation", "fxp_mlp_fleet",
             "fxp_svm_fleet", "flash_attention")

    def __init__(self, torch, K):
        self.torch, self.K = torch, K
        self.cases = {n: 0 for n in self.NAMES}
        self.max_abs_err = {n: 0 for n in self.NAMES}
        self.wrapped = 0  # SVM cases whose x . sv^T wrapped int32
        self.mlp_wrapped = 0  # MLP cases whose first int32 dot wrapped
        self.layer_wrapped = 0  # fxp_layer cases whose int32 dot wrapped
        self.layer_routes = {"narrow": 0, "tile": 0}
        # fxp_qmatmul cases whose int32 dot wrapped, by container width
        self.qmatmul_wrapped = {8: 0, 16: 0, 32: 0}
        self.tree_routes = {"smem": 0, "global": 0}
        self.pwl_bias_cases = 0  # pwl_activation cases with the fused bias
        self.flash_err = {}  # dtype -> max abs err of flash_attention
        self.flash_row_rel = 0.0  # bf16: max per-row relative error
        self.flash_window_cases = 0  # flash_attention cases with a window

    def _compare(self, name, got, want, what):
        torch = self.torch
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name} {what}: {got.dtype}{tuple(got.shape)}"
                                 f" vs plain {want.dtype}{tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        self.max_abs_err[name] = max(self.max_abs_err[name], err)
        self.cases[name] += 1
        if err:
            bad = int((got != want).sum())
            raise AssertionError(f"{name} {what}: {bad} elements differ from "
                                 f"the plain version (max abs err {err})")

    def _compare_bits(self, name, got, want, what):
        """Float results: the same bits everywhere, float32, float16 or
        bfloat16 (the card's NaN is canonical in both); max_abs_err over the
        finite entries."""
        torch = self.torch
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name} {what}: {got.dtype}{tuple(got.shape)}"
                                 f" vs plain {want.dtype}{tuple(want.shape)}")
        both = torch.isfinite(got) & torch.isfinite(want)
        err = float((got[both].double() - want[both].double()).abs().max()) \
            if bool(both.any()) else 0.0
        self.max_abs_err[name] = max(self.max_abs_err[name], err)
        self.cases[name] += 1
        as_int = {4: torch.int32, 2: torch.int16}[got.element_size()]
        bad = int((got.view(as_int) != want.view(as_int)).sum())
        if bad:
            raise AssertionError(f"{name} {what}: {bad} elements differ from "
                                 f"the plain version in their bits (max abs "
                                 f"err {err})")

    def _compare_close(self, name, got, want, atol, what):
        """Float results that sum in another order: within ``atol``, every
        entry finite."""
        torch = self.torch
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name} {what}: {got.dtype}{tuple(got.shape)}"
                                 f" vs plain {want.dtype}{tuple(want.shape)}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} {what}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        self.max_abs_err[name] = max(self.max_abs_err[name], err)
        self.cases[name] += 1
        if err > atol:
            raise AssertionError(f"{name} {what}: max abs err {err} against "
                                 f"the plain version, over {atol}")
        return err

    def flash_case(self, gen, dtype, causal, dh, s, bh, group, window=None):
        """The kernel against its plain version (K/V repeated to the query
        heads, scores materialized in float32): atol 2e-5 in float32, 3e-2
        in bfloat16, the reference's bounds (tests/test_kernels.py), and in
        bfloat16 the per-row relative bound; within a sliding ``window``
        when one is given."""
        torch, fa = self.torch, self.K.fa
        q = torch.randn(bh, s, dh, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(bh // group, s, dh, generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        got = fa.flash_attention_cuda(q, k, v, causal, window)
        want = fa.flash_attention_plain(q, k, v, causal, window=window)
        what = (f"{dtype} causal={causal} (BH {bh}, S {s}, dh {dh}, G "
                f"{group}, window {window})")
        if window is not None:
            self.flash_window_cases += 1
        atol = {torch.float32: 2e-5, torch.bfloat16: FLASH_BF16_ATOL,
                torch.float16: FLASH_FP16_ATOL}[dtype]
        err = self._compare_close("flash_attention", got, want, atol, what)
        key = str(dtype).replace("torch.", "")
        self.flash_err[key] = max(self.flash_err.get(key, 0.0), err)
        if dtype == torch.bfloat16:
            rel = row_rel_err(got, want)
            self.flash_row_rel = max(self.flash_row_rel, rel)
            if rel > FLASH_BF16_ROW_RTOL:
                raise AssertionError(f"flash_attention {what}: a row's error "
                                     f"is {rel} of its largest value, over "
                                     f"{FLASH_BF16_ROW_RTOL}")

    def flash_controls(self, gen):
        """The bf16 bounds' controls at the prefill's shape (BH 56, S 2048,
        dh 64, causal, G 7): the plain version with P rounded to bf16 before
        P.V (l from the float32 p) must pass both bounds; with keys
        1920..1983 dropped from the rows that see key 1984 (the last query
        tile loses one key tile) it must fail the row bound."""
        torch, fa = self.torch, self.K.fa
        bh, s, dh, group = 56, 2048, 64, 7
        q = torch.randn(bh, s, dh, generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (fa.expand_kv(torch.randn(bh // group, s, dh, generator=gen,
                                         device="cuda").to(torch.bfloat16),
                             group) for _ in range(2))
        want = fa.flash_attention_plain(q, k, v, True)
        readings = {}
        for name, kw in (("P bf16", dict(p_bf16=True)),
                         ("tile dropped", dict(drop=(1920, 1984, 1984)))):
            got = attention_control(torch, q, k, v, **kw)
            readings[name] = (float((got.float() - want.float()).abs().max()),
                              row_rel_err(got, want))
        abs_p, rel_p = readings["P bf16"]
        if abs_p > FLASH_BF16_ATOL or rel_p > FLASH_BF16_ROW_RTOL:
            raise AssertionError(f"flash_attention control: the plain version "
                                 f"with P in bf16 fails the bounds "
                                 f"({readings})")
        if readings["tile dropped"][1] <= FLASH_BF16_ROW_RTOL:
            raise AssertionError(f"flash_attention control: a dropped key "
                                 f"tile passes the row bound ({readings})")
        log(f"  flash_attention bf16 controls at (BH 56, S 2048, dh 64) "
            f"causal, G 7, (max abs err, max row relative err) against the "
            f"plain version: " + ", ".join(
                f"{n} ({a:.4e}, {r:.4e})" for n, (a, r) in readings.items()))

    def _cuda(self, *arrays):
        return [self.torch.from_numpy(a).cuda() for a in arrays]

    def pwl_case(self, rng, shape, variant, offset=0, dtype=None):
        """float32, or a narrow float (rounded from the same values): the
        kernel computes in float32 and rounds to nearest even on the store,
        as the plain version's cast does."""
        K = self.K
        n = int(np.prod(shape))
        flat = (rng.randn(n + offset) * 4).astype(np.float32)
        edges = pwl_edges()
        flat[offset:offset + min(n, edges.size)] = edges[:n]
        x, = self._cuda(flat)
        if dtype is not None:
            x = x.to(dtype)
        x = x[offset:].view(shape)  # offset 1: an unaligned tensor
        got = K.pwl.pwl_activation_cuda(x, variant)
        want = K.pwl.pwl_activation_plain(x, variant)
        self._compare_bits("pwl_activation", got, want,
                           f"{variant} {x.dtype} {shape} offset {offset}")

    def pwl_bias_case(self, rng, dtype, variant, rows, cols, offset=0):
        """The fused bias: ``variant(x + b)``, x (rows, cols) with the edges
        in its first values (a view ``offset`` values past a 16-byte
        boundary when offset > 0), b (cols,) with -0, +-inf and NaN first;
        bit for bit against the plain version's ``pwl(x + b)``."""
        K = self.K
        flat = (rng.randn(rows * cols + offset) * 4).astype(np.float32)
        edges = pwl_edges()
        flat[offset:offset + min(rows * cols, edges.size)] = \
            edges[:rows * cols]
        b = (rng.randn(cols) * 2).astype(np.float32)
        b[:4] = np.asarray([-0.0, np.inf, -np.inf, np.nan], np.float32)[:cols]
        x, b = self._cuda(flat, b)
        x = x.to(dtype)[offset:].view(rows, cols)
        b = b.to(dtype)
        got = K.pwl.pwl_activation_cuda(x, variant, bias=b)
        want = K.pwl.pwl_activation_plain(x, variant, bias=b)
        self._compare_bits("pwl_activation", got, want,
                           f"{variant} {x.dtype} ({rows}, {cols}) + bias "
                           f"offset {offset}")
        self.pwl_bias_cases += 1

    def pwl_cases(self, rng):
        """The four variants without a bias (random values and the edges,
        ragged shapes, an unaligned tensor), with the fused bias at widths
        that cross the 16-byte vectors (C 1..4864, rows 1..65536, an
        unaligned view), and silu_pwl4 at path E's gate shapes: decode (4,
        4864) and the bf16 prefill (4 x 2048, 4864)."""
        torch = self.torch
        for variant in self.K.pwl.PWL_VARIANTS:
            for dtype in (None, torch.float16, torch.bfloat16):
                for shape in ((3089, 64), (7, 13), (5, 3, 2)):
                    self.pwl_case(rng, shape, variant, dtype=dtype)
                self.pwl_case(rng, (4097,), variant, offset=1, dtype=dtype)
        for variant in self.K.pwl.PWL_VARIANTS:
            for dtype in (torch.float32, torch.float16, torch.bfloat16):
                for cols in PWL_BIAS_COLS:
                    rows_list = ((1, 4, LM_BATCH * LM_SEQ) if cols > 561
                                 else PWL_BIAS_ROWS)
                    for rows in rows_list:
                        self.pwl_bias_case(rng, dtype, variant, rows, cols)
                    self.pwl_bias_case(rng, dtype, variant, 7, cols, offset=1)
        d_ff = self.K.configs.get_config(LM_ARCH).d_ff
        for dtype in (None, torch.bfloat16):
            self.pwl_case(rng, (LM_GEN_BATCH, d_ff), "silu_pwl4",
                          dtype=dtype)
        self.pwl_case(rng, (LM_BATCH * LM_SEQ, d_ff), "silu_pwl4",
                      dtype=torch.bfloat16)

    def mlp_fleet_case(self, rng, bits, e, m, hetero, regime):
        K = self.K
        dims = (561, 64, 6)
        acts = K.layer.LAYER_ACTIVATIONS
        scheds = []
        for i in range(e):
            j = i if hetero else 0
            if regime == "mid":
                shifts = (_mid_shift(bits, 561) - j % 2,
                          _mid_shift(bits, 64) + j % 3)
                fracs = (bits - 6 - j % 2, bits - 6)
            else:  # full-range values: int32 sums wrap
                shifts, fracs = (bits - 1 - j % 2, 0), (bits - 1, j % 2)
            act = acts[1 + (j + bits) % (len(acts) - 1)]
            scheds.append(((shifts[0], K.fxp.FxpFormat(bits, fracs[0]), act),
                           (shifts[1], K.fxp.FxpFormat(bits, fracs[1]),
                            "none")))
        scheds = tuple(scheds)
        x, = self._cuda(_ints(rng, (e, m, dims[0]), bits, regime))
        ws = self._cuda(*[_ints(rng, (e, i, o), bits, regime)
                          for i, o in zip(dims, dims[1:])])
        bs = self._cuda(*[_ints(rng, (e, o), bits, "full") for o in dims[1:]])
        got = K.model.fxp_mlp_fleet_cuda(x, ws, bs, scheds)
        want = K.model.fxp_mlp_fleet_plain(x, ws, bs, scheds)
        self._compare("fxp_mlp_fleet", got, want,
                      f"w{bits} E={e} {m}x{dims} "
                      f"{'per-model' if hetero else 'uniform'} schedules "
                      f"{regime}")

    def _count_wrap(self, x, w):
        """Whether the first layer's exact dot over the first rows leaves
        int32 (float64 is exact below 2^53, so at 8 and 16 bits)."""
        torch = self.torch
        dot = x[:64].to(torch.float64) @ w.to(torch.float64)
        self.mlp_wrapped += int(dot.abs().max() >= 2 ** 31)

    def _mlp_schedule(self, bits, dims, regime, j):
        """A schedule for ``dims``: model j's shifts and formats vary with
        j; hidden layers take the activations in turn, the last none."""
        fxp, acts = self.K.fxp, self.K.layer.LAYER_ACTIVATIONS
        n, sched = len(dims) - 1, []
        for l in range(n):
            hidden = l < n - 1
            if regime == "mid":
                shift = max(0, _mid_shift(bits, dims[l]) - j % 2)
                frac = bits - 6 - (j % 2 if hidden else 0)
            elif regime == "full":  # full-range values: int32 sums wrap
                shift, frac = ((bits - 1 - j % 2, bits - 1) if hidden
                               else (0, j % 2))
            else:  # edge
                shift, frac = (0, bits - 1) if hidden else (bits - 1, 0)
            act = acts[(l + j + bits) % len(acts)] if hidden else "none"
            sched.append((min(shift, 31), fxp.FxpFormat(bits, frac), act))
        return tuple(sched)

    def mlp_shape_case(self, rng, bits, dims, m, e=0, hetero=False,
                       regime="mid"):
        """fxp_mlp_model (e = 0) or fxp_mlp_fleet of e models at any widths
        and depth, against the plain version; counts int32-wrapping dots."""
        K = self.K
        n_models = max(e, 1)
        scheds = tuple(self._mlp_schedule(bits, dims, regime,
                                          i if hetero else 0)
                       for i in range(n_models))
        x, = self._cuda(_ints(rng, (n_models, m, dims[0]), bits, regime))
        ws = self._cuda(*[_ints(rng, (n_models, i, o), bits, regime)
                          for i, o in zip(dims, dims[1:])])
        bs = self._cuda(*[_ints(rng, (n_models, o), bits, "full")
                          for o in dims[1:]])
        self._count_wrap(x[0], ws[0][0])
        what = (f"w{bits} {m}x{tuple(dims)} {regime}"
                + (f" E={e} {'per-model' if hetero else 'uniform'}"
                   if e else ""))
        if e:
            got = K.model.fxp_mlp_fleet_cuda(x, ws, bs, scheds)
            want = K.model.fxp_mlp_fleet_plain(x, ws, bs, scheds)
            self._compare("fxp_mlp_fleet", got, want, what)
        else:
            args = (x[0], [w[0] for w in ws], [b[0] for b in bs], scheds[0])
            got = K.model.fxp_mlp_model_cuda(*args)
            want = K.model.fxp_mlp_model_plain(*args)
            self._compare("fxp_mlp_model", got, want, what)

    def mlp_cases(self, rng, bits):
        """The tensor-core MLP body's edges (every container width; the
        32-bit one runs the CUDA-core body): K not a multiple of 32 (561, 8,
        33), N not a multiple of 8 (6, 10), widths at the routing
        predicate's limit (weights streamed through a chunk), 8 layers,
        batches around the 16-row tile up to 65536, fleets of 2 and 8 whose
        slices start off a 16-byte boundary (M 3089, K 561), a logistic
        fleet (one layer, N 6), full-range and edge values."""
        limit = self.K.tune.SMEM_PER_BLOCK // (2 * self.K.tune.MODEL_BLOCK_M
                                               * bits // 8)
        for dims in ((561, 64, 6), (8, 16, 10), (33, 40, 6), (64, 10),
                     (561, 6)):
            for m, regime in ((3089, "mid"), (31, "full"), (33, "edge")):
                self.mlp_shape_case(rng, bits, dims, m, regime=regime)
        for m in (1, 7, 15, 16, 17, 31, 3089, 65536):
            self.mlp_shape_case(rng, bits, (561, 64, 6), m,
                                regime="full" if m < 3089 else "mid")
        for dims in ((limit, 64, 6), (48, limit, 6), (limit, 6)):
            self.mlp_shape_case(rng, bits, dims, 40, regime="mid")
            self.mlp_shape_case(rng, bits, dims, 17, regime="edge")
        deep = (40, 32, 24, 48, 16, 33, 8, 12, 6)  # 8 layers
        self.mlp_shape_case(rng, bits, deep, 3089, regime="mid")
        self.mlp_shape_case(rng, bits, deep, 31, regime="edge")
        for e in (2, 8):
            for hetero in (False, True):
                self.mlp_shape_case(rng, bits, (561, 64, 6), 3089, e, hetero,
                                    "full" if hetero else "mid")
            self.mlp_shape_case(rng, bits, (561, 6), 3089, e, True, "mid")
            self.mlp_shape_case(rng, bits, (561, 6), 33, e, True, "edge")
        self.mlp_shape_case(rng, bits, deep, 100, 2, True, "mid")
        self.mlp_shape_case(rng, bits, (limit, 64, 6), 20, 2, True, "mid")

    def _svm_params(self, rng, bits, regime):
        """(fmt, out_fmt, q(gamma), q(coef0), degree, dec_shift): random,
        nonzero q(gamma)."""
        frac = bits - 6 if regime == "mid" else bits - 1 - rng.randint(0, 4)
        fmt = self.K.fxp.FxpFormat(bits, frac)
        out_fmt = self.K.fxp.FxpFormat(bits, rng.randint(0, bits))
        if regime == "mid":  # kernel values inside the format, not saturated
            qgamma = int(rng.randint(1, 2 ** max(1, frac // 2)))
            qcoef0 = int(rng.randint(-(2 ** frac), 2 ** frac))
        else:
            qgamma = int(rng.randint(1, 2 ** (bits - 1)))
            qcoef0 = int(rng.randint(-(2 ** (bits - 1)), 2 ** (bits - 1)))
        degree, dec_shift = 1 + rng.randint(0, 3), rng.randint(0, min(bits, 31))
        return fmt, out_fmt, qgamma, qcoef0, degree, dec_shift

    def svm_fleet_case(self, rng, bits, e, m, f, s, c, kind, regime,
                       slots=False):
        """E stacked SVMs, each its own formats, q(gamma), q(coef0) and
        degree, against the plain version; with ``slots``, each slot also
        against ``fxp_svm_model_cuda`` of that model alone."""
        K = self.K
        params = []
        for _ in range(e):  # each model its own formats and constants
            p = self._svm_params(rng, bits, regime)
            params.append((K.fxp.FxpFormat(bits, p[0].frac_bits),) + p[1:])
        params = tuple(params)
        x, sv, dual, icept = self._cuda(
            _ints(rng, (e, m, f), bits, regime),
            _ints(rng, (e, s, f), bits, regime),
            _ints(rng, (e, s, c), bits, "mid"),
            _ints(rng, (e, c), bits, "full"))
        got = K.model.fxp_svm_fleet_cuda(x, sv, dual, icept, kind, params)
        want = K.model.fxp_svm_fleet_plain(x, sv, dual, icept, kind, params)
        what = (f"w{bits} {kind} E={e} {m}x{f} S={s} C={c} q(gamma) "
                f"{[p[2] for p in params]} degrees {[p[4] for p in params]} "
                f"{regime}")
        self._compare("fxp_svm_fleet", got, want, what)
        if slots:
            for i, p in enumerate(params):
                solo = K.model.fxp_svm_model_cuda(x[i], sv[i], dual[i],
                                                  icept[i], kind, *p)
                self._compare("fxp_svm_fleet", got[i], solo,
                              f"{what}: slot {i} against fxp_svm_model")

    def svm_fleet_cases(self, rng, bits):
        """The fleet on the cluster body: E in SVM_FLEET_SIZES x S in
        SVM_LENGTHS x batches SVM_FLEET_BATCHES (D6 width where the plain
        version is cheap, D5 width elsewhere), poly and rbf in turn; and
        each slot of an E = 4 launch at path D's shape against the single
        model's kernel."""
        j = 0
        for e in SVM_FLEET_SIZES:
            for s in SVM_LENGTHS:
                for m in SVM_FLEET_BATCHES:
                    f = 561 if s <= N_PROTOTYPES and m <= 31 else 8
                    c = 6 if f == 561 else 10
                    self.svm_fleet_case(rng, bits, e, m, f, s, c,
                                        ("poly", "rbf")[j % 2],
                                        "full" if m == 31 else "mid")
                    j += 1
        for kind in ("poly", "rbf"):
            self.svm_fleet_case(rng, bits, 4, 3298, 8, N_PROTOTYPES, 10, kind,
                                "mid", slots=True)

    def layer_case(self, rng, bits, m, k, n, act, shift, frac, regime,
                   offset=0):
        """``offset`` rows dropped from the front of A: a row slice whose
        start is not 16-byte aligned.  Counts the cases whose int32 dot
        wrapped (first 64 rows, float64: exact at 8 and 16 bits) and the
        route each shape takes."""
        K, torch = self.K, self.torch
        fmt = K.fxp.FxpFormat(bits, frac)
        a, b, bias = self._cuda(
            _ints(rng, (m + offset, k), bits, regime),
            _ints(rng, (k, n), bits, regime),
            _ints(rng, (n,), bits, "full" if regime == "mid" else regime))
        a = a[offset:]
        got = K.layer.fxp_layer_cuda(a, b, bias, fmt, act, shift)
        want = K.layer.fxp_layer_plain(a, b, bias, fmt, act, shift)
        dot = a[:64].to(torch.float64) @ b.to(torch.float64)
        self.layer_wrapped += int(dot.abs().max() >= 2 ** 31)
        route = "narrow" if K.layer.narrow_plan(k, n) else "tile"
        self.layer_routes[route] += 1
        self._compare("fxp_layer", got, want,
                      f"w{bits} {m}x{k}x{n} {act} shift {shift} {regime} "
                      f"offset {offset} ({route})")

    def layer_narrow_cases(self, rng, bits):
        """fxp_layer around its narrow route: N in LAYER_NS x K in LAYER_KS
        at every activation (batches, regimes and shifts 0 / width - 1 in
        turn), row slices of A, and the largest K whose weights fit the
        narrow route beside the first K past it, at N 6 and 32."""
        acts = self.K.layer.LAYER_ACTIVATIONS
        regimes = ("mid", "full", "edge")
        i = 0
        for n in LAYER_NS:
            for k in LAYER_KS:
                for act in acts:
                    m = LAYER_BATCHES[i % len(LAYER_BATCHES)]
                    regime = regimes[i % len(regimes)]
                    shift = {"mid": _mid_shift(bits, k), "full": bits - 1,
                             "edge": 0}[regime]
                    frac = bits - 6 if regime == "mid" else bits - 1 - i % 2
                    self.layer_case(rng, bits, m, k, n, act, shift, frac,
                                    regime)
                    i += 1
        for k, n in ((561, 6), (300, 10), (8, 1), (561, 31)):
            for m, regime in ((3089, "mid"), (7, "full")):
                shift = _mid_shift(bits, k) if regime == "mid" else bits - 1
                frac = bits - 6 if regime == "mid" else bits - 1
                self.layer_case(rng, bits, m, k, n, acts[(k + m) % len(acts)],
                                shift, frac, regime, offset=1)
        for n in (6, 32):
            k_fit = max(k for k in range(1, 8192)
                        if self.K.layer.narrow_plan(k, n))
            for k in (k_fit, k_fit + 1):
                for m, regime in ((100, "mid"), (33, "full")):
                    shift = _mid_shift(bits, k) if regime == "mid" else 0
                    frac = bits - 6 if regime == "mid" else bits - 1
                    self.layer_case(rng, bits, m, k, n, "exact", shift, frac,
                                    regime)

    def model_case(self, rng, bits, m, dims, act, shifts, fracs, regime):
        K = self.K
        sched = tuple((s, K.fxp.FxpFormat(bits, f), a) for s, f, a in
                      zip(shifts, fracs, [act] * (len(dims) - 2) + ["none"]))
        x, = self._cuda(_ints(rng, (m, dims[0]), bits, regime))
        ws = self._cuda(*[_ints(rng, (i, o), bits, regime)
                          for i, o in zip(dims, dims[1:])])
        bs = self._cuda(*[_ints(rng, (o,), bits, "full") for o in dims[1:]])
        got = K.model.fxp_mlp_model_cuda(x, ws, bs, sched)
        want = K.model.fxp_mlp_model_plain(x, ws, bs, sched)
        self._compare("fxp_mlp_model", got, want,
                      f"w{bits} {m}x{dims} {act} shifts {shifts} {regime}")

    def qmatmul_case(self, rng, bits, m, k, n, regime, offset=0):
        """``offset`` rows dropped from the front of A (a row slice at any
        alignment).  Counts the cases whose int32 dot wrapped (first 64
        rows, float64)."""
        K, torch = self.K, self.torch
        frac = {"mid": bits - 6, "full": bits - 2, "edge": bits - 1}[regime]
        fmt = K.fxp.FxpFormat(bits, frac)
        a, b = self._cuda(_ints(rng, (m + offset, k), bits, regime),
                          _ints(rng, (k, n), bits, regime))
        a = a[offset:]
        got = K.qm.fxp_qmatmul_cuda(a, b, fmt)
        want = K.qm.fxp_qmatmul_plain(a, b, fmt)
        dot = a[:64].to(torch.float64) @ b.to(torch.float64)
        self.qmatmul_wrapped[bits] += int(dot.abs().max() >= 2 ** 31)
        self._compare("fxp_qmatmul", got, want,
                      f"w{bits} {m}x{k}x{n} m={frac} {regime} offset {offset}")

    def qmatmul_cases(self, rng, bits):
        """The tensor-core tile: M in BATCHES x K in QMATMUL_KS x N in
        QMATMUL_NS, the regimes in turn and all three at M 7, A a row slice
        every other case; a K past the point where one s32 partial of
        full-range 16-bit values would overflow (the accumulators wrap)."""
        regimes = ("mid", "full", "edge")
        i = 0
        for m in BATCHES:
            for k in QMATMUL_KS:
                for n in QMATMUL_NS:
                    for regime in (regimes if m == 7 else (regimes[i % 3],)):
                        self.qmatmul_case(rng, bits, m, k, n, regime,
                                          offset=i % 2)
                        i += 1
        self.qmatmul_case(rng, bits, 5, 40000, 9, "full")

    def tree_cases(self, tree, x_rows):
        """The tree on float rows with non-finite values and on every
        integer container (int32 rows in [2^24, 2^31) among them, where
        the cast rounds), with the node table in shared memory and, the
        budget lowered to 0 nodes, in device memory."""
        torch, fxp, te = self.torch, self.K.fxp, self.K.te
        rows = np.resize(x_rows, (max(BATCHES), x_rows.shape[1]))
        flt = torch.from_numpy(non_finite_rows(rows, tree)).cuda()
        finite = torch.from_numpy(rows).cuda()
        cases = [(tree, flt, "flt")]
        for fmt in (fxp.FxpFormat(8, 4), fxp.FXP16, fxp.FXP32,
                    fxp.FxpFormat(32, 28)):
            cases.append((tree.quantized(fmt), fxp.quantize(finite, fmt),
                          str(fmt)))
        rng = np.random.RandomState(7)
        big = (rng.randint(2 ** 24, 2 ** 31 - 1, rows.shape)
               * rng.choice([-1, 1], rows.shape)).astype(np.int32)
        cases.append((tree.quantized(fxp.FxpFormat(32, 28)),
                      torch.from_numpy(big).cuda(), "int32 in [2^24, 2^31)"))
        budget = te.TABLE_SMEM_NODES
        try:
            for route, limit in (("smem", budget), ("global", 0)):
                te.TABLE_SMEM_NODES = limit
                for t, x, what in cases:
                    if te.table_in_smem(t.n_nodes) != (route == "smem"):
                        raise AssertionError(f"tree table route: {route}")
                    for m in BATCHES:
                        self.tree_case(t, x[:m], f"{what} batch {m} {route}")
                        self.tree_routes[route] += 1
        finally:
            te.TABLE_SMEM_NODES = budget

    def svm_case(self, rng, bits, m, f, s, c, kind, regime):
        K, torch = self.K, self.torch
        x, sv, dual, icept = self._cuda(
            _ints(rng, (m, f), bits, regime), _ints(rng, (s, f), bits, regime),
            _ints(rng, (s, c), bits, "mid"), _ints(rng, (c,), bits, "full"))
        fmt, out_fmt, qgamma, qcoef0, degree, dec_shift = self._svm_params(
            rng, bits, regime)
        args = (x, sv, dual, icept, kind, fmt, out_fmt, qgamma, qcoef0, degree,
                dec_shift)
        got = K.model.fxp_svm_model_cuda(*args)
        want = K.model.fxp_svm_model_plain(*args)
        if m <= 64:
            dot = x[:1].to(torch.float64) @ sv.to(torch.float64).T
            self.wrapped += int(dot.abs().max() >= 2 ** 31)
        self._compare("fxp_svm_model", got, want,
                      f"w{bits} {kind} {m}x{f} S={s} C={c} degree {degree} "
                      f"q(gamma)={qgamma} q(coef0)={qcoef0} {regime}")

    def tree_case(self, tree, x, what):
        K = self.K
        got = K.te.tree_ensemble_cuda(tree, x)
        want = K.te.tree_ensemble_plain(tree, x)
        self._compare("tree_ensemble", got, want, what)

    def run(self, tree, x_rows):
        """Every case at the main paths' shapes, the new kernels' among
        them: the fleet kernels at E in {2, 8} and the PWL kernel on the
        (3089, 64) hidden layer."""
        rng = np.random.RandomState(0)
        acts = self.K.layer.LAYER_ACTIVATIONS
        shapes = ((561, 64), (64, 6), (561, 6))
        regimes = ("mid", "full", "edge")
        i = 0
        for bits in (8, 16, 32):
            # every activation x shape x regime at a ragged batch
            for act in acts:
                for k, n in shapes:
                    for regime in regimes:
                        shift = {"mid": _mid_shift(bits, k), "full": bits - 1,
                                 "edge": 0}[regime]
                        frac = bits - 6 if regime == "mid" else bits - 1 - i % 2
                        self.layer_case(rng, bits, 7, k, n, act, shift, frac,
                                        regime)
                        i += 1
            # every batch size at every shape
            for m in BATCHES:
                for k, n in shapes:
                    act = acts[i % len(acts)]
                    self.layer_case(rng, bits, m, k, n, act,
                                    _mid_shift(bits, k), bits - 6, "mid")
                    i += 1
            # the megakernel: every hidden activation x batch, and the edges
            for act in acts:
                for m in BATCHES:
                    shifts = (_mid_shift(bits, 561), _mid_shift(bits, 64))
                    self.model_case(rng, bits, m, (561, 64, 6), act, shifts,
                                    (bits - 6, bits - 6), "mid")
                for regime, shifts in (("full", (bits - 1, 0)),
                                       ("edge", (0, bits - 1))):
                    self.model_case(rng, bits, 64, (561, 64, 6), act, shifts,
                                    (bits - 1, 0), regime)
            # the SVM per-layer route's first stage on the tensor-core tile
            self.qmatmul_cases(rng, bits)
            # the SVM megakernel at the D6 and D5 shapes
            for f, c in ((561, 6), (8, 10)):
                for kind in ("poly", "rbf"):
                    for regime in regimes:
                        self.svm_case(rng, bits, 7, f, N_PROTOTYPES, c, kind,
                                      regime)
                    for m in BATCHES:
                        self.svm_case(rng, bits, m, f, N_PROTOTYPES, c, kind,
                                      "mid")
            # the megakernel's cluster split of the support vectors: one
            # vector to the fit predicate's limit, S not a multiple of
            # G x 64, ragged batches (D6 width where the plain version is
            # cheap, D5 width elsewhere)
            for kind in ("poly", "rbf"):
                for s in SVM_LENGTHS:
                    for m in SVM_BATCHES:
                        f = 561 if s <= N_PROTOTYPES and m <= 3089 else 8
                        self.svm_case(rng, bits, m, f, s, 6, kind,
                                      "full" if m == 31 else "mid")
            # the MLP megakernels' edges (tensor cores at 8 and 16 bits)
            self.mlp_cases(rng, bits)
            # fxp_layer's narrow route and its edges; the SVM fleet on the
            # cluster body
            self.layer_narrow_cases(rng, bits)
            # fxp_layer's wide route (the tile shared with fxp_qmatmul) on
            # a row slice of A that is not 16-byte aligned
            for j, m in enumerate((7, 3089, 65536)):
                regime = ("mid", "full", "edge")[j]
                shift = {"mid": _mid_shift(bits, 561), "full": bits - 1,
                         "edge": 0}[regime]
                self.layer_case(rng, bits, m, 561, 64, acts[j + 1], shift,
                                bits - 6 if regime == "mid" else bits - 1,
                                regime, offset=1 + j)
            self.svm_fleet_cases(rng, bits)
            # the fleet kernels: E in {2, 8}, uniform and per-model
            # schedules, ragged and full batches, int32-wrapping sums
            for e in (2, 8):
                for hetero in (False, True):
                    for m in (7, 3089):
                        self.mlp_fleet_case(rng, bits, e, m, hetero, "mid")
            self.mlp_fleet_case(rng, bits, 2, 64, True, "edge")
            for kind in ("poly", "rbf"):
                self.svm_fleet_case(rng, bits, 2, 7, 561, N_PROTOTYPES, 6,
                                    kind, "mid")
                self.svm_fleet_case(rng, bits, 4, 3298, 8, N_PROTOTYPES, 10,
                                    kind, "mid")
                self.svm_fleet_case(rng, bits, 2, 33, 8, N_PROTOTYPES, 10,
                                    kind, "edge")
        if not self.wrapped:
            raise AssertionError("no SVM case wrapped the int32 dot")
        if not self.mlp_wrapped:
            raise AssertionError("no MLP case wrapped the int32 dot")
        if not self.layer_wrapped:
            raise AssertionError("no fxp_layer case wrapped the int32 dot")
        if not (self.qmatmul_wrapped[16] and self.qmatmul_wrapped[32]):
            raise AssertionError(f"fxp_qmatmul cases that wrapped the int32 "
                                 f"dot, by width: {self.qmatmul_wrapped}")
        self.pwl_cases(rng)
        # the tree on float rows with non-finite values and on containers
        self.tree_cases(tree, x_rows)
        # flash_attention: float32 and bf16, causal and full, every head
        # dim, ragged and tile-aligned S, one head and the LM's 56
        torch = self.torch
        self.K.common.require_full_float32(torch.device("cuda", 0))
        gen = torch.Generator(device="cuda").manual_seed(0)
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                for dh in self.K.fa.HEAD_DIMS:
                    for s in FLASH_LENGTHS:
                        for bh, group in FLASH_HEADS:
                            self.flash_case(gen, dtype, causal, dh, s, bh,
                                            group)
        # head dims between the instances (zero-padded), and float16 (the
        # float32 instance, rounded once), at the grouped LM shape
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            dims = FLASH_PADDED_DIMS + ((64,) if dtype == torch.float16
                                        else ())
            for dh in dims:
                for s in (7, 65, 2048):
                    for causal in (True, False):
                        self.flash_case(gen, dtype, causal, dh, s, 56, 7)
        # sliding windows (zamba2's shared block), causal and not
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                for s in FLASH_WINDOW_LENGTHS:
                    for window in (1, 63, 64, 65, s - 1, s, s + 1):
                        for dh, bh, group in FLASH_WINDOW_HEADS:
                            self.flash_case(gen, dtype, causal, dh, s, bh,
                                            group, window)
        self.flash_controls(gen)
        log(f"phase 3: {self.cases} kernel-vs-plain cases, bit-exact but "
            f"flash_attention (within 2e-5 in float32, {FLASH_BF16_ATOL} in "
            f"bf16: max abs err {self.flash_err}; bf16 rows within "
            f"{FLASH_BF16_ROW_RTOL} of their largest value: max "
            f"{self.flash_row_rel:.4e}; {self.flash_window_cases} of them "
            f"with a sliding window) (max abs err {self.max_abs_err}; "
            f"{self.wrapped} SVM cases, {self.mlp_wrapped} MLP cases and "
            f"{self.layer_wrapped} fxp_layer cases wrapped the int32 dot; "
            f"fxp_layer routes {self.layer_routes}; fxp_qmatmul cases that "
            f"wrapped the int32 dot by width {self.qmatmul_wrapped}; "
            f"tree_ensemble table routes {self.tree_routes}; "
            f"pwl_activation cases with the fused bias "
            f"{self.pwl_bias_cases})")


# --------------------------------------------------------------------------
# phase 3T: the block-size tuner
# --------------------------------------------------------------------------
# E of the timed fleets: path D's 8 MLPs and 4 SVMs; its SVM fleet's batch
TUNE_MLP_FLEET, TUNE_SVM_FLEET, TUNE_SVM_FLEET_M = 8, 4, 3298
# the K of each of two processes' fxp_qmatmul lookups into one file
TUNE_PROCS = ((100, 101, 102), (200, 201, 202))
TUNE_PROC_SCRIPT = """
import sys, torch
sys.path.insert(0, {src!r})
from repro_torch.core.fixedpoint import FxpFormat
from repro_torch.kernels import ops, tune
dev, fmt = torch.device("cuda"), FxpFormat(16, 10)
for k in {ks!r}:
    a = torch.ones((1000, k), dtype=torch.int16, device=dev)
    b = torch.ones((k, 300), dtype=torch.int16, device=dev)
    ops.fxp_qmatmul(a, b, fmt)
torch.cuda.synchronize()
print("sweep launches", tune.sweep_launches)
"""


@dataclasses.dataclass
class TuneCase:
    """One tuned kernel at one shape: its real input, the launch of a
    blocking with ``count=False`` (on ``x`` or the tuner's zeros), the plain
    version, the ops wrapper (the tuner's lookup on the card), the tuner's
    own lookup with a given runner, and the candidates (today's first)."""
    name: str
    label: str
    x: object
    launch: object  # (x, blocking) -> tensor
    plain: object  # x -> tensor
    wrapper: object  # x -> tensor, through ops
    lookup: object  # runner -> blocking
    cands: list
    zshape: tuple


def tune_cases(torch, K, bits, m, rng, mlp_dims=(561, 64, 6), fleet_m=None):
    """The seven tuned kernels (fxp_layer on both routes) at ``m`` rows of
    their main paths' shapes in the ``bits`` container: fxp_qmatmul at the
    SVM per-layer route's (m, 561) x (561, 300), fxp_layer's wide route at
    the per-layer MLP's 561 x 64 and its narrow route at the logistic head's
    561 x 6, fxp_mlp_model at ``mlp_dims``, fxp_svm_model at D6's rbf (561,
    300, 6), fxp_mlp_fleet at path D's 8 MLPs (schedules of their own) and
    fxp_svm_fleet at its 4 D5 rbf SVMs (8, 300, 10), at ``fleet_m`` rows if
    given."""
    T, dev = K.tune, torch.device("cuda")
    fmt = K.fxp.FxpFormat(bits, bits - 6)
    mb = T.batch_bucket(m, cap=1 << 30)
    cuda = lambda *a: [torch.from_numpy(v).to(dev) for v in a]  # noqa: E731
    x, sv_t, w64, b64 = cuda(_ints(rng, (m, 561), bits, "mid"),
                             _ints(rng, (561, 300), bits, "mid"),
                             _ints(rng, (561, 64), bits, "mid"),
                             _ints(rng, (64,), bits, "full"))
    w6, b6 = w64[:, :6].contiguous(), b64[:6].contiguous()
    cases = []

    def matmul(name, label, kind, b, run, plain, wrap, occ=None):
        n = int(b.shape[1])
        cases.append(TuneCase(
            name, label, x, run, plain, wrap,
            lambda r: T.matmul_blocks(kind, m, 561, n, bits, r, occupancy=occ,
                                      device=dev),
            T.candidates(kind, mb, 561, n, bits, occ), (mb, 561)))

    matmul("fxp_qmatmul", "(m, 561) x (561, 300)", "qmatmul", sv_t,
           lambda z, blk: K.qm.fxp_qmatmul_cuda(z, sv_t, fmt, blk,
                                                count=False),
           lambda z: K.qm.fxp_qmatmul_plain(z, sv_t, fmt),
           lambda z: K.ops.fxp_qmatmul(z, sv_t, fmt))
    matmul("fxp_layer", "wide (m, 561) x (561, 64) exact", "layer", w64,
           lambda z, blk: K.layer.fxp_layer_cuda(z, w64, b64, fmt, "exact",
                                                 None, blk, count=False),
           lambda z: K.layer.fxp_layer_plain(z, w64, b64, fmt, "exact"),
           lambda z: K.ops.fxp_layer(z, w64, b64, fmt, "exact"))
    matmul("fxp_layer", "narrow (m, 561) x (561, 6)", "layer", w6,
           lambda z, blk: K.layer.fxp_layer_cuda(z, w6, b6, fmt, "none",
                                                 None, blk, count=False),
           lambda z: K.layer.fxp_layer_plain(z, w6, b6, fmt, "none"),
           lambda z: K.ops.fxp_layer(z, w6, b6, fmt, "none"),
           occ=K.layer.narrow_occupancy(561, 6, bits, dev))

    dims = tuple(mlp_dims)
    xm = x if dims[0] == 561 else x[:, :dims[0]].contiguous()
    ws = cuda(*[_ints(rng, (k, n), bits, "mid")
                for k, n in zip(dims, dims[1:])])
    bs = cuda(*[_ints(rng, (n,), bits, "full") for n in dims[1:]])
    sched = tuple((_mid_shift(bits, k), fmt, act)
                  for k, act in zip(dims, ("exact",) * (len(dims) - 2)
                                    + ("none",)))
    cases.append(TuneCase(
        "fxp_mlp_model", f"{'->'.join(map(str, dims))}", xm,
        lambda z, bm: K.model.fxp_mlp_model_cuda(z, ws, bs, sched, bm,
                                                 count=False),
        lambda z: K.model.fxp_mlp_model_plain(z, ws, bs, sched),
        lambda z: K.ops.fxp_mlp_model(z, ws, bs, sched),
        lambda r: T.model_block_m("mlp", m, dims, bits, runner=r, device=dev),
        T.model_candidates("mlp", dims, bits), (mb, dims[0])))

    sv, dual = cuda(_ints(rng, (300, 561), bits, "mid"),
                    _ints(rng, (300, 6), bits, "mid"))
    qgamma = int(rng.randint(1, 2 ** ((bits - 6) // 2)))
    svm = (sv, dual, b6, "rbf", fmt, K.fxp.FxpFormat(bits, bits // 2),
           qgamma, 1, 2, bits // 2)
    cases.append(TuneCase(
        "fxp_svm_model", "rbf (m, 561), S 300, C 6", x,
        lambda z, bm: K.model.fxp_svm_model_cuda(z, *svm, bm=bm, count=False),
        lambda z: K.model.fxp_svm_model_plain(z, *svm),
        lambda z: K.ops.fxp_svm_model(z, *svm),
        lambda r: T.model_block_m("svm-rbf", m, (561, 300, 6), bits,
                                  runner=r, device=dev),
        T.model_candidates("svm-rbf", (561, 300, 6), bits), (mb, 561)))

    e = TUNE_MLP_FLEET
    xe = torch.stack([xm.roll(i, 0) for i in range(e)])
    wse = [torch.stack([w.roll(i, 0) for i in range(e)]) for w in ws]
    bse = [torch.stack([b.roll(i, 0) for i in range(e)]) for b in bs]
    scheds = tuple(tuple((s + i % 2, f, a) for s, f, a in sched)
                   for i in range(e))
    cases.append(TuneCase(
        "fxp_mlp_fleet", f"{e} x {'->'.join(map(str, dims))}", xe,
        lambda z, blk: K.model.fxp_mlp_fleet_cuda(z, wse, bse, scheds,
                                                  blk[1], count=False),
        lambda z: K.model.fxp_mlp_fleet_plain(z, wse, bse, scheds),
        lambda z: K.ops.fxp_mlp_fleet(z, wse, bse, scheds),
        lambda r: T.fleet_blocks("mlp", e, m, dims, bits, uniform=False,
                                 runner=r, device=dev),
        [(1, bm) for bm in T.model_candidates("mlp", dims, bits)],
        (e, mb, dims[0])))

    # names of its own: the lambdas above read e, m and mb when called
    es, ms = TUNE_SVM_FLEET, fleet_m or m
    mbs = T.batch_bucket(ms, cap=1 << 30)
    qe, sve, de, ie = cuda(_ints(rng, (es, ms, 8), bits, "mid"),
                           _ints(rng, (es, 300, 8), bits, "mid"),
                           _ints(rng, (es, 300, 10), bits, "mid"),
                           _ints(rng, (es, 10), bits, "full"))
    params = tuple((fmt, K.fxp.FxpFormat(bits, bits // 2 - i), qgamma + i, i,
                    2, bits // 2) for i in range(es))
    cases.append(TuneCase(
        "fxp_svm_fleet", f"{es} x rbf (m, 8), S 300, C 10", qe,
        lambda z, blk: K.model.fxp_svm_fleet_cuda(z, sve, de, ie, "rbf",
                                                  params, blk[1],
                                                  count=False),
        lambda z: K.model.fxp_svm_fleet_plain(z, sve, de, ie, "rbf", params),
        lambda z: K.ops.fxp_svm_fleet(z, sve, de, ie, "rbf", params),
        lambda r: T.fleet_blocks("svm-rbf", es, ms, (8, 300, 10), bits,
                                 uniform=False, runner=r, device=dev),
        [(1, bm) for bm in T.model_candidates("svm-rbf", (8, 300, 10),
                                              bits)],
        (es, mbs, 8)))
    return cases


def _blk(b):
    return list(b) if isinstance(b, tuple) else [b]


def tune_sweep(torch, K, check, case, m):
    """The tuner's own lookup of ``case`` at ``m`` rows with a runner that
    keeps each candidate's CUDA-event time (ms, best of 3), then every
    candidate against the plain version bit for bit.  Returns (chosen,
    {candidate: ms})."""
    T, dev = K.tune, torch.device("cuda")
    times = {}
    base = K.ops._timed_runner(dev, case.zshape, case.x.dtype, case.launch)

    def runner(blk):
        times[blk] = base(blk)
        return times[blk]

    n0 = T.sweep_launches
    chosen = case.lookup(runner)
    if sorted(times) != sorted(case.cands):
        raise AssertionError(f"tuner {case.name} {case.label} m {m}: swept "
                             f"{sorted(times)}, candidates {case.cands}")
    if T.sweep_launches - n0 != 4 * len(times):
        raise AssertionError(f"tuner {case.name}: {T.sweep_launches - n0} "
                             f"sweep launches for {len(times)} candidates")
    if chosen not in times:
        raise AssertionError(f"tuner {case.name}: chose {chosen}, not a "
                             f"candidate")
    want = case.plain(case.x)
    for blk in case.cands:
        check._compare(case.name, case.launch(case.x, blk), want,
                       f"tuned {blk} {case.label} m {m}")
    return chosen, times


def tuner_phase(torch, K, check):
    """Phase 3T (see the module docstring)."""
    T = K.tune
    t0 = time.perf_counter()
    log(f"phase 3T: the block-size tuner, cache {T.cache_path()} (fresh); "
        f"candidate CUDA-event ms, best of 3 after a warm launch; * today's, "
        f"> chosen")
    rng = np.random.RandomState(31)
    results, timed = {}, []
    for m in TIMED_BATCHES:
        fleet_m = TUNE_SVM_FLEET_M if m == TIMED_BATCHES[-2] else m
        for case in tune_cases(torch, K, 16, m, rng, fleet_m=fleet_m):
            mm = fleet_m if case.name == "fxp_svm_fleet" else m
            chosen, times = tune_sweep(torch, K, check, case, mm)
            today = case.cands[0]
            log(f"  tune {case.name:13s} fxp16 {case.label:32s} m {mm:6d}: "
                + ", ".join(f"{'*' if b == today else ''}"
                            f"{'>' if b == chosen else ''}{_blk(b)} "
                            f"{times[b]:.4f}" for b in case.cands)
                + f"; chosen/today {times[chosen] / times[today]:.3f}")
            results.setdefault((case.name, case.label), {})[mm] = (
                chosen, times[chosen], today, times[today])
            timed.append((case, mm))
    for bits in (8, 32):  # every candidate at the other widths, untimed
        for m in (65, 3089):
            for dims in ((561, 64, 6),) + (((200, 64, 6),) if bits == 32
                                           else ()):
                for case in tune_cases(torch, K, bits, m, rng, dims):
                    want = case.plain(case.x)
                    for blk in case.cands:
                        check._compare(case.name, case.launch(case.x, blk),
                                       want, f"w{bits} tuned {blk} "
                                       f"{case.label} m {m}")
    log(f"  every candidate bit for bit against its plain version at 8, 16 "
        f"and 32 bits; {T.sweep_launches} sweep launches, "
        f"{T.sweep_seconds:.2f} s of sweeps")

    # persistence: the same lookups from the file, through the ops wrappers
    keys = set(T.cache_snapshot())
    T.clear_memory_cache()
    n0 = T.sweep_launches
    for case, m in timed:
        check._compare(case.name, case.wrapper(case.x), case.plain(case.x),
                       f"from the file {case.label} m {m}")
    if T.sweep_launches != n0:
        raise AssertionError(f"tuner: {T.sweep_launches - n0} sweep launches "
                             f"after clear_memory_cache for keys not in the "
                             f"file: {sorted(set(T.cache_snapshot()) - keys)}")
    log(f"  clear_memory_cache, then {len(timed)} lookups through the ops "
        f"wrappers: answered from the file, no sweep launch, outputs equal "
        f"to the plain versions")
    tune_two_processes(K)
    tune_pretune(torch, K)
    log(f"phase 3T took {time.perf_counter() - t0:.1f} s")
    return results


def tune_two_processes(K):
    """Two processes tune different shapes into the one file at once."""
    T = K.tune
    before = set(T.cache_snapshot())
    procs = [subprocess.Popen(
        [sys.executable, "-c", TUNE_PROC_SCRIPT.format(
            src=os.path.join(ROOT, "src"), ks=ks)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for ks in TUNE_PROCS]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        if p.returncode != 0:
            raise AssertionError(f"tuner process failed:\n{out}")
    with open(T.cache_path()) as f:
        raw = json.load(f)
    dev = T.device_key()
    want = {f"qmatmul|1024x{k}x300|w16|{dev}" for ks in TUNE_PROCS for k in ks}
    missing = (want | before) - set(raw)
    if missing:
        raise AssertionError(f"tuner: the file lost {sorted(missing)}")
    T.clear_memory_cache()

    def no_sweep(blk):
        raise AssertionError(f"tuner: swept {blk} for a key in the file")

    for ks in TUNE_PROCS:
        for k in ks:  # each answered from the file, or the runner raises
            T.matmul_blocks("qmatmul", 1000, k, 300, 16, no_sweep)
    log(f"  two processes tuning {len(want)} fxp_qmatmul shapes into the file "
        f"at once: every key of both and all {len(before)} earlier keys "
        f"persist ({len(raw)} keys)")


def tune_pretune(torch, K):
    """``pretune`` fills one key a bucket for each kernel the artifact
    dispatches; predicts in those buckets then make no sweep launch."""
    T = K.tune
    rng = np.random.RandomState(5)
    x = (rng.randn(3089, 561) * 2).astype(np.float32)
    models = {"model-mlp": K.models.init_mlp([561, 64, 6], seed=7),
              "layer": K.models.LogisticModel(
                  (rng.randn(561, 6) * 0.05).astype(np.float32),
                  np.zeros(6, np.float32))}
    ladder = LADDER + (4096,)
    for kind, model in models.items():
        target = K.tc.Target(backend="cuda", number_format="fxp32")
        art = K.tc.compile(model, target)
        before = set(T.cache_snapshot())
        n0 = T.sweep_launches
        art.pretune(x[:1], batches=ladder)
        keys = set(T.cache_snapshot()) - before
        if len(keys) != len(ladder) or not all(
                k.startswith(kind + "|") and "|w32|" in k for k in keys):
            raise AssertionError(f"pretune of {kind}: keys {sorted(keys)}")
        swept = T.sweep_launches - n0
        host = K.tc.compile(model, target, device="cpu")
        n0 = T.sweep_launches
        for m in (1, 3, 17, 50, 64, 3089):
            if not (art.predict(x[:m]) == host.predict(x[:m])).all():
                raise AssertionError(f"pretuned {kind}: labels differ at {m}")
        if T.sweep_launches != n0:
            raise AssertionError(f"pretuned {kind}: {T.sweep_launches - n0} "
                                 f"sweep launches in live predicts")
        log(f"  pretune {kind} fxp32 over {ladder}: {len(keys)} keys, "
            f"{swept} sweep launches; predicts of 1-3089 rows then sweep "
            f"nothing, labels equal to the host's")


# --------------------------------------------------------------------------
# phase 4: the main paths
# --------------------------------------------------------------------------
def plain_labels(torch, K, art, model, x):
    """The artifact's frozen program run through the plain versions on the
    card: quantize with the artifact's input format, then the plain kernel
    (float trees: the plain tree kernel on the rows as they are)."""
    xt = torch.from_numpy(x).cuda()
    spec = art.extras.get("emit_spec")
    if spec is None:  # flt tree
        return K.te.tree_ensemble_plain(model.tree, xt).cpu().numpy()
    family = spec["family"]
    if family == "tree":
        tree = K.trees.TreeArrays(
            spec["feature"], spec["threshold"], spec["left"], spec["right"],
            spec["leaf_class"], spec["max_depth"], model.tree.n_classes,
            model.tree.n_features)
        qx = K.fxp.quantize(xt, spec["in_fmt"])
        return K.te.tree_ensemble_plain(tree, qx).cpu().numpy()
    if family == "svm":
        qx = K.fxp.quantize(xt, spec["fmt"])
        sv, dual, b = (torch.from_numpy(spec[k]).cuda()
                       for k in ("sv", "dual", "b"))
        out = K.model.fxp_svm_model_plain(
            qx, sv, dual, b, spec["kernel"], spec["fmt"], spec["out_fmt"],
            spec["qgamma"], spec["qcoef0"], spec["degree"], spec["dec_shift"])
    elif family == "mlp":
        qx = K.fxp.quantize(xt, spec["in_fmt"])
        sched = tuple(zip(spec["shifts"], spec["out_fmts"], spec["acts"]))
        out = K.model.fxp_mlp_model_plain(
            qx, [torch.from_numpy(w).cuda() for w in spec["ws"]],
            [torch.from_numpy(b).cuda() for b in spec["bs"]], sched)
    else:
        qx = K.fxp.quantize(xt, spec["in_fmt"])
        out = K.layer.fxp_layer_plain(qx, torch.from_numpy(spec["w"]).cuda(),
                                      torch.from_numpy(spec["b"]).cuda(),
                                      spec["out_fmt"], "none", spec["shift"])
    return K.common.argmax_first(out).cpu().numpy()


def check_artifact(torch, K, art, model, x_test, n_classes, one, what):
    """predict on the test split and the batch ladder with ``one`` launches
    each; labels well-formed, stable across batches, equal to the plain
    versions'.  Returns the labels."""
    before = launch_counts(K)
    labels = art.predict(x_test)
    expect_launches(K, before, one, f"{what} predict")
    if labels.shape != (len(x_test),) or labels.dtype != np.int32:
        raise AssertionError(f"{what}: labels {labels.dtype}{labels.shape}")
    if labels.min() < 0 or labels.max() >= n_classes:
        raise AssertionError(f"{what}: label out of range")
    for b in LADDER:
        before = launch_counts(K)
        lab = art.predict(x_test[:b])
        expect_launches(K, before, one, f"{what} batch {b}")
        if not np.array_equal(lab, labels[:b]):
            raise AssertionError(f"{what}: batch {b} labels differ from the "
                                 f"full batch")
    if art.target.is_quantized or art.kind == "tree":
        plain = plain_labels(torch, K, art, model, x_test)
        if not np.array_equal(labels, plain):
            raise AssertionError(f"{what}: {int((labels != plain).sum())} "
                                 f"labels differ from the plain versions")
    return labels


def compile_per_layer(K, model, target, cal):
    os.environ["REPRO_MEGAKERNEL_VMEM"] = "0"
    try:
        art = K.tc.compile(model, target, calibration=cal)
    finally:
        del os.environ["REPRO_MEGAKERNEL_VMEM"]
    if art.kernel_strategy != "per-layer":
        raise AssertionError(f"forced route {art.kernel_strategy}")
    return art


def _ref_diff(K, model, kw, cal, x, labels):
    ref = K.tc.compile(model, K.tc.Target(backend="ref", **kw),
                       calibration=cal)
    return int((ref.predict(x) != labels).sum())


def main_path_mlp(torch, K, ds):
    """Main path A: the fixed-point MLP and logistic models on D6."""
    x_test, x_cal = ds.x_test, ds.x_train[:N_CALIBRATION]
    mlp = K.models.init_mlp([561, 64, 6], seed=0)
    rng = np.random.RandomState(0)
    logistic = K.models.LogisticModel(
        coef=(rng.randn(561, 6) * np.sqrt(2.0 / (561 + 6))).astype(np.float32),
        intercept=np.zeros(6, np.float32))
    arts, mlp_labels = {}, {}
    reset_launches(K)
    t0 = time.perf_counter()
    for tag, kw in TAGS.items():
        cal = x_cal if kw["number_format"].startswith("auto") else None
        for kind, m in (("mlp", mlp), ("logistic", logistic)):
            art = K.tc.compile(m, K.tc.Target(backend="cuda", **kw),
                               calibration=cal)
            arts[(kind, tag)] = art
            if kind == "mlp" and art.kernel_strategy != "megakernel":
                raise AssertionError(f"D6 mlp {tag} routed "
                                     f"{art.kernel_strategy}, not megakernel")
            one = {"fxp_mlp_model": 1} if kind == "mlp" else {"fxp_layer": 1}
            labels = check_artifact(torch, K, art, m, x_test, ds.n_classes,
                                    one, f"{kind} {tag}")
            if kind == "mlp":
                mlp_labels[tag] = labels
            diff = _ref_diff(K, m, kw, cal, x_test, labels)
            log(f"  {kind:8s} {tag:10s} labels {np.bincount(labels, minlength=6)}"
                f" == plain; rows differing ref vs cuda (int64 vs int32 "
                f"accumulator, information): {diff}")
        # the forced per-layer route: same labels, two fxp_layer launches
        per = compile_per_layer(K, mlp, K.tc.Target(backend="cuda", **kw), cal)
        before = launch_counts(K)
        if not np.array_equal(per.predict(x_test), mlp_labels[tag]):
            raise AssertionError(f"mlp {tag}: per-layer labels differ")
        expect_launches(K, before, {"fxp_layer": 2}, f"mlp {tag} per-layer")
    # flt: full float32 matmuls (PyTorch's default; the float predicts
    # refuse TF32), labels against float64 numpy
    for kind, m in (("mlp", mlp), ("logistic", logistic)):
        art = K.tc.compile(m, K.tc.Target(number_format="flt", backend="cuda"))
        check_flt(art.predict(x_test), _float64_logits(m, x_test),
                  f"{kind:8s} flt       ")
    launches = launch_counts(K)
    log(f"phase 4A: MLP/logistic path in {time.perf_counter() - t0:.1f} s; "
        f"kernel launches {launches}")
    for name in ("fxp_layer", "fxp_mlp_model"):
        if launches[name] == 0:
            raise AssertionError(f"main path A never launched {name}")
    return arts, launches


def check_flt(labels, logits, what):
    top2 = np.sort(logits, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) >= 1e-4
    if not np.array_equal(labels[decided], logits.argmax(1)[decided]):
        raise AssertionError(f"flt {what}: labels differ from float64")
    log(f"  {what} labels match float64 on "
        f"{int(decided.sum())}/{len(labels)} rows with top-2 gap >= 1e-4")


def _float64_logits(m, x):
    h = np.asarray(x, np.float64)
    if not hasattr(m, "weights"):  # logistic, svm-linear
        return h @ m.coef + m.intercept
    for i, (w, b) in enumerate(zip(m.weights, m.biases)):
        h = h @ w + b
        if i < len(m.weights) - 1:
            h = 1.0 / (1.0 + np.exp(-h))
    return h


def kernel_features(kind, x, sv, gamma, coef0, degree):
    dot = x @ sv.T
    if kind == "poly":
        return (gamma * dot + coef0) ** degree
    d2 = (x * x).sum(1)[:, None] - 2 * dot + (sv * sv).sum(1)[None, :]
    return np.exp(-gamma * d2)


def build_svms(K, ds, kinds):
    """SVM models of ``kinds`` on ``ds``: least-squares readouts (float64,
    one-hot targets) on the first N_FIT_ROWS train rows, of the raw
    features (linear) or of the kernel features of N_PROTOTYPES
    class-stratified prototypes with gamma = 1/(F var(x)) (sklearn's
    'scale'), coef0 1.0, degree 2.  No SVM trainer is ported yet."""
    x64 = ds.x_train.astype(np.float64)
    xf, yf = x64[:N_FIT_ROWS], ds.y_train[:N_FIT_ROWS]
    onehot = np.eye(ds.n_classes)[yf]

    def lstsq(h):
        sol = np.linalg.lstsq(np.c_[h, np.ones(len(h))], onehot, rcond=None)[0]
        return sol[:-1], sol[-1]

    gamma = 1.0 / (x64.shape[1] * max(x64.var(), 1e-12))
    sv = K.pick_prototypes(x64, ds.y_train, ds.n_classes, N_PROTOTYPES,
                               seed=0)
    out = {}
    for kind in kinds:
        if kind == "linear":
            coef, icept = lstsq(xf)
            out[kind] = K.models.SVMModel(
                "linear", coef=coef.astype(np.float32),
                intercept=icept.astype(np.float32), dtype="float32")
        else:
            dual, icept = lstsq(kernel_features(kind, xf, sv, gamma, 1.0, 2))
            out[kind] = K.models.SVMModel(kind, support_vectors=sv,
                                          dual_coef=dual, intercept=icept,
                                          gamma=gamma, coef0=1.0, degree=2)
    return out


def main_path_tree_svm(torch, K, d6, d5, tree_model):
    """Main path B: the D6 tree and SVMs, and the D5 kernel SVMs."""
    s6, s5 = build_svms(K, d6, ("linear", "poly", "rbf")), \
        build_svms(K, d5, ("poly", "rbf"))
    entries = [("tree", "D6", tree_model, TREE_TAGS, d6),
               ("svm-linear", "D6", s6["linear"], TREE_TAGS, d6),
               ("svm-poly", "D6", s6["poly"], SVM_TAGS, d6),
               ("svm-rbf", "D6", s6["rbf"], SVM_TAGS, d6),
               ("svm-poly", "D5", s5["poly"], SVM_TAGS, d5),
               ("svm-rbf", "D5", s5["rbf"], SVM_TAGS, d5)]
    arts = {}
    reset_launches(K)
    t0 = time.perf_counter()
    for kind, dname, model, tags, ds in entries:
        x_test, x_cal = ds.x_test, ds.x_train[:N_CALIBRATION]
        for tag in tags:
            kw = TAGS.get(tag, dict(number_format=tag))
            cal = x_cal if kw["number_format"].startswith("auto") else None
            art = K.tc.compile(model, K.tc.Target(backend="cuda", **kw),
                               calibration=cal)
            arts[(kind, dname, tag)] = art
            what = f"{dname} {kind} {tag}"
            if kind == "tree":
                one = {"tree_ensemble": 1}
            elif kind == "svm-linear":
                one = {"fxp_layer": 1} if tag != "flt" else {}
            else:
                one = {"fxp_svm_model": 1}
                if art.kernel_strategy != "megakernel":
                    raise AssertionError(f"{what} routed "
                                         f"{art.kernel_strategy}")
            labels = check_artifact(torch, K, art, model, x_test,
                                    ds.n_classes, one, what)
            if kind == "svm-linear" and tag == "flt":
                check_flt(labels, _float64_logits(model, x_test), what)
            diff = _ref_diff(K, model, kw, cal, x_test, labels)
            extra = ""
            if kind in ("svm-poly", "svm-rbf"):
                spec = art.extras["emit_spec"]
                extra = (f" q(gamma)={spec['qgamma']} "
                         f"q(coef0)={spec['qcoef0']} in {spec['fmt']}")
                per = compile_per_layer(
                    K, model, K.tc.Target(backend="cuda", **kw), cal)
                before = launch_counts(K)
                if not np.array_equal(per.predict(x_test), labels):
                    raise AssertionError(f"{what}: per-layer labels differ")
                expect_launches(K, before, {"fxp_qmatmul": 1, "fxp_layer": 1},
                                f"{what} per-layer")
            hist = np.bincount(labels, minlength=ds.n_classes)
            constant = " (constant)" if (hist > 0).sum() == 1 else ""
            log(f"  {dname} {kind:10s} {tag:10s} labels {hist}{constant} == "
                f"plain;{extra} rows differing ref vs cuda (information): "
                f"{diff}")
    launches = launch_counts(K)
    log(f"phase 4B: tree/SVM path in {time.perf_counter() - t0:.1f} s; "
        f"kernel launches {launches}")
    for name in ("fxp_layer", "fxp_qmatmul", "fxp_svm_model", "tree_ensemble"):
        if launches[name] == 0:
            raise AssertionError(f"main path B never launched {name}")
    return arts, launches


def emit_c_phase(K, arts_a, arts_b, d6, d5):
    """Phase 4F: C emission.  Every quantized artifact of paths A and B
    emits its freestanding fixed-point C (the paper's deliverable), built
    by the host's C compiler (``-std=c99 -ffreestanding -Werror``, and a
    hosted replay binary), the builds in parallel; the binary replays the
    test rows (quantized on the host) and must give the artifact's ``cuda``
    labels on every row.  Prints the measured sections beside the
    artifact's flash and SRAM model (the paper's Tables IV-VI).  Nothing of
    it runs on the card."""
    from concurrent.futures import ThreadPoolExecutor

    E = K.emit
    cc = E.find_cc()
    if cc is None:
        raise AssertionError("phase 4F: no C compiler (cc, gcc, clang) on "
                             "this host")
    jobs = [(f"D6 {kind} {tag}", art, d6)
            for (kind, tag), art in arts_a.items()]
    jobs += [(f"{dname} {kind} {tag}", art, d6 if dname == "D6" else d5)
             for (kind, dname, tag), art in arts_b.items()
             if art.target.is_quantized]

    def build_and_replay(job):
        what, art, ds = job
        t0 = time.perf_counter()
        src = art.emit_c()
        with E.CRunner(src, E.input_format(E.spec_of(art)), cc=cc) as run:
            labels, _ = run.predict(ds.x_test)
            return labels, run.sizes(), len(src), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        results = list(pool.map(build_and_replay, jobs))
    t_build = time.perf_counter() - t0
    log(f"phase 4F: C emission of {len(jobs)} quantized artifacts of paths "
        f"A and B with {cc}: emitted, built and replayed in {t_build:.1f} s")
    log(f"  {'artifact':26s} {'C chars':>8s} {'text':>7s} {'rodata':>8s} "
        f"{'data':>5s} {'bss':>6s} {'flash':>8s} {'model flash':>11s} "
        f"{'model sram':>10s}")
    for (what, art, ds), (labels, sec, n_chars, _) in zip(jobs, results):
        want = art.predict(ds.x_test)
        if not np.array_equal(labels, want):
            raise AssertionError(f"phase 4F {what}: the compiled C gives "
                                 f"{int((labels != want).sum())} labels "
                                 f"other than the cuda artifact's")
        mem = art.memory_report()
        log(f"  {what:26s} {n_chars:8d} {sec['text']:7d} {sec['rodata']:8d} "
            f"{sec['data']:5d} {sec['bss']:6d} {sec['flash']:8d} "
            f"{mem['flash']:11d} {mem['sram']:10d}")
    log(f"  every C label equals the cuda artifact's on all "
        f"{sum(len(ds.x_test) for _, _, ds in jobs)} test rows")


def _np_pwl(variant, h):
    """The float PWL sigmoids in float64 numpy (the flt yardstick)."""
    if variant == "pwl2":
        return np.clip(0.25 * h + 0.5, 0.0, 1.0)
    if variant == "rational":
        return 0.5 + 0.5 * h / (1.0 + np.abs(h))
    ax = np.abs(h)
    y = np.where(ax >= 5.0, 1.0, np.where(
        ax >= 2.375, 0.03125 * ax + 0.84375,
        np.where(ax >= 1.0, 0.125 * ax + 0.625, 0.25 * ax + 0.5)))
    return np.where(h >= 0, y, 1.0 - y)


def main_path_flt_pwl(torch, K, ds):
    """Main path C: the flt D6 MLP with a pwl2/pwl4/rational sigmoid on
    cuda, one pwl_activation launch per predict, against the plain route
    (the same model on the ``ref`` backend: float sigmoids in PyTorch ops)."""
    mlp = K.models.init_mlp([561, 64, 6], seed=0)
    x_test = ds.x_test
    reset_launches(K)
    t0 = time.perf_counter()
    for sig in ("pwl2", "pwl4", "rational"):
        art = K.tc.compile(mlp, K.tc.Target(sigmoid=sig, backend="cuda"))
        labels = check_artifact(torch, K, art, mlp, x_test, ds.n_classes,
                                {"pwl_activation": 1}, f"mlp flt {sig}")
        plain = K.tc.compile(mlp, K.tc.Target(sigmoid=sig, backend="ref"))
        before = launch_counts(K)
        plain_labels = plain.predict(x_test)
        expect_launches(K, before, {}, f"mlp flt {sig} plain route")
        h = np.asarray(x_test, np.float64)
        for i, (w, b) in enumerate(zip(mlp.weights, mlp.biases)):
            h = h @ w + b
            if i < len(mlp.weights) - 1:
                h = _np_pwl(sig, h)
        top2 = np.sort(h, axis=1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) >= 1e-4
        if not np.array_equal(labels[decided], plain_labels[decided]):
            raise AssertionError(f"mlp flt {sig}: labels differ from the "
                                 f"plain route on decided rows")
        log(f"  mlp      flt {sig:8s} labels "
            f"{np.bincount(labels, minlength=ds.n_classes)}: equal to the "
            f"plain route on all {len(labels)} rows "
            f"{np.array_equal(labels, plain_labels)} (required on the "
            f"{int(decided.sum())} rows with float64 top-2 gap >= 1e-4); "
            f"equal to float64 on "
            f"{int((labels == h.argmax(1))[decided].sum())} of them")
    launches = launch_counts(K)
    log(f"phase 4C: flt PWL path in {time.perf_counter() - t0:.1f} s; "
        f"kernel launches {launches}")
    if launches["pwl_activation"] == 0:
        raise AssertionError("main path C never launched pwl_activation")
    return launches


def serving_models(K, d6, d5):
    """The endpoints of main path D: 8 D6 MLPs (auto16, each calibrated on
    its own 2000-row slice of the train rows, so the schedules differ), 2
    D6 logistic models (fxp16), 4 D5 rbf SVMs (fxp32, prototypes and duals
    of their own), and the D6 tree is added by the caller."""
    out = {}
    for s in range(8):
        cal = d6.x_train[650 * s:650 * s + N_FIT_ROWS]
        out[f"mlp{s}"] = (K.models.init_mlp([561, 64, 6], seed=s),
                          dict(number_format="auto16"), cal, d6)
    for s in range(2):
        rng = np.random.RandomState(20 + s)
        model = K.models.LogisticModel(
            coef=(rng.randn(561, 6) * np.sqrt(2.0 / 567)).astype(np.float32),
            intercept=np.zeros(6, np.float32))
        out[f"logistic{s}"] = (model, dict(number_format="fxp16"), None, d6)
    x64 = d5.x_train.astype(np.float64)
    gamma = 1.0 / (x64.shape[1] * max(x64.var(), 1e-12))
    for s in range(4):
        sv = K.pick_prototypes(x64, d5.y_train, d5.n_classes, N_PROTOTYPES,
                               seed=s)
        rows = slice(1000 * s, 1000 * s + N_FIT_ROWS)
        onehot = np.eye(d5.n_classes)[d5.y_train[rows]]
        feats = kernel_features("rbf", x64[rows], sv, gamma, 1.0, 2)
        sol = np.linalg.lstsq(np.c_[feats, np.ones(len(feats))], onehot,
                              rcond=None)[0]
        out[f"rbf{s}"] = (K.models.SVMModel(
            "rbf", support_vectors=sv, dual_coef=sol[:-1], intercept=sol[-1],
            gamma=gamma, coef0=1.0, degree=2), dict(number_format="fxp32"),
            None, d5)
    return out


def main_path_serving(torch, K, d6, d5, tree_model):
    """Main path D: one InferenceService on the card serving 8 D6 MLPs, 2
    D6 logistic models, 4 D5 rbf SVMs and the D6 tree; enable_fleet forms
    three fleets, client threads submit 1-64-row requests, and every
    response must equal its member's own predict."""
    S = K.serve
    models = serving_models(K, d6, d5)
    models["tree"] = (tree_model, dict(number_format="fxp16"), None, d6)
    policy = S.BatchingPolicy(max_batch=64, max_wait_ms=2.0)
    t0 = time.perf_counter()
    svc = S.InferenceService()
    try:
        for name, (model, kw, cal, _) in models.items():
            svc.register(name, model, K.tc.Target(backend="cuda", **kw),
                         calibration=cal, policy=policy)
        plans = {tuple(svc.endpoint(f"mlp{s}").artifact.extras["emit_spec"]
                       ["shifts"]) for s in range(8)}
        arts = {n: svc.endpoint(n).artifact for n in models}
        golden = {n: arts[n].predict(ds.x_test)
                  for n, (_, _, _, ds) in models.items()}
        t_setup = time.perf_counter() - t0
        # each member's own predict, held against its frozen program run
        # through the plain versions on the card (as paths A and B do)
        for n, (model, _, _, ds) in models.items():
            plain = plain_labels(torch, K, arts[n], model, ds.x_test)
            if not np.array_equal(golden[n], plain):
                raise AssertionError(
                    f"{n}: {int((golden[n] != plain).sum())} labels of its "
                    f"own predict differ from the plain versions")
        reset_launches(K)
        t0 = time.perf_counter()
        formed = svc.enable_fleet()
        fleets = sorted(sorted(m) for m in formed.values())
        want = [[f"logistic{s}" for s in range(2)],
                [f"mlp{s}" for s in range(8)], [f"rbf{s}" for s in range(4)]]
        if fleets != want:
            raise AssertionError(f"enable_fleet formed {fleets}")
        errors, counts = [], []

        def client(seed):
            rng = np.random.RandomState(seed)
            names, futs = sorted(models), []
            for _ in range(60):
                n = names[rng.randint(len(names))]
                ds = models[n][3]
                k = int(rng.randint(1, 65))
                lo = int(rng.randint(0, len(ds.x_test) - k))
                futs.append((n, lo, k, svc.submit(n, ds.x_test[lo:lo + k])))
            for n, lo, k, f in futs:
                got = f.result(timeout=300)
                if not np.array_equal(got, golden[n][lo:lo + k]):
                    errors.append((n, lo, k))
            counts.append(len(futs))

        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a serving client did not finish")
        if errors or sum(counts) != 360:
            raise AssertionError(f"{len(errors)} responses differ from their "
                                 f"member's own predict: {errors[:5]}")
        stats = svc.stats()
    finally:
        svc.close()
    launches = launch_counts(K)
    for fleet in stats["_fleets"]:
        if fleet["stacked_dispatches"] < 1 or fleet["stack_fallbacks"] != 0:
            raise AssertionError(f"fleet {fleet}")
    tree = stats["tree"]
    if tree["batches"] < 1 or tree["coalesced_batches"] != 0:
        raise AssertionError(f"tree not served solo: {tree}")
    for name in ("fxp_mlp_fleet", "fxp_svm_fleet", "tree_ensemble"):
        if launches[name] == 0:
            raise AssertionError(f"main path D never launched {name}")
    log(f"phase 4D: serving path: {len(models)} endpoints registered in "
        f"{t_setup:.1f} s ({len(plans)} distinct MLP schedules), each "
        f"member's own predict equal to the plain versions; 360 requests "
        f"of 1-64 rows from 6 threads in {time.perf_counter() - t0:.1f} s, "
        f"every response equal to its member's own predict; kernel "
        f"launches {launches}")
    for fleet in stats["_fleets"]:
        log(f"  fleet {fleet['members']}: rounds {fleet['rounds']}, stacked "
            f"{fleet['stacked_dispatches']}, solo batches "
            f"{fleet['solo_batches']}, fallbacks {fleet['stack_fallbacks']}, "
            f"staging allocs {fleet['staging_allocs']}")
    log(f"  tree served solo: {tree['batches']} batches, "
        f"{tree['requests']} requests")
    return launches, arts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _rel_err(a, b):
    """max |a - b| / max |b|, one batch row at a time (the full-width logits
    are 5 GB: no third copy)."""
    err = scale = 0.0
    for i in range(a.shape[0]):
        err = max(err, float((a[i] - b[i]).abs().max()))
        scale = max(scale, float(b[i].abs().max()))
    return err / scale


def _lm_tokens(torch, cfg, shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        1, cfg.vocab_size, shape).astype(np.int32)).cuda()


def _decode_logits(torch, M, cfg, params, tok, max_len):
    """serve_step along ``tok`` (B, T) from a fresh cache: (B, T, vocab)."""
    cache = M.init_cache(cfg, tok.shape[0], max_len, tok.device)
    out = []
    for i in range(tok.shape[1]):
        logits, cache = M.serve_step(params, cache, {"token": tok[:, i]}, cfg)
        out.append(logits)
    return torch.stack(out, 1)


@contextlib.contextmanager
def gate_route(K, kernel):
    """The route of the LM's SiLU gate: the port's own (True: on the card, a
    pwl4 gate is one silu_pwl4 launch of pwl_activation) or, patched in,
    the op-by-op PyTorch route that preceded it (False), the yardstick the
    kernel route is held to and timed beside."""
    layers = K.lm_layers
    route = layers.gated_silu
    if not kernel:
        layers.gated_silu = lambda x, gate="exact": \
            x * layers.get_sigmoid(gate)(x)
    try:
        yield
    finally:
        layers.gated_silu = route


def check_gate_route(torch, K, cfg, params, tok, fwd):
    """Path E's pwl4 gate through the kernel against the op-by-op route, at
    the served artifact's weights: in float32 the two forwards within 1e-4
    (relative to the largest logit); in bf16 the kernel route (``fwd``) no
    further from the float32 logits than 1.5x the op-by-op route."""
    M = K.lm_model
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _tree_map(lambda t: t.to(torch.float32) if t.is_floating_point()
                    else t, params)
    with gate_route(K, False):
        eager = M.forward(params, {"tokens": tok}, cfg)
        eager32 = M.forward(p32, {"tokens": tok}, cfg32)
    with gate_route(K, True):
        fused32 = M.forward(p32, {"tokens": tok}, cfg32)
    rel32 = _rel_err(fused32, eager32)
    rel_k, rel_o = _rel_err(fwd, eager32), _rel_err(eager, eager32)
    if not rel32 <= 1e-4:
        raise AssertionError(f"pwl4 gate: float32 kernel route {rel32} from "
                             f"the op-by-op route, over 1e-4")
    if not rel_k <= 1.5 * rel_o:
        raise AssertionError(f"pwl4 gate: bf16 kernel route {rel_k} from the "
                             f"float32 logits, over 1.5 x the op-by-op "
                             f"route's {rel_o}")
    return (f"; pwl4 gate through the kernel: float32 within {rel32:.3e} of "
            f"the op-by-op gate (bound 1e-4), bf16 {rel_k:.3e} from the "
            f"float32 logits against the op-by-op gate's {rel_o:.3e} (bound "
            f"1.5x)")


def prefill_checks(torch, K, cfg, params, tok, what):
    """The bf16 prefill through the kernel at ``params``: exactly one
    flash_attention launch per layer, finite float32 logits of the expected
    shape; with the weights in float32 the kernel route within 1e-4 of the
    same forward through the oracle's attention, and in bf16 the kernel
    route no further from those float32 logits than 1.5x the oracle
    route.  Returns (float32 rel err, bf16 kernel and oracle distances from
    float32, the two bf16 routes' distance, first call s)."""
    M = K.lm_model
    zero = launch_counts(K)
    t0 = time.perf_counter()
    logits = M.forward(params, {"tokens": tok}, cfg)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    expect_launches(K, zero, {"flash_attention": cfg.n_layers},
                    f"bf16 prefill forward{what}")
    if (logits.shape != (*tok.shape, cfg.vocab_size)
            or logits.dtype != torch.float32
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"prefill logits{what} {logits.dtype}"
                             f"{tuple(logits.shape)} not finite float32 of "
                             f"the expected shape")
    # The same weights in float32: the kernel route against the oracle's
    # attention, and the float32 logits that both bf16 routes are held to.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _tree_map(lambda t: t.to(torch.float32), params)
    before = launch_counts(K)
    ref32 = M.forward(p32, {"tokens": tok}, cfg32, attn_impl="ref")
    expect_launches(K, before, {}, f"float32 prefill through the oracle{what}")
    f32 = M.forward(p32, {"tokens": tok}, cfg32)
    expect_launches(K, before, {"flash_attention": cfg.n_layers},
                    f"float32 prefill{what}")
    del p32
    rel32 = _rel_err(f32, ref32)
    del ref32
    if not rel32 <= 1e-4:
        raise AssertionError(f"float32 prefill{what}: kernel route against "
                             f"the oracle's attention, rel err {rel32} > 1e-4")
    rel_k = _rel_err(logits, f32)
    before = launch_counts(K)
    plain = M.forward(params, {"tokens": tok}, cfg, attn_impl="ref")
    expect_launches(K, before, {}, f"bf16 prefill through the oracle{what}")
    rel_o = _rel_err(plain, f32)
    rel = _rel_err(logits, plain)
    del logits, plain, f32
    # bf16 rounds every layer's output: two bf16 forwards that sum in other
    # orders part by about as much as either parts from float32, so the
    # kernel route is held to the oracle route's distance from float32.
    if not rel_k <= 1.5 * rel_o:
        raise AssertionError(f"bf16 prefill{what}: kernel route {rel_k} from "
                             f"the float32 logits, over 1.5 x the oracle "
                             f"route's {rel_o}")
    b, s = tok.shape
    log(f"  bf16 prefill{what} {b} x {s} tokens: {cfg.n_layers} "
        f"flash_attention launches, first call {t_fwd:.2f} s.  float32, "
        f"same weights: kernel route within {rel32:.3e} of the oracle's "
        f"attention (bound 1e-4).  bf16: kernel route {rel_k:.3e} and oracle "
        f"route {rel_o:.3e} from the float32 logits (bound 1.5x the "
        f"oracle's), {rel:.3e} from each other (relative to the largest "
        f"logit)")
    return rel32, rel_k, rel_o, rel, t_fwd


def main_path_lm(torch, K):
    """Main path E: qwen2-0.5b at its published widths, seeded weights.

    1. bf16 prefill: ``forward`` at batch 4 x 2048 tokens, exactly one
       flash_attention launch per layer.  With the same weights in float32,
       the kernel route's logits are within 1e-4 (max |dlogit| / max
       |logit|) of the same forward with its attention through the
       materialized-scores oracle; in bf16 the kernel route is no further
       than 1.5x the oracle route's distance from those float32 logits.
    2. float32: decode (serve_step over the KV cache) against forward,
       batch 2 x 12 steps, relative error < 2e-3.
    3. serving: one InferenceService registers the model at flt (bf16) and
       at fxp8/qnm with an int8 KV cache and the pwl4 gate; generate (batch
       4, 32 tokens) on each makes no flash_attention launch, every token is
       the argmax of serve_step's logits along the sequence, and those
       logits agree with the prefill's over the same tokens (a misplaced
       cache entry or position would put the two an order of the logits
       apart; the bound is 0.25 of the largest logit).
    """
    M, cfg = K.lm_model, K.configs.get_config(LM_ARCH)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    log(f"phase 4E: {LM_ARCH} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV, dh "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied "
        f"embeddings): {n_params} seeded {cfg.dtype} parameters in "
        f"{time.perf_counter() - t0:.1f} s")
    reset_launches(K)
    tok = _lm_tokens(torch, cfg, (LM_BATCH, LM_SEQ), 0)
    prefill_checks(torch, K, cfg, params, tok, "")

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _tree_map(lambda t: t.to(torch.float32), params)
    tok = _lm_tokens(torch, cfg, (LM_DECODE_BATCH, LM_DECODE_STEPS), 1)
    before = launch_counts(K)
    fwd = M.forward(p32, {"tokens": tok}, cfg32)
    expect_launches(K, before, {"flash_attention": cfg.n_layers},
                    "float32 forward")
    dec = _decode_logits(torch, M, cfg32, p32, tok, LM_DECODE_STEPS + 2)
    rel32 = _rel_err(dec, fwd)
    del p32, fwd, dec
    if not rel32 < 2e-3:
        raise AssertionError(f"float32 decode against forward: rel err "
                             f"{rel32} >= 2e-3")
    log(f"  float32 decode ({LM_DECODE_BATCH} x {LM_DECODE_STEPS} steps over "
        f"the KV cache) against the kernel's forward: rel err {rel32:.3e} "
        f"(bound 2e-3)")

    S = K.serve
    targets = {
        "flt": K.tc.Target(number_format="flt"),
        "fxp8_qnm_kv8_pwl4": K.tc.Target(number_format="fxp8",
                                         weight_scale="qnm", kv_cache="int8",
                                         sigmoid="pwl4"),
    }
    start = np.random.RandomState(2).randint(
        1, cfg.vocab_size, (LM_GEN_BATCH,)).astype(np.int32)
    serving = {}
    svc = S.InferenceService()
    try:
        for name, target in targets.items():
            t0 = time.perf_counter()
            art = svc.register(name, K.tc.LMModel(cfg, params), target).artifact
            t_reg = time.perf_counter() - t0
            svc.generate(name, start, 2)  # warm-up: allocations
            gated = art.extras["cfg"].gate_sigmoid == "pwl4"
            # the pwl4 gate: one silu_pwl4 launch per layer and step
            per_step = {"pwl_activation": cfg.n_layers} if gated else {}
            before = launch_counts(K)
            t0 = time.perf_counter()
            seqs = svc.generate(name, start, LM_GEN_TOKENS)
            ms_tok = (time.perf_counter() - t0) * 1e3 / LM_GEN_TOKENS
            expect_launches(K, before, {k: v * LM_GEN_TOKENS
                                        for k, v in per_step.items()},
                            f"generate at {name}")
            if (seqs.shape != (LM_GEN_BATCH, LM_GEN_TOKENS + 1)
                    or seqs.dtype != np.int32 or seqs.min() < 0
                    or seqs.max() >= cfg.vocab_size
                    or not np.array_equal(seqs[:, 0], start)):
                raise AssertionError(f"generate at {name}: {seqs.dtype}"
                                     f"{seqs.shape} [{seqs.min()}, "
                                     f"{seqs.max()}]")
            acfg, ap = art.extras["cfg"], art.extras["params"]
            seq_t = torch.from_numpy(seqs).cuda()
            dec = _decode_logits(torch, M, acfg, ap, seq_t[:, :-1],
                                 LM_GEN_TOKENS + 4)
            if not torch.equal(dec.argmax(-1).to(torch.int32), seq_t[:, 1:]):
                raise AssertionError(f"generate at {name}: tokens are not the "
                                     f"argmax of serve_step's logits")
            before = launch_counts(K)
            fwd = M.forward(ap, {"tokens": seq_t[:, :-1]}, acfg)
            expect_launches(K, before, {"flash_attention": cfg.n_layers,
                                        **per_step},
                            f"prefill of the {name} artifact")
            gate_note = check_gate_route(torch, K, acfg, ap, seq_t[:, :-1],
                                         fwd) if gated else ""
            rel_g = _rel_err(dec, fwd)
            agree = float((fwd.argmax(-1).to(torch.int32)
                           == seq_t[:, 1:]).float().mean())
            if not rel_g < 0.25:
                raise AssertionError(f"generate at {name}: serve_step logits "
                                     f"against prefill, rel err {rel_g}")
            serving[name] = dict(ms_per_token=ms_tok, artifact=art,
                                 flash_bytes=art.memory_report()["flash"],
                                 quantized_bytes=art.extras["quantized_bytes"],
                                 register_s=t_reg, rel=rel_g, agree=agree)
            log(f"  served {name}: registered in {t_reg:.1f} s, artifact "
                f"{serving[name]['flash_bytes']} bytes "
                f"({serving[name]['quantized_bytes']} quantized); generate "
                f"batch {LM_GEN_BATCH} x {LM_GEN_TOKENS} tokens: "
                f"{ms_tok:.2f} ms/token, no flash_attention launch; decode "
                f"logits within {rel_g:.3e} of the prefill's, which picks "
                f"the same token at {agree:.1%} of the steps; sample "
                f"{seqs[0, :8].tolist()}{gate_note}")
        stats = {n: svc.stats()[n] for n in targets}
    finally:
        svc.close()
    for n, st in stats.items():
        if st["batches"] != 2 or st["rows"] != LM_GEN_BATCH * (LM_GEN_TOKENS + 2):
            raise AssertionError(f"endpoint {n} stats {st}")
    launches = launch_counts(K)
    if launches["flash_attention"] == 0:
        raise AssertionError("main path E never launched flash_attention")
    log(f"  kernel launches on path E: {launches}")
    return launches, dict(cfg=cfg, params=params, serving=serving)


# --------------------------------------------------------------------------
# phase 4G: the paper's pipeline (train -> compile -> archive -> load -> HTTP)
# --------------------------------------------------------------------------
PIPELINE_TAGS = ("fxp16", "auto8")
PIPELINE_PROTOTYPES = 400
# a trained model's flt test accuracy must exceed chance (1 / classes) by
# this much
CHANCE_MARGIN = 0.5
HTTP_SIZES = (1, 16, 256)  # rows per request, in turns
HTTP_CLIENTS = 8
KIND_KERNEL = {"mlp": "fxp_mlp_model", "logistic": "fxp_layer",
               "svm-linear": "fxp_layer", "svm-poly": "fxp_svm_model",
               "svm-rbf": "fxp_svm_model", "tree": "tree_ensemble"}


def _flt_accuracy(K, model, ds):
    art = K.tc.compile(model, K.tc.Target(number_format="flt",
                                          backend="cuda"))
    return float((art.predict(ds.x_test) == ds.y_test).mean())


def _archive_members(K, path):
    with open(path, "rb") as f:
        payload = K.ckpt.unpackb(K.ckpt.decompress_bytes(f.read()))
    return {k: K.ckpt.unpackb(v) for k, v in payload["members"].items()}


def _http_requests(server, jobs, bodies, clients):
    """POST every (name, rows) job, with its JSON body from ``bodies``,
    from ``clients`` threads, each on its own keep-alive connection;
    returns (responses and request latencies in s, by job index, and the
    wall seconds)."""
    import http.client

    out, lat, errors = [None] * len(jobs), [0.0] * len(jobs), []

    def client(c):
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=120)
        try:
            for i in range(c, len(jobs), clients):
                t0 = time.perf_counter()
                conn.request("POST", f"/v1/predict/{jobs[i][0]}", body=bodies[i],
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                payload = json.loads(resp.read())
                dt = time.perf_counter() - t0
                if resp.status != 200:
                    raise AssertionError(f"{jobs[i][0]}: HTTP "
                                         f"{resp.status} {payload}")
                out[i], lat[i] = payload["predictions"], dt
        except Exception as e:  # reported by the caller
            errors.append(e)
        finally:
            conn.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"HTTP clients failed: {errors[:3]}")
    return out, lat, wall


def _inproc_requests(svc, jobs, clients):
    """The same jobs through ``svc.predict`` from ``clients`` threads:
    (latencies in s by job index, wall seconds)."""
    lat, errors = [0.0] * len(jobs), []

    def client(c):
        try:
            for i in range(c, len(jobs), clients):
                name, rows = jobs[i]
                t0 = time.perf_counter()
                svc.predict(name, rows)
                lat[i] = time.perf_counter() - t0
        except Exception as e:  # reported by the caller
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"in-process clients failed: {errors[:3]}")
    return lat, time.perf_counter() - t0


def _http_get(server, path):
    import http.client

    conn = http.client.HTTPConnection(server.host, server.port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _latency_line(lat, wall, n):
    ms = np.asarray(lat) * 1e3
    return (f"{n / wall:.1f} requests/s, p50 {np.percentile(ms, 50):.3f} ms, "
            f"p99 {np.percentile(ms, 99):.3f} ms")


def main_path_pipeline(torch, K, ds, tree_model):
    """Main path G: the paper's pipeline on D6 at full width.  Train each
    classifier on the card (the tree is main()'s CART), compile it at fxp16
    and auto8 on ``cuda``, save each archive with its C, load each on the
    card (labels and C equal to the saved artifact's), serve the loaded
    archives over HTTP (every test row of every endpoint in requests of 1,
    16 and 256 rows, labels equal to the in-process labels), and refuse a
    corrupted archive."""
    import asyncio

    M, C = K.models, ds.n_classes
    x_tr, y_tr, x_cal = ds.x_train, ds.y_train, ds.x_train[:N_CALIBRATION]
    out_dir = os.path.join(ROOT, "build", "pipeline")
    os.makedirs(out_dir, exist_ok=True)
    reset_launches(K)
    t_phase = time.perf_counter()
    trainers = {
        "mlp": lambda: M.train_mlp(x_tr, y_tr, C, hidden=(64,)),
        "logistic": lambda: M.train_logistic(x_tr, y_tr, C),
        "svm-linear": lambda: M.train_linear_svm(x_tr, y_tr, C),
        "svm-rbf": lambda: M.train_kernel_svm(
            x_tr, y_tr, C, kernel="rbf", n_prototypes=PIPELINE_PROTOTYPES),
        "svm-poly": lambda: M.train_kernel_svm(
            x_tr, y_tr, C, kernel="poly", n_prototypes=PIPELINE_PROTOTYPES),
    }
    models, floor = {}, 1.0 / C + CHANCE_MARGIN
    for kind, train in trainers.items():
        t0 = time.perf_counter()
        models[kind] = train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        acc = _flt_accuracy(K, models[kind], ds)
        log(f"  4G train {kind:10s} on the card in {secs:.2f} s; flt test "
            f"accuracy {acc:.4f}")
        if acc < floor:
            raise AssertionError(f"4G: trained {kind} accuracy {acc:.4f} "
                                 f"under chance + {CHANCE_MARGIN} ({floor:.4f})")
    models["tree"] = tree_model
    acc_tree = _flt_accuracy(K, tree_model, ds)
    acc_mlp = _flt_accuracy(K, models["mlp"], ds)
    acc_init = _flt_accuracy(K, M.init_mlp([561, 64, 6], seed=0), ds)
    log(f"  4G tree (main()'s CART) flt accuracy {acc_tree:.4f}; untrained "
        f"init_mlp (path A's MLP) {acc_init:.4f} against trained "
        f"{acc_mlp:.4f}")
    if acc_tree < floor or acc_mlp <= acc_init:
        raise AssertionError("4G: the tree is under chance + margin or the "
                             "trained MLP does not beat the untrained one")

    arts, paths = {}, {}
    t0 = time.perf_counter()
    for kind, model in models.items():
        for tag in PIPELINE_TAGS:
            kw = TAGS[tag]
            cal = x_cal if kw["number_format"].startswith("auto") else None
            art = K.tc.compile(model, K.tc.Target(backend="cuda", **kw),
                               calibration=cal)
            path = os.path.join(out_dir, f"{kind}-{tag}.embml")
            art.save(path, metadata={"dataset": "D6"}, include_c=True)
            arts[(kind, tag)], paths[(kind, tag)] = art, path
    log(f"  4G compiled and saved {len(arts)} archives (include_c) in "
        f"{time.perf_counter() - t0:.2f} s: "
        f"{sum(os.path.getsize(p) for p in paths.values())} bytes")

    loaded, labels = {}, {}
    for key, path in paths.items():
        t0 = time.perf_counter()
        again = K.tc.load(path)
        t_load = time.perf_counter() - t0
        before = launch_counts(K)
        got = again.predict(ds.x_test)
        expect_launches(K, before, {KIND_KERNEL[key[0]]: 1},
                        f"4G loaded {key} predict")
        want = arts[key].predict(ds.x_test)
        if again.device != arts[key].device or not np.array_equal(got, want):
            raise AssertionError(f"4G: loaded {key} gives other labels "
                                 f"than the saved artifact")
        meta = _archive_members(K, path)["metadata"]
        if meta.get("emit_c") != again.emit_c():
            raise AssertionError(f"4G: {key} archive's C is not emit_c()")
        loaded[key], labels[key] = again, got
        log(f"  4G load {key[0]:10s} {key[1]:6s} {t_load * 1e3:8.2f} ms "
            f"({os.path.getsize(path)} bytes); labels on {len(got)} rows "
            f"and the carried C equal the saved artifact's; test accuracy "
            f"{float((got == ds.y_test).mean()):.4f}")

    svc = K.serve.InferenceService()
    loop = asyncio.new_event_loop()
    loop_thread = threading.Thread(target=loop.run_forever, daemon=True)
    loop_thread.start()
    server = None
    try:
        names = {}
        for key, art in loaded.items():
            names[key] = f"{key[0]}-{key[1]}"
            svc.register(names[key], artifact=art,
                         policy=K.serve.BatchingPolicy(max_batch=256,
                                                       max_wait_ms=1.0))
        server = svc.serve_http("127.0.0.1", 0)
        asyncio.run_coroutine_threadsafe(server.start(), loop).result(60)
        jobs, spans = [], []
        for key in loaded:
            lo, i = 0, 0
            while lo < len(ds.x_test):
                k = HTTP_SIZES[i % len(HTTP_SIZES)]
                jobs.append((names[key], ds.x_test[lo:lo + k]))
                spans.append((key, lo, min(lo + k, len(ds.x_test))))
                lo, i = lo + k, i + 1
        for name in names.values():  # the first request of each endpoint
            svc.predict(name, ds.x_test[:1])
        # each row's JSON made once, before the clock: the clients then
        # only join strings, and the timing is the server's
        row_json = [json.dumps(r) for r in ds.x_test.tolist()]
        bodies = ['{"rows": [' + ",".join(row_json[lo:hi]) + "]}"
                  for _, lo, hi in spans]
        out, lat, wall = _http_requests(server, jobs, bodies, HTTP_CLIENTS)
        for (key, lo, hi), preds in zip(spans, out):
            if not np.array_equal(np.asarray(preds), labels[key][lo:hi]):
                raise AssertionError(f"4G: HTTP labels of {key} rows "
                                     f"{lo}:{hi} differ from in-process")
        status_h, health = _http_get(server, "/v1/health")
        status_s, stats = _http_get(server, "/v1/stats")
        if (status_h, health) != (200, {"status": "ok",
                                        "endpoints": len(names)}):
            raise AssertionError(f"4G /v1/health: {status_h} {health}")
        if status_s != 200 or set(stats["slo"]) != set(names.values()):
            raise AssertionError(f"4G /v1/stats: {status_s}")
        in_lat, in_wall = _inproc_requests(svc, jobs, HTTP_CLIENTS)
        log(f"  4G HTTP: {len(jobs)} requests ({len(names)} endpoints x "
            f"{len(ds.x_test)} rows in requests of {HTTP_SIZES} rows, "
            f"{HTTP_CLIENTS} clients): {_latency_line(lat, wall, len(jobs))}; "
            f"every label equal to the in-process label; /v1/health and "
            f"/v1/stats answer")
        log(f"  4G in process, the same requests: "
            f"{_latency_line(in_lat, in_wall, len(jobs))}")
        sizes = np.array([hi - lo for _, lo, hi in spans])
        for k in HTTP_SIZES:
            pick = sizes == k
            h = np.asarray(lat)[pick] * 1e3
            p = np.asarray(in_lat)[pick] * 1e3
            log(f"  4G requests of {k:3d} rows ({int(pick.sum())}): HTTP p50 "
                f"{np.percentile(h, 50):.3f} p99 {np.percentile(h, 99):.3f} "
                f"ms; in process p50 {np.percentile(p, 50):.3f} p99 "
                f"{np.percentile(p, 99):.3f} ms")
    finally:
        if server is not None:
            asyncio.run_coroutine_threadsafe(server.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        loop_thread.join(60)
        loop.close()
        svc.close()

    src = paths[("mlp", "fxp16")]
    bad = os.path.join(out_dir, "corrupt.embml")
    raw = bytearray(open(src, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    with open(bad, "wb") as f:
        f.write(bytes(raw))
    try:
        K.tc.load(bad)
    except K.tc.ArtifactIntegrityError as e:
        log(f"  4G a one-byte flip is refused: {str(e)[:96]}")
    else:
        raise AssertionError("4G: a corrupted archive loaded")
    launches = launch_counts(K)
    for name in set(KIND_KERNEL.values()):
        if launches[name] == 0:
            raise AssertionError(f"main path G never launched {name}")
    log(f"phase 4G: pipeline path in {time.perf_counter() - t_phase:.1f} s; "
        f"kernel launches {launches}")
    return launches


# --------------------------------------------------------------------------
# phase 4H: the LM trainer on the card (loss_fn, make_train_step, train_loop,
# the pytree checkpoints, launch/train.py)
# --------------------------------------------------------------------------
TRAIN_BATCH, TRAIN_SEQ = 8, 512  # H1: the full_attention branch (chunk 1024)
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP, TRAIN_SEED = 24, 1e-3, 3, 0
HELD_OUT_STEP = 10_000  # a batch of the stream that training never sees
CODEC_SAMPLE_BYTES = 64 << 20  # H2: a slice of the trained embedding table
TRAINED_GEN_TOKENS = 4
# H3: launch/train.py at the reduced config, and the resume check.  At the
# launcher's default lr (1e-3) the reduced model's loss over 20 steps moves
# less than the batch-to-batch noise of 256 tokens (host runs, seeds 0-5:
# the mean of the last five losses is above the first five's for two);
# at 1e-2 it falls by 0.1-0.2 for every seed
REDUCED_STEPS, REDUCED_EVERY, REDUCED_BATCH, REDUCED_SEQ = 20, 10, 4, 64
REDUCED_LR, REDUCED_EVAL_BATCH = 1e-2, 32
TRAIN_DIR = os.path.join(ROOT, "build", "train_ckpt")


def _step_profile(torch, fn):
    """One call of ``fn`` through :func:`_kernel_profile`, its device time
    bucketed by the kinds of a training step (no kernel of the port runs
    in one), with the top kernels and the top aten ops by device time."""
    prof = _kernel_profile(torch, fn)
    kinds = {"float32 GEMM": 0.0, "bf16 GEMM": 0.0, "reduction": 0.0,
             "elementwise": 0.0, "other": 0.0}
    for name, ms in prof["device_ms"].items():
        n = name.lower()
        if any(t in n for t in ("gemm", "nvjet", "cutlass", "xmma")):
            f32 = "sgemm" in n or ("f32" in n and "bf16" not in n)
            kind = "float32 GEMM" if f32 else "bf16 GEMM"
        elif "reduce" in n or "softmax" in n:
            kind = "reduction"
        else:
            kind = "elementwise" if "elementwise" in n else "other"
        kinds[kind] += ms
    top = sorted(prof["device_ms"].items(), key=lambda kv: -kv[1])[:8]
    return {"by_kind": kinds, "device_ms": sum(kinds.values()),
            "wall_ms": prof["wall_ms"], "launches": prof["launches"],
            "top_kernels": [(n, (ms, prof["names"][n])) for n, ms in top],
            "top_ops": sorted(prof["ops"].items(), key=lambda kv: -kv[1])[:8]}


def _leaf_bits(torch, x):
    """(dtype, shape, bytes) of a restored leaf: a numpy array, or a
    bfloat16 tensor (the codec's decoding of bf16)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return str(t.dtype), tuple(t.shape), t.view(torch.int16).numpy(
            ).tobytes()
    x = np.asarray(x)
    return str(x.dtype), x.shape, x.tobytes()


def check_grad_guard(torch, K, cfg, params, tokens):
    """The serving route with grad on: the stack stops at its first
    flash_attention call, and pwl_activation refuses an input that requires
    grad; neither launches."""
    live = K.optim.tree_map(lambda p: p.detach().requires_grad_(True), params)
    x = torch.ones(4, 64, device="cuda", requires_grad=True)
    calls = {"the serving stack (flash_attention)": lambda: K.lm_model._stack(
                 live, {"tokens": tokens}, cfg, "cuda"),
             "pwl_activation": lambda: K.ops.pwl_activation(x, "silu_pwl4")}
    before = launch_counts(K)
    for what, call in calls.items():
        try:
            with torch.enable_grad():
                call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"{what} with grad on did not raise")
    expect_launches(K, before, {}, "the kernel routes with grad on")
    return list(calls)


def train_full_width(torch, K):
    """H1: qwen2-0.5b at its published widths (bf16 parameters, float32
    moments) trains for TRAIN_STEPS steps of batch 8 x 512 from a seeded
    init through make_train_step; no kernel launches in a step."""
    M, TT = K.lm_model, K.trainer
    cfg = K.configs.get_config(LM_ARCH)
    dev = torch.device("cuda", 0)
    tcfg = TT.TrainConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                          total_steps=TRAIN_STEPS, seed=TRAIN_SEED)
    opt = TT.make_optimizer(tcfg)
    step_fn = TT.make_train_step(cfg, tcfg, opt)
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init = M.init_params(cfg, torch.Generator(dev).manual_seed(TRAIN_SEED))
    state = opt.init(init)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(init))
    blockwise = TRAIN_SEQ % cfg.attn_chunk == 0 and TRAIN_SEQ > cfg.attn_chunk
    log(f"phase 4H: {LM_ARCH} training at full width, remat {cfg.remat}: "
        f"{n_params} {cfg.dtype} parameters and {tcfg.moments_dtype} "
        f"moments in {time.perf_counter() - t0:.1f} s; batch {TRAIN_BATCH} "
        f"x {TRAIN_SEQ} ({'blockwise' if blockwise else 'full'} attention), "
        f"lr {TRAIN_LR}, warmup {TRAIN_WARMUP}, {TRAIN_STEPS} steps")
    stream = TT.synthetic_token_stream(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                       TRAIN_SEED, device=dev)
    batch = next(stream)
    # the serving route's cross-entropy on step 0's batch: the loss that
    # the training route must give at the same weights
    before = launch_counts(K)
    with torch.inference_mode():
        logits = M.forward(init, batch, cfg)
        serve_loss = float(M._cross_entropy(logits[:, :-1],
                                            batch["tokens"][:, 1:]))
    del logits
    expect_launches(K, before, {"flash_attention": cfg.n_layers},
                    "H1 serving-route forward")
    guarded = check_grad_guard(torch, K, cfg, init, batch["tokens"][:1, :64])
    params, losses, norms, times = init, [], [], []
    before = launch_counts(K)
    for i in range(TRAIN_STEPS):
        if i:
            batch = next(stream)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    expect_launches(K, before, {}, "H1 training steps")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"H1: non-finite loss or grad norm: {losses}, "
                             f"{norms}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first:
        raise AssertionError(f"H1: the loss did not fall: mean of the first "
                             f"five {first}, of the last five {last}; "
                             f"{losses}")
    gap = abs(losses[0] - serve_loss) / serve_loss
    if not gap <= 1e-2:
        raise AssertionError(f"H1: step 0's training-route loss {losses[0]} "
                             f"against the serving route's {serve_loss}: "
                             f"{gap} > 1e-2")
    ms = float(np.median(times[3:]))
    shape = K.configs.ShapeSpec("h1", TRAIN_SEQ, TRAIN_BATCH, "train")
    one = dict(chips=1, tp=1, dp_in_pod=1, pods=1, microbatches=1)
    model_flops = K.roofline.analytic_cost(cfg, shape, remat=False,
                                           **one).flops_global
    run_flops = K.roofline.analytic_cost(cfg, shape, **one).flops_global
    share = model_flops / (ms / 1e3 * BF16_TENSOR_OPS_PER_S)
    prof = _step_profile(torch, lambda: step_fn(params, state, batch))
    idle = 1 - prof["device_ms"] / ms
    log(f"  losses {[round(v, 4) for v in losses]}")
    log(f"  grad norms {[round(v, 3) for v in norms]}")
    log(f"  H1: loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first "
        f"five {first:.4f}, of the last five {last:.4f}); step 0 against "
        f"the serving route's cross-entropy {serve_loss:.4f}: {gap:.3e} "
        f"(bound 1e-2); with grad on {', '.join(guarded)} raised")
    log(f"  H1: {ms:.2f} ms/step (median of steps 4-{TRAIN_STEPS}; all "
        f"{[round(t, 1) for t in times]}), "
        f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.0f} tokens/s; model FLOPs "
        f"{model_flops / 1e12:.3f} Tflop a step (analytic_cost, no remat; "
        f"{run_flops / 1e12:.3f} with the config's remat): "
        f"{share:.1%} of {BF16_TENSOR_OPS_PER_S / 1e12:.1f} Tflop/s "
        f"({run_flops / (ms / 1e3 * BF16_TENSOR_OPS_PER_S):.1%} with "
        f"remat); peak memory {peak_gb:.2f} GiB "
        f"(max_memory_allocated; {base_gb:.2f} GiB held before the phase)")
    log(f"  H1 one step under torch.profiler: {prof['device_ms']:.2f} ms of "
        f"device time in {prof['launches']} launches, "
        f"{prof['wall_ms']:.1f} ms wall; device idle {idle:.1%} of the "
        f"unprofiled step ({1 - prof['device_ms'] / prof['wall_ms']:.1%} of "
        f"the profiled one); by kind: "
        + ", ".join(f"{k} {v:.2f} ms ({v / prof['device_ms']:.1%})"
                    for k, v in prof["by_kind"].items()))
    log("  H1 top kernels: " + "; ".join(
        f"{n[:70]} {v[0]:.2f} ms x{v[1]}" for n, v in prof["top_kernels"]))
    log("  H1 top ops (own device time): " + "; ".join(
        f"{n} {v:.2f} ms" for n, v in prof["top_ops"]))
    del state
    return dict(cfg=cfg, init=init, params=params, ms_per_step=ms,
                tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
                model_flops=model_flops, share=share, peak_gb=peak_gb,
                launches_per_step=prof["launches"], idle=idle,
                losses=losses, profile=prof)


def serve_trained(torch, K, h1):
    """H2: the trained weights served back: the bf16 prefill through the
    kernel (path E's checks), the held-out loss below the initial one,
    generate through the lm lowering, and the checkpoint codec timed on a
    64 MB slice of the trained embedding table."""
    M, TT = K.lm_model, K.trainer
    cfg, init, params = h1["cfg"], h1["init"], h1["params"]
    dev = torch.device("cuda", 0)
    tok = _lm_tokens(torch, cfg, (LM_BATCH, LM_SEQ), 5)
    prefill_checks(torch, K, cfg, params, tok, " of the trained weights")
    held = next(TT.synthetic_token_stream(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                          TRAIN_SEED, HELD_OUT_STEP,
                                          device=dev))
    with torch.no_grad():
        l_init = float(M.loss_fn(init, held, cfg))
        l_trained = float(M.loss_fn(params, held, cfg))
    if not l_trained < l_init:
        raise AssertionError(f"H2: held-out loss of the trained weights "
                             f"{l_trained} not below the initial {l_init}")
    art = K.tc.compile(K.tc.LMModel(cfg, params),
                       K.tc.Target(number_format="flt"))
    start = np.arange(1, LM_GEN_BATCH + 1, dtype=np.int32) * 97
    before = launch_counts(K)
    seqs = art.extras["generate"](start, TRAINED_GEN_TOKENS)
    expect_launches(K, before, {}, "H2 generate")
    seq_t = torch.from_numpy(seqs).cuda()
    dec = _decode_logits(torch, M, art.extras["cfg"], art.extras["params"],
                         seq_t[:, :-1], TRAINED_GEN_TOKENS + 4)
    if (seqs.shape != (LM_GEN_BATCH, TRAINED_GEN_TOKENS + 1)
            or not torch.equal(dec.argmax(-1).to(torch.int32), seq_t[:, 1:])):
        raise AssertionError(f"H2 generate: {seqs} are not serve_step's "
                             f"argmax")
    del art, dec
    # the codec on a slice of the trained table (zlib where zstandard is
    # missing), projected to the whole train state
    table = params["embed"]["table"]
    rows = CODEC_SAMPLE_BYTES // (table.shape[1] * table.element_size())
    sample = {"embed": {"table": table[:rows]}}
    raw = rows * table.shape[1] * table.element_size()
    path = os.path.join(TRAIN_DIR, "codec", "sample.ckpt")
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    t0 = time.perf_counter()
    K.ckpt.save_pytree(path, sample)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, _ = K.ckpt.restore_pytree(path, like=sample)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    disk = os.path.getsize(path)
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    got = back["embed"]["table"]
    if got.device.type != "cuda" or _leaf_bits(torch, got) != _leaf_bits(
            torch, sample["embed"]["table"]):
        raise AssertionError("H2: the codec sample did not restore bit for "
                             "bit onto the card")
    codec = "zstd" if K.ckpt.zstandard is not None else "zlib"
    n = sum(t.numel() for t in _leaves(params))
    state_bytes = n * (table.element_size() + 4 + 4)  # params, mu, nu
    save_mbs = raw / t_save / 1e6
    log(f"  H2: held-out loss (stream step {HELD_OUT_STEP}) {l_init:.4f} "
        f"initial -> {l_trained:.4f} trained; generate {TRAINED_GEN_TOKENS} "
        f"tokens through the lm lowering: {seqs[0].tolist()}, serve_step's "
        f"argmax, no flash_attention launch")
    log(f"  H2 codec ({codec}) on {raw / 1e6:.1f} MB of the trained bf16 "
        f"table: save {t_save:.2f} s ({save_mbs:.1f} MB/s), restore onto "
        f"the card {t_restore:.2f} s ({raw / t_restore / 1e6:.1f} MB/s), "
        f"ratio {disk / raw:.3f}; the full train state ({state_bytes / 1e9:.2f}"
        f" GB: bf16 parameters, float32 mu and nu) would take "
        f"{state_bytes / 1e6 / save_mbs:.0f} s to save at this rate")
    return dict(l_init=l_init, l_trained=l_trained, codec=codec,
                save_mbs=save_mbs, restore_mbs=raw / t_restore / 1e6,
                ratio=disk / raw,
                projected_s=state_bytes / 1e6 / save_mbs)


def _run_train_cli(ckpt_dir, arch=LM_ARCH, steps=REDUCED_STEPS,
                   batch=REDUCED_BATCH, seq=REDUCED_SEQ, lr=REDUCED_LR,
                   every=REDUCED_EVERY, what="H3"):
    """launch/train.py at the reduced config in a process of its own:
    (first loss, last loss, the printed lines)."""
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in [env.get("PYTHONPATH")]
                                       if p])
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           arch, "--steps", str(steps), "--batch", str(batch), "--seq",
           str(seq), "--lr", str(lr), "--checkpoint-every", str(every),
           "--ckpt-dir", ckpt_dir]
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"{what}: {' '.join(cmd[2:])} exited "
                             f"{r.returncode}: {r.stderr[-3000:]}")
    done = [l for l in r.stdout.splitlines() if l.startswith("done at step")]
    if not done or f"done at step {steps} on cuda" not in done[-1]:
        raise AssertionError(f"{what}: the launcher printed "
                             f"{r.stdout[-2000:]}")
    first, last = (float(v) for v in done[-1].split("loss")[1].split("->"))
    return first, last, r.stdout.strip().splitlines()


def train_reduced(torch, K):
    """H3: launch/train.py on the card at the reduced config; the resume
    check of tests/test_trainer.py, bit for bit under deterministic
    algorithms; and the step-0 loss and gradients against the host's."""
    M, TT = K.lm_model, K.trainer
    cfg = K.configs.get_config(LM_ARCH).reduced()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cli_dir = os.path.join(TRAIN_DIR, "cli")
    first, last, lines = _run_train_cli(cli_dir)
    mgr = K.ckpt.CheckpointManager(os.path.join(cli_dir, cfg.name))
    steps = mgr.all_steps()
    if steps != [REDUCED_EVERY, REDUCED_STEPS]:
        raise AssertionError(f"H3: committed steps {steps}")
    t_cli = time.perf_counter() - t0
    # the loss falls: the committed step's weights against the launcher's
    # seeded init (the same generator, on the card), on a held-out batch
    init = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    _, state, _ = mgr.restore({"params": init, "opt": K.trainer.make_optimizer(
        K.trainer.TrainConfig()).init(init)}, REDUCED_STEPS)
    held = next(TT.synthetic_token_stream(cfg, REDUCED_EVAL_BATCH,
                                          REDUCED_SEQ, 0, HELD_OUT_STEP,
                                          device=dev))
    with torch.no_grad():
        l_init = float(M.loss_fn(init, held, cfg))
        l_end = float(M.loss_fn(state["params"], held, cfg))
    if not l_end < l_init:
        raise AssertionError(f"H3: held-out loss at step {REDUCED_STEPS} "
                             f"{l_end} not below the initial {l_init}")
    log(f"  H3: launch/train.py --arch {LM_ARCH} --steps {REDUCED_STEPS} "
        f"--batch {REDUCED_BATCH} --seq {REDUCED_SEQ} --lr {REDUCED_LR} "
        f"--checkpoint-every {REDUCED_EVERY} on the card in {t_cli:.1f} s "
        f"(its own process): loss {first} -> {last}, committed steps "
        f"{steps}; held-out loss ({REDUCED_EVAL_BATCH} x {REDUCED_SEQ}) "
        f"{l_init:.4f} initial -> {l_end:.4f} at step {REDUCED_STEPS}; "
        + " | ".join(lines[-3:]))

    tcfg = TT.TrainConfig(lr=1e-3, warmup_steps=2, total_steps=30,
                          checkpoint_every=10, seed=3)

    def run(d, n):
        return TT.train_loop(cfg, tcfg, batch=4, seq=32, ckpt_dir=d,
                             steps=n, device=dev)

    da, db = (os.path.join(TRAIN_DIR, x) for x in ("full", "resumed"))
    for d in (da, db):
        shutil.rmtree(d, ignore_errors=True)
    prev = torch.are_deterministic_algorithms_enabled()
    nondeterministic = None
    t0 = time.perf_counter()
    try:
        torch.use_deterministic_algorithms(True)
        full = run(da, 20)
        run(db, 10)
        resumed = run(db, 20)
    except RuntimeError as e:
        if "deterministic" not in str(e):
            raise
        nondeterministic = str(e).splitlines()[0]
    finally:
        torch.use_deterministic_algorithms(prev)
    if nondeterministic is None:
        _, a, _ = K.ckpt.CheckpointManager(da).restore(None, 20)
        _, b, _ = K.ckpt.CheckpointManager(db).restore(None, 20)
        same = (len(a) == len(b) and all(
            _leaf_bits(torch, x) == _leaf_bits(torch, y)
            for x, y in zip(a, b)))
        if not same or full["history"][10:] != resumed["history"]:
            raise AssertionError("H3: the resumed run's final parameters or "
                                 "losses are not the uninterrupted run's bit "
                                 "for bit")
        verdict = (f"final parameters ({len(a)} leaves) and losses 10-19 "
                   f"equal bit for bit under deterministic algorithms")
    else:
        for d in (da, db):
            shutil.rmtree(d, ignore_errors=True)
        full = run(da, 20)
        run(db, 10)
        resumed = run(db, 20)
        np.testing.assert_allclose(full["history"][-1],
                                   resumed["history"][-1], rtol=1e-5)
        verdict = (f"no deterministic CUDA kernel for: {nondeterministic}; "
                   f"last loss {resumed['history'][-1]} within rtol 1e-5 of "
                   f"{full['history'][-1]}")
    log(f"  H3 resume (20 steps against 10 + 10, {time.perf_counter() - t0:.1f}"
        f" s): {verdict}")

    p_cpu = M.init_params(cfg, torch.Generator("cpu").manual_seed(0))
    p_gpu = K.optim.tree_map(lambda t: t.to(dev), p_cpu)
    b = next(TT.synthetic_token_stream(cfg, REDUCED_BATCH, REDUCED_SEQ, 0))
    l_c, g_c = TT.loss_and_grads(p_cpu, b, cfg)
    l_g, g_g = TT.loss_and_grads(p_gpu, {"tokens": b["tokens"].to(dev)}, cfg)
    rel_l = abs(float(l_g) - float(l_c)) / abs(float(l_c))
    rel_g = max(float((x.cpu() - y).abs().max() / y.abs().max())
                for x, y in zip(K.optim.tree_leaves(g_g),
                                K.optim.tree_leaves(g_c)))
    if not (rel_l <= 1e-4 and rel_g <= 1e-4):
        raise AssertionError(f"H3: the card's step-0 loss {rel_l} or "
                             f"gradients {rel_g} from the host's, over 1e-4")
    log(f"  H3 float32 step 0 on the card against the host: loss "
        f"{float(l_g):.6f} vs {float(l_c):.6f} ({rel_l:.2e}), gradients "
        f"within {rel_g:.2e} of each leaf's largest value (bound 1e-4)")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return dict(cli_loss=(first, last), held_out=(l_init, l_end),
                resume=verdict, rel_loss=rel_l,
                rel_grad=rel_g, nondeterministic=nondeterministic)


def main_path_train(torch, K):
    """Main path H: the LM trainer on the card.  H1 trains qwen2-0.5b at
    full width, H2 serves the trained weights back through the kernel and
    times the checkpoint codec, H3 runs launch/train.py and the resume
    check at the reduced config."""
    reset_launches(K)
    t0 = time.perf_counter()
    h1 = train_full_width(torch, K)
    h2 = serve_trained(torch, K, h1)
    h3 = train_reduced(torch, K)
    launches = launch_counts(K)
    if launches["flash_attention"] == 0:
        raise AssertionError("main path H never launched flash_attention")
    log(f"phase 4H: trainer path in {time.perf_counter() - t0:.1f} s; kernel "
        f"launches on path H: {launches}")
    for k in ("init", "params"):
        h1.pop(k)
    torch.cuda.empty_cache()
    return launches, dict(h1=h1, h2=h2, h3=h3)


# --------------------------------------------------------------------------
# phase 4I: the rest of the attention family (MoE, MLA with MoE, the vision
# and audio front ends) at published widths
# --------------------------------------------------------------------------
# (arch, layers kept or None for the full depth, prefill (batch, tokens),
# image embeddings prepended per row, decode (batch, tokens) or None)
FAMILY_RUNS = (
    # 3 dense layers (d_ff 18432) and one MoE layer; S 8192 crosses the
    # config's moe_prefill_chunk (4096) in two chunks of 2 x 4096 tokens
    ("deepseek-v3-671b", 4, (2, 8192), 0, (4, 32)),
    ("grok-1-314b", 2, (4, 2048), 0, (4, 32)),
    # anyres: 5 tiles x 576 = 2880 patch embeddings before 1216 tokens
    ("llava-next-mistral-7b", None, (2, 1216), 2880, (4, 32)),
    # 30 s of audio at HuBERT's 20 ms frames; encoder-only: no decode
    ("hubert-xlarge", None, (4, 1500), 0, None),
)
# the float32 checks: one row of this many positions (llava: a quarter of
# them image embeddings)
FAMILY_CHECK_SEQ = 1024
FAMILY_QUANT = "deepseek-v3-671b"  # served at fxp8/qnm/int8-KV/pwl4 too


def _family_cfg(K, arch, n_layers):
    cfg = K.configs.get_config(arch)
    return cfg if n_layers is None else dataclasses.replace(cfg,
                                                            n_layers=n_layers)


def _no_drop(cfg):
    """``cfg`` with the MoE capacity factor raised until nothing drops
    (capacity = tokens: E / k), as the reference's ``reduced()`` does for
    decode == prefill; a dense config as it is."""
    if cfg.moe is None:
        return cfg
    mo = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=mo.n_experts / mo.top_k))


def _family_batch(torch, cfg, b, s, n_img, seed):
    """A prefill batch of ``b`` rows: audio frame embeddings (s of them),
    or tokens with ``n_img`` image embeddings before them."""
    rng = np.random.RandomState(seed)
    if cfg.modality == "audio":
        return {"embeds": torch.from_numpy(rng.randn(b, s, cfg.d_model)
                                           .astype(np.float32)).cuda()}
    out = {"tokens": _lm_tokens(torch, cfg, (b, s), seed)}
    if n_img:
        out["image_embeds"] = torch.from_numpy(
            rng.randn(b, n_img, cfg.d_model).astype(np.float32)).cuda()
    return out


@contextlib.contextmanager
def record_routing(K):
    """Every ``moe.route`` call's (float32 input, experts) in order: which
    experts each token picked, in each MoE layer (and prefill chunk)."""
    moe, route = K.moe, K.moe.route
    calls = []

    def spy(p, x32, cfg):
        w, e = route(p, x32, cfg)
        calls.append((x32, e))
        return w, e

    moe.route = spy
    try:
        yield calls
    finally:
        moe.route = route


@contextlib.contextmanager
def pinned_routing(K, experts):
    """Every ``moe.route`` call, in order, selects the experts of the
    matching call of ``experts`` (a float32 run's), weighted by this run's
    own scores as ``moe.select`` weights its picks: a bf16 run dispatches
    the same tokens to the same experts as the float32 one, so the two
    differ by rounding only, at every position."""
    moe, route = K.moe, K.moe.route
    calls = iter(experts)

    def pinned(p, x32, cfg):
        e = next(calls)
        w = moe.scores(p, x32, cfg).gather(1, e)
        total = w[:, 0]
        for j in range(1, w.shape[1]):
            total = total + w[:, j]
        return w / total.clamp_min(1e-9)[:, None], e

    moe.route = pinned
    try:
        yield
    finally:
        moe.route = route
    if next(calls, None) is not None:
        raise AssertionError("pinned routing: fewer MoE calls than the "
                             "float32 run made")


@contextlib.contextmanager
def captured_flash(K):
    """The last ``flash_attention_cuda`` launch made inside, its inputs and
    output cut to its first query heads (``FLASH_CHECK_HEADS``, rounded to
    whole KV groups) and kept, for the plain version to check after the run
    at the main path's own shape and data; the launch is the path's own
    (the wrapper counts it), none is added."""
    ops, wrapper = K.ops, K.ops.flash_attention_cuda
    seen = {"launches": 0}

    def spy(q, k, v, causal=True, window=None):
        out = wrapper(q, k, v, causal, window)
        g = q.shape[0] // k.shape[0]
        n_kv = max(1, FLASH_CHECK_HEADS // g)
        seen.update(q=q[:n_kv * g].clone(), k=k[:n_kv].clone(),
                    v=v[:n_kv].clone(), out=out[:n_kv * g].clone(),
                    causal=causal, window=window, group=g,
                    shape=tuple(q.shape), launches=seen["launches"] + 1)
        return out

    ops.flash_attention_cuda = spy
    try:
        yield seen
    finally:
        ops.flash_attention_cuda = wrapper


def check_captured_flash(torch, K, seen, what):
    """The captured launch's query heads against the plain version:
    every output row within FLASH_BF16_ROW_RTOL of its largest value, and
    within FLASH_BF16_ATOL x max(1, rms of v) absolute (phase 3's bound is
    for unit-normal v; an output is a convex mix of v's rows)."""
    q, k, v, out = (seen[n] for n in ("q", "k", "v", "out"))
    want = K.fa.flash_attention_plain(q, k, v, seen["causal"],
                                      window=seen["window"])
    err = float((out.float() - want.float()).abs().max())
    rel = row_rel_err(out, want)
    v_rms = float(v.float().square().mean().sqrt())
    atol = FLASH_BF16_ATOL * max(1.0, v_rms)
    del want
    where = (f"the last of {seen['launches']} launches, (BH, S, dh) "
             f"{seen['shape']}, G {seen['group']}, "
             f"{'causal' if seen['causal'] else 'full'}"
             + (f", window {seen['window']}" if seen["window"] else "")
             + ", query heads 0.."
             f"{q.shape[0] - 1}")
    if (err > atol or rel > FLASH_BF16_ROW_RTOL
            or not bool(torch.isfinite(out).all())):
        raise AssertionError(f"{what}: flash_attention at {where} against "
                             f"the plain version: max abs err {err} (bound "
                             f"{atol}), row rel err {rel} (bound "
                             f"{FLASH_BF16_ROW_RTOL})")
    return (f"flash_attention at {where}: within {err:.3e} (max abs, bound "
            f"{atol:.3e}, rms of v {v_rms:.3g}) and {rel:.3e} (row, bound "
            f"{FLASH_BF16_ROW_RTOL}) of the plain version")


def _first_flip(torch, a, b, rows, cols):
    """Per row, the first position whose expert set differs between two
    runs' routing (``cols`` when none): from there on a token's output, and
    through attention every later one's, may differ by a whole expert.
    ``a``, ``b``: the (rows * cols, k) experts of each MoE layer, tokens in
    (row, position) order."""
    first = torch.full((rows,), cols, dtype=torch.long, device="cuda")
    for ea, eb in zip(a, b):
        diff = (ea.sort(-1).values != eb.sort(-1).values).any(-1)
        diff = diff.view(rows, -1)
        pos = torch.arange(diff.shape[1], device="cuda").expand_as(diff)
        first = torch.minimum(first, torch.where(
            diff, pos, cols).min(-1).values)
    return first


def _masked_rel(a, b, first):
    """max |a - b| / max |b| over each row's positions before ``first``."""
    err = scale = 0.0
    for r in range(a.shape[0]):
        n = int(first[r])
        if n:
            err = max(err, float((a[r, :n] - b[r, :n]).abs().max()))
            scale = max(scale, float(b[r, :n].abs().max()))
    return err / scale if scale else float("nan")


def _float32_checks(torch, K, cfg, params, n_img_check):
    """At published widths in float32: the prefill through the kernel
    against the oracle's attention (one row of FAMILY_CHECK_SEQ positions,
    within 1e-4 before the first token whose experts differ between the
    two), decode against forward (path E's 2e-3 over 2 x 12 steps, the MoE
    capacity raised until nothing drops) and the MoE routing tables on the
    card against the host's.  Returns the kernel route's logits at the
    check batch (the float32 logits the bf16 routes are held to) and the
    experts each of its MoE calls picked."""
    M = K.lm_model
    n_text = FAMILY_CHECK_SEQ - n_img_check
    batch = _family_batch(torch, cfg, 1, n_text, n_img_check, 5)
    before = launch_counts(K)
    with record_routing(K) as kern_calls:
        f32 = M.forward(params, batch, cfg)
    with record_routing(K) as ref_calls:
        ref = M.forward(params, batch, cfg, attn_impl="ref")
    expect_launches(K, before, {"flash_attention": cfg.n_layers},
                    f"{cfg.name} float32 prefill (kernel, then oracle)")
    first = _first_flip(torch, [e for _, e in kern_calls],
                        [e for _, e in ref_calls], 1, f32.shape[1])
    rel = _masked_rel(f32, ref, first)
    if not (rel <= 1e-4 and int(first.min()) >= f32.shape[1] // 4):
        raise AssertionError(f"{cfg.name} float32 prefill: kernel route "
                             f"{rel} from the oracle's over the first "
                             f"{first.tolist()} positions (bound 1e-4, at "
                             f"least a quarter of them)")
    del ref
    notes = [f"float32 prefill 1 x {f32.shape[1]}: kernel route within "
             f"{rel:.3e} of the oracle's attention (bound 1e-4) over "
             f"{int(first.min())} positions before the first routing "
             f"difference"]
    if cfg.moe is not None:
        notes.append(_routing_tables(torch, K, cfg, params, kern_calls))
    experts = [e for _, e in kern_calls]
    del kern_calls, ref_calls

    if not cfg.encoder_only:
        cfg_nd = _no_drop(cfg)
        tok = _lm_tokens(torch, cfg, (LM_DECODE_BATCH, LM_DECODE_STEPS), 6)
        with record_routing(K) as fwd_calls:
            fwd = M.forward(params, {"tokens": tok}, cfg_nd)
        with record_routing(K) as dec_calls:
            dec = _decode_logits(torch, M, cfg_nd, params, tok,
                                 LM_DECODE_STEPS + 2)
        n_moe = len(fwd_calls)
        per_layer = [[dec_calls[s * n_moe + i][1]
                      for s in range(LM_DECODE_STEPS)] for i in range(n_moe)]
        first = _first_flip(torch, [e for _, e in fwd_calls],
                            [torch.stack(p, 1).reshape(-1, p[0].shape[-1])
                             for p in per_layer],
                            LM_DECODE_BATCH, LM_DECODE_STEPS)
        rel = _masked_rel(dec, fwd, first)
        if not (rel < 2e-3 and int(first.min()) >= LM_DECODE_STEPS // 2):
            raise AssertionError(f"{cfg.name} float32 decode against forward:"
                                 f" rel err {rel} over the first "
                                 f"{first.tolist()} steps (bound 2e-3)")
        notes.append(f"float32 decode ({LM_DECODE_BATCH} x "
                     f"{LM_DECODE_STEPS} steps{', capacity raised until '
                     'nothing drops' if cfg.moe else ''}) within {rel:.3e} "
                     f"of the forward (bound 2e-3) over "
                     f"{first.tolist()} steps")
        del fwd, dec, fwd_calls, dec_calls
    log("  " + "; ".join(notes))
    return f32, experts


def _routing_tables(torch, K, cfg, params, calls):
    """The top-k selection and dispatch of the first MoE layer on the card
    against the host's, bit for bit, from the same float32 scores: at the
    check prefill's tokens (the published capacity factor, and 1.0) and at
    decode's 4; at least one expert must overflow."""
    moe, mo = K.moe, cfg.moe
    router = {k: v[0] for k, v in params["layers"]["moe"]["router"].items()}
    x32 = calls[0][0]
    overflow = []
    for t, cf in ((x32.shape[0], None), (x32.shape[0], 1.0), (4, None)):
        s = moe.scores({"router": router}, x32[:t], mo)
        cap = moe.capacity(t, mo, cf)
        card = moe.select({"router": router}, s, mo)
        host = moe.select({"router": {k: v.cpu() for k, v in
                                      router.items()}}, s.cpu(), mo)
        tables_c = moe.dispatch(*card, mo.n_experts, cap)
        tables_h = moe.dispatch(*host, mo.n_experts, cap)
        for c, h in zip(card + tables_c, host + tables_h):
            if not torch.equal(c.cpu(), h):
                raise AssertionError(f"{cfg.name} routing at {t} tokens: the "
                                     f"card's tables differ from the host's")
        counts = torch.bincount(host[1].reshape(-1), minlength=mo.n_experts)
        overflow.append((t, cap, int((counts > cap).sum())))
    if not any(n for _, _, n in overflow):
        raise AssertionError(f"{cfg.name} routing: no expert overflowed")
    return ("routing tables (experts, weights, slot_token, token_slots, "
            "token_weights) on the card equal the host's bit for bit at "
            + ", ".join(f"{t} tokens (capacity {c}, {n} experts overflow)"
                        for t, c, n in overflow))


def _gated_mlps(cfg):
    """pwl_activation launches per decode step at the pwl4 gate: one per
    gated MLP or expert stack (silu only), two per Mamba2 layer (its SiLU
    gates) and two per RWKV-6 layer (its SiLU gate and receptance)."""
    if cfg.block_pattern == "rwkv":
        return 2 * cfg.n_layers
    if cfg.block_pattern == "mamba_hybrid":
        n_shared, n_mamba = cfg._layer_split()
        return 2 * n_mamba + (n_shared if cfg.activation == "silu" else 0)
    if cfg.activation != "silu":
        return 0
    if cfg.moe is None:
        return cfg.n_layers
    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    return cfg.moe.first_k_dense + n_moe * (1 + bool(cfg.moe.n_shared))


def family_run(torch, K, arch, n_layers, prefill, n_img, decode):
    """One model of path I (see :func:`main_path_families`)."""
    M = K.lm_model
    start = launch_counts(K)
    cfg = _family_cfg(K, arch, n_layers)
    cut = (f"depth {cfg.n_layers} of {K.configs.get_config(arch).n_layers} "
           f"layers" if n_layers else "full depth")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = M.init_params(cfg32, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    log(f"phase 4I {arch}: {cut}, published widths (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV, "
        + (f"MLA q/k {cfg.mla.qk_nope_head_dim} + {cfg.mla.qk_rope_head_dim}"
           f", v {cfg.mla.v_head_dim}" if cfg.mla else f"dh {cfg.head_dim}")
        + (f", {cfg.moe.n_experts} experts top {cfg.moe.top_k} d_ff "
           f"{cfg.moe.d_ff_expert}, {cfg.moe.first_k_dense} dense layers, "
           f"{cfg.moe.n_shared} shared" if cfg.moe else f", d_ff {cfg.d_ff}")
        + f", vocab {cfg.vocab_size}): {n_params} seeded float32 parameters "
        f"in {time.perf_counter() - t0:.1f} s")
    n_img_check = FAMILY_CHECK_SEQ // 4 if n_img else 0
    f32_logits, f32_experts = _float32_checks(torch, K, cfg32, params,
                                              n_img_check)

    M.cast_params_(params, torch.bfloat16)
    torch.cuda.empty_cache()
    check = _family_batch(torch, cfg, 1, FAMILY_CHECK_SEQ - n_img_check,
                          n_img_check, 5)
    # a MoE layer's top-k flips wherever bf16 rounding moves a score past a
    # neighbour's; both bf16 routes take the float32 run's experts, so they
    # part from it by rounding only, at all FAMILY_CHECK_SEQ positions
    pin = ((lambda: pinned_routing(K, f32_experts)) if cfg.moe else
           contextlib.nullcontext)
    with pin():
        bf16 = M.forward(params, check, cfg)
    with pin():
        plain = M.forward(params, check, cfg, attn_impl="ref")
    rel_k, rel_o = _rel_err(bf16, f32_logits), _rel_err(plain, f32_logits)
    del bf16, plain, f32_logits, f32_experts
    if not rel_k <= 1.5 * rel_o:
        raise AssertionError(f"{arch} bf16 prefill: kernel route {rel_k} from "
                             f"the float32 logits, over 1.5 x the oracle "
                             f"route's {rel_o}")
    log(f"  bf16 prefill 1 x {FAMILY_CHECK_SEQ}"
        + (" (both routes on the float32 run's experts)" if cfg.moe else "")
        + f": kernel route {rel_k:.3e}, oracle route {rel_o:.3e} from the "
        f"float32 logits (bound 1.5x the oracle's)")

    b, s = prefill
    batch = _family_batch(torch, cfg, b, s, n_img, 7)
    s_total = s + n_img
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts(K)
    t0 = time.perf_counter()
    with captured_flash(K) as seen:
        logits = M.forward(params, batch, cfg)
        torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    expect_launches(K, before, {"flash_attention": cfg.n_layers},
                    f"{arch} bf16 prefill")
    if (logits.shape != (b, s_total, cfg.vocab_size)
            or logits.dtype != torch.float32
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{arch} prefill logits {logits.dtype}"
                             f"{tuple(logits.shape)} not finite float32 of "
                             f"the expected shape")
    del logits
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("  bf16 prefill " + check_captured_flash(torch, K, seen,
                                                 f"{arch} bf16 prefill"))
    del seen
    fwd = lambda: M.forward(params, batch, cfg)  # noqa: E731
    ms, host_ms = cuda_ms(torch, fwd, 2)
    prof = _kernel_profile(torch, fwd)
    dev_ms = sum(prof["by_kind"].values())
    shape = K.configs.ShapeSpec("i", s_total, b, "prefill")
    one = dict(chips=1, tp=1, dp_in_pod=1, pods=1, microbatches=1)
    cost = K.roofline.analytic_cost(cfg, shape, **one)
    bound_ms = max(cost.flops_global / BF16_TENSOR_OPS_PER_S,
                   cost.hbm_bytes_global / HBM_BYTES_PER_S) * 1e3
    top = sorted(prof["device_ms"].items(), key=lambda kv: -kv[1])[:4]
    log(f"  bf16 prefill {b} x {s_total}"
        + (f" ({n_img} image embeddings + {s} tokens)" if n_img else "")
        + f": {cfg.n_layers} flash_attention launches, first call "
        f"{t_first:.2f} s; {ms:.2f} ms ({host_ms:.2f} ms host); peak memory "
        f"{peak:.2f} GiB; bound {bound_ms:.3f} ms "
        f"({cost.flops_global / 1e12:.2f} Tflop at the bf16 rate, "
        f"analytic_cost); device time by kind "
        "(torch.profiler): " + ", ".join(
            f"{k} {v:.2f} ms ({v / dev_ms:.1%})"
            for k, v in prof["by_kind"].items())
        + f"; {prof['launches']} launches, idle "
        f"{max(0.0, 1 - dev_ms / ms):.1%} of the {ms:.2f} ms (the profiled "
        f"call's wall {prof['wall_ms']:.2f} ms); top kernels "
        + "; ".join(f"{n[:60]} {v:.2f} ms" for n, v in top))
    del batch, fwd

    record = dict(prefill_ms=ms, device_ms=dev_ms, bound_ms=bound_ms,
                  peak_gib=peak, launches=prof["launches"],
                  flash_device_ms=prof["by_kind"]["flash_attention"])
    if decode is not None:
        record["decode"] = family_decode(torch, K, cfg, params, decode,
                                         arch == FAMILY_QUANT)
    record["flash_launches"] = (launch_counts(K)["flash_attention"]
                                - start["flash_attention"])
    del params
    torch.cuda.empty_cache()
    return record


def family_decode(torch, K, cfg, params, decode, quantized):
    """``generate`` through an InferenceService at flt (and, when asked,
    fxp8/qnm/int8-KV/pwl4): no flash_attention launch, one silu_pwl4 per
    gated MLP or expert stack a step, tokens in the vocabulary."""
    b, n = decode
    targets = {"flt": K.tc.Target(number_format="flt")}
    if quantized:
        targets["fxp8_qnm_kv8_pwl4"] = K.tc.Target(
            number_format="fxp8", weight_scale="qnm", kv_cache="int8",
            sigmoid="pwl4")
    start = np.random.RandomState(2).randint(1, cfg.vocab_size,
                                             (b,)).astype(np.int32)
    out = {}
    svc = K.serve.InferenceService()
    try:
        for name, target in targets.items():
            t0 = time.perf_counter()
            art = svc.register(name, K.tc.LMModel(cfg, params),
                               target).artifact
            t_reg = time.perf_counter() - t0
            acfg = art.extras["cfg"]
            svc.generate(name, start, 2)  # warm-up: allocations
            per_step = _gated_mlps(acfg) if acfg.gate_sigmoid == "pwl4" else 0
            before = launch_counts(K)
            t0 = time.perf_counter()
            seqs = svc.generate(name, start, n)
            ms_tok = (time.perf_counter() - t0) * 1e3 / n
            expect_launches(K, before, {"pwl_activation": per_step * n}
                            if per_step else {}, f"{cfg.name} generate at "
                            f"{name}")
            if (seqs.shape != (b, n + 1) or seqs.min() < 0
                    or seqs.max() >= cfg.vocab_size
                    or not np.array_equal(seqs[:, 0], start)):
                raise AssertionError(f"{cfg.name} generate at {name}: "
                                     f"{seqs.dtype}{seqs.shape}")
            cache = art.extras["init_cache"](1, 2)
            layout = {k: (str(v.dtype).replace("torch.", ""),
                          tuple(v.shape[-1:]))
                      for key in ("layers", "shared_attn", "groups")
                      for k, v in cache.get(key, {}).items()}
            if quantized and name != "flt" and cfg.mla is not None and (
                    layout.get("c_kv_q", ("",))[0] != "int8"):
                raise AssertionError(f"{cfg.name} at {name}: the latent "
                                     f"cache is {layout}, not int8")
            out[name] = ms_tok
            log(f"  decode {name}: registered in {t_reg:.1f} s; generate "
                f"batch {b} x {n} tokens: {ms_tok:.2f} ms/token, no "
                f"flash_attention launch, {per_step} pwl_activation "
                f"(silu_pwl4) a step; cache {layout}; weights "
                f"{art.memory_report()['flash']} bytes "
                f"({art.extras['quantized_bytes']} quantized); sample "
                f"{seqs[0, :8].tolist()}")
            del art
    finally:
        svc.close()
    return out


def main_path_families(torch, K):
    """Main path I: the rest of the attention family at published widths,
    one model at a time (each freed before the next), seeded weights: the
    depth cuts and traffic of FAMILY_RUNS.  For each model: float32 checks
    at one row of FAMILY_CHECK_SEQ positions (the kernel route against the
    oracle's attention within 1e-4; decode against forward within 2e-3;
    the MoE routing tables on the card equal to the host's), the bf16 routes
    against those float32 logits (the kernel route within 1.5x the oracle
    route's distance, path E's bound; MoE on the float32 run's experts),
    then the bf16 prefill at the model's traffic with one flash_attention
    launch per layer (MLA on the dh-192 instance; the last launch's first
    heads against the plain version), profiled, and decode through an
    InferenceService."""
    reset_launches(K)
    records = {}
    for run in FAMILY_RUNS:
        t0 = time.perf_counter()
        records[run[0]] = family_run(torch, K, *run)
        log(f"  {run[0]} took {time.perf_counter() - t0:.1f} s")
    launches = launch_counts(K)
    if launches["flash_attention"] == 0:
        raise AssertionError("main path I never launched flash_attention")
    log(f"  kernel launches on path I: {launches}")
    return launches, records


# --------------------------------------------------------------------------
# phase 4J: the recurrent half of the LM stack (the Mamba2 hybrid, RWKV-6)
# at published widths, depth cut
# --------------------------------------------------------------------------
# (arch, layers kept, bf16 prefill (batch, tokens), tokens of the float32
# kernel-vs-oracle prefill check or None for a model without attention, the
# dtype in which decode is held to forward).  The depth is cut (from 81
# and 24 layers) to keep the whole run near its time: every check stays,
# and path L6 runs the same shapes on a mesh.
RECURRENT_RUNS = (
    # 4 groups of 5 Mamba2 layers, each with the shared block, then a tail
    # of 1; S 8192 is twice the shared block's window of 4096; the float32
    # check at 6144 also runs past it
    ("zamba2-7b", 25, (2, 8192), 6144, "float32"),
    # launch-bound by its WKV loop: 2048 steps a layer.  Its float32 decode
    # and forward part by rounding that the layers amplify (~4e-3 of the
    # largest logit at the full 24; in float64 the two agree to float64
    # rounding: tests/test_torch_rwkv6.py), so decode is held to forward in
    # float64
    ("rwkv6-1.6b", 8, (4, 2048), None, "float64"),
)
RECURRENT_DECODE_STEPS = 64  # float32 decode against forward, batch 1
RECURRENT_DECODE = (4, 32)  # generate at flt and fxp8/qnm/int8-KV/pwl4
RECURRENT_TRAIN = dict(steps=3, batch=2, seq=64, every=3, lr=1e-3)


def recurrent_run(torch, K, arch, n_layers, prefill, check_seq,
                  decode_dtype):
    """One model of path J (see :func:`main_path_recurrent`)."""
    M = K.lm_model
    start = launch_counts(K)
    cfg = _family_cfg(K, arch, n_layers)
    n_flash = cfg._layer_split()[0]  # zamba2's shared-block calls; rwkv 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = M.init_params(cfg32, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    log(f"phase 4J {arch}: depth {cfg.n_layers} of "
        f"{K.configs.get_config(arch).n_layers} layers, published "
        f"widths (d_model {cfg.d_model}, {cfg.n_heads} heads, dh "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
        + (f"; Mamba2 d_state {cfg.ssm.d_state}, expand {cfg.ssm.expand}, "
           f"head_dim {cfg.ssm.head_dim}, {cfg.ssm.n_groups} groups, chunk "
           f"{cfg.ssm.chunk}; {n_flash} shared-block calls, window "
           f"{cfg.sliding_window}" if cfg.ssm else "")
        + f"): {n_params} seeded float32 parameters in "
        f"{time.perf_counter() - t0:.1f} s")

    notes = []
    if check_seq:
        batch = {"tokens": _lm_tokens(torch, cfg, (1, check_seq), 5)}
        before = launch_counts(K)
        f32 = M.forward(params, batch, cfg32)
        ref = M.forward(params, batch, cfg32, attn_impl="ref")
        expect_launches(K, before, {"flash_attention": n_flash},
                        f"{arch} float32 prefill (kernel, then oracle)")
        rel = _rel_err(f32, ref)
        del f32, ref
        if not rel <= 1e-4:
            raise AssertionError(f"{arch} float32 prefill 1 x {check_seq}: "
                                 f"kernel route {rel} from the oracle's "
                                 f"attention (bound 1e-4)")
        notes.append(f"float32 prefill 1 x {check_seq}: kernel route "
                     f"({n_flash} windowed launches) within {rel:.3e} of the "
                     f"oracle's attention (bound 1e-4)")
    tok = _lm_tokens(torch, cfg, (1, RECURRENT_DECODE_STEPS), 6)
    fwd = M.forward(params, {"tokens": tok}, cfg32)
    t0 = time.perf_counter()
    dec = _decode_logits(torch, M, cfg32, params, tok,
                         RECURRENT_DECODE_STEPS + 2)
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) * 1e3 / RECURRENT_DECODE_STEPS
    rel = _rel_err(dec, fwd)
    del fwd, dec
    if decode_dtype == "float32" and not rel < 2e-3:
        raise AssertionError(f"{arch} float32 decode against forward: rel err "
                             f"{rel} (bound 2e-3)")
    notes.append(f"float32 decode 1 x {RECURRENT_DECODE_STEPS} steps "
                 f"{rel:.3e} from the forward"
                 + (" (bound 2e-3)" if decode_dtype == "float32" else "")
                 + f", {t_dec:.1f} ms/step")
    if decode_dtype == "float64":
        p64 = _tree_map(lambda t: t.to(torch.float64)
                        if t.is_floating_point() else t, params)
        cfg64 = dataclasses.replace(cfg, dtype="float64")
        fwd = M.forward(p64, {"tokens": tok}, cfg64)
        dec = _decode_logits(torch, M, cfg64, p64, tok,
                             RECURRENT_DECODE_STEPS + 2)
        rel = _rel_err(dec, fwd)
        del p64, fwd, dec
        torch.cuda.empty_cache()
        if not rel <= 1e-6:
            raise AssertionError(f"{arch} float64 decode against forward: rel "
                                 f"err {rel} (bound 1e-6)")
        notes.append(f"float64 (the same weights): decode within {rel:.3e} of "
                     f"the forward (bound 1e-6; the logits rounded to "
                     f"float32)")
    log("  " + "; ".join(notes))

    M.cast_params_(params, torch.bfloat16)  # the float32 leaves stay
    torch.cuda.empty_cache()
    b, s = prefill
    batch = {"tokens": _lm_tokens(torch, cfg, (b, s), 7)}
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts(K)
    t0 = time.perf_counter()
    with captured_flash(K) as seen:
        logits = M.forward(params, batch, cfg)
        torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    expect_launches(K, before, {"flash_attention": n_flash},
                    f"{arch} bf16 prefill")
    if (logits.shape != (b, s, cfg.vocab_size)
            or logits.dtype != torch.float32
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{arch} prefill logits {logits.dtype}"
                             f"{tuple(logits.shape)} not finite float32 of "
                             f"the expected shape")
    del logits
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if n_flash:
        if seen["window"] != cfg.sliding_window:
            raise AssertionError(f"{arch}: the shared block launched with "
                                 f"window {seen['window']}")
        log("  bf16 prefill " + check_captured_flash(torch, K, seen,
                                                     f"{arch} bf16 prefill"))
    del seen
    fwd = lambda: M.forward(params, batch, cfg)  # noqa: E731
    ms, host_ms = cuda_ms(torch, fwd, 2)
    # rwkv6's WKV loop makes ~10^5 launches a forward: its trace without
    # aten op events is minutes shorter to read, and path J reads no op
    prof = _kernel_profile(torch, fwd, cpu=False)
    if not prof["launches"]:  # no runtime events: count the kernels run
        prof["launches"] = prof["activities"]
    dev_ms = sum(prof["by_kind"].values())
    one = dict(chips=1, tp=1, dp_in_pod=1, pods=1, microbatches=1)
    cost = K.roofline.analytic_cost(
        cfg, K.configs.ShapeSpec("j", s, b, "prefill"), **one)
    bound_ms = max(cost.flops_global / BF16_TENSOR_OPS_PER_S,
                   cost.hbm_bytes_global / HBM_BYTES_PER_S) * 1e3
    top = sorted(prof["device_ms"].items(), key=lambda kv: -kv[1])[:4]
    log(f"  bf16 prefill {b} x {s}: {n_flash} flash_attention launches, "
        f"first call {t_first:.2f} s; {ms:.2f} ms ({host_ms:.2f} ms host); "
        f"peak memory {peak:.2f} GiB; bound {bound_ms:.3f} ms "
        f"({cost.flops_global / 1e12:.2f} Tflop at the bf16 rate, "
        f"analytic_cost); device time by kind (torch.profiler): "
        + ", ".join(f"{k} {v:.2f} ms ({v / dev_ms:.1%})"
                    for k, v in prof["by_kind"].items())
        + f"; {prof['launches']} launches, idle "
        f"{max(0.0, 1 - dev_ms / ms):.1%} of the {ms:.2f} ms (the profiled "
        f"call's wall {prof['wall_ms']:.2f} ms); top kernels "
        + "; ".join(f"{n[:60]} {v:.2f} ms" for n, v in top))
    del batch, fwd
    record = dict(prefill_ms=ms, device_ms=dev_ms, bound_ms=bound_ms,
                  peak_gib=peak, launches=prof["launches"],
                  flash_device_ms=prof["by_kind"]["flash_attention"],
                  by_kind=prof["by_kind"])
    record["decode"] = family_decode(torch, K, cfg, params, RECURRENT_DECODE,
                                     True)
    record["flash_launches"] = (launch_counts(K)["flash_attention"]
                                - start["flash_attention"])
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    first, last, _ = _run_train_cli(
        os.path.join(ROOT, "build", "recurrent_ckpt", arch), arch=arch,
        what=f"J {arch}", **RECURRENT_TRAIN)
    if not (math.isfinite(first) and math.isfinite(last)):
        raise AssertionError(f"J {arch}: launch/train.py losses {first}, "
                             f"{last}")
    log(f"  launch/train.py --arch {arch} (reduced) --steps "
        f"{RECURRENT_TRAIN['steps']} --batch {RECURRENT_TRAIN['batch']} "
        f"--seq {RECURRENT_TRAIN['seq']} on the card in "
        f"{time.perf_counter() - t0:.1f} s: loss {first:.4f} -> {last:.4f}")
    return record


def main_path_recurrent(torch, K):
    """Main path J: the recurrent half of the LM stack at published widths,
    depth cut, one model at a time (each freed before the next),
    seeded weights.  For each model: float32 checks (zamba2's kernel route
    within 1e-4 of the oracle's attention at 1 x 6144, past its window;
    decode against forward over 1 x 64 steps within 2e-3; rwkv6's decode
    against forward in float64 within 1e-6, the float32 distance printed:
    see RECURRENT_RUNS), then the bf16
    prefill (zamba2 2 x 8192: one windowed flash_attention launch per
    shared-block call, the last held to the plain version on its first
    heads; rwkv6 4 x 2048), profiled; ``generate`` through an
    InferenceService at flt and fxp8/qnm/int8-KV/pwl4 (two pwl_activation
    launches a Mamba2 or RWKV layer a step there); and launch/train.py at
    the reduced config for three steps."""
    reset_launches(K)
    records = {}
    for run in RECURRENT_RUNS:
        t0 = time.perf_counter()
        records[run[0]] = recurrent_run(torch, K, *run)
        log(f"  {run[0]} took {time.perf_counter() - t0:.1f} s")
    launches = launch_counts(K)
    if launches["flash_attention"] == 0 or launches["pwl_activation"] == 0:
        raise AssertionError(f"main path J launched {launches}")
    log(f"  kernel launches on path J: {launches}")
    return launches, records


# --------------------------------------------------------------------------
# phase 4K: data-parallel classifier serving over a device mesh (spmd over
# the cards, fused over a host mesh with replica health, the serving plane
# and --dp)
# --------------------------------------------------------------------------
# (key in arts_a / arts_b, kernel): D6's MLP at fxp16 and auto8, the
# logistic at fxp16, the depth-12 tree and the rbf SVM at fxp16
MESH_ARTS = ((("mlp", "fxp16"), "fxp_mlp_model"),
             (("mlp", "auto8"), "fxp_mlp_model"),
             (("logistic", "fxp16"), "fxp_layer"),
             (("tree", "D6", "fxp16"), "tree_ensemble"),
             (("svm-rbf", "D6", "fxp16"), "fxp_svm_model"))
MESH_BATCHES = (1, 3, 64, 3089, 65536)
MESH_TIMED = (3089, 65536)
MESH_HOST_REPLICAS = 4
MESH_FIXED_BATCH = 64
MESH_REQUEST_ROWS = (1, 16, 256)
MESH_CLIENTS = 8


def _mesh_predicts(K, sharded, single, x, batches, per_call, what):
    """Each batch through the mesh artifact: labels and stats equal to the
    single-device artifact's bit for bit, ``per_call`` launches of the
    kernel a predict (twice that on the wrapper's first padded call, which
    runs its pad-row probe)."""
    name, n = per_call
    probed = False
    for b in batches:
        padded = K.sharding.replica_bucket(b, sharded.replicas)[1] > b
        want = n * (2 if padded and not probed else 1)
        probed = probed or padded
        before = launch_counts(K)
        got = sharded.predict_with_stats(x[:b])
        expect_launches(K, before, {name: want}, f"{what} batch {b}")
        ref = single.predict_with_stats(x[:b])
        if not np.array_equal(got[0], ref[0]) or got[1] != ref[1]:
            raise AssertionError(
                f"{what} batch {b}: {int((got[0] != ref[0]).sum())} labels "
                f"differ, stats {got[1]} vs {ref[1]}")


def _per_device_launches(torch, sharded, x, kernel):
    """The devices whose trace holds the kernel in one predict (spmd on two
    or more cards: each replica's launch on its own card)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sharded.predict(x)
        torch.cuda.synchronize()
    return sorted({e.device_index for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and kernel in e.name})


def _mesh_times(torch, sharded, single, x, what):
    """predict ms (host clock, labels on the host) of the mesh artifact
    beside the single-device artifact, in turns, at MESH_TIMED rows."""
    for b in MESH_TIMED:
        times = {"single": [], "mesh": []}
        for _ in range(6):
            for side in ("single", "mesh", "mesh", "single"):
                art = single if side == "single" else sharded
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                art.predict(x[:b])
                times[side].append((time.perf_counter() - t0) * 1e3)
        med = {k: float(np.median(v)) for k, v in times.items()}
        log(f"  4K {what} predict at {b} rows: mesh {med['mesh']:.4f} ms, "
            f"single {med['single']:.4f} ms (median of 12 in turns; "
            f"{med['mesh'] / med['single']:.3f}x)")


def mesh_spmd(torch, K, dev, arts, x):
    """K1: spmd over make_serving_mesh() (every visible card)."""
    mesh = K.sharding.make_serving_mesh()
    replicas = K.sharding.dp_size(mesh)
    if replicas != dev.count:
        raise AssertionError(f"serving mesh of {replicas} replicas on "
                             f"{dev.count} cards")
    for key, kernel in MESH_ARTS:
        single = arts[key]
        sharded = single.specialize_mesh(mesh)
        what = f"K1 spmd {' '.join(key)} x{replicas}"
        if sharded.mesh_strategy != "spmd" or sharded.replicas != replicas:
            raise AssertionError(f"{what}: {sharded.mesh_strategy} "
                                 f"x{sharded.replicas}")
        _mesh_predicts(K, sharded, single, x, MESH_BATCHES,
                       (kernel, replicas), what)
        _mesh_times(torch, sharded, single, x, what)
        if replicas >= 2:
            seen = _per_device_launches(torch, sharded, x[:3089], kernel)
            if seen != list(range(replicas)):
                raise AssertionError(f"{what}: {kernel} traced on devices "
                                     f"{seen}")
            log(f"  4K {what}: {kernel} traced on devices {seen}")
    if replicas < 2:
        log("  4K K1: one card, so the per-card profiler check (one replica "
            "a card) did not run")
    return mesh


def mesh_fused(torch, K, arts, x):
    """K2: fused over make_host_mesh(4) with the CUDA artifacts: untracked,
    under a mesh.replica fault plan, and at a fixed batch."""
    S = K.serve
    host = K.sharding.make_host_mesh(MESH_HOST_REPLICAS)
    for key, kernel in MESH_ARTS:
        single = arts[key]
        sharded = single.specialize_mesh(host)
        what = f"K2 fused {' '.join(key)} x{MESH_HOST_REPLICAS}"
        if sharded.mesh_strategy != "fused" or sharded.device != single.device:
            raise AssertionError(f"{what}: {sharded.mesh_strategy} on "
                                 f"{sharded.device}")
        _mesh_predicts(K, sharded, single, x, MESH_BATCHES[:4], (kernel, 1),
                       what + " untracked")
        golden = single.predict(x[:64])
        plan = S.FaultPlan([S.FaultRule(site="mesh.replica", match="0",
                                        transient=True, count=3)])
        with S.faults.inject(plan):
            for i in range(12):
                before = launch_counts(K)
                if not np.array_equal(sharded.predict(x[:64]), golden):
                    raise AssertionError(f"{what}: call {i} under the fault "
                                         f"plan changed a label")
                expect_launches(K, before, {kernel: MESH_HOST_REPLICAS},
                                f"{what} tracked call {i}")
        snap = sharded.replica_health.snapshot()
        if (snap["evictions"] < 1 or snap["probes"] < 1
                or snap["readmissions"] < 1
                or snap["healthy"] != list(range(MESH_HOST_REPLICAS))):
            raise AssertionError(f"{what}: replica health {snap}")
        log(f"  4K {what}: labels equal the single-device artifact's at "
            f"{MESH_BATCHES[:4]} rows, one launch a call; 12 calls under the "
            f"fault plan bit for bit, {MESH_HOST_REPLICAS} launches each; "
            f"health {snap}")
    model = K.models.init_mlp([561, 64, 6], seed=0)  # path A's MLP
    fixed = K.tc.compile(model, K.tc.Target(
        number_format="fxp16", backend="cuda", batch_policy="fixed",
        batch_size=MESH_FIXED_BATCH)).specialize_mesh(host)
    cap = MESH_FIXED_BATCH * MESH_HOST_REPLICAS
    if fixed.max_supported_batch != cap:
        raise AssertionError(f"K2 fixed capacity {fixed.max_supported_batch}")
    golden = arts[("mlp", "fxp16")].predict(x[:cap])
    before = launch_counts(K)
    labels = fixed.predict(x[:cap])
    expect_launches(K, before, {"fxp_mlp_model": MESH_HOST_REPLICAS},
                    "K2 fixed")
    if not np.array_equal(labels, golden):
        raise AssertionError("K2 fixed: labels differ")
    want = (f"batch {cap + 1} exceeds the mesh capacity {cap} "
            f"({MESH_HOST_REPLICAS} replicas x fixed batch_size "
            f"{MESH_FIXED_BATCH}); recompile or grow the mesh")
    try:
        fixed.predict(x[:cap + 1])
    except ValueError as e:
        if str(e) != want:
            raise AssertionError(f"K2 fixed: {e}") from e
    else:
        raise AssertionError(f"K2 fixed: {cap + 1} rows did not raise")
    log(f"  4K K2 fixed batch {MESH_FIXED_BATCH}: capacity {cap}, {cap} rows "
        f"equal in {MESH_HOST_REPLICAS} launches, {cap + 1} rows raise: "
        f"{want}")
    return host


def _mesh_clients(svc, names, x, golden):
    """MESH_CLIENTS threads send requests of MESH_REQUEST_ROWS rows in turns
    to each endpoint of ``names`` in turn (all of one endpoint's before the
    next): latencies and wall seconds by endpoint; every label must equal
    ``golden``."""
    jobs = [(k * 97 % (len(x) - 256), MESH_REQUEST_ROWS[k % 3])
            for k in range(240)]
    out = {}
    for name in names:
        lat, errors = [0.0] * len(jobs), []

        def client(c):
            try:
                for i in range(c, len(jobs), MESH_CLIENTS):
                    lo, n = jobs[i]
                    t0 = time.perf_counter()
                    got = svc.predict(name, x[lo:lo + n])
                    lat[i] = time.perf_counter() - t0
                    if not np.array_equal(got, golden[lo:lo + n]):
                        errors.append((name, lo, n))
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(MESH_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"K3 {name}: {errors[:3]}")
        out[name] = (lat, time.perf_counter() - t0, len(jobs))
    return out


def mesh_serving(torch, K, spmd_mesh, host_mesh, x):
    """K3: one InferenceService on the card with a single-device, an spmd
    and a fused endpoint of one model; K4: launch/serve.py --dp."""
    S = K.serve
    model = K.models.init_mlp([561, 64, 6], seed=0)  # path A's MLP
    target = K.tc.Target(number_format="fxp16", backend="cuda")
    svc = S.InferenceService()
    try:
        policy = S.BatchingPolicy(max_batch=256, max_wait_ms=2.0)
        ep_single = svc.register("single", model, target, policy=policy)
        ep_spmd = svc.register("spmd", model, target, mesh=spmd_mesh,
                               policy=policy)
        ep_fused = svc.register("fused", model, target, mesh=host_mesh,
                                policy=policy)
        again = svc.register("spmd_again", model, target, mesh=spmd_mesh,
                             policy=policy)
        cache = svc.stats()["_cache"]
        keys = {ep.artifact.cache_key for ep in (ep_single, ep_spmd, ep_fused)}
        if (again.artifact is not ep_spmd.artifact or cache["hits"] != 1
                or cache["misses"] != 3 or len(keys) != 3):
            raise AssertionError(f"K3 cache {cache}, {len(keys)} keys")
        if (ep_spmd.artifact.mesh_strategy, ep_fused.artifact.mesh_strategy) \
                != ("spmd", "fused"):
            raise AssertionError("K3 strategies")
        golden = ep_single.artifact.predict(x)
        runs = _mesh_clients(svc, ("single", "spmd", "fused"), x, golden)
        stats = svc.stats()
    finally:
        svc.close()
    health = stats["fused"].get("replica_health")
    if health is None or "replica_health" in stats["spmd"]:
        raise AssertionError(f"K3 replica_health: {health}")
    for name, (lat, wall, n) in runs.items():
        log(f"  4K K3 {name:6s} endpoint: {n} requests of "
            f"{MESH_REQUEST_ROWS} rows from {MESH_CLIENTS} threads, every "
            f"label equal to the single-device artifact's: "
            f"{_latency_line(lat, wall, n)}")
    log(f"  4K K3 cache {stats['_cache']}; fused replica_health {health}")


def mesh_cli(K, dev):
    """K4: launch/serve.py --classifier mlp --dp <cards> serves; --dp
    <cards + 1> raises make_serving_mesh's error."""
    import io
    from repro_torch.launch import serve as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--classifier", "mlp", "--dp", str(dev.count),
                  "--requests", "256"])
    text = out.getvalue()
    want = (f"replicas={dev.count} (spmd)" if dev.count > 1
            else "replicas=1,")
    if want not in text or "256 rows:" not in text:
        raise AssertionError(f"K4 --dp {dev.count}: {text}")
    log("  4K K4 --dp {}: {}".format(dev.count, " | ".join(
        text.strip().splitlines())))
    n = dev.count + 1
    try:
        cli.main(["--classifier", "mlp", "--dp", str(n)])
    except ValueError as e:
        if f"requested {n} devices but only {dev.count} are available" \
                not in str(e):
            raise AssertionError(f"K4 --dp {n}: {e}") from e
        log(f"  4K K4 --dp {n} raises: {e}")
    else:
        raise AssertionError(f"K4 --dp {n} did not raise")


def main_path_mesh(torch, K, dev, d6, arts_a, arts_b):
    """Main path K: the classifier artifacts of paths A and B served
    data-parallel over meshes (K1 spmd on the cards, K2 fused on a host
    mesh with replica health, K3 the serving plane, K4 --dp)."""
    arts = {**arts_a, **arts_b}
    x = np.resize(d6.x_test, (max(MESH_BATCHES), d6.x_test.shape[1]))
    reset_launches(K)
    t0 = time.perf_counter()
    spmd_mesh = mesh_spmd(torch, K, dev, arts, x)
    host_mesh = mesh_fused(torch, K, arts, x)
    mesh_serving(torch, K, spmd_mesh, host_mesh, d6.x_test)
    mesh_cli(K, dev)
    launches = launch_counts(K)
    for _, kernel in MESH_ARTS:
        if launches[kernel] == 0:
            raise AssertionError(f"main path K never launched {kernel}")
    log(f"phase 4K: mesh path in {time.perf_counter() - t0:.1f} s; kernel "
        f"launches {launches}")
    return launches


# --------------------------------------------------------------------------
# phase 4L: the LM on a device mesh (DTensor, one process a card)
# --------------------------------------------------------------------------
MESH_TRAIN_F32_STEPS = 3  # L2: float32 steps held to the single-device step
MESH_STEP_RTOL = 1e-4  # L2/L3: loss and grad norm against the single device
MESH_DECODE = (4, 8)  # L4: float32 serve_step (batch, steps)
MESH_DECODE_RTOL = 2e-3  # path E's decode tolerance
ELASTIC_BATCH = (8, 16)  # L3 through the files: tests/test_elastic.py's
ELASTIC_DIR = os.path.join(ROOT, "build", "elastic_ckpt")
DRYRUN_CELLS = 31  # tests/test_archs.py:103-113: runnable cells a mesh


def dryrun_plans(torch, K):
    """L1: the dry run (``launch/dryrun.py``) plans every runnable cell on
    ``pod`` and ``multipod`` and qwen2-0.5b's train_4k on dp64tp4; each
    cell's argument bytes a device against this card's memory (a cell over
    it is a finding, printed as such), its dominant roofline term and its
    plan time."""
    from repro_torch.launch import dryrun

    card = torch.cuda.get_device_properties(0).total_memory
    cells = [(m, a, s) for m in ("pod", "multipod")
             for a in K.configs.ARCH_IDS for s in K.configs.SHAPES]
    cells.append(("dp64tp4", LM_ARCH, "train_4k"))
    planned = {"pod": 0, "multipod": 0, "dp64tp4": 0}
    over = []
    t0 = time.perf_counter()
    for mesh, arch, shape in cells:
        rec = dryrun.run_cell(arch, shape, mesh, verbose=False)
        if rec["status"] != "run":
            continue
        planned[mesh] += 1
        arg = rec["memory_analysis"]["argument_size_in_bytes"]
        fits = arg <= card
        if not fits:
            over.append(f"{arch} {shape} {mesh}")
        log(f"  4L1 {arch} x {shape} x {mesh}: {arg} argument bytes a "
            f"device ({arg / card:.1%} of this card's {card}: "
            f"{'fits' if fits else 'DOES NOT FIT one card'}), dominant "
            f"{rec['roofline']['dominant']}, plan {rec['plan_s']:.4f} s")
    if planned != {"pod": DRYRUN_CELLS, "multipod": DRYRUN_CELLS,
                   "dp64tp4": 1}:
        raise AssertionError(f"L1: planned {planned}, expected "
                             f"{DRYRUN_CELLS} on pod and on multipod")
    log(f"  4L1: planned {planned} in {time.perf_counter() - t0:.1f} s; "
        f"{len(over)} cells over one card's memory: {over}")
    return planned


def card_mesh(torch, K, shape):
    """A ('data', 'model') mesh over the first prod(shape) cards."""
    n = int(np.prod(shape))
    devs = np.empty(n, dtype=object)
    devs[:] = [torch.device("cuda", i) for i in range(n)]
    return K.sharding.Mesh(devs.reshape(shape), ("data", "model"))


def _place_state(K, cfg, mesh, params, state):
    """(params, optimizer state) placed on ``mesh`` by ``param_specs``: the
    moments like the params, the step counter replicated."""
    M, S = K.lm_model, K.sharding
    pspecs = M.param_specs(cfg, S.Rules(mesh))
    return (S.device_put_tree(params, pspecs, mesh),
            K.optim.OptState(
                S.device_put(state.step, S.NamedSharding(mesh, ())),
                S.device_put_tree(state.mu, pspecs, mesh),
                S.device_put_tree(state.nu, pspecs, mesh)))


def mesh_steps(torch, K, cfg, tcfg, mesh, params, state, batches,
               profile=False, gather=True):
    """``make_train_step`` from (params, state) over ``batches``: on
    ``mesh`` (full values placed by :func:`_place_state`; DTensors taken as
    they are), or with ``mesh`` None the single-device trainer.  Returns
    the losses, grad norms, step ms, (params, state) after (full values,
    or as stepped with ``gather`` False), the parameter and moment bytes
    this rank holds, and with ``profile`` one more step under
    torch.profiler."""
    S, TT = K.sharding, K.trainer
    rules = S.Rules(mesh) if mesh is not None else None
    if mesh is not None and not S.is_dtensor(state.step):
        params, state = _place_state(K, cfg, mesh, params, state)
    held = sum(t.to_local().numel() * t.element_size() if mesh is not None
               else t.numel() * t.element_size()
               for t in _leaves({"p": params, "mu": state.mu, "nu": state.nu}))
    step = TT.make_train_step(cfg, tcfg, TT.make_optimizer(tcfg), rules)
    losses, norms, times = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    prof = _step_profile(torch, lambda: step(params, state, batches[-1])) \
        if profile else None
    if gather:
        params, state = S.full_value(params), S.full_value(state)
    return dict(losses=losses, norms=norms, ms=times, params=params,
                state=state, profile=prof, held_gb=held / 2**30)


def _steps_rel(got, want, what):
    """Max relative distance of the losses and grad norms."""
    rel = max(abs(g - w) / abs(w) for g, w in
              zip(got["losses"] + got["norms"], want["losses"] + want["norms"]))
    if not rel <= MESH_STEP_RTOL:
        raise AssertionError(f"{what}: losses {got['losses']} / norms "
                             f"{got['norms']} against the single device's "
                             f"{want['losses']} / {want['norms']}: {rel} > "
                             f"{MESH_STEP_RTOL}")
    return rel


def _part(run, lo, hi):
    return {k: run[k][lo:hi] for k in ("losses", "norms")}


def mesh_train(torch, K, meshes, rank0):
    """L2 and L3 on this rank: the float32 steps against the single-device
    trainer, the elastic steps in memory, then the bf16 run."""
    M, TT = K.lm_model, K.trainer
    cfg = K.configs.get_config(LM_ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    dev = torch.device("cuda", torch.cuda.current_device())
    tcfg = TT.TrainConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                          total_steps=TRAIN_STEPS, seed=TRAIN_SEED)
    stream = TT.synthetic_token_stream(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                       TRAIN_SEED, device=dev)
    batches = [next(stream) for _ in range(TRAIN_STEPS)]
    n = MESH_TRAIN_F32_STEPS
    init = M.init_params(cfg32, torch.Generator(dev).manual_seed(TRAIN_SEED))
    state0 = TT.make_optimizer(tcfg).init(init)
    # the single-device trainer (path H's code) from the same weights
    ref = mesh_steps(torch, K, cfg32, tcfg, None, init, state0,
                     batches[:n + 2])
    l2 = mesh_steps(torch, K, cfg32, tcfg, meshes["L2"], init, state0,
                    batches[:n])
    rel2 = _steps_rel(l2, _part(ref, 0, n), "L2 float32")
    # L3: the float32 state after step 3 under mesh A, gathered and placed
    # under mesh B for step 4, then back under A for step 5
    a = l2 if meshes["A"] is meshes["L2"] else mesh_steps(
        torch, K, cfg32, tcfg, meshes["A"], init, state0, batches[:n])
    rel3a = _steps_rel(a, _part(ref, 0, n), "L3 steps 1-3 under A")
    b = mesh_steps(torch, K, cfg32, tcfg, meshes["B"], a["params"],
                   a["state"], batches[n:n + 1])
    c = mesh_steps(torch, K, cfg32, tcfg, meshes["A"], b["params"],
                   b["state"], batches[n + 1:n + 2])
    rel3 = max(rel3a, _steps_rel(b, _part(ref, n, n + 1), "L3 step 4"),
               _steps_rel(c, _part(ref, n + 1, n + 2), "L3 step 5"))
    f32_losses = ref["losses"]
    del ref, l2, a, b, c, init, state0
    torch.cuda.empty_cache()
    # bf16 parameters and float32 moments, as path H
    init = M.init_params(cfg, torch.Generator(dev).manual_seed(TRAIN_SEED))
    state0 = TT.make_optimizer(tcfg).init(init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts(K)
    run = mesh_steps(torch, K, cfg, tcfg, meshes["L2"], init, state0,
                     batches, profile=True)
    expect_launches(K, before, {}, "L2 bf16 training steps")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses = run["losses"]
    if not all(math.isfinite(v) for v in losses + run["norms"]):
        raise AssertionError(f"L2 bf16: non-finite loss or norm {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"L2 bf16: the loss did not fall: {losses}")
    ms = float(np.median(run["ms"][3:]))
    prof = run["profile"]
    if rank0:
        log(f"  4L2 float32 on {meshes['L2']}: {n} steps within {rel2:.3e} "
            f"of the single-device step (losses {f32_losses[:n]}, bound "
            f"{MESH_STEP_RTOL}); 4L3 elastic in memory, A {meshes['A']}, B "
            f"{meshes['B'] or 'the single-device trainer'}: steps 1-5 "
            f"within {rel3:.3e}")
        log(f"  4L2 bf16 {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}: "
            f"losses {[round(v, 4) for v in losses]}; {ms:.2f} ms/step "
            f"(median of steps 4-{TRAIN_STEPS}; all "
            f"{[round(t, 1) for t in run['ms']]}), "
            f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.0f} tokens/s; one step "
            f"profiled: {prof['device_ms']:.2f} ms device time in "
            f"{prof['launches']} launches, {prof['wall_ms']:.1f} ms wall")
    return dict(rel2=rel2, rel3=rel3, ms=ms, peak_gb=peak_gb,
                held_gb=run["held_gb"],
                tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
                launches_per_step=prof["launches"],
                device_ms=prof["device_ms"])


def _elastic_cfg(K):
    """The reduced qwen2 of ``tests/test_elastic.py:28-31``."""
    return dataclasses.replace(
        K.configs.get_config(LM_ARCH).reduced(), n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256,
        remat=False, dtype="float32")


def mesh_elastic_files(torch, K, meshes, rank0):
    """L3 through the checkpoint files, at ``tests/test_elastic.py``'s
    width: steps 1-3 under mesh A, (params, optimizer state) saved by
    ``CheckpointManager`` (each DTensor leaf gathered, rank 0 writes, a
    barrier), restored into a tree placed for mesh B (the ``like``) for
    step 4, saved again and restored under A for step 5; each step within
    1e-4 of the single-device steps, each restored leaf placed as its
    ``like``."""
    import torch.distributed as dist

    M, S, TT = K.lm_model, K.sharding, K.trainer
    cfg = _elastic_cfg(K)
    dev = torch.device("cuda", torch.cuda.current_device())
    tcfg = TT.TrainConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                          total_steps=TRAIN_STEPS, seed=TRAIN_SEED)
    stream = TT.synthetic_token_stream(cfg, *ELASTIC_BATCH, TRAIN_SEED,
                                       device=dev)
    n = MESH_TRAIN_F32_STEPS
    batches = [next(stream) for _ in range(n + 2)]
    init = M.init_params(cfg, torch.Generator(dev).manual_seed(TRAIN_SEED))
    state0 = TT.make_optimizer(tcfg).init(init)
    ref = mesh_steps(torch, K, cfg, tcfg, None, init, state0, batches)
    if rank0:
        shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    dist.barrier()
    mgr = K.ckpt.CheckpointManager(ELASTIC_DIR)
    legs = ((meshes["A"], 0, n), (meshes["B"], n, n + 1),
            (meshes["A"], n + 1, n + 2))
    params, state, rel = init, state0, 0.0
    for i, (mesh, lo, hi) in enumerate(legs):
        if i:
            like = (_place_state(K, cfg, mesh, init, state0)
                    if mesh is not None else (init, state0))
            _, tree, _ = mgr.restore({"params": like[0], "opt": like[1]}, i)
            params, state = tree["params"], tree["opt"]
            for got, want in zip(TT.tree_leaves(tree),
                                 TT.tree_leaves(list(like))):
                if S.is_dtensor(got) != S.is_dtensor(want) or (
                        S.is_dtensor(want)
                        and got.placements != want.placements):
                    raise AssertionError(f"L3 files: a leaf restored as "
                                         f"{got!r:.80}, its like {want!r:.80}")
        run = mesh_steps(torch, K, cfg, tcfg, mesh, params, state,
                         batches[lo:hi], gather=False)
        rel = max(rel, _steps_rel(run, _part(ref, lo, hi),
                                  f"L3 files, steps {lo + 1}-{hi}"))
        if i < len(legs) - 1:
            mgr.save(i + 1, {"params": run["params"], "opt": run["state"]})
    if rank0:
        log(f"  4L3 elastic through the checkpoint files at "
            f"tests/test_elastic.py's width ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, batch {ELASTIC_BATCH}): steps 1-{n} under A "
            f"{meshes['A']}, saved, restored for step {n + 1} under B "
            f"{meshes['B'] or 'the single-device trainer'}, saved, restored "
            f"for step {n + 2} under A: within {rel:.3e} of the "
            f"single-device steps (bound {MESH_STEP_RTOL})")
    return rel


def mesh_serve(torch, K, mesh, rank0):
    """L4 on this rank: the bf16 prefill under rules (one flash_attention
    launch a layer on this rank's local heads) against the single-device
    kernel route, and float32 serve_steps from a cache placed by
    cache_specs against the single-device decode."""
    M, S = K.lm_model, K.sharding
    cfg = K.configs.get_config(LM_ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    dev = torch.device("cuda", torch.cuda.current_device())
    rules = S.Rules(mesh)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    tok = _lm_tokens(torch, cfg, (LM_BATCH, LM_SEQ), 0)
    p32 = _tree_map(lambda t: t.to(torch.float32), params)
    f32 = M.forward(p32, {"tokens": tok}, cfg32)
    single = M.forward(params, {"tokens": tok}, cfg)
    rel_k = _rel_err(single, f32)
    placed = S.device_put_tree(params, M.param_specs(cfg, rules), mesh)
    before = launch_counts(K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = M.forward(placed, {"tokens": tok}, cfg, "cuda", rules)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    expect_launches(K, before, {"flash_attention": cfg.n_layers},
                    "L4 sharded bf16 prefill")
    local = tuple(out.to_local().shape)
    logits = out.full_tensor()
    del out
    rel_s, rel_ss = _rel_err(logits, f32), _rel_err(logits, single)
    del logits, single, f32
    if not rel_s <= 1.5 * rel_k:
        raise AssertionError(f"L4: sharded bf16 prefill {rel_s} from the "
                             f"float32 logits, over 1.5 x the single-device "
                             f"kernel route's {rel_k}")
    b, steps = MESH_DECODE
    dtok = _lm_tokens(torch, cfg, (b, steps), 1)
    want = _decode_logits(torch, M, cfg32, p32, dtok, steps + 2)
    placed32 = S.device_put_tree(p32, M.param_specs(cfg32, rules), mesh)
    cache = S.device_put_tree(M.init_cache(cfg32, b, steps + 2, dev),
                              M.cache_specs(cfg32, rules, b, steps + 2), mesh)
    got = []
    for i in range(steps):
        step_logits, cache = M.serve_step(placed32, cache,
                                          {"token": dtok[:, i]}, cfg32, rules)
        got.append(step_logits.full_tensor())
    rel_d = _rel_err(torch.stack(got, 1), want)
    if not rel_d <= MESH_DECODE_RTOL:
        raise AssertionError(f"L4: sharded float32 decode {rel_d} from the "
                             f"single-device decode > {MESH_DECODE_RTOL}")
    if rank0:
        log(f"  4L4 bf16 prefill {LM_BATCH} x {LM_SEQ} on {mesh}: "
            f"{cfg.n_layers} flash_attention launches on this rank "
            f"(local logits {local}), first call {t_fwd:.2f} s; "
            f"{rel_s:.3e} from the float32 logits against the "
            f"single-device kernel route's {rel_k:.3e} (bound 1.5x), "
            f"{rel_ss:.3e} from it; float32 decode {b} x {steps} steps "
            f"under cache_specs within {rel_d:.3e} of the single-device "
            f"decode (bound {MESH_DECODE_RTOL})")
    return dict(rel_s=rel_s, rel_k=rel_k, rel_decode=rel_d, t_fwd=t_fwd)


def mesh_lm_rank(meshes):
    """Paths L2-L4 on one rank (one process a card, run_on_mesh): returns
    this rank's readings and its kernel launches."""
    import torch
    import torch.distributed as dist

    K = namespace()
    rank0 = dist.get_rank() == 0
    reset_launches(K)
    train = mesh_train(torch, K, meshes, rank0)
    train["rel3_files"] = mesh_elastic_files(torch, K, meshes, rank0)
    serve = mesh_serve(torch, K, meshes["L2"], rank0)
    return dict(rank=dist.get_rank(), train=train, serve=serve,
                launches=launch_counts(K))


def main_path_mesh_lm(torch, K, h1):
    """Main path L: the LM on a device mesh (module docstring, 4L)."""
    t0 = time.perf_counter()
    planned = dryrun_plans(torch, K)
    n = torch.cuda.device_count()
    if n >= 4:
        meshes = {"L2": card_mesh(torch, K, (2, 2)),
                  "A": card_mesh(torch, K, (4, 1))}
        meshes["B"] = meshes["L2"]
    else:
        one = card_mesh(torch, K, (1, 1))
        meshes = {"L2": one, "A": one, "B": None}
    log(f"phase 4L: {LM_ARCH} on {meshes['L2']} ({meshes['L2'].size} "
        f"process(es), NCCL)")
    reset_launches(K)
    ranks = K.mesh.run_on_mesh(mesh_lm_rank, meshes["L2"], meshes)
    r0 = ranks[0]
    for r in ranks:
        log(f"  4L rank {r['rank']}: parameters and moments held "
            f"{r['train']['held_gb']:.3f} GiB, peak memory "
            f"{r['train']['peak_gb']:.2f} GiB in the bf16 run, "
            f"{r['train']['ms']:.2f} ms/step; kernel launches "
            f"{r['launches']}")
    log(f"  4L beside path H (single device): {r0['train']['ms']:.2f} "
        f"against {h1['ms_per_step']:.2f} ms/step, "
        f"{r0['train']['tokens_per_s']:.0f} against "
        f"{h1['tokens_per_s']:.0f} tokens/s, peak "
        f"{r0['train']['peak_gb']:.2f} against {h1['peak_gb']:.2f} GiB, "
        f"{r0['train']['launches_per_step']} against "
        f"{h1['launches_per_step']} launches a step")
    log(f"phase 4L took {time.perf_counter() - t0:.1f} s")
    return r0["launches"], dict(planned=planned, ranks=ranks)


# --------------------------------------------------------------------------
# phase 4L5: the attention families on a device mesh (after L, on its mesh)
# --------------------------------------------------------------------------
# L5a: float32 at the CPU tests' widths (tests/_torch_mesh_family_cases.py):
# case -> (arch, layers, the MoE fields replaced)
L5A_WIDTHS = dict(d_model=512, n_heads=8, n_kv_heads=2, d_head=64,
                  vocab_size=512, d_ff=1024, remat=False, dtype="float32")
L5A_CASES = {
    "grok-1 tp": ("grok-1-314b", 1,
                  dict(n_experts=4, top_k=2, d_ff_expert=512)),
    "deepseek-v3 ep": ("deepseek-v3-671b", 2,
                       dict(n_experts=4, top_k=2, d_ff_expert=512,
                            n_shared=1, first_k_dense=1, d_ff_dense=1024)),
    "deepseek-v3 ep2d": ("deepseek-v3-671b", 2,
                         dict(n_experts=8, top_k=2, d_ff_expert=512,
                              n_shared=1, first_k_dense=1, d_ff_dense=1024,
                              expert_sharding="ep2d")),
    "llava-next": ("llava-next-mistral-7b", 1, None),
    "hubert": ("hubert-xlarge", 1, None),
}
L5A_BATCH = (8, 16)
L5A_DECODE = 4  # serve_steps
L5A_RTOL = 1e-4  # path L's bound, for the loss, every gradient leaf (of
# the leaf's largest value), the step, the logits and the decode
# L5b: bf16 at published widths, depth cut; gate_sigmoid pwl4 (the SiLU
# gates of deepseek-v3 and llava-next one pwl_activation launch a stack):
# (arch, layers, prefill (batch, tokens), image embeddings, decode (batch,
# steps) or None)
L5B_RUNS = (
    # 3 dense layers and 1 MoE layer of 256 experts; 2 x 4096 (path I ran
    # 2 x 8192: the memory of the sharded copy beside the single-device
    # references)
    ("deepseek-v3-671b", 4, (2, 4096), 0, (4, 32)),
    ("grok-1-314b", 2, (4, 2048), 0, (4, 32)),
    ("llava-next-mistral-7b", 2, (2, 1216), 2880, (4, 32)),
    ("hubert-xlarge", 2, (4, 1500), 0, None),
)
L5B_PEAK_GIB = 75.0


def _l5a_cfg(K, case):
    arch, n_layers, moe = L5A_CASES[case]
    cfg = dataclasses.replace(K.configs.get_config(arch).reduced(),
                              n_layers=n_layers, **L5A_WIDTHS)
    if moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def _leaf_rel(K, got, want):
    """(worst leaf's max |got - want| over the leaf's largest |want|, its
    path, and the leaves compared); a zero leaf must be zero in both."""
    TT = K.trainer
    worst = (0.0, "")
    n = 0
    for path, a, b in zip(TT._leaf_paths(want), TT.tree_leaves(want),
                          TT.tree_leaves(got)):
        b = K.sharding.full_value(b)
        scale = float(a.abs().max())
        err = float((a - b).abs().max())
        rel = err / scale if scale else err
        worst = max(worst, (rel, "/".join(path)))
        n += 1
    return worst[0], worst[1], n


def _mesh_readings(K, got, one):
    """The readings of a run (``got``) against another (``one``): relative
    distances of the loss, the step's metrics, the logits, the decode and
    every gradient leaf (of the leaf's largest value), and the stepped
    parameters' absolute distance where ``one``'s gradient is at least
    1e-6 (AdamW's first step moves the others by lr x the gradient's
    sign); with the worst gradient leaf and the count of leaves."""
    S, TT = K.sharding, K.trainer
    rel = {"loss": abs(float(S.full_value(got["loss"]))
                       - float(S.full_value(one["loss"])))
           / abs(float(S.full_value(one["loss"]))),
           "step": max(abs(got[k] - one[k]) / abs(one[k])
                       for k in ("step_loss", "grad_norm")),
           "logits": _rel_err(got["logits"], one["logits"])}
    rel["grads"], worst, n_leaves = _leaf_rel(K, got["grads"],
                                              one["grads"])
    rel["params"] = max(
        float(((a - S.full_value(b)).abs() * (g.abs() >= 1e-6)).max())
        for a, b, g in zip(TT.tree_leaves(one["step"]),
                           TT.tree_leaves(got["step"]),
                           TT.tree_leaves(one["grads"])))
    if "decode" in one:
        rel["decode"] = _rel_err(got["decode"], one["decode"])
    return rel, worst, n_leaves


def mesh_case(torch, K, mesh, tag, case, cfg, batch_shape, seed, rank0,
              rounding=False):
    """One config of L5a or L6a (``tag``; float32, or float64): the
    single-device run on this rank's card, then the same under ``mesh``;
    each reading within L5A_RTOL and the experts of every token equal.
    With ``rounding`` (RWKV in float32) a reading may also be as far as
    one card's own float32 run is from a float64 run of the same weights
    (the function's float32 resolution, measured here), where that is
    further."""
    M, S, TT = K.lm_model, K.sharding, K.trainer
    rules = S.Rules(mesh)
    dev = torch.device("cuda", torch.cuda.current_device())
    init = M.init_params(cfg, torch.Generator(dev).manual_seed(seed))
    batch = next(TT.synthetic_token_stream(cfg, *batch_shape, seed,
                                           device=dev))
    tcfg = TT.TrainConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
    opt = TT.make_optimizer(tcfg)

    def run(params, rules, cfg=cfg):
        out = {}
        with record_routing(K) as calls:
            out["loss"], out["grads"] = TT.loss_and_grads(params, batch, cfg,
                                                          rules)
        out["experts"] = [e for _, e in calls]
        new, _, m = TT.make_train_step(cfg, tcfg, opt, rules)(
            params, opt.init(params), batch)
        out.update(step=new, step_loss=float(m["loss"]),
                   grad_norm=float(m["grad_norm"]),
                   logits=S.full_value(M.forward(params, batch, cfg, "cuda",
                                                 rules)))
        if not cfg.encoder_only:
            b = batch_shape[0]
            cache = M.init_cache(cfg, b, L5A_DECODE + 2, dev)
            if rules is not None:
                cache = S.device_put_tree(cache, M.cache_specs(
                    cfg, rules, b, L5A_DECODE + 2), mesh)
            dec = []
            for i in range(L5A_DECODE):
                lg, cache = M.serve_step(params, cache,
                                         {"token": batch["tokens"][:, i]},
                                         cfg, rules)
                dec.append(S.full_value(lg))
            out["decode"] = torch.stack(dec, 1)
        return out

    one = run(init, None)
    placed = S.device_put_tree(init, M.param_specs(cfg, rules), mesh)
    got = run(placed, rules)
    rel, worst, n_leaves = _mesh_readings(K, got, one)
    bound = dict.fromkeys(rel, L5A_RTOL)
    floor = None
    if rounding:
        wide = run(_tree_map(lambda t: t.to(torch.float64)
                             if t.is_floating_point() else t, init), None,
                   dataclasses.replace(cfg, dtype="float64"))
        floor = _mesh_readings(K, one, wide)[0]
        bound = {k: max(L5A_RTOL, floor[k]) for k in rel}
    tokens = 0
    if len(got["experts"]) != len(one["experts"]):
        raise AssertionError(f"{tag} {case}: {len(got['experts'])} routing "
                             f"calls under the mesh, {len(one['experts'])} "
                             f"on one card")
    for a, b in zip(got["experts"], one["experts"]):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag} {case}: experts differ from the "
                                 f"single device's")
        tokens += a.shape[0]
    bad = {k: v for k, v in rel.items() if not v <= bound[k]}
    if bad:
        raise AssertionError(f"{tag} {case} on {mesh}: {bad} over {bound} "
                             f"from the single device (worst gradient leaf "
                             f"{worst})")
    if rank0:
        log(f"  4{tag} {case} {cfg.dtype} on {mesh}: against one card, loss "
            f"{rel['loss']:.3e}, {n_leaves} gradient leaves within "
            f"{rel['grads']:.3e} (worst {worst}), train step {rel['step']:.3e}"
            f" (parameters {rel['params']:.3e}), forward {rel['logits']:.3e}"
            + (f", {L5A_DECODE} serve_steps {rel['decode']:.3e}"
               if "decode" in rel else ", no decode (encoder)")
            + f" (bound {L5A_RTOL}"
            + (", or one card's own float32 distance from float64 where "
               "further: " + ", ".join(f"{k} {v:.3e}" for k, v in
                                       floor.items()) if floor else "")
            + ")"
            + (f"; experts equal on {tokens} tokens in "
               f"{len(one['experts'])} routing calls" if one["experts"]
               else ""))
    return dict(rel, tokens=tokens, floor=floor)


def comm_bytes(torch):
    """A dispatch mode counting the bytes this rank sends in the functional
    collectives that DTensor calls (ring algorithms: an all-gather sends
    (n - 1) x its input, a reduce-scatter and an all-to-all (n - 1) / n of
    it, an all-reduce 2 (n - 1) / n), by collective.  Groups of one send
    nothing."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.utils._python_dispatch import TorchDispatchMode

    factors = {"all_gather_into_tensor": lambda n: n - 1,
               "reduce_scatter_tensor": lambda n: (n - 1) / n,
               "all_to_all_single": lambda n: (n - 1) / n,
               "shard_dim_alltoall": lambda n: (n - 1) / n,
               "all_reduce": lambda n: 2 * (n - 1) / n}

    class CommBytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.by_op = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__.split(".")[0]
            if (name in factors and getattr(func, "namespace", "")
                    in ("_c10d_functional", "_dtensor")):
                group = next(a for a in reversed(args) if isinstance(a, str))
                n = _resolve_process_group(group).size()
                nbytes = args[0].numel() * args[0].element_size()
                self.by_op[name] = (self.by_op.get(name, 0)
                                    + nbytes * factors[name](n))
            return func(*args, **(kwargs or {}))

    return CommBytes()


@contextlib.contextmanager
def layer_bytes(torch, module, name):
    """Each call of ``module.name`` (a layer: ``apply_moe``,
    ``mamba2_forward``, ``rwkv6_forward``) inside under
    :func:`comm_bytes`: the bytes it sends by collective, one dict a call,
    in the list yielded."""
    apply = getattr(module, name)
    records = []

    def counted(*args, **kw):
        with comm_bytes(torch) as mode:
            out = apply(*args, **kw)
        records.append(dict(mode.by_op))
        return out

    setattr(module, name, counted)
    try:
        yield records
    finally:
        setattr(module, name, apply)


def _mesh_layer(K, cfg):
    """(module, function, what) of the layer whose bytes a sharded forward
    of ``cfg`` counts: a MoE layer, a Mamba2 layer or an RWKV layer; None
    for a dense stack."""
    if cfg.block_pattern == "rwkv":
        return K.rwkv, "rwkv6_forward", "RWKV layer"
    if cfg.block_pattern == "mamba_hybrid":
        return K.mamba, "mamba2_forward", "Mamba2 layer"
    if cfg.moe is not None:
        return K.moe, "apply_moe", "MoE layer call"
    return None


def _mesh_launches(cfg):
    """Kernel launches of one sharded forward at the pwl4 gate on each
    rank: flash_attention a layer (a shared-block call of the hybrid, none
    for RWKV), pwl_activation a gated stack (:func:`_gated_mlps`, as many a
    decode step)."""
    n_attn = (cfg.n_layers if cfg.block_pattern == "attn"
              else cfg._layer_split()[0])
    out = {"flash_attention": n_attn} if n_attn else {}
    if _gated_mlps(cfg):
        out["pwl_activation"] = _gated_mlps(cfg)
    return out


@contextlib.contextmanager
def captured_pwl(K):
    """The last ``pwl_activation_cuda`` launch made inside, its input,
    variant and output kept for the plain version to check after the run;
    the launch is the path's own (the wrapper counts it), none is added."""
    ops, wrapper = K.ops, K.ops.pwl_activation_cuda
    seen = {"launches": 0}

    def spy(x, variant, bias=None):
        out = wrapper(x, variant, bias)
        seen.update(x=x.clone(), variant=variant, out=out.clone(),
                    bias=None if bias is None else bias.clone(),
                    launches=seen["launches"] + 1)
        return out

    ops.pwl_activation_cuda = spy
    try:
        yield seen
    finally:
        ops.pwl_activation_cuda = wrapper


def check_captured_pwl(torch, K, seen, what):
    """The captured launch against the plain version, bit for bit."""
    want = K.pwl.pwl_activation_plain(seen["x"], seen["variant"],
                                      seen["bias"])
    if not torch.equal(seen["out"], want):
        err = float((seen["out"].float() - want.float()).abs().max())
        raise AssertionError(f"{what}: the last pwl_activation launch "
                             f"({seen['variant']}, {tuple(seen['x'].shape)} "
                             f"{seen['x'].dtype}) is {err} from the plain "
                             f"version, not equal")
    return (f"pwl_activation ({seen['variant']}) at the last of "
            f"{seen['launches']} launches, {tuple(seen['x'].shape)} "
            f"{str(seen['x'].dtype).split('.')[-1]}: equal to the plain "
            f"version bit for bit")


def _place_consuming(K, tree, specs, mesh):
    """:func:`device_put_tree`, each full leaf dropped from ``tree`` as it
    is placed: the full tree and the placed one never both stay alive."""
    out = {}
    for k in list(tree):
        v = tree.pop(k)
        out[k] = (_place_consuming(K, v, specs[k], mesh)
                  if isinstance(v, dict) else
                  K.sharding.device_put(v, K.sharding.NamedSharding(
                      mesh, specs[k])))
        del v
    return out


def bf16_mesh_run(torch, K, mesh, tag, arch, n_layers, prefill, n_img,
                  decode, rank0):
    """One model of L5b or L6b (``tag``; bf16, published widths,
    ``n_layers`` deep, the pwl4 gate): the single-device prefill and
    decode on rank 0, the weights placed leaf by leaf, then the sharded
    prefill (:func:`_mesh_launches` on this rank's local shards, the last
    flash_attention and pwl_activation launches held to their plain
    versions; timed and profiled) and decode."""
    M, S = K.lm_model, K.sharding
    cfg = dataclasses.replace(_family_cfg(K, arch, n_layers),
                              gate_sigmoid="pwl4")
    rules = S.Rules(mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    b, s = prefill
    batch = _family_batch(torch, cfg, b, s, n_img, 7)
    gates = _gated_mlps(cfg)
    per_fwd = _mesh_launches(cfg)
    single = single_dec = None
    experts = {}
    if rank0:
        with record_routing(K) as calls:
            single = M.forward(params, batch, cfg)
        experts["single"] = [e for _, e in calls]
        del calls
        if decode is not None:
            dtok = _lm_tokens(torch, cfg, decode, 3)
            single_dec = _decode_logits(torch, M, cfg, params, dtok,
                                        decode[1] + 2)
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    placed = _place_consuming(K, params, M.param_specs(cfg, rules), mesh)
    del params
    torch.cuda.empty_cache()
    held = sum(t.to_local().numel() * t.element_size()
               for t in _leaves(placed))
    before = launch_counts(K)
    t0 = time.perf_counter()
    with captured_flash(K) as seen, captured_pwl(K) as seen_pwl, \
            record_routing(K) as calls:
        out = M.forward(placed, batch, cfg, "cuda", rules)
        torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    experts["mesh"] = [e for _, e in calls]
    del calls
    expect_launches(K, before, per_fwd, f"{tag} {arch} sharded bf16 prefill")
    local = tuple(out.to_local().shape)
    logits = out.full_tensor()
    del out
    if (logits.shape != (b, s + n_img, cfg.vocab_size)
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{tag} {arch}: sharded logits "
                             f"{tuple(logits.shape)} not finite of the "
                             f"expected shape")
    checked = []
    if "flash_attention" in per_fwd:
        checked.append(check_captured_flash(torch, K, seen, f"{tag} {arch}"))
    if "pwl_activation" in per_fwd:
        checked.append(check_captured_pwl(torch, K, seen_pwl,
                                          f"{tag} {arch}"))
    flash = "; ".join(checked)
    del seen, seen_pwl
    dist_prefill = flips = before_flip = None
    if rank0:
        dist_prefill = _rel_err(logits, single)
        if mesh.size == 1 and dist_prefill != 0.0:
            raise AssertionError(f"{tag} {arch}: the sharded logits on a mesh "
                                 f"of one card are {dist_prefill} from the "
                                 f"single device's, not equal")
        if cfg.moe is not None:
            # a token whose experts differ (bf16 partial sums added in
            # another order move a router score past a neighbour's) may
            # differ by a whole expert from there on: the distance before
            # each row's first such token
            first = _first_flip(torch, experts["mesh"], experts["single"], b,
                                s + n_img)
            flips = sum(int((a.sort(-1).values != c.sort(-1).values)
                            .any(-1).sum()) for a, c in
                        zip(experts["mesh"], experts["single"]))
            before_flip = (_masked_rel(logits, single, first),
                           int(first.min()))
    del logits, single, experts
    moe_bytes = None
    layer = _mesh_layer(K, cfg)
    if mesh.size > 1 and layer is not None:
        with layer_bytes(torch, *layer[:2]) as moe_bytes:
            M.forward(placed, batch, cfg, "cuda", rules)
    fwd = lambda: M.forward(placed, batch, cfg, "cuda", rules)  # noqa: E731
    ms, host_ms = cuda_ms(torch, fwd, 1)
    prof = _kernel_profile(torch, fwd, cpu=False)
    dev_ms = sum(prof["by_kind"].values())
    del batch
    rec = dict(params=n_params, held_gib=held / 2 ** 30, prefill_ms=ms,
               device_ms=dev_ms, idle=max(0.0, 1 - dev_ms / ms),
               launches=prof["launches"], first_s=t_first,
               dist_prefill=dist_prefill, flips=flips,
               before_flip=before_flip, moe_bytes=moe_bytes)
    if decode is not None:
        db, steps = decode
        dtok = _lm_tokens(torch, cfg, decode, 3)
        dev = torch.device("cuda", torch.cuda.current_device())

        def placed_cache():
            return S.device_put_tree(
                M.init_cache(cfg, db, steps + 2, dev),
                M.cache_specs(cfg, rules, db, steps + 2), mesh)

        M.serve_step(placed, placed_cache(), {"token": dtok[:, 0]}, cfg,
                     rules)  # warm-up
        cache = placed_cache()
        before = launch_counts(K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec = []
        for i in range(steps):
            lg, cache = M.serve_step(placed, cache, {"token": dtok[:, i]},
                                     cfg, rules)
            dec.append(lg.full_tensor())
        torch.cuda.synchronize()
        rec["decode_ms"] = (time.perf_counter() - t0) * 1e3 / steps
        expect_launches(K, before, {"pwl_activation": gates * steps}
                        if gates else {}, f"{tag} {arch} sharded decode")
        dec = torch.stack(dec, 1)
        if not bool(torch.isfinite(dec).all()):
            raise AssertionError(f"{tag} {arch}: non-finite decode logits")
        if rank0:
            rec["dist_decode"] = _rel_err(dec, single_dec)
            if mesh.size == 1 and rec["dist_decode"] != 0.0:
                raise AssertionError(f"{tag} {arch}: the sharded decode on a "
                                     f"mesh of one card is "
                                     f"{rec['dist_decode']} from the "
                                     f"single device's, not equal")
        del dec, single_dec, cache
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if rec["peak_gib"] > L5B_PEAK_GIB:
        raise AssertionError(f"{tag} {arch}: peak memory {rec['peak_gib']:.2f} "
                             f"GiB over {L5B_PEAK_GIB}")
    if rank0:
        log(f"  4{tag} {arch} bf16 on {mesh}: depth {cfg.n_layers} of "
            f"{K.configs.get_config(arch).n_layers}, prefill {b} x "
            f"{s + n_img}" + (f" ({n_img} image embeddings + {s} tokens)"
                             if n_img else "")
            + f", pwl4 gate; {n_params} parameters, {held} bytes "
            f"({rec['held_gib']:.3f} GiB) on this card; init and "
            f"single-device references {t_single:.1f} s; sharded prefill: {per_fwd} "
            f"launches on this rank (local logits {local}), first call "
            f"{t_first:.2f} s, {ms:.2f} ms ({host_ms:.2f} ms host), "
            f"{dev_ms:.2f} ms device time in {prof['launches']} launches, "
            f"idle {rec['idle']:.1%}; {flash}; {dist_prefill:.3e} from the "
            f"single-device bf16 logits"
            + (f" ({flips} of the "
               f"{b * (s + n_img) * (cfg.n_layers - cfg.moe.first_k_dense)}"
               f" token routings pick other experts than one card's; "
               f"before each row's first such token {before_flip[0]:.3e}, "
               f"the earliest at position {before_flip[1]})"
               if flips is not None else "")
            + (f"; bytes this rank sends a {layer[2]}: " + "; ".join(
                f"{sum(r.values()):.0f} (" + ", ".join(
                    f"{k} {v:.0f}" for k, v in r.items()) + ")"
                for r in moe_bytes) if moe_bytes is not None else "")
            + (f"; decode {decode[0]} x {decode[1]}: "
               f"{rec['decode_ms']:.2f} ms/token, {gates} pwl_activation a "
               f"step, {rec['dist_decode']:.3e} from the single-device "
               f"decode" if decode is not None else "")
            + f"; peak memory {rec['peak_gib']:.2f} GiB")
    del placed
    torch.cuda.empty_cache()
    return rec


def mesh_families_rank(mesh):
    """Path L5 on one rank: L5a's five float32 configs, then L5b's four
    bf16 models; returns this rank's readings and its kernel launches."""
    import torch
    import torch.distributed as dist

    K = namespace()
    rank0 = dist.get_rank() == 0
    reset_launches(K)
    t0 = time.perf_counter()
    l5a = {case: mesh_case(torch, K, mesh, "L5a", case, _l5a_cfg(K, case),
                           L5A_BATCH, i, rank0)
           for i, case in enumerate(L5A_CASES)}
    t_a = time.perf_counter() - t0
    l5b = {}
    for run in L5B_RUNS:
        t1 = time.perf_counter()
        l5b[run[0]] = bf16_mesh_run(torch, K, mesh, "L5b", *run, rank0)
        l5b[run[0]]["s"] = time.perf_counter() - t1
    return dict(rank=dist.get_rank(), l5a=l5a, l5b=l5b, l5a_s=t_a,
                launches=launch_counts(K))


def main_path_mesh_families(torch, K):
    """Main path L5: the attention families on path L's mesh (module
    docstring, 4L5)."""
    t0 = time.perf_counter()
    shape = (2, 2) if torch.cuda.device_count() >= 4 else (1, 1)
    mesh = card_mesh(torch, K, shape)
    log(f"phase 4L5: the attention families on {mesh} ({mesh.size} "
        f"process(es), NCCL)")
    reset_launches(K)
    ranks = K.mesh.run_on_mesh(mesh_families_rank, mesh, mesh)
    for r in ranks:
        log(f"  4L5 rank {r['rank']}: L5a {r['l5a_s']:.1f} s; "
            + "; ".join(f"{a} {v['s']:.1f} s, {v['held_gib']:.3f} GiB held, "
                        f"peak {v['peak_gib']:.2f} GiB"
                        for a, v in r["l5b"].items())
            + f"; kernel launches {r['launches']}")
    launches = ranks[0]["launches"]
    if not launches["flash_attention"] or not launches["pwl_activation"]:
        raise AssertionError(f"path L5 launched {launches}: flash_attention "
                             f"and pwl_activation must both run")
    log(f"phase 4L5 took {time.perf_counter() - t0:.1f} s")
    return launches, ranks


# --------------------------------------------------------------------------
# phase 4L6: the hybrid and RWKV on a device mesh (after L5, on its mesh)
# --------------------------------------------------------------------------
# L6a: float32 at the CPU tests' widths (tests/_torch_mesh_recurrent_cases.py):
# case -> (arch, layers, the fields replaced).  zamba2: reduced()'s SSM
# (32 heads of 32 in 2 groups, chunk 32, a shared block every 3 layers,
# window 64), one group of 2 Mamba2 layers and the shared block (8 heads
# over 2 KV heads), a tail of 1; rwkv6: 8 heads of 64.
L6A_CASES = {
    "zamba2": ("zamba2-7b", 4, dict(n_kv_heads=2)),
    "rwkv6": ("rwkv6-1.6b", 2, dict(n_kv_heads=8)),
    # RWKV in float64, where the mesh and one card compute the same
    # function to rounding: its float32 gradients are resolved only to
    # ~3e-4 at these widths (a group norm of near-zero variance in the
    # first tokens, eps 1e-5), which the float32 case measures
    "rwkv6-f64": ("rwkv6-1.6b", 2, dict(n_kv_heads=8, dtype="float64")),
}
L6A_BATCH = (8, 64)  # two SSD chunks
# L6b: bf16 at published widths, depth cut; gate_sigmoid pwl4 (two
# pwl_activation launches a Mamba2 or RWKV layer): zamba2 13 of 81 layers
# (two groups of five Mamba2 layers and the shared block, a tail of one)
# at 2 x 8192, past the window of 4096; rwkv6 4 of 24 at 4 x 2048
L6B_RUNS = (
    ("zamba2-7b", 13, (2, 8192), 0, (4, 32)),
    ("rwkv6-1.6b", 4, (4, 2048), 0, (4, 32)),
)


def _l6a_cfg(K, case):
    arch, n_layers, fields = L6A_CASES[case]
    return dataclasses.replace(K.configs.get_config(arch).reduced(),
                               n_layers=n_layers,
                               **dict(L5A_WIDTHS, **fields))


def mesh_recurrent_rank(mesh):
    """Path L6 on one rank: L6a's two float32 configs, then L6b's two bf16
    models; returns this rank's readings and its kernel launches."""
    import torch
    import torch.distributed as dist

    K = namespace()
    rank0 = dist.get_rank() == 0
    reset_launches(K)
    t0 = time.perf_counter()
    l6a = {case: mesh_case(torch, K, mesh, "L6a", case, _l6a_cfg(K, case),
                           L6A_BATCH, 20 + i, rank0,
                           rounding=case == "rwkv6")
           for i, case in enumerate(L6A_CASES)}
    t_a = time.perf_counter() - t0
    l6b = {}
    for run in L6B_RUNS:
        t1 = time.perf_counter()
        l6b[run[0]] = bf16_mesh_run(torch, K, mesh, "L6b", *run, rank0)
        l6b[run[0]]["s"] = time.perf_counter() - t1
    return dict(rank=dist.get_rank(), l6a=l6a, l6b=l6b, l6a_s=t_a,
                launches=launch_counts(K))


def main_path_mesh_recurrent(torch, K):
    """Main path L6: the hybrid and RWKV on path L's mesh (module
    docstring, 4L6)."""
    t0 = time.perf_counter()
    shape = (2, 2) if torch.cuda.device_count() >= 4 else (1, 1)
    mesh = card_mesh(torch, K, shape)
    log(f"phase 4L6: the hybrid and RWKV on {mesh} ({mesh.size} "
        f"process(es), NCCL)")
    reset_launches(K)
    ranks = K.mesh.run_on_mesh(mesh_recurrent_rank, mesh, mesh)
    for r in ranks:
        log(f"  4L6 rank {r['rank']}: L6a {r['l6a_s']:.1f} s; "
            + "; ".join(f"{a} {v['s']:.1f} s, {v['held_gib']:.3f} GiB held, "
                        f"peak {v['peak_gib']:.2f} GiB"
                        for a, v in r["l6b"].items())
            + f"; kernel launches {r['launches']}")
        if not (r["launches"]["flash_attention"]
                and r["launches"]["pwl_activation"]):
            raise AssertionError(f"path L6 launched {r['launches']} on rank "
                                 f"{r['rank']}: flash_attention and "
                                 f"pwl_activation must both run")
    log(f"phase 4L6 took {time.perf_counter() - t0:.1f} s")
    return ranks[0]["launches"], ranks


# --------------------------------------------------------------------------
# phase 5: timing
# --------------------------------------------------------------------------
def cuda_ms(torch, fn, iters):
    """(ms per call between CUDA events, host ms per call to issue it).
    When the two are close, the loop is bound by the host, not the card."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def device_ms(torch, fn, iters=20, attempts=3):
    """Device time per call of ``fn`` (ms): the sum of its kernels' device
    time in a torch.profiler trace of ``iters`` calls.  Below ~0.04 ms a
    CUDA-event loop measures the host's launch cost instead.  A trace that
    now and then holds no device event is taken again (0.0 after
    ``attempts`` empty traces)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total = 0
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total:
            break
    return total / 1e3 / iters


class Timer:
    """Phase 5: kernel times beside their bounds; keeps the record of each
    kernel at its recorded shape for the JSON line."""

    def __init__(self, torch, dev, check, launches):
        self.torch, self.dev, self.check = torch, dev, check
        self.launches = launches  # name -> (total, by path)
        self.records = {}
        log("phase 5: kernel times (CUDA events, warm L2, mean over iterations)")
        log(f"  {'kernel':14s} {'tag':10s} {'batch':>6s} {'ms':>9s} "
            f"{'host_ms':>9s} {'plain_ms':>9s} {'bound_ms':>9s} bound_by")

    def time(self, name, tag, m, kern, plain, nbytes, ops, peak, record,
             source, replaces, shape=None, profile=False):
        iters = 200 if m <= 3298 else 20
        ms, host_ms = cuda_ms(self.torch, kern, iters)
        plain_ms, _ = cuda_ms(self.torch, plain, max(3, iters // 20))
        bound_ms, bound_by = self.dev.bound(nbytes, ops, peak)
        dev_ms = device_ms(self.torch, kern) if record or profile else None
        log(f"  {name:14s} {tag:10s} {m:6d} {ms:9.4f} {host_ms:9.4f} "
            f"{plain_ms:9.4f} {bound_ms:9.5f} {bound_by}"
            + ("" if dev_ms is None else f"; profiler device {dev_ms:.4f}"))
        if record:
            total, by_path = self.launches[name]
            self.records[name] = {
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces, "launches": total,
                "launches_by_path": by_path,
                "max_abs_err": self.check.max_abs_err[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
                "device_ms": dev_ms,
                "shape": shape or f"{tag} D6 test split, batch {m}"}
        return ms


def log_cuda_core_bound(dev, nbytes, ops, bits):
    """The MLP megakernels' bound on the CUDA cores (their route before the
    tensor cores), printed beside the tensor-core bound the record keeps."""
    ms, by = dev.bound(nbytes, ops, dev.int_peak(bits))
    log(f"  {'':14s} CUDA-core bound {ms:.5f} ms ({by})")


def time_mlp(torch, K, T, arts, x_big, n_test):
    for tag in ("fxp16", "auto8", "fxp32"):
        for kind in ("mlp", "logistic"):
            spec = arts[(kind, tag)].extras["emit_spec"]
            bits = spec["in_fmt"].total_bits
            for m in TIMED_BATCHES:
                qx = K.fxp.quantize(torch.from_numpy(x_big[:m]).cuda(),
                                    spec["in_fmt"])
                record = tag == "fxp16" and m == n_test
                if kind == "mlp":
                    ws = [torch.from_numpy(w).cuda() for w in spec["ws"]]
                    bs = [torch.from_numpy(b).cuda() for b in spec["bs"]]
                    sched = tuple(zip(spec["shifts"], spec["out_fmts"],
                                      spec["acts"]))
                    kern = lambda: K.model.fxp_mlp_model_cuda(qx, ws, bs,
                                                              sched)
                    plain = lambda: K.model.fxp_mlp_model_plain(qx, ws, bs,
                                                                sched)
                    out = kern()
                    macs = m * sum(w.shape[0] * w.shape[1] for w in ws)
                    nbytes = _nbytes(qx, *ws, *bs, out)
                    T.time("fxp_mlp_model", tag, m, kern, plain, nbytes,
                           2 * macs, T.dev.mma_peak(bits), record,
                           "fxp_mlp_model.cu", K.model.REPLACES,
                           profile=m >= n_test)
                    log_cuda_core_bound(T.dev, nbytes, 2 * macs, bits)
                else:
                    w = torch.from_numpy(spec["w"]).cuda()
                    b = torch.from_numpy(spec["b"]).cuda()
                    fmt, sh = spec["out_fmt"], spec["shift"]
                    kern = lambda: K.layer.fxp_layer_cuda(qx, w, b, fmt,
                                                          "none", sh)
                    plain = lambda: K.layer.fxp_layer_plain(qx, w, b, fmt,
                                                            "none", sh)
                    out = kern()
                    T.time("fxp_layer", tag, m, kern, plain,
                           _nbytes(qx, w, b, out), 2 * m * w.numel(),
                           T.dev.int_peak(bits), record, "fxp_layer.cu",
                           K.layer.REPLACES,
                           profile=tag == "fxp16" and m >= n_test)


def time_layer_wide(torch, K, T, arts, x_big, n_test):
    """fxp_layer's wide route (the integer tile shared with fxp_qmatmul) at
    the per-layer MLP route's first layer, 561 x 64, with its activation."""
    for tag in ("fxp16", "auto8", "fxp32"):
        spec = arts[("mlp", tag)].extras["emit_spec"]
        bits = spec["in_fmt"].total_bits
        w = torch.from_numpy(spec["ws"][0]).cuda()
        b = torch.from_numpy(spec["bs"][0]).cuda()
        layer = (spec["out_fmts"][0], spec["acts"][0], spec["shifts"][0])
        for m in (n_test, max(TIMED_BATCHES)):
            qx = K.fxp.quantize(torch.from_numpy(x_big[:m]).cuda(),
                                spec["in_fmt"])
            kern = lambda: K.layer.fxp_layer_cuda(qx, w, b, *layer)
            plain = lambda: K.layer.fxp_layer_plain(qx, w, b, *layer)
            out = kern()
            T.time("fxp_layer", f"{tag} 561x64", m, kern, plain,
                   _nbytes(qx, w, b, out), 2 * m * w.numel(),
                   T.dev.tile_peak(bits), False, "fxp_layer.cu",
                   K.layer.REPLACES, profile=True)


def path_steps(torch, tree, x):
    """Node compares the rows ``x`` (on the card; float32 or a container,
    cast as the kernel casts) need: the depth of the leaf each row
    reaches."""
    x = x.to(torch.float32)
    feat = torch.from_numpy(tree.feature.astype(np.int64)).to(x.device)
    thr = torch.from_numpy(tree.threshold.astype(np.float32)).to(x.device)
    left = torch.from_numpy(tree.left.astype(np.int64)).to(x.device)
    right = torch.from_numpy(tree.right.astype(np.int64)).to(x.device)
    node = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    steps = 0
    for _ in range(tree.n_nodes):
        f = feat[node]
        inner = f >= 0
        if not bool(inner.any()):
            break
        steps += int(inner.sum())
        xv = torch.gather(x, 1, f.clamp_min(0)[:, None])[:, 0]
        nxt = torch.where(xv <= thr[node], left[node], right[node])
        node = torch.where(inner, nxt, node)
    return steps


def time_tree_svm(torch, K, T, arts, tree_model, x_big, n_test):
    for tag in ("fxp16", "auto8", "fxp32", "flt"):
        # tree_ensemble: quantized rows cast to float32, or float rows
        art = arts[("tree", "D6", tag)]
        spec = art.extras.get("emit_spec")
        tree = tree_model.tree if spec is None else K.trees.TreeArrays(
            spec["feature"], spec["threshold"], spec["left"], spec["right"],
            spec["leaf_class"], spec["max_depth"], tree_model.tree.n_classes,
            tree_model.tree.n_features)
        node_bytes = 16 * tree.n_nodes  # one 16-byte record a node
        for m in TIMED_BATCHES:
            x = torch.from_numpy(x_big[:m]).cuda()
            if spec is not None:  # the container, as the lowering passes it
                x = K.fxp.quantize(x, spec["in_fmt"])
            kern = lambda: K.te.tree_ensemble_cuda(tree, x)
            plain = lambda: K.te.tree_ensemble_plain(tree, x)
            out = kern()
            steps = path_steps(torch, tree, x)
            if spec is None:
                # float32 rows are read whole (F finiteness tests each),
                # then one compare per node on each row's path
                ops, row_bytes = m * x.shape[1] + steps, _nbytes(x)
            else:
                # a container: the features on the path, one 32-byte
                # sector each
                ops, row_bytes = steps, 32 * steps
            T.time("tree_ensemble", tag, m, kern, plain,
                   row_bytes + _nbytes(out) + node_bytes, ops,
                   FP32_OPS_PER_S, tag == "fxp16" and m == n_test,
                   "tree_ensemble.cu", K.te.REPLACES,
                   profile=m >= n_test)
        if tag == "flt":
            continue
        # fxp_svm_model (rbf and poly) and the per-layer fxp_qmatmul
        for kind in ("svm-rbf", "svm-poly"):
            spec = arts[(kind, "D6", tag)].extras["emit_spec"]
            fmt, bits = spec["fmt"], spec["fmt"].total_bits
            sv, dual, b = (torch.from_numpy(spec[k]).cuda()
                           for k in ("sv", "dual", "b"))
            svt = sv.T.contiguous()
            (s, f), c = sv.shape, dual.shape[1]
            args = (spec["kernel"], fmt, spec["out_fmt"], spec["qgamma"],
                    spec["qcoef0"], spec["degree"], spec["dec_shift"])
            for m in TIMED_BATCHES:
                qx = K.fxp.quantize(torch.from_numpy(x_big[:m]).cuda(), fmt)
                kern = lambda: K.model.fxp_svm_model_cuda(qx, sv, dual, b,
                                                          *args)
                plain = lambda: K.model.fxp_svm_model_plain(qx, sv, dual, b,
                                                            *args)
                out = kern()
                T.time("fxp_svm_model", f"{tag} {kind[4:]}", m, kern, plain,
                       _nbytes(qx, sv, dual, b, out),
                       2 * m * (f * s + s * c), T.dev.int_peak(bits),
                       kind == "svm-rbf" and tag == "fxp16" and m == n_test,
                       "fxp_svm_model.cu", K.model.SVM_REPLACES,
                       profile=kind == "svm-rbf" and tag == "fxp16")
                if kind != "svm-rbf":
                    continue
                kern = lambda: K.qm.fxp_qmatmul_cuda(qx, svt, fmt)
                plain = lambda: K.qm.fxp_qmatmul_plain(qx, svt, fmt)
                out = kern()
                T.time("fxp_qmatmul", tag, m, kern, plain,
                       _nbytes(qx, svt, out), 2 * m * f * s,
                       T.dev.tile_peak(bits), tag == "fxp16" and m == n_test,
                       "fxp_qmatmul.cu", K.qm.REPLACES, profile=m >= n_test)
                if tag != "fxp16" or m < n_test:
                    continue
                # the per-layer route's decision stage: fxp_layer on the
                # (m, 300) kernel values and the (300, 6) duals
                kv = K.kref.svm_kernel_values(
                    out, qx, sv, "rbf", fmt, spec["qgamma"], spec["qcoef0"],
                    spec["degree"])
                dec = (spec["out_fmt"], "none", spec["dec_shift"])
                kern = lambda: K.layer.fxp_layer_cuda(kv, dual, b, *dec)
                plain = lambda: K.layer.fxp_layer_plain(kv, dual, b, *dec)
                out = kern()
                T.time("fxp_layer", f"{tag} svm-dec", m, kern, plain,
                       _nbytes(kv, dual, b, out), 2 * m * s * c,
                       T.dev.int_peak(bits), False, "fxp_layer.cu",
                       K.layer.REPLACES, profile=True)


def time_predict(art, x_big, what):
    for m in (TIMED_BATCHES[-2], TIMED_BATCHES[-1]):
        xb = x_big[:m]
        art.predict(xb)
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            art.predict(xb)
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        log(f"  predict {what:24s} batch {m:6d}: {ms:8.3f} ms, "
            f"{m / ms * 1e3:12.0f} rows/s")


def predict_breakdown(torch, K, art, x_big, batches, pinned=False):
    """Where one megakernel predict spends its time: each stage of
    ``predict`` run alone between synchronizations, host clock, median.
    ``pinned`` hands the rows over as the serving plane's staging buffer
    does (a pinned host tensor, copied without blocking); otherwise as a
    pageable numpy array."""
    spec = art.extras["emit_spec"]
    ws = [torch.from_numpy(w).cuda() for w in spec["ws"]]
    bs = [torch.from_numpy(b).cuda() for b in spec["bs"]]
    sched = tuple(zip(spec["shifts"], spec["out_fmts"], spec["acts"]))
    for m in batches:
        xb = np.ascontiguousarray(x_big[:m])
        if pinned:
            xb = torch.from_numpy(xb).pin_memory()
        state = {}
        stages = (
            ("copy rows to card", lambda: state.update(
                x=K.common.as_input(xb, art.device))),
            ("quantize + stats", lambda: state.update(
                q=K.fxp.quantize_with_stats(state["x"], spec["in_fmt"])[0])),
            ("fxp_mlp_model kernel", lambda: state.update(
                out=K.model.fxp_mlp_model_cuda(state["q"], ws, bs, sched))),
            ("argmax", lambda: state.update(
                lab=K.common.argmax_first(state["out"]))),
            ("copy labels to host", lambda: state["lab"].cpu().numpy()),
        )
        times = {name: [] for name, _ in stages}
        for _ in range(11):
            for name, fn in stages:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
        parts = ", ".join(f"{name} {float(np.median(t)):.3f}"
                          for name, t in times.items())
        log(f"  predict stages, mlp {art.target.number_format}, batch {m}, "
            f"{'pinned' if pinned else 'pageable'} rows (ms): {parts}")


def tree_predict_kernels(torch, K, art, x):
    """The device work of one quantized tree predict, beside the route of
    the port's first tree lowering (quantize, cast to float32, the kernel on
    the float rows), which the kernel's container input replaced."""
    spec = art.extras["emit_spec"]
    tree = K.trees.TreeArrays(
        spec["feature"], spec["threshold"], spec["left"], spec["right"],
        spec["leaf_class"], spec["max_depth"], 0, x.shape[1])
    xt = torch.from_numpy(x).cuda()
    routes = (
        ("predict", lambda: art.predict(x)),
        ("quantize + kernel on the container", lambda: K.te.tree_ensemble_cuda(
            tree, K.fxp.quantize_with_stats(xt, spec["in_fmt"])[0])),
        ("quantize + cast + kernel on float32 rows (the first lowering)",
         lambda: K.te.tree_ensemble_cuda(tree, K.fxp.quantize_with_stats(
             xt, spec["in_fmt"])[0].to(torch.float32))))
    for what, fn in routes:
        fn()
        prof = _kernel_profile(torch, fn)
        log(f"  tree {art.target.number_format} {what}, {len(x)} rows: "
            f"{prof['launches']} kernel launches, "
            f"{sum(prof['by_kind'].values()):.4f} ms device")


def _stacked(torch, arrays):
    return torch.stack([torch.from_numpy(a) for a in arrays]).cuda()


def time_slice(torch, K, T, arts_d, d6, d5):
    """The new kernels at the main paths' shapes: pwl_activation on the D6
    MLP's (rows, 64) hidden layer, fxp_mlp_fleet over the 8 D6 MLPs of
    path D, fxp_svm_fleet over its 4 D5 rbf SVMs, at 3089/3298 rows and
    65536; eight fxp_mlp_model launches beside the one fleet launch."""
    mlp = K.models.init_mlp([561, 64, 6], seed=0)
    w0 = torch.from_numpy(mlp.weights[0]).cuda()
    b0 = torch.from_numpy(mlp.biases[0]).cuda()
    for m in (len(d6.x_test), max(TIMED_BATCHES)):
        x = torch.from_numpy(np.resize(d6.x_test, (m, 561))).cuda()
        acc = x @ w0
        for v in ("pwl4", "rational"):
            # path C's hidden layer: the bias add in the kernel's launch
            kern = lambda: K.pwl.pwl_activation_cuda(acc, v, bias=b0)
            plain = lambda: K.pwl.pwl_activation_plain(acc, v, bias=b0)
            out = kern()
            T.time("pwl_activation", f"{v}+bias", m, kern, plain,
                   _nbytes(acc, b0, out), 9 * acc.numel(), FP32_OPS_PER_S,
                   v == "pwl4" and m == len(d6.x_test), "pwl_activation.cu",
                   K.pwl.REPLACES, profile=True,
                   shape=f"{v}(acc + bias) on the D6 MLP's ({m}, 64) hidden "
                         f"layer (path C)")
            unfused = lambda: K.pwl.pwl_activation_cuda(acc + b0, v)
            ms, host = cuda_ms(torch, unfused, 200 if m <= 3298 else 20)
            log(f"  {'':14s} the unfused pair (bias add, then the kernel "
                f"without bias): {ms:.4f} ms, host {host:.4f}, profiler "
                f"device {device_ms(torch, unfused):.4f}")
    specs = [arts_d[f"mlp{s}"].extras["emit_spec"] for s in range(8)]
    ws = [_stacked(torch, [sp["ws"][i] for sp in specs]) for i in range(2)]
    bs = [_stacked(torch, [sp["bs"][i] for sp in specs]) for i in range(2)]
    scheds = tuple(tuple(zip(sp["shifts"], sp["out_fmts"], sp["acts"]))
                   for sp in specs)
    bits = specs[0]["in_fmt"].total_bits
    for m in (len(d6.x_test), max(TIMED_BATCHES)):
        xf = torch.from_numpy(np.resize(d6.x_test, (m, 561))).cuda()
        qx = torch.stack([K.fxp.quantize(xf, sp["in_fmt"]) for sp in specs])
        kern = lambda: K.model.fxp_mlp_fleet_cuda(qx, ws, bs, scheds)
        plain = lambda: K.model.fxp_mlp_fleet_plain(qx, ws, bs, scheds)
        out = kern()
        macs = 8 * m * sum(w.shape[1] * w.shape[2] for w in ws)
        nbytes = _nbytes(qx, *ws, *bs, out)
        ms = T.time("fxp_mlp_fleet", "auto16 E=8", m, kern, plain,
                    nbytes, 2 * macs, T.dev.mma_peak(bits),
                    m == len(d6.x_test), "fxp_mlp_fleet.cu",
                    K.model.MLP_FLEET_REPLACES,
                    shape=f"8 D6 MLPs (auto16, per-model schedules) x {m} "
                          f"rows", profile=True)
        log_cuda_core_bound(T.dev, nbytes, 2 * macs, bits)
        solo = lambda: [K.model.fxp_mlp_model_cuda(
            qx[e], [w[e] for w in ws], [b[e] for b in bs], scheds[e])
            for e in range(8)]
        solo_ms, solo_host = cuda_ms(torch, solo, 50 if m <= 3298 else 5)
        log(f"  8 x fxp_mlp_model at {m} rows: {solo_ms:.4f} ms device "
            f"({solo_host:.4f} ms host) against one fxp_mlp_fleet launch "
            f"{ms:.4f} ms")
    specs = [arts_d[f"rbf{s}"].extras["emit_spec"] for s in range(4)]
    sv, dual, icept = (_stacked(torch, [sp[k] for sp in specs])
                       for k in ("sv", "dual", "b"))
    params = tuple((sp["fmt"], sp["out_fmt"], sp["qgamma"], sp["qcoef0"],
                    sp["degree"], sp["dec_shift"]) for sp in specs)
    (s_, f_), c_ = sv.shape[1:], dual.shape[2]
    for m in (64, len(d5.x_test), max(TIMED_BATCHES)):
        xf = torch.from_numpy(np.resize(d5.x_test, (m, f_))).cuda()
        qx = K.fxp.quantize(xf, specs[0]["fmt"]).expand(4, m, f_).contiguous()
        kern = lambda: K.model.fxp_svm_fleet_cuda(qx, sv, dual, icept, "rbf",
                                                  params)
        plain = lambda: K.model.fxp_svm_fleet_plain(qx, sv, dual, icept,
                                                    "rbf", params)
        out = kern()
        ms = T.time("fxp_svm_fleet", "fxp32 E=4", m, kern, plain,
                    _nbytes(qx, sv, dual, icept, out),
                    2 * 4 * m * (f_ * s_ + s_ * c_), T.dev.int_peak(32),
                    m == len(d5.x_test), "fxp_svm_fleet.cu",
                    K.model.SVM_FLEET_REPLACES,
                    shape=f"4 D5 rbf SVMs (fxp32, S={s_}) x {m} rows",
                    profile=True)
        solo = lambda: [K.model.fxp_svm_model_cuda(
            qx[e], sv[e], dual[e], icept[e], "rbf", *params[e])
            for e in range(4)]
        solo_ms, solo_host = cuda_ms(torch, solo, 50 if m <= 3298 else 5)
        log(f"  4 x fxp_svm_model at {m} rows: {solo_ms:.4f} ms "
            f"({solo_host:.4f} ms host; profiler device "
            f"{device_ms(torch, solo):.4f}) against one fxp_svm_fleet "
            f"launch {ms:.4f} ms")


def time_predict_device(torch, K, arts_d, d6):
    """Host time of FleetStack.predict_device beside the device time of
    the work it enqueues: a hidden synchronization would make the two
    equal."""
    stack = K.tc.stack_fleet([arts_d[f"mlp{s}"] for s in range(8)])
    for m in (64, 4096):
        buf = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
            np.resize(d6.x_test, (m, 561)), (8, m, 561)))).pin_memory()
        stack.predict_device(buf).cpu()
        host, total = [], []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = stack.predict_device(buf)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host.append((t1 - t0) * 1e3)
            total.append((t2 - t0) * 1e3)
        del out
        log(f"  FleetStack.predict_device, 8 D6 MLPs x {m} rows (pinned "
            f"{buf.numel() * 4 / 1e6:.1f} MB): host {np.median(host):.3f} "
            f"ms, until the card is done {np.median(total):.3f} ms")


def serving_record(torch, K, arts_d, rows):
    """The first serving record: 8 D6 MLP endpoints, 8 client threads each
    sending its endpoint 500 one-row requests, one in flight at a time,
    BatchingPolicy(max_batch=64, max_wait_ms=2.0), fleet off and on."""
    S = K.serve
    x = np.resize(rows, (500, 561))
    names = [f"mlp{s}" for s in range(8)]
    for fleet in (False, True):
        svc = S.InferenceService()
        try:
            for n in names:
                svc.register(n, artifact=arts_d[n],
                             policy=S.BatchingPolicy(max_batch=64,
                                                     max_wait_ms=2.0))
            if fleet and len(svc.enable_fleet()) != 1:
                raise AssertionError("the 8 MLPs did not form one fleet")
            for n in names:  # warm every bucket (and the stack) first
                svc.submit(n, x[:1]).result(timeout=300)
            lat = [[] for _ in names]

            def client(i):
                for r in range(500):
                    t0 = time.perf_counter()
                    svc.submit(names[i], x[r:r + 1]).result(timeout=300)
                    lat[i].append(time.perf_counter() - t0)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(8)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            wall = time.perf_counter() - t0
            if any(t.is_alive() for t in threads):
                raise AssertionError("a serving client did not finish")
            stats = svc.stats()
        finally:
            svc.close()
        ms = np.concatenate(lat) * 1e3
        if fleet:
            co = stats["_fleets"][0]
            extra = (f"fleet rounds {co['rounds']}, stack fallbacks "
                     f"{co['stack_fallbacks']}, coalescer assembly_s "
                     f"{co['assembly_s']:.4f}, device_s {co['device_s']:.4f}")
            if co["stack_fallbacks"] != 0:
                raise AssertionError(f"serving record: {co}")
        else:
            extra = ("endpoints' assembly_s "
                     f"{sum(stats[n]['assembly_s'] for n in names):.4f}, "
                     f"device_s {sum(stats[n]['device_s'] for n in names):.4f}"
                     f", staging allocs "
                     f"{[stats[n]['n_staging_allocs'] for n in names]}")
        log(f"  serving 8 MLP endpoints, fleet {'on ' if fleet else 'off'}: "
            f"{len(ms) / wall:.0f} requests/s, p50 "
            f"{np.percentile(ms, 50):.3f} ms, p99 {np.percentile(ms, 99):.3f}"
            f" ms over {len(ms)} requests in {wall:.2f} s; {extra}")


def _kernel_profile(torch, fn, cpu=True):
    """Device time by kernel kind and by name (ms), the number of kernel
    launches (the host's launch calls) and of device activities (kernels
    and copies, and their count by name) of one call of ``fn``, from
    torch.profiler's CPU and CUDA activity; with each aten op's own device
    time and the wall time under the profiler.  ``cpu=False`` records the
    CUDA activity alone (no aten op events, no op times): the trace of a
    call with ~10^5 launches is then minutes shorter to read."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind = {"flash_attention": 0.0, "pwl_activation": 0.0,
               "float32 GEMM": 0.0, "bf16 GEMM": 0.0, "other": 0.0}
    launches = activities = 0
    names, device_ms, ops = {}, {}, {}
    for e in prof.key_averages():
        if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx", "cuLaunchKernel",
                     "cudaLaunchKernelExC"):
            launches += e.count
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.self_device_time_total > 0:
                ops[e.key] = e.self_device_time_total / 1e3
            continue
        activities += e.count
        names[e.key] = e.count
        device_ms[e.key] = e.self_device_time_total / 1e3
        name = e.key
        ms = e.self_device_time_total / 1e3
        if "flash_attention_kernel" in name:
            by_kind["flash_attention"] += ms
        elif "pwl_activation_kernel" in name:
            by_kind["pwl_activation"] += ms
        elif "f32f32" in name or ("gemm" in name and "f32" in name):
            by_kind["float32 GEMM"] += ms
        elif any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma")):
            by_kind["bf16 GEMM"] += ms
        else:
            by_kind["other"] += ms
    return {"by_kind": by_kind, "launches": launches,
            "activities": activities, "names": names,
            "device_ms": device_ms, "ops": ops, "wall_ms": wall_ms}


def time_lm(torch, K, T, lm):
    """Path E's kernel at the prefill's shape — qwen2-0.5b's 14 heads x
    batch 4, 2048 tokens, dh 64, bf16, causal — beside its plain version,
    its bound and one PyTorch call that computes the same function
    (scaled_dot_product_attention, a yardstick the port never calls); then
    the whole prefill forward with the kernel's share of it, and decode
    ms/token at both served targets."""
    fa, M = K.fa, K.lm_model
    cfg, params = lm["cfg"], lm["params"]
    h, dh, s = cfg.n_heads, cfg.head_dim, LM_SEQ
    hkv, group = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    bh = LM_BATCH * h
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(bh, s, dh, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    # the grouped form path E launches: K/V of the 4 x 2 KV heads
    kg, vg = (t.view(LM_BATCH, h, s, dh)[:, ::group].reshape(
        LM_BATCH * hkv, s, dh).contiguous() for t in (k, v))
    pairs = s * (s + 1) // 2  # the causal (query, key) pairs this run needs
    flops = 4 * bh * dh * pairs
    out = fa.flash_attention_cuda(q, k, v, True)
    ungrouped_ms = T.time("flash_attention", "bf16 G=1", s,
                          lambda: fa.flash_attention_cuda(q, k, v, True),
                          lambda: fa.flash_attention_plain(q, k, v, True),
                          _nbytes(q, k, v, out), flops, BF16_TENSOR_OPS_PER_S,
                          False, "flash_attention.cu", fa.REPLACES)
    outg = fa.flash_attention_cuda(q, kg, vg, True)
    kern_ms = T.time("flash_attention", f"bf16 G={group}", s,
                     lambda: fa.flash_attention_cuda(q, kg, vg, True),
                     lambda: fa.flash_attention_plain(q, kg, vg, True),
                     _nbytes(q, kg, vg, outg), flops, BF16_TENSOR_OPS_PER_S,
                     True, "flash_attention.cu", fa.REPLACES,
                     shape=f"(BH {bh} = batch {LM_BATCH} x {h} heads, K/V "
                           f"{LM_BATCH * hkv} rows (G {group}), S {s}, dh "
                           f"{dh}) bf16 causal: one layer of the {LM_ARCH} "
                           f"prefill")
    q4, k4, v4 = (t.view(LM_BATCH, -1, s, dh) for t in (q, k, v))
    kg4, vg4 = (t.view(LM_BATCH, hkv, s, dh) for t in (kg, vg))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms, _ = cuda_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True), 200)
    lib_g_ms, _ = cuda_ms(torch, lambda: sdpa(q4, kg4, vg4, is_causal=True,
                                              enable_gqa=True), 200)
    err = float((sdpa(q4, k4, v4, is_causal=True).reshape(bh, s, dh).float()
                 - out.float()).abs().max())
    err_g = float((sdpa(q4, kg4, vg4, is_causal=True, enable_gqa=True)
                   .reshape(bh, s, dh).float() - outg.float()).abs().max())
    T.records["flash_attention"]["library_ms"] = lib_g_ms
    T.records["flash_attention"]["ungrouped_ms"] = ungrouped_ms
    T.records["flash_attention"]["ungrouped_library_ms"] = lib_ms
    log(f"  scaled_dot_product_attention (library yardstick) on the same "
        f"tensors: {lib_ms:.4f} ms ungrouped (max abs diff from the kernel "
        f"{err:.3e}; kernel / library {ungrouped_ms / lib_ms:.2f}x), "
        f"{lib_g_ms:.4f} ms with enable_gqa (max abs diff {err_g:.3e}; "
        f"kernel / library {kern_ms / lib_g_ms:.2f}x); kernel at "
        f"{flops / kern_ms / 1e9:.1f} Tflop/s")
    del q, k, v, kg, vg, out, outg, q4, k4, v4, kg4, vg4
    tok = _lm_tokens(torch, cfg, (LM_BATCH, LM_SEQ), 0)
    fwd_ms, fwd_host = cuda_ms(torch, lambda: M.forward(params,
                                                        {"tokens": tok}, cfg), 5)
    ref_ms, _ = cuda_ms(torch, lambda: M.forward(
        params, {"tokens": tok}, cfg, attn_impl="ref"), 3)
    body = cfg.param_count() - cfg.vocab_size * cfg.d_model  # minus the table
    n_tok = LM_BATCH * LM_SEQ
    flops = (2 * n_tok * body + 2 * n_tok * cfg.d_model * cfg.vocab_size
             + cfg.n_layers * 4 * LM_BATCH * h * dh * pairs)
    log(f"  prefill forward {LM_BATCH} x {LM_SEQ} bf16: {fwd_ms:.3f} ms "
        f"({fwd_host:.3f} ms host); flash_attention {cfg.n_layers} x "
        f"{kern_ms:.4f} = {cfg.n_layers * kern_ms:.3f} ms, "
        f"{cfg.n_layers * kern_ms / fwd_ms:.1%} of it; bound "
        f"{flops / BF16_TENSOR_OPS_PER_S * 1e3:.3f} ms ({flops / 1e12:.3f} "
        f"Tflop at the bf16 tensor-core rate); with the oracle's attention "
        f"in place of the kernel: {ref_ms:.3f} ms")
    prefill = _kernel_profile(torch, lambda: M.forward(params,
                                                       {"tokens": tok}, cfg))
    total = sum(prefill["by_kind"].values())
    log(f"  prefill forward by kernel kind (torch.profiler, device time): "
        + ", ".join(f"{k} {v:.3f} ms ({v / total:.1%})"
                    for k, v in prefill["by_kind"].items())
        + f"; {prefill['launches']} launches")
    cache = M.init_cache(cfg, LM_GEN_BATCH, 8, tok.device)
    step = _kernel_profile(torch, lambda: M.serve_step(
        params, cache, {"token": tok[:LM_GEN_BATCH, 0]}, cfg))
    log(f"  one flt decode step, batch {LM_GEN_BATCH}: "
        f"{sum(step['by_kind'].values()):.3f} ms of device time in "
        f"{step['launches']} launches (host-bound when ms/token is above "
        f"it)")
    for name, st in lm["serving"].items():
        log(f"  decode {name}: {st['ms_per_token']:.3f} ms/token at batch "
            f"{LM_GEN_BATCH} (host clock over {LM_GEN_TOKENS} tokens); "
            f"weights read per token {st['flash_bytes']} bytes, bound "
            f"{st['flash_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms")


def time_flash_mla(torch, K, T, launches_mla):
    """The kernel's dh-192 instance at path I's deepseek-v3 prefill shape —
    128 heads x batch 2, 8192 tokens, q/k 128 + 64 dims, v 128 zero-padded
    to 192 (MLA's padding), bf16, causal, ungrouped — checked on its first
    FLASH_CHECK_HEADS heads against the plain version (FLASH_BF16_ATOL and
    the row bound; the padded output columns exactly 0), beside its bound
    and scaled_dot_product_attention on the same tensors (a yardstick the
    port never calls), kept in flash_attention's record as ``dh192_*``.
    The bound is the MLA function's: q.k over 192 dims and p.v over 128 a
    pair, v and the output 128 wide (the padded columns are zeros the
    layer never needs); the padded dh-192 problem's is printed beside."""
    fa = K.fa
    b, h, s, dh, dv = 2, 128, 8192, 192, 128
    bh = b * h
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(bh, s, dh, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    v[..., dv:] = 0
    pairs = s * (s + 1) // 2
    flops = 2 * bh * pairs * (dh + dv)
    nbytes = bh * s * (dh + dh + dv + dv) * q.element_size()
    out = fa.flash_attention_cuda(q, k, v, True)
    n = FLASH_CHECK_HEADS
    want = fa.flash_attention_plain(q[:n], k[:n], v[:n], True)
    err = float((out[:n].float() - want.float()).abs().max())
    rel = row_rel_err(out[:n], want)
    pad_nonzero = int((out[..., dv:] != 0).sum())
    del want
    if (err > FLASH_BF16_ATOL or rel > FLASH_BF16_ROW_RTOL or pad_nonzero
            or not bool(torch.isfinite(out).all())):
        raise AssertionError(f"flash_attention dh 192 at (BH {bh}, S {s}): "
                             f"heads 0..{n - 1} max abs err {err} (bound "
                             f"{FLASH_BF16_ATOL}), row rel err {rel} (bound "
                             f"{FLASH_BF16_ROW_RTOL}) against the plain "
                             f"version; {pad_nonzero} nonzero padded outputs")
    ms, host_ms = cuda_ms(torch, lambda: fa.flash_attention_cuda(q, k, v,
                                                                 True), 5)
    bound_ms, bound_by = T.dev.bound(nbytes, flops, BF16_TENSOR_OPS_PER_S)
    pad_bound_ms, pad_by = T.dev.bound(_nbytes(q, k, v, out),
                                       4 * bh * pairs * dh,
                                       BF16_TENSOR_OPS_PER_S)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (t.view(b, h, s, dh) for t in (q, k, v))
    lib_ms, _ = cuda_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True), 5)
    lib_err = float((sdpa(q4, k4, v4, is_causal=True).reshape(bh, s, dh)
                     .float() - out.float()).abs().max())
    rec = T.records["flash_attention"]
    rec.update(instances=list(fa.HEAD_DIMS), dh192_ms=ms,
               dh192_bound_ms=bound_ms, dh192_bound_by=bound_by,
               dh192_padded_bound_ms=pad_bound_ms,
               dh192_max_abs_err=err, dh192_row_rel_err=rel,
               dh192_library_ms=lib_ms, dh192_launches=launches_mla,
               dh192_shape=f"(BH {bh} = batch {b} x {h} heads, S {s}, dh "
                           f"{dh}, v padded from {dv}) bf16 causal: one MLA "
                           f"layer of path I's deepseek-v3 prefill")
    log(f"  flash_attention dh 192 at {rec['dh192_shape']}: heads 0..{n - 1}"
        f" within {err:.3e} (max abs, bound {FLASH_BF16_ATOL}) and "
        f"{rel:.3e} (row, bound {FLASH_BF16_ROW_RTOL}) of the plain version,"
        f" padded columns 0; {ms:.3f} ms ({host_ms:.3f} ms host), "
        f"{flops / ms / 1e9:.1f} Tflop/s of the MLA function's "
        f"{flops / 1e12:.3f} Tflop; bound {bound_ms:.3f} ms ({bound_by}: "
        f"q.k 192 + p.v {dv} dims a pair, {nbytes} bytes; the padded dh-192 "
        f"problem's {pad_bound_ms:.3f} ms, {pad_by}); "
        f"scaled_dot_product_attention {lib_ms:.3f} ms (max abs diff "
        f"{lib_err:.3e}; kernel / library {ms / lib_ms:.2f}x); "
        f"{launches_mla} launches on path I (deepseek-v3)")
    del q, k, v, out, q4, k4, v4


def time_flash_window(torch, K, T, launches_window):
    """The kernel with a sliding window at path J's zamba2 shape — 32 heads
    x batch 2, 8192 tokens, dh 112 (padded to 128 by the wrapper), window
    4096, bf16, causal — its first FLASH_CHECK_HEADS heads held to the plain
    version (FLASH_BF16_ATOL and the row bound), beside its bound, the same
    kernel without the window, and scaled_dot_product_attention with the
    same boolean window mask (a yardstick the port never calls); kept in
    flash_attention's record as ``window_*``.  The bound counts the
    (query, key) pairs the window leaves: q.k and p.v over 112 dims a
    pair, each input read and the output written once."""
    fa = K.fa
    b, h, s, dh, w = 2, 32, 8192, 112, 4096
    bh = b * h
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(bh, s, dh, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out = fa.flash_attention_cuda(q, k, v, True, w)
    n = FLASH_CHECK_HEADS
    want = fa.flash_attention_plain(q[:n], k[:n], v[:n], True, window=w)
    err = float((out[:n].float() - want.float()).abs().max())
    rel = row_rel_err(out[:n], want)
    del want
    if (err > FLASH_BF16_ATOL or rel > FLASH_BF16_ROW_RTOL
            or not bool(torch.isfinite(out).all())):
        raise AssertionError(f"flash_attention window {w} at (BH {bh}, S "
                             f"{s}, dh {dh}): heads 0..{n - 1} max abs err "
                             f"{err} (bound {FLASH_BF16_ATOL}), row rel err "
                             f"{rel} (bound {FLASH_BF16_ROW_RTOL})")
    kern = lambda: fa.flash_attention_cuda(q, k, v, True, w)  # noqa: E731
    ms, host_ms = cuda_ms(torch, kern, 10)
    dev = device_ms(torch, kern, iters=5)
    causal_ms, _ = cuda_ms(torch, lambda: fa.flash_attention_cuda(q, k, v,
                                                                  True), 5)
    pairs = w * (w + 1) // 2 + (s - w) * w  # a head's pairs in the window
    flops = 2 * bh * pairs * (dh + dh)
    nbytes = _nbytes(q, k, v, out)
    bound_ms, bound_by = T.dev.bound(nbytes, flops, BF16_TENSOR_OPS_PER_S)
    pos = torch.arange(s, device="cuda")
    diff = pos[:, None] - pos[None, :]
    mask = (diff >= 0) & (diff < w)  # True: the key is attended
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (t.view(b, h, s, dh) for t in (q, k, v))
    lib = lambda: sdpa(q4, k4, v4, attn_mask=mask)  # noqa: E731
    lib_ms, _ = cuda_ms(torch, lib, 5)
    lib_err = float((lib().reshape(bh, s, dh).float() - out.float())
                    .abs().max())
    rec = T.records["flash_attention"]
    rec.update(window_ms=ms, window_device_ms=dev, window_bound_ms=bound_ms,
               window_bound_by=bound_by, window_library_ms=lib_ms,
               window_causal_ms=causal_ms, window_max_abs_err=err,
               window_row_rel_err=rel, window_launches=launches_window,
               window_shape=f"(BH {bh} = batch {b} x {h} heads, S {s}, dh "
                            f"{dh} padded to 128, window {w}) bf16 causal: "
                            f"one shared-block call of path J's zamba2 "
                            f"prefill")
    log(f"  flash_attention window at {rec['window_shape']}: heads 0.."
        f"{n - 1} within {err:.3e} (max abs, bound {FLASH_BF16_ATOL}) and "
        f"{rel:.3e} (row, bound {FLASH_BF16_ROW_RTOL}) of the plain version; "
        f"{ms:.3f} ms ({host_ms:.3f} ms host; profiler device {dev:.3f} ms), "
        f"{flops / ms / 1e9:.1f} Tflop/s of the window's {flops / 1e12:.4f} "
        f"Tflop ({pairs} pairs a head); bound {bound_ms:.3f} ms ({bound_by}; "
        f"{nbytes} bytes); the same kernel without the window {causal_ms:.3f}"
        f" ms; scaled_dot_product_attention with the window mask "
        f"{lib_ms:.3f} ms (max abs diff {lib_err:.3e}; kernel / library "
        f"{ms / lib_ms:.2f}x); {launches_window} launches on path J (zamba2)")
    del q, k, v, out, q4, k4, v4, mask, diff


def time_flash_longdoc(torch, K, T):
    """The kernel at the longdoc cell's shapes — LLaVA's 32 query heads
    over 8 KV heads (G 4), dh 128, bf16, causal, S 8192 and 24960 (the
    traffic's longest) — beside its bound, each launch on the wgmma
    design; at S 8192 its first FLASH_CHECK_HEADS heads held to the plain
    version.  Kept in flash_attention's record as ``longdoc_*``."""
    fa = K.fa
    bh, group, dh = 32, 4, 128
    gen = torch.Generator(device="cuda").manual_seed(6)
    rec = T.records["flash_attention"]
    for s in (8192, 24960):
        q = torch.randn(bh, s, dh, generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn(bh // group, s, dh, generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        before = fa.flash_attention_cuda.wgmma_launches
        out = fa.flash_attention_cuda(q, k, v, True)
        if fa.flash_attention_cuda.wgmma_launches != before + 1:
            raise AssertionError("flash_attention at dh 128 in bf16 did not "
                                 "launch the wgmma design")
        checked = ""
        if s == 8192:
            n = FLASH_CHECK_HEADS
            want = fa.flash_attention_plain(q[:n], k[:n // group],
                                            v[:n // group], True)
            err = float((out[:n].float() - want.float()).abs().max())
            rel = row_rel_err(out[:n], want)
            del want
            if err > FLASH_BF16_ATOL or rel > FLASH_BF16_ROW_RTOL:
                raise AssertionError(f"flash_attention longdoc S {s}: heads "
                                     f"0..{n - 1} max abs err {err}, row rel "
                                     f"err {rel} against the plain version")
            checked = (f"heads 0..{n - 1} within {err:.3e} (max abs) and "
                       f"{rel:.3e} (row) of the plain version; ")
        ms, host_ms = cuda_ms(torch, lambda: fa.flash_attention_cuda(
            q, k, v, True), 5)
        flops = 4 * bh * dh * (s * (s + 1) // 2)
        bound_ms, bound_by = T.dev.bound(_nbytes(q, k, v, out), flops,
                                         BF16_TENSOR_OPS_PER_S)
        rec.update({f"longdoc_{s}_ms": ms, f"longdoc_{s}_bound_ms": bound_ms})
        log(f"  flash_attention longdoc (BH {bh}, K/V {bh // group} rows (G "
            f"{group}), S {s}, dh {dh}) bf16 causal: {checked}{ms:.3f} ms "
            f"({host_ms:.3f} ms host), {flops / ms / 1e9:.1f} Tflop/s; bound "
            f"{bound_ms:.3f} ms ({bound_by}), {bound_ms / ms:.1%} of it")
        del q, k, v, out


def time_lm_gate(torch, K, T, lm):
    """Path E's pwl4 SiLU gate: the kernel (silu_pwl4) at the decode (4,
    4864) and bf16 prefill (4 x 2048, 4864) shapes beside its plain version,
    its bytes bound and the op-by-op gate it replaced; a bf16 prefill
    forward at the pwl4 gate and one decode step of the served
    fxp8/qnm/int8-KV/pwl4 artifact by torch.profiler, with the gate through
    the kernel and op by op; and decode ms/token of that artifact with the
    two gate routes in turns (op by op, kernel, kernel, op by op)."""
    M, cfg, params = K.lm_model, lm["cfg"], lm["params"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    for rows, what in ((LM_GEN_BATCH, "decode"),
                       (LM_BATCH * LM_SEQ, "bf16 prefill")):
        x = (torch.randn(rows, cfg.d_ff, generator=gen, device="cuda")
             * 4).to(torch.bfloat16)
        kern = lambda: K.pwl.pwl_activation_cuda(x, "silu_pwl4")
        plain = lambda: K.pwl.pwl_activation_plain(x, "silu_pwl4")
        out = kern()
        T.time("pwl_activation", "silu_pwl4", rows, kern, plain,
               _nbytes(x, out), 8 * x.numel(), FP32_OPS_PER_S, False,
               "pwl_activation.cu", K.pwl.REPLACES, profile=True)
        eager = lambda: x * K.acts.sigmoid_pwl4(x)
        ms, host = cuda_ms(torch, eager, 200 if rows <= 3298 else 20)
        prof = _kernel_profile(torch, eager)
        log(f"  {'':14s} the op-by-op gate x * sigmoid_pwl4(x) at the "
            f"{what} shape ({rows}, {cfg.d_ff}) bf16: {ms:.4f} ms, host "
            f"{host:.4f}, {prof['launches']} launches, "
            f"{sum(prof['by_kind'].values()):.4f} ms device")
    tok = _lm_tokens(torch, cfg, (LM_BATCH, LM_SEQ), 0)
    cfg_g = dataclasses.replace(cfg, gate_sigmoid="pwl4")
    gate_bytes = 2 * LM_BATCH * LM_SEQ * cfg.d_ff * 2  # bf16 in and out
    for kernel in (False, True):
        with gate_route(K, kernel):
            prof = _kernel_profile(torch, lambda: M.forward(
                params, {"tokens": tok}, cfg_g))
        by = prof["by_kind"]
        route = "through the kernel" if kernel else "op by op"
        log(f"  prefill forward {LM_BATCH} x {LM_SEQ} bf16 at the pwl4 "
            f"gate, gate {route}: "
            f"{prof['launches']} launches, {prof['activities']} device "
            f"activities, {sum(by.values()):.3f} ms device; pwl_activation "
            f"{by['pwl_activation']:.4f} ms = {cfg.n_layers} x "
            f"{by['pwl_activation'] / cfg.n_layers:.4f} ms a layer (bytes "
            f"bound {gate_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms a layer); "
            f"other {by['other']:.3f} ms")
    art = lm["serving"]["fxp8_qnm_kv8_pwl4"]["artifact"]
    acfg, ap = art.extras["cfg"], art.extras["params"]
    cache = M.init_cache(acfg, LM_GEN_BATCH, 8, tok.device)
    for kernel in (False, True):
        with gate_route(K, kernel):
            step = _kernel_profile(torch, lambda: M.serve_step(
                ap, cache, {"token": tok[:LM_GEN_BATCH, 0]}, acfg))
        route = "through the kernel" if kernel else "op by op"
        log(f"  one fxp8/qnm/int8-KV/pwl4 decode step, batch "
            f"{LM_GEN_BATCH}, gate {route}: "
            f"{step['launches']} launches, {step['activities']} device "
            f"activities, {sum(step['by_kind'].values()):.3f} ms device")
    start = np.random.RandomState(2).randint(
        1, cfg.vocab_size, (LM_GEN_BATCH,)).astype(np.int32)
    readings = {False: [], True: []}
    turns = (False, True, True, False) * 2
    for kernel in turns:
        with gate_route(K, kernel):
            art.extras["generate"](start, 2)
            t0 = time.perf_counter()
            art.extras["generate"](start, LM_GEN_TOKENS)
            readings[kernel].append(
                (time.perf_counter() - t0) * 1e3 / LM_GEN_TOKENS)
    order = {False: iter(readings[False]), True: iter(readings[True])}
    log(f"  decode fxp8/qnm/int8-KV/pwl4 ms/token at batch {LM_GEN_BATCH} "
        f"(host clock over {LM_GEN_TOKENS} tokens), the gate op by op (o) "
        f"and through the kernel (k) in turns: "
        + " / ".join(f"{'k' if k else 'o'} {next(order[k]):.3f}"
                     for k in turns)
        + f"; median o {np.median(readings[False]):.3f}, k "
        f"{np.median(readings[True]):.3f}")


@contextlib.contextmanager
def unfused_bias():
    """Path C's lowering with the bias add outside the kernel's launch (the
    route before the fused bias): ``ops.pwl_activation`` adds it first."""
    from repro_torch.kernels import ops

    fused = ops.pwl_activation

    def unfused(x, variant="pwl4", impl="cuda", bias=None):
        return fused(x if bias is None else x + bias, variant, impl)

    ops.pwl_activation = unfused
    try:
        yield
    finally:
        ops.pwl_activation = fused


def flt_pwl_predict(torch, K, x_big):
    """Path C's predict (the flt D6 MLP, pwl4 sigmoid, ``cuda``) at 1, 64,
    3089 and 65536 rows: its device activities, kernel launches and device
    time by kernel (its stages) by torch.profiler, beside the same lowering
    with the bias added outside the kernel (labels equal), and both
    predicts end to end (host clock, median of 10)."""
    mlp = K.models.init_mlp([561, 64, 6], seed=0)
    art = K.tc.compile(mlp, K.tc.Target(sigmoid="pwl4", backend="cuda"))

    def median_ms(fn, n):
        fn()
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    for m in TIMED_BATCHES:
        xb = np.ascontiguousarray(x_big[:m])
        fused_p = _kernel_profile(torch, lambda: art.predict(xb))
        fused_ms = median_ms(lambda: art.predict(xb), 10)
        with unfused_bias():
            unfused_labels = art.predict(xb)
            unfused_p = _kernel_profile(torch, lambda: art.predict(xb))
            unfused_ms = median_ms(lambda: art.predict(xb), 10)
        if not np.array_equal(art.predict(xb), unfused_labels):
            raise AssertionError(f"path C, {m} rows: the fused bias changes "
                                 f"labels")
        if unfused_p["launches"] != fused_p["launches"] + 1:
            raise AssertionError(f"path C, {m} rows: {fused_p['launches']} "
                                 f"launches with the fused bias, "
                                 f"{unfused_p['launches']} without: not one "
                                 f"fewer")
        stages = ", ".join(f"{name[:48]} {ms:.4f}"
                           for name, ms in fused_p["device_ms"].items())
        log(f"  path C predict, flt pwl4 MLP, batch {m}: fused bias "
            f"{fused_p['activities']} device activities "
            f"({fused_p['launches']} kernel launches), unfused "
            f"{unfused_p['activities']} ({unfused_p['launches']}); labels "
            f"equal; predict {fused_ms:.3f} ms, unfused {unfused_ms:.3f} "
            f"ms; device ms by kernel: {stages}")


def timing(torch, K, dev, d6, d5, check, arts_a, arts_b, arts_d, tree_model,
           launches, lm, families, recurrent):
    x_big = np.resize(d6.x_test, (max(TIMED_BATCHES), d6.x_test.shape[1]))
    n_test = len(d6.x_test)
    T = Timer(torch, dev, check, launches)
    time_lm(torch, K, T, lm)
    time_flash_mla(torch, K, T, families[FAMILY_QUANT]["flash_launches"])
    time_flash_window(torch, K, T, recurrent["zamba2-7b"]["flash_launches"])
    time_flash_longdoc(torch, K, T)
    time_lm_gate(torch, K, T, lm)
    time_mlp(torch, K, T, arts_a, x_big, n_test)
    time_tree_svm(torch, K, T, arts_b, tree_model, x_big, n_test)
    time_layer_wide(torch, K, T, arts_a, x_big, n_test)
    time_slice(torch, K, T, arts_d, d6, d5)
    time_predict_device(torch, K, arts_d, d6)
    flt_pwl_predict(torch, K, x_big)
    predict_breakdown(torch, K, arts_a[("mlp", "fxp16")], x_big,
                      (n_test, max(TIMED_BATCHES)))
    for pinned in (False, True):
        predict_breakdown(torch, K, arts_d["mlp0"], x_big, (64, 4096),
                          pinned=pinned)
    serving_record(torch, K, arts_d, d6.x_test)
    log("  predict end to end (host clock around predict -> numpy labels)")
    for tag in TAGS:
        for kind in ("mlp", "logistic"):
            time_predict(arts_a[(kind, tag)], x_big, f"{kind} {tag}")
    for key in (("tree", "D6", "fxp16"), ("tree", "D6", "flt"),
                ("svm-rbf", "D6", "fxp16"), ("svm-poly", "D6", "fxp16")):
        time_predict(arts_b[key], x_big, " ".join(key[::2]))
    tree_predict_kernels(torch, K, arts_b[("tree", "D6", "fxp16")],
                         d6.x_test)
    tuner_predict_cost(torch, K, arts_a, x_big)
    return [T.records[n] for n in KernelCheck.NAMES]


# the record of each tuned kernel: phase 3T's sweep at its main path's shape
TUNED_RECORD = {"fxp_qmatmul": ("(m, 561) x (561, 300)", 3089),
                "fxp_layer": ("narrow (m, 561) x (561, 6)", 3089),
                "fxp_mlp_model": ("561->64->6", 3089),
                "fxp_svm_model": ("rbf (m, 561), S 300, C 6", 3089),
                "fxp_mlp_fleet": ("8 x 561->64->6", 3089),
                "fxp_svm_fleet": ("4 x rbf (m, 8), S 300, C 10",
                                  TUNE_SVM_FLEET_M)}


def add_tuned(kernels, tuned):
    """Each tuned kernel's record gains phase 3T's choice at its main shape
    (fxp16): the chosen blocking and today's, each with its sweep time."""
    for rec in kernels:
        if rec["name"] not in TUNED_RECORD:
            continue
        label, m = TUNED_RECORD[rec["name"]]
        chosen, ms, today, today_ms = tuned[(rec["name"], label)][m]
        rec.update(blocks=_blk(chosen), blocks_ms=ms,
                   blocks_today=_blk(today), blocks_today_ms=today_ms,
                   blocks_shape=f"fxp16 {label}, m {m}")


def tuner_predict_cost(torch, K, arts_a, x_big):
    """Host ms of path A's predict (fxp16 MLP and logistic) at 1 and 3089
    rows with the tuner's warm lookup, beside the same calls with today's
    blocking passed as an override (no lookup), in turns."""
    T, ops = K.tune, K.ops
    log("  predict with the tuner's lookup beside an override of today's "
        "blocking (host clock, median of 200 in turns)")
    for kind, fn_name in (("mlp", "fxp_mlp_model"), ("logistic", "fxp_layer")):
        art = arts_a[(kind, "fxp16")]
        orig = getattr(ops, fn_name)
        for m in (1, 3089):
            xb = x_big[:m]
            mb = T.batch_bucket(m, cap=1 << 30)
            if kind == "mlp":
                today = T.model_candidates("mlp", (561, 64, 6), 16)[0]
                pinned = lambda *a, **k: orig(*a, bm=today, **k)  # noqa
            else:
                occ = K.layer.narrow_occupancy(561, 6, 16,
                                               torch.device("cuda"))
                today = T.candidates("layer", mb, 561, 6, 16, occ)[0]
                pinned = lambda *a, **k: orig(*a, blocks=today, **k)  # noqa
            times = {"tuner": [], "override": []}
            art.predict(xb)
            for _ in range(200):
                for how in ("tuner", "override"):
                    setattr(ops, fn_name, pinned if how == "override"
                            else orig)
                    try:
                        t0 = time.perf_counter()
                        art.predict(xb)
                        times[how].append(time.perf_counter() - t0)
                    finally:
                        setattr(ops, fn_name, orig)
            med = {h: float(np.median(v)) * 1e3 for h, v in times.items()}
            log(f"  predict {kind} fxp16 batch {m:5d}: tuner {med['tuner']:.4f}"
                f" ms, override of today's {_blk(today)} "
                f"{med['override']:.4f} ms")


def check_tensor_core_sass(build):
    """Count the tensor-core MMA instructions in the SASS of each instance
    of the kernels in TENSOR_CORE_SASS (HGMMA for bf16 flash_attention, IMMA
    for the 8- and 16-bit MLP megakernels), where the toolkit's cuobjdump
    exists; fail if an instance that must use the tensor cores has none."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.access(tool, os.X_OK):
        log("  cuobjdump not found: MMA counts not taken")
        return
    for lib, part, opcode in TENSOR_CORE_SASS:
        sass = subprocess.run([tool, "-sass", str(build._library_path(lib))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = 0
            elif fn is not None and opcode in line:
                counts[fn] += 1
        for fn, n in counts.items():
            log(f"  SASS {lib} {fn}: {n} {opcode}")
        need = {fn: n for fn, n in counts.items() if part in fn}
        if not need or not all(need.values()):
            raise AssertionError(f"{lib} instances without {opcode} in their "
                                 f"SASS: {need}")


def namespace():
    """The port's modules that the phases use, and each kernel's launcher
    (whose ``launches`` count the main paths read)."""
    from repro_torch import compile as tc
    from repro_torch import models
    from repro_torch.compile.lowerings import common
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.core import trees
    from repro_torch import serve
    from repro_torch import configs
    from repro_torch import emit
    from repro_torch.kernels import (flash_attention, fxp_layer, fxp_model,
                                     fxp_qmatmul, pwl_activation,
                                     tree_ensemble, tune)
    from repro_torch.kernels import ref as kernels_ref
    from repro_torch.core import activations as acts
    from repro_torch.lm import layers as lm_layers
    from repro_torch.lm import mamba2
    from repro_torch.lm import model as lm_model
    from repro_torch.lm import moe
    from repro_torch.lm import rwkv6
    from repro_torch.models.svm import _pick_prototypes
    from repro_torch import roofline
    from repro_torch import sharding
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.kernels import ops
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optim, trainer

    return types.SimpleNamespace(
        tc=tc, models=models, common=common, fxp=fxp, trees=trees,
        layer=fxp_layer, model=fxp_model, qm=fxp_qmatmul, te=tree_ensemble,
        pwl=pwl_activation, serve=serve, pick_prototypes=_pick_prototypes,
        fa=flash_attention, lm_model=lm_model, lm_layers=lm_layers, moe=moe,
        mamba=mamba2, rwkv=rwkv6,
        acts=acts, emit=emit, ckpt=ckpt, optim=optim, trainer=trainer,
        roofline=roofline, ops=ops, configs=configs, tune=tune,
        kref=kernels_ref, sharding=sharding, mesh=launch_mesh,
        launchers={"fxp_layer": fxp_layer.fxp_layer_cuda,
                   "fxp_mlp_model": fxp_model.fxp_mlp_model_cuda,
                   "fxp_qmatmul": fxp_qmatmul.fxp_qmatmul_cuda,
                   "fxp_svm_model": fxp_model.fxp_svm_model_cuda,
                   "tree_ensemble": tree_ensemble.tree_ensemble_cuda,
                   "pwl_activation": pwl_activation.pwl_activation_cuda,
                   "fxp_mlp_fleet": fxp_model.fxp_mlp_fleet_cuda,
                   "fxp_svm_fleet": fxp_model.fxp_svm_fleet_cuda,
                   "flash_attention": flash_attention.flash_attention_cuda})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on a GPU host",
              file=sys.stderr)
        return 2
    from repro_torch import models
    from repro_torch.data import load_dataset
    from repro_torch.kernels import build

    K = namespace()
    t_start = time.perf_counter()
    dev = Device(torch)
    # a fresh tuner file for this run (inherited by every process it starts)
    tune_file = os.path.join(ROOT, "build", "chip_smoke_tune_cache.json")
    os.makedirs(os.path.dirname(tune_file), exist_ok=True)
    for path in (tune_file, tune_file + ".lock"):
        if os.path.exists(path):
            os.remove(path)
    os.environ["REPRO_TORCH_TUNE_CACHE"] = tune_file
    K.tune.clear_memory_cache()

    t0 = time.perf_counter()
    built = build.build_all()
    log(f"phase 2: built {list(built)} in {time.perf_counter() - t0:.1f} s "
        f"(per library: { {k: round(v, 1) for k, v in built.items()} })")
    for name, out in build.BUILD_LOG.items():
        for line in out.splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or (name in REDESIGNED and "entry function" in line)):
                log(f"  ptxas {name}: {line.strip()}")
    check_tensor_core_sass(build)
    t0 = time.perf_counter()
    d6, d5 = load_dataset("D6"), load_dataset("D5")
    log(f"  D6 and D5 generated in {time.perf_counter() - t0:.1f} s: D6 train "
        f"{d6.x_train.shape}, test {d6.x_test.shape}; D5 train "
        f"{d5.x_train.shape}, test {d5.x_test.shape}")
    t0 = time.perf_counter()
    tree_model = models.train_decision_tree(d6.x_train, d6.y_train,
                                            d6.n_classes, max_depth=TREE_DEPTH)
    log(f"  D6 tree trained in {time.perf_counter() - t0:.1f} s: "
        f"{tree_model.tree.n_nodes} nodes, {tree_model.tree.n_leaves} leaves")

    t0 = time.perf_counter()
    check = KernelCheck(torch, K)
    check.run(tree_model.tree, d6.x_test)
    log(f"  phase 3 took {time.perf_counter() - t0:.1f} s")
    tuned = tuner_phase(torch, K, check)

    arts_a, launches_a = main_path_mlp(torch, K, d6)
    arts_b, launches_b = main_path_tree_svm(torch, K, d6, d5, tree_model)
    emit_c_phase(K, arts_a, arts_b, d6, d5)
    launches_c = main_path_flt_pwl(torch, K, d6)
    launches_d, arts_d = main_path_serving(torch, K, d6, d5, tree_model)
    launches_e, lm = main_path_lm(torch, K)
    launches_g = main_path_pipeline(torch, K, d6, tree_model)
    launches_h, trained = main_path_train(torch, K)
    t0 = time.perf_counter()
    launches_i, families = main_path_families(torch, K)
    log(f"  phase 4I took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches_j, recurrent = main_path_recurrent(torch, K)
    log(f"  phase 4J took {time.perf_counter() - t0:.1f} s")
    launches_k = main_path_mesh(torch, K, dev, d6, arts_a, arts_b)
    launches_l, _ = main_path_mesh_lm(torch, K, trained["h1"])
    launches_l5, _ = main_path_mesh_families(torch, K)
    launches_l6, _ = main_path_mesh_recurrent(torch, K)
    by_path = {"A": launches_a, "B": launches_b, "C": launches_c,
               "D": launches_d, "E": launches_e, "G": launches_g,
               "H": launches_h, "I": launches_i, "J": launches_j,
               "K": launches_k, "L": launches_l, "L5": launches_l5,
               "L6": launches_l6}
    launches = {n: (sum(p[n] for p in by_path.values()),
                    {k: p[n] for k, p in by_path.items()})
                for n in KernelCheck.NAMES}
    kernels = timing(torch, K, dev, d6, d5, check, arts_a, arts_b, arts_d,
                     tree_model, launches, lm, families, recurrent)
    add_tuned(kernels, tuned)
    with open(tune_file) as f:
        n_keys = len(json.load(f))
    log(f"tuner: {K.tune.sweep_launches} sweep launches in "
        f"{K.tune.sweep_seconds:.2f} s of sweeps over the run (this process);"
        f" {n_keys} keys in {tune_file}, from every process of the run")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(dev.smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev.name, "count": dev.count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
