#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` and drives its paths through them: replicated hypergraph
partitioning (``partition_with_replication``, flat and as a multilevel
V-cycle), serving ``hymba-1.5b`` and serving ``olmoe-1b-7b`` with
replicated expert placement (``launch.serve.serve``), and BSP scheduling
with replication, whose window pricers run as int32 PyTorch programs on
the card (``kernels.front_pass.DeviceScheduleWindows``),
``hubert-xlarge``'s encoder (``Model.forward``, ``logits_fn``),
serving ``deepseek-v3-671b`` (MLA and MoE) at its published widths,
serving ``llama-3.2-vision-11b`` (cross-attention) at full width and
depth, training ``hymba-1.5b`` at full width and depth through the
backward kernels (``train.step``), training ``olmoe-1b-7b`` at full
width, cut in depth, through the grouped matmul's backward, training
``deepseek-v3-671b`` at its published widths, cut to its dense MLA layers
and MTP block, through the attention backward at MLA's head dims (192,
128), training ``hubert-xlarge`` at full width and depth through the
attention kernels at its head dims (80, 80), the distributed paths on two
ranks that share the card, and ``falcon-mamba-7b`` served at full size and
trained with its Mamba mixers on their channel blocks.  Phases, in order; any
failure propagates and the exit code is nonzero:

1. build the kernels, one ``nvcc`` per source, all started together;
   print the build time, what ``ptxas`` reports for the find, attention,
   grouped-matmul and scan kernels (registers, shared memory, spills), the
   tensor-core instructions (``HMMA``/``HGMMA``) in the SASS of every
   instantiation of the general routes' kernels (``cuobjdump -sass``; each
   must have some), the wgmma instructions (``HGMMA``) of the bf16
   prefill and backward routes' kernels (``attention_prefill_tc.cu``,
   ``attention_bwd_tc.cu``, ``moe_gmm_bwd_tc.cu``; each must have some,
   and ptxas must report no spills), the wgmma shapes in the SASS of the
   (80, 80) instantiations, and the card's name, power limit, maximum SM
   clock and SM count;
2. hold each kernel against its plain PyTorch version on the card and
   time both: the min-cover kernel at the shapes the per-front path gives
   it, and the device pass's fused find (``front_find``) at phase 3's
   block shape -- 1, 8 and 64 active blocks, P 4 and 8, FM and
   replication, one queued move to apply, with the pass's feasibility and
   with none (a scan of every block) -- both exactly equal (the triple and
   the buffers after the apply), the find timed beside its bound and an
   empty cooperative launch on its grid (the latency floor); attention
   and the selective scan at hymba's and olmoe's serving shapes and
   hubert's encoder call, and the grouped matmul at olmoe's, in bf16 and
   in f32 (tolerances at ``MODEL_TOL``), with TF32 off for the f32
   products of the plain versions.  The bounds count operations at 989
   TFLOP/s in bf16, at 165 TFLOP/s for the general routes' f32 calls
   (3xTF32: three products at the TF32 rate) and at 67 TFLOP/s for the
   other f32 calls (CUDA cores).  The scan's bound is the larger of its
   bytes and its arithmetic at the card's maximum SM clock (phase 1
   prints it): the recurrence's FMA-pipe instructions and one exp2 per
   (t, d, n), the exps split between the special-function unit and an
   emulation on the FMA pipe so that both pipes finish together
   (``scan_bound``); the decode step is timed beside an empty launch on
   its grid; at hubert's call (bf16 on ``prefill_tc``) the general
   kernel's bf16 instantiation, the route it took before, called directly
   as "before".  Each attention row names its route
   (``flash_attention.route``: ``prefill_tc``, ``decode_split`` or
   ``general``) and asserts that the call took it, as each grouped-matmul
   row does with ``moe_gmm.route`` (``gmm_tc``, ``gmv``, ``general``).
   The grouped matmul also runs fill-aware: slot fills from a seeded
   uniform top-8 routing (4 x 2048 tokens for prefill, 4 for decode), rows
   past each fill exact zeros, the bound counted over the live rows and
   slots, ``torch.bmm`` timed on the full buffers;
3. the device-resident pass on ``large_row_net(8192)``, P = 8:
   ``fm_refine`` then ``replicate_local_search`` on CUDA against the host
   (numpy) path -- equal masks and cost, counter bounds, one find launch
   and one read per find; then one FM pass timed plain and under
   ``torch.profiler`` (where the time goes: one device->host read per
   find, no PyTorch index, gather or scatter kernel);
4. the per-front path on an MoE expert-placement instance (float weights,
   128 experts): ``partition_with_replication`` on CUDA against numpy
   (run beside it in the dry-run pool's process, which sees no card);
5. full size: ``partition_with_replication(large_row_net(16384))``, P = 8,
   on CUDA, with its time, costs, counters (one find launch and one read
   per find), the queue and active blocks per find and peak device memory;
6. serve ``hymba-1.5b`` at full width and depth: 4 prompts of 2048
   tokens, 32 new tokens each, in bf16, the decode a captured step
   (``ServeResult.decode == "graph"``: one eager step, the capture, 30
   replays; ``served_decode``); prefill seconds, decode ms per token,
   the capture's seconds, tokens/s, peak memory, launches per counter
   (each of the four model kernels must launch; a replay counts the
   launches its capture recorded) and per attention route (bf16 serving
   runs ``prefill_tc`` and ``decode_split`` only), and the scan's share
   of the prefill.  Then prefill and three teacher-forced decode steps (seeded
   tokens, the same in every run): of the f32 model through the kernels
   (prefill on ``general``, decode on ``decode_split``) and through the
   plain versions (``ops.force("ref")``), within ``F32_LOGIT_TOL`` of the
   largest logit; of the bf16 model through both; and of the bf16 model's
   weights, cast to f32, through the plain versions, from which each bf16
   path's distance is reported (weight rounding left out).  (b) The
   decode profile (``decode_profile``): 6 greedy steps of the bf16 model
   from one prefill, captured and eager (``GreedyStep(graph=False)``,
   what the CPU and a mesh run), each from copies of the same caches:
   ms a step, device busy ms and share, device activities a step, copies
   host->device (0 captured) and device->host (1) a step; tokens equal,
   logits bit-equal or within ``F32_LOGIT_TOL``;
7. serve ``olmoe-1b-7b`` at full width and depth with
   ``placement="replicated"`` (4 prompts of 2048 tokens, 32 new tokens
   each, bf16): the placement's lambda-costs and min-cover launches,
   prefill seconds, decode ms per token, tokens/s, peak memory, launches
   per counter (exactly as expected: three grouped products per MoE layer
   and call, prefill on ``gmm_tc`` and decode on ``gmv``, never
   ``general``), the decode captured as in phase 6, and its decode
   profile (7b) as 6b's.  Then
   the f32 model: each layer's MoE block on the same input through the
   kernel and the plain version within ``MODEL_TOL`` (the routing is then
   identical, so this isolates the kernel), and prefill plus three
   teacher-forced decode steps within ``F32_LOGIT_TOL`` (the run counts
   the top-k choices on which the two paths' routers differ, and a gap
   past the tolerance fails unless some differ: a router near-tie); the
   bf16 paths' distances from the f32 plain path at the bf16 weights as
   in phase 6.
   Last, the serving benchmark's SMOKE drift replay through the online
   controller on CUDA and on the host path: equal totals, commits and
   migration bytes;
8. the V-cycle: ``partition_with_replication(large_row_net(8192),
   multilevel=True, workers=None)``, P = 8, with ``frontier="torch"`` on
   CUDA and ``frontier="numpy"`` (beside it, as in phase 4): equal base
   and replicated masks and
   costs; per level on the card (levels of at least ``DEVICE_MIN_NODES``
   nodes) commits, finds, reads and find launches, reads = finds =
   launches, each pass released; ``min_cover_lambdas`` launched on the
   coarse levels; the level sizes, both times and peak device memory.
   Then heavy-pin matching on a 2-worker pool forked after CUDA is up:
   byte-identical to serial, the pool not failed;
9. scheduling with replication: on ``sptrsv_dag(6000, band=48)`` and
   ``psdd_dag(500 leaves, depth 16)`` at P = 8, g = 4, L = 20,
   ``hill_climb`` of the list schedule with ``backend="torch"`` on CUDA
   and ``backend="numpy"``, then ``advanced_heuristic``: equal
   assignments, comms and costs, and the replicated cost against the
   baseline; then ``multilevel_schedule(large_sptrsv_dag(16384))`` on
   both backends, equal, with window reads on the card (the engine-scale
   hill climbs price no window long enough for the device).  The window
   programs are then timed on the V-cycle's schedule: the host's time
   per priced window, and under ``torch.profiler`` the kernels one
   launches and their device time;
10. ``hubert-xlarge``'s encoder at full width and depth (48 non-causal
   layers, d_model 1280, bf16, seeded weights) over 8 clips of 1500
   frames (30 s at 50 frames/s) drawn with numpy: one forward's launches
   (48 attention calls, all on ``prefill_tc``, nothing else), the median
   of 3 timed forwards after it, in turns with 3 whose attention takes
   the general route, as it did before ``prefill_tc`` took head dim 80
   (``bf16_prefill_on_general``), peak memory and the attention calls'
   share (phase 2's device time); the f32 model's kernel path
   against its plain path within ``F32_LOGIT_TOL``, and the bf16 paths'
   distances from the f32 plain path at the bf16 weights as in phase 6;
11. serve ``deepseek-v3-671b`` at its published widths (d_model 7168, 128
   heads, MLA head dims 128 + 64 and 128, 256 experts of 2048 top-8 and
   one shared, vocabulary 129,280) with its depth cut to 3 dense + 2 MoE
   MLA layers and MTP 1 (27.3 B parameters, 54.6 GB in bf16), seeded
   weights, phase 6's traffic, the one-shard round-robin placement:
   prefill seconds, decode ms per token, tokens/s, peak memory, launches
   exactly as expected (5 prefill attention calls on ``prefill_tc``, none
   in MLA decode, which is plain PyTorch as in the JAX package; 192
   grouped products, prefill on ``gmm_tc`` and decode on ``gmv``), the
   decode captured (its head bf16 by bf16 into f32, as the JAX package's:
   no f32 copy of the 129,280 x 7,168 head a step) and a decode profile
   (11b) as 6b's.  Then at 1 dense + 1 MoE layer over one prompt (the
   plain attention's f32 scores of four would not fit beside 58.5 GB of
   f32 weights): the bf16 model through both paths (logits kept on the
   host; the two models do not fit together), the f32 model's kernel
   path against its plain path within ``F32_LOGIT_TOL`` (a router
   near-tie counted from both paths' router choices), and the bf16
   paths' distances from the f32 plain path at the bf16 weights;
12. serve ``llama-3.2-vision-11b`` at the registry's full width and depth
   (8 groups of 1 cross-attention + 4 self-attention sub-layers, d_model
   4096, 32/8 heads of 128, d_ff 14336, vocabulary 128,256; 9,775,157,256
   parameters, 19.6 GB in bf16), seeded weights, each group's gate set to
   a seeded value with |tanh(gate)| in [0.4, 0.8] (the init's zero gates
   would hide cross-attention), 4 prompts of 2048 tokens with the
   launcher's 1024 stub image tokens each, 32 new tokens, bf16: prefill
   seconds, decode ms per token, tokens/s, peak memory, launches exactly
   as expected (80 prefill calls on ``prefill_tc``: every sub-layer
   twice, block and cache pass; 1,240 decode calls on ``decode_split``,
   the 248 cross ones unmasked without positions, so counted as
   ``flash_attention``), the decode captured, and a decode profile (12b)
   as 6b's.  Then the f32 model (39.1
   GB, built after the bf16 one is freed) through the kernels and the
   plain versions, prefill and three teacher-forced decode steps of all
   four prompts, within ``F32_LOGIT_TOL``, and the bf16 paths' distances
   from the f32 plain path at the bf16 weights;
13. training ``hymba-1.5b``.  (a) Each backward kernel against autograd
   of its plain version at hymba's training shapes, in bf16 and f32,
   within ``GRAD_TOL`` of each gradient's largest entry: attention (4,
   2048², 25/5, 64), causal and with window 1024, on its backward route
   (``tc``, ``attention_bwd_tc.cu``, in bf16; ``general``,
   ``attention_bwd.cu``, in f32; both from the forward's LSE; asserted,
   two runs bit-equal), timed beside its bound (five products of 2 hd
   FLOPs per live pair and head, the LSE given, at 989 or 165 TFLOP/s,
   or its bytes; the six-product figure beside), the plain backward
   (``attention_bwd_ref``), SDPA's forward + backward (its forward alone
   and its backward alone beside it) and the forward with and without
   the LSE written, in turns; the scan (4,
   2048, 3200, 16) on the plan's segments (``mamba_scan.bwd_plan``),
   two runs bit-equal, beside its bound (``scan_bound`` with 13 FMA-pipe
   instructions and 2 exps per (t, d, n)) and its plain backward, with
   its segment count and each pass's device time (pass 1, pass 2, the
   finish) from a ``torch.profiler`` trace of whole calls.  (b)
   Five training steps at full width and depth, bf16, remat "full", 4 x
   2048 tokens from ``SyntheticTokenStream(seed=0)``, AdamW as
   ``launch/train.py`` sets it (lr 3e-4, one warm-up step, 5 steps), the
   step run directly (not through ``Trainer.run``'s retries) and captured
   as ``train.step`` runs it on one card (``train_steps``): step 1 eager
   on the capture's stream, then recorded in a CUDA graph; steps 2-5
   replays.  Losses (finite), the eager first step's and the capture's
   seconds, the graph pool, seconds per step (median of the replayed
   steps 2-5), tokens/s, peak memory, and each step's launches exactly
   as expected (every forward kernel twice -- forward and recompute --
   one backward kernel each, the fused AdamW once a leaf, all attention
   on ``prefill_tc``, every attention backward call on ``tc``
   (``ops.bwd_route_launches``), nothing else; a replay books its
   capture's); then the graph dropped and one more step, eager, split by
   CUDA events (forward, backward with the recompute, AdamW) and by
   kernel under ``torch.profiler``, the "other" kind's device time by the
   aten op that launched it; and the loss head's three products timed
   bf16 into f32 against the f32 copies they replaced (``head_times``).
   (c) The f32 model at full width, depth cut to one layer of each of
   its five segments
   (``hymba_gate_config``: its three global-attention layers and two
   windowed ones; phase 17's time came out of this gate's plain
   backward), 2 x 2048 tokens: the loss and every gradient through the
   kernels and through the plain versions (losses within 1e-5 relative,
   each leaf within ``GRAD_TOL`` f32 of its largest entry, the worst
   reported; every backward call on ``general``), then one AdamW step
   from each, the parameters compared
   (at most 1e-5 of them more than lr / 10 apart: a first AdamW step
   moves each parameter by about lr times its gradient's sign, which the
   two paths share except where a gradient is near 0; an H100 read 2,998
   of 1.66e9 at full depth);
14. training ``olmoe-1b-7b``.  (a) The grouped matmul's backward on its
   route (``tc``, ``moe_gmm_bwd_tc.cu``, in bf16; ``general``,
   ``moe_gmm_bwd.cu``, in f32; asserted), dx and dw, against the plain
   backward
   (``grouped_matmul_aligned_bwd_ref``) and autograd of the plain forward
   at olmoe's training shapes -- 64 slots of C = 2560, gate/up (2048 ->
   1024) and down (1024 -> 2048), at the fills of 4 x 2048 tokens routed
   top-8 uniformly and with every row live -- in bf16 and f32 within
   ``GRAD_TOL``, dx and dw bit-equal over two runs; dx and dw timed apart
   and together beside their bounds (2 x live rows x D x F FLOPs a product
   at 989 or 165 TFLOP/s, or the bytes), the plain backward,
   ``torch.bmm`` on the full buffers (dY W^T, X^T dY) and, in bf16, the
   PR 23 kernels' bf16 instantiation called directly ("before").  Then
   the attention
   backward at olmoe's (4, 2048², 16/16, 128), causal, as in 13a.  (b)
   olmoe-1b-7b at its published widths, depth cut to
   ``OLMOE_TRAIN_LAYERS`` of 16 layers: five bf16 steps as in 13b, each
   step's launches exactly as expected (per layer 2 ``flash_attention``
   on ``prefill_tc``, 1 ``attention_bwd`` on ``tc``, 6
   ``grouped_matmul`` on ``gmm_tc``, 3 ``grouped_matmul_bwd`` on ``tc``),
   every layer's recompute routed
   as its forward (the routers recorded on the card), then the split
   step; the choices each layer dropped in the first step, and the MoE
   gathers at the routing of its layers that dropped the fewest and the
   most (``check_gathers``):
   ``sort_dispatch`` and ``combine_from_buffers`` whole, their gathers as
   embedding lookups and as indexing, outputs bit-equal, gradients
   within ``GRAD_TOL``, each timed with and without the backward.  (c)
   The f32 model at ``OLMOE_GATE_LAYERS`` layers, 2 x 2048
   tokens: the loss and every gradient through the kernels and through
   the plain versions, the plain run's routers replaying the kernel run's
   choices (``RouterLog``'s replay; a near-tie would otherwise send a
   token's gradient to another expert): losses within 1e-5 relative, each
   leaf within ``GRAD_TOL`` f32, every backward call on ``general``, the
   worst leaf and the choices the plain routers would have flipped
   reported;
15. training ``deepseek-v3-671b``.  (a) The attention backward at its
   training call (4, 2048², 128/128, (hd, hd_v) = (192, 128)), causal,
   as in 13a: ``tc`` in bf16 from ``prefill_tc``'s LSE (within
   ``LSE_TOL`` of ``attention_lse_ref``), ``general`` in f32, against
   ``attention_bwd_ref`` and autograd of ``attention_ref`` (one prompt a
   call: one prompt's f32 scores are 2.1 GB) within ``GRAD_TOL``, two runs
   bit-equal, timed beside its bound (five products: S, dQ and dK of 2 hd
   FLOPs, dP and dV of 2 hd_v), the plain backward and SDPA's pair, with
   the SDPA backend the default dispatch picks named.  (b) The published
   widths, depth cut to ``DS_TRAIN_DENSE`` of its 3 dense MLA layers and
   the MTP block, no MoE layer: five bf16 steps as in 13b, each step's
   launches exactly as expected (per dense layer 2 ``flash_attention``
   on ``prefill_tc`` and 1 ``attention_bwd`` on ``tc``; the MTP block,
   which ``Model._mtp_loss`` does not recompute, 1 and 1), then the split
   step.  (c) The same cut in f32 at ``DS_GATE_B`` x 2048 tokens without
   optimizer state (``deepseek_gate``): the loss and every gradient
   through the kernels and through the plain versions, losses within 1e-5
   relative, each leaf within ``GRAD_TOL`` f32, every backward call on
   ``general``; AdamW's state would not fit beside two gradient sets, so
   no AdamW step is compared;
16. training ``hubert-xlarge`` (frame classification, 48 non-causal
   layers, 16 heads of 80).  (a) The attention backward at its training
   call (8, 1500², 16/16, (80, 80)), non-causal, as in 15a: ``tc`` in
   bf16 from ``prefill_tc``'s LSE, ``general`` in f32, against
   ``attention_bwd_ref`` and autograd of ``attention_ref``, its bound over
   every (query, key) pair.  (b) Full width and depth: five bf16 steps as
   in 13b on 8 clips of 1500 frames and their labels drawn with numpy
   (``FrameStream``: the data pipeline draws tokens only), each step's
   launches exactly as expected (48 layers x 2 ``flash_attention`` on
   ``prefill_tc`` and 1 ``attention_bwd`` on ``tc``), frames a second,
   then the split step.  (c) The f32 model at full depth, 2 clips, as 13c
   (``adamw_gate``): the loss and every gradient through the kernels and
   the plain versions, every backward call on ``general``, then one AdamW
   step from each;
17. the planning tools against the card.  The dry runs
   (``launch.dryrun.run_cell`` on the meta device: 13b-16b's cells as
   trained, and hymba's and hubert's under remat "dots" and "none") run
   in a spawned process on the CPU from the end of the build on, beside
   phases 1-16.
   (a) Each training cell's dry run holds the parameters and the bytes of
   training state (parameters, f32 master, m, v) that the card trained,
   exactly; its predicted peak beside the measured
   ``max_memory_allocated`` and its counted FLOPs beside ``step_cost``'s
   are printed as ratios.  (b) Every training step (13b-16b) and serving
   run (6, 7, 11, 12; hubert's forward in 10) beside ``step_cost``'s
   compute and memory seconds at dp = tp = 1 on the H100's constants
   (``roofline.roofline_terms``): the bottleneck, ``mfu`` (model FLOPs
   over 989 TFLOP/s times the measured seconds) and the roofline
   fraction.  (c) hymba-1.5b and hubert-xlarge train five bf16 steps
   under remat "dots" on 13b's and 16b's batches: each step's launches
   and backward routes those of "full", losses finite, step 1's loss
   equal to "full"'s, one step's gradients within ``GRAD_TOL`` of
   "full"'s on the same weights (bit-equality reported); seconds a step,
   tokens (frames) a second and peak beside "full"'s, ``plan_remat``'s
   decision for the card's 80 GB less the state, and the dry run's peak
   under each policy; remat "none" trains only where the dry run
   predicts a peak under 72 GB (hubert), else the prediction is printed.
   Every policy's steps are captured, so "dots" decides what to save once,
   at the capture, and a replay is the device's own time: no eager split
   follows;
18. distribution (``mesh_phase``), each world in processes of its own
   (``launch.mesh.run_ranks``), the transport an explicit argument that
   the phase prints.  (a) One rank of a (1, 1) mesh over NCCL: olmoe-1b-7b
   served as in phase 7 (4 x 2048 prompts, 32 new tokens) without a mesh
   and through the mesh path, the tokens and the prefill's f32 logits
   bit-equal; the f32 model at ``MESH_GATE_LAYERS`` layers, logits of the
   prefill and ``MESH_FORCED`` teacher-forced decode steps bit-equal (and
   two runs without a mesh bit-equal); three bf16 training steps at those
   layers, losses bit-equal; every collective over a group of one
   (counted).  (b) Two ranks of a (1, 2)
   mesh sharing the card over gloo (NCCL puts no two ranks on one card):
   olmoe-1b-7b at full width and depth in bf16, the replicated placement
   planned for two shards from the router trace (each rank plans; the
   plans must agree) and adopted at ``MESH_SERVE_CF``, prefill on
   ``moe_a2a`` and decode on ``moe_tp``, every rank's attention and
   grouped products on the kernels' routes (counted as expected); per
   rank its weights' bytes, its peak, the all_to_all bytes of a prefill
   layer, prefill seconds and decode ms a token (gloo's path through the
   host, not NVLink), the share of tokens equal to the one card's run at
   the same capacity factor and the largest prefill logit gap as a share
   of the largest logit; then the f32 model at ``MESH_GATE_LAYERS`` layers
   under the replicated plan and under the round robin, prefill and
   decode logits within ``F32_LOGIT_TOL`` of the one card's, each plan's
   all_to_all bytes a layer (``models.moe.a2a_bytes``, checked against
   ``CollectiveCounter``) and local fraction: the paper's communication
   saving on the running system.  (c) Elastic training of the f32 model
   at ``ELASTIC_LAYERS`` layer (``Trainer``, ``ELASTIC_B`` x
   ``ELASTIC_S`` tokens, the round robin at ``MESH_TRAIN_CF``, under which
   no choice is dropped): two ranks of (1, 2) train 4 steps and
   checkpoint; two ranks of (2, 1) and one of (1, 1) each restore it and
   train to step 6; both resume at step 4 and every loss is within
   ``ELASTIC_TOL`` (relative) of an uninterrupted run on one card.  olmoe's
   attention, embedding and head run tensor-parallel there (phase 19).
   (a) runs beside (c)'s writer and uninterrupted run: its results are
   bit-equalities, which sharing the card and the host cannot change;
19. tensor-parallel products (``tp_phase``): deepseek-7b, the dense kind,
   at full width cut to ``DS7_LAYERS`` of its 30 layers (at 16 B a
   parameter its state does not fit one card at full depth).  (a) One
   card, no mesh: ``TRAIN_STEPS`` bf16 steps of ``DS7_B`` x ``DS7_S``
   tokens under remat "full" (``train_steps``: seconds a step, tokens a
   second, peak memory, each attention route's launches; then one step
   split).  (b) Two ranks of a (1, 2) mesh sharing the card over gloo
   train the first ``MESH_STEPS`` of those steps from the same weights
   and batches, every family
   on route ``tp`` (``parallel.sharding.tp_split``): per rank the
   parameter bytes it holds (equal to the dry run's at (1, 2), phase 17's
   process, and about half of (a)'s), its peak, its routes, step 1's
   collectives (``CollectiveCounter``: no all-gather; the all-reduces,
   the stream's psums among them, beside ``step_cost``'s collective term
   at tp = 2), seconds a step (gloo's path through the host, not NVLink)
   and its attention launches at 16 local heads on ``prefill_tc`` and
   ``tc``; the losses within ``TP_LOSS_TOL`` (relative) of (a)'s.  (c) In
   the same ranks, the f32 model at ``MESH_GATE_LAYERS`` layers, one step
   of ``DS7_GATE_B`` x ``DS7_S`` tokens: rank 0 takes one card's
   gradients first, and each gathered gradient of the (1, 2) step is
   within ``GRAD_TOL`` f32 of its leaf's largest entry, the loss within
   ``ELASTIC_TOL``, and the replicated leaves' gradients bit-equal on
   both ranks.
20. the sequence split (``seq_phase``): smollm-135m, the registry's
   ``dp_seq`` config, at its published widths and depth (30 layers, d
   576, 9/3 heads of 64, vocabulary 49152, tied).  (k) The four attention
   kernels at rank 1's call of (b), ``SEQ_KERNEL_CASE``: 8 x 2048 queries
   at positions 2048-4095 (``q_off`` 2048) against 4096 keys, causal --
   ``prefill_tc`` with its LSE and the ``tc`` backward in bf16,
   ``general``'s forward and backward in f32 -- each against its plain
   version (``MODEL_TOL``, ``GRAD_TOL``), timed beside the bound of the
   live pairs with the offset (``flash_attention.live_pairs``), the plain
   version and SDPA with the explicit boolean mask (forward, and forward
   and backward); at ``q_off`` 0 (rank 0's call) the launch bit-equal to
   the call without the argument, and timed.  (a) One card, no mesh:
   ``TRAIN_STEPS`` bf16 steps of ``SEQ_B`` x ``SEQ_S`` tokens under remat
   "full" (``train_steps``).  (b) Two ranks of a (1, 2) mesh sharing the
   card over gloo train the first ``MESH_STEPS`` of those steps from the
   same weights and
   batches, each on its block of 8 x 2048 tokens (its labels with the
   next block's first one): every GQA layer on sequence route ``seq``
   (``parallel.sharding.seq_split``), rank 1's attention at ``q_off``
   2048; per rank its losses (within ``TP_LOSS_TOL`` of (a)'s), the
   parameters' digest after every step (equal on both ranks), its peak,
   seconds a step, step 1's collectives (the K/V gathers, which gloo on
   CUDA runs as all-to-alls, with the remat replays; their
   reduce-scatters; the gradients' all-reduces over 'model') beside the
   dry run at (1, 2) (phase 17's process, ``seq_dryrun_cell``), and one
   more step's attention device time under ``torch.profiler``: the
   contiguous split's imbalance.  (c) In the same ranks, the f32 model at
   ``MESH_GATE_LAYERS`` layers, one step of ``SEQ_GATE_B`` x ``SEQ_S``
   tokens against rank 0's one-card step: each gradient within
   ``GRAD_TOL`` f32 of its leaf's largest entry, the loss within
   ``ELASTIC_TOL``, the whole leaves' gradients bit-equal on both ranks.
   (d) The same for deepseek-7b at ``MESH_GATE_LAYERS`` layers, ``SP_GATE_B``
   x ``SP_GATE_S`` tokens, with ``seq_shard_activations`` on: every family
   on sequence route ``gathered``, step 1's all-gathers and
   reduce-scatters in place of the stream's psums, beside the same step
   without the flag (19c's).
21. the Mamba mixer on its channel blocks (``falcon_phase``):
   falcon-mamba-7b, the registry's ``ssm`` config (arXiv:2410.05355; 64
   Mamba layers, d 4096, d_inner 8192, state 16, vocabulary 65024).  (k)
   The scan kernels at its widths, each against its plain version
   (``MODEL_TOL``, ``GRAD_TOL``) in bf16 and f32, timed beside its bound
   (``scan_bound``, with ``scan_cost``'s bytes and FLOPs) and the plain
   version: the forward at (4, 2048, 8192, 16), the step at (4, 1, 8192,
   16), the backward at a step's (2, 2048, 8192, 16) and a rank's (2,
   2048, 4096, 16), both cut by ``bwd_plan`` into segments whose last is
   shorter than the rest (7 of 296 steps, the last 272; 13 of 160, the
   last 128).  (s) Served at full width and depth through
   ``launch.serve.serve`` (phase 6's prompts: 4 x 2048, 32 new tokens;
   128 ``mamba_scan`` and 1,984 ``mamba_step`` launches), the decode
   captured, prefill s, decode ms a token, peak, and a decode profile
   (21sb) as 6b's of a model drawn again; the bf16 kernel path against
   the bf16 plain path over the prefill and three teacher-forced decode
   steps, a share
   of the largest logit; the f32 model at ``FM_SERVE_GATE_LAYERS``
   layers, kernels against plain within ``F32_LOGIT_TOL``.  (a) One card:
   ``FM_TRAIN_LAYERS`` of its layers, ``TRAIN_STEPS`` bf16 steps of
   ``FM_B`` x ``FM_S`` tokens under remat "full" (``train_steps``: 32
   ``mamba_scan`` and 16 ``mamba_scan_bwd`` launches a step), its state
   equal to the dry run's (phase 17's process, ``falcon_dryrun_cells``),
   its peak and FLOPs beside the dry run's, ``mfu`` (``roofline_row``).
   (b) Two ranks of a (1, 2) mesh sharing the card over gloo train the
   first ``MESH_STEPS`` of those steps: every mixer on route ``tp``
   (``parallel.sharding.tp_split``, 96 a rank), each rank holding half
   of every mixer leaf but ``conv_b``, ``dt_bias`` and the norms
   (``held_specs``: ``in_proj`` as its ``[x | z]`` channel blocks,
   ``conv_w`` on its channels); its
   parameter bytes and step 1's collectives (no gather; the mixer's two
   psums a pass, the ``x_proj`` one replayed) equal to the dry run's at
   (1, 2) by kind, count and bytes; losses within ``FM_LOSS_TOL`` of
   (a)'s; the replicated leaves' digest equal on both ranks after every
   step; peak, seconds a step, and one more step's scan device time
   under ``torch.profiler`` against (a)'s.  (c) In the same ranks, the
   f32 model at ``MESH_GATE_LAYERS`` layers, one step of ``FM_GATE_B`` x
   ``FM_S`` tokens against rank 0's one-card step: each gradient,
   gathered whole through ``Sharding.full``, within ``FM_GRAD_TOL`` of
   its leaf's largest entry, the loss within ``FM_GATE_LOSS_TOL``;
22. training as one captured step (``graph_phase``); every training run
   on one card above (13b-16b, 17c, 19a, 20a, 21a) is captured and must
   report the form "graph".  (a) The fused AdamW kernel
   (``csrc/adamw.cu``) over hymba-1.5b's leaves, from random gradients,
   moments and masters: one step through the kernel and one through its
   plain version from copies of one state, m, v and the master within
   ``ADAMW_TOL`` of each leaf's largest entry (bit-equality reported),
   then timed: device ms (every leaf's launch in one CUDA graph), call
   ms, plain ms, its bound (bytes over 3.35 TB/s) and the library's time
   (``torch._fused_adamw_`` on the masters with f32 gradients, then the
   parameters copied from them: the same update).  (b) hymba-1.5b at
   ``GRAPH_HYMBA_LAYERS`` and olmoe-1b-7b at ``GRAPH_OLMOE_LAYERS``
   layers, ``GRAPH_STEPS`` bf16 steps of 4 x 2048 tokens eagerly and
   captured from the same weights: losses and every parameter, master, m
   and v bit-equal.  (c)
   deepseek-7b at ``DS7_LAYERS`` layers, one loss and backward on 2 x
   2048 tokens with the head bf16 by bf16 into f32 and one through f32
   copies of x and the head (``F32Head``, the path before): the loss
   within ``HEAD_LOSS_TOL`` relative, every gradient leaf within
   ``GRAD_TOL`` bf16 of its largest entry;
23. the fused elementwise kernels (``fused_phase``, ``csrc/fused.cu``:
   rmsnorm, rope, the Mamba conv with its bias and SiLU, the SiLU gate,
   each a forward and a backward; no TPU counterpart, the reference's jnp
   that XLA fuses): every case of ``FUSED_CASES`` (hymba's, hubert's,
   smollm's, deepseek-v3's, falcon's and olmoe's path shapes and the
   decode step's; the conv and the mixer's gate on column slices of
   ``in_proj``'s output) in
   bf16 and f32, the forward against its plain version within
   ``MODEL_TOL`` (bit-equality reported), the backward against the
   written-out plain backward within ``GRAD_TOL``; each timed: device ms
   (a graph replay), call ms, the plain forward's and backward's ms, a
   forward and backward through the op's Function and through the eager
   chain's autograd, the bound (bytes over 3.35 TB/s) and the library's
   call where one computes the same (``F.rms_norm``, forward and
   backward; ``F.conv1d`` with groups = di, ``F.silu``'s ms beside, and
   the two forward and backward as a yardstick); rmsnorm's and the conv's
   backward also split by launch under ``torch.profiler``
   (``kernel_split_ms``), their first designs' times beside them as
   "before" (``FUSED_BWD_BEFORE``, from PERF.md), and their forward and
   backward through autograd captured in a CUDA graph beside the
   library's, device ms; the conv's forward bit-equal to its plain
   version (asserted), its first design's time beside it
   (``FUSED_FWD_BEFORE``) and its time over its bound.  Then 13b's and
   16b's steps split by layer op (``fused_split``): each op's calls a step
   times its plain chain's and its kernels' ms at the step's shapes,
   beside the kernels' device ms in the step's eager split and its
   remaining "other".  Every eager split of a training run
   (13b-16b, 19a-21a) must show no kernel under ``aten::rsqrt``,
   ``aten::silu`` or ``aten::sin``, and one under ``aten::cos`` (the
   learning rate's), and the training runs' launches a step include the
   fused kernels' as ``expected_train_launches`` counts them.

Launch counts are reset just before each driven run (phases 3-8, 10-16)
and read just after; the kernel line reports those of phases 4 and 5 (the
flat ``partition_with_replication`` runs) for the gain kernels, with phase
8's beside them (``vcycle_launches``), and those of the serve runs of
phases 6, 7, 11 and 12, summed, for the model kernels, and beside them
each rank's of phase 18b (``mesh_launches_per_rank``), of phase 19b
(``tp_launches_per_rank``, on the entries of its routes) and of phase 20b
(``seq_launches_per_rank``, with phase 20k's rows at rank 1's call as
``seq_*``: ``prefill_tc``, ``general`` f32 and ``attention_bwd``); the
scan entries (``mamba_scan``, ``mamba_step``, ``mamba_scan_bwd``) carry
phase 21's launches (``falcon_launches``, 21s; ``falcon_train_launches``,
21a; ``falcon_tp_launches_per_rank``, 21b) and 21k's rows at falcon's
widths (``falcon_*``, ``falcon_f32_*``, the backward's ``falcon_rank_*``
at a rank's channels).  The
attention kernels count ``flash_attention`` (no window, no positions: the
Pallas kernel's role) apart from ``attention_masked``, and the line has
one entry per (count, route) the serve runs took, one for hubert's bf16
forward on ``prefill_tc`` at (80, 80) with phase 10's launches and phase
16b's training launches (the general kernel's bf16 at its call beside it
as "before", and phase 10's forward seconds on either route), plus one
for the ``general`` route with the launches of the f32 kernel paths of
phases 6, 7, 10, 11 and 12 (no bf16 call of a path takes it), timed at
hubert's f32 call with hymba's, olmoe's, MLA's, deepseek's and
llama-vision's f32 prefill beside it (the ``prefill_tc`` entry has
hymba's, olmoe's, deepseek's,
MLA's 16-head and llama-vision's cross bf16 shapes beside its
commonest); the grouped matmul likewise has one entry
per route of the serve runs (``gmm_tc``, ``gmv``) timed at its
fill-aware case, deepseek's beside it, and one for ``general`` with the
launches of the f32 checks of phases 7 and 11; the scan ``mamba_scan`` (from zeros) apart from ``mamba_step``
(decode, from a state), each with its bound's terms
(``bound_terms_ms``, the exps' share on the special-function unit
``exp_sfu_share``) and the step with an empty launch's time
(``empty_ms``); each count is timed at its commonest shape on the path.
``min_cover_lambdas`` (the per-front path) is timed at its
commonest shape; ``front_find`` (the device pass's finds, which also take
the min-cover kernel's apply role: ``also_replaces``) at phase 2's P = 8
FM case nearest the path's median count of active blocks, with
``path_ms``, its device time per launch in phase 3b's profile.  The
attention and scan backward kernels (``attention_bwd``,
``mamba_scan_bwd``) carry the launches of phases 13b, 14b, 15b and 16b
and phase 13a's times (bf16, the windowed attention call first, the
others, olmoe's head dim 128 from phase 14a, deepseek's (192, 128) from
phase 15a and hubert's (80, 80) from phase 16a beside it);
``grouped_matmul_bwd``
carries phase 14b's launches and phase 14a's times (bf16 gate/up at the
fills, dx and dw apart beside the call; the down product, f32 and every
row live beside it).  The attention and grouped-matmul backward entries
name the bf16 route's wgmma source (``tc``) and time it, with the PR
22/23 kernel's bf16 times ("before") and the f32 ``general`` rows (the
same source, ``general_source``) beside; the forward kernels also carry
their training
launches (``train_launches``).  The fused AdamW (``adamw``, no TPU
counterpart: the reference's update is jnp that XLA fuses) carries the
launches of every training run on one card (one a leaf a step) and
phase 22a's times over hymba-1.5b's leaves (``ms`` a whole step's
launches, ``library_ms`` ``torch._fused_adamw_``'s); the fused
elementwise kernels (``rmsnorm``, ``rope``, ``causal_conv``,
``silu_gate`` and their ``*_bwd``) likewise carry the training runs'
launches and phase 23's rows at each op's commonest path shape.  A
``summary`` line near the end holds every number the run reports, so the
last 2 KB of the output carry them.  The last line is the JSON verdict.
Without a CUDA device, or outside a checkout of the repository, the script
exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import json
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
INT32_OPS_PER_S = 67e12        # 32-bit non-tensor rate (data sheet, fp32)
OPS_PER_ELEM = 3               # compare, select, min per loaded element

BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core rate (data sheet)
F32_FLOPS_PER_S = 67e12        # fp32 rate outside the tensor cores
# an f32-accurate product on the tensor cores: three TF32 products (3xTF32)
# at the dense TF32 rate (data sheet, 495 TFLOP/s); the bound of the
# general routes' f32 calls, which run that way
F32_TC_FLOPS_PER_S = 495e12 / 3
# issue rates per clock per SM (CUDA C Programming Guide, arithmetic
# instruction throughput, compute capability 9.0): f32 add/multiply/FMA on
# the FMA pipe, and exp2 (MUFU.EX2) on the special-function unit
FMA_PER_CLK_PER_SM = 128
EXP_PER_CLK_PER_SM = 16
SCAN_FMA_PER_ELEM = 4          # per (t, d, n): dt * A, (dt * u) * B, the
                               # state's FMA and y's FMA
EXP_EMULATED_FMA = 10          # FMA-pipe instructions of one exp2 off the
                               # special-function unit: 3 to split y into
                               # j + f (add and subtract 1.5 * 2^23, f =
                               # y - j), 6 Horner FMAs of a degree-6
                               # polynomial for 2^f on [-1/2, 1/2] (f32
                               # accuracy), 1 IMAD adding j << 23 into its
                               # exponent

# file:line of the Pallas kernel each CUDA kernel replaces; the fused find
# also takes the min-cover kernel's apply role (FIND_ALSO_REPLACES)
REPLACES = {
    "front_find": "src/repro/kernels/gain.py:78",
    "min_cover_lambdas": "src/repro/kernels/gain.py:53",
    "flash_attention": "src/repro/kernels/flash_attention.py:25",
    "attention_masked": "src/repro/kernels/flash_attention.py:25",
    "mamba_scan": "src/repro/kernels/mamba_scan.py:24",
    "mamba_step": "src/repro/kernels/mamba_scan.py:24",
    "grouped_matmul": "src/repro/kernels/moe_gmm.py:23",
}
# launch counter -> the kernel it counts
FIND_ALSO_REPLACES = "src/repro/kernels/gain.py:53"
KERNEL_OF = {"front_find": "front_find",
             "min_cover_lambdas": "min_cover_lambdas",
             "flash_attention": "flash_attention",
             "attention_masked": "flash_attention",
             "mamba_scan": "mamba_scan",
             "mamba_step": "mamba_scan",
             "grouped_matmul": "grouped_matmul"}
# kernel -> its source, the name of its library in _build
SOURCES = {"front_find": "front_find", "min_cover_lambdas": "gain",
           "flash_attention": "flash_attention", "mamba_scan": "mamba_scan",
           "grouped_matmul": "moe_gmm"}
# grouped-matmul route -> its source; the routes of the bf16 serve runs
GMM_SOURCES = {"gmm_tc": "moe_gmm_tc", "gmv": "moe_gmm",
               "general": "moe_gmm"}
GMM_PATH = ("gmm_tc", "gmv")
# attention route -> its source
ATTN_SOURCES = {"prefill_tc": "attention_prefill_tc",
                "decode_split": "attention_decode",
                "general": "flash_attention"}
# the (count, route) pairs of the bf16 serving runs, each a kernel-line entry
ATTN_PATH = (("flash_attention", "prefill_tc"),
             ("attention_masked", "prefill_tc"),
             ("attention_masked", "decode_split"),
             ("flash_attention", "decode_split"))
MODEL_COUNTERS = ("flash_attention", "attention_masked", "mamba_scan",
                  "mamba_step", "grouped_matmul")
# kernel vs plain version: tests/test_kernels.py's bounds, f32 relaxed from
# 2e-6 to 1e-5 for the summation order on the card
MODEL_TOL = {("attn", "float32"): 1e-5, ("attn", "bfloat16"): 2e-2,
             ("scan", "float32"): 1e-5, ("scan", "bfloat16"): 3e-2,
             ("gmm", "float32"): 1e-5, ("gmm", "bfloat16"): 3e-2,
             ("fused", "float32"): 1e-5, ("fused", "bfloat16"): 2e-2}
# phase 6: the f32 kernel path against the f32 plain path, as a share of
# the largest |logit|
F32_LOGIT_TOL = 1e-3


T0 = time.perf_counter()


def log(*a) -> None:
    print(f"{time.perf_counter() - T0:8.2f}s", *a, flush=True)


def sig(x: float) -> float:
    """``x`` to six significant digits: the summary line's times."""
    return float(f"{x:.6g}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz = out.stdout.strip().splitlines()[0].split()[0]
    return float(mhz) * 1e6


def time_ms(fn, iters: int = 20) -> float:
    """Mean time per eager call of ``fn`` over ``iters`` calls, CUDA
    events around the run: the host's enqueue cost included, as the
    partitioning path pays it."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Device time per call of ``fn``: ``launches`` calls captured in one
    CUDA graph and replayed back to back, so no host gap sits between
    them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def bound_ms(kernel: str, R: int, M: int) -> tuple[float, str]:
    """Least time for the work: each input read once, each output written
    once, over the memory rate; the masked-min operations over the
    32-bit rate.  The larger wins."""
    nbytes = 4 * (R * M + M + R)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEM * R * M / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def popcount_pc(P: int) -> np.ndarray:
    from repro_torch.core.partition.engine import _tables
    from repro_torch.kernels.gain import _NO_COVER
    _, _, order_pc, _ = _tables(P)
    return np.concatenate(([_NO_COVER], order_pc)).astype(np.int32)


def kernel_inputs(R: int, P: int, seed: int):
    """Uncov-like int32 rows on the card: mostly positive, some zeros,
    every seventh row with no zero at all (its lambda is the sentinel)."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    M = 1 << P
    rows = torch.randint(1, 4, (R, M), generator=g, device=dev,
                         dtype=torch.int32)
    rows *= (torch.rand((R, M), generator=g, device=dev) > 0.05)
    rows[::7] = 1
    pc = torch.from_numpy(popcount_pc(P)).to(dev)
    return rows, pc


def check_kernel(kernel: str, R: int, P: int, seed: int) -> dict:
    """Kernel against plain version at (R, 2^P): exact, then timed."""
    import torch
    from repro_torch.kernels import gain, ref
    rows, pc = kernel_inputs(R, P, seed)

    def run():
        return gain.min_cover(rows, pc)

    def plain():
        return ref.min_cover_ref(rows, pc)
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max().item())
    if not torch.equal(got, want):
        raise AssertionError(f"{kernel} at R={R}, P={P}: kernel != plain "
                             f"(max abs err {err})")
    if kernel == "min_cover_lambdas" and not bool(
            (got[::7] == gain._NO_COVER).all()):
        raise AssertionError("all-nonzero rows must give the sentinel 127")
    ms, plain_ms = graph_ms(run), graph_ms(plain)
    b, by = bound_ms(kernel, R, 1 << P)
    return {"kernel": kernel, "R": R, "M": 1 << P, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "call_ms": time_ms(run), "plain_call_ms": time_ms(plain)}


def find_pass(hg, P: int, rep: bool, masks: np.ndarray, cap: float,
              seed: int):
    """A device pass on the card over ``hg`` from ``masks`` (for replication
    with a second replica on every tenth node), its blocks cut for a
    seeded visit order."""
    from repro_torch.core.partition import PartitionState
    from repro_torch.kernels import front_pass
    rng = np.random.default_rng(seed)
    masks = masks.copy()
    if rep:
        extra = rng.random(hg.n) < 0.1
        masks[extra] |= 1 << rng.integers(0, P, size=int(extra.sum()))
    st = PartitionState(hg, P, masks=masks)
    dev = front_pass.attach(st, cap, device="cuda")
    if dev is None:
        raise AssertionError("the device pass did not attach")
    dev._build_blocks(rng.permutation(hg.n))
    return dev


def find_bound(dev, blocks, pos: int, queue) -> tuple[float, str, dict]:
    """Least time for one find from position 0: the bytes of every (node,
    edge) uncov row the scan must price -- the positions of ``blocks`` up
    to the event ``pos`` (all of them when there is none) -- with each
    row's mu and lambda and the nodes' index, mask and feasibility entries,
    plus the applied rows (read and written) and the work list, over the
    memory rate; the masked-min operations (``OPS_PER_ELEM`` per column and
    candidate) over the 32-bit rate.  The larger wins."""
    P, M = dev.P, dev.nsub
    poss = np.concatenate([np.arange(dev._bounds[b], dev._bounds[b + 1])
                           for b in blocks]) if len(blocks) else np.zeros(0)
    poss = poss[poss <= pos].astype(np.int64)
    rows = int(dev.deg[dev._perm[poss]].sum())
    nodes = len(poss)
    applied = sum(int(dev.deg[v]) for v, old, new in queue if old != new)
    nbytes = (rows * (4 * M + 12) + nodes * (16 + P)
              + applied * (8 * M + 8) + 4 * (3 * len(queue) + 2 * len(blocks)
                                              + 1) + 12)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEM * rows * M * P / INT32_OPS_PER_S * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound + ({"rows": rows, "nodes": nodes, "bytes": nbytes},)


def check_find(dev, rep: bool, k: int, full_scan: bool, seed: int) -> dict:
    """The fused find against its plain version on the pass's buffers: the
    first ``k`` blocks active, one queued move (node v to another
    processor, or a replica added), with the pass's feasibility or, for
    ``full_scan``, none (no move fits, so FM scans every block).  Exact
    equality of the triple and of uncov, lambdas and masks after the apply;
    then both timed on alternating queues (the move, then its reversal), the
    kernel as pure launches of pre-uploaded work lists in a CUDA graph, and
    one eager call through the wrapper."""
    import torch
    from repro_torch.kernels import front_find as ff
    rng = np.random.default_rng(seed)
    P, n = dev.P, dev.n
    blocks = np.arange(min(k, dev._nb))
    x = dev._inputs()
    if full_scan:
        x.fits = torch.zeros_like(x.fits)
    v = int(dev._perm[int(rng.integers(0, n))])
    old = int(dev.state.masks[v])
    unset = [q for q in range(P) if not (old >> q) & 1]
    if rep:        # a replica added (or, on a full mask, one dropped)
        new = old | (1 << unset[0]) if unset else old & (old - 1)
    else:          # moved to the next processor
        new = 1 << (old.bit_length() % P)
    fwd, back = [(v, old, new)], [(v, new, old)]
    kw = dict(rep=rep, start_pos=0, resume_p=-1, maxrep=P + 1)

    def clone(t):
        return ff.FindInputs(**{**t.__dict__, "uncov": t.uncov.clone(),
                                "lam": t.lam.clone(), "masks": t.masks.clone()})
    xk, xr = clone(x), clone(x)
    got = ff.front_find(xk, fwd, blocks, **kw)
    want = ff.front_find_ref(xr, fwd, blocks, **kw)
    torch.cuda.synchronize()
    same = got.tolist() == want.tolist() and all(
        torch.equal(getattr(xk, f), getattr(xr, f))
        for f in ("uncov", "lam", "masks"))
    err = max(int((getattr(xk, f).long() - getattr(xr, f).long()).abs().max())
              for f in ("uncov", "lam", "masks"))
    err = max(err, max(abs(a - b) for a, b in zip(got.tolist(),
                                                  want.tolist())))
    if not same:
        raise AssertionError(f"front_find P={P} rep={rep} k={k}: kernel "
                             f"{got.tolist()} != plain {want.tolist()} "
                             f"(max abs err {err})")
    pos = got.tolist()[0]
    # timing: the buffers go back and forth between the two states
    work = [ff.upload_work(ff.pack_work(q, blocks, x.bounds_host),
                           x.uncov.device).clone() for q in (fwd, back)]

    def pair():
        for w in work:
            ff.launch(xk, w, 1, len(blocks), **kw)

    def call_pair():
        for q in (fwd, back):
            ff.front_find(xk, q, blocks, **kw)

    def plain_pair():
        for q in (fwd, back):
            ff.front_find_ref(xr, q, blocks, **kw)
    ms = graph_ms(pair, launches=10) / 2
    grid = ff.find_grid(P, rep, xk.uncov.device)
    empty_ms = graph_ms(lambda: ff.empty_launch(grid, ff.THREADS,
                                                xk.uncov.device, True),
                        launches=10)
    b, by, work_of = find_bound(dev, blocks, pos, fwd)
    return {"kernel": "front_find", "P": P, "rep": rep, "blocks": len(blocks),
            "full_scan": full_scan, "triple": got.tolist(), **work_of,
            "max_abs_err": err, "ms": ms, "empty_ms": empty_ms,
            "plain_ms": time_ms(plain_pair, iters=5) / 2, "bound_ms": b,
            "bound_by": by, "call_ms": time_ms(call_pair) / 2}


def f32_rate(route: str) -> float:
    """The peak an f32 call of ``route`` is bounded by: the general routes
    multiply on the tensor cores in 3xTF32, the others on the CUDA cores."""
    return F32_TC_FLOPS_PER_S if route == "general" else F32_FLOPS_PER_S


def rel_ok(got, want, tol: float) -> tuple[bool, float]:
    """``|got - want| <= tol + tol * |want|`` everywhere (the rule of
    ``assert_allclose`` with rtol = atol = tol), and the max abs error."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return ok, float(diff.max())


# (name, counter, B, Sq, Sk, H, KV, hd, hd_v, causal, window, positions,
# timed beside the plain version and SDPA): hymba's prefill (global and
# window 1024) and decode (linear cache of 2080 at position 2060, full
# ring of 1024), a ring whose left slots are still padding, a non-causal
# shape, MLA's 192/128 dims at 16 heads (``prefill_tc`` in bf16,
# ``general`` in f32), olmoe's prefill and decode, hubert's encoder call,
# deepseek-v3's MLA prefill (phase 11) and llama-3.2-vision's four calls
# (phase 12).  Every path shape is timed
ATTN_CASES = [
    ("prefill", "flash_attention", 4, 2048, 2048, 25, 5, 64, 64, True, 0,
     None, True),
    ("prefill_window", "attention_masked", 4, 2048, 2048, 25, 5, 64, 64,
     True, 1024, None, True),
    ("decode_global", "attention_masked", 4, 1, 2080, 25, 5, 64, 64, True,
     0, "linear", True),
    ("decode_window", "attention_masked", 4, 1, 1024, 25, 5, 64, 64, True,
     0, "ring", True),
    ("decode_ring_pads", "attention_masked", 4, 1, 1024, 25, 5, 64, 64,
     True, 0, "ring_pads", False),
    ("noncausal", "flash_attention", 2, 1024, 1024, 25, 5, 64, 64, False, 0,
     None, False),
    ("hd192_v128", "flash_attention", 1, 1024, 1024, 16, 16, 192, 128, True,
     0, None, True),
    # olmoe: prefill, and decode on a linear cache of 2048 + 32
    ("olmoe_prefill", "flash_attention", 4, 2048, 2048, 16, 16, 128, 128,
     True, 0, None, True),
    ("olmoe_decode", "attention_masked", 4, 1, 2080, 16, 16, 128, 128, True,
     0, "linear", True),
    # hubert-xlarge's encoder (phase 10): 8 clips of 1500 frames, 16 heads
    # of 80, non-causal
    ("hubert", "flash_attention", 8, 1500, 1500, 16, 16, 80, 80, False, 0,
     None, True),
    # deepseek-v3 (phase 11): 4 prompts of 2048, 128 heads, q/k head dim
    # 128 + 64, v head dim 128, causal
    ("deepseek_prefill", "flash_attention", 4, 2048, 2048, 128, 128, 192,
     128, True, 0, None, True),
    # llama-3.2-vision-11b (phase 12): 4 prompts of 2048 and 1024 image
    # tokens, 32 q heads over 8 kv heads of 128: the self prefill
    # (causal), the cross prefill (non-causal), the self decode (linear
    # cache of 2048 + 32) and the cross decode (non-causal, no positions)
    ("vision_prefill", "flash_attention", 4, 2048, 2048, 32, 8, 128, 128,
     True, 0, None, True),
    ("vision_cross_prefill", "flash_attention", 4, 2048, 1024, 32, 8, 128,
     128, False, 0, None, True),
    ("vision_decode", "attention_masked", 4, 1, 2080, 32, 8, 128, 128, True,
     0, "linear", True),
    ("vision_cross_decode", "flash_attention", 4, 1, 1024, 32, 8, 128, 128,
     False, 0, None, True),
]
# (name, counter, B, S, di, N, with a state, on the path)
SCAN_CASES = [
    ("prefill", "mamba_scan", 4, 2048, 3200, 16, False, True),
    ("decode", "mamba_step", 4, 1, 3200, 16, True, True),
]
# (name, G, C, D, F, on the path, routed tokens): olmoe's expert
# products, 64 slots -- gate/up (D 2048 -> F 1024) and down (1024 ->
# 2048) -- at decode (C = 1) and prefill (C = 2560), one odd shape, and
# deepseek-v3's (phase 11), 256 slots -- gate/up (7168 -> 2048) and down
# (2048 -> 7168) -- at decode (C = 1) and prefill (C = 640); the ``_fill``
# cases hand the kernel the slot fills of that many tokens routed top-8
# uniformly at random (None: every row live)
GMM_CASES = [
    ("decode_gate_up", 64, 1, 2048, 1024, True, None),
    ("decode_down", 64, 1, 1024, 2048, True, None),
    ("prefill_gate_up", 64, 2560, 2048, 1024, True, None),
    ("prefill_down", 64, 2560, 1024, 2048, True, None),
    ("odd", 8, 37, 96, 80, False, None),
    ("prefill_gate_up_fill", 64, 2560, 2048, 1024, True, 4 * 2048),
    ("prefill_down_fill", 64, 2560, 1024, 2048, True, 4 * 2048),
    ("decode_fill", 64, 1, 2048, 1024, True, 4),
    ("ds_decode_gate_up", 256, 1, 7168, 2048, True, None),
    ("ds_prefill_gate_up", 256, 640, 7168, 2048, True, None),
    ("ds_prefill_down", 256, 640, 2048, 7168, True, None),
    ("ds_prefill_gate_up_fill", 256, 640, 7168, 2048, True, 4 * 2048),
    ("ds_prefill_down_fill", 256, 640, 2048, 7168, True, 4 * 2048),
    ("ds_decode_fill", 256, 1, 7168, 2048, True, 4),
    ("ds_decode_down_fill", 256, 1, 2048, 7168, True, 4),
]
GMM_TOP_K = 8
# cases whose bf16 call took the general route until ``prefill_tc`` took
# their head dims (hubert's (80, 80)): ``check_attention`` also times the
# general kernel's bf16 instantiation there, called directly, as
# "before"
GENERAL_BEFORE = ("hubert",)


def attn_key(q, k, v, window: int) -> tuple:
    return (tuple(q.shape), tuple(k.shape), v.shape[-1], window)


def attention_inputs(case, dtype_name: str, seed: int) -> tuple:
    """The case's q, k, v on the card, drawn from ``seed``, and the keyword
    arguments of ``ops.attention`` (mask and positions)."""
    import torch
    (name, counter, B, Sq, Sk, H, KV, hd, hdv, causal, window, pos,
     timed) = case
    dtype = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Sk, KV, hdv), generator=g, device=dev).to(dtype)
    qp = kp = None
    if pos is not None:
        at = {"linear": 2060, "ring": 2060, "ring_pads": 700}[pos]
        qp = torch.full((B, Sq), at, dtype=torch.int32, device=dev)
        first = 0 if pos == "linear" else at - Sk + 1
        kp = torch.arange(first, first + Sk, dtype=torch.int32,
                          device=dev).expand(B, Sk).contiguous()
    return q, k, v, dict(causal=causal, window=window, q_pos=qp, k_pos=kp)


def attention_case_route(case, dtype_name: str) -> str:
    """The attention route ``kernels/flash_attention.py::route`` gives the
    case."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    (_, _, B, Sq, Sk, H, KV, hd, hdv, _, window, pos, _) = case
    return fa.route(getattr(torch, dtype_name), B, Sq, Sk, H, KV, hd, hdv,
                    window, pos is not None)


def check_attention(case, dtype_name: str, seed: int) -> dict:
    """The attention kernel of the case's route against the plain version;
    timed with the plain version and SDPA (``library_ms``) where the case
    says so."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    (name, counter, B, Sq, Sk, H, KV, hd, hdv, causal, window, pos,
     timed) = case
    dev = torch.device("cuda")
    q, k, v, kw = attention_inputs(case, dtype_name, seed)
    qp, kp = kw["q_pos"], kw["k_pos"]

    def run():
        return ops.attention(q, k, v, **kw)

    def plain():
        return ref.attention_ref(q, k, v, **kw)
    route = attention_case_route(case, dtype_name)
    ops.reset_launches()
    got, want = run(), plain()
    torch.cuda.synchronize()
    taken = {r: c for r, c in ops.route_launches.items() if c}
    if taken != {route: 1}:
        raise AssertionError(f"attention {name} {dtype_name}: routes "
                             f"{taken}, expected {route}")
    tol = MODEL_TOL[("attn", dtype_name)]
    ok, err = rel_ok(got, want, tol)
    if not ok:
        raise AssertionError(f"attention {name} {dtype_name}: kernel != "
                             f"plain within {tol} (max abs err {err})")
    # the bound: the pairs the mask leaves, 2 (hd + hd_v) FLOPs per pair
    # and q head; q, k, v (and positions) read once, o written once
    qpos = qp if qp is not None else torch.arange(
        Sq, device=dev).expand(B, Sq)
    kpos = kp if kp is not None else torch.arange(
        Sk, device=dev).expand(B, Sk)
    keep = (kpos[:, None, :] >= 0).expand(B, Sq, Sk)
    if causal:
        keep = keep & (qpos[:, :, None] >= kpos[:, None, :])
    if window:
        keep = keep & (qpos[:, :, None] - kpos[:, None, :] < window)
    pairs = int(keep.sum())
    flops = 2 * H * pairs * (hd + hdv)
    nbytes = got.element_size() * (q.numel() + k.numel() + v.numel()
                                   + got.numel())
    if qp is not None:
        nbytes += 4 * (qp.numel() + kp.numel())
    rate = f32_rate(route) if dtype_name == "float32" else BF16_FLOPS_PER_S
    t_ops, t_bytes = flops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    row = {"case": name, "counter": counter, "route": route,
           "dtype": dtype_name,
           "shape": [B, Sq, Sk, H, KV, hd, hdv], "window": window,
           "key": attn_key(q, k, v, window),
           "max_abs_err": err, "tol": tol, "ms": graph_ms(run, 10, 5),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes}
    if timed:
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = None if (pos is None and not window) else keep[:, None]

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)
        row.update(call_ms=time_ms(run, 10), plain_ms=graph_ms(plain, 2, 2),
                   library_ms=graph_ms(library, 10, 5))
    if name in GENERAL_BEFORE and route == "prefill_tc":
        from repro_torch.kernels import _build
        launch = _build.load("flash_attention").repro_flash_attention
        old = torch.empty_like(got)

        def before():
            err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         old.data_ptr(), None, None, None, B, Sq, Sk, H, KV,
                         hd, hdv, int(causal), int(window), 0, hd ** -0.5, 1,
                         torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"flash_attention.cu bf16: CUDA error "
                                   f"{err}")
        before()
        torch.cuda.synchronize()
        ok, err_b = rel_ok(old, want, tol)
        if not ok:
            raise AssertionError(f"attention {name}: the general kernel's "
                                 f"bf16 != plain within {tol} ({err_b})")
        row.update(before_ms=graph_ms(before, 10, 5),
                   before_call_ms=time_ms(before, 10),
                   before_max_abs_err=err_b, before_route="general")
    return row


def scan_bound(B: int, S: int, di: int, N: int, esize: int, state: bool,
               clock_hz: float, sms: int,
               fma_per_elem: int = SCAN_FMA_PER_ELEM, exp_per_elem: int = 1,
               nbytes: int | None = None) -> dict:
    """Least time for a scan: the larger of its bytes (u, dt and y once, Bc
    and Cc once, A, D and the states once) over the memory rate and its
    arithmetic on ``sms`` SMs at ``clock_hz``.  The arithmetic is
    ``SCAN_FMA_PER_ELEM`` FMA-pipe instructions and one exp2 per (t, d, n),
    a share x of the exps on the special-function unit and the rest
    emulated on the FMA pipe (``EXP_EMULATED_FMA`` each), x chosen so that
    the two pipes finish together.  ``bound_terms_ms`` also holds the FMA
    pipe's time without exps (a lower floor) and the exps' time all on the
    unit (not a floor: some of them can move).  The backward's bound passes
    its own counts per (t, d, n) and its bytes."""
    if nbytes is None:
        nbytes = (esize * (3 * B * S * di + 2 * B * S * N)
                  + 4 * (di * N + di + B * di * N * (2 if state else 1)))
    exps = exp_per_elem * B * S * di * N
    per_s = sms * clock_hz
    sfu = exps / (EXP_PER_CLK_PER_SM * per_s)
    fma = fma_per_elem * B * S * di * N / (FMA_PER_CLK_PER_SM * per_s)
    emul = EXP_EMULATED_FMA * exps / (FMA_PER_CLK_PER_SM * per_s)
    share = min(1.0, (fma + emul) / (sfu + emul))   # sfu*x = fma + emul(1-x)
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "fma_pipe": fma * 1e3, "exps_sfu": sfu * 1e3,
             "arithmetic": max(fma, share * sfu) * 1e3}
    by = "bytes" if terms["bytes"] >= terms["arithmetic"] else "operations"
    return {"bound_ms": max(terms["bytes"], terms["arithmetic"]),
            "bound_by": by, "bound_terms_ms": terms,
            "exp_sfu_share": share, "bytes": nbytes, "exps": exps}


def check_scan(case, dtype_name: str, seed: int, clock_hz: float,
               sms: int) -> dict:
    """The scan kernel against its plain version at one shape, timed; the
    decode step (S = 1) also beside an empty launch on its grid."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import front_find as ff
    from repro_torch.kernels import ops, ref
    name, counter, B, S, di, N, state, on_path = case
    dtype = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    u = rnd(B, S, di).to(dtype)
    dt = F.softplus(rnd(B, S, di)).to(dtype)
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=dev).expand(di, N).contiguous()
    Bc, Cc = rnd(B, S, N).to(dtype), rnd(B, S, N).to(dtype)
    D = rnd(di)
    h0 = rnd(B, di, N) if state else None

    def run():
        return ops.mamba_scan(u, dt, A, Bc, Cc, D, init_state=h0)

    def plain():
        return ref.mamba_scan_ref(u, dt, A, Bc, Cc, D, init_state=h0)
    ops.reset_launches()
    (y, last), (y_ref, last_ref) = run(), plain()
    torch.cuda.synchronize()
    taken = {c: n for c, n in ops.launches.items() if n}
    if taken != {counter: 1}:
        raise AssertionError(f"scan {name} {dtype_name}: launches {taken}, "
                             f"expected {counter}")
    tol = MODEL_TOL[("scan", dtype_name)]
    ok_y, err_y = rel_ok(y, y_ref, tol)
    ok_h, err_h = rel_ok(last, last_ref, tol)
    if not (ok_y and ok_h):
        raise AssertionError(f"scan {name} {dtype_name}: kernel != plain "
                             f"within {tol} (max abs err y {err_y}, "
                             f"state {err_h})")
    row = {"case": name, "counter": counter, "dtype": dtype_name,
           "shape": [B, S, di, N], "key": ((B, S, di), N),
           "max_abs_err": max(err_y, err_h),
           "tol": tol, "ms": graph_ms(run, 10, 5),
           **scan_bound(B, S, di, N, u.element_size(), state, clock_hz,
                        sms)}
    if S == 1:     # the step kernel's grid: N / min(N, 4) lanes a channel
        lanes = B * di * (N // min(N, 4))
        row["empty_ms"] = graph_ms(
            lambda: ff.empty_launch(-(-lanes // 256), 256, dev), 10, 5)
    if on_path:
        row.update(call_ms=time_ms(run, 10), plain_ms=graph_ms(plain, 1, 2),
                   library_ms=None)
    return row


def uniform_fills(G: int, C: int, tokens: int, seed: int):
    """(G,) int32 slot fills of ``tokens`` tokens that each pick
    ``GMM_TOP_K`` distinct slots uniformly at random (a seeded router),
    each fill clamped to the capacity ``C`` as the dispatch does."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.rand((tokens, G), generator=g, device=dev).topk(
        GMM_TOP_K, dim=1).indices.reshape(-1)
    counts = torch.zeros(G, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return counts.clamp(max=C).to(torch.int32)


def gmm_inputs(case, dtype_name: str, seed: int) -> tuple:
    """The case's x (G*C, D) and w (G, D, F) on the card, drawn from
    ``seed``, and its slot fills (None: every row live)."""
    import torch
    name, G, C, D, F, on_path, tokens = case
    dtype = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((G * C, D), generator=g, device=dev).to(dtype)
    w = (torch.randn((G, D, F), generator=g, device=dev)
         * D ** -0.5).to(dtype)
    fills = None if tokens is None else uniform_fills(G, C, tokens, seed)
    return x, w, fills


def check_gmm(case, dtype_name: str, seed: int) -> dict:
    """The grouped-matmul kernel of the case's route against its plain
    version at one shape, with the case's fills (rows past a fill exact
    zeros); timed with the plain version and ``torch.bmm`` on the full
    buffers (``library_ms``) where on the path."""
    import torch
    from repro_torch.kernels import moe_gmm, ops, ref
    name, G, C, D, F, on_path, tokens = case
    dtype = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    x, w, fills = gmm_inputs(case, dtype_name, seed)

    def run():
        return ops.grouped_matmul_aligned(x, w, C, fills)

    def plain():
        return ref.grouped_matmul_aligned_ref(x, w, C, fills)
    route = moe_gmm.route(dtype, C, D, F)
    ops.reset_launches()
    got, want = run(), plain()
    torch.cuda.synchronize()
    taken = {r: c for r, c in ops.gmm_route_launches.items() if c}
    if taken != {route: 1}:
        raise AssertionError(f"grouped_matmul {name} {dtype_name}: routes "
                             f"{taken}, expected {route}")
    tol = MODEL_TOL[("gmm", dtype_name)]
    ok, err = rel_ok(got, want, tol)
    if not ok:
        raise AssertionError(f"grouped_matmul {name} {dtype_name}: kernel "
                             f"!= plain within {tol} (max abs err {err})")
    live_rows, live_slots = G * C, G
    if fills is not None:
        past = torch.arange(C, device=dev)[None, :] >= fills[:, None]
        if not bool((got.view(G, C, F)[past] == 0).all()):
            raise AssertionError(f"grouped_matmul {name} {dtype_name}: rows "
                                 "past the fills are not exact zeros")
        live_rows = int(fills.sum())
        live_slots = int((fills > 0).sum())
    # the live rows' products; x's live rows and the live slots' weights
    # read once (and the fills), every output row written once
    flops = 2 * live_rows * D * F
    nbytes = got.element_size() * (live_rows * D + live_slots * D * F
                                   + got.numel())
    if fills is not None:
        nbytes += 4 * G
    rate = f32_rate(route) if dtype_name == "float32" else BF16_FLOPS_PER_S
    t_ops, t_bytes = flops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    n = 10 if C < 64 else 2      # a prefill-shaped call takes milliseconds
    row = {"case": name, "counter": "grouped_matmul", "route": route,
           "dtype": dtype_name, "shape": [G, C, D, F], "key": (G, C, D, F),
           "fill": fills is not None, "live_rows": live_rows,
           "live_slots": live_slots,
           "max_abs_err": err, "tol": tol, "ms": graph_ms(run, n, 2),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes}
    if on_path:
        xv = x.view(G, C, D)

        def library():
            return torch.bmm(xv, w)
        row.update(call_ms=time_ms(run, n), plain_ms=graph_ms(plain, n, 2),
                   library_ms=graph_ms(library, n, 2))
    return row


class ModelShapes:
    """Counts the model kernels' launches of a driven run by (counter,
    shape key, dtype), to time each counter at its commonest shape, and
    the attention and grouped-matmul calls by (counter, route, shape key,
    dtype) in ``routes``.  A captured decode step's calls are counted once
    a replay, as ``ops.launches`` counts them: those made while
    ``GreedyStep.capture`` records go to the step, which adds them at
    each replay."""

    def __init__(self) -> None:
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import mamba_scan as ms
        from repro_torch.kernels import moe_gmm as mg
        from repro_torch.launch.serve import GreedyStep
        self.shapes: Counter = Counter()
        self.routes: Counter = Counter()
        self._capturing: tuple | None = None
        real_fa, real_ms, real_mg = (fa.flash_attention, ms.mamba_scan,
                                     mg.grouped_matmul)
        real_capture, real_call = GreedyStep.capture, GreedyStep.__call__

        def counters() -> tuple:
            return self._capturing or (self.shapes, self.routes)

        def attention(q, k, v, *, window=0, q_pos=None, k_pos=None, **kw):
            shapes, routes = counters()
            plain = window == 0 and q_pos is None and k_pos is None
            counter = "flash_attention" if plain else "attention_masked"
            key, dt = attn_key(q, k, v, window), str(q.dtype)
            shapes[(counter, key, dt)] += 1
            B, Sq, H, hd = q.shape
            route = fa.route(q.dtype, B, Sq, k.shape[1], H, k.shape[2], hd,
                             v.shape[3], window,
                             q_pos is not None or k_pos is not None)
            routes[(counter, route, key, dt)] += 1
            return real_fa(q, k, v, window=window, q_pos=q_pos,
                           k_pos=k_pos, **kw)

        def scan(u, dt, A, Bc, Cc, D, init_state=None):
            counters()[0][("mamba_scan" if init_state is None else
                           "mamba_step", (tuple(u.shape), A.shape[1]),
                           str(u.dtype))] += 1
            return real_ms(u, dt, A, Bc, Cc, D, init_state=init_state)

        def gmm(x, w, capacity, fills=None):
            shapes, routes = counters()
            key = (w.shape[0], capacity) + tuple(w.shape[1:])
            shapes[("grouped_matmul", key, str(x.dtype))] += 1
            route = mg.route(x.dtype, capacity, *w.shape[1:])
            routes[("grouped_matmul", route, key, str(x.dtype))] += 1
            return real_mg(x, w, capacity, fills)

        def capture(step) -> None:
            self._capturing = (Counter(), Counter())
            try:
                real_capture(step)
            finally:
                step.shape_counts, self._capturing = self._capturing, None

        def call(step) -> None:
            real_call(step)
            if step.graph is not None and step.graph.graph is not None:
                self.shapes.update(step.shape_counts[0])
                self.routes.update(step.shape_counts[1])

        fa.flash_attention, ms.mamba_scan = attention, scan
        mg.grouped_matmul = gmm
        GreedyStep.capture, GreedyStep.__call__ = capture, call


def commonest(shapes: Counter, counter: str) -> tuple:
    """The (shape key, dtype) a counter launched most often; ``counter``
    may be a (counter, route) pair for ``ModelShapes.routes``."""
    head = counter if isinstance(counter, tuple) else (counter,)
    n = len(head)
    return max((k[n:] for k in shapes if k[:n] == head),
               key=lambda kd: shapes[head + kd])


def kernel_name(mangled: str) -> str:
    """A mangled entry name (after ``_Z``) as its last name component --
    anonymous namespaces dropped -- with its template arguments, cut to 40
    characters."""
    rest = mangled[1:] if mangled.startswith("N") else mangled
    name = ""
    while (m := re.match(r"(\d+)", rest)):
        n = int(m.group(1))
        name, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
    return name + rest[:40]


@functools.cache
def sass_lines(lib: Path) -> tuple:
    """(kernel, line) for each SASS line of a built library, as ``cuobjdump
    -sass`` lists it, the kernel named with its template arguments
    (``kernel_name``); (kernel, None) opens each kernel.  Dumped once a
    library."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    rows, name = [], None
    for line in out.splitlines():
        m = re.search(r"Function : _Z(\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            rows.append((name, None))
        elif name:
            rows.append((name, line))
    return tuple(rows)


def tc_instructions(lib: Path, pattern: str = r"\bHG?MMA\.") -> dict:
    """Tensor-core instructions (``HMMA``, ``HGMMA``; ``pattern`` picks
    which) per kernel in the SASS of a built library."""
    counts: dict = {}
    for name, line in sass_lines(lib):
        counts[name] = counts.get(name, 0) + int(
            line is not None and re.search(pattern, line) is not None)
    return counts


def hgmma_shapes(lib: Path) -> dict:
    """The wgmma shapes in the SASS of a built library, per kernel: e.g.
    {"64x80x16": n}, counted."""
    shapes: dict = {}
    for name, line in sass_lines(lib):
        m = line and re.search(r"\bHGMMA\.(\d+x\d+x\d+)", line)
        if m:
            shapes.setdefault(name, Counter())[m.group(1)] += 1
    return {n: dict(c) for n, c in shapes.items()}


def ptxas_summary(log: str) -> list:
    """``nvcc -Xptxas -v`` output, one line per kernel: its name (the
    template arguments kept), registers, shared memory and spills; and
    every warning (e.g. wgmma serialized by ptxas) as it is."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif "warning" in line.lower() or "Performance Loss" in line:
            out.append(line.strip())
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def expected_serve_launches(cfg, G: int) -> dict:
    """What one serve run launches: each global layer's prefill attention
    is plain, each windowed layer's and every GQA decode call masked (MLA
    decodes in plain PyTorch, as the JAX package does in jnp); the SSM
    mixer runs twice per layer in prefill (block, then cache) and once per
    layer and decode step.  A vision group runs its cross and self
    sub-layers' prefill attention twice (block, then the cache pass's
    replay), all plain; in decode its cross call is plain (no positions)
    and its self calls masked."""
    def layers(pred):
        return sum(s.n_layers for s in cfg.segments if pred(s))

    def plain(s):
        return s.kind not in ("mamba", "vision_group")
    n_attn = layers(lambda s: s.attn != "none" and plain(s))
    n_gqa = layers(lambda s: s.attn == "gqa" and plain(s))
    n_window = layers(lambda s: s.sliding_window)
    n_ssm = layers(lambda s: s.kind in ("mamba", "hybrid"))
    n_moe = layers(lambda s: s.kind == "moe")
    n_cross = layers(lambda s: s.kind == "vision_group")
    n_self = sum(s.n_layers * (s.sub_layers - 1) for s in cfg.segments
                 if s.kind == "vision_group")
    return {"flash_attention": n_attn - n_window + 2 * (n_cross + n_self)
            + (G - 1) * n_cross,
            "attention_masked": n_window + (G - 1) * (n_gqa + n_self),
            "mamba_scan": 2 * n_ssm, "mamba_step": (G - 1) * n_ssm,
            "grouped_matmul": 3 * n_moe * G}


def prompt_batch(prompts, images=None) -> dict:
    """The prefill batch: the prompts, and a vision model's image
    embeddings."""
    return {"tokens": prompts} if images is None else {
        "tokens": prompts, "image_embeds": images}


def logits_through(model, prompts, forced, which: str, max_len: int,
                   images=None):
    """Prefill logits and those of ``forced`` teacher-forced decode steps,
    every kernel call sent to ``which`` ("cuda" or "ref")."""
    import torch
    from repro_torch.kernels import ops
    S = prompts.shape[1]
    ops.force(which)
    try:
        with torch.inference_mode():
            logits, caches = model.prefill(prompt_batch(prompts, images),
                                           max_len)
            out = [logits]
            for i in range(forced.shape[1]):
                logits, caches = model.decode_step(forced[:, i:i + 1],
                                                   caches, S + i)
                out.append(logits)
        torch.cuda.synchronize()
    finally:
        ops.force(None)
    return torch.cat(out, dim=1)


def round_weights(model32, model16) -> bool:
    """Overwrite the f32 ``model32``'s weights with the bf16 ``model16``'s,
    cast: the f32 reference of the bf16 paths, with the weights' rounding
    left out.  Returns whether ``make_model`` drew ``model32``'s own
    weights as those the bf16 model rounds (checked on the embedding,
    before the copy)."""
    import torch
    same_draw = bool(torch.equal(model32.embed.to(model16.embed.dtype),
                                 model16.embed))
    p16 = dict(model16.named_parameters())
    with torch.no_grad():
        for name, p in model32.named_parameters():
            p.copy_(p16[name])
    return same_draw


def bf16_errors(kern16, plain16, plain32) -> dict:
    """The bf16 kernel path's and bf16 plain path's max |diff| from the f32
    plain path at the same weights, as shares of its largest |logit|; and
    the kernel path's against the plain path's in bf16 (``bf16_gap``, the
    share of the bf16 plain path's largest |logit|)."""
    scale = float(plain32.abs().max())
    err_k = float((kern16.float() - plain32).abs().max()) / scale
    err_p = float((plain16.float() - plain32).abs().max()) / scale
    gap = float((kern16 - plain16).abs().max()) / float(plain16.abs().max())
    return {"bf16_kernel_err": sig(err_k), "bf16_plain_err": sig(err_p),
            "bf16_err_ratio": sig(err_k / err_p), "bf16_gap": sig(gap)}


def clone_tree(tree):
    """A copy of nested lists and dicts of tensors (a model's caches)."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return [clone_tree(v) for v in tree]


def served_decode(res, tag: str) -> dict:
    """A one-card serve run's decode: it must have replayed a captured
    step (``ServeResult.decode``); its capture seconds."""
    if res.decode != "graph":
        raise AssertionError(f"[{tag}] serve decoded {res.decode!r} on one "
                             f"card, not 'graph'")
    return {"decode": res.decode, "capture_s": sig(res.capture_s)}


def step_activities(prof) -> list:
    """The device activities (kernels and copies) of each whole decode
    step in a ``torch.profiler`` window whose steps each end with their
    token's device->host copy; the window's first step, which tracing may
    cut short, is left out."""
    from torch.autograd import DeviceType
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    counts, n = [], 0
    for e in events:
        n += 1
        if e.key.startswith("Memcpy DtoH"):
            counts.append(n)
            n = 0
    return counts[1:]


def decode_profile(model, prompts, max_len: int, tag: str = "6b",
                   images=None, steps: int = 6) -> dict:
    """Where a decode step's time goes, captured and eager, on one model
    from one unprofiled prefill: ``steps`` greedy steps of
    ``launch.serve.GreedyStep`` on copies of the prefill's caches, as
    ``serve`` runs them on one card (``graph``: one eager step, the
    capture, then replays) and as it runs them on the CPU and under a mesh
    (``eager``: the same in-place step).  Each path runs its steps three
    times from the prefill's state (``GreedyStep.load``, outside the
    timed runs): once timed on the host's clock, then twice under
    ``torch.profiler`` (device activity only): a warm-up cycle, whose
    events are dropped, keeping its logits and tokens, and the window
    read.
    Each step reads its token on the host, as the serve loop does (its one
    device->host copy).  Per path: ms a step, device busy ms a step and
    its share of the wall time, device activities (kernels and copies) a
    step -- over the window, and the median over its whole steps
    (``step_activities``) -- copies host->device and device->host a step.
    The paths' tokens must be equal, the captured step must make no
    host->device copy and one device->host read a step (the window one
    fewer where tracing cut its first step short), and as many activities
    a step as the eager one;
    the logits' max |diff| is reported (bit-equal expected) and must be
    within ``F32_LOGIT_TOL`` of the largest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.launch.serve import GreedyStep
    S = prompts.shape[1]
    out, kept, by_key, per_step = {}, {}, {}, {}

    def run(step, keep=None) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
            tok = step.token.cpu()
            if keep is not None:
                keep.append((step.logits.clone(), tok))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with torch.inference_mode():
        logits, caches0 = model.prefill(prompt_batch(prompts, images),
                                        max_len)
        tok0 = logits[:, -1].argmax(dim=-1, keepdim=True)
        for mode in ("graph", "eager"):
            step = GreedyStep(model, tok0, clone_tree(caches0), S,
                              graph=mode == "graph")
            capture_s = None
            if mode == "graph":
                step()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step.capture()
                torch.cuda.synchronize()
                capture_s = time.perf_counter() - t0
            step.load(tok0, caches0, S)
            wall = run(step)
            # a traced window's first launches can go missing while tracing
            # starts: a warm-up cycle of the same steps (which keeps their
            # logits and tokens), whose events are dropped, comes before
            # the window kept
            kept[mode] = []
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                step.load(tok0, caches0, S)
                run(step, kept[mode])
                step.load(tok0, caches0, S)
                torch.cuda.synchronize()
                prof.step()
                run(step)
                prof.step()
            del step
            kern = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in kern) / 1e6
            acts = sum(e.count for e in kern)
            per_step[mode] = step_activities(prof)
            d2h = sum(e.count for e in kern
                      if e.key.startswith("Memcpy DtoH"))
            h2d = sum(e.count for e in kern
                      if e.key.startswith("Memcpy HtoD"))
            top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
            by_key[mode] = Counter({e.key: e.count for e in kern})
            log(f"[{tag}] {mode} decode, {steps} steps: "
                f"{1e3 * wall / steps:.4f} ms/step wall; device busy "
                f"{1e3 * busy / steps:.4f} ms/step = "
                f"{busy / wall if wall else 0:.4f} of it; activities/step "
                f"{acts / steps:.1f}; device->host copies/step "
                f"{d2h / steps:.2f}, host->device {h2d / steps:.2f}"
                + ("" if capture_s is None else
                   f"; capture {capture_s:.4f} s")
                + "; by kernel (name: count, ms): " + "; ".join(
                    f"{e.key[:50]}: {e.count}, "
                    f"{e.self_device_time_total / 1e3:.3f}" for e in top))
            out[mode] = {"ms_per_step": sig(1e3 * wall / steps)}
            if busy:
                out[mode].update(
                    busy_ms_per_step=sig(1e3 * busy / steps),
                    busy_share=sig(busy / wall),
                    launches_per_step=sig(acts / steps),
                    step_activities=statistics.median(per_step[mode]),
                    whole_step_activities=per_step[mode],
                    d2h_per_step=sig(d2h / steps),
                    h2d_per_step=sig(h2d / steps))
            else:
                out[mode]["busy"] = "not measured"
            if capture_s is not None:
                out[mode]["capture_s"] = sig(capture_s)
    lg = {m: torch.cat([x for x, _ in kept[m]], dim=1) for m in kept}
    tk = {m: torch.cat([t for _, t in kept[m]], dim=1) for m in kept}
    diff = float((lg["graph"] - lg["eager"]).abs().max())
    scale = float(lg["eager"].abs().max())
    out.update(logit_max_diff=sig(diff), logit_scale=sig(scale),
               bit_equal=bool(torch.equal(lg["graph"], lg["eager"])),
               tokens_equal=bool(torch.equal(tk["graph"], tk["eager"])),
               steps=steps)
    apart = {k: (by_key["graph"][k], by_key["eager"][k])
             for k in by_key["graph"] | by_key["eager"]
             if by_key["graph"][k] != by_key["eager"][k]}
    log(f"[{tag}] captured vs eager: logits max |diff| {diff:.6g} of max "
        f"|logit| {scale:.6g} (bit-equal: {out['bit_equal']}); tokens "
        f"equal: {out['tokens_equal']}; device activities whose counts "
        f"differ (captured, eager): {apart}")
    g, e = out["graph"], out["eager"]
    if not out["tokens_equal"] or not diff <= F32_LOGIT_TOL * scale:
        raise AssertionError(f"[{tag}] the captured step parts from the "
                             f"eager one: {out}")
    if "busy" in g or "busy" in e:
        raise AssertionError(f"[{tag}] the profiler saw no device time: "
                             f"{out}")
    # a step's activities: the median over the window's whole steps
    # (tracing has dropped, or misplaced, some of a window's first events
    # in either path); one device->host read a step, and one fewer in the
    # window only where tracing cut its first step short (the window then
    # holds fewer activities than its steps' whole count)
    cut = g["launches_per_step"] < g["step_activities"]
    d2h = round(g["d2h_per_step"] * steps)
    if (g["h2d_per_step"] != 0 or d2h not in ((steps - 1, steps) if cut
                                              else (steps,))
            or g["step_activities"] != e["step_activities"]):
        raise AssertionError(f"[{tag}] a captured step's copies or "
                             f"activities: {out}")
    return out


class Recorder:
    """Observes a driven run: the device passes it attached and the shape
    of every kernel launch (launch counts stay in ``ops.launches``)."""

    def __init__(self) -> None:
        from repro_torch.kernels import front_find, front_pass, gain
        self.passes: list = []
        self.shapes: Counter = Counter()   # (counter, R, M) -> launches
        self.finds: Counter = Counter()    # (queued, active blocks) -> finds
        self.level_finds: Counter = Counter()  # level's n -> find launches
        real_attach, real_launch = front_pass.attach, gain._launch
        real_find = front_find.launch

        def attach(*a, **kw):
            dev = real_attach(*a, **kw)
            if dev is not None:
                self.passes.append(dev)
            return dev

        def launch(rows_perm, pc):
            self.shapes[("min_cover_lambdas",) + tuple(rows_perm.shape)] += 1
            return real_launch(rows_perm, pc)

        def find(x, work, Q, NA, **kw):
            self.finds[(Q, NA)] += 1
            if kw.get("count_as", "front_find") == "front_find":
                self.level_finds[x.n] += 1
            return real_find(x, work, Q, NA, **kw)

        front_pass.attach, gain._launch = attach, launch
        front_find.launch = find

    def reset(self) -> None:
        from repro_torch.kernels import ops
        self.passes.clear()
        self.finds.clear()
        self.level_finds.clear()
        ops.reset_launches()

    def find_shape(self) -> dict:
        """Queued mutations and active blocks per find launch of the run."""
        n = sum(self.finds.values())
        q = [k[0] for k, c in self.finds.items() for _ in range(c)]
        na = sorted(k[1] for k, c in self.finds.items() for _ in range(c))
        return {"launches": n, "max_queue": max(q, default=0),
                "mean_queue": sig(sum(q) / max(n, 1)),
                "median_blocks": na[len(na) // 2] if na else 0,
                "max_blocks": max(na, default=0)}

    def counters(self) -> dict:
        keys = ("commits", "finds", "syncs", "pass_scans",
                "apply_dispatches")
        return {k: sum(getattr(d, k) for d in self.passes) for k in keys}


def check_bounds(passes, launches: dict) -> None:
    """The device passes of one run: ``commits <= finds <= commits +
    pass_scans``, one read per find, no apply outside a find, and one
    launch of the fused find per find."""
    for d in passes:
        if not d.commits <= d.finds <= d.commits + d.pass_scans:
            raise AssertionError(f"finds bound broken: {vars_of(d)}")
        if d.syncs != d.finds or d.apply_dispatches:
            raise AssertionError(f"syncs != finds or a standalone apply: "
                                 f"{vars_of(d)}")
    finds = sum(d.finds for d in passes)
    if not finds or launches["front_find"] != finds or launches["front_apply"]:
        raise AssertionError(f"{finds} finds, launches {launches}")


def vars_of(d) -> dict:
    return {k: getattr(d, k) for k in ("commits", "finds", "syncs",
                                       "pass_scans", "apply_dispatches")}


def where_time_goes(hg, P, cap, m0) -> dict:
    """One device FM pass from ``m0``, plain and under ``torch.profiler``:
    wall time, finds, and the device's busy time by kernel name.  Only
    device activity is traced: host-op events of a whole pass take the
    profiler minutes to summarize."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.frontier import device_pass
    from repro_torch.core.partition import PartitionState

    perm = np.random.default_rng(3).permutation(hg.n)

    def one_pass():
        st = PartitionState(hg, P, masks=m0.copy())
        dev = device_pass(st, cap, backend="torch", device="cuda")
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dev.fm_pass(perm)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, vars_of(dev)
        finally:
            dev.detach()

    wall, counts = one_pass()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_prof, counts_prof = one_pass()
    if counts_prof != counts:
        raise AssertionError("profiled pass took other decisions")
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    ms_find = 1e3 * wall / max(counts["finds"], 1)
    log(f"[3b] one device FM pass, n={hg.n}: {wall:.3f} s "
        f"({wall_prof:.3f} s profiled), {counts}; "
        f"host ms per find {ms_find:.4f}")
    out = {"pass_s": sig(wall), "finds": counts["finds"],
           "syncs": counts["syncs"], "ms_per_find": sig(ms_find)}
    if busy == 0:
        log("[3b] device busy time: not measured (no device events)")
        return out | {"busy_s": "not measured"}
    # every device -> host copy is a blocking read the pass must count: one
    # per find; and the pass runs the fused find and copies, nothing else
    # of PyTorch's (no index, gather or scatter kernel)
    reads = sum(e.count for e in kern if e.key.startswith("Memcpy DtoH"))
    if not reads == counts["syncs"] == counts["finds"]:
        raise AssertionError(f"{reads} device->host copies, but the pass "
                             f"counted {counts['syncs']} syncs and "
                             f"{counts['finds']} finds")
    torch_ops = [e.key for e in kern if any(
        w in e.key.lower() for w in ("index", "gather", "scatter"))]
    if torch_ops:
        raise AssertionError(f"the pass ran PyTorch kernels {torch_ops}")
    found = [e for e in kern if "front_find_kernel" in e.key]
    launches = sum(e.count for e in found)
    if launches != counts["finds"]:
        raise AssertionError(f"{launches} find launches for "
                             f"{counts['finds']} finds")
    find_ms = sum(e.self_device_time_total for e in found) / 1e3
    log(f"[3b] device busy {busy:.4f} s = {busy / wall:.4f} of the "
        f"unprofiled pass; {reads} device->host reads; by kernel (name: "
        f"count, ms): " + "; ".join(
            f"{e.key[:60]}: {e.count}, {e.self_device_time_total / 1e3:.3f}"
            for e in top))
    return out | {"busy_s": sig(busy), "busy_share": sig(busy / wall),
                  "find_ms_per_launch": sig(find_ms / launches),
                  "h2d_per_find": sig(sum(
                      e.count for e in kern
                      if e.key.startswith("Memcpy HtoD")) / launches)}


def moe_layer_check(model, prompts) -> list:
    """Each MoE layer's block on one input through the kernel and through
    the plain version (f32, within ``MODEL_TOL``): the prompts' hidden
    state (a2a, the prefill path) and its last token (tp, decode).  Both
    run the same router on the same input, so the routing is identical and
    only the grouped products differ.  The layers advance on the kernel's
    output.  Returns the max abs error per layer and mode."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models.moe import moe_apply
    cfg = model.cfg
    tol = MODEL_TOL[("gmm", "float32")]
    errs = []
    with torch.inference_mode():
        x = model._embed_inputs({"tokens": prompts})
        for seg, layers in zip(cfg.segments, model.segments):
            for j, lp in enumerate(layers):
                x = x + model._mixer(lp, x, seg)
                h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
                for mode, hin in (("a2a", h), ("tp", h[:, -1:])):
                    got, _ = moe_apply(lp["moe"], hin, cfg, model.plan, mode)
                    ops.force("ref")
                    try:
                        want, _ = moe_apply(lp["moe"], hin, cfg, model.plan,
                                            mode)
                    finally:
                        ops.force(None)
                    ok, err = rel_ok(got, want, tol)
                    if not ok:
                        raise AssertionError(
                            f"MoE layer {j} ({mode}): kernel path != plain "
                            f"path within {tol} (max abs err {err})")
                    errs.append(err)
                    if mode == "a2a":
                        y = got
                x = x + y
    return errs


class RouterLog:
    """While active, records the top-k experts of every router call of the
    MoE slot paths (``models.moe.router_topk``), on the device (no read
    that would stall the host): the routing of a run, to count where two
    runs route apart.  A call recorded into a CUDA graph is not kept (a
    replay runs no Python: only an eager step's routing is seen).  With
    ``replay`` (another run's log), call i routes to that log's call i
    instead, weighted by this call's own probabilities (the router's
    arithmetic, ``moe.router_topk``, with the experts given), while its
    own top k is still recorded."""

    def __init__(self, replay: "RouterLog | None" = None) -> None:
        self.calls: list = []
        self.replay = replay

    def __enter__(self):
        import torch
        import torch.nn.functional as F
        from repro_torch.models import moe
        self._real = moe.router_topk

        def topk(router_w, x, cfg, axes=()):
            w, idx, aux = self._real(router_w, x, cfg, axes)
            own = idx
            if self.replay is not None:
                idx = self.replay.calls[len(self.calls)]
                probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
                w = probs.gather(-1, idx)
                w = (w / w.sum(dim=-1, keepdim=True)).to(x.dtype)
                ce = F.one_hot(idx, cfg.n_experts).float().sum(1).mean(0)
                aux = cfg.n_experts * (probs.mean(dim=0) * ce).sum()
            if not torch.cuda.is_current_stream_capturing():
                self.calls.append(own.clone())
            return w, idx, aux
        moe.router_topk = topk
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.models import moe
        moe.router_topk = self._real

    def flips(self, other: "RouterLog") -> int:
        return int(sum((a != b).sum() for a, b in zip(self.calls,
                                                      other.calls)))


def check_routes(routes: dict, launches: dict, model: str) -> None:
    """A bf16 serve run's attention calls all took the two Hopper routes,
    each at least once."""
    calls = launches["flash_attention"] + launches["attention_masked"]
    if (sum(routes.values()) != calls or routes["general"]
            or routes["prefill_tc"] < launches["flash_attention"]
            or not routes["prefill_tc"] or not routes["decode_split"]):
        raise AssertionError(f"{model} serve: attention routes {routes} "
                             f"for {calls} calls")


def check_gmm_routes(routes: dict, launches: dict, n_moe: int,
                     G: int) -> None:
    """A bf16 serve run's grouped products: prefill (three per MoE layer)
    on ``gmm_tc``, every decode step's on ``gmv``, none on ``general``."""
    want = {"gmv": 3 * n_moe * (G - 1), "gmm_tc": 3 * n_moe, "general": 0}
    if (routes != want
            or sum(routes.values()) != launches["grouped_matmul"]):
        raise AssertionError(f"serve: grouped-matmul routes {routes}, "
                             f"expected {want}")


def check_result(hg, P, eps, res) -> None:
    """Valid, balanced masks whose recomputed cost is the reported one."""
    from repro_torch.core.partition.cost import is_valid, partition_cost
    if not is_valid(hg, res.masks, P, eps):
        raise AssertionError("invalid or unbalanced partition")
    cost = partition_cost(hg, res.masks, P)
    if not (np.isfinite(res.cost) and cost == res.cost):
        raise AssertionError(f"reported cost {res.cost} != recomputed {cost}")


def find_entry(find_rows: list, launches: int, shape: dict,
               p3b: dict) -> dict:
    """The fused find's kernel-line entry: timed at phase 2's P = 8 FM case
    (the pass's feasibility, an event to find) whose count of active blocks
    is nearest the path's median, with the device time per launch that
    phase 3b's profile measured on the path beside it."""
    med = max(shape["median_blocks"], 1)
    row = min((r for r in find_rows if r["P"] == 8 and not r["rep"]
               and not r["full_scan"]),
              key=lambda r: abs(np.log(r["blocks"] / med)))
    return {"name": "front_find", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/"
                      f"{SOURCES['front_find']}.cu",
            "replaces": REPLACES["front_find"],
            "also_replaces": FIND_ALSO_REPLACES, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in find_rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shape": [row["P"], row["blocks"]],
            "call_ms": row["call_ms"], "empty_ms": row["empty_ms"],
            "path_ms": p3b.get("find_ms_per_launch", "not measured")}


def check_levels(passes, level_finds: Counter, launches: dict) -> dict:
    """The V-cycle's device passes by level (its node count): commits,
    finds, syncs and pass scans, and the level's find launches, which
    must equal its finds and its reads; every pass released."""
    levels: dict = {}
    for d in passes:
        row = levels.setdefault(d.n, Counter())
        row["passes"] += 1
        for k in ("commits", "finds", "syncs", "pass_scans"):
            row[k] += getattr(d, k)
        if d.state.device is not None:
            raise AssertionError(f"a device pass at n={d.n} was not "
                                 f"released")
    for lv, row in levels.items():
        row["launches"] = level_finds[lv]
        if not row["finds"] == row["syncs"] == row["launches"]:
            raise AssertionError(f"level n={lv}: {dict(row)}")
    if sum(level_finds.values()) != launches["front_find"]:
        raise AssertionError("a find launch outside the V-cycle's passes")
    return levels


# phase 8's instance: large_row_net(8192), cut from 16,384 nodes (PRs
# 18-33) to keep the smoke inside its time limit; its top two levels (of
# at least DEVICE_MIN_NODES = 4096 nodes) still run the device pass
VCYCLE_N = 8192


def host_partition(instance: tuple, P: int, eps: float, **kw) -> tuple:
    """The host path's ``partition_with_replication(..., frontier="numpy",
    **kw)`` for phases 4 and 8, run in the dry-run pool's process (which
    sees no card) beside the card's run in this one: on moe8's layer 0
    (``("moe8",)``) or ``large_row_net(n, seed=n)`` (``("row", n)``).
    Returns (base, replicated, seconds)."""
    from repro_torch.core.partition.heuristic import (
        partition_with_replication)
    from repro_torch.datagen import large_row_net, moe_dataset
    hg = (large_row_net(instance[1], seed=instance[1])
          if instance[0] == "row" else moe_dataset(
              "moe8", n_layers=1, kappa0=50_000, n_experts=128)[0])
    t0 = time.perf_counter()
    base, rep = partition_with_replication(hg, P, eps, frontier="numpy",
                                           **kw)
    return base, rep, time.perf_counter() - t0


def vcycle_phase(rec: Recorder, P: int, eps: float, n: int, host_pool,
                 device: str = "cuda") -> dict:
    """Phase 8: ``partition_with_replication(large_row_net(n), multilevel=
    True, workers=None)`` with ``frontier="torch"`` on the card and with
    ``frontier="numpy"`` beside it in ``host_pool``'s process, which sees
    no card (``host_partition``): equal base and replicated masks and
    costs; on the card, per level, one find launch and one read per find,
    and the min-cover kernel on the coarse levels.  Then the pool forks
    after the card is up: sharded heavy-pin matching byte-identical to
    serial."""
    import torch
    from repro_torch.core.partition import multilevel as ml
    from repro_torch.core.partition.heuristic import (
        partition_with_replication)
    from repro_torch.core.partition.parallel import ParallelContext
    from repro_torch.datagen import large_row_net
    from repro_torch.kernels import front_pass, ops

    hg = large_row_net(n, seed=n)
    sizes: list = []
    real_build = ml.build_levels

    def build(*a, **kw):
        out = real_build(*a, **kw)
        sizes.append([lv.n for lv in out[0]])
        return out

    host = host_pool.submit(host_partition, ("row", n), P, eps,
                            multilevel=True, workers=None)
    ml.build_levels = build
    try:
        rec.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        base, rep = partition_with_replication(
            hg, P, eps, multilevel=True, workers=None, frontier="torch",
            device=device)
        torch.cuda.synchronize()
        t = {"base": base, "rep": rep, "s": time.perf_counter() - t0,
             "launches": dict(ops.launches), "passes": list(rec.passes),
             "level_finds": Counter(rec.level_finds),
             "peak_B": torch.cuda.max_memory_allocated()}
    finally:
        ml.build_levels = real_build
    h = dict(zip(("base", "rep", "s"), host.result()))
    for a, b in ((t["base"], h["base"]), (t["rep"], h["rep"])):
        if not (np.array_equal(a.masks, b.masks) and a.cost == b.cost):
            raise AssertionError("the V-cycle on the card differs from the "
                                 "host path")
    for res in (t["base"], t["rep"]):
        check_result(hg, P, eps, res)
    if not t["rep"].cost <= t["base"].cost:
        raise AssertionError("replication made the V-cycle's cost worse")
    check_bounds(t["passes"], t["launches"])
    levels = check_levels(t["passes"], t["level_finds"], t["launches"])
    if min(levels, default=0) < front_pass.DEVICE_MIN_NODES:
        raise AssertionError(f"device pass below the floor: {list(levels)}")
    if t["launches"]["min_cover_lambdas"] == 0:
        raise AssertionError("min_cover_lambdas never launched on the "
                             "coarse levels")
    stops = ml._refinement_schedule(len(sizes[0]),
                                    ml.MultilevelOptions().refine_every)
    log(f"[8] V-cycle on large_row_net({n}) P={P}: levels {sizes[0]}, "
        f"refined at n {[sizes[0][i] for i in stops]}; base cost "
        f"{t['base'].cost}, replicated {t['rep'].cost}, equal on cuda "
        f"({t['s']:.2f} s) and numpy ({h['s']:.2f} s, beside it); launches "
        f"{t['launches']}; per level on the card (n: counts) "
        + "; ".join(f"{lv}: {dict(row)}" for lv, row in sorted(levels.items(),
                                                              reverse=True))
        + f"; max_memory_allocated {t['peak_B']} B")

    # the pool, forked after the card is up: its workers run numpy only
    cap = (min(ml.MultilevelOptions().cluster_cap_frac, 0.5 * eps)
           * float(hg.omega.sum()) / P)
    t0 = time.perf_counter()
    with ParallelContext(2) as ctx:
        cm_p, nc_p = ml.heavy_pin_matching(hg, cap, np.random.default_rng(0),
                                           ctx=ctx)
        failed, method = ctx.failed, ctx.start_method
    s_pool = time.perf_counter() - t0
    t0 = time.perf_counter()
    cm_s, nc_s = ml.heavy_pin_matching(hg, cap, np.random.default_rng(0))
    s_serial = time.perf_counter() - t0
    if failed or nc_p != nc_s or cm_p.tobytes() != cm_s.tobytes():
        raise AssertionError(f"pooled matching ({method}): failed={failed}, "
                             f"{nc_p} clusters against {nc_s} serial")
    log(f"[8] heavy_pin_matching on a 2-worker pool ({method}, after CUDA "
        f"init): {nc_p} clusters, byte-identical to serial; "
        f"{s_pool:.2f} s pooled, {s_serial:.2f} s serial")
    return {"n": n, "levels": sizes[0],
            "refined_at": [sizes[0][i] for i in stops],
            "cuda_s": sig(t["s"]), "numpy_s": sig(h["s"]),
            "base": t["base"].cost, "rep": t["rep"].cost,
            "launches": {k: v for k, v in t["launches"].items() if v},
            "per_level": {str(lv): dict(row) for lv, row in levels.items()},
            "peak_B": t["peak_B"], "pool": method,
            "pool_s": sig(s_pool), "serial_match_s": sig(s_serial)}


def window_probe(sched, device: str = "cuda", calls: int = 50) -> dict:
    """Each window program of ``DeviceScheduleWindows`` on one state of
    ``sched``: the longest comm window, the longest compute window and the
    node move touching the most supersteps (the floor on touched steps
    lowered so that the move takes the device fold).  Per priced window:
    the host's time for the whole call (``call_ms``, its read included)
    and, under ``torch.profiler``, the kernels it launches and their
    device time (``device_ms``), copies apart.  Each result is held
    against the numpy front."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.frontier import schedule_front as sf
    from repro_torch.core.schedule import list_sched
    from repro_torch.kernels import front_pass

    def width(lo_hi):
        return lo_hi[1] - lo_hi[0] + 1

    (v, dst) = max(sorted(sched.comms),
                   key=lambda k: width(list_sched._comm_window(sched, *k)))
    lo, hi = list_sched._comm_window(sched, v, dst)
    ts_c = np.arange(lo, hi + 1)
    single = [u for u in range(sched.inst.dag.n)
              if len(sched.assign[u]) == 1]
    comp = [(u, next(iter(sched.assign[u]))) for u in single
            if (u, next(iter(sched.assign[u]))) not in sched.comms]
    (u, p) = max(comp, key=lambda k: width(list_sched._comp_window(sched,
                                                                   *k)))
    lo2, hi2 = list_sched._comp_window(sched, u, p)
    ts_p = np.arange(lo2, hi2 + 1)
    w = max(single, key=lambda k: len(front_pass._node_move_cells(sched, k)))
    T = len(front_pass._node_move_cells(sched, w))
    win = front_pass.DeviceScheduleWindows(sched, device=device)
    progs = {
        "comm": (lambda: win.price_comm_moves(v, dst, ts_c),
                 lambda: sf.price_comm_moves(sched, v, dst, ts_c), len(ts_c)),
        "comp": (lambda: win.price_comp_moves(u, p, ts_p),
                 lambda: sf.price_comp_moves(sched, u, p, ts_p), len(ts_p)),
        "node": (lambda: win.price_node_moves(w),
                 lambda: sf.price_node_moves(sched, w), T)}
    saved = front_pass.DEVICE_MIN_STEPS
    front_pass.DEVICE_MIN_STEPS = 1
    out = {}
    try:
        for kind, (dev, host, size) in progs.items():
            if not np.array_equal(dev(), host()):
                raise AssertionError(f"{kind} window differs from numpy")
            for _ in range(5):
                dev()
            t0 = time.perf_counter()
            for _ in range(calls):
                dev()
            call_ms = (time.perf_counter() - t0) / calls * 1e3
            t0 = time.perf_counter()
            for _ in range(calls):
                host()
            host_ms = (time.perf_counter() - t0) / calls * 1e3
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    dev()
            ev = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
            kern = [e for e in ev if not e.key.startswith("Memcpy")]
            copies = sum(e.count for e in ev if e.key.startswith("Memcpy"))
            dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
            out[kind] = {
                "size": size, "call_ms": sig(call_ms),
                "numpy_ms": sig(host_ms),
                "launches_per_window": sig(sum(e.count for e in kern)
                                           / calls) if kern else
                "not measured",
                "device_ms": sig(dev_ms / calls) if kern else
                "not measured",
                "copies_per_window": sig(copies / calls)}
    finally:
        front_pass.DEVICE_MIN_STEPS = saved
    return out


def schedule_phase(P: int, g: float, L: float, n_ml: int,
                   device: str = "cuda") -> dict:
    """Phase 9: scheduling with replication on the card.  On the engine-
    scale pair (``sptrsv_6000``, ``psdd_2035``): ``hill_climb`` of the
    list schedule, then ``advanced_heuristic``, with ``backend="torch"``
    on the card and ``backend="numpy"`` -- equal assignments, comms and
    costs; then ``multilevel_schedule`` on ``large_sptrsv_dag(n_ml)`` on
    both.  The windows priced on the card are counted (syncs, refreshes,
    launches per program), and must be some."""
    import torch
    from repro_torch.core.schedule import (BspInstance, advanced_heuristic,
                                           bspg_schedule, hill_climb,
                                           multilevel_schedule)
    from repro_torch.datagen import large_sptrsv_dag, psdd_dag, sptrsv_dag
    from repro_torch.kernels import front_pass

    wins: list = []
    sizes: dict = {"comm": [], "comp": []}   # window lengths priced
    Real = front_pass.DeviceScheduleWindows

    class Counted(Real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            wins.append(self)

        def price_comm_moves(self, v, dst, ts):
            sizes["comm"].append(len(ts))
            return super().price_comm_moves(v, dst, ts)

        def price_comp_moves(self, v, p, ts):
            sizes["comp"].append(len(ts))
            return super().price_comp_moves(v, p, ts)

    def counts() -> dict:
        out = Counter()
        for w in wins:
            out["windows"] += 1
            out["syncs"] += w.syncs
            out["refreshes"] += w.refreshes
            for k, c in w.launches.items():
                out[f"{k}_launches"] += c
        for k, got in sizes.items():
            if got:
                out[f"{k}_len_median"] = int(np.median(got))
                out[f"{k}_len_max"] = max(got)
            got.clear()
        return dict(out)

    def same(a, b) -> bool:
        return (a.current_cost() == b.current_cost() and a.assign == b.assign
                and a.comms == b.comms)

    out: dict = {}
    front_pass.DeviceScheduleWindows = Counted
    try:
        for name, dag in (("sptrsv_6000", sptrsv_dag(n=6000, band=48,
                                                     seed=0)),
                          ("psdd_2035", psdd_dag(n_leaves=500, depth=16,
                                                 seed=0))):
            inst = BspInstance(dag, P=P, g=g, L=L)
            res = {}
            for backend in ("torch", "numpy"):
                wins.clear()
                t0 = time.perf_counter()
                hc = hill_climb(bspg_schedule(inst, seed=0), seed=0,
                                backend=backend, device=device)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                adv = advanced_heuristic(hc.copy())
                t2 = time.perf_counter()
                res[backend] = (hc, adv, t1 - t0, t2 - t1, counts())
            (hc, adv, s_hc, s_adv, c), (hcn, advn, s_hcn, s_advn, cn) = \
                res["torch"], res["numpy"]
            if not (same(hc, hcn) and same(adv, advn)):
                raise AssertionError(f"{name}: the schedule on the card "
                                     f"differs from the host path's")
            if cn or not c.get("windows"):
                raise AssertionError(f"{name}: windows {c} / {cn}")
            if adv.validate():
                raise AssertionError(f"{name}: invalid replicated schedule")
            base_c, rep_c = hc.current_cost(), adv.current_cost()
            log(f"[9] {name} (n={dag.n}) P={P} g={g} L={L}: hill_climb "
                f"cost {base_c} on cuda ({s_hc:.3f} s) and numpy "
                f"({s_hcn:.3f} s); advanced_heuristic {rep_c} "
                f"({s_adv:.3f} s after the card's climb, {s_advn:.3f} s "
                f"after numpy's): {100 * (1 - rep_c / base_c):.2f} % "
                f"below the baseline; windows on the card {c}")
            out[name] = {"n": dag.n, "base": base_c, "rep": rep_c,
                         "reduction_pct": sig(100 * (1 - rep_c / base_c)),
                         "hc_cuda_s": sig(s_hc), "hc_numpy_s": sig(s_hcn),
                         "adv_s": [sig(s_adv), sig(s_advn)], "windows": c}
        dag = large_sptrsv_dag(n=n_ml, band=48, seed=0)
        inst = BspInstance(dag, P=P, g=g, L=L)
        res = {}
        for backend in ("torch", "numpy"):
            wins.clear()
            t0 = time.perf_counter()
            sched = multilevel_schedule(inst, seed=0, backend=backend,
                                        device=device)
            torch.cuda.synchronize()
            res[backend] = (sched, time.perf_counter() - t0, counts())
        (mt, s_t, c), (mn, s_n, cn) = res["torch"], res["numpy"]
    finally:
        front_pass.DeviceScheduleWindows = Real
    if not same(mt, mn):
        raise AssertionError("multilevel_schedule on the card differs from "
                             "the host path's")
    if cn or not c.get("syncs"):
        raise AssertionError(f"multilevel_schedule: no window priced on "
                             f"the card ({c}; numpy {cn})")
    if mt.validate():
        raise AssertionError("multilevel_schedule: invalid schedule")
    log(f"[9] multilevel_schedule on large_sptrsv_dag({n_ml}): cost "
        f"{mt.current_cost()} ({mt.S} supersteps) on cuda ({s_t:.2f} s) and "
        f"numpy ({s_n:.2f} s); windows on the card {c}")
    out["ml"] = {"n": n_ml, "cost": mt.current_cost(), "S": mt.S,
                 "cuda_s": sig(s_t), "numpy_s": sig(s_n), "windows": c}
    out["probe"] = window_probe(mt, device)
    log(f"[9] window programs on the V-cycle's schedule: {out['probe']}")
    return out


def encoder_logits(model, frames, which: str):
    """``Model.forward`` then ``logits_fn`` over ``frames`` (an encoder's
    entry points), every kernel call sent to ``which`` ("cuda" or
    "ref")."""
    import torch
    from repro_torch.kernels import ops
    ops.force(which)
    try:
        with torch.inference_mode():
            x, _ = model({"frames": frames})
            logits = model.logits_fn(x)
        torch.cuda.synchronize()
    finally:
        ops.force(None)
    return logits


def hubert_inputs(B: int, S: int) -> tuple:
    """hubert-xlarge's config, ``B`` clips of ``S`` frames drawn with numpy
    from a seed (on the card), and its bf16 model from seeded weights."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_model
    cfg = get_config("hubert-xlarge")
    frames = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)).cuda()
    return cfg, frames, make_model(cfg, device="cuda", seed=0)


@contextlib.contextmanager
def bf16_prefill_on_general():
    """``flash_attention.route`` sending the calls it gives ``prefill_tc``
    without an LSE to ``general``: the route hubert's bf16 forward took
    before ``prefill_tc`` took head dim 80, timed in phase 10 beside the
    route it takes now."""
    from repro_torch.kernels import flash_attention as fa
    route = fa.route

    def on_general(*args, **kw):
        which = route(*args, **kw)
        with_lse = kw.get("with_lse", len(args) > 10 and args[10])
        return "general" if which == "prefill_tc" and not with_lse else which
    fa.route = on_general
    try:
        yield
    finally:
        fa.route = route


def hubert_phase(B: int, S: int, reps: int = 3) -> dict:
    """Phase 10: hubert-xlarge's encoder at full width and depth (48
    non-causal layers of 16 heads of 80, d_model 1280, bf16, seeded
    weights) over ``B`` clips of ``S`` frames drawn with numpy (the feature
    extractor is a stub, as in the JAX package).  One forward's launches
    (every attention call on ``prefill_tc``; the fused kernels' two norms,
    two ropes and one gate a layer and the final norm; nothing else), its
    time (the median of ``reps`` forwards after that one) beside ``reps``
    forwards with the attention on the general route it took before (in
    turns,
    ``bf16_prefill_on_general``), the f32 model's
    kernel path against its plain path within ``F32_LOGIT_TOL`` of the
    largest logit, and the bf16 paths' distances from the f32 plain path
    at the bf16 weights."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, frames, model = hubert_inputs(B, S)
    n = cfg.n_layers
    n_params = sum(p.numel() for p in model.parameters())
    ops.reset_launches()
    kern16 = encoder_logits(model, frames, "cuda")     # also the warm-up
    launches = {c: k for c, k in ops.launches.items() if k}
    routes = dict(ops.route_launches)
    if (routes != {r: n if r == "prefill_tc" else 0 for r in routes}
            or launches != {"flash_attention": n, "rmsnorm": 2 * n + 1,
                             "rope": 2 * n, "silu_gate": n}
            or any(ops.gmm_route_launches.values())):
        raise AssertionError(f"hubert forward: launches {launches}, "
                             f"attention routes {routes}, expected {n} on "
                             "prefill_tc")
    with bf16_prefill_on_general():         # the general route's warm-up
        encoder_logits(model, frames, "cuda")
    ops.reset_launches()
    times, times_before = [], []
    for _ in range(reps):                   # in turns: now, then before
        for on_general, out in ((False, times), (True, times_before)):
            t0 = time.perf_counter()
            if on_general:
                with bf16_prefill_on_general():
                    encoder_logits(model, frames, "cuda")
            else:
                encoder_logits(model, frames, "cuda")
            out.append(time.perf_counter() - t0)
    # the launches of the timed bf16 forwards by route, and the counted
    # forward's on prefill_tc
    timed_routes = dict(ops.route_launches)
    if timed_routes != {"decode_split": 0, "prefill_tc": n * reps,
                        "general": n * reps}:
        raise AssertionError(f"hubert timed forwards: routes "
                             f"{timed_routes}")
    prefill16 = n + timed_routes["prefill_tc"]
    peak = torch.cuda.max_memory_allocated()
    plain16 = encoder_logits(model, frames, "ref")
    # the f32 model (its own draw) through the kernels and the plain
    # versions, gated; then the bf16 weights, cast, through the plain ones
    model32 = make_model(cfg.with_(dtype="float32"), device="cuda", seed=0)
    ops.reset_launches()
    kern32 = encoder_logits(model32, frames, "cuda")
    routes32 = dict(ops.route_launches)
    plain32 = encoder_logits(model32, frames, "ref")
    for name, lg in (("float32", kern32), ("bfloat16", kern16)):
        if not (torch.isfinite(lg).all() and lg.shape == (B, S, cfg.vocab)):
            raise AssertionError(f"hubert {name} logits not finite or "
                                 f"misshapen: {tuple(lg.shape)}")
    gap, scale = (float((kern32 - plain32).abs().max()),
                  float(plain32.abs().max()))
    if routes32["general"] != n or not gap <= F32_LOGIT_TOL * scale:
        raise AssertionError(f"hubert f32 kernel path: routes {routes32}, "
                             f"off the plain path by {gap} > "
                             f"{F32_LOGIT_TOL} x {scale}")
    del kern32, plain32
    same_draw = round_weights(model32, model)
    ref32 = encoder_logits(model32, frames, "ref")
    errs = bf16_errors(kern16, plain16, ref32)
    del model32, model, kern16, plain16, ref32
    torch.cuda.empty_cache()
    med = sorted(times)[len(times) // 2]
    med_before = sorted(times_before)[len(times_before) // 2]
    log(f"[10] {cfg.name} encoder ({n} layers, d_model {cfg.d_model}, "
        f"{n_params} parameters, bf16): {B} clips x {S} frames; forward + "
        f"logits {med:.6g} s (median of {reps}: "
        f"{[round(t, 6) for t in times]}); with the attention on the "
        f"general route, as before: {med_before:.6g} s "
        f"({[round(t, 6) for t in times_before]}); max_memory_allocated "
        f"{peak} B; launches {launches}; attention routes {routes}")
    log(f"[10] f32 kernel path vs plain path: max |diff| {gap:.6g} of max "
        f"|logit| {scale:.6g} (ratio {gap / scale:.6g}); bf16 paths against "
        f"the f32 plain path at the bf16 weights (same draw: {same_draw}): "
        f"kernel {errs['bf16_kernel_err']}, plain {errs['bf16_plain_err']} "
        f"(ratio {errs['bf16_err_ratio']}); kernel vs plain in bf16 "
        f"{errs['bf16_gap']}")
    return {"B": B, "S": S, "params": n_params, "forward_s": sig(med),
            "forward_runs_s": [sig(t) for t in times],
            "forward_before_s": sig(med_before),
            "forward_before_runs_s": [sig(t) for t in times_before],
            "peak_B": peak, "launches": launches, "routes": routes,
            "f32_routes": routes32, "prefill_tc_launches_bf16": prefill16,
            "f32_gap": sig(gap / scale), **errs, "same_draw": same_draw}


# phase 11: deepseek-v3-671b at its published widths, cut in depth only
# to (dense, MoE) MLA layers: the served cut (54.6 GB of bf16 weights; a
# third MoE layer would need 77.6 GB) and the f32 gate's (58.5 GB of f32
# weights), with MTP depth 1 (built, not run by serving)
DS_SERVE_DEPTH = (3, 2)
DS_GATE_DEPTH = (1, 1)


def deepseek_config(dense: int, moe: int, dtype: str = "bfloat16"):
    """deepseek-v3-671b with only its depth cut: ``dense`` + ``moe`` MLA
    layers of the published 3 + 58."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import Segment
    return get_config("deepseek-v3-671b").with_(
        segments=(Segment("dense", dense, attn="mla"),
                  Segment("moe", moe, attn="mla")), dtype=dtype)


def deepseek_phase(shapes: "ModelShapes", B: int, S: int, G: int,
                   B_gate: int) -> dict:
    """Phase 11: serve deepseek-v3 at its published widths (d_model 7168,
    128 heads, MLA q/kv ranks 1536/512, head dims 128 + 64 and 128, 256
    experts of 2048 top-8 and one shared, vocabulary 129,280), depth cut to
    ``DS_SERVE_DEPTH``, bf16, seeded weights: ``B`` prompts of ``S``
    tokens, ``G`` new each, one-shard round-robin placement.  Launches
    exactly as expected (each layer's prefill attention on ``prefill_tc``,
    no attention kernel in MLA decode, the grouped products on ``gmm_tc``
    and ``gmv``); a decode profile of the same cut.  Then, at
    ``DS_GATE_DEPTH`` over ``B_gate`` prompts: the bf16 model through the
    kernels and the plain versions (logits kept on the host), then the f32
    model (its own draw) through both, within ``F32_LOGIT_TOL`` of the
    largest logit (a router near-tie counted as in phase 7, from the
    routers' choices on both paths), then its weights rounded to the bf16
    model's, through the plain versions: each bf16 path's distance."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_model, make_prompts, serve
    cfg = deepseek_config(*DS_SERVE_DEPTH)
    n_layers, n_moe = sum(DS_SERVE_DEPTH), DS_SERVE_DEPTH[1]
    cut = (f"depth {DS_SERVE_DEPTH[0]} dense + {DS_SERVE_DEPTH[1]} MoE of "
           f"the published 3 + 58 layers, MTP 1; widths as published")
    shapes.shapes.clear()
    shapes.routes.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = serve(cfg, B, S, G, device="cuda", seed=0)
    peak = torch.cuda.max_memory_allocated()
    dec = served_decode(res, "11")
    routes = dict(ops.route_launches)
    gmm = dict(ops.gmm_route_launches)
    shapes11, routes11 = Counter(shapes.shapes), Counter(shapes.routes)
    launches = {c: res.launches[c] for c in MODEL_COUNTERS}
    want = expected_serve_launches(cfg, G)
    want_routes = {"decode_split": 0, "prefill_tc": n_layers, "general": 0}
    if launches != want or routes != want_routes:
        raise AssertionError(f"deepseek serve launched {launches}, routes "
                             f"{routes}; expected {want}, {want_routes}")
    check_gmm_routes(gmm, launches, n_moe, G)
    if res.tokens.shape != (B, G) or not (
            (res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise AssertionError(f"bad generated tokens {res.tokens.shape}")
    log(f"[11] serve {cfg.name} ({cut}; d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, {cfg.n_experts} experts top-{cfg.top_k} + "
        f"{cfg.n_shared_experts} shared, bf16): {B} prompts x {S} tokens, "
        f"{G} new each; prefill {res.prefill_s:.4f} s, decode "
        f"{res.ms_per_token:.4f} ms/token ({res.decode}, capture "
        f"{res.capture_s:.4f} s), {res.tokens_per_s:.2f} tok/s, "
        f"max_memory_allocated {peak} B; launches {launches}; attention "
        f"routes {routes}; grouped-matmul routes {gmm}; sample "
        f"{res.tokens[0][:8].tolist()}")
    served = {"prefill_s": sig(res.prefill_s),
              "ms_per_token": sig(res.ms_per_token),
              "tok_s": sig(res.tokens_per_s), **dec}
    del res
    prompts = torch.from_numpy(make_prompts(cfg, B, S, 0)).cuda()
    forced = torch.from_numpy(make_prompts(cfg, B, 3, 1)).cuda()
    torch.cuda.empty_cache()
    model = make_model(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    profile = decode_profile(model, prompts, S + G, tag="11b")
    del model
    torch.cuda.empty_cache()

    # the f32 gate and the bf16 distances, at the gate's depth; the bf16
    # and the f32 model do not fit the card together
    cfg_g = deepseek_config(*DS_GATE_DEPTH)
    pg, fg = prompts[:B_gate], forced[:B_gate]
    model16 = make_model(cfg_g, device="cuda", seed=0)
    kern16 = logits_through(model16, pg, fg, "cuda", S + G).cpu()
    plain16 = logits_through(model16, pg, fg, "ref", S + G).cpu()
    dtypes16 = {n: p.dtype for n, p in model16.named_parameters()}
    probe16 = model16.embed[:256].cpu()
    del model16
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model32 = make_model(cfg_g.with_(dtype="float32"), device="cuda", seed=0)
    n_gate = sum(p.numel() for p in model32.parameters())
    ops.reset_launches()
    with RouterLog() as rk:
        kern32 = logits_through(model32, pg, fg, "cuda", S + G)
    routes32 = dict(ops.route_launches)
    gmm32 = dict(ops.gmm_route_launches)
    with RouterLog() as rp:
        plain32 = logits_through(model32, pg, fg, "ref", S + G)
    peak32 = torch.cuda.max_memory_allocated()
    flips = rk.flips(rp)
    n_gl = sum(DS_GATE_DEPTH)
    want32 = ({"decode_split": 0, "prefill_tc": 0, "general": n_gl},
              {"gmv": 3 * 3, "gmm_tc": 0, "general": 3})
    if (routes32, gmm32) != want32:
        raise AssertionError(f"deepseek f32 routes {routes32}, grouped "
                             f"{gmm32}; expected {want32}")
    for name, lg in (("float32", kern32), ("bfloat16", kern16)):
        if not (torch.isfinite(lg).all()
                and lg.shape == (B_gate, 4, cfg.vocab)):
            raise AssertionError(f"deepseek {name} logits not finite or "
                                 f"misshapen: {tuple(lg.shape)}")
    gap, scale = (float((kern32 - plain32).abs().max()),
                  float(plain32.abs().max()))
    if not gap <= F32_LOGIT_TOL * scale:
        log(f"[11] f32 logits off by {gap} > {F32_LOGIT_TOL} x {scale}; "
            f"the routers' choices differ in {flips} top-k choices")
        if flips == 0:
            raise AssertionError("deepseek f32 kernel path off the plain "
                                 "path with identical routing")
    del kern32, plain32
    # the bf16 model's weights, cast: model32's own, rounded in place
    same_draw = bool(torch.equal(
        model32.embed[:256].to(torch.bfloat16).cpu(), probe16))
    with torch.no_grad():
        for n, p in model32.named_parameters():
            if dtypes16[n] == torch.bfloat16:
                p.copy_(p.to(torch.bfloat16))
    ref32 = logits_through(model32, pg, fg, "ref", S + G).cpu()
    del model32
    torch.cuda.empty_cache()
    errs = bf16_errors(kern16, plain16, ref32)
    log(f"[11] gate at depth {DS_GATE_DEPTH[0]} dense + {DS_GATE_DEPTH[1]} "
        f"MoE ({n_gate} parameters, f32; max_memory_allocated {peak32} B), "
        f"{B_gate} prompt(s) of {S} tokens, prefill + 3 decode steps: f32 "
        f"kernel path vs plain path max |diff| {gap:.6g} of max |logit| "
        f"{scale:.6g} (ratio {gap / scale:.6g}), routers apart in {flips} "
        f"top-k choices; attention routes {routes32}, grouped {gmm32}")
    log(f"[11] bf16 paths against the f32 plain path at the bf16 weights "
        f"(same draw: {same_draw}): kernel {errs['bf16_kernel_err']}, plain "
        f"{errs['bf16_plain_err']} (ratio {errs['bf16_err_ratio']}); kernel "
        f"vs plain in bf16 {errs['bf16_gap']}")
    return {"cut": cut, "params": n_params, "B": B, "S": S, "G": G,
            **served, "peak_B": peak, "launches": launches, "routes": routes,
            "gmm_routes": gmm, "profile": profile, "gate_params": n_gate,
            "gate_B": B_gate, "gate_peak_B": peak32, "f32_routes": routes32,
            "f32_gmm_routes": gmm32, "f32_gap": sig(gap / scale),
            "route_flips": flips, **errs, "same_draw": same_draw,
            "shapes": shapes11, "model_routes": routes11}


# phase 12: llama-3.2-vision-11b at the registry's full width and depth;
# the JAX init's leaves hold VISION_PARAMS parameters (``param_count``
# prices two norms per group too many: ROADMAP Queue 3 f)
VISION_PARAMS = 9_775_157_256
VISION_GATE_TANH = (0.4, 0.8)


def vision_gates(n: int, seed: int) -> list:
    """``n`` gate values drawn from ``seed``, |tanh(gate)| uniform in
    ``VISION_GATE_TANH`` with random signs, each an f32 value."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(*VISION_GATE_TANH, n) * rng.choice((-1.0, 1.0), n)
    return [float(np.float32(np.arctanh(x))) for x in t]


def set_gates(model, gates) -> None:
    """Each vision group's cross-attention gate, in order, to ``gates``."""
    import torch
    groups = [lp for seg, layers in zip(model.cfg.segments, model.segments)
              if seg.kind == "vision_group" for lp in layers]
    if len(groups) != len(gates):
        raise ValueError(f"{len(gates)} gates for {len(groups)} groups")
    with torch.no_grad():
        for lp, g in zip(groups, gates):
            lp["cross"]["gate"].fill_(g)


class GatedModels:
    """While active, every model ``launch.serve.make_model`` draws (the
    one ``serve`` serves among them) gets ``gates``."""

    def __init__(self, gates) -> None:
        self.gates = gates

    def __enter__(self):
        from repro_torch.launch import serve as sv
        self._real = sv.make_model

        def make(*a, **kw):
            model = self._real(*a, **kw)
            set_gates(model, self.gates)
            return model
        sv.make_model = make
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.launch import serve as sv
        sv.make_model = self._real


def vision_phase(shapes: "ModelShapes", B: int, S: int, G: int) -> dict:
    """Phase 12: serve llama-3.2-vision-11b at full width and depth, bf16,
    seeded weights and gates (``vision_gates``): ``B`` prompts of ``S``
    tokens with the launcher's stub image embeddings, ``G`` new each.
    Launches exactly as expected, every attention call on ``prefill_tc``
    or ``decode_split``; a decode profile.  Then the bf16 model through
    the kernels and the plain versions (logits kept on the host), the f32
    model (its own draw, the same gates) through both within
    ``F32_LOGIT_TOL`` of the largest logit, and its weights rounded to
    the bf16 model's through the plain versions: each bf16 path's
    distance."""
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import (draw_batch, make_model,
                                          make_prompts, serve)
    cfg = get_config("llama-3.2-vision-11b")
    n_groups = sum(sg.n_layers for sg in cfg.segments)
    gates = vision_gates(n_groups, seed=12)
    log(f"[12] gates {gates}; tanh "
        f"{[round(math.tanh(g), 6) for g in gates]}")
    shapes.shapes.clear()
    shapes.routes.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with GatedModels(gates):
        res = serve(cfg, B, S, G, device="cuda", seed=0)
    peak = torch.cuda.max_memory_allocated()
    dec = served_decode(res, "12")
    routes = dict(ops.route_launches)
    gmm = dict(ops.gmm_route_launches)
    shapes12, routes12 = Counter(shapes.shapes), Counter(shapes.routes)
    launches = {c: res.launches[c] for c in MODEL_COUNTERS}
    want = expected_serve_launches(cfg, G)
    n_attn = cfg.n_layers           # every sub-layer attends, cross or self
    want_routes = {"decode_split": (G - 1) * n_attn,
                   "prefill_tc": 2 * n_attn, "general": 0}
    if launches != want or routes != want_routes or any(gmm.values()):
        raise AssertionError(f"vision serve launched {launches}, routes "
                             f"{routes}, grouped {gmm}; expected {want}, "
                             f"{want_routes}, none")
    cross_decode = sum(c for k, c in routes12.items()
                       if k[:2] == ("flash_attention", "decode_split"))
    if cross_decode != (G - 1) * n_groups:
        raise AssertionError(f"{cross_decode} unmasked decode calls, "
                             f"expected {(G - 1) * n_groups}")
    if res.tokens.shape != (B, G) or not (
            (res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise AssertionError(f"bad generated tokens {res.tokens.shape}")
    log(f"[12] serve {cfg.name} ({n_groups} groups, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.hd}, {cfg.n_image_tokens} image tokens, bf16): {B} prompts x "
        f"{S} tokens, {G} new each; prefill {res.prefill_s:.4f} s, decode "
        f"{res.ms_per_token:.4f} ms/token ({res.decode}, capture "
        f"{res.capture_s:.4f} s), {res.tokens_per_s:.2f} tok/s, "
        f"max_memory_allocated {peak} B; launches {launches}; attention "
        f"routes {routes}, {cross_decode} of the decode calls unmasked "
        f"(cross); sample {res.tokens[0][:8].tolist()}")
    served = {"prefill_s": sig(res.prefill_s),
              "ms_per_token": sig(res.ms_per_token),
              "tok_s": sig(res.tokens_per_s), **dec}
    del res
    batch = draw_batch(cfg, np.random.default_rng(0), B, S)  # serve's draw
    prompts = torch.from_numpy(batch["tokens"]).cuda()
    images = torch.from_numpy(batch["image_embeds"]).cuda()
    forced = torch.from_numpy(make_prompts(cfg, B, 3, 1)).cuda()
    torch.cuda.empty_cache()
    model = make_model(cfg, device="cuda", seed=0)
    set_gates(model, gates)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != VISION_PARAMS:
        raise AssertionError(f"{n_params} parameters, not {VISION_PARAMS}")
    profile = decode_profile(model, prompts, S + G, tag="12b",
                             images=images)
    kern16 = logits_through(model, prompts, forced, "cuda", S + G,
                            images).cpu()
    plain16 = logits_through(model, prompts, forced, "ref", S + G,
                             images).cpu()
    dtypes16 = {n: p.dtype for n, p in model.named_parameters()}
    probe16 = model.embed[:256].cpu()
    del model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model32 = make_model(cfg.with_(dtype="float32"), device="cuda", seed=0)
    set_gates(model32, gates)
    ops.reset_launches()
    kern32 = logits_through(model32, prompts, forced, "cuda", S + G, images)
    routes32 = dict(ops.route_launches)
    want32 = {"decode_split": 3 * n_attn, "prefill_tc": 0,
              "general": 2 * n_attn}
    if routes32 != want32:
        raise AssertionError(f"vision f32 routes {routes32}, expected "
                             f"{want32}")
    plain32 = logits_through(model32, prompts, forced, "ref", S + G, images)
    peak32 = torch.cuda.max_memory_allocated()
    for name, lg in (("float32", kern32), ("bfloat16", kern16)):
        if not (torch.isfinite(lg).all() and lg.shape == (B, 4, cfg.vocab)):
            raise AssertionError(f"vision {name} logits not finite or "
                                 f"misshapen: {tuple(lg.shape)}")
    gap, scale = (float((kern32 - plain32).abs().max()),
                  float(plain32.abs().max()))
    if not gap <= F32_LOGIT_TOL * scale:
        raise AssertionError(f"vision f32 kernel path off the plain path by "
                             f"{gap} > {F32_LOGIT_TOL} x {scale}")
    del kern32, plain32
    # the bf16 model's weights, cast: model32's own, rounded in place
    same_draw = bool(torch.equal(
        model32.embed[:256].to(torch.bfloat16).cpu(), probe16))
    with torch.no_grad():
        for n, p in model32.named_parameters():
            if dtypes16[n] == torch.bfloat16:
                p.copy_(p.to(torch.bfloat16))
    ref32 = logits_through(model32, prompts, forced, "ref", S + G,
                           images).cpu()
    del model32
    torch.cuda.empty_cache()
    errs = bf16_errors(kern16, plain16, ref32)
    log(f"[12] f32 model ({n_params} parameters; max_memory_allocated "
        f"{peak32} B), {B} prompts of {S} tokens, prefill + 3 decode steps: "
        f"kernel path vs plain path max |diff| {gap:.6g} of max |logit| "
        f"{scale:.6g} (ratio {gap / scale:.6g}); attention routes {routes32}")
    log(f"[12] bf16 paths against the f32 plain path at the bf16 weights "
        f"(same draw: {same_draw}): kernel {errs['bf16_kernel_err']}, plain "
        f"{errs['bf16_plain_err']} (ratio {errs['bf16_err_ratio']}); kernel "
        f"vs plain in bf16 {errs['bf16_gap']}")
    return {"params": n_params, "B": B, "S": S, "G": G, **served,
            "peak_B": peak, "launches": launches, "routes": routes,
            "cross_decode": cross_decode, "profile": profile,
            "gates": gates, "gate_peak_B": peak32, "f32_routes": routes32,
            "f32_gap": sig(gap / scale), **errs, "same_draw": same_draw,
            "shapes": shapes12, "model_routes": routes12}


# ------------------------------------------------- 13. training hymba
# the backward kernels against autograd of their plain versions: max
# |kernel - reference| over the largest |reference| of each gradient.
# bf16: the kernels round P and dS (attention) and every gradient (both)
# to bf16, 8 bits, and the reference rounds at other places; f32: 3xTF32
# products summed in another order (attention), ex2.approx exps in the
# scan's recurrence -- near f32 accuracy, a few 1e-6 of the largest entry
GRAD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# prefill_tc's row log-sum-exp (log2 units) against attention_lse_ref: its
# f32 sums over bf16 products in another order
LSE_TOL = 1e-3
BWD_KERNELS = ("attention_bwd", "mamba_scan_bwd", "moe_gmm_bwd",
               "attention_bwd_tc", "moe_gmm_bwd_tc")
# the wgmma kernels of the bf16 backward routes (``tc``) and of the
# attention prefill that writes their LSE, each with the prefix of its
# kernels' names: phase 1 holds their SASS to HGMMA instructions and their
# ptxas report to no spills
WGMMA_SOURCES = {"attention_prefill_tc": ("prefill_tc_kernel",),
                 "attention_bwd_tc": ("dq_kernel", "dkv_kernel"),
                 "moe_gmm_bwd_tc": ("gmm_bwd_tc_kernel",)}
# the head dims whose wgmma shapes phase 1 reports from the SASS: hubert's
# (80, 80), whose P V, dQ, dK and dV products are 80 columns wide
SASS_SHAPES_OF = "ILi80ELi80E"     # template arguments <80, 80>, mangled
# what each backward kernel stands for: the gradient of the Pallas kernel,
# which the JAX package cannot differentiate (ROADMAP Queue 3 g)
BWD_REPLACES = {"attention_bwd": "src/repro/kernels/flash_attention.py:25",
                "mamba_scan_bwd": "src/repro/kernels/mamba_scan.py:24",
                "grouped_matmul_bwd": "src/repro/kernels/moe_gmm.py:23"}
# (name, B, S, H, KV, hd, window, causal): hymba's training attention
BWD_ATTN_CASES = [("train_global", 4, 2048, 25, 5, 64, 0, True),
                  ("train_window", 4, 2048, 25, 5, 64, 1024, True)]
BWD_SCAN_CASE = (4, 2048, 3200, 16)
# per (t, d, n) of the scan's backward at the least: one forward
# recurrence for the states (dt * A, x * B, the state's FMA) and the
# reverse walk (dt * A, g's FMA, dBc, dCc, the sum with B, h - x B, g times
# it, its sums into ddt and dA, a g) -- 13 FMA-pipe instructions -- and
# two exps (a_t in each direction)
SCAN_BWD_FMA_PER_ELEM = 13
SCAN_BWD_EXP_PER_ELEM = 2
# the scan backward's kernels (``csrc/mamba_scan_bwd.cu``) by pass
SCAN_BWD_PASSES = {"pass1": "seg_fwd_kernel", "pass2": "seg_bwd_kernel",
                   "finish": "finish_kernel"}
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 5
# the two-rank worlds (19b, 20b, 21b) train the first MESH_STEPS of one
# card's steps: their steps over gloo take 2-6 s each, and the first
# (its collectives counted) 17-24 s
MESH_STEPS = 3
GATE_B = 2


def hymba_gate_config(cfg):
    """13c's cut of ``cfg`` (hymba-1.5b): one layer of each segment, so
    both attention kinds (global and windowed) and the scan stay."""
    import dataclasses
    return cfg.with_(segments=tuple(dataclasses.replace(s, n_layers=1)
                                    for s in cfg.segments))


def hymba_layers_config(layers: int):
    """hymba-1.5b cut to ``layers`` layers: its first, global-attention
    layer and ``layers - 1`` of the windowed ones after it."""
    import dataclasses
    from repro_torch.configs import get_config
    segs = get_config("hymba-1.5b").segments
    return get_config("hymba-1.5b").with_(segments=(
        segs[0], dataclasses.replace(segs[1], n_layers=layers - 1)))


def sdpa_backend(q, k, v, mask, causal: bool = True) -> str:
    """The SDPA backend that PyTorch's default dispatch picks for these
    (B, heads, S, head dim) inputs (MATH takes any call)."""
    import torch
    from torch.nn.attention import SDPBackend
    pick = torch._fused_sdp_choice(q, k, v, attn_mask=mask,
                                   is_causal=causal and mask is None,
                                   enable_gqa=True)
    return {int(b): n for n, b in SDPBackend.__members__.items()}[pick]


def grad_gap(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def check_attention_bwd(case, dtype_name: str, seed: int,
                        ref_batch: int | None = None) -> dict:
    """The attention backward on its route (``flash_attention.bwd_route``:
    ``tc`` in bf16, ``general`` in f32), from the forward's LSE, which the
    forward writes (``prefill_tc`` in bf16, ``general`` in f32) and which
    must lie within ``LSE_TOL`` of ``attention_lse_ref``, against autograd
    of the plain version at a training shape, two runs bit-equal, the
    route asserted.  ``case`` is (name, B, S, H, KV, hd, window, causal),
    its head dim hd = hd_v or a pair (hd, hd_v).  Timed beside its bound
    (five products per live pair and head with the LSE given -- S, dQ and
    dK of 2 hd FLOPs, dP and dV of 2 hd_v; the six-product figure beside
    it), the plain backward (``attention_bwd_ref``) and SDPA's forward and
    backward (``library_ms``; its forward alone and its backward alone,
    the pair less the forward, beside it; the backend the default dispatch
    picks, ``sdpa_backend``; in f32 logged beside the row).  The plain
    versions run ``ref_batch`` batch elements a call (default all): at
    deepseek's 128 heads one element's f32 scores are 2.1 GB.  And the
    forward on its route with the LSE written and without it, in turns."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import flash_attention as fa
    name, B, S, H, KV, hd, window, causal = case
    hd, hd_v = hd if isinstance(hd, tuple) else (hd, hd)
    dtype = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((B, S, H, hd), (B, S, KV, hd),
                             (B, S, KV, hd_v)))
    do = torch.randn((B, S, H, hd_v), generator=g, device=dev).to(dtype)
    kw = dict(causal=causal, window=window)
    scale = hd ** -0.5
    route = fa.bwd_route(dtype, S, S, hd, hd_v, window, False)
    step = ref_batch or B
    parts = [slice(b, b + step) for b in range(0, B, step)]
    want = [[], [], []]
    for sl in parts:
        leaves = [t[sl].clone().requires_grad_() for t in (q, k, v)]
        ref.attention_ref(*leaves, **kw).backward(do[sl])
        for w, t in zip(want, leaves):
            w.append(t.grad)
        del leaves
    want = [torch.cat(w) for w in want]
    with torch.no_grad():
        o, lse = fa.flash_attention(q, k, v, scale=scale, return_lse=True,
                                    **kw)
        lse_err = max(float((lse[sl] - ref.attention_lse_ref(
            q[sl], k[sl], scale=scale, **kw)).abs().max()) for sl in parts)
        if not lse_err <= LSE_TOL:
            raise AssertionError(f"attention {name}: the forward's LSE off "
                                 f"by {lse_err}")

    def run():
        return fa.attention_bwd(q, k, v, o, do, scale=scale, lse=lse, **kw)

    def plain():
        return [ref.attention_bwd_ref(
            q[sl], k[sl], v[sl], o[sl], do[sl], scale=scale, lse=lse[sl],
            **kw) for sl in parts]
    ops.reset_launches()
    got, again = run(), run()
    torch.cuda.synchronize()
    routes = dict(ops.bwd_route_launches)
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    errs = {n: grad_gap(a, b) for n, a, b in zip("qkv", got, want)}
    tol = GRAD_TOL[dtype_name]
    if (routes[f"attention_{route}"] != 2 or sum(routes.values()) != 2
            or not repeat or max(errs.values()) > tol
            or any(a.shape != b.shape for a, b in zip(got, want))):
        raise AssertionError(f"attention backward {name} {dtype_name}: "
                             f"{errs} past {tol}, routes {routes} (want 2 "
                             f"on {route}), shapes, or two runs differ "
                             f"(bit-equal: {repeat})")
    del got, again, want
    # the bound: per live pair and q head, 2 hd FLOPs for each of S, dQ
    # and dK, 2 hd_v for dP and dV (both routes take the forward's LSE);
    # q, k, v, o, do read once, dq, dk, dv written once
    i = torch.arange(S, device=dev)
    keep = torch.ones((S, S), dtype=torch.bool, device=dev)
    if causal:
        keep &= i[:, None] >= i[None, :]
    if window:
        keep &= (i[:, None] - i[None, :]) < window
    pairs = B * int(keep.sum())
    products = 5
    flop_pair = 2 * (3 * hd + 2 * hd_v)
    nbytes = q.element_size() * 2 * (q.numel() + do.numel() + k.numel()
                                     + v.numel())
    rate = BF16_FLOPS_PER_S if dtype_name == "bfloat16" else \
        F32_TC_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop_pair * H * pairs / rate * 1e3
    t_ops6 = (2 * (4 * hd + 2 * hd_v)) * H * pairs / rate * 1e3
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous().requires_grad_(
        x is not do) for x in (q, k, v, do))
    mask = keep if window else None

    def library_fwd():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)

    def library():
        library_fwd().backward(dot)
    row = {"case": name, "dtype": dtype_name, "bwd_route": route,
           "shape": [B, S, S, H, KV, hd, hd_v], "window": window,
           "causal": causal,
           "max_abs_err": max(errs.values()), "errs": errs, "tol": tol,
           "bit_equal": repeat, "ms": graph_ms(run, 5, 3),
           "call_ms": time_ms(run, 5), "plain_ms": graph_ms(plain, 1, 2),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "products": products, "bound6_ms": max(t_ops6, t_bytes),
           "flops": flop_pair * H * pairs, "bytes": nbytes,
           "pairs": pairs, "ref_batch": step, "lse_err": lse_err,
           "sdpa_backend": sdpa_backend(qt, kt, vt, mask, causal)}
    with torch.no_grad():
        lib_fwd = time_ms(library_fwd, 5)
    row.update(library_ms=time_ms(library, 5), library_fwd_ms=lib_fwd)
    row["library_bwd_ms"] = row["library_ms"] - lib_fwd
    if route == "general":
        log(f"[bwd] {name} f32: {sig(row['ms'])} ms, SDPA's pair "
            f"{sig(row['library_ms'])} ms, its backward alone "
            f"{sig(row['library_bwd_ms'])} ms")
    with torch.no_grad():
        fwd = [lambda: fa.flash_attention(q, k, v, scale=scale, **kw),
               lambda: fa.flash_attention(q, k, v, scale=scale,
                                          return_lse=True, **kw)]
        # in turns: without, with, with, without
        t = [graph_ms(fwd[j], 5, 3) for j in (0, 1, 1, 0)]
        row["fwd_ms"], row["fwd_lse_ms"] = (t[0] + t[3]) / 2, \
            (t[1] + t[2]) / 2
    return row


def scan_bwd_inputs(dtype_name: str, seed: int,
                    case: tuple = BWD_SCAN_CASE) -> tuple:
    """The scan backward's inputs at ``case`` (B, S, di, N; default
    ``BWD_SCAN_CASE``) on the card, from ``seed``: ((u, dt, A, Bc, Cc, D),
    dy); A is -(1 .. N) on every channel, as Mamba initialises it."""
    import torch
    import torch.nn.functional as F
    B, S, di, N = case
    dtype = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    u = rnd(B, S, di).to(dtype)
    dt = F.softplus(rnd(B, S, di) - 2).to(dtype)
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=dev).expand(di, N).contiguous()
    Bc, Cc, D = rnd(B, S, N).to(dtype), rnd(B, S, N).to(dtype), rnd(di)
    dy = rnd(B, S, di).to(dtype)
    return (u, dt, A, Bc, Cc, D), dy


def check_scan_bwd(dtype_name: str, seed: int, clock_hz: float,
                   sms: int, case: tuple = BWD_SCAN_CASE,
                   name: str = "train") -> dict:
    """The scan's backward kernel against autograd of the plain version at
    ``case`` (default hymba's training shape), two runs bit-equal, timed
    beside its bound and the plain version's backward
    (``mamba_scan_bwd_ref`` on the kernel's segments); no library call
    computes it.  Beside: its segments (the last one's steps too) and
    each pass's device time (``kernel_split_ms``)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import mamba_scan as ms
    B, S, di, N = case
    ins, dy = scan_bwd_inputs(dtype_name, seed, case)
    u = ins[0]
    leaves = [t.clone().requires_grad_() for t in ins]
    ref.mamba_scan_ref(*leaves)[0].backward(dy)
    want = [t.grad for t in leaves]
    del leaves
    plan = ms.bwd_plan(B, S, di, N)

    def run():
        return ms.mamba_scan_bwd(*ins, dy)

    def plain():
        return ref.mamba_scan_bwd_ref(*ins, dy, segment=plan["seg_len"])
    got, again = run(), run()
    torch.cuda.synchronize()
    names = ("du", "ddt", "dA", "dBc", "dCc", "dD")
    errs = {n: grad_gap(a, b) for n, a, b in zip(names, got, want)}
    tol = GRAD_TOL[dtype_name]
    if max(errs.values()) > tol:
        raise AssertionError(f"scan backward {dtype_name}: {errs} past "
                             f"{tol}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"scan backward {dtype_name}: two runs "
                             f"differ")
    del got, again, want
    esize = u.element_size()
    nbytes = (esize * (5 * B * S * di + 4 * B * S * N)
              + 4 * (2 * di * N + 2 * di))
    bound = scan_bound(B, S, di, N, esize, False, clock_hz, sms,
                       fma_per_elem=SCAN_BWD_FMA_PER_ELEM,
                       exp_per_elem=SCAN_BWD_EXP_PER_ELEM, nbytes=nbytes)
    row = {"case": name, "dtype": dtype_name, "shape": [B, S, di, N],
           "max_abs_err": max(errs.values()), "errs": errs, "tol": tol,
           "bit_equal": True, "segments": plan["nseg"],
           "segment_steps": plan["seg_len"],
           "last_segment_steps": S - (plan["nseg"] - 1) * plan["seg_len"],
           "ms": graph_ms(run, 3, 3), "call_ms": time_ms(run, 3)}
    row["pass_ms"] = kernel_split_ms(run, SCAN_BWD_PASSES, 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain()
    torch.cuda.synchronize()
    return {**row, "plain_ms": 1e3 * (time.perf_counter() - t0),
            "library_ms": None, **bound}


def kernel_split_ms(fn, kernels: dict, reps: int) -> dict:
    """Each kernel of ``kernels`` (key: a part of its name) that ``fn``
    launches once a call: its device time per call, from ``reps`` whole
    calls of ``fn`` under ``torch.profiler``, keyed by kernel name.  Its
    time is the mean over the launches the trace holds: the trace can miss
    some (on the H100 it kept none of a profile's first launches after
    other work had run), and a kernel still missing after three profiles
    is "not measured"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    us = {k: 0.0 for k in kernels}
    n = {k: 0 for k in kernels}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            for k, name in kernels.items():
                if name in e.key:
                    us[k] += e.self_device_time_total
                    n[k] += e.count
        if all(n.values()):
            break
    return {k: sig(us[k] / 1e3 / n[k]) if n[k] else "not measured"
            for k in kernels}


def expected_train_launches(cfg, leaves: int = 0) -> dict:
    """One training step's launches with remat "full" or "dots" (with
    ``leaves``, the fused AdamW's too, one a leaf): every
    layer's forward kernels twice (the forward and its recompute in the
    backward pass: "dots" saves the matrix products' outputs, not the
    kernels'), one backward kernel each -- an MoE layer's three grouped
    products twice and one backward call each; with remat "none" the
    forward kernels once; each MTP block (a dense layer with the last
    segment's attention, GQA or MLA) its forward kernels once, as
    ``Model._mtp_loss`` runs it without recompute, and one backward kernel
    each; nothing else.  The fused elementwise kernels likewise: a layer's
    norms (one before each sub-layer, MLA's ``q_ln`` and ``kv_ln`` too),
    two ropes an attention layer, one conv a Mamba mixer, one gate an MLP,
    a mixer and an MoE layer's experts (one shard: the local branch) and
    shared experts; the final norm before each head (the model's, each MTP
    block's) and each MTP block's input norm once."""
    from repro_torch.kernels import ops
    from repro_torch.models.config import Segment
    want = {c: 0 for c in ops.launches}
    runs = [(seg, 1 if cfg.remat == "none" else 2) for seg in cfg.segments]
    if cfg.mtp_depth:
        runs.append((Segment("dense", cfg.mtp_depth,
                             attn=cfg.segments[-1].attn), 1))
    for seg, fwd in runs:
        n = seg.n_layers
        if seg.attn in ("gqa", "mla"):
            want["attention_masked" if seg.sliding_window
                 else "flash_attention"] += fwd * n
            want["attention_bwd"] += n
        if seg.kind in ("mamba", "hybrid"):
            want["mamba_scan"] += fwd * n
            want["mamba_scan_bwd"] += n
        if seg.kind == "moe":
            want["grouped_matmul"] += 3 * fwd * n
            want["grouped_matmul_bwd"] += 3 * n
        mixer = seg.kind in ("mamba", "hybrid")
        per = {"rmsnorm": (1 if seg.kind == "mamba" else 2)
               + 2 * (seg.attn == "mla"),
               "rope": 2 * (seg.attn in ("gqa", "mla")
                            and seg.kind != "mamba"),
               "causal_conv": int(mixer),
               "silu_gate": int(mixer) + int(seg.kind != "mamba")
               + int(seg.kind == "moe" and bool(cfg.n_shared_experts))}
        for c, k in per.items():
            want[c] += fwd * k * n
            want[f"{c}_bwd"] += k * n
    want["rmsnorm"] += 1 + 2 * cfg.mtp_depth
    want["rmsnorm_bwd"] += 1 + 2 * cfg.mtp_depth
    want["adamw"] = leaves
    return want


def expected_bwd_routes(cfg) -> dict:
    """One training step's backward calls by route
    (``ops.bwd_route_launches``): every attention and grouped-matmul
    backward call on the wgmma kernels (``tc``) in bf16, on ``general`` in
    f32."""
    from repro_torch.kernels import ops
    want = expected_train_launches(cfg)
    tag = "tc" if cfg.dtype == "bfloat16" else "general"
    out = {c: 0 for c in ops.bwd_route_launches}
    out[f"attention_{tag}"] = want["attention_bwd"]
    out[f"gmm_{tag}"] = want["grouped_matmul_bwd"]
    return out


def train_step_split(ts, state, batch) -> dict:
    """One more step, run eagerly (the captured step is one replay, with
    no host between its parts): its phases timed with CUDA events (the
    loss's forward, the backward pass with its recompute, AdamW) and its
    kernels under ``torch.profiler``: device time by kind, and the
    "other" kind's by the aten op that launched each kernel (the innermost
    ``aten::`` op around its launch; ``other_by_op``, the largest first),
    which says what ROADMAP item 13's fusions would take."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    params = ts._bind(state["params"])
    with profile(activities=[ProfilerActivity.CUDA,
                             ProfilerActivity.CPU]) as prof:
        for p in params.values():
            p.grad = None
        ev[0].record()
        loss, _ = ts.model.loss(batch)
        ev[1].record()
        loss.backward()
        for p in params.values():       # as ``TrainStep.grads`` leaves
            if p.grad is None:          # them: a frame model's embed
                p.grad = torch.zeros_like(p)
        ev[2].record()
        ts.update(state, params)
        ev[3].record()
        torch.cuda.synchronize()
    phases = {k: ev[i].elapsed_time(ev[i + 1]) for i, k in enumerate(
        ("forward_ms", "backward_ms", "adamw_ms"))}
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    by = {k: 0.0 for k in TRAIN_KINDS}
    by["other"] = 0.0
    for e in kern:
        by[train_kind(e.key)] += e.self_device_time_total / 1e3
    other: Counter = Counter()
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        op = e
        while op is not None and not op.name.startswith("aten::"):
            op = op.cpu_parent
        name = e.name if op is None else op.name
        for k in e.kernels:
            if train_kind(k.name) == "other":
                other[name] += k.duration / 1e3
    busy = sum(by.values())
    # the four fused ops' eager chains are gone: no kernel under rsqrt,
    # silu (forward or backward) or sin, and cos only for the learning
    # rate's one scalar (``optim.adamw.schedule``)
    chains: Counter = Counter()
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        op = e
        while op is not None and not op.name.startswith("aten::"):
            op = op.cpu_parent
        if op is not None and op.name in CHAINS_GONE:
            chains[op.name] += len(e.kernels)
    if any(n > (name == "aten::cos") for name, n in chains.items()):
        raise AssertionError(f"an eager step still launches the fused ops' "
                             f"chains: {dict(chains)}")
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    return {"form": "eager", **{k: sig(v) for k, v in phases.items()},
            "device_ms": {k: sig(v) for k, v in by.items()},
            "busy_ms": sig(busy),
            "busy_share": sig(busy / sum(phases.values())) if busy else
            "not measured",
            "other_by_op": [[k, sig(v)] for k, v in other.most_common(12)],
            "other_by_op_total_ms": sig(sum(other.values())),
            "chain_kernels": dict(chains),
            "top": [[e.key[:60], e.count, sig(e.self_device_time_total / 1e3)]
                    for e in top]}


# the aten ops of the four fused ops' eager chains (rmsnorm's rsqrt, the
# SiLUs, rope's cos and sin): ``train_step_split`` finds none of their
# kernels in a step but the schedule's cos
CHAINS_GONE = ("aten::rsqrt", "aten::silu", "aten::silu_backward",
               "aten::cos", "aten::sin")


# a training step's device kernels by kind (``train_kind``), by name:
# the wgmma backward kernels (attention_bwd_tc.cu's dq_kernel<HD, HDV>
# and dkv_kernel<HD, HDV>, moe_gmm_bwd_tc.cu's) first: the general
# routes' kernels of the same names take (T, HD, ...) template arguments
TRAIN_KINDS = {
    # the fused elementwise kernels (``csrc/fused.cu``), first: their
    # names may hold later kinds' keys
    "rmsnorm": ("fused_rmsnorm",), "rope": ("fused_rope",),
    "conv": ("fused_conv",), "gate": ("fused_gate",),
    "attention_bwd_tc": tuple(f"{k}_kernel<{hd}," for k in ("dq", "dkv")
                              for hd in (64, 80, 128, 192)),
    "gmm_bwd_tc": ("gmm_bwd_tc_kernel",),
    "attention_fwd": ("prefill_tc_kernel", "flash_kernel"),
    "scan_fwd": ("scan_kernel",),
    "attention_bwd": ("dq_kernel", "dkv_kernel"),
    "scan_bwd": tuple(SCAN_BWD_PASSES.values()),
    "gmm_fwd": ("gmm_tc_kernel", "gmm_kernel", "gmv_kernel"),
    "gmm_bwd": ("dx_kernel", "dw_kernel"),
    "adamw": ("adamw_kernel",),
    "gemm": ("gemm", "xmma", "cutlass", "cublas", "sm90_",
             "nvjet")}     # cuBLAS's Hopper GEMMs: nvjet_tst_*


def train_kind(name: str) -> str:
    """The kind of a training step's device kernel (``TRAIN_KINDS``), or
    "other": elementwise, reduction, gather and copy kernels."""
    for k, keys in TRAIN_KINDS.items():
        if k in ("attention_fwd", "scan_fwd") and "bwd" in name:
            continue
        if any(x in name for x in keys):
            return k
    return "other"


def head_times(T: int, D: int, V: int) -> dict:
    """The loss head's product (T, D) x (D, V), forward and backward (dX
    and dHead) from an f32 cotangent, device ms by CUDA events: as the
    step runs it for a bf16 model (``models.model._HeadProduct``: bf16
    operands into f32) and as it ran before, through f32 copies of x and
    the head; the bound of the three products at 989 TFLOP/s bf16 (the f32
    path's at 67 TFLOP/s beside it)."""
    import torch
    from repro_torch.models.model import _HeadProduct
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = (torch.randn((T, D), generator=gen, device="cuda") * 0.5
         ).bfloat16().requires_grad_(True)
    w = (torch.randn((D, V), generator=gen, device="cuda") * 0.02
         ).bfloat16().requires_grad_(True)
    g = torch.randn((T, V), generator=gen, device="cuda")

    def bf16():
        _HeadProduct.apply(x, w).backward(g)

    def f32():
        (x.float() @ w.float()).backward(g)
    out = {"shape": [T, D, V]}
    for name, fn in (("bf16", bf16), ("f32", f32)):
        fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(2):
            x.grad = w.grad = None
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = sig(ev[0].elapsed_time(ev[1]) / 2)
    x.grad = w.grad = None
    flops = 3 * 2 * T * D * V
    out["bound_ms"] = sig(1e3 * flops / BF16_FLOPS_PER_S)
    out["f32_bound_ms"] = sig(1e3 * flops / F32_FLOPS_PER_S)
    del x, w, g
    torch.cuda.empty_cache()
    return out


class FrameStream:
    """Batches of ``B`` clips of ``S`` frames (B, S, d_model) f32 and
    their frame labels (B, S) int32, drawn with numpy from ``seed``: the
    data pipeline draws tokens only (the JAX package's does the same,
    ROADMAP Queue 3 h), so a frame-input model's training run draws its
    own, as phase 10 does."""

    def __init__(self, cfg, B: int, S: int, seed: int):
        self.cfg, self.B, self.S = cfg, B, S
        self.rng = np.random.default_rng(seed)

    def next_batch(self) -> dict:
        return {"frames": self.rng.standard_normal(
                    (self.B, self.S, self.cfg.d_model)).astype(np.float32),
                "labels": self.rng.integers(0, self.cfg.vocab, (
                    self.B, self.S)).astype(np.int32)}


def train_steps(cfg, opt, tag: str, stream=None, split: bool = True
                ) -> dict:
    """``TRAIN_STEPS`` bf16 training steps of ``cfg`` on the batches of
    ``stream`` (default ``TRAIN_B`` x ``TRAIN_S`` tokens from
    ``SyntheticTokenStream(seed=0)``; a ``FrameStream`` for a frame-input
    model), the step run directly (not through ``Trainer.run``'s retries)
    and captured (``TrainStep.mode`` "graph"): step 1 runs
    eagerly on the capture's stream and records the CUDA graph, steps 2-5
    replay it.  Returned and logged: the losses (finite), the eager first
    step's seconds (its call less the capture's), the capture's seconds
    and the graph pool's bytes, seconds per step (the median of the
    replayed steps 2-5), tokens (frames) a second, peak memory
    (``max_memory_allocated`` over the run), and each step's launches
    exactly as ``expected_train_launches`` says with the fused AdamW's
    (one a leaf; a replay books its capture's), all attention on
    ``prefill_tc``, all grouped products on ``gmm_tc``; then, with
    ``split``, the graph is dropped, one more step is split, eagerly
    (``train_step_split``), and the loss head's product is timed
    (``head_times``).  The MoE routers
    are recorded where Python runs the step, in the eager first step (a
    replay runs none), whose recompute of every MoE layer (remat "full"
    or "dots") must route as its forward did: ``torch.utils.checkpoint``
    compares only the recomputed tensors' shapes.  A model with experts
    also returns that step's routing (``routing``: each MoE layer's (T,
    k) experts, on the card).  Also returned: the training state's bytes
    (``state_B``: parameters, f32 master, m and v), its leaves and step
    1's loss unrounded (``loss0``)."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
    from repro_torch.kernels import ops
    from repro_torch.train.step import batch_to, build_train_step
    ts = build_train_step(cfg, opt, device="cuda")
    state = ts.init_state(0)
    leaves = len(state["params"])
    n_params = sum(p.numel() for p in state["params"].values())
    state_B = sum(t.numel() * t.element_size() for part in (
        state["params"], state["opt"]["master"], state["opt"]["m"],
        state["opt"]["v"]) for t in part.values())
    if stream is None:
        stream = SyntheticTokenStream(cfg, DataConfig(TRAIN_B, TRAIN_S,
                                                      seed=0))
    want = expected_train_launches(cfg, leaves)
    want_bwd = {c: TRAIN_STEPS * n
                for c, n in expected_bwd_routes(cfg).items()}
    want_kinds = ["capture"] + ["replay"] * (TRAIN_STEPS - 1)
    n_moe = sum(s.n_layers for s in cfg.segments if s.kind == "moe")
    n_route = n_moe if cfg.remat == "none" else 2 * n_moe
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, per_step, kinds = [], [], [], []
    log_r = RouterLog()
    ops.reset_launches()
    for step in range(TRAIN_STEPS):
        before = dict(ops.launches)
        batch = batch_to(stream.next_batch(), "cuda")
        B, S = batch["labels"].shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with log_r:
            state, met = ts.step_fn(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        kinds.append(ts.last_kind)
        losses.append(float(met["loss"]))
        per_step.append({c: ops.launches[c] - before[c] for c in before})
        # the forward's layers 0..L-1, then the recompute's L-1..0
        calls, log_r.calls = log_r.calls, []
        if step == 0:
            routing = calls[:n_moe]
        if len(calls) != (0 if ts.last_kind == "replay" else n_route) or \
                n_route > n_moe and calls and any(
                    not torch.equal(calls[i], calls[-1 - i])
                    for i in range(n_moe)):
            raise AssertionError(f"train step {step} ({ts.last_kind}): the "
                                 f"recompute routed apart from the forward "
                                 f"({len(calls)} router calls)")
    del met
    launches = dict(ops.launches)
    routes = dict(ops.route_launches)
    gmm_routes = dict(ops.gmm_route_launches)
    bwd_routes = dict(ops.bwd_route_launches)
    peak = torch.cuda.max_memory_allocated()
    if kinds != want_kinds:
        raise AssertionError(f"{tag}: the steps ran as {kinds}, expected "
                             f"{want_kinds}")
    for i, got in enumerate(per_step):
        if got != want:
            raise AssertionError(f"train step {i} launched {got}, expected "
                                 f"{want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training losses {losses}")
    n_attn = TRAIN_STEPS * (want["flash_attention"]
                            + want["attention_masked"])
    n_gmm = TRAIN_STEPS * want["grouped_matmul"]
    if routes != {"prefill_tc": n_attn, "decode_split": 0, "general": 0} \
            or gmm_routes != {"gmv": 0, "gmm_tc": n_gmm, "general": 0}:
        raise AssertionError(f"bf16 training took routes {routes}, "
                             f"grouped products {gmm_routes}")
    if bwd_routes != want_bwd:
        raise AssertionError(f"bf16 training's backward calls took routes "
                             f"{bwd_routes}, expected {want_bwd}")
    med = float(np.median(seconds[1:]))
    capture_s = ts.capture_s
    first_s = seconds[0] - capture_s
    unit = "frames" if cfg.frame_input else "tokens"
    log(f"[{tag}] train {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params} parameters in {leaves} leaves, bf16, "
        f"remat {cfg.remat}, step {ts.mode}): {TRAIN_STEPS} steps of {B} x "
        f"{S} {unit} ({kinds}), losses {losses}, seconds {seconds}; the "
        f"eager first step {first_s:.6g} s, the capture {capture_s:.6g} s "
        f"(graph pool {ts.graph_pool_B} B); median of steps "
        f"2-{TRAIN_STEPS} {med:.6g} s/step, {B * S / med:.6g} {unit}/s; "
        f"max_memory_allocated {peak} B; launches per step "
        f"{per_step[0]}; routes {routes}, grouped products {gmm_routes}, "
        f"backward calls {bwd_routes}")
    mode, pool_B = ts.mode, ts.graph_pool_B
    ts.drop_graph()
    torch.cuda.empty_cache()
    parts = {}
    if split:
        batch = batch_to(stream.next_batch(), "cuda")
        parts["split"] = train_step_split(ts, state, batch)
        log(f"[{tag}] one more step, eager, split: "
            f"{json.dumps(parts['split'])}")
        del batch
    del ts, state
    torch.cuda.empty_cache()
    if split:
        head = parts["head"] = head_times(B * S, cfg.d_model, cfg.vocab)
        log(f"[{tag}] the loss head (x {head['shape'][:2]} @ head "
            f"{head['shape'][1:]}, forward and backward, "
            f"{1 + cfg.mtp_depth} a step): bf16 into f32 {head['bf16_ms']} "
            f"ms, the f32 copies' {head['f32_ms']} ms; bound "
            f"{head['bound_ms']} ms (bf16), {head['f32_bound_ms']} ms (f32)")
    out = dict(losses=[sig(x) for x in losses],
               step_s=[sig(x) for x in seconds], median_step_s=sig(med),
               tokens_per_s=sig(B * S / med), batch=[B, S], peak_B=peak,
               n_params=n_params, leaves=leaves, state_B=state_B,
               loss0=losses[0], launches=launches, mode=mode,
               first_step_s=sig(first_s), capture_s=sig(capture_s),
               graph_pool_B=pool_B,
               per_step_launches=per_step[0], routes=routes,
               gmm_routes=gmm_routes, bwd_routes=bwd_routes, **parts)
    if n_moe:
        out["routing"] = routing
    return out


def train_phase(clock_hz: float, sms: int) -> dict:
    """13a, 13b and 13c (see the module docstring)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import batch_to
    out: dict = {"attn_rows": [], "scan_rows": []}
    # 13a: the backward kernels at hymba's training shapes
    for i, case in enumerate(BWD_ATTN_CASES):
        for dt in ("bfloat16", "float32"):
            out["attn_rows"].append(check_attention_bwd(case, dt, 400 + i))
            log("    " + json.dumps(out["attn_rows"][-1]))
            torch.cuda.empty_cache()
    for dt in ("bfloat16", "float32"):
        out["scan_rows"].append(check_scan_bwd(dt, 500, clock_hz, sms))
        log("    " + json.dumps(out["scan_rows"][-1]))
        torch.cuda.empty_cache()

    # 13b: hymba-1.5b at full width and depth, bf16, remat "full"
    cfg = get_config("hymba-1.5b")
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    out.update(train_steps(cfg, opt, "13b"))
    torch.cuda.empty_cache()

    # 13c: the f32 model cut in depth, one backward through the kernels
    # and one through the plain versions, then one AdamW step from each
    cfg32 = hymba_gate_config(cfg).with_(dtype="float32")
    out["gate"] = adamw_gate(cfg32, opt, batch_to(SyntheticTokenStream(
        cfg32, DataConfig(GATE_B, TRAIN_S, seed=0)).next_batch(), "cuda"),
        "13c")
    return out


def adamw_gate(cfg32, opt, batch: dict, tag: str) -> dict:
    """The f32 model of ``cfg32`` from seed 0: one loss and backward on
    ``batch`` through the kernels and one through the plain versions, then
    one AdamW step from each (the start and the kernel path's result kept
    on the host): losses within 1e-5 relative, every leaf within
    ``GRAD_TOL`` f32 of its largest entry (the worst reported), every
    backward call on ``general``, the launches as
    ``expected_train_launches`` says and none on the plain path, and at
    most 1e-5 of the parameters more than lr / 10 apart after the step
    (phases 13c and 16c)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train.step import build_train_step
    ts = build_train_step(cfg32, opt, device="cuda")
    state = ts.init_state(0)
    start = {n: p.detach().to("cpu", copy=True)
             for n, p in state["params"].items()}
    gate: dict = {}
    for which in ("cuda", "ref"):
        ops.force(which)
        ops.reset_launches()
        try:
            t0 = time.perf_counter()
            params, met = ts.grads(state, batch)
            torch.cuda.synchronize()
            gate[f"{which}_s"] = time.perf_counter() - t0
        finally:
            ops.force(None)
        gate[f"{which}_launches"] = {c: n for c, n in ops.launches.items()
                                     if n}
        gate[f"{which}_bwd_routes"] = {c: n for c, n in
                                       ops.bwd_route_launches.items() if n}
        gate[f"{which}_loss"] = float(met["loss"])
        if which == "cuda":
            grads_k = {n: p.grad.clone() for n, p in params.items()}
        else:
            gaps = {n: grad_gap(p.grad, grads_k[n])
                    for n, p in params.items()}
            del grads_k
        ts.update(state, params)
        if which == "cuda":
            after_k = {n: p.detach().to("cpu", copy=True)
                       for n, p in params.items()}
            o = state["opt"]
            with torch.no_grad():        # back to the same start
                o["step"].zero_()
                for n, p in params.items():
                    p.copy_(start[n])
                    o["master"][n].copy_(p)
                    o["m"][n].zero_()
                    o["v"][n].zero_()
    rel_loss = abs(gate["cuda_loss"] - gate["ref_loss"]) / abs(
        gate["ref_loss"])
    worst = max(gaps, key=gaps.get)
    off, total, max_moved = 0, 0, 0.0
    for n, p in params.items():
        d = (p.detach() - after_k[n].to(p.device)).abs()
        off += int((d > opt.lr / 10).sum())
        total += d.numel()
        max_moved = max(max_moved, float(d.max()))
    gate.update(rel_loss=rel_loss, worst_leaf=worst,
                worst_gap=gaps[worst], params_off=off, params=total,
                max_param_gap_over_lr=max_moved / opt.lr)
    want32 = expected_train_launches(cfg32)
    if gate["cuda_launches"] != {c: n for c, n in want32.items() if n}:
        raise AssertionError(f"f32 kernel path launched "
                             f"{gate['cuda_launches']}, expected {want32}")
    bwd32 = {c: n for c, n in expected_bwd_routes(cfg32).items() if n}
    if gate["cuda_bwd_routes"] != bwd32 or gate["ref_bwd_routes"]:
        raise AssertionError(f"f32 backward calls took routes "
                             f"{gate['cuda_bwd_routes']} (plain path: "
                             f"{gate['ref_bwd_routes']}), expected {bwd32}")
    if gate["ref_launches"]:
        raise AssertionError(f"plain path launched {gate['ref_launches']}")
    B, S = batch["labels"].shape
    unit = "frames" if cfg32.frame_input else "tokens"
    log(f"[{tag}] f32 {cfg32.name}, {B} x {S} {unit}: loss kernels "
        f"{gate['cuda_loss']!r}, plain {gate['ref_loss']!r} (relative gap "
        f"{rel_loss:.3g}); worst gradient leaf {worst}: {gaps[worst]:.3g} "
        f"of its largest |grad|; after one AdamW step {off} of {total} "
        f"parameters differ by more than lr / 10 (max {max_moved / opt.lr:.3g}"
        f" lr); kernel path {gate['cuda_s']:.3f} s, plain "
        f"{gate['ref_s']:.3f} s; launches {gate['cuda_launches']}")
    if not rel_loss <= 1e-5:
        raise AssertionError(f"f32 losses differ by {rel_loss}")
    if not gaps[worst] <= GRAD_TOL["float32"]:
        raise AssertionError(f"f32 gradient {worst} off by {gaps[worst]}")
    if not off <= 1e-5 * total:
        raise AssertionError(f"{off} of {total} parameters off after AdamW")
    del ts, state, params, start, after_k
    torch.cuda.empty_cache()
    return {k: (sig(v) if isinstance(v, float) else v)
            for k, v in gate.items()}


# ------------------------------------------------ 14. training olmoe
# olmoe-1b-7b at its published widths, cut in depth only: 9 of its 16 MoE
# layers (3,982,137,344 parameters, 63.7 GB of training state at 16 B a
# parameter -- bf16 parameters and gradients, f32 master, m and v; 10
# layers, 70.4 GB, leave too little beside the logits and the MoE
# buffers), and 2 in the f32 gate (20.9 GB of state)
OLMOE_TRAIN_LAYERS = 9
OLMOE_GATE_LAYERS = 2
# (name, G, C, D, F, on the path, routed tokens): the expert products of
# olmoe's training step, 64 slots of C = 2560 (``a2a_capacities`` at 4 x
# 2048 tokens, top 8) -- gate/up (D 2048 -> F 1024) and down (1024 ->
# 2048) -- at the fills of 4 x 2048 tokens routed top-8 uniformly at
# random, and with every row live (None)
BWD_GMM_CASES = [
    ("train_gate_up_fill", 64, 2560, 2048, 1024, True, 8192),
    ("train_down_fill", 64, 2560, 1024, 2048, True, 8192),
    ("train_gate_up", 64, 2560, 2048, 1024, True, None),
    ("train_down", 64, 2560, 1024, 2048, True, None),
]
# olmoe's training attention (B, S, H, KV, hd, window): causal, 16 heads
# of 128, no GQA
OLMOE_BWD_ATTN_CASE = ("olmoe_train", 4, 2048, 16, 16, 128, 0, True)


def olmoe_config(layers: int, dtype: str = "bfloat16"):
    """olmoe-1b-7b with only its depth cut: ``layers`` of its 16 MoE
    layers."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import Segment
    return get_config("olmoe-1b-7b").with_(
        segments=(Segment("moe", layers),), dtype=dtype)


def check_gmm_bwd(case, dtype_name: str, seed: int) -> dict:
    """The grouped-matmul backward on its route (``moe_gmm.bwd_route``:
    ``tc`` in bf16, ``general`` in f32) against the plain backward
    (``grouped_matmul_aligned_bwd_ref``) and autograd of the plain forward
    at one of olmoe's training shapes with the case's fills (dx rows past
    a fill exact zeros); dx and dw bit-equal over two runs, the route
    asserted.  Timed: dx and dw apart and together (one backward call),
    each beside its bound (2 x live rows x D x F FLOPs at 989 or 165
    TFLOP/s, or its bytes: the live rows of x and dy and the live slots'
    weights read once, the outputs written once), the plain backward, and
    ``torch.bmm`` on the full buffers: dY W^T and X^T dY (``library_ms``,
    their sum).  In bf16 also the PR 23 kernels' bf16 instantiation
    (``moe_gmm_bwd.cu``, which the ``general`` route keeps for f32),
    called directly, as "before": dx, dw and both."""
    import torch
    from repro_torch.kernels import _build, moe_gmm, ops, ref
    name, G, C, D, F, _, tokens = case
    dtype = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    x, w, fills = gmm_inputs(case, dtype_name, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dy = torch.randn((G * C, F), generator=g, device=dev).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (x, w)]
    ref.grouped_matmul_aligned_ref(*leaves, C, fills).backward(dy)
    want = [t.grad for t in leaves]
    del leaves
    route = moe_gmm.bwd_route(dtype, D, F)
    ops.reset_launches()
    got = moe_gmm.grouped_matmul_bwd(x, w, dy, C, fills)
    again = moe_gmm.grouped_matmul_bwd(x, w, dy, C, fills)
    plain_out = ref.grouped_matmul_aligned_bwd_ref(x, w, dy, C, fills)
    torch.cuda.synchronize()
    routes = dict(ops.bwd_route_launches)
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    errs = {}
    for n, a, b, c in zip(("dx", "dw"), got, plain_out, want):
        errs[n] = grad_gap(a, b)
        errs[f"{n}_autograd"] = grad_gap(a, c)
    tol = GRAD_TOL[dtype_name]
    if (routes[f"gmm_{route}"] != 2 or sum(routes.values()) != 2
            or not repeat or max(errs.values()) > tol):
        raise AssertionError(f"grouped_matmul backward {name} {dtype_name}: "
                             f"{errs} past {tol}, routes {routes} (want 2 "
                             f"on {route}), or two runs differ (bit-equal: "
                             f"{repeat})")
    live_rows, live_slots = G * C, G
    if fills is not None:
        past = torch.arange(C, device=dev)[None, :] >= fills[:, None]
        if not bool((got[0].view(G, C, D)[past] == 0).all()):
            raise AssertionError(f"grouped_matmul backward {name} "
                                 f"{dtype_name}: dx rows past the fills "
                                 "are not exact zeros")
        live_rows = int(fills.sum())
        live_slots = int((fills > 0).sum())
    del got, again, plain_out, want
    esize = x.element_size()
    rate = BF16_FLOPS_PER_S if dtype_name == "bfloat16" else \
        F32_TC_FLOPS_PER_S
    flops = 2 * live_rows * D * F
    extra = 0 if fills is None else 4 * G
    terms = {"dx": esize * (live_rows * F + live_slots * D * F + G * C * D),
             "dw": esize * (live_rows * (D + F) + G * D * F)}
    bounds = {}
    for n, nbytes in terms.items():
        t_ops = flops / rate * 1e3
        t_bytes = (nbytes + extra) / HBM_BYTES_PER_S * 1e3
        bounds[n] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    xv, dyv = x.view(G, C, D), dy.view(G, C, F)

    def run():
        return moe_gmm.grouped_matmul_bwd(x, w, dy, C, fills)

    def run_dx():
        return moe_gmm.grouped_matmul_bwd(x, w, dy, C, fills, need_dw=False)

    def run_dw():
        return moe_gmm.grouped_matmul_bwd(x, w, dy, C, fills, need_dx=False)

    def plain():
        return ref.grouped_matmul_aligned_bwd_ref(x, w, dy, C, fills)

    def lib_dx():
        return torch.bmm(dyv, w.transpose(1, 2))

    def lib_dw():
        return torch.bmm(xv.transpose(1, 2), dyv)
    row = {"case": name, "dtype": dtype_name, "bwd_route": route,
           "shape": [G, C, D, F],
           "fill": fills is not None, "live_rows": live_rows,
           "live_slots": live_slots, "max_abs_err": max(errs.values()),
           "errs": errs, "tol": tol, "bit_equal": repeat,
           "ms": graph_ms(run, 3, 2), "dx_ms": graph_ms(run_dx, 3, 2),
           "dw_ms": graph_ms(run_dw, 3, 2), "call_ms": time_ms(run, 3),
           "bound_ms": bounds["dx"][0] + bounds["dw"][0],
           "dx_bound_ms": bounds["dx"][0], "dw_bound_ms": bounds["dw"][0],
           "bound_by": bounds["dx"][1], "flops_per_product": flops,
           "bytes": terms, "plain_ms": graph_ms(plain, 1, 2),
           "library_dx_ms": graph_ms(lib_dx, 3, 2),
           "library_dw_ms": graph_ms(lib_dw, 3, 2)}
    row["library_ms"] = row["library_dx_ms"] + row["library_dw_ms"]
    if route == "tc":
        old = _build.load("moe_gmm_bwd").repro_grouped_matmul_bwd
        dx, dw = torch.empty_like(x), torch.empty_like(w)
        fp = None if fills is None else fills.data_ptr()

        def before(need_dx=True, need_dw=True):
            err = old(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                      dx.data_ptr() if need_dx else None,
                      dw.data_ptr() if need_dw else None, fp, G, C, D, F, 1,
                      torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"moe_gmm_bwd.cu bf16: CUDA error {err}")
        row["before_ms"] = graph_ms(before, 3, 2)
        row["before_dx_ms"] = graph_ms(lambda: before(need_dw=False), 3, 2)
        row["before_dw_ms"] = graph_ms(lambda: before(need_dx=False), 3, 2)
    return row


class _IndexingF:
    """``torch.nn.functional`` with ``embedding`` as indexing,
    ``weight[idx]``: set as ``models.moe.F``, the dispatch's and the
    combine's gathers run as they did before they became embedding
    lookups."""

    def __getattr__(self, name):
        import torch.nn.functional
        return getattr(torch.nn.functional, name)

    @staticmethod
    def embedding(idx, weight, padding_idx=None):
        return weight[idx]


def check_gathers(slots, n_slots: int, capacity: int, seed: int) -> dict:
    """``moe.sort_dispatch`` and ``moe.combine_from_buffers`` whole, bf16,
    at one layer's routing of phase 14b (``slots``, (T, 8) experts; a
    slot's choices past ``capacity`` dropped, their number reported): with
    their gathers as embedding lookups, as the package runs them, and as
    indexing (``_IndexingF``).  The outputs bit-equal, the gradients within
    ``GRAD_TOL``; each function timed (eager, CUDA events) without and
    with its backward.  Indexing's backward sums the gradients that one
    row takes from many reads one after another: the dispatch's empty row
    (every empty buffer row), the combine's row 0 (every dropped
    choice)."""
    import torch
    from repro_torch.models import moe
    T, k = slots.shape
    D, dev = 2048, slots.device
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(*shape, rand=torch.randn):
        return rand(shape, generator=g, device=dev).bfloat16()
    keep = torch.ones_like(slots, dtype=torch.bool)
    xt, yout = draw(T, D), draw(n_slots * capacity, D)
    w = draw(T, k, rand=torch.rand)
    _, buf_of = moe.sort_dispatch(xt, slots, keep, n_slots, capacity)
    out = {"case": "gathers", "shape": [T, k, n_slots, capacity, D],
           "dropped": int((buf_of < 0).sum())}
    cases = {
        "dispatch": (lambda x: moe.sort_dispatch(
            x, slots, keep, n_slots, capacity)[0], xt,
            draw(n_slots, capacity, D)),
        "combine": (lambda y: moe.combine_from_buffers(y, buf_of, w), yout,
                    draw(T, D))}
    real = moe.F
    for case, (fn, inp, grad) in cases.items():
        res = {}
        for name, funcs in (("embedding", real), ("indexing", _IndexingF())):
            moe.F = funcs
            try:
                x = inp.clone().requires_grad_()
                y = fn(x)
                y.backward(grad)
                res[name] = (y.detach(), x.grad)
                with torch.no_grad():
                    out[f"{case}_{name}_fwd_ms"] = time_ms(lambda: fn(inp),
                                                           10)

                def both():
                    x.grad = None
                    fn(x).backward(grad)
                out[f"{case}_{name}_fwd_bwd_ms"] = time_ms(both, 3)
            finally:
                moe.F = real
        equal = torch.equal(res["embedding"][0], res["indexing"][0])
        gap = grad_gap(res["embedding"][1], res["indexing"][1])
        if not equal or gap > GRAD_TOL["bfloat16"]:
            raise AssertionError(f"{case}: outputs equal {equal}, gradient "
                                 f"off by {gap}")
        out[f"{case}_grad_gap"] = gap
    return out


def moe_train_phase() -> dict:
    """14a, 14b and 14c (see the module docstring)."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import batch_to, build_train_step
    out: dict = {"gmm_rows": [], "attn_rows": []}
    # 14a: the grouped-matmul backward at olmoe's training shapes, and the
    # attention backward at its head dim 128
    for i, case in enumerate(BWD_GMM_CASES):
        for dt in ("bfloat16", "float32"):
            out["gmm_rows"].append(check_gmm_bwd(case, dt, 600 + i))
            log("    " + json.dumps(out["gmm_rows"][-1]))
            torch.cuda.empty_cache()
    for dt in ("bfloat16", "float32"):
        out["attn_rows"].append(check_attention_bwd(OLMOE_BWD_ATTN_CASE, dt,
                                                    700))
        log("    " + json.dumps(out["attn_rows"][-1]))
        torch.cuda.empty_cache()

    # 14b: olmoe-1b-7b at full width, OLMOE_TRAIN_LAYERS of 16 layers; the
    # choices each layer dropped in the first step's forward (a slot's
    # past the capacity), and the MoE gathers at the routing of the layers
    # that dropped the fewest and the most
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    cfg = olmoe_config(OLMOE_TRAIN_LAYERS)
    out.update(train_steps(cfg, opt, "14b"))
    torch.cuda.empty_cache()
    routing = out.pop("routing")
    T, E = TRAIN_B * TRAIN_S, cfg.n_experts
    cap = moe.a2a_capacities(moe.round_robin_plan(E, 1), T, cfg.top_k)[0]
    out["dropped"] = [int((torch.bincount(r.flatten(), minlength=E) - cap)
                          .clamp(min=0).sum()) for r in routing]
    log(f"[14b] choices dropped per layer in the first step's forward, of "
        f"{T * cfg.top_k} (capacity {cap} a slot): {out['dropped']}")
    out["gathers"] = []
    for i in sorted({int(np.argmin(out["dropped"])),
                     int(np.argmax(out["dropped"]))}):
        out["gathers"].append(check_gathers(routing[i], E, cap, 800))
        out["gathers"][-1]["layer"] = i
        log("    " + json.dumps(out["gathers"][-1]))
        if out["gathers"][-1]["dropped"] != out["dropped"][i]:
            raise AssertionError(f"layer {i}: sort_dispatch dropped "
                                 f"{out['gathers'][-1]['dropped']} choices")
    del routing
    torch.cuda.empty_cache()

    # 14c: the f32 model at OLMOE_GATE_LAYERS layers, one backward through
    # the kernels and one through the plain versions, the plain run's
    # routers replaying the kernel run's choices (a near-tie would send a
    # token's gradient to another expert)
    cfg32 = olmoe_config(OLMOE_GATE_LAYERS, "float32")
    ts = build_train_step(cfg32, opt, device="cuda")
    state = ts.init_state(0)
    batch = batch_to(SyntheticTokenStream(
        cfg32, DataConfig(GATE_B, TRAIN_S, seed=0)).next_batch(), "cuda")
    gate: dict = {}
    logs: dict = {}
    for which in ("cuda", "ref"):
        ops.force(which)
        ops.reset_launches()
        try:
            with RouterLog(replay=logs.get("cuda")) as logs[which]:
                t0 = time.perf_counter()
                params, met = ts.grads(state, batch)
                torch.cuda.synchronize()
            gate[f"{which}_s"] = time.perf_counter() - t0
        finally:
            ops.force(None)
        gate[f"{which}_launches"] = {c: n for c, n in ops.launches.items()
                                     if n}
        gate[f"{which}_bwd_routes"] = {c: n for c, n in
                                       ops.bwd_route_launches.items() if n}
        gate[f"{which}_loss"] = float(met["loss"])
        if which == "cuda":
            grads_k = {n: p.grad.clone() for n, p in params.items()}
    gaps = {n: grad_gap(p.grad, grads_k[n]) for n, p in params.items()}
    rel_loss = abs(gate["cuda_loss"] - gate["ref_loss"]) / abs(
        gate["ref_loss"])
    worst = max(gaps, key=gaps.get)
    flips = logs["ref"].flips(logs["cuda"])
    gate.update(rel_loss=rel_loss, worst_leaf=worst, worst_gap=gaps[worst],
                router_calls=len(logs["cuda"].calls), router_flips=flips)
    want32 = expected_train_launches(cfg32)
    if gate["cuda_launches"] != {c: n for c, n in want32.items() if n}:
        raise AssertionError(f"f32 kernel path launched "
                             f"{gate['cuda_launches']}, expected {want32}")
    bwd32 = {c: n for c, n in expected_bwd_routes(cfg32).items() if n}
    if gate["cuda_bwd_routes"] != bwd32 or gate["ref_bwd_routes"]:
        raise AssertionError(f"f32 backward calls took routes "
                             f"{gate['cuda_bwd_routes']} (plain path: "
                             f"{gate['ref_bwd_routes']}), expected {bwd32}")
    if gate["ref_launches"]:
        raise AssertionError(f"plain path launched {gate['ref_launches']}")
    log(f"[14c] f32 {cfg32.name} at {cfg32.n_layers} layers, {GATE_B} x "
        f"{TRAIN_S} tokens, routing replayed: loss kernels "
        f"{gate['cuda_loss']!r}, plain {gate['ref_loss']!r} (relative gap "
        f"{rel_loss:.3g}); worst gradient leaf {worst}: {gaps[worst]:.3g} "
        f"of its largest |grad|; the plain routers would have flipped "
        f"{flips} choices over {len(logs['cuda'].calls)} calls; kernel "
        f"path {gate['cuda_s']:.3f} s, plain {gate['ref_s']:.3f} s; "
        f"launches {gate['cuda_launches']}")
    if not rel_loss <= 1e-5:
        raise AssertionError(f"f32 losses differ by {rel_loss}")
    if not gaps[worst] <= GRAD_TOL["float32"]:
        raise AssertionError(f"f32 gradient {worst} off by {gaps[worst]}")
    out["gate"] = {k: (sig(v) if isinstance(v, float) else v)
                   for k, v in gate.items()}
    del ts, state, params, grads_k, logs
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------- 15. training deepseek-v3
# deepseek-v3-671b at its published widths, cut in depth to DS_TRAIN_DENSE
# of its 3 dense MLA layers and its MTP block (depth 1): two MLA blocks,
# 3,141,513,216 parameters by ``param_count`` (about 18 M high: it prices
# the MTP block's attention as GQA), 50.3 GB of training state at 16 B a
# parameter.  Its MoE layers hold 11.27 B parameters each (256 experts x 3
# x 7168 x 2048), 180 GB of state: they train only across cards.  Beside
# the state a bf16 step holds the main head's and the MTP head's f32
# logits (4.24 GB each at 4 x 2048 tokens) and ``logits_fn``'s f32 copy of
# the head for each (3.7 GB); a second dense layer (59.6 GB of state)
# would leave too little.  The f32 gate takes the same cut at DS_GATE_B x
# 2048 tokens without AdamW's state: its f32 parameters (12.6 GB), two
# gradient sets and the plain attention's f32 scores (2.1 GB per prompt
# and tensor) fit, the state (master, m and v, 37.7 GB more) beside them
# would not, so no AdamW step is compared there.
DS_TRAIN_DENSE = 1
DS_GATE_B = 1
# deepseek's training attention (B, S, H, KV, (hd, hd_v), window): MLA's
# call, causal, 128 heads; the plain versions one prompt a call
DS_BWD_ATTN_CASE = ("deepseek_train", 4, 2048, 128, 128, (192, 128), 0,
                    True)


def deepseek_train_config(dense: int, dtype: str = "bfloat16"):
    """deepseek-v3-671b with only its depth cut: ``dense`` of its 3 dense
    MLA layers and no MoE layer; the MTP block as published."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import Segment
    return get_config("deepseek-v3-671b").with_(
        segments=(Segment("dense", dense, attn="mla"),), dtype=dtype)


def deepseek_gate(cfg32, B: int) -> dict:
    """The f32 model of ``cfg32`` (no optimizer state), one loss and
    backward through the kernels and one through the plain versions on
    the same ``B`` x ``TRAIN_S`` tokens: losses within 1e-5 relative,
    every leaf within ``GRAD_TOL`` f32 of its largest entry (the worst
    reported), every backward call on ``general``, the launches as
    ``expected_train_launches`` says, none on the plain path."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.train.step import batch_to
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = Model(cfg32, device="cuda", generator=gen).requires_grad_(True)
    params = dict(model.named_parameters())
    batch = batch_to(SyntheticTokenStream(
        cfg32, DataConfig(B, TRAIN_S, seed=0)).next_batch(), "cuda")
    gate: dict = {}
    grads: dict = {}
    torch.cuda.reset_peak_memory_stats()
    for which in ("cuda", "ref"):
        ops.force(which)
        ops.reset_launches()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, met = model.loss(batch)
            loss.backward()
            torch.cuda.synchronize()
            gate[f"{which}_s"] = time.perf_counter() - t0
        finally:
            ops.force(None)
        gate[f"{which}_launches"] = {c: n for c, n in ops.launches.items()
                                     if n}
        gate[f"{which}_bwd_routes"] = {c: n for c, n in
                                       ops.bwd_route_launches.items() if n}
        gate[f"{which}_loss"] = float(met["loss"].detach())
        grads[which] = {n: p.grad if p.grad is not None
                        else torch.zeros_like(p) for n, p in params.items()}
        for p in params.values():
            p.grad = None
        del loss, met
    gate["peak_B"] = torch.cuda.max_memory_allocated()
    gaps = {n: grad_gap(grads["cuda"][n], grads["ref"][n]) for n in params}
    del grads, model, params
    rel_loss = abs(gate["cuda_loss"] - gate["ref_loss"]) / abs(
        gate["ref_loss"])
    worst = max(gaps, key=gaps.get)
    gate.update(rel_loss=rel_loss, worst_leaf=worst, worst_gap=gaps[worst],
                leaves=len(gaps), tokens=[B, TRAIN_S],
                adamw_compared=False)
    want32 = {c: n for c, n in expected_train_launches(cfg32).items() if n}
    if gate["cuda_launches"] != want32:
        raise AssertionError(f"f32 kernel path launched "
                             f"{gate['cuda_launches']}, expected {want32}")
    bwd32 = {c: n for c, n in expected_bwd_routes(cfg32).items() if n}
    if gate["cuda_bwd_routes"] != bwd32 or gate["ref_bwd_routes"]:
        raise AssertionError(f"f32 backward calls took routes "
                             f"{gate['cuda_bwd_routes']} (plain path: "
                             f"{gate['ref_bwd_routes']}), expected {bwd32}")
    if gate["ref_launches"]:
        raise AssertionError(f"plain path launched {gate['ref_launches']}")
    log(f"[15c] f32 {cfg32.name} cut ({cfg32.n_layers} dense MLA layer(s) "
        f"+ MTP), {B} x {TRAIN_S} tokens, no optimizer state: loss kernels "
        f"{gate['cuda_loss']!r}, plain {gate['ref_loss']!r} (relative gap "
        f"{rel_loss:.3g}); worst of {len(gaps)} gradient leaves {worst}: "
        f"{gaps[worst]:.3g} of its largest |grad|; kernel path "
        f"{gate['cuda_s']:.3f} s, plain {gate['ref_s']:.3f} s; launches "
        f"{gate['cuda_launches']}, backward routes "
        f"{gate['cuda_bwd_routes']}; max_memory_allocated "
        f"{gate['peak_B']} B")
    if not rel_loss <= 1e-5:
        raise AssertionError(f"f32 losses differ by {rel_loss}")
    if not gaps[worst] <= GRAD_TOL["float32"]:
        raise AssertionError(f"f32 gradient {worst} off by {gaps[worst]}")
    torch.cuda.empty_cache()
    return {k: (sig(v) if isinstance(v, float) else v)
            for k, v in gate.items()}


def deepseek_train_phase() -> dict:
    """15a, 15b and 15c (see the module docstring)."""
    import torch
    from repro_torch.optim.adamw import AdamWConfig
    out: dict = {"attn_rows": []}
    # 15a: the attention backward at deepseek's training call, (192, 128)
    for dt in ("bfloat16", "float32"):
        out["attn_rows"].append(check_attention_bwd(DS_BWD_ATTN_CASE, dt,
                                                    900, ref_batch=1))
        log("    " + json.dumps(out["attn_rows"][-1]))
        torch.cuda.empty_cache()
    # 15b: the cut at its published widths, five bf16 steps
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    out.update(train_steps(deepseek_train_config(DS_TRAIN_DENSE), opt,
                           "15b"))
    torch.cuda.empty_cache()
    # 15c: the f32 gate
    out["gate"] = deepseek_gate(
        deepseek_train_config(DS_TRAIN_DENSE, "float32"), DS_GATE_B)
    return out


# ------------------------------------------- 16. training hubert-xlarge
# hubert-xlarge (arXiv:2106.07447) at full width and depth: 48 non-causal
# layers of 16 heads of 80, d_model 1280, d_ff 5120, 504 frame classes;
# 1,259,705,600 parameters, 20.2 GB of training state at 16 B a parameter.
# A step takes phase 10's traffic, 8 clips of 1500 frames (30 s at 50
# frames/s) and their frame labels, drawn with numpy (``FrameStream``);
# the f32 gate 2 clips (5.0 GB of f32 parameters, AdamW's state beside)
HUBERT_TRAIN_B, HUBERT_TRAIN_S = 8, 1500
HUBERT_GATE_B = 2
# hubert's training attention: 8 clips of 1500 frames, 16/16 heads of 80,
# non-causal, every (query, key) pair live
HUBERT_BWD_ATTN_CASE = ("hubert_train", 8, 1500, 16, 16, 80, 0, False)


def hubert_train_phase() -> dict:
    """16a, 16b and 16c (see the module docstring)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import batch_to
    out: dict = {"attn_rows": []}
    # 16a: the attention backward at hubert's training call, (80, 80)
    for dt in ("bfloat16", "float32"):
        out["attn_rows"].append(check_attention_bwd(HUBERT_BWD_ATTN_CASE, dt,
                                                    1000))
        log("    " + json.dumps(out["attn_rows"][-1]))
        torch.cuda.empty_cache()
    # 16b: full width and depth, five bf16 steps
    cfg = get_config("hubert-xlarge")
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    out.update(train_steps(cfg, opt, "16b", FrameStream(
        cfg, HUBERT_TRAIN_B, HUBERT_TRAIN_S, seed=16)))
    torch.cuda.empty_cache()
    # 16c: the f32 gate at full depth
    cfg32 = cfg.with_(dtype="float32")
    out["gate"] = adamw_gate(cfg32, opt, batch_to(FrameStream(
        cfg32, HUBERT_GATE_B, HUBERT_TRAIN_S, seed=17).next_batch(), "cuda"),
        "16c")
    return out


# ----------------------------------------------------------- 17. tools
# the card's memory less the margin under which 17c trains a config with
# remat "none" (its dry-run peak must be below it)
NONE_PEAK_LIMIT_B = 72e9
CARD_MEMORY_B = 80e9
REMAT_POLICIES = ("full", "dots", "none")


def dryrun_cells() -> dict:
    """The dry runs of phase 17 by key (arch, remat): the four training
    cells of 13b-16b at their shapes (remat "full", as trained), and
    hymba's and hubert's under "dots" and "none" (17c); each
    ``launch.dryrun.run_cell``'s dict.  Runs in a spawned process on the
    CPU alone, beside the card's phases."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch.dryrun import run_cell
    out = {}
    for arch, B, S, overrides in dryrun_train_cells():
        for remat in REMAT_POLICIES:
            if remat != "full" and arch not in ("hymba-1.5b",
                                                "hubert-xlarge"):
                continue
            shape = Shape(f"smoke_train_{B}x{S}", S, B, "train")
            out[f"{arch}/{remat}"] = run_cell(
                arch, shape, overrides={**overrides, "remat": remat})
    out["deepseek-7b/tp"] = tp_dryrun_cell()
    out["smollm-135m/seq"] = seq_dryrun_cell()
    out.update(falcon_dryrun_cells())
    return out


def tp_dryrun_cell() -> dict:
    """Phase 19b's training step as rank 0 of a (1, 2) mesh on the meta
    device (``launch.dryrun``, over a fake process group of two)."""
    import torch.distributed as dist
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch.dryrun import fake_mesh, run_cell
    try:
        return run_cell("deepseek-7b", Shape(
            f"smoke_train_{DS7_B}x{DS7_S}", DS7_S, DS7_B, "train"),
            overrides={"segments": ds7_config(DS7_LAYERS).segments},
            mesh=fake_mesh((1, 2)))
    finally:
        dist.destroy_process_group()


def seq_dryrun_cell() -> dict:
    """Phase 20b's training step as rank 0 of a (1, 2) mesh on the meta
    device: smollm-135m's ``dp_seq`` step on its block of the sequence
    (``launch.dryrun --mesh 1x2``)."""
    import torch.distributed as dist
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch.dryrun import fake_mesh, run_cell
    try:
        return run_cell("smollm-135m", Shape(
            f"smoke_train_{SEQ_B}x{SEQ_S}", SEQ_S, SEQ_B, "train"),
            mesh=fake_mesh((1, 2)))
    finally:
        dist.destroy_process_group()


def dryrun_train_cells() -> list:
    """(arch, B, S, config overrides) of the training runs of 13b-16b."""
    return [("hymba-1.5b", TRAIN_B, TRAIN_S, {}),
            ("olmoe-1b-7b", TRAIN_B, TRAIN_S,
             {"segments": olmoe_config(OLMOE_TRAIN_LAYERS).segments}),
            ("deepseek-v3-671b", TRAIN_B, TRAIN_S,
             {"segments": deepseek_train_config(DS_TRAIN_DENSE).segments}),
            ("hubert-xlarge", HUBERT_TRAIN_B, HUBERT_TRAIN_S, {})]


def _cpu_only() -> None:
    """The dry-run process's initializer: no card for it."""
    import os
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def dryrun_phase(dry: dict, trained: dict) -> dict:
    """17a: the dry run of each training cell of 13b-16b against the card:
    its parameters (the model's leaves) and its training state's bytes
    (parameters, f32 master, m, v) equal to the live state's exactly (a
    gate); its predicted peak beside the measured ``max_memory_allocated``
    and its counted FLOPs (PyTorch's products and the kernels' bounds)
    beside ``step_cost``'s, as ratios."""
    rows = {}
    for arch, B, S, _ in dryrun_train_cells():
        r, live = dry[f"{arch}/full"], trained[arch]
        if r["status"] != "ok":
            raise AssertionError(f"17a {arch}: dry run {r['status']}: "
                                 f"{r.get('error', r.get('reason'))}")
        if (r["leaves"], r["state_bytes"]) != (live["n_params"],
                                               live["state_B"]):
            raise AssertionError(
                f"17a {arch}: dry run {r['leaves']} parameters, "
                f"{r['state_bytes']} B of state; the card trained "
                f"{live['n_params']}, {live['state_B']} B")
        row = {"B": B, "S": S, "leaves": r["leaves"],
               "state_B": r["state_bytes"],
               "peak_pred_B": r["memory"]["peak_bytes"],
               "peak_B": live["peak_B"],
               "peak_ratio": sig(r["memory"]["peak_bytes"] / live["peak_B"]),
               "flops": r["cost"]["flops"],
               "kernel_flops": r["kernel_flops"],
               "step_cost_flops": r["step_cost"]["flops"],
               "flops_ratio": sig(r["cost"]["flops"]
                                  / r["step_cost"]["flops"]),
               "kernel_calls": r["kernel_calls"],
               "dry_s": r["seconds"]}
        log(f"[17a] {arch} ({B} x {S}, remat full): dry run on meta in "
            f"{r['seconds']} s: {r['leaves']} parameters and "
            f"{r['state_bytes']} B of state, equal to the card's; peak "
            f"predicted {row['peak_pred_B']} B, measured {live['peak_B']} "
            f"B (ratio {row['peak_ratio']}); counted FLOPs "
            f"{row['flops']:.6g} ({row['kernel_flops']:.6g} in the "
            f"kernels), step_cost's {row['step_cost_flops']:.6g} (ratio "
            f"{row['flops_ratio']}); kernel calls {r['kernel_calls']}")
        rows[arch] = row
    return rows


def roofline_row(tag: str, cfg, B: int, S: int, K: int, kind: str,
                 seconds: float) -> dict:
    """``step_cost``'s roofline terms at dp = tp = 1 on the H100's
    constants beside the measured ``seconds`` of a step, prefill, forward
    or decode step: ``mfu`` = model FLOPs / (peak x seconds),
    ``roofline_fraction`` as ``roofline_terms`` gives it (the model FLOP
    rate at the bottleneck's time over the peak) and ``of_bound`` = the
    larger of the compute and memory seconds over the measured ones."""
    from repro_torch.roofline import PEAK_FLOPS, roofline_terms
    t = roofline_terms(cfg, B, S, K, 1, 1, kind)
    row = {"B": B, "S": S, "K": K, "kind": kind,
           "compute_s": sig(t["compute_s"]), "memory_s": sig(t["memory_s"]),
           "bottleneck": t["bottleneck"], "seconds": seconds,
           "model_flops": t["model_flops"],
           "mfu": sig(t["model_flops"] / (PEAK_FLOPS * seconds)),
           "roofline_fraction": sig(t["roofline_fraction"]),
           "of_bound": sig(max(t["compute_s"], t["memory_s"]) / seconds)}
    log(f"[17b] {tag} {cfg.name} {kind} {B} x {S} (K {K}): compute "
        f"{row['compute_s']} s, memory {row['memory_s']} s, bottleneck "
        f"{row['bottleneck']}; measured {seconds} s; mfu {row['mfu']}, "
        f"roofline fraction {row['roofline_fraction']}, bound over "
        f"measured {row['of_bound']}")
    return row


def roofline_phase(summary: dict, trained: dict) -> dict:
    """17b: every training step (13b-16b) and serving run (6, 7, 11, 12;
    hubert's forward in 10) against ``step_cost``'s roofline."""
    from repro_torch.configs import get_config
    cfgs = {"hymba-1.5b": get_config("hymba-1.5b"),
            "olmoe-1b-7b": olmoe_config(OLMOE_TRAIN_LAYERS),
            "deepseek-v3-671b": deepseek_train_config(DS_TRAIN_DENSE),
            "hubert-xlarge": get_config("hubert-xlarge")}
    rows = {}
    for arch, B, S, _ in dryrun_train_cells():
        rows[f"train/{arch}"] = roofline_row(
            "train", cfgs[arch], B, S, S, "train",
            trained[arch]["median_step_s"])
    G = 32
    for tag, cfg in (("p6", get_config("hymba-1.5b")),
                     ("p7", get_config("olmoe-1b-7b")),
                     ("p11", deepseek_config(*DS_SERVE_DEPTH)),
                     ("p12", get_config("llama-3.2-vision-11b"))):
        run = summary[tag]
        rows[f"{tag}/prefill"] = roofline_row(tag, cfg, 4, 2048, 2048,
                                              "prefill", run["prefill_s"])
        rows[f"{tag}/decode"] = roofline_row(
            tag, cfg, 4, 1, 2048 + G, "decode",
            sig(run["ms_per_token"] / 1e3))
    p10 = summary["p10"]
    rows["p10/forward"] = roofline_row("p10", cfgs["hubert-xlarge"],
                                       p10["B"], p10["S"], p10["S"],
                                       "prefill", p10["forward_s"])
    return rows


def grads_full_vs_dots(cfg, batch: dict) -> dict:
    """One step's gradients of ``cfg``'s bf16 model from seed 0 on
    ``batch``, remat "dots" then "full" on the same weights: every leaf
    within ``GRAD_TOL`` bf16 of "full"'s largest entry (the worst
    reported), the losses equal, and whether every leaf came out
    bit-equal."""
    import torch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import build_train_step
    ts = build_train_step(cfg.with_(remat="dots"), AdamWConfig(),
                          device="cuda")
    state = ts.init_state(0)
    params, met = ts.grads(state, batch)
    dots = {n: p.grad.clone() for n, p in params.items()}
    loss_dots = float(met["loss"])
    ts.model.cfg = ts.cfg = cfg.with_(remat="full")
    params, met = ts.grads(state, batch)
    gaps = {n: grad_gap(dots[n], p.grad) for n, p in params.items()}
    equal = all(torch.equal(dots[n], p.grad) for n, p in params.items())
    worst = max(gaps, key=gaps.get)
    out = {"loss_dots": loss_dots, "loss_full": float(met["loss"]),
           "worst_leaf": worst, "worst_gap": gaps[worst],
           "bit_equal": equal}
    del ts, state, params, dots
    torch.cuda.empty_cache()
    if out["loss_dots"] != out["loss_full"]:
        raise AssertionError(f"remat dots vs full: losses {out}")
    if not gaps[worst] <= GRAD_TOL["bfloat16"]:
        raise AssertionError(f"remat dots vs full: gradient {worst} off "
                             f"by {gaps[worst]}")
    return out


def remat_phase(dry: dict, trained: dict) -> dict:
    """17c: hymba-1.5b and hubert-xlarge train ``TRAIN_STEPS`` bf16 steps
    each under remat "dots" (``train_steps``) on 13b's and 16b's batches:
    the launches of each step and the backward routes equal "full"'s (the
    recompute re-launches the forward kernels), losses finite, step 1's
    loss equal to "full"'s (the forward is unchanged), and one step's
    gradients within ``GRAD_TOL`` of "full"'s (``grads_full_vs_dots``);
    seconds, tokens (frames) a second and peak beside "full"'s,
    ``plan_remat``'s decision for a budget of the card's memory less the
    state, and the dry run's peak under each policy.  remat "none" trains
    only where its dry-run peak is below ``NONE_PEAK_LIMIT_B``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.placement import plan_remat
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import batch_to
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    out = {}
    for arch, B, S, _ in dryrun_train_cells():
        if arch not in ("hymba-1.5b", "hubert-xlarge"):
            continue
        cfg = get_config(arch)

        def stream(c):
            if c.frame_input:
                return FrameStream(c, B, S, seed=16)
            return SyntheticTokenStream(c, DataConfig(B, S, seed=0))
        full = trained[arch]
        pred = {r: dry[f"{arch}/{r}"]["memory"]["peak_bytes"]
                for r in REMAT_POLICIES}
        plan = plan_remat(cfg, B, S, 1, 1,
                          hbm_budget_bytes=CARD_MEMORY_B - full["state_B"])
        row = {"predicted_peak_B": pred, "plan_remat": {
            "policy": plan.policy, "recompute_s": sig(plan.recompute_seconds),
            "save_s": sig(plan.save_seconds), "save_B": plan.save_bytes,
            "fits_budget": plan.fits_budget},
            "full": {k: full[k] for k in ("median_step_s", "tokens_per_s",
                                          "peak_B")}}
        for remat in ("dots", "none"):
            if remat == "none" and pred["none"] >= NONE_PEAK_LIMIT_B:
                row["none"] = "not run: predicted peak " \
                    f"{pred['none']} B >= {NONE_PEAK_LIMIT_B:.0f} B"
                log(f"[17c] {arch} remat none {row['none']}")
                continue
            c = cfg.with_(remat=remat)
            r = train_steps(c, opt, f"17c {arch} {remat}", stream(c),
                            split=False)
            torch.cuda.empty_cache()
            if remat == "dots" and (
                    r["per_step_launches"] != full["per_step_launches"]
                    or r["bwd_routes"] != full["bwd_routes"]):
                raise AssertionError(
                    f"17c {arch} dots launched {r['per_step_launches']}, "
                    f"backward {r['bwd_routes']}; full "
                    f"{full['per_step_launches']}, {full['bwd_routes']}")
            if r["loss0"] != full["loss0"]:
                raise AssertionError(f"17c {arch} {remat}: step 1's loss "
                                     f"{r['loss0']!r}, full's "
                                     f"{full['loss0']!r}")
            row[remat] = {k: r[k] for k in ("median_step_s", "tokens_per_s",
                                            "peak_B", "losses",
                                            "per_step_launches")}
        row["grads"] = grads_full_vs_dots(cfg, batch_to(
            stream(cfg).next_batch(), "cuda"))
        log(f"[17c] {arch}: remat dots {row['dots']['median_step_s']} s a "
            f"step ({row['dots']['tokens_per_s']} a second), peak "
            f"{row['dots']['peak_B']} B; full {full['median_step_s']} s, "
            f"peak {full['peak_B']} B; dry-run peaks {pred}; plan_remat "
            f"(budget {CARD_MEMORY_B:.0f} B less {full['state_B']} B of "
            f"state): {row['plan_remat']}; gradients dots vs full: "
            f"{row['grads']}")
        out[arch] = row
    return out


# phase 18: distribution.  The plans' capacity factors: serving's (both
# plans of the f32 gate and the bf16 run) leaves the replicated plan's
# buffers room for every choice in practice; training's, at two shards of
# olmoe (64 experts, top 8) under the round robin, makes every buffer as
# large as the most it can receive (cap_send = k T_loc, cap_local = cap_in
# = T_loc), so the meshes' losses are the one card's
MESH_SERVE_CF = 8.0
MESH_TRAIN_CF = 4.0
MESH_GATE_LAYERS = 2
MESH_FORCED = 3                  # teacher-forced decode steps of the gates
# 18c trains one layer: it writes the f32 state three times (the writer's
# checkpoint and each resume's last), 50 GB at two layers (16.7 GB each),
# 30 GB at one
ELASTIC_LAYERS = 1
ELASTIC_B, ELASTIC_S = 2, 512
ELASTIC_STEPS = (4, 6)           # the writer's steps, the resumes' end
ELASTIC_TOL = 1e-4               # tests/test_torch_train.py's three steps
MESH_TIMEOUT = 900
# the kernels of phase 18b's path, by kernel-line entry, and their routes
MESH_KERNELS = {"flash_attention:prefill_tc": "prefill_tc",
                "flash_attention:decode_split": "decode_split",
                "grouped_matmul:gmm_tc": "gmm_tc",
                "grouped_matmul:gmv": "gmv"}


def gate_logits(model, prompts, forced, max_len: int):
    """Prefill logits and those of the teacher-forced decode steps, on the
    kernels, and the collectives of the prefill
    (``roofline.hlo.CollectiveCounter``)."""
    import torch
    from repro_torch.roofline.hlo import CollectiveCounter
    S = prompts.shape[1]
    cc = CollectiveCounter()
    with torch.inference_mode():
        with cc:
            logits, caches = model.prefill({"tokens": prompts}, max_len)
        out = [logits]
        for i in range(forced.shape[1]):
            logits, caches = model.decode_step(forced[:, i:i + 1], caches,
                                               S + i)
            out.append(logits)
    torch.cuda.synchronize()
    return torch.cat(out, dim=1), cc.result()


def mesh_rank_18a(rank: int, B: int, S: int, G: int) -> dict:
    """18a, the one rank of a (1, 1) mesh over NCCL: olmoe-1b-7b served
    (B x S prompts, G new tokens) and three bf16 training steps at
    MESH_GATE_LAYERS layers, and the f32 model at those layers' logits,
    each without a mesh and through the mesh path; every collective of the
    mesh runs goes to a group of one.  The f32 logits without a mesh are
    taken twice, to show that the path repeats itself bit for bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import make_model, make_prompts, serve
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import sharding as shd
    from repro_torch.roofline.hlo import CollectiveCounter
    from repro_torch.train.step import batch_to, build_train_step
    t0 = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    cfg = get_config("olmoe-1b-7b")
    runs: dict = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        cc = CollectiveCounter()
        with shd.use_mesh(m), cc:
            r = serve(cfg, B, S, G, device="cuda", seed=0)
        runs[name] = (r.tokens, r.prefill_logits, cc.result()["counts"])
        torch.cuda.empty_cache()
    out = {"serve_tokens_equal": bool(np.array_equal(runs["plain"][0],
                                                     runs["mesh"][0])),
           "serve_prefill_equal": bool(np.array_equal(runs["plain"][1],
                                                      runs["mesh"][1])),
           "serve_collectives": runs["mesh"][2]}
    prompts = torch.from_numpy(make_prompts(cfg, B, S)).cuda()
    forced = torch.from_numpy(runs["plain"][0][:, :MESH_FORCED]).cuda()
    cfg32 = olmoe_config(MESH_GATE_LAYERS, "float32")
    lg = {}
    for name, m in (("plain", None), ("again", None), ("mesh", mesh)):
        with shd.use_mesh(m):
            model = make_model(cfg32, device="cuda", seed=0)
            if m is not None:
                model.gather_dense_()
                model.place_slots_(model.plan)
            lg[name] = gate_logits(model, prompts, forced,
                                   S + MESH_FORCED + 1)[0]
        del model
        torch.cuda.empty_cache()
    out["f32_equal"] = bool(torch.equal(lg["plain"], lg["mesh"]))
    out["f32_repeats"] = bool(torch.equal(lg["plain"], lg["again"]))
    cfg16 = olmoe_config(MESH_GATE_LAYERS)
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=3)
    losses = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        ts = build_train_step(cfg16, opt, mesh=m, device="cuda")
        state = ts.init_state(0)
        stream = SyntheticTokenStream(cfg16, DataConfig(TRAIN_B, TRAIN_S))
        cc = CollectiveCounter()
        with cc:
            losses[name] = [float(ts.step_fn(state, ts.local_batch(batch_to(
                stream.next_batch(), "cuda")))[1]["loss"]) for _ in range(3)]
        if m is not None:
            out["train_collectives"] = cc.result()["counts"]
        del ts, state
        torch.cuda.empty_cache()
    out["losses"] = losses["mesh"]
    out["losses_equal"] = losses["plain"] == losses["mesh"]
    out["s"] = time.perf_counter() - t0
    return out


def mesh_rank_18b(rank: int, B: int, S: int, G: int, ref: dict) -> dict:
    """18b, one of two ranks of a (1, 2) mesh sharing the card over gloo:
    olmoe-1b-7b at full width and depth in bf16, the replicated placement
    planned for two shards from the router trace and adopted (prefill on
    ``moe_a2a``, decode on ``moe_tp``); then the f32 model at
    MESH_GATE_LAYERS layers under the replicated plan and under the round
    robin against the one card's logits (``ref``), with the all_to_all
    bytes of each plan's prefill."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import make_model, make_prompts, serve
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as shd
    mesh = make_mesh((1, 2), ("data", "model"), device="cuda")
    cfg = get_config("olmoe-1b-7b")
    torch.cuda.reset_peak_memory_stats()
    with shd.use_mesh(mesh):
        r = serve(cfg, B, S, G, device="cuda", seed=0,
                  placement="replicated", capacity_factor=MESH_SERVE_CF)
    out = {"peak_B": torch.cuda.max_memory_allocated(),
           "weight_B": r.weight_bytes, "prefill_s": r.prefill_s,
           "ms_per_token": r.ms_per_token, "launches": r.launches,
           "attn_routes": dict(ops.route_launches),
           "gmm_routes": dict(ops.gmm_route_launches),
           "a2a_B_per_layer": r.a2a_bytes,
           "placement_s": r.placement["seconds"],
           "local_fraction": r.placement["local_fraction_repl"],
           "slot_experts": r.placement["plan"].slot_expert,
           "tokens_equal_share": float((r.tokens == ref["tokens"]).mean()),
           "bf16_logit_gap": float(np.abs(r.prefill_logits
                                          - ref["logits"]).max()
                                   / np.abs(ref["logits"]).max())}
    torch.cuda.empty_cache()
    cfg32 = olmoe_config(MESH_GATE_LAYERS, "float32")
    prompts = torch.from_numpy(make_prompts(cfg, B, S)).cuda()
    forced = torch.from_numpy(ref["tokens"][:, :MESH_FORCED]).cuda()
    want = torch.from_numpy(ref["f32"]).cuda()
    plans = {"replicated": dataclasses.replace(
        r.placement["plan"], capacity_factor=MESH_SERVE_CF),
        "round_robin": moe.round_robin_plan(cfg.n_experts, 2,
                                            MESH_SERVE_CF)}
    T_loc = B * S // 2
    for name, plan in plans.items():
        with shd.use_mesh(mesh):
            model = make_model(cfg32, device="cuda", seed=0)
            model.gather_dense_()
            model.place_slots_(plan)
            lg, coll = gate_logits(model, prompts, forced,
                                   S + MESH_FORCED + 1)
        del model
        torch.cuda.empty_cache()
        gap, scale = (float((lg - want).abs().max()),
                      float(want.abs().max()))
        a2a = moe.a2a_bytes(plan, T_loc, cfg.top_k, cfg.d_model, 4)
        # gloo's CUDA all-gathers (the MoE output along the sequence) run
        # as all_to_alls: then the counter's all-to-all bytes hold them too
        gathered = (0 if coll["counts"]["all-gather"]
                    else B * S * cfg.d_model * 4)
        counted = coll["per_kind_bytes"]["all-to-all"] / MESH_GATE_LAYERS
        out[name] = {"f32_gap": gap / scale, "f32_ok": gap <= F32_LOGIT_TOL
                     * scale, "local_fraction": plan.local_fraction,
                     "a2a_B_per_layer": a2a,
                     "a2a_counted_B_per_layer": counted,
                     "a2a_counted_ok": counted == a2a["sent"]
                     + a2a["returned"] + gathered,
                     "collectives": coll["counts"]}
    return out


def elastic_rank(rank: int, shape: tuple, steps: int, ckpt_dir: str
                 ) -> dict:
    """18c: one rank of a ``shape`` mesh training the f32 olmoe-1b-7b at
    ELASTIC_LAYERS layers (``Trainer``: restored from ``ckpt_dir``'s
    latest checkpoint, if any, and checkpointing at step 4 and at its
    end)."""
    import torch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    mesh = make_mesh(shape, ("data", "model"), device="cuda")
    tr = Trainer(olmoe_config(ELASTIC_LAYERS, "float32"),
                 DataConfig(ELASTIC_B, ELASTIC_S),
                 TrainerConfig(steps=steps, ckpt_every=ELASTIC_STEPS[0],
                               ckpt_dir=ckpt_dir, keep=1, log_every=100),
                 AdamWConfig(lr=3e-4, warmup_steps=1,
                             total_steps=ELASTIC_STEPS[1]),
                 device="cuda", mesh=mesh, capacity_factor=MESH_TRAIN_CF)
    t0 = time.perf_counter()
    _, hist = tr.run()
    return {"hist": [(h["step"], h["loss"], h["seconds"]) for h in hist],
            "s": time.perf_counter() - t0,
            "peak_B": torch.cuda.max_memory_allocated()}


def elastic_reference() -> list:
    """18c's uninterrupted run: ELASTIC_STEPS[1] steps on one card without
    a mesh, the Trainer's batches and state."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
    from repro_torch.models import moe
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import batch_to, build_train_step
    cfg = olmoe_config(ELASTIC_LAYERS, "float32")
    ts = build_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=1,
                                           total_steps=ELASTIC_STEPS[1]),
                          plan=moe.round_robin_plan(cfg.n_experts, 1,
                                                    MESH_TRAIN_CF),
                          device="cuda")
    state = ts.init_state(0)
    stream = SyntheticTokenStream(cfg, DataConfig(ELASTIC_B, ELASTIC_S))
    losses = []
    for _ in range(ELASTIC_STEPS[1]):
        state, m = ts.step_fn(state, batch_to(stream.next_batch(), "cuda"))
        losses.append(float(m["loss"]))
    del ts, state
    torch.cuda.empty_cache()
    return losses


def mesh_phase(B: int, S: int, G: int) -> dict:
    """Phase 18: 18a, 18b and 18c (see the module docstring), each world
    in processes of its own (``launch.mesh.run_ranks``), at phase 7's
    serve run (B prompts of S tokens, G new each)."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.serve import make_model, make_prompts, serve
    from repro_torch.models import moe
    out: dict = {"transport": {"18a": "nccl", "18b": "gloo",
                               "18c": "gloo (one rank: nccl)"}}
    torch.cuda.empty_cache()
    # 18a beside 18c's writer and the uninterrupted run, then 18c's two
    # resumes at once (each world spends its first step's ≈ 12 s warming
    # up, and each resume writes its last checkpoint).  18a's results are
    # bit-equalities, which the overlap cannot change; the three worlds
    # hold ≈ 60 GB of the card together
    t = time.perf_counter()
    base = ROOT / "build" / "smoke_elastic"
    shutil.rmtree(base, ignore_errors=True)
    write = base / "write"
    step4 = f"step_{ELASTIC_STEPS[0]:08d}"

    def resume(shape):
        d = base / f"resume_{shape[0]}x{shape[1]}"
        d.mkdir(parents=True)
        (d / step4).symlink_to(write / step4)    # the writer's checkpoint
        return run_ranks(
            elastic_rank, shape[0] * shape[1], shape, ELASTIC_STEPS[1],
            str(d), backend="gloo" if shape[0] * shape[1] > 1 else "nccl",
            device="cuda", timeout=MESH_TIMEOUT)

    with ThreadPoolExecutor(3) as pool:
        af = pool.submit(run_ranks, mesh_rank_18a, 1, B, S, G,
                         backend="nccl", device="cuda", timeout=MESH_TIMEOUT)
        wf = pool.submit(run_ranks, elastic_rank, 2, (1, 2),
                         ELASTIC_STEPS[0], str(write), backend="gloo",
                         device="cuda", timeout=MESH_TIMEOUT)
        whole = elastic_reference()
        w = wf.result()
        (a,) = af.result()
        futures = {shape: pool.submit(resume, shape)
                   for shape in ((2, 1), (1, 1))}
        resumes = {shape: f.result() for shape, f in futures.items()}
    shutil.rmtree(base, ignore_errors=True)
    log(f"[18a] one rank, mesh (1, 1) over nccl: serve {B} x {S} + {G}: "
        f"tokens equal {a['serve_tokens_equal']}, prefill logits bit-equal "
        f"{a['serve_prefill_equal']}; f32 at {MESH_GATE_LAYERS} layers, "
        f"prefill + {MESH_FORCED} decode steps: logits bit-equal "
        f"{a['f32_equal']} (the path without a mesh repeats itself "
        f"{a['f32_repeats']}); 3 bf16 training steps: losses "
        f"{a['losses']} bit-equal {a['losses_equal']}; collectives (each "
        f"over a group of one): serve {a['serve_collectives']}, train "
        f"{a['train_collectives']}; {a['s']:.1f} s in the rank, beside "
        f"18c's writer")
    if not (a["serve_tokens_equal"] and a["serve_prefill_equal"]
            and a["f32_equal"] and a["f32_repeats"] and a["losses_equal"]):
        raise AssertionError(f"18a: the (1, 1) mesh path is not the "
                             f"one-device path: {a}")
    out["a"] = {k: v for k, v in a.items()}
    want_steps = list(range(ELASTIC_STEPS[0], ELASTIC_STEPS[1]))
    for label, runs, steps in ((("1, 2", w, list(range(ELASTIC_STEPS[0]))),)
                               + tuple((f"{s[0]}, {s[1]}", r, want_steps)
                                       for s, r in resumes.items())):
        for i, rk in enumerate(runs):
            got = [h[0] for h in rk["hist"]]
            losses = [h[1] for h in rk["hist"]]
            wanted = [whole[s] for s in steps]
            rel = max(abs(x - y) / abs(y) for x, y in zip(losses, wanted))
            log(f"[18c] ({label}) rank {i}: steps {got}, losses {losses} "
                f"(uninterrupted {wanted}, largest relative gap {rel:.3g}),"
                f" {rk['s']:.1f} s, peak {rk['peak_B']} B")
            if got != steps or not rel <= ELASTIC_TOL:
                raise AssertionError(f"18c ({label}) rank {i}: steps {got},"
                                     f" losses {losses} vs {wanted}")
    log(f"[18a] [18c] took {time.perf_counter() - t:.1f} s")
    out["c"] = {"uninterrupted": whole, "write": [rk["hist"] for rk in w],
                **{f"resume_{s[0]}x{s[1]}": [rk["hist"] for rk in r]
                   for s, r in resumes.items()},
                "s": time.perf_counter() - t}
    # the one card's run at MESH_SERVE_CF (18b's bf16 reference) and its
    # f32 logits at MESH_GATE_LAYERS layers
    cfg = get_config("olmoe-1b-7b")
    one = serve(cfg, B, S, G, device="cuda", seed=0,
                capacity_factor=MESH_SERVE_CF)
    torch.cuda.empty_cache()
    cfg32 = olmoe_config(MESH_GATE_LAYERS, "float32")
    model = make_model(cfg32, device="cuda", seed=0)
    model.plan = moe.round_robin_plan(cfg.n_experts, 1, MESH_SERVE_CF)
    prompts = torch.from_numpy(make_prompts(cfg, B, S)).cuda()
    forced = torch.from_numpy(one.tokens[:, :MESH_FORCED]).cuda()
    ref32 = gate_logits(model, prompts, forced,
                        S + MESH_FORCED + 1)[0].cpu().numpy()
    del model
    torch.cuda.empty_cache()
    # 18b
    t = time.perf_counter()
    ref = {"tokens": one.tokens, "logits": one.prefill_logits, "f32": ref32}
    ranks = run_ranks(mesh_rank_18b, 2, B, S, G, ref, backend="gloo",
                      device="cuda", timeout=MESH_TIMEOUT)
    if ranks[0]["slot_experts"] != ranks[1]["slot_experts"]:
        raise AssertionError("18b: the ranks planned different placements")
    n_moe = sum(sg.n_layers for sg in cfg.segments if sg.kind == "moe")
    want_gmm = {"gmm_tc": 2 * 3 * n_moe, "gmv": 3 * n_moe * (G - 1),
                "general": 0}
    want_attn = {"prefill_tc": n_moe, "decode_split": n_moe * (G - 1),
                 "general": 0}
    for i, rk in enumerate(ranks):
        log(f"[18b] rank {i} of (1, 2) over gloo, two ranks on one card: "
            f"weights {rk['weight_B']} B, peak {rk['peak_B']} B, placement "
            f"{rk['placement_s']:.2f} s (local fraction "
            f"{rk['local_fraction']:.4f}), prefill {rk['prefill_s']:.3f} s, "
            f"decode {rk['ms_per_token']:.2f} ms/token (gloo through the "
            f"host, not NVLink); grouped matmul {rk['gmm_routes']}, "
            f"attention {rk['attn_routes']}; all_to_all a prefill layer "
            f"{rk['a2a_B_per_layer']}; tokens equal to one card's "
            f"{rk['tokens_equal_share']:.4f}, prefill logit gap "
            f"{rk['bf16_logit_gap']:.4g} of the largest")
        for name in ("replicated", "round_robin"):
            g = rk[name]
            log(f"[18b] rank {i} f32 {name}: gap {g['f32_gap']:.3g} of the "
                f"largest logit, local fraction {g['local_fraction']:.4f}, "
                f"all_to_all a layer {g['a2a_B_per_layer']} (counted "
                f"{g['a2a_counted_B_per_layer']:.0f} with the gathers: "
                f"{g['a2a_counted_ok']}), collectives {g['collectives']}")
            if not (g["f32_ok"] and g["a2a_counted_ok"]):
                raise AssertionError(f"18b rank {i} {name}: {g}")
        if rk["gmm_routes"] != want_gmm or rk["attn_routes"] != want_attn:
            raise AssertionError(f"18b rank {i}: routes {rk['gmm_routes']}"
                                 f" {rk['attn_routes']}, expected "
                                 f"{want_gmm} {want_attn}")
    log(f"[18b] took {time.perf_counter() - t:.1f} s")
    out["b"] = [{k: v for k, v in rk.items() if k != "slot_experts"}
                for rk in ranks]
    return out


# phase 19: tensor-parallel products.  deepseek-7b at full width, 8 of
# its 30 layers; the (1, 2) ranks' bf16 losses within the bf16 tolerance
# of one card's (a row-parallel product's partial sums are rounded to
# bf16 before the psum adds them)
DS7_LAYERS = 8
DS7_B, DS7_S = 2, 2048
DS7_GATE_B = 1
TP_LOSS_TOL = GRAD_TOL["bfloat16"]
TP_TIMEOUT = 600
# the kernels of phase 19b's path, by kernel-line entry: (launch counter,
# route table, route)
TP_KERNELS = {"flash_attention:prefill_tc": ("attn_routes", "prefill_tc"),
              "attention_bwd": ("bwd_routes", "attention_tc")}


def ds7_config(layers: int, dtype: str = "bfloat16"):
    """deepseek-7b at its published widths, cut to ``layers`` layers."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import Segment
    return get_config("deepseek-7b").with_(
        segments=(Segment("dense", layers),), dtype=dtype)


def ds7_stream(cfg, B: int):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
    return SyntheticTokenStream(cfg, DataConfig(B, DS7_S, seed=0))


def tp_rank(rank: int) -> dict:
    """19b and 19c, one of two ranks of a (1, 2) mesh over gloo on one
    card (see the module docstring)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import sharding as shd
    from repro_torch.roofline.hlo import CollectiveCounter
    from repro_torch.train.step import batch_to, build_train_step
    mesh = make_mesh((1, 2), ("data", "model"), device="cuda")
    # 19b
    cfg = ds7_config(DS7_LAYERS)
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    ts = build_train_step(cfg, opt, mesh=mesh, device="cuda")
    state = ts.init_state(0)
    held_B = sum(p.numel() * p.element_size()
                 for p in state["params"].values())
    stream = ds7_stream(cfg, DS7_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    shd.reset_tp_routes()
    losses, seconds, coll = [], [], None
    for step in range(MESH_STEPS):
        batch = ts.local_batch(batch_to(stream.next_batch(), "cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # step 1's collectives counted (the counter sees every operation:
        # the timed steps after it run without it)
        with CollectiveCounter() if step == 0 else \
                contextlib.nullcontext() as cc:
            state, met = ts.step_fn(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
        if step == 0:
            coll = cc.result()
    out = {"held_B": held_B, "peak_B": torch.cuda.max_memory_allocated(),
           "losses": losses, "seconds": seconds, "collectives": coll,
           "routes": {k: dict(v) for k, v in shd.tp_route_launches.items()},
           "launches": dict(ops.launches),
           "attn_routes": dict(ops.route_launches),
           "bwd_routes": dict(ops.bwd_route_launches),
           "replicated": sorted(n for n, sh in ts.model.shardings().items()
                                if sh is None)}
    del ts, state
    torch.cuda.empty_cache()
    # 19c
    cfg32 = ds7_config(MESH_GATE_LAYERS, "float32")
    batch = batch_to(ds7_stream(cfg32, DS7_GATE_B).next_batch(), "cuda")
    ref = None
    if rank == 0:                   # one card's gradients
        one = build_train_step(cfg32, opt, device="cuda")
        params, met = one.grads(one.init_state(0), batch)
        ref = {n: p.grad for n, p in params.items()}
        ref_loss = float(met["loss"])
        del one, params
        torch.cuda.empty_cache()
    ts = build_train_step(cfg32, opt, mesh=mesh, device="cuda")
    params, met = ts.grads(ts.init_state(0), ts.local_batch(batch))
    held = ts.model.shardings()
    gaps, replicated = {}, {}
    with shd.use_mesh(mesh):
        for n, p in params.items():
            g = p.grad if held[n] is None else held[n].full(p.grad)
            if held[n] is None:
                replicated[n] = g.cpu().numpy()
            if ref is not None:
                gaps[n] = float((g - ref[n]).abs().max()
                                / ref[n].abs().max().clamp_min(1e-30))
            del g
    out["f32"] = {"loss": float(met["loss"]), "replicated": replicated}
    if ref is not None:
        out["f32"].update(ref_loss=ref_loss, gaps=gaps)
    return out


def tp_phase(dry: dict) -> dict:
    """Phase 19: 19a on this process's card, then 19b and 19c in two
    ranks of their own (``tp_rank``); checks and prints."""
    import torch
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline.model import step_cost
    cfg = ds7_config(DS7_LAYERS)
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    a = train_steps(cfg, opt, "19a", ds7_stream(cfg, DS7_B))
    torch.cuda.empty_cache()
    log(f"[19a] took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ranks = run_ranks(tp_rank, 2, backend="gloo", device="cuda",
                      timeout=TP_TIMEOUT)
    log(f"[19b] [19c] two ranks took {time.perf_counter() - t:.1f} s")
    L, D, T = DS7_LAYERS, cfg.d_model, DS7_B * DS7_S
    cell = dry["deepseek-7b/tp"]
    if cell["status"] != "ok":
        raise AssertionError(f"19: the dry run at (1, 2): {cell['status']}"
                             f": {cell.get('error', cell.get('reason'))}")
    cost = step_cost(cfg, DS7_B, DS7_S, DS7_S, 1, 2, "train")["coll_bytes"]
    stream_B = T * D * 2                  # one bf16 psum of the stream
    want_attn = {"prefill_tc": 2 * L * MESH_STEPS, "decode_split": 0,
                 "general": 0}
    b_rows = []
    for i, rk in enumerate(ranks):
        med = float(np.median(rk["seconds"][1:]))
        c = rk["collectives"]
        # the all-reduces that are not the stream's: the replicated
        # leaves' gradients over 'model', the split leaves' squared norms
        # in one, the cross-entropy's max and its psum of two and back
        n_split = 7 * L + 2
        xent = DS7_B * (DS7_S - 1) * 4
        small = len(rk["replicated"]) * D * 4 + n_split * 4 + 5 * xent
        n_stream = (c["per_kind_bytes"]["all-reduce"] - small) / stream_B
        rel = max(abs(x - y) / abs(y) for x, y in zip(rk["losses"],
                                                      a["losses"]))
        row = {"held_B": rk["held_B"], "dry_param_B": cell["param_bytes"],
               "half_of_19a": rk["held_B"] / (2 * a["n_params"]),
               "peak_B": rk["peak_B"], "dry_peak_B":
               cell["memory"]["peak_bytes"], "losses": rk["losses"],
               "loss_rel_gap": rel, "step_s": rk["seconds"],
               "median_step_s": med, "tokens_per_s": T / med,
               "routes": rk["routes"], "collectives": c,
               "stream_allreduces": n_stream,
               "stream_allreduces_per_layer": (n_stream - 2) / L,
               "step_cost_coll_B": cost,
               "counted_over_step_cost": c["per_kind_bytes"]["all-reduce"]
               / cost, "dry_collectives": cell["collectives"],
               "attn_routes": rk["attn_routes"],
               "bwd_routes": rk["bwd_routes"], "launches": rk["launches"]}
        log(f"[19b] rank {i} of (1, 2) over gloo, two ranks on one card: "
            f"parameters held {rk['held_B']} B (the dry run's "
            f"{cell['param_bytes']}; {row['half_of_19a']:.4f} of 19a's "
            f"bf16 bytes), peak {rk['peak_B']} B (the dry run's "
            f"{cell['memory']['peak_bytes']}), routes {rk['routes']}; "
            f"losses {rk['losses']} (19a's {a['losses']}, largest relative "
            f"gap {rel:.3g}); seconds {rk['seconds']}, median of steps "
            f"2-{MESH_STEPS} {med:.4f} s/step, {T / med:.6g} tokens/s "
            f"(gloo through the host, not NVLink); step 1's collectives "
            f"{c} -- {n_stream:g} all-reduces of the stream ({stream_B} B "
            f"each), {row['stream_allreduces_per_layer']:g} a layer; "
            f"step_cost's collective term at tp = 2 {cost:.6g} B, counted "
            f"{row['counted_over_step_cost']:.4f} of it; the dry run's "
            f"{cell['collectives']}; attention {rk['attn_routes']}, "
            f"backward {rk['bwd_routes']}")
        if c["counts"]["all-gather"] or c["counts"]["reduce-scatter"] \
                or c["counts"]["all-to-all"]:
            raise AssertionError(f"19b rank {i}: a tp step gathered: {c}")
        if any(r["gathered"] for r in rk["routes"].values()) or \
                set(rk["routes"]) != {"embed", "gqa", "mlp", "head"}:
            raise AssertionError(f"19b rank {i}: routes {rk['routes']}")
        if rk["held_B"] != cell["param_bytes"]:
            raise AssertionError(f"19b rank {i}: holds {rk['held_B']} B, "
                                 f"the dry run {cell['param_bytes']}")
        if not rel <= TP_LOSS_TOL:
            raise AssertionError(f"19b rank {i}: losses {rk['losses']} vs "
                                 f"19a's {a['losses']}")
        if rk["attn_routes"] != want_attn or \
                rk["bwd_routes"]["attention_tc"] != L * MESH_STEPS:
            raise AssertionError(f"19b rank {i}: attention "
                                 f"{rk['attn_routes']}, backward "
                                 f"{rk['bwd_routes']}")
        b_rows.append(row)
    f0, f1 = ranks[0]["f32"], ranks[1]["f32"]
    worst = max(f0["gaps"].values())
    rel32 = abs(f0["loss"] - f0["ref_loss"]) / abs(f0["ref_loss"])
    same = all(np.array_equal(f0["replicated"][n], f1["replicated"][n])
               for n in f0["replicated"])
    log(f"[19c] f32 at {MESH_GATE_LAYERS} layers, {DS7_GATE_B} x {DS7_S} "
        f"tokens: loss {f0['loss']} and {f1['loss']} vs one card's "
        f"{f0['ref_loss']} (relative gap {rel32:.3g}); gathered gradients' "
        f"largest gap {worst:.3g} of a leaf's largest entry "
        f"({max(f0['gaps'], key=f0['gaps'].get)}); "
        f"{len(f0['replicated'])} replicated leaves' gradients bit-equal "
        f"on both ranks: {same}")
    if not (worst <= GRAD_TOL["float32"] and rel32 <= ELASTIC_TOL and same
            and f1["loss"] == f0["loss"]):
        raise AssertionError(f"19c: gradients {worst}, loss {rel32}, "
                             f"replicated equal {same}")
    return {"a": a, "b": b_rows,
            "c": {"loss": f0["loss"], "ref_loss": f0["ref_loss"],
                  "loss_rel_gap": rel32, "worst_grad_gap": worst,
                  "replicated_equal": same}}


# --------------------------------------------- 20. the sequence split
# smollm-135m (the registry's one ``dp_seq`` config) at its published
# widths and depth; 20b splits each 4096-token sequence over the two model
# ranks of a (1, 2) mesh
SEQ_B, SEQ_S = 8, 4096
SEQ_GATE_B = 2                  # 20c: f32 at MESH_GATE_LAYERS layers
SP_GATE_B, SP_GATE_S = 1, 2048  # 20d: deepseek-7b, seq_shard_activations
SEQ_TIMEOUT = 600
# 20k: rank 1's attention call of 20b, (B, Sq, Sk, H, KV, hd, q_off):
# its 2048 queries at positions 2048-4095 against the 4096 gathered keys;
# rank 0's (q_off 0) beside it for the split's imbalance
SEQ_KERNEL_CASE = (SEQ_B, SEQ_S // 2, SEQ_S, 9, 3, 64, SEQ_S // 2)
# the kernels of phase 20b's path, by kernel-line entry: (route table,
# route)
SEQ_KERNELS = {"flash_attention:prefill_tc": ("attn_routes", "prefill_tc"),
               "attention_bwd": ("bwd_routes", "attention_tc")}


def smollm_config(layers: int = 0, dtype: str = "bfloat16"):
    """smollm-135m at its published widths, cut to ``layers`` layers (0:
    its 30)."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import Segment
    cfg = get_config("smollm-135m").with_(dtype=dtype)
    return cfg.with_(segments=(Segment("dense", layers),)) if layers else cfg


def smollm_stream(cfg, B: int):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
    return SyntheticTokenStream(cfg, DataConfig(B, SEQ_S, seed=0))


def seq_kernel_rows() -> list:
    """20k: the four attention kernels at rank 1's call of 20b (causal,
    the queries at ``q_off`` 2048 on): ``prefill_tc`` with its LSE and the
    ``tc`` backward in bf16, ``general``'s forward with its LSE and
    backward in f32,
    each against its plain version (``MODEL_TOL``, ``GRAD_TOL``; the LSE
    within ``LSE_TOL``), timed beside its bound (``live_pairs`` with the
    offset: 3/4 of the pairs of a whole 4096-token call, 3/8 of the block
    against every key), the plain version and SDPA with the explicit
    boolean mask (forward, and forward and backward); at ``q_off`` 0
    (rank 0's call) the same launch as a call without the argument,
    bit-equal, and timed: the split's imbalance."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    B, Sq, Sk, H, KV, hd, q_off = SEQ_KERNEL_CASE
    dev = torch.device("cuda")
    rows = []
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device=dev).manual_seed(20)
        q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((B, Sk, KV, hd), generator=g,
                            device=dev).to(dtype) for _ in range(2))
        do = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype)
        scale = hd ** -0.5
        kw = dict(causal=True, window=0, scale=scale)
        bf16 = dtype_name == "bfloat16"
        route, bwd = ("prefill_tc", "tc") if bf16 else ("general", "general")
        ops.reset_launches()
        with torch.no_grad():
            o, lse = fa.flash_attention(q, k, v, return_lse=True,
                                        q_off=q_off, **kw)
            # rank 0's call: q_off 0 is the call without the argument
            o0 = fa.flash_attention(q, k, v, q_off=0, **kw)
            same0 = torch.equal(o0, fa.flash_attention(q, k, v, **kw))
            want = ref.attention_ref(q, k, v, q_off=q_off, **kw)
        torch.cuda.synchronize()
        if ops.route_launches[route] != 3 or not same0:
            raise AssertionError(f"20k {dtype_name}: routes "
                                 f"{ops.route_launches}, q_off 0 bit-equal "
                                 f"to no offset: {same0}")
        tol = MODEL_TOL[("attn", dtype_name)]
        ok, err = rel_ok(o, want, tol)
        lse_err = float((lse - ref.attention_lse_ref(
            q, k, q_off=q_off, **kw)).abs().max())
        if not ok or lse_err > LSE_TOL:
            raise AssertionError(f"20k {dtype_name}: forward with q_off "
                                 f"{q_off} off by {err} (tol {tol}), LSE "
                                 f"by {lse_err}")
        del want
        ops.reset_launches()
        got = fa.attention_bwd(q, k, v, o, do, lse=lse, q_off=q_off, **kw)
        plain = ref.attention_bwd_ref(q, k, v, o, do, lse=lse, q_off=q_off,
                                      **kw)
        torch.cuda.synchronize()
        errs = {n: grad_gap(a, b) for n, a, b in zip("qkv", got, plain)}
        if ops.bwd_route_launches[f"attention_{bwd}"] != 1 or \
                max(errs.values()) > GRAD_TOL[dtype_name]:
            raise AssertionError(f"20k {dtype_name}: backward with q_off "
                                 f"{q_off}: {errs} past "
                                 f"{GRAD_TOL[dtype_name]}, routes "
                                 f"{ops.bwd_route_launches}")
        del got, plain
        rate = BF16_FLOPS_PER_S if bf16 else F32_TC_FLOPS_PER_S
        es = q.element_size()

        def bound(flops, nbytes):
            t_ops, t_bytes = flops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                         else "bytes")
        f_b = bound(*fa.attention_cost(es, B, Sq, Sk, H, KV, hd, hd, True,
                                       0, 0, True, q_off))
        b_b = bound(*fa.attention_bwd_cost(es, B, Sq, Sk, H, KV, hd,
                                           hd, True, 0, q_off))
        mask = (torch.arange(Sq, device=dev)[:, None] + q_off
                >= torch.arange(Sk, device=dev)[None, :])
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous().requires_grad_(
            x is not do) for x in (q, k, v, do))

        def fwd(off=q_off):
            return fa.flash_attention(q, k, v, return_lse=True, q_off=off,
                                      **kw)

        def bwd_run():
            return fa.attention_bwd(q, k, v, o, do, lse=lse, q_off=q_off,
                                    **kw)

        def lib_fwd():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

        def lib_both():
            lib_fwd().backward(dot)
        with torch.no_grad():
            t_fwd = [graph_ms(fwd, 5, 3), graph_ms(lambda: fwd(0), 5, 3)]
            plain_fwd = graph_ms(lambda: ref.attention_ref(
                q, k, v, q_off=q_off, **kw), 1, 2)
            lib_f = time_ms(lib_fwd, 5)
        t_bwd = graph_ms(bwd_run, 5, 3)
        plain_bwd = graph_ms(lambda: ref.attention_bwd_ref(
            q, k, v, o, do, lse=lse, q_off=q_off, **kw), 1, 2)
        lib_b = time_ms(lib_both, 5)
        pairs = B * fa.live_pairs(Sq, Sk, True, 0, q_off)
        pairs0 = B * fa.live_pairs(Sq, Sk, True, 0, 0)
        rows.append({
            "case": "seq_rank1", "dtype": dtype_name, "route": route,
            "bwd_route": bwd, "q_off": q_off,
            "shape": [B, Sq, Sk, H, KV, hd, hd], "pairs": pairs,
            "pairs_rank0": pairs0, "max_abs_err": err, "lse_err": lse_err,
            "bwd_errs": errs, "bwd_max_err": max(errs.values()),
            "q_off0_bit_equal": same0,
            "ms": t_fwd[0], "rank0_ms": t_fwd[1],
            "bound_ms": f_b[0], "bound_by": f_b[1], "plain_ms": plain_fwd,
            "library_ms": lib_f, "bwd_ms": t_bwd, "bwd_bound_ms": b_b[0],
            "bwd_bound_by": b_b[1], "bwd_plain_ms": plain_bwd,
            "library_fwd_bwd_ms": lib_b, "library_bwd_ms": lib_b - lib_f,
            "sdpa_backend": sdpa_backend(qt, kt, vt, mask)})
        log(f"[20k] {dtype_name} rank 1's call {[B, Sq, Sk, H, KV, hd]} at "
            f"q_off {q_off}: forward on {route} {t_fwd[0]:.4f} ms (bound "
            f"{f_b[0]:.4f} ms by {f_b[1]}, {pairs} live pairs; rank 0's "
            f"call at q_off 0, {pairs0} pairs, {t_fwd[1]:.4f} ms, its "
            f"launch bit-equal to no offset: {same0}), plain "
            f"{plain_fwd:.3f} ms, SDPA with the mask {lib_f:.4f} ms "
            f"({rows[-1]['sdpa_backend']}); max abs error {err:.3g} (tol "
            f"{tol}), LSE {lse_err:.3g}; backward on {bwd} {t_bwd:.4f} ms "
            f"(bound {b_b[0]:.4f} ms by {b_b[1]}), plain {plain_bwd:.3f} "
            f"ms, SDPA forward and backward {lib_b:.4f} ms (its backward "
            f"alone {lib_b - lib_f:.4f} ms); gradient gaps {errs}")
        del q, k, v, o, do, qt, kt, vt, dot, mask
        torch.cuda.empty_cache()
    return rows


def param_digest(params) -> int:
    """A checksum of the parameters' bits (each leaf's 16- or 32-bit words
    weighted by their index): two ranks whose digests differ hold
    different parameters."""
    import torch
    total = 0
    for p in params:
        w = p.detach().reshape(-1).view(
            torch.int16 if p.element_size() == 2 else torch.int32).long()
        idx = torch.arange(w.numel(), device=w.device) % 65521 + 1
        total += int((w * idx).sum())
    return total


def seq_rank(rank: int) -> dict:
    """20b, 20c and 20d, one of two ranks of a (1, 2) mesh over gloo on
    one card (see the module docstring)."""
    import dataclasses
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import sharding as shd
    from repro_torch.roofline.hlo import CollectiveCounter
    from repro_torch.train.step import batch_to, build_train_step
    mesh = make_mesh((1, 2), ("data", "model"), device="cuda")
    # 20b
    cfg = smollm_config()
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    ts = build_train_step(cfg, opt, mesh=mesh, device="cuda")
    state = ts.init_state(0)
    stream = smollm_stream(cfg, SEQ_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    shd.reset_seq_routes()
    losses, seconds, digests, coll, split = [], [], [], None, None
    for step in range(MESH_STEPS):
        batch = ts.local_batch(batch_to(stream.next_batch(), "cuda"))
        split = batch["seq_split"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CollectiveCounter() if step == 0 else \
                contextlib.nullcontext() as cc:
            state, met = ts.step_fn(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
        digests.append(param_digest(state["params"].values()))
        if step == 0:
            coll = cc.result()
    out = {"peak_B": torch.cuda.max_memory_allocated(), "losses": losses,
           "seconds": seconds, "digests": digests, "collectives": coll,
           "q_off": split.offset, "block": split.block,
           "tokens": list(batch["tokens"].shape),
           "labels": list(batch["labels"].shape),
           "routes": {k: dict(v) for k, v in shd.seq_route_launches.items()},
           "launches": dict(ops.launches),
           "attn_routes": dict(ops.route_launches),
           "bwd_routes": dict(ops.bwd_route_launches),
           "held_B": sum(p.numel() * p.element_size()
                         for p in state["params"].values())}
    # one more step under the profiler: this rank's attention device time
    batch = ts.local_batch(batch_to(stream.next_batch(), "cuda"))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ts.step_fn(state, batch)
        torch.cuda.synchronize()
    attn = {"fwd": ("prefill_tc_kernel",), "bwd": ("dq_kernel",
                                                   "dkv_kernel")}
    out["attn_device_ms"] = {
        k: sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and any(x in e.key for x in keys)) / 1e3
        for k, keys in attn.items()}
    del ts, state
    torch.cuda.empty_cache()

    def gate(cfg32, batch, tag):
        """One f32 step's gradients at (1, 2) against rank 0's one-card
        step: gaps, losses, digests of the whole leaves, collectives."""
        ref = None
        if rank == 0:
            one = build_train_step(cfg32, opt, device="cuda")
            params, met = one.grads(one.init_state(0), batch)
            ref = {n: p.grad for n, p in params.items()}
            ref_loss = float(met["loss"])
            del one, params
            torch.cuda.empty_cache()
        ts = build_train_step(cfg32, opt, mesh=mesh, device="cuda")
        cc = CollectiveCounter()
        with cc:
            params, met = ts.grads(ts.init_state(0), ts.local_batch(batch))
        held = ts.model.shardings()
        gaps, whole = {}, []
        with shd.use_mesh(mesh):
            for n, p in params.items():
                g = p.grad if held[n] is None else held[n].full(p.grad)
                if held[n] is None:
                    whole.append(p.grad)
                if ref is not None:
                    gaps[n] = float((g - ref[n]).abs().max()
                                    / ref[n].abs().max().clamp_min(1e-30))
                del g
        res = {"loss": float(met["loss"]), "collectives": cc.result(),
               "whole_digest": param_digest(whole), "n_whole": len(whole)}
        if ref is not None:
            res.update(ref_loss=ref_loss, gaps=gaps)
        del ts, params, ref, whole
        torch.cuda.empty_cache()
        return res
    # 20c
    cfg32 = smollm_config(MESH_GATE_LAYERS, "float32")
    out["f32"] = gate(cfg32, batch_to(smollm_stream(
        cfg32, SEQ_GATE_B).next_batch(), "cuda"), "20c")
    # 20d: seq_shard_activations, and 19c's step without it beside
    cfg32 = dataclasses.replace(ds7_config(MESH_GATE_LAYERS, "float32"),
                                seq_shard_activations=True)
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
    batch = batch_to(SyntheticTokenStream(cfg32, DataConfig(
        SP_GATE_B, SP_GATE_S, seed=0)).next_batch(), "cuda")
    shd.reset_seq_routes()
    out["sp"] = gate(cfg32, batch, "20d")
    out["sp"]["routes"] = {k: dict(v)
                           for k, v in shd.seq_route_launches.items()}
    base = build_train_step(dataclasses.replace(
        cfg32, seq_shard_activations=False), opt, mesh=mesh, device="cuda")
    cc = CollectiveCounter()
    with cc:
        base.grads(base.init_state(0), base.local_batch(batch))
    out["sp"]["baseline_collectives"] = cc.result()
    return out


def seq_phase(dry: dict) -> dict:
    """Phase 20: 20k and 20a on this process's card, then 20b, 20c and
    20d in two ranks of their own (``seq_rank``); checks and prints."""
    import torch
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.optim.adamw import AdamWConfig
    t = time.perf_counter()
    k_rows = seq_kernel_rows()
    log(f"[20k] took {time.perf_counter() - t:.1f} s")
    cfg = smollm_config()
    L, T = cfg.n_layers, SEQ_B * SEQ_S
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    t = time.perf_counter()
    a = train_steps(cfg, opt, "20a", smollm_stream(cfg, SEQ_B))
    torch.cuda.empty_cache()
    log(f"[20a] took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ranks = run_ranks(seq_rank, 2, backend="gloo", device="cuda",
                      timeout=SEQ_TIMEOUT)
    log(f"[20b] [20c] [20d] two ranks took {time.perf_counter() - t:.1f} s")
    cell = dry["smollm-135m/seq"]
    if cell["status"] != "ok":
        raise AssertionError(f"20: the dry run at (1, 2): {cell['status']}"
                             f": {cell.get('error', cell.get('reason'))}")
    want_attn = {"prefill_tc": 2 * L * MESH_STEPS, "decode_split": 0,
                 "general": 0}
    want_routes = {"embed": {"seq": 0, "token": MESH_STEPS, "gathered": 0},
                   "gqa": {"seq": 2 * L * MESH_STEPS, "token": 0,
                           "gathered": 0},
                   "mlp": {"seq": 0, "token": 2 * L * MESH_STEPS,
                           "gathered": 0},
                   "head": {"seq": 0, "token": MESH_STEPS, "gathered": 0}}
    b_rows = []
    for i, rk in enumerate(ranks):
        med = float(np.median(rk["seconds"][1:]))
        rel = max(abs(x - y) / abs(y) for x, y in zip(rk["losses"],
                                                      a["losses"]))
        c = rk["collectives"]
        row = {"q_off": rk["q_off"], "block": rk["block"],
               "tokens": rk["tokens"], "labels": rk["labels"],
               "held_B": rk["held_B"], "peak_B": rk["peak_B"],
               "peak_over_20a": rk["peak_B"] / a["peak_B"],
               "dry_peak_B": cell["memory"]["peak_bytes"],
               "losses": rk["losses"], "loss_rel_gap": rel,
               "step_s": rk["seconds"], "median_step_s": med,
               "tokens_per_s": T / med, "routes": rk["routes"],
               "collectives": c, "dry_collectives": cell["collectives"],
               "attn_routes": rk["attn_routes"],
               "bwd_routes": rk["bwd_routes"], "launches": rk["launches"],
               "attn_device_ms": rk["attn_device_ms"]}
        log(f"[20b] rank {i} of (1, 2) over gloo, two ranks on one card: "
            f"q_off {rk['q_off']}, tokens {rk['tokens']}, labels "
            f"{rk['labels']}; parameters held {rk['held_B']} B (whole); "
            f"peak {rk['peak_B']} B ({row['peak_over_20a']:.4f} of 20a's; "
            f"the dry run's {cell['memory']['peak_bytes']}); routes "
            f"{rk['routes']}; losses {rk['losses']} (20a's {a['losses']}, "
            f"largest relative gap {rel:.3g}); seconds {rk['seconds']}, "
            f"median of steps 2-{MESH_STEPS} {med:.4f} s/step, "
            f"{T / med:.6g} tokens/s (gloo through the host, not NVLink); "
            f"step 1's collectives {c} (the dry run's "
            f"{cell['collectives']}); attention {rk['attn_routes']}, "
            f"backward {rk['bwd_routes']}; one more step's attention "
            f"device ms {rk['attn_device_ms']}")
        if rk["attn_routes"] != want_attn or \
                rk["bwd_routes"]["attention_tc"] != L * MESH_STEPS:
            raise AssertionError(f"20b rank {i}: attention "
                                 f"{rk['attn_routes']}, backward "
                                 f"{rk['bwd_routes']}")
        if rk["routes"] != want_routes:
            raise AssertionError(f"20b rank {i}: routes {rk['routes']}")
        if rk["q_off"] != i * SEQ_S // 2 or rk["tokens"] != [SEQ_B,
                                                            SEQ_S // 2]:
            raise AssertionError(f"20b rank {i}: block at {rk['q_off']}, "
                                 f"tokens {rk['tokens']}")
        if not rel <= TP_LOSS_TOL:
            raise AssertionError(f"20b rank {i}: losses {rk['losses']} vs "
                                 f"20a's {a['losses']}")
        b_rows.append(row)
    if ranks[0]["digests"] != ranks[1]["digests"]:
        raise AssertionError(f"20b: the ranks' parameters differ after a "
                             f"step: {ranks[0]['digests']} vs "
                             f"{ranks[1]['digests']}")
    att = [sum(r["attn_device_ms"].values()) for r in ranks]
    imbalance = att[1] / att[0] if att[0] else "not measured"
    log(f"[20b] parameters bit-equal on both ranks after every step "
        f"(digests {ranks[0]['digests']}); attention device ms a step by "
        f"rank {att}: rank 1 / rank 0 {imbalance}")
    gates = {}
    for tag, key in (("20c", "f32"), ("20d", "sp")):
        f0, f1 = ranks[0][key], ranks[1][key]
        worst = max(f0["gaps"].values())
        rel32 = abs(f0["loss"] - f0["ref_loss"]) / abs(f0["ref_loss"])
        same = f0["whole_digest"] == f1["whole_digest"]
        extra = ""
        if key == "sp":
            extra = (f"; routes {f0['routes']}; step 1's collectives "
                     f"{f0['collectives']}, without the flag "
                     f"{f0['baseline_collectives']}")
        log(f"[{tag}] f32 at {MESH_GATE_LAYERS} layers: loss {f0['loss']} "
            f"and {f1['loss']} vs one card's {f0['ref_loss']} (relative "
            f"gap {rel32:.3g}); gathered gradients' largest gap {worst:.3g} "
            f"of a leaf's largest entry "
            f"({max(f0['gaps'], key=f0['gaps'].get)}); {f0['n_whole']} "
            f"whole leaves' gradients bit-equal on both ranks: {same}"
            f"{extra}")
        if not (worst <= GRAD_TOL["float32"] and rel32 <= ELASTIC_TOL
                and same and f1["loss"] == f0["loss"]):
            raise AssertionError(f"{tag}: gradients {worst}, loss {rel32}, "
                                 f"whole leaves equal {same}")
        gates[tag] = {"loss": f0["loss"], "ref_loss": f0["ref_loss"],
                      "loss_rel_gap": rel32, "worst_grad_gap": worst,
                      "whole_equal": same,
                      "collectives": f0["collectives"]}
    # every layer's families on ``gathered``, twice with the remat replay
    runs = MESH_GATE_LAYERS * (1 if ds7_config(1).remat == "none" else 2)
    sp = ranks[0]["sp"]
    c, base = sp["collectives"]["counts"], sp["baseline_collectives"]["counts"]
    if c["all-reduce"] >= base["all-reduce"] or not c["reduce-scatter"] \
            or sp["routes"]["gqa"]["gathered"] != runs \
            or sp["routes"]["mlp"]["gathered"] != runs:
        raise AssertionError(f"20d: collectives {c} vs without the flag "
                             f"{base}, routes {sp['routes']}")
    gates["20d"].update(baseline_collectives=sp["baseline_collectives"],
                        routes=sp["routes"])
    return {"k": k_rows,
            "a": a, "b": b_rows, "attn_ms_by_rank": att, "imbalance": imbalance,
            "c": gates["20c"], "d": gates["20d"]}


# ------------------------------------------- 21. the Mamba mixer's blocks
# falcon-mamba-7b (the ``ssm`` kind, arXiv:2410.05355) at the registry's
# widths: served at full depth (21s, phase 6's traffic), trained at 16 of
# its 64 layers on one card (21a) and tensor-parallel on two gloo ranks of
# a (1, 2) mesh, every mixer on its channel blocks (21b), with an f32
# gate at 2 layers (21c); 21k holds the scan kernels at its widths
FM_TRAIN_LAYERS = 16
FM_B, FM_S = 2, 2048
FM_SERVE_GATE_LAYERS = 8         # 21s's f32 gate
FM_GATE_B = 1                    # 21c: f32 at MESH_GATE_LAYERS layers
FM_LOSS_TOL = 5e-3               # 21b's losses against 21a's, relative
# 21c: the gradients within GRAD_TOL's f32 bound, as 19c and 20c hold
# theirs (the full-width step's f32 sums in another order moved the
# embedding's gradient by 1.4e-5 of its largest entry), the loss within
# 1e-6
FM_GRAD_TOL, FM_GATE_LOSS_TOL = GRAD_TOL["float32"], 1e-6
FM_TIMEOUT = 600
# 21k: the forward and the step at falcon's d_inner ((name, counter, B, S,
# di, N, with a state, on the path), as ``SCAN_CASES``), the backward at a
# step's (B, S, di, N) on one card and at a rank's half of the channels
FM_SCAN_CASES = [
    ("falcon_prefill", "mamba_scan", 4, 2048, 8192, 16, False, True),
    ("falcon_decode", "mamba_step", 4, 1, 8192, 16, True, True),
]
FM_BWD_SCAN_CASES = [("falcon_train", (FM_B, FM_S, 8192, 16)),
                     ("falcon_rank", (FM_B, FM_S, 4096, 16))]
# the mixer's leaves held as channel blocks on route ``tp``
FM_SPLIT = ("in_proj", "conv_w", "A_log", "ssm_D", "x_proj", "dt_proj",
            "out_proj")


def falcon_config(layers: int = 0, dtype: str = "bfloat16"):
    """falcon-mamba-7b at its published widths, cut to ``layers`` Mamba
    layers (0: all 64)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("falcon-mamba-7b").with_(dtype=dtype)
    if not layers:
        return cfg
    return cfg.with_(segments=(dataclasses.replace(cfg.segments[0],
                                                   n_layers=layers),))


def falcon_stream(cfg, B: int):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
    return SyntheticTokenStream(cfg, DataConfig(B, FM_S, seed=0))


def falcon_dryrun_cells() -> dict:
    """21a's and 21b's training steps on the meta device: one card, and
    rank 0 of a (1, 2) mesh over a fake process group of two."""
    import torch.distributed as dist
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch.dryrun import fake_mesh, run_cell
    shape = Shape(f"smoke_train_{FM_B}x{FM_S}", FM_S, FM_B, "train")
    over = {"segments": falcon_config(FM_TRAIN_LAYERS).segments}
    out = {"falcon-mamba-7b/one": run_cell("falcon-mamba-7b", shape,
                                           overrides=over)}
    try:
        out["falcon-mamba-7b/tp"] = run_cell(
            "falcon-mamba-7b", shape, overrides=over, mesh=fake_mesh((1, 2)))
    finally:
        dist.destroy_process_group()
    return out


def falcon_kernel_rows(clock_hz: float, sms: int) -> list:
    """21k: the scan forward and step at falcon's d_inner, and the
    backward at a step's shape and a rank's, each segmented by
    ``bwd_plan`` with a last segment shorter than the rest, in bf16 and
    f32, against their plain versions; each bound beside ``scan_cost``'s
    bytes and FLOPs (what the dry run counts)."""
    from repro_torch.kernels import mamba_scan as ms
    rows = []
    for case in FM_SCAN_CASES:
        name, _, B, S, di, N, state, _ = case
        for dt in ("bfloat16", "float32"):
            r = check_scan(case, dt, 2100, clock_hz, sms)
            r["scan_cost"] = ms.scan_cost(4 if dt == "float32" else 2, B, S,
                                          di, N, state)
            rows.append(r)
            log(f"[21k] {name} {dt} {r['shape']}: kernel {r['ms']:.6g} ms, "
                f"call {r['call_ms']:.6g}, bound {r['bound_ms']:.6g} "
                f"({r['bound_by']}; scan_cost {r['scan_cost']}), plain "
                f"{r['plain_ms']:.6g}; max abs err {r['max_abs_err']:.3g}")
    for name, case in FM_BWD_SCAN_CASES:
        B, S, di, N = case
        for dt in ("bfloat16", "float32"):
            r = check_scan_bwd(dt, 2100, clock_hz, sms, case=case,
                               name=name)
            r["scan_cost"] = ms.scan_cost(4 if dt == "float32" else 2, B, S,
                                          di, N, False, backward=True)
            if not 0 < r["last_segment_steps"] < r["segment_steps"]:
                raise AssertionError(f"21k {name}: segments of "
                                     f"{r['segment_steps']} steps, the last "
                                     f"{r['last_segment_steps']}")
            rows.append(r)
            log(f"[21k] {name} backward {dt} {r['shape']}: "
                f"{r['segments']} segments of {r['segment_steps']} steps, "
                f"the last {r['last_segment_steps']}; kernel {r['ms']:.6g} "
                f"ms, call {r['call_ms']:.6g}, bound {r['bound_ms']:.6g} "
                f"({r['bound_by']}; scan_cost {r['scan_cost']}), plain "
                f"{r['plain_ms']:.6g}; passes {r['pass_ms']}; gaps "
                f"{r['errs']}, two runs bit-equal")
    return rows


def falcon_serve(B: int, S: int, G: int) -> dict:
    """21s: falcon-mamba-7b served at full width and depth through
    ``launch.serve.serve`` (phase 6's prompts), its launches as
    ``expected_serve_launches`` says.  Then at ``FM_SERVE_GATE_LAYERS``
    layers, over the prefill and three teacher-forced decode steps, as
    phase 6 holds hymba: the f32 kernel path against the f32 plain path
    within ``F32_LOGIT_TOL``, and the bf16 kernel and plain paths against
    the f32 plain path at the bf16 weights (``bf16_errors``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_model, make_prompts, serve
    cfg = falcon_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = serve(cfg, B, S, G, device="cuda", seed=0)
    peak = torch.cuda.max_memory_allocated()
    dec = served_decode(res, "21s")
    launches = {c: res.launches[c] for c in MODEL_COUNTERS}
    want = expected_serve_launches(cfg, G)
    if launches != want:
        raise AssertionError(f"21s: serve launched {launches}, expected "
                             f"{want}")
    if any(ops.route_launches.values()) or any(
            ops.gmm_route_launches.values()):
        raise AssertionError(f"21s: attention {ops.route_launches}, "
                             f"grouped products {ops.gmm_route_launches}")
    if res.tokens.shape != (B, G) or not (
            (res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise AssertionError(f"21s: bad tokens {res.tokens.shape}")
    weight_B = res.weight_bytes
    prompts = torch.from_numpy(make_prompts(cfg, B, S, 0)).cuda()
    forced = torch.from_numpy(make_prompts(cfg, B, 3, 1)).cuda()
    model = make_model(cfg, device="cuda", seed=0)
    profile = decode_profile(model, prompts, S + G, tag="21sb")
    del model
    torch.cuda.empty_cache()
    cut = falcon_config(FM_SERVE_GATE_LAYERS)
    model32 = make_model(cut.with_(dtype="float32"), device="cuda", seed=0)
    kern32 = logits_through(model32, prompts, forced, "cuda", S + G)
    plain32 = logits_through(model32, prompts, forced, "ref", S + G)
    model = make_model(cut, device="cuda", seed=0)
    same_draw = round_weights(model32, model)
    ref32 = logits_through(model32, prompts, forced, "ref", S + G)
    del model32
    kern16 = logits_through(model, prompts, forced, "cuda", S + G)
    plain16 = logits_through(model, prompts, forced, "ref", S + G)
    del model
    torch.cuda.empty_cache()
    for name, kern in (("float32", kern32), ("bfloat16", kern16)):
        if not (torch.isfinite(kern).all()
                and kern.shape == (B, 4, cfg.vocab)):
            raise AssertionError(f"21s: {name} logits not finite or "
                                 f"misshapen: {tuple(kern.shape)}")
    gap32, scale32 = (float((kern32 - plain32).abs().max()),
                      float(plain32.abs().max()))
    if not gap32 <= F32_LOGIT_TOL * scale32:
        raise AssertionError(f"21s: f32 kernel path off the plain path by "
                             f"{gap32} > {F32_LOGIT_TOL} x {scale32}")
    errs = bf16_errors(kern16, plain16, ref32)
    out = {"prefill_s": sig(res.prefill_s),
           "ms_per_token": sig(res.ms_per_token),
           "tok_s": sig(res.tokens_per_s), "peak_B": peak, **dec,
           "profile": profile,
           "weight_B": weight_B, "launches": launches, **errs,
           "same_draw": same_draw, "f32_gap": sig(gap32 / scale32),
           "gate_layers": FM_SERVE_GATE_LAYERS}
    log(f"[21s] serve {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, d_inner {cfg.d_inner}, {weight_B} B of bf16 "
        f"weights): {B} prompts x {S} tokens, {G} new each; prefill "
        f"{res.prefill_s:.4f} s, decode {res.ms_per_token:.4f} ms/token "
        f"({res.decode}, capture {res.capture_s:.4f} s), "
        f"{res.tokens_per_s:.2f} tok/s, max_memory_allocated {peak} B; "
        f"launches {launches}; sample {res.tokens[0][:8].tolist()}")
    log(f"[21s] at {FM_SERVE_GATE_LAYERS} layers, prefill + 3 decode "
        f"steps: f32 kernel vs plain path {gap32:.6g} of {scale32:.6g} "
        f"({gap32 / scale32:.6g}); bf16 paths against the f32 plain path "
        f"at the bf16 weights (same draw: {same_draw}), shares of its "
        f"largest |logit|: kernel {errs['bf16_kernel_err']}, plain "
        f"{errs['bf16_plain_err']} (ratio {errs['bf16_err_ratio']}); "
        f"kernel vs plain in bf16 {errs['bf16_gap']}")
    return out


def falcon_rank(rank: int) -> dict:
    """21b and 21c, one of two ranks of a (1, 2) mesh over gloo on one
    card (see the module docstring)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import sharding as shd
    from repro_torch.roofline.hlo import CollectiveCounter
    from repro_torch.train.step import batch_to, build_train_step
    mesh = make_mesh((1, 2), ("data", "model"), device="cuda")
    # 21b
    cfg = falcon_config(FM_TRAIN_LAYERS)
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    ts = build_train_step(cfg, opt, mesh=mesh, device="cuda")
    state = ts.init_state(0)
    held = ts.model.shardings()
    params = state["params"]
    held_B = sum(p.numel() * p.element_size() for p in params.values())
    # each mixer leaf's share of its whole tensor held here
    shares = {}
    for n, p in params.items():
        if ".mamba." in n or n.endswith("ln1"):
            leaf = n.split(".")[-1]
            whole = (p.numel() if held[n] is None else
                     held[n].full(p.detach()).numel())
            shares.setdefault(leaf, set()).add(p.numel() / whole)
    replicated = [n for n, sh in held.items() if sh is None]
    stream = falcon_stream(cfg, FM_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    shd.reset_tp_routes()
    losses, seconds, digests, coll = [], [], [], None
    for step in range(MESH_STEPS):
        batch = ts.local_batch(batch_to(stream.next_batch(), "cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CollectiveCounter() if step == 0 else \
                contextlib.nullcontext() as cc:
            state, met = ts.step_fn(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
        digests.append(param_digest(state["params"][n] for n in replicated))
        if step == 0:
            coll = cc.result()
    out = {"held_B": held_B, "peak_B": torch.cuda.max_memory_allocated(),
           "losses": losses, "seconds": seconds, "collectives": coll,
           "digests": digests,
           "shares": {k: sorted(v) for k, v in shares.items()},
           "routes": {k: dict(v) for k, v in shd.tp_route_launches.items()},
           "launches": dict(ops.launches)}
    # one more step under the profiler: this rank's scan device time, the
    # forward's and the backward's kernels (``train_step_split``'s kinds)
    batch = ts.local_batch(batch_to(stream.next_batch(), "cuda"))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ts.step_fn(state, batch)
        torch.cuda.synchronize()
    names = ("scan_kernel",) + tuple(SCAN_BWD_PASSES.values())
    out["scan_device_ms"] = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and any(x in e.key for x in names)) / 1e3
    del ts, state, params
    torch.cuda.empty_cache()
    # 21c
    cfg32 = falcon_config(MESH_GATE_LAYERS, "float32")
    batch = batch_to(falcon_stream(cfg32, FM_GATE_B).next_batch(), "cuda")
    ref = None
    if rank == 0:                   # one card's gradients
        one = build_train_step(cfg32, opt, device="cuda")
        params, met = one.grads(one.init_state(0), batch)
        ref = {n: p.grad for n, p in params.items()}
        ref_loss = float(met["loss"])
        del one, params
        torch.cuda.empty_cache()
    ts = build_train_step(cfg32, opt, mesh=mesh, device="cuda")
    params, met = ts.grads(ts.init_state(0), ts.local_batch(batch))
    held = ts.model.shardings()
    gaps, whole = {}, []
    with shd.use_mesh(mesh):
        for n, p in params.items():
            g = p.grad if held[n] is None else held[n].full(p.grad)
            if held[n] is None:
                whole.append(p.grad)
            if ref is not None:
                gaps[n] = float((g - ref[n]).abs().max()
                                / ref[n].abs().max().clamp_min(1e-30))
            del g
    out["f32"] = {"loss": float(met["loss"]),
                  "whole_digest": param_digest(whole), "n_whole": len(whole)}
    if ref is not None:
        out["f32"].update(ref_loss=ref_loss, gaps=gaps)
    return out


def falcon_phase(dry: dict, clock_hz: float, sms: int) -> dict:
    """Phase 21: 21k, 21s and 21a on this process's card, then 21b and 21c
    in two ranks of their own (``falcon_rank``); checks and prints."""
    import torch
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline.model import step_cost
    t = time.perf_counter()
    k_rows = falcon_kernel_rows(clock_hz, sms)
    log(f"[21k] took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    s = falcon_serve(4, 2048, 32)
    log(f"[21s] took {time.perf_counter() - t:.1f} s")
    cfg = falcon_config(FM_TRAIN_LAYERS)
    L, T = FM_TRAIN_LAYERS, FM_B * FM_S
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    t = time.perf_counter()
    a = train_steps(cfg, opt, "21a", falcon_stream(cfg, FM_B))
    torch.cuda.empty_cache()
    log(f"[21a] took {time.perf_counter() - t:.1f} s")
    one, cell = dry["falcon-mamba-7b/one"], dry["falcon-mamba-7b/tp"]
    for c in (one, cell):
        if c["status"] != "ok":
            raise AssertionError(f"21: a dry run: {c['status']}: "
                                 f"{c.get('error', c.get('reason'))}")
    if (one["leaves"], one["state_bytes"]) != (a["n_params"], a["state_B"]):
        raise AssertionError(f"21a: dry run {one['leaves']} parameters, "
                             f"{one['state_bytes']} B of state; the card "
                             f"trained {a['n_params']}, {a['state_B']} B")
    a_scan_ms = (a["split"]["device_ms"]["scan_fwd"]
                 + a["split"]["device_ms"]["scan_bwd"])
    a["dry"] = {"peak_pred_B": one["memory"]["peak_bytes"],
                "peak_ratio": sig(one["memory"]["peak_bytes"] / a["peak_B"]),
                "flops": one["cost"]["flops"],
                "kernel_flops": one["kernel_flops"],
                "step_cost_flops": one["step_cost"]["flops"],
                "flops_ratio": sig(one["cost"]["flops"]
                                   / one["step_cost"]["flops"])}
    a["roofline"] = roofline_row("21a", cfg, FM_B, FM_S, FM_S, "train",
                                 a["median_step_s"])
    a["scan_device_ms"] = a_scan_ms
    log(f"[21a] dry run: peak predicted {one['memory']['peak_bytes']} B, "
        f"measured {a['peak_B']} B (ratio {a['dry']['peak_ratio']}); "
        f"counted FLOPs {one['cost']['flops']:.6g} (kernels "
        f"{one['kernel_flops']:.6g}), step_cost's "
        f"{one['step_cost']['flops']:.6g} (ratio {a['dry']['flops_ratio']});"
        f" the scan's device ms in the split step {a_scan_ms:.6g}")
    t = time.perf_counter()
    ranks = run_ranks(falcon_rank, 2, backend="gloo", device="cuda",
                      timeout=FM_TIMEOUT)
    log(f"[21b] [21c] two ranks took {time.perf_counter() - t:.1f} s")
    cost = step_cost(cfg, FM_B, FM_S, FM_S, 1, 2, "train")["coll_bytes"]
    want_routes = {"embed": {"tp": MESH_STEPS, "gathered": 0},
                   "mamba": {"tp": 2 * L * MESH_STEPS, "gathered": 0},
                   "head": {"tp": MESH_STEPS, "gathered": 0}}
    want_l = {c: MESH_STEPS * n
              for c, n in expected_train_launches(cfg, a["leaves"]).items()}
    b_rows = []
    for i, rk in enumerate(ranks):
        med = float(np.median(rk["seconds"][1:]))
        c = rk["collectives"]
        rel = max(abs(x - y) / abs(y) for x, y in zip(rk["losses"],
                                                      a["losses"]))
        row = {"held_B": rk["held_B"], "dry_param_B": cell["param_bytes"],
               "half_of_21a": rk["held_B"] / (2 * a["n_params"]),
               "shares": rk["shares"], "peak_B": rk["peak_B"],
               "dry_peak_B": cell["memory"]["peak_bytes"],
               "peak_over_21a": rk["peak_B"] / a["peak_B"],
               "losses": rk["losses"], "loss_rel_gap": rel,
               "step_s": rk["seconds"], "median_step_s": med,
               "tokens_per_s": T / med, "routes": rk["routes"],
               "collectives": c, "dry_collectives": cell["collectives"],
               "step_cost_coll_B": cost,
               "counted_over_step_cost": c["total_bytes"] / cost,
               "launches": rk["launches"],
               "scan_device_ms": rk["scan_device_ms"],
               "scan_over_21a": rk["scan_device_ms"] / a_scan_ms}
        log(f"[21b] rank {i} of (1, 2) over gloo, two ranks on one card: "
            f"parameters held {rk['held_B']} B (the dry run's "
            f"{cell['param_bytes']}; {row['half_of_21a']:.4f} of 21a's "
            f"bf16 bytes), shares of each leaf held {rk['shares']}; peak "
            f"{rk['peak_B']} B ({row['peak_over_21a']:.4f} of 21a's; the dry"
            f" run's {cell['memory']['peak_bytes']}); routes {rk['routes']};"
            f" losses {rk['losses']} (21a's {a['losses']}, largest relative"
            f" gap {rel:.3g}); seconds {rk['seconds']}, median of steps "
            f"2-{MESH_STEPS} {med:.4f} s/step, {T / med:.6g} tokens/s "
            f"(gloo through the host, not NVLink); step 1's collectives {c}"
            f" (the dry run's {cell['collectives']}; step_cost's collective "
            f"term at tp = 2 {cost:.6g} B, counted "
            f"{row['counted_over_step_cost']:.4f} of it); launches "
            f"{rk['launches']}; one more step's scan device ms "
            f"{rk['scan_device_ms']:.6g} ({row['scan_over_21a']:.4f} of "
            f"21a's)")
        if rk["held_B"] != cell["param_bytes"]:
            raise AssertionError(f"21b rank {i}: holds {rk['held_B']} B, "
                                 f"the dry run {cell['param_bytes']}")
        if any(rk["shares"][k] != [0.5] for k in FM_SPLIT) or any(
                rk["shares"][k] != [1.0] for k in ("conv_b", "dt_bias",
                                                   "ln1")):
            raise AssertionError(f"21b rank {i}: shares {rk['shares']}")
        if (c["counts"], c["per_kind_bytes"]) != (
                cell["collectives"]["counts"],
                cell["collectives"]["per_kind_bytes"]):
            raise AssertionError(f"21b rank {i}: step 1's collectives {c}, "
                                 f"the dry run's {cell['collectives']}")
        if c["counts"]["all-gather"] or c["counts"]["reduce-scatter"] \
                or c["counts"]["all-to-all"]:
            raise AssertionError(f"21b rank {i}: a tp step gathered: {c}")
        if rk["routes"] != want_routes:
            raise AssertionError(f"21b rank {i}: routes {rk['routes']}")
        if rk["launches"] != want_l:
            raise AssertionError(f"21b rank {i}: launches {rk['launches']},"
                                 f" expected {want_l}")
        if not rel <= FM_LOSS_TOL:
            raise AssertionError(f"21b rank {i}: losses {rk['losses']} vs "
                                 f"21a's {a['losses']}")
        b_rows.append(row)
    if ranks[0]["digests"] != ranks[1]["digests"]:
        raise AssertionError(f"21b: the ranks' replicated leaves differ: "
                             f"{ranks[0]['digests']} vs "
                             f"{ranks[1]['digests']}")
    f0, f1 = ranks[0]["f32"], ranks[1]["f32"]
    worst = max(f0["gaps"].values())
    rel32 = abs(f0["loss"] - f0["ref_loss"]) / abs(f0["ref_loss"])
    same = f0["whole_digest"] == f1["whole_digest"]
    log(f"[21b] replicated leaves bit-equal on both ranks after every step "
        f"(digests {ranks[0]['digests']})")
    log(f"[21c] f32 at {MESH_GATE_LAYERS} layers, {FM_GATE_B} x {FM_S} "
        f"tokens: loss {f0['loss']} and {f1['loss']} vs one card's "
        f"{f0['ref_loss']} (relative gap {rel32:.3g}); gathered gradients' "
        f"largest gap {worst:.3g} of a leaf's largest entry "
        f"({max(f0['gaps'], key=f0['gaps'].get)}); {f0['n_whole']} whole "
        f"leaves' gradients bit-equal on both ranks: {same}")
    top = sorted(f0["gaps"].items(), key=lambda kv: -kv[1])[:4]
    log(f"[21c] the largest gaps by leaf: {top}")
    if not (worst <= FM_GRAD_TOL and rel32 <= FM_GATE_LOSS_TOL and same
            and f1["loss"] == f0["loss"]):
        raise AssertionError(f"21c: gradients {worst}, loss {rel32}, "
                             f"whole leaves equal {same}")
    return {"k": k_rows, "serve": s, "a": a, "b": b_rows,
            "c": {"loss": f0["loss"], "ref_loss": f0["ref_loss"],
                  "loss_rel_gap": rel32, "worst_grad_gap": worst,
                  "largest_gaps": top, "whole_equal": same}}


# ------------------------------------ 22. training as one captured step
GRAPH_HYMBA_LAYERS = 4          # 22b: hymba-1.5b at 4 of its 32 layers
GRAPH_OLMOE_LAYERS = 2          # 22b: olmoe-1b-7b at 2 of its 16 layers
GRAPH_STEPS = 3
ADAMW_TOL = 1e-6                # 22a: kernel against plain, each leaf
# 22c: the bf16 head's loss against the f32 head's, relative (the logits
# differ only in the order of f32 sums), and each gradient leaf within
# the bf16 backward's GRAD_TOL of its largest entry (the cotangent of the
# head's products rounded to bf16 once)
HEAD_LOSS_TOL = 1e-4
ADAMW_REPLACES = ("src/repro/optim/adamw.py:62 (jnp, fused by XLA; no "
                  "Pallas kernel)")


def adamw_phase() -> dict:
    """22a: the fused AdamW kernel (``kernels.adamw``) over hymba-1.5b's
    leaves (their shapes and dtypes: bf16, the norms f32), from random
    gradients (bf16 or f32 as the leaf), moments and masters: one step
    through the kernel and one through its plain version
    (``optim.adamw.update_leaf``) from copies of one state, m, v and the
    master within ``ADAMW_TOL`` of each leaf's largest entry (bit-equality
    reported), the parameter the master cast; then timed: device ms (the
    launches of every leaf in one CUDA graph, replayed), call ms (the
    eager loop), plain ms (the plain loop, CUDA events), the bound (each
    array read or written once, over 3.35 TB/s), and the library's time:
    ``torch._fused_adamw_`` (its multi-tensor AdamW, decoupled decay) over
    the f32 masters with the gradients cast to f32 beforehand (not
    timed), the lr a device tensor and the clip as ``grad_scale`` = 1 /
    scale, then the parameters copied from the masters
    (``torch._foreach_copy_``): the same update, CUDA events."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    cfg = get_config("hymba-1.5b")
    opt = adamw.AdamWConfig()
    shapes = {n: (tuple(p.shape), p.dtype) for n, p in
              Model(cfg, device="meta").named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(22)

    def rand(shape, scale):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    leaves = {}
    for n, (shape, dt) in shapes.items():
        master = rand(shape, 0.02)
        leaves[n] = {"g": rand(shape, 1e-3).to(dt), "m": rand(shape, 1e-4),
                     "v": rand(shape, 1e-3).square_(), "master": master,
                     "p": master.to(dt, copy=True)}
    plain = {n: {k: t.clone() for k, t in d.items() if k != "g"}
             for n, d in leaves.items()}
    sc = torch.tensor([0.5, 3e-4, 1 - 0.9 ** 3, 1 - 0.95 ** 3],
                      device="cuda")
    consts = (opt.b1, opt.b2, opt.eps, opt.weight_decay)

    def kernel():
        for d in leaves.values():
            kadamw.fused_update(d["g"], d["m"], d["v"], d["master"],
                                d["p"], sc, *consts)

    def plain_loop():
        for n, d in plain.items():
            adamw.update_leaf(opt, leaves[n]["g"], d["m"], d["v"],
                              d["master"], d["p"], *sc.unbind())
    ops.reset_launches()
    kernel()
    plain_loop()
    torch.cuda.synchronize()
    launches = ops.launches["adamw"]
    gaps, equal, n_el, nbytes, abs_err = {}, True, 0, 0, 0.0
    for n, d in leaves.items():
        for k in ("m", "v", "master", "p"):
            a, b = d[k].float(), plain[n][k].float()
            err = float((a - b).abs().max())
            abs_err = max(abs_err, err)
            gaps[f"{n}/{k}"] = err / max(float(b.abs().max()), 1e-30)
            equal = equal and torch.equal(d[k], plain[n][k])
        if not torch.equal(d["p"], d["master"].to(d["p"].dtype)):
            raise AssertionError(f"22a {n}: the parameter is not the "
                                 f"master cast")
        n_el += d["p"].numel()
        nbytes += kadamw.adamw_cost(d["g"], d["m"], d["p"])[1]
    worst = max(gaps, key=gaps.get)
    del plain
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for _ in range(3):
        kernel()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3 / 3
    dev_ms = graph_ms(kernel, launches=1, replays=5)
    plain = {n: {k: t.clone() for k, t in d.items() if k != "g"}
             for n, d in leaves.items()}
    plain_ms = time_ms(plain_loop, iters=2)
    del plain
    torch.cuda.empty_cache()
    lib = {k: [d[k] for d in leaves.values()] for k in ("master", "m", "v",
                                                         "p")}
    g32 = [d["g"].float() for d in leaves.values()]
    steps = [torch.full((), 3.0, device="cuda") for _ in leaves]
    unscale = 1 / sc[0]

    def library():
        torch._fused_adamw_(lib["master"], g32, lib["m"], lib["v"], [],
                            steps, lr=sc[1], beta1=opt.b1, beta2=opt.b2,
                            weight_decay=opt.weight_decay, eps=opt.eps,
                            amsgrad=False, maximize=False,
                            grad_scale=unscale)
        torch._foreach_copy_(lib["p"], lib["master"])
    library_ms = time_ms(library, iters=2)
    del leaves, lib, g32
    torch.cuda.empty_cache()
    row = {"name": "adamw", "leaves": len(shapes), "elements": n_el,
           "launches_a_step": launches, "max_abs_err": abs_err,
           "max_rel_err": gaps[worst],
           "worst": worst, "bit_equal": equal, "ms": dev_ms,
           "call_ms": call_ms, "plain_ms": plain_ms,
           "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
           "bytes": nbytes, "library_ms": library_ms}
    log(f"[22a] the fused AdamW over hymba-1.5b's {len(shapes)} leaves "
        f"({n_el} elements, {nbytes} B moved): {launches} launches a step;"
        f" kernel against plain: worst {worst} {gaps[worst]:.3g} of its "
        f"largest entry, every leaf bit-equal: {equal}; device "
        f"{dev_ms:.6g} ms (one graph of every launch), call "
        f"{call_ms:.6g} ms, plain {plain_ms:.6g} ms, bound "
        f"{row['bound_ms']:.6g} ms (bytes); library (torch._fused_adamw_ "
        f"on f32 gradients, then the parameters' copy) {library_ms:.6g} ms")
    if launches != len(shapes) or not gaps[worst] <= ADAMW_TOL:
        raise AssertionError(f"22a: {launches} launches, worst gap "
                             f"{gaps[worst]} ({worst})")
    return {k: sig(v) if isinstance(v, float) else v for k, v in row.items()}


def captured_vs_eager(cfg, stream, tag: str) -> dict:
    """22b: ``GRAPH_STEPS`` bf16 steps of ``cfg`` eagerly, then captured,
    from seed 0 on the batches ``stream()`` draws: the losses and every
    parameter and optimizer leaf after the steps bit-equal; each run's
    seconds a step, the capture's seconds and its pool."""
    import torch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import batch_to, build_train_step
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    runs = {}
    for graph in (False, True):
        ts = build_train_step(cfg, opt, device="cuda", graph=graph)
        state = ts.init_state(0)
        src = stream()
        losses, seconds, kinds = [], [], []
        for _ in range(GRAPH_STEPS):
            batch = batch_to(src.next_batch(), "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = ts.step_fn(state, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            kinds.append(ts.last_kind)
            losses.append(met["loss"].clone())
        leaves = {f"{part}/{n}": t for part, tree in (
            ("params", state["params"]), ("master", state["opt"]["master"]),
            ("m", state["opt"]["m"]), ("v", state["opt"]["v"]))
            for n, t in tree.items()}
        if graph:
            equal = all(torch.equal(t, runs[False]["leaves"][k])
                        for k, t in leaves.items())
            same_loss = torch.equal(torch.stack(losses),
                                    runs[False]["losses"])
        runs[graph] = {"losses": torch.stack(losses),
                       "leaves": {k: t.clone() for k, t in leaves.items()}
                       if not graph else None,
                       "kinds": kinds, "seconds": seconds,
                       "capture_s": ts.capture_s,
                       "graph_pool_B": ts.graph_pool_B}
        del ts, state, leaves, met
        torch.cuda.empty_cache()
    cap, eager = runs[True], runs[False]
    out = {"layers": cfg.n_layers, "losses": eager["losses"].tolist(),
           "bit_equal_losses": same_loss, "bit_equal_state": equal,
           "kinds": cap["kinds"], "eager_s": [sig(x) for x in
                                                 eager["seconds"]],
           "captured_s": [sig(x) for x in cap["seconds"]],
           "capture_s": sig(cap["capture_s"]),
           "graph_pool_B": cap["graph_pool_B"]}
    log(f"[22b] {tag} ({cfg.n_layers} layers): {GRAPH_STEPS} steps eager "
        f"{out['eager_s']} s and captured {out['captured_s']} s "
        f"({cap['kinds']}; capture {out['capture_s']} s, graph pool "
        f"{cap['graph_pool_B']} B); losses {out['losses']}, bit-equal: "
        f"{same_loss}; every parameter, master, m and v bit-equal: {equal}")
    if not (same_loss and equal):
        raise AssertionError(f"22b {tag}: captured steps differ from eager "
                             f"ones: {out}")
    return out


class F32Head:
    """While active, the loss head multiplies through f32 copies of x and
    the head (``x.float() @ head.float()``), as it did before the bf16
    product (22c's yardstick; never the path)."""

    def __enter__(self):
        from repro_torch.models import model as model_mod

        class _F32:
            @staticmethod
            def apply(x, head):
                return x.float() @ head.float()
        self._real = model_mod._HeadProduct
        model_mod._HeadProduct = _F32
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.models import model as model_mod
        model_mod._HeadProduct = self._real


def head_phase() -> dict:
    """22c: deepseek-7b's bf16 model at ``DS7_LAYERS`` layers from seed 0,
    one loss and backward on a ``DS7_B`` x ``DS7_S`` batch with the head
    multiplied bf16 by bf16 into f32 (the path) and one through f32
    copies of x and the head (``F32Head``, as before): the loss gap
    (relative, within ``HEAD_LOSS_TOL``) and every leaf's gradient gap as
    a share of its largest entry (within ``GRAD_TOL`` bf16)."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.train.step import batch_to
    cfg = ds7_config(DS7_LAYERS)
    model = Model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0)).requires_grad_(True)
    batch = batch_to(ds7_stream(cfg, DS7_B).next_batch(), "cuda")

    def grads():
        for p in model.parameters():
            p.grad = None
        loss, _ = model.loss(batch)
        loss.backward()
        return float(loss.detach()), {
            n: p.grad for n, p in model.named_parameters()
            if p.grad is not None}
    loss16, g16 = grads()
    with F32Head():
        loss32, g32 = grads()
    gaps = {n: grad_gap(g16[n], g) for n, g in g32.items()}
    del g16, g32, model
    torch.cuda.empty_cache()
    rel = abs(loss16 - loss32) / abs(loss32)
    worst = max(gaps, key=gaps.get)
    head = "embed" if cfg.tie_embeddings else "lm_head"
    out = {"layers": cfg.n_layers, "loss_bf16": loss16, "loss_f32": loss32,
           "loss_rel_gap": rel, "worst_leaf": worst,
           "worst_gap": gaps[worst], "head_gap": gaps[head],
           "gaps": {n: sig(v) for n, v in gaps.items()}}
    log(f"[22c] {cfg.name} ({cfg.n_layers} layers, {DS7_B} x {DS7_S} "
        f"tokens): loss with the bf16 head {loss16!r}, with the f32 head "
        f"{loss32!r} (relative gap {rel:.3g}); gradients, shares of each "
        f"leaf's largest entry: worst {worst} {gaps[worst]:.3g}, the head "
        f"{gaps[head]:.3g}; every leaf {out['gaps']}")
    if not rel <= HEAD_LOSS_TOL or not gaps[worst] <= GRAD_TOL["bfloat16"]:
        raise AssertionError(f"22c: the bf16 head's loss off by {rel}, "
                             f"gradient {worst} off by {gaps[worst]}")
    return {k: sig(v) if isinstance(v, float) else v for k, v in out.items()}


def graph_phase() -> dict:
    """Phase 22: 22a, 22b and 22c (see the module docstring)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
    out = {"a": adamw_phase()}
    hymba = hymba_layers_config(GRAPH_HYMBA_LAYERS)
    olmoe = olmoe_config(GRAPH_OLMOE_LAYERS)
    out["b"] = {name: captured_vs_eager(cfg, lambda cfg=cfg: (
        SyntheticTokenStream(cfg, DataConfig(TRAIN_B, TRAIN_S, seed=0))),
        name) for name, cfg in (("hymba-1.5b", hymba),
                                ("olmoe-1b-7b", olmoe))}
    out["c"] = head_phase()
    return out


# ------------------------------------ 23. the fused elementwise kernels
# file:line of the reference's jnp that each fused op stands for (XLA
# fuses it; no Pallas kernel)
FUSED_REPLACES = {
    "rmsnorm": "src/repro/models/layers.py:23",
    "rope": "src/repro/models/layers.py:29",
    "causal_conv": "src/repro/models/layers.py:287",
    "silu_gate": "src/repro/models/layers.py:45"}
FUSED_NOTE = " (jnp, fused by XLA; no Pallas kernel)"
FUSED_OPS = tuple(FUSED_REPLACES)
# (op, tag, shape), the first of each op its commonest path shape: rmsnorm
# (rows, D), rope (B, S, H, hd), the conv (B, S, di) on a column slice of
# in_proj's output ("decode": S = 1 from a state), the gate (rows, D) or
# (B, S, di) with the mixer's z a slice of in_proj's output
FUSED_CASES = [
    ("rmsnorm", "hymba", (TRAIN_B * TRAIN_S, 1600)),
    ("rmsnorm", "hubert", (12000, 1280)),
    ("rmsnorm", "smollm", (32768, 576)),
    ("rmsnorm", "deepseek", (TRAIN_B * TRAIN_S, 7168)),
    ("rmsnorm", "decode", (4, 1600)),
    ("rope", "hymba_q", (TRAIN_B, TRAIN_S, 25, 64)),
    ("rope", "hymba_k", (TRAIN_B, TRAIN_S, 5, 64)),
    ("rope", "hubert", (8, 1500, 16, 80)),
    ("rope", "decode", (4, 1, 25, 64)),
    ("causal_conv", "hymba", (TRAIN_B, TRAIN_S, 3200)),
    ("causal_conv", "falcon", (2, TRAIN_S, 8192)),
    ("causal_conv", "decode", (4, 1, 3200)),
    ("silu_gate", "hymba", (TRAIN_B * TRAIN_S, 5504)),
    ("silu_gate", "hymba_mixer", (TRAIN_B, TRAIN_S, 3200)),
    ("silu_gate", "hubert", (12000, 5120)),
    ("silu_gate", "olmoe", (64 * 2560, 1024)),
    ("silu_gate", "falcon_mixer", (2, TRAIN_S, 8192)),
    ("silu_gate", "decode", (4, 5504)),
]
# rmsnorm's and the conv's backward, in their second designs: each
# launch's kernel (a part of its name) for ``kernel_split_ms``, and the
# first designs' device ms at the same cases (PERF.md's table; H100 80GB
# HBM3 at 700 W), "before"
FUSED_BWD_SPLIT = {
    "rmsnorm": {"band": "fused_rmsnorm_bwd_kernel",
                "dwsum": "fused_rmsnorm_dwsum_kernel"},
    "causal_conv": {"main": "fused_conv_bwd_kernel",
                    "dwsum": "fused_conv_dwsum_kernel"}}
FUSED_BWD_BEFORE = {
    ("rmsnorm", "hymba", "bfloat16"): 0.0706923,
    ("rmsnorm", "hymba", "float32"): 0.125131,
    ("rmsnorm", "hubert", "bfloat16"): 0.0739573,
    ("rmsnorm", "smollm", "bfloat16"): 0.0982368,
    ("causal_conv", "hymba", "bfloat16"): 0.177806,
    ("causal_conv", "hymba", "float32"): 0.182565,
    ("causal_conv", "falcon", "bfloat16"): 0.182956}
# the conv's forward in its first design (a thread a chunk of 64 steps
# and four channels, global loads a step), device ms at the same cases
# (PERF.md's table; H100 80GB HBM3 at 700 W), "before"; decode keeps
# that design (a thread a channel group from a state)
FUSED_FWD_BEFORE = {
    ("causal_conv", "hymba", "bfloat16"): 0.0792021,
    ("causal_conv", "hymba", "float32"): 0.121367,
    ("causal_conv", "falcon", "bfloat16"): 0.0815317,
    ("causal_conv", "decode", "bfloat16"): 0.00455573}
# a training step's calls of each op by case tag, as shares of
# ``expected_train_launches``' counts (phase 23's split of 13b's and 16b's
# steps by layer op): hymba's ropes half on its 25 query heads, half on
# its 5 key heads; its gates half the MLP's, half the mixer's
FUSED_SPLIT = {
    "hymba-1.5b": {"rmsnorm": {"hymba": 1.0},
                   "rope": {"hymba_q": 0.5, "hymba_k": 0.5},
                   "causal_conv": {"hymba": 1.0},
                   "silu_gate": {"hymba": 0.5, "hymba_mixer": 0.5}},
    "hubert-xlarge": {"rmsnorm": {"hubert": 1.0}, "rope": {"hubert": 1.0},
                      "silu_gate": {"hubert": 1.0}}}


def fused_case(op: str, tag: str, shape: tuple, dtype_name: str,
               seed: int) -> dict:
    """One case's inputs on the card and its callables: the kernel's
    forward and backward wrappers (``fwd``, ``bwd``; no backward from a
    state), the plain forward and written-out backward (``plain``,
    ``plain_bwd``), the op's autograd Function and its plain chain with the
    differentiated inputs (``train``, ``chain``, ``leaves``), the
    library's call (``library``) and the bytes of each bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused, ops, ref
    dt = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def t(*s, scale=1.0, dtype=dt):
        return (torch.randn(s, generator=gen, device="cuda") * scale).to(
            dtype)
    case = {"library": None}
    if op == "rmsnorm":
        x, w = t(*shape, scale=2), 1 + t(shape[-1], scale=0.25,
                                         dtype=torch.float32)
        wl = w.to(dt)
        args = (x, w)
        case.update(
            fwd=lambda: fused.rmsnorm(x, w, 1e-5),
            plain=lambda: ref.rmsnorm_ref(x, w, 1e-5),
            bwd=lambda dy: fused.rmsnorm_bwd(x, w, dy, 1e-5),
            plain_bwd=lambda dy: ref.rmsnorm_bwd_ref(x, w, dy, 1e-5),
            train=lambda a, b: ops.rmsnorm(a, b, 1e-5),
            chain=lambda a, b: ref.rmsnorm_ref(a, b, 1e-5),
            library=lambda a=x: F.rms_norm(a, (shape[-1],), wl, 1e-5),
            library_train=lambda a, b: F.rms_norm(a, (shape[-1],),
                                                  b.to(dt), 1e-5),
            cost=(fused.rmsnorm_cost(x, w)[1],
                  fused.rmsnorm_cost(x, w, backward=True)[1]))
    elif op == "rope":
        B, S, H, hd = shape
        x = t(B, S, H, hd)
        pos = (torch.arange(S, dtype=torch.int32, device="cuda")
               + (TRAIN_S - 1 if S == 1 else 0)).expand(B, S)
        args = (x,)
        case.update(
            fwd=lambda: fused.rope(x, pos, 1e4),
            plain=lambda: ref.rope_ref(x, pos, 1e4),
            bwd=lambda dy: fused.rope(dy, pos, 1e4, negate=True),
            plain_bwd=lambda dy: ref.rope_bwd_ref(dy, pos, 1e4),
            train=lambda a: ops.rope(a, pos, 1e4),
            chain=lambda a: ref.rope_ref(a, pos, 1e4),
            cost=(fused.rope_cost(x, pos)[1], fused.rope_cost(x, pos)[1]))
    elif op == "causal_conv":
        B, S, di = shape
        u = t(B, S, 2 * di)[..., :di]
        w, b = t(4, di, scale=0.5), t(di, scale=0.25)
        args = (u, w, b)
        ut = u.transpose(1, 2).contiguous()       # conv1d's (B, di, S)
        wc = w.t().contiguous()[:, None, :]       # (di, 1, K)
        case.update(library=lambda: F.conv1d(ut, wc, b, padding=3,
                                             groups=di)[..., :S],
                    library_train=lambda a, c_, d: F.silu(F.conv1d(
                        a, c_, d, padding=3, groups=di)[..., :S]),
                    library_args=(ut, wc, b),
                    library_dy=lambda dy: dy.transpose(1, 2).contiguous())
        if tag == "decode":
            state = t(B, 3, di)
            held = state.clone()
            case.update(
                fwd=lambda: fused.causal_conv(u, w, b, held)[0],
                plain=lambda: ref.causal_conv_ref(u, w, b, state)[0],
                bwd=None, cost=(fused.conv_cost(u, w, True)[1], None))
        else:
            case.update(
                fwd=lambda: fused.causal_conv(u, w, b)[0],
                plain=lambda: ref.causal_conv_ref(u, w, b)[0],
                bwd=lambda dy: fused.causal_conv_bwd(u, w, b, dy),
                plain_bwd=lambda dy: ref.causal_conv_bwd_ref(u, w, b, dy),
                train=lambda a, c, d: ops.causal_conv(a, c, d)[0],
                chain=lambda a, c, d: ref.causal_conv_ref(a, c, d)[0],
                cost=(fused.conv_cost(u, w, False)[1],
                      fused.conv_cost(u, w, False, backward=True)[1]))
    else:
        if len(shape) == 3:
            B, S, di = shape
            g, u = t(B, S, 2 * di, scale=3)[..., di:], t(B, S, di)
        else:
            g, u = t(*shape, scale=3), t(*shape)
        args = (g, u)
        case.update(
            fwd=lambda: fused.silu_gate(g, u),
            plain=lambda: ref.silu_gate_ref(g, u),
            bwd=None if tag == "decode" else (
                lambda dy: fused.silu_gate_bwd(g, u, dy)),
            plain_bwd=lambda dy: ref.silu_gate_bwd_ref(g, u, dy),
            train=ops.silu_gate, chain=ref.silu_gate_ref,
            cost=(fused.gate_cost(g)[1], fused.gate_cost(g, True)[1]))
    case["args"] = args
    case["dy"] = t(*args[0].shape)
    return case


def _tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def check_fused(op: str, tag: str, shape: tuple, dtype_name: str,
                seed: int) -> dict:
    """23: one case of a fused kernel against its plain version: the
    forward within ``MODEL_TOL`` (bit-equality reported; the conv's
    asserted), the backward
    within ``GRAD_TOL`` of the written-out backward, each launch counted
    once; then timed: device ms (launches captured in a CUDA graph), call
    ms (eager), the plain forward's ms (the eager chain), the bound (bytes
    over 3.35 TB/s), the library's call where one computes the same
    (``F.rms_norm``; ``F.conv1d`` with groups = di on a (B, di, S) copy of
    u, SiLU not in it: ``library_silu_ms`` beside it), and for the
    backward its device ms, the written-out plain backward's, a forward
    and backward through the op's autograd Function and through the plain
    chain's autograd (``torch.autograd.grad``), and the library's
    (``F.rms_norm``; ``F.conv1d`` with groups = di and ``F.silu`` on the
    (B, di, S) copy).  For rmsnorm's and the conv's backward also each
    launch's device ms (``kernel_split_ms``), the first design's ms at the
    case where PERF.md has it (``FUSED_BWD_BEFORE``, "before"), and the
    device ms of the forward and backward through autograd captured in a
    CUDA graph, the op's Function's and the library's
    (``fwd_bwd_graph_ms``, ``library_fwd_bwd_graph_ms``).  For the conv's
    forward its first design's ms (``FUSED_FWD_BEFORE``, "before") and its
    time over its bound (``x_bound``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    c = fused_case(op, tag, shape, dtype_name, seed)
    ops.reset_launches()
    got = c["fwd"]()
    torch.cuda.synchronize()
    want = c["plain"]()
    ok, err = rel_ok(got, want, MODEL_TOL[("fused", dtype_name)])
    row = {"op": op, "case": tag, "dtype": dtype_name, "shape": list(shape),
           "max_abs_err": err, "bit_equal": bool(torch.equal(got, want)),
           "bound_ms": 1e3 * c["cost"][0] / HBM_BYTES_PER_S,
           "bound_by": "bytes", "bytes": c["cost"][0]}
    del got, want
    if not ok:
        raise AssertionError(f"23 {op} {tag} {dtype_name}: the forward off "
                             f"its plain version by {err}")
    if op == "causal_conv" and not row["bit_equal"]:
        raise AssertionError(f"23 {op} {tag} {dtype_name}: the conv's "
                             f"forward not bit-equal to its plain version "
                             f"(max abs error {err})")
    want_l = {op: 1}
    if c["bwd"] is not None:
        got_b = _tuple(c["bwd"](c["dy"]))
        torch.cuda.synchronize()
        gaps = [grad_gap(a, b) for a, b in zip(
            got_b, _tuple(c["plain_bwd"](c["dy"])), strict=True)]
        row["bwd_max_rel_err"] = max(gaps)
        row["bwd_bound_ms"] = 1e3 * c["cost"][1] / HBM_BYTES_PER_S
        want_l[f"{op}_bwd"] = 1
        del got_b
        if not max(gaps) <= GRAD_TOL[dtype_name]:
            raise AssertionError(f"23 {op} {tag} {dtype_name}: the "
                                 f"backward off its plain version by "
                                 f"{gaps}")
    if {k: n for k, n in ops.launches.items() if n} != want_l:
        raise AssertionError(f"23 {op} {tag}: launched {ops.launches}")
    row["ms"] = graph_ms(c["fwd"], launches=10, replays=3)
    row["call_ms"] = time_ms(c["fwd"], iters=10)
    row["plain_ms"] = time_ms(c["plain"], iters=5)
    row["library_ms"] = (None if c["library"] is None
                         else time_ms(c["library"], iters=10))
    if op == "causal_conv":
        out = c["library"]()
        row["library_silu_ms"] = time_ms(lambda: F.silu(out), iters=10)
        row["before_ms"] = FUSED_FWD_BEFORE.get((op, tag, dtype_name),
                                                "not measured")
        row["x_bound"] = row["ms"] / row["bound_ms"]
        del out
    if c["bwd"] is not None:
        dy = c["dy"]
        row["bwd_ms"] = graph_ms(lambda: c["bwd"](dy), launches=10,
                                 replays=3)
        row["bwd_plain_ms"] = time_ms(lambda: c["plain_bwd"](dy), iters=5)
        leaves = [a.detach().requires_grad_() for a in c["args"]]

        def fwd_bwd(fn):
            return lambda: torch.autograd.grad(fn(*leaves), leaves, dy)
        row["fwd_bwd_ms"] = time_ms(fwd_bwd(c["train"]), iters=5)
        row["chain_fwd_bwd_ms"] = time_ms(fwd_bwd(c["chain"]), iters=5)
        split = op in FUSED_BWD_SPLIT
        if split:   # the pair's device time, captured with its autograd
            row["fwd_bwd_graph_ms"] = graph_ms(fwd_bwd(c["train"]),
                                               launches=5, replays=3)
        if "library_train" in c:
            lleaves = [a.detach().requires_grad_()
                       for a in c.get("library_args", c["args"])]
            ldy = c.get("library_dy", lambda d: d)(dy)

            def lib_pair():
                return torch.autograd.grad(c["library_train"](*lleaves),
                                           lleaves, ldy)
            row["library_fwd_bwd_ms"] = time_ms(lib_pair, iters=5)
            if split:
                row["library_fwd_bwd_graph_ms"] = graph_ms(
                    lib_pair, launches=5, replays=3)
            del lleaves, ldy
        if split:
            row["bwd_split_ms"] = kernel_split_ms(
                lambda: c["bwd"](dy), FUSED_BWD_SPLIT[op], 10)
            row["bwd_before_ms"] = FUSED_BWD_BEFORE.get(
                (op, tag, dtype_name), "not measured")
        del leaves
    del c
    torch.cuda.empty_cache()
    return {k: sig(v) if isinstance(v, float) else v for k, v in row.items()}


def fused_split(rows: list, trained: dict) -> dict:
    """23's split of 13b's (hymba-1.5b) and 16b's (hubert-xlarge) steps by
    layer op: each op's calls a step (``expected_train_launches``, remat
    "full": forwards twice, one backward) times the bf16 rows' times at
    the step's shapes (``FUSED_SPLIT``), through the plain chains as the
    eager step ran them before (forward ms, and the chain's forward and
    backward less its forward) and through the kernels; beside them the
    kernels' device ms in the step's eager split and its remaining "other"
    ms (the elementwise work these four ops do not take)."""
    from repro_torch.configs import get_config
    by = {(r["op"], r["case"]): r for r in rows if r["dtype"] == "bfloat16"}
    out = {}
    for model, ops_ in FUSED_SPLIT.items():
        cfg = get_config(model)
        want = expected_train_launches(cfg)
        split = trained[model]["split"]["device_ms"]
        ops_ms = {}
        for op, shares in ops_.items():
            fwd, bwd = want[op], want[f"{op}_bwd"]
            plain = kern = 0.0
            for tag, share in shares.items():
                r = by[(op, tag)]
                plain += share * (fwd * r["plain_ms"] + bwd * (
                    r["chain_fwd_bwd_ms"] - r["plain_ms"]))
                kern += share * (fwd * r["ms"] + bwd * r["bwd_ms"])
            ops_ms[op] = {"calls": [fwd, bwd], "plain_ms": sig(plain),
                          "kernel_ms": sig(kern)}
        out[model] = {
            "ops": ops_ms,
            "plain_total_ms": sig(sum(v["plain_ms"] for v in ops_ms.values())),
            "kernel_total_ms": sig(sum(v["kernel_ms"]
                                       for v in ops_ms.values())),
            "step_fused_ms": {k: split[k] for k in ("rmsnorm", "rope",
                                                    "conv", "gate")},
            "step_other_ms": split["other"]}
    return out


def fused_phase(trained: dict) -> dict:
    """Phase 23: every case of ``FUSED_CASES`` in bf16 and f32
    (``check_fused``), and the split of 13b's and 16b's steps by layer op
    (``fused_split``)."""
    rows = [check_fused(op, tag, shape, dt, seed=i)
            for i, (op, tag, shape) in enumerate(FUSED_CASES)
            for dt in ("bfloat16", "float32")]
    for r in rows:
        log("[23] " + json.dumps(r))
    split = fused_split(rows, trained)
    log(f"[23] eager steps by layer op: {json.dumps(split)}")
    return {"rows": rows, "split": split}


def main() -> int:
    """Check for a card and a checkout, and run the phases (``phases``)
    beside a spawned process for phase 17's dry runs, stopped at the
    end."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401 -- raises outside a checkout
    with ProcessPoolExecutor(1, multiprocessing.get_context("spawn"),
                             initializer=_cpu_only) as dry_pool:
        return phases(dry_pool)


def phases(dry_pool) -> int:
    """Phases 1-23 (see the module docstring); phase 17's dry runs
    (``dryrun_cells``) run in ``dry_pool`` from the end of the build
    on."""
    import torch
    from repro_torch.core.partition.cost import capacity
    from repro_torch.core.partition.heuristic import (
        fm_refine, greedy_initial, partition_with_replication,
        replicate_local_search)
    from repro_torch.datagen import large_row_net, moe_dataset
    from repro_torch.kernels import _build, front_pass, ops

    # ------------------------------------------------------------ 1. build
    t0 = time.perf_counter()
    libs = sorted(set(SOURCES.values()) | set(ATTN_SOURCES.values())
                  | set(GMM_SOURCES.values()) | set(BWD_KERNELS)
                  | {"adamw", "fused"})
    with ThreadPoolExecutor(len(libs)) as pool:   # nvcc runs outside the GIL
        list(pool.map(_build.load, libs))
    build_s = time.perf_counter() - t0
    dry_future = dry_pool.submit(dryrun_cells)
    log(f"[1] built and loaded "
        f"{', '.join(_build._lib_path(n).name for n in libs)} in "
        f"{build_s:.2f} s")
    for n in _build.PTXAS_REPORT:
        for line in ptxas_summary(_build.build_log.get(n, "")) or [
                "(loaded from an earlier build: no ptxas report)"]:
            log(f"[1] ptxas {n}: {line}")
    summary: dict = {"build_s": sig(build_s)}
    # the general routes' kernels run on the tensor cores: every
    # instantiation's SASS holds HMMA instructions (bf16 and 3xTF32); the
    # libraries' SASS dumped side by side (cuobjdump runs outside the GIL)
    with ThreadPoolExecutor(len(WGMMA_SOURCES) + 2) as pool:
        list(pool.map(sass_lines, [_build._lib_path(n) for n in (
            "flash_attention", "moe_gmm", *WGMMA_SOURCES)]))
    summary["p1_tc_sass"] = {}
    for lib, prefix in (("flash_attention", "flash_kernel"),
                        ("moe_gmm", "gmm_kernel")):
        counts = {n: c for n, c in tc_instructions(
            _build._lib_path(lib)).items() if n.startswith(prefix)}
        log(f"[1] tensor-core instructions (HMMA/HGMMA) in {lib}'s SASS: "
            f"{counts}")
        if not counts or not all(counts.values()):
            raise AssertionError(f"{lib}: an instantiation without tensor-"
                                 f"core instructions: {counts}")
        summary["p1_tc_sass"].update(counts)
    # the bf16 prefill and backward routes run on wgmma: HGMMA in every
    # kernel's SASS, and no spills in ptxas's report; the wgmma shapes of
    # the (80, 80) instantiations reported
    summary["p1_hgmma_80"] = {}
    for lib, prefixes in WGMMA_SOURCES.items():
        counts = {n: c for n, c in tc_instructions(
            _build._lib_path(lib), r"\bHGMMA\.").items()
            if n.startswith(prefixes)}
        log(f"[1] wgmma instructions (HGMMA) in {lib}'s SASS: {counts}")
        if not counts or not all(counts.values()):
            raise AssertionError(f"{lib}: a kernel without HGMMA "
                                 f"instructions: {counts}")
        summary["p1_tc_sass"].update(counts)
        shapes80 = {n: c for n, c in hgmma_shapes(
            _build._lib_path(lib)).items() if SASS_SHAPES_OF in n}
        if shapes80:
            log(f"[1] wgmma shapes of {lib}'s (80, 80) instantiations: "
                f"{shapes80}")
            summary["p1_hgmma_80"].update(shapes80)
        report = _build.build_log.get(lib)
        if report is None:
            log(f"[1] {lib} was loaded from an earlier build: no ptxas "
                f"report to hold to no spills")
            continue
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                             report)]
        if not spills or any(spills):
            raise AssertionError(f"{lib}: ptxas reports spill stores "
                                 f"{spills}")
    card = card_line()
    clock_hz = max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"card: {card}; max SM clock {clock_hz / 1e6:.0f} MHz, {sms} SMs "
        f"(the scan's arithmetic bound: per SM and clock "
        f"{FMA_PER_CLK_PER_SM} FMA-pipe instructions, {EXP_PER_CLK_PER_SM} "
        f"exps on the special-function unit)")
    summary["max_sm_clock_mhz"], summary["sms"] = clock_hz / 1e6, sms
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    # -------------------------------------------- 2. kernels vs plain
    # min_cover_lambdas sees per-front chunks of up to _CHUNK_ELEMS / 2^P
    # rows; the fused find sees phase 3's blocks (R_blk rows each), the
    # active ones from the current position on.
    timed: dict = {}
    hg8 = large_row_net(8192, seed=8192)
    P, eps = 8, 0.05
    dmax = int(np.diff(hg8.xinc).max())
    r_blk = max(front_pass._R_BLK_MIN, front_pass._pow2(P * dmax))
    shapes = [("min_cover_lambdas", r, p) for p in (4, 8)
              for r in (dmax, 4096, 15625, r_blk * 64)]
    log(f"[2] kernels vs plain versions (R_blk = {r_blk} at P = 8)")
    for i, (kernel, R, p) in enumerate(shapes):
        row = check_kernel(kernel, R, p, seed=i)
        timed[(kernel, R, 1 << p)] = row
        log("    " + json.dumps(row))
    find_rows: list = []
    for p in (4, 8):
        m0p = greedy_initial(hg8, p, eps, np.random.default_rng(0))
        for rep in (False, True):
            dev = find_pass(hg8, p, rep, m0p, capacity(hg8, p, eps) + 1e-9,
                            seed=p + rep)
            try:
                for k in (1, 8, 64):
                    for full in (False, True):
                        find_rows.append(check_find(dev, rep, k, full,
                                                    seed=len(find_rows)))
                        log("    " + json.dumps(find_rows[-1]))
            finally:
                dev.detach()
    summary["p2_find"] = {
        f"P{r['P']}{'rep' if r['rep'] else 'fm'}k{r['blocks']}"
        f"{'full' if r['full_scan'] else ''}": [
            sig(r["ms"]), sig(r["bound_ms"]), sig(r["plain_ms"]),
            sig(r["empty_ms"]), r["rows"]] for r in find_rows}
    torch.cuda.empty_cache()

    # the model kernels at hymba's shapes; the f32 plain versions run their
    # products in full f32 (TF32 off for matmuls and cuDNN alike)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[2] attention and scan vs plain versions (TF32 off)")
    model_rows: list = []
    for i, case in enumerate(ATTN_CASES):
        for dtype_name in ("bfloat16", "float32"):
            model_rows.append(check_attention(case, dtype_name, seed=100 + i))
            log("    " + json.dumps(model_rows[-1]))
    for i, case in enumerate(SCAN_CASES):
        for dtype_name in ("bfloat16", "float32"):
            model_rows.append(check_scan(case, dtype_name, seed=200 + i,
                                         clock_hz=clock_hz, sms=sms))
            log("    " + json.dumps(model_rows[-1]))
    for i, case in enumerate(GMM_CASES):
        for dtype_name in ("bfloat16", "float32"):
            model_rows.append(check_gmm(case, dtype_name, seed=300 + i))
            log("    " + json.dumps(model_rows[-1]))
    summary["p2_model"] = {
        f"{r['counter']}:{r['case']}/{r['dtype'][:4]}": [
            sig(r["ms"]), sig(r["bound_ms"]),
            sig(r["plain_ms"]) if "plain_ms" in r else None,
            sig(r["library_ms"]) if r.get("library_ms") else None,
            sig(r["max_abs_err"])]
        for r in model_rows}
    torch.cuda.empty_cache()

    rec = Recorder()

    # ------------------------------------ 3. device pass vs host path
    cap = capacity(hg8, P, eps) + 1e-9
    m0 = greedy_initial(hg8, P, eps, np.random.default_rng(0))
    out = {}
    for frontier in ("torch", "numpy"):
        rec.reset()
        t0 = time.perf_counter()
        masks = fm_refine(hg8, m0.copy(), P, eps, np.random.default_rng(1),
                          frontier=frontier, device="cuda")
        fm_passes = list(rec.passes)
        rep = replicate_local_search(hg8, masks.copy(), P, eps, seed=2,
                                     frontier=frontier, device="cuda")
        torch.cuda.synchronize()
        out[frontier] = (masks, rep, time.perf_counter() - t0,
                         dict(ops.launches), fm_passes, list(rec.passes))
    (mt, rt, st_, lt, fmp, allp), (mn, rn, sn, _, _, _) = \
        out["torch"], out["numpy"]
    if not (np.array_equal(mt, mn) and np.array_equal(rt.masks, rn.masks)
            and rt.cost == rn.cost):
        raise AssertionError("device pass differs from the host path")
    if len(fmp) != 1 or len(allp) != 2:
        raise AssertionError(f"device pass did not attach: {len(allp)}")
    check_bounds(allp, lt)
    check_result(hg8, P, eps, rn)
    log(f"[3] large_row_net(8192) P=8: fm+rep cost {rt.cost} equal on "
        f"cuda ({st_:.2f} s) and numpy ({sn:.2f} s); launches {lt}; "
        f"fm {vars_of(fmp[0])}; rep {vars_of(allp[1])}")
    summary["p3"] = {"cuda_s": sig(st_), "numpy_s": sig(sn), "cost": rt.cost}
    summary["p3b"] = where_time_goes(hg8, P, cap, m0)

    # --------------------------------------------- 4. per-front path (MoE)
    hgm = moe_dataset("moe8", n_layers=1, kappa0=50_000, n_experts=128)[0]
    log(f"[4] moe8 layer 0: n={hgm.n} experts, {len(hgm.edges)} edges, "
        f"{len(hgm.pins)} pins, integer mu: "
        f"{bool(np.all(hgm.mu == np.rint(hgm.mu)))}")
    host4 = dry_pool.submit(host_partition, ("moe8",), P, eps)
    rec.reset()
    rec.shapes.clear()
    t0 = time.perf_counter()
    bm_t, rm_t = partition_with_replication(hgm, P, eps, frontier="torch",
                                            device="cuda")
    torch.cuda.synchronize()
    s4 = time.perf_counter() - t0
    l4 = dict(ops.launches)
    if rec.passes:
        raise AssertionError("float-mu instance attached the device pass")
    bm_n, rm_n, s4n = host4.result()
    if not (np.array_equal(bm_t.masks, bm_n.masks) and bm_t.cost == bm_n.cost
            and np.array_equal(rm_t.masks, rm_n.masks)
            and rm_t.cost == rm_n.cost):
        raise AssertionError("per-front path differs from the host path")
    if l4["min_cover_lambdas"] == 0:
        raise AssertionError("min_cover_lambdas never launched in phase 4")
    check_result(hgm, P, eps, rm_t)
    shapes4 = Counter(rec.shapes)
    max_rows = max(r for (_, r, _) in shapes4)
    log(f"[4] cost {bm_t.cost} -> {rm_t.cost} (replicated), equal on cuda "
        f"({s4:.2f} s) and numpy ({s4n:.2f} s, beside it); launches {l4}; "
        f"front rows: max {max_rows}")
    summary["p4"] = {"cuda_s": sig(s4), "numpy_s": sig(s4n),
                     "base": bm_t.cost, "rep": rm_t.cost, "max_rows": max_rows}

    # --------------------------------------------------- 5. full size
    # 32,768 nodes until PR 33; halved in PR 34 to keep the smoke inside
    # its time limit (phase 5 is host-bound: 59-267 s at 32,768)
    n5 = 16384
    hg5 = large_row_net(n5, seed=n5)
    rec.reset()
    rec.shapes.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b5, r5 = partition_with_replication(hg5, P, eps, frontier="torch",
                                        device="cuda")
    torch.cuda.synchronize()
    s5 = time.perf_counter() - t0
    l5 = dict(ops.launches)
    c5 = rec.counters()
    find5 = rec.find_shape()
    peak = torch.cuda.max_memory_allocated()
    shapes5 = Counter(rec.shapes)
    check_result(hg5, P, eps, b5)
    check_result(hg5, P, eps, r5)
    check_bounds(rec.passes, l5)
    if not r5.cost <= b5.cost:
        raise AssertionError("replication made the cost worse")
    log(f"[5] large_row_net({n5}) P=8: {s5:.2f} s, base cost {b5.cost}, "
        f"replicated cost {r5.cost}, device passes {len(rec.passes)}, "
        f"{c5}, syncs/commit {c5['syncs'] / max(c5['commits'], 1):.4f}, "
        f"find launches {find5}, "
        f"launches {l5}, max_memory_allocated {peak} B")
    summary["p5"] = {"n": n5, "s": sig(s5), "base": b5.cost, "rep": r5.cost,
                     **c5, "syncs_per_commit": sig(c5["syncs"] / max(
                         c5["commits"], 1)), "peak_B": peak, "finds": find5}

    # ------------------------------------------------ 6. serve hymba-1.5b
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_model, make_prompts, serve
    cfg = get_config("hymba-1.5b")
    B6, S6, G6 = 4, 2048, 32
    shapes = ModelShapes()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = serve(cfg, B6, S6, G6, device="cuda", seed=0)
    peak6 = torch.cuda.max_memory_allocated()
    dec6 = served_decode(res, "6")
    r6 = dict(ops.route_launches)
    if any(ops.gmm_route_launches.values()):
        raise AssertionError(f"hymba ran grouped products: "
                             f"{ops.gmm_route_launches}")
    shapes6, routes6 = Counter(shapes.shapes), Counter(shapes.routes)
    l6 = {c: res.launches[c] for c in MODEL_COUNTERS}
    check_routes(r6, l6, "hymba")
    if res.tokens.shape != (B6, G6) or not (
            (res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise AssertionError(f"bad generated tokens {res.tokens.shape}")
    for c in MODEL_COUNTERS[:4]:       # hymba runs all but the MoE kernel
        if l6[c] == 0:
            raise AssertionError(f"{c} never launched while serving")
    want6 = expected_serve_launches(cfg, G6)
    if l6 != want6:
        raise AssertionError(f"serve launched {l6}, expected {want6}")
    log(f"[6] serve {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, bf16): {B6} prompts x {S6} tokens, {G6} new each; "
        f"prefill {res.prefill_s:.4f} s, decode {res.ms_per_token:.4f} "
        f"ms/token ({res.decode}, capture {res.capture_s:.4f} s), "
        f"{res.tokens_per_s:.2f} tok/s, max_memory_allocated "
        f"{peak6} B; launches {l6}; attention routes {r6}; sample "
        f"{res.tokens[0][:8].tolist()}")
    # the scan's share of the prefill: its launches at phase 2's device time
    scan_row = next(r for r in model_rows if r["case"] == "prefill"
                    and r["counter"] == "mamba_scan"
                    and r["dtype"] == "bfloat16")
    scan_ms = l6["mamba_scan"] * scan_row["ms"]
    log(f"[6] the scan in prefill: {l6['mamba_scan']} launches x "
        f"{scan_row['ms']:.6g} ms (phase 2, device time) = {scan_ms:.6g} ms "
        f"of {1e3 * res.prefill_s:.6g} ms")
    # prefill and three teacher-forced decode steps.  The f32 model (its
    # own draw) through the kernels and through the plain versions, within
    # F32_LOGIT_TOL; then its weights overwritten by the bf16 model's, cast,
    # through the plain versions: the reference each bf16 path is held to
    prompts6 = torch.from_numpy(make_prompts(cfg, B6, S6, 0)).cuda()
    # forced tokens drawn apart from the serve run, so that runs on other
    # kernels hold their paths to the same inputs
    forced = torch.from_numpy(make_prompts(cfg, B6, 3, 1)).cuda()
    model32 = make_model(cfg.with_(dtype="float32"), device="cuda", seed=0)
    ops.reset_launches()
    kern32 = logits_through(model32, prompts6, forced, "cuda", S6 + G6)
    r6_f32 = dict(ops.route_launches)     # f32 prefill takes general
    log(f"[6] f32 kernel path, prefill + 3 decode steps: attention routes "
        f"{r6_f32}")
    if not (r6_f32["general"] and r6_f32["decode_split"]):
        raise AssertionError(f"f32 attention routes {r6_f32}")
    plain32 = logits_through(model32, prompts6, forced, "ref", S6 + G6)
    model = make_model(cfg, device="cuda", seed=0)
    same_draw = round_weights(model32, model)
    ref32 = logits_through(model32, prompts6, forced, "ref", S6 + G6)
    del model32
    torch.cuda.empty_cache()
    kern16 = logits_through(model, prompts6, forced, "cuda", S6 + G6)
    plain16 = logits_through(model, prompts6, forced, "ref", S6 + G6)
    summary["p6b"] = decode_profile(model, prompts6, S6 + G6)
    del model
    torch.cuda.empty_cache()
    for name, kern in (("float32", kern32), ("bfloat16", kern16)):
        if not (torch.isfinite(kern).all()
                and kern.shape == (B6, 4, cfg.vocab)):
            raise AssertionError(f"{name} logits not finite or misshapen: "
                                 f"{tuple(kern.shape)}")
    gap32, scale32 = (float((kern32 - plain32).abs().max()),
                      float(plain32.abs().max()))
    if not gap32 <= F32_LOGIT_TOL * scale32:
        raise AssertionError(f"f32 kernel path off the plain path by "
                             f"{gap32} > {F32_LOGIT_TOL} x {scale32}")
    errs6 = bf16_errors(kern16, plain16, ref32)
    log(f"[6] f32 kernel path vs plain path, prefill + 3 decode steps: max "
        f"|diff| {gap32:.6g}, max |logit| {scale32:.6g}, ratio "
        f"{gap32 / scale32:.6g}")
    log(f"[6] bf16 paths against the f32 plain path at the bf16 weights "
        f"(make_model draws the f32 weights the bf16 model rounds: "
        f"{same_draw}), shares of its largest |logit|: kernel "
        f"{errs6['bf16_kernel_err']}, plain {errs6['bf16_plain_err']} "
        f"(ratio {errs6['bf16_err_ratio']}); kernel vs plain in bf16 "
        f"{errs6['bf16_gap']}")
    summary["p6"] = {
        "prefill_s": sig(res.prefill_s), "ms_per_token": sig(
            res.ms_per_token), "tok_s": sig(res.tokens_per_s),
        "peak_B": peak6, "launches": l6, "routes": r6, **dec6,
        "f32_routes": r6_f32, "f32_gap": sig(gap32 / scale32), **errs6,
        "same_draw": same_draw, "scan_prefill_ms": sig(scan_ms)}

    # ----------------------------------------- 7. serve olmoe-1b-7b (MoE)
    from repro_torch.core.placement import SMOKE, drift_replay
    t7 = time.perf_counter()
    cfg7 = get_config("olmoe-1b-7b")
    B7, S7, G7 = 4, 2048, 32
    shapes.shapes.clear()
    shapes.routes.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res7 = serve(cfg7, B7, S7, G7, device="cuda", seed=0,
                 placement="replicated")
    peak7 = torch.cuda.max_memory_allocated()
    dec7 = served_decode(res7, "7")
    r7 = dict(ops.route_launches)
    g7 = dict(ops.gmm_route_launches)
    shapes7, routes7 = Counter(shapes.shapes), Counter(shapes.routes)
    l7 = {c: res7.launches[c] for c in MODEL_COUNTERS}
    check_routes(r7, l7, "olmoe")
    n_moe7 = sum(sg.n_layers for sg in cfg7.segments if sg.kind == "moe")
    check_gmm_routes(g7, l7, n_moe7, G7)
    if res7.tokens.shape != (B7, G7) or not (
            (res7.tokens >= 0) & (res7.tokens < cfg7.vocab)).all():
        raise AssertionError(f"bad generated tokens {res7.tokens.shape}")
    want7 = expected_serve_launches(cfg7, G7)
    if l7 != want7:
        raise AssertionError(f"olmoe serve launched {l7}, expected {want7}")
    pl = res7.placement
    log(f"[7] placement over {pl['n_shards']} shards from the prompts' "
        f"router trace ({pl['seconds']:.3f} s): lambda-cost "
        f"{pl['lambda_cost_no_repl']} -> {pl['lambda_cost_repl']} with "
        f"replication, local fraction {pl['local_fraction_no_repl']:.4f} -> "
        f"{pl['local_fraction_repl']:.4f}; launches while planning "
        f"{pl['launches']}")
    log(f"[7] serve {cfg7.name} ({cfg7.n_layers} layers, d_model "
        f"{cfg7.d_model}, {cfg7.n_experts} experts top-{cfg7.top_k}, bf16): "
        f"{B7} prompts x {S7} tokens, {G7} new each; prefill "
        f"{res7.prefill_s:.4f} s, decode {res7.ms_per_token:.4f} ms/token "
        f"({res7.decode}, capture {res7.capture_s:.4f} s), "
        f"{res7.tokens_per_s:.2f} tok/s, max_memory_allocated {peak7} B; "
        f"launches {l7}; attention routes {r7}; grouped-matmul routes "
        f"{g7}; sample {res7.tokens[0][:8].tolist()}")
    prompts7 = torch.from_numpy(make_prompts(cfg7, B7, S7, 0)).cuda()
    forced7 = torch.from_numpy(make_prompts(cfg7, B7, 3, 1)).cuda()
    # as in phase 6: the f32 model's own draw through both paths, gated;
    # then the bf16 model's weights, cast, through the plain versions
    model32 = make_model(cfg7.with_(dtype="float32"), device="cuda", seed=0)
    ops.reset_launches()
    layer_errs = moe_layer_check(model32, prompts7)
    log(f"[7] f32 MoE block per layer on one input, kernel vs plain: max "
        f"abs err {max(layer_errs):.6g} (a2a and tp, {len(layer_errs)} "
        f"checks within {MODEL_TOL[('gmm', 'float32')]})")
    with RouterLog() as rk:
        kern = logits_through(model32, prompts7, forced7, "cuda", S7 + G7)
    g7_f32 = dict(ops.gmm_route_launches)     # the f32 checks' products
    r7_f32 = dict(ops.route_launches)         # and their attention calls
    log(f"[7] f32 checks (MoE blocks, prefill + 3 decode steps): "
        f"grouped-matmul routes {g7_f32}")
    if not (g7_f32["general"] and g7_f32["gmv"]) or g7_f32["gmm_tc"]:
        raise AssertionError(f"f32 grouped-matmul routes {g7_f32}")
    with RouterLog() as rp:
        plain = logits_through(model32, prompts7, forced7, "ref", S7 + G7)
    gap32, scale32 = (float((kern - plain).abs().max()),
                      float(plain.abs().max()))
    flips = rk.flips(rp)
    if not gap32 <= F32_LOGIT_TOL * scale32:
        log(f"[7] f32 logits off by {gap32} > {F32_LOGIT_TOL} x {scale32}; "
            f"the routers' choices differ in {flips} top-k choices")
        if flips == 0:
            raise AssertionError("f32 kernel path off the plain path with "
                                 "identical routing")
    del plain
    model = make_model(cfg7, device="cuda", seed=0)
    same_draw7 = round_weights(model32, model)
    ref32 = logits_through(model32, prompts7, forced7, "ref", S7 + G7)
    del model32
    torch.cuda.empty_cache()
    summary["p7b"] = decode_profile(model, prompts7, S7 + G7, tag="7b")
    kern16 = logits_through(model, prompts7, forced7, "cuda", S7 + G7)
    plain16 = logits_through(model, prompts7, forced7, "ref", S7 + G7)
    del model
    for name, k in (("float32", kern), ("bfloat16", kern16)):
        if not (torch.isfinite(k).all() and k.shape == (B7, 4, cfg7.vocab)):
            raise AssertionError(f"{name} logits not finite or misshapen: "
                                 f"{tuple(k.shape)}")
    errs7 = bf16_errors(kern16, plain16, ref32)
    del kern, kern16, plain16, ref32
    torch.cuda.empty_cache()
    log(f"[7] f32 kernel path vs plain path, prefill + 3 decode steps: max "
        f"|diff| {gap32:.6g} of max |logit| {scale32:.6g} (ratio "
        f"{gap32 / scale32:.6g})")
    log(f"[7] bf16 paths against the f32 plain path at the bf16 weights "
        f"(make_model draws the f32 weights the bf16 model rounds: "
        f"{same_draw7}), shares of its largest |logit|: kernel "
        f"{errs7['bf16_kernel_err']}, plain {errs7['bf16_plain_err']} "
        f"(ratio {errs7['bf16_err_ratio']}); kernel vs plain in bf16 "
        f"{errs7['bf16_gap']}")
    replay = {}
    for drift in (0.8, 0.0):
        t0 = time.perf_counter()
        on_card = drift_replay(**SMOKE, drift_rate=drift, device="cuda")
        s_card = time.perf_counter() - t0
        host = drift_replay(**SMOKE, drift_rate=drift, frontier="numpy")
        if on_card["policies"] != host["policies"]:
            raise AssertionError(f"drift {drift}: the replay on CUDA "
                                 f"{on_card['policies']} != host "
                                 f"{host['policies']}")
        pol = on_card["policies"]
        replay[drift] = [pol[k]["comm_cost"] for k in pol] + [
            pol["online_replicated"]["commits"],
            pol["online_replicated"]["migration_bytes"]]
        log(f"[7] SMOKE drift replay, drift {drift}: {pol}, equal on CUDA "
            f"({s_card:.2f} s) and the host path")
    s7 = time.perf_counter() - t7
    log(f"[7] phase 7 took {s7:.2f} s")
    summary["p7"] = {
        "prefill_s": sig(res7.prefill_s), "ms_per_token": sig(
            res7.ms_per_token), "tok_s": sig(res7.tokens_per_s),
        "peak_B": peak7, "launches": l7, "routes": r7, "gmm_routes": g7,
        **dec7,
        "f32_gmm_routes": g7_f32, "f32_routes": r7_f32,
        "lam_cost": [pl["lambda_cost_no_repl"], pl["lambda_cost_repl"]],
        "plan_launches": pl["launches"]["min_cover_lambdas"],
        "layer_err": sig(max(layer_errs)), "f32_gap": sig(gap32 / scale32),
        "route_flips": flips, **errs7, "same_draw": same_draw7,
        "replay": {str(k): v for k, v in replay.items()}, "s": sig(s7)}

    # ------------------------------------------------ 8. the V-cycle
    t8 = time.perf_counter()
    summary["p8"] = vcycle_phase(rec, P, eps, VCYCLE_N, dry_pool)
    log(f"[8] phase 8 took {time.perf_counter() - t8:.2f} s")
    torch.cuda.empty_cache()

    # ------------------------------------ 9. scheduling with replication
    t9 = time.perf_counter()
    summary["p9"] = schedule_phase(P=8, g=4.0, L=20.0, n_ml=16384)
    log(f"[9] phase 9 took {time.perf_counter() - t9:.2f} s")

    # ------------------------------------- 10. hubert-xlarge's encoder
    t10 = time.perf_counter()
    summary["p10"] = hubert_phase(B=8, S=1500)
    hub_row = next(r for r in model_rows if r["case"] == "hubert"
                   and r["dtype"] == "bfloat16")
    n10 = summary["p10"]["launches"]["flash_attention"]
    attn_ms = n10 * hub_row["ms"]
    summary["p10"]["attention_ms"] = sig(attn_ms)
    log(f"[10] attention in the forward: {n10} launches x "
        f"{hub_row['ms']:.6g} ms (phase 2, device time) = {attn_ms:.6g} ms "
        f"of {1e3 * summary['p10']['forward_s']:.6g} ms")
    log(f"[10] phase 10 took {time.perf_counter() - t10:.2f} s")

    # ------------------------------------------- 11. serve deepseek-v3
    t11 = time.perf_counter()
    p11 = deepseek_phase(shapes, B=4, S=2048, G=32, B_gate=1)
    shapes11, routes11 = p11.pop("shapes"), p11.pop("model_routes")
    l11, r11, g11 = p11["launches"], p11["routes"], p11["gmm_routes"]
    ds_row = next(r for r in model_rows if r["case"] == "deepseek_prefill"
                  and r["dtype"] == "bfloat16")
    p11["attention_ms"] = sig(l11["flash_attention"] * ds_row["ms"])
    log(f"[11] prefill attention: {l11['flash_attention']} launches x "
        f"{ds_row['ms']:.6g} ms (phase 2, device time) = "
        f"{p11['attention_ms']:.6g} ms of {1e3 * p11['prefill_s']:.6g} ms")
    p11["s"] = sig(time.perf_counter() - t11)
    summary["p11"] = p11
    log(f"[11] phase 11 took {p11['s']:.2f} s")

    # --------------------------------- 12. serve llama-3.2-vision-11b
    t12 = time.perf_counter()
    p12 = vision_phase(shapes, B=4, S=2048, G=32)
    shapes12, routes12 = p12.pop("shapes"), p12.pop("model_routes")
    l12, r12 = p12["launches"], p12["routes"]
    # the prefill calls at phase 2's device times: self and cross
    vis_ms = {c: next(r["ms"] for r in model_rows if r["case"] == c
                      and r["dtype"] == "bfloat16")
              for c in ("vision_prefill", "vision_cross_prefill")}
    n_cross = 2 * sum(sg.n_layers for sg in get_config(
        "llama-3.2-vision-11b").segments)
    p12["attention_ms"] = sig(n_cross * vis_ms["vision_cross_prefill"] + (
        r12["prefill_tc"] - n_cross) * vis_ms["vision_prefill"])
    log(f"[12] prefill attention: {r12['prefill_tc'] - n_cross} self x "
        f"{vis_ms['vision_prefill']:.6g} ms + {n_cross} cross x "
        f"{vis_ms['vision_cross_prefill']:.6g} ms (phase 2, device time) = "
        f"{p12['attention_ms']:.6g} ms of {1e3 * p12['prefill_s']:.6g} ms")
    p12["s"] = sig(time.perf_counter() - t12)
    summary["p12"] = p12
    log(f"[12] phase 12 took {p12['s']:.2f} s")

    # ------------------------------------------ 13. training hymba-1.5b
    t13 = time.perf_counter()
    p13 = train_phase(clock_hz, sms)
    p13["s"] = sig(time.perf_counter() - t13)
    log(f"[13] phase 13 took {p13['s']:.2f} s")
    summary["p13"] = {k: v for k, v in p13.items()
                      if k not in ("attn_rows", "scan_rows")}
    summary["p13"]["bwd"] = {
        f"{r['case']}/{r['dtype'][:4]}": [
            sig(r["ms"]), sig(r["bound_ms"]), sig(r["plain_ms"]),
            sig(r["library_ms"]) if r.get("library_ms") else None,
            sig(r["max_abs_err"]),
            sig(r["before_ms"]) if "before_ms" in r else None]
        for r in p13["attn_rows"] + p13["scan_rows"]}

    # --------------------------------------- 14. training olmoe-1b-7b
    t14 = time.perf_counter()
    p14 = moe_train_phase()
    p14["s"] = sig(time.perf_counter() - t14)
    log(f"[14] phase 14 took {p14['s']:.2f} s")
    summary["p14"] = {k: v for k, v in p14.items()
                      if k not in ("gmm_rows", "attn_rows")}
    summary["p14"]["bwd"] = {
        f"{r['case']}/{r['dtype'][:4]}": [
            sig(r["ms"]), sig(r["bound_ms"]), sig(r["plain_ms"]),
            sig(r["library_ms"]), sig(r["max_abs_err"]),
            sig(r["before_ms"]) if "before_ms" in r else None]
        + ([sig(r["dx_ms"]), sig(r["dw_ms"])] if "dx_ms" in r else [])
        for r in p14["gmm_rows"] + p14["attn_rows"]}

    # ---------------------------------------- 15. training deepseek-v3
    t15 = time.perf_counter()
    p15 = deepseek_train_phase()
    p15["s"] = sig(time.perf_counter() - t15)
    log(f"[15] phase 15 took {p15['s']:.2f} s")
    summary["p15"] = {k: v for k, v in p15.items() if k != "attn_rows"}
    summary["p15"]["bwd"] = {
        f"{r['case']}/{r['dtype'][:4]}": [
            sig(r["ms"]), sig(r["bound_ms"]), sig(r["plain_ms"]),
            sig(r["library_ms"]), sig(r["max_abs_err"]), r["sdpa_backend"]]
        for r in p15["attn_rows"]}

    # ------------------------------------- 16. training hubert-xlarge
    t16 = time.perf_counter()
    p16 = hubert_train_phase()
    p16["s"] = sig(time.perf_counter() - t16)
    log(f"[16] phase 16 took {p16['s']:.2f} s")
    summary["p16"] = {k: v for k, v in p16.items() if k != "attn_rows"}
    summary["p16"]["bwd"] = {
        f"{r['case']}/{r['dtype'][:4]}": [
            sig(r["ms"]), sig(r["bound_ms"]), sig(r["plain_ms"]),
            sig(r["library_ms"]), sig(r["max_abs_err"]), r["sdpa_backend"]]
        for r in p16["attn_rows"]}
    train_phases = (p13, p14, p15, p16)

    # ------------------------------------------------------ 17. tools
    t17 = time.perf_counter()
    trained = dict(zip([c[0] for c in dryrun_train_cells()], train_phases))
    dry = dry_future.result()
    log(f"[17] dry runs ready {time.perf_counter() - t17:.2f} s after "
        f"phase 16")
    p17 = {"a": dryrun_phase(dry, trained),
           "b": roofline_phase(summary, trained),
           "c": remat_phase(dry, trained)}
    p17["s"] = sig(time.perf_counter() - t17)
    log(f"[17] phase 17 took {p17['s']:.2f} s")
    summary["p17"] = p17

    # ---------------------------------------------- 18. distribution
    t18 = time.perf_counter()
    p18 = mesh_phase(B7, S7, G7)
    p18["s"] = sig(time.perf_counter() - t18)
    log(f"[18] phase 18 took {p18['s']:.2f} s")
    summary["p18"] = {"a": p18["a"], "b": p18["b"], "s": p18["s"],
                      "c": {k: v for k, v in p18["c"].items()}}

    # -------------------------------------- 19. tensor-parallel products
    t19 = time.perf_counter()
    p19 = tp_phase(dry)
    p19["s"] = sig(time.perf_counter() - t19)
    log(f"[19] phase 19 took {p19['s']:.2f} s")
    summary["p19"] = {"a": {k: p19["a"][k] for k in (
        "losses", "median_step_s", "tokens_per_s", "peak_B", "n_params",
        "routes", "bwd_routes", "split")},
        "b": [{k: r[k] for k in ("held_B", "peak_B", "losses",
                                 "median_step_s", "tokens_per_s",
                                 "stream_allreduces", "collectives",
                                 "counted_over_step_cost")}
              for r in p19["b"]], "c": p19["c"], "s": p19["s"]}

    # -------------------------------------------- 20. the sequence split
    t20 = time.perf_counter()
    p20 = seq_phase(dry)
    p20["s"] = sig(time.perf_counter() - t20)
    log(f"[20] phase 20 took {p20['s']:.2f} s")
    summary["p20"] = {
        "k": [{k: r[k] for k in (
            "dtype", "q_off", "ms", "rank0_ms", "bound_ms", "plain_ms",
            "library_ms", "bwd_ms", "bwd_bound_ms", "bwd_plain_ms",
            "library_fwd_bwd_ms", "max_abs_err", "bwd_max_err")}
            for r in p20["k"]],
        "a": {k: p20["a"][k] for k in (
            "losses", "median_step_s", "tokens_per_s", "peak_B",
            "n_params", "routes", "bwd_routes")},
        "b": [{k: r[k] for k in ("q_off", "peak_B", "losses",
                                 "median_step_s", "tokens_per_s",
                                 "collectives", "attn_device_ms")}
              for r in p20["b"]],
        "imbalance": p20["imbalance"], "c": p20["c"], "d": p20["d"],
        "s": p20["s"]}

    # --------------------------------------- 21. the Mamba mixer's blocks
    t21 = time.perf_counter()
    p21 = falcon_phase(dry, clock_hz, sms)
    p21["s"] = sig(time.perf_counter() - t21)
    log(f"[21] phase 21 took {p21['s']:.2f} s")
    summary["p21"] = {
        "k": [{k: r.get(k) for k in (
            "case", "dtype", "shape", "ms", "call_ms", "bound_ms",
            "bound_by", "plain_ms", "max_abs_err", "segments",
            "segment_steps", "last_segment_steps", "pass_ms", "scan_cost")}
            for r in p21["k"]],
        "serve": p21["serve"],
        "a": {k: p21["a"][k] for k in (
            "losses", "median_step_s", "tokens_per_s", "peak_B", "n_params",
            "per_step_launches", "dry", "roofline", "scan_device_ms",
            "split")},
        "b": [{k: r[k] for k in ("held_B", "peak_B", "losses",
                                 "median_step_s", "tokens_per_s",
                                 "collectives", "counted_over_step_cost",
                                 "scan_device_ms", "scan_over_21a")}
              for r in p21["b"]], "c": p21["c"], "s": p21["s"]}

    # ------------------------------ 22. training as one captured step
    t22 = time.perf_counter()
    p22 = graph_phase()
    p22["s"] = sig(time.perf_counter() - t22)
    log(f"[22] phase 22 took {p22['s']:.2f} s")
    summary["p22"] = {"a": p22["a"], "b": p22["b"],
                      "c": {k: v for k, v in p22["c"].items()
                            if k != "gaps"}, "s": p22["s"]}
    summary["train_graph"] = {
        tag: {k: p[k] for k in ("mode", "first_step_s", "capture_s",
                                "graph_pool_B", "median_step_s", "peak_B",
                                "head")}
        for tag, p in (("13b", p13), ("14b", p14), ("15b", p15),
                       ("16b", p16), ("19a", p19["a"]), ("20a", p20["a"]),
                       ("21a", p21["a"]))}
    for tag, row in summary["train_graph"].items():
        if row["mode"] != "graph":
            raise AssertionError(f"{tag} trained {row['mode']}")

    # --------------------------------- 23. the fused elementwise kernels
    t23 = time.perf_counter()
    p23 = fused_phase({"hymba-1.5b": p13, "hubert-xlarge": p16})
    p23["s"] = sig(time.perf_counter() - t23)
    log(f"[23] phase 23 took {p23['s']:.2f} s")
    summary["p23"] = {"rows": [{k: r.get(k) for k in (
        "op", "case", "dtype", "max_abs_err", "bit_equal", "bwd_max_rel_err",
        "ms", "call_ms", "plain_ms", "bound_ms", "library_ms", "bwd_ms",
        "bwd_plain_ms", "bwd_bound_ms", "fwd_bwd_ms", "chain_fwd_bwd_ms",
        "library_fwd_bwd_ms", "bwd_split_ms", "bwd_before_ms", "before_ms",
        "x_bound", "fwd_bwd_graph_ms", "library_fwd_bwd_graph_ms")}
        for r in p23["rows"]], "split": p23["split"], "s": p23["s"]}
    summary["train_split_fused"] = {
        tag: {k: p["split"]["device_ms"][k] for k in (
            "rmsnorm", "rope", "conv", "gate", "other")}
        for tag, p in (("13b", p13), ("14b", p14), ("15b", p15),
                       ("16b", p16), ("19a", p19["a"]), ("20a", p20["a"]),
                       ("21a", p21["a"])) if "split" in p}

    # ----------------------------------------------------- kernel line
    launches = {k: l4[k] + l5[k] for k in l4}
    shapes_all = shapes4 + shapes5
    log(f"launch shapes (counter, R, M): count, phases 4+5: "
        f"{dict(shapes_all.most_common(12))}")
    kernels = []
    for name, kernel in KERNEL_OF.items():
        if name in MODEL_COUNTERS:
            continue
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")
        if name == "front_find":
            kernels.append(find_entry(find_rows, launches[name], find5,
                                      summary["p3b"]))
            continue
        # time each count's kernel at its most frequent shape on the path
        (_, R, M), _ = max(((s, c) for s, c in shapes_all.items()
                            if s[0] == name), key=lambda sc: sc[1])
        row = timed.get((kernel, R, M))
        if row is None:
            row = check_kernel(kernel, R, M.bit_length() - 1, seed=99)
            timed[(kernel, R, M)] = row
            log("    " + json.dumps(row))
        errs = [r["max_abs_err"] for (k, _, _), r in timed.items()
                if k == kernel]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{SOURCES[kernel]}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(errs), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": [R, M], "call_ms": row["call_ms"]})
    # the partition kernels' launches on the V-cycle's path (phase 8)
    for k in kernels:
        k["vcycle_launches"] = summary["p8"]["launches"].get(k["name"], 0)
    shapes_model = shapes6 + shapes7 + shapes11 + shapes12
    log(f"model kernel launch shapes (counter, key, dtype): count, phases "
        f"6, 7, 11, 12: {dict(shapes_model.most_common(14))}")
    def timed_row(counter, key, dt, route=None, fill=False):
        rows = [r for r in model_rows if r["counter"] == counter
                and r["dtype"] == dt.removeprefix("torch.")
                and "plain_ms" in r and r["key"] == key
                and route in (None, r.get("route"))
                and r.get("fill", False) == fill]
        if not rows:
            raise AssertionError(f"{counter} {route}: its commonest shape "
                                 f"{key} {dt} was not timed in phase 2")
        return rows[0]

    def row_fields(row):
        return {"max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": row["shape"], "dtype": row["dtype"],
                "call_ms": row["call_ms"]}

    def second(case, dtype, prefix):   # another path shape of a kernel
        r = next(r for r in model_rows if r["case"] == case
                 and r["dtype"] == dtype)
        return {f"{prefix}_{k}": r[k] for k in (
            "ms", "bound_ms", "plain_ms", "library_ms", "call_ms")}

    # attention: one entry per (count, route) of the bf16 serve runs, and
    # general's two below.  In the serve runs every plain call is a
    # prefill (prefill_tc) but phase 12's cross decode calls (decode_split,
    # counted there), and every masked decode call decode_split, so the
    # serve counts split by route as below (``ModelShapes`` also sees the
    # placement planner's calls: it only picks the commonest shape)
    routes_model = routes6 + routes7 + routes11 + routes12
    log(f"attention calls by (counter, route, key, dtype), phases 6, 7, "
        f"11, 12, planner included: {dict(routes_model)}")
    plain_decode = p12["cross_decode"]
    n_plain = (l6["flash_attention"] + l7["flash_attention"]
               + l11["flash_attention"] + l12["flash_attention"]
               - plain_decode)
    serve_routes = [r6, r7, r11, r12]
    by_route = {
        ("flash_attention", "prefill_tc"): n_plain,
        ("flash_attention", "decode_split"): plain_decode,
        ("attention_masked", "prefill_tc"):
            sum(r["prefill_tc"] for r in serve_routes) - n_plain,
        ("attention_masked", "decode_split"):
            sum(r["decode_split"] for r in serve_routes) - plain_decode}
    for counter, route in ATTN_PATH:
        key, dt = commonest(routes_model, (counter, route))
        row = timed_row(counter, key, dt, route)
        kernels.append({
            "name": f"{counter}:{route}", "route": "cuda",
            "attn_route": route,
            "source": f"src/repro_torch/kernels/csrc/"
                      f"{ATTN_SOURCES[route]}.cu",
            "replaces": REPLACES[counter],
            "launches": by_route[(counter, route)], **row_fields(row)})
        if (counter, route) == ("flash_attention", "prefill_tc"):
            for case, prefix in (("prefill", "hymba"),
                                 ("olmoe_prefill", "olmoe"),
                                 ("deepseek_prefill", "deepseek"),
                                 ("hd192_v128", "hd192_v128"),
                                 ("vision_cross_prefill", "vision_cross")):
                kernels[-1].update(second(case, row["dtype"], prefix))
        if (counter, route) == ("attention_masked", "decode_split"):
            kernels[-1].update(second("olmoe_decode", row["dtype"],
                                      "olmoe"))
            kernels[-1].update(second("decode_window", row["dtype"],
                                      "hymba"))
    # hubert's bf16 forward on prefill_tc at (80, 80): phase 10's counted
    # and timed forwards, phase 16b's training launches beside; the
    # general kernel's bf16 at its call, the route it took before, as
    # "before" (phase 2), and phase 10's forwards on either route
    p10 = summary["p10"]
    row = next(r for r in model_rows if r["case"] == "hubert"
               and r["dtype"] == "bfloat16")
    kernels.append({
        "name": "flash_attention:prefill_tc:hubert", "route": "cuda",
        "attn_route": "prefill_tc",
        "source": f"src/repro_torch/kernels/csrc/"
                  f"{ATTN_SOURCES['prefill_tc']}.cu",
        "replaces": REPLACES["flash_attention"],
        "launches": p10["prefill_tc_launches_bf16"],
        "launches_from": "phase 10, the bf16 forwards (counted and timed)",
        "train_launches": p16["launches"]["flash_attention"],
        **row_fields(row),
        **{k: row[k] for k in ("before_ms", "before_call_ms",
                               "before_max_abs_err", "before_route")},
        "forward_s": p10["forward_s"],
        "forward_before_s": p10["forward_before_s"]})
    # the general route, timed at hubert's f32 call: its commonest shape
    # (48 calls a forward; the f32 paths of phases 6, 7, 11 and 12 make
    # 32, 16, 2 and 80 in all); no bf16 call of a path takes it
    row = next(r for r in model_rows if r["case"] == "hubert"
               and r["dtype"] == "float32")
    kernels.append({
        "name": "attention:general:f32", "route": "cuda",
        "attn_route": "general",
        "source": f"src/repro_torch/kernels/csrc/"
                  f"{ATTN_SOURCES['general']}.cu",
        "replaces": REPLACES["flash_attention"],
        "launches": (r6_f32["general"] + r7_f32["general"]
                     + p10["f32_routes"]["general"]
                     + p11["f32_routes"]["general"]
                     + p12["f32_routes"]["general"]),
        "launches_from": "the f32 kernel paths of phases 6, 7, 10, 11 and "
                         "12", **row_fields(row)})
    for case, prefix in (("prefill", "hymba"), ("olmoe_prefill", "olmoe"),
                         ("hd192_v128", "hd192_v128"),
                         ("deepseek_prefill", "deepseek"),
                         ("vision_prefill", "vision"),
                         ("vision_cross_prefill", "vision_cross")):
        kernels[-1].update(second(case, "float32", prefix))
    for name in ("mamba_scan", "mamba_step"):
        key, dt = commonest(shapes_model, name)
        row = timed_row(name, key, dt)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/"
                      f"{SOURCES[KERNEL_OF[name]]}.cu",
            "replaces": REPLACES[name], "launches": l6[name] + l7[name],
            **row_fields(row), "bound_terms_ms": row["bound_terms_ms"],
            "exp_sfu_share": row["exp_sfu_share"]})
        if "empty_ms" in row:
            kernels[-1]["empty_ms"] = row["empty_ms"]
    # grouped matmul: one entry per route of the bf16 serve runs, timed at
    # the fill-aware case of its commonest path shape (the path hands the
    # kernel the slot fills), the full buffers and deepseek's shapes beside
    # it; and general with the launches of the f32 checks of phases 7 and
    # 11
    gmm_launches = {r: g7[r] + g11[r] for r in g7}
    gmm_launches["general"] = (g7_f32["general"]
                               + p11["f32_gmm_routes"]["general"])
    for route in GMM_PATH + ("general",):
        if route == "general":
            key, dt = (64, 2560, 2048, 1024), "float32"
        else:
            key, dt = commonest(routes_model, ("grouped_matmul", route))
        row = timed_row("grouped_matmul", key, dt, route, fill=True)
        full = timed_row("grouped_matmul", key, dt, route)
        kernels.append({
            "name": f"grouped_matmul:{route}", "route": "cuda",
            "gmm_route": route,
            "source": f"src/repro_torch/kernels/csrc/{GMM_SOURCES[route]}.cu",
            "replaces": REPLACES["grouped_matmul"],
            "launches": gmm_launches[route], **row_fields(row),
            "live_rows": row["live_rows"], "live_slots": row["live_slots"],
            **{f"full_{k}": full[k] for k in (
                "ms", "bound_ms", "plain_ms", "library_ms", "call_ms")}})
        if route == "general":
            kernels[-1]["launches_from"] = "phases 7 and 11, f32 checks"
            kernels[-1].update(second("ds_prefill_gate_up_fill",
                                      row["dtype"], "deepseek"))
        elif route == "gmm_tc":           # also the down product's shape
            kernels[-1].update(second("prefill_down_fill", row["dtype"],
                                      "down"))
            kernels[-1].update(second("prefill_down", row["dtype"],
                                      "down_full"))
            kernels[-1].update(second("ds_prefill_gate_up_fill",
                                      row["dtype"], "deepseek"))
            kernels[-1].update(second("ds_prefill_down_fill", row["dtype"],
                                      "deepseek_down"))
        else:
            kernels[-1].update(second("ds_decode_fill", row["dtype"],
                                      "deepseek"))
            kernels[-1].update(second("ds_decode_down_fill", row["dtype"],
                                      "deepseek_down"))
    # the backward kernels: the launches of the training steps of phases
    # 13b, 14b, 15b and 16b, timed at hymba's training shapes in bf16 (the
    # windowed attention call, 29 of 32 a step; the global one, f32,
    # olmoe's head dim 128 from phase 14a, deepseek's MLA call at (192,
    # 128) from phase 15a and hubert's non-causal call at (80, 80) from
    # phase 16a beside it)
    # the attention and grouped-matmul entries carry the bf16 route's
    # (``tc``) kernel and times (the grouped matmul's with its first
    # kernels' bf16 times as "before") and the f32 (``general``) rows
    # beside them, SDPA's backward alone beside the attention rows
    def tagged(r, tag):
        return {f"{tag}_{k}": r.get(k) for k in (
            "ms", "bound_ms", "plain_ms", "library_ms", "library_bwd_ms",
            "call_ms", "before_ms", "bound6_ms") if k in r}
    bwd_sources = {"attention_bwd": ("attention_bwd_tc", "attention_bwd"),
                   "mamba_scan_bwd": ("mamba_scan_bwd", None)}
    for name, rows in (("attention_bwd", p13["attn_rows"]),
                       ("mamba_scan_bwd", p13["scan_rows"])):
        row = next(r for r in rows if r["dtype"] == "bfloat16"
                   and r.get("window", 1024) == 1024)
        src, general = bwd_sources[name]
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{src}.cu",
                 "replaces": BWD_REPLACES[name],
                 "launches": sum(p["launches"][name]
                                 for p in train_phases),
                 "launches_from": "phases 13b, 14b, 15b and 16b, 5 "
                                  "training steps each",
                 **row_fields(row),
                 "max_abs_err": max(r["max_abs_err"] for r in rows)}
        if general:
            entry.update(
                general_source=f"src/repro_torch/kernels/csrc/{general}.cu",
                bwd_route_launches={
                    k: sum(p["bwd_routes"].get(k, 0) for p in train_phases)
                    for k in p13["bwd_routes"] if k.startswith("attention")},
                bound6_ms=row["bound6_ms"],
                library_bwd_ms=row["library_bwd_ms"],
                fwd_lse_ms=row["fwd_lse_ms"])
        for r in rows:
            if r is row:
                continue
            tag = "_".join(x for x in (
                {0: "global", 1024: "window"}.get(r.get("window"), ""),
                "f32" if r["dtype"] == "float32" else "") if x)
            entry.update(tagged(r, tag))
        if name == "mamba_scan_bwd":
            entry.update({k: row[k] for k in (
                "bound_terms_ms", "exp_sfu_share", "segments",
                "segment_steps", "pass_ms")})
        else:
            entry["library_fwd_ms"] = row["library_fwd_ms"]
            entry["fwd_ms"] = row["fwd_ms"]
            for r in p14["attn_rows"]:
                tag = "olmoe" + ("_f32" if r["dtype"] == "float32" else "")
                entry.update(tagged(r, tag))
                entry[f"{tag}_max_abs_err"] = r["max_abs_err"]
            for model, p in (("deepseek", p15), ("hubert", p16)):
                for r in p["attn_rows"]:
                    tag = model + ("_f32" if r["dtype"] == "float32"
                                   else "")
                    entry.update(tagged(r, tag))
                    entry.update({f"{tag}_{k}": r[k] for k in (
                        "max_abs_err", "shape", "causal", "sdpa_backend",
                        "library_fwd_ms", "library_bwd_ms", "fwd_ms")})
        kernels.append(entry)
    # the grouped matmul's backward: phase 14b's launches (one per call,
    # dx and dw), timed at the bf16 gate/up product at the fills (dx and dw
    # apart beside it), the down product, f32 and every row live beside
    rows = p14["gmm_rows"]
    row = next(r for r in rows if r["dtype"] == "bfloat16"
               and r["case"] == "train_gate_up_fill")
    entry = {"name": "grouped_matmul_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/moe_gmm_bwd_tc.cu",
             "general_source": "src/repro_torch/kernels/csrc/moe_gmm_bwd.cu",
             "replaces": BWD_REPLACES["grouped_matmul_bwd"],
             "launches": p14["launches"]["grouped_matmul_bwd"],
             "launches_from": "phase 14b, 5 training steps",
             "bwd_route_launches": {k: n for k, n in
                                    p14["bwd_routes"].items()
                                    if k.startswith("gmm")},
             **row_fields(row),
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "live_rows": row["live_rows"]}
    for k in ("dx_ms", "dw_ms", "dx_bound_ms", "dw_bound_ms",
              "library_dx_ms", "library_dw_ms", "before_ms", "before_dx_ms",
              "before_dw_ms"):
        entry[k] = row[k]
    for r in rows:
        if r is row:
            continue
        tag = "_".join(x for x in (
            "down" if "down" in r["case"] else "",
            "full" if not r["fill"] else "",
            "f32" if r["dtype"] == "float32" else "") if x)
        entry.update(tagged(r, tag))
        entry[f"{tag}_dx_ms"], entry[f"{tag}_dw_ms"] = r["dx_ms"], r["dw_ms"]
        for k in ("before_dx_ms", "before_dw_ms"):
            if k in r:
                entry[f"{tag}_{k}"] = r[k]
    kernels.append(entry)
    # the forward kernels' launches in training (phases 13b, 14b and 15b;
    # 16b's on hubert's entry) beside the serve runs' counts above
    for k in kernels:
        c = k["name"].split(":")[0]
        if c in ("flash_attention", "attention_masked", "mamba_scan") and \
                k.get("attn_route", "prefill_tc") == "prefill_tc" and \
                "train_launches" not in k:
            k["train_launches"] = sum(p["launches"][c]
                                      for p in (p13, p14, p15))
        if k["name"] == "grouped_matmul:gmm_tc":
            k["train_launches"] = p14["launches"]["grouped_matmul"]
    # the distribution path's launches, per rank of phase 18b (each of its
    # kernels launched on both ranks)
    for k in kernels:
        route = MESH_KERNELS.get(k["name"])
        if route is None:
            continue
        table = "gmm_routes" if route in GMM_PATH else "attn_routes"
        k["mesh_launches_per_rank"] = [rk[table][route] for rk in p18["b"]]
        k["mesh_launches_from"] = ("phase 18b, olmoe-1b-7b served by two "
                                   "ranks of a (1, 2) mesh")
        if min(k["mesh_launches_per_rank"]) < 1:
            raise AssertionError(f"18b: {k['name']} was not launched on "
                                 f"every rank: {k['mesh_launches_per_rank']}")
    # the tensor-parallel path's launches, per rank of phase 19b
    for k in kernels:
        if k["name"] not in TP_KERNELS:
            continue
        table, route = TP_KERNELS[k["name"]]
        k["tp_launches_per_rank"] = [r[table][route] for r in p19["b"]]
        k["tp_launches_from"] = (f"phase 19b, deepseek-7b ({DS7_LAYERS} "
                                 f"layers) trained by two ranks of a (1, 2) "
                                 f"mesh, {TRAIN_STEPS} steps")
        if min(k["tp_launches_per_rank"]) < 1:
            raise AssertionError(f"19b: {k['name']} was not launched on "
                                 f"every rank: {k['tp_launches_per_rank']}")
    # the sequence split's launches, per rank of phase 20b, and phase
    # 20k's rows at rank 1's call (q_off 2048): prefill_tc and the tc
    # backward in bf16, general's forward and backward in f32
    k20 = {r["dtype"]: r for r in p20["k"]}

    def seq_fields(r, tag, which):
        keys = {"fwd": ("ms", "bound_ms", "plain_ms", "library_ms",
                        "max_abs_err", "rank0_ms"),
                "bwd": ("bwd_ms", "bwd_bound_ms", "bwd_plain_ms",
                        "library_fwd_bwd_ms", "bwd_max_err")}[which]
        return {f"{tag}_{k}": r[k] for k in keys} | {
            f"{tag}_q_off": r["q_off"], f"{tag}_shape": r["shape"]}
    for k in kernels:
        if k["name"] in SEQ_KERNELS:
            table, route = SEQ_KERNELS[k["name"]]
            k["seq_launches_per_rank"] = [r[table][route] for r in p20["b"]]
            k["seq_launches_from"] = (
                f"phase 20b, smollm-135m trained by two ranks of a (1, 2) "
                f"mesh on their blocks of {SEQ_S} tokens, {TRAIN_STEPS} "
                f"steps")
            if min(k["seq_launches_per_rank"]) < 1:
                raise AssertionError(f"20b: {k['name']} was not launched on "
                                     f"every rank: "
                                     f"{k['seq_launches_per_rank']}")
        if k["name"] == "flash_attention:prefill_tc":
            k.update(seq_fields(k20["bfloat16"], "seq", "fwd"))
        elif k["name"] == "attention:general:f32":
            k.update(seq_fields(k20["float32"], "seq", "fwd"))
        elif k["name"] == "attention_bwd":
            k.update(seq_fields(k20["bfloat16"], "seq", "bwd"))
            k.update(seq_fields(k20["float32"], "seq_f32", "bwd"))
    # the scan kernels on phase 21's path: 21s's serve run, 21a's and each
    # rank of 21b's training steps, and 21k's rows at falcon's widths
    fk = {(r["case"], r["dtype"]): r for r in p21["k"]}

    def falcon_fields(case, dtype, tag):
        r = fk[(case, dtype)]
        out = {f"{tag}_{k}": r[k] for k in (
            "ms", "call_ms", "bound_ms", "bound_by", "plain_ms",
            "max_abs_err", "shape")}
        if "segments" in r:
            out.update({f"{tag}_{k}": r[k] for k in (
                "segments", "segment_steps", "last_segment_steps",
                "pass_ms")})
        return out
    for k in kernels:
        if k["name"] not in ("mamba_scan", "mamba_step", "mamba_scan_bwd"):
            continue
        k["falcon_train_launches"] = p21["a"]["launches"][k["name"]]
        k["falcon_tp_launches_per_rank"] = [r["launches"][k["name"]]
                                            for r in p21["b"]]
        k["falcon_launches_from"] = (
            f"phase 21: 21s serves falcon-mamba-7b (64 layers), 21a trains "
            f"{FM_TRAIN_LAYERS} of its layers on one card and 21b on two "
            f"ranks of a (1, 2) mesh, {TRAIN_STEPS} steps each")
        if k["name"] == "mamba_scan_bwd":
            for case, tag in (("falcon_train", "falcon"),
                              ("falcon_rank", "falcon_rank")):
                k.update(falcon_fields(case, "bfloat16", tag))
                k.update(falcon_fields(case, "float32", f"{tag}_f32"))
        else:
            k["falcon_launches"] = p21["serve"]["launches"][k["name"]]
            case = ("falcon_prefill" if k["name"] == "mamba_scan"
                    else "falcon_decode")
            k.update(falcon_fields(case, "bfloat16", "falcon"))
            k.update(falcon_fields(case, "float32", "falcon_f32"))
        # training takes no step kernel, serving no backward
        run = ([k["falcon_launches"]] if k["name"] == "mamba_step" else
               [k["falcon_train_launches"], *k["falcon_tp_launches_per_rank"]]
               + ([k["falcon_launches"]] if k["name"] == "mamba_scan"
                  else []))
        if min(run) < 1:
            raise AssertionError(f"21: {k['name']} was not launched on "
                                 f"every run of phase 21: {run}")
    # the fused AdamW (no TPU counterpart): the launches of every training
    # step of phases 13b-16b, 19a, 20a and 21a (one a leaf), timed over
    # hymba-1.5b's leaves in 22a (every leaf's launch: ms is a step's)
    adamw_runs = (p13, p14, p15, p16, p19["a"], p20["a"], p21["a"])
    a22 = p22["a"]
    kernels.append({
        "name": "adamw", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adamw.cu",
        "replaces": ADAMW_REPLACES,
        "launches": sum(p["launches"]["adamw"] for p in adamw_runs),
        "launches_from": "phases 13b-16b, 19a, 20a and 21a, 5 training "
                         "steps each",
        "max_abs_err": a22["max_abs_err"],
        "max_rel_err": a22["max_rel_err"], "ms": a22["ms"],
        "plain_ms": a22["plain_ms"],
        "bound_ms": a22["bound_ms"], "bound_by": "bytes",
        "library_ms": a22["library_ms"],
        "library": "torch._fused_adamw_ on f32 gradients + "
                   "torch._foreach_copy_ of the parameters",
        "call_ms": a22["call_ms"],
        "timed_at": "hymba-1.5b's leaves, one step's launches",
        "launches_in_ms": a22["launches_a_step"]})
    if min(p["launches"]["adamw"] for p in adamw_runs) < 1:
        raise AssertionError("adamw was not launched in every training run")
    # the fused elementwise kernels (no TPU counterpart either): the
    # launches of the same training runs, phase 23's rows at each op's
    # commonest path shape in bf16 (the other cases and f32 beside)
    for op in FUSED_OPS:
        rows = [r for r in p23["rows"] if r["op"] == op]
        row = rows[0]
        for name, fields in ((op, ("ms", "call_ms", "plain_ms",
                                   "bound_ms", "library_ms")),
                             (f"{op}_bwd", ("bwd_ms", "fwd_bwd_ms",
                                            "bwd_plain_ms", "bwd_bound_ms",
                                            None))):
            ms, call, plain, bound, lib = (row.get(f) if f else None
                                           for f in fields)
            entry = {
                "name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/fused.cu",
                "replaces": FUSED_REPLACES[op] + FUSED_NOTE,
                "launches": sum(p["launches"][name] for p in adamw_runs),
                "launches_from": "phases 13b-16b, 19a, 20a and 21a, 5 "
                                 "training steps each",
                "max_abs_err": max(r["max_abs_err"] for r in rows)
                if name == op else max(r["bwd_max_rel_err"] for r in rows
                                       if "bwd_max_rel_err" in r),
                "ms": ms, "plain_ms": plain, "bound_ms": bound,
                "bound_by": "bytes", "library_ms": lib,
                "shape": row["shape"], "dtype": row["dtype"]}
            if name == op:
                entry["call_ms"] = call
                entry["bit_equal"] = [r["case"] + ":" + r["dtype"]
                                      for r in rows if r["bit_equal"]]
            else:
                entry["max_abs_err_is"] = "relative to the largest entry"
                entry["fwd_bwd_ms"] = call
                entry["chain_fwd_bwd_ms"] = row["chain_fwd_bwd_ms"]
                if "library_fwd_bwd_ms" in row:
                    entry["library_fwd_bwd_ms"] = row["library_fwd_bwd_ms"]
                if "bwd_split_ms" in row:
                    entry["split_ms"] = row["bwd_split_ms"]
            if "library_silu_ms" in row and name == op:
                entry["library_silu_ms"] = row["library_silu_ms"]
            for r in rows[1:]:
                if r["dtype"] != "bfloat16":
                    continue
                key = "bwd_ms" if name != op else "ms"
                if r.get(key) is not None:
                    entry[f"{r['case']}_ms"] = r[key]
            kernels.append(entry)
            if entry["launches"] < 1:
                raise AssertionError(f"{name} was not launched in the "
                                     f"training runs")
    # the largest shape of phase 2, per kernel: the kernel against its bound
    # where launch latency no longer hides it
    summary["p2_largest"] = {
        k: [R, M, sig(r["ms"]), sig(r["bound_ms"]), sig(r["plain_ms"])]
        for (k, R, M), r in timed.items() if R == r_blk * 64 and M == 256}
    compact = (",", ":")
    log("summary " + json.dumps(summary, separators=compact))
    log(f"card: {card}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}, separators=compact), flush=True)
    log("kernels: " + ", ".join(k["name"] for k in kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
