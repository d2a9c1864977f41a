"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Fails (non-zero exit, no result line) when no CUDA device is visible or the
repository's sources are not beside this script.  Otherwise, in order:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the port from the sources in the checkout
   (one ``nvcc`` per source, all at once) and prints ``ptxas -v``'s
   registers, shared memory and spills; fails unless the flash forward
   kernels (``flash_fwd_mma_bf16_kernel`` and the fp32 ``flash_fwd_kernel``
   at every head dim, ``flash_fwd_wgmma_kernel`` at D 64, 80, 128 and 192
   with no ``wgmma`` made to wait and built as ``flash_attention.fwd_plan``
   plans it, printing its tiling and blocks an SM) compiled with no spill,
   and unless every instantiation of the GEMM's
   ``gemm_wgmma_bf16_kernel`` (clusters of 1 and 2, each pair of operand
   majors, each schedule) and the decode kernels ``gemm_decode_bf16_kernel``
   and ``gemm_decode_sum_kernel`` (row tiles 8 and 16) compiled with no
   spill and no ``wgmma`` made to wait by ``ptxas`` (C7517, C7518),
   printing the decode kernel's blocks an SM, and
   unless every conv kernel (each tile of ``im2col_conv.TILES``, 16-byte
   and 4-byte copies, and the split sum) compiled with no spill, printing
   the blocks of each one SM holds, and unless the tensor-core SSD scan
   ``ssd_scan_mma_bf16_kernel`` compiled at every state width and p tile
   with no spill, asks the shared memory the wrapper counts and splits its
   inexact operands into the wrapper's ``MMA_TERMS`` bf16 terms, printing
   its registers and blocks an SM, and the SSD scan's wgmma route
   (``ssd_scan_fwd_states_kernel`` and ``ssd_scan_fwd_chunk_kernel`` at
   state widths 64 and 128) compiled with no spill and no ``wgmma`` made to
   wait, asking the shared memory the wrapper counts
   (``check_ssd_ptxas``), and unless every kernel of the flash
   backward (the wgmma route's dQ and dK/dV at D 64, 80 and 128 in both
   score modes with no ``wgmma`` made to wait, printing their blocks an
   SM, and every ``mma.sync`` and SIMT kernel) and of
   the SSD scan's backward (both routes of ``ssd_scan.bwd_kernels``: the
   SIMT kernels, and the tensor-core states, chunk and sum kernels, which
   must ask the shared memory the wrapper counts) compiled with no spill
   (``check_flash_bwd_ptxas``, ``check_ssd_bwd_ptxas``), the bf16-score
   mode's forward and backward kernels among them;
3. holds each kernel against its plain PyTorch version on the card, at every
   distinct layer shape of full-width SynthNet and of full-width ResNet50
   (microbatch of 2 images: the stride-2 7x7 stem over 3 channels, 1x1 convs
   up to 2048 channels, the classifier at 2 rows) and at the reference
   kernel tests' shapes plus a ragged K, in fp32 with TF32 off (tolerance
   3e-4 absolute and relative, the reference's), and the conv against
   itself over two calls (the same bits); prints each shape's plan (tile,
   splits, blocks) and fails if a SynthNet shape launches fewer blocks than
   the card has SMs; times the kernel, the plain version and cuDNN's
   ``F.conv2d`` (``cudnn.benchmark`` off, and on as ``library_best_ms``) on
   the SynthNet and ResNet50 shapes by CUDA events, the kernel and cuDNN
   also by the profiler's device time and by the host's time to issue a
   call, and computes each shape's bound on the H100 SXM, and the totals of
   one forward of each network;
4. drives the main path — ``launch.serve_cnn.serve_cnn`` at full width:
   measure each layer, Shisha H3, 4-stage stream pipeline of 8 microbatches,
   straggler rebalance — with every launch count set to 0 just before and
   read just after; fails if a kernel of the path never launched;
5. checks the pipelined output: equal to the sequential model on the same
   kernels, and within 1e-3 of the output's largest magnitude of the
   sequential model computed with the plain versions (18 fp32 layers with
   reductions of up to 30976 terms summed in another order); then the
   paper's Fig. 4 race on the measured oracle of phase 4 (full-width
   SynthNet, each layer timed on the hand-written conv, the 4-EP platform of
   streams): Shisha H3, HC, HC from Shisha's seed, SA, SA from the seed and
   RW, each with RACE_BUDGET times Shisha's simulated wall, and Pipe-Search
   and ES paying the database's generation cost up front, ES over the whole
   space (19,792 configurations); prints each arm's trials, simulated time
   to 99% of its final best, best modelled throughput, its ratio to ES's and
   host seconds, and fails if any arm's best exceeds ES's; runs the best
   splits of Shisha, HC and SA as stream pipelines and prints their measured
   microbatches/s (no limit);
5b. Shisha's placement and DVFS moves on the same measured oracle (nothing
   measured again; ``place_and_scale``), from the H3 seed at 3 stages on
   the 4 EPs, so one EP is always free for a relocation: (a) with
   ``scalar_fabric`` and ``degenerate_power`` attached, ``tune(placement=
   True, dvfs=True)`` must equal the bare platform's ``tune(placement=True)``
   bit for bit (trials, best split and throughput, trial count, simulated
   wall); (b) on a 2x2 ``mesh2d`` fabric at the stream EPs' own link
   bandwidth and latency, ``tune(placement=True)`` must pay at least one
   relocation trial (counted by a ``Trace`` that sees each
   ``reconfig_cost``), and prints the count, the routed cost of the seed's
   farthest relocation onto a free EP beside the flat overhead, and the
   adopted split; (c) on that fabric with ``uniform_power`` capped at 0.7
   of the seed's nominal package watts, ``tune(placement=True, dvfs=True)``
   must return levels under which its split meets the cap, and prints the
   enforced and adopted levels, the package watts against the cap and the
   trials.  (b)'s and (c)'s splits run as stream pipelines (8 microbatches
   of 2; (c)'s only where it differs from (b)'s), each output must equal
   the sequential model's, and the conv must launch; their measured
   microbatches/s are printed, with no limit, beside the card's name and
   power limit.  Watts, levels and throughputs of the tuner are the
   model's (marked ``modelled``): the measured oracle prices each boundary
   on the scalar link and ignores DVFS scales, as the reference's does, so
   a frequency step is free to it;
5c. online Shisha on the same measured oracle (``serve_online``): the
   serving simulator (``repro_torch.serve``) serves phase 4's split under
   seeded Poisson traffic at 0.6 of its modelled capacity for 60 simulated
   seconds (SLO 3x the pipeline's latency), with ``ContinuousShisha`` at
   the reference's defaults re-tuning over the measured oracle's model of
   the drifted machine (``MeasuringEvaluator.on_platform`` of
   ``drifted_platform``: nothing measured again).  (a) Scripted drift: the
   bottleneck EP 3x slower at 15 s, an in-use EP dead at 30 s and revived
   at 45 s; fails unless the re-tunes include a ``slowdown``, a
   ``dropout`` and a ``recovery`` in that order, no split installed while
   the EP is dead uses it, every request is accounted for, the drain and
   heap event engines and a rerun give the same ``SimResult``, a live
   ``Telemetry`` changes nothing and counts exactly the trials the
   re-tunes paid, and two reruns export byte-identical JSONL and Chrome
   traces.  (b) Chaos: a seeded ``FaultModel`` (failures of the slow
   class's EPs, transient batch errors) through ``with_faults``, served
   with a ``ResiliencePolicy``; fails unless two runs are identical, the
   result is strict JSON, and ``no_faults()`` gives the bare platform's run
   bit for bit.  (c) Thermal: ``uniform_power`` with the reference power
   tour's aggressive RC nodes (its watts sized to the tour's chiplets);
   fails unless a re-tune of kind ``throttle`` is answered by a DVFS
   step-down that leaves the split unchanged.  Every split a re-tune
   installed runs as a stream pipeline, equal to the sequential model, and
   the conv must launch; measured microbatches/s are printed beside the
   modelled ones.  Simulated time, watts, temperatures and throughputs of
   the model are marked ``modelled``;
5d. multi-tenant co-serving on the card's measured oracles
   (``co_serve_online``): full-width SynthNet (220x220x3) and ResNet50
   (224x224x3) measured layer by layer (``launch.serve_cnn.measure_cnn``,
   microbatches of 2) over 8 stream EPs (4 FEPs, 4 SEPs), interleaved into
   two partitions; each lane's evaluator is its tenant's oracle
   ``on_platform`` of its partition (nothing measured again).  The
   reference acceptance test's setup: each tenant's capacity the tuned H3
   throughput on its partition, SynthNet's recorded Poisson traffic at 0.65
   of it and ResNet50's recorded MMPP at 0.08 / 0.30, each SLO 3x its
   launch split's pipeline latency, 60 simulated s, batch-policy search,
   measure 2, alpha 4.  (a) SynthNet's fastest EP dies at 20 s and revives
   at 40 s, served elastic and static: fails unless after every
   re-partition the partitions are disjoint and cover exactly the alive
   EPs, every installed split lies on its lane's EPs, on none dead at its
   install and on none another lane's split holds, every request is
   accounted for, the revived EP rejoins exactly one tenant in a
   ``revival`` event, the static run never re-partitions, every dropout
   re-tunes its victim and donors at the ``Trace.wall`` each paid (> 0),
   the drain and heap engines, ``co_serve`` and two reruns agree, a live
   ``Telemetry`` changes nothing and exports byte-identical traces twice,
   a degenerate ``uniform_power`` gives the bare result, and elastic beats
   static on aggregate SLO violations (the reference's acceptance, held
   with a margin of 1.29-4.9x in CPU rehearsals on the card's layer
   times); prints the events and each arm's aggregate SLO share and
   throughput.  (b) Seeded chaos (SEP failures, batch errors) with a
   ``ResiliencePolicy`` on the launch partitions: two runs identical,
   strict JSON, requests accounted for.  (c) Every split a lane installed in (a) runs as
   a stream pipeline of its tenant's model, equal to the sequential model;
   then both tenants' final splits, each captured as a CUDA graph, replay
   alone and together on streams of their own before one synchronise (the
   host issues each in one call, so the card holds both at once), each
   still equal, with their microbatches/s on the device alone, together
   and back to back beside the modelled ones; the conv must launch.  All
   simulated numbers are marked ``modelled``;
6. LM serving kernels: holds ``flash_attention`` and ``ssd_scan`` against
   their plain versions on the card at the LM main path's shapes in bf16
   (prefill attention of every served attention model, causal, q/k/v as
   the model's views: granite-3-2b q [4,32,512,64], k/v [4,8,512,64];
   phi3.5-moe-42b q [4,32,512,128], llama4-scout-17b q [4,40,512,128],
   k/v [4,8,512,128]; zamba2-2.7b's shared block q/k/v [4,32,512,80];
   nemotron-4-340b q [4,96,512,192], k/v [4,8,512,192]; internvl2-76b
   over its 256 patches and the prompt, q [4,64,768,128], k/v
   [4,8,768,128]; whisper-small's encoder, q/k/v [4,12,1500,64]
   bidirectional, decoder, [4,12,448,64] causal, and cross attention, q
   [4,12,448,64] against k/v [4,12,1500,64]; the prefill scan
   of mamba2-130m, x [4,512,24,64],
   B/C [4,512,128], and of zamba2-2.7b, x [4,512,80,64], B/C [4,512,64],
   chunk 64, x, B and C strided as ``ssd_block`` passes them) and at
   the reference tests' shapes in fp32 at the reference's tolerances (2e-4
   attention, 2e-3 SSD), plus a ragged length, a sliding window, a
   non-causal case, a ragged p tile and strided inputs, the same at head
   dims 80 and 192 in fp32, bf16 attention cases that reach every branch
   of the tensor-core kernel (every head dim, GQA groups 1, 4, 5 and 12, S
   of 1, 15, 65 and 1000, a window of 7, non-causal), attention over a key
   length other than the query's in bf16 and fp32 (Sq 1, 15, 448 and 1500
   against Skv 1, 15, 65, 448 and 1500, longer and shorter, causal with and
   without a window, non-causal, GQA 1 and 8), and bf16 SSD cases
   that reach every branch of the
   tensor-core scans (chunks 16, 32 and 64, state 64 and 128, p 64, 48 and
   16, one chunk, contiguous and strided; the wgmma route's SSD_WGMMA_CASES:
   one chunk, p of two tiles, head groups of one and several), each also at
   every p tile of ``ssd_scan.mma_plans``, and bf16 at chunk 8 on the SIMT
   scan; bf16 y and final state are held within BF16_REL_TOL of max
   |plain|, and the wgmma route must give the same bits twice and differ
   from plain in no more of its bf16 outputs than the mma.sync kernel's
   plan; fails unless both SSD model shapes and the mesh ranks' scans
   (SSD_RANK_SHAPES) plan the wgmma route and the profiler shows its two
   kernels ran, each timed beside the mma.sync kernel's plan
   (``mma_device_ms``, ``mma_host_ms``, each kernel's ``steps_ms``); times the
   kernel, the plain version and (attention, at each model's shape) SDPA,
   naming the device kernel that served SDPA, and computes each bound;
   every bf16 attention case prints its forward route
   (``flash_attention.fwd_route``: ``wgmma`` at D 64, 80, 128 and 192 with
   rows TMA can address) and must give the same bits on two calls, and
   each served shape also times the ``mma.sync`` kernel through the C
   entry's route code (``flash_attention.run_fwd_route``,
   ``mma_device_ms``, ``mma_host_ms``) beside the shipped route and SDPA,
   printing whether the two routes gave the same bits (``mma_same_bits``).
   Every time in the ``kernels`` line is by CUDA events around 20 calls;
   attention and the SSD scan also get the profiler's device time per call
   and the host's time to issue a call (their wrappers take the host about
   as long to issue as the card to run), and attention the same for SDPA;
7. drives the LM main path — ``launch.serve.serve`` at full width on
   ``cuda``, bf16, batch 4, prompt 512, 32 generated tokens — for
   granite-3-2b, mamba2-130m, zamba2-2.7b and whisper-small (prompt cut
   to its 448 decoder positions, 1500 random frames) at full depth,
   nemotron-4-340b at 2 of its 96 layers and internvl2-76b at 8 of its
   80 (256 random patch embeddings), every launch count set to 0
   just before each and read just after; fails if the path's kernel never
   launched or the tokens are out of range; then times a warm prefill and
   warm decode steps on the host clock and prints a profiler breakdown
   (device time by kernel, busy share of the wall) of one prefill and of
   four decode steps; fails unless an attention model's bf16 prefill ran
   ``flash_fwd_wgmma_kernel`` once per attention layer (zamba2: once
   per application of its shared block, 9; whisper: its 12 encoder layers
   and self and cross attention in its 12 decoder layers, 36) and never
   the ``mma.sync`` ``flash_fwd_mma_bf16_kernel`` or the fp32 SIMT
   ``flash_fwd_kernel``, and unless an SSD model's ran the wgmma route's
   ``ssd_scan_fwd_states_kernel`` and ``ssd_scan_fwd_chunk_kernel`` once
   per layer and no other scan kernel;
8. holds each LM path against the same path on the plain versions
   (``ops.flash_attention`` / ``ops.ssd_scan`` / ``ops.gemm`` swapped here,
   and only here): prefill plus 4 teacher-forced decode steps on the kernel
   path's tokens, logits compared relative to the largest |logit|, in bf16
   and with the same weights in fp32 (nemotron-4-340b at 1 layer: its
   fp32 weights take 51.5 GB, made as its bf16 ones are freed;
   internvl2-76b at 2), held to
   LM_TOL; for an SSD model (mamba2-130m, zamba2-2.7b) in
   bf16 every prefill scan of the kernel path is also held to BF16_REL_TOL
   against the plain version on the same inputs, and its logits are held to
   LM_TOL with the bf16 scan in the model in fp32 at every layer, where a
   control scan that rounds toward zero must miss LM_TOL (see SSD_LAYERS;
   the bf16 model's logits are printed); a logits comparison that misses
   LM_TOL, or a control that meets it, fails the run after every later
   phase has run and the ``kernels`` line is printed;
9. the MoE expert GEMM (checked with phase 6): holds ``gemm`` against
   ``gemm_plain`` on the reference tests' grid (fp32 at 2e-4, bf16 at 6e-2,
   the reference's tolerances), at capacities around the wgmma tile's
   edges (M 17, 100, 321, K 4104, N 6408 and 6392, batch 1 and 16: an odd
   and an even count of column tiles), on a layer slice
   of a stacked expert tensor, each also with A, B or both as transposed
   views (every wgmma instantiation; fp32, decode and unaligned rows copied
   first, and nowhere else), the decode kernels at capacities 1, 8 and 16,
   N 6392 and 6408, K 4104, batch 1 and 16 and on a layer slice of a
   stacked expert tensor, each giving the same bits twice, and at the MoE
   main path's shapes in bf16 (phi3.5-moe prefill capacity 320 and decode
   capacity 8, llama4-scout prefill capacity 160 and decode capacity 8, 16
   experts in one launch); at each main shape fails unless prefill ran
   ``gemm_wgmma_bf16_kernel`` and decode exactly ``gemm.decode_kernels``
   (``gemm_decode_bf16_kernel`` and ``gemm_decode_sum_kernel``), and times
   the kernel, the plain version and ``torch.bmm`` (cuBLAS) by CUDA events
   and by the profiler's device time, with its FLOPs, bytes and bound
   (decode: and the split's blocks, units an SM, split tiles, blocks an
   SM, and the kernels' and ``torch.bmm``'s device time with the L2 cache
   cold before each call, ``_cold_device_ms``, as the decode step finds it);
10. drives MoE serving like phase 7, with the ``gemm`` launch count beside
   the others: phi3.5-moe-42b at 16 of its 32 layers and llama4-scout-17b at
   4 of its 48, both at full width (full depth does not fit the card's
   80 GB; these depths, well below what would fit, keep the run short);
   fails unless each profiled bf16 prefill ran ``gemm_wgmma_bf16_kernel``
   three times a layer (gate, up, down) and never ``gemm_mma_bf16_kernel``,
   unless the served decode steps launched gemm's decode route
   (``gemm.decode_launches``) and unless the four profiled decode steps ran
   exactly ``gemm.decode_kernels`` three times a layer each, nothing else;
   phase 8 for both, the fp32 comparison at 2 layers (fp32 weights of 16
   layers would need 84 GB), and the share of (token, expert) assignments
   that the kernel and plain paths route alike, held to ROUTE_FLOOR (see
   MOE_ROUTES for the logits check where they differ);
11. the flash backward (``check_flash_bwd``): ``flash_attention_bwd``
   against ``flash_attention_bwd_plain`` on the kernel's own o and lse, and
   that against autograd through ``flash_attention_plain``, on the same
   inputs: the training shapes (bf16, causal, the model's layout:
   granite-3-2b q [4,32,512,64], k/v [4,8,512,64]; phi3.5-moe q
   [4,32,512,128], k/v [4,8,512,128]; zamba2-2.7b's shared block q/k/v
   [4,32,512,80]), every head dim in bf16 and fp32,
   GQA groups 1, 4, 5, 7 and 12 at D 64 and 128 (clusters of 1, 4, 5, 7
   and 6 on the wgmma route), S of 1, 15, 65 and 1000, Sq != Skv both
   ways, key tiles past Sq that no query sees (a causal window), non-causal,
   a window of 7, contiguous, strided, and rows only 8-byte aligned (D 64,
   80 and 128); D 80 on the wgmma route at GQA groups 1 and 4, S of 1, 15,
   65 and 1000, Sq != Skv, a window and non-causal; each
   case prints the route ``flash_attention.bwd_route`` picked and fails
   unless it is the one expected (wgmma: bf16 at D 64, 80 and 128 with rows
   TMA can address; the profiled training shapes must run exactly
   ``flash_attention.bwd_kernels`` of their route); bf16 within
   BF16_REL_TOL of each gradient's max |plain|, fp32 within ATTN_TOL of it
   (where every row sees one key, dq and dk are 0 in exact arithmetic and
   are held against max |dv|); two calls give the same bits; the lse
   against ``flash_attention_fwd_plain``'s; times the training shapes (kernel,
   plain backward, SDPA's backward by events and device time) with each
   bound; then the SSD scan's backward (``check_ssd_bwd``): ``ssd_scan_bwd``
   against ``ssd_scan_bwd_plain``, and that against autograd through
   ``ssd_scan_plain``, on the same inputs: mamba2-130m's and zamba2-2.7b's
   training shapes (x [4,512,24,64], B/C [4,512,128]; x [4,512,80,64],
   B/C [4,512,64]; chunk 64) in bf16 strided as ``ssd_block`` passes them
   with no final-state gradient, as training runs them, and in fp32 and in
   bf16 contiguous with one; the reference tests' shapes, a ragged p tile
   and chunk 8, with and without it; each case prints its route
   (``ssd_scan.bwd_route``: bf16 at chunk 64 and p 64 on ``"wgmma"``, the
   chunk kernel ``ssd_scan_bwd_chunk_kernel`` on ``wgmma``) and fails
   unless it is the one expected; bf16 within BF16_REL_TOL of each
   gradient's max |plain|, fp32 within SSD_TOL of it; two calls give the
   same bits; at the training shapes, on the same inputs, the route given
   the forward's states (``ssd_scan.ssd_scan_states``: the same bits, the
   states kernel at half its blocks by the profiler's trace), the
   ``"mma"`` route (the ``mma.sync`` chunk kernel it replaced) and the SIMT
   route (``ssd_scan.run_bwd_route``, held to BF16_REL_TOL too), and
   ``ops._SsdScan`` as a checkpointed layer runs it
   (``ops.keeping_scan_states``: its backward on the route's kernels, the
   states kernel at half its blocks); times each route kernel by kernel by
   device time in turns (wgmma, mma, simt, wgmma given the forward's
   states, mma, wgmma), the whole by events too, beside the bound and the
   plain backward (no PyTorch call computes it), and fails unless the
   profiled backward ran exactly ``ssd_scan.bwd_kernels`` of its route;
12. the ``gemm`` gradient (``check_gemm_grad``): ``ops.gemm``'s autograd
   Function at phi3.5-moe's training shapes (16 experts, capacity 320, d
   4096, d_ff 6400, bf16), dA and dB against ``gemm_plain`` at GEMM_TOL,
   two calls the same bits; fails unless dA ran the wgmma instantiation
   that reads Bᵀ K-major and dB the one that reads Aᵀ MN-major, the
   wrapper copied nothing and the profiled backward ran those two kernels
   and nothing else; its device time (and dA's and dB's alone) against
   ``torch.bmm`` on the transposed views and the bound;
13. drives the training main path (``drive_train``): ``launch.train.train``
   on ``cuda`` in bf16, batch 4 of 512 tokens from the data pipeline,
   TRAIN_STEPS steps, for granite-3-2b, mamba2-130m and zamba2-2.7b at
   full size and phi3.5-moe-42b at 2 of 32 layers (TRAIN_MODELS), every
   launch count 0 just before; fails unless every loss is finite, every
   parameter leaf got a finite, non-zero gradient at step 0 (``A_log`` and
   ``dt_bias`` included, whose only route is the SSD backward's dA and
   ddt), and the run launched what the code runs (``_train_launches``):
   with remat each layer's forward twice a step and its backward once
   (flash, the SSD scan); a hybrid's shared attention block, not
   recomputed, once each way per application (zamba2: 9); (MoE) ``gemm``
   twelve times a layer, six of them in the backward (``gemm.bwd_launches``,
   counted where ``ops.gemm``'s backward launches); times and profiles a
   warm step of ``transformer.make_train_step`` (wall, tokens/s, peak
   memory, device time by flash and SSD forward and backward, ``gemm``,
   cuBLAS and the rest, the optimizer's update by events, the busy share)
   and fails unless its kernels ran as often as its wrappers launched them,
   on the tensor-core forward kernels and the backward's route
   (``bwd_kernels``: the wgmma route's two kernels at granite's D 64,
   phi3.5-moe's D 128 and zamba2's shared block at D 80); holds the loss
   and every leaf's
   gradient, kernel path against plain path (``ops`` swapped as in phase 8,
   MoE on the kernel path's routes): an attention model in bf16 at the
   trained depth to TRAIN_LOSS_TOL and TRAIN_GRAD_TOL of each leaf's max
   |plain|, where two attention faults (TRAIN_CONTROLS: the backward
   without delta, the causal mask dropped) must miss them; an SSD model in
   fp32 with bf16 scans (mamba2-130m at its 24 layers, zamba2-2.7b at its
   first 6: SSD_HOLD_DEPTH) to SSD_TRAIN_LOSS_TOL and SSD_TRAIN_GRAD_TOL,
   where two faults in the scan's backward (SSD_TRAIN_CONTROLS: the carried
   state's gradient dropped across chunks, ddt without its decay term) must
   miss; every leaf's gradient to GRAD_TOL with the model in fp32 at 2
   layers (phi3.5-moe at 1, zamba2 at 6); checks a resume
   (``check_resume``) at full width and RESUME_CUT's depth (a full-size
   checkpoint passes the machine's disk limit), a checkpoint in a temporary
   directory at the middle step, the repeated losses held to RESUME_TOL;
14. drives the mesh paths (``launch/mesh.py``), each with its launch
   counts from 0 (``mesh_one_rank``, ``mesh_two_ranks``): (a) one rank over
   NCCL on a (1, 1) mesh, where every collective is a copy, so the mesh
   paths must give the bits of the paths without a mesh: phi3.5-moe's
   prefill at full width, MESH_DEPTH layers, bf16 (logits and cache), a
   granite-3-2b ``make_train_step`` (loss, gradient norm, every parameter)
   and ``compressed_psum`` on CUDA tensors; prints NCCL's version; (b)
   MESH_RANKS processes sharing cuda:0 over gloo (this script again, with
   ``--mesh-rank``): full-width SynthNet in a 2-stage split, stage s on rank
   s, 8 microbatches of 2, every rank's output equal to the sequential model
   on the same kernels; phi3.5-moe's prefill on a (1, 2) mesh, each rank
   holding its blocks of the sharded layout (half of d_ff of the experts,
   half of the heads), held to LM_TOL
   against the one-process kernel path on the same routes, each rank's
   profiled prefill running ``gemm_wgmma_bf16_kernel`` three times a layer
   with no copy (its route printed); granite-3-2b's loss and every leaf's
   gradient on a (2, 1) mesh, batch 4 x 512 split 2 / 2 with rank 0's rows
   partly masked, held to MESH_LOSS_TOL and MESH_GRAD_TOL against one
   process (each rank's blocks of the gradient gathered whole), beside two
   controls that must miss (the mean of the ranks' own means, the gradients
   left unsummed over the data ranks), then a warm mesh train step after
   which the ranks' gathered parameters agree; ``compressed_psum`` over the two ranks
   against its formula in fp32 on the host.  Walls and micro/s there are
   the host clock of two processes on one card, not a multi-card figure;
15. drives the sharded layout (``[shard]`` lines; ``models/layout.py``,
   ``sharding.py``, ``collectives.py``), each with its launch counts from 0: (a) one NCCL
   rank on a (1, 1) mesh, the parameters as ``local_shard`` gives them:
   granite-3-2b's train step, phi3.5-moe's prefill and a decode step must
   give the bits of no mesh (``sp_residuals`` on: one ``model`` rank splits
   nothing); (b) SHARD_RANKS processes sharing cuda:0 over
   gloo (this script again, with ``--shard-rank``), on a (1, 2) and a (2, 1)
   mesh; on (1, 2) the residual stream is split over the sequence
   (``sp_residuals``, the default): granite-3-2b at full width and
   MESH_DEPTH layers, its loss and every
   leaf of its gradient gathered whole held to SPLIT_LOSS_TOL on (1, 2) and
   MESH_LOSS_TOL on (2, 1), and MESH_GRAD_TOL, against one process, with
   the stream split and whole, beside controls that must miss (on (1, 2)
   the tensor-parallel sums dropped, ``sum_tp`` and the split's
   reduce-scatter ``sp_scatter``, both limits, and the norms' gradients
   left unsummed over ``model``, the gradient's; on (2, 1) the data sums,
   both); on (1, 2) the
   bytes of the layer inputs remat keeps (``_recording_remat``), which with
   the split must be exactly half of those without it; phi3.5-moe's prefill
   and SHARD_DECODE decode steps (over the ring split across the ranks' slots
   on (1, 2)) held to LM_TOL against one process on the same routes (on
   (2, 1) against the rank's slice alone: a data shard routes its own
   tokens), the mesh's routes against one process's own held to
   ROUTE_FLOOR, beside a control on (1, 2) that must miss (the split ring's
   all-reduces dropped, each rank attending only its own slots);
   zamba2-2.7b at SHARD_HYBRID_DEPTH layers (its SSD layers split over
   their heads, ``Layout.ssd``: each rank projects and scans its 40 of 80
   heads on the wgmma route, exactly once a layer, over the
   gathered sequence, its shared attention block on the rank's heads)
   served the same way on (1, 2) in bf16 (printed, SSD_LAYERS), then it
   and SHARD_SSD (mamba2-130m, at full width and depth, 12 of its 24 heads
   a rank) with the model in fp32 and its scans in bf16, as the SSD checks
   hold them: served, the logits held to LM_TOL, and stepped once (4 x
   512), the loss and every leaf gathered whole held to SSD_TRAIN_LOSS_TOL
   / SSD_TRAIN_GRAD_TOL against one process, beside a control that must
   miss, the gated norm's mean square summed forward only, ``sum_tp`` for
   ``psum_tp``; every scan on the wgmma route at the rank's heads
   and every backward on the ``"wgmma"``
   route's three kernels (``_recording_scans``); each rank's parameter and
   AdamW bytes by
   ``torch.cuda.memory_allocated`` held to the sum of its blocks (at most
   the allocator's 512-byte rounding a tensor more); (c) the dry run on the
   card (``launch.dryrun.run_cell(..., device="cuda")``): SHARD_DRYRUN's
   cells as rank 0 of a 256-rank fake group with real CUDA tensors (the
   other ranks' blocks of a gathered leaf are zeros): argument bytes equal
   to the ``meta`` profile's, the measured peak, the step's device time by
   CUDA events beside the roofline's compute and memory terms, the launches
   of flash, ``gemm`` and the SSD scan from 0, finite outputs; qwen3-32b's
   train cell's peak (the stream split) beside SHARD_WHOLE_STREAM_PEAK_GIB;
   zamba2-2.7b's train cell's scans, forward and backward, with their
   shapes (5 of 80 heads a rank) and kernels; and, taken in phase 13
   beside the scan's backward (after the training phases the profiler
   kept no device record of it), the bf16 scan and its backward at
   mamba2-130m's and zamba2-2.7b's prefill shapes, whole and at the (1, 2)
   rank's heads, and at zamba2-2.7b x train_4k's rank 0 of (16, 16), each
   held to BF16_REL_TOL against its plain version on the same inputs and
   timed by the profiler's device time (``shard_scan_times``; the
   ``ssd_scan`` row's ``split heads``);
16. the bf16-score mode (the reference's ``attn_fp32_scores=False``), whose
   kernels phases 6b and 11b hold first, after phases 6 and 11 (6b opens
   with the exhaustive scalar checks, ``check_bf16s_scalars``: each of the
   mode's rounding steps against the IEEE op over every input, inputs and
   mismatches printed, none allowed): the mode's
   forward (``flash_fwd_mma_bf16_scores_kernel`` in bf16,
   ``flash_fwd_bf16_scores_kernel`` in fp32) and backward (the fp32 mode's
   route: ``"wgmma"`` at D 64, 80 and 128 with rows TMA can address, ``"mma"``
   for other bf16 calls, ``"simt"`` in fp32; ``bwd_kernels(route, d,
   False)``, printed with the route for every call) against
   the plain version in the mode on the same inputs, o, (m, l), dq, dk and
   dv, at the served calls of BF16S_SERVED, the training shapes of
   BF16S_TRAINED and a grid (every head dim in both types, GQA groups 1, 4
   and 5, a window, no causal mask, ragged S, Skv other than Sq both
   ways, D 80 on the wgmma route, bf16 rows only 8-byte aligned at D 64,
   80 and 128), held to BF16S_TOL
   beside the fp32-score function as the control, which must miss; two
   backward calls give the same bits; the profiled training shapes and
   unaligned rows run exactly the mode's kernels; times by events and
   device time beside the fp32-score kernels and the plain mode.  Then
   (``drive_bf16_scores``) granite-3-2b and zamba2-2.7b (its shared block
   at D 80) trained at full size and whisper-small served at full size
   with ``attn_fp32_scores=False``, each with the counts set to 0 just
   before and read just after (the mode's launches as the code runs them,
   the fp32-score kernels' none; zamba2: that and finite losses), the
   training step's loss and every leaf held kernel path against plain path
   (in bf16, and in fp32 beside the fp32-score control, which must miss),
   whisper's prefill and teacher-forced decode logits held to BF16S_LM_TOL;
17. prints the per-kernel JSON line (the ``flash_attention`` row is
   granite-3-2b's, naming the device function that served its prefill,
   with every other served attention call's times, bound, SDPA times and
   launches under keys that name the model and the call, and the
   backward's ``bwd_*`` keys at granite's training shape, phi3.5-moe's
   and zamba2-2.7b's (D 80) under keys that name them, with the training
   runs' launches; the
   ``ssd_scan`` row is mamba2-130m's scan, with its device function, device
   and host times, and zamba2-2.7b's times and launches under keys that
   name it, and the backward's ``bwd_*`` keys at both training shapes with
   the training runs' launches; the ``gemm`` row adds each MoE decode
   product's keys (``<model> decode gate/up device_ms`` ...: the decode
   kernels' times, ``torch.bmm``'s, the bound, the split), phase 10's
   decode launches, one phi3.5-moe layer's backward times and the training
   run's launches; the
   ``flash_attention_bf16_scores`` row is the mode's, at granite-3-2b's
   shape, with phase 16's launches), then
   ``{"ok": true, "device": ...}`` last.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))  # the port, from this checkout

from repro_torch.configs import get_config
from repro_torch.core import (
    HEURISTICS,
    PipelineConfig,
    Trace,
    database_generation_cost,
    exhaustive_search,
    generate_seed,
    hill_climbing,
    paper_platform,
    pipe_search,
    placement_reconfig_cost,
    random_walk,
    run_shisha,
    simulated_annealing,
    space_size,
    tune,
    weights,
)
from repro_torch.interconnect import mesh2d, scalar_fabric, uniform_fabric
from repro_torch.faults import FaultModel, ResiliencePolicy, no_faults
from repro_torch.kernels import build, im2col_conv, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm as gm
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.data import DataConfig, make_batch_iterator
from repro_torch.launch.serve import make_batch, serve
from repro_torch.launch.train import train
from repro_torch.launch.mesh import make_stage_mesh
from repro_torch.launch.serve_cnn import BATCH, N_MICRO, measure_cnn, serve_cnn
from repro_torch.models import blocks, transformer
from repro_torch.models.lm_common import init_params
from repro_torch.models.cnn import make_cnn, network_layers, resnet50_specs, synthnet_specs
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.pipeline import PipelineRunner, h100_platform_from_streams, pipeline_throughput
from repro_torch.power import ThermalModel, degenerate_power, uniform_power
from repro_torch.power.model import WATTS_PER_GFLOPS
from repro_torch.serve import (
    ContinuousShisha,
    HeapEventLoop,
    MMPPTraffic,
    PoissonTraffic,
    ReplayTraffic,
    ServingSimulator,
    SharedClockCoSimulator,
    Tenant,
    co_serve,
    partition_eps,
    subplatform,
)
from repro_torch.telemetry import Telemetry
from repro_torch.pipeline.hetero import H100_FP32_FLOPS as PEAK_FP32_FLOPS
from repro_torch.pipeline.hetero import H100_BF16_FLOPS as PEAK_BF16_FLOPS
from repro_torch.pipeline.hetero import H100_HBM_BW as HBM_BYTES_PER_S
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import named_leaves, tree_map

#: kernel-vs-plain tolerance on one conv (the reference's conv test)
KERNEL_TOL = 3e-4
#: pipelined-vs-plain tolerance over the 18-layer chain, relative to max |output|
CHAIN_TOL = 1e-3
#: kernel-vs-plain in fp32: the reference's kernel-test tolerances
ATTN_TOL, SSD_TOL = 2e-4, 2e-3
#: kernel-vs-plain in bf16, max |kernel - plain| over max |plain|: both keep
#: fp32 inside and differ by where the output (and, for attention, p) is
#: rounded to bf16, 2^-8 relative each, so 1e-2 leaves about 2.5 roundings
BF16_REL_TOL = 1e-2
#: LM logits, kernel path against plain path, relative to max |logit|: fp32
#: differs only by summation order through 24-40 layers; bf16 by the
#: roundings above at every layer, carried through the residual stream
LM_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
# MOE_ROUTES: MoE logits are held to LM_TOL too, on one set of routes.  A
# router whose top choices nearly tie can pick other experts when its input
# differs by rounding, and a token sent elsewhere gets another FFN output,
# not a rounding of the same one.  In bf16 the two paths route 99.4% of
# phi3.5-moe's (token, expert) assignments alike in its first layer, 85% in
# its 16th (NVIDIA H100 80GB HBM3, 700 W), and their logits then differ by
# 46% of max |logit|.  So where any assignment differs, drive_lm prints that
# share and that error, and checks the plain path again with the kernel
# path's routes replayed (its own router probabilities as gates).  The share
# itself is held to ROUTE_FLOOR, so that a change that moves many more
# routes fails.
# SSD_LAYERS: for a bf16 SSD model every prefill scan of the kernel path is
# also held to BF16_REL_TOL against the plain version on the same inputs, y
# and final state.  Its logits are held to LM_TOL with the model in fp32,
# weights and activations, and each scan in bf16 (x, B and C rounded to
# bf16 on the way in, its bf16 output widened on the way out) in both
# paths: the tensor-core scan at every layer, its roundings carried through
# the residual stream.  In the model in bf16 they are printed, not held:
# mamba2-130m's random-weight bf16 logits at its 24 layers move by 0.07 to
# 0.17 of max |logit| whenever a scan's bf16 output differs from the plain
# version's in 1.8e-4 or more of its elements, whatever the cause: the
# plain version's own arithmetic in another fp32 order, its output times
# 1 + 1e-6, or a biased scan, so no limit there tells an exact scan from a
# biased one.  With the other ops in fp32 the same comparison reads 0.016
# to 0.028 for the tensor-core scan and for plain's arithmetic in another
# order, and 0.082 to 0.135 for plain rounded toward zero
# (scripts/ssd_lm_sensitivity.py --model bf16 mixed, seeds 0 and 1,
# PERF.md).  So that scan, biased by half a rounding on average and each
# output within one rounding of plain's, runs through the same comparison
# as a control, and the run fails if it meets LM_TOL.
#: least routing agreement, kernel path against plain path: in the first MoE
#: layer, whose inputs differ only by attention's rounding (measured 0.994
#: phi3.5-moe, 0.997 llama4-scout, bf16), and over every MoE call of the run
#: (measured 0.908 and 0.983; 1.000 for both in fp32)
ROUTE_FLOOR = {"first layer": 0.98, "all calls": 0.85}
#: kernel-vs-plain for the GEMM: the reference's kernel-test tolerances (allclose)
GEMM_TOL = {torch.float32: 2e-4, torch.bfloat16: 6e-2}
#: the LM main path: per model the kernels it must launch, the depth served
#: (None: the config's) and the depth of the fp32 comparison (None: served
#: depth).  nemotron-4-340b's embedding and head take 18.9 GB in bf16 and
#: each layer 6.9 GB; its fp32 comparison at 1 layer takes 51.5 GB.
#: internvl2-76b's take 4.2 GB and 1.71 GB a layer: 80 layers would need
#: about 141 GB, 8 take 17.9 GB, its fp32 comparison at 2 about 15.5 GB.
LM_MODELS = {
    "granite-3-2b": (("flash_attention",), None, None),
    "mamba2-130m": (("ssd_scan",), None, None),
    "phi3.5-moe-42b": (("flash_attention", "gemm"), 16, 2),
    "llama4-scout-17b": (("flash_attention", "gemm"), 4, 2),
    "zamba2-2.7b": (("ssd_scan", "flash_attention"), None, None),
    "nemotron-4-340b": (("flash_attention",), 2, 1),
    "whisper-small": (("flash_attention",), None, None),
    "internvl2-76b": (("flash_attention",), 8, 2),
}
LM_BATCH, LM_PROMPT, LM_GEN, LM_FORCED = 4, 512, 32, 4
#: the port's CUDA kernel functions, as the profiler names them
PORT_KERNELS = ("flash_fwd_wgmma_kernel", "flash_fwd_mma_bf16_kernel", "flash_fwd_kernel",
                "ssd_scan_fwd_states_kernel", "ssd_scan_fwd_chunk_kernel",
                "ssd_scan_mma_bf16_kernel", "ssd_scan_kernel", "gemm_wgmma_bf16_kernel", "gemm_mma_bf16_kernel", "gemm_fma_f32_kernel", "gemm_decode_bf16_kernel",
                "gemm_decode_sum_kernel", "flash_bwd_delta_kernel",
                "flash_bwd_dq_mma_bf16_kernel", "flash_bwd_dkdv_mma_bf16_kernel", "flash_bwd_dq_wgmma_kernel",
                "flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_kernel",
                "flash_bwd_dkdv_kernel", "flash_fwd_mma_bf16_scores_kernel", "flash_fwd_bf16_scores_kernel",
                "flash_bwd_dq_mma_bf16_scores_kernel", "flash_bwd_dkdv_mma_bf16_scores_kernel",
                "flash_bwd_dq_wgmma_bf16_scores_kernel", "flash_bwd_dkdv_wgmma_bf16_scores_kernel",
                "flash_bwd_dq_bf16_scores_kernel", "flash_bwd_dkdv_bf16_scores_kernel",
                "ssd_scan_bwd_kernel", "ssd_scan_bwd_sum_kernel",
                "ssd_scan_bwd_states_mma_kernel", "ssd_scan_bwd_chunk_mma_kernel", "ssd_scan_bwd_mma_sum_kernel")
#: the flash kernels as the profiler names them: forward bf16 on wgmma and on mma.sync, fp32 on the SIMT
#: pipes; the backward's delta pre-pass, and its dQ and dK/dV kernels of each type; each of the bf16-score
#: mode's (``_bf16_scores_kernel``)
FLASH_FN = re.compile(r"\(anonymous namespace\)::((?:flash_fwd_(?:wgmma_|mma_bf16_|mma_bf16_scores_|bf16_scores_|)"
                      r"kernel"
                      r"|flash_bwd_(?:delta|dq_mma_bf16|dkdv_mma_bf16|dq_wgmma|dkdv_wgmma|dq|dkdv|dq_mma_bf16_scores"
                      r"|dkdv_mma_bf16_scores|dq_wgmma_bf16_scores|dkdv_wgmma_bf16_scores|dq_bf16_scores"
                      r"|dkdv_bf16_scores)_kernel)<[^>]*>)")
#: the GEMM's kernels as the profiler names them (wgmma, mma.sync tiles, fp32 FMA)
GEMM_FN = re.compile(r"\(anonymous namespace\)::(gemm_\w+_kernel(?:<[^>]*>)?)")
#: the SSD scan's forward kernels as the profiler names them: the bf16 wgmma route's states and chunk
#: kernels, the mma.sync kernel, the SIMT one
SSD_FN = re.compile(r"\(anonymous namespace\)::(ssd_scan(?:_fwd_states|_fwd_chunk|_mma_bf16)?_kernel<[^>]*>)")
#: the SSD scan's backward kernels as the profiler names them: the SIMT route's reverse scan and the sum of
#: its partials, the tensor-core route's states, chunk and sum kernels (``ssd_scan.bwd_kernels``)
SSD_BWD_FN = re.compile(r"\(anonymous namespace\)::(ssd_scan_bwd(?:_sum|_states_mma|_chunk_mma|_chunk|_mma_sum)?_kernel<[^>]*>)")
#: the SSD backward kernels' mangled names in ``ptxas -v``: the type's, state width's and loads' template arguments
SSD_BWD_PTXAS = r"(ssd_scan_bwd(?:_[a-z]+)*_kernelI(?:f|13__nv_bfloat16|Li\d+E(?:Lb[01]E)?)E)"
#: profiler windows a device-time reading takes at most: the profiler can
#: keep some or none of a window's device records
#: (``scripts/profiler_windows.py`` counts how often)
PROFILER_WINDOWS = 8
#: seconds a grid-reading profiler window waits on the host before its first call and after its last:
#: the card's records can be dated a few ms off the host's (``scripts/profiler_windows.py --pads``)
PROFILER_PAD_S = 0.05
#: the Mamba2-family models whose prefill scan phase 6 times, both served
#: (LM_MODELS): state widths 128 and 64
SSD_MODELS = ("mamba2-130m", "zamba2-2.7b")
#: the comparison arms' online budget in the race, in multiples of Shisha's
#: simulated wall (the paper's "35x faster")
RACE_BUDGET = 35
#: phase 5b: the depth of Shisha's H3 seed on the 4 EPs of streams, so that
#: one EP is always free for a relocation; and the package cap of its DVFS
#: tune, as a share of the seed's nominal package watts (modelled watts,
#: binding at nominal clocks)
PLACE_STAGES, PLACE_CAP_SHARE = 3, 0.7
#: phase 5c: simulated seconds of traffic, the offered load as a share of the
#: split's modelled capacity, and the arrivals' seed
ONLINE_HORIZON, ONLINE_LOAD, ONLINE_SEED = 60.0, 0.6, 5
#: phase 5c (a): the bottleneck EP's scripted slowdown (at 1/4 of the
#: horizon; an in-use EP dies at 1/2 and revives at 3/4)
ONLINE_SLOWDOWN = 3.0
#: phase 5c (b): the chaos spec's mean time between failures and to repair
#: of each slow-class EP, as shares of the horizon (9 s and 2.4 s at 60 s),
#: and the transient batch-error probability (the reference chaos tests')
ONLINE_MTBF, ONLINE_MTTR, ONLINE_BATCH_ERROR_P = 0.15, 0.04, 0.03
#: phase 5c (c): the reference power tour's aggressive thermal RC nodes
#: (``examples/power_tour.py`` stop 6: tau 4 s, a 4 K hysteresis band)
ONLINE_THERMAL = dict(r_k_per_w=(4.0,) * 4, c_j_per_k=(1.0,) * 4, t_hot_c=80.0, t_cool_c=76.0)
#: phase 5d: stream EPs of the co-served platform (4 FEPs and 4 SEPs of 16
#: SMs: the shape of the reference's ``paper_platform(8)``, so a tenant holds
#: 4 and a steal leaves a donor 3), simulated seconds of traffic, and the
#: reference acceptance test's knobs (``tests/test_multitenant_serve.py``)
CO_STREAMS, CO_HORIZON = 8, 60.0
CO_KNOBS = dict(batch_policy_search=True, measure_batches=2, alpha=4)
#: phase 5d's tenants, in partition order: input (H, W, C) and weights seed
CO_TENANTS = {"synthnet": ((220, 220, 3), 0), "resnet50": ((224, 224, 3), 1)}
#: each tenant's offered load as shares of its tuned capacity, and its
#: arrivals' seed: SynthNet Poisson at 0.65, ResNet50 MMPP between 0.08 and
#: 0.30 (the reference fixture's)
CO_LOADS = {"synthnet": (0.65, 11), "resnet50": ((0.08, 0.30), 12)}
#: timed replays of the final splits' graphs, alone and together (best of)
CO_REPS = 5
#: the training main path: per model the depth trained (None: the config's)
#: and the depth of the fp32 gradient comparison.  phi3.5-moe's 2 layers
#: hold 2.9 B parameters, 35 GB of parameters, gradients, fp32 master and
#: bf16 moments; its fp32 comparison at 1 layer (1.3 B parameters, 10.5 GB
#: of weights and gradients in each path).  mamba2-130m and zamba2-2.7b
#: (2.42 B parameters, fewer than granite-3-2b's 2.63 B) train at full
#: size; zamba2's fp32 comparison at one whole group of 6 SSD layers and
#: its shared block.
TRAIN_MODELS = {"granite-3-2b": (None, 2), "phi3.5-moe-42b": (2, 1), "mamba2-130m": (None, 2),
                "zamba2-2.7b": (None, 6)}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 4
#: the resume check's cut of each model (full width): a checkpoint holds 16
#: bytes a parameter (parameters, fp32 master and both moments, bf16 saved
#: as fp32 as the reference saves it), 42 GB at granite-3-2b's full size and
#: 46 GB at phi3.5-moe's 2 layers, and the machine with the card allows 45
#: GiB of disk writes a call.  At 1 layer (phi3.5-moe with 3 of its 16
#: experts, mamba2-130m; zamba2-2.7b at one group of 6 SSD layers and its
#: shared block, the least whole depth) a checkpoint is 4.2, 8.6, 1.3 and
#: 8.1 GB, two of each: 44.5 GB (41.4 GiB).
RESUME_CUT = {"granite-3-2b": dict(n_layers=1), "phi3.5-moe-42b": dict(n_layers=1, n_experts=3),
              "mamba2-130m": dict(n_layers=1), "zamba2-2.7b": dict(n_layers=6)}
#: the gradient of each leaf, kernel path against plain path in fp32, max
#: |difference| over max |plain|: both sum in fp32 in other orders through
#: 1-2 layers, the chunked loss and the embedding's scatter
GRAD_TOL = 1e-3
#: the training loss in bf16 at the trained depth, kernel path against plain
#: path, relative; and each leaf's bf16 gradient there, max |difference|
#: over max |plain|.  scripts/train_grad_sensitivity.py, seeds 0 and 1
#: (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): the kernel path reads 5.3e-6
#: to 3.5e-5 in the loss and 8.3e-3 to 1.2e-2 at its worst leaf (the
#: embedding: bf16 leaves, about 3 roundings of the largest element; this
#: phase, a few steps further on, 1.3e-2 at granite's w_down); the causal
#: mask dropped reads 7.8e-3 to 1.7e-2 in the loss and 0.88 to 1.0 at its
#: worst leaf, the backward without delta 6.8 to 24
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 5e-4, 3e-2
#: the bf16-score mode (phases 6b, 11b), kernel against plain on the same
#: inputs: the root mean square of the difference over that of plain, per
#: tensor (o and the row sums l; dq, dk, dv).  A bf16-rounded score that
#: lands a step apart (the products' fp32 sums in another order) moves one
#: probability by a bf16 step, so the difference is sparse and its max says
#: little: the fp32-score function on the same inputs, whose every
#: probability differs by a rounding, is the control and must miss.  Read
#: on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6): bf16 1.3e-4 at most
#: forward, 3.5e-4 backward, the control 4.0e-3 and 6.0e-3 at least; fp32
#: 0 (the SIMT kernels and cuBLAS add in one order here), the control
#: 3.4e-3 and 5.2e-3 at least.
BF16S_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
#: phase 16's granite-3-2b run with attn_fp32_scores=False: training steps, and the limits of the model
#: in fp32 at the trained depth, kernel path against plain path: the loss's relative difference and the
#: worst leaf's.  Read (PERF.md §6): the kernel path 0 in both (at 2 layers too); the fp32-score control
#: 5.3e-5 and 5.6e-3 at 40 layers (1.6e-6 and 4.9e-3 at 2).  In bf16 the control cannot be told from
#: the kernel path (loss 2.4e-5 against 1.6e-5, worst leaf 1.48e-2 against 1.38e-2: the knob's effect
#: is under the bf16 model's own roundings), so there the kernel path is held as phase 13 holds it and
#: the control is printed.
BF16S_TRAIN_STEPS = 2
BF16S_TRAIN_TOL = (1e-6, 1e-4)
#: phase 16's whisper-small logits with attn_fp32_scores=False, kernel path against plain path, relative
#: to max |logit|.  Read (PERF.md §6): fp32 1.57e-3, bf16 1.68e-2.  Unlike granite's step, the plain
#: path's fp32 sums over the encoder's 1500 frames differ from the kernel's in the last bits and flip
#: bf16-rounded scores, carried through 24 layers; the fp32-score model reads 3.35e-3 and 1.96e-2, so no
#: limit here tells the mode from it: the mode's kernels are held call by call in phases 6b and 11b,
#: and the fp32-score model is printed.
BF16S_LM_TOL = {torch.float32: 5e-3, torch.bfloat16: 5e-2}
#: the SSD and hybrid models' training check, kernel path against plain
#: path beside SSD_TRAIN_CONTROLS, with the model in fp32 with bf16 scans
#: (as hold_bf16_scans holds serving): the trained weights' first
#: SSD_HOLD_DEPTH layers (None: all) and the limits
#: of the loss, relative, and of each leaf's gradient, max |difference| over
#: max |plain|, per model.  scripts/ssd_train_sensitivity.py, seeds 0 and 1
#: (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): in bf16 the kernel path's
#: worst leaf reads 0.17 to 0.24 at mamba2-130m's 24 layers and 1.0 to 1.4
#: at zamba2-2.7b's 54, as high as the dropped carry's 0.24 to 0.38: no
#: limit there tells them apart, as in bf16 SSD logits (SSD_LAYERS).  In fp32 with bf16 scans the kernel path reads
#: 0.048 to 0.067 at mamba2's 24 layers, the faults 0.26 (carry dropped)
#: and 1.0 (ddt without decay) at least; at zamba2's 6 (one group) 0.011 to
#: 0.016 against 0.13 and 1.1 (at 12 layers 0.036 to 0.073 against 0.21; at
#: 24 and 54 the kernel path reads as high as the dropped carry).  The loss
#: reads 4e-7 to 2.3e-5 (both faults are in the backward alone: 0).  This
#: phase reads its weights some steps further on (the warm steps): mamba2
#: 0.042 against 0.17 (carry dropped), zamba2 0.0087 against 0.12, so
#: mamba2's limit sits between 0.067 and 0.17.
SSD_HOLD_DEPTH = {"mamba2-130m": None, "zamba2-2.7b": 6}
SSD_TRAIN_LOSS_TOL = 1e-4
SSD_TRAIN_GRAD_TOL = {"mamba2-130m": 0.1, "zamba2-2.7b": 0.045}
#: resumed losses against the uninterrupted run's, relative: CUDA's
#: ``index_add_`` (MoE dispatch and combine) and the embedding backward sum
#: with atomics in no fixed order, so the resumed steps' gradients differ in
#: the last bits, and Adam's first steps move a weight by about lr whatever
#: its gradient's size; the loss is ln(vocab) ~ 10.4-10.8 at these steps
RESUME_TOL = 2e-3


def _time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _ptxas_entries(source: str, mangled: str) -> dict[str, tuple[int, int, int]]:
    """Registers, spill-store and spill-load bytes of each function of
    ``source`` whose mangled name matches ``mangled`` (the first group names
    it), from ``ptxas -v``."""
    return _ptxas_entries_of(build.ptxas_report(source), mangled)


def _ptxas_entries_of(log: str, mangled: str) -> dict[str, tuple[int, int, int]]:
    """:func:`_ptxas_entries` from a ``ptxas -v`` log."""
    lines = log.splitlines()
    seen = {}
    for i, line in enumerate(lines):
        name = re.search(mangled, line)
        if "Compiling entry function" not in line or not name:
            continue
        props = " ".join(lines[i + 1 : i + 4])
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", props)
        regs = re.search(r"Used (\d+) registers", props)
        seen[name.group(1)] = (int(regs.group(1)), int(spill.group(1)), int(spill.group(2)))
    return seen


def check_flash_ptxas() -> None:
    """Fail unless ``ptxas`` compiled the forward kernels,
    ``flash_fwd_mma_bf16_kernel``, the fp32 ``flash_fwd_kernel`` and both of
    the bf16-score mode's at every head dim and ``flash_fwd_wgmma_kernel``
    at ``flash_attention.FWD_WGMMA_HEAD_DIMS``, with no spill and without
    making the wgmma kernel's ``wgmma`` wait (C7517, C7518), and unless the
    wgmma kernel was built as ``flash_attention.fwd_plan`` plans it and an
    SM holds the blocks it was planned for; print their registers and the
    wgmma kernel's tiling."""
    want = {"flash_fwd_wgmma_kernel": fa.FWD_WGMMA_HEAD_DIMS}
    for kernel in ("flash_fwd_wgmma_kernel", "flash_fwd_mma_bf16_kernel", "flash_fwd_kernel",
                   "flash_fwd_mma_bf16_scores_kernel", "flash_fwd_bf16_scores_kernel"):
        seen = {int(d): v for d, v in _ptxas_entries("flash_attention", kernel + r"ILi(\d+)EE").items()}
        for d, (regs, st, ld) in sorted(seen.items()):
            tiling = ""
            if kernel == "flash_fwd_wgmma_kernel":
                config = fa.fwd_config(d)
                plan = {k: v for k, v in fa.fwd_plan(d).items() if k in config}
                if {k: v for k, v in config.items() if k in plan} != plan \
                        or config["blocks_an_sm"] != plan["planned_blocks_an_sm"]:
                    raise RuntimeError(f"{kernel}<{d}> was built as {config}, fwd_plan plans {plan}")
                tiling = f", {json.dumps(config)}"
            print(f"[build] {kernel}<{d}>: {regs} registers, spill stores {st} B, spill loads {ld} B{tiling}")
        if sorted(seen) != list(want.get(kernel, fa.HEAD_DIMS)):
            raise RuntimeError(f"ptxas compiled {kernel} at head dims {sorted(seen)}, want "
                               f"{want.get(kernel, fa.HEAD_DIMS)}")
        spilled = {d: v for d, v in seen.items() if v[1] or v[2]}
        if spilled:
            raise RuntimeError(f"{kernel} spills: {spilled}")
    waits = [line for line in build.ptxas_report("flash_attention").splitlines()
             if re.search(r"\(C751[78]\)", line) and "flash_fwd_wgmma_kernel" in line]
    if waits:
        raise RuntimeError(f"ptxas made the wgmma of the flash forward wait: {waits}")


def _bwd_name(mangled: str) -> str:
    """A backward kernel's name from its mangled one: ``flash_bwd_dq_kernel<64>``."""
    kernel, args = re.match(r"([a-z0-9_]+_kernel)I(.*)E$", mangled).groups()
    kind = ["__nv_bfloat16"] if "bfloat16" in args else ["float"] if args == "f" else []
    flags = ["true" if v == "1" else "false" for v in re.findall(r"Lb([01])E", args)]
    return f"{kernel}<{', '.join(re.findall(r'Li(\d+)E', args) + kind + flags)}>"


def check_flash_bwd_ptxas() -> None:
    """Fail unless ``ptxas`` compiled every kernel of the flash backward
    (every route's, ``flash_attention.bwd_kernels``: the wgmma route's dQ
    and dK/dV at D 64 and 128; the delta pre-pass of each type; dQ and
    dK/dV at every head dim on ``mma.sync`` and on the SIMT pipes, the
    ``mma.sync`` dK/dV as one pass up to D 80 and as a dV pass and a dK
    pass above; the bf16-score mode's dQ and dK/dV on all three routes)
    with no spill, and without making the wgmma kernels' ``wgmma`` wait
    (C7517, C7518); print each one's registers, and the wgmma kernels'
    blocks an SM."""
    seen = {_bwd_name(n): v for n, v in _ptxas_entries(
        "flash_attention", r"(flash_bwd_[a-z0-9_]+_kernelI(?:Li\d+E)*(?:13__nv_bfloat16|f)?E)").items()}
    want = {name for d in fa.HEAD_DIMS for route in fa.BWD_ROUTES for fp32_scores in (True, False)
            if route != "wgmma" or d in fa.WGMMA_HEAD_DIMS for name in fa.bwd_kernels(route, d, fp32_scores)}
    for name, (regs, st, ld) in sorted(seen.items()):
        occ = ""
        if m := re.match(r"flash_bwd_(dq|dkdv)_wgmma(_bf16_scores)?_kernel<(\d+)>", name):
            occ = f", {fa.bwd_occupancy(int(m.group(3)), not m.group(2), m.group(1) == 'dkdv')} blocks an SM"
        print(f"[build] {name}: {regs} registers, spill stores {st} B, spill loads {ld} B{occ}")
    if set(seen) != want:
        raise RuntimeError(f"ptxas compiled flash backward kernels {sorted(seen)}, want {sorted(want)}")
    spilled = {n: v for n, v in seen.items() if v[1] or v[2]}
    if spilled:
        raise RuntimeError(f"flash backward kernels spill: {spilled}")
    waits = [line for line in build.ptxas_report("flash_attention").splitlines()
             if re.search(r"\(C751[78]\)", line) and re.search(r"wgmma_(?:bf16_scores_)?kernel", line)]
    if waits:
        raise RuntimeError(f"ptxas made the wgmma of the flash backward wait: {waits}")


def check_gemm_ptxas() -> None:
    """Fail unless ``ptxas`` compiled every instantiation of
    ``gemm_wgmma_bf16_kernel`` (clusters of 1 and 2, each pair of operand
    majors and each schedule: ``gemm.KERNELS``) and the decode route's
    ``gemm_decode_bf16_kernel`` and ``gemm_decode_sum_kernel`` (row tiles
    8 and 16) with no spill and without making their ``wgmma``
    wait: C7518 (a wgmma under a branch ptxas cannot prove warp-uniform is
    serialised) and C7517 (a wait injected where other code touches
    registers a wgmma in flight defines); print their registers, and the
    decode kernel's blocks an SM."""
    seen = {tuple(int(v) for v in re.findall(r"Li(\d+)E", n)): v
            for n, v in _ptxas_entries("gemm", r"gemm_wgmma_bf16_kernelI((?:Li\d+E)+)E").items()}
    for args, (regs, st, ld) in sorted(seen.items()):
        print(f"[build] gemm_wgmma_bf16_kernel<{', '.join(map(str, args))}>: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B")
    layouts = [tuple(int(v) for v in re.findall(r"\d", k.split("<C, ")[1])) for k in gm.KERNELS if "<C, " in k]
    want = sorted((c, *layout) for c in (1, 2) for layout in layouts)
    if sorted(seen) != want:
        raise RuntimeError(f"ptxas compiled gemm_wgmma_bf16_kernel<{sorted(seen)}>, want {want}")
    spilled = {c: v for c, v in seen.items() if v[1] or v[2]}
    if spilled:
        raise RuntimeError(f"gemm_wgmma_bf16_kernel spills: {spilled}")
    waits = [line for line in build.ptxas_report("gemm").splitlines()
             if re.search(r"\(C751[78]\)", line) and re.search(r"gemm_(?:wgmma|decode)_bf16_kernel", line)]
    if waits:
        raise RuntimeError(f"ptxas made the wgmma of the GEMM's kernels wait: {waits}")
    decode = {tuple(int(v) for v in re.findall(r"Li(\d+)E", n)) + (kind,): v for kind in ("bf16", "sum")
              for n, v in _ptxas_entries("gemm", rf"(gemm_decode_{kind}_kernelI(?:Li\d+E)+E)").items()}
    for (mt, kind), (regs, st, ld) in sorted(decode.items()):
        occ = f", {gm.decode_occupancy(mt)} blocks an SM" if kind == "bf16" else ""
        print(f"[build] gemm_decode_{kind}_kernel<{mt}>: {regs} registers, spill stores {st} B, spill loads {ld} B"
              f"{occ}")
    if sorted(decode) != [(mt, kind) for mt in (8, 16) for kind in ("bf16", "sum")]:
        raise RuntimeError(f"ptxas compiled the decode kernels {sorted(decode)}, want MT 8 and 16 of each")
    spilled = {c: v for c, v in decode.items() if v[1] or v[2]}
    if spilled:
        raise RuntimeError(f"the decode kernels spill: {spilled}")


def ssd_ptxas() -> dict[tuple[int, int], tuple[int, int, int]]:
    """Registers, spill-store and spill-load bytes of ``ssd_scan_mma_bf16_kernel``
    by (state width, p tile), from ``ptxas -v``; fails unless the bf16
    terms it splits each inexact operand into are the wrapper's and the
    wrapper's shared-memory size agrees with the source's.  Prints each one
    with the blocks of it one SM holds at chunk 64."""
    lib = ssd.library()
    lib.ssd_scan_mma_terms.restype = ctypes.c_int
    if lib.ssd_scan_mma_terms() != ssd.MMA_TERMS:
        raise RuntimeError(f"ssd_scan_mma_bf16_kernel splits into {lib.ssd_scan_mma_terms()} bf16 terms, the "
                           f"wrapper says {ssd.MMA_TERMS}")
    fn = lib.ssd_scan_mma_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    out = {}
    for name, (regs, st, ld) in sorted(_ptxas_entries("ssd_scan", r"(ssd_scan_mma_bf16_kernelILi\d+ELi\d+EE)").items()):
        n, pt = (int(v) for v in re.match(r"ssd_scan_mma_bf16_kernelILi(\d+)ELi(\d+)EE", name).groups())
        out[n, pt] = (regs, st, ld)
        for chunk in ssd.MMA_CHUNKS:
            if fn(n, pt, chunk) != ssd.mma_smem_bytes(chunk, n, pt):
                raise RuntimeError(f"ssd_scan_mma_bf16_kernel<{n}, {pt}> at chunk {chunk}: the source asks "
                                   f"{fn(n, pt, chunk)} B of shared memory, the wrapper counts "
                                   f"{ssd.mma_smem_bytes(chunk, n, pt)}")
        print(f"[build] ssd_scan_mma_bf16_kernel<{n}, {pt}>: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B, {ssd.occupancy(n, pt, 64)} blocks an SM at chunk 64 "
              f"({ssd.mma_smem_bytes(64, n, pt)} B of shared memory)")
    return out


def check_ssd_ptxas() -> None:
    """Fail unless ``ptxas`` compiled ``ssd_scan_mma_bf16_kernel`` at every
    state width and p tile (:func:`ssd_ptxas`) and the wgmma route's states
    and chunk kernels at both state widths with no spill, the latter two
    without a ``wgmma`` made to wait (C7517, C7518) and asking the shared
    memory the wrapper counts (``ssd_scan.fwd_smem_bytes``, at the served
    models' head groups); print their registers."""
    seen = ssd_ptxas()
    want = {(n, pt) for n in ssd.MMA_STATES for pt in ssd.MMA_P_TILES}
    if set(seen) != want:
        raise RuntimeError(f"ptxas compiled ssd_scan_mma_bf16_kernel for {sorted(seen)}, want {sorted(want)}")
    spilled = {k: v for k, v in seen.items() if v[1] or v[2]}
    if spilled:
        raise RuntimeError(f"ssd_scan_mma_bf16_kernel spills (state width, p tile): {spilled}")
    fwd = {re.sub(r"ILi(\d+)EE.*", r"<\1>", m): v for m, v in _ptxas_entries(
        "ssd_scan", r"(ssd_scan_fwd_(?:states|chunk)_kernelILi\d+EE)").items()}
    for name, (regs, st, ld) in sorted(fwd.items()):
        print(f"[build] {name}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    want = {f"ssd_scan_fwd_{k}_kernel<{n}>" for k in ("states", "chunk") for n in ssd.WGMMA_STATES}
    if set(fwd) != want:
        raise RuntimeError(f"ptxas compiled the wgmma SSD forward's kernels {sorted(fwd)}, want {sorted(want)}")
    spilled = {k: v for k, v in fwd.items() if v[1] or v[2]}
    if spilled:
        raise RuntimeError(f"the wgmma SSD forward's kernels spill: {spilled}")
    waits = [line for line in build.ptxas_report("ssd_scan").splitlines()
             if re.search(r"\(C751[78]\)", line) and "ssd_scan_fwd" in line]
    if waits:
        raise RuntimeError(f"ptxas made the wgmma of the SSD forward wait: {waits}")
    fn = ssd.library().ssd_scan_fwd_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    for arch in SSD_MODELS:
        cfg = get_config(arch)
        n, hg = cfg.ssm_state, ssd.bwd_head_group(LM_BATCH, LM_PROMPT, cfg.ssm_heads)
        source = fn(n, hg, 0), fn(n, hg, 1)
        if source != ssd.fwd_smem_bytes(n, hg):
            raise RuntimeError(f"the wgmma SSD forward's states and chunk kernels at state {n}, {hg} heads a block, "
                               f"ask {source} B of shared memory, the wrapper counts {ssd.fwd_smem_bytes(n, hg)}")
        print(f"[build] SSD forward, wgmma route at {arch}'s state {n} and {hg} heads a chunk block: {source} B "
              f"of shared memory a block (states, chunk)")


def check_ssd_bwd_ptxas() -> None:
    """Fail unless ``ptxas`` compiled every kernel of the SSD backward
    (every route's, ``ssd_scan.bwd_kernels``: the SIMT route's
    ``ssd_scan_bwd_kernel`` and ``ssd_scan_bwd_sum_kernel`` in fp32 and
    bf16; the tensor-core routes' states kernel, ``mma.sync`` chunk kernel
    and ``wgmma`` chunk kernel (TMA and ``cp.async`` loads) at state widths
    64 and 128 and their sum) with no spill and no ``wgmma`` made to wait
    (C7517, C7518), and unless the tensor-core routes' shared memory is
    what the wrapper counts (``ssd_scan.mma_bwd_smem_bytes``,
    ``ssd_scan.wgmma_bwd_smem_bytes`` at the training shapes' head groups);
    print each one's registers."""
    seen = {_bwd_name(m): v for m, v in _ptxas_entries("ssd_scan", SSD_BWD_PTXAS).items()}
    for name, (regs, st, ld) in sorted(seen.items()):
        print(f"[build] {name}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    want = {name for dtype in (torch.float32, torch.bfloat16) for name in ssd.bwd_kernels("simt", dtype, 128)}
    want |= {name for n in ssd.MMA_BWD_STATES for route in ("mma", "wgmma") for tma in (True, False)
             for name in ssd.bwd_kernels(route, torch.bfloat16, n, tma)}
    if set(seen) != want:
        raise RuntimeError(f"ptxas compiled SSD backward kernels {sorted(seen)}, want {sorted(want)}")
    spilled = {n: v for n, v in seen.items() if v[1] or v[2]}
    if spilled:
        raise RuntimeError(f"SSD backward kernels spill: {spilled}")
    waits = [line for line in build.ptxas_report("ssd_scan").splitlines()
             if re.search(r"\(C751[78]\)", line) and "ssd_scan_bwd" in line]
    if waits:
        raise RuntimeError(f"ptxas made the wgmma of the SSD backward wait: {waits}")
    fn = ssd.library().ssd_scan_bwd_mma_smem_bytes
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    for n in ssd.MMA_BWD_STATES:
        source = fn(n, 0), fn(n, 1)
        if source != ssd.mma_bwd_smem_bytes(n):
            raise RuntimeError(f"the SSD backward's states and chunk kernels at state {n} ask {source} B of shared "
                               f"memory, the wrapper counts {ssd.mma_bwd_smem_bytes(n)}")
        print(f"[build] SSD backward, tensor-core route at state {n}: {source} B of shared memory a block "
              f"(states, chunk)")
    fn = ssd.library().ssd_scan_bwd_wgmma_smem_bytes
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    for arch in SSD_MODELS:
        cfg = get_config(arch)
        n, hg = cfg.ssm_state, ssd.bwd_head_group(TRAIN_BATCH, TRAIN_SEQ, cfg.ssm_heads)
        if fn(n, hg) != ssd.wgmma_bwd_smem_bytes(n, hg) or fn(n, hg) > ssd.MAX_SMEM_BYTES:
            raise RuntimeError(f"the SSD backward's wgmma chunk kernel at state {n}, {hg} heads a block, asks "
                               f"{fn(n, hg)} B of shared memory, the wrapper counts {ssd.wgmma_bwd_smem_bytes(n, hg)} "
                               f"(at most {ssd.MAX_SMEM_BYTES})")
        print(f"[build] SSD backward, wgmma route at {arch}'s state {n} and {hg} heads a chunk block: {fn(n, hg)} B "
              f"of shared memory a chunk-kernel block")


def check_conv_ptxas() -> None:
    """Fail unless ``ptxas`` compiled ``conv2d_im2col_kernel`` for every
    tile of ``im2col_conv.TILES`` with 16-byte and with 4-byte copies, and
    the split sum, with no spill; print each kernel's registers and the
    blocks of it one SM holds at once."""
    seen = _ptxas_entries("conv2d_im2col", r"(conv2d_im2col_kernelILi\d+ELi\d+ELb[01]EE|conv_split_sum_kernel)")
    want = {f"conv2d_im2col_kernelILi{bm}ELi{bn}ELb{v}EE" for bm, bn in im2col_conv.TILES for v in (0, 1)}
    want.add("conv_split_sum_kernel")
    for name, (regs, st, ld) in sorted(seen.items()):
        tile = re.match(r"conv2d_im2col_kernelILi(\d+)ELi(\d+)ELb([01])EE", name)
        occ = ""
        if tile:
            bm, bn, v = (int(g) for g in tile.groups())
            name = f"conv2d_im2col_kernel<{bm}, {bn}, {'16-byte' if v else '4-byte'} copies>"
            occ = f", {im2col_conv.occupancy(bm, bn, bool(v))} blocks an SM"
        print(f"[build] {name}: {regs} registers, spill stores {st} B, spill loads {ld} B{occ}")
    if set(seen) != want:
        raise RuntimeError(f"ptxas compiled conv kernels {sorted(seen)}, want {sorted(want)}")
    spilled = {n: v for n, v in seen.items() if v[1] or v[2]}
    if spilled:
        raise RuntimeError(f"conv kernels spill: {spilled}")


def _conv_shapes(specs, batch: int) -> list[dict]:
    """Distinct (x, w, stride) shapes the layers give the conv, with the
    layers that share each."""
    shapes: dict[tuple, dict] = {}
    for sp in specs:
        in_h = sp.h_out * sp.stride
        key = ((batch, in_h, in_h, sp.c_in), (sp.r, sp.s, sp.c_in, sp.k), sp.stride)
        shapes.setdefault(key, {"x": key[0], "w": key[1], "stride": sp.stride, "layers": []})
        shapes[key]["layers"].append(sp.name)
    return list(shapes.values())


def conv_inputs(sh: dict, gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Random x and w (scaled by 1/sqrt(R*S*C)) of one conv shape, on the card."""
    x = torch.randn(sh["x"], generator=gen, device="cuda")
    r, s, c, _ = sh["w"]
    w = torch.randn(sh["w"], generator=gen, device="cuda") / (r * s * c) ** 0.5
    return x, w, sh["stride"]


def cudnn_conv(x: torch.Tensor, w: torch.Tensor, stride: int):
    """cuDNN's ``F.conv2d`` on the same conv as a call: NCHW views of the
    NHWC data, padded beforehand (asymmetric SAME padding is not one
    ``F.conv2d`` argument)."""
    r, s = w.shape[:2]
    _, _, pt, pb, pl, pr = im2col_conv.same_padding(x.shape[1], x.shape[2], r, s, stride)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(xp, wl, stride=stride)


def cudnn_ms(x: torch.Tensor, w: torch.Tensor, stride: int, device: bool = False) -> tuple[float, float]:
    """:func:`cudnn_conv`'s time (TF32 off), by CUDA events: with
    ``cudnn.benchmark`` off (the algorithm its heuristic picks:
    ``library_ms``) and on (the fastest one it finds by timing:
    ``library_best_ms``), then the setting restored; with ``device``, by the
    profiler's device time instead (``_device_ms``)."""
    call = cudnn_conv(x, w, stride)
    before = torch.backends.cudnn.benchmark
    def timer(fn):
        return _device_ms(fn, need=False)[0] if device else _time_ms(fn)

    try:
        torch.backends.cudnn.benchmark = False
        plain = timer(call)
        torch.backends.cudnn.benchmark = True
        best = timer(call)
    finally:
        torch.backends.cudnn.benchmark = before
    return plain, best


def _forward_total(rows: list[dict]) -> dict:
    """One forward of a network at a microbatch of 2: each shape's readings
    weighted by the number of layers that run it, and the bound of the sum."""
    tot = {key: None if any(r[key] is None for r in rows) else sum(len(r["layers"]) * r[key] for r in rows)
           for key in ("flops", "bytes", "ms", "plain_ms", "library_ms", "library_best_ms", "device_ms",
                       "library_device_ms")}
    t_ops, t_bytes = tot["flops"] / PEAK_FP32_FLOPS, tot["bytes"] / HBM_BYTES_PER_S
    return {**tot, "bound_ms": max(t_ops, t_bytes) * 1e3, "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def check_conv(gen: torch.Generator) -> dict:
    """Phase 3 for ``conv2d_im2col``: parity everywhere, the same bits over
    two calls, each SynthNet and ResNet50 shape's plan and times, and the
    times of one forward of each."""
    synth = [{**sh, "net": "synthnet"} for sh in _conv_shapes(synthnet_specs(), batch=BATCH)]
    resnet = [{**sh, "net": "resnet50"} for sh in _conv_shapes(resnet50_specs(), batch=BATCH)]
    extra = [
        {"x": (2, 12, 12, 8), "w": (r, r, 8, 24), "stride": st, "layers": []}
        for r in (1, 3, 5)
        for st in (1, 2)
    ] + [
        {"x": (3, 13, 11, 5), "w": (3, 3, 5, 67), "stride": 1, "layers": []},  # ragged K, M, C
        {"x": (2, 20, 20, 8), "w": (11, 11, 8, 17), "stride": 4, "layers": []},  # 11x11 stride 4, ragged K
    ]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, max_err = [], 0.0
    for sh in synth + resnet + extra:
        x, w, st = conv_inputs(sh, gen)
        r, s, c, k = sh["w"]
        y = im2col_conv.conv2d_im2col(x, w, stride=st)
        again = im2col_conv.conv2d_im2col(x, w, stride=st)
        yp = im2col_conv.conv2d_im2col_plain(x, w, stride=st)
        torch.cuda.synchronize()
        err = (y - yp).abs().max().item()
        max_err = max(max_err, err)
        if not torch.allclose(y, yp, rtol=KERNEL_TOL, atol=KERNEL_TOL):
            raise RuntimeError(f"conv2d_im2col disagrees with its plain version at {sh}: max abs err {err}")
        if not torch.equal(y, again):
            raise RuntimeError(f"conv2d_im2col gave other bits on a second call at {sh}")
        p = im2col_conv.plan(tuple(x.shape), tuple(w.shape), st, sms=sms)
        row = {"x": list(sh["x"]), "w": list(sh["w"]), "stride": st, "max_abs_err": err,
               "plan": {"tile": f"{p.bm}x{p.bn}", "thread": f"{p.tm}x{p.tn}", "splits": p.splits,
                        "blocks": p.blocks, "copies": 16 if p.vector else 4}}
        if sh["layers"]:
            if sh["net"] == "synthnet" and p.blocks < sms:
                raise RuntimeError(f"plan {p} launches {p.blocks} blocks on {sms} SMs at {sh}")
            flops, nbytes = im2col_conv.cost(x, w, st)
            lib_ms, lib_best_ms = cudnn_ms(x, w, st)
            row.update(
                net=sh["net"],
                layers=sh["layers"],
                flops=flops,
                bytes=nbytes,
                bound_ms=max(flops / PEAK_FP32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
                bound_by="operations" if flops / PEAK_FP32_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes",
                ms=_time_ms(lambda: im2col_conv.conv2d_im2col(x, w, stride=st)),
                plain_ms=_time_ms(lambda: im2col_conv.conv2d_im2col_plain(x, w, stride=st)),
                library_ms=lib_ms,
                library_best_ms=lib_best_ms,
                device_ms=_device_ms(lambda: im2col_conv.conv2d_im2col(x, w, stride=st))[0],
                library_device_ms=cudnn_ms(x, w, st, device=True)[0],
                host_ms=_host_ms(lambda: im2col_conv.conv2d_im2col(x, w, stride=st)),
                library_host_ms=_host_ms(cudnn_conv(x, w, st)),
            )
            row["tflops"] = flops / row["ms"] / 1e9
        rows.append(row)
        print(f"[check] conv2d_im2col {json.dumps(row)}")

    # one forward of full-width SynthNet (the main path's) and of ResNet50
    # (phase 5d's second tenant) at a microbatch of 2
    tot = _forward_total([r for r in rows if r.get("net") == "synthnet"])
    r50 = _forward_total([r for r in rows if r.get("net") == "resnet50"])
    print(f"[check] conv2d_im2col one ResNet50 forward (microbatch of {BATCH}, {len(resnet)} shapes, 50 layers): "
          + json.dumps(r50))
    return {
        "name": "conv2d_im2col",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/conv2d_im2col.cu",
        "replaces": "src/repro/kernels/im2col_conv.py:48",
        "max_abs_err": max_err,
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": tot["bound_by"],
        "library_ms": tot["library_ms"],
        "library_best_ms": tot["library_best_ms"],
        "device_ms": tot["device_ms"],
        "library_device_ms": tot["library_device_ms"],
        "resnet50_forward": {k: r50[k] for k in ("ms", "plain_ms", "device_ms", "bound_ms", "bound_by", "library_ms",
                                                  "library_best_ms", "library_device_ms")},
    }


def time_to_converge(trace: Trace, final_frac: float = 0.99) -> float:
    """Simulated wall time when the best-so-far throughput first reaches
    ``final_frac`` of its final value (``benchmarks/fig4_convergence.py``'s
    definition)."""
    curve = trace.convergence_curve()
    if not curve:
        return float("inf")
    final = curve[-1][1]
    for t, tp in curve:
        if tp >= final_frac * final:
            return t
    return curve[-1][0]


def race(res) -> None:
    """Phase 5's race: the paper's Fig. 4 comparison on the measured oracle
    of phase 4 (``res.evaluator``: every SynthNet layer timed on the card).
    Shisha H3 first; HC, HC from Shisha's seed, SA, SA from the seed and RW
    each get RACE_BUDGET times Shisha's simulated wall; Pipe-Search and ES
    pay the database's generation cost up front, ES over the whole space.
    Fails if an arm's best modelled throughput exceeds ES's, which covers
    the whole space on the same deterministic oracle.  Then runs the best
    splits of Shisha, HC and SA as stream pipelines."""
    ev = res.evaluator
    n, n_eps, ws = len(ev.layers), ev.platform.n_eps, weights(ev.layers)
    traces, results, host = {}, {}, {}

    def run(name, trace, fn):
        t0 = time.perf_counter()
        results[name] = fn(trace)
        host[name] = time.perf_counter() - t0
        traces[name] = trace

    run("Shisha", Trace(ev), lambda tr: run_shisha(ws, tr, "H3").result)
    budget = RACE_BUDGET * traces["Shisha"].wall
    seed_conf = generate_seed(ws, ev.platform, choice="rank_w").conf
    run("HC", Trace(ev), lambda tr: hill_climbing(tr, n, budget, seed=0))
    run("HC_s", Trace(ev), lambda tr: hill_climbing(tr, n, budget, start=seed_conf, seed=0))
    run("SA", Trace(ev), lambda tr: simulated_annealing(tr, n, budget, seed=0))
    run("SA_s", Trace(ev), lambda tr: simulated_annealing(tr, n, budget, start=seed_conf, seed=0))
    run("RW", Trace(ev), lambda tr: random_walk(tr, n, budget, seed=0))
    db = database_generation_cost(n, n_eps)
    run("PS", Trace(ev, setup_cost=db), lambda tr: pipe_search(tr, ws, budget_s=db + budget))
    run("ES", Trace(ev, setup_cost=db), lambda tr: exhaustive_search(tr, n))
    if traces["ES"].n_trials != space_size(n, n_eps):
        raise RuntimeError(f"ES tried {traces['ES'].n_trials} of {space_size(n, n_eps)} configurations")
    es = results["ES"].best_throughput
    table = {}
    for name, r in results.items():
        table[name] = {"trials": traces[name].n_trials, "time_to_converge_s": time_to_converge(traces[name]),
                       "wall_s": traces[name].wall, "best_micro_per_s": r.best_throughput,
                       "best_over_es": r.best_throughput / es, "host_s": host[name],
                       "best_conf": r.best_conf.pretty([ep.name for ep in ev.platform.eps])}
        print(f"[race] {name}: {json.dumps(table[name])}")
    print(f"[race] budget {budget:.3f} s simulated ({RACE_BUDGET}x Shisha's wall), database "
          f"{db:.3f} s, whole space {space_size(n, n_eps)} configurations")
    over = {name: row["best_micro_per_s"] for name, row in table.items() if row["best_micro_per_s"] > es}
    if over:
        raise RuntimeError(f"arms beat the exhaustive optimum {es} on the same oracle: {over}")
    for name in ("Shisha", "HC", "SA"):  # the chosen splits, run for real
        conf = results[name].best_conf
        runner = PipelineRunner(mesh=make_stage_mesh(conf.depth, res.micro.device), conf=conf,
                                apply_layer=res.model.apply_layer, n_micro=N_MICRO)
        table[name]["measured_micro_per_s"] = pipeline_throughput(runner, res.micro)
        print(f"[race] {name}'s split {table[name]['best_conf']} as a stream pipeline: measured "
              f"{table[name]['measured_micro_per_s']:.3f} micro/s, modelled {table[name]['best_micro_per_s']:.3f}")


class RelocationTrace(Trace):
    """A ``Trace`` that counts the trials charged a relocation's own
    ``reconfig_cost`` (``tune(placement=True)``'s EP moves)."""

    def __post_init__(self):
        super().__post_init__()
        self.relocations = 0

    def execute(self, conf, reconfig_cost=None):
        if reconfig_cost is not None:
            self.relocations += 1
        return super().execute(conf, reconfig_cost)


def place_and_scale(res, seq: torch.Tensor) -> dict:
    """Phase 5b: Shisha's placement and DVFS moves on the measured oracle of
    phase 4 (``res.evaluator``; nothing is measured again), from the H3 seed
    at PLACE_STAGES stages on the 4-EP platform of streams.

    (a) ``scalar_fabric`` and ``degenerate_power`` attached: ``tune(placement=
    True, dvfs=True)`` must give the bare platform's ``tune(placement=True)``
    bit for bit (trials, best split and throughput, trials counted, wall).
    (b) A 2x2 ``mesh2d`` fabric at the stream EPs' own ``link_bw`` and
    ``link_latency``: ``tune(placement=True)`` must pay at least one
    relocation trial.  (c) The same fabric and ``uniform_power`` capped at
    PLACE_CAP_SHARE of the seed's nominal package watts: ``tune(placement=
    True, dvfs=True)`` must return levels under which its split meets the
    cap.  Then (b)'s and (c)'s splits run as stream pipelines ((c)'s only
    where it differs from (b)'s), each output equal to ``seq`` (the sequential model on the same kernels), and their
    measured microbatches/s are printed.  Watts, levels and throughputs of
    the tuner are the model's (the measured oracle prices the link as a
    scalar and ignores DVFS, as the reference's does); only the
    microbatches/s are the card's."""
    ev = res.evaluator
    bare = ev.platform
    assignment, balancing = HEURISTICS["H3"]
    seed = generate_seed(weights(ev.layers), bare, n_stages=PLACE_STAGES, choice=assignment).conf
    names = [ep.name for ep in bare.eps]
    out = {"seed": seed.pretty(names)}

    def tuned(platform, alpha=10, **kw):
        trace = RelocationTrace(ev.on_platform(platform))
        return tune(seed, trace, alpha=alpha, balancing=balancing, placement=True, **kw), trace

    def trials(trace):
        return [(t.conf, t.throughput, t.t_wall) for t in trace.trials]

    # (a) the degenerate fabric and power model are the bare platform
    base, base_tr = tuned(bare)
    degen, degen_tr = tuned(bare.with_fabric(scalar_fabric(bare)).with_power(degenerate_power(bare)), dvfs=True)
    got = (degen.best_conf, degen.best_throughput, degen.n_explored, degen_tr.wall, trials(degen_tr))
    want = (base.best_conf, base.best_throughput, base.n_explored, base_tr.wall, trials(base_tr))
    if got != want:
        raise RuntimeError(f"degenerate fabric and power moved the tune: {got[:4]} != {want[:4]}")
    print(f"[place] (a) scalar_fabric + degenerate_power == bare tune(placement=True) bit for bit: "
          f"{base.n_explored} trials, wall {base_tr.wall!r} s, best {base.best_conf.pretty(names)} "
          f"at {base.best_throughput!r} micro/s (modelled)")

    # (b) a routed 2x2 mesh at the stream EPs' own link: routes, hops, contention
    links = {(ep.link_bw, ep.link_latency) for ep in bare.eps}
    if len(links) != 1:
        raise RuntimeError(f"stream EPs with different links: {links}")
    (bw, lat), = links
    mesh = uniform_fabric(mesh2d(2, 2, bw=bw, latency=lat))
    routed = bare.with_fabric(mesh)
    placed, placed_tr = tuned(routed)
    if placed_tr.relocations == 0:
        raise RuntimeError("no relocation trial was paid on the routed mesh")
    # the seed's farthest relocation the tune can make: a stage onto a free
    # EP (placement_candidate proposes no other), the most hops first
    free = [e for e in range(bare.n_eps) if e not in seed.eps]
    stage, to = max(((st, e) for st in range(seed.depth) for e in free),
                    key=lambda se: (len(mesh.route_ep(seed.eps[se[0]], se[1])), -se[0], -se[1]))
    out["placed"] = {"trials": placed.n_explored, "relocation_trials": placed_tr.relocations,
                     "wall_s": placed_tr.wall, "best_conf": placed.best_conf.pretty(names),
                     "modelled_micro_per_s": placed.best_throughput,
                     "far_relocation": f"stage {stage} {names[seed.eps[stage]]} -> {names[to]}, "
                                       f"{len(mesh.route_ep(seed.eps[stage], to))} hops",
                     "far_relocation_cost_s": placement_reconfig_cost(placed_tr, seed, stage, to),
                     "flat_overhead_s": placed_tr.reconfig_overhead}
    print(f"[place] (b) mesh2x2 at link_bw {bw!r} B/s, latency {lat!r} s: " + json.dumps(out["placed"]))

    # (c) DVFS under a binding package cap, on the same fabric
    nominal_w = uniform_power(bare).package_w(seed.eps)
    cap = PLACE_CAP_SHARE * nominal_w
    # alpha=0 stops the tune after its cap walk: the levels it enforces
    enforced = tuned(routed.with_power(uniform_power(bare, cap_w=cap)), alpha=0, dvfs=True)[0].dvfs_levels
    pm = uniform_power(bare, cap_w=cap)
    capped, capped_tr = tuned(routed.with_power(pm), dvfs=True)
    levels = capped.dvfs_levels
    if levels is None or pm.snapshot() != levels or not pm.cap_feasible(capped.best_conf.eps):
        raise RuntimeError(f"capped tune returned levels {levels} that break the {cap} W cap "
                           f"on {capped.best_conf.pretty(names)}")
    out["capped"] = {"cap_w_modelled": cap, "nominal_w_modelled": nominal_w,
                     "enforced_levels": list(enforced), "adopted_levels": list(levels),
                     "package_w_modelled": pm.package_w(capped.best_conf.eps), "trials": capped.n_explored,
                     "relocation_trials": capped_tr.relocations, "wall_s": capped_tr.wall,
                     "best_conf": capped.best_conf.pretty(names), "modelled_micro_per_s": capped.best_throughput}
    print("[place] (c) DVFS under the cap: " + json.dumps(out["capped"]))

    # the tuned splits, run for real; (c)'s only where it differs from (b)'s
    for name, conf in (("placed", placed.best_conf), ("capped", capped.best_conf)):
        if name == "capped" and conf == placed.best_conf:
            out[name]["measured_micro_per_s"] = out["placed"]["measured_micro_per_s"]
            print(f"[place] capped split {conf.pretty(names)} is the placed split: its measurement above")
            continue
        runner = PipelineRunner(mesh=make_stage_mesh(conf.depth, res.micro.device), conf=conf,
                                apply_layer=res.model.apply_layer, n_micro=N_MICRO)
        got = runner.run(res.micro)
        if not torch.equal(got, seq):
            raise RuntimeError(f"{name} split {conf.pretty(names)} differs from the sequential model: "
                               f"{(got - seq).abs().max().item()}")
        out[name]["measured_micro_per_s"] = pipeline_throughput(runner, res.micro)
        print(f"[place] {name} split {conf.pretty(names)} as a stream pipeline: == sequential, measured "
              f"{out[name]['measured_micro_per_s']:.3f} micro/s on {res.micro.device}, modelled "
              f"{out[name]['modelled_micro_per_s']:.3f} micro/s")
    return out


def _installed(result, tuner) -> list[tuple[float, object]]:
    """(install time, ``Retune``) of each re-tune the simulator installed:
    the simulator logs a re-tune when it installs it, at the end of its
    exploration window, and decides the next only after that, so the logged
    entries are the first of the tuner's history, in order."""
    out = []
    for entry, rt in zip(result.reconfigs, tuner.history):
        if (entry["kind"], entry["new_depth"]) != (rt.kind, rt.conf.depth):
            raise RuntimeError(f"installed re-tune {entry} is not the tuner's {rt.kind} at depth {rt.conf.depth}")
        out.append((entry["t"] + entry["tuning_cost_s"], rt))
    if len(out) != len(result.reconfigs):
        raise RuntimeError(f"{len(result.reconfigs)} re-tunes installed, the tuner decided {len(tuner.history)}")
    return out


def _held(result) -> int:
    """Requests a ``SimResult`` accounts for at its horizon."""
    return result.n_completed + result.n_queued + result.n_in_flight + result.n_shed + result.n_failed


def serve_online(res, seq: torch.Tensor, horizon: float = ONLINE_HORIZON) -> dict:
    """Phase 5c: online Shisha on the measured oracle of phase 4
    (``res.evaluator``; nothing is measured again).

    The serving simulator serves phase 4's split ``res.conf`` under
    ``PoissonTraffic`` at ONLINE_LOAD of its modelled capacity for
    ``horizon`` simulated seconds, with the SLO at 3x the split's pipeline
    latency; ``ContinuousShisha`` keeps the reference's defaults and re-tunes
    over ``res.evaluator.on_platform`` of its model of the drifted machine.
    (a) scripted drift, (b) chaos and (c) thermal throttling, each checked
    as the module docstring says; then every split a re-tune installed runs
    as a stream pipeline of ``res.micro``, each output equal to ``seq``.
    Simulated times, throughputs, watts and temperatures are the model's;
    only the pipelines' microbatches/s are the card's.
    """
    ev, conf = res.evaluator, res.conf
    bare = ev.platform
    names = [ep.name for ep in bare.eps]
    times = ev.stage_times(conf)
    cap, slo = 1.0 / max(times), 3.0 * sum(times)
    arrivals = PoissonTraffic(rate=ONLINE_LOAD * cap, seed=ONLINE_SEED).arrivals(horizon)
    knobs = ContinuousShisha(bare, ev.layers, make_evaluator=ev.on_platform)
    knobs = {k: getattr(knobs, k) for k in ("alpha", "measure_batches", "reconfig_overhead",
                                              "reconfig_downtime", "cooldown")}
    monitor = ServingSimulator(ev, conf).monitor_interval
    out = {"split": conf.pretty(names), "cap_micro_per_s_modelled": cap, "slo_s_modelled": slo,
           "arrivals": len(arrivals), "horizon_s": horizon, "tuner": knobs, "monitor_interval_s": monitor}
    print(f"[online] serving {out['split']}: cap {cap!r} micro/s, beat {max(times) * 1e3:.4f} ms, SLO "
          f"{slo * 1e3:.4f} ms (modelled); {len(arrivals)} Poisson arrivals at {ONLINE_LOAD} x cap over "
          f"{horizon} simulated s; ContinuousShisha defaults {json.dumps(knobs)}, monitor every {monitor} s: "
          f"measure {knobs['measure_batches']}, cooldown {knobs['cooldown'] / max(times):.0f} and monitor "
          f"{monitor / max(times):.0f} beats")

    def serve(platform, script=(), **kw):
        tuner = ContinuousShisha(platform, ev.layers, make_evaluator=ev.on_platform)
        sim = ServingSimulator(ev.on_platform(platform), conf, slo=slo, autotuner=tuner, **kw)
        for fn in script:
            fn(sim)
        t0 = time.perf_counter()
        result = sim.run(arrivals, horizon)
        host = time.perf_counter() - t0
        # every request is completed, queued, in flight, shed or failed; with
        # a resilience policy a request may also wait out a retry backoff at
        # the horizon, which SimResult counts nowhere (as the reference's)
        gap = result.n_arrived - _held(result)
        if result.n_arrived != len(arrivals) or not 0 <= gap <= (result.n_retries if "resilience" in kw else 0):
            raise RuntimeError(f"requests lost: {len(arrivals)} sent, {result.n_arrived} arrived, "
                               f"{_held(result)} held, {result.n_retries} retries")
        return result, tuner, host

    def same(name, a, b):
        if dataclasses.asdict(a) != dataclasses.asdict(b):
            raise RuntimeError(f"{name}: the SimResults differ: {a.summary()} != {b.summary()}")

    def kinds(tuner):
        return [r.kind for r in tuner.history]

    installed = []  # (scenario, install time, Retune)

    # (a) scripted drift: slowdown, dropout, revival
    bad = conf.eps[max(range(conf.depth), key=times.__getitem__)]
    t_slow, t_drop, t_revive = horizon / 4, horizon / 2, 3 * horizon / 4
    slow = (lambda sim: sim.schedule_slowdown(t_slow, bad, ONLINE_SLOWDOWN),)
    probe, probe_tuner, _ = serve(bare, slow)
    # the split in force at the dropout (runs agree up to it): its slowed
    # EP if it still serves, so the revival finds no slowed EP in use
    at_drop = conf
    for t, rt in _installed(probe, probe_tuner):
        if t <= t_drop:
            at_drop = rt.conf
    dead = bad if bad in at_drop.eps else at_drop.eps[0]
    script = slow + (lambda sim: sim.schedule_dropout(t_drop, dead), lambda sim: sim.schedule_revival(t_revive, dead))
    drift, tuner, host = serve(bare, script)
    got, want = iter(kinds(tuner)), ("slowdown", "dropout", "recovery")
    if not all(any(k == w for k in got) for w in want):
        raise RuntimeError(f"re-tunes {kinds(tuner)} lack {want} in that order")
    for t, rt in _installed(drift, tuner):
        installed.append(("drift", t, rt))
        if t_drop <= t < t_revive and dead in rt.conf.eps:
            raise RuntimeError(f"{rt.kind} re-tune installed {rt.conf.pretty(names)} at {t} s on dead {names[dead]}")
    same("drain vs heap engine", drift, serve(bare, script, loop=HeapEventLoop())[0])
    same("rerun", drift, serve(bare, script)[0])
    exports = []
    for _ in range(2):
        tl = Telemetry()
        traced, traced_tuner, _ = serve(bare, script, telemetry=tl)
        same("live telemetry vs none", drift, traced)
        paid = sum(rt.tune_result.n_explored for rt in traced_tuner.history)
        counted = tl.metrics_snapshot().get("tune.trials", {}).get("value")
        if counted != paid:
            raise RuntimeError(f"telemetry counted {counted} tune trials, the re-tunes paid {paid}")
        exports.append((tl.export_jsonl(), json.dumps(tl.export_chrome_trace(), allow_nan=False)))
    if exports[0] != exports[1]:
        raise RuntimeError("two seeded reruns exported different telemetry")
    out["drift"] = {"slowed": names[bad], "dead": names[dead], "kinds": kinds(tuner),
                    "trials": [rt.tune_result.n_explored for rt in tuner.history],
                    "tuning_cost_s_modelled": [rt.tuning_cost for rt in tuner.history],
                    "splits": [rt.conf.pretty(names) for rt in tuner.history],
                    "tune_trials_counted": paid, "jsonl_bytes": len(exports[0][0]),
                    "chrome_bytes": len(exports[0][1]), "host_s": host, "summary": drift.summary(),
                    "p99_s_modelled": drift.p99}
    print(f"[online] (a) slowdown of {names[bad]} x{ONLINE_SLOWDOWN} at {t_slow} s, {names[dead]} dead at "
          f"{t_drop} s and revived at {t_revive} s: " + json.dumps(out["drift"]))
    print("[online] (a) drain == heap engine, rerun == run, live Telemetry == none and counts "
          f"{paid} tune.trials == the re-tunes' trials; JSONL and Chrome exports byte-identical over two reruns")

    # (b) chaos: seeded EP failures on the slow class and batch errors
    worst = max(ep.perf_class for ep in bare.eps)
    slow_eps = [i for i, ep in enumerate(bare.eps) if ep.perf_class == worst]
    # the fault model keys failure rates by perf class
    chaos = FaultModel(seed=7, ep_mtbf={worst: ONLINE_MTBF * horizon}, ep_mttr={worst: ONLINE_MTTR * horizon},
                       batch_error_p=ONLINE_BATCH_ERROR_P)
    policy = ResiliencePolicy(deadline_s=slo)
    first, chaos_tuner, host = serve(bare.with_faults(chaos), resilience=policy)
    same("chaos rerun", first, serve(bare.with_faults(chaos), resilience=policy)[0])
    same("no_faults() vs the bare platform", serve(bare, resilience=policy)[0],
         serve(bare.with_faults(no_faults()), resilience=policy)[0])
    strict = json.dumps(dataclasses.asdict(first), allow_nan=False)
    for t, rt in _installed(first, chaos_tuner):
        installed.append(("chaos", t, rt))
    out["chaos"] = {"failing": [names[e] for e in slow_eps], "mtbf_s": ONLINE_MTBF * horizon,
                    "mttr_s": ONLINE_MTTR * horizon, "batch_error_p": ONLINE_BATCH_ERROR_P,
                    "deadline_s_modelled": slo, "kinds": kinds(chaos_tuner),
                    "n_retries": first.n_retries, "n_shed": first.n_shed, "n_failed": first.n_failed,
                    "in_backoff_at_horizon": first.n_arrived - _held(first),
                    "availability": first.availability, "goodput_rps_modelled": first.goodput_rps,
                    "strict_json_bytes": len(strict), "host_s": host, "summary": first.summary()}
    print("[online] (b) chaos, two seeded runs identical, strict JSON, no_faults() == bare bit for bit: "
          + json.dumps(out["chaos"]))

    # (c) thermal throttling answered by DVFS; the tour's RC constants are
    # for its 16 W chiplets, so the modelled watts are sized to them (at
    # uniform_power's default rate a stream EP draws kilowatts, stays
    # throttled and never shows the oscillation a throttle is told by)
    per_gflops = WATTS_PER_GFLOPS * paper_platform(4).eps[0].flops / max(ep.flops for ep in bare.eps)

    def hot():
        pm = uniform_power(bare, watts_per_gflops=per_gflops, thermal=ThermalModel(**ONLINE_THERMAL))
        return bare.with_power(pm)

    heat, heat_tuner, host = serve(hot())
    same("thermal rerun", heat, serve(hot())[0])
    before, answered = conf, []
    for t, rt in _installed(heat, heat_tuner):
        installed.append(("thermal", t, rt))
        if rt.kind == "throttle" and rt.conf == before and rt.tune_result.n_explored == 1 and rt.dvfs_levels:
            answered.append(rt)
        before = rt.conf
    if not answered:
        raise RuntimeError(f"no throttle answered by a DVFS step-down that keeps the split: {kinds(heat_tuner)}")
    out["thermal"] = {"watts_per_gflops": per_gflops, "kinds": kinds(heat_tuner),
                      "throttle_levels": [list(rt.dvfs_levels) for rt in answered],
                      "throttle_events_modelled": heat.power["throttle_events"],
                      "max_temp_c_modelled": heat.power["max_temp_c"],
                      "peak_package_w_modelled": heat.power["peak_package_w"], "host_s": host,
                      "summary": heat.summary()}
    print("[online] (c) thermal: " + json.dumps(out["thermal"]))

    # every installed split, run for real
    splits = {}
    for scenario, t, rt in installed:
        splits.setdefault(rt.conf, []).append(f"{scenario} {rt.kind} @{t:.3f}s")
    out["splits"] = {}
    for split, why in splits.items():
        runner = PipelineRunner(mesh=make_stage_mesh(split.depth, res.micro.device), conf=split,
                                apply_layer=res.model.apply_layer, n_micro=N_MICRO)
        got = runner.run(res.micro)
        if not torch.equal(got, seq):
            raise RuntimeError(f"installed split {split.pretty(names)} differs from the sequential model: "
                               f"{(got - seq).abs().max().item()}")
        row = {"installed_by": why, "measured_micro_per_s": pipeline_throughput(runner, res.micro),
               "modelled_micro_per_s": ev.throughput(split)}
        out["splits"][split.pretty(names)] = row
        print(f"[online] split {split.pretty(names)} ({', '.join(why)}) as a stream pipeline: == sequential, "
              f"measured {row['measured_micro_per_s']:.3f} micro/s on {res.micro.device}, modelled "
              f"{row['modelled_micro_per_s']:.3f} on the undrifted oracle")
    return out


def co_platform(props=None):
    """Phase 5d's platform: CO_STREAMS stream EPs of the card, half of them
    SEPs (``h100_platform_from_streams``); fresh at every call, since a run
    steps the models a platform carries in place."""
    return h100_platform_from_streams(CO_STREAMS, props=props)


def _co_installed(co, launch: dict, horizon: float) -> dict[str, list[dict]]:
    """Per tenant, every split its lane installed, the launch split at 0
    first: its install time, the time it was decided, its kind, the split,
    the lane's EPs then and the global EPs of its stages.  A lane logs a
    re-tune when it installs it and the co-simulator defers a re-partition
    while any lane explores, so the logged entries are the first of the
    lane's tuner history, in order; a re-partition's entry names the lane's
    new EPs (``eps``), which map its local indices from then on."""
    out = {}
    for name, lane in co.lanes.items():
        conf, part = launch[name]
        rows = [dict(t=0.0, decided=0.0, kind="launch", conf=conf, lane=tuple(part),
                     eps=tuple(part[e] for e in conf.eps))]
        result = lane.result(horizon)
        for entry, rt in zip(result.reconfigs, lane.autotuner.history):
            if (entry["kind"], entry["new_depth"]) != (rt.kind, rt.conf.depth):
                raise RuntimeError(f"{name}: installed re-tune {entry} is not the tuner's {rt.kind}")
            part = tuple(entry.get("eps", part))
            rows.append(dict(t=entry["t"] + entry["tuning_cost_s"], decided=entry["t"], kind=rt.kind, conf=rt.conf,
                             lane=part, eps=tuple(part[e] for e in rt.conf.eps)))
        if len(rows) != len(result.reconfigs) + 1:
            raise RuntimeError(f"{name}: {len(result.reconfigs)} re-tunes installed, fewer decided")
        out[name] = rows
    return out


def _check_co_run(res, co, launch: dict, n_eps: int, faults: list, horizon: float, gap_ok: bool = False) -> dict:
    """Phase 5d (a)'s invariants on one run: after every re-partition the
    partitions are disjoint and cover exactly the EPs alive then; every
    installed split lies on its lane's EPs (a re-partition's, as the event
    records them), on none dead at its install, and on none another lane's
    split holds at the time; every request is accounted for (with a
    resilience policy, ``gap_ok``, up to the retries may wait in a backoff);
    each dropout re-tunes its victim and donors at the ``Trace.wall`` each
    paid, > 0."""
    gone: set[int] = set()
    for ev in res.repartitions:
        (gone.add if ev.kind == "dropout" else gone.discard)(ev.dead_ep)
        owned = [ep for part in ev.partitions.values() for ep in part]
        if len(owned) != len(set(owned)) or set(owned) != set(range(n_eps)) - gone:
            raise RuntimeError(f"partitions at {ev.t} s {ev.partitions} do not cover exactly the alive EPs")

    def dead(t):
        out = set()
        for ft, kind, ep in sorted((f[1], f[0], f[2]) for f in faults):
            if ft <= t:
                (out.add if kind == "dropout" else out.discard)(ep)
        return out

    installed = _co_installed(co, launch, horizon)
    events = {(e.t, name): e.partitions[name] for e in res.repartitions for name in e.retune_costs}
    for name, rows in installed.items():
        for row in rows:
            if not set(row["eps"]) <= set(row["lane"]) or set(row["eps"]) & dead(row["t"]):
                raise RuntimeError(f"{name} installed {row['conf'].pretty()} at {row['t']} s on {row['eps']}: "
                                   f"its lane holds {row['lane']}, dead then {dead(row['t'])}")
            if row["kind"] == "repartition" and events.get((row["decided"], name)) != row["lane"]:
                raise RuntimeError(f"{name}'s re-partition at {row['decided']} s installed on {row['lane']}, the "
                                   f"event records {events.get((row['decided'], name))}")
    # lanes swap EPs atomically: check once every install at a time is in
    serving = {name: set(rows[0]["eps"]) for name, rows in installed.items()}
    installs = sorted((r["t"], n, r["eps"]) for n, rows in installed.items() for r in rows[1:])
    for i, (t, name, eps) in enumerate(installs):
        serving[name] = set(eps)
        clash = {(a, b): serving[a] & serving[b] for a in serving for b in serving if a < b and serving[a] & serving[b]}
        if clash and (i + 1 == len(installs) or installs[i + 1][0] != t):
            raise RuntimeError(f"at {t} s two lanes' splits share EPs: {clash}")
    for ev in res.repartitions:
        if ev.kind == "dropout":
            want = {ev.victim} | {d["donor"] for d in ev.bundle}
            if set(ev.retune_costs) != want or not all(c > 0 for c in ev.retune_costs.values()):
                raise RuntimeError(f"dropout at {ev.t} s re-tuned {ev.retune_costs}, not {want} at a cost > 0")
            for name, cost in ev.retune_costs.items():
                paid = [rt.tuning_cost for rt in co.lanes[name].autotuner.history if rt.kind == "repartition"]
                if cost not in paid:
                    raise RuntimeError(f"{name}'s re-tune cost {cost} at {ev.t} s is no Trace.wall it paid: {paid}")
    for r in res.results:
        gap = r.sim.n_arrived - _held(r.sim)
        if r.sim.n_arrived != len(r.tenant.traffic.arrivals(horizon)) or not 0 <= gap <= (
                r.sim.n_retries if gap_ok else 0):
            raise RuntimeError(f"{r.tenant.name} lost requests: {r.sim.n_arrived} arrived, {_held(r.sim)} held")
    return installed


def co_serve_online(tenants: dict, oracles: dict, horizon: float = CO_HORIZON, props=None) -> dict:
    """Phase 5d: multi-tenant co-serving on the card's measured oracles.

    ``tenants`` maps each of CO_TENANTS' networks to (its model, its
    microbatches), ``oracles`` to its ``MeasuringEvaluator`` over
    ``co_platform`` (``measure_cnn``).  Each lane's evaluator is its tenant's
    measured oracle ``on_platform`` of the lane's partition: nothing is
    measured again.  The tenants are the reference acceptance
    test's: an interleaved partition, each tenant's capacity the tuned H3
    throughput on its partition, SynthNet's recorded Poisson traffic at
    0.65 of it and ResNet50's recorded MMPP at 0.08 / 0.30 of it, each SLO
    3x its launch split's pipeline latency.  (a) SynthNet's fastest EP dies
    at 1/3 of the horizon and revives at 2/3, elastic and static, checked
    as the module docstring says; (b) seeded chaos with a resilience policy;
    (c) every split a lane installed in (a) runs as a stream pipeline of its
    tenant's model, equal to the sequential model, then both tenants' final
    splits as CUDA graphs, alone and together on their own streams
    (``co_run_together``).  Simulated times, SLO shares and
    model throughputs are the model's; only the pipelines' microbatches/s
    are the card's.
    """
    by_layers = {tuple(ev.layers): ev for ev in oracles.values()}

    def make_evaluator(p, layers):
        return by_layers[tuple(layers)].on_platform(p)

    plat = co_platform(props)
    names = [ep.name for ep in plat.eps]
    parts = dict(zip(CO_TENANTS, partition_eps(plat, len(CO_TENANTS), "interleaved")))
    caps, slos, specs = {}, {}, []
    for net, part in parts.items():
        ev = make_evaluator(subplatform(plat, part, net), oracles[net].layers)
        sh = run_shisha(weights(ev.layers), Trace(ev), "H3")
        caps[net], slos[net] = sh.result.best_throughput, 3.0 * sum(ev.stage_times(sh.result.best_conf))
        share, seed = CO_LOADS[net]
        if isinstance(share, tuple):
            gen_ = MMPPTraffic(rate_low=share[0] * caps[net], rate_high=share[1] * caps[net], seed=seed)
        else:
            gen_ = PoissonTraffic(rate=share * caps[net], seed=seed)
        specs.append(Tenant(name=net, layers=tuple(ev.layers), traffic=ReplayTraffic.record(gen_, horizon),
                            slo=slos[net]))
    victim_part = parts["synthnet"]
    victim_ep = max(victim_part, key=lambda e: (plat.eps[e].flops, -e))
    faults = [("dropout", horizon / 3, victim_ep), ("revival", 2 * horizon / 3, victim_ep)]
    out = {"platform": plat.name, "horizon_s": horizon, "knobs": CO_KNOBS,
           "partitions": {n: [names[e] for e in p] for n, p in parts.items()},
           "cap_micro_per_s_modelled": caps, "slo_s_modelled": slos,
           "arrivals": {t.name: len(t.traffic.arrivals(horizon)) for t in specs},
           "faults": [(k, t, names[e]) for k, t, e in faults]}
    print(f"[co] {plat.name}: {json.dumps(out)}")

    def run(elastic=True, loop=None, telemetry=None, power=False, chaos=None, resilience=None, fault_script=faults):
        p = co_platform(props)
        if power:
            p = p.with_power(uniform_power(p, n_levels=1))
        co = SharedClockCoSimulator(p, specs, make_evaluator=make_evaluator, elastic=elastic, loop=loop,
                                    telemetry=telemetry, chaos=chaos, resilience=resilience, **CO_KNOBS)
        launch = {n: (lane.conf, co.partitions[n]) for n, lane in co.lanes.items()}
        for kind, t, ep in fault_script:
            getattr(co, f"schedule_{kind}")(t, ep)
        t0 = time.perf_counter()
        res = co.run(horizon)
        return res, co, launch, time.perf_counter() - t0

    def same(what, a, b, skip=()):
        def view(r):
            return ([{k: v for k, v in dataclasses.asdict(x.sim).items() if k not in skip} for x in r.results],
                    [dataclasses.asdict(e) for e in r.repartitions], r.partitions, r.dead)

        if view(a) != view(b):
            raise RuntimeError(f"{what}: the co-serve results differ")

    # (a) elastic against static under the dropout and the revival
    elastic, co, launch, host = run()
    tuner = co.lanes["synthnet"].autotuner
    out["knobs"] = {**{k: getattr(co, k) for k in ("heuristic", "max_batch", "batch_efficiency",
                                                    "monitor_interval", "contention_aware", "placement", "dvfs",
                                                    "max_bundle")},
                    "headroom": co.elastic_partitioner.headroom,
                    **{k: getattr(tuner, k) for k in ("alpha", "measure_batches", "reconfig_overhead",
                                                      "reconfig_downtime", "cooldown", "batch_policy_search",
                                                      "max_batch_cap", "batch_latency_margin", "balancing")}}
    print("[co] knobs: interleaved partition, " + json.dumps(out["knobs"]))
    installed = {"elastic": _check_co_run(elastic, co, launch, len(names), faults, horizon)}
    final = {n: (lane.conf, elastic.partitions[n]) for n, lane in co.lanes.items()}
    static, co_s, launch_s, host_s = run(elastic=False)
    installed["static"] = _check_co_run(static, co_s, launch_s, len(names), faults, horizon)
    if static.repartitions:
        raise RuntimeError(f"the static run re-partitioned: {static.repartitions}")
    revivals = [e for e in elastic.repartitions if e.kind == "revival"]
    owners = [n for n, part in elastic.partitions.items() if victim_ep in part]
    if [e.stolen_ep for e in revivals] != [victim_ep] or owners != [revivals[0].victim]:
        raise RuntimeError(f"the revived {names[victim_ep]} rejoined {owners} in events {revivals}")
    same("drain vs heap engine", elastic, run(loop=HeapEventLoop())[0])
    # a rerun, through the entry point a user calls
    same("co_serve vs SharedClockCoSimulator", elastic, co_serve(
        co_platform(props), specs, horizon=horizon, make_evaluator=make_evaluator, elastic=True, faults=faults,
        **CO_KNOBS))
    exports = []
    for _ in range(2):
        tl = Telemetry()
        same("live telemetry vs none", elastic, run(telemetry=tl)[0])
        exports.append((tl.export_jsonl(), json.dumps(tl.export_chrome_trace(), allow_nan=False)))
    if exports[0] != exports[1]:
        raise RuntimeError("two seeded co-serve reruns exported different telemetry")
    powered = run(power=True)[0]
    same("degenerate uniform_power vs bare", elastic, powered, skip=("power",))
    if any(r.sim.power is None for r in powered.results):
        raise RuntimeError("the degenerate power model stepped no lane")

    def arm(res, co, host_s):
        history = {n: lane.autotuner.history for n, lane in co.lanes.items()}
        return {"aggregate_slo_rate_modelled": res.aggregate_slo_rate,
                "aggregate_throughput_rps_modelled": res.aggregate_throughput_rps, "host_s": host_s,
                "tenants": {r.tenant.name: {"eps": [names[e] for e in r.ep_idxs], "launch": r.conf_pretty,
                                            "launch_trials": r.n_trials, "batch_policy": r.batch_policy,
                                            "summary": r.sim.summary(), "slo_rate_modelled": r.sim.slo_rate,
                                            "retunes": [(rc["kind"], rc["t"], rc["tuning_cost_s"],
                                                         rt.tune_result.n_explored)
                                                        for rc, rt in zip(r.sim.reconfigs, history[r.tenant.name])]}
                            for r in res.results}}

    out["elastic"], out["static"] = arm(elastic, co, host), arm(static, co_s, host_s)
    trials = {(n, rt.tuning_cost): rt.tune_result.n_explored for n, lane in co.lanes.items()
              for rt in lane.autotuner.history if rt.kind == "repartition"}
    out["events"] = [{"kind": e.kind, "t": e.t, "dead": names[e.dead_ep], "victim": e.victim, "donor": e.donor,
                      "stolen": None if e.stolen_ep is None else names[e.stolen_ep], "price": e.price,
                      "retune_costs_s_modelled": e.retune_costs,
                      "retune_trials": {n: trials[(n, c)] for n, c in e.retune_costs.items()},
                      "partitions": {n: [names[x] for x in p] for n, p in e.partitions.items()}}
                     for e in elastic.repartitions]
    out["elastic_beats_static"] = elastic.aggregate_slo_rate < static.aggregate_slo_rate
    if not out["elastic_beats_static"]:
        raise RuntimeError(f"elastic ({elastic.aggregate_slo_rate}) does not beat static ({static.aggregate_slo_rate}) "
                           "on aggregate SLO violations")
    print("[co] (a) events: " + json.dumps(out["events"]))
    for which in ("elastic", "static"):
        print(f"[co] (a) {which}: " + json.dumps(out[which]))
    print(f"[co] (a) aggregate SLO violations (modelled): elastic {elastic.aggregate_slo_rate!r}, static "
          f"{static.aggregate_slo_rate!r}: elastic beats static: {out['elastic_beats_static']}; partitions "
          "disjoint and covering the alive EPs after every event, no split on a dead EP, every request accounted "
          "for, drain == heap engine, a co_serve rerun == SharedClockCoSimulator, live Telemetry == none, "
          "exports byte-identical over two reruns, degenerate uniform_power == bare")

    # (b) chaos: seeded failures of the SEPs, transient batch errors, on the
    # launch partitions (each keeps its FEPs): an elastic run can drain a
    # tenant down to SEPs, and a lane whose last EP dies while another lane
    # explores raises, in the reference as in the port (ROADMAP.md queue 3)
    worst = max(e.perf_class for e in plat.eps)
    seps = [i for i, ep in enumerate(plat.eps) if ep.perf_class == worst]
    chaos = FaultModel(seed=7, ep_mtbf={worst: ONLINE_MTBF * horizon}, ep_mttr={worst: ONLINE_MTTR * horizon},
                       batch_error_p=ONLINE_BATCH_ERROR_P)
    policy = ResiliencePolicy(deadline_s=max(slos.values()), max_retries=2, queue_cap=256)
    first, co_c, launch_c, host_c = run(elastic=False, chaos=chaos, resilience=policy, fault_script=())
    same("chaos rerun", first, run(elastic=False, chaos=chaos, resilience=policy, fault_script=())[0])
    _check_co_run(first, co_c, launch_c, len(names), [], horizon, gap_ok=True)
    strict = json.dumps([[dataclasses.asdict(r.sim) for r in first.results],
                         [dataclasses.asdict(e) for e in first.repartitions]], allow_nan=False)
    out["chaos"] = {"failing": [names[e] for e in seps], "mtbf_s": ONLINE_MTBF * horizon,
                    "mttr_s": ONLINE_MTTR * horizon, "batch_error_p": ONLINE_BATCH_ERROR_P,
                    "retunes": {r.tenant.name: [rc["kind"] for rc in r.sim.reconfigs] for r in first.results},
                    "strict_json_bytes": len(strict), "host_s": host_c,
                    "aggregate_slo_rate_modelled": first.aggregate_slo_rate,
                    "tenants": {r.tenant.name: {"availability": r.sim.availability, "n_retries": r.sim.n_retries,
                                                "n_shed": r.sim.n_shed, "n_failed": r.sim.n_failed,
                                                "summary": r.sim.summary()} for r in first.results}}
    print("[co] (b) chaos, two seeded runs identical, strict JSON: " + json.dumps(out["chaos"]))

    # (c) every installed split on the card, alone; then the final splits together
    seqs = {net: torch.stack([m(x) for x in micro]) for net, (m, micro) in tenants.items()}
    runners, out["splits"] = {}, {}
    for net, (model, micro) in tenants.items():
        seen = {}
        for which, rows in installed.items():
            for row in rows[net]:
                seen.setdefault(row["conf"].stages, []).append(
                    f"{which} {row['kind']} @{row['t']:.3f}s on {[names[e] for e in row['eps']]}")
        for stages, why in seen.items():
            conf = PipelineConfig(stages=stages, eps=tuple(range(len(stages))))
            runner = PipelineRunner(mesh=make_stage_mesh(conf.depth, micro.device), conf=conf,
                                    apply_layer=model.apply_layer, n_micro=N_MICRO)
            got = runner.run(micro)
            if not torch.equal(got, seqs[net]):
                raise RuntimeError(f"{net}'s installed split {stages} differs from the sequential model")
            row = {"installed": why, "measured_micro_per_s": pipeline_throughput(runner, micro)}
            out["splits"][f"{net} {list(stages)}"] = row
            print(f"[co] {net} split {list(stages)} ({len(why)} installs: {', '.join(why)}) as a stream pipeline: "
                  f"== sequential, measured {row['measured_micro_per_s']:.3f} micro/s on {micro.device}")
        conf, part = final[net]
        runners[net] = PipelineRunner(mesh=make_stage_mesh(conf.depth, micro.device), conf=conf,
                                      apply_layer=model.apply_layer, n_micro=N_MICRO)
    out["together"] = co_run_together(tenants, runners, seqs)
    for net, (conf, part) in final.items():
        ev = make_evaluator(subplatform(plat, part, net), oracles[net].layers)
        out["together"][net]["modelled_micro_per_s"] = ev.throughput(conf)
        out["together"][net]["split"] = conf.pretty([names[e] for e in part])
    print("[co] (c) final splits as graphs alone, together and back to back (measured on the card; modelled on "
          "the lane's oracle): "
          + json.dumps(out["together"]))
    return out


def co_run_together(tenants: dict, runners: dict, seqs: dict) -> dict:
    """Each tenant's final split alone, then all of them on the card at once.

    Issued from the host, a split's run is host-bound (a wrapper's issue
    outlasts a small conv on the device), and one host thread issues one
    tenant after the other, so host-issued runs only add up.  So each split
    is captured once as a CUDA graph, which the host launches in one call.
    Alone, each graph is replayed by itself; together, all of them are
    replayed on streams of their own before one synchronise, so the card
    holds every tenant at once.  Every replay's output must equal its
    sequential model.  Microbatches/s are each tenant's microbatches over
    its graph's span on the device (CUDA events from one start to its last
    stage), best of CO_REPS; ``back_to_back`` is what each would get if the
    graphs ran one after the other, so ``together`` above it is overlap.
    ``alone_issued`` is the host-issued split's ``pipeline_throughput``,
    the beat of the lanes' oracle.  On the CPU only that."""
    out = {net: {"alone_issued_micro_per_s": pipeline_throughput(runners[net], tenants[net][1])} for net in runners}
    device = next(iter(tenants.values()))[1].device
    if device.type != "cuda":
        return out
    graphs = {}
    for net, runner in runners.items():
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = runner.run(tenants[net][1])
        graphs[net] = (graph, got)
    callers = {net: torch.cuda.Stream(device=device) for net in runners}

    def replay(nets) -> dict:
        """Launch ``nets``' graphs on their own streams; each one's span in ms."""
        start, ends = torch.cuda.Event(enable_timing=True), {}
        start.record()
        for net in nets:
            callers[net].wait_event(start)
            with torch.cuda.stream(callers[net]):
                graphs[net][0].replay()
                ends[net] = torch.cuda.Event(enable_timing=True)
                ends[net].record()
        torch.cuda.synchronize(device)
        for net in nets:
            if not torch.equal(graphs[net][1], seqs[net]):
                raise RuntimeError(f"{net}'s final split replayed {'with the others' if len(nets) > 1 else 'alone'} "
                                   "differs from the sequential model")
        return {net: start.elapsed_time(ends[net]) for net in nets}

    def best(nets) -> dict:
        replay(nets)  # warm-up
        spans = [replay(nets) for _ in range(CO_REPS)]
        return {net: min(s[net] for s in spans) for net in nets}

    alone = {net: best([net])[net] for net in runners}
    together = best(list(runners))
    for net, runner in runners.items():
        out[net].update({"alone_ms": alone[net], "alone_micro_per_s": runner.n_micro / alone[net] * 1e3,
                         "together_ms": together[net],
                         "together_micro_per_s": runner.n_micro / together[net] * 1e3,
                         "back_to_back_micro_per_s": runner.n_micro / sum(alone.values()) * 1e3})
    return out


def _bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    return ops.bound(flops, nbytes, peak)


def _agree(name: str, case, got: torch.Tensor, want: torch.Tensor, tol: float | None) -> float:
    """allclose at ``tol`` (fp32 inputs); with ``tol=None`` (bf16 inputs) the
    max error within BF16_REL_TOL of max |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    if tol is not None:
        ok = torch.allclose(got, want, rtol=tol, atol=tol)
    else:
        ok = err <= BF16_REL_TOL * want.abs().max().item()
    if not ok:
        raise RuntimeError(f"{name} disagrees with its plain version at {case}: max abs err {err}")
    return err


def served_flash_calls() -> list[dict]:
    """The flash calls of each served model's bf16 prefill at LM_BATCH and
    LM_PROMPT, one per distinct shape: the causal self attention of every
    attention model (internvl's over the patches and the prompt); whisper's
    bidirectional encoder over its frames, its causal decoder over the prompt
    cut to ``max_decoder_len`` and its cross attention from the one to the
    other."""
    bf16, calls = torch.bfloat16, []
    for arch, (names, _, _) in LM_MODELS.items():
        if "flash_attention" not in names:
            continue
        cfg = get_config(arch)
        if cfg.sliding_window:  # SDPA, the yardstick, takes no window
            raise RuntimeError(f"{arch}: a sliding window is not timed here")
        shape = dict(b=LM_BATCH, h=cfg.n_heads, kvh=cfg.n_kv_heads, d=cfg.hd, dtype=bf16, window=0)
        if cfg.is_encdec:
            dec = min(LM_PROMPT, cfg.max_decoder_len)
            calls += [dict(shape, s=cfg.enc_frames, causal=False, model=f"{arch} encoder"),
                      dict(shape, s=dec, causal=True, model=f"{arch} decoder self-attention"),
                      dict(shape, s=dec, skv=cfg.enc_frames, causal=False, model=f"{arch} cross attention")]
        else:
            calls.append(dict(shape, s=LM_PROMPT + cfg.n_patches, causal=True, model=arch))
    return calls


#: (query, key) pairs a mask leaves visible, the kernel module's count
visible_pairs = fa.visible_pairs


def check_flash(gen: torch.Generator) -> dict:
    """Phase 6 for ``flash_attention``: parity everywhere, times at every
    flash call of the served models' prefills (``served_flash_calls``), q,
    k and v in the model's layout (transposed ``[b, s, h, d]`` views).  The
    kernels-line row is granite-3-2b's, the kernel's first model, with the
    other calls under keys that name the model and the call."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = served_flash_calls() + [
        dict(b=2, h=h, kvh=kvh, s=s, d=32, dtype=f32, causal=c, window=0)  # tests/test_kernels.py grid
        for c in (True, False) for h, kvh in ((4, 4), (4, 2), (8, 1)) for s in (64, 128)
    ] + [
        dict(b=2, h=4, kvh=2, s=200, d=64, dtype=f32, causal=True, window=0),  # ragged S
        dict(b=2, h=4, kvh=2, s=100, d=64, dtype=f32, causal=True, window=16),  # window
        dict(b=1, h=4, kvh=4, s=77, d=128, dtype=f32, causal=False, window=9),  # non-causal window, D 128
        dict(b=2, h=8, kvh=2, s=300, d=128, dtype=bf16, causal=True, window=50),  # bf16 ragged window
        dict(b=4, h=32, kvh=8, s=512, d=64, dtype=f32, causal=True, window=0),  # granite's shape, fp32
    ] + [  # the tensor-core kernel's branches: every head dim, GQA groups 1 / 4 / 5, S of one row, under
        # one fragment, one key past a tile and ragged long, a window narrower than a 16-row fragment,
        # and no causal mask
        dict(b=2, h=4, kvh=4, s=65, d=16, dtype=bf16, causal=True, window=0),
        dict(b=2, h=8, kvh=2, s=15, d=32, dtype=bf16, causal=True, window=0),
        dict(b=1, h=8, kvh=2, s=1, d=64, dtype=bf16, causal=True, window=0),
        dict(b=2, h=40, kvh=8, s=1000, d=128, dtype=bf16, causal=True, window=0),
        dict(b=2, h=10, kvh=2, s=65, d=128, dtype=bf16, causal=False, window=0),
        dict(b=2, h=4, kvh=4, s=200, d=64, dtype=bf16, causal=True, window=7),
        dict(b=1, h=10, kvh=2, s=130, d=32, dtype=bf16, causal=False, window=7),
        dict(b=2, h=8, kvh=2, s=1000, d=16, dtype=bf16, causal=False, window=0),
        dict(b=2, h=8, kvh=8, s=200, d=80, dtype=bf16, causal=True, window=7),
        dict(b=2, h=24, kvh=2, s=130, d=192, dtype=bf16, causal=True, window=50),  # GQA group 12
        dict(b=1, h=12, kvh=1, s=65, d=80, dtype=bf16, causal=False, window=0),
        dict(b=2, h=12, kvh=1, s=300, d=192, dtype=bf16, causal=False, window=0),
        dict(b=1, h=12, kvh=1, s=1, d=192, dtype=bf16, causal=True, window=0),
    ] + [  # head dims 80 and 192 in fp32 at the reference's 2e-4: ragged S, a window, no causal mask
        dict(b=2, h=4, kvh=2, s=200, d=d, dtype=f32, causal=True, window=0) for d in (80, 192)
    ] + [
        dict(b=2, h=24, kvh=2, s=100, d=d, dtype=f32, causal=True, window=16) for d in (80, 192)
    ] + [
        dict(b=1, h=12, kvh=1, s=77, d=d, dtype=f32, causal=False, window=9) for d in (80, 192)
    ] + [  # a key length other than the query's: Sq 1 / 15 / 448 / 1500 against Skv 1 / 15 / 65 / 448 /
        # 1500, longer and shorter, causal (top-left) with and without a window, D 64 and 128, GQA 1 and 8
        dict(b=2, h=8, kvh=1, s=1, skv=1500, d=64, dtype=bf16, causal=False, window=0),
        dict(b=2, h=8, kvh=8, s=15, skv=65, d=128, dtype=bf16, causal=True, window=7),
        dict(b=2, h=8, kvh=1, s=448, skv=65, d=64, dtype=bf16, causal=False, window=0),
        dict(b=2, h=12, kvh=12, s=448, skv=1, d=128, dtype=bf16, causal=False, window=0),
        dict(b=1, h=16, kvh=2, s=448, skv=1500, d=128, dtype=bf16, causal=True, window=0),
        dict(b=2, h=4, kvh=4, s=65, skv=15, d=64, dtype=bf16, causal=True, window=64),
        dict(b=2, h=8, kvh=1, s=1500, skv=448, d=64, dtype=bf16, causal=True, window=0),
        dict(b=1, h=8, kvh=8, s=15, skv=1500, d=64, dtype=bf16, causal=False, window=0),
        dict(b=2, h=4, kvh=2, s=20, skv=8, d=32, dtype=f32, causal=True, window=16),  # fp32 at 2e-4
        dict(b=2, h=4, kvh=4, s=8, skv=20, d=64, dtype=f32, causal=False, window=0),
        dict(b=1, h=8, kvh=1, s=100, skv=300, d=128, dtype=f32, causal=True, window=0),
        dict(b=2, h=4, kvh=2, s=77, skv=33, d=64, dtype=f32, causal=False, window=50),
        dict(b=1, h=12, kvh=1, s=1, skv=1500, d=64, dtype=f32, causal=False, window=0),
        dict(b=4, h=12, kvh=12, s=448, skv=1500, d=64, dtype=f32, causal=False, window=0),  # whisper's, fp32
    ]
    row = None
    max_err = 0.0
    for case in cases:
        b, h, kvh, s, d, dt = (case[k] for k in ("b", "h", "kvh", "s", "d", "dtype"))
        skv = case.get("skv", s)
        q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt).transpose(1, 2)  # the model's layout
        if "model" in case:
            k = torch.randn((b, skv, kvh, d), generator=gen, device="cuda").to(dt).transpose(1, 2)
            v = torch.randn((b, skv, kvh, d), generator=gen, device="cuda").to(dt).transpose(1, 2)
        else:
            k = torch.randn((b, kvh, skv, d), generator=gen, device="cuda").to(dt)
            v = torch.randn((b, kvh, skv, d), generator=gen, device="cuda").to(dt)
        kw = dict(causal=case["causal"], window=case["window"])
        y = fa.flash_attention(q, k, v, **kw)
        yp = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        desc = {**case, "dtype": str(dt).removeprefix("torch."), "route": fa.fwd_route(q, k, v)}
        err = _agree("flash_attention", desc, y, yp, ATTN_TOL if dt == f32 else None)
        if dt == bf16 and not torch.equal(y, fa.flash_attention(q, k, v, **kw)):
            raise RuntimeError(f"flash_attention gave other bits on a second call at {desc}")
        max_err = max(max_err, err)
        print(f"[check] flash_attention {json.dumps({**desc, 'max_abs_err': err, 'max_abs_plain': yp.float().abs().max().item()})}")
        if "model" in case:
            flops, nbytes = fa.cost(q, k, v, case["causal"], case["window"])
            bound_ms, bound_by = _bound(flops, nbytes, PEAK_BF16_FLOPS)
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()

            def kern():
                return fa.flash_attention(q, k, v, **kw)

            def mma():  # the mma.sync kernel at the same shape, through the C entry's route code
                return fa.run_fwd_route(q, k, v, route="mma", **kw)

            def plain():
                return fa.flash_attention_plain(q, k, v, **kw)

            def sdpa():
                return F.scaled_dot_product_attention(qc, kc, vc, is_causal=case["causal"], enable_gqa=True)

            ym = mma()
            _agree("flash_attention on mma.sync", desc, ym, yp, None)
            same_bits = torch.equal(y, ym)  # printed: the two routes take one row's fp32 steps in one order
            # CUDA events around 20 calls, as for every kernel; at these sizes the wrapper
            # takes the host longer to issue than the card to run, so the device time from
            # the profiler and the host's time to issue a call stand beside them
            timed = dict(ms=_time_ms(kern), plain_ms=_time_ms(plain), library_ms=_time_ms(sdpa),
                         bound_ms=bound_ms, bound_by=bound_by, mma_ms=_time_ms(mma), mma_same_bits=same_bits)
            device_ms, ran = _device_ms(kern)
            mma_device_ms, mma_ran = _device_ms(mma)
            plain_device_ms, _ = _device_ms(plain)
            library_device_ms, sdpa_ran = _device_ms(sdpa, need=False)
            timed.update(device_ms=device_ms, mma_device_ms=mma_device_ms, plain_device_ms=plain_device_ms,
                         library_device_ms=library_device_ms, host_ms=_host_ms(kern), mma_host_ms=_host_ms(mma),
                         library_host_ms=_host_ms(sdpa))
            if desc["route"] != "wgmma":  # every served prefill shape is on the wgmma route
                raise RuntimeError(f"flash_attention at {case['model']}'s shape took route {desc['route']!r}")
            want = {"wgmma": fa.fwd_kernels("wgmma", d), "mma": fa.fwd_kernels("mma", d)}
            for route, got in (("wgmma", ran), ("mma", mma_ran)):
                names = sorted(m.group(1) for n in got if (m := FLASH_FN.search(n)))
                if names != list(want[route]):
                    raise RuntimeError(f"flash_attention on {route} at {case['model']}'s shape ran {got}")
            ratios = dict(sdpa_ratio=timed["ms"] / timed["library_ms"],
                          sdpa_device_ratio=_ratio(device_ms, library_device_ms),
                          mma_device_ratio=_ratio(device_ms, mma_device_ms))
            print(f"[check] flash_attention {case['model']} prefill shape: "
                  f"{json.dumps({**timed, **ratios, 'flops': flops, 'bytes': nbytes})}")
            print(f"[check] flash_attention at {case['model']}'s shape ran {json.dumps(ran)}; "
                  f"SDPA ran {json.dumps(sdpa_ran)}")
            if row is None:
                row = {**timed, "sdpa_ran": sorted(sdpa_ran)}
            else:  # the other served calls' shapes, under keys that name the model and the call
                row.update({f"{case['model']} {k}": v for k, v in {**timed, **ratios}.items()})
                row[f"{case['model']} sdpa_ran"] = sorted(sdpa_ran)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:64",
        "max_abs_err": max_err, **row,
    }


def ssd_inputs(b: int, l: int, h: int, p: int, n: int, dtype: torch.dtype, strided: bool, gen: torch.Generator):
    """Random x, dt, A, B, C of one SSD shape on the card; ``strided``: x, B
    and C as slices of one projection, as ``ssd_block`` passes them."""
    if strided:
        proj = torch.randn((b, l, h * p + 2 * n), generator=gen, device="cuda").to(dtype)
        x, B, C = proj[..., : h * p].reshape(b, l, h, p), proj[..., h * p : h * p + n], proj[..., h * p + n :]
    else:
        x = torch.randn((b, l, h, p), generator=gen, device="cuda").to(dtype)
        B = torch.randn((b, l, n), generator=gen, device="cuda").to(dtype)
        C = torch.randn((b, l, n), generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn((b, l, h), generator=gen, device="cuda"))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device="cuda"))
    return x, dt, A, B, C


#: FLOPs and bytes of one scan, the kernel module's formula
ssd_cost = ssd.cost


#: the SSD scan's wgmma route's branches (b, l, h, p, n, strided) at chunk 64, each held against plain
#: with the mma.sync kernel beside it: state 64 / 128, one chunk and several, p of one and two 64-row
#: tiles, head groups of one and several, contiguous and strided rows (the served and rank shapes are
#: the timed cases)
SSD_WGMMA_CASES = ((1, 64, 2, 64, 128, False), (1, 128, 2, 64, 64, True), (2, 256, 3, 128, 64, True),
                   (2, 256, 5, 64, 128, False), (3, 192, 7, 64, 64, True))
#: the mesh ranks' scans, timed on both bf16 tensor-core routes: mamba2 and zamba2 at their heads on a
#: (1, 2) mesh, zamba2 x train_4k as rank 0 of (16, 16)
SSD_RANK_SHAPES = {"mamba2-130m rank of (1, 2)": (4, 512, 12, 64, 128),
                   "zamba2-2.7b rank of (1, 2)": (4, 512, 40, 64, 64),
                   "zamba2-2.7b x train_4k rank 0 of (16, 16)": (16, 4096, 5, 64, 64)}


def check_ssd(gen: torch.Generator) -> dict:
    """Phase 6 for ``ssd_scan``: parity everywhere; at mamba2-130m's and
    zamba2-2.7b's prefill shapes and at the mesh ranks' the kernels that ran
    (the wgmma route's two, ``ssd_scan.fwd_kernels``), times and bound,
    beside the ``mma.sync`` kernel's plan on the same inputs (its device
    and host ms, ``mma_device_ms``, ``mma_host_ms``) and each route's share
    of bf16 outputs that differ from plain's, which for the wgmma route must
    be no greater than the mma.sync kernel's.  The kernels-line row is
    mamba2-130m's, the served model's, with zamba2's and the ranks' times
    beside it."""
    f32, bf16 = torch.float32, torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    served = []  # the prefill scan of each Mamba2-family model, as ssd_block passes it
    for arch in SSD_MODELS:
        cfg = get_config(arch)
        served.append(dict(b=LM_BATCH, l=LM_PROMPT, h=cfg.ssm_heads, p=cfg.ssm_head_dim, n=cfg.ssm_state,
                           chunk=cfg.ssm_chunk, dtype=bf16, strided=True, model=arch))
    cases = served + [
        dict(b=2, l=128, h=h, p=p, n=n, chunk=c, dtype=f32, strided=False)  # tests/test_kernels.py grid
        for c in (16, 32) for h, p, n in ((2, 16, 8), (3, 8, 16))
    ] + [
        dict(b=2, l=256, h=3, p=100, n=32, chunk=64, dtype=f32, strided=False),  # ragged p tile
        dict(b=2, l=64, h=4, p=16, n=16, chunk=8, dtype=f32, strided=True),  # mamba2 smoke shape
        dict(b=4, l=512, h=24, p=64, n=128, chunk=64, dtype=f32, strided=False),  # main shape, fp32
        dict(b=2, l=64, h=4, p=16, n=16, chunk=8, dtype=bf16, strided=True),  # mamba2 smoke, bf16: SIMT
    ] + [  # the tensor-core kernel's branches: chunks 16 / 32 / 64, state 64 / 128, p tiles 16 / 32 / 64
        # with a ragged one (p 48), one chunk, contiguous and strided inputs
        dict(b=2, l=128, h=4, p=64, n=128, chunk=16, dtype=bf16, strided=True),
        dict(b=2, l=96, h=3, p=48, n=64, chunk=32, dtype=bf16, strided=False),
        dict(b=1, l=64, h=2, p=48, n=128, chunk=64, dtype=bf16, strided=True),
        dict(b=2, l=256, h=8, p=32, n=64, chunk=64, dtype=bf16, strided=False),
        dict(b=3, l=32, h=5, p=16, n=128, chunk=16, dtype=bf16, strided=True),
    ] + [  # the wgmma route's branches
        dict(b=b, l=l, h=h, p=p, n=n, chunk=64, dtype=bf16, strided=strided) for b, l, h, p, n, strided in SSD_WGMMA_CASES
    ] + [
        dict(b=b, l=l, h=h, p=p, n=n, chunk=64, dtype=bf16, strided=True, model=label)
        for label, (b, l, h, p, n) in SSD_RANK_SHAPES.items()
    ]
    row = None
    max_err = 0.0
    for case in cases:
        b, l, h, p, n, chunk, dt = (case[k] for k in ("b", "l", "h", "p", "n", "chunk", "dtype"))
        x, dtt, A, B, C = ssd_inputs(b, l, h, p, n, dt, case["strided"], gen)
        y, st = ssd.ssd_scan(x, dtt, A, B, C, chunk=chunk)
        yp, stp = ssd.ssd_scan_plain(x, dtt, A, B, C, chunk=chunk)
        torch.cuda.synchronize()
        chosen = ssd.plan(dt, b, h, p, n, chunk, *ssd.alignment(x, B, C), sms=sms)
        desc = {**case, "dtype": str(dt).removeprefix("torch."), "kernel": ssd.KERNELS[chosen.route],
                "p_tile": chosen.p_tile, "blocks": chosen.blocks}
        tol = SSD_TOL if dt == f32 else None
        err = max(_agree("ssd_scan", desc, y, yp, tol), _agree("ssd_scan (state)", desc, st, stp, tol))
        diff = {}  # each bf16 tensor-core route's share of outputs that differ from plain's
        if chosen.route == ssd.WGMMA:
            y2, st2 = ssd.ssd_scan(x, dtt, A, B, C, chunk=chunk)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(st, st2)):
                raise RuntimeError(f"ssd_scan gives other bits twice at {desc}")
            diff["wgmma"] = (y != yp).float().mean().item()
        if chosen.route in (ssd.MMA, ssd.WGMMA):  # every p tile of the mma.sync kernel, too
            for other in ssd.mma_plans(b, h, p, n, chunk):
                yo, so = ssd.run_plan(x, dtt, A, B, C, chunk, other)
                torch.cuda.synchronize()
                what = {**desc, "kernel": ssd.KERNELS[ssd.MMA], "p_tile": other.p_tile, "blocks": other.blocks}
                err = max(err, _agree("ssd_scan", what, yo, yp, tol), _agree("ssd_scan (state)", what, so, stp, tol))
                if other == ssd.mma_plan(b, h, p, n, chunk, sms):
                    diff["mma"] = (yo != yp).float().mean().item()
                    if "wgmma" in diff:  # printed: whether the two routes give the same bits
                        diff["wgmma gives the mma.sync bits"] = torch.equal(y, yo) and torch.equal(st, so)
        if "wgmma" in diff and diff["wgmma"] > diff["mma"]:
            raise RuntimeError(f"ssd_scan's wgmma route differs from plain in {diff['wgmma']} of its bf16 outputs, "
                               f"the mma.sync kernel in {diff['mma']}, at {desc}")
        max_err = max(max_err, err)
        print(f"[check] ssd_scan {json.dumps({**desc, 'max_abs_err': err, 'max_abs_plain': yp.float().abs().max().item(), 'max_abs_state': stp.abs().max().item(), 'y_differing_from_plain': diff})}")
        if "model" in case:
            if chosen.route != ssd.WGMMA:
                raise RuntimeError(f"ssd_scan at {case['model']}'s shape planned {chosen}, want the wgmma route")
            flops, nbytes = ssd_cost(x, B, chunk)
            bound_ms, bound_by = _bound(flops, nbytes, PEAK_BF16_FLOPS)
            mma_plan = ssd.mma_plan(b, h, p, n, chunk, sms)

            def kern():
                return ssd.ssd_scan(x, dtt, A, B, C, chunk=chunk)

            def mma():
                return ssd.run_plan(x, dtt, A, B, C, chunk, mma_plan)

            timed = dict(ms=_time_ms(kern), plain_ms=_time_ms(lambda: ssd.ssd_scan_plain(x, dtt, A, B, C, chunk=chunk)),
                         library_ms=None,  # no single PyTorch call computes SSD
                         bound_ms=bound_ms, bound_by=bound_by)
            want = sorted(ssd.fwd_kernels(chosen, n))
            for _ in range(3):  # a profiler window can hand its records to the next one: take another
                steps: dict[str, float] = {}
                device_ms, ran = _device_ms(kern, times=steps)
                fns = sorted({m.group(1) for k in ran if (m := SSD_FN.search(k))})
                if fns == want:
                    break
            if fns != want:
                raise RuntimeError(f"ssd_scan at {case['model']}'s shape ran {fns}, want {want} (the profiler's "
                                   f"window: {ran})")
            mma_device_ms, _ = _device_ms(mma)
            timed.update(device_ms=device_ms, host_ms=_host_ms(kern), device_functions=fns,
                         steps_ms={m.group(1): v for k, v in steps.items() if (m := SSD_FN.search(k))},
                         blocks=ssd.fwd_grid(b, l, h, p, n, sms=sms), bound_ratio=device_ms / bound_ms,
                         mma_device_ms=mma_device_ms, mma_host_ms=_host_ms(mma), mma_p_tile=mma_plan.p_tile,
                         mma_device_ratio=device_ms / mma_device_ms, y_differing_from_plain=diff["wgmma"],
                         mma_y_differing_from_plain=diff["mma"], mma_same_bits=diff["wgmma gives the mma.sync bits"])
            print(f"[check] ssd_scan {case['model']} shape: "
                  f"{json.dumps({**timed, 'flops': flops, 'bytes': nbytes})}")
            if row is None:
                row = timed
            else:
                row.update({f"{case['model']} {k}": v for k, v in timed.items() if k != "library_ms"})
    return {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:59",
        "max_abs_err": max_err, **row,
    }


def _gemm_operand(shape, dt, gen: torch.Generator, transposed: bool, scale: float = 1.0) -> torch.Tensor:
    """A random operand of ``shape`` on the card: as stored, or (``transposed``)
    the transposed view of one stored with its last two dims swapped, unit
    stride over its second-to-last dim.  A 4-D shape is an [L, E, ...]
    stack, of which layer 1 is returned (a view at a nonzero offset)."""
    stored = (*shape[:-2], shape[-1], shape[-2]) if transposed else shape
    t = (torch.randn(stored, generator=gen, device="cuda") * scale).to(dt)
    t = t[1] if len(shape) == 4 else t
    return t.transpose(-1, -2) if transposed else t


def check_gemm(gen: torch.Generator) -> dict:
    """Phase 9 for ``gemm``: parity everywhere, operands as stored and as
    transposed views (the backward's), the kernel each main shape runs,
    times at the MoE main path's shapes.  The kernels-line row is one
    phi3.5-moe layer's expert products: its prefill (gate, up, down) plus one
    decode step (gate, up, down)."""
    f32, bf16 = torch.float32, torch.bfloat16
    grid = [((m, k), (k, n)) for m, k, n in ((64, 64, 64), (200, 300, 150), (128, 512, 256), (33, 65, 17))]
    # (a, b, type, label, a transposed, b transposed)
    cases = [(sa, sb, dt, "reference grid", False, False) for sa, sb in grid for dt in (f32, bf16)]  # tests/test_kernels.py
    cases += [((3, 33, 65), (3, 65, 17), dt, "batched, ragged", False, False) for dt in (f32, bf16)]
    # transposed views: the wgmma instantiation of each pair of majors where the TMA can address the rows; fp32,
    # M <= 16 and unaligned rows copied to the one layout their kernels read
    cases += [(sa, sb, dt, "reference grid, transposed", ta, tb) for sa, sb in grid for dt in (f32, bf16)
              for ta, tb in ((True, False), (False, True), (True, True))]
    cases += [((16, 8, 264), (16, 264, 136), bf16, "decode, transposed", ta, tb)
              for ta, tb in ((True, False), (False, True))]
    # the decode kernels: capacities 1, 8 and 16 (row tiles 8 and 16), N past whole 256-column tiles (6392) and
    # one column into the next (6408), K past whole 64-row steps, one expert and sixteen
    cases += [((e, m, 4104), (e, 4104, n), bf16, "decode split", False, False)
              for m in (1, 8, 16) for e, n in ((1, 6408), (16, 6392))]
    cases.append(((16, 8, 4096), (3, 16, 4096, 640), bf16, "decode, layer 1 of a stacked expert tensor", False, False))
    # the wgmma tile's edges: M past 16 and past whole 192-row tiles, K and N not whole 64 / 128 tiles
    cases += [((e, m, 4104), (e, 4104, n), bf16, "wgmma tile edges", False, False)  # 51 column tiles: one block
              for e, m, n in ((1, 17, 6408), (1, 100, 6408), (16, 321, 6392))]  # a cluster; 50: two
    # (a transposed A's rows are its M, so M a multiple of 8 there: 328 and 104 lie past whole 192-row tiles)
    cases += [((16, m, k), (16, k, 6392), bf16, "wgmma tile edges, transposed", ta, tb)
              for k in (4104, 264) for m, ta, tb in ((321, False, True), (328, True, False), (328, True, True))]
    cases += [((1, 104, 4104), (1, 4104, 6408), bf16, "wgmma tile edges, transposed", True, True)]
    cases.append(((16, 160, 264), (3, 16, 264, 136), bf16, "layer 1 of a stacked expert tensor", False, False))
    cases.append(((16, 160, 136), (3, 16, 136, 264), bf16, "layer 1 of a stacked expert tensor, transposed",
                  False, True))
    layer, main = {}, {}  # phi3.5-moe shape label -> calls per layer; main shape label -> kernel it must run
    for arch in ("phi3.5-moe-42b", "llama4-scout-17b"):
        cfg = get_config(arch)
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        for phase, tokens in (("prefill", LM_BATCH * LM_PROMPT), ("decode", LM_BATCH)):
            cap = blocks.moe_capacity(cfg, tokens)
            up, down = f"{arch} {phase} gate/up", f"{arch} {phase} down"
            cases += [((E, cap, d), (E, d, f), bf16, up, False, False), ((E, cap, f), (E, f, d), bf16, down, False, False)]
            kernel = ("gemm_wgmma_bf16_kernel",) if phase == "prefill" else gm.decode_kernels(cap)
            main.update({up: kernel, down: kernel})
            if arch == "phi3.5-moe-42b":
                layer.update({up: 2, down: 1})
    cases.append(((16, 320, 4096), (16, 4096, 6400), f32, "phi3.5-moe-42b prefill gate/up, fp32", False, False))
    max_err = 0.0
    tot = {key: 0.0 for key in ("ms", "plain_ms", "library_ms", "device_ms", "library_device_ms", "flops", "bytes")}
    decode = {}  # the kernels-line keys of each decode product
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for sa, sb, dt, label, ta, tb in cases:
        a = _gemm_operand(sa, dt, gen, ta)
        b = _gemm_operand(sb, dt, gen, tb, scale=sb[-2] ** -0.5)
        copies = gm.copies
        y, yp = gm.gemm(a, b), gm.gemm_plain(a, b)
        torch.cuda.synchronize()
        desc = {"a": list(sa), "b": list(sb), "dtype": str(dt).removeprefix("torch."), "case": label,
                "majors": list(gm.majors(a, b))}
        err = (y.float() - yp.float()).abs().max().item()
        if not torch.allclose(y.float(), yp.float(), rtol=GEMM_TOL[dt], atol=GEMM_TOL[dt]):
            raise RuntimeError(f"gemm disagrees with its plain version at {desc}: max abs err {err}")
        r = gm.route(dt, a.shape[-2], a.shape[-1], b.shape[-1], gm._aligned(a) and gm._aligned(b), *gm.majors(a, b))
        if gm.copies - copies != r.copy_a + r.copy_b:
            raise RuntimeError(f"gemm at {desc} copied {gm.copies - copies} operands, its route {r} says "
                               f"{r.copy_a + r.copy_b}")
        max_err = max(max_err, err)
        row = {**desc, "max_abs_err": err, "max_abs_plain": yp.float().abs().max().item(),
               "kernel": gm.KERNELS[r.kernel], "copied": [n for n, c in (("a", r.copy_a), ("b", r.copy_b)) if c]}
        if r.kernel == gm.KERNELS.index("gemm_decode_bf16_kernel<MT>"):  # the same bits twice; the split
            if not torch.equal(y, gm.gemm(a, b)):
                raise RuntimeError(f"gemm's decode kernels gave other bits on a second call at {desc}")
            E, M, K = (a.shape if a.dim() == 3 else (1, *a.shape))
            plan = gm.decode_plan(E, b.shape[-1], K, sms)
            shares = [plan.start(i + 1) - plan.start(i) for i in range(plan.blocks)]
            row.update(same_bits=True, blocks=plan.blocks, units_an_sm=[min(shares), max(shares)],
                       split_tiles=len({pc.tile for pc in gm.decode_pieces(plan, K) if pc.slot is not None}))
        if label in main:
            flops, nbytes = gm.cost(a, b)
            bound_ms, bound_by = _bound(flops, nbytes, PEAK_BF16_FLOPS)
            row.update(flops=flops, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
                       ms=_time_ms(lambda: gm.gemm(a, b)), plain_ms=_time_ms(lambda: gm.gemm_plain(a, b)),
                       library_ms=_time_ms(lambda: torch.bmm(a, b)))
            row["device_ms"], ran = _device_ms(lambda: gm.gemm(a, b))
            row["library_device_ms"], _ = _device_ms(lambda: torch.bmm(a, b), need=False)
            fns = sorted({m.group(1) for n in ran if (m := GEMM_FN.search(n))})
            if not fns or not (fns == sorted(main[label]) if "decode" in label
                               else all(fn.startswith(main[label][0]) for fn in fns)):
                raise RuntimeError(f"gemm at {label} ran {fns}, want {main[label]}")
            row.update(ran=fns, tflops=flops / row["device_ms"] / 1e9, bmm_ratio=row["ms"] / row["library_ms"],
                       bmm_device_ratio=_ratio(row["device_ms"], row["library_device_ms"]))
            if "decode" in label:  # and with the L2 cold before each call, as the decode step finds it
                row.update(blocks_an_sm=gm.decode_occupancy(gm.decode_mt(a.shape[-2])),
                           bound_share=_ratio(bound_ms, row["device_ms"]),
                           cold_device_ms=_cold_device_ms(lambda: gm.gemm(a, b)),
                           library_cold_device_ms=_cold_device_ms(lambda: torch.bmm(a, b), need=False))
                row.update(bmm_cold_device_ratio=_ratio(row["cold_device_ms"], row["library_cold_device_ms"]),
                           cold_bound_share=_ratio(bound_ms, row["cold_device_ms"]))
                decode.update({f"{label} {key}": row[key] for key in (
                    "ms", "device_ms", "library_ms", "library_device_ms", "cold_device_ms", "library_cold_device_ms",
                    "bound_ms", "bound_by", "bmm_device_ratio", "bmm_cold_device_ratio", "blocks", "units_an_sm",
                    "split_tiles", "blocks_an_sm", "ran")})
            for key in tot:
                tot[key] = None if tot[key] is None or row[key] is None \
                    else tot[key] + layer.get(label, 0) * row[key]
        print(f"[check] gemm {json.dumps(row)}")
        del a, b, y, yp
    torch.cuda.empty_cache()
    bound_ms, bound_by = _bound(tot["flops"], tot["bytes"], PEAK_BF16_FLOPS)
    print(f"[check] gemm, one phi3.5-moe layer (prefill + one decode step): "
          f"{json.dumps({**tot, 'bound_ms': bound_ms})}")
    return {
        "name": "gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/kernels/gemm.py:37",
        "max_abs_err": max_err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": tot["library_ms"],
        "device_ms": tot["device_ms"], "library_device_ms": tot["library_device_ms"], **decode,
    }


def _host_ms(fn, reps: int = 20) -> float:
    """Host time to issue one call of ``fn``: the host clock around ``reps``
    calls with no synchronisation inside (the card's queue holds them all)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return host


def _device_ms(fn, reps: int = 20, need: bool = True,
               times: dict | None = None) -> tuple[float | None, dict[str, int]]:
    """Device time per call of ``fn`` from the profiler, and the device
    kernels it ran, by the profiler's name, with their calls per call.  Each
    kernel, copy and memset counts at its mean time per record times its
    records per call, rounded: the profiler can keep only some of a window's
    records, or none, so the window's own kernels keep their per-call time,
    and a name with under half a record per call is another window's and is
    left out.  Unlike ``_time_ms`` it excludes the host's gaps between
    calls: a call that takes the host longer to issue than the card to run
    reads as the card's time.  A window in which the profiler kept no record
    a call is taken again after a pause, up to ``PROFILER_WINDOWS`` in all;
    then it raises, or with ``need`` false (a library call, timed for
    comparison only) prints so and returns ``None``: not measured.
    ``times``, a dict, gets each kernel's device ms per call by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
        per_call = [(e, round(e.count / reps)) for e in events]
        if any(n for _, n in per_call):
            break
        time.sleep(0.1)
    else:
        kept = {e.key[:120]: e.count for e in events}
        msg = f"the profiler kept no device record a call in {PROFILER_WINDOWS} windows of {reps} calls: {kept}"
        if need:
            raise RuntimeError(msg)
        print(f"[check] device time not measured: {msg}")
        return None, {}
    if times is not None:
        times.update({e.key[:120]: e.self_device_time_total / e.count * n / 1e3 for e, n in per_call if n})
    return (sum(e.self_device_time_total / e.count * n for e, n in per_call) / 1e3,
            {e.key[:120]: n for e, n in per_call if n})


#: bytes of the buffer ``_cold_device_ms`` reads between calls: five times the H100's 50 MB L2
L2_FLUSH_BYTES = 256 * 2**20


@functools.cache
def _l2_flush() -> torch.Tensor:
    return torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")


def _cold_device_ms(fn, need: bool = True) -> float | None:
    """``_device_ms`` of ``fn`` with the L2 cache cold before each call, as
    a caller that streams more than the cache between two calls finds it
    (each MoE decode product reads its 0.84-1.3 GB of weights once a step,
    the other layers' in between): a read of L2_FLUSH_BYTES before each
    call, its own kernels left out.  A read, not a write, so that no dirty
    line is written back during ``fn``."""
    buf = _l2_flush()
    flush = lambda: buf.sum()  # noqa: E731
    skip = set(_device_ms(flush)[1])
    times: dict[str, float] = {}
    ms, _ = _device_ms(lambda: (flush(), fn()), need=need, times=times)
    return None if ms is None else sum(v for k, v in times.items() if k not in skip)


def _ratio(a: float | None, b: float | None) -> float | None:
    """``a / b``, or ``None`` where either was not measured."""
    return None if a is None or b is None else a / b


def _kernel_table(prof, wall_s: float) -> dict:
    """Device time by kernel from a profiler trace: the top kernels, sums by
    kind, and the device's busy share of ``wall_s``."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)

    def kind(name: str) -> str:
        if any(k in name for k in PORT_KERNELS):
            return "port kernel"
        return "matmul" if any(t in name.lower() for t in ("gemm", "nvjet", "xmma", "cutlass")) else "other"

    kinds: dict[str, float] = {}
    for name, ms, _ in rows:
        kinds[kind(name)] = kinds.get(kind(name), 0.0) + ms
    return {
        "wall_ms": wall_s * 1e3,
        "device_ms": busy,
        "kernel_calls": sum(r[2] for r in rows),
        "busy_share": busy / (wall_s * 1e3) if busy else "not measured",
        "by_kind_ms": kinds,
        "top": [{"kernel": n[:60], "ms": ms, "calls": c} for n, ms, c in rows[:6]],
        "flash_calls": {m.group(1): c for n, _, c in rows if (m := FLASH_FN.search(n))},
        "gemm_calls": {m.group(1): c for n, _, c in rows if (m := GEMM_FN.search(n))},
        "ssd_calls": {m.group(1): c for n, _, c in rows if (m := SSD_FN.search(n))},
        "ssd_bwd_calls": {m.group(1): c for n, _, c in rows if (m := SSD_BWD_FN.search(n))},
    }


@torch.inference_mode()
def _time_lm(arch: str, cfg, params, prompt: dict) -> dict:
    """Warm prefill and decode times of the kernel path on the host clock
    (around ``torch.cuda.synchronize()``), then one profiled prefill and
    four profiled decode steps.  Returns the kernel tables of both
    (``"prefill"``, ``"decode x4"``)."""
    from torch.profiler import ProfilerActivity, profile

    def prefill():
        return transformer.prefill_step(cfg, params, prompt, max_len=prompt["tokens"].shape[1] + LM_GEN)

    def decode(logits, cache, steps):
        for _ in range(steps):
            logits, cache = transformer.serve_step(cfg, params, cache, torch.argmax(logits, -1)[:, None])
        return logits, cache

    prefill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill()
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    logits, cache = decode(logits, cache, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = decode(logits, cache, 8)
    torch.cuda.synchronize()
    t_step = (time.perf_counter() - t0) / 8
    print(f"[lm] {arch} warm: prefill {t_prefill * 1e3:.3f} ms, decode step {t_step * 1e3:.3f} ms "
          f"({LM_BATCH / t_step:.1f} tokens/s over the batch)")
    tables = {}
    mods = (fa, ssd, gm)
    for what, run in (("prefill", lambda: prefill()), ("decode x4", lambda: decode(logits, cache, 4))):
        # a window in which the profiler kept fewer records of the port's kernels than the
        # wrappers launched is taken again: the checks below count those records (a decode
        # call of gemm launches two kernels, and so does a scan on the SSD's wgmma route)
        for _ in range(PROFILER_WINDOWS):
            before = sum(mod.launches for mod in mods) + gm.decode_launches + ssd.wgmma_launches
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            table = _kernel_table(prof, wall)
            kept = sum(sum(table[k].values()) for k in ("flash_calls", "ssd_calls", "gemm_calls"))
            launched = sum(mod.launches for mod in mods) + gm.decode_launches + ssd.wgmma_launches - before
            if table["kernel_calls"] and kept == launched:
                break
            print(f"[lm] {arch} profile {what}: the profiler kept {kept} of {launched} port kernel launches; "
                  f"taken again")
            time.sleep(0.1)
        tables[what] = table
        print(f"[lm] {arch} profile {what}: {json.dumps(tables[what])}")
    return tables


def _cast(params: dict, dt: torch.dtype) -> dict:
    """The parameter tree with its bf16 leaves in ``dt`` (norm scales stay fp32)."""
    return {k: _cast(v, dt) if isinstance(v, dict) else (v.to(dt) if v.dtype == torch.bfloat16 else v)
            for k, v in params.items()}


@torch.inference_mode()
def _forced_logits(cfg, params, prompt: dict, forced: torch.Tensor) -> torch.Tensor:
    """Prefill logits over ``prompt`` (``make_batch``'s inputs), then one per
    teacher-forced decode step: [b, 1 + steps, vocab]."""
    logits, cache = transformer.prefill_step(cfg, params, prompt, max_len=prompt["tokens"].shape[1] + LM_GEN)
    out = [logits]
    for t in range(forced.shape[1]):
        logits, cache = transformer.serve_step(cfg, params, cache, forced[:, t : t + 1])
        out.append(logits)
    return torch.stack(out, dim=1)


def _fp32_first_layers(params: dict, n: int) -> dict:
    """The parameter tree cut to its first ``n`` layers with its bf16 leaves
    in fp32, made leaf by leaf while ``params`` is emptied, so that each bf16
    leaf is freed as soon as its copy exists: nemotron-4-340b's fp32 model at
    1 layer (51.5 GB) fits the card only once its bf16 one at 2 (32.7 GB) is
    gone."""
    def fp32(t: torch.Tensor) -> torch.Tensor:
        return t.float() if t.dtype == torch.bfloat16 else t

    out = {}
    for key in list(params):
        v = params.pop(key)
        if isinstance(v, dict):
            cut = n if key == "blocks" else None
            out[key] = {k: fp32(v.pop(k)[:cut]) for k in list(v)}
        else:
            out[key] = fp32(v)
        del v
    return out


@contextlib.contextmanager
def _recording_routes(out: list):
    """Append each MoE layer's expert choice [t, k] to ``out``, in call order."""
    route = blocks.route

    def recording(cfg, p, xf):
        probs, gate, expert = route(cfg, p, xf)
        out.append(expert)
        return probs, gate, expert

    with mock.patch.object(blocks, "route", recording):
        yield


@contextlib.contextmanager
def _replaying_routes(recorded: list):
    """Route each MoE call to the experts ``recorded`` for it, in call order,
    with gates from this path's own router probabilities."""
    route, calls = blocks.route, iter(recorded)

    def replaying(cfg, p, xf):
        probs = route(cfg, p, xf)[0]
        expert = next(calls)
        gate = probs.gather(1, expert)
        return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), expert

    with mock.patch.object(blocks, "route", replaying):
        yield


@contextlib.contextmanager
def _plain_versions():
    """Every kernel's plain version in place of the kernel, on the model's
    path (flash's with the bf16-score mode's explicit backward,
    ``ops.flash_attention_plain``)."""
    with mock.patch.object(ops, "flash_attention", ops.flash_attention_plain), \
            mock.patch.object(ops, "ssd_scan", ssd.ssd_scan_plain), mock.patch.object(ops, "gemm", gm.gemm_plain):
        yield


@contextlib.contextmanager
def _checking_scans(errors: list):
    """Run each ``ops.ssd_scan`` call as it is, and the plain version on the
    same inputs; append (y, final state) max |difference| over max |plain|."""
    scan = ops.ssd_scan

    def checking(x, dt, A, B, C, *, chunk=64):
        y, st = scan(x, dt, A, B, C, chunk=chunk)
        yp, sp = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
        errors.append(((y.float() - yp.float()).abs().max().item() / yp.float().abs().max().item(),
                       (st - sp).abs().max().item() / sp.abs().max().item()))
        return y, st

    with mock.patch.object(ops, "ssd_scan", checking):
        yield


@contextlib.contextmanager
def _bf16_scans():
    """``ops.ssd_scan`` as it is now, on x, B and C rounded to bf16, its bf16
    output widened to x's type: a bf16 scan in a model in fp32."""
    scan = ops.ssd_scan

    def bf16_scan(x, dt, A, B, C, *, chunk=64):
        bf = torch.bfloat16
        y, st = scan(x.to(bf), dt, A, B.to(bf), C.to(bf), chunk=chunk)
        return y.to(x.dtype), st

    with mock.patch.object(ops, "ssd_scan", bf16_scan):
        yield


@contextlib.contextmanager
def _plain_toward_zero():
    """``ops.ssd_scan`` as the plain version with its output rounded toward
    zero to x's type (bf16) instead of to nearest: a biased scan whose every
    output is within one rounding of the plain version's."""
    def toward_zero(x, dt, A, B, C, *, chunk=64):
        y, st = ssd.ssd_scan_plain(x.float(), dt, A, B.float(), C.float(), chunk=chunk)
        return (y.contiguous().view(torch.int32) & -65536).view(torch.float32).to(x.dtype), st

    with mock.patch.object(ops, "ssd_scan", toward_zero):
        yield


def hold_bf16_scans(arch: str, cfg, params: dict, prompt: dict, forced: torch.Tensor,
                    failures: list[str]) -> None:
    """Phase 8's logits check of a bf16 SSD model (see SSD_LAYERS): the model
    in fp32 with its scans in bf16, kernel path and a control scan that
    rounds toward zero, each against the plain path.  Appends to
    ``failures`` if the kernel path misses LM_TOL or the control meets it."""
    c, p, tol = dataclasses.replace(cfg, dtype=torch.float32), _cast(params, torch.float32), LM_TOL[torch.bfloat16]
    with _bf16_scans():
        got = _forced_logits(c, p, prompt, forced)
    with _plain_versions(), _bf16_scans():
        want = _forced_logits(c, p, prompt, forced)
    with _plain_versions(), _plain_toward_zero(), _bf16_scans():
        control = _forced_logits(c, p, prompt, forced)
    if not all(torch.isfinite(t).all() for t in (got, want, control)):
        raise RuntimeError(f"{arch}: logits with bf16 scans not finite")
    scale = want.abs().max().item()
    err, ctrl = (got - want).abs().max().item(), (control - want).abs().max().item()
    name = f"{arch} fp32 with bf16 scans at {c.n_layers} layers"
    print(f"[lm] {name}: logits {tuple(got.shape)} kernel vs plain max abs err {err:.3e}, max |logit| "
          f"{scale:.3e} (relative {err / scale:.3e}, tolerance {tol}); control (plain rounded toward zero) "
          f"relative {ctrl / scale:.3e}, must exceed {tol}")
    if not scale > 0 or err > tol * scale:
        failures.append(f"{name}: kernel path disagrees with the plain path: {err} > {tol} * {scale}")
        print(f"[FAIL] {failures[-1]}")
    if not ctrl > tol * scale:
        failures.append(f"{name}: the control that rounds toward zero agrees with the plain path: "
                        f"{ctrl} <= {tol} * {scale}, so the comparison cannot tell a biased scan")
        print(f"[FAIL] {failures[-1]}")
    del p


def _route_agreement(got: list, want: list) -> tuple[float, list[float]]:
    """Share of (token, expert) assignments of ``got`` that ``want`` makes
    too, over all calls, and per call."""
    per = [(g[:, :, None] == w[:, None, :]).any(-1).float().mean().item() for g, w in zip(got, want, strict=True)]
    n = [g.numel() for g in got]
    return sum(a * k for a, k in zip(per, n)) / sum(n), per


def drive_lm(arch: str, kernels: tuple[str, ...], depth: int | None, fp32_depth: int | None,
             failures: list[str]) -> tuple[dict[str, int], str | None]:
    """Phases 7-8 (10 for MoE) for one model: the served path, then kernels
    against plain.  Returns the launches of each kernel on the served path and
    the flash device function that served its bf16 prefill (None without
    attention); a logits comparison that misses LM_TOL is appended to
    ``failures``, every other failed check raises."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=depth) if depth else full
    print(f"[lm] {arch}: {cfg.n_layers} of {full.n_layers} layers, full width (d_model {cfg.d_model})")
    mods = {"conv2d_im2col": im2col_conv, "flash_attention": fa, "ssd_scan": ssd, "gemm": gm}
    for mod in mods.values():
        mod.launches = 0
    gm.decode_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve(cfg, batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN, seed=0, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in mods.items()}
    decode_launches = gm.decode_launches
    tokens = res["tokens"]
    print(f"[lm] {arch}: prefill_s {res['prefill_s']:.6f}, decode_tok_per_s {res['decode_tok_per_s']:.3f}, "
          f"wall {wall:.1f} s (weights drawn on the card included), launches {launches}, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for kernel in kernels:
        if launches[kernel] == 0:
            raise RuntimeError(f"kernel {kernel} never launched on the {arch} serving path")
    if "gemm" in kernels:  # every decode step's expert products on the decode kernels
        print(f"[lm] {arch}: gemm's decode route launched {decode_launches} of its {launches['gemm']} calls")
        if decode_launches == 0:
            raise RuntimeError(f"{arch}: the serving path never launched gemm's decode kernels")
    if tuple(tokens.shape) != (LM_BATCH, LM_GEN) or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab:
        raise RuntimeError(f"{arch}: bad tokens {tuple(tokens.shape)} in [{int(tokens.min())}, {int(tokens.max())}]")

    # the same weights and prompt, kernel path against plain path, teacher-forced on the served tokens
    prompt = make_batch(cfg, LM_BATCH, LM_PROMPT, 0, "cuda")  # tokens, and whisper's frames or internvl's patches
    forced = tokens[:, :LM_FORCED]
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    tables = _time_lm(arch, cfg, params, prompt)
    table = tables["prefill"]
    flash_calls, gemm_calls, ssd_calls = table["flash_calls"], table["gemm_calls"], table["ssd_calls"]
    served_by = None
    if "ssd_scan" in kernels:  # bf16 prefill: the wgmma route's kernels once per layer, no other scan
        want = {k: cfg.n_layers for k in ssd.fwd_kernels(ssd.plan(torch.bfloat16, LM_BATCH, cfg.ssm_heads,
                                                                   cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk,
                                                                   True), cfg.ssm_state)}
        if ssd_calls != want:
            raise RuntimeError(f"{arch}: the profiled bf16 prefill ran {ssd_calls}, want {want}: the wgmma route's "
                               f"kernels once per layer and ssd_scan_mma_bf16_kernel never")
        print(f"[lm] {arch}: prefill scan served by {json.dumps(ssd_calls)}")
    if "gemm" in kernels:  # bf16 prefill: every expert product on wgmma, none on the mma.sync tiles
        wgmma = {n: c for n, c in gemm_calls.items() if n.startswith("gemm_wgmma_bf16_kernel")}
        if len(wgmma) != 1 or len(gemm_calls) != 1 or sum(wgmma.values()) != 3 * cfg.n_layers:
            raise RuntimeError(f"{arch}: the profiled bf16 prefill ran {gemm_calls}, want gemm_wgmma_bf16_kernel "
                               f"three times per layer ({3 * cfg.n_layers})")
        print(f"[lm] {arch}: prefill expert products served by {json.dumps(gemm_calls)}")
        # decode, batch LM_BATCH: each step's three products a layer on the decode kernels, nothing else
        cap = blocks.moe_capacity(cfg, LM_BATCH)
        calls = tables["decode x4"]["gemm_calls"]
        want = dict.fromkeys(gm.decode_kernels(cap), 3 * cfg.n_layers * 4)
        if calls != want:
            raise RuntimeError(f"{arch}: the profiled decode steps ran {calls}, want {want}")
        print(f"[lm] {arch}: decode expert products served by {json.dumps(calls)}")
    if "flash_attention" in kernels:  # bf16 prefill: the wgmma kernel once per layer, never mma.sync or SIMT
        wgmma = {n: c for n, c in flash_calls.items() if n == f"flash_fwd_wgmma_kernel<{cfg.hd}>"}
        # a hybrid runs its shared attention block once per group of SSD layers; whisper's prefill runs
        # every encoder layer, and self and cross attention in every decoder layer
        attn_layers = cfg.n_layers // cfg.shared_attn_every if cfg.block_kind == "hybrid" \
            else cfg.enc_layers + 2 * cfg.n_layers if cfg.is_encdec else cfg.n_layers
        if len(wgmma) != 1 or len(flash_calls) != 1 or sum(wgmma.values()) != attn_layers:
            raise RuntimeError(f"{arch}: the profiled bf16 prefill ran {flash_calls}, want "
                               f"flash_fwd_wgmma_kernel<{cfg.hd}> once per attention layer ({attn_layers}) and "
                               f"flash_fwd_mma_bf16_kernel never")
        served_by = next(iter(wgmma))
        print(f"[lm] {arch}: prefill attention served by {served_by}, {wgmma[served_by]} calls")
    for dt in (torch.bfloat16, torch.float32):
        c = dataclasses.replace(cfg, dtype=dt)
        if dt == torch.float32 and fp32_depth:  # the last use of params: it is emptied
            c, p = dataclasses.replace(c, n_layers=fp32_depth), _fp32_first_layers(params, fp32_depth)
        else:
            p = _cast(params, dt)
        routes: dict[str, list] = {"kernel": [], "plain": []}
        ssd_layers = "ssd_scan" in kernels and dt == torch.bfloat16  # see SSD_LAYERS
        scans: list = []
        with _recording_routes(routes["kernel"]), \
                (_checking_scans(scans) if ssd_layers else contextlib.nullcontext()):
            got = _forced_logits(c, p, prompt, forced)
        with _plain_versions(), _recording_routes(routes["plain"]):
            want = _forced_logits(c, p, prompt, forced)
        name = f"{arch} {str(dt).removeprefix('torch.')} at {c.n_layers} layers"
        if cfg.is_moe:
            share, per = _route_agreement(routes["kernel"], routes["plain"])
            print(f"[lm] {name}: routing agreement {share:.6f} of (token, expert) assignments over "
                  f"{len(per)} MoE calls; prefill by layer {[round(a, 6) for a in per[: c.n_layers]]}, "
                  f"decode min {min(per[c.n_layers:]):.6f} (floors {ROUTE_FLOOR})")
            if per[0] < ROUTE_FLOOR["first layer"] or share < ROUTE_FLOOR["all calls"]:
                raise RuntimeError(f"{name}: routing agreement {per[0]} in the first layer, {share} over all "
                                   f"calls, below {ROUTE_FLOOR}")
            if share < 1.0:  # see MOE_ROUTES
                err, scale = (got - want).abs().max().item(), want.abs().max().item()
                same = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
                print(f"[lm] {name}: each path on its own routes: logits max abs err {err:.3e} (relative "
                      f"{err / scale:.3e}), argmax agreement {same:.4f}")
                with _plain_versions(), _replaying_routes(routes["kernel"]):
                    want = _forced_logits(c, p, prompt, forced)
                name += ", plain path on the kernel path's routes"
        if ssd_layers:  # see SSD_LAYERS
            y_err, st_err = max(e[0] for e in scans), max(e[1] for e in scans)
            print(f"[lm] {name}: {len(scans)} prefill scans against the plain version on the same inputs: "
                  f"y max err {y_err:.3e}, state {st_err:.3e} of max |plain| (tolerance {BF16_REL_TOL})")
            if len(scans) != c.n_layers or max(y_err, st_err) > BF16_REL_TOL:
                raise RuntimeError(f"{name}: the kernel path's scans disagree with the plain version: {scans}")
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise RuntimeError(f"{name}: logits not finite")
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        same = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        print(f"[lm] {name}: logits {tuple(got.shape)} kernel vs plain max abs err "
              f"{err:.3e}, max |logit| {scale:.3e} (relative {err / scale:.3e}, tolerance {LM_TOL[dt]}); "
              f"argmax agreement {same:.4f}")
        if dt == torch.bfloat16:
            served = (got[:, : LM_FORCED + 1].argmax(-1) == tokens[:, : LM_FORCED + 1]).float().mean().item()
            print(f"[lm] {arch}: teacher-forced kernel path reproduces the served tokens at {served:.4f} of positions")
        if ssd_layers:  # see SSD_LAYERS: held below with the model in fp32
            print(f"[lm] {name}: logits printed, not held (see SSD_LAYERS)")
        elif not scale > 0 or err > LM_TOL[dt] * scale:
            failures.append(f"{name}: kernel path disagrees with the plain path: {err} > {LM_TOL[dt]} * {scale}")
            print(f"[FAIL] {failures[-1]}")
        del p, got, want
    if "ssd_scan" in kernels:  # fp32_depth is None: params is whole
        hold_bf16_scans(arch, cfg, params, prompt, forced, failures)
    del params
    torch.cuda.empty_cache()
    out = {name: launches[name] for name in kernels}
    if "gemm" in kernels:
        out["gemm decode"] = decode_launches
    return out, served_by


def _hold_grads(name: str, desc: dict, got, want, tol: float, one_key: bool) -> float:
    """Hold (dq, dk, dv) ``got`` against ``want``: each max |difference|
    within ``tol`` of its own max |want|.  Where every row sees one key
    (``one_key``) dq and dk are 0 in exact arithmetic, so they are held
    against max |dv| instead.  Returns the worst ratio."""
    dv_scale = want[2].float().abs().max().item()
    worst = 0.0
    for g, w, which in zip(got, want, ("dq", "dk", "dv")):
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        if one_key and which != "dv":
            scale = max(scale, dv_scale)
        if not err <= tol * scale:
            raise RuntimeError(f"{name}: {which} disagrees at {desc}: max abs err {err}, max |want| {scale}, "
                               f"tolerance {tol} of it")
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def check_flash_bwd(gen: torch.Generator) -> dict:
    """Phase 11: ``flash_attention_bwd`` against ``flash_attention_bwd_plain``
    (the kernel's own o and lse), that against autograd through
    ``flash_attention_plain``, on the same inputs, over the training shapes
    and a grid that reaches every branch; two calls give the same bits;
    the lse against ``flash_attention_fwd_plain``'s.  Times the training
    shapes: kernel, plain backward and SDPA's backward (cuDNN or flash, by
    PyTorch's choice), by events and the profiler's device time.  Each case
    prints its route (``flash_attention.bwd_route``) and fails unless it is
    the expected one; a timed shape fails unless its profiled backward ran
    exactly the route's kernels (``flash_attention.bwd_kernels``).  Returns
    the ``flash_attention`` row's backward keys (granite-3-2b's, phi3.5-moe's
    and zamba2-2.7b's under keys that name them)."""
    f32, bf16 = torch.float32, torch.bfloat16
    base = dict(b=2, h=8, kvh=2, s=200, d=64, dtype=bf16, causal=True, window=0)
    cases = [dict(base, b=TRAIN_BATCH, h=c.n_heads, kvh=c.n_kv_heads, s=TRAIN_SEQ, d=c.hd, model=arch)
             for arch in TRAIN_MODELS for c in [get_config(arch)] if c.block_kind != "ssd"]  # zamba2: its shared block
    cases += [dict(base, d=d, dtype=dt) for dt in (bf16, f32) for d in fa.HEAD_DIMS]  # every head dim
    cases += [dict(base, h=h, kvh=kvh, s=130, d=d) for d in (64, 128)
              for h, kvh in ((4, 4), (8, 2), (10, 2), (14, 2), (24, 2))]  # GQA groups 1, 4, 5, 7 and 12
    cases += [dict(base, s=s, d=d) for s in (1, 15, 65, 1000) for d in (64, 128)]  # S
    cases += [dict(base, s=1000, d=128, dtype=f32), dict(base, s=1, d=64, dtype=f32)]
    cases += [  # Sq != Skv, both ways
        dict(base, s=15, skv=1000, causal=False), dict(base, s=448, skv=65), dict(base, s=1500, skv=448, h=12, kvh=12),
        dict(base, s=1, skv=1500, causal=False, kvh=1), dict(base, s=65, skv=15, d=128, window=64),
        dict(base, s=100, skv=300, d=128, dtype=f32), dict(base, s=77, skv=33, dtype=f32, causal=False, window=50),
        dict(base, s=100, skv=400, d=128, h=10, window=32),  # key tiles past Sq: whole clusters see no query
        dict(base, s=200, skv=330, h=14, window=48),
    ]
    cases += [dict(base, d=d, dtype=dt, causal=c, window=w) for dt in (bf16, f32) for d in (64, 192)
              for c, w in ((False, 0), (True, 7))]  # non-causal; a window
    cases += [dict(base, d=d, dtype=dt, strided=False) for dt in (bf16, f32) for d in (32, 128)]  # contiguous
    cases += [dict(base, d=d, pad=4) for d in (64, 80, 128)]  # rows 8-byte aligned only: the mma.sync route
    # D 80 on the wgmma route (two 128-byte boxes a tile, the second zero-filled past column 79): GQA groups 1
    # and 4, S 1, 15, 65 and 1000, Sq != Skv both ways, a window, non-causal
    cases += [dict(base, h=h, kvh=kvh, s=130, d=80) for h, kvh in ((4, 4), (8, 2))]
    cases += [dict(base, s=s, d=80) for s in (1, 15, 65, 1000)]
    cases += [dict(base, s=15, skv=1000, causal=False, d=80), dict(base, s=448, skv=65, d=80, h=4, kvh=4),
              dict(base, d=80, window=7), dict(base, d=80, causal=False), dict(base, s=100, skv=400, d=80, window=32)]
    out, max_err = {}, 0.0
    for case in cases:
        b, h, kvh, s, d, dt = (case[k] for k in ("b", "h", "kvh", "s", "d", "dtype"))
        skv, kw = case.get("skv", s), dict(causal=case["causal"], window=case["window"])

        def draw(n, heads):
            if "pad" in case:  # rows of d + pad elements: strides a multiple of 4 elements, not of 8
                x = torch.randn((b, n, heads, d + case["pad"]), generator=gen, device="cuda").to(dt)
                return x[..., :d].transpose(1, 2)
            if case.get("strided", True):  # the model's layout: [b, s, h, d] as a transposed view
                return torch.randn((b, n, heads, d), generator=gen, device="cuda").to(dt).transpose(1, 2)
            return torch.randn((b, heads, n, d), generator=gen, device="cuda").to(dt)

        q, k, v, do = draw(s, h), draw(skv, kvh), draw(skv, kvh), draw(s, h)
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        route = fa.bwd_route(q, k, v, o, do)
        want_route = ("simt" if dt == f32 else "wgmma" if d in fa.WGMMA_HEAD_DIMS and "pad" not in case else "mma")
        if route != want_route:
            raise RuntimeError(f"flash_attention_bwd took the {route} route at {case}, want {want_route}")
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
        auto = torch.autograd.grad(fa.flash_attention_plain(qa, ka, va, **kw), (qa, ka, va), do)
        lse_plain = fa.flash_attention_fwd_plain(q, k, v, **kw)[1]
        torch.cuda.synchronize()
        desc = {**case, "skv": skv, "dtype": str(dt).removeprefix("torch."), "route": route}
        if route == "wgmma":
            desc["cluster"] = fa.bwd_cluster(h, kvh)
        tol = ATTN_TOL if dt == f32 else BF16_REL_TOL
        one_key = skv == 1 or (case["causal"] and s == 1) or case["window"] == 1
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise RuntimeError(f"flash_attention_bwd: two calls differ at {desc}")
        lse_err = (lse - lse_plain).abs().max().item()
        if not lse_err <= ATTN_TOL * lse_plain.abs().max().item():
            raise RuntimeError(f"flash_attention lse disagrees with the plain version at {desc}: {lse_err}")
        err = _hold_grads("flash_attention_bwd", desc, got, plain, tol, one_key)
        auto_err = _hold_grads("flash_attention_bwd_plain against autograd", desc, plain, auto, tol, one_key)
        max_err = max(max_err, max((g.float() - w.float()).abs().max().item() for g, w in zip(got, plain)))
        print(f"[bwd] flash_attention_bwd {json.dumps({**desc, 'rel_err': err, 'plain_vs_autograd': auto_err, 'lse_err': lse_err})}")
        if "model" in case:
            flops, nbytes = fa.bwd_cost(q, k, case["causal"], case["window"])  # five products
            bound_ms, bound_by = _bound(flops, nbytes, PEAK_BF16_FLOPS)
            qc, kc, vc = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qc, kc, vc, is_causal=case["causal"], enable_gqa=True)
            doc = do.contiguous()

            def kern():
                return fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)

            def sdpa_bwd():
                return torch.autograd.grad(sdpa_out, (qc, kc, vc), doc, retain_graph=True)

            timed = dict(bwd_ms=_time_ms(kern),
                         bwd_plain_ms=_time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)),
                         bwd_library_ms=_time_ms(sdpa_bwd), bwd_bound_ms=bound_ms, bwd_bound_by=bound_by)
            timed["bwd_device_ms"], ran = _device_ms(kern)
            timed["bwd_library_device_ms"], sdpa_ran = _device_ms(sdpa_bwd, need=False)
            timed.update(bwd_host_ms=_host_ms(kern), bwd_max_abs_err=max(
                (g.float() - w.float()).abs().max().item() for g, w in zip(got, plain)))
            timed["bwd_device_functions"] = sorted(m.group(1) for n in ran if (m := FLASH_FN.search(n)))
            timed.update(bwd_route=route, bwd_kernel_launches=sum(ran.values()))
            if timed["bwd_device_functions"] != sorted(fa.bwd_kernels(route, d)) or sum(ran.values()) != len(
                    fa.bwd_kernels(route, d)):
                raise RuntimeError(f"flash_attention_bwd at {case['model']}'s training shape ran {ran}, want "
                                   f"{fa.bwd_kernels(route, d)} once each")
            ratios = dict(sdpa_ratio=timed["bwd_ms"] / timed["bwd_library_ms"],
                          sdpa_device_ratio=_ratio(timed["bwd_device_ms"], timed["bwd_library_device_ms"]),
                          bound_ratio=_ratio(timed["bwd_device_ms"], bound_ms))
            print(f"[bwd] flash_attention_bwd at {case['model']}'s training shape: "
                  f"{json.dumps({**timed, **ratios, 'flops': flops, 'bytes': nbytes})}")
            print(f"[bwd] it ran {json.dumps(ran)}; SDPA's backward ran {json.dumps(sdpa_ran)}")
            prefix = "" if not out else f"{case['model']} "
            out.update({prefix + key: val for key, val in timed.items()})
            del qc, kc, vc, sdpa_out
        del q, k, v, do, o, lse, got, again, plain, auto, qa, ka, va
    torch.cuda.empty_cache()
    out["bwd_max_abs_err"] = max_err
    return out


#: FLOPs and bytes of one backward of the scan, the kernel module's formula
ssd_bwd_cost = ssd.bwd_cost


def _hold_ssd_grads(name: str, desc: dict, got, want, tol: float) -> float:
    """Hold (dx, ddt, dA, dB, dC) ``got`` against ``want``: each max
    |difference| within ``tol`` of its own max |want|.  Returns the worst ratio."""
    worst = 0.0
    for g, w, which in zip(got, want, ("dx", "ddt", "dA", "dB", "dC"), strict=True):
        err, scale = (g.float() - w.float()).abs().max().item(), w.float().abs().max().item()
        if not err <= tol * scale:
            raise RuntimeError(f"{name}: {which} disagrees at {desc}: max abs err {err}, max |want| {scale}, "
                               f"tolerance {tol} of it")
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def _kernel_grids(fn, reps: int = 5) -> dict[str, list[list[int]]]:
    """The grid of each device kernel ``reps`` calls of ``fn`` launched, by
    the profiler's name, from its trace (kineto records each launch's
    grid).  Each window waits ``PROFILER_PAD_S`` on the host before its
    first call and after its last (a device record the profiler dates
    outside its window is dropped); a window that kept no grid is taken
    again after a pause, up to ``PROFILER_WINDOWS`` in all, then it raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILER_PAD_S)
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(trace))
            events = json.loads(trace.read_text()).get("traceEvents", [])
        grids: dict[str, list[list[int]]] = {}
        for e in events:
            if isinstance(e.get("args"), dict) and "grid" in e["args"]:
                grids.setdefault(e.get("name", ""), []).append(list(e["args"]["grid"]))
        if grids:
            return grids
        time.sleep(0.1)
    raise RuntimeError(f"the profiler kept no kernel grid of {reps} calls in {PROFILER_WINDOWS} windows")


def _ssd_states_blocks(fn, n: int) -> set[int]:
    """The blocks (x of the grid) the SSD backward's states kernel at state
    width ``n`` launched in ``fn``, from the profiler's trace; raises if the
    trace kept the grids of other kernels only."""
    name = f"ssd_scan_bwd_states_mma_kernel<{n}>"
    grids = _kernel_grids(fn)
    seen = {m.group(1): {g[0] for g in v} for k, v in grids.items() if (m := SSD_BWD_FN.search(k))}
    if name not in seen:
        raise RuntimeError(f"the profiler kept no grid of {name}: it kept {sorted(grids)}")
    return seen[name]


def check_ssd_bwd(gen: torch.Generator) -> dict:
    """Phase 11 for the SSD scan: ``ssd_scan_bwd`` against
    ``ssd_scan_bwd_plain``, and that against autograd through
    ``ssd_scan_plain``, on the same inputs: mamba2-130m's and zamba2-2.7b's
    training shapes (x, B and C strided as ``ssd_block`` passes them, no
    final-state gradient, as in training) in bf16, and in fp32 and
    contiguous, the reference tests' shapes, a ragged p tile and the smoke
    configs' chunk 8, with and without the final state's gradient; each
    case prints its route (``ssd_scan.bwd_route``) and fails unless it is
    the one expected (``"wgmma"`` for bf16 at chunk 64 and p 64); bf16
    within BF16_REL_TOL of each gradient's max |plain|, fp32 within SSD_TOL
    of it; two calls give the same bits.  At the training shapes it also
    runs, on the same inputs, the ``"wgmma"`` route given the forward's
    states (``ssd_scan.ssd_scan_states``' H_in), which must give the bits of
    the one that rebuilds them and launch its states kernel at half the
    blocks (the gradients' direction alone, read from the profiler's
    trace), the ``"mma"`` route (the ``mma.sync`` chunk kernel the
    ``"wgmma"`` one replaced) and the SIMT route (``ssd_scan.run_bwd_route``,
    each held to BF16_REL_TOL too), and ``ops._SsdScan`` under
    ``torch.utils.checkpoint`` as a checkpointed layer runs it
    (``ops.keeping_scan_states``), whose profiled backward must run exactly
    the route's kernels with the states kernel at half its blocks; times
    each route (kernel by kernel by device time, the whole by events too)
    beside the bound and the plain backward (no single PyTorch call
    computes the SSD backward), and fails unless the profiled backward ran
    exactly ``ssd_scan.bwd_kernels`` of its route.  Returns the
    ``ssd_scan`` row's backward keys (mamba2-130m's, zamba2-2.7b's under
    keys that name it)."""
    from torch.utils.checkpoint import checkpoint

    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for arch in SSD_MODELS:
        cfg = get_config(arch)
        shape = dict(b=TRAIN_BATCH, l=TRAIN_SEQ, h=cfg.ssm_heads, p=cfg.ssm_head_dim, n=cfg.ssm_state,
                     chunk=cfg.ssm_chunk)
        cases += [dict(shape, dtype=bf16, strided=True, state=False, model=arch),
                  dict(shape, dtype=f32, strided=False, state=True), dict(shape, dtype=bf16, strided=False, state=True)]
    cases += [dict(b=2, l=128, h=h, p=p, n=n, chunk=c, dtype=f32, strided=False, state=c == 16)  # the reference's grid
              for c in (16, 32) for h, p, n in ((2, 16, 8), (3, 8, 16))]
    cases += [dict(b=2, l=256, h=3, p=100, n=32, chunk=64, dtype=f32, strided=True, state=True),  # a ragged p tile
              dict(b=2, l=64, h=4, p=16, n=16, chunk=8, dtype=bf16, strided=True, state=True),  # the smoke configs
              dict(b=2, l=64, h=4, p=16, n=16, chunk=8, dtype=f32, strided=True, state=False)]
    out, max_err = {}, 0.0
    for case in cases:
        b, l, h, p, n, chunk, dt = (case[k] for k in ("b", "l", "h", "p", "n", "chunk", "dtype"))
        x, dtt, A, B, C = ssd_inputs(b, l, h, p, n, dt, case["strided"], gen)
        dy = torch.randn((b, l, h, p), generator=gen, device="cuda").to(dt)
        dstate = torch.randn((b, h, p, n), generator=gen, device="cuda") if case["state"] else None
        route = ssd.bwd_route(dt, p, n, chunk, all(ssd._aligned(t) for t in (x, B, C, dy)))
        if route != ("wgmma" if dt == bf16 and chunk == ssd.MMA_BWD_CHUNK and p == ssd.MMA_BWD_P else "simt"):
            raise RuntimeError(f"ssd_scan_bwd at {case} routes {route}")
        got = ssd.ssd_scan_bwd(x, dtt, A, B, C, dy, dstate, chunk=chunk)
        again = ssd.ssd_scan_bwd(x, dtt, A, B, C, dy, dstate, chunk=chunk)
        plain = ssd.ssd_scan_bwd_plain(x, dtt, A, B, C, dy, dstate, chunk=chunk)
        ins = [t.detach().clone().requires_grad_() for t in (x, dtt, A, B, C)]
        y, st = ssd.ssd_scan_plain(*ins, chunk=chunk)
        auto = torch.autograd.grad((y.float() * dy.float()).sum() + ((st * dstate).sum() if case["state"] else 0.0),
                                   ins)
        torch.cuda.synchronize()
        desc = {**case, "dtype": str(dt).removeprefix("torch."), "route": route}
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            raise RuntimeError(f"ssd_scan_bwd: two calls differ at {desc}")
        tol = SSD_TOL if dt == f32 else BF16_REL_TOL
        err = _hold_ssd_grads("ssd_scan_bwd", desc, got, plain, tol)
        auto_err = _hold_ssd_grads("ssd_scan_bwd_plain against autograd", desc, plain, auto, tol)
        max_err = max(max_err, max((g.float() - w.float()).abs().max().item() for g, w in zip(got, plain)))
        print(f"[bwd] ssd_scan_bwd {json.dumps({**desc, 'rel_err': err, 'plain_vs_autograd': auto_err})}")
        del ins, y, st, auto, again
        if "model" in case:
            flops, nbytes = ssd_bwd_cost(x, B, chunk, case["state"])
            bound_ms, bound_by = _bound(flops, nbytes, PEAK_BF16_FLOPS)
            tma = ssd.fwd_aligned(x, B, C, dy)
            want = ssd.bwd_kernels("wgmma", bf16, n, tma)
            h_in = ssd.ssd_scan_states(x, dtt, A, B, C, chunk=chunk)[2]  # the forward's states

            def kern():
                return ssd.ssd_scan_bwd(x, dtt, A, B, C, dy, dstate, chunk=chunk)

            def carried():
                return ssd.ssd_scan_bwd(x, dtt, A, B, C, dy, dstate, chunk=chunk, h_in=h_in)

            def mma():
                return ssd.run_bwd_route(x, dtt, A, B, C, dy, dstate, chunk=chunk, route="mma")

            def simt():
                return ssd.run_bwd_route(x, dtt, A, B, C, dy, dstate, chunk=chunk, route="simt")

            if not all(torch.equal(u, v) for u, v in zip(carried(), got)):
                raise RuntimeError(f"ssd_scan_bwd given the forward's states differs from the one that rebuilds "
                                   f"them at {desc}")
            errs = {name: _hold_ssd_grads(f"ssd_scan_bwd ({name})", desc, fn(), plain, BF16_REL_TOL)
                    for name, fn in (("mma", mma), ("simt", simt))}
            split: dict = {}
            split_carried: dict = {}
            split_mma: dict = {}
            timed = dict(bwd_route="wgmma", bwd_kernels=list(want), bwd_ms=_time_ms(kern),
                         bwd_plain_ms=_time_ms(lambda: ssd.ssd_scan_bwd_plain(x, dtt, A, B, C, dy, dstate,
                                                                              chunk=chunk)),
                         bwd_library_ms=None,  # no single PyTorch call computes the SSD backward
                         bwd_bound_ms=bound_ms, bwd_bound_by=bound_by)
            # in turns: wgmma, mma, simt, carried, mma, wgmma
            first, ran = _device_ms(kern, times=split)
            mma_first = _device_ms(mma, times=split_mma)[0]
            simt_ms = _device_ms(simt)[0]
            carried_ms, ran_carried = _device_ms(carried, times=split_carried)
            mma_second = _device_ms(mma)[0]
            second = _device_ms(kern)[0]
            device_ms, mma_ms = (first + second) / 2, (mma_first + mma_second) / 2
            kernels_ms = {m.group(1): v for k, v in split.items() if (m := SSD_BWD_FN.search(k))}
            carried_kernels_ms = {m.group(1): v for k, v in split_carried.items() if (m := SSD_BWD_FN.search(k))}
            mma_kernels_ms = {m.group(1): v for k, v in split_mma.items() if (m := SSD_BWD_FN.search(k))}
            blocks, blocks_carried = _ssd_states_blocks(kern, n), _ssd_states_blocks(carried, n)
            states = ssd.bwd_kernels("wgmma", bf16, n)[0]
            chunk_name, mma_chunk = want[1], ssd.bwd_kernels("mma", bf16, n)[1]
            timed.update(bwd_device_ms=device_ms, bwd_device_ms_runs=[first, second], bwd_host_ms=_host_ms(kern),
                         bwd_bound_ratio=device_ms / bound_ms,
                         bwd_device_functions=sorted(m.group(1) for k in ran if (m := SSD_BWD_FN.search(k))),
                         bwd_kernels_device_ms=kernels_ms, bwd_carried_device_ms=carried_ms,
                         bwd_carried_kernels_device_ms=carried_kernels_ms,
                         bwd_carried_device_functions=sorted(m.group(1) for k in ran_carried
                                                             if (m := SSD_BWD_FN.search(k))),
                         bwd_states_blocks=sorted(blocks), bwd_carried_states_blocks=sorted(blocks_carried),
                         bwd_mma_device_ms=mma_ms, bwd_mma_device_ms_runs=[mma_first, mma_second],
                         bwd_mma_kernels_device_ms=mma_kernels_ms, bwd_simt_device_ms=simt_ms,
                         bwd_mma_rel_err=errs["mma"], bwd_simt_rel_err=errs["simt"],
                         bwd_ratio_to_mma=device_ms / mma_ms, bwd_carried_ratio_to_mma=carried_ms / mma_ms,
                         bwd_chunk_ratio_to_mma=kernels_ms[chunk_name] / mma_kernels_ms[mma_chunk],
                         bwd_states_carried_ratio=carried_kernels_ms[states] / kernels_ms[states],
                         bwd_speedup=simt_ms / device_ms)
            if len(ran) != 3 or timed["bwd_device_functions"] != sorted(want) \
                    or timed["bwd_carried_device_functions"] != sorted(want):
                raise RuntimeError(f"ssd_scan_bwd at {case['model']}'s training shape ran {ran} ({ran_carried} given "
                                   f"the forward's states), want {want}")
            two, one = ssd.wgmma_bwd_grid(b, l, h, n)[0], ssd.wgmma_bwd_grid(b, l, h, n, carried=True)[0]
            if blocks != {two} or blocks_carried != {one} or 2 * one != two:
                raise RuntimeError(f"the states kernel at {case['model']}'s training shape launched {blocks} blocks, "
                                   f"{blocks_carried} given the forward's states; want {two}, {one}")
            # the autograd Function as a checkpointed layer runs it: its backward reads the recomputed forward's states
            ins = [t.detach().clone().requires_grad_() for t in (x, dtt, A, B, C)]

            def layer(*args):
                return (ops.ssd_scan(*args, chunk=chunk)[0].float() * dy.float()).sum()

            def step():
                loss = checkpoint(ops.keeping_scan_states(layer), *ins, use_reentrant=False)
                return torch.autograd.grad(loss, ins)

            fn_grads = step()
            _hold_ssd_grads("ops._SsdScan under checkpoint", desc, fn_grads,
                            ssd.ssd_scan_bwd_plain(x, dtt, A, B, C, dy, chunk=chunk), BF16_REL_TOL)
            fn_blocks = _ssd_states_blocks(step, n)
            fn_ran = sorted(m.group(1) for k in _device_ms(step, reps=10)[1] if (m := SSD_BWD_FN.search(k)))
            if fn_ran != sorted(want) or fn_blocks != {one}:
                raise RuntimeError(f"ops._SsdScan's backward under checkpoint at {case['model']}'s training shape ran "
                                   f"{fn_ran}, {fn_blocks} states blocks, want {want} with {one}")
            timed.update(bwd_checkpointed_device_functions=fn_ran, bwd_checkpointed_states_blocks=sorted(fn_blocks))
            del ins, fn_grads, h_in
            print(f"[bwd] ssd_scan_bwd at {case['model']}'s training shape, the wgmma route beside the mma and "
                  f"SIMT routes on the same inputs: {json.dumps({**timed, 'flops': flops, 'bytes': nbytes})}")
            prefix = "" if not out else f"{case['model']} "
            out.update({prefix + key: val for key, val in timed.items()})
        del x, dtt, A, B, C, dy, dstate, got, plain
    torch.cuda.empty_cache()
    out["bwd_max_abs_err"] = max_err
    return out


#: the wgmma instantiations, as the profiler names them, that read the backward's transposed operands in place:
#: dA = dC·Bᵀ (B K-major) and dB = Aᵀ·dC (A MN-major); the cluster size is picked at launch
GEMM_BWD_FN = re.compile(r"gemm_wgmma_bf16_kernel<[12], (?:0, 0|1, 1), [01]>")


def check_gemm_grad(gen: torch.Generator) -> dict:
    """Phase 12: the gradient of ``ops.gemm`` (an autograd Function whose
    backward is two more ``gemm`` calls on the transposed views) at
    phi3.5-moe's training shapes, bf16, dA = dC·Bᵀ and dB = Aᵀ·dC held
    against ``gemm_plain`` at GEMM_TOL, two calls the same bits; fails
    unless each product ran the wgmma instantiation that reads its
    transposed operand in place, the wrapper copied nothing, and the
    profiled backward ran those two kernels and no other (no copy, no
    elementwise kernel).  Times the backward, dA and dB alone, against
    ``torch.bmm`` on the transposed views (cuBLAS reads them as they are),
    by events and by the profiler's device time, beside the bound.  Returns
    the ``gemm`` row's backward keys for one phi3.5-moe layer (gate, up,
    down)."""
    bf16 = torch.bfloat16
    cfg = get_config("phi3.5-moe-42b")
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    cap = blocks.moe_capacity(cfg, TRAIN_BATCH * TRAIN_SEQ)
    keys = ("bwd_ms", "bwd_device_ms", "bwd_library_ms", "bwd_library_device_ms", "bwd_dA_device_ms",
            "bwd_dB_device_ms", "flops", "bytes", "dA_bytes", "dB_bytes")
    tot = {key: 0.0 for key in keys}
    for label, (K, N), per_layer in (("gate/up", (d, f), 2), ("down", (f, d), 1)):
        a = torch.randn((E, cap, K), generator=gen, device="cuda").to(bf16).requires_grad_()
        b = (torch.randn((E, K, N), generator=gen, device="cuda") / K**0.5).to(bf16).requires_grad_()
        dc = torch.randn((E, cap, N), generator=gen, device="cuda").to(bf16)
        c = ops.gemm(a, b)
        before, copies = gm.launches, gm.copies
        da, db = torch.autograd.grad(c, (a, b), dc, retain_graph=True)
        launched, copied = gm.launches - before, gm.copies - copies
        ad, bd = a.detach(), b.detach()
        da_p, db_p = gm.gemm_plain(dc, bd.transpose(1, 2)), gm.gemm_plain(ad.transpose(1, 2), dc)
        da2, db2 = torch.autograd.grad(c, (a, b), dc, retain_graph=True)
        torch.cuda.synchronize()
        errs = []
        for which, got, want in (("dA", da, da_p), ("dB", db, db_p)):
            errs.append((got.float() - want.float()).abs().max().item())
            if not torch.allclose(got.float(), want.float(), rtol=GEMM_TOL[bf16], atol=GEMM_TOL[bf16]):
                raise RuntimeError(f"gemm gradient {which} disagrees with gemm_plain at phi3.5-moe {label}: {errs[-1]}")
        if not (torch.equal(da, da2) and torch.equal(db, db2)):
            raise RuntimeError(f"gemm gradient at phi3.5-moe {label}: two calls gave other bits")
        if launched != 2 or copied:
            raise RuntimeError(f"the gemm backward launched the kernel {launched} times, want 2, and copied "
                               f"{copied} operands, want 0")
        kernels = {"dA": gm.route(bf16, cap, N, K, gm._aligned(dc) and gm._aligned(bd.transpose(1, 2)),
                                  *gm.majors(dc, bd.transpose(1, 2))),
                   "dB": gm.route(bf16, K, cap, N, gm._aligned(ad.transpose(1, 2)) and gm._aligned(dc),
                                  *gm.majors(ad.transpose(1, 2), dc))}
        # dA's reduction is d_ff or d (the long schedule), dB's the capacity (the short one)
        want = {"dA": "gemm_wgmma_bf16_kernel<C, 0, 0, 0>", "dB": "gemm_wgmma_bf16_kernel<C, 1, 1, 1>"}
        if {k: gm.KERNELS[r.kernel] for k, r in kernels.items()} != want:
            raise RuntimeError(f"the gemm backward at phi3.5-moe {label} routes {kernels}, want {want}")
        flops, nbytes = gm.bwd_cost(a, b)
        bound_ms, bound_by = _bound(flops, nbytes, PEAK_BF16_FLOPS)

        def backward():
            return torch.autograd.grad(c, (a, b), dc, retain_graph=True)

        def library():
            return torch.bmm(dc, bd.transpose(1, 2)), torch.bmm(ad.transpose(1, 2), dc)

        row = dict(bwd_ms=_time_ms(backward), bwd_library_ms=_time_ms(library), flops=flops, bytes=nbytes,
                   dA_bytes=2.0 * (dc.numel() + b.numel() + da.numel()),
                   dB_bytes=2.0 * (a.numel() + dc.numel() + db.numel()), bound_ms=bound_ms, bound_by=bound_by)
        row["bwd_device_ms"], ran = _device_ms(backward)
        row["bwd_library_device_ms"], _ = _device_ms(library, need=False)
        row["bwd_dA_device_ms"], _ = _device_ms(lambda: gm.gemm(dc, bd.transpose(1, 2)))
        row["bwd_dB_device_ms"], _ = _device_ms(lambda: gm.gemm(ad.transpose(1, 2), dc))
        row["ran"] = ran = {m.group(1) if (m := GEMM_FN.search(n)) else n: c for n, c in ran.items()}
        if len(ran) != 2 or not all(GEMM_BWD_FN.fullmatch(n) and c == 1 for n, c in ran.items()):
            raise RuntimeError(f"the profiled gemm backward at phi3.5-moe {label} ran {ran}, want one dA and one dB "
                               f"on the transposed wgmma instantiations and nothing else")
        row["kernels"] = {k: gm.KERNELS[r.kernel] for k, r in kernels.items()}
        print(f"[bwd] gemm gradient at phi3.5-moe {label} a [{E},{cap},{K}], b [{E},{K},{N}]: "
              f"{json.dumps({**row, 'dA_err': errs[0], 'dB_err': errs[1]})}")
        for key in tot:
            tot[key] = None if tot[key] is None or row[key] is None else tot[key] + per_layer * row[key]
        del a, b, dc, c, da, db, da2, db2, da_p, db_p, ad, bd
    torch.cuda.empty_cache()
    bound_ms, bound_by = _bound(tot["flops"], tot["bytes"], PEAK_BF16_FLOPS)
    print(f"[bwd] gemm gradient, one phi3.5-moe layer (gate, up, down): device {tot['bwd_device_ms']} ms "
          f"(dA {tot['bwd_dA_device_ms']}, dB {tot['bwd_dB_device_ms']}), torch.bmm on the transposed views "
          f"{tot['bwd_library_device_ms']} ms, bound {bound_ms} ms ({bound_by}): "
          f"{json.dumps({**tot, 'bound_ms': bound_ms})}")
    return {"bwd_ms": tot["bwd_ms"], "bwd_device_ms": tot["bwd_device_ms"], "bwd_library_ms": tot["bwd_library_ms"],
            "bwd_library_device_ms": tot["bwd_library_device_ms"], "bwd_dA_device_ms": tot["bwd_dA_device_ms"],
            "bwd_dB_device_ms": tot["bwd_dB_device_ms"], "bwd_bound_ms": bound_ms, "bwd_bound_by": bound_by}


@contextlib.contextmanager
def _checking_first_grads(bad: list, count: list):
    """Before the first optimizer update, append to ``bad`` every gradient
    leaf that is not finite or is zero throughout, and to ``count`` the
    number of leaves."""
    update = AdamW.update

    def checking(self, grads, state, params):
        if not count:
            named = list(named_leaves(grads))
            bad.extend(n for n, g in named if not (torch.isfinite(g).all() and (g != 0).any()))
            count.append(len(named))
        return update(self, grads, state, params)

    with mock.patch.object(AdamW, "update", checking):
        yield


class _FlashNoDelta(torch.autograd.Function):
    """The plain attention forward with a backward that leaves out delta =
    rowsum(dO∘O), so that dS = P∘dP: dV right, dQ and dK wrong."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        zero = torch.zeros_like(do)  # o = 0 makes delta = rowsum(dO∘O) = 0
        return (*fa.flash_attention_bwd_plain(q, k, v, zero, lse, do, causal=ctx.causal, window=ctx.window),
                None, None)


#: attention faults that the bf16 training check must see, each in place of
#: ``ops.flash_attention`` on the plain path: the backward without delta (the
#: loss unchanged, the gradients of q and k wrong), and a causal mask dropped
#: (every query sees the whole sequence)
TRAIN_CONTROLS = {
    "no delta": ("flash_attention", lambda q, k, v, *, causal=True, window=0, fp32_scores=True: _FlashNoDelta.apply(
        q, k, v, causal, window)),
    "not causal": ("flash_attention", lambda q, k, v, *, causal=True, window=0, fp32_scores=True:
                   fa.flash_attention_plain(q, k, v, causal=False, window=window)),
}
#: the bf16-score mode's training check (phase 16): its control, in place of ``ops.flash_attention`` on the
#: plain path, is the fp32-score function
BF16S_TRAIN_CONTROLS = {
    "fp32 scores": ("flash_attention", lambda q, k, v, *, causal=True, window=0, fp32_scores=True:
                    fa.flash_attention_plain(q, k, v, causal=causal, window=window)),
}


def _scan_carry_detached(x, dt, A, B, C, *, chunk=64):
    """The plain scan chunk by chunk with the state entering each chunk
    detached: the same values, but the carried state's gradient dropped
    across chunks (each chunk's own terms kept)."""
    nc, cast = x.shape[1] // chunk, (lambda t: t.float())
    state, ys = None, []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        y, own = ssd.ssd_scan_plain(cast(x[:, sl]), dt[:, sl], A, cast(B[:, sl]), cast(C[:, sl]), chunk=chunk)
        if state is not None:
            cum = torch.cumsum(dt[:, sl].float() * A, dim=1)  # [b, cl, h]
            entering = state.detach()
            y = y + torch.exp(cum)[..., None] * torch.einsum("bln,bhpn->blhp", C[:, sl].float(), entering)
            own = entering * torch.exp(cum[:, -1])[..., None, None] + own
        state = own
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), state


class _SsdNoDecayGrad(torch.autograd.Function):
    """The plain scan with a backward whose ddt leaves out the decay's term
    (the reverse cumulative sum of d(cum) times A): ddt = dxdt·x alone."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C = ctx.saved_tensors
        dx, _, dA, dB, dC = ssd.ssd_scan_bwd_plain(x.float(), dt, A, B.float(), C.float(), dy.float(), dstate,
                                                   chunk=ctx.chunk)
        ddt = (dx * x.float()).sum(-1) / dt  # dx = dxdt·dt
        return dx.to(x.dtype), ddt, dA, dB.to(B.dtype), dC.to(C.dtype), None


#: SSD faults that the SSD models' training check must see, each in place of
#: ``ops.ssd_scan`` on the plain path, both in the backward alone (the loss
#: unchanged): the carried state's gradient dropped across chunks, and ddt
#: without its decay term
SSD_TRAIN_CONTROLS = {
    "no carried dH": ("ssd_scan", _scan_carry_detached),
    "ddt without decay": ("ssd_scan", lambda x, dt, A, B, C, *, chunk=64: _SsdNoDecayGrad.apply(x, dt, A, B, C, chunk)),
}


def _leaf_ratios(grads: dict, plain: list) -> dict[str, float]:
    """Each leaf's max |grads - plain| over its max |plain| (inf where that is
    not finite), ``plain`` as ``named_leaves`` lists it."""
    out = {}
    for (name, g), (_, w) in zip(named_leaves(grads), plain, strict=True):
        scale, err = w.float().abs().max().item(), (g.float() - w.float()).abs().max().item()
        ratio = err / scale if scale else 0.0 if err == 0 else math.inf
        out[name] = ratio if math.isfinite(ratio) else math.inf
    return out


def train_readings(cfg, params: dict, batch: dict, controls: dict | None = None,
                   scans=contextlib.nullcontext) -> dict:
    """One ``transformer.value_and_grad`` of ``params`` on ``batch`` on the
    kernel path, on the plain path (``ops`` swapped as in phase 8) and on
    the plain path with each of ``controls`` (default TRAIN_CONTROLS: name
    -> (the ``ops`` function it replaces, the fault)) in its place, MoE on
    the kernel path's routes, each inside ``scans()`` (``_bf16_scans``: the
    model in fp32 with bf16 scans).  Returns, for the kernel path and each
    control against the plain path, the loss's relative difference (inf if
    not finite) and each leaf's gradient difference (``_leaf_ratios``)."""
    controls = TRAIN_CONTROLS if controls is None else controls
    routes: list = []
    with _recording_routes(routes), scans():
        loss, grads = transformer.value_and_grad(cfg, params, batch)
    kernel = (loss.item(), grads)
    del grads

    def on_routes():
        return _replaying_routes(routes) if cfg.is_moe else contextlib.nullcontext()

    with _plain_versions(), on_routes(), scans():
        loss, grads = transformer.value_and_grad(cfg, params, batch)
    want, plain = loss.item(), list(named_leaves(grads))
    del grads

    def reading(got: float, grads: dict) -> dict:
        rel = abs(got - want) / abs(want)
        return {"loss": rel if math.isfinite(rel) else math.inf, "leaves": _leaf_ratios(grads, plain)}

    out = {"kernel": reading(*kernel)}
    del kernel
    for name, (op, fault) in controls.items():
        with _plain_versions(), mock.patch.object(ops, op, fault), on_routes(), scans():
            loss, grads = transformer.value_and_grad(cfg, params, batch)
        out[name] = reading(loss.item(), grads)
        del grads
    return out


def hold_train_readings(name: str, readings: dict, failures: list[str], limits: tuple[float, float] | None = None,
                        loss_controls: tuple[str, ...] = ("not causal",)) -> None:
    """Print ``train_readings``'s readings; append to ``failures`` if the
    kernel path misses the loss or gradient limit (``limits``, default
    TRAIN_LOSS_TOL and TRAIN_GRAD_TOL), if a control of ``loss_controls``
    (one that changes the forward) meets the loss limit, or if any control
    meets the gradient limit at every leaf."""
    loss_tol, grad_tol = limits or (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL)
    for path, r in readings.items():
        leaf = max(r["leaves"], key=r["leaves"].get)
        print(f"[train] {name}, {path} against the plain path: loss relative {r['loss']:.3e} (tolerance "
              f"{loss_tol}); worst gradient leaf {leaf} at {r['leaves'][leaf]:.3e} of its max |plain| "
              f"(tolerance {grad_tol}); every leaf {json.dumps(r['leaves'])}")
    kernel = readings["kernel"]
    worst = max(kernel["leaves"].values())
    if not (kernel["loss"] <= loss_tol and worst <= grad_tol):
        failures.append(f"{name}: kernel path against plain path: loss {kernel['loss']}, worst leaf {worst}")
        print(f"[FAIL] {failures[-1]}")
    for path in loss_controls:
        if not readings[path]["loss"] > loss_tol:
            failures.append(f"{name}: the control '{path}' meets the loss tolerance")
            print(f"[FAIL] {failures[-1]}")
    for path in readings.keys() - {"kernel"}:
        if not max(readings[path]["leaves"].values()) > grad_tol:
            failures.append(f"{name}: the control '{path}' meets the gradient tolerance at every leaf")
            print(f"[FAIL] {failures[-1]}")


def ssd_train_readings(cfg, params: dict, batch: dict, model: str, depth: int | None) -> tuple[str, dict]:
    """``train_readings`` of an SSD or hybrid model beside SSD_TRAIN_CONTROLS:
    ``model`` "bf16" (the weights as they are) or "mixed" (the model in fp32
    with bf16 scans, ``_bf16_scans``), its layers cut to the first ``depth``
    (None: all).  Returns a name for the readings, and the readings."""
    if depth:
        cfg, params = dataclasses.replace(cfg, n_layers=depth), {**params, "blocks": {
            k: v[:depth] for k, v in params["blocks"].items()}}
    if model == "mixed":
        c, p, scans, what = dataclasses.replace(cfg, dtype=torch.float32), _cast(params, torch.float32), \
            _bf16_scans, "fp32 with bf16 scans"
    else:
        c, p, scans, what = cfg, params, contextlib.nullcontext, "bf16"
    return f"{what} at {cfg.n_layers} layers", train_readings(c, p, batch, SSD_TRAIN_CONTROLS, scans)


def hold_ssd_train_readings(arch: str, cfg, params: dict, batch: dict, failures: list[str]) -> None:
    """The SSD models' kernel-vs-plain training check: ``ssd_train_readings``
    in fp32 with bf16 scans at SSD_HOLD_DEPTH, held to SSD_TRAIN_LOSS_TOL
    and SSD_TRAIN_GRAD_TOL, where both controls must miss the gradient
    limit."""
    name, readings = ssd_train_readings(cfg, params, batch, "mixed", SSD_HOLD_DEPTH[arch])
    hold_train_readings(f"{arch} {name}", readings, failures, (SSD_TRAIN_LOSS_TOL, SSD_TRAIN_GRAD_TOL[arch]),
                        loss_controls=())


def check_resume(arch: str, cfg) -> None:
    """Phase 13's resume check on ``cfg`` (RESUME_CUT of the trained
    model): an uninterrupted run of TRAIN_STEPS steps; a run of half of them
    (the same cosine horizon) that checkpoints at its end, the middle; a run
    that resumes from that checkpoint and repeats the rest.  The repeated
    losses are held to RESUME_TOL of the uninterrupted ones."""
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, schedule_steps=TRAIN_STEPS, log_every=0, seed=0, device="cuda")
    mid = TRAIN_STEPS // 2
    whole = train(cfg, steps=TRAIN_STEPS, **kw)["losses"]
    with tempfile.TemporaryDirectory() as ckpt:
        first = train(cfg, steps=mid, ckpt_dir=ckpt, save_every=mid, **kw)["losses"]
        t0 = time.perf_counter()
        resumed = train(cfg, steps=TRAIN_STEPS, ckpt_dir=ckpt, save_every=mid, **kw)["losses"]
        torch.cuda.synchronize()
        t_resume = time.perf_counter() - t0
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(first + resumed, whole, strict=True)]
    print(f"[train] {arch} at {cfg.n_layers} layer(s), {cfg.n_experts or 'no'} experts, full width "
          f"({cfg.param_count() / 1e9:.3f} B parameters): uninterrupted losses {whole}; {first} to the checkpoint "
          f"at step {mid}, then {resumed} resumed from it ({t_resume:.1f} s with the restore and the last save); "
          f"relative difference {rel} (tolerance {RESUME_TOL})")
    if not all(math.isfinite(x) for x in whole) or max(rel) > RESUME_TOL:
        raise RuntimeError(f"{arch}: resumed losses {first + resumed} differ from {whole} by {rel}")


def _train_launches(cfg, steps: int) -> dict[str, int]:
    """The launches ``steps`` training steps of ``cfg`` make, by the code
    (``transformer.backbone``): with remat each layer's forward runs again in
    the backward; a hybrid's shared attention block (after every
    ``shared_attn_every``-th SSD layer) is not recomputed; MoE: 3 expert
    products a layer forward, 3 again, and dA and dB of each in the
    backward."""
    L, kind = cfg.n_layers, cfg.block_kind
    again = 2 if cfg.remat == "full" else 1
    n_ssd = L if kind in ("ssd", "hybrid") else 0
    n_attn = L if kind == "attn" else L // cfg.shared_attn_every if kind == "hybrid" else 0
    moe = L if cfg.is_moe else 0
    per_step = {"flash_attention": (again if kind == "attn" else 1) * n_attn, "flash_attention_bwd": n_attn,
                "ssd_scan": again * n_ssd, "ssd_scan_bwd": n_ssd, "gemm": (3 * again + 6) * moe, "gemm_bwd": 6 * moe,
                "conv2d_im2col": 0}
    return {k: v * steps for k, v in per_step.items()}


def drive_train(arch: str, depth: int | None, grad_depth: int, failures: list[str]) -> dict:
    """Phase 13 for one model: ``launch.train.train`` on the card, bf16,
    TRAIN_STEPS steps of the data pipeline's batches, every launch count 0
    just before, held to ``_train_launches``; a warm step of
    ``transformer.make_train_step`` timed and profiled; the loss and every
    leaf's gradient at the trained depth, kernel path against plain path
    beside the controls (``train_readings``: bf16 and TRAIN_CONTROLS for an
    attention model, ``hold_ssd_train_readings`` for an SSD or hybrid one),
    and every leaf's gradient in fp32 at ``grad_depth``; the resume check
    (``check_resume``, at RESUME_CUT).  Returns the training run's
    launches, its peak memory and the warm step's wall."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=depth) if depth else full
    L = cfg.n_layers
    print(f"[train] {arch}: {L} of {full.n_layers} layers, full width (d_model {cfg.d_model}), "
          f"{cfg.param_count() / 1e9:.3f} B parameters, batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    mods = {"conv2d_im2col": im2col_conv, "flash_attention": fa, "ssd_scan": ssd, "gemm": gm}
    for mod in mods.values():
        mod.launches = 0
    fa.bwd_launches = gm.bwd_launches = ssd.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    bad, count = [], []
    t0 = time.perf_counter()
    with _checking_first_grads(bad, count):
        res = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=0, seed=0, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**{name: mod.launches for name, mod in mods.items()}, "flash_attention_bwd": fa.bwd_launches,
                "gemm_bwd": gm.bwd_launches, "ssd_scan_bwd": ssd.bwd_launches}
    losses, state, peak = res["losses"], res["state"], torch.cuda.max_memory_allocated() / 2**30
    del res
    print(f"[train] {arch}: losses {losses}, wall {wall:.1f} s (weights drawn on the card included), launches "
          f"{launches}, max_memory_allocated {peak:.2f} GiB")
    want = _train_launches(cfg, TRAIN_STEPS)
    if launches != want:
        raise RuntimeError(f"{arch}: the training run launched {launches}, want {want}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{arch}: training losses {losses}")
    if not count or bad:
        raise RuntimeError(f"{arch}: step 0's gradient is not finite and non-zero at {bad} of {count} leaves")
    print(f"[train] {arch}: every one of the {count[0]} parameter leaves got a finite, non-zero gradient at step 0")

    # a warm step of the main path's train step on the trained state: timed, then profiled
    opt = AdamW(AdamWConfig(peak_lr=3e-4, warmup=min(20, TRAIN_STEPS // 5 + 1), total_steps=TRAIN_STEPS))
    train_step = transformer.make_train_step(cfg, opt)
    batch = next(make_batch_iterator(cfg, DataConfig(batch=TRAIN_BATCH, seq=TRAIN_SEQ, vocab=cfg.vocab, seed=0),
                                     start_step=TRAIN_STEPS, device="cuda"))
    params, opt_state = state["params"], state["opt"]
    del state

    def step():
        return train_step(params, opt_state, batch)  # updates params and opt_state in place

    step()
    walls = []
    for _ in range(3):  # one step's host time moves by tens of percent between steps (the host issues ~14k launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    t_step = sorted(walls)[1]
    grads = transformer.value_and_grad(cfg, params, batch)[1]
    opt_ms = _time_ms(lambda: opt.update(grads, opt_state, params), reps=2)
    del grads
    print(f"[train] {arch} warm steps {[round(w * 1e3, 1) for w in walls]} ms on the host clock: median "
          f"{t_step * 1e3:.1f} ms, {TRAIN_BATCH * TRAIN_SEQ / t_step:.1f} tokens/s; the optimizer's update alone "
          f"{opt_ms:.2f} ms (events)")
    from torch.profiler import ProfilerActivity, profile

    per_step = _train_launches(cfg, 1)
    # the model's bf16 q, k, v, o and dO are strided views TMA can address: the wgmma route where its head dims allow
    bwd_kernels = fa.bwd_kernels("wgmma" if cfg.hd in fa.WGMMA_HEAD_DIMS else "mma", cfg.hd)
    per_bwd = len(bwd_kernels)
    ssd_bwd_kernels = () if cfg.block_kind == "attn" else ssd.bwd_kernels(
        ssd.bwd_route(torch.bfloat16, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk, True), torch.bfloat16,
        cfg.ssm_state)
    # the forward scan's route (the wgmma route's two kernels at the training shapes)
    ssd_fwd_kernels = () if cfg.block_kind == "attn" else ssd.fwd_kernels(
        ssd.plan(torch.bfloat16, TRAIN_BATCH, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk, True),
        cfg.ssm_state)
    calls_of = ("flash_calls", "gemm_calls", "ssd_calls", "ssd_bwd_calls")
    for _ in range(PROFILER_WINDOWS):
        before = {name: mod.launches for name, mod in mods.items()}
        before.update(flash_attention_bwd=fa.bwd_launches, gemm_bwd=gm.bwd_launches, ssd_scan_bwd=ssd.bwd_launches)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        table = _kernel_table(prof, wall)
        ran = {name: mod.launches - before[name] for name, mod in mods.items()}
        ran.update(flash_attention_bwd=fa.bwd_launches - before["flash_attention_bwd"],
                   gemm_bwd=gm.bwd_launches - before["gemm_bwd"], ssd_scan_bwd=ssd.bwd_launches - before["ssd_scan_bwd"])
        kept = sum(sum(table[k].values()) for k in calls_of)
        issued = (ran["flash_attention"] + per_bwd * ran["flash_attention_bwd"] + ran["gemm"]
                  + len(ssd_fwd_kernels) * ran["ssd_scan"] + len(ssd_bwd_kernels) * ran["ssd_scan_bwd"])
        if table["kernel_calls"] and kept == issued:
            break
        print(f"[train] {arch} profile: the profiler kept {kept} of {issued} port kernel launches; taken again")
        time.sleep(0.1)
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    split = {"flash forward": 0.0, "flash backward": 0.0, "ssd forward": 0.0, "ssd backward": 0.0, "gemm": 0.0}
    for name, ms in rows:
        if m := FLASH_FN.search(name):
            split["flash backward" if "bwd" in m.group(1) else "flash forward"] += ms
        elif SSD_BWD_FN.search(name):
            split["ssd backward"] += ms
        elif SSD_FN.search(name):
            split["ssd forward"] += ms
        elif GEMM_FN.search(name):
            split["gemm"] += ms
    table.update(split_ms=split, optimizer_ms=opt_ms, step_wall_ms=t_step * 1e3,
                 tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / t_step, peak_gib=peak)
    print(f"[train] {arch} profile of one step: {json.dumps(table)}")
    want_calls = {}
    if per_step["flash_attention_bwd"]:
        n_attn = per_step["flash_attention_bwd"]
        # the forward on wgmma once per attention layer (again under remat), never on mma.sync
        want_calls.update({f"flash_fwd_wgmma_kernel<{cfg.hd}>": per_step["flash_attention"]})
        want_calls.update({name: n_attn for name in bwd_kernels})
    if per_step["ssd_scan_bwd"]:
        n_ssd = per_step["ssd_scan_bwd"]
        # the forward on the wgmma route once per SSD layer (again under remat), never on mma.sync
        want_calls.update({**{name: per_step["ssd_scan"] for name in ssd_fwd_kernels},
                           **{name: n_ssd for name in ssd_bwd_kernels}})
    calls = {**table["flash_calls"], **table["ssd_calls"], **table["ssd_bwd_calls"]}
    if calls != want_calls or ran != per_step:
        raise RuntimeError(f"{arch}: the profiled step ran {calls} (launches {ran}), want {want_calls} ({per_step})")
    if cfg.is_moe:
        gemm_n, gemm_bwd = ran["gemm"], ran["gemm_bwd"]
        if sum(table["gemm_calls"].values()) != gemm_n:
            raise RuntimeError(f"{arch}: the profiled step launched gemm {gemm_n} times, {gemm_bwd} of them in the "
                               f"backward, and the profiler saw {table['gemm_calls']}")
        print(f"[train] {arch}: the backward ran gemm {gemm_bwd} of the step's {gemm_n} times ({table['gemm_calls']})")
    print(f"[train] {arch}: the profiled step ran each backward kernel once per layer that has it and each "
          f"forward kernel as often as the code runs that layer (remat): {json.dumps(calls)}")

    # kernel path against plain path: the loss and every leaf's gradient at the trained depth, beside the
    # controls ...
    del opt_state
    torch.cuda.empty_cache()
    if cfg.block_kind == "attn":
        hold_train_readings(f"{arch} bf16 at {L} layers", train_readings(cfg, params, batch), failures)
    else:
        hold_ssd_train_readings(arch, cfg, params, batch, failures)
    del params
    torch.cuda.empty_cache()
    # ... and every leaf's gradient in fp32 at grad_depth
    c32 = dataclasses.replace(cfg, n_layers=grad_depth, dtype=torch.float32)
    p32 = init_params(c32, torch.Generator(device="cuda").manual_seed(1), "cuda")
    routes = []
    with _recording_routes(routes):
        lk, gk = transformer.value_and_grad(c32, p32, batch)
    with _plain_versions(), (_replaying_routes(routes) if cfg.is_moe else contextlib.nullcontext()):
        lp, gp = transformer.value_and_grad(c32, p32, batch)
    ratios = _leaf_ratios(gk, list(named_leaves(gp)))
    worst_leaf = max(ratios, key=ratios.get)
    for name, ratio in ratios.items():
        if not ratio <= GRAD_TOL:
            failures.append(f"{arch} fp32 at {grad_depth} layers: gradient of {name} differs by {ratio} of its max")
            print(f"[FAIL] {failures[-1]}")
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    print(f"[train] {arch} fp32 at {grad_depth} layers: loss relative difference {loss_rel:.3e}; worst gradient "
          f"leaf {worst_leaf} at {ratios[worst_leaf]:.3e} of its max |plain| (tolerance {GRAD_TOL}) over "
          f"{len(ratios)} leaves")
    if not loss_rel <= LM_TOL[torch.float32]:
        failures.append(f"{arch} fp32 training loss: relative difference {loss_rel}")
        print(f"[FAIL] {failures[-1]}")
    del p32, gk, gp
    torch.cuda.empty_cache()
    check_resume(arch, dataclasses.replace(full, **RESUME_CUT[arch]))
    return {**launches, "peak_gib": peak, "step_ms": t_step * 1e3}


# ---------------------------------------------------------------------------
# The bf16-score mode (attn_fp32_scores=False): phases 6b, 11b and 16
# ---------------------------------------------------------------------------

@functools.cache
def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


#: the models whose served flash calls (``served_flash_calls``) phase 6b holds and times in the mode
BF16S_SERVED = ("granite-3-2b", "phi3.5-moe-42b", "zamba2-2.7b", "nemotron-4-340b", "whisper-small")
#: the training shapes phase 11b times, forward and backward (zamba2: its shared block)
BF16S_TRAINED = ("granite-3-2b", "phi3.5-moe-42b", "zamba2-2.7b")


def _rms_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Root mean square of ``got - want`` over that of ``want``."""
    got, want = got.float(), want.float()
    return ((got - want).square().mean().sqrt() / want.square().mean().sqrt().clamp_min(1e-30)).item()


def _max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _hold_bf16s(name: str, desc: dict, pairs: dict, dt: torch.dtype) -> dict:
    """Hold each ``name -> (kernel, plain, control)`` of the bf16-score mode:
    the kernel's ``_rms_rel`` to plain within BF16S_TOL[dt], the control's
    (the fp32-score function) beyond it for at least one tensor.  Returns
    the readings."""
    tol = BF16S_TOL[dt]
    out = {}
    for key, (got, want, ctl) in pairs.items():
        out[key] = {"rms": _rms_rel(got, want), "max": _max_rel(got, want), "control_rms": _rms_rel(ctl, want)}
    print(f"[bf16s] {name} {json.dumps({**desc, **out})}")
    bad = {k: r["rms"] for k, r in out.items() if not r["rms"] <= tol}
    if bad:
        raise RuntimeError(f"{name} disagrees with its plain version at {desc}: rms {bad} > {tol}")
    if not max(r["control_rms"] for r in out.values()) > tol:
        raise RuntimeError(f"{name}: the fp32-score control meets the mode's tolerance {tol} at {desc}: {out}")
    return out


def _bf16s_cases(gen_cases: list[dict]) -> list[dict]:
    """The mode's grid: ``gen_cases`` and every head dim in bf16 and fp32,
    GQA groups 1, 4 and 5, a window, ragged S, no causal mask and a key
    length other than the query's both ways (whisper's 448 x 1500 among
    them), D 80 on the wgmma route at groups 1 and 5; and bf16 rows only
    8-byte aligned at D 64, 80 and 128 (``pad``), which keep the backward on
    the ``mma.sync`` kernels."""
    f32, bf16 = torch.float32, torch.bfloat16
    base = dict(b=2, h=8, kvh=2, s=200, d=64, dtype=bf16, causal=True, window=0)
    return gen_cases + [dict(base, d=d, dtype=dt) for dt in (bf16, f32) for d in fa.HEAD_DIMS] + [
        dict(base, h=4, kvh=4, s=65, d=16), dict(base, h=10, kvh=2, s=130, d=128, causal=False),
        dict(base, s=300, d=80, window=50), dict(base, s=100, d=192, dtype=f32, window=16),
        dict(base, s=15, skv=1000, causal=False), dict(base, s=448, skv=65, d=128),
        dict(base, b=1, h=12, kvh=12, s=448, skv=1500, causal=False), dict(base, s=77, skv=33, dtype=f32, window=50),
        dict(base, pad=4), dict(base, d=128, pad=4), dict(base, h=4, kvh=4, s=130, d=128, pad=4, causal=False),
        dict(base, s=300, pad=4, window=50),
        # D 80 on the wgmma route: a group of 1, Sq != Skv, non-causal; and its rows only 8-byte aligned
        dict(base, h=4, kvh=4, s=65, d=80), dict(base, s=448, skv=65, d=80), dict(base, s=15, skv=1000, d=80,
                                                                                  causal=False),
        dict(base, h=10, kvh=2, s=130, d=80, causal=False), dict(base, d=80, pad=4),
    ]


def _draw_bhsd(case: dict, gen: torch.Generator):
    """q, k, v and dO of ``case`` on the card as the model lays them out
    (``[b, s, h, d]`` tensors as transposed views; with ``pad``, rows of d +
    pad elements sliced to d)."""
    b, h, kvh, s, d, dt = (case[k] for k in ("b", "h", "kvh", "s", "d", "dtype"))
    skv, pad = case.get("skv", s), case.get("pad", 0)
    draw = lambda n, heads: (torch.randn((b, n, heads, d + pad), generator=gen, device="cuda").to(dt)[..., :d]
                             .transpose(1, 2))
    return draw(s, h), draw(skv, kvh), draw(skv, kvh), draw(s, h)


def check_bf16s_scalars() -> dict:
    """Phase 6b's first check: the bf16-score mode's scalar steps (the
    division by c, the division by l, exp) held on the card to the IEEE ops
    they replace, bit for bit over every input they can take
    (``flash_attention.scalar_check``).  Prints each step's count of inputs
    and of mismatches; fails on one mismatch.  Returns the readings."""
    got = fa.scalar_check()
    for step in got["steps"]:
        print(f"[bf16s] scalar check {step['step']}: {step['inputs']} inputs, {step['mismatches']} mismatches "
              f"({_card()})")
    print(f"[bf16s] scalar check: the fast exp's fp32 value lies at most {got['exp_max_ulp']} units in the last place "
          f"from expf's")
    bad = [step for step in got["steps"] if step["mismatches"]]
    if bad:
        raise RuntimeError(f"the bf16-score mode's scalar steps miss the IEEE ops: {bad}")
    return got


def check_flash_bf16_scores(gen: torch.Generator) -> dict:
    """Phase 6b: the bf16-score forward (``flash_attention(fp32_scores=
    False)``: ``flash_fwd_mma_bf16_scores_kernel`` in bf16,
    ``flash_fwd_bf16_scores_kernel`` in fp32) against
    ``flash_attention_fwd_plain`` in the mode on the same inputs, o and the
    (m, l) stats, beside the fp32-score kernel as the control
    (``_hold_bf16s``), at the served flash calls of BF16S_SERVED and the
    grid of ``_bf16s_cases``.  Returns the ``flash_attention_bf16_scores``
    row, with its forward times at granite-3-2b's shape (kernel, the
    fp32-score kernel and the plain mode by events and device time; no
    PyTorch call computes bf16-rounded scores, so ``library_ms`` is null and
    SDPA's time stands beside it as the fp32-score yardstick), and the
    scalar checks' readings (``check_bf16s_scalars``, run first).  Each
    call prints the route and kernels its backward would take."""
    scalars = check_bf16s_scalars()
    served = [c for c in served_flash_calls() if c["model"].split()[0] in BF16S_SERVED]
    row, max_err = None, 0.0
    for case in _bf16s_cases(served):
        q, k, v, _ = _draw_bhsd(case, gen)
        kw = dict(causal=case["causal"], window=case["window"])
        o, stats = fa.flash_attention(q, k, v, return_lse=True, fp32_scores=False, **kw)
        po, pstats = fa.flash_attention_fwd_plain(q, k, v, fp32_scores=False, **kw)
        ctl = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        route = fa.bwd_route(q, k, v, o, q, fp32_scores=False)  # dO takes q's layout
        desc = {**case, "skv": case.get("skv", case["s"]), "dtype": str(case["dtype"]).removeprefix("torch."),
                "bwd_route": route, "bwd_kernels": fa.bwd_kernels(route, case["d"], False)}
        _hold_bf16s("flash_attention bf16 scores", desc, {"o": (o, po, ctl)}, case["dtype"])
        # m is a bf16 score: a step (2^-7 of it at most) apart where the row's largest score rounds apart;
        # l then moves with it
        m_err, l_err = _max_rel(stats[0], pstats[0]), _rms_rel(stats[1], pstats[1])
        if not (m_err <= 2.0**-7 and l_err <= BF16S_TOL[case["dtype"]]):
            raise RuntimeError(f"flash_attention bf16 scores: (m, l) disagree with plain at {desc}: m {m_err}, "
                               f"l {l_err}")
        max_err = max(max_err, (o.float() - po.float()).abs().max().item())
        if case.get("model") == "granite-3-2b":
            flops, nbytes = fa.cost(q, k, v, case["causal"], case["window"])
            bound_ms, bound_by = _bound(flops, nbytes, PEAK_BF16_FLOPS)
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()

            def kern():
                return fa.flash_attention(q, k, v, fp32_scores=False, **kw)

            def fp32():
                return fa.flash_attention(q, k, v, **kw)

            def plain():
                return fa.flash_attention_plain(q, k, v, fp32_scores=False, **kw)

            def sdpa():
                return F.scaled_dot_product_attention(qc, kc, vc, is_causal=case["causal"], enable_gqa=True)

            row = dict(ms=_time_ms(kern), plain_ms=_time_ms(plain), bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=None, fp32_scores_ms=_time_ms(fp32), sdpa_ms=_time_ms(sdpa))
            row["device_ms"], ran = _device_ms(kern)
            row["fp32_scores_device_ms"], _ = _device_ms(fp32)
            row["plain_device_ms"], _ = _device_ms(plain)
            row["sdpa_device_ms"], _ = _device_ms(sdpa, need=False)
            row["device_functions"] = sorted(m.group(1) for n in ran if (m := FLASH_FN.search(n)))
            if row["device_functions"] != [f"flash_fwd_mma_bf16_scores_kernel<{case['d']}>"]:
                raise RuntimeError(f"the bf16-score forward at granite's shape ran {ran}")
            print(f"[bf16s] flash_attention bf16 scores at granite-3-2b's shape: "
                  f"{json.dumps({**row, 'flops': flops, 'bytes': nbytes})} ({_card()})")
        del q, k, v, o, po, ctl
    torch.cuda.empty_cache()
    return {"name": "flash_attention_bf16_scores", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:64", "max_abs_err": max_err, **row,
            "scalar_check": {step["step"]: [step["inputs"], step["mismatches"]] for step in scalars["steps"]}}


def check_flash_bwd_bf16_scores(gen: torch.Generator) -> dict:
    """Phase 11b: the bf16-score backward (``flash_attention_bwd(fp32_scores=
    False)``) from the kernel's own o and (m, l) against
    ``flash_attention_bwd_plain`` in the mode from plain's, dq, dk and dv,
    beside the fp32-score plain backward as the control (``_hold_bf16s``),
    on BF16S_TRAINED's training shapes and ``_bf16s_cases``' grid; prints
    each call's route and kernels (``flash_attention.bwd_route`` /
    ``bwd_kernels``); fails unless the route is the fp32 mode's (``wgmma``
    at granite-3-2b's, phi3.5-moe's and zamba2-2.7b's training shapes,
    ``mma`` on rows only 8-byte aligned), unless two calls give the same
    bits, and unless the
    profiled training shapes and rows only 8-byte aligned ran exactly
    ``flash_attention.bwd_kernels`` of the mode.  Times the training shapes
    forward and backward: the mode's kernels, the fp32-score kernels and
    the plain mode, by events and device time.  Returns the row's backward
    keys (granite-3-2b's, the others under keys that name them)."""
    trained = [dict(b=TRAIN_BATCH, h=c.n_heads, kvh=c.n_kv_heads, s=TRAIN_SEQ, d=c.hd, dtype=torch.bfloat16,
                    causal=True, window=0, model=arch) for arch in BF16S_TRAINED for c in [get_config(arch)]]
    out, max_err = {}, 0.0
    for case in _bf16s_cases(trained):
        q, k, v, do = _draw_bhsd(case, gen)
        dt, d = case["dtype"], case["d"]
        kw = dict(causal=case["causal"], window=case["window"])
        o, stats = fa.flash_attention(q, k, v, return_lse=True, fp32_scores=False, **kw)
        po, pstats = fa.flash_attention_fwd_plain(q, k, v, fp32_scores=False, **kw)
        route = fa.bwd_route(q, k, v, o, do, fp32_scores=False)
        wgmma = "model" in case  # granite-3-2b, phi3.5-moe and zamba2-2.7b (D 80) on the wgmma route
        if route != fa.bwd_route(q, k, v, o, do) or wgmma and route != "wgmma" or "pad" in case and route != "mma":
            raise RuntimeError(f"the bf16-score backward took the {route} route at {case}")
        got = fa.flash_attention_bwd(q, k, v, o, stats, do, fp32_scores=False, **kw)
        again = fa.flash_attention_bwd(q, k, v, o, stats, do, fp32_scores=False, **kw)
        plain = fa.flash_attention_bwd_plain(q, k, v, po, pstats, do, fp32_scores=False, **kw)
        o32, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
        ctl = fa.flash_attention_bwd_plain(q, k, v, o32, lse, do, **kw)
        torch.cuda.synchronize()
        desc = {**case, "skv": case.get("skv", case["s"]), "dtype": str(dt).removeprefix("torch."), "route": route,
                "kernels": fa.bwd_kernels(route, d, False)}
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise RuntimeError(f"the bf16-score backward: two calls differ at {desc}")
        _hold_bf16s("flash_attention_bwd bf16 scores", desc,
                    {n: (g, w, c) for n, g, w, c in zip(("dq", "dk", "dv"), got, plain, ctl)}, dt)
        max_err = max(max_err, max((g.float() - w.float()).abs().max().item() for g, w in zip(got, plain)))
        if "pad" in case:  # the mma.sync kernels, which no other case of the grid reaches at D 64 and 128
            _, ran = _device_ms(lambda: fa.flash_attention_bwd(q, k, v, o, stats, do, fp32_scores=False, **kw))
            ran = {m.group(1): n for name, n in ran.items() if (m := FLASH_FN.search(name))}
            want = fa.bwd_kernels("mma", d, False)
            print(f"[bf16s] flash_attention_bwd bf16 scores on rows only 8-byte aligned ran {ran}")
            if ran != dict.fromkeys(want, 1):
                raise RuntimeError(f"the bf16-score backward at {desc} ran {ran}, want each of {want} once")
        if "model" in case:
            flops, nbytes = fa.bwd_cost(q, k, case["causal"], case["window"])
            bound_ms, bound_by = _bound(flops, nbytes, PEAK_BF16_FLOPS)
            o2, lse2 = fa.flash_attention(q, k, v, return_lse=True, **kw)

            def kern():
                return fa.flash_attention_bwd(q, k, v, o, stats, do, fp32_scores=False, **kw)

            def fp32():
                return fa.flash_attention_bwd(q, k, v, o2, lse2, do, **kw)

            def plain_bwd():
                return fa.flash_attention_bwd_plain(q, k, v, po, pstats, do, fp32_scores=False, **kw)

            def fwd(fp32_scores):
                return lambda: fa.flash_attention(q, k, v, fp32_scores=fp32_scores, **kw)

            timed = dict(bwd_ms=_time_ms(kern), bwd_plain_ms=_time_ms(plain_bwd), bwd_bound_ms=bound_ms,
                         bwd_bound_by=bound_by, bwd_library_ms=None, bwd_fp32_scores_ms=_time_ms(fp32))
            timed["bwd_device_ms"], ran = _device_ms(kern)
            timed["bwd_fp32_scores_device_ms"], _ = _device_ms(fp32)
            timed["bwd_device_functions"] = sorted(m.group(1) for n in ran if (m := FLASH_FN.search(n)))
            want = fa.bwd_kernels(route, d, fp32_scores=False)
            if timed["bwd_device_functions"] != sorted(want) or sum(ran.values()) != len(want):
                raise RuntimeError(f"the bf16-score backward at {case['model']}'s shape ran {ran}, want {want}")
            fwds = dict(fwd_ms=_time_ms(fwd(False)), fwd_fp32_scores_ms=_time_ms(fwd(True)),
                        fwd_device_ms=_device_ms(fwd(False))[0], fwd_fp32_scores_device_ms=_device_ms(fwd(True))[0])
            print(f"[bf16s] flash_attention bf16 scores at {case['model']}'s training shape: "
                  f"{json.dumps({**timed, **fwds, 'flops': flops, 'bytes': nbytes})} ({_card()})")
            prefix = "" if not out else f"{case['model']} "  # granite's forward is phase 6b's row
            out.update({prefix + key: val for key, val in {**timed, **(fwds if prefix else {})}.items()})
        del q, k, v, do, o, po, got, again, plain, ctl
    torch.cuda.empty_cache()
    out["bwd_max_abs_err"] = max_err
    return out


def _mode_counts() -> dict[str, int]:
    return {"flash_attention_bf16_scores": fa.bf16_scores_launches,
            "flash_attention_bf16_scores_bwd": fa.bf16_scores_bwd_launches,
            "flash_attention": fa.launches, "flash_attention_bwd": fa.bwd_launches}


def _zero_mode_counts() -> None:
    fa.bf16_scores_launches = fa.bf16_scores_bwd_launches = fa.launches = fa.bwd_launches = 0


def drive_bf16_scores(failures: list[str]) -> dict:
    """Phase 16: the main paths with ``attn_fp32_scores=False``, each with
    the counts set to 0 just before and read just after.  (a) granite-3-2b
    trained (``launch.train.train``, bf16, full size, BF16S_TRAIN_STEPS
    steps): fails unless it launched the mode's forward and backward as the
    code runs them (``_train_launches``) and the fp32-score kernels never;
    then the loss and every leaf's gradient at the trained depth, kernel
    path against plain path (``train_readings``): in bf16 held to
    TRAIN_LOSS_TOL / TRAIN_GRAD_TOL with BF16S_TRAIN_CONTROLS (the
    fp32-score function) printed; with the model in fp32 held to
    BF16S_TRAIN_TOL, where the control must miss both limits.  (b) whisper-small served (``launch.serve.serve``, bf16,
    full size, batch 4, prompt 448 of 1500 frames): fails unless its prefill
    launched the mode's forward once per attention call (its 12 encoder
    layers, self and cross attention in its 12 decoder layers) and the
    fp32-score forward never (decode scores in torch ops, as the
    reference's: none); then prefill and LM_FORCED teacher-forced decode
    steps, kernel path against plain path in bf16 and fp32 (``_forced_logits``),
    held to BF16S_LM_TOL, the fp32-score model printed beside.  Between
    them zamba2-2.7b trained BF16S_TRAIN_STEPS steps with the knob off
    (its shared block at D 80 on the wgmma route, phase 11b): finite
    losses and the mode's launches as the code runs them, the fp32-score
    kernels never.  Returns the launches of the three runs."""
    out = {}
    arch = "granite-3-2b"
    cfg = dataclasses.replace(get_config(arch), attn_fp32_scores=False)
    _zero_mode_counts()
    res = train(cfg, steps=BF16S_TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=0, seed=0, device="cuda")
    torch.cuda.synchronize()
    counts = _mode_counts()
    want = _train_launches(cfg, BF16S_TRAIN_STEPS)
    want = {"flash_attention_bf16_scores": want["flash_attention"], "flash_attention_bf16_scores_bwd":
            want["flash_attention_bwd"], "flash_attention": 0, "flash_attention_bwd": 0}
    print(f"[bf16s] {arch} trained with attn_fp32_scores=False: losses {res['losses']}, launches {counts} "
          f"({_card()})")
    if counts != want or not all(math.isfinite(x) for x in res["losses"]):
        raise RuntimeError(f"{arch} with bf16 scores: launches {counts} (want {want}), losses {res['losses']}")
    out[f"{arch} train"] = counts
    params = res["state"]["params"]
    del res
    torch.cuda.empty_cache()
    batch = next(make_batch_iterator(cfg, DataConfig(batch=TRAIN_BATCH, seq=TRAIN_SEQ, vocab=cfg.vocab, seed=0),
                                     start_step=BF16S_TRAIN_STEPS, device="cuda"))
    # in bf16 the kernel path is held as phase 13 holds it; the control is printed (BF16S_TRAIN_TOL)
    name = f"{arch} bf16 at {cfg.n_layers} layers, attn_fp32_scores=False"
    readings = train_readings(cfg, params, batch, BF16S_TRAIN_CONTROLS)
    hold_train_readings(name, {"kernel": readings["kernel"]}, failures, loss_controls=())
    r = readings["fp32 scores"]
    print(f"[bf16s] {name}, the fp32-score control against the plain path (printed): loss relative "
          f"{r['loss']:.3e}, worst leaf {max(r['leaves'].values()):.3e}")
    # the model in fp32 at the trained depth, the control held
    c, p = dataclasses.replace(cfg, dtype=torch.float32), _cast(params, torch.float32)
    hold_train_readings(f"{arch} fp32 at {cfg.n_layers} layers, attn_fp32_scores=False",
                        train_readings(c, p, batch, BF16S_TRAIN_CONTROLS), failures, BF16S_TRAIN_TOL,
                        loss_controls=("fp32 scores",))
    del params, p, batch
    torch.cuda.empty_cache()

    # zamba2-2.7b's shared block (D 80, the wgmma route) trained in the mode: its launches as the code runs them
    arch = "zamba2-2.7b"
    cfg = dataclasses.replace(get_config(arch), attn_fp32_scores=False)
    _zero_mode_counts()
    res = train(cfg, steps=BF16S_TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=0, seed=0, device="cuda")
    torch.cuda.synchronize()
    counts = _mode_counts()
    want = _train_launches(cfg, BF16S_TRAIN_STEPS)
    want = {"flash_attention_bf16_scores": want["flash_attention"], "flash_attention_bf16_scores_bwd":
            want["flash_attention_bwd"], "flash_attention": 0, "flash_attention_bwd": 0}
    print(f"[bf16s] {arch} trained with attn_fp32_scores=False: losses {res['losses']}, launches {counts} "
          f"({_card()})")
    if counts != want or not all(math.isfinite(x) for x in res["losses"]):
        raise RuntimeError(f"{arch} with bf16 scores: launches {counts} (want {want}), losses {res['losses']}")
    out[f"{arch} train"] = counts
    del res
    torch.cuda.empty_cache()

    arch = "whisper-small"
    cfg = dataclasses.replace(get_config(arch), attn_fp32_scores=False)
    _zero_mode_counts()
    res = serve(cfg, batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN, seed=0, device="cuda")
    torch.cuda.synchronize()
    counts = _mode_counts()
    attn = cfg.enc_layers + 2 * cfg.n_layers
    print(f"[bf16s] {arch} served with attn_fp32_scores=False: prefill_s {res['prefill_s']:.6f}, decode_tok_per_s "
          f"{res['decode_tok_per_s']:.3f}, launches {counts} ({_card()})")
    if counts != {"flash_attention_bf16_scores": attn, "flash_attention_bf16_scores_bwd": 0, "flash_attention": 0,
                  "flash_attention_bwd": 0}:
        raise RuntimeError(f"{arch} with bf16 scores launched {counts}, want the mode's forward {attn} times")
    out[f"{arch} serve"] = counts
    prompt = make_batch(cfg, LM_BATCH, LM_PROMPT, 0, "cuda")
    forced = res["tokens"][:, :LM_FORCED]
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    for dt in (torch.bfloat16, torch.float32):
        c, p = dataclasses.replace(cfg, dtype=dt), _cast(params, dt)
        got = _forced_logits(c, p, prompt, forced)
        with _plain_versions():
            want = _forced_logits(c, p, prompt, forced)
            ctl = _forced_logits(dataclasses.replace(c, attn_fp32_scores=True), p, prompt, forced)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err, ctl_err = (got - want).abs().max().item() / scale, (ctl - want).abs().max().item() / scale
        name = f"{arch} {str(dt).removeprefix('torch.')} with attn_fp32_scores=False"
        print(f"[bf16s] {name}: logits kernel vs plain relative {err:.3e} (tolerance {BF16S_LM_TOL[dt]}), "
              f"the fp32-score model {ctl_err:.3e} (printed)")
        if not (torch.isfinite(got).all() and err <= BF16S_LM_TOL[dt]):
            failures.append(f"{name}: kernel path against plain path {err} > {BF16S_LM_TOL[dt]}")
            print(f"[FAIL] {failures[-1]}")
        del p, got, want, ctl
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 14: the mesh paths (launch/mesh.py), one NCCL rank, then two gloo ranks sharing the card
# ---------------------------------------------------------------------------

#: the mesh phase's models, full width, at MESH_DEPTH layers, bf16: MoE prefill (tensor parallel over
#: ``model``) and a train step (the batch split over ``data``)
MESH_MOE, MESH_TRAIN, MESH_DEPTH = "phi3.5-moe-42b", "granite-3-2b", 2
#: ranks of phase (b), each its own process on cuda:0 over gloo, and each one's time limit, seconds
MESH_RANKS, MESH_RANK_TIMEOUT = 2, 300
#: phase (b)'s training batch: rank 0's half has MESH_MASKED labels masked in each row, rank 1's none, so
#: the two count different tokens
MESH_MASKED = 300
#: phase (b)'s training check, the mesh step's loss and gradient against the one-process step's: the loss's
#: relative difference, and each leaf's max |difference| over max |one process|.  Read on an NVIDIA H100 80GB
#: HBM3 at 700 W (PERF.md): the mesh path 1.7e-7 in the loss and 3.2e-3 to 1.15e-2 over the leaves (bf16
#: leaves, the two halves' gradients summed: about 3 roundings at the worst, the embedding); the mean of the
#: ranks' own means 9.0e-4 in the loss and 0.37 to 0.61 over the leaves; the gradients left unreduced 0.48 to
#: 1.03 over the leaves
MESH_LOSS_TOL, MESH_GRAD_TOL = 1e-5, 3e-2


def _mesh_prompt(cfg, seed: int) -> dict:
    return make_batch(cfg, LM_BATCH, LM_PROMPT, seed=seed, device="cuda")


def _mesh_train_batch(cfg) -> dict:
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ), generator=g, device="cuda")
    labels = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ), generator=g, device="cuda")
    labels[: TRAIN_BATCH // MESH_RANKS, :MESH_MASKED] = -1
    return {"tokens": tokens, "labels": labels}


def _mesh_grads(seed: int, device: str) -> tuple[dict, dict]:
    """One rank's gradients and carried error for ``compressed_psum``, from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    grads = {"a": torch.randn((1024, 1024), generator=g, device="cuda"),
             "b": torch.randn((4099,), generator=g, device="cuda") * (1 + seed % 3)}
    err = {k: torch.randn(v.shape, generator=g, device="cuda") * 0.01 for k, v in grads.items()}
    return {k: v.to(device) for k, v in grads.items()}, {k: v.to(device) for k, v in err.items()}


def _psum_formula(seeds: list[int]) -> tuple[dict, list[dict]]:
    """``compressed_psum``'s sum and each rank's residual, from its formula in fp32 on the host."""
    both = [_mesh_grads(s, "cpu") for s in seeds]
    out, res = {}, [{} for _ in seeds]
    for k in both[0][0]:
        g32 = [g[k] + e[k] for g, e in both]
        scale = torch.clamp(max(x.abs().max() for x in g32), min=1e-12) / 127.0
        q = [torch.clamp(torch.round(x / scale), -127, 127) for x in g32]
        out[k] = sum(q) * scale / len(seeds)
        for r, (x, qr) in enumerate(zip(g32, q)):
            res[r][k] = x - qr * scale
    return out, res


def _trees_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(named_leaves(a), named_leaves(b), strict=True))


def mesh_one_rank(failures: list[str]) -> dict:
    """Phase 14 (a): one rank over NCCL, a (1, 1) mesh.  Every collective is
    a copy, so the mesh paths must give the bits of the paths without a
    mesh: phi3.5-moe's prefill (logits and cache), a granite-3-2b train step
    (loss, gradient norm, every parameter after it), and ``compressed_psum``
    against its formula run on the card.  Returns the launches."""
    from repro_torch.launch.mesh import join_group, make_test_mesh
    from repro_torch.optim import compressed_psum, dequantize, quantize_int8

    print(f"[mesh] (a) NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, one rank, a (1, 1) mesh")
    launches = {}
    with tempfile.TemporaryDirectory() as d:
        join_group(1, 0, store=torch.distributed.FileStore(str(Path(d) / "store"), 1), device="cuda")
        try:
            mesh = make_test_mesh((1, 1), device="cuda")
            cfg = dataclasses.replace(get_config(MESH_MOE), n_layers=MESH_DEPTH)
            params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
            prompt = _mesh_prompt(cfg, 0)
            gm.launches = 0
            lm, cm = transformer.prefill_step(cfg, params, prompt, mesh, max_len=LM_PROMPT + LM_GEN)
            torch.cuda.synchronize()
            launches["gemm"] = gm.launches
            l1, c1 = transformer.prefill_step(cfg, params, prompt, max_len=LM_PROMPT + LM_GEN)
            same = torch.equal(lm, l1) and all(torch.equal(cm[k], c1[k]) for k in c1 if k != "index")
            print(f"[mesh] (a) {MESH_MOE} at {MESH_DEPTH} layers, bf16, prefill {LM_BATCH} x {LM_PROMPT}: mesh == "
                  f"no mesh, logits and cache: {same}; gemm launches {launches['gemm']}")
            if not same:
                failures.append(f"(a) {MESH_MOE} prefill over a (1, 1) mesh differs from no mesh: "
                                f"{(lm.float() - l1.float()).abs().max().item()}")
            del params, lm, cm, l1, c1
            torch.cuda.empty_cache()

            cfg = dataclasses.replace(get_config(MESH_TRAIN), n_layers=MESH_DEPTH)
            params = init_params(cfg, torch.Generator(device="cuda").manual_seed(2), "cuda")
            batch = _mesh_train_batch(cfg)
            opt = AdamW(AdamWConfig(total_steps=10, warmup=2))
            runs = []
            fa.launches = 0
            for m in (mesh, None):  # the step updates the parameters in place: each run starts from a copy
                p = tree_map(torch.clone, params)
                p1, _, met = transformer.make_train_step(cfg, opt, m)(p, opt.init(p), batch)
                runs.append((p1, met))
                if m is not None:
                    torch.cuda.synchronize()
                    launches["flash_attention"] = fa.launches
            (pa, ma), (pb, mb) = runs
            same = torch.equal(ma["loss"], mb["loss"]) and torch.equal(ma["grad_norm"], mb["grad_norm"]) \
                and _trees_equal(pa, pb)
            print(f"[mesh] (a) {MESH_TRAIN} at {MESH_DEPTH} layers, bf16, a train step on {TRAIN_BATCH} x {TRAIN_SEQ}: "
                  f"loss {ma['loss'].item():.6f}, grad_norm {ma['grad_norm'].item():.6f}; mesh == no mesh, loss, "
                  f"grad_norm and every parameter: {same}; flash launches {launches['flash_attention']}")
            if not same:
                failures.append(f"(a) {MESH_TRAIN} train step over a (1, 1) mesh differs from no mesh")
            del params, runs, pa, pb
            torch.cuda.empty_cache()

            grads, err = _mesh_grads(10, "cuda")
            out, res = compressed_psum(grads, error=err)
            same = True
            for k, g in grads.items():
                g32 = g + err[k]
                scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
                q = quantize_int8(g32, scale)
                same &= torch.equal(out[k], dequantize(q.to(torch.int32), scale) / 1) \
                    and torch.equal(res[k], g32 - dequantize(q, scale))
            print(f"[mesh] (a) compressed_psum over one rank, CUDA tensors: == its formula on the card: {same}")
            if not same:
                failures.append("(a) compressed_psum over one rank differs from its formula")
        finally:
            torch.distributed.destroy_process_group()
    return launches


def mesh_rank(rank: int, store: str, out_path: str) -> int:
    """Phase 14 (b), one rank: its own process on cuda:0, joined over gloo
    to the others (NCCL refuses two ranks on one card).  Writes its readings
    and failures to ``out_path`` as JSON; exits 0 once written."""
    from repro_torch.collectives import all_reduce_over, gather_whole
    from repro_torch.launch.mesh import batch_shard, join_group, make_test_mesh
    from repro_torch.models.layout import param_layout
    from repro_torch.sharding import local_shard
    from repro_torch.optim import compressed_psum

    def say(msg: str) -> None:
        print(f"[mesh] (b) rank {rank}: {msg}", flush=True)

    out: dict = {"failures": [], "launches": {}}
    fail = out["failures"].append
    join_group(MESH_RANKS, rank, store=torch.distributed.FileStore(store, MESH_RANKS), device="cuda", backend="gloo")
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # the pipeline: full-width SynthNet in a 2-stage split, stage s on rank s
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = make_cnn("synthnet", scale=1.0, device="cuda").init(gen)
        conf = generate_seed(weights(network_layers("synthnet")), paper_platform(MESH_RANKS), n_stages=MESH_RANKS).conf
        micro = torch.randn((N_MICRO, BATCH, 220, 220, 3), generator=gen, device="cuda")
        runner = PipelineRunner(mesh=make_stage_mesh(conf.depth, "cuda", ranks=True), conf=conf,
                                apply_layer=model.apply_layer, n_micro=N_MICRO)
        im2col_conv.launches = 0
        got = runner.run(micro)
        torch.cuda.synchronize()
        out["launches"]["conv2d_im2col"] = im2col_conv.launches
        seq = torch.stack([model(x) for x in micro])
        same = torch.equal(got, seq)
        tp = pipeline_throughput(runner, micro)
        out["pipeline_micro_per_s"] = tp
        say(f"SynthNet split {conf.pretty()}, {N_MICRO} microbatches of {BATCH}, stage {rank} here: output == the "
            f"sequential model on the same kernels: {same}; conv launches {out['launches']['conv2d_im2col']}; {tp:.1f} micro/s "
            f"(host clock, two processes on one card)")
        if not same:
            fail(f"rank {rank}: the 2-rank pipeline differs from the sequential model: "
                 f"{(got - seq).abs().max().item()}")
        del model, micro, runner, got, seq
        torch.cuda.empty_cache()

        # MoE on a (1, 2) mesh: each rank computes its half of d_ff
        mesh = make_test_mesh((1, MESH_RANKS), device="cuda")
        cfg = dataclasses.replace(get_config(MESH_MOE), n_layers=MESH_DEPTH)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        blocks_of = local_shard(mesh, params, param_layout(cfg, mesh))  # the rank's blocks
        prompt = _mesh_prompt(cfg, 0)

        def prefill(m):
            return transformer.prefill_step(cfg, params if m is None else blocks_of, prompt, m,
                                            max_len=LM_PROMPT + LM_GEN)[0]

        routes: list = []
        gm.launches = gm.copies = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _recording_routes(routes):
            logits = prefill(mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["launches"]["gemm"], copies = gm.launches, gm.copies
        with _replaying_routes(routes):
            want = prefill(None)
        rel = ((logits.float() - want.float()).abs().max() / want.float().abs().max()).item()
        out["moe_rel"] = rel
        E, dm, f = cfg.n_experts, cfg.d_model, cfg.d_ff // MESH_RANKS
        cap = blocks.moe_capacity(cfg, LM_BATCH * LM_PROMPT)
        half = blocks_of["blocks"]["we_gate"][0]
        fwd = gm.KERNELS[gm.route(cfg.dtype, cap, dm, f, gm._aligned(half), *gm.majors(half, half))[0]]
        say(f"{MESH_MOE} at {MESH_DEPTH} layers, bf16, prefill {LM_BATCH} x {LM_PROMPT} on a (1, {MESH_RANKS}) "
            f"mesh, d_ff {cfg.d_ff} -> {f} a rank: logits against the one-process kernel path on the same routes "
            f"{rel:.3e} of max |logit| (tolerance {LM_TOL[torch.bfloat16]}); gemm launches {out['launches']['gemm']}, copies "
            f"{copies}; the gate product's route [{E}, {cap}, {dm}] x [{E}, {dm}, {f}] (rows {half.stride(-2)} "
            f"elements apart): {fwd}; wall {wall:.3f} s (host clock, two processes on one card)")
        if not rel <= LM_TOL[torch.bfloat16]:
            fail(f"rank {rank}: MoE prefill over (1, {MESH_RANKS}) against one process: {rel}")
        if copies or out["launches"]["gemm"] != 3 * MESH_DEPTH or "wgmma" not in fwd:
            fail(f"rank {rank}: MoE prefill ran gemm {out['launches']['gemm']} times with {copies} copies on {fwd}")
        from torch.profiler import ProfilerActivity, profile

        for _ in range(PROFILER_WINDOWS):  # a window may keep fewer device records than the wrappers launched
            before = gm.launches
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                prefill(mesh)
                torch.cuda.synchronize()
            wg = sum(e.count for e in prof.key_averages() if "gemm_wgmma_bf16_kernel" in e.key)
            other = {e.key[:80]: e.count for e in prof.key_averages() if "gemm_" in e.key
                     and "gemm_wgmma_bf16_kernel" not in e.key and "(anonymous namespace)" in e.key}
            if wg == gm.launches - before:
                break
        say(f"profiled prefill: gemm_wgmma_bf16_kernel {wg} times ({3 * MESH_DEPTH} wanted), other gemm kernels "
            f"{other}, copies {gm.copies}")
        if wg != 3 * MESH_DEPTH or other or gm.copies:
            fail(f"rank {rank}: the profiled MoE prefill ran gemm_wgmma_bf16_kernel {wg} times, {other}, "
                 f"{gm.copies} copies")
        del params, blocks_of, logits, want, routes
        torch.cuda.empty_cache()

        # training on a (2, 1) mesh: the batch split 2 / 2
        mesh = make_test_mesh((MESH_RANKS, 1), device="cuda")
        cfg = dataclasses.replace(get_config(MESH_TRAIN), n_layers=MESH_DEPTH)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(2), "cuda")
        batch = _mesh_train_batch(cfg)
        loss, grads = transformer.value_and_grad(cfg, params, batch)
        want, plain = loss.item(), list(named_leaves(grads))
        del grads

        def reading(got: float, grads: dict) -> dict:
            return {"loss": abs(got - want) / abs(want), "leaves": _leaf_ratios(grads, plain)}

        specs = param_layout(cfg, mesh)
        mine, rows = local_shard(mesh, params, specs), batch_shard(mesh, batch)
        fa.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = transformer.value_and_grad(cfg, mine, rows, mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["launches"]["flash_attention"] = fa.launches
        readings = {"mesh": reading(loss.item(), gather_whole(mesh, grads, specs))}
        del grads
        # control: the mean of the ranks' own means (each over its own tokens), the gradients averaged alike
        loss, grads = transformer.value_and_grad(cfg, params, batch_shard(mesh, batch))
        readings["mean of per-rank means"] = reading(
            (all_reduce_over(loss, mesh, ("data",)) / MESH_RANKS).item(),
            tree_map(lambda g: all_reduce_over(g, mesh, ("data",)) / MESH_RANKS, grads))
        del grads
        # control: each rank's gradient of its own rows, left unsummed over the data ranks (no batch axes)
        loss, grads = transformer.value_and_grad(cfg, mine, rows, mesh, dp_axes=())
        readings["gradients unreduced"] = reading(loss.item(), gather_whole(mesh, grads, specs))
        del grads
        out["train_readings"] = readings
        for path, r in readings.items():
            leaf = max(r["leaves"], key=r["leaves"].get)
            say(f"{MESH_TRAIN} at {MESH_DEPTH} layers, bf16, {TRAIN_BATCH} x {TRAIN_SEQ} split {MESH_RANKS} ways "
                f"({MESH_MASKED} labels masked in each of rank 0's rows), {path} against one process: loss "
                f"relative {r['loss']:.3e} (tolerance {MESH_LOSS_TOL}); worst leaf {leaf} at {r['leaves'][leaf]:.3e} "
                f"(tolerance {MESH_GRAD_TOL}); every leaf {json.dumps(r['leaves'])}")
        mesh_r = readings["mesh"]
        if not (mesh_r["loss"] <= MESH_LOSS_TOL and max(mesh_r["leaves"].values()) <= MESH_GRAD_TOL):
            fail(f"rank {rank}: the mesh train step against one process: {mesh_r['loss']}, "
                 f"{max(mesh_r['leaves'].values())}")
        for path in readings.keys() - {"mesh"}:
            if not max(readings[path]["leaves"].values()) > MESH_GRAD_TOL:
                fail(f"rank {rank}: the control '{path}' meets the gradient tolerance at every leaf")
        if not readings["mean of per-rank means"]["loss"] > MESH_LOSS_TOL:
            fail(f"rank {rank}: the control 'mean of per-rank means' meets the loss tolerance")
        opt = AdamW(AdamWConfig(total_steps=10, warmup=2))
        step = transformer.make_train_step(cfg, opt, mesh)
        state = opt.init(mine)
        step(mine, state, rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, met = step(mine, state, rows)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        sums = torch.stack([t.float().sum() for t in tree_leaves(gather_whole(mesh, mine, specs))])
        agree = torch.equal(all_reduce_over(sums, mesh, ("data",), torch.distributed.ReduceOp.MAX), sums)
        out["train_step_s"] = step_s
        say(f"value_and_grad over the mesh {wall:.3f} s; a warm make_train_step {step_s:.3f} s, "
            f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s, loss {met['loss'].item():.5f} (host clock, two "
            f"processes on one card); the ranks' gathered parameters agree after it: {agree}; flash launches "
            f"{out['launches']['flash_attention']} (value_and_grad over the mesh)")
        if not (agree and math.isfinite(met["loss"].item())):
            fail(f"rank {rank}: after a mesh train step the ranks' parameters agree: {agree}, loss {met['loss']}")
        del params, mine, state, batch, rows
        torch.cuda.empty_cache()

        # compressed_psum over the two ranks against its formula in fp32 on the host
        grads, err = _mesh_grads(10 + rank, "cuda")
        got, res = compressed_psum(grads, error=err)
        want_out, want_res = _psum_formula([10 + r for r in range(MESH_RANKS)])
        diff = max(max((got[k].cpu() - want_out[k]).abs().max().item(), (res[k].cpu() - want_res[rank][k]).abs().max().item())
                   for k in grads)
        out["psum_err"] = diff
        say(f"compressed_psum over {MESH_RANKS} ranks, {sum(g.numel() for g in grads.values())} elements: max "
            f"|difference| from the fp32 host formula, sum and residual, {diff:.3e}")
        if not diff <= 1e-6:
            fail(f"rank {rank}: compressed_psum differs from its formula by {diff}")
    finally:
        Path(out_path).write_text(json.dumps(out))
        torch.distributed.destroy_process_group()
    return 0


def mesh_two_ranks(failures: list[str]) -> dict:
    """Phase 14 (b): MESH_RANKS processes of ``mesh_rank`` sharing cuda:0
    over gloo; prints their lines, adds their failures.  Returns the
    launches, summed over the ranks."""
    with tempfile.TemporaryDirectory() as d:
        outs = [Path(d) / f"rank{r}.json" for r in range(MESH_RANKS)]
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mesh-rank", str(r),
                                   str(Path(d) / "store"), str(outs[r])], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(MESH_RANKS)]
        try:
            logs = [p.communicate(timeout=MESH_RANK_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            print(log, end="")
            if p.returncode != 0 or not outs[r].exists():
                failures.append(f"(b) rank {r} exited {p.returncode}")
                print(f"[FAIL] {failures[-1]}")
        results = [json.loads(o.read_text()) for o in outs if o.exists()]
    launches: dict[str, int] = {}
    for res in results:
        for f in res["failures"]:
            failures.append(f"(b) {f}")
            print(f"[FAIL] {failures[-1]}")
        for k, n in res["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return launches


# ---------------------------------------------------------------------------
# Phase 15: the sharded layout (models/layout.py, sharding.py, collectives.py) and the dry run on the card
# ---------------------------------------------------------------------------

#: ranks of phase 15 (b), each its own process on cuda:0 over gloo, and the meshes it runs
SHARD_RANKS, SHARD_MESHES = 2, ((1, 2), (2, 1))
#: phase (b)'s limit on granite's loss over a mesh that splits the model, (1, 2), against one process
#: (MESH_LOSS_TOL holds on (2, 1)): there the bf16 loss moves with the weights.  scripts/mesh_loss_spread.py
#: (NVIDIA H100 80GB HBM3, 700 W; PERF.md) reads 3.4e-7 to 6.3e-5 over weight seeds 2-6 in bf16 and 0.0 at
#: each in fp32 (rounding, not another loss), so the limit is about three times the worst bf16 reading; the
#: control with the tensor-parallel sums dropped reads 2.7e-3 at seed 2, its weights here
SPLIT_LOSS_TOL = 2e-4
#: decode steps phase 15 holds after each prefill
SHARD_DECODE = 3
#: phase 15 (b)'s hybrid model on the (1, 2) mesh, at one group of SSD layers and its shared attention block: each
#: rank projects and scans its 40 of the 80 SSD heads (models/layout.py's Layout.ssd) on the tensor-core scan kernel,
#: served in bf16 (printed) and served and trained a step with the model in fp32 and its scans in bf16 (held)
SHARD_HYBRID, SHARD_HYBRID_DEPTH = "zamba2-2.7b", 6
#: phase 15 (b)'s SSD model on the (1, 2) mesh, at full width and depth: 12 of its 24 heads a rank, served and
#: trained a step with the model in fp32 and its scans in bf16 (held)
SHARD_SSD = "mamba2-130m"
#: the held train steps against one process hold the loss's relative difference to SSD_TRAIN_LOSS_TOL and each
#: leaf's max |difference| over max |one process| to SSD_TRAIN_GRAD_TOL, the SSD checks' limits on the kernel path
#: against the plain one: the same kind of comparison, the scans' bf16 roundings carried through the model.  Read on
#: an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): mamba2-130m 1.2e-6 in the loss and 6.5e-2 at the worst leaf
#: (dt_bias), zamba2-2.7b at 6 layers 8.1e-6 and 1.4e-2 (out_proj); the control, the gated norm's mean square summed
#: forward only (collectives.sum_tp in place of psum_tp), 0.93 and 0.68.  Their served logits read 1.9e-2-2.5e-2
#: and 1.4e-3-3.3e-3.  In bf16 mamba2's step read 2.1e-4 and 0.43 against the control's 1.21, its logits 0.13-0.22 of
#: max |logit|, and zamba2's logits 0.025-0.039: a bf16 SSD model moves that much with the last bit of any scan
#: (SSD_LAYERS), so zamba2's are printed and mamba2's not taken
#: each phase 15 (b) rank's time limit, seconds
SHARD_RANK_TIMEOUT = 480
#: phase 15 (c)'s cells, run as rank 0 of a 256-rank fake group on the card
SHARD_DRYRUN = (("qwen3-32b", "train_4k"), ("nemotron-4-340b", "decode_32k"), ("zamba2-2.7b", "train_4k"))
#: qwen3-32b x train_4k's step peak (GiB, max_memory_allocated) as rank 0 of 256 with the residual stream whole
#: on every model rank (sp_residuals off), two runs on an NVIDIA H100 80GB HBM3 at 700 W: phase 15 (c) prints the
#: split stream's beside it
SHARD_WHOLE_STREAM_PEAK_GIB = (15.380, 15.484)
#: the caching allocator's block: a tensor's memory_allocated is its bytes rounded up to it
ALLOC_ROUND = 512


def _launch_counts() -> dict:
    return {"flash_attention": fa.launches, "gemm": gm.launches, "ssd_scan": ssd.launches}


@contextlib.contextmanager
def _recording_remat(out: list):
    """Append the bytes of each floating tensor ``transformer._remat`` keeps
    for the backward (its storage's, so a view of a larger tensor counts
    whole): a saved-tensors hook around the layer sees only what
    ``torch.utils.checkpoint`` saves, its own hook taking the layer's saves
    (newer versions also save an empty marker, left out)."""
    remat = transformer._remat

    def pack(t):
        if t.is_floating_point() and t.numel():  # not the checkpoint's own empty marker
            out.append(t.untyped_storage().nbytes())
        return t

    def recording(cfg, fn, *args):
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            return remat(cfg, fn, *args)

    with mock.patch.object(transformer, "_remat", recording):
        yield


@contextlib.contextmanager
def _recording_scans(fwd: list, bwd: list | None = None):
    """Append (x's shape, the route its plan takes, by ``ssd_scan.KERNELS``'
    name) of each ``ops.ssd_scan`` call on the card to ``fwd``, and (x's shape, the
    backward's route, its kernels) of each ``ssd_scan.ssd_scan_bwd`` call to
    ``bwd``."""
    scan, scan_bwd = ops.ssd_scan, ssd.ssd_scan_bwd

    def recording(x, dt, A, B, C, *, chunk=64):
        if x.is_cuda:
            fwd.append((list(x.shape),
                        ssd.KERNELS[ssd.route(x.dtype, x.shape[3], B.shape[-1], chunk, *ssd.alignment(x, B, C))]))
        return scan(x, dt, A, B, C, chunk=chunk)

    def recording_bwd(x, dt, A, B, C, dy, dstate=None, *, chunk=64, h_in=None):
        route = ssd.bwd_route(x.dtype, x.shape[3], B.shape[-1], chunk, all(ssd._aligned(t) for t in (x, B, C, dy)))
        if bwd is not None:
            kernels = ssd.bwd_kernels(route, x.dtype, B.shape[-1], ssd.fwd_aligned(x, B, C, dy))
            bwd.append((list(x.shape), route, list(kernels)))
        return scan_bwd(x, dt, A, B, C, dy, dstate, chunk=chunk, h_in=h_in)

    with mock.patch.object(ops, "ssd_scan", recording), mock.patch.object(ssd, "ssd_scan_bwd", recording_bwd):
        yield


def _drop_tp_sums(y, mesh, axis, dim=None):
    """A control's stand-in for ``sum_tp`` / ``sp_scatter``: the rank's own
    partial output, unsummed over ``axis`` (its block of it for the latter)."""
    from repro_torch.collectives import own_block

    return y if dim is None else own_block(y, mesh, axis, dim).contiguous()


def _zero_launches() -> None:
    fa.launches = gm.launches = ssd.launches = 0


def shard_one_rank(failures: list[str], smi: str) -> dict:
    """Phase 15 (a): one NCCL rank, a (1, 1) mesh, the parameters as
    ``local_shard`` gives them (each block the whole leaf): granite-3-2b's
    train step, phi3.5-moe's prefill and a decode step must give the bits of
    no mesh.  Returns the launches of the mesh runs."""
    from repro_torch.launch.mesh import join_group, make_test_mesh
    from repro_torch.models.layout import param_layout
    from repro_torch.sharding import local_shard

    launches: dict[str, int] = {}
    with tempfile.TemporaryDirectory() as d:
        join_group(1, 0, store=torch.distributed.FileStore(str(Path(d) / "store"), 1), device="cuda")
        try:
            mesh = make_test_mesh((1, 1), device="cuda")
            cfg = dataclasses.replace(get_config(MESH_MOE), n_layers=MESH_DEPTH)
            whole = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
            mine = local_shard(mesh, whole, param_layout(cfg, mesh))
            prompt = _mesh_prompt(cfg, 0)
            forced = torch.randint(0, cfg.vocab, (LM_BATCH, 1), generator=torch.Generator(device="cuda").manual_seed(1),
                                   device="cuda")
            runs = []
            for m, p in ((mesh, mine), (None, whole)):
                _zero_launches()
                lg, cache = transformer.prefill_step(cfg, p, prompt, m, max_len=LM_PROMPT + LM_GEN)
                lg1, cache = transformer.serve_step(cfg, p, cache, forced, m)
                torch.cuda.synchronize()
                runs.append((lg, lg1, cache, _launch_counts()))
            (a0, a1, ca, la), (b0, b1, cb, _) = runs
            launches["gemm"] = la["gemm"]
            same = torch.equal(a0, b0) and torch.equal(a1, b1) and all(torch.equal(ca[k], cb[k]) for k in cb if k != "index")
            print(f"[shard] (a) {MESH_MOE} at {MESH_DEPTH} layers, bf16, blocks of a (1, 1) mesh (sp_residuals "
                  f"{cfg.sp_residuals}: one model rank, no split): prefill {LM_BATCH} x "
                  f"{LM_PROMPT} and a decode step == no mesh (logits and cache): {same}; gemm launches {la['gemm']} "
                  f"({smi})")
            if not same:
                failures.append(f"(a) {MESH_MOE} prefill and decode over the (1, 1) blocks differ from no mesh")
            del whole, mine, runs, ca, cb
            torch.cuda.empty_cache()

            cfg = dataclasses.replace(get_config(MESH_TRAIN), n_layers=MESH_DEPTH)
            whole = init_params(cfg, torch.Generator(device="cuda").manual_seed(2), "cuda")
            batch = _mesh_train_batch(cfg)
            opt = AdamW(AdamWConfig(total_steps=10, warmup=2))
            runs = []
            for m in (mesh, None):
                p = local_shard(mesh, tree_map(torch.clone, whole), param_layout(cfg, mesh))
                _zero_launches()
                p1, _, met = transformer.make_train_step(cfg, opt, m)(p, opt.init(p), batch)
                torch.cuda.synchronize()
                runs.append((p1, met, _launch_counts()))
            (pa, ma, la), (pb, mb, _) = runs
            launches["flash_attention"] = la["flash_attention"]
            same = torch.equal(ma["loss"], mb["loss"]) and torch.equal(ma["grad_norm"], mb["grad_norm"]) \
                and _trees_equal(pa, pb)
            print(f"[shard] (a) {MESH_TRAIN} at {MESH_DEPTH} layers, bf16, a train step on the (1, 1) blocks, "
                  f"{TRAIN_BATCH} x {TRAIN_SEQ}: loss, grad_norm and every parameter == no mesh: {same}; flash launches "
                  f"{la['flash_attention']} ({smi})")
            if not same:
                failures.append(f"(a) {MESH_TRAIN} train step over the (1, 1) blocks differs from no mesh")
            del whole, runs, pa, pb
            torch.cuda.empty_cache()
        finally:
            torch.distributed.destroy_process_group()
    return launches


def shard_rank(rank: int, store: str, out_path: str) -> int:
    """Phase 15 (b), one rank: its own process on cuda:0, joined over gloo
    to the other.  Writes its readings and failures to ``out_path`` as JSON;
    exits 0 once written."""
    from repro_torch.collectives import gather_whole
    from repro_torch.launch.mesh import batch_shard, join_group, make_test_mesh
    from repro_torch.models.layout import Layout, param_layout
    from repro_torch.sharding import local_shard, tree_bytes

    def say(msg: str) -> None:
        print(f"[shard] (b) rank {rank}: {msg}", flush=True)

    out: dict = {"failures": [], "launches": {}}
    fail = out["failures"].append
    join_group(SHARD_RANKS, rank, store=torch.distributed.FileStore(store, SHARD_RANKS), device="cuda", backend="gloo")
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # granite's gradient, one process, then over each mesh
        cfg = dataclasses.replace(get_config(MESH_TRAIN), n_layers=MESH_DEPTH)
        whole = init_params(cfg, torch.Generator(device="cuda").manual_seed(2), "cuda")
        batch = _mesh_train_batch(cfg)
        loss, grads = transformer.value_and_grad(cfg, whole, batch)
        want, plain = loss.item(), list(named_leaves(grads))
        del grads
        for shape in SHARD_MESHES:
            mesh = make_test_mesh(shape, device="cuda")
            specs = param_layout(cfg, mesh)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            mine = local_shard(mesh, tree_map(torch.clone, whole), specs)  # blocks of their own, the copy freed
            opt = AdamW(AdamWConfig(total_steps=10, warmup=2))
            state = opt.init(mine)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() - before
            exact = tree_bytes(mine) + tree_bytes(state)
            n = len(tree_leaves(mine)) + len(tree_leaves(state))
            ok_bytes = exact <= held <= exact + ALLOC_ROUND * n
            out[f"bytes {shape}"] = {"memory_allocated": held, "blocks": exact, "tensors": n}
            rows = batch_shard(mesh, batch)

            def held_against_plain(c=cfg, dp_axes=("data",)):
                """(loss, gathered leaves) over ``mesh`` against one process, and the bytes remat kept."""
                kept: list = []
                with _recording_remat(kept):
                    loss, grads = transformer.value_and_grad(c, mine, rows, mesh, dp_axes=dp_axes)
                return {"loss": abs(loss.item() - want) / abs(want),
                        "leaves": _leaf_ratios(gather_whole(mesh, grads, specs), plain)}, kept

            _zero_launches()
            r_mesh, kept = held_against_plain()
            torch.cuda.synchronize()
            out["launches"][f"flash_attention {shape}"] = fa.launches
            runs, controls = {"mesh": r_mesh}, []
            if shape[1] > 1:
                # the stream whole on each rank (sp_residuals off), held too; remat keeps twice the split's bytes
                runs["stream whole"], kept_whole = held_against_plain(dataclasses.replace(cfg, sp_residuals=False))
                out[f"remat bytes {shape}"] = {"split": kept, "whole": kept_whole}
                say(f"{MESH_TRAIN} on {shape}: the layer inputs remat keeps, bytes each, the sequence split over "
                    f"model {kept}, whole {kept_whole} (the split's must be exactly 1/{shape[1]})")
                if not (len(kept) == len(kept_whole) == MESH_DEPTH and all(a * shape[1] == b for a, b in
                                                                           zip(kept, kept_whole))):
                    fail(f"rank {rank}: remat kept {kept} bytes with the split, {kept_whole} without it")
                # control: the tensor-parallel outputs left unsummed over model (the split's reduce-scatter too)
                with mock.patch.object(blocks, "sum_tp", _drop_tp_sums), \
                        mock.patch.object(blocks, "sp_scatter", _drop_tp_sums):
                    runs["tensor-parallel sums dropped"] = held_against_plain()[0]
                # control: the norms run on the rank's block of the sequence, their gradients left unsummed
                with mock.patch.object(Layout, "NORMS", frozenset()):
                    runs["norm gradients unsummed over model"] = held_against_plain()[0]
                controls = ["tensor-parallel sums dropped", "norm gradients unsummed over model"]
            else:  # control: each rank's gradient of its own rows, unsummed over data
                runs["data sums dropped"] = held_against_plain(dp_axes=())[0]
                controls = ["data sums dropped"]
            out[f"train {shape}"] = runs
            loss_tol = SPLIT_LOSS_TOL if shape[1] > 1 else MESH_LOSS_TOL
            for name, r in runs.items():
                leaf = max(r["leaves"], key=r["leaves"].get)
                say(f"{MESH_TRAIN} at {MESH_DEPTH} layers, bf16, {TRAIN_BATCH} x {TRAIN_SEQ} on {shape}, {name} "
                    f"against one process: loss relative {r['loss']:.3e} (tolerance {loss_tol}); worst leaf "
                    f"{leaf} at {r['leaves'][leaf]:.3e} (tolerance {MESH_GRAD_TOL})")
            say(f"{MESH_TRAIN} on {shape}: parameters and AdamW state held {held} bytes by memory_allocated, the "
                f"blocks {exact} bytes in {n} tensors ({'within' if ok_bytes else 'OUTSIDE'} the allocator's "
                f"{ALLOC_ROUND}-byte rounding); the whole tree {tree_bytes(whole)} bytes of parameters")
            for name, r in runs.items():
                if name in controls:
                    if not max(r["leaves"].values()) > MESH_GRAD_TOL:
                        fail(f"rank {rank}: the control '{name}' on {shape} meets the gradient tolerance")
                elif not (r["loss"] <= loss_tol and max(r["leaves"].values()) <= MESH_GRAD_TOL):
                    fail(f"rank {rank}: {MESH_TRAIN} on {shape}, {name}, against one process: {r['loss']}, "
                         f"{max(r['leaves'].values())}")
            # the control that changes the loss (the norms' gradients do not) must miss the loss limit too
            if not runs[controls[0]]["loss"] > loss_tol:
                fail(f"rank {rank}: the control '{controls[0]}' on {shape} meets the loss tolerance {loss_tol}")
            if not ok_bytes:
                fail(f"rank {rank}: {shape} holds {held} bytes for blocks of {exact}")
            del mine, state
            torch.cuda.empty_cache()
        del whole
        torch.cuda.empty_cache()

        # phi3.5-moe: prefill and decode on each mesh against one process on the same routes
        cfg = dataclasses.replace(get_config(MESH_MOE), n_layers=MESH_DEPTH)
        whole = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        prompt = _mesh_prompt(cfg, 0)
        forced = torch.randint(0, cfg.vocab, (LM_BATCH, SHARD_DECODE), device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(1))

        def serve(c, p, m, pr, fo):
            lg, cache = transformer.prefill_step(c, p, pr, m, max_len=LM_PROMPT + LM_GEN)
            got = [lg]
            for i in range(SHARD_DECODE):
                lg, cache = transformer.serve_step(c, p, cache, fo[:, i : i + 1], m)
                got.append(lg)
            return got, cache

        def rel(got, wanted):
            return [((g.float() - w.float()).abs().max() / w.float().abs().max()).item() for g, w in zip(got, wanted)]

        for shape in SHARD_MESHES:
            mesh = make_test_mesh(shape, device="cuda")
            mine = local_shard(mesh, whole, param_layout(cfg, mesh))
            pr, fo = batch_shard(mesh, prompt), batch_shard(mesh, forced)
            routes: list = []
            _zero_launches()
            with _recording_routes(routes):
                got, cache = serve(cfg, mine, mesh, pr, fo)
            torch.cuda.synchronize()
            counts = _launch_counts()
            for k in ("gemm", "flash_attention"):
                out["launches"][f"{k} serve {shape}"] = counts[k]
            ring = tuple(cache["k"].shape)
            with _replaying_routes(routes):
                wanted, _ = serve(cfg, whole, None, pr, fo)
            own: list = []
            with _recording_routes(own):  # one process on its own routes: the mesh's must agree as phase 8's do
                serve(cfg, whole, None, pr, fo)
            share, per = _route_agreement(routes, own)
            out[f"routes {shape}"] = {"all calls": share, "first layer": per[0]}
            say(f"{MESH_MOE} on {shape}: the mesh's routes against one process's own, first layer {per[0]:.6f}, all "
                f"calls {share:.6f} (floors {ROUTE_FLOOR})")
            if per[0] < ROUTE_FLOOR["first layer"] or share < ROUTE_FLOOR["all calls"]:
                fail(f"rank {rank}: {MESH_MOE} on {shape} routes below {ROUTE_FLOOR}: {per[0]}, {share}")
            rels = rel(got, wanted)
            out[f"serve {shape}"] = rels
            say(f"{MESH_MOE} at {MESH_DEPTH} layers, bf16, prefill {pr['tokens'].shape[0]} x {LM_PROMPT} and "
                f"{SHARD_DECODE} decode steps on {shape} (the rank's ring {ring} of {LM_PROMPT + LM_GEN} slots): logits "
                f"against one process on the same routes {', '.join(f'{r:.3e}' for r in rels)} of max |logit| "
                f"(tolerance {LM_TOL[torch.bfloat16]}); launches {counts}")
            if not max(rels) <= LM_TOL[torch.bfloat16]:
                fail(f"rank {rank}: {MESH_MOE} serving on {shape} against one process: {rels}")
            if shape[1] > 1:  # control: the split ring's softmax statistics left uncombined over model
                with _replaying_routes(routes), \
                        mock.patch.object(blocks, "all_reduce_over", lambda t, *a, **k: t.clone()):
                    ctl, _ = serve(cfg, mine, mesh, pr, fo)
                ctl_rels = rel(ctl[1:], wanted[1:])
                out[f"serve {shape} split ring uncombined"] = ctl_rels
                say(f"{MESH_MOE} on {shape}, control, each rank attending only its {ring[2]} ring slots (the split "
                    f"ring's all-reduces dropped): decode logits against one process "
                    f"{', '.join(f'{r:.3e}' for r in ctl_rels)} of max |logit| (must miss {LM_TOL[torch.bfloat16]})")
                if not min(ctl_rels) > LM_TOL[torch.bfloat16]:
                    fail(f"rank {rank}: the control 'split ring uncombined' on {shape} meets the logits tolerance")
                del ctl
            del mine, got, wanted, cache, routes
            torch.cuda.empty_cache()
        del whole
        torch.cuda.empty_cache()

        def split_scans(scans: list, name: str, shape, heads: int) -> None:
            """Fail unless every recorded scan took the rank's ``heads`` on the wgmma route."""
            want = [[LM_BATCH // shape[0], LM_PROMPT, heads, 64], ssd.KERNELS[ssd.WGMMA]]
            if [list(sc) for sc in scans] != [want] * len(scans) or not scans:
                fail(f"rank {rank}: {name} on {shape} scanned {scans}, each {want} wanted")

        def ssd_model(arch: str, depth: int | None, seed: int, held: bool) -> None:
            """``arch`` at ``depth`` layers (None: all) on the (1, 2) mesh, each rank on its heads of every SSD
            layer, served against one process.  ``held``: the model in fp32 and its scans in bf16 (SSD_LAYERS),
            the logits held to LM_TOL, then a train step, its loss and every leaf gathered whole held to
            SSD_TRAIN_LOSS_TOL / SSD_TRAIN_GRAD_TOL beside the gated-norm control, which must miss; otherwise
            the model in bf16, its logits printed.  Every scan on the tensor-core kernel at the rank's heads,
            every backward on the "wgmma" route's three kernels."""
            cfg = get_config(arch)
            cfg = cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)
            whole = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
            if held:
                cfg, whole = dataclasses.replace(cfg, dtype=torch.float32), _cast(whole, torch.float32)
            scans_in = _bf16_scans if held else contextlib.nullcontext
            prec, heads = ("fp32 with bf16 scans" if held else "bf16"), cfg.ssm_heads // shape[1]
            prompt = _mesh_prompt(cfg, seed)
            forced = torch.randint(0, cfg.vocab, (LM_BATCH, SHARD_DECODE), device="cuda",
                                   generator=torch.Generator(device="cuda").manual_seed(seed + 1))
            specs = param_layout(cfg, mesh)
            mine = local_shard(mesh, tree_map(torch.clone, whole), specs)
            pr, fo = batch_shard(mesh, prompt), batch_shard(mesh, forced)
            _zero_launches()
            scans: list = []
            with _recording_scans(scans), scans_in():
                got, cache = serve(cfg, mine, mesh, pr, fo)
            torch.cuda.synchronize()
            counts = _launch_counts()
            for k in ("ssd_scan", "flash_attention"):
                out["launches"][f"{k} {arch} serve {prec} {shape}"] = counts[k]
            state = tuple(cache["ssm"].shape)
            with scans_in():
                wanted, _ = serve(cfg, whole, None, pr, fo)
            rels = rel(got, wanted)
            out[f"{arch} serve {prec} {shape}"] = rels
            say(f"{arch} at {cfg.n_layers} layers, {prec}, prefill {pr['tokens'].shape[0]} x {LM_PROMPT} and "
                f"{SHARD_DECODE} decode steps on {shape} ({heads} of {cfg.ssm_heads} SSD heads a rank, its SSM state "
                f"{state}): logits against one process {', '.join(f'{r:.3e}' for r in rels)} of max |logit| "
                f"({f'tolerance {LM_TOL[torch.bfloat16]}' if held else 'printed only, SSD_LAYERS'}); launches "
                f"{counts}; the prefill's scans {scans[:1]} x {len(scans)}")
            if held and not max(rels) <= LM_TOL[torch.bfloat16]:
                fail(f"rank {rank}: {arch} serving on {shape}, {prec}, against one process: {rels}")
            if counts["ssd_scan"] != cfg.n_layers:  # each rank scans its heads of every SSD layer once
                fail(f"rank {rank}: {arch} on {shape} launched {counts['ssd_scan']} SSD scans, {cfg.n_layers} wanted")
            split_scans(scans, arch, shape, heads)
            del got, wanted, cache
            torch.cuda.empty_cache()
            if not held:
                return

            batch = _mesh_train_batch(cfg)
            with scans_in():
                loss, grads = transformer.value_and_grad(cfg, whole, batch)
            want, plain = loss.item(), list(named_leaves(grads))
            del grads
            rows = batch_shard(mesh, batch)

            def ssd_step() -> dict:
                with scans_in():
                    loss, grads = transformer.value_and_grad(cfg, mine, rows, mesh)
                return {"loss": abs(loss.item() - want) / abs(want),
                        "leaves": _leaf_ratios(gather_whole(mesh, grads, specs), plain)}

            fwd, bwd = [], []
            ssd.bwd_launches = 0
            with _recording_scans(fwd, bwd):
                runs = {"mesh": ssd_step()}
            torch.cuda.synchronize()
            launched = ssd.bwd_launches
            out["launches"][f"ssd_scan {arch} train {prec} {shape}"] = len(fwd)
            control = "gated norm's mean square summed forward only"
            with mock.patch.object(blocks, "psum_tp", blocks.sum_tp):  # its gradient left unsummed over model
                runs[control] = ssd_step()
            out[f"{arch} train {prec} {shape}"] = runs
            tol = SSD_TRAIN_GRAD_TOL[arch]
            for name, r in runs.items():
                leaf = max(r["leaves"], key=r["leaves"].get)
                say(f"{arch} at {cfg.n_layers} layers, {prec}, a train step {TRAIN_BATCH} x {TRAIN_SEQ} on {shape}, "
                    f"{name}, against one process: loss relative {r['loss']:.3e}; worst leaf {leaf} at "
                    f"{r['leaves'][leaf]:.3e} (tolerances {SSD_TRAIN_LOSS_TOL} / {tol}"
                    f"{', must miss' if name == control else ''})")
            say(f"{arch} train step, {prec}, on {shape}: {len(fwd)} forward scans (remat recomputes each layer's), "
                f"{launched} backward calls; forward {fwd[:1]}, backward {bwd[:1]}")
            r = runs["mesh"]
            if not (r["loss"] <= SSD_TRAIN_LOSS_TOL and max(r["leaves"].values()) <= tol):
                fail(f"rank {rank}: {arch} train step on {shape}, {prec}, against one process: "
                     f"{r['loss']}, {max(r['leaves'].values())}")
            if not max(runs[control]["leaves"].values()) > tol:
                fail(f"rank {rank}: the control '{control}' on {shape} meets {arch}'s gradient tolerance")
            rows_r = [TRAIN_BATCH // shape[0], TRAIN_SEQ, heads, cfg.ssm_head_dim]
            route_kernels = list(ssd.bwd_kernels("wgmma", torch.bfloat16, cfg.ssm_state))
            if [list(f) for f in fwd] != [[rows_r, ssd.KERNELS[ssd.WGMMA]]] * (2 * cfg.n_layers):
                fail(f"rank {rank}: {arch} train step on {shape} scanned {fwd[:2]}... ({len(fwd)}), "
                     f"{2 * cfg.n_layers} of {rows_r} on the wgmma route wanted")
            if [list(b) for b in bwd] != [[rows_r, "wgmma", route_kernels]] * cfg.n_layers or launched != cfg.n_layers:
                fail(f"rank {rank}: {arch} train step on {shape}: backward {bwd[:2]}... ({len(bwd)} recorded, "
                     f"{launched} launched), {cfg.n_layers} of {rows_r} on the 'wgmma' route wanted")
            del mine, whole, plain
            torch.cuda.empty_cache()

        # zamba2 (each rank on its SSD heads, its shared block on its attention heads) in bf16, printed, and held
        # in fp32 with bf16 scans; mamba2 at full width and depth, held so
        shape = SHARD_MESHES[0]
        mesh = make_test_mesh(shape, device="cuda")
        for held in (False, True):
            ssd_model(SHARD_HYBRID, SHARD_HYBRID_DEPTH, 4, held)
        ssd_model(SHARD_SSD, None, 6, True)
    finally:
        Path(out_path).write_text(json.dumps(out))
        torch.distributed.destroy_process_group()
    return 0


def shard_two_ranks(failures: list[str]) -> dict:
    """Phase 15 (b): SHARD_RANKS processes of ``shard_rank`` sharing cuda:0
    over gloo; prints their lines, adds their failures.  Returns the
    launches, summed over the ranks and runs."""
    with tempfile.TemporaryDirectory() as d:
        outs = [Path(d) / f"rank{r}.json" for r in range(SHARD_RANKS)]
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--shard-rank", str(r),
                                   str(Path(d) / "store"), str(outs[r])], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(SHARD_RANKS)]
        try:
            logs = [p.communicate(timeout=SHARD_RANK_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            print(log, end="")
            if p.returncode != 0 or not outs[r].exists():
                failures.append(f"(b) shard rank {r} exited {p.returncode}")
                print(f"[FAIL] {failures[-1]}")
        results = [json.loads(o.read_text()) for o in outs if o.exists()]
    launches: dict[str, int] = {}
    for res in results:
        for f in res["failures"]:
            failures.append(f"(b) {f}")
            print(f"[FAIL] {failures[-1]}")
        for k, n in res["launches"].items():
            name = k.split()[0]
            launches[name] = launches.get(name, 0) + n
    return launches


#: phase 15's scan shapes: (model, whose, x's shape [b, l, h, p], the state width): each model's prefill and train
#: shape whole and at the (1, 2) mesh rank's half of the heads, and zamba2-2.7b x train_4k's as rank 0 of (16, 16)
SHARD_SCAN_SHAPES = (("mamba2-130m", "whole", (4, 512, 24, 64), 128),
                     ("mamba2-130m", "a (1, 2) rank", (4, 512, 12, 64), 128),
                     ("zamba2-2.7b", "whole", (4, 512, 80, 64), 64),
                     ("zamba2-2.7b", "a (1, 2) rank", (4, 512, 40, 64), 64),
                     ("zamba2-2.7b", "train_4k, rank 0 of (16, 16)", (16, 4096, 5, 64), 64))


def shard_scan_times(failures: list[str], smi: str) -> dict:
    """Phase 15: the bf16 scan and its backward at each SHARD_SCAN_SHAPES
    shape, on x, B and C strided as ``ssd_block`` passes them: y and the
    final state held to BF16_REL_TOL of max |plain| against
    ``ssd_scan_plain``, and dx, ddt, dA, dB and dC against
    ``ssd_scan_bwd_plain``, on the same inputs; then timed by the
    profiler's device time, beside the forward's ``mma.sync`` kernel
    (``ssd_scan.mma_plan``) and the backward's ``"mma"`` route (the
    ``mma.sync`` chunk kernel) on the same inputs, and the backward given
    the forward's states (``ssd_scan.ssd_scan_states``), which must give
    the same bits.  Fails unless the forward ran the wgmma route's kernels
    (``ssd_scan.fwd_kernels``) and the backward the ``"wgmma"`` route's.
    Returns the readings by shape."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf16, out = torch.bfloat16, {}
    for model, whose, (b, l, h, p), n in SHARD_SCAN_SHAPES:
        chunk = get_config(model).ssm_chunk
        x, dt, A, B, C = ssd_inputs(b, l, h, p, n, bf16, True, gen)
        dy = torch.randn((b, l, h, p), generator=gen, device="cuda").to(bf16)
        shape = f"[{b},{l},{h},{p}]"
        desc = {"model": model, "x": shape, "state": n, "chunk": chunk}
        n0 = len(failures)
        try:
            y, st = ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
            yp, stp = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
            f_err = max(_agree("ssd_scan", desc, y, yp, None) / yp.float().abs().max().item(),
                        _agree("ssd_scan (state)", desc, st, stp, None) / stp.float().abs().max().item())
            del y, st, yp, stp
            got = ssd.ssd_scan_bwd(x, dt, A, B, C, dy, chunk=chunk)
            b_err = _hold_ssd_grads("ssd_scan_bwd", desc, got, ssd.ssd_scan_bwd_plain(x, dt, A, B, C, dy, chunk=chunk),
                                    BF16_REL_TOL)
            h_in = ssd.ssd_scan_states(x, dt, A, B, C, chunk=chunk)[2]
            if not all(torch.equal(u, v) for u, v in zip(got, ssd.ssd_scan_bwd(x, dt, A, B, C, dy, chunk=chunk,
                                                                                h_in=h_in))):
                raise RuntimeError("the backward given the forward's states differs from the one that rebuilds them")
            del got
        except RuntimeError as e:
            failures.append(f"{model} scan x {shape} against its plain version: {e}")
            f_err = b_err = float("nan")
            h_in = None
        f_ms, f_ran = _device_ms(lambda: ssd.ssd_scan(x, dt, A, B, C, chunk=chunk))
        mma_plan = ssd.mma_plan(b, h, p, n, chunk)
        mma_ms, _ = _device_ms(lambda: ssd.run_plan(x, dt, A, B, C, chunk, mma_plan))
        b_ms, b_ran = _device_ms(lambda: ssd.ssd_scan_bwd(x, dt, A, B, C, dy, chunk=chunk))
        b_mma_ms, _ = _device_ms(lambda: ssd.run_bwd_route(x, dt, A, B, C, dy, chunk=chunk, route="mma"))
        b_carried_ms = None if h_in is None else _device_ms(
            lambda: ssd.ssd_scan_bwd(x, dt, A, B, C, dy, chunk=chunk, h_in=h_in))[0]
        out[f"{model} x {shape}"] = {"forward_ms": f_ms, "forward_mma_ms": mma_ms, "backward_ms": b_ms,
                                     "backward_mma_ms": b_mma_ms, "backward_carried_ms": b_carried_ms,
                                     "backward_ratio_to_mma": b_ms / b_mma_ms,
                                     "forward_rel_err": f_err, "backward_rel_err": b_err}
        f_fns = sorted({m.group(1) for k in f_ran if (m := SSD_FN.search(k))})
        b_fns = sorted({m.group(1) for k in b_ran if (m := SSD_BWD_FN.search(k))})
        print(f"[shard] {model} scan x {shape}, B/C [{b},{l},{n}] bf16 ({whose}): against the plain version, y and "
              f"state {f_err:.3e}, worst gradient {b_err:.3e} of max |plain| (tolerance {BF16_REL_TOL}); forward "
              f"{f_ms:.4f} ms {f_fns} (the mma.sync kernel's plan {mma_ms:.4f} ms), backward {b_ms:.4f} ms {b_fns} "
              f"(the 'mma' route {b_mma_ms:.4f} ms, given the forward's states {b_carried_ms} ms) by the profiler's "
              f"device time ({smi})")
        want = sorted(ssd.fwd_kernels(ssd.plan(bf16, b, h, p, n, chunk, True), n))
        if f_fns != want:
            failures.append(f"{model} scan x {shape} ran {f_fns}, not the wgmma route's {want}")
        if b_fns != sorted(ssd.bwd_kernels("wgmma", bf16, n)):
            failures.append(f"{model} scan backward x {shape} ran {b_fns}, not the 'wgmma' route's kernels")
        for f in failures[n0:]:
            print(f"[FAIL] {f}")
        del x, dt, A, B, C, dy, h_in
    torch.cuda.empty_cache()
    return out


def shard_dryrun(failures: list[str], smi: str) -> dict:
    """Phase 15 (c): each SHARD_DRYRUN cell's ``meta`` profile, then its
    step once on the card as rank 0 of the same 256-rank fake group.
    Returns the launches of the card runs."""
    from repro_torch.launch import dryrun

    launches = {"flash_attention": 0, "gemm": 0, "ssd_scan": 0}
    try:
        for arch, shape in SHARD_DRYRUN:
            t0, n0 = time.perf_counter(), len(failures)
            _zero_launches()
            ssd.bwd_launches = 0
            fwd, bwd = [], []
            with _recording_scans(fwd, bwd):
                rec = dryrun.run_cell(arch, shape, "single", out_dir=None, device="cuda")
            counts = _launch_counts()
            for k, n in counts.items():
                launches[k] += n
            meas, roof, mem = rec["measured"], rec["roofline"], rec["memory"]
            print(f"[shard] (c) {arch} x {shape} x single, rank 0 of 256 (fake group), accum {rec['accum']}: argument "
                  f"bytes {meas.get('argument_bytes')} on the card, {mem['argument_bytes_per_dev']} by the meta profile; "
                  f"measured peak {meas.get('peak_bytes', 0) / 2**30:.3f} GiB (max_memory_allocated; meta estimate "
                  f"{mem['peak_estimate_gib']} GiB); the step {meas.get('step_ms', float('nan')):.1f} ms by CUDA events "
                  f"beside the roofline's compute {roof['compute_s'] * 1e3:.1f} ms and memory "
                  f"{roof['memory_s'] * 1e3:.1f} ms (collective {roof['collective_s'] * 1e3:.1f} ms, not run: the "
                  f"fake group moves nothing); finite outputs: {meas.get('finite')}; launches {counts}; "
                  f"{time.perf_counter() - t0:.1f} s ({smi})")
            cfg, tp = get_config(arch), 16  # the single mesh's model axis
            if cfg.block_kind in ("ssd", "hybrid"):
                heads = cfg.ssm_heads // tp if cfg.ssm_heads % tp == 0 else cfg.ssm_heads
                tally = lambda calls: dict(collections.Counter(json.dumps(c) for c in calls))
                print(f"[shard] (c) {arch} x {shape}: {heads} of {cfg.ssm_heads} SSD heads a rank; the card's scans "
                      f"(x's shape, kernel: calls) {tally(fwd)}; backward (x's shape, route, kernels: calls) "
                      f"{tally(bwd)}, {ssd.bwd_launches} launched ({smi})")
                if not fwd or any(f[0][2] != heads for f in fwd) or (rec["phase"] == "train" and not bwd):
                    failures.append(f"(c) {arch} x {shape}: the scans took {tally(fwd)}, {heads} heads wanted")
            if arch == "qwen3-32b" and rec["phase"] == "train" and "peak_bytes" in meas:
                print(f"[shard] (c) {arch} x {shape}: the residual stream split over model (sp_residuals), step peak "
                      f"{meas['peak_bytes'] / 2**30:.3f} GiB, beside {SHARD_WHOLE_STREAM_PEAK_GIB[0]:.3f}-"
                      f"{SHARD_WHOLE_STREAM_PEAK_GIB[1]:.3f} GiB with the stream whole on every model rank ({smi})")
            if "skipped" in meas:
                failures.append(f"(c) {arch} x {shape} did not run on the card: {meas['skipped']}")
            elif meas["argument_bytes"] != mem["argument_bytes_per_dev"] or not meas["finite"]:
                failures.append(f"(c) {arch} x {shape}: card arguments {meas['argument_bytes']} vs meta "
                                f"{mem['argument_bytes_per_dev']}, finite {meas['finite']}")
            if rec["phase"] == "train" and not counts["flash_attention"]:
                failures.append(f"(c) {arch} x {shape} never launched flash_attention")
            for f in failures[n0:]:
                print(f"[FAIL] {f}")
            torch.cuda.empty_cache()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return launches


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(f"[card] {smi.stdout.strip().splitlines()[0]}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    # full fp32 everywhere a plain or library result is compared or timed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[card] TF32 off: cuda.matmul.allow_tf32=False, cudnn.allow_tf32=False")

    t0 = time.perf_counter()
    paths = build.build_all()
    print(f"[build] {len(paths)} kernel(s) in {time.perf_counter() - t0:.1f} s: {sorted(paths)}")
    for name in sorted(paths):
        print(f"[build] {name}:\n{build.ptxas_report(name)}")
    check_flash_ptxas()
    check_flash_bwd_ptxas()
    check_gemm_ptxas()
    check_conv_ptxas()
    check_ssd_ptxas()
    check_ssd_bwd_ptxas()

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    kernels = {"conv2d_im2col": check_conv(gen)}
    print(f"[check] done in {time.perf_counter() - t0:.1f} s")

    # main path, counts from 0
    im2col_conv.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve_cnn(device="cuda", scale=1.0, in_shape=(220, 220, 3), seed=0)
    torch.cuda.synchronize()
    launches = {"conv2d_im2col": im2col_conv.launches}
    wall = time.perf_counter() - t0
    print("\n".join(res.report()))
    print(f"[main] wall {wall:.1f} s, launches {launches}, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    names = [sp.name for sp in res.model.specs]
    print("[main] measured layer ms (microbatch of 2): "
          + json.dumps({n: round(t * 1e3, 4) for n, t in zip(names, res.evaluator.measured)}))
    print(f"[main] stage ms of the chosen split: {[round(t * 1e3, 4) for t in res.evaluator.stage_times(res.conf)]}")
    for name, n in launches.items():
        if n == 0:
            raise RuntimeError(f"kernel {name} never launched on the main path")
        kernels[name]["launches"] = n

    # the pipelined output against the sequential model
    model, out = res.model, res.out
    if not torch.isfinite(out).all():
        raise RuntimeError("pipelined output is not finite")
    seq = torch.stack([model(x) for x in res.micro])
    if not torch.equal(out, seq):
        raise RuntimeError(f"pipelined output differs from the sequential model: {(out - seq).abs().max().item()}")
    plain = []
    for x in res.micro:
        for i, sp in enumerate(model.specs):
            y = im2col_conv.conv2d_im2col_plain(model.layer_input(i, x), model.w[i], stride=sp.stride)
            x = torch.relu(y + model.b[i])
        plain.append(x)
    plain = torch.stack(plain)
    err, scale = (out - plain).abs().max().item(), plain.abs().max().item()
    print(f"[main] output {tuple(out.shape)}: pipelined == sequential; vs plain max abs err {err:.3e}, "
          f"max |output| {scale:.3e}")
    if not scale > 0 or err > CHAIN_TOL * scale:
        raise RuntimeError(f"pipelined output disagrees with the plain model: {err} > {CHAIN_TOL} * {scale}")
    t0 = time.perf_counter()
    race(res)
    print(f"[race] done in {time.perf_counter() - t0:.1f} s")
    t0, before = time.perf_counter(), im2col_conv.launches
    place_and_scale(res, seq)
    torch.cuda.synchronize()
    if im2col_conv.launches == before:
        raise RuntimeError("phase 5b's pipelines never launched the conv kernel")
    print(f"[place] done in {time.perf_counter() - t0:.1f} s, conv launches {im2col_conv.launches - before} "
          f"({smi.stdout.strip().splitlines()[0]})")
    t0, before = time.perf_counter(), im2col_conv.launches
    serve_online(res, seq)
    torch.cuda.synchronize()
    if im2col_conv.launches == before:
        raise RuntimeError("phase 5c's pipelines never launched the conv kernel")
    print(f"[online] done in {time.perf_counter() - t0:.1f} s, conv launches {im2col_conv.launches - before} "
          f"({smi.stdout.strip().splitlines()[0]})")
    t0, before = time.perf_counter(), im2col_conv.launches
    co_plat = co_platform()
    tenants = {}
    for net, (shape, seed) in CO_TENANTS.items():
        measured = measure_cnn(net, co_plat, device="cuda", in_shape=shape, seed=seed)
        micro = torch.randn((N_MICRO, BATCH, *shape), generator=measured.gen, device="cuda")
        tenants[net] = (measured, micro)
        print(f"[co] {net} measured layer ms (microbatch of {BATCH}, {shape}): "
              + json.dumps([round(t * 1e3, 4) for t in measured.evaluator.measured]))
    co_serve_online({net: (m.model, micro) for net, (m, micro) in tenants.items()},
                    {net: m.evaluator for net, (m, _) in tenants.items()})
    torch.cuda.synchronize()
    if im2col_conv.launches == before:
        raise RuntimeError("phase 5d's pipelines never launched the conv kernel")
    print(f"[co] done in {time.perf_counter() - t0:.1f} s, conv launches {im2col_conv.launches - before} "
          f"({smi.stdout.strip().splitlines()[0]})")
    del tenants
    del res, model, out, seq, plain
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    kernels["flash_attention"] = check_flash(gen)
    kernels["flash_attention_bf16_scores"] = check_flash_bf16_scores(gen)
    kernels["ssd_scan"] = check_ssd(gen)
    kernels["gemm"] = check_gemm(gen)
    print(f"[check] LM kernels done in {time.perf_counter() - t0:.1f} s")
    failures: list[str] = []
    for arch, (names, depth, fp32_depth) in LM_MODELS.items():
        t0 = time.perf_counter()
        launched, served_by = drive_lm(arch, names, depth, fp32_depth, failures)
        if "gemm decode" in launched:
            kernels["gemm"][f"{arch} decode launches"] = launched.pop("gemm decode")
        for name, n in launched.items():
            if "launches" in kernels[name]:  # each kernel's first model is its main path
                kernels[name][f"{arch} launches"] = n
            else:
                kernels[name]["launches"] = n
        if served_by:
            kernels["flash_attention"].setdefault("device_function", served_by)
        print(f"[lm] {arch} done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    kernels["flash_attention"].update(check_flash_bwd(gen))
    kernels["flash_attention_bf16_scores"].update(check_flash_bwd_bf16_scores(gen))
    kernels["ssd_scan"].update(check_ssd_bwd(gen))
    # phase 15's scan times at a rank's heads, beside the scan's own: taken after the training phases, the
    # profiler kept no device record of them in 8 windows (PERF.md)
    split_heads = shard_scan_times(failures, smi.stdout.strip().splitlines()[0])
    kernels["gemm"].update(check_gemm_grad(gen))
    print(f"[bwd] backward kernels done in {time.perf_counter() - t0:.1f} s")
    for arch, (depth, grad_depth) in TRAIN_MODELS.items():
        t0 = time.perf_counter()
        out = drive_train(arch, depth, grad_depth, failures)
        # granite's training run is the flash row's, mamba2's the ssd_scan row's
        for row, first in (("flash_attention", "granite-3-2b"), ("ssd_scan", "mamba2-130m"), ("gemm", "phi3.5-moe-42b")):
            if out[f"{row}_bwd"]:
                prefix = "" if arch == first else f"{arch} "
                kernels[row].update({f"{prefix}train_launches": out[row], f"{prefix}bwd_launches": out[f"{row}_bwd"]})
        print(f"[train] {arch} done in {time.perf_counter() - t0:.1f} s")

    # phase 14: the mesh paths, each with its counts from 0
    t0 = time.perf_counter()
    one = mesh_one_rank(failures)
    two = mesh_two_ranks(failures)
    for label, launched, want in (("mesh (1, 1)", one, ("gemm", "flash_attention")),
                                  ("mesh two-rank", two, ("conv2d_im2col", "gemm", "flash_attention"))):
        for name in want:
            kernels[name][f"{label} launches"] = launched.get(name, 0)
            if not launched.get(name):
                failures.append(f"{label}: {name} never launched")
                print(f"[FAIL] {failures[-1]}")
    print(f"[mesh] done in {time.perf_counter() - t0:.1f} s, launches (1, 1) {one}, two ranks {two} "
          f"({smi.stdout.strip().splitlines()[0]})")

    # phase 15: the sharded layout, and the dry run on the card, each with its counts from 0
    t0 = time.perf_counter()
    card = smi.stdout.strip().splitlines()[0]
    one = shard_one_rank(failures, card)
    two = shard_two_ranks(failures)
    dry = shard_dryrun(failures, card)
    kernels["ssd_scan"]["split heads"] = split_heads
    for label, launched, want in (("shard (1, 1)", one, ("gemm", "flash_attention")),
                                  ("shard two-rank", two, ("gemm", "flash_attention", "ssd_scan")),
                                  ("dryrun on the card", dry, ("flash_attention",))):
        for name in ("flash_attention", "gemm", "ssd_scan"):
            kernels[name][f"{label} launches"] = launched.get(name, 0)
        for name in want:
            if not launched.get(name):
                failures.append(f"{label}: {name} never launched")
                print(f"[FAIL] {failures[-1]}")
    print(f"[shard] done in {time.perf_counter() - t0:.1f} s, launches (1, 1) {one}, two ranks {two}, dry run {dry} "
          f"({card})")

    # phase 16: the bf16-score mode on the main paths, each with its counts from 0
    t0 = time.perf_counter()
    bf16s = drive_bf16_scores(failures)
    row = kernels["flash_attention_bf16_scores"]
    row["launches"] = bf16s["granite-3-2b train"]["flash_attention_bf16_scores"]
    row["bwd_launches"] = bf16s["granite-3-2b train"]["flash_attention_bf16_scores_bwd"]
    row["whisper-small launches"] = bf16s["whisper-small serve"]["flash_attention_bf16_scores"]
    row["zamba2-2.7b train_launches"] = bf16s["zamba2-2.7b train"]["flash_attention_bf16_scores"]
    row["zamba2-2.7b bwd_launches"] = bf16s["zamba2-2.7b train"]["flash_attention_bf16_scores_bwd"]
    print(f"[bf16s] done in {time.perf_counter() - t0:.1f} s, launches {json.dumps(bf16s)} ({card})")

    print(f"[done] chip_smoke in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    if failures:
        print("chip_smoke: failed:\n" + "\n".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:  # one rank of phase 14 (b), started by mesh_two_ranks
        sys.exit(mesh_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["--shard-rank"]:  # one rank of phase 15 (b), started by shard_two_ranks
        sys.exit(shard_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
