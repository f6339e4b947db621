#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out details.json]

Phases, each printing one line; any failure raises and exits non-zero:

1. card     — the card's name and power limit (nvidia-smi); TF32 off.
2. build    — build every kernel from ``src/repro_torch/csrc`` (one nvcc
              per source, in parallel); where the toolkit's ``cuobjdump``
              is found, every SSD kernel that computes products must hold
              tensor-core instructions (HMMA or HGMMA) in both dtypes.
3. kernels  — each kernel against its plain PyTorch version on the card:
              conv3d over the shape grid of ``tests/test_kernels.py`` and
              every conv of cosmoflow-128 at batch 4 (and of the
              quickstart's cosmoflow-512 smoke variant at batch 4) and the
              U-Net's Cin = 1 and Cin = 512 at a small depth, bn_act over
              the same rows x C shapes, fp32 and bf16; halo pack and
              unpack, bit for bit, at every face of the depth-split convs of
              cosmoflow-128 batch 4 (S = 2, 4, and all 7 blocks split at
              S = 2) and cosmoflow-512 batch 1 (S = 4), the sharded
              training steps' faces (batch 2 at 2 x 2) and those of
              unpack's adjoint, the U-Net's (unet3d-256 b1 at S = 2, 4,
              its training steps at 64^3), plus k = 5 (lo = hi = 2), a
              row of 180 bytes and the edges of the copy's work split
              (``HALO_EDGES``), fp32 and bf16, at each of the kernel's
              vector counts (``HALO_VECTORS``), and unpack of a pack
              buffer's faces (views off 16 bytes).
4. serve    — ``repro_torch.api.compile(RunConfig(model="cosmoflow-128",
              mode="infer", global_batch=4))`` at fp32 and bf16: predict
              on a seeded batch, held against the same forward through the
              plain versions; exactly 7 conv3d + 7 bn_act launches.
5. serve512 — cosmoflow-512 (512^3 x 4 input, 7 blocks), batch 1, fp32,
              also held against the plain forward; peak device memory.
6. harness  — ``serve(max_batch=4, max_wait_ms=50)`` on 16 cosmoflow-128
              requests; every future resolves.
7. spatial  — the same models with depth split over S shards, every
              shard on this card (``devices=["cuda:0"] * S``, one stream
              each): cosmoflow-128 batch 4 S=2 fp32 and bf16, S=4 fp32,
              cosmoflow-512 batch 1 S=4 fp32 (peak memory), and
              cosmoflow-128 S=2 under a plan that splits all 7 blocks
              (the path that launches unpack). Each is held against the
              unsharded forward of phases 4-5 (same seed, same input) and
              against its own forward through the plain versions, and
              its launches of conv3d, bn_act, pack and unpack per forward
              against the counts ``kernel_launches`` derives from its
              plan.
8. harness  — ``serve()`` on the cosmoflow-128 S=2 session, 8 requests.
9. timings  — per kernel at the main paths' shapes (CUDA events, median):
              kernel, bound, plain version and library call (conv3d: its
              device time per call, calls queued back to back, and the
              single call's time, for the kernel and for F.conv3d; which
              of its two kernels and how many K splits; the share of the
              bound; the per-forward sums against F.conv3d; pack and
              unpack at every face of the spatial configs and of
              unet3d-256 b1 at S = 2, 4 in fp32 and bf16, each beside
              torch.cat, its byte bound, the launch floor and its share
              of the bound); end-to-end
              predict time per batch, unsharded and spatial; the
              overlapped conv lowering against the blocking one
              (``overlap_halo=False``) at cosmoflow-128 S=2, S=4 and
              cosmoflow-512 S=4; one profiled predict per config (device
              busy time, idle share, time by kernel name).
10. train   — ``repro_torch.api.compile(RunConfig(model="cosmoflow-128",
              mode="train", global_batch=4))``: 5 Adam steps in fp32 and 3
              in bf16 on a seeded batch with seeded dropout masks, then
              cosmoflow-512 batch 1 fp32, 2 steps, which must fit on the
              card (peak memory allocated and reserved); every loss
              finite; per step exactly 7 conv3d, 6 conv3d input-gradient
              (the same kernel) and 7 bn_act launches, no pack/unpack.
              Step 1's loss and every gradient are held against the same
              step through the plain versions, autograd through them
              directly, and against the step in fp64 (bounds: ``STEP1_*``;
              fp32: from the fp64 step that takes the kernel step's
              leaky-ReLU signs and pool winners, ``decisions``, within
              1e-4 of each leaf's max-abs or within the plain fp32 step's
              own distance from fp64, whichever is larger; bf16 no
              farther from fp64 than 1.5x the plain bf16 step). Timed:
              ms per step (host clock, median of 3), the forward/
              backward/optimizer split (the train step's phase probes,
              CUDA events), one profiled step, peak memory; each input
              gradient, held against autograd through the plain conv
              (fp32 1e-6 sqrt(k^3 Cout) of the scale, bf16 2^-7), beside
              ``torch.nn.grad.conv3d_input``, and each weight gradient
              beside ``torch.nn.grad.conv3d_weight``.
10b. train_spatial — hybrid data x spatial training of cosmoflow-128 b4,
              every shard on this card (``devices=["cuda:0"] * n``), 3
              steps in each of ``TRAIN_SPATIAL``: (a) fp32 1 x 2, (b) fp32
              1 x 4, (c) fp32 2 x 2 with ``overlap`` and with
              ``monolithic``, (d) bf16 1 x 2, (e) fp32 1 x 2 under the plan
              that splits all 7 blocks (unpack and its adjoint). Step 1's
              loss and reduced gradients (the ``grad_comm`` probe) held
              against the unsharded step: fp32 against the fp64 step that
              takes the sharded step's leaky-ReLU signs and pool winners
              (gathered from the shards), within max(1e-4, the plain fp32
              step's own distance from fp64) of each leaf's max-abs; bf16
              no farther from fp64 than 1.5x the plain bf16 step; losses
              1e-4 and 5e-2. Launches per step of conv3d, its input
              gradient, bn_act, pack and unpack equal to
              ``kernel_launches(train=True)``; 2 x 2 overlap against
              monolithic after 2 steps (atol 1e-5, rtol 1e-4). Timed: ms
              per step (host clock, median of 3), the probes' fwd / bwd /
              grad_comm / step split, peak memory. Each part runs under a
              wall-clock limit, so a deadlocked backward fails the run.
              With every shard on one card the times are the sharded
              step's overhead, not scaling.
10c. unet_serve — ``compile(RunConfig(model="unet3d-256", mode="infer",
              global_batch=1))``, fp32 and bf16 unsharded, fp32 at S = 2
              and S = 4 (every shard on this card): per-voxel logits (1,
              256, 256, 256, 3) against the same forward through the
              plain versions (fp32 1e-4, bf16 5e-2 of the logits' scale),
              S > 1 against unsharded (fp32 1e-5), launches per forward
              against ``unet3d.kernel_launches``; the harness serves 4
              volumes (one a batch) with none failed. Timed: predict
              (median of 3), its peak memory, one profiled predict.
10d. unet_long_k — the fp32 error against fp64 of dec2_w0's forward
              and mid_w1's input gradient (K = 13,824) at their 256^3
              shapes, within 1e-6 sqrt(K), with the K split ``ops.plan``
              chose; then conv3d and bn_act at each conv of a 256^3 b1
              forward (fp32, bf16) against F.conv3d and the bound.
10e. unet_train (run right after phase 3, while the allocator holds
              nothing) — step 1 at unet3d-256's widths and depth on a 64^3
              input, batch 2, against the plain and fp64 steps
              (``step1_vs_plain``); then unet3d-256 b1 at 256^3, fp32 and
              bf16, a warm-up and 3 steps each: ms per step, peak memory
              allocated and reserved (it must fit the card with the
              default allocator settings), launches per step against
              ``kernel_launches(train=True)``; the probes' split and one
              profiled step.
10f. train_spatial_unet — phase 10b's checks on the U-Net at 64^3 b2:
              (u-a) fp32 1 x 2, (u-b) fp32 1 x 4 (its bottleneck has no
              interior: unpack and its adjoint), (u-c) fp32 2 x 2 overlap
              and monolithic, (u-d) bf16 1 x 2.
10g. train_remat (run right after 10e) — cosmoflow-128 b4 fp32 at 1 x 1,
              1 x 2 and 1 x 2 with all 7 blocks split (the recompute
              unpacks): step 1 (the ``grad_comm`` probe) with every
              stage rematerialized against the same step without (loss
              1e-5, each reduced gradient atol 1e-5 rtol 1e-4: the
              reference's contract), whether the two are bitwise equal,
              launches against ``kernel_launches(train=True)`` with the
              recompute counted, the peak memory and ms per step of both;
              then, every stage rematerialized, cosmoflow-512 b2 (2
              steps; then again without remat), cosmoflow-512 b1 and
              unet3d-256 b1 at 256^3: losses finite, launches, ms per
              step and peak memory, and after phase 10 the 512^3 b1 and
              256^3 runs beside the same steps without remat (10, 10e).
10h. train_io — 8 synthetic cosmoflow-128 volumes written to a temporary
              store; ``Session.make_loader`` at prefetch 0 and 2, at 1 x 1
              and 1 x 2: the batches bitwise equal across loaders, 4
              steps from each (two epochs) with bitwise equal losses at
              each degree, each rank's store bytes (half a volume a
              sample at S = 2; plus one row of each neighbour with
              ``halo_voxels=1``), launches against ``kernel_launches``;
              ms per step with its load, and ``io_stall_s``.
10z. train_zero1 — ZeRO-1 (``grad_comm="reduce_scatter"``) at cosmoflow-
              128 b4, every shard on this card: fp32 2 x 1, 4 x 1, 2 x 2
              and bf16 2 x 2, each against ``overlap`` from the same
              parameters after 2 steps (atol 1e-5, rtol 1e-4; whether
              bitwise), launches against ``kernel_launches(train=True)``,
              each shard's optimizer state exactly its 1/N of every
              padded bucket (spatial peers equal); ms per step and the
              probes' split of both at 2 x 2; fp16 at 2 x 1 with a NaN in
              one data index's rows vetoed on every shard by the guard; a
              ZeRO-1 checkpoint restored on the card, resuming bitwise.
              10z-u: the same against ``overlap`` for the U-Net at 64^3
              b2, 2 x 2, with its timings (after 10f).
10p. plans  — the cost-model planner's layouts, every shard on this
              card: the all_to_all bitwise its oracle at the planned
              boundaries; training cosmoflow-128 b4 fp32 under the b1/b2 batch
              plans and the uniform batch plan (1 x 2; b1 and b2 at 1 x
              4) beside the fixed plan of each mesh, and the U-Net at
              64^3 b2 under its b1 batch plan, with phase 10b's checks
              and timings (beside ``describe().predicted_step_s``) and
              overlap against ZeRO-1 after 2 steps; ``plan="auto"`` and
              ``memory_budget_gib`` (the chosen plan, its modeled peak,
              the measured own peak; a budget below the floor raises
              naming it); batch-sharded serving of cosmoflow-128 b4 at
              data 2 and 2 x 2 against data 1, and the U-Net's batch plan
              served at 256^3 b2 S = 2 against its fixed plan.
10s. supervise — the auto-resume supervisor at cosmoflow-128 b4 fp32
              (``SUP_*``): 1 x 1, 6 steps, checkpoints every 2, without a
              fault (launches exactly 6 steps' ``kernel_launches``) and
              with ``device.loss`` at step 4, bitwise equal (losses, every
              parameter), with ``recovery_s``; ``comm.stall`` of 0.8 s at
              step 3 under a 0.5 s watchdog (one restart);
              ``grads.nonfinite`` at steps 3-5, patience 3 (one rollback);
              a flipped byte in the newest checkpoint's leaf walked past;
              2 x 2 ZeRO-1 on this card killed and resumed bitwise, and
              re-degreed to 1 x 2 by ``available=2`` (finite losses, the
              state carried over). ``Session.report()`` (the drift table:
              the time model on the H100 beside the probes' spans and two
              loader batches) at 1 x 1, 1 x 2 and 1 x 2 with every block
              split (unpack), each row printed; ``repro_torch.launch.train
              --arch cosmoflow-128 --full-config`` for 3 steps and the
              quickstart for 2 (cosmoflow-512's smoke variant, whose conv
              and bn_act shapes phase 3 checks too).
10q. train_pipeline (run right after 10g) — the pipeline axis, two
              device groups on this card at the boundary ``plan="fixed"``
              prices cheapest on the H100 (beside the V100's pick),
              pinned for both schedules: step 1 of cosmoflow-128 b4 (one
              shard a group, M = 4, fp32 and bf16) and of the U-Net at
              64^3 b2 (M = 2, on phase 10e's batch) through the
              pipelined step against the plain versions and fp64 (phase
              10's gates, the U-Net's decision-aware bf16 gate; the
              oracle is the micro-batches one after another on one
              device, and the pipelined step's probe must lie within
              1e-5 of it); M = 1 against the unpipelined step of the same
              data degree (1 and 2 shards, loss and every leaf 1e-5,
              whether bitwise). Main path: cosmoflow-128 b4 at 1 shard a
              group (M = 4) and 2 (M = 2), fp32 1F1B and sequential x
              overlap and monolithic, bf16 1F1B overlap; unet3d-256 at
              256^3 b2, M = 2, one shard a group, fp32 1F1B and
              sequential; 2 steps each from the same parameters,
              bitwise between schedules and lowerings, launches a step
              against ``kernel_launches(train=True)``; ms a step (median
              of 3 after a warm-up) of the fp32 overlap runs and the
              U-Net's, peak memory (256^3 b2 must fit). After:
              ``Session.profile`` (``pipeline_speedup``), ``describe()``
              (bubble, predicted step) and ``report()``'s drift table
              at cosmoflow-128 b4, one shard a group.
10w. procmesh — the process mesh (one process a shard, collectives
              through ``torch.distributed``), 4 spawned processes
              (``launch.dist.Pool``), every rank on this card, so the
              transport is gloo (NCCL refuses two ranks on one card; it
              runs only where ``torch.cuda.device_count()`` >= the world
              size, else one line says it did not run). cosmoflow-128 b4
              training (``PROCMESH_TRAIN``: fp32 1 x 2 and 2 x 2 under
              ``overlap`` and ``monolithic``, bf16 1 x 2) and the U-Net at
              64^3 b2 1 x 2, each against the in-process mesh at the same
              degrees on this card: step 1's ``grad_comm`` probe per leaf
              (fp32 within 1e-5 of its max-abs; bf16 no farther from the
              in-process step than 1.5x the in-process step through the
              plain versions), 2 steps' losses, and whether probe, losses
              and parameters are bitwise; serving at S = 2 (cosmoflow-128
              b4, unet3d-256 b1 at 256^3) against the unsharded forward
              (1e-5); each rank's launches summed against
              ``kernel_launches``; ms a step or predict beside the
              in-process mesh's, each rank's peak. Then ZeRO-1, remat
              and pipeline groups over processes (``PROCMESH_COMPOSE``),
              each bitwise the in-process mesh at the same plan or the
              run fails: ZeRO-1 2 x 2 at 128^3 b4 fp32 and bf16 (each
              rank's state exactly 2 x 4 x padded / N bytes a bucket,
              its CRCs the in-process shard's; the fp32 run saves a
              checkpoint over processes, restores it and steps: files,
              loss and parameters the in-process run's), remat 1 x 2
              with every block split, two pipeline groups of one shard
              (M = 4) and of two (M = 2), 1F1B and sequential; the U-Net
              at 64^3 b2 ZeRO-1 2 x 2, remat 1 x 2 and two groups (M =
              2); each rank's modeled peak beside its measured one. A
              child that fails or does not answer within
              ``PROCMESH_LIMIT_S`` fails the run (its threads' stacks
              printed). Then the ``PROCMESH_IO`` runs, each against the
              in-process mesh: (a) the per-rank loader, cosmoflow-128 b4
              at 1 x 2 and 2 x 2 and the U-Net at 64^3 b2 1 x 2 from a
              store of 8 volumes the run writes, synchronous and with
              prefetch 2: each rank's blocks bitwise its slice of the
              in-process loader's batch, its store bytes over the first
              epoch exactly 1/S of a volume a sample of its rows, 4
              loader-fed steps' losses and the parameters bitwise, the
              synchronous run's launches summed over the ranks against
              ``kernel_launches``; load + step ms and ``stall_s`` beside
              the in-process loader's. (b) the harness, cosmoflow-128
              S = 2, 16 one-volume requests at ``max_batch=4`` (rank 0
              the front end, rank 1 following): 16/16 served, 0 failed,
              each prediction within 1e-5 of the unsharded forward of
              its batch, launches against ``kernel_launches`` x 4, p50
              latency beside the in-process harness's. (c) the
              supervisor, loader-fed cosmoflow-128 b4 2 x 2 ZeRO-1, 6
              steps: a crash at step 3 on every rank and a persistent
              ``loader.read`` error on rank 1 alone, the losses and
              parameters bitwise the in-process unfaulted run's,
              ``recovery_s`` printed; then ``DeviceLost(available=2)``
              on rank 2 alone: ranks 0-1 re-plan to 1 x 2 with finite
              losses and the in-process supervisor's events, ranks 2-3
              are released. Then the ``PROCMESH_PLANS`` runs (the
              cost-model planner over processes), each bitwise the
              in-process run of the same config or the run fails:
              cosmoflow-128 b4 fp32 1 x 2 pinned ``b1_batch`` under
              ``overlap`` and ``reduce_scatter`` and ``plan="auto"``,
              1 x 4 ``plan="auto"``; a 1.0 GiB budget at data =
              spatial = 1 over the 4 ranks, at b4 (the in-process
              ``PLANS_AUTO`` budget run's plan, bf16 ``b1_batch`` on
              every rank)
              and at b2 (its plan on ranks 0-1, ranks 2-3 released: no
              launch, no subgroup, nothing on the card), with each
              rank's modeled peak beside its measured one (allocated,
              less what its process held before); the U-Net 64^3 b2
              1 x 2 ``b1_batch``; the per-rank loader under
              ``uniform_batch`` (whole volumes of a rank's own samples:
              1/(D x S) of the bytes); the U-Net's 256^3 b2 S = 2
              ``b1_batch`` serving; the harness, 16 one-volume requests
              at S = 2 under ``plan="auto"``; the supervisor, a pinned
              ``b1_batch`` 2 x 2 ZeRO-1 loader-fed run losing a device
              on rank 2, re-planned (``"auto"``) to 1 x 2 on ranks 0-1
              with the in-process elastic run's events, losses,
              parameters and plan, ranks 2-3 released. Launches summed
              over the ranks against ``kernel_launches``.
m.  memory_model — every measured peak of phases 5, 10, 10c, 10e, 10g
              and 10q's U-Net (512^3 b2 now also without remat) beside
              the session's ``describe().modeled_peak`` (``core/memory.py``,
              a pipelined plan's: its largest group's), and the
              serving peak at 128^3 b4 (``measured_peak_bytes``, after
              phase 4's path is read): modeled over allocated and over
              reserved. No gate.
11. ssd     — the SSD scan kernel against its plain (sequential) version
              at the shapes of ``tests/test_kernels.py``, a ragged L and
              the layer shapes of mamba2-370m (B=4, L=4096, H=32, P=64,
              N=128, chunk 256) and zamba2-1.2b (H=64, N=64), fp32 (3e-4
              rtol/atol; at the layer shapes 3e-4 of the output's scale)
              and bf16 (2e-2 of the output scale); at mamba2-370m's layer
              shape, x, B and C as views of one
              (B, L, H*P + 2N) buffer (as the Mamba2 block passes them) give
              the bits contiguous copies give, and a second call the same
              bits.
12. score   — mamba2-370m at full width (48 layers, seeded random
              weights): ``ssm_lm.lm_loss`` on 4 x 4096 tokens in fp32 and
              bf16 and on 1 x 32768 in fp32 — time (median of 3), tokens/s,
              peak memory, loss, exactly 48 ssd_scan launches per forward;
              logits held against the same forward through the plain
              chunked scan (fp32 1e-3, bf16 0.25 of the logits' scale) and
              against that forward in fp64 (the kernel no more than 2x as
              far from it as the plain forward: see ``phase_score``).
13. decode  — ``serve.lm.generate``, greedy, 4 prompts of 64 tokens, 16
              new tokens, fp32; prefill's last logits and 16 teacher-forced
              decode steps held against the kernel forward (5e-4 rtol/atol);
              decode ms per token.
13b. lm_families — every LM family at its published width, seeded weights
              drawn on the card, under ``torch.inference_mode``: zamba2-1.2b
              at full depth (38 Mamba2 blocks, the shared attention block
              applied 6 times) through phases 12-13's checks at 4 x 4096
              fp32 and bf16 (38 ssd_scan launches per forward; useful
              FLOP/s from ``launch.specs.model_flops``); then one lm_loss
              each (``LM_FAMILIES``: ms, median of 3; tokens/s, useful
              FLOP/s, peak; no kernel launched) of qwen1.5-0.5b, phi3-mini,
              phi3-vision (1,024 image + 3,072 text tokens), gemma2-2b (1 x
              8192, past its 4096 window), hubert-xlarge (4096 synthetic
              frames) at full depth in fp32, and, cut in depth to what the
              card holds, phi3.5-moe (4 of 32 layers, fp32), arctic-480b (1
              of 35, bf16), llama3-405b (2 of 126, bf16); each one's
              logits (and MoE aux loss) against the same forward in fp64
              on the same weights (the MoE layers through ``plain_moe``
              on the run's expert choices; gemma2-2b on its first 4,608
              positions, llama3-405b on 1 layer: ``LM_FP64_CUT``), within
              1e-3 (fp32) and 0.05 (bf16) of the logits' scale;
              qwen1.5-0.5b's and gemma2-2b's prefill and 16 teacher-forced
              decode steps against the forward (3e-4 rtol/atol).
13c. lm_train — language-model training, fp32, seeded weights drawn on
              the card, ``flags.REMAT`` on (each Mamba2 block and
              transformer layer rematerialized; the SSD scan's backward
              the plain chunked recompute, ``ops.SSDScan``), the
              launcher's Adam (warmup_cosine(3e-3, 10), clip 1.0) on its
              ``make_token_dataset`` batches (``LM_TRAIN``): mamba2-370m
              4 x 4096 and zamba2-1.2b 1 x 4096 at full depth,
              qwen1.5-0.5b 1 x 4096, phi3.5-moe cut to 1 of 32 layers
              (the functional Adam holds 7 copies of the weights); a
              warm-up and 3 timed ``make_lm_train_step`` steps: ms a step
              (median), tokens/s, useful TFLOP/s (``model_flops``' train
              convention), peak allocated and reserved, every loss;
              ssd_scan launches a step exactly ``kernel_launches(cfg,
              train=True)`` (96 and 76: forward and recompute; 0 for the
              transformers). Step 1's loss and every gradient leaf
              against the fp64 step on the same weights and batch
              (``LM_TRAIN_FP64_CUT``: mamba2-370m's first row, zamba2's
              and phi3.5-moe's first 2048 positions; the MoE layers
              through ``plain_moe`` on the kernel step's expert
              choices): the transformers within 1e-3 of each leaf's
              scale, the SSM configs no farther than max(1e-3, 2x the
              plain-scan step's distance), the loss 1e-4 relative;
              remat against none at mamba2-370m 1 x 4096 (2e-5, and
              whether bitwise). Then ``launch.train`` (3 steps of
              mamba2-370m's SMOKE) and ``examples/serve_lm`` (3 training
              steps, then greedy generation) on ``cuda:0``; after the
              phase, the SSD backward's ms and peak at both layer shapes.
13d. lm_sharded — (run after phase 14's timings, phase 12's weights
              freed) the sharded language models over an in-process mesh,
              every shard on this card (``devices=["cuda:0"] * n``), fp32,
              TF32 off, ``flags.REMAT`` on, weights drawn seeded on the
              card, the launcher's batches (``LM_SHARDED``; each run's
              plan is ``configs.plan_for`` of its arch at an input
              shape): qwen1.5-0.5b 1 x 4096 under ``tp`` (train_4k) and
              ``cp`` (decode_32k) at 1 x 2,
              mamba2-370m 1 x 4096 under ``tp`` (gathered projections,
              whole-sequence kernel scans) and ``cp`` (``cp_ssd`` on the
              kernel, the conv's halo), zamba2-1.2b (12 of 38 layers)
              and gemma2-2b (one local/global pair; its 4096 window
              crosses the shard boundary: one hop) under ``cp``,
              phi3.5-moe (1 layer) under ``ep`` (``moe_ffn_ep``'s two
              ``all_to_all``s). Each: step 1's loss (2e-4 absolute) and
              EVERY gradient leaf (1e-4 of its max-abs) against the
              unsharded step on the same weights and batch, then the
              parameters after ``make_lm_train_step``'s first step
              against one Adam step of the unsharded gradients (rtol
              3e-3, atol 3e-4; an element whose unsharded gradient lies
              within the gradient gate of zero may move by up to 2 lr:
              its sign rests on rounding). An SSM config's leaves may
              lie up to 2 x the unsharded plain-scan step's own distance
              from the kernel step (phase 12's rule); its dataflow is
              held apart from the kernel's rounding by the sharded step
              with the plain scan against the unsharded plain-scan step
              in fp64 (the first ``LM_SHARDED_FP64_POSITIONS``
              positions) at 2e-4 / 1e-4, and in fp32 under the kernel
              step's rule.
              phi3.5-moe's unsharded side computes ``moe_ffn_ep``'s
              arithmetic (each shard's block of the sequence routed
              alone) with its own top-k (``ep_moe``): a token whose
              choices differ from the sharded run's must be a near tie
              (``LM_SHARDED_TIE``) and takes the sharded choices; any
              other fails. That step is the warm-up of
              LM_SHARDED_STEPS timed steps: ms a step (median),
              tokens/s, peak allocated and reserved, each collective a
              step and shard (``counting_collectives``), 13c's unsharded
              ms where it ran the same config; ssd_scan launches exactly
              ``kernel_launches(train=True)`` a shard a step (192 for
              mamba2-370m at 1 x 2 under either plan: a cp run that
              launched none would have fallen back to the plain scan).
              Serving (``LM_SHARDED_SERVE``): qwen1.5-0.5b under ``cp`` 1 x
              2, a 4064-token prefill and 32 greedy steps over the
              S-sharded cache (4096 slots, 2048 a shard), zamba2-1.2b a
              64-token prompt and 32 steps: the tokens equal the
              unsharded ones, the first step's logits within 1e-4 of
              their scale. Then ``launch.train --arch qwen1.5-0.5b
              --data 1 --model 2 --plan tp --steps 3 --device cuda:0``
              (SMOKE). The phase prints its seconds.
14. timings — ssd_scan at both layer shapes: kernel, plain version, plain
              chunked scan, bounds (of ``ssd_work`` on the tensor cores, of
              the arithmetic the kernel executes, on the CUDA cores), each
              of its CUDA kernels' time (median over 5 profiled calls);
              one profiled mamba2-370m forward in fp32 and one in bf16.

Phases 4-6, 7-8, 10 (the training steps), 10b (the sharded training
steps), 10c, 10e and 10f (the U-Net's), 10g, 10q, 10h, 10z, 10z-u, 10p,
10s, 10w (each rank's counters, summed), 12-13, 13b, 13c and 13d are
the main paths:
the launch counters are zeroed just before each and read just after. The next-to-last line is the
``{"kernels": [...]}`` summary and the last line the device record.
Exits non-zero without a CUDA device or without the repository beside
it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
# published H100 SXM peaks (dense): fp32 on the CUDA cores, bf16 and TF32
# on the tensor cores, and HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
LONG_CALL_MS = 2000.0  # median_ms times a call this long once
PEAKS_USED = ("bound = max(FLOPs / peak, bytes / 3.35 TB/s); peak = "
              "67 TFLOP/s fp32 (CUDA cores: bn_act), 989 TFLOP/s bf16 "
              "(tensor cores); conv3d and ssd_scan fp32 run as 3xTF32 on the "
              "tensor cores: 3 x FLOPs / 495 TFLOP/s (the CUDA-core bound, "
              "FLOPs / 67 TFLOP/s, beside it as bound_cuda_core_ms); "
              "ssd_scan also beside the bound of the arithmetic it executes "
              "(bound_executed_ms: its whole tiles, 3 TF32 products in fp32, "
              "3 bf16 products for each computed operand in bf16); each "
              "input read once, each output written once")
CONV_GRID = [((2, 10, 10, 10, 3), 3, 8, 1), ((1, 9, 9, 9, 4), 3, 16, 2),
             ((2, 12, 8, 8, 8), 5, 4, 1), ((1, 6, 6, 6, 2), 1, 8, 1),
             ((1, 7, 7, 7, 16), 3, 32, 1)]
BN_GRID = [(2, 5, 5, 5, 16), (4, 7, 3, 3, 32), (1, 128, 8)]
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# (model, batch, spatial degree, precision, plan): "deep" splits depth in
# every conv block; "fixed" is the legacy plan (gathered where a block's
# local width would drop below 4)
SPATIAL = (("cosmoflow-128", 4, 2, "fp32", "fixed"),
           ("cosmoflow-128", 4, 2, "bf16", "fixed"),
           ("cosmoflow-128", 4, 4, "fp32", "fixed"),
           ("cosmoflow-512", 1, 4, "fp32", "fixed"),
           ("cosmoflow-128", 4, 2, "fp32", "deep"))
# extra halo cases beyond the main path's: k = 5 (lo = hi = 2), and a
# depth row of 3*5*3 fp32 = 180 bytes, not a multiple of 16
HALO_EXTRA = (((2, 8, 16, 16, 8), 2, 2), ((2, 6, 3, 5, 3), 1, 1))
# the edges of the halo copy's work split (tests/test_torch_cuda.py holds
# the kernel at them too): a run shorter than a chunk; not a multiple of
# one (40,000-byte rows); many chunks a run (1 MB runs); lo = 0 and hi = 0
# alone; 7-element rows (14 bytes in bf16); more runs than a grid's
# y-dimension once took (3 x 30,000)
HALO_EDGES = (((2, 4, 4, 4, 8), 1, 1), ((2, 5, 25, 25, 16), 2, 1),
              ((1, 6, 64, 64, 16), 2, 2), ((2, 6, 8, 8, 8), 0, 2),
              ((2, 6, 8, 8, 8), 2, 0), ((2, 5, 1, 1, 7), 1, 2),
              ((30000, 3, 1, 2, 2), 1, 1))
# the halo kernel's vector counts a thread (its three instantiations),
# each held by patching ``kernels/halo_pack/ops.REG_VECTORS``
HALO_VECTORS = (4, 2, 1)
# "conv3d_dgrad": the conv3d kernel launched for a conv's input gradient
# (counted apart from the forward's launches)
KERNELS = ("conv3d", "conv3d_dgrad", "bn_act", "pack", "unpack", "ssd_scan")
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)
# (model, batch, precision, steps, whether step 1 is held against the
# plain step: not at 512^3, where autograd through the plain conv would
# save a copy of the input per tap)
TRAIN = (("cosmoflow-128", 4, "fp32", 5, True),
         ("cosmoflow-128", 4, "bf16", 3, True),
         ("cosmoflow-512", 1, "fp32", 2, False))
# Step 1 against the plain step and the fp64 step (``phase_train``;
# measured by scripts/train_accuracy.py, PERF.md §6). A step's gradient
# jumps wherever rounding flips one of its discrete decisions (a
# leaky-ReLU's sign, a pool's winner: ``decisions``), so two fp32 steps
# that differ only in summation order lie up to ~5e-3 of a leaf apart in
# blocks 0-2; the plain fp32 step itself lies up to 2.5e-3 from fp64
# there. fp32: the error the kernels' arithmetic adds — the kernel step's
# distance from the fp64 step that takes the kernel step's decisions —
# must stay within STEP1_FP32 of each leaf's max-abs or within the plain
# fp32 step's own distance from fp64 (its decisions its own), whichever
# is larger. bf16: both steps lie 0.03-1.1 of a leaf from fp64, so each
# leaf of the kernel step must lie no farther from fp64 than STEP1_BF16 x
# the plain bf16 step does (the U-Net's bf16 gate: ``step1_vs_plain``).
# The loss: STEP1_LOSS relative to the plain step's.
STEP1_FP32 = 1e-4
STEP1_BF16 = 1.5
STEP1_LOSS = {"fp32": 1e-4, "bf16": 5e-2}
# hybrid training of cosmoflow-128 b4, every shard on this card:
# (configuration, data, spatial, precision, grad_comm, plan)
TRAIN_SPATIAL = (("a", 1, 2, "fp32", "overlap", "fixed"),
                 ("b", 1, 4, "fp32", "overlap", "fixed"),
                 ("c", 2, 2, "fp32", "overlap", "fixed"),
                 ("c", 2, 2, "fp32", "monolithic", "fixed"),
                 ("d", 1, 2, "bf16", "overlap", "fixed"),
                 ("e", 1, 2, "fp32", "overlap", "deep"))
SPATIAL_STEPS = 3
# phase 10w: (tag, data, spatial, precision, reduction) of cosmoflow-128
# b4 over processes, every rank on this card; the U-Net at 64^3 b2 1 x 2
# is added in the phase
PROCMESH_TRAIN = (("pm-a", 1, 2, "fp32", "overlap"),
                  ("pm-a", 1, 2, "fp32", "monolithic"),
                  ("pm-b", 2, 2, "fp32", "overlap"),
                  ("pm-b", 2, 2, "fp32", "monolithic"),
                  ("pm-c", 1, 2, "bf16", "overlap"))
# the U-Net at 64^3 b2: (data, spatial, precision, reduction); serving:
# (model, batch, spatial), fp32, against the unsharded forward
PROCMESH_UNET = ((1, 2, "fp32", "overlap"),)
# ZeRO-1, remat and pipeline groups over processes: (tag, model, data
# (the total over a pipeline's groups), spatial, precision, grad_comm,
# plan kind, micro-batches, schedule); "remat-deep" is every block split
# and rematerialized, "pipe" the two-group plan of ``pipe_plan``
PROCMESH_COMPOSE = (
    ("pz-a", "cosmo", 2, 2, "fp32", "reduce_scatter", "fixed", 1, None),
    ("pz-b", "cosmo", 2, 2, "bf16", "reduce_scatter", "fixed", 1, None),
    ("pr-a", "cosmo", 1, 2, "fp32", "overlap", "remat-deep", 1, None),
    ("pp-a", "cosmo", 2, 1, "fp32", "overlap", "pipe", 4, "1f1b"),
    ("pp-a", "cosmo", 2, 1, "fp32", "overlap", "pipe", 4, "sequential"),
    ("pp-b", "cosmo", 4, 1, "fp32", "overlap", "pipe", 2, "1f1b"),
    ("pp-b", "cosmo", 4, 1, "fp32", "overlap", "pipe", 2, "sequential"),
    ("pz-u", "unet", 2, 2, "fp32", "reduce_scatter", "fixed", 1, None),
    ("pr-u", "unet", 1, 2, "fp32", "overlap", "remat", 1, None),
    ("pp-u", "unet", 2, 1, "fp32", "overlap", "pipe", 2, "1f1b"))
# the runs that save a checkpoint over processes, restore it and step
PROCMESH_CHECKPOINT = ("pz-a",)
PROCMESH_SERVE = (("cosmoflow-128", 4, 2), ("unet3d-256", 1, 2))
PROCMESH_WORLD = 4
PROCMESH_STEPS = 2
# timed steps a phase-10w run adds after a warm-up (no gate reads them;
# a step over processes takes ~0.2-0.7 s)
PROCMESH_TIMED = 1
PROCMESH_FP32 = 1e-5  # a leaf's share of its max-abs, and the losses
PROCMESH_LIMIT_S = 300
# phase 10w's PROCMESH_IO runs, every rank on this card over gloo: the
# per-rank loader, (tag, model, data, spatial), cosmoflow-128 b4 and the
# U-Net at 64^3 b2, each synchronous and with a prefetch queue of
# PROCMESH_IO_PREFETCH, from a store of PROCMESH_IO_SAMPLES volumes the
# run writes; the harness, (requests, max_batch, spatial); the
# supervisor, (data, spatial, steps, save_every), ZeRO-1 and loader-fed
PROCMESH_IO = (("io-a", "cosmo", 1, 2), ("io-b", "cosmo", 2, 2),
               ("io-u", "unet", 1, 2))
PROCMESH_IO_SAMPLES = 8
PROCMESH_IO_STEPS = 4
PROCMESH_IO_PREFETCH = 2
PROCMESH_IO_SERVE = (16, 4, 2)
PROCMESH_IO_SUPERVISE = (2, 2, 6, 2)
# phase 10w's PROCMESH_PLANS runs, every rank on this card over gloo, each
# gated bitwise against the in-process run of the same config: training
# (tag, model, batch, data, spatial, precision, grad_comm, plan), the plan
# a kind of PLAN_KINDS, "auto", or a memory budget in GiB over a world of
# PROCMESH_WORLD ranks at data = spatial = 1 ("auto" precision: the
# planner's); the per-rank loader (tag, model, data, spatial, plan kind),
# as PROCMESH_IO; the U-Net's serving (tag, batch, spatial, plan kind) at
# 256^3; the harness (requests, max_batch, spatial) under plan="auto";
# the supervisor (data, spatial, steps, save_every, plan kind), a pinned
# plan losing a device on rank 2. The budget at b4 resolves to bf16
# b1_batch at 1 x 4 (PLANS_AUTO's "budget 1.0 GiB"): that run is the
# bf16 b1_batch run over 4 processes
PROCMESH_PLANS = (
    ("pl-a", "cosmo", 4, 1, 2, "fp32", "overlap", "b1_batch"),
    ("pl-a", "cosmo", 4, 1, 2, "fp32", "reduce_scatter", "b1_batch"),
    ("pl-b", "cosmo", 4, 1, 2, "fp32", "overlap", "auto"),
    ("pl-c", "cosmo", 4, 1, 4, "fp32", "overlap", "auto"),
    ("pl-m", "cosmo", 4, 1, 1, "auto", "overlap", 1.0),
    ("pl-r", "cosmo", 2, 1, 1, "auto", "overlap", 1.0),
    ("pl-u", "unet", 2, 1, 2, "fp32", "overlap", "b1_batch"))
PROCMESH_PLANS_IO = (("pl-io", "cosmo", 1, 2, "uniform_batch"),)
PROCMESH_PLANS_SERVE = (("pl-us", 2, 2, "b1_batch"),)
PROCMESH_PLANS_HARNESS = (16, 4, 2)
PROCMESH_PLANS_SUPERVISE = (2, 2, 6, 2, "b1_batch")
# wall clock a configuration's step-1 check, its steps or its timings
# may take: a backward that deadlocks fails the run instead of hanging it
SPATIAL_LIMIT_S = 240
# overlap against monolithic after 2 steps (tests/test_grad_comm.py)
MODES_ATOL, MODES_RTOL = 1e-5, 1e-4
# planned layouts (phase 10p): one transition each, the spatial group
# turned into batch shards after block (U-Net: level) 1 or 2, or at the
# FC head (core/plan.py::convnet_plan)
PLAN_KINDS = {"b1_batch": dict(boundary=1, kind="batch"),
              "b2_batch": dict(boundary=2, kind="batch"),
              "uniform_batch": dict(boundary=None, kind="batch")}
# phase 10p's training runs at cosmoflow-128 b4 fp32, as TRAIN_SPATIAL,
# beside the fixed plan of each mesh; "p-b" twice: overlap against ZeRO-1
# after 2 steps. No uniform batch plan at 1 x 4: blocks 5-6 are 2 deep
PLANS_TRAIN = (("p-a", 1, 2, "fp32", "overlap", "fixed"),
               ("p-b", 1, 2, "fp32", "overlap", "b1_batch"),
               ("p-b", 1, 2, "fp32", "reduce_scatter", "b1_batch"),
               ("p-c", 1, 2, "fp32", "overlap", "b2_batch"),
               ("p-d", 1, 2, "fp32", "overlap", "uniform_batch"),
               ("p-e", 1, 4, "fp32", "overlap", "fixed"),
               ("p-f", 1, 4, "fp32", "overlap", "b1_batch"),
               ("p-g", 1, 4, "fp32", "overlap", "b2_batch"))
# the U-Net's at 64^3 b2 (UNET_CHECK_*), and its batch plan served at
# 256^3 b2, S = 2, against the fixed plan
PLANS_UNET = (("pu-a", 1, 2, "fp32", "overlap", "fixed"),
              ("pu-b", 1, 2, "fp32", "overlap", "b1_batch"))
PLANS_UNET_SERVE = (2, 2, "b1_batch")  # (batch, spatial degree, plan)
# plan="auto" and memory budgets at cosmoflow-128 b4 (tag, RunConfig
# fields, shards given): the budgets' spatial options are the shards
PLANS_AUTO = (("auto 1x2", dict(spatial=2, plan="auto"), 2),
              ("auto 1x4", dict(spatial=4, plan="auto"), 4),
              ("budget 1.0 GiB", dict(memory_budget_gib=1.0), 4),
              ("budget 1.5 GiB fp32", dict(memory_budget_gib=1.5,
                                           precision="fp32"), 4))
PLANS_FLOOR_BUDGET_GIB = 0.5  # below every candidate's modeled peak
# batch-sharded serving of cosmoflow-128 b4 fp32: (data, spatial, plan)
PLANS_SERVE = ((2, 1, "fixed"), (2, 2, "fixed"), (1, 2, "auto"))
# the 3D U-Net (unet3d-256, 256^3 x 1 input, base 32, depth 3): serving
# at batch 1, (spatial degree, precision), every shard on this card
UNET_SERVE = ((1, "fp32"), (1, "bf16"), (2, "fp32"), (4, "fp32"))
# (spatial degree, precision) of the U-Net's faces in the halo timings
UNET_HALO = ((2, "fp32"), (2, "bf16"), (4, "fp32"), (4, "bf16"))
# training at batch 1: a warm-up, then this many timed steps
UNET_STEPS = 3
# step 1's accuracy and the sharded steps: unet3d-256's widths and depth
# on a 64^3 input at batch 2 (an fp64 step at 256^3 would take ~90 GB)
UNET_CHECK_WIDTH, UNET_CHECK_BATCH = 64, 2
UNET_SPATIAL = (("u-a", 1, 2, "fp32", "overlap", "fixed"),
                ("u-b", 1, 4, "fp32", "overlap", "fixed"),
                ("u-c", 2, 2, "fp32", "overlap", "fixed"),
                ("u-c", 2, 2, "fp32", "monolithic", "fixed"),
                ("u-d", 1, 2, "bf16", "overlap", "fixed"))
# the U-Net's extreme input widths at a small depth (phase 3): enc0_w0's
# Cin = 1 (4-byte gather pieces in fp32, 2-byte in bf16) and dec2_w0's
# Cin = 512 (K = 13,824): (input shape, Cout)
UNET_GRID = (((1, 8, 16, 16, 1), 32), ((1, 4, 8, 8, 512), 256))
# rematerialization (phase 10g): step 1 with every block rematerialized
# against without, at cosmoflow-128 b4 fp32 at these (spatial degree,
# plan) — "deep" splits all 7 blocks, so the recompute unpacks — (the
# reference's contract: loss 1e-5, gradients atol 1e-5, rtol 1e-4);
# then the memory runs, largest first, each (model, batch, steps, every
# stage rematerialized or none): the first step is the warm-up, the rest
# timed
REMAT_PARITY = ((1, "fixed"), (2, "fixed"), (2, "deep"))
REMAT_LOSS, REMAT_ATOL, REMAT_RTOL = 1e-5, 1e-5, 1e-4
REMAT_RUNS = (("cosmoflow-512", 2, 2, True), ("cosmoflow-512", 2, 2, False),
              ("cosmoflow-512", 1, 2, True), ("unet3d-256", 1, 3, True))
# the input pipeline (phase 10h): a store of IO_SAMPLES cosmoflow-128
# volumes, loaders at these spatial degrees and prefetch depths, IO_STEPS
# training steps each (two epochs), and the margin of a halo read
IO_SAMPLES, IO_BATCH, IO_STEPS = 8, 4, 4
IO_S, IO_DEPTHS, IO_HALO = (1, 2), (0, 2), 1
# ZeRO-1 (phase 10z): ``reduce_scatter`` against ``overlap`` after
# ZERO1_STEPS steps from the same parameters and masks, each (precision,
# data, spatial), at cosmoflow-128 b4 and (10z-u) the U-Net at 64^3 b2;
# the reference's tolerance between the modes (tests/test_grad_comm.py)
ZERO1 = (("fp32", 2, 1), ("fp32", 4, 1), ("fp32", 2, 2), ("bf16", 2, 2))
ZERO1_UNET = (("fp32", 2, 2),)
ZERO1_STEPS = 2
# phase 10s: the supervisor at cosmoflow-128 b4 fp32; the drift tables'
# meshes (tag, spatial degree, plan kind)
SUP_BATCH, SUP_STEPS, SUP_EVERY = 4, 6, 2
SUP_ZERO1 = (2, 2)
SUP_WATCHDOG_S, SUP_STALL_S = 0.5, 0.8
SUP_REPORTS = (("1x1", 1, "fixed"), ("1x2", 2, "fixed"),
               ("1x2 all blocks split", 2, "deep"))
# the pipeline axis (phase 10q): two groups at the boundary plan="fixed"
# prices cheapest on the H100. (q-a) cosmoflow-128 b4 fp32 with d = 1
# shard a group (M = PIPE_M, micro-batch 1) and d = 2 (M = PIPE_M2: a
# micro-batch of 1 does not split over 2 shards), 1F1B and sequential x
# overlap and monolithic; (q-b) the same in bf16, 1F1B overlap; (q-c)
# unet3d-256 at 256^3 b2, M = 2, d = 1, 1F1B and sequential. PIPE_STEPS
# steps each from the same parameters; the fp32 overlap runs and the
# U-Net's then go on to a warm-up and PIPE_TIMED timed steps in all
PIPE_BATCH, PIPE_M, PIPE_M2, PIPE_STEPS, PIPE_TIMED = 4, 4, 2, 2, 3
PIPE_RUNS = (("q-a", "fp32", 1), ("q-a", "fp32", 2), ("q-b", "bf16", 1),
             ("q-b", "bf16", 2))
PIPE_UNET_BATCH, PIPE_UNET_M, PIPE_UNET_PREC = 2, 2, "fp32"
# M = 1 against the unpipelined step, and the pipelined step's probe
# against its oracle (the micro-batches one after another on one device,
# both through the kernels): loss (relative) and each gradient leaf (a
# share of its max-abs)
PIPE_M1_TOL = PIPE_ORACLE_TOL = 1e-5
# (B, L, H, P, N, chunk): tests/test_kernels.py's four (B=2), L=40 with
# chunk 16 (lowered to 10), and the layers of mamba2-370m and zamba2-1.2b
# at 4 x 4096 tokens
SSD_SHAPES = ((2, 32, 2, 8, 16, 8), (2, 64, 3, 8, 16, 16),
              (2, 64, 1, 16, 8, 64), (2, 48, 2, 4, 4, 12),
              (2, 40, 2, 8, 16, 16), (4, 4096, 32, 64, 128, 256),
              (4, 4096, 64, 64, 64, 256))
SSD_LAYERS = {"mamba2-370m": SSD_SHAPES[-2], "zamba2-1.2b": SSD_SHAPES[-1]}
SSD_MAIN = SSD_LAYERS["mamba2-370m"]
# (batch, tokens, precision) of the scoring runs: mamba2-370m (phase 12)
# and zamba2-1.2b (phase 13b)
SCORE = ((4, 4096, "fp32"), (4, 4096, "bf16"), (1, 32768, "fp32"))
SCORE_HYBRID = ((4, 4096, "fp32"), (4, 4096, "bf16"))
# phase 13b's transformers at their published widths, one fp32 (bf16
# where the weights are cut) lm_loss each: (arch, batch, text tokens,
# image tokens, precision, layers kept where the card cannot hold them
# all). gemma2-2b at 8192 tokens so that its 4096 window bites; hubert
# on synthetic frame embeddings; phi3-vision on 1,024 image tokens.
LM_FAMILIES = (("qwen1.5-0.5b", 1, 4096, 0, "fp32", None),
               ("phi3-mini", 1, 4096, 0, "fp32", None),
               ("phi3-vision", 1, 3072, 1024, "fp32", None),
               ("gemma2-2b", 1, 8192, 0, "fp32", None),
               ("hubert-xlarge", 1, 4096, 0, "fp32", None),
               ("phi3.5-moe", 1, 4096, 0, "fp32", 4),
               ("arctic-480b", 1, 4096, 0, "bf16", 1),
               ("llama3-405b", 1, 4096, 0, "bf16", 2))
# prefill's last logits and LM_DECODE_STEPS teacher-forced decode steps
# against the forward, 3e-4 rtol/atol (tests/test_models.py:57-90)
LM_DECODE_CHECK = ("qwen1.5-0.5b", "gemma2-2b")
LM_DECODE_STEPS = 16
# each transformer's logits against the same forward in fp64 on the same
# weights and inputs (``vs_fp64``), held to LM_FP64_TOL of the fp64
# logits' scale. The run's own shape, except where the fp64 work does not
# fit beside it: (layers, positions) — the run's first ``layers`` layers
# (a forward of that depth in the run's precision beside it), or its
# first ``positions`` positions (a causal model's logits there depend on
# nothing after them; gemma2-2b's 4,608 still pass its 4,096 window).
LM_FP64_CUT = {"gemma2-2b": (None, 4608), "llama3-405b": (1, None)}
LM_FP64_TOL = {"fp32": 1e-3, "bf16": 0.05}
# phase 13c: training at each (arch, batch, tokens, layers kept where
# the card cannot hold every layer beside Adam's state), fp32, under
# flags.REMAT: a warm-up and LM_TRAIN_STEPS timed steps with the
# launcher's Adam. mamba2-370m at the reference's train_4k sequence, its
# global batch of 256 cut to 4 for one card. phi3.5-moe keeps 1 of its
# 32 layers: the functional Adam update holds the old and new
# parameters and moments and the gradients at once, 7 copies of the
# weights (2 layers, 2.86 B parameters: 80 GB, out of memory on the card)
LM_TRAIN = (("mamba2-370m", 4, 4096, None),
            ("zamba2-1.2b", 1, 4096, None),
            ("qwen1.5-0.5b", 1, 4096, None),
            ("phi3.5-moe", 1, 4096, 1))
LM_TRAIN_STEPS = 3
# step 1 against the fp64 step on the same weights and batch, at the
# run's shape except (batch rows, layers, positions) here: the run's
# first rows, layers or positions, the kernel step taken again at that
# cut beside it. mamba2's fp64 step at 4 x 4096 would hold ~4x the
# memory and time; zamba2's shared attention is not rematerialized (as
# in the reference), and its six applications' score blocks at 4096
# positions took the card's 80 GB in fp64; phi3.5-moe's fp64 weights
# and gradients (25.6 GB) beside the run's and its 4096-position
# recompute in fp64 would leave little room.
LM_TRAIN_FP64_CUT = {"mamba2-370m": (1, None, None),
                     "zamba2-1.2b": (None, None, 2048),
                     "phi3.5-moe": (None, None, 2048)}
# per gradient leaf, max abs diff over the fp64 leaf's max-abs: the
# transformers within 1e-3 (phase 13b's fp32 logits gate); the SSM
# configs no farther from fp64 than max(1e-3, 2x the plain step, which
# takes the plain chunked scan where the kernel ran), as in phase 12;
# the loss within 1e-4 relative
LM_TRAIN_TOL, LM_TRAIN_LOSS_TOL = 1e-3, 1e-4
# remat against none: mamba2-370m at 1 x 4096, full depth, each leaf
# within 2e-5 of its scale (the reference's
# test_scan_unroll_and_remat_match_rolled tolerance)
LM_REMAT_CHECK, LM_REMAT_TOL = ("mamba2-370m", 1, 4096), 2e-5
# the drivers at SMOKE size on the card (phase 13c's end)
LM_DRIVER_ARCH, LM_DRIVER_STEPS = "mamba2-370m", 3
# phase 13d: the sharded language models over an in-process mesh, every
# shard on this card, fp32, under flags.REMAT: (tag, arch, input shape
# whose plan it takes (configs.plan_for), data, model, batch, tokens,
# layers kept where the card or the time budget cannot hold them all). zamba2-1.2b keeps 12 of its 38 layers (2 of its
# 6 shared-attention applications: unsharded at full depth one step took
# 66 GiB, and the check holds an unsharded and a sharded step);
# gemma2-2b one local/global pair of its 26 layers (its 2.6 B fp32
# parameters, gradients and the functional Adam's copies would take the
# card); phi3.5-moe 1 of 32 layers, as in 13c.
# phi3.5-moe runs first, from a clean cache: its functional Adam step
# holds ~58 GiB, and after the other runs the cached segments left too
# little contiguous room beside the rest of the script's tensors
LM_SHARDED = (("p-ep", "phi3.5-moe", "train_4k", 1, 2, 1, 4096, 1),
              ("q-tp", "qwen1.5-0.5b", "train_4k", 1, 2, 1, 4096, None),
              ("q-cp", "qwen1.5-0.5b", "decode_32k", 1, 2, 1, 4096, None),
              ("m-tp", "mamba2-370m", "train_4k", 1, 2, 1, 4096, None),
              ("m-cp", "mamba2-370m", "prefill_32k", 1, 2, 1, 4096, None),
              ("z-cp", "zamba2-1.2b", "prefill_32k", 1, 2, 1, 4096, 12),
              ("g-cp", "gemma2-2b", "train_4k", 1, 2, 1, 4096, 2))
LM_SHARDED_STEPS = 3
# step 1 against the unsharded step on the same weights and batch (the
# reference's tests/test_multidevice.py:210-219): loss absolute, each
# gradient leaf over its max-abs; the parameters after one Adam step
# rtol/atol, except where the unsharded gradient lies within the
# gradient gate of zero (its sign, and so Adam's whole-lr step, rests on
# rounding there), which may move by up to 2 lr
LM_SHARDED_LOSS_TOL, LM_SHARDED_GRAD_TOL = 2e-4, 1e-4
LM_SHARDED_RTOL, LM_SHARDED_ATOL = 3e-3, 3e-4
# an SSM config's kernel step carries the scan's fp32 rounding through
# every block: its leaves may lie as far from the unsharded kernel step
# as twice the unsharded plain-scan step does (phase 12's rule). The
# dataflow is held apart from that rounding by the sharded step with the
# plain scan against the unsharded plain-scan step: in fp64 (the first
# LM_SHARDED_FP64_POSITIONS positions, for time: each shard's block
# still takes the halo and the state carry; the model's few fp32 casts
# leave ~1e-7) at LM_SHARDED_LOSS_TOL and LM_SHARDED_GRAD_TOL, where a
# fault in the plan's dataflow shows at its full size and rounding does
# not; in fp32 under the kernel step's rule (mamba2-370m `cp`'s 48
# blocks carry fp32 rounding to ~3e-4 of the embedding's scale there,
# measured on an H100)
# MoE: the unsharded side routes with its own top-k; a token whose
# choices differ from the sharded run's must be a near tie (at each
# differing place, the two experts' probabilities under the unsharded
# router within LM_SHARDED_TIE; ~100x the rounding of the router's fp32
# logits carried into the probabilities) and takes the sharded choices;
# any other differing token fails the run
LM_SHARDED_TIE = 1e-5
LM_SHARDED_FP64_POSITIONS = 2048
# serving over the S-sharded cache: (arch, input shape whose plan it
# takes, data, model, prompt tokens, new tokens); the tokens equal the unsharded generate's, the
# first step's logits within LM_SHARDED_SERVE_TOL of their scale
LM_SHARDED_SERVE = (("qwen1.5-0.5b", "decode_32k", 1, 2, 4064, 32),
                    ("zamba2-1.2b", "decode_32k", 1, 2, 64, 32))
LM_SHARDED_SERVE_TOL = 1e-4
# the launcher over the mesh at SMOKE size: (arch, plan, data, model,
# steps)
LM_SHARDED_DRIVER = ("qwen1.5-0.5b", "tp", 1, 2, 3)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def median_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` CUDA-event-timed calls, after one warm-up; a
    warm-up of ``LONG_CALL_MS`` or more is the time itself (one-time
    costs are noise beside it, and each rep would add its length)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    if a.elapsed_time(b) >= LONG_CALL_MS:
        return a.elapsed_time(b)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def queued_ms(fn, n: int = 20) -> float:
    """Device time per call of ``fn``, for work too short to hide its own
    launch cost: ``n`` calls enqueued behind a spin kernel
    (``torch.cuda._sleep``, about 3x the time the host takes to enqueue
    them), so the card runs them back to back; CUDA events around the
    ``n`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(3 * host_s * 2e9) + 100_000)  # cycles at <= 2 GHz
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def host_ms(fn, reps: int) -> float:
    """Median host wall time of ``fn`` + synchronize (end to end)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_profile(fn) -> dict:
    """One traced call of ``fn`` (after a warm-up): its wall time, the
    time some kernel ran on the card (union of kernel intervals), the
    idle share, and device time by kernel name (top 8). ``busy_ms`` is
    None when the profiler recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    by_name: dict = {}
    busy, end = 0.0, float("-inf")
    for a, b, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall, "busy_ms": busy / 1e3 if spans else None,
            "idle_share": 1 - busy / 1e3 / wall if spans else None,
            "by_kernel_ms": dict(top)}


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    return (got.float() - want.float()).abs().max().item()


# ------------------------------------------------------------------ bounds --
def conv_work(x_shape, w_shape, out_shape, dtype):
    k3cin = math.prod(w_shape[:4])
    flops = 2.0 * math.prod(out_shape) * k3cin
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = size * (math.prod(x_shape) + math.prod(w_shape)
                     + math.prod(out_shape))
    return flops, nbytes


def ssd_work(B, L, H, P, N, Q, dtype):
    """Operations and bytes one SSD scan needs: C Bᵀ once per chunk
    (shared by the heads) and the decay-weighted product with x, each
    on the lower triangle with its diagonal; the inter-chunk term
    C stateᵀ for every chunk but the first (it enters at zero); each
    chunk's state, xᵀ (B w); the carry over the chunks. Bytes: x, dt,
    A, B, C read once, y and the fp32 state written once."""
    nc = L // Q
    tri = Q * (Q + 1) / 2
    flops = 2.0 * (B * nc * tri * N + B * nc * H * tri * P
                   + B * (nc - 1) * H * Q * N * P + B * nc * H * Q * P * N
                   + B * (nc - 1) * H * P * N)
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = (size * (2 * B * L * H * P + B * L * H + 2 * B * L * N)
              + 4 * H + 4 * B * H * P * N)
    return flops, nbytes


def ssd_executed(B, L, H, P, N, Q, dtype):
    """The tensor-core operations one call of the kernel executes, by its
    tiles (``csrc/ssd_scan.cu``): C Bᵀ in whole 64 x 64 tiles on and
    below the diagonal; the chunk states; C s_inᵀ for every chunk but the
    first; the intra-chunk product in whole tiles below the diagonal and,
    on it, the k steps (8 units: 8 keys in TF32, 16 in bf16) at or below
    each warp's 16 rows. Products: 3 a TF32 product in fp32; in bf16 one
    for C Bᵀ and three (the bf16 parts of the computed operand) for the
    rest.
    Returns (operations, the same count with one product each)."""
    nc, it = L // Q, -(-Q // 64)
    pp, qs = 64 * -(-P // 64), 32 * -(-Q // 32)      # whole p tiles, key slabs
    nk, ns = 32 * -(-N // 32), 128 * -(-N // 128)    # whole n slabs, n tiles
    keys = 8 if dtype == torch.float32 else 16
    steps = sum(min(64 // keys, (16 * w + 15) // keys + 1) for w in range(4))
    cbf = 2.0 * B * nc * it * (it + 1) / 2 * 64 * 64 * nk
    state = 2.0 * B * nc * H * pp * ns * qs
    inter = 2.0 * B * (nc - 1) * H * it * 64 * nk * pp
    intra = 2.0 * B * nc * H * pp * (it * (it - 1) / 2 * 64 * 64
                                     + it * steps * 16 * keys)
    once = cbf + state + inter + intra
    if dtype == torch.float32:
        return 3 * once, once
    return cbf + 3 * (state + inter + intra), once


def bound(flops: float, nbytes: float, dtype, tf32x3: bool = False) -> tuple:
    """The least time for ``flops`` and ``nbytes``; ``tf32x3``: fp32 run as
    three TF32 products on the tensor cores."""
    t_ops = (3 * flops / PEAK_TF32 if tf32x3 and dtype == torch.float32
             else flops / PEAK_FLOPS[dtype]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def device_ms(fn, reps: int) -> tuple:
    """(device time per call, single-call time). The single call is timed
    by CUDA events around it (host time included where the card waits
    for the launch); the device time queues 20 calls back to back behind
    a spin kernel (``queued_ms``), except for calls of 2 ms and more,
    whose launches queue behind each other anyway."""
    call = median_ms(fn, reps)
    return (call if call >= 2.0 else queued_ms(fn)), call


# ------------------------------------------------------------------ phases --
def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(len(out) >= 1, "nvidia-smi listed no card")
    print(out[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f" CUDA {torch.version.cuda}; TF32 off")
    return out[0]


def tensor_core_instructions(lib: str):
    """{kernel: HMMA and HGMMA instructions} in a built library, read with
    the toolkit's ``cuobjdump -sass``; None without a cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return {part.split("\n", 1)[0].strip():
            len(re.findall(r"\bHG?MMA\b", part))
            for part in sass.split("Function : ")[1:]}


def phase_build(build) -> dict:
    t0 = time.perf_counter()
    secs = build.build_all()
    total = time.perf_counter() - t0
    for name in secs:
        regs = sorted({line.split(":", 1)[1].strip()
                       for line in build.build_log(name).splitlines()
                       if "registers" in line})
        log("build", f"{name}: {regs}")
    log("build", f"ok in {total:.1f}s {json.dumps(secs)}")
    tc = tensor_core_instructions(str(build.library_path("ssd_scan")))
    if tc is None:
        log("build", "no cuobjdump: the SSD kernels' instructions not read")
    else:  # chunk_state and chunk_output compute products, in both dtypes
        products = {n: c for n, c in tc.items()
                    if "chunk_state" in n or "chunk_output" in n}
        check(len(products) == 4 and all(products.values()),
              f"ssd_scan kernels without tensor-core instructions: {tc}")
        log("build", "ssd_scan tensor-core instructions by kernel: "
            + json.dumps(tc))
    return {"seconds": total, "per_source": secs,
            "ssd_tensor_core_instructions": tc}


def phase_kernels(conv_ops, conv_ref, bn_ops, bn_ref, conv_shapes) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = {"conv3d": 0.0, "bn_act": 0.0}
    rows = []

    def conv_case(xs, ws, stride, pads, dt, wscale, tol_fn, tag):
        x = torch.randn(xs, generator=g, device="cuda").to(dt)
        w = (torch.randn(ws, generator=g, device="cuda") * wscale).to(dt)
        got = conv_ops.conv3d_valid(x, w, stride, pads)
        torch.cuda.synchronize()
        want = conv_ref.conv3d_valid(x, w, stride, pads)
        err = max_err(got, want)
        tol = tol_fn(want)
        check(err <= tol, f"conv3d {tag} {xs} {dt}: err {err} > tol {tol}")
        rows.append(("conv3d", tag, xs, str(dt), err, tol))
        return err

    for name, dt in DTYPES.items():
        # test_kernels.py's grid and tolerances (weights scaled by 0.1)
        base = 2e-5 if dt == torch.float32 else 2e-2
        for xs, k, cout, s in CONV_GRID:
            conv_case(xs, (k, k, k, xs[-1], cout), s, ((0, 0),) * 3, dt, 0.1,
                      lambda want: base * (
                          1 + want.float().abs().max().item()), "grid")
        # every conv of the main paths (cosmoflow-128 and the quickstart's
        # smoke variant at batch 4), He-scaled weights. fp32:
        # kernel and plain version sum the same k^3*Cin products in another
        # order, an error growing like sqrt(k^3*Cin) * 6e-8 of the output
        # scale — 1e-6 * sqrt(k^3*Cin) leaves a wide margin. bf16: both
        # round the same fp32 sum once, so they differ by at most one bf16
        # ulp, 2^-7 of the largest output.
        for xs, ws, s, pads in conv_shapes:
            kc = math.prod(ws[:4])
            rel = 1e-6 * math.sqrt(kc) if dt == torch.float32 else 2 ** -7
            err = conv_case(
                xs, ws, s, pads, dt, math.sqrt(2.0 / kc),
                lambda want, rel=rel: rel * max(
                    1.0, want.float().abs().max().item()), "main paths")
            if dt == torch.float32:
                worst["conv3d"] = max(worst["conv3d"], err)
        for xs, cout in UNET_GRID:
            kc = 27 * xs[-1]
            rel = 1e-6 * math.sqrt(kc) if dt == torch.float32 else 2 ** -7
            conv_case(xs, (3, 3, 3, xs[-1], cout), 1, ((1, 1),) * 3, dt,
                      math.sqrt(2.0 / kc),
                      lambda want, rel=rel: rel * max(
                          1.0, want.float().abs().max().item()),
                      "unet3d Cin")
    bn_shapes = BN_GRID + [conv_ref.output_shape(xs, ws, s, pads)
                           for xs, ws, s, pads in conv_shapes]
    for name, dt in DTYPES.items():
        for shape in bn_shapes:
            c = shape[-1]
            x = torch.randn(shape, generator=g, device="cuda").to(dt)
            mean, scale, bias = (torch.randn(c, generator=g, device="cuda")
                                 for _ in range(3))
            var = F.softplus(torch.randn(c, generator=g, device="cuda"))
            for slope in (0.01, 1.0):
                got = bn_ops.bn_leaky_relu(x, mean, var, scale, bias,
                                           negative_slope=slope)
                torch.cuda.synchronize()
                want = bn_ref.bn_leaky_relu(x, mean, var, scale, bias,
                                            negative_slope=slope)
                err = max_err(got, want)
                # elementwise, fp32 math in both: 2e-5 (test_kernels.py);
                # bf16 rounds once: half an ulp, within 2^-8 of |y|
                tol = (2e-5 * (1 + want.float().abs().max().item())
                       if dt == torch.float32 else
                       2 ** -8 * max(1.0, want.float().abs().max().item()))
                check(err <= tol, f"bn_act {shape} {dt} slope {slope}: err "
                      f"{err} > tol {tol}")
                rows.append(("bn_act", "grid+main paths", shape, str(dt),
                             err, tol))
                if dt == torch.float32 and shape in bn_shapes[len(BN_GRID):]:
                    worst["bn_act"] = max(worst["bn_act"], err)
    log("kernels", f"ok: {len(rows)} comparisons; worst fp32 error at the "
        f"main path's shapes {worst}")
    return {"worst_fp32_main": worst, "cases": rows}


def halo_cases(cosmoflow, plan_lib, part, cfgs) -> list:
    """(shard input shape, lo, hi) of every depth-split conv of the
    spatial configs, and the extra cases, each once."""
    cases = set(HALO_EXTRA)
    runs = [(cfgs[name], batch, S, kind) for name, batch, S, _, kind
            in SPATIAL]
    runs += [(cfgs["cosmoflow-128"], 4 // D, S, kind)
             for _, D, S, _, _, kind in TRAIN_SPATIAL + PLANS_TRAIN]
    for cfg, batch, S, kind in runs:
        plan = spatial_plan(plan_lib, part, cfg, S, kind)
        for sc in cosmoflow.split_convs(cfg, plan, batch):
            cases.add((sc.shape, sc.lo, sc.hi))
            if sc.no_interior:  # the unpack's adjoint: a pack of dout
                n, d, h, w, c = sc.shape
                cases.add(((n, sc.lo + d + sc.hi, h, w, c), sc.hi, sc.lo))
    return sorted(cases)


def unet_halo_cases(unet3d, plan_lib, part, cfg, cfg64) -> set:
    """(shard input shape, lo, hi) of every depth-split conv of the U-Net
    paths: unet3d-256 b1 served at S = 2 and 4, and the sharded training
    steps at 64^3 (batch 2 over D data shards), phase 10p's planned
    runs, with the faces of the unpack's adjoint where a shard has no
    interior."""
    cases = set()
    runs = [(cfg, 1, S, "fixed") for S, _ in UNET_SERVE if S > 1]
    runs += [(cfg64, UNET_CHECK_BATCH // D, S, kind)
             for _, D, S, _, _, kind in UNET_SPATIAL + PLANS_UNET]
    batch, S, kind = PLANS_UNET_SERVE
    runs += [(cfg, batch, S, kind), (cfg, batch, S, "fixed")]
    for c, batch, S, kind in runs:
        plan = spatial_plan(plan_lib, part, c, S, kind)
        for sc in unet3d.split_convs(c, plan, batch):
            cases.add((sc.shape, sc.lo, sc.hi))
            if sc.no_interior:  # the unpack's adjoint: a pack of dout
                n, d, h, w, ch = sc.shape
                cases.add(((n, sc.lo + d + sc.hi, h, w, ch), sc.hi, sc.lo))
    return cases


def spatial_plan(plan_lib, part, cfg, S, kind, data: int = 1):
    """The plan of ``kind``: "fixed" (the legacy plan), one of
    ``PLAN_KINDS`` (a one-transition plan), or "deep" (CosmoFlow's depth
    split through every conv block, data 1)."""
    if kind == "fixed":
        return plan_lib.legacy_convnet_plan(cfg, part, (S, 1, 1),
                                            data_degrees=(data,))
    if kind in PLAN_KINDS:
        return plan_lib.convnet_plan(cfg, spatial_degrees=(S, 1, 1),
                                     data_degrees=(data,),
                                     **PLAN_KINDS[kind])
    n = len(cfg.conv_channels)
    return plan_lib.ParallelPlan(
        (plan_lib.Stage(0, n, ("model", None, None)),
         plan_lib.Stage(n, n + 1, (None, None, None))),
        (("data", 1), ("model", S)), n + 1, name="deep")


def phase_halo_kernels(pack_ops, pack_ref, cases) -> dict:
    """pack and unpack against their plain versions, bit for bit, at each
    of the kernel's vector counts (``REG_VECTORS`` patched to each of
    ``HALO_VECTORS``), at ``cases`` and the edges of the work split; the
    largest absolute difference seen is kept for the summary."""
    g = torch.Generator(device="cuda").manual_seed(4)
    n_cmp = 0
    worst = {"pack": 0.0, "unpack": 0.0}
    cases = sorted(set(cases) | set(HALO_EDGES))
    for v in HALO_VECTORS:
        with mock.patch.multiple(pack_ops, REG_VECTORS=(v,),
                                 REG_STREAM_BYTES=1 << 62):
            for dt in DTYPES.values():
                for shape, lo, hi in cases:
                    n_cmp += halo_compare(pack_ops, pack_ref, g, shape, lo,
                                          hi, dt, v, worst)
    torch.cuda.empty_cache()  # the U-Net's 4 GB cases, before phase 10e
    log("kernels", f"halo_pack ok: {n_cmp} comparisons over {len(cases)} "
        f"shapes x {len(DTYPES)} dtypes x vectors {HALO_VECTORS}, all "
        f"bit-exact; largest abs difference {worst}")
    return {"comparisons": n_cmp, "max_abs_err": worst,
            "vectors": list(HALO_VECTORS),
            "cases": [list(map(str, c)) for c in cases]}


def halo_compare(pack_ops, pack_ref, g, shape, lo, hi, dt, vectors,
                 worst) -> int:
    """One case at one vector count: pack, unpack, and unpack of the pack
    buffer's faces (views that need not start on 16 bytes), each against
    its plain version; returns the number of comparisons."""
    x = torch.randn(shape, generator=g, device="cuda").to(dt)
    n, d, h, w, c = shape
    row = h * w * c * x.element_size()
    for kind in ("pack", "unpack"):
        sp = pack_ops.split(pack_ops.parts(kind, n, d, row, lo, hi), n,
                            pack_ops._sms(0))
        check(sp.vectors == vectors, f"{kind} {shape} lo={lo} hi={hi}: "
              f"{sp.vectors} vectors a thread, not {vectors}")
    got = pack_ops.pack(x, lo, hi)
    bufs = [torch.randn((n, k, h, w, c), generator=g,
                        device="cuda").to(dt) if k else None
            for k in (lo, hi)]
    pairs = [("pack", got.buf, lambda: pack_ref.pack(x, lo, hi).buf),
             ("unpack", pack_ops.unpack(x, *bufs),
              lambda: pack_ref.unpack(x, *bufs))]
    if lo and hi:
        pairs.append(("unpack", pack_ops.unpack(x, got.to_prev, got.to_next),
                      lambda: pack_ref.unpack(x, got.to_prev, got.to_next)))
    torch.cuda.synchronize()
    for name, a, plain in pairs:
        b = plain()
        what = f"{name} {shape} lo={lo} hi={hi} {dt} {vectors} vectors"
        check(a.shape == b.shape, f"{what}: shape {tuple(a.shape)} != "
              f"{tuple(b.shape)}")
        worst[name] = max(worst[name], max_err(a, b))
        check(torch.equal(a, b), f"{what} differs")
        del b
    return len(pairs)


def ssd_inputs(g, B, L, H, P, N, dt):
    """The distribution of ``tests/test_kernels.py``'s SSD inputs."""
    x = torch.randn((B, L, H, P), generator=g, device="cuda").to(dt)
    d = F.softplus(torch.randn((B, L, H), generator=g, device="cuda")).to(dt)
    A = -torch.exp(torch.randn((H,), generator=g, device="cuda") * 0.5)
    Bm = torch.randn((B, L, N), generator=g, device="cuda").to(dt)
    Cm = torch.randn((B, L, N), generator=g, device="cuda").to(dt)
    return x, d, A, Bm, Cm


def within(got: torch.Tensor, want: torch.Tensor, tol: float) -> bool:
    """Elementwise |got - want| <= tol + tol * |want| (``assert_allclose``
    with rtol = atol = tol)."""
    want = want.float()
    return bool(((got.float() - want).abs() <= tol + tol * want.abs()).all())


def phase_ssd_kernel(ssd_ops, ssd_ref, mamba2) -> dict:
    """The SSD scan kernel against its plain (sequential) version.
    fp32 at the test shapes: 3e-4 rtol/atol elementwise, the reference's
    own kernel contract (``tests/test_kernels.py:84-87``). fp32 at the
    layer shapes (``SSD_LAYERS``): 3e-4 of the output's scale — y there
    reaches ~300-400, and an element near zero keeps the fp32 rounding of
    its ~400-sized terms,
    which no summation order removes (the plain chunked scan's own error
    against the sequential version is printed beside it). bf16: y within
    2e-2 of its scale, the reference's bf16 sweep tolerance (both round
    the same fp32 sums to bf16 once). The fp32 state follows the fp32
    rule of its shape."""
    g = torch.Generator(device="cuda").manual_seed(6)
    rows, worst = [], {}
    for prec, dt in DTYPES.items():
        for B, L, H, P, N, Q in SSD_SHAPES:
            args = ssd_inputs(g, B, L, H, P, N, dt)
            y, state = ssd_ops.ssd_scan(*args, chunk=Q)
            torch.cuda.synchronize()
            want_y, want_s = ssd_ref.ssd_scan(*args)
            err_y, err_s = max_err(y, want_y), max_err(state, want_s)
            tag = f"ssd_scan {(B, L, H, P, N, Q)} {prec}"
            check(y.dtype == dt and state.dtype == torch.float32,
                  f"{tag}: dtypes {y.dtype} {state.dtype}")
            main = (B, L, H, P, N, Q) in SSD_LAYERS.values()
            scale = max(1.0, want_y.float().abs().max().item())
            s_scale = max(1.0, want_s.abs().max().item())
            row = {"shape": [B, L, H, P, N, Q], "dtype": prec,
                   "err_y": err_y, "y_scale": scale, "err_state": err_s,
                   "state_scale": s_scale}
            if main:
                check(err_s <= 3e-4 * s_scale, f"{tag}: state err {err_s}")
            else:
                check(within(state, want_s, 3e-4), f"{tag}: state err "
                      f"{err_s}")
            if prec == "bf16":
                check(err_y <= 2e-2 * scale, f"{tag}: y err {err_y}")
            elif main:
                check(err_y <= 3e-4 * scale, f"{tag}: y err {err_y}")
                yc, ex = mamba2.ssd_chunked(*args, chunk=Q)
                row.update(chunked_err_y=max_err(yc, want_y),
                           chunked_err_state=max_err(ex.final_state, want_s))
                worst[(B, L, H, P, N, Q)] = max(err_y, err_s)
                log("ssd", f"{tag}: kernel y err {err_y:.3g} (scale "
                    f"{scale:.4g}), state err {err_s:.3g} (scale "
                    f"{s_scale:.4g}); plain chunked scan y err "
                    f"{row['chunked_err_y']:.3g}, state err "
                    f"{row['chunked_err_state']:.3g}")
                del yc, ex
            else:
                check(within(y, want_y, 3e-4), f"{tag}: y err {err_y}")
            rows.append(row)
            del args, y, state, want_y, want_s
    # at the layer shape: x, B and C as views of one buffer, as the Mamba2
    # block passes them, give the bits their contiguous copies give, and a
    # second call gives the same bits
    B, L, H, P, N, Q = SSD_MAIN
    in_place = {}
    for prec, dt in DTYPES.items():
        x, d, A, Bm, Cm = ssd_inputs(g, B, L, H, P, N, dt)
        xv, bv, cv = torch.split(torch.cat([x.reshape(B, L, H * P), Bm, Cm],
                                           dim=-1), [H * P, N, N], dim=-1)
        xv = xv.reshape(B, L, H, P)
        check(not (xv.is_contiguous() or bv.is_contiguous()),
              "the views are contiguous")
        y1, s1 = ssd_ops.ssd_scan(xv, d, A, bv, cv, chunk=Q)
        y2, s2 = ssd_ops.ssd_scan(xv, d, A, bv, cv, chunk=Q)
        y3, s3 = ssd_ops.ssd_scan(x, d, A, Bm, Cm, chunk=Q)
        torch.cuda.synchronize()
        in_place[prec] = {
            "views_give_the_bits_of_copies": torch.equal(y1, y3)
            and torch.equal(s1, s3),
            "same_bits_twice": torch.equal(y1, y2) and torch.equal(s1, s2)}
        log("ssd", f"ssd_scan {SSD_MAIN} {prec}: views of one buffer give "
            f"the bits of contiguous copies: "
            f"{in_place[prec]['views_give_the_bits_of_copies']}; the same "
            f"bits twice: {in_place[prec]['same_bits_twice']}")
        check(all(in_place[prec].values()), f"ssd_scan {prec}: {in_place}")
        del x, d, A, Bm, Cm, xv, bv, cv, y1, s1, y2, s2, y3, s3
    log("ssd", f"ok: {len(rows)} comparisons; largest abs difference at "
        f"the layer shapes, fp32: " + ", ".join(
            f"{name} {worst[shape]:.3g}" for name, shape in
            SSD_LAYERS.items()))
    return {"max_abs_err_main_fp32": worst[SSD_MAIN],
            "max_abs_err_layers_fp32": {name: worst[shape] for name, shape
                                        in SSD_LAYERS.items()},
            "cases": rows, "in_place": in_place}


@contextlib.contextmanager
def plain_scan(k):
    """Route the Mamba2 blocks' scan through the plain chunked scan."""
    def plain(x, dt, A, Bm, Cm, *, chunk):
        y, extras = k.mamba2.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
        return y, extras.final_state

    with mock.patch.object(k.ssd_ops, "ssd_scan", plain):
        yield


def lm_batch(cfg, batch: int, seqlen: int, seed: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.randint(0, cfg.vocab_size, (batch, seqlen + 1), generator=g,
                      device="cuda")
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def to_dtype(params, dt):
    return {n: ({m: t.to(dt) for m, t in v.items()} if isinstance(v, dict)
                else v.to(dt)) for n, v in params.items()}


def useful_flops(k, cfg, tokens: int) -> float:
    """The useful FLOPs of a forward over ``tokens`` tokens:
    ``model_flops``'s prefill convention (2 x active parameters a token,
    at ``INPUT_SHAPES["prefill_32k"]``) scaled to this run's tokens."""
    shape = k.configs.INPUT_SHAPES["prefill_32k"]
    return (k.specs.model_flops(cfg.name, cfg, shape.name) * tokens
            / (shape.global_batch * shape.seq_len))


def phase_score(k, cfg, params, runs=SCORE, phase="score") -> tuple:
    """``lm_loss`` at each (batch, tokens, precision) of ``runs``: launches
    per forward, time, tokens/s, useful FLOP/s (``useful_flops``), peak
    memory, loss, and the forward's
    logits against two yardsticks on the same weights and tokens: the
    forward through the plain chunked scan, and that forward in fp64.

    48 random full-width layers amplify rounding ~30x: the plain fp32
    forward itself sits 2.4e-4 (4 x 4096) to 3.5e-4 (1 x 32768) of the
    logits' scale from the fp64 one, the plain bf16 forward 0.42 (H100,
    700 W; the PR 14 rows of PERF.md). So the kernel forward is held
    within 1e-3 (fp32) and 0.25 (bf16) of the logits' scale of the
    plain-scan forward — about twice the measured 3.8e-4 to 4.6e-4 and
    0.127 — and, the test that separates a fault from rounding, no more
    than 2x as far from the fp64 forward as the plain forward is (or
    within 1e-5 of the scale, where both are at fp32's own resolution).
    Returns (rows, forwards that went through the kernel)."""
    rows, forwards = {}, 0
    for batch, seqlen, prec in runs:
        tag = f"{cfg.name}/{prec}/{batch}x{seqlen}"
        p = params[prec]
        data = lm_batch(cfg, batch, seqlen, seed=7)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        c0 = counts(k)
        loss = k.ssm_lm.lm_loss(p, data, cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        per_fwd = delta(counts(k), c0)
        check(per_fwd == dict(NO_LAUNCHES, ssd_scan=cfg.num_layers),
              f"{tag}: launches per forward {per_fwd}")
        check(loss.shape == () and bool(torch.isfinite(loss)),
              f"{tag}: loss {loss}")
        c1 = counts(k)
        ms = host_ms(lambda: k.ssm_lm.lm_loss(p, data, cfg), 3)
        logits = k.ssm_lm.forward(p, data["tokens"], cfg)
        check(counts(k)["ssd_scan"] - c1["ssd_scan"] == 5 * cfg.num_layers,
              f"{tag}: 5 more forwards launched "
              f"{counts(k)['ssd_scan'] - c1['ssd_scan']}")
        forwards += 6
        check(tuple(logits.shape) == (batch, seqlen, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()), f"{tag}: logits")
        c2 = counts(k)
        with plain_scan(k):
            want = k.ssm_lm.forward(p, data["tokens"], cfg)
        torch.cuda.synchronize()
        check(counts(k) == c2, f"{tag}: the plain forward launched a kernel")
        # the yardstick: the plain-scan forward in fp64 on the same
        # (fp32 or bf16-rounded) weights
        with plain_scan(k):
            exact = k.ssm_lm.forward(to_dtype(p, torch.float64),
                                     data["tokens"], cfg)
        check(counts(k) == c2, f"{tag}: a plain forward launched a kernel")
        scale, s64 = want.float().abs().max().item(), exact.abs().max().item()
        row = {"rel_err_vs_plain": (logits.float() - want.float()).abs().max()
               .item() / scale, "logits_scale": scale,
               "kernel_rel_err_vs_fp64": (logits.double() - exact).abs().max()
               .item() / s64,
               "plain_rel_err_vs_fp64": (want.double() - exact).abs().max()
               .item() / s64}
        del exact
        tol = 1e-3 if prec == "fp32" else 0.25
        log(phase, f"{tag}: kernel vs plain-scan forward "
            f"{row['rel_err_vs_plain']:.3g} <= {tol}; vs the fp64 forward: "
            f"kernel {row['kernel_rel_err_vs_fp64']:.3g} <= 2 x plain "
            f"{row['plain_rel_err_vs_fp64']:.3g} (of the logits' scale)")
        check(row["rel_err_vs_plain"] <= tol, f"{tag}: kernel forward vs "
              f"plain-scan forward {row['rel_err_vs_plain']:.3g} > {tol}")
        check(row["kernel_rel_err_vs_fp64"]
              <= max(2 * row["plain_rel_err_vs_fp64"], 1e-5),
              f"{tag}: the kernel forward is more than twice as far from "
              f"the fp64 forward as the plain-scan forward")
        flops = useful_flops(k, cfg, batch * seqlen)
        rows[tag] = {"ms": ms, "tokens_per_s": batch * seqlen / ms * 1e3,
                     "useful_flops": flops,
                     "useful_flop_per_s": flops / ms * 1e3,
                     "peak_bytes": peak, "resident_bytes_before": resident,
                     "loss": loss.item(), "tol_vs_plain": tol,
                     "ssd_launches_per_forward": per_fwd["ssd_scan"], **row}
        tps = rows[tag]["tokens_per_s"]
        log(phase, f"{tag}: lm_loss {ms:.2f} ms ({tps:.0f} tokens/s, "
            f"{rows[tag]['useful_flop_per_s'] / 1e12:.1f} useful TFLOP/s), "
            f"peak {peak / 2 ** 30:.2f} GiB ({resident / 2 ** 30:.2f} GiB "
            f"resident before), loss "
            f"{loss.item():.4f}, {per_fwd['ssd_scan']} ssd_scan launches per "
            f"forward")
        del data, loss, logits, want
    return rows, forwards


def phase_decode(k, cfg, p, phase="decode") -> tuple:
    """Greedy ``generate`` (4 prompts of 64 tokens, 16 new tokens);
    prefill's last logits and 16 teacher-forced ``decode_step``s from an
    empty cache against the kernel forward's last and first 16 positions
    (5e-4 rtol/atol, as ``tests/test_models.py:99-111`` holds the
    reference), decode time per token. Returns (row, forwards that went
    through the kernel)."""
    g = torch.Generator(device="cuda").manual_seed(8)
    prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=g,
                            device="cuda")
    c0 = counts(k)
    toks = k.lm.generate(p, prompts, cfg, 16)
    torch.cuda.synchronize()
    check(counts(k) == c0, "decoding launched a kernel (it runs no scan)")
    check(tuple(toks.shape) == (4, 16) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size, f"generated {toks.shape}")
    prefill, decode = k.lm.make_serve_fns(cfg)
    last, cache = prefill(p, prompts, 80)
    forward = k.ssm_lm.forward(p, prompts, cfg)
    full = forward[:, -1]
    torch.cuda.synchronize()
    check(delta(counts(k), c0) == dict(NO_LAUNCHES, ssd_scan=cfg.num_layers),
          f"{phase} phase: launches")
    err = (last - full).abs().max().item()
    check(within(last, full, 5e-4), f"prefill vs forward logits {err:.3g}")
    check(torch.equal(toks[:, 0], last.argmax(-1)),
          "generate's first token is not prefill's argmax")
    c, teacher = k.ssm_lm.init_cache(cfg, 4, 16, p["embed"].dtype,
                                     p["embed"].device), 0.0
    for t in range(16):
        lg, c = decode(p, c, prompts[:, t:t + 1])
        teacher = max(teacher, (lg - forward[:, t]).abs().max().item())
        check(within(lg, forward[:, t], 5e-4), f"teacher-forced decode "
              f"step {t} vs forward: {teacher:.3g}")
    check(counts(k) == dict(c0, ssd_scan=c0["ssd_scan"] + cfg.num_layers),
          "teacher-forced decoding launched a kernel")
    del forward, c

    def run_decode():  # from a copy: decode_step writes into its cache
        logits, c = last, {n: v.clone() if torch.is_tensor(v) else v
                           for n, v in cache.items()}
        for _ in range(16):
            logits, c = decode(p, c, logits.argmax(-1)[:, None])
        return logits

    row = {"prefill_ms": host_ms(lambda: prefill(p, prompts, 80), 1),
           "decode_ms_per_token": host_ms(run_decode, 2) / 16,
           "prefill_vs_forward_max_abs": err,
           "teacher_forced_vs_forward_max_abs": teacher,
           "prefill_logits_scale": full.abs().max().item(),
           "tokens": toks.tolist()}
    log(phase, f"{cfg.name} fp32 batch 4: 64-token prompts, 16 greedy "
        f"tokens; prefill vs forward {err:.3g}, 16 teacher-forced decode "
        f"steps vs forward {teacher:.3g} (5e-4 rtol/atol); prefill "
        f"{row['prefill_ms']:.1f} ms, decode {row['decode_ms_per_token']:.2f}"
        f" ms per token")
    return row, 1


def lm_inputs(k, cfg, batch: int, tokens: int, images: int, dt,
              seed: int) -> dict:
    """A seeded batch for ``transformer.lm_loss``: tokens and next-token
    labels, or (hubert) synthetic frame embeddings and per-frame labels;
    with ``images`` synthetic image embeddings before the text."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.embed_inputs:
        t = torch.randint(0, cfg.vocab_size, (batch, tokens + 1),
                          generator=g, device="cuda")
        data = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    else:
        data = {"tokens": k.frontends.synth_audio_embeds(
                    g, batch, tokens, cfg.d_model, dt),
                "labels": torch.randint(0, cfg.vocab_size, (batch, tokens),
                                        generator=g, device="cuda")}
    if images:
        data["image_embeds"] = k.frontends.synth_vision_embeds(
            g, batch, cfg.d_model, images, dt)
    return data


class Upcast:
    """A stacked weight whose slices come out in ``dt`` as the forward
    takes them (``params["layers"][name][li]``, ``params["embed"][ids]``,
    the unembedding's ``.t()``): the fp64 yardstick holds one layer's
    weights in fp64 at a time beside the run's."""

    def __init__(self, w: torch.Tensor, dt: torch.dtype):
        self.w, self.dt = w, dt

    def __getitem__(self, i):
        return self.w[i].to(self.dt)

    def t(self) -> torch.Tensor:
        return self.w.to(self.dt).t()


def fp64_params(params) -> dict:
    """A transformer's ``params`` for its fp64 yardstick: the layers'
    weights and the embeddings upcast as the forward takes them, the
    experts (``*_e``) as they are, for ``plain_moe`` to upcast one expert
    at a time."""
    return {"layers": {n: v if n.endswith("_e") else Upcast(v, torch.float64)
                       for n, v in params["layers"].items()},
            **{n: Upcast(params[n], torch.float64)
               for n in ("embed", "unembed") if n in params},
            "final_norm": params["final_norm"].double()}


@contextlib.contextmanager
def recording_routes(routes: list):
    """Append each ``torch.topk``'s indices to ``routes``: in a
    transformer's forward, the experts each MoE layer chose for each
    token, in layer order."""
    topk = torch.topk

    def recorded(*args, **kwargs):
        out = topk(*args, **kwargs)
        routes.append(out.indices)
        return out

    with mock.patch.object(torch, "topk", recorded):
        yield


def plain_moe(routes: list):
    """``moe_ffn`` for the fp64 yardstick, written apart from
    ``models/moe.py``: a copy's place in its expert's queue is a running
    count over (token, choice) order, not a sort; the experts run one at
    a time, each one's weights upcast to x's dtype then; the gates and
    the aux loss in x's dtype. It takes the run's expert choices
    (``routes``, one (T, k) tensor a layer, in order): a token on which
    two experts' probabilities nearly tie would otherwise go to either in
    the two precisions, and change which copies are dropped. A layer
    called again (its recompute under remat, in the backward) takes the
    choices it took the first time: a layer is known by its router's
    first weights (not by their address: the fp64 yardstick's weights
    are fresh copies, whose memory the next layer's may reuse)."""
    taken = {}

    def moe_ffn(p, x, *, num_experts, top_k, capacity_factor=1.25):
        B, S, D = x.shape
        T = B * S
        xt = x.reshape(T, D)
        layer = tuple(p["router"].reshape(-1)[:8].tolist())
        if layer not in taken:
            taken[layer] = routes.pop(0)
        idx = taken[layer]
        probs = torch.softmax(xt @ p["router"].to(x.dtype), dim=-1)
        gates = probs.gather(1, idx)
        gates = (gates / gates.sum(dim=-1, keepdim=True)).reshape(-1)
        first = F.one_hot(idx[:, 0], num_experts).to(x.dtype)
        aux = num_experts * (probs.mean(dim=0) * first.mean(dim=0)).sum()
        C = max(math.ceil(capacity_factor * T * top_k / num_experts), 1)
        flat = idx.reshape(-1)
        queue = F.one_hot(flat, num_experts).cumsum(0).gather(
            1, flat[:, None])[:, 0] - 1
        out = torch.zeros_like(xt)
        for e in range(num_experts):
            rows = torch.nonzero((flat == e) & (queue < C))[:, 0]
            tok = rows // top_k
            xe = xt[tok]
            w_gate, w_up, w_down = (p[n][e].to(x.dtype)
                                    for n in ("w_gate", "w_up", "w_down"))
            ye = (F.silu(xe @ w_gate) * (xe @ w_up)) @ w_down
            out.index_add_(0, tok, ye * gates[rows, None])
        return out.reshape(B, S, D), aux

    return moe_ffn


def vs_fp64(k, cfg, params, data, logits, aux, routes, prec: str) -> dict:
    """The forward's logits (and MoE aux loss) against the same forward
    in fp64 on the same weights (the run's, upcast: ``fp64_params``) and
    inputs, the MoE layers through ``plain_moe`` on the run's expert
    choices (``routes``), at the run's shape or LM_FP64_CUT's; the
    largest difference over the fp64 logits' largest magnitude, held to
    LM_FP64_TOL[prec] by the caller."""
    layers, positions = LM_FP64_CUT.get(cfg.name.split("@")[0], (None, None))
    tokens, images = data["tokens"], data.get("image_embeds")
    if layers:  # the run's first layers, and a forward of that depth
        cfg = dataclasses.replace(cfg, num_layers=layers)
        params = dict(params, layers={n: v[:layers] for n, v in
                                      params["layers"].items()})
        routes = []
        with recording_routes(routes):
            logits, aux = k.transformer.forward(params, tokens, cfg,
                                                extra_embeds=images)
    if positions:  # a causal prefix (after any image prefix)
        tokens = tokens[:, :positions - (0 if images is None
                                          else images.shape[1])]
        logits = logits[:, :positions]
    with mock.patch.object(k.transformer.moe_lib, "moe_ffn",
                           plain_moe(list(routes))):
        exact, aux64 = k.transformer.forward(fp64_params(params), tokens,
                                             cfg, extra_embeds=images)
    lo, hi = torch.aminmax(exact)
    scale = max(-lo.item(), hi.item())
    err = exact.sub_(logits).abs_().max().item() / scale
    return {"fp64_layers": cfg.num_layers, "fp64_positions": logits.shape[1],
            "rel_err_vs_fp64": err, "fp64_logits_scale": scale,
            "aux_vs_fp64": abs(aux.item() - aux64.item()),
            "fp64_tol": LM_FP64_TOL[prec]}


def decode_vs_forward(k, cfg, params, tokens, logits) -> dict:
    """``prefill`` of all but the last LM_DECODE_STEPS tokens, then those
    tokens teacher-forced through ``decode_step``, against the forward's
    logits at the same positions (3e-4 rtol/atol, as
    ``tests/test_models.py:57-90`` holds the reference); prefill ms and
    decode ms a token (host clock, one pass)."""
    S, n = tokens.shape[1], LM_DECODE_STEPS
    prefill, decode = k.lm.make_serve_fns(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = prefill(params, tokens[:, :S - n], S)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    err_p = (last - logits[:, S - n - 1]).abs().max().item()
    check(within(last, logits[:, S - n - 1], 3e-4),
          f"{cfg.name}: prefill vs forward {err_p:.3g}")
    err_d, lgs = 0.0, []
    for t in range(S - n, S):
        lg, cache = decode(params, cache, tokens[:, t:t + 1])
        lgs.append(lg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for t, lg in zip(range(S - n, S), lgs):
        err_d = max(err_d, (lg - logits[:, t]).abs().max().item())
        check(within(lg, logits[:, t], 3e-4), f"{cfg.name}: decode step at "
              f"{t} vs forward: {err_d:.3g}")
    check(cache["pos"] == S, f"{cfg.name}: cache pos {cache['pos']}")
    return {"prefill_tokens": S - n, "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_token": (t2 - t1) * 1e3 / n,
            "prefill_vs_forward_max_abs": err_p,
            "decode_vs_forward_max_abs": err_d,
            "logits_scale": logits.abs().max().item()}


def phase_transformers(k, get_config) -> dict:
    """Each of LM_FAMILIES at its published width, weights drawn on the
    card from a seeded CUDA generator: the forward's logits (shape,
    finite), ``lm_loss`` (finite; ms, median of 3 after a warm-up),
    tokens/s, useful FLOP/s, peak memory, no kernel launched; prefill and
    decode against the forward for LM_DECODE_CHECK; the logits (and MoE
    aux loss) against the fp64 forward (``vs_fp64``), every config's
    gate checked after the last so that one run reports them all."""
    rows, failed = {}, []
    for i, (arch, batch, tokens, images, prec, layers) in enumerate(
            LM_FAMILIES):
        t_start = time.perf_counter()
        cfg = get_config(arch)
        if layers:  # the card cannot hold every layer's weights
            cfg = dataclasses.replace(
                cfg, name=f"{arch}@{layers}of{cfg.num_layers}layers",
                num_layers=layers)
        dt = DTYPES[prec]
        params = k.transformer.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(20 + i),
            device="cuda", dtype=dt)
        data = lm_inputs(k, cfg, batch, tokens, images, dt, seed=30 + i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        c0 = counts(k)
        routes = []
        with recording_routes(routes):
            logits, aux = k.transformer.forward(
                params, data["tokens"], cfg,
                extra_embeds=data.get("image_embeds"))
        tag = f"{cfg.name}/{prec}/{batch}x{images + tokens}"
        check(tuple(logits.shape) == (batch, images + tokens, cfg.vocab_size)
              and logits.dtype == dt and bool(torch.isfinite(logits).all())
              and bool(torch.isfinite(aux)), f"{tag}: logits")
        loss = k.transformer.lm_loss(params, data, cfg)
        check(loss.shape == () and bool(torch.isfinite(loss)),
              f"{tag}: loss {loss}")
        ms = host_ms(lambda: k.transformer.lm_loss(params, data, cfg), 3)
        peak = torch.cuda.max_memory_allocated()
        check(counts(k) == c0, f"{tag}: a transformer launched a kernel")
        n_tok = batch * (images + tokens)
        flops = useful_flops(k, cfg, n_tok)
        row = {"layers": cfg.num_layers, "depth_cut": bool(layers),
               "params": cfg.param_count(), "ms": ms,
               "tokens_per_s": n_tok / ms * 1e3, "useful_flops": flops,
               "useful_flop_per_s": flops / ms * 1e3, "peak_bytes": peak,
               "resident_bytes_before": resident, "loss": loss.item(),
               "aux": aux.item()}
        if arch in LM_DECODE_CHECK:
            row.update(decode_vs_forward(k, cfg, params, data["tokens"],
                                         logits))
        row.update(vs_fp64(k, cfg, params, data, logits, aux, routes, prec))
        check(counts(k) == c0, f"{tag}: a transformer launched a kernel")
        if (row["rel_err_vs_fp64"] > row["fp64_tol"] or row["aux_vs_fp64"]
                > row["fp64_tol"] * max(1.0, abs(row["aux"]))):
            failed.append(tag)
        row["seconds"] = time.perf_counter() - t_start
        rows[tag] = row
        log("lm_families", f"{tag}{' (depth cut)' if layers else ''}: "
            f"{cfg.param_count() / 1e9:.3f}B parameters, lm_loss {ms:.2f} ms "
            f"({row['tokens_per_s']:.0f} tokens/s, "
            f"{row['useful_flop_per_s'] / 1e12:.1f} useful TFLOP/s), peak "
            f"{peak / 2 ** 30:.2f} GiB, loss {row['loss']:.4f}"
            + ("" if arch not in LM_DECODE_CHECK else
               f"; prefill {row['prefill_ms']:.1f} ms vs forward "
               f"{row['prefill_vs_forward_max_abs']:.3g}, "
               f"{LM_DECODE_STEPS} decode steps "
               f"{row['decode_ms_per_token']:.2f} ms a token vs forward "
               f"{row['decode_vs_forward_max_abs']:.3g} (3e-4 rtol/atol)")
            + f"; vs the fp64 forward ({row['fp64_layers']} layers, "
            f"{row['fp64_positions']} positions) {row['rel_err_vs_fp64']:.3g}"
            f" of the logits' scale, aux {row['aux_vs_fp64']:.3g} (<= "
            f"{row['fp64_tol']}); {row['seconds']:.1f} s")
        del params, data, logits, aux, loss, routes
        torch.cuda.empty_cache()
    check(not failed, f"beyond LM_FP64_TOL of the fp64 forward: {failed}")
    return rows


def phase_lm_families(k, get_config) -> tuple:
    """Phase 13b: zamba2-1.2b at full width and depth (``phase_score`` at
    SCORE_HYBRID, ``phase_decode``), then the transformers
    (``phase_transformers``), under ``torch.inference_mode``. Returns
    (report, forwards that went through the SSD kernel)."""
    zcfg = get_config("zamba2-1.2b")
    t0 = time.perf_counter()
    with torch.inference_mode():
        p32 = k.ssm_lm.init_params(
            zcfg, torch.Generator(device="cuda").manual_seed(10),
            device="cuda")
        params = {"fp32": p32, "bf16": to_dtype(p32, torch.bfloat16)}
        log("lm_families", f"{zcfg.name}: {zcfg.param_count() / 1e6:.1f}M "
            f"parameters ({zcfg.num_layers} Mamba2 blocks, the shared "
            f"attention block applied {zcfg.num_attn_applications} times) "
            f"on the card in {time.perf_counter() - t0:.1f}s")
        score, fwd_score = phase_score(k, zcfg, params, SCORE_HYBRID,
                                       "lm_families")
        decode_row, fwd_decode = phase_decode(k, zcfg, p32, "lm_families")
        del params, p32
        torch.cuda.empty_cache()
        transformers = phase_transformers(k, get_config)
    return ({"score": score, "decode": decode_row,
             "transformers": transformers,
             "seconds": time.perf_counter() - t0}, fwd_score + fwd_decode)


def train_launches(k, cfg) -> int:
    """ssd_scan launches of a training step: ``ssm_lm.kernel_launches``
    for an SSM or hybrid config, none for a transformer (attention, the
    MLPs and the MoE dispatch are plain PyTorch)."""
    if k.models.lm_module(cfg) is k.ssm_lm:
        return k.ssm_lm.kernel_launches(cfg, train=True)
    return 0


def lm_train_cut(cfg, params, data, rows=None, layers=None,
                 positions=None):
    """(cfg, params, batch) at the first ``rows`` rows and ``positions``
    positions of the batch and the first ``layers`` layers (None: all),
    the parameters sliced as views."""
    if rows:
        data = {n: v[:rows] for n, v in data.items()}
    if positions:
        data = {n: v[:, :positions] for n, v in data.items()}
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        stack = "layers" if "layers" in params else "blocks"
        params = dict(params, **{stack: {n: v[:layers] for n, v in
                                         params[stack].items()}})
        if "block_norms" in params:
            params["block_norms"] = params["block_norms"][:layers]
    return cfg, params, data


def leaf_errors(k, grads, want) -> dict:
    """{leaf path: max abs diff / the fp64 leaf's max-abs}."""
    out = {}
    for (path, g), w in zip(k.tree.key_paths(grads), k.tree.leaves(want)):
        scale = max(w.abs().max().item(), 1e-300)
        out[path] = (g.double() - w).abs().max().item() / scale
    return out


def lm_step1(k, mod, cfg, params, data, ssm: bool, remat_row=None) -> dict:
    """Step 1's loss and gradients (``lm_value_and_grad``, remat on)
    against the same step in fp64 on the same weights (the run's, upcast)
    and batch: the MoE layers through ``plain_moe`` on the kernel step's
    expert choices (recorded in its forward); an SSM config also through
    the plain chunked scan in fp32 (``plain_scan``). Per-leaf errors and
    their worst; ``remat_row``: the kernel step without remat beside it
    (per leaf, and whether bitwise). Returns the row, with the kernel
    step's ssd_scan launches."""
    vag = k.train_step.lm_value_and_grad
    routes = []
    c0 = counts(k)
    with recording_routes(routes):
        loss, grads = vag(mod.lm_loss, params, data, cfg)
    torch.cuda.synchronize()
    launched = counts(k)["ssd_scan"] - c0["ssd_scan"]
    check(launched == train_launches(k, cfg),
          f"{cfg.name}: step 1 launched {launched} ssd_scan, expected "
          f"{train_launches(k, cfg)}")
    routes = routes[:cfg.num_layers] if getattr(cfg, "num_experts", 0) \
        else []
    row = {"check_layers": cfg.num_layers,
           "check_tokens": int(data["labels"].numel())}
    if remat_row is not None:
        with mock.patch.object(k.flags, "REMAT", False):
            c1 = counts(k)["ssd_scan"]
            loss0, grads0 = vag(mod.lm_loss, params, data, cfg)
            launched += counts(k)["ssd_scan"] - c1
        errs = leaf_errors(k, grads, k.tree.tree_map(torch.Tensor.double,
                                                     grads0))
        remat_row.update(
            loss_remat=loss.item(), loss_no_remat=loss0.item(),
            worst_leaf=max(errs.values()), tol=LM_REMAT_TOL,
            bitwise=bool(torch.equal(loss, loss0)) and all(
                torch.equal(a, b) for a, b in zip(
                    k.tree.leaves(grads), k.tree.leaves(grads0))),
            loss_rel=abs(loss.item() - loss0.item()) / abs(loss0.item()))
        del grads0
    if ssm:
        c1 = counts(k)
        with plain_scan(k):
            plain_loss, plain = vag(mod.lm_loss, params, data, cfg)
        check(counts(k) == c1, f"{cfg.name}: the plain step launched")
    p64 = to_dtype(params, torch.float64)
    with contextlib.ExitStack() as stack:
        if ssm:
            stack.enter_context(plain_scan(k))
        else:
            stack.enter_context(mock.patch.object(
                k.transformer.moe_lib, "moe_ffn", plain_moe(list(routes))))
        loss64, g64 = vag(mod.lm_loss, p64, data, cfg)
    del p64
    errs = leaf_errors(k, grads, g64)
    row.update(loss=loss.item(), loss64=loss64.item(),
               loss_rel_err=abs(loss.item() - loss64.item())
               / abs(loss64.item()),
               worst_leaf=max(errs, key=errs.get),
               worst_rel_err=max(errs.values()), rel_err=errs)
    if ssm:
        perrs = leaf_errors(k, plain, g64)
        row.update(plain_loss_rel_err=abs(plain_loss.item() - loss64.item())
                   / abs(loss64.item()), plain_rel_err=perrs,
                   worst_plain_rel_err=max(perrs.values()),
                   failing=[n for n, e in errs.items()
                            if e > max(LM_TRAIN_TOL, 2 * perrs[n])])
        del plain
    else:
        row["failing"] = [n for n, e in errs.items() if e > LM_TRAIN_TOL]
    if row["loss_rel_err"] > LM_TRAIN_LOSS_TOL:
        row["failing"].append("loss")
    del grads, g64
    return row, launched


def ssd_backward_rows(k) -> dict:
    """The SSD scan's backward (the plain chunked recompute and its
    ``autograd.grad``, no CUDA kernel) at mamba2-370m's and zamba2-1.2b's
    layer shapes, fp32: ms (median of 3) beside the kernel's forward
    call, and the backward's own peak memory."""
    rows = {}
    for arch, (B, L, H, P, N, Q) in SSD_LAYERS.items():
        g = torch.Generator(device="cuda").manual_seed(12)
        args = [a.requires_grad_() for a in ssd_inputs(g, B, L, H, P, N,
                                                       torch.float32)]
        y, _ = k.ssd_ops.ssd_scan(*args, chunk=Q)
        gy = torch.randn(y.shape, generator=g, device="cuda")
        gc.collect()  # no earlier phase's garbage freed in the window
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = median_ms(lambda: torch.autograd.grad(y, args, gy,
                                                   retain_graph=True), 3)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        check(peak >= base, f"ssd_scan backward at {arch}'s layer: peak "
              f"{peak} below the window's base {base}")
        rows[arch] = {"shape": [B, L, H, P, N, Q], "backward_ms": ms,
                      "backward_peak_bytes": peak - base}
        log("lm_train", f"ssd_scan backward at {arch}'s layer {rows[arch]}")
        del args, y, gy
        gc.collect()
    return rows


def lm_train_steps(k, mod, cfg, params, batches, tokens: int) -> dict:
    """A warm-up and LM_TRAIN_STEPS timed ``make_lm_train_step`` steps
    with the launcher's Adam (host clock + synchronize each, median);
    ssd_scan launches a step against ``kernel_launches(train=True)``;
    tokens/s, useful FLOP/s (``model_flops``'s train convention, 6 x
    active parameters a token), peak allocated and reserved."""
    opt = k.Adam(lr=k.warmup_cosine(3e-3, 10, LM_TRAIN_STEPS + 1),
                 grad_clip=1.0)
    state = opt.init(params)
    step = k.train_step.make_lm_train_step(mod.lm_loss, cfg, None, None, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, launches = [], [], []
    for data in batches:
        c0 = counts(k)["ssd_scan"]
        t0 = time.perf_counter()
        params, state, loss = step(params, state, data)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        launches.append(counts(k)["ssd_scan"] - c0)
    want = train_launches(k, cfg)
    check(all(n == want for n in launches), f"{cfg.name}: ssd_scan "
          f"launches a step {launches}, expected {want}")
    check(all(math.isfinite(v) for v in losses), f"{cfg.name}: {losses}")
    ms = statistics.median(times[1:])
    shape = k.configs.INPUT_SHAPES["train_4k"]
    flops = (k.specs.model_flops(cfg.name, cfg, "train_4k") * tokens
             / (shape.global_batch * shape.seq_len))
    return {"ms": ms, "step_ms": times, "losses": losses,
            "tokens_per_s": tokens / ms * 1e3, "useful_flops": flops,
            "useful_flop_per_s": flops / ms * 1e3,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
            "ssd_launches_per_step": want}, sum(launches)


def lm_train_drivers(k) -> tuple:
    """``python -m repro_torch.launch.train --arch LM_DRIVER_ARCH --steps
    3 --device cuda:0`` (``train_lm``, SMOKE) and ``examples/serve_lm``
    (3 training steps, then greedy generation), without remat: finite
    losses, the scan's launches. Returns (row, launches)."""
    cfg = k.configs.get_smoke_config(LM_DRIVER_ARCH)
    c0 = counts(k)["ssd_scan"]
    args = k.launch_train.parse_args(
        ["--arch", LM_DRIVER_ARCH, "--steps", str(LM_DRIVER_STEPS),
         "--device", "cuda:0"])
    _, losses = k.launch_train.train_lm(
        args, cfg, say=lambda *a: log("lm_train", " ".join(map(str, a))))
    check(len(losses) == LM_DRIVER_STEPS and all(
        math.isfinite(v) for v in losses), f"launcher losses {losses}")
    toks = k.serve_lm.main(["--arch", LM_DRIVER_ARCH, "--train-steps",
                            str(LM_DRIVER_STEPS), "--batch", "2",
                            "--gen-steps", "4", "--device", "cuda:0"])
    check(tuple(toks.shape) == (2, 4) and toks.device.type == "cuda",
          f"serve_lm generated {tuple(toks.shape)} on {toks.device}")
    launched = counts(k)["ssd_scan"] - c0
    want = 2 * LM_DRIVER_STEPS * k.ssm_lm.kernel_launches(cfg, train=True)
    check(launched == want, f"drivers launched {launched} ssd_scan, "
          f"expected {want}")
    log("lm_train", f"drivers: launch.train {LM_DRIVER_ARCH} (SMOKE) "
        f"losses {losses}; serve_lm trained {LM_DRIVER_STEPS} steps and "
        f"generated {toks.tolist()}; {launched} ssd_scan launches")
    return {"launcher_losses": losses, "serve_lm_tokens": toks.tolist(),
            "launches": launched}, launched


def phase_lm_train(k, get_config) -> tuple:
    """Phase 13c: each of LM_TRAIN in fp32 under ``flags.REMAT``, weights
    drawn on the card from a seeded CUDA generator, batches the
    launcher's (``launch.train.lm_batches``): step 1 against fp64
    (``lm_step1``, at LM_TRAIN_FP64_CUT's cut), mamba2-370m's remat
    against none (LM_REMAT_CHECK), then the timed steps
    (``lm_train_steps``); the drivers. Every config's gates are checked
    after the last. Returns (report, its ssd_scan launches)."""
    t_start = time.perf_counter()
    rows, failed, launched = {}, [], 0
    with mock.patch.object(k.flags, "REMAT", True):
        for i, (arch, batch, tokens, layers) in enumerate(LM_TRAIN):
            t0 = time.perf_counter()
            cfg = get_config(arch)
            if layers:
                cfg = dataclasses.replace(
                    cfg, name=f"{arch}@{layers}of{cfg.num_layers}layers",
                    num_layers=layers)
            mod = k.models.lm_module(cfg)
            ssm = mod is k.ssm_lm
            gen = torch.Generator(device="cuda").manual_seed(40 + i)
            params = (mod.init_params(cfg, gen, device="cuda") if ssm else
                      mod.init_params(cfg, gen, device="cuda",
                                      dtype=torch.float32))
            batches = list(k.launch_train.lm_batches(
                cfg, batch, tokens, LM_TRAIN_STEPS + 1, "cuda"))
            tag = f"{cfg.name}/fp32/{batch}x{tokens}"
            cut = LM_TRAIN_FP64_CUT.get(arch, (None, None, None))
            remat_row = ({} if (arch, cut[0] or batch, cut[2] or tokens)
                         == LM_REMAT_CHECK and not cut[1] else None)
            ccfg, cparams, cdata = lm_train_cut(cfg, params, batches[0],
                                                *cut)
            check1, n = lm_step1(k, mod, ccfg, cparams, cdata, ssm,
                                 remat_row)
            launched += n
            del cparams, cdata
            torch.cuda.empty_cache()
            steps, n = lm_train_steps(k, mod, cfg, params, batches,
                                      batch * tokens)
            launched += n
            row = {"layers": cfg.num_layers, "depth_cut": bool(layers),
                   "params": cfg.param_count(), **steps, "step1": check1}
            if remat_row is not None:
                row["remat"] = remat_row
                if remat_row["worst_leaf"] > LM_REMAT_TOL or \
                        remat_row["loss_rel"] > LM_REMAT_TOL:
                    failed.append(f"{tag}: remat")
            if check1["failing"]:
                failed.append(f"{tag}: {check1['failing']}")
            row["seconds"] = time.perf_counter() - t0
            rows[tag] = row
            gate = ("max(1e-3, 2 x plain "
                    f"{check1['worst_plain_rel_err']:.3g})" if ssm
                    else f"{LM_TRAIN_TOL}")
            log("lm_train", f"{tag}{' (depth cut)' if layers else ''}: "
                f"{cfg.param_count() / 1e9:.3f}B parameters, "
                f"{steps['ms']:.2f} ms a step ({steps['tokens_per_s']:.0f} "
                f"tokens/s, {steps['useful_flop_per_s'] / 1e12:.1f} useful "
                f"TFLOP/s), peak {steps['peak_bytes'] / 2 ** 30:.2f} GiB "
                f"allocated, {steps['peak_reserved_bytes'] / 2 ** 30:.2f} "
                f"reserved; losses {steps['losses']}; "
                f"{steps['ssd_launches_per_step']} ssd_scan launches a "
                f"step; step 1 vs fp64 ({check1['check_layers']} layers, "
                f"{check1['check_tokens']} tokens): loss "
                f"{check1['loss_rel_err']:.3g} (<= {LM_TRAIN_LOSS_TOL}), "
                f"worst leaf {check1['worst_leaf']} "
                f"{check1['worst_rel_err']:.3g} (<= {gate})"
                + ("" if remat_row is None else
                   f"; remat vs none worst leaf "
                   f"{remat_row['worst_leaf']:.3g} (<= {LM_REMAT_TOL}), "
                   f"bitwise {remat_row['bitwise']}")
                + f"; {row['seconds']:.1f} s")
            del params, batches, steps
            torch.cuda.empty_cache()
    drivers, n = lm_train_drivers(k)
    launched += n
    check(not failed, f"LM training gates failed: {failed}")
    return ({"runs": rows, "drivers": drivers,
             "seconds": time.perf_counter() - t_start}, launched)


COLLECTIVES = ("psum", "pmax", "all_gather", "ppermute_start",
               "all_to_all", "psum_grad")


@contextlib.contextmanager
def counting_collectives(k, tally: dict):
    """Count every collective an in-process shard group issues over more
    than one shard (``spmd.Group``; ``ppermute`` as its
    ``ppermute_start``), each shard's call once, into ``tally``."""
    patches = []
    for name in COLLECTIVES:
        orig = getattr(k.spmd.Group, name)

        def counted(self, *a, _name=name, _orig=orig, **kw):
            if self.size > 1:
                tally[_name] = tally.get(_name, 0) + 1
            return _orig(self, *a, **kw)
        patches.append(mock.patch.object(k.spmd.Group, name, counted))
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        yield tally


@contextlib.contextmanager
def recording_shard_routes(k, routes: dict):
    """Append each ``torch.topk``'s indices, in a shard's thread, to
    ``routes[the shard's model-axis index]``: the experts each MoE layer
    chose for each of the shard's tokens, the forward's calls first, in
    layer order."""
    topk = torch.topk

    def recorded(*args, **kwargs):
        out = topk(*args, **kwargs)
        routes.setdefault(k.spmd.axis("model").index, []).append(
            out.indices)
        return out

    with mock.patch.object(torch, "topk", recorded):
        yield


def ep_moe(k, n: int, routes: dict, tally: dict):
    """``moe_ffn_ep``'s arithmetic on one device, for the unsharded side
    of an ``ep`` run: the tokens cut into the n model shards' blocks of
    the sequence, each block routed, dropped (its own capacity) and
    combined alone by ``moe_ffn``, the aux loss the blocks' mean. Each
    block routes with its own ``torch.topk``; where a token's choices
    differ from those shard j took in the sharded run (``routes``, as
    ``recording_shard_routes`` keeps them), each differing place must be
    a near tie (the two experts' probabilities here within
    LM_SHARDED_TIE): such a token takes the sharded choices, so that a
    flip of rounding does not change which copies drop; any other is
    counted in ``tally["not_tie"]``, which fails the run. A layer called
    again (its recompute) takes the choices of its first call; a layer
    is known by its router's first values, as in ``plain_moe``."""
    moe_ffn, topk, taken, order = k.transformer.moe_lib.moe_ffn, \
        torch.topk, {}, {}
    tally.update(tokens=0, differing=0, near_tie=0, not_tie=0,
                 worst_tie_gap=0.0)

    def routed(key, idx_s):
        def route(probs, k_, dim=-1, **kwargs):
            if key not in taken:  # off the graph: the recompute saves
                pr = probs.detach()  # only what the forward did
                own = topk(pr, k_, dim=dim, **kwargs).indices
                gap = (pr.gather(-1, own) - pr.gather(-1, idx_s)).abs()
                differ = (own != idx_s).any(-1)
                tie = (gap <= LM_SHARDED_TIE).all(-1)
                tally["tokens"] += int(own.shape[0])
                tally["differing"] += int(differ.sum())
                tally["near_tie"] += int((differ & tie).sum())
                tally["not_tie"] += int((differ & ~tie).sum())
                if bool((differ & tie).any()):
                    tally["worst_tie_gap"] = max(tally["worst_tie_gap"],
                                                 gap[differ & tie].max().item())
                taken[key] = torch.where((differ & tie)[:, None], idx_s, own)
            idx = taken[key]
            return torch.return_types.topk((probs.gather(-1, idx), idx))
        return route

    def blocks(p, x, *, num_experts, top_k, capacity_factor=1.25,
               expert_axis=None):
        layer = order.setdefault(tuple(p["router"].reshape(-1)[:8].tolist()),
                                 len(order))
        outs, aux = [], None
        for j, blk in enumerate(x.chunk(n, dim=1)):
            with mock.patch.object(torch, "topk", routed(
                    (layer, j), routes[j][layer].to(x.device))):
                o, a = moe_ffn(p, blk, num_experts=num_experts,
                               top_k=top_k, capacity_factor=capacity_factor)
            outs.append(o)
            aux = a if aux is None else aux + a
        return torch.cat(outs, 1), aux / n

    return blocks


def sharded_grads(k, mod, shards, cut, cfg, policy, specs, mesh) -> tuple:
    """The sharded step 1's loss and gradients (the global tree)."""
    n = mesh.size
    loss, grads = k.train_step.lm_sharded_value_and_grad(
        mod.lm_loss, shards, [{nm: v[r] for nm, v in cut.items()}
                              for r in range(n)], cfg, policy, specs)
    return loss, k.sharding.join_shards(grads, specs, mesh)


def plain_witness(k, mod, cfg, params, data, policy, specs, mesh,
                  dtype, gates=None, unsharded=None) -> dict:
    """The sharded step with the plain chunked scan against the unsharded
    plain-scan step on the same weights (in ``dtype``) and batch
    (``unsharded``: its (loss, gradients) where already taken): the
    plan's dataflow apart from the kernel's rounding. Loss absolute
    error, per leaf max abs diff over the unsharded leaf's max-abs, each
    held to its gate in ``gates`` (LM_SHARDED_GRAD_TOL where None)."""
    p = params if dtype == torch.float32 else to_dtype(params, dtype)
    shards = k.sharding.shard_tree(p, specs, mesh)
    cut = {nm: k.sharding.shard_rows(v, policy) for nm, v in data.items()}
    c0 = counts(k)
    with plain_scan(k):
        loss_u, grads_u = unsharded or k.train_step.lm_value_and_grad(
            mod.lm_loss, p, data, cfg)
        loss_s, grads_s = sharded_grads(k, mod, shards, cut, cfg, policy,
                                        specs, mesh)
    check(counts(k) == c0, f"{cfg.name}: a plain-scan step launched")
    del shards
    errs = leaf_errors(k, grads_s, k.tree.tree_map(torch.Tensor.double,
                                                   grads_u))
    return {"dtype": str(dtype).replace("torch.", ""),
            "tokens": int(data["labels"].numel()), "layers": cfg.num_layers,
            "loss_abs_err": abs(loss_s.item() - loss_u.item()),
            "worst_leaf": max(errs, key=errs.get),
            "worst_rel_err": max(errs.values()), "rel_err": errs,
            "gated": "1e-4" if gates is None else "the kernel step's",
            "failing": [nm for nm, e in errs.items()
                        if e > (gates or {}).get(nm, LM_SHARDED_GRAD_TOL)]
            + (["loss"] if abs(loss_s.item() - loss_u.item())
               > LM_SHARDED_LOSS_TOL else [])}


def to_host(tree_lib, tree):
    return tree_lib.tree_map(lambda t: t.detach().cpu(), tree)


def sharded_param_errors(k, got, want, grads, lr: float,
                         gates) -> dict:
    """The parameters after one Adam step against the unsharded step's
    (host trees): per leaf the elements outside rtol/atol whose
    unsharded gradient is not within the leaf's gradient gate (``gates``,
    a share of its max-abs, in leaf order) of zero (``failing``), and
    those that are (``sign_rounding``: each may move by up to 2 lr)."""
    out = {"failing": 0, "sign_rounding": 0, "worst_over_2lr": 0.0}
    for g_t, w_t, gr, gate in zip(k.tree.leaves(got), k.tree.leaves(want),
                                  k.tree.leaves(grads), gates):
        w_t, gr = w_t.to(g_t.device), gr.to(g_t.device)
        diff = (g_t - w_t).abs()
        off = diff > LM_SHARDED_ATOL + LM_SHARDED_RTOL * w_t.abs()
        near0 = gr.abs() <= gate * max(gr.abs().max().item(), 1e-30)
        out["failing"] += int((off & ~near0).sum())
        out["failing"] += int((off & near0 & (diff > 2 * lr
                                              + LM_SHARDED_ATOL)).sum())
        out["sign_rounding"] += int((off & near0).sum())
        if bool((off & near0).any()):
            out["worst_over_2lr"] = max(out["worst_over_2lr"], (
                diff[off & near0].max().item() / (2 * lr)))
    return out


def lm_sharded_run(k, i: int, row, get_config, unsharded_ms=None) -> tuple:
    """One LM_SHARDED run: step 1 against the unsharded step (the
    sharded ``lm_sharded_value_and_grad``'s loss and every gradient
    leaf, then the parameters after ``make_lm_train_step``'s first step
    against one Adam step of the unsharded gradients), then that step as
    the warm-up and LM_SHARDED_STEPS timed steps with the launcher's
    Adam: ms a step (median), tokens/s, peak allocated and reserved,
    each collective a step (a shard's), the ssd_scan launches (checked:
    ``kernel_launches(train=True)`` a shard a step). Returns (row,
    ssd_scan launches)."""
    tag, arch, shape, d, m, batch, tokens, layers = row
    plan = k.configs.plan_for(arch, shape)
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(
            cfg, name=f"{arch}@{layers}of{cfg.num_layers}layers",
            num_layers=layers)
    mod = k.models.lm_module(cfg)
    ssm = mod is k.ssm_lm
    moe = bool(getattr(cfg, "num_experts", 0))
    gen = torch.Generator(device="cuda").manual_seed(60 + i)
    params = (mod.init_params(cfg, gen, device="cuda") if ssm else
              mod.init_params(cfg, gen, device="cuda", dtype=torch.float32))
    batches = list(k.launch_train.lm_batches(
        cfg, batch, tokens, LM_SHARDED_STEPS + 1, "cuda"))
    n = d * m
    mesh = k.mesh_lib.Mesh((("data", d), ("model", m)), ["cuda:0"] * n)
    policy = k.sharding.ShardingPolicy(mesh, plan=plan)
    specs = k.param_specs.infer_param_specs(mod.param_shapes(cfg), policy)
    opt = k.Adam(lr=k.warmup_cosine(3e-3, 10, LM_SHARDED_STEPS + 1),
                 grad_clip=1.0)
    per_shard = k.ssm_lm.kernel_launches(cfg, train=True) if ssm else 0
    c0 = counts(k)["ssd_scan"]
    # the sharded step 1's gradients (each shard's expert choices
    # recorded)
    shards = k.sharding.shard_tree(params, specs, mesh)
    cut = {nm: k.sharding.shard_rows(v, policy)
           for nm, v in batches[0].items()}
    routes, route_tally = {}, {}
    with recording_shard_routes(k, routes):
        loss_s, grads_s = sharded_grads(k, mod, shards, cut, cfg, policy,
                                        specs, mesh)
    # the unsharded step 1 on the same weights and batch (an ep run's
    # MoE as moe_ffn_ep computes it, routed by its own top-k but for
    # near ties)
    check(not moe or (plan == "ep" and k.flags.EP_ALLTOALL and d == 1),
          f"{tag}: a MoE run is held to moe_ffn_ep's arithmetic at data 1 "
          f"only")
    with (mock.patch.object(k.transformer.moe_lib, "moe_ffn",
                            ep_moe(k, m, routes, route_tally)) if moe
          else contextlib.nullcontext()):
        loss_u, grads_u = k.train_step.lm_value_and_grad(
            mod.lm_loss, params, batches[0], cfg)
    grads_u = to_host(k.tree, grads_u)
    errs = leaf_errors(k, grads_s, k.tree.tree_map(
        lambda t: t.to("cuda").double(), grads_u))
    del grads_s, routes
    # an SSM config's kernel step carries the scan's fp32 rounding
    # through every block: each leaf may lie as far from the unsharded
    # kernel step as twice the unsharded plain-scan step does (phase
    # 12/13c's rule), where that exceeds LM_SHARDED_GRAD_TOL; the
    # dataflow itself is held at LM_SHARDED_GRAD_TOL by the fp64
    # plain-scan witness (``plain_witness``)
    gates, plain_errs, witness = dict.fromkeys(errs, LM_SHARDED_GRAD_TOL), \
        None, {}
    if ssm:
        with plain_scan(k):
            plain = k.train_step.lm_value_and_grad(
                mod.lm_loss, params, batches[0], cfg)
        plain_errs = leaf_errors(k, plain[1], k.tree.tree_map(
            lambda t: t.to("cuda").double(), grads_u))
        gates = {p: max(LM_SHARDED_GRAD_TOL, 2 * e)
                 for p, e in plain_errs.items()}
        witness["fp32"] = plain_witness(k, mod, cfg, params, batches[0],
                                        policy, specs, mesh, torch.float32,
                                        gates, plain)
        del plain
        torch.cuda.empty_cache()
        ccfg, cparams, cdata = lm_train_cut(
            cfg, params, batches[0], positions=LM_SHARDED_FP64_POSITIONS)
        witness["fp64"] = plain_witness(k, mod, ccfg, cparams, cdata,
                                        policy, specs, mesh, torch.float64)
        del cparams, cdata
        torch.cuda.empty_cache()
    with torch.no_grad():
        p_u, _ = opt.update(k.tree.tree_map(lambda t: t.cuda(), grads_u),
                            opt.init(params), params)
    p_u = to_host(k.tree, p_u)
    del params
    torch.cuda.empty_cache()
    # step 1 of the train step (the warm-up), then the timed steps
    step = k.train_step.make_lm_train_step(mod.lm_loss, cfg, mesh, policy,
                                           opt)
    states = [opt.init(p) for p in shards]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, tally = [], [], {}
    for j, data in enumerate(batches):
        with (counting_collectives(k, tally) if j == len(batches) - 1
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            shards, states, loss = step(shards, states, data)
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        if j == 0:
            lr = opt.lr(torch.ones((), dtype=torch.int32)).item()
            perr = sharded_param_errors(
                k, k.sharding.join_shards(shards, specs, mesh), p_u,
                grads_u, lr, [gates[p] for p, _ in k.tree.key_paths(
                    grads_u)])
    peak = torch.cuda.max_memory_allocated()
    peak_res = torch.cuda.max_memory_reserved()
    launched = counts(k)["ssd_scan"] - c0
    want = per_shard * (1 + n * (1 + len(batches)))
    check(launched == want, f"{tag}: {launched} ssd_scan launches, "
          f"expected {want} (kernel_launches {per_shard} a shard a step)")
    check(not ssm or per_shard > 0, f"{tag}: no ssd_scan launch")
    check(all(math.isfinite(v) for v in losses), f"{tag}: {losses}")
    ms = statistics.median(times[1:])
    failing = [p for p, e in errs.items() if e > gates[p]]
    loss_err = abs(loss_s.item() - loss_u.item())
    if loss_err > LM_SHARDED_LOSS_TOL:
        failing.append("loss")
    if perr["failing"]:
        failing.append(f"{perr['failing']} parameters after step 1")
    for dt, w in witness.items():
        failing += [f"plain-scan witness {dt}: {f}" for f in w["failing"]]
    if route_tally.get("not_tie"):
        failing.append(f"{route_tally['not_tie']} tokens routed apart "
                       f"beyond a near tie")
    out = {"arch": arch, "name": cfg.name, "plan": plan, "mesh": [d, m],
           "layers": cfg.num_layers, "depth_cut": bool(layers),
           "batch": batch, "tokens": tokens, "ms": ms, "step_ms": times,
           "tokens_per_s": batch * tokens / ms * 1e3, "losses": losses,
           "peak_bytes": peak, "peak_reserved_bytes": peak_res,
           "collectives_per_step": {nm: c // n for nm, c in tally.items()},
           "ssd_launches_per_step": n * per_shard,
           "unsharded_ms_13c": unsharded_ms,
           "loss": loss_s.item(), "loss_unsharded": loss_u.item(),
           "loss_abs_err": loss_err, "worst_leaf": max(errs, key=errs.get),
           "worst_rel_err": max(errs.values()), "rel_err": errs,
           "plain_rel_err": plain_errs,
           "worst_plain_rel_err": (None if plain_errs is None
                                   else max(plain_errs.values())),
           "plain_witness": witness, "routes": route_tally or None,
           "params": perr, "failing": failing}
    del shards, states, grads_u, p_u
    torch.cuda.empty_cache()
    return out, launched


def lm_sharded_serve(k, i: int, row, get_config) -> dict:
    """One LM_SHARDED_SERVE run: greedy ``generate`` over the mesh (the
    prefill's keys and values moved into the S-sharded cache, each decode
    step's sharded merge) against the unsharded one on the same weights
    and prompt: the tokens equal, the first step's logits within
    LM_SHARDED_SERVE_TOL of their scale; prefill and per-token ms."""
    arch, shape, d, m, prompt_len, new = row
    plan = k.configs.plan_for(arch, shape)
    cfg = get_config(arch)
    mod = k.models.lm_module(cfg)
    gen = torch.Generator(device="cuda").manual_seed(70 + i)
    params = (mod.init_params(cfg, gen, device="cuda")
              if mod is k.ssm_lm else
              mod.init_params(cfg, gen, device="cuda", dtype=torch.float32))
    prompts = lm_batch(cfg, 1, prompt_len, seed=71 + i)["tokens"]
    mesh = k.mesh_lib.Mesh((("data", d), ("model", m)), ["cuda:0"] * (d * m))
    policy = k.sharding.ShardingPolicy(mesh, plan=plan)
    specs = k.param_specs.infer_param_specs(mod.param_shapes(cfg), policy)
    out = {}
    for name, pol in (("unsharded", None), ("sharded", policy)):
        prefill, decode = k.lm.make_serve_fns(cfg, pol)
        p = params if pol is None else k.sharding.shard_tree(params, specs,
                                                            mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, cache = prefill(p, prompts, prompt_len + new)
            first = logits.float().cpu()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            toks = []
            for _ in range(new):
                tok = torch.argmax(logits, dim=-1)
                toks.append(tok)
                logits, cache = decode(p, cache, tok[:, None])
            torch.cuda.synchronize()
        out[name] = {"first": first, "tokens": torch.stack(toks, 1).cpu(),
                     "prefill_ms": (t1 - t0) * 1e3,
                     "decode_ms_per_token": (time.perf_counter() - t1)
                     * 1e3 / new}
        del p, cache, logits
    scale = out["unsharded"]["first"].abs().max().item()
    err = (out["sharded"]["first"] - out["unsharded"]["first"]).abs().max(
        ).item() / scale
    same = torch.equal(out["sharded"]["tokens"], out["unsharded"]["tokens"])
    del params
    torch.cuda.empty_cache()
    return {"arch": arch, "plan": plan, "mesh": [d, m],
            "prompt": prompt_len, "new": new, "tokens_equal": same,
            "first_logits_rel_err": err,
            **{f"{name}_{key}": out[name][key] for name in out
               for key in ("prefill_ms", "decode_ms_per_token")}}


def phase_lm_sharded(k, get_config, unsharded=None) -> tuple:
    """Phase 13d: each LM_SHARDED run (``lm_sharded_run``), then serving
    over the S-sharded cache (LM_SHARDED_SERVE) and the launcher over the
    mesh (LM_SHARDED_DRIVER), all under ``flags.REMAT``; every gate
    checked after the last. ``unsharded``: 13c's report (its same
    configs' ms). Returns (report, ssd_scan launches)."""
    t_start = time.perf_counter()
    rows, serve, failed, launched = {}, {}, [], 0
    same = (unsharded or {}).get("runs", {})
    with mock.patch.object(k.flags, "REMAT", True):
        for i, row in enumerate(LM_SHARDED):
            # each shard's stream keeps cuBLAS workspaces that pin cached
            # segments: dropped before each run
            release_cached(f"13d {row[0]}")
            t0 = time.perf_counter()
            cfg0 = get_config(row[1])
            name = (cfg0.name if not row[7] else
                    f"{row[1]}@{row[7]}of{cfg0.num_layers}layers")
            out, n = lm_sharded_run(k, i, row, get_config, same.get(
                f"{name}/fp32/{row[5]}x{row[6]}", {}).get("ms"))
            launched += n
            out["seconds"] = time.perf_counter() - t0
            rows[row[0]] = out
            if out["failing"]:
                failed.append(f"{row[0]}: {out['failing']}")
            log("lm_sharded", f"{row[0]} {out['name']} {out['plan']} "
                f"({row[2]}'s plan) {row[3]}x{row[4]} {row[5]}x{row[6]}"
                f"{' (depth cut)' if row[7] else ''}: {out['ms']:.2f} ms a "
                f"step ({out['tokens_per_s']:.0f} tokens/s; unsharded in "
                f"13c {out['unsharded_ms_13c']}), peak "
                f"{out['peak_bytes'] / 2 ** 30:.2f} GiB allocated, "
                f"{out['peak_reserved_bytes'] / 2 ** 30:.2f} reserved; "
                f"collectives a step {out['collectives_per_step']}; "
                f"{out['ssd_launches_per_step']} ssd_scan launches a step; "
                f"step 1 against unsharded: loss {out['loss_abs_err']:.3g} "
                f"(<= {LM_SHARDED_LOSS_TOL}), worst leaf "
                f"{out['worst_leaf']} {out['worst_rel_err']:.3g} (<= "
                f"{LM_SHARDED_GRAD_TOL}"
                + ("" if out["worst_plain_rel_err"] is None else
                   f", or 2 x the plain-scan step's own distance, worst "
                   f"{out['worst_plain_rel_err']:.3g}")
                + ")" + "".join(
                    f"; plain-scan witness {dt} ({w['layers']} layers, "
                    f"{w['tokens']} tokens): loss {w['loss_abs_err']:.3g}, "
                    f"worst leaf {w['worst_leaf']} {w['worst_rel_err']:.3g} "
                    f"(<= {w['gated']} gate)"
                    for dt, w in out["plain_witness"].items())
                + ("" if out["routes"] is None else
                   f"; routes {out['routes']} (near tie <= "
                   f"{LM_SHARDED_TIE})")
                + f"; parameters {out['params']}; "
                f"losses {out['losses']}; {out['seconds']:.1f} s")
        for i, row in enumerate(LM_SHARDED_SERVE):
            t0 = time.perf_counter()
            out = lm_sharded_serve(k, i, row, get_config)
            out["seconds"] = time.perf_counter() - t0
            serve[f"{row[0]}/{out['plan']}/{row[2]}x{row[3]}"] = out
            if not out["tokens_equal"] or \
                    out["first_logits_rel_err"] > LM_SHARDED_SERVE_TOL:
                failed.append(f"serve {row[0]}: {out}")
            log("lm_sharded", f"serve {row[0]} {out['plan']} "
                f"{row[2]}x{row[3]}: "
                f"prefill {row[4]} + {row[5]} greedy tokens, equal to the "
                f"unsharded {out['tokens_equal']}, first logits "
                f"{out['first_logits_rel_err']:.3g} (<= "
                f"{LM_SHARDED_SERVE_TOL}); prefill "
                f"{out['sharded_prefill_ms']:.1f} ms (unsharded "
                f"{out['unsharded_prefill_ms']:.1f}), decode "
                f"{out['sharded_decode_ms_per_token']:.2f} ms a token "
                f"(unsharded {out['unsharded_decode_ms_per_token']:.2f}); "
                f"{out['seconds']:.1f} s")
        arch, plan, d, m, steps = LM_SHARDED_DRIVER
        args = k.launch_train.parse_args(
            ["--arch", arch, "--data", str(d), "--model", str(m), "--plan",
             plan, "--steps", str(steps), "--device", "cuda:0"])
        _, losses = k.launch_train.train_lm(
            args, k.configs.get_smoke_config(arch),
            say=lambda *a: log("lm_sharded", " ".join(map(str, a))))
        check(len(losses) == steps and all(math.isfinite(v) for v in losses),
              f"the sharded launcher's losses {losses}")
    check(not failed, f"sharded LM gates failed: {failed}")
    seconds = time.perf_counter() - t_start
    log("lm_sharded", f"phase 13d: {seconds:.1f} s")
    return ({"runs": rows, "serve": serve, "driver_losses": losses,
             "seconds": seconds}, launched)


def kernel_ms(fn, calls: int = 5) -> dict:
    """Device time of each CUDA kernel (``*_kernel``) of one call of
    ``fn``: the median of its instances over ``calls`` calls in one
    profiled window (after a warm-up). A profiler window may miss the
    first kernels it should record, so one call alone is not enough."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times: dict = {}
    for e in prof.events():
        m = re.search(r"(\w+_kernel)", e.name)
        if e.device_type.name == "CUDA" and m:
            times.setdefault(m.group(1), []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    return {name: statistics.median(v) for name, v in times.items()}


def ssd_rows(k, shape=SSD_MAIN) -> dict:
    """ssd_scan at a layer shape (``SSD_LAYERS``): the kernel
    (``device_ms``: device time per call, 20 calls queued, and the single
    call's time, host included, as ``call_ms``), each of its CUDA kernels
    (``kernel_ms``), the plain
    sequential version and the plain chunked scan (median of 3), and the
    bounds: ``ssd_work`` with fp32 as 3xTF32 on the tensor cores
    (``bound_ms``), the arithmetic the kernel executes
    (``bound_executed_ms``, ``ssd_executed``), ``ssd_work`` on the CUDA
    cores (``bound_cuda_core_ms``)."""
    B, L, H, P, N, Q = shape
    g = torch.Generator(device="cuda").manual_seed(9)
    rows = {}
    for prec, dt in DTYPES.items():
        args = ssd_inputs(g, B, L, H, P, N, dt)
        flops, nbytes = ssd_work(B, L, H, P, N, Q, dt)
        executed, once = ssd_executed(B, L, H, P, N, Q, dt)
        b_ms, b_by = bound(flops, nbytes, dt, tf32x3=True)
        peak = PEAK_TF32 if dt == torch.float32 else PEAK_FLOPS[dt]
        dev, call = device_ms(lambda: k.ssd_ops.ssd_scan(*args, chunk=Q), 10)
        rows[prec] = {
            "shape": list(shape), "dtype": prec, "ms": dev, "call_ms": call,
            "ms_by_kernel": kernel_ms(
                lambda: k.ssd_ops.ssd_scan(*args, chunk=Q)),
            "plain_ms": median_ms(lambda: k.ssd_ref.ssd_scan(*args), 3),
            "chunked_plain_ms": median_ms(
                lambda: k.mamba2.ssd_chunked(*args, chunk=Q), 3),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bound_executed_ms": max(executed / peak,
                                     nbytes / PEAK_BYTES) * 1e3,
            "bound_cuda_core_ms": bound(flops, nbytes, torch.float32)[0],
            "gflop": flops / 1e9, "executed_gflop": executed / 1e9,
            "executed_over_work": once / flops, "gbytes": nbytes / 1e9}
        log("timings", "ssd_scan " + json.dumps(rows[prec]))
        del args
    return rows


@contextlib.contextmanager
def plain_versions(k):
    """Route the forward through the plain versions (for comparison)."""
    with mock.patch.object(k.conv_ops, "conv3d_valid",
                           k.conv_ref.conv3d_valid), \
            mock.patch.object(k.bn_ops, "bn_leaky_relu",
                              k.bn_ref.bn_leaky_relu), \
            mock.patch.object(k.pack_ops, "pack", k.pack_ref.pack), \
            mock.patch.object(k.pack_ops, "unpack", k.pack_ref.unpack):
        yield


def wrappers(k) -> dict:
    return {"conv3d": k.conv_ops.conv3d_valid,
            "conv3d_dgrad": k.conv_ops.conv3d_input_grad,
            "bn_act": k.bn_ops.bn_leaky_relu,
            "pack": k.pack_ops.pack, "unpack": k.pack_ops.unpack,
            "ssd_scan": k.ssd_ops.ssd_scan}


def counts(k) -> dict:
    return {name: fn.launches for name, fn in wrappers(k).items()}


def zero_counts(k) -> None:
    for fn in wrappers(k).values():
        fn.launches = 0


def delta(after: dict, before: dict) -> dict:
    return {n: after[n] - before[n] for n in KERNELS}


def release_cached(what: str) -> None:
    """Hand the cached device memory back before a phase that needs most
    of the card: cuBLAS keeps a workspace for every (handle, stream) a
    product ran on — the shard threads and the meshes' streams add up to
    ~3 GiB of them — and each pins the cached segment it sits in (~23 GiB
    stayed reserved with ~3 GiB allocated after the sharded phases), so
    they are dropped (cuBLAS makes them anew at its next product) before
    the cache is emptied."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    log("memory", f"before {what}: {before[0] / 2 ** 30:.2f} GiB "
        f"allocated, {before[1] / 2 ** 30:.2f} reserved; after dropping "
        f"cuBLAS's workspaces and the cache "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} and "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = max(1.0, want.float().abs().max().item())
    return (got.float() - want.float()).abs().max().item() / scale


def serve_and_compare(sess, x, k, rel, tag, expect, shape=None):
    """One predict: its launches equal ``expect``, its output finite, of
    ``shape`` (default (N, out_dim)) and within ``rel`` of the same
    forward through the plain versions."""
    c0 = counts(k)
    pred = sess.predict(x)
    torch.cuda.synchronize()
    c1 = counts(k)
    check(delta(c1, c0) == expect, f"{tag}: launches per forward "
          f"{delta(c1, c0)}, expected {expect}")
    check(tuple(pred.shape) == (shape or (x.shape[0], sess.cfg.out_dim)),
          f"{tag}: prediction shape {tuple(pred.shape)}")
    check(bool(torch.isfinite(pred).all()), f"{tag}: non-finite predictions")
    with plain_versions(k):
        want = sess.predict(x)
    torch.cuda.synchronize()
    check(counts(k) == c1, f"{tag}: the plain forward launched a kernel")
    err = rel_err(pred, want)
    check(err <= rel, f"{tag}: kernel forward vs plain forward {err} > {rel}")
    return pred, err


@contextlib.contextmanager
def plain_training(k):
    """Route a training step through the plain versions and around the
    autograd Functions: autograd then differentiates ``ref.conv3d_valid``
    and ``ref.bn_leaky_relu`` themselves, so the plain step's input
    gradient does not take the kernel's flipped-filter route."""
    with mock.patch.object(k.conv_ops, "conv3d", k.conv_ref.conv3d_valid), \
            mock.patch.object(k.bn_ops, "bn_act", k.bn_ref.bn_leaky_relu):
        yield


def loss_and_grads(k, sess, x, y, params=None, precision=None,
                   micro: int = 1) -> tuple:
    """Step 1 of ``sess`` without the update: its loss (CosmoFlow:
    dropout seed 0, the session's masks; the U-Net: the voxel
    cross-entropy) and the gradient of every parameter (of ``params``,
    default the session's, at ``precision``, default the session's).
    ``micro`` > 1: a pipelined step's oracle on one device — the batch cut
    into ``micro`` micro-batches, each its own forward (its batch-norm
    statistics) with the global normalizer and its rows' global ids, the
    losses and each micro-batch's gradients added in micro-batch order
    (the pipelined session's plan run as one group,
    ``train_step.flat_plan``)."""
    p = {n: v.detach().requires_grad_(True)
         for n, v in (params or sess.params).items()}
    plan = k.train_step.flat_plan(sess.plan)
    precision = precision or sess.precision
    n = x.shape[0]
    mb = n // micro
    loss, grads = None, None
    for m in range(micro):
        rows = slice(m * mb, (m + 1) * mb)
        if sess.cfg.arch == "unet3d":
            lm = k.unet3d.segmentation_loss(
                p, x[rows], y[rows], sess.cfg, plan=plan,
                global_voxels=n * sess.cfg.input_width ** 3,
                precision=precision)
        else:
            lm = k.cosmoflow.mse_loss(
                p, x[rows], y[rows], sess.cfg, plan=plan, global_batch=n,
                train=True, dropout_seed=0,
                sample_ids=range(m * mb, (m + 1) * mb),
                mask_source=sess.mask_source, precision=precision)
        gm = dict(zip(p, torch.autograd.grad(lm, list(p.values()))))
        loss = lm.detach() if loss is None else loss + lm.detach()
        grads = gm if grads is None else {q: grads[q] + gm[q] for q in gm}
    return loss, grads


def _windows(x: torch.Tensor, s: int) -> torch.Tensor:
    """x's pool windows as (N, D/s, H/s, W/s, C, s^3), each window's
    voxels in row-major (d, h, w) order."""
    n, d, h, w_, c = x.shape
    x = x[:, :d // s * s, :h // s * s, :w_ // s * s]
    return x.reshape(n, d // s, s, h // s, s, w_ // s, s, c).permute(
        0, 1, 3, 5, 7, 2, 4, 6).reshape(n, d // s, h // s, w_ // s, c, s ** 3)


@contextlib.contextmanager
def pools(k, pool):
    """Both models' max pooling replaced by ``pool``."""
    with mock.patch.object(k.cosmoflow, "maxpool3d", pool), \
            mock.patch.object(k.unet3d, "maxpool3d", pool):
        yield


@contextlib.contextmanager
def decisions(k, taken: list, replay: bool = False):
    """A training step's discrete choices, in call order: the sign of each
    batch norm + leaky-ReLU (or ReLU) output and the winner (the first
    maximum, the rule ``_MaxPool`` and XLA follow) of each max pool
    window. ``replay`` False appends the step's own to ``taken``; True
    makes the step take those of ``taken`` instead: its batch norm's
    output before the activation then the recorded slope, its pool's
    recorded winner, with autograd through both. Wraps whatever batch
    norm and pool are in place (the kernels, the plain versions or
    fp64)."""
    bn_fn = k.cosmoflow.dist_norm.distributed_batchnorm
    pool_fn = k.cosmoflow.maxpool3d
    it = iter(taken)

    def bn(x, scale, bias, reduce_axes=(), eps=1e-5, activation_slope=None):
        if not replay:
            y = bn_fn(x, scale, bias, reduce_axes, eps, activation_slope)
            taken.append(y.detach() > 0)
            return y
        z = bn_fn(x, scale, bias, reduce_axes, eps, None)
        return torch.where(next(it), z, z * activation_slope)

    def pool(x, part, window=2, stride=2):
        if not replay:
            taken.append(_windows(x.detach(), stride).argmax(-1))
            return pool_fn(x, part, window, stride)
        return _windows(x, stride).gather(
            -1, next(it).unsqueeze(-1)).squeeze(-1)

    with mock.patch.object(k.cosmoflow.dist_norm, "distributed_batchnorm",
                           bn), pools(k, pool):
        yield


def flips(a: list, b: list) -> list:
    """Per recorded decision (``decisions``' order), how many elements
    two steps decided differently."""
    return [int((x != y).sum().item()) for x, y in zip(a, b)]


def conv64(x, w, stride=1, pads=((0, 0),) * 3):
    (pd, qd), (ph, qh), (pw, qw) = pads
    xc = F.pad(x, (0, 0, pw, qw, ph, qh, pd, qd)).permute(0, 4, 1, 2, 3)
    return F.conv3d(xc, w.permute(4, 3, 0, 1, 2), stride=stride).permute(
        0, 2, 3, 4, 1)


def bn64(x, scale, bias, reduce_axes=(), eps=1e-5, activation_slope=None):
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dims)
    var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
    y = (x - mean) * torch.rsqrt(var + eps) * scale + bias
    slope = 1.0 if activation_slope is None else activation_slope
    return y if slope == 1.0 else F.leaky_relu(y, slope)


def mse64(pred, y, global_batch):
    return torch.sum(torch.mean(torch.square(pred - y), dim=-1)) / global_batch


def nll64(logits, labels, denominator):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long().unsqueeze(-1)).sum() / denominator


def fp64_grads(k, sess, x, y, within=contextlib.nullcontext,
               micro: int = 1) -> tuple:
    """Step 1 in fp64, as near the exact gradient as the card computes:
    the session's fp32 masters widened, the convs by ``F.conv3d`` and the
    batch norm and the loss in fp64 (the U-Net's up-convolutions and head
    are products, in fp64 on fp64 inputs), the same masks; inside the
    context ``within()`` (entered after those patches); ``micro`` as
    ``loss_and_grads``'."""
    with mock.patch.object(k.conv_ops, "conv3d", conv64), \
            mock.patch.object(k.cosmoflow.dist_norm,
                              "distributed_batchnorm", bn64), \
            mock.patch.object(k.cosmoflow, "mse", mse64), \
            mock.patch.object(k.unet3d, "voxel_nll", nll64), within():
        return loss_and_grads(
            k, sess, x.double(), y if sess.cfg.arch == "unet3d"
            else y.double(), precision="fp32",
            params={n: v.double() for n, v in sess.params.items()},
            micro=micro)


def block_of(name: str) -> int:
    """The conv block a parameter belongs to (the FC head: 99)."""
    return int(name[4:].split("_")[0]) if name.startswith("conv") else \
        int(name[2:].split("_")[0]) if name.startswith("bn") else 99


def saved_bytes(k, cfg, batch: int) -> float:
    """Reckoned activations a training step keeps for its backward, fp32:
    per block the conv's input and output (saved by the conv and the
    batch norm) and one byte per pooled output (the pool's argmax)."""
    total = 0.0
    for xs, ws, s, pads in k.cosmoflow.conv_shapes(cfg, batch):
        out = k.conv_ref.output_shape(xs, ws, s, pads)
        total += 4 * (math.prod(xs) + math.prod(out))
    npool = k.cosmoflow.num_pools(cfg)
    for i, (xs, ws, s, pads) in enumerate(k.cosmoflow.conv_shapes(cfg,
                                                                  batch)):
        if i < npool:
            total += math.prod(k.conv_ref.output_shape(xs, ws, s, pads)) / 8
    return total


def step_split(k, sess, x, y, reps: int = 3) -> dict:
    """A step's device time split by the train step's phase probes
    (``make_convnet_phase_probes``: the forward alone, the forward and
    the backward, then the gradient reduction, the whole step without
    the guard), each timed by CUDA events around it, the median of
    ``reps`` after one warm-up, on the session's parameters (the results
    are dropped): forward = fwd, backward = bwd - fwd, reduction =
    grad_comm - bwd, optimizer = step - grad_comm; and the peak of
    allocated memory in each probe."""
    probes = k.train_step.make_convnet_phase_probes(
        sess.cfg, sess.mesh, sess.optimizer, global_batch=x.shape[0],
        plan=sess.plan, grad_comm=sess.grad_comm, precision=sess.precision)
    ms, out = {}, {}
    for stage, fn in probes.items():
        fn(sess.params, sess.opt_state, x, y, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(sess.params, sess.opt_state, x, y, 0)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms[stage] = statistics.median(times)
        out[stage + "_peak_bytes"] = torch.cuda.max_memory_allocated()
    return dict(out, forward_ms=ms["fwd"], backward_ms=ms["bwd"] - ms["fwd"],
                grad_comm_ms=ms["grad_comm"] - ms["bwd"],
                optimizer_ms=ms["step"] - ms["grad_comm"], probe_ms=ms)


def grad_rows(k, cfg, batch: int, prec: str, reps: int) -> dict:
    """Each conv's input gradient (the conv3d kernel, device time per
    call queued), held against autograd through ``ref.conv3d_valid`` in
    fp32 on the same x, w and dy (fp32 within 1e-6 sqrt(k^3 Cout) of the
    scale, the forward's contract at the input gradient's K; bf16 within
    2^-7, one rounding of an fp32 sum), beside
    ``torch.nn.grad.conv3d_input`` (cuDNN), and each
    weight gradient (one fp32 product a tap) beside
    ``torch.nn.grad.conv3d_weight``, at the shapes of ``cfg``'s training
    step. Bounds: the forward's operations on the tensor cores (the
    input gradient; 3xTF32 for fp32) or the CUDA cores (the fp32 weight
    products), and each input read once, each output written once."""
    dt = DTYPES[prec]
    gt = torch.Generator(device="cuda").manual_seed(9)
    rows = {"input_grad": [], "weight_grad": []}
    torch.cuda.empty_cache()  # the steps' blocks, for the plain backward
    for i, (xs, ws, s, pads) in enumerate(k.cosmoflow.conv_shapes(cfg,
                                                                  batch)):
        ys = k.conv_ref.output_shape(xs, ws, s, pads)
        x = torch.randn(xs, generator=gt, device="cuda").to(dt)
        w = (torch.randn(ws, generator=gt, device="cuda") * 0.05).to(dt)
        dy = torch.randn(ys, generator=gt, device="cuda").to(dt)
        flops = 2.0 * math.prod(ys[:4]) * math.prod(ws)
        size = x.element_size()
        (pd, qd), (ph, qh), (pw, qw) = pads
        padded = tuple(n + p + q for n, (p, q) in zip(xs[1:4], pads))
        xc = F.pad(x, (0, 0, pw, qw, ph, qh, pd, qd)).permute(0, 4, 1, 2, 3)
        dyc, wc = dy.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2)
        base = {"config": cfg.name, "batch": batch, "dtype": prec,
                "layer": i, "x": list(xs), "w": list(ws), "stride": s}
        if i > 0:  # block 0's input needs no gradient
            got = k.conv_ops.conv3d_input_grad(dy, w, xs, s, pads).float()
            xr = x.float().requires_grad_(True)
            k.conv_ref.conv3d_valid(xr, w.float(), s, pads).backward(
                dy.float())
            kc = ws[0] * ws[1] * ws[2] * ws[4]
            tol = 1e-6 * kc ** 0.5 if prec == "fp32" else 2 ** -7
            err = (got - xr.grad).abs().max().item()
            scale = max(1.0, xr.grad.abs().max().item())
            check(err <= tol * scale, f"{cfg.name} b{batch} {prec} layer "
                  f"{i}: input gradient vs autograd through the plain conv "
                  f"{err} > {tol} x {scale}")
            del got, xr
            ms, call_ms = device_ms(lambda: k.conv_ops.conv3d_input_grad(
                dy, w, xs, s, pads), reps)
            lib_ms, _ = device_ms(lambda: torch.nn.grad.conv3d_input(
                (xs[0], xs[4]) + padded, wc, dyc, stride=s), reps)
            b_ms, b_by = bound(flops, size * (math.prod(ys) + math.prod(ws)
                                              + math.prod(xs)), dt,
                               tf32x3=True)
            rows["input_grad"].append(dict(
                base, ms=ms, call_ms=call_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                tolerance=tol * scale))
            log("timings", "conv3d input grad " + json.dumps(
                rows["input_grad"][-1]))
        ms, call_ms = device_ms(lambda: k.conv_ops.conv3d_weight_grad(
            x, dy, ws, s, pads), reps)
        lib_ms, _ = device_ms(lambda: torch.nn.grad.conv3d_weight(
            xc, wc.shape, dyc, stride=s), reps)
        b_ms, b_by = bound(flops, size * (math.prod(xs) + math.prod(ys))
                           + 4 * math.prod(ws), torch.float32)
        rows["weight_grad"].append(dict(
            base, ms=ms, call_ms=call_ms, library_ms=lib_ms, bound_ms=b_ms,
            bound_by=b_by))
        log("timings", "conv3d weight grad " + json.dumps(
            rows["weight_grad"][-1]))
        del x, w, dy, xc, dyc, wc
    return rows


def step1_vs_plain(k, sess, x, y, tag: str, prec: str, micro: int = 1,
                   step=None) -> tuple:
    """Step 1's loss and every gradient through the kernels, held against
    the same step through the plain versions (``plain_training``) and in
    fp64 (``fp64_grads``), within ``STEP1_*``: fp32 from the fp64 step
    that takes the kernel step's decisions (``decisions``), within
    ``STEP1_FP32`` of each leaf's max-abs or the plain fp32 step's own
    distance from fp64, whichever is larger; the loss within
    ``STEP1_LOSS`` of the plain step's. bf16, CosmoFlow: no farther from
    fp64 than ``STEP1_BF16`` x the plain bf16 step. bf16, the U-Net
    (``bf16_given_decisions``): with every decision the kernel step's, no
    farther from fp64 than ``STEP1_BF16`` x the plain step, and no more
    decisions taken otherwise than fp64 than ``STEP1_BF16`` x the plain
    step's — in bf16 both steps flip ~690,000 of its ReLU signs and pool
    winners at 64^3 b2, and a leaf fed by the last level's ReLUs lies
    from fp64 where the flips put it (PERF.md §6). Returns
    (report, loss).

    A pipelined session: the oracle is ``loss_and_grads(micro=)`` (its
    decisions, one micro-batch after another, are the pipelined step's:
    the same blocks on the same inputs), and ``step(x, y)`` — the
    pipelined step's ``grad_comm`` probe, (loss, merged gradients) — is
    the kernel and the plain step held to the gates."""
    taken, plain_taken, exact_taken = [], [], []

    def oracle(params=None, precision=None):
        return loss_and_grads(k, sess, x, y, params, precision, micro)

    with decisions(k, taken):
        loss, grads = oracle()
    if step is not None:
        loss, grads = step(x, y)
    c0 = counts(k)
    with plain_training(k), decisions(k, plain_taken):
        plain_loss, plain = oracle()
    if step is not None:
        with plain_training(k):
            plain_loss, plain = step(x, y)
    with plain_training(k), decisions(k, taken, replay=True):
        _, pinned = oracle()
    _, exact = fp64_grads(k, sess, x, y, lambda: decisions(k, exact_taken),
                          micro)
    _, exact_same = fp64_grads(k, sess, x, y, lambda: decisions(
        k, taken, replay=True), micro)
    torch.cuda.synchronize()
    check(counts(k) == c0, f"{tag}: the plain or fp64 step launched a "
          "kernel")

    def rel(a, b):
        return ((a.double() - b.double()).abs().max().item()
                / max(1e-30, b.double().abs().max().item()))

    row = {n: {"vs_fp64_same_decisions": rel(grads[n], exact_same[n]),
               "vs_plain_same_decisions": rel(grads[n], pinned[n]),
               "plain_same_decisions_vs_fp64_same_decisions": rel(
                   pinned[n], exact_same[n]),
               "vs_plain": rel(grads[n], plain[n]),
               "vs_fp64": rel(grads[n], exact[n]),
               "plain_vs_fp64": rel(plain[n], exact[n])} for n in grads}
    # decisions (activation signs and pool winners, in call order) that
    # the kernel step and the plain step each take otherwise than fp64
    flipped = {"kernel_vs_fp64": flips(taken, exact_taken),
               "plain_vs_fp64": flips(plain_taken, exact_taken),
               "decisions": [int(t.numel()) for t in taken]}
    if prec == "fp32":
        key = "vs_fp64_same_decisions"
        bad = {n: r for n, r in row.items()
               if r[key] > max(STEP1_FP32, r["plain_vs_fp64"])}
    elif sess.cfg.arch == "unet3d":
        key = "vs_fp64_same_decisions"
        bad = {n: r for n, r in row.items() if r[key] > STEP1_BF16 * r[
            "plain_same_decisions_vs_fp64_same_decisions"]}
        if (sum(flipped["kernel_vs_fp64"])
                > STEP1_BF16 * sum(flipped["plain_vs_fp64"])):
            bad["decisions flipped"] = flipped
    else:
        key = "vs_fp64"
        bad = {n: r for n, r in row.items()
               if r["vs_fp64"] > STEP1_BF16 * r["plain_vs_fp64"]}
    loss_err = abs(loss.item() - plain_loss.item()) / abs(plain_loss.item())
    if bad:
        log("train", f"{tag}: every leaf {json.dumps(row)}; decisions "
            f"flipped from fp64 {json.dumps(flipped)}")
    check(loss_err <= STEP1_LOSS[prec] and not bad,
          f"{tag}: step 1 vs the plain step: loss {loss_err}; gradients "
          f"out of bounds {bad}")
    worst = max(row, key=lambda n: row[n][key])
    # each step with its own decisions: the kernel step's distance from
    # fp64 over the plain step's (CosmoFlow's bf16 comparison)
    own = {n: r["vs_fp64"] / max(1e-30, r["plain_vs_fp64"])
           for n, r in row.items()}
    most = max(own, key=own.get)
    log("train", f"{tag}: step 1 vs the plain step: loss {loss_err:.3g}; "
        f"worst gradient by {key}: {worst} {json.dumps(row[worst])} (share "
        f"of the leaf's max-abs); every leaf within its bound; each step "
        f"with its own decisions, kernel over plain distance from fp64 at "
        f"most {own[most]:.3g} ({most}); decisions flipped from fp64 "
        f"{json.dumps(flipped)}")
    return {"loss": loss.item(), "plain_loss": plain_loss.item(),
            "loss_rel_err": loss_err, "grads": row, "flipped": flipped,
            "own_decisions_ratio_max": [most, own[most]]}, loss.item()


def phase_train(k, cfgs, RunConfig, compile) -> tuple:
    """The training main path: for each of ``TRAIN``, a
    ``compile(RunConfig(mode="train"))`` session on the card takes its
    steps on a seeded batch (dropout masks from the session's seeded
    generator), every loss finite, launching per step 7 conv3d, 6 conv3d
    input-gradient and 7 bn_act kernels. Before that, step 1's loss and
    every gradient through the kernels are held against the same step
    through the plain versions (``plain_training``) and in fp64
    (``fp64_grads``), within ``STEP1_*``, and after it each
    config is timed: ms per step, the forward/backward/optimizer split,
    a profiled step, the peak memory, and the gradient kernels beside
    cuDNN's. Returns (report, launches of the steps)."""
    out = {"steps": {}, "vs_plain": {}, "timing": {}, "profile": {}}
    g = torch.Generator(device="cuda").manual_seed(7)
    data, sessions = {}, {}
    for name, batch, prec, _, vs_plain in TRAIN:
        cfg = cfgs[name]
        w = cfg.input_width
        data[(name, prec)] = (
            torch.randn((batch, w, w, w, cfg.in_channels), generator=g,
                        device="cuda"),
            torch.randn((batch, cfg.out_dim), generator=g, device="cuda"))
        if not vs_plain:
            continue
        sess = compile(RunConfig(model=name, mode="train",
                                 global_batch=batch, precision=prec))
        check(sess.device.type == "cuda", "train session not on the card")
        x, y = data[(name, prec)]
        out["vs_plain"][f"{name}/{prec}"], loss = step1_vs_plain(
            k, sess, x, y, f"{name} {prec} b{batch}", prec)
        sessions[(name, prec)] = (sess, loss)
    torch.cuda.empty_cache()

    # ------------------------------------------------ the main path ----
    zero_counts(k)
    per_step = dict(NO_LAUNCHES, conv3d=7, conv3d_dgrad=6, bn_act=7)
    expected = dict(NO_LAUNCHES)
    for name, batch, prec, n_steps, _ in TRAIN:
        cfg = cfgs[name]
        x, y = data[(name, prec)]
        tag = f"{name}/{prec}/b{batch}"
        reckoned = saved_bytes(k, cfg, batch)
        if (name, prec) not in sessions:
            sessions[(name, prec)] = (compile(RunConfig(
                model=name, mode="train", global_batch=batch,
                precision=prec)), None)
        sess, first = sessions[(name, prec)]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # reserved memory: this config's alone
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        c0 = counts(k)
        losses, step_ms = [], []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            losses.append(sess.step(x, y).item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        got = delta(counts(k), c0)
        expected = {n: expected[n] + per_step[n] * n_steps for n in KERNELS}
        check(got == {n: v * n_steps for n, v in per_step.items()},
              f"{tag}: launches {got} over {n_steps} steps, expected "
              f"{per_step} per step")
        check(all(math.isfinite(v) for v in losses),
              f"{tag}: non-finite losses {losses}")
        if first is not None:
            check(abs(losses[0] - first) <= 1e-6 * abs(first),
                  f"{tag}: step 1's loss {losses[0]} vs {first}")
        row = out["steps"][tag] = {
            "losses": losses, "launches": got, "step_ms": step_ms,
            "ms_per_step": statistics.median(step_ms[1:]),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
            "resident_bytes_before": resident,
            "foreign_bytes": foreign_bytes(resident, sess, x, y),
            "reckoned_saved_bytes": reckoned, "modeled": modeled(sess),
            "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF")}
        log("train", f"{tag}: {n_steps} steps, losses {losses}; launches "
            f"{json.dumps(got)}; peak {row['peak_bytes'] / 2 ** 30:.2f} GiB "
            f"allocated, {row['peak_reserved_bytes'] / 2 ** 30:.2f} GiB "
            f"reserved (reckoned saved activations {reckoned / 2 ** 30:.2f}"
            f" GiB; PYTORCH_CUDA_ALLOC_CONF {row['alloc_conf']})")
    launches = counts(k)
    check(launches == expected and launches["conv3d_dgrad"] > 0,
          f"train path launches {launches}, expected {expected}")
    log("main path", f"train: launches {launches}")

    # ------------------------------------------------------ timings ----
    for (name, prec), (sess, _) in sessions.items():
        cfg = cfgs[name]
        x, y = data[(name, prec)]
        batch = x.shape[0]
        tag = f"{name}/{prec}/b{batch}"
        reps = 3
        row = {"step_ms": host_ms(lambda: sess.step(x, y), reps),
               **step_split(k, sess, x, y, reps)}
        out["timing"][tag] = row
        out["profile"][tag] = device_profile(lambda: sess.step(x, y))
        log("timings", f"train {tag}: " + json.dumps(row))
        log("profile", f"train {tag} " + json.dumps(out["profile"][tag]))
        out["timing"][tag].update(grad_rows(k, cfg, batch, prec, reps))
        check(all(math.isfinite(v) for v in
                  [sess.step(x, y).item()]), f"{tag}: non-finite loss")
        sess.close()
    del sessions, data
    torch.cuda.empty_cache()
    return out, launches


def within_limit(fn, seconds: float, what: str):
    """``fn()`` in a thread of its own, which must end within
    ``seconds``: a step whose backward deadlocks fails the run instead
    of hanging it. Re-raises what ``fn`` raised."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    t = threading.Thread(target=run, name=f"limit-{what}", daemon=True)
    t.start()
    t.join(seconds)
    check(not t.is_alive(), f"{what}: did not finish within {seconds} s")
    if "error" in box:
        raise box["error"]
    return box.get("value")


@contextlib.contextmanager
def shard_decisions(k, taken: dict):
    """``decisions``' record mode in a sharded step: each shard's
    leaky-ReLU signs and pool winners, in its call order, in
    ``taken[rank]``."""
    bn_fn = k.cosmoflow.dist_norm.distributed_batchnorm
    pool_fn = k.cosmoflow.maxpool3d

    def mine() -> list:
        return taken.setdefault(k.spmd.axis(("data", "model")).index, [])

    def bn(x, scale, bias, reduce_axes=(), eps=1e-5, activation_slope=None):
        y = bn_fn(x, scale, bias, reduce_axes, eps, activation_slope)
        mine().append(y.detach() > 0)
        return y

    def pool(x, part, window=2, stride=2):
        mine().append(_windows(x.detach(), stride).argmax(-1))
        return pool_fn(x, part, window, stride)

    with mock.patch.object(k.cosmoflow.dist_norm, "distributed_batchnorm",
                           bn), pools(k, pool):
        yield


def decision_layouts(k, cfg, plan) -> list:
    """The layout of each decision a step records (``decisions``' call
    order: CosmoFlow's batch norm and pool of each block; the U-Net's two
    batch norms and the pool of each encoder level, the bottleneck's
    two, each decoder level's two) under ``plan``: "spatial" (depth split
    over the spatial axis), "batch" (the spatial axis moved into the
    batch) or "replicated" (gathered)."""
    def layout(layer):
        st = plan.stage_for(layer)
        if st.part.active:
            return "spatial"
        return "batch" if "model" in st.batch_axes else "replicated"

    if cfg.arch == "unet3d":
        d = cfg.depth
        layers = ([lvl for lvl in range(d) for _ in range(3)] + [d, d]
                  + [lvl for lvl in reversed(range(d)) for _ in range(2)])
    else:
        npool = k.cosmoflow.num_pools(cfg)
        layers = [i for i in range(k.cosmoflow.num_blocks(cfg))
                  for _ in range(2 if i < npool else 1)]
    return [layout(i) for i in layers]


def global_decisions(k, taken: dict, cfg, plan, mesh) -> list:
    """The sharded step's decisions as the unsharded step's: depth slabs
    concatenated along depth, the spatial group's batch chunks (a stage
    that moved it into the batch) and the data slices along the batch,
    and a block the plan gathers (replicated over the spatial group)
    from the group's first shard."""
    n_data, n_model = mesh.degree("data"), mesh.degree("model")
    out = []
    for j, lay in enumerate(decision_layouts(k, cfg, plan)):
        out.append(torch.cat([
            torch.cat([taken[d * n_model + m][j]
                       for m in (range(n_model) if lay != "replicated"
                                 else (0,))], 1 if lay == "spatial" else 0)
            for d in range(n_data)], 0))
    return out


def train_batch(cfg, batch: int, g) -> tuple:
    """A seeded batch on the card: volumes, and CosmoFlow's targets or
    the U-Net's voxel labels (classes uniform over ``out_dim``)."""
    w = cfg.input_width
    x = torch.randn((batch, w, w, w, cfg.in_channels), generator=g,
                    device="cuda")
    if cfg.arch == "unet3d":
        return x, torch.randint(0, cfg.out_dim, (batch, w, w, w),
                                generator=g, device="cuda")
    return x, torch.randn((batch, cfg.out_dim), generator=g, device="cuda")


def phase_train_spatial(k, cfg, runs, batch: int, unpack_tags, RunConfig,
                        compile, plan_lib, depth, card: str,
                        split_reps: int = 3, name: str = "") -> tuple:
    """Hybrid data x spatial training of ``cfg`` at ``batch``, every shard
    on this card, in each of ``runs`` (``TRAIN_SPATIAL`` for
    cosmoflow-128 b4, ``UNET_SPATIAL`` for the U-Net at 64^3 b2; the runs
    tagged ``unpack_tags`` must launch the unpack kernel):

    1. step 1's loss and reduced gradients (the ``grad_comm`` probe)
       held against the unsharded step: fp32 against the fp64 unsharded
       step that takes the sharded step's leaky-ReLU signs and pool
       winners (``shard_decisions``, ``global_decisions``), every leaf
       within max(``STEP1_FP32``, the plain fp32 unsharded step's own
       distance from fp64) of its max-abs; bf16 no farther from fp64
       than ``STEP1_BF16`` x the plain bf16 step; the loss within
       ``STEP1_LOSS`` of the plain unsharded step's; a planned run's
       distance from the fixed plan's step 1 on its mesh, where the runs
       hold one (recorded; the loss within ``STEP1_LOSS``);
    2. the main path: ``SPATIAL_STEPS`` steps each, every loss finite,
       the launches per step of each kernel equal to
       ``kernel_launches(train=True)``; two runs with one tag (two
       reduction lowerings) agree after 2 steps within
       ``MODES_ATOL``/``MODES_RTOL`` (and whether bitwise);
    3. timings: ms per step (host clock, median of 3 after a warm-up)
       beside ``describe().predicted_step_s``, the probes' split (median
       of ``split_reps``), peak memory.

    Each part of each configuration runs under ``within_limit``.
    Returns (report, launches of the main path)."""
    out = {"vs_unsharded": {}, "steps": {}, "timing": {}, "card": card,
           "note": "every shard on one card: these times measure the "
                   "sharded step's overhead, not scaling"}
    g = torch.Generator(device="cuda").manual_seed(11)
    x, y = train_batch(cfg, batch, g)
    model = k.unet3d if cfg.arch == "unet3d" else k.cosmoflow
    phase = name or "train_spatial" + ("_unet" if cfg.arch == "unet3d"
                                       else "")

    def rel(a, b):
        return ((a.double() - b.double()).abs().max().item()
                / max(1e-30, b.double().abs().max().item()))

    # the unsharded steps the checks are held to, per precision
    base = {}
    for prec in sorted({r[3] for r in runs}):
        one = compile(RunConfig(model=cfg, mode="train", global_batch=batch,
                                precision=prec))
        with plain_training(k):
            plain_loss, plain = loss_and_grads(k, one, x, y)
        _, exact = fp64_grads(k, one, x, y)
        base[prec] = (one, plain_loss.item(), plain, exact)
    torch.cuda.synchronize()

    sessions, step1 = {}, {}
    for tag, D, S, prec, mode, kind in runs:
        key = f"{tag}/{D}x{S}/{prec}/{mode}/{kind}"
        plan = "fixed" if kind == "fixed" else spatial_plan(
            plan_lib, depth, cfg, S, kind, D)
        one, plain_loss, plain, exact = base[prec]

        def check_step1():
            sess = compile(RunConfig(model=cfg, mode="train",
                                     global_batch=batch, precision=prec,
                                     data=D, spatial=S, grad_comm=mode,
                                     plan=plan),
                           devices=["cuda:0"] * (D * S))
            check(sess.mesh.shape == {"data": D, "model": S}
                  and all(torch.equal(sess.params[n], one.params[n])
                          for n in one.params), f"{key}: mesh or params")
            probe = k.train_step.make_convnet_phase_probes(
                sess.cfg, sess.mesh, sess.optimizer, global_batch=batch,
                plan=sess.plan, grad_comm=mode,
                precision=prec)["grad_comm"]
            taken = {}
            with shard_decisions(k, taken):
                loss, grads = probe(sess.params, sess.opt_state, x, y, 0)
            row = {n: {"plain_vs_fp64": rel(plain[n], exact[n]),
                       "vs_fp64": rel(grads[n], exact[n])} for n in grads}
            if prec == "fp32":
                replay = global_decisions(k, taken, cfg, sess.plan,
                                          sess.mesh)
                _, same = fp64_grads(k, one, x, y, lambda: decisions(
                    k, replay, replay=True))
                for n in grads:
                    row[n]["vs_fp64_same_decisions"] = rel(grads[n], same[n])
                bad = {n: r for n, r in row.items()
                       if r["vs_fp64_same_decisions"]
                       > max(STEP1_FP32, r["plain_vs_fp64"])}
                worst_key = "vs_fp64_same_decisions"
            else:
                bad = {n: r for n, r in row.items()
                       if r["vs_fp64"] > STEP1_BF16 * r["plain_vs_fp64"]}
                worst_key = "vs_fp64"
            loss_err = abs(loss.item() - plain_loss) / abs(plain_loss)
            check(loss_err <= STEP1_LOSS[prec] and not bad,
                  f"{key}: step 1 vs the unsharded step: loss {loss_err}; "
                  f"gradients out of bounds {bad}")
            worst = max(row, key=lambda n: row[n][worst_key])
            step1[key] = (loss.item(), grads)
            out["vs_unsharded"][key] = {"loss": loss.item(),
                                        "plain_loss": plain_loss,
                                        "loss_rel_err": loss_err,
                                        "grads": row}
            log(phase, f"{key}: step 1 vs the unsharded step: "
                f"loss {loss_err:.3g}; worst gradient by {worst_key}: "
                f"{worst} {json.dumps(row[worst])} (share of the leaf's "
                "max-abs); every leaf within its bound")
            return sess

        sessions[key] = within_limit(check_step1, SPATIAL_LIMIT_S,
                                     f"{key} step 1")
        torch.cuda.synchronize()
    for one, *_ in base.values():
        one.close()
    del base
    # a planned run beside the fixed plan's step 1 on its mesh
    for (tag, D, S, prec, mode, kind), key in zip(runs, list(step1)):
        fixed = next((k2 for (t2, D2, S2, p2, m2, kind2), k2 in zip(
            runs, step1) if kind2 == "fixed" and (D2, S2, p2, m2)
                      == (D, S, prec, mode)), None)
        if kind == "fixed" or fixed is None:
            continue
        (loss, grads), (floss, fgrads) = step1[key], step1[fixed]
        loss_err = abs(loss - floss) / abs(floss)
        dist = {n: rel(grads[n], fgrads[n]) for n in grads}
        check(loss_err <= STEP1_LOSS[prec], f"{key}: step 1's loss vs the "
              f"fixed plan's {loss_err}")
        worst = max(dist, key=dist.get)
        out["vs_unsharded"][key]["vs_fixed"] = {
            "loss_rel_err": loss_err, "grads": dist}
        log(phase, f"{key}: step 1 vs the fixed plan's ({fixed}): loss "
            f"{loss_err:.3g}; farthest gradient {worst} {dist[worst]:.3g} "
            "of its max-abs (each plan's own decisions; both within their "
            "bounds from fp64 above)")
    del step1
    torch.cuda.empty_cache()

    # ------------------------------------------------ the main path ----
    zero_counts(k)
    expected = dict(NO_LAUNCHES)
    after_two = {}
    for (tag, D, S, prec, mode, kind), (key, sess) in zip(
            runs, sessions.items()):
        per_step = dict(NO_LAUNCHES, **model.kernel_launches(
            cfg, sess.plan, train=True))

        def steps():
            torch.cuda.synchronize()
            # the other configurations' streams keep blocks cached: free
            # them, so that reserved memory is this configuration's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            c0 = counts(k)
            losses = []
            for i in range(SPATIAL_STEPS):
                losses.append(sess.step(x, y).item())
                if i == 1:
                    after_two[key] = {n: v.clone()
                                      for n, v in sess.params.items()}
            torch.cuda.synchronize()
            return losses, delta(counts(k), c0)

        losses, got = within_limit(steps, SPATIAL_LIMIT_S, f"{key} steps")
        want = {n: v * SPATIAL_STEPS for n, v in per_step.items()}
        check(got == want, f"{key}: launches {got} over {SPATIAL_STEPS} "
              f"steps, expected {per_step} per step (kernel_launches)")
        check(got["pack"] > 0 and (got["unpack"] > 0) == (tag in unpack_tags),
              f"{key}: pack/unpack launches {got}")
        check(all(math.isfinite(v) for v in losses),
              f"{key}: non-finite losses {losses}")
        expected = {n: expected[n] + want[n] for n in KERNELS}
        row = out["steps"][key] = {
            "losses": losses, "launches_per_step": per_step,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved()}
        log(phase, f"{key}: {SPATIAL_STEPS} steps, losses "
            f"{losses}; launches per step {json.dumps(per_step)} = "
            f"kernel_launches; peak {row['peak_bytes'] / 2 ** 30:.2f} GiB "
            f"allocated, {row['peak_reserved_bytes'] / 2 ** 30:.2f} GiB "
            f"reserved ({card})")
    launches = counts(k)
    check(launches == expected, f"{phase} path launches {launches}, "
          f"expected {expected}")
    log("main path", f"{phase}: launches {launches}")
    tags = [r[0] for r in runs]
    out["modes"] = {}
    for tag in sorted({t for t in tags if tags.count(t) == 2}):
        (ka, a), (kb, b) = ((key, after_two[key]) for key in sessions
                            if key.startswith(tag + "/"))
        what = f"{ka.split('/')[1]} {ka.split('/')[3]} vs {kb.split('/')[3]}"
        diff = {n: (a[n] - b[n]).abs().max().item() for n in a}
        bad = {n for n in a if not torch.allclose(
            a[n], b[n], atol=MODES_ATOL, rtol=MODES_RTOL)}
        check(not bad, f"{tag} {what} after 2 steps: {bad}")
        bitwise = all(torch.equal(a[n], b[n]) for n in a)
        out["modes"][f"{tag} {what}"] = {"max_abs": max(diff.values()),
                                          "bitwise": bitwise}
        log(phase, f"{what} ({tag}) after 2 steps: max abs difference "
            f"{max(diff.values()):.3g} (atol {MODES_ATOL}, rtol "
            f"{MODES_RTOL}); bitwise {bitwise}")

    # ------------------------------------------------------ timings ----
    for key, sess in sessions.items():
        def timed():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            return {"step_ms": host_ms(lambda: sess.step(x, y), 3),
                    **step_split(k, sess, x, y, split_reps),
                    "plan": sess.plan.name,
                    "predicted_step_s": sess.describe().predicted_step_s}

        row = out["timing"][key] = within_limit(timed, SPATIAL_LIMIT_S,
                                                f"{key} timings")
        log("timings", f"{phase} {key} ({card}; every shard on one "
            "card: the sharded step's overhead, not scaling; predicted: "
            "the H100 model, a card a shard): " + json.dumps(row))
        sess.close()
    del sessions, after_two, x, y
    torch.cuda.empty_cache()
    return out, launches


def phase_plans(k, cfg, ucfg, ucfg64, RunConfig, compile, plan_lib, depth,
                card: str) -> tuple:
    """Phase 10p: the cost-model planner's layouts on the card, every
    shard on it (main paths, the launch counters zeroed before each part
    and read after):

    1. training under one-transition plans (``PLANS_TRAIN``,
       cosmoflow-128 b4 fp32; ``PLANS_UNET``, the U-Net at 64^3 b2):
       phase 10b's checks (step 1 against the unsharded fp64 step with
       the run's own decisions, launches per step against
       ``kernel_launches``, timings beside ``predicted_step_s``), the
       distance from the fixed plan's step 1 on the same mesh, and
       overlap against ZeRO-1 after 2 steps;
    2. the all_to_all (``reshard.spatial_to_batch``) at the b1 and b2
       plans' boundary shapes, 1 x 2 and 1 x 4: bitwise its gather-and-
       slice oracle, undone by ``batch_to_spatial``, both timed;
       ``plan="auto"`` and ``memory_budget_gib`` (``PLANS_AUTO``): the
       chosen plan, its modeled peak and the measured peak of a step
       (allocated, less ``foreign_bytes``: the run's own), the step's
       launches and time beside ``predicted_step_s``; a budget below
       every candidate (``PLANS_FLOOR_BUDGET_GIB``) raises naming the
       floor;
    3. batch-sharded serving (``PLANS_SERVE``: cosmoflow-128 b4 at data
       2, at 2 x 2, and plan="auto" at S = 2) against data 1 (fp32
       1e-5), a harness at data 2, and the U-Net's batch plan served at
       256^3 b2 S = 2 against its fixed plan (fp32 1e-5), launches per
       forward against ``kernel_launches``.

    Returns (report, launches of its main paths)."""
    t0 = time.perf_counter()
    out = {"card": card}
    launches = dict(NO_LAUNCHES)

    def add(got):
        nonlocal launches
        launches = {n: launches[n] + got[n] for n in KERNELS}

    release_cached("the plans phase")
    out["train"], got = phase_train_spatial(
        k, cfg, PLANS_TRAIN, 4, {"p-d"}, RunConfig, compile, plan_lib,
        depth, card, split_reps=1, name="plans")
    add(got)
    out["train_unet"], got = phase_train_spatial(
        k, ucfg64, PLANS_UNET, UNET_CHECK_BATCH, set(), RunConfig, compile,
        plan_lib, depth, card, split_reps=1, name="plans_unet")
    add(got)

    # ------------------------ the all_to_all against its oracle ----
    from repro_torch.core import reshard
    from repro_torch.launch.mesh import Mesh

    g = torch.Generator(device="cuda").manual_seed(21)
    out["all_to_all"] = {}
    layers = plan_lib.perf_model.cosmoflow_layers(cfg)
    for S, b in ((2, 1), (2, 2), (4, 1), (4, 2)):
        mesh = Mesh([("data", 1), ("model", S)], ["cuda:0"] * S)
        w, c = layers[b].width, layers[b].cin  # block b's input at b4
        xs = [torch.randn((4, w // S, w, w, c), generator=g, device="cuda")
              for _ in range(S)]

        def a2a(t):
            return reshard.spatial_to_batch(t, "model", 1)

        def oracle(t):
            return reshard.spatial_to_batch_oracle(t, "model", 1)

        got, want = k.spmd.run(mesh, a2a, xs), k.spmd.run(mesh, oracle, xs)
        back = k.spmd.run(mesh, lambda t: reshard.batch_to_spatial(
            t, "model", 1), got)
        check(all(torch.equal(a, o) for a, o in zip(got, want))
              and all(torch.equal(a, x_) for a, x_ in zip(back, xs)),
              f"all_to_all 1x{S} at block {b}'s input: not the oracle's "
              "bits, or batch_to_spatial does not undo it")
        row = out["all_to_all"][f"1x{S}/block{b}"] = {
            "shard_shape": list(xs[0].shape), "bitwise_vs_oracle": True,
            "ms": host_ms(lambda: k.spmd.run(mesh, a2a, xs), 5),
            "oracle_ms": host_ms(lambda: k.spmd.run(mesh, oracle, xs), 5)}
        log("plans", f"spatial_to_batch 1x{S} at block {b}'s input (a "
            f"shard {tuple(xs[0].shape)} fp32): bitwise the gather-and-"
            f"slice oracle's, undone by batch_to_spatial; {row['ms']:.3f} "
            f"ms against the oracle's {row['oracle_ms']:.3f} (host clock, "
            f"every shard's copy on this card; {card})")
        del xs, got, want, back

    # ------------------------------------- plan="auto", the budget ----
    x, y = train_batch(cfg, 4, g)
    out["auto"] = {}
    zero_counts(k)
    expected = dict(NO_LAUNCHES)
    for tag, kw, n in PLANS_AUTO:
        sess = compile(RunConfig(model=cfg, mode="train", global_batch=4,
                                 **kw), devices=["cuda:0"] * n)
        rep = sess.describe()
        per_step = dict(NO_LAUNCHES, **k.cosmoflow.kernel_launches(
            cfg, sess.plan, train=True))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        c0 = counts(k)
        first = sess.step(x, y).item()  # the warm-up
        resident = torch.cuda.memory_allocated()
        peak = k.memory.measured_peak_bytes(lambda: sess.step(x, y))
        got = delta(counts(k), c0)
        want = {n_: 2 * v for n_, v in per_step.items()}
        check(got == want, f"{tag}: launches {got} over 2 steps, expected "
              f"{per_step} a step (kernel_launches)")
        expected = {n_: expected[n_] + want[n_] for n_ in KERNELS}
        ms = host_ms(lambda: sess.step(x, y), 3)
        expected = {n_: expected[n_] + 4 * per_step[n_] for n_ in KERNELS}
        check(math.isfinite(first), f"{tag}: loss {first}")
        foreign = foreign_bytes(resident, sess, x, y)
        own = peak.allocated - foreign
        budget = rep.memory_budget_bytes
        row = out["auto"][tag] = {
            "plan": sess.plan.name, "precision": sess.precision,
            "mesh": sess.mesh.shape, "loss": first,
            "modeled": modeled(sess), "budget_bytes": budget,
            "peak_bytes": peak.allocated,
            "peak_reserved_bytes": peak.reserved,
            "resident_bytes_before": resident, "foreign_bytes": foreign,
            "own_peak_bytes": own,
            "modeled_over_own_peak": rep.modeled_peak.total / own,
            "ms_per_step": ms, "predicted_step_s": rep.predicted_step_s,
            "launches_per_step": per_step}
        check(budget is None or rep.modeled_peak.total <= budget,
              f"{tag}: modeled peak over the budget")
        log("plans", f"{tag}: chose {sess.plan.name} ({sess.precision}, "
            f"mesh {sess.mesh.shape}); modeled peak "
            f"{rep.modeled_peak.total / 2 ** 30:.3f} GiB a shard"
            + ("" if budget is None else
               f" (budget {budget / 2 ** 30:.2f})")
            + f"; measured {peak.allocated / 2 ** 30:.3f} GiB allocated, "
            f"{foreign / 2 ** 30:.3f} of it other phases' (own "
            f"{own / 2 ** 30:.3f}, every shard on this card), "
            f"{peak.reserved / 2 ** 30:.3f} reserved; {ms:.2f} ms a step "
            f"against {rep.predicted_step_s * 1e3:.2f} predicted (the "
            f"H100 model, a card a shard; {card})")
        sess.close()
    got = counts(k)
    check(got == expected, f"plans auto path launches {got}, expected "
          f"{expected}")
    log("main path", f"plans auto: launches {got}")
    add(got)
    floor = min(
        k.memory.plan_peak_bytes(cfg, dataclasses.replace(v, precision=p),
                                 global_batch=4).total
        for s in (1, 2, 4)
        for c in plan_lib.candidate_convnet_plans(
            cfg, plan_lib.perf_model.H100, spatial_degree=s,
            global_batch=4)
        for v in plan_lib.remat_variants(cfg, c) for p in ("fp32", "bf16"))
    try:
        compile(RunConfig(model=cfg, mode="train", global_batch=4,
                          memory_budget_gib=PLANS_FLOOR_BUDGET_GIB),
                devices=["cuda:0"] * 4)
        raised = None
    except ValueError as e:  # RunConfigError
        raised = e
    check(raised is not None and getattr(raised, "field", "")
          == "memory_budget_gib"
          and f"{floor / 2 ** 30:.3f} GiB" in str(raised),
          f"a {PLANS_FLOOR_BUDGET_GIB} GiB budget: {raised!r}, floor "
          f"{floor / 2 ** 30:.3f} GiB")
    out["floor"] = {"budget_gib": PLANS_FLOOR_BUDGET_GIB,
                    "floor_bytes": floor, "error": str(raised)}
    log("plans", f"budget {PLANS_FLOOR_BUDGET_GIB} GiB: raises "
        f"RunConfigError(memory_budget_gib) naming the "
        f"{floor / 2 ** 30:.3f} GiB floor: {raised}")
    del x, y

    # ------------------------------------ batch-sharded serving ----
    out["serve"] = {}
    x = torch.randn((4, 128, 128, 128, 4), generator=g, device="cuda")
    base = compile(RunConfig(model=cfg, mode="infer", global_batch=4))
    want = base.predict(x)
    base.close()
    zero_counts(k)
    expected = dict(NO_LAUNCHES)
    for D, S, plan in PLANS_SERVE:
        tag = f"{cfg.name}/fp32/{D}x{S}/{plan}"
        sess = compile(RunConfig(model=cfg, mode="infer", global_batch=4,
                                 data=D, spatial=S, plan=plan),
                       devices=["cuda:0"] * (D * S))
        per_fwd = dict(NO_LAUNCHES, **k.cosmoflow.kernel_launches(
            cfg, sess.plan))
        c0 = counts(k)
        pred = sess.predict(x)
        check(delta(counts(k), c0) == per_fwd,
              f"{tag}: launches per forward (kernel_launches)")
        err = rel_err(pred, want)
        check(tuple(pred.shape) == (4, 4) and err <= 1e-5,
              f"{tag}: vs data 1 {err}")
        ms = host_ms(lambda: sess.predict(x), 5)
        forwards = 7  # the checked one, host_ms's warm-up and 5
        if D > 1:  # the harness pads 3 requests to 4
            with sess.serve(max_batch=4, max_wait_ms=50) as h:
                rows = [f.result(timeout=300) for f in h.submit_many(
                    [r.cpu().numpy() for r in x[:3]])]
            check(all(r.shape == (4,) and np.all(np.isfinite(r))
                      for r in rows), f"{tag}: harness replies")
            forwards += int(sess.telemetry()["serve.batches"])
        expected = {n: expected[n] + forwards * per_fwd[n] for n in KERNELS}
        out["serve"][tag] = {"plan": sess.plan.name, "rel_err_vs_data1": err,
                             "tol": 1e-5, "ms": ms,
                             "launches_per_forward": per_fwd}
        log("plans", f"serve {tag}: plan {sess.plan.name}; vs data 1 "
            f"{err:.3g} <= 1e-5; launches per forward {json.dumps(per_fwd)}"
            f"; {ms:.2f} ms a batch ({card})")
        sess.close()
    del x, want, pred
    release_cached("the U-Net's planned serving")
    batch, S, kind = PLANS_UNET_SERVE
    x = torch.randn((batch, 256, 256, 256, 1), generator=g, device="cuda")
    logits = {}
    for name in ("fixed", kind):
        tag = f"{ucfg.name}/fp32/b{batch}/S{S}/{name}"
        plan = "fixed" if name == "fixed" else spatial_plan(
            plan_lib, depth, ucfg, S, name)
        sess = compile(RunConfig(model=ucfg, mode="infer",
                                 global_batch=batch, spatial=S, plan=plan),
                       devices=["cuda:0"] * S)
        per_fwd = dict(NO_LAUNCHES, **k.unet3d.kernel_launches(ucfg,
                                                               sess.plan))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = counts(k)
        logits[name] = sess.predict(x)
        check(delta(counts(k), c0) == per_fwd,
              f"{tag}: launches per forward (kernel_launches)")
        expected = {n: expected[n] + per_fwd[n] for n in KERNELS}
        ms = host_ms(lambda: sess.predict(x), 1)
        expected = {n: expected[n] + 2 * per_fwd[n] for n in KERNELS}
        out["serve"][tag] = {"plan": sess.plan.name, "ms": ms,
                             "peak_bytes": torch.cuda.max_memory_allocated(),
                             "launches_per_forward": per_fwd}
        sess.close()
    err = rel_err(logits[kind], logits["fixed"])
    check(tuple(logits[kind].shape) == (batch, 256, 256, 256, 3)
          and err <= 1e-5, f"{ucfg.name} b{batch} S{S} {kind} vs fixed {err}")
    out["serve"][f"{ucfg.name}/fp32/b{batch}/S{S}/{kind}"][
        "rel_err_vs_fixed"] = err
    log("plans", f"serve {ucfg.name} b{batch} S={S}: {kind} vs the fixed "
        f"plan {err:.3g} <= 1e-5; " + json.dumps(
            {n: out["serve"][f"{ucfg.name}/fp32/b{batch}/S{S}/{n}"]
             for n in ("fixed", kind)}) + f" ({card})")
    del x, logits
    got = counts(k)
    check(got == expected, f"plans serving launches {got}, expected "
          f"{expected}")
    log("main path", f"plans serving: launches {got}")
    add(got)
    release_cached("the phases after 10p")
    out["seconds"] = time.perf_counter() - t0
    log("plans", f"all plan checks ok in {out['seconds']:.0f}s; launches "
        f"{json.dumps(launches)}")
    return out, launches


def phase_unet_serve(k, cfg, RunConfig, compile) -> tuple:
    """The U-Net's serving main path: ``compile(RunConfig(model=
    "unet3d-256", mode="infer"))`` at batch 1 in each of ``UNET_SERVE``,
    every shard on this card. Each predict: per-voxel logits (1, 256,
    256, 256, 3), finite, launches per forward equal to
    ``unet3d.kernel_launches``, within 1e-4 (fp32) or 5e-2 (bf16) of the
    logits' scale of the same forward through the plain versions, and at
    S > 1 within 1e-5 of the unsharded fp32 forward (the reference's
    contract); then ``serve(max_batch=1)`` answers 4 requests with none
    failed (a 256^3 volume is a batch: two would double the forward's
    ~29 GB). The launch counters are zeroed before and read after. Timed
    after: predict (host clock, median of 3) and its peak memory per
    configuration, one profiled unsharded fp32 predict. Returns (report,
    launches)."""
    g = torch.Generator(device="cuda").manual_seed(12)
    w = cfg.input_width
    x = torch.randn((1, w, w, w, cfg.in_channels), generator=g,
                    device="cuda")
    shape = (1, w, w, w, cfg.out_dim)
    out = {"serve": {}, "predict": {}}
    zero_counts(k)
    expected = dict(NO_LAUNCHES)
    unsharded, sessions = {}, {}
    for S, prec in UNET_SERVE:
        tag = f"{cfg.name}/{prec}/S{S}"
        t0 = time.perf_counter()
        sess = compile(RunConfig(model=cfg.name, mode="infer",
                                 global_batch=1, precision=prec, spatial=S),
                       devices=["cuda:0"] * S)
        check(sess.device.type == "cuda" and sess.mesh.shape == {
            "data": 1, "model": S}, f"{tag}: mesh {sess.mesh}")
        per_fwd = dict(NO_LAUNCHES, **k.unet3d.kernel_launches(cfg,
                                                                sess.plan))
        rel = 1e-4 if prec == "fp32" else 5e-2
        pred, err = serve_and_compare(sess, x, k, rel, tag, per_fwd, shape)
        expected = {n: expected[n] + per_fwd[n] for n in KERNELS}
        row = {"launches_per_forward": per_fwd, "rel_err_vs_plain": err,
               "tol_vs_plain": rel}
        if S == 1:
            unsharded[prec] = pred
        else:
            err_u = rel_err(pred, unsharded[prec])
            tol = 1e-5 if prec == "fp32" else 5e-2
            check(err_u <= tol, f"{tag}: vs the unsharded forward {err_u} "
                  f"> {tol}")
            row.update(rel_err_vs_unsharded=err_u, tol_vs_unsharded=tol)
        del pred
        row["seconds"] = time.perf_counter() - t0
        out["serve"][tag] = row
        sessions[tag] = sess
        log("unet_serve", f"{tag} batch 1: logits {shape}; launches "
            f"{json.dumps(per_fwd)} = kernel_launches; vs plain "
            f"{err:.3g} <= {rel}" + (
                f"; vs unsharded {row['rel_err_vs_unsharded']:.3g}"
                if S > 1 else "") + f"; {row['seconds']:.1f}s wall")
    sess = sessions[f"{cfg.name}/fp32/S1"]
    reqs = np.random.default_rng(3).standard_normal(
        (4, w, w, w, cfg.in_channels), dtype=np.float32)
    with sess.serve(max_batch=1, max_wait_ms=1) as h:
        rows = [f.result(timeout=300) for f in h.submit_many(list(reqs))]
    check(all(r.shape == shape[1:] and np.all(np.isfinite(r))
              for r in rows), "unet harness replies")
    tele = sess.telemetry()
    check(tele["serve.requests"] == 4 and tele["serve.worker_failures"] == 0,
          f"unet harness telemetry {tele}")
    per_fwd = out["serve"][f"{cfg.name}/fp32/S1"]["launches_per_forward"]
    expected = {n: expected[n] + per_fwd[n] * int(tele["serve.batches"])
                for n in KERNELS}
    out["harness"] = tele
    log("unet_serve", f"harness: 4/4 futures resolved, 0 failed; "
        f"telemetry {json.dumps(tele)}")
    del rows, reqs, unsharded
    launches = counts(k)
    check(launches == expected, f"unet serving launches {launches}, "
          f"derived from the plans {expected}")
    log("main path", f"unet_serve: launches {launches} = derived from the "
        "plans")
    for tag, sess in sessions.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        ms = host_ms(lambda: sess.predict(x), 3)
        out["predict"][tag] = {
            "ms": ms, "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
            "resident_bytes_before": resident,
            "foreign_bytes": foreign_bytes(resident, sess, x),
            "modeled": modeled(sess)}
        log("timings", f"unet predict {tag}: " + json.dumps(
            out["predict"][tag]))
    out["profile"] = device_profile(
        lambda: sessions[f"{cfg.name}/fp32/S1"].predict(x))
    log("profile", f"unet predict {cfg.name}/fp32/S1 "
        + json.dumps(out["profile"]))
    for sess in sessions.values():
        sess.close()
    del sessions, x
    torch.cuda.empty_cache()
    return out, launches


def phase_unet_long_k(k, cfg) -> dict:
    """The longest K of the U-Net, in fp32 against fp64 at its unet3d-256
    b1 shapes: ``dec2_w0``'s forward (K = 27 x 512) and ``mid_w1``'s input
    gradient (K = 27 x 512), each by the conv kernel with the K split
    ``ops.plan`` chose, held within 1e-6 sqrt(K) of the output's scale
    (ROADMAP §3's conv3d contract), beside the plain fp32 conv's own
    distance from fp64. He-scaled weights, unit normal inputs."""
    g = torch.Generator(device="cuda").manual_seed(13)
    shapes = k.unet3d.conv_shapes(cfg, 1)
    names = [f"{p}_w{i}" for p in [f"enc{l}" for l in range(cfg.depth)]
             + ["mid"] + [f"dec{l}" for l in reversed(range(cfg.depth))]
             for i in (0, 1)]
    by_name = dict(zip(names, shapes))
    rows = {}
    sms = k.conv_ops._sms(0)
    for name, grad in (("dec2_w0", False), ("mid_w1", True)):
        xs, ws, _, pads = by_name[name]
        ys = xs[:4] + (ws[4],)
        w = torch.randn(ws, generator=g, device="cuda") * math.sqrt(
            2.0 / math.prod(ws[:4]))
        if grad:  # dL/dx from dy, the flipped and transposed filter's K
            dy = torch.randn(ys, generator=g, device="cuda")
            w_t = w.flip((0, 1, 2)).transpose(3, 4).contiguous()
            got = k.conv_ops.conv3d_input_grad(dy, w, xs, 1, pads)
            plain = k.conv_ref.conv3d_valid(dy, w_t, 1, pads)
            want = torch.nn.grad.conv3d_input(
                (xs[0], xs[4]) + xs[1:4], w.double().permute(4, 3, 0, 1, 2),
                dy.double().permute(0, 4, 1, 2, 3), padding=1).permute(
                    0, 2, 3, 4, 1)
            plan = k.conv_ops.plan(ys, w_t.shape, xs, torch.float32, sms,
                                   dy.data_ptr(), 1)
            kk = math.prod(w_t.shape[:4])
        else:
            x = torch.randn(xs, generator=g, device="cuda")
            got = k.conv_ops.conv3d_valid(x, w, 1, pads)
            plain = k.conv_ref.conv3d_valid(x, w, 1, pads)
            want = conv64(x.double(), w.double(), 1, pads)
            plan = k.conv_ops.plan(xs, ws, ys, torch.float32, sms,
                                   x.data_ptr(), 1)
            kk = math.prod(ws[:4])
        torch.cuda.synchronize()
        scale = max(1.0, want.abs().max().item())
        err = (got.double() - want).abs().max().item() / scale
        plain_err = (plain.double() - want).abs().max().item() / scale
        bound_ = 1e-6 * math.sqrt(kk)
        rows[name] = {"what": "input gradient" if grad else "forward",
                      "K": kk, "splits": plan.splits,
                      "kernel": "patch" if plan.stages else "gather",
                      "rel_err_vs_fp64": err, "plain_rel_err_vs_fp64":
                      plain_err, "contract": bound_,
                      "share_of_contract": err / bound_}
        check(err <= bound_, f"long K {name}: {err} > {bound_}")
        log("unet_long_k", f"{name} {rows[name]['what']} at {list(xs)}, K "
            f"{kk}: {plan.splits} K split(s), {rows[name]['kernel']} "
            f"kernel; vs fp64 {err:.3g} of the scale ({err / bound_:.1%} of "
            f"1e-6 sqrt(K) = {bound_:.3g}); the plain fp32 conv "
            f"{plain_err:.3g}")
        del got, plain, want, w
    torch.cuda.empty_cache()
    return rows


def phase_unet_train(k, cfg, RunConfig, compile) -> tuple:
    """The U-Net's training main path. First step 1's accuracy at
    unet3d-256's widths and depth on a 64^3 input, batch 2, fp32 and bf16
    (``step1_vs_plain``: the gates of phase 10). Then the main path:
    ``compile(RunConfig(model="unet3d-256", mode="train",
    global_batch=1))`` at 256^3 in fp32 and bf16, a warm-up then
    ``UNET_STEPS`` steps each (host clock each), every loss finite,
    launches per step equal to ``kernel_launches(train=True)``, peak
    memory allocated and reserved (default allocator settings: it must
    fit the card). Timed after: the probes' fwd / bwd / grad_comm / step
    split (one run each after a warm-up) and one profiled step. Returns
    (report, launches of the main path)."""
    out = {"vs_plain": {}, "steps": {}, "timing": {}, "profile": {}}
    g = torch.Generator(device="cuda").manual_seed(14)
    small = dataclasses.replace(cfg, name=f"{cfg.name}@{UNET_CHECK_WIDTH}",
                                input_width=UNET_CHECK_WIDTH)
    for prec in ("fp32", "bf16"):
        sess = compile(RunConfig(model=small, mode="train",
                                 global_batch=UNET_CHECK_BATCH,
                                 precision=prec))
        x, y = train_batch(small, UNET_CHECK_BATCH, g)
        out["vs_plain"][f"{small.name}/{prec}"], _ = step1_vs_plain(
            k, sess, x, y, f"{small.name} {prec} b{UNET_CHECK_BATCH}", prec)
        sess.close()
        del x, y
        torch.cuda.empty_cache()

    zero_counts(k)
    expected = dict(NO_LAUNCHES)
    sessions = {}
    x, y = train_batch(cfg, 1, g)
    for prec in ("fp32", "bf16"):
        tag = f"{cfg.name}/{prec}/b1"
        sess = compile(RunConfig(model=cfg.name, mode="train",
                                 global_batch=1, precision=prec))
        per_step = dict(NO_LAUNCHES, **k.unet3d.kernel_launches(
            cfg, sess.plan, train=True))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        log("memory", f"{tag}: {resident / 2 ** 30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved "
            "before the steps")
        c0 = counts(k)
        losses, ms = [], []
        for _ in range(1 + UNET_STEPS):
            t0 = time.perf_counter()
            losses.append(sess.step(x, y).item())
            ms.append((time.perf_counter() - t0) * 1e3)
        got = delta(counts(k), c0)
        n = 1 + UNET_STEPS
        check(got == {m: v * n for m, v in per_step.items()},
              f"{tag}: launches {got} over {n} steps, expected {per_step} "
              "per step (kernel_launches)")
        check(all(math.isfinite(v) for v in losses),
              f"{tag}: non-finite losses {losses}")
        expected = {m: expected[m] + got[m] for m in KERNELS}
        row = out["steps"][tag] = {
            "losses": losses, "step_ms": ms[1:],
            "ms_per_step": statistics.median(ms[1:]),
            "warm_up_ms": ms[0], "launches_per_step": per_step,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
            "resident_bytes_before": resident,
            "foreign_bytes": foreign_bytes(resident, sess, x, y),
            "modeled": modeled(sess),
            "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF")}
        log("unet_train", f"{tag}: warm-up + {UNET_STEPS} steps, losses "
            f"{losses}; {row['ms_per_step']:.1f} ms a step (median of "
            f"{UNET_STEPS}); launches per step {json.dumps(per_step)} = "
            f"kernel_launches; peak {row['peak_bytes'] / 2 ** 30:.2f} GiB "
            f"allocated, {row['peak_reserved_bytes'] / 2 ** 30:.2f} GiB "
            f"reserved (PYTORCH_CUDA_ALLOC_CONF {row['alloc_conf']})")
        sessions[tag] = sess
    launches = counts(k)
    check(launches == expected, f"unet train launches {launches}, "
          f"expected {expected}")
    log("main path", f"unet_train: launches {launches}")
    for tag, sess in sessions.items():
        torch.cuda.empty_cache()
        out["timing"][tag] = step_split(k, sess, x, y, 1)
        log("timings", f"unet train {tag}: " + json.dumps(out["timing"][tag]))
        out["profile"][tag] = device_profile(lambda: sess.step(x, y))
        log("profile", f"unet train {tag} " + json.dumps(out["profile"][tag]))
        sess.close()
    del sessions, x, y
    torch.cuda.empty_cache()
    return out, launches


def layer_rows(k, cfg, batch: int, prec: str, reps: int, gt, timing):
    """conv3d and bn_act at every conv of ``cfg``'s forward at ``batch``
    (``conv_shapes``), appended to ``timing``: the kernel (device time per
    call and the single call's), its plan, the plain version, the library
    call (``F.conv3d``, cuDNN, TF32 off; none for bn_act) and the
    bound."""
    conv_ops, conv_ref = k.conv_ops, k.conv_ref
    bn_ops, bn_ref = k.bn_ops, k.bn_ref
    dt = DTYPES[prec]
    shapes = k.for_config(cfg).conv_shapes(cfg, batch)
    for i, (xs, ws, s, pads) in enumerate(shapes):
        x = torch.randn(xs, generator=gt, device="cuda").to(dt)
        w = (torch.randn(ws, generator=gt, device="cuda") * 0.05).to(dt)
        y = conv_ops.conv3d_valid(x, w, s, pads)
        flops, nbytes = conv_work(xs, ws, tuple(y.shape), dt)
        b_ms, b_by = bound(flops, nbytes, dt, tf32x3=True)
        xc, wc = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2)
        (pd, qd), (ph, qh), (pw, qw) = pads
        lib = (lambda: F.conv3d(xc, wc, stride=s, padding=pd)) \
            if (pd, ph, pw) == (qd, qh, qw) else \
            (lambda: F.conv3d(F.pad(xc, (pw, qw, ph, qh, pd, qd)), wc,
                              stride=s))
        plan = conv_ops.plan(xs, ws, tuple(y.shape), dt,
                             conv_ops._sms(0), x.data_ptr(), s)
        ms, call_ms = device_ms(lambda: conv_ops.conv3d_valid(
            x, w, s, pads), reps)
        lib_ms, lib_call_ms = device_ms(lib, reps)
        row = {"config": cfg.name, "batch": batch, "dtype": prec,
               "layer": i, "x": list(xs), "w": list(ws), "stride": s,
               "kernel": "patch" if plan.stages else "gather",
               "splits": plan.splits, "ms": ms, "call_ms": call_ms,
               "plain_ms": median_ms(lambda: conv_ref.conv3d_valid(
                   x, w, s, pads), reps),
               "library_ms": lib_ms, "library_call_ms": lib_call_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "share_of_bound": b_ms / ms, "gflop": flops / 1e9}
        if dt == torch.float32:
            row["bound_cuda_core_ms"] = bound(flops, nbytes, dt)[0]
        timing["conv3d"].append(row)
        log("timings", f"conv3d {cfg.name} b{batch} {prec} layer {i}: "
            f"{row['kernel']} kernel, {plan.splits} K split(s), "
            f"{ms:.4f} ms ({b_ms / ms:.1%} of its {b_ms:.4f} ms bound) "
            f"vs F.conv3d {lib_ms:.4f} ms " + json.dumps(row))
        c = ws[4]
        yv = torch.randn(y.shape, generator=gt, device="cuda").to(dt)
        del x, y
        vec = [torch.randn(c, generator=gt, device="cuda")
               for _ in range(4)]
        vec[1] = F.softplus(vec[1])
        nbytes = 2 * yv.numel() * yv.element_size() + 16 * c
        b_ms, b_by = bound(5.0 * yv.numel(), nbytes, dt)
        ms, call_ms = device_ms(lambda: bn_ops.bn_leaky_relu(yv, *vec),
                                reps)
        row = {"config": cfg.name, "batch": batch, "dtype": prec,
               "layer": i, "x": list(yv.shape), "ms": ms,
               "call_ms": call_ms,
               "plain_ms": median_ms(lambda: bn_ref.bn_leaky_relu(
                   yv, *vec), reps),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        timing["bn_act"].append(row)
        log("timings", "bn_act " + json.dumps(row))
        del yv


def per_forward(timing, cfg, batch: int, prec: str) -> dict:
    """conv3d's rows of one forward summed: kernel, library, bound; and
    whether the kernel is no slower per forward and at layers 0-2."""
    rows = [r for r in timing["conv3d"]
            if r["config"] == cfg.name and r["dtype"] == prec
            and r["batch"] == batch]
    return {"ms": sum(r["ms"] for r in rows),
            "library_ms": sum(r["library_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "call_ms": sum(r["call_ms"] for r in rows),
            "library_call_ms": sum(r["library_call_ms"] for r in rows),
            "no_slower_per_forward": sum(r["ms"] for r in rows)
            <= sum(r["library_ms"] for r in rows),
            "no_slower_layers_0_2": [r["ms"] <= r["library_ms"]
                                     for r in rows[:3]]}


def phase_unet(k, cfg, cfg64, RunConfig, compile, plan_lib, depth,
               card: str, train: tuple) -> tuple:
    """Phases 10c-10f, the 3D U-Net (unet3d-256): serving (main path),
    the long-K check, each conv and bn_act of a 256^3 b1 forward timed
    against the library and the bound, and the sharded training steps
    at 64^3 (main path), beside ``train``, phase 10e's (report, launches)
    (run first: ``main``). Returns (report, launches of its main paths,
    each path's launches)."""
    t0 = time.perf_counter()
    release_cached("the U-Net phases")
    out, paths = {}, {}
    out["serve"], paths["unet_serve"] = phase_unet_serve(k, cfg, RunConfig,
                                                         compile)
    out["long_k"] = phase_unet_long_k(k, cfg)
    timing = {"conv3d": [], "bn_act": []}
    gt = torch.Generator(device="cuda").manual_seed(15)
    for prec in ("fp32", "bf16"):  # calls of 1-150 ms (cuDNN's to 16 s)
        layer_rows(k, cfg, 1, prec, 1, gt, timing)
    out["timing"] = timing
    out["conv_per_forward"] = {}
    for prec in ("fp32", "bf16"):
        key = f"{cfg.name}/{prec}/b1"
        out["conv_per_forward"][key] = per_forward(timing, cfg, 1, prec)
        log("timings", f"conv3d per forward {key}: "
            + json.dumps(out["conv_per_forward"][key]))
    torch.cuda.empty_cache()
    out["train"], paths["unet_train"] = train
    out["train_spatial"], paths["unet_train_spatial"] = phase_train_spatial(
        k, cfg64, UNET_SPATIAL, UNET_CHECK_BATCH, {"u-b"}, RunConfig,
        compile, plan_lib, depth, card, split_reps=1)
    launches = {n: sum(p[n] for p in paths.values()) for n in KERNELS}
    out["seconds"] = time.perf_counter() - t0
    log("unet", f"all U-Net phases ok in {out['seconds']:.0f}s; launches "
        f"{json.dumps(launches)}")
    return out, launches, paths


def halo_rows(k, cases, reps, floor_ms) -> dict:
    """pack and unpack at each (shape, lo, hi, dtype): kernel, plain
    version and library call (one ``torch.cat`` of the same views), each
    timed as device time per call (``queued_ms``: one call alone is
    shorter than its launch), the vectors a thread the kernel took, the
    byte bound (each input read once, each output written once), the
    launch floor and the kernel's share of its bound."""
    gt = torch.Generator(device="cuda").manual_seed(5)
    rows = {"pack": {}, "unpack": {}}
    for shape, lo, hi, prec in cases:
        dt = DTYPES[prec]
        x = torch.randn(shape, generator=gt, device="cuda").to(dt)
        n, d, h, w, c = shape
        row = h * w * c * x.element_size()
        face = n * (lo + hi) * row
        nxt, prv = x[:, d - lo:], x[:, :hi]
        bufs = [torch.randn((n, m, h, w, c), generator=gt,
                            device="cuda").to(dt) if m else None
                for m in (lo, hi)]
        parts = [b for b in (bufs[0], x, bufs[1]) if b is not None]
        key = (tuple(shape), lo, hi, prec)
        for name, fn, plain, cat, nbytes in (
                ("pack", lambda: k.pack_ops.pack(x, lo, hi),
                 lambda: k.pack_ref.pack(x, lo, hi),
                 lambda: torch.cat((nxt, prv), 1), 2 * face),
                ("unpack", lambda: k.pack_ops.unpack(x, *bufs),
                 lambda: k.pack_ref.unpack(x, *bufs),
                 lambda: torch.cat(parts, 1),
                 2 * (face + x.numel() * x.element_size()))):
            ms = queued_ms(fn, reps)
            bound = nbytes / PEAK_BYTES * 1e3
            sp = k.pack_ops.split(k.pack_ops.parts(name, n, d, row, lo, hi),
                                  n, k.pack_ops._sms(0))
            rows[name][key] = {
                "x": list(shape), "lo": lo, "hi": hi, "dtype": prec,
                "vectors": sp.vectors, "ms": ms,
                "plain_ms": queued_ms(plain, reps),
                "library_ms": queued_ms(cat, reps), "bound_ms": bound,
                "bound_by": "bytes", "launch_floor_ms": floor_ms,
                "share_of_bound": bound / ms}
        # unpack's adjoint: d_lo and d_hi out of the padded gradient, by
        # one pack launch (as the port does) or two narrow copies
        dout = torch.randn((n, lo + d + hi, h, w, c), generator=gt,
                           device="cuda").to(dt)
        rows["unpack"][key].update(
            adjoint_pack_ms=queued_ms(lambda: k.pack_ops.pack(dout, hi, lo),
                                      reps),
            adjoint_narrow_ms=queued_ms(lambda: (
                dout.narrow(1, 0, lo).contiguous(),
                dout.narrow(1, lo + d, hi).contiguous()), reps))
        for name in ("pack", "unpack"):
            log("timings", f"{name} " + json.dumps(rows[name][key]))
        del x, nxt, prv, bufs, parts, dout
    return rows


def unet_halo_totals(halo, name, unet3d, plan_lib, depth, cfg) -> dict:
    """pack's or unpack's calls in one unet3d-256 b1 forward at each of
    ``UNET_HALO``, summed over every shard (None where it has none)."""
    out = {}
    for S, prec in UNET_HALO:
        plan = plan_lib.legacy_convnet_plan(cfg, depth, (S, 1, 1))
        rows = [halo[name][(sc.shape, sc.lo, sc.hi, prec)]
                for sc in unet3d.split_convs(cfg, plan, 1)
                if name == "pack" or sc.no_interior]
        out[f"S{S}/{prec}"] = {
            key: S * sum(r[key] for r in rows) if rows else None
            for key in ("ms", "library_ms", "bound_ms")}
        out[f"S{S}/{prec}"]["calls"] = S * len(rows)
    return out


def remat_plan(plan_lib, depth, cfg, S: int, remat: bool = True,
               kind: str = "fixed"):
    """``spatial_plan``'s plan of ``cfg`` at spatial degree ``S`` (depth
    split, ``depth``) with every stage rematerialized (``remat``) or
    none."""
    plan = spatial_plan(plan_lib, depth, cfg, S, kind)
    return dataclasses.replace(plan, stages=tuple(
        dataclasses.replace(st, remat=remat) for st in plan.stages))


def phase_train_remat(k, cfgs, ucfg, RunConfig, compile, plan_lib, depth,
                      card: str) -> tuple:
    """Rematerialization on the card (a main path: every call below is
    counted). First step 1 of cosmoflow-128 b4 fp32 at each of
    ``REMAT_PARITY`` (every shard on this card) with every stage
    rematerialized against the same step without: the ``grad_comm``
    probe's loss within ``REMAT_LOSS`` and each reduced gradient within
    ``REMAT_ATOL``/``REMAT_RTOL`` (the reference's contract), whether
    the two are bitwise equal, the launches of each against
    ``kernel_launches(train=True)`` (the recompute counted), and the
    peak memory allocated and reserved of each; ms per step of each
    (host clock, median of 3). Then ``REMAT_RUNS``, each with every
    stage rematerialized, after the cached memory is released: its
    steps (the first a warm-up), every loss finite, launches per step
    against ``kernel_launches``, ms per timed step and the peak memory.
    Returns (report, launches)."""
    out = {"parity": {}, "runs": {}, "card": card}
    g = torch.Generator(device="cuda").manual_seed(21)
    cfg = cfgs["cosmoflow-128"]
    x, y = train_batch(cfg, 4, g)
    zero_counts(k)
    expected = dict(NO_LAUNCHES)
    for S, kind in REMAT_PARITY:
        got, sessions = {}, {}
        where = f"1x{S}" + ("" if kind == "fixed" else f" {kind}")
        for tag, remat in (("off", False), ("on", True)):
            sess = compile(RunConfig(model=cfg, mode="train", global_batch=4,
                                     spatial=S,
                                     plan=remat_plan(plan_lib, depth, cfg,
                                                     S, remat, kind)),
                           devices=["cuda:0"] * S)
            per_step = dict(NO_LAUNCHES, **k.cosmoflow.kernel_launches(
                cfg, sess.plan, train=True))
            probe = k.train_step.make_convnet_phase_probes(
                sess.cfg, sess.mesh, sess.optimizer, global_batch=4,
                plan=sess.plan)["grad_comm"]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            c0 = counts(k)
            loss, grads = within_limit(
                lambda: probe(sess.params, sess.opt_state, x, y, 0),
                SPATIAL_LIMIT_S, f"remat {tag} {where}")
            torch.cuda.synchronize()
            launched = delta(counts(k), c0)
            check(launched == per_step, f"remat {tag} {where}: launches "
                  f"{launched}, kernel_launches {per_step}")
            expected = {n: expected[n] + per_step[n] for n in KERNELS}
            got[tag] = {"loss": loss.item(), "grads": grads,
                        "launches": per_step,
                        "peak_bytes": torch.cuda.max_memory_allocated(),
                        "peak_reserved_bytes":
                            torch.cuda.max_memory_reserved()}
            sessions[tag] = sess
        on, off = got["on"], got["off"]
        loss_err = abs(on["loss"] - off["loss"])
        bad = [n for n in off["grads"] if not torch.allclose(
            on["grads"][n], off["grads"][n], atol=REMAT_ATOL,
            rtol=REMAT_RTOL)]
        check(loss_err <= REMAT_LOSS and not bad,
              f"remat {where}: loss {loss_err}, gradients out of bounds {bad}")
        bitwise = on["loss"] == off["loss"] and all(
            torch.equal(on["grads"][n], off["grads"][n])
            for n in off["grads"])
        worst = max((on["grads"][n] - off["grads"][n]).abs().max().item()
                    for n in off["grads"])
        for tag in ("off", "on"):  # the steps, counted
            c0 = counts(k)
            ms = host_ms(lambda: sessions[tag].step(x, y), 3)
            per_step = got[tag]["launches"]
            launched = delta(counts(k), c0)
            check(launched == {n: 4 * v for n, v in per_step.items()},
                  f"remat {tag} {where}: steps' launches {launched}")
            expected = {n: expected[n] + launched[n] for n in KERNELS}
            got[tag]["ms_per_step"] = ms
            sessions[tag].close()
        row = out["parity"][f"cosmoflow-128/fp32/b4/{where}"] = {
            "loss_abs_err": loss_err, "max_abs_grad_diff": worst,
            "bitwise": bitwise, **{tag: {key: v for key, v in got[tag].items()
                                         if key != "grads"}
                                   for tag in ("off", "on")}}
        log("train_remat", f"cosmoflow-128 fp32 b4 {where}: step 1 every "
            f"block rematerialized vs none: loss {loss_err:.3g} <= "
            f"{REMAT_LOSS}, gradients max abs {worst:.3g} (atol "
            f"{REMAT_ATOL}, rtol {REMAT_RTOL}); bitwise equal: {bitwise}; "
            f"launches per step {json.dumps(on['launches'])} (without "
            f"{json.dumps(off['launches'])}) = kernel_launches; peak "
            f"{on['peak_bytes'] / 2 ** 30:.3f} GiB allocated, "
            f"{on['peak_reserved_bytes'] / 2 ** 30:.3f} reserved (without "
            f"{off['peak_bytes'] / 2 ** 30:.3f}, "
            f"{off['peak_reserved_bytes'] / 2 ** 30:.3f}); ms per step "
            f"{row['on']['ms_per_step']:.2f} (without "
            f"{row['off']['ms_per_step']:.2f}) ({card})")
        del sessions, got
    del x, y

    for name, batch, n_steps, remat in REMAT_RUNS:
        big = ucfg if name == "unet3d-256" else cfgs[name]
        model = k.unet3d if big.arch == "unet3d" else k.cosmoflow
        tag = f"{name}/fp32/b{batch}" + ("/remat" if remat else "")
        release_cached(tag)
        x, y = train_batch(big, batch, g)
        sess = compile(RunConfig(model=big, mode="train", global_batch=batch,
                                 plan=remat_plan(plan_lib, depth, big, 1,
                                                 remat)))
        per_step = dict(NO_LAUNCHES, **model.kernel_launches(
            big, sess.plan, train=True))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        c0 = counts(k)
        losses, ms = [], []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            losses.append(sess.step(x, y).item())
            ms.append((time.perf_counter() - t0) * 1e3)
        launched = delta(counts(k), c0)
        check(launched == {n: v * n_steps for n, v in per_step.items()},
              f"{tag}: launches {launched} over {n_steps} steps, expected "
              f"{per_step} per step (kernel_launches)")
        check(all(math.isfinite(v) for v in losses),
              f"{tag}: non-finite losses {losses}")
        expected = {n: expected[n] + launched[n] for n in KERNELS}
        row = out["runs"][tag] = {
            "losses": losses, "step_ms": ms,
            "ms_per_step": statistics.median(ms[1:]),
            "launches_per_step": per_step,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
            "resident_bytes_before": resident,
            "foreign_bytes": foreign_bytes(resident, sess, x, y),
            "modeled": modeled(sess)}
        log("train_remat", f"{tag}: {n_steps} steps (the first a warm-up), "
            f"losses {losses}; {row['ms_per_step']:.1f} ms a step; "
            f"launches per step {json.dumps(per_step)} = kernel_launches; "
            f"peak {row['peak_bytes'] / 2 ** 30:.2f} GiB allocated, "
            f"{row['peak_reserved_bytes'] / 2 ** 30:.2f} GiB reserved "
            f"({card})")
        sess.close()
        del sess, x, y
    launches = counts(k)
    check(launches == expected, f"train_remat launches {launches}, "
          f"expected {expected}")
    log("main path", f"train_remat: launches {launches}")
    release_cached("the phases after train_remat")
    return out, launches


def held_bytes(*roots) -> int:
    """Bytes of the distinct CUDA storages among the tensors in ``roots``
    (tensors, and dicts, lists and tuples of them, nested)."""
    storages, stack = {}, list(roots)
    while stack:
        t = stack.pop()
        if isinstance(t, torch.Tensor):
            if t.is_cuda:
                st = t.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
        elif isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
    return sum(storages.values())


def foreign_bytes(resident: int, sess, *inputs) -> int:
    """Of ``resident`` (the bytes allocated just before a measured run),
    those that neither ``sess``' own state (parameters, optimizer state,
    serving replicas) nor the run's ``inputs`` hold: what earlier phases
    and other sessions left alive, which no model of this run counts."""
    return resident - held_bytes(sess.params, getattr(sess, "opt_state", None),
                                 getattr(sess, "_replicas", None), *inputs)


def modeled(sess) -> dict:
    """The session's modeled peak bytes per shard, by source
    (``describe().modeled_peak``: ``core/memory.py``)."""
    peak = sess.describe().modeled_peak
    return dict(dataclasses.asdict(peak), total=peak.total)


def zero1_state_bytes(k, sess) -> dict:
    """Each shard's ZeRO-1 optimizer state checked against the layout:
    every chunk of m and v exactly padded / N fp32 elements of a bucket
    in a storage of its own, on the card, spatial peers (the same data
    index) equal; returns the bytes a shard holds, the buckets' and the
    scalars', and the unsharded state's."""
    plan = k.train_step.convnet_grad_plan(sess.cfg)
    n = k.train_step.data_degree(sess.plan)
    entry = sess.plan.stages[0]
    want = sum(2 * 4 * plan.padded_size(b, n) // n for b in plan.buckets)
    owners = {}
    rows = []
    for r, st in enumerate(sess.opt_state):
        inner = getattr(st, "inner", st)
        chunks = (*inner.m, *inner.v)
        check(all(t.device.type == "cuda" and t.dtype == torch.float32
                  and t.untyped_storage().nbytes() == 4 * t.numel()
                  for t in chunks)
              and [t.numel() for t in inner.m] == [
                  plan.padded_size(b, n) // n for b in plan.buckets],
              f"shard {r}: ZeRO-1 chunks off the layout")
        scalars = [t for t in (inner.step, getattr(st, "loss_scale", None),
                               getattr(st, "good_steps", None))
                   if t is not None]
        got = sum(4 * t.numel() for t in chunks)
        check(got == want, f"shard {r}: {got} state bytes, expected {want}")
        d = k.train_step.batch_slice(sess.mesh, r, entry)[0]
        if d in owners:
            peer = owners[d]
            check(all(torch.equal(a, b) for a, b in zip(chunks, peer)),
                  f"shard {r}: its chunk differs from its spatial peer's")
        owners[d] = chunks
        rows.append(got + sum(t.element_size() * t.numel() for t in scalars))
    return {"bucket_bytes_per_shard": want, "shard_bytes": rows,
            "unsharded_bytes": 2 * 4 * sess.cfg.param_count(),
            "buckets": plan.num_buckets, "padded_per_bucket": [
                plan.padded_size(b, n) for b in plan.buckets]}


def phase_train_zero1(k, cfg, runs, batch: int, RunConfig, compile,
                      card: str) -> tuple:
    """ZeRO-1 on the card, every shard on it (a main path: every step
    below is counted). For each of ``runs`` (precision, data, spatial):
    an ``overlap`` and a ``reduce_scatter`` session from the same seeded
    parameters and masks take ``ZERO1_STEPS`` steps on one seeded batch
    (``cfg`` at ``batch``), every loss finite, launches per step equal
    to ``kernel_launches(train=True)``; the parameters of the two within
    ``MODES_ATOL``/``MODES_RTOL``, and whether bitwise; each
    ``reduce_scatter`` shard's state exactly its 1/N chunk of every
    bucket (``zero1_state_bytes``). Then, at fp32 2 x 2, ms per step of
    both (host clock, median of 3, timed overlap, ZeRO-1, ZeRO-1,
    overlap) and what runs after the backward (``update_split``).
    CosmoFlow also: an fp16 step at 2 x 1 with a NaN in data index 0's
    batch rows only, vetoed by the guard on every shard (the step
    function called directly); fp16 without the guard, an inf in one
    gradient element that only data shard 0's chunk holds, skipped on
    every shard (``zero1_chunk_overflow``); a ZeRO-1 checkpoint saved
    and restored on the card, resuming bitwise. Returns (report,
    launches of the main path)."""
    unet = cfg.arch == "unet3d"
    phase = "train_zero1" + ("_unet" if unet else "")
    model = k.unet3d if unet else k.cosmoflow
    out = {"runs": {}, "timing": {}, "card": card}
    g = torch.Generator(device="cuda").manual_seed(23)
    x, y = train_batch(cfg, batch, g)
    zero_counts(k)
    expected = dict(NO_LAUNCHES)
    timed = {}
    for prec, D, S in runs:
        key = f"{D}x{S}/{prec}"
        params = {}
        for mode in ("overlap", "reduce_scatter"):
            def steps():
                sess = compile(RunConfig(
                    model=cfg, mode="train", global_batch=batch,
                    precision=prec, data=D, spatial=S, grad_comm=mode),
                    devices=["cuda:0"] * (D * S))
                c0 = counts(k)
                losses = [sess.step(x, y).item() for _ in range(ZERO1_STEPS)]
                torch.cuda.synchronize()
                return sess, losses, delta(counts(k), c0)

            sess, losses, got = within_limit(steps, SPATIAL_LIMIT_S,
                                             f"{key} {mode}")
            per_step = dict(NO_LAUNCHES, **model.kernel_launches(
                cfg, sess.plan, train=True))
            check(got == {n: v * ZERO1_STEPS for n, v in per_step.items()},
                  f"{key} {mode}: launches {got}, expected {per_step} a step")
            check(all(math.isfinite(v) for v in losses),
                  f"{key} {mode}: non-finite losses {losses}")
            expected = {n: expected[n] + got[n] for n in KERNELS}
            params[mode] = sess.params
            row = out["runs"].setdefault(key, {})
            row[mode] = {"losses": losses}
            if mode == "reduce_scatter":
                row["state"] = zero1_state_bytes(k, sess)
                row["modeled"] = modeled(sess)
            if (prec, D, S) == ("fp32", 2, 2):
                timed[mode] = sess
            else:
                sess.close()
        ov, rs = params["overlap"], params["reduce_scatter"]
        bad = {n for n in ov if not torch.allclose(
            rs[n], ov[n], atol=MODES_ATOL, rtol=MODES_RTOL)}
        check(not bad, f"{key}: reduce_scatter vs overlap after "
              f"{ZERO1_STEPS} steps: {sorted(bad)}")
        row = out["runs"][key]
        row["max_abs_diff"] = max((rs[n] - ov[n]).abs().max().item()
                                  for n in ov)
        row["bitwise"] = all(torch.equal(rs[n], ov[n]) for n in ov)
        log(phase, f"{key}: reduce_scatter vs overlap after {ZERO1_STEPS} "
            f"steps: max abs difference {row['max_abs_diff']:.3g} (atol "
            f"{MODES_ATOL}, rtol {MODES_RTOL}); bitwise {row['bitwise']}; "
            f"losses {row['reduce_scatter']['losses']} vs "
            f"{row['overlap']['losses']}; state per shard "
            f"{row['state']['shard_bytes']} bytes (buckets "
            f"{row['state']['bucket_bytes_per_shard']}; unsharded "
            f"{row['state']['unsharded_bytes']})")
    launches = counts(k)
    check(launches == expected, f"{phase} path launches {launches}, "
          f"expected {expected}")
    log("main path", f"{phase}: launches {launches}")

    # ------------------------------------------------------ timings ----
    fns = [lambda: timed["overlap"].step(x, y),
           lambda: timed["reduce_scatter"].step(x, y)]
    t = within_limit(lambda: [host_ms(fns[i], 3) for i in (0, 1, 1, 0)],
                     SPATIAL_LIMIT_S, f"{phase} timings")
    out["timing"]["step_ms"] = {"overlap": [t[0], t[3]],
                                "reduce_scatter": [t[1], t[2]]}
    for mode, sess in timed.items():
        out["timing"][mode] = within_limit(
            lambda: update_split(k, sess, 5), SPATIAL_LIMIT_S,
            f"{phase} {mode} update")
    log("timings", f"{phase} 2x2/fp32 ({card}; every shard on one card): "
        + json.dumps(out["timing"]))
    if not unet:
        out["fp16_veto"] = zero1_fp16_veto(k, cfg, x, y)
        out["fp16_chunk_overflow"] = zero1_chunk_overflow(k, cfg)
        out["checkpoint"] = zero1_checkpoint(k, timed["reduce_scatter"], x,
                                             y)
    for sess in timed.values():
        sess.close()
    del timed, fns, x, y
    torch.cuda.empty_cache()
    return out, launches


def update_split(k, sess, reps: int) -> dict:
    """What a step runs after its backward, alone, on fixed seeded
    gradients (one set a shard) and the session's state, every shard on
    the card: host ms (around ``spmd.run`` + synchronize, median of
    ``reps`` after a warm-up) of the update — ``overlap``: the optimizer
    on every leaf of every shard (the reduction ran in the backward);
    ZeRO-1: ``sharded_update``, its buckets' reduce-scatter, the update
    of each shard's chunk and the gather — and, under ZeRO-1, of the
    reduce-scatter and gather alone (the ``grad_comm`` probe's part).
    The probes' differences (``step_split``) are host noise at this
    size."""
    from repro_torch.core import grad_comm as gc
    from repro_torch.core import precision as precision_lib

    mesh, n = sess.mesh, sess.mesh.size
    g = torch.Generator(device="cuda").manual_seed(29)
    grads = [{name: torch.randn(p.shape, generator=g, device=p.device)
              for name, p in sess.params.items()} for _ in range(n)]
    opt = precision_lib.wrap_optimizer(sess.optimizer, sess.precision)
    params = [sess.params] * n
    if sess.grad_comm != "reduce_scatter":
        out = {"update_ms": host_ms(lambda: k.spmd.run(
            mesh, lambda gr, st, p: opt.update(gr, st, p), grads,
            [sess.opt_state] * n, params), reps)}
        return out
    buckets = k.train_step.convnet_grad_plan(sess.cfg)
    axes = tuple(sess.plan.stages[0].batch_axes)

    def comm(gr):
        return gc.all_gather_params(gc.reduce_scatter_grads(
            gr, buckets, axes), buckets, axes, gr)

    return {"update_ms": host_ms(lambda: k.spmd.run(
        mesh, lambda gr, st, p: gc.sharded_update(opt, gr, st, p, buckets,
                                                  axes),
        grads, sess.opt_state, params), reps),
        "scatter_gather_ms": host_ms(lambda: k.spmd.run(mesh, comm, grads),
                                     reps)}


def zero1_fp16_veto(k, cfg, x, y) -> dict:
    """fp16 at 2 x 1 under the guard, the step function called directly
    (the session's ``grads.nonfinite`` site poisons the whole batch): a
    step, then one with a NaN in data index 0's batch rows only, which
    every shard must veto — parameters and its state held bitwise, its
    loss scale halved."""
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.spatial_conv import SpatialPartitioning
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim.adam import Adam, constant

    plan = plan_lib.legacy_convnet_plan(
        cfg, SpatialPartitioning(("model", None, None)), (1, 1, 1),
        data_degrees=(2,))
    mesh = Mesh(plan.mesh_axes, ["cuda:0"] * 2)
    opt = Adam(lr=constant(1e-3))
    step = k.train_step.make_convnet_train_step(
        cfg, mesh, opt, global_batch=x.shape[0], plan=plan,
        grad_comm="reduce_scatter", precision="fp16", guard=True)
    params = k.cosmoflow.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cuda")
    state = k.train_step.make_convnet_opt_state(
        cfg, opt, params, grad_comm="reduce_scatter", plan=plan,
        mesh=mesh, precision="fp16")
    params, state, loss, applied = step(params, state, x, y, 0)
    check(applied.item() == 1.0, "fp16 ZeRO-1: a finite step was vetoed")
    bad = x.clone()
    bad[:x.shape[0] // 2, 0] = float("nan")  # data index 0's rows
    new_params, new_state, loss, applied = step(params, state, bad, y, 1)
    held = all(torch.equal(new_params[n], params[n]) for n in params) and all(
        torch.equal(a, b) for old, new in zip(state, new_state)
        for a, b in zip((*old.inner.m, *old.inner.v, old.inner.step),
                        (*new.inner.m, *new.inner.v, new.inner.step)))
    scales = [(old.loss_scale.item(), new.loss_scale.item())
              for old, new in zip(state, new_state)]
    check(applied.item() == 0.0 and held
          and all(b == a / 2 for a, b in scales),
          f"fp16 ZeRO-1 overflow on one data index: applied "
          f"{applied.item()}, held {held}, loss scales {scales}")
    log("train_zero1", f"fp16 2x1: a NaN in data index 0's rows vetoed the "
        f"step on both shards (parameters and states held bitwise); loss "
        f"scales {scales}")
    return {"applied": applied.item(), "held": held, "loss_scales": scales}


def zero1_chunk_overflow(k, cfg) -> dict:
    """fp16 without the guard, ``sharded_update`` called directly at
    2 x 1 on the card over ``cfg``'s seeded parameters: one inf in the
    gradients that the reduce-scatter hands to data shard 0's chunk
    alone. Shard 1's chunks are finite, so only the finite verdict that
    ``MixedPrecision`` sums over the data axis skips its step: both
    shards must hold their parameters and inner states bitwise and halve
    their loss scales."""
    from repro_torch.core import grad_comm as gc
    from repro_torch.core import precision as precision_lib
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim.adam import Adam, constant

    buckets = k.train_step.convnet_grad_plan(cfg)
    params = k.cosmoflow.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cuda")
    g = torch.Generator(device="cuda").manual_seed(31)
    grads = [{n: torch.randn(p.shape, generator=g, device="cuda")
              for n, p in params.items()} for _ in range(2)]
    first = buckets.buckets[0].names[0]
    grads[1][first].view(-1)[0] = float("inf")  # chunk 0 of bucket 0
    opt = precision_lib.MixedPrecision(Adam(lr=constant(1e-3)),
                                       precision_lib.FP16)
    whole = gc.init_sharded_opt_state(opt, buckets, num_shards=2,
                                      device="cuda")
    states = [gc.local_opt_state(whole, buckets, i, 2) for i in range(2)]

    def fn(gr, st):
        chunks = gc.reduce_scatter_grads(gr, buckets, ("data",))
        return (bool(torch.isfinite(torch.cat(chunks)).all()),
                gc.sharded_update(opt, gr, st, params, buckets, ("data",)))

    outs = k.spmd.run(Mesh([("data", 2)], ["cuda:0"] * 2), fn, grads,
                      states)
    torch.cuda.synchronize()
    finite = [o[0] for o in outs]
    held = all(torch.equal(new[n], params[n]) for _, (new, _) in outs
               for n in params) and all(
        torch.equal(a, b) for (_, (_, new)), old in zip(outs, states)
        for a, b in zip((*old.inner.m, *old.inner.v, old.inner.step),
                        (*new.inner.m, *new.inner.v, new.inner.step)))
    scales = [(old.loss_scale.item(), new.loss_scale.item())
              for (_, (_, new)), old in zip(outs, states)]
    check(finite == [False, True] and held
          and all(b == a / 2 for a, b in scales),
          f"fp16 ZeRO-1 overflow in shard 0's chunk, no guard: chunks "
          f"finite {finite}, held {held}, loss scales {scales}")
    log("train_zero1", f"fp16 2x1 without the guard: an inf in shard 0's "
        f"chunk alone (chunks finite {finite}) skipped the update on both "
        f"shards (parameters and states held bitwise); loss scales "
        f"{scales}")
    return {"chunks_finite": finite, "held": held, "loss_scales": scales}


def zero1_checkpoint(k, sess, x, y) -> dict:
    """A ZeRO-1 session's checkpoint, restored on the card: the next
    step's loss and parameters bitwise the session's own."""
    import tempfile

    from repro_torch.api import Session

    with tempfile.TemporaryDirectory() as d:
        sess.save(os.path.join(d, "c"))
        again = Session.restore(os.path.join(d, "c"),
                                devices=["cuda:0"] * sess.mesh.size)
    want = sess.step(x, y).item()
    got = again.step(x, y).item()
    same = got == want and all(torch.equal(again.params[n], sess.params[n])
                               for n in sess.params)
    check(same, f"ZeRO-1 checkpoint on the card: loss {got} vs {want}, "
          "or the parameters differ")
    again.close()
    log("train_zero1", f"2x2 checkpoint saved and restored on the card: "
        f"the next step bitwise equal (loss {got})")
    return {"loss": got, "bitwise": same}


def pipe_plan(plan_lib, perf_model, cfg, batch: int, d: int, micro: int,
              sched: str = "1f1b"):
    """The two-group plan ``plan="fixed"`` resolves to for 1F1B (the
    boundary priced cheapest on the H100), its schedule set to
    ``sched``: both schedules run the same groups (a sequential config's
    own pick, priced for that schedule, may cut elsewhere)."""
    best = min(plan_lib.candidate_pipeline_plans(
        cfg, perf_model.H100, pipeline_degrees=(2,),
        micro_batch_options=(micro,), num_devices=2 * d,
        global_batch=batch), key=lambda p: p.cost)
    return dataclasses.replace(
        best, pipeline=dataclasses.replace(best.pipeline, schedule=sched),
        name=best.name.replace(".1f1b", f".{sched}"))


def pipe_config(RunConfig, plan, cfg, batch: int, prec: str,
                mode: str = "overlap", **kw):
    """A training run of ``cfg`` pinned to the two-group ``plan``
    (``pipe_plan``): its d shards a group (``data`` the total, 2d)."""
    spec = plan.pipeline
    return RunConfig(model=cfg, mode="train", global_batch=batch,
                     precision=prec, data=2 * plan.data_degree, pipeline=2,
                     micro_batches=spec.micro_batches,
                     pipeline_schedule=spec.schedule, grad_comm=mode,
                     plan=plan, **kw)


def pipe_probe(k, sess):
    """``sess``' pipelined step's ``grad_comm`` probe as ``step(x, y)`` ->
    (loss, merged reduced gradients), on its parameters and state."""
    fn = k.train_step.make_pipeline_train_step(
        sess.cfg, sess.meshes, sess.optimizer, plan=sess.plan,
        global_batch=sess.config.global_batch, grad_comm=sess.grad_comm,
        precision=sess.precision, stage="grad_comm",
        mask_source=sess.mask_source)
    return lambda x, y: fn(sess.params, sess.opt_state, x, y, 0)


def pipe_steps(k, sess, x, y, steps: int, timed: int = 0) -> dict:
    """``steps`` steps of ``sess`` (host clock each), the launches they
    made checked against ``kernel_launches(train=True)`` a step, the
    parameters after the first ``PIPE_STEPS`` kept; peaks allocated and
    reserved over all of them; with ``timed``, the median of the last
    ``timed`` step times (the first step the warm-up)."""
    model = k.unet3d if sess.cfg.arch == "unet3d" else k.cosmoflow
    per_step = dict(NO_LAUNCHES, **model.kernel_launches(
        sess.cfg, sess.plan, train=True))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    c0 = counts(k)
    losses, ms, params = [], [], None
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(sess.step(x, y).item())
        ms.append((time.perf_counter() - t0) * 1e3)
        if i + 1 == PIPE_STEPS:
            params = dict(sess.params)
    got = delta(counts(k), c0)
    check(got == {n: v * steps for n, v in per_step.items()},
          f"{sess.plan.name} {sess.precision}: launches {got} over {steps} "
          f"steps, expected {per_step} a step (kernel_launches)")
    check(all(math.isfinite(v) for v in losses),
          f"{sess.plan.name}: non-finite losses {losses}")
    row = {"losses": losses, "step_ms": ms, "launches": got,
           "launches_per_step": per_step, "params": params,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "resident_bytes_before": resident,
           "foreign_bytes": foreign_bytes(resident, sess, x, y),
           "modeled": modeled(sess)}
    if timed:
        row["ms_per_step"] = statistics.median(ms[-timed:])
    return row


def same_bits(a: dict, b: dict) -> bool:
    return (a["losses"][:PIPE_STEPS] == b["losses"][:PIPE_STEPS]
            and all(torch.equal(a["params"][n], b["params"][n])
                    for n in a["params"]))


def pipe_gate(k, sess, x, y, tag: str, prec: str, micro: int) -> dict:
    """Step 1 of a pipelined session (d = 1) against the plain versions
    and fp64 (``step1_vs_plain`` with the micro-batch oracle), and its
    ``grad_comm`` probe through the kernels against the oracle through
    the kernels (each leaf's distance, a share of its max-abs)."""
    probe = pipe_probe(k, sess)
    loss, grads = probe(x, y)
    o_loss, oracle = loss_and_grads(k, sess, x, y, micro=micro)
    dist = {n: ((grads[n].double() - oracle[n].double()).abs().max()
                / oracle[n].double().abs().max().clamp_min(1e-30)).item()
            for n in grads}
    vs_oracle = {"loss": abs(loss.item() - o_loss.item()),
                 "worst_leaf": max(dist.values()),
                 "bitwise": all(torch.equal(grads[n], oracle[n])
                                for n in grads)}
    log("train_pipeline", f"{tag}: the pipelined step's probe against the "
        f"oracle (micro-batches one after another, one device), both "
        f"through the kernels: {json.dumps(vs_oracle)}")
    check(vs_oracle["worst_leaf"] <= PIPE_ORACLE_TOL
          and vs_oracle["loss"] <= PIPE_ORACLE_TOL * abs(o_loss.item()),
          f"{tag}: the pipelined step against its oracle {vs_oracle}")
    del grads, oracle
    row, _ = within_limit(lambda: step1_vs_plain(
        k, sess, x, y, tag, prec, micro=micro, step=probe),
        SPATIAL_LIMIT_S, f"{tag} step 1")
    row["vs_oracle"] = vs_oracle
    return row


def phase_train_pipeline(k, cfg, ucfg, ucfg64, RunConfig, compile,
                         plan_lib, perf_model, card: str) -> tuple:
    """(10q) The pipeline axis on the card, every group's shards on it (a
    main path: every step below is counted). First, uncounted: the
    boundary ``plan="fixed"`` picks on the H100 (the sessions' pricing)
    beside the reference's V100; step 1 of cosmoflow-128 b4 (d = 1,
    fp32 and bf16) and of the U-Net at 64^3 b2 (``UNET_CHECK_*``)
    against the plain versions and fp64 (``pipe_gate``); M = 1 against
    the unpipelined step of the same data degree (loss and each leaf
    within ``PIPE_M1_TOL``, whether bitwise). Then the main path:
    ``PIPE_RUNS`` at cosmoflow-128 b4 (fp32: 1F1B and sequential x
    overlap and monolithic; bf16: 1F1B overlap) and the U-Net at 256^3
    b2 (1F1B and sequential), ``PIPE_STEPS`` steps each from the same
    seeded parameters and batch, launches a step against
    ``kernel_launches``, 1F1B against sequential and overlap against
    monolithic bitwise; the fp32 overlap runs take ``PIPE_TIMED`` more
    steps, timed (host clock, median after the warm-up), and each run's
    peak memory. After the path: ``Session.profile`` (1F1B against the
    sequential oracle, ``pipeline_speedup``), ``describe()`` and
    ``report()`` at cosmoflow-128 b4 d = 1. On one card the groups share
    the SMs and the host: no speedup is expected. Returns (report,
    launches of the main path, the U-Net run's memory row)."""
    out = {"boundaries": {}, "vs_plain": {}, "m1": {}, "runs": {},
           "card": card}
    t_phase = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(31)
    x, y = train_batch(cfg, PIPE_BATCH, g)
    for c, batch, micro, d in ((cfg, PIPE_BATCH, PIPE_M, 1),
                               (cfg, PIPE_BATCH, PIPE_M2, 2),
                               (ucfg, PIPE_UNET_BATCH, PIPE_UNET_M, 1)):
        picks = {}
        for hw in (perf_model.H100, perf_model.V100):
            cands = plan_lib.candidate_pipeline_plans(
                c, hw, pipeline_degrees=(2,), micro_batch_options=(micro,),
                num_devices=2 * d, global_batch=batch)
            best = min(cands, key=lambda p: p.cost)
            picks[hw.name] = {"plan": best.name, "predicted_step_s":
                              best.cost}
        key = f"{c.name}/b{batch}/m{micro}/d{d}"
        out["boundaries"][key] = picks
        log("train_pipeline", f"{key}: plan=\"fixed\" picks "
            + "; ".join(f"{hw}: {v['plan']} ({v['predicted_step_s'] * 1e3:.3f}"
                        f" ms modeled)" for hw, v in picks.items()))

    def plan(c, batch, d, micro, sched="1f1b"):
        return pipe_plan(plan_lib, perf_model, c, batch, d, micro, sched)

    # ------------------------------- step 1, M = 1 (not counted) ----
    for prec in ("fp32", "bf16"):
        with compile(pipe_config(RunConfig, plan(cfg, PIPE_BATCH, 1, PIPE_M),
                                 cfg, PIPE_BATCH, prec),
                     devices=["cuda:0"] * 2) as sess:
            tag = f"{cfg.name} {prec} b{PIPE_BATCH} pipe2 d1 M{PIPE_M}"
            out["vs_plain"][tag] = pipe_gate(k, sess, x, y, tag, prec,
                                             PIPE_M)
    # the U-Net's gate on phase 10e's own batch (its seed, its first
    # draw): the decision-aware bf16 criterion held phase 10e's step
    # there, and it is seed-fragile at these leaves for the unpipelined
    # step as well (scripts/pipeline_accuracy.py, PERF.md §6); what the
    # pipeline adds is held apart, its probe against its oracle
    # (PIPE_ORACLE_TOL)
    ux, uy = train_batch(ucfg64, UNET_CHECK_BATCH,
                         torch.Generator(device="cuda").manual_seed(14))
    for prec in ("fp32", "bf16"):
        with compile(pipe_config(RunConfig, plan(
                ucfg64, UNET_CHECK_BATCH, 1, PIPE_UNET_M), ucfg64,
                UNET_CHECK_BATCH, prec), devices=["cuda:0"] * 2) as sess:
            tag = (f"{ucfg64.name} {prec} b{UNET_CHECK_BATCH} "
                   f"{sess.plan.name} d1")
            out["vs_plain"][tag] = pipe_gate(k, sess, ux, uy, tag, prec,
                                             PIPE_UNET_M)
    del ux, uy
    for d in (1, 2):
        with compile(pipe_config(RunConfig, plan(cfg, PIPE_BATCH, d, 1),
                                 cfg, PIPE_BATCH, "fp32"),
                     devices=["cuda:0"] * (2 * d)) as sess:
            loss, grads = pipe_probe(k, sess)(x, y)
            flat = plan_lib.legacy_convnet_plan(
                cfg, plan_lib.SpatialPartitioning(("model", None, None)),
                (1, 1, 1), data_degrees=(d,))
            mesh = k.mesh_lib.make_plan_mesh(flat, ["cuda:0"] * d)
            want_loss, want = k.train_step.make_convnet_phase_probes(
                cfg, mesh, sess.optimizer, global_batch=PIPE_BATCH,
                plan=flat, precision="fp32")["grad_comm"](
                    sess.params, sess.optimizer.init(sess.params), x, y, 0)
            dist = {n: ((grads[n] - want[n]).abs().max()
                        / want[n].abs().max().clamp_min(1e-30)).item()
                    for n in want}
            row = out["m1"][f"d{d}"] = {
                "loss": loss.item(), "unpipelined_loss": want_loss.item(),
                "worst_leaf": max(dist.values()),
                "bitwise": bool(torch.equal(loss, want_loss) and all(
                    torch.equal(grads[n], want[n]) for n in want))}
            check(abs(row["loss"] - row["unpipelined_loss"])
                  <= PIPE_M1_TOL * max(1.0, abs(row["unpipelined_loss"]))
                  and row["worst_leaf"] <= PIPE_M1_TOL,
                  f"M = 1, d = {d}: against the unpipelined step {row}")
            log("train_pipeline", f"{cfg.name} fp32 b{PIPE_BATCH} M = 1, "
                f"d = {d} ({sess.plan.name}) against the unpipelined "
                f"step at data {d}: {json.dumps(row)}")

    # ------------------------------------------------ the main path ----
    zero_counts(k)
    expected = dict(NO_LAUNCHES)
    for tag, prec, d in PIPE_RUNS:
        micro = PIPE_M if d == 1 else PIPE_M2
        runs, names = {}, {}
        for sched in (("1f1b", "sequential") if prec == "fp32"
                      else ("1f1b",)):
            for mode in (("overlap", "monolithic") if prec == "fp32"
                         else ("overlap",)):
                timed = PIPE_TIMED if mode == "overlap" and prec == "fp32" \
                    else 0

                def run():
                    with compile(pipe_config(
                            RunConfig, plan(cfg, PIPE_BATCH, d, micro, sched),
                            cfg, PIPE_BATCH, prec, mode),
                            devices=["cuda:0"] * (2 * d)) as s:
                        return s.plan.name, pipe_steps(
                            k, s, x, y, max(PIPE_STEPS, 1 + timed), timed)

                names[sched], runs[(sched, mode)] = within_limit(
                    run, SPATIAL_LIMIT_S, f"{tag} {prec} d{d} {sched} {mode}")
                got = runs[(sched, mode)]["launches"]
                expected = {n: expected[n] + got[n] for n in KERNELS}
        key = f"{tag} {cfg.name} {prec} b{PIPE_BATCH} d{d} M{micro}"
        name = names["1f1b"]
        row = out["runs"][key] = {"plan": name, "checks": {}}
        base = runs[("1f1b", "overlap")]
        for other in runs:
            if other == ("1f1b", "overlap"):
                continue
            same = same_bits(base, runs[other])
            row["checks"][" vs ".join(("1f1b overlap", " ".join(other)))] = \
                same
            check(same, f"{key}: 1f1b overlap against {other} after "
                  f"{PIPE_STEPS} steps is not bitwise")
        for (sched, mode), r in runs.items():
            row[f"{sched} {mode}"] = {n: v for n, v in r.items()
                                      if n != "params"}
        log("train_pipeline", f"{key} ({name}): losses "
            f"{base['losses'][:PIPE_STEPS]}; bitwise {json.dumps(row['checks'])}; "
            f"launches a step {json.dumps(base['launches_per_step'])} = "
            "kernel_launches; " + "".join(
                f"{s} {m}: {r['ms_per_step']:.2f} ms a step (median of "
                f"{PIPE_TIMED} after a warm-up); " for (s, m), r
                in runs.items() if "ms_per_step" in r)
            + f"peak {base['peak_bytes'] / 2 ** 30:.3f} GiB allocated, "
            f"{base['peak_reserved_bytes'] / 2 ** 30:.3f} reserved ({card})")
    del runs, base
    # (q-c) the U-Net at 256^3 b2
    release_cached("the pipelined U-Net")
    ux, uy = train_batch(ucfg, PIPE_UNET_BATCH, g)
    runs, names = {}, {}
    for sched in ("1f1b", "sequential"):
        def run():
            with compile(pipe_config(RunConfig, plan(
                    ucfg, PIPE_UNET_BATCH, 1, PIPE_UNET_M, sched), ucfg,
                    PIPE_UNET_BATCH, PIPE_UNET_PREC),
                    devices=["cuda:0"] * 2) as s:
                return s.plan.name, pipe_steps(k, s, ux, uy,
                                               1 + PIPE_TIMED, PIPE_TIMED)

        names[sched], runs[sched] = within_limit(run, 2 * SPATIAL_LIMIT_S,
                                                 f"q-c {sched}")
        expected = {n: expected[n] + runs[sched]["launches"][n]
                    for n in KERNELS}
        torch.cuda.empty_cache()
    key = (f"q-c {ucfg.name} {PIPE_UNET_PREC} b{PIPE_UNET_BATCH} d1 "
           f"M{PIPE_UNET_M}")
    same = same_bits(runs["1f1b"], runs["sequential"])
    check(same, f"{key}: 1f1b against sequential after {PIPE_STEPS} steps "
          "is not bitwise")
    unet_row = {n: v for n, v in runs["1f1b"].items() if n != "params"}
    name = names["1f1b"]
    out["runs"][key] = {"plan": name, "checks": {
        "1f1b vs sequential": same}, "1f1b overlap": unet_row,
        "sequential overlap": {n: v for n, v in runs["sequential"].items()
                               if n != "params"}}
    log("train_pipeline", f"{key} ({name}): losses "
        f"{unet_row['losses']}; 1f1b vs sequential bitwise {same}; launches "
        f"a step {json.dumps(unet_row['launches_per_step'])} = "
        f"kernel_launches; 1f1b {unet_row['ms_per_step']:.1f} ms a step, "
        f"sequential {runs['sequential']['ms_per_step']:.1f} (median of "
        f"{PIPE_TIMED} after a warm-up); peak "
        f"{unet_row['peak_bytes'] / 2 ** 30:.2f} GiB allocated, "
        f"{unet_row['peak_reserved_bytes'] / 2 ** 30:.2f} reserved; "
        f"modeled {unet_row['modeled']['total'] / 2 ** 30:.2f} GiB a group "
        f"({card})")
    del runs, ux, uy
    launches = counts(k)
    check(launches == expected, f"train_pipeline path launches {launches}, "
          f"expected {expected}")
    log("main path", f"train_pipeline: launches {launches}")

    # ------------------------- profile, describe, report (after) ----
    with compile(pipe_config(RunConfig, plan(cfg, PIPE_BATCH, 1, PIPE_M),
                             cfg, PIPE_BATCH, "fp32", trace=True),
                 devices=["cuda:0"] * 2) as sess:
        prof = sess.profile((x, y))
        rep = sess.describe()
        drift = sess.report()
        out["profile"] = {key_: v for key_, v in prof.items()
                          if not key_.startswith("telemetry")}
        out["describe"] = {"plan": rep.plan_name,
                           "bubble_fraction": rep.bubble_fraction,
                           "predicted_step_s": rep.predicted_step_s,
                           "modeled_peak": dataclasses.asdict(
                               rep.modeled_peak)}
        out["report"] = drift.to_json()
    log("train_pipeline", f"{cfg.name} fp32 b{PIPE_BATCH} d1 M{PIPE_M}: "
        f"Session.profile {json.dumps(out['profile'])}; describe "
        f"{json.dumps(out['describe'])} ({card}); the drift table:\n"
        + str(drift))
    out["seconds"] = time.perf_counter() - t_phase
    log("train_pipeline", f"the phase took {out['seconds']:.1f} s")
    del x, y
    torch.cuda.empty_cache()
    return out, launches, unet_row


def phase_memory_model(rows: dict, card: str) -> dict:
    """(m) Each measured peak beside the session's modeled peak
    (``core/memory.py``, the reference's coefficients): the ratio of
    modeled to allocated and to reserved bytes, and to the run's own
    allocated peak — the peak less the bytes earlier phases and other
    sessions held throughout (``foreign_bytes``). No gate: the model's
    coefficients were fitted to XLA's liveness, not to this allocator."""
    out = {}
    for tag, row in rows.items():
        m = row["modeled"]["total"]
        own = row["peak_bytes"] - row["foreign_bytes"]
        out[tag] = {"modeled_bytes": m, "allocated_bytes": row["peak_bytes"],
                    "reserved_bytes": row["peak_reserved_bytes"],
                    "resident_bytes_before": row["resident_bytes_before"],
                    "foreign_bytes": row["foreign_bytes"],
                    "own_allocated_bytes": own,
                    "modeled_over_allocated": m / row["peak_bytes"],
                    "modeled_over_own_allocated": m / own,
                    "modeled_over_reserved": m / row["peak_reserved_bytes"],
                    "modeled": row["modeled"]}
        log("memory_model", f"{tag}: modeled {m / 2 ** 30:.3f} GiB, measured "
            f"{row['peak_bytes'] / 2 ** 30:.3f} allocated "
            f"({row['foreign_bytes'] / 2 ** 30:.3f} of it other phases', "
            f"{own / 2 ** 30:.3f} the run's own) and "
            f"{row['peak_reserved_bytes'] / 2 ** 30:.3f} reserved: ratios "
            f"{out[tag]['modeled_over_allocated']:.3f} allocated, "
            f"{out[tag]['modeled_over_own_allocated']:.3f} own and "
            f"{out[tag]['modeled_over_reserved']:.3f} reserved ({card})")
    return out


def phase_train_io(k, cfg, RunConfig, compile, card: str) -> tuple:
    """The input pipeline on the card (a main path for its training
    steps): ``IO_SAMPLES`` synthetic cosmoflow-128 volumes written to a
    temporary store; for each spatial degree of ``IO_S`` (every shard on
    this card) and prefetch depth of ``IO_DEPTHS``, a train session's
    ``make_loader`` feeds ``IO_STEPS`` steps over two epochs. Checked:
    the batches of every loader bitwise equal (prefetched against
    synchronous, S = 2 against S = 1), the losses of the two depths
    bitwise equal at each S, each rank's store bytes (``IOStats``) at
    S = 2 half of S = 1's, and at S = 2 with ``IO_HALO`` margin voxels
    half plus the margin's rows, every loss finite, launches per step
    against ``kernel_launches``. Printed: ms per step (host clock,
    median of the steps after the first) and ``io_stall_s``. Returns
    (report, launches)."""
    import tempfile

    from repro_torch.data import store, synthetic

    out = {"runs": {}, "card": card}
    w, c = cfg.input_width, cfg.in_channels
    vol_bytes = w ** 3 * c * 4
    with tempfile.TemporaryDirectory(prefix="chip_smoke_io_") as root:
        t0 = time.perf_counter()
        cubes, targets = synthetic.make_cosmology_dataset(
            IO_SAMPLES, w, channels=c, seed=0)
        store.write_dataset(root, cubes, targets)
        del cubes
        log("train_io", f"{IO_SAMPLES} synthetic {cfg.name} volumes "
            f"({IO_SAMPLES * vol_bytes / 2 ** 20:.0f} MiB) written in "
            f"{time.perf_counter() - t0:.1f} s")
        zero_counts(k)
        expected = dict(NO_LAUNCHES)
        batches, losses_at = None, {}
        for S in IO_S:
            for depth in IO_DEPTHS:
                tag = f"{cfg.name}/fp32/b{IO_BATCH}/1x{S}/prefetch{depth}"
                sess = compile(RunConfig(model=cfg, mode="train",
                                         global_batch=IO_BATCH, spatial=S,
                                         data_dir=root, prefetch=depth),
                               devices=["cuda:0"] * S)
                per_step = dict(NO_LAUNCHES, **k.cosmoflow.kernel_launches(
                    cfg, sess.plan, train=True))
                ld = sess.make_loader()
                seen, losses, ms = [], [], []
                c0 = counts(k)
                for _ in range(IO_STEPS * IO_BATCH // IO_SAMPLES):
                    order = ld.epoch_schedule()
                    for lo in range(0, IO_SAMPLES, IO_BATCH):
                        t1 = time.perf_counter()
                        x, y = ld.load_batch(order[lo:lo + IO_BATCH])
                        losses.append(sess.step(x, y).item())
                        ms.append((time.perf_counter() - t1) * 1e3)
                        seen.append((x, y))
                launched = delta(counts(k), c0)
                check(launched == {n: v * IO_STEPS
                                   for n, v in per_step.items()},
                      f"{tag}: launches {launched}, expected {per_step} "
                      "per step (kernel_launches)")
                expected = {n: expected[n] + launched[n] for n in KERNELS}
                check(all(math.isfinite(v) for v in losses),
                      f"{tag}: non-finite losses {losses}")
                if batches is None:
                    batches = seen
                same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                           for a, b in zip(seen, batches))
                check(same, f"{tag}: batches differ from the first loader's")
                if depth:
                    check(losses == losses_at[S], f"{tag}: losses {losses}"
                          f" vs synchronous {losses_at[S]}")
                losses_at.setdefault(S, losses)
                ranks = dict(sorted(ld.stats.rank_pfs_bytes.items()))
                check(ranks == {r: IO_SAMPLES * vol_bytes // S
                                for r in range(S)},
                      f"{tag}: store bytes per rank {ranks}")
                tele = sess.telemetry()
                row = out["runs"][tag] = {
                    "losses": losses, "step_ms": ms,
                    "ms_per_step": statistics.median(ms[1:]),
                    "rank_pfs_bytes": ranks,
                    "io_stall_s": tele.get("io_stall_s"),
                    "io_queue_occupancy": tele.get("io_queue_occupancy"),
                    "io_cache_hit_ratio": tele["io_cache_hit_ratio"]}
                log("train_io", f"{tag}: {IO_STEPS} steps from the loader, "
                    f"losses {losses}; {row['ms_per_step']:.2f} ms a step "
                    f"with its load; store bytes per rank "
                    f"{json.dumps(ranks)}; io_stall_s {row['io_stall_s']}, "
                    f"queue occupancy {row['io_queue_occupancy']}, cache "
                    f"hit ratio {row['io_cache_hit_ratio']:.3f} ({card})")
                del seen, x, y
                sess.close()
        launches = counts(k)
        check(launches == expected, f"train_io launches {launches}, "
              f"expected {expected}")
        log("main path", f"train_io: launches {launches}")
        # the margin: each rank also reads IO_HALO depth rows of each
        # neighbour it has
        S = max(IO_S)
        sess = compile(RunConfig(model=cfg, mode="train",
                                 global_batch=IO_BATCH, spatial=S,
                                 data_dir=root, prefetch=2),
                       devices=["cuda:0"] * S)
        ld = sess.make_loader(halo_voxels=IO_HALO)
        order = ld.epoch_schedule()
        for i, lo in enumerate(range(0, IO_SAMPLES, IO_BATCH)):
            x, y = ld.load_batch(order[lo:lo + IO_BATCH])
            check(torch.equal(x, batches[i][0]),
                  "halo loader: the batch differs from the exact slabs'")
        row_bytes = vol_bytes // w
        ranks = dict(sorted(ld.stats.rank_pfs_bytes.items()))
        want = {r: IO_SAMPLES * (vol_bytes // S + row_bytes * IO_HALO
                                 * ((r > 0) + (r < S - 1)))
                for r in range(S)}
        check(ranks == want, f"halo loader: store bytes per rank {ranks}, "
              f"expected {want}")
        out["halo"] = {"halo_voxels": IO_HALO, "rank_pfs_bytes": ranks}
        log("train_io", f"{cfg.name} 1x{S} halo_voxels={IO_HALO}: store "
            f"bytes per rank {json.dumps(ranks)} = half a volume plus "
            f"{IO_HALO} row(s) of each neighbour, per sample; batches "
            "equal the exact slabs'")
        sess.close()
        del batches, x, y
    return out, launches

def phase_supervise(k, cfg, RunConfig, compile, plan_lib, part,
                    card: str) -> tuple:
    """The auto-resume supervisor, the drift report and the drivers on
    the card (a main path): ``supervisor.run`` at ``cfg`` b4 fp32 1 x 1
    for ``SUP_STEPS`` steps, checkpoints every ``SUP_EVERY``: without a
    fault (its launches exactly ``SUP_STEPS`` x ``kernel_launches``) and
    with ``device.loss`` at step 4, the two bitwise equal (losses, every
    parameter); ``comm.stall`` of ``SUP_STALL_S`` at step 3 under a
    ``SUP_WATCHDOG_S`` watchdog (one restart); ``grads.nonfinite`` at
    steps 3-5 with patience 3 (one rollback); a flipped byte in the
    newest checkpoint's leaf walked past (the resumed run bitwise the
    clean one). Then 2 x 2 ZeRO-1, every shard on this card: a kill and
    resume bitwise, and ``available=2`` re-degreeing to 1 x 2 with
    finite losses and the optimizer state carried over. Then
    ``Session.report()`` at each of ``SUP_REPORTS`` (each row printed),
    ``python -m repro_torch.launch.train --arch <cfg> --full-config`` for
    3 steps and the quickstart for 2 (their ``main``). Returns (report,
    launches)."""
    import io
    import tempfile

    from repro_torch.api import supervisor
    from repro_torch.core import faults
    from repro_torch.data import store, synthetic
    from repro_torch.examples import quickstart
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint

    out = {"runs": {}, "reports": {}, "card": card}
    t_phase = time.perf_counter()
    zero_counts(k)
    one = ["cuda:0"]

    def same_params(a, b) -> bool:
        return all(torch.equal(a.params[n], b.params[n]) for n in a.params)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sup_") as tmp:
        def supervised(tag, steps, spec=None, devices=one, root=None,
                       **kw):
            config = RunConfig(model=cfg, global_batch=SUP_BATCH,
                               checkpoint_dir=root or os.path.join(tmp, tag),
                               **kw.pop("config", {}))
            t0 = time.perf_counter()
            with (faults.active(spec) if spec else contextlib.nullcontext()):
                r = supervisor.run(config, steps, save_every=SUP_EVERY,
                                   devices=devices, **kw)
            row = out["runs"][tag] = {
                "losses": r.losses, "restarts": r.restarts,
                "resumes": r.resumes, "cold_starts": r.cold_starts,
                "rollbacks": r.rollbacks, "replans": r.replans,
                "final": [r.final_data, r.final_spatial],
                "recovery_s": r.recovery_s, "events": r.events,
                "wall_s": time.perf_counter() - t0}
            log("supervise", f"{tag}: losses {r.losses}; restarts "
                f"{r.restarts}, resumes {r.resumes}, rollbacks "
                f"{r.rollbacks}, replans {r.replans}, final "
                f"{r.final_data} x {r.final_spatial}; recovery_s "
                f"{r.recovery_s}; {row['wall_s']:.1f} s; events "
                f"{json.dumps(r.events)} ({card})")
            return r

        c0 = counts(k)
        clean = supervised("1x1", SUP_STEPS)
        per_step = dict(NO_LAUNCHES, **k.cosmoflow.kernel_launches(
            cfg, clean.session.plan, train=True))
        check(delta(counts(k), c0) == {n: v * SUP_STEPS
                                       for n, v in per_step.items()},
              f"1x1: launches {delta(counts(k), c0)}, expected {SUP_STEPS}"
              f" x {per_step}")
        check(all(math.isfinite(v) for v in clean.losses)
              and clean.restarts == 0, "1x1: the clean run")
        got = supervised("1x1 device.loss@4", SUP_STEPS,
                         faults.FaultSpec("device.loss", at_steps=(4,),
                                          max_fires=1))
        check(got.restarts == 1 and got.resumes == 1
              and got.losses == clean.losses and same_params(
                  got.session, clean.session),
              f"1x1: the resumed run is not the clean run's bits: "
              f"{got.losses} vs {clean.losses}")
        got.session.close()
        r = supervised("1x1 comm.stall@3", 5, faults.FaultSpec(
            "comm.stall", at_steps=(3,), max_fires=1, stall_s=SUP_STALL_S),
            watchdog_timeout_s=SUP_WATCHDOG_S)
        check(r.restarts == 1 and any("StepTimeout" in e for e in r.events)
              and r.losses == clean.losses[:5],
              "1x1: the watchdog did not catch the stall once")
        r.session.close()
        r = supervised("1x1 grads.nonfinite@3-5", 8, faults.FaultSpec(
            "grads.nonfinite", at_steps=(3, 4, 5), max_fires=3),
            divergence_patience=3)
        check(r.rollbacks == 1 and all(math.isfinite(v)
                                       for v in r.losses[4:]),
              "1x1: the divergence did not roll back once")
        r.session.close()
        root = os.path.join(tmp, "corrupt")
        supervised("1x1 first 4", 4, root=root).session.close()
        newest = checkpoint.step_dir(root, 4)
        leaf = os.path.join(newest, sorted(
            f for f in os.listdir(newest) if f.endswith(".npy"))[0])
        with open(leaf, "r+b") as f:
            f.seek(os.path.getsize(leaf) - 1)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))
        check(not checkpoint.validate(newest), "the flipped byte went unseen")
        r = supervised("1x1 corrupt step 4", SUP_STEPS, root=root)
        check(r.resumes == 1 and r.events[0].startswith("resumed from step 2")
              and r.losses[2:] == clean.losses[2:]
              and same_params(r.session, clean.session),
              f"1x1: the corrupt checkpoint was not walked past: {r.events}")
        r.session.close()
        clean.session.close()

        # 2 x 2 ZeRO-1, every shard on the card
        D, S = SUP_ZERO1
        z1 = dict(config={"data": D, "spatial": S,
                          "grad_comm": "reduce_scatter"},
                  devices=["cuda:0"] * (D * S))
        clean = supervised(f"{D}x{S} zero1", SUP_STEPS, **dict(z1))
        got = supervised(f"{D}x{S} zero1 device.loss@4", SUP_STEPS,
                         faults.FaultSpec("device.loss", at_steps=(4,),
                                          max_fires=1), **dict(z1))
        check(got.restarts == 1 and got.losses == clean.losses
              and same_params(got.session, clean.session),
              f"{D}x{S}: the resumed run is not the clean run's bits")
        got.session.close()
        clean.session.close()
        el = supervised(f"{D}x{S} zero1 available=2@3", SUP_STEPS,
                        faults.FaultSpec("device.loss", at_steps=(3,),
                                         max_fires=1, available=2),
                        **dict(z1))
        check(el.replans == 1 and (el.final_data, el.final_spatial) == (1, 2)
              and el.session.mesh.shape == {"data": 1, "model": 2}
              and all(math.isfinite(v) for v in el.losses)
              and not any("reset" in e for e in el.events),
              f"{D}x{S}: the elastic re-plan {el.events}")
        el.session.close()

        # the drift table: the time model (H100, a card a shard) beside
        # the measured probes' spans and two loader batches
        data = os.path.join(tmp, "store")
        w, c = cfg.input_width, cfg.in_channels
        cubes, targets = synthetic.make_cosmology_dataset(
            SUP_BATCH, w, channels=c, seed=0)
        store.write_dataset(data, cubes, targets)
        del cubes
        for tag, S, kind in SUP_REPORTS:
            plan = ("fixed" if kind == "fixed"
                    else spatial_plan(plan_lib, part, cfg, S, kind))
            with compile(RunConfig(model=cfg, global_batch=SUP_BATCH,
                                   spatial=S, plan=plan),
                         devices=["cuda:0"] * S) as sess:
                sess.make_loader(data)
                t0 = time.perf_counter()
                rep = sess.report()
                out["reports"][tag] = dict(rep.to_json(),
                                           seconds=time.perf_counter() - t0)
            log("supervise", f"drift {cfg.name} b{SUP_BATCH} fp32 {tag} "
                f"({card}):\n" + str(rep))

        # the drivers, in this process (their own printing kept aside)
        for tag, main, argv in (
                ("launch.train", launch_train.main,
                 ["--arch", cfg.name, "--full-config", "--steps", "3"]),
                ("quickstart", quickstart.main, ["--steps", "2"])):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                main(argv)
            text = buf.getvalue()
            losses = [float(v) for v in re.findall(r"loss (\S+)", text)]
            check(losses and all(math.isfinite(v) for v in losses),
                  f"{tag}: losses {losses}\n{text}")
            out[tag] = {"losses": losses,
                        "seconds": time.perf_counter() - t0,
                        "tail": text.splitlines()[-3:]}
            log("supervise", f"{tag} {' '.join(argv)}: losses {losses} in "
                f"{out[tag]['seconds']:.1f} s")
    launches = counts(k)
    for name in ("conv3d", "conv3d_dgrad", "bn_act", "pack", "unpack"):
        check(launches[name] > 0, f"supervise: {name} never launched")
    out["seconds"] = time.perf_counter() - t_phase
    log("main path", f"supervise: launches {launches}; the phase took "
        f"{out['seconds']:.1f} s")
    return out, launches


# --------------------------------------------- 10w: the process mesh ----
def _child_kernels():
    """In a process-mesh child: TF32 off as in the parent (phase 1), and
    the kernel wrappers whose counters the child reads."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.bn_act import ops as bn_ops
    from repro_torch.kernels.conv3d import ops as conv_ops
    from repro_torch.kernels.halo_pack import ops as pack_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return argparse.Namespace(conv_ops=conv_ops, bn_ops=bn_ops,
                              pack_ops=pack_ops, ssd_ops=ssd_ops)


def _child_release() -> None:
    """At the end of a process-mesh child's job (the pool's processes
    live on): its cuBLAS workspaces and cached blocks handed back, so
    that the parent's next run has the card."""
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()


def procmesh_config(RunConfig, cfg, batch: int, D: int, S: int, prec: str,
                    mode: str, plan=None):
    """A phase-10w training run: ``D`` the total data degree, ``plan`` a
    pinned plan (a remat, a two-group or a one-transition plan), "auto",
    a memory budget in GiB (a float: the planner's choice over the
    devices given), or None (the fixed one); ``prec`` "auto" leaves the
    precision to the planner."""
    if isinstance(plan, float):
        return RunConfig(model=cfg, mode="train", global_batch=batch,
                         precision=prec, data=D, spatial=S, grad_comm=mode,
                         memory_budget_gib=plan)
    if plan is not None and not isinstance(plan, str) and plan.n_groups > 1:
        return pipe_config(RunConfig, plan, cfg, batch, prec, mode)
    return RunConfig(model=cfg, mode="train", global_batch=batch,
                     precision=prec, data=D, spatial=S, grad_comm=mode,
                     **({} if plan is None else {"plan": plan}))


def _crcs(tree) -> list:
    """CRC-32 of every leaf's bytes, in ``key_paths`` order."""
    import zlib

    from repro_torch.core.tree import leaves
    return [zlib.crc32(t.detach().contiguous().view(-1).view(
        torch.uint8).cpu().numpy().tobytes()) for t in leaves(tree)]


def _probe_of(k, sess, batch: int, prec: str, mode: str):
    """``sess``' ``grad_comm`` probe as ``probe(x, y)`` -> (loss, reduced
    gradients): the pipelined step's for a pipelined session."""
    if sess.meshes is not None:
        return pipe_probe(k, sess)
    fn = k.train_step.make_convnet_phase_probes(
        sess.cfg, sess.mesh, sess.optimizer, global_batch=batch,
        plan=sess.plan, grad_comm=mode, precision=prec)["grad_comm"]
    return lambda x, y: fn(sess.params, sess.opt_state, x, y, 0)


def procmesh_train_job(cfg, batch: int, D: int, S: int, prec: str,
                       mode: str, steps: int, devices, plan=None,
                       ckpt=None) -> dict:
    """One rank of a process-mesh training run (``launch.dist.Pool``):
    phase 10b's seeded batch; step 1's ``grad_comm`` probe; then, the
    counters zeroed, ``steps`` steps (the main path), their losses and
    this rank's launches and peak memory; then ms a step (median of
    ``PROCMESH_TIMED``
    after a warm-up, every rank stepping together). Rank 0 also returns
    the probe's gradients (every group's); each group's shard 0 its
    parameters after ``steps``; under ZeRO-1 every rank its state's
    bytes and leaves' CRCs. With ``ckpt``: a save there, a restore and
    one more step (its loss and rank 0's parameters)."""
    from repro_torch.api import RunConfig, Session, compile
    from repro_torch.launch import dist as dist_lib
    from repro_torch.train import train_step

    k = _child_kernels()
    k.train_step = train_step
    x, y = train_batch(cfg, batch, torch.Generator(
        device="cuda").manual_seed(11))
    torch.cuda.synchronize()
    foreign = torch.cuda.memory_allocated()  # what this process held before
    torch.cuda.reset_peak_memory_stats()
    groups = set(dist_lib._GROUPS)
    zero_counts(k)
    sess = compile(procmesh_config(RunConfig, cfg, batch, D, S, prec, mode,
                                   plan), devices=devices)
    if sess.released:  # a budget's plan spans fewer ranks than the world
        out = {"rank": torch.distributed.get_rank(), "released": True,
               "plan": sess.plan.name, "ranks": list(sess.ranks),
               "describe": str(sess.describe()), "launches": counts(k),
               "subgroups": sorted(str(g_) for g_ in set(dist_lib._GROUPS)
                                   - groups if g_[0] != dist_lib.world()),
               "peak_bytes": torch.cuda.max_memory_allocated() - foreign}
        sess.close()
        return out
    world = sess.mesh.pipeline
    rank = sess.mesh.rank if world is None else world.rank
    loss1, grads = _probe_of(k, sess, batch, sess.precision, mode)(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(k)
    losses = [sess.step(x, y).item() for _ in range(steps)]
    torch.cuda.synchronize()
    out = {"rank": rank, "transport": sess.describe().transport,
           "device": str(sess.device), "x_sum": x.double().sum().item(),
           "loss1": loss1.item(), "losses": losses,
           "launches": counts(k), "plan": sess.plan.name,
           "precision": sess.precision, "foreign_bytes": foreign,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "modeled_peak_bytes": sess.describe().modeled_peak.total}
    if rank == 0:
        out["grads"] = {n: v.cpu() for n, v in grads.items()}
    if sess.mesh.rank == 0:  # the group's shard 0
        out["params"] = {n: v.cpu() for n, v in sess.params.items()}
    if isinstance(sess.opt_state, list):  # ZeRO-1: this rank's chunk
        (state,) = sess.opt_state
        out["state_bytes"] = sum(t.numel() * t.element_size()
                                 for t in (*state.m, *state.v))
        out["state_crcs"] = _crcs(state)
    out["step_ms"] = host_ms(lambda: sess.step(x, y), PROCMESH_TIMED)
    if ckpt is not None:
        sess.save(ckpt)
        again = Session.restore(ckpt, devices=devices)
        out["resumed"] = again.step(x, y).item()
        out["resumed_crcs"] = _crcs(again.params)
        again.close()
    sess.close()
    _child_release()
    return out


def procmesh_serve_job(cfg, batch: int, S: int, seed: int,
                       plan="fixed", reps: int = 3) -> dict:
    """One rank of depth-split serving over processes (under ``plan``):
    one predict with the counters zeroed (after a warm-up), rank 0's
    predictions, ms a predict (median of ``reps`` more) and this rank's
    peak memory; with ``reps`` 0 no warm-up, and the counted predict's
    ms (the pool's processes built the kernels before)."""
    from repro_torch.api import RunConfig, compile

    k = _child_kernels()
    w = cfg.input_width
    x = torch.randn((batch, w, w, w, cfg.in_channels), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        seed))
    sess = compile(RunConfig(model=cfg, mode="infer", global_batch=batch,
                             spatial=S, plan=plan), devices=["cuda:0"] * S)
    if reps:
        sess.predict(x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(k)
    t0 = time.perf_counter()
    pred = sess.predict(x)
    torch.cuda.synchronize()
    once = (time.perf_counter() - t0) * 1e3
    out = {"rank": sess.mesh.rank, "launches": counts(k),
           "transport": sess.describe().transport,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "pred": pred.cpu() if sess.mesh.rank == 0 else None}
    out["ms"] = host_ms(lambda: sess.predict(x), reps) if reps else once
    sess.close()
    del x, pred
    _child_release()
    return out


def procmesh_runs(cf128, ucfg64, plan_lib, depth, perf_model) -> list:
    """Phase 10w's training runs, each (tag, cfg, batch, total data
    degree, spatial degree, precision, grad_comm, pinned plan, "auto", a
    budget in GiB or None, whether it checkpoints): ``PROCMESH_TRAIN``
    and ``PROCMESH_UNET`` (the fixed plan), then ``PROCMESH_COMPOSE``
    (ZeRO-1, remat, pipeline groups), then ``PROCMESH_PLANS`` (the
    planner's layouts, ``plan="auto"`` and budgets)."""
    runs = [(tag, cf128, 4, D, S, prec, mode, None, False)
            for tag, D, S, prec, mode in PROCMESH_TRAIN]
    runs += [("pm-u", ucfg64, UNET_CHECK_BATCH, D, S, prec, mode, None,
              False) for D, S, prec, mode in PROCMESH_UNET]
    for tag, model, D, S, prec, mode, kind, micro, sched in PROCMESH_COMPOSE:
        cfg, batch = ((cf128, 4) if model == "cosmo"
                      else (ucfg64, UNET_CHECK_BATCH))
        plan = None
        if kind.startswith("remat"):
            plan = remat_plan(plan_lib, depth, cfg, S,
                              kind="deep" if kind == "remat-deep"
                              else "fixed")
        elif kind == "pipe":
            plan = pipe_plan(plan_lib, perf_model, cfg, batch, D // 2,
                             micro, sched)
        runs.append((tag, cfg, batch, D, S, prec, mode, plan,
                     tag in PROCMESH_CHECKPOINT))
    for tag, model, batch, D, S, prec, mode, kind in PROCMESH_PLANS:
        cfg = cf128 if model == "cosmo" else ucfg64
        plan = (spatial_plan(plan_lib, depth, cfg, S, kind, data=D)
                if kind in PLAN_KINDS else kind)
        runs.append((tag, cfg, batch, D, S, prec, mode, plan, False))
    return runs


def phase_procmesh(k, cf128, ucfg, ucfg64, RunConfig, compile, plan_lib,
                   depth, perf_model, card: str) -> tuple:
    """Phase 10w: the process mesh (one process a shard, collectives
    through ``torch.distributed``) on this card, the transport gloo
    (NCCL refuses two ranks on one card): one 4-process world
    (``launch.dist.Pool``, spawned), its 1 x 2 runs on ranks 0-1.

    (a) cosmoflow-128 b4 training (``PROCMESH_TRAIN``) and (c) the U-Net
    at 64^3 b2 at 1 x 2, then (g) ZeRO-1, remat and pipeline groups
    over processes (``PROCMESH_COMPOSE``), each held against the
    in-process mesh at the same degrees and plan on this card: step 1's
    ``grad_comm`` probe (a pipeline's: every group's merged tree),
    every leaf within ``PROCMESH_FP32`` of its max-abs (fp32), or (bf16)
    no farther from the in-process step than ``STEP1_BF16`` x the
    in-process step through the plain versions; the losses of
    ``PROCMESH_STEPS`` steps within ``PROCMESH_FP32`` (fp32) or
    ``STEP1_LOSS`` (bf16); whether the probe, the losses and the
    parameters after the steps (a pipeline's: each group's, from its
    shard 0) are bitwise, and under ZeRO-1 each rank's state (its CRCs
    against the in-process shard's), which must hold exactly 2 x 4 x
    padded / N bytes a bucket; ``PROCMESH_CHECKPOINT``'s runs save over
    processes, restore and step once more: the files, the loss and the
    parameters against the in-process run's. (b) serving at S = 2
    (``PROCMESH_SERVE``) against the unsharded forward (fp32 1e-5). (d)
    each rank's launches summed against the plan's ``kernel_launches``.
    (e) ms a step or predict beside the in-process mesh's, each rank's
    peak. (f) the NCCL transport runs only where every rank has a card
    of its own.

    A child that fails, or a pool that does not answer within
    ``PROCMESH_LIMIT_S``, fails the run. Returns (report, the launches
    the children's main paths made)."""
    import tempfile

    from repro_torch.api import Session
    from repro_torch.launch import dist as dist_lib

    out = {"card": card, "train": {}, "serve": {}, "note":
           "every rank on one card, over gloo through pinned host "
           "buffers: the process mesh's overhead, not scaling"}
    total = dict(NO_LAUNCHES)
    g = torch.Generator(device="cuda").manual_seed(11)

    def rel(a, b):
        return ((a.double() - b.double()).abs().max().item()
                / max(1e-30, b.double().abs().max().item()))

    def in_process(cfg, batch, D, S, prec, mode, plan, x, y, ckpt, n):
        sess = compile(procmesh_config(RunConfig, cfg, batch, D, S, prec,
                                       mode, plan),
                       devices=["cuda:0"] * n)
        probe = _probe_of(k, sess, batch, sess.precision, mode)
        loss1, grads = probe(x, y)
        plain = None
        if sess.precision == "bf16":
            with plain_training(k):
                plain = probe(x, y)[1]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [sess.step(x, y).item() for _ in range(PROCMESH_STEPS)]
        row = {"loss1": loss1.item(), "grads": grads, "plain": plain,
               "losses": losses, "params": {n: v.clone() for n, v in
                                            sess.params.items()},
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "plan": sess.plan, "precision": sess.precision}
        if isinstance(sess.opt_state, list):
            row["state_crcs"] = [_crcs(s) for s in sess.opt_state]
        row["step_ms"] = host_ms(lambda: sess.step(x, y), PROCMESH_TIMED)
        if ckpt is not None:
            sess.save(ckpt)
            again = Session.restore(ckpt, devices=["cuda:0"] * (D * S))
            row["resumed"] = again.step(x, y).item()
            row["resumed_crcs"] = _crcs(again.params)
            again.close()
        sess.close()
        return row

    def files(path):
        return {n: open(os.path.join(path, n), "rb").read()
                for n in sorted(os.listdir(path))}

    root = tempfile.mkdtemp(prefix="procmesh-")
    t0 = time.perf_counter()
    with dist_lib.Pool(PROCMESH_WORLD, "file://" + os.path.join(
            root, "rendezvous"), timeout_s=PROCMESH_LIMIT_S) as pool:
        log("procmesh", f"{PROCMESH_WORLD} processes spawned and joined in "
            f"{time.perf_counter() - t0:.1f} s")
        for tag, cfg, batch, D, S, prec, mode, plan, ckpt in procmesh_runs(
                cf128, ucfg64, plan_lib, depth, perf_model):
            budget = isinstance(plan, float)
            what = (f"{D}x{S}" if plan is None
                    else f"{D}x{S} budget {plan} GiB" if budget
                    else f"{D}x{S} auto" if plan == "auto" else plan.name)
            key = f"{tag}/{cfg.name}/b{batch}/{what}/{prec}/{mode}"
            # a budget plans over the world: its plan takes the first ranks
            n = PROCMESH_WORLD if budget else D * S
            t_run = time.perf_counter()
            dirs = ((os.path.join(root, f"{tag}-procs"),
                     os.path.join(root, f"{tag}-threads")) if ckpt
                    else (None, None))
            got = pool.run(procmesh_train_job, cfg, batch, D, S, prec, mode,
                           PROCMESH_STEPS, ["cuda:0"] * n, plan, dirs[0],
                           ranks=range(n))
            g.manual_seed(11)
            x, y = train_batch(cfg, batch, g)
            want = in_process(cfg, batch, D, S, prec, mode, plan, x, y,
                              dirs[1], n)
            prec = want["precision"]  # the planner's, under a budget
            if plan is not None:
                # every rank holds the in-process plan; ranks past it are
                # released: no launch, no subgroup, nothing on the card
                m = want["plan"].device_count
                released = [r for r in got if r.get("released")]
                check(all(r["plan"] == want["plan"].name for r in got)
                      and [r["rank"] for r in released] == list(range(m, n))
                      and all(r["ranks"] == list(range(m))
                              and not any(r["launches"].values())
                              and not r["subgroups"] and not r["peak_bytes"]
                              for r in released),
                      f"{key}: the ranks' plans "
                      f"{[r['plan'] for r in got]} (in-process "
                      f"{want['plan'].name}), released ranks "
                      f"{[(r['rank'], r['launches'], r['subgroups']) for r in released]}")
                got = got[:m]
                if released:
                    log("procmesh", f"{key}: ranks "
                        f"{[r['rank'] for r in released]} released: "
                        f"{released[0]['describe'].splitlines()[0]}")
            zero = got[0]
            check(all(r["transport"] == "gloo" and r["device"] == "cuda:0"
                      and r["x_sum"] == x.double().sum().item()
                      for r in got), f"{key}: transport, device or batch")
            dist_ = {q: rel(zero["grads"][q], want["grads"][q].cpu())
                     for q in want["grads"]}
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(
                [zero["loss1"]] + zero["losses"],
                [want["loss1"]] + want["losses"]))
            if prec == "fp32":
                bad = {q: v for q, v in dist_.items() if v > PROCMESH_FP32}
                loss_tol = PROCMESH_FP32
            else:
                plain = {q: rel(want["plain"][q], want["grads"][q])
                         for q in dist_}
                bad = {q: (v, plain[q]) for q, v in dist_.items()
                       if v > STEP1_BF16 * plain[q]}
                loss_tol = STEP1_LOSS["bf16"]
            check(not bad and loss_err <= loss_tol,
                  f"{key}: against the in-process mesh: loss {loss_err}; "
                  f"gradients out of bounds {bad}")
            check(all(r["losses"] == zero["losses"] for r in got),
                  f"{key}: the ranks' losses differ")
            params = {}
            for r in got:  # each group's shard 0's
                params.update(r.get("params", {}))
            check(set(params) == set(want["params"]),
                  f"{key}: the groups' parameters cover the model")
            bitwise = (
                all(torch.equal(zero["grads"][q], want["grads"][q].cpu())
                    for q in want["grads"])
                and zero["losses"] == want["losses"]
                and all(torch.equal(params[q], want["params"][q].cpu())
                        for q in want["params"]))
            if mode == "reduce_scatter":
                buckets = k.train_step.convnet_grad_plan(cfg)
                chunk = sum(2 * 4 * buckets.padded_size(b_, D) // D
                            for b_ in buckets.buckets)
                check(all(r["state_bytes"] == chunk for r in got),
                      f"{key}: each rank's ZeRO-1 state "
                      f"{[r['state_bytes'] for r in got]} bytes, expected "
                      f"{chunk} (2 x 4 x padded / N a bucket)")
                bitwise = bitwise and all(
                    r["state_crcs"] == want["state_crcs"][r["rank"]]
                    for r in got)
            model = k.unet3d if cfg.arch == "unet3d" else k.cosmoflow
            per_step = dict(NO_LAUNCHES, **model.kernel_launches(
                cfg, want["plan"], train=True))
            summed = {q: sum(r["launches"][q] for r in got)
                      for q in KERNELS}
            expect = {q: v * PROCMESH_STEPS for q, v in per_step.items()}
            check(summed == expect, f"{key}: launches summed over the ranks "
                  f"{summed}, expected {expect} (kernel_launches x "
                  f"{PROCMESH_STEPS})")
            total = {q: total[q] + summed[q] for q in KERNELS}
            worst = max(dist_, key=dist_.get)
            row = out["train"][key] = {
                "bitwise": bitwise, "loss_rel_err": loss_err,
                "worst_grad": [worst, dist_[worst]],
                "losses": zero["losses"], "launches_summed": summed,
                "step_ms": [r["step_ms"] for r in got],
                "in_process_step_ms": want["step_ms"],
                "peak_bytes": [r["peak_bytes"] for r in got],
                "peak_reserved_bytes": [r["peak_reserved_bytes"]
                                        for r in got],
                "modeled_peak_bytes": [r["modeled_peak_bytes"]
                                       for r in got],
                # less what the rank's process held before the run
                "own_peak_bytes": [r["peak_bytes"] - r["foreign_bytes"]
                                   for r in got],
                "in_process_peak_bytes": want["peak_bytes"]}
            if plan is not None and not hasattr(plan, "stages"):
                row["plan"] = want["plan"].name
                log("procmesh", f"{key}: every rank chose "
                    f"{want['plan'].name} ({prec}) as in one process; "
                    f"modeled peak a rank "
                    f"{row['modeled_peak_bytes'][0] / 2 ** 30:.3f} GiB, "
                    f"measured (allocated, less what the process held "
                    f"before) {[round(v / 2 ** 30, 3) for v in row['own_peak_bytes']]}"
                    f" GiB")
            if ckpt:
                same_files = files(dirs[0]) == files(dirs[1])
                resumed = (all(r["resumed"] == want["resumed"] for r in got)
                           and zero["resumed_crcs"] == want["resumed_crcs"])
                check(same_files and resumed,
                      f"{key}: the checkpoint saved over processes (files "
                      f"equal: {same_files}) restored and stepped "
                      f"{[r['resumed'] for r in got]}, in-process "
                      f"{want['resumed']}")
                row["checkpoint"] = {"files_equal": same_files,
                                     "resumed_loss": zero["resumed"]}
            if mode == "reduce_scatter" or plan is not None:
                # ZeRO-1, remat and pipeline groups must be the in-process
                # mesh's bits: the same kernels, sums in the same order
                check(bitwise, f"{key}: not bitwise the in-process mesh")
            log("procmesh", f"{key}: transport gloo, {n} processes on "
                f"cuda:0; vs the in-process mesh: loss {loss_err:.3g}, "
                f"worst gradient {worst} {dist_[worst]:.3g} of its max-abs; "
                f"bitwise {bitwise}; launches summed over the ranks "
                f"{json.dumps(summed)} = kernel_launches x {PROCMESH_STEPS}"
                + (f"; checkpoint saved over processes, restored and "
                   f"resumed bitwise (files equal)" if ckpt else ""))
            log("timings", f"procmesh {key} ({card}): ms a step over "
                f"processes {[round(v, 2) for v in row['step_ms']]} (each "
                f"rank), in-process {want['step_ms']:.2f}; peak a rank "
                f"{[round(v / 2 ** 30, 2) for v in row['peak_bytes']]} GiB "
                f"allocated (modeled "
                f"{[round(v / 2 ** 30, 2) for v in row['modeled_peak_bytes']]}"
                f"), in-process (every shard) "
                f"{want['peak_bytes'] / 2 ** 30:.2f} GiB; "
                f"{time.perf_counter() - t_run:.1f} s")
            del want, got, x, y
            torch.cuda.empty_cache()
        for name, batch, S in PROCMESH_SERVE:
            cfg = {cf128.name: cf128, ucfg.name: ucfg}[name]
            key = f"{cfg.name}/b{batch}/S{S}/fp32"
            got = pool.run(procmesh_serve_job, cfg, batch, S, 21,
                           ranks=range(S))
            w = cfg.input_width
            x = torch.randn((batch, w, w, w, cfg.in_channels), device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(21))
            one = compile(RunConfig(model=cfg, mode="infer",
                                    global_batch=batch))
            want = one.predict(x)
            spatial = compile(RunConfig(model=cfg, mode="infer",
                                        global_batch=batch, spatial=S),
                              devices=["cuda:0"] * S)
            spatial.predict(x)
            threads_ms = host_ms(lambda: spatial.predict(x), 3)
            model = k.unet3d if cfg.arch == "unet3d" else k.cosmoflow
            per_fwd = dict(NO_LAUNCHES, **model.kernel_launches(
                cfg, spatial.plan))
            one.close()
            spatial.close()
            err = rel_err(got[0]["pred"].cuda(), want)
            summed = {q: sum(r["launches"][q] for r in got) for q in KERNELS}
            check(err <= 1e-5, f"{key}: over processes vs the unsharded "
                  f"forward {err} > 1e-5")
            check(summed == per_fwd, f"{key}: launches summed over the "
                  f"ranks {summed}, expected {per_fwd}")
            total = {q: total[q] + summed[q] for q in KERNELS}
            out["serve"][key] = {
                "rel_err_vs_unsharded": err, "launches_summed": summed,
                "ms": [r["ms"] for r in got], "in_process_ms": threads_ms,
                "peak_bytes": [r["peak_bytes"] for r in got]}
            log("procmesh", f"serve {key}: transport {got[0]['transport']}; "
                f"vs the unsharded forward {err:.3g} <= 1e-5; launches "
                f"summed over the ranks {json.dumps(summed)} = "
                "kernel_launches")
            log("timings", f"procmesh serve {key} ({card}): ms a predict "
                f"over processes {[round(r['ms'], 2) for r in got]}, "
                f"in-process {threads_ms:.2f}; peak a rank "
                f"{[round(r['peak_bytes'] / 2 ** 30, 2) for r in got]} GiB")
            del want, got, x
            torch.cuda.empty_cache()
        if (PROCMESH_IO or PROCMESH_IO_SERVE or PROCMESH_IO_SUPERVISE
                or PROCMESH_PLANS_IO or PROCMESH_PLANS_HARNESS
                or PROCMESH_PLANS_SUPERVISE or PROCMESH_PLANS_SERVE):
            out["io"], got = phase_procmesh_io(
                pool, k, cf128, ucfg, ucfg64, RunConfig, compile, plan_lib,
                depth, root, card)
            total = {q: total[q] + got[q] for q in KERNELS}
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        got = dist_lib.spawn(procmesh_train_job, 2, "file://" + os.path.join(
            root, "rendezvous-nccl"), cf128, 4, 1, 2, "fp32", "overlap",
            PROCMESH_STEPS, None, timeout_s=PROCMESH_LIMIT_S)
        check(all(r["transport"] == "nccl" for r in got), "NCCL transport")
        out["nccl"] = {"losses": got[0]["losses"],
                       "step_ms": [r["step_ms"] for r in got]}
        log("procmesh", f"NCCL 1 x 2 on cuda:0-1: losses {got[0]['losses']}")
    else:
        out["nccl"] = f"not run: {n_cards} card visible, a 2-rank NCCL " \
                      "world needs a card a rank"
        log("procmesh", "NCCL transport not run: one card is visible "
            "(NCCL refuses two ranks on one card; it runs where "
            "torch.cuda.device_count() >= the world size)")
    out["seconds"] = time.perf_counter() - t0
    log("main path", f"procmesh: launches summed over the ranks "
        f"{json.dumps(total)}")
    return out, total


# ------------------------------- 10w: PROCMESH_IO, over processes ----
def io_blocks(batch, mesh, entry, arch: str, k) -> list:
    """Per rank of ``mesh``, the CRCs of its (x, y) blocks of a loader's
    batch: a rank's own ``Block``s over processes (one row), the slices
    of the global tensors in one process (a row a rank)."""
    from repro_torch.train.train_step import Block

    x, y = batch
    if isinstance(x, Block):
        return [_crcs((x.t, y.t))]
    out = []
    for r in range(mesh.size):
        ys = (y[k.train_step.block_index(y.shape, mesh, r, entry)]
              if arch == "unet3d" else None)
        if ys is None:
            index, count = k.train_step.batch_slice(mesh, r, entry)
            n = y.shape[0] // count
            ys = y[index * n:(index + 1) * n]
        out.append(_crcs((x[k.train_step.block_index(
            x.shape, mesh, r, entry)].contiguous(), ys.contiguous())))
    return out


def io_steps(k, sess, root: str, batch: int, steps: int, depth: int
             ) -> dict:
    """``steps`` steps fed by ``sess``' loader over ``root`` (``depth``:
    its prefetch queue, 0 synchronous), step ``t`` the chunk ``t % bpe``
    of epoch ``t // bpe``'s schedule: the blocks' CRCs, the losses, ms of
    each load + step (``.item()`` waits), the store bytes of each rank
    after the first epoch, ``stall_s`` and the parameters' CRCs."""
    loader = sess.make_loader(root, prefetch=depth)
    bpe = loader.store.num_samples // batch
    row = {"crcs": [], "losses": [], "ms": []}
    for t in range(steps):
        epoch, b = divmod(t, bpe)
        order = loader.schedule_for_epoch(epoch)
        t0 = time.perf_counter()
        xy = loader.load_batch(order[b * batch:(b + 1) * batch])
        row["losses"].append(sess.step(xy).item())
        row["ms"].append((time.perf_counter() - t0) * 1e3)
        row["crcs"].append(io_blocks(xy, sess.mesh, sess.plan.stages[0],
                                     sess.cfg.arch, k))
        if t == bpe - 1:
            row["pfs"] = dict(loader.stats.rank_pfs_bytes)
    row["stall_s"] = getattr(loader, "stall_s", 0.0)
    row["params"] = _crcs(sess.params)
    return row


def io_train(k, compile, RunConfig, cfg, batch: int, D: int, S: int,
             root: str, devices, plan="fixed") -> dict:
    """One session of ``cfg`` at D x S under ``plan`` (a process's rank,
    or in one process every shard), loader-fed ``PROCMESH_IO_STEPS``
    steps synchronously (launches counted), then again from the same
    initial state with prefetch."""
    from repro_torch.core.tree import tree_map

    sess = compile(RunConfig(model=cfg, mode="train", global_batch=batch,
                             data=D, spatial=S, plan=plan), devices=devices)
    init = ({n: v.clone() for n, v in sess.params.items()},
            tree_map(torch.clone, sess.opt_state))
    out = {"rank": getattr(sess.mesh, "rank", None),
           "plan": sess.plan if not hasattr(sess.mesh, "rank") else None}
    for depth in (0, PROCMESH_IO_PREFETCH):
        sess.params = {n: v.clone() for n, v in init[0].items()}
        sess.opt_state = tree_map(torch.clone, init[1])
        sess._t = 0
        torch.cuda.synchronize()
        zero_counts(k)
        out[depth] = io_steps(k, sess, root, batch, PROCMESH_IO_STEPS,
                              depth)
        out[depth]["launches"] = counts(k)
    sess.close()
    return out


def procmesh_io_job(cfg, batch: int, D: int, S: int, root: str,
                    devices, plan="fixed") -> dict:
    """One rank of ``io_train`` over processes."""
    from repro_torch.api import RunConfig, compile
    from repro_torch.train import train_step

    k = _child_kernels()
    k.train_step = train_step
    return io_train(k, compile, RunConfig, cfg, batch, D, S, root, devices,
                    plan)


def io_volumes(cfg, n: int) -> torch.Tensor:
    """``n`` seeded volumes of ``cfg`` on the host (the harness's
    requests; the same bits in every process)."""
    w = cfg.input_width
    return torch.randn((n, w, w, w, cfg.in_channels),
                       generator=torch.Generator().manual_seed(23))


def io_serve(k, compile, RunConfig, cfg, n: int, max_batch: int, S: int,
             devices, plan="fixed") -> dict:
    """``n`` one-volume requests through ``serve()`` under ``plan`` (one
    worker, each group of ``max_batch`` submitted together and awaited,
    so that every batch is one group): on the front end the predictions,
    the telemetry and the launches; on a follower its launches."""
    sess = compile(RunConfig(model=cfg, mode="infer", global_batch=max_batch,
                             spatial=S, plan=plan), devices=devices)
    torch.cuda.synchronize()
    zero_counts(k)
    h = sess.serve(max_batch=max_batch, max_wait_ms=5000.0, workers=1)
    out = {"rank": getattr(sess.mesh, "rank", 0)}
    if type(h).__name__ == "ServingFollower":
        h.close()
        out.update(launches=counts(k), batches=h.batches)
        sess.close()
        return out
    xs = io_volumes(cfg, n).numpy()
    preds, errors = [], []
    for i in range(0, n, max_batch):
        for f in h.submit_many(xs[i:i + max_batch]):
            try:
                preds.append(f.result(timeout=PROCMESH_LIMIT_S))
            except Exception as e:  # noqa: BLE001 — counted, then gated
                errors.append(f"{type(e).__name__}: {e}")
    h.close()
    out.update(preds=np.stack(preds) if preds else None, errors=errors,
               telemetry=sess.telemetry(), launches=counts(k))
    sess.close()
    return out


def procmesh_serve_io_job(cfg, n: int, max_batch: int, S: int,
                          plan="fixed") -> dict:
    from repro_torch.api import RunConfig, compile

    k = _child_kernels()
    return io_serve(k, compile, RunConfig, cfg, n, max_batch, S,
                    ["cuda:0"] * S, plan)


def io_supervise(cfg, root: str, data_dir: str, devices, fault: str,
                 plan="fixed") -> dict:
    """A loader-fed ZeRO-1 run of ``cfg`` under the supervisor
    (``PROCMESH_IO_SUPERVISE``; with a pinned ``plan``,
    ``PROCMESH_PLANS_SUPERVISE``), on every rank or in one process.
    ``fault``: "" none; "crash+read" an ``InjectedCrash`` at step 3 on
    every rank and a persistent ``loader.read`` error (every attempt of
    one read) on rank 1 alone; "lost" ``DeviceLost(available=2)`` at
    step 3 on rank 2 alone (in one process: in the process)."""
    import torch.distributed as tdist

    from repro_torch.api import RunConfig, supervisor
    from repro_torch.core import faults

    D, S, steps, every = (PROCMESH_IO_SUPERVISE if plan == "fixed"
                          else PROCMESH_PLANS_SUPERVISE[:4])
    rank = tdist.get_rank() if tdist.is_initialized() else None
    specs = []
    if fault == "crash+read" and rank in (1, None):
        specs.append(faults.FaultSpec("loader.read", at_calls=(2, 3, 4, 5)))
    if fault == "lost" and rank in (2, None):
        specs.append(faults.FaultSpec("device.loss", at_steps=(3,),
                                      max_fires=1, available=2))
    real = supervisor._loader_batch_fn
    fired = []

    def batch_fn(sess, config):
        make = real(sess, config)

        def crashing(t):
            if fault == "crash+read" and t == 3 and not fired:
                fired.append(t)
                raise faults.InjectedCrash("loader.read",
                                           f"injected crash at step {t}")
            return make(t)
        return crashing

    config = RunConfig(model=cfg, global_batch=4, data=D, spatial=S,
                       grad_comm="reduce_scatter", checkpoint_dir=root,
                       data_dir=data_dir, plan=plan)
    supervisor._loader_batch_fn = batch_fn
    t0 = time.perf_counter()
    try:
        with faults.active(*specs):
            r = supervisor.run(config, steps, save_every=every,
                               devices=devices)
    finally:
        supervisor._loader_batch_fn = real
    out = {"rank": rank, "losses": r.losses, "events": r.events,
           "restarts": r.restarts, "replans": r.replans,
           "released": r.released, "final": [r.final_data, r.final_spatial],
           "recovery_s": r.recovery_s, "wall_s": time.perf_counter() - t0}
    if r.session is not None:
        out["params"] = _crcs(r.session.params)
        out["mesh"] = r.session.mesh.shape
        out["plan"] = r.session.plan.name
        r.session.close()
    return out


def procmesh_supervise_io_job(cfg, root: str, data_dir: str, fault: str,
                              devices, plan="fixed") -> dict:
    """One rank of ``io_supervise``, with its launches."""
    k = _child_kernels()
    zero_counts(k)
    out = dict(io_supervise(cfg, root, data_dir, devices, fault, plan),
               launches=counts(k))
    _child_release()
    return out


def io_harness_runs(pool, k, cf128, RunConfig, compile, card: str,
                    out: dict, spec=None, plan: str = "fixed") -> dict:
    """Phase 10w's ``PROCMESH_IO`` harness run (b), or under ``plan``
    (``PROCMESH_PLANS_HARNESS``, gated bitwise against the in-process
    harness): rank 0 the front end, rank 1 following, against the
    unsharded forward and the in-process harness. Returns the launches
    summed over the ranks."""
    n_req, max_batch, S = spec or PROCMESH_IO_SERVE
    key = f"{cf128.name}/S{S}/{n_req}x1/max_batch{max_batch}" + (
        f"/{plan}" if plan != "fixed" else "")
    got = pool.run(procmesh_serve_io_job, cf128, n_req, max_batch, S, plan,
                   ranks=range(S))
    want = io_serve(k, compile, RunConfig, cf128, n_req, max_batch, S,
                    ["cuda:0"] * S, plan)
    front = got[0]
    tele = front["telemetry"]
    check(not front["errors"] and tele["serve.requests"] == n_req
          and tele["serve.worker_failures"] == 0
          and all(r["batches"] == n_req // max_batch for r in got[1:]),
          f"{key}: served {tele['serve.requests']}/{n_req}, failed "
          f"{tele['serve.worker_failures']}: {front['errors'][:1]}")
    one = compile(RunConfig(model=cf128, mode="infer",
                            global_batch=max_batch))
    xs = io_volumes(cf128, n_req)
    err = 0.0
    for i in range(0, n_req, max_batch):
        ref = one.predict(xs[i:i + max_batch])
        err = max(err, rel_err(torch.from_numpy(
            front["preds"][i:i + max_batch]).cuda(), ref))
    one.close()
    check(err <= 1e-5, f"{key}: predictions against the unsharded forward "
          f"of each batch {err} > 1e-5")
    same = bool(np.array_equal(front["preds"], want["preds"]))
    if plan != "fixed":
        check(same, f"{key}: rank 0's replies are not the in-process "
              f"harness's bits")
    with compile(RunConfig(model=cf128, mode="infer", global_batch=max_batch,
                           spatial=S, plan=plan),
                 devices=["cuda:0"] * S) as sp:
        per_fwd = dict(NO_LAUNCHES, **k.cosmoflow.kernel_launches(
            cf128, sp.plan))
        plan_name = sp.plan.name
    summed = {q: sum(r["launches"][q] for r in got) for q in KERNELS}
    expect = {q: v * (n_req // max_batch) for q, v in per_fwd.items()}
    check(summed == expect, f"{key}: launches summed over the ranks "
          f"{summed}, expected {expect}")
    out["serve"][key] = {
        "plan": plan_name, "served": tele["serve.requests"], "failed":
        tele["serve.worker_failures"], "rel_err_vs_unsharded": err,
        "bitwise_in_process": same,
        "p50_ms": tele["serve.latency_p50_ms"],
        "in_process_p50_ms": want["telemetry"]["serve.latency_p50_ms"],
        "launches_summed": summed}
    log("procmesh", f"io harness {key}: plan {plan_name}; {n_req}/{n_req} "
        f"served, 0 failed, vs the unsharded forward {err:.3g} <= 1e-5, "
        f"bitwise the in-process harness: {same}; launches summed "
        f"{json.dumps(summed)}")
    log("timings", f"procmesh io harness {key} ({card}): p50 latency "
        f"{tele['serve.latency_p50_ms']:.2f} ms over processes, "
        f"{want['telemetry']['serve.latency_p50_ms']:.2f} ms in-process")
    del got, want, xs
    torch.cuda.empty_cache()
    return summed


def io_supervisor_runs(pool, k, cf128, root: str, stores: dict,
                       card: str, out: dict) -> dict:
    """Phase 10w's ``PROCMESH_IO`` supervisor runs (c), against the
    in-process supervisor. Returns the children's launches."""
    total = dict(NO_LAUNCHES)
    D, S, steps, _ = PROCMESH_IO_SUPERVISE
    n = D * S
    key = f"{cf128.name}/b4/{D}x{S}/zero1/{steps} steps"
    clean = io_supervise(cf128, os.path.join(root, "sup-clean"),
                         stores["cosmo"], ["cuda:0"] * n, "")
    got = pool.run(procmesh_supervise_io_job, cf128,
                   os.path.join(root, "sup-faulted"), stores["cosmo"],
                   "crash+read", ["cuda:0"] * n, ranks=range(n))
    check(all(r["losses"] == clean["losses"] and r["params"] ==
              clean["params"] and r["restarts"] == 2 for r in got),
          f"{key}: the faulted run over processes "
          f"{[r['losses'] for r in got]} (restarts "
          f"{[r['restarts'] for r in got]}) is not the unfaulted run's bits "
          f"{clean['losses']}")
    check(all(r["events"] == got[0]["events"] for r in got),
          f"{key}: the ranks' events differ")
    total = {q: total[q] + sum(r["launches"][q] for r in got)
             for q in KERNELS}
    out["supervise"]["faulted"] = {
        "losses": got[0]["losses"], "events": got[0]["events"],
        "recovery_s": [r["recovery_s"] for r in got],
        "wall_s": [r["wall_s"] for r in got],
        "in_process_wall_s": clean["wall_s"]}
    log("procmesh", f"io supervisor {key}: a crash at step 3 on every rank "
        f"and a persistent loader.read error on rank 1 recovered to the "
        f"unfaulted run's losses and parameters, bitwise; events "
        f"{json.dumps(got[0]['events'])}")
    log("timings", f"procmesh io supervisor {key} ({card}): recovery_s "
        f"{[[round(v, 3) for v in r['recovery_s']] for r in got]} (a rank "
        f"each), wall {[round(r['wall_s'], 1) for r in got]} s, in-process "
        f"unfaulted {clean['wall_s']:.1f} s")
    lost = io_supervise(cf128, os.path.join(root, "sup-lost-threads"),
                        stores["cosmo"], ["cuda:0"] * n, "lost")
    got = pool.run(procmesh_supervise_io_job, cf128,
                   os.path.join(root, "sup-lost"), stores["cosmo"], "lost",
                   ["cuda:0"] * n, ranks=range(n))
    kept, released = got[:2], got[2:]
    check(lost["final"] == [1, 2] and all(
        r["final"] == [1, 2] and r["mesh"] == {"data": 1, "model": 2}
        and not r["released"] and r["events"] == lost["events"]
        and all(math.isfinite(v) for v in r["losses"]) for r in kept),
          f"{key}: the elastic re-plan over processes "
          f"{[r['events'] for r in kept]}, in-process {lost['events']}")
    check(all(r["released"] and "params" not in r
              and r["events"][-1].startswith("released") for r in released),
          f"{key}: ranks 2-3 were not released: "
          f"{[r['events'] for r in released]}")
    out["supervise"]["elastic"] = {
        "losses": kept[0]["losses"], "events": kept[0]["events"],
        "bitwise_in_process": kept[0]["losses"] == lost["losses"]
        and kept[0]["params"] == lost["params"],
        "released_events": released[0]["events"]}
    total = {q: total[q] + sum(r["launches"][q] for r in got)
             for q in KERNELS}
    log("procmesh", f"io supervisor elastic: DeviceLost(available=2) on "
        f"rank 2 re-planned ranks 0-1 to 1 x 2 (losses "
        f"{kept[0]['losses']}, bitwise the in-process elastic run: "
        f"{out['supervise']['elastic']['bitwise_in_process']}), the "
        f"in-process events {json.dumps(lost['events'])}; ranks 2-3 "
        f"released")
    return total


def plans_supervisor_run(pool, k, cf128, root: str, stores: dict,
                         plan_lib, depth, card: str, out: dict) -> dict:
    """Phase 10w's ``PROCMESH_PLANS_SUPERVISE`` run: a loader-fed ZeRO-1
    data x spatial run under a pinned one-transition plan, rank 2 losing
    its device at step 3 (``DeviceLost(available=2)``): the pinned plan
    drops to ``"auto"``, ranks 0-1 re-plan to 1 x 2 bitwise the
    in-process elastic run (events, losses, parameters, plan), ranks 2-3
    released. Returns the children's launches."""
    D, S, steps, _, kind = PROCMESH_PLANS_SUPERVISE
    n = D * S
    plan = spatial_plan(plan_lib, depth, cf128, S, kind, data=D)
    key = f"{cf128.name}/b4/{D}x{S}/{plan.name}/zero1/{steps} steps"
    want = io_supervise(cf128, os.path.join(root, "plans-sup-threads"),
                        stores["cosmo"], ["cuda:0"] * n, "lost", plan)
    got = pool.run(procmesh_supervise_io_job, cf128,
                   os.path.join(root, "plans-sup-procs"), stores["cosmo"],
                   "lost", ["cuda:0"] * n, plan, ranks=range(n))
    kept, released = got[:2], got[2:]
    check(want["final"] == [1, 2] and all(
        r["final"] == [1, 2] and not r["released"]
        and r["events"] == want["events"] and r["losses"] == want["losses"]
        and r["params"] == want["params"] and r["plan"] == want["plan"]
        for r in kept),
          f"{key}: the re-plan over processes {[r['events'] for r in kept]} "
          f"(plans {[r.get('plan') for r in kept]}, losses "
          f"{[r['losses'] for r in kept]}) is not the in-process elastic "
          f"run's bits: {want['events']}, {want.get('plan')}, "
          f"{want['losses']}")
    check(all(r["released"] and "params" not in r
              and r["events"][-1].startswith("released") for r in released),
          f"{key}: ranks 2-3 were not released: "
          f"{[r['events'] for r in released]}")
    out["supervise"]["plans_elastic"] = {
        "pinned": plan.name, "replanned": want["plan"],
        "losses": kept[0]["losses"], "events": kept[0]["events"],
        "wall_s": [r["wall_s"] for r in got],
        "in_process_wall_s": want["wall_s"]}
    log("procmesh", f"plans supervisor {key}: DeviceLost(available=2) on "
        f"rank 2; the pinned plan re-planned (auto) to {want['plan']} at "
        f"1 x 2 on ranks 0-1, bitwise the in-process elastic run (events "
        f"{json.dumps(want['events'])}); ranks 2-3 released")
    log("timings", f"procmesh plans supervisor {key} ({card}): wall "
        f"{[round(r['wall_s'], 1) for r in got]} s, in-process "
        f"{want['wall_s']:.1f} s")
    return {q: sum(r["launches"][q] for r in got) for q in KERNELS}


def plans_serve_runs(pool, k, ucfg, RunConfig, compile, plan_lib, depth,
                     card: str, out: dict) -> dict:
    """Phase 10w's ``PROCMESH_PLANS_SERVE`` runs: the U-Net at 256^3
    served over S processes under a one-transition plan, rank 0's
    logits bitwise the in-process session's at the same plan, each
    rank's launches summed against ``kernel_launches``. Returns them."""
    total = dict(NO_LAUNCHES)
    for tag, batch, S, kind in PROCMESH_PLANS_SERVE:
        plan = spatial_plan(plan_lib, depth, ucfg, S, kind)
        key = f"{tag}/{ucfg.name}/b{batch}/S{S}/{plan.name}/fp32"
        # the card for the ranks' 256^3 forwards (~21 GiB a rank): every
        # process's cached blocks and cuBLAS workspaces handed back first
        release_cached(f"procmesh {key}")
        pool.run(_child_release)
        # one timed predict: over processes a 256^3 b2 forward takes
        # seconds (every all_to_all's bytes through loopback gloo)
        got = pool.run(procmesh_serve_job, ucfg, batch, S, 21, plan, 0,
                       ranks=range(S))
        w = ucfg.input_width
        x = torch.randn((batch, w, w, w, ucfg.in_channels), device="cuda",
                        generator=torch.Generator(
                            device="cuda").manual_seed(21))
        sess = compile(RunConfig(model=ucfg, mode="infer",
                                 global_batch=batch, spatial=S, plan=plan),
                       devices=["cuda:0"] * S)
        want = sess.predict(x)
        threads_ms = host_ms(lambda: sess.predict(x), 1)
        per_fwd = dict(NO_LAUNCHES, **k.unet3d.kernel_launches(ucfg,
                                                               sess.plan))
        sess.close()
        same = torch.equal(got[0]["pred"].cuda(), want)
        summed = {q: sum(r["launches"][q] for r in got) for q in KERNELS}
        check(same and tuple(want.shape) == (batch, w, w, w, ucfg.out_dim)
              and bool(torch.isfinite(want).all()),
              f"{key}: rank 0's logits are not the in-process session's "
              f"bits (max abs diff "
              f"{(got[0]['pred'].cuda() - want).abs().max().item()})")
        check(summed == per_fwd, f"{key}: launches summed over the ranks "
              f"{summed}, expected {per_fwd}")
        total = {q: total[q] + summed[q] for q in KERNELS}
        out["serve"][key] = {
            "bitwise_in_process": same, "launches_summed": summed,
            "ms": [r["ms"] for r in got], "in_process_ms": threads_ms,
            "peak_bytes": [r["peak_bytes"] for r in got]}
        log("procmesh", f"plans serve {key}: bitwise the in-process "
            f"session; launches summed {json.dumps(summed)} = "
            f"kernel_launches")
        log("timings", f"procmesh plans serve {key} ({card}): ms of one predict "
            f"over processes {[round(r['ms'], 2) for r in got]}, in-process "
            f"{threads_ms:.2f}; peak a rank "
            f"{[round(r['peak_bytes'] / 2 ** 30, 2) for r in got]} GiB")
        del x, want, got
        release_cached(f"the runs after {key}")
    return total


def phase_procmesh_io(pool, k, cf128, ucfg, ucfg64, RunConfig, compile,
                      plan_lib, depth, root: str, card: str) -> tuple:
    """Phase 10w's ``PROCMESH_IO`` runs on ``pool`` (the module docstring
    has the gates). Returns (report, the launches the children's main
    paths made)."""
    from repro_torch.data import store, synthetic
    from repro_torch.launch.mesh import Mesh

    out = {"loader": {}, "serve": {}, "supervise": {}}
    total = dict(NO_LAUNCHES)
    t_phase = time.perf_counter()
    stores = {}
    for model, cfg in (("cosmo", cf128), ("unet", ucfg64)):
        path = os.path.join(root, f"store-{model}")
        if cfg.arch == "cosmoflow":
            cubes, targets = synthetic.make_cosmology_dataset(
                PROCMESH_IO_SAMPLES, cfg.input_width,
                channels=cfg.in_channels, seed=3)
            store.write_dataset(path, cubes, targets)
        else:
            cubes, labels = synthetic.make_segmentation_dataset(
                PROCMESH_IO_SAMPLES, cfg.input_width,
                num_classes=cfg.out_dim, channels=cfg.in_channels, seed=4)
            store.write_dataset(path, cubes, labels=labels)
        del cubes
        stores[model] = path
    log("procmesh", f"io: stores written in "
        f"{time.perf_counter() - t_phase:.1f} s")

    # (a) the per-rank loader (PROCMESH_PLANS_IO: under a planned layout)
    for tag, model, D, S, *kind in PROCMESH_IO + PROCMESH_PLANS_IO:
        cfg, batch = ((cf128, 4) if model == "cosmo"
                      else (ucfg64, UNET_CHECK_BATCH))
        kind = kind[0] if kind else "fixed"
        key = f"{tag}/{cfg.name}/b{batch}/{D}x{S}" + (
            f"/{kind}" if kind != "fixed" else "")
        pinned = (spatial_plan(plan_lib, depth, cfg, S, kind, data=D)
                  if kind != "fixed" else "fixed")
        n = D * S
        t_run = time.perf_counter()
        got = pool.run(procmesh_io_job, cfg, batch, D, S, stores[model],
                       ["cuda:0"] * n, pinned, ranks=range(n))
        want = io_train(k, compile, RunConfig, cfg, batch, D, S,
                        stores[model], ["cuda:0"] * n, pinned)
        plan = want["plan"]
        w, c = cfg.input_width, cfg.in_channels
        # a rank reads 1/(D x S) of the volumes' bytes: its rows' depth
        # slabs under a spatial entry stage, whole volumes of its own
        # samples under a batch one (uniform_batch); x, and the U-Net's
        # int32 voxel labels
        volume = w ** 3 * c * 4 + (w ** 3 * 4 if cfg.arch == "unet3d" else 0)
        mine = PROCMESH_IO_SAMPLES * volume // n
        for depth in (0, PROCMESH_IO_PREFETCH):
            w_row = want[0]  # the synchronous in-process run: the oracle
            for r in got:
                row = r[depth]
                check(all(c_[0] == want_[r["rank"]] for c_, want_ in zip(
                    row["crcs"], w_row["crcs"])),
                      f"{key} prefetch {depth}: rank {r['rank']}'s blocks "
                      f"are not its slice of the in-process batch")
                check(row["pfs"] == {r["rank"]: mine},
                      f"{key} prefetch {depth}: rank {r['rank']} read "
                      f"{row['pfs']} bytes over the first epoch, expected "
                      f"{mine} (1/(D x S) of the volumes)")
                check(row["losses"] == w_row["losses"]
                      and row["params"] == w_row["params"],
                      f"{key} prefetch {depth}: rank {r['rank']}'s losses "
                      f"{row['losses']} or parameters are not the "
                      f"in-process loader-fed run's {w_row['losses']}")
        check(want[PROCMESH_IO_PREFETCH]["losses"] == want[0]["losses"],
              f"{key}: in-process prefetch against synchronous")
        model_ = k.unet3d if cfg.arch == "unet3d" else k.cosmoflow
        per_step = dict(NO_LAUNCHES, **model_.kernel_launches(
            cfg, plan, train=True))
        summed = {q: sum(r[0]["launches"][q] for r in got) for q in KERNELS}
        expect = {q: v * PROCMESH_IO_STEPS for q, v in per_step.items()}
        check(summed == expect, f"{key}: launches summed over the ranks "
              f"{summed}, expected {expect}")
        total = {q: total[q] + summed[q] for q in KERNELS}
        row = out["loader"][key] = {
            "losses": want[0]["losses"], "rank_pfs_bytes": mine,
            "launches_summed": summed,
            "ms": {d: [r[d]["ms"] for r in got]
                   for d in (0, PROCMESH_IO_PREFETCH)},
            "stall_s": [r[PROCMESH_IO_PREFETCH]["stall_s"] for r in got],
            "in_process_ms": {d: want[d]["ms"]
                              for d in (0, PROCMESH_IO_PREFETCH)},
            "in_process_stall_s": want[PROCMESH_IO_PREFETCH]["stall_s"],
            "seconds": time.perf_counter() - t_run}

        def med(v):
            return round(statistics.median(v[1:]), 2)
        log("procmesh", f"io {key}: each rank's blocks bitwise its slice "
            f"of the in-process loader's batch, {mine} store bytes a rank "
            f"over the first epoch, {PROCMESH_IO_STEPS} loader-fed steps' "
            f"losses and the parameters bitwise, sync and prefetch "
            f"{PROCMESH_IO_PREFETCH}; launches summed {json.dumps(summed)}")
        log("timings", f"procmesh io {key} ({card}): load + step ms "
            f"(median of steps 2-{PROCMESH_IO_STEPS}) over processes sync "
            f"{[med(r[0]['ms']) for r in got]}, prefetch "
            f"{[med(r[PROCMESH_IO_PREFETCH]['ms']) for r in got]} (stall_s "
            f"{[round(v, 4) for v in row['stall_s']]}); in-process sync "
            f"{med(want[0]['ms'])}, prefetch "
            f"{med(want[PROCMESH_IO_PREFETCH]['ms'])} (stall_s "
            f"{want[PROCMESH_IO_PREFETCH]['stall_s']:.4f}); "
            f"{row['seconds']:.1f} s")
        del got, want
        torch.cuda.empty_cache()

    if PROCMESH_IO_SERVE:
        got = io_harness_runs(pool, k, cf128, RunConfig, compile, card, out)
        total = {q: total[q] + got[q] for q in KERNELS}
    if PROCMESH_IO_SUPERVISE:
        got = io_supervisor_runs(pool, k, cf128, root, stores, card, out)
        total = {q: total[q] + got[q] for q in KERNELS}
    if PROCMESH_PLANS_HARNESS:
        got = io_harness_runs(pool, k, cf128, RunConfig, compile, card, out,
                              PROCMESH_PLANS_HARNESS, "auto")
        total = {q: total[q] + got[q] for q in KERNELS}
    if PROCMESH_PLANS_SUPERVISE:
        got = plans_supervisor_run(pool, k, cf128, root, stores, plan_lib,
                                   depth, card, out)
        total = {q: total[q] + got[q] for q in KERNELS}
    if PROCMESH_PLANS_SERVE:
        got = plans_serve_runs(pool, k, ucfg, RunConfig, compile, plan_lib,
                               depth, card, out)
        total = {q: total[q] + got[q] for q in KERNELS}
    out["seconds"] = time.perf_counter() - t_phase
    log("procmesh", f"io: the PROCMESH_IO runs took {out['seconds']:.1f} s")
    return out, total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every measurement as JSON")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import configs
    from repro_torch.api import RunConfig, compile
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import memory, perf_model
    from repro_torch.core import plan as plan_lib
    from repro_torch.core import spmd
    from repro_torch.core.spatial_conv import SpatialPartitioning
    from repro_torch.kernels import _build
    from repro_torch.kernels.bn_act import ops as bn_ops
    from repro_torch.kernels.bn_act import ref as bn_ref
    from repro_torch.kernels.conv3d import ops as conv_ops
    from repro_torch.kernels.conv3d import ref as conv_ref
    from repro_torch.kernels.halo_pack import ops as pack_ops
    from repro_torch.kernels.halo_pack import ref as pack_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import specs
    from repro_torch import models
    from repro_torch.core import flags, param_specs, sharding
    from repro_torch.core import tree
    from repro_torch.examples import serve_lm
    from repro_torch.launch import train as launch_train
    from repro_torch.models import cosmoflow, for_config, mamba2, ssm_lm
    from repro_torch.models import frontends, transformer, unet3d
    from repro_torch.optim.adam import Adam, warmup_cosine
    from repro_torch.serve import lm
    from repro_torch.train import train_step

    t_start = time.perf_counter()

    def clock(what: str) -> None:
        log("clock", f"{what}: done at {time.perf_counter() - t_start:.0f} s")
    k = argparse.Namespace(conv_ops=conv_ops, conv_ref=conv_ref,
                           bn_ops=bn_ops, bn_ref=bn_ref, pack_ops=pack_ops,
                           pack_ref=pack_ref, ssd_ops=ssd_ops,
                           ssd_ref=ssd_ref, mamba2=mamba2, ssm_lm=ssm_lm,
                           lm=lm, cosmoflow=cosmoflow, unet3d=unet3d,
                           for_config=for_config, train_step=train_step,
                           spmd=spmd, memory=memory, mesh_lib=mesh_lib,
                           transformer=transformer, frontends=frontends,
                           configs=configs, specs=specs, models=models,
                           flags=flags, tree=tree, Adam=Adam,
                           warmup_cosine=warmup_cosine,
                           launch_train=launch_train, serve_lm=serve_lm,
                           sharding=sharding, param_specs=param_specs)
    report = {"card": phase_card()}
    report["build"] = phase_build(_build)
    clock("build")
    cf128, cf512 = get_config("cosmoflow-128"), get_config("cosmoflow-512")
    cfgs = {"cosmoflow-128": cf128, "cosmoflow-512": cf512}
    depth = SpatialPartitioning(("model", None, None))
    shapes128 = cosmoflow.conv_shapes(cf128, 4)
    # and the quickstart's (phase 10s): cosmoflow-512's smoke variant, b4
    report["kernels"] = phase_kernels(
        conv_ops, conv_ref, bn_ops, bn_ref,
        shapes128 + cosmoflow.conv_shapes(get_smoke_config("cosmoflow-512"),
                                          4))
    ucfg = get_config("unet3d-256")
    ucfg64 = dataclasses.replace(ucfg, name=f"{ucfg.name}@{UNET_CHECK_WIDTH}",
                                 input_width=UNET_CHECK_WIDTH)
    report["halo_kernels"] = phase_halo_kernels(
        pack_ops, pack_ref,
        sorted(set(halo_cases(cosmoflow, plan_lib, depth, cfgs))
               | unet_halo_cases(unet3d, plan_lib, depth, ucfg, ucfg64)))
    # phase 10e first, while the allocator holds nothing: a 256^3 step
    # reserves ~73 GB, and the later phases leave cached segments pinned
    # by small live blocks (~23 GB reserved with 3 GB allocated)
    unet_train = phase_unet_train(k, ucfg, RunConfig, compile)
    clock("kernels, halo kernels, unet_train")
    # phase 10g next, for the same reason: cosmoflow-512 b2 and the U-Net
    # at 256^3, every block rematerialized
    release_cached("train_remat")
    train_remat, got_remat = phase_train_remat(
        k, cfgs, ucfg, RunConfig, compile, plan_lib, depth, report["card"])
    clock("train_remat")
    # phase 10q next: its U-Net at 256^3 b2 needs most of the card too
    release_cached("train_pipeline")
    train_pipeline, got_pipe, pipe_unet_row = phase_train_pipeline(
        k, cf128, ucfg, ucfg64, RunConfig, compile, plan_lib, perf_model,
        report["card"])
    release_cached("the serving phases")
    clock("train_pipeline")

    # ------------------------------------------- main path 1: 4-6 ----
    n128, n512 = cosmoflow.num_blocks(cf128), cosmoflow.num_blocks(cf512)
    g = torch.Generator(device="cuda").manual_seed(1)
    x128 = torch.randn((4, 128, 128, 128, 4), generator=g, device="cuda")
    zero_counts(k)
    forwards = 0
    sessions = {}
    preds = {}
    serve = {}
    for prec, rel in (("fp32", 1e-4), ("bf16", 5e-2)):
        sess = compile(RunConfig(model="cosmoflow-128", mode="infer",
                                 global_batch=4, precision=prec))
        check(sess.device.type == "cuda", "session not on the card")
        expect = dict(NO_LAUNCHES, conv3d=n128, bn_act=n128)
        preds[("cosmoflow-128", prec)], err = serve_and_compare(
            sess, x128, k, rel, f"cosmoflow-128 {prec}", expect)
        forwards += 1
        sessions[prec] = sess
        serve[f"cosmoflow-128/{prec}"] = {"rel_err_vs_plain": err,
                                          "tol": rel}
        log("serve", f"cosmoflow-128 {prec} batch 4: {n128} conv3d + {n128} "
            f"bn_act launches; vs plain forward {err:.3g} <= {rel}")

    x512 = torch.randn((1, 512, 512, 512, 4), generator=g, device="cuda")
    sess512 = compile(RunConfig(model="cosmoflow-512", mode="infer",
                                global_batch=1, precision="fp32"))
    c0 = counts(k)
    box = []
    resident = torch.cuda.memory_allocated()
    peak = k.memory.measured_peak_bytes(
        lambda: box.append(sess512.predict(x512)))
    pred512 = box.pop()
    check(delta(counts(k), c0) == dict(NO_LAUNCHES, conv3d=n512,
                                       bn_act=n512),
          "cosmoflow-512: launches per forward")
    check(tuple(pred512.shape) == (1, 4)
          and bool(torch.isfinite(pred512).all()), "cosmoflow-512 output")
    forwards += 1
    preds[("cosmoflow-512", "fp32")] = pred512
    with plain_versions(k):
        want512 = sess512.predict(x512)
    err512 = rel_err(pred512, want512)
    check(err512 <= 1e-4, f"cosmoflow-512 vs plain forward {err512}")
    del want512
    serve["cosmoflow-512/fp32"] = {
        "rel_err_vs_plain": err512, "tol": 1e-4, "peak_bytes": peak.allocated,
        "peak_reserved_bytes": peak.reserved,
        "resident_bytes_before": resident,
        "foreign_bytes": foreign_bytes(resident, sess512, x512),
        "modeled": modeled(sess512)}
    log("serve512", f"cosmoflow-512 fp32 batch 1: finite "
        f"{tuple(pred512.shape)}; vs plain forward {err512:.3g}; peak "
        f"device memory {peak.allocated / 2 ** 30:.2f} GiB allocated, "
        f"{peak.reserved / 2 ** 30:.2f} reserved (measured_peak_bytes)")

    sess = sessions["fp32"]
    reqs = np.random.default_rng(2).standard_normal(
        (16, 128, 128, 128, 4), dtype=np.float32)
    with sess.serve(max_batch=4, max_wait_ms=50) as h:
        futs = h.submit_many(list(reqs))
        rows = [f.result(timeout=300) for f in futs]
    check(all(r.shape == (4,) and np.all(np.isfinite(r)) for r in rows),
          "harness replies")
    tele = sess.telemetry()
    check(tele["serve.requests"] == 16 and tele["serve.worker_failures"] == 0,
          f"harness telemetry {tele}")
    forwards += int(tele["serve.batches"])
    log("harness", f"16/16 futures resolved; telemetry {json.dumps(tele)}")

    launches = counts(k)
    check(launches == dict(NO_LAUNCHES, conv3d=7 * forwards,
                           bn_act=7 * forwards),
          f"{launches} launches on the unsharded path, expected 7 conv3d "
          f"and 7 bn_act per forward x {forwards} forwards")
    log("main path", f"unsharded: {forwards} forwards; launches {launches}")
    main_paths = {"unsharded": {"forwards": forwards, "launches": launches}}
    # the serving peak at 128^3 b4 (phase m), after the path is read
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    peak = k.memory.measured_peak_bytes(lambda: sessions["fp32"].predict(
        x128))
    serve["cosmoflow-128/fp32"].update(
        peak_bytes=peak.allocated, peak_reserved_bytes=peak.reserved,
        resident_bytes_before=resident,
        foreign_bytes=foreign_bytes(resident, sessions["fp32"], x128),
        modeled=modeled(sessions["fp32"]))

    # ------------------------------------------- main path 2: 7-8 ----
    zero_counts(k)
    expected = dict.fromkeys(KERNELS, 0)
    spatial = {}
    spatial_sessions = {}
    for name, batch, S, prec, kind in SPATIAL:
        cfg = cfgs[name]
        tag = f"{name}/{prec}/S{S}/{kind}"
        plan = "fixed" if kind == "fixed" else spatial_plan(
            plan_lib, depth, cfg, S, kind)
        sess = compile(RunConfig(model=name, mode="infer",
                                 global_batch=batch, precision=prec,
                                 spatial=S, plan=plan),
                       devices=["cuda:0"] * S)
        check(sess.mesh.shape == {"data": 1, "model": S}
              and len(set(map(id, (sess.mesh.stream(r)
                                   for r in range(S))))) == S,
              f"{tag}: mesh {sess.mesh}")
        x = x128 if name == "cosmoflow-128" else x512
        per_fwd = dict(NO_LAUNCHES,
                       **cosmoflow.kernel_launches(cfg, sess.plan))
        if name == "cosmoflow-512":
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
        rel_plain = 1e-4 if prec == "fp32" else 5e-2
        pred, err_plain = serve_and_compare(sess, x, k, rel_plain, tag,
                                            per_fwd)
        for kname in KERNELS:
            expected[kname] += per_fwd[kname]
        row = {"launches_per_forward": per_fwd,
               "rel_err_vs_plain": err_plain, "tol_vs_plain": rel_plain}
        if name == "cosmoflow-512":
            row["peak_bytes"] = torch.cuda.max_memory_allocated()
            row["resident_bytes_before"] = resident
        tol = 1e-5 if prec == "fp32" else 5e-2
        err = rel_err(pred, preds[(name, prec)])
        check(err <= tol, f"{tag}: vs the unsharded forward {err} > {tol}")
        row.update(rel_err_vs_unsharded=err, tol_vs_unsharded=tol)
        spatial[tag] = row
        spatial_sessions[tag] = (sess, x)
        log("spatial", f"{tag} batch {batch}: launches {json.dumps(per_fwd)}"
            f"; vs unsharded {err:.3g} <= {tol}; vs plain {err_plain:.3g}"
            + (f"; peak {row['peak_bytes'] / 2 ** 30:.2f} GiB "
               f"({resident / 2 ** 30:.2f} GiB resident before)"
               if "peak_bytes" in row else ""))

    sess2 = spatial_sessions["cosmoflow-128/fp32/S2/fixed"][0]
    with sess2.serve(max_batch=4, max_wait_ms=50) as h:
        rows = [f.result(timeout=300) for f in h.submit_many(list(reqs[:8]))]
    check(all(r.shape == (4,) and np.all(np.isfinite(r)) for r in rows),
          "spatial harness replies")
    tele2 = sess2.telemetry()
    check(tele2["serve.requests"] == 8 and tele2["serve.worker_failures"] == 0,
          f"spatial harness telemetry {tele2}")
    per_fwd = spatial["cosmoflow-128/fp32/S2/fixed"]["launches_per_forward"]
    for kname in KERNELS:
        expected[kname] += per_fwd[kname] * int(tele2["serve.batches"])
    log("harness", f"spatial S=2: 8/8 futures resolved; telemetry "
        f"{json.dumps(tele2)}")
    got = counts(k)
    check(got == expected, f"spatial path launches {got}, derived from the "
          f"plans {expected}")
    check(got["pack"] > 0 and got["unpack"] > 0, "pack/unpack never ran")
    log("main path", f"spatial: launches {got} = derived from the plans")
    main_paths["spatial"] = {"launches": got, "expected": expected}
    launches = {n: main_paths["unsharded"]["launches"][n] + got[n]
                for n in KERNELS}

    # ------------------------------------------------------- timings ----
    timing = {"conv3d": [], "bn_act": []}
    log("timings", PEAKS_USED)
    gt = torch.Generator(device="cuda").manual_seed(3)
    for cfg, batch, prec, reps in ((cf128, 4, "fp32", 5),
                                   (cf128, 4, "bf16", 3),
                                   (cf512, 1, "fp32", 2)):
        layer_rows(k, cfg, batch, prec, reps, gt, timing)
    # conv3d per forward against F.conv3d, and at each of layers 0-2
    conv_vs_library = {}
    for cfg, batch, prec in ((cf128, 4, "fp32"), (cf128, 4, "bf16"),
                             (cf512, 1, "fp32")):
        key = f"{cfg.name}/{prec}/b{batch}"
        conv_vs_library[key] = per_forward(timing, cfg, batch, prec)
        log("timings", f"conv3d per forward {key}: "
            + json.dumps(conv_vs_library[key]))
    # the launch floor: device time per call of a kernel that does nothing
    # (a spin of zero cycles), queued as pack and unpack are
    timing["launch_floor_ms"] = queued_ms(lambda: torch.cuda._sleep(0))
    log("timings", f"launch floor {timing['launch_floor_ms']:.5f} ms a "
        "call (queued)")
    # pack and unpack at every shape the spatial paths gave them, and at
    # the U-Net's faces served at S = 2 and 4 (the largest in the repo)
    halo_keys = set()
    for name, batch, S, prec, kind in SPATIAL:
        for sc in cosmoflow.split_convs(
                cfgs[name], spatial_plan(plan_lib, depth, cfgs[name], S,
                                         kind), batch):
            halo_keys.add((sc.shape, sc.lo, sc.hi, prec))
    for S, prec in UNET_HALO:
        for sc in unet3d.split_convs(ucfg, plan_lib.legacy_convnet_plan(
                ucfg, depth, (S, 1, 1)), 1):
            halo_keys.add((sc.shape, sc.lo, sc.hi, prec))
    halo = halo_rows(k, sorted(halo_keys), 20, timing["launch_floor_ms"])
    timing["pack"] = list(halo["pack"].values())
    timing["unpack"] = list(halo["unpack"].values())

    e2e = {
        "cosmoflow-128/fp32/b4": host_ms(lambda: sessions["fp32"].predict(
            x128), 5),
        "cosmoflow-128/bf16/b4": host_ms(lambda: sessions["bf16"].predict(
            x128), 5),
        "cosmoflow-512/fp32/b1": host_ms(lambda: sess512.predict(x512), 2),
    }
    for tag, (sess, x) in spatial_sessions.items():
        e2e[tag] = host_ms(lambda: sess.predict(x),
                           2 if tag.startswith("cosmoflow-512") else 5)
    log("timings", f"end-to-end predict ms per batch {json.dumps(e2e)}")
    # the two conv lowerings against each other: each legacy fp32 spatial
    # session (overlapped) and the same config compiled with
    # overlap_halo=False (blocking), timed overlapped, blocking,
    # blocking, overlapped, before any profiler has run
    lowering, blocking = {}, {}
    for tag in ("cosmoflow-128/fp32/S2/fixed", "cosmoflow-128/fp32/S4/fixed",
                "cosmoflow-512/fp32/S4/fixed"):
        sess, x = spatial_sessions[tag]
        name, S = tag.split("/")[0], int(tag.split("/")[2][1:])
        blk = compile(RunConfig(model=name, mode="infer",
                                global_batch=x.shape[0], precision="fp32",
                                spatial=S, plan="fixed", overlap_halo=False),
                      devices=["cuda:0"] * S)
        err = rel_err(blk.predict(x), preds[(name, "fp32")])
        check(err <= 1e-5, f"{tag} blocking: vs the unsharded forward {err}")
        reps = 2 if name == "cosmoflow-512" else 5
        fns = (lambda: sess.predict(x), lambda: blk.predict(x))
        t = [host_ms(fns[i], reps) for i in (0, 1, 1, 0)]
        lowering[tag] = {"overlap_ms": [t[0], t[3]],
                         "blocking_ms": [t[1], t[2]],
                         "blocking_rel_err_vs_unsharded": err}
        blocking[tag] = blk
        log("timings", f"lowering {tag} {json.dumps(lowering[tag])}")
    profiles = {
        "cosmoflow-128/fp32/b4": device_profile(
            lambda: sessions["fp32"].predict(x128)),
        "cosmoflow-512/fp32/b1": device_profile(
            lambda: sess512.predict(x512)),
    }
    for tag, blk in blocking.items():
        sess, x = spatial_sessions[tag]
        profiles[tag] = device_profile(lambda: sess.predict(x))
        profiles[tag + "/blocking"] = device_profile(lambda: blk.predict(x))
    for key, prof in profiles.items():
        log("profile", f"{key} {json.dumps(prof)}")
    for s in (*sessions.values(), sess512, *blocking.values(),
              *(v[0] for v in spatial_sessions.values())):
        s.close()
    # the loops' last volume (x512, 2.1 GB) and sessions too: what stays
    # allocated pins its cached segment for the later phases
    del x128, x512, sessions, sess512, blocking, spatial_sessions, preds
    del x, sess, blk, pred, pred512
    release_cached("the training phases")
    clock("serving, spatial serving, timings")

    # ------------------------------------------------ main path 3: 10 ----
    train, got = phase_train(k, cfgs, RunConfig, compile)
    clock("train")
    main_paths["train"] = {"launches": got}
    launches = {n: launches[n] + got[n] for n in KERNELS}
    main_paths["train_remat"] = {"launches": got_remat}
    launches = {n: launches[n] + got_remat[n] for n in KERNELS}
    main_paths["train_pipeline"] = {"launches": got_pipe}
    launches = {n: launches[n] + got_pipe[n] for n in KERNELS}
    # every block rematerialized (phase 10g) beside the same configs
    # without (phases 10 and 10e), in this run
    vs = train_remat["vs_no_remat"] = {}
    for tag, plain in (("cosmoflow-512/fp32/b1", train["steps"]),
                       ("cosmoflow-512/fp32/b2", train_remat["runs"]),
                       ("unet3d-256/fp32/b1", unet_train[0]["steps"])):
        on, off = train_remat["runs"][tag + "/remat"], plain[tag]
        vs[tag] = {key: (on[key], off[key]) for key in
                   ("peak_bytes", "peak_reserved_bytes", "ms_per_step")}
        log("train_remat", f"{tag}: remat vs none: peak "
            f"{on['peak_bytes'] / 2 ** 30:.2f} vs "
            f"{off['peak_bytes'] / 2 ** 30:.2f} GiB allocated, "
            f"{on['peak_reserved_bytes'] / 2 ** 30:.2f} vs "
            f"{off['peak_reserved_bytes'] / 2 ** 30:.2f} GiB reserved; "
            f"{on['ms_per_step']:.1f} vs {off['ms_per_step']:.1f} ms a step "
            f"({report['card']})")

    # ------------------------------------------ main path 4: 10b ----
    train_spatial, got = phase_train_spatial(
        k, cf128, TRAIN_SPATIAL, 4, {"e"}, RunConfig, compile, plan_lib,
        depth, report["card"], split_reps=2)
    main_paths["train_spatial"] = {"launches": got}
    clock("train_spatial")
    launches = {n: launches[n] + got[n] for n in KERNELS}

    # ------------------------------------------ main path: 10h ----
    train_io, got = phase_train_io(k, cf128, RunConfig, compile,
                                   report["card"])
    main_paths["train_io"] = {"launches": got}
    clock("train_io")
    launches = {n: launches[n] + got[n] for n in KERNELS}

    # ------------------------------------------ main path: 10z ----
    train_zero1, got = phase_train_zero1(k, cf128, ZERO1, 4, RunConfig,
                                         compile, report["card"])
    main_paths["train_zero1"] = {"launches": got}
    clock("train_zero1")
    launches = {n: launches[n] + got[n] for n in KERNELS}

    # ------------------------------ the 3D U-Net: main paths 10c-10f ----
    unet, got, paths = phase_unet(k, ucfg, ucfg64, RunConfig, compile,
                                  plan_lib, depth, report["card"],
                                  unet_train)
    main_paths.update({name: {"launches": v} for name, v in paths.items()})
    clock("the U-Net phases")
    launches = {n: launches[n] + got[n] for n in KERNELS}
    # ------------------------------------------ main path: 10z-u ----
    unet["train_zero1"], got = phase_train_zero1(
        k, ucfg64, ZERO1_UNET, UNET_CHECK_BATCH, RunConfig, compile,
        report["card"])
    main_paths["train_zero1_unet"] = {"launches": got}
    clock("train_zero1_unet")
    launches = {n: launches[n] + got[n] for n in KERNELS}
    # ------------------------------------------ main path: 10p ----
    plans, got = phase_plans(k, cf128, ucfg, ucfg64, RunConfig, compile,
                             plan_lib, depth, report["card"])
    main_paths["plans"] = {"launches": got}
    clock("plans")
    launches = {n: launches[n] + got[n] for n in KERNELS}
    # ------------------------------------------ main path: 10s ----
    supervise, got = phase_supervise(k, cf128, RunConfig, compile, plan_lib,
                                     depth, report["card"])
    main_paths["supervise"] = {"launches": got}
    clock("supervise")
    launches = {n: launches[n] + got[n] for n in KERNELS}
    # ------------------------------------------ main path: 10w ----
    release_cached("procmesh")
    procmesh, got = phase_procmesh(k, cf128, ucfg, ucfg64, RunConfig,
                                   compile, plan_lib, depth, perf_model,
                                   report["card"])
    main_paths["procmesh"] = {"launches": got}
    clock("procmesh")
    launches = {n: launches[n] + got[n] for n in KERNELS}

    # -------------------------------- (m) modeled against measured ----
    memory_rows = {f"train {tag}": row for tag, row in train["steps"].items()}
    memory_rows.update({f"train {tag}": row for tag, row in
                        train_remat["runs"].items()})
    memory_rows.update({f"train {tag}": row for tag, row in
                        unet_train[0]["steps"].items()})
    memory_rows[f"train {ucfg.name}/{PIPE_UNET_PREC}/b{PIPE_UNET_BATCH} "
                f"pipe2 M{PIPE_UNET_M}"] = pipe_unet_row
    memory_rows.update({f"serve {tag}": serve[tag] for tag in (
        "cosmoflow-128/fp32", "cosmoflow-512/fp32")})
    memory_rows[f"serve {ucfg.name}/fp32/S1"] = unet["serve"]["predict"][
        f"{ucfg.name}/fp32/S1"]
    memory_model = phase_memory_model(memory_rows, report["card"])

    # ------------------------------------------ mamba2-370m: 11-14 ----
    release_cached("the Mamba2 phases")
    report["ssd_kernel"] = phase_ssd_kernel(ssd_ops, ssd_ref, mamba2)
    mcfg = get_config("mamba2-370m")
    t0 = time.perf_counter()
    p32 = ssm_lm.init_params(mcfg, torch.Generator().manual_seed(0),
                             device="cuda")
    params = {"fp32": p32, "bf16": to_dtype(p32, torch.bfloat16)}
    log("score", f"{mcfg.name}: {mcfg.param_count() / 1e6:.1f}M parameters "
        f"on the card in {time.perf_counter() - t0:.1f}s")
    zero_counts(k)
    score, fwd_score = phase_score(k, mcfg, params)
    decode_row, fwd_decode = phase_decode(k, mcfg, p32)
    got = counts(k)
    forwards_lm = fwd_score + fwd_decode
    check(got == dict(NO_LAUNCHES, ssd_scan=mcfg.num_layers * forwards_lm),
          f"mamba2 path launches {got}, expected {mcfg.num_layers} ssd_scan "
          f"per forward x {forwards_lm} forwards")
    log("main path", f"mamba2-370m: {forwards_lm} forwards; launches {got}")
    main_paths["mamba2"] = {"forwards": forwards_lm, "launches": got}
    clock("ssd, score, decode")
    launches = {n: launches[n] + got[n] for n in KERNELS}

    # ------------------------- main path 13b: every LM family ----
    release_cached("the LM families")
    zcfg = get_config("zamba2-1.2b")
    zero_counts(k)
    lm_families, forwards_fam = phase_lm_families(k, get_config)
    got = counts(k)
    check(got == dict(NO_LAUNCHES, ssd_scan=zcfg.num_layers * forwards_fam),
          f"LM families path launches {got}, expected {zcfg.num_layers} "
          f"ssd_scan per zamba2 forward x {forwards_fam} forwards (the "
          f"transformers launch none)")
    log("main path", f"LM families: {forwards_fam} zamba2-1.2b forwards; "
        f"launches {got}")
    main_paths["lm_families"] = {"forwards": forwards_fam, "launches": got}
    clock("lm_families")
    launches = {n: launches[n] + got[n] for n in KERNELS}

    # ------------------------- main path 13c: LM training ----
    release_cached("LM training")
    zero_counts(k)
    lm_train, launched_train = phase_lm_train(k, get_config)
    got = counts(k)
    check(got == dict(NO_LAUNCHES, ssd_scan=launched_train),
          f"LM training path launches {got}, expected {launched_train} "
          f"ssd_scan (kernel_launches(train=True) a step and step-1 check, "
          f"the transformers none)")
    log("main path", f"LM training: launches {got} in "
        f"{lm_train['seconds']:.0f} s")
    main_paths["lm_train"] = {"launches": got}
    clock("lm_train")
    launches = {n: launches[n] + got[n] for n in KERNELS}

    lm_train["ssd_backward"] = ssd_backward_rows(k)
    timing["ssd_scan"] = ssd_rows(k)
    timing["ssd_scan_zamba2"] = ssd_rows(k, SSD_LAYERS["zamba2-1.2b"])
    lm_tokens = lm_batch(mcfg, 4, 4096, seed=7)["tokens"]
    for prec in ("fp32", "bf16"):
        tag = f"mamba2-370m/{prec}/4x4096"
        profiles[tag] = device_profile(
            lambda: ssm_lm.forward(params[prec], lm_tokens, mcfg))
        log("profile", f"{tag} {json.dumps(profiles[tag])}")
    del params, p32, lm_tokens

    # ------- main path 13d: the sharded LMs (after phase 14's timings,
    # with phase 12's parameters freed; each run drops the cache first)
    zero_counts(k)
    lm_sharded, launched_sharded = phase_lm_sharded(k, get_config, lm_train)
    got = counts(k)
    check(got == dict(NO_LAUNCHES, ssd_scan=launched_sharded),
          f"sharded LM path launches {got}, expected {launched_sharded} "
          f"ssd_scan (kernel_launches(train=True) a shard a step and "
          f"step-1 check, the transformers none)")
    log("main path", f"sharded LMs: launches {got} in "
        f"{lm_sharded['seconds']:.0f} s")
    main_paths["lm_sharded"] = {"launches": got}
    clock("lm_sharded")
    launches = {n: launches[n] + got[n] for n in KERNELS}

    # the summary: one forward's worth of each kernel at its main path's
    # first config — cosmoflow-128 batch-4 fp32: conv3d and bn_act of the
    # unsharded forward (7 calls each), pack of the S=2 forward (4 blocks
    # x 2 shards), unpack of the S=2 forward that splits all 7 blocks
    # (blocks 4-6 x 2 shards)
    def total(rows, key):
        sel = [r[key] for r in rows if r["config"] == "cosmoflow-128"
               and r["dtype"] == "fp32"]
        return None if any(v is None for v in sel) else sum(sel)

    def halo_total(name, kind, key):
        plan = spatial_plan(plan_lib, depth, cf128, 2, kind)
        return sum(2 * halo[name][(sc.shape, sc.lo, sc.hi, "fp32")][key]
                   for sc in cosmoflow.split_convs(cf128, plan, 4)
                   if name == "pack" or sc.no_interior)

    summary = []
    for name, kname, src, replaces in (
            ("conv3d", "conv3d_valid", "src/repro_torch/csrc/conv3d.cu",
             "src/repro/kernels/conv3d/kernel.py:43"),
            ("bn_act", "bn_leaky_relu", "src/repro_torch/csrc/bn_act.cu",
             "src/repro/kernels/bn_act/kernel.py:31"),
            ("pack", "pack_depth", "src/repro_torch/csrc/halo_pack.cu",
             "src/repro/kernels/halo_pack/kernel.py:26"),
            ("unpack", "unpack_depth", "src/repro_torch/csrc/halo_pack.cu",
             "src/repro/kernels/halo_pack/kernel.py:69"),
            ("ssd_scan", "ssd_scan_chunked", "src/repro_torch/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan/kernel.py:58")):
        entry = {"name": kname, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[name]}
        if name == "conv3d":  # the kernel also runs each input gradient
            entry["launches"] += launches["conv3d_dgrad"]
            entry["input_grad_launches"] = launches["conv3d_dgrad"]
            rows = train["timing"]["cosmoflow-128/fp32/b4"]["input_grad"]
            entry["input_grad"] = {key: sum(r[key] for r in rows) for key in
                                   ("ms", "library_ms", "bound_ms")}
            entry["input_grad"]["max_abs_err"] = max(
                r["max_abs_err"] for rows_ in (
                    t["input_grad"] for t in train["timing"].values())
                for r in rows_ if r["dtype"] == "fp32")
        if name == "ssd_scan":  # one call at mamba2-370m's layer shape
            row = timing["ssd_scan"]["fp32"]
            entry.update(
                max_abs_err=report["ssd_kernel"]["max_abs_err_main_fp32"],
                **{key: row[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "call_ms", "bound_executed_ms", "bound_cuda_core_ms",
                    "chunked_plain_ms")})
            entry["bf16"] = {key: timing["ssd_scan"]["bf16"][key] for key in (
                "ms", "call_ms", "bound_ms", "bound_by", "bound_executed_ms",
                "chunked_plain_ms")}
            # one call at zamba2-1.2b's layer shape; its path's launches
            zrow = timing["ssd_scan_zamba2"]
            entry["training"] = dict(
                launches=main_paths["lm_train"]["launches"]["ssd_scan"],
                launches_per_step={
                    tag: r["ssd_launches_per_step"]
                    for tag, r in lm_train["runs"].items()},
                backward=lm_train["ssd_backward"])
            # the sharded LMs (phase 13d): cp_ssd's local scans and tp's
            # whole-sequence scans, every shard's
            entry["sharded"] = dict(
                launches=main_paths["lm_sharded"]["launches"]["ssd_scan"],
                launches_per_step={
                    tag: r["ssd_launches_per_step"]
                    for tag, r in lm_sharded["runs"].items()})
            entry["zamba2-1.2b"] = dict(
                launches=main_paths["lm_families"]["launches"]["ssd_scan"],
                max_abs_err=report["ssd_kernel"]["max_abs_err_layers_fp32"][
                    "zamba2-1.2b"],
                **{key: zrow["fp32"][key] for key in (
                    "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "call_ms", "chunked_plain_ms")},
                bf16={key: zrow["bf16"][key] for key in (
                    "ms", "call_ms", "bound_ms", "bound_by")})
        elif name in ("pack", "unpack"):
            kind = "fixed" if name == "pack" else "deep"
            entry.update(
                max_abs_err=report["halo_kernels"]["max_abs_err"][name],
                **{key: halo_total(name, kind, key) for key in
                   ("ms", "plain_ms", "bound_ms", "library_ms")},
                bound_by="bytes")
            if name == "unpack":  # its adjoint, per all-blocks S=2 step
                entry["adjoint"] = {
                    key: halo_total(name, kind, key)
                    for key in ("adjoint_pack_ms", "adjoint_narrow_ms")}
            entry["unet3d-256"] = unet_halo_totals(
                halo, name, unet3d, plan_lib, depth, ucfg)
            # one launch floor per call of that forward
            entry["launch_floor_ms"] = timing["launch_floor_ms"] * sum(
                2 for sc in cosmoflow.split_convs(
                    cf128, spatial_plan(plan_lib, depth, cf128, 2, kind), 4)
                if name == "pack" or sc.no_interior)
        else:
            rows = timing[name]
            by = {r["bound_by"] for r in rows
                  if r["config"] == "cosmoflow-128" and r["dtype"] == "fp32"}
            entry.update(
                max_abs_err=report["kernels"]["worst_fp32_main"][name],
                ms=total(rows, "ms"), plain_ms=total(rows, "plain_ms"),
                bound_ms=total(rows, "bound_ms"),
                bound_by="operations" if "operations" in by else "bytes",
                library_ms=total(rows, "library_ms"))
            if name == "conv3d":  # the CUDA-core bound and bf16 beside
                entry["bound_cuda_core_ms"] = total(rows,
                                                    "bound_cuda_core_ms")
                entry["bf16"] = {
                    key: sum(r[key] for r in rows
                             if r["config"] == "cosmoflow-128"
                             and r["dtype"] == "bf16")
                    for key in ("ms", "bound_ms", "library_ms")}
                # one unet3d-256 b1 forward's 14 convs, and step 1's long K
                entry["unet3d-256"] = {
                    prec: {key: unet["conv_per_forward"][
                        f"unet3d-256/{prec}/b1"][key] for key in (
                            "ms", "plain_ms", "bound_ms", "library_ms")}
                    for prec in DTYPES}
                entry["unet3d-256"]["long_k"] = unet["long_k"]
            if name == "bn_act":  # its 14 calls in a unet3d-256 b1 forward
                entry["unet3d-256"] = {
                    key: sum(r[key] for r in unet["timing"]["bn_act"]
                             if r["dtype"] == "fp32")
                    for key in ("ms", "plain_ms", "bound_ms")}
        summary.append(entry)
    report.update(score=score, decode=decode_row, lm_families=lm_families,
                  lm_train=lm_train, lm_sharded=lm_sharded, train=train,
                  train_spatial=train_spatial, unet=unet,
                  train_remat=train_remat, train_io=train_io,
                  train_zero1=train_zero1, memory_model=memory_model,
                  plans=plans, supervise=supervise,
                  train_pipeline=train_pipeline, procmesh=procmesh)
    report.update(serve=serve, spatial=spatial, timing=timing, e2e_ms=e2e,
                  conv_vs_library=conv_vs_library,
                  lowering=lowering, profile=profiles, bounds=PEAKS_USED,
                  main_paths=main_paths,
                  seconds=time.perf_counter() - t_start)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    log("done", f"all phases ok in {report['seconds']:.0f}s")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
