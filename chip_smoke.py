#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero, and there is
no CPU fallback):

  1. build      -- compile every kernel from ``src/repro_torch/kernels/csrc``
                   with nvcc for sm_90a into ``build/repro_torch_kernels/``.
  2. paths      -- seventeen paths, each driven with the launch counts reset
                   just before it and read just after, recording the
                   shape (and the operands) of every kernel call and the
                   sampled coordinates:
       a. serial fits: a nu-SVM fit at the paper's Figure 2 size
          (n=50,000, d=512, B=1) and a hard-margin fit in block mode
          (n=20,000, d=256, B=128), through ``SaddleNuSVC.fit`` /
          ``SaddleSVC.fit``: one launch of each packed kernel per step,
          3 FWHTs per fit, a finite history that falls.
       b. distributed fits (Algorithm 4, k=20 clients on the card):
          Figure 3's hard-margin shape (n=10,000, d=256, 6,000 steps) and
          Figure 4's gisette-like nu-SVM (n=6,000, d=512, 5,000 steps),
          through ``preprocess`` and ``distributed.solve_distributed``:
          the packed kernels at S=20, 2 launches per step, 3 (HM) or 29
          (nu) tallied client reductions per step, the objective falls,
          every client holds the same w.
       c. reference step: the unpacked kernels (4 launches per step, for
          k=20 and serially) against the packed solves on the same
          coordinates, 80 steps on the Figure 3 data, 1e-5 on w, the dual
          weights and u, with the reference chunk's ms per step; and one
          block of 4 steps at B=128.
       d. above 32,768 features: two hard-margin fits on
          separable(1500, 40000), padded to d_pad = 65,536, through
          ``SaddleSVC.fit``: 300 steps at B=1 and 200 steps at B=40,000
          (more sampled rows than a packed block holds at once: two
          chunks a call); their 3 FWHTs take two device passes each (a
          row no longer fits one block's shared memory).
       e. the fit service: ``SolverService(num_slots=8, chunk_steps=64)``
          with 12 hard-margin tenants (separable(n, 256), n = 3,000,
          5,000, 8,000: buckets of 4,096 and 8,192 points), 4 nu-SVM
          tenants on Figure 4's data (bucket 8,192 x 512), one with a
          duality-gap stop and a streaming tenant (an append inside its
          rung, then one across it), budgets of 640-1,280 steps; run 1
          cancels a request mid-run, run 2 poisons one lane at its chunk
          2 instead.  Every other request is bit-equal across the runs;
          each completed one equals its solo ``saddle.solve`` on the card
          within 1e-5 (the stream's rounds the solve warm-started from
          the previous round); no chunk after a bucket's first sets up a
          new ``engine.trace_counts`` key; device memory returns to its
          level after the drain; requests per second, ms per chunk and
          step, launches per step and the sampler's host time are
          printed.
       f. real collectives: ``distributed.solve_distributed(mesh=...)``
          with one client a process.  NCCL at world size 1 in this
          process on Figure 3's data (200 steps, bit-equal to the serial
          ``saddle.solve``); then one spawn of 20 gloo ranks over CUDA
          tensors on the one card (NCCL refuses two ranks on one card):
          Figure 3 at k = 20 on path b's first 40 draws, Figure 3 (200
          steps) and Figure 4 (40 steps) at k = 4 on ranks 0-3, each
          within 1e-4 of the simulated solve with the same draws; on
          ranks 0-1 two chunks of 64 steps of an 8-lane 8,192 x 256
          serving bucket point-sharded (within 1e-5 of the unsharded
          chunk), lane-placed (bit-equal) and point-sharded after
          ``drop_slot_shard`` (batch-mates bit-equal).  Every run: 2 packed
          launches a step on every rank, the tallied collectives equal
          to ``CommModel`` / ``ServeCommModel``, the same from the
          profiler's events (``utils.comm_audit``), ms a step and the
          collectives' host time printed (each all-reduce between two
          device synchronisations, so NCCL's is timed to its end; the
          first NCCL run is not timed so, for its ms a step).  The
          packed calls here are recorded by shape as on every path, and
          rank 0 records its own and copies one step's arguments of each
          run to the host, for phase 5.
       g. the fit service over a process group:
          ``SolverService(mesh=ClientGroup)``, one process a rank, rank 0
          the front end, ``step``/``run`` collective.  On ranks 0-1 of
          path f's spawn (gloo over the one card): path e's 12
          hard-margin and 4 nu tenants lane-placed (4 whole lanes a rank)
          beside two point-sharded fits above 9,000 points (hard margin
          on separable(20000, 256), n_pad 32,768; nu on Figure 2's
          non_separable(50000, 512), n_pad 65,536: columns [r m, (r+1)
          m) a rank), budgets cut to 128-320 steps; run 1 cancels a lane
          and the point-sharded nu fit once they run, run 2 poisons a
          lane at its chunk 2 and the point-sharded hard margin at its
          chunk 1.  Every other request bit-equal across the runs; lane
          results within 1e-5 and point-sharded within 1e-4 of their
          solo solves on the card (at the point-sharded bucket);
          every rank's tallied all-reduces equal to ``ServeCommModel``
          for its point-sharded chunks and none for the lane-placed, the
          same from the profiler over one chunk a group
          (``comm_audit.audit_service``), which also holds the service's
          own calls (plan broadcasts, admission data, harvest gathers)
          to its tally; no set-up in run 2; device memory back to its
          base on both ranks; requests a second, ms a chunk, the
          service's traffic and the chunks' all-reduces in host ms a
          step, set-ups and memory printed per rank.  Each rank records
          its packed calls by shape and copies one step of each
          configuration's first chunk (rank 0 also the chunk after the
          poison) for phase 5.  In the parent, a one-rank NCCL group's
          service (one request point-sharded at k = 1) bit-equal to
          path e on four of its requests.
       h. the paper's comparisons (``repro_torch.baselines``), at the
          full sizes of the JAX package's Table 1, Figure 1, Figure 3 and
          Table 4 scripts, each timed and printed beside the card:
          h1 Table 1: separable(10000, 512) through ``save_libsvm`` /
          ``load_libsvm`` (bit-equal to the values the file states),
          preprocessed, Saddle-SVC for 2,000 steps (depth cut: Theorem
          6 gives 59,975; the JAX script's quick cap is 20,000) against
          Gilbert (20,000 iterations, tol 1e-6): Gilbert's history never
          rises, its weights sum to 1 (1e-5) and give its z (1e-4), its
          first 200 iterations replayed on the CPU (z within 1e-4).
          h2 Figure 1: non_separable(20000, 128)'s training split, QP
          nu-SVM (FISTA, 1,000 iterations; JAX 4,000 + 2,000) and
          nu-Saddle-SVC (3,000 steps; JAX 12,000): the QP's duals in the
          capped simplex, both objectives finite and below that of the
          uniform duals both start from, the QP's first 20 iterations
          replayed on the CPU (1e-5).  Every baseline is profiled (5 QP
          iterations, 50 of each other one).  h3 Figure 3: distributed
          Gilbert at k = 20 (1,500 iterations) within 1e-4 of serial
          Gilbert, its 3kd scalars an iteration beside path b's
          Saddle-DSVC; HOGWILD
          (2,000 rounds, 2kd) at training accuracy >= 0.9, its draws
          those of ``draw_schedule``, its first 200 rounds replayed on
          the CPU (1e-4).  h4 Table 4: Pegasos (4,000 steps) on
          sparse_non_separable(100000, 128) at nnz 12, 64, 115, test
          accuracy printed, the first 200 steps replayed on the CPU
          (1e-4).  h5: MDM and Gilbert on Table 1's (2000, 32) min-norm
          problem within 2e-3.
       i. the LM serving side (``repro_torch.models``, ``serve.engine``,
          ``serve.lm_service``), its models random-initialised on the card
          from seeds and freed before the next phase.  i1: gemma-7b at
          full width (28 layers, d 3,072, vocab 256,000, 8.54 B bfloat16
          parameters) in slot mode, ``LMService(num_slots=4,
          chunk_steps=8, max_len=512)``, 8 staggered requests (prompts of
          5-250 tokens, buckets 8-256, 16-64 tokens each; two up front,
          one more after each step), three runs: greedy with a running
          request cancelled, temperature 0.8, greedy with one lane
          poisoned at its chunk 2 (retried).  Every completed request
          equals its solo ``engine.generate`` on the card (same seed,
          the service's cache capacity) token for token; the batch-mates
          of the cancelled and poisoned requests are bit-equal across
          runs 1 and 3; no set-up but the temperature run's decode chunk
          after run 1; device memory back to its level after each drain.
          Then ms a chunk and a step of 4 busy lanes, and one profiled
          chunk (idle share, device launches a step).  i4: the SVM probe
          on gemma-7b's pooled logits through the port's
          ``repro_torch.examples.svm_probe_lm`` (``tokens``, ``features``,
          ``split``, ``fit_probe``; 2 x 100 sequences of 24 tokens
          from two vocabulary ranges, features ``logits.mean(1)[:,
          :128]``), ``SaddleNuSVC(alpha=0.6, num_iters=3000)`` (the
          example's 6,000 cut) on the
          card (kernels 1-3, recorded for phase 5), train and test
          accuracy, and the fit replayed on the CPU with the card's
          coordinates (w and b within 1e-4).  i2: h2o-danube-1.8b at full
          width (window 4,096) on the service's fallback path: a
          4,500-token prompt (the ring prefill's roll) and 32 greedy
          decode steps, equal to the service's solo generate, the last 8
          steps' logits within 5e-2 of max |logit| of a full forward (both
          bfloat16).  i3: gemma-7b at full width with 2 layers in float32,
          the same weights on the card and the CPU: a 16-token prefill and
          8 greedy decode steps, logits within 1e-4 of max |logit| and the
          same tokens (a differing token only where the CPU's top-2 margin
          is under that tolerance: a tie).
       j. DeepSeek-V2's MLA and MoE in the LM service, its models random-
          initialised on the card from seeds and freed before the next
          phase; no kernel is on this path (the counts must stay empty).
          j1: deepseek-v2-lite-16b at full width (27 layers, d 2,048, 16
          heads, nope 128 / rope 64 / v 128, kv-LoRA 512, 64 routed
          experts top-6 and 2 shared of 1,408, layer 0 dense at 10,944,
          vocab 102,400; 15.71 B bfloat16 parameters) in
          ``LMService(num_slots=12, chunk_steps=8, max_len=512)``: 16
          decode rows, more than one row tile.  16 staggered requests
          (prompts of 5-250 tokens, 8-20 tokens each, 212 in all: cut from
          16-48 and 496 to make room for path l; the CPU tests of
          ``tests/test_torch_lm_serve.py`` still hold lanes above one row
          tile to solo decodes; six up front, one
          more after each step), one greedy run with one lane poisoned at
          its chunk 2 and retried: every request completes equal to its
          solo ``engine.generate`` at the service's rows and cache
          capacity, token for token; no set-up but the decode chunk's at
          its first chunk; device memory back to its level after the
          drain.  Then ms a chunk and a step of 12 busy lanes, one
          profiled chunk (launches, idle share and device time a step)
          beside the weight-read bounds of a step (every expert, as the
          slot-dense expert product reads them, and one token's six).
          j2: a 24-token prompt and 8 absorbed decode steps against the
          expanded forward over the 32 tokens (one token a routing group,
          no capacity drop), bfloat16, within 5e-2 of max |logit|.  j3:
          deepseek-v2-lite-16b at full width with 2 layers (one dense,
          one MoE) in float32 on the card and the CPU, as i3.
       k. the recurrent families in the LM service (``models.ssm``), their
          models random-initialised on the card from seeds and freed
          before the next phase; no kernel is on this path (the counts
          must stay empty).  k1: recurrentgemma-2b at full width (26
          layers: 18 RG-LRU of width 2,560 and 8 local-attention MQA
          with window 2,048, d 2,560, vocab 256,000 tied; 2.89 B bfloat16
          parameters) in ``LMService(num_slots=4, chunk_steps=8)``, which
          must take the solo fallback: 6 requests (prompts of 5-250
          tokens, 16-32 tokens each), the last with a deadline and first
          to finish, each equal to a direct ``engine.generate`` token for
          token, device memory back after the drain; then a solo decode
          (B = 1 on 8 rows) timed over 16 steps and 2 steps profiled
          (launches, idle share and device time a step) beside a step's
          weight-read bound.  k2: a 2,300-token prompt past the local
          window (the ring prefill's roll, an RG-LRU scan of 2,300
          positions) and 32 greedy steps equal to the service's fallback,
          the last 8 steps' logits within 5e-2 of max |logit| of a full
          forward over 2,332 tokens (bfloat16).  k3: xlstm-125m at full
          width (12 layers alternating mLSTM and sLSTM, d 768, 4 heads,
          mLSTM inner 1,536, vocab 50,304), a 1,200-token prompt (the
          mLSTM's parallel form in query chunks of 1,024 and a padded 176,
          1,200 sequential sLSTM steps; its ms a prompt token) and 32
          steps equal to the fallback, the last 8 within the larger of
          5e-2 and twice the bfloat16 forward's own distance from the
          float32 forward of the same weights (``K_NOISE``), then its
          solo decode timed and profiled as in k1.  k4: as i3, in
          float32 on the card and the CPU, recurrentgemma-2b cut to one
          period (rglru, rglru, local_attn) and xlstm-125m at all 12
          layers.
       l. the encoder-decoder and the vision-language backbone in the LM
          service, their models random-initialised on the card from
          seeds and freed before the next phase; no kernel is on this
          path (the counts must stay empty).  l1: whisper-medium at full
          width (24 encoder and 24 decoder layers, d 1,024, 16 heads of
          64, d_ff 4,096, vocab 51,865 padded to 51,968, untied; 1.01 B
          bfloat16 parameters): the encoder's pass over 1,500 stub frames
          (a standard normal from a seed times 0.05, bfloat16) timed;
          ``engine.generate(enc_frames=)`` on a 16-token prompt, 32
          greedy steps, equal to prefill + decode against the cross
          cache, the last 8 steps' logits within the larger of 5e-2 and
          K_NOISE times the bfloat16 forward's distance from the float32
          forward (random weights give flat logits, as k3's) of a full
          forward over the same frames; two requests through
          ``LMService``, which takes the fallback and decodes against
          the zero cross cache (the JAX package's service carries no
          frames), each equal to a direct ``generate``; a solo decode
          timed (16 steps) and profiled (2) beside its read bound (the
          decoder without the cross ``wk`` / ``wv``, the LM head and the
          cross cache).  l2: qwen2-vl-7b at full width (28 layers, d
          3,584, 28 heads / 4 KV heads of 128, M-RoPE sections (16, 24,
          24), SwiGLU 18,944, vocab 152,064 untied; 7.62 B bfloat16
          parameters) in ``LMService(num_slots=4, chunk_steps=8,
          max_len=512)`` in slot mode, 6 staggered text requests each
          equal to its solo ``generate`` at the service's rows; a
          ``generate(vision_embeds=, vision_mask=)`` on a 64-token prompt
          whose middle 32 positions take patch embeddings from a seed,
          16 steps, the last 8 held to a full forward with the same
          embeddings as l1; one decode chunk of 4 lanes timed and
          profiled beside the weight-read bound.  l3: as i3, in float32
          on the card and the CPU, whisper-medium cut to 2 encoder and 2
          decoder layers over frames from a seed, with a float32 cache
          (a bfloat16 one rounds card / CPU differences of ~1e-6 to a
          bfloat16 ulp at its boundaries); and qwen2-vl-7b cut
          to 2 layers, one forward at explicit (3, 1, 48) positions with
          distinct t/h/w streams (4 text tokens, a 4 x 8 patch grid with
          patch embeddings, 12 text tokens), every position's logits
          within 1e-4 of its max |logit| and its argmax equal (but at a
          tie).
       m. training (``repro_torch.train``, the examples ``train_lm`` and
          ``train_svm_e2e``).  m1: ``train_lm --full`` at h2o-danube-1.8b's
          published widths (24 layers, d 2,560, 32 heads / 8 KV heads of
          80, SwiGLU 6,912, vocab 32,000 untied; 1.831 B bfloat16
          parameters, float32 AdamW state, every block rematerialised),
          B = 4, S = 1,024 from ``TokenPipeline(seed=0)``, 8 steps at the
          JAX script's settings (lr 1e-3, warm-up 20): every loss and grad
          norm finite, the last loss below the first, one eval step; ms a
          step (median of steps 2-8), tokens a second, peak memory against
          the 29.3 GB of parameters, grads and AdamW state, a 2-step
          profiled window (device launches, idle share, device ms) beside
          the step's bound (8 N tokens bf16 FLOPs at the dense bf16 peak
          plus the float32 score products at the float32 peak).  m2: a
          float32 train step of reduced h2o-danube-1.8b (S = 80, past its
          window of 64), deepseek-v2-lite-16b (MLA, MoE, a non-zero aux)
          and xlstm-125m on the card and the CPU from the same weights and
          batches: loss, ce, aux and grad norm within 1e-5 relative, every
          grad within 1e-4 of its leaf's max |g|, the parameters after
          step 1 within 1e-6 where |g| is above 1e-3 of the leaf's max
          (Adam's first step moves a weight by about lr whatever its
          grad's size), the losses of 3 steps within 1e-4 relative.  m3:
          ``train_svm_e2e``'s default nu fit (non_separable(20000, 256),
          10 % held out) on the card, --iters cut from 20,000 to 2,000:
          the objective falls and never rises above its first record, the
          checkpoint (in a temporary directory) restores w_ and b_ bit for
          bit; its kernel calls (rows 1-3) are recorded for phase 5.
       n. the analysis gate and the examples.  n1: the lint
          (``repro_torch.analysis.lint``) of its seven serial targets
          (the packed chunk, the slot chunk, the whole-solve loop with
          and without the gap check, the warm-start state, reduced
          gemma-7b's bucketed prefill and decode chunk) with the CUDA
          kernels: every chunk under ``set_sync_debug_mode("error")``,
          the solve loop's read-backs pinned by count, no float64, no
          collective, the same work every step with exactly 2 packed
          launches a step by the tally, no second copy of the state by
          ``memory_allocated``; zero unsuppressed findings; one profiled
          packed chunk of 8 steps shows 8 device launches of each packed
          kernel.  The lint's k = 8 targets run on the CPU only.  n3:
          the examples ``quickstart`` (separable(2000, 64),
          non_separable(3000, 64)) and ``distributed_svm``
          (separable(4000, 128), k = 20) at their data sizes, iterations
          cut (N_QUICKSTART, N_DISTRIBUTED): each nu objective falls and
          never rises above its first record, test accuracies printed,
          the Saddle-SVC margin beside Gilbert's distance, comm in k d
          units equal to ``CommModel``'s and the tallied client
          reductions equal to its multiset; their kernel calls (rows
          1-3) recorded for phase 5.  n2 (after the counts are read):
          the launch-plan audit (``analysis.kernel_audit``, zero
          findings), ``MAX_SMEM`` equal to the card's opt-in shared
          memory a block, each kernel's compiled static shared memory
          equal to its plan's, every audited plan's grid and dynamic
          shared memory equal to what the C launchers derive for the same
          arguments (``launch_geometry`` / ``fwht_geometry``), and each
          kernel at one audited shape (a
          packed rung, K = 20 n = 251 B = 128, the FWHT at d = 65,536 in
          two passes) with its outputs and the workspace's scratch
          filled with NaN first: every element written, within phase 5's
          tolerances of the plain version.
       o. the launch family (``repro_torch.launch``).  o1: one rank of
          each of the dry-run's solver and serving entries
          (``launch.dryrun.run_one_saddle`` / ``run_one_saddle_serve``)
          at both production meshes, on a fake group of k = 256 or 512
          ranks with its shard on the card: Saddle-DSVC's client of 1M
          points in d = 256 (4,096 / 2,048 points, b = 128 / 1), the
          lanes entry's own 2 / 1 lanes (no collective) and a model
          column's 2 lanes of 65,536 / 32,768 points (b = 128); each
          entry's collectives a step (and, for the points placement, a
          chunk) equal to ``CommModel`` / ``ServeCommModel`` (each fake
          group this process's default group while its entry runs); its
          packed calls recorded, one step of each entry copied, for
          phase 5.  o2: ``launch.train`` on a
          reduced h2o-danube-1.8b, 2 steps, as a user calls it; the
          same launcher's trainer again on the card (the same losses,
          bit for bit) and on the CPU from the card's starting weights
          (losses within 1e-4, relative) (no kernel).
       p. sharded training (``repro_torch.models.sharding``), inside
          path f's spawn on an 8-rank ``sub_group``: ranks 0-7 as
          ``launch.mesh.make_test_mesh`` lays 8 out, (data 2, model 4),
          gloo's collectives on CUDA tensors.  p1: h2o-danube-1.8b at its
          published widths through ``train_lm``'s ``Trainer(mesh=)`` with
          path m1's settings, B = 4, S = 1,024, 2 steps: each rank's
          bytes of the parameters and of the master / m / v equal to the
          dry-run's count for that layout exactly, its ms a step and
          peak memory, the collectives of step 1 by kind (counted by
          ``dispatch_trace``), and the two losses within 1e-2 of path
          m1's first two (unsharded, the same seed-0 weights and
          batches).  p2: ``launch.train``'s trainer over the same mesh
          on reduced h2o-danube-1.8b and gemma-7b, 2 float32 steps each,
          replayed on the CPU unsharded from the card's starting weights:
          losses within 1e-5 (relative), the gathered final parameters
          within 1e-5 where step 1's grad is above 1e-3 of its leaf's
          max (no kernel).
       q. sharded training of the DeepSeek-V2 family (MLA's heads and the
          MoE's router logits and experts over ``model``, the routing
          groups the whole batch's), after path p on its mesh.  q1:
          deepseek-v2-lite-16b at its published widths, its depth cut
          from 27 layers to 3 (1 dense, 2 MoE), B = 4, S = 1,024, 2 steps:
          each rank's bytes equal to the dry-run's count, its expert
          block (16, 1,024, 1,408), ms a step, peak memory, step 1's
          collectives by kind, and the two losses within 1e-2 of the same
          cut model trained unsharded on the card here (the same seed-0
          weights and batches).  q2: ``launch.train``'s trainer on
          reduced deepseek-v2-lite-16b and deepseek-v2-236b, 2 float32
          steps each, replayed on the CPU as p2 (236b's bf16 moments
          widen its parameters' tolerance by Q_BF16_SLACK; no kernel).
  3. serial vs distributed -- each distributed fit refit serially on the
                   coordinates it drew: w within 1e-4.
  4. profile    -- short windows of the serial nu-SVM solve, of both
                   distributed fits and of the service (4 chunks of its
                   8,192 x 256 bucket) under torch.profiler: the device's
                   busy share and kernel time by name.
  5. kernels    -- each kernel against its plain PyTorch version on the
                   card, at every shape the paths gave it (on the paths'
                   own data and step scalars, with fresh duals and u), and
                   at the JAX kernel tests' shapes (ragged B = 3 and 130
                   too), a synthetic packed layout and FWHT rows of d =
                   1,024 to 131,072, and the packed kernels at b = 32,769
                   and 65,536 on path d's operands and on path e's
                   recorded calls (8 lanes with their own blocks and
                   scalars, free lanes, a NaN lane after the poison: held
                   on the live lanes, whose bits must equal a call on
                   them alone); path f's too: its references' and NCCL
                   run's shapes here, and rank 0's (one client of k = 20
                   and of k = 4 on Figures 3 and 4, the 8 lanes' point
                   shards, its 4 placed lanes), on their operands with
                   fresh duals and on each run's copied step; path g's:
                   the NCCL service's calls here, and both ranks' lane
                   and point shards (4 lanes of 4,096 / 8,192 x 256 and
                   8,192 x 512; 2 lanes of 16,384 x 256 and 32,768 x
                   512); path h's (S = 1, b = 1 at Table 1's d = 512 and
                   Figure 1's d = 128; the FWHT at d = 512, 128, 256 and
                   32); path i's (S = 1, b = 1 at the probe's d = 128, and
                   its FWHTs); its time, its device-only time (one
                   profiler session per group), the plain version's, a
                   one-call PyTorch yardstick (the FWHT's ``x @ H`` with
                   H built from Kronecker factors, or the error that
                   refused its allocation) and its bound, and the
                   device launches of one call (exactly 1 for a packed
                   wrapper and the unpacked dot and MWU, 1 or 2 passes
                   for the FWHT as its plan says).  The FWHT also prints its
                   variant, whether it equals the plain version bit for
                   bit, and a copy of the same bytes (``out.copy_(x)``)
                   under the same events.
                   The unpacked MWU is also checked normalized, and its
                   (m, s) against the plain merge of the per-block
                   partials of its own log_new.  Planted faults must
                   break the tolerance: at the path shapes for the
                   unpacked kernels, and at K = 20, n = 2,048, B = 128
                   for the MWU, whose clients take several blocks
                   (momentum or u dropped, a client's last point left
                   out, the last block left out of the merge, log_new
                   left unnormalized), and at every shape for the packed
                   ones (theta = 0, the last row group left out of delta,
                   u = 0, the last tile with a real point left out of the
                   merged (m, s)), whose (m, s) must also match the plain
                   merge of the per-tile partials of their own log_new.
                   Every wrapper's host time but the FWHT's is split into
                   validation, allocation, the ctypes call and the rest
                   (1,000 calls each).  The packed kernels alternate with
                   the unpacked ones, which share their ticket counters,
                   for three rounds: the same bits each round and every
                   ticket counter back at 0.  An out-of-range row index
                   gives NaN, not a fault.
  6. card vs CPU -- a serial fit (n=4,000, d=128, 2,000 iterations) on the
                   card and on the CPU with the same signs and schedule;
                   the serial fits of paths a and d (path a's nu fit over
                   its first 500 of 8,000 steps, a cut of depth, and
                   the B=40,000 one, whose rounding a block of most of d
                   amplifies, over its first 8, each run again on the
                   card over those steps, w, the history and, for the nu
                   fit, b held), 1,000
                   steps of the Figure 4 distributed fit and one lane of
                   path e replayed on the CPU with the coordinates the
                   card sampled.

A line before the last gives the script's seconds in all, paths k's, l's,
m's, n's and o's and the nu fit's CPU replay's; then the card's name and power
limit.  The
next-to-last line of standard output is a JSON object listing every
kernel at every path shape with its launches, error, times and bound;
the last line is ``{"ok": true, "device": {...}}``.  It imports nothing of
JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = "src/repro_torch/kernels/csrc"
KERNELS = ("fwht", "momentum_dot_packed", "mwu_update_packed",
           "momentum_dot", "mwu_update")
PACKED = ("momentum_dot_packed", "mwu_update_packed")
UNPACKED = ("momentum_dot", "mwu_update")
REPLACES = {
    "fwht": "src/repro/kernels/fwht.py:96",
    "momentum_dot_packed": "src/repro/kernels/saddle_update.py:359",
    "mwu_update_packed": "src/repro/kernels/saddle_update.py:432",
    "momentum_dot": "src/repro/kernels/saddle_update.py:233",
    "mwu_update": "src/repro/kernels/saddle_update.py:287",
}
SOURCES = {"fwht": f"{CSRC}/fwht.cu",
           **{name: f"{CSRC}/saddle_update.cu" for name in KERNELS[1:]}}
# Card vs CPU: a fit's w_ and b_ agree to 1e-4, its objective history to
# 1e-3 relative.  Serial vs distributed: w to 1e-4, every client's w to
# 1e-6 of the first's (tests/test_distributed.py); reference vs packed:
# 1e-5 (tests/test_engine.py).
FIT_ATOL, HIST_RTOL = 1e-4, 1e-3
SESSIONS = 3          # profiler sessions a group of kernel jobs may take
CLIENT_ATOL, REF_ATOL = 1e-6, 1e-5


# The H100 SXM's data-sheet peaks, bound by main() from
# repro_torch.utils.roofline once the checkout's src is on the path: HBM
# bytes/s, float32 FLOP/s outside the tensor cores, dense bf16 FLOP/s.
HBM_BW = F32_FLOPS = PEAK_FLOPS = None


class PhaseError(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing
class Timer:
    """Median time of a call on the card with CUDA events, warm, with the
    50 MB L2 flushed before every repeat (the solver's x_t is larger than
    L2, so a step finds its rows cold).  The flush is queued before the
    first event, so the events hide the wrapper's host time as long as it
    is shorter than the flush: 512 MiB, ~0.17 ms on an H100, above every
    wrapper's host time (0.03-0.08 ms, ``host_split``)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.float32,
                                 device="cuda")   # 512 MiB

    def __call__(self, fn, reps: int = 15, warm: int = 3) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device_ms(self, jobs, reps: int = 20) -> list[tuple]:
        """Mean device time of one launch of each job's CUDA kernel, from
        ONE torch.profiler session over ``reps`` calls of every job
        ``(fn, kernel)`` in turn: the kernel alone, without the host's
        launch cost and the wrapper's other ops.  Each job runs inside a
        labelled range, which the profiler also records on the device's
        clock; the launches of the kernel whose name holds ``kernel``
        that start inside the device range are that job's.  (A second
        session in one process has been seen to offset the device clock
        from the host's by milliseconds, and to lose the device events of
        its first milliseconds: so ranges are read on the device side, and
        the session first spends ~50 ms zeroing the flush buffer.)  The
        mean is over the launches recorded, returned with their count; a
        job with fewer than half of ``reps`` fails, after up to SESSIONS
        sessions (in one run of the whole script a session recorded 8 of
        a job's 20 launches: the profiler drops or misplaces device events
        at times, and a fresh session measures again).  Third in each
        tuple: the device launches of one call of the job's function
        (kernels, copies, fills), read from the same session."""
        for fn, _ in jobs:
            fn()
        for attempt in range(1, SESSIONS + 1):
            found = self._session(jobs, reps)
            short = [(i, len(us)) for i, (us, _) in enumerate(found)
                     if 2 * len(us) < reps]
            if not short:
                break
            print(f"  profiler session {attempt} of {SESSIONS}: too few "
                  f"launches recorded for jobs {short} (want {reps} "
                  "each); measuring the group again")
        out = []
        for i, ((us, inside), (_, kernel)) in enumerate(zip(found, jobs)):
            require(2 * len(us) >= reps, f"profiler: {len(us)} launches of "
                    f"{kernel} recorded for job {i}, want {reps}")
            # every device launch of a call but the flush's one fill
            per_call = (inside - reps) / reps
            out.append((statistics.fmean(us) / 1e3, len(us), per_call))
        return out

    def _session(self, jobs, reps: int) -> list[tuple]:
        """One profiler session over the jobs: for each, the device times
        (us) of its kernel's launches inside its range, and the count of
        all device launches inside it."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(300):
                self.flush.zero_()
            torch.cuda.synchronize()
            for i, (fn, _) in enumerate(jobs):
                with record_function(f"chip_smoke job {i}"):
                    for _ in range(reps):
                        self.flush.zero_()
                        fn()
                    torch.cuda.synchronize()
        events = [ev for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA]
        ranges = {ev.name: ev.time_range for ev in events
                  if ev.name.startswith("chip_smoke job ")}
        launches = [(ev.time_range.start, ev.name,
                     ev.time_range.elapsed_us()) for ev in events
                    if not ev.name.startswith("chip_smoke job ")]
        found = []
        for i, (_, kernel) in enumerate(jobs):
            span = ranges.get(f"chip_smoke job {i}")
            require(span is not None, f"profiler: no device range for job "
                    f"{i} ({kernel})")
            inside = [(name, t) for start, name, t in launches
                      if span.start <= start <= span.end]
            found.append(([t for name, t in inside if kernel in name],
                          len(inside)))
        return found


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def entry(name, label, err, ms, plain_ms, library_ms, nbytes, ops):
    b_ms, b_by = bound_ms(nbytes, ops)
    return dict(name=label, route="cuda", source=SOURCES[name],
                replaces=REPLACES[name], launches=None, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def report(timer, jobs) -> list[dict]:
    """Print each checked kernel's entry with its device-only time per
    call, all from one profiler session; ``jobs`` are (entry, fn, kernel
    name, device launches one call must make, or None where the wrapper
    runs torch ops beside its kernel)."""
    dev = timer.device_ms([(fn, kernel) for _, fn, kernel, _ in jobs])
    for (e, _, _, want), (dev_ms, n, per_call) in zip(jobs, dev):
        lib = "null" if e["library_ms"] is None else f"{e['library_ms']:.4f}"
        print(f"  {e['name']}: err {e['max_abs_err']:.3e}  kernel "
              f"{e['ms']:.4f} ms (device only {dev_ms * (want or 1):.4f} ms "
              f"a call, over {n} launches, {per_call:.2f} device launches "
              f"a call)  plain {e['plain_ms']:.4f} ms  library {lib} ms  "
              f"bound {e['bound_ms']:.4f} ms ({e['bound_by']})  launches "
              f"{e['launches']}")
        if want is not None:
            require(per_call == want, f"{e['name']}: {per_call} device "
                    f"launches a call, want {want}")
    return [e for e, _, _, _ in jobs]


# ---------------------------------------------------------------- phase 2
class PathRecorder:
    """Host-side bookkeeping of one path: the shape of every kernel call,
    the packed operands (x_t, sign) of each packed shape, the arguments of
    the first unpacked call at each shape, and the coordinate block of
    every packed step.  It wraps the entry points of
    ``repro_torch.kernels.ops`` that the solver calls; the wrappers
    underneath still count their own launches."""

    def __init__(self, name: str, keep: bool = True,
                 on_device: bool = False):
        self.name = name
        self.keep = keep           # keep operands and blocks (device refs)
        self.on_device = on_device  # capture to device copies (host_copy)
        self.calls = Counter()     # (kernel, shape) -> calls
        self.operands = {}         # (S, d, n_pad, b) -> (x_t, sign)
        self.unpacked = {}         # (kernel, shape) -> first call's args
        self.blocks = []           # idx (S, b) of every packed step
        self.armed = None          # (label, packed steps still to skip)
        self.captured = []         # {label, kernel: host copy of args}

    def arm(self, label: str, skip: int = 1) -> None:
        """Copy to the host the arguments of the packed step ``skip``
        steps on from the next one (the momentum dot's and the MWU's)."""
        self.armed = (label, skip)

    def _capture(self, name, args) -> None:
        host = self.captured[-1].setdefault("host", {})
        self.captured[-1][name] = tuple(
            host.setdefault(a.data_ptr(),
                            a.clone() if self.on_device else a.cpu())
            if hasattr(a, "data_ptr") else a for a in args)

    def host_copy(self) -> dict:
        """What the parent needs to hold this recorder's calls (from a
        spawned rank, whose results travel pickled): the calls by shape
        and the captures as numpy arrays, each tensor copied once."""
        memo = {}
        return dict(calls=dict(self.calls), captured=[
            {key: tuple(memo.setdefault(id(a), a.cpu().numpy())
                        if hasattr(a, "cpu") else a for a in val)
             if key in PACKED else val for key, val in cap.items()}
            for cap in self.captured])

    @classmethod
    def from_host_copy(cls, name: str, copy: dict,
                       operands: bool = True) -> "PathRecorder":
        """A rank's recorder in the parent: its calls and captures (host
        tensors again), and, with ``operands``, each captured shape's
        (x_t, sign) on the card as its operands (for the fresh-dual
        check, which needs both classes in every row: not so on a
        service's point shards and free lanes)."""
        import numpy as np
        import torch

        rec = cls(name, keep=False)
        rec.calls = Counter(copy["calls"])
        memo = {}
        rec.captured = [
            {key: tuple(memo.setdefault(id(a), torch.from_numpy(a))
                        if isinstance(a, np.ndarray) else a for a in val)
             if key in PACKED else val for key, val in cap.items()}
            for cap in copy["captured"]]
        dev = {}
        for cap in rec.captured if operands else ():
            x_t, *_, sign, _theta = cap["momentum_dot_packed"]
            rec.operands.setdefault(cap["shape"], tuple(
                dev.setdefault(id(a), a.cuda()) for a in (x_t, sign)))
        return rec

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.saved = {name: getattr(ops, name) for name in KERNELS}

        def fwht(x, **kw):
            n = 1 if x.ndim == 1 else x.shape[0]
            self.calls["fwht", (n, x.shape[-1])] += 1
            return self.saved["fwht"](x, **kw)

        def momentum_dot_packed(x_t, idx, *args):
            shape = (*x_t.shape, idx.shape[1])
            self.calls["momentum_dot_packed", shape] += 1
            if self.keep:
                self.operands.setdefault(shape, (x_t, args[2]))
                self.blocks.append(idx)
            if self.armed is not None:
                label, skip = self.armed
                self.armed = (label, skip - 1) if skip else None
                if not skip:
                    self.captured.append(dict(label=label, shape=shape))
                    self._capture("momentum_dot_packed", (x_t, idx) + args)
            return self.saved["momentum_dot_packed"](x_t, idx, *args)

        def mwu_update_packed(x_t, idx, *args):
            self.calls["mwu_update_packed", (*x_t.shape, idx.shape[1])] += 1
            last = self.captured[-1] if self.captured else {}
            if "momentum_dot_packed" in last and \
                    "mwu_update_packed" not in last:
                self._capture("mwu_update_packed", (x_t, idx) + args)
                del last["host"]
            return self.saved["mwu_update_packed"](x_t, idx, *args)

        def unpacked(name):
            def call(cols, *args, **kw):
                key = (name, tuple(cols.shape))
                self.calls[key] += 1
                self.unpacked.setdefault(key, (cols, *args))
                return self.saved[name](cols, *args, **kw)
            return call

        for name, fn in (("fwht", fwht),
                         ("momentum_dot_packed", momentum_dot_packed),
                         ("mwu_update_packed", mwu_update_packed),
                         ("momentum_dot", unpacked("momentum_dot")),
                         ("mwu_update", unpacked("mwu_update"))):
            setattr(ops, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)

    def take_schedule(self):
        """The (steps, b) coordinate schedule of the packed fit just run
        (every client's row is the server's one draw)."""
        import torch
        sched = torch.stack(self.blocks)[:, 0, :].cpu().numpy()
        self.blocks = []
        return sched

    def check_counts(self, counts: dict, kernels) -> None:
        """Every kernel of the path was launched, and each launch was a
        call this recorder saw."""
        for name in kernels:
            require(counts.get(name, 0) > 0, f"{self.name}: {name} was "
                    "never launched")
        for name in KERNELS:
            seen = sum(c for (k, _), c in self.calls.items() if k == name)
            require(seen == counts.get(name, 0), f"{self.name}: {name}: "
                    f"{counts.get(name, 0)} launches counted, {seen} calls "
                    "recorded")


FITS = (
    # label, estimator, constructor arguments, data
    ("nu-SVM n=50000 d=512 B=1", "SaddleNuSVC",
     dict(alpha=0.85, eps=1e-3, beta=0.1, num_iters=8000,
          record_every=2000),
     ("non_separable", (50_000, 512), dict(beta2=0.2, seed=50_000))),
    ("hard-margin n=20000 d=256 B=128", "SaddleSVC",
     dict(eps=1e-3, beta=0.1, block_size=128, record_every=50),
     ("separable", (20_000, 256), dict(seed=256))),
)


def make_fit(spec, device, ds=None):
    """(estimator, data) of a fit spec; ``ds`` reuses data already made."""
    from repro_torch.core import svm
    from repro_torch.data import synthetic

    _label, cls, kw, (gen, args, gkw) = spec
    return (getattr(svm, cls)(device=device, **kw),
            ds if ds is not None else getattr(synthetic, gen)(*args, **gkw))


def rises(objs) -> list[bool]:
    return [b >= a for a, b in zip(objs, objs[1:])]


def run_fit(torch, label, clf, ds, steps_want, falls: bool = True):
    from repro_torch.kernels import ops

    before = Counter(ops.launch_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clf.fit(ds.x, ds.y)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = Counter(ops.launch_counts) - before
    steps = clf.history_[-1][0]
    objs = [o for _, o in clf.history_]
    acc = clf.score(ds.x, ds.y)
    print(f"{label}: {secs:.3f} s fit, {secs / steps * 1e3:.4f} ms/step "
          f"over {steps} steps, train accuracy {acc:.4f}, margin "
          f"{clf.margin_:.6g}")
    print(f"  history {clf.history_}")
    print(f"  launches {dict(counts)}")
    require(steps == steps_want, f"{label}: ran {steps} steps, want "
            f"{steps_want}")
    require(counts["momentum_dot_packed"] == steps
            and counts["mwu_update_packed"] == steps,
            f"{label}: want one launch of each packed kernel per step")
    require(counts["fwht"] == 3,
            f"{label}: want 3 fwht launches (2 preprocessing, 1 recovery)")
    require(all(math.isfinite(o) for o in objs), f"{label}: non-finite")
    # The dual objective of this primal-dual method falls overall but is
    # not monotone once near its floor, so the check is that it falls from
    # the first chunk to the last and never rises above the first; phase 5
    # replays the fit on the CPU's plain path and must find the same
    # history.  ``falls=False``: a fit whose block is most of d, where
    # the paper's step sizes (set for one coordinate a step) do not
    # settle in either package; its check is that replay alone.
    print(f"  objective rose at {sum(rises(objs))} of {len(objs) - 1} "
          f"boundaries")
    require(not falls or (objs[-1] < objs[0] and max(objs) <= objs[0]),
            f"{label}: objective does not fall")
    require(all(math.isfinite(v) for v in clf.w_) and math.isfinite(clf.b_),
            f"{label}: non-finite hyperplane")


def main_path(torch, rec: PathRecorder):
    """Path a: both serial fits, with the launch counts reset just before
    and read just after.  Returns [(spec, fitted estimator, data,
    schedule)]."""
    from repro_torch.core import saddle
    from repro_torch.kernels import ops

    fits = [(spec,) + make_fit(spec, "cuda") for spec in FITS]
    ops.launch_counts.clear()
    done = []
    with rec:
        for spec, clf, ds in fits:
            steps = saddle.resolve_num_iters(
                clf.num_iters, ds.x.shape[1], clf.eps, clf.beta, len(ds.y),
                clf.block_size)
            run_fit(torch, spec[0], clf, ds, steps)
            done.append((spec, clf, ds, rec.take_schedule()))
    counts = dict(ops.launch_counts)
    print(f"path a launches {counts}")
    rec.check_counts(counts, ("fwht",) + PACKED)
    return done


DIST_FITS = (
    # label, data, solver arguments, alpha (nu = 1/(alpha min(n1, n2)))
    ("Figure 3 hard margin k=20 n=10000 d=256",
     ("separable", (10_000, 256), dict(seed=0)),
     dict(k=20, eps=1e-3, beta=0.1, num_iters=6000, record_every=1000),
     None),
    ("Figure 4 nu-SVM k=20 n=6000 d=512",
     ("non_separable", (6000, 512), dict(beta2=0.25, seed=512)),
     dict(k=20, eps=1e-3, beta=0.1, num_iters=5000, record_every=1000),
     0.85),
)


def dist_problem(spec):
    """The two classes and nu of a distributed fit, as
    benchmarks/fig3_dist_hard_margin.py and fig4_dist_nusvm.py build
    them."""
    from repro_torch.core.svm import split_classes
    from repro_torch.data import synthetic

    _label, (gen, args, gkw), _kw, alpha = spec
    ds = getattr(synthetic, gen)(*args, **gkw)
    xp, xm = split_classes(ds.x, ds.y)
    nu = 0.0 if alpha is None else 1.0 / (alpha * min(len(xp), len(xm)))
    return xp, xm, nu


def expected_collectives(res, steps: int, d: int):
    """The client reductions a B = 1 distributed solve must tally: the
    model's per-iteration multiset for every step, and one (d,) sum per
    chunk for the objective."""
    expect = Counter({key: n * steps for key, n in
                      res.comm.collective_multiset().items()})
    expect["all-reduce", "add", d] += len(res.history)
    return expect


def run_dist_fit(torch, spec):
    """One distributed fit through preprocess, solve_distributed and the
    recovery of w, checked; returns its record."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import engine
    from repro_torch.core import preprocess as pp
    from repro_torch.kernels import ops

    label, _data, kw, _alpha = spec
    xp, xm, nu = dist_problem(spec)
    launches = Counter(ops.launch_counts)
    colls = Counter(engine.collective_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre = pp.preprocess(xp, xm, generator=torch.Generator().manual_seed(0),
                        device="cuda")
    res = dist.solve_distributed(pre.xp, pre.xm, nu=nu, device="cuda", **kw)
    w = pp.recover_direction(res.state.w[0], pre)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = Counter(ops.launch_counts) - launches
    colls = Counter(engine.collective_counts) - colls
    steps = res.history[-1][0]
    objs = [o for *_, o in res.history]
    d = pre.xp.shape[1]
    per_step = res.comm.collectives_per_iteration()
    client_spread = (res.state.w - res.state.w[0]).abs().max().item()
    print(f"{label}: {secs:.3f} s fit, {secs / steps * 1e3:.4f} ms/step "
          f"over {steps} steps, k={kw['k']}, nu={nu:.6g}, "
          f"{res.scalars_sent:.0f} scalars sent ({per_step} collectives "
          f"per step)")
    print(f"  history {[(m, o) for m, _, o in res.history]}")
    print(f"  launches {dict(launches)}")
    print(f"  client reductions {dict(colls)}")
    require(steps == kw["num_iters"], f"{label}: ran {steps} steps")
    require(all(launches[k] == steps for k in PACKED)
            and not any(launches[k] for k in UNPACKED),
            f"{label}: want one launch of each packed kernel per step")
    require(launches["fwht"] == 3,
            f"{label}: want 3 fwht launches (2 preprocessing, 1 recovery)")
    require(per_step == (29 if nu > 0 else 3),
            f"{label}: the model counts {per_step} collectives per step")
    require(colls == expected_collectives(res, steps, d),
            f"{label}: tallied client reductions differ from the model")
    require(all(math.isfinite(o) for o in objs), f"{label}: non-finite")
    require(objs[-1] < objs[0], f"{label}: objective does not fall")
    require(torch.isfinite(w).all().item(), f"{label}: non-finite w")
    print(f"  every client's w within {client_spread:.3e} of client 0's "
          f"(tol {CLIENT_ATOL})")
    require(client_spread <= CLIENT_ATOL, f"{label}: clients' w differ")
    return dict(spec=spec, pre=pre, nu=nu, res=res, secs=secs)


def dist_path(torch, rec: PathRecorder):
    """Path b: both distributed fits, counts reset just before and read
    just after.  Returns their records, each with its schedule."""
    from repro_torch.kernels import ops

    ops.launch_counts.clear()
    done = []
    with rec:
        for spec in DIST_FITS:
            fit = run_dist_fit(torch, spec)
            fit["sched"] = rec.take_schedule()
            done.append(fit)
    counts = dict(ops.launch_counts)
    print(f"path b launches {counts}")
    rec.check_counts(counts, ("fwht",) + PACKED)
    return done


def max_state_diff(a, b) -> dict:
    """Largest differences of two per-class states: w, u, and the dual
    weights exp(log)."""
    import torch
    return {
        "w": (a.w - b.w).abs().max().item(),
        "weights": max((torch.exp(x) - torch.exp(y)).abs().max().item()
                       for x, y in ((a.log_eta, b.log_eta),
                                    (a.log_xi, b.log_xi))),
        "u": max((x - y).abs().max().item()
                 for x, y in ((a.u_p, b.u_p), (a.u_m, b.u_m))),
    }


def reference_path(torch, rec: PathRecorder, fig3):
    """Path c: the unpacked reference step against the packed solves on
    the Figure 3 data and coordinates, k=20 and serially, 80 steps; then
    4 steps at B=128.  4 unpacked launches per step, 2 packed."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import engine, saddle
    from repro_torch.kernels import ops

    pre, sched, k = fig3["pre"], fig3["sched"], fig3["spec"][2]["k"]
    n1, d = pre.xp.shape
    n2 = pre.xm.shape[0]
    iters = 80
    params = saddle.make_params(n1 + n2, d, 1e-3, 0.1)
    host = [t.cpu().numpy() for t in (pre.xp, pre.xm)]
    xp_sh, mask_p = dist.shard_points(host[0], k)
    xm_sh, mask_m = dist.shard_points(host[1], k)
    xps = torch.as_tensor(xp_sh, device="cuda")
    xms = torch.as_tensor(xm_sh, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(128)
    idx128 = engine.draw_blocks(g, d, 128, 4, torch.device("cuda"))
    params128 = saddle.make_params(n1 + n2, d, 1e-3, 0.1, block_size=128)

    def counted(fn, label=None, steps=None):
        before = Counter(ops.launch_counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        if label is not None:
            print(f"  {label}: {(time.perf_counter() - t0) / steps * 1e3:.4f}"
                  f" ms/step over {steps} steps")
        return out, Counter(ops.launch_counts) - before

    def compare(label, got, want, steps, unpacked):
        diff = max_state_diff(got, want)
        print(f"  {label}: {diff} (tol {REF_ATOL}); reference launches "
              f"{dict(unpacked)}")
        require(max(diff.values()) <= REF_ATOL, f"{label}: differ")
        require(unpacked == Counter({"momentum_dot": 2 * steps,
                                     "mwu_update": 2 * steps}),
                f"{label}: want 4 unpacked launches per step")

    def packed_launches(label, counts, steps):
        require(counts == Counter({"momentum_dot_packed": steps,
                                   "mwu_update_packed": steps}),
                f"{label}: want 2 packed launches per step, got "
                f"{dict(counts)}")

    ops.launch_counts.clear()
    t0 = time.perf_counter()
    with rec:
        sched_t = torch.as_tensor(sched[:iters], device="cuda")
        (ref, _), c_ref = counted(lambda: dist.run_chunk_sim(
            dist.init_sharded_state(n1, n2, d, mask_p, mask_m,
                                    device="cuda"),
            xps, xms, iters, params=params, idx=sched_t),
            f"reference chunk, k={k}", iters)
        pk, c_pk = counted(lambda: dist.solve_distributed(
            pre.xp, pre.xm, k=k, num_iters=iters,
            idx_schedule=sched[:iters], device="cuda"))
        packed_launches("packed k=20", c_pk, iters)
        compare(f"reference vs packed, k={k}, {iters} steps", ref,
                pk.state, iters, c_ref)

        (sref, _), c_sref = counted(lambda: engine.run_chunk(
            saddle.init_state(n1, n2, d, pre.xp), pre.xp, pre.xm,
            iters, params=params, idx=sched_t), "reference chunk, serial",
            iters)
        spk, c_spk = counted(lambda: saddle.solve(
            pre.xp, pre.xm, num_iters=iters, idx_schedule=sched[:iters],
            device="cuda"))
        packed_launches("packed serial", c_spk, iters)
        compare(f"reference vs packed, serial, {iters} steps", sref,
                spk.state, iters, c_sref)

        (ref128, _), c_ref128 = counted(lambda: dist.run_chunk_sim(
            dist.init_sharded_state(n1, n2, d, mask_p, mask_m,
                                    device="cuda"),
            xps, xms, 4, params=params128, idx=idx128))
        pk128, c_pk128 = counted(lambda: dist.solve_distributed(
            pre.xp, pre.xm, k=k, num_iters=4 * 128, block_size=128,
            idx_schedule=idx128.cpu().numpy(), device="cuda"))
        packed_launches("packed k=20 B=128", c_pk128, 4)
        compare(f"reference vs packed, k={k}, B=128, 4 steps", ref128,
                pk128.state, 4, c_ref128)
    rec.blocks = []
    counts = dict(ops.launch_counts)
    print(f"path c: {time.perf_counter() - t0:.2f} s, launches {counts}")
    rec.check_counts(counts, UNPACKED + PACKED)


# above 32,768 features: d = 40,000 pads to d_pad = 65,536, where a row
# no longer fits one block's shared memory and the FWHT takes two passes;
# n = 1,500 keeps x_t (65,536 x 1,536 floats) at 403 MB.  The second fit
# samples B = 40,000 rows a step, more than a packed block holds in
# shared memory at once (CHUNK_ROWS = 32,768), so both packed kernels
# walk them in two chunks; num_iters counts coordinates (200 steps).  With
# a block of 61 % of the coordinates the paper's step sizes do not settle
# (the JAX package's SaddleSVC on separable(300, 4000) at B = 2,500 of
# 4,096 rises too), so this fit is held to its CPU replay, not to a
# falling objective.
WIDE_DATA = ("separable", (1500, 40_000), dict(seed=40_000))
WIDE_FITS = (
    ("hard-margin n=1500 d=40000 (d_pad=65536) B=1", "SaddleSVC",
     dict(eps=1e-3, beta=0.1, num_iters=300, record_every=100), WIDE_DATA),
    ("hard-margin n=1500 d=40000 (d_pad=65536) B=40000", "SaddleSVC",
     dict(eps=1e-3, beta=0.1, block_size=40_000, num_iters=200 * 40_000,
          record_every=50), WIDE_DATA),
)


# Fits held to the CPU over their first steps only, rerun on the card over
# those steps with the coordinates the card drew: label -> (steps, whether
# b is held too).  With a block of most of the coordinates the solve
# amplifies rounding (a relative change of 1e-7 in the data moves w by
# more than 1e-3 over 200 steps,
# tests/test_torch_svm.py::test_large_block_solve_amplifies_rounding),
# and at B = 40,000 of d_pad = 65,536 the MWU's unnormalised log weights
# reach the thousands (mwu_c ~ 1e4), where a float32 step is 2.4e-4 to
# 4.9e-4 and the card and the CPU, rounding in different orders, part
# from the first step; so the card's fit cannot be replayed to 1e-4 over
# its 200 steps.  Over its first 8 it is held to w within 1e-4 and the
# history within 1e-3 relative; b, which sums the weights of every point
# (1e-4 apart after 8 steps), is printed.  Path a's nu fit is a cut of
# depth, not of accuracy: its CPU replay of all 8,000 steps took 107.4 s
# of the script's 1,200 on a slow host, so the CPU replays its first
# 500 (2,000 and then 1,000 before), with w, b and the history
# held as for a whole fit.
REPLAY_PREFIX = {WIDE_FITS[1][0]: (8, False), FITS[0][0]: (500, True)}


def wide_path(torch, rec: PathRecorder):
    """Path d: both fits above 32,768 features on the same data, counts
    reset just before and read just after; every FWHT of them takes two
    passes.  Returns [(spec, fitted estimator, data, schedule)]."""
    from repro_torch.core import saddle
    from repro_torch.kernels import ops
    from repro_torch.kernels.fwht import fwht_plan

    ds = make_fit(WIDE_FITS[0], "cuda")[1]
    fits = [make_fit(spec, "cuda", ds) for spec in WIDE_FITS]
    ops.launch_counts.clear()
    t0 = time.perf_counter()
    done = []
    with rec:
        for spec, (clf, _) in zip(WIDE_FITS, fits):
            steps = saddle.resolve_num_iters(
                clf.num_iters, 65_536, clf.eps, clf.beta, len(ds.y),
                clf.block_size)
            run_fit(torch, spec[0], clf, ds, steps,
                    falls=clf.block_size == 1)
            done.append((spec, clf, ds, rec.take_schedule()))
    counts = dict(ops.launch_counts)
    print(f"path d: {time.perf_counter() - t0:.2f} s, launches {counts}")
    rec.check_counts(counts, ("fwht",) + PACKED)
    shapes = [shape for (name, shape) in rec.calls if name == "fwht"]
    print(f"  fwht shapes {shapes}: device passes "
          f"{[fwht_plan(d).device_launches for _, d in shapes]}")
    require(shapes and all(fwht_plan(d).device_launches == 2
                           for _, d in shapes),
            "path d: want every FWHT in two passes")
    return done


# ---------------------------------------------------------------- path e
# The fit service: SolverService(num_slots=8, chunk_steps=64) on the card.
# Hard-margin tenants at Figure 3's width in two point buckets (4,096 and
# 8,192), nu-SVM tenants on Figure 4's data (bucket 8,192 x 512), one with
# a duality-gap stop and one streaming tenant (an append inside its rung,
# then one that jumps to the next rung); budgets of 640 to 1,280 steps, a
# multiple of the chunk as the parity contract wants.
SERVE_SLOTS, SERVE_CHUNK = 8, 64
SERVE_HM = [(n, 100 + i, 640 + 128 * (i % 6))     # n, seed, budget
            for i, n in enumerate((3000, 5000, 8000) * 4)]
SERVE_NU = [(200 + i, 640 + 128 * i) for i in range(4)]   # seed, budget
SERVE_GAP = (3000, 150, 1280, 0.05)       # n, seed, budget, gap_tol
SERVE_STREAM = (300, 640, (3900, 4000, 4200))   # seed, budget, sizes
SERVE_CANCEL = 1      # index of the request cancelled mid-run (n = 5,000)
SERVE_VICTIM = 4      # index of the request poisoned at its chunk 2
SERVE_REPLAY = 0      # index of the request replayed on the CPU
SERVE_ATOL = 1e-5     # service vs solo solve (tests/test_solver_service.py)


def serve_requests():
    """Path e's tenants in submission order, (label, data, FitRequest
    keyword arguments), and the streaming tenant's data."""
    from repro_torch.core.svm import split_classes
    from repro_torch.data import synthetic

    reqs = [(f"hard-margin #{i} n={n} d=256", synthetic.separable(
                n, 256, seed=i), dict(seed=seed, num_iters=iters))
            for i, (n, seed, iters) in enumerate(SERVE_HM)]
    fig4 = synthetic.non_separable(6000, 512, beta2=0.25, seed=512)
    xp, xm = split_classes(fig4.x, fig4.y)
    nu = 1.0 / (0.85 * min(len(xp), len(xm)))
    reqs += [(f"nu-SVM seed={seed} n=6000 d=512", fig4,
              dict(seed=seed, num_iters=iters, nu=nu))
             for seed, iters in SERVE_NU]
    n, seed, iters, tol = SERVE_GAP
    reqs.append((f"hard-margin gap_tol={tol} n={n} d=256",
                 synthetic.separable(n, 256, seed=50),
                 dict(seed=seed, num_iters=iters, gap_tol=tol)))
    return reqs, synthetic.separable(SERVE_STREAM[2][-1], 256, seed=77)


def drive_mix(torch, svc, reqs, stream, cancel: bool):
    """Submit path e's requests and the streaming tenant, and step the
    service until it is drained, submitting the tenant's next update when
    its last round is done and, with ``cancel``, cancelling request
    SERVE_CANCEL once it has been running for three steps.  Returns
    ({label: rid}, {label: outcome}, seconds, tenant rid)."""
    from repro_torch.serve.scheduler import Status
    from repro_torch.serve.solver_service import FitRequest, UpdateRequest

    seed, iters, sizes = SERVE_STREAM
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = {label: svc.submit(FitRequest(x=ds.x, y=ds.y, **kw))
            for label, ds, kw in reqs}
    target = rids[reqs[SERVE_CANCEL][0]] if cancel else None
    tenant = svc.submit(FitRequest(x=stream.x[:sizes[0]],
                                   y=stream.y[:sizes[0]], seed=seed,
                                   num_iters=iters, stream=True))
    rids["stream round 0"] = live = tenant
    rounds, running = 1, 0
    while svc._sched.has_work():
        svc.step()
        if target is not None and svc.status(target) is Status.RUNNING:
            running += 1
            if running == 3:
                require(svc.cancel(target), "path e: cancel failed")
                target = None
        if rounds < len(sizes) and svc.status(live) is Status.DONE:
            lo, hi = sizes[rounds - 1], sizes[rounds]
            live = svc.submit_update(UpdateRequest(
                tenant=tenant, x=stream.x[lo:hi], y=stream.y[lo:hi],
                num_iters=iters))
            rids[f"stream round {rounds}"] = live
            rounds += 1
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    require(rounds == len(sizes) and target is None,
            "path e: the stream or the cancel did not happen")
    out = svc.run()
    return rids, {label: out[rid] for label, rid in rids.items()}, secs, \
        tenant


def workspace_bytes() -> int:
    """Bytes of the packed kernels' workspaces (grown on first use and
    kept for the process, so left out of the memory check), as the CUDA
    caching allocator counts them (in blocks of 512 bytes), so that a
    workspace replaced by a larger one mid-run leaves the check exact."""
    from repro_torch.kernels import saddle_update as su
    return sum(-(-t.numel() * t.element_size() // 512) * 512
               for ws in su._workspace.values() for t in ws)


def service_path(torch, rec: PathRecorder):
    """Path e: the mix run twice through a fresh service each time, counts
    reset just before the first run and read just after the second.  Run
    1 cancels one request mid-run and records every chunk's host time,
    sampler draws and set-up keys; run 2 poisons one lane at its chunk 2,
    leaves the cancel out, and copies to the host the packed calls of the
    second step of each bucket's first chunk and of the chunk after the
    poison.  Every other request must be bit-equal across the two runs,
    so each run's cancelled or poisoned lane left its batch-mates alone.
    Returns the record of both runs."""
    import numpy as np

    from repro_torch.core import engine
    from repro_torch.kernels import ops
    from repro_torch.serve.faults import Fault, FaultInjector, FaultPlan
    from repro_torch.serve.scheduler import RequestFailure, Status
    from repro_torch.serve.solver_service import SolverService

    reqs, stream = serve_requests()
    labels = [label for label, _, _ in reqs]
    run_chunk, sample_blocks = engine.run_chunk_slots, engine.sample_blocks
    rec_ = dict(chunk_s=[], sample_s=[], draws=[], inj=None)

    def chunk(state, x_t, sign, sp, num_steps, **kw):
        cfg = (tuple(x_t.shape), kw["project"], kw["check_gap"])
        first = cfg not in rec_["seen"]
        rec_["seen"].add(cfg)
        inj = rec_["inj"]
        if inj is not None:
            if first:
                rec.arm(f"first chunk of n_pad={x_t.shape[2]},d="
                        f"{x_t.shape[1]}{',nu' if kw['project'] else ''}"
                        f"{',gap' if kw['check_gap'] else ''}")
            elif len(inj.fired) > rec_["fired"]:
                rec.arm("chunk after the poison")
            rec_["fired"] = len(inj.fired)
        keys = set(engine.trace_counts)
        t = time.perf_counter()
        out = run_chunk(state, x_t, sign, sp, num_steps, **kw)
        rec_["chunk_s"].append((cfg, time.perf_counter() - t))
        require(first or set(engine.trace_counts) == keys,
                "path e: a chunk after its bucket's first set up a key")
        return out

    def sample(gens, d, b, steps, device):
        t = time.perf_counter()
        out = sample_blocks(gens, d, b, steps, device)
        rec_["sample_s"].append(time.perf_counter() - t)
        rec_["draws"].append(([g.initial_seed() for g in gens], out))
        return out

    runs = []
    ops.launch_counts.clear()
    engine.run_chunk_slots = chunk
    try:
        with rec:
            for poison in (False, True):
                rec_.update(seen=set(), fired=0, chunk_s=[], sample_s=[])
                inj = None
                if poison:
                    victim = runs[0]["rids"][labels[SERVE_VICTIM]]
                    inj = FaultInjector(FaultPlan(seed=0, faults=(
                        Fault("poison", rid=victim, at_chunk=2),)))
                rec_["inj"] = inj
                engine.sample_blocks = sample if not poison else \
                    sample_blocks
                keys = set(engine.trace_counts)
                before = Counter(ops.launch_counts)
                base = torch.cuda.memory_allocated() - workspace_bytes()
                svc = SolverService(num_slots=SERVE_SLOTS,
                                    chunk_steps=SERVE_CHUNK,
                                    fault_injector=inj)
                rids, res, secs, tenant = drive_mix(torch, svc, reqs,
                                                    stream, not poison)
                engine.sample_blocks = sample_blocks
                draws = [(seeds, out.cpu()) for seeds, out in
                         rec_.pop("draws")] if not poison else None
                rec_["draws"] = []
                svc.close_stream(tenant)
                mem = torch.cuda.memory_allocated() - workspace_bytes()
                runs.append(dict(
                    rids=rids, res=res, secs=secs, stats=svc.stats,
                    new_keys=set(engine.trace_counts) - keys,
                    launches=Counter(ops.launch_counts) - before,
                    chunk_s=rec_["chunk_s"], sample_s=rec_["sample_s"],
                    draws=draws, mem=(base, mem), inj=inj))
                del svc
    finally:
        engine.run_chunk_slots = run_chunk
        engine.sample_blocks = sample_blocks
    counts = dict(ops.launch_counts)
    print(f"path e launches {counts}")
    rec.check_counts(counts, ("fwht",) + PACKED)

    card = card_line()
    for i, run in enumerate(runs):
        st, done = run["stats"], run["res"]
        ok = [r for r in done.values() if not isinstance(r, RequestFailure)]
        steps = st["chunk_calls"] * SERVE_CHUNK
        lc = run["launches"]
        per_cfg = {}
        for cfg, secs in run["chunk_s"]:
            per_cfg.setdefault(cfg, []).append(secs)
        chunk_ms = statistics.fmean(t for _, t in run["chunk_s"]) * 1e3
        print(f"path e run {i + 1} ({'poison at chunk 2' if i else 'cancel'}"
              f", {card}): {len(done)} requests, {len(ok)} completed in "
              f"{run['secs']:.3f} s: {len(ok) / run['secs']:.3f} requests/s,"
              f" {st['chunk_calls']} chunks of {SERVE_SLOTS} lanes x "
              f"{SERVE_CHUNK} steps: "
              f"{run['secs'] / st['chunk_calls'] * 1e3:.3f} ms/chunk, "
              f"{run['secs'] / steps * 1e3:.4f} ms/step "
              f"(wall, intake and recovery included); launches {dict(lc)}: "
              f"{lc['momentum_dot_packed'] / steps:.3f} + "
              f"{lc['mwu_update_packed'] / steps:.3f} packed a step; set-ups"
              f" {st['compiles']} (new keys {sorted(run['new_keys'])})")
        sampler = (f"{statistics.fmean(run['sample_s']) * 1e3:.3f}"
                   if run["sample_s"] else "not recorded")
        print(f"  host ms a chunk: the chunk call {chunk_ms:.3f} (enqueue, no "
              f"sync; " + ", ".join(
                  f"n_pad={c[0][2]},d={c[0][1]}{',nu' if c[1] else ''}"
                  f"{',gap' if c[2] else ''}: {statistics.fmean(v) * 1e3:.3f}"
                  f" x {len(v)}" for c, v in sorted(per_cfg.items()))
              + f"), its sampler {sampler} ({SERVE_SLOTS} generators drawn "
              "one by one)")
        require(lc["momentum_dot_packed"] == steps
                and lc["mwu_update_packed"] == steps,
                f"path e run {i + 1}: want one launch of each packed kernel"
                f" a step")
        base, mem = run["mem"]
        print(f"  device memory (workspace left out): {base} bytes before "
              f"the first submit, {mem} after the drain")
        require(mem == base, f"path e run {i + 1}: device memory not "
                "released after the drain")
    require(runs[0]["stats"]["compiles"] == len(runs[0]["new_keys"]) == 4,
            "path e: want one set-up for each of the 4 batch configurations")
    require(runs[1]["stats"]["compiles"] == 0 and not runs[1]["new_keys"],
            "path e: the second run set up something new")
    one, two = runs[0]["res"], runs[1]["res"]
    cancelled, victim = labels[SERVE_CANCEL], labels[SERVE_VICTIM]
    require(isinstance(one[cancelled], RequestFailure)
            and one[cancelled].status is Status.CANCELLED
            and "running" in one[cancelled].reason,
            f"path e: {cancelled} was not cancelled while running")
    require(isinstance(two[victim], RequestFailure)
            and two[victim].status is Status.FAILED
            and "non-finite solver state" in two[victim].reason,
            f"path e: {victim} was not quarantined: {two[victim]}")
    require(len(runs[1]["inj"].fired) == 1, "path e: the poison never fired")
    same = 0
    for label in one:
        if label in (cancelled, victim):
            continue
        a, b = one[label], two[label]
        require(not isinstance(a, RequestFailure)
                and not isinstance(b, RequestFailure),
                f"path e: {label} failed: {a} {b}")
        require(np.array_equal(a.w, b.w)
                and (a.b, a.objective, a.iterations)
                == (b.b, b.objective, b.iterations),
                f"path e: {label} differs between the cancel and the "
                "poison run")
        same += 1
    print(f"  {same} requests bit-equal in both runs: the cancelled "
          f"({cancelled}) and the poisoned ({victim}, {two[victim].reason})"
          f" lanes left their batch-mates alone")
    return dict(reqs=reqs, stream=stream, runs=runs)


def serve_pre(torch, x, y, seed):
    """A request's preprocessing on the card, seeded as the service seeds
    it (``svm._preprocess_seed``)."""
    from repro_torch.core import preprocess as pp
    from repro_torch.core.svm import _preprocess_seed, split_classes

    xp, xm = split_classes(x, y)
    return pp.preprocess(xp, xm, generator=torch.Generator().manual_seed(
        _preprocess_seed(seed)), device="cuda")


def serve_solo(torch, pre, xp, xm, kw, bucket=None, warm=None, seed=None):
    """The port's solo saddle.solve on the card at a request's seed,
    bucket (default: the meshless service's) and chunk, and its (w, b)."""
    from repro_torch.core import preprocess as pp
    from repro_torch.core import saddle
    from repro_torch.core.svm import recover_hyperplane

    n_b, d_b = bucket or pp.bucket_shape(len(xp) + len(xm), xp.shape[1])
    res = saddle.solve(xp, xm, nu=kw.get("nu", 0.0),
                       num_iters=kw["num_iters"],
                       seed=kw["seed"] if seed is None else seed,
                       gap_tol=kw.get("gap_tol", 0.0),
                       record_every=SERVE_CHUNK, n_pad=n_b, d_pad=d_b,
                       warm_start=warm, device="cuda")
    st = res.state
    w, b, *_ = recover_hyperplane(pre, torch.exp(st.log_eta),
                                  torch.exp(st.log_xi), xp, xm)
    return res, w, b


def serve_vs_solo(torch, serve):
    """Every completed request of path e against the port's solo
    saddle.solve on the card at its seed, bucket and chunk (w within
    1e-5, the same iterations); the streaming tenant's rounds against the
    solo chain warm-started from the previous round."""
    import numpy as np

    from repro_torch.core import preprocess as pp

    t0 = time.perf_counter()
    one, two = (run["res"] for run in serve["runs"])
    labels = [label for label, _, _ in serve["reqs"]]
    worst = 0.0
    for i, (label, ds, kw) in enumerate(serve["reqs"]):
        got = two[label] if i == SERVE_CANCEL else one[label]
        pre = serve_pre(torch, ds.x, ds.y, kw["seed"])
        res, w, b = serve_solo(torch, pre, pre.xp, pre.xm, kw)
        dw = float(np.abs(got.w - w).max())
        worst = max(worst, dw)
        require(dw <= SERVE_ATOL and got.iterations == res.history[-1][0],
                f"path e: {label} vs its solo solve: max|dw| {dw:.3e}, "
                f"{got.iterations} vs {res.history[-1][0]} iterations")
    seed, iters, sizes = SERVE_STREAM
    stream = serve["stream"]
    pre = serve_pre(torch, stream.x[:sizes[0]], stream.y[:sizes[0]], seed)
    xp, xm = pre.xp, pre.xm
    warm = None
    for k in range(len(sizes)):
        if k:
            lo, hi = sizes[k - 1], sizes[k]
            x, y = stream.x[lo:hi], stream.y[lo:hi]
            xp = torch.cat([xp, pp.transform_like(pre, x[y > 0])])
            xm = torch.cat([xm, pp.transform_like(pre, x[y < 0])])
        res, w, b = serve_solo(torch, pre, xp, xm,
                               dict(num_iters=iters, seed=seed), warm=warm,
                               seed=seed + 1000003 * k)
        warm = res.state
        got = one[f"stream round {k}"]
        dw = float(np.abs(got.w - w).max())
        worst = max(worst, dw)
        print(f"  stream round {k}: {len(xp) + len(xm)} points, bucket "
              f"{got.bucket}, max|dw| vs the warm-started solo solve "
              f"{dw:.3e}")
        require(dw <= SERVE_ATOL and got.iterations == iters,
                f"path e: stream round {k} vs its solo solve: {dw:.3e}")
    print(f"path e vs solo solves on the card ({len(labels) + len(sizes)} "
          f"requests, {time.perf_counter() - t0:.1f} s): max|dw| {worst:.3e}"
          f" (tol {SERVE_ATOL}), iterations equal")


def serve_replay_cpu(torch, serve):
    """Request SERVE_REPLAY of path e's first run replayed on the CPU's
    plain path from the coordinates its lane drew on the card."""
    import numpy as np

    from repro_torch.core import preprocess as pp
    from repro_torch.core import saddle
    from repro_torch.core.svm import (_preprocess_seed, recover_hyperplane,
                                      split_classes)

    label, ds, kw = serve["reqs"][SERVE_REPLAY]
    run = serve["runs"][0]
    rows = [out[:, lane] for seeds, out in run["draws"]
            for lane, s in enumerate(seeds) if s == kw["seed"]]
    sched = torch.cat(rows)[:kw["num_iters"]].numpy()
    require(len(sched) == kw["num_iters"], f"{label}: draws not recorded")
    xp, xm = split_classes(ds.x, ds.y)
    pre = pp.preprocess(xp, xm, generator=torch.Generator().manual_seed(
        _preprocess_seed(kw["seed"])), device="cuda")
    pre = pp.Preprocessed(*(t.cpu() if hasattr(t, "cpu") else t
                            for t in pre))
    n_b, d_b = pp.bucket_shape(len(ds.y), pre.xp.shape[1])
    t0 = time.perf_counter()
    res = saddle.solve(pre.xp, pre.xm, num_iters=kw["num_iters"],
                       record_every=SERVE_CHUNK, n_pad=n_b, d_pad=d_b,
                       idx_schedule=sched, device="cpu")
    w, b, *_ = recover_hyperplane(pre, torch.exp(res.state.log_eta),
                                  torch.exp(res.state.log_xi), pre.xp,
                                  pre.xm)
    got = run["res"][label]
    dw = float(np.abs(got.w - w).max())
    db = abs(got.b - b)
    print(f"path e, {label} replayed on the CPU from its lane's "
          f"coordinates ({time.perf_counter() - t0:.1f} s): max|dw| "
          f"{dw:.3e}, |db| {db:.3e} (tol {FIT_ATOL})")
    require(max(dw, db) <= FIT_ATOL, f"path e: {label}: card and CPU "
            "disagree")


def check_service_calls(torch, timer, rec) -> list:
    """A path's copied packed calls (path e's: S = 8 lanes, a block and
    step scalars each, free lanes, and after the poison a NaN lane; path
    f's: one step of each run, here and on rank 0; path g's: each rank's
    lane and point shards) on the card: each
    kernel against its plain version on the live lanes (a
    lane with a point and finite duals, u and dw) at the packed
    tolerances, the MWU's (m, s) also against the plain merge of its own
    log_new, the live lanes' bits equal to a call on the live lanes
    alone (the other lanes leave them alone), the same bits on a repeat
    call; returns their timing jobs (one device launch a call)."""
    from repro_torch.kernels import ops, ref

    jobs = []
    for cap in rec.captured:
        dev = {}

        def cuda(args):
            return [dev.setdefault(id(a), a.cuda()) if hasattr(a, "cuda")
                    else a for a in args]

        dot = cuda(cap["momentum_dot_packed"])
        mwu = cuda(cap["mwu_update_packed"])
        x_t, idx, ll, lp, sign, theta = dot
        s, d, n_pad = x_t.shape
        b = idx.shape[1]
        shape = (s, d, n_pad, b)
        label = (f"[S={s},d={d},n_pad={n_pad},b={b},path {rec.name} "
                 f"{cap['label']}]")
        real = sign != 0

        def finite(*ts):
            return torch.stack([torch.isfinite(t).all(-1) for t in ts]
                               ).all(0)

        lam = torch.exp(ll)
        mom = sign * (lam + theta[:, None] * (lam - torch.exp(lp)))
        rows = torch.arange(s, device=x_t.device)[:, None]
        for name, args, live, library, nbytes, ops_ in (
                ("momentum_dot_packed", dot, real.any(-1) & finite(ll, lp),
                 lambda: x_t[rows, idx.long()] @ mom[..., None],
                 4 * s * (n_pad * (b + 3) + 2 * b + 1),
                 s * n_pad * (2 * b + 6)),
                ("mwu_update_packed", mwu,
                 real.any(-1) & finite(mwu[2], mwu[3], mwu[4]), None,
                 4 * s * (n_pad * (b + 5) + 2 * b + 6),
                 s * n_pad * (2 * b + 12))):
            if not live.any():
                # e.g. the chunk after the poison of a group whose only
                # tenant was the poisoned lane: its shape is held by the
                # group's first chunk
                print(f"  {name}{label}: no live lane (the {s} lanes free "
                      "or non-finite), nothing to hold")
                continue
            kernel = getattr(ops, name)
            plain = getattr(ref, name + "_ref")

            def fn(kernel=kernel, args=args):
                return kernel(*args)

            def lanes(out, live=live):
                return (out[live] if isinstance(out, torch.Tensor)
                        else tuple(t[live] for t in out))

            got, want = fn(), plain(*args)
            errs = packed_errors(torch, name, lanes(got), lanes(want),
                                 real[live])
            if name == "mwu_update_packed":
                merged = merged_partials(torch, got[0][live], sign[live])
                errs["merge"] = (lse_error(torch, got[2][live],
                                           got[3][live], *merged), 1e-4)
            require(all(e <= tol for e, tol in errs.values()),
                    f"{name}{label}: {errs}")
            alone = kernel(*(a[live].contiguous()
                             if isinstance(a, torch.Tensor) else a
                             for a in args))
            same = [torch.equal(p, q) for p, q in zip(
                (alone,) if name == "momentum_dot_packed" else alone,
                (lanes(got),) if name == "momentum_dot_packed"
                else lanes(got))]
            require(all(same), f"{name}{label}: the other lanes moved the "
                    "live lanes' bits")
            again = lanes(fn())
            require(all(torch.equal(p, q) for p, q in zip(
                (again,) if name == "momentum_dot_packed" else again,
                (lanes(got),) if name == "momentum_dot_packed"
                else lanes(got))), f"{name}{label}: not deterministic")
            print(f"  {name}{label}: {int(live.sum())} live lanes of {s}, "
                  f"{len(set(map(tuple, idx.tolist())))} distinct blocks "
                  f"over the {s} lanes; errors "
                  + ", ".join(f"{k} {e:.3e} (tol {tol:.1e})"
                              for k, (e, tol) in errs.items())
                  + "; live lanes bit-equal to a call on them alone")
            e = entry(name, name + label,
                      max(err for err, _ in errs.values()), timer(fn),
                      timer(lambda: plain(*args)),
                      None if library is None else timer(library),
                      nbytes=nbytes, ops=ops_)
            e["launches"] = rec.calls[name, shape]
            jobs.append((e, fn, name + "_kernel", 1))
    return jobs


# ---------------------------------------------------------------- path f
# Algorithm 4 over real collectives: solve_distributed(mesh=ClientGroup),
# one client a process.  The ranks share the one card, where NCCL refuses
# two ranks ("Duplicate GPU detected"), so they talk through gloo over CUDA
# tensors (copied to the host and back) and NCCL runs at world size 1, in
# this process.  One spawn of F_RANKS gloo ranks runs every gloo case: the
# whole group is Figure 3 at the paper's k = 20, ranks 0-3 the k = 4 fits,
# ranks 0-1 the serving chunk's two placements.  Cut to 200 / 40 / 40
# steps (paths b's 6,000 / 5,000; 600 / 200 / 120 until path m came), 2
# chunks of the bucket: most of the spawn is fixed cost (start-up, the
# ranks' first profiler sessions, exit; f_time_split), and a gloo
# all-reduce between device synchronisations costs 3-14 ms, 29 of them a
# Figure 4 step.
F_RANKS = 20
F_K4 = (("Figure 3 hard margin k=4", 0, dict(num_iters=200,
                                              record_every=100)),
        ("Figure 4 nu-SVM k=4", 1, dict(num_iters=40, record_every=20)))
F_K20_STEPS = 40
F_SERVE = dict(k=2, lanes=8, n_pad=8192, d=256, chunk_steps=64, chunks=2,
               drop=(3, 1), ns=[5000 + 400 * i for i in range(8)])
F_TIMEOUT_S = 600


def f_solve(group, xp, xm, k, timed: bool = True, **kw) -> dict:
    """One solve on this rank with its launches and tallied collectives,
    each counted from just before it, and with ``timed`` the host time of
    its collectives (each between two device synchronisations: a
    ``comm_audit.Recorder`` on the group)."""
    import torch

    from repro_torch.core import distributed as dist
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    from repro_torch.utils import comm_audit

    rec = comm_audit.Recorder()
    launches = Counter(ops.launch_counts)
    counts = Counter(engine.collective_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = dist.solve_distributed(
        xp, xm, k=k, mesh=group._replace(recorder=rec) if timed else group,
        device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(
        w=res.state.w.cpu().numpy(), history=res.history, wall=wall,
        log_eta=res.state.log_eta.cpu().numpy(),
        launches=dict(Counter(ops.launch_counts) - launches),
        tally=Counter(engine.collective_counts) - counts,
        coll_s=rec.seconds if timed else None)


def f_serve_batch(torch, lanes, dev):
    """Path f's serving bucket (F_SERVE) from the preprocessed lanes."""
    from repro_torch.core import engine, saddle
    from repro_torch.utils import comm_audit

    rows = [engine.slot_params_row(saddle.make_params(
        len(xp) + len(xm), F_SERVE["d"], 1e-3, 0.1, block_size=1))
        for xp, xm in lanes]
    return comm_audit.fresh_slot_batch(
        [(torch.as_tensor(xp, device=dev), torch.as_tensor(xm, device=dev))
         for xp, xm in lanes], F_SERVE["n_pad"], F_SERVE["d"], rows,
        [100 + i for i in range(len(lanes))], 1 << 20, dev)


def f_serve_run(torch, group, placement, batch, drop=None) -> dict:
    """F_SERVE's chunks of the bucket: unsharded without a group, else
    this rank's shard in ``placement`` (after dropping ``drop``)."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    from repro_torch.utils import comm_audit

    state, x_t, sign, sp = batch
    rec = comm_audit.Recorder()
    if drop is not None:
        state, sign = dist.drop_slot_shard(state, sign, *drop,
                                           num_shards=group.size)
    if group is not None:
        state, x_t, sign, sp = engine.shard_slot_batch(group, placement,
                                                       state, x_t, sign, sp)
    kw = dict(chunk_steps=F_SERVE["chunk_steps"], d=F_SERVE["d"],
              block_size=1, project=False, check_gap=False)
    launches = Counter(ops.launch_counts)
    counts = Counter(engine.collective_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    objs = []
    for _ in range(F_SERVE["chunks"]):
        if group is None:
            state, obj, healthy = engine.run_chunk_slots(
                state, x_t, sign, sp, F_SERVE["chunk_steps"], **kw)
        else:
            state, obj, healthy = engine.run_chunk_slots_sharded(
                state, x_t, sign, sp, F_SERVE["chunk_steps"],
                mesh=group._replace(recorder=rec), placement=placement, **kw)
        objs.append(obj)
    torch.cuda.synchronize()
    return dict(
        wall=time.perf_counter() - t0, w=state.w.cpu().numpy(),
        weights=torch.exp(state.log_lam).cpu().numpy(),
        u=state.u.cpu().numpy(), obj=torch.stack(objs).cpu().numpy(),
        healthy=healthy.cpu().numpy(),
        launches=dict(Counter(ops.launch_counts) - launches),
        tally=Counter(engine.collective_counts) - counts,
        coll_s=rec.seconds)


def f_rank(world, data_path: str) -> dict:
    """What each of path f's spawned ranks runs (see F_RANKS).  Rank 0
    records its packed calls by shape and copies one step's arguments of
    each run (on the card during the run, to the host after it), which the
    parent holds against the plain versions."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.utils import comm_audit

    marks = [("in f_rank", time.time())]      # epoch seconds: the parent
    torch.zeros(1, device=world.device)       # compares them with its own
    # a process's first profiler session takes seconds; the audits' would
    # take them in lockstep at their collectives, so take it here, while
    # the later ranks still start
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    marks.append(("CUDA context and a first profiler session", time.time()))
    data = np.load(data_path)
    g4 = meshlib.sub_group(world, range(4))
    g2 = meshlib.sub_group(world, range(F_SERVE["k"]))
    pmesh = meshlib.make_test_mesh(world, ranks=range(P_RANKS))
    rec = (PathRecorder("f rank 0", keep=False, on_device=True)
           if world.rank == 0 else None)

    def arm(label):
        if rec is not None:
            rec.arm(label)

    ops.launch_counts.clear()
    out = {}
    with rec if rec is not None else contextlib.nullcontext():
        xp, xm = data["xp0"], data["xm0"]
        arm(f"Figure 3 k={F_RANKS}")
        out["k20"] = f_solve(world, xp, xm, F_RANKS, num_iters=F_K20_STEPS,
                             record_every=F_K20_STEPS,
                             idx_schedule=data["sched0"])
        marks.append((f"k = {F_RANKS} fit", time.time()))
        out["k20 audit"] = comm_audit.audit_runner(
            world, n1=len(xp), n2=len(xm), d=xp.shape[1], nu=0.0)
        marks.append((f"k = {F_RANKS} audit", time.time()))
        if g4 is not None:
            for label, i, kw in F_K4:
                xp, xm = data[f"xp{i}"], data[f"xm{i}"]
                nu = float(data[f"nu{i}"])
                arm(label)
                out[label] = f_solve(g4, xp, xm, 4, nu=nu, **kw)
                marks.append((label, time.time()))
                out[label + " audit"] = comm_audit.audit_runner(
                    g4, n1=len(xp), n2=len(xm), d=xp.shape[1], nu=nu)
                marks.append((label + " audit", time.time()))
        if g2 is not None:
            lanes = [(data[f"sxp{i}"], data[f"sxm{i}"])
                     for i in range(F_SERVE["lanes"])]
            for placement in ("points", "lanes"):
                arm(f"serving {placement}")
                out[placement] = f_serve_run(
                    torch, g2, placement,
                    f_serve_batch(torch, lanes, g2.device))
                n = F_SERVE["ns"][-1]
                out[placement + " audit"] = comm_audit.audit_serve(
                    g2, placement=placement, num_slots=F_SERVE["lanes"],
                    n1=n // 2, n2=n - n // 2, d=F_SERVE["d"], nu=0.0,
                    chunk_steps=8)
            out["dropped"] = f_serve_run(
                torch, g2, "points", f_serve_batch(torch, lanes, g2.device),
                drop=F_SERVE["drop"])
            marks.append(("serving chunks and audits", time.time()))
    if rec is not None:
        out["rec"] = rec.host_copy()
        out["rec"]["counts"] = dict(ops.launch_counts)
    if g2 is not None:
        out["g"] = g_rank(g2, g_requests() if g2.rank == 0 else [])
        marks.append(("path g", time.time()))
    if pmesh is not None:
        out["p"] = p_rank(pmesh, str(Path(data_path).parent))
        marks.append(("path p", time.time()))
        out["q"] = q_rank(pmesh, str(Path(data_path).parent))
        marks.append(("path q", time.time()))
    out["marks"] = marks
    return out


def f_check_run(label, runs, steps: int, want_colls: dict, diff: float,
                tol: float) -> None:
    """A run on several ranks: ``diff`` (its largest difference from the
    reference) within ``tol``, 2 packed launches a step on every rank, the
    tally equal to the model; prints ms a step and the collectives' host
    time."""
    wall = max(r["wall"] for r in runs)
    ncoll = sum(want_colls.values())
    if any(r["coll_s"] is None for r in runs):
        timed = "collectives not timed"
    else:
        coll = max(r["coll_s"] for r in runs)
        timed = (f"collectives' host time {coll / steps * 1e3:.4f} ms a step "
                 f"({coll / max(ncoll, 1) * 1e3:.4f} ms each)")
    print(f"path f {label}: {len(runs)} ranks, {wall / steps * 1e3:.4f} ms "
          f"a step ({wall:.3f} s, {steps} steps); {timed}, {ncoll} calls; "
          f"max|w - reference| {diff:.3e} (tol {tol:g})")
    for r in runs:
        require(r["launches"] == {k: steps for k in PACKED},
                f"path f {label}: launches {r['launches']}, want {steps} "
                "of each packed kernel")
        require(r["tally"] == Counter(want_colls),
                f"path f {label}: tallied {dict(r['tally'])}, model "
                f"{want_colls}")
    require(diff <= tol, f"path f {label}: w differs from the reference")


def f_check_audit(label, rec, want_count: int | None) -> None:
    print(f"  audit {label}: backend {rec['backend']}, measured "
          f"{rec['measured']} an iteration, "
          f"{rec.get('measured_per_chunk', rec.get('runner_per_chunk'))} a "
          f"chunk, match {rec['match']}")
    require(rec["match"] is True and rec["hooks_agree"] is True,
            f"path f {label}: the profiler's collectives differ from the "
            "model or the hooks")
    require(rec.get("runner_match", True) is True
            and rec.get("runner_matches_step", True) is True,
            f"path f {label}: the runner chunk differs from the step")
    if want_count is not None:
        require(rec["per_iteration_count"] == want_count,
                f"path f {label}: {rec['per_iteration_count']} collectives "
                f"an iteration, want {want_count}")


def model_colls(k: int, nu: float, steps: int, chunks: int, d: int) -> dict:
    from repro_torch.core import distributed as dist
    from repro_torch.core import projections

    comm = dist.CommModel(k=k, nu_rounds_per_iter=(
        float(projections.BISECT_ROUNDS_SOLVER) if nu > 0 else 0.0))
    want = Counter({key: n * steps
                    for key, n in comm.collective_multiset().items()})
    want["all-reduce", "add", d] += chunks
    return dict(want)


def collectives_path(torch, dist_fits, serve, rec: PathRecorder,
                     rec_g: PathRecorder) -> tuple:
    """Paths f, g, p and q: the references on the card, NCCL at world size
    1 here (path f's solves, then path g's service), then the spawned gloo
    ranks (path f, then path g on ranks 0-1, then paths p and q on ranks
    0-7); each path's counts reset just before it and read after, here
    and on each rank, its calls here recorded by ``rec`` / ``rec_g``.
    Returns
    (the ranks' recorders, p1's result for path m)."""
    t_path = time.perf_counter()
    ranks, spawn_s, arrays, refs, counts = f_parent(torch, dist_fits, rec,
                                                    rec_g, serve)
    print(f"path f launches here {counts['f']}")
    rec.check_counts(counts["f"], ("fwht",) + PACKED)
    rank0 = PathRecorder.from_host_copy("f rank 0", ranks[0]["rec"])
    print(f"path f launches on rank 0 {ranks[0]['rec']['counts']}")
    rank0.check_counts(ranks[0]["rec"]["counts"], PACKED)
    f_check(ranks, spawn_s, arrays, refs)
    print(f"path f: {time.perf_counter() - t_path:.2f} s in all (path g's "
          "part of the spawn included)")
    print(f"path g launches here {counts['g']}")
    rec_g.check_counts(counts["g"], ("fwht",) + PACKED)
    g_recs = []
    for r in range(2):
        g = ranks[r]["g"]
        grec = PathRecorder.from_host_copy(f"g rank {r}", g["rec"],
                                           operands=False)
        print(f"path g launches on rank {r} {g['counts']}")
        grec.check_counts(g["counts"], (("fwht",) if r == 0 else ())
                          + PACKED)
        g_recs.append(grec)
    g_check(torch, [ranks[r]["g"] for r in range(2)], refs["g"])
    p1 = p_check(torch, ranks, refs["p files"])
    q_check(torch, ranks, refs["p files"])
    return [rank0] + g_recs, p1


def f_parent(torch, dist_fits, rec, rec_g, serve):
    """Path f's data, its references on the card and the NCCL runs here,
    path g's NCCL service, then the spawn (paths f, g, p and q); returns (the
    ranks' results, the spawn's seconds, the data, the references with
    path p's files, the launches here of paths f and g)."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.utils import comm_audit

    ops.launch_counts.clear()
    t0 = time.perf_counter()
    with rec:
        arrays, refs = f_references(torch, dist_fits)
    secs = {"references": time.perf_counter() - t0}
    counts = {}

    # NCCL at world size 1 in this process, then the spawned gloo ranks
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_f_"))
    try:
        g1 = meshlib.init_client_group(
            backend="nccl", init_method=f"file://{tmp / 'nccl'}", rank=0,
            world_size=1, device="cuda", timeout_s=F_TIMEOUT_S)
        try:
            with rec:
                # NCCL sets its communicator up at the first collective:
                # do that before the timed solves; the first one's ms a
                # step has no device synchronisation around its
                # collectives
                torch.distributed.all_reduce(
                    torch.zeros(1, device=g1.device))
                xp, xm = arrays["xp0"], arrays["xm0"]
                serial_kw = F_K4[0][2]
                nccl = [f_solve(g1, xp, xm, 1, timed=False, **serial_kw)]
                rec.arm("NCCL k=1")
                nccl.append(f_solve(g1, xp, xm, 1, **serial_kw))
                refs.update(nccl=nccl, nccl_audit=comm_audit.audit_runner(
                    g1, n1=len(xp), n2=len(xm), d=xp.shape[1], nu=0.0))
            counts["f"] = dict(ops.launch_counts)
            ops.launch_counts.clear()
            secs["NCCL k=1"] = time.perf_counter() - t0 - secs["references"]
            with rec_g:
                refs["g"] = g_parent(torch, g1, serve, rec_g)
            counts["g"] = dict(ops.launch_counts)
            secs["path g's NCCL service"] = (time.perf_counter() - t0
                                             - sum(secs.values()))
        finally:
            torch.distributed.destroy_process_group()
        np.savez(tmp / "data.npz", **arrays)
        t0 = time.perf_counter()
        refs["spawn_epoch"] = time.time()
        ranks = meshlib.spawn_clients(f_rank, F_RANKS, backend="gloo",
                                      device="cuda", timeout_s=F_TIMEOUT_S,
                                      args=(str(tmp / "data.npz"),))
        spawn_s = time.perf_counter() - t0
        refs["p files"] = {f.stem: dict(np.load(f))
                           for f in tmp.glob("[pq]2 *.npz")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("path f in the parent: " + "; ".join(
        f"{k} {v:.2f} s" for k, v in secs.items()))
    return ranks, spawn_s, arrays, refs, counts


def f_references(torch, dist_fits):
    """Path f's data and its references on the card."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import preprocess as pp
    from repro_torch.core import saddle
    from repro_torch.core.svm import split_classes
    from repro_torch.data import synthetic

    arrays = {"sched0": dist_fits[0]["sched"][:F_K20_STEPS]}
    for i, spec in enumerate(DIST_FITS):
        xp, xm, nu = dist_problem(spec)
        pre = pp.preprocess(xp, xm,
                            generator=torch.Generator().manual_seed(0),
                            device="cuda")
        arrays.update({f"xp{i}": pre.xp.cpu().numpy(),
                       f"xm{i}": pre.xm.cpu().numpy(), f"nu{i}": nu})
    lanes = []
    for i, n in enumerate(F_SERVE["ns"]):
        ds = synthetic.separable(n, F_SERVE["d"], seed=100 + i)
        pre = pp.preprocess(*split_classes(ds.x, ds.y),
                            generator=torch.Generator().manual_seed(i),
                            device="cuda")
        lanes.append((pre.xp.cpu().numpy(), pre.xm.cpu().numpy()))
        arrays[f"sxp{i}"], arrays[f"sxm{i}"] = lanes[-1]

    # the references, on the card
    xp, xm = arrays["xp0"], arrays["xm0"]
    sims = {label: dist.solve_distributed(
        arrays[f"xp{i}"], arrays[f"xm{i}"], k=4, nu=arrays[f"nu{i}"],
        device="cuda", **kw) for label, i, kw in F_K4}
    sim20 = dist.solve_distributed(xp, xm, k=F_RANKS,
                                   num_iters=F_K20_STEPS,
                                   record_every=F_K20_STEPS,
                                   idx_schedule=arrays["sched0"],
                                   device="cuda")
    serial_kw = F_K4[0][2]
    serial = saddle.solve(xp, xm, device="cuda", **serial_kw)
    whole = f_serve_run(torch, None, None,
                        f_serve_batch(torch, lanes, torch.device("cuda")))
    return arrays, dict(sims=sims, sim20=sim20, serial=serial, whole=whole)


def f_time_split(ranks, spawn_epoch: float, spawn_s: float) -> None:
    """Where the spawn's seconds go: from the spawn to the last rank's
    entry into ``f_rank`` (interpreters, imports, the gloo rendezvous),
    its CUDA context and first profiler session, then rank 0's phases
    (each ends at a collective all its group's ranks share), and the rest
    (the ranks' exit and their results' trip back)."""
    entry = max(r["marks"][0][1] for r in ranks) - spawn_epoch
    ctx = max(r["marks"][1][1] - r["marks"][0][1] for r in ranks)
    parts = [f"start-up to the last rank in f_rank {entry:.2f} s",
             f"the slowest CUDA context and first profiler session "
             f"{ctx:.2f} s"]
    marks = ranks[0]["marks"]
    for (_, t0), (label, t1) in zip(marks[1:], marks[2:]):
        parts.append(f"{label} {t1 - t0:.2f} s")
    rest = spawn_s - (marks[-1][1] - spawn_epoch)
    parts.append(f"exit and results {rest:.2f} s")
    print("path f time split (rank 0): " + "; ".join(parts))


def f_check(ranks, spawn_s, arrays, refs) -> None:
    """Path f's holds: every run against its reference and the models."""
    import numpy as np

    from repro_torch.core import distributed as dist

    sims, sim20, serial, whole = (refs[k] for k in ("sims", "sim20",
                                                    "serial", "whole"))
    xp = arrays["xp0"]
    serial_kw = F_K4[0][2]
    steps = serial_kw["num_iters"]
    for nccl, label in zip(refs["nccl"], ("", ", collectives timed")):
        f_check_run(f"NCCL k=1 vs serial{label}", [nccl], steps,
                    model_colls(1, 0.0, steps,
                                -(-steps // serial_kw["record_every"]),
                                xp.shape[1]),
                    float(abs(nccl["w"] - serial.state.w.cpu().numpy()
                              ).max()), 0.0)
        require(np.array_equal(serial.state.log_eta.cpu().numpy(),
                               nccl["log_eta"][0])
                and [(m, o) for m, _, o in nccl["history"]]
                == serial.history, "path f NCCL k=1: duals or history "
                "differ from the serial solve")
    f_check_audit("NCCL k=1", refs["nccl_audit"], 3)
    print(f"path f: {F_RANKS} gloo ranks on the card, {spawn_s:.2f} s from "
          "spawn to the last result")
    f_time_split(ranks, refs["spawn_epoch"], spawn_s)
    d = xp.shape[1]

    def w_diff(runs, ref):
        return max(float(abs(r["w"] - ref.state.w.cpu().numpy()).max())
                   for r in runs)

    runs = [r["k20"] for r in ranks]
    f_check_run(f"Figure 3 k={F_RANKS}", runs, F_K20_STEPS,
                model_colls(F_RANKS, 0.0, F_K20_STEPS, 1, d),
                w_diff(runs, sim20), FIT_ATOL)
    f_check_audit(f"Figure 3 k={F_RANKS}", ranks[0]["k20 audit"], 3)
    for label, i, kw in F_K4:
        nu = arrays[f"nu{i}"]
        chunks = -(-kw["num_iters"] // kw["record_every"])
        runs = [r[label] for r in ranks[:4]]
        f_check_run(label, runs, kw["num_iters"],
                    model_colls(4, nu, kw["num_iters"], chunks,
                                arrays[f"xp{i}"].shape[1]),
                    w_diff(runs, sims[label]), FIT_ATOL)
        f_check_audit(label, ranks[0][label + " audit"], 29 if nu else 3)

    # the serving chunk's placements
    steps = F_SERVE["chunks"] * F_SERVE["chunk_steps"]
    s, k, m = F_SERVE["lanes"], F_SERVE["k"], F_SERVE["n_pad"] // F_SERVE["k"]
    serve_model = dist.ServeCommModel(k=k, num_slots=s, nu_rounds_per_iter=0)
    want = Counter({key: n * steps for key, n in
                    serve_model.collective_multiset().items()})
    for key, n in serve_model.per_chunk_multiset(F_SERVE["d"]).items():
        want[key] += n * F_SERVE["chunks"]
    pts = [r["points"] for r in ranks[:k]]
    weights = np.concatenate([p["weights"] for p in pts], axis=1)
    u = np.concatenate([p["u"] for p in pts], axis=1)
    errs = {"w": max(float(abs(p["w"] - whole["w"]).max()) for p in pts),
            "dual weights": float(abs(weights - whole["weights"]).max()),
            "u": float(abs(u - whole["u"]).max())}
    print(f"  points vs unsharded: max differences {errs}")
    f_check_run("serving chunk, points", pts, steps, dict(want),
                max(errs.values()), REF_ATOL)
    f_check_audit("serving points", ranks[0]["points audit"],
                  serve_model.collectives_per_iteration())
    lanes_ = [r["lanes"] for r in ranks[:k]]
    same = {f: np.array_equal(np.concatenate([q[f] for q in lanes_]),
                              whole[f])
            for f in ("w", "weights", "u", "healthy")}
    same["obj"] = np.array_equal(
        np.concatenate([q["obj"] for q in lanes_], axis=1), whole["obj"])
    print(f"  lanes vs unsharded, bit for bit: {same}")
    f_check_run("serving chunk, lanes", lanes_, steps, {},
                0.0 if all(same.values()) else math.inf, 0.0)
    f_check_audit("serving lanes", ranks[0]["lanes audit"], 0)
    drop = [r["dropped"] for r in ranks[:k]]
    lane, shard = F_SERVE["drop"]
    mates = [i for i in range(s) if i != lane]
    dw = np.concatenate([q["weights"] for q in drop], axis=1)
    kept = (np.array_equal(drop[0]["w"][mates], pts[0]["w"][mates])
            and np.array_equal(dw[mates], weights[mates])
            and np.array_equal(drop[0]["obj"][:, mates],
                               pts[0]["obj"][:, mates]))
    print(f"  drop_slot_shard lane {lane} shard {shard}: batch-mates "
          f"bit-equal {kept}; the lane's dropped weights all 0 "
          f"{bool((dw[lane, shard * m:(shard + 1) * m] == 0).all())}")
    require(kept and (dw[lane, shard * m:(shard + 1) * m] == 0).all(),
            "path f drop_slot_shard")


# ---------------------------------------------------------------- path p
# Sharded training (``models.sharding``, ``launch.train --ranks``) on ranks
# 0-7 of path f's spawn (no start-up of its own), laid out (data 2, model
# 4) by ``launch.mesh.make_test_mesh``; the other 12 ranks have ended
# their part by then.  p1 trains h2o-danube-1.8b at full width with path
# m1's settings; its losses wait for m1's (path m) to be compared.  p2
# replays launch.train's reduced runs on the CPU here.
P_RANKS = 8
P_STEPS = 2
P_LOSS_ATOL = 1e-2          # p1 vs m1: bf16 sums in other orders
P_REPLAY = ("h2o-danube-1.8b", "gemma-7b")
P_REPLAY_ATOL = 1e-5        # p2's parameters, where step 1's grad is big
P_LAYOUT = ("2x4", ("data", "model"), (2, 4))


def sharded_train(mesh, argv: list, steps: int) -> dict:
    """``train_lm.Trainer(argv, mesh=)`` on this rank (None: unsharded) for
    ``steps`` steps: its set-up seconds, bytes (and the dry-run's count
    for its layout),
    each step's loss and seconds, step 1's collectives (traced), peak
    memory, its first MoE layer's expert block shape (None without one)
    and, on rank 0 (every rank without a mesh), each MoE layer's dropped
    choices of step 1 over the whole batch (``moe_drops``).  The trainer
    is freed before it returns."""
    import torch

    from repro_torch.examples import train_lm
    from repro_torch.launch import specs
    from repro_torch.utils import dispatch_trace

    def nbytes(tensors) -> int:
        return sum(t.numel() * t.element_size() for t in tensors)

    out = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = train_lm.Trainer(train_lm.parse_args(argv), mesh=mesh)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    st = tr.state.opt_state
    out["bytes"] = {"params": nbytes(tr.state.model.parameters()),
                    "master": nbytes(st.master.values()),
                    "m": nbytes(st.m.values()), "v": nbytes(st.v.values())}
    out["want"] = (None if mesh is None else
                   specs.train_state_bytes_per_device(tr.cfg, mesh.layout))
    experts = [b.mlp.expert_gate for b in tr.state.model.layers
               if hasattr(b.mlp, "expert_gate")]
    out["expert_block"] = tuple(experts[0].shape) if experts else None
    losses, secs = [], []
    for i in range(steps):
        batch = tr.batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:            # step 1's collectives; the others untraced
            with dispatch_trace.Trace() as trace:
                tr.state, m = tr.train_step(tr.state, batch)
                losses.append(float(m["loss"]))
            stats = trace.collective_stats()
            out["collectives"] = {"count": stats.count_by_op,
                                  "bytes": stats.bytes_by_op}
            drops = moe_drops(tr.state.model,
                              tr.pipe.batch_size * tr.pipe.seq_len)
            if mesh is None or mesh.rank == 0:
                out["drops"] = drops
        else:
            tr.state, m = tr.train_step(tr.state, batch)
            losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    out.update(losses=losses, step_s=secs,
               peak=torch.cuda.max_memory_allocated())
    del tr, st, m
    torch.cuda.empty_cache()
    return out


def moe_drops(model, tokens: int) -> list:
    """Each MoE layer's dropped choices of its last forward (``MoE.dropped``)
    over the whole batch of ``tokens`` tokens, as numpy (groups, tokens a
    group x top-k): all-gathered over ``data`` where each rank routed its
    own groups (a collective: every rank of the mesh calls it)."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models import sharding as shd

    groups = moe.num_groups(tokens)
    out = []
    for block in model.layers:
        if isinstance(block.mlp, moe.MoE):
            d = block.mlp.dropped.to(torch.float32)
            if d.shape[0] != groups:
                d = shd.all_gather(d, "data", 0)
            out.append(d.bool().cpu().numpy())
    return out


def sharded_replays(mesh, tmp: str, label: str, archs) -> dict:
    """``launch.train``'s reduced trainer of each of ``archs`` on this
    rank for P_STEPS steps: its losses by ``"{label} {arch}"``; rank 0
    writes the whole starting and final weights to ``tmp`` for the
    parent's replay."""
    import numpy as np
    import torch

    from repro_torch.launch import train as launch_train
    from repro_torch.models import sharding as shd

    out = {}
    for arch in archs:
        tr = launch_train.make_trainer(launch_train.parse_args(
            ["--arch", arch, "--steps", str(P_STEPS)]), mesh)
        model = tr.state.model
        init = {n: shd.whole(p).cpu().numpy()
                for n, p in model.named_parameters()}
        out[f"{label} {arch}"] = tr.train(P_STEPS)["loss"]
        final = {n: shd.whole(p).cpu().numpy()
                 for n, p in model.named_parameters()}
        if mesh.rank == 0:
            np.savez(Path(tmp) / f"{label} {arch} init.npz", **init)
            np.savez(Path(tmp) / f"{label} {arch} final.npz", **final)
        del tr, model
    shd.set_mesh_axes(None)
    torch.cuda.empty_cache()
    return out


def p_rank(mesh, tmp: str) -> dict:
    """Path p on one rank of its mesh (see P_RANKS)."""
    t_path = time.perf_counter()
    out = {"rank": mesh.rank, "layout": tuple(mesh.layout),
           "device_mesh": mesh.device_mesh is not None}
    out.update(sharded_train(mesh, M_TRAIN, P_STEPS))
    out["p1_s"] = time.perf_counter() - t_path
    out.update(sharded_replays(mesh, tmp, "p2", P_REPLAY))
    out["p_s"] = time.perf_counter() - t_path
    return out


def p_replay(torch, arch: str, init: dict, final: dict, got: list, card,
             label: str = "p2", param_atol: float = P_REPLAY_ATOL) -> None:
    """p2 (or q2, ``label``) on the CPU: ``launch.train``'s unsharded
    trainer from the card's starting weights, its losses (P_REPLAY_ATOL,
    relative) and final parameters (``param_atol``) against the card's
    sharded run."""
    import numpy as np

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.train import optimizer as opt, steps

    args = launch_train.parse_args(["--arch", arch, "--steps", str(P_STEPS),
                                    "--device", "cpu"])
    cpu = launch_train.make_trainer(args)
    model = cpu.state.model
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(init[n]))
    cpu.state = steps.TrainState(model, opt.init(model, cpu.ocfg))
    first = TokenPipeline(cpu.cfg.vocab_size, args.seq, args.batch,
                          seed=0).next_batch()
    _, _, g = steps.value_and_grad(model, cpu.cfg, {
        "tokens": torch.as_tensor(first.tokens),
        "targets": torch.as_tensor(first.targets)})
    grads = {n: t.detach().clone() for n, t in g.items()}
    ref = cpu.train(P_STEPS)["loss"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    perr = 0.0
    for n, p in model.named_parameters():
        big = grads[n].abs() > 1e-3 * grads[n].abs().max()
        diff = (torch.from_numpy(final[n]) - p.detach())[big]
        if diff.numel():
            perr = max(perr, float(diff.abs().max()))
    print(f"{label} {arch} (reduced, float32, {P_STEPS} steps, sharded "
          f"{P_LAYOUT[0]} on the card / unsharded on the CPU): losses "
          f"{got!r} / {ref!r} (largest relative difference {rel:.3e}, tol "
          f"{P_REPLAY_ATOL:g}); final parameters {perr:.3e} where step 1's "
          f"|g| > 1e-3 of its leaf's max (tol {param_atol:g}) [{card}]")
    require(rel <= P_REPLAY_ATOL and perr <= param_atol,
            f"{label} {arch}: the sharded run on the card differs from the "
            "CPU's")
    require(bool(np.isfinite(got).all()),
            f"{label} {arch}: a non-finite loss")


def check_sharded_train(label: str, rs: list, card: str) -> dict:
    """The holds of a ``sharded_train`` run (p1, q1) that need nothing but
    the ranks' results: each rank's bytes against the dry-run, its losses
    and collectives equal to rank 0's; prints each rank's figures and
    rank 0's collectives by kind.  Returns rank 0's result."""
    from repro_torch.launch import mesh as meshlib

    r0 = rs[0]
    layout = meshlib.Layout(*P_LAYOUT)
    for r in rs:
        print(f"{label} rank {r['rank']}: bytes {r['bytes']} (dry-run "
              f"{r['want']}); set up {r['setup_s']:.2f} s; steps "
              f"{[round(s * 1e3, 1) for s in r['step_s']]} ms (step 1 "
              f"traced); peak memory {r['peak'] / 1e9:.2f} GB [{card}]")
        require(r["bytes"] == r["want"], f"{label} rank {r['rank']}: its "
                f"bytes {r['bytes']} are not the dry-run's {r['want']} for "
                f"{layout.name}")
        require(r["losses"] == r0["losses"] and r["collectives"]["count"]
                == r0["collectives"]["count"],
                f"{label} rank {r['rank']}: its losses or collectives "
                "differ from rank 0's")
    colls = r0["collectives"]
    print(f"{label} collectives of step 1 on rank 0 (dispatch_trace): "
          + ", ".join(f"{k} {n} ({colls['bytes'][k] / 1e6:.1f} MB)"
                      for k, n in sorted(colls["count"].items())))
    require(sum(colls["count"].values()) > 0, f"{label}: no collective "
            "counted")
    return r0


def p_check(torch, ranks, files: dict) -> dict:
    """Path p's holds that need nothing but the ranks' results: p1's bytes
    against the dry-run, its losses equal on every rank, its collectives;
    then p2's replays.  Returns p1's losses for path m's comparison."""
    card = card_line()
    rs = [r["p"] for r in ranks[:P_RANKS]]
    r0 = rs[0]
    require(r0["layout"] == P_LAYOUT, f"p: layout {r0['layout']}")
    print(f"p: {P_LAYOUT[0]} mesh of gloo ranks on the card, its DeviceMesh "
          f"made on {sum(r['device_mesh'] for r in rs)} of {len(rs)} ranks "
          f"[{card}]")
    check_sharded_train("p1", rs, card)
    ms = max(r["step_s"][-1] for r in rs) * 1e3
    print(f"p1: losses {r0['losses']!r}; step 2 {ms:.1f} ms (the slowest "
          f"rank); p1 {max(r['p1_s'] for r in rs):.1f} s, path p "
          f"{max(r['p_s'] for r in rs):.1f} s on the ranks [{card}]")
    for arch in P_REPLAY:
        got = r0[f"p2 {arch}"]
        require(all(r[f"p2 {arch}"] == got for r in rs),
                f"p2 {arch}: the ranks' losses differ")
        p_replay(torch, arch, files[f"p2 {arch} init"],
                 files[f"p2 {arch} final"], got, card)
    return {"losses": r0["losses"]}


def p_versus_m1(p1: dict, m1_losses: list) -> None:
    """p1's two losses against m1's first two (the same weights and
    batches, unsharded)."""
    gap = max(abs(a - b) for a, b in zip(p1["losses"], m1_losses))
    print(f"p1 vs m1: losses {p1['losses']!r} sharded / "
          f"{m1_losses[:P_STEPS]!r} unsharded, largest gap {gap:.3e} (tol "
          f"{P_LOSS_ATOL:g})")
    require(gap <= P_LOSS_ATOL, "p1: the sharded losses differ from m1's")


# ---------------------------------------------------------------- path q
# Sharded training of the DeepSeek-V2 family (``models.sharding``: MLA's
# heads, the MoE's router logits and experts over ``model``, the routing
# groups the whole batch's) on path p's mesh, after path p in path f's
# spawn (no start-up of its own).  q1 trains deepseek-v2-lite-16b at its
# published widths (d_model 2,048, 64 experts top-6, 2 shared, MLA lora
# 512, vocabulary 102,400) with its depth cut from 27 layers to 3 (1 dense,
# 2 MoE) so that 8 ranks' state fits the one card, at m1's B = 4, S = 1,024
# for 2 steps.  Its losses and each MoE layer's dropped choices of step 1
# are held to the same cut model trained unsharded on the card by rank 0
# after the others are done (same seed-0 weights and batches), and two
# planted faults, each one step, must break that hold: every rank routing
# its own 2 rows' tokens (32 groups of 64 at capacity 8, not of 128 at
# 15), and every rank running its experts on the next rank's slots.  q2
# replays launch.train's reduced runs of both DeepSeek-V2 configs on the
# CPU here, as p2 does.  No kernel is on this path.
Q_LAYERS = 3
Q_TRAIN = ["--full", "--arch", "deepseek-v2-lite-16b", "--layers",
           str(Q_LAYERS), "--batch", "4", "--seq", "1024"]
Q_EXPERT_BLOCK = (16, 1024, 1408)  # 64 / 4 experts, 2,048 / 2 rows of D
# q1 vs unsharded, bf16 sums in other orders: losses 3.2e-5 to 5.1e-4
# apart and 107 / 222 of a layer's 24,576 choices dropped differently in
# runs of this script on an H100 80GB HBM3 at 700 W (the planted faults:
# losses 9.9e-4 / 5.6e-3 apart, drops over other groups / 2,512 differing)
Q_LOSS_ATOL = 2e-3
Q_DROP_DIFF = 1000
Q_FAULTS = ("own rows' groups", "experts on the next rank's slots")
Q_REPLAY = ("deepseek-v2-lite-16b", "deepseek-v2-236b")
# 236b keeps m and v in bf16.  Step 1's update reads m and v before their
# rounding; step 2's reads the rounded ones, so where the card and the CPU
# round a grad's moment to neighbouring bf16 values (2^-8 apart, relative)
# step 2's update moves by at most b1 x 2^-8 x |m1| / ((1 - b1^2)
# sqrt(v-hat)) <= 0.9 x 2^-8 x 0.76 (m) plus 2^-9 x |update| <= 2^-9 x 1.01
# (v), times step 2's learning rate (2 / 10 warm-up steps x 1e-3): 9.2e-7.
# The losses (each before its step's update) do not see it.
Q_BF16_SLACK = 2.0e-4 * (0.9 * 2.0 ** -8 * 0.76 + 2.0 ** -9 * 1.01)


def q_rank(mesh, tmp: str) -> dict:
    """Path q on one rank of path p's mesh (see Q_TRAIN), its kernel
    launches counted from 0 (none expected); then, on rank 0 alone, q1's
    model and batches unsharded (``sharded_train`` without a mesh: its
    losses and step 1's drops), so that the parent's CUDA state before
    the paths after f is what it was without path q."""
    from repro_torch.kernels import ops

    ops.launch_counts.clear()
    t_path = time.perf_counter()
    out = {"rank": mesh.rank, "layout": tuple(mesh.layout)}
    out.update(sharded_train(mesh, Q_TRAIN, P_STEPS))
    out["q1_s"] = time.perf_counter() - t_path
    for fault in Q_FAULTS:
        with q_planted(fault):
            r = sharded_train(mesh, Q_TRAIN, 1)
        out[fault] = {"losses": r["losses"], "drops": r.get("drops")}
    out["faults_s"] = time.perf_counter() - t_path - out["q1_s"]
    out.update(sharded_replays(mesh, tmp, "q2", Q_REPLAY))
    out["q_s"] = time.perf_counter() - t_path
    if mesh.rank == 0:
        t0 = time.perf_counter()
        out["twin"] = sharded_train(None, Q_TRAIN, P_STEPS)
        out["twin"]["s"] = time.perf_counter() - t0
    out["launches"] = dict(ops.launch_counts)
    return out


@contextlib.contextmanager
def q_planted(fault: str):
    """One of Q_FAULTS planted in the MoE while the block runs."""
    from repro_torch.models import sharding as shd

    name = "batch_layout" if fault == Q_FAULTS[0] else "offset"
    right = getattr(shd, name)

    def own_rows(rows, whole):
        return rows, 0

    def next_rank(p, dim):
        full = getattr(p, "full_shape", p.shape)
        if p.dim() == 3 and dim == 0 and p.shape[0] < full[0]:   # experts
            return (right(p, dim) + p.shape[0]) % full[0]
        return right(p, dim)

    setattr(shd, name, own_rows if name == "batch_layout" else next_rank)
    try:
        yield
    finally:
        setattr(shd, name, right)


def q_drops(sharded: list, twin: list) -> tuple:
    """Step 1's dropped choices of each MoE layer, sharded against the
    unsharded twin: whether every layer's are over the same (groups,
    choices), and (dropped in each, choices that differ) a layer."""
    require(len(sharded) == len(twin) >= 1, f"q1: {len(sharded)} / "
            f"{len(twin)} MoE layers' drops")
    same = all(a.shape == b.shape for a, b in zip(sharded, twin))
    return same, [(int(a.sum()), int(b.sum()),
                   int((a != b).sum()) if same else None)
                  for a, b in zip(sharded, twin)]


def q_holds(losses: list, drops: list, twin: dict) -> tuple:
    """q1's hold against the twin: (whether it holds, the largest loss
    gap, the drops' shapes agree, (dropped, dropped, differ) a layer)."""
    gap = max(abs(a - b) for a, b in zip(losses, twin["losses"]))
    same, layers = q_drops(drops, twin["drops"])
    ok = (gap <= Q_LOSS_ATOL and same
          and all(n <= Q_DROP_DIFF for *_, n in layers))
    return ok, gap, same, layers


def q_check(torch, ranks, files: dict) -> None:
    """Path q's holds: q1's bytes against the dry-run, its expert blocks,
    its losses equal on every rank and within Q_LOSS_ATOL of the unsharded
    run (rank 0's twin), each MoE layer's drops of step 1 over the same
    (groups, choices) as the twin's and differing in at most Q_DROP_DIFF
    of them, each planted fault refused by that hold; q2's replays on the
    CPU."""
    import numpy as np

    card = card_line()
    t0 = time.perf_counter()
    rs = [r["q"] for r in ranks[:P_RANKS]]
    r0 = rs[0]
    require(r0["layout"] == P_LAYOUT, f"q: layout {r0['layout']}")
    check_sharded_train("q1", rs, card)
    for r in rs:
        require(r["expert_block"] == Q_EXPERT_BLOCK,
                f"q1 rank {r['rank']}: expert block {r['expert_block']}, "
                f"not {Q_EXPERT_BLOCK}")
        require(not r["launches"], f"q rank {r['rank']}: kernel launches "
                f"{r['launches']} on the LM path")
    ms = [round(max(r["step_s"][i] for r in rs) * 1e3, 1)
          for i in range(P_STEPS)]
    print(f"q1: expert block {r0['expert_block']} a rank; losses "
          f"{r0['losses']!r}; ms a step {ms} (the slowest rank, step 1 "
          f"traced); peak memory {max(r['peak'] for r in rs) / 1e9:.2f} GB "
          f"(the largest rank); q1 {max(r['q1_s'] for r in rs):.1f} s, "
          f"path q {max(r['q_s'] for r in rs):.1f} s on the ranks; launches "
          f"on the ranks {[r['launches'] for r in rs]} [{card}]")
    require(bool(np.isfinite(r0["losses"]).all()), "q1: a non-finite loss")
    twin = r0["twin"]
    print(f"q1 unsharded on the card (rank 0): {Q_TRAIN}, "
          f"{sum(twin['bytes'].values()):,} B of parameters and AdamW "
          f"state; losses {twin['losses']!r}; steps "
          f"{[round(x * 1e3, 1) for x in twin['step_s']]} ms; peak memory "
          f"{twin['peak'] / 1e9:.2f} GB; {twin['s']:.1f} s [{card}]")
    ok, gap, _, drops = q_holds(r0["losses"], r0["drops"], twin)
    print(f"q1 vs unsharded: losses {r0['losses']!r} sharded / "
          f"{twin['losses']!r} unsharded, largest gap {gap:.3e} (tol "
          f"{Q_LOSS_ATOL:g}); step 1's drops a MoE layer over "
          f"{r0['drops'][0].shape} (groups, choices): "
          + "; ".join(f"{a} sharded, {b} unsharded, {n} differ"
                      for a, b, n in drops)
          + f" (tol {Q_DROP_DIFF})")
    require(ok, "q1: the sharded run's losses or drops differ from the "
            "unsharded run's")
    for fault in Q_FAULTS:
        f = r0[fault]
        ok, gap, same, drops = q_holds(f["losses"], f["drops"], twin)
        print(f"q1 planted fault, {fault} (step 1): loss gap {gap:.3e}; "
              f"drops over {[d.shape for d in f['drops']]}, differing "
              f"{[n for *_, n in drops]}: the hold "
              f"{'passes' if ok else 'fails'}")
        require(not ok, f"q1: the planted fault ({fault}) passes q1's hold")
    print(f"q1 planted faults: {max(r['faults_s'] for r in rs):.1f} s on "
          "the ranks")
    for arch in Q_REPLAY:
        got = r0[f"q2 {arch}"]
        require(all(r[f"q2 {arch}"] == got for r in rs),
                f"q2 {arch}: the ranks' losses differ")
        slack = Q_BF16_SLACK if arch == "deepseek-v2-236b" else 0.0
        p_replay(torch, arch, files[f"q2 {arch} init"],
                 files[f"q2 {arch} final"], got, card, label="q2",
                 param_atol=P_REPLAY_ATOL + slack)
    print(f"path q in the parent: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------- path g
# The fit service over a process group: SolverService(mesh=ClientGroup),
# one process a rank, rank 0 the front end, step()/run() collective.  On
# path f's 2-rank gloo subgroup (the ranks share the card): path e's
# tenants, all lane-placed (4 whole lanes a rank), beside two point-sharded
# fits above G_SHARD_ABOVE points (Figure 2's data, and hard margin at n =
# 20,000); run 1 cancels a lane and the point-sharded nu fit once they
# run, run 2 poisons a lane at its chunk 2 and the point-sharded hard
# margin at its chunk 1.  Budgets cut from path e's 640-1,280 steps to
# 128-320; widths as path e's and path a's.  In the parent, a one-rank
# NCCL group's service on four of path e's tenants (one point-sharded at
# k = 1), bit-equal to path e.
G_SHARD_ABOVE = 9000
G_HM = [(n, 100 + i, 192 + 64 * (i % 3))         # n, seed, budget
        for i, n in enumerate((3000, 5000, 8000) * 4)]
G_NU = [(200 + i, 128 + 64 * i) for i in range(4)]   # seed, budget
G_POINTS = (("points hard-margin n=20000 d=256", "separable", (20_000, 256),
             dict(seed=20_000), dict(seed=400, num_iters=256)),
            ("points nu-SVM n=50000 d=512", "non_separable", (50_000, 512),
             dict(beta2=0.2, seed=50_000), dict(seed=401, num_iters=128)))
G_LANE = "hard-margin #{} n={} d=256".format
G_CANCEL = {G_LANE(1, G_HM[1][0]): 2,          # label: running steps
            G_POINTS[1][0]: 1}
G_POISON = {G_LANE(4, G_HM[4][0]): 2,          # label: at_chunk
            G_POINTS[0][0]: 1}
G_NCCL = (0, 1, 2, 12)        # path e's requests run again at k = 1
G_POINTS_ATOL = 1e-4          # point-sharded vs solo (tests/test_mesh_...)


def g_requests():
    """Path g's tenants in submission order: (label, data, FitRequest
    keyword arguments)."""
    from repro_torch.core.svm import split_classes
    from repro_torch.data import synthetic

    reqs = [(G_LANE(i, n), synthetic.separable(n, 256, seed=i),
             dict(seed=seed, num_iters=iters))
            for i, (n, seed, iters) in enumerate(G_HM)]
    fig4 = synthetic.non_separable(6000, 512, beta2=0.25, seed=512)
    xp, xm = split_classes(fig4.x, fig4.y)
    nu = 1.0 / (0.85 * min(len(xp), len(xm)))
    reqs += [(f"nu-SVM seed={seed} n=6000 d=512", fig4,
              dict(seed=seed, num_iters=iters, nu=nu))
             for seed, iters in G_NU]
    for label, kind, shape, dkw, kw in G_POINTS:
        ds = getattr(synthetic, kind)(*shape, **dkw)
        if kind == "non_separable":
            xp, xm = split_classes(ds.x, ds.y)
            kw = dict(kw, nu=1.0 / (0.85 * min(len(xp), len(xm))))
        reqs.append((label, ds, kw))
    return reqs


def g_drive(svc, reqs, cancel: dict) -> tuple:
    """Rank 0: submit ``reqs``, step until the service has drained,
    cancelling each request of ``cancel`` once it has been running for its
    count of steps; then ``run`` (its last plan stops the other ranks).
    Returns ({label: rid}, {label: outcome})."""
    from repro_torch.serve.scheduler import Status
    from repro_torch.serve.solver_service import FitRequest

    rids = {label: svc.submit(FitRequest(x=ds.x, y=ds.y, **kw))
            for label, ds, kw in reqs}
    running, cancel = Counter(), dict(cancel)
    while svc._sched.has_work():
        svc.step()
        for label in list(cancel):
            if svc.status(rids[label]) is Status.RUNNING:
                running[label] += 1
                if running[label] == cancel[label]:
                    require(svc.cancel(rids[label]),
                            f"path g: cancel of {label} failed")
                    del cancel[label]
    require(not cancel, f"path g: {sorted(cancel)} never ran")
    out = svc.run()
    return rids, {label: out[rid] for label, rid in rids.items()}


def g_rank(group, reqs) -> dict:
    """What each rank of path g's 2-rank group runs: the two runs (each a
    fresh service; counts reset just before the first and read after the
    second) and a short profiled run of one chunk a group.  Every rank
    records its packed calls by shape and copies the arguments of the
    second step of each configuration's first chunk in run 2 in which it
    holds a live lane (rank 0 also of the chunk after the poison) to the
    host, for phase 5."""
    import torch

    from repro_torch.core import engine
    from repro_torch.kernels import ops
    from repro_torch.serve.faults import Fault, FaultInjector, FaultPlan
    from repro_torch.serve.solver_service import SolverService
    from repro_torch.utils import comm_audit

    rec = PathRecorder(f"g rank {group.rank}", keep=False)
    run_chunk = engine.run_chunk_slots_sharded
    state = dict(seen=set(), fired=0, inj=None, chunk_s=[], arm=False)

    def chunk(st, x_t, sign, sp, num_steps, **kw):
        cfg = (tuple(x_t.shape), kw["placement"], kw["project"])
        inj = state["inj"]
        if state["arm"] and bool(st.active.any()):
            if cfg not in state["seen"]:
                state["seen"].add(cfg)
                rec.arm(f"first chunk of {kw['placement']} "
                        f"n_pad={x_t.shape[2]},d={x_t.shape[1]}"
                        f"{',nu' if kw['project'] else ''}")
            elif inj is not None and len(inj.fired) > state["fired"]:
                rec.arm("chunk after the poison")
            state["fired"] = 0 if inj is None else len(inj.fired)
        t = time.perf_counter()
        out = run_chunk(st, x_t, sign, sp, num_steps, **kw)
        state["chunk_s"].append((cfg, time.perf_counter() - t))
        return out

    def service(mesh, injector=None):
        return SolverService(num_slots=SERVE_SLOTS, chunk_steps=SERVE_CHUNK,
                             mesh=mesh, shard_points_above=G_SHARD_ABOVE,
                             shard_num_slots=2, fault_injector=injector)

    runs = []
    ops.launch_counts.clear()
    engine.run_chunk_slots_sharded = chunk
    try:
        with rec:
            for poison in (False, True):
                inj = None
                if poison:
                    rids = runs[0]["rids"] if group.rank == 0 else {}
                    inj = FaultInjector(FaultPlan(seed=0, faults=tuple(
                        Fault("poison", rid=rids.get(label, -1),
                              at_chunk=at) for label, at in
                        G_POISON.items())))
                state.update(inj=inj, fired=0, chunk_s=[], arm=poison)
                audit = comm_audit.Recorder()
                keys = set(engine.trace_counts)
                tally = Counter(engine.collective_counts)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated() - workspace_bytes()
                svc = service(group._replace(recorder=audit), inj)
                t0 = time.perf_counter()
                if group.rank == 0:
                    rids, res = g_drive(svc, reqs, {} if poison
                                        else G_CANCEL)
                else:
                    rids, res = {}, svc.run()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                mem = torch.cuda.memory_allocated() - workspace_bytes()
                runs.append(dict(
                    rids=rids, res=res, secs=secs, stats=svc.rank_stats,
                    new_keys=sorted(map(str, set(engine.trace_counts)
                                        - keys)),
                    tally=dict(Counter(engine.collective_counts) - tally),
                    coll_s=audit.seconds, mem=(base, mem),
                    chunk_s=state["chunk_s"],
                    fired=None if inj is None else len(inj.fired)))
                del svc
    finally:
        engine.run_chunk_slots_sharded = run_chunk
    counts = dict(ops.launch_counts)

    # one chunk of two lane-placed and one point-sharded hard-margin fit
    # under the profiler: all-reduces and the service's own calls
    short = [r for r in reqs if r[0].startswith("hard-margin #")][:2] + [
        r for r in reqs if r[0] == G_POINTS[0][0]]

    def profiled(g):
        svc = service(g)
        if g.rank == 0:
            g_drive(svc, [(lb, ds, dict(kw, num_iters=SERVE_CHUNK))
                          for lb, ds, kw in short], {})
        else:
            svc.run()
        return svc

    audit = comm_audit.audit_service(group, profiled)
    for run in runs:
        run["model"] = comm_audit.service_model(run["stats"]["keys"])
        run["points_chunks"] = sum(
            v for k, v in run["stats"]["keys"].items()
            if k[-2:-1] == ("points",))
        run["stats"]["keys"] = {str(k): v
                                for k, v in run["stats"]["keys"].items()}
    return dict(runs=runs, audit=audit, counts=counts,
                rec=rec.host_copy())


def g_parent(torch, g1, serve, rec) -> dict:
    """Path g in the parent: a one-rank NCCL group's service (lanes, and
    point-sharded above 6,000 points with 8 lanes, whose bucket at k = 1
    is the meshless one) on path e's requests G_NCCL, each bit-equal to
    path e's result (run 2's where run 1 cancelled it)."""
    import numpy as np

    from repro_torch.serve.solver_service import FitRequest, SolverService

    reqs, _ = serve_requests()
    picked = [reqs[i] for i in G_NCCL]
    svc = SolverService(num_slots=SERVE_SLOTS, chunk_steps=SERVE_CHUNK,
                        mesh=g1, shard_points_above=6000,
                        shard_num_slots=SERVE_SLOTS)
    rec.arm("NCCL k=1 service")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = {label: svc.submit(FitRequest(x=ds.x, y=ds.y, **kw))
            for label, ds, kw in picked}
    out = svc.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st = svc.rank_stats
    same = {}
    for label, _, _ in picked:
        run = serve["runs"][1 if label == reqs[SERVE_CANCEL][0] else 0]
        a, b = run["res"][label], out[rids[label]]
        same[label] = (np.array_equal(a.w, b.w)
                       and (a.b, a.objective, a.iterations, a.history)
                       == (b.b, b.objective, b.iterations, b.history))
    points = sorted(str(k) for k in st["keys"] if k[-2:] == ("points", 1))
    print(f"path g NCCL k=1 ({card_line()}): {len(out)} requests in "
          f"{secs:.3f} s ({len(out) / secs:.3f} requests/s), "
          f"{st['chunk_calls']} chunks, set-ups {st['compiles']}, "
          f"point-sharded configurations {points}; bit-equal to path e: "
          f"{same}")
    require(all(same.values()) and points, "path g NCCL k=1: the service "
            "differs from the meshless one")
    return dict(secs=secs, stats=st)


def g_check(torch, ranks, nccl) -> None:
    """Path g's holds, from both ranks' records (see g_rank)."""
    import numpy as np

    from repro_torch.core import preprocess as pp
    from repro_torch.serve.scheduler import RequestFailure, Status

    card = card_line()
    reqs = g_requests()
    first, second = (ranks[0]["runs"][i]["res"] for i in range(2))
    for i in range(2):
        kind = "cancels" if i == 0 else "poisons"
        done = [r for r in ranks[0]["runs"][i]["res"].values()
                if not isinstance(r, RequestFailure)]
        secs = ranks[0]["runs"][i]["secs"]
        print(f"path g run {i + 1} ({kind}, {card}): {len(done)} of "
              f"{len(reqs)} requests completed in {secs:.3f} s, "
              f"{len(done) / secs:.3f} requests/s")
        for r, rank in enumerate(ranks):
            run = rank["runs"][i]
            st = run["stats"]
            calls = st["chunk_calls"]
            steps = calls * SERVE_CHUNK
            pts = max(run["points_chunks"], 1) * SERVE_CHUNK
            per_cfg = {}
            for cfg, t in run["chunk_s"]:
                per_cfg.setdefault(cfg, []).append(t)
            traffic = ", ".join(
                f"{k} {v['seconds'] / steps * 1e3:.4f} ms a step "
                f"({v['calls']} calls, {v['bytes']} bytes)"
                for k, v in st["traffic"].items())
            chunk_ms = run["secs"] / calls * 1e3
            print(f"  rank {r}: {calls} chunks, {chunk_ms:.3f} ms a chunk "
                  "of wall; the chunk call (host, no sync) "
                  + ", ".join(f"{c[1]} n_pad={c[0][2]},d={c[0][1]}"
                              f"{',nu' if c[2] else ''}: "
                              f"{statistics.fmean(v) * 1e3:.3f} x {len(v)}"
                              for c, v in sorted(per_cfg.items()))
                  + f"; the service's traffic: {traffic}; the chunks' "
                  f"all-reduces {run['coll_s'] / steps * 1e3:.4f} ms a step "
                  f"of host, {run['coll_s'] / pts * 1e3:.4f} ms a "
                  f"point-sharded step ({sum(run['tally'].values())} calls); "
                  f"set-ups "
                  f"{st['compiles']} (new keys {len(run['new_keys'])}); "
                  f"device memory (workspace left out) {run['mem'][0]} "
                  f"bytes before, {run['mem'][1]} after the drain, held "
                  f"{st['held_bytes']}")
            require(run["mem"][0] == run["mem"][1] and not st["held_bytes"],
                    f"path g run {i + 1} rank {r}: device memory not back "
                    "to its base after the drain")
            require(Counter(run["tally"]) == Counter(run["model"]),
                    f"path g run {i + 1} rank {r}: tallied "
                    f"{run['tally']}, ServeCommModel {run['model']}")
            require(st["compiles"] == len(run["new_keys"]),
                    f"path g rank {r}: set-ups and new keys disagree")
            if i:
                require(not run["new_keys"] and not st["compiles"],
                        f"path g run 2 rank {r}: new set-ups "
                        f"{run['new_keys']}")
    for r, rank in enumerate(ranks):
        a = rank["audit"]
        print(f"  audit rank {r} (one chunk a group, profiled): all-reduces "
              f"{a['measured']} (model {a['predicted']}), match {a['match']}"
              f", hooks agree {a['hooks_agree']}; the service's calls "
              f"{a['service_calls']} (tallied {a['service_tally']})")
        require(a["match"] and a["hooks_agree"] and a["service_match"],
                f"path g rank {r}: the profiler's calls differ from the "
                "models")
    for label in G_CANCEL:
        res = first[label]
        require(isinstance(res, RequestFailure)
                and res.status is Status.CANCELLED
                and "running" in res.reason,
                f"path g: {label} was not cancelled while running: {res}")
    require(ranks[0]["runs"][1]["fired"] == len(G_POISON),
            "path g: a poison never fired")
    for label in G_POISON:
        res = second[label]
        require(isinstance(res, RequestFailure)
                and res.status is Status.FAILED
                and "non-finite" in res.reason,
                f"path g: {label} was not quarantined: {res}")
    mates = [label for label, _, _ in reqs
             if label not in G_CANCEL and label not in G_POISON]
    for label in mates:
        a, b = first[label], second[label]
        require(np.array_equal(a.w, b.w)
                and (a.b, a.objective, a.iterations, a.history)
                == (b.b, b.objective, b.iterations, b.history),
                f"path g: {label} differs between the runs")
    print(f"  {len(mates)} requests bit-equal in both runs: the cancelled "
          f"and the poisoned lanes (lane-placed and point-sharded) left "
          "their batch-mates alone")

    t0 = time.perf_counter()
    worst = {"lanes": 0.0, "points": 0.0}
    for label, ds, kw in reqs:
        got = first[label] if not isinstance(first[label], RequestFailure) \
            else second[label]
        pre = serve_pre(torch, ds.x, ds.y, kw["seed"])
        n = len(ds.y)
        points = n > G_SHARD_ABOVE
        bucket = ((2 * pp.bucket_length(-(-n // 2)), pre.xp.shape[1])
                  if points else None)
        res, w, b = serve_solo(torch, pre, pre.xp, pre.xm, kw, bucket)
        dw = float(np.abs(got.w - w).max())
        kind = "points" if points else "lanes"
        worst[kind] = max(worst[kind], dw)
        tol = G_POINTS_ATOL if points else SERVE_ATOL
        if points:
            print(f"  {label}: bucket {got.bucket}, max|dw| {dw:.3e}, |db| "
                  f"{abs(got.b - b):.3e} vs its solo solve at the bucket")
            require(abs(got.b - b) <= tol and got.bucket == bucket,
                    f"path g: {label}: b or bucket")
        require(dw <= tol and got.iterations == res.history[-1][0],
                f"path g: {label} vs its solo solve: max|dw| {dw:.3e}, "
                f"{got.iterations} vs {res.history[-1][0]} iterations")
    print(f"path g vs solo solves on the card ({len(reqs)} requests, "
          f"{time.perf_counter() - t0:.1f} s): lane-placed max|dw| "
          f"{worst['lanes']:.3e} (tol {SERVE_ATOL}), point-sharded "
          f"{worst['points']:.3e} (tol {G_POINTS_ATOL}); NCCL k=1 service "
          f"{nccl['secs']:.3f} s")


# ---------------------------------------------------------------- path h
# The paper's comparisons, at the full sizes of the JAX package's figure
# and table scripts (benchmarks/table1_hard_margin.py, fig1_nusvm_
# convergence.py, fig3_dist_hard_margin.py, table4_density.py), with
# depth cuts: Table 1's Saddle-SVC 2,000 steps (Theorem 6 gives 59,975;
# the JAX script's quick cap is 20,000, run here before; only its
# finiteness is checked), Figure 1's QP 1,000 iterations (JAX: 4,000 +
# 2,000) and its Saddle-SVC 3,000 steps (JAX: 12,000; 4,000 here before:
# the QP must end below it, so fewer steps would loosen that check).
H_EPS, H_BETA, H_ALPHA = 1e-3, 0.1, 0.85
H_TABLE1 = dict(n=10_000, d=512, seed=512, saddle_steps=2_000,
                gilbert_iters=20_000, tol=1e-6, record_every=200)
H_FIG1 = dict(n=20_000, d=128, beta2=0.2, qp_iters=1000, qp_every=200,
              saddle_steps=3000, saddle_every=500)
H_FIG3 = dict(n=10_000, d=256, k=20, iters=1500, every=300,
              hogwild_iters=2000)
H_TABLE4 = dict(n=100_000, d=128, fracs=(0.1, 0.5, 0.9), lam=1e-4,
                iters=4000, batch=32)
H_MDM = dict(n=2000, d=32, iters=3000)
H_REPLAY = 200           # steps replayed on the CPU (Gilbert, the SGDs)
H_QP_REPLAY = 20
H_PROFILE = 50           # iterations profiled (the QP's: 5)
MDM_GAP = 2e-3           # MDM vs Gilbert (tests/test_baselines.py:64-70)


def h_preprocess(torch, xp, xm):
    """Algorithm 1 on the card (the FWHT kernel), signs from seed 0 as the
    JAX scripts' jax.random.key(0)."""
    from repro_torch.core import preprocess as pp
    return pp.preprocess(xp, xm, generator=torch.Generator().manual_seed(0),
                         device="cuda")


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def libsvm_round_trip(ds):
    """``ds`` written by ``save_libsvm`` into a temporary directory and read
    back by ``load_libsvm``: the labels come back equal and the points
    equal, bit for bit, to the values the file states (the JAX package's
    format: 6 significant digits a value)."""
    import tempfile

    import numpy as np

    from repro_torch.data import libsvm

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "table1.libsvm")
        libsvm.save_libsvm(path, ds)
        size = Path(path).stat().st_size
        t1 = time.perf_counter()
        back = libsvm.load_libsvm(path, n_features=ds.x.shape[1])
    t2 = time.perf_counter()
    stated = np.concatenate([
        np.char.mod("%.6g", ds.x[i:i + 1000]).astype(np.float64).astype(
            np.float32) for i in range(0, len(ds.x), 1000)])
    rel = float((np.abs(back.x - ds.x) / np.abs(ds.x)).max())
    print(f"  libsvm: {size} bytes written in {t1 - t0:.2f} s, read in "
          f"{t2 - t1:.2f} s; the values as written differ from the data by "
          f"{rel:.3e} relative at most")
    require(back.x.dtype == np.float32 and back.x.shape == ds.x.shape
            and np.array_equal(back.x, stated)
            and np.array_equal(back.y, ds.y),
            "path h: load_libsvm does not give the written array")
    return back


def h_table1(torch, card):
    """h1, Table 1's full case: Saddle-SVC against Gilbert on
    separable(10000, 512) after a LIBSVM round trip."""
    from repro_torch.baselines import gilbert
    from repro_torch.core import saddle
    from repro_torch.core.svm import split_classes
    from repro_torch.data import synthetic

    c = H_TABLE1
    ds = libsvm_round_trip(synthetic.separable(c["n"], c["d"],
                                               seed=c["seed"]))
    pre = h_preprocess(torch, *split_classes(ds.x, ds.y))
    sad, sad_s = timed(torch, lambda: saddle.solve(
        pre.xp, pre.xm, eps=H_EPS, beta=H_BETA, num_iters=c["saddle_steps"],
        record_every=c["saddle_steps"] // 10, device="cuda"))
    gil, gil_s = timed(torch, lambda: gilbert.solve(
        pre.xp, pre.xm, num_iters=c["gilbert_iters"], tol=c["tol"],
        record_every=c["record_every"], device="cuda"))
    obj_s, obj_g = sad.history[-1][1], gil.history[-1][1]
    iters_g = gil.history[-1][0]
    print(f"h1 Table 1 n={c['n']} d={c['d']} ({card}): Saddle-SVC "
          f"{sad_s:.3f} s ({sad_s / c['saddle_steps'] * 1e3:.4f} ms/step, "
          f"{c['saddle_steps']} steps), objective {obj_s:.6g}; Gilbert "
          f"{gil_s:.3f} s ({gil_s / iters_g * 1e3:.4f} ms/iteration, "
          f"{iters_g} iterations, tol {c['tol']}), objective {obj_g:.6g}; "
          f"objective ratio saddle/gilbert {obj_s / obj_g:.6f}, time ratio "
          f"gilbert/saddle {gil_s / sad_s:.4f}")
    print(f"  Saddle-SVC history {sad.history}")
    print(f"  Gilbert history {gil.history}")
    objs = [o for _, o in gil.history]
    st = gil.state
    z_w = st.eta @ pre.xp - st.xi @ pre.xm
    sums = (st.eta.sum().item(), st.xi.sum().item())
    dz = (z_w - st.z).abs().max().item()
    print(f"  Gilbert: weight sums {sums}, max|z - (eta A - xi B)| {dz:.3e}")
    require(all(math.isfinite(o) for o in objs + [obj_s]),
            "h1: non-finite objective")
    require(not any(b > a for a, b in zip(objs, objs[1:])),
            "h1: Gilbert's objective rose")
    require(all(abs(s - 1.0) <= 1e-5 for s in sums),
            "h1: Gilbert's weights do not sum to 1")
    require(dz <= 1e-4, "h1: Gilbert's z does not equal its weights' point")
    card_g = gilbert.solve(pre.xp, pre.xm, num_iters=H_REPLAY,
                           device="cuda").state.z
    cpu_g = gilbert.solve(pre.xp.cpu(), pre.xm.cpu(), num_iters=H_REPLAY,
                          device="cpu").state.z
    dz = (card_g.cpu() - cpu_g).abs().max().item()
    print(f"  Gilbert's first {H_REPLAY} iterations on the CPU: max|dz| "
          f"{dz:.3e} (tol {FIT_ATOL})")
    require(dz <= FIT_ATOL, "h1: Gilbert on the card and the CPU differ")


def h_figure1(torch, card):
    """h2, Figure 1's full size: FISTA on RC-Hull (the NuSVC stand-in)
    against nu-Saddle-SVC on non_separable(20000, 128)'s training split;
    then profiles of 5 QP and 50 Gilbert iterations."""
    from repro_torch.baselines import gilbert, qp_nusvm
    from repro_torch.core import saddle
    from repro_torch.core.svm import split_classes
    from repro_torch.data import synthetic

    c = H_FIG1
    tr, _te = synthetic.non_separable(c["n"], c["d"], beta2=c["beta2"],
                                      seed=0).split(0.1, seed=0)
    xp, xm = split_classes(tr.x, tr.y)
    nu = 1.0 / (H_ALPHA * min(len(xp), len(xm)))
    pre = h_preprocess(torch, xp, xm)
    (qst, qhist), qp_s = timed(torch, lambda: qp_nusvm.solve(
        pre.xp, pre.xm, nu=nu, num_iters=c["qp_iters"],
        record_every=c["qp_every"], device="cuda"))
    sad, sad_s = timed(torch, lambda: saddle.solve(
        pre.xp, pre.xm, nu=nu, eps=H_EPS, beta=H_BETA,
        num_iters=c["saddle_steps"], record_every=c["saddle_every"],
        device="cuda"))
    print(f"h2 Figure 1 n={len(tr.y)} d={c['d']} nu={nu:.6g} ({card}): QP "
          f"{qp_s:.3f} s ({qp_s / c['qp_iters'] * 1e3:.4f} ms/iteration, "
          f"{c['qp_iters']} iterations), objective {qhist[-1][1]:.6g}; "
          f"nu-Saddle-SVC {sad_s:.3f} s "
          f"({sad_s / c['saddle_steps'] * 1e3:.4f} ms/step, "
          f"{c['saddle_steps']} steps), objective "
          f"{sad.history[-1][1]:.6g}; time ratio QP/saddle "
          f"{qp_s / sad_s:.4f}")
    print(f"  QP history {qhist}")
    print(f"  Saddle-SVC history {sad.history}")
    for name, v in (("eta", qst.eta), ("xi", qst.xi)):
        lo, hi, s = v.min().item(), v.max().item(), v.sum().item()
        print(f"  QP {name}: in [{lo:.3e}, {hi:.6g}] (nu {nu:.6g}), sum {s}")
        require(lo >= 0.0 and hi <= nu + 1e-6 and abs(s - 1.0) <= 1e-5,
                f"h2: QP's {name} leaves the capped simplex")
    # both begin at the uniform duals (the QP settles to float32 rounding
    # before its first record)
    start = 0.5 * (pre.xp.mean(dim=0) - pre.xm.mean(dim=0)).square().sum()
    print(f"  objective at the uniform duals both begin at "
          f"{start.item():.6g}")
    for label, hist in (("QP", qhist), ("Saddle-SVC", sad.history)):
        objs = [o for _, o in hist]
        require(all(math.isfinite(o) for o in objs)
                and objs[-1] < start.item(),
                f"h2: {label}'s objective is not finite or does not fall")
    # the QP minimises the same objective over the same capped simplex that
    # holds nu-Saddle-SVC's duals, so a QP that stalled would end above it
    q_end, s_end = qhist[-1][1], sad.history[-1][1]
    print(f"  QP end {q_end:.8g} against nu-Saddle-SVC's {s_end:.8g}: "
          f"{(s_end - q_end) / s_end:.4f} of it below")
    require(q_end <= s_end, "h2: the QP ends above nu-Saddle-SVC")
    lr = qp_nusvm.default_lr(pre.xp, pre.xm)
    lr_cpu = qp_nusvm.default_lr(pre.xp.cpu(), pre.xm.cpu())
    card_q, _ = qp_nusvm.solve(pre.xp, pre.xm, nu=nu, lr=lr,
                               num_iters=H_QP_REPLAY, device="cuda")
    cpu_q, _ = qp_nusvm.solve(pre.xp.cpu(), pre.xm.cpu(), nu=nu, lr=lr,
                              num_iters=H_QP_REPLAY, device="cpu")
    diff = max((a.cpu() - b).abs().max().item()
               for a, b in ((card_q.eta, cpu_q.eta), (card_q.xi, cpu_q.xi)))
    print(f"  QP's first {H_QP_REPLAY} iterations on the CPU at the card's "
          f"lr {lr!r} (the CPU's own {lr_cpu!r}): max|d eta|, |d xi| "
          f"{diff:.3e} (tol {REF_ATOL})")
    require(diff <= REF_ATOL, "h2: QP on the card and the CPU differ")
    eta0 = torch.full((len(xp),), 1.0 / len(xp), device="cuda")
    xi0 = torch.full((len(xm),), 1.0 / len(xm), device="cuda")
    q0 = qp_nusvm.QPState(eta0, xi0, eta0, xi0,
                          torch.ones((), device="cuda"))
    profile_window(torch, "h2 QP (steps = iterations)", 5,
                   lambda: qp_nusvm.run_chunk(q0, pre.xp, pre.xm, nu, lr, 5))
    g0 = gilbert.init_state(pre.xp, pre.xm)
    profile_window(torch, "h2 Gilbert (steps = iterations)", H_PROFILE,
                   lambda: gilbert.run_chunk(g0, pre.xp, pre.xm, H_PROFILE))


def h_figure3(torch, card, dist_fit):
    """h3, Figure 3: distributed Gilbert (3kd scalars an iteration)
    against serial Gilbert and beside path b's Saddle-DSVC, then HOGWILD
    (2kd) on the same points."""
    from repro_torch.baselines import dist_gilbert, gilbert, hogwild, pegasos
    from repro_torch.core.svm import split_classes
    from repro_torch.data import synthetic

    c = H_FIG3
    k, d = c["k"], c["d"]
    ds = synthetic.separable(c["n"], d, seed=0)
    pre = h_preprocess(torch, *split_classes(ds.x, ds.y))
    (_, hist, comm), dg_s = timed(torch, lambda: dist_gilbert.solve(
        pre.xp, pre.xm, k=k, num_iters=c["iters"], record_every=c["every"],
        device="cuda"))
    ser, ser_s = timed(torch, lambda: gilbert.solve(
        pre.xp, pre.xm, num_iters=c["iters"], record_every=c["every"],
        device="cuda"))
    unit = k * d

    def units_to_5pct(h):
        return next(s for _, s, o in h if o <= h[-1][2] * 1.05) / unit

    dsvc = dist_fit["res"]
    diff = abs(hist[-1][2] - ser.history[-1][1])
    print(f"h3 Figure 3 k={k} n={c['n']} d={d} ({card}): distributed "
          f"Gilbert {dg_s:.3f} s ({dg_s / c['iters'] * 1e3:.4f} ms/"
          f"iteration), {comm.total(c['iters']) / unit:.1f} kd sent in "
          f"{c['iters']} iterations ({units_to_5pct(hist):.1f} kd to within "
          f"5 % of its end), objective {hist[-1][2]:.6g}; serial Gilbert "
          f"{ser_s:.3f} s, objective {ser.history[-1][1]:.6g} (|diff| "
          f"{diff:.3e}); Saddle-DSVC (path b) {dsvc.scalars_sent / unit:.3f} "
          f"kd in {dsvc.history[-1][0]} steps "
          f"({units_to_5pct(dsvc.history):.3f} kd to within 5 %), "
          f"objective {dsvc.history[-1][2]:.6g}")
    print(f"  distributed Gilbert history {hist}")
    require(diff <= FIT_ATOL, "h3: distributed and serial Gilbert differ")
    shards = dist_gilbert.shard_problem(pre.xp, pre.xm, k, pre.xp.device)
    s0 = dist_gilbert.init_state(shards[0], shards[2])
    profile_window(torch, "h3 distributed Gilbert (steps = iterations)",
                   H_PROFILE, lambda: dist_gilbert.run_chunk(
                       s0, *shards, H_PROFILE))
    require(comm.scalars_per_iteration() == 3 * k * d,
            "h3: distributed Gilbert's CommModel is not 3kd")

    x = torch.cat([pre.xp, pre.xm])
    y = torch.cat([torch.ones(len(pre.xp)), -torch.ones(len(pre.xm))]).to(x)
    kw = dict(k=k, num_iters=c["hogwild_iters"])
    (hst, hhist, hcomm), hw_s = timed(torch, lambda: hogwild.solve(
        x, y, device="cuda", **kw))
    draws = pegasos.draw_schedule(len(y), (c["hogwild_iters"], k, 8), 0,
                                  "cuda")
    again, _, _ = hogwild.solve(x, y, idx_schedule=draws, device="cuda", **kw)
    print(f"  HOGWILD k={k}: {hw_s:.3f} s "
          f"({hw_s / c['hogwild_iters'] * 1e3:.4f} ms/round), training "
          f"accuracy {hhist[-1][2]:.4f}, "
          f"{hcomm.total(c['hogwild_iters']) / unit:.1f} kd sent")
    require(hhist[-1][2] >= 0.9, "h3: HOGWILD's training accuracy < 0.9")
    require(hcomm.scalars_per_iteration() == 2 * k * d,
            "h3: HOGWILD's CommModel is not 2kd")
    require(all(torch.equal(a, b) for a, b in zip(hst, again)),
            "h3: HOGWILD's draws are not draw_schedule's")
    sgd_replay(torch, "h3 HOGWILD", hogwild.solve, x, y, draws,
               dict(k=k))
    h0 = hogwild.HogwildState(*(torch.zeros_like(v) for v in hst))
    profile_window(torch, "h3 HOGWILD (steps = rounds)", H_PROFILE,
                   lambda: hogwild.run_chunk(h0, draws[:H_PROFILE], x, y,
                                             lam=1e-3, staleness=4))


def sgd_replay(torch, label, solve, x, y, draws, kw):
    """An SGD baseline's first H_REPLAY steps on the card and on the CPU
    with the card's draws: w and b within FIT_ATOL."""
    card = solve(x, y, num_iters=H_REPLAY, idx_schedule=draws[:H_REPLAY],
                 device="cuda", **kw)[0]
    cpu = solve(x.cpu(), y.cpu(), num_iters=H_REPLAY,
                idx_schedule=draws[:H_REPLAY].cpu(), device="cpu", **kw)[0]
    dw = (card.w.cpu() - cpu.w).abs().max().item()
    db = abs(card.b.item() - cpu.b.item())
    print(f"  {label}: first {H_REPLAY} steps on the CPU with the card's "
          f"draws: max|dw| {dw:.3e}, |db| {db:.3e} (tol {FIT_ATOL}; |w| "
          f"{card.w.abs().max().item():.4g}, |b| {abs(card.b.item()):.4g})")
    require(max(dw, db) <= FIT_ATOL, f"{label}: card and CPU differ")


def h_table4(torch, card):
    """h4, Table 4's full size: Pegasos on sparse_non_separable(100000,
    128) at three densities."""
    import numpy as np

    from repro_torch.baselines import pegasos
    from repro_torch.data import synthetic

    c = H_TABLE4
    for frac in c["fracs"]:
        nnz = int(c["d"] * frac)
        t0 = time.perf_counter()
        tr, te = synthetic.sparse_non_separable(
            c["n"], c["d"], nnz=nnz, seed=nnz).split(0.1, seed=0)
        data_s = time.perf_counter() - t0
        x = torch.as_tensor(tr.x, device="cuda")
        y = torch.as_tensor(tr.y, dtype=torch.float32, device="cuda")
        kw = dict(lam=c["lam"], batch=c["batch"])
        (st, hist), secs = timed(torch, lambda: pegasos.solve(
            x, y, num_iters=c["iters"], device="cuda", **kw))
        acc = float(np.mean(pegasos.predict(st, te.x) == te.y))
        draws = pegasos.draw_schedule(len(y), (c["iters"], c["batch"]), 0,
                                      "cuda")
        again, _ = pegasos.solve(x, y, num_iters=c["iters"],
                                 idx_schedule=draws, device="cuda", **kw)
        print(f"h4 Table 4 nnz={nnz} ({frac}) n={len(tr.y)} d={c['d']} "
              f"({card}): Pegasos {secs:.3f} s "
              f"({secs / c['iters'] * 1e3:.4f} ms/step, {c['iters']} "
              f"steps), training objective "
              f"{hist[-1][1]:.6g} and accuracy {hist[-1][2]:.4f}, test "
              f"accuracy {acc:.4f}; data made in {data_s:.2f} s")
        require(math.isfinite(hist[-1][1]), "h4: non-finite objective")
        require(all(torch.equal(a, b) for a, b in zip(st, again)),
                "h4: Pegasos's draws are not draw_schedule's")
        sgd_replay(torch, f"h4 Pegasos nnz={nnz}", pegasos.solve, x, y,
                   draws, kw)
    p0 = pegasos.PegasosState(*(torch.zeros_like(v) for v in st))
    profile_window(torch, f"h4 Pegasos nnz={nnz} (steps = steps)",
                   H_PROFILE, lambda: pegasos.run_chunk(
                       p0, draws[:H_PROFILE], x, y, c["lam"]))


def h_mdm(torch, card):
    """h5: MDM against Gilbert on the min-norm problem of Table 1's (2000,
    32) case, preprocessed."""
    from repro_torch.baselines import gilbert, mdm
    from repro_torch.core.svm import split_classes
    from repro_torch.data import synthetic

    c = H_MDM
    ds = synthetic.separable(c["n"], c["d"], seed=c["d"])
    pre = h_preprocess(torch, *split_classes(ds.x, ds.y))
    pts = pre.xp - pre.xm.mean(dim=0)
    (_, mhist), m_s = timed(torch, lambda: mdm.solve(
        pts, num_iters=c["iters"], device="cuda"))
    gil, g_s = timed(torch, lambda: gilbert.solve(
        pts, torch.zeros_like(pts[:1]), num_iters=c["iters"],
        device="cuda"))
    gap = abs(mhist[-1][1] - gil.history[-1][1])
    print(f"h5 MDM vs Gilbert n={c['n']} d={c['d']} ({card}): MDM "
          f"{m_s:.3f} s ({m_s / c['iters'] * 1e3:.4f} ms/iteration), "
          f"objective {mhist[-1][1]:.6g}; Gilbert {g_s:.3f} s, objective "
          f"{gil.history[-1][1]:.6g}; |diff| {gap:.3e} (tol {MDM_GAP})")
    require(gap < MDM_GAP, "h5: MDM and Gilbert disagree")
    m0 = mdm.init_state(pts)
    profile_window(torch, "h5 MDM (steps = iterations)", H_PROFILE,
                   lambda: mdm.run_chunk(m0, pts, H_PROFILE))


def baselines_path(torch, rec: PathRecorder, dist_fits):
    """Path h: the paper's comparisons, counts reset just before and read
    just after; every Saddle-SVC fit and preprocess of it recorded."""
    from repro_torch.kernels import ops

    card = card_line()
    ops.launch_counts.clear()
    t0 = time.perf_counter()
    with rec:
        h_table1(torch, card)
        h_figure1(torch, card)
        h_figure3(torch, card, dist_fits[0])
        h_table4(torch, card)
        h_mdm(torch, card)
    counts = dict(ops.launch_counts)
    print(f"path h launches {counts}; {time.perf_counter() - t0:.1f} s")
    rec.check_counts(counts, ("fwht",) + PACKED)


# ---------------------------------------------------------------- path i
I_SLOTS, I_CHUNK, I_MAX_LEN = 4, 8, 512
# prompt length, tokens, seed: buckets 8 to 256 (a bucket of 512 leaves no
# room for a token under max_len = 512, so submit refuses it)
I_REQS = [(5, 16, 11), (250, 40, 12), (17, 64, 13), (60, 24, 14),
          (9, 48, 15), (130, 32, 16), (33, 56, 17), (200, 20, 18)]
I_UPFRONT = 2          # submitted before the first chunk, the rest between
I_CANCEL = 1           # run 1 cancels this request once it is running
I_VICTIM = 4           # run 3 poisons this request's lane at its chunk 2
I_TEMPERATURE = 0.8    # run 2
I_RING = dict(prompt=4500, steps=32, compare=8)
# Ring decode vs a full forward, both bfloat16: the two compute the same
# sums in differently shaped products (prompt chunks of 1,024 queries
# against single rows), and every activation is rounded to bfloat16
# (unit roundoff 2^-9 = 1.95e-3) some 7 times a layer over 24 layers, so
# independent roundings reach ~sqrt(168) * 1.95e-3 ~ 2.5e-2 of an
# activation; held at 5e-2 of max |logit|.
I_RING_RTOL = 5e-2
I_REPLAY = dict(layers=2, prompt=16, steps=8)
I_REPLAY_RTOL = 1e-4   # card vs CPU, float32 weights: of max |logit|
# the JAX example's 6,000 iterations cut to 3,000 (to pay for path m; the
# probe has no class signal at full width: test accuracy 0.5000)
I_PROBE = dict(n=100, seq=24, feats=128, iters=3000)


def i_requests(cfg):
    import numpy as np

    rng = np.random.default_rng(2024)
    return [(rng.integers(0, cfg.vocab_size, s), n, seed)
            for s, n, seed in I_REQS]


def i_drive(torch, svc, reqs, cancel=None, upfront: int = I_UPFRONT
            ) -> tuple:
    """``upfront`` requests up front, one more after each step (as the
    JAX package's ``examples/serve_lm.py``), then a drain; ``cancel`` (an
    index) is cancelled once it runs.  Returns (results by index, wall
    seconds)."""
    from repro_torch.serve.scheduler import Status

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [svc.submit(p, n, seed=s, max_retries=1)
            for p, n, s in reqs[:upfront]]
    for p, n, s in reqs[upfront:]:
        svc.step()
        rids.append(svc.submit(p, n, seed=s, max_retries=1))
        if (cancel is not None and len(rids) > cancel
                and svc.status(rids[cancel]) is Status.RUNNING):
            require(svc.cancel(rids[cancel]), "i1: cancel refused")
            cancel = None
    out = svc.run()
    torch.cuda.synchronize()
    require(cancel is None, "i1: the request to cancel never ran")
    return ({i: out[rid] for i, rid in enumerate(rids)},
            time.perf_counter() - t0)


def i_slots(torch, model, card):
    """i1: gemma-7b at full width in slot mode, three runs of 8 staggered
    requests (greedy with a cancel, temperature, greedy with a poisoned
    lane), every completed request held to its solo ``generate``."""
    import numpy as np

    from repro_torch.serve import engine, faults
    from repro_torch.serve.lm_service import LMService
    from repro_torch.serve.scheduler import RequestFailure, Status

    reqs = i_requests(model.cfg)
    # Solo references first (they also warm every bucket's prefill).  A
    # solo generate takes the service's cache capacity: the capacity
    # sets the decode products' shapes, and so the library's algorithm.
    solo = {}
    t0 = time.perf_counter()
    for temperature in (0.0, I_TEMPERATURE):
        for i, (p, n, s) in enumerate(reqs):
            solo[i, temperature] = engine.generate(
                model, p[None], steps=n, seed=s, temperature=temperature,
                max_len=I_MAX_LEN)[0].cpu().numpy()
    torch.cuda.synchronize()
    n_solo = 2 * sum(n for _, n, _ in reqs)
    print(f"i1 solo generates: {n_solo} tokens in "
          f"{time.perf_counter() - t0:.3f} s [{card}]")
    runs = {}
    for run, (temperature, cancel, victim) in enumerate(
            ((0.0, I_CANCEL, None), (I_TEMPERATURE, None, None),
             (0.0, None, I_VICTIM)), start=1):
        inj = None
        if victim is not None:
            inj = faults.FaultInjector(faults.FaultPlan(seed=0, faults=(
                faults.Fault("poison", rid=victim, at_chunk=2),)))
        svc = LMService(model, num_slots=I_SLOTS, chunk_steps=I_CHUNK,
                        max_len=I_MAX_LEN, temperature=temperature,
                        fault_injector=inj)
        require(svc.slot_mode, "i1: gemma-7b must run in slot mode")
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        before = set(engine.trace_counts)
        res, wall = i_drive(torch, svc, reqs, cancel)
        mem1 = torch.cuda.memory_allocated()
        new = set(engine.trace_counts) - before
        done = {i: r for i, r in res.items()
                if not isinstance(r, RequestFailure)}
        toks = sum(len(r.tokens) for r in done.values())
        print(f"i1 run {run} (temperature {temperature}): {len(done)} of "
              f"{len(reqs)} completed, {toks} tokens in {wall:.3f} s: "
              f"{toks / wall:.1f} tokens/s; stats {svc.stats}; new "
              f"set-ups {sorted(new)}; memory {mem0} -> {mem1} bytes "
              f"[{card}]")
        for i, r in sorted(res.items()):
            if isinstance(r, RequestFailure):
                print(f"  req {i}: {r.status.value} ({r.reason})")
                continue
            same = np.array_equal(r.tokens, solo[i, temperature])
            print(f"  req {i}: prompt {r.prompt_len} bucket {r.bucket} "
                  f"tokens {len(r.tokens)} admitted at chunk "
                  f"{r.admitted_chunk}: "
                  f"{'equal to' if same else 'DIFFERS from'} solo")
            if not same:
                first = int(np.argmax(r.tokens != solo[i, temperature]))
                print(f"    first differing token {first}: lane "
                      f"{r.tokens[first]}, solo {solo[i, temperature][first]}")
            require(same, f"i1 run {run} req {i}: lane differs from solo")
        require(mem1 <= mem0, f"i1 run {run}: memory {mem0} -> {mem1}")
        want = {engine.lm_slot_trace_key(model.cfg.name, I_SLOTS, I_MAX_LEN,
                                         I_CHUNK, temperature)}
        require(new <= want and svc.stats["compiles"] == len(new),
                f"i1 run {run}: set-ups {new}, want at most {want}")
        if run == 3:
            require(not new, f"i1 run 3: set-ups after warm-up: {new}")
        if cancel is not None:
            require(isinstance(res[cancel], RequestFailure)
                    and res[cancel].status is Status.CANCELLED,
                    "i1: the cancelled request did not end CANCELLED")
        if victim is not None:
            require(len(inj.fired) == 1
                    and not isinstance(res[victim], RequestFailure),
                    "i1: the poisoned request was not retried to the end")
        runs[run] = res
    mates = [i for i in range(len(reqs)) if i not in (I_CANCEL, I_VICTIM)]
    for i in mates:
        require(np.array_equal(runs[1][i].tokens, runs[3][i].tokens),
                f"i1: batch-mate {i} differs between runs 1 and 3")
    print(f"i1: batch-mates {mates} bit-equal across runs 1 and 3")
    i_decode_timing(torch, model, reqs, card)


def i_decode_timing(torch, model, reqs, card, slots: int = I_SLOTS,
                    label: str = "i1"):
    """ms a chunk and a decode step of ``slots`` busy lanes, then one
    profiled chunk: idle share, device launches and device time a
    step."""
    from repro_torch.serve import engine

    state = None
    for lane in range(slots):
        p, _, seed = reqs[lane]
        s_b = engine.prompt_bucket(len(p))
        toks = torch.zeros((1, s_b), dtype=torch.long)
        toks[0, :len(p)] = torch.as_tensor(p)
        pre = engine._prefill_bucketed(model, toks, len(p),
                                       max_len=I_MAX_LEN)
        if state is None:
            state = engine.init_lm_slot_state(pre, slots)
        state = engine.admit_lane(state, lane, pre, seed, I_MAX_LEN)
    kw = dict(chunk_steps=I_CHUNK, temperature=0.0, max_len=I_MAX_LEN)
    engine.decode_chunk_slots(model, state, **kw)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.decode_chunk_slots(model, state, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    print(f"{label} decode, {slots} busy lanes: {ms:.3f} ms a chunk of "
          f"{I_CHUNK}, {ms / I_CHUNK:.3f} ms a step, "
          f"{slots * I_CHUNK / ms * 1e3:.1f} tokens/s [{card}]")
    profile_window(torch, f"{label} one decode chunk, {slots} lanes of "
                   f"{model.cfg.name} [{card}]", I_CHUNK,
                   lambda: engine.decode_chunk_slots(model, state, **kw))


def i_ring(torch, card):
    """i2: h2o-danube-1.8b at full width on the fallback path: a prompt
    longer than the window (the prefill's roll), 32 decode steps, the
    last 8 held to a full forward."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve import engine
    from repro_torch.serve.lm_service import LMService

    cfg = get_config("h2o-danube-1.8b")
    t0 = time.perf_counter()
    model = tf.init_lm(cfg, seed=1)
    torch.cuda.synchronize()
    print(f"i2: {cfg.name}, {tf.count_params(model):,} parameters "
          f"({cfg.param_dtype}), initialised in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    s, steps, cmp = I_RING["prompt"], I_RING["steps"], I_RING["compare"]
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, s)
    svc = LMService(model)
    require(not svc.slot_mode, "i2: a window config must not run in slot "
            "mode")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = svc.generate(prompt, steps, seed=0).tokens
    torch.cuda.synchronize()
    print(f"i2 fallback generate: {s} + {steps} tokens in "
          f"{time.perf_counter() - t0:.3f} s [{card}]")
    st = engine.prefill(model, prompt[None], max_len=s + steps)
    w = st.cache["layers"][0]["k"].shape[2]
    logits, toks = [], []
    for _ in range(steps):
        tok = st.last_logits.argmax(-1)
        toks.append(int(tok[0]))
        st = engine.decode_step(model, tok[:, None], st)
        logits.append(st.last_logits[0].float())
    require(toks == served.tolist(), "i2: the service's fallback differs "
            "from prefill + decode")
    full, _ = model(torch.as_tensor(np.r_[prompt, toks][None],
                                    device=model.device))
    want = full[0, -cmp:].float()
    got = torch.stack(logits[-cmp:])
    err = (got - want).abs().max().item() / want.abs().max().item()
    print(f"i2: ring of {w} slots, index {s} -> {s + steps} (writes at "
          f"slots {s % w}..{(s + steps - 1) % w}); last {cmp} decode "
          f"logits vs a full forward over {s + steps} tokens: max |diff| "
          f"/ max |logit| {err:.3e} (tol {I_RING_RTOL}); argmax equal at "
          f"{int((got.argmax(-1) == want.argmax(-1)).sum())} of {cmp}")
    require(err <= I_RING_RTOL, "i2: ring decode differs from the full "
            "forward")
    del model, st, full


def i_replay(torch, card, arch: str = "gemma-7b", label: str = "i3",
             layers: int = I_REPLAY["layers"], frames: bool = False,
             cache_dtype=None, **changes):
    """i3 (j3, k4, l3): ``arch`` at full width, cut to ``layers`` layers
    (and the config ``changes``), float32: prefill and greedy decode on
    the card and on the CPU with the same weights; with ``frames``, over
    the same encoder frames drawn from a seed; the cache in
    ``cache_dtype`` (default the engine's bfloat16)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve import engine

    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              param_dtype="float32", compute_dtype="float32",
                              **changes)
    card_model = tf.init_lm(cfg, seed=2)
    cpu_model = tf.LM(cfg, device="cpu")
    cpu_model.load_state_dict(card_model.state_dict())
    print(f"{label}: {cfg.name} x {cfg.num_layers} layers (kinds "
          f"{tf.layer_kinds(cfg)}, MLPs {tf.layer_mlps(cfg)}"
          f"{f', {cfg.enc_layers} encoder layers' if cfg.enc_layers else ''}"
          f"), {tf.count_params(cpu_model):,} float32 parameters on both")
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, I_REPLAY["prompt"])
    kw = {} if cache_dtype is None else {"cache_dtype": cache_dtype}
    if frames:
        kw["enc_frames"] = (rng.standard_normal(
            (1, cfg.enc_frames, cfg.d_model)) * L_FRAME_SCALE).astype(
                np.float32)
    runs = {}
    for name, model in (("card", card_model), ("cpu", cpu_model)):
        t0 = time.perf_counter()
        st = engine.prefill(model, prompt[None],
                            max_len=len(prompt) + I_REPLAY["steps"], **kw)
        logits, toks = [st.last_logits[0].cpu()], []
        for _ in range(I_REPLAY["steps"]):
            tok = st.last_logits.argmax(-1)
            toks.append(int(tok[0]))
            st = engine.decode_step(model, tok[:, None], st)
            logits.append(st.last_logits[0].cpu())
        runs[name] = (logits, toks)
        print(f"  {name}: {time.perf_counter() - t0:.2f} s, tokens {toks}"
              f"{f' [{card}]' if name == 'card' else ''}")
    (lc, tc), (lh, th) = runs["card"], runs["cpu"]
    for i in range(len(lc)):
        tol = I_REPLAY_RTOL * lh[i].abs().max().item()
        err = (lc[i] - lh[i]).abs().max().item()
        print(f"  logits {i}: max |card - CPU| {err:.3e} (tol {tol:.3e})")
        require(err <= tol, f"{label}: logits {i} differ")
        if i < len(tc) and tc[i] != th[i]:
            top = torch.topk(lh[i], 2).values
            margin = (top[0] - top[1]).item()
            print(f"  token {i} differs: CPU top-2 margin {margin:.3e}")
            require(margin <= tol, f"{label}: token {i} differs beyond a "
                    "tie")
            break
    del card_model


def i_probe(torch, model, rec: PathRecorder, card):
    """i4: the port's ``examples/svm_probe_lm.py`` at full width on
    gemma-7b: its features (pooled logits) and its nu-SVM probe, fit on
    the card (iterations cut to I_PROBE's), then replayed on the CPU with
    the card's coordinates."""
    import numpy as np

    from repro_torch.examples import svm_probe_lm as probe

    n, iters = I_PROBE["n"], I_PROBE["iters"]
    require((I_PROBE["seq"], I_PROBE["feats"]) == (probe.SEQ, probe.FEATS),
            "i4: the probe's shapes changed")
    rng = np.random.default_rng(0)
    toks, y = probe.tokens(model.cfg, n, rng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = probe.features(model, toks)
    print(f"i4 features: {toks.shape} tokens -> {feats.shape} in "
          f"{time.perf_counter() - t0:.3f} s [{card}]")
    require(np.isfinite(feats).all(), "i4: non-finite features")
    tr, te = probe.split(len(y), rng)
    with rec:
        t0 = time.perf_counter()
        fit = probe.fit_probe(feats, y, tr, te, device="cuda",
                              num_iters=iters)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    sched = rec.take_schedule()
    clf = fit["clf"]
    print(f"i4 probe fit: {secs:.3f} s for {iters} steps; train accuracy "
          f"{fit['train_acc']:.4f}, test accuracy {fit['test_acc']:.4f} "
          f"[{card}]")
    require(np.isfinite(clf.w_).all(), "i4: non-finite probe")
    t0 = time.perf_counter()
    cpu = probe.fit_probe(feats, y, tr, te, device="cpu", num_iters=iters,
                          idx_schedule=sched)["clf"]
    print(f"i4 probe replayed on the CPU with the card's coordinates: "
          f"{time.perf_counter() - t0:.1f} s")
    compare_fits("  card vs CPU, i4 probe", clf, cpu, history=True)


def lm_path(torch, rec: PathRecorder):
    """Path i: the LM serving side, counts reset just before and read
    just after; the probe's fit is recorded.  Its models are freed
    before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    card = card_line()
    ops.launch_counts.clear()
    t_path = time.perf_counter()
    cfg = get_config("gemma-7b")
    t0 = time.perf_counter()
    model = tf.init_lm(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"i1: {cfg.name}, {tf.count_params(model):,} parameters "
          f"({cfg.param_dtype}, {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB on the card), initialised in {time.perf_counter() - t0:.2f} "
          f"s [{card}]")
    i_slots(torch, model, card)
    i_probe(torch, model, rec, card)
    del model
    torch.cuda.empty_cache()
    i_ring(torch, card)
    torch.cuda.empty_cache()
    i_replay(torch, card)
    torch.cuda.empty_cache()
    counts = dict(ops.launch_counts)
    print(f"path i launches {counts}; {time.perf_counter() - t_path:.1f} s")
    rec.check_counts(counts, ("fwht",) + PACKED)


# ---------------------------------------------------------------- path j
J_ARCH = "deepseek-v2-lite-16b"
J_SLOTS = 12           # 16 decode rows: more than one row tile
# prompt length, tokens, seed: buckets 8 to 256.  212 tokens in all (496
# before path l was added: each solo reference decodes on 16 rows at ~0.12
# s a token, host-bound, so the cut saves ~30 s there and a few in the
# service); the victim keeps 20 tokens, so it still runs at its chunk 2
J_REQS = [(5, 8, 21), (250, 16, 22), (17, 20, 23), (60, 20, 24),
          (9, 12, 25), (130, 8, 26), (33, 16, 27), (200, 10, 28),
          (12, 20, 29), (90, 12, 30), (7, 8, 31), (240, 14, 32),
          (40, 10, 33), (150, 18, 34), (20, 8, 35), (70, 12, 36)]
J_UPFRONT = 6
J_VICTIM = 3           # poisoned at its chunk 2, retried
# j2: 24 + 8 = 32 tokens, one token a routing group in both runs (no
# capacity drop); bfloat16 as i2, so held at i2's 5e-2 of max |logit|
# where the routing agrees; and float32 at 4 layers, held at the JAX
# package's decode-consistency bound (tests/test_decode_consistency.py)
J_ABSORB = dict(prompt=24, steps=8, layers_f32=4)
J_ABSORB_RTOL_F32 = 1e-4


def j_requests(cfg):
    import numpy as np

    rng = np.random.default_rng(2025)
    return [(rng.integers(0, cfg.vocab_size, s), n, seed)
            for s, n, seed in J_REQS]


def j_weight_bounds(model) -> tuple:
    """Bytes a decode step must read (every weight but the embedding
    table, which decode gathers by row): all experts of every MoE layer,
    as the slot-dense expert product reads them, and one token's routed
    experts only.  Returns (all bytes, routed bytes)."""
    from repro_torch.models.moe import MoE

    cfg = model.cfg
    every = sum(p.numel() * p.element_size() for p in model.parameters())
    table = model.embed.embedding
    every -= table.numel() * table.element_size()
    experts = sum(w.numel() * w.element_size() for m in model.modules()
                  if isinstance(m, MoE)
                  for w in (m.expert_gate, m.expert_up, m.expert_down))
    routed = every - experts * (1 - cfg.moe_top_k / cfg.moe_num_experts)
    return every, routed


def slot_run(torch, model, card, label: str, reqs, slots: int,
             upfront: int, victim: int | None = None):
    """One greedy run of ``reqs`` through ``LMService(num_slots=slots,
    chunk_steps=8, max_len=512)`` in slot mode, ``upfront`` requests up
    front and one more after each step, request ``victim`` (if any)
    poisoned at its chunk 2 and retried: every request completes equal to
    its solo ``generate`` at the service's rows and cache capacity, token
    for token; some request is admitted mid-decode; no set-up but the
    decode chunk's; device memory back after the drain."""
    import numpy as np

    from repro_torch.models import transformer as tf
    from repro_torch.serve import engine, faults
    from repro_torch.serve.lm_service import LMService
    from repro_torch.serve.scheduler import RequestFailure

    rows = tf.decode_rows(slots)
    solo = {}
    t0 = time.perf_counter()
    for i, (p, n, s) in enumerate(reqs):
        solo[i] = engine.generate(model, p[None], steps=n, seed=s,
                                  max_len=I_MAX_LEN,
                                  rows=rows)[0].cpu().numpy()
    torch.cuda.synchronize()
    n_solo = sum(n for _, n, _ in reqs)
    print(f"{label} solo generates ({rows} rows): {n_solo} tokens in "
          f"{time.perf_counter() - t0:.3f} s [{card}]")
    inj = None
    if victim is not None:
        inj = faults.FaultInjector(faults.FaultPlan(seed=0, faults=(
            faults.Fault("poison", rid=victim, at_chunk=2),)))
    svc = LMService(model, num_slots=slots, chunk_steps=I_CHUNK,
                    max_len=I_MAX_LEN, fault_injector=inj)
    require(svc.slot_mode, f"{label}: {model.cfg.name} must run in slot "
            "mode")
    require(svc.rows == rows, f"{label}: the service runs {svc.rows} rows")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    before = set(engine.trace_counts)
    res, wall = i_drive(torch, svc, reqs, upfront=upfront)
    mem1 = torch.cuda.memory_allocated()
    new = set(engine.trace_counts) - before
    done = {i: r for i, r in res.items()
            if not isinstance(r, RequestFailure)}
    toks = sum(len(r.tokens) for r in done.values())
    poison = ("" if victim is None else
              f", request {victim} poisoned at its chunk 2")
    print(f"{label} run (greedy{poison}): "
          f"{len(done)} of {len(reqs)} completed, {toks} tokens in "
          f"{wall:.3f} s: {toks / wall:.1f} tokens/s; stats {svc.stats}; "
          f"new set-ups {sorted(new)}; memory {mem0} -> {mem1} bytes "
          f"[{card}]")
    for i, r in sorted(res.items()):
        if isinstance(r, RequestFailure):
            print(f"  req {i}: {r.status.value} ({r.reason})")
            continue
        same = np.array_equal(r.tokens, solo[i])
        print(f"  req {i}: prompt {r.prompt_len} bucket {r.bucket} tokens "
              f"{len(r.tokens)} admitted at chunk {r.admitted_chunk}: "
              f"{'equal to' if same else 'DIFFERS from'} solo")
        if not same:
            first = int(np.argmax(r.tokens != solo[i]))
            print(f"    first differing token {first}: lane "
                  f"{r.tokens[first]}, solo {solo[i][first]}")
    require(len(done) == len(reqs), f"{label}: a request did not complete")
    require(all(np.array_equal(r.tokens, solo[i]) for i, r in done.items()),
            f"{label}: a lane differs from its solo generate")
    require(max(r.admitted_chunk for r in done.values()) > 0,
            f"{label}: no request was admitted mid-decode")
    if inj is not None:
        require(len(inj.fired) == 1, f"{label}: the poison did not fire "
                "once")
    require(mem1 <= mem0, f"{label}: memory {mem0} -> {mem1}")
    # the solo references set up every bucket's prefill: the service sets
    # up its decode chunk once, at its first chunk, and nothing after it
    want = {engine.lm_slot_trace_key(model.cfg.name, slots, I_MAX_LEN,
                                     I_CHUNK, 0.0)}
    require(new <= want and svc.stats["compiles"] == len(new),
            f"{label}: set-ups {new}, want at most {want}")


def j_slots(torch, model, card):
    """j1: deepseek-v2-lite-16b at full width in a 12-lane service (16
    rows), one greedy run of 16 staggered requests with a lane poisoned at
    its chunk 2 and retried (``slot_run``), then a timed and profiled
    chunk beside the weight-read bounds."""
    reqs = j_requests(model.cfg)
    slot_run(torch, model, card, "j1", reqs, J_SLOTS, J_UPFRONT, J_VICTIM)
    i_decode_timing(torch, model, reqs, card, slots=J_SLOTS, label="j1")
    every, routed = j_weight_bounds(model)
    print(f"j1 weight-read bound a decode step: every expert "
          f"{every / 1e9:.2f} GB -> {every / HBM_BW * 1e3:.2f} ms; "
          f"one token's {model.cfg.moe_top_k} routed experts "
          f"{routed / 1e9:.2f} GB -> {routed / HBM_BW * 1e3:.2f} ms "
          f"(at {HBM_BW / 1e12:.2f} TB/s)")


def j_decode_vs_forward(torch, model, prompt, steps: int,
                        cache_dtype=None, between=None):
    """Prefill ``prompt``, decode ``steps`` greedy tokens (absorbed path),
    then one causal forward over the whole sequence (expanded path).
    ``between()`` runs after the prefill and after each decode step.
    Returns the decode logits and the forward's at the same positions,
    (steps, V) float32 each, and the sequence (1, S + steps)."""
    import numpy as np

    from repro_torch.serve import engine

    kw = {} if cache_dtype is None else {"cache_dtype": cache_dtype}
    st = engine.prefill(model, prompt[None], max_len=len(prompt) + steps,
                        **kw)
    between = between or (lambda: None)
    between()
    logits, toks = [], []
    for _ in range(steps):
        tok = st.last_logits.argmax(-1)
        toks.append(int(tok[0]))
        st = engine.decode_step(model, tok[:, None], st)
        logits.append(st.last_logits[0].float())
        between()
    seq = torch.as_tensor(np.r_[prompt, toks][None], device=model.device)
    full, _ = model(seq)
    return torch.stack(logits), full[0, -steps:].float(), seq


def j_route_hooks(torch, model, log: list) -> list:
    """Forward hooks on every MoE layer appending, per call, each token's
    top-k experts (N, k) and the router's margin between its k-th and
    (k+1)-th probability (N,), recomputed from the layer's input as the
    layer computes them (one token a routing group: decode and inputs of
    up to 32 tokens).  Returns the hook handles."""
    from repro_torch.models.moe import MoE, top_k

    def hook(mod, args, _out):
        h = args[0]
        probs = torch.softmax(h.reshape(-1, 1, h.shape[-1]).float()
                              @ mod.router, dim=-1)[:, 0]
        vals, idx = top_k(probs, mod.cfg.moe_top_k + 1)
        log.append((idx[:, :-1], vals[:, -2] - vals[:, -1]))

    return [m.register_forward_hook(hook) for m in model.modules()
            if isinstance(m, MoE)]


def j_pinned_top_k(routes):
    """A stand-in for ``moe.top_k`` that routes the n-th MoE call's tokens
    to ``routes[n]`` (N, k): the experts another run chose, weighted by
    this run's router probabilities."""
    calls = iter(routes)

    def pinned(probs, k):
        idx = next(calls).reshape(probs.shape[:-1] + (k,))
        return probs.gather(-1, idx), idx

    return pinned


def j_absorbed(torch, model, card):
    """j2: the absorbed decode against the expanded forward at full width.

    bfloat16, the j1 model: a 24-token prompt and 8 greedy steps, their
    logits against one causal forward over the 32 tokens.  A token's MoE
    routing is a discontinuous function of its hidden state, and bfloat16
    rounds the two paths' states apart (~1e-2): where a router's k-th and
    (k+1)-th probabilities nearly tie (random router weights give 64
    near-equal probabilities), the two runs send a token to different
    experts, in the JAX package as here.  So the forward runs twice: free
    (each step's error and routing differences printed) and with every
    MoE layer pinned to the experts the prefill and the decode chose
    (``j_pinned_top_k``), which compares the two attention paths and the
    rest of the stack alone: every step within 5e-2 of max |logit|.  Then
    float32 with the model cut to 4 layers, free: every step within
    1e-4."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    cfg = model.cfg
    s, steps = J_ABSORB["prompt"], J_ABSORB["steps"]
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, s)
    log, calls = [], []
    handles = j_route_hooks(torch, model, log)
    try:
        got, free, seq = j_decode_vs_forward(
            torch, model, prompt, steps,
            between=lambda: (calls.append(list(log)), log.clear()))
    finally:
        for h in handles:
            h.remove()
    # calls[0]: the prefill's layers; calls[1 + j]: decode step j's (row
    # 0 the real one); log: the free forward's
    layers = range(len(log))
    routes = [torch.cat([calls[0][i][0]]
                        + [calls[1 + j][i][0][:1] for j in range(steps)])
              for i in layers]
    top_k = moe.top_k
    moe.top_k = j_pinned_top_k(routes)
    try:
        pinned, _ = model(seq)
    finally:
        moe.top_k = top_k
    pinned = pinned[0, -steps:].float()
    scale = free.abs().max()
    err_free = ((got - free).abs().max(-1).values / scale).cpu().numpy()
    err = ((got - pinned).abs().max(-1).values / scale).cpu().numpy()
    for j in range(steps):
        flips = [(i, float(log[i][1][s + j])) for i in layers
                 if not torch.equal(routes[i][s + j], log[i][0][s + j])]
        print(f"  j2 step {j}: vs the free forward {err_free[j]:.3e}, "
              + (f"routing differs in MoE layers {[f[0] for f in flips]} "
                 f"(the forward's k-th vs (k+1)-th router margin down to "
                 f"{min(f[1] for f in flips):.2e})" if flips else
                 "the same routing in every MoE layer")
              + f"; vs the pinned forward {err[j]:.3e}")
    prompt_flips = sum(not torch.equal(routes[i][:s], log[i][0][:s])
                       for i in layers)
    print(f"j2: {s}-token prompt + {steps} absorbed decode steps vs the "
          f"expanded forward over {s + steps} tokens ({cfg.param_dtype}): "
          f"free max {err_free.max():.3e}, argmax equal at "
          f"{int((got.argmax(-1) == free.argmax(-1)).sum())} of {steps}; "
          f"routing pinned max {err.max():.3e} (tol {I_RING_RTOL}), argmax "
          f"equal at {int((got.argmax(-1) == pinned.argmax(-1)).sum())}; "
          f"{prompt_flips} MoE layers route some prompt token differently "
          f"in the prefill and the free forward [{card}]")
    require(err.max() <= I_RING_RTOL, "j2: absorbed decode differs from "
            "the expanded forward with the same routing")

    cfg32 = dataclasses.replace(get_config(J_ARCH),
                                num_layers=J_ABSORB["layers_f32"],
                                param_dtype="float32",
                                compute_dtype="float32")
    m32 = tf.init_lm(cfg32, seed=4)
    got, want, _ = j_decode_vs_forward(torch, m32, prompt, steps,
                                       cache_dtype=torch.float32)
    err32 = ((got - want).abs().max() / want.abs().max()).item()
    print(f"j2: the same in float32, {cfg32.num_layers} layers (MLPs "
          f"{tf.layer_mlps(cfg32)}), float32 cache, free: max |diff| / max "
          f"|logit| {err32:.3e} over the {steps} steps (tol "
          f"{J_ABSORB_RTOL_F32}) [{card}]")
    require(err32 <= J_ABSORB_RTOL_F32, "j2: float32 absorbed decode "
            "differs from the expanded forward")
    del m32


def deepseek_path(torch):
    """Path j: deepseek-v2-lite-16b's MLA and MoE in the LM service,
    counts reset just before and read just after (the path reaches no
    kernel).  Its models are freed before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    card = card_line()
    ops.launch_counts.clear()
    t_path = time.perf_counter()
    cfg = get_config(J_ARCH)
    t0 = time.perf_counter()
    model = tf.init_lm(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"j1: {cfg.name}, {tf.count_params(model):,} parameters "
          f"({cfg.param_dtype}, {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB on the card), initialised in {time.perf_counter() - t0:.2f} "
          f"s [{card}]")
    j_slots(torch, model, card)
    j_absorbed(torch, model, card)
    del model
    torch.cuda.empty_cache()
    i_replay(torch, card, J_ARCH, "j3")
    torch.cuda.empty_cache()
    counts = dict(ops.launch_counts)
    print(f"path j launches {counts}; {time.perf_counter() - t_path:.1f} s")
    require(not counts, "path j: it reaches no kernel, yet one was launched")


# ---------------------------------------------------------------- path k
K_SLOTS, K_CHUNK = 4, 8
# prompt length, tokens, seed; the last is submitted with a deadline and
# must finish before every earlier request (tests/test_lm_service.py's
# fallback contract: deadline-tagged tickets precede slack ones)
K_REQS = [(5, 16, 41), (250, 32, 42), (17, 24, 43), (60, 20, 44),
          (130, 28, 45), (33, 16, 46)]
K_DEADLINE = 1.0
K_RING = dict(prompt=2300, steps=32, compare=8)    # past the 2,048 window
K_XLSTM = dict(prompt=1200, steps=32, compare=8)   # mLSTM chunks 1,024 + 176
# k3's bfloat16 decode vs forward: xlstm-125m's random-weight logits are
# flat (max |logit| ~4), and bfloat16 alone moves its forward 5.9e-2 of
# max |logit| from the float32 forward of the same weights (k3 prints it;
# an H100 at full width), above I_RING_RTOL.  Two bfloat16 evaluations of
# one function, each that far from the float32 one, may lie twice that
# apart: k3 holds its decode to the larger of I_RING_RTOL and K_NOISE
# times the distance measured in the same run.
K_NOISE = 2.0
# solo decode steps timed, then profiled (a profiled step of ~1,900
# launches costs seconds of the profiler's own host time)
K_TIMED, K_PROFILED = 16, 2


def k_weight_bytes(model) -> int:
    """Bytes a decode step must read: every weight once, the tied head's
    table included."""
    return sum(p.numel() * p.element_size() for p in model.parameters())


def k_decode_timing(torch, model, st, card, label: str,
                    nbytes: int | None = None) -> None:
    """ms a step of a solo greedy decode (B = 1 on ``decode_rows(1)``
    rows) from the prefilled state ``st``, then a profiled window of
    decode steps, beside a step's read bound of ``nbytes`` (default
    every weight, ``k_weight_bytes``)."""
    from repro_torch.models import transformer as tf
    from repro_torch.serve import engine

    tok = st.last_logits.argmax(-1)[:, None]
    box = [st]

    def steps(n: int) -> None:
        for _ in range(n):
            box[0] = engine.decode_step(model, tok, box[0])

    steps(2)                                            # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(K_TIMED)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / K_TIMED * 1e3
    nbytes = k_weight_bytes(model) if nbytes is None else nbytes
    print(f"{label} solo decode (B = 1, {tf.decode_rows(1)} rows): {ms:.3f} "
          f"ms a step over {K_TIMED} steps; read bound "
          f"{nbytes / 1e9:.3f} GB -> {nbytes / HBM_BW * 1e3:.3f} ms "
          f"a step (at {HBM_BW / 1e12:.2f} TB/s) [{card}]")
    profile_window(torch, f"{label} solo decode of {model.cfg.name}, "
                   f"{K_PROFILED} steps [{card}]", K_PROFILED,
                   lambda: steps(K_PROFILED))


def k_decode_vs_forward(torch, model, prompt, steps: int, cmp: int,
                        served, label: str, card, f32_model=None,
                        prefill_kw=None, forward_kw=None):
    """Prefill ``prompt``, ``steps`` greedy decode steps equal to the
    tokens ``served`` (the service's fallback, or a ``generate``), the
    last ``cmp`` steps' logits within I_RING_RTOL of max |logit| of one
    forward over the whole sequence (both in the model's dtype).  With
    ``f32_model`` (the same weights in float32) the bound is the larger of
    I_RING_RTOL and twice the bfloat16 forward's own distance from the
    float32 forward on the same tokens (K_NOISE).  ``prefill_kw`` and
    ``forward_kw`` are the prefill's and the forwards' other inputs
    (frames, vision embeddings; float32 for the float32 forward).  Returns
    the decode's state."""
    import numpy as np

    from repro_torch.serve import engine

    prefill_kw, forward_kw = prefill_kw or {}, forward_kw or {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = engine.prefill(model, prompt[None], max_len=len(prompt) + steps,
                        **prefill_kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"{label} prefill of {len(prompt)} tokens: {secs:.3f} s, "
          f"{secs / len(prompt) * 1e3:.4f} ms a prompt token [{card}]")
    logits, toks = [], []
    for _ in range(steps):
        tok = st.last_logits.argmax(-1)
        toks.append(int(tok[0]))
        st = engine.decode_step(model, tok[:, None], st)
        logits.append(st.last_logits[0].float())
    require(toks == served.tolist(), f"{label}: the served tokens differ "
            "from prefill + decode")
    seq = torch.as_tensor(np.r_[prompt, toks][None], device=model.device)
    full, _ = model(seq, **forward_kw)
    want = full[0, -cmp:].float()
    got = torch.stack(logits[-cmp:])
    err = (got - want).abs().max().item() / want.abs().max().item()
    tol = I_RING_RTOL
    if f32_model is not None:
        ref = f32_model(seq, **{
            k: v.float() if v.is_floating_point() else v
            for k, v in forward_kw.items()})[0][0, -cmp:]
        scale = ref.abs().max().item()
        noise = (want - ref).abs().max().item() / scale
        print(f"{label}: the {model.cfg.param_dtype} forward vs the float32 "
              f"forward of the same weights: {noise:.3e} of max |logit|; "
              f"the decode vs the float32 forward "
              f"{(got - ref).abs().max().item() / scale:.3e}")
        tol = max(tol, K_NOISE * noise)
    print(f"{label}: {steps} decode steps equal the served tokens; "
          f"last {cmp} decode logits vs a full forward over "
          f"{len(prompt) + steps} tokens ({model.cfg.param_dtype}): max "
          f"|diff| / max |logit| {err:.3e} (tol {tol:.3e}); argmax "
          f"equal at {int((got.argmax(-1) == want.argmax(-1)).sum())} of "
          f"{cmp} [{card}]")
    require(err <= tol, f"{label}: decode differs from the full forward")
    return st


def k_service(torch, model, card) -> None:
    """k1: recurrentgemma-2b in ``LMService`` (the solo fallback): 6
    requests, the last with a deadline, each equal to a direct
    ``engine.generate``; memory back after the drain."""
    import numpy as np

    from repro_torch.serve import engine
    from repro_torch.serve.lm_service import LMService

    rng = np.random.default_rng(2026)
    reqs = [(rng.integers(0, model.cfg.vocab_size, s), n, seed)
            for s, n, seed in K_REQS]
    t0 = time.perf_counter()
    solo = [engine.generate(model, p[None], steps=n, seed=s)[0].cpu().numpy()
            for p, n, s in reqs]
    torch.cuda.synchronize()
    print(f"k1 solo generates: {sum(n for _, n, _ in reqs)} tokens in "
          f"{time.perf_counter() - t0:.3f} s [{card}]")
    svc = LMService(model, num_slots=K_SLOTS, chunk_steps=K_CHUNK)
    require(not svc.slot_mode, "k1: a recurrent config must not run in "
            "slot mode")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rids = [svc.submit(p, n, seed=s,
                       deadline=K_DEADLINE if i == len(reqs) - 1 else None)
            for i, (p, n, s) in enumerate(reqs)]
    res = svc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mem1 = torch.cuda.memory_allocated()
    toks = sum(len(res[r].tokens) for r in rids)
    done = [rid for rid, _ in svc.latencies]
    print(f"k1 service (fallback, {K_SLOTS} slots asked): {len(res)} of "
          f"{len(reqs)} completed, {toks} tokens in {wall:.3f} s: "
          f"{toks / wall:.1f} tokens/s; completion order {done}; memory "
          f"{mem0} -> {mem1} bytes [{card}]")
    for i, rid in enumerate(rids):
        r = res[rid]
        same = np.array_equal(r.tokens, solo[i])
        print(f"  req {i}: prompt {r.prompt_len} tokens {len(r.tokens)}: "
              f"{'equal to' if same else 'DIFFERS from'} a direct generate")
        require(same, f"k1 req {i}: the service differs from generate")
    require(done[0] == rids[-1] and done.index(rids[-1]) < done.index(
        rids[0]), "k1: the deadline request did not finish first")
    require(mem1 <= mem0, f"k1: memory {mem0} -> {mem1}")
    prompt = reqs[1][0]
    k_decode_timing(torch, model, engine.prefill(
        model, prompt[None], max_len=len(prompt) + K_TIMED + 3 * K_PROFILED),
        card, "k1")


def k_float32(model):
    """``model``'s weights in float32, in a model of its config in float32
    on its device."""
    import dataclasses

    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(model.cfg, param_dtype="float32",
                              compute_dtype="float32")
    m32 = tf.LM(cfg, model.device)
    m32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    return m32


def k_model(torch, arch: str, card, label: str):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    cfg = get_config(arch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = tf.init_lm(cfg, seed=0)
    torch.cuda.synchronize()
    kinds = tf.layer_kinds(cfg)
    tally = ", ".join(f"{kinds.count(k)} {k}" for k in dict.fromkeys(kinds))
    enc = f" + {cfg.enc_layers} encoder layers" if cfg.enc_layers else ""
    print(f"{label}: {cfg.name}, {len(kinds)} layers ({tally}){enc}, "
          f"{tf.count_params(model):,} parameters ({cfg.param_dtype}, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card), "
          f"initialised in {time.perf_counter() - t0:.2f} s [{card}]")
    return model


def k_long(torch, model, spec: dict, label: str, card, f32_model=None):
    """A long prompt through the service's fallback and through prefill +
    decode, held to each other and to a full forward."""
    import numpy as np

    from repro_torch.serve.lm_service import LMService

    s, steps, cmp = spec["prompt"], spec["steps"], spec["compare"]
    prompt = np.random.default_rng(s).integers(0, model.cfg.vocab_size, s)
    svc = LMService(model, num_slots=K_SLOTS, chunk_steps=K_CHUNK)
    require(not svc.slot_mode, f"{label}: a recurrent config must not run "
            "in slot mode")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = svc.generate(prompt, steps, seed=0).tokens
    torch.cuda.synchronize()
    print(f"{label} fallback generate: {s} + {steps} tokens in "
          f"{time.perf_counter() - t0:.3f} s [{card}]")
    return prompt, k_decode_vs_forward(torch, model, prompt, steps, cmp,
                                       served, label, card, f32_model)


def recurrent_path(torch) -> float:
    """Path k: the recurrent families in the LM service at full width,
    counts reset just before and read just after (the path reaches no
    kernel).  Its models are freed before it returns; returns its
    seconds."""
    from repro_torch.kernels import ops

    card = card_line()
    ops.launch_counts.clear()
    t_path = t0 = time.perf_counter()

    def lap(label: str) -> None:
        nonlocal t0
        torch.cuda.synchronize()
        print(f"{label}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    model = k_model(torch, "recurrentgemma-2b", card, "k1")
    k_service(torch, model, card)
    lap("k1")
    _, st = k_long(torch, model, K_RING, "k2", card)
    ring = next(layer for layer in st.cache["layers"] if "pos" in layer)
    w = ring["k"].shape[2]
    s = K_RING["prompt"]
    print(f"k2: ring of {w} slots, positions {int(ring['pos'].min())}.."
          f"{int(ring['pos'].max())} after {s} + {K_RING['steps']} tokens "
          f"(prefill rolled by {s % w}); RG-LRU scan over {s} positions")
    require(w == model.cfg.local_window and s > w, "k2: the prompt must "
            "pass the local window")
    del model, st, ring
    torch.cuda.empty_cache()
    lap("k2")
    model = k_model(torch, "xlstm-125m", card, "k3")
    m32 = k_float32(model)
    _, st = k_long(torch, model, K_XLSTM, "k3", card, m32)
    del m32
    k_decode_timing(torch, model, st, card, "k3")
    del model, st
    torch.cuda.empty_cache()
    lap("k3")
    i_replay(torch, card, "recurrentgemma-2b", "k4", layers=3)
    torch.cuda.empty_cache()
    i_replay(torch, card, "xlstm-125m", "k4", layers=12)
    torch.cuda.empty_cache()
    lap("k4")
    counts = dict(ops.launch_counts)
    secs = time.perf_counter() - t_path
    print(f"path k launches {counts}; {secs:.1f} s")
    require(not counts, "path k: it reaches no kernel, yet one was launched")
    return secs


# ---------------------------------------------------------------- path l
L_WHISPER = dict(prompt=16, steps=32, compare=8)
L_FRAME_SCALE = 0.05   # stub frames' scale (tests/test_decode_consistency.py)
L_ENCODE_REPS = 5
# prompt length, tokens, seed: whisper's two service requests (fallback),
# then qwen2-vl's six staggered text requests (slot mode, buckets 8-256)
L_SERVICE = [(5, 12, 51), (9, 16, 52)]
L_REQS = [(5, 12, 61), (250, 16, 62), (17, 20, 63), (60, 12, 64),
          (130, 16, 65), (33, 12, 66)]
L_VISION = dict(prompt=64, patches=32, steps=16, compare=8)
L_GRID, L_TEXT = (4, 8), (4, 12)   # l3: a 4 x 8 patch grid between text


def l_frames(torch, model, seed: int):
    """(1, enc_frames, d_model) stub frame embeddings, a standard normal
    from ``seed`` on the card times L_FRAME_SCALE, in the model's
    compute dtype."""
    from repro_torch.models.layers import compute_dtype

    cfg = model.cfg
    g = torch.Generator(device=model.device).manual_seed(seed)
    frames = torch.randn((1, cfg.enc_frames, cfg.d_model), generator=g,
                         device=model.device) * L_FRAME_SCALE
    return frames.to(compute_dtype(cfg))


def l_decode_bytes(model, st) -> int:
    """Bytes a whisper decode step must read: the decoder's weights but
    the cross ``wk`` / ``wv`` (applied once, at the prefill) and the
    token table (gathered by row), the encoder's none, plus the cross
    K/V of every layer in the cache ``st.cache``."""
    def size(t):
        return t.numel() * t.element_size()

    dec = sum(size(p) for name, p in model.named_parameters()
              if not name.startswith("encoder.")
              and not name.endswith(("cross.wk", "cross.wv")))
    dec -= size(model.embed.embedding)
    return dec + sum(size(layer[k]) for layer in st.cache["layers"]
                     for k in ("cross_k", "cross_v"))


def l_whisper(torch, card) -> None:
    """l1: whisper-medium at full width: the encoder's pass over 1,500
    frames timed; ``generate(enc_frames=)`` on a 16-token prompt, 32
    greedy steps, the last 8 against a full forward over the same frames;
    two requests through ``LMService`` (the fallback, on the zero cross
    cache) each equal to a direct ``generate``; a solo decode timed and
    profiled beside its read bound."""
    import numpy as np

    from repro_torch.serve import engine
    from repro_torch.serve.lm_service import LMService

    model = k_model(torch, "whisper-medium", card, "l1")
    cfg = model.cfg
    frames = l_frames(torch, model, seed=7)
    model.encode(frames)                                # warm
    times = []
    for _ in range(L_ENCODE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = model.encode(frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    require(enc.shape == (1, cfg.enc_frames, cfg.d_model)
            and bool(torch.isfinite(enc).all()), "l1: encoder output")
    print(f"l1 encoder: {cfg.enc_layers} layers over {cfg.enc_frames} "
          f"frames ({frames.dtype}): {statistics.median(times) * 1e3:.3f} ms "
          f"(median of {L_ENCODE_REPS}) [{card}]")
    del enc
    s, steps, cmp = (L_WHISPER["prompt"], L_WHISPER["steps"],
                     L_WHISPER["compare"])
    prompt = np.random.default_rng(s).integers(0, cfg.vocab_size, s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = engine.generate(model, prompt[None], steps=steps,
                             enc_frames=frames)[0].cpu().numpy()
    torch.cuda.synchronize()
    print(f"l1 generate(enc_frames=): {s} + {steps} tokens in "
          f"{time.perf_counter() - t0:.3f} s [{card}]")
    m32 = k_float32(model)
    st = k_decode_vs_forward(torch, model, prompt, steps, cmp, served, "l1",
                             card, m32, prefill_kw={"enc_frames": frames},
                             forward_kw={"enc_frames": frames})
    del m32, st
    torch.cuda.empty_cache()
    rng = np.random.default_rng(2027)
    reqs = [(rng.integers(0, cfg.vocab_size, n), k, seed)
            for n, k, seed in L_SERVICE]
    solo = [engine.generate(model, p[None], steps=k, seed=seed)[0]
            .cpu().numpy() for p, k, seed in reqs]
    svc = LMService(model, num_slots=K_SLOTS, chunk_steps=K_CHUNK)
    require(not svc.slot_mode, "l1: an encoder-decoder must not run in "
            "slot mode")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    rids = [svc.submit(p, k, seed=seed) for p, k, seed in reqs]
    res = svc.run()
    mem1 = torch.cuda.memory_allocated()
    for i, rid in enumerate(rids):
        same = np.array_equal(res[rid].tokens, solo[i])
        print(f"  l1 service req {i}: prompt {len(reqs[i][0])} tokens "
              f"{len(res[rid].tokens)} (zero cross cache): "
              f"{'equal to' if same else 'DIFFERS from'} a direct generate")
        require(same, f"l1 req {i}: the service differs from generate")
    require(mem1 <= mem0, f"l1: memory {mem0} -> {mem1}")
    st = engine.prefill(model, prompt[None],
                        max_len=s + K_TIMED + 3 * K_PROFILED,
                        enc_frames=frames)
    k_decode_timing(torch, model, st, card, "l1 (cross cache of "
                    f"{cfg.enc_frames} frames)", l_decode_bytes(model, st))
    del model, st, frames


def l_weight_bytes(model) -> int:
    """Bytes a decode step must read: every weight but the token table
    (gathered by row)."""
    table = model.embed.embedding
    return (k_weight_bytes(model) - table.numel() * table.element_size())


def l_qwen(torch, card) -> None:
    """l2: qwen2-vl-7b at full width: 6 staggered text requests through
    ``LMService(num_slots=4, chunk_steps=8, max_len=512)`` in slot mode
    (M-RoPE at 1-D positions; ``slot_run``); a
    vision-conditioned ``generate`` held to a full forward with the same
    patch embeddings; one decode chunk timed and profiled."""
    import numpy as np

    from repro_torch.models import transformer as tf
    from repro_torch.serve import engine

    model = k_model(torch, "qwen2-vl-7b", card, "l2")
    cfg = model.cfg
    rng = np.random.default_rng(2028)
    reqs = [(rng.integers(0, cfg.vocab_size, n), k, seed)
            for n, k, seed in L_REQS]
    slot_run(torch, model, card, "l2", reqs, K_SLOTS, I_UPFRONT)

    s, n_patch = L_VISION["prompt"], L_VISION["patches"]
    steps, cmp = L_VISION["steps"], L_VISION["compare"]
    prompt = np.random.default_rng(s).integers(0, cfg.vocab_size, s)
    g = torch.Generator(device=model.device).manual_seed(8)
    embeds = torch.zeros((1, s + steps, cfg.d_model), dtype=torch.bfloat16,
                         device=model.device)
    mask = torch.zeros((1, s + steps), dtype=torch.bool, device=model.device)
    lo = (s - n_patch) // 2
    embeds[0, lo:lo + n_patch] = torch.randn(
        (n_patch, cfg.d_model), generator=g, device=model.device).to(
            embeds.dtype)
    mask[0, lo:lo + n_patch] = True
    pre = {"vision_embeds": embeds[:, :s], "vision_mask": mask[:, :s]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = engine.generate(model, prompt[None], steps=steps,
                             **pre)[0].cpu().numpy()
    torch.cuda.synchronize()
    print(f"l2 generate(vision_embeds=): {s} tokens ({n_patch} patch "
          f"embeddings at positions {lo}..{lo + n_patch - 1}) + {steps} in "
          f"{time.perf_counter() - t0:.3f} s [{card}]")
    plain = engine.generate(model, prompt[None], steps=steps)[0].cpu().numpy()
    require(not np.array_equal(served, plain), "l2: the patch embeddings "
            "changed no token")
    m32 = k_float32(model)
    k_decode_vs_forward(torch, model, prompt, steps, cmp, served, "l2",
                        card, m32, prefill_kw=pre,
                        forward_kw={"vision_embeds": embeds,
                                    "vision_mask": mask})
    del m32
    torch.cuda.empty_cache()
    i_decode_timing(torch, model, reqs, card, slots=K_SLOTS, label="l2")
    nbytes = l_weight_bytes(model)
    print(f"l2 weight-read bound a decode step: {nbytes / 1e9:.2f} GB -> "
          f"{nbytes / HBM_BW * 1e3:.2f} ms (at "
          f"{HBM_BW / 1e12:.2f} TB/s); {tf.count_params(model):,} "
          f"parameters")
    del model


def l_mrope_positions(grid=L_GRID, text=L_TEXT):
    """(3, S) t/h/w positions of ``text[0]`` tokens, a patch grid and
    ``text[1]`` tokens, as Qwen2-VL lays them out (text at t = h = w = its
    index; a patch at the grid's start in t, plus its row in h and its
    column in w; text after it from one past the largest), and the
    patches' (S,) mask."""
    import numpy as np

    rows, cols = grid
    t0 = text[0]
    r, c = np.divmod(np.arange(rows * cols), cols)
    patches = np.stack([np.full(rows * cols, t0), t0 + r, t0 + c])
    start = patches.max() + 1
    pos = np.concatenate([np.stack([np.arange(t0)] * 3), patches,
                          np.stack([np.arange(start, start + text[1])] * 3)],
                         axis=1)
    mask = np.zeros(pos.shape[1], bool)
    mask[t0:t0 + rows * cols] = True
    return pos, mask


def l_mrope_replay(torch, card) -> None:
    """l3: qwen2-vl-7b at full width with 2 layers, float32, on the card
    and the CPU: one forward at explicit (3, 1, S) positions with distinct
    t/h/w streams (a 4 x 8 patch grid between text, patch embeddings from
    a seed), every position's logits within I_REPLAY_RTOL and its argmax
    equal (but at a tie)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_config("qwen2-vl-7b"), num_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    card_model = tf.init_lm(cfg, seed=2)
    cpu_model = tf.LM(cfg, device="cpu")
    cpu_model.load_state_dict(card_model.state_dict())
    pos, mask = l_mrope_positions()
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (1, pos.shape[1]))
    embeds = rng.standard_normal((1, pos.shape[1], cfg.d_model)).astype(
        np.float32)
    print(f"l3: {cfg.name} x {cfg.num_layers} layers, "
          f"{tf.count_params(cpu_model):,} float32 parameters on both; "
          f"{pos.shape[1]} positions, t/h/w streams up to "
          f"{pos.max(axis=1).tolist()}, patches at {int(mask.argmax())}.."
          f"{int(mask.argmax()) + int(mask.sum()) - 1}")
    out = {}
    for name, model in (("card", card_model), ("cpu", cpu_model)):
        t0 = time.perf_counter()
        dev = model.device
        logits, _ = model(
            torch.as_tensor(toks, device=dev),
            positions=torch.as_tensor(pos[:, None], device=dev),
            vision_embeds=torch.as_tensor(embeds, device=dev),
            vision_mask=torch.as_tensor(mask[None], device=dev))
        out[name] = logits[0].cpu()
        print(f"  {name}: {time.perf_counter() - t0:.2f} s"
              f"{f' [{card}]' if name == 'card' else ''}")
    lc, lh = out["card"], out["cpu"]
    tol = I_REPLAY_RTOL * lh.abs().max(-1).values
    err = (lc - lh).abs().max(-1).values
    worst = int((err / tol).argmax())
    print(f"  {len(lh)} positions: max |card - CPU| {err[worst]:.3e} (tol "
          f"{tol[worst]:.3e}) at position {worst}, the largest share of "
          f"its tolerance")
    require(bool((err <= tol).all()), "l3: the M-RoPE forward's logits "
            "differ")
    top = torch.topk(lh, 2).values
    ties = (top[:, 0] - top[:, 1]) <= tol
    same = lc.argmax(-1) == lh.argmax(-1)
    print(f"  argmax equal at {int(same.sum())} of {len(lh)} positions "
          f"({int((~same & ties).sum())} differ at a tie)")
    require(bool((same | ties).all()), "l3: a token differs beyond a tie")
    del card_model


def multimodal_path(torch) -> float:
    """Path l: whisper-medium's encoder and cross cache and qwen2-vl-7b's
    M-RoPE and vision inputs at full width, counts reset just before and
    read just after (the path reaches no kernel).  Its models are freed
    before it returns; returns its seconds."""
    from repro_torch.kernels import ops

    card = card_line()
    ops.launch_counts.clear()
    t_path = t0 = time.perf_counter()

    def lap(label: str) -> None:
        nonlocal t0
        torch.cuda.synchronize()
        print(f"{label}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    l_whisper(torch, card)
    torch.cuda.empty_cache()
    lap("l1")
    l_qwen(torch, card)
    torch.cuda.empty_cache()
    lap("l2")
    # a float32 cache: the two encoders differ by ~1e-4 (the sinusoid's
    # exp rounds an ulp apart on the card and the CPU), and a bfloat16
    # self cache turns such differences into a bfloat16 ulp where a value
    # sits at a rounding boundary (1.6e-3 of max |logit| on flat logits,
    # against 2.6e-6 with a float32 cache; PERF.md section 6)
    i_replay(torch, card, "whisper-medium", "l3", layers=2, frames=True,
             cache_dtype=torch.float32, enc_layers=2)
    torch.cuda.empty_cache()
    l_mrope_replay(torch, card)
    torch.cuda.empty_cache()
    lap("l3")
    counts = dict(ops.launch_counts)
    secs = time.perf_counter() - t_path
    print(f"path l launches {counts}; {secs:.1f} s")
    require(not counts, "path l: it reaches no kernel, yet one was launched")
    return secs


# ---------------------------------------------------------------- path m
# Training (``repro_torch.train``, ``examples/train_lm.py`` and
# ``examples/train_svm_e2e.py``).  m1: h2o-danube-1.8b at full width through
# train_lm's code with --full: bfloat16 parameters, float32 AdamW state,
# every block rematerialised, B = 4, S = 1,024 from TokenPipeline(seed=0),
# JAX's example settings (lr 1e-3, warm-up 20).  gemma-7b (8.54 B) would
# need ~137 GB of parameters, grads and AdamW state, deepseek-v2-lite-16b
# more: neither fits one card.  m2: a float32 train step of three reduced
# configs on the card and the CPU.  m3: train_svm_e2e's nu fit on the card
# (kernels 1-3, recorded for phase 5), its iterations cut.
M_TRAIN = ["--full", "--arch", "h2o-danube-1.8b", "--batch", "4",
           "--seq", "1024", "--steps", "8"]
M_PROFILED = 2
M_REPLAY = (("h2o-danube-1.8b", 80),       # above the reduced window of 64
            ("deepseek-v2-lite-16b", 32),  # MLA, MoE, a non-zero aux
            ("xlstm-125m", 32))            # mLSTM and sLSTM
M_REPLAY_STEPS = 3
M_METRIC_RTOL, M_GRAD_RTOL, M_LOSS_RTOL = 1e-5, 1e-4, 1e-4
M_PARAM_ATOL = 1e-6   # after step 1, where |g| > 1e-3 of the leaf's max
M_SVM = ["--n", "20000", "--d", "256", "--variant", "nu"]
M_SVM_ITERS = (20_000, 2_000)   # the script's default, the cut


def m_bound(cfg, n_params: int, tokens: int, batch: int, seq: int):
    """A step's least time: the bf16 FLOPs of forward, remat and backward
    (8 N tokens) over the dense bf16 peak, plus the chunked attention's
    float32 score products (q k^T of every query against every key, as
    the port computes them: forward, remat and the backward's two, 4 x 2
    B H S^2 Dh a layer) over the float32 peak.  Returns (ms, bf16 FLOPs,
    float32 FLOPs)."""
    bf16 = 8 * n_params * tokens
    f32 = (4 * 2 * batch * cfg.num_heads * seq * seq * cfg.head_dim
           * cfg.num_layers)
    return (bf16 / PEAK_FLOPS + f32 / F32_FLOPS) * 1e3, bf16, f32


def m_train(torch, card) -> list:
    """m1: train_lm --full at h2o-danube-1.8b's published widths; returns
    its losses."""
    import numpy as np

    from repro_torch.examples import train_lm
    from repro_torch.models import transformer as tf

    args = train_lm.parse_args(M_TRAIN)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = train_lm.Trainer(args)
    torch.cuda.synchronize()
    model, st = tr.state.model, tr.state.opt_state
    n = tf.count_params(model)
    def nbytes(tensors) -> int:
        return sum(t.numel() * t.element_size() for t in tensors)

    p_bytes = nbytes(model.parameters())
    state_bytes = (2 * p_bytes + nbytes(st.master.values())
                   + nbytes(st.m.values()) + nbytes(st.v.values()))
    print(f"m1: {tr.cfg.name} at full width, {n:,} parameters "
          f"({tr.cfg.param_dtype}), AdamW state {tr.ocfg.state_dtype}, "
          f"remat {model.remat}; B = {args.batch}, S = {args.seq}; "
          f"parameters, grads and AdamW state {state_bytes / 1e9:.2f} GB; "
          f"set up in {time.perf_counter() - t0:.2f} s [{card}]")
    out = tr.train(args.steps, log_every=1)
    losses, norms = out["loss"], out["grad_norm"]
    require(bool(np.isfinite(losses).all() and np.isfinite(norms).all()),
            "m1: a non-finite loss or grad norm")
    require(losses[-1] < losses[0], f"m1: the loss did not fall "
            f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    ms = statistics.median(out["step_s"][1:]) * 1e3
    tokens = args.batch * args.seq
    peak = torch.cuda.max_memory_allocated()
    ev = tr.evaluate()
    require(math.isfinite(ev["loss"]), "m1: a non-finite eval loss")
    bound, bf16, f32 = m_bound(tr.cfg, n, tokens, args.batch, args.seq)
    print(f"m1: loss {losses[0]:.4f} -> {losses[-1]:.4f} over {args.steps} "
          f"steps (eval {ev['loss']:.4f}); {ms:.3f} ms a step (median of "
          f"steps 2-{args.steps}; step 1 {out['step_s'][0] * 1e3:.1f} ms), "
          f"{tokens / ms * 1e3:.1f} tokens a second; peak memory "
          f"{peak / 1e9:.2f} GB against {state_bytes / 1e9:.2f} GB of "
          f"state [{card}]")
    prof = profile_window(torch, f"m1 train steps of {tr.cfg.name} [{card}]",
                          M_PROFILED, lambda: tr.train(M_PROFILED))
    print(f"m1 bound: {bf16:.3e} bf16 FLOPs (8 N tokens) at "
          f"{PEAK_FLOPS / 1e12:.0f} TFLOP/s + {f32:.3e} float32 FLOPs "
          f"(the score products) at {F32_FLOPS / 1e12:.0f} TFLOP/s = "
          f"{bound:.3f} ms a step; measured {ms:.3f} ms ({ms / bound:.2f}x)"
          + ("" if prof is None else
             f", device {prof['device_ms']:.3f} ms, "
             f"{prof['launches']:.1f} launches and idle "
             f"{prof['idle']:.4f} a step") + f" [{card}]")
    del tr, model, st
    return losses


def m_replay(torch, card) -> None:
    """m2: a float32 train step of each M_REPLAY config on the card and
    the CPU from the same seed-drawn weights and batches."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.device import resolve_device
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps

    for arch, seq in M_REPLAY:
        cfg = get_config(arch).reduced()
        ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=4)
        cpu = steps.init_train_state(cfg, ocfg, seed=0, device="cpu")
        model = copy.deepcopy(cpu.model).to(resolve_device())
        gpu = steps.TrainState(model, opt.init(model, ocfg))
        pipe = TokenPipeline(cfg.vocab_size, seq, 2, seed=0)
        batches = [pipe.next_batch() for _ in range(M_REPLAY_STEPS)]
        metrics, grads, params = {}, {}, {}
        t0 = time.perf_counter()
        for name, st in (("card", gpu), ("cpu", cpu)):
            dev = st.model.device
            tb = [{"tokens": torch.as_tensor(b.tokens, device=dev),
                   "targets": torch.as_tensor(b.targets, device=dev)}
                  for b in batches]
            train_step = steps.make_train_step(cfg, ocfg)
            loss, _, g = steps.value_and_grad(st.model, cfg, tb[0])
            grads[name] = {n: t.float().cpu() for n, t in g.items()}
            ms = []
            for i, b in enumerate(tb):
                st, m = train_step(st, b)
                ms.append({k: float(v) for k, v in m.items()})
                if i == 0:
                    params[name] = {n: p.detach().cpu().clone() for n, p in
                                    st.model.named_parameters()}
            metrics[name] = ms
            require(abs(float(loss) - ms[0]["loss"]) == 0.0,
                    f"m2 {arch} {name}: value_and_grad and the train step "
                    "disagree")
        first = {k: (metrics["card"][0][k], metrics["cpu"][0][k])
                 for k in ("loss", "ce", "aux", "grad_norm")}
        rel = {k: abs(a - b) / max(abs(b), 1e-30) for k, (a, b)
               in first.items()}
        gerr = max(float((grads["card"][k] - g).abs().max())
                   / max(float(g.abs().max()), 1e-30)
                   for k, g in grads["cpu"].items())
        perr = 0.0
        for k, g in grads["cpu"].items():
            big = g.abs() > 1e-3 * g.abs().max()
            diff = (params["card"][k] - params["cpu"][k]).float()[big]
            if diff.numel():
                perr = max(perr, float(diff.abs().max()))
        lrel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b
                   in zip(metrics["card"], metrics["cpu"]))
        print(f"m2 {arch} (S = {seq}, float32, {M_REPLAY_STEPS} steps, "
              f"{time.perf_counter() - t0:.1f} s): step 1 "
              + ", ".join(f"{k} {a:.6f} / {b:.6f}" for k, (a, b)
                          in first.items())
              + f" (card / CPU; largest relative difference "
              f"{max(rel.values()):.3e}, tol {M_METRIC_RTOL:g}); grads "
              f"{gerr:.3e} of their leaf's max (tol {M_GRAD_RTOL:g}); "
              f"parameters after step 1 {perr:.3e} where |g| > 1e-3 of the "
              f"max (tol {M_PARAM_ATOL:g}); losses of {M_REPLAY_STEPS} steps "
              f"{lrel:.3e} (tol {M_LOSS_RTOL:g}) [{card}]")
        require(max(rel.values()) <= M_METRIC_RTOL and gerr <= M_GRAD_RTOL
                and perr <= M_PARAM_ATOL and lrel <= M_LOSS_RTOL,
                f"m2 {arch}: the card's train step differs from the CPU's")
        if arch.startswith("deepseek"):
            require(first["aux"][0] > 0, "m2: deepseek's aux is zero")
        del model, gpu, cpu


def m_svm(torch, rec: PathRecorder, card) -> None:
    """m3: train_svm_e2e's default nu fit on the card, its checkpoint in
    a temporary directory."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.examples import train_svm_e2e
    from repro_torch.train import checkpoint

    full, cut = M_SVM_ITERS
    print(f"m3: train_svm_e2e {' '.join(M_SVM)}, --iters cut from the "
          f"script's {full:,} to {cut:,} (serial nu runs 3.4-4.4 ms a step, "
          f"PERF.md section 5)")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_m_"))
    try:
        ckpt = str(tmp / "svm_e2e.npz")
        with rec:
            out = train_svm_e2e.main(M_SVM + ["--iters", str(cut), "--ckpt",
                                              ckpt])
        clf = out["clf"]
        back = checkpoint.restore(ckpt, {"w": clf.w_,
                                         "b": np.asarray(clf.b_)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    objs = [o for _, o in out["history"]]
    print(f"m3: {len(objs)} records, objective {objs[0]:.6f} -> "
          f"{objs[-1]:.6f}; fit {out['seconds']:.3f} s "
          f"({out['seconds'] / cut * 1e3:.3f} ms a step); train accuracy "
          f"{out['train_acc']:.4f}, test accuracy {out['test_acc']:.4f} "
          f"[{card}]")
    require(bool(np.isfinite(objs).all()) and objs[-1] < objs[0]
            and max(objs) <= objs[0], "m3: the objective did not fall or "
            "rose above its first record")
    require(np.array_equal(back["w"], clf.w_) and back["w"].dtype
            == clf.w_.dtype and float(back["b"]) == clf.b_,
            "m3: the checkpoint does not restore w_ and b_ bit for bit")
    print("m3: the checkpoint restores w_ and b_ bit for bit")


def training_path(torch, rec: PathRecorder, p1: dict) -> float:
    """Path m: training, counts reset just before and read just after;
    m3's kernel calls recorded by ``rec``; path p's p1 held to m1's
    losses.  Its models are freed before it returns; returns its
    seconds."""
    from repro_torch.kernels import ops

    card = card_line()
    ops.launch_counts.clear()
    t_path = t0 = time.perf_counter()
    p_versus_m1(p1, m_train(torch, card))
    torch.cuda.empty_cache()
    print(f"m1: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m_replay(torch, card)
    torch.cuda.empty_cache()
    print(f"m2: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m_svm(torch, rec, card)
    print(f"m3: {time.perf_counter() - t0:.1f} s")
    counts = dict(ops.launch_counts)
    secs = time.perf_counter() - t_path
    print(f"path m launches {counts}; {secs:.1f} s")
    rec.check_counts(counts, ("fwht",) + PACKED)
    return secs


# ---------------------------------------------------------------- path n
# The analysis gate on the card and the examples.  n1: the lint's serial
# targets (``analysis.lint.serial_targets``) with the CUDA kernels, every
# chunk under set_sync_debug_mode("error"), STATE-001 by memory_allocated,
# STEP-001 by the launch tally; one profiled packed chunk (2 device
# launches of the packed kernels a step).  The k = 8 targets run on the
# CPU only (path f's spawn is already the script's largest fixed cost).
# n2: the launch-plan audit, MAX_SMEM, the compiled static shared memory
# and the launchers' geometry against the plans, and three audited shapes
# with every output filled with NaN first.  n3: the examples quickstart and distributed_svm
# at their data sizes, iterations cut (N_QUICKSTART / N_DISTRIBUTED beside
# the scripts' own counts).
N_QUICKSTART = dict(hm_iters=4000, gilbert_iters=3000, nu_iters=1500)
N_QUICKSTART_FULL = dict(hm_iters=20000, gilbert_iters=3000, nu_iters=10000)
N_DISTRIBUTED = dict(hm_iters=2000, gilbert_iters=2000, nu_iters=1000,
                     record_every=250, gilbert_every=500)
N_DISTRIBUTED_FULL = dict(hm_iters=8000, gilbert_iters=2000, nu_iters=6000)
N_PROFILED = 8          # steps of the profiled packed chunk
# n2's shapes: a packed rung, the unpacked reference step's client shape
# at B = 128, the FWHT in two passes
N_NAN_PACKED = (8, 256, 2048, 8)            # S, d, n_pad, b
N_NAN_UNPACKED = (20, 251, 128)             # K, n, B
N_NAN_FWHT = (195, 65_536)                  # n, d


def n_lint(torch) -> None:
    """n1: the lint's serial targets on the card, zero findings."""
    from repro_torch.analysis import lint

    t0 = time.perf_counter()
    targets = lint.serial_targets()
    records, findings = lint.lint_all(targets, "cuda")
    live, waived = lint.apply_suppressions(findings)
    for rec in records:
        print(f"  n1 {rec}")
    for f in findings:
        print(f"  n1 FINDING {f.rule} {f.target}: {f.detail}")
    print(f"n1 lint on the card: {len(records)} targets, {len(findings)} "
          f"findings, {len(live)} unsuppressed, {len(waived)} suppressed, "
          f"{time.perf_counter() - t0:.1f} s")
    require(not live, f"n1: {len(live)} unsuppressed lint findings")
    # the card's own check: a read-back planted in the packed step must be
    # refused by the sync debug mode
    from repro_torch.core import engine
    step = engine._step_packed_core

    def planted(*args, **kw):
        out = step(*args, **kw)
        out.w.sum().item()
        return out

    engine._step_packed_core = planted
    try:
        _, caught = lint.lint_target(targets[0], "cuda")
    finally:
        engine._step_packed_core = step
    print(f"n1 planted .item() in the packed step: {caught}")
    require(any(f.rule == "SYNC-001" and "set_sync_debug_mode" in f.detail
                for f in caught), "n1: the planted .item() was not caught")
    for t, rec in zip(targets, records):
        want = {k: v for k, v in t.per_unit.items() if k in PACKED}
        require(rec.get("calls_per_unit", {}) == want,
                f"n1 {t.name}: packed launches a unit "
                f"{rec.get('calls_per_unit')}, want {want}")
    kernels = n_profiled_chunk(torch, targets[0])
    print(f"n1 profiled chunk of {targets[0].name}, {N_PROFILED} steps: "
          f"device launches {dict(kernels)}")
    require(kernels == Counter({name: N_PROFILED for name in PACKED}),
            "n1: want 2 packed device launches a step")


def n_profiled_chunk(torch, target) -> Counter:
    """The device's own launches of the packed kernels in one profiled
    chunk of ``target`` (N_PROFILED steps), after a warm-up cycle of the
    profiler.  A session that is not a process's first can lose the device
    events of its first milliseconds (``Timer.device_ms``): so each cycle
    first keeps the device busy for ~50 ms with fills of a flush buffer,
    and only then runs the chunk."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    ctx = target.setup(torch.device("cuda"), None)
    target.run(ctx, target.init(ctx), N_PROFILED)
    flush = torch.empty(128 << 20, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            for _ in range(300):
                flush.zero_()
            torch.cuda.synchronize()
            target.run(ctx, target.init(ctx), N_PROFILED)
            torch.cuda.synchronize()
            prof.step()
    del flush
    require(len(traced) == 1, "n1: the profiler gave no active cycle")
    kernels = Counter()
    for ev in traced[0]:
        if ev.device_type == DeviceType.CUDA:
            for name in PACKED:
                if name + "_kernel" in ev.key:
                    kernels[name] += ev.count
    return kernels


def n_nan_check(torch, name, fn, plain, real, label) -> None:
    """One wrapper call with every tensor it allocates (its outputs) and
    the kernels' workspace scratch filled with NaN first: every element
    must come out written and within phase 5's tolerances of the plain
    version."""
    from repro_torch.kernels import saddle_update as su

    for _counters, scratch in su._workspace.values():
        scratch.fill_(math.nan)
    empty, empty_like = torch.empty, torch.empty_like

    def nan_empty(*args, **kw):
        return empty(*args, **kw).fill_(math.nan)

    def nan_empty_like(*args, **kw):
        return empty_like(*args, **kw).fill_(math.nan)

    torch.empty, torch.empty_like = nan_empty, nan_empty_like
    try:
        got = fn()
    finally:
        torch.empty, torch.empty_like = empty, empty_like
    want = plain()
    outs = (got,) if isinstance(got, torch.Tensor) else got
    written = all(not torch.isnan(o).any().item() for o in outs)
    if name == "fwht":
        errs = {"out": ((got - want).abs().max().item(), 1e-4)}
    elif name in PACKED:
        errs = packed_errors(torch, name, got, want, real)
    else:
        errs = unpacked_errors(torch, name, got, want, real)
    print(f"  n2 {name}{label}: every output element written {written}; "
          + ", ".join(f"{k} {e:.3e} (tol {t})" for k, (e, t) in errs.items()))
    require(written, f"n2 {name}{label}: an output element was not written")
    require(all(e <= t for e, t in errs.values()),
            f"n2 {name}{label}: {errs}")


def geometry_mismatches(ctypes, build, kernel_audit) -> list:
    """Every audited plan's launches beside the grid, threads and dynamic
    shared memory the C launchers derive for the same arguments (the
    libraries' ``launch_geometry`` / ``fwht_geometry``): [(case, plan's,
    library's)] where they differ."""
    which = {"momentum_dot_packed": 0, "mwu_update_packed": 1,
             "momentum_dot": 2, "mwu_update": 3}
    saddle, fwht_lib = build.library("saddle_update"), build.library("fwht")
    reg = kernel_audit.registry()
    out = (ctypes.c_uint * 4)()
    differ = []
    for c in kernel_audit.audit_cases():
        plan = reg[c.kernel](**c.kwargs)
        for p in kernel_audit.launches(plan):
            mine = (*p["grid"], p["dynamic_smem"])
            if c.kernel == "fwht":
                a = p["args"]
                build.check(fwht_lib.fwht_geometry(
                    a["rows"], a["d2"] or 0, a["log_m"] or 0, out),
                    "fwht_geometry")
                mine = (p["grid"][0], p["threads"], p["dynamic_smem"])
                theirs = tuple(out[:3])
            else:
                kw = c.kwargs
                g = list(p["args"].values())
                build.check(saddle.launch_geometry(
                    which[c.kernel], kw.get("s", kw.get("k")),
                    kw.get("n_pad", kw.get("n")), kw["b"], g[0],
                    g[1] if len(g) > 1 else 0, out), "launch_geometry")
                theirs = tuple(out[:4])
            if mine != theirs:
                differ.append((f"{c.kernel} [{c.case}]", mine, theirs))
    return differ


def n_audit(torch) -> None:
    """n2: the launch-plan audit beside the card."""
    import ctypes

    from repro_torch.analysis import kernel_audit
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import saddle_update as su

    t0 = time.perf_counter()
    records, findings = kernel_audit.audit_all()
    print(f"n2 audit: {len(records)} kernel cases, {len(findings)} findings "
          f"({time.perf_counter() - t0:.1f} s)")
    for f in findings:
        print(f"  n2 FINDING {f.rule} {f.kernel} [{f.case}]: {f.detail}")
    require(not findings, "n2: audit findings")
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    print(f"n2 MAX_SMEM {su.MAX_SMEM} B, the card's opt-in limit {optin} B")
    require(su.MAX_SMEM == optin, "n2: MAX_SMEM is not the card's limit")
    lib = build.library("saddle_update")
    compiled = []
    for i, name in enumerate(kernel_audit.STATIC_SMEM_ORDER):
        v = ctypes.c_int(-1)
        build.check(lib.static_smem(i, ctypes.byref(v)), "static_smem")
        compiled.append((name, v.value, kernel_audit.STATIC_SMEM[name]))
    print(f"n2 static shared memory (kernel, compiled, plan): {compiled}")
    require(all(c == p for _, c, p in compiled),
            "n2: the plans' static shared memory is not the compiled one")
    differ = geometry_mismatches(ctypes, build, kernel_audit)
    print(f"n2 launch geometry: {len(records)} plans against the "
          f"libraries' launch_geometry / fwht_geometry, {len(differ)} "
          f"differ")
    for case, plan, lib_says in differ[:5]:
        print(f"  n2 GEOMETRY {case}: plan {plan}, library {lib_says}")
    require(not differ, "n2: a plan's grid or shared memory is not the "
            "launcher's")

    g = torch.Generator(device="cuda").manual_seed(25)
    s, d, n_pad, b = N_NAN_PACKED
    x_t = torch.randn((s, d, n_pad), generator=g, device="cuda") / 16
    sign = torch.zeros((s, n_pad), device="cuda")
    sign[:, :n_pad // 3], sign[:, n_pad // 3:n_pad - 100] = 1.0, -1.0
    x_t[:, :, n_pad - 100:] = 0.0
    a = step_inputs(torch, g, x_t, sign, b)
    real = sign != 0
    for name, args in (
            ("momentum_dot_packed", (x_t, a["idx"], a["ll"], a["lp"], sign,
                                     a["theta"])),
            ("mwu_update_packed", (x_t, a["idx"], a["ll"], a["u"], a["dw"],
                                   sign, a["mwu_c"], a["mwu_dot"],
                                   a["d_eff"]))):
        n_nan_check(torch, name,
                    lambda name=name, args=args: getattr(ops, name)(*args),
                    lambda name=name, args=args:
                    getattr(ref, name + "_ref")(*args),
                    real, f"[S={s},d={d},n_pad={n_pad},b={b}]")
    k, n, b = N_NAN_UNPACKED
    cols = torch.randn((k, n, b), generator=g, device="cuda")
    ll = torch.randn((k, n), generator=g, device="cuda") - math.log(n)
    lp = ll + 0.1 * torch.randn((k, n), generator=g, device="cuda")
    u = 0.1 * torch.randn((k, n), generator=g, device="cuda")
    dw = 0.01 * torch.randn((k, b), generator=g, device="cuda")
    label = f"[K={k},n={n},B={b}]"
    scal = (-1.0, 1e-3, 40.0, float(b))
    for name, fn, plain in (
            ("momentum_dot", lambda: ops.momentum_dot(cols, ll, lp, 0.95),
             lambda: ref.momentum_dot_ref(cols, ll, lp, 0.95)),
            ("mwu_update", lambda: ops.mwu_update(cols, ll, u, dw, *scal,
                                                  normalize=False),
             lambda: ref.mwu_update_ref(cols, ll, u, dw, *scal,
                                        normalize=False))):
        n_nan_check(torch, name, fn, plain,
                    torch.ones_like(ll, dtype=torch.bool), label)
    n, d = N_NAN_FWHT
    x = torch.randn((n, d), generator=g, device="cuda")
    n_nan_check(torch, "fwht", lambda: ops.fwht(x),
                lambda: ref.fwht_ref(x), None, f"[n={n},d={d}, two passes]")


def falls(objs) -> bool:
    """The objective ends below its first record and never rises above
    it."""
    return objs[-1] < objs[0] and max(objs) <= objs[0]


def n_examples(torch, card) -> None:
    """n3: quickstart and distributed_svm on the card, iterations cut."""
    from repro_torch.core import distributed, engine, projections
    from repro_torch.examples import distributed_svm, quickstart

    print(f"n3 quickstart, iterations {N_QUICKSTART} (the script's "
          f"{N_QUICKSTART_FULL}) [{card}]")
    q = quickstart.run("cuda", **N_QUICKSTART)
    nu_objs = [o for _, o in q["nu"].history_]
    print(f"n3 quickstart: hard margin {q['hm_seconds']:.2f} s, test "
          f"accuracy {q['hm_acc']:.4f}, Saddle-SVC margin "
          f"{q['hm'].margin_:.6f} beside Gilbert's distance "
          f"{q['gilbert_distance']:.6f}; nu {q['nu_seconds']:.2f} s, test "
          f"accuracy {q['nu_acc']:.4f}, objective history {nu_objs}")
    require(all(math.isfinite(o) for o in nu_objs) and falls(nu_objs),
            "n3 quickstart: the nu objective does not fall")
    require(math.isfinite(q["hm"].margin_) and q["hm"].margin_ > 0,
            "n3 quickstart: no margin")

    print(f"n3 distributed_svm, iterations {N_DISTRIBUTED} (the script's "
          f"{N_DISTRIBUTED_FULL})")
    colls = Counter(engine.collective_counts)
    out = distributed_svm.run("cuda", **N_DISTRIBUTED)
    colls = Counter(engine.collective_counts) - colls
    k, d = out["k"], out["pre"].xp.shape[1]
    want = Counter()
    for key, rows, rounds in (
            ("hm", "hm_rows", 0.0),
            ("nu", "nu_rows", float(projections.BISECT_ROUNDS_SOLVER))):
        model = distributed.CommModel(k=k, nu_rounds_per_iter=rounds)
        units = [model.scalars_per_iteration() * it / (k * d)
                 for it, _, _ in out[rows]]
        objs = [o for *_, o in out[rows]]
        print(f"  {key}: {out[key + '_seconds']:.2f} s, rows {out[rows]}")
        require([u for _, u, _ in out[rows]] == units,
                f"n3 distributed_svm {key}: comm differs from CommModel")
        require(all(math.isfinite(o) for o in objs) and falls(objs),
                f"n3 distributed_svm {key}: the objective does not fall")
        steps = out[rows][-1][0]
        want.update(expected_collectives(out[key], steps, d))
    print(f"  distributed Gilbert: {out['gilbert_seconds']:.2f} s, rows "
          f"{out['gilbert_rows']}")
    print(f"  tallied client reductions {dict(colls)}")
    require(colls == want, "n3 distributed_svm: the tallied client "
            "reductions differ from CommModel")


def analysis_path(torch, rec: PathRecorder) -> float:
    """Path n: n1 and n3 with the launch counts reset just before and read
    just after (n1's calls counted but not kept, n3's recorded for phase
    5), then n2, whose comparison launches are not the path's.  Returns
    its seconds."""
    from repro_torch.kernels import ops

    card = card_line()
    t_path = time.perf_counter()
    ops.launch_counts.clear()
    rec.keep = False
    with rec:
        n_lint(torch)
        torch.cuda.empty_cache()
        rec.keep = True
        t0 = time.perf_counter()
        n_examples(torch, card)
        print(f"n3: {time.perf_counter() - t0:.1f} s")
    counts = dict(ops.launch_counts)
    print(f"path n launches {counts}")
    rec.check_counts(counts, ("fwht",) + PACKED)
    t0 = time.perf_counter()
    n_audit(torch)
    print(f"n2: {time.perf_counter() - t0:.1f} s")
    secs = time.perf_counter() - t_path
    print(f"path n: {secs:.1f} s [{card}]")
    return secs


# ---------------------------------------------------------------- path o
# The launch family (``repro_torch.launch``).  o1: the launch dry-run's
# solver and serving entries, one rank each on a fake group of k = 256 or
# 512 ranks (``launch.mesh.init_fake_group``) with its shard on the card:
# kernels 1-2 at the dry-run's shard shapes (S = 1, d = 256, n_pad 4,096 /
# 2,048, b = 128 / 1), the lanes entry's (S = 2 / 1, d = 64, n_pad 4,096,
# b = 1) and a model column's points (S = 2, d = 256, n_pad 65,536 /
# 32,768, b = 128), one step of each entry copied for phase 5.  A fake
# group is its process's default group: path f destroyed its own, so each
# entry makes one in this process and destroys it (a spawned child would
# add ~10 s of start-up and exit to the path).  The fake backend takes CUDA
# tensors (torch 2.11.0+cu128).  o2: ``launch.train`` at world size 1 on
# a reduced config as a user calls it; then the launcher's trainer again
# on the card (its losses bit for bit: the same entry) and on the CPU from
# the card's starting weights (the card's draw differs from the CPU's), at
# path m2's loss tolerance (no SVM kernel on it).  The CPU tests hold the
# launcher to the JAX package's.
O_TRAIN = ["--arch", "h2o-danube-1.8b", "--steps", "2"]


def o_train(torch) -> None:
    """o2: ``launch.train`` on the card; its trainer again on the card
    and on the CPU from the same starting weights."""
    import copy

    from repro_torch.launch import train
    from repro_torch.train import optimizer as opt, steps

    got = train.main(O_TRAIN)
    args = train.parse_args(O_TRAIN)
    card = train.make_trainer(args)
    cpu = train.make_trainer(train.parse_args(O_TRAIN + ["--device", "cpu"]))
    model = copy.deepcopy(card.state.model).to("cpu")
    cpu.state = steps.TrainState(model, opt.init(model, cpu.ocfg))
    n = len(got)
    again, ref = card.train(n)["loss"], cpu.train(n)["loss"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(again, ref))
    print(f"o2 launch.train {O_TRAIN} on the card: losses {got!r}; its "
          f"trainer again {again!r}; on the CPU from the same weights "
          f"{ref!r} (largest relative difference {rel:.3e}, tol "
          f"{M_LOSS_RTOL:g})")
    require(n == 2 and got == again,
            "o2: launch.train's losses change between two runs on the card")
    require(rel <= M_LOSS_RTOL,
            "o2: launch.train's losses on the card differ from the CPU's")


def launch_path(torch, rec: PathRecorder) -> float:
    """Path o: o1 (its packed calls recorded by ``rec``, one step of each
    entry copied) and o2, with the launch counts reset just before and
    read just after; o2 must add none.  Returns its seconds."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, specs

    card = card_line()
    t_path = time.perf_counter()
    require(not torch.distributed.is_initialized(),
            "path o: a default process group is still up")
    entries = ([(specs.SOLVER_ARCH, n, dryrun.run_one_saddle)
                for n in specs.SADDLE_DSVC_SHAPES]
               + [(specs.SERVE_ARCH, n, dryrun.run_one_saddle_serve)
                  for n in specs.SADDLE_SERVE_SHAPES])
    ops.launch_counts.clear()
    with rec:
        for entry, name, run in entries:
            for multi_pod in (False, True):
                rec.arm(f"{entry} {name} "
                        f"{'multi' if multi_pod else 'single'}", skip=0)
                ca = run(name, multi_pod, device="cuda")["comm_audit"]
                require(ca["match"] and ca["device"] == "cuda",
                        f"o1 {entry} {name}: {ca}")
    torch.cuda.synchronize()
    o1_s = time.perf_counter() - t_path
    print(f"o1: {len(entries) * 2} dry-run records on the card, each equal "
          f"to its model, {o1_s:.1f} s")
    o_train(torch)
    counts = dict(ops.launch_counts)
    print(f"path o launches {counts}")
    rec.check_counts(counts, PACKED)
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_path
    print(f"path o: {secs:.1f} s (o1 {o1_s:.1f}, o2 {secs - o1_s:.1f}) "
          f"[{card}]")
    return secs


def serial_vs_dist(torch, fits):
    """Each distributed fit refit serially on the coordinates it drew."""
    from repro_torch.core import saddle

    for fit in fits:
        label, _data, kw, _alpha = fit["spec"]
        pre, res = fit["pre"], fit["res"]
        t0 = time.perf_counter()
        ser = saddle.solve(pre.xp, pre.xm, nu=fit["nu"], eps=kw["eps"],
                           beta=kw["beta"], num_iters=kw["num_iters"],
                           record_every=kw["record_every"],
                           idx_schedule=fit["sched"], device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        dw = (ser.state.w - res.state.w[0]).abs().max().item()
        objs = [(m, o) for m, _, o in res.history]
        print(f"{label}: serial on the same coordinates {secs:.3f} s "
              f"({secs / kw['num_iters'] * 1e3:.4f} ms/step); max|dw| "
              f"{dw:.3e} (tol {FIT_ATOL})")
        print(f"  serial history      {ser.history}")
        print(f"  distributed history {objs}")
        require(dw <= FIT_ATOL, f"{label}: serial and distributed differ")


# ---------------------------------------------------------------- phase 3
def check_fwht(torch, timer, g, n, d, launches, path):
    """The FWHT at (n, d) against its plain version (1e-4; bit-equality
    printed), with its times beside ``x @ H`` (``fwht_library``) and a
    copy of the same bytes under the same events; one call must be as many
    device launches as its plan has passes."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fwht import fwht_plan

    x = torch.randn((n, d), generator=g, device="cuda")
    out = ops.fwht(x)
    want = ref.fwht_ref(x)
    err = (out - want).abs().max().item()
    require(err <= 1e-4, f"fwht n={n} d={d} disagrees with its plain "
            f"version: {err}")
    require(torch.equal(out, ops.fwht(x)), "fwht is not deterministic")
    plan = fwht_plan(d)
    library, lib_err = fwht_library(torch, timer, x)
    copy = torch.empty_like(x)
    copy_ms = timer(lambda: copy.copy_(x))
    e = entry("fwht", f"fwht[n={n},d={d},path {path}]", err,
              timer(lambda: ops.fwht(x)), timer(lambda: ref.fwht_ref(x)),
              library, nbytes=2 * 4 * n * d, ops=n * d * (math.log2(d) + 1))
    e["launches"] = launches
    print(f"  fwht[n={n},d={d}]: variant {plan.variant} ({plan.d1} x "
          f"{plan.d2}, {plan.device_launches} pass(es)), max error "
          f"{err:.3e}, bit-equal to the plain version "
          f"{torch.equal(out, want)}; wrapper {e['ms']:.4f} ms, copy of the "
          f"same bytes {copy_ms:.4f} ms, bound {e['bound_ms']:.4f} ms, "
          f"x @ H {'null' if library is None else f'{library:.4f}'} ms"
          + (f" (H not allocated: {lib_err})" if lib_err else ""))
    return e, lambda: ops.fwht(x), "fwht_", plan.device_launches


def fwht_library(torch, timer, x) -> tuple:
    """``x @ H`` by events, H the normalized Hadamard matrix of x's width
    built on the card in float32 (TF32 off) as the Kronecker product of
    two of order <= 512 -- not as the plain transform of a (d, d)
    identity, which copies the whole matrix at every stage -- and freed
    after.  Returns (ms, None), or (None, the error) where H cannot be
    allocated (d = 131,072: 64 GiB)."""
    from repro_torch.kernels import ref

    d = x.shape[-1]
    a = 1 << (d.bit_length() - 1) // 2
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    had = None
    try:
        had = torch.kron(ref.fwht_ref(torch.eye(a, device="cuda")),
                         ref.fwht_ref(torch.eye(d // a, device="cuda")))
        return timer(lambda: x @ had), None
    except torch.cuda.OutOfMemoryError as err:
        return None, f"{type(err).__name__}: {str(err).splitlines()[0]}"
    finally:
        del had
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = tf32


def step_inputs(torch, g, x_t, sign, b, main_path: bool = True):
    """Duals, u and the step's scalars for a packed call on (x_t, sign):
    per-class log weights near uniform, -1e30 on padding.  The scalars are
    the main path's for this n, d and b, or else the fixed ones of the JAX
    package's kernel tests (gamma = 1e-3, tau = 40, d_eff = d, theta =
    0.95), which go with their unscaled Gaussian rows."""
    from repro_torch.core import engine, saddle

    rows, d, n_pad = x_t.shape
    dev = x_t.device
    n1, n2 = int((sign > 0).sum()), int((sign < 0).sum())
    noise = 0.1 * torch.randn((rows, n_pad), generator=g, device=dev)
    ll = torch.where(sign > 0, -math.log(n1) + noise,
                     torch.where(sign < 0, -math.log(n2) + noise,
                                 torch.full_like(noise, -1e30)))
    # the previous weights 50 % apart from these, so that the momentum
    # term is of the order of delta and a kernel that drops it (the
    # planted theta = 0) shows on a single-row sum too
    lp = ll + 0.5 * torch.randn((rows, n_pad), generator=g,
                                device=dev) * (sign != 0)
    u = 0.1 * torch.randn((rows, n_pad), generator=g, device=dev)
    if main_path:
        sp = engine.stack_slot_params([engine.slot_params_row(
            saddle.make_params(n1 + n2, d, 1e-3, 0.1, block_size=b))]
            * rows, dev)
        theta, mwu_c, mwu_dot, d_eff = sp.theta, sp.mwu_c, sp.mwu_dot, d / b
    else:
        gamma, tau, d_eff = 1e-3, 40.0, float(d)
        theta = torch.full((rows,), 0.95, device=dev)
        mwu_c = torch.full((rows,), 1.0 / (gamma + d_eff / tau), device=dev)
        mwu_dot = torch.full((rows,), d_eff / tau, device=dev)
    # one draw for every row, as the server broadcasts it to the clients
    idx = torch.randperm(d, generator=g, device=dev)[:b].to(
        torch.int32)[None].expand(rows, b).contiguous()
    dw = (0.01 * torch.randn((1, b), generator=g, device=dev)).expand(
        rows, b).contiguous()
    if main_path and b > 128:
        # path d's b = 32,769-65,536 at d_pad = 65,536: the MWU multiplies
        # u by mwu_c ~ 1e4 and dv by mwu_c d_eff ~ 1.7e4, so u of 0.1 and
        # dw of 0.01 put log_new in the thousands, where one float32 step
        # (1.2e-4 - 4.9e-4) is above the 1e-4 tolerance and two orders of
        # summing 40,000 rows differ by 1e-3.  There u is 0.1 / mwu_c and
        # dw 0.01 * 128 / b: mwu_c u and the dv term of order 1.
        u = u / torch.clamp(mwu_c, min=1.0)[:, None]
        dw = dw * (128 / b)
    return dict(ll=ll, lp=lp, u=u, theta=theta, mwu_c=mwu_c,
                mwu_dot=mwu_dot, d_eff=d_eff, idx=idx, dw=dw)


def lse_error(torch, m, s, m_want, s_want) -> float:
    """The largest difference of the per-class lse = m + log(s) from the
    wanted one over the (row, class) pairs that hold a point (s_want > 0);
    a class without a point in a row (a point shard may hold one class
    only, a free lane none) must give the wanted (NEG, 0) exactly, else
    the error is infinite."""
    present = s_want > 0
    if not torch.equal(torch.where(present, 0.0, m), torch.where(
            present, 0.0, m_want)) or (s[~present] != 0).any():
        return math.inf
    if not present.any():
        return 0.0
    lse = (m + torch.log(s))[present]
    return (lse - (m_want + torch.log(s_want))[present]).abs().max().item()


def packed_errors(torch, name, got, want, real) -> dict:
    """{output: (error, tolerance)} of a packed kernel's result: delta
    within 1e-4 of its largest value (and 1e-4 at most); log_new on real
    points and each class's lse = m + log(s) within 1e-4 (``lse_error``),
    u within 1e-5 (tests/test_kernels.py)."""
    if name == "momentum_dot_packed":
        scale = want.abs().max().item()
        return {"delta": ((got - want).abs().max().item(),
                          min(1e-4, 1e-4 * scale))}
    return {"log_new": ((got[0][real] - want[0][real]).abs().max().item(),
                        1e-4),
            "lse": (lse_error(torch, got[2], got[3], want[2], want[3]),
                    1e-4),
            "u": ((got[1] - want[1]).abs().max().item(), 1e-5)}


def merged_partials(torch, log_new, sign, leave_out_last: bool = False):
    """(m, s) (S, 2) of packed log weights by the plain per-tile partials
    merged in tile order (``ref.merge_class_partials``): the oracle of the
    kernel's in-kernel merge.  With ``leave_out_last`` each slot's last
    tile that holds a real point is left out (given (NEG, 0))."""
    from repro_torch.kernels import ref

    parts = ref.class_partials(log_new, sign)
    if leave_out_last:
        real = (sign != 0).reshape(parts.shape[0], parts.shape[1], -1)
        tiles = torch.arange(parts.shape[1], device=parts.device)
        last = (real.any(-1) * tiles).argmax(-1)
        gone = torch.tensor([-1e30, 0.0, -1e30, 0.0], device=parts.device)
        parts = parts.clone()
        parts[torch.arange(parts.shape[0]), last] = gone
    return ref.merge_class_partials(parts)


def packed_faults(torch, name, b, args, got, sign) -> dict:
    """What a faulty packed kernel would return on these operands:
    momentum_dot_packed with theta taken as 0, or with the kernel's last
    row group (rows j = G - 1 mod G, G = 8 / tiles per block) left out of
    delta; mwu_update_packed with u left out, or with each slot's last
    tile that holds a real point left out of the merged (m, s); above
    CHUNK_ROWS sampled rows, either kernel with the rows past the first
    chunk left out; and with R > 1 row splits, the dot with its last
    split left unmerged (its rows of delta 0) and the MWU with the last
    split's rows left out of dv."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.saddle_update import (CHUNK_ROWS,
                                                   packed_row_splits,
                                                   packed_split_rows,
                                                   packed_tiles_per_block)

    splits = packed_row_splits(args[0].shape[2], b)
    last = (splits - 1) * packed_split_rows(b, splits)

    if name == "momentum_dot_packed":
        x_t, idx, ll, lp, sign, theta = args
        groups = 8 // packed_tiles_per_block(b)
        gone = got.clone()
        gone[:, groups - 1::groups] = 0.0
        faults = {"theta = 0": ref.momentum_dot_packed_ref(
                      x_t, idx, ll, lp, sign, torch.zeros_like(theta)),
                  "last row group left out": gone}
        if b > CHUNK_ROWS:
            later = got.clone()
            later[:, CHUNK_ROWS:] = 0.0
            faults["rows past the first chunk left out"] = later
        if splits > 1:
            unmerged = got.clone()
            unmerged[:, last:] = 0.0
            faults["last split left unmerged"] = unmerged
        return faults
    x_t, idx, ll, u, dw, *rest = args
    faults = {"u = 0": ref.mwu_update_packed_ref(
                  x_t, idx, ll, torch.zeros_like(u), dw, *rest),
              "last tile left out": (got[0], got[1]) + merged_partials(
                  torch, got[0], sign, leave_out_last=True)}
    if b > CHUNK_ROWS:
        faults["rows past the first chunk left out"] = \
            ref.mwu_update_packed_ref(
                x_t, idx[:, :CHUNK_ROWS].contiguous(), ll, u,
                dw[:, :CHUNK_ROWS].contiguous(), *rest)
    if splits > 1:
        faults["last split's rows left out of dv"] = \
            ref.mwu_update_packed_ref(
                x_t, idx[:, :last].contiguous(), ll, u,
                dw[:, :last].contiguous(), *rest)
    return faults


def host_split(torch, name, args, calls: int = 1000) -> dict:
    """A wrapper's host time per call (the unpacked MWU's with
    ``normalize=False``, as the reference step calls it), split: its
    validation (``check_packed`` / ``check_unpacked``), its
    allocations (the same ``torch.empty`` calls and workspace look-up),
    the ctypes call of the C launcher with the pointers ready, and the
    rest (geometry, pointers, stream, device check, launch count, views),
    the whole wrapper's time less the three.  Each is the mean over
    ``calls`` calls between two synchronisations, by time.perf_counter,
    in ms."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import saddle_update as su

    lib = build.library("saddle_update")
    if name == "momentum_dot":
        cols, ll, lp, theta = args
        lead, n, b = su.check_unpacked(cols, dict(log_lam=ll, log_prev=lp))
        dev = cols.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        k = lead[0] if lead else 1
        lanes, points, blocks, chunks = su.momentum_dot_geometry(k, n, b)
        floats = k * chunks * blocks * su.DOT_COLS

        def validate():
            su.check_unpacked(cols, dict(log_lam=ll, log_prev=lp))

        def allocate():
            torch.empty(lead + (b,), dtype=torch.float32, device=dev)
            su.workspace(dev, k * chunks, floats)

        out = torch.empty(lead + (b,), dtype=torch.float32, device=dev)
        counters, parts = su.workspace(dev, k * chunks, floats)
        ptrs = [t.data_ptr() for t in (cols, ll, lp)]
        ptrs2 = [t.data_ptr() for t in (out, parts, counters)]
        vec4 = int(b % 4 == 0 and cols.data_ptr() % 16 == 0)

        def call():
            lib.momentum_dot_f32(*ptrs, float(theta), *ptrs2, k, n, b, lanes,
                                 points, vec4, stream)

        def whole():
            ops.momentum_dot(*args)

        return _split(torch, calls, validate, allocate, call, whole)
    if name == "mwu_update":
        cols, ll, u, dw, *scalars = args
        vecs = dict(log_lam=ll, u=u)
        lead, n, b = su.check_unpacked(cols, vecs, dw)
        dev = cols.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        k = lead[0] if lead else 1
        lanes, points, blocks = su.mwu_update_geometry(k, n, b)

        def validate():
            su.check_unpacked(cols, vecs, dw)

        def allocate():
            torch.empty_like(ll)
            torch.empty_like(u)
            torch.empty((2, k), dtype=torch.float32, device=dev)
            su.workspace(dev, k, 2 * k * blocks)

        outs = [torch.empty_like(ll), torch.empty_like(u),
                torch.empty((2, k), dtype=torch.float32, device=dev)]
        counters, parts = su.workspace(dev, k, 2 * k * blocks)
        ptrs = [t.data_ptr() for t in (cols, ll, u, dw)]
        ptrs2 = [t.data_ptr() for t in (*outs, parts, counters)]
        scal = [float(v) for v in scalars]
        vec4 = int(b % 4 == 0 and cols.data_ptr() % 16 == 0)

        def call():
            lib.mwu_update_f32(*ptrs, *scal, 0, *ptrs2, k, n, b, lanes,
                               points, vec4, stream)

        def whole():
            ops.mwu_update(*args, normalize=False)

        return _split(torch, calls, validate, allocate, call, whole)

    x_t, idx = args[:2]
    s, d, n_pad = x_t.shape
    b = idx.shape[1]
    dev = x_t.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    ln = su.packed_launch(name, s, n_pad, b)
    if name == "momentum_dot_packed":
        _, _, ll, lp, sign, theta = args

        def validate():
            su.check_packed(x_t, idx, dict(log_lam=ll, log_prev=lp,
                                           sign=sign), dict(theta=theta))

        def allocate():
            torch.empty((s, b), dtype=torch.float32, device=dev)
            su.workspace(dev, ln.counters, ln.floats)

        out = torch.empty((s, b), dtype=torch.float32, device=dev)
        counters, parts = su.workspace(dev, ln.counters, ln.floats)
        ptrs = [t.data_ptr() for t in (x_t, idx, ll, lp, sign, theta, out,
                                       parts, counters)]

        def call():
            lib.momentum_dot_packed_f32(*ptrs, s, d, n_pad, b, *ln.args,
                                        stream)

        def whole():
            ops.momentum_dot_packed(*args)
    else:
        _, _, ll, u, dw, sign, mwu_c, mwu_dot, d_eff = args

        def validate():
            su.check_packed(x_t, idx, dict(log_lam=ll, u=u, sign=sign),
                            dict(mwu_c=mwu_c, mwu_dot=mwu_dot),
                            rows=dict(dw=dw))

        def allocate():
            torch.empty_like(ll)
            torch.empty_like(u)
            torch.empty((2, s, 2), dtype=torch.float32, device=dev)
            su.workspace(dev, ln.counters, ln.floats)

        outs = [torch.empty_like(ll), torch.empty_like(u),
                torch.empty((2, s, 2), dtype=torch.float32, device=dev)]
        counters, parts = su.workspace(dev, ln.counters, ln.floats)
        ptrs = [t.data_ptr() for t in (x_t, idx, dw, ll, u, sign, mwu_c,
                                       mwu_dot)]
        ptrs2 = [t.data_ptr() for t in (*outs, parts, counters)]

        def call():
            lib.mwu_update_packed_f32(*ptrs, float(d_eff), *ptrs2, s, d,
                                      n_pad, b, *ln.args, stream)

        def whole():
            ops.mwu_update_packed(*args)

    return _split(torch, calls, validate, allocate, call, whole)


def _split(torch, calls, validate, allocate, call, whole) -> dict:
    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e3

    split = {part: per_call(fn) for part, fn in (
        ("validation", validate), ("allocation", allocate),
        ("ctypes call", call), ("wrapper", whole))}
    split["rest"] = split["wrapper"] - sum(
        split[k] for k in ("validation", "allocation", "ctypes call"))
    return split


def check_packed(torch, timer, g, x_t, sign, b, launches,
                 main_path: bool = True, path: str = ""):
    """Both packed kernels on (x_t, sign) with b sampled rows, every row
    (slot or client) given the same block: each against its plain
    version (``packed_errors``), the MWU's (m, s) also against the plain
    merge of the per-tile partials of its own log_new, the same bits on a
    repeat call, every planted fault (``packed_faults``) breaking a
    tolerance, the wrapper's host time split (``host_split``); with R > 1
    row splits the MWU also against the plain split order
    (``ref.mwu_update_packed_ref(span=)``); returns their timing jobs."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import saddle_update as su

    rows, d, n_pad = x_t.shape
    a = step_inputs(torch, g, x_t, sign, b, main_path)
    ll, lp, u, idx, dw, theta, mwu_c, mwu_dot, d_eff = (a[k] for k in (
        "ll", "lp", "u", "idx", "dw", "theta", "mwu_c", "mwu_dot", "d_eff"))
    tag = f",{path} operands" if main_path else ",synthetic layout"
    real = sign != 0
    splits = su.packed_row_splits(n_pad, b)
    label = f"[S={rows},d={d},n_pad={n_pad},b={b},R={splits}{tag}]"
    dot_args = (x_t, idx, ll, lp, sign, theta)
    # The MWU's log_new spreads over hundreds at b = 128, so that one
    # point carries a class: each slot's last real point is raised to 1
    # above the largest log_new of its class (log_new is affine in its
    # log weight with slope mwu_c * mwu_dot), so a merge that leaves out
    # the last tile shows.
    log0 = ref.mwu_update_packed_ref(x_t, idx, ll, u, dw, sign, mwu_c,
                                     mwu_dot, d_eff)[0]
    last = last_real(torch, ll)
    same = sign == sign.gather(-1, last)
    top = torch.where(same, log0, -math.inf).amax(-1, keepdim=True)
    ll_m = ll.scatter_add(-1, last, (top + 1 - log0.gather(-1, last))
                          / (mwu_c * mwu_dot)[:, None])
    mwu_args = (x_t, idx, ll_m, u, dw, sign, mwu_c, mwu_dot, d_eff)
    lam = torch.exp(ll)
    mom = sign * (lam + theta[:, None] * (lam - torch.exp(lp)))
    idx_l = idx[0].long()
    # a practical floor beside the bound: one contiguous read of as many
    # bytes as the sampled rows (b rows of every slot), by torch.sum
    stream_ms = timer(lambda: x_t[:, :b].sum())
    jobs = []
    for name, args, plain, library, nbytes, ops_ in (
            ("momentum_dot_packed", dot_args, ref.momentum_dot_packed_ref,
             lambda: x_t[:, idx_l] @ mom[..., None],
             4 * rows * (n_pad * (b + 3) + 2 * b + 1),
             rows * n_pad * (2 * b + 6)),
            ("mwu_update_packed", mwu_args, ref.mwu_update_packed_ref, None,
             4 * rows * (n_pad * (b + 5) + 2 * b + 6),
             rows * n_pad * (2 * b + 12))):
        kernel = getattr(ops, name)

        def fn(kernel=kernel, args=args):
            return kernel(*args)

        got, want = fn(), plain(*args)
        errs = packed_errors(torch, name, got, want, real)
        if name == "mwu_update_packed":
            require((got[0][~real] < -1e20).all().item(),
                    f"{name}{label}: padding lanes not below -1e20")
            merged = merged_partials(torch, got[0], sign)
            errs["merge"] = (lse_error(torch, got[2], got[3], *merged),
                             1e-4)
            if splits > 1:
                split_order = plain(*args, span=su.packed_split_rows(
                    b, splits))
                errs.update((f"{k} split order", v) for k, v in
                            packed_errors(torch, name, got, split_order,
                                          real).items())
        require(all(e <= tol for e, tol in errs.values()),
                f"{name}{label}: {errs}")
        again = fn()
        same = (torch.equal(got, again) if name == "momentum_dot_packed"
                else all(torch.equal(p, q) for p, q in zip(got, again)))
        require(same, f"{name}{label}: not deterministic")
        caught = {}
        for fault, out in packed_faults(torch, name, b, args, got,
                                        sign).items():
            ferrs = packed_errors(torch, name, out, want, real)
            caught[fault] = max(e / tol for e, tol in ferrs.values())
            require(caught[fault] > 1, f"{name}{label}: the check would "
                    f"pass a kernel with {fault}: {ferrs}")
        # above b = 1,024 a call is milliseconds of device: 50 calls time
        # the host's share as well as 1,000 would
        split = host_split(torch, name, args, 1000 if b <= 1024 else 50)
        print(f"  {name}{label}: errors " + ", ".join(
            f"{k} {e:.3e} (tol {tol:.1e})" for k, (e, tol) in errs.items())
            + "; planted faults break the tolerance by " + ", ".join(
                f"{f} {r:.3g}x" for f, r in caught.items())
            + "; host ms per call " + ", ".join(
                f"{k} {v:.4f}" for k, v in split.items())
            + f"; a contiguous read of the rows' bytes {stream_ms:.4f} ms")
        e = entry(name, name + label, max(err for err, _ in errs.values()),
                  timer(fn), timer(lambda: plain(*args)),
                  None if library is None else timer(library),
                  nbytes=nbytes, ops=ops_)
        e["launches"] = launches
        jobs.append((e, fn, name + "_kernel", 1))
    return jobs


def split_slots_alone(torch, g, x_t, sign, b, slots: int = 3) -> None:
    """Both packed kernels at b rows cut into R > 1 row splits, on S =
    ``slots`` slots of the one slot (x_t, sign), each slot with its own
    rows, dw, duals and u: every slot's outputs bit-equal to a call on
    that slot alone (R does not depend on S, so a lane's bits do not
    depend on its batch-mates)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import saddle_update as su

    _, d, n_pad = x_t.shape
    splits = su.packed_row_splits(n_pad, b)
    require(splits > 1, f"split_slots_alone: b = {b} over n_pad = {n_pad} "
            "takes no row split")
    xs = x_t.expand(slots, -1, -1).contiguous()
    signs = sign.expand(slots, -1).contiguous()
    a = step_inputs(torch, g, xs, signs, b)
    idx = torch.stack([torch.randperm(d, generator=g, device="cuda")[:b]
                       for _ in range(slots)]).to(torch.int32)
    dw = a["dw"] * (1 + torch.rand((slots, b), generator=g, device="cuda"))
    calls = {
        "momentum_dot_packed": lambda i: ops.momentum_dot_packed(
            *(v[i] for v in (xs, idx, a["ll"], a["lp"], signs,
                             a["theta"]))),
        "mwu_update_packed": lambda i: ops.mwu_update_packed(
            *(v[i] for v in (xs, idx, a["ll"], a["u"], dw, signs,
                             a["mwu_c"], a["mwu_dot"])), a["d_eff"])}
    every = slice(None)
    for name, call in calls.items():
        batch = call(every)
        batch = (batch,) if isinstance(batch, torch.Tensor) else batch
        for k in range(slots):
            one = slice(k, k + 1)
            alone = call(one)
            alone = (alone,) if isinstance(alone, torch.Tensor) else alone
            require(all(torch.equal(p[one], q) for p, q in zip(batch, alone)),
                    f"{name}[S={slots},b={b},R={splits}]: slot {k} differs "
                    "from a call on it alone")
    print(f"  S = {slots} slots at b = {b}, n_pad = {n_pad} (R = {splits}): "
          "every slot's outputs of both packed kernels bit-equal to a call "
          "on it alone")


def ticket_rounds(torch, g, recs, rounds: int = 3):
    """The kernels that share the ticket counters, alternating for
    ``rounds`` rounds: the packed kernels at the path shapes S = 1, b = 1;
    S = 1, b = 128 and S = 20, b = 1, and between them the unpacked
    momentum dot and MWU (both values of ``normalize``) at every shape
    path c gave them and at K = 20, n = 2,048, B = 128, where every
    client takes several blocks and a ticket.  The same bits in every
    round and every ticket counter back at 0 after each round, so a
    launch leaves the counters as it found them."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import saddle_update as su

    operands = {shape: xs for rec in recs for shape, xs in
                rec.operands.items()}
    shapes = [min(k for k in operands if k[0] == 1 and k[3] == b)
              for b in (1, 128)]
    shapes.append(min(k for k in operands if k[0] == 20 and k[3] == 1))
    calls = []
    for shape in shapes:
        x_t, sign = operands[shape]
        a = step_inputs(torch, g, x_t, sign, shape[3])
        calls.append(lambda x_t=x_t, sign=sign, a=a: (
            ops.momentum_dot_packed(x_t, a["idx"], a["ll"], a["lp"], sign,
                                    a["theta"]),
            *ops.mwu_update_packed(x_t, a["idx"], a["ll"], a["u"], a["dw"],
                                   sign, a["mwu_c"], a["mwu_dot"],
                                   a["d_eff"])))
    unpacked = [args for rec in recs for (name, _), args in
                rec.unpacked.items() if name == "mwu_update"]
    cols = torch.randn((20, 2048, 128), generator=g, device="cuda")
    unpacked.append((cols, torch.full((20, 2048), -math.log(2048),
                                      device="cuda"),
                     0.1 * torch.randn((20, 2048), generator=g,
                                       device="cuda"),
                     0.01 * torch.randn((20, 128), generator=g,
                                        device="cuda"),
                     1.0, 1e-3, 40.0, 128.0))
    for i, args in enumerate(unpacked):
        calls.insert(min(2 * i + 1, len(calls)), lambda args=args: (
            ops.momentum_dot(args[0], args[1], args[1], 0.5),
            *ops.mwu_update(*args, normalize=False),
            *ops.mwu_update(*args, normalize=True)))
    first = None
    dev = operands[shapes[0]][0].device
    for r in range(rounds):
        outs = [call() for call in calls]
        counters = su.workspace(dev, 1, 1)[0]
        require(not counters.any().item(), f"round {r}: a ticket counter "
                "was not reset")
        if first is None:
            first = outs
        require(all(torch.equal(p, q) for o, f in zip(outs, first)
                    for p, q in zip(o, f)),
                f"round {r}: the ticket kernels gave other bits")
    blocks = [su.mwu_update_geometry(a[0].shape[0] if a[0].ndim == 3 else 1,
                                     *a[0].shape[-2:])[2] for a in unpacked]
    print(f"  ticket counters: {rounds} rounds alternating the packed "
          f"kernels at {shapes} with the unpacked ones at "
          f"{[tuple(a[0].shape) for a in unpacked]} (MWU blocks a client "
          f"{blocks}): same bits every round, every counter 0 after each")


def synthetic_layout(torch, g):
    """x_t (1, 512, 50,048) of Gaussian rows and its sign: a single-class
    first tile, a mixed tile at the class boundary and an all-padding last
    tile."""
    n_pad, d, n1, n2 = 50_048, 512, 24_000, 25_900
    x_t = torch.randn((1, d, n_pad), generator=g, device="cuda")
    x_t[:, :, n1 + n2:] = 0.0
    sign = torch.zeros((1, n_pad), device="cuda")
    sign[:, :n1], sign[:, n1:n1 + n2] = 1.0, -1.0
    return x_t, sign


def check_bad_index(torch, g, x_t, sign):
    """A row index outside [0, d) is skipped by the kernels: its dot and
    the whole dual update come out NaN, with no CUDA error."""
    from repro_torch.kernels import ops

    d = x_t.shape[1]
    a = step_inputs(torch, g, x_t, sign, 2)
    idx = torch.tensor([[0, d]], dtype=torch.int32, device="cuda")
    delta = ops.momentum_dot_packed(x_t, idx, a["ll"], a["lp"], sign,
                                    a["theta"])
    log_new, u_new, *_ = ops.mwu_update_packed(
        x_t, idx, a["ll"], a["u"], a["dw"], sign, a["mwu_c"], a["mwu_dot"],
        a["d_eff"])
    torch.cuda.synchronize()
    require(math.isfinite(delta[0, 0].item())
            and math.isnan(delta[0, 1].item()),
            "momentum_dot_packed: want NaN for the out-of-range row only")
    require(torch.isnan(log_new).all().item()
            and torch.isnan(u_new).all().item(),
            "mwu_update_packed: want NaN outputs for an out-of-range row")
    print("  out-of-range row index: NaN outputs, no CUDA error")


def unpacked_state(torch, g, name, args):
    """Fresh state on a recorded unpacked call: its cols, dw and step
    scalars kept, its duals and u drawn anew.  The call the path made
    first saw the starting state (log_prev = log_lam, u = 0, uniform
    weights), on which a kernel that drops the momentum term or u would
    pass; here every point's log weight is near -log(n) with a spread of
    0.5, log_prev differs from it by as much, u is 0.1 N(0, 1), and each
    client's last real point carries the largest weight (of lam for
    momentum_dot, of the updated weights for mwu_update), so that a kernel
    that leaves out the tail of its last tile shows.  Padding (log weight
    -1e30, the round-robin padding of a client shard) stays padding, with
    u = 0."""
    from repro_torch.kernels import ref

    cols, ll_rec = args[0], args[1]
    pad = ll_rec < -1e29

    def noise(scale):
        return scale * torch.randn(ll_rec.shape, generator=g,
                                   device=ll_rec.device)

    def lift(ll, new):
        # raise the last real point's log weight until its ``new`` (affine
        # in it with slope ``slope``) is e times the largest
        last = last_real(torch, ll)
        top = new.amax(-1, keepdim=True) + 1 - new.gather(-1, last)
        return ll.scatter_add(-1, last, top / slope)

    n_real = (~pad).sum(-1, keepdim=True).float()
    ll = torch.where(pad, -1e30, -torch.log(n_real) + noise(0.5))
    if name == "momentum_dot":
        slope = 1.0
        ll = lift(ll, ll)
        lp = torch.where(pad, -1e30, ll + noise(0.5))
        return (cols, ll, lp, args[3])
    u = torch.where(pad, 0.0, noise(0.1))
    _sign, gamma, tau, d_eff = args[4:]
    slope = (d_eff / tau) / (gamma + d_eff / tau)
    new = ref.mwu_update_ref(cols, ll, u, *args[3:], normalize=False)[0]
    return (cols, lift(ll, new), u, *args[3:])


def last_real(torch, ll):
    """Index (..., 1) of each client's last point that is not padding."""
    real = (ll > -1e29).to(torch.int64)
    return (real * torch.arange(ll.shape[-1], device=ll.device)).argmax(
        -1, keepdim=True)


def unpacked_errors(torch, name, got, want, real) -> dict:
    """{output: (error, tolerance)} of an unpacked kernel's result:
    delta within 1e-4 of its largest value (and 1e-4 at most); log_new on
    real points and lse = m + log(s) within 1e-4, u within 1e-5
    (tests/test_kernels.py)."""
    if name == "momentum_dot":
        scale = want.abs().max().item()
        return {"delta": ((got - want).abs().max().item(),
                          min(1e-4, 1e-4 * scale))}
    lse = [r[2] + torch.log(r[3]) for r in (got, want)]
    return {"log_new": ((got[0][real] - want[0][real]).abs().max().item(),
                        1e-4),
            "lse": ((lse[0] - lse[1]).abs().max().item(), 1e-4),
            "u": ((got[1] - want[1]).abs().max().item(), 1e-5)}


def merged_blocks(torch, cols, log_new, leave_out_last: bool = False):
    """(m, s) of the unnormalized log weights (..., n) of an unpacked MWU
    call on ``cols`` by the plain per-block partials of the kernel's
    geometry merged in block order (``ref.merge_block_partials``): the
    oracle of the kernel's in-launch merge.  With ``leave_out_last`` each
    client's last block is left out (given (-1e30, 0)); a client of one
    block then has nothing left."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.saddle_update import mwu_update_geometry

    n, b = cols.shape[-2:]
    k = cols.shape[0] if cols.ndim == 3 else 1
    _, points, _ = mwu_update_geometry(k, n, b)
    pmax, psum = ref.block_partials(log_new, points)
    if leave_out_last:
        pmax, psum = pmax.clone(), psum.clone()
        pmax[..., -1], psum[..., -1] = -1e30, 0.0
    return ref.merge_block_partials(pmax, psum)


def planted_faults(torch, name, args, want) -> dict:
    """What a faulty kernel would return on these operands, from the
    plain version: momentum_dot with theta taken as 0, or with each
    client's last real point left out; mwu_update with u left out, with
    each client's last real point left out of its block's (max,
    sum-exp), or with the merge of its blocks' partials leaving out the
    last block's."""
    from repro_torch.kernels import ref

    last = last_real(torch, args[1])

    def drop(t):
        return t.scatter(-1, last, -1e30)

    if name == "momentum_dot":
        cols, ll, lp, theta = args
        return {"theta = 0": ref.momentum_dot_ref(cols, ll, lp, 0.0),
                "last point left out": ref.momentum_dot_ref(
                    cols, drop(ll), drop(lp), theta)}
    cols, ll, u, *rest = args
    lo = drop(want[0])
    m = lo.amax(-1)
    return {"u = 0": ref.mwu_update_ref(cols, ll, torch.zeros_like(u),
                                        *rest, normalize=False),
            "last point left out": (want[0], want[1], m,
                                    torch.exp(lo - m[..., None]).sum(-1)),
            "last block left out of the merge": (want[0], want[1]) +
            merged_blocks(torch, cols, want[0], leave_out_last=True)}


def check_unpacked(torch, timer, g, name, args, launches, label,
                   on_path: bool, faults: bool | None = None):
    """One unpacked kernel on cols (K, n, B) or (n, B) against its plain
    version (``unpacked_errors``), the same bits on a repeat call, its
    host time split (``host_split``) and its times; the MWU also
    normalized (log_new within 1e-4, u 1e-5), and its (m, s) against the
    plain merge of its own log_new cut by the kernel's blocks
    (``merged_blocks``).  Points at log weight -1e30 (round-robin padding
    of a client shard) are held below -1e20 and left out of the log_new
    error.  On a path's shape (``on_path``) the recorded call's cols, dw
    and step scalars get fresh state (``unpacked_state``); there, and
    wherever ``faults`` asks, each planted fault (``planted_faults``, and
    for the MWU a log_new left unnormalized) must break a tolerance."""
    from repro_torch.kernels import ops, ref

    faults = on_path if faults is None else faults
    if faults:
        args = unpacked_state(torch, g, name, args)
    cols, ll = args[:2]
    k = cols.shape[0] if cols.ndim == 3 else 1
    n, b = cols.shape[-2:]
    label = f"{name}[{'K=%d,' % k if cols.ndim == 3 else ''}n={n},b={b}" \
            f"{label}]"
    if name == "momentum_dot":
        def fn():
            return ops.momentum_dot(*args)

        def plain():
            return ref.momentum_dot_ref(*args)

        lam = torch.exp(ll)
        mom = lam + args[3] * (lam - torch.exp(args[2]))
        library = timer(lambda: cols.transpose(-1, -2) @ mom[..., None])
        nbytes, ops_ = 4 * k * (n * (b + 2) + b), k * n * (2 * b + 6)
        kernel = "momentum_dot_kernel"
    else:
        def fn():
            return ops.mwu_update(*args, normalize=False)

        def plain():
            return ref.mwu_update_ref(*args, normalize=False)

        library = None
        nbytes, ops_ = 4 * k * (n * (b + 4) + b + 2), k * n * (2 * b + 12)
        kernel = "mwu_update_kernel"
    got, want = fn(), plain()
    real = ll > -1e29
    errs = unpacked_errors(torch, name, got, want, real)
    if name == "mwu_update":
        require((got[0][~real] < -1e20).all().item(),
                f"{label}: padding not below -1e20")
        merged = merged_blocks(torch, cols, got[0])
        errs["merge"] = ((got[2] + torch.log(got[3]) - merged[0]
                          - torch.log(merged[1])).abs().max().item(), 1e-4)
        norm = ops.mwu_update(*args, normalize=True)
        norm_want = ref.mwu_update_ref(*args, normalize=True)
        require((norm[0][~real] < -1e20).all().item(),
                f"{label}: normalized padding not below -1e20")
        require(all(torch.equal(p, q) for p, q in zip(
            norm, ops.mwu_update(*args, normalize=True))),
            f"{label}: normalized, not deterministic")

        def norm_errors(out):
            return {"normalized log_new": (
                        (out[0][real] - norm_want[0][real]).abs().max()
                        .item(), 1e-4),
                    "normalized u": ((out[1] - norm_want[1]).abs().max()
                                     .item(), 1e-5)}
        errs.update(norm_errors(norm))
    require(all(e <= tol for e, tol in errs.values()), f"{label}: {errs}")
    same = (torch.equal(got, fn()) if name == "momentum_dot" else
            all(torch.equal(p, q) for p, q in zip(got, fn())))
    require(same, f"{label}: not deterministic")
    if faults:
        caught = {}
        for fault, out in planted_faults(torch, name, args, want).items():
            ferrs = unpacked_errors(torch, name, out, want, real)
            caught[fault] = max(e / tol for e, tol in ferrs.values())
            require(caught[fault] > 1, f"{label}: the check would pass a "
                    f"kernel with {fault}: {ferrs}")
        if name == "mwu_update":
            ferrs = norm_errors((want[0], want[1]))
            caught["log_new left unnormalized"] = max(
                e / tol for e, tol in ferrs.values())
            require(caught["log_new left unnormalized"] > 1,
                    f"{label}: the check would pass a kernel that leaves "
                    f"log_new unnormalized: {ferrs}")
        print(f"  {label}: planted faults break the tolerance by "
              + ", ".join(f"{f} {r:.3g}x" for f, r in caught.items()))
    split = host_split(torch, name, args)
    print(f"  {label}: errors " + ", ".join(
        f"{k_} {e:.3e} (tol {tol:.1e})" for k_, (e, tol) in errs.items())
        + "; host ms per call " + ", ".join(
            f"{k_} {v:.4f}" for k_, v in split.items()))
    e = entry(name, label, max(err for err, _ in errs.values()), timer(fn),
              timer(plain), library, nbytes=nbytes, ops=ops_)
    e["launches"] = launches
    if name == "mwu_update":
        print(f"  {label}: normalized, wrapper "
              f"{timer(lambda: ops.mwu_update(*args, normalize=True)):.4f} "
              f"ms by events")
    return e, fn, kernel, 1


def jax_test_shapes(torch, timer, g):
    """The unpacked kernels at the JAX kernel tests' shapes and scalars
    (tests/test_kernels.py) and at ragged B = 3 and 130, with one client
    and with 20."""
    jobs = []
    for lead in ((), (20,)):
        for n, b in ((17, 1), (513, 128), (1025, 8), (2048, 128), (100, 3),
                     (300, 130)):
            def randn(*shape):
                return torch.randn(lead + shape, generator=g, device="cuda")
            cols = randn(n, b)
            ll, lp = randn(n) - 3, randn(n) - 3
            jobs.append(check_unpacked(torch, timer, g, "momentum_dot",
                                       (cols, ll, lp, 0.95), None,
                                       ",JAX test", False))
            u, dw = 0.1 * randn(n), 0.01 * randn(b)
            lu = torch.full(lead + (n,), -math.log(n), device="cuda")
            for sign in (1.0, -1.0):
                jobs.append(check_unpacked(
                    torch, timer, g, "mwu_update",
                    (cols, lu, u, dw, sign, 1e-3, 40.0, 128.0), None,
                    f",JAX test,sign={sign:+.0f}", False))
            if lead and (n, b) == (2048, 128):
                # several blocks a client (the ticket path), with the
                # planted faults on fresh state
                jobs.append(check_unpacked(
                    torch, timer, g, "mwu_update",
                    (cols, lu, u, dw, 1.0, 1e-3, 40.0, 128.0), None,
                    ",JAX test,fresh state", False, faults=True))
    return jobs


def fwht_shapes(rec) -> set:
    """The FWHT shapes of a path held against the plain version: all of
    them, but for paths e-h (two class matrices a problem) the longest
    class matrix and the recovery's vector of each d."""
    shapes = {shape for (name, shape) in rec.calls if name == "fwht"}
    if rec.name[0] not in "efgh":
        return shapes
    return {max(sh for sh in shapes if sh[1] == d) for _, d in shapes} | {
        sh for sh in shapes if sh[0] == 1}


def check_kernels(torch, timer, recs) -> list[dict]:
    """Every kernel at every shape of every path (the JSON entries), then
    at the JAX tests' shapes and the synthetic layout (printed only); the
    device-only times of each group from one profiler session."""
    g = torch.Generator(device="cuda").manual_seed(0)
    entries = []
    for rec in recs:
        print(f"  path {rec.name}:")
        jobs = []
        for (name, shape), calls in sorted(rec.calls.items()):
            if name == "fwht" and shape in fwht_shapes(rec):
                jobs.append(check_fwht(torch, timer, g, *shape, calls,
                                       rec.name))
        for shape, (x_t, sign) in sorted(rec.operands.items()):
            jobs += check_packed(torch, timer, g, x_t, sign, shape[3],
                                 rec.calls["momentum_dot_packed", shape],
                                 path=f"path {rec.name}")
        for (name, shape), args in sorted(rec.unpacked.items(),
                                          key=lambda kv: str(kv[0])):
            jobs.append(check_unpacked(
                torch, timer, g, name, args, rec.calls[name, shape],
                f",path {rec.name}", on_path=True))
        jobs += check_service_calls(torch, timer, rec)
        entries += report(timer, jobs)
    ticket_rounds(torch, g, recs)
    print("  not on a path (launches null):")
    jobs = [check_fwht(torch, timer, g, max(1, 12_800_000 // d), d, None,
                       "none")
            for d in (1024, 4096, 32_768, 65_536, 131_072)]
    jobs.append(check_fwht(torch, timer, g, 50_000, 512, None, "none"))
    # more sampled rows than a block holds at once (b > 32,768: two chunks
    # of indices or dw) and every row of d, on path d's operands
    x_t, sign = next(xs for shape, xs in recs[3].operands.items()
                     if shape[3] == 1)
    for b in (32_768, 32_769, 65_536):
        jobs += check_packed(torch, timer, g, x_t, sign, b, None,
                             path="path d")
    report(timer, jobs)
    split_slots_alone(torch, g, x_t, sign, 40_000)
    jobs = []
    x_t, sign = synthetic_layout(torch, g)
    # b = 3 and 300: a ragged last block of 4 tiles, and a row ring that
    # is refilled (10 stages of 32 rows through 4 buffers)
    for b in (1, 3, 128, 300):
        jobs += check_packed(torch, timer, g, x_t, sign, b, None,
                             main_path=False)
    check_bad_index(torch, g, x_t, sign)
    report(timer, jobs + jax_test_shapes(torch, timer, g))
    return entries


# ---------------------------------------------------------------- phase 4
def profile_window(torch, label, steps, fn):
    """Device busy share and kernel time by name over one call of ``fn``
    (``steps`` solver steps), warm; returns the idle share, device
    launches, device ms and wall ms a step (None if the profiler saw no
    device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()                                               # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []                           # device-side rows: kernels, copies
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    if busy == 0:
        print(f"profile {label}: the profiler saw no device time (not "
              "measured)")
        return
    launches = sum(r[2] for r in rows)
    print(f"profile ({steps} steps, {label}): wall {wall:.4f} s, "
          f"device busy {busy:.4f} s, idle share {1 - busy / wall:.4f}, "
          f"{wall / steps * 1e3:.4f} ms/step, {launches / steps:.1f} device "
          f"launches/step, {busy / steps * 1e3:.4f} device ms/step")
    for dev_us, key, count in rows[:12]:
        print(f"  {dev_us / 1e3:10.3f} ms  {count:7d}x  {key[:90]}")
    return dict(idle=1 - busy / wall, launches=launches / steps,
                device_ms=busy / steps * 1e3, ms=wall / steps * 1e3)


PROFILED_STEPS = 100   # 300 until PR 24: reading a window's trace back
#                        (key_averages) took most of the phase's ~118 s


def profiles(torch, dist_fits, serve):
    """PROFILED_STEPS steps of the serial nu-SVM solve at the Figure 2
    shape, and of each distributed fit on its own data and coordinates; 4
    chunks of path e's service over its 8 requests of bucket (8,192,
    256): intake, the chunks and the recovery."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import preprocess as pp
    from repro_torch.core import saddle
    from repro_torch.core.svm import split_classes
    from repro_torch.data import synthetic

    ds = synthetic.non_separable(50_000, 512, beta2=0.2, seed=50_000)
    xp, xm = split_classes(ds.x, ds.y)
    pre = pp.preprocess(xp, xm, generator=torch.Generator().manual_seed(0),
                        device="cuda")
    nu = 1.0 / (0.85 * min(len(xp), len(xm)))
    n = PROFILED_STEPS
    kw = dict(eps=1e-3, beta=0.1, nu=nu, num_iters=n, device="cuda")
    profile_window(torch, "serial nu-SVM n=50000 d=512", n,
                   lambda: saddle.solve(pre.xp, pre.xm, **kw))
    for fit in dist_fits:
        label, _data, fkw, _alpha = fit["spec"]
        fkw = dict(fkw, num_iters=n, record_every=n)
        profile_window(torch, label, n, lambda: dist.solve_distributed(
            fit["pre"].xp, fit["pre"].xm, nu=fit["nu"], device="cuda",
            idx_schedule=fit["sched"][:n], **fkw))

    from repro_torch.serve.solver_service import FitRequest, SolverService
    mates = [(ds, kw) for label, ds, kw in serve["reqs"]
             if label.startswith("hard-margin #") and len(ds.y) > 4096]

    def service():
        svc = SolverService(num_slots=SERVE_SLOTS, chunk_steps=SERVE_CHUNK)
        for ds, kw in mates:
            svc.submit(FitRequest(x=ds.x, y=ds.y, seed=kw["seed"],
                                  num_iters=4 * SERVE_CHUNK))
        require(len(svc.run()) == SERVE_SLOTS, "service window")

    profile_window(torch, f"path e service, {len(mates)} lanes of bucket "
                   f"(8192, 256), 4 chunks", 4 * SERVE_CHUNK, service)


# ---------------------------------------------------------------- phase 5
def compare_fits(label, card, cpu, history: bool,
                 offset: bool = True) -> None:
    """w (and with ``offset`` b) within FIT_ATOL, and with ``history`` the
    objective at every mark within HIST_RTOL relative."""
    import numpy as np

    dw = float(np.abs(card.w_ - cpu.w_).max())
    db = abs(card.b_ - cpu.b_)
    print(f"{label}: max|dw| {dw:.3e}, |db| {db:.3e}, |dobj| "
          f"{abs(card.objective_ - cpu.objective_):.3e} (tol {FIT_ATOL} on "
          f"{'w and b' if offset else 'w'})")
    require(max(dw, db if offset else 0.0) <= FIT_ATOL,
            f"{label}: card and CPU disagree")
    if not history:
        return
    marks = [m for m, _ in card.history_]
    oc = [o for _, o in card.history_]
    oh = [o for _, o in cpu.history_]
    rel = max(abs(a - b) / abs(b) for a, b in zip(oc, oh))
    print(f"  card history {list(zip(marks, oc))}")
    print(f"  CPU history  {cpu.history_}")
    print(f"  max relative objective difference {rel:.3e}; rises at "
          f"boundaries: card {rises(oc)}, CPU {rises(oh)}")
    require(marks == [m for m, _ in cpu.history_], f"{label}: marks differ")
    require(rel <= HIST_RTOL, f"{label}: histories disagree")


def card_vs_cpu(torch, fits):
    import numpy as np

    from repro_torch.core.svm import SaddleSVC
    from repro_torch.data import synthetic

    ds = synthetic.separable(4000, 128, seed=4000)
    rng = np.random.default_rng(4000)
    signs = rng.choice([-1.0, 1.0], size=128).astype(np.float32)
    sched = rng.integers(0, 128, size=(2000, 1)).astype(np.int32)
    card, cpu = (SaddleSVC(eps=1e-3, beta=0.1, num_iters=2000,
                           device=dev).fit(ds.x, ds.y, signs=signs,
                                           idx_schedule=sched)
                 for dev in ("cuda", "cpu"))
    compare_fits("card vs CPU (n=4000 d=128, 2000 steps)", card, cpu,
                 history=False)
    require(abs(card.objective_ - cpu.objective_) <= FIT_ATOL,
            "card and CPU objectives disagree")

    secs = {}
    for spec, card, ds, sched in fits:
        label, cls, kw, data = spec
        steps, offset = REPLAY_PREFIX.get(label, (None, True))
        if steps is not None:
            # its first steps again on the card, against the same steps
            # on the CPU
            kw = dict(kw, num_iters=steps * kw.get("block_size", 1),
                      record_every=steps // 4)
            label = f"{label}, its first {steps} steps"
            card, _ = make_fit((label, cls, kw, data), "cuda", ds)
            t0 = time.perf_counter()
            card.fit(ds.x, ds.y, idx_schedule=sched[:steps])
            secs[label + " (card)"] = time.perf_counter() - t0
            print(f"{label} rerun on the card: "
                  f"{secs[label + ' (card)']:.1f} s")
            sched = sched[:steps]
        clf, _ = make_fit((label, cls, kw, data), "cpu", ds)
        t0 = time.perf_counter()
        clf.fit(ds.x, ds.y, idx_schedule=sched)
        secs[label] = time.perf_counter() - t0
        print(f"{label} replayed on the CPU with the card's "
              f"coordinates: {secs[label]:.1f} s")
        compare_fits(f"  card vs CPU, {label}", card, clf, history=True,
                     offset=offset)
    return secs


def dist_card_vs_cpu(torch, fit):
    """The first 1,000 steps of a distributed fit on the card and on the
    CPU's plain path, with the coordinates the card drew and the card's
    preprocessed data: w within 1e-4, histories within 1e-3 relative."""
    from repro_torch.core import distributed as dist

    label, _data, kw, _alpha = fit["spec"]
    steps = 1000
    kw = dict(kw, num_iters=steps, record_every=200)
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[dev] = dist.solve_distributed(
            fit["pre"].xp.to(dev), fit["pre"].xm.to(dev), nu=fit["nu"],
            idx_schedule=fit["sched"][:steps], device=dev, **kw)
        print(f"{label}, {steps} steps on {dev}: "
              f"{time.perf_counter() - t0:.2f} s")
    card, cpu = runs["cuda"], runs["cpu"]
    dw = (card.state.w.cpu() - cpu.state.w).abs().max().item()
    marks = [m for m, *_ in card.history]
    oc = [o for *_, o in card.history]
    oh = [o for *_, o in cpu.history]
    rel = max(abs(a - b) / abs(b) for a, b in zip(oc, oh))
    print(f"  card history {list(zip(marks, oc))}")
    print(f"  CPU history  {list(zip(marks, oh))}")
    print(f"  max|dw| {dw:.3e} (tol {FIT_ATOL}), max relative objective "
          f"difference {rel:.3e} (tol {HIST_RTOL})")
    require(marks == [m for m, *_ in cpu.history], f"{label}: marks differ")
    require(dw <= FIT_ATOL, f"{label}: card and CPU w disagree")
    require(rel <= HIST_RTOL, f"{label}: histories disagree")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    global HBM_BW, F32_FLOPS, PEAK_FLOPS
    from repro_torch.kernels import build
    from repro_torch.utils.roofline import F32_FLOPS, HBM_BW, PEAK_FLOPS

    card = card_line()
    t_script = t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(build.SOURCES)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"card: {card}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}")

    laps = [("build", time.perf_counter() - t0)]
    t0 = time.perf_counter()

    def lap(label: str) -> None:
        nonlocal t0
        laps.append((label, time.perf_counter() - t0))
        t0 = time.perf_counter()

    recs = [PathRecorder(name) for name in ("a", "b", "c", "d")]
    recs += [PathRecorder("e", keep=False), PathRecorder("f"),
             PathRecorder("g", keep=False)]
    fits = main_path(torch, recs[0])
    lap("a")
    dist_fits = dist_path(torch, recs[1])
    lap("b")
    reference_path(torch, recs[2], dist_fits[0])
    lap("c")
    fits += wide_path(torch, recs[3])
    lap("d")
    serve = service_path(torch, recs[4])
    serve_vs_solo(torch, serve)
    lap("e")
    f_recs, p1 = collectives_path(torch, dist_fits, serve, recs[5], recs[6])
    recs += f_recs
    lap("f, g, p and q")
    recs.append(PathRecorder("h"))
    baselines_path(torch, recs[-1], dist_fits)
    lap("h")
    recs.append(PathRecorder("i"))
    lm_path(torch, recs[-1])
    lap("i")
    deepseek_path(torch)
    lap("j")
    k_secs = recurrent_path(torch)
    lap("k")
    l_secs = multimodal_path(torch)
    lap("l")
    recs.append(PathRecorder("m"))
    m_secs = training_path(torch, recs[-1], p1)
    lap("m")
    recs.append(PathRecorder("n"))
    n_secs = analysis_path(torch, recs[-1])
    lap("n")
    recs.append(PathRecorder("o", keep=False))
    o_secs = launch_path(torch, recs[-1])
    lap("o")
    serial_vs_dist(torch, dist_fits)
    lap("phase 3")
    profiles(torch, dist_fits, serve)
    lap("phase 4")
    entries = check_kernels(torch, Timer(torch), recs)
    lap("phase 5")
    replay_secs = card_vs_cpu(torch, fits)
    dist_card_vs_cpu(torch, dist_fits[1])
    serve_replay_cpu(torch, serve)
    lap("phase 6")
    print("chip_smoke seconds by path and phase: " + ", ".join(
        f"{label} {secs:.1f}" for label, secs in laps))

    steps = REPLAY_PREFIX[FITS[0][0]][0]
    nu = f"{FITS[0][0]}, its first {steps} steps"
    cpu, card_s = replay_secs[nu], replay_secs[nu + " (card)"]
    whole = cpu * FITS[0][2]["num_iters"] / steps
    print(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all "
          f"(build included); path k {k_secs:.1f} s; path l {l_secs:.1f} "
          f"s; path m {m_secs:.1f} s; path n {n_secs:.1f} s; path o "
          f"{o_secs:.1f} s; the CPU replay "
          f"of "
          f"{nu} {cpu:.1f} s and its rerun on the card {card_s:.1f} s, "
          f"against ~{whole:.1f} s for all {FITS[0][2]['num_iters']} "
          f"steps (linear in steps): the cut saves "
          f"~{whole - cpu - card_s:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
