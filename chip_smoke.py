#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper GPU, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA:

    python3 chip_smoke.py [--out results.json]

It needs no network and no arguments, and exits non-zero — printing no
result line — when there is no GPU, when the package is missing, or when
any phase fails. Phases:

1. device   — require CUDA; print the card's name and power limit as
              ``nvidia-smi --query-gpu=name,power.limit`` gives them.
2. build    — compile every kernel under ``src/repro_torch/kernels/csrc``
              with ``nvcc`` (one process per source, in parallel); print
              each ``logmatmul`` instantiation's registers and spills (the
              large tile's must spill nothing) and, where ``cuobjdump``
              exists, the large tile's product loops in SASS as opcode
              counts a product: the width-8 FLOAT form and the GENERAL
              form.
3. kernels  — call each kernel's wrapper on GPU tensors and hold the result
              against its plain PyTorch version on the same inputs:
              ``elemwise`` bit-equal (exhaustive width-8 square, > 1 M
              width-16 pairs, zeros, ragged and 1-D shapes);
              ``flash_attention`` within the stated tolerances (f32 / bf16,
              d_head 64 / 128, causal / window / non-causal, ragged Sq != Skv
              with q_offset and kv_len, an empty kv loop, exact and SIMDive
              divide — at the main path's shape also the scheduler's shed
              rung's Mitchell divider (coeff_bits 0, no rounding) and its
              recovery rung's exact divide; the dense family's prefill
              shapes, q (128,512,128) / kv (32,512,128) G 4, (128,512,64)
              G 1, (160,512,128) / (32,512,128) G 5, the MoE
              family's, mixtral's G 4 with its 4096 window and
              llama4-scout's G 5, and the modality-stub families',
              qwen2-vl-2b's (48,512,128) / (8,512,128) G 6 and
              musicgen-medium's (96,512,64) G 1, and the hybrid
              family's, zamba2-2.7b's (128,512,80) G 1 in bf16 and f32
              (d_head 80; the general cases at d_head 64, 80 and 128);
              bf16 at the tensor-core fragments' edges: Sq and Skv
              not multiples of 16 or 8, one q row at a q_offset, scores
              of large magnitude), its ``cp.async``-ring schedule at every
              depth the wrapper accepts for each case bit-equal to the
              depth-0 kernel (and so within the same tolerances), a depth
              whose ring does not fit and a bf16 k off 16-byte alignment
              refused before any launch (both schedules), and its
              finalize bit-equal on given (acc, l); ``decode_attention``
              (one decode step's attention and its finalize, a cluster
              of blocks per (b, kv head)) within the same tolerances at
              the planner's cluster size and pinned at every size 1..8,
              two calls bit-identical and a CUDA-graph replay bit-equal
              to the eager call at each, the planner's launch equal to
              the one pinned at its size (f32 / bf16, d_head 64 / 128,
              exact and SIMDive divide, scalar and per-row positions,
              pos 0 and Smax - 1, ``ring_full`` before and after the
              wrap, the masked slot on rank boundaries, a window across
              ranks, fewer slots than ranks, G 1 / 3 / 8, a history of
              several rounds, 160 (b, kv head) rows where the planner
              takes one block a row, the main path's shape, the dense
              family's step shapes (G 4 / 1 / 5 over a 544-slot cache),
              the MoE family's (mixtral's ``ring_full`` over its
              544-slot ring, also at per-row positions past the wrap)
              and the modality-stub families' (qwen2-vl's G 6 at cluster
              8, musicgen's 24 kv heads at cluster 2), zamba2-2.7b's
              (4, 32, 1, 80) over 544 slots at pos 527 with and without
              the SIMDive divide and over 2,048 slots at pos 2047 (d_head
              80: a row's 16-byte pieces on 10 or 20 of a warp's lanes),
              and the
              scheduler drill's per-row positions with an idle row at 0
              at the shed rung's Mitchell divider and the recovery rung's
              exact divide), the main
              path's and the dense family's clusters resident in one wave
              (``cudaOccupancyMaxActiveClusters``), and G 9, a position
              tensor left on the CPU and clusters of 0, 9 and 2.5 blocks
              refused before any launch; ``logmatmul`` bit-equal
              for every registered block (the skinny and the large-M
              tiles, depth 0 and the cp.async ring) at the four (K, N) of
              smollm-360m's linears at M = 2048 and 4 (every ring depth
              1..4 of each tile equal to its depth 0), the training
              step's weight-gradient products, Table 4's first layer and
              qwen3-4b's seven at M = 4 and 64, plus the large tile's
              edges (M 63 / 65 / 127 / 129 / 2047, K off the slab and
              around each float partial sum's flush, N odd or under 128,
              every product saturated at both signs, views off 16 bytes),
              ragged shapes, zeros, INT32_MIN,
              width-16 wrapping sums and Mitchell, and decode edges around
              the skinny tile's rows (M = 1, 3, 4, 5, 8, 9; N not a
              multiple of 4; K not a multiple of the split; w and x 4 bytes
              off a 16-byte boundary; (9, 2560) @ (2560, 960), which needs
              the launch to opt in to more than 48 KB of shared memory;
              width-16 wrapping sums at M = 4), zamba2-2.7b's seven
              (K, N) — its Mamba2 layer's and its shared block's
              linears — at M = 4 and 2048, where every ring
              depth 1..4 of each skinny tile must also be ``torch.equal`` to
              its depth 0; ``matmul_emul`` bit-equal to its int64 plain
              version where int32 cannot overflow; ``packed`` (4 x 8-bit /
              2 x 16-bit lanes a word) ``torch.equal`` to ``packed_ref`` for
              its registered block: the exhaustive 8-bit square (zeros
              included) at each of the four lane positions for mul, div
              (frac_out 0 / 4 / 8) and mixed, > 1 M stratified width-16
              pairs, the error sweep's (64, 64) words, ragged, 1-D, one-word
              and unaligned word tensors with mode lanes nonzero only in
              their high bits; its lanes equal to the elemwise kernel's
              masked to 16 bits; frac_out 9 at width 8 and a CPU tensor
              refused before any launch.
4. paths    — the packed path through the port's entry points, with the
              launch counts zeroed just before and read just after:
              ``tuning.frontier.measure_error(kernel="packed")`` on the card
              for mul and div at width 8, coeff_bits 0 and 6, and the BENCH
              grid's mixed rows (``benchmarks/run.py`` ``_run_packed``,
              mirrored here with the port's ``pack`` / ``sample_uints`` /
              ``error_stats``): all six error objects must equal the
              committed ``BENCH_simdive.json`` packed rows to 1e-12
              relative; then ``simdive_packed`` at Table 3's size (256, 1024)
              words and at (17280, 960) words — eight 3840 x 2160 8-bit
              frames — for mul, div and mixed: the ``packed`` count must
              move by exactly the calls made, and every result, at both
              sizes, must equal the plain version's on the same operands.
              (e) ``measure_error(kernel="elemwise")`` on the card for mul
              and div at width 8, coeff_bits 6: its error objects must
              equal the same call's on the plain version, with exactly
              two ``elemwise`` launches.
              Then the serving path at the full width of smollm-360m: batch 4,
              prompt 512, 32 greedy tokens, random weights from a seed,
              through ``launch.serve.generate``, whose prefill is one CUDA
              graph per prompt shape (``make_prefill``) and whose decode
              step is one CUDA graph (``make_decode_step``) replayed per
              token, twice:
              (a) ``--approx simdive`` (divider only), after one served
              prefill that lets the attention autotune time its
              candidates and captures the prefill, and one generate that
              captures the decode step: the kernels' launch counters (a
              replay adds the launches its graph holds) are zeroed just
              before and read just after: 32 attention launches (one per
              layer of the prefill, depth-0 and ring schedules together,
              as the autotune chose) and 32 decode_attention launches per
              decode step (and no elemwise launch) are required, and no
              second capture of either; the eager prefill and loop
              (``prefill_fn=lm.prefill, decode_fn=lm.decode_step``) must
              give the same launches and ``torch.equal`` tokens and
              logits; one replay of the captured prefill must give the
              eager ``lm.prefill``'s logits and k / v caches
              ``torch.equal`` and launch exactly what one eager prefill
              does; one decode step alone,
              eager and one replay, must launch 32 decode_attention
              kernels and nothing else. The
              same model is then run through the plain versions
              (``backend="ref"``, on the GPU, fed the same tokens) and
              logits and tokens are compared. Then served twice more at
              full width with the attention autotune cache pinned
              (``preload_autotune_cache``) to the depth-0 block and to the
              ring block: each pin makes the prefill and the decode step
              capture once more (two generates a pin: the first captures,
              its warm runs counted, the second replays), each run must
              launch only its own schedule, and
              the two must give bit-identical logits and tokens, equal to
              the autotuned run's.
              (b) ``--approx simdive --emulate`` with the block autotune on:
              224 ``logmatmul`` launches (seven linears x 32 layers) per
              prefill and per decode step besides (a)'s (32
              decode_attention a step, no elemwise), one capture of the
              prefill and one of the step across two generates, the eager
              prefill and loop's launches, tokens and logits equal, one
              replayed prefill equal to the eager one (logits, k, v,
              launches), one step alone eager and replayed; at batch 4 x
              prompt 32 x 8 tokens, logits bit-equal (most rows) to a run
              whose matmuls are the plain versions and whose attention op
              runs on the same kernels, and logits and tokens within
              the bound against the all-plain-version run; then served
              twice more at full size with the autotune cache pinned
              (``preload_autotune_cache``) to the default depth-0 block and
              to a ring block: each pin captures the prefill and the
              decode step once more (their warm runs' 224 launches each
              counted), then each run
              must launch only its own schedule, 224 a prefill and a
              decode step, with logits and tokens bit-identical to the
              autotuned run's; one ``--emulate --quantize`` generate at
              full size, captured for its params, ``torch.equal`` to its
              eager prefill and loop, and its replayed prefill equal to
              the eager one.
5. times    — prefill eager (also with each attention schedule pinned, in
              turns) and captured (a replay, host work included), its
              replays back to back, the host's time a call, the capture's
              time, the device kernels of an eager prefill and of a
              replay, the memory the captured prefill holds; decode step
              eager and captured (a replay, host work
              included), its card time, the host share of each, the
              capture's time, the device kernels of an eager step and of
              a replay; generate captured (prefill and step), eager, and
              with the eager prefill before the captured step, with the
              peak memory the card reports; for (a) and (b); and each
              kernel at the main path's shapes beside its bound, its plain
              version (``packed``: at both sizes of phase 4, for each op,
              at 128, 256 and 512 threads a block, beside the elemwise
              kernel and an exact ``torch.mul`` on the same lanes unpacked;
              ``elemwise``: at measure_error's 8-bit square) and — for
              attention and decode_attention — one
              ``scaled_dot_product_attention`` call as the yardstick (timed
              here; the port never calls it) — attention for each
              schedule and ring depth; decode_attention at the decode
              step's shape at the planner's and every cluster size, and
              at cache 2048 / pos 2047, its SDPA over the cache plus the
              new token with a boolean mask; ``logmatmul``: every
              registered block, skinny and large, at M = 2048 and 4,
              beside its bound over the SM's pipes (LOGMATMUL_PIPES) and
              the bound that superseded it —, and the number of kernels one
              decode step puts on the card. A kernel's ``ms`` (and
              ``library_ms``) is device time with the host taken out (many
              launches replayed from one CUDA graph); the eager per-call
              time, host included, is printed beside it.
6. drill    — ``serve --scheduler``'s continuous-batching drill through
              ``launch.scheduler.Scheduler``: smollm-360m full width,
              random weights from seed 0, ``--approx simdive``, batch 4,
              prompt 512, 32 tokens a request, max_seq 544, 12 requests,
              shed_depth 4, recover_depth 1, ladder fine / shed (Mitchell)
              / recovery (exact). ``warmup()`` must warm 6 executables,
              capturing each rung's prefill and decode step, and ``run()``
              must capture nothing; every rung's step must serve the
              scheduler's one cache (``data_ptr``s equal); all 12 requests
              complete, none fails, at least one shed before a recover,
              both fine and shed serve tokens and the tokens attributed to
              the rungs sum to the tokens served; the launch counts,
              zeroed just before ``run()`` and read just after, must be 32
              attention launches per admission and 32 decode_attention
              launches per tick. Then the same drill eager (``lm.prefill``,
              ``lm.decode_step``) and guarded (``ApproxConfig(guard=
              True)``: each capture's warm run checked, no trip) must give
              the captured drill's events and tokens ``torch.equal``; four
              requests admitted together must give ``generate``'s tokens on
              the same prompts; and the drill with ``--emulate`` (8
              requests) must pass the same gates with 224 ``logmatmul``
              launches per prefill and per step. Printed: the drill's wall
              ms, ticks and tokens/s, each rung's ``measure_decode`` (one
              replay, every row mid-generation), an admission (prefill
              replay + insert), the warmup, the memory the six graphs
              hold, and the drill's launches per kernel (also in the
              kernels line, ``launches_drill``).
7. faults   — the fault subsystem (``repro_torch.faults``) on the card,
              after phase 6. (a) Every kernel against its plain version
              under the same arming, for each of the campaign's
              ``default_sites(op, width, full=True)`` for mul and div at
              widths 8 and 16, a table flip at bits 30 and 31 and a log
              flip at bit 31 for each, and the pack site
              ``FaultSpec(site="pack", bit=7, width=16)``: ``elemwise``,
              ``packed`` (against ``packed_word_op``) and ``logmatmul``
              (every registered block, both schedules, each taking a
              log fault above bit 19) ``torch.equal``;
              ``flash_attention`` (depth 0 and ring),
              ``decode_attention`` and the finalize (bit for bit)
              at the divider's serving spec within ``judge_attention``'s
              tolerances, on inputs whose softmax sums are exact; every
              output moved from its disarmed one exactly where the plain
              version's did. (b) The fine and the shed rung's prefill and
              decode step, captured disarmed: under the chaos fault, a
              width-16 div table flip and a width-16 log fault, one replay
              equals the eager call bit for bit and moves exactly where
              the fault reaches the rung; disarmed, pristine again; no
              capture; the tables keep their ``data_ptr``. (c)
              ``faults.campaign.smoke(device="cuda")`` passes and
              ``run_campaign`` on the card equals it on the CPU site for
              site. (d) ``serve --chaos`` at full width: the scheduler
              drill, scrub every tick, the chaos fault armed after the
              first tick, 12 requests (8 with ``--emulate``): all
              complete, none fails, at least one quarantine and one
              retry, recovery tokens, a ``scrub-dirty`` event naming a
              div table, no capture during the drill, captured equal to
              eager event for event and token for token; printed: the
              chaos drill's ms, ticks and tok/s, one scrub of the
              ladder's tables (read-back included), ``set_faults`` arm and
              disarm, and the drill's launches (also in the kernels line,
              ``launches_chaos``). Last: nothing armed, and every kernel
              at phase 3's main-path shapes bit-equal to its output
              before phase 7.
8. policy   — the tuner's selection layer and ``serve --policy`` on the
              card. (a) ``tuning.build_policy(("mul", "div"), width=8)``
              and a width-16 ``select_config`` with their error sweeps
              on the card: one ``elemwise`` launch per (op, width,
              coeff_bits) measured, every entry (stats included) equal
              to the same calls on the plain versions to 1e-12 relative,
              the policy saved and loaded again unchanged. (b) A
              ``simdive-policy/v1`` file of three layer segments
              (``POLICY_SEGMENTS``: attention dividers w16 cb6 q15, cb4
              q12 and cb5 with frac_out unset; backends ``pallas`` and
              ``auto``) loaded as ``serve --policy`` loads it and served
              at full width, batch 4, prompt 512, 32 tokens: the plan's
              rows equal the file's; ``flash_attention`` (both schedules)
              and ``decode_attention`` within phase 3's tolerances of
              their plain versions at every divider spec of the policy,
              at the serving shapes; the last segment's table made by
              the prefill's warm run, before the capture, and never made
              again; the captured generate ``torch.equal`` to the eager
              one with 32 attention launches a prefill, 32
              decode_attention a step and one capture of each; within
              phase 4's tolerances of the same file with every backend
              rewritten to ``ref`` (the plain versions on the card); and
              a policy pinning the config's own divider ``torch.equal``
              to the policy-free run. (c) ``--emulate`` with per-segment
              matmul entries (w8 cb6 / cb2 / cb8): 224 ``logmatmul``
              launches a prefill and a step, captured equal to eager.
              (d) ``serve --scheduler --policy`` with phase 6's gates
              (the fine rung carries the policy, the shed and recovery
              rungs drop it; captured == eager == guarded; four requests
              == ``generate``) and ``serve --chaos --policy`` with phase
              7 (d)'s, the scrub's table identities covering every
              segment's tables. Printed: the build's seconds, the plans,
              the policy generate captured and eager, the prefill and
              step replays, the drills' ms and tok/s, and the launches of
              each path (also in the kernels line, ``launches_policy*``).
9. arithmetic — the rest of the arithmetic on the card. (c)
              ``approx_rmsnorm`` on (4, 512, 960) bf16 activations (rows of
              scales 10^-4..10) with smollm-360m's eps: ``backend="cuda"``
              (one ``sqrt`` and one ``elemwise`` launch) ``torch.equal`` to
              ``backend="ref"``; the rsqrt's out-of-lane numerator 2^31 at
              width 16 through the elemwise kernel equal to its plain
              version for every r in 1..256, with four of the
              reference's words (``RSQRT_WORDS``). (b)
              ``_fixed_point_div`` and ``approx_softmax``
              on smollm-360m's prefill scores, (60, 512, 512) float32
              causal: ``cuda`` (one ``elemwise`` launch a call)
              ``torch.equal`` to ``ref``. (a) The ``sqrt`` kernel
              (``csrc/elemwise.cu``) ``torch.equal`` to its plain version on
              every 8- and 16-bit operand at frac_out 0, 8 and 16 and on the
              norms' operands (the embeddings of (d)'s prompts and (c)'s
              rows), disarmed, under each of the campaign's log sites and
              a log flip at bit 31 at widths 8 and 16 (outputs moved) and
              disarmed again (as before). (d) smollm-360m at full width with
              ``ApproxConfig(mode="simdive", use_in_norm=True)``, batch 4,
              prompt 512, 32 tokens, through ``generate`` with both served
              graphs: 64 ``sqrt`` and 64 ``elemwise`` launches a prefill
              and a step (2,048 each a generate) beside 32 attention a
              prefill and 32 ``decode_attention`` a step, one capture of
              each, captured == eager, one replayed prefill == the eager
              one; logits within 6 bf16 ulps of the largest logit of the
              same config on the plain versions, decided tokens equal.
              Printed: the sqrt kernel at the norms' shapes beside its
              bound, the softmax times, and the generate, prefill and step
              replays against the same process's use_in_norm-free path, in
              turns (the kernels line's ``sqrt`` row; ``elemwise``'s
              ``launches_use_in_norm``).
10. dense family — the three other dense configurations at full width,
              depth cut (SERVED_LAYERS: qwen3-4b 3 of 36 layers,
              stablelm-1.6b 2 of 24, qwen2.5-14b 2 of 48; random weights
              from seed 0, batch 4, prompt 512, ``--approx simdive``),
              each model's graphs dropped before the next. (k) The
              kernels' times at qwen3-4b's shapes beside their bounds and
              ``scaled_dot_product_attention`` (attention at its prefill,
              decode attention at its step),
              the seven linears at M = 4 and 2048, and the sqrt kernel at
              16.8 M lanes; phase 3 holds the kernels at the three
              configurations' shapes against their plain versions. (a)
              qwen3-4b (qk-norm, d_head 128, G 4, untied), 32 tokens: the
              captured prefill and step alone (memory each holds), then
              the captured generate ``torch.equal`` to the eager one with
              one attention launch a layer a prefill and one
              decode_attention a layer a step (31 steps), a replayed
              prefill equal to the eager one;
              logits within 6 bf16 ulps of the largest logit (which must
              lie in [2, 4)) of the plain versions, decided tokens equal;
              peak memory and times. (b)
              qwen3-4b ``--emulate``, 4 tokens: 7 ``logmatmul`` a layer
              a prefill and a step, captured == eager. (c) stablelm-1.6b
              (LayerNorm, qkv bias, rotary on 16 of 64 features, G 1) and
              (d) qwen2.5-14b (qkv bias, G 5), each as (a). Each model
              also: ``LM.init``'s peak under INIT_PEAK_RATIO of its
              parameters' bytes and one eager
              step's device time by kernel, as phase 11 has them.
11. MoE family — after phase 10's graphs are dropped, random weights
              from seed 0, batch 4, prompt 512, 32 tokens, ``--approx
              simdive``, each model dropped before the next: (a)
              mixtral-8x7b (top-2 of 8 experts, window 4096: a 544-slot
              ring cache, every decode step ``ring_full``) at 2 of its
              32 layers and (b) llama4-scout-17b-a16e (top-1 of 16 and a
              shared expert, vocab 202,048) at 2 of its 48 (SERVED_LAYERS):
              the parameters' bytes and ``LM.init``'s peak, under
              INIT_PEAK_RATIO of them; the captured prefill and step
              alone (memory each holds); the captured generate
              ``torch.equal`` to the eager one with one attention launch a
              layer a prefill and one decode_attention a layer a step and
              nothing else; a replayed prefill equal to the eager one; the
              eager run and the plain versions fed its tokens, every
              ``_dispatch`` call recorded in both: the share of routes
              that agree at each layer over ROUTE_AGREE_FLOOR, the logits
              within 6 bf16 ulps of the largest on every row whose own
              routes agree at every layer, at least ROUTE_CHECKED_FLOOR of
              the rows checked, decided tokens equal (and the same gate
              fails on the logits moved by twice its bound); the entries
              each layer dropped past capacity in the prefill and the
              decode steps; peak memory, times and one eager step's
              device time by kernel. (c) llama4-scout ``--emulate``, 4
              tokens: 7 ``logmatmul`` a layer a prefill and a step (the
              attention's four linears and the shared expert's three),
              captured == eager.
12. modality-stub families — after phase 11's models are dropped,
              qwen2-vl-2b whole and musicgen-medium at 4 of its 48
              layers (SERVED_LAYERS), random weights from seed 0, batch
              4, prompt 512, 32 tokens, ``--approx simdive``, each model
              dropped before the next. (k) The attention kernels' times at both
              configurations' shapes beside their bounds and
              ``scaled_dot_product_attention``. (a) qwen2-vl-2b (M-RoPE
              sections (16, 24, 24), qkv bias, G 6, vocab 151,936), as
              phase 10 (a): 28 attention launches a prefill and 28
              decode_attention a step; then the vision stub: 256 patch
              embeddings (a 16 x 16 grid) at slots 0-255 with Qwen2-VL's
              M-RoPE positions (image t 0, h row, w col; the text after
              at 16 + j), the prefill through the eager ``lm.prefill``
              and 31 steps through the captured step, logits within 6
              bf16 ulps of the plain versions, decided tokens equal, and
              the same prefill with (B, P) positions moving the logits
              past twice that bound. (b) musicgen-medium (gelu, LayerNorm,
              sinusoidal positions, 4 codebooks of 2,048), prompts (4,
              512, 4): one attention a layer a prefill and one
              decode_attention a layer a step, ``(B, C, V)`` logits as
              (a). (c) musicgen-medium ``--emulate``, 4 tokens: 6
              ``logmatmul`` a layer a prefill and a step (q, k, v, o, w1,
              w2; the heads exact), captured == eager. Each model also:
              parameters' bytes and ``LM.init``'s peak, peak and held
              memory, the prefill and step replays, one eager step's
              device time by kernel.
13. rwkv6 — after phase 12's models are dropped, rwkv6-1.6b at 2 of its
              24 layers (SERVED_LAYERS; d_model 2,048, 32 heads of 64,
              d_ff 7,168, vocab 65,536, untied), random weights from
              seed 0, batch 4, prompt 512, 32 tokens, ``--approx
              simdive``; float32 matmuls at full precision (no TF32).
              (k) ``logmatmul`` at its eight linears' (K, N) — (2048,
              2048) x 6, (2048, 7168), (7168, 2048) — timed at M 4 and
              2048 beside their bound and an exact float32
              ``torch.matmul`` (phase 3 holds them bit for bit at M 4 and
              64, every block, both schedules). (a)
              divider-only: no SIMDive kernel launches (no softmax), the
              captured prefill and step alone (memory each holds, the
              recurrent cache included), the captured generate
              ``torch.equal`` to the eager one, a replayed prefill's
              logits, att_x, ffn_x and state ``torch.equal`` to
              ``lm.prefill``'s, ``LM.init``'s peak, peak memory, times,
              one eager step's device time by kernel; the prefill over
              64 tokens against the same tokens one decode step at a time
              (float32 activations: CHUNK_VS_STEP_F32_REL_TOL; the served
              bf16: closer than the bf16 prefill is to the float32 one),
              and
              ``_wkv_chunk`` at (B 4, Tc 64, H 32, dk 64) against itself
              in float64 (WKV_F64_REL_TOL). (c) ``--emulate``, 4 tokens:
              8 ``logmatmul`` a layer a prefill and a step (the head
              exact), captured == eager.
14. zamba2 — after phase 13's models are dropped, zamba2-2.7b at 9 of
              its 54 Mamba2 layers (SERVED_LAYERS; d_model 2,560,
              d_inner 5,120 in 80 heads of 64, state 64, and a shared
              attention + gelu MLP block after every 9th layer: 1 of its
              6 invocations, 32 heads of d_head 80, each with its own
              rank-64 LoRA on ``wq``, merged every call; vocab 32,000,
              untied), random
              weights from seed 0 and ``lora_b`` a seeded non-zero draw
              (the init's zeros would add nothing to ``wq``), batch 4,
              prompt 512, 32 tokens, ``--approx simdive``. (k) The
              attention kernels at its shapes (prefill q / kv (128, 512,
              80), step (4, 32, 1, 80) over 544 and 2,048 slots) beside
              their bounds, their plain versions and
              ``scaled_dot_product_attention``, ``logmatmul`` at its
              linears at M 4 and 2048 beside an exact bf16 matmul, and
              one LoRA merge. (a) divider-only: one attention a prefill
              and one ``decode_attention`` a step an invocation and
              nothing else, the
              captured generate ``torch.equal`` to the eager one, a
              replayed prefill's logits and cache (conv, ssm, k, v)
              ``torch.equal`` to ``lm.prefill``'s, the logits within 6
              bf16 ulps of the plain versions' (decided tokens equal);
              the parameters' and cache bytes, ``LM.init``'s peak, the
              memory the captured prefill and step hold, peaks, times
              and one eager step's device time by kernel. (c)
              ``--emulate``, 4 tokens: 6 ``logmatmul`` a Mamba2 layer and
              6 a shared-block invocation a prefill and a step (the head
              exact), captured == eager.
15. training — the training path (``repro_torch.launch.train``) on
              smollm-360m at full width, after every served graph is
              dropped. (a) ``logmatmul`` at the gradient products'
              shapes, gx (2048, N_out) x (N_out, K_in) and gw (K_in,
              2048) x (2048, N_out) of ``wq`` and ``w2``, every
              registered block (skinny and large) ``torch.equal`` to its
              plain version on 256 rows, timed beside its bound;
              ``elemwise`` at the training finalize's (4, 5, 3, 512, 64) lanes
              ``torch.equal`` to its plain version. (b)-(d) under
              ``torch.use_deterministic_algorithms``: (b) one
              ``make_train_step`` step at 2 of 32 layers, batch 2 x 128,
              ``--approx simdive --backward approx``, on the kernels and
              on the plain versions: loss, gradients and updated
              parameters ``torch.equal``; (c) ``train`` with all 32
              layers, batch 4 x 512, remat on, ``--approx simdive
              --backward approx``, 3 steps, a checkpoint every 2 and a
              rung change at step 2: a step's 704 ``logmatmul`` (22 a
              layer: R-8 leaves wq / wk / wv without gradient products)
              and 64 ``elemwise`` launches, its time, peak memory and device
              time by kernel, every loss finite, a run killed after 2
              steps (in the first rung) and resumed (in the second) equal
              to the uninterrupted run from the checkpoint on; (d) ``train_twin`` at full width, 2 steps,
              exact against ``--approx simdive``, R-8 (no gradient for
              the approximate model's wq / wk / wv), and an exact-base
              twin at 2 layers with zero divergence.
16. applications — the paper's two application studies at the
              reference's own size, after every served graph is dropped.
              (a) ``logmatmul`` at Table 4's layer shapes, (1000, 784) x
              (784, 100), (1000, 100) x (100, 100), (1000, 100) x (100,
              10), every rung of ``default_candidates("matmul")`` and the
              Mitchell rung, every registered block, bit-equal to
              ``logmatmul_ref`` (int32) and, in its wide
              form, to ``logmatmul_wide_ref`` (int64), and
              ``matmul_emul``'s kernel path (the wide form at width 16)
              to its int64 plain version; the wide form timed against the
              int32 one there and at smollm-360m's wq at the prefill;
              ``elemwise`` at Fig. 3/4's lanes (the blend's 65,536, the
              Gaussian's 63,504 multiplies and its divider's window sums
              past a 16-bit lane) at every rung of the mul ladder,
              bit-equal, timed. Then, every count zeroed just before and
              read just after: (b) Table 4's 784-100-10 and
              784-100-100-10 MLPs trained on the card (6,000 images, 600
              steps, float32, TF32 off) and run on the 1,000 test images
              in 8-bit fixed point — accurate, SIMDive w8 cb6 and
              Mitchell w8 on ``matmul_int``, logits on the kernel
              ``torch.equal`` to the plain version's, float accuracy over
              TABLE4_FLOAT_FLOOR; (c) the campaign's ``--ann``:
              ``ann_accuracy_drop`` on the kernel equal to the plain
              version on the same weights, the drop positive, nothing
              left armed, and ``python -m repro_torch.faults.campaign
              --ann --widths 8`` exiting 0 with an ``ann`` entry; (d)
              ``profile_ann`` on the 784-100-100-10 MLP, ``greedy_assign``
              at ANN_BUDGET points, ``assignment_policy`` and
              ``ann_policy_metric``, and ``profile_imaging`` for psnr and
              ssim, every value on the kernels equal to the same run on
              the plain versions. The launches join the kernels line
              (``launches_apps``).
17. width 32 — the 64-bit bus (the reference's uint64 lanes). (a) The
              width-32 forms against their plain versions, disarmed and
              under a log flip at bits 0, 20 and 31 and a flipped width-32
              div-table entry: ``elemwise`` mul / div / mixed at frac_out
              0 / 8 / 16 and ``sqrt`` at 0 / 8 on 16.8 M stratified lanes
              plus the edge words, and the attention finalize alone
              (``softmax_div_kernel``), ``torch.equal``, each arming moving
              the kernel's output where it moves the plain version's;
              ``flash_attention`` at smollm-360m's and qwen3-4b's prefill
              shapes within ``judge_attention``'s tolerances, every ring
              depth ``torch.equal`` to depth 0; ``decode_attention`` at
              their step shapes at every cluster size (under the bit-31
              log flip, k's low bit, at most 0.3 % of the outputs outside
              the tight bound, each the plain version's times a quotient
              step of 4^n: W32_KFLIP_OUTLIER_SHARE). (b)
              ``measure_error('mul' / 'div', 32, 8)`` on the card equal to
              the plain versions' to 1e-12 relative, and
              ``select_config(width=None)`` sweeping width 32. (c)
              smollm-360m at full width, batch 4, prompt 512, 32 tokens,
              under a policy file whose attention entry is width 32 cb 8
              frac_out 15 and whose div entry width 32 cb 8, then with
              ``use_in_norm``: captured == eager, one width-32 attention a
              layer a prefill and one width-32 ``decode_attention`` a step
              (with use_in_norm one width-32 ``sqrt`` and ``elemwise`` a
              block norm). Without use_in_norm the logits lie within
              ``ulp_logit_tol`` of the same file on the plain versions.
              With it that gate is replaced (w32_serve): the norms'
              kernels leave the logits ``torch.equal`` to their plain
              versions', with attention on its kernels and on its plain
              version, and the all-kernel vs all-plain logit gap (4.23 on
              the H100) is recorded only; its witness, the all-plain run
              against itself with every attention output one bf16 ulp off,
              must part by more than ``ulp_logit_tol`` too. Both attention
              schedules pinned in turn; the served path timed in turns
              with the width-16 one.
              The kernels line's ``*_w32`` rows carry the forms' times,
              bounds and registers / spills from the build.
18. mesh   — the sharded training path (``launch/sharding.py``,
              ``specs.py``, ``train --tp``): ranks spawned on the one
              card, joined by a ``gloo`` group (NCCL refuses two ranks on
              one device), each loading the kernels phase 2 built, every
              input from seed 0. First a probe: gloo's ``all_reduce`` SUM
              / MAX and ``broadcast`` on CUDA tensors of every dtype the
              path reduces. (a) stablelm-1.6b at full width, 4 of 24
              layers, batch 4 x 512, ``--approx simdive --backward
              approx``: ``launch.train.train`` 2 steps at tp 2 against
              tp 1 in this process; every SIMDive linear of layer 0 on
              the kernels at its shard shapes ``torch.equal`` to the
              unsplit linear (forward, both gradient products); the
              losses and the first step's gradients (recorded inside
              each ``train`` run, ``first_step_grads``; gathered on the
              host) within twice a witness, the tp-1 run against itself
              with every row's log-sum-exp one float32 ulp up
              (``ulp_nudged_lse``); every rank's launches (each gated)
              and ``all_reduce`` calls a step. (b) smollm-360m at full
              width, 2 of 32 layers,
              3 ranks (tp 3: K/V replicated and repeated, the MLP
              replicated, the vocabulary split), 1 step, the same gates.
              (c) mixtral-8x7b's MoE block at full width, x (4, 512,
              4096) bf16: the SPMD block over 2 ranks against the
              unsplit ``moe_ffn``: routes equal, the output within
              ``MESH_MOE_ULPS`` bf16 ulps of its largest magnitude, aux
              within 1e-6. (d) a world-1 NCCL group: one step of (a)'s
              model under a bound (1, 1) mesh ``torch.equal`` to the same
              step over gloo. (e) ``compress_psum`` over 2 ranks on CUDA
              tensors equal to the plain computation on the CPU. (f)-(h)
              in (a)'s spawn, one step each at (a)'s batch with its
              gates (layer 0's SIMDive linears ``torch.equal`` at their
              shard shapes, the loss within twice the lse witness, the
              first step's gradients within twice the larger witness,
              every rank's launches): (f) smollm-360m, 2 of 32 layers,
              15 query and 5 kv heads over 2 ranks (a cut head: q / k / v
              gathered once a block, each rank's whole GQA groups
              attended, the output gathered once); (g) rwkv6-1.6b, 2 of
              24 layers (its heads split); (h) zamba2-2.7b, 9 of 54
              layers (one group of Mamba2 layers, their heads split, and
              the shared block). (i) the served forward at tp 2,
              divider-only: stablelm-1.6b (4 layers; the cache split by
              kv head) and smollm-360m (2 layers; by sequence), one
              prefill of 4 x 512 and 8 decode steps: the gathered logits
              within 6 bf16 ulps of the unsplit run's largest logit, one
              ``flash_attention`` a layer a prefill, and a step one
              ``decode_attention`` a layer (stablelm) or one
              ``elemwise`` a layer, the divider after the ranks' sums
              (smollm), on every rank. (j) the dry run
              (``launch/dryrun.py``) on the host under the fake process
              group at world 2 / 3 / 4, cells (a), (b), (f)-(h), (l),
              (m): collectives a step (calls and bytes by mesh axes) and
              parameter and optimizer bytes equal to the ranks'; (a)'s
              traced peak within 25 % of rank 0's
              ``max_memory_allocated`` over its run. (k) one FULL
              ``train_4k`` single-pod dry-run cell a family, ``ok``. The
              mesh's options, each with (a)'s gates: (l) (a)'s
              model, one step under ``--sp`` in (a)'s spawn, every
              SIMDive linear of layer 0 ``torch.equal`` at its
              sequence-parallel shard shapes; (m) smollm-360m (2 layers),
              one step under ``--pure-dp`` over (a)'s two ranks and one
              under ``--fsdp`` over four (data 2 x model 2, spawned
              beside (b)'s), the loss and gradients also allowed the data
              ranks' float order (8 float32 ulps, one bf16 ulp of a
              leaf's largest, the CPU tests'); (n) mixtral-8x7b (2
              layers) served at tp 2 in (i) — every decode step's
              ``all_reduce`` calls one a layer more than the attention's
              (the MoE's sum), the logits under phase 11's routing-aware
              gate — and its MoE block under the experts override,
              ``torch.equal`` to the unsplit block with one
              ``all_gather``; (o) (i)'s served forward 4 steps more with
              per-row positions (smollm's cache split by sequence). The
              ``logmatmul`` row carries its times at (a)'s (also
              ``--sp``'s), rwkv6's, zamba2's and (m)'s shard shapes.

19. analysis — the static analyzer (``repro_torch.analysis``): (a)
              ``python -m repro_torch.analysis --gate --json`` as a
              subprocess on this machine's host and torch build, started
              after the build and run on one CPU thread beside phases
              3-18 (stopped at exit whatever happens): exit 0,
              every case proved, no coverage gap, the lint clean; its
              case count and seconds printed. (b) each proved case of an
              op with a CUDA kernel run disarmed at its operands'
              corners (lo, hi and every 2^j - 1, 2^j, 2^j + 1 inside the
              interval): ``elemwise`` mul / div / mixed and ``sqrt`` at
              widths 8 / 16 / 32 with the case's coeff_bits and
              frac_out over every corner pair, ``packed`` on corner and
              alternating lane words, ``logmatmul`` width 8 at K 32 /
              128 / 512 with every operand +-255 (the int32
              accumulator's worst case, K times the largest product)
              and the attention finalize alone (``softmax_div_cuda``) on
              corner rows, each ``torch.equal`` to its plain version.

Output: progress lines, then the card line, one JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def wall_clock() -> float:
    """The host clock every phase time here is read from: the port's one
    clock helper (``repro_torch.metrics.timing.wall_clock``)."""
    from repro_torch.metrics.timing import wall_clock as clock

    return clock()

SEED = 0
ARCH = "smollm-360m"
BATCH, PROMPT, GEN = 4, 512, 32

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# 32-bit integer operations: 64 INT32 lanes per SM per clock on Hopper; the
# rate is SM count x 64 x the maximum SM clock, both read on the card
# (int32_ops_per_s). The elemwise, packed and sqrt counts below are the
# least number of integer operations each function needs, counted from the
# datapath (csrc/simdive_datapath.cuh and its plain version
# kernels/datapath.py), all taken on the INT32 lanes.
#
# logmatmul's bound is the least work of its products and operand
# conversions over the pipes an SM has, each over its own rate a clock
# (LOGMATMUL_PIPES: scaled to the card by int32_ops_per_s / 64): the INT32
# lanes 64 (adds, shifts, logic, min / max), the FP32 lanes 128, shared-
# memory loads 32 (128 bytes a clock: one 4-byte table read a lane) and
# the issue of 4 warp instructions (128 lanes); the busiest pipe gives the
# time (logmatmul_ops_ms). One signed SIMDive product at width 8 with
# rounding, its operands converted once, needs at least:
#   a table read, the coefficient of its region (a shared-memory load) 1;
#   on the INT32 lanes: the table offset hx + hw 1 and the ternary sum
#   la + lb + corr 1 — in the float route (csrc/logmatmul.cuh, the FLOAT
#   form) that same IADD3 of pre-shifted words builds the product's float
#   bits, the anti-log's exponent and mantissa;
#   on the FP32 lanes: one add that rounds the anti-log half up and
#   accumulates it with its sign, into a partial sum held where the float
#   grid is the integers 1;
#   4 issue slots. The clamp at the bus maximum is left out: only products
#   whose ternary sum reaches 16 x 2^7 saturate, and a kernel that knows
#   none can could skip it.
# Each pipe takes 1/32 of an SM clock a product (INT32 2/64, LDS 1/32,
# issue 4/128). Converting one operand element, once: 10 integer
# operations (sign test, |v|, clamp to the lane, leading one, 1 << k,
# fraction, alignment, zero flag, F - k, (k << F) + frac), on the INT32
# lanes and 10 issue slots. A kernel timed under this bound means the bound
# is wrong, never that the kernel is right.
LOGMATMUL_PIPES = {"int32": 64, "fp32": 128, "lds": 32, "issue": 128}
LOGMATMUL_PRODUCT_WORK = {"int32": 2, "fp32": 1, "lds": 1, "issue": 4}
LOGMATMUL_OPERAND_WORK = {"int32": 10, "issue": 10}
# the bound this one supersedes (reported beside it): all of it integer
# work, 11 operations a product of which 7 only the INT32 lanes take (the
# clip, integer part, mantissa, the two anti-log shifts, the saturation, the
# ternary add) and 4 that also issue as IMAD on the FMA pipe (offset,
# rounding add, sign product, signed accumulate); 10 an operand, 8 of them
# INT32-only — over 128 lanes all, or 64 the INT32-only, the longer
LOGMATMUL_SUPERSEDED_OPS = (11, 7, 10, 8)
# One elemwise div lane (width 16, rounding; the quotient of the decode
# finalize is below one, so the right-shift path): two LOD + log
# conversions 2 x 6 (FLO, 1 << k, xor, F - k, shift, (k << F) | frac),
# region index 5 (mask and shift per operand, shift-or join), zero tests 2,
# coefficient select 1, ternary subtract la - lb + corr 1, ls >> F 1,
# mantissa 1, shift amount I + frac_out - F 1, the right shift (direction
# test, negate, clip at 31, 1 << (n - 1), rounding add, shift) 6, x / 0 and
# 0 / x selects 2.
ELEMWISE_OPS_PER_LANE = 32
# One packed lane at width 8 with rounding, per op: lane expand, a and b,
# one byte extract each (one PRMT, __byte_perm(w, 0, 0x444i), gives the
# zero-extended byte) 2 (3 with a mode word); two LOD + log conversions
# 2 x 6; region index 5; zero tests 2; coefficient select 1; then
#   mul:   ternary add la + lb + corr 1 (IADD3), clip at 0 1, ls >> F 1,
#          mantissa 1, saturation test 1, the anti-log shift (direction
#          test, shift amount, shift) 3 — products of uniform 8-bit
#          operands mostly shift left, with no rounding add —, zero
#          select 1;
#   div:   ternary subtract 1, ls >> F 1, mantissa 1, shift amount
#          I + frac_out - F 1, the shift (direction test, clip at 31,
#          shift) 3 — at frac_out 8, 3/4 of uniform quotients shift left —,
#          x / 0 and 0 / x selects 2;
#   mixed: the mode test 1 and one of the two tails (9 either way);
# and the repack onto the 16-bit output lanes: one PRMT
# (__byte_perm(r0, r1, 0x5410)) masks and merges two results into an output
# word, 0.5 a lane.
PACKED_OPS_PER_LANE = {"mul": 2 + 12 + 5 + 2 + 1 + 9 + 0.5,         # 31.5
                       "div": 2 + 12 + 5 + 2 + 1 + 9 + 0.5,         # 31.5
                       "mixed": 3 + 12 + 5 + 2 + 1 + 1 + 9 + 0.5}   # 33.5
# device-memory bytes a 4-lane word at width 8 must move: a, b and two
# output words; a mode word adds 4
PACKED_BYTES_PER_WORD = {"mul": 16, "div": 16, "mixed": 20}
# the packed path's sizes in uint32 words: Table 3's own
# (benchmarks/table3_simd.py: 1 M 8-bit lanes) and a full-card one, eight
# 3840 x 2160 8-bit frames (66.4 M lanes) — the paper's Fig. 3 per-pixel
# blending at UHD video size
PACKED_SIZES = {"table3": (256, 1024), "full": (17280, 960)}
# threads per block timed at both sizes (the op registers 256 alone)
PACKED_BLOCK_SWEEP = ((128,), (256,), (512,))
# the committed BENCH packed rows are held to the kernel path's error
# objects: bit-equal lanes give the same float64 statistics, so exact
# equality is expected; 1e-12 relative allows only a float64 summation
# order the numpy version might change
BENCH_REL_TOL = 1e-12

# ---- tolerances, kernel vs plain version on the same inputs (on the GPU) --
# float32, exact divide: online softmax over 64-wide kv tiles vs a dense
# softmax — summation order only, a few ulps of O(1) values
TOL_F32 = dict(atol=3e-5, rtol=3e-5)
# bfloat16: p is rounded to bf16 (2^-9 relative per term) before the PV
# product — in the kernel relative to the running maximum of its kv tile,
# in the dense plain version relative to the final one — so the two sums
# differ by up to 2^-8 of sum(p |v|) / l <= max|v| (< 6 here), whatever the
# output's own size after cancellation: 2e-2 absolute; plus one bf16 ulp
# (2^-8) of the output for the final rounding, which f32 round-off can flip
TOL_BF16 = dict(atol=2e-2, rtol=8e-3)
# SIMDive divide: f32 round-off in (acc, l) may move a rounded 16-bit
# divider operand by one unit, i.e. the quotient by <= 2^-12 of the row's
# scale (|v| < 6 here): 1.25e-3 absolute. Rarely (when that unit crosses
# one of the 64 correction regions) the coefficient itself steps, a jump of
# up to a few percent of the element: those may be at most 1e-4 of all
# elements and must stay inside the loose bound.
TOL_APPROX_EXTRA = 1.25e-3
APPROX_OUTLIER_SHARE = 1e-4
TOL_APPROX_LOOSE = dict(atol=2e-2, rtol=6e-2)
# served logits, kernels vs plain versions: activations and logits are bf16
# (8 bits of mantissa), so a logit of magnitude in [2^e, 2^(e+1)) has an ulp
# of 2^(e-7). Attention outputs that differ by one bf16 ulp between kernel
# and plain version pass through every layer; the measured difference on
# smollm-360m is 0.07 = 2.2 ulps of its largest logits (PERF.md). Bound:
# LOGIT_ULPS ulps of the plain run's largest |logit| (ulp_logit_tol),
# derived for the largest logits each head gives at the main path's size,
# which must lie in the range named for it: smollm-360m's tied head about
# 5, in TIED_LOGIT_RANGE (ulp 2^-5, bound 0.1875); the dense family's
# untied heads, uniform(+-d^-0.5) over the final norm's unit-rms rows, a
# standard deviation of 1/sqrt(3), the largest of B x GEN x V (19.4 M for
# qwen3-4b) ~5.8 of them, ~3.4, in UNTIED_LOGIT_RANGE (ulp 2^-6, bound
# 0.09375)
LOGIT_ULPS = 6
TIED_LOGIT_RANGE = (4.0, 8.0)
UNTIED_LOGIT_RANGE = (2.0, 4.0)
# --emulate, kernels vs plain versions, at prompt 32, two comparisons:
# (1) against a run whose matmuls are the plain versions but whose
# attention op runs on the same kernels: the integer matmuls are
# bit-equal, so most (batch, step) logit rows must be bit-equal (measured:
# all of them, PERF.md); (2) against the all-plain run: the bf16 attention
# kernel sums its products on the tensor cores, in another f32 order than
# the dense plain version (whose order the earlier CUDA-core kernel happened
# to share, so the two used to agree bit for bit at one kv tile). Attention
# outputs then differ by one bf16 ulp here and there, as on the
# divider-only path, and 8-bit re-quantization of the activations carries
# them through 32 layers: the divider-only path's bound, LOGIT_ULPS ulps of
# the largest logits, far under what a wrong scale or a wrong linear does
# (O(1)).
EMULATE_EQUAL_ROW_SHARE = 0.5
# the plain-version comparison of the emulate path runs shorter: its int64
# emulation of the 644 G products of a prompt-512 prefill would take many
# minutes; prompt 32 is 40 G. The blocks the autotune serves at the main
# path's shapes are held bit for bit against the plain version in phase 3.
REF_PROMPT, REF_GEN = 32, 8
# the scheduler's shed rung (coarse_step): the divider's Mitchell spec, no
# correction, no rounding
MITCHELL_DIV = dict(width=16, coeff_bits=0, index_bits=3,
                    round_output=False)
# the scheduler drill (launch/scheduler.py, serve --scheduler): the
# reference's drill settings (launch/serve.py defaults); the --emulate
# drill floods fewer requests (each of its admissions is a ~0.6 s prefill)
# but still sheds (8 >= 4) and recovers
DRILL_REQUESTS, DRILL_SHED, DRILL_RECOVER = 12, 4, 1
DRILL_EMULATE_REQUESTS = 8
# the registered attention ring block: the pinned full-width run and the
# flash_attention_pipelined row of the kernels line use it
ATTENTION_RING_BLOCK = (64, 64, 2)
# the registered logmatmul ring block the full-size --emulate run is pinned
# to (the depth-0 pin is the default block)
MATMUL_RING_BLOCK = (4, 128, 256, 4, 2)
# the registered large-M logmatmul blocks phase 16 times beside the
# skinny ones at the studies' shapes: depth 0 and its ring
LARGE_BLOCK, LARGE_RING_BLOCK = (64, 128, 32, 2, 0), (64, 128, 32, 2, 2)
# phase 8: the served policy's layer segments [lo, hi) of smollm-360m's 32
# layers, each with its attention divider entry and, on --emulate, its
# matmul entry. The first is the config's own divider written out with
# the policy files' name of the kernel, 'pallas'; the second its own
# coeff_bits and frac_out, backend 'auto'; the third coeff_bits 5 — a
# table no earlier phase reads — and no frac_out (the config's 15 stands).
# The dividers keep 16-bit lanes: phase 4's tolerances against the plain
# versions are derived for 16-bit divider operands (an 8-bit operand's
# unit is 2^-7 of its row's scale, which bf16 round-off moves). The
# matmul entries keep 8-bit lanes (16-bit magnitudes overflow the int32
# sums of a 960-long dot product)
POLICY_SEGMENTS = (
    (0, 10, dict(width=16, coeff_bits=6, frac_out=15, backend="pallas"),
     dict(width=8, coeff_bits=6, backend="pallas")),
    (10, 21, dict(width=16, coeff_bits=4, frac_out=12, backend="auto"),
     dict(width=8, coeff_bits=2, backend="auto")),
    (21, 32, dict(width=16, coeff_bits=5, backend="pallas"),
     dict(width=8, coeff_bits=8, backend="pallas")),
)
# phase 8 (a): the error budget (ARE %) the policies are built for
POLICY_BUDGET = 1.2

# phase 9: the arithmetic. The softmax operand is smollm-360m's prefill
# scores, (batch x heads, prompt, prompt) float32, causal; the norm operand
# its activations, (batch, prompt, d_model) bf16, rows of scales 10^-4..10
# (under 2^-8 rms the rsqrt's qm is no longer clipped to the lane)
SOFTMAX_SHAPE = (BATCH * 15, PROMPT, PROMPT)
NORM_SHAPE = (BATCH, PROMPT, 960)
SQRT_FRAC_OUTS = (0, 8, 16)
# four of the reference's quotient words of the rsqrt's out-of-lane
# numerator 2^31 at width 16, frac_out 16, coeff_bits 6: r -> div(2^31, r)
RSQRT_WORDS = {255: 3221225472, 256: 3221225472, 1: 0, 181: 2147483648}
# one sqrt lane, counted as ELEMWISE_OPS_PER_LANE is: LOD + log conversion
# 6, the halving shift 1, ls >> F 1, mantissa 1, shift amount I + frac_out
# - F 1, the shift (direction test, clip at 31, shift) 3, the zero select 1
SQRT_OPS_PER_LANE = 14
# phase 9 (d), use_in_norm served at full width, kernels vs plain versions:
# at the 16-bit divider every block norm's qm is clipped to the lane (the
# activations' mean square is far above 2^-16, R-4), so sqrt and divide
# give one constant in both versions and the norms are bit-equal; the
# logits then differ only as phase 4's do — attention outputs one bf16 ulp
# apart here and there, carried through 32 layers — and the final norm is
# exact. Phase 4's bound, ulp_logit_tol over TIED_LOGIT_RANGE, holds as
# it is.

# phase 14: zamba2-2.7b (src/repro_torch/configs/zamba2_2_7b.py) served
# whole: its shared attention block's shape (arch, q heads, kv heads,
# d_head, window), d_head 80 in both attention kernels
ZAMBA2 = "zamba2-2.7b"
HYBRID_ATTENTION = ((ZAMBA2, 32, 32, 80, 0),)
# its linears through dense(), (name, K, N): a Mamba2 layer's six (the
# in-projections z | x | B | C | dt and out_proj) and the shared block's
# six (q with its merged LoRA, k, v, o, the gelu MLP's two)
ZAMBA2_MAMBA_LINEARS = (("wz", 2560, 5120), ("wx", 2560, 5120),
                        ("wb", 2560, 64), ("wc", 2560, 64),
                        ("wdt", 2560, 80), ("out_proj", 5120, 2560))
ZAMBA2_SHARED_LINEARS = (("wq", 2560, 2560), ("wk", 2560, 2560),
                         ("wv", 2560, 2560), ("wo", 2560, 2560),
                         ("w1", 2560, 10240), ("w2", 10240, 2560))
# phase 3 holds logmatmul bit-equal at its linears' (K, N) at a step's 4
# rows and a prefill's 2,048
ZAMBA2_CHECK_ROWS = (4, 2048)
# (c) --emulate: 4 tokens; 6 x 54 Mamba2 linears + 6 x 6 shared-block
# linears = 360 logmatmul a prefill and a step
ZAMBA2_EMULATE_GEN = 4
# phase 15: training (launch/train.py) at smollm-360m's full width, batch 4
# x seq 512, --approx simdive --backward approx, remat on. A step runs each
# linear's forward and its re-run in the remat backward (7 a layer each),
# and both gradient products of the linears the loss reaches: not wq, wk
# and wv, upstream of the attention finalize's SIMDive divider, whose
# quotient carries no gradient (ROADMAP R-8), so autograd runs neither of
# their products: 4 x 2 a layer. The finalize's divider runs once a layer
# in the forward and once in the re-run
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_LR = 3e-4
TRAIN_STEPS, TRAIN_SAVE_EVERY, TRAIN_STOP_AFTER, TRAIN_RUNG_AT = 3, 2, 2, 2
TRAIN_LOGMATMUL_A_LAYER = 7 + 7 + 4 * 2
TRAIN_LOGMATMUL_A_STEP = 32 * TRAIN_LOGMATMUL_A_LAYER
TRAIN_ELEMWISE_A_STEP = 2 * 32
# the twin (train_twin): exact against --approx simdive (straight-through
# backward): 7 x 32 x 2 logmatmul and 64 elemwise a step, all the
# approximate twin's
TWIN_STEPS, TWIN_LR = 2, 1e-3
TWIN_LOGMATMUL_A_STEP = 7 * 32 * 2
# (b): one make_train_step step on the kernels against one on the plain
# versions, at full width but 2 of 32 layers and batch 2 x seq 128 (the
# plain versions' int64 emulation of a full-size step would take minutes)
STEP_CHECK_LAYERS, STEP_CHECK_BATCH, STEP_CHECK_SEQ = 2, 2, 128
# (a): logmatmul at the gradient products' shapes, held against its plain
# version on the first TRAIN_CHECK_ROWS rows (a full (2048, 960) x (960,
# 2560) product in int64 takes seconds), every registered block; the
# (name, K_in, N_out) of the linears whose products are held: gx is
# (2048, N_out) x (N_out, K_in), gw (K_in, 2048) x (2048, N_out)
TRAIN_CHECK_ROWS = 256
TRAIN_GRAD_LINEARS = (("wq", 960, 960), ("w2", 2560, 960))
# phase 16: the paper's two application studies at the reference's own
# size (benchmarks/table4_ann.py, benchmarks/fig34_imaging.py). Table 4:
# the 784-100-10 and 784-100-100-10 MLPs trained in float on 6,000 images
# for 600 steps, run in 8-bit fixed point on the 1,000 test images; its
# layers' (M, K, N) at the test set's 1,000 rows
TABLE4_HIDDEN = ((100,), (100, 100))
TABLE4_STEPS = 600
TABLE4_SHAPES = ((1000, 784, 100), (1000, 100, 100), (1000, 100, 10))
# the float MLP must learn: ten classes, chance is 10 %
TABLE4_FLOAT_FLOOR = 50.0
# the campaign's --ann fault (a stuck-1 at bit 20 of the width-8 mul
# table) and its 200-step classifier
ANN_FAULT = dict(site="table", bit=20, kind="stuck1", op="mul", width=8)
ANN_QUICK_STEPS = 200
# the tuner's greedy budget over the ANN profile, in accuracy points
ANN_BUDGET = 1.0
# Fig. 3/4: the blend's 256 x 256 lanes and the Gaussian's 252 x 252
IMAGING_HW = 256
# the wide (int64) logmatmul form timed against the int32 one at Table 4's
# first layer and at a served shape: smollm-360m's wq at the prefill
WIDE_SERVED_SHAPE = (2048, 960, 960)
# one elemwise mul lane (the blend's and the window's multiplies),
# counted as ELEMWISE_OPS_PER_LANE is: two LOD + log conversions 2 x 6,
# region index 5, zero tests 2, coefficient select 1, ternary add 1, clip
# at 0 1, ls >> F 1, mantissa 1, saturation test 1, the anti-log shift
# (direction test, shift amount, shift) 3, zero select 1
ELEMWISE_MUL_OPS_PER_LANE = 29

# smollm-360m's linears per layer: (name, K, N)
LINEARS = (("wq", 960, 960), ("wk", 960, 320), ("wv", 960, 320),
           ("wo", 960, 960), ("w1", 960, 2560), ("w3", 960, 2560),
           ("w2", 2560, 960))

# phase 10: the dense family's other configurations at full width
# (src/repro_torch/configs/qwen3_4b.py, stablelm_1_6b.py, qwen2_5_14b.py),
# served divider-only as phase 4 (a) serves smollm-360m. Their attention
# shapes: (arch, q heads, kv heads, d_head)
DENSE_ATTENTION = (("qwen3-4b", 32, 8, 128), ("stablelm-1.6b", 32, 32, 64),
                   ("qwen2.5-14b", 40, 8, 128))
# phase 11: the MoE family's attention shapes (src/repro_torch/configs/
# mixtral_8x7b.py, llama4_scout.py): (arch, q heads, kv heads, d_head,
# sliding window). Mixtral's window (4096) reaches the prefill kernel, and
# its 544-slot serving cache (min(max_seq, window) slots) makes every
# decode step ring_full
MOE_ATTENTION = (("mixtral-8x7b", 32, 8, 128, 4096),
                 ("llama4-scout-17b-a16e", 40, 8, 128, 0))
# phase 12: the modality-stub families' attention shapes (src/repro_torch/
# configs/qwen2_vl_2b.py, musicgen_medium.py), as MOE_ATTENTION: qwen2-vl's
# G 6 (its 8 (b, kv head) rows cap the decode cluster at 8), musicgen's 24
# kv heads at d_head 64
MODALITY_ATTENTION = (("qwen2-vl-2b", 12, 2, 128, 0),
                      ("musicgen-medium", 24, 24, 64, 0))
# every configuration phase 3 holds the attention kernels at, window last
ARCH_ATTENTION = (tuple((*a, 0) for a in DENSE_ATTENTION) + MOE_ATTENTION
                  + MODALITY_ATTENTION + HYBRID_ATTENTION)
# qwen3-4b's linears per layer: (name, K, N)
QWEN3_LINEARS = (("wq", 2560, 4096), ("wk", 2560, 1024),
                 ("wv", 2560, 1024), ("wo", 4096, 2560),
                 ("w1", 2560, 9728), ("w3", 2560, 9728),
                 ("w2", 9728, 2560))
# (b) qwen3-4b --emulate generates 4 tokens, not 32: its prefill is 36
# layers of ~10x smollm-360m's 16.8 ms of logmatmul a layer, ~6 s, and the
# check runs five prefills (the capture's warm run, two replays, the eager
# prefill and the eager lm.prefill the replay is held to)
QWEN3_EMULATE_GEN = 4
# its logmatmul bit-equality rows: a decode step's 4, and 64 rows standing
# for the prefill's 2,048 (the int64 plain version of a full prefill
# layer's seven linears takes ~46 s)
QWEN3_CHECK_ROWS = (4, 64)
# 8-bit magnitudes: a product is at most 255^2 = 65,025, so the int32 sum of
# the longest dot product, K = 10,240 (zamba2-2.7b's w2), stays under 2^31
INT32_SUM_BOUND = 255 * 255 * 10240
# the served configurations' depth (widths are never cut): cut to fit one
# card in float32 — qwen2.5-14b's 48 layers are 59 GB, mixtral-8x7b's 32 are
# 186 GB, llama4-scout's 48 ~431 GB — and, as the script grows, to keep
# it inside its time limit (their time goes to init, capture and serving,
# which scale with depth; phase 3 holds the kernels at their shapes
# whatever the depth; halved once more to make room for phase 18's
# options). A configuration not named here is served whole: qwen2-vl-2b
# keeps its 28 layers, where the vision stub's M-RoPE gate was measured
# with little margin (PERF.md).
SERVED_LAYERS = {"qwen3-4b": 3, "stablelm-1.6b": 2, "qwen2.5-14b": 2,
                 "mixtral-8x7b": 2, "llama4-scout-17b-a16e": 2,
                 "musicgen-medium": 4,
                 "rwkv6-1.6b": 2, "zamba2-2.7b": 9}
# the sqrt kernel (ROADMAP rule 2's check of row 8) at a working size:
# 16.8 M lanes, where it is no longer launch-bound
SQRT_WORK_LANES = 1 << 24
# phase 13: rwkv6-1.6b (src/repro_torch/configs/rwkv6_1_6b.py) served
# whole. Its linears per layer through dense(): the time mix's r / k / v /
# g / output and the channel mix's three, (name, K, N); all but wo take
# float32 activations, and phase 3 holds them at QWEN3_CHECK_ROWS rows
RWKV6 = "rwkv6-1.6b"
RWKV6_LINEARS = (("wr", 2048, 2048), ("wk", 2048, 2048),
                 ("wv", 2048, 2048), ("wg", 2048, 2048),
                 ("wo", 2048, 2048), ("cm_wk", 2048, 7168),
                 ("cm_wr", 2048, 2048), ("cm_wv", 7168, 2048))
# (c) --emulate: 4 tokens (a prefill is ~24 x 100 ms of logmatmul), the 8
# linears of each layer emulated, the head exact
RWKV6_EMULATE_GEN = 4
# (a) the chunked prefill against the decode step one token at a time over
# a prefix of one whole chunk (the config's ssm_chunk), and _wkv_chunk at
# full width (B 4, Tc 64, H 32, dk 64) against itself in float64
RWKV6_PREFIX = 64
# _wkv_chunk's float32 against float64: the same log / cumsum / exp and
# sums of 64 products; on the CPU the port and the reference, both float32,
# part by <= 1.5e-6 of the largest output (tests/test_torch_ssm.py,
# WKV_REL_TOL 1e-5); the same bound here
WKV_F64_REL_TOL = 1e-5
# the chunked prefill against the stepwise decode at float32 activations,
# relative to each leaf's largest value: only the recurrence's and the
# GEMMs' grouping of float32 sums differs; measured <= 1.9e-5 on the H100
# (24 layers), bound ~5x
CHUNK_VS_STEP_F32_REL_TOL = 1e-4

# LM.init allocates each leaf once: its peak is the parameters' bytes and
# at most one layer's leaf filled in place; a stack-then-copy init would
# be 2x
INIT_PEAK_RATIO = 1.1
# (c) llama4-scout --emulate: 4 tokens, and per layer the seven linears
# dense() serves (wq, wk, wv, wo and the shared expert's w1, w3, w2; the
# router and the routed experts are plain matmuls, as in the reference)
LLAMA4_EMULATE_GEN = 4
LLAMA4_EMULATED_LINEARS = 7
# MoE logits, kernels vs plain versions: routing is discontinuous, and the
# attention kernels' bf16 round-off (phase 4's one-ulp differences) can
# flip a top-k pick or a capacity slot, after which a row's logits differ
# by far more than round-off though both runs are right. So the eager
# kernel run and the plain run (fed the same tokens) record every
# _dispatch call's picks and kept slots, and (1) the share of routes — a
# (token, pick) entry: its expert and whether it was kept — that agree
# must reach ROUTE_AGREE_FLOOR at every layer; (2) every (b, step) logit
# row whose own token's routes agree at every layer is held to
# ulp_logit_tol over UNTIED_LOGIT_RANGE, and those rows must be at least
# ROUTE_CHECKED_FLOOR of all. A wrong attention kernel moves every
# router input far past its ties: (1) fails, or (2) on the rows it keeps.
# Measured on a correct kernel (PERF.md, phase 11): 96.5-99.3 % of mixtral's
# routes agree by layer, 97.7-99.5 % of llama4's; 1-3.6 % of a layer's
# tokens part there first (bf16 router logits a rounding apart), the rest
# are their later layers and the capacity slots they shift (random-init
# routing drops a quarter to over half of a prefill's entries, so every
# expert sits at its capacity); 89 % and 94 % of the rows are checked
ROUTE_AGREE_FLOOR = 0.95
ROUTE_CHECKED_FLOOR = 0.75
# phase 12 (a): qwen2-vl's vision-stub prompt, a 16 x 16 grid of merged
# patch embeddings at slots 0-255 of the 512 (Qwen2-VL's M-RoPE positions:
# image t 0, h row, w col; the text after it at 16 + j on all three)
VISION_GRID = 16
# (c) musicgen --emulate: 4 tokens, 6 logmatmul a layer (q, k, v, o and
# the gelu MLP's w1, w2; the codebook heads stay exact)
MUSICGEN_EMULATE_GEN = 4
MUSICGEN_EMULATED_LINEARS = 6


def ulp_logit_tol(what: str, ref_all, logit_range) -> tuple[float, float]:
    """(bound, largest |logit|) for served logits held to the plain run's
    ``ref_all``: LOGIT_ULPS bf16 ulps of its largest |logit|, which must
    lie in ``logit_range`` [lo, hi), where the bound is derived."""
    top = float(ref_all.abs().max())
    lo, hi = logit_range
    require(lo <= top < hi, f"{what}: largest |logit| of the plain run "
            f"{top:.3f} lies outside [{lo:g}, {hi:g}), where the bound is "
            "derived")
    tol = LOGIT_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)
    log(f"  {what}: largest |logit| of the plain run {top:.3f} (in "
        f"[{lo:g}, {hi:g})), bound {LOGIT_ULPS} bf16 ulps = {tol:g}")
    return tol, top


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(AssertionError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# --------------------------------------------------------------- helpers --
def int32_ops_per_s(dev) -> float:
    """SM count x 64 INT32 lanes x the maximum SM clock, read on the card."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0]
    return sms * 64 * float(out) * 1e6


def logmatmul_ops_ms(M: int, K: int, N: int, int_rate: float) -> float:
    """Least time of (M, K) @ (K, N)'s products and operand conversions:
    the busiest of LOGMATMUL_PIPES, each pipe's work over its rate
    (``int_rate`` / 64 SM clocks a second, times its lanes)."""
    products, operands = M * K * N, M * K + K * N
    clocks = int_rate / 64
    return max((products * LOGMATMUL_PRODUCT_WORK.get(p, 0)
                + operands * LOGMATMUL_OPERAND_WORK.get(p, 0))
               / (lanes * clocks)
               for p, lanes in LOGMATMUL_PIPES.items()) * 1e3


def logmatmul_ops_ms_superseded(M: int, K: int, N: int,
                                int_rate: float) -> float:
    """The bound :func:`logmatmul_ops_ms` supersedes
    (LOGMATMUL_SUPERSEDED_OPS): every operation over the INT32 lanes and
    the FMA pipe together (2 x ``int_rate``), or the INT32-only ones over
    ``int_rate``, the longer."""
    per_p, int_p, per_o, int_o = LOGMATMUL_SUPERSEDED_OPS
    products, operands = M * K * N, M * K + K * N
    return max((products * per_p + operands * per_o) / (2 * int_rate),
               (products * int_p + operands * int_o) / int_rate) * 1e3


def gpu_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call, CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def gpu_graph_time_ms(fn, iters: int) -> float:
    """Mean device time of one call with the host taken out: ``iters`` calls
    are captured into one CUDA graph and the replay is timed. At small
    shapes an eager loop times Python and the launch queue, not the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()                                   # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    """Best host time of one call of ``fn``, the card drained before each
    and no synchronise inside: what the host spends issuing the work."""
    import torch

    best = float("inf")
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = wall_clock()
        fn()
        best = min(best, wall_clock() - t0)
    torch.cuda.synchronize()
    return best * 1e3


def reserved_bytes() -> int:
    """Card memory the caching allocator holds once its unused blocks are
    released: live tensors, and the private pools of live CUDA graphs."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def device_time_by_kernel(fn):
    """Device time of one call of ``fn`` from a ``torch.profiler`` trace:
    ``(busy ms, {name: [count, ms]})`` over its kernels, copies and
    memsets (one stream: they do not overlap); None when the trace holds no
    device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            rec = by.setdefault(ev.name, [0, 0.0])
            rec[0] += 1
            rec[1] += ev.time_range.elapsed_us() / 1e3
    if not by:
        return None
    return sum(ms for _, ms in by.values()), by


def count_device_kernels(fn):
    """Kernels, copies and memsets the card ran for one call of ``fn``
    (:func:`device_time_by_kernel`); None when the trace holds no device
    event (tracing not available on this machine)."""
    prof = device_time_by_kernel(fn)
    return None if prof is None else sum(n for n, _ in prof[1].values())


def logmatmul_ptxas(text: str) -> list:
    """Registers and spill bytes of each logmatmul instantiation, the
    skinny tiles' and the large tiles', from ``nvcc -Xptxas -v`` output."""
    import re

    skinny = re.compile(r"Compiling entry function '\S*logmatmul_skinny_kernel"
                        r"ILi(\d+)ELi(\d+)ELi(\d+)ELb([01])ELb([01])E([jy])")
    large = re.compile(r"Compiling entry function '\S*logmatmul_large_kernel"
                       r"ILi(\d+)ELi(\d+)ELi(\d+)ELb([01])E([jy])")
    found, cur = [], None
    for line in text.splitlines():
        m = skinny.search(line)
        if m:
            w, mr, ku, pipe, vec = (int(g) for g in m.groups()[:5])
            # the accumulator: j = uint32 (the int32 form), y = uint64 (wide)
            cur = {"family": "skinny",
                   "tile": f"w{w} MR {mr} k_unroll {ku} "
                           f"{'ring' if pipe else 'depth 0'} "
                           f"{'16-byte' if vec else 'scalar'} loads"
                           f"{' wide' if m.group(6) == 'y' else ''}"}
            continue
        m = large.search(line)
        if m:
            w, bm, ku, pipe = (int(g) for g in m.groups()[:4])
            cur = {"family": "large",
                   "tile": f"w{w} {bm} x 128 k_unroll {ku} "
                           f"{'ring' if pipe else 'depth 0'}"
                           f"{' wide' if m.group(5) == 'y' else ''}"}
            continue
        if cur is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            cur["spill_bytes"] = int(spill.group(1)) + int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            cur["registers"] = int(used.group(1))
            found.append(cur)
            cur = None
    return found


def start_logmatmul_sass(build):
    """Start ``cuobjdump -sass`` on the built library in the background
    (its text lands in a temporary file; :func:`logmatmul_sass` reads it),
    where the toolkit has cuobjdump; None where it has not."""
    import atexit
    import os
    import shutil
    import tempfile

    exe = shutil.which("cuobjdump") or next(
        (str(p) for p in (Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
                          / "bin" / "cuobjdump",) if p.exists()), None)
    lib = next(build.build_dir().rglob("libsimdive_kernels.so"), None)
    if exe is None or lib is None:
        log("  SASS: cuobjdump or the library not found; not read")
        return None
    out = tempfile.NamedTemporaryFile(prefix="chip_smoke_sass_",
                                      suffix=".txt", delete=False)
    proc = subprocess.Popen([exe, "-sass", str(lib)], stdout=out,
                            stderr=subprocess.DEVNULL)
    path = Path(out.name)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        path.unlink(missing_ok=True)

    atexit.register(stop)
    return SimpleNamespace(proc=proc, path=path, file=out)


def logmatmul_sass(started) -> dict | None:
    """The large tile's product loops in SASS, from
    :func:`start_logmatmul_sass`'s dump: the int32 form's 64-row depth-0
    kernel (the untimed default from 64 rows), at width 8 its FLOAT
    form's loop (the one holding FMNMX) and at width 16 its GENERAL
    form's, each as opcode counts a product (a thread's register tile is
    BM / 8 x 4: the FLOAT loop holds k_unroll such tiles, the GENERAL loop
    one)."""
    import re

    if started is None:
        return None
    try:
        started.proc.wait(timeout=600)
    finally:
        started.file.close()
    funcs, cur = {}, None
    with started.path.open() as f:
        for line in f:
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = m.group(1) if ("logmatmul_large_cu" in m.group(1)
                                     and "Li64ELi2ELb0EjE" in m.group(1)) \
                    else None
                if cur:
                    funcs[cur] = []
                continue
            if cur:
                funcs[cur].append(line)
    started.path.unlink(missing_ok=True)
    out = {}
    for name, lines in funcs.items():
        width, bm, ku = (int(g) for g in re.search(
            r"large_kernelILi(\d+)ELi(\d+)ELi(\d+)E", name).groups())
        tile = bm // 8 * 4
        # a branch names its target by label (.L_x_N) or by address (0x..)
        targets, ins = {}, []
        for line in lines:
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if m:
                targets[m.group(1)] = len(ins)
                continue
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
            if m:
                targets[int(m.group(1), 16)] = len(ins)
                ins.append((m.group(2).split(".")[0], m.group(3)))
        loops = []
        for i, (op, args) in enumerate(ins):
            if op != "BRA":
                continue
            t = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", args)
            start = None if t is None else targets.get(
                t.group(1) or int(t.group(2), 16))
            if start is not None and start <= i:
                hist = {}
                for o, _ in ins[start:i + 1]:
                    hist[o] = hist.get(o, 0) + 1
                loops.append(hist)
        if width == 8:
            form, products = "w8 FLOAT", ku * tile
            found = [h for h in loops if h.get("FMNMX", 0) >= 2 * products]
        else:
            form, products = "w16 GENERAL", tile
            found = [h for h in loops if h.get("LDS", 0) >= products]
        if not found:
            log(f"  SASS {form}: no product loop found ({len(ins)} "
                f"instructions, {len(loops)} loops)")
            continue
        # the innermost such loop: the slab loop around it holds it all
        hist = min(found, key=lambda h: sum(h.values()))
        per = {o: n / products for o, n in sorted(hist.items(),
                                                  key=lambda t: -t[1])}
        out[form] = {"per_product": per,
                     "loop_instructions": sum(hist.values()),
                     "products": products}
        log(f"  SASS {form} product loop: {sum(hist.values())} "
            f"instructions for {products} products, a product: "
            + ", ".join(f"{o} {n:.3g}" for o, n in per.items() if n >= 0.05))
    return out


def close(got, want, *, atol, rtol):
    """(all within bound, max abs err, share outside bound), in float32."""
    import torch

    g, w = got.to(torch.float32), want.to(torch.float32)
    err = (g - w).abs()
    bad = err > (atol + rtol * w.abs())
    finite = bool(torch.isfinite(g).all())
    return (finite and not bool(bad.any()), float(err.max()),
            float(bad.float().mean()))


# ------------------------------------------------------- phase 3: kernels --
def check_elemwise(dev) -> float:
    import torch
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import get_op

    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0

    def run(name, a, b, spec, **kw):
        nonlocal worst
        got = get_op("elemwise", spec, "cuda")(a, b, **kw)
        want = get_op("elemwise", spec, "ref")(a, b, **kw)
        torch.cuda.synchronize()
        require(got.dtype == torch.uint32 and got.shape == a.shape,
                f"elemwise {name}: dtype/shape {got.dtype} {got.shape}")
        diff = (got.view(torch.int32).to(torch.int64)
                - want.view(torch.int32).to(torch.int64)).abs()
        worst = max(worst, int(diff.max()))
        require(int(diff.max()) == 0,
                f"elemwise {name}: {int((diff != 0).sum())} lanes differ")

    # exhaustive width-8 square, zeros included
    a8 = torch.arange(256, device=dev).repeat_interleave(256)
    b8 = torch.arange(256, device=dev).repeat(256)
    m8 = torch.randint(0, 2, a8.shape, generator=gen, device=dev)
    for cb in (0, 6):
        spec = SimdiveSpec(width=8, coeff_bits=cb)
        run(f"w8 cb{cb} mul", a8, b8, spec, op="mul")
        run(f"w8 cb{cb} div", a8, b8, spec, op="div", frac_out=8)
        run(f"w8 cb{cb} mixed", a8, b8, spec, op="mixed", mode=m8,
            frac_out=8)
    run("w8 mitchell (no rounding)", a8, b8,
        SimdiveSpec(width=8, coeff_bits=0, round_output=False), op="div",
        frac_out=8)
    run("w8 ib4 mixed", a8, b8, SimdiveSpec(width=8, coeff_bits=6,
                                            index_bits=4),
        op="mixed", mode=m8, frac_out=8)

    # width 16: > 1 M seeded pairs plus every zero / edge case
    n = (1 << 20) + 3
    a16 = torch.randint(0, 1 << 16, (n,), generator=gen, device=dev)
    b16 = torch.randint(0, 1 << 16, (n,), generator=gen, device=dev)
    edge = torch.tensor([0, 1, 2, 3, 0x7FFF, 0x8000, 0xFFFF], device=dev)
    a16 = torch.cat([a16, edge.repeat_interleave(len(edge))])
    b16 = torch.cat([b16, edge.repeat(len(edge))])
    m16 = torch.randint(0, 2, a16.shape, generator=gen, device=dev)
    s16 = SimdiveSpec(width=16, coeff_bits=8)
    run("w16 cb8 div fo15", a16, b16, s16, op="div", frac_out=15)
    run("w16 cb8 mul", a16, b16, s16, op="mul")
    run("w16 cb8 mixed", a16, b16, s16, op="mixed", mode=m16, frac_out=8)
    run("w16 cb6 div fo15 (serving config)", a16, b16,
        SimdiveSpec(width=16, coeff_bits=6), op="div", frac_out=15)

    # ragged, 1-D, unaligned views, uint32 operands, the decode shape
    run("ragged (37,53)", a16[:37 * 53].reshape(37, 53),
        b16[:37 * 53].reshape(37, 53), s16, op="div", frac_out=15)
    run("1-D (1001,)", a16[:1001], b16[:1001], s16, op="mul")
    a32 = a16.to(torch.int32).view(torch.uint32)
    b32 = b16.to(torch.int32).view(torch.uint32)
    run("unaligned uint32 views", a32[1:1000], b32[3:1002], s16, op="div",
        frac_out=15)
    run("one lane", a16[:1], b16[:1], s16, op="div", frac_out=15)
    au = a16[:3840].to(torch.int32).view(torch.uint32).reshape(4, 5, 3, 64)
    bu = b16[:3840].to(torch.int32).view(torch.uint32).reshape(4, 5, 3, 64)
    run("decode finalize shape (4,5,3,64) uint32", au, bu,
        SimdiveSpec(width=16, coeff_bits=6), op="div", frac_out=15)
    return float(worst)


def judge_attention(name, got, want, dtype, approx):
    """Hold an attention kernel's output to its plain version's: TOL_F32 /
    TOL_BF16, and with the SIMDive divide TOL_APPROX_EXTRA more, at most
    APPROX_OUTLIER_SHARE of the elements outside that and none outside
    TOL_APPROX_LOOSE. Returns (max abs err, share outside the bound)."""
    import torch

    tol = dict(TOL_F32 if dtype == torch.float32 else TOL_BF16)
    if approx:
        tol["atol"] += TOL_APPROX_EXTRA
        ok, err, share = close(got, want, **tol)
        loose_ok, _, _ = close(got, want, **TOL_APPROX_LOOSE)
        ok = loose_ok and share <= APPROX_OUTLIER_SHARE
    else:
        ok, err, share = close(got, want, **tol)
    require(ok, f"attention {name}: max_abs_err {err:.3e}, share outside "
                f"the bound {share:.3e} (tolerance {tol})")
    return err, share


def check_attention(dev):
    """Both schedules vs the plain version. Returns a dict: max abs err at
    the main path's shape and the worst over all cases, for the depth-0
    kernel and for the registered ring block (64, 64, 2), and under
    "archs" each configuration's prefill shape's row (ARCH_ATTENTION)."""
    import torch
    from repro_torch.core.error_lut import table_for
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    errs = {"main": 0.0, "all": 0.0, "pipe_main": 0.0, "pipe_all": 0.0,
            "ring_runs": 0, "archs": {}}
    judge = judge_attention

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    def run(name, BH, Sq, Skv, dh, dtype, *, kv_group=1, kv_len=None,
            spec=fa.DEFAULT_DIV_SPEC, main=False, arch=None, qk_gain=1.0,
            **kw):
        # qk_gain (a power of two: exact in bf16) scales q and k, so the
        # scores grow by its square
        q = randn(BH, Sq, dh, dtype=dtype) * qk_gain
        k = randn(BH // kv_group, Skv, dh, dtype=dtype) * qk_gain
        v = randn(BH // kv_group, Skv, dh, dtype=dtype)
        args = dict(spec=spec, kv_len=kv_len, kv_group=kv_group, **kw)
        got = fa.flash_attention_cuda(q, k, v, block=fa.DEFAULT_BLOCK, **args)
        want = fa.flash_attention_ref(q, k, v, **args)
        torch.cuda.synchronize()
        require(got.dtype == dtype and got.shape == q.shape,
                f"attention {name}: dtype/shape {got.dtype} {got.shape}")
        approx = kw.get("approx_div", False)
        err, share = judge(name, got, want, dtype, approx)
        errs["all"] = max(errs["all"], err)
        if main:
            errs["main"] = err
        if arch:
            errs["archs"][arch] = {
                "shape": f"q ({BH},{Sq},{dh}) kv ({BH // kv_group},{Skv},"
                         f"{dh}) G {kv_group} window {kw.get('window', 0)}",
                "max_abs_err": err, "outside_tight_share": share}
        # the ring at every depth the wrapper takes for this dtype / d_head:
        # bit-equal to depth 0, and so within the same tolerance
        depths = []
        for depth in range(1, fa._MAX_DEPTH + 1):
            block = (*fa.DEFAULT_BLOCK, depth)
            try:
                fa.check_block(block, dtype, dh)
            except ValueError:
                n0 = fa.flash_attention_pipelined_cuda.launches
                try:
                    fa.flash_attention_cuda(q, k, v, block=block, **args)
                except ValueError:
                    pass
                else:
                    raise SmokeFailure(f"attention {name}: ring depth "
                                       f"{depth} does not fit, yet launched")
                require(fa.flash_attention_pipelined_cuda.launches == n0,
                        "a refused block was counted as a launch")
                continue
            ring = fa.flash_attention_pipelined_cuda(q, k, v, block=block,
                                                     **args)
            torch.cuda.synchronize()
            nbad = int((ring != got).sum())
            require(torch.equal(ring, got),
                    f"attention {name}: ring depth {depth} differs from the "
                    f"depth-0 kernel on {nbad} of {got.numel()} outputs")
            perr, _ = judge(f"{name} ring depth {depth}", ring, want, dtype,
                            approx)
            if depth == 2:
                errs["pipe_all"] = max(errs["pipe_all"], perr)
                if main:
                    errs["pipe_main"] = perr
            errs["ring_runs"] += 1
            depths.append(depth)
        log(f"  attention {name}: max_abs_err {err:.3e} outside-tight share "
            f"{share:.2e}; ring depths {depths} bit-equal to depth 0")
        return err

    f32, bf16 = torch.float32, torch.bfloat16
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        for dh in (64, 80, 128):
            for approx in (False, True):
                t = f"{tag} dh{dh} {'simdive' if approx else 'exact'}"
                run(f"{t} causal", 6, 256, 256, dh, dtype, causal=True,
                    approx_div=approx)
                run(f"{t} window48", 4, 200, 200, dh, dtype, causal=True,
                    window=48, approx_div=approx)
                run(f"{t} non-causal ragged", 4, 100, 173, dh, dtype,
                    causal=False, approx_div=approx)
                run(f"{t} q_offset+kv_len", 4, 70, 300, dh, dtype,
                    causal=True, q_offset=150, kv_len=260,
                    approx_div=approx)
    # bf16 at the edges of the tensor-core fragments (m16n8k16: 16 q rows a
    # warp, 8 kv columns an n-tile): Sq and Skv not multiples of 16 or 8, a
    # single q row at a q_offset, and scores of large magnitude (q . k
    # ~ 64 after the scale, where it is ~ 1 above), whose running maximum
    # moves from tile to tile
    for dh in (64, 80, 128):
        for approx in (False, True):
            t = f"bf16 dh{dh} {'simdive' if approx else 'exact'}"
            run(f"{t} fragment edges Sq 37 Skv 45", 3, 37, 45, dh, bf16,
                causal=False, approx_div=approx)
            run(f"{t} fragment edges causal Sq 13 Skv 77 q_offset 64", 3,
                13, 77, dh, bf16, causal=True, q_offset=64,
                approx_div=approx)
            run(f"{t} single q row q_offset 140 Skv 141", 4, 1, 141, dh,
                bf16, causal=True, q_offset=140, approx_div=approx)
            run(f"{t} large scores (q, k x 8) Sq 150 Skv 150", 4, 150, 150,
                dh, bf16, causal=True, approx_div=approx, qk_gain=8.0)
    # an empty kv loop: every key masked by kv_len 0 (zero output)
    for dtype, tag, dh in ((f32, "f32", 64), (bf16, "bf16", 128)):
        for approx in (False, True):
            run(f"{tag} dh{dh} kv_len 0 (empty kv loop) "
                f"{'simdive' if approx else 'exact'}", 2, 70, 130, dh, dtype,
                causal=False, kv_len=0, approx_div=approx)
    # the shape the prefill hands the kernel: q (B*15, S, 64), kv (B*5, S, 64)
    run("bf16 dh64 GQA kv_group3, the main path's shape and serving config",
        BATCH * 15, PROMPT, PROMPT, 64, bf16, kv_group=3, causal=True,
        approx_div=True, frac_out=15,
        spec=SimdiveSpec(width=16, coeff_bits=6), main=True)
    # the scheduler's other rungs at the same shape: the shed rung's
    # Mitchell divider (coeff_bits 0, no rounding) and the recovery rung's
    # exact divide
    run("bf16 dh64 GQA kv_group3, the main path's shape, the shed rung's "
        "Mitchell divider", BATCH * 15, PROMPT, PROMPT, 64, bf16,
        kv_group=3, causal=True, approx_div=True, frac_out=15,
        spec=SimdiveSpec(**MITCHELL_DIV))
    run("bf16 dh64 GQA kv_group3, the main path's shape, the recovery "
        "rung's exact divide", BATCH * 15, PROMPT, PROMPT, 64, bf16,
        kv_group=3, causal=True, approx_div=False)
    # the dense, the MoE and the modality-stub families' prefill shapes
    # (phases 10-12): d_head 128 at G 4, 5 and 6, d_head 64 at G 1,
    # mixtral's window, the serving divider
    for arch, H, KV, dh, window in ARCH_ATTENTION:
        run(f"bf16 dh{dh} kv_group{H // KV} window {window}, {arch}'s "
            "prefill shape and serving config", BATCH * H, PROMPT, PROMPT,
            dh, bf16, kv_group=H // KV, causal=True, window=window,
            approx_div=True, frac_out=15,
            spec=SimdiveSpec(width=16, coeff_bits=6), arch=arch)
    # the hybrid family's shared block in f32 too (every ring depth fits
    # f32 at d_head 80)
    for arch, H, KV, dh, window in HYBRID_ATTENTION:
        run(f"f32 dh{dh} kv_group{H // KV}, {arch}'s prefill shape and "
            "serving divider", BATCH * H, PROMPT, PROMPT, dh, f32,
            kv_group=H // KV, causal=True, window=window, approx_div=True,
            frac_out=15, spec=SimdiveSpec(width=16, coeff_bits=6))
    run("f32 dh64 single decode-style row", 4, 1, 300, 64, f32, causal=True,
        q_offset=299, approx_div=True)
    run("f32 dh64 width-8 divider", 4, 128, 128, 64, f32, causal=True,
        approx_div=True, frac_out=8, spec=SimdiveSpec(width=8, coeff_bits=6))
    run("f32 dh64 mitchell divider ib4", 4, 128, 128, 64, f32, causal=True,
        approx_div=True, spec=SimdiveSpec(width=16, coeff_bits=0,
                                          index_bits=4, round_output=False))
    # both bf16 schedules load q / k / v 16 bytes at a time: a bf16 k view
    # 2 or 4 bytes past a 16-byte boundary is refused before any launch, at
    # depth 0 and in the ring
    flat = randn(4 * 128 * 64 + 2, dtype=bf16)
    q = randn(4, 128, 64, dtype=bf16)
    for off in (1, 2):
        k_off = flat[off:off + 4 * 128 * 64].view(4, 128, 64)
        require(k_off.is_contiguous() and k_off.data_ptr() % 16 == 2 * off,
                "the misaligned view is not what the check needs")
        for block in (fa.DEFAULT_BLOCK, ATTENTION_RING_BLOCK):
            n0 = (fa.flash_attention_cuda.launches
                  + fa.flash_attention_pipelined_cuda.launches)
            try:
                fa.flash_attention_cuda(q, k_off, k_off, block=block)
            except ValueError:
                pass
            else:
                raise SmokeFailure(f"a k {2 * off} bytes past a 16-byte "
                                   f"boundary was launched, block {block}")
            require(fa.flash_attention_cuda.launches
                    + fa.flash_attention_pipelined_cuda.launches == n0,
                    "a refused call was counted as a launch")
    log("  attention: a depth whose ring does not fit and a bf16 k off "
        "16-byte alignment (both schedules) are refused before any launch")

    # the finalize alone, on given (acc, l): bit-equal floats and integers
    rows, dh = BATCH * 15 * PROMPT, 64
    acc = torch.randn(rows, dh, generator=gen, device=dev) * 4.0
    l = torch.rand(rows, generator=gen, device=dev) * 300.0 + 1e-3
    acc[0] = 0.0                                    # zero numerators
    acc[1] *= 1e-20                                 # tiny row
    acc[2] *= 1e20                                  # huge row
    l[3] = 0.0                                      # clamps to 1e-30
    acc[4, 0], l[4] = 2.0, 2.0                      # exact powers of two
    acc[5, 0], l[5] = 1.9999999, 0.5
    for spec, fo in ((fa.DEFAULT_DIV_SPEC, 15),
                     (SimdiveSpec(width=16, coeff_bits=6), 15),
                     (SimdiveSpec(width=8, coeff_bits=6), 8)):
        out, quot = fa.softmax_div_cuda(acc, l, spec=spec, frac_out=fo)
        tab = table_for("div", spec.width, spec.coeff_bits, spec.index_bits,
                        device=dev)
        kw = dict(width=spec.width, index_bits=spec.index_bits, frac_out=fo,
                  round_out=spec.round_output)
        want_q = fa.softmax_div_lanes(acc, l, tab, **kw)
        want = fa.softmax_div(acc, l, tab, **kw)
        torch.cuda.synchronize()
        got_q = quot.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        nq = int((got_q != want_q).sum())
        nf = int((out != want).sum())
        log(f"  finalize w{spec.width} cb{spec.coeff_bits} fo{fo}: "
            f"{nq} integer / {nf} float mismatches over {rows * dh} lanes")
        require(nq == 0, f"finalize integers differ on {nq} lanes")
        require(nf == 0, f"finalize floats differ on {nf} lanes")
    log(f"  attention ring: {errs['ring_runs']} (case, depth) runs bit-equal "
        "to the depth-0 kernel")
    return errs


def graph_output(fn):
    """What ``fn()`` returns when it is captured into a CUDA graph and the
    graph is replayed once (call ``fn`` eagerly first: the capture must
    not be its first call)."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out.clone()


def check_decode_attention(dev):
    """The decode-step kernel vs its plain version (``decode_attention_ref``)
    on the same inputs, at the attention tolerances, every case at the
    planner's cluster size (``cluster=None``) and pinned at every legal
    size 1..8: each size within the tolerances, two calls bit-identical and
    a CUDA-graph replay bit-equal to the eager call, and the planner's
    launch equal to the one pinned at its size. Every case but the main
    path's and the served configurations' shapes has >= 10,240 outputs a
    draw; the main path's shape (3,840 outputs) is judged over three draws
    pooled and the other configurations' (8,192 to 20,480) over two, so
    that one SIMDive
    outlier stays under APPROX_OUTLIER_SHARE, as the constant means it.
    Returns {"main": max abs err at the main path's shape at the planner's
    size, "all": the worst over every case and size, "runs": kernel calls
    checked, "clusters": the planner's size at the main path's shape,
    "archs": each configuration's step shape's row (ARCH_ATTENTION)}."""
    import torch
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    serving = SimdiveSpec(width=16, coeff_bits=6)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    sizes = (None, *range(1, da.MAX_CLUSTER + 1))   # None: the planner's
    errs = {"main": 0.0, "all": 0.0, "runs": 0, "archs": {}}

    def randn(*shape, dtype, gain=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * gain
                ).to(dtype)

    def run(name, B, Smax, KVH, G, dh, dtype, pos, *, ring_full=False,
            window=0, approx=False, draws=1, main=False, arch=None,
            qk_gain=1.0, spec=serving):
        if isinstance(pos, list):
            pos = torch.tensor(pos, device=dev)
        slot = pos % Smax if ring_full else pos
        kw = dict(pos=pos, slot=slot, spec=spec, ring_full=ring_full,
                  window=window, approx_div=approx, frac_out=15)
        planned = da.cluster_size(B, KVH, sm_count)
        gots, wants = {c: [] for c in sizes}, []
        for _ in range(draws):
            q = randn(B, KVH, G, dh, dtype=dtype, gain=qk_gain)
            kc = randn(B, Smax, KVH, dh, dtype=dtype, gain=qk_gain)
            vc = randn(B, Smax, KVH, dh, dtype=dtype)
            kn = randn(B, 1, KVH, dh, dtype=dtype, gain=qk_gain)
            vn = randn(B, 1, KVH, dh, dtype=dtype)
            wants.append(da.decode_attention_ref(q, kc, vc, kn, vn, **kw
                                                 ).flatten())
            for c in sizes:
                call = (lambda c=c: da.decode_attention_cuda(
                    q, kc, vc, kn, vn, cluster=c, **kw))
                got, again = call(), call()
                replay = graph_output(call)
                require(got.dtype == dtype and got.shape == q.shape,
                        f"decode attention {name} cluster {c}: dtype/shape "
                        f"{got.dtype} {tuple(got.shape)}")
                require(torch.equal(got, again),
                        f"decode attention {name} cluster {c}: two calls "
                        f"differ on {int((got != again).sum())} outputs")
                require(torch.equal(got, replay),
                        f"decode attention {name} cluster {c}: the graph "
                        f"replay differs from the eager call on "
                        f"{int((got != replay).sum())} outputs")
                gots[c].append(got.flatten())
                errs["runs"] += 1
            require(torch.equal(gots[None][-1], gots[planned][-1]),
                    f"decode attention {name}: the planner's launch differs "
                    f"from cluster {planned}'s")
        want = torch.cat(wants)
        worst = 0.0
        for c in sizes:
            err, share = judge_attention(f"decode {name} cluster {c}",
                                         torch.cat(gots[c]), want, dtype,
                                         approx)
            worst = max(worst, err)
            if c is None:
                planner_err = err
        if main:
            errs["main"] = planner_err
        if arch:
            errs["archs"][arch] = {
                "shape": f"q ({B},{KVH},{G},{dh}) caches ({B},{Smax},{KVH},"
                         f"{dh}) pos {pos} ring_full {ring_full}",
                "cluster": planned,
                "max_abs_err": planner_err, "max_abs_err_all_sizes": worst}
        errs["all"] = max(errs["all"], worst)
        log(f"  decode attention {name}: planner's cluster {planned} (its "
            f"launch equal to cluster {planned}'s); max_abs_err over sizes "
            f"None, 1..{da.MAX_CLUSTER} {worst:.3e}; deterministic, graph "
            "replay bit-equal")

    f32, bf16 = torch.float32, torch.bfloat16
    spread = [0, 1, 9, 31, 32, 50, 62, 63]           # 0 and Smax - 1
    ring = [5, 63, 64, 65, 127, 200, 10, 64]         # before and after wrap
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        for dh in (64, 80, 128):
            for approx in (False, True):
                t = f"{tag} dh{dh} {'simdive' if approx else 'exact'}"
                base = (8, 64, 8, 3, dh, dtype)
                run(f"{t} pos 0 (empty history)", *base, 0, approx=approx)
                run(f"{t} pos Smax-1", *base, 63, approx=approx)
                run(f"{t} per-row pos {spread}", *base, spread,
                    approx=approx)
                run(f"{t} ring per-row pos {ring}", *base, ring,
                    ring_full=True, approx=approx)
                run(f"{t} ring scalar pos 30 (not wrapped)", *base, 30,
                    ring_full=True, approx=approx)
                run(f"{t} ring scalar pos 100 (wrapped)", *base, 100,
                    ring_full=True, approx=approx)
                # [35, 50), [17, 32), ...: a window across ranks
                run(f"{t} window 16 per-row pos {spread}", *base, spread,
                    window=16, approx=approx)
    for approx in (False, True):
        t = "simdive" if approx else "exact"
        run(f"bf16 dh64 G1 {t}", 8, 64, 20, 1, 64, bf16, spread,
            approx=approx)
        run(f"bf16 dh64 G8 {t}", 8, 64, 3, 8, 64, bf16, spread,
            approx=approx)
        run(f"f32 dh128 G8 {t}", 8, 64, 3, 8, 128, f32, 40, approx=approx)
        # fewer valid slots than ranks: empty shares at C > hi - lo
        run(f"bf16 dh64 fewer slots than ranks {t}", 8, 64, 8, 3, 64, bf16,
            [1, 2, 3, 4, 5, 6, 7, 0], approx=approx)
        # the wrapped ring's masked slot on a rank's first slot, 64 * r // C:
        # 8 (C 8), 21 (C 3), 12 (C 5), 9 (C 7), 10 (C 6), 32 (C 2), 0 (any
        # C), 16 (C 4)
        run(f"bf16 dh64 ring, masked slot on rank boundaries {t}", 8, 64, 8,
            3, 64, bf16, [64 + s for s in (8, 21, 12, 9, 10, 32, 0, 16)],
            ring_full=True, approx=approx)
    # more history than one round (C x 8192 // G slots: 1,024 a block at G
    # 8): three rounds at C 1, two at C 2, one from C 3
    chunks = [0, 1023, 1024, 1025, 2047, 2599, 1500, 2100]
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        run(f"{tag} dh64 G8 rounds per-row pos {chunks}", 8, 2600, 3,
            8, 64, dtype, chunks, approx=True)
    run("bf16 dh64 large scores (q, k x 4) per-row", 8, 64, 8, 3, 64, bf16,
        spread, approx=True, qk_gain=4.0)
    # B x KVH >= the SM count: the planner takes one block a row
    wide = 32 * 5
    require(wide >= sm_count and da.cluster_size(32, 5, sm_count) == 1,
            f"{wide} rows do not make the planner take C = 1 on "
            f"{sm_count} SMs")
    run(f"bf16 dh64 B 32 x KVH 5 = {wide} rows (planner's C 1) simdive", 32,
        PROMPT + GEN, 5, 3, 64, bf16,
        [PROMPT + 15 - i for i in range(32)], approx=True)
    # the main path's shape: batch 4, cache PROMPT + GEN, 5 kv heads x 3,
    # bf16, the serving divider, a mid-generation position
    run(f"main path's shape (4, {PROMPT + GEN}, 5, 3, 64) bf16 simdive "
        f"pos {PROMPT + 15}, three draws", BATCH, PROMPT + GEN, 5, 3, 64,
        bf16, PROMPT + 15, approx=True, draws=3, main=True)
    errs["clusters"] = da.cluster_size(BATCH, 5, sm_count)
    # the dense, the MoE and the modality-stub families' decode steps
    # (phases 10-12): G 4 / 1 / 5 / 6 at d_head 128 / 64 / 128 / 128, two
    # draws pooled; mixtral's serving
    # cache is its ring (544 slots under a 4096 window: ring_full, no
    # window mask), held also past the wrap at per-row positions
    for arch, H, KV, dh, window in ARCH_ATTENTION:
        ring = bool(window) and PROMPT + GEN <= window
        run(f"{arch}'s step shape ({BATCH}, {PROMPT + GEN}, {KV}, {H // KV}, "
            f"{dh}) bf16 simdive pos {PROMPT + 15} ring_full {ring}, two "
            "draws", BATCH, PROMPT + GEN, KV, H // KV, dh, bf16, PROMPT + 15,
            ring_full=ring, approx=True, draws=2, arch=arch)
        if ring:
            wrap = [PROMPT + GEN, PROMPT + GEN - 1, 2 * (PROMPT + GEN) - 1,
                    PROMPT + GEN + 100]
            run(f"{arch}'s step shape, ring_full, per-row pos {wrap} (past "
                "the wrap)", BATCH, PROMPT + GEN, KV, H // KV, dh, bf16, wrap,
                ring_full=True, approx=True)
    # the hybrid family's step without the divider and over a 2,048-slot
    # cache, both at d_head 80
    for arch, H, KV, dh, _ in HYBRID_ATTENTION:
        run(f"{arch}'s step shape ({BATCH}, {PROMPT + GEN}, {KV}, "
            f"{H // KV}, {dh}) bf16 exact divide pos {PROMPT + 15}, two "
            "draws", BATCH, PROMPT + GEN, KV, H // KV, dh, bf16, PROMPT + 15,
            approx=False, draws=2)
        run(f"{arch}'s step over 2048 slots, bf16 simdive pos 2047",
            BATCH, 2048, KV, H // KV, dh, bf16, 2047, approx=True)
    # the scheduler drill's shape: per-row positions with idle rows at 0,
    # at the shed rung's Mitchell divider and the recovery rung's exact
    # divide
    drill_pos = [PROMPT + 15, 0, PROMPT + GEN - 1, PROMPT]
    run(f"main path's shape, per-row pos {drill_pos}, the shed rung's "
        "Mitchell divider, three draws", BATCH, PROMPT + GEN, 5, 3, 64,
        bf16, drill_pos, approx=True, draws=3,
        spec=SimdiveSpec(**MITCHELL_DIV))
    run(f"main path's shape, per-row pos {drill_pos}, the recovery rung's "
        "exact divide", BATCH, PROMPT + GEN, 5, 3, 64, bf16, drill_pos,
        approx=False)

    # refused before any launch: 9 q heads a kv head, a position tensor
    # left on the CPU, and clusters of 0, 9 and 2.5 blocks
    q = randn(2, 2, 9, 64, dtype=bf16)
    kc = randn(2, 16, 2, 64, dtype=bf16)
    kn = randn(2, 1, 2, 64, dtype=bf16)
    n0 = da.decode_attention_cuda.launches
    for what, args, pos, cluster in (
            ("G 9", (q, kc, kc, kn, kn), 3, None),
            ("a CPU pos tensor", (q[:, :, :3], kc, kc, kn, kn),
             torch.tensor([3, 4]), None),
            ("cluster 0", (q[:, :, :3], kc, kc, kn, kn), 3, 0),
            ("cluster 9", (q[:, :, :3], kc, kc, kn, kn), 3, 9),
            ("cluster 2.5", (q[:, :, :3], kc, kc, kn, kn), 3, 2.5)):
        try:
            da.decode_attention_cuda(*args, pos=pos, slot=pos,
                                     cluster=cluster)
        except (ValueError, TypeError):
            pass
        else:
            raise SmokeFailure(f"decode attention: {what} was launched")
    require(da.decode_attention_cuda.launches == n0,
            "a refused decode attention call was counted as a launch")
    # one wave: every (b, kv head) cluster of the main path's shape
    # resident at once, at the planner's size
    resident = {c: da.max_active_clusters(PROMPT + GEN, 3, 64, bf16, c)
                for c in range(1, da.MAX_CLUSTER + 1)}
    log(f"  decode attention: clusters the card holds at once at the main "
        f"path's shape, by size: {resident} (cudaOccupancyMaxActiveClusters)")
    require(resident[errs["clusters"]] >= BATCH * 5,
            f"{BATCH * 5} clusters of {errs['clusters']} do not fit in one "
            f"wave ({resident[errs['clusters']]})")
    errs["resident_clusters"] = resident
    # ... and the other configurations', at each one's planner's size
    for arch, H, KV, dh, _ in ARCH_ATTENTION:
        row = errs["archs"][arch]
        row["resident_clusters"] = da.max_active_clusters(
            PROMPT + GEN, H // KV, dh, bf16, row["cluster"])
        require(row["resident_clusters"] >= BATCH * KV,
                f"decode attention {arch}: {BATCH * KV} clusters of "
                f"{row['cluster']} do not fit in one wave "
                f"({row['resident_clusters']})")
        log(f"  decode attention, {arch}'s step: {row['resident_clusters']} "
            f"clusters of {row['cluster']} resident at once")
    log(f"  decode attention: {errs['runs']} kernel calls within the "
        "tolerances, each deterministic and equal to its graph replay; G 9, "
        "a CPU pos tensor and clusters 0 / 9 / 2.5 refused before any "
        "launch")
    return errs


def check_logmatmul(dev):
    """Every registered block vs ``logmatmul_ref``, bit for bit; at the
    main path's shapes and the edges also every ring depth of each tile
    (skinny and large) against its depth 0; at the edge cases also the
    wide (int64) form of every block and ring depth against
    ``logmatmul_wide_ref``.
    Returns (worst abs difference, {(M, K, N): plain-version ms},
    {arch: bit-equal (shape, block) runs} at qwen3-4b's seven linears and
    rwkv6-1.6b's eight)."""
    import torch
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import get_op
    from repro_torch.kernels import logmatmul as lm

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    blocks = get_op("matmul_int", SimdiveSpec()).entry.block_candidates
    # each tile's registered depth-0 block, to be held against its ring at
    # every depth the kernel takes
    depth0 = [b for b in blocks if b[4] == 0]
    require({lm.is_skinny(b) for b in depth0} == {True, False},
            "no skinny or no large depth-0 block is registered")
    plain_ms = {}
    worst = 0
    ring_runs = 0

    def ints(shape, hi):
        return torch.randint(-hi + 1, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def run(name, x, w, spec, timed=False, depths=False, wide=False):
        nonlocal worst, ring_runs
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = lm.logmatmul_ref(x, w, spec)
        end.record()
        end.synchronize()
        if timed:
            plain_ms[(x.shape[0], x.shape[1], w.shape[1])] = \
                start.elapsed_time(end)
        got_by = {}
        for block in blocks:
            got = got_by[block] = lm.logmatmul_cuda(x, w, spec, block)
            torch.cuda.synchronize()
            require(got.dtype == torch.int32 and got.shape == want.shape,
                    f"logmatmul {name} block {block}: dtype/shape "
                    f"{got.dtype} {tuple(got.shape)}")
            diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
            worst = max(worst, int(diff.max()))
            nbad = int((diff != 0).sum())
            require(nbad == 0,
                    f"logmatmul {name} block {block}: {nbad} of "
                    f"{want.numel()} outputs differ from the plain version")
        if depths:
            for b0 in depth0:
                for depth in range(1, lm._MAX_DEPTH + 1):
                    ring = (*b0[:4], depth)
                    got = lm.logmatmul_cuda(x, w, spec, ring)
                    torch.cuda.synchronize()
                    require(torch.equal(got, got_by[b0]),
                            f"logmatmul {name}: ring {ring} differs "
                            f"from its depth 0 {b0}")
                    ring_runs += 1
        if wide:
            want = lm.logmatmul_wide_ref(x, w, spec)
            rings = [(*b0[:4], d) for b0 in depth0
                     for d in range(1, lm._MAX_DEPTH + 1)] if depths else []
            for block in (*blocks, *rings):
                got = lm.logmatmul_cuda(x, w, spec, block, wide=True)
                torch.cuda.synchronize()
                require(got.dtype == torch.int64 and torch.equal(got, want),
                        f"logmatmul {name} block {block}, wide form: "
                        f"{int((got != want).sum())} of {want.numel()} "
                        "outputs differ from logmatmul_wide_ref")
        log(f"  logmatmul {name}: bit-equal for all {len(blocks)} "
            "registered blocks"
            + (f"; skinny and large rings at depths 1..{lm._MAX_DEPTH} "
               "equal to depth 0" if depths else "")
            + ("; the wide form of each equal to logmatmul_wide_ref"
               if wide else ""))

    serving = SimdiveSpec(width=8, coeff_bits=6)
    for M in (2048, 4):
        for K, N in sorted({(k, n) for _, k, n in LINEARS}):
            x, w = ints((M, K), 256), ints((K, N), 256)
            run(f"({M},{K})@({K},{N}) w8 cb6", x, w, serving, timed=True,
                depths=True)
    # the training step's weight-gradient products (phase 15; its input
    # gradients run the shapes above) and Table 4's first layer (phase 16),
    # every row
    for name, k_in, n_out in TRAIN_GRAD_LINEARS:
        M = TRAIN_BATCH * TRAIN_SEQ
        run(f"{name} gw ({k_in},{M})@({M},{n_out})", ints((k_in, M), 256),
            ints((M, n_out), 256), serving)
    run("Table 4 (1000,784)@(784,100)", ints((1000, 784), 256),
        ints((784, 100), 256), serving, depths=True, wide=True)
    # the large tile's edges: rows around its 64 and 128 and the prefill's
    # 2,048; K off the 32-k slab and around the float partial sums' flush
    # (every slab); N odd and under the 128 columns; every operand +-255
    # (saturating products at both signs) and INT32_MIN
    for M, K, N in ((63, 100, 130), (65, 33, 7), (2047, 96, 131),
                    (129, 65, 128), (127, 513, 255)):
        x, w = ints((M, K), 256), ints((K, N), 256)
        x[0, :] = 255
        x[1, :] = -255
        w[:, 0] = 255
        w[:, -1] = -(1 << 31)
        x[-1, ::2] = -(1 << 31)
        run(f"large edge ({M},{K})@({K},{N}), +-255, INT32_MIN", x, w,
            serving, depths=True, wide=True)
    for K in (31, 32, 64, 65, 257):
        sat = torch.full((65, K), 255, dtype=torch.int32, device=dev)
        sat[1::2] = -255
        run(f"flush (65,{K})@({K},130), every product saturated",
            sat, torch.full((K, 130), 255, dtype=torch.int32, device=dev),
            serving, depths=True, wide=True)
    # qwen3-4b's seven linears (phase 10) and rwkv6-1.6b's eight (phase
    # 13): a decode step's 4 rows, and 64 standing for the prefill's 2,048
    # (the int64 plain version of a full prefill layer's seven linears
    # takes ~46 s); zamba2-2.7b's seven (K, N) (phase 14) at 4 and the
    # prefill's own 2,048 rows. 8-bit magnitudes: the int32 sum of the
    # longest dot product, K = 10,240 (zamba2-2.7b's w2), stays under 2^31
    zamba2 = ZAMBA2_MAMBA_LINEARS + ZAMBA2_SHARED_LINEARS
    require(max(k for _, k, _ in QWEN3_LINEARS + RWKV6_LINEARS + zamba2)
            * 255 * 255 == INT32_SUM_BOUND < 2 ** 31,
            "int32 headroom at the configs' K")
    arch_runs = {}
    for arch, linears, rows in (("qwen3-4b", QWEN3_LINEARS, QWEN3_CHECK_ROWS),
                                (RWKV6, RWKV6_LINEARS, QWEN3_CHECK_ROWS),
                                (ZAMBA2, zamba2, ZAMBA2_CHECK_ROWS)):
        arch_runs[arch] = 0
        for M in rows:
            for K, N in sorted({(k, n) for _, k, n in linears}):
                run(f"{arch} ({M},{K})@({K},{N}) w8 cb6", ints((M, K), 256),
                    ints((K, N), 256), serving, depths=M == 4)
                arch_runs[arch] += len(blocks)
    log(f"  logmatmul at qwen3-4b's seven linears, rwkv6-1.6b's eight and "
        f"zamba2-2.7b's seven (K, N): int32 sums bounded by 255^2 x 10,240 "
        f"= {INT32_SUM_BOUND:,} < 2^31")
    # decode edges: rows around the skinny tiles' 4 and 8; N = 388 takes
    # the 16-byte weight loads, N = 131 the scalar ones; K = 777 and 1001
    # are multiples of no split; zeros and INT32_MIN in both operands
    for M in (1, 3, 4, 5, 8, 9):
        for K, N in ((777, 388), (1001, 131)):
            x, w = ints((M, K), 256), ints((K, N), 256)
            x[0, :7] = 0
            w[:, 2] = 0
            x[-1, 9] = -(1 << 31)
            w[5, :3] = -(1 << 31)
            run(f"decode edge ({M},{K})@({K},{N}), zeros, INT32_MIN", x, w,
                serving, depths=True, wide=True)
    # 47,360 bytes of dynamic shared memory for the 8-row tile: with the
    # static table over the 48 KB a launch gets without opting in
    run("decode edge (9,2560)@(2560,960)", ints((9, 2560), 256),
        ints((2560, 960), 256), serving, depths=True, wide=True)
    # operands 4 bytes off a 16-byte boundary (contiguous views into a
    # larger buffer): both tiles must take their scalar loads
    for M, K, N in ((4, 960, 960), (5, 960, 388), (130, 960, 388)):
        xb = torch.empty(M * K + 1, dtype=torch.int32, device=dev)
        wb = torch.empty(K * N + 1, dtype=torch.int32, device=dev)
        x, w = xb[1:].view(M, K), wb[1:].view(K, N)
        x.copy_(ints((M, K), 256))
        w.copy_(ints((K, N), 256))
        require(w.data_ptr() % 16 == 4 and w.is_contiguous(),
                "the offset view is not 4 bytes off a 16-byte boundary")
        run(f"4-byte-offset views ({M},{K})@({K},{N})", x, w, serving,
            depths=True, wide=True)
    x, w = ints((37, 50), 256), ints((50, 17), 256)
    x[0] = 0
    w[:, 3] = 0
    x[1, :5] = -(1 << 31)                       # INT32_MIN clamps to 255
    w[2, :4] = (1 << 31) - 1
    run("ragged (37,50)@(50,17), zeros, INT32_MIN", x, w, serving,
        wide=True)
    run("ragged (100,130)@(130,70) mitchell", ints((100, 130), 256),
        ints((130, 70), 256),
        SimdiveSpec(width=8, coeff_bits=0, round_output=False), wide=True)
    for M in (64, 4):
        x, w = ints((M, 960), 1 << 16), ints((960, 96), 1 << 16)
        x[:, :200], w[:200] = 65535, 65535      # sums past 2^31: they wrap
        run(f"w16 cb8 ib4 ({M},960)@(960,96), wrapping sums", x, w,
            SimdiveSpec(width=16, coeff_bits=8, index_bits=4),
            depths=M == 4, wide=True)

    # matmul_emul: the kernel path vs the int64 plain version (width 8 at
    # K <= 2560 cannot overflow int32: 2560 * 255^2 < 2^31; width 16 takes
    # the wide form, whose sums pass 2^31)
    for M, K, N, width in ((4, 2560, 960, 8), (64, 960, 320, 8),
                           (4, 2560, 960, 16), (64, 960, 320, 16)):
        serving = SimdiveSpec(width=width, coeff_bits=6)
        hi = 1 << width
        qx = torch.randint(0, hi, (M, K), generator=gen, device=dev)
        qw = torch.randint(0, hi, (K, N), generator=gen, device=dev)
        sx = torch.randint(0, 2, (M, K), generator=gen, device=dev) * 2 - 1
        sw = torch.randint(0, 2, (K, N), generator=gen, device=dev) * 2 - 1
        args = (qx.to(torch.int32), sx.to(torch.int32),
                qw.to(torch.int32), sw.to(torch.int32))
        got = get_op("matmul_emul", serving, "cuda")(*args, k_chunk=128)
        want = get_op("matmul_emul", serving, "ref")(*args, k_chunk=128)
        torch.cuda.synchronize()
        worst = max(worst, int((got - want).abs().max()))
        require(got.dtype == torch.int64 and torch.equal(got, want),
                f"matmul_emul ({M},{K})@({K},{N}) w{width}: kernel path "
                "differs from the int64 plain version")
        require(width == 8 or float(want.abs().max()) >= 2 ** 31,
                f"matmul_emul ({M},{K})@({K},{N}) w16: no sum past 2^31")
    log("  matmul_emul: kernel path bit-equal to the int64 plain version "
        "at widths 8 and 16 (the wide form, sums past 2^31)")
    log(f"  logmatmul rings: {ring_runs} (case, tile, depth) runs equal to "
        "their depth 0")
    return float(worst), plain_ms, arch_runs


def _packed_hi_mode(gen, dev, shape, width):
    """Packed mode words whose nonzero lanes are nonzero only in their high
    bit (0x80 / 0x8000): a kernel that tested bit 0 would divide there."""
    import torch
    from repro_torch.core.simd_pack import pack

    lpw = 32 // width
    sel = torch.randint(0, 2, (*shape, lpw), generator=gen, device=dev)
    return pack((sel << (width - 1)).reshape(*shape[:-1], -1), width)


def _packed_err(got, want, width) -> tuple[int, int]:
    """(uint32 words that differ, largest |kernel lane - plain lane|) of two
    packed outputs; their lanes are 2 * width bits (16 two to a word at
    width 8, one 32-bit lane a word at width 16)."""
    import torch
    from repro_torch.core.mitchell import from_lanes
    from repro_torch.core.simd_pack import unpack

    require(got.dtype == torch.uint32 and got.shape == want.shape,
            f"packed: dtype/shape {got.dtype} {tuple(got.shape)}, expected "
            f"uint32 {tuple(want.shape)}")
    nbad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    if width == 8:
        got, want = unpack(got, 16), unpack(want, 16)
    diff = (from_lanes(got) - from_lanes(want)).abs()
    return nbad, int(diff.max()) if diff.numel() else 0


def check_packed(dev) -> tuple[int, int]:
    """The packed kernel vs ``packed_ref``, ``torch.equal`` for every
    registered block. Returns the number of (case, block) runs and the
    largest |kernel lane - plain lane| found (0 when all are equal)."""
    import torch
    from repro_torch.core.mitchell import from_lanes
    from repro_torch.core.simd_pack import pack, unpack
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import get_op
    from repro_torch.kernels import elemwise as ew
    from repro_torch.kernels import packed_simd as ps
    from repro_torch.metrics import (PACKED_DIV_FRAC_OUT, grid8,
                                     sample_uints, stratified_pairs)

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    entry = get_op("packed", SimdiveSpec()).entry
    blocks = entry.block_candidates or (entry.default_block,)
    runs, worst = 0, 0

    def run(name, aw, bw, spec, **kw):
        nonlocal runs, worst
        want = ps.packed_ref(aw, bw, spec, **kw)
        for block in blocks:
            got = ps.packed_cuda(aw, bw, spec, block=block, **kw)
            torch.cuda.synchronize()
            nbad, err = _packed_err(got, want, spec.width)
            worst = max(worst, err)
            require(nbad == 0, f"packed {name} block {block}: {nbad} of "
                               f"{want.numel()} words differ from packed_ref "
                               f"(largest lane error {err})")
            runs += 1

    def words(lanes, width):
        return pack(lanes.to(dev), width)

    # every 8-bit pair, zeros included, as (64, 256) words, rotated so each
    # pair sits at every lane position across the four shifts
    A, B = (torch.from_numpy(x) for x in grid8(include_zero=True))
    s8 = SimdiveSpec(width=8, coeff_bits=6)
    for shift in range(4):
        aw = words(A.roll(shift).reshape(64, -1), 8)
        bw = words(B.roll(shift).reshape(64, -1), 8)
        mw = _packed_hi_mode(gen, dev, tuple(aw.shape), 8)
        run(f"w8 square shift {shift} mul", aw, bw, s8, op="mul")
        for fo in (0, 4, 8):
            run(f"w8 square shift {shift} div fo{fo}", aw, bw, s8, op="div",
                frac_out=fo)
        run(f"w8 square shift {shift} mixed", aw, bw, s8, op="mixed",
            mode=mw, frac_out=8)
    aw, bw = words(A.reshape(64, -1), 8), words(B.reshape(64, -1), 8)
    s8m = SimdiveSpec(width=8, coeff_bits=0, round_output=False)
    run("w8 square mitchell mul", aw, bw, s8m, op="mul")
    run("w8 square mitchell div fo8", aw, bw, s8m, op="div", frac_out=8)
    log(f"  packed: exhaustive 8-bit square at four lane positions "
        f"bit-equal ({runs} runs over {len(blocks)} blocks)")

    # packed lanes = the elemwise kernel's lanes masked to 16 bits
    a8, b8 = A.to(dev), B.to(dev)
    for op, fo in (("mul", 0), ("div", 8)):
        lanes = unpack(ps.packed_cuda(aw, bw, s8, op=op, frac_out=fo), 16)
        elem = ew.elemwise_cuda(a8, b8, s8, op=op, frac_out=fo)
        torch.cuda.synchronize()
        require(torch.equal(from_lanes(lanes).reshape(-1),
                            from_lanes(elem) & 0xFFFF),
                f"packed {op} lanes differ from the elemwise kernel's")

    # width 16: > 1 M stratified pairs plus every zero / edge pair
    sa, sb = (torch.from_numpy(x) for x in stratified_pairs(
        16, SEED, per_stratum=4096))
    edge = torch.tensor([0, 1, 2, 3, 0x7FFF, 0x8000, 0xFFFE, 0xFFFF])
    a16 = torch.cat([sa.to(torch.int64), edge.repeat_interleave(len(edge))])
    b16 = torch.cat([sb.to(torch.int64), edge.repeat(len(edge))])
    aw, bw = words(a16, 16), words(b16, 16)
    mw = _packed_hi_mode(gen, dev, tuple(aw.shape), 16)
    s16 = SimdiveSpec(width=16, coeff_bits=6)
    run(f"w16 {a16.numel()} pairs mul", aw, bw, s16, op="mul")
    run(f"w16 {a16.numel()} pairs div fo15", aw, bw, s16, op="div",
        frac_out=15)
    run(f"w16 {a16.numel()} pairs mixed", aw, bw, s16, op="mixed", mode=mw,
        frac_out=8)
    run(f"w16 {a16.numel()} pairs div fo0 cb8", aw, bw,
        SimdiveSpec(width=16, coeff_bits=8), op="div", frac_out=0)

    # the error sweep's own words: (64, 64), seed 0, divisors >= 1
    sa, sb = (torch.from_numpy(x.reshape(64, -1))
              for x in sample_uints(8, 16_384, SEED, b_lo=1))
    aw, bw = words(sa, 8), words(sb, 8)
    for cb in (0, 6):
        spec = SimdiveSpec(width=8, coeff_bits=cb)
        run(f"sweep (64,64) cb{cb} mul", aw, bw, spec, op="mul")
        run(f"sweep (64,64) cb{cb} div", aw, bw, spec, op="div",
            frac_out=PACKED_DIV_FRAC_OUT)
        run(f"sweep (64,64) cb{cb} mixed", aw, bw, spec, op="mixed",
            mode=_packed_hi_mode(gen, dev, (64, 64), 8),
            frac_out=PACKED_DIV_FRAC_OUT)

    # ragged, 1-D, one-word, rank-3 and unaligned word tensors
    def rand_words(n):
        return torch.randint(0, 1 << 32, (n,), generator=gen, device=dev
                             ).to(torch.int32).view(torch.uint32)

    for width, fo in ((8, 8), (16, 15)):
        spec = SimdiveSpec(width=width, coeff_bits=6)
        for shape in ((9, 30), (7,), (1,), (2, 3, 5)):
            n = 1
            for d in shape:
                n *= d
            aw, bw = rand_words(n).reshape(shape), rand_words(n).reshape(shape)
            mw = _packed_hi_mode(gen, dev, shape, width)
            for op in ("mul", "div", "mixed"):
                run(f"w{width} {shape} {op}", aw, bw, spec, op=op,
                    mode=mw if op == "mixed" else None,
                    frac_out=0 if op == "mul" else fo)
        aw, bw = rand_words(1001), rand_words(1003)
        run(f"w{width} unaligned views", aw[1:1000], bw[3:1002], spec,
            op="div", frac_out=fo)

    # refused before any launch: frac_out 9 at width 8, a CPU tensor
    n0 = ps.packed_cuda.launches
    w = rand_words(8)
    for args, kw, what in (((w, w, s8), dict(op="div", frac_out=9),
                            "frac_out 9 at width 8"),
                           ((w.cpu(), w.cpu(), s8), {}, "a CPU tensor")):
        try:
            ps.packed_cuda(*args, **kw)
        except ValueError:
            pass
        else:
            raise SmokeFailure(f"packed: {what} was not refused")
    require(ps.packed_cuda.launches == n0,
            "a refused packed call was counted as a launch")
    log(f"  packed: bit-equal to packed_ref in {runs} (case, block) runs; "
        "lanes equal to the elemwise kernel's; frac_out 9 at width 8 and a "
        "CPU tensor refused before any launch")
    return runs, worst


# --------------------------------------------------------- phase 4: paths --
def _bench_packed_rows() -> dict:
    """The committed BENCH_simdive.json packed error rows: (op, coeff_bits)
    -> error object, from the latest run that holds them."""
    doc = json.loads((ROOT / "BENCH_simdive.json").read_text())
    for run in reversed(doc["runs"]):
        rows = {(r["op"], r["coeff_bits"]): r["error"]
                for r in run.get("grid") or []
                if r.get("kernel") == "packed" and r.get("backend") == "ref"
                and r.get("width") == 8 and r.get("index_bits") == 3
                and r.get("status") == "ok"}
        if rows:
            return rows
    raise SmokeFailure("BENCH_simdive.json holds no packed rows")


def _bench_mixed_error(dev, coeff_bits: int) -> dict:
    """The BENCH grid's packed mixed row (``benchmarks/run.py``
    ``_run_packed``), through the port: 16,384 lanes in 64 rows, seed 0,
    divisors >= 1, a seed-1 mode draw; products at integer scale,
    quotients at 2^PACKED_DIV_FRAC_OUT."""
    import numpy as np
    import torch
    from repro_torch.core.simd_pack import pack, unpack
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import simdive_packed
    from repro_torch.metrics import (PACKED_DIV_FRAC_OUT, error_stats,
                                     sample_uints)

    n, rows = 16_384, 64
    a_np, b_np = sample_uints(8, n, SEED, b_lo=1)
    a_l = torch.from_numpy(a_np.reshape(rows, -1)).to(dev)
    b_l = torch.from_numpy(b_np.reshape(rows, -1)).to(dev)
    mode_np = np.random.default_rng(SEED + 1).integers(
        0, 2, tuple(a_l.shape)).astype(np.uint32)
    mw = pack(torch.from_numpy(mode_np).to(dev), 8)
    out = simdive_packed(pack(a_l, 8), pack(b_l, 8),
                         SimdiveSpec(width=8, coeff_bits=coeff_bits),
                         op="mixed", mode=mw, frac_out=PACKED_DIV_FRAC_OUT)
    lanes = unpack(out, 16).cpu().numpy().astype(np.float64)
    af = a_np.reshape(rows, -1).astype(np.float64)
    bf = b_np.reshape(rows, -1).astype(np.float64)
    sel = mode_np.astype(bool)
    approx = np.where(sel, lanes, lanes / 2.0 ** PACKED_DIV_FRAC_OUT)
    exact = np.where(sel, af * bf, af / bf)
    return error_stats(approx, exact).as_dict()


def packed_operands(dev, size: str):
    """Packed (a, b, mode) words at one of PACKED_SIZES: Table 3's own
    draws (numpy seed 0: a in [0, 256), b in [1, 256), mode 0 / 1) at its
    size, seeded device draws of the same ranges at the full size."""
    import numpy as np
    import torch
    from repro_torch.core.simd_pack import pack

    M, Nw = PACKED_SIZES[size]
    lanes = (M, Nw * 4)
    if size == "table3":
        rng = np.random.default_rng(0)
        a = torch.from_numpy(rng.integers(0, 256, lanes, dtype=np.uint32))
        b = torch.from_numpy(rng.integers(1, 256, lanes, dtype=np.uint32))
        m = torch.from_numpy(rng.integers(0, 2, lanes, dtype=np.uint32))
    else:
        gen = torch.Generator(device=dev).manual_seed(SEED + 6)
        a = torch.randint(0, 256, lanes, generator=gen, device=dev)
        b = torch.randint(1, 256, lanes, generator=gen, device=dev)
        m = torch.randint(0, 2, lanes, generator=gen, device=dev)
    return tuple(pack(x.to(dev), 8) for x in (a, b, m))


def packed_path(dev):
    """The packed slice's path through the port's entry points: the
    frontier's error sweep and the BENCH mixed rows, held to the committed
    BENCH packed rows, then ``simdive_packed`` at both sizes."""
    import torch
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     simdive_packed)
    from repro_torch.kernels import packed_simd as ps
    from repro_torch.metrics import PACKED_DIV_FRAC_OUT
    from repro_torch.tuning import measure_error

    bench = _bench_packed_rows()
    require(sorted(bench) == [(op, cb) for op in ("div", "mixed", "mul")
                              for cb in (0, 6)],
            f"BENCH_simdive.json packed rows {sorted(bench)}")
    reset_launch_counts()
    errors = {}
    for op in ("mul", "div"):
        for cb in (0, 6):
            stats, source = measure_error(op, 8, cb, kernel="packed",
                                          device=dev)
            require(source == "sampled", f"measure_error source {source}")
            errors[(op, cb)] = dict(stats)
    for cb in (0, 6):
        errors[("mixed", cb)] = _bench_mixed_error(dev, cb)
    torch.cuda.synchronize()
    sweep_counts = launch_counts()
    require(sweep_counts["packed"] == len(errors)
            and sum(sweep_counts.values()) == sweep_counts["packed"],
            f"error sweeps: launches {sweep_counts}, expected {len(errors)} "
            "packed, one per sweep")
    for key in sorted(bench):
        want, got = bench[key], errors[key]
        for stat in ("are_pct", "mred", "nmed", "pre_pct", "wce",
                     "error_rate", "n"):
            w, g = float(want[stat]), float(got[stat])
            require(abs(g - w) <= BENCH_REL_TOL * abs(w),
                    f"packed {key[0]} cb{key[1]} {stat}: {g!r} through the "
                    f"kernel, BENCH_simdive.json {w!r}")
        log(f"  packed {key[0]} cb{key[1]}: ARE {got['are_pct']!r} % NMED "
            f"{got['nmed']!r} WCE {got['wce']!r} = BENCH_simdive.json")
    log(f"  error sweeps: launches {sweep_counts}")

    # simdive_packed at both sizes: one warm call each, then count exactly
    # the calls made
    spec = SimdiveSpec(width=8, coeff_bits=6)
    operands = {size: packed_operands(dev, size) for size in PACKED_SIZES}
    kw = {"mul": {}, "div": dict(frac_out=PACKED_DIV_FRAC_OUT),
          "mixed": dict(frac_out=PACKED_DIV_FRAC_OUT)}

    def call(size, op):
        aw, bw, mw = operands[size]
        return simdive_packed(aw, bw, spec, op=op,
                              mode=mw if op == "mixed" else None, **kw[op])

    for size in PACKED_SIZES:
        for op in kw:
            call(size, op)
    torch.cuda.synchronize()
    reset_launch_counts()
    outs, calls = {}, 0
    for size in PACKED_SIZES:
        for op in kw:
            outs[(size, op)] = call(size, op)
            calls += 1
    torch.cuda.synchronize()
    api_counts = launch_counts()
    require(api_counts["packed"] == calls
            and sum(api_counts.values()) == calls,
            f"simdive_packed: launches {api_counts}, expected {calls} packed")
    worst = 0
    for (size, op), out in outs.items():
        aw, bw, mw = operands[size]
        require(tuple(out.shape) == (aw.shape[0], 2 * aw.shape[1]),
                f"simdive_packed {size} {op}: shape {tuple(out.shape)}")
        want = ps.packed_ref(aw, bw, spec, op=op,
                             mode=mw if op == "mixed" else None, **kw[op])
        nbad, err = _packed_err(out, want, spec.width)
        worst = max(worst, err)
        require(nbad == 0, f"simdive_packed {size} {op}: {nbad} words differ "
                           f"from packed_ref (largest lane error {err})")
        del want
    outs.clear()
    torch.cuda.empty_cache()
    log(f"  simdive_packed: {calls} calls at {sorted(PACKED_SIZES.values())}"
        f" words, launches {api_counts}; every output bit-equal to "
        f"packed_ref (largest lane error {worst})")
    return dict(operands=operands, kw=kw, spec=spec,
                sweep_launches=sweep_counts["packed"],
                api_launches=api_counts["packed"], max_abs_err=worst,
                errors={f"{op} cb{cb}": e for (op, cb), e in errors.items()})


def elemwise_path(dev):
    """The elemwise kernel's path since the decode step's divider moved into
    decode_attention: ``tuning.frontier.measure_error(kernel="elemwise")``
    on the card for mul and div, width 8, coeff_bits 6 (the exhaustive
    8-bit square), each error object equal to the same call's on the plain
    version (``device="cpu"``); the launch counts zeroed just before and
    read just after."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.tuning import measure_error

    reset_launch_counts()
    card = {op: measure_error(op, 8, 6, kernel="elemwise", device=dev)
            for op in ("mul", "div")}
    torch.cuda.synchronize()
    counts = launch_counts()
    require(counts["elemwise"] == len(card)
            and sum(counts.values()) == len(card),
            f"measure_error(kernel='elemwise'): launches {counts}, expected "
            f"{len(card)} elemwise")
    errors = {}
    for op, (stats, source) in card.items():
        plain = measure_error(op, 8, 6, kernel="elemwise", device="cpu")
        require((stats, source) == plain and source == "exhaustive",
                f"measure_error elemwise {op} w8 cb6: {dict(stats)} "
                f"({source}) on the card, {dict(plain[0])} ({plain[1]}) "
                "on the plain version")
        errors[op] = dict(stats)
        log(f"  elemwise {op} w8 cb6 (measure_error, {source}): ARE "
            f"{errors[op]['are_pct']!r} % = the plain version's")
    log(f"  measure_error(kernel='elemwise'): launches {counts}")
    return dict(launches=counts["elemwise"], errors=errors)


# --------------------------------------------------------- phase 4: serve --
def serve_main_path(dev):
    import numpy as np
    import torch
    from repro_torch.kernels import (clear_autotune_cache,
                                     export_autotune_cache, launch_counts,
                                     preload_autotune_cache,
                                     reset_launch_counts)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import build

    cfg = serve.serving_config(ARCH, approx="simdive")
    require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.d_head, cfg.d_ff, cfg.vocab_size, cfg.dtype)
            == (32, 960, 15, 5, 64, 2560, 49152, "bfloat16"),
            "not the full-width smollm-360m config")
    lm = build(cfg)                                  # device defaults to cuda
    require(lm.device.type == "cuda", "LM not on the GPU")
    log(serve.render_plan(serve.resolve_serving_plan(cfg), cfg))
    params = lm.init(SEED)
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int64)).to(dev)
    max_seq = PROMPT + GEN

    # first use: the served prefill, called alone, runs once eagerly (the
    # attention autotune times its candidates once for the prefill's shape
    # bucket) and captures; then the first generate replays it and captures
    # the decode step (those launches are not the path's). Reserved memory
    # before and after each: what each graph holds
    step, pstep = serve.make_decode_step(lm), serve.make_prefill(lm)
    clear_autotune_cache()
    reserved = reserved_bytes()
    t0 = wall_clock()
    pstep(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_held_bytes = reserved_bytes() - reserved
    reserved = reserved_bytes()
    serve.generate(lm, params, prompts, max_seq, GEN)
    torch.cuda.synchronize()
    first_run_s = wall_clock() - t0
    held_bytes = reserved_bytes() - reserved
    first_capture_s = step.capture_s
    prefill_first_capture_s = pstep.capture_s
    picks = [tuple(r["block"]) for r in export_autotune_cache()
             if r["key"][0] == "attention"]
    log(f"  first prefill and generate (autotune, capture of the prefill "
        f"{prefill_first_capture_s:.2f}s, holding {prefill_held_bytes} "
        f"bytes, and of the decode step {first_capture_s:.2f}s, holding "
        f"{held_bytes}) {first_run_s:.2f}s; attention picked {picks}")
    require(step.captures == 1, f"the first generate captured {step.captures}"
                                " decode steps, expected 1")
    require(pstep.captures == 1, f"the first prefill and generate captured "
                                 f"{pstep.captures} prefills, expected 1")

    # the main path: the second generate replays the captured prefill and
    # step (launch counts through the replay accounting)
    reset_launch_counts()
    t0 = wall_clock()
    tokens, logits = serve.generate(lm, params, prompts, max_seq, GEN,
                                    return_logits=True)
    torch.cuda.synchronize()
    run_s = wall_clock() - t0
    counts = launch_counts()
    log(f"  main path: {tuple(tokens.shape)} tokens in {run_s:.2f}s; "
        f"launches {counts}")
    require(step.captures == 1, "two generate calls in a row captured "
                                f"{step.captures} decode steps, expected 1")
    require(pstep.captures == 1, "two generate calls in a row captured "
                                 f"{pstep.captures} prefills, expected 1")
    require(_attention_launches(counts) == cfg.n_layers,
            f"attention launches {counts}, expected {cfg.n_layers} (one per "
            "layer of the prefill, both schedules together)")
    require(counts["decode_attention"] == cfg.n_layers * (GEN - 1)
            and counts["elemwise"] == 0,
            f"decode_attention / elemwise launches {counts}, expected "
            f"{cfg.n_layers} decode_attention per decode step x {GEN - 1} "
            "steps and no elemwise")
    require(tokens.shape == (BATCH, GEN)
            and logits.shape == (BATCH, GEN, cfg.vocab_size),
            "generate returned the wrong shapes")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    require(int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size,
            "token out of the vocabulary")
    # the eager prefill and loop: the same launches, tokens and logits
    reset_launch_counts()
    eager_tok, eager_logits = serve.generate(
        lm, params, prompts, max_seq, GEN, prefill_fn=lm.prefill,
        decode_fn=lm.decode_step, return_logits=True)
    torch.cuda.synchronize()
    eager_counts = launch_counts()
    require(eager_counts == counts,
            f"the eager generate launched {eager_counts}, the captured one "
            f"{counts}")
    require(torch.equal(eager_tok, tokens) and torch.equal(eager_logits,
                                                           logits),
            "the captured and the eager generate gave different tokens or "
            "logits")
    log("  captured (prefill and step) vs eager generate: tokens and logits "
        "torch.equal, the same launches")
    prefill_counts = check_prefill_replay(lm, params, prompts, "divider-only")
    # one decode step alone, eager and one replay of the captured step: one
    # decode_attention launch a layer
    lg, pre = lm.prefill(params, {"tokens": prompts})
    cache = serve.merge_cache(lm.empty_cache(BATCH, max_seq), pre)
    reset_launch_counts()
    lm.decode_step(params, cache, lg.argmax(-1), PROMPT)
    torch.cuda.synchronize()
    step_counts = launch_counts()
    require(step_counts["decode_attention"] == cfg.n_layers
            and sum(step_counts.values()) == cfg.n_layers,
            f"one decode step launched {step_counts}, expected "
            f"{cfg.n_layers} decode_attention and nothing else")
    own = serve.merge_cache(step.empty_cache(BATCH, max_seq), pre)
    reset_launch_counts()
    step(params, own, lg.argmax(-1), PROMPT)
    torch.cuda.synchronize()
    require(launch_counts() == step_counts and step.captures == 1,
            f"one replay of the captured step counted {launch_counts()} "
            f"(captures {step.captures}), the eager step {step_counts}")
    del lg, pre, cache, own
    reset_launch_counts()

    # the same model through the plain versions, fed the same tokens
    ref_lm = build(serve.serving_config(ARCH, approx="simdive",
                                        backend="ref"))
    ref_all = plain_logits(ref_lm, params, prompts, tokens)
    tol, _ = ulp_logit_tol("divider-only", ref_all, TIED_LOGIT_RANGE)
    err = (logits - ref_all).abs()
    prefill_err, decode_err = float(err[:, 0].max()), float(err[:, 1:].max())
    top2 = ref_all.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * tol
    agree = tokens == ref_all.argmax(-1)
    log(f"  vs plain versions: prefill logits max_abs_err {prefill_err:.4f}, "
        f"decode {decode_err:.4f}; tokens equal {int(agree.sum())}/"
        f"{agree.numel()}, decided by margin {int(decided.sum())}, of those "
        f"equal {int((agree & decided).sum())}")
    require(max(prefill_err, decode_err) <= tol,
            f"logits differ from the plain-version run by "
            f"{max(prefill_err, decode_err):.4f} > {tol}")
    require(bool((agree | ~decided).all()),
            "a greedy token decided by more than twice the logit tolerance "
            "differs from the plain-version run")

    # both attention schedules on the path, at full width: pin the prefill's
    # cached entry to one block, then to the other. Each pin makes the
    # prefill and the decode step capture again: the first pinned generate
    # captures (each warm run adds one prefill's or one step's launches),
    # the second replays
    tuned = export_autotune_cache()
    pinned = {}
    for block, own, other in (
            (fa.DEFAULT_BLOCK, "attention", "attention_pipelined"),
            (ATTENTION_RING_BLOCK, "attention_pipelined", "attention")):
        require(_pin_blocks("attention", block) > 0, "nothing to pin")
        captures, prefill_captures = step.captures, pstep.captures
        for warm in (1, 0):
            reset_launch_counts()
            tok_p, log_p = serve.generate(lm, params, prompts, max_seq, GEN,
                                          return_logits=True)
            torch.cuda.synchronize()
            c = launch_counts()
            log(f"  pinned to attention block {block}: launches {c}, "
                f"captures {step.captures - captures} (step) / "
                f"{pstep.captures - prefill_captures} (prefill)")
            require(c[own] == cfg.n_layers * (1 + warm) and c[other] == 0
                    and c["decode_attention"]
                    == cfg.n_layers * (GEN - 1 + warm),
                    f"pinned to {block}, launches were {c}")
            require(step.captures == captures + 1
                    and pstep.captures == prefill_captures + 1,
                    f"pinned to {block}, the decode step captured "
                    f"{step.captures - captures} times and the prefill "
                    f"{pstep.captures - prefill_captures}, expected once each")
        pinned[own] = (tok_p, log_p, c)
    (tok_0, log_0, c_0), (tok_r, log_r, c_r) = (pinned["attention"],
                                                pinned["attention_pipelined"])
    require(torch.equal(log_0, log_r) and torch.equal(tok_0, tok_r),
            "depth-0 and ring attention schedules gave different logits or "
            "tokens")
    require(torch.equal(log_0, logits) and torch.equal(tok_0, tokens),
            "the pinned and the autotuned runs gave different logits or "
            "tokens")
    log("  depth-0 and ring attention schedules: bit-identical logits and "
        "tokens, equal to the autotuned run's")
    clear_autotune_cache()
    preload_autotune_cache(tuned)                # back to the tuned blocks
    return dict(lm=lm, params=params, prompts=prompts, counts=counts,
                step_counts=step_counts, first_capture_s=first_capture_s,
                held_bytes=held_bytes, prefill_counts=prefill_counts,
                prefill_first_capture_s=prefill_first_capture_s,
                prefill_held_bytes=prefill_held_bytes,
                pinned_counts={"attention": c_0,
                               "attention_pipelined": c_r},
                attention_picks=[list(b) for b in picks],
                first_run_s=first_run_s, run_s=run_s,
                prefill_logit_err=prefill_err,
                decode_logit_err=decode_err,
                tokens_equal=int(agree.sum()), tokens=agree.numel(),
                tokens_decided=int(decided.sum()))


def check_prefill_replay(lm, params, prompts, what: str) -> dict:
    """One replay of the served prefill (captured before, for ``params``)
    against the eager ``lm.prefill`` on the same prompts: logits and every
    cache leaf (k and v; the rwkv6 stack's att_x, ffn_x and state)
    ``torch.equal``, no new capture, and the replay's launches exactly one
    eager prefill's. Returns those launches."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    pstep = serve.make_prefill(lm)
    captures = pstep.captures
    batch = {"tokens": prompts}
    reset_launch_counts()
    want_logits, want = lm.prefill(params, batch)
    torch.cuda.synchronize()
    eager_counts = launch_counts()
    reset_launch_counts()
    got_logits, got = pstep(params, batch)
    torch.cuda.synchronize()
    replay_counts = launch_counts()
    reset_launch_counts()
    require(pstep.captures == captures,
            f"{what}: the served prefill captured again for the same params")
    require(replay_counts == eager_counts,
            f"{what}: one replayed prefill counted {replay_counts}, one eager "
            f"prefill {eager_counts}")
    paths = [p for p, _ in serve.cache_leaves(
        type(lm)(lm.cfg, torch.device("meta")).empty_cache(1, 1))]
    got, want = dict(serve.cache_leaves(got)), dict(serve.cache_leaves(want))
    require(torch.equal(got_logits, want_logits)
            and list(got) == list(want) == paths
            and all(torch.equal(got[p], want[p]) for p in want),
            f"{what}: the captured prefill's logits or cache differ from the "
            "eager lm.prefill's")
    log(f"  {what}: captured prefill vs eager lm.prefill: logits and "
        f"{', '.join('/'.join(p) for p in paths)} torch.equal; one replay "
        f"launched {replay_counts}, as one eager prefill")
    return eager_counts


def _matmul_launches(counts) -> int:
    return counts.get("matmul", 0) + counts.get("matmul_pipelined", 0)


def _attention_launches(counts) -> int:
    return counts["attention"] + counts["attention_pipelined"]


def _pin_blocks(op: str, block) -> int:
    """Point every cached entry of ``op`` at ``block``, keeping the other
    ops' entries; returns how many entries of ``op`` were pinned."""
    from repro_torch.kernels import (autotune_cache, clear_autotune_cache,
                                     export_autotune_cache,
                                     preload_autotune_cache)

    records = [dict(r, block=list(block)) if r["key"][0] == op else r
               for r in export_autotune_cache()]
    clear_autotune_cache()
    preload_autotune_cache(records)
    return sum(1 for key, got in autotune_cache().items()
               if key[0] == op and got == tuple(block))


def serve_emulate_path(dev, params, prompts):
    """--approx simdive --emulate at full width: launch counts, plain-version
    comparison (shorter run), schedule pinning, --quantize."""
    import torch
    from repro_torch.kernels import (clear_autotune_cache,
                                     export_autotune_cache, launch_counts,
                                     preload_autotune_cache,
                                     reset_launch_counts)
    from repro_torch.kernels import logmatmul as lm
    from repro_torch.launch import serve
    from repro_torch.models import build

    cfg = serve.serving_config(ARCH, approx="simdive", emulate=True)
    require(cfg.approx.emulate and cfg.approx.width == 8,
            "not the --emulate serving config")
    lm_e = build(cfg)
    n_lin = len(LINEARS) * cfg.n_layers                   # 224
    max_seq = PROMPT + GEN

    # first use, as in (a): the served prefill alone (autotunes each of its
    # shape buckets once, captures), then the first generate (autotunes
    # the decode buckets, captures the decode step); builds nothing new
    step, pstep = serve.make_decode_step(lm_e), serve.make_prefill(lm_e)
    clear_autotune_cache()
    reserved = reserved_bytes()
    t0 = wall_clock()
    pstep(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_held_bytes = reserved_bytes() - reserved
    reserved = reserved_bytes()
    serve.generate(lm_e, params, prompts, max_seq, GEN)
    torch.cuda.synchronize()
    tune_s = wall_clock() - t0
    held_bytes = reserved_bytes() - reserved
    first_capture_s = step.capture_s
    prefill_first_capture_s = pstep.capture_s
    require(step.captures == 1, f"the first emulate generate captured "
                                f"{step.captures} decode steps, expected 1")
    require(pstep.captures == 1, f"the first emulate prefill and generate "
                                 f"captured {pstep.captures} prefills, "
                                 "expected 1")
    picks = {tuple(r["key"][2][0]) + tuple(r["key"][2][2]): r["block"]
             for r in export_autotune_cache() if r["key"][0] == "matmul_emul"}
    log(f"  emulate: first generate (autotune) {tune_s:.2f}s; picked "
        + "; ".join(f"x{k[:2]} w{k[2:]} -> {tuple(v)}"
                    for k, v in sorted(picks.items())))

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = wall_clock()
    tokens, logits = serve.generate(lm_e, params, prompts, max_seq, GEN,
                                    return_logits=True)
    torch.cuda.synchronize()
    run_s = wall_clock() - t0
    counts = launch_counts()
    log(f"  emulate main path: {tuple(tokens.shape)} tokens in {run_s:.2f}s; "
        f"launches {counts}")
    require(step.captures == 1, "two emulate generate calls in a row "
                                f"captured {step.captures} decode steps")
    require(pstep.captures == 1, "two emulate generate calls in a row "
                                 f"captured {pstep.captures} prefills")
    require(_matmul_launches(counts) == n_lin * GEN,
            f"logmatmul launches {_matmul_launches(counts)}, expected "
            f"{n_lin} per prefill and per decode step x {GEN}")
    require(_attention_launches(counts) == cfg.n_layers
            and counts["decode_attention"] == cfg.n_layers * (GEN - 1)
            and counts["elemwise"] == 0,
            f"attention / decode_attention / elemwise launches {counts}")
    require(bool(torch.isfinite(logits).all())
            and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab_size, "bad emulate output")
    reset_launch_counts()
    eager_tok, eager_logits = serve.generate(
        lm_e, params, prompts, max_seq, GEN, prefill_fn=lm_e.prefill,
        decode_fn=lm_e.decode_step, return_logits=True)
    torch.cuda.synchronize()
    require(launch_counts() == counts,
            f"the eager emulate generate launched {launch_counts()}, the "
            f"captured one {counts}")
    require(torch.equal(eager_tok, tokens) and torch.equal(eager_logits,
                                                           logits),
            "the captured and the eager emulate generate gave different "
            "tokens or logits")
    log("  emulate, captured (prefill and step) vs eager generate: tokens "
        "and logits torch.equal, the same launches")
    prefill_counts = check_prefill_replay(lm_e, params, prompts, "emulate")
    reset_launch_counts()
    lg, pre = lm_e.prefill(params, {"tokens": prompts})
    cache = serve.merge_cache(lm_e.empty_cache(BATCH, max_seq), pre)
    reset_launch_counts()
    lm_e.decode_step(params, cache, lg.argmax(-1), PROMPT)
    step_counts = launch_counts()
    own = serve.merge_cache(step.empty_cache(BATCH, max_seq), pre)
    reset_launch_counts()
    step(params, own, lg.argmax(-1), PROMPT)
    torch.cuda.synchronize()
    require(launch_counts() == step_counts and step.captures == 1,
            f"one replay of the captured emulate step counted "
            f"{launch_counts()} (captures {step.captures}), the eager step "
            f"{step_counts}")
    del lg, pre, cache, own
    require(_matmul_launches(prefill_counts) == n_lin
            and _matmul_launches(step_counts) == n_lin,
            f"logmatmul launches per prefill {prefill_counts}, per decode "
            f"step {step_counts}; expected {n_lin} each")
    require(step_counts["decode_attention"] == cfg.n_layers
            and step_counts["elemwise"] == 0,
            f"emulate decode step launched {step_counts}, expected "
            f"{cfg.n_layers} decode_attention and no elemwise")

    # plain-version comparisons at batch 4 x prompt 32 x 8 tokens
    short = prompts[:, :REF_PROMPT]
    short_seq = REF_PROMPT + REF_GEN
    tok_k, log_k = serve.generate(lm_e, params, short, short_seq, REF_GEN,
                                  return_logits=True)
    spec, _, frac_out = cfg.approx.resolve_attention()

    class AttentionOnKernel:
        """A serving policy that keeps the attention op (the prefill's
        flash kernel, the decode step's decode_attention kernel) on its
        CUDA kernels, same divider config, and leaves every other op to
        the config. Its backend is the policy files' name of the kernel,
        'pallas', which the port serves as 'cuda'."""
        entry = SimpleNamespace(width=spec.width, coeff_bits=spec.coeff_bits,
                                index_bits=spec.index_bits, backend="pallas",
                                frac_out=frac_out)

        def lookup(self, op, layer):
            return self.entry if op == "attention" else None

    def plain_run(policy):
        ref_cfg = serve.serving_config(ARCH, approx="simdive", emulate=True,
                                       backend="ref")
        ref_lm = build(ref_cfg.with_approx(
            replace(ref_cfg.approx, policy=policy)))
        before = launch_counts()
        t0 = wall_clock()
        ref_logits, cache = ref_lm.prefill(params, {"tokens": short})
        cache = serve.merge_cache(ref_lm.empty_cache(BATCH, short_seq), cache)
        ref_all = [ref_logits]
        for i in range(REF_GEN - 1):
            ref_logits, cache = ref_lm.decode_step(params, cache, tok_k[:, i],
                                                   REF_PROMPT + i)
            ref_all.append(ref_logits)
        ref_all = torch.stack(ref_all, dim=1).to(torch.float32)
        torch.cuda.synchronize()
        after = launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        return ref_all, wall_clock() - t0, launched

    # (1) plain matmuls, the attention op (prefill and decode attention
    # kernels) on its kernels: bit-equal rows
    ref_att, ref_s, launched = plain_run(AttentionOnKernel())
    require(_matmul_launches(launched) == 0 and launched["packed"] == 0
            and _attention_launches(launched) == cfg.n_layers
            and launched["decode_attention"] == cfg.n_layers * (REF_GEN - 1)
            and launched["elemwise"] == 0,
            f"the plain-matmul run launched {launched}, expected the "
            f"attention op's kernels only")
    equal_rows = float((log_k == ref_att).all(dim=-1).float().mean())
    log(f"  emulate vs plain matmuls, attention op on its kernels (run "
        f"{ref_s:.1f}s): logits max_abs_err "
        f"{float((log_k - ref_att).abs().max()):.4f}, bit-equal rows "
        f"{equal_rows:.3f}")
    require(equal_rows >= EMULATE_EQUAL_ROW_SHARE,
            f"only {equal_rows:.3f} of the emulate logit rows are bit-equal "
            f"to the plain-matmul run's (at least "
            f"{EMULATE_EQUAL_ROW_SHARE} required)")
    # (2) every op on its plain version
    ref_all, ref_s, launched = plain_run(None)
    require(not any(launched.values()),
            f"the plain-version run launched {launched}")
    tol, _ = ulp_logit_tol("emulate", ref_all, TIED_LOGIT_RANGE)
    err = float((log_k - ref_all).abs().max())
    top2 = ref_all.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * tol
    agree = tok_k == ref_all.argmax(-1)
    log(f"  emulate vs plain versions (batch {BATCH} x prompt {REF_PROMPT} x "
        f"{REF_GEN} tokens, plain run {ref_s:.1f}s): logits max_abs_err "
        f"{err:.4f}, bit-equal rows "
        f"{float((log_k == ref_all).all(dim=-1).float().mean()):.3f}; tokens "
        f"equal {int(agree.sum())}/{agree.numel()}, decided "
        f"{int(decided.sum())}")
    require(err <= tol,
            f"emulate logits differ from the plain-version run by {err:.4f} "
            f"> {tol}")
    require(bool((agree | ~decided).all()),
            "an emulate greedy token decided by more than twice the logit "
            "tolerance differs from the plain-version run")

    # both schedules on the path, at full size: pin every shape bucket to
    # the default (depth-0) block, then to the ring block. Each pin makes
    # the prefill and the decode step capture again: the first pinned
    # generate captures (the prefill's warm run and the step's warm step
    # add 224 launches each), the second replays
    tuned = export_autotune_cache()
    pinned, pinned_counts = {}, {}
    for block, own, other in (
            (lm.DEFAULT_BLOCK, "matmul", "matmul_pipelined"),
            (MATMUL_RING_BLOCK, "matmul_pipelined", "matmul")):
        require(_pin_blocks("matmul_emul", block) > 0, "nothing to pin")
        captures, prefill_captures = step.captures, pstep.captures
        for extra in (2 * n_lin, 0):
            reset_launch_counts()
            pinned[own] = serve.generate(lm_e, params, prompts, max_seq, GEN,
                                         return_logits=True)
            torch.cuda.synchronize()
            c = launch_counts()
            log(f"  emulate pinned to matmul block {block}: launches {c}, "
                f"captures {step.captures - captures} (step) / "
                f"{pstep.captures - prefill_captures} (prefill)")
            require(c[own] == n_lin * GEN + extra and c[other] == 0,
                    f"pinned to {block}, launches were {c}")
            require(step.captures == captures + 1
                    and pstep.captures == prefill_captures + 1,
                    f"pinned to {block}, the decode step captured "
                    f"{step.captures - captures} times and the prefill "
                    f"{pstep.captures - prefill_captures}, expected once each")
        pinned_counts[own] = c[own]
    for own, (tok_p, log_p) in pinned.items():
        require(torch.equal(tok_p, tokens) and torch.equal(log_p, logits),
                f"emulate pinned to the {own} schedule: tokens or logits "
                "differ from the autotuned run's")
    log("  emulate, depth-0 and ring matmul schedules: bit-identical logits "
        "and tokens, equal to the autotuned run's")
    clear_autotune_cache()
    preload_autotune_cache(tuned)                # back to the tuned blocks

    # --emulate --quantize: int8 weights through the same kernels. New
    # params: the prefill and the step capture again (their warm runs add
    # one prefill's and one step's launches); the eager prefill and loop
    # launch what the autotuned run did
    qparams = serve.quantize_params(params)
    captures, prefill_captures = step.captures, pstep.captures
    reset_launch_counts()
    q_tok, q_logits = serve.generate(lm_e, qparams, prompts, max_seq, GEN,
                                     return_logits=True)
    q_counts = launch_counts()
    require(bool(torch.isfinite(q_logits).all())
            and int(q_tok.min()) >= 0 and int(q_tok.max()) < cfg.vocab_size,
            "bad --emulate --quantize output")
    require(step.captures == captures + 1
            and pstep.captures == prefill_captures + 1,
            "--quantize: the decode step or the prefill did not capture "
            "again for the new params")
    with_warm = {k: counts[k] + step_counts[k] + prefill_counts[k]
                 for k in counts}
    require(q_counts == with_warm,
            f"--quantize launches {q_counts} != {with_warm}")
    check_prefill_replay(lm_e, qparams, prompts, "--emulate --quantize")
    reset_launch_counts()
    qe_tok, qe_logits = serve.generate(lm_e, qparams, prompts, max_seq, GEN,
                                       prefill_fn=lm_e.prefill,
                                       decode_fn=lm_e.decode_step,
                                       return_logits=True)
    torch.cuda.synchronize()
    require(launch_counts() == counts,
            f"--quantize eager launches {launch_counts()} != {counts}")
    require(torch.equal(qe_tok, q_tok) and torch.equal(qe_logits, q_logits),
            "--quantize: the captured and the eager generate gave different "
            "tokens or logits")
    log(f"  --emulate --quantize: finite logits, launches {q_counts} "
        "(the captures' warm runs included); captured vs eager generate: "
        "tokens and logits torch.equal")
    return dict(lm=lm_e, counts=counts, step_counts=step_counts,
                first_capture_s=first_capture_s, held_bytes=held_bytes,
                prefill_counts=prefill_counts,
                prefill_first_capture_s=prefill_first_capture_s,
                prefill_held_bytes=prefill_held_bytes,
                pinned_counts=pinned_counts,
                first_run_s=run_s, tune_s=tune_s,
                autotune_picks={f"{k}": v for k, v in picks.items()},
                logit_err=err, equal_row_share=equal_rows,
                tokens_equal=int(agree.sum()),
                tokens=agree.numel(), tokens_decided=int(decided.sum()),
                plain_run_s=ref_s)


# --------------------------------------------------------- phase 5: times --
def decode_attention_bound(B, KVH, G, dh, valid, int_rate):
    """(least ms, "bytes" or "operations") of one bf16 decode attention
    call with ``valid`` history slots: their k and v rows, q, the output,
    the new token and the div table moved once; QK^T and PV (and the self
    term) at the bf16 tensor-core peak; the finalize's divider lanes on the
    INT32 lanes."""
    q_elems = B * KVH * G * dh
    moved = (2 * B * valid * KVH * dh * 2 + 2 * q_elems * 2
             + 2 * B * KVH * dh * 2 + 256 * 4)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    flops_ms = 4 * B * KVH * G * (valid + 1) * dh / BF16_FLOPS * 1e3
    int_ms = ELEMWISE_OPS_PER_LANE * q_elems / int_rate * 1e3
    if bytes_ms >= max(flops_ms, int_ms):
        return bytes_ms, "bytes"
    return max(flops_ms, int_ms), "operations"


def time_decode_attention(dev, gen, B, Smax, KVH, G, dh, pos, spec,
                          frac_out, int_rate, clusters=()):
    """The decode_attention op on the card at one bf16 shape, a scalar
    ``pos`` (``pos`` valid slots), the SIMDive finalize: graph-replayed ms
    at the planner's launch (``get_op``, as the model calls it) and, where
    the wrapper takes ``cluster=``, pinned at each size in ``clusters``;
    one ``scaled_dot_product_attention`` over the cache plus the new token
    (appended as the last key) with a boolean mask, the exact-divide
    yardstick (the GQA repeat and the layout made outside the timed call);
    the bound. Returns a dict; "inputs" holds (q, k_cache, v_cache, k_new,
    v_new)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import get_op

    bf16 = torch.bfloat16
    # (a wrapper without cluster= is timed at its own launch shape alone)
    dq = torch.randn(B, KVH, G, dh, generator=gen, device=dev).to(bf16)
    kc, vc = (torch.randn(B, Smax, KVH, dh, generator=gen, device=dev
                          ).to(bf16) for _ in range(2))
    kn, vn = (torch.randn(B, 1, KVH, dh, generator=gen, device=dev
                          ).to(bf16) for _ in range(2))
    kw = dict(pos=pos, slot=pos, approx_div=True, frac_out=frac_out)
    ms = gpu_graph_time_ms(lambda: get_op("decode_attention", spec, "cuda")(
        dq, kc, vc, kn, vn, **kw), iters=200)
    by_cluster = {}
    if hasattr(da, "cluster_size"):
        for c in clusters:
            by_cluster[c] = gpu_graph_time_ms(
                lambda c=c: da.decode_attention_cuda(
                    dq, kc, vc, kn, vn, spec=spec, cluster=c, **kw),
                iters=200)
    H = KVH * G
    kf = torch.cat([kc, kn], dim=1).permute(0, 2, 1, 3
                                             ).repeat_interleave(G, dim=1)
    vf = torch.cat([vc, vn], dim=1).permute(0, 2, 1, 3
                                             ).repeat_interleave(G, dim=1)
    qf = dq.reshape(B, H, 1, dh)
    mask = torch.arange(Smax + 1, device=dev) < pos
    mask[Smax] = True
    mask = mask.expand(B, 1, 1, Smax + 1)
    lib_ms = gpu_graph_time_ms(lambda: F.scaled_dot_product_attention(
        qf, kf, vf, attn_mask=mask), iters=200)
    bound, by = decode_attention_bound(B, KVH, G, dh, min(pos, Smax),
                                       int_rate)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    return {"ms": ms, "ms_by_cluster": by_cluster, "library_ms": lib_ms,
            "bound_ms": bound, "bound_by": by,
            "cluster": (da.cluster_size(B, KVH, sm_count)
                        if hasattr(da, "cluster_size") else None),
            "inputs": (dq, kc, vc, kn, vn)}


def measure(dev, served, int_rate):
    import torch
    import torch.nn.functional as F
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import (clear_autotune_cache,
                                     export_autotune_cache, get_op,
                                     preload_autotune_cache)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.metrics import DIV_FRAC_OUT, grid8
    from repro_torch.metrics.timing import time_callable

    lm, params, prompts = served["lm"], served["params"], served["prompts"]
    cfg = lm.cfg
    spec, _, frac_out = cfg.approx.resolve_attention()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // KV

    # attention at the prefill's shape: q (B*H, S, dh), kv (B*KV, S, dh)
    q = torch.randn(BATCH * H, PROMPT, dh, generator=gen, device=dev
                    ).to(torch.bfloat16)
    k = torch.randn(BATCH * KV, PROMPT, dh, generator=gen, device=dev
                    ).to(torch.bfloat16)
    v = torch.randn(BATCH * KV, PROMPT, dh, generator=gen, device=dev
                    ).to(torch.bfloat16)
    kw = dict(causal=True, approx_div=True, frac_out=frac_out, kv_group=G)
    # each schedule, and the ring at every depth it takes at this shape
    att_blocks = [fa.DEFAULT_BLOCK]
    for depth in range(1, fa._MAX_DEPTH + 1):
        try:
            fa.check_block((*fa.DEFAULT_BLOCK, depth), q.dtype, dh)
        except ValueError:
            continue
        att_blocks.append((*fa.DEFAULT_BLOCK, depth))
    att_ms_by, att_eager_by = {}, {}
    for block in att_blocks:
        att_kernel = lambda b=block: get_op("attention", spec, "cuda",
                                            block=b)(q, k, v, **kw)
        att_ms_by[block] = gpu_graph_time_ms(att_kernel, iters=50)
        att_eager_by[block] = gpu_time_ms(att_kernel, iters=50)
        log(f"  attention block {block}: {att_ms_by[block]:.5f} ms (graph), "
            f"{att_eager_by[block]:.5f} ms (eager)")
    att_ms = att_ms_by[fa.DEFAULT_BLOCK]
    ring_ms = att_ms_by[ATTENTION_RING_BLOCK]
    # the depth-0 launch with the exact divide: what the SIMDive finalize
    # adds to the kernel's time
    att_exact_ms = gpu_graph_time_ms(
        lambda: get_op("attention", spec, "cuda", block=fa.DEFAULT_BLOCK)(
            q, k, v, **dict(kw, approx_div=False)), iters=50)
    log(f"  attention block {fa.DEFAULT_BLOCK}, exact divide: "
        f"{att_exact_ms:.5f} ms (graph); the SIMDive finalize adds "
        f"{att_ms - att_exact_ms:.5f} ms")
    att_plain_ms = gpu_time_ms(lambda: get_op("attention", spec, "ref")(
        q, k, v, **kw), iters=10)
    q4 = q.reshape(BATCH, H, PROMPT, dh)
    k4 = k.reshape(BATCH, KV, PROMPT, dh).repeat_interleave(G, dim=1)
    v4 = v.reshape(BATCH, KV, PROMPT, dh).repeat_interleave(G, dim=1)
    att_lib_ms = gpu_graph_time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), iters=50)
    pairs = BATCH * H * PROMPT * (PROMPT + 1) // 2       # causal (q, k) pairs
    att_flops = 4 * pairs * dh                           # QK^T and PV
    att_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, o, k, v
    att_ops_ms = att_flops / BF16_FLOPS * 1e3
    att_bytes_ms = att_bytes / HBM_BYTES_PER_S * 1e3
    for block, t in att_ms_by.items():
        log(f"  attention block {block}: {att_flops / (t * 1e-3) / 1e12:.2f} "
            f"TFLOP/s, {t / att_lib_ms:.3f}x scaled_dot_product_attention "
            f"({att_lib_ms:.5f} ms), {t / max(att_ops_ms, att_bytes_ms):.2f}x "
            "the bound")

    # elemwise at its path's shape: measure_error's exhaustive 8-bit
    # square, div at DIV_FRAC_OUT, w8 cb6
    a_np, b_np = grid8()
    a = torch.from_numpy(a_np).to(dev)
    b = torch.from_numpy(b_np).to(dev)
    ew_spec = SimdiveSpec(width=8, coeff_bits=6)
    ew_kernel = lambda: get_op("elemwise", ew_spec, "cuda")(
        a, b, op="div", frac_out=DIV_FRAC_OUT)
    ew_ms = gpu_graph_time_ms(ew_kernel, iters=200)
    ew_eager_ms = gpu_time_ms(ew_kernel, iters=500)
    ew_plain_ms = gpu_time_ms(lambda: get_op("elemwise", ew_spec, "ref")(
        a, b, op="div", frac_out=DIV_FRAC_OUT), iters=50)
    lanes = a.numel()
    ew_bytes_ms = 12 * lanes / HBM_BYTES_PER_S * 1e3
    ew_ops_ms = ELEMWISE_OPS_PER_LANE * lanes / int_rate * 1e3
    # the same kernel where it is memory bound: 16 M lanes
    big = 1 << 24
    ab = torch.randint(0, 1 << 16, (big,), generator=gen, device=dev
                       ).to(torch.int32).view(torch.uint32)
    bb = torch.randint(0, 1 << 16, (big,), generator=gen, device=dev
                       ).to(torch.int32).view(torch.uint32)
    ew_big_ms = gpu_time_ms(lambda: get_op("elemwise", spec, "cuda")(
        ab, bb, op="div", frac_out=frac_out), iters=20)

    # decode_attention at the decode step's shape: batch 4, cache
    # PROMPT + GEN, a mid-generation position, the serving divider; the
    # planner's cluster size and every pinned size
    Smax, pos = PROMPT + GEN, PROMPT + 15
    sizes = tuple(range(1, 9))
    da_t = time_decode_attention(dev, gen, BATCH, Smax, KV, G, dh, pos, spec,
                                 frac_out, int_rate, clusters=sizes)
    dq, kc, vc, kn, vn = da_t["inputs"]
    dkw = dict(pos=pos, slot=pos, approx_div=True, frac_out=frac_out)
    da_kernel = lambda: get_op("decode_attention", spec, "cuda")(
        dq, kc, vc, kn, vn, **dkw)
    da_ms = da_t["ms"]
    da_eager_ms = gpu_time_ms(da_kernel, iters=200)
    da_exact_ms = gpu_graph_time_ms(
        lambda: get_op("decode_attention", spec, "cuda")(
            dq, kc, vc, kn, vn, **dict(dkw, approx_div=False)), iters=200)
    # an empty history (pos 0): what a launch costs before any cache slot
    da_pos0_ms = gpu_graph_time_ms(
        lambda: get_op("decode_attention", spec, "cuda")(
            dq, kc, vc, kn, vn, **dict(dkw, pos=0, slot=0)), iters=200)
    da_plain_ms = gpu_time_ms(lambda: get_op("decode_attention", spec, "ref")(
        dq, kc, vc, kn, vn, **dkw), iters=50)
    da_lib_ms, da_bound, da_by = (da_t["library_ms"], da_t["bound_ms"],
                                  da_t["bound_by"])
    log(f"  decode_attention ({BATCH},{Smax},{KV},{dh}) G {G} bf16 pos {pos}:"
        f" {da_ms:.5f} ms (graph, planner's cluster {da_t['cluster']}; "
        f"exact divide {da_exact_ms:.5f}; pos 0 {da_pos0_ms:.5f}), "
        f"{da_eager_ms:.5f} ms (eager), plain {da_plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {da_lib_ms:.5f} ms, bound "
        f"{da_bound:.6f} ms; by cluster size "
        + ", ".join(f"{c}: {t:.5f}" for c, t in da_t["ms_by_cluster"].items()))
    # a history near smollm-360m's context length: cache 2048, pos 2047
    long_t = time_decode_attention(dev, gen, BATCH, 2048, KV, G, dh, 2047,
                                   spec, frac_out, int_rate, clusters=sizes)
    log(f"  decode_attention ({BATCH},2048,{KV},{dh}) G {G} bf16 pos 2047: "
        f"{long_t['ms']:.5f} ms (graph, planner's cluster "
        f"{long_t['cluster']}), scaled_dot_product_attention "
        f"{long_t['library_ms']:.5f} ms, bound {long_t['bound_ms']:.6f} ms; "
        "by cluster size " + ", ".join(
            f"{c}: {t:.5f}" for c, t in long_t["ms_by_cluster"].items()))

    # serving: prefill, steady-state decode step, end to end
    # where the prefill's card time goes: kernels by name, from a trace
    prefill_dev = device_time_by_kernel(
        lambda: lm.prefill(params, {"tokens": prompts}))
    if prefill_dev is None:
        log("  prefill: the trace showed no device activity")
    else:
        prefill_busy_ms, by = prefill_dev
        prefill_att_ms = sum(ms for name, (_, ms) in by.items()
                             if "flash_kernel" in name)
        top = sorted(by.items(), key=lambda kv: -kv[1][1])[:8]
        log(f"  prefill: {prefill_busy_ms:.3f} ms of card in "
            f"{sum(n for n, _ in by.values())} kernels and copies (profiler "
            f"trace), attention kernel {prefill_att_ms:.3f} ms; the largest: "
            + "; ".join(f"{name[:70]} x{n} {ms:.3f} ms"
                        for name, (n, ms) in top))
    # the prefill with each attention schedule pinned, in turns (depth 0,
    # ring, ring, depth 0), best of each: what the schedule moves end to end
    tuned = export_autotune_cache()
    pinned_prefill = {}
    for block in (fa.DEFAULT_BLOCK, ATTENTION_RING_BLOCK,
                  ATTENTION_RING_BLOCK, fa.DEFAULT_BLOCK):
        _pin_blocks("attention", block)
        t = time_callable(lm.prefill, params, {"tokens": prompts}, iters=5)
        pinned_prefill[block] = min(pinned_prefill.get(block, t.best_s),
                                    t.best_s)
    clear_autotune_cache()
    preload_autotune_cache(tuned)
    # the prefill and the decode step, eager and captured, and generate
    prefill_times = time_prefill(lm, params, prompts, served)
    step_times = time_decode_step(lm, params, prompts, served)
    served["decode_step_device_kernels"] = \
        step_times["decode_step_device_kernels"]
    times = {
        **prefill_times,
        "prefill_eager_ms_attention_depth0":
            pinned_prefill[fa.DEFAULT_BLOCK] * 1e3,
        "prefill_eager_ms_attention_ring":
            pinned_prefill[ATTENTION_RING_BLOCK] * 1e3,
        **step_times,
        "first_generate_s": served["first_run_s"],
        "elemwise_eager_call_ms": ew_eager_ms,
        "decode_attention_eager_call_ms": da_eager_ms,
        "decode_attention_exact_div_ms": da_exact_ms,
        "decode_attention_pos0_ms": da_pos0_ms,
        "decode_attention_cache2048_ms": long_t["ms"],
        "decode_attention_cache2048_sdpa_ms": long_t["library_ms"],
        "decode_attention_cache2048_bound_ms": long_t["bound_ms"],
        "flash_attention_eager_call_ms": att_eager_by[fa.DEFAULT_BLOCK],
        "flash_attention_pipelined_eager_call_ms":
            att_eager_by[ATTENTION_RING_BLOCK],
        "elemwise_16M_lanes_ms": ew_big_ms,
        "elemwise_16M_lanes_bound_ms": 12 * big / HBM_BYTES_PER_S * 1e3,
        "attention_tflops": att_flops / (att_ms * 1e-3) / 1e12,
        "attention_pipelined_tflops": att_flops / (ring_ms * 1e-3) / 1e12,
        "attention_exact_div_ms": att_exact_ms,
        "attention_over_sdpa": att_ms / att_lib_ms,
        "attention_pipelined_over_sdpa": ring_ms / att_lib_ms,
    }
    if prefill_dev is not None:
        times["prefill_device_ms"] = prefill_busy_ms
        times["prefill_attention_device_ms"] = prefill_att_ms
    kernels = [
        {"name": "elemwise", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/elemwise.cu",
         "replaces": "src/repro/kernels/elemwise.py:33",
         "shape": f"({lanes},) uint32 lanes (measure_error's 8-bit square), "
                  f"div, w8 cb6 fo{DIV_FRAC_OUT}",
         "ms": ew_ms, "plain_ms": ew_plain_ms,
         "bound_ms": max(ew_bytes_ms, ew_ops_ms),
         "bound_by": "bytes" if ew_bytes_ms >= ew_ops_ms else "operations",
         "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:145",
         "shape": f"q ({BATCH * H},{PROMPT},{dh}) kv ({BATCH * KV},{PROMPT},"
                  f"{dh}) bf16 causal simdive w{spec.width} "
                  f"cb{spec.coeff_bits} fo{frac_out}",
         "block": list(fa.DEFAULT_BLOCK),
         "ms": att_ms, "plain_ms": att_plain_ms,
         "bound_ms": max(att_ops_ms, att_bytes_ms),
         "bound_by": "operations" if att_ops_ms >= att_bytes_ms else "bytes",
         "library_ms": att_lib_ms},
        {"name": "flash_attention_pipelined", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:175",
         "shape": f"q ({BATCH * H},{PROMPT},{dh}) kv ({BATCH * KV},{PROMPT},"
                  f"{dh}) bf16 causal simdive w{spec.width} "
                  f"cb{spec.coeff_bits} fo{frac_out}",
         "block": list(ATTENTION_RING_BLOCK),
         "ms": ring_ms, "plain_ms": att_plain_ms,
         "bound_ms": max(att_ops_ms, att_bytes_ms),
         "bound_by": "operations" if att_ops_ms >= att_bytes_ms else "bytes",
         "library_ms": att_lib_ms,
         "ms_by_depth": {str(b[2]): t for b, t in att_ms_by.items()
                         if len(b) == 3}},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
         "replaces": "src/repro/models/layers.py:351",
         "note": "no TPU kernel: the reference's jnp decode_attention_append "
                 "around elemwise_pallas (src/repro/kernels/elemwise.py:67)",
         "shape": f"q ({BATCH},{KV},{G},{dh}) caches ({BATCH},{Smax},{KV},"
                  f"{dh}) bf16 pos {pos} simdive w{spec.width} "
                  f"cb{spec.coeff_bits} fo{frac_out}",
         "cluster": da_t["cluster"],
         "ms": da_ms, "plain_ms": da_plain_ms, "bound_ms": da_bound,
         "bound_by": da_by, "library_ms": da_lib_ms, "eager_ms": da_eager_ms,
         "ms_by_cluster": {str(c): t
                           for c, t in da_t["ms_by_cluster"].items()},
         "cache2048": {k: long_t[k] for k in (
             "cluster", "ms", "library_ms", "bound_ms", "bound_by")}
         | {"ms_by_cluster": {str(c): t for c, t in
                              long_t["ms_by_cluster"].items()}}},
    ]
    return kernels, times


def measure_logmatmul(dev, plain_ms, int_rate):
    """Both schedules at the main path's shapes. Per (M, K, N): every
    registered block (the skinny tiles and the large ones) by graph
    replay, the fastest of each schedule kept,
    its eager per-call time, the plain version's time (phase 3), the bound
    and the exact bf16 ``torch.matmul`` of the same shape as context. The
    kernel lines sum the seven linears of one layer at M = 2048."""
    import torch
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import get_op
    from repro_torch.kernels import logmatmul as lm

    spec = SimdiveSpec(width=8, coeff_bits=6)
    registered = blocks = get_op("matmul_int", spec).entry.block_candidates
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    shapes = {}
    for M in (2048, 4):
        for K, N in sorted({(k, n) for _, k, n in LINEARS}):
            x = torch.randint(-255, 256, (M, K), generator=gen, device=dev,
                              dtype=torch.int32)
            w = torch.randint(-255, 256, (K, N), generator=gen, device=dev,
                              dtype=torch.int32)
            iters = 3 if M * K * N > 1e8 else 50
            by_block = {b: gpu_graph_time_ms(
                lambda b=b: lm.logmatmul_cuda(x, w, spec, b), iters=iters)
                for b in blocks}
            row = {"by_block": {str(b): t for b, t in by_block.items()}}
            for sched, depth0 in (("logmatmul", True),
                                  ("logmatmul_pipelined", False)):
                best = min((b for b in registered if (b[4] == 0) == depth0),
                           key=by_block.get)
                row[sched] = {"block": best, "ms": by_block[best],
                              "eager_ms": gpu_time_ms(
                                  lambda b=best: lm.logmatmul_cuda(x, w, spec,
                                                                   b),
                                  iters=iters)}
            xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
            row["exact_linear_ms"] = gpu_graph_time_ms(lambda: xb @ wb,
                                                       iters=20)
            # what zeroing the (M, N) output costs alone, as a split of K
            # needs before its atomics (a PyTorch fill kernel standing in
            # for the launch's cudaMemsetAsync)
            zeros = torch.empty((M, N), dtype=torch.int32, device=dev)
            row["zero_out_ms"] = gpu_graph_time_ms(zeros.zero_, iters=50)
            row["ops_ms"] = logmatmul_ops_ms(M, K, N, int_rate)
            row["ops_ms_superseded"] = logmatmul_ops_ms_superseded(
                M, K, N, int_rate)
            row["bytes_ms"] = (M * K + K * N + M * N) * 4 \
                / HBM_BYTES_PER_S * 1e3
            row["plain_ms"] = plain_ms[(M, K, N)]
            shapes[(M, K, N)] = row
            log(f"  logmatmul ({M},{K})@({K},{N}): depth 0 "
                f"{row['logmatmul']['ms']:.4f} ms {row['logmatmul']['block']}"
                f", pipelined {row['logmatmul_pipelined']['ms']:.4f} ms "
                f"{row['logmatmul_pipelined']['block']}, bound "
                f"{max(row['ops_ms'], row['bytes_ms']):.4f} ms, plain "
                f"{row['plain_ms']:.1f} ms, exact bf16 "
                f"{row['exact_linear_ms']:.4f} ms")

    def layer(M, key):
        return sum(shapes[(M, k, n)][key] for _, k, n in LINEARS)

    def layer_sched(M, sched, key):
        return sum(shapes[(M, k, n)][sched][key] for _, k, n in LINEARS)

    def layer_by_block(M):
        return {str(b): sum(shapes[(M, k, n)]["by_block"][str(b)]
                            for _, k, n in LINEARS) for b in blocks}

    for M in (4, 2048):
        log(f"  logmatmul, one layer's 7 linears at M = {M}, by block: "
            + "; ".join(f"{b} {t:.5f} ms"
                        for b, t in layer_by_block(M).items()))

    kernels, times = [], {}
    for sched, replaces in (
            ("logmatmul", "src/repro/kernels/logmatmul.py:101"),
            ("logmatmul_pipelined", "src/repro/kernels/logmatmul.py:113")):
        ops, nbytes = layer(2048, "ops_ms"), layer(2048, "bytes_ms")
        kernels.append({
            "name": sched, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/logmatmul.cu",
            "replaces": replaces,
            "shape": "one layer's 7 linears, x (2048, K) int32 @ w (K, N) "
                     "int32, (K, N) = 2x(960,960) 2x(960,320) 2x(960,2560) "
                     "(2560,960), w8 cb6",
            "ms": layer_sched(2048, sched, "ms"),
            "plain_ms": layer(2048, "plain_ms"),
            "bound_ms": max(ops, nbytes),
            "bound_by": "operations" if ops >= nbytes else "bytes",
            "bound_ms_superseded": max(layer(2048, "ops_ms_superseded"),
                                       nbytes),
            "library_ms": None,
            "eager_ms": layer_sched(2048, sched, "eager_ms"),
            "decode_layer_ms": layer_sched(4, sched, "ms"),
            "decode_layer_bound_ms": max(layer(4, "ops_ms"),
                                         layer(4, "bytes_ms")),
            "decode_layer_bound_ms_superseded": max(
                layer(4, "ops_ms_superseded"), layer(4, "bytes_ms")),
            "decode_layer_plain_ms": layer(4, "plain_ms"),
            "blocks": {f"{M},{K},{N}": list(r[sched]["block"])
                       for (M, K, N), r in shapes.items()},
            "decode_blocks": {f"{K},{N}": list(r[sched]["block"])
                              for (M, K, N), r in shapes.items() if M == 4},
            "decode_layer_ms_by_block": layer_by_block(4),
            "prefill_layer_ms_by_block": layer_by_block(2048),
        })
    times["exact_linear_layer_prefill_ms"] = layer(2048, "exact_linear_ms")
    times["exact_linear_layer_decode_ms"] = layer(4, "exact_linear_ms")
    times["zero_out_layer_decode_ms"] = layer(4, "zero_out_ms")
    times["int32_ops_per_s"] = int_rate
    return kernels, times, {f"{k}": v for k, v in shapes.items()}


def measure_packed(packed, int_rate):
    """The packed kernel at both sizes of phase 4, for each op: device time
    by graph replay, the eager per-call time, the plain version's time and
    the bound; the kernel alone at each of PACKED_BLOCK_SWEEP's threads per
    block (graph replay, mul); at the full size also the elemwise kernel and
    an exact ``torch.mul`` on the same lanes unpacked (yardsticks: no
    PyTorch call computes a SIMDive product). Returns the kernels-line
    row."""
    import torch
    from repro_torch.core.simd_pack import unpack
    from repro_torch.kernels import get_op, simdive_packed
    from repro_torch.kernels.packed_simd import packed_cuda

    spec, kw, operands = packed["spec"], packed["kw"], packed["operands"]
    by = {}
    for size, (M, Nw) in PACKED_SIZES.items():
        aw, bw, mw = operands[size]
        words = M * Nw
        big = size == "full"
        for op in kw:
            fn = (lambda aw=aw, bw=bw, op=op: simdive_packed(
                aw, bw, spec, op=op, mode=mw if op == "mixed" else None,
                **kw[op]))
            plain = (lambda aw=aw, bw=bw, op=op: get_op(
                "packed", spec, "ref")(aw, bw, op=op,
                                       mode=mw if op == "mixed" else None,
                                       **kw[op]))
            bytes_ms = PACKED_BYTES_PER_WORD[op] * words / HBM_BYTES_PER_S \
                * 1e3
            ops_ms = PACKED_OPS_PER_LANE[op] * 4 * words / int_rate * 1e3
            row = {"ms": gpu_graph_time_ms(fn, iters=20 if big else 200),
                   "eager_ms": gpu_time_ms(fn, iters=20 if big else 200),
                   "plain_ms": gpu_time_ms(plain, iters=2 if big else 5,
                                           warmup=1),
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                               else "operations",
                   "bytes_ms": bytes_ms, "ops_ms": ops_ms}
            torch.cuda.empty_cache()
            by[f"{size} {op}"] = row
            log(f"  packed {size} ({M},{Nw}) words {op}: {row['ms']:.5f} ms "
                f"(graph), {row['eager_ms']:.5f} ms (eager), bound "
                f"{row['bound_ms']:.5f} ms ({row['bound_by']}), plain "
                f"{row['plain_ms']:.3f} ms")
        # threads per block, in turns: 256, 128, 512, 256
        sweep = {}
        for block in ((256,), *(b for b in PACKED_BLOCK_SWEEP
                                if b != (256,)), (256,)):
            sweep.setdefault(str(block[0]), []).append(gpu_graph_time_ms(
                lambda aw=aw, bw=bw, block=block: packed_cuda(
                    aw, bw, spec, op="mul", block=block),
                iters=20 if big else 200))
        by[f"{size} mul"]["block_sweep_ms"] = sweep
        log(f"  packed {size} mul by threads per block (ms, graph): "
            + ", ".join(f"{k}: {v}" for k, v in sweep.items()))
    # yardsticks on the full size's lanes, unpacked: 12 bytes a lane
    aw, bw, _ = operands["full"]
    a_l, b_l = unpack(aw, 8), unpack(bw, 8)
    lanes = a_l.numel()
    ew_ms = gpu_graph_time_ms(lambda: get_op("elemwise", spec, "cuda")(
        a_l, b_l, op="mul"), iters=20)
    a32, b32 = a_l.view(torch.int32), b_l.view(torch.int32)
    exact_ms = gpu_graph_time_ms(lambda: a32 * b32, iters=20)
    ew_bound_ms = max(12 * lanes / HBM_BYTES_PER_S * 1e3,
                      (ELEMWISE_OPS_PER_LANE * lanes) / int_rate * 1e3)
    log(f"  yardsticks on the same {lanes} lanes unpacked: elemwise kernel "
        f"mul {ew_ms:.5f} ms (its bytes bound "
        f"{12 * lanes / HBM_BYTES_PER_S * 1e3:.5f} ms), exact torch.mul "
        f"{exact_ms:.5f} ms")
    main = by["full mul"]
    return {
        "name": "packed", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/packed_simd.cu",
        "replaces": "src/repro/kernels/packed_simd.py:62",
        "shape": f"{PACKED_SIZES['full']} uint32 words = "
                 f"{4 * PACKED_SIZES['full'][0] * PACKED_SIZES['full'][1]} "
                 f"8-bit lanes, mul, w{spec.width} cb{spec.coeff_bits}",
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "eager_ms": main["eager_ms"],
        "by_size_op": by,
        "elemwise_same_lanes_ms": ew_ms,
        "elemwise_same_lanes_bound_ms": ew_bound_ms,
        "exact_torch_mul_same_lanes_ms": exact_ms,
    }


def time_prefill(lm, params, prompts, served, *, prefix="", iters=5):
    """The prefill of one path, eager (``prefill_eager_*``, ``lm.prefill``)
    and captured (``prefill_captured_*``, the served prefill, one
    CUDA-graph replay), each timed by ``time_callable`` (CUDA events around
    a call, host work included); captured prefills back to back
    (``prefill_replay_ms``: the host runs ahead, the card sets the pace);
    the host's own time a call, no synchronise inside (``prefill_host_ms``
    captured, ``prefill_eager_host_ms``); the first capture (phase 4) and
    one on a warm process (``prefill_capture_s``, warm run included); the
    device kernels of one eager prefill and of one replay (profiler trace);
    and the reserved memory the captured prefill holds (phase 4: its
    prompt buffer and its graph's pool, which keeps the prefill's
    activations, logits and cache)."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.metrics.timing import time_callable

    pstep = serve.make_prefill(lm)
    batch = {"tokens": prompts}
    # the autotune cache was preloaded, or the params changed, since the
    # last capture: the next call captures again, kernels built and blocks
    # settled
    captures = pstep.captures
    pstep(params, batch)
    torch.cuda.synchronize()
    require(pstep.captures == captures + 1,
            f"{prefix}prefill: no capture after the autotune cache was "
            "preloaded")
    capture_s = pstep.capture_s
    eager_t = time_callable(lm.prefill, params, batch, iters=iters,
                            items=BATCH * PROMPT)
    captured_t = time_callable(pstep, params, batch, iters=iters,
                               items=BATCH * PROMPT)
    replay_ms = gpu_time_ms(lambda: pstep(params, batch), iters=2 * iters)
    eager_host_ms = host_ms(lambda: lm.prefill(params, batch), iters)
    captured_host_ms = host_ms(lambda: pstep(params, batch), iters)
    eager_kernels = count_device_kernels(lambda: lm.prefill(params, batch))
    replay_kernels = count_device_kernels(lambda: pstep(params, batch))
    log(f"  {prefix}prefill: {eager_kernels} device kernels and copies in "
        f"one eager prefill, {replay_kernels} in one replay of the captured "
        "prefill (profiler trace; None = the trace showed no device "
        "activity)")
    require(pstep.captures == captures + 1,
            f"{prefix}prefill: captured again while timed")
    eager_ms, captured_ms = eager_t.best_s * 1e3, captured_t.best_s * 1e3
    return {
        f"{prefix}prefill_eager_ms": eager_ms,
        f"{prefix}prefill_eager_tok_per_s": BATCH * PROMPT / eager_t.best_s,
        f"{prefix}prefill_captured_ms": captured_ms,
        f"{prefix}prefill_captured_tok_per_s":
            BATCH * PROMPT / captured_t.best_s,
        f"{prefix}prefill_replay_ms": replay_ms,
        f"{prefix}prefill_captured_host_share": 1.0 - replay_ms / captured_ms,
        f"{prefix}prefill_eager_host_ms": eager_host_ms,
        f"{prefix}prefill_host_ms": captured_host_ms,
        f"{prefix}prefill_first_capture_s": served["prefill_first_capture_s"],
        f"{prefix}prefill_capture_s": capture_s,
        f"{prefix}prefill_device_kernels": eager_kernels or 0,
        f"{prefix}prefill_replay_device_kernels": replay_kernels or 0,
        f"{prefix}prefill_held_bytes": served["prefill_held_bytes"],
    }


def time_decode_step(lm, params, prompts, served, *, prefix="",
                     step_iters=10, graph_iters=3, gen_iters=2):
    """The decode step and generate of one path, eager (``*_eager_*``,
    ``lm.decode_step`` / ``prefill_fn=lm.prefill, decode_fn=
    lm.decode_step``) and captured (``*_captured_*``, the served step, one
    CUDA-graph replay a token, behind the served prefill; and
    ``generate_prefill_eager_ms``, the served step behind the eager
    prefill),
    timed by ``time_callable`` (CUDA events around each call, host work
    included); the card alone (``decode_step_device_ms``: many eager steps
    replayed from one graph; ``decode_step_replay_ms``: captured steps
    back to back, the host running ahead); the host share of each (one
    less the card's time over the step's, each against its own) and the
    host's own time a call (``*_host_ms``, no synchronise inside); the
    time of the
    first capture (phase 4) and of one on a warm process; the device
    kernels of one eager step and of one replay (profiler trace); the peak
    memory the card reports for each generate (``max_memory_allocated``,
    which a graph's private pool does not enter once its capture is over)
    and the memory the captured step holds after its first generate
    (phase 4: reserved memory after ``empty_cache``, before and after: its
    cache buffers, its graph's pool, its stream's cuBLAS workspace)."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.metrics.timing import time_callable

    max_seq = PROMPT + GEN
    step = serve.make_decode_step(lm)
    logits, pre = lm.prefill(params, {"tokens": prompts})
    cache = serve.merge_cache(lm.empty_cache(BATCH, max_seq), pre)
    own = serve.merge_cache(step.empty_cache(BATCH, max_seq), pre)
    tok = logits.argmax(-1)
    del pre
    # the autotune cache was cleared and preloaded since the last capture:
    # the next call captures again, kernels built and blocks settled
    captures = step.captures
    step(params, own, tok, PROMPT)
    torch.cuda.synchronize()
    require(step.captures == captures + 1,
            f"{prefix}decode step: no capture after the autotune cache was "
            "preloaded")
    capture_s = step.capture_s
    eager_t = time_callable(lm.decode_step, params, cache, tok, PROMPT,
                            iters=step_iters, warmup=1, items=BATCH)
    captured_t = time_callable(step, params, own, tok, PROMPT,
                               iters=step_iters, warmup=1, items=BATCH)
    # back-to-back replays: the host runs ahead, the card sets the pace
    replay_ms = gpu_time_ms(lambda: step(params, own, tok, PROMPT),
                            iters=2 * step_iters)
    eager_host_ms = host_ms(lambda: lm.decode_step(params, cache, tok, PROMPT),
                            step_iters)
    captured_host_ms = host_ms(lambda: step(params, own, tok, PROMPT),
                               step_iters)
    # the same step with the host taken out: what the card alone needs
    device_ms = gpu_graph_time_ms(
        lambda: lm.decode_step(params, cache, tok, PROMPT), iters=graph_iters)
    eager_kernels = count_device_kernels(
        lambda: lm.decode_step(params, cache, tok, PROMPT))
    replay_kernels = count_device_kernels(
        lambda: step(params, own, tok, PROMPT))
    log(f"  {prefix}decode step: {eager_kernels} device kernels and copies "
        f"in one eager step, {replay_kernels} in one replay of the captured "
        "step (profiler trace; None = the trace showed no device activity)")
    require(step.captures == captures + 1,
            f"{prefix}decode step: captured again while timed")

    def generate_run(**kw):
        return lambda: serve.generate(lm, params, prompts, max_seq, GEN, **kw)

    def timed_peak(fn):
        """``time_callable``'s timing of ``fn`` and the peak memory over
        its calls (warm: every graph is captured by now), one window."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time_callable(fn, iters=gen_iters, items=BATCH * GEN,
                          device=lm.device)
        torch.cuda.synchronize()
        return t, torch.cuda.max_memory_allocated()

    eager = dict(prefill_fn=lm.prefill, decode_fn=lm.decode_step)
    gen_captured, peak_captured = timed_peak(generate_run())
    gen_eager, peak_eager = timed_peak(generate_run(**eager))
    # the captured step behind the eager prefill: PR 21's served generate
    gen_prefill_eager = time_callable(generate_run(prefill_fn=lm.prefill),
                                      iters=gen_iters, items=BATCH * GEN,
                                      device=lm.device)
    eager_ms, captured_ms = eager_t.best_s * 1e3, captured_t.best_s * 1e3
    return {
        f"{prefix}decode_step_eager_ms": eager_ms,
        f"{prefix}decode_eager_tok_per_s": BATCH / eager_t.best_s,
        f"{prefix}decode_step_captured_ms": captured_ms,
        f"{prefix}decode_captured_tok_per_s": BATCH / captured_t.best_s,
        f"{prefix}decode_step_device_ms": device_ms,
        f"{prefix}decode_step_eager_host_share": 1.0 - device_ms / eager_ms,
        f"{prefix}decode_step_replay_ms": replay_ms,
        f"{prefix}decode_step_captured_host_share":
            1.0 - replay_ms / captured_ms,
        f"{prefix}decode_step_eager_host_ms": eager_host_ms,
        f"{prefix}decode_step_captured_host_ms": captured_host_ms,
        f"{prefix}decode_step_first_capture_s": served["first_capture_s"],
        f"{prefix}decode_step_capture_s": capture_s,
        f"{prefix}decode_step_device_kernels": eager_kernels or 0,
        f"{prefix}decode_step_replay_device_kernels": replay_kernels or 0,
        f"{prefix}generate_eager_ms": gen_eager.best_s * 1e3,
        f"{prefix}generate_eager_tok_per_s": BATCH * GEN / gen_eager.best_s,
        f"{prefix}generate_captured_ms": gen_captured.best_s * 1e3,
        f"{prefix}generate_captured_tok_per_s":
            BATCH * GEN / gen_captured.best_s,
        f"{prefix}generate_prefill_eager_ms": gen_prefill_eager.best_s * 1e3,
        f"{prefix}generate_eager_peak_bytes": peak_eager,
        f"{prefix}generate_captured_peak_bytes": peak_captured,
        f"{prefix}decode_step_held_bytes": served["held_bytes"],
    }


def measure_emulate(served_e, params, prompts):
    """Prefill and decode step (eager, captured, card) and generate (eager
    and captured) of the --emulate path."""
    lm_e = served_e["lm"]
    return {
        **time_prefill(lm_e, params, prompts, served_e, prefix="emulate_",
                       iters=2),
        **time_decode_step(lm_e, params, prompts, served_e,
                           prefix="emulate_", step_iters=5, graph_iters=2,
                           gen_iters=1),
        "emulate_first_generate_s": served_e["first_run_s"],
        "emulate_autotune_generate_s": served_e["tune_s"],
    }


# --------------------------------------------------------- phase 6: drill --
def _drill_scheduler(cfg, requests, *, params=None, eager=False,
                     shed_depth=DRILL_SHED, scrub_every=0):
    """The ``serve --scheduler`` drill's scheduler at full width, its
    queue filled with ``requests`` prompts drawn from seed 0 (the same
    prompts for every drill of this phase)."""
    import numpy as np
    from repro_torch.launch.scheduler import Scheduler, default_ladder

    sched = Scheduler(cfg, params, levels=default_ladder(cfg.approx),
                      batch=BATCH, prompt_len=PROMPT, max_seq=PROMPT + GEN,
                      shed_depth=shed_depth, recover_depth=DRILL_RECOVER,
                      seed=SEED, eager=eager, scrub_every=scrub_every)
    rng = np.random.default_rng(SEED)
    for _ in range(requests):
        sched.submit(rng.integers(0, cfg.vocab_size, PROMPT), max_new=GEN)
    return sched


def _captures(sched) -> list:
    """Each rung's prefill and step captures (none for an eager drill)."""
    if sched.eager:
        return []
    return [f.captures for f in sched.prefills + sched.steps]


def _drill_tokens(sched) -> dict:
    return {r.rid: list(r.tokens) for r in sched.done}


def run_drill(name, sched, requests):
    """Warm ``sched`` (one capture of each rung's prefill and step), run
    its drill with the launch counts zeroed just before and read just
    after, and hold it to the drill's gates. Returns its numbers."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t0 = wall_clock()
    warmed = sched.warmup()
    warm_s = wall_clock() - t0
    levels = [lv.name for lv in sched.levels]
    require(levels == ["fine", "shed", "recovery"],
            f"drill {name}: ladder {levels}")
    require(warmed == 2 * len(levels),
            f"drill {name}: warmup warmed {warmed}, expected 6")
    caps = _captures(sched)
    if not sched.eager:
        require(all(c >= 1 for c in caps),
                f"drill {name}: captures after warmup {caps}")
        for lvl, step in zip(levels, sched.steps):
            own = step.slot_cache(BATCH, PROMPT + GEN)
            require(own is not None and all(
                own[k].data_ptr() == sched.cache[k].data_ptr()
                for k in sched.cache),
                f"drill {name}: the {lvl} rung's step does not serve the "
                "scheduler's cache buffers")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = wall_clock()
    stats = sched.run()
    torch.cuda.synchronize()
    wall_s = wall_clock() - t0
    counts = launch_counts()
    require(_captures(sched) == caps,
            f"drill {name}: captures {caps} -> {_captures(sched)} during "
            "run()")
    require(stats["completed"] == requests and stats["failed"] == 0,
            f"drill {name}: {stats['completed']} of {requests} completed, "
            f"{stats['failed']} failed")
    kinds = [k for _, k, _ in stats["events"]]
    require(stats["sheds"] >= 1 and stats["recovers"] >= 1
            and kinds.index("shed") < kinds.index("recover"),
            f"drill {name}: sheds {stats['sheds']}, recovers "
            f"{stats['recovers']}, events {kinds}")
    per = stats["tokens_per_level"]
    served = sum(len(r.tokens) for r in sched.done)
    require(per["fine"] > 0 and per["shed"] > 0,
            f"drill {name}: tokens per rung {per}")
    require(sum(per.values()) == served == stats["tokens"]
            == requests * GEN,
            f"drill {name}: tokens per rung {per} vs {served} served")
    require(all(len(r.tokens) == GEN and 0 <= min(r.tokens)
                and max(r.tokens) < sched.cfg.vocab_size
                for r in sched.done),
            f"drill {name}: a request's tokens are out of shape or range")
    admissions = len({t for t, k, _ in stats["events"] if k == "admit"})
    n_layers = sched.cfg.n_layers
    require(_attention_launches(counts) == n_layers * admissions
            and counts["decode_attention"] == n_layers * stats["ticks"]
            and counts["elemwise"] == 0,
            f"drill {name}: launches {counts}, expected {n_layers} "
            f"attention per admission x {admissions} and {n_layers} "
            f"decode_attention per tick x {stats['ticks']} (every tick of "
            "the drill decodes)")
    log(f"  drill {name}: {stats['completed']} requests, {stats['ticks']} "
        f"ticks, {admissions} admissions, {stats['tokens']} tokens "
        f"{per}, sheds {stats['sheds']}, recovers {stats['recovers']}, "
        f"in {wall_s * 1e3:.1f} ms ({stats['tokens'] / wall_s:.1f} tok/s); "
        f"warmup {warm_s:.2f}s, captures {caps} (none during run()); "
        f"launches {counts}")
    return dict(stats=stats, wall_ms=wall_s * 1e3, warm_s=warm_s,
                tok_per_s=stats["tokens"] / wall_s, counts=counts,
                admissions=admissions)


def drill_equivalents(dev, cfg, params, tokens, events, tag) -> tuple:
    """The drill's other forms against its captured run's ``events`` and
    ``tokens``: (b) the same drill eager (``lm.prefill``,
    ``lm.decode_step``), bit for bit; (c) guarded (``ApproxConfig(guard=
    True)``) on every rung — each capture's eager warm run is checked, the
    captures pass unchecked, replays are not calls — with no trip and the
    same events and tokens; (d) one admission filling all four slots,
    each row's tokens equal to ``generate``'s at the fine rung on the
    same prompts. Returns the eager drill's numbers and the guard's
    counts."""
    from dataclasses import replace as dc_replace
    import numpy as np
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve

    who = f"drill {tag}".rstrip()
    eager = _drill_scheduler(cfg, DRILL_REQUESTS, params=params, eager=True)
    e = run_drill(f"{tag}eager", eager, DRILL_REQUESTS)
    require(e["stats"]["events"] == events,
            f"{who}: captured and eager events differ")
    require(_drill_tokens(eager) == tokens,
            f"{who}: captured and eager tokens differ")
    del eager

    seen = {"checked": 0, "under_capture": 0}
    real_check = registry._guard_check

    def counting(*args, **kw):
        seen["under_capture" if registry._capturing() else "checked"] += 1
        return real_check(*args, **kw)

    registry._guard_check = counting
    try:
        cfg_g = cfg.with_approx(dc_replace(cfg.approx, guard=True))
        guarded = _drill_scheduler(cfg_g, DRILL_REQUESTS, params=params)
        g = run_drill(f"{tag}guarded", guarded, DRILL_REQUESTS)
    finally:
        registry._guard_check = real_check
    require(g["stats"]["guard_trips"] == 0,
            f"{who}: guarded drill tripped {g['stats']['guard_trips']} "
            "times")
    require(g["stats"]["events"] == events and
            _drill_tokens(guarded) == tokens,
            f"{who}: the guarded drill differs from the unguarded one")
    require(seen["checked"] > 0 and seen["under_capture"] > 0,
            f"{who}: guard checks {seen}")
    log(f"  drill {tag}guarded: {seen['checked']} outputs checked (the warm "
        f"runs), {seen['under_capture']} passed under capture, no trip; "
        "events and tokens equal to the unguarded drill")
    del guarded

    four = _drill_scheduler(cfg, BATCH, params=params,
                            shed_depth=BATCH + 1)
    four.warmup()
    reqs = list(four.queue)
    four.run()
    want = serve.generate(four.lms[0], params, torch.from_numpy(
        np.stack([r.prompt for r in reqs])).to(dev), PROMPT + GEN, GEN)
    require(torch.equal(torch.tensor([r.tokens for r in reqs]), want.cpu()),
            f"{who}: four requests admitted together differ from "
            "generate")
    require(all(set(r.levels) == {"fine"} for r in reqs),
            f"{who}: the four-request drill left the fine rung")
    log(f"  {who}: four requests in one admission == generate on the "
        "same prompts (torch.equal)")
    return e, seen


def scheduler_drill(dev):
    """Phase 6: ``serve --scheduler``'s drill at full width, through the
    port's entry points (``launch.scheduler.Scheduler``), with its gates;
    then the same drill eager, guarded and with ``--emulate``."""
    import gc
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.metrics.timing import time_callable

    # the earlier phases' memoized prefills and steps (and their graphs)
    # go, so that the memory this phase reads is its own graphs'
    serve.make_prefill.cache_clear()
    serve.make_decode_step.cache_clear()
    gc.collect()
    cfg = serve.serving_config(ARCH, approx="simdive")
    out = {}

    # (a) the captured drill: 2 graphs a rung at warmup, none in run()
    sched = _drill_scheduler(cfg, DRILL_REQUESTS)
    params = sched.params
    reserved = reserved_bytes()
    drill = run_drill("captured", sched, DRILL_REQUESTS)
    # held after the drill: the six graphs' pools, the prefills' prompt
    # buffers, the steps' token / position buffers (the params and the
    # shared cache were allocated before the reading)
    held = reserved_bytes() - reserved
    out.update(drill_ms=drill["wall_ms"], drill_ticks=drill["stats"]["ticks"],
               drill_tok_per_s=drill["tok_per_s"],
               drill_warmup_s=drill["warm_s"], drill_graphs_held_bytes=held,
               drill_admissions=drill["admissions"])
    out["drill_launches"] = drill["counts"]
    # one replay of each rung's captured step, every row mid-generation
    for i, lv in enumerate(sched.levels):
        sched.level = i
        sched.pos[:] = PROMPT + GEN // 2
        t = sched.measure_decode(iters=20)
        out[f"drill_decode_step_ms_{lv.name}"] = t.best_s * 1e3
    sched.level = 0
    sched.pos[:] = 0
    # an admission: one replay of the fine rung's prefill and the insert
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (BATCH, PROMPT))).to(dev)
    slots = np.arange(BATCH)
    admit = lambda: serve.insert_cache(
        sched.cache, sched.prefills[0](params, {"tokens": prompts})[1], slots)
    out["drill_admission_ms"] = time_callable(
        admit, iters=10, device=dev).best_s * 1e3
    log("  drill: decode step, one replay a rung "
        + ", ".join(f"{lv.name} {out[f'drill_decode_step_ms_{lv.name}']:.3f}"
                    for lv in sched.levels)
        + f" ms; an admission (prefill replay + insert) "
        f"{out['drill_admission_ms']:.3f} ms; the six graphs hold {held} "
        "bytes")
    tokens = _drill_tokens(sched)
    events = drill["stats"]["events"]

    e, seen = drill_equivalents(dev, cfg, params, tokens, events, "")
    out["drill_eager_ms"] = e["wall_ms"]
    out["drill_guard_checks"] = seen

    # (e) --emulate: every linear through logmatmul on the fine and shed
    # rungs (the shed rung at Mitchell), fewer requests
    cfg_e = serve.serving_config(ARCH, approx="simdive", emulate=True)
    emu = _drill_scheduler(cfg_e, DRILL_EMULATE_REQUESTS, params=params)
    em = run_drill("--emulate", emu, DRILL_EMULATE_REQUESTS)
    linears = 7 * cfg_e.n_layers
    require(_matmul_launches(em["counts"]) == linears * (
        em["stats"]["ticks"] + em["admissions"]),
        f"drill --emulate: logmatmul launches {em['counts']}, expected "
        f"{linears} per prefill and per decode step (no tick ran the "
        "recovery rung's plain linears)")
    out.update(drill_emulate_ms=em["wall_ms"],
               drill_emulate_ticks=em["stats"]["ticks"],
               drill_emulate_tok_per_s=em["tok_per_s"],
               drill_emulate_warmup_s=em["warm_s"])
    out["drill_emulate_launches"] = em["counts"]
    del emu, sched
    gc.collect()
    return out


# ------------------------------------------------------- phase 7: faults --
def bits_equal(a, b) -> bool:
    """``torch.equal`` on the bit patterns: NaN equals the same NaN (an
    upset divider can drive later layers' floats out of range)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.contiguous().view(view),
                           b.contiguous().view(view))
    return torch.equal(a, b)


def fault_sites():
    """Phase 7 (a)'s sites as (op, width, FaultSpec): the campaign's
    ``default_sites(op, width, full=True)`` for mul and div at widths 8
    and 16, a table flip at bits 30 and 31 and a log flip at bit 31 for
    each (where the wrapping int32 sums of the anti-log differ from an
    int64 carrier's), and the campaign's pack site."""
    from repro_torch.faults.campaign import default_sites
    from repro_torch.faults.inject import FaultSpec

    out = []
    for w in (8, 16):
        for op in ("mul", "div"):
            specs = list(default_sites(op, w, full=True))
            for extra in (
                    FaultSpec(site="table", bit=30, kind="flip", op=op,
                              width=w),
                    FaultSpec(site="table", bit=31, kind="flip", op=op,
                              width=w),
                    FaultSpec(site="log", bit=31, kind="flip", width=w)):
                if extra not in specs:
                    specs.append(extra)
            out += [(op, w, s) for s in specs]
    out.append(("mul", 8, FaultSpec(site="pack", bit=7, kind="flip",
                                    width=16)))
    return out


def _fault_operands(dev):
    """Seeded operands of phase 7 (a), made once: lanes and packed words at
    widths 8 (the exhaustive square, zeros included) and 16 (65,536 pairs,
    a divisor below 2^8 for div, zeros spliced in); logmatmul's signed
    int32 (12, 512) @ (512, 384) at each width; attention inputs whose
    softmax sums are exact (q = 0, so every score is 0 and p = 1; v small
    integers), so that the kernels' (acc, l) equal the plain versions' and
    the divider — the one stage a fault reaches — decides every
    difference: with random inputs f32 summation order moves a quantized
    divider operand by one unit on ~0.1 % of the elements, which an upset
    coefficient turns into an arbitrary jump; and random (acc, l) for the
    finalize alone, held bit for bit."""
    import numpy as np
    import torch
    from repro_torch.core.simd_pack import pack
    from repro_torch.metrics import grid8, sample_uints

    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    ops = {}
    a8, b8 = grid8(include_zero=True)
    for w in (8, 16):
        for op in ("mul", "div"):
            if w == 8:
                a, b = a8, b8
            else:
                a, b = sample_uints(16, 65536, SEED,
                                    b_width=8 if op == "div" else 16)
                a, b = a.copy(), b.copy()
                a[:3], b[:3] = (0, 7, 0), (5, 0, 0)
            at = torch.from_numpy(a.astype(np.int64)).to(dev)
            bt = torch.from_numpy(b.astype(np.int64)).to(dev)
            ops[op, w] = dict(a=at, b=bt, aw=pack(at, w), bw=pack(bt, w))
    for w in (8, 16):
        hi = (1 << w) - 1
        ops["mm", w] = dict(
            x=torch.randint(-hi, hi + 1, (12, 512), generator=gen,
                            device=dev, dtype=torch.int32),
            w=torch.randint(-hi, hi + 1, (512, 384), generator=gen,
                            device=dev, dtype=torch.int32))
    bf16 = torch.bfloat16

    def ints(*shape):
        return torch.randint(-8, 9, shape, generator=gen,
                             device=dev).to(bf16)

    ops["flash"] = dict(
        q=torch.zeros(6, 128, 64, device=dev, dtype=bf16),
        k=torch.randn(2, 128, 64, generator=gen, device=dev).to(bf16),
        v=ints(2, 128, 64))
    ops["decode"] = dict(
        q=torch.zeros(4, 2, 3, 64, device=dev, dtype=bf16),
        kc=torch.randn(4, 128, 2, 64, generator=gen, device=dev).to(bf16),
        vc=ints(4, 128, 2, 64),
        kn=torch.randn(4, 1, 2, 64, generator=gen, device=dev).to(bf16),
        vn=ints(4, 1, 2, 64),
        pos=torch.tensor([0, 37, 64, 127], device=dev))
    ops["finalize"] = dict(
        acc=torch.randn(768, 64, generator=gen, device=dev) * 3,
        l=torch.rand(768, generator=gen, device=dev) * 40 + 0.5)
    return ops


def fault_kernels(dev) -> dict:
    """Phase 7 (a): every kernel against its plain version under each of
    :func:`fault_sites`, the same arming for both. ``elemwise`` and
    ``packed`` (against ``packed_word_op``, the kernel body as a plain
    function, which fires the pack hook) run every site at its op and
    width; ``logmatmul`` (every registered block — the skinny and the
    large tiles, both schedules — each in its int32 and its wide int64
    form) every site listed under mul; the attention
    kernels (``flash_attention`` depth 0 and ring, ``decode_attention``,
    the finalize alone) every width-16 site listed under div, at the
    divider's serving spec. Integers ``torch.equal``; attention within
    ``judge_attention``'s tolerances, the finalize bit for bit. Each
    kernel's output must have moved from its disarmed output exactly
    where the plain version's did. Every block takes every arming, a log
    fault above bit 19 included (whole 32-bit log words). Returns the
    counts."""
    import torch
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.faults.inject import fault_injection
    from repro_torch.kernels import datapath as dp
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import elemwise as ew
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import logmatmul as lm_k
    from repro_torch.kernels import packed_simd as ps
    from repro_torch.metrics import DIV_FRAC_OUT, PACKED_DIV_FRAC_OUT

    ops = _fault_operands(dev)
    serving = SimdiveSpec(width=16, coeff_bits=6)

    def cb(w):
        return 6 if w == 8 else 8

    def run_elemwise(op, w):
        spec, o = SimdiveSpec(width=w, coeff_bits=cb(w)), ops[op, w]
        fo = DIV_FRAC_OUT if op == "div" else 0
        return (ew.elemwise_cuda(o["a"], o["b"], spec, op=op, frac_out=fo),
                ew.elemwise_ref(o["a"], o["b"], spec, op=op, frac_out=fo))

    def run_packed(op, w):
        spec, o = SimdiveSpec(width=w, coeff_bits=cb(w)), ops[op, w]
        fo = (PACKED_DIV_FRAC_OUT if w == 8 else DIV_FRAC_OUT) \
            if op == "div" else 0
        tab = dp.op_table(op, w, spec.coeff_bits, spec.index_bits,
                          device=dev)
        return (ps.packed_cuda(o["aw"], o["bw"], spec, op=op, frac_out=fo),
                ps.packed_word_op(o["aw"], o["bw"], tab, spec=spec, op=op,
                                  frac_out=fo))

    def run_matmul(w, block, wide=False):
        spec, o = SimdiveSpec(width=w, coeff_bits=cb(w)), ops["mm", w]
        return lm_k.logmatmul_cuda(o["x"], o["w"], spec, block=block,
                                   wide=wide)

    def matmul_ref(w, wide=False):
        spec, o = SimdiveSpec(width=w, coeff_bits=cb(w)), ops["mm", w]
        ref = lm_k.logmatmul_wide_ref if wide else lm_k.logmatmul_ref
        return ref(o["x"], o["w"], spec)

    def run_attention():
        f, d, z = ops["flash"], ops["decode"], ops["finalize"]
        kw = dict(spec=serving, approx_div=True, causal=True, kv_group=3)
        dkw = dict(pos=d["pos"], slot=d["pos"], spec=serving,
                   approx_div=True, frac_out=15)
        tab = dp.op_table("div", 16, serving.coeff_bits, serving.index_bits,
                          device=dev)
        got = {"flash": fa.flash_attention_cuda(f["q"], f["k"], f["v"],
                                                block=fa.DEFAULT_BLOCK, **kw),
               "flash_ring": fa.flash_attention_cuda(
                   f["q"], f["k"], f["v"], block=ATTENTION_RING_BLOCK, **kw),
               "decode": da.decode_attention_cuda(
                   d["q"], d["kc"], d["vc"], d["kn"], d["vn"], **dkw),
               "finalize": fa.softmax_div_cuda(
                   z["acc"], z["l"], spec=serving, frac_out=15)[0]}
        flash_want = fa.flash_attention_ref(f["q"], f["k"], f["v"], **kw)
        want = {"flash": flash_want, "flash_ring": flash_want,
                "decode": da.decode_attention_ref(
                    d["q"], d["kc"], d["vc"], d["kn"], d["vn"], **dkw),
                "finalize": fa.softmax_div(
                    z["acc"], z["l"], tab, width=16,
                    index_bits=serving.index_bits, frac_out=15,
                    round_out=serving.round_output)}
        return got, want

    base = {}
    for op in ("mul", "div"):
        for w in (8, 16):
            base["elemwise", op, w] = run_elemwise(op, w)
            base["packed", op, w] = run_packed(op, w)
    for w in (8, 16):
        for wide in (False, True):
            base["matmul_ref", w, wide] = matmul_ref(w, wide)
            for block in lm_k.BLOCK_CANDIDATES:
                base["matmul", w, block, wide] = run_matmul(w, block, wide)
    base["attention"] = run_attention()
    torch.cuda.synchronize()

    stats = {"sites": 0, "checks": 0, "changed": {}, "high_log": 0}

    def held(name, got, want, got0, want0, *, approx=False):
        if approx:
            judge_attention(f"{name} under {spec}", got, want,
                            torch.bfloat16, True)
        else:
            require(bits_equal(got, want),
                    f"{name} under {spec}: the kernel differs from its plain "
                    f"version on {int((got != want).sum())} outputs")
        moved = not bits_equal(want, want0)
        require(moved == (not bits_equal(got, got0)),
                f"{name} under {spec}: the plain version's output "
                f"{'moved' if moved else 'stayed'} from its disarmed one, "
                "the kernel's did not")
        stats["checks"] += 1
        stats["changed"][name] = stats["changed"].get(name, 0) + int(moved)

    for op, w, spec in fault_sites():
        stats["sites"] += 1
        with fault_injection(spec):
            got, want = run_elemwise(op, w)
            held("elemwise", got, want, *base["elemwise", op, w])
            got, want = run_packed(op, w)
            held("packed", got, want, *base["packed", op, w])
            for wide in ((False, True) if op == "mul" else ()):
                want = matmul_ref(w, wide)
                for block in lm_k.BLOCK_CANDIDATES:
                    got = run_matmul(w, block, wide)
                    name = ("logmatmul" if not lm_k.split_block(block)[2]
                            else "logmatmul_pipelined")
                    if lm_k.is_large(block):
                        name += "_large"
                    if wide:
                        name += "_wide"
                    held(name, got, want, base["matmul", w, block, wide],
                         base["matmul_ref", w, wide])
                    stats["high_log"] += spec.site == "log" and spec.bit >= 20
            if op == "div" and w == 16:
                got, want = run_attention()
                got0, want0 = base["attention"]
                for name in got:
                    held(name, got[name], want[name], got0[name],
                         want0[name], approx=name != "finalize")
        torch.cuda.synchronize()
    require(stats["high_log"] > 0, "no logmatmul block ran under a log "
                                   "fault above bit 19")
    log(f"  (a) {stats['sites']} sites, {stats['checks']} kernel-vs-plain "
        f"checks under the same arming, all held; outputs moved at "
        f"{stats['changed']} sites; every block took every arming, "
        f"{stats['high_log']} runs under a log fault above bit 19")
    return stats


def _serve_outputs(fn, *args):
    """The logits a served call returns, cloned (a graph's buffer is
    rewritten by its next replay)."""
    return fn(*args)[0].clone()


def fault_graphs(dev, params) -> dict:
    """Phase 7 (b): captured graphs see an arming without a capture. For
    the divider-only path's fine rung (coeff_bits 6) and the scheduler's
    shed rung (Mitchell, coeff_bits 0), the prefill and the decode step
    are captured disarmed; then, for the chaos drill's table fault, the
    campaign's width-16 div table flip at bit 20 and a persistent
    width-16 log fault in turn, one replay of each under the arming
    equals the eager call bit for bit, and moves from the pristine replay
    exactly where the fault reaches what the graph reads: a log fault
    always, a table fault when the scrub finds the rung's div table
    upset (the chaos fault, a stuck-1 at bit 20, leaves every
    coefficient-6 entry as it is — all are negative, bit 20 already set —
    and upsets all 64 zero entries of Mitchell's). After the disarm every
    replay equals the pristine one bit for bit; no graph captures again
    and the div tables keep their ``data_ptr``."""
    import torch
    from repro_torch.core.error_lut import table_for
    from repro_torch.faults.inject import FaultSpec, set_faults
    from repro_torch.faults.scrub import scrub_tables
    from repro_torch.launch import serve
    from repro_torch.launch.scheduler import coarse_step
    from repro_torch.models import build

    cfg = serve.serving_config(ARCH, approx="simdive")
    max_seq = PROMPT + GEN
    gen = torch.Generator().manual_seed(SEED + 3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                     generator=gen).to(dev)}
    specs = (("chaos", FaultSpec(site="table", bit=20, kind="stuck1",
                                 op="div")),
             ("table flip", FaultSpec(site="table", bit=20, kind="flip",
                                      op="div", width=16)),
             ("log", FaultSpec(site="log", bit=8, kind="stuck1", width=16)))
    out = {}
    for rung, approx in (("fine", cfg.approx),
                         ("shed", coarse_step(cfg.approx))):
        lm = build(cfg.with_approx(approx))
        div = approx.resolve_attention()[0]
        ident = ("div", div.width, div.coeff_bits, div.index_bits)
        tab = table_for(*ident, device=dev, dtype=torch.int32)
        ptr = tab.data_ptr()
        step, pstep = serve.make_decode_step(lm), serve.make_prefill(lm)
        lg, pre = pstep(params, batch)
        pre0 = {k: v.clone() for k, v in pre.items()}
        tok = lg.argmax(-1)
        own = serve.merge_cache(step.empty_cache(BATCH, max_seq), pre0)
        step(params, own, tok, PROMPT)
        torch.cuda.synchronize()
        caps = (pstep.captures, step.captures)

        def replay():
            return (_serve_outputs(pstep, params, batch),
                    _serve_outputs(step, params, own, tok, PROMPT))

        pristine = replay()
        for name, spec in specs:
            set_faults([spec])
            try:
                reached = spec.site != "table" or bool(scrub_tables([ident]))
                got = replay()
                cache = serve.merge_cache(lm.empty_cache(BATCH, max_seq),
                                          pre0)
                eager = (lm.prefill(params, batch)[0],
                         lm.decode_step(params, cache, tok, PROMPT)[0])
                torch.cuda.synchronize()
            finally:
                set_faults([])
            again = replay()
            torch.cuda.synchronize()
            for i, what in enumerate(("prefill", "decode step")):
                require(bits_equal(got[i], eager[i]),
                        f"(b) {rung} rung, {name} fault: the captured "
                        f"{what}'s replay differs from the eager call under "
                        "the same arming")
                require((not bits_equal(got[i], pristine[i])) == reached,
                        f"(b) {rung} rung, {name} fault: the captured "
                        f"{what}'s replay {'did not move' if reached else 'moved'}"
                        f" from the pristine one, yet the fault "
                        f"{'reaches' if reached else 'does not reach'} it")
                require(bits_equal(again[i], pristine[i]),
                        f"(b) {rung} rung, {name} fault: after the disarm the "
                        f"captured {what} is not pristine again")
            out[f"{rung} {name}"] = int((got[1] != pristine[1]).sum())
        require((pstep.captures, step.captures) == caps,
                f"(b) {rung} rung: captures {caps} -> "
                f"{(pstep.captures, step.captures)}: an arming made a graph "
                "capture again")
        require(table_for(*ident, device=dev, dtype=torch.int32).data_ptr()
                == ptr == tab.data_ptr(),
                f"(b) {rung} rung: the div table's tensor moved")
        del lm, step, pstep, pre, pre0, own
    log(f"  (b) captured prefill and decode step of the fine and the shed "
        f"rung: under each arming one replay equals the eager call bit for "
        f"bit and moves exactly where the fault reaches the rung (step "
        f"logits moved: {out}); disarmed, bit-equal to pristine; no "
        "capture; the div tables' data_ptr unchanged")
    return out


def fault_campaign(dev) -> dict:
    """Phase 7 (c): ``faults.campaign.smoke`` on the card passes, and
    ``run_campaign`` gives on the card, site for site, the ``SiteResult``s
    it gives on the CPU."""
    from repro_torch.faults import campaign

    lines = []
    require(campaign.smoke(report=lines.append, device="cuda"),
            "(c) the campaign smoke failed on the card: " + "; ".join(lines))
    card = campaign.run_campaign(device="cuda", report=lambda _: None)
    host = campaign.run_campaign(device="cpu", report=lambda _: None)
    require(card["sites"] == host["sites"],
            "(c) the campaign's sites differ between the card and the CPU: "
            + "; ".join(f"{a} != {b}" for a, b in
                        zip(card["sites"], host["sites"]) if a != b))
    s = card["summary"]
    log(f"  (c) campaign smoke PASS on the card; run_campaign on the card "
        f"== on the CPU at all {s['n_sites']} sites ({s['guard_trips']} "
        f"guard trips, {s['table_scrub_detected']} of {s['table_sites']} "
        "table sites scrubbed)")
    return s


def run_chaos(name, sched, requests) -> dict:
    """Warm ``sched`` (scrub every tick), take one tick, arm the chaos
    drill's fault, run to the end, disarm — the launch counts zeroed just
    before and read just after — and hold it to the drill's gates: the
    reference's four rules, a retry, a ``scrub-dirty`` event naming a div
    table, no capture during the drill."""
    import torch
    from repro_torch.faults.inject import FaultSpec, set_faults
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import CHAOS_SPEC, chaos_violations

    sched.warmup()
    caps = _captures(sched)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = wall_clock()
    sched.step()
    set_faults([FaultSpec(**CHAOS_SPEC)])
    try:
        stats = sched.run()
    finally:
        set_faults([])
    torch.cuda.synchronize()
    wall_s = wall_clock() - t0
    counts = launch_counts()
    require(_captures(sched) == caps,
            f"chaos {name}: captures {caps} -> {_captures(sched)} during "
            "the drill")
    bad = chaos_violations(stats, requests)
    require(not bad, f"chaos {name}: " + "; ".join(bad))
    require(stats["retries"] >= 1, f"chaos {name}: no retry")
    dirty = [v for _, k, v in stats["events"] if k == "scrub-dirty"]
    require(bool(dirty) and dirty[0].startswith("div"),
            f"chaos {name}: scrub-dirty events {dirty}")
    log(f"  chaos {name}: {stats['completed']} requests, {stats['ticks']} "
        f"ticks, quarantines {stats['quarantines']}, retries "
        f"{stats['retries']}, tokens {stats['tokens_per_level']}, in "
        f"{wall_s * 1e3:.1f} ms ({stats['tokens'] / wall_s:.1f} tok/s); "
        f"scrub-dirty: {dirty[0]}; launches {counts}")
    return dict(stats=stats, wall_ms=wall_s * 1e3, counts=counts,
                tok_per_s=stats["tokens"] / wall_s)


def chaos_pair(cfg, params, requests, tag) -> tuple:
    """``serve --chaos`` for ``cfg``, captured and eager (scrub every tick,
    the chaos fault armed after the first tick), each with
    :func:`run_chaos`'s gates and equal event for event and token for
    token. Returns both drills' numbers and the scrub's identities."""
    sched = _drill_scheduler(cfg, requests, params=params, scrub_every=1)
    c = run_chaos(f"{tag}captured", sched, requests)
    eager = _drill_scheduler(cfg, requests, params=params, eager=True,
                             scrub_every=1)
    e = run_chaos(f"{tag}eager", eager, requests)
    require(e["stats"]["events"] == c["stats"]["events"]
            and _drill_tokens(eager) == _drill_tokens(sched),
            f"chaos {tag}: the captured drill's events or tokens differ "
            "from the eager drill's")
    log(f"  chaos {tag.rstrip(' _') or 'divider'}: captured == eager, event "
        "for event and token for token")
    return c, e, sched._scrub_idents


def chaos_drill(dev, params) -> dict:
    """Phase 7 (d): ``serve --chaos`` at full width — the scheduler drill
    with the table scrub every tick and the chaos fault armed after the
    first tick — captured and eager (events and tokens equal), divider
    only (12 requests) and ``--emulate`` (8); then the cost of one scrub
    of the ladder's tables (read-back included) and of arming and
    disarming."""
    import gc
    import torch
    from repro_torch.faults.inject import FaultSpec, set_faults
    from repro_torch.faults.scrub import scrub_tables
    from repro_torch.launch import serve

    serve.make_prefill.cache_clear()
    serve.make_decode_step.cache_clear()
    gc.collect()
    out = {}
    for tag, emulate, requests in (("", False, DRILL_REQUESTS),
                                   ("emulate_", True,
                                    DRILL_EMULATE_REQUESTS)):
        cfg = serve.serving_config(ARCH, approx="simdive", emulate=emulate)
        c, e, idents = chaos_pair(cfg, params, requests, tag)
        out.update({f"chaos_{tag}ms": c["wall_ms"],
                    f"chaos_{tag}ticks": c["stats"]["ticks"],
                    f"chaos_{tag}tok_per_s": c["tok_per_s"],
                    f"chaos_{tag}eager_ms": e["wall_ms"],
                    f"chaos_{tag}quarantines": c["stats"]["quarantines"],
                    f"chaos_{tag}retries": c["stats"]["retries"]})
        out[f"launches_chaos{'_' + tag[:-1] if tag else ''}"] = c["counts"]
        if not emulate:
            scrub_tables(idents)
            torch.cuda.synchronize()
            t0 = wall_clock()
            for _ in range(20):
                scrub_tables(idents)
            out["scrub_ms"] = (wall_clock() - t0) / 20 * 1e3
            spec = FaultSpec(**serve.CHAOS_SPEC)
            arm, disarm = [], []
            for _ in range(5):
                t0 = wall_clock()
                set_faults([spec])
                torch.cuda.synchronize()
                t1 = wall_clock()
                set_faults([])
                torch.cuda.synchronize()
                arm.append(t1 - t0)
                disarm.append(wall_clock() - t1)
            out["set_faults_arm_ms"] = min(arm) * 1e3
            out["set_faults_disarm_ms"] = min(disarm) * 1e3
            log(f"  one scrub of the ladder's {len(idents)} table "
                f"identities ({idents}), read-back included: "
                f"{out['scrub_ms']:.3f} ms; set_faults arm "
                f"{out['set_faults_arm_ms']:.3f} ms, disarm "
                f"{out['set_faults_disarm_ms']:.3f} ms (best of 5, "
                "synchronised)")
        gc.collect()
    return out


def main_shape_outputs(dev) -> dict:
    """Each kernel once at phase 3's main-path shapes on seeded inputs
    (elemwise: measure_error's 8-bit square, div; attention: the prefill's
    q (60, 512, 64), kv (20, 512, 64) bf16, both schedules;
    decode_attention: q (4, 5, 3, 64), caches (4, 544, 5, 64), pos 527;
    logmatmul: wq's (960, 960) at M = 4 and 2048, both schedules; packed:
    (17280, 960) words, mul), for phase 7's closing check."""
    import numpy as np
    import torch
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import elemwise as ew
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import logmatmul as lm_k
    from repro_torch.kernels import packed_simd as ps
    from repro_torch.metrics import DIV_FRAC_OUT, grid8

    gen = torch.Generator(device=dev).manual_seed(SEED + 52)
    serving = SimdiveSpec(width=16, coeff_bits=6)
    w8 = SimdiveSpec(width=8, coeff_bits=6)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    a, b = (torch.from_numpy(x.astype(np.int64)).to(dev) for x in grid8())
    out = {"elemwise": ew.elemwise_cuda(a, b, w8, op="div",
                                        frac_out=DIV_FRAC_OUT)}
    q, k, v = randn(60, 512, 64), randn(20, 512, 64), randn(20, 512, 64)
    for name, block in (("attention", fa.DEFAULT_BLOCK),
                        ("attention_ring", ATTENTION_RING_BLOCK)):
        out[name] = fa.flash_attention_cuda(
            q, k, v, spec=serving, approx_div=True, causal=True, kv_group=3,
            block=block)
    out["decode_attention"] = da.decode_attention_cuda(
        randn(4, 5, 3, 64), randn(4, 544, 5, 64), randn(4, 544, 5, 64),
        randn(4, 1, 5, 64), randn(4, 1, 5, 64), pos=527, slot=527,
        spec=serving, approx_div=True, frac_out=15)
    wq = torch.randint(-255, 256, (960, 960), generator=gen, device=dev,
                       dtype=torch.int32)
    for M in (4, 2048):
        x = torch.randint(-255, 256, (M, 960), generator=gen, device=dev,
                          dtype=torch.int32)
        for name, block in (("logmatmul", lm_k.DEFAULT_BLOCK),
                            ("logmatmul_ring", MATMUL_RING_BLOCK)):
            out[f"{name}_M{M}"] = lm_k.logmatmul_cuda(x, wq, w8, block=block)
    words = torch.randint(0, 1 << 32, PACKED_SIZES["full"], generator=gen,
                          device=dev, dtype=torch.int64)
    out["packed"] = ps.packed_cuda(words, words.flip(-1), w8, op="mul")
    torch.cuda.synchronize()
    return out


def fault_phase(dev, params) -> dict:
    """Phase 7: the fault subsystem on the card — (a) every kernel against
    its plain version under each armed site, (b) captured graphs seeing
    an arming without a capture, (c) the campaign on the card against the
    CPU, (d) the chaos drill at full width — closed by a check that
    nothing is armed and that phase 3's main-path shapes give their
    disarmed outputs again, bit for bit."""
    from repro_torch.faults.inject import active_faults

    before = main_shape_outputs(dev)
    out = {"fault_kernel_checks": fault_kernels(dev)["checks"]}
    out["fault_graph_step_moved"] = fault_graphs(dev, params)
    out["campaign"] = fault_campaign(dev)
    out.update(chaos_drill(dev, params))
    require(active_faults() == (), f"phase 7 left {active_faults()} armed")
    after = main_shape_outputs(dev)
    moved = [k for k in before if not bits_equal(before[k], after[k])]
    require(not moved, f"after phase 7 disarmed, {moved} differ from their "
                       "outputs before it")
    log(f"  disarmed: {len(before)} main-path kernel outputs bit-equal to "
        "theirs before phase 7")
    return out


# ------------------------------------------------------- phase 8: policy --
def segment_policy(*, matmul: bool, backend: str | None = None):
    """The layer-segmented policy phase 8 serves (POLICY_SEGMENTS): each
    segment's attention divider entry and, with ``matmul``, its matmul
    entry; the first segment's entries are the op defaults, the others
    one entry a layer. ``backend`` rewrites every entry's backend."""
    from repro_torch.core.approx import layer_label
    from repro_torch.tuning import PolicyEntry, TuningPolicy

    entries = []
    for i, (lo, hi, att, mm) in enumerate(POLICY_SEGMENTS):
        ops = [("attention", att)]
        if matmul:
            ops.append(("matmul", dict(mm, kernel="matmul")))
        layers = [None] if i == 0 else [layer_label(j) for j in range(lo, hi)]
        for op, kw in ops:
            kw = dict(kw, backend=backend or kw["backend"])
            entries += [PolicyEntry(op=op, layer=layer, **kw)
                        for layer in layers]
    return TuningPolicy(entries=tuple(entries),
                        meta=(("source", "chip_smoke.py phase 8"),))


def _saved_and_loaded(policy):
    """``policy`` through a simdive-policy/v1 file, as ``serve --policy``
    reads one; the loaded policy must equal it, JSON and all."""
    import os
    import tempfile
    from repro_torch.tuning import TuningPolicy

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "policy.json")
        policy.save(path)
        loaded = TuningPolicy.load(path)
    require(loaded == policy and loaded.to_json() == policy.to_json()
            and hash(loaded) == hash(policy),
            "a policy saved and loaded again differs from itself")
    return loaded


def policy_build(dev) -> dict:
    """Phase 8 (a): ``build_policy(("mul", "div"), width=8)`` and a width-16
    ``select_config`` on the card, each error sweep through the elemwise
    kernel (one launch per (op, width, coeff_bits) measured), held to the
    same calls on the plain versions (``device="cpu"``) to BENCH_REL_TOL;
    the policy saved and loaded again unchanged."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.tuning import build_policy, default_bench_path
    from repro_torch.tuning import frontier, select_config

    # phase 4 (e) measured two of these configs on the card already: the
    # memo goes, so that every (op, width, coeff_bits) runs here once
    frontier._ERROR_CACHE.clear()
    sweep = frontier.DEFAULT_COEFF_SWEEP
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = wall_clock()
    pol = build_policy(("mul", "div"), error_budget=POLICY_BUDGET, width=8,
                       device=dev)
    e16 = select_config("div", error_budget=POLICY_BUDGET, width=16,
                        device=dev)
    torch.cuda.synchronize()
    build_s = wall_clock() - t0
    counts = launch_counts()
    measured = 3 * len(sweep)                # mul w8, div w8, div w16
    require(counts["elemwise"] == measured
            and sum(counts.values()) == measured,
            f"policy build: launches {counts}, expected {measured} elemwise, "
            "one per (op, width, coeff_bits) measured")
    cpu = build_policy(("mul", "div"), error_budget=POLICY_BUDGET, width=8,
                       device="cpu").entries + (select_config(
                           "div", error_budget=POLICY_BUDGET, width=16,
                           device="cpu"),)
    for got, want in zip(pol.entries + (e16,), cpu):
        g, w = got.as_dict(), want.as_dict()
        gs, ws = g.pop("stats"), w.pop("stats")
        require(g == w and gs.keys() == ws.keys(),
                f"policy build: {got.label()} on the card, {want.label()} "
                "on the plain versions")
        for k, v in ws.items():
            ok = gs[k] == v if isinstance(v, str) else \
                abs(gs[k] - v) <= BENCH_REL_TOL * abs(v)
            require(ok, f"policy build {got.label()} {k}: {gs[k]!r} on the "
                        f"card, {v!r} on the plain versions")
        require(got.backend == "auto" and gs["are_pct"] <= POLICY_BUDGET,
                f"policy build: {got.label()} {gs}")
    policy = pol.with_entries(e16)
    _saved_and_loaded(policy)
    log(f"  (a) policy built on the card in {build_s:.2f}s ({measured} error "
        f"sweeps, launches {counts}; timings joined from "
        f"{default_bench_path() or 'no file: no BENCH_simdive_torch.json'}"
        "), entries equal to the plain versions' "
        f"to {BENCH_REL_TOL:g} relative:")
    log("\n".join(f"    {line}" for line in policy.render().splitlines()))
    return dict(policy_build_s=build_s, policy_build_launches=counts,
                policy_entries=[e.label() for e in policy.entries])


def check_policy_plan(cfg, policy, segments) -> None:
    """The serving plan's rows against the policy file: the expected layer
    segments, and each row's width / coeff_bits / index_bits / frac_out /
    backend the entry's that every layer of the row looks up (the
    backend mapped: 'pallas' serves as 'cuda'), or the config's own where
    no entry exists."""
    from repro_torch.core.approx import layer_label, serving_segments
    from repro_torch.launch import serve
    from repro_torch.tuning.select import port_backend

    approx = cfg.approx
    got = [(lo, hi) for lo, hi, _ in serving_segments(approx, cfg.n_layers)]
    require(got == list(segments), f"policy segments {got}, expected "
                                   f"{list(segments)}")
    plan = serve.resolve_serving_plan(cfg)
    require(len(plan) == 3 * len(segments), f"plan has {len(plan)} rows")
    for row in plan:
        entries = {policy.lookup(row.op, layer_label(i))
                   for i in range(row.layer_lo, row.layer_hi)}
        entries = {e and replace(e, layer=None) for e in entries}
        require(len(entries) == 1, f"plan row {row.label()}: its layers "
                                   "look up different configs")
        entry = entries.pop()
        if entry is None:
            spec, backend = approx.resolve(
                row.op, approx.div_width if row.op == "div" else None)
            want = (spec.width, spec.coeff_bits, spec.index_bits, backend,
                    approx.frac_out if row.op == "div" else None, "config")
        else:
            frac = None if row.op == "matmul" else approx.frac_out
            if row.op == "attention" and entry.frac_out:
                frac = entry.frac_out
            want = (entry.width, entry.coeff_bits, entry.index_bits,
                    port_backend(entry.backend), frac, "policy")
        have = (row.width, row.coeff_bits, row.index_bits, row.backend,
                row.frac_out, row.source)
        require(have == want, f"plan row {row.label()}: {have}, the file "
                              f"says {want}")


def policy_kernels(dev, cfg) -> dict:
    """``flash_attention`` (both registered schedules) and
    ``decode_attention`` against their plain versions at every attention
    divider spec the served policy resolves to, at the serving shapes:
    the prefill's q (60, 512, 64), kv (20, 512, 64) bf16, causal, and the
    decode step's q (4, 5, 3, 64), caches (4, 544, 5, 64), pos 527 (three
    draws pooled, as phase 3 judges that shape). Returns the worst error
    per kernel."""
    import torch
    from repro_torch.core.approx import serving_segments
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 81)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    specs = []
    for _, _, acfg in serving_segments(cfg.approx, cfg.n_layers):
        spec, _, frac = acfg.resolve_attention()
        if (spec, frac) not in specs:
            specs.append((spec, frac))
    errs = {"attention": 0.0, "decode_attention": 0.0}
    for spec, frac in specs:
        name = (f"w{spec.width} cb{spec.coeff_bits} ib{spec.index_bits} "
                f"q{frac}")
        q, k, v = (randn(BATCH * 15, PROMPT, 64),
                   randn(BATCH * 5, PROMPT, 64), randn(BATCH * 5, PROMPT, 64))
        args = dict(spec=spec, approx_div=True, frac_out=frac, causal=True,
                    kv_group=3)
        want = fa.flash_attention_ref(q, k, v, **args)
        got = fa.flash_attention_cuda(q, k, v, block=fa.DEFAULT_BLOCK, **args)
        ring = fa.flash_attention_cuda(q, k, v, block=ATTENTION_RING_BLOCK,
                                       **args)
        torch.cuda.synchronize()
        require(torch.equal(ring, got), f"attention {name}: the ring differs "
                                        "from the depth-0 kernel")
        err, _ = judge_attention(f"policy {name}", got, want, bf16, True)
        errs["attention"] = max(errs["attention"], err)
        gots, wants = [], []
        for _ in range(3):
            dq, kc, vc = (randn(BATCH, 5, 3, 64),
                          randn(BATCH, PROMPT + GEN, 5, 64),
                          randn(BATCH, PROMPT + GEN, 5, 64))
            kn, vn = randn(BATCH, 1, 5, 64), randn(BATCH, 1, 5, 64)
            kw = dict(pos=PROMPT + 15, slot=PROMPT + 15, spec=spec,
                      approx_div=True, frac_out=frac)
            wants.append(da.decode_attention_ref(dq, kc, vc, kn, vn, **kw
                                                 ).flatten())
            gots.append(da.decode_attention_cuda(dq, kc, vc, kn, vn, **kw
                                                 ).flatten())
        derr, _ = judge_attention(f"policy decode {name}", torch.cat(gots),
                                  torch.cat(wants), bf16, True)
        errs["decode_attention"] = max(errs["decode_attention"], derr)
        log(f"  policy spec {name}: flash_attention (depth 0 = ring) "
            f"max_abs_err {err:.3e}, decode_attention {derr:.3e}")
    return errs


def plain_logits(ref_lm, params, prompts, tokens, extra=None, *,
                 kernels=False):
    """``ref_lm`` (every op on its plain version) fed ``tokens``: the
    prefill's (its batch ``prompts`` and ``extra``'s fields) and each
    decode step's logits, float32 (batch, gen, [codebooks,] vocab); no
    kernel may launch (``kernels=True``: a model that mixes kernels and
    plain versions, eager, fed the same way)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    reset_launch_counts()
    gen = tokens.shape[1]
    logits, cache = ref_lm.prefill(params, {"tokens": prompts,
                                            **(extra or {})})
    cache = serve.merge_cache(
        ref_lm.empty_cache(prompts.shape[0], prompts.shape[1] + gen), cache)
    out = [logits]
    for i in range(gen - 1):
        logits, cache = ref_lm.decode_step(params, cache, tokens[:, i],
                                           prompts.shape[1] + i)
        out.append(logits)
    out = torch.stack(out, dim=1).to(torch.float32)
    torch.cuda.synchronize()
    require(kernels or not any(launch_counts().values()),
            "the plain-version run launched a kernel")
    return out


def judge_logits(what, logits, tokens, ref_all, tol) -> dict:
    """Logits within ``tol`` of the plain-version run's, and every greedy
    token whose top-2 margin there exceeds twice ``tol`` equal."""
    err = float((logits - ref_all).abs().max())
    top2 = ref_all.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * tol
    agree = tokens == ref_all.argmax(-1)
    log(f"  {what} vs plain versions: logits max_abs_err {err:.4f}; tokens "
        f"equal {int(agree.sum())}/{agree.numel()}, decided by margin "
        f"{int(decided.sum())}")
    require(err <= tol, f"{what}: logits differ from the plain-version run "
                        f"by {err:.4f} > {tol}")
    require(bool((agree | ~decided).all()),
            f"{what}: a greedy token decided by more than twice the logit "
            "tolerance differs from the plain-version run")
    return dict(logit_err=err, tokens_equal=int(agree.sum()),
                tokens_decided=int(decided.sum()))


def attention_layers(cfg) -> int:
    """Attention blocks a prefill or a decode step runs: one a layer, none
    in an attention-free stack (rwkv6), one a shared-block invocation in
    the hybrid stack (zamba2: one after every ``hybrid_period`` Mamba2
    layers)."""
    if cfg.attn_free:
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_period
    return cfg.n_layers


def policy_generate(dev, lm, params, prompts, what, *, linears=0,
                    norms=0, gen=GEN) -> dict:
    """The captured generate of a policy's ``lm``: the first call captures
    the prefill and the step once each, the second replays them with the
    launch counts zeroed just before and read just after (32 attention a
    prefill, 32 decode_attention a step, ``linears`` logmatmul each,
    ``norms`` sqrt and as many elemwise each — the approximate norms of
    phase 9 (d) —, nothing else), equal to the eager prefill and loop (the
    same launches, tokens and logits ``torch.equal``), and one replayed
    prefill equal to the eager ``lm.prefill``. ``gen`` tokens a generate
    (phase 10 (b) cuts it); the counted generate's seconds are returned
    beside the tokens, logits and launches."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    n = attention_layers(lm.cfg)
    max_seq = PROMPT + gen
    step, pstep = serve.make_decode_step(lm), serve.make_prefill(lm)
    t0 = wall_clock()
    serve.generate(lm, params, prompts, max_seq, gen)
    torch.cuda.synchronize()
    first_s = wall_clock() - t0
    require(step.captures == 1 and pstep.captures == 1,
            f"{what}: the first generate captured {pstep.captures} prefills "
            f"and {step.captures} steps, expected one each")
    reset_launch_counts()
    t0 = wall_clock()
    tokens, logits = serve.generate(lm, params, prompts, max_seq, gen,
                                    return_logits=True)
    torch.cuda.synchronize()
    generate_s = wall_clock() - t0
    counts = launch_counts()
    require(step.captures == 1 and pstep.captures == 1,
            f"{what}: the second generate captured again")
    require(_attention_launches(counts) == n
            and counts["decode_attention"] == n * (gen - 1)
            and _matmul_launches(counts) == linears * gen
            and counts["elemwise"] == counts["sqrt"] == norms * gen
            and counts["packed"] == 0,
            f"{what}: launches {counts}, expected {n} attention, {n} "
            f"decode_attention per step x {gen - 1}, {linears} logmatmul "
            f"and {norms} sqrt and elemwise per prefill and step")
    require(bool(torch.isfinite(logits).all())
            and int(tokens.min()) >= 0
            and int(tokens.max()) < lm.cfg.vocab_size, f"{what}: bad output")
    reset_launch_counts()
    eager_tok, eager_logits = serve.generate(
        lm, params, prompts, max_seq, gen, prefill_fn=lm.prefill,
        decode_fn=lm.decode_step, return_logits=True)
    torch.cuda.synchronize()
    require(launch_counts() == counts,
            f"{what}: the eager generate launched {launch_counts()}, the "
            f"captured one {counts}")
    require(torch.equal(eager_tok, tokens)
            and torch.equal(eager_logits, logits),
            f"{what}: the captured and the eager generate differ")
    log(f"  {what}: captured (prefill and step) vs eager generate: tokens "
        f"and logits torch.equal; launches {counts}")
    prefill_counts = check_prefill_replay(lm, params, prompts, what)
    require(_matmul_launches(prefill_counts) == linears
            and prefill_counts["sqrt"] == norms,
            f"{what}: one prefill launched {prefill_counts}")
    return dict(tokens=tokens, logits=logits, counts=counts,
                first_generate_s=first_s, generate_s=generate_s)


def policy_times(dev, lm, params, prompts, prefix="policy_", *,
                 eager=True) -> dict:
    """The generate of ``lm`` (a policy's; phase 9: with and without
    use_in_norm), captured and (``eager``) eager (``time_callable``, best
    of 3 / 2), and its prefill and decode step replayed back to back (the
    card's pace)."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.metrics.timing import time_callable

    max_seq = PROMPT + GEN
    step, pstep = serve.make_decode_step(lm), serve.make_prefill(lm)
    batch = {"tokens": prompts}
    captured = time_callable(lambda: serve.generate(
        lm, params, prompts, max_seq, GEN), iters=3, device=dev)
    if eager:
        eager = time_callable(lambda: serve.generate(
            lm, params, prompts, max_seq, GEN, prefill_fn=lm.prefill,
            decode_fn=lm.decode_step), iters=2, device=dev)
    prefill_ms = gpu_time_ms(lambda: pstep(params, batch), iters=10)
    lg, pre = pstep(params, batch)
    own = serve.merge_cache(step.empty_cache(BATCH, max_seq), pre)
    tok = lg.argmax(-1)
    step_ms = gpu_time_ms(lambda: step(params, own, tok, PROMPT), iters=20)
    torch.cuda.synchronize()
    out = {f"{prefix}generate_captured_ms": captured.best_s * 1e3,
           f"{prefix}prefill_replay_ms": prefill_ms,
           f"{prefix}decode_step_replay_ms": step_ms}
    if eager:
        out[f"{prefix}generate_eager_ms"] = eager.best_s * 1e3
    return out


def policy_serve(dev, params, prompts) -> dict:
    """Phase 8 (b) and (c): the layer-segmented policy file served at full
    width, divider only and ``--emulate``, captured equal to eager, held
    to the all-plain run of the same file and, for a policy that pins the
    config's own divider, to the policy-free run."""
    import torch
    from repro_torch.core.error_lut import materialized_tables
    from repro_torch.launch import serve
    from repro_torch.metrics.timing import time_callable
    from repro_torch.models import build
    from repro_torch.tuning import PolicyEntry, TuningPolicy

    segments = [(lo, hi) for lo, hi, _, _ in POLICY_SEGMENTS]
    policy = _saved_and_loaded(segment_policy(matmul=False))
    log(f"  (b) policy file: {len(policy.entries)} entries, "
        f"{len(policy.distinct_configs())} distinct dispatch config(s)")
    cfg = serve.serving_config(ARCH, policy=policy)   # serve --policy PATH
    require(cfg.approx.mode == "simdive" and cfg.approx.policy is policy,
            "--policy did not make the config simdive")
    log(serve.render_plan(serve.resolve_serving_plan(cfg), cfg))
    check_policy_plan(cfg, policy, segments)

    # the last segment's divider table: read by no earlier phase, made by
    # the prefill's warm run before its capture, the same tensor after
    last = POLICY_SEGMENTS[-1][2]
    key = ("div", last["width"], last["coeff_bits"], 3)

    def table_ptrs():
        return {k: t.data_ptr() for k, t in materialized_tables().items()
                if k[:4] == key and k[4].type == "cuda"}

    require(not table_ptrs(), f"table {key} was read before phase 8")
    lm = build(cfg)
    run = policy_generate(dev, lm, params, prompts, "policy")
    ptrs = table_ptrs()
    require(len(ptrs) == 1, f"table {key} on the card: {ptrs}")
    out = policy_times(dev, lm, params, prompts)
    errs = policy_kernels(dev, cfg)     # adds the plain versions' copy
    require(all(table_ptrs()[k] == p for k, p in ptrs.items()),
            f"table {key} was made anew")

    # the same file, every backend rewritten to 'ref': the plain versions
    # on the card, fed the same tokens
    ref_policy = segment_policy(matmul=False, backend="ref")
    ref_lm = build(serve.serving_config(ARCH, backend="ref",
                                        policy=ref_policy))
    require({row.backend for row in serve.resolve_serving_plan(ref_lm.cfg)}
            == {"ref"}, "the rewritten policy's plan is not all 'ref'")
    ref_all = plain_logits(ref_lm, params, prompts, run["tokens"])
    tol, _ = ulp_logit_tol("policy", ref_all, TIED_LOGIT_RANGE)
    out.update({f"policy_{k}": v for k, v in judge_logits(
        "policy", run["logits"], run["tokens"], ref_all, tol).items()})
    del ref_lm, ref_all

    # a policy pinning exactly the config's own divider serves the
    # policy-free tokens and logits, bit for bit
    base = serve.serving_config(ARCH, approx="simdive")
    spec, _, frac = base.approx.resolve_attention()
    same = TuningPolicy(entries=(PolicyEntry(
        op="attention", width=spec.width, coeff_bits=spec.coeff_bits,
        index_bits=spec.index_bits, frac_out=frac),))
    toks = {}
    for name, c in (("policy-free", base),
                    ("defaults-policy", serve.serving_config(
                        ARCH, approx="simdive", policy=same))):
        toks[name] = serve.generate(build(c), params, prompts, PROMPT + GEN,
                                    GEN, return_logits=True)
    (t0, l0), (t1, l1) = toks.values()
    require(torch.equal(t0, t1) and torch.equal(l0, l1),
            "a policy pinning the config's own divider serves other tokens "
            "or logits than no policy")
    log("  a policy pinning the config's own divider: tokens and logits "
        "torch.equal to the policy-free run's")
    del toks

    # (c) --emulate: per-segment matmul entries besides the dividers
    policy_e = _saved_and_loaded(segment_policy(matmul=True))
    cfg_e = serve.serving_config(ARCH, emulate=True, policy=policy_e)
    log(serve.render_plan(serve.resolve_serving_plan(cfg_e), cfg_e))
    check_policy_plan(cfg_e, policy_e, segments)
    lm_e = build(cfg_e)
    linears = len(LINEARS) * cfg_e.n_layers                  # 224
    run_e = policy_generate(dev, lm_e, params, prompts, "policy --emulate",
                            linears=linears)
    out["policy_emulate_generate_captured_ms"] = time_callable(
        lambda: serve.generate(lm_e, params, prompts, PROMPT + GEN, GEN),
        iters=2, device=dev).best_s * 1e3
    out.update(policy_emulate_first_generate_s=run_e["first_generate_s"],
               policy_first_generate_s=run["first_generate_s"],
               policy_attention_max_abs_err=errs["attention"],
               policy_decode_attention_max_abs_err=errs["decode_attention"])
    out["launches_policy"] = run["counts"]
    out["launches_policy_emulate"] = run_e["counts"]
    log(f"  policy generate: captured {out['policy_generate_captured_ms']:.2f}"
        f" ms, eager {out['policy_generate_eager_ms']:.2f} ms; prefill "
        f"replay {out['policy_prefill_replay_ms']:.3f} ms, decode step "
        f"replay {out['policy_decode_step_replay_ms']:.3f} ms; --emulate "
        f"generate captured {out['policy_emulate_generate_captured_ms']:.1f}"
        " ms")
    return out, cfg


def policy_drills(dev, cfg, params) -> dict:
    """Phase 8 (d): ``serve --scheduler --policy`` with phase 6's gates
    (captured, eager and guarded drills equal, four requests ==
    ``generate``) and ``serve --chaos --policy`` with phase 7 (d)'s
    (captured == eager), the scrub's table identities covering every
    layer segment's tables."""
    import gc
    from repro_torch.faults.scrub import config_table_identities

    policy = cfg.approx.policy
    out = {}
    sched = _drill_scheduler(cfg, DRILL_REQUESTS, params=params)
    require(sched.levels[0].approx.policy is policy
            and all(lv.approx.policy is None for lv in sched.levels[1:]),
            "the ladder: the fine rung must carry the policy, the shed and "
            "recovery rungs drop it")
    d = run_drill("policy captured", sched, DRILL_REQUESTS)
    e, _ = drill_equivalents(dev, cfg, params, _drill_tokens(sched),
                             d["stats"]["events"], "policy ")
    out.update(policy_drill_ms=d["wall_ms"],
               policy_drill_tok_per_s=d["tok_per_s"],
               policy_drill_ticks=d["stats"]["ticks"],
               policy_drill_eager_ms=e["wall_ms"])
    out["launches_policy_drill"] = d["counts"]
    del sched
    gc.collect()

    idents = set(config_table_identities(cfg.approx, cfg.n_layers))
    seg_tables = {("div", att["width"], att["coeff_bits"], 3)
                  for _, _, att, _ in POLICY_SEGMENTS}
    c, ce, scrubbed = chaos_pair(cfg, params, DRILL_REQUESTS, "policy ")
    require(seg_tables <= idents <= set(scrubbed),
            f"chaos --policy: scrub identities {scrubbed} miss a segment's "
            f"tables {sorted(seg_tables | idents)}")
    log(f"  chaos --policy: the scrub covers {len(scrubbed)} table "
        f"identities, the segments' {sorted(seg_tables)} among them")
    out.update(policy_chaos_ms=c["wall_ms"],
               policy_chaos_tok_per_s=c["tok_per_s"],
               policy_chaos_ticks=c["stats"]["ticks"],
               policy_chaos_eager_ms=ce["wall_ms"])
    out["launches_policy_chaos"] = c["counts"]
    log(f"  policy drill {out['policy_drill_ms']:.1f} ms, "
        f"{out['policy_drill_tok_per_s']:.1f} tok/s; chaos --policy "
        f"{out['policy_chaos_ms']:.1f} ms, "
        f"{out['policy_chaos_tok_per_s']:.1f} tok/s")
    return out


def policy_phase(dev, params, prompts) -> dict:
    """Phase 8: the tuner's policies built on the card and served."""
    import gc
    from repro_torch.faults.inject import active_faults
    from repro_torch.launch import serve

    serve.make_prefill.cache_clear()
    serve.make_decode_step.cache_clear()
    gc.collect()
    out = policy_build(dev)
    served, cfg = policy_serve(dev, params, prompts)
    out.update(served)
    serve.make_prefill.cache_clear()
    serve.make_decode_step.cache_clear()
    gc.collect()
    out.update(policy_drills(dev, cfg, params))
    require(active_faults() == (), f"phase 8 left {active_faults()} armed")
    return out


# ------------------------------------------------------------------- main --
# ---------------------------------------------------- phase 9: arithmetic --
def rsqrt_operands(x, eps: float):
    """The sqrt operands ``approx_rmsnorm`` makes of activations ``x`` at
    the 16-bit divider, one a row (``core.approx.rsqrt_operand``)."""
    import torch
    from repro_torch.core.approx import rsqrt_operand

    return rsqrt_operand(x.to(torch.float32).square().mean(dim=-1,
                                                           keepdim=True),
                         eps, 16)


def check_sqrt(dev, norm_operands) -> dict:
    """Phase 9 (a): the sqrt kernel against its plain version, bit for bit,
    on every 8- and 16-bit operand at each of SQRT_FRAC_OUTS and on the
    norms' own operands; disarmed, then under each of the campaign's log
    sites (a stuck-1 at bit w/2, a transient flip at bit w-1) and a log
    flip at bit 31 (both versions armed alike), where the output must
    move; disarmed again, every output as before the arming."""
    import torch
    from repro_torch.core.mitchell import from_lanes
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.faults.campaign import default_sites
    from repro_torch.faults.inject import (FaultSpec, active_faults,
                                           fault_injection)
    from repro_torch.kernels import get_op

    lanes = {w: torch.arange(1 << w, device=dev, dtype=torch.int32
                             ).view(torch.uint32) for w in (8, 16)}
    worst = [0]

    def both(a, w, fo, what):
        spec = SimdiveSpec(width=w)
        got = get_op("sqrt", spec, "cuda")(a, frac_out=fo)
        want = get_op("sqrt", spec, "ref")(a, frac_out=fo)
        torch.cuda.synchronize()
        require(got.dtype == torch.uint32 and got.shape == a.shape,
                f"sqrt {what} w{w} fo{fo}: {got.dtype} {tuple(got.shape)}")
        err = int((from_lanes(got) - from_lanes(want)).abs().max())
        worst[0] = max(worst[0], err)
        require(err == 0 and torch.equal(got, want),
                f"sqrt {what} w{w} fo{fo}: "
                f"{int((got != want).sum())} lanes differ from the plain "
                f"version, by up to {err}")
        return got

    def sweep(what):
        out = {(w, fo): both(a, w, fo, what) for w, a in lanes.items()
               for fo in SQRT_FRAC_OUTS}
        for i, qm in enumerate(norm_operands):
            out["norm", i] = both(qm, 16, 0, f"{what} norm operands {i}")
        return out

    before = sweep("disarmed")
    sites = [s for w in (8, 16) for s in default_sites("div", w)
             if s.site == "log"]
    sites += [FaultSpec(site="log", bit=31, kind="flip", width=w)
              for w in (8, 16)]
    for site in sites:
        with fault_injection(site):
            armed = sweep(f"armed {site}")
        moved = [k for k in armed if k[0] == site.width
                 and not torch.equal(armed[k], before[k])]
        require(bool(moved), f"sqrt: {site} moved no output")
    require(active_faults() == (), "phase 9 (a) left a fault armed")
    after = sweep("disarmed again")
    require(all(torch.equal(after[k], before[k]) for k in before),
            "sqrt: after the disarm an output differs from before it")
    n = sum(t.numel() for t in before.values())
    log(f"  (a) sqrt: {n} lanes a sweep (every 8- and 16-bit operand at "
        f"frac_out {SQRT_FRAC_OUTS}, the norms' operands) torch.equal to "
        f"the plain version disarmed, under {len(sites)} log sites (each "
        "moved its width's outputs) and disarmed again (as before)")
    return {"sqrt_lanes_a_sweep": n, "sqrt_armed_sites": len(sites),
            "sqrt_max_abs_err": worst[0]}


def check_softmax(dev) -> dict:
    """Phase 9 (b): ``_fixed_point_div`` and ``approx_softmax`` on
    smollm-360m's prefill scores, SOFTMAX_SHAPE float32 causal:
    ``backend='cuda'`` (one elemwise launch a call) ``torch.equal`` to
    ``backend='ref'`` (no launch) on the same tensors."""
    import torch
    from repro_torch.core.approx import (ApproxConfig, _fixed_point_div,
                                         approx_softmax)
    from repro_torch.kernels import launch_counts, reset_launch_counts

    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    x = torch.randn(SOFTMAX_SHAPE, generator=gen, device=dev) * 2.0
    causal = torch.ones(SOFTMAX_SHAPE[1:], dtype=torch.bool,
                        device=dev).tril()
    x = x.masked_fill(~causal, float("-inf"))
    cuda = ApproxConfig(mode="simdive", backend="cuda")
    ref = replace(cuda, backend="ref")
    e = (x - x.amax(dim=-1, keepdim=True)).exp()
    s = e.sum(dim=-1, keepdim=True).expand_as(e)
    out = {}
    for name, fn in (("fixed_point_div", lambda c: _fixed_point_div(e, s, c)),
                     ("approx_softmax", lambda c: approx_softmax(x, -1, c))):
        torch.cuda.synchronize()
        reset_launch_counts()
        got = fn(cuda)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = fn(ref)
        torch.cuda.synchronize()
        require(counts["elemwise"] == 1 and sum(counts.values()) == 1,
                f"{name}: launches {counts}, expected one elemwise")
        require(launch_counts() == counts,
                f"{name}: the plain version launched a kernel")
        require(torch.equal(got, want), f"{name} {SOFTMAX_SHAPE}: cuda and "
                f"ref differ on {int((got != want).sum())} elements")
        out[f"{name}_launches"] = counts["elemwise"]
    exact = torch.softmax(x, dim=-1)
    p = approx_softmax(x, -1, cuda)
    err = float((p - exact).abs().max())
    ms = gpu_time_ms(lambda: approx_softmax(x, -1, cuda), iters=5)
    plain_ms = gpu_time_ms(lambda: approx_softmax(x, -1, ref), iters=2)
    exact_ms = gpu_time_ms(lambda: torch.softmax(x, dim=-1), iters=5)
    log(f"  (b) _fixed_point_div and approx_softmax {SOFTMAX_SHAPE} float32 "
        "causal: cuda torch.equal to ref, one elemwise launch a call; "
        f"approx_softmax {ms:.4f} ms (eager), on the plain versions "
        f"{plain_ms:.4f} ms, torch.softmax {exact_ms:.4f} ms; max |approx - "
        f"exact| {err:.3g}")
    return dict(out, approx_softmax_ms=ms, approx_softmax_plain_ms=plain_ms,
                softmax_exact_ms=exact_ms, approx_softmax_err=err)


def check_rmsnorm(dev, eps: float) -> dict:
    """Phase 9 (c): ``approx_rmsnorm`` on NORM_SHAPE bf16 activations with
    smollm-360m's eps, ``backend='cuda'`` (one sqrt and one elemwise
    launch) ``torch.equal`` to ``backend='ref'``; and the rsqrt's
    out-of-lane numerator 2^31 at width 16 through the elemwise kernel
    against its plain version for every r in 1..256, ``RSQRT_WORDS``
    among them. Returns the norm's sqrt operands for (a)."""
    import torch
    from repro_torch.core.approx import ApproxConfig, approx_rmsnorm
    from repro_torch.core.mitchell import from_lanes
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import get_op, launch_counts, reset_launch_counts

    gen = torch.Generator(device=dev).manual_seed(SEED + 91)
    scale = 10.0 ** (torch.rand(*NORM_SHAPE[:2], 1, generator=gen,
                                device=dev) * 5 - 4)
    x = (torch.randn(NORM_SHAPE, generator=gen, device=dev) * scale
         ).to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn(NORM_SHAPE[-1], generator=gen, device=dev)
    cuda = ApproxConfig(mode="simdive", use_in_norm=True, backend="cuda")
    torch.cuda.synchronize()
    reset_launch_counts()
    got = approx_rmsnorm(x, gamma, eps, cuda)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = approx_rmsnorm(x, gamma, eps, replace(cuda, backend="ref"))
    torch.cuda.synchronize()
    require(counts["sqrt"] == 1 and counts["elemwise"] == 1
            and sum(counts.values()) == 2 and launch_counts() == counts,
            f"approx_rmsnorm: launches {counts}, expected one sqrt and one "
            "elemwise (and none from the plain version)")
    require(got.dtype == torch.bfloat16 and torch.equal(got, want),
            f"approx_rmsnorm {NORM_SHAPE}: cuda and ref differ on "
            f"{int((got != want).sum())} elements")
    qm = rsqrt_operands(x, eps)
    distinct = int(from_lanes(qm).unique().numel())
    spec = SimdiveSpec(width=16, coeff_bits=6)
    r = torch.arange(1, 257, device=dev)
    one = torch.full_like(r, 1 << 31)
    q = get_op("elemwise", spec, "cuda")(one, r, op="div", frac_out=16)
    q_ref = get_op("elemwise", spec, "ref")(one, r, op="div", frac_out=16)
    require(torch.equal(q, q_ref), "the rsqrt's 2^31 numerator: the elemwise "
            f"kernel differs from its plain version on "
            f"{int((q != q_ref).sum())} of 256 divisors")
    words = {k: int(from_lanes(q)[k - 1]) for k in RSQRT_WORDS}
    require(words == RSQRT_WORDS, f"the rsqrt's 2^31 quotient words {words}, "
            f"expected {RSQRT_WORDS}")
    log(f"  (c) approx_rmsnorm {NORM_SHAPE} bf16 eps {eps:g} ({distinct} "
        "distinct sqrt operands): cuda torch.equal to ref, one sqrt and "
        "one elemwise launch; div(2^31, r) at w16 fo16 for r in 1..256 "
        f"bit-equal, RSQRT_WORDS {words}")
    return dict(qm=qm, norm_sqrt_operands=distinct)


def norm_generate(dev, served) -> dict:
    """Phase 9 (d): smollm-360m at full width with ``ApproxConfig(mode=
    'simdive', use_in_norm=True)``, phase 4's params and prompts, through
    ``generate`` with both served graphs: captured ``torch.equal`` to eager,
    one sqrt and one elemwise launch a block norm (64 a prefill and a
    step) besides phase 4's attention and decode_attention counts; logits
    within :func:`ulp_logit_tol` over TIED_LOGIT_RANGE of the same config on
    the plain versions; times
    against the same process's use_in_norm-free path, in turns."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import build

    base = serve.serving_config(ARCH, approx="simdive")
    cfg = base.with_approx(replace(base.approx, use_in_norm=True))
    lm = build(cfg)
    params, prompts = served["params"], served["prompts"]
    norms = 2 * cfg.n_layers
    run = policy_generate(dev, lm, params, prompts, "use_in_norm",
                          norms=norms)
    counts = run["counts"]
    ref_lm = build(serve.serving_config(ARCH, approx="simdive", backend="ref")
                   .with_approx(replace(cfg.approx, backend="ref")))
    ref_all = plain_logits(ref_lm, params, prompts, run["tokens"])
    tol, top = ulp_logit_tol("use_in_norm", ref_all, TIED_LOGIT_RANGE)
    judged = judge_logits("use_in_norm", run["logits"], run["tokens"],
                          ref_all, tol)
    # the served path in turns with the same process's use_in_norm-free
    # one: free, norm, norm, free; best of each
    times = {}
    for name, this in (("free", served["lm"]), ("norm", lm), ("norm", lm),
                       ("free", served["lm"])):
        t = policy_times(dev, this, params, prompts, prefix=f"{name}_")
        for k, v in t.items():
            times[k] = min(times.get(k, v), v)
    log("  (d) use_in_norm generate, captured / eager: "
        f"{times['norm_generate_captured_ms']:.2f} / "
        f"{times['norm_generate_eager_ms']:.1f} ms (use_in_norm-free "
        f"{times['free_generate_captured_ms']:.2f} / "
        f"{times['free_generate_eager_ms']:.1f}); prefill replay "
        f"{times['norm_prefill_replay_ms']:.3f} "
        f"({times['free_prefill_replay_ms']:.3f}), step replay "
        f"{times['norm_decode_step_replay_ms']:.3f} "
        f"({times['free_decode_step_replay_ms']:.3f}) ms; largest logit "
        f"{top:.2f}")
    return dict(counts=counts, first_generate_s=run["first_generate_s"],
                logit_max=top, logit_tol=tol, **judged, **times)


def time_sqrt(dev, int_rate) -> tuple[dict, dict]:
    """The sqrt kernel at the norms' shapes on the served path: a prefill's
    (BATCH x PROMPT lanes, one a row) and a decode step's (BATCH lanes);
    graph-replayed, beside its bound and its plain version."""
    import torch
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import get_op

    gen = torch.Generator(device=dev).manual_seed(SEED + 92)
    spec = SimdiveSpec(width=16, coeff_bits=6)
    out = {}
    for name, n in (("prefill", BATCH * PROMPT), ("step", BATCH)):
        a = torch.randint(1, 1 << 16, (BATCH, n // BATCH, 1), generator=gen,
                          device=dev, dtype=torch.int32).view(torch.uint32)
        kernel = lambda a=a: get_op("sqrt", spec, "cuda")(a)
        ms = gpu_graph_time_ms(kernel, iters=200)
        plain_ms = gpu_time_ms(lambda a=a: get_op("sqrt", spec, "ref")(a),
                               iters=50)
        bytes_ms = 8 * n / HBM_BYTES_PER_S * 1e3
        ops_ms = SQRT_OPS_PER_LANE * n / int_rate * 1e3
        out[name] = dict(lanes=n, ms=ms, plain_ms=plain_ms,
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms
                         else "operations")
        log(f"  sqrt kernel, the {name}'s norm shape ({n} lanes): {ms:.5f} ms "
            f"(graph), plain {plain_ms:.4f} ms, bound "
            f"{out[name]['bound_ms']:.3g} ms ({out[name]['bound_by']})")
    p = out["prefill"]
    row = {"name": "sqrt", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/elemwise.cu",
           "replaces": "src/repro/core/simdive.py:68",
           "note": "no TPU kernel: the reference's jnp simdive_sqrt, "
                   "registered for its oracle alone "
                   "(src/repro/kernels/ops.py:472)",
           "shape": f"({BATCH},{PROMPT},1) uint32 lanes, w16 fo0 (a "
                    "prefill's block norm; a decode step's: "
                    f"({BATCH},1,1))",
           "ms": p["ms"], "plain_ms": p["plain_ms"],
           "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
           "library_ms": None, "step_shape": out["step"]}
    return row, out


def arithmetic_phase(dev, served) -> dict:
    """Phase 9: the rest of the arithmetic on the card — (c) and (b)
    first, whose operands (a) reuses, then (a), then (d) the full-width
    use_in_norm generate."""
    import torch

    eps = served["lm"].cfg.norm_eps
    norm = check_rmsnorm(dev, eps)
    soft = check_softmax(dev)
    embed = served["params"]["embed"][0][served["prompts"]].to(torch.bfloat16)
    sq = check_sqrt(dev, [rsqrt_operands(embed, eps), norm.pop("qm")])
    gen = norm_generate(dev, served)
    return dict(**norm, **soft, **sq, use_in_norm=gen)



# ------------------------------------------- phase 10: the dense family --
def attention_times(dev, gen, arch, H, KV, dh, int_rate) -> dict:
    """The attention kernels at ``arch``'s serving shapes (batch 4, prompt
    512, the serving divider), each beside its bound: ``flash_attention``
    at its prefill (depth 0 and the ring) beside
    ``scaled_dot_product_attention`` and its plain version, and
    ``decode_attention`` at its step (at the planner's cluster size and
    pinned at each) likewise. Returns the ``attention {arch}`` and
    ``decode_attention {arch}`` rows; phase 3 holds the same shapes
    against their plain versions."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import get_op

    bf16 = torch.bfloat16
    serving, frac_out = SimdiveSpec(width=16, coeff_bits=6), 15
    G = H // KV
    out = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    q = randn(BATCH * H, PROMPT, dh)
    k, v = randn(BATCH * KV, PROMPT, dh), randn(BATCH * KV, PROMPT, dh)
    kw = dict(causal=True, approx_div=True, frac_out=frac_out, kv_group=G)
    by_block = {block: gpu_graph_time_ms(
        lambda b=block: get_op("attention", serving, "cuda", block=b)(
            q, k, v, **kw), iters=20)
        for block in (fa.DEFAULT_BLOCK, ATTENTION_RING_BLOCK)}
    plain_ms = gpu_time_ms(lambda: get_op("attention", serving, "ref")(
        q, k, v, **kw), iters=3)
    q4 = q.reshape(BATCH, H, PROMPT, dh)
    k4 = k.reshape(BATCH, KV, PROMPT, dh).repeat_interleave(G, dim=1)
    v4 = v.reshape(BATCH, KV, PROMPT, dh).repeat_interleave(G, dim=1)
    lib_ms = gpu_graph_time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), iters=20)
    pairs = BATCH * H * PROMPT * (PROMPT + 1) // 2
    flops_ms = 4 * pairs * dh / BF16_FLOPS * 1e3
    bytes_ms = 2 * (2 * q.numel() + k.numel() + v.numel()) \
        / HBM_BYTES_PER_S * 1e3
    row = out[f"attention {arch}"] = dict(
        ms=by_block[fa.DEFAULT_BLOCK], ring_ms=by_block[ATTENTION_RING_BLOCK],
        plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=max(flops_ms, bytes_ms),
        bound_by="operations" if flops_ms >= bytes_ms else "bytes")
    log(f"  attention, {arch}'s prefill: depth 0 {row['ms']:.5f} ms, ring "
        f"{ATTENTION_RING_BLOCK} {row['ring_ms']:.5f} ms (graph), plain "
        f"{plain_ms:.3f} ms, scaled_dot_product_attention {lib_ms:.5f} ms "
        f"({row['ms'] / lib_ms:.2f}x), bound {row['bound_ms']:.5f} ms "
        f"({row['bound_by']})")
    del q, k, v, q4, k4, v4

    Smax, pos = PROMPT + GEN, PROMPT + 15
    t = time_decode_attention(dev, gen, BATCH, Smax, KV, G, dh, pos, serving,
                              frac_out, int_rate,
                              clusters=range(1, da.MAX_CLUSTER + 1))
    dq, kc, vc, kn, vn = t["inputs"]
    plain_ms = gpu_time_ms(lambda: get_op("decode_attention", serving, "ref")(
        dq, kc, vc, kn, vn, pos=pos, slot=pos, approx_div=True,
        frac_out=frac_out), iters=20)
    out[f"decode_attention {arch}"] = dict(
        {key: t[key] for key in ("ms", "library_ms", "bound_ms", "bound_by",
                                 "cluster")},
        plain_ms=plain_ms,
        ms_by_cluster={str(c): ms for c, ms in t["ms_by_cluster"].items()})
    log(f"  decode attention, {arch}'s step: {t['ms']:.5f} ms (graph, "
        f"cluster {t['cluster']}), plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {t['library_ms']:.5f} ms "
        f"({t['ms'] / t['library_ms']:.2f}x), bound {t['bound_ms']:.6f} ms "
        f"({t['bound_by']}); by cluster size "
        + ", ".join(f"{c}: {ms:.5f}" for c, ms in t["ms_by_cluster"].items()))
    del t, dq, kc, vc, kn, vn
    return out


def linear_times(dev, gen, arch, linears, int_rate, exact_dtype,
                 check_rows=QWEN3_CHECK_ROWS) -> dict:
    """``logmatmul`` at one layer's ``linears`` ((name, K, N)) of ``arch``,
    w8 cb6, timed at a step's 4 rows and a prefill's 2,048, the fastest
    registered block each, summed over the layer beside its bound and an
    exact ``torch.matmul`` of the same shapes in ``exact_dtype`` (what
    the divider-only path multiplies in). Phase 3 holds the same shapes
    bit for bit against the plain version."""
    import torch
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import get_op
    from repro_torch.kernels import logmatmul as lmm

    spec8 = SimdiveSpec(width=8, coeff_bits=6)
    registered = get_op("matmul_int", spec8).entry.block_candidates
    shapes = sorted({(k, n) for _, k, n in linears})
    exact = str(exact_dtype).split(".")[-1].replace("float", "f")
    rows = {}
    for M in (4, 2048):
        for K, N in shapes:
            x = torch.randint(-255, 256, (M, K), generator=gen, device=dev,
                              dtype=torch.int32)
            w = torch.randint(-255, 256, (K, N), generator=gen, device=dev,
                              dtype=torch.int32)
            iters = 2 if M > 4 else 50
            by_block = {b: gpu_graph_time_ms(
                lambda b=b: lmm.logmatmul_cuda(x, w, spec8, b), iters=iters)
                for b in registered}
            best = min(registered, key=by_block.get)
            xe, we = x.to(exact_dtype), w.to(exact_dtype)
            rows[(M, K, N)] = {
                "ms": by_block[best], "block": list(best),
                "ops_ms": logmatmul_ops_ms(M, K, N, int_rate),
                "bytes_ms": (M * K + K * N + M * N) * 4
                / HBM_BYTES_PER_S * 1e3,
                "exact_ms": gpu_graph_time_ms(lambda: xe @ we, iters=10)}

    def layer_sum(M, key):
        return sum(rows[(M, k, n)][key] for _, k, n in linears)

    layer = {}
    for M in (4, 2048):
        ops, nbytes = layer_sum(M, "ops_ms"), layer_sum(M, "bytes_ms")
        layer[M] = {"ms": layer_sum(M, "ms"),
                    f"exact_{exact}_ms": layer_sum(M, "exact_ms"),
                    "bound_ms": max(ops, nbytes),
                    "bound_by": "operations" if ops >= nbytes else "bytes",
                    "blocks": {f"{K},{N}": rows[(M, K, N)]["block"]
                               for K, N in shapes}}
        log(f"  logmatmul, {arch}'s {len(linears)} linears at M = {M} (the "
            f"fastest registered block each): {layer[M]['ms']:.4f} ms, "
            f"bound {layer[M]['bound_ms']:.4f} ms ({layer[M]['bound_by']}), "
            f"exact {exact} torch.matmul "
            f"{layer[M][f'exact_{exact}_ms']:.4f} ms")
    return {"shape": f"one layer's {len(linears)} linears, (K, N) = "
                     + " ".join(f"({k},{n})" for _, k, n in linears)
                     + ", w8 cb6",
            "check_rows": list(check_rows),
            "int32_sum_bound": INT32_SUM_BOUND,
            "step": layer[4], "prefill": layer[2048]}


def dense_kernel_times(dev, int_rate) -> dict:
    """Phase 10 (k): the kernels' times at qwen3-4b's serving shapes, each
    beside its bound (phase 3 holds them at the three configurations'
    shapes against their plain versions): ``flash_attention`` at its
    prefill (depth 0 and the ring) beside ``scaled_dot_product_attention``
    and its plain version, ``decode_attention`` at its step likewise, the
    seven linears at M = 4 and 2048 (the fastest registered block each)
    beside an exact bf16 ``torch.matmul``, and the sqrt kernel at
    SQRT_WORK_LANES lanes."""
    import torch
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import get_op

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    serving = SimdiveSpec(width=16, coeff_bits=6)
    (_, H, KV, dh), = (a for a in DENSE_ATTENTION if a[0] == "qwen3-4b")
    out = attention_times(dev, gen, "qwen3-4b", H, KV, dh, int_rate)
    out["logmatmul qwen3-4b"] = linear_times(
        dev, gen, "qwen3-4b", QWEN3_LINEARS, int_rate, torch.bfloat16)

    # the sqrt kernel at a working size, beside its bound
    a = torch.randint(1, 1 << 16, (SQRT_WORK_LANES,), generator=gen,
                      device=dev, dtype=torch.int32).view(torch.uint32)
    sq_ms = gpu_graph_time_ms(lambda: get_op("sqrt", serving, "cuda")(a),
                              iters=20)
    bytes_ms = 8 * SQRT_WORK_LANES / HBM_BYTES_PER_S * 1e3
    ops_ms = SQRT_OPS_PER_LANE * SQRT_WORK_LANES / int_rate * 1e3
    out["sqrt working size"] = {
        "lanes": SQRT_WORK_LANES, "ms": sq_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    log(f"  sqrt kernel at {SQRT_WORK_LANES:,} lanes: {sq_ms:.5f} ms "
        f"(graph), bound {max(bytes_ms, ops_ms):.5f} ms "
        f"({out['sqrt working size']['bound_by']}): "
        f"{max(bytes_ms, ops_ms) / sq_ms:.0%} of it")
    return out


def _drop_served_graphs() -> None:
    """Free every memoized served prefill and decode step (their graphs,
    pools and the params they hold) before the next model."""
    import gc

    import torch
    from repro_torch.launch import serve

    serve.make_prefill.cache_clear()
    serve.make_decode_step.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()


def served_config(arch, **kw):
    """``serve.serving_config(arch, approx="simdive", **kw)`` at the depth
    SERVED_LAYERS gives ``arch`` (whole when it names none)."""
    from repro_torch.launch import serve

    cfg = serve.serving_config(arch, approx="simdive", **kw)
    n = SERVED_LAYERS.get(arch)
    return cfg if n is None else replace(cfg, n_layers=n)


def served_generate(dev, arch, *, prepare=None) -> dict:
    """Phases 10 (a), (c), (d), 11 (a), (b), 12 (a), (b), 13 (a) and 14
    (a): ``arch`` at its published widths (depth cut to SERVED_LAYERS'),
    random weights from SEED (then ``prepare(params)``, in place,
    where given), batch 4, prompt 512 (a codebook config's prompts
    (4, 512, C)), 32 greedy tokens, ``--approx simdive``: the
    parameters' bytes and ``LM.init``'s peak (under INIT_PEAK_RATIO of
    them); the served prefill and decode step captured first, each alone
    (:func:`graphs_held`); then :func:`policy_generate` (one attention
    launch a layer a prefill, one decode_attention a layer a step,
    nothing else; captured ``torch.equal`` to eager; a replayed prefill
    equal to the eager one); the logits against the same config on the
    plain versions — within :func:`ulp_logit_tol` over UNTIED_LOGIT_RANGE
    with the decided tokens equal, or for an MoE config
    :func:`routed_logits` (an attention-free config launches no kernel
    here, so its plain versions run the same computation: none);
    :func:`peaks_and_times`; where one step's card
    time goes (:func:`step_breakdown`). Returns the results and, under
    "params" / "prompts", what an ``--emulate`` run reuses."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import serve
    from repro_torch.models import build

    full_layers = serve.serving_config(arch, approx="simdive").n_layers
    cfg = served_config(arch)
    lm = build(cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = wall_clock()
    params = lm.init(SEED)
    torch.cuda.synchronize()
    init_s = wall_clock() - t0
    init_peak = torch.cuda.max_memory_allocated(dev) - base
    if prepare is not None:
        prepare(params)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in serve._leaves(params))
    C = cfg.n_codebooks
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (BATCH, PROMPT, C) if C else (BATCH, PROMPT),
        dtype=np.int64)).to(dev)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    G = cfg.n_heads // cfg.n_kv_heads
    cluster = da.cluster_size(BATCH, cfg.n_kv_heads, sm_count)
    experts = (f"{cfg.n_experts} experts top-{cfg.n_experts_active}, "
               f"{cfg.n_shared_experts} shared, capacity factor "
               f"{cfg.moe_capacity_factor} (prefill) / 4.0 (decode), "
               if cfg.n_experts else "")
    log(f"  {arch}: {cfg.n_layers} of {full_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads (G "
        f"{G}), d_head {cfg.d_head}, d_ff {cfg.d_ff}, {experts}window "
        f"{cfg.sliding_window}, vocab {cfg.vocab_size}, norm {cfg.norm}, "
        f"qk_norm {cfg.qk_norm}, qkv_bias {cfg.qkv_bias}, partial_rotary "
        f"{cfg.partial_rotary}, act {cfg.act}, pos_emb {cfg.pos_emb}, mrope "
        f"{cfg.mrope_sections if cfg.mrope else False}, codebooks {C}, "
        f"tied {cfg.tie_embeddings}; "
        f"{param_bytes:,} bytes of f32 parameters made in {init_s:.1f}s, "
        f"init peak {init_peak:,} ({init_peak / param_bytes:.4f}x); decode "
        f"cluster {cluster}")
    require(init_peak < INIT_PEAK_RATIO * param_bytes,
            f"{arch}: LM.init peaked at {init_peak:,} bytes, over "
            f"{INIT_PEAK_RATIO}x the parameters' {param_bytes:,}")
    held = graphs_held(lm, params, prompts)
    run = policy_generate(dev, lm, params, prompts, arch)
    ref_lm = build(replace(cfg, approx=replace(cfg.approx, backend="ref")))
    if cfg.n_experts:
        judged = routed_logits(lm, ref_lm, params, prompts, run)
    elif cfg.attn_free:
        judged = {}
    else:
        ref_all = plain_logits(ref_lm, params, prompts, run["tokens"])
        tol, top = ulp_logit_tol(arch, ref_all, UNTIED_LOGIT_RANGE)
        judged = dict(logit_max=top, logit_tol=tol, **judge_logits(
            arch, run["logits"], run["tokens"], ref_all, tol))
        del ref_all
    return dict(params=params, prompts=prompts, layers=cfg.n_layers,
                full_layers=full_layers, G=G, cluster=cluster,
                param_bytes=param_bytes, init_s=init_s,
                init_peak_bytes=init_peak, counts=run["counts"],
                first_generate_s=run["first_generate_s"], **held, **judged,
                **peaks_and_times(dev, lm, params, prompts),
                step_kernels=step_breakdown(lm, params, prompts))


def graphs_held(lm, params, prompts) -> dict:
    """The served prefill and decode step of ``lm`` captured first, each
    alone: the card memory each holds (its graph's pool; the step's cache
    included) and its capture's seconds."""
    import torch
    from repro_torch.launch import serve

    step, pstep = serve.make_decode_step(lm), serve.make_prefill(lm)
    reserved = reserved_bytes()
    lg, pre = pstep(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_held = reserved_bytes() - reserved
    reserved = reserved_bytes()
    own = serve.merge_cache(step.empty_cache(BATCH, PROMPT + GEN), pre)
    if "k" in own:             # a K/V cache (the rwkv6 stack's has no seq)
        require(own["k"].shape[2] == min(PROMPT + GEN, lm.cfg.sliding_window
                                         or PROMPT + GEN),
                f"{lm.cfg.name}: a serving cache of {own['k'].shape[2]} "
                "slots")
    step(params, own, lg.argmax(-1), PROMPT)
    torch.cuda.synchronize()
    step_held = reserved_bytes() - reserved
    log(f"  {lm.cfg.name}: the captured prefill holds {prefill_held:,} bytes "
        f"(captured in {pstep.capture_s:.2f}s), the captured decode step "
        f"{step_held:,} (its cache included; {step.capture_s:.2f}s)")
    return dict(prefill_held_bytes=prefill_held,
                decode_step_held_bytes=step_held,
                prefill_capture_s=pstep.capture_s,
                decode_step_capture_s=step.capture_s)


def peaks_and_times(dev, lm, params, prompts) -> dict:
    """The peak memory of a captured and of an eager generate of ``lm``,
    and :func:`policy_times`."""
    import torch
    from repro_torch.launch import serve

    peaks = {}
    for name, kw in (("captured", {}), ("eager", dict(
            prefill_fn=lm.prefill, decode_fn=lm.decode_step))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        serve.generate(lm, params, prompts, PROMPT + GEN, GEN, **kw)
        torch.cuda.synchronize()
        peaks[f"generate_{name}_peak_bytes"] = \
            torch.cuda.max_memory_allocated(dev)
    times = policy_times(dev, lm, params, prompts, prefix="")
    log(f"  {lm.cfg.name}: generate captured "
        f"{times['generate_captured_ms']:.2f} ms, eager "
        f"{times['generate_eager_ms']:.2f} ms; prefill replay "
        f"{times['prefill_replay_ms']:.3f} ms, decode step replay "
        f"{times['decode_step_replay_ms']:.3f} ms; peak "
        f"{peaks['generate_captured_peak_bytes']:,} / "
        f"{peaks['generate_eager_peak_bytes']:,} bytes (captured / eager)")
    return {**peaks, **times}


def qwen3_emulate(dev, params, prompts) -> dict:
    """Phase 10 (b): qwen3-4b at full width with ``--emulate``, QWEN3_EMULATE_GEN
    tokens, (a)'s params and prompts: 7 logmatmul launches a layer a
    prefill and a step besides (a)'s, captured ``torch.equal`` to eager, a
    replayed prefill equal to the eager one (:func:`policy_generate`)."""
    from repro_torch.models import build

    cfg = served_config("qwen3-4b", emulate=True)
    require(cfg.approx.emulate and cfg.approx.width == 8,
            "not the --emulate serving config")
    run = policy_generate(dev, build(cfg), params, prompts,
                          "qwen3-4b --emulate",
                          linears=len(QWEN3_LINEARS) * cfg.n_layers,
                          gen=QWEN3_EMULATE_GEN)
    log(f"  qwen3-4b --emulate: first generate (autotune, captures) "
        f"{run['first_generate_s']:.1f}s, captured generate of "
        f"{QWEN3_EMULATE_GEN} tokens {run['generate_s'] * 1e3:.1f} ms")
    return dict(counts=run["counts"], gen=QWEN3_EMULATE_GEN,
                first_generate_s=run["first_generate_s"],
                generate_captured_ms=run["generate_s"] * 1e3)


def dense_family_phase(dev, int_rate) -> dict:
    """Phase 10: (k) the kernels' times at qwen3-4b's shapes, then (a) qwen3-4b
    divider-only, (b) qwen3-4b --emulate, (c) stablelm-1.6b, (d)
    qwen2.5-14b, each at full width, depth cut to SERVED_LAYERS; every
    earlier model's graphs are dropped first and each model's after it."""
    _drop_served_graphs()
    out = {"kernels": dense_kernel_times(dev, int_rate)}
    log(f"  (a) qwen3-4b at full width, {SERVED_LAYERS['qwen3-4b']} of 36 "
        "layers, --approx simdive")
    a = served_generate(dev, "qwen3-4b")
    log(f"  (b) qwen3-4b at full width, --approx simdive --emulate, "
        f"{QWEN3_EMULATE_GEN} tokens")
    out["qwen3-4b --emulate"] = qwen3_emulate(dev, a.pop("params"),
                                              a.pop("prompts"))
    out["qwen3-4b"] = a
    _drop_served_graphs()
    log(f"  (c) stablelm-1.6b at full width, "
        f"{SERVED_LAYERS['stablelm-1.6b']} of 24 layers, --approx simdive")
    c = served_generate(dev, "stablelm-1.6b")
    del c["params"], c["prompts"]
    out["stablelm-1.6b"] = c
    _drop_served_graphs()
    log(f"  (d) qwen2.5-14b at full widths, {SERVED_LAYERS['qwen2.5-14b']} "
        "of 48 layers, --approx simdive")
    d = served_generate(dev, "qwen2.5-14b")
    del d["params"], d["prompts"]
    out["qwen2.5-14b"] = d
    _drop_served_graphs()
    return out


# -------------------------------------------- phase 11: the MoE family --
class _RecordedRoutes:
    """Every ``repro_torch.models.moe._dispatch`` call while installed: its
    picks ``gate_idx (G,Tg,K)``, its kept entries ``dst < E*C``
    ``(G,Tg,K)`` and its overflow count. The package has no hook; this
    wraps the module's function for eager runs only."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe

        self._orig = orig = moe._dispatch

        def record(xt, probs, top_k, capacity_factor):
            out = orig(xt, probs, top_k, capacity_factor)
            buf, dst, _, _, gate_idx = out
            overflow = buf.shape[1] * buf.shape[2]
            self.calls.append((gate_idx.clone(),
                               (dst < overflow).reshape(gate_idx.shape)))
            return out

        moe._dispatch = record
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._dispatch = self._orig


def judge_routed_logits(what, n_layers, kern_calls, plain_calls, logits,
                        tokens, ref_all, tol,
                        against: str = "the plain-version run") -> dict:
    """The routing-aware gate (ROUTE_AGREE_FLOOR, ROUTE_CHECKED_FLOOR):
    ``*_calls`` are one generate's dispatch calls in order — the prefill's
    one a layer (G = B groups of the prompt), then each step's one a layer
    (one group of the B rows); ``against``: what the reference run is."""
    import torch

    gen = tokens.shape[1]
    B = tokens.shape[0]
    require(len(kern_calls) == len(plain_calls) == n_layers * gen,
            f"{what}: {len(kern_calls)} / {len(plain_calls)} dispatch calls, "
            f"expected {n_layers * gen}")
    agree = [[0, 0] for _ in range(n_layers)]     # (routes equal, routes)
    # tokens whose routes first part at a layer (all equal below it)
    fresh = [0] * n_layers
    row_ok = torch.ones((B, gen), dtype=torch.bool, device=tokens.device)
    for j, ((gk, kk), (gp, kp)) in enumerate(zip(kern_calls, plain_calls)):
        layer, step = j % n_layers, j // n_layers
        same = (gk == gp) & (kk == kp)                 # (G, Tg, K)
        agree[layer][0] += int(same.sum())
        agree[layer][1] += same.numel()
        own = same.all(-1)                             # (G, Tg)
        if layer == 0:
            equal_below = torch.ones_like(own)
        fresh[layer] += int((equal_below & ~own).sum())
        equal_below &= own
        # the row's own token: the prompt's last (prefill) or the step's
        row_ok[:, step] &= own[:, -1] if step == 0 else own[0]
    shares = [a / n for a, n in agree]
    checked = float(row_ok.float().mean())
    row_err = (logits - ref_all).abs().amax(-1)
    err = float(row_err[row_ok].max()) if bool(row_ok.any()) \
        else float("inf")
    top2 = ref_all.topk(2, dim=-1).values
    decided = ((top2[..., 0] - top2[..., 1]) > 2 * tol) & row_ok
    token_ok = (tokens == ref_all.argmax(-1)) | ~decided
    log(f"  {what} vs {against}: routes agreeing by layer "
        + ", ".join(f"{x:.5f}" for x in shares)
        + f" (floor {ROUTE_AGREE_FLOOR}); tokens whose routes first part "
        f"there {fresh}; {int(row_ok.sum())} of {B * gen} "
        f"logit rows with every own route equal (floor "
        f"{ROUTE_CHECKED_FLOOR:.0%}): max_abs_err {err:.4f} (bound {tol}); "
        f"decided tokens {int(decided.sum())}, all equal: "
        f"{bool(token_ok.all())}")
    require(min(shares) >= ROUTE_AGREE_FLOOR,
            f"{what}: routes agree on {min(shares):.5f} of a layer's, under "
            f"{ROUTE_AGREE_FLOOR}")
    require(checked >= ROUTE_CHECKED_FLOOR,
            f"{what}: only {checked:.3f} of the logit rows have every own "
            f"route equal, under {ROUTE_CHECKED_FLOOR}")
    require(err <= tol, f"{what}: logits differ from {against} by "
                        f"{err:.4f} > {tol} on a row whose routes agree")
    require(bool(token_ok.all()),
            f"{what}: a greedy token decided by more than twice the logit "
            f"tolerance differs from {against}")
    flips = [n - a for a, n in agree]
    return dict(route_agree_by_layer=shares, route_flips_by_layer=flips,
                first_parting_tokens_by_layer=fresh,
                rows_checked=int(row_ok.sum()), rows=B * gen,
                logit_err_checked=err, tokens_decided=int(decided.sum()))


def _dropped(calls, n_layers) -> dict:
    """Entries sent to the overflow slot by layer: the prefill's, and the
    decode steps' summed."""
    pre = [int((~kept).sum()) for _, kept in calls[:n_layers]]
    dec = [0] * n_layers
    for j, (_, kept) in enumerate(calls[n_layers:]):
        dec[j % n_layers] += int((~kept).sum())
    return {"prefill": pre, "decode": dec}


def step_breakdown(lm, params, prompts) -> list:
    """Where one eager decode step's card time goes (the captured step
    runs the same kernels): ``[name, count, ms]`` by kernel, largest
    first; empty when the trace holds no device event."""
    from repro_torch.launch import serve

    lg, cache = lm.prefill(params, {"tokens": prompts})
    cache = serve.merge_cache(lm.empty_cache(BATCH, PROMPT + GEN), cache)
    tok = lg.argmax(-1)
    prof = device_time_by_kernel(
        lambda: lm.decode_step(params, cache, tok, PROMPT))
    if prof is None:
        return []
    busy, by = prof
    rows = sorted(([name, n, ms] for name, (n, ms) in by.items()),
                  key=lambda r: -r[2])
    log(f"  {lm.cfg.name}: one eager decode step keeps the card busy "
        f"{busy:.3f} ms; by kernel: "
        + "; ".join(f"{name[:60]} x{n} {ms:.3f}" for name, n, ms in rows[:6]))
    return rows[:12]


def routed_logits(lm, ref_lm, params, prompts, run) -> dict:
    """An MoE config's logits against the plain versions: an eager
    generate (``torch.equal`` to ``run``'s captured one) and the plain
    versions fed its tokens, every ``_dispatch`` call of both recorded,
    held by :func:`judge_routed_logits` — which must also fail on the
    same logits moved by twice its bound —, and the entries each layer
    dropped past capacity."""
    import torch
    from repro_torch.launch import serve

    arch, n = lm.cfg.name, lm.cfg.n_layers
    with _RecordedRoutes() as kern:
        tokens, logits = serve.generate(
            lm, params, prompts, PROMPT + GEN, GEN, prefill_fn=lm.prefill,
            decode_fn=lm.decode_step, return_logits=True)
    require(torch.equal(tokens, run["tokens"])
            and torch.equal(logits, run["logits"]),
            f"{arch}: the recorded eager generate differs from the captured")
    with _RecordedRoutes() as plain:
        ref_all = plain_logits(ref_lm, params, prompts, tokens)
    tol, top = ulp_logit_tol(arch, ref_all, UNTIED_LOGIT_RANGE)
    judged = judge_routed_logits(arch, n, kern.calls, plain.calls, logits,
                                 tokens, ref_all, tol)
    try:
        judge_routed_logits(f"{arch} (logits moved by {2 * tol:g}, must "
                            "fail)", n, kern.calls, plain.calls,
                            logits + 2 * tol, tokens, ref_all, tol)
    except SmokeFailure:
        pass
    else:
        raise SmokeFailure(f"{arch}: the routed logit gate passed logits "
                           "moved past its bound")
    dropped = _dropped(kern.calls, n)
    k = lm.cfg.n_experts_active
    log(f"  {arch}: entries dropped past capacity by layer: prefill "
        f"{dropped['prefill']} of {BATCH * PROMPT * k} a layer, decode "
        f"{dropped['decode']} of {(GEN - 1) * BATCH * k} a layer ({GEN - 1} "
        f"steps); the plain run's {_dropped(plain.calls, n)}")
    return dict(logit_max=top, logit_tol=tol, dropped=dropped, **judged)


def llama4_emulate(dev, params, prompts) -> dict:
    """Phase 11 (c): llama4-scout (SERVED_LAYERS) with ``--emulate``,
    LLAMA4_EMULATE_GEN tokens, (b)'s params and prompts: 7 logmatmul
    launches a layer a prefill and a step (the attention's four linears
    and the shared expert's three) besides (b)'s, captured ``torch.equal``
    to eager, a replayed prefill equal to the eager one."""
    from repro_torch.models import build

    arch = "llama4-scout-17b-a16e"
    cfg = served_config(arch, emulate=True)
    require(cfg.approx.emulate and cfg.approx.width == 8,
            "not the --emulate serving config")
    run = policy_generate(dev, build(cfg), params, prompts,
                          f"{arch} --emulate",
                          linears=LLAMA4_EMULATED_LINEARS * cfg.n_layers,
                          gen=LLAMA4_EMULATE_GEN)
    log(f"  {arch} --emulate: first generate (autotune, captures) "
        f"{run['first_generate_s']:.1f}s, captured generate of "
        f"{LLAMA4_EMULATE_GEN} tokens {run['generate_s'] * 1e3:.1f} ms")
    return dict(counts=run["counts"], gen=LLAMA4_EMULATE_GEN,
                first_generate_s=run["first_generate_s"],
                generate_captured_ms=run["generate_s"] * 1e3)


def moe_family_phase(dev) -> dict:
    """Phase 11: (a) mixtral-8x7b, (b) llama4-scout and (c) llama4-scout
    ``--emulate`` at full width, depth cut to SERVED_LAYERS; every earlier
    model's graphs are dropped first and each model's after it."""
    _drop_served_graphs()
    out = {}
    log("  (a) mixtral-8x7b at full width, "
        f"{SERVED_LAYERS['mixtral-8x7b']} of 32 layers, --approx simdive")
    a = served_generate(dev, "mixtral-8x7b")
    del a["params"], a["prompts"]
    out["mixtral-8x7b"] = a
    _drop_served_graphs()
    arch = "llama4-scout-17b-a16e"
    log(f"  (b) {arch} at full width, {SERVED_LAYERS[arch]} of 48 layers, "
        "--approx simdive")
    b = served_generate(dev, arch)
    params, prompts = b.pop("params"), b.pop("prompts")
    out[arch] = b
    _drop_served_graphs()
    log(f"  (c) {arch} --emulate, {LLAMA4_EMULATE_GEN} tokens")
    out[f"{arch} --emulate"] = llama4_emulate(dev, params, prompts)
    del params, prompts
    _drop_served_graphs()
    return out


# ------------------------------ phase 12: the modality-stub families --
def modality_kernel_times(dev, int_rate) -> dict:
    """Phase 12 (k): :func:`attention_times` at each MODALITY_ATTENTION
    configuration's shapes: qwen2-vl-2b's prefill q (48, 512, 128) / kv
    (8, 512, 128) G 6 and step (4, 2, 6, 128) over 544 slots, cluster 8;
    musicgen-medium's (96, 512, 64) G 1 and (4, 24, 1, 64), cluster 2."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    out = {}
    for arch, H, KV, dh, _ in MODALITY_ATTENTION:
        out.update(attention_times(dev, gen, arch, H, KV, dh, int_rate))
    return out


def vision_batch(dev, d_model) -> dict:
    """Phase 12 (a)'s vision-stub fields for a (BATCH, PROMPT) prompt:
    VISION_GRID ** 2 patch embeddings (normal at the token embeddings'
    scale, d_model ** -0.5, seed SEED + 12) masked in at slots 0 to n - 1,
    and Qwen2-VL's M-RoPE positions (BATCH, PROMPT, 3): image slot ``r *
    grid + c`` at (0, r, c), the text after it at ``grid + j`` on all
    three coordinates."""
    import torch

    n = VISION_GRID ** 2
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    patches = torch.randn((BATCH, n, d_model), generator=gen,
                          device=dev) * d_model ** -0.5
    mask = torch.zeros((BATCH, PROMPT), dtype=torch.bool, device=dev)
    mask[:, :n] = True
    idx = torch.arange(n, device=dev)
    pos = torch.empty((PROMPT, 3), dtype=torch.int64, device=dev)
    pos[:n, 0] = 0
    pos[:n, 1] = idx // VISION_GRID
    pos[:n, 2] = idx % VISION_GRID
    pos[n:] = (VISION_GRID + torch.arange(PROMPT - n, device=dev))[:, None]
    return {"patch_embeds": patches, "patch_mask": mask,
            "positions": pos.expand(BATCH, PROMPT, 3)}


def vision_generate(dev, params, prompts) -> dict:
    """Phase 12 (a), the vision stub: qwen2-vl-2b's prompts with
    :func:`vision_batch` merged in, the prefill through the eager
    ``lm.prefill`` (the captured prefill takes tokens alone, as the
    reference's serving path passes them), then GEN - 1 steps through the
    captured decode step (a replay of (a)'s graph: no capture) from the
    merged cache, at ``PROMPT + i`` on all three coordinates as the
    reference's ``decode_step`` continues. One attention launch a layer
    for the prefill and one decode_attention a layer a step, nothing
    else; the logits within :func:`ulp_logit_tol` of the plain versions
    fed the same batch and tokens, decided tokens equal. The gate: the
    same prefill with (B, P) arange positions (plain RoPE) must move the
    logits past twice that bound, or the sections were ignored."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import build

    arch = "qwen2-vl-2b"
    cfg = served_config(arch)
    lm = build(cfg)
    ref_lm = build(replace(cfg, approx=replace(cfg.approx, backend="ref")))
    extra = vision_batch(dev, cfg.d_model)
    step = serve.make_decode_step(lm)
    captures = step.captures
    n = cfg.n_layers
    reset_launch_counts()
    tokens, logits = serve.generate(
        lm, params, prompts, PROMPT + GEN, GEN, return_logits=True,
        prefill_fn=lambda p, batch: lm.prefill(p, {**batch, **extra}))
    torch.cuda.synchronize()
    counts = launch_counts()
    require(step.captures == captures,
            f"{arch} vision stub: the decode step captured again")
    require(_attention_launches(counts) == n
            and counts["decode_attention"] == n * (GEN - 1)
            and _matmul_launches(counts) == 0
            and counts["elemwise"] == counts["sqrt"] == counts["packed"] == 0,
            f"{arch} vision stub: launches {counts}, expected {n} attention "
            f"and {n} decode_attention per step x {GEN - 1}")
    require(bool(torch.isfinite(logits).all()) and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab_size,
            f"{arch} vision stub: bad output")
    what = f"{arch} vision stub"
    ref_all = plain_logits(ref_lm, params, prompts, tokens, extra)
    tol, top = ulp_logit_tol(what, ref_all, UNTIED_LOGIT_RANGE)
    judged = judge_logits(what, logits, tokens, ref_all, tol)
    del ref_all
    flat, _ = lm.prefill(params, {"tokens": prompts, **{
        k: v for k, v in extra.items() if k != "positions"}})
    moved = float((flat.float() - logits[:, 0]).abs().max())
    log(f"  {what}: {VISION_GRID ** 2} patches at slots 0-"
        f"{VISION_GRID ** 2 - 1}, M-RoPE sections {cfg.mrope_sections}; "
        f"launches {counts}; the same prefill with (B, P) positions moves "
        f"the logits by {moved:.4f} (gate: > {2 * tol:g})")
    require(moved > 2 * tol, f"{what}: the M-RoPE positions moved the "
            f"prefill's logits by {moved:.4f} only: sections ignored?")
    return dict(counts=counts, logit_max=top, logit_tol=tol,
                moved_by_plain_positions=moved, **judged)


def musicgen_emulate(dev, params, prompts) -> dict:
    """Phase 12 (c): musicgen-medium with ``--emulate``,
    MUSICGEN_EMULATE_GEN tokens, (b)'s params and (4, 512, 4) prompts: 6
    logmatmul launches a layer a prefill and a step (the attention's four
    linears and the gelu MLP's two; the codebook heads exact) besides
    (b)'s, captured ``torch.equal`` to eager, a replayed prefill equal to
    the eager one."""
    from repro_torch.launch import serve
    from repro_torch.models import build

    arch = "musicgen-medium"
    cfg = served_config(arch, emulate=True)
    require(cfg.approx.emulate and cfg.approx.width == 8,
            "not the --emulate serving config")
    run = policy_generate(dev, build(cfg), params, prompts,
                          f"{arch} --emulate",
                          linears=MUSICGEN_EMULATED_LINEARS * cfg.n_layers,
                          gen=MUSICGEN_EMULATE_GEN)
    log(f"  {arch} --emulate: first generate (autotune, captures) "
        f"{run['first_generate_s']:.1f}s, captured generate of "
        f"{MUSICGEN_EMULATE_GEN} tokens {run['generate_s'] * 1e3:.1f} ms")
    return dict(counts=run["counts"], gen=MUSICGEN_EMULATE_GEN,
                first_generate_s=run["first_generate_s"],
                generate_captured_ms=run["generate_s"] * 1e3)


def modality_family_phase(dev, int_rate) -> dict:
    """Phase 12: (k) the attention kernels' times at both configurations'
    shapes, then (a) qwen2-vl-2b whole (text, then the vision stub), (b)
    musicgen-medium and (c) musicgen-medium ``--emulate``, its depth cut to
    SERVED_LAYERS; every earlier model's graphs are dropped first and each
    model's after it."""
    _drop_served_graphs()
    out = {"kernels": modality_kernel_times(dev, int_rate)}
    log("  (a) qwen2-vl-2b whole (28 layers), --approx simdive")
    a = served_generate(dev, "qwen2-vl-2b")
    log(f"  (a) qwen2-vl-2b with the vision stub: a {VISION_GRID} x "
        f"{VISION_GRID} patch grid, M-RoPE positions")
    a["vision"] = vision_generate(dev, a.pop("params"), a.pop("prompts"))
    out["qwen2-vl-2b"] = a
    _drop_served_graphs()
    log(f"  (b) musicgen-medium at full width, "
        f"{SERVED_LAYERS['musicgen-medium']} of 48 layers, 4 codebooks, "
        "--approx simdive")
    b = served_generate(dev, "musicgen-medium")
    params, prompts = b.pop("params"), b.pop("prompts")
    out["musicgen-medium"] = b
    _drop_served_graphs()
    log(f"  (c) musicgen-medium --emulate, {MUSICGEN_EMULATE_GEN} tokens")
    out["musicgen-medium --emulate"] = musicgen_emulate(dev, params, prompts)
    del params, prompts
    _drop_served_graphs()
    return out


# ------------------------------------------- phase 13: the rwkv6 stack --
def wkv_against_f64(dev, gen) -> dict:
    """Phase 13 (a): ``_wkv_chunk`` at full width (B 4, Tc RWKV6_PREFIX,
    H 32, dk 64) from a nonzero state, decays ``exp(-exp(u))`` with u in
    (-6, 0.5) (0.19-0.9975, as the CPU test draws them), against itself on
    the same inputs in float64: the largest |difference| of the outputs
    and of the new state over the largest |float64 value|, under
    WKV_F64_REL_TOL."""
    import torch
    from repro_torch.models import ssm

    B, Tc, H, dk = BATCH, RWKV6_PREFIX, 32, 64

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    state = torch.randn((B, H, dk, dk), generator=gen, device=dev)
    r, k, v = (torch.randn((B, Tc, H, dk), generator=gen, device=dev)
               for _ in range(3))
    w = torch.exp(-torch.exp(uniform((B, Tc, H, dk), -6.0, 0.5)))
    u = uniform((H, dk), -0.5, 0.5)
    args = (state, r, k, v, w, u)
    got = ssm._wkv_chunk(*args)
    want = ssm._wkv_chunk(*(t.double() for t in args))
    rel = {name: float((g.double() - ww).abs().max() / ww.abs().max())
           for name, g, ww in zip(("state", "y"), got, want)}
    log(f"  _wkv_chunk (B {B}, Tc {Tc}, H {H}, dk {dk}) float32 vs float64 "
        f"on the card: largest |difference| over the largest |value| "
        f"{rel} (bound {WKV_F64_REL_TOL:g})")
    require(all(got[i].dtype == torch.float32 for i in (0, 1))
            and max(rel.values()) <= WKV_F64_REL_TOL,
            f"_wkv_chunk float32 parts from float64 by {rel}")
    return rel


def chunk_vs_step(dev, params, prompts) -> dict:
    """Phase 13 (a): the eager prefill of rwkv6-1.6b over the prompts'
    first RWKV6_PREFIX tokens (one whole chunk) against the same tokens
    fed one at a time through the eager decode step from a zero cache: for
    each cache leaf and the last logits, the largest |difference| over the
    largest |prefill value|. At float32 activations only the grouping of
    float32 sums differs: under CHUNK_VS_STEP_F32_REL_TOL. At the served
    bf16 activations both round the residual stream, the token shifts and
    the output projection's inputs to bf16, and 24 layers carry each
    rounding on: the two must stay closer to each other than the bf16
    prefill is to the float32 one (the served dtype's own distance from
    float32 serving, measured alongside)."""
    from repro_torch.launch import serve
    from repro_torch.models import build

    toks = prompts[:, :RWKV6_PREFIX]
    runs = {}
    for dtype in ("float32", "bfloat16"):
        lm = build(replace(served_config(RWKV6), dtype=dtype))
        logits, cache = lm.prefill(params, {"tokens": toks})
        stepped = lm.empty_cache(BATCH, RWKV6_PREFIX)
        for i in range(RWKV6_PREFIX):
            step_logits, _ = lm.decode_step(params, stepped, toks[:, i], i)
        runs[dtype] = [{"/".join(p): t.float() for p, t in
                        serve.cache_leaves({**c, "logits": lg})}
                       for c, lg in ((cache, logits),
                                     (stepped, step_logits))]

    def rel(want, got):
        return {k: float((got[k] - a).abs().max() / a.abs().max())
                for k, a in want.items()}

    out = {"float32": rel(*runs["float32"]),
           "bfloat16": rel(*runs["bfloat16"]),
           "bfloat16_prefill_vs_float32": rel(runs["float32"][0],
                                              runs["bfloat16"][0])}
    for key, val in out.items():
        what = "the bf16 prefill vs the float32 one" if "prefill" in key \
            else (f"{key}: the prefill over {RWKV6_PREFIX} tokens vs the "
                  "same tokens one decode step at a time")
        log(f"  {RWKV6} {what}, largest |difference| over the largest "
            f"|value|: {val}")
    noise = max(out["bfloat16_prefill_vs_float32"].values())
    require(max(out["float32"].values()) <= CHUNK_VS_STEP_F32_REL_TOL,
            f"{RWKV6} float32: chunked prefill and stepwise decode part by "
            f"{out['float32']} > {CHUNK_VS_STEP_F32_REL_TOL}")
    require(max(out["bfloat16"].values()) <= noise,
            f"{RWKV6} bfloat16: chunked prefill and stepwise decode part by "
            f"{out['bfloat16']}, more than the bf16 prefill from the float32 "
            f"one ({noise})")
    return out


def rwkv6_phase(dev, int_rate) -> dict:
    """Phase 13: rwkv6-1.6b (SERVED_LAYERS), after every earlier model's
    graphs are dropped. (k) ``logmatmul`` at its eight linears' shapes
    beside their bound and an exact float32 ``torch.matmul`` (phase 3
    holds them bit for bit); (a) divider-only (:func:`served_generate`:
    no SIMDive kernel launches), the chunked prefill against the stepwise
    decode (:func:`chunk_vs_step`) and the WKV chunk against float64
    (:func:`wkv_against_f64`); (c) ``--emulate``, RWKV6_EMULATE_GEN
    tokens: 8 ``logmatmul`` a layer a prefill and a step, the head exact,
    captured == eager. Float32 matmuls must run at full precision (no
    TF32): seven of the eight linears multiply float32 activations."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.models.model import LM

    _drop_served_graphs()
    require(torch.get_float32_matmul_precision() == "highest"
            and not torch.backends.cuda.matmul.allow_tf32,
            "float32 matmuls are not at full precision (TF32 is on)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    out = {"kernels": {f"logmatmul {RWKV6}": linear_times(
        dev, gen, RWKV6, RWKV6_LINEARS, int_rate, torch.float32)}}
    cfg = served_config(RWKV6)
    cache_bytes = {"/".join(p): t.numel() * t.element_size()
                   for p, t in serve.cache_leaves(LM(
                       cfg, torch.device("meta")).empty_cache(BATCH, 1))}
    log(f"  (a) {RWKV6} at full width, {cfg.n_layers} of 24 layers, "
        "--approx simdive; "
        f"its serving cache {cache_bytes} bytes, no seq axis")
    a = served_generate(dev, RWKV6)
    require(not any(a["counts"].values()),
            f"{RWKV6} divider-only launched {a['counts']}")
    log(f"  {RWKV6}: no SIMDive kernel launched ({a['counts']})")
    a["cache_bytes"] = cache_bytes
    a["chunk_vs_step"] = chunk_vs_step(dev, a["params"], a["prompts"])
    a["wkv_f64"] = wkv_against_f64(dev, gen)
    params, prompts = a.pop("params"), a.pop("prompts")
    out[RWKV6] = a
    _drop_served_graphs()
    log(f"  (c) {RWKV6} --emulate, {RWKV6_EMULATE_GEN} tokens")
    ecfg = served_config(RWKV6, emulate=True)
    require(ecfg.approx.emulate and ecfg.approx.width == 8,
            "not the --emulate serving config")
    run = policy_generate(dev, build(ecfg), params, prompts,
                          f"{RWKV6} --emulate",
                          linears=len(RWKV6_LINEARS) * ecfg.n_layers,
                          gen=RWKV6_EMULATE_GEN)
    log(f"  {RWKV6} --emulate: first generate (autotune, captures) "
        f"{run['first_generate_s']:.1f}s, captured generate of "
        f"{RWKV6_EMULATE_GEN} tokens {run['generate_s'] * 1e3:.1f} ms")
    out[f"{RWKV6} --emulate"] = dict(
        counts=run["counts"], gen=RWKV6_EMULATE_GEN,
        first_generate_s=run["first_generate_s"],
        generate_captured_ms=run["generate_s"] * 1e3)
    del params, prompts, run
    _drop_served_graphs()
    return out


# ---------------------------------------- phase 14: the hybrid stack --
def seeded_lora_b(params) -> None:
    """zamba2's ``lora_b`` (zeros at init, so the merge adds nothing to
    ``wq``) given a normal draw of std r^-0.5 from SEED + 14, in place,
    before any graph is captured."""
    import torch

    lb = params["stack"]["lora_b"]
    gen = torch.Generator(device=lb.device).manual_seed(SEED + 14)
    lb.copy_(torch.randn(lb.shape, generator=gen, device=lb.device)
             * lb.shape[1] ** -0.5)


def lora_merge_ms(params) -> float:
    """One shared-block LoRA merge as the stack makes it on every call
    (``hybrid_shared``: ``wq + la @ lb``, the pair in bf16, the sum in
    f32), graph-replayed."""
    import torch
    from repro_torch.models.transformer import hybrid_shared

    return gpu_graph_time_ms(lambda: hybrid_shared(
        params["stack"], 0, torch.bfloat16)["wq"], iters=20)


def zamba2_phase(dev, int_rate) -> dict:
    """Phase 14: zamba2-2.7b (SERVED_LAYERS), after every earlier model's
    graphs are dropped. (k) the attention kernels at its shapes
    (:func:`attention_times` at d_head 80, and the step over 2,048 slots)
    and ``logmatmul`` at its Mamba2 layer's and shared block's linears,
    each beside its bound; (a) divider-only (:func:`served_generate`,
    ``lora_b`` seeded first): one attention a prefill and one
    decode_attention a step an invocation, nothing else, captured
    == eager, within 6 bf16 ulps of the plain versions; the cache's bytes
    and one LoRA merge's time; (c) ``--emulate``, ZAMBA2_EMULATE_GEN
    tokens: 6 ``logmatmul`` a Mamba2 layer and 6 a shared-block
    invocation a prefill and a step, captured == eager."""
    import torch
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.models.model import LM

    _drop_served_graphs()
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    kernels = {}
    for arch, H, KV, dh, _ in HYBRID_ATTENTION:
        kernels.update(attention_times(dev, gen, arch, H, KV, dh, int_rate))
        t = time_decode_attention(dev, gen, BATCH, 2048, KV, H // KV, dh,
                                  2047, SimdiveSpec(width=16, coeff_bits=6),
                                  15, int_rate)
        row = kernels[f"decode_attention {arch} cache 2048"] = {
            key: t[key] for key in ("ms", "library_ms", "bound_ms",
                                    "bound_by", "cluster")}
        log(f"  decode attention, {arch}'s step over 2048 slots, pos 2047: "
            f"{row['ms']:.5f} ms (graph, cluster {row['cluster']}), "
            f"scaled_dot_product_attention {row['library_ms']:.5f} ms, bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
        del t
    for part, linears in (("mamba2", ZAMBA2_MAMBA_LINEARS),
                          ("shared", ZAMBA2_SHARED_LINEARS)):
        kernels[f"logmatmul {ZAMBA2} {part}"] = linear_times(
            dev, gen, f"{ZAMBA2} {part}", linears, int_rate, torch.bfloat16,
            check_rows=ZAMBA2_CHECK_ROWS)
    out = {"kernels": kernels}
    cfg = served_config(ZAMBA2)
    cache_bytes = {"/".join(p): t.numel() * t.element_size()
                   for p, t in serve.cache_leaves(LM(
                       cfg, torch.device("meta")).empty_cache(
                           BATCH, PROMPT + GEN))}
    n_inv = cfg.n_layers // cfg.hybrid_period
    log(f"  (a) {ZAMBA2} at full width, {cfg.n_layers} of 54 Mamba2 "
        "layers (the shared "
        f"block {n_inv} times), --approx simdive, lora_b seeded; its "
        f"serving cache {cache_bytes} bytes")
    a = served_generate(dev, ZAMBA2, prepare=seeded_lora_b)
    a["cache_bytes"] = cache_bytes
    params, prompts = a.pop("params"), a.pop("prompts")
    a["lora_merge_ms"] = lora_merge_ms(params)
    log(f"  {ZAMBA2}: one LoRA merge (wq + la @ lb, made on every call: "
        f"{n_inv} a prefill and a step) {a['lora_merge_ms']:.5f} ms")
    out[ZAMBA2] = a
    _drop_served_graphs()
    log(f"  (c) {ZAMBA2} --emulate, {ZAMBA2_EMULATE_GEN} tokens")
    ecfg = served_config(ZAMBA2, emulate=True)
    require(ecfg.approx.emulate and ecfg.approx.width == 8,
            "not the --emulate serving config")
    linears = (len(ZAMBA2_MAMBA_LINEARS) * ecfg.n_layers
               + len(ZAMBA2_SHARED_LINEARS) * n_inv)
    require(linears == 6 * cfg.n_layers + 6 * n_inv,
            f"{ZAMBA2}: {linears} linears a prefill")
    run = policy_generate(dev, build(ecfg), params, prompts,
                          f"{ZAMBA2} --emulate", linears=linears,
                          gen=ZAMBA2_EMULATE_GEN)
    log(f"  {ZAMBA2} --emulate: first generate (autotune, captures) "
        f"{run['first_generate_s']:.1f}s, captured generate of "
        f"{ZAMBA2_EMULATE_GEN} tokens {run['generate_s'] * 1e3:.1f} ms")
    out[f"{ZAMBA2} --emulate"] = dict(
        counts=run["counts"], gen=ZAMBA2_EMULATE_GEN,
        first_generate_s=run["first_generate_s"],
        generate_captured_ms=run["generate_s"] * 1e3)
    del params, prompts, run
    _drop_served_graphs()
    return out


# ------------------------------------------------------------ phase 15 --
def _tree_equal(a, b) -> tuple[bool, float, list]:
    """Whether two trees of tensors are equal leaf for leaf (a ``None``
    gradient leaf equal only to ``None``): ``(equal, largest absolute
    difference, the paths that differ)``."""
    from repro_torch.core.tree import tree_leaves

    def paths(t, p=()):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from paths(t[k], p + (k,))
        else:
            yield "/".join(p)

    worst, bad = 0.0, []
    for path, x, y in zip(paths(a), tree_leaves(a), tree_leaves(b)):
        if x is None or y is None:
            if (x is None) != (y is None):
                bad.append(path)
            continue
        if not torch_equal(x, y):
            bad.append(path)
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return not bad, worst, bad


def torch_equal(x, y) -> bool:
    import torch

    return x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)


def train_kernel_checks(dev, int_rate) -> dict:
    """Phase 15 (a): the kernels at the training path's new shapes.
    ``logmatmul`` at smollm-360m's gradient products — gx (2048, N_out) x
    (N_out, K_in) and gw (K_in, 2048) x (2048, N_out) of ``wq`` and
    ``w2`` — every registered block ``torch.equal`` to its plain version on
    the first TRAIN_CHECK_ROWS rows, each timed (graph replay) beside its
    bound; ``elemwise`` at the training finalize's (4, 5, 3, 512, 64)
    lanes (the divider of ``attention_div``, w16 cb6 fo15) ``torch.equal``
    to its plain version, and ``attention_div`` on the card equal to it on
    the plain version."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.approx import ApproxConfig, attention_div
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import get_op
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import logmatmul as lmm

    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    spec8 = SimdiveSpec(width=8, coeff_bits=6)
    blocks = get_op("matmul_int", spec8).entry.block_candidates
    M = TRAIN_BATCH * TRAIN_SEQ
    products = {}
    for name, k_in, n_out in TRAIN_GRAD_LINEARS:
        for prod, (m, k, n) in (("gx", (M, n_out, k_in)),
                                ("gw", (k_in, M, n_out))):
            x = torch.randint(-255, 256, (m, k), generator=gen, device=dev,
                              dtype=torch.int32)
            w = torch.randint(-255, 256, (k, n), generator=gen, device=dev,
                              dtype=torch.int32)
            torch.cuda.synchronize()
            t0 = wall_clock()
            want = lmm.logmatmul_ref(x[:TRAIN_CHECK_ROWS], w, spec8)
            torch.cuda.synchronize()
            plain_ms = (wall_clock() - t0) * 1e3
            by_block = {}
            for b in blocks:
                got = lmm.logmatmul_cuda(x, w, spec8, b)
                require(torch_equal(got[:TRAIN_CHECK_ROWS], want),
                        f"logmatmul {name} {prod} ({m}, {k}) x ({k}, {n}) "
                        f"block {b}: not bit-equal to its plain version")
                by_block[b] = gpu_graph_time_ms(
                    lambda b=b: lmm.logmatmul_cuda(x, w, spec8, b), iters=3)
            best = min(blocks, key=by_block.get)
            ops_ms = logmatmul_ops_ms(m, k, n, int_rate)
            bytes_ms = (m * k + k * n + m * n) * 4 / HBM_BYTES_PER_S * 1e3
            row = products[f"{name} {prod}"] = {
                "shape": [m, k, n], "ms": by_block[best],
                "block": list(best),
                "ms_by_block": {str(list(b)): t for b, t in by_block.items()},
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "plain_ms_rows": plain_ms, "plain_rows": TRAIN_CHECK_ROWS,
                "max_abs_err": 0, "library_ms": None}
            log(f"  logmatmul {name} {prod} ({m}, {k}) x ({k}, {n}): "
                f"{row['ms']:.4f} ms (block {row['block']}), bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
                f"{row['ms'] / row['bound_ms']:.2f}x); every block "
                f"bit-equal on {TRAIN_CHECK_ROWS} rows (plain "
                f"{plain_ms:.1f} ms)")
            del x, w, want, got
    cfg = get_config(ARCH)
    KV, G, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    shape = (TRAIN_BATCH, KV, G, TRAIN_SEQ, dh)
    acc = torch.randn(shape, generator=gen, device=dev) * 3
    l = torch.rand(shape[:-1], generator=gen, device=dev) * 60 + 1
    spec16 = SimdiveSpec(width=16, coeff_bits=6)
    qn, qd = fa.softmax_div_quantize(acc, l, spec16.width)
    a = qn.to(torch.int32).view(torch.uint32)
    b = qd.expand_as(qn).to(torch.int32).view(torch.uint32)
    kern = lambda: get_op("elemwise", spec16, "cuda")(a, b, op="div",
                                                      frac_out=15)
    plain = lambda: get_op("elemwise", spec16, "ref")(a, b, op="div",
                                                      frac_out=15)
    require(torch_equal(kern(), plain()),
            f"elemwise at the training finalize's {shape}: not bit-equal")
    approx = ApproxConfig(mode="simdive")
    require(torch_equal(attention_div(acc, l, approx),
                        attention_div(acc, l, replace(approx,
                                                      backend="ref"))),
            "attention_div on the card differs from its plain version")
    lanes = a.numel()
    ops_ms = ELEMWISE_OPS_PER_LANE * lanes / int_rate * 1e3
    bytes_ms = 12 * lanes / HBM_BYTES_PER_S * 1e3
    finalize = {"shape": list(shape), "lanes": lanes,
                "ms": gpu_graph_time_ms(kern, iters=50),
                "eager_ms": gpu_time_ms(kern, iters=50),
                "plain_ms": gpu_time_ms(plain, iters=5),
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "max_abs_err": 0, "library_ms": None}
    log(f"  elemwise at the training finalize's {shape} ({lanes} lanes, "
        f"w16 cb6 fo15): {finalize['ms']:.5f} ms (graph), bound "
        f"{finalize['bound_ms']:.5f} ms ({finalize['bound_by']}), plain "
        f"{finalize['plain_ms']:.3f} ms; bit-equal")
    return {"products": products, "finalize": finalize}


def _matmuls(counts) -> int:
    return counts.get("matmul", 0) + counts.get("matmul_pipelined", 0)


def train_step_check(dev) -> dict:
    """Phase 15 (b): one training step of smollm-360m at full width, 2 of
    32 layers, batch 2 x seq 128, ``--approx simdive --backward approx``,
    on the kernels and with every op on its plain version (``backend=
    'ref'`` on the card), from the same parameters and batch: the loss,
    every gradient leaf (``None`` where R-8 leaves none) and the AdamW
    update ``torch.equal``, and ``make_train_step``'s step equal to the
    gradient and update taken apart. The kernels' gradient run launches
    2 x TRAIN_LOGMATMUL_A_LAYER ``logmatmul`` and 2 x 2 ``elemwise``."""
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.approx import ApproxConfig
    from repro_torch.core.tree import value_and_grad
    from repro_torch.data import make_source, torch_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import build
    from repro_torch.optim import adamw, cosine_schedule

    approx = ApproxConfig(mode="simdive", backward="approx")
    cfg = replace(get_config(ARCH), n_layers=STEP_CHECK_LAYERS
                  ).with_approx(approx)
    lm = build(cfg, dev)
    lm_ref = build(cfg.with_approx(replace(approx, backend="ref")), dev)
    params = lm.init(SEED)
    opt = adamw(cosine_schedule(TRAIN_LR, warmup=1, total=TRAIN_STEPS))
    state = opt.init(params)
    batch = torch_batch(make_source(cfg, ShapeConfig(
        "check", STEP_CHECK_SEQ, STEP_CHECK_BATCH, "train"), seed=SEED
    ).batch(0), dev)
    value_and_grad(lm.train_loss)(params, batch)     # the autotune, warm
    reset_launch_counts()
    loss, grads = value_and_grad(lm.train_loss)(params, batch)
    counts = launch_counts()
    new_p, new_s, _ = opt.update(grads, state, params)
    step_p, step_s, step_m = make_train_step(lm, opt)(params, state, batch)
    require(torch_equal(step_m["loss"], loss)
            and _tree_equal(step_p, new_p)[0]
            and _tree_equal(step_s, new_s)[0],
            "make_train_step differs from value_and_grad + opt.update")
    torch.cuda.synchronize()
    t0 = wall_clock()
    loss_r, grads_r = value_and_grad(lm_ref.train_loss)(params, batch)
    torch.cuda.synchronize()
    plain_s = wall_clock() - t0
    new_pr, new_sr, _ = opt.update(grads_r, state, params)
    out = {"loss": float(loss), "loss_plain": float(loss_r),
           "plain_grad_s": plain_s,
           "logmatmul_launches": _matmuls(counts),
           "elemwise_launches": counts["elemwise"]}
    for what, x, y in (("grads", grads, grads_r), ("params", new_p, new_pr),
                       ("opt_state", new_s, new_sr)):
        eq, worst, bad = _tree_equal(x, y)
        out[f"{what}_equal"], out[f"{what}_max_abs_diff"] = eq, worst
        out[f"{what}_differing"] = bad
    log(f"  (b) one step, kernels vs plain versions ({STEP_CHECK_LAYERS} "
        f"layers, batch {STEP_CHECK_BATCH} x {STEP_CHECK_SEQ}): loss "
        f"{out['loss']!r} / {out['loss_plain']!r}; grads equal "
        f"{out['grads_equal']} (max {out['grads_max_abs_diff']:.3g}), "
        f"params {out['params_equal']}, opt state {out['opt_state_equal']}; "
        f"{out['logmatmul_launches']} logmatmul, "
        f"{out['elemwise_launches']} elemwise; plain gradients "
        f"{plain_s:.1f}s")
    layers = [grads["stack"]["layers"][n] for n in ("wq", "wk", "wv")]
    require(all(g is None for g in layers),
            "R-8: the divider should leave wq / wk / wv without gradient")
    require(torch_equal(loss, loss_r) and out["grads_equal"]
            and out["params_equal"] and out["opt_state_equal"],
            f"one step on the kernels differs from the plain versions: {out}")
    require(out["logmatmul_launches"]
            == STEP_CHECK_LAYERS * TRAIN_LOGMATMUL_A_LAYER
            and out["elemwise_launches"] == 2 * STEP_CHECK_LAYERS,
            f"(b) launches {counts}")
    return out


def train_full_width(dev, int_rate) -> dict:
    """Phase 15 (c): ``launch.train.train`` on smollm-360m whole, batch 4 x
    seq 512, remat on, ``--approx simdive --backward approx``, under a
    schedule of two approximate rungs (w8 cb6, then w8 cb4 from step
    TRAIN_RUNG_AT), a checkpoint every TRAIN_SAVE_EVERY steps: one step
    warm, then one timed and counted (TRAIN_LOGMATMUL_A_STEP ``logmatmul``
    and TRAIN_ELEMWISE_A_STEP ``elemwise``), its peak memory, one step's
    device time by kernel beside its ``logmatmul`` work's operations
    bound; then the uninterrupted TRAIN_STEPS-step run
    (every loss finite, its launches TRAIN_STEPS times a step's), a run
    killed after TRAIN_STOP_AFTER steps and its ``resume='auto'``: the
    resumed losses ``==`` the uninterrupted run's from the checkpoint on.
    Runs under ``torch.use_deterministic_algorithms``."""
    import gc
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.approx import ApproxConfig
    from repro_torch.data import make_source, torch_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import make_train_step, train
    from repro_torch.models import build
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import PrecisionSchedule, ScheduleRung
    from repro_torch.tuning import PolicyEntry, TuningPolicy

    approx = ApproxConfig(mode="simdive", backward="approx")
    cfg = get_config(ARCH).with_approx(approx)
    require(cfg.remat, "smollm-360m's config has remat off")
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    rungs = [TuningPolicy(entries=(PolicyEntry(op="matmul", width=8,
                                               coeff_bits=cb),))
             for cb in (6, 4)]
    schedule = PrecisionSchedule(rungs=(
        ScheduleRung(0, rungs[0], "w8 cb6"),
        ScheduleRung(TRAIN_RUNG_AT, rungs[1], "w8 cb4")))
    lm = build(cfg.with_approx(schedule.config_at(0, approx)), dev)
    params = lm.init(SEED)
    opt = adamw(cosine_schedule(TRAIN_LR, warmup=min(
        100, TRAIN_STEPS // 10 + 1), total=TRAIN_STEPS))
    state = opt.init(params)
    batch = torch_batch(make_source(cfg, shape, seed=SEED).batch(0), dev)
    step = make_train_step(lm, opt)
    t0 = wall_clock()
    first = step(params, state, batch)
    first_loss = float(first[2]["loss"])
    first_s = wall_clock() - t0
    del first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launch_counts()
    t0 = wall_clock()
    out = step(params, state, batch)
    loss = float(out[2]["loss"])
    step_s = wall_clock() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del out
    require(loss == first_loss, f"two steps from the same state: {loss!r} "
                                f"then {first_loss!r}")
    require(_matmuls(counts) == TRAIN_LOGMATMUL_A_STEP
            and counts["elemwise"] == TRAIN_ELEMWISE_A_STEP,
            f"a training step's launches: {counts}")
    prof = device_time_by_kernel(lambda: step(params, state, batch))
    res = {"first_step_s": first_s, "step_ms": step_s * 1e3,
           "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
           "peak_bytes": peak, "state_bytes": base,
           "step_counts": {k: v for k, v in counts.items() if v}}
    log(f"  (c) a training step: {res['step_ms']:.1f} ms "
        f"({res['tok_per_s']:.1f} tok/s; the first, autotune included, "
        f"{first_s:.1f}s), peak {peak / 1e9:.2f} GB over "
        f"{base / 1e9:.2f} GB of parameters and optimizer state; launches "
        f"{res['step_counts']}")
    # the step's logmatmul work at its operations bound: each linear's
    # forward twice (the remat re-run), and gx (M, N) x (N, K) and gw
    # (K, M) x (M, N) of every linear but wq / wk / wv (R-8)
    M = TRAIN_BATCH * TRAIN_SEQ
    for key, bound in (("logmatmul_bound_ms", logmatmul_ops_ms),
                       ("logmatmul_bound_ms_superseded",
                        logmatmul_ops_ms_superseded)):
        res[key] = cfg.n_layers * sum(
            2 * bound(M, k, n, int_rate)
            + (0 if name in ("wq", "wk", "wv") else
               bound(M, n, k, int_rate) + bound(k, M, n, int_rate))
            for name, k, n in LINEARS)
    if prof is not None:
        busy, by = prof
        top = sorted(by.items(), key=lambda kv: -kv[1][1])[:10]
        res["device_ms"] = busy
        res["device_top"] = {n[:80]: [c, ms] for n, (c, ms) in top}
        mm = sum(ms for n, (c, ms) in by.items() if "logmatmul" in n)
        res["device_logmatmul_ms"] = mm
        res["device_fill_ms"] = sum(ms for n, (c, ms) in by.items()
                                    if "FillFunctor" in n)
        log(f"  one step's device time {busy:.1f} ms: logmatmul "
            f"{mm:.1f} ms ({mm / res['logmatmul_bound_ms']:.2f}x its "
            f"operations bound {res['logmatmul_bound_ms']:.1f} ms; the "
            f"superseded one {res['logmatmul_bound_ms_superseded']:.1f} "
            f"ms), fills "
            f"{res['device_fill_ms']:.1f} ms; the top kernels: "
            + "; ".join(f"{n[:50]} x{c} {ms:.1f} ms" for n, (c, ms) in top))
    del params, state, step, lm, batch
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    kw = dict(steps=TRAIN_STEPS, save_every=TRAIN_SAVE_EVERY, seed=SEED,
              lr=TRAIN_LR, log_every=1, keep=2, schedule=schedule,
              device=dev)
    try:
        reset_launch_counts()
        t0 = wall_clock()
        _, full = train(cfg, shape, ckpt_dir=str(Path(root) / "full"), **kw)
        res["run_s"] = wall_clock() - t0
        res["run_counts"] = {k: v for k, v in launch_counts().items() if v}
        t0 = wall_clock()
        _, head = train(cfg, shape, ckpt_dir=str(Path(root) / "killed"),
                        stop_after=TRAIN_STOP_AFTER, **kw)
        _, tail = train(cfg, shape, ckpt_dir=str(Path(root) / "killed"),
                        **kw)
        res["kill_resume_s"] = wall_clock() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res.update(losses=full, losses_killed=head, losses_resumed=tail)
    log(f"  (c) {TRAIN_STEPS} steps in {res['run_s']:.1f}s (checkpoints "
        f"included): losses {full}; killed after {TRAIN_STOP_AFTER}: "
        f"{head}; resumed: {tail} ({res['kill_resume_s']:.1f}s); launches "
        f"{res['run_counts']}")
    require(all(math.isfinite(x) for x in full + head + tail),
            "a non-finite loss")
    require(head == full[:TRAIN_STOP_AFTER],
            "the killed run's losses differ from the uninterrupted run's")
    require(tail == full[TRAIN_SAVE_EVERY:],
            "resumed losses differ from the uninterrupted run's")
    run = res["run_counts"]
    require(run.get("matmul", 0) + run.get("matmul_pipelined", 0)
            == TRAIN_STEPS * TRAIN_LOGMATMUL_A_STEP
            and run.get("elemwise", 0) == TRAIN_STEPS
            * TRAIN_ELEMWISE_A_STEP, f"the run's launches: {run}")
    return res


def twin_phase(dev) -> dict:
    """Phase 15 (d): ``train_twin`` at smollm-360m's full width, TWIN_STEPS
    steps, exact against ``--approx simdive``: every loss finite, the
    approximate twin's launches (TWIN_LOGMATMUL_A_STEP ``logmatmul`` and
    TRAIN_ELEMWISE_A_STEP ``elemwise`` a step); R-8 on the card (the
    approximate model's wq / wk / wv get no gradient, the exact model's
    nonzero ones); on the 2-layer cut, a twin whose approximate side
    dispatches but resolves exact tracks the exact one bit for bit."""
    import gc

    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.approx import EXACT, ApproxConfig
    from repro_torch.core.tree import value_and_grad
    from repro_torch.data import make_source, torch_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build
    from repro_torch.train import train_twin
    from repro_torch.tuning import TuningPolicy

    cfg = get_config(ARCH)
    shape = ShapeConfig("twin", TRAIN_SEQ, TRAIN_BATCH, "train")
    approx = ApproxConfig(mode="simdive")
    reset_launch_counts()
    t0 = wall_clock()
    _, trace = train_twin(cfg, shape, steps=TWIN_STEPS, approx=approx,
                          seed=SEED, lr=TWIN_LR, log_every=1, device=dev)
    res = {"twin_s": wall_clock() - t0,
           "counts": {k: v for k, v in launch_counts().items() if v},
           "records": trace.records, "summary": trace.summary()}
    gc.collect()
    torch.cuda.empty_cache()
    require(all(math.isfinite(r[k]) for r in trace.records
                for k in ("loss_exact", "loss_approx", "grad_cosine",
                          "param_drift")), "a non-finite twin record")
    require(_matmuls(res["counts"]) == TWIN_STEPS * TWIN_LOGMATMUL_A_STEP
            and res["counts"].get("elemwise", 0)
            == TWIN_STEPS * TRAIN_ELEMWISE_A_STEP,
            f"the twin's launches: {res['counts']}")
    log(f"  (d) twin, {TWIN_STEPS} steps in {res['twin_s']:.1f}s: "
        + "; ".join(f"step {r['step']} loss {r['loss_exact']:.4f} / "
                    f"{r['loss_approx']:.4f} (delta {r['loss_delta']:.4g}),"
                    f" grad cosine {r['grad_cosine']:.4f}, drift "
                    f"{r['param_drift']:.3g}" for r in trace.records))
    lm_e = build(cfg.with_approx(EXACT), dev)
    lm_a = build(cfg.with_approx(approx), dev)
    params = lm_e.init(SEED)
    batch = torch_batch(make_source(cfg, shape, seed=SEED).batch(0), dev)
    _, g = value_and_grad(lm_a.train_loss)(params, batch)
    layers = g["stack"]["layers"]
    r8_approx = {n: layers[n] is None for n in ("wq", "wk", "wv")}
    wo_ok = layers["wo"] is not None and bool(torch.any(layers["wo"] != 0))
    del g, layers
    _, g = value_and_grad(lm_e.train_loss)(params, batch)
    r8_exact = {n: int(torch.count_nonzero(g["stack"]["layers"][n]))
                for n in ("wq", "wk", "wv")}
    del g, params
    res["r8"] = {"approx_no_grad": r8_approx, "exact_nonzero": r8_exact}
    log(f"  R-8 on the card: the approximate model's wq / wk / wv without "
        f"gradient {r8_approx}, wo's nonzero {wo_ok}; the exact model's "
        f"nonzero entries {r8_exact}")
    require(all(r8_approx.values()) and wo_ok
            and all(v > 0 for v in r8_exact.values()), f"R-8: {res['r8']}")
    gc.collect()
    torch.cuda.empty_cache()
    exact_base = ApproxConfig(mode="simdive", policy=TuningPolicy(),
                              policy_only=True)
    _, flat = train_twin(replace(cfg, n_layers=STEP_CHECK_LAYERS), shape,
                         steps=2, approx=exact_base, seed=SEED, lr=TWIN_LR,
                         device=dev)
    res["exact_base"] = {"max_abs_loss_delta": flat.max_abs_loss_delta(),
                         "max_param_drift": flat.max_param_drift()}
    log(f"  exact-base twin ({STEP_CHECK_LAYERS} layers): "
        f"{res['exact_base']}")
    require(flat.max_abs_loss_delta() == 0.0
            and flat.max_param_drift() == 0.0,
            f"an exact-base twin diverged: {res['exact_base']}")
    return res


def training_phase(dev, int_rate) -> dict:
    """Phase 15: the training path (:mod:`repro_torch.launch.train`), (a)
    to (d) as their functions say, (b) to (d) under
    ``torch.use_deterministic_algorithms`` (``launch.train.deterministic``,
    as ``python -m repro_torch.launch.train`` runs on the card), turned off
    again at the end."""
    import gc

    import torch
    from repro_torch.launch.train import deterministic

    _drop_served_graphs()
    out = {"kernels": train_kernel_checks(dev, int_rate)}
    deterministic()
    try:
        out["step_check"] = train_step_check(dev)
        gc.collect()
        torch.cuda.empty_cache()
        out["trainer"] = train_full_width(dev, int_rate)
        gc.collect()
        torch.cuda.empty_cache()
        out["twin"] = twin_phase(dev)
    finally:
        torch.use_deterministic_algorithms(False)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------- phase 16: the applications --
def _table4_operands(dev, gen, M, K, N, width):
    """Magnitudes in the lane, signs, zeros: ``quantize_sign_magnitude``'s
    outputs at (M, K) @ (K, N), and the re-signed int32 operands."""
    import torch

    hi = 1 << width
    qx = torch.randint(0, hi, (M, K), generator=gen, device=dev,
                       dtype=torch.int32)
    qw = torch.randint(0, hi, (K, N), generator=gen, device=dev,
                       dtype=torch.int32)
    qx[:, :3], qw[:2] = 0, 0
    qx[0, 3:9], qw[2, :5] = hi - 1, hi - 1      # saturating products
    sx = torch.randint(0, 2, (M, K), generator=gen, device=dev,
                       dtype=torch.int32) * 2 - 1
    sw = torch.randint(0, 2, (K, N), generator=gen, device=dev,
                       dtype=torch.int32) * 2 - 1
    return qx, sx, qw, sw


def app_matmul_checks(dev, int_rate) -> dict:
    """Phase 16 (a), the matmuls: at Table 4's three layer shapes, every
    rung of ``default_candidates("matmul")`` and the Mitchell rung,
    ``logmatmul`` bit-equal to its plain version for every registered
    block, in its int32 form (``matmul_int``'s
    wrap-around contract) and its wide form (``logmatmul_wide_ref``), and
    ``matmul_emul``'s kernel path (the wide form where int32 could wrap:
    every width-16 call) bit-equal to its int64 plain version; then the
    wide form timed against the int32 one at Table 4's first layer and at
    smollm-360m's wq at the prefill (graph replays, the autotune's default
    block and the ring's): the repair's cost."""
    import torch
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import get_op
    from repro_torch.kernels import logmatmul as lmm
    from repro_torch.tuning import default_candidates

    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    specs = [(f"w{c.width} cb{c.coeff_bits}", c.spec())
             for c in default_candidates("matmul")]
    specs.append(("mitchell w8", SimdiveSpec(width=8, coeff_bits=0,
                                             round_output=False)))
    blocks = get_op("matmul_int", SimdiveSpec()).entry.block_candidates
    runs = 0
    plain_ms = {}
    for M, K, N in TABLE4_SHAPES:
        for name, spec in specs:
            qx, sx, qw, sw = _table4_operands(dev, gen, M, K, N, spec.width)
            x, w = qx * sx, qw * sw
            t0 = wall_clock()
            want = lmm.logmatmul_ref(x, w, spec)
            torch.cuda.synchronize()
            plain_ms[f"{M},{K},{N} {name}"] = (wall_clock() - t0) * 1e3
            want_wide = lmm.logmatmul_wide_ref(x, w, spec)
            for b in blocks:
                got = lmm.logmatmul_cuda(x, w, spec, b)
                require(torch_equal(got, want),
                        f"logmatmul ({M},{K})@({K},{N}) {name} block {b}: "
                        "not bit-equal to logmatmul_ref")
                got = lmm.logmatmul_cuda(x, w, spec, b, wide=True)
                require(torch_equal(got, want_wide),
                        f"logmatmul ({M},{K})@({K},{N}) {name} block {b}, "
                        "wide form: not bit-equal to logmatmul_wide_ref")
                runs += 2
            emul = get_op("matmul_emul", spec, "ref")(qx, sx, qw, sw)
            require(torch_equal(emul, want_wide),
                    f"({M},{K})@({K},{N}) {name}: logmatmul_wide_ref is not "
                    "matmul_emul's plain version")
            for b in get_op("matmul_emul", spec).entry.block_candidates:
                got = get_op("matmul_emul", spec, "cuda", block=b)(
                    qx, sx, qw, sw)
                require(torch_equal(got, emul),
                        f"matmul_emul ({M},{K})@({K},{N}) {name} block {b}: "
                        "the kernel path differs from the int64 plain "
                        "version")
                runs += 1
            if spec.width == 16 and K == 784:
                narrow = want.to(torch.int64)
                wrong = float((narrow != want_wide).float().mean())
                log(f"  ({M},{K})@({K},{N}) {name}: the int32 form differs "
                    f"from the int64 sum on {wrong:.1%} of the outputs "
                    f"(largest |sum| {float(want_wide.abs().max()):.4g})")
    log(f"  logmatmul / matmul_emul at Table 4's shapes, {len(specs)} rungs:"
        f" {runs} kernel runs bit-equal to their plain versions (int32 and "
        "wide forms, both schedules, skinny and large tiles)")
    timed = {}
    for M, K, N in (TABLE4_SHAPES[0], WIDE_SERVED_SHAPE):
        for width in (8, 16):
            spec = SimdiveSpec(width=width, coeff_bits=6)
            qx, sx, qw, sw = _table4_operands(dev, gen, M, K, N, width)
            x, w = qx * sx, qw * sw
            row = {}
            for sched, block in (("", lmm.DEFAULT_BLOCK),
                                 ("ring_", MATMUL_RING_BLOCK),
                                 ("large_", LARGE_BLOCK),
                                 ("large_ring_", LARGE_RING_BLOCK)):
                for form, wide in (("int32", False), ("wide", True)):
                    row[f"{sched}{form}_ms"] = gpu_graph_time_ms(
                        lambda block=block, wide=wide: lmm.logmatmul_cuda(
                            x, w, spec, block, wide=wide), iters=5)
            # the wide form's bound: int32 operands in, int64 sums out
            ops_ms = logmatmul_ops_ms(M, K, N, int_rate)
            bytes_ms = ((M * K + K * N) * 4 + M * N * 8) \
                / HBM_BYTES_PER_S * 1e3
            row.update(bound_ms=max(ops_ms, bytes_ms),
                       bound_by="operations" if ops_ms >= bytes_ms
                       else "bytes",
                       wide_over_int32=row["wide_ms"] / row["int32_ms"])
            timed[f"{M},{K},{N} w{width}"] = row
            log(f"  logmatmul ({M},{K})@({K},{N}) w{width}, block "
                f"{lmm.DEFAULT_BLOCK}: int32 form {row['int32_ms']:.4f} ms, "
                f"wide form {row['wide_ms']:.4f} ms "
                f"({row['wide_over_int32']:.3f}x); ring {MATMUL_RING_BLOCK}"
                f": {row['ring_int32_ms']:.4f} / {row['ring_wide_ms']:.4f} "
                f"ms; large {LARGE_BLOCK}: {row['large_int32_ms']:.4f} / "
                f"{row['large_wide_ms']:.4f} ms, its ring "
                f"{row['large_ring_int32_ms']:.4f} / "
                f"{row['large_ring_wide_ms']:.4f} ms; bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return {"bit_equal_runs": runs, "plain_ms": plain_ms, "wide_vs_int32":
            timed, "max_abs_err": 0}


def _imaging_lanes(dev) -> dict:
    """The lanes Fig. 3/4's pipeline hands ``elemwise`` (seed 3's images):
    the blend's 65,536 pixel pairs, the Gaussian's 63,504 (pixel, weight)
    pairs of its centre tap (weight 41) and its divider's window sums over
    273, with the window sums' edges spliced in (0, 1, 255, 65,535, and
    past a 16-bit lane 65,536 and 255 x 273 = 69,615, the largest a window
    can sum)."""
    import numpy as np
    import torch
    from repro_torch.apps import fig34_imaging as f34
    from repro_torch.core.mitchell import to_lanes

    img1, img2 = f34.synth_image(3), f34.synth_image(4)
    blended = (img1.astype(np.int64) * img2) // 255
    H = IMAGING_HW
    acc = np.zeros((H - 4, H - 4), np.int64)
    for dy in range(5):
        for dx in range(5):
            acc += (blended[dy:dy + H - 4, dx:dx + H - 4]
                    * int(f34.GAUSS[dy, dx]))

    def lanes(a):                  # uint32 lanes, as the kernel takes them
        return to_lanes(torch.from_numpy(
            np.ascontiguousarray(a, np.int64).ravel())).to(dev)

    centre = blended[2:H - 2, 2:H - 2]
    acc = acc.ravel()
    acc[:6] = (0, 1, 255, 65535, 65536, 255 * 273)
    return {"blend mul": (lanes(img1), lanes(img2), {"op": "mul"}),
            "gauss mul": (lanes(centre), lanes(np.full(centre.shape, 41)),
                          {"op": "mul"}),
            "gauss div": (lanes(acc), lanes(np.full(acc.shape, 273)),
                          {"op": "div", "frac_out": f34.FO})}


def app_elemwise_checks(dev, int_rate) -> dict:
    """Phase 16 (a), the imaging kernel: ``elemwise`` at Fig. 3/4's lanes
    (:func:`_imaging_lanes`) at every rung of the mul ladder bit-equal to
    its plain version, each timed (graph replay) beside its bound and the
    plain version."""
    import torch
    from repro_torch.kernels import get_op
    from repro_torch.tuning import default_candidates

    cases = _imaging_lanes(dev)
    rows = {}
    for cand in default_candidates("mul"):
        spec = cand.spec()
        for case, (a, b, kw) in cases.items():
            op_k = get_op("elemwise", spec, "cuda")
            op_p = get_op("elemwise", spec, "ref")
            kern = lambda: op_k(a, b, **kw)
            plain = lambda: op_p(a, b, **kw)
            require(torch_equal(kern(), plain()),
                    f"elemwise {case} w{spec.width} cb{spec.coeff_bits}: "
                    "not bit-equal to its plain version")
            if (spec.width, spec.coeff_bits) != (16, 6):
                continue
            lanes = a.numel()
            ops = (ELEMWISE_OPS_PER_LANE if kw["op"] == "div"
                   else ELEMWISE_MUL_OPS_PER_LANE)
            ops_ms = ops * lanes / int_rate * 1e3
            bytes_ms = 12 * lanes / HBM_BYTES_PER_S * 1e3
            rows[case] = {
                "lanes": lanes, "spec": "w16 cb6",
                "ms": gpu_graph_time_ms(kern, iters=50),
                "eager_ms": gpu_time_ms(kern, iters=50),
                "plain_ms": gpu_time_ms(plain, iters=5),
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "max_abs_err": 0, "library_ms": None}
    for case, row in rows.items():
        log(f"  elemwise {case} ({row['lanes']} lanes, w16 cb6): "
            f"{row['ms']:.5f} ms (graph), eager {row['eager_ms']:.5f}, "
            f"bound {row['bound_ms']:.6f} ms ({row['bound_by']}), plain "
            f"{row['plain_ms']:.3f} ms")
    log("  elemwise at Fig. 3/4's lanes: bit-equal at every rung of the mul "
        "ladder (window sums past a 16-bit lane included)")
    return rows


def table4_rows(dev, data) -> dict:
    """Phase 16 (b): Table 4's rows. Each MLP trained on the card
    (``apps.table4_ann.train_float``, float32, TF32 off), then run in 8-bit
    fixed point with the accurate baseline (``exact_matmul``), SIMDive
    w8 cb6 and Mitchell w8 on ``matmul_int`` — on the kernel, and on the
    plain version with the same weights: logits ``torch.equal``, so the
    accuracies equal. The float accuracy over TABLE4_FLOAT_FLOOR. Returns
    the rows and the 784-100-100-10 weights (for (d))."""
    import torch
    from repro_torch.apps import table4_ann as t4
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import get_op
    from repro_torch.metrics import classification_accuracy

    require(torch.get_float32_matmul_precision() == "highest"
            and not torch.backends.cuda.matmul.allow_tf32,
            "float32 matmuls are not at full precision (TF32 is on)")
    (xtr, ytr), (xte, yte) = data
    specs = {"simdive": SimdiveSpec(width=8, coeff_bits=6),
             "mitchell": SimdiveSpec(width=8, coeff_bits=0,
                                     round_output=False)}
    rows, weights = {}, None
    for hidden in TABLE4_HIDDEN:
        torch.cuda.synchronize()
        t0 = wall_clock()
        ws, fwd = t4.train_float(xtr, ytr, hidden=hidden, steps=TABLE4_STEPS,
                                 seed=0, device=dev)
        torch.cuda.synchronize()
        train_s = wall_clock() - t0
        xt = torch.from_numpy(xte).to(dev)
        row = {"float": classification_accuracy(fwd(ws, xt).cpu().numpy(),
                                                yte),
               "train_s": train_s}
        row["accurate8"] = classification_accuracy(
            t4.quantized_infer(ws, xte, t4.exact_matmul).cpu().numpy(), yte)
        for name, spec in specs.items():
            got = t4.quantized_infer(ws, xte,
                                     get_op("matmul_int", spec, "auto"))
            want = t4.quantized_infer(ws, xte,
                                      get_op("matmul_int", spec, "ref"))
            require(torch_equal(got, want),
                    f"Table 4 {hidden} {name}: logits on the kernel differ "
                    "from the plain version's")
            row[name] = classification_accuracy(got.cpu().numpy(), yte)
        row["delta_simdive_pct_points"] = abs(row["simdive"]
                                              - row["accurate8"])
        tag = "-".join(str(h) for h in (784, *hidden, 10))
        require(row["float"] > TABLE4_FLOAT_FLOOR,
                f"Table 4 {tag}: float accuracy {row['float']:.1f} % (the "
                "MLP did not learn)")
        rows[tag] = row
        log(f"  Table 4 {tag} ({TABLE4_STEPS} steps in {train_s:.2f}s): "
            f"float {row['float']:.1f} %, accurate-8 {row['accurate8']:.1f}"
            f" %, SIMDive-8 {row['simdive']:.1f} %, Mitchell-8 "
            f"{row['mitchell']:.1f} %; SIMDive - accurate "
            f"{row['simdive'] - row['accurate8']:+.1f} points; logits on "
            "the kernel == on the plain version")
        weights = ws
    return rows, weights


def ann_phase(dev, data) -> dict:
    """Phase 16 (c): the campaign's ``--ann``. ``ann_accuracy_drop`` on the
    kernel and on the plain version with the same trained weights (its own
    200-step classifier, trained once): clean and faulted accuracies equal,
    the drop positive, nothing left armed; then the CLI ``python -m
    repro_torch.faults.campaign --ann --widths 8 --out ...`` in its own
    process (it trains its own classifier): exit 0 and an ``ann`` entry."""
    import os
    import tempfile

    from repro_torch.apps import table4_ann as t4
    from repro_torch.faults.campaign import ann_accuracy_drop
    from repro_torch.faults.inject import FaultSpec, active_faults

    (xtr, ytr), _ = data
    spec = FaultSpec(**ANN_FAULT)
    ws, _ = t4.train_float(xtr, ytr, hidden=(100,), steps=ANN_QUICK_STEPS,
                           seed=0, device=dev)
    kern = ann_accuracy_drop(spec, device=dev, ws=ws)
    plain = ann_accuracy_drop(spec, device=dev, backend="ref", ws=ws)
    require(kern == plain, f"--ann on the kernel {kern} differs from the "
                           f"plain version {plain}")
    require(kern["acc_drop_pct_points"] > 0,
            f"--ann: the fault moved nothing ({kern})")
    require(active_faults() == (), f"--ann left {active_faults()} armed")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "campaign.json"
        t0 = wall_clock()
        done = subprocess.run(
            [sys.executable, "-m", "repro_torch.faults.campaign", "--ann",
             "--widths", "8", "--out", str(out)], cwd=str(ROOT),
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            capture_output=True, text=True, timeout=600)
        cli_s = wall_clock() - t0
        require(done.returncode == 0,
                f"campaign --ann exited {done.returncode}: "
                f"{done.stderr[-2000:]}")
        cli = json.loads(out.read_text())["ann"]
    log(f"  --ann: {ANN_FAULT}, clean {kern['acc_clean_pct']:.1f} %, "
        f"faulted {kern['acc_fault_pct']:.1f} %, drop "
        f"{kern['acc_drop_pct_points']:.1f} points, == on the plain "
        f"version; the CLI in {cli_s:.1f}s: {cli}")
    return {"kernel": kern, "cli": cli, "cli_s": cli_s}


def tuner_phase(dev, data, ws) -> dict:
    """Phase 16 (d): the tuner's application glue on the card.
    ``profile_ann`` on the 784-100-100-10 MLP over the 1,000 test images
    at every rung of ``default_candidates("matmul")`` (its (16, 6) rung on
    the wide form), ``greedy_assign`` at ANN_BUDGET points,
    ``assignment_policy`` and ``ann_policy_metric``; ``profile_imaging``
    for psnr and ssim. Each run again with the candidates' backend
    ``'ref'`` (the plain versions on the same card): every value equal."""
    from repro_torch.tuning import (BudgetError, ann_policy_metric,
                                    assignment_policy, default_candidates,
                                    greedy_assign, profile_ann,
                                    profile_imaging)

    _, (xte, yte) = data

    def plain(cands):
        return tuple(replace(c, backend="ref") for c in cands)

    def values(prof):
        return [(layer, [m for _, m in row]) for layer, row in prof.table]

    out = {}
    t0 = wall_clock()
    prof = profile_ann(ws, xte, yte, device=dev)
    prof_s = wall_clock() - t0
    ref = profile_ann(ws, xte, yte, candidates=plain(prof.candidates),
                      device=dev)
    require(prof.baseline == ref.baseline and values(prof) == values(ref),
            f"profile_ann on the kernels {values(prof)} differs from the "
            f"plain versions {values(ref)}")
    try:
        assignment = greedy_assign(prof, ANN_BUDGET)
        feasible = True
    except BudgetError:
        assignment = {layer: prof.candidates[-1] for layer in prof.layers}
        feasible = False
    policy = assignment_policy(assignment, op="matmul")
    acc = ann_policy_metric(ws, xte, yte, policy, device=dev)
    acc_plain = ann_policy_metric(
        ws, xte, yte, assignment_policy(
            {k: replace(c, backend="ref") for k, c in assignment.items()},
            op="matmul"), device=dev)
    require(acc == acc_plain, f"ann_policy_metric on the kernels {acc} "
                              f"differs from the plain versions {acc_plain}")
    out["ann"] = {"baseline": prof.baseline, "table": values(prof),
                  "candidates": [(c.width, c.coeff_bits)
                                 for c in prof.candidates],
                  "budget": ANN_BUDGET, "feasible": feasible,
                  "assignment": {k: (c.width, c.coeff_bits)
                                 for k, c in assignment.items()},
                  "policy_accuracy": acc, "profile_s": prof_s}
    log(f"  profile_ann (784-100-100-10, 1,000 images; {prof_s:.1f}s on the "
        f"kernels): {prof.render()}")
    how = ("feasible" if feasible
           else "infeasible: every layer at the best rung")
    log(f"  greedy_assign at {ANN_BUDGET} point(s) ({how}): "
        f"{out['ann']['assignment']}; ann_policy_metric {acc:.1f} % == on "
        "the plain versions")
    for metric in ("psnr", "ssim"):
        t0 = wall_clock()
        prof = profile_imaging(metric=metric, device=dev)
        prof_s = wall_clock() - t0
        ref = profile_imaging(metric=metric, device=dev,
                              candidates=plain(prof.candidates))
        require(prof.baseline == ref.baseline
                and values(prof) == values(ref),
                f"profile_imaging {metric} on the kernels differs from the "
                "plain versions")
        out[f"imaging {metric}"] = {"baseline": prof.baseline,
                                    "table": values(prof),
                                    "profile_s": prof_s}
        log(f"  profile_imaging {metric} ({prof_s:.1f}s on the kernels): "
            f"{prof.render()}")
    return out


def applications_phase(dev, int_rate) -> dict:
    """Phase 16: (a) the kernels at the application studies' shapes
    (:func:`app_matmul_checks`, :func:`app_elemwise_checks`), then, with
    every launch count zeroed just before and read just after, (b)
    :func:`table4_rows`, (c) :func:`ann_phase` and (d)
    :func:`tuner_phase`: their launches per kernel, of which the wide
    form's, must include both matmul forms and the elemwise kernel."""
    import torch
    from repro_torch.apps import table4_ann as t4
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import logmatmul as lmm

    _drop_served_graphs()
    out = {"kernels": {"matmul": app_matmul_checks(dev, int_rate),
                       "elemwise": app_elemwise_checks(dev, int_rate)}}
    data = t4.make_dataset(seed=0)
    reset_launch_counts()
    lmm.logmatmul_cuda.wide_launches = 0
    out["table4"], ws = table4_rows(dev, data)
    out["ann"] = ann_phase(dev, data)
    out["tuner"] = tuner_phase(dev, data, ws)
    torch.cuda.synchronize()
    counts = launch_counts()
    out["counts"] = counts
    out["wide_launches"] = lmm.logmatmul_cuda.wide_launches
    require(_matmul_launches(counts) > 0 and counts["elemwise"] > 0
            and out["wide_launches"] > 0,
            f"applications: launches {counts}, wide "
            f"{out['wide_launches']}: a kernel of the path never ran")
    log(f"  applications: launches {counts}, of which the wide logmatmul "
        f"form {out['wide_launches']}")
    return out


# ------------------------------------------------ phase 17: width 32 --
#: the width-32 divider of the served policy file (the reference's shipped
#: width-32 configuration: cb 8, 64 regions) and its attention frac_out
W32_SPEC = dict(width=32, coeff_bits=8, index_bits=3)
W32_ATTENTION_FRAC_OUT = 15
W32_DIV_FRAC_OUT = 16
#: stratified width-32 lanes phase 17 (a) holds the lane kernels to: every
#: (k1, k2) leading-one pair 16,384 times (16.8 M pairs), plus the edges
W32_PER_STRATUM = 1 << 14
W32_EDGES = (0, 1, 2, 3, (1 << 31) - 1, 1 << 31, (1 << 31) + 1,
             (1 << 32) - 2, (1 << 32) - 1, 255, 256, 257, 65535, 65536,
             65537, (1 << 24) - 1, 1 << 24, (1 << 24) + 1)
#: the armings of phase 17 (a): log-site bits 0, 20 and 31 (31 is the low
#: bit of k at width 32) and one flipped entry of the width-32 div table
W32_FAULTS = (dict(site="log", bit=0, kind="flip", width=32),
              dict(site="log", bit=20, kind="flip", width=32),
              dict(site="log", bit=31, kind="flip", width=32),
              dict(site="table", bit=20, kind="flip", op="div", width=32,
                   index=27))
#: a log flip at bit 31 is a flip of the leading-one position's low bit at
#: width 32 (F = 31): every operand's log moves by +-1 in k, so the
#: divider jumps by a factor of 2 to 4 wherever an operand crosses a power
#: of two. bf16 attention's acc differs from the dense plain version's by
#: p's bf16 rounding (relative to the running max, not the row's), ~2^-8,
#: so the outputs whose operands lie that close to a power of two land on
#: the other side: ~0.1 % of them (1.0e-3 at smollm-360m's prefill on an
#: H100). Under that arming the attention kernels are
#: held to at most this share outside judge_attention's tight bound, every
#: output outside it explained by such a step (kflip_unexplained), the
#: ring bit-equal to depth 0 and the finalize alone bit for bit
W32_KFLIP_OUTLIER_SHARE = 3e-3
#: an outside output is explained when it is the plain version's times
#: 4^n, 0 < |n| <= 3, to the tight bound scaled by the step plus this share
#: of the stepped value (the correction table's error differs on the two
#: sides of a power of two, ~1 %). A lane whose word lies on the other
#: side of a power of two moves by 2x one way in one run and the other way
#: in the other: its quotient by 4x. A row's l on the other side moves the
#: row's shared exponent, so every lane of the row by one in k: the
#: quotients whose two lanes' k differ in parity by 16x; with a lane of
#: its own across too, 64x
W32_KFLIP_STEP_RTOL = 0.1
#: the attention shapes of phase 17 (a): smollm-360m's prefill (the main
#: path's) and qwen3-4b's (d_head 128, the largest instantiation)
W32_ATTENTION = (("smollm-360m", 15, 5, 64), ("qwen3-4b", 32, 8, 128))
#: integer operations of one width-32 lane op: every 64-bit add, shift or
#: compare of the 32-bit one issues as two 32-bit instructions
W32_ELEMWISE_OPS_PER_LANE = 2 * ELEMWISE_OPS_PER_LANE
W32_SQRT_OPS_PER_LANE = 2 * SQRT_OPS_PER_LANE


def kflip_unexplained(got, want, *, atol, rtol) -> tuple[int, float]:
    """(outputs outside ``atol + rtol |want|`` that no quotient step of
    4^n explains (W32_KFLIP_STEP_RTOL), the largest |got / want| among
    the outside ones)."""
    import torch

    g, w = got.to(torch.float32), want.to(torch.float32)
    bad = (g - w).abs() > atol + rtol * w.abs()
    explained = torch.zeros_like(bad)
    for n in (-3, -2, -1, 1, 2, 3):
        step = 4.0 ** n
        explained |= ((g - step * w).abs()
                      <= max(1.0, step) * atol
                      + (rtol + W32_KFLIP_STEP_RTOL) * step * w.abs())
    ratio = (g[bad] / w[bad]).abs()
    ratio = ratio[torch.isfinite(ratio)]
    return (int((bad & ~explained).sum()),
            float(ratio.max()) if ratio.numel() else 0.0)


def w32_spec():
    from repro_torch.core.simdive import SimdiveSpec

    return SimdiveSpec(**W32_SPEC)


def w32_ptxas(text: str) -> list:
    """Registers and spill bytes of every width-32 instantiation in the
    ``nvcc -Xptxas -v`` log: each entry compiled from a ``*_w32.cu``
    source, and the uint64 (``m``) lane forms of ``elemwise.cu``."""
    import re

    found, src, cur = [], None, None
    for line in text.splitlines():
        if line.startswith("$ "):
            m = re.search(r"csrc/(\w+)\.cu ", line)
            src = m.group(1) if m else None
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            # elemwise.cu's uint64 forms: elemwise_kernel<OP, unsigned
            # long> and sqrt_kernel<unsigned long> (m in the mangled name)
            w32 = (src or "").endswith("_w32") or (
                src == "elemwise" and re.search(
                    r"elemwise_kernelILi\dEmE|sqrt_kernelImE", name))
            cur = {"source": f"{src}.cu", "entry": name} if w32 else None
            continue
        if cur is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            cur["spill_bytes"] = int(spill.group(1)) + int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            cur["registers"] = int(used.group(1))
            found.append(cur)
            cur = None
    return found


def w32_lanes(dev):
    """Phase 17 (a)'s operands: 16.8 M stratified width-32 pairs and every
    pair of W32_EDGES, on the card as the int64 carrier, and a mode word a
    lane."""
    import numpy as np
    import torch
    from repro_torch.metrics import stratified_pairs

    a, b = stratified_pairs(32, SEED + 170, per_stratum=W32_PER_STRATUM)
    e = np.array(W32_EDGES, np.uint64)
    ea, eb = (x.ravel() for x in np.meshgrid(e, e, indexing="ij"))
    a = np.concatenate([a.astype(np.uint64), ea])
    b = np.concatenate([b.astype(np.uint64), eb])
    lanes = [torch.from_numpy(x.view(np.int64)).to(dev) for x in (a, b)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 171)
    mode = torch.randint(0, 2, lanes[0].shape, generator=gen, device=dev,
                         dtype=torch.int32)
    return lanes[0], lanes[1], mode


def w32_lane_kernels(dev) -> dict:
    """Phase 17 (a), the lane kernels: ``elemwise`` mul / div / mixed at
    frac_out 0 / 8 / 16, ``sqrt`` at 0 / 8 and the attention finalize
    alone (``softmax_div_kernel``, at smollm-360m's prefill rows) at
    width 32, ``torch.equal`` to their plain versions disarmed and under
    each of W32_FAULTS; every arming must move the kernel's output exactly
    where it moves the plain version's."""
    import torch
    from repro_torch.core.error_lut import table_for
    from repro_torch.core.mitchell import from_lanes
    from repro_torch.faults.inject import FaultSpec, fault_injection
    from repro_torch.kernels import elemwise as ew
    from repro_torch.kernels import flash_attention as fa

    a, b, mode = w32_lanes(dev)
    spec = w32_spec()
    gen = torch.Generator(device=dev).manual_seed(SEED + 172)
    rows, dh = BATCH * 15 * PROMPT, 64
    acc = torch.randn(rows, dh, generator=gen, device=dev) * 4.0
    l = torch.rand(rows, generator=gen, device=dev) * 300.0 + 1e-3
    l[:64] = 1.0                       # a causal first row: l = 1 exactly
    acc[64] = 0.0
    acc[65] *= 1e-20
    acc[66] *= 1e20
    l[67] = 0.0                        # clamps to 1e-30
    acc[68, 0], l[68] = 2.0, 2.0
    cases = [(f"elemwise {op} fo{fo}",
              lambda op=op, fo=fo: ew.elemwise_cuda(
                  a, b, spec, op=op, frac_out=fo,
                  mode=mode if op == "mixed" else None),
              lambda op=op, fo=fo: ew.elemwise_ref(
                  a, b, spec, op=op, frac_out=fo,
                  mode=mode if op == "mixed" else None))
             for op, fo in (("mul", 0), ("div", 0), ("div", 8), ("div", 16),
                            ("mixed", 0), ("mixed", 8), ("mixed", 16))]
    cases += [(f"sqrt fo{fo}",
               lambda fo=fo: ew.sqrt_cuda(a, spec, frac_out=fo),
               lambda fo=fo: ew.sqrt_ref(a, spec, frac_out=fo))
              for fo in (0, 8)]
    tab = table_for("div", 32, spec.coeff_bits, spec.index_bits, device=dev)
    fkw = dict(width=32, index_bits=spec.index_bits,
               frac_out=W32_ATTENTION_FRAC_OUT, round_out=spec.round_output)

    def finalize():
        out, quot = fa.softmax_div_cuda(acc, l, spec=spec,
                                        frac_out=W32_ATTENTION_FRAC_OUT)
        return torch.cat([out.view(torch.int32).to(torch.int64).flatten(),
                          quot.view(torch.int64).flatten()])

    def finalize_ref():
        out = fa.softmax_div(acc, l, tab, **fkw)
        quot = fa.softmax_div_lanes(acc, l, tab, **fkw)
        return torch.cat([out.view(torch.int32).to(torch.int64).flatten(),
                          quot.flatten()])

    cases.append(("finalize (softmax_div_kernel) fo15", finalize,
                  finalize_ref))
    clean, runs = {}, 0
    for armed in (None, *W32_FAULTS):
        specs = () if armed is None else (FaultSpec(**armed),)
        tag = "disarmed" if armed is None else \
            f"{armed['site']} bit {armed['bit']}"
        with fault_injection(*specs):
            for name, kern, ref in cases:
                got, want = kern(), ref()
                torch.cuda.synchronize()
                got, want = from_lanes(got), from_lanes(want)
                nbad = int((got != want).sum())
                require(nbad == 0, f"width 32 {name} {tag}: {nbad} of "
                                   f"{got.numel()} lanes differ from the "
                                   "plain version")
                if armed is None:
                    clean[name] = (got, want)
                else:
                    moved_k = got != clean[name][0]
                    moved_p = want != clean[name][1]
                    require(torch.equal(moved_k, moved_p),
                            f"width 32 {name} {tag}: the kernel's output "
                            "moved elsewhere than the plain version's")
                runs += 1
        log(f"  (a) width 32, {tag}: elemwise mul / div / mixed, sqrt and "
            f"the finalize alone bit-equal to their plain versions on "
            f"{a.numel()} lanes / {rows} rows")
    return {"lane_runs": runs, "lanes": a.numel(),
            "finalize_rows": rows}


def w32_attention_kernels(dev) -> dict:
    """Phase 17 (a), the attention kernels at a width-32 divider:
    ``flash_attention`` at smollm-360m's and qwen3-4b's prefill shapes
    (bf16, causal, GQA) within ``judge_attention``'s tolerances of the
    plain version, every ring depth that fits ``torch.equal`` to depth 0;
    ``decode_attention`` at their step shapes (a 544-slot cache, pos 527)
    at the planner's cluster and pinned at every size 1..8, each within
    the tolerances, two calls bit-identical. Under each of W32_FAULTS the
    depth-0 kernel, the 2-slot ring and the planner's decode launch at the
    main path's shapes are held the same way, but for the log flip at bit
    31: see W32_KFLIP_OUTLIER_SHARE."""
    import torch
    from repro_torch.faults.inject import FaultSpec, fault_injection
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 173)
    spec, bf16 = w32_spec(), torch.bfloat16
    fo = W32_ATTENTION_FRAC_OUT
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"archs": {}, "main": 0.0, "all": 0.0, "decode_main": 0.0,
           "decode_all": 0.0, "ring_runs": 0, "decode_runs": 0}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    for arch, H, KV, dh in W32_ATTENTION:
        main = arch == ARCH
        G = H // KV
        q, k, v = randn(BATCH * H, PROMPT, dh), randn(BATCH * KV, PROMPT,
                                                      dh), \
            randn(BATCH * KV, PROMPT, dh)
        kw = dict(spec=spec, causal=True, approx_div=True, frac_out=fo,
                  kv_group=G)
        want = fa.flash_attention_ref(q, k, v, **kw)
        got = fa.flash_attention_cuda(q, k, v, block=fa.DEFAULT_BLOCK, **kw)
        torch.cuda.synchronize()
        err, share = judge_attention(f"w32 {arch} prefill", got, want, bf16,
                                     True)
        depths = []
        for depth in range(1, fa._MAX_DEPTH + 1):
            block = (*fa.DEFAULT_BLOCK, depth)
            try:
                fa.check_block(block, bf16, dh)
            except ValueError:
                continue
            ring = fa.flash_attention_pipelined_cuda(q, k, v, block=block,
                                                     **kw)
            torch.cuda.synchronize()
            require(torch.equal(ring, got),
                    f"w32 attention {arch}: ring depth {depth} differs from "
                    f"depth 0 on {int((ring != got).sum())} outputs")
            depths.append(depth)
            out["ring_runs"] += 1
        # the decode step: a 544-slot cache, pos 527, every cluster size
        Smax, pos = PROMPT + GEN, PROMPT + 15
        dq, kc, vc = randn(BATCH, KV, G, dh), randn(BATCH, Smax, KV, dh), \
            randn(BATCH, Smax, KV, dh)
        kn, vn = randn(BATCH, 1, KV, dh), randn(BATCH, 1, KV, dh)
        dkw = dict(pos=pos, slot=pos, spec=spec, approx_div=True,
                   frac_out=fo)
        dwant = da.decode_attention_ref(dq, kc, vc, kn, vn, **dkw)
        planned = da.cluster_size(BATCH, KV, sm_count)
        derr = 0.0
        for c in (None, *range(1, da.MAX_CLUSTER + 1)):
            dgot = da.decode_attention_cuda(dq, kc, vc, kn, vn, cluster=c,
                                            **dkw)
            again = da.decode_attention_cuda(dq, kc, vc, kn, vn, cluster=c,
                                             **dkw)
            torch.cuda.synchronize()
            require(torch.equal(dgot, again),
                    f"w32 decode attention {arch} cluster {c}: two calls "
                    "differ")
            e, _ = judge_attention(f"w32 {arch} decode cluster {c}", dgot,
                                   dwant, bf16, True)
            derr = max(derr, e)
            out["decode_runs"] += 1
        out["archs"][arch] = {
            "prefill_shape": f"q ({BATCH * H},{PROMPT},{dh}) kv "
                             f"({BATCH * KV},{PROMPT},{dh}) G {G}",
            "max_abs_err": err, "outside_tight_share": share,
            "ring_depths": depths,
            "step_shape": f"q ({BATCH},{KV},{G},{dh}) caches ({BATCH},"
                          f"{Smax},{KV},{dh}) pos {pos}",
            "cluster": planned, "decode_max_abs_err": derr}
        out["all"] = max(out["all"], err)
        out["decode_all"] = max(out["decode_all"], derr)
        if main:
            out["main"], out["decode_main"] = err, derr
        log(f"  (a) width-32 attention at {arch}'s shapes: prefill "
            f"max_abs_err {err:.3e} (outside-tight share {share:.2e}), ring "
            f"depths {depths} bit-equal to depth 0; decode at every cluster "
            f"size (planner's {planned}) max_abs_err {derr:.3e}")
        if not main:
            continue
        for armed in W32_FAULTS:
            tag = f"{armed['site']} bit {armed['bit']}"
            kflip = armed["site"] == "log" and armed["bit"] == 31
            with fault_injection(FaultSpec(**armed)):
                want = fa.flash_attention_ref(q, k, v, **kw)
                got = fa.flash_attention_cuda(q, k, v,
                                              block=fa.DEFAULT_BLOCK, **kw)
                ring = fa.flash_attention_pipelined_cuda(
                    q, k, v, block=ATTENTION_RING_BLOCK, **kw)
                dwant = da.decode_attention_ref(dq, kc, vc, kn, vn, **dkw)
                dgot = da.decode_attention_cuda(dq, kc, vc, kn, vn, **dkw)
                torch.cuda.synchronize()
                require(torch.equal(ring, got),
                        f"w32 attention {tag}: the ring differs from depth 0")
                for what, g, w in (("prefill", got, want),
                                   ("decode", dgot, dwant)):
                    if not kflip:
                        judge_attention(f"w32 {arch} {what} {tag}", g, w,
                                        bf16, True)
                        continue
                    tol = dict(TOL_BF16)
                    tol["atol"] += TOL_APPROX_EXTRA
                    _, err, share = close(g, w, **tol)
                    lost, ratio = kflip_unexplained(g, w, **tol)
                    out[f"kflip_{what}_outside_share"] = share
                    out[f"kflip_{what}_max_abs_err"] = err
                    out[f"kflip_{what}_unexplained"] = lost
                    require(bool(torch.isfinite(g.float()).all())
                            and share <= W32_KFLIP_OUTLIER_SHARE
                            and lost == 0,
                            f"w32 {arch} {what} {tag}: {share:.3e} of the "
                            f"outputs outside {tol} (at most "
                            f"{W32_KFLIP_OUTLIER_SHARE}), {lost} of them "
                            "not a quotient step of 4^n")
                    log(f"  (a) {what} under {tag} (k's low bit): "
                        f"{share:.3e} of the outputs outside the tight "
                        f"bound, each a quotient step of 4^n (largest "
                        f"|got/want| {ratio:.3f}), max_abs_err {err:.3e}")
        log(f"  (a) width-32 attention at {arch}'s shapes under each of "
            f"{len(W32_FAULTS)} armings: within the tolerances, the ring "
            "bit-equal to depth 0")
    return out


def w32_tuning(dev) -> dict:
    """Phase 17 (b): ``measure_error('mul' / 'div', 32, 8)`` through the
    width-32 elemwise kernel, each statistic equal to the same sweep on
    the plain versions (on the CPU) to BENCH_REL_TOL relative, with one
    ``elemwise_w32`` launch each; ``select_config(width=None)`` on the card
    sweeps width 32 too (its elemwise_w32 launches) and selects what the
    plain versions select."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.tuning import frontier, measure_error, select_config
    from repro_torch.tuning.select import _available_widths

    out = {}
    for op in ("mul", "div"):
        reset_launch_counts()
        card, source = measure_error(op, 32, W32_SPEC["coeff_bits"],
                                     device=dev)
        n = launch_counts()["elemwise_w32"]
        cpu, _ = measure_error(op, 32, W32_SPEC["coeff_bits"], device="cpu")
        require(n == 1, f"measure_error({op!r}, 32) launched {n} width-32 "
                        "elemwise kernels, expected 1")
        for (k, got), (_, want) in zip(card, cpu):
            require(abs(got - want) <= BENCH_REL_TOL * max(abs(want), 1e-300),
                    f"measure_error({op!r}, 32) {k}: card {got} vs plain "
                    f"{want}")
        out[f"measure_error_{op}_w32"] = dict(card)
        log(f"  (b) measure_error({op!r}, 32, 8) on the card ({source}): "
            f"{dict(card)} — equal to the plain versions'")
    require(32 in _available_widths(), "select_config omits width 32")
    kw = dict(error_budget=1.0, coeff_sweep=(8,), bench=None)
    frontier._ERROR_CACHE.clear()           # measure each width anew
    reset_launch_counts()
    card = select_config("mul", width=None, device=dev, **kw)
    n32 = launch_counts()["elemwise_w32"]
    cpu = select_config("mul", width=None, device="cpu", **kw)
    require(n32 == 1, f"select_config(width=None) launched {n32} width-32 "
                      "elemwise kernels, expected 1 (one sweep)")
    require(card.as_dict() == cpu.as_dict(),
            f"select_config on the card {card.as_dict()} vs plain "
            f"{cpu.as_dict()}")
    out["select_config"] = card.as_dict()
    log(f"  (b) select_config('mul', width=None) on the card swept widths "
        f"{_available_widths()}: {card.label()}, equal to the plain versions'")
    return out


def w32_policy(attention: str = "auto", div: str = "auto"):
    """The width-32 divider policy file of phase 17 (c): the attention
    entry at width 32 cb 8 frac_out 15, the div entry at width 32 cb 8,
    each with the given backend name ('ref': the plain versions)."""
    from repro_torch.tuning import PolicyEntry, TuningPolicy

    return _saved_and_loaded(TuningPolicy(entries=(
        PolicyEntry(op="attention", frac_out=W32_ATTENTION_FRAC_OUT,
                    backend=attention, **W32_SPEC),
        PolicyEntry(op="div", backend=div, **W32_SPEC))))


@contextlib.contextmanager
def ulp_nudged_attention():
    """Every attention output of a model (prefill and decode step) moved by
    one bf16 ulp, its lowest mantissa bit flipped: a plain-version run's
    stand-in for the kernels' last-place differences (phase 17 (c)'s
    witness). Patches the stack's two attention entries."""
    import torch
    from repro_torch.models import transformer

    saved = transformer.flash_attention, transformer.decode_attention_append

    def nudged(fn):
        def call(*args, **kw):
            o = fn(*args, **kw)
            require(o.dtype == torch.bfloat16, "ulp nudge: attention "
                    f"output is {o.dtype}, not bfloat16")
            return (o.view(torch.int16) ^ 1).view(torch.bfloat16)
        return call

    transformer.flash_attention, transformer.decode_attention_append = (
        nudged(f) for f in saved)
    try:
        yield
    finally:
        (transformer.flash_attention,
         transformer.decode_attention_append) = saved


def w32_serve(dev, served) -> dict:
    """Phase 17 (c): smollm-360m at full width served under the width-32
    policy file (``--approx simdive --policy``), then the same with
    ``use_in_norm``: each through ``policy_generate`` (captured ==
    eager, one attention launch a layer a prefill and one decode_attention
    a step, and with use_in_norm one sqrt and one elemwise a block norm —
    every one of them on its width-32 form). Divider only, the logits lie
    within ``ulp_logit_tol`` of the same file on the plain versions. With
    use_in_norm they cannot (the note in the body), and that gate is
    replaced: every norm's kernels are held to their plain versions on the
    served path itself — the run ``torch.equal`` to the same file with the
    div entry on 'ref' (the norms' plain versions on the card, attention
    on its kernels), and the all-plain run ``torch.equal`` to the file
    with the attention entry on 'ref' (the norms on their kernels), both
    fed the served tokens — and the all-kernel against all-plain logit
    difference is recorded, not gated. The witness for the replacement,
    in both runs: the all-plain run against itself with every attention
    output moved by one bf16 ulp (ulp_nudged_attention), recorded, and
    with use_in_norm required to part by more than ``ulp_logit_tol``
    too. Both attention schedules pinned in turn (each a generate, counted
    apart). Then the served path in turns with the same process's width-16
    one (w16, w32, w32, w16), best of each."""
    import torch
    from repro_torch.kernels import (clear_autotune_cache,
                                     export_autotune_cache, launch_counts,
                                     preload_autotune_cache,
                                     reset_launch_counts)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import build

    params, prompts = served["params"], served["prompts"]
    out, lms = {}, {}

    def lm_of(attention, div, norm, backend="auto"):
        cfg = serve.serving_config(ARCH, backend=backend,
                                   policy=w32_policy(attention, div))
        return build(cfg.with_approx(replace(cfg.approx, use_in_norm=norm)))

    for what, norm in (("w32 policy", False), ("w32 policy use_in_norm",
                                               True)):
        policy = w32_policy()
        cfg = serve.serving_config(ARCH, policy=policy)
        if norm:
            cfg = cfg.with_approx(replace(cfg.approx, use_in_norm=True))
        spec, _, frac = cfg.approx.resolve_attention()
        require(spec.width == 32 and frac == W32_ATTENTION_FRAC_OUT
                and cfg.approx.resolve("div", cfg.approx.div_width)[0].width
                == 32, f"{what}: the plan does not resolve to width 32")
        if not norm:
            log(serve.render_plan(serve.resolve_serving_plan(cfg), cfg))
        lm = build(cfg)
        n = cfg.n_layers
        norms = 2 * n if norm else 0
        run = policy_generate(dev, lm, params, prompts, what, norms=norms)
        c = run["counts"]
        require(c["attention_w32"] + c["attention_pipelined_w32"] == n
                and c["decode_attention_w32"] == n * (GEN - 1)
                and c["sqrt_w32"] == c["elemwise_w32"] == norms * GEN,
                f"{what}: not every launch ran its width-32 form: {c}")
        plain_lm = lm_of("ref", "ref", norm, "ref")
        ref_all = plain_logits(plain_lm, params, prompts, run["tokens"])
        tol, top = ulp_logit_tol(what, ref_all, TIED_LOGIT_RANGE)
        # the witness: the all-plain run moved by one ulp of attention
        with ulp_nudged_attention():
            nudged = plain_logits(plain_lm, params, prompts, run["tokens"])
        witness = float((nudged - ref_all).abs().max())
        log(f"  {what}: witness, the all-plain run with every attention "
            f"output one bf16 ulp off vs itself: logits max_abs_err "
            f"{witness:.4f} (6-ulp bound {tol:g}), tokens equal "
            f"{int((nudged.argmax(-1) == ref_all.argmax(-1)).sum())}/"
            f"{run['tokens'].numel()}")
        del nudged, plain_lm
        if not norm:
            judged = judge_logits(what, run["logits"], run["tokens"],
                                  ref_all, tol)
        else:
            # use_in_norm at width 32: every block norm's rsqrt runs the
            # divider's correction table on a row scale that follows the
            # row (at width 16 R-4 makes it a constant), so a row whose
            # operand crosses a region boundary moves by the table's step
            # (~1 %). The bf16 attention kernels differ from their plain
            # versions within TOL_BF16, and over 64 norms of 32 layers the
            # two runs' rows cross different boundaries: all-kernel and
            # all-plain logits part by far more than 6 bf16 ulps. So the
            # norms' kernels are held to their plain versions, each in the
            # other's company, on the served tokens: bit for bit
            require(witness > tol,
                    f"{what}: one bf16 ulp of attention moves the all-plain "
                    f"logits by only {witness:.4f} <= {tol:g}, so the "
                    "amplification that excuses this run from the logit "
                    "gate does not show")
            mixed = {m: plain_logits(lm_of(*m, norm), params, prompts,
                                     run["tokens"], kernels=True)
                     for m in (("auto", "ref"), ("ref", "auto"))}
            require(torch.equal(mixed["auto", "ref"], run["logits"]),
                    f"{what}: the norms on their plain versions change the "
                    "all-kernel logits")
            require(torch.equal(mixed["ref", "auto"], ref_all),
                    f"{what}: the norms on their kernels change the "
                    "all-plain logits")
            err = float((run["logits"] - ref_all).abs().max())
            agree = run["tokens"] == ref_all.argmax(-1)
            judged = dict(logit_err=err, tokens_equal=int(agree.sum()),
                          norms_bit_equal_in_both=True)
            log(f"  {what}: the norms' width-32 sqrt and elemwise kernels "
                "leave the logits torch.equal to their plain versions', "
                "with attention on its kernels and on its plain version; "
                f"all-kernel vs all-plain logits max_abs_err {err:.4f} "
                f"(not gated: see w32_serve), tokens equal "
                f"{int(agree.sum())}/{agree.numel()}")
            del mixed
        del ref_all
        key = "w32_norm" if norm else "w32"
        out[key] = dict(counts=c, first_generate_s=run["first_generate_s"],
                        logit_max=top, logit_tol=tol,
                        ulp_nudge_logit_err=witness, **judged)
        lms[key] = lm
    # both attention schedules on the width-32 path: each pinned, one
    # counted generate each (the autotune served one of them above)
    lm = lms["w32"]
    tuned = export_autotune_cache()
    pinned = {}
    for block, own in ((fa.DEFAULT_BLOCK, "attention_w32"),
                       (ATTENTION_RING_BLOCK, "attention_pipelined_w32")):
        require(_pin_blocks("attention", block) > 0, "nothing to pin")
        serve.generate(lm, params, prompts, PROMPT + GEN, GEN)  # captures
        reset_launch_counts()
        serve.generate(lm, params, prompts, PROMPT + GEN, GEN)
        torch.cuda.synchronize()
        c = launch_counts()
        require(c[own] == lm.cfg.n_layers,
                f"w32 pinned to {block}: launches {c}")
        pinned[own] = c[own]
    clear_autotune_cache()
    preload_autotune_cache(tuned)
    out["pinned_counts"] = pinned
    # in turns with the width-16 path of phase 4: w16, w32, w32, w16 (the
    # served graphs only: phase 9 times the eager path)
    times = {}
    for name, this in (("w16", served["lm"]), ("w32", lm), ("w32", lm),
                       ("w16", served["lm"])):
        t = policy_times(dev, this, params, prompts, prefix=f"{name}_",
                         eager=False)
        for k, v in t.items():
            times[k] = min(times.get(k, v), v)
    out["times"] = times
    log("  (c) width-32 policy generate, captured: "
        f"{times['w32_generate_captured_ms']:.2f} ms (width 16: "
        f"{times['w16_generate_captured_ms']:.2f}); prefill replay "
        f"{times['w32_prefill_replay_ms']:.3f} "
        f"({times['w16_prefill_replay_ms']:.3f}), step replay "
        f"{times['w32_decode_step_replay_ms']:.3f} "
        f"({times['w16_decode_step_replay_ms']:.3f}) ms")
    return out


def w32_kernel_rows(dev, served, int_rate) -> list:
    """The width-32 forms' rows of the kernels line, timed at the served
    path's shapes: the attention kernels at smollm-360m's prefill and step
    (beside the same kernels at width 16, in turns, and
    ``scaled_dot_product_attention``), ``elemwise`` at the use_in_norm
    prefill's divide ((BATCH, PROMPT, 1) lanes, fo 16) and at 16.8 M lanes
    (memory bound), ``sqrt`` at the norm's shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import get_op
    from repro_torch.kernels import flash_attention as fa

    cfg = served["lm"].cfg
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // KV
    spec, fo = w32_spec(), W32_ATTENTION_FRAC_OUT
    spec16 = SimdiveSpec(width=16, coeff_bits=6)
    gen = torch.Generator(device=dev).manual_seed(SEED + 174)
    bf16 = torch.bfloat16
    q = torch.randn(BATCH * H, PROMPT, dh, generator=gen, device=dev).to(bf16)
    k, v = (torch.randn(BATCH * KV, PROMPT, dh, generator=gen, device=dev
                        ).to(bf16) for _ in range(2))
    kw = dict(causal=True, approx_div=True, frac_out=fo, kv_group=G)
    att = {}
    for s, w in ((spec16, 16), (spec, 32), (spec, 32), (spec16, 16)):
        for block in (fa.DEFAULT_BLOCK, ATTENTION_RING_BLOCK):
            t = gpu_graph_time_ms(lambda s=s, b=block: get_op(
                "attention", s, "cuda", block=b)(q, k, v, **kw), iters=50)
            att[w, block] = min(att.get((w, block), t), t)
    plain_ms = gpu_time_ms(lambda: get_op("attention", spec, "ref")(
        q, k, v, **kw), iters=10)
    q4 = q.reshape(BATCH, H, PROMPT, dh)
    k4 = k.reshape(BATCH, KV, PROMPT, dh).repeat_interleave(G, dim=1)
    v4 = v.reshape(BATCH, KV, PROMPT, dh).repeat_interleave(G, dim=1)
    lib_ms = gpu_graph_time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), iters=50)
    pairs = BATCH * H * PROMPT * (PROMPT + 1) // 2
    ops_ms = 4 * pairs * dh / BF16_FLOPS * 1e3
    bytes_ms = 2 * (2 * q.numel() + k.numel() + v.numel()) \
        / HBM_BYTES_PER_S * 1e3
    shape = (f"q ({BATCH * H},{PROMPT},{dh}) kv ({BATCH * KV},{PROMPT},{dh})"
             f" bf16 causal simdive w32 cb{spec.coeff_bits} fo{fo}")
    rows = []
    for name, block, line in (
            ("flash_attention_w32", fa.DEFAULT_BLOCK, 145),
            ("flash_attention_pipelined_w32", ATTENTION_RING_BLOCK, 175)):
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_w32.cu",
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "shape": shape, "block": list(block), "ms": att[32, block],
            "w16_ms": att[16, block], "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": lib_ms})
        log(f"  {name} {block}: {att[32, block]:.5f} ms (graph; width 16 "
            f"{att[16, block]:.5f}), plain {plain_ms:.3f}, sdpa "
            f"{lib_ms:.5f}, bound {max(ops_ms, bytes_ms):.5f} ms")
    # the decode step: cache PROMPT + GEN, pos PROMPT + 15, every cluster
    Smax, pos = PROMPT + GEN, PROMPT + 15
    sizes = tuple(range(1, 9))
    t16 = time_decode_attention(dev, gen, BATCH, Smax, KV, G, dh, pos,
                                spec16, fo, int_rate)
    t32 = time_decode_attention(dev, gen, BATCH, Smax, KV, G, dh, pos, spec,
                                fo, int_rate, clusters=sizes)
    dq, kc, vc, kn, vn = t32["inputs"]
    dplain = gpu_time_ms(lambda: get_op("decode_attention", spec, "ref")(
        dq, kc, vc, kn, vn, pos=pos, slot=pos, approx_div=True,
        frac_out=fo), iters=50)
    rows.append({
        "name": "decode_attention_w32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention_w32.cu",
        "replaces": "src/repro/models/layers.py:351",
        "note": "no TPU kernel: the reference's jnp decode_attention_append "
                "around elemwise_pallas (src/repro/kernels/elemwise.py:67)",
        "shape": f"q ({BATCH},{KV},{G},{dh}) caches ({BATCH},{Smax},{KV},"
                 f"{dh}) bf16 pos {pos} simdive w32 cb{spec.coeff_bits} "
                 f"fo{fo}",
        "cluster": t32["cluster"], "ms": t32["ms"], "w16_ms": t16["ms"],
        "plain_ms": dplain, "bound_ms": t32["bound_ms"],
        "bound_by": t32["bound_by"], "library_ms": t32["library_ms"],
        "ms_by_cluster": {str(c): t for c, t in t32["ms_by_cluster"].items()}})
    log(f"  decode_attention_w32: {t32['ms']:.5f} ms (graph, cluster "
        f"{t32['cluster']}; width 16 {t16['ms']:.5f}), plain {dplain:.4f}, "
        f"sdpa {t32['library_ms']:.5f}, bound {t32['bound_ms']:.6f} ms")
    # elemwise: the use_in_norm prefill's divide (2^31 / r at fo 16, one
    # lane a row) and 16.8 M lanes
    ew = []
    for n in (BATCH * PROMPT, 1 << 24):
        a = torch.full((n,), 1 << 31, device=dev, dtype=torch.int64)
        b = torch.randint(1 << 10, 1 << 32, (n,), generator=gen, device=dev,
                          dtype=torch.int64)
        kern = lambda a=a, b=b: get_op("elemwise", spec, "cuda")(
            a, b, op="div", frac_out=W32_DIV_FRAC_OUT)
        ms = gpu_graph_time_ms(kern, iters=200 if n < 1 << 20 else 20)
        plain = gpu_time_ms(lambda a=a, b=b: get_op("elemwise", spec, "ref")(
            a, b, op="div", frac_out=W32_DIV_FRAC_OUT), iters=20)
        b_ms = 24 * n / HBM_BYTES_PER_S * 1e3
        o_ms = W32_ELEMWISE_OPS_PER_LANE * n / int_rate * 1e3
        ew.append(dict(lanes=n, ms=ms, plain_ms=plain,
                       bound_ms=max(b_ms, o_ms),
                       bound_by="bytes" if b_ms >= o_ms else "operations"))
        log(f"  elemwise_w32 div fo16, {n} lanes: {ms:.5f} ms (graph), plain "
            f"{plain:.4f} ms, bound {max(b_ms, o_ms):.6f} ms")
    rows.append({
        "name": "elemwise_w32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/elemwise.cu",
        "replaces": "src/repro/kernels/elemwise.py:33",
        "shape": f"({BATCH},{PROMPT},1) uint64 lanes, div w32 cb8 fo16 (the "
                 "use_in_norm prefill's rsqrt divide)",
        "ms": ew[0]["ms"], "plain_ms": ew[0]["plain_ms"],
        "bound_ms": ew[0]["bound_ms"], "bound_by": ew[0]["bound_by"],
        "library_ms": None, "lanes_16M": ew[1]})
    n = BATCH * PROMPT
    a = torch.randint(1, 1 << 32, (BATCH, PROMPT, 1), generator=gen,
                      device=dev, dtype=torch.int64)
    ms = gpu_graph_time_ms(lambda: get_op("sqrt", spec, "cuda")(a), iters=200)
    plain = gpu_time_ms(lambda: get_op("sqrt", spec, "ref")(a), iters=50)
    b_ms = 16 * n / HBM_BYTES_PER_S * 1e3
    o_ms = W32_SQRT_OPS_PER_LANE * n / int_rate * 1e3
    rows.append({
        "name": "sqrt_w32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/elemwise.cu",
        "replaces": "src/repro/core/simdive.py:68",
        "note": "no TPU kernel: the reference's jnp simdive_sqrt, registered "
                "for its oracle alone (src/repro/kernels/ops.py:472)",
        "shape": f"({BATCH},{PROMPT},1) uint64 lanes, w32 fo0 (a prefill's "
                 "block norm)",
        "ms": ms, "plain_ms": plain, "bound_ms": max(b_ms, o_ms),
        "bound_by": "bytes" if b_ms >= o_ms else "operations",
        "library_ms": None})
    log(f"  sqrt_w32, {n} lanes: {ms:.5f} ms (graph), plain {plain:.4f} ms, "
        f"bound {max(b_ms, o_ms):.6f} ms")
    return rows


def width32_phase(dev, served, int_rate, ptxas) -> dict:
    """Phase 17: (a) the width-32 kernels against their plain versions,
    (b) the error sweep and the selection at width 32, (c) smollm-360m
    served under the width-32 divider policy, with and without
    use_in_norm; the width-32 rows of the kernels line, with each form's
    registers and spills from the build."""
    lanes = w32_lane_kernels(dev)
    att = w32_attention_kernels(dev)
    tuning = w32_tuning(dev)
    served32 = w32_serve(dev, served)
    rows = w32_kernel_rows(dev, served, int_rate)
    regs = {}
    for r in ptxas:
        regs.setdefault(r["source"], []).append(
            {k: r[k] for k in ("entry", "registers", "spill_bytes")
             if k in r})
    c, cn = served32["w32"]["counts"], served32["w32_norm"]["counts"]
    pinned = served32["pinned_counts"]
    for row in rows:
        name = row["name"]
        if name.startswith("flash_attention"):
            own = ("attention_pipelined_w32" if "pipelined" in name
                   else "attention_w32")
            row["launches_autotuned"] = c[own]
            row["launches_pinned"] = pinned[own]
            row["launches"] = c[own] + pinned[own]
            row["launches_use_in_norm"] = cn[own]
            row["max_abs_err"] = att["main"]
            row["max_abs_err_all_cases"] = att["all"]
            row["ptxas"] = [r for r in regs.get("flash_attention_w32.cu", [])]
        elif name == "decode_attention_w32":
            row["launches"] = c["decode_attention_w32"]
            row["launches_use_in_norm"] = cn["decode_attention_w32"]
            row["max_abs_err"] = att["decode_main"]
            row["max_abs_err_all_cases"] = att["decode_all"]
            row["ptxas"] = regs.get("decode_attention_w32.cu", [])
        else:
            own = name
            row["launches"] = cn[own]
            row["max_abs_err"] = 0.0
            row["ptxas"] = regs.get("elemwise.cu", [])
    return dict(lanes=lanes, attention=att, tuning=tuning, serve=served32,
                kernels=rows)


# ------------------------------------------------- phase 18: the mesh --
# (a) stablelm-1.6b (src/repro_torch/configs/stablelm_1_6b.py): every split
# divides at tp 2 (32 heads = 32 kv heads, d_ff 5,632, vocab 100,352), so
# it runs the kv-head layout, the column / row MLP, the qkv biases' split
# and the vocab-parallel embedding, head and loss; 4 of its 24 layers
MESH_ARCH, MESH_LAYERS, MESH_TP = "stablelm-1.6b", 4, 2
MESH_BATCH, MESH_SEQ, MESH_STEPS = 4, 512, 2
# (b) smollm-360m at tp 3: K/V replicated (5 kv heads), the MLP replicated
# (d_ff 2,560), the vocabulary split (49,152); 2 of 32 layers, 1 step
MESH_TP3_ARCH, MESH_TP3_LAYERS = "smollm-360m", 2
# (c) mixtral-8x7b's MoE block at full width
MESH_MOE_ARCH, MESH_MOE_X = "mixtral-8x7b", (4, 512, 4096)
# each output element of the SPMD block adds two bf16-rounded partial sums
# (one a hidden-dim half) in float32 and rounds once more, where the
# unsplit block rounds the whole sum once: three bf16 roundings of a
# partial's magnitude apart at most, bounded by 4 bf16 ulps (2^-8 each) of
# the output's largest magnitude
MESH_MOE_ULPS = 4
MESH_COMPRESS_SHAPE = (2048, 2048)
MESH_JOIN_S = 600
# the SIMDive linears of layer 0, by family: an attention block's, an
# rwkv6 layer's (time mix and channel mix), a Mamba2 layer's
MESH_LINEARS = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")
MESH_FAMILY_LINEARS = {
    "ssm": ("wr", "wk", "wv", "wg", "wo", "cm_wk", "cm_wv", "cm_wr"),
    "hybrid": ("wz", "wx", "wb", "wc", "wdt", "out_proj")}
# (f)-(h): the mesh's remaining cases at tp 2, inside (a)'s spawn, one step
# each at (a)'s batch: smollm-360m cuts a query and a kv head (15 and 5
# heads over 2 ranks: transformer.head_plan), rwkv6-1.6b splits its 32
# heads, zamba2-2.7b its 80 Mamba2 heads (one group of 9 layers and the
# shared block with its LoRA)
MESH_CASES = {"f": ("smollm-360m", 2), "g": ("rwkv6-1.6b", 2),
              "h": ("zamba2-2.7b", 9)}
# (i): the served forward at tp 2, divider-only: a prefill at (a)'s batch
# and MESH_SERVE_STEPS decode steps (stablelm's cache split by kv head,
# smollm's by sequence: specs.cache_specs)
MESH_SERVE = (("stablelm-1.6b", 4), ("smollm-360m", 2),
              ("mixtral-8x7b", 2))
MESH_SERVE_STEPS = 8
# (o): after the served steps, MESH_ROW_STEPS more with per-row positions
# (row b one slot deeper than row b - 1; a cache of 512 + 8 + 4 + 4 slots,
# smollm's split by sequence over the two ranks)
MESH_ROW_STEPS = 4
# (l): (a)'s config, one step under --sp inside (a)'s spawn; (m): (f)'s
# config (smollm-360m, 2 layers), one step under --pure-dp over (a)'s two
# ranks and one under --fsdp over a spawn of MESH_FSDP_WORLD ranks (data 2
# x model 2), run beside (b)'s
MESH_FSDP_WORLD = 4
# (m) splits the batch over data ranks: their partial sums add in another
# order than the unsplit run's, so beside the witnesses the loss may move
# by 8 float32 ulps of itself and a gradient leaf by one bf16 ulp of its
# largest magnitude (tests/test_torch_mesh_cases.py's tolerances)
MESH_DATA_LOSS_RTOL, MESH_DATA_GRAD_ULP = 8 * 2.0 ** -23, 2.0 ** -8
MESH_SERVE_LOGITS = (2.0 ** -4, 2.0 ** 8)   # where the ulp bound holds
# (j)-(k): the dry run on the host (launch/dryrun.py), in subprocesses
# started with the phase: (j) cells (a), (b), (f)-(h) as the ranks run them
# (their collectives and their parameter and optimizer bytes equal what
# the ranks measured, (a)'s peak within MESH_PEAK_TOL of rank 0's
# max_memory_allocated over its run); (k) one FULL train_4k single-pod
# cell a family
MESH_DRYRUN_ARCHS = ("smollm-360m", "mixtral-8x7b", "qwen2-vl-2b",
                     "musicgen-medium", "rwkv6-1.6b", "zamba2-2.7b")
MESH_PEAK_TOL = 0.25
MESH_DRYRUN_BUDGET_S = 60


# what phase 18 runs; a rehearsal on the CPU passes smaller values
MESH_RUN = {"arch": MESH_ARCH, "layers": MESH_LAYERS, "tp": MESH_TP,
            "arch3": MESH_TP3_ARCH, "layers3": MESH_TP3_LAYERS,
            "batch": MESH_BATCH, "seq": MESH_SEQ, "steps": MESH_STEPS,
            "moe_arch": MESH_MOE_ARCH, "moe_x": MESH_MOE_X,
            "compress": MESH_COMPRESS_SHAPE, "cases": MESH_CASES,
            "serve": MESH_SERVE, "serve_steps": MESH_SERVE_STEPS,
            "row_steps": MESH_ROW_STEPS,
            "dryrun_archs": MESH_DRYRUN_ARCHS, "smoke": False}


def mesh_config(run: dict, three: bool = False, case: str | None = None):
    from repro_torch.configs import get_config
    from repro_torch.core.approx import ApproxConfig

    arch, layers = ((run["arch3"], run["layers3"]) if three
                    else tuple(run["cases"][case]) if case
                    else (run["arch"], run["layers"]))
    cfg = get_config(arch, smoke=run["smoke"])
    return replace(cfg, n_layers=layers).with_approx(
        ApproxConfig(mode="simdive", backward="approx"))


def mesh_shape(run: dict):
    from repro_torch.configs import ShapeConfig

    return ShapeConfig("mesh", run["seq"], run["batch"], "train")


@contextlib.contextmanager
def ulp_nudged_lse():
    """Every row's log-sum-exp moved one float32 ulp up (``nextafter``),
    in the loss and in its gradient, ``softmax = exp(logits - lse)``: the
    unsplit run's stand-in for what float order alone does to the loss
    (phase 18's witness). Patches the loss's ``xent``."""
    import torch
    from repro_torch.models import loss

    class Nudged(torch.autograd.Function):
        @staticmethod
        def forward(ctx, lg, labels):
            lse = torch.logsumexp(lg, dim=-1)
            lse = torch.nextafter(lse, torch.full_like(lse, math.inf))
            ctx.save_for_backward(lg, lse, labels)
            return lse - loss._pick(lg, labels)

        @staticmethod
        def backward(ctx, g):
            lg, lse, labels = ctx.saved_tensors
            d = torch.exp(lg - lse[..., None])
            flat = d.view(-1, d.shape[-1])
            flat[torch.arange(flat.shape[0], device=d.device),
                 labels.reshape(-1)] -= 1.0
            return d * g[..., None], None

    saved = loss.xent

    def nudged(logits, labels, vocab_size=None):
        return Nudged.apply(logits.to(torch.float32), labels)

    loss.xent = nudged
    try:
        yield
    finally:
        loss.xent = saved


@contextlib.contextmanager
def head_gradient_in_f32():
    """The head's input gradient ``g @ w^T`` accumulated in float32 by one
    GEMM and rounded once to bf16, in place of the bf16 GEMM's own
    order: the unsplit run's stand-in for what float order alone does to
    the one bf16 product whose reduction the vocabulary split reorders
    (phase 18's gradient witness; the split adds two float32 halves).
    Everything else, the weight gradient included, is the unsplit
    linear's. Patches the model's ``dense`` (the head's alone)."""
    import torch
    from repro_torch.models import model

    class Head(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.w_dtype = w.dtype
            w = w.to(x.dtype)
            ctx.save_for_backward(x, w)
            return x @ w

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            gx = (g.to(torch.float32) @ w.to(torch.float32).T).to(x.dtype)
            gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
            return gx, gw.to(ctx.w_dtype)

    saved = model.dense

    def head(x, w, approx=None, split=None):
        require(split is None, "the head witness runs unsplit")
        return Head.apply(x, w)

    model.dense = head
    try:
        yield
    finally:
        model.dense = saved


@contextlib.contextmanager
def first_step_grads(out: dict):
    """Record the gradients of the first step that ``launch.train``'s
    step takes (the data ranks' added: the output of ``sum_over_data``,
    which the step calls once on the way to the optimizer) into
    ``out["grads"]``, on the host. The copy is made inside that step and
    adds to its time."""
    from repro_torch.core.tree import tree_map
    from repro_torch.launch import train as t_train

    saved = t_train.sum_over_data

    def rec(grads, *rest):
        grads = saved(grads, *rest)
        if "grads" not in out:
            out["grads"] = tree_map(
                lambda g: None if g is None else g.detach().cpu(), grads)
        return grads

    t_train.sum_over_data = rec
    try:
        yield
    finally:
        t_train.sum_over_data = saved


@contextlib.contextmanager
def first_step_state(out: dict):
    """Record the bytes of the parameters and of the optimizer state that
    ``launch.train``'s step first takes (this rank's leaves) into
    ``out``. Patches ``launch.train.make_train_step``."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import train as t_train

    saved = t_train.make_train_step

    def held(tree) -> int:
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if t is not None)

    def make(*args, **kw):
        step = saved(*args, **kw)

        def rec(params, opt_state, *rest):
            if "params" not in out:
                out.update(params=held(params), optimizer=held(opt_state))
            return step(params, opt_state, *rest)
        return rec

    t_train.make_train_step = make
    try:
        yield
    finally:
        t_train.make_train_step = saved


def mesh_linears(cfg, run, dev, tp, zero3: str | None = None):
    """Every SIMDive linear of layer 0 at its shard shapes on the kernels
    against the unsplit linear on this rank (forward and both gradient
    products, ``torch.equal``); each weight's split read from
    ``sanitize_specs``. Inputs x (M, K) bf16, w (K, N) float32 and g (M,
    N) bf16 drawn on the card from seed 0; M the batch's tokens.
    ``zero3``: the run's parameter placement (``"pure_dp"``: every linear
    whole once gathered)."""
    import torch
    from repro_torch.launch import sharding as shardlib
    from repro_torch.launch import train as t_train
    from repro_torch.models.layers import dense

    from repro_torch.launch.specs import param_shapes

    specs = t_train.placement(cfg, shardlib.current_mesh(),
                              zero3=zero3)[0]["params"]
    layer = specs["stack"]["layers"]
    whole = param_shapes(cfg)["stack"]["layers"]
    M = run["batch"] * run["seq"]
    r = shardlib.rank_in("heads")
    out = {}
    for i, name in enumerate(MESH_FAMILY_LINEARS.get(cfg.family,
                                                     MESH_LINEARS)):
        path = ("mlp", name) if name in ("w1", "w2", "w3") else (name,)
        spec, leaf = layer, whole
        for key in path:
            spec, leaf = spec[key], leaf[key]
        K, N = leaf.shape[-2:]
        spec = tuple(spec.spec)
        kind = None
        if "model" in spec:
            kind = "row" if spec[-1] is None else "col"
        gen = torch.Generator(device=dev).manual_seed(SEED + 100 + i)
        x0 = torch.randn((M, K), generator=gen, device=dev).to(
            torch.bfloat16)
        w0 = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        g0 = torch.randn((M, N), generator=gen, device=dev).to(
            torch.bfloat16)

        def run(x, w, g, split):
            x = x.clone().requires_grad_()
            w = w.clone().requires_grad_()
            y = dense(x, w, cfg.approx, split)
            y.backward(g)
            return y.detach(), x.grad, w.grad

        with shardlib.use_rules(_OneRank()):
            y, gx, gw = run(x0, w0, g0, None)
        if kind == "col":
            n = N // tp
            sl = slice(r * n, (r + 1) * n)
            got = run(x0, w0[:, sl], g0[:, sl], ("col", "heads"))
            want = (y[:, sl], gx, gw[:, sl])
        elif kind == "row":
            k = K // tp
            sl = slice(r * k, (r + 1) * k)
            got = run(x0[:, sl], w0[sl], g0, ("row", "heads"))
            want = (y, gx[:, sl], gw[sl])
        else:
            got, want = run(x0, w0, g0, None), (y, gx, gw)
        out[name] = {"split": kind or "replicated",
                     "equal": [torch_equal(a, b) for a, b in zip(got, want)]}
    return out


def mesh_linears_sp(cfg, run, dev, tp):
    """(l) Every SIMDive linear of layer 0 under ``--sp`` at its shard
    shapes on the kernels against the unsplit linear on this rank: x
    (B, S, K) bf16 from (a)'s batch, w (K, N) float32, g bf16 drawn on the
    card from seed 0; a column-parallel linear takes this rank's slice of
    the sequence (gathered inside) and its columns, a row-parallel one
    its rows of K and gives this rank's slice of the sequence; forward
    and both gradient products ``torch.equal`` to the unsplit's."""
    import torch
    from repro_torch.launch import sharding as shardlib
    from repro_torch.launch import train as t_train
    from repro_torch.launch.specs import param_shapes
    from repro_torch.models.layers import dense

    specs = t_train.placement(cfg, shardlib.current_mesh())[0]["params"]
    layer = specs["stack"]["layers"]
    whole = param_shapes(cfg)["stack"]["layers"]
    B, S = run["batch"], run["seq"]
    r = shardlib.rank_in("heads")
    rows = slice(r * S // tp, (r + 1) * S // tp)
    out = {}
    for i, name in enumerate(MESH_LINEARS):
        path = ("mlp", name) if name in ("w1", "w2", "w3") else (name,)
        spec, leaf = layer, whole
        for key in path:
            spec, leaf = spec[key], leaf[key]
        K, N = leaf.shape[-2:]
        kind = "row" if tuple(spec.spec)[-1] is None else "col"
        gen = torch.Generator(device=dev).manual_seed(SEED + 100 + i)
        x0 = torch.randn((B, S, K), generator=gen, device=dev).to(
            torch.bfloat16)
        w0 = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        g0 = torch.randn((B, S, N), generator=gen, device=dev).to(
            torch.bfloat16)

        def run_linear(x, w, g, split):
            x = x.clone().requires_grad_()
            w = w.clone().requires_grad_()
            y = dense(x, w, cfg.approx, split)
            y.backward(g)
            return y.detach(), x.grad, w.grad

        with shardlib.use_rules(_OneRank()):
            y, gx, gw = run_linear(x0, w0, g0, None)
        if kind == "col":
            c = slice(r * N // tp, (r + 1) * N // tp)
            got = run_linear(x0[:, rows], w0[:, c], g0[..., c],
                             ("col", "heads", "seq"))
            want = (y[..., c], gx[:, rows], gw[:, c])
        else:
            c = slice(r * K // tp, (r + 1) * K // tp)
            got = run_linear(x0[..., c], w0[c], g0[:, rows],
                             ("row", "heads", "seq"))
            want = (y[:, rows], gx[..., c], gw[c])
        out[name] = {"split": kind + " (sequence-parallel)",
                     "equal": [torch_equal(a, b) for a, b in zip(got, want)]}
    return out


class _OneRank:
    """A mesh of one rank a dim: bound, it changes nothing but the loss's
    branch, so a rank computes the unsplit linear under it."""
    axis_names, shape = ("data", "model"), (1, 1)


def gloo_probe(dev) -> dict:
    """gloo's collectives on CUDA tensors, each dtype the path reduces:
    the result against the plain value (a rank's tensor is its rank + 1)."""
    import torch
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    out = {}
    for name, dtype in (("float32", torch.float32), ("int64", torch.int64),
                        ("int32", torch.int32)):
        for op, rop, want in (("sum", dist.ReduceOp.SUM,
                               world * (world + 1) // 2),
                              ("max", dist.ReduceOp.MAX, world)):
            t = torch.full((1024,), rank + 1, dtype=dtype, device=dev)
            try:
                dist.all_reduce(t, op=rop)
                out[f"all_reduce_{op}_{name}"] = bool((t == want).all())
            except RuntimeError as e:
                out[f"all_reduce_{op}_{name}"] = f"refused: {e}"[:200]
    t = torch.full((1024,), rank + 1.0, device=dev)
    dist.broadcast(t, src=0)
    out["broadcast_float32"] = bool((t == 1.0).all())
    # sequence parallelism's reduce_scatter: rank r's part of every rank's
    # arange, summed
    for name, dtype in (("float32", torch.float32), ("int64", torch.int64)):
        src = torch.arange(world * 256, dtype=dtype, device=dev) * (rank + 1)
        part = torch.empty(256, dtype=dtype, device=dev)
        try:
            dist.reduce_scatter_tensor(part, src)
            want = torch.arange(rank * 256, (rank + 1) * 256, dtype=dtype,
                                device=dev) * (world * (world + 1) // 2)
            out[f"reduce_scatter_{name}"] = bool(torch.equal(part, want))
        except RuntimeError as e:
            out[f"reduce_scatter_{name}"] = f"refused: {e}"[:200]
    return out


def _mesh_rank(rank, world, job, run, store, out, device_type):
    """A spawned rank of phase 18: ``job`` (``tp2`` / ``tp3``) run under a
    gloo group of ``world`` ranks on the one card; its results written to
    ``out.<rank>``. A failure writes its traceback and ends the process at
    once, so that the other ranks' collectives fail instead of waiting."""
    import datetime
    import os
    import traceback

    os.environ["SIMDIVE_AUTOTUNE"] = "0"   # the ranks' timings would race
    import torch
    import torch.distributed as dist

    dev = torch.device(device_type)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        from repro_torch.launch.train import deterministic

        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        build.load(dev)
        deterministic()
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_JOIN_S))
    try:
        res = {"ok": True, **_MESH_JOBS[job](dev, run, out)}
    # simdive-lint: allow(swallowed-exception): whatever a rank raises is written with its traceback for the parent to raise, and the rank exits non-zero
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()},
                   f"{out}.{rank}")
        os._exit(1)
    torch.save(res, f"{out}.{rank}")
    dist.destroy_process_group()


def _mesh_train(cfg, run, dev, tp, steps, mesh=None, gather_to=None,
                sp: bool = False, zero3: str | None = None) -> dict:
    """``launch.train.train`` at ``mesh_shape()`` from seed 0 (bound to a
    mesh of its own where this process is one of several ranks): losses,
    step seconds, this rank's launches (the run's, and a step's) and
    collectives a step, and the first step's gradients. On a rank those
    are gathered whole on the host over ``mesh`` and written by rank 0 to
    ``gather_to`` with the first step's loss; unbound they come back
    under ``"grads"``. ``sp`` / ``zero3``: the mesh's options
    (``launch.train.train``'s)."""
    import torch
    import torch.distributed as dist
    from repro_torch import checkpoint as ckpt
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import sharding as shardlib
    from repro_torch.launch import train as t_train

    times, first, state = [], {}, {}
    reset_launch_counts()
    shardlib.reset_collective_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with first_step_grads(first), first_step_state(state):
        _, losses = t_train.train(cfg, mesh_shape(run), steps=steps,
                                  ckpt_dir=None, tp=tp, device=dev,
                                  log_every=steps, step_times=times, sp=sp,
                                  zero3=zero3)
    counts, colls = launch_counts(), shardlib.collective_counts()
    by_axis = shardlib.collective_counts(by_axis=True)
    res = {"losses": losses, "step_s": times,
           "launches": {k: v for k, v in counts.items() if v},
           "launches_a_step": {k: v / steps for k, v in counts.items() if v},
           "collectives_a_step": {k: v / steps for k, v in colls.items()},
           "collectives_by_axis_a_step": {
               k: [c / steps, b / steps] for k, (c, b) in by_axis.items()},
           "state_bytes": state}
    if dev.type == "cuda":
        res["peak_bytes_run"] = torch.cuda.max_memory_allocated(dev)
    if mesh is None:
        res["grads"] = first["grads"]
        return res
    with shardlib.use_rules(mesh, t_train.rules_for(mesh, sp,
                                                    zero3 == "pure_dp")):
        psh = t_train.placement(cfg, mesh, zero3=zero3)[0]["params"]
    full = tree_map(lambda g, sh: None if g is None
                    else ckpt.gather_full(g, sh), first["grads"], psh)
    if dist.get_rank() == 0:
        torch.save({"loss": losses[0], "grads": full}, gather_to)
    return res


def _mesh_job_tp2(dev, run, out) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch.launch import sharding as shardlib
    from repro_torch.launch import train as t_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import batch_axes_for

    tp = run["tp"]
    res = {"probe": gloo_probe(dev)}
    cfg = mesh_config(run)
    mesh = make_host_mesh(model=tp)
    with shardlib.use_rules(mesh, {"batch": batch_axes_for(mesh)}):
        res["linears"] = mesh_linears(cfg, run, dev, tp)
        res["compress"] = mesh_compress(run, dev)
    _free(dev)
    res["train"] = _mesh_train(cfg, run, dev, tp, run["steps"], mesh,
                               f"{out}.grads")
    _free(dev)
    # (l): (a)'s config, one step under --sp
    with shardlib.use_rules(mesh, t_train.rules_for(mesh, sp=True)):
        res["linears_l"] = mesh_linears_sp(cfg, run, dev, tp)
    _free(dev)
    res["train_l"] = _mesh_train(cfg, run, dev, tp, 1, mesh,
                                 f"{out}.grads_l", sp=True)
    _free(dev)
    with shardlib.use_rules(mesh, {"batch": batch_axes_for(mesh)}):
        o, aux, routes = mesh_moe_block(run, dev)
    if dist.get_rank() == 0:
        torch.save({"out": o.cpu(), "aux": float(aux), "routes": routes},
                   f"{out}.moe")
    del o
    # (n): the block under the experts override, each rank its experts
    with shardlib.use_rules(mesh, t_train.rules_for(mesh, experts=True)):
        shardlib.reset_collective_counts()
        o, aux, routes = mesh_moe_block(run, dev)
        res["moe_experts_collectives"] = shardlib.collective_counts(
            by_axis=True)
    if dist.get_rank() == 0:
        torch.save({"out": o.cpu(), "aux": float(aux), "routes": routes},
                   f"{out}.moe_experts")
    del o
    _free(dev)
    if dev.type == "cuda":
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    # (f)-(h): the remaining cases, one step each
    for case in run["cases"]:
        cfg = mesh_config(run, case=case)
        with shardlib.use_rules(mesh, {"batch": batch_axes_for(mesh)}):
            res["linears_" + case] = mesh_linears(cfg, run, dev, tp)
        _free(dev)
        res["train_" + case] = _mesh_train(cfg, run, dev, tp, 1, mesh,
                                           f"{out}.grads_{case}")
        _free(dev)
    # (m): (f)'s config, one step under --pure-dp over the two ranks
    cfg = mesh_config(run, case="f")
    with shardlib.use_rules(mesh, t_train.rules_for(mesh, pure_dp=True)):
        res["linears_m"] = mesh_linears(cfg, run, dev, tp, "pure_dp")
    res["train_m"] = _mesh_train(cfg, run, dev, tp, 1, mesh,
                                 f"{out}.grads_m", zero3="pure_dp")
    _free(dev)
    # (i), (n), (o): the served forward under the mesh
    with shardlib.use_rules(mesh, {"batch": batch_axes_for(mesh)}):
        res["serve"] = {arch: mesh_serve(arch, layers, run, dev,
                                         f"{out}.serve_{arch}")
                        for arch, layers in run["serve"]}
    _free(dev)
    return res


def mesh_serve_config(arch: str, layers: int, run: dict):
    """(i)'s config: ``serve --approx simdive`` (divider-only) at
    ``layers``."""
    from repro_torch.launch import serve

    return replace(serve.serving_config(arch, smoke=run["smoke"],
                                        approx="simdive"), n_layers=layers)


def _decode_cache(lm, cache, B: int, P: int, max_seq: int):
    """A decode cache of ``max_seq`` slots, laid out as ``lm.empty_cache``
    lays it on this rank, holding a prefill's K/V of ``P`` slots: where
    the mesh splits the sequence the prefill's slots are gathered first,
    then this rank's slots of the new layout copied in."""
    import torch
    from repro_torch.launch import sharding as shardlib
    from repro_torch.models.transformer import _seq_split

    new = lm.empty_cache(B, max_seq)
    with torch.no_grad():
        for name in ("k", "v"):
            t = cache[name]
            if _seq_split(lm.cfg, P) is not None:
                t = shardlib.all_gather(t.contiguous(), "kv", 2)
            dst = _seq_split(lm.cfg, max_seq)
            lo = 0 if dst is None else dst[0]
            hi = min(lo + new[name].shape[2], P)
            if hi > lo:
                new[name][:, :, :hi - lo].copy_(t[:, :, lo:hi])
    return new


def mesh_serve(arch: str, layers: int, run: dict, dev, out=None) -> dict:
    """(i) One prefill of (a)'s batch and ``serve_steps`` decode steps of
    ``arch`` at ``layers``, divider-only, from seed 0, then (o)
    ``row_steps`` more with per-row positions (row b at ``b`` slots past
    the step's; a cache deep enough for the last row's): unbound, the
    tokens fed are the run's own greedy picks; bound (a rank), this
    rank's parameters, the tokens the unsplit run fed (read from
    ``run``'s ``serve_ref``), the logits gathered over the vocabulary.
    Returns the logits (on the host), the tokens, the launches of the
    prefill and of the steps, each step's collectives and, for an MoE
    config, every dispatch's routes (:class:`_RecordedRoutes`)."""
    import torch
    from repro_torch.launch import sharding as shardlib
    from repro_torch.launch import train as t_train
    from repro_torch.models import build

    cfg = mesh_serve_config(arch, layers, run)
    lm = build(cfg, dev)
    mesh = shardlib.current_mesh()
    shardings = None if mesh is None else \
        t_train.placement(cfg, mesh)[0]["params"]
    params = lm.init(SEED, shardings)
    B, P = run["batch"], run["seq"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 500)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=dev)
    fed = None
    if mesh is not None:
        fed = torch.load(run["serve_ref"], weights_only=False)[arch][
            "tokens"]

    def whole(lg):
        if lg.shape[-1] < cfg.vocab_size:
            lg = shardlib.all_gather(lg.contiguous(), "vocab", -1)
        return lg.float().cpu()

    routes = _RecordedRoutes() if cfg.n_experts else \
        contextlib.nullcontext()
    with routes:
        res = _mesh_serve_steps(lm, params, prompts, fed, whole, run, dev)
    if cfg.n_experts:
        res["routes"] = [(g.cpu(), k.cpu()) for g, k in routes.calls]
    if out is not None and shardlib.rank_in("heads") == 0:
        torch.save({"prefill": res["prefill"], "steps": res["steps"],
                    "routes": res.get("routes")}, out)
    return res


def _mesh_serve_steps(lm, params, prompts, fed, whole, run, dev) -> dict:
    """:func:`mesh_serve`'s prefill and decode steps."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import sharding as shardlib

    B, P, n = run["batch"], run["seq"], run["serve_steps"]
    reset_launch_counts()
    logits, cache = lm.prefill(params, {"tokens": prompts})
    res = {"prefill": whole(logits), "steps": [], "tokens": []}
    res["prefill_launches"] = {k: v for k, v in launch_counts().items()
                               if v}
    m = run["row_steps"]
    max_seq = P + n + m + B          # the deepest row's last slot inside
    cache = _decode_cache(lm, cache, B, P, max_seq)
    tok = res["prefill"].argmax(-1) if fed is None else fed[0]
    reset_launch_counts()
    res["collectives"] = []
    for i in range(n + m):
        res["tokens"].append(tok)
        # (o): per-row positions, row b at b slots past the step's
        pos = P + i if i < n else \
            P + i + torch.arange(B, device=dev, dtype=torch.int64)
        shardlib.reset_collective_counts()
        lg, cache = lm.decode_step(params, cache, tok.to(dev), pos,
                                   max_seq=max_seq)
        res["collectives"].append(shardlib.collective_counts(by_axis=True))
        res["steps"].append(whole(lg))
        if i + 1 < n + m:
            tok = res["steps"][-1].argmax(-1) if fed is None else fed[i + 1]
    res["step_launches"] = {k: v for k, v in launch_counts().items() if v}
    return res


def mesh_dryrun_witness(run_path: str, out_path: str, archs=(),
                        cells_dir: str | None = None) -> None:
    """(j), in a subprocess: cells (a), (b), (f)-(h), (l) and (m) traced
    by the dry run (``launch/dryrun.py``) as rank 0 of their meshes,
    under the fake process group at world 2 / 3 / 4 — their configs,
    batch, depth and options, no ZeRO-1, as ``launch.train`` runs them
    —; written as JSON. Then (k)'s
    ``train_4k`` single-pod cells of ``archs``, one after the other, into
    ``cells_dir`` (the CLI's records)."""
    from repro_torch.launch import dryrun

    run = json.loads(Path(run_path).read_text())
    tp = run["tp"]
    cells = {"a": (mesh_config(run), (1, tp), {}),
             "b": (mesh_config(run, three=True), (1, 3), {}),
             "l": (mesh_config(run), (1, tp), {"sp": True}),
             "m": (mesh_config(run, case="f"), (1, tp),
                   {"zero3": "pure_dp"}),
             "m4": (mesh_config(run, case="f"), (2, 2), {"zero3": "fsdp"})}
    cells.update({c: (mesh_config(run, case=c), (1, tp), {})
                  for c in run["cases"]})
    out = {}
    for tag, (cfg, shape, kw) in cells.items():
        out[tag] = dryrun.trace_cell(cfg, mesh_shape(run), shape,
                                     ("data", "model"), zero1=False, **kw)
    Path(out_path).write_text(json.dumps(out))
    for arch in archs:
        res = dryrun.run_cell(arch, "train_4k", False, out_dir=cells_dir)
        require(res["status"] == "ok", f"(k) {arch}: {res.get('error')}")


def start_dryruns(run: dict, tmp: Path) -> dict:
    """(j) and (k)'s subprocesses, started together (the host's cores
    trace while the card trains): the witness and one FULL ``train_4k``
    single-pod cell a family (the dry run's records); a thread stamps
    each one's exit."""
    import os
    import threading

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    d = tmp / "dryrun"
    d.mkdir()
    (d / "run.json").write_text(json.dumps(run))
    from repro_torch.configs import get_config

    # the recurrent families' cells trace longest: each its own process;
    # the witness and the other families' cells one after the other in
    # one more, so that few processes share the host with the ranks
    heavy = [a for a in run["dryrun_archs"]
             if get_config(a).family in ("ssm", "hybrid")]
    light = [a for a in run["dryrun_archs"] if a not in heavy]
    cmds = {"j": [sys.executable, "-c", "import chip_smoke; chip_smoke."
                  f"mesh_dryrun_witness({str(d / 'run.json')!r}, "
                  f"{str(d / 'witness.json')!r}, {light!r}, "
                  f"{str(d / 'cells')!r})"]}
    for arch in heavy:
        cmds[arch] = [sys.executable, "-m", "repro_torch.launch.dryrun",
                      "--arch", arch, "--shape", "train_4k", "--mesh",
                      "single", "--out", str(d / "cells")]
    t0 = wall_clock()
    procs, done_at = {}, {}
    for name, cmd in cmds.items():
        with open(d / f"{name}.log", "w") as log_file:
            procs[name] = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                           stdout=log_file,
                                           stderr=subprocess.STDOUT)

    def stamp(name, proc):
        proc.wait()
        done_at[name] = wall_clock() - t0

    for name, proc in procs.items():
        threading.Thread(target=stamp, args=(name, proc),
                         daemon=True).start()
    return {"dir": d, "procs": procs, "done_at": done_at}


def join_dryruns(started: dict) -> dict:
    """Wait for :func:`start_dryruns`' subprocesses (each must exit 0) and
    read their records; the wall time from their start to the last
    exit."""
    d = started["dir"]
    for name, proc in started["procs"].items():
        try:
            proc.wait(timeout=MESH_JOIN_S)
        except subprocess.TimeoutExpired:
            for p in started["procs"].values():
                p.kill()
            raise SmokeFailure(f"phase 18 dry run {name}: still running "
                               f"after {MESH_JOIN_S} s") from None
        require(proc.returncode == 0, f"phase 18 dry run {name} exited "
                f"{proc.returncode}: "
                f"{(d / f'{name}.log').read_text()[-3000:]}")
    deadline = wall_clock() + 10
    while (len(started["done_at"]) < len(started["procs"])
           and wall_clock() < deadline):
        time.sleep(0.05)
    cells = {f.stem: json.loads(f.read_text())
             for f in sorted((d / "cells").glob("*.json"))}
    done_at = dict(started["done_at"])
    return {"witness": json.loads((d / "witness.json").read_text()),
            "cells": cells, "wall_s": max(done_at.values()),
            "done_at_s": done_at}


def _free(dev) -> None:
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _mesh_job_tp3(dev, run, out) -> dict:
    from repro_torch.launch import sharding as shardlib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import batch_axes_for

    cfg = mesh_config(run, three=True)
    mesh = make_host_mesh(model=3)
    res = {"probe": gloo_probe(dev)}
    with shardlib.use_rules(mesh, {"batch": batch_axes_for(mesh)}):
        res["linears"] = mesh_linears(cfg, run, dev, 3)
    res["train"] = _mesh_train(cfg, run, dev, 3, 1, mesh, f"{out}.grads")
    return res


def _mesh_job_dp4(dev, run, out) -> dict:
    """(m) --fsdp: (f)'s config at data 2 x model 2, one step."""
    from repro_torch.launch import sharding as shardlib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import batch_axes_for

    cfg = mesh_config(run, case="f")
    mesh = make_host_mesh(model=2)
    res = {"probe": gloo_probe(dev)}
    with shardlib.use_rules(mesh, {"batch": batch_axes_for(mesh)}):
        res["linears"] = mesh_linears(cfg, run, dev, 2, "fsdp")
    res["train"] = _mesh_train(cfg, run, dev, 2, 1, mesh, f"{out}.grads",
                               zero3="fsdp")
    return res


_MESH_JOBS = {"tp2": _mesh_job_tp2, "tp3": _mesh_job_tp3,
              "dp4": _mesh_job_dp4}


def mesh_compress(run, dev) -> dict:
    """(e) ``compress_psum`` over the model ranks on CUDA tensors against
    the plain computation on the CPU from every rank's inputs."""
    import torch
    from repro_torch.launch import sharding as shardlib
    from repro_torch.optim.grad_compress import compress_psum, quantize_grad

    n, r = shardlib.logical_axis_size("heads"), shardlib.rank_in("heads")

    def draw(i):
        gen = torch.Generator().manual_seed(SEED + 200 + i)
        return (torch.randn(run["compress"], generator=gen),
                torch.randn(run["compress"], generator=gen) * 1e-3)

    g, res = draw(r)
    got, new_res = compress_psum({"g": g.to(dev)}, {"g": res.to(dev)},
                                 "heads")
    qs = [quantize_grad(*draw(i)) for i in range(n)]
    want = sum(q.to(torch.int32) for q, _, _ in qs).to(torch.float32) \
        * max(s for _, s, _ in qs)
    return {"equal": torch_equal(got["g"].cpu(), want)
            and torch_equal(new_res["g"].cpu(), qs[r][2])}


@contextlib.contextmanager
def _recorded_routes(calls: list):
    """Record every ``moe._dispatch`` call's top-k expert indices."""
    from repro_torch.models import moe

    saved = moe._dispatch

    def rec(*args, **kw):
        out = saved(*args, **kw)
        calls.append(out[4].detach().cpu())
        return out

    moe._dispatch = rec
    try:
        yield
    finally:
        moe._dispatch = saved


def mesh_moe_block(run, dev):
    """(c) mixtral-8x7b's MoE block at full width from seed 0: this rank's
    slice of the experts' hidden dim (all of it unbound; (n) under the
    experts override, its experts whole), x (4, 512, 4096) bf16. Returns
    (out, aux, routes)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shardlib
    from repro_torch.models.moe import init_moe, moe_ffn

    cfg = get_config(run["moe_arch"], smoke=run["smoke"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 300)
    p = init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                 cfg.n_shared_experts, torch.float32, dev)
    x = torch.randn(run["moe_x"], generator=gen, device=dev).to(
        torch.bfloat16)
    n, r = shardlib.logical_axis_size("ff"), shardlib.rank_in("ff")
    if n > 1:
        f = cfg.d_ff // n
        p = {"router": p["router"],
             "w1": p["w1"][..., r * f:(r + 1) * f].contiguous(),
             "w3": p["w3"][..., r * f:(r + 1) * f].contiguous(),
             "w2": p["w2"][:, r * f:(r + 1) * f].contiguous()}
    n_e, r_e = shardlib.logical_axis_size("experts"), \
        shardlib.rank_in("experts")
    if n_e > 1:
        # the experts override: this rank's experts, whole
        e = cfg.n_experts // n_e
        p = {"router": p["router"],
             **{k: p[k][r_e * e:(r_e + 1) * e].contiguous()
                for k in ("w1", "w3", "w2")}}
    routes = []
    with torch.no_grad(), _recorded_routes(routes):
        out, aux = moe_ffn(x, p, top_k=cfg.n_experts_active,
                           capacity_factor=cfg.moe_capacity_factor,
                           split=n > 1)
    return out, aux, routes


def _spawn_mesh(job: str, world: int, run: dict, tmp: Path, dev):
    import torch.multiprocessing as mp

    d = tmp / job
    d.mkdir()
    ctx = mp.spawn(_mesh_rank, args=(world, job, run, str(d / "store"),
                                     str(d / "out"), dev.type),
                   nprocs=world, join=False)
    return ctx, d


def _join_mesh(ctx, d: Path, world: int, what: str) -> list:
    import torch

    deadline = wall_clock() + MESH_JOIN_S
    done = False
    while not done:
        try:
            done = ctx.join(timeout=max(deadline - wall_clock(), 1.0))
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as e:
            # a rank raised or exited non-zero
            errs = []
            for r in range(world):
                f = d / f"out.{r}"
                if f.exists():
                    errs.append(torch.load(f, weights_only=False).get(
                        "error", ""))
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise SmokeFailure(f"phase 18 {what}: a rank failed: {e}\n"
                               + "\n".join(errs)) from None
        if not done and wall_clock() > deadline:
            for p in ctx.processes:
                p.kill()
            raise SmokeFailure(f"phase 18 {what}: ranks still running "
                               f"after {MESH_JOIN_S} s")
    res = [torch.load(d / f"out.{r}", weights_only=False)
           for r in range(world)]
    for r in res:
        require(r["ok"], f"phase 18 {what}: {r.get('error')}")
    return res


def _grad_gate(what, loss, grads, loss0, grads0, wit_loss, witnesses,
               data_order: bool = False):
    """The loss within twice the lse witness's distance from the unsplit
    run, and every gradient leaf within twice the larger of the
    witnesses' distances (a leaf both leave equal must be equal).
    ``data_order``: the batch is split over data ranks, whose partial
    sums (the loss's, every gradient's) add in another order: the loss
    may also move by MESH_DATA_LOSS_RTOL of itself and a leaf by
    MESH_DATA_GRAD_ULP of its largest magnitude, the CPU tests'
    tolerances (``tests/test_torch_mesh_cases.py``)."""
    from repro_torch.core.tree import tree_leaves

    rows, worst = [], 0.0
    for g, g0, *ws in zip(tree_leaves(grads), tree_leaves(grads0),
                          *(tree_leaves(w) for w in witnesses)):
        require(all((g is None) == (x is None) for x in (g0, *ws)),
                f"{what}: a gradient leaf None on one side only")
        if g is None:
            continue
        err = float((g.float() - g0.float()).abs().max())
        w_err = [float((w.float() - g0.float()).abs().max()) for w in ws]
        rows.append((err, *w_err))
        top = max(w_err)
        if data_order:
            top = max(top, MESH_DATA_GRAD_ULP / 2
                      * float(g0.float().abs().max()))
        worst = max(worst, err / top if top else (0.0 if err == 0
                                                  else math.inf))
    loss_err, w_loss = abs(loss - loss0), abs(wit_loss - loss0)
    loss_tol = 2 * w_loss
    if data_order:
        loss_tol = max(loss_tol, MESH_DATA_LOSS_RTOL * abs(loss0))
    require(loss_err <= loss_tol, f"{what}: loss {loss!r} vs {loss0!r}, "
            f"witness {wit_loss!r}")
    require(worst <= 2.0, f"{what}: a gradient leaf past twice its "
            f"witness ({worst:.3g}x): (err, lse witness, order witness) "
            f"{rows}")
    return {"loss_err": loss_err, "witness_loss_err": w_loss,
            "grad_err_over_witness_max": worst,
            "grad_errs": [r[0] for r in rows],
            "witness_grad_errs": [r[1:] for r in rows]}


def _unsplit_runs(cfg, run, dev, steps) -> dict:
    """The tp-1 train runs in this process, each recording its first
    step's gradients: as it is, under the lse witness (every step, for
    the losses' gate), and the first step under the float-order
    witness."""
    out = {}
    for tag, ctx, n in (("", contextlib.nullcontext(), steps),
                        ("witness_", ulp_nudged_lse(), steps),
                        ("order_", head_gradient_in_f32(), 1)):
        with ctx:
            r = _mesh_train(cfg, run, dev, 1, n)
        out[tag + "first"] = (r["losses"][0], r["grads"])
        out[tag + "losses"], out[tag + "step_s"] = r["losses"], r["step_s"]
    return out


def mesh_nccl_world1(run, dev, backends=("nccl", "gloo")) -> dict:
    """(d) One step of (a)'s model under a bound (1, 1) mesh over a
    world-1 NCCL group, ``torch.equal`` (loss and every parameter) to the
    same step over a world-1 gloo group; an explicit ``all_reduce`` SUM /
    MAX and ``broadcast`` on the NCCL group (identities at world 1: the
    port's helpers skip one-rank groups)."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.core.tree import tree_map
    from repro_torch.data import make_source, torch_batch
    from repro_torch.launch import sharding as shardlib
    from repro_torch.launch import train as t_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import batch_axes_for
    from repro_torch.models import build
    from repro_torch.optim import adamw, cosine_schedule

    cfg = mesh_config(run)
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, backend in enumerate(backends):
            dist.init_process_group(
                backend, init_method=f"file://{tmp}/{i}", rank=0,
                world_size=1, timeout=datetime.timedelta(seconds=300))
            try:
                t = torch.arange(8.0, device=dev)
                dist.all_reduce(t)
                dist.all_reduce(t, op=dist.ReduceOp.MAX)
                dist.broadcast(t, src=0)
                require(torch.equal(t, torch.arange(8.0, device=dev)),
                        f"{backend} world 1: a collective moved a value")
                mesh = make_host_mesh(model=1)
                with shardlib.use_rules(mesh,
                                        {"batch": batch_axes_for(mesh)}):
                    shardings, split = t_train.placement(cfg, mesh)
                    lm = build(cfg, dev)
                    params = lm.init(SEED, shardings["params"])
                    opt = adamw(cosine_schedule(TRAIN_LR, warmup=1,
                                                total=run["steps"]))
                    batch = torch_batch(make_source(
                        cfg, mesh_shape(run), seed=SEED).batch(0), dev)
                    step = t_train.make_train_step(lm, opt, split=split)
                    p2, _, m = step(params, opt.init(params), batch)
                    got[i] = (m["loss"].cpu(),
                                    tree_map(lambda t: t.cpu(), p2))
                    del params, p2
            finally:
                dist.destroy_process_group()
    eq, worst, bad = _tree_equal(got[0][1], got[1][1])
    require(torch_equal(got[0][0], got[1][0]) and eq,
            f"(d) the NCCL step differs from the gloo one: {bad} ({worst})")
    return {"loss": float(got[0][0]), "params_equal": eq}


def mesh_kernel_rows(dev, int_rate) -> list:
    """``logmatmul`` at tp 2's shard shapes (M = 4 x 512 tokens): (a)'s
    (the column-parallel wq / wk / wv and w1 / w3, the row-parallel wo and
    w2), (g)'s rwkv6-1.6b (the column-parallel r / k / v / g, cm_wk,
    cm_wr and cm_wv, the row-parallel wo) and (h)'s zamba2-2.7b Mamba2
    layer (the column-parallel wz / wx and wdt, the row-parallel
    out_proj); under ``--sp`` (l) the column-parallel products run on the
    gathered sequence and the row-parallel ones before their
    reduce-scatter, (a)'s shapes; (m)'s smollm-360m under ``--pure-dp``
    (this rank's 2 x 512 rows, every weight whole) and ``--fsdp`` (the
    same rows, tp 2's columns and rows): by graph replay, the time of the
    block the ranks launch (the autotune off: the registry's untimed
    default for M, ``logmatmul.default_block``), the fastest registered
    block's beside it and the skinny default's, the operations bound, and
    the exact bf16 ``torch.matmul`` of the same shape."""
    import torch
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import get_op
    from repro_torch.kernels import logmatmul as lm

    cfg = mesh_config(MESH_RUN)
    D, F, HD = cfg.d_model, cfg.d_ff // MESH_TP, \
        cfg.n_heads * cfg.d_head // MESH_TP
    rw = mesh_config(MESH_RUN, case="g")
    zb = mesh_config(MESH_RUN, case="h")
    RD, RF = rw.d_model, rw.d_ff
    ZD, ZI = zb.d_model, 2 * zb.d_model
    ZH = ZI // zb.ssm_head_dim
    sm = mesh_config(MESH_RUN, case="f")
    SD, SF = sm.d_model, sm.d_ff
    SQ, SK = sm.n_heads * sm.d_head, sm.n_kv_heads * sm.d_head
    half = MESH_BATCH * MESH_SEQ // 2
    spec = SimdiveSpec(width=8, coeff_bits=6)
    gen = torch.Generator(device=dev).manual_seed(SEED + 400)
    rows = []
    for names, K, N, *m in (
            (("wq", "wk", "wv"), D, HD), (("w1", "w3"), D, F),
            (("wo",), HD, D), (("w2",), F, D),
            (("rwkv6 wr", "wk", "wv", "wg", "cm_wr"), RD, RD // MESH_TP),
            (("rwkv6 cm_wk",), RD, RF // MESH_TP),
            (("rwkv6 cm_wv",), RF, RD // MESH_TP),
            (("rwkv6 wo",), RD // MESH_TP, RD),
            (("zamba2 wz", "wx"), ZD, ZI // MESH_TP),
            (("zamba2 wdt",), ZD, ZH // MESH_TP),
            (("zamba2 out_proj",), ZI // MESH_TP, ZD),
            (("pure-dp smollm wq", "wo"), SD, SQ, half),
            (("pure-dp smollm wk", "wv"), SD, SK, half),
            (("pure-dp smollm w1", "w3"), SD, SF, half),
            (("pure-dp smollm w2",), SF, SD, half),
            (("fsdp smollm wq",), SD, SQ // 2, half),
            (("fsdp smollm wk", "wv"), SD, SK // 2, half),
            (("fsdp smollm wo",), SQ // 2, SD, half),
            (("fsdp smollm w1", "w3"), SD, SF // 2, half),
            (("fsdp smollm w2",), SF // 2, SD, half)):
        M = m[0] if m else MESH_BATCH * MESH_SEQ
        x = torch.randint(-255, 256, (M, K), generator=gen, device=dev,
                          dtype=torch.int32)
        w = torch.randint(-255, 256, (K, N), generator=gen, device=dev,
                          dtype=torch.int32)
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        by_block = {b: gpu_graph_time_ms(
            lambda b=b: lm.logmatmul_cuda(x, w, spec, b), iters=3)
            for b in get_op("matmul_int", spec).entry.block_candidates}
        best = min(by_block, key=by_block.get)
        ran = lm.default_block(M)
        rows.append({
            "linears": names, "M": M, "K": K, "N": N,
            "block": list(ran), "ms": by_block[ran],
            "fastest_block": list(best), "fastest_ms": by_block[best],
            "skinny_ms": by_block[lm.DEFAULT_BLOCK],
            "bound_ms": logmatmul_ops_ms(M, K, N, int_rate),
            "bound_by": "operations",
            "library_ms": gpu_graph_time_ms(lambda: xb @ wb, iters=20)})
    return rows


def mesh_phase(dev, int_rate, run=None) -> dict:
    """Phase 18: the mesh, (a) to (k) as the module docstring says.
    ``run``: :data:`MESH_RUN` unless a rehearsal gives smaller values (on
    the CPU the NCCL step (d) and the kernel times are left out). The dry
    run's subprocesses are ended whatever happens."""
    import os
    import tempfile

    import torch

    run = run or MESH_RUN
    cuda = dev.type == "cuda"
    if cuda:
        from repro_torch.kernels import build
        from repro_torch.launch.train import deterministic

        _drop_served_graphs()
        require(build.load(dev) is not None, "the kernels' library")
        deterministic()
    _free(dev)
    saved_autotune = os.environ.get("SIMDIVE_AUTOTUNE")
    os.environ["SIMDIVE_AUTOTUNE"] = "0"     # as in the ranks
    out, dry = {}, None
    try:
        with tempfile.TemporaryDirectory() as tmp_name:
            tmp = Path(tmp_name)
            # (j), (k): the dry run's subprocesses, on the host's cores
            # while the card trains
            dry = start_dryruns(run, tmp)
            # (a), (c), (e), (f)-(i): the unsplit runs here, then two ranks
            # (one after the other, so that each step time has the card
            # alone)
            t0 = wall_clock()
            unsplit = _unsplit_runs(mesh_config(run), run, dev,
                                    run["steps"])
            _free(dev)
            with torch.no_grad():
                moe_out0, moe_aux0, routes0 = mesh_moe_block(run, dev)
            moe_out0 = moe_out0.cpu()
            _free(dev)
            cases0 = {}
            for case in run["cases"]:
                cases0[case] = _unsplit_runs(mesh_config(run, case=case),
                                             run, dev, 1)
                _free(dev)
            serve0 = {arch: mesh_serve(arch, layers, run, dev)
                      for arch, layers in run["serve"]}
            torch.save({a: {"tokens": r["tokens"]} for a, r in serve0.items()},
                       tmp / "serve_ref.pt")
            run = dict(run, serve_ref=str(tmp / "serve_ref.pt"))
            _free(dev)
            ctx, d = _spawn_mesh("tp2", run["tp"], run, tmp, dev)
            ranks = _join_mesh(ctx, d, run["tp"], "(a) tp 2")
            out["a"] = mesh_judge("(a)", ranks, unsplit, d)
            out["c"] = mesh_judge_moe(d, moe_out0, moe_aux0, routes0)
            require(all(r["compress"]["equal"] for r in ranks),
                    "(e) compress_psum on the card differs from the plain "
                    "computation")
            out["e"] = ranks[0]["compress"]
            log("  (e) compress_psum over 2 ranks on CUDA tensors == the "
                "plain computation on the CPU")
            for case in run["cases"]:
                cfg = mesh_config(run, case=case)
                out[case] = mesh_judge(
                    f"({case}) {cfg.name} {cfg.n_layers} layers", ranks,
                    cases0[case], d, tag="_" + case,
                    attention=cfg.family != "ssm")
            out["l"] = mesh_judge("(l) --sp", ranks, unsplit, d, tag="_l")
            out["m"] = mesh_judge("(m) --pure-dp", ranks, cases0["f"], d,
                                  tag="_m", data_order=True)
            out["n"] = mesh_judge_experts(ranks, d, moe_out0)
            out["i"] = mesh_judge_serve(ranks, serve0, d, run)
            out["a_s"] = wall_clock() - t0
            del unsplit, moe_out0, serve0
            _free(dev)
            # (b): three ranks, and (m)'s --fsdp over four beside them
            t0 = wall_clock()
            unsplit3 = _unsplit_runs(mesh_config(run, three=True), run, dev,
                                     1)
            _free(dev)
            ctx, d = _spawn_mesh("tp3", 3, run, tmp, dev)
            ctx4, d4 = _spawn_mesh("dp4", MESH_FSDP_WORLD, run, tmp, dev)
            ranks3 = _join_mesh(ctx, d, 3, "(b) tp 3")
            ranks4 = _join_mesh(ctx4, d4, MESH_FSDP_WORLD, "(m) --fsdp")
            out["b"] = mesh_judge("(b)", ranks3, unsplit3, d)
            out["m4"] = mesh_judge("(m) --fsdp", ranks4, cases0["f"], d4,
                                   data_order=True)
            out["b_s"] = wall_clock() - t0
            del unsplit3, cases0
            _free(dev)
            # (j), (k): the dry run against what the ranks measured
            t0 = wall_clock()
            dry = join_dryruns(dry)
            trains = {"a": [r["train"] for r in ranks],
                      "b": [r["train"] for r in ranks3],
                      "l": [r["train_l"] for r in ranks],
                      "m": [r["train_m"] for r in ranks],
                      "m4": [r["train"] for r in ranks4]}
            trains.update({c: [r["train_" + c] for r in ranks]
                           for c in run["cases"]})
            out["j"] = mesh_judge_dryrun(dry["witness"], trains)
            out["k"] = mesh_judge_cells(dry, run)
            out["jk_wait_s"] = wall_clock() - t0
        if cuda:
            t0 = wall_clock()
            out["d"] = mesh_nccl_world1(run, dev)
            out["d_s"] = wall_clock() - t0
            log(f"  (d) a world-1 NCCL group: one step under a bound (1, 1) "
                f"mesh == the gloo one (loss {out['d']['loss']!r})")
            out["kernels"] = mesh_kernel_rows(dev, int_rate)
    finally:
        for proc in (dry or {}).get("procs", {}).values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if cuda:
            torch.use_deterministic_algorithms(False)
        if saved_autotune is None:
            os.environ.pop("SIMDIVE_AUTOTUNE", None)
        else:
            os.environ["SIMDIVE_AUTOTUNE"] = saved_autotune
    _free(dev)
    return out


def mesh_judge_moe(d: Path, out0, aux0, routes0) -> dict:
    """(c)'s gates: the ranks' SPMD block against the unsplit one."""
    import torch

    moe = torch.load(d / "out.moe", weights_only=False)
    tol = MESH_MOE_ULPS * 2.0 ** -8 * float(out0.abs().max())
    err = float((moe["out"].float() - out0.float()).abs().max())
    routes_eq = len(moe["routes"]) == len(routes0) and all(
        torch.equal(a, b) for a, b in zip(moe["routes"], routes0))
    res = {"routes_equal": routes_eq, "out_err": err, "out_tol": tol,
           "aux": moe["aux"], "aux_unsplit": float(aux0)}
    log(f"  (c) the MoE block, SPMD over 2 ranks: routes equal {routes_eq}, "
        f"output {err:.4g} from the unsplit block (bound {tol:.4g}), aux "
        f"{moe['aux']!r} / {float(aux0)!r}")
    require(routes_eq and err <= tol
            and abs(moe["aux"] - float(aux0)) <= 1e-6,
            f"(c) the SPMD MoE block: {res}")
    return res


def mesh_judge_experts(ranks, d: Path, out0) -> dict:
    """(n)'s gate on the MoE block: under the experts override (each rank
    its experts whole, the slot-space outputs gathered before the
    combine) the output ``torch.equal`` to the unsplit block's, with one
    ``all_gather`` over the model ranks on every rank."""
    import torch

    got = torch.load(d / "out.moe_experts", weights_only=False)
    eq = torch_equal(got["out"], out0)
    err = float((got["out"].float() - out0.float()).abs().max())
    colls = [r["moe_experts_collectives"] for r in ranks]
    res = {"equal": eq, "max_abs_err": err, "collectives": colls[0]}
    log(f"  (n) the MoE block under the experts override over 2 ranks: "
        f"torch.equal to the unsplit block {eq} (max |err| {err:.3g}); "
        f"collectives {colls}")
    require(eq, f"(n) the experts override's output differs from the "
            f"unsplit block's by {err:.3g}")
    require(all(c.get("all_gather@model", [0])[0] == 1 for c in colls),
            f"(n) collectives {colls}")
    return res


def mesh_judge(what, ranks, unsplit, d: Path, tag: str = "",
               attention: bool = True, data_order: bool = False) -> dict:
    """(a), (b), (f)-(h)'s gates over the ranks' results (``tag`` names
    the case's keys) and the unsplit runs; ``attention``: the model has a
    softmax, whose finalize launches ``elemwise``; ``data_order``: the
    batch is split over data ranks (:func:`_grad_gate`)."""
    import torch

    for r in ranks:
        probe = r["probe"]
        require(all(v is True for v in probe.values()),
                f"{what} gloo on CUDA tensors: {probe}")
        for name, row in r["linears" + tag].items():
            require(all(row["equal"]), f"{what} the {row['split']} SIMDive "
                    f"linear {name} differs from the unsplit one "
                    f"(forward, gx, gw): {row['equal']}")
    gathered = torch.load(d / f"out.grads{tag}", weights_only=False)
    loss0, grads0 = unsplit["first"]
    w_loss, w_grads = unsplit["witness_first"]
    gate = _grad_gate(f"{what} first step", gathered["loss"],
                      gathered["grads"], loss0, grads0, w_loss,
                      (w_grads, unsplit["order_first"][1]), data_order)
    trains = [r["train" + tag] for r in ranks]
    require(all(t["losses"] == trains[0]["losses"] for t in trains),
            f"{what} the ranks' losses differ")
    for i, (l, l0, lw) in enumerate(zip(trains[0]["losses"],
                                        unsplit["losses"],
                                        unsplit["witness_losses"])):
        tol = 2 * abs(lw - l0)
        if data_order:
            tol = max(tol, MESH_DATA_LOSS_RTOL * abs(l0))
        require(abs(l - l0) <= tol,
                f"{what} step {i}: loss {l!r} vs {l0!r} (witness {lw!r})")
    per_rank = [t["launches_a_step"] for t in trains]
    for r, counts in enumerate(per_rank):
        mm = counts.get("matmul", 0) + counts.get("matmul_pipelined", 0)
        require(mm > 0 and (counts.get("elemwise", 0) > 0) == attention,
                f"{what} rank {r}'s launches a step: {counts}")
    res = {"probe": ranks[0]["probe"],
           "linears": {k: v["split"]
                       for k, v in ranks[0]["linears" + tag].items()},
           "losses": trains[0]["losses"], "losses_unsplit": unsplit["losses"],
           "losses_witness": unsplit["witness_losses"],
           "step_s": trains[0]["step_s"],
           "step_s_unsplit": unsplit["step_s"],
           "launches_by_rank": [t["launches"] for t in trains],
           "launches_a_rank_a_step": per_rank,
           "collectives_a_rank_a_step": [t["collectives_a_step"]
                                         for t in trains],
           "peak_bytes": ranks[0].get("peak_bytes"),
           "peak_bytes_run": trains[0].get("peak_bytes_run"), **gate}
    each = "; ".join(
        f"rank {r} {c.get('matmul', 0) + c.get('matmul_pipelined', 0):g} "
        f"logmatmul, {c.get('elemwise', 0):g} elemwise, "
        f"{res['collectives_a_rank_a_step'][r]}"
        for r, c in enumerate(per_rank))
    log(f"  {what} {len(ranks)} ranks: every SIMDive linear of layer 0 "
        f"bit-equal ({res['linears']}); losses {res['losses']} vs tp 1 "
        f"{res['losses_unsplit']} (witness {res['losses_witness']}); first "
        f"step's gradients at most {gate['grad_err_over_witness_max']:.3g}x "
        f"the witness; a step: {each}; step s {res['step_s']} "
        f"(tp 1 {res['step_s_unsplit']}; the ranks share one card: this "
        "measures nothing about scaling)")
    return res


def mesh_judge_serve(ranks, serve0, d: Path, run: dict) -> dict:
    """(i)'s gates: each rank's gathered logits within LOGIT_ULPS bf16
    ulps of the unsplit run's largest logit, at the prefill and every
    decode step; on every rank one ``flash_attention`` a layer a prefill,
    and a step one ``decode_attention`` a layer where the cache is split
    by kv head, one ``elemwise`` (the divider after the ranks' partial
    sums) a layer where it is split by sequence."""
    import torch

    out = {}
    for arch, layers in run["serve"]:
        ref = serve0[arch]
        got = torch.load(d / f"out.serve_{arch}", weights_only=False)
        ref_all = torch.stack([ref["prefill"], *ref["steps"]])
        tol, top = ulp_logit_tol(f"(i) {arch}", ref_all, MESH_SERVE_LOGITS)
        errs = [float((g - w).abs().max()) for g, w in
                zip([got["prefill"], *got["steps"]],
                    [ref["prefill"], *ref["steps"]])]
        cfg = mesh_serve_config(arch, layers, run)
        routed = None
        if cfg.n_experts:
            # (n): a route that flips between the split and the unsplit
            # run (a near tie in the router) moves its row's logits past
            # any ulp bound: phase 11's routing-aware gate
            got_all = torch.stack([got["prefill"], *got["steps"]])
            routed = judge_routed_logits(
                f"(n) {arch} at tp {run['tp']}", layers, got["routes"],
                ref["routes"], got_all.transpose(0, 1),
                got_all.argmax(-1).transpose(0, 1),
                ref_all.transpose(0, 1), tol, against="the unsplit run")
        else:
            require(max(errs) <= tol, f"(i) {arch}: gathered logits "
                    f"{errs} past {tol:g} of the unsplit run's")
        by_heads = cfg.n_kv_heads % run["tp"] == 0
        steps = run["serve_steps"] + run["row_steps"]
        if cfg.n_experts:
            # each layer's MoE sums its split experts, beside wo's sum and
            # the vocabulary-parallel embedding's
            for r, rank in enumerate(ranks):
                sums = [c.get("all_reduce@model", [0])[0]
                        for c in rank["serve"][arch]["collectives"]]
                require(sums == [2 * layers + 1] * steps,
                        f"(n) {arch} rank {r}: all_reduce calls a step "
                        f"{sums}")
        for r, rank in enumerate(ranks):
            pre = rank["serve"][arch]["prefill_launches"]
            step = rank["serve"][arch]["step_launches"]
            att = pre.get("attention", 0) + pre.get("attention_pipelined", 0)
            require(att == layers, f"(i) {arch} rank {r}: prefill "
                    f"launches {pre}")
            if by_heads:
                require(step.get("decode_attention", 0) == layers * steps,
                        f"(i) {arch} rank {r}: step launches {step}")
            else:
                require(step.get("elemwise", 0) == layers * steps
                        and "decode_attention" not in step,
                        f"(i) {arch} rank {r}: step launches {step}")
        out[arch] = {"logit_errs": errs, "tol": tol, "top": top,
                     "cache": "kv heads" if by_heads else "sequence",
                     "step_collectives": ranks[0]["serve"][arch][
                         "collectives"][0], "routed": routed,
                     "launches_by_rank": [
                         {"prefill": rank["serve"][arch]["prefill_launches"],
                          "steps": rank["serve"][arch]["step_launches"]}
                         for rank in ranks]}
        log(f"  (i) {arch} {layers} layers at tp {run['tp']}: prefill and "
            f"{run['serve_steps']} steps and (o) {run['row_steps']} with "
            f"per-row positions within {max(errs):.4g} of the unsplit logits "
            f"(bound {tol:g}); cache split by {out[arch]['cache']}; "
            f"launches {out[arch]['launches_by_rank'][0]}")
    return out


def mesh_judge_dryrun(witness: dict, trains: dict) -> dict:
    """(j)'s gates: each traced cell's collectives (calls and bytes by
    kind and mesh axes) equal to a step's on every rank; its parameter and
    optimizer bytes equal to rank 0's leaves; (a)'s peak within
    MESH_PEAK_TOL of rank 0's ``max_memory_allocated`` over its run."""
    out = {}
    for tag, rec in witness.items():
        per = rec["per_device"]
        want = {k: [float(c), float(b)] for k, (c, b)
                in per["collectives"].items()}
        for r, t in enumerate(trains[tag]):
            got = {k: [float(c), float(b)] for k, (c, b)
                   in t["collectives_by_axis_a_step"].items()}
            require(got == want, f"(j) cell {tag} rank {r}: measured "
                    f"collectives a step {got}, the dry run's {want}")
        state = trains[tag][0]["state_bytes"]
        parts = per["argument_parts"]
        require(state == {"params": parts["params"],
                          "optimizer": parts["optimizer"]},
                f"(j) cell {tag}: rank 0's leaves {state}, the dry run's "
                f"{parts}")
        out[tag] = {"collectives": want, "state_bytes": state,
                    "peak_bytes": per["peak_bytes"],
                    "trace_s": rec["trace_seconds"]}
    peak = trains["a"][0].get("peak_bytes_run")
    if peak:
        dry = witness["a"]["per_device"]["peak_bytes"]
        out["a"]["measured_peak_bytes"] = peak
        out["a"]["peak_ratio"] = dry / peak
        require(abs(dry - peak) <= MESH_PEAK_TOL * peak,
                f"(j) (a)'s dry-run peak {dry / 1e9:.3f} GB against rank "
                f"0's {peak / 1e9:.3f} GB")
    log(f"  (j) the dry run at world 2 / 3 / 4: collectives and state bytes "
        f"== the ranks' for cells {sorted(witness)}; (a)'s peak "
        f"{witness['a']['per_device']['peak_bytes'] / 1e9:.3f} GB traced, "
        f"{(peak or 0) / 1e9:.3f} GB measured")
    return out


def mesh_judge_cells(dry: dict, run: dict) -> dict:
    """(k)'s gates: every family's FULL train_4k single-pod cell ``ok``."""
    out = {}
    for arch in run["dryrun_archs"]:
        rec = dry["cells"].get(f"{arch}__train_4k__singlepod")
        require(rec is not None and rec.get("status") == "ok",
                f"(k) {arch} train_4k: {rec and rec.get('error')}")
        out[arch] = {"peak_gb": rec["per_device"]["peak_bytes"] / 1e9,
                     "bottleneck": rec["roofline"]["bottleneck"],
                     "trace_s": rec["trace_seconds"]}
    log(f"  (k) train_4k single-pod, rank 0 of 256: {out}; the dry run's "
        f"subprocesses took {dry['wall_s']:.1f} s (budget "
        f"{MESH_DRYRUN_BUDGET_S} s): {dry['done_at_s']}")
    return {"cells": out, "wall_s": dry["wall_s"],
            "done_at_s": dry["done_at_s"]}


# ----------------------------------------- phase 19: the static analyzer --
#: the gate's own time limit on the card machine's host, seconds
GATE_TIMEOUT_S = 600
#: lane words of phase 19 (b)'s packed corners: all ones, alternating
#: bits, alternating lanes at widths 8 and 16, and their complements
PACKED_CORNER_WORDS = (0xFFFFFFFF, 0xAAAAAAAA, 0x55555555, 0xFF00FF00,
                       0x00FF00FF, 0xFFFF0000, 0x0000FFFF, 0x80808080,
                       0x7F7F7F7F, 0x80008000, 0x7FFF7FFF)


def corner_values(lo, hi) -> list:
    """An analyzer operand's corners: ``lo``, ``hi`` and every 2^j - 1,
    2^j and 2^j + 1 inside ``[lo, hi]`` (negated too, where the interval
    reaches below zero)."""
    vals = {lo, hi}
    top = max(abs(lo), abs(hi))
    j = 0
    while (1 << j) - 1 <= top:
        for v in ((1 << j) - 1, 1 << j, (1 << j) + 1):
            for sv in (v, -v):
                if lo <= sv <= hi:
                    vals.add(sv)
        j += 1
    return sorted(vals)


def start_analysis_gate() -> SimpleNamespace:
    """Phase 19 (a), started right after the build: ``python -m
    repro_torch.analysis --gate --json`` as a subprocess on this
    machine's host and torch build, on one CPU thread beside the card's
    phases (the analyzer is host-only work, about 40 s here). Stopped at
    exit, whatever happens in between."""
    import atexit
    import os
    import shutil
    import tempfile

    from repro_torch.metrics.timing import epoch_time

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_gate_"))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--gate", "--json",
         "--out", str(tmp / "gate.json")], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(stop)
    return SimpleNamespace(proc=proc, tmp=tmp, started=epoch_time(),
                           t0=wall_clock())


def analysis_gate(gate: SimpleNamespace) -> dict:
    """Phase 19 (a)'s verdict: exit 0, every case proved, no coverage gap,
    the lint clean; its case count and its own seconds (start to the
    report's write)."""
    import shutil

    left = GATE_TIMEOUT_S - (wall_clock() - gate.t0)
    try:
        _, err = gate.proc.communicate(timeout=max(left, 1.0))
    except subprocess.TimeoutExpired:
        gate.proc.kill()
        gate.proc.wait()
        raise SmokeFailure(f"phase 19 (a): the gate ran over "
                           f"{GATE_TIMEOUT_S} s") from None
    require(gate.proc.returncode == 0,
            f"phase 19 (a): the gate exited {gate.proc.returncode}: "
            f"{err[-3000:]}")
    report = gate.tmp / "gate.json"
    seconds = report.stat().st_mtime - gate.started
    rep = json.loads(report.read_text())
    shutil.rmtree(gate.tmp, ignore_errors=True)
    unsafe = [c["label"] for c in rep["cases"] if not c["ok"]]
    require(bool(rep["cases"]) and not unsafe,
            f"phase 19 (a): unsafe cases {unsafe}")
    require(not rep["coverage_gaps"],
            f"phase 19 (a): coverage gaps {rep['coverage_gaps']}")
    require(not rep["lint"], f"phase 19 (a): lint {rep['lint']}")
    widened = sorted({u for c in rep["cases"]
                      for u in c["unknown_primitives"]})
    log(f"  (a) gate: {len(rep['cases'])} cases proved, "
        f"{len(rep['skips'])} declared skips, no gap, lint clean, "
        f"{seconds:.1f}s on the host beside phases 3 on (ops widened: "
        f"{widened or 'none'})")
    return {"cases": len(rep["cases"]), "skips": len(rep["skips"]),
            "seconds": seconds, "widened": widened}


def _pairs(vals_a, vals_b, dev, dtype):
    """Every (a, b) of two corner lists as two flat tensors."""
    import torch

    a = torch.tensor(vals_a, dtype=dtype, device=dev)
    b = torch.tensor(vals_b, dtype=dtype, device=dev)
    return (a[:, None].expand(len(vals_a), len(vals_b)).reshape(-1),
            b[None, :].expand(len(vals_a), len(vals_b)).reshape(-1))


def analysis_corners(dev) -> dict:
    """Phase 19 (b): each proved case of an op with a CUDA kernel, run
    disarmed at its operands' corners through the kernel and its plain
    version, ``torch.equal``: elemwise and sqrt at every lane corner
    pair, packed on corner words, matmul_int w8 at K 32 / 128 / 512 with
    every operand +-255 (the int32 accumulator's worst case the analyzer
    proves fits), and the attention finalize alone (``softmax_div_cuda``)
    on corner rows."""
    import torch
    from repro_torch.core.error_lut import table_for
    from repro_torch.core.mitchell import from_lanes, to_lanes
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import elemwise as ew
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import logmatmul as lm
    from repro_torch.kernels import packed_simd as ps
    from repro_torch.kernels import registry

    def same(name, got, want):
        torch.cuda.synchronize()
        got, want = from_lanes(got) if not got.is_floating_point() else got, \
            from_lanes(want) if not want.is_floating_point() else want
        nbad = int((got != want).sum())
        require(got.shape == want.shape and nbad == 0,
                f"phase 19 (b) {name}: {nbad} of {want.numel()} elements "
                "differ from the plain version")

    runs, elements = 0, 0
    ops = {impl.name: impl for impl in registry.all_ops()}
    for w in (8, 16, 32):
        for case in ops["elemwise"].analysis(w) + ops["sqrt"].analysis(w):
            pr = case.params
            lane = case.args[0]
            corners = corner_values(int(lane.lo), int(lane.hi))
            if case.label.startswith("sqrt"):
                spec = SimdiveSpec(width=w)
                a = to_lanes(torch.tensor(corners, dtype=torch.int64,
                                          device=dev), w)
                same(case.label, ew.sqrt_cuda(a, spec, pr["frac_out"]),
                     ew.sqrt_ref(a, spec, pr["frac_out"]))
                runs, elements = runs + 1, elements + a.numel()
                continue
            spec = SimdiveSpec(width=w, coeff_bits=pr["coeff_bits"])
            a, b = _pairs(corners, corners, dev, torch.int64)
            mode = None
            if pr["op"] == "mixed":
                a, b = a.repeat(2), b.repeat(2)
                mode = torch.arange(a.numel(), device=dev) // (
                    a.numel() // 2)
                mode = to_lanes(mode, w)
            a, b = to_lanes(a, w), to_lanes(b, w)
            kw = dict(op=pr["op"], mode=mode, frac_out=pr["frac_out"])
            same(case.label, ew.elemwise_cuda(a, b, spec, **kw),
                 ew.elemwise_ref(a, b, spec, **kw))
            runs, elements = runs + 1, elements + a.numel()
    for w in (8, 16):
        for case in ops["packed"].analysis(w):
            pr = case.params
            spec = SimdiveSpec(width=w, coeff_bits=pr["coeff_bits"])
            word = case.args[0]
            words = sorted(set(PACKED_CORNER_WORDS) | {
                v for v in corner_values(int(word.lo), int(word.hi))})
            a, b = _pairs(words, words, dev, torch.int64)
            mode = to_lanes(b.flip(0), 16) if pr["op"] == "mixed" else None
            a, b = to_lanes(a, 16), to_lanes(b, 16)
            kw = dict(op=pr["op"], mode=mode, frac_out=pr["frac_out"])
            same(case.label, ps.packed_cuda(a, b, spec, **kw),
                 ps.packed_ref(a, b, spec, **kw))
            runs, elements = runs + 1, elements + a.numel()
    for case in ops["matmul_int"].analysis(8):
        pr = case.params
        spec = SimdiveSpec(width=8, coeff_bits=pr["coeff_bits"])
        K, N = pr["K"], case.args[1].shape[1]
        lane = int(case.args[0].hi)
        signs = torch.ones(8, K, dtype=torch.int32, device=dev)
        signs[1] = -1                                  # all negative
        signs[2, ::2] = -1                             # alternating
        signs[3, : K // 2] = -1                        # half and half
        x = signs * lane
        wt = torch.full((K, N), lane, dtype=torch.int32, device=dev)
        wt[:, 1::2] = -lane
        got = lm.logmatmul_cuda(x, wt, spec)
        want = lm.logmatmul_ref(x, wt, spec)
        same(case.label, got, want)
        require(int(want.abs().max()) == K * int(
            lm.logmatmul_ref(x[:1, :1], wt[:1, :1], spec).abs().max()),
            f"phase 19 (b) {case.label}: the worst-case sum is not K "
            "times the largest product")
        runs, elements = runs + 1, elements + got.numel()
    for w in (8, 16, 32):
        for case in ops["attention"].analysis(w):
            pr = case.params
            spec = SimdiveSpec(width=w, coeff_bits=pr["coeff_bits"])
            acc_c = [float(v) for v in corner_values(
                int(case.args[0].lo), int(case.args[0].hi))]
            l_c = [float(v) for v in corner_values(
                int(case.args[1].lo), int(case.args[1].hi))]
            dh = case.args[0].shape[-1]
            rows = len(l_c)
            acc = torch.tensor(acc_c, device=dev).repeat(
                rows * dh // len(acc_c) + 1)[: rows * dh].reshape(rows, dh)
            acc = acc.roll(1, 0) * torch.where(
                torch.arange(rows, device=dev) % 2 == 0, 1.0, -1.0)[:, None]
            l = torch.tensor(l_c, device=dev)
            tab = table_for("div", w, spec.coeff_bits, spec.index_bits,
                            device=dev)
            out, quot = fa.softmax_div_cuda(acc, l, spec=spec,
                                            frac_out=pr["frac_out"])
            fkw = dict(width=w, index_bits=spec.index_bits,
                       frac_out=pr["frac_out"], round_out=spec.round_output)
            same(case.label + " out", out.view(torch.int32),
                 fa.softmax_div(acc, l, tab, **fkw).view(torch.int32))
            same(case.label + " lanes", quot,
                 fa.softmax_div_lanes(acc, l, tab, **fkw))
            runs, elements = runs + 1, elements + acc.numel()
    log(f"  (b) corners: {runs} proved cases through elemwise, sqrt, "
        f"packed, logmatmul and softmax_div_cuda, {elements} elements, "
        "each torch.equal to its plain version")
    return {"corner_runs": runs, "corner_elements": elements}


def analysis_phase(dev, gate: SimpleNamespace) -> dict:
    """Phase 19: the static analyzer — (a) its gate on this machine's
    host (started by :func:`start_analysis_gate`), (b) its proved cases'
    corners through the kernels."""
    t0 = wall_clock()
    gate = analysis_gate(gate)
    gate["wait_seconds"] = wall_clock() - t0
    t0 = wall_clock()
    corners = analysis_corners(dev)
    return {"gate": gate, **corners,
            "corners_seconds": wall_clock() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the results as JSON to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import build        # fails outside the checkout

    t_start = wall_clock()
    starts = {}              # phase -> seconds since the start, when it began
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[1/19] device: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = wall_clock()
    build.load()
    build_s = wall_clock() - t0
    log(f"[2/19] build: kernels compiled and loaded in {build_s:.1f}s")
    mm_regs, w32_regs = [], []
    for logf in sorted(build.build_dir().rglob("build.*.log")):
        text = logf.read_text()
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or ("Compiling entry" in line
                        and ("flash" in line or "decode_attention" in line))):
                log("  ptxas: " + line.strip()[:200])
        mm_regs += logmatmul_ptxas(text)
        w32_regs += w32_ptxas(text)
    for r in mm_regs:
        log(f"  ptxas, {r['family']} logmatmul tile {r['tile']}: "
            f"{r['registers']} registers, {r['spill_bytes']} bytes spilled")
    require({r["family"] for r in mm_regs} == {"skinny", "large"},
            "no skinny or no large logmatmul tile in the build log")
    spilled = [r["tile"] for r in mm_regs
               if r["family"] == "large" and r["spill_bytes"]]
    require(not spilled, f"large logmatmul tiles spilled: {spilled}")
    sass_dump = start_logmatmul_sass(build)   # read after phase 5
    for r in w32_regs:
        log(f"  ptxas, width-32 form {r['source']} {r['entry'][:90]}: "
            f"{r.get('registers')} registers, {r.get('spill_bytes')} bytes "
            "spilled")
    require(bool(w32_regs), "no width-32 kernel form in the build log")
    gate = start_analysis_gate()     # phase 19 (a), on the host meanwhile
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    starts[3] = wall_clock() - t_start
    log("[3/19] kernels vs plain versions")
    ew_err = check_elemwise(dev)
    log("  elemwise: bit-equal on every case")
    att_errs = check_attention(dev)
    da_errs = check_decode_attention(dev)
    mm_err, mm_plain_ms, mm_arch_runs = check_logmatmul(dev)
    packed_runs, packed_err = check_packed(dev)

    starts[4] = wall_clock() - t_start
    log("[4/19] paths: (p) the packed path, tuning.frontier.measure_error("
        "kernel='packed') and simdive_packed")
    packed = packed_path(dev)
    log("  (e) the elemwise kernel's path: tuning.frontier.measure_error("
        "kernel='elemwise')")
    ew_path = elemwise_path(dev)
    log("  (a) serving: smollm-360m full width, batch "
        f"{BATCH}, prompt {PROMPT}, gen {GEN}, --approx simdive")
    served = serve_main_path(dev)
    log("  (b) --approx simdive --emulate")
    served_e = serve_emulate_path(dev, served["params"], served["prompts"])

    starts[5] = wall_clock() - t_start
    log("[5/19] times")
    int_rate = int32_ops_per_s(dev)
    log(f"  INT32 peak: {int_rate:.4g} ops/s (SM count x 64 x max SM "
        f"clock); logmatmul's least work a product {LOGMATMUL_PRODUCT_WORK}"
        f" and an operand element {LOGMATMUL_OPERAND_WORK} over the pipes "
        f"{LOGMATMUL_PIPES} (lanes an SM a clock; superseded: "
        f"{LOGMATMUL_SUPERSEDED_OPS}); integer operations: "
        f"{ELEMWISE_OPS_PER_LANE} per elemwise div lane, "
        f"{PACKED_OPS_PER_LANE} per packed width-8 lane")
    kernels, times = measure(dev, served, int_rate)
    mm_kernels, mm_times, mm_shapes = measure_logmatmul(
        dev, mm_plain_ms, int_rate)
    sass = logmatmul_sass(sass_dump)
    kernels += mm_kernels
    times.update(mm_times)
    times.update(measure_emulate(served_e, served["params"],
                                 served["prompts"]))
    packed_row = measure_packed(packed, int_rate)

    starts[6] = wall_clock() - t_start
    log("[6/19] drill: serve --scheduler, smollm-360m full width, batch "
        f"{BATCH}, prompt {PROMPT}, gen {GEN}, {DRILL_REQUESTS} requests, "
        f"shed_depth {DRILL_SHED}, recover_depth {DRILL_RECOVER}")
    drill = scheduler_drill(dev)

    starts[7] = wall_clock() - t_start
    log("[7/19] faults: every kernel under each armed site, captured graphs, "
        "the campaign on the card, serve --chaos at full width")
    faults = fault_phase(dev, served["params"])

    starts[8] = wall_clock() - t_start
    log("[8/19] policy: build_policy / select_config on the card, a "
        "layer-segmented policy file served at full width (captured, "
        "--emulate, --scheduler, --chaos)")
    policy = policy_phase(dev, served["params"], served["prompts"])

    starts[9] = wall_clock() - t_start
    log("[9/19] arithmetic: the sqrt kernel, approx_softmax, approx_rmsnorm "
        "on the card; smollm-360m full width with use_in_norm (captured, "
        "eager, plain versions)")
    arith = arithmetic_phase(dev, served)
    sqrt_row, sqrt_times = time_sqrt(dev, int_rate)
    norm_counts = arith["use_in_norm"]["counts"]
    sqrt_row["launches"] = norm_counts["sqrt"]
    sqrt_row["max_abs_err"] = arith["sqrt_max_abs_err"]
    require(norm_counts["sqrt"] == norm_counts["elemwise"]
            == 2 * served["lm"].cfg.n_layers * GEN,
            f"use_in_norm generate: launches {norm_counts}")
    kernels.append(sqrt_row)

    starts[10] = wall_clock() - t_start
    log("[10/19] the dense family at full width: (k) the kernels' times "
        "at qwen3-4b's shapes, (a) qwen3-4b, (b) qwen3-4b --emulate, (c) "
        "stablelm-1.6b, (d) qwen2.5-14b; depths cut to SERVED_LAYERS")
    dense = dense_family_phase(dev, int_rate)

    starts[11] = wall_clock() - t_start
    log("[11/19] the MoE family at full width: (a) mixtral-8x7b "
        f"({SERVED_LAYERS['mixtral-8x7b']} of 32 layers), (b) "
        "llama4-scout-17b-a16e "
        f"({SERVED_LAYERS['llama4-scout-17b-a16e']} of 48 layers), (c) "
        "llama4-scout --emulate")
    moe = moe_family_phase(dev)

    starts[12] = wall_clock() - t_start
    log("[12/19] the modality-stub families at full width (musicgen-medium "
        f"at {SERVED_LAYERS['musicgen-medium']} of 48 layers): (k) "
        "the attention kernels' times at their shapes, (a) qwen2-vl-2b "
        "(text and the vision stub), (b) musicgen-medium, (c) "
        "musicgen-medium --emulate")
    modality = modality_family_phase(dev, int_rate)

    starts[13] = wall_clock() - t_start
    log(f"[13/19] rwkv6-1.6b at full width, {SERVED_LAYERS['rwkv6-1.6b']} "
        "of 24 layers: (k) "
        "logmatmul at its "
        "eight linears' shapes, (a) --approx simdive (no SIMDive kernel; "
        "the recurrent cache through both graphs), (c) --emulate")
    rwkv6 = rwkv6_phase(dev, int_rate)

    starts[14] = wall_clock() - t_start
    n_zamba2 = SERVED_LAYERS["zamba2-2.7b"]
    log("[14/19] zamba2-2.7b at full width: (k) the attention "
        "kernels at d_head 80 and logmatmul at its linears, (a) --approx "
        f"simdive ({n_zamba2} of 54 Mamba2 layers, the shared block "
        f"{n_zamba2 // 9} time(s) with its LoRA merged each call), (c) "
        "--emulate")
    zamba2 = zamba2_phase(dev, int_rate)

    starts[15] = wall_clock() - t_start
    log("[15/19] training: (a) logmatmul at smollm-360m's gradient "
        "products and elemwise at the training finalize, against their "
        "plain versions; (b) one step on the kernels == on the plain "
        "versions (2 layers); (c) launch.train.train at full width, "
        "--approx simdive --backward approx, a rung change, killed and "
        "resumed; (d) the exact-vs-approximate twin")
    training = training_phase(dev, int_rate)

    starts[16] = wall_clock() - t_start
    log("[16/19] applications at the reference's size: (a) logmatmul and "
        "matmul_emul at Table 4's layer shapes (int32 and wide forms) and "
        "elemwise at Fig. 3/4's lanes, every rung, against their plain "
        "versions; (b) Table 4's two MLPs trained on the card and run in "
        "8-bit fixed point; (c) the campaign's --ann; (d) profile_ann, "
        "greedy_assign, ann_policy_metric and profile_imaging")
    apps = applications_phase(dev, int_rate)

    starts[17] = wall_clock() - t_start
    log("[17/19] width 32: (a) elemwise, sqrt, the finalize alone and both "
        "attention kernels at a width-32 divider against their plain "
        "versions, disarmed and armed; (b) measure_error and select_config "
        "at width 32; (c) smollm-360m full width under a width-32 divider "
        "policy, with and without use_in_norm")
    w32 = width32_phase(dev, served, int_rate, w32_regs)
    kernels += w32.pop("kernels")

    starts[18] = wall_clock() - t_start
    log("[18/19] mesh: ranks on the one card over gloo — (a) stablelm-1.6b "
        f"tp {MESH_TP} ({MESH_LAYERS} of 24 layers) against tp 1, (b) "
        f"smollm-360m tp 3 ({MESH_TP3_LAYERS} of 32 layers), (c) "
        "mixtral-8x7b's MoE block SPMD, (d) a world-1 NCCL step == gloo, "
        "(e) compress_psum, (f)-(h) cut heads, rwkv6-1.6b and zamba2-2.7b "
        "at tp 2, (i) the served forward at tp 2, (j) the dry run against "
        "the ranks, (k) a FULL train_4k dry-run cell a family")
    mesh = mesh_phase(dev, int_rate)

    starts[19] = wall_clock() - t_start
    log("[19/19] the static analyzer: (a) python -m repro_torch.analysis "
        "--gate on this host, (b) its proved cases' corners through the "
        "kernels against their plain versions")
    analysis = analysis_phase(dev, gate)
    # launches: the error sweeps and the simdive_packed calls of phase 4,
    # each window zeroed just before and read just after; max_abs_err is
    # the largest lane error over phase 4's outputs at both sizes, the
    # worst over phase 3's cases stands beside it
    packed_row["launches_measure_error"] = packed["sweep_launches"]
    packed_row["launches_simdive_packed"] = packed["api_launches"]
    packed_row["launches"] = packed["sweep_launches"] + packed["api_launches"]
    packed_row["max_abs_err"] = packed["max_abs_err"]
    packed_row["max_abs_err_all_cases"] = packed_err
    packed_row["bit_equal_runs"] = packed_runs
    packed_row["bench_errors"] = packed["errors"]
    kernels.append(packed_row)
    counts, counts_e = served["counts"], served_e["counts"]
    pinned = served["pinned_counts"]
    by_name = {kern["name"]: kern for kern in kernels}
    # elemwise: measure_error's two calls on the card (phase 4 (e))
    by_name["elemwise"]["launches"] = ew_path["launches"]
    by_name["elemwise"]["max_abs_err"] = ew_err
    by_name["elemwise"]["measure_error"] = ew_path["errors"]
    # ... and phase 8 (a)'s policy build: one per (op, width, coeff_bits)
    by_name["elemwise"]["launches_policy_build"] = \
        policy["policy_build_launches"]["elemwise"]
    # ... and phase 9 (d)'s use_in_norm generate: one a block norm
    by_name["elemwise"]["launches_use_in_norm"] = norm_counts["elemwise"]
    # decode_attention: the divider-only main path's run; max_abs_err at
    # the main path's shape, the worst over every phase-3 case beside it
    by_name["decode_attention"]["launches"] = counts["decode_attention"]
    by_name["decode_attention"]["launches_emulate"] = \
        counts_e["decode_attention"]
    by_name["decode_attention"]["max_abs_err"] = da_errs["main"]
    by_name["decode_attention"]["max_abs_err_all_cases"] = da_errs["all"]
    by_name["decode_attention"]["resident_clusters"] = \
        da_errs["resident_clusters"]
    # logmatmul: the autotuned full-size --emulate run plus the full-size
    # run pinned to the row's schedule, each zeroed just before and read
    # just after, as for attention below
    for kern, name in ((by_name["logmatmul"], "matmul"),
                       (by_name["logmatmul_pipelined"], "matmul_pipelined")):
        kern["launches_autotuned"] = counts_e[name]
        kern["launches_pinned"] = served_e["pinned_counts"][name]
        kern["launches"] = counts_e[name] + served_e["pinned_counts"][name]
        kern["max_abs_err"] = mm_err
    # attention: the autotuned divider-only run plus the full-width run
    # pinned to the row's schedule, each zeroed just before and read just
    # after, so that a schedule the autotune did not pick still shows on
    # the path. max_abs_err is taken at the main path's shape; the worst
    # over every other case of phase 3 stands beside it.
    for kern, name, tag in ((by_name["flash_attention"], "attention", ""),
                            (by_name["flash_attention_pipelined"],
                             "attention_pipelined", "pipe_")):
        kern["launches_autotuned"] = counts[name]
        kern["launches_pinned"] = pinned[name][name]
        kern["launches"] = counts[name] + pinned[name][name]
        kern["max_abs_err"] = att_errs[tag + "main"]
        kern["max_abs_err_all_cases"] = att_errs[tag + "all"]
    # the drill (phase 6): its own counts, zeroed just before each drill
    # and read just after, beside the earlier paths' launches
    for kern, names in ((by_name["flash_attention"], ("attention",)),
                        (by_name["flash_attention_pipelined"],
                         ("attention_pipelined",)),
                        (by_name["decode_attention"], ("decode_attention",)),
                        (by_name["logmatmul"], ("matmul",)),
                        (by_name["logmatmul_pipelined"],
                         ("matmul_pipelined",))):
        kern["launches_drill"] = sum(drill["drill_launches"][n]
                                     for n in names)
        kern["launches_drill_emulate"] = sum(
            drill["drill_emulate_launches"][n] for n in names)
        # the chaos drills (phase 7 (d)), likewise zeroed and read
        kern["launches_chaos"] = sum(faults["launches_chaos"][n]
                                     for n in names)
        kern["launches_chaos_emulate"] = sum(
            faults["launches_chaos_emulate"][n] for n in names)
        # phase 8: the policy's generate, --emulate, drill and chaos
        # drill, each zeroed just before and read just after
        for key in ("launches_policy", "launches_policy_emulate",
                    "launches_policy_drill", "launches_policy_chaos"):
            kern[key] = sum(policy[key][n] for n in names)
    # phase 10: the launches of (a)-(d) together, zeroed just before each
    # counted generate and read just after; the kernels at the new shapes:
    # phase 3's errors at each configuration's, phase 10's times at
    # qwen3-4b's
    dense_runs = ("qwen3-4b", "qwen3-4b --emulate", "stablelm-1.6b",
                  "qwen2.5-14b")
    dense_rows = dict(dense["kernels"])
    for arch, *_ in DENSE_ATTENTION:
        for key, errs in ((f"attention {arch}", att_errs),
                          (f"decode_attention {arch}", da_errs)):
            dense_rows[key] = {**errs["archs"][arch],
                               **dense_rows.get(key, {})}
    dense_rows["logmatmul qwen3-4b"]["bit_equal_runs"] = \
        mm_arch_runs["qwen3-4b"]
    for kern, names, keys in (
            (by_name["flash_attention"], ("attention",),
             [f"attention {a}" for a, *_ in DENSE_ATTENTION]),
            (by_name["flash_attention_pipelined"], ("attention_pipelined",),
             []),
            (by_name["decode_attention"], ("decode_attention",),
             [f"decode_attention {a}" for a, *_ in DENSE_ATTENTION]),
            (by_name["logmatmul"], ("matmul",), ["logmatmul qwen3-4b"]),
            (by_name["logmatmul_pipelined"], ("matmul_pipelined",), []),
            (by_name["sqrt"], (), ["sqrt working size"])):
        kern["launches_dense_family"] = sum(
            dense[r]["counts"][n] for r in dense_runs for n in names)
        for key in keys:
            kern[key] = dense_rows[key]
    # phase 11: the launches of (a)-(c) together, zeroed just before each
    # counted generate and read just after; phase 3's errors at the MoE
    # configurations' attention shapes
    moe_runs = ("mixtral-8x7b", "llama4-scout-17b-a16e",
                "llama4-scout-17b-a16e --emulate")
    for kern, name, errs in (
            (by_name["flash_attention"], "attention", att_errs),
            (by_name["flash_attention_pipelined"], "attention_pipelined",
             None),
            (by_name["decode_attention"], "decode_attention", da_errs),
            (by_name["logmatmul"], "matmul", None),
            (by_name["logmatmul_pipelined"], "matmul_pipelined", None)):
        kern["launches_moe"] = sum(moe[r]["counts"][name] for r in moe_runs)
        for arch, *_ in (MOE_ATTENTION if errs is not None else ()):
            kern[f"{name} {arch}"] = errs["archs"][arch]
    # phase 12: the launches of (a)-(c) and of (a)'s vision stub together,
    # zeroed just before each counted generate and read just after; the
    # attention kernels at the new shapes: phase 3's errors and phase 12's
    # times at each configuration's
    modality_counts = [modality[r]["counts"] for r in (
        "qwen2-vl-2b", "musicgen-medium", "musicgen-medium --emulate")]
    modality_counts.append(modality["qwen2-vl-2b"]["vision"]["counts"])
    modality_rows = dict(modality["kernels"])
    for kern, name, errs in (
            (by_name["flash_attention"], "attention", att_errs),
            (by_name["flash_attention_pipelined"], "attention_pipelined",
             None),
            (by_name["decode_attention"], "decode_attention", da_errs),
            (by_name["logmatmul"], "matmul", None),
            (by_name["logmatmul_pipelined"], "matmul_pipelined", None)):
        kern["launches_modality"] = sum(c[name] for c in modality_counts)
        for arch, *_ in (MODALITY_ATTENTION if errs is not None else ()):
            key = f"{name} {arch}"
            kern[key] = {**errs["archs"][arch], **modality_rows[key]}
    # phase 13: the launches of (a) and (c) together, zeroed just before
    # each counted generate and read just after (none but (c)'s
    # logmatmul); logmatmul at rwkv6-1.6b's linears: phase 3's bit-equal
    # runs and phase 13's times
    rwkv6_counts = [rwkv6[r]["counts"] for r in (RWKV6, f"{RWKV6} --emulate")]
    rwkv6_rows = rwkv6["kernels"]
    rwkv6_rows[f"logmatmul {RWKV6}"]["bit_equal_runs"] = mm_arch_runs[RWKV6]
    for kern, names, keys in (
            (by_name["flash_attention"], ("attention",), []),
            (by_name["flash_attention_pipelined"], ("attention_pipelined",),
             []),
            (by_name["decode_attention"], ("decode_attention",), []),
            (by_name["logmatmul"], ("matmul",), [f"logmatmul {RWKV6}"]),
            (by_name["logmatmul_pipelined"], ("matmul_pipelined",), []),
            (by_name["elemwise"], ("elemwise",), []),
            (by_name["packed"], ("packed",), []),
            (by_name["sqrt"], ("sqrt",), [])):
        kern["launches_rwkv6"] = sum(c[n] for c in rwkv6_counts
                                     for n in names)
        for key in keys:
            kern[key] = rwkv6_rows[key]
    # phase 14: the launches of (a) and (c) together, zeroed just before
    # each counted generate and read just after; the kernels at zamba2's
    # shapes: phase 3's errors and phase 14's times
    zamba2_counts = [zamba2[r]["counts"]
                     for r in (ZAMBA2, f"{ZAMBA2} --emulate")]
    zamba2_rows = dict(zamba2["kernels"])
    zamba2_rows[f"logmatmul {ZAMBA2} mamba2"]["bit_equal_runs"] = \
        mm_arch_runs[ZAMBA2]
    for key, errs in ((f"attention {ZAMBA2}", att_errs),
                      (f"decode_attention {ZAMBA2}", da_errs)):
        zamba2_rows[key] = {**errs["archs"][ZAMBA2], **zamba2_rows[key]}
    for kern, names, keys in (
            (by_name["flash_attention"], ("attention",),
             [f"attention {ZAMBA2}"]),
            (by_name["flash_attention_pipelined"], ("attention_pipelined",),
             []),
            (by_name["decode_attention"], ("decode_attention",),
             [f"decode_attention {ZAMBA2}",
              f"decode_attention {ZAMBA2} cache 2048"]),
            (by_name["logmatmul"], ("matmul",),
             [f"logmatmul {ZAMBA2} mamba2", f"logmatmul {ZAMBA2} shared"]),
            (by_name["logmatmul_pipelined"], ("matmul_pipelined",), []),
            (by_name["elemwise"], ("elemwise",), []),
            (by_name["packed"], ("packed",), []),
            (by_name["sqrt"], ("sqrt",), [])):
        kern["launches_zamba2"] = sum(c[n] for c in zamba2_counts
                                      for n in names)
        for key in keys:
            kern[key] = zamba2_rows[key]
    # phase 15: the training path's launches, each window zeroed just
    # before and read just after: one counted step and the uninterrupted
    # run of (c), the twin of (d); the kernels at the training shapes (a)
    for kern, name in ((by_name["logmatmul"], "matmul"),
                       (by_name["logmatmul_pipelined"], "matmul_pipelined"),
                       (by_name["elemwise"], "elemwise")):
        kern["launches_train_step"] = \
            training["trainer"]["step_counts"].get(name, 0)
        kern["launches_train"] = training["trainer"]["run_counts"].get(name,
                                                                       0)
        kern["launches_twin"] = training["twin"]["counts"].get(name, 0)
    by_name["logmatmul"]["train_grad_products"] = \
        training["kernels"]["products"]
    by_name["elemwise"]["train_finalize"] = training["kernels"]["finalize"]
    # phase 16: the application studies' launches, zeroed just before (b)
    # and read just after (d), of which the wide logmatmul form's; the
    # kernels at the studies' shapes (a)
    for kern, name in ((by_name["logmatmul"], "matmul"),
                       (by_name["logmatmul_pipelined"], "matmul_pipelined"),
                       (by_name["elemwise"], "elemwise")):
        kern["launches_apps"] = apps["counts"].get(name, 0)
    by_name["logmatmul"]["launches_apps_wide"] = apps["wide_launches"]
    by_name["logmatmul"]["table4"] = apps["kernels"]["matmul"]
    by_name["elemwise"]["imaging"] = apps["kernels"]["elemwise"]
    # phase 18: each rank's launches in the train runs of (a), (b) and
    # (f)-(h) and in (i)'s prefills and steps, each zeroed just before and
    # read just after, added over the ranks; logmatmul at (a)'s, rwkv6's
    # and zamba2's shard shapes
    mesh_counts = [c for part in ("a", "b", *MESH_CASES, "l", "m", "m4")
                   for c in mesh[part]["launches_by_rank"]]
    mesh_counts += [c for arch, _ in MESH_SERVE
                    for row in mesh["i"][arch]["launches_by_rank"]
                    for c in row.values()]
    for kern, names in ((by_name["logmatmul"], ("matmul",
                                                "matmul_pipelined")),
                        (by_name["elemwise"], ("elemwise",)),
                        (by_name["flash_attention"], ("attention",)),
                        (by_name["flash_attention_pipelined"],
                         ("attention_pipelined",)),
                        (by_name["decode_attention"],
                         ("decode_attention",))):
        kern["launches_mesh"] = sum(counts.get(n, 0) for counts in mesh_counts
                                    for n in names)
    by_name["logmatmul"]["mesh_tp2_shapes"] = mesh["kernels"]
    # the large tile as built: registers and spills of each instantiation,
    # its product loops' SASS a product (phase 2)
    by_name["logmatmul"]["large_tile_ptxas"] = [
        r for r in mm_regs if r["family"] == "large"]
    by_name["logmatmul"]["large_tile_sass"] = sass
    for kern in kernels:
        require(kern["launches"] > 0, f"{kern['name']} never launched on "
                                      "the path")
    require(by_name["logmatmul"]["launches_autotuned"]
            + by_name["logmatmul_pipelined"]["launches_autotuned"]
            == 7 * 32 * GEN,
            "logmatmul launches on the emulate path")
    for key, val in times.items():
        log(f"  {key}: {val:.4f}")
    for key, val in (*drill.items(), *faults.items(), *policy.items(),
                     *arith.items(), *dense.items(), *moe.items(),
                     *modality.items(), *rwkv6.items(),
                     *zamba2.items(), *training.items(), *apps.items(),
                     *w32.items(), *mesh.items(), *analysis.items()):
        log(f"  {key}: "
            f"{val if isinstance(val, (dict, list)) else f'{val:.4f}'}")
    total_s = wall_clock() - t_start
    ends = [*list(starts.values())[1:], total_s]
    phase_s = {k: round(end - begin, 1)
               for (k, begin), end in zip(starts.items(), ends)}
    log(f"  total {total_s:.1f}s; seconds by phase (3-19) {phase_s}")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({
            "card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s,
            "total_s": total_s, "phase_s": phase_s, "kernels": kernels,
            "times": times,
            "main_path": {k: v for k, v in served.items()
                          if k not in ("lm", "params", "prompts")},
            "emulate_path": {k: v for k, v in served_e.items()
                             if k != "lm"},
            "logmatmul_shapes": mm_shapes, "drill": drill,
            "faults": faults, "policy": policy,
            "arithmetic": {**arith, "sqrt_times": sqrt_times},
            "dense_family": dense, "moe_family": moe,
            "modality_family": modality, "rwkv6": rwkv6,
            "zamba2": zamba2, "training": training, "applications": apps,
            "width32": w32, "mesh": mesh, "analysis": analysis,
            "packed_errors": packed["errors"],
            "device": device}, indent=1))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
