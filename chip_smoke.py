#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`paddle_tpu_torch`).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out result.json] [--profile]

Phases (any failure exits non-zero; the last line is printed only when
every phase passed):
1. card name and power limit (nvidia-smi); build every kernel with nvcc,
   one process per source, all at once.
2. kernel K1 (ragged flash-decode; each lane and head cut into C(T) =
   min(8, max(1, T / 128)) CTAs of one thread-block cluster, merged
   inside the launch) against its plain version (split-K + merge) and
   the full-slab reference on the card at GPT-small decode shapes
   (B = S = 8, nh = 12, hd = 64) at T = 1024 (C = 8), 256 (C = 2) and 64
   (C = 1), fp32 and bf16, the reference's 1 and 2 splits, a
   repeated-slot verify layout, lengths 0, 1, block_k - 1, block_k,
   block_k + 1, 513, T - 1, T; outputs within fp32 atol = rtol = 1e-4 /
   bf16 2e-2 of `ragged_decode_reference` and within 1e-5 / 2e-2 of the
   plain split + merge, one launch per call, visit counts exactly the
   reference's live-chunk arithmetic, and dead cache rows never read
   (NaN-filled dead rows leave the output bitwise unchanged).
2a. kernels K4 (paged), K5 (int8) and K6 (paged int8) against their
   plain versions (split + merge) at the same shapes and the same three
   T, fp32 and bf16, pages of 64 rows at shuffled ids, the phase-2 edge
   lengths and the phase-4 lengths (clipped to T): outputs within
   atol = rtol = 1e-5 (fp32) / 2e-2 (bf16), visit counts exact, NaN in
   dead rows, unbound pages and the trash page (in the scales, for
   int8) leaves the output bitwise unchanged; K4 == K1 and K6 == K5
   bitwise on the same rows.
2b. kernel K7 (fused int8 GEMV) against its plain version, bitwise, at
   GPT-small's five (k, n) (768 x 2304 / 768 / 3072, 3072 x 768 and the
   int8 draft's head 768 x 50304), gpt_1p3b's four block shapes (2048 x
   6144 / 2048 / 8192, 8192 x 2048) and three edges through the wrapper
   (k 100, no multiple of 4, at n 16 and 48; k 20, shorter than one
   split of the launch plan, at n 768), 1-4 rows, x in bf16 and fp32
   (the weight scales in x's dtype), without a bias and with an fp32
   and a bf16 one; inputs include x on code half-points ((c + 0.5) *
   sx) and on +-127.5 * sx. Each shape's launch plan is logged.
3. kernels K2 (flash-attention forward) and K3 (backward: delta, dk/dv
   and dq kernels) on both routes, `wgmma` (bf16 at head dim 32, 64,
   128) and `tf32x3` (fp32 at 32, 64, 128: the split kernel, then every
   product as three TF32 products), against their plain versions (fp32
   products exact, TF32 off): the training shape (b 18,
   s 1024, h 12, d 64, causal, q/k/v strided slices of one fused qkv
   tensor as the model passes them), sq < sk (256 vs 1024) causal, a
   length that is no tile multiple (1000) non-causal and causal,
   d = 128, and the edges of the TMA tiles: d = 128 on a packed qkv
   (two 64-column boxes per row tile, strided), causal sq 200 against
   sk 1000 (sq no multiple of 128, sk - sq a multiple of neither 64 nor
   128), causal sq 1 against sk 333 (one query under one tile), and
   b x h = 1024 heads (far more work items than SMs); then causal sq
   1024 against sk 256 (768 rows with no visible key: the reference's
   uniform softmax), causal sq 300 / sk 200, d 128 sq 1000 / sk 900
   (the last empty row inside a K2 warpgroup and a K3 query tile) and
   sq 1000 / sk 936 (the edge between K2's two warpgroups of a tile),
   b x h = 66000 at s 128; fp32 at d 64 (packed), 32 and 128, fp32
   sq 200 / sk 333, fp32 causal sq 300 / sk 200, bf16 d 32 packed and
   not, bf16 d 32 causal sq 300 / sk 200 and sq 1 / sk 333 (the 64-byte
   swizzle on the same edges as d 64), fp32 d 128 sq 1000 / sk 900 and
   an fp32 slice whose strides are no multiple of 16 bytes, and
   ERNIE's shape (b 64, s 128, h 12, d 64, non-causal, packed qkv,
   bf16: one key tile per (b, h) pair). bf16: the
   output
   within atol = rtol = 2e-2, the logsumexp within atol = 1e-3, each
   gradient within max|kernel - plain| <= 2e-2 * max|plain|; fp32: the
   output and each gradient within 1e-5 * max|plain|, the logsumexp
   within 1e-5 * max|plain|; rows with no visible key have lse -1e30
   and dq 0; two backward runs bitwise equal; each call launches on
   its route only. fp16 (the wgmma_f16 route) at d 32, 64 and 128: the
   training shape, gpt_tiny's packed shape, d 128, sq 200 / sk 1000,
   causal sq 300 / sk 200 and d 32 s 1000, out within atol = rtol =
   2e-3 and each gradient within 2e-3 * max|plain| (ten times bf16's
   limits; the largest errors are logged); and K3 at the training shape
   with g = min(|N(0, 1)|, 3.9) x 2^14 (a loss scale; g finite): dv
   overflows fp16's 65504 on both sides, the finite entries agree within 2e-3 and the
   non-finite pattern is the same except within one fp16 ulp of the
   overflow edge.
3b. the TF32 probe (`csrc/tf32_probe.cu`): a 64 x 64 x 32 wgmma tile
   product against an fp32 FFMA product and fp64, at the magnitudes of
   attention scores (normal operands) and probabilities ([0, 1) times
   normal): the largest error relative to max|fp64| of one TF32
   product, of 3xTF32 from shared memory and of 3xTF32 with A from
   registers (the tf32x3 route's P and dS, in its permuted fragments);
   both 3xTF32 within 1e-5. Chosen operands show whether the card
   truncates or rounds the 13 low bits of an fp32 operand it reads as
   TF32.
4. serving at full width: GPT-small (768 hidden, 12 layers, 12 heads,
   vocab 50304, random weights from a seed) in bf16 served by
   `LLMEngine(max_slots=8, max_seq=1024, decode_block_size=8)` on 16
   requests (prompts 16..700 tokens, 64 new tokens, mostly greedy, some
   sampled). Every request finishes; K1 launched exactly num_layers x
   decode steps times; one host sync per dispatch; two greedy requests
   served alone reproduce their batched streams bitwise.
4b. the same load through `kv_layout="paged"` (K4), `kv_dtype="int8"`
   (K5) and both (K6): each run launches its kernel exactly num_layers
   x decode steps times and the other decode kernels never; paged
   streams equal slotted ones token for token.
4c. paged int8 with `kv_pages=49`: admission waits on pages while lanes
   are free, all 16 requests finish with (b)'s streams, 0 pages leak.
4d. an int8-PTQ GPT-small (the port's `PTQ` over the bf16 model,
   calibrated on two fixed batches from numpy seed 0) served with
   `max_slots=4` on 8 of phase 4's requests: K7 launched exactly 4 x 12
   times per decode step (prefill rows exceed 4 and take the unfused
   product), K1 12 times; the same load with K7's plain version swapped
   in gives the same streams.
4e. speculation on == off at GPT-small bf16: `max_slots=4`,
   `decode_block_size=8`, `speculate_k=3`, 8 of phase 4's requests
   (greedy and sampled, one stopping at an EOS, 32 new tokens): draft
   trunc and int8 on the slotted layout, int8 on the paged layout, int8
   with `kv_dtype="int8"`; every stream equals the spec-off engine's
   token for token. K7 launches = (4 x draft_layers + 1) x k x
   spec_rounds x decode blocks (int8 draft), 0 (trunc); the decode
   kernel's = (k x draft_layers + 12) x spec_rounds x decode blocks.
   Acceptance rate and tokens/s, off against on, are logged.
   Every decode block of phases 4-4e runs as one CUDA graph replay:
   each engine captures each of its block programs once
   (`graph_captures`), and the launch counts above are counted per
   replay.
4f. the dispatch loop: the loads of phases 4, 4b, 4d and 4e (trunc and
   int8 drafts) served eagerly (no graph) give the graph runs' streams
   bitwise; phase 4's load with `overlap=False` gives phase 4's streams
   (overlap on); injected faults under overlap (`decode_dispatch` call
   3 and `host_sync` call 6 through K1; `host_sync` calls 2 and 9 through
   K6) and under speculation (`draft_dispatch` calls 2 and 3,
   `host_sync` call 4, int8 draft) give the clean streams, with one
   retry per fault, 2 speculative fallbacks and the plain graph
   captured beside the speculative one; host syncs = dispatches, one
   capture per runner and 0 leaked pages everywhere; the CUDA kernels
   of one graph launch and the device's busy share of a profiled
   decode-only step are logged. Every prefill piece of phases 4-4h is
   one CUDA graph replay of its row count's program; here phase 4's
   load in pieces of at most 600 tokens (rows 128, 256, 512, 1024)
   through K1, K4, K5, K6 and the int8-PTQ model, graphed and eager,
   gives bitwise equal logits for every prefill call and equal
   streams, one prefill capture per row count (seconds and graph pool
   bytes logged), and the same counted launches (a prefill replay adds
   none).
4g. admission: phase 4's model on a shared-prefix load (one 512-token
   system prompt, 16-188-token tails) monolithic without the prefix
   cache (a), with it (b), interleaved (c: `prefill_budget=256,
   prefill_chunk=64`), paged (d), paged int8 (e, against its cache-off
   twin), (c) snapshotted and resumed (f), (c) with two requests
   extracted and adopted by a second engine (g): all streams bitwise
   equal as stated, 15 x 512 tokens reused in (b), decode launches =
   layers x (decode + replay steps); TTFT, tokens/s, prefill tokens and
   prefill captures logged.
4h. the reference's open-loop serving bench (`bench.py`'s
   `bench_serve_openloop`, accelerator branch): GPT-small bf16 at
   max_seq 1024, 8 slots, `decode_block_size=2`, prefix cache off; 96
   requests on one seeded Poisson schedule at 40 requests/s (long, 896
   tokens, with probability 0.125, else 8/16/24/32 tokens; 16 new
   tokens each) served in real time monolithically and with
   `prefill_budget=32, prefill_chunk=32`, each engine warmed outside
   its window; the interactive class's ttft_p99 and queue_wait_p99,
   the long class's ttft_p99, the speedup and the decode-stall probe
   (an attached stream's longest inter-token gap across a long
   prompt's admission) in both modes, under the reference's metric
   names; every request finishes, 0 graph captures inside a timed
   window.
4i. best-of-n, the reference's `bench_serve_bestof` accelerator load
   (`bench.py`): GPT-small bf16, `max_slots=6, max_seq=1024`, paged,
   64-row pages, prefix cache off, one seeded 512-token prompt, 64 new
   tokens, temperature 0.8, top_k 20: one request against n = 4, peak
   pages 9 against 12 (ratio < 1.5), no boundary copy, 0 leaked pages,
   continuation 0 the request served alone; a 500-token prompt (3
   boundary copies, 9 against 15 pages, logged); the group slotted
   (K1), interleaved (`prefill_budget=256, prefill_chunk=64`: the same
   prefill tokens, a peak no higher) and with `speculate_k=2` (trunc)
   gives the paged group's streams bitwise; paged int8 KV (K6) leaks no
   page. Each run counts its decode kernel from 0: layers x decode
   steps ((k x draft layers + layers) x rounds x blocks speculative),
   the others 0.
4j. the generation surface on GPT-small bf16, 4 seeded 128-token
   prompts, 64 new tokens: eager `generate` == `generate_jit` (one CUDA
   graph) bitwise, a second call captures nothing, sampled
   `generate_jit` deterministic in its seed and not across seeds,
   `beam_search(beam_size=1)` == greedy, beam 4 with an EOS keeps the
   prompt and scores finitely; one profiled replay's kernels and busy
   share; the int8-PTQ GPT-small's `generate_jit` launches K7 48 x 63
   times per replay and equals eager `generate` with K7's plain version
   swapped in, K7 == plain at its four 4-row shapes. Eager and graph ms
   per step, capture seconds, pool bytes and beam ms per step are
   logged beside the card.
4k. observability, host swap and the serving artifact on GPT-small
   bf16: (a) phase 4's load, paged (`overlap=True`, block 8) with the
   pool starved to the first 8 requests' spans: 2 of the 8 decoding
   requests swapped out mid-run, the queue admitted into the freed
   pages, both swapped back in; streams bitwise 4b's, pages out = in,
   2 swap host syncs, 0 leaked, K4 = layers x decode steps; again with
   int8 KV (K6); (b) the engine's snapshot with a parked request,
   resumed: 0 prefill tokens for it, streams bitwise; (c) a paged
   extract adopted by a second engine: 0 prefill tokens, bitwise; (d)
   phase 4's load with tracing on and off (decode ms per step each,
   their ratio; one span tree per request, one decode_block event per
   block, a strict-parsed exposition, to_prometheus / export_trace host
   ms); 0 unexpected captures on every engine of the phase; (e) an
   injected decode_dispatch exhaustion writes one flight dump; (f) 4d's
   PTQ model through `save_for_serving` / `load_engine` on the card:
   4d's streams, 48 K7 launches per decode step. swap_out, gather and
   scatter ms at 1, 9 and 16 pages beside the bytes and a pinned copy
   of the same bytes are logged.
4l. the replica fleet on GPT-small bf16 (`EngineFleet`, every replica
   on this one card): (a) the reference's KV tier A/B
   (`bench_serve_kv_tier` at its accelerator settings: 3 paged
   replicas, 4 slots, 64-row pages, max_seq 512, one 337-token shared
   prompt, 32 new tokens, a leader then 3 waves of 3) with the tier off
   and on: streams identical across on, off and the leader, tier hits
   >= 4 and publishes >= 1, the reuse gain (on - off) / (3 x 320
   aligned tokens) within 0.8-1.2 x 2/3, 0 leaked pages, 0 unexpected
   captures, K4 = layers x (decode + discarded steps) summed over the
   replicas (discarded: blocks launched and never processed, a killed
   replica's in-flight block); again with int8 KV (K6); (b) the
   reference's autoscale load (`bench_serve_autoscale`: 16 Poisson
   arrivals at 8/s then 48 at 32/s, 96-token prompts, 96 new tokens,
   1-3 replicas behind a `FleetAutoscaler`, the busiest replica killed
   during the step): 0 stranded, 0 leaked, 0 unexpected captures, a
   policy scale-out, the kill replaced, settled at 1 replica, TTFT p99
   step / steady at most 15 (the reference's time-share limit: every
   replica shares this card), K4 = layers x (decode + replay +
   discarded steps) over every engine the fleet built; (c) the kill
   soak of `python -m paddle_tpu_torch.serving` at GPT-small (3
   replicas, prefix affinity, the busiest killed after 3 rounds and
   revived through the canary), slotted (K1) and paged with roles
   (prefill, decode, decode) and the tier (K4, pages handed off through
   the tier): 0 stranded, greedy streams equal one undisturbed
   engine's, the exposition strict-parsed; (d) captures amid garbage:
   a captured engine dropped inside a reference cycle (as a failover or
   a scale-in leaves one), then a fresh engine's prefill and decode
   block captured with the cycle collector run at nearly every
   allocation: the dead engine collected, no collection inside a
   capture, the stream equal to the dead engine's. TTFT p50 / p99 tier
   on and off, publish and bind ms, and each replica's captures and
   capture seconds are logged with the card.
4m. the HTTP front door on phase 4's GPT-small bf16: K4 and K6 against
   their plain versions at the paged soak's shapes (4 lanes, max_seq
   256, 8-row pages, bf16; lengths at the page edges and across its
   streams: visit counts exact, dead rows and the trash page unread, K4
   == K1 bitwise); then `python -m paddle_tpu_torch.serving.server`'s
   soak (`run_soak` on this model, on this main thread: 48 behaved + 24
   flood streams, every 5th behaved stream disconnecting after its
   first chunk, a real SIGTERM drain after 12 completions and a
   restarted server (resumed from the drain's snapshot where the drain
   found work in flight; on a card a lone engine has usually finished
   everything by then) that takes reattach-by-id and the refused
   streams, 4 slots, 12 new tokens, every 6th stream 16x, 75 ms
   spacing, prefill_budget 16, max_seq 256; each backend's programs
   captured by `warm_up` before its server takes traffic) slotted (a,
   K1), paged int8 KV (b, K6 at 8-row pages), 2 replicas with the
   busiest killed and revived (c, K1), speculate 4 with the int8 draft
   (d, K1 + K7), autoscaled 1-3 replicas with a preemption (e, K1), and
   paged int8 KV drained after 4 completions, while the first 16x
   stream is still decoding (f, K6): the restart resumes a lone engine
   from the drain's pickled snapshot and reattaches that stream by id.
   Each passes the soak's gates at the reference's values (0 stranded,
   0 bit mismatches against an undisturbed engine, a strict-parsed
   exposition, sheds > 0 each with Retry-After, steady ttft_p99 /
   decode ms per token <= 400 (disarmed for (e), as in the reference),
   0 leaked pages, the autoscale contract), launches its kernels and no
   other decode kernel (counters set to 0 just before the soak, read
   once its servers have stopped and before the verdicts' reference
   engine runs), and, but for (d), launches each exactly 12 x (decode
   + replay + discarded steps) over every engine that served (killed,
   revived, spawned and resumed ones too); it makes no capture in the
   restarted server's window (all but e) and leaves the SIGTERM /
   SIGINT handlers as they were. TTFT p99 steady and under shedding,
   decode ms per token, the tail ratio, sheds, disconnects, reattached
   streams, captures and seconds are logged with the card.
4n. TP-sharded serving on phase 4's GPT-small bf16, every rank of a
   group on this one card (`LLMEngine(tp=k)`): K1 and K4 through the
   sharded entries over 6-head (tp 2) and 3-head (tp 4) slabs at
   phase-4 shapes, fp32 and bf16, tp launches a call, each rank within
   1e-5 / 2e-2 of its plain version and the ranks joined == the 12-head
   launch bitwise; phase 4's first 8 requests (their first 32 tokens)
   through K1, K4, K5 and K6 at tp 2 and 4 (K1 at tp 1 too): each
   kernel tp x 12 x decode steps and no other, 2 L + 2 = 26 collectives
   a forward (prefill call or decode step), kv_bytes_per_token tp 1's;
   first-token logits within 2 e of tp 1's, e being tp 1's bf16 error
   against the fp32 logits of the same weights; greedy streams equal
   phase 4 / 4b's tp=1 streams but after a step whose tp=1 top-2 margin
   is below the tie bound 4 e (such steps are printed); at tp 2 graph
   == eager and a snapshot resumed bitwise (K1 = 24 x (decode + replay
   + discarded steps)); `EngineFleet(tp=2)` of two groups with the
   busiest killed and revived (0 stranded, greedy = one tp 2 engine's,
   K1 = 24 x the steps of every engine); the front-door soak at `--tp
   2` (slotted, phase 4m's gates, K1 = 24 x steps). K1 and K4 at 12, 6
   and 3 heads, decode ms per step, capture seconds and prefill pool
   bytes at tp 1 / 2 / 4 are logged with the card.
5. ragged against masked attention in fp32: equal greedy streams,
   except after a step whose top-2 logit margin is below 1e-3 (margins
   logged).
5d. paged against slotted greedy streams with fp32 weights: K4 against
   K1 and K6 against K5, equal token for token (smallest top-2 margin
   logged).
6. training at full width: GPT-small from seed 0 under
   `Trainer(AdamW(1e-4), amp_level="O2", amp_dtype="bfloat16")` on one
   resident batch of 18 x 1024 token ids (numpy seed 0), as `bench.py`
   trains; one warm-up step, then 10 steps. Every loss finite, the last
   below the first, K2 and K3 each launched exactly 12 x 10 times; step
   ms, tokens/s and peak memory.
6b. fp32 training at `Trainer`'s default amp_level=None through the
   tf32x3 route: gpt_tiny (head dim 32, bs 8 x 256, AdamW 1e-3) takes 3
   steps on the card and the same 3 on the CPU (plain attention),
   losses within 1e-4 relative; gpt_tiny under O2 (bf16 at head dim 32)
   takes 3 steps on the wgmma route; GPT-small in fp32 takes 1 warm-up
   and 3 timed steps at bs 18 x 1024 (step ms, tokens/s). Each counts
   its launches on its route only (4 x 3 each way for gpt_tiny, 12 x 4
   for GPT-small).
6c. GPT-small from seed 0, bs 18 x 1024, under O2 fp16 with a
   GradScaler, AdamW(LinearWarmup(CosineAnnealingDecay(1e-4,
   T_max=10), warmup 2 from 0)) with ClipGradByGlobalNorm(1.0): one
   warm-up and 10 timed steps; losses finite and falling, K2/K3 12 x 11
   launches on the wgmma_f16 route only; the loss scale and the
   rejected steps, step ms, tokens/s and peak memory beside phase 6's.
   First `amp.nonfinite` (found_inf) finds a NaN and an inf in fp32,
   bf16 and fp16 tensors on the card.
6d. O1 on GPT-small (fp32 parameters, bs 8 x 1024): 3 steps in bf16
   and 3 in fp16 with a GradScaler; 12 x 3 launches each way on the
   matching route only; losses finite.
6e. dropout and remat on GPT-small at bs 8 x 1024, O2 bf16: one step's
   loss and every gradient with dropout 0.1 bitwise equal with remat
   on and off; then 3 steps in each of four runs: dropout 0.1 (dense
   attention, 12 calls per forward, K2/K3 0) with remat off and on
   (24 calls per step), dropout 0 with remat on (K2 24 and K3 12
   launches per step) and off (12 and 12); peak memory of each.
6f. each of the 10 optimizer rules (with its decay) takes 2 steps of
   gpt_tiny fp32 on the card (tf32x3 route, TF32 off) and on the CPU:
   ||move_card - move_cpu|| / ||move_cpu|| <= 2e-2 over all parameters,
   losses within 1e-4.
6g. ResNet-50 at bench.py's configuration (`resnet50(num_classes=1000,
   data_format="NHWC", stem_s2d=True)`, Momentum(0.1, 0.9),
   cross-entropy, O2 bf16, a device-resident batch of 128 x 224 x 224,
   `loop_unroll=2`) through `Trainer.train_steps`, cudnn.benchmark off
   (on, it bought nothing measurable: `scripts/resnet_probe.py`): 3
   warm-up and 10 timed steps;
   every loss finite, one below the first (at lr 0.1 it falls, then
   oscillates); every BatchNorm buffer moved and fp32, parameters bf16
   but BatchNorm's fp32, an fp32 master for exactly the bf16 ones. Step
   ms, images/s, peak memory, the step's compute bound (convolution and
   fc FLOPs, forward and both gradients, counted by
   `torch.utils.flop_counter`, over 989 TFLOP/s) and one profiled step
   by kernel group with the device's busy share.
6h. config 1 through its entry point: `hapi.Model(resnet50(
   num_classes=10))` with Momentum(0.05, 0.9, weight_decay=5e-4),
   `CrossEntropyLoss` and `Accuracy`, `fit` for one epoch over
   `DataLoader(Cifar10(mode="train", transform=Compose([
   RandomHorizontalFlip, Normalize(HWC), Transpose])), batch_size=64,
   shuffle=True)` on the synthetic fallback (1024 images), then
   `evaluate` on the test split: 16 steps, finite loss and accuracy;
   images/s of the epoch including the loader.
6i. fp32 with TF32 off: 3 Trainer steps of ResNet-18 (10 classes, NHWC,
   stem_s2d) at 8 x 32 x 32, Momentum(1e-3, 0.9), on the card and on
   the CPU from one seed, each of the card's steps started from the
   CPU's state (the free-running fp32 trajectory is not comparable: a
   ReLU input whose sign one rounding flips re-routes a gradient):
   losses within
   1e-4 relative, every parameter, BatchNorm buffer and velocity within
   1e-3 of its largest magnitude (the CPU tests' limits); on the card,
   NHWC == NCHW and stem_s2d == conv1 (logits within 2e-5, gradients
   within 1e-4).
6j. ERNIE-3.0-base at bench.py's accelerator configuration
   (`bench_ernie`: `BertForSequenceClassification(ernie_base(), 2)`
   from seed 0, AdamW(2e-5), cross-entropy, O2 bf16, dropout 0.1
   everywhere, a device-resident batch of 64 x 128 ids from numpy seed
   0) through `Trainer.train_steps`: 3 warm-up and 10 timed steps;
   attention dropout sends every layer to `attention_dense`
   (`DENSE_ATTENTION_CALLS` = 12 a forward), K2/K3 launch 0 times;
   every loss finite. Step ms, seq/s, peak memory, the compute bound
   (6 x the matmul parameters x tokens plus attention's six products,
   over 989 TFLOP/s) and one profiled step by kernel group with the
   device's busy share.
6k. the kernel route: the same model (seed 0) and batch with
   `attention_dropout=0`: K2 and K3 12 launches a step each on the
   wgmma route (non-causal, packed qkv, s 128), 0 dense calls, step ms
   beside 6j's; an eval forward of the 64 x 128 batch (no mask): K2 12,
   K3 0; and `examples/finetune_bert.py`'s loop at `ernie_base` (bs 16
   x 128, 30 steps, AdamW(LinearWarmup(CosineAnnealingDecay(2e-5,
   T_max=30), 3 from 0), weight_decay=0.01), the shifted-token
   synthetic data) with `attention_dropout=0`: finite losses, K2/K3 12
   x 30.
6l. padded batches and the other heads: `text.Imdb` (the synthetic
   fallback, 512 reviews of 16-63 tokens) through `io.DataLoader` with a
   collate that pads to 64 and makes `attention_mask`, into
   `hapi.Model(ernie, inputs=[ids, token types, mask]).fit` for one
   epoch at bs 32 under O2: 16 steps, dense attention only (12 calls a
   forward), K2/K3 0, seq/s; one O2 AdamW step of
   `BertForMaskedLM(ernie_base())` at 16 x 128 (the head tied to the
   word embedding; finite loss); and a 2-layer BERT (hidden 128, 2
   heads) in fp32 with TF32 off and dropout 0, 3 SGD steps on the card
   and on the CPU, each of the card's from the CPU's state, without and
   with a padding mask (tf32x3 K2/K3 vs dense): losses and every
   parameter within 1e-4.
6m. ResNet-50 (`resnet50()`, NCHW, 224^2, fp32, TF32 off, cuDNN's
   deterministic algorithms) through `jit.to_static` (`torch.export`):
   an eval forward of 64 images equals the eager one, and one
   Momentum(0.1, 0.9) step in train mode on 16 of them through the
   captured program
   equals one eager step from the same state (loss, every parameter,
   every BatchNorm buffer, which the captured program writes in
   place), each within 1e-5 of the largest magnitude.
6n. `jit.save` of ResNet-50 (seed 0, eval) with InputSpec([None, 3,
   224, 224]); a fresh process that imports only paddle_tpu_torch
   (jax and paddle_tpu blocked) builds an `inference.Predictor` on the
   card and serves batches 1, 8 and 64 against this process's eager
   outputs (within 1e-5): 3 entries in `_compiled`, each one CUDA
   graph, a repeated batch reusing its entry; per batch the eager
   forward ms, the Predictor's `run` ms (numpy in and out), its graph
   replay ms on device-resident input, and images/s.
6o. ERNIE-base (`BertForSequenceClassification(ernie_base(), 2)`, bf16,
   eval) exported with InputSpec([None, 128], int64) x 2 (ids, token
   types; no mask: K2's wgmma route): a Predictor at 64 x 128 whose
   replay launches K2 12 times and no dense attention, within bf16's
   atol = rtol = 2e-2 of the eager forward (Predictor and eager ms
   logged); `jit.load` and one SGD step on the loaded layer over 16 x
   128 (lr a tenth of loss / |g|^2): K2 12 and K3 12 launches (K3
   through the forward operator's registered backward), the loss on
   the same batch falls.
6p. dy2static on the card: a function and a Layer with a traced if /
   elif, a while with a break and a for over a traced bound with an
   early return, exported (`torch.cond` / `while_loop` nodes) and
   equal to the eager (Python-path) call, bitwise, on inputs through
   each branch; `jit.save` of each and the Predictor serving the
   program eagerly (its `eager_reason`: no CUDA graph), equal outputs.
   6k's host enqueue of one eager ERNIE step (K2/K3 as operators) is
   logged beside PR 19's 53.7-137.6 ms.
6q. `parallel/` on the card (a mesh is k logical ranks on this one
   card): each collective over 4 ranks' CUDA tensors equal to its
   rank-order formula, bitwise, in its list and its rank (SPMD run)
   form; GPT-small fp32 (TF32 off, the tf32x3 route) takes one
   Momentum step under a dp 2 x fsdp 2 mesh at ZeRO stages 1, 2 and 3:
   against one rank's whole-batch step the loss within 1e-5 relative
   and each parameter's move within 1e-3 in relative L2 norm; against
   one rank whose grad_accum=4 microbatches are the ranks' rows, stage
   1 bitwise and stages 2-3 within 1e-5 (another order of the four
   adds); per rank, optimizer-slot bytes = the split entries' total
   over the fsdp ranks plus the entries that stay whole; a bf16 O2
   step at stage 2 finite.
6r. config 4 ("Fleet collective data-parallel ResNet-50"): bench.py's
   ResNet-50 (128 x 224^2, NHWC, stem_s2d, O2 bf16, Momentum(0.1,
   0.9)) through `DataParallel` and `Trainer(mesh=)` over 4 data ranks
   with synced batch norm: the loss falls below its first value;
   step ms, images/s, peak memory, 215 all-reduces a step (53 batch
   norms, 1 count, 161 gradients). One step at 64 x 224^2 of the 4
   ranks against one rank's whole batch: fp64 gradients and running
   statistics within 1e-9; fp32 no further from one rank's fp64 step
   than twice one rank's own fp32 step is.
6s. config 5 ("Fleet sharding stage2 + GPT-3 1.3B pretrain"):
   `gpt_1p3b` built through `fleet.init` / `distributed_model` /
   `distributed_trainer` (sharding stage 2, sharding_degree 4, AMP O2
   bf16), AdamW, global batch 8 x 2048 over 4 ranks: the loss finite
   and falling over 1 + 3 steps, K2 and K3 each launched 24 layers x
   4 ranks = 96 times a step through the wgmma route, per-rank
   optimizer-state bytes, step ms, tokens/s, peak memory. Phase 3
   holds K2/K3 at its rank shape (b 2, s 2048, h 16, d 128, causal,
   packed qkv) and phase 8 times them there.
6t. tensor parallelism (`Trainer(mesh=)` with tp 2; each rank holds
   its column, row and vocabulary shards, qkv head-aligned): GPT-small
   fp32 (TF32 off) at 4 x 1024 takes one Momentum step under dp 2 x
   tp 2 against one rank's whole-batch step (loss within 1e-5
   relative, every parameter's gradient, the first step's velocity,
   within 1e-3 in relative L2); then
   gpt_1p3b O2 bf16 (AdamW, no remat) on 8 x 2048 tokens under dp 2 x
   tp 2, a warm-up and 3 timed steps: finite and falling, K2/K3 each
   launched causal 24 layers x 4 ranks a step, step ms, tokens/s, peak
   memory, collectives a step.
6u. sequence parallelism: GPT-small's width at seq 4096 (fp32, TF32
   off), one Momentum step at sp 4 through ring and through Ulysses
   attention against sp 1 (6t's tolerances); gpt_1p3b O2 bf16 (6t's
   model) on 2 x 2048 tokens at sp 4, ring and Ulysses, a warm-up and
   2 timed steps each: finite and falling, K2/K3 launches, causal and
   full counted apart (ring: 10 chunk pairs a layer over the 4 ranks,
   the 4 diagonal ones causal and the 6 below it full; Ulysses: one
   causal call a rank and layer), ppermutes (ring: k and v, 3 hops
   each, 6 a layer, 144 a step) and all_to_alls (Ulysses, 96 a step)
   as the schedules give them, step ms, peak memory.
6v. pipeline parallelism: a `PipelineStack` of 12 GPT-small-width
   `GPTBlock`s (fp32, TF32 off) at pp 4 with 8 microbatches, at v 1 and
   v 3: loss within 1e-5 relative and gradients within 1e-4 in relative
   L2 of the sequential stack's, `_num_ticks` ppermutes.
6w. expert parallelism: `MoELayer` (768 -> 3072, 8 experts, top-2, a
   capacity that drops no token, checked) over 8 x 1024 tokens, ep 4
   against the dense route in fp32 within 1e-5 of the largest output;
   one O2 bf16 training step at ep 4 timed. Phase 3 holds K2/K3 at
   the model-parallel rank shapes of 6t and 6u (tp 2: b 4, h 8; Ulysses
   sp 4: b 2, h 4, s 2048; the ring's 512 x 512 chunk pairs, diagonal
   causal and below it full; d 128) and phase 8 times them there.
6x. int8 error-feedback compression: `compressed_grad_step` on
   GPT-small (fp32, TF32 off) over dp 2 at 6q's batch (8 x 256), 3
   Momentum steps: each step's mean of every tensor and both ranks' new
   residuals equal the formula over the ranks' fp32 locals, bitwise;
   losses within 1e-2 relative of exact dp (`Trainer(mesh=)` dp 2);
   the codes cross as int8 (the wire counter), fp32 only as scalars;
   K2/K3 2 ranks x 12 layers a step.
6y. `LocalSGD` on GPT-small over dp 2, k 4, 2 rounds (AdamW): one
   exchange a round, the state after it the ranks' mean bitwise, K2/K3
   2 x 4 x 12 a round.
6z. `init_multislice_mesh(dcn={"dp": 2}, ici={"fsdp": 2})` and the
   grid that is not row-major (dcn fsdp, ici dp): one GPT-small step
   bitwise the `init_mesh(dp=2, fsdp=2)` step; `auto.Engine` over 4
   ranks (plan, two `fit_batch` steps); `Calibrator.fit` over
   `time_step_fn` times of three plans (fitted mfu and link rate).
9a. several processes on the one card: `launch_local` of 2 workers
   (this script with `--worker gang`): the gloo group, the host plane
   and `fleet.metrics`' AUC across them; GPT-small on a dp 2 mesh
   spanning the processes, 3 steps, losses and parameters bitwise the
   one-process dp 2 mesh's; 0 kernel builds in the workers (they load
   the kernels this run built); a step's time and the exchange's D2H,
   gather and H2D beside one process's step; each worker's stages.
9b. `ElasticController` over 2 workers (`--worker elastic`): GPT-small
   width at 2 layers on a dp 2 mesh spanning them, `AutoCheckpoint`
   every step; worker 1 dies after step 3 of 5, the gang relaunches and
   resumes, every loss equal to an uninterrupted one-process run's;
   each worker's K2/K3 launches = layers x its steps, 0 builds.
   6x-9b print their seconds each and together.
10a. the op sweep on the card: every case of
   `paddle_tpu_torch/testing/op_cases.py` (the CPU tests' table) on the
   card against the port's own result on the CPU, TF32 off, each case's
   tolerance, its gradient where it takes one, every tensor result on
   cuda; the random ops reproducible under `seed` and within their law;
   matmul 4096^2, logsumexp / log_softmax / softmax over (18 x 1024,
   50304) logits, topk / sort / argsort over 50304, gather /
   index_select / scatter on a 50304 x 768 table, cumsum over 1M, each
   within its stated tolerance of the CPU (exact ones bitwise); 0
   failed. Prints the ops run and its seconds.
10b. the reference's training idiom on GPT-small (12 layers, bf16
   parameters, fp32 norms) at 18 x 1024: `pt.seed(0)`, then
   `pt.value_and_grad(loss_fn)(params)` over `pt.functional_call` and
   `model.loss`, loss and every gradient bitwise `torch.autograd.grad`'s
   over the same function, 12 K2 and 12 K3 launches on the wgmma route,
   0 dense attention calls; `jacobian`, `hessian`, `jvp`, `vjp`, a
   PyLayer and grad of grad on small functions, card against CPU
   within rtol 1e-5, atol 1e-6. 10a-10b print their seconds each and
   together.
11a. the vision zoo at full width: each of the 23 constructors of
   `models/vision.py` and `vision_extra.py`, and `vgg16(batch_norm=
   True)`, built on the card from a seed with 1000 classes; parameter
   and buffer counts equal to the JAX package's (the CPU tests' pinned
   table), `summary`'s totals equal to them; an fp32 eval forward at
   batch 2 (LeNet at 1 x 28^2, InceptionV3 at 299^2, the rest at 224^2,
   TF32 off) finite and of shape (2, 1000); one constructor per family
   (11) against the port on the CPU from the same state, within 1e-4
   of the largest logit.
11b. mobilenet_v2 (scale 1.0, 102 classes, fp32 as phase 6h) trained
   20 steps at 64 x 224^2 through `hapi.Model.fit`: synthetic
   `Flowers` through `RandomResizedCrop(224)`, `ColorJitter(0.4, 0.4,
   0.4)`, `RandomHorizontalFlip`, `Normalize` and `Transpose` on 8
   thread workers, batches stacked by the native collate; Momentum
   under a cosine schedule stepped by `LRSchedulerCallback`,
   `EarlyStopping` on the eval loss of the valid split, `VisualDL`
   into a temporary directory. The loss falls (the mean of the last 5
   steps under the first 5's) and the scalars file holds every step.
   Prints step ms, images/s, peak memory and the share of wall time
   waiting on the loader.
11c. quantized convolutions at full width: PTQ of resnet50 (1000
   classes, fp32, TF32 off) calibrated on 4 batches of 32 x 224^2 and
   converted: 53 `Int8Conv2D` and 1 `Int8Linear`, no float Conv2D or
   Linear left; the int32 accumulators and the whole forward (rescale
   and bias) of all 53 `Int8Conv2D` layers and of a converted
   mobilenet_v2's expand and depthwise layers bitwise the port's CPU
   version on the same input; the codes each device's own forward
   hands the layers, compared, with the first layer where they differ
   and how close to a rounding boundary its inputs lie there; the
   converted logits within 2e-2 of the largest of the CPU's, and
   closer than the int8 model is to the float one; top-1 agreement with the float model on the
   calibration batch and the int8 forward's ms against the float's;
   one QAT step of a QuantedConv2D resnet18 on the card.
11d. the new layers and the collate: the transposed convolutions
   within 1e-5, the 1-D / 3-D max and average pools, the adaptive
   pools and `MaxPool2D(return_mask=True)` on ReLU outputs (ties) card
   against CPU, max values and indices bitwise, averages within 1e-6;
   the native collate of 64 x 3 x 224 x 224 float32 samples bitwise
   `np.stack`'s, both timed. 11a-11d print their seconds each and
   together.
7. gradients of one step of a full-width 2-layer GPT-small (bs 8 x
   1024, bf16 O2 parameters, and again in fp16) through the kernels
   against the same step with the plain versions swapped in on the
   same CUDA tensors: ||g_kernel - g_plain|| / ||g_plain|| <= 3e-2 for
   every parameter.
8. numbers: K1's median time (one launch, merge included) at phase-4
   shapes and lengths beside its byte bound, the plain version's time and one
   `scaled_dot_product_attention` call over the full slab with the keep
   mask; K4, K5 and K6 the same way (their yardstick gathers pages
   and/or dequantises first); the engine through each of them; K2 and K3 at the training shape beside their bounds, plain
   versions and `scaled_dot_product_attention` (causal) forward and
   backward (yardsticks only; the port never calls it); engine
   tokens/s, decode ms/token, TTFT p50/p99 — each beside the card and
   its power limit. K3's parts (delta, dk/dv, dq) are timed one at a
   time, and each flash source's nvcc time and each flash kernel's
   registers, local (spill) bytes and dynamic shared memory are
   printed. The timer's floor under the same `time_ms`: an empty
   kernel (with and without the flush) and 96 empty CTAs in clusters
   of 8 that meet at one cluster barrier. K7 at each (k, n) of 2b's
   GPT-small and gpt_1p3b shapes with 4 bf16 rows: median after an L2
   flush, byte bound, a read-only stream over the same weight bytes
   (what a perfect GEMV could read under this timer), K7's timing
   variants (without the quantize prologue, without the cluster
   merge, without the whole reduction, without prologue and
   reduction), plain version, and two yardsticks never called by the
   port (bf16 `torch.matmul` with the fp weights, and `torch._int_mm`
   on rows padded to 32). The tf32x3 route's forward
   and backward at GPT-small's fp32 training shape (the split kernel's
   share timed alone), the wgmma route at phase 3's bf16 d 32 shape and
   the wgmma_f16 route at the training shape (fp16 packed qkv) and
   the wgmma route at ERNIE's shape (non-causal; its yardstick
   non-causal too) and at 6s', 6t's and 6u's gpt_1p3b rank shapes, each
   beside their bounds (fp32: three TF32 products over 495 TFLOP/s, and
   the FFMA bound over 67 TFLOP/s), plain versions,
   `scaled_dot_product_attention` (TF32 off), and each kernel's
   registers and spills.
Then one JSON line of kernel records and, last, the device line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet, device memory
FP32_FLOPS = 67e12               # H100 SXM data sheet, fp32 non-tensor
TF32_FLOPS = 495e12              # H100 SXM data sheet, TF32 dense tensor
BF16_FLOPS = 989e12              # H100 SXM data sheet, bf16 dense tensor
INT8_OPS = 1979e12               # H100 SXM data sheet, int8 dense tensor
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2),
       # fp16 (the wgmma_f16 route): ten times tighter than bf16's, for
       # three more mantissa bits (largest seen at the training shape:
       # out 9.8e-4, gradients 6e-4 of their largest magnitude)
       "float16": dict(atol=2e-3, rtol=2e-3)}
FP16_MAX = 65504.0


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def log(msg: str):
    print(msg, flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


# --------------------------------------------------------------------------- #
# phase 2: the kernel against its plain version
# --------------------------------------------------------------------------- #

# T = 1024 (GPT-small's max_seq: 8 CTAs per lane and head), 256 (2) and
# 64 (1), the fused kernel's cluster sizes C(T)
DECODE_T = (1024, 256, 64)


def kernel_cases(torch, T: int, block_k: int):
    full = [0, 1, block_k - 1, block_k, block_k + 1, 513, T - 1, T]
    verify_lengths = [100, 101, 102, 700, 701, 702, 5, 6]
    verify_slots = [0, 0, 0, 1, 1, 1, 2, 2]
    for dtype in (torch.float32, torch.bfloat16):
        for ns in (1, 2):
            yield f"{str(dtype)[6:]} splits={ns}", dtype, ns, full, None
        yield (f"{str(dtype)[6:]} verify slot_map", dtype, 2,
               verify_lengths, verify_slots)


def phase_kernel(torch, dec):
    """K1 (fused: its split ranges merged inside the launch through a
    thread-block cluster) against the full-slab reference and against
    the plain split-K version + merge, at each T of DECODE_T; visit
    counts exact; NaN in dead rows leaves the output bitwise unchanged.
    Lengths past T are clipped to T by every version."""
    S, nh, hd = 8, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for T in DECODE_T:
        block_k, _ = dec.pick_decode_blocks(T, hd, torch.bfloat16)
        for name, dtype, ns, lengths, slots in kernel_cases(torch, T,
                                                            block_k):
            if T % (block_k * ns):
                continue
            name = f"T {T} (C {dec.cluster_size(T)}) {name}"
            B = len(lengths)
            q = torch.randn(B, nh, hd, device="cuda", generator=gen).to(dtype)
            kc = torch.randn(S, T, nh, hd, device="cuda",
                             generator=gen).to(dtype)
            vc = torch.randn(S, T, nh, hd, device="cuda",
                             generator=gen).to(dtype)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            smap = None if slots is None else torch.tensor(
                slots, dtype=torch.int32, device="cuda")
            dec.LAUNCHES.reset()
            out, visits = dec.ragged_decode_attention(
                q, kc, vc, lens, slot_map=smap, block_k=block_k,
                num_splits=ns, with_stats=True)
            torch.cuda.synchronize()
            check(dec.LAUNCHES.count == 1, f"{name}: {dec.LAUNCHES.count} "
                                           f"launches for one call")
            ref = dec.ragged_decode_reference(q, kc, vc, lens, slot_map=smap)
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[str(dtype)[6:]]
            check(bool(torch.isfinite(out).all()),
                  f"{name}: non-finite output")
            torch.testing.assert_close(out.float(), ref.float(), **tol)
            # visit counts: clip(ceil((len - split_start) / block_k), 0,
            # blocks), the reference's arithmetic for its (block_k, ns)
            rows = T // ns
            want = [[min(max(-(-(n - p * rows) // block_k), 0),
                         rows // block_k) for p in range(ns)]
                    for n in lengths]
            check(visits.cpu().tolist() == want,
                  f"{name}: visits {visits.cpu().tolist()} != {want}")
            # against the plain split-K version and its merge
            sm = smap if smap is not None else torch.arange(
                B, dtype=torch.int32, device="cuda")
            plain = dec.ragged_decode_split_plain(
                q, kc, vc, lens, sm, 1 / math.sqrt(hd), block_k, ns)
            want_out = dec._merge_splits(*plain[:3], q.dtype)
            torch.testing.assert_close(out.float(), want_out.float(),
                                       **PLAIN_TOL[str(dtype)[6:]])
            check(plain[3].tolist() == want, f"{name}: plain visits")
            # dead rows are never read: NaN there leaves the output
            # unchanged
            keep = (torch.arange(T, device="cuda")[None, :]
                    < lens[:, None].long())
            kn, vn = kc.clone(), vc.clone()
            live = torch.zeros(S, T, dtype=torch.bool, device="cuda")
            for b, s in enumerate(sm.tolist()):
                live[s] |= keep[b]
            kn[~live] = float("nan")
            vn[~live] = float("nan")
            out_nan = dec.ragged_decode_attention(
                q, kn, vn, lens, slot_map=smap, block_k=block_k,
                num_splits=ns)
            torch.cuda.synchronize()
            check(torch.equal(out_nan, out), f"{name}: a dead row was read")
            worst = max(worst, err)
            log(f"  K1 {name}: max|kernel - reference| = {err:.3e} "
                f"(atol=rtol={tol['atol']:g}), within "
                f"{PLAIN_TOL[str(dtype)[6:]]['atol']:g} of plain split + "
                f"merge, visits exact, dead rows unread, one launch")
    return worst


# --------------------------------------------------------------------------- #
# phase 2a: K4, K5, K6 against their plain versions
# --------------------------------------------------------------------------- #

PAGE = 64                       # the engine's default page at max_seq 1024
PLAIN_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def serving_lengths(np, T: int):
    """The first 8 phase-4 requests' lengths halfway through their 64
    new tokens (the rows a decode step of that run attends)."""
    return [min(int(p.size) + 32, T)
            for p in make_prompts(np, 16, 16, 700, 50304, seed=1)[:8]]


def page_tables(torch, gen, S, T, lengths, page):
    """Shuffled block tables for S lanes of T rows: each lane's bound
    pages (enough for its length) at random page ids, 0 (the trash page)
    past them, and spare pages left unbound. Returns (tables, number of
    pages, live mask (num_pages, page) of the rows below each length)."""
    maxp = T // page
    num_pages = 1 + S * maxp + 7
    ids = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    tables = ids[:S * maxp].reshape(S, maxp).to(torch.int32)
    live = torch.zeros(num_pages, page, dtype=torch.bool, device="cuda")
    for s, n in enumerate(lengths):
        nb = -(-n // page)
        tables[s, nb:] = 0
        for j in range(nb):
            live[int(tables[s, j]), :min(page, n - j * page)] = True
    return tables, num_pages, live


def to_pages(torch, x, tables, num_pages, page):
    """Slotted rows x (S, T, ...) scattered into a (num_pages, page,
    ...) pool through `tables` (bound pages only; the rest stay 0)."""
    pool = torch.zeros((num_pages, page) + tuple(x.shape[2:]),
                       dtype=x.dtype, device="cuda")
    S, maxp = tables.shape
    for s in range(S):
        for j in range(maxp):
            pid = int(tables[s, j])
            if pid:
                pool[pid] = x[s, j * page:(j + 1) * page]
    return pool


def paged_cases(torch, np):
    """(T, dtype, name, lengths) of phase 2a: each T of DECODE_T, fp32
    and bf16, the edge lengths and the serving lengths, clipped to T."""
    for T in DECODE_T:
        for dtype in (torch.float32, torch.bfloat16):
            yield T, dtype, "edges", [min(n, T) for n in (
                0, 1, PAGE - 1, PAGE, PAGE + 1, 513, T - 1, T)]
            yield T, dtype, "serving", [min(n, T) for n in
                                        serving_lengths(np, 1024)]


def hold_paged_kernels(torch, dec, gen, S, T, page, dtype, lengths, names,
                       tag):
    """Hold each kernel of `names` (of K4, K5, K6) against its plain
    version (split + merge) on the same CUDA tensors: S lanes of T rows,
    nh 12, hd 64, `page`-row pages at shuffled ids; visit counts exact;
    NaN in dead rows and on the trash page (in the scales, for int8
    codes) leaves the output bitwise unchanged; K4 == K1 and K6 == K5
    bitwise on the same rows (where both ran). Returns {name: max
    |kernel - plain|}."""
    from paddle_tpu_torch.quantization.kv import kv_quantize
    nh, hd = 12, 64
    scale = 1 / math.sqrt(hd)
    tol = PLAIN_TOL[str(dtype)[6:]]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn(S, nh, hd, device="cuda", generator=gen).to(dtype)
    kc = torch.randn(S, T, nh, hd, device="cuda", generator=gen).to(dtype)
    vc = torch.randn(S, T, nh, hd, device="cuda", generator=gen).to(dtype)
    kq, ks = kv_quantize(kc)
    vq, vs = kv_quantize(vc)
    sm = torch.arange(S, dtype=torch.int32, device="cuda")
    keep = (torch.arange(T, device="cuda")[None, :]
            < lens[:, None].long())                  # (S, T)
    tables, npages, live = page_tables(torch, gen, S, T, lengths, page)
    kp, vp, kqp, vqp, ksp, vsp = (
        to_pages(torch, x, tables, npages, page)
        for x in (kc, vc, kq, vq, ks, vs))
    cases = {
        "K4": (dict(paged=True), (kp, vp, None, None)),
        "K5": (dict(paged=False), (kq, vq, ks, vs)),
        "K6": (dict(paged=True), (kqp, vqp, ksp, vsp))}
    outs, errs = {}, {}
    for kname in names:
        how, (k_, v_, ks_, vs_) = cases[kname]
        if how["paged"]:
            bk, ns = dec.pick_paged_decode_blocks(T, page, hd, k_.dtype)
            run = lambda k_, v_, ks_, vs_, bk=bk, ns=ns: \
                dec.paged_ragged_decode_attention(
                    q, k_, v_, tables, lens, block_k=bk,
                    num_splits=ns, with_stats=True, k_scale=ks_,
                    v_scale=vs_)
            plain = dec.paged_decode_split_plain(
                q, k_, v_, tables, lens, scale, bk, ns, ks_, vs_)
        else:
            bk, ns = dec.pick_decode_blocks(T, hd, k_.dtype)
            run = lambda k_, v_, ks_, vs_, bk=bk, ns=ns: \
                dec.ragged_decode_attention(
                    q, k_, v_, lens, block_k=bk, num_splits=ns,
                    with_stats=True, k_scale=ks_, v_scale=vs_)
            plain = dec.ragged_decode_split_plain(
                q, k_, v_, lens, sm, scale, bk, ns, ks_, vs_)
        out, visits = run(k_, v_, ks_, vs_)
        torch.cuda.synchronize()
        want = dec._merge_splits(*plain[:3], q.dtype)
        check(bool(torch.isfinite(out).all()),
              f"{kname} {tag}: non-finite output")
        torch.testing.assert_close(out.float(), want.float(), **tol)
        err = (out.float() - want.float()).abs().max().item()
        rows = T // ns
        exp = [[min(max(-(-(n - p * rows) // bk), 0), rows // bk)
                for p in range(ns)] for n in lengths]
        check(visits.cpu().tolist() == exp == plain[3].tolist(),
              f"{kname} {tag}: visits {visits.cpu().tolist()} != {exp}")
        # dead rows and the trash page never read: NaN there (in the
        # scales, for int8 codes) leaves the output unchanged
        nan = float("nan")
        if how["paged"]:
            dead = ~live
            if ks_ is None:
                out_nan, _ = run(k_.masked_fill(dead[..., None, None], nan),
                                 v_.masked_fill(dead[..., None, None], nan),
                                 None, None)
            else:
                out_nan, _ = run(k_, v_,
                                 ks_.masked_fill(dead[..., None], nan),
                                 vs_.masked_fill(dead[..., None], nan))
        else:
            out_nan, _ = run(k_, v_,
                             ks_.masked_fill(~keep[..., None], nan),
                             vs_.masked_fill(~keep[..., None], nan))
        torch.cuda.synchronize()
        check(torch.equal(out_nan, out),
              f"{kname} {tag}: a dead row was read")
        outs[kname], errs[kname] = out, err
        log(f"  {kname} {tag} (block_k {bk}, splits {ns}): max|kernel - "
            f"plain| = {err:.3e} (atol=rtol={tol['atol']:g}), visits "
            f"exact, dead rows and trash page unread")
    # the addressing seam does not change the arithmetic
    if "K4" in outs:
        k1 = dec.ragged_decode_attention(q, kc, vc, lens)
        torch.cuda.synchronize()
        check(torch.equal(outs["K4"], k1), f"K4 != K1 bitwise ({tag})")
    if "K5" in outs and "K6" in outs:
        check(torch.equal(outs["K6"], outs["K5"]),
              f"K6 != K5 bitwise ({tag})")
    return errs


def phase_paged_quant_kernels(torch, np, dec):
    """K4 (paged), K5 (int8) and K6 (paged int8) at the serving shapes
    and each T of DECODE_T against their plain versions (split + merge)
    on the same CUDA tensors; visit counts; NaN in dead rows and on the
    trash page leaves the output bitwise unchanged; K4 ≡ K1 and K6 ≡ K5
    bitwise on the same rows. Lengths are clipped to T."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {"K4": 0.0, "K5": 0.0, "K6": 0.0}
    for T, dtype, lname, lengths in paged_cases(torch, np):
        tag = f"T {T} {str(dtype)[6:]} {lname}"
        errs = hold_paged_kernels(torch, dec, gen, 8, T, PAGE, dtype,
                                  lengths, ("K4", "K5", "K6"), tag)
        for k, e in errs.items():
            worst[k] = max(worst[k], e)
        log(f"  {tag}: K4 == K1 and K6 == K5 bitwise")
    return worst


# --------------------------------------------------------------------------- #
# phase 2b: K7 against its plain version
# --------------------------------------------------------------------------- #

# (k, n) of GPT-small's block linears (qkv, out, fc1, fc2) and of the
# int8 draft's tied head
INT8_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768),
               (768, 50304))
# (k, n) of gpt_1p3b's block linears (hidden 2048)
INT8_1P3B_SHAPES = ((2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048))
HALF_SX = 1.0 / 64      # a power of two: (c + 0.5) * sx is exact in bf16


# (k, n) cases through the wrapper beyond the models' shapes: k no
# multiple of 4 at n = 16 and 48 (one and three column groups), and a k
# shorter than one split of the launch plan
INT8_EDGE_SHAPES = ((100, 16), (100, 48), (20, 768))


def int8_inputs(torch, gen, m, k, n, dtype):
    """x (m, k) in `dtype` whose first row holds exact code half-points
    ((c + 0.5) * sx for c in -3..3, and +-127.5 * sx) at sx = 1/64,
    int8 weights (k, n), weight scales (n,) in `dtype`, sx, and fp32
    and bf16 biases."""
    x = torch.randn(m, k, device="cuda", generator=gen) * 0.5
    halves = torch.tensor([-3.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5,
                           127.5, -127.5], device="cuda") * HALF_SX
    x[0, :halves.numel()] = halves[:k]
    qw = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                       dtype=torch.int8)
    ws = (torch.rand(n, device="cuda", generator=gen) * 0.01).to(dtype)
    b = torch.randn(n, device="cuda", generator=gen)
    sx = torch.tensor(HALF_SX, device="cuda")
    return x.to(dtype), qw, ws, sx, {"no bias": None, "fp32 bias": b,
                                     "bf16 bias": b.bfloat16()}


def phase_int8_kernel(torch, k7):
    """K7 against its plain version on the same CUDA tensors: equal bit
    for bit at every shape (GPT-small's, gpt_1p3b's block linears and
    the edge cases), row count, dtype and bias."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = 0
    for k, n in INT8_SHAPES + INT8_1P3B_SHAPES + INT8_EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for m in (1, 2, 3, 4):
                x, qw, ws, sx, biases = int8_inputs(torch, gen, m, k, n,
                                                    dtype)
                for bname, b in biases.items():
                    out = k7.int8_linear_fused(x, qw, ws, sx, b)
                    want = k7.int8_linear_plain(x, qw, ws, sx, b)
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(out).all()),
                          f"K7 {k}x{n} m={m} {dtype} {bname}: non-finite")
                    err = (out.float() - want.float()).abs().max().item()
                    check(torch.equal(out, want),
                          f"K7 {k}x{n} m={m} {dtype} {bname}: max|kernel "
                          f"- plain| = {err:.3e}, not bitwise")
                    cases += 1
        log(f"  K7 {k}x{n} ({k7.launch_plan(4, k, n, sms)} at 4 rows): "
            f"rows 1-4, fp32 and bf16 x, no / fp32 / bf16 bias, half-point "
            f"codes: kernel == plain bitwise")
    log(f"  K7: {cases} cases bitwise equal; max|kernel - plain| = 0")
    return 0.0


# --------------------------------------------------------------------------- #
# phase 3: K2 and K3 against their plain versions
# --------------------------------------------------------------------------- #

FLASH_SHAPE = dict(b=18, s=1024, h=12, d=64)     # GPT-small, bench.py bs
ERNIE_SHAPE = dict(b=64, s=128, h=12, d=64)      # ernie_base, bench.py bs
P1B_RANK_SHAPE = dict(b=2, s=2048, h=16, d=128)  # gpt_1p3b, one of 4 ranks
# gpt_1p3b's model-parallel rank shapes (d 128): name -> (b, s, h,
# causal, packed qkv); phase 3 holds them, phase 8 times them
MP_FLASH_SHAPES = {
    "gpt_1p3b tp 2 rank shape": (4, 2048, 8, True, True),      # 6t
    "gpt_1p3b Ulysses sp 4 rank shape": (2, 2048, 4, True, False),  # 6u
    "gpt_1p3b ring diagonal pair": (2, 512, 16, True, True),   # 6u
    "gpt_1p3b ring pair below the diagonal": (2, 512, 16, False, True)}


def flash_inputs(torch, gen, b, sq, sk, h, d, packed, dtype=None):
    """q, k, v (b, s, h, d) and a cotangent g in `dtype` (bf16 by
    default); `packed` gives q, k, v as the strided slices of one
    (b, s, 3, h, d) tensor, the layout the model's fused qkv projection
    hands the kernels; "odd" the same slices of rows one element longer
    (strides no multiple of 16 bytes: the tf32x3 route's split kernel
    takes them, TMA would not)."""
    dtype = dtype or torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    if packed == "odd":
        rows = rnd(b, sq, 3 * h * d + 1)[..., :3 * h * d]
        qkv = rows.unflatten(-1, (3, h, d))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    elif packed:
        qkv = rnd(b, sq, 3, h, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = rnd(b, sq, h, d), rnd(b, sk, h, d), rnd(b, sk, h, d)
    return q, k, v, rnd(b, sq, h, d)


def flash_cases(torch):
    """(name, b, sq, sk, h, d, causal, packed, dtype): bf16 d 64 and
    128 cases, then the fp32 (tf32x3) and bf16 d 32 ones."""
    f, bf, f32 = FLASH_SHAPE, torch.bfloat16, torch.float32
    yield ("training shape", f["b"], f["s"], f["s"], f["h"], f["d"], True,
           True, bf)
    yield "sq < sk", 4, 256, 1024, 12, 64, True, False, bf
    yield "s 1000", 4, 1000, 1000, 12, 64, False, False, bf
    yield "s 1000 causal", 4, 1000, 1000, 12, 64, True, False, bf
    yield "d 128", 4, 512, 512, 8, 128, True, False, bf
    # the edges of the TMA tiles
    yield "d 128 packed", 4, 512, 512, 8, 128, True, True, bf
    yield "sq 200, sk 1000", 2, 200, 1000, 12, 64, True, False, bf
    yield "sq 1, sk 333", 2, 1, 333, 12, 64, True, False, bf
    yield "b x h 1024", 32, 128, 128, 32, 64, False, False, bf
    # rows with no visible key (causal sq > sk) and b x h past 65535
    yield "causal sq 1024, sk 256", 4, 1024, 256, 12, 64, True, False, bf
    # the edge between empty and live rows inside a K2 warpgroup and a K3
    # query tile (row 100), and between K2's two warpgroups (row 64)
    yield "causal sq 300, sk 200", 2, 300, 200, 12, 64, True, False, bf
    yield "d 128 sq 1000, sk 900", 2, 1000, 900, 8, 128, True, False, bf
    yield "causal sq 1000, sk 936", 2, 1000, 936, 12, 64, True, False, bf
    yield "b x h 66000", 5500, 128, 128, 12, 64, False, False, bf
    # fp32 (the tf32x3 route) at d 32, 64, 128, and bf16 at d 32 (the
    # 64-byte swizzle) on the edges d 64 takes; the main paths' shapes:
    # phase 6b's GPT-small fp32 and gpt_tiny O2
    yield ("fp32 training shape", f["b"], f["s"], f["s"], f["h"], f["d"],
           True, True, f32)
    yield "fp32 d 32", 4, 512, 512, 8, 32, True, False, f32
    yield "fp32 d 128", 2, 512, 512, 8, 128, True, False, f32
    yield "fp32 sq 200, sk 333", 2, 200, 333, 12, 64, False, False, f32
    yield "fp32 causal sq 300, sk 200", 2, 300, 200, 12, 64, True, False, f32
    yield "bf16 d 32 packed", 4, 512, 512, 24, 32, True, True, bf
    yield "bf16 d 32", 4, 512, 512, 24, 32, True, False, bf
    yield "bf16 d 32 causal sq 300, sk 200", 2, 300, 200, 12, 32, True, \
        False, bf
    yield "bf16 d 32 sq 1, sk 333", 2, 1, 333, 12, 32, True, False, bf
    yield "bf16 d 32 gpt_tiny packed", 8, 256, 256, 4, 32, True, True, bf
    yield "fp32 d 128 sq 1000, sk 900", 2, 1000, 900, 8, 128, True, False, f32
    yield "fp32 odd strides", 2, 200, 200, 3, 64, True, "odd", f32
    # the longest preset rows (gpt_1p3b: d 128, max_seq 2048): the
    # forward's one running sum over every key tile
    yield "fp32 d 128 causal s 2048", 2, 2048, 2048, 8, 128, True, False, \
        f32
    # fp16 (the wgmma_f16 route) at d 32, 64 and 128: the training shape,
    # gpt_tiny's packed shape, the TMA edges and rows with no visible key
    h16 = torch.float16
    yield ("fp16 training shape", f["b"], f["s"], f["s"], f["h"], f["d"],
           True, True, h16)
    yield "fp16 d 32 gpt_tiny packed", 8, 256, 256, 4, 32, True, True, h16
    yield "fp16 d 128", 4, 512, 512, 8, 128, True, False, h16
    yield "fp16 sq 200, sk 1000", 2, 200, 1000, 12, 64, True, False, h16
    yield "fp16 causal sq 300, sk 200", 2, 300, 200, 12, 64, True, False, \
        h16
    yield "fp16 d 32 s 1000", 4, 1000, 1000, 12, 32, False, False, h16
    # ERNIE-3.0-base's encoder (phases 6k, 6l): non-causal on slices of
    # the packed qkv at s 128, one key tile per (b, h) pair, so K2's
    # online softmax and K3's dk/dv sweep run their first and last tile
    # with no step between, over 768 pairs
    e = ERNIE_SHAPE
    yield ("ERNIE shape", e["b"], e["s"], e["s"], e["h"], e["d"], False,
           True, bf)
    # gpt_1p3b's rank shape under config 5 (phase 6s): 8 x 2048 tokens
    # over 4 ranks, d 128, causal, slices of the packed qkv
    r = P1B_RANK_SHAPE
    yield ("gpt_1p3b rank shape", r["b"], r["s"], r["s"], r["h"], r["d"],
           True, True, bf)
    # the model-parallel rank shapes of phases 6t and 6u (gpt_1p3b, d
    # 128, causal): a tp 2 rank's 8 heads on slices of its packed qkv;
    # a Ulysses rank's 4 heads over the whole sequence (the all_to_all's
    # contiguous tensors); a ring rank's 512 x 512 chunk pairs, the
    # diagonal causal, a pair below it full (it returns the lse the
    # merge reads)
    for name, (b_, sq_, h_, causal_, packed_) in MP_FLASH_SHAPES.items():
        yield (name, b_, sq_, sq_, h_, 128, causal_, packed_, bf)


LAYOUT_NOTE = {True: ", packed qkv", "odd": ", odd strides"}


def reset_flash_counters(fa):
    for c in (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES,
              *(c for pair in fa.ROUTE_COUNTERS.values() for c in pair),
              *(c for pair in fa.CAUSAL_COUNTERS.values() for c in pair)):
        c.reset()


def no_launches(fa):
    return {r: (0, 0) for r in fa.ROUTE_COUNTERS}


def hold_flash(torch, fa, name, q, k, v, g, causal, scale, out, lse,
               grads):
    """Holds one flash call's (out, lse) and (dq, dk, dv) against the
    plain versions (the backward on the kernel's own forward, the
    residuals the autograd Function saves) at phase 3's tolerances.
    Returns max|out err|, max|lse err| over rows that see a key, and
    each gradient's max err and max err / max|plain|."""
    sq, sk = q.shape[1], k.shape[1]
    pout, plse = fa.flash_forward_plain(q, k, v, causal, scale)
    empty = fa.empty_rows(sq, sk, causal, q.device)
    fp32 = q.dtype == torch.float32
    tname = str(q.dtype)[6:]
    if fp32:
        tol_o = 1e-5 * pout.abs().max().item()
        torch.testing.assert_close(out, pout, atol=tol_o, rtol=0)
    else:
        torch.testing.assert_close(out.float(), pout.float(), **TOL[tname])
    live_lse, live_plse = lse[:, :, ~empty], plse[:, :, ~empty]
    tol_l = 1e-5 * live_plse.abs().max().item() if fp32 else 1e-3
    torch.testing.assert_close(live_lse, live_plse, atol=tol_l, rtol=0)
    check(bool((lse[:, :, empty] == -1e30).all()),
          f"{name}: an empty row's lse is not -1e30")
    err_o = (out.float() - pout.float()).abs().max().item()
    err_l = (live_lse - live_plse).abs().max().item()
    ref_o = pout.float().abs().max().item()
    del pout, plse
    plain = fa.flash_backward_plain(q, k, v, out, lse, g, causal, scale)
    check(bool((grads[0][:, empty] == 0).all()), f"{name}: empty rows' dq")
    errs, rel = [], []
    lim = 1e-5 if fp32 else TOL[tname]["rtol"]
    for gname, got, want in zip(("dq", "dk", "dv"), grads, plain):
        check(bool(torch.isfinite(got).all()), f"{name}: {gname} "
                                               f"not finite")
        e = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        check(e <= lim * ref, f"{name}: {gname} max err {e:.3e} > "
                              f"{lim:g} x max|plain| {ref:.3e}")
        errs.append(e)
        rel.append(e / ref)
    return {"out_err": err_o, "out_rel": err_o / ref_o, "lse_err": err_l,
            "grad_err": errs, "grad_rel": rel, "limit": lim,
            "empty": int(empty.sum())}


def phase_flash_kernels(torch, fa):
    """K2/K3 on both routes against their plain versions, with fp32
    products exact (TF32 off). bf16: out
    within atol = rtol = 2e-2, lse within 1e-3, gradients within 2e-2 x
    max|plain|. fp32: out and gradients within 1e-5 x max|plain|, lse
    within 1e-5 x max|plain lse| on rows that see a key. Rows with no
    visible key: lse -1e30 exactly, dq 0. Two backward runs bitwise
    equal; each case counts one launch on its route and none on the
    other. The fp32 odd-strided case (q, k, v, g through the split's hi
    copies) gives the same bits as its values in contiguous tensors
    (which TMA reads in place as their own hi parts)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {"fwd": 0.0, "bwd": 0.0, "tf32x3_fwd": 0.0, "tf32x3_bwd": 0.0,
             "fp16_fwd": 0.0, "fp16_bwd": 0.0, "fp16_grad_rel": 0.0}
    prefix = {fa.WGMMA: "", fa.TF32X3: "tf32x3_", fa.WGMMA_F16: "fp16_"}
    for name, b, sq, sk, h, d, causal, packed, dtype in flash_cases(torch):
        q, k, v, g = flash_inputs(torch, gen, b, sq, sk, h, d, packed,
                                  dtype)
        scale = 1 / math.sqrt(d)
        route = fa._check_cuda_args(q, k, v, causal)
        counters = fa.ROUTE_COUNTERS
        reset_flash_counters(fa)
        out, lse = fa._launch_fwd(q, k, v, causal, scale)
        dq, dk, dv = fa._launch_bwd(q, k, v, out, lse, g, causal, scale)
        torch.cuda.synchronize()
        counts = {r: (f.count, bw.count) for r, (f, bw) in counters.items()}
        check(counts == {r: (1, 1) if r == route else (0, 0)
                         for r in counters},
              f"{name}: launches by route {counts}, expected {route}")
        held = hold_flash(torch, fa, name, q, k, v, g, causal, scale, out,
                          lse, (dq, dk, dv))
        err_o, rel, lim = held["out_err"], held["grad_rel"], held["limit"]
        key = prefix[route] + "bwd"
        worst[key] = max(worst[key], *held["grad_err"])
        if route == fa.WGMMA_F16:
            worst["fp16_grad_rel"] = max(worst["fp16_grad_rel"], *rel)
        again = fa._launch_bwd(q, k, v, out, lse, g, causal, scale)
        check(all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again)),
              f"{name}: two backward runs differ")
        if packed == "odd":
            same = [x.contiguous() for x in (q, k, v, g)]
            o2, l2 = fa._launch_fwd(*same[:3], causal, scale)
            grads = fa._launch_bwd(*same[:3], out, lse, same[3], causal,
                                   scale)
            check(torch.equal(o2, out) and torch.equal(l2, lse) and all(
                torch.equal(x, y) for x, y in zip(grads, (dq, dk, dv))),
                f"{name}: in-place hi and copied hi differ")
            del same, o2, l2, grads
        key = prefix[route] + "fwd"
        worst[key] = max(worst[key], err_o)
        if name == "ERNIE shape":       # its own record (phase 8's line)
            worst["ernie_fwd"], worst["ernie_bwd"] = err_o, max(
                held["grad_err"])
        if name == "gpt_1p3b rank shape":
            worst["1p3b_fwd"], worst["1p3b_bwd"] = err_o, max(
                held["grad_err"])
        if name in MP_FLASH_SHAPES:     # each its own record
            worst[name] = (err_o, max(held["grad_err"]))
        n_empty = held["empty"]
        log(f"  {route} {name} (b {b}, sq {sq}, sk {sk}, h {h}, d {d}, "
            f"{str(dtype)[6:]}, causal {causal}"
            f"{LAYOUT_NOTE.get(packed, '')}"
            f"{f', {n_empty} empty rows' if n_empty else ''}"
            f"): max|out err| {err_o:.3e} ({held['out_rel']:.2e} of "
            f"max|plain|), max|lse err| {held['lse_err']:.3e}, dq/dk/dv "
            f"max err / max|plain| {rel[0]:.2e}/{rel[1]:.2e}/{rel[2]:.2e} "
            f"(limit {lim:g}); backward bitwise deterministic"
            f"{'; equal to in-place hi' if packed == 'odd' else ''}")
        del q, k, v, g, out, lse, dq, dk, dv, again
        torch.cuda.empty_cache()
    worst["fp16_overflow"] = hold_fp16_overflow(torch, fa)
    return worst


def hold_fp16_overflow(torch, fa):
    """fp16 gradients past 65504 under a loss scale: K3 and its plain
    version at the training shape with g = min(|N(0, 1)|, 3.9) x 2^14
    (finite, up to 63,898, of one sign as a gradient under a loss scale
    often is): dv sums many queries' g and overflows to inf on both.
    The finite entries agree within phase 3's fp16 limit, and the
    non-finite pattern is the same except where the finite side lies
    within one fp16 ulp of the overflow edge (fp32 sums in another order
    can round either way there)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    f = FLASH_SHAPE
    q, k, v, g = flash_inputs(torch, gen, f["b"], f["s"], f["s"], f["h"],
                              f["d"], True, torch.float16)
    g = (g.float().abs().clamp(max=3.9) * 2.0 ** 14).half()
    check(bool(torch.isfinite(g).all()), "scaled g not finite")
    scale = 1 / math.sqrt(f["d"])
    out, lse = fa._launch_fwd(q, k, v, True, scale)
    got = fa._launch_bwd(q, k, v, out, lse, g, True, scale)
    want = fa.flash_backward_plain(q, k, v, out, lse, g, True, scale)
    edge = FP16_MAX * (1 - 2 ** -11)
    res = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        fa_, fb = torch.isfinite(a), torch.isfinite(b)
        differ = fa_ != fb
        at_edge = torch.where(fa_, a.float().abs(), b.float().abs()) >= edge
        check(bool((differ <= at_edge).all()),
              f"fp16 overflow: {name} non-finite pattern differs away from "
              f"the edge ({int((differ & ~at_edge).sum())} entries)")
        both = fa_ & fb
        e = (a.float() - b.float())[both].abs().max().item()
        ref = b.float()[both].abs().max().item()
        check(e <= TOL["float16"]["rtol"] * ref,
              f"fp16 overflow: {name} finite entries max err {e:.3e} > "
              f"{TOL['float16']['rtol']:g} x {ref:.3e}")
        res[name] = {"nonfinite": int((~fa_).sum()),
                     "nonfinite_plain": int((~fb).sum()),
                     "edge_differences": int(differ.sum()),
                     "max_err_rel": e / ref}
    log("  fp16 K3 with g = min(|N(0, 1)|, 3.9) x 2^14 (training shape): "
        "non-finite entries "
        "kernel/plain " + ", ".join(
            f"{n} {r['nonfinite']}/{r['nonfinite_plain']}"
            for n, r in res.items())
        + "; finite entries' max err / max|plain| "
        + "/".join(f"{r['max_err_rel']:.2e}" for r in res.values())
        + f" (limit {TOL['float16']['rtol']:g})")
    del q, k, v, g, out, lse, got, want
    torch.cuda.empty_cache()
    return res


def tf32_bits(torch, m: int, sign: float = 1.0) -> float:
    """1 + m 2^-23 (times `sign`): an fp32 value whose 13 low bits are m."""
    x = torch.tensor([0x3F800000 | m], dtype=torch.int32).view(
        torch.float32).item()
    return sign * x


def phase_tf32_probe(torch, fa):
    """(3b) The tensor cores' TF32 arithmetic (`fa.tf32_probe`): a 64 x
    64 x 32 product at the magnitudes of scores (a, b normal) and of
    probabilities (a uniform in [0, 1), b normal): the largest error
    over max|fp64 product| of the fp32 FFMA product (TF32 off), of one
    TF32 product of the raw values, of 3xTF32 from shared memory and of
    3xTF32 with a from registers; both 3xTF32 within 1e-5. Then a[:, 0]
    = 1 + m 2^-23 for chosen low bits m (below, at and above half a
    TF32 ulp, odd and even, both signs), b[:, 0] = 1, the rest 0: the
    product is the card's TF32 reading of each value, compared with
    truncation, round-to-nearest-even and round-half-away."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    errs = {}
    for name in ("scores", "probabilities"):
        a = torch.randn(64, 32, device="cuda", generator=gen)
        if name == "probabilities":
            a = torch.rand(64, 32, device="cuda", generator=gen)
        b = torch.randn(64, 32, device="cuda", generator=gen)
        ref = a.double() @ b.double().T
        den = ref.abs().max().item()
        rec = {"fp32 FFMA": ((a @ b.T).double() - ref).abs().max().item()
               / den}
        for mode, what in ((0, "1xTF32"), (1, "3xTF32 shared"),
                           (2, "3xTF32 registers")):
            got = fa.tf32_probe(a, b, mode).double()
            rec[what] = (got - ref).abs().max().item() / den
        errs[name] = rec
        check(rec["3xTF32 shared"] <= 1e-5 and rec["3xTF32 registers"]
              <= 1e-5, f"3xTF32 probe ({name}): {rec}")
    lows = (0, 0x0FFF, 0x1000, 0x1001, 0x1800, 0x1FFF, 0x2FFF, 0x3000)
    vals = [tf32_bits(torch, m, s) for s in (1.0, -1.0) for m in lows] * 4
    a = torch.zeros(64, 32, device="cuda")
    b = torch.zeros(64, 32, device="cuda")
    a[:, 0] = torch.tensor(vals, device="cuda")
    b[:, 0] = 1.0
    got = fa.tf32_probe(a, b, 0)[:, 0].cpu()
    bits = torch.tensor(vals).view(torch.int32)
    low, odd = bits & 8191, (bits >> 13) & 1
    down = bits & -8192
    rules = {"truncate": down,
             "nearest even": down + 8192 * ((low > 4096) | ((low == 4096)
                                                            & (odd == 1))),
             "nearest, ties away": down + 8192 * (low >= 4096)}
    found = [r for r, want in rules.items()
             if torch.equal(got, want.view(torch.float32))]
    log(f"  TF32 probe, 64 x 64 x 32, error / max|fp64|: " + "; ".join(
        f"{name}: " + ", ".join(f"{k} {v:.2e}" for k, v in rec.items())
        for name, rec in errs.items()))
    log(f"  the card reads an fp32 operand as TF32 by: "
        f"{found[0] if found else 'none of ' + str(list(rules))} (low bits "
        f"{[hex(m) for m in lows]} of 1 + m 2^-23 read as "
        f"{[got[i].item() for i in range(len(lows))]})")
    check(len(found) == 1, f"TF32 reading matches {found or 'no rule'}")
    return {"errors": errs, "rule": found[0]}


# --------------------------------------------------------------------------- #
# phases 4-5: the engine
# --------------------------------------------------------------------------- #

def make_prompts(np, n, lo, hi, vocab, seed):
    rng = np.random.RandomState(seed)
    lengths = np.linspace(lo, hi, n).astype(int)
    rng.shuffle(lengths)
    return [rng.randint(0, vocab, (int(k),)).astype(np.int32)
            for k in lengths]


SERVE_KW = dict(max_slots=8, max_seq=1024, decode_block_size=8, seed=0,
                device="cuda")
# the four decode kernels and the engine knobs that select them
DECODE_VARIANTS = (("K1", {}), ("K4", dict(kv_layout="paged")),
                   ("K5", dict(kv_dtype="int8")),
                   ("K6", dict(kv_layout="paged", kv_dtype="int8")))


def decode_counters(dec):
    return {"K1": dec.LAUNCHES, "K4": dec.PAGED_LAUNCHES,
            "K5": dec.QUANT_LAUNCHES, "K6": dec.PAGED_QUANT_LAUNCHES}


def serving_load(np, SamplingParams, vocab):
    """The 16 requests of phase 4: prompts 16..700 tokens, 64 new
    tokens, 12 greedy and 4 sampled."""
    prompts = make_prompts(np, 16, 16, 700, vocab, seed=1)
    params = [SamplingParams(max_new_tokens=64) for _ in prompts]
    params[3] = SamplingParams(max_new_tokens=64, temperature=0.8)
    params[7] = SamplingParams(max_new_tokens=64, temperature=1.0, top_k=50)
    params[11] = SamplingParams(max_new_tokens=64, temperature=0.9,
                                top_p=0.9)
    params[14] = SamplingParams(max_new_tokens=64, temperature=0.7,
                                top_k=40, top_p=0.95)
    return prompts, params


def leaked_pages(eng) -> int:
    """Pages held beyond the trash page once the prefix tree's (its
    own, legitimate) pages are let go: 0 after every load."""
    if eng.prefix is not None:
        eng.prefix.clear()
    return eng.cache.pool.leaked()


SYSTEM_PROMPT = 512              # phase 4g's shared system prompt, tokens


def shared_prefix_load(np, SamplingParams, vocab):
    """The 16 requests of phase 4g: one seeded 512-token shared system
    prompt and a 16..188-token tail each, phase 4's sampling knobs (64
    new tokens, 12 greedy and 4 sampled)."""
    rng = np.random.RandomState(4)
    system = rng.randint(0, vocab, (SYSTEM_PROMPT,)).astype(np.int32)
    tails = np.linspace(16, 188, 16).astype(int)
    rng.shuffle(tails)
    prompts = [np.concatenate([system, rng.randint(0, vocab, (int(n),))
                               .astype(np.int32)]) for n in tails]
    return prompts, serving_load(np, SamplingParams, vocab)[1]


def serve(torch, dec, model, prompts, params, name, **knobs):
    """Serve the load through one engine with every decode counter set
    to 0 just before and read just after. Checks: every request
    finishes with its max_new_tokens in-range tokens; the variant's
    kernel launched tp x num_layers x decode steps times (`tp` in
    `knobs`, default 1) and no other decode kernel at all; one host sync
    per dispatch; at tp > 1, 2 L + 2 collectives per forward (each
    prefill call and decode step)."""
    from paddle_tpu_torch.serving import LLMEngine
    counters = decode_counters(dec)
    tp = knobs.get("tp", 1)
    eng = LLMEngine(model, **{**SERVE_KW, **knobs})
    route = "ragged_tp" if tp > 1 else "ragged"
    check(eng.attend_impl == route, f"auto gave {eng.attend_impl}")
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    results = eng.generate(prompts, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: c.count for k, c in counters.items()}
    st = eng.stats()
    vocab, layers = model.cfg.vocab_size, model.cfg.num_layers
    for r, p in zip(results, params):
        check(r.finish_reason == "length"
              and len(r.token_ids) == p.max_new_tokens,
              f"{name} request {r.request_id}: {r.finish_reason}, "
              f"{len(r.token_ids)} tokens")
        check(all(0 <= t < vocab for t in r.token_ids),
              f"{name} request {r.request_id}: token id out of range")
    want = {k: tp * layers * st["decode_steps"] if k == name else 0
            for k in counters}
    check(counts == want, f"{name}: decode kernel launches {counts} != "
                          f"{want} ({tp} ranks x {layers} layers x "
                          f"{st['decode_steps']} decode steps)")
    prefills = sum(1 for e in eng.tracer.events() if e[2] == "prefill_chunk")
    if tp > 1:
        per = 2 * layers + 2
        check(st["tp_collectives_per_step"] == per
              and st["tp_collectives"] == per * (prefills
                                                 + st["decode_steps"]),
              f"{name} tp {tp}: {st['tp_collectives']} collectives, "
              f"{st['tp_collectives_per_step']} a forward, want {per} x "
              f"({prefills} prefill calls + {st['decode_steps']} steps)")
    check(st["host_syncs"] == st["decode_dispatches"],
          f"{name}: host_syncs {st['host_syncs']} != dispatches "
          f"{st['decode_dispatches']}")
    check(st["graph_captures"] == len(eng._runners) == 1,
          f"{name}: {st['graph_captures']} graph captures, runners "
          f"{sorted(eng._runners)}")
    check(st["prefill_graph_captures"] == len(eng._prefill_runners),
          f"{name}: {st['prefill_graph_captures']} prefill graph captures, "
          f"row counts {sorted(eng._prefill_runners)}")
    if eng.paged:
        check(leaked_pages(eng) == 0, f"{name}: leaked pages")
    log(f"  {name} {knobs or 'slotted'}: {len(results)} requests "
        f"({st['prompt_tokens']} prompt, {st['generated_tokens']} generated"
        f" tokens) in {wall:.2f} s; {name} launches {counts[name]} = "
        + (f"{tp} ranks x " if tp > 1 else "")
        + f"{layers} layers x {st['decode_steps']} decode steps, other "
        f"decode kernels 0; "
        + (f"collectives {st['tp_collectives']} = {2 * layers + 2} x "
           f"({prefills} prefill calls + {st['decode_steps']} steps); "
           if tp > 1 else "")
        + f"host_syncs = dispatches "
        f"{st['decode_dispatches']}; 1 graph capture "
        f"({st['graph_capture_s']:.3f} s), prefill graphs of "
        f"{sorted(eng._prefill_runners)} rows "
        f"({st['prefill_graph_capture_s']:.3f} s, pool "
        f"{st['prefill_graph_pool_bytes'] / 2**20:.1f} MiB); "
        f"kv_bytes_per_token {st['kv_bytes_per_token']:.0f}")
    return eng, results, {
        "launches": counts[name], "tokens_per_s": st["tokens_per_sec"],
        "decode_ms_per_token": st["decode_ms_per_token"],
        "ttft_p50_s": st["ttft_p50_s"], "ttft_p99_s": st["ttft_p99_s"],
        "decode_steps": st["decode_steps"],
        "dispatches": st["decode_dispatches"], "wall_s": wall,
        "graph_capture_s": st["graph_capture_s"],
        "prefill_graph_captures": st["prefill_graph_captures"],
        "prefill_graph_capture_s": st["prefill_graph_capture_s"],
        "prefill_graph_pool_bytes": st["prefill_graph_pool_bytes"],
        "kv_bytes_per_token": st["kv_bytes_per_token"],
        "kv_pages_peak": st["kv_pages_peak"],
        "tp_collectives": st["tp_collectives"],
        "streams": [r.token_ids for r in results]}


def gpt_small_bf16(torch, P):
    t0 = time.perf_counter()
    model = P.models.gpt_small(seed=0, device="cuda", dtype="bf16")
    cfg = model.cfg
    check((cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.vocab_size)
          == (768, 12, 12, 50304), f"not GPT-small: {cfg}")
    log(f"  GPT-small bf16 built from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    return model


def phase_engine(torch, np, P):
    from paddle_tpu_torch.ops_cuda import decode_attention as dec
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    model = gpt_small_bf16(torch, P)
    prompts, params = serving_load(np, SamplingParams, model.cfg.vocab_size)
    # warm-up (cuBLAS handles, allocator) outside the measured run
    LLMEngine(model, **SERVE_KW).generate(prompts[:2],
                                          SamplingParams(max_new_tokens=8))
    torch.cuda.synchronize()
    _, results, run = serve(torch, dec, model, prompts, params, "K1")
    # the engine's own invariant: a request served alone gives the same
    # stream as in the batch (lanes are row-independent)
    for i in (0, 1):
        solo = LLMEngine(model, **SERVE_KW).generate([prompts[i]],
                                                     params[i])[0]
        check(solo.token_ids == results[i].token_ids,
              f"request {i}: alone {solo.token_ids[:8]}... != batched "
              f"{results[i].token_ids[:8]}...")
    log("  greedy requests 0 and 1 served alone: streams bitwise equal")
    return {**run, "prompts": prompts, "model": model, "params": params}


def phase_engine_variants(torch, np, dec, engine_run):
    """(b) the phase-4 load served through K4, K5 and K6; paged streams
    equal the slotted ones token for token (bf16: K4 against phase 4's
    K1, int8: K6 against K5), sampled requests included."""
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    model, prompts, params = (engine_run[k] for k in
                              ("model", "prompts", "params"))
    runs = {"K1": engine_run}
    for name, knobs in DECODE_VARIANTS[1:]:
        LLMEngine(model, **SERVE_KW, **knobs).generate(
            prompts[:2], SamplingParams(max_new_tokens=8))     # warm-up
        torch.cuda.synchronize()
        runs[name] = serve(torch, dec, model, prompts, params, name,
                           **knobs)[2]
    for paged, slotted in (("K4", "K1"), ("K6", "K5")):
        check(runs[paged]["streams"] == runs[slotted]["streams"],
              f"{paged} streams != {slotted} streams")
        log(f"  {paged} (paged) and {slotted} (slotted): all 16 streams "
            f"equal token for token")
    return runs


def phase_page_pressure(torch, dec, engine_run, int8_streams):
    """(c) paged int8 with kv_pages = 49 (48 usable pages of 64 rows;
    a request's span takes 2-12): admission waits on pages while lanes
    are free, every request finishes with K6's streams of (b), and no
    page leaks."""
    from paddle_tpu_torch.serving import LLMEngine
    model, prompts, params = (engine_run[k] for k in
                              ("model", "prompts", "params"))
    eng = LLMEngine(model, **SERVE_KW, kv_layout="paged", kv_dtype="int8",
                    kv_pages=49)
    rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    waited = 0
    t0 = time.perf_counter()
    while eng.has_work():
        eng.step()
        if eng._queue and eng.cache.num_free > 0:
            waited += 1            # lanes free, the head waits on pages
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    results = [eng.result(r) for r in rids]
    st = eng.stats()
    check(all(r.finish_reason == "length" and len(r.token_ids) == 64
              for r in results), "a request under page pressure failed")
    check(waited > 0, "admission never waited on pages")
    leaked = leaked_pages(eng)
    check(leaked == 0, f"{leaked} pages leaked")
    check(st["kv_pages_peak"] <= 49, f"peak {st['kv_pages_peak']} > 49")
    check([r.token_ids for r in results] == int8_streams,
          "streams under page pressure != K6 streams of (b)")
    log(f"  paged int8, kv_pages 49: 16/16 requests finished in {wall:.2f}"
        f" s, admission waited on pages at {waited} steps with lanes free,"
        f" peak {st['kv_pages_peak']} pages, 0 leaked; streams equal (b)'s")
    return {"waited_steps": waited, "kv_pages_peak": st["kv_pages_peak"],
            "wall_s": wall}


SPEC_KW = dict(max_slots=4, max_seq=1024, decode_block_size=8, seed=0,
               device="cuda")
SPEC_K = 3


def ptq_gpt_small(torch, np, P):
    """The port's PTQ over GPT-small bf16 from seed 0, calibrated on two
    fixed (4, 128) batches of token ids from numpy seed 0."""
    from paddle_tpu_torch.quantization import PTQ, Int8Linear
    model = P.models.gpt_small(seed=0, device="cuda", dtype="bf16")
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, model.cfg.vocab_size, (4, 128))
               for _ in range(2)]
    ptq = PTQ()
    ptq.quantize(model)
    ptq.sample(model, batches)
    ptq.convert(model)
    n = sum(isinstance(m, Int8Linear) for m in model.modules())
    check(n == 4 * model.cfg.num_layers, f"{n} Int8Linear layers")
    return model


class _PlainInt8:
    """Swaps K7's plain version in for the kernel on CUDA tensors, for
    the control run only (restored on exit)."""

    def __init__(self, k7):
        self.k7 = k7

    def __enter__(self):
        self.saved = self.k7.int8_linear_fused
        self.k7.int8_linear_fused = self.k7.int8_linear_plain

    def __exit__(self, *exc):
        self.k7.int8_linear_fused = self.saved


def phase_int8_serving(torch, np, P, dec, k7, engine_run):
    """(4d) an int8-PTQ GPT-small served through K7 with max_slots = 4:
    48 K7 launches and 12 K1 launches per decode step; the plain version
    swapped in for K7 gives the same streams."""
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    model = ptq_gpt_small(torch, np, P)
    prompts, params = engine_run["prompts"][:8], engine_run["params"][:8]
    kw = dict(SPEC_KW)
    LLMEngine(model, **kw).generate(prompts[:2],
                                    SamplingParams(max_new_tokens=8))
    torch.cuda.synchronize()
    k7.INT8_LAUNCHES.reset()
    dec.LAUNCHES.reset()
    eng = LLMEngine(model, **kw)
    t0 = time.perf_counter()
    results = eng.generate(prompts, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    launches, k1 = k7.INT8_LAUNCHES.count, dec.LAUNCHES.count
    layers = model.cfg.num_layers
    check(all(r.finish_reason == "length" and len(r.token_ids) == 64
              for r in results), "an int8 request did not finish")
    check(launches == 4 * layers * st["decode_steps"],
          f"K7 launches {launches} != 4 x {layers} x "
          f"{st['decode_steps']} decode steps")
    check(k1 == layers * st["decode_steps"], f"K1 launches {k1}")
    check(st["host_syncs"] == st["decode_dispatches"], "host syncs")
    streams = [r.token_ids for r in results]
    with _PlainInt8(k7):
        k7.INT8_LAUNCHES.reset()
        plain = [r.token_ids for r in LLMEngine(model, **kw).generate(
            prompts, params)]
        check(k7.INT8_LAUNCHES.count == 0, "the plain run launched K7")
    check(plain == streams, "K7 streams != plain-version streams")
    log(f"  int8-PTQ GPT-small, max_slots 4: 8 requests in {wall:.2f} s, "
        f"{st['tokens_per_sec']:.1f} tokens/s, decode "
        f"{st['decode_ms_per_token']:.3f} ms/step; K7 launches {launches} "
        f"= 4 x {layers} x {st['decode_steps']} decode steps, K1 {k1}; "
        f"streams with K7's plain version swapped in: equal, 8/8")
    del eng
    torch.cuda.empty_cache()
    # the model and streams stay for phase 4f's graph == eager check
    return {"launches": launches, "decode_steps": st["decode_steps"],
            "tokens_per_s": st["tokens_per_sec"],
            "decode_ms_per_token": st["decode_ms_per_token"],
            "wall_s": wall, "model": model, "streams": streams}


def phase_speculative(torch, np, dec, k7, engine_run):
    """(4e) speculation on == off at GPT-small bf16, token for token:
    trunc and int8 drafts on the slotted layout, int8 on the paged
    layout, int8 with an int8 KV cache; launch counts of K7 and of the
    decode kernel against their formulas."""
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    model = engine_run["model"]
    layers = model.cfg.num_layers
    prompts = engine_run["prompts"][:8]
    params = [dataclasses.replace(p, max_new_tokens=32)
              for p in engine_run["params"][:8]]
    counters = decode_counters(dec)

    def run(name, **knobs):
        eng = LLMEngine(model, **SPEC_KW, **knobs)
        for c in list(counters.values()) + [k7.INT8_LAUNCHES]:
            c.reset()
        t0 = time.perf_counter()
        res = eng.generate(prompts, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        check(st["host_syncs"] == st["decode_dispatches"],
              f"{name}: host syncs {st['host_syncs']} != dispatches")
        return eng, res, st, wall, {k: c.count for k, c in counters.items()}

    # the EOS: request 0's 7th token in a first spec-off run (the runs
    # with the EOS set are identical to it up to that token)
    _, first, _, _, _ = run("off, no EOS")
    params[0] = dataclasses.replace(params[0],
                                    eos_token_id=first[0].token_ids[6])
    out, refs = {}, {}
    for kv in ("bf16", "int8"):
        kvk = {} if kv == "bf16" else dict(kv_dtype="int8")
        _, res, st, wall, _ = run(f"off {kv}", **kvk)
        refs[kv] = [r.token_ids for r in res]
        out[f"off_{kv}"] = {"tokens_per_s": st["tokens_per_sec"],
                            "wall_s": wall}
        log(f"  spec off, KV {kv}: {st['tokens_per_sec']:.1f} tokens/s, "
            f"{st['decode_dispatches']} blocks, {wall:.2f} s")
        if kv == "bf16":
            check(res[0].finish_reason == "stop" and len(res[0].token_ids)
                  <= 7, "request 0 did not stop at its EOS")
    for name, knobs, kv, kernel in (
            ("trunc slotted", dict(draft="trunc"), "bf16", "K1"),
            ("int8 slotted", dict(draft="int8"), "bf16", "K1"),
            ("int8 paged", dict(draft="int8", kv_layout="paged"), "bf16",
             "K4"),
            ("int8 slotted, int8 KV", dict(draft="int8", kv_dtype="int8"),
             "int8", "K5")):
        eng, res, st, wall, counts = run(name, speculate_k=SPEC_K, **knobs)
        streams = [r.token_ids for r in res]
        same = sum(a == b for a, b in zip(streams, refs[kv]))
        check(same == len(prompts), f"spec {name}: {len(prompts) - same} "
                                    f"streams differ from spec off")
        blocks, rounds, dl = (st["decode_dispatches"], eng.spec_rounds,
                              eng.draft_layers)
        k7_want = (4 * dl + 1) * SPEC_K * rounds * blocks             if knobs["draft"] == "int8" else 0
        check(k7.INT8_LAUNCHES.count == k7_want,
              f"spec {name}: K7 launches {k7.INT8_LAUNCHES.count} != "
              f"(4 x {dl} + 1) x {SPEC_K} x {rounds} x {blocks} = {k7_want}")
        dec_want = {k: (SPEC_K * dl + layers) * rounds * blocks
                    if k == kernel else 0 for k in counters}
        check(counts == dec_want, f"spec {name}: decode launches {counts} "
                                  f"!= {dec_want}")
        check(st["spec_proposed"] > 0 and st["spec_blocks"] == blocks,
              f"spec {name}: spec counters {st['spec_proposed']}, "
              f"{st['spec_blocks']}")
        log(f"  spec on, {name} (k {SPEC_K}, draft_layers {dl}, rounds "
            f"{rounds}): 8/8 streams equal spec off; {blocks} blocks; K7 "
            f"launches {k7.INT8_LAUNCHES.count} = (4 x {dl} + 1) x {SPEC_K}"
            f" x {rounds} x {blocks}; {kernel} launches {counts[kernel]} = "
            f"({SPEC_K} x {dl} + {layers}) x {rounds} x {blocks}; "
            f"acceptance {st['spec_acceptance_rate']:.3f}; "
            f"{st['tokens_per_sec']:.1f} tokens/s (off, KV {kv}: "
            f"{out['off_' + kv]['tokens_per_s']:.1f}); graph capture "
            f"{st['graph_capture_s']:.3f} s")
        check(st["graph_captures"] == len(eng._runners) == 1,
              f"spec {name}: {st['graph_captures']} graph captures")
        out[name] = {"k7_launches": k7.INT8_LAUNCHES.count,
                     "decode_launches": counts[kernel], "blocks": blocks,
                     "acceptance": st["spec_acceptance_rate"],
                     "tokens_per_s": st["tokens_per_sec"], "wall_s": wall,
                     "streams": streams, "knobs": knobs}
    log(f"  EOS: request 0 stopped after {len(refs['bf16'][0])} tokens "
        f"with KV bf16, spec off and on")
    out["refs"], out["prompts"], out["params"] = refs, prompts, params
    return out


def busy_us(kernels) -> float:
    """The device's busy µs under profiler kernel events: the union of
    their intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def kernels_per_block(torch, eng):
    """CUDA kernels, and the device's busy share, of one profiled
    scheduler step that only decodes (torch.profiler; a graph replay's
    kernels are traced one by one). Returns (kernels per processed
    block, busy share of the step's wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    before = eng.stats()["decode_dispatches"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    blocks = eng.stats()["decode_dispatches"] - before
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("Command Buffer")]
    return len(kernels) / max(blocks, 1), busy_us(kernels) / wall_us


# phase 4f's prefill check: pieces of at most 600 tokens over phase 4's
# prompts (16-700 tokens) use every prefill row count of the default
# buckets past the floor
PREFILL_CHUNK_4F = 600
PREFILL_ROWS_4F = [128, 256, 512, 1024]


def record_prefills(eng):
    """Keep every `_prefill_tokens` call's logits of `eng` on the host
    (a host sync per call: for a check only)."""
    out, real = [], eng._prefill_tokens

    def recorded(*args, **kw):
        logits = real(*args, **kw)
        if logits is not None:
            out.append(logits.cpu())
        return logits

    eng._prefill_tokens = recorded
    return out


def phase_dispatch(torch, np, dec, k7, engine_run, variants, int8_run,
                   spec):
    """(4f) the dispatch loop on the card: every decode block of phases
    4-4e ran as one CUDA graph replay; here the same loads run eagerly
    (the engine's private switch) and must give the graph runs' streams
    bitwise (K1, K4, K5, K6, K7, speculation with the trunc and the int8
    draft); overlap off gives overlap on's streams; injected
    decode_dispatch / host_sync faults under overlap and draft_dispatch
    faults under speculation recover to the clean streams with the
    expected retries, recoveries and fallbacks, re-uploading the lane
    state into the graphs' static buffers; counts and leaks as phase
    4. The prefill programs: phase 4's load in pieces of at most 600
    tokens (row counts 128, 256, 512, 1024) through K1, K4, K5, K6 and
    the int8-PTQ model, graphed and eager: every prefill call's logits
    and every stream bitwise equal, one prefill capture per row count,
    capture seconds and pool bytes logged, and the graph run's counted
    launches those of the eager run (a prefill replay adds none)."""
    import gc
    from paddle_tpu_torch.serving import LLMEngine
    from paddle_tpu_torch.testing import faults
    model, prompts, params = (engine_run[k] for k in
                              ("model", "prompts", "params"))
    layers = model.cfg.num_layers
    counters = decode_counters(dec)
    out = {}

    def run(mdl, prm, prs, graphs=True, plan=None, **knobs):
        eng = LLMEngine(mdl, **knobs)
        eng._use_graphs = graphs
        for c in list(counters.values()) + [k7.INT8_LAUNCHES]:
            c.reset()
        rids = [eng.submit(p, sp) for p, sp in zip(prm, prs)]
        t0 = time.perf_counter()
        if plan is None:
            eng.run_until_complete(max_steps=2000)
        else:
            with faults.inject(plan):
                eng.run_until_complete(max_steps=2000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        res = [eng.result(r) for r in rids]
        check(all(r.finish_reason in ("stop", "length") for r in res),
              f"4f: finish reasons {[r.finish_reason for r in res]}")
        check(st["host_syncs"] == st["decode_dispatches"], "4f: host syncs")
        check(st["graph_captures"] == (len(eng._runners) if graphs else 0),
              f"4f: {st['graph_captures']} captures, runners "
              f"{sorted(eng._runners)}")
        check(eng.cache.num_free == eng.max_slots and not eng.has_work(),
              "4f: slots not drained")
        if eng.paged:
            check(leaked_pages(eng) == 0, "4f: leaked pages")
        counts = {k: c.count for k, c in counters.items()}
        counts["K7"] = k7.INT8_LAUNCHES.count
        streams = [r.token_ids for r in res]
        del eng, res
        gc.collect()
        torch.cuda.empty_cache()
        return streams, st, counts, wall

    # graph == eager, bitwise, through each decode kernel
    for name, knobs in DECODE_VARIANTS:
        streams, st, counts, wall = run(model, prompts, params,
                                        graphs=False, **SERVE_KW, **knobs)
        check(streams == variants[name]["streams"],
              f"4f: {name} eager streams != graph streams")
        check(counts[name] == layers * st["decode_steps"],
              f"4f: eager {name} launches {counts[name]}")
        out[f"eager_{name}"] = {"tokens_per_s": st["tokens_per_sec"],
                                "decode_ms_per_token":
                                    st["decode_ms_per_token"],
                                "wall_s": wall}
        log(f"  {name}: eager streams == graph streams, 16/16; eager "
            f"{st['tokens_per_sec']:.1f} tokens/s, decode "
            f"{st['decode_ms_per_token']:.3f} ms/step against the graph "
            f"run's {variants[name]['tokens_per_s']:.1f} tokens/s, "
            f"{variants[name]['decode_ms_per_token']:.3f} ms/step")
    # the prefill programs: graph == eager, bitwise, on a chunked load
    # that uses every row count
    out["prefill_graphs"] = {}
    for name, mdl, prs, prm, knobs in (
            [(n, model, prompts, params, {**SERVE_KW, **k})
             for n, k in DECODE_VARIANTS]
            + [("K7", int8_run["model"], prompts, params,
                dict(SPEC_KW))]):
        got = {}
        for graphs in (True, False):
            eng = LLMEngine(mdl, prefill_chunk=PREFILL_CHUNK_4F, **knobs)
            eng._use_graphs = graphs
            logits = record_prefills(eng)
            for c in list(counters.values()) + [k7.INT8_LAUNCHES]:
                c.reset()
            res = eng.generate(prs, prm)
            torch.cuda.synchronize()
            st = eng.stats()
            counts = {k: c.count for k, c in counters.items()}
            counts["K7"] = k7.INT8_LAUNCHES.count
            got[graphs] = ([r.token_ids for r in res], logits, counts)
            rows = sorted(eng._prefill_runners)
            check(rows == PREFILL_ROWS_4F, f"4f: {name} prefill row counts "
                                           f"{rows}")
            if graphs:
                runners = eng._prefill_runners.values()
                check(st["prefill_graph_captures"] == len(rows)
                      and all(r.graph is not None for r in runners),
                      f"4f: {name}: {st['prefill_graph_captures']} "
                      f"prefill captures for row counts {rows}")
                check(all(d == 0 for r in runners for d in r.deltas),
                      f"4f: {name}: a prefill graph counts launches "
                      f"{[r.deltas for r in runners]}")
                info = {"captures": st["prefill_graph_captures"],
                        "capture_s": st["prefill_graph_capture_s"],
                        "pool_bytes": st["prefill_graph_pool_bytes"],
                        "prefill_calls": len(logits)}
            else:
                check(st["prefill_graph_captures"] == 0,
                      f"4f: {name}: the eager engine captured a prefill")
            del eng, res
            gc.collect()
            torch.cuda.empty_cache()
        (sg, lg, cg), (se, le, ce) = got[True], got[False]
        check(sg == se, f"4f: {name}: graphed prefill streams != eager")
        check(len(lg) == len(le) and all(torch.equal(a, b)
                                         for a, b in zip(lg, le)),
              f"4f: {name}: graphed prefill logits != eager")
        check(cg == ce, f"4f: {name}: counted launches {cg} (graphs) != "
                        f"{ce} (eager)")
        out["prefill_graphs"][name] = info
        log(f"  {name} prefill: graphs == eager, bitwise: {len(lg)} "
            f"prefill calls' logits, {len(sg)}/{len(sg)} streams; "
            f"{info['captures']} prefill captures (rows {rows}) in "
            f"{info['capture_s']:.3f} s, pool "
            f"{info['pool_bytes'] / 2**20:.1f} MiB; counted launches "
            f"{ {k: v for k, v in cg.items() if v} } == eager's "
            f"[card: {card_line()}]")
    # K7: the int8-PTQ model of phase 4d
    streams, st, counts, _ = run(int8_run["model"], prompts[:8],
                                 params[:8], graphs=False, **SPEC_KW)
    check(streams == int8_run["streams"], "4f: K7 eager != graph streams")
    check(counts["K7"] == 4 * layers * st["decode_steps"],
          f"4f: eager K7 launches {counts['K7']}")
    log("  K7 (int8-PTQ, 4 slots): eager streams == graph streams, 8/8")
    # speculation, trunc and int8 drafts
    for name in ("trunc slotted", "int8 slotted"):
        streams, st, counts, _ = run(model, spec["prompts"], spec["params"],
                                     graphs=False, speculate_k=SPEC_K,
                                     **SPEC_KW, **spec[name]["knobs"])
        check(streams == spec[name]["streams"],
              f"4f: spec {name} eager != graph streams")
        log(f"  spec {name}: eager streams == graph streams, 8/8")
    # overlap off == on (phase 4 ran with the default, on)
    streams, st, counts, _ = run(model, prompts, params, overlap=False,
                                 **SERVE_KW)
    check(streams == engine_run["streams"], "4f: overlap off != on")
    check(counts["K1"] == layers * st["decode_steps"], "4f: K1 launches")
    log("  overlap off: streams == phase 4's (overlap on), 16/16; K1 "
        f"launches {counts['K1']} = {layers} x {st['decode_steps']}")
    # injected faults under overlap: decode_dispatch and host_sync
    # (slotted K1, paged int8 K6), draft_dispatch under speculation
    # (each injected fault costs one retry; faults in one round share
    # its recovery)
    for name, knobs, plan in (
            ("K1", {}, faults.FaultPlan().fail_at("decode_dispatch", 3)
             .fail_at("host_sync", 6)),
            ("K6", dict(kv_layout="paged", kv_dtype="int8"),
             faults.FaultPlan().fail_at("host_sync", 2, 9))):
        streams, st, _, _ = run(model, prompts, params, plan=plan,
                                retry_backoff_s=0.0, **SERVE_KW, **knobs)
        check(streams == variants[name]["streams"],
              f"4f: faulted {name} streams != clean streams")
        n = sum(plan.injected.values())
        check(n == 2 and st["retries"] == n
              and 1 <= st["recoveries"] <= n and st["failed_requests"] == 0,
              f"4f: faulted {name}: injected {plan.injected}, retries "
              f"{st['retries']}, recoveries {st['recoveries']}")
        log(f"  {name} with faults {plan.injected}: streams == clean, "
            f"16/16; retries {st['retries']}, recoveries "
            f"{st['recoveries']}, 0 failed")
    plan = faults.FaultPlan().fail_at("draft_dispatch", 2, 3) \
        .fail_at("host_sync", 4)
    streams, st, _, _ = run(model, spec["prompts"], spec["params"],
                            plan=plan, retry_backoff_s=0.0,
                            speculate_k=SPEC_K, **SPEC_KW,
                            **spec["int8 slotted"]["knobs"])
    check(streams == spec["refs"]["bf16"], "4f: faulted spec != spec off")
    check((st["spec_fallbacks"], st["retries"], st["recoveries"],
           st["graph_captures"]) == (2, 1, 1, 2),
          f"4f: faulted spec: fallbacks {st['spec_fallbacks']}, retries "
          f"{st['retries']}, recoveries {st['recoveries']}, captures "
          f"{st['graph_captures']}")
    log(f"  spec int8 with faults {plan.injected}: streams == spec off, "
        f"8/8; spec_fallbacks 2, retries 1, recoveries 1, 2 graph "
        f"captures (speculative and plain)")
    # CUDA kernels per decode block: one decode-only step (overlap off)
    eng = LLMEngine(model, overlap=False, **SERVE_KW)
    for p in prompts[:8]:
        eng.submit(p, params[0])
    eng.step()
    per_block, busy = kernels_per_block(torch, eng)
    out["kernels_per_block"], out["busy_share"] = per_block, busy
    log(f"  one decode block ({eng.decode_block_size} steps: as many "
        f"replays of a one-step graph, 8 lanes): {per_block:.0f} CUDA "
        f"kernels; device busy "
        f"{busy:.3f} of the profiled step [card: {card_line()}]")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# phase 4g: admission (prefix cache, interleaved chunked prefill,
# snapshot / resume, extract / adopt)
# --------------------------------------------------------------------------- #

ADMISSION_KW = dict(prefill_budget=256, prefill_chunk=64)
# (tag, engine knobs, the decode kernel the run launches)
ADMISSION = (("a", dict(prefix_cache=False), "K1"),
             ("b", {}, "K1"),
             ("c", ADMISSION_KW, "K1"),
             ("d", dict(ADMISSION_KW, kv_layout="paged"), "K4"),
             ("e", dict(ADMISSION_KW, kv_layout="paged", kv_dtype="int8"),
              "K6"),
             ("e twin", dict(prefix_cache=False, kv_layout="paged",
                             kv_dtype="int8"), "K6"))


def greedy_margins(torch, np, model, prompts, streams, idx):
    """Per request of `idx`: the model's top-2 logit margin at every
    position that decided a token of its greedy stream (one causal
    forward over prompt + stream)."""
    out = {}
    for i in idx:
        seq = np.concatenate([prompts[i],
                              np.asarray(streams[i][:-1], np.int32)])
        lg = model.logits(torch.from_numpy(seq[None]).long().cuda())[0]
        top2 = torch.topk(lg[len(prompts[i]) - 1:].float(), 2,
                          dim=-1).values
        out[i] = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    return out


def phase_admission(torch, np, dec, engine_run):
    """(4g) phase 4's model on a shared-prefix load (one 512-token system
    prompt, a 16-188-token tail each), served (a) monolithically without
    the prefix cache, (b) with it (slotted), (c) with it and
    `prefill_budget=256, prefill_chunk=64`, (d) as (c), paged, (e) as
    (d) with int8 KV; (f) (c) snapshotted after its fourth step that
    ran a decode block (before it, every lane is still prefilling),
    pickled, resumed in a fresh engine; (g) (c) with two greedy
    requests extracted mid-run and adopted by a second engine with
    `keep_salt=True`. (b)-(d) give (a)'s streams bitwise, greedy and
    sampled, and (e) those of paged int8 without the prefix cache; (b)
    reuses 15 x 512 tokens; (f) and (g) give (c)'s streams bitwise
    (continuations replay their emitted tokens through decode steps),
    the top-2 margins along the moved greedy streams logged. Every run:
    all requests finish, its decode kernel launched layers x (decode +
    replay steps) times and the others never (counted from 0 just
    before the run), one graph capture per runner, host syncs =
    dispatches, 0 failed requests, 0 leaked pages."""
    import gc
    import pickle
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    model = engine_run["model"]
    layers = model.cfg.num_layers
    prompts, params = shared_prefix_load(np, SamplingParams,
                                         model.cfg.vocab_size)
    greedy = [i for i, sp in enumerate(params) if sp.temperature == 0]
    counters = decode_counters(dec)
    card = card_line()

    def reset():
        for c in counters.values():
            c.reset()

    def check_launches(tag, kernel, steps):
        """`steps`: the decode and replay steps the run took."""
        counts = {k: c.count for k, c in counters.items()}
        want = {k: layers * steps if k == kernel else 0 for k in counters}
        check(counts == want, f"4g {tag}: decode kernel launches {counts} "
                              f"!= {want}")
        return counts[kernel]

    def drained(tag, eng):
        st = eng.stats()
        check(st["host_syncs"] == st["decode_dispatches"],
              f"4g {tag}: host syncs {st['host_syncs']} != dispatches "
              f"{st['decode_dispatches']}")
        check(st["graph_captures"] == len(eng._runners),
              f"4g {tag}: {st['graph_captures']} captures, runners "
              f"{sorted(eng._runners)}")
        check(st["failed_requests"] == 0, f"4g {tag}: failed requests")
        check(eng.cache.num_free == eng.max_slots and not eng.has_work(),
              f"4g {tag}: slots not drained")
        if eng.paged:
            check(leaked_pages(eng) == 0, f"4g {tag}: leaked pages")
        return st

    def finished(tag, results):
        for r in results:
            check(r.finish_reason == "length" and len(r.token_ids) == 64,
                  f"4g {tag} request {r.request_id}: {r.finish_reason}, "
                  f"{len(r.token_ids)} tokens")
        return [r.token_ids for r in results]

    def numbers(st, wall):
        return {"ttft_p50_s": st["ttft_p50_s"], "ttft_p99_s": st["ttft_p99_s"],
                "tokens_per_s": st["tokens_per_sec"],
                "prefill_tokens_computed": st["prefill_tokens_computed"],
                "prefix_tokens_reused": st["prefix_tokens_reused"],
                "decode_steps": st["decode_steps"], "wall_s": wall,
                "graph_capture_s": st["graph_capture_s"],
                "prefill_graph_captures": st["prefill_graph_captures"],
                "prefill_graph_capture_s": st["prefill_graph_capture_s"],
                "prefill_graph_pool_bytes": st["prefill_graph_pool_bytes"]}

    def report(tag, knobs, run):
        log(f"  ({tag}) {knobs or 'prefix cache on, monolithic'}: TTFT p50 "
            f"{run['ttft_p50_s'] * 1e3:.1f} ms, p99 "
            f"{run['ttft_p99_s'] * 1e3:.1f} ms, {run['tokens_per_s']:.1f} "
            f"tokens/s, prefill tokens computed "
            f"{run['prefill_tokens_computed']}, reused "
            f"{run['prefix_tokens_reused']}, {run['launches']} decode "
            f"launches; {run['prefill_graph_captures']} prefill captures "
            f"({run['prefill_graph_capture_s']:.3f} s) [card: {card}]")

    runs = {}
    for tag, knobs, kernel in ADMISSION:
        eng = LLMEngine(model, **SERVE_KW, **knobs)
        reset()
        t0 = time.perf_counter()
        rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
        eng.run_until_complete(max_steps=2000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        streams = finished(tag, [eng.result(r) for r in rids])
        st = drained(tag, eng)
        runs[tag] = {**numbers(st, wall), "streams": streams,
                     "launches": check_launches(
                         tag, kernel, st["decode_steps"] + st["replay_steps"])}
        report(tag, knobs, runs[tag])
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    total = sum(int(p.size) for p in prompts)
    check(runs["a"]["prefill_tokens_computed"] == total,
          f"4g (a): computed {runs['a']['prefill_tokens_computed']} != "
          f"{total}")
    reuse = (len(prompts) - 1) * SYSTEM_PROMPT
    check(runs["b"]["prefix_tokens_reused"] == reuse
          and runs["b"]["prefill_tokens_computed"] == total - reuse,
          f"4g (b): reused {runs['b']['prefix_tokens_reused']} != "
          f"{len(prompts) - 1} x {SYSTEM_PROMPT}")
    for tag in ("b", "c", "d"):
        same = sum(x == y for x, y in zip(runs[tag]["streams"],
                                          runs["a"]["streams"]))
        check(same == len(prompts), f"4g ({tag}): {len(prompts) - same} "
                                    f"streams != (a)'s")
    same = sum(x == y for x, y in zip(runs["e"]["streams"],
                                      runs["e twin"]["streams"]))
    check(same == len(prompts), f"4g (e): {len(prompts) - same} streams != "
                                f"paged int8 without the prefix cache")
    log(f"  (b), (c), (d) == (a) and (e) == paged int8 without the prefix "
        f"cache: {len(prompts)}/{len(prompts)} streams each ({len(greedy)} "
        f"greedy, {len(prompts) - len(greedy)} sampled), bitwise; (b) "
        f"reused {len(prompts) - 1} x {SYSTEM_PROMPT} = "
        f"{runs['b']['prefix_tokens_reused']} tokens")
    ref = runs["c"]["streams"]
    margins = greedy_margins(torch, np, model, prompts, ref, greedy)

    def hold_streams(tag, streams, moved):
        """(c)'s streams, every one; the top-2 margins along the moved
        greedy ones."""
        diff = [i for i in range(len(ref)) if streams[i] != ref[i]]
        idx = [i for i in greedy if i in moved]
        m = np.concatenate([margins[i] for i in idx])
        near = int((m < 1e-2).sum())
        log(f"  ({tag}) streams == (c)'s: {len(ref) - len(diff)}/{len(ref)}"
            f" ({len(greedy)} greedy, {len(ref) - len(greedy)} sampled), "
            f"bitwise; top-2 margins at the "
            f"{m.size} positions of the {len(idx)} moved greedy streams: "
            f"min {m.min():.4f}, {near} below 1e-2")
        for i in diff:
            k = next(j for j, (x, y) in enumerate(zip(streams[i], ref[i]))
                     if x != y)
            log(f"    request {i} diverges at token {k}"
                + (f", margin {margins[i][k]:.4f}" if i in greedy else ""))
        check(not diff, f"4g ({tag}): streams {diff} != (c)'s")
        return {"min_margin": float(m.min()), "near_ties": near,
                "positions": int(m.size)}

    # (f) snapshot after the fourth step with decode, pickle, resume in a
    # fresh engine
    eng = LLMEngine(model, **SERVE_KW, **ADMISSION_KW)
    reset()
    rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    with_decode = 0
    for _ in range(200):
        before = eng.metrics.decode_dispatches
        eng.step()
        with_decode += eng.metrics.decode_dispatches > before
        if with_decode == 4:
            break
    pending = eng._inflight.steps if eng._inflight is not None else 0
    snap = pickle.loads(pickle.dumps(eng.snapshot()))
    check_launches("f, before the snapshot", "K1",
                   eng.stats()["decode_steps"] + pending)
    check(snap["active"] and snap["queued"],
          f"4g (f): {len(snap['active'])} active, {len(snap['queued'])} "
          f"queued at the snapshot")
    del eng
    gc.collect()
    moved = [r["rid"] for r in snap["active"] + snap["queued"]]
    reset()
    t0 = time.perf_counter()
    eng = LLMEngine.resume(model, snap)
    eng.run_until_complete(max_steps=2000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = finished("f", [eng.result(r) for r in rids])
    st = drained("f", eng)
    runs["f"] = {**numbers(st, wall), "launches": check_launches(
        "f, after the resume", "K1",
        st["decode_steps"] + st["replay_steps"]),
        "active": len(snap["active"]), "queued": len(snap["queued"]),
        "replay_steps": st["replay_steps"]}
    report("f", f"(c) resumed from a snapshot after 4 steps with decode "
                f"({len(snap['active'])} active, {len(snap['queued'])} "
                f"queued or prefilling)", runs["f"])
    runs["f"].update(hold_streams("f", streams, moved))
    del eng
    gc.collect()
    # (g) two greedy requests extracted mid-run, adopted with keep_salt
    a = LLMEngine(model, **SERVE_KW, **ADMISSION_KW)
    b = LLMEngine(model, **SERVE_KW, **ADMISSION_KW)
    reset()
    rids = [a.submit(p, sp) for p, sp in zip(prompts, params)]
    pick = []
    for _ in range(50):
        a.step()
        pick = [r.rid for _, r in sorted(a._active.items())
                if r.finish_reason is None and r.generated
                and r.params.temperature == 0][:2]
        if len(pick) == 2:
            break
    check(len(pick) == 2, "4g (g): no two greedy requests decoding")
    moving = pickle.loads(pickle.dumps([a.extract(rid) for rid in pick]))
    b.advance_salt_clock(a.salt_clock())
    for d in moving:
        b.adopt(d, keep_salt=True)
    t0 = time.perf_counter()
    a.run_until_complete(max_steps=2000)
    b.run_until_complete(max_steps=2000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = finished("g", [(b if rid in pick else a).result(rid)
                             for rid in rids])
    sa, sb = drained("g, origin", a), drained("g, adopter", b)
    # the origin's numbers (it took every first token); the adopter's
    # re-ingest beside them
    runs["g"] = {**numbers(sa, wall), "launches": check_launches(
        "g", "K1", sa["decode_steps"] + sb["decode_steps"]
        + sb["replay_steps"]), "replay_steps": sb["replay_steps"],
        "moved": pick,
        "adopter_prefill_tokens_computed": sb["prefill_tokens_computed"],
        "adopter_prefix_tokens_reused": sb["prefix_tokens_reused"]}
    report("g", f"(c), requests {pick} extracted after "
                f"{[len(d['generated']) for d in moving]} tokens and "
                f"adopted (keep_salt)", runs["g"])
    runs["g"].update(hold_streams("g", streams, pick))
    del a, b
    gc.collect()
    torch.cuda.empty_cache()
    for run in runs.values():
        run.pop("streams", None)
    return runs


# --------------------------------------------------------------------------- #
# phase 4h: the open-loop serving bench
# --------------------------------------------------------------------------- #

# the reference's `bench_serve_openloop` on an accelerator (`bench.py`):
# GPT-small at max_seq 1024 with 8 slots; 96 requests on one seeded
# Poisson schedule at 40 requests/s, each long (896 tokens) with
# probability 0.125, else 8/16/24/32 tokens; 16 new tokens each
OPENLOOP = dict(n_req=96, long_frac=0.125, long_len=896,
                short_lens=(8, 16, 24, 32), new_toks=16, rate=40.0)
OPENLOOP_KW = dict(max_slots=8, max_seq=1024, decode_block_size=2,
                   prefix_cache=False, seed=0, device="cuda")
OPENLOOP_INTERLEAVED = dict(prefill_budget=32, prefill_chunk=32)


def all_captures(eng) -> int:
    """Graph captures of an engine, decode and prefill programs: the
    port's analog of the reference's `compiles_unexpected` counts the
    ones inside a timed window."""
    st = eng.stats()
    return st["graph_captures"] + st["prefill_graph_captures"]


def phase_openloop(torch, np, engine_run):
    """(4h) the reference's open-loop serving bench: the same Poisson
    arrival schedule of a mixed short / long population served in real
    time, monolithic and interleaved (`prefill_budget=32,
    prefill_chunk=32`), at equal offered load; each engine warmed
    outside its timed window on one long and one short prompt (the row
    counts 1024 and 128 of either mode, the decode program). Reports
    the interactive class's ttft_p99 and queue_wait_p99, the long
    class's ttft_p99, the speedup, and the decode-stall probe (the
    longest inter-token gap of an attached stream across a long
    prompt's admission) in both modes. Checks: every request finishes
    with its 16 tokens, and no graph is captured inside a timed window
    (0 unexpected captures)."""
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    from paddle_tpu_torch.serving.metrics import nearest_rank_p99
    model = engine_run["model"]
    V = model.cfg.vocab_size
    o = OPENLOOP
    n_req, short_lens = o["n_req"], o["short_lens"]
    rng = np.random.RandomState(0)
    is_long = (rng.random_sample(n_req) < o["long_frac"]).tolist()
    prompts = [rng.randint(0, V, (o["long_len"],)) if is_long[i]
               else rng.randint(0, V, (short_lens[i % len(short_lens)],))
               for i in range(n_req)]
    arrivals = np.cumsum(rng.exponential(1.0 / o["rate"], size=n_req))
    sp = SamplingParams(max_new_tokens=o["new_toks"])
    card = card_line()

    def engine(interleaved, **kw):
        return LLMEngine(model, **{**OPENLOOP_KW, **kw},
                         **(OPENLOOP_INTERLEAVED if interleaved else {}))

    def run(interleaved):
        eng = engine(interleaved, max_queue=n_req + 8)
        wrng = np.random.RandomState(123)
        eng.generate([prompts[is_long.index(True)],
                      wrng.randint(0, V, (short_lens[0],))], sp)
        torch.cuda.synchronize()
        captured = all_captures(eng)
        t0 = time.perf_counter()
        rids, i = [], 0
        while i < len(prompts) or eng.has_work():
            now = time.perf_counter() - t0
            while i < len(prompts) and arrivals[i] <= now:
                rids.append(eng.submit(prompts[i], sp))
                i += 1
            if eng.has_work():
                eng.step()
            elif i < len(prompts):
                time.sleep(min(0.002, max(arrivals[i] - now, 0.0)))
        wall = time.perf_counter() - t0
        res = [eng.result(r) for r in rids]
        unexpected = all_captures(eng) - captured
        st = eng.stats()
        eng.close()
        check(all(r.finish_reason == "length"
                  and len(r.token_ids) == o["new_toks"] for r in res),
              f"4h: finish reasons {[r.finish_reason for r in res]}")
        check(unexpected == 0, f"4h: {unexpected} graph captures inside "
                               f"the timed window")
        shorts = [r for r, lg in zip(res, is_long) if not lg]
        longs = [r for r, lg in zip(res, is_long) if lg]
        return {"ttft": nearest_rank_p99([r.ttft_s for r in shorts]) * 1e3,
                "qw": nearest_rank_p99([r.queue_wait_s for r in shorts])
                * 1e3,
                "long_ttft": nearest_rank_p99([r.ttft_s for r in longs])
                * 1e3,
                "unexpected_captures": unexpected, "n_short": len(shorts),
                "n_long": len(longs), "wall_s": wall,
                "tokens_per_s": st["tokens_per_sec"],
                "decode_ms_per_token": st["decode_ms_per_token"]}

    def stall_probe(interleaved):
        """The longest inter-token gap of one active decode stream while
        a long prompt is admitted beside it: monolithic admission stalls
        it for the long's whole prefill, interleaved admission for at
        most one round's budget and aging chunk."""
        eng = engine(interleaved, max_queue=8)
        wrng = np.random.RandomState(7)
        long_p = wrng.randint(0, V, (o["long_len"],))
        act_p = wrng.randint(0, V, (8,))
        eng.generate([long_p, act_p], sp)          # warm every program
        act = eng.submit(act_p, SamplingParams(max_new_tokens=56))
        gaps, last = [], [None]

        def sink(kind, *payload):
            if kind == "tokens":
                t = time.perf_counter()
                if last[0] is not None:
                    gaps.append(t - last[0])
                last[0] = t

        check(eng.attach_stream(act, sink), "4h: attach_stream refused")
        for _ in range(3):
            eng.step()      # the stream is decoding steadily
        gaps.clear()        # measure only across the long's admission
        captured = all_captures(eng)
        eng.submit(wrng.randint(0, V, (o["long_len"],)), sp)
        eng.run_until_complete(max_steps=2000)
        unexpected = all_captures(eng) - captured
        eng.close()
        check(unexpected == 0, f"4h: {unexpected} graph captures inside "
                               f"the stall probe")
        # the largest gap and, beside it, the stream's usual gap
        return max(gaps) * 1e3, statistics.median(gaps) * 1e3

    base = run(interleaved=False)
    inter = run(interleaved=True)
    stall_base, gap_base = stall_probe(interleaved=False)
    stall_int, gap_int = stall_probe(interleaved=True)
    ttft_x = base["ttft"] / max(inter["ttft"], 1e-9)
    qw_x = base["qw"] / max(inter["qw"], 1e-9)
    stall_x = stall_base / max(stall_int, 1e-9)
    log(f"  {n_req} requests ({base['n_short']} interactive, "
        f"{base['n_long']} long of {o['long_len']} tokens) at "
        f"{o['rate']}/s, monolithic -> interleaved: interactive ttft_p99 "
        f"{base['ttft']:.1f} -> {inter['ttft']:.1f} ms ({ttft_x:.2f}x), "
        f"queue_wait_p99 {base['qw']:.1f} -> {inter['qw']:.1f} ms "
        f"({qw_x:.2f}x), long ttft_p99 {base['long_ttft']:.1f} -> "
        f"{inter['long_ttft']:.1f} ms, decode_stall {stall_base:.1f} -> "
        f"{stall_int:.1f} ms ({stall_x:.2f}x; the stream's median gap "
        f"{gap_base:.1f} -> {gap_int:.1f} ms); tokens/s "
        f"{base['tokens_per_s']:.1f} -> {inter['tokens_per_s']:.1f}; "
        f"unexpected graph captures {base['unexpected_captures']} + "
        f"{inter['unexpected_captures']} [card: {card}]")
    metrics = {
        "gpt_small_serve_openloop_ttft_p99_ms": inter["ttft"],
        "gpt_small_serve_openloop_queue_wait_p99_ms": inter["qw"],
        "gpt_small_serve_openloop_ttft_p99_noninterleaved_ms": base["ttft"],
        "gpt_small_serve_openloop_queue_wait_p99_noninterleaved_ms":
            base["qw"],
        "gpt_small_serve_openloop_long_ttft_p99_ms": inter["long_ttft"],
        "gpt_small_serve_openloop_long_ttft_p99_noninterleaved_ms":
            base["long_ttft"],
        "gpt_small_serve_decode_stall_ms": stall_int,
        "gpt_small_serve_decode_stall_noninterleaved_ms": stall_base,
        "gpt_small_serve_openloop_ttft_p99_speedup": ttft_x}
    for name, value in metrics.items():
        log(f"  {name} {value!r} [card: {card}]")
    return {"metrics": metrics, "monolithic": base, "interleaved": inter,
            "stall_median_gap_ms": {"monolithic": gap_base,
                                    "interleaved": gap_int}}


# --------------------------------------------------------------------------- #
# phase 4i: best-of-n fork groups
# --------------------------------------------------------------------------- #

# the reference's `bench_serve_bestof` on an accelerator (`bench.py`):
# GPT-small at max_seq 1024, pages of 64 rows, 6 slots, prefix cache off;
# one seeded 512-token prompt, 64 new tokens, temperature 0.8, top_k 20
BESTOF_KW = dict(max_slots=6, max_seq=1024, kv_layout="paged", page_size=64,
                 prefix_cache=False, seed=0, device="cuda")
BESTOF_N = 4


def phase_bestof(torch, np, dec, engine_run):
    """(4i) best-of-4 against one request on the reference's bestof
    load: peak pages (minus the trash page) 12 against 9 (8 shared
    prompt pages and one decode page per continuation), ratio < 1.5, no
    boundary copy, 0 leaked pages, continuation 0 = the request served
    alone; a 500-token prompt (3 boundary copies, 15 against 9 pages,
    logged); the group slotted (K1), interleaved (`prefill_budget=256,
    prefill_chunk=64`: the same prefill tokens, a peak no higher) and
    speculative (`speculate_k=2`, trunc draft) with the paged streams,
    and paged int8 KV (K6, 0 leaked pages). Every run counts the decode
    kernels from 0: its own kernel layers x decode steps times (the
    speculative run (k x draft layers + layers) x rounds x blocks), the
    others never."""
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    model = engine_run["model"]
    layers, vocab = model.cfg.num_layers, model.cfg.vocab_size
    prompt = np.random.RandomState(0).randint(0, vocab, (512,)).astype(
        np.int32)
    sp = SamplingParams(max_new_tokens=64, temperature=0.8, top_k=20)
    group = dataclasses.replace(sp, n=BESTOF_N)
    counters = decode_counters(dec)
    card = card_line()

    def run(tag, kernel, p, params, **knobs):
        eng = LLMEngine(model, **{**BESTOF_KW, **knobs})
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        res = eng.generate([p], params)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        counts = {k: c.count for k, c in counters.items()}
        if eng.speculate_k:
            steps = (eng.speculate_k * eng.draft_layers + layers) \
                * eng.spec_rounds * st["decode_dispatches"]
        else:
            steps = layers * st["decode_steps"]
        want = {k: steps if k == kernel else 0 for k in counters}
        check(counts == want, f"4i {tag}: decode launches {counts} != "
                              f"{want}")
        streams = [res.token_ids] + [g.token_ids
                                     for g in res.siblings or ()]
        for s_ in streams:
            check(len(s_) == 64 and all(0 <= t < vocab for t in s_),
                  f"4i {tag}: a stream of {len(s_)} tokens")
        check(st["host_syncs"] == st["decode_dispatches"],
              f"4i {tag}: host syncs")
        check(st["failed_requests"] == 0 and not eng._fork_src,
              f"4i {tag}: failed requests or a fork stash left")
        peak = eng.cache.pool.peak_used - 1 if eng.paged else 0
        if eng.paged:
            check(leaked_pages(eng) == 0, f"4i {tag}: leaked pages")
        log(f"  {tag}: {len(streams)} streams in {wall:.3f} s, {kernel} "
            f"launches {counts[kernel]}, peak {peak} pages, "
            f"{st['pages_cow_copied']} boundary copies, "
            f"{st['prefill_tokens_computed']} prefill tokens")
        return {"streams": streams, "peak": peak, "wall_s": wall,
                "cow": st["pages_cow_copied"], "launches": counts[kernel],
                "prefill_tokens": st["prefill_tokens_computed"]}

    LLMEngine(model, **BESTOF_KW).generate([prompt[:64]],
                                           SamplingParams(max_new_tokens=8))
    torch.cuda.synchronize()
    one = run("one request, paged (K4)", "K4", prompt, sp)
    four = run("best-of-4, paged (K4)", "K4", prompt, group)
    ratio = four["peak"] / one["peak"]
    check((one["peak"], four["peak"]) == (9, 12),
          f"4i peaks {one['peak']} / {four['peak']} pages, not 9 / 12")
    check(ratio < 1.5 and four["cow"] == 0, f"4i ratio {ratio:.3f}, "
                                            f"{four['cow']} copies")
    check(four["streams"][0] == one["streams"][0],
          "4i continuation 0 != the request served alone")
    check(len(set(map(tuple, four["streams"]))) == BESTOF_N,
          "4i sampled continuations collapsed")
    log(f"  serve_bestof [card: {card}]: prompt 512, page 64: one request "
        f"{one['peak']} pages, best-of-4 {four['peak']} pages, ratio "
        f"{ratio:.4f} (< 1.5), 0 boundary copies; continuation 0 = the "
        f"request alone")
    one500 = run("one request, 500-token prompt", "K4", prompt[:500], sp)
    odd = run("best-of-4, 500-token prompt", "K4", prompt[:500], group)
    check(odd["cow"] == BESTOF_N - 1 and odd["streams"][0]
          == one500["streams"][0], f"4i 500: {odd['cow']} copies")
    log(f"  500-token prompt: {one500['peak']} against {odd['peak']} pages,"
        f" ratio {odd['peak'] / one500['peak']:.4f} (not gated), "
        f"{odd['cow']} boundary copies")
    slotted = run("best-of-4, slotted (K1)", "K1", prompt, group,
                  kv_layout="slotted", page_size=None)
    inter = run("best-of-4, interleaved", "K4", prompt, group,
                prefill_budget=256, prefill_chunk=64)
    spec = run("best-of-4, speculate_k=2 trunc", "K4", prompt, group,
               speculate_k=2, draft="trunc")
    int8 = run("best-of-4, paged int8 KV (K6)", "K6", prompt, group,
               kv_dtype="int8")
    for tag, r in (("slotted", slotted), ("interleaved", inter),
                   ("speculative", spec)):
        check(r["streams"] == four["streams"],
              f"4i {tag} streams != the paged group's")
    check(inter["prefill_tokens"] == four["prefill_tokens"] == 512
          and inter["peak"] <= four["peak"],
          f"4i interleaved: {inter['prefill_tokens']} prefill tokens, "
          f"peak {inter['peak']}")
    log("  slotted, interleaved and speculative groups: the paged "
        "group's 4 streams bitwise; int8 KV: 0 leaked pages")
    return {"one_pages": one["peak"], "bestof4_pages": four["peak"],
            "ratio": ratio, "cow_copies": four["cow"],
            "pages_500": [one500["peak"], odd["peak"]],
            "cow_copies_500": odd["cow"],
            "launches": {"K4": four["launches"], "K1": slotted["launches"],
                         "K6": int8["launches"], "K4_spec": spec["launches"]},
            "wall_s": {"one": one["wall_s"], "bestof4": four["wall_s"],
                       "slotted": slotted["wall_s"],
                       "interleaved": inter["wall_s"],
                       "speculative": spec["wall_s"],
                       "int8_kv": int8["wall_s"]}}


# --------------------------------------------------------------------------- #
# phase 4j: the model-side generation surface
# --------------------------------------------------------------------------- #

GEN_B, GEN_PROMPT, GEN_NEW = 4, 128, 64


def graph_entry(model, attr):
    """The newest per-signature program of `model`'s `attr` cache."""
    return list(model.__dict__[attr].values())[-1][1]


def profile_call(torch, fn, top: int = 6):
    """One profiled call of `fn` (torch.profiler; a graph replay's
    kernels are traced one by one): (CUDA kernels, the device's busy
    share of the call's wall time, the `top` kernel names by device
    time with their share of it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("Command Buffer")]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    total = sum(by_name.values()) or 1.0
    names = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return (len(kernels), busy_us(kernels) / wall_us,
            [(n[:60], round(t / total, 4)) for n, t in names])


def phase_generation(torch, np, k7, engine_run, int8_model):
    """(4j) GPT-small bf16, 4 seeded 128-token prompts, 64 new tokens:
    eager `generate` (greedy) == `generate_jit` (one CUDA graph) bitwise;
    a second call with the same signature captures nothing; sampled
    `generate_jit` is deterministic in its seed and differs across
    seeds; `beam_search(beam_size=1)` == greedy; `beam_search(beam_size=
    4, eos_token_id=...)` on one prompt keeps it and scores finitely.
    The int8-PTQ GPT-small's `generate_jit` runs K7 48 x 63 times per
    replay (the 63 decode steps' 4 linears x 12 layers at 4 rows; the
    prefill's 512 rows take the unfused product) and equals eager
    `generate` with K7's plain version swapped in; K7 == plain bitwise at
    its four (4, k, n) shapes. Timed: ms per step eager and graph, the
    capture, beam ms per step, each beside the card."""
    model = engine_run["model"]
    card = card_line()
    vocab = model.cfg.vocab_size
    ids = torch.from_numpy(np.random.RandomState(5).randint(
        0, vocab, (GEN_B, GEN_PROMPT))).cuda()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def captures(m):
        return m.__dict__.get("_graph_capture_count", 0)

    model.generate(ids[:, :16], max_new_tokens=2, temperature=0.0)
    eager, eager_s = timed(lambda: model.generate(
        ids, max_new_tokens=GEN_NEW, temperature=0.0))
    c0 = captures(model)
    graph, first_s = timed(lambda: model.generate_jit(
        ids, max_new_tokens=GEN_NEW))
    entry = graph_entry(model, "_compiled_generate")
    check(captures(model) == c0 + 1, "4j: generate_jit captured "
                                     f"{captures(model) - c0} graphs")
    graph2, graph_s = timed(lambda: model.generate_jit(
        ids, max_new_tokens=GEN_NEW))
    check(captures(model) == c0 + 1, "4j: a second call captured again")
    check(graph.shape == (GEN_B, GEN_PROMPT + GEN_NEW)
          and torch.equal(graph[:, :GEN_PROMPT], ids), "4j: output shape "
                                                       "or prompt")
    check(torch.equal(eager, graph) and torch.equal(graph, graph2),
          "4j: generate_jit (graph) != eager generate")
    n_kernels, busy, top = profile_call(torch, lambda: model.generate_jit(
        ids, max_new_tokens=GEN_NEW))
    sk = dict(max_new_tokens=GEN_NEW, temperature=0.8, top_k=20)
    s1 = model.generate_jit(ids, seed=1, **sk)
    s1b = model.generate_jit(ids, seed=1, **sk)
    s2 = model.generate_jit(ids, seed=2, **sk)
    check(torch.equal(s1, s1b) and not torch.equal(s1, s2),
          "4j: sampled generate_jit not deterministic in its seed")
    check(int(s1.min()) >= 0 and int(s1.max()) < vocab, "4j: token range")
    beam1, bscore = model.beam_search(ids, beam_size=1,
                                      max_new_tokens=GEN_NEW)
    check(torch.equal(beam1, graph) and bool(torch.isfinite(bscore).all()),
          "4j: beam_search(beam_size=1) != greedy")
    eos = int(graph[0, GEN_PROMPT + 2])
    model.beam_search(ids[:1], beam_size=4, max_new_tokens=GEN_NEW,
                      eos_token_id=eos)
    (beam, score), beam_s = timed(lambda: model.beam_search(
        ids[:1], beam_size=4, max_new_tokens=GEN_NEW, eos_token_id=eos))
    check(torch.equal(beam[:, :GEN_PROMPT], ids[:1])
          and bool(torch.isfinite(score).all()),
          "4j: beam-4 lost its prompt or scored non-finitely")
    beam_entry = graph_entry(model, "_compiled_beam")
    log(f"  GPT-small bf16, b {GEN_B}, prompt {GEN_PROMPT}, {GEN_NEW} new "
        f"[card: {card}]: eager generate {eager_s * 1e3 / GEN_NEW:.3f} ms "
        f"per step ({eager_s * 1e3 / (GEN_NEW * GEN_B):.3f} per generated "
        f"token), generate_jit (one graph replay) "
        f"{graph_s * 1e3 / GEN_NEW:.3f} ms per step "
        f"({graph_s * 1e3 / (GEN_NEW * GEN_B):.3f} per generated token; "
        f"first call "
        f"{first_s:.3f} s, capture {entry.capture_s:.3f} s, graph pool "
        f"{entry.pool_bytes / 2**20:.1f} MiB); a profiled replay: "
        f"{n_kernels} CUDA kernels ({n_kernels / GEN_NEW:.0f} per step), "
        f"device busy {busy:.3f} of its wall time, by device time {top}; "
        f"streams equal bitwise, a "
        f"second call captures 0 graphs; sampled: seed 1 twice equal, "
        f"seed 2 differs; beam 1 == greedy; beam 4 with EOS {eos}: "
        f"{beam_s * 1e3 / GEN_NEW:.3f} ms per step (capture "
        f"{beam_entry.capture_s:.3f} s, pool "
        f"{beam_entry.pool_bytes / 2**20:.1f} MiB), score "
        f"{float(score[0]):.4f}")
    # the int8-PTQ model: K7 in every decode step of the graph
    q = int8_model
    q.generate_jit(ids, max_new_tokens=2)
    k7.INT8_LAUNCHES.reset()
    qg, q_first_s = timed(lambda: q.generate_jit(ids,
                                                 max_new_tokens=GEN_NEW))
    want = 4 * q.cfg.num_layers * (GEN_NEW - 1)
    check(k7.INT8_LAUNCHES.count == want,
          f"4j int8: K7 launches {k7.INT8_LAUNCHES.count} != 4 x "
          f"{q.cfg.num_layers} x {GEN_NEW - 1} = {want}")
    qg2, q_graph_s = timed(lambda: q.generate_jit(
        ids, max_new_tokens=GEN_NEW))
    check(k7.INT8_LAUNCHES.count == 2 * want and torch.equal(qg, qg2),
          "4j int8: a replay's launches or tokens")
    with _PlainInt8(k7):
        k7.INT8_LAUNCHES.reset()
        plain, q_eager_s = timed(lambda: q.generate(
            ids, max_new_tokens=GEN_NEW, temperature=0.0))
        check(k7.INT8_LAUNCHES.count == 0, "4j: the plain run launched K7")
    check(torch.equal(plain, qg), "4j int8: the graph (K7) != eager "
                                  "generate with K7's plain version")
    gen = torch.Generator(device="cuda").manual_seed(17)
    for k, n in INT8_SHAPES[:4]:
        x, qw, ws, sx, biases = int8_inputs(torch, gen, GEN_B, k, n,
                                            torch.bfloat16)
        check(torch.equal(k7.int8_linear_fused(x, qw, ws, sx,
                                               biases["fp32 bias"]),
                          k7.int8_linear_plain(x, qw, ws, sx,
                                               biases["fp32 bias"])),
              f"4j: K7 {GEN_B}x{k}x{n} != plain")
    agree = float((qg[:, GEN_PROMPT:] == graph[:, GEN_PROMPT:]).float()
                  .mean())
    log(f"  int8-PTQ GPT-small generate_jit [card: {card}]: K7 launches "
        f"{want} = 4 x {q.cfg.num_layers} x {GEN_NEW - 1} per replay; "
        f"{q_graph_s * 1e3 / GEN_NEW:.3f} ms per step (eager with K7's "
        f"plain version {q_eager_s * 1e3 / GEN_NEW:.3f}); tokens equal "
        f"the plain version's; {agree:.3f} of the generated tokens equal "
        f"the bf16 model's; K7 == plain at 4 x (768x2304, 768x768, "
        f"768x3072, 3072x768)")
    return {"eager_ms_per_step": eager_s * 1e3 / GEN_NEW,
            "graph_ms_per_step": graph_s * 1e3 / GEN_NEW,
            "eager_ms_per_token": eager_s * 1e3 / (GEN_NEW * GEN_B),
            "graph_ms_per_token": graph_s * 1e3 / (GEN_NEW * GEN_B),
            "first_call_s": first_s, "capture_s": entry.capture_s,
            "pool_bytes": entry.pool_bytes,
            "replay_kernels": n_kernels, "replay_busy_share": busy,
            "replay_top_kernels": top,
            "beam4_ms_per_step": beam_s * 1e3 / GEN_NEW,
            "beam_capture_s": beam_entry.capture_s,
            "beam_pool_bytes": beam_entry.pool_bytes,
            "captures": captures(model),
            "int8_k7_launches": want,
            "int8_graph_ms_per_step": q_graph_s * 1e3 / GEN_NEW,
            "int8_eager_plain_ms_per_step": q_eager_s * 1e3 / GEN_NEW,
            "int8_first_call_s": q_first_s, "int8_agree_bf16": agree}


# --------------------------------------------------------------------------- #
# phase 4k: observability, host swap, page payloads, the serving artifact
# --------------------------------------------------------------------------- #

SWAP_PAGE_COUNTS = (1, 9, 16)     # pages per timed swap (64-row pages)


def swap_timing(torch, np, model, card):
    """swap_out / swap_in of one request at 1, 9 and 16 bf16 pages: the
    engine's swap_out (discard, gather, one sync, release) of a first
    request (cold: its pinned payload buffer is allocated) and, after
    that payload was uploaded back and freed, of a second request of the
    same size (warm: the pinned block is reused); then the cache's
    gather (one device buffer, one pinned copy, one sync) and scatter
    (an upload and an index copy per slab leaf, then a sync) as medians
    of 5, beside the bytes moved and a plain pinned device-to-host copy
    of the same bytes (the host-copy rate those bytes are held to)."""
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    out = {}
    for n in SWAP_PAGE_COUNTS:
        # rows P + 8 and P + 16 (after one and two blocks) both span n
        # 64-row pages
        prompts = [np.random.RandomState(n + i).randint(
            0, model.cfg.vocab_size, (64 * n - 40,)).astype(np.int32)
            for i in range(2)]
        eng = LLMEngine(model, **SERVE_KW, kv_layout="paged")
        rids = [eng.submit(p, SamplingParams(max_new_tokens=24))
                for p in prompts]
        eng.step()
        swap_ms = []
        for rid in rids:
            slot = next(s for s, r in eng._active.items() if r.rid == rid)
            check(eng.cache.span_pages(eng.cache.length(slot)) == n,
                  f"4k timing: request {rid} does not span {n} pages")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check(eng.swap_out(rid), "4k timing: swap_out failed")
            swap_ms.append((time.perf_counter() - t0) * 1e3)
            if rid == rids[0]:
                kv = eng._swapped[rid].kv_host
                nbytes = n * eng.cache.page_nbytes()
                check(sum(t.numel() * t.element_size()
                          for t in kv["k"] + kv["v"]) == nbytes,
                      "4k timing: payload bytes")
                fresh = eng.cache.pool.alloc(n)
                gather, scatter, copy = [], [], []
                dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
                host = torch.empty(nbytes, dtype=torch.uint8,
                                   pin_memory=True)
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    eng.cache.gather_pages(fresh)
                    gather.append((time.perf_counter() - t0) * 1e3)
                    t0 = time.perf_counter()
                    eng.cache.scatter_pages(fresh, kv["k"], kv["v"])
                    torch.cuda.synchronize()
                    scatter.append((time.perf_counter() - t0) * 1e3)
                    t0 = time.perf_counter()
                    host.copy_(dev, non_blocking=True)
                    torch.cuda.synchronize()
                    copy.append((time.perf_counter() - t0) * 1e3)
                for p in fresh:
                    eng.cache.pool.unref(p)
                del kv, dev, host
                # the upload frees the first payload before the second
                # swap
                check(eng.swap_in(rid), "4k timing: swap_in")
                eng.step()
                check(rid in eng.decoding_rids(), "4k timing: re-admit")
        for rid in rids[1:]:
            check(eng.swap_in(rid), "4k timing: swap_in")
        eng.run_until_complete(max_steps=200)
        check(leaked_pages(eng) == 0, "4k timing: leaked pages")
        rate = nbytes / (statistics.median(copy) / 1e3)
        out[n] = {"pages": n, "bytes": nbytes,
                  "swap_out_cold_ms": swap_ms[0],
                  "swap_out_warm_ms": swap_ms[1],
                  "gather_ms": statistics.median(gather),
                  "scatter_ms": statistics.median(scatter),
                  "host_copy_ms": statistics.median(copy),
                  "host_copy_bytes_per_s": rate}
        log(f"  swap [card: {card}] {n} pages ({nbytes} B): swap_out "
            f"{swap_ms[0]:.3f} ms cold (its pinned buffer allocated), "
            f"{swap_ms[1]:.3f} ms warm; gather {out[n]['gather_ms']:.3f} "
            f"ms, scatter (swap_in's upload) {out[n]['scatter_ms']:.3f} "
            f"ms; the bytes over the pinned copy rate "
            f"{out[n]['host_copy_ms']:.3f} ms ({rate / 1e9:.2f} GB/s)")
        del eng
    return out


def phase_obs_swap(torch, np, dec, k7, engine_run, variants, int8_run):
    """(4k) GPT-small bf16, phase 4's model: (a) phase 4's load on the
    paged layout (`decode_block_size=8`, `overlap=True`) with the pool
    starved to the spans of the first 8 requests, so the queue waits on
    pages; 2 of the 8 decoding requests swapped out mid-run (no block
    in flight: the queue is not empty), the queue admitted into the
    freed pages, both swapped back in: streams bitwise phase 4b's
    (unswapped) K4 streams, pages out = pages in, swap host syncs = 2,
    0 leaked pages, K4 launches = layers x decode steps; again under
    kv_dtype="int8" (K6, against 4b's K6 streams). (b) the engine's
    snapshot with one parked request, pickled, resumed in a fresh
    engine: the parked request computes 0 prefill tokens and its tokens
    are 4b's. (c) a paged `extract` then `adopt` on a second engine: 0
    prefill tokens at the adopter, a bitwise continuation. (d) phase
    4's load (slotted, K1) with `trace=True` and `trace=False`, twice
    each alternating: decode ms per step of each and the ratio (no
    gate); on a traced run one span tree per request, one decode_block
    event per processed block, `to_prometheus()` strict-parsed,
    `to_prometheus` / `export_trace` host ms. The capture watchdog of
    every engine of the phase reads 0 unexpected. (e) an injected
    `decode_dispatch` exhaustion writes one flight dump into a temporary
    directory. (f) `save_for_serving` of phase 4d's PTQ model, then
    `load_engine` on the card: 4d's streams bitwise, 48 K7 launches per
    decode step."""
    import pickle
    import tempfile
    from paddle_tpu_torch import obs
    from paddle_tpu_torch.serving import (LLMEngine, SamplingParams,
                                          load_engine, save_for_serving)
    from paddle_tpu_torch.testing import faults
    model, prompts, params = (engine_run[k] for k in
                              ("model", "prompts", "params"))
    layers = model.cfg.num_layers
    counters = decode_counters(dec)
    card = card_line()
    engines = []
    res = {}

    # --- (a) swap round trip under page pressure ------------------------ #
    spans = [-(-(p.size + sp.max_new_tokens) // 64)
             for p, sp in zip(prompts, params)]
    kv_pages = 1 + sum(spans[:8])
    for name, knobs in (("K4", dict(kv_layout="paged")),
                        ("K6", dict(kv_layout="paged", kv_dtype="int8"))):
        eng = LLMEngine(model, **SERVE_KW, **knobs, kv_pages=kv_pages)
        engines.append(eng)
        for c in counters.values():
            c.reset()
        rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
        moved, admitted_after = [], None
        t0 = time.perf_counter()
        for _ in range(400):
            if not eng.has_work() and not eng.swapped_rids:
                break
            if not moved and len(eng.decoding_rids()) == 8 \
                    and eng.pending:
                check(eng._inflight is None, "4k (a): a block in flight")
                pending = eng.pending
                moved = eng.decoding_rids()[:2]
                for rid in moved:
                    check(eng.swap_out(rid), f"4k (a): swap_out {rid}")
            elif moved and admitted_after is None and eng.pending < pending:
                admitted_after = eng.pending
            elif admitted_after is not None and eng.swapped_rids:
                for rid in moved:
                    check(eng.swap_in(rid), f"4k (a): swap_in {rid}")
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(len(moved) == 2 and admitted_after is not None,
              f"4k (a) {name}: moved {moved}, queue after {admitted_after}")
        streams = [eng.result(r).token_ids for r in rids]
        check(streams == variants[name]["streams"],
              f"4k (a) {name}: swapped streams != 4b's unswapped streams")
        st = eng.stats()
        counts = {k: c.count for k, c in counters.items()}
        want = {k: layers * st["decode_steps"] if k == name else 0
                for k in counters}
        check(counts == want, f"4k (a) {name}: launches {counts} != {want}")
        check(st["swap_outs"] == st["swap_ins"] == 2
              and st["pages_swapped_out"] == st["pages_swapped_in"] > 0,
              f"4k (a) {name}: swap counters {st['swap_outs']} / "
              f"{st['swap_ins']}, pages {st['pages_swapped_out']} / "
              f"{st['pages_swapped_in']}")
        check(st["swap_host_syncs"] == 2, f"4k (a) {name}: swap host syncs "
                                          f"{st['swap_host_syncs']}")
        check(st["host_syncs"] == st["decode_dispatches"],
              f"4k (a) {name}: host syncs")
        check(leaked_pages(eng) == 0, f"4k (a) {name}: leaked pages")
        res[f"a_{name}"] = {
            "kv_pages": kv_pages, "moved": moved, "wall_s": wall,
            "pages_swapped": st["pages_swapped_out"],
            "launches": counts[name], "decode_steps": st["decode_steps"],
            "tbt_p99_s": st["tbt_p99_s"]}
        log(f"  (a) {name} kv_pages {kv_pages}: requests {moved} swapped "
            f"out ({st['pages_swapped_out']} pages) and back in; the queue "
            f"admitted into the freed pages; 16 streams == 4b's; {name} "
            f"launches {counts[name]} = {layers} x {st['decode_steps']}; "
            f"swap host syncs 2; 0 leaked; {wall:.2f} s")

    # --- (b) snapshot with a parked request, resumed ---------------------- #
    sub, sub_params = prompts[:4], params[:4]
    ref = variants["K4"]["streams"][:4]
    eng = LLMEngine(model, **SERVE_KW, kv_layout="paged")
    engines.append(eng)
    rids = [eng.submit(p, sp) for p, sp in zip(sub, sub_params)]
    while len(eng.decoding_rids()) < 4:
        eng.step()
    eng.step()
    parked = eng.decoding_rids()[0]
    check(eng.swap_out(parked), "4k (b): swap_out")
    snap = pickle.loads(pickle.dumps(eng.snapshot()))
    check([d["rid"] for d in snap["swapped"]] == [parked]
          and snap["swapped"][0]["kv_pages"]["rows"] > 0,
          "4k (b): the snapshot's swapped entry")
    eng2 = LLMEngine.resume(model, snap)
    engines.append(eng2)
    check(eng2.swapped_rids == [parked], "4k (b): not parked on resume")
    eng2.run_until_complete(max_steps=400)
    pf = eng2.metrics.prefill_tokens_computed
    check(eng2.swap_in(parked), "4k (b): swap_in")
    eng2.run_until_complete(max_steps=400)
    check(eng2.metrics.prefill_tokens_computed == pf,
          "4k (b): the parked request prefilled")
    check([eng2.result(r).token_ids for r in rids] == ref,
          "4k (b): resumed streams != 4b's")
    check(leaked_pages(eng2) == 0, "4k (b): leaked pages")
    res["b_resumed_prefill_tokens"] = pf
    log(f"  (b) snapshot with request {parked} parked, pickled, resumed: "
        f"it reactivated with 0 prefill tokens; 4 streams == 4b's")

    # --- (c) paged extract -> adopt ----------------------------------------- #
    a = LLMEngine(model, **SERVE_KW, kv_layout="paged")
    b = LLMEngine(model, **SERVE_KW, kv_layout="paged")
    engines += [a, b]
    rids = [a.submit(p, sp) for p, sp in zip(sub, sub_params)]
    while len(a.decoding_rids()) < 4:
        a.step()
    a.step()
    moved = a.decoding_rids()[1]
    d = pickle.loads(pickle.dumps(a.extract(moved)))
    check(d["kv_pages"]["rows"] > 0, "4k (c): no pages in the handoff")
    b.advance_salt_clock(a.salt_clock())
    b.adopt(d, keep_salt=True)
    a.run_until_complete(max_steps=400)
    b.run_until_complete(max_steps=400)
    st = b.stats()
    check(st["prefill_tokens_computed"] == 0 and st["replay_steps"] == 0,
          f"4k (c): the adopter computed {st['prefill_tokens_computed']} "
          f"prefill tokens, {st['replay_steps']} replay steps")
    got = [(b if r == moved else a).result(r).token_ids for r in rids]
    check(got == ref, "4k (c): handoff streams != 4b's")
    check(leaked_pages(a) == 0 and leaked_pages(b) == 0,
          "4k (c): leaked pages")
    log(f"  (c) request {moved} extracted with {d['kv_pages']['n_pages']} "
        f"pages and adopted: 0 prefill tokens at the adopter, streams == "
        f"4b's")

    # --- (d) tracing on the hot path ---------------------------------------- #
    runs = {True: [], False: []}
    traced = None
    for trace in (True, False, True, False):
        eng = LLMEngine(model, **SERVE_KW, trace=trace)
        engines.append(eng)
        results = eng.generate(prompts, params)
        torch.cuda.synchronize()
        check([r.token_ids for r in results] == engine_run["streams"],
              f"4k (d): trace={trace} streams != phase 4's")
        runs[trace].append(eng.stats()["decode_ms_per_token"])
        if trace:
            traced = eng
    st = traced.stats()
    events = traced.tracer.events()
    check(traced.tracer.dropped == 0, "4k (d): the ring dropped events")
    blocks = [e for e in events if e[2] == "decode_block"]
    check(len(blocks) == st["decode_dispatches"],
          f"4k (d): {len(blocks)} decode_block events != "
          f"{st['decode_dispatches']} blocks")
    t0 = time.perf_counter()
    trace_dict = traced.export_trace()
    export_ms = (time.perf_counter() - t0) * 1e3
    spans = obs.request_spans(events)
    check(sorted(spans) == list(range(len(prompts))) and all(
        t["finished"] is not None and t["admissions"] and t["decode_blocks"]
        for t in spans.values()), "4k (d): a request's span tree")
    check(trace_dict["otherData"]["requests"] == len(prompts),
          "4k (d): the exported trace")
    t0 = time.perf_counter()
    text = traced.to_prometheus()
    prom_ms = (time.perf_counter() - t0) * 1e3
    obs.parse_exposition(text)
    on, off = statistics.median(runs[True]), statistics.median(runs[False])
    res["d"] = {"trace_on_ms_per_step": runs[True],
                "trace_off_ms_per_step": runs[False], "ratio": on / off,
                "events": len(events), "to_prometheus_ms": prom_ms,
                "export_trace_ms": export_ms,
                "exposition_lines": len(text.splitlines())}
    log(f"  (d) [card: {card}] decode ms per step, trace on {runs[True]} / "
        f"off {runs[False]}: medians {on:.4f} / {off:.4f}, ratio "
        f"{on / off:.4f}; {len(events)} events, one decode_block per block "
        f"({len(blocks)}); to_prometheus {prom_ms:.3f} ms "
        f"({len(text.splitlines())} lines, strict-parsed), export_trace "
        f"{export_ms:.3f} ms")

    # --- (e) the flight recorder -------------------------------------------- #
    with tempfile.TemporaryDirectory() as tmp:
        plan = faults.FaultPlan().fail_at("decode_dispatch", *range(1, 9))
        eng = LLMEngine(model, **SERVE_KW, max_retries=1,
                        retry_backoff_s=0.0, flight_dir=tmp)
        engines.append(eng)
        with faults.inject(plan):
            out = eng.generate(prompts[:2], SamplingParams(max_new_tokens=8))
        check({r.finish_reason for r in out} == {"error"},
              "4k (e): the requests did not fail")
        files = os.listdir(tmp)
        check(len(files) == 1 and len(plan.postmortems) == 1
              and plan.postmortems[0]["reason"] == "decode_retry_exhausted",
              f"4k (e): flight dumps {files}")
        rep = json.load(open(os.path.join(tmp, files[0])))
        check(sorted(rep["detail"]["failed_rids"]) == [0, 1]
              and rep["events"], "4k (e): the dump's content")
    log(f"  (e) decode_dispatch exhausted: one flight dump ({files[0]}, "
        f"{len(rep['events'])} events, failed rids "
        f"{rep['detail']['failed_rids']})")

    # --- the watchdog over every engine of the phase ------------------------ #
    for eng in engines:
        check(eng.watchdog.compiles_unexpected == 0,
              f"4k: {eng.name} watchdog {eng.watchdog.counts()}")
    res["watchdog_budget"] = traced.watchdog.budget_total
    res["watchdog_total"] = traced.watchdog.compiles_total
    log(f"  the capture watchdog of all {len(engines)} engines: 0 "
        f"unexpected (traced engine {traced.watchdog.snapshot()})")
    del engines, eng, eng2, a, b, traced

    # --- (f) the serving artifact ------------------------------------------- #
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        prefix = save_for_serving(int8_run["model"], os.path.join(tmp, "q"))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng = load_engine(prefix, **SPEC_KW)
        load_s = time.perf_counter() - t0
        k7.INT8_LAUNCHES.reset()
        got = [r.token_ids for r in eng.generate(prompts[:8], params[:8])]
        st = eng.stats()
        check(got == int8_run["streams"], "4k (f): artifact streams != 4d's")
        want = 4 * layers * st["decode_steps"]
        check(k7.INT8_LAUNCHES.count == want,
              f"4k (f): K7 launches {k7.INT8_LAUNCHES.count} != {want}")
        check(eng.watchdog.compiles_unexpected == 0, "4k (f): watchdog")
        nbytes = os.path.getsize(prefix + ".llm.params")
    res["f"] = {"save_s": save_s, "load_s": load_s, "params_bytes": nbytes,
                "k7_launches": want}
    log(f"  (f) int8-PTQ artifact ({nbytes} B) saved in {save_s:.2f} s, "
        f"loaded on the card in {load_s:.2f} s: 8 streams == 4d's, K7 "
        f"launches {want} = 48 x {st['decode_steps']} decode steps")
    del eng
    torch.cuda.empty_cache()
    res["swap_timing"] = swap_timing(torch, np, model, card)
    return res


# --------------------------------------------------------------------------- #
# phase 4l: the replica fleet, its KV tier and its autoscaler
# --------------------------------------------------------------------------- #

# the reference's accelerator settings of its tier and autoscale benches
FLEET_KW = dict(max_slots=4, max_seq=512, kv_layout="paged", page_size=64,
                seed=0, device="cuda")


def track_discards(eng):
    """Make `eng` count, in `discarded_steps`, the steps of dispatched
    blocks never processed: those its `_discard_inflight` throws away (a
    failed dispatch's retry, a swap) and those in flight when it is
    closed (a replica killed or retired mid-block, a drained engine):
    launched, and counted by the launch counters, but never processed.
    Returns `eng`."""
    eng.discarded_steps = 0
    discard, close = eng._discard_inflight, eng.close

    def outstanding():
        eng.discarded_steps += sum(b.steps for b in (eng._inflight,
                                                     eng._ahead)
                                   if b is not None)

    def counted():
        outstanding()
        discard()

    def closed():
        if not eng._closed:
            outstanding()
        close()

    eng._discard_inflight, eng.close = counted, closed
    return eng


def tracked_fleet(EngineFleet):
    """An `EngineFleet` that keeps every engine it builds (initial
    replicas, failover rebuilds, revives, spawns) in `built`, each
    counting its discarded steps (`track_discards`), so a run's decode
    and replay steps can be summed over engines that were closed on the
    way."""
    class Tracked(EngineFleet):
        def _build_engine(self, idx):
            eng = track_discards(super()._build_engine(idx))
            self.__dict__.setdefault("built", []).append(eng)
            return eng
    return Tracked


def engine_totals(engines, layers):
    """Over `engines`: decode steps, replay steps, discarded block steps
    (`track_discards`), the decode kernel launches they imply (layers
    per step), the watchdog's unexpected captures, and each engine's
    graph captures and capture seconds."""
    dsteps = rsteps = xsteps = unexpected = 0
    caps = []
    for eng in engines:
        st = eng.stats()
        dsteps += st["decode_steps"]
        rsteps += st["replay_steps"]
        xsteps += eng.discarded_steps
        unexpected += eng.watchdog.compiles_unexpected
        caps.append((eng.name.rsplit("_", 1)[-1], all_captures(eng),
                     round(st["graph_capture_s"]
                           + st["prefill_graph_capture_s"], 3)))
    return {"decode_steps": dsteps, "replay_steps": rsteps,
            "discarded_steps": xsteps,
            "launches_want": layers * (dsteps + rsteps + xsteps),
            "unexpected": unexpected, "captures": caps}


def steps_text(tot) -> str:
    return (f"({tot['decode_steps']} decode + {tot['replay_steps']} replay "
            f"+ {tot['discarded_steps']} discarded steps)")


def fleet_leaked(fleet) -> int:
    return sum(leaked_pages(eng) for eng in fleet.live_engines())


def tier_event_ms(fleet, kind):
    """Host ms of every `kind` event (tier_publish / tier_bind) of the
    fleet's live engines."""
    return [e[1] * 1e3 for eng in fleet.live_engines()
            for e in eng.tracer.events() if e[2] == kind]


def tier_ab(torch, np, dec, model, card, kv_dtype):
    """(4l a) bench_serve_kv_tier at its accelerator settings: 3 paged
    replicas, one 337-token shared prompt (5 aligned pages), 32 new
    tokens, a leader then 3 waves of 3, served with the tier off and
    on."""
    from paddle_tpu_torch.serving import EngineFleet, SamplingParams
    Fleet = tracked_fleet(EngineFleet)
    layers = model.cfg.num_layers
    name = "K6" if kv_dtype else "K4"
    counters = decode_counters(dec)
    replicas, waves, plen, page = 3, 3, 337, FLEET_KW["page_size"]
    aligned = (plen // page) * page
    shared = np.random.RandomState(0).randint(
        0, model.cfg.vocab_size, (plen,))
    sp = SamplingParams(max_new_tokens=32)
    runs = {}
    for with_tier in (False, True):
        fleet = Fleet(model, replicas=replicas, register_stats=False,
                      kv_tier=True if with_tier else None,
                      max_queue=replicas * waves + 4, kv_dtype=kv_dtype,
                      **FLEET_KW)
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        rids = [fleet.submit(shared, sp)]
        fleet.run_until_complete(max_steps=400)
        for _ in range(waves):
            rids += [fleet.submit(shared, sp) for _ in range(replicas)]
            fleet.run_until_complete(max_steps=400)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: c.count for k, c in counters.items()}
        res = [fleet.result(r) for r in rids]
        check(all(g.finish_reason == "length" for g in res),
              f"4l (a) {name} tier={with_tier}: a request did not finish")
        st = [eng.stats() for eng in fleet.live_engines()]
        tot = engine_totals(fleet.built, layers)
        want = {k: tot["launches_want"] if k == name else 0
                for k in counters}
        check(counts == want, f"4l (a) {name} tier={with_tier}: launches "
                              f"{counts} != {want}")
        check(tot["unexpected"] == 0,
              f"4l (a) {name}: unexpected captures")
        fst = fleet.stats()
        run = {
            "streams": [tuple(g.token_ids) for g in res],
            "reused": sum(s["prefix_tokens_reused"] for s in st),
            "computed": sum(s["prefill_tokens_computed"] for s in st),
            "hits": sum(s["kv_tier_hits"] for s in st),
            "publishes": int(fst.get("kv_tier_publishes", 0)),
            "routed_tier": fst["routed_tier"], "wall_s": wall,
            "launches": counts[name], **tot,
            "ttft_ms": [g.ttft_s * 1e3 for g in res],
            "publish_ms": tier_event_ms(fleet, "tier_publish"),
            "bind_ms": tier_event_ms(fleet, "tier_bind")}
        check(fleet_leaked(fleet) == 0, f"4l (a) {name}: leaked pages")
        fleet.close()
        runs["on" if with_tier else "off"] = run
    on, off = runs["on"], runs["off"]
    target = (replicas - 1) / replicas
    gain = (on["reused"] - off["reused"]) / float(replicas * aligned)
    check(len(set(off["streams"])) == 1
          and set(on["streams"]) == set(off["streams"]),
          f"4l (a) {name}: streams differ across tier on / off / leader")
    check(on["hits"] >= 4 and on["publishes"] >= 1 and off["hits"] == 0,
          f"4l (a) {name}: tier hits {on['hits']}, publishes "
          f"{on['publishes']}, tier-off hits {off['hits']}")
    check(0.8 * target <= gain <= 1.2 * target,
          f"4l (a) {name}: reuse gain {gain:.3f} outside 0.8-1.2 x "
          f"{target:.3f} (reused on {on['reused']} / off {off['reused']})")
    for key, run in runs.items():
        t = sorted(run["ttft_ms"])
        log(f"  (a) {name} tier {key} [card: {card}]: 13 requests in "
            f"{run['wall_s']:.2f} s, TTFT p50 {statistics.median(t):.2f} / "
            f"p99 {t[-1]:.2f} ms, reused {run['reused']} computed "
            f"{run['computed']} prefill tokens, tier hits {run['hits']} "
            f"publishes {run['publishes']}, {name} launches "
            f"{run['launches']} = {layers} x {steps_text(run)}; publish ms {[round(x, 3) for x in run['publish_ms']]}"
            f", bind ms {[round(x, 3) for x in run['bind_ms']]}; captures "
            f"(replica, graphs, s) {run['captures']}")
    log(f"  (a) {name}: streams identical tier on / off / leader; reuse "
        f"gain {gain:.4f} of {replicas} x {aligned} (target {target:.4f}, "
        f"gate 0.8-1.2x); 0 leaked, 0 unexpected captures")
    for run in runs.values():
        run.pop("streams")
    return {"gain": gain, "target": target, **runs}


def autoscale_load(torch, np, dec, model, card):
    """(4l b) bench_serve_autoscale at its accelerator settings: 16
    Poisson arrivals at 8/s then 48 at 32/s, prompts of 96 tokens, 96
    new tokens, 1-3 replicas behind a FleetAutoscaler, the busiest
    replica killed (no revive) during the step."""
    from paddle_tpu_torch.serving import (AutoscalePolicy, EngineFleet,
                                          FleetAutoscaler, SamplingParams)
    from paddle_tpu_torch.serving.metrics import nearest_rank_p99
    Fleet = tracked_fleet(EngineFleet)
    layers = model.cfg.num_layers
    counters = decode_counters(dec)
    n_a, n_b, rate_a, new_toks, plen = 16, 48, 8.0, 96, 96
    rng = np.random.RandomState(0)
    V = model.cfg.vocab_size
    fleet = Fleet(model, replicas=1, snapshot_every=2,
                  quarantine_backoff_s=0.01, register_stats=False,
                  max_queue=n_a + n_b + 8, **FLEET_KW)
    scaler = FleetAutoscaler(fleet, AutoscalePolicy(
        min_replicas=1, max_replicas=3, out_backlog=1.5, out_hold_s=0.02,
        in_hold_s=0.5, out_cooldown_s=0.05, in_cooldown_s=1.0),
        heartbeat_timeout_s=1.0)
    # the first replica's graphs, outside the measured window (later
    # replicas capture theirs on their canary)
    fleet.generate([rng.randint(0, V, (plen,))],
                   SamplingParams(max_new_tokens=new_toks))
    arr_a = np.cumsum(rng.exponential(1.0 / rate_a, size=n_a))
    arr_b = arr_a[-1] + np.cumsum(
        rng.exponential(1.0 / (4.0 * rate_a), size=n_b))
    arrivals = np.concatenate([arr_a, arr_b])
    prompts = [rng.randint(0, V, (plen,)) for _ in range(n_a + n_b)]
    sp = SamplingParams(max_new_tokens=new_toks)
    submit_t, first_t = {}, {}

    def sink_for(rid):
        def sink(kind, *payload):
            if kind == "tokens" and rid not in first_t:
                first_t[rid] = time.perf_counter()
        return sink

    for c in counters.values():
        c.reset()
    base = {id(e): (e.stats()["decode_steps"], e.stats()["replay_steps"],
                    e.discarded_steps) for e in fleet.built}
    rids, peak, killed, i = [], 1, -1, 0
    t0 = time.perf_counter()
    while (i < len(prompts) or fleet.has_work()) \
            and time.perf_counter() - t0 < 120:
        now = time.perf_counter() - t0
        while i < len(prompts) and arrivals[i] <= now:
            rid = fleet.submit(prompts[i], sp)
            submit_t[rid] = time.perf_counter()
            fleet.attach_stream(rid, sink_for(rid))
            rids.append(rid)
            i += 1
        if fleet.has_work():
            fleet.step()
            serving = sum(1 for s in fleet.replica_states()
                          if s in ("healthy", "suspect"))
            peak = max(peak, serving)
            if killed < 0 and i > n_a + n_b // 2 and serving >= 2:
                killed = fleet.busiest()
                fleet.kill(killed)
        elif i < len(prompts):
            time.sleep(min(0.002, max(arrivals[i] - now, 0.0)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stranded = sum(1 for r in rids if not fleet.has_result(r))
    res = {r: fleet.result(r) for r in rids if fleet.has_result(r)}
    t_settle = time.perf_counter()
    while time.perf_counter() - t_settle < 10.0:
        fleet.step()
        if len(fleet.replica_states()) <= 1:
            break
    settle_s = time.perf_counter() - t_settle
    settled = sum(1 for s in fleet.replica_states()
                  if s in ("healthy", "suspect"))
    counts = {k: c.count for k, c in counters.items()}
    tot = engine_totals(fleet.built, layers)
    done = sum(layers * sum(n) for n in base.values())
    want = {k: tot["launches_want"] - done if k == "K4" else 0
            for k in counters}
    leaked = fleet_leaked(fleet)
    fst = fleet.stats()
    events = scaler.events()
    fleet.close()
    ttft = {r: (first_t[r] - submit_t[r]) * 1e3 for r in rids
            if r in first_t}
    steady = [ttft[r] for r in rids[:n_a] if r in ttft]
    step = [ttft[r] for r in rids[n_a:] if r in ttft]
    p99_steady, p99_step = nearest_rank_p99(steady), nearest_rank_p99(step)
    ratio = p99_step / max(p99_steady, 1e-9)
    policy_outs = sum(1 for _, k, d in events
                      if k == "scale_out" and "(policy)" in d)
    replaced = any(k == "scale_out" and "replace" in d
                   for _, k, d in events)
    check(stranded == 0, f"4l (b): {stranded} stranded")
    check(all(g.finish_reason == "length" for g in res.values()),
          "4l (b): a request did not finish")
    check(leaked == 0, f"4l (b): {leaked} leaked pages")
    check(tot["unexpected"] == 0, "4l (b): unexpected captures")
    check(counts == want, f"4l (b): launches {counts} != {want}")
    check(policy_outs >= 1 and peak >= 2,
          f"4l (b): no policy scale-out (peak {peak})")
    check(killed >= 0 and replaced, f"4l (b): the kill of r{killed} was "
                                    f"not replaced ({events})")
    check(settled == 1, f"4l (b): settled at {settled} replicas")
    check(ratio <= 15.0, f"4l (b): ttft p99 step/steady {ratio:.2f} > 15")
    log(f"  (b) [card: {card}] {n_a}+{n_b} requests at {rate_a:.0f} -> "
        f"{4 * rate_a:.0f}/s in {wall:.2f} s: replicas 1 -> {peak} -> "
        f"{settled} (settled in {settle_s:.2f} s), policy scale-outs "
        f"{policy_outs}, scale-ins {scaler.scale_ins}, r{killed} killed "
        f"and replaced, {fst['requests_drained']} drained; TTFT p99 "
        f"steady {p99_steady:.1f} ms, step {p99_step:.1f} ms, ratio "
        f"{ratio:.2f} (limit 15: every replica shares this one card, the "
        f"reference's time-share case; its 3x assumes a chip per replica);"
        f" K4 launches {counts['K4']} = {layers} x {steps_text(tot)} "
        f"less the warm-up's; 0 stranded, 0 leaked, 0 unexpected "
        f"captures; captures (replica, graphs, s) {tot['captures']}")
    return {"wall_s": wall, "peak": peak, "settled": settled,
            "settle_s": settle_s, "policy_scale_outs": policy_outs,
            "scale_ins": scaler.scale_ins, "killed": killed,
            "drained": fst["requests_drained"],
            "ttft_p99_steady_ms": p99_steady, "ttft_p99_step_ms": p99_step,
            "ratio": ratio, "launches": counts["K4"], **tot}


def kill_soak(torch, np, dec, model, card):
    """(4l c) `python -m paddle_tpu_torch.serving`'s kill soak at
    GPT-small: 3 replicas, prefix affinity, the busiest killed after 3
    rounds and revived through the canary; once slotted (K1), once paged
    with roles (prefill, decode, decode) and the KV tier (K4), where the
    handoffs carry pages through extract / adopt and the tier."""
    from paddle_tpu_torch.serving import (EngineFleet, LLMEngine,
                                          SamplingParams)
    from paddle_tpu_torch.serving.__main__ import run_soak, soak_prompts
    Fleet = tracked_fleet(EngineFleet)
    layers = model.cfg.num_layers
    counters = decode_counters(dec)
    prompts = soak_prompts(18, 16, 0)
    out = {}
    for name, knobs in (
            ("K1", {}),
            ("K4", dict(kv_layout="paged", page_size=16, kv_tier=True,
                        roles=("prefill", "decode", "decode")))):
        eng_kw = dict(max_slots=2, max_seq=96, prefix_block=8, seed=0,
                      device="cuda",
                      **{k: v for k, v in knobs.items()
                         if k in ("kv_layout", "page_size")})
        ref = LLMEngine(model, register_stats=False, **eng_kw)
        want = [r.token_ids for r in ref.generate(
            prompts, SamplingParams(max_new_tokens=12))]
        fleet = Fleet(model, replicas=3, routing="prefix_affinity",
                      snapshot_every=2, quarantine_backoff_s=0.01,
                      register_stats=False,
                      **{k: v for k, v in knobs.items()
                         if k in ("kv_tier", "roles")}, **eng_kw)
        for c in counters.values():
            c.reset()
        report, results, rids = run_soak(fleet, prompts, 12, 3)
        torch.cuda.synchronize()
        counts = {k: c.count for k, c in counters.items()}
        tot = engine_totals(fleet.built, layers)
        st = fleet.stats()
        check(report["stranded_requests"] == 0
              and report["failed_requests"] == 0,
              f"4l (c) {name}: {report}")
        check([results[r].token_ids for r in rids] == want,
              f"4l (c) {name}: soak streams != one undisturbed engine's")
        check(counts == {k: tot["launches_want"] if k == name else 0
                         for k in counters},
              f"4l (c) {name}: launches {counts} != {tot['launches_want']}")
        check(tot["unexpected"] == 0, f"4l (c) {name}: unexpected captures")
        check(report["failovers"] == 1 and report["canary_probes"] >= 1,
              f"4l (c) {name}: failover {report}")
        if name == "K4":
            check(st["handoffs"] > 0
                  and st["tier_handoffs"] == st["handoffs"]
                  and st["kv_tier_handoffs_open"] == 0,
                  f"4l (c): handoffs {st['handoffs']}, through the tier "
                  f"{st['tier_handoffs']}")
            check(fleet_leaked(fleet) == 0, "4l (c): leaked pages")
        fleet.close()
        out[name] = {**report, "launches": counts[name],
                     "handoffs": st["handoffs"],
                     "handoff_pages_moved": st["handoff_pages_moved"], **tot}
        log(f"  (c) {name} {knobs or 'slotted'} [card: {card}]: 18 "
            f"requests, r{report['killed_replica']} killed after 3 rounds "
            f"and revived ({report['canary_probes']} canaries), "
            f"{report['readmitted_requests']} re-admitted + "
            f"{report['resubmitted_requests']} re-submitted, handoffs "
            f"{st['handoffs']} ({st['handoff_pages_moved']} pages); greedy "
            f"streams == one engine's; TTFT p99 affected "
            f"{report['ttft_p99_failover_s'] * 1e3:.1f} ms, steady "
            f"{report['ttft_p99_steady_s'] * 1e3:.1f} ms; {name} launches "
            f"{counts[name]} = {layers} x {steps_text(tot)}; exposition "
            f"strict-parsed; 0 stranded; captures (replica, graphs, s) "
            f"{tot['captures']}")
    return out


def capture_amid_garbage(torch, np, model, card):
    """(4l d) A dead engine's CUDA graphs freed inside another engine's
    capture invalidate it (`cudaErrorStreamCaptureInvalidated`); the
    cycle collector frees them wherever it happens to run, as it did
    after a fleet phase. A captured engine is dropped inside a reference
    cycle, then a fresh engine captures its prefill and decode block
    with the collector set to run at nearly every allocation: the dead
    engine is collected, no collection starts inside a capture (the
    capture pauses the collector), and the stream equals the dead
    engine's."""
    import gc
    import weakref
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    kw = dict(max_slots=2, max_seq=256, register_stats=False, seed=0,
              device="cuda")
    sp = SamplingParams(max_new_tokens=8)
    prompt = np.random.RandomState(3).randint(0, model.cfg.vocab_size,
                                              (200,))
    dead = LLMEngine(model, **kw)
    want = dead.generate([prompt], sp)[0].token_ids
    dead.cycle = dead
    gone = weakref.ref(dead)
    del dead
    seen = {"collections": 0, "in_capture": 0}

    def watch(phase, info):
        if phase == "start":
            seen["collections"] += 1
            seen["in_capture"] += torch.cuda.is_current_stream_capturing()

    thresholds = gc.get_threshold()
    gc.callbacks.append(watch)
    gc.set_threshold(1, 1, 1)
    t0 = time.perf_counter()
    try:
        eng = LLMEngine(model, **kw)
        got = eng.generate([prompt], sp)[0].token_ids
    finally:
        gc.set_threshold(*thresholds)
        gc.callbacks.remove(watch)
    secs = time.perf_counter() - t0
    caps = all_captures(eng)
    eng.close()
    check(got == want, "4l (d): the stream differs from the dead engine's")
    check(gone() is None, "4l (d): the dead engine was not collected")
    check(seen["collections"] > 0 and seen["in_capture"] == 0,
          f"4l (d): collections {seen}")
    check(caps >= 2, f"4l (d): {caps} captures")
    log(f"  (d) [card: {card}] {caps} captures amid {seen['collections']} "
        f"cycle collections, none inside a capture, the dead engine "
        f"collected, stream == the dead engine's ({secs:.2f} s)")
    return {**seen, "captures": caps, "seconds": secs}


def phase_fleet(torch, np, dec, engine_run):
    """(4l) GPT-small bf16, phase 4's model, through `EngineFleet`: (a)
    the KV tier A/B, fp and int8 KV; (b) the autoscale load; (c) the
    kill soak, slotted and disaggregated; (d) captures amid garbage."""
    model = engine_run["model"]
    card = card_line()
    t0 = time.perf_counter()
    res = {"a_K4": tier_ab(torch, np, dec, model, card, None),
           "a_K6": tier_ab(torch, np, dec, model, card, "int8"),
           "b": autoscale_load(torch, np, dec, model, card),
           "c": kill_soak(torch, np, dec, model, card),
           "d": capture_amid_garbage(torch, np, model, card)}
    res["seconds"] = time.perf_counter() - t0
    log(f"  phase 4l: {res['seconds']:.1f} s")
    return res


# the front-door soak's configurations (4m): the soak's own flags, the
# decode kernels the run must launch (every other decode kernel and K7
# launch 0 times) and whether the drain must find work in flight, so
# that the restart resumes from its snapshot and reattaches by id. With
# the reference's drain after 12 completions a lone engine on the card
# has finished every stream by then; (f) drains after 4, while stream 3
# (16x, arriving at 225 ms) still decodes.
FRONT_DOOR_CONFIGS = (
    ("a", "slotted", [], ("K1",), False),
    ("b", "paged int8", ["--paged", "--kv-dtype", "int8"], ("K6",), False),
    ("c", "2 replicas, kill + revive", ["--replicas", "2"], ("K1",),
     False),
    ("d", "speculate 4, int8 draft", ["--speculate", "4", "--draft",
                                      "int8"], ("K1", "K7"), False),
    ("e", "autoscale", ["--autoscale"], ("K1",), False),
    ("f", "paged int8, drain after 4", ["--paged", "--kv-dtype", "int8",
                                        "--drain-after", "4"], ("K6",),
     True))


@contextlib.contextmanager
def served_engines():
    """Inside the block, every engine `paddle_tpu_torch.serving` builds
    (an `LLMEngine`, its `resume`, or a fleet's replica) is appended to
    the list this yields, counting its discarded steps
    (`track_discards`)."""
    from unittest import mock
    from paddle_tpu_torch.serving import engine as E
    from paddle_tpu_torch.serving import fleet as F
    built = []

    class Engine(E.LLMEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(track_discards(self))

    class Fleet(F.EngineFleet):
        def _build_engine(self, idx):
            eng = track_discards(super()._build_engine(idx))
            built.append(eng)
            return eng

    with mock.patch.object(E, "LLMEngine", Engine), \
            mock.patch.object(F, "EngineFleet", Fleet):
        yield built


def soak_page_kernels(torch, dec, card):
    """(4m) K4 and K6 at the paged soak's shapes, 8-row pages: 4 lanes
    of max_seq 256 (block_k shrinks to the page), bf16 queries, lengths
    at the page edges and across the soak's streams (prompts of 4-15
    tokens, 12 or 192 new tokens)."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    worst = {"K4": 0.0, "K6": 0.0}
    for lname, lengths in (("edges", [1, 7, 8, 9]),
                           ("streams", [15, 27, 207, 256]),
                           ("short", [0, 4, 16, 100])):
        tag = f"8-row pages, T 256, 4 lanes, {lname} {lengths}"
        errs = hold_paged_kernels(torch, dec, gen, 4, 256, 8,
                                  torch.bfloat16, lengths, ("K4", "K6"),
                                  tag)
        for k, e in errs.items():
            worst[k] = max(worst[k], e)
    log(f"  [card: {card}] K4 and K6 at 8-row pages within bf16 "
        f"atol=rtol=2e-2 of their plain versions (worst {worst}); K4 == "
        f"K1 bitwise")
    return worst


def front_door_soak(torch, dec, k7, model, card, tag, what, argv, kernels,
                    resumes, tp: int = 1, phase: str = "4m"):
    """(4m) one configuration of `python -m paddle_tpu_torch.serving.
    server`'s soak on `model`, on this (the main) thread: the soak's own
    gates (0 stranded, 0 bit mismatches, strict exposition, sheds with
    Retry-After, the tail gate, 0 leaked pages, the autoscale contract);
    with every launch counter set to 0 just before the soak and read
    when its servers have stopped (before its reference engine runs),
    its decode kernels (and K7) launched and no other, and but for the
    speculative run exactly 12 x (decode + replay + discarded steps)
    over the engines that served (tp x 12 for a soak at `--tp`); with
    `resumes`, a restart from the drain's snapshot that reattached a
    stream; the SIGTERM / SIGINT handlers as they were."""
    import gc
    import signal
    import tempfile
    from paddle_tpu_torch.serving import server as fd
    layers = model.cfg.num_layers
    counters = {**decode_counters(dec), "K7": k7.INT8_LAUNCHES}
    handlers = [signal.getsignal(s) for s in (signal.SIGTERM,
                                              signal.SIGINT)]
    seen = {}
    with tempfile.TemporaryDirectory() as d, served_engines() as built:
        args = fd.soak_parser().parse_args(
            ["--device", "cuda", "--server-out",
             os.path.join(d, "SERVER.json"), *argv])

        def served(backends):
            torch.cuda.synchronize()
            seen["counts"] = {k: c.count for k, c in counters.items()}
            seen["engines"] = list(built)

        # dead engines of earlier runs are collected here, on this
        # thread, before a worker thread captures
        gc.collect()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        rc, rep, extra = fd.run_soak(model, args, served=served)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    gc.collect()
    check(rc == 0,
          f"{phase} ({tag}) {what}: the soak's gates failed: {rep}")
    check([signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)]
          == handlers, f"{phase} ({tag}): signal handlers not restored")
    counts = seen["counts"]
    check(all(counts[k] > 0 if k in kernels else counts[k] == 0
              for k in counts),
          f"{phase} ({tag}) {what}: launches {counts}, want {kernels} "
          f"only")
    tot = engine_totals(seen["engines"], layers * tp)
    formula = ""
    if "K7" not in kernels:
        check(all(counts[k] == tot["launches_want"] for k in kernels),
              f"{phase} ({tag}) {what}: launches {counts} != "
              f"{tp * layers} x {steps_text(tot)} = "
              f"{tot['launches_want']}")
        formula = f" = {tp * layers} x {steps_text(tot)}"
    if resumes:
        check(rep["drain_snapshot"] and rep["reattached_streams"] > 0,
              f"{phase} ({tag}) {what}: the drain left no snapshot to "
              f"resume or no stream reattached: {rep}")
    if tag != "e":
        check(extra["builds_steady"] == 0,
              f"{phase} ({tag}): {extra['builds_steady']} captures in the "
              f"restarted server's window")
    keys = ("ttft_p99_steady_ms", "ttft_p99_shed_ms",
            "decode_ms_per_token", "ttft_tail_ratio", "shed_count",
            "disconnected_streams", "drain_snapshot", "reattached_streams",
            "killed_replica", "stranded_count", "bit_mismatches",
            "leaked_pages", "spec_acceptance_rate")
    out = {k: rep[k] for k in keys}
    if tag == "e":
        out.update({k: rep[k] for k in ("scale_outs", "scale_ins",
                                        "replicas_peak",
                                        "preempt_replaced")})
    out.update(extra, launches={k: counts[k] for k in kernels},
               engines=len(tot["captures"]),
               steps={k: tot[k] for k in ("decode_steps", "replay_steps",
                                          "discarded_steps")},
               seconds=secs)
    log(f"  ({tag}) {what} [card: {card}]: {rep['requests']} behaved + "
        f"{rep['flood_requests']} flood streams; ttft_p99 steady "
        f"{rep['ttft_p99_steady_ms']:.2f} ms ({extra['ttft_after']} "
        f"streams), under shedding {rep['ttft_p99_shed_ms']:.2f} ms "
        f"({extra['ttft_during']}); decode {rep['decode_ms_per_token']:.4f}"
        f" ms/token; tail ratio {rep['ttft_tail_ratio']:.2f} (gate "
        f"{rep['tail_gate_ratio']:g}, "
        f"{'disarmed: autoscale' if tag == 'e' else 'armed'}); "
        f"sheds {rep['shed_count']}, disconnects "
        f"{rep['disconnected_streams']}, drain snapshot "
        f"{rep['drain_snapshot']}, reattached "
        f"{rep['reattached_streams']}, killed r{rep['killed_replica']}; "
        f"launches {out['launches']}{formula} over "
        f"{len(tot['captures'])} engines; captures: "
        f"{extra['warm_programs']} warm-up, {extra['builds_serving']} "
        f"while serving, {extra['builds_steady']} in the restarted "
        f"server's window; {secs:.1f} s"
        + (f"; scale-outs {rep['scale_outs']}, scale-ins "
           f"{rep['scale_ins']}, peak {rep['replicas_peak']}, preemption"
           f" replaced" if tag == "e" else "")
        + (f"; acceptance {rep['spec_acceptance_rate']}" if tag == "d"
           else ""))
    return out


def phase_front_door(torch, np, dec, k7, engine_run):
    """(4m) The HTTP front door on phase 4's GPT-small bf16: K4 and K6
    at the paged soak's 8-row pages, then the front-door soak (48
    behaved + 24 flood streams, every 5th behaved stream disconnecting,
    the SIGTERM drain after 12, 4 slots, 12 new tokens (every 6th
    stream 16x), 75 ms spacing, prefill_budget 16, max_seq 256) in the
    configurations of FRONT_DOOR_CONFIGS."""
    model = engine_run["model"]
    card = card_line()
    t0 = time.perf_counter()
    res = {"page8_kernels": soak_page_kernels(torch, dec, card)}
    for tag, what, argv, kernels, resumes in FRONT_DOOR_CONFIGS:
        res[tag] = front_door_soak(torch, dec, k7, model, card, tag, what,
                                   argv, kernels, resumes)
    res["seconds"] = time.perf_counter() - t0
    log(f"  phase 4m: {res['seconds']:.1f} s")
    return res


# --------------------------------------------------------------------------- #
# phase 4n: TP-sharded serving, every rank on this one card
# --------------------------------------------------------------------------- #

TP_DEGREES = (2, 4)
TP_LOAD = 8        # phase 4's first 8 requests (2 of them sampled) ...
TP_NEW = 32        # ... and their first 32 tokens


def tp_kernels(torch, np, dec, card):
    """(4n) K1 and K4 per shard at phase-4 shapes (S 8, T 1024, hd 64,
    phase-4 lengths, 64-row pages at shuffled ids), fp32 and bf16: the
    sharded entries over 6-head (tp 2) and 3-head (tp 4) slabs launch
    tp kernels a call, each rank's output is within 1e-5 (fp32) / 2e-2
    (bf16) of its plain version (split + merge), and the ranks' outputs
    joined equal the unsharded 12-head launch bitwise (a CTA's work is
    one lane and head). Then K1 and K4 timed (bf16) at 12, 6 and 3
    heads beside each shape's byte bound, and the whole sharded call."""
    S, T, nh, hd = 8, 1024, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(21)
    lengths = serving_lengths(np, T)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    ident = torch.arange(S, dtype=torch.int32, device="cuda")
    scale = 1 / math.sqrt(hd)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    live = sum(lengths)
    worst, times = {"K1": 0.0, "K4": 0.0}, {}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype)[6:]
        q = torch.randn(S, nh, hd, device="cuda", generator=gen).to(dtype)
        kc = torch.randn(S, T, nh, hd, device="cuda", generator=gen).to(dtype)
        vc = torch.randn(S, T, nh, hd, device="cuda", generator=gen).to(dtype)
        tables, npages, _ = page_tables(torch, gen, S, T, lengths, PAGE)
        kp, vp = (to_pages(torch, x, tables, npages, PAGE) for x in (kc, vc))
        whole = {"K1": dec.ragged_decode_attention(q, kc, vc, lens),
                 "K4": dec.paged_ragged_decode_attention(q, kp, vp, tables,
                                                         lens)}
        for tp in TP_DEGREES:
            h = nh // tp

            def heads(x):
                return [x[:, :, r * h:(r + 1) * h].contiguous()
                        for r in range(tp)]

            shards = {"K1": (heads(kc), heads(vc)),
                      "K4": (heads(kp), heads(vp))}
            for name, counter in (("K1", dec.LAUNCHES),
                                  ("K4", dec.PAGED_LAUNCHES)):
                ks, vs = shards[name]
                if name == "K1":
                    def call(ks=ks, vs=vs):
                        return dec.sharded_ragged_decode_attention(
                            q, ks, vs, lens)
                else:
                    def call(ks=ks, vs=vs):
                        return dec.sharded_paged_ragged_decode_attention(
                            q, ks, vs, tables, lens)
                counter.reset()
                got = call()
                torch.cuda.synchronize()
                check(counter.count == tp, f"4n {name} tp {tp}: "
                      f"{counter.count} launches for one sharded call")
                check(torch.equal(got, whole[name]),
                      f"4n {name} tp {tp} {tname}: the ranks' outputs "
                      f"joined != the unsharded launch")
                for r in range(tp):
                    qr = q[:, r * h:(r + 1) * h].contiguous()
                    if name == "K1":
                        bk, ns = dec.pick_decode_blocks(T, hd, dtype)
                        plain = dec.ragged_decode_split_plain(
                            qr, ks[r], vs[r], lens, ident, scale, bk, ns)
                    else:
                        bk, ns = dec.pick_paged_decode_blocks(T, PAGE, hd,
                                                              dtype)
                        plain = dec.paged_decode_split_plain(
                            qr, ks[r], vs[r], tables, lens, scale, bk, ns)
                    want = dec._merge_splits(*plain[:3], dtype).float()
                    part = got[:, r * h:(r + 1) * h].float()
                    torch.testing.assert_close(part, want, **PLAIN_TOL[tname])
                    worst[name] = max(worst[name],
                                      (part - want).abs().max().item())
                if dtype == torch.bfloat16:
                    if name == "K1":
                        def one(ks=ks, vs=vs):
                            return dec.ragged_decode_attention(
                                q[:, :h].contiguous(), ks[0], vs[0], lens)
                    else:
                        def one(ks=ks, vs=vs):
                            return dec.paged_ragged_decode_attention(
                                q[:, :h].contiguous(), ks[0], vs[0], tables,
                                lens)
                    nbytes = 2 * live * h * hd * 2 + 2 * S * h * hd * 2 \
                        + 4 * S
                    times[f"{name} {h} heads"] = {
                        "ms": time_ms(torch, one, flush),
                        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
                    times[f"{name} tp {tp} call"] = {
                        "ms": time_ms(torch, call, flush)}
        if dtype == torch.bfloat16:
            for name, fn in (
                    ("K1", lambda: dec.ragged_decode_attention(q, kc, vc,
                                                               lens)),
                    ("K4", lambda: dec.paged_ragged_decode_attention(
                        q, kp, vp, tables, lens))):
                nbytes = 2 * live * nh * hd * 2 + 2 * S * nh * hd * 2 + 4 * S
                times[f"{name} {nh} heads"] = {
                    "ms": time_ms(torch, fn, flush),
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    log(f"  K1 / K4 per shard (6 and 3 heads of 12, fp32 and bf16): tp "
        f"launches a call, every shard within 1e-5 / 2e-2 of its plain "
        f"version (worst {worst}), the shards joined == the 12-head "
        f"launch bitwise")
    for key, t in times.items():
        log(f"    {key} [card: {card}]: {t['ms']:.4f} ms"
            + (f" (byte bound {t['bound_ms']:.5f} ms)" if "bound_ms" in t
               else ""))
    return {"max_abs_err": worst, "times": times}


def tp_first_logits(torch, engines, prompts):
    """The first-token logits of `prompts` through the prefill of each
    engine of `engines` ({tp: engine}, idle), the prompt in slot 0."""
    out = {}
    for tp, eng in engines.items():
        rows = []
        for p in prompts:
            slot = eng.cache.allocate()
            rows.append(eng._prefill_tokens(slot, p))
            eng.cache.release(slot)
        out[tp] = torch.stack(rows).float()
    return out


def phase_tp(torch, np, dec, k7, engine_run, variants):
    """(4n) TP-sharded serving of phase 4's GPT-small bf16, every rank
    on this card: per-shard K1 / K4 (`tp_kernels`); phase 4's first 8
    requests (6 greedy, 2 sampled; their first 32 tokens) through K1,
    K4, K5 and K6 at tp 2 and 4 (and K1 at tp 1 for the timing): each
    engine's kernel launched tp x 12 x decode steps and no other, 26
    collectives a forward, the KV bytes per token tp=1's; first-token
    logits at tp 2 and 4 within 2 e of tp 1's (e: tp 1's bf16 error
    against fp32 logits of the same weights); greedy streams equal
    phase 4 / 4b's tp=1 streams, except after a step whose tp=1 top-2
    margin is below the tie bound 4 e; inside tp 2: graph == eager
    and a snapshot resumed (continuation bitwise, K1 = 2 x 12 x (decode
    + replay + discarded steps)); a two-group `EngineFleet(tp=2)` with
    the busiest group killed and revived (0 stranded, greedy streams
    those of one tp=2 engine); the front-door soak at `--tp 2`
    (slotted)."""
    from paddle_tpu_torch.serving import (EngineFleet, LLMEngine,
                                          SamplingParams)
    model = engine_run["model"]
    card = card_line()
    t0 = time.perf_counter()
    layers = model.cfg.num_layers
    res = {"kernels": tp_kernels(torch, np, dec, card)}
    prompts = engine_run["prompts"][:TP_LOAD]
    params = [dataclasses.replace(p, max_new_tokens=TP_NEW)
              for p in engine_run["params"][:TP_LOAD]]
    greedy = [i for i, p in enumerate(params) if p.temperature == 0]
    base = {name: [s[:TP_NEW] for s in run["streams"][:TP_LOAD]]
            for name, run in variants.items()}
    runs, k1 = {}, {}
    for name, knobs in DECODE_VARIANTS:
        for tp in ((1,) if name == "K1" else ()) + TP_DEGREES:
            LLMEngine(model, **SERVE_KW, **knobs, tp=tp).generate(
                prompts[:2], SamplingParams(max_new_tokens=4))   # warm-up
            torch.cuda.synchronize()
            eng, _, run = serve(torch, dec, model, prompts, params, name,
                                tp=tp, **knobs)
            runs[(name, tp)] = run
            if name == "K1":
                k1[tp] = eng
            want_bpt = variants[name]["kv_bytes_per_token"]
            check(run["kv_bytes_per_token"] == want_bpt,
                  f"4n {name} tp {tp}: kv_bytes_per_token "
                  f"{run['kv_bytes_per_token']} != tp 1's {want_bpt}")
    check(runs[("K1", 1)]["streams"] == base["K1"],
          "4n: K1 tp 1 on the first 8 requests != phase 4's streams")
    # first-token logits across degrees, against bf16's own error: the
    # fp32 logits of the same (bf16) weights give tp 1's error e; two
    # bf16 computations of one function, each about e from it, differ
    # by at most 2 e, and a greedy token can flip only where the tp=1
    # top-2 margin is below twice that
    lg = tp_first_logits(torch, k1, prompts)
    from paddle_tpu_torch.models import GPT
    m32 = GPT(model.cfg, device="cuda")
    m32.load_state_dict({k: v.float() for k, v in
                         model.state_dict().items()})
    lg32 = torch.stack([m32.logits(torch.from_numpy(p[None]).long().cuda())
                        [0, -1].float() for p in prompts])
    del m32
    e = float((lg[1] - lg32).abs().max())
    gate, tie = 2 * e, 4 * e
    logit_err = {tp: float((lg[tp] - lg[1]).abs().max())
                 for tp in TP_DEGREES}
    for tp, err in logit_err.items():
        check(err <= gate, f"4n: tp {tp}'s first-token logits {err:.4f} "
              f"from tp 1's, over twice tp 1's bf16 error {e:.4f}")
    # greedy streams against tp 1: equal, or first apart at a near-tie
    flips = []
    for (name, tp), run in sorted(runs.items()):
        if tp == 1:
            continue
        for i in greedy:
            got, want = run["streams"][i], base[name][i]
            if got == want:
                continue
            j = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            m = float(greedy_margins(torch, np, model, prompts, base[name],
                                     [i])[i][j])
            flips.append((name, tp, i, j, m))
            check(m < tie, f"4n {name} tp {tp} request {i}: stream apart "
                  f"from tp 1's at step {j}, where the tp=1 top-2 margin "
                  f"{m:.4f} is not below the tie bound {tie:.4f}")
    sampled = [run["streams"][i] == base[name][i]
               for (name, tp), run in runs.items() if tp > 1
               for i in range(TP_LOAD) if i not in greedy]
    log(f"  first-token logits (8 prompts): tp 1's bf16 error against "
        f"fp32 {e:.4f}; tp 2 / 4 from tp 1's {logit_err} (gate 2 e = "
        f"{gate:.4f}, |logit| <= {float(lg32.abs().max()):.3f}); tie "
        f"bound 4 e = {tie:.4f}; greedy streams equal tp 1's but {flips} "
        f"((variant, tp, request, step, tp=1 margin)); sampled streams "
        f"equal tp 1's: {sum(sampled)} of {len(sampled)}")
    res.update(logit_err=logit_err, bf16_err=e, tie_bound=tie, flips=flips)
    res["runs"] = {f"{name} tp {tp}": {k: v for k, v in run.items()
                                       if k != "streams"}
                   for (name, tp), run in runs.items()}
    for tp in (1,) + TP_DEGREES:
        run = runs[("K1", tp)]
        log(f"  K1 tp {tp} [card: {card}]: decode "
            f"{run['decode_ms_per_token']:.3f} ms per step, "
            f"{run['tokens_per_s']:.1f} tokens/s, decode graph capture "
            f"{run['graph_capture_s']:.3f} s, prefill graphs "
            f"{run['prefill_graph_captures']} in "
            f"{run['prefill_graph_capture_s']:.3f} s, pool "
            f"{run['prefill_graph_pool_bytes'] / 2**20:.1f} MiB")
    tp2 = runs[("K1", 2)]["streams"]
    # graph == eager at tp 2
    eager = LLMEngine(model, **SERVE_KW, tp=2)
    eager._use_graphs = False
    check([r.token_ids for r in eager.generate(prompts, params)] == tp2,
          "4n: tp 2 eager streams != tp 2 graph streams")
    del eager
    # a tp 2 snapshot resumed at tp 2
    counter = dec.LAUNCHES
    eng = LLMEngine(model, **SERVE_KW, tp=2)
    rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    eng.close()
    torch.cuda.synchronize()
    counter.reset()
    resumed = track_discards(LLMEngine.resume(model, snap))
    check(resumed.tp == 2, f"4n: resumed at tp {resumed.tp}")
    resumed.run_until_complete()
    torch.cuda.synchronize()
    tot = engine_totals([resumed], 2 * layers)
    check([resumed.result(r).token_ids for r in rids] == tp2,
          "4n: the tp 2 snapshot's continuation != the tp 2 streams")
    check(counter.count == tot["launches_want"],
          f"4n resume: K1 {counter.count} != {2 * layers} x "
          f"{steps_text(tot)}")
    log(f"  tp 2 snapshot after 3 steps resumed at tp 2: streams bitwise "
        f"(sampled included), K1 {counter.count} = {2 * layers} x "
        f"{steps_text(tot)}; graph == eager at tp 2 bitwise")
    del resumed, eng
    # two TP groups, the busiest killed
    Fleet = tracked_fleet(EngineFleet)
    fleet = Fleet(model, replicas=2, tp=2, snapshot_every=1,
                  quarantine_backoff_s=0.0, register_stats=False,
                  **SERVE_KW)
    check([r.engine.mesh.ranks for r in fleet._replicas] == [(0, 1), (2, 3)],
          "4n fleet: replicas are not the groups (0, 1), (2, 3)")
    counter.reset()
    rids = [fleet.submit(p, sp) for p, sp in zip(prompts, params)]
    for _ in range(2):
        fleet.step()
    victim = fleet.busiest()
    fleet.kill(victim)
    fleet.revive(victim)
    fleet.run_until_complete(max_steps=5000)
    torch.cuda.synchronize()
    got = [fleet.result(r) for r in rids]
    st = fleet.stats()
    check(all(g.finish_reason == "length" for g in got),
          f"4n fleet: stranded {[g.finish_reason for g in got]}")
    check([got[i].token_ids for i in greedy] == [tp2[i] for i in greedy],
          "4n fleet: greedy streams != one tp 2 engine's")
    check(st["kills"] == 1 and st["failovers"] == 1, f"4n fleet: {st}")
    tot = engine_totals(fleet.built, 2 * layers)
    check(counter.count == tot["launches_want"] and tot["unexpected"] == 0,
          f"4n fleet: K1 {counter.count} != {2 * layers} x "
          f"{steps_text(tot)}, {tot['unexpected']} unexpected captures")
    fleet.close()
    log(f"  EngineFleet(tp=2), 2 groups, r{victim} killed and revived: 0 "
        f"stranded, greedy streams = one tp 2 engine's, K1 "
        f"{counter.count} = {2 * layers} x {steps_text(tot)} over "
        f"{len(fleet.built)} engines")
    del fleet
    res["soak"] = front_door_soak(torch, dec, k7, model, card, "n",
                                  "slotted, --tp 2", ["--tp", "2"],
                                  ("K1",), False, tp=2, phase="4n")
    res["seconds"] = time.perf_counter() - t0
    log(f"  phase 4n: {res['seconds']:.1f} s")
    return res


def phase_paged_vs_slotted(torch, np, P):
    """(d) paged ≡ slotted greedy streams in fp32 (K4 against K1) and in
    int8 over fp32 weights (K6 against K5), token for token; the
    smallest top-2 margin of the fp32 model's logits along the streams
    is logged."""
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    model = P.models.gpt_small(seed=0, device="cuda", dtype="float32")
    prompts = make_prompts(np, 8, 16, 700, model.cfg.vocab_size, seed=2)
    sp = SamplingParams(max_new_tokens=32)
    streams = {name: [r.token_ids for r in LLMEngine(
        model, **SERVE_KW, **knobs).generate(prompts, sp)]
        for name, knobs in DECODE_VARIANTS}
    out = {}
    for paged, slotted in (("K4", "K1"), ("K6", "K5")):
        margin = float("inf")
        for p, toks in zip(prompts, streams[slotted]):
            seq = np.concatenate([p, np.asarray(toks[:-1], np.int32)])
            lg = model.logits(torch.from_numpy(seq[None]).long().cuda())[0]
            top2 = torch.topk(lg[len(p) - 1:].float(), 2, dim=-1).values
            margin = min(margin, (top2[:, 0] - top2[:, 1]).min().item())
        same = sum(a == b for a, b in zip(streams[paged], streams[slotted]))
        check(same == len(prompts), f"fp32 weights: {paged} != {slotted} "
                                    f"in {len(prompts) - same} streams")
        log(f"  fp32 weights, {paged} vs {slotted}: {same}/{len(prompts)} "
            f"greedy streams equal token for token; smallest top-2 margin "
            f"of the fp32 model along them {margin:.3e}")
        out[f"{paged}_vs_{slotted}_min_margin"] = margin
    del model
    torch.cuda.empty_cache()
    return out


def phase_ragged_vs_masked(torch, np, P):
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    model = P.models.gpt_small(seed=0, device="cuda", dtype="float32")
    prompts = make_prompts(np, 8, 16, 700, model.cfg.vocab_size, seed=2)
    sp = SamplingParams(max_new_tokens=32)
    kw = dict(max_slots=8, max_seq=1024, decode_block_size=8, seed=0,
              device="cuda")
    ragged = LLMEngine(model, attend_impl="ragged", **kw).generate(prompts,
                                                                  sp)
    masked = LLMEngine(model, attend_impl="masked", **kw).generate(prompts,
                                                                  sp)
    min_margin, diverged = float("inf"), 0
    for i, (p, r, m) in enumerate(zip(prompts, ragged, masked)):
        seq = np.concatenate([p, np.asarray(m.token_ids[:-1], np.int32)])
        lg = model.logits(torch.from_numpy(seq[None]).long().cuda())[0]
        top2 = torch.topk(lg[len(p) - 1:].float(), 2, dim=-1).values
        margins = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        min_margin = min(min_margin, float(margins.min()))
        k = next((j for j, (a, b) in enumerate(zip(r.token_ids, m.token_ids))
                  if a != b), None)
        if k is not None:
            diverged += 1
            check(margins[k] < 1e-3,
                  f"request {i}: ragged and masked diverge at step {k} with "
                  f"top-2 margin {margins[k]:.3e} >= 1e-3")
            log(f"  request {i}: diverges at step {k}, top-2 margin "
                f"{margins[k]:.3e} (< 1e-3: a near-tie)")
    log(f"  ragged vs masked fp32: {len(prompts) - diverged}/{len(prompts)}"
        f" greedy streams equal; min top-2 logit margin {min_margin:.3e}")
    return {"min_margin": min_margin, "diverged": diverged}


# --------------------------------------------------------------------------- #
# phases 6-7: training
# --------------------------------------------------------------------------- #

TRAIN_STEPS = 10


KERNEL_GROUPS = (("flash K2/K3", ("flash_fwd", "flash_bwd")),
                 ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")),
                 ("torch elementwise / reduction", ("at::native",)))


def profile_steps(torch, trainer, ids, steps: int = 3, top: int = 25,
                  batch=None, kernel_groups=KERNEL_GROUPS):
    """Device time by kernel over `steps` training steps on `batch`
    ((ids, ids) by default) (torch.profiler, CUDA activity), per step,
    grouped as `kernel_groups` (the first group whose keys a kernel's
    name holds); the device's busy share of the wall time (the union of
    the kernels' intervals). Diagnostics (`--profile`; phase 6g
    always)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batch = (ids, ids) if batch is None else batch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_steps(*batch, steps=steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("Command Buffer")]
    busy = busy_us(kernels) / 1e3 / steps
    if busy == 0:
        log("  profile: torch.profiler saw no device time")
        return None
    by_name, groups = {}, {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3 / steps
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + ms)
        g = next((g for g, keys in kernel_groups
                  if any(k in e.name for k in keys)), "other")
        groups[g] = groups.get(g, 0.0) + ms
    log(f"  profile of {steps} steps [{card_line()}]: wall {wall_ms:.2f} ms "
        f"per step, device busy {busy:.2f} ms per step (idle share "
        f"{1 - busy / wall_ms:.3f})")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g}: {ms:.2f} ms/step ({ms / busy:.1%} of busy)")
    rows = sorted(((t, n // steps, k) for k, (n, t) in by_name.items()),
                  reverse=True)
    for ms, n, key in rows[:top]:
        log(f"    {ms:8.3f} ms/step {n:5d} calls  {key[:100]}")
    return {"wall_ms_per_step": wall_ms, "busy_ms_per_step": busy,
            "groups_ms_per_step": groups,
            "kernels": [{"ms_per_step": ms, "calls_per_step": n, "name": k}
                        for ms, n, k in rows[:top]]}


def phase_train(torch, np, P, profile: bool = False):
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    model = P.models.gpt_small(seed=0, device="cuda")
    cfg = model.cfg
    check((cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.vocab_size)
          == (768, 12, 12, 50304), f"not GPT-small: {cfg}")
    bs, seq = FLASH_SHAPE["b"], FLASH_SHAPE["s"]
    trainer = Trainer(model, AdamW(learning_rate=1e-4),
                      lambda logits, y: model.loss(logits, y),
                      amp_level="O2", amp_dtype="bfloat16")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (bs, seq))).cuda()
    t0 = time.perf_counter()
    warm, _ = trainer.train_step(ids, ids)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counters(fa)
    t0 = time.perf_counter()
    _, losses = trainer.train_steps(ids, ids, steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = fa.FWD_LAUNCHES.count, fa.BWD_LAUNCHES.count
    check((fa.WGMMA_FWD_LAUNCHES.count, fa.WGMMA_BWD_LAUNCHES.count)
          == (fwd, bwd), "bf16 training left the wgmma route")
    peak = torch.cuda.max_memory_allocated()
    losses = [float(warm)] + losses.cpu().tolist()
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: "
                                                 f"{losses}")
    check(losses[-1] < losses[1], f"loss did not fall over the "
                                  f"{TRAIN_STEPS} steps: {losses}")
    want = cfg.num_layers * TRAIN_STEPS
    check(fwd == want and bwd == want,
          f"K2/K3 launches {fwd}/{bwd} != {cfg.num_layers} layers x "
          f"{TRAIN_STEPS} steps")
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = bs * seq * TRAIN_STEPS / wall
    log(f"  GPT-small O2 bf16, bs {bs} x seq {seq}, AdamW(1e-4): warm-up "
        f"step {warm_s:.2f} s, then {TRAIN_STEPS} steps in {wall:.3f} s; "
        f"losses {[round(x, 4) for x in losses]}")
    log(f"  K2 launches {fwd}, K3 launches {bwd} = {cfg.num_layers} layers "
        f"x {TRAIN_STEPS} steps")
    prof = profile_steps(torch, trainer, ids) if profile else None
    del trainer, model
    torch.cuda.empty_cache()
    return {"fwd_launches": fwd, "bwd_launches": bwd, "losses": losses,
            "step_ms": step_ms, "tokens_per_s": tok_s,
            "peak_bytes": peak, "wall_s": wall, "warmup_s": warm_s,
            "profile": prof}


TINY_STEPS = 3
FP32_SMALL_STEPS = 3


def route_counts(counters):
    return {r: (f.count, b.count) for r, (f, b) in counters.items()}


def phase_train_fp32(torch, np, P):
    """(6b) fp32 models at `Trainer`'s default amp_level=None, which the
    tf32x3 route carries: gpt_tiny (head dim 32) takes 3 AdamW steps on
    the card and the same 3 steps on the CPU (plain attention), losses
    within 1e-4 relative (fp32 both sides, TF32 off; the sums run in
    other orders); gpt_tiny under O2 takes 3 steps through the wgmma
    route (bf16 at head dim 32), losses finite and falling; then
    GPT-small in fp32 takes 1 warm-up and 3 timed steps at bs 18 x
    1024. Every flash launch of a run on its route (layers x steps each
    way), none on the other."""
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = fa.ROUTE_COUNTERS
    ids = np.random.RandomState(2).randint(0, 1024, (8, 256))
    none = no_launches(fa)
    losses, counts = {}, {}
    for run, dev, amp in (("cpu", "cpu", None), ("cuda", "cuda", None),
                          ("O2", "cuda", "O2")):
        model = P.models.gpt_tiny(seed=0, device=dev)
        kw = dict(amp_level="O2", amp_dtype="bfloat16") if amp else {}
        tr = Trainer(model, AdamW(learning_rate=1e-3),
                     lambda logits, y, m=model: m.loss(logits, y), **kw)
        t = torch.from_numpy(ids).to(dev)
        reset_flash_counters(fa)
        _, ls = tr.train_steps(t, t, steps=TINY_STEPS)
        losses[run] = ls.cpu().tolist()
        counts[run] = route_counts(counters)
    n = 4 * TINY_STEPS                      # gpt_tiny: 4 layers
    check(counts["cuda"] == {**none, fa.TF32X3: (n, n)},
          f"gpt_tiny fp32 launches by route {counts['cuda']}, want tf32x3 "
          f"{n} = 4 layers x {TINY_STEPS} steps")
    check(counts["O2"] == {**none, fa.WGMMA: (n, n)},
          f"gpt_tiny O2 launches by route {counts['O2']}, want wgmma {n}")
    check(counts["cpu"] == none, "the CPU run launched a kernel")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                 losses["cpu"]))
    check(all(math.isfinite(x) for x in losses["cuda"]) and rel <= 1e-4,
          f"gpt_tiny fp32: card losses {losses['cuda']} vs CPU "
          f"{losses['cpu']}: max relative difference {rel:.3e} > 1e-4")
    check(all(math.isfinite(x) for x in losses["O2"])
          and losses["O2"][-1] < losses["O2"][0],
          f"gpt_tiny O2 losses {losses['O2']}")
    log(f"  gpt_tiny fp32, amp_level=None, AdamW(1e-3), bs 8 x 256: card "
        f"losses {[round(x, 6) for x in losses['cuda']]}, CPU "
        f"{[round(x, 6) for x in losses['cpu']]}, max relative difference "
        f"{rel:.2e} (limit 1e-4); tf32x3 launches {n}/{n}, wgmma 0")
    log(f"  gpt_tiny O2 (bf16, head dim 32): losses "
        f"{[round(x, 4) for x in losses['O2']]}; wgmma launches {n}/{n}, "
        f"tf32x3 0")

    model = P.models.gpt_small(seed=0, device="cuda")
    cfg = model.cfg
    check(cfg.num_heads == 12 and cfg.hidden_size == 768,
          f"not GPT-small: {cfg}")
    bs, seq = FLASH_SHAPE["b"], FLASH_SHAPE["s"]
    tr = Trainer(model, AdamW(learning_rate=1e-4),
                 lambda logits, y: model.loss(logits, y))
    big = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (bs, seq))).cuda()
    warm, _ = tr.train_step(big, big)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counters(fa)
    t0 = time.perf_counter()
    _, ls = tr.train_steps(big, big, steps=FP32_SMALL_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    small_counts = route_counts(counters)
    n = cfg.num_layers * FP32_SMALL_STEPS
    check(small_counts == {**none, fa.TF32X3: (n, n)},
          f"GPT-small fp32 launches by route {small_counts}, want tf32x3 "
          f"{n}")
    small_losses = [float(warm)] + ls.cpu().tolist()
    check(all(math.isfinite(x) for x in small_losses),
          f"GPT-small fp32 losses {small_losses}")
    peak = torch.cuda.max_memory_allocated()
    step_ms = wall / FP32_SMALL_STEPS * 1e3
    tok_s = bs * seq * FP32_SMALL_STEPS / wall
    log(f"  GPT-small fp32, amp_level=None, bs {bs} x {seq}: 1 warm-up, "
        f"then {FP32_SMALL_STEPS} steps at {step_ms:.2f} ms per step, "
        f"{tok_s:.1f} tokens/s, losses "
        f"{[round(x, 4) for x in small_losses]}, peak "
        f"{peak / 2**30:.2f} GiB; tf32x3 launches {n}/{n} = "
        f"{cfg.num_layers} layers x {FP32_SMALL_STEPS} steps, wgmma 0 "
        f"[card: {card_line()}]")
    del tr, model, big
    torch.cuda.empty_cache()
    return {"tiny_losses": losses, "tiny_rel": rel,
            "small_losses": small_losses, "small_step_ms": step_ms,
            "small_tokens_per_s": tok_s, "small_peak_bytes": peak,
            "fwd_launches": n, "bwd_launches": n}


def timed_steps(torch, trainer, ids, steps: int):
    """One warm-up step, then `steps` timed steps with the peak memory
    reset between: (warm-up loss, losses, wall s, peak bytes)."""
    warm, _ = trainer.train_step(ids, ids)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, losses = trainer.train_steps(ids, ids, steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return float(warm), losses.cpu().tolist(), wall, \
        torch.cuda.max_memory_allocated()


def gpt_small_ids(torch, np, cfg, bs: int, seq: int, seed: int = 0):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (bs, seq))).cuda()


def phase_train_fp16(torch, np, P, bf16_run):
    """(6c) GPT-small at full width from seed 0, bs 18 x 1024, under
    O2 fp16 with a GradScaler, AdamW on LinearWarmup(CosineAnnealingDecay)
    with ClipGradByGlobalNorm(1.0): 1 warm-up and 10 timed steps; losses
    finite and falling, K2/K3 launched 12 x steps on the wgmma_f16 route
    only; the scale and the rejected steps logged; step ms, tokens/s and
    peak memory beside phase 6's bf16 run. First, `amp.nonfinite` (the
    scaler's found_inf) on the card: a NaN and an inf in fp32, bf16 and
    fp16 tensors are found, finite tensors are not."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW, lr
    ts = [torch.ones(1000, device="cuda", dtype=dt)
          for _ in range(2)
          for dt in (torch.float32, torch.bfloat16, torch.float16)]
    ts[1][17] = float("nan")
    ts[3][999] = float("inf")
    ts[5][0] = float("-inf")
    found = amp.nonfinite(ts).tolist()
    check(found == [False, True, False, True, False, True],
          f"amp.nonfinite on the card: {found}")
    model = P.models.gpt_small(seed=0, device="cuda")
    cfg = model.cfg
    bs, seq = FLASH_SHAPE["b"], FLASH_SHAPE["s"]
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, T_max=10),
                            warmup_steps=2, start_lr=0.0, end_lr=1e-4)
    trainer = Trainer(model, AdamW(learning_rate=sched,
                                   grad_clip=ClipGradByGlobalNorm(1.0)),
                      lambda logits, y: model.loss(logits, y),
                      amp_level="O2", amp_dtype="float16",
                      scaler=amp.GradScaler())
    ids = gpt_small_ids(torch, np, cfg, bs, seq)
    reset_flash_counters(fa)
    warm, losses, wall, peak = timed_steps(torch, trainer, ids, TRAIN_STEPS)
    counts = route_counts(fa.ROUTE_COUNTERS)
    n = cfg.num_layers * (TRAIN_STEPS + 1)
    check(counts == {**no_launches(fa), fa.WGMMA_F16: (n, n)},
          f"fp16 launches by route {counts}, want wgmma_f16 {n} = "
          f"{cfg.num_layers} layers x {TRAIN_STEPS + 1} steps")
    losses = [warm] + losses
    check(all(math.isfinite(x) for x in losses), f"fp16 losses {losses}")
    check(losses[-1] < losses[1], f"fp16 loss did not fall: {losses}")
    st = trainer.state
    rejected = st.step - st.opt_state["step"]
    scale = st.scaler_state["scale"].item()
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = bs * seq * TRAIN_STEPS / wall
    log(f"  amp.nonfinite on the card: NaN and inf found in fp32, bf16 and "
        f"fp16 tensors")
    log(f"  GPT-small O2 fp16 + GradScaler, AdamW(LinearWarmup(Cosine"
        f"AnnealingDecay(1e-4, T_max=10), 2 steps from 0)), "
        f"ClipGradByGlobalNorm(1.0), bs {bs} x {seq}: 1 warm-up, then "
        f"{TRAIN_STEPS} steps at {step_ms:.2f} ms per step, {tok_s:.1f} "
        f"tokens/s, peak {peak / 2**30:.2f} GiB (phase 6, bf16 AdamW(1e-4): "
        f"{bf16_run['step_ms']:.2f} ms, {bf16_run['tokens_per_s']:.1f} "
        f"tokens/s, {bf16_run['peak_bytes'] / 2**30:.2f} GiB) "
        f"[card: {card_line()}]")
    log(f"  losses {[round(x, 4) for x in losses]}; loss scale {scale:g}, "
        f"{rejected} of {st.step} steps rejected (found_inf); wgmma_f16 "
        f"launches {n}/{n}, other routes 0")
    del trainer, model, ids
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms, "tokens_per_s": tok_s,
            "peak_bytes": peak, "scale": scale, "rejected": rejected,
            "fwd_launches": n, "bwd_launches": n}


O1_STEPS = 3
O1_SHAPE = (8, 1024)


def phase_train_o1(torch, np, P):
    """(6d) O1 on GPT-small: fp32 parameters, the forward under
    `amp.auto_cast` (linear casts to the compute dtype), 3 steps at
    bs 8 x 1024 in bf16 and in fp16 with a GradScaler; K2/K3 on the
    matching route only, 12 x 3 launches each way; losses finite, the
    parameters still fp32."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    out = {}
    for tname, route in (("bfloat16", fa.WGMMA), ("float16", fa.WGMMA_F16)):
        model = P.models.gpt_small(seed=0, device="cuda")
        cfg = model.cfg
        kw = dict(scaler=amp.GradScaler()) if tname == "float16" else {}
        tr = Trainer(model, AdamW(learning_rate=1e-4),
                     lambda logits, y, m=model: m.loss(logits, y),
                     amp_level="O1", amp_dtype=tname, **kw)
        ids = gpt_small_ids(torch, np, cfg, *O1_SHAPE, seed=1)
        reset_flash_counters(fa)
        _, losses = tr.train_steps(ids, ids, steps=O1_STEPS)
        losses = losses.cpu().tolist()
        n = cfg.num_layers * O1_STEPS
        counts = route_counts(fa.ROUTE_COUNTERS)
        check(counts == {**no_launches(fa), route: (n, n)},
              f"O1 {tname}: launches by route {counts}, want {route} {n}")
        check(all(math.isfinite(x) for x in losses),
              f"O1 {tname} losses {losses}")
        check(all(v.dtype == torch.float32 for v in tr.state.params.values()),
              f"O1 {tname}: a parameter left fp32")
        rejected = tr.state.step - tr.state.opt_state["step"]
        log(f"  GPT-small O1 {tname}{' + GradScaler' if kw else ''}, fp32 "
            f"parameters, bs {O1_SHAPE[0]} x {O1_SHAPE[1]}: losses "
            f"{[round(x, 4) for x in losses]}, {rejected} rejected; "
            f"{route} launches {n}/{n}, other routes 0")
        out[tname] = {"losses": losses, "route": route, "launches": n,
                      "rejected": rejected}
        del tr, model, ids
        torch.cuda.empty_cache()
    return out


DROPOUT_STEPS = 3
DROPOUT_SHAPE = (8, 1024)


def phase_dropout_remat(torch, np, P):
    """(6e) GPT-small at bs 8 x 1024, O2 bf16, AdamW(1e-4), 3 steps each
    in four runs: dropout 0.1 with remat off and on (attention through
    `attention_dense`: DENSE_ATTENTION_CALLS 12 per forward, one forward
    per step without remat and two with it; K2/K3 launched 0 times), and
    dropout 0 with remat on and off (K2 24 and K3 12 launches per step
    with remat, 12 and 12 without). Before that, one step's loss and
    every gradient with dropout 0.1, remat off against on, from the same
    state: bitwise equal (the recomputed forward draws the same masks).
    Peak memory of each run logged."""
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    def make(dropout, remat):
        model = P.models.gpt_small(seed=0, device="cuda", dropout=dropout)
        return Trainer(model, AdamW(learning_rate=1e-4),
                       lambda logits, y, m=model: m.loss(logits, y),
                       amp_level="O2", amp_dtype="bfloat16", remat=remat)

    cfg = P.models.GPTConfig()
    ids = gpt_small_ids(torch, np, cfg, *DROPOUT_SHAPE, seed=2)
    grads = {}
    for remat in (False, True):
        tr = make(0.1, remat)
        loss, _, _, g = tr._loss_and_grads(tr.init_state(), (ids, ids))
        grads[remat] = (loss, g)
        del tr
        torch.cuda.empty_cache()
    (l0, g0), (l1, g1) = grads[False], grads[True]
    same = torch.equal(l0, l1) and set(g0) == set(g1) and all(
        torch.equal(g0[k], g1[k]) for k in g0)
    check(same, "dropout 0.1: remat on and off differ after one step")
    n_grads = len(g0)
    del grads, g0, g1
    log(f"  dropout 0.1, one step from the same state: loss "
        f"{l0.item():.6f} and all {n_grads} gradients bitwise equal, "
        f"remat on vs off")
    runs = {}
    L = cfg.num_layers
    for dropout, remat, fwd_per_step, bwd_per_step, dense_per_step in (
            (0.1, False, 0, 0, L), (0.1, True, 0, 0, 2 * L),
            (0.0, True, 2 * L, L, 0), (0.0, False, L, L, 0)):
        tr = make(dropout, remat)
        reset_flash_counters(fa)
        fa.DENSE_ATTENTION_CALLS.reset()
        torch.cuda.reset_peak_memory_stats()
        _, losses = tr.train_steps(ids, ids, steps=DROPOUT_STEPS)
        peak = torch.cuda.max_memory_allocated()
        losses = losses.cpu().tolist()
        got = (fa.FWD_LAUNCHES.count, fa.BWD_LAUNCHES.count,
               fa.DENSE_ATTENTION_CALLS.count)
        want = (fwd_per_step * DROPOUT_STEPS, bwd_per_step * DROPOUT_STEPS,
                dense_per_step * DROPOUT_STEPS)
        name = f"dropout {dropout}, remat {'on' if remat else 'off'}"
        check(got == want, f"{name}: K2/K3/dense counts {got}, want {want}")
        check(all(math.isfinite(x) for x in losses), f"{name}: {losses}")
        log(f"  {name}, bs {DROPOUT_SHAPE[0]} x {DROPOUT_SHAPE[1]}: losses "
            f"{[round(x, 4) for x in losses]}; K2 {got[0]}, K3 {got[1]}, "
            f"dense attention {got[2]} calls; peak {peak / 2**30:.2f} GiB "
            f"[card: {card_line()}]")
        runs[name] = {"losses": losses, "k2": got[0], "k3": got[1],
                      "dense": got[2], "peak_bytes": peak}
        del tr
        torch.cuda.empty_cache()
    return {"bitwise_one_step": same, "runs": runs}


RULE_STEPS = 2
# each rule with its decay where it has one (L2, decoupled, Lamb's and
# LARS's); the learning rates make each rule move gpt_tiny visibly
RULE_KW = {
    "SGD": dict(learning_rate=0.1, weight_decay=0.01),
    "Momentum": dict(learning_rate=0.1, use_nesterov=True,
                     weight_decay=0.01),
    "Adam": dict(learning_rate=1e-3, weight_decay=0.01),
    "AdamW": dict(learning_rate=1e-3, weight_decay=0.1),
    "Adamax": dict(learning_rate=1e-3, weight_decay=0.01),
    "Adagrad": dict(learning_rate=1e-2, weight_decay=0.01),
    "Adadelta": dict(learning_rate=1.0, weight_decay=0.01),
    "RMSProp": dict(learning_rate=1e-3, momentum=0.5, centered=True,
                    weight_decay=0.01),
    "Lamb": dict(learning_rate=1e-3, lamb_weight_decay=0.01),
    "LarsMomentum": dict(learning_rate=0.5, lars_weight_decay=0.001),
}
RULE_TOL = 2e-2


def phase_rules(torch, np, P):
    """(6f) each of the 10 optimizer rules: 2 steps of gpt_tiny (fp32,
    bs 4 x 64, the tf32x3 route with TF32 off) on the card and the same
    2 steps on the CPU (plain attention). The parameters' move agrees:
    ||move_card - move_cpu|| / ||move_cpu|| <= 2e-2 over all parameters
    (the two sum in other orders; where a gradient entry is near 0, the
    Adam-type rules' step is about lr either way, so the limit is on the
    whole move, not per entry); losses within 1e-4 relative."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    ids = np.random.RandomState(3).randint(0, 1024, (4, 64))
    out = {}
    for rule, kw in RULE_KW.items():
        moves, losses = {}, {}
        for dev in ("cpu", "cuda"):
            model = P.models.gpt_tiny(seed=0, device=dev)
            p0 = {k: v.detach().float().cpu().clone()
                  for k, v in model.named_parameters()}
            tr = Trainer(model, getattr(popt, rule)(**kw),
                         lambda logits, y, m=model: m.loss(logits, y))
            t = torch.from_numpy(ids).to(dev)
            reset_flash_counters(fa)
            _, ls = tr.train_steps(t, t, steps=RULE_STEPS)
            losses[dev] = ls.cpu().tolist()
            moves[dev] = torch.cat([(tr.state.params[k].detach().float()
                                     .cpu() - p0[k]).flatten() for k in p0])
            if dev == "cuda":
                n = 4 * RULE_STEPS
                counts = route_counts(fa.ROUTE_COUNTERS)
                check(counts == {**no_launches(fa), fa.TF32X3: (n, n)},
                      f"{rule}: launches {counts}")
        rel = ((moves["cuda"] - moves["cpu"]).norm()
               / moves["cpu"].norm()).item()
        lrel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                       losses["cpu"]))
        check(math.isfinite(rel) and rel <= RULE_TOL and lrel <= 1e-4,
              f"{rule}: card vs CPU move {rel:.3e} (limit {RULE_TOL:g}), "
              f"losses {lrel:.3e}")
        out[rule] = {"move_rel": rel, "loss_rel": lrel,
                     "move_norm": moves["cpu"].norm().item()}
    log("  gpt_tiny fp32, 2 steps, card vs CPU, ||move diff|| / ||move|| "
        f"(limit {RULE_TOL:g}): " + ", ".join(
            f"{r} {v['move_rel']:.1e}" for r, v in out.items()))
    return out


class _PlainFlash:
    """Swaps the plain K2/K3 functions in for the kernels on CUDA
    tensors, for the gradient check only (restored on exit): the
    `paddle_tpu_torch::flash_attention_*` operators call
    `flash_forward` / `flash_backward` by their module names."""

    def __init__(self, torch, fa):
        self.fa = fa

    def __enter__(self):
        self.saved = (self.fa.flash_forward, self.fa.flash_backward)
        self.fa.flash_forward = self.fa.flash_forward_plain
        self.fa.flash_backward = self.fa.flash_backward_plain

    def __exit__(self, *exc):
        self.fa.flash_forward, self.fa.flash_backward = self.saved


def phase_grad_check(torch, np, P, tname: str = "bfloat16"):
    """One step's gradients of a 2-layer full-width GPT-small (bs 8 x
    1024, O2-style `tname` parameters, norms fp32) through the kernels of
    `tname`'s route against the same step with the plain versions
    swapped in on the same CUDA tensors. fp16 scales the loss by 2^15,
    GradScaler's default, as fp16 training does: unscaled, most of its
    gradients lie below fp16's normal range (6.1e-5) and round to a
    few bits on both sides."""
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    model = P.models.GPT(P.models.GPTConfig(hidden_size=768, num_layers=2,
                                            num_heads=12),
                         seed=0, device="cuda")
    norm = {k for k in dict(model.named_parameters())
            if ".ln" in k or k.startswith("ln_")}
    dtype = getattr(torch, tname)
    params = {k: (p.detach() if k in norm else p.detach().to(dtype))
              .requires_grad_() for k, p in model.named_parameters()}
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, model.cfg.vocab_size, (8, 1024))).cuda()

    loss_scale = 2.0 ** 15 if tname == "float16" else 1.0

    def grads():
        logits = torch.func.functional_call(model, params, (ids,))
        loss = model.loss(logits, ids) * loss_scale
        return dict(zip(params, torch.autograd.grad(loss,
                                                    list(params.values()))))

    reset_flash_counters(fa)
    g_kernel = grads()
    route = fa._ROUTE_OF_DTYPE[dtype]
    check(fa.BWD_LAUNCHES.count == 2
          and fa.ROUTE_COUNTERS[route][1].count == 2,
          f"kernel path did not launch K3 on the {route} route")
    with _PlainFlash(torch, fa):
        g_plain = grads()
    check(fa.BWD_LAUNCHES.count == 2, "plain path launched K3")
    worst, worst_name = 0.0, ""
    for k in params:
        a, b = g_kernel[k].float(), g_plain[k].float()
        rel = ((a - b).norm() / b.norm().clamp(min=1e-30)).item()
        check(rel <= 3e-2, f"{k}: ||g_kernel - g_plain|| / ||g_plain|| = "
                           f"{rel:.3e} > 3e-2")
        if rel > worst:
            worst, worst_name = rel, k
    log(f"  2-layer full-width GPT-small, bs 8 x 1024, {tname} ({route}"
        f"{', loss x 2^15' if loss_scale != 1 else ''}): "
        f"{len(params)} parameter gradients, kernel vs plain attention; "
        f"worst relative error {worst:.3e} ({worst_name}), limit 3e-2")
    del model, params, g_kernel, g_plain
    torch.cuda.empty_cache()
    return {"worst_rel": worst, "worst_param": worst_name}


# --------------------------------------------------------------------------- #
# phases 6g-6i: ResNet training
# --------------------------------------------------------------------------- #

RESNET_BATCH, RESNET_SIZE = 128, 224     # bench.py's resnet50 shape
RESNET_WARM, RESNET_STEPS = 3, 10
RESNET_GROUPS = (
    ("max / avg pooling", ("pool",)),
    ("optimizer (_foreach)", ("multi_tensor_apply",)),
    ("copies / casts / layout", ("copy", "Memcpy", "Memset", "nchwToNhwc",
                                 "nhwcToNchw", "CatArray")),
    ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "xmma",
                             "cudnn", "implicit")),
    ("GEMM (fc)", ("gemm", "nvjet", "cutlass")),
    ("batch norm, ReLU, adds, loss (elementwise / reductions)",
     ("at::native",)),
)


def _resnet_state_checks(torch, model, st, buf0, norm_names):
    """O2's layout: parameters bf16 but BatchNorm's fp32, an fp32 master
    for exactly the bf16 ones; every BatchNorm buffer fp32 and moved
    from its initial value."""
    for k, v in st.params.items():
        want = torch.float32 if k in norm_names else torch.bfloat16
        check(v.dtype == want, f"{k}: {v.dtype}, want {want}")
        sl = st.opt_state["slots"][k]
        check(("master_weight" in sl) == (k not in norm_names),
              f"{k}: master_weight present {'master_weight' in sl}, "
              f"BatchNorm {k in norm_names}")
        check(all(t.dtype == torch.float32 for t in sl.values()),
              f"{k}: slots not fp32")
    check(set(st.buffers) == set(buf0) and len(buf0) == 106,
          f"{len(st.buffers)} buffers, want ResNet-50's 106")
    for k, v in st.buffers.items():
        check(v.dtype == torch.float32, f"buffer {k}: {v.dtype}")
        check(not torch.equal(v, buf0[k]), f"buffer {k} never moved")


def resnet_step_flops(torch, model, batch: int, size: int) -> float:
    """FLOPs of one training step's convolutions and fc (forward,
    weight gradients and input gradients, the stem's input gradient
    excepted: the image needs none), from the shapes the port runs
    (the space-to-depth stem as its 4 x 4 x 12 convolution), counted by
    `torch.utils.flop_counter` on one image's forward and backward and
    scaled by the batch (every count is linear in it)."""
    from torch.utils.flop_counter import FlopCounterMode
    was = model.training
    model.eval()                   # the same shapes; the buffers stay
    x = torch.zeros(1, size, size, 3, device="cuda")
    with FlopCounterMode(display=False) as fc:
        model(x).float().sum().backward()
    model.zero_grad(set_to_none=True)
    model.train(was)
    return float(fc.get_total_flops()) * batch


def phase_resnet50(torch, np, P, card: str):
    """(6g) ResNet-50 at bench.py's configuration through
    `Trainer.train_steps`; cudnn.benchmark off for the phase, then
    restored (on, it bought nothing measurable: 123.42 against 123.64
    ms a step on one H100 at 700 W, `scripts/resnet_probe.py`)."""
    benchmark = False
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = benchmark
    try:
        model = P.models.resnet50(num_classes=1000, data_format="NHWC",
                                  stem_s2d=True, seed=0, device="cuda")
        trainer = Trainer(model, Momentum(learning_rate=0.1, momentum=0.9),
                          lambda out, y: F.cross_entropy(out, y),
                          amp_level="O2", amp_dtype="bfloat16",
                          loop_unroll=2)
        rs = np.random.RandomState(0)
        # a device-resident batch, as bench.py's
        x = torch.from_numpy(rs.randn(RESNET_BATCH, RESNET_SIZE,
                                      RESNET_SIZE, 3).astype(np.float32)
                             ).to("cuda", torch.bfloat16)
        y = torch.from_numpy(rs.randint(0, 1000, (RESNET_BATCH,))).cuda()
        buf0 = {k: b.detach().clone() for k, b in model.named_buffers()}
        norm_names = trainer._norm_param_names()
        t0 = time.perf_counter()
        _, warm = trainer.train_steps(x, y, steps=RESNET_WARM)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, timed = trainer.train_steps(x, y, steps=RESNET_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = warm.float().cpu().tolist() + timed.float().cpu().tolist()
        check(all(math.isfinite(v) for v in losses),
              f"ResNet-50 non-finite loss: {losses}")
        # at bench's lr 0.1 (no warm-up) the loss on the repeated random
        # batch falls for a few steps, then oscillates above its low:
        # the check is that it falls below its start within the run
        check(min(losses[1:]) < losses[0], f"ResNet-50 loss never fell "
                                           f"below its first value over "
                                           f"{len(losses)} steps: {losses}")
        _resnet_state_checks(torch, model, trainer.state, buf0, norm_names)
        step_ms = wall / RESNET_STEPS * 1e3
        ips = RESNET_BATCH * RESNET_STEPS / wall
        flops = resnet_step_flops(torch, model, RESNET_BATCH, RESNET_SIZE)
        bound_ms = flops / BF16_FLOPS * 1e3
        log(f"  ResNet-50 O2 bf16, NHWC, stem_s2d, bs {RESNET_BATCH} x "
            f"{RESNET_SIZE}^2, Momentum(0.1, 0.9), cudnn.benchmark "
            f"{benchmark}: "
            f"{RESNET_WARM} warm-up steps in {warm_s:.2f} s; losses "
            f"{[round(v, 4) for v in losses]}")
        log(f"  ResNet-50 [{card}]: {step_ms:.2f} ms per step, {ips:.1f} "
            f"images/s, peak memory {peak / 2**30:.2f} GiB "
            f"(torch.cuda.max_memory_allocated), cudnn.benchmark "
            f"{benchmark}")
        log(f"  ResNet-50 step compute bound: {flops / 1e12:.3f} TFLOP "
            f"(convolutions + fc, forward + both gradients, "
            f"torch.utils.flop_counter) / {BF16_FLOPS / 1e12:.0f} TFLOP/s "
            f"bf16 = {bound_ms:.3f} ms ({bound_ms / step_ms:.1%} of the "
            f"step)")
        prof = profile_steps(torch, trainer, None, steps=1, top=15,
                             batch=(x, y), kernel_groups=RESNET_GROUPS)
        del trainer, model, x
        torch.cuda.empty_cache()
        return {"losses": losses, "step_ms": step_ms,
                "images_per_s": ips, "peak_bytes": peak,
                "warmup_s": warm_s, "wall_s": wall, "step_flops": flops,
                "bound_ms": bound_ms, "cudnn_benchmark": benchmark,
                "profile": prof}
    finally:
        torch.backends.cudnn.benchmark = prev


CIFAR_MEAN, CIFAR_STD = [125.3, 123.0, 113.9], [63.0, 62.1, 66.7]


def phase_resnet_fit(torch, np, P, card: str):
    """(6h) config 1 through its own entry point: `hapi.Model.fit` of a
    ResNet-50 (10 classes) over the DataLoader of synthetic CIFAR-10,
    one epoch, then `evaluate` on the test split."""
    from paddle_tpu_torch import hapi, metric, nn, optimizer
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision import datasets, transforms as T
    datasets.set_synthetic_fallback(True)
    tf = T.Compose([T.RandomHorizontalFlip(seed=0),
                    T.Normalize(mean=CIFAR_MEAN, std=CIFAR_STD,
                                data_format="HWC"),
                    T.Transpose()])
    train = datasets.Cifar10(mode="train", transform=tf)
    test = datasets.Cifar10(mode="test", transform=tf)
    model = hapi.Model(P.models.resnet50(num_classes=10, seed=0,
                                         device="cuda"))
    model.prepare(optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                     weight_decay=5e-4),
                  nn.CrossEntropyLoss(), metric.Accuracy())
    loader = DataLoader(train, batch_size=64, shuffle=True)
    t0 = time.perf_counter()
    hist = model.fit(loader, epochs=1, verbose=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev = model.evaluate(DataLoader(test, batch_size=64), verbose=0)
    check(set(hist) == {"loss", "acc", "ips"}, f"fit logs {sorted(hist)}")
    check(math.isfinite(hist["loss"][0]) and 0 <= hist["acc"][0] <= 1,
          f"fit history {hist}")
    check(set(ev) == {"loss", "acc"} and math.isfinite(ev["loss"]),
          f"evaluate {ev}")
    check(model._trainer.state.step == len(loader) == 16,
          f"{model._trainer.state.step} steps, want 16")
    ips = len(train) / wall
    log(f"  hapi.Model(resnet50(num_classes=10)).fit, 1 epoch of synthetic "
        f"CIFAR-10 (1024 images, bs 64, flip + normalize + transpose on "
        f"the host, fp32): {wall:.2f} s, {ips:.1f} images/s including the "
        f"loader and the first steps; fit's own ips (after 2 steps) "
        f"{hist['ips'][0]:.1f}; epoch loss {hist['loss'][0]:.4f}, acc "
        f"{hist['acc'][0]:.4f}; evaluate on the 256 test images: loss "
        f"{ev['loss']:.4f}, acc {ev['acc']:.4f} [{card}]")
    del model
    torch.cuda.empty_cache()
    return {"wall_s": wall, "images_per_s": ips,
            "fit_ips": hist["ips"][0], "history": hist, "evaluate": ev}


def phase_resnet_card_vs_cpu(torch, np, P):
    """(6i) in fp32 with TF32 off: 3 Trainer steps of ResNet-18 at 8 x
    32 x 32 on the card and on the CPU from the same weights, each step
    of the card's started from the CPU's state (`load_state`), within
    the CPU tests' tolerances; NHWC == NCHW and stem_s2d == conv1 on
    the card. Why each step restarts from the CPU's state: the
    free-running 3-step fp32 trajectory of this network is not
    comparable across devices. At the third step one ReLU input sits so
    near 0 that the card's fp32 forward flips its sign against fp64
    (the CPU's does not), which re-routes a gradient: the card's free
    run then leaves the fp64 one by 1e-3 (parameters) and 5.3e-3
    (velocity), a jump the CPU makes too from weights perturbed by
    3e-7 (`scripts/resnet_probe.py`). From the CPU's state one step
    agrees within ~2.7e-5."""
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rs = np.random.RandomState(0)
        x = rs.randn(8, 32, 32, 3).astype(np.float32)
        y = rs.randint(0, 10, (8,))
        kw = dict(num_classes=10, data_format="NHWC", stem_s2d=True, seed=0)
        trainers = {dev: Trainer(P.models.resnet18(device=dev, **kw),
                                 Momentum(1e-3, 0.9),
                                 lambda o, t: F.cross_entropy(o, t))
                    for dev in ("cpu", "cuda")}
        cpu, card = trainers["cpu"], trainers["cuda"]
        cpu.init_state()
        losses = {"cpu": [], "cuda": []}
        worst = {"params": (0.0, ""), "buffers": (0.0, ""),
                 "slots": (0.0, "")}
        for _ in range(3):
            card.load_state(cpu.state)               # copies to the card
            for dev, tr in trainers.items():
                loss, _ = tr.train_step(x, y)
                losses[dev].append(float(loss))
            for part, get in (
                    ("params", lambda s: s.params),
                    ("buffers", lambda s: s.buffers),
                    ("slots", lambda s: {k: v["velocity"] for k, v in
                                         s.opt_state["slots"].items()})):
                c, g = get(cpu.state), get(card.state)
                worst[part] = max([worst[part]] + [
                    (float((g[k].detach().cpu() - v.detach()).abs().max()
                           / v.detach().abs().max().clamp_min(1e-30)), k)
                    for k, v in c.items()])
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
        check(rel <= 1e-4, f"ResNet-18 losses card {losses['cuda']} vs CPU "
                           f"{losses['cpu']}: {rel:.2e} > 1e-4")
        for part, (err, name) in worst.items():
            check(err <= 1e-3, f"ResNet-18 {part} card vs CPU: {err:.2e} "
                               f"({name}) > 1e-3")
        log(f"  ResNet-18 fp32 (TF32 off), 3 steps Momentum(1e-3, 0.9) at "
            f"8 x 32^2, each from the CPU's state, card vs CPU: losses "
            f"{losses['cpu']} / {losses['cuda']}, max relative {rel:.2e} "
            f"(limit 1e-4); worst params {worst['params'][0]:.2e} "
            f"({worst['params'][1]}), buffers {worst['buffers'][0]:.2e}, "
            f"velocity {worst['slots'][0]:.2e} (limit 1e-3 of the largest "
            f"magnitude)")
        plain = P.models.resnet18(num_classes=10, seed=5, device="cuda")
        xn = torch.from_numpy(rs.randn(8, 3, 32, 32).astype(np.float32))
        yn = torch.from_numpy(rs.randint(0, 10, (8,))).cuda()
        outs, grads = [], []
        for fmt, s2d in (("NCHW", False), ("NHWC", False), ("NHWC", True)):
            m = P.models.resnet18(num_classes=10, seed=9, device="cuda",
                                  data_format=fmt, stem_s2d=s2d)
            m.load_state_dict(plain.state_dict())
            m.train()
            xi = xn if fmt == "NCHW" else xn.permute(0, 2, 3, 1).contiguous()
            out = m(xi.cuda())
            F.cross_entropy(out, yn).backward()
            outs.append(out.detach())
            grads.append({k: p.grad for k, p in m.named_parameters()})
        errs = []
        for o, gr in zip(outs[1:], grads[1:]):
            e_out = float((o - outs[0]).abs().max() / outs[0].abs().max())
            e_grad = max(float((gr[k] - v).abs().max()
                               / v.abs().max().clamp_min(1e-30))
                         for k, v in grads[0].items())
            check(e_out <= 2e-5 and e_grad <= 1e-4,
                  f"layout identity on the card: logits {e_out:.2e} "
                  f"(limit 2e-5), gradients {e_grad:.2e} (limit 1e-4)")
            errs.append((e_out, e_grad))
        log(f"  on the card, fp32: NHWC vs NCHW logits {errs[0][0]:.2e}, "
            f"gradients {errs[0][1]:.2e}; NHWC stem_s2d vs NCHW conv1 "
            f"logits {errs[1][0]:.2e}, gradients {errs[1][1]:.2e} "
            f"(limits 2e-5 / 1e-4 of the largest magnitude)")
        return {"loss_rel": rel,
                "worst": {k: v[0] for k, v in worst.items()},
                "layout": errs}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


# --------------------------------------------------------------------------- #
# phases 6j-6l: ERNIE-3.0-base fine-tuning
# --------------------------------------------------------------------------- #

ERNIE_WARM, ERNIE_STEPS = 3, 10
FINETUNE_BATCH, FINETUNE_STEPS = 16, 30      # examples/finetune_bert.py
IMDB_PAD, IMDB_BATCH = 64, 32
ERNIE_GROUPS = (
    ("flash K2/K3", ("flash_fwd", "flash_bwd")),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")),
    ("optimizer (_foreach)", ("multi_tensor_apply",)),
    ("copies / casts", ("copy", "Memcpy", "Memset", "CatArray")),
    ("softmax, dropout, LayerNorm, GELU, adds, loss (elementwise / "
     "reductions)", ("at::native",)),
)


def bert_step_flops(cfg, bs: int, seq: int) -> float:
    """FLOPs of one training step's matmuls: 6 x the encoder's matmul
    parameters (qkv, out, fc1, fc2 of every layer) x the tokens
    (forward and both gradients), plus attention's six products per
    layer and head (q.k and p.v forward; dp, dv, dq, dk backward) of 2
    s^2 d each. The pooler and the classifier see one token a sequence
    and are left out."""
    h, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    matmul_params = n * (h * 3 * h + h * h + 2 * h * f)
    attention = n * bs * 6 * 2 * seq * seq * h
    return 6.0 * matmul_params * bs * seq + attention


def ernie_trainer(P, cfg, lr=2e-5, weight_decay=None):
    """bench_ernie's model and trainer on the card: BertForSequence-
    Classification(cfg, 2) from seed 0, AdamW, cross-entropy, O2
    bf16."""
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW
    model = P.models.BertForSequenceClassification(cfg, 2, seed=0,
                                                   device="cuda")
    kw = {} if weight_decay is None else {"weight_decay": weight_decay}
    return model, Trainer(model, AdamW(learning_rate=lr, **kw),
                          lambda logits, y: F.cross_entropy(logits, y),
                          amp_level="O2", amp_dtype="bfloat16")


def ernie_batch(torch, np, cfg):
    """bench_ernie's resident batch: 64 x 128 ids, then 64 labels, from
    numpy seed 0."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (ERNIE_SHAPE["b"],
                                          ERNIE_SHAPE["s"]))
    y = rng.randint(0, 2, (ERNIE_SHAPE["b"],))
    return torch.from_numpy(ids).cuda(), torch.from_numpy(y).cuda()


def attention_counts(fa):
    """(K2 launches, K3 launches, wgmma K2, wgmma K3, dense calls)."""
    return (fa.FWD_LAUNCHES.count, fa.BWD_LAUNCHES.count,
            fa.WGMMA_FWD_LAUNCHES.count, fa.WGMMA_BWD_LAUNCHES.count,
            fa.DENSE_ATTENTION_CALLS.count)


def reset_attention_counts(fa):
    reset_flash_counters(fa)
    fa.DENSE_ATTENTION_CALLS.reset()


def timed_ernie(torch, trainer, ids, y, fa):
    """ERNIE_WARM warm-up steps, then ERNIE_STEPS timed ones with the
    attention counters and the peak memory reset between: (losses,
    wall s of the timed steps, peak bytes, counts, warm-up s, host ms:
    the time one more step takes to return, before the device has
    finished it, i.e. the host's enqueue of its ~2000 kernels)."""
    t0 = time.perf_counter()
    _, warm = trainer.train_steps(ids, y, steps=ERNIE_WARM)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_attention_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, timed = trainer.train_steps(ids, y, steps=ERNIE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = attention_counts(fa)
    peak = torch.cuda.max_memory_allocated()
    losses = warm.float().cpu().tolist() + timed.float().cpu().tolist()
    check(all(math.isfinite(v) for v in losses),
          f"ERNIE non-finite loss: {losses}")
    t0 = time.perf_counter()
    trainer.train_steps(ids, y, steps=1)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return losses, wall, peak, counts, warm_s, host_ms


def phase_ernie(torch, np, P, card: str):
    """(6j) bench_ernie's accelerator configuration: dropout 0.1
    everywhere sends attention to the dense path."""
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    cfg = P.models.ernie_base()
    check((cfg.hidden_size, cfg.num_layers, cfg.num_heads,
           cfg.intermediate_size, cfg.vocab_size, cfg.attention_dropout)
          == (768, 12, 12, 3072, 40000, 0.1), f"not ERNIE-base: {cfg}")
    model, trainer = ernie_trainer(P, cfg)
    ids, y = ernie_batch(torch, np, cfg)
    losses, wall, peak, counts, warm_s, host_ms = timed_ernie(
        torch, trainer, ids, y, fa)
    want = cfg.num_layers * ERNIE_STEPS
    check(counts == (0, 0, 0, 0, want),
          f"6j attention (K2, K3, wgmma K2, wgmma K3, dense) {counts}, "
          f"want dense {want} = {cfg.num_layers} layers x {ERNIE_STEPS} "
          f"forwards and no kernel")
    bs, seq = ERNIE_SHAPE["b"], ERNIE_SHAPE["s"]
    step_ms = wall / ERNIE_STEPS * 1e3
    seq_s = bs * ERNIE_STEPS / wall
    flops = bert_step_flops(cfg, bs, seq)
    bound_ms = flops / BF16_FLOPS * 1e3
    log(f"  ERNIE-base O2 bf16, bs {bs} x seq {seq}, AdamW(2e-5), dropout "
        f"0.1: {ERNIE_WARM} warm-up steps in {warm_s:.2f} s; losses "
        f"{[round(v, 4) for v in losses]}; dense attention calls "
        f"{counts[4]} = {cfg.num_layers} x {ERNIE_STEPS}, K2/K3 0")
    log(f"  ERNIE-base (6j) [{card}]: {step_ms:.2f} ms per step, "
        f"{seq_s:.1f} seq/s, peak memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); one step's host enqueue "
        f"{host_ms:.2f} ms")
    log(f"  ERNIE-base step compute bound: {flops / 1e12:.3f} TFLOP (6 x "
        f"matmul parameters x {bs * seq} tokens + attention's 6 "
        f"products) / {BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 = "
        f"{bound_ms:.3f} ms ({bound_ms / step_ms:.1%} of the step)")
    prof = profile_steps(torch, trainer, None, steps=1, top=15,
                         batch=(ids, y), kernel_groups=ERNIE_GROUPS)
    if prof:
        # the profiler slows the host: the busy share of the plain step
        log(f"  device busy {prof['busy_ms_per_step']:.2f} ms of the "
            f"unprofiled {step_ms:.2f} ms step: busy share "
            f"{prof['busy_ms_per_step'] / step_ms:.3f}")
    del trainer, model
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms, "seq_per_s": seq_s,
            "peak_bytes": peak, "warmup_s": warm_s, "wall_s": wall,
            "host_ms": host_ms, "dense_calls": counts[4],
            "step_flops": flops, "bound_ms": bound_ms, "profile": prof}


def phase_ernie_kernels(torch, np, P, card: str, dense_run):
    """(6k) the kernel route: attention_dropout 0 (training), an eval
    forward, and examples/finetune_bert.py's loop at ernie_base."""
    from paddle_tpu_torch.optimizer import lr as lr_mod
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    cfg = P.models.ernie_base(attention_dropout=0.0)
    n = cfg.num_layers
    model, trainer = ernie_trainer(P, cfg)
    ids, y = ernie_batch(torch, np, cfg)
    losses, wall, peak, counts, _, host_ms = timed_ernie(torch, trainer,
                                                         ids, y, fa)
    want = n * ERNIE_STEPS
    check(counts == (want, want, want, want, 0),
          f"6k attention (K2, K3, wgmma K2, wgmma K3, dense) {counts}, "
          f"want {want} = {n} layers x {ERNIE_STEPS} steps on the wgmma "
          f"route and no dense call")
    launches = counts[0]
    step_ms = wall / ERNIE_STEPS * 1e3
    bs = ERNIE_SHAPE["b"]
    log(f"  ERNIE-base O2 bf16, attention_dropout 0 [{card}]: "
        f"{step_ms:.2f} ms per step ({bs * ERNIE_STEPS / wall:.1f} seq/s; "
        f"6j's dense route {dense_run['step_ms']:.2f}), host enqueue "
        f"{host_ms:.2f} ms a step (6j's {dense_run['host_ms']:.2f}), peak "
        f"{peak / 2**30:.2f} GiB; K2 {counts[0]}, K3 {counts[1]} launches "
        f"(wgmma), dense 0; losses {[round(v, 4) for v in losses]}")
    reset_attention_counts(fa)
    ev_loss, logits = trainer.eval_step(ids, y)
    torch.cuda.synchronize()
    ev_counts = attention_counts(fa)
    check(ev_counts == (n, 0, n, 0, 0),
          f"6k eval forward (K2, K3, wgmma K2, wgmma K3, dense) "
          f"{ev_counts}, want K2 {n}, K3 0")
    check(math.isfinite(float(ev_loss)) and tuple(logits.shape) == (bs, 2),
          f"6k eval: loss {float(ev_loss)}, logits {tuple(logits.shape)}")
    log(f"  eval forward of the {bs} x {ERNIE_SHAPE['s']} batch, no mask: "
        f"K2 {ev_counts[0]}, K3 0, dense 0; loss {float(ev_loss):.4f}")
    del trainer, model
    torch.cuda.empty_cache()
    # examples/finetune_bert.py at --arch ernie_base (attention dropout 0)
    sched = lr_mod.LinearWarmup(
        lr_mod.CosineAnnealingDecay(2e-5, T_max=FINETUNE_STEPS),
        warmup_steps=max(FINETUNE_STEPS // 10, 1), start_lr=0.0,
        end_lr=2e-5)
    model, trainer = ernie_trainer(P, cfg, lr=sched, weight_decay=0.01)
    rng = np.random.RandomState(0)
    half = cfg.vocab_size // 2
    fy = rng.randint(0, 2, (FINETUNE_BATCH,))
    fids = rng.randint(0, half, (FINETUNE_BATCH, ERNIE_SHAPE["s"])) \
        + fy[:, None] * half
    reset_attention_counts(fa)
    t0 = time.perf_counter()
    _, ft = trainer.train_steps(fids, fy, steps=FINETUNE_STEPS)
    ft = ft.float().cpu().tolist()
    ft_wall = time.perf_counter() - t0
    ft_counts = attention_counts(fa)
    want = n * FINETUNE_STEPS
    at = sorted({*range(0, FINETUNE_STEPS, 10), FINETUNE_STEPS - 1})
    check(all(math.isfinite(v) for v in ft), f"finetune losses {ft}")
    check(ft_counts == (want, want, want, want, 0),
          f"finetune attention {ft_counts}, want {want} each on wgmma")
    log(f"  finetune_bert loop at ernie_base (bs {FINETUNE_BATCH} x "
        f"{ERNIE_SHAPE['s']}, {FINETUNE_STEPS} steps, LinearWarmup("
        f"CosineAnnealingDecay(2e-5)), AdamW(weight_decay=0.01)): "
        f"{ft_wall:.2f} s; losses every 10 steps and the last: "
        f"{[round(ft[i], 4) for i in at]}; K2/K3 "
        f"{ft_counts[0]}/{ft_counts[1]}")
    del trainer, model
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms, "peak_bytes": peak,
            "wall_s": wall, "host_ms": host_ms, "fwd_launches": launches,
            "bwd_launches": counts[1], "eval_launches": ev_counts[0],
            "finetune_losses": ft, "finetune_s": ft_wall}


def pad_collate(np, length: int):
    """(ids, token types, attention_mask, labels) of (doc, label)
    samples: each doc cut or zero-padded to `length`, the mask 1 over
    its tokens."""
    def collate(batch):
        n = len(batch)
        ids = np.zeros((n, length), np.int64)
        mask = np.zeros((n, length), np.int64)
        for i, (doc, _) in enumerate(batch):
            m = min(len(doc), length)
            ids[i, :m] = doc[:m]
            mask[i, :m] = 1
        labels = np.asarray([lab for _, lab in batch], np.int64)
        return ids, np.zeros_like(ids), mask, labels
    return collate


def bert_cpu_vs_card(torch, np, P, masked: bool):
    """A 2-layer BERT (hidden 128, 2 heads: d 64), fp32, dropout 0, 3
    SGD(0.5) steps at 8 x 32 on the CPU and on the card, each of the
    card's from the CPU's state: (losses cpu, losses card, worst
    parameter error / max|param|, its name). SGD keeps a parameter's
    difference the gradient's (Adam's first steps turn a gradient near
    0 into a step of +-lr, so an ulp can flip a whole step)."""
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import SGD
    cfg = P.models.BertConfig(vocab_size=1000, hidden_size=128,
                              num_layers=2, num_heads=2,
                              intermediate_size=256,
                              max_position_embeddings=64, hidden_dropout=0.0,
                              attention_dropout=0.0)
    rs = np.random.RandomState(1)
    ids = rs.randint(0, cfg.vocab_size, (8, 32))
    tt = rs.randint(0, cfg.type_vocab_size, (8, 32))
    y = rs.randint(0, 2, (8,))
    lengths = rs.randint(8, 33, (8, 1))
    mask = (np.arange(32)[None, :] < lengths).astype(np.int64)
    batch = (ids, tt, mask, y) if masked else (ids, tt, y)
    trainers = {dev: Trainer(P.models.BertForSequenceClassification(
                    cfg, 2, seed=0, device=dev), SGD(0.5),
                    lambda o, t: F.cross_entropy(o, t),
                    num_inputs=len(batch) - 1)
                for dev in ("cpu", "cuda")}
    cpu, card = trainers["cpu"], trainers["cuda"]
    cpu.init_state()
    losses = {"cpu": [], "cuda": []}
    worst = (0.0, "")
    for _ in range(3):
        card.load_state(cpu.state)
        for dev, tr in trainers.items():
            loss, _ = tr.train_step(*batch)
            losses[dev].append(float(loss))
        worst = max([worst] + [
            (float((card.state.params[k].detach().cpu() - v.detach()).abs()
                   .max() / v.detach().abs().max().clamp_min(1e-30)), k)
            for k, v in cpu.state.params.items()])
    return losses["cpu"], losses["cuda"], worst


def phase_ernie_padded(torch, np, P, card: str):
    """(6l) padded batches through hapi (dense attention), the MLM head
    under O2, and card == CPU for a 2-layer BERT with and without a
    mask."""
    from paddle_tpu_torch import hapi, metric, nn, optimizer, text
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    text.set_synthetic_fallback(True)
    imdb = text.Imdb(mode="train")
    cfg = P.models.ernie_base()
    net = P.models.BertForSequenceClassification(cfg, 2, seed=0,
                                                 device="cuda")
    model = hapi.Model(net, inputs=["input_ids", "token_type_ids",
                                    "attention_mask"], labels=["label"])
    model.prepare(optimizer.AdamW(learning_rate=2e-5),
                  nn.CrossEntropyLoss(), metric.Accuracy(),
                  amp_configs="O2")
    loader = DataLoader(imdb, batch_size=IMDB_BATCH, shuffle=True,
                        collate_fn=pad_collate(np, IMDB_PAD))
    reset_attention_counts(fa)
    t0 = time.perf_counter()
    hist = model.fit(loader, epochs=1, verbose=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = attention_counts(fa)
    steps = len(loader)
    check(steps == 16 and model._trainer.state.step == steps,
          f"fit took {model._trainer.state.step} steps, want 16")
    check(counts == (0, 0, 0, 0, cfg.num_layers * steps),
          f"6l fit attention (K2, K3, wgmma K2, wgmma K3, dense) "
          f"{counts}, want dense {cfg.num_layers} x {steps}")
    check(math.isfinite(hist["loss"][0]) and 0 <= hist["acc"][0] <= 1,
          f"fit history {hist}")
    seq_s = len(imdb) / wall
    log(f"  hapi.Model(ernie_base classifier).fit, 1 epoch of synthetic "
        f"Imdb ({len(imdb)} reviews of 16-63 tokens padded to "
        f"{IMDB_PAD}, bs {IMDB_BATCH}, O2 bf16, AdamW(2e-5)) [{card}]: "
        f"{wall:.2f} s, {seq_s:.1f} seq/s including the loader and the "
        f"first steps; fit's ips {hist['ips'][0]:.1f}; dense calls "
        f"{counts[4]}, K2/K3 0; loss {hist['loss'][0]:.4f}, acc "
        f"{hist['acc'][0]:.4f}")
    del model, net
    torch.cuda.empty_cache()
    # the MLM head: one O2 step at 16 x 128
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.optimizer import AdamW
    mlm = P.models.BertForMaskedLM(cfg, seed=0, device="cuda")
    tr = Trainer(mlm, AdamW(learning_rate=2e-5),
                 lambda logits, t: F.cross_entropy(
                     logits.reshape(-1, logits.shape[-1]), t.reshape(-1)),
                 amp_level="O2", amp_dtype="bfloat16")
    mids = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (FINETUNE_BATCH, ERNIE_SHAPE["s"]))).cuda()
    pool0 = mlm.bert.pooler.weight.detach().clone()     # fp32
    reset_attention_counts(fa)
    t0 = time.perf_counter()
    mlm_loss, logits = tr.train_step(mids, mids)
    torch.cuda.synchronize()
    mlm_s = time.perf_counter() - t0
    mcounts = attention_counts(fa)
    check(math.isfinite(float(mlm_loss)) and tuple(logits.shape)
          == (FINETUNE_BATCH, ERNIE_SHAPE["s"], cfg.vocab_size),
          f"MLM step: loss {float(mlm_loss)}, logits "
          f"{tuple(logits.shape)}")
    check(mcounts == (0, 0, 0, 0, cfg.num_layers),
          f"MLM attention {mcounts}, want dense {cfg.num_layers}")
    # the pooler's fp32 master: decayed by AdamW under its zero gradient
    moved = not torch.equal(tr.state.opt_state["slots"][
        "bert.pooler.weight"]["master_weight"], pool0)
    log(f"  BertForMaskedLM(ernie_base) one O2 step at {FINETUNE_BATCH} x "
        f"{ERNIE_SHAPE['s']} (vocab {cfg.vocab_size}, tied head): loss "
        f"{float(mlm_loss):.4f} (ln V = {math.log(cfg.vocab_size):.4f}), "
        f"{mlm_s:.2f} s with its first-call costs; the unreached pooler "
        f"moved by AdamW's decay: {moved}")
    del tr, mlm, logits
    torch.cuda.empty_cache()
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"fit_s": wall, "seq_per_s": seq_s, "fit_ips": hist["ips"][0],
           "history": hist, "mlm_loss": float(mlm_loss)}
    try:
        for masked in (False, True):
            lc, lg, (err, name) = bert_cpu_vs_card(torch, np, P, masked)
            rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
            tag = "with" if masked else "without"
            check(rel <= 1e-4, f"2-layer BERT {tag} mask: losses card {lg} "
                               f"vs CPU {lc}: {rel:.2e} > 1e-4")
            check(err <= 1e-4, f"2-layer BERT {tag} mask: {name} card vs "
                               f"CPU {err:.2e} > 1e-4")
            log(f"  2-layer BERT fp32 (TF32 off) {tag} a padding mask, 3 "
                f"SGD steps each from the CPU's state, card vs CPU: "
                f"losses {lc} / {lg}, max relative {rel:.2e}; worst "
                f"parameter {err:.2e} of its largest magnitude ({name}); "
                f"limits 1e-4")
            out[f"card_vs_cpu_{tag}_mask"] = {"loss_rel": rel,
                                              "param_err": err}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    return out


# --------------------------------------------------------------------------- #
# phases 6m-6p: capture, export and the Predictor
# --------------------------------------------------------------------------- #

CAPTURE_BATCH = 64                   # 6m's images, 6n's largest batch
CAPTURE_TRAIN_BATCH = 16             # 6m's train step (a trace's cost is
                                     # the batch's; the step's is not)
PREDICTOR_BATCHES = (1, 8, 64)
PREDICTOR_REPS = 10
RESNET_CAPTURE_TOL = 1e-5            # of the largest magnitude, fp32
ERNIE_EXPORT_BATCH, ERNIE_TUNE_BATCH = 64, 16


@contextlib.contextmanager
def tf32_off(torch):
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def rel_err(a, b) -> float:
    """max|a - b| over the largest |b|."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def wall_ms(torch, fn, reps: int) -> float:
    """Host ms of one `fn()` call, the device synchronised after `reps`
    calls (one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def device_busy_ms(torch, fn):
    """(CUDA kernels, the device's busy ms) of one profiled `fn()` call
    (after one unprofiled call): the device time a replay of the same
    work could approach."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("Command Buffer")]
    return len(kernels), busy_us(kernels) / 1e3


def phase_to_static_resnet(torch, np, P, card: str):
    """(6m) ResNet-50 (NCHW, 224^2, fp32, TF32 off, cuDNN's
    deterministic algorithms) through `jit.to_static`: an eval forward
    of 64 images equals the eager one, and one Momentum step in train
    mode on 16 of them through the captured program equals one eager
    step from the same state (loss, parameters and BatchNorm buffers),
    each within RESNET_CAPTURE_TOL of the largest magnitude. cuDNN's
    default weight-gradient algorithms sum in a run-dependent order:
    with them a parameter after the step differed by 1.9e-5 of its
    largest magnitude."""
    import copy
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    out = {}
    was_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with tf32_off(torch), contextlib.ExitStack() as restore:
        restore.callback(setattr, torch.backends.cudnn, "deterministic",
                         was_det)
        model = P.models.resnet50(device="cuda")
        twin = copy.deepcopy(model)
        rs = np.random.RandomState(0)
        x = torch.from_numpy(rs.randn(CAPTURE_BATCH, 3, RESNET_SIZE,
                                      RESNET_SIZE).astype(np.float32)).cuda()
        y = torch.from_numpy(rs.randint(0, 1000, (CAPTURE_BATCH,))).cuda()
        xt, yt = x[:CAPTURE_TRAIN_BATCH], y[:CAPTURE_TRAIN_BATCH]
        static = jit.to_static(model)
        model.eval()
        t0 = time.perf_counter()
        with torch.no_grad():
            got = static(x)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        with torch.no_grad():
            want = model(x)
        err = rel_err(got, want)
        check(err <= RESNET_CAPTURE_TOL,
              f"6m eval forward: captured vs eager {err:.2e} > "
              f"{RESNET_CAPTURE_TOL}")
        out["eval_err"], out["eval_capture_s"] = err, capture_s
        # one Momentum step in train mode: captured (model) vs eager (twin)
        model.train()
        twin.train()
        losses, t0 = {}, time.perf_counter()
        for name, m, fwd in (("captured", model, static), ("eager", twin,
                                                            twin)):
            params = {k: p for k, p in m.named_parameters()}
            loss = F.cross_entropy(fwd(xt), yt)
            grads = torch.autograd.grad(loss, list(params.values()))
            Momentum(0.1, 0.9).bind(m).step(dict(zip(params, grads)))
            losses[name] = float(loss.detach())
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        loss_err = abs(losses["captured"] - losses["eager"]) \
            / abs(losses["eager"])
        worst = {"params": (0.0, ""), "buffers": (0.0, "")}
        for part, get in (("params", lambda m: m.named_parameters()),
                          ("buffers", lambda m: m.named_buffers())):
            mine = dict(get(model))
            worst[part] = max((rel_err(mine[k], v), k)
                              for k, v in get(twin))
        buf0 = dict(P.models.resnet50(device="cuda").named_buffers())
        moved = sum(not torch.equal(v, buf0[k])
                    for k, v in model.named_buffers() if v.is_floating_point())
        check(loss_err <= RESNET_CAPTURE_TOL,
              f"6m loss captured {losses['captured']} vs eager "
              f"{losses['eager']}")
        for part, (e, k) in worst.items():
            check(e <= RESNET_CAPTURE_TOL,
                  f"6m {part}: {k} captured vs eager {e:.2e}")
        check(moved == 106, f"6m: {moved} BatchNorm buffers moved, want "
                            f"ResNet-50's 106")
        log(f"  ResNet-50 fp32 (TF32 off) through jit.to_static [{card}]: "
            f"eval forward of {CAPTURE_BATCH} x 3 x {RESNET_SIZE}^2 "
            f"captured in {capture_s:.2f} s, captured vs eager "
            f"{err:.2e}; one Momentum(0.1, 0.9) step in train mode on "
            f"{CAPTURE_TRAIN_BATCH} of them "
            f"({train_s:.2f} s with the train capture): loss "
            f"{losses['captured']:.6f} vs {losses['eager']:.6f} "
            f"({loss_err:.2e}), worst parameter {worst['params'][0]:.2e} "
            f"({worst['params'][1]}), worst buffer "
            f"{worst['buffers'][0]:.2e} ({worst['buffers'][1]}), "
            f"{moved} BatchNorm buffers moved in place; limit "
            f"{RESNET_CAPTURE_TOL} of the largest magnitude")
        out.update(loss_err=loss_err, param_err=worst["params"][0],
                   buffer_err=worst["buffers"][0], train_s=train_s,
                   programs=len(static._programs))
        del twin, static, model
        torch.cuda.empty_cache()
    return out


PREDICTOR_CHILD = r"""
import json, sys, time
sys.modules["jax"] = None
sys.modules["paddle_tpu"] = None
import numpy as np, torch
from paddle_tpu_torch import inference
prefix, batches, reps = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
size = int(sys.argv[4])
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
pred = inference.create_predictor(inference.Config(prefix + ".pt2"))
res = {"load_s": time.perf_counter() - t0, "batches": {}}
entries = {}
for b in batches:
    x = np.load(f"{prefix}.x{b}.npy")
    t0 = time.perf_counter()
    got = pred.run([x])[0]
    first = time.perf_counter() - t0
    entries[b] = pred._compiled[(((b, 3, size, size), torch.float32),)]
    want = np.load(f"{prefix}.want{b}.npy")
    err = float(np.abs(got - want).max() / np.abs(want).max())
    def positional():
        pred.run([x])
    h = pred.get_input_handle(pred.get_input_names()[0])
    xd = torch.from_numpy(x).cuda()
    def replay():
        h.share_external_data(xd)
        pred.run()
    out = {"err": err, "first_s": first}
    for name, fn in (("run_ms", positional), ("replay_ms", replay)):
        fn(); torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / reps * 1e3
    res["batches"][str(b)] = out
pred.run([np.load(f"{prefix}.x{batches[1]}.npy")])      # a repeated batch
key = (((batches[1], 3, size, size), torch.float32),)
res["entries"] = len(pred._compiled)
res["reused"] = pred._compiled[key] is entries[batches[1]]
res["graphed"] = all(e[1].graph is not None for e in pred._compiled.values())
res["modules_jax"] = sorted(
    m for m in sys.modules if sys.modules[m] is not None
    and (m in ("jax", "paddle_tpu") or m.startswith(("jax.", "paddle_tpu."))))
print(json.dumps(res))
"""


def phase_predictor_resnet(torch, np, P, card: str, tmp: str):
    """(6n) `jit.save` of ResNet-50 (seed 0, eval; 6m's one step at lr
    0.1 leaves running statistics that overflow its eval forward) with
    a dynamic batch; a fresh
    process that imports only paddle_tpu_torch serves batches 1, 8 and
    64 through `inference.Predictor` on the card (one CUDA graph per
    signature) against this process's eager outputs (fp32, TF32 off on
    both sides, within RESNET_CAPTURE_TOL of the largest magnitude)."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.static import InputSpec
    prefix = os.path.join(tmp, "resnet50")
    model = P.models.resnet50(device="cuda")
    model.eval()
    t0 = time.perf_counter()
    with tf32_off(torch):
        jit.save(model, prefix, input_spec=[InputSpec([None, 3, RESNET_SIZE,
                                                       RESNET_SIZE])])
        save_s = time.perf_counter() - t0
        rs = np.random.RandomState(1)
        eager = {}
        for b in PREDICTOR_BATCHES:
            x = rs.randn(b, 3, RESNET_SIZE, RESNET_SIZE).astype(np.float32)
            xd = torch.from_numpy(x).cuda()
            with torch.no_grad():
                want = model(xd).cpu().numpy()
                ms = wall_ms(torch, lambda: model(xd), PREDICTOR_REPS)
                eager[b] = (ms,) + device_busy_ms(torch, lambda: model(xd))
            np.save(f"{prefix}.x{b}.npy", x)
            np.save(f"{prefix}.want{b}.npy", want)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", PREDICTOR_CHILD, prefix,
         json.dumps(PREDICTOR_BATCHES), str(PREDICTOR_REPS),
         str(RESNET_SIZE)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"6n Predictor process failed:\n"
                                f"{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    check(res["modules_jax"] == [], f"6n child imported {res['modules_jax']}")
    check(res["entries"] == len(PREDICTOR_BATCHES) and res["reused"]
          and res["graphed"],
          f"6n: {res['entries']} compiled entries (want "
          f"{len(PREDICTOR_BATCHES)}), repeated batch reused "
          f"{res['reused']}, all CUDA graphs {res['graphed']}")
    log(f"  jit.save(ResNet-50, InputSpec([None, 3, {RESNET_SIZE}, "
        f"{RESNET_SIZE}])) in {save_s:.2f} s; a fresh process (no jax, no "
        f"paddle_tpu) built the Predictor in {res['load_s']:.2f} s, "
        f"{child_s:.1f} s in all; {res['entries']} entries (one CUDA graph "
        f"per batch), a repeated batch reused its entry")
    for b in PREDICTOR_BATCHES:
        r = res["batches"][str(b)]
        check(r["err"] <= RESNET_CAPTURE_TOL,
              f"6n batch {b}: Predictor vs eager {r['err']:.2e}")
        ms, kernels, busy = eager[b]
        log(f"  [{card}] batch {b}: eager forward {ms:.2f} ms ({kernels} "
            f"kernels, device busy {busy:.2f} ms), "
            f"Predictor run (numpy in and out) {r['run_ms']:.2f} ms = "
            f"{b / r['run_ms'] * 1e3:.1f} images/s, graph replay on "
            f"device-resident input {r['replay_ms']:.2f} ms = "
            f"{b / r['replay_ms'] * 1e3:.1f} images/s, first run (capture) "
            f"{r['first_s']:.2f} s; vs eager {r['err']:.2e} (limit "
            f"{RESNET_CAPTURE_TOL})")
        r["eager_ms"], r["eager_kernels"], r["busy_ms"] = eager[b]
    res["save_s"], res["child_s"] = save_s, child_s
    del model
    torch.cuda.empty_cache()
    return res


def phase_export_ernie(torch, np, P, card: str, tmp: str, ernie_k):
    """(6o) ERNIE-3.0-base (bf16, eval, no mask) exported with specs
    [None, 128] x 2: a Predictor at 64 x 128 replays one CUDA graph
    whose run launches K2 12 times and no dense attention, within phase
    3's bf16 tolerance of the eager forward; `jit.load` and one SGD step
    on the loaded layer over 16 x 128 (lr a tenth of loss / |g|^2)
    launch K2 12 and K3 12 times, and the loss on that batch falls."""
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.static import InputSpec
    cfg = P.models.ernie_base()
    n, s = cfg.num_layers, ERNIE_SHAPE["s"]
    model = P.models.BertForSequenceClassification(
        cfg, 2, seed=0, device="cuda", dtype="bfloat16")
    model.eval()
    prefix = os.path.join(tmp, "ernie")
    t0 = time.perf_counter()
    jit.save(model, prefix, input_spec=[InputSpec([None, s], "int64"),
                                        InputSpec([None, s], "int64")])
    save_s = time.perf_counter() - t0
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab_size, (ERNIE_EXPORT_BATCH, s))
    tt = np.zeros_like(ids)
    ids_d, tt_d = torch.from_numpy(ids).cuda(), torch.from_numpy(tt).cuda()
    with torch.no_grad():
        want = model(ids_d, tt_d)
        eager_ms = wall_ms(torch, lambda: model(ids_d, tt_d), PREDICTOR_REPS)
        kernels, busy = device_busy_ms(torch, lambda: model(ids_d, tt_d))
    t0 = time.perf_counter()
    pred = inference.create_predictor(inference.Config(prefix))
    got = pred.run([ids, tt])[0]          # warm-up, capture, one replay
    first_s = time.perf_counter() - t0
    reset_attention_counts(fa)
    got = pred.run([ids, tt])[0]
    torch.cuda.synchronize()
    counts = attention_counts(fa)
    check(counts == (n, 0, n, 0, 0),
          f"6o Predictor run (K2, K3, wgmma K2, wgmma K3, dense) {counts}, "
          f"want K2 {n} on the wgmma route and nothing else")
    check(len(pred._compiled) == 1 and all(
        e[1].graph is not None for e in pred._compiled.values()),
          "6o: the Predictor's entry is not one CUDA graph")
    want_np = want.float().cpu().numpy()
    err = float(np.abs(got - want_np).max())
    check(np.allclose(got, want_np, **TOL["bfloat16"]),
          f"6o Predictor vs eager: max |diff| {err:.3e} beyond bf16's "
          f"atol = rtol = 2e-2")
    h = [pred.get_input_handle(k) for k in pred.get_input_names()]

    def replay():
        h[0].share_external_data(ids_d)
        h[1].share_external_data(tt_d)
        pred.run()
    run_ms = wall_ms(torch, lambda: pred.run([ids, tt]), PREDICTOR_REPS)
    replay_ms = wall_ms(torch, replay, PREDICTOR_REPS)
    log(f"  ERNIE-base bf16 eval exported (InputSpec([None, {s}], int64) "
        f"x 2) in {save_s:.2f} s; the Predictor's first run (load, "
        f"capture) {first_s:.2f} s; one replay: K2 {counts[0]} (wgmma), "
        f"dense 0; vs eager max |diff| {err:.3e} (bf16 limits atol = rtol "
        f"= 2e-2)")
    log(f"  [{card}] ERNIE-base {ERNIE_EXPORT_BATCH} x {s}: eager forward "
        f"{eager_ms:.2f} ms ({kernels} kernels, device busy {busy:.2f} "
        f"ms), Predictor run (numpy in and out) "
        f"{run_ms:.2f} ms, graph replay on device-resident input "
        f"{replay_ms:.2f} ms ({ERNIE_EXPORT_BATCH / replay_ms * 1e3:.1f} "
        f"seq/s); 6k's eager training step enqueued in "
        f"{ernie_k['host_ms']:.2f} ms on the host with K2/K3 as "
        f"operators (PR 19: 53.7-137.6 ms through autograd.Function)")
    del pred, model
    torch.cuda.empty_cache()
    # the loaded layer, fine-tuned: one SGD step over 16 x 128
    layer = jit.load(prefix)
    layer.train()
    fy = torch.from_numpy(rs.randint(0, 2, (ERNIE_TUNE_BATCH,))).cuda()
    fids, ftt = ids_d[:ERNIE_TUNE_BATCH], tt_d[:ERNIE_TUNE_BATCH]
    params = dict(layer.named_parameters())
    reset_attention_counts(fa)
    loss0 = F.cross_entropy(layer(fids, ftt).float(), fy)
    grads = torch.autograd.grad(loss0, list(params.values()))
    loss0 = loss0.detach()
    torch.cuda.synchronize()
    step_counts = attention_counts(fa)
    # a tenth of the step that the first-order model says would take
    # the loss to 0 (at lr 0.1 the bf16 step overshot: 0.66 -> 1.53)
    gsq = sum(float(g.float().square().sum()) for g in grads)
    lr = 0.1 * float(loss0) / gsq
    SGD(lr).bind(layer).step(dict(zip(params, grads)))
    with torch.no_grad():
        loss1 = F.cross_entropy(layer(fids, ftt).float(), fy)
    check(step_counts == (n, n, n, n, 0),
          f"6o loaded-layer step (K2, K3, wgmma K2, wgmma K3, dense) "
          f"{step_counts}, want {n} each on the wgmma route")
    check(float(loss1) < float(loss0),
          f"6o loaded-layer SGD step: loss {float(loss0)} -> "
          f"{float(loss1)}, did not fall")
    log(f"  jit.load(ERNIE-base) and one SGD step (lr {lr:.3e} = 0.1 x "
        f"loss / |g|^2) on the loaded layer over {ERNIE_TUNE_BATCH} x "
        f"{s}: K2 {step_counts[0]}, K3 "
        f"{step_counts[1]} (wgmma), dense 0; loss {float(loss0):.4f} -> "
        f"{float(loss1):.4f} on the same batch")
    del layer, grads
    torch.cuda.empty_cache()
    return {"save_s": save_s, "first_s": first_s, "counts": counts,
            "err": err, "eager_ms": eager_ms, "eager_kernels": kernels,
            "busy_ms": busy, "run_ms": run_ms,
            "replay_ms": replay_ms, "step_counts": step_counts,
            "losses": [float(loss0), float(loss1)], "sgd_lr": lr,
            "fwd_launches": counts[0], "tune_fwd": step_counts[0],
            "tune_bwd": step_counts[1]}


def cf_function(x, n):
    """(6p) a traced if / elif, a while with a break and a for over a
    traced bound with an early return."""
    s = x.sum()
    if s > 0:
        y = x * 2.0
    elif s > -8.0:
        y = x + 1.0
    else:
        y = -x
    total = y[0] * 0.0
    i = n * 0
    while i < 16:
        total = total + y[i]
        if total.sum() > 40.0:
            break
        i = i + 1
    acc = total * 0.0
    for j in range(n):
        acc = acc + y[j] * 0.5
        if acc.sum() > 30.0:
            return acc * 3.0
    return acc + total


def cf_layer(torch, P):
    """(6p) a Layer whose forward holds a traced if and a while with a
    break."""
    from paddle_tpu_torch.core import make_generator
    from paddle_tpu_torch.nn.layers import Linear

    class ControlFlowLayer(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = Linear(64, 64, 0.2, make_generator(3))

        def forward(self, x, n):
            h = self.fc(x)
            if h.mean() > 0:
                out = h * 0.5
            else:
                out = -h
            k = n * 0
            while k < n:
                out = out + h[k]
                if out.sum() > 500.0:
                    break
                k = k + 1
            return out

    return ControlFlowLayer().cuda()


def phase_dy2static_card(torch, np, P, card: str, tmp: str):
    """(6p) dy2static on the card: the exported program of a function
    and of a Layer with traced control flow equals the eager (Python
    path) call on inputs that take each branch; the Predictor serves
    the saved program eagerly (it holds torch.cond / while_loop nodes),
    as its docstring says, with the same outputs."""
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.jit.dy2static import convert_to_static
    from paddle_tpu_torch.static import InputSpec
    rs = np.random.RandomState(5)
    base = rs.randn(16, 64).astype(np.float32)
    cases = [(base * 0.1 + 0.05, 5), (-base * 0.01 - 0.005, 12),
             (-np.abs(base) - 1.0, 3), (np.abs(base) * 3.0, 16)]
    layer = cf_layer(torch, P)
    targets = (("function", cf_function, convert_to_static(cf_function)),
               ("Layer", layer, layer.forward))
    rows = {}
    for name, obj, eager in targets:
        static = jit.to_static(obj)
        t0 = time.perf_counter()
        for xv, nv in cases:
            x = torch.from_numpy(xv).cuda()
            nt = torch.tensor(nv).cuda()
            got = static(x, nt)
            with torch.no_grad():
                want = eager(x, nt)
            diff = float((got - want).detach().abs().max())
            check(torch.equal(got, want),
                  f"6p {name}: exported vs eager differ by {diff:.3e} at "
                  f"n {nv}")
        prog = static.program(x, nt)
        check(jit.has_control_flow(prog), f"6p {name}: no cond / while_loop "
                                          f"node in the program")
        capture_s = time.perf_counter() - t0
        prefix = os.path.join(tmp, f"cf_{name}")
        spec = [InputSpec([16, 64]), InputSpec([], "int64")]
        jit.save(obj, prefix, input_spec=spec, device=x.device)
        pred = inference.create_predictor(inference.Config(prefix))
        for xv, nv in cases:
            got = pred.run([xv, np.asarray(nv)])[0]
            with torch.no_grad():
                want = eager(torch.from_numpy(xv).cuda(),
                             torch.tensor(nv).cuda()).cpu().numpy()
            check(np.array_equal(got, want),
                  f"6p {name}: Predictor vs eager at n {nv}")
        check(pred.eager_reason is not None and all(
            e[1].graph is None for e in pred._compiled.values()),
              f"6p {name}: the Predictor captured a program with control "
              f"flow")
        rows[name] = {"capture_s": capture_s, "programs":
                      len(static._programs), "entries": len(pred._compiled)}
        log(f"  [{card}] {name}: {len(cases)} inputs through each branch, "
            f"exported == eager (bitwise), {len(static._programs)} program "
            f"({capture_s:.2f} s with the capture); the Predictor runs it "
            f"eagerly ({pred.eager_reason}), equal outputs")
    return rows


# --------------------------------------------------------------------------- #
# phases 6q-6s: parallel/ on the one card (configs 4 and 5)
# --------------------------------------------------------------------------- #

MESH_BATCH = dict(b=8, s=256)         # 6q: gpt_small, dp 2 x fsdp 2
DP_RANKS = 4                          # 6r: config 4's data ranks
DP_WARM, DP_STEPS = 2, 6
P1B = dict(b=8, s=2048, ranks=4, stage=2)   # 6s: config 5
P1B_STEPS = 3
# AdamW without warm-up: at 1e-4 the loss on the repeated batch fell
# for two steps and rose past its start at the fourth (11.24, 10.93,
# 10.62, 11.64; NVIDIA H100 80GB HBM3, 700.00 W)
P1B_LR = 3e-5


def collective_formulas(torch, C):
    """Each collective over 4 ranks' CUDA tensors (list form and rank
    form inside an SPMD run) against its rank-order formula, bitwise."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    xs = [torch.randn(8, 12, device="cuda", generator=gen)
          for _ in range(4)]
    s = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    want = {
        "sum": s, "avg": s / 4,
        "max": torch.maximum(torch.maximum(torch.maximum(xs[0], xs[1]),
                                           xs[2]), xs[3]),
        "min": torch.minimum(torch.minimum(torch.minimum(xs[0], xs[1]),
                                           xs[2]), xs[3]),
        "prod": ((xs[0] * xs[1]) * xs[2]) * xs[3]}
    for op, w in want.items():
        check(torch.equal(C.all_reduce(xs, op=op), w),
              f"all_reduce {op} != its rank-order formula")
    check(torch.equal(C.all_gather(xs, axis=1), torch.cat(xs, 1)),
          "all_gather")
    check(all(torch.equal(a, b) for a, b in zip(
        C.reduce_scatter(xs), s.chunk(4, 0))), "reduce_scatter")
    check(torch.equal(C.broadcast(xs, src=2), xs[2]), "broadcast")
    a2a = C.all_to_all(xs, split_axis=0, concat_axis=1)
    check(all(torch.equal(a2a[i], torch.cat([x.chunk(4, 0)[i] for x in xs],
                                            1)) for i in range(4)),
          "all_to_all")
    ring = C.ppermute(xs, [(i, (i + 1) % 4) for i in range(4)])
    check(all(torch.equal(ring[(i + 1) % 4], xs[i]) for i in range(4)),
          "ppermute")
    got = C.spmd([{"dp": i} for i in range(4)], lambda r: (
        C.all_reduce(xs[r], group="dp"), C.reduce_scatter(xs[r], group="dp"),
        C.all_to_all(xs[r], group="dp")))
    for r in range(4):
        check(torch.equal(got[r][0], s), f"rank {r}: in-run all_reduce")
        check(torch.equal(got[r][1], s.chunk(4, 0)[r]),
              f"rank {r}: in-run reduce_scatter")
        check(torch.equal(got[r][2], C.all_to_all(xs)[r]),
              f"rank {r}: in-run all_to_all")
    return len(want) + 5


def mesh_gpt_small_step(torch, np, P, parallel, stage, mesh, amp_level=None,
                        steps=1, grad_accum=1, model=None):
    """(losses, trainer) of `steps` Momentum steps of GPT-small (`model`,
    else a new one) on MESH_BATCH's ids (one rank when mesh is None)."""
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.optimizer import Momentum
    if model is None:
        model = P.models.gpt_small(seed=0, device="cuda")
    if mesh is not None:
        parallel.apply_fsdp(model, mesh, stage=stage)
    tr = Trainer(model, Momentum(1e-2, 0.9),
                 lambda lg, y: model.loss(lg, y), mesh=mesh,
                 amp_level=amp_level, grad_accum=grad_accum)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, model.cfg.vocab_size, (MESH_BATCH["b"], MESH_BATCH["s"]))).cuda()
    losses = [float(tr.train_step(ids, ids)[0]) for _ in range(steps)]
    return losses, tr


def move_errs(torch, got, want, p0):
    """Per parameter: ||move - one rank's move|| / ||one rank's move||
    (relative L2) and max |move - one rank's| / max |one rank's move|."""
    out = {}
    for k, w in want.items():
        d = (got[k] - p0[k]) - w
        out[k] = (float(d.norm() / w.norm().clamp_min(1e-30)),
                  float(d.abs().max() / w.abs().max().clamp_min(1e-30)))
    return out


def phase_mesh(torch, np, P, card: str):
    """(6q) the collectives on the card, and GPT-small (fp32, TF32 off,
    the tf32x3 route) taking one Momentum step under a dp 2 x fsdp 2
    mesh at ZeRO stages 1, 2 and 3 on the same batch as one rank. The
    first Momentum step moves each parameter by lr x its gradient, so
    the moves hold the gradients. Against one rank's whole-batch step:
    the loss within 1e-5 relative, each parameter's move within 1e-3 in
    relative L2 (the ranks' GEMMs and K2/K3 calls sum over 2 rows where
    one rank's sum over 8; a bias gradient sums thousands of rows that
    cancel, so its largest element may be further off: logged).
    Against one rank whose `grad_accum=4` microbatches are the ranks'
    rows (the same kernels at the same shapes): stage 1 (one all_reduce
    over the 4 ranks, in rank order) bitwise; stages 2-3 (a
    reduce_scatter per dp row, then an all_reduce over dp: another
    order of the four adds, which a cancelling bias gradient shows
    most) within 1e-5 relative L2. Per rank, slot
    bytes = the split entries' total over the fsdp ranks plus the
    entries that stay whole; a bf16 O2 step at stage 2 finite."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.nn import ranks
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel.sharding import Sharded, rank_bytes
    t0 = time.perf_counter()
    n_coll = collective_formulas(torch, C)
    log(f"  {n_coll} collectives over 4 ranks' CUDA tensors equal their "
        f"rank-order formulas bitwise (list and rank forms)")
    res = {"collectives_checked": n_coll, "stages": {}}
    with tf32_off(torch):
        p0 = {k: v.detach().clone()
              for k, v in P.models.gpt_small(seed=0, device="cuda"
                                             ).named_parameters()}
        moves = {}
        for acc in (1, 4):
            (loss,), tr1 = mesh_gpt_small_step(torch, np, P, parallel, None,
                                               None, grad_accum=acc)
            moves[acc] = (loss, {k: tr1.state.params[k].detach() - p0[k]
                                 for k in p0})
            del tr1
        one = moves[1][0]
        for stage in (1, 2, 3):
            mesh = parallel.init_mesh(dp=2, fsdp=2, device="cuda")
            ranks.reset_counts()
            (loss,), tr = mesh_gpt_small_step(torch, np, P, parallel, stage,
                                              mesh)
            counts = ranks.counts()
            st = tr.gathered_state()
            e1 = move_errs(torch, st.params, moves[1][1], p0)
            e4 = move_errs(torch, st.params, moves[4][1], p0)
            l2 = max(e1.values())
            mx = max(e1.items(), key=lambda kv: kv[1][1])
            l2_4 = max(v[0] for v in e4.values())
            check(abs(loss - one) <= 1e-5 * abs(one),
                  f"stage {stage}: loss {loss} vs one rank {one}")
            check(l2[0] <= 1e-3, f"stage {stage}: a parameter's move is "
                                 f"{l2[0]:.2e} off in relative L2")
            if stage == 1:
                check(l2_4 == 0.0 and loss == moves[4][0],
                      f"stage 1 vs grad_accum=4: {l2_4:.2e}, loss {loss} "
                      f"vs {moves[4][0]}")
            else:
                check(l2_4 <= 1e-5, f"stage {stage} vs grad_accum=4: "
                                    f"{l2_4:.2e}")
            per = rank_bytes(tr.state, mesh)
            total = sum(v.numel() * v.element_size() for s in
                        st.opt_state["slots"].values() for v in s.values())
            # the entries no dim of which splits (the column biases,
            # whose one dim the reference's tp spec holds) stay whole
            whole = sum(v.numel() * v.element_size()
                        for s in tr.state.opt_state["slots"].values()
                        for v in s.values() if not isinstance(v, Sharded))
            check(all(p["slots"] == (total - whole) / 2 + whole
                      for p in per),
                  f"stage {stage}: per-rank slot bytes "
                  f"{[p['slots'] for p in per]} vs the split {total - whole}"
                  f" / 2 + the whole {whole}")
            log(f"  stage {stage}, dp 2 x fsdp 2, fp32: loss {loss:.6f} "
                f"(one rank {one:.6f}); parameter moves against one rank's "
                f"worst {l2[0]:.2e} relative L2, largest element "
                f"{mx[1][1]:.2e} of its max ({mx[0]}); against grad_accum 4 "
                f"{l2_4:.2e}; per-rank slots {per[0]['slots']} B of {total} "
                f"B ({whole} B whole on every rank), params "
                f"{per[0]['params']} B; collectives {counts}")
            res["stages"][stage] = {
                "loss": loss, "one_rank_loss": one, "move_rel_l2": l2[0],
                "move_max_elem": [mx[0], mx[1][1]],
                "vs_grad_accum4": l2_4, "rank_bytes": per[0],
                "slot_bytes_total": total, "slot_bytes_whole": whole,
                "collectives": counts}
            del tr, st
            parallel.set_mesh(None)
    mesh = parallel.init_mesh(dp=2, fsdp=2, device="cuda")
    losses, tr = mesh_gpt_small_step(torch, np, P, parallel, 2, mesh,
                                     amp_level="O2", steps=2)
    check(all(math.isfinite(x) for x in losses), f"O2 stage 2: {losses}")
    log(f"  stage 2 O2 bf16 (wgmma route): losses {losses}")
    res["o2_stage2_losses"] = losses
    del tr
    parallel.set_mesh(None)
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    return res


def resnet50_dp_trainer(torch, P, parallel, mesh, amp_level, lr=0.1):
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    model = P.models.resnet50(num_classes=1000, data_format="NHWC",
                              stem_s2d=True, seed=0, device="cuda")
    model = parallel.DataParallel(model, mesh=mesh) if mesh else model
    return Trainer(model, Momentum(learning_rate=lr, momentum=0.9),
                   lambda out, y: F.cross_entropy(out, y), mesh=mesh,
                   amp_level=amp_level, amp_dtype="bfloat16")


def phase_dp_resnet50(torch, np, P, card: str):
    """(6r) config 4, "Fleet collective data-parallel ResNet-50":
    bench.py's shape (128 x 224^2, NHWC, stem_s2d, O2 bf16,
    Momentum(0.1, 0.9)) over DP_RANKS data ranks through
    `DataParallel` and `Trainer(mesh=)` with synced batch norm: the loss
    falls below its first value (no TPU kernel on this path), step ms,
    images/s, peak memory and the collectives per step. Then one step
    of the 4 ranks against one rank's whole-batch step from the same
    weights at RESNET_CHECK_BATCH x 224^2 (TF32 off, cuDNN
    deterministic; the gradients are the first Momentum step's move at
    lr 1): in fp64 the gradients within 1e-9 in relative L2 norm over
    the model and the running statistics within 1e-9 of their largest
    magnitude; in fp32 both no further from one rank's fp64 step than
    twice one rank's own fp32 step is (a random-init ResNet-50's fp32
    gradients are a few percent off its fp64 ones, in layer4 most, so
    a fixed fp32 bound would measure the model, not the ranks)."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.nn import ranks
    t0 = time.perf_counter()
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(RESNET_BATCH, RESNET_SIZE, RESNET_SIZE,
                                  3).astype(np.float32)).cuda()
    y = torch.from_numpy(rs.randint(0, 1000, (RESNET_BATCH,))).cuda()
    try:
        mesh = parallel.init_mesh(dp=DP_RANKS, device="cuda")
        tr = resnet50_dp_trainer(torch, P, parallel, mesh, "O2")
        xb = x.to(torch.bfloat16)
        t1 = time.perf_counter()
        _, warm = tr.train_steps(xb, y, steps=DP_WARM)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t1
        torch.cuda.reset_peak_memory_stats()
        ranks.reset_counts()
        t1 = time.perf_counter()
        _, timed = tr.train_steps(xb, y, steps=DP_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated()
        per_step = {k: v / DP_STEPS for k, v in ranks.counts().items()
                    if v}
        losses = warm.float().cpu().tolist() + timed.float().cpu().tolist()
        check(all(math.isfinite(v) for v in losses), f"DP ResNet-50: "
                                                     f"{losses}")
        check(min(losses[1:]) < losses[0], f"DP ResNet-50 loss never fell "
                                           f"below its first: {losses}")
        n_bn = sum(isinstance(m, P.nn.layers_norm._BatchNormBase)
                   for m in tr.model.modules())
        n_par = len(tr.state.params)
        check(per_step.get("all_reduce") == n_bn + 1 + n_par,
              f"all-reduces per step {per_step} != {n_bn} batch norms + 1 "
              f"count + {n_par} gradients")
        step_ms = wall / DP_STEPS * 1e3
        ips = RESNET_BATCH * DP_STEPS / wall
        log(f"  DP ResNet-50 O2 bf16, {DP_RANKS} ranks x "
            f"{RESNET_BATCH // DP_RANKS} images, synced batch norm "
            f"[{card}]: {DP_WARM} warm-up steps {warm_s:.2f} s; "
            f"{step_ms:.2f} ms per step, {ips:.1f} images/s, peak memory "
            f"{peak / 2**30:.2f} GiB; collectives per step {per_step}; "
            f"losses {[round(v, 4) for v in losses]}")
        del tr, xb
        torch.cuda.empty_cache()
        res = {"losses": losses, "step_ms": step_ms, "images_per_s": ips,
               "peak_bytes": peak, "warmup_s": warm_s,
               "collectives_per_step": per_step, "batch_norms": n_bn}
        # one step of 4 ranks vs one rank, same weights and batch, in
        # fp64 (the ranks' arithmetic alone) and fp32 (against fp32's
        # own distance from fp64)
        xs, ys = x[:RESNET_CHECK_BATCH], y[:RESNET_CHECK_BATCH]
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        runs = {}
        try:
            with tf32_off(torch):
                for tname in ("float64", "float32"):
                    for m in (None, mesh):
                        runs[tname, m is not None] = resnet50_one_step(
                            torch, P, parallel, m, getattr(torch, tname),
                            xs, ys)
        finally:
            torch.backends.cudnn.deterministic = det
        ref = runs["float64", False]
        err = {key: (grad_rel_l2(g, ref[0]), max(
            rel_err(b[k], ref[1][k]) for k in ref[1]))
            for key, (g, b) in runs.items()}
        mesh64, mesh32, one32 = (err["float64", True], err["float32", True],
                                 err["float32", False])
        check(mesh64[0] <= 1e-9 and mesh64[1] <= 1e-9,
              f"fp64: 4 ranks vs one rank {mesh64}")
        check(mesh32[0] <= 2 * one32[0] and mesh32[1] <= 2 * one32[1],
              f"fp32 4 ranks {mesh32} vs one rank's own fp32 error {one32}")
        log(f"  one step at {RESNET_CHECK_BATCH} x {RESNET_SIZE}^2, "
            f"{DP_RANKS} ranks vs one rank's whole batch (TF32 off, cuDNN "
            f"deterministic): fp64 gradients {mesh64[0]:.2e} relative L2, "
            f"running statistics {mesh64[1]:.2e} of their largest "
            f"magnitude; fp32 against fp64's one rank: 4 ranks "
            f"{mesh32[0]:.2e} / {mesh32[1]:.2e}, one rank {one32[0]:.2e} / "
            f"{one32[1]:.2e}")
        res.update(check_batch=RESNET_CHECK_BATCH, fp64_vs_one=mesh64,
                   fp32_mesh_vs_fp64=mesh32, fp32_one_vs_fp64=one32,
                   seconds=time.perf_counter() - t0)
        return res
    finally:
        torch.backends.cudnn.benchmark = prev
        parallel.set_mesh(None)


RESNET_CHECK_BATCH = 64     # 6r's one-step comparison (fp64 fits twice)


def grad_rel_l2(g, ref) -> float:
    num = sum(float((g[k].double() - ref[k].double()).square().sum())
              for k in ref)
    den = sum(float(ref[k].double().square().sum()) for k in ref)
    return math.sqrt(num / den)


def resnet50_one_step(torch, P, parallel, mesh, dtype, x, y):
    """(gradients, running statistics) of one Momentum step at lr 1 (the
    first step moves by the gradient) of ResNet-50 in `dtype`, on one
    rank or over `mesh` (through DataParallel); names without the
    wrapper's prefix."""
    t = resnet50_dp_trainer(torch, P, parallel, mesh, None, lr=1.0)
    t.model.to(dtype)
    t.init_state()
    p0 = {k: v.detach().clone() for k, v in t.state.params.items()}
    t.train_step(x.to(dtype), y)
    st = t.gathered_state()
    out = ({k.removeprefix("_layers."): p0[k] - st.params[k].detach()
            for k in p0},
           {k.removeprefix("_layers."): v.clone()
            for k, v in st.buffers.items()})
    del t, st, p0
    torch.cuda.empty_cache()
    return out


def p1b_step_flops(cfg, tokens: int, seq: int) -> float:
    """6 N per token for the weights' GEMMs (N counting the tied head
    once) plus the causal attention's 2 x 2 x d x pairs products x 3
    (forward and the two backward ones)."""
    n = sum(math.prod(s) for k, s in P1B_SHAPES(cfg).items()
            if not k.endswith(("bias",)) and "ln" not in k
            and k != "wpe.weight")
    pairs = seq * (seq + 1) / 2
    attn = 3 * 2 * 2 * cfg.head_dim * pairs * cfg.num_heads * \
        cfg.num_layers * (tokens / seq)
    return 6 * n * tokens + attn


def P1B_SHAPES(cfg):
    from paddle_tpu_torch.models.gpt import param_shapes
    return param_shapes(cfg)


def phase_p1b(torch, np, P, card: str):
    """(6s) config 5, "Fleet sharding stage2 + GPT-3 1.3B pretrain":
    `gpt_1p3b` at O2 bf16 with AdamW, built through `fleet.init` /
    `distributed_model` / `distributed_trainer` (sharding, stage 2,
    sharding_degree 4), global batch 8 x 2048 over 4 ranks: the loss
    finite and falling over the steps, K2/K3 each launched 24 layers x
    4 ranks = 96 times a step (read from their counters), each rank's
    optimizer-state bytes, step ms, tokens/s and peak memory."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.nn import ranks
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import fleet
    from paddle_tpu_torch.parallel.sharding import rank_bytes
    t0 = time.perf_counter()
    s = parallel.DistributedStrategy(
        sharding=True, sharding_configs={"stage": P1B["stage"]},
        hybrid_configs={"sharding_degree": P1B["ranks"]}, amp=True,
        amp_configs={"level": "O2", "dtype": "bfloat16"})
    mesh = fleet.init(strategy=s, world_size=P1B["ranks"], device="cuda")
    try:
        model = fleet.distributed_model(P.models.gpt_1p3b(seed=0,
                                                          device="cuda"))
        cfg = model.cfg
        check((cfg.hidden_size, cfg.num_layers, cfg.num_heads,
               cfg.max_seq_len) == (2048, 24, 16, 2048), f"not 1.3B: {cfg}")
        n_params = sum(p.numel() for p in model.parameters())
        tr = fleet.distributed_trainer(
            model, fleet.distributed_optimizer(AdamW(learning_rate=P1B_LR)),
            lambda lg, y: model.loss(lg, y))
        ids = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (P1B["b"], P1B["s"]))).cuda()
        build_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        warm, _ = tr.train_step(ids, ids)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t1
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counters(fa)
        ranks.reset_counts()
        t1 = time.perf_counter()
        _, timed = tr.train_steps(ids, ids, steps=P1B_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated()
        fwd, bwd = fa.FWD_LAUNCHES.count, fa.BWD_LAUNCHES.count
        check((fa.WGMMA_FWD_LAUNCHES.count, fa.WGMMA_BWD_LAUNCHES.count)
              == (fwd, bwd), "1.3B training left the wgmma route")
        want = cfg.num_layers * P1B["ranks"] * P1B_STEPS
        check(fwd == want and bwd == want,
              f"K2/K3 launches {fwd}/{bwd} != {cfg.num_layers} layers x "
              f"{P1B['ranks']} ranks x {P1B_STEPS} steps")
        losses = [float(warm)] + timed.float().cpu().tolist()
        check(all(math.isfinite(v) for v in losses), f"1.3B: {losses}")
        check(losses[-1] < losses[0] and losses[-1] < losses[1],
              f"1.3B loss did not fall: {losses}")
        per = rank_bytes(tr.state, mesh)
        total = sum(p["slots"] for p in per)      # the ranks' slices
        counts = {k: v / P1B_STEPS for k, v in ranks.counts().items() if v}
        tokens = P1B["b"] * P1B["s"]
        step_ms = wall / P1B_STEPS * 1e3
        flops = p1b_step_flops(cfg, tokens, P1B["s"])
        log(f"  gpt_1p3b ({n_params / 1e9:.3f} B parameters) O2 bf16, "
            f"AdamW, ZeRO stage {P1B['stage']} over {P1B['ranks']} ranks, "
            f"global batch {P1B['b']} x {P1B['s']} [{card}]: built in "
            f"{build_s:.1f} s, warm-up step {warm_s:.2f} s, then "
            f"{step_ms:.1f} ms per step, {tokens * P1B_STEPS / wall:.0f} "
            f"tokens/s, peak memory {peak / 2**30:.2f} GiB; losses "
            f"{[round(v, 4) for v in losses]}")
        log(f"  K2 launches {fwd}, K3 launches {bwd} = {cfg.num_layers} "
            f"layers x {P1B['ranks']} ranks x {P1B_STEPS} steps; "
            f"collectives per step {counts}; per-rank optimizer state "
            f"{[p['slots'] for p in per]} B ({total / 2**30:.2f} GiB in "
            f"all), per-rank parameters {per[0]['params']} B; step "
            f"model FLOPs {flops / 1e12:.1f} T "
            f"({flops / step_ms / 1e9:.0f} TFLOP/s)")
        res = {"losses": losses, "step_ms": step_ms,
               "tokens_per_s": tokens * P1B_STEPS / wall,
               "peak_bytes": peak, "warmup_s": warm_s, "build_s": build_s,
               "fwd_launches": fwd, "bwd_launches": bwd,
               "launches_per_step": fwd // P1B_STEPS,
               "rank_bytes": per, "collectives_per_step": counts,
               "n_params": n_params, "step_flops": flops,
               "seconds": time.perf_counter() - t0}
        del tr, model, ids
        torch.cuda.empty_cache()
        return res
    finally:
        parallel.set_mesh(None)


# --------------------------------------------------------------------------- #
# phases 6t-6w: model-parallel training on the one card
# --------------------------------------------------------------------------- #

TP_BATCH = dict(b=4, s=1024)          # 6t: GPT-small fp32, dp 2 x tp 2
MP_P1B = dict(b=8, s=2048, dp=2, tp=2)   # 6t: gpt_1p3b, 3 steps
MP_P1B_STEPS = 3
SP_SMALL = dict(b=2, s=4096, sp=4)    # 6u: GPT-small width, fp32
SP_P1B = dict(b=2, s=2048, sp=4)      # 6u: gpt_1p3b, ring and Ulysses
SP_P1B_STEPS = 2
PP_STACK = dict(layers=12, pp=4, micro=8, b=8, s=1024)   # 6v
MOE = dict(d_model=768, d_hidden=3072, experts=8, top_k=2, b=8, s=1024,
           ep=4, capacity_factor=2.0)                    # 6w


def one_step_grads(torch, P, model_fn, mesh, ids, grad_accum=1):
    """(loss, {name: the parameter's gradient}) of one Momentum step of
    `model_fn()` on `ids`, under `mesh` (one rank when None); fp32,
    TF32 off. The first step's velocity is the gradient itself (the
    move p1 - p0 would round it to the ulps of p: a layer norm weight
    of 1 moves by ~1e-5, a few ulps)."""
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.optimizer import Momentum
    model = model_fn()
    tr = Trainer(model, Momentum(1e-2, 0.9), lambda lg, y: model.loss(lg, y),
                 mesh=mesh, grad_accum=grad_accum)
    loss = float(tr.train_step(ids, ids)[0])
    st = tr.gathered_state()
    grads = {k: s["velocity"].detach().clone()
             for k, s in st.opt_state["slots"].items()}
    del tr, model, st
    torch.cuda.empty_cache()
    return loss, grads


def grad_l2(a, b):
    """{name: ||a - b|| / ||b||} over b's parameters."""
    return {k: float((a[k] - w).norm() / w.norm().clamp_min(1e-30))
            for k, w in b.items()}


def hold_grads(loss, grads, one_loss, one_grads, what):
    """The loss within 1e-5 relative of one rank's, and each
    parameter's gradient within 1e-3 in relative L2 (6q's bar for the
    moves) of one rank's."""
    l2 = grad_l2(grads, one_grads)
    top = sorted(l2.items(), key=lambda kv: -kv[1])[:3]
    log(f"  {what}: the three furthest gradients (relative L2) " + ", ".join(
        f"{k} {v:.2e}" for k, v in top))
    check(abs(loss - one_loss) <= 1e-5 * abs(one_loss),
          f"{what}: loss {loss} vs one rank {one_loss}")
    check(top[0][1] <= 1e-3,
          f"{what}: {top[0][0]}'s gradient is {top[0][1]:.2e} off in "
          f"relative L2 (bar 1e-3)")
    return {"loss": loss, "one_rank_loss": one_loss,
            "grad_rel_l2": top[0][1], "worst_param": top[0][0]}


def timed_mp_steps(torch, np, fa, tr, ids, steps: int):
    """A warm-up step, then `steps` timed steps with the flash and
    collective counters zeroed just before and read just after:
    (losses, step ms, peak bytes, K2 launches, K3 launches,
    collectives per step, {"causal": (K2, K3), "full": (K2, K3)}
    launches by the causal flag)."""
    from paddle_tpu_torch.nn import ranks
    warm, _ = tr.train_step(ids, ids)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counters(fa)
    ranks.reset_counts()
    t1 = time.perf_counter()
    _, timed = tr.train_steps(ids, ids, steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    losses = [float(warm)] + timed.float().cpu().tolist()
    counts = {k: v / steps for k, v in ranks.counts().items() if v}
    by_flag = {("causal" if c else "full"): (f.count, b.count)
               for c, (f, b) in fa.CAUSAL_COUNTERS.items()}
    return (losses, wall / steps * 1e3, torch.cuda.max_memory_allocated(),
            fa.FWD_LAUNCHES.count, fa.BWD_LAUNCHES.count, counts, by_flag)


def run_mp_p1b(torch, np, P, fa, model, mesh, ids, steps):
    """`timed_mp_steps` of gpt_1p3b under `mesh` (O2 bf16, AdamW, no
    remat)."""
    import gc
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.optimizer import AdamW
    tr = Trainer(model, AdamW(learning_rate=P1B_LR),
                 lambda lg, y: model.loss(lg, y), mesh=mesh,
                 amp_level="O2", amp_dtype="bfloat16")
    res = timed_mp_steps(torch, np, fa, tr, ids, steps)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return res


def check_falling(losses, what):
    check(all(math.isfinite(v) for v in losses), f"{what}: {losses}")
    check(losses[-1] < losses[0], f"{what}: the loss did not fall: "
                                  f"{losses}")


def phase_tp_train(torch, np, P, card: str):
    """(6t) tensor parallelism. GPT-small fp32 (TF32 off, the tf32x3
    route) at full width, 4 x 1024 ids, one Momentum step under dp 2 x
    tp 2 against one rank's whole-batch step (`hold_grads`: the loss
    within 1e-5 relative, each gradient within 1e-3 relative L2). Then
    gpt_1p3b at O2 bf16 (AdamW) on 8 x 2048 ids under dp 2 x tp 2: a
    warm-up and 3 timed steps, finite and falling; each rank runs 8 of
    the 16 heads through K2/K3, so each is launched 24 layers x 4
    ranks = 96 times a step (read from their counters); step ms,
    tokens/s, peak memory, collectives a step."""
    import gc
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    b, s_ = TP_BATCH["b"], TP_BATCH["s"]
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 50304, (b, s_))).cuda()
    with tf32_off(torch):
        def small():
            return P.models.gpt_small(seed=0, device="cuda")
        one = one_step_grads(torch, P, small, None, ids)
        mesh = parallel.init_mesh(dp=2, tp=2, device="cuda")
        got = one_step_grads(torch, P, small, mesh, ids)
        parallel.set_mesh(None)
    res = {"small": hold_grads(*got, *one, "6t dp 2 x tp 2")}
    log(f"  GPT-small fp32 (TF32 off), {b} x {s_}, dp 2 x tp 2 against one "
        f"rank: loss {got[0]:.6f} (one rank {one[0]:.6f}); worst gradient "
        f"{res['small']['grad_rel_l2']:.2e} relative L2 "
        f"({res['small']['worst_param']})")
    t1 = time.perf_counter()
    model = P.models.gpt_1p3b(seed=0, device="cuda")
    cfg = model.cfg
    res["p1b_build_s"] = time.perf_counter() - t1
    mesh = parallel.init_mesh(dp=MP_P1B["dp"], tp=MP_P1B["tp"],
                              device="cuda")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (MP_P1B["b"], MP_P1B["s"]))).cuda()
    try:
        losses, step_ms, peak, fwd, bwd, counts, by_flag = run_mp_p1b(
            torch, np, P, fa, model, mesh, ids, MP_P1B_STEPS)
    finally:
        parallel.set_mesh(None)
    check_falling(losses, "6t gpt_1p3b dp 2 x tp 2")
    n_ranks = MP_P1B["dp"] * MP_P1B["tp"]
    want = cfg.num_layers * n_ranks * MP_P1B_STEPS
    check(fwd == want and bwd == want and by_flag["causal"] == (want, want),
          f"6t: K2/K3 launches {fwd}/{bwd} ({by_flag}) != "
          f"{cfg.num_layers} layers x {n_ranks} ranks x {MP_P1B_STEPS} "
          f"steps, all causal")
    tokens = MP_P1B["b"] * MP_P1B["s"]
    log(f"  gpt_1p3b O2 bf16, AdamW, dp 2 x tp 2 (8 of 16 heads a rank), "
        f"{MP_P1B['b']} x {MP_P1B['s']} [{card}]: {step_ms:.1f} ms per "
        f"step, {tokens / step_ms * 1e3:.0f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB; losses "
        f"{[round(v, 4) for v in losses]}; K2 {fwd}, K3 {bwd} launches = "
        f"{cfg.num_layers} layers x {n_ranks} ranks x {MP_P1B_STEPS} "
        f"steps; collectives per step {counts}")
    res.update({"losses": losses, "step_ms": step_ms,
                "tokens_per_s": tokens / step_ms * 1e3, "peak_bytes": peak,
                "fwd_launches": fwd, "bwd_launches": bwd,
                "launches_per_step": fwd // MP_P1B_STEPS,
                "collectives_per_step": counts,
                "seconds": time.perf_counter() - t0})
    return res, model


def phase_sp_train(torch, np, P, card: str, model):
    """(6u) sequence parallelism. GPT-small's width at seq 4096 (fp32,
    TF32 off), 2 x 4096 ids, one Momentum step at sp 4, ring and
    Ulysses each, against sp 1's (`hold_grads`, as 6t). Then
    gpt_1p3b (6t's model) at O2 bf16 on 2 x 2048 ids at sp 4, ring and
    Ulysses: a warm-up and 2 timed steps each, finite and falling.
    Ring: per layer and step rank i runs K2 and K3 on i + 1 chunk
    pairs (the diagonal causal, the others full: 4 causal and 6 full
    pairs over 4 ranks) and receives k and v over 3 ppermute hops each
    (6 a layer, 144 a step); Ulysses: each rank runs K2/K3 once,
    causal, on its 4 heads over the whole sequence, between 4
    all_to_alls a layer. Launches (causal and full apart) and
    collectives read from their counters."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    t0 = time.perf_counter()
    sp = SP_SMALL["sp"]
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, 50304, (SP_SMALL["b"], SP_SMALL["s"]))).cuda()
    res = {}
    with tf32_off(torch):
        def small(mode):
            return lambda: P.models.gpt_small(
                seed=0, device="cuda", max_seq_len=SP_SMALL["s"],
                sequence_parallel=mode)
        one = one_step_grads(torch, P, small("none"), None, ids)
        for mode in ("ring", "ulysses"):
            mesh = parallel.init_mesh(sp=sp, device="cuda")
            got = one_step_grads(torch, P, small(mode), mesh, ids)
            parallel.set_mesh(None)
            res[f"small_{mode}"] = hold_grads(*got, *one, f"6u {mode}")
            log(f"  GPT-small width fp32, {SP_SMALL['b']} x {SP_SMALL['s']},"
                f" {mode} at sp {sp} against sp 1: loss {got[0]:.6f} (sp 1 "
                f"{one[0]:.6f}); worst gradient "
                f"{res[f'small_{mode}']['grad_rel_l2']:.2e} relative L2")
    cfg = model.cfg
    ids = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (SP_P1B["b"], SP_P1B["s"]))).cuda()
    layers = cfg.num_layers
    # a step's (causal, full) launches of each of K2 and K3, and its
    # collectives, as the schedules give them
    want = {"ring": ((layers * sp, layers * sp * (sp - 1) // 2),
                     {"ppermute": 2 * (sp - 1) * layers}),
            "ulysses": ((layers * sp, 0), {"all_to_all": 4 * layers})}
    try:
        for mode in ("ring", "ulysses"):
            cfg.sequence_parallel = mode
            mesh = parallel.init_mesh(sp=sp, device="cuda")
            losses, step_ms, peak, fwd, bwd, counts, by_flag = run_mp_p1b(
                torch, np, P, fa, model, mesh, ids, SP_P1B_STEPS)
            parallel.set_mesh(None)
            check_falling(losses, f"6u gpt_1p3b {mode}")
            (n_causal, n_full), coll = want[mode]
            n = n_causal + n_full
            for flag, k in (("causal", n_causal), ("full", n_full)):
                check(by_flag[flag] == (k * SP_P1B_STEPS,) * 2,
                      f"6u {mode}: {flag} K2/K3 launches {by_flag[flag]} "
                      f"!= {k} a step")
            check(fwd == n * SP_P1B_STEPS and bwd == n * SP_P1B_STEPS,
                  f"6u {mode}: K2/K3 launches {fwd}/{bwd} != {n} a step")
            for name, c in coll.items():
                check(counts.get(name) == c, f"6u {mode}: {name} "
                                             f"{counts.get(name)} != {c}")
            tokens = SP_P1B["b"] * SP_P1B["s"]
            log(f"  gpt_1p3b O2 bf16, {mode} at sp {sp}, {SP_P1B['b']} x "
                f"{SP_P1B['s']} [{card}]: {step_ms:.1f} ms per step, "
                f"{tokens / step_ms * 1e3:.0f} tokens/s, peak memory "
                f"{peak / 2**30:.2f} GiB; "
                f"losses {[round(v, 4) for v in losses]}; K2 {fwd}, K3 "
                f"{bwd} launches ({n} a step; causal {by_flag['causal']}, "
                f"full {by_flag['full']}); collectives per step {counts}")
            res[mode] = {"losses": losses, "step_ms": step_ms,
                         "tokens_per_s": tokens / step_ms * 1e3,
                         "peak_bytes": peak,
                         "fwd_launches": fwd, "bwd_launches": bwd,
                         "causal_launches": by_flag["causal"],
                         "full_launches": by_flag["full"],
                         "launches_per_step": n,
                         "collectives_per_step": counts}
    finally:
        cfg.sequence_parallel = "none"
        parallel.set_mesh(None)
    res["seconds"] = time.perf_counter() - t0
    return res


def phase_pp_train(torch, np, P, card: str):
    """(6v) pipeline parallelism: a `PipelineStack` of 12 GPT-small-width
    `GPTBlock`s (fp32, TF32 off) on 8 x 1024 x 768 activations at pp 4
    with 8 microbatches, at v 1 and v 3 (interleaved): the loss
    sum(out * r), r a fixed random tensor, within 1e-5 relative and
    every parameter's gradient within 1e-4 in relative L2 of the
    sequential stack's; one ppermute per tick, `_num_ticks` of them."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.models.gpt import GPTBlock, GPTConfig
    from paddle_tpu_torch.nn import ranks
    from paddle_tpu_torch.parallel import pipeline as pp
    t0 = time.perf_counter()
    c = PP_STACK
    cfg = GPTConfig(num_layers=c["layers"])
    gen = torch.Generator().manual_seed(0)
    res = {}
    with tf32_off(torch):
        rs = np.random.RandomState(3)
        x = torch.from_numpy(rs.randn(c["b"], c["s"], cfg.hidden_size)
                             .astype(np.float32)).cuda()
        r = torch.from_numpy(rs.randn(c["b"], c["s"], cfg.hidden_size)
                             .astype(np.float32)).cuda()
        for v in (1, 3):
            stack = pp.PipelineStack(lambda i: GPTBlock(cfg, gen),
                                     c["layers"], num_micro=c["micro"],
                                     virtual_degree=v).cuda()
            params = [p for n, p in stack.named_parameters()
                      if not n.startswith("_template")]
            want = (stack(x) * r).sum()
            g_want = torch.autograd.grad(want, params)
            mesh = parallel.init_mesh(pp=c["pp"], device="cuda")
            ranks.reset_counts()
            got = (stack.pipeline_forward(x, mesh=mesh) * r).sum()
            ticks = ranks.counts()["ppermute"]
            g_got = torch.autograd.grad(got, params)
            parallel.set_mesh(None)
            rel = max(float((a - b_).norm() / b_.norm().clamp_min(1e-30))
                      for a, b_ in zip(g_got, g_want))
            want_ticks = pp._num_ticks(c["micro"], c["pp"], v)
            check(abs(float(got) - float(want)) <= 1e-5 * abs(float(want)),
                  f"6v v {v}: loss {float(got)} vs {float(want)}")
            check(rel <= 1e-4, f"6v v {v}: a gradient is {rel:.2e} off")
            check(ticks == want_ticks, f"6v v {v}: {ticks} ticks != "
                                       f"{want_ticks}")
            log(f"  12 GPT-small blocks, pp {c['pp']}, {c['micro']} "
                f"microbatches, v {v}: loss {float(got):.6f} (sequential "
                f"{float(want):.6f}), worst gradient {rel:.2e} relative L2,"
                f" {ticks} ticks = _num_ticks (bubble "
                f"{pp.bubble_fraction(c['micro'], c['pp'], v):.3f})")
            res[f"v{v}"] = {"loss": float(got), "sequential": float(want),
                            "grad_rel_l2": rel, "ticks": ticks}
            del stack, params, g_want, g_got, got, want
            torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    return res


def phase_moe_train(torch, np, P, card: str):
    """(6w) expert parallelism: `MoELayer` (d_model 768, d_hidden 3072, 8
    experts, top-2, capacity factor 2: no token dropped, checked) over
    8 x 1024 tokens, fp32 (TF32 off): ep 4 against the dense route,
    the output within 1e-5 of its largest magnitude and the aux loss
    within 1e-5 relative; then one timed O2 bf16 training step
    (AdamW; the loss mse to a target plus 0.01 x the aux loss) at ep
    4 after a warm-up."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.nn import ranks
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.moe import MoELayer
    t0 = time.perf_counter()
    c = MOE
    gen = torch.Generator().manual_seed(0)
    layer = MoELayer(c["d_model"], c["d_hidden"], c["experts"],
                     top_k=c["top_k"], capacity_factor=c["capacity_factor"],
                     gen=gen).cuda()
    layer.gate.noise_std = 0.0
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(c["b"], c["s"], c["d_model"]).astype(
        np.float32)).cuda()
    res = {}
    with tf32_off(torch), torch.no_grad():
        flat = x.reshape(-1, c["d_model"])
        per_rank = flat.shape[0] // c["ep"]
        for tokens, name in ((flat, "dense"),
                             (flat[:per_rank], "an ep rank")):
            disp, _, _ = layer.gate(tokens)
            kept = int(disp.sum())
            check(kept == tokens.shape[0] * c["top_k"],
                  f"6w: {name}'s gate drops {tokens.shape[0] * c['top_k'] - kept}"
                  f" token slots")
            del disp
        dense = layer(x)
        dense_aux = float(layer.aux_loss)
        mesh = parallel.init_mesh(ep=c["ep"], device="cuda")
        ranks.reset_counts()
        ep = layer(x)
        counts = ranks.counts()
        parallel.set_mesh(None)
        err = float((ep - dense).abs().max() / dense.abs().max())
        check(err <= 1e-5, f"6w: ep {c['ep']} vs dense {err:.2e}")
        ep_aux = float(layer.aux_loss)
    log(f"  MoE {c['experts']} experts top-{c['top_k']}, {c['b']} x "
        f"{c['s']} tokens, fp32: ep {c['ep']} against dense {err:.2e} of "
        f"max|out|; aux {ep_aux:.6f} (mean over the ep ranks; dense "
        f"{dense_aux:.6f}); collectives {dict((k, v) for k, v in counts.items() if v)}")
    res["ep_vs_dense"] = err
    res["collectives"] = counts
    del dense, ep

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.moe = layer

        def forward(self, h):
            return self.moe(h)

    net = Net()
    target = torch.from_numpy(rs.randn(*x.shape).astype(np.float32)).cuda()
    mesh = parallel.init_mesh(ep=c["ep"], device="cuda")
    try:
        tr = Trainer(net, AdamW(1e-4), lambda o, y: ((o.float() - y) ** 2)
                     .mean() + 0.01 * net.moe.aux_loss, mesh=mesh,
                     amp_level="O2", amp_dtype="bfloat16")
        l0 = float(tr.train_step(x, target)[0])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        l1 = float(tr.train_step(x, target)[0])
        step_ms = (time.perf_counter() - t1) * 1e3
    finally:
        parallel.set_mesh(None)
    check(math.isfinite(l0) and math.isfinite(l1), f"6w: {l0}, {l1}")
    log(f"  MoE O2 bf16 training step at ep {c['ep']} [{card}]: "
        f"{step_ms:.1f} ms (after a warm-up); losses {l0:.5f}, {l1:.5f}")
    res.update({"step_ms": step_ms, "losses": [l0, l1],
                "seconds": time.perf_counter() - t0})
    del tr, net, layer
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------- #
# phases 6x-6z, 9a-9b: the rest of parallel/ (compression, LocalSGD,
# multislice, auto; several processes on the one card)
# --------------------------------------------------------------------------- #

COMP_STEPS = 3                        # 6x: compressed_grad_step, dp 2
COMP_LOSS_TOL = 1e-2                  # 6x: relative, against exact dp
LSGD = dict(k=4, rounds=2)            # 6y: LocalSGD, dp 2
GANG_STEPS = 3                        # 9a: one checked + two timed steps
ELASTIC = dict(layers=2, steps=5, die_at=3)   # 9b: GPT-small width
GANG_TIMEOUT_S = 240                  # 9a / 9b: the whole gang's limit



def functional_loss(torch, model):
    def loss_fn(p, b):
        return model.loss(torch.func.functional_call(model, p, (b[0],)),
                          b[1])
    return loss_fn


def mesh_ids(torch, np, vocab):
    return torch.from_numpy(np.random.RandomState(0).randint(
        0, vocab, (MESH_BATCH["b"], MESH_BATCH["s"]))).cuda()


def plain_compressed(torch, np, locs, n):
    """The compression's formula over the ranks' fp32 locals of one
    tensor, written out: (mean, [residuals])."""
    m = locs[0].abs().max()
    for x in locs[1:]:
        m = torch.maximum(m, x.abs().max())
    qmax = float(math.floor(127.0 / n))
    scale = torch.where(m > 0, m * float(np.float32(1.0 / qmax)),
                        torch.ones_like(m))
    qs = [torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
          for x in locs]
    total = qs[0]
    for q in qs[1:]:
        total = total + q
    mean = total.to(torch.float32) * scale * float(np.float32(1.0 / n))
    return mean, [(x.double() - q.double() * scale.double()).float()
                  for x, q in zip(locs, qs)]


def phase_compressed(torch, np, P, card: str, fa):
    """(6x) `compressed_grad_step` on GPT-small (fp32, TF32 off: the
    tf32x3 route) over dp 2 at MESH_BATCH, Momentum(1e-2, 0.9), for
    COMP_STEPS steps. Per step, every tensor's mean and both ranks'
    new residuals equal the formula over the ranks' fp32 locals
    (gradient + residual, recorded where they are quantized), bitwise;
    the losses within COMP_LOSS_TOL relative of exact dp
    (`Trainer(mesh=)` dp 2, the same steps); the wire counter shows
    the codes as int8 (2 ranks x parameters x steps) and fp32 only as
    scalars (one max per tensor and rank, and the losses); K2/K3
    launched 2 ranks x 12 layers a step."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.nn import ranks
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.parallel import compression as comp
    t0 = time.perf_counter()
    with tf32_off(torch):
        model = P.models.gpt_small(seed=0, device="cuda")
        ids = mesh_ids(torch, np, model.cfg.vocab_size)
        params = {k: v.detach().clone() for k, v in
                  model.named_parameters()}
        names = list(params)
        opt = Momentum(1e-2, 0.9)
        state = opt.init(params)
        mesh = parallel.init_mesh(dp=2, device="cuda")
        res = comp.zero_residuals(params, mesh, "dp")
        seen, means = [], []
        codes, update = comp._codes, opt.update

        def record(x, scale, qmax):
            seen.append(x.clone())
            return codes(x, scale, qmax)

        def keep_grads(grads, st, ps):
            means.append({k: g.clone() for k, g in grads.items()})
            return update(grads, st, ps)

        losses = []
        reset_flash_counters(fa)
        ranks.reset_counts()
        comp._codes, opt.update = record, keep_grads
        try:
            for step in range(COMP_STEPS):
                params, state, res, loss = comp.compressed_grad_step(
                    functional_loss(torch, model), opt, params, state, res,
                    (ids, ids), mesh=mesh, axis="dp")
                losses.append(float(loss))
                launches = (fa.FWD_LAUNCHES.count, fa.BWD_LAUNCHES.count)
                wire = ranks.wire()
                # the locals were quantized rank-major: rank i, tensor j
                for j, k in enumerate(names):
                    mean, rs = plain_compressed(
                        torch, np, [seen[i * len(names) + j]
                                    for i in range(2)], 2)
                    check(torch.equal(means[-1][k], mean),
                          f"6x step {step}: {k}'s mean != the formula")
                    for i in range(2):
                        check(torch.equal(res[k][i], rs[i]),
                              f"6x step {step}: {k} rank {i}'s residual "
                              f"!= the formula")
                seen.clear()
                means.clear()
        finally:
            comp._codes = codes
        del params, state, res
        torch.cuda.empty_cache()
        exact = Trainer(model, Momentum(1e-2, 0.9),
                        lambda lg, y: model.loss(lg, y),
                        mesh=parallel.init_mesh(dp=2, device="cuda"))
        exact_losses = [float(exact.train_step(ids, ids)[0])
                        for _ in range(COMP_STEPS)]
        del exact
    parallel.set_mesh(None)
    want = 2 * model.cfg.num_layers * COMP_STEPS
    numel = sum(p.numel() for p in model.parameters())
    check(launches == (want, want), f"6x: K2/K3 launches {launches}, "
                                    f"expected {want} each")
    check(wire.get("int8") == 2 * numel * COMP_STEPS,
          f"6x: int8 bytes {wire.get('int8')} vs {2 * numel * COMP_STEPS}")
    n_scalars = 2 * (len(names) + 1) * COMP_STEPS
    check(wire.get("float32") == 4 * n_scalars,
          f"6x: fp32 bytes {wire.get('float32')} vs {4 * n_scalars}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, exact_losses))
    check(all(math.isfinite(v) for v in losses) and rel <= COMP_LOSS_TOL,
          f"6x: losses {losses} vs exact dp {exact_losses}")
    del model
    torch.cuda.empty_cache()
    out = {"losses": losses, "exact_dp_losses": exact_losses,
           "worst_rel_loss": rel, "launches": launches, "wire": wire,
           "seconds": time.perf_counter() - t0}
    log(f"  [{card}] 6x: {COMP_STEPS} steps, every mean and residual == "
        f"the formula bitwise; losses {losses} vs exact dp {exact_losses} "
        f"(worst {rel:.2e} relative, limit {COMP_LOSS_TOL}); wire bytes "
        f"{wire}; K2/K3 {launches}")
    log(f"  phase 6x took {out['seconds']:.1f} s")
    return out


def phase_localsgd(torch, np, P, card: str, fa):
    """(6y) `LocalSGD` on GPT-small (fp32, TF32 off) over dp 2, k
    LSGD["k"], AdamW(1e-4), LSGD["rounds"] rounds at MESH_BATCH: each
    round one exchange (one fp32 all_reduce of every parameter, slot
    and loss); after it the state is the mean of the two ranks'
    buffers (recorded at the exchange) bitwise, one tensor for both
    ranks; the step counter counts k a round; K2/K3 launched 2 ranks x
    k x 12 layers a round."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.nn import ranks
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import localsgd
    t0 = time.perf_counter()
    k, rounds = LSGD["k"], LSGD["rounds"]
    with tf32_off(torch):
        model = P.models.gpt_small(seed=0, device="cuda")
        ids = mesh_ids(torch, np, model.cfg.vocab_size)
        params = {n: v.detach().clone() for n, v in
                  model.named_parameters()}
        opt = AdamW(1e-4)
        state = opt.init(params)
        lsgd = localsgd.LocalSGD(functional_loss(torch, model), opt,
                                 k_steps=k,
                                 mesh=parallel.init_mesh(dp=2,
                                                         device="cuda"))
        exchanged = []
        parts = localsgd.global_parts

        def record(bufs):
            out = parts(bufs)
            exchanged.append([b[0] for b in out])
            return out

        reset_flash_counters(fa)
        all_losses, per_round = [], []
        localsgd.global_parts = record
        try:
            for r in range(rounds):
                ranks.reset_counts()
                exchanged.clear()
                params, state, losses = lsgd.round(params, state,
                                                   (ids, ids))
                per_round.append(ranks.counts()["all_reduce"])
                all_losses.append(losses.cpu().tolist())
                b0, b1 = exchanged[0]
                mean = (b0 + b1) / 2
                flat = torch.cat([t.reshape(-1) for t in
                                  list(params.values()) + [
                                      s for sl in state["slots"].values()
                                      for s in sl.values()]] + [losses])
                check(torch.equal(flat, mean),
                      f"6y round {r}: the state != the ranks' mean")
                check(state["step"] == k * (r + 1),
                      f"6y: step counter {state['step']}")
        finally:
            localsgd.global_parts = parts
        launches = (fa.FWD_LAUNCHES.count, fa.BWD_LAUNCHES.count)
        del params, state, lsgd, exchanged
    parallel.set_mesh(None)
    want = 2 * k * rounds * model.cfg.num_layers
    check(per_round == [1] * rounds, f"6y: exchanges a round {per_round}")
    check(launches == (want, want), f"6y: K2/K3 launches {launches}, "
                                    f"expected {want} each")
    check(all(math.isfinite(v) for lo in all_losses for v in lo),
          f"6y: losses {all_losses}")
    del model
    torch.cuda.empty_cache()
    out = {"losses": all_losses, "exchanges_per_round": per_round,
           "launches": launches, "seconds": time.perf_counter() - t0}
    log(f"  [{card}] 6y: {rounds} rounds of k {k} on dp 2: one exchange a "
        f"round, the state the ranks' mean bitwise; losses {all_losses}; "
        f"K2/K3 {launches}")
    log(f"  phase 6y took {out['seconds']:.1f} s")
    return out


def phase_multislice_auto(torch, np, P, card: str):
    """(6z) GPT-small (fp32, TF32 off) one Momentum step at ZeRO stage
    1 over `init_multislice_mesh(dcn={"dp": 2}, ici={"fsdp": 2})` and
    over the grid that is not row-major (dcn fsdp 2, ici dp 2): the
    loss and every parameter bitwise the `init_mesh(dp=2, fsdp=2)`
    step; `auto.Engine` over 4 logical ranks prepares GPT-small and
    takes two `fit_batch` steps (finite); `Calibrator.fit` over
    `time_step_fn` times of three plans (dp 4, fsdp 4 at stage 3, dp 2
    x fsdp 2 at stage 3) gives the fitted mfu and fast-link rate."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.parallel import auto, multislice
    import copy
    t0 = time.perf_counter()
    out = {}
    base = P.models.gpt_small(seed=0, device="cuda")   # copied, never run
    with tf32_off(torch):
        (plain,), tr = mesh_gpt_small_step(
            torch, np, P, parallel, 1,
            parallel.init_mesh(dp=2, fsdp=2, device="cuda"),
            model=copy.deepcopy(base))
        want = {k: v.detach().clone() for k, v in
                tr.gathered_state().params.items()}
        del tr
        for dcn, ici in (({"dp": 2}, {"fsdp": 2}), ({"fsdp": 2},
                                                   {"dp": 2})):
            mesh = multislice.init_multislice_mesh(dcn=dcn, ici=ici,
                                                   device="cuda")
            (loss,), tr = mesh_gpt_small_step(torch, np, P, parallel, 1,
                                              mesh, model=copy.deepcopy(base))
            got = tr.gathered_state().params
            check(loss == plain and all(torch.equal(got[k], want[k])
                                        for k in want),
                  f"6z: dcn {dcn} ici {ici}: loss {loss} vs {plain} or a "
                  f"parameter differs")
            log(f"  [{card}] 6z: multislice dcn {dcn} ici {ici} (grid "
                f"{mesh.devices.ravel().tolist()}): loss {loss:.6f} and "
                f"every parameter == init_mesh(dp=2, fsdp=2) bitwise")
            del tr, got
        del want
        torch.cuda.empty_cache()
    model = copy.deepcopy(base)
    ids = mesh_ids(torch, np, model.cfg.vocab_size)
    eng = auto.Engine(model, lambda lg, y: model.loss(lg, y),
                      Momentum(1e-2, 0.9), world_size=4)
    eng.prepare(sample_shape=(1, MESH_BATCH["s"]),
                global_batch=MESH_BATCH["b"], seq_like=True)
    el = [float(eng.fit_batch(ids, ids)[0]) for _ in range(2)]
    check(all(math.isfinite(v) for v in el), f"6z: Engine losses {el}")
    out["engine"] = {"plan": str(eng.plan_), "losses": el}
    log(f"  [{card}] 6z: auto.Engine over 4 ranks chose {eng.plan_}; "
        f"fit_batch losses {el}")
    del eng, model
    parallel.set_mesh(None)
    torch.cuda.empty_cache()
    stats = auto.analyze_model(base, (1, MESH_BATCH["s"]), seq_like=True)
    meas = []
    for plan in (auto.Plan(4, 1, 1, 1), auto.Plan(1, 4, 1, 1),
                 auto.Plan(2, 2, 1, 1)):
        model = copy.deepcopy(base)
        mesh = parallel.init_mesh(dp=plan.dp, fsdp=plan.fsdp,
                                  device="cuda")
        if plan.fsdp > 1:
            parallel.apply_fsdp(model, mesh, stage=3)
        tr = Trainer(model, Momentum(1e-2, 0.9),
                     lambda lg, y: model.loss(lg, y), mesh=mesh)
        sec = auto.time_step_fn(lambda a, b: tr.train_step(a, b)[0],
                                (ids, ids), steps=3, warmup=1)
        meas.append((plan, MESH_BATCH["b"], sec))
        log(f"  [{card}] 6z: time_step_fn {plan.degrees}: {sec * 1e3:.2f} "
            f"ms a step")
        del tr, model
        parallel.set_mesh(None)
        torch.cuda.empty_cache()
    del base
    fitted = auto.Calibrator(auto.ClusterSpec(n_devices=4),
                             remat=False).fit(stats, meas)
    out["calibration"] = {"step_s": {str(p.degrees): s for p, _, s in meas},
                          "mfu": fitted.mfu, "ici_bw": fitted.ici_bw,
                          "card": card}
    out["seconds"] = time.perf_counter() - t0
    log(f"  [{card}] 6z: Calibrator.fit over 3 plans: mfu {fitted.mfu:.4g} "
        f"of the datasheet's {fitted.peak_flops:.3g} FLOP/s, fast link "
        f"{fitted.ici_bw:.4g} B/s (4 logical ranks on one card: the "
        f"'link' is the in-process exchange)")
    log(f"  phase 6z took {out['seconds']:.1f} s")
    return out


def gang_gpt_step(torch, np, P, steps: int, stamps=None):
    """GPT-small (fp32, TF32 off) Momentum steps under a dp 2 mesh of
    this process (one process) or spanning the processes: (losses,
    sha256 of the parameters after the first step and after the last,
    seconds a step after the first, layers)."""
    import hashlib
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.optimizer import Momentum

    def digest(tr):
        h = hashlib.sha256()
        for k, v in sorted(tr.gathered_state().params.items()):
            h.update(k.encode())
            h.update(v.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    stamps = {} if stamps is None else stamps
    with tf32_off(torch):
        model = P.models.gpt_small(seed=0, device="cuda")
        tr = Trainer(model, Momentum(1e-2, 0.9),
                     lambda lg, y: model.loss(lg, y),
                     mesh=parallel.init_mesh(dp=2, world_size=2,
                                             device="cuda"))
        ids = mesh_ids(torch, np, model.cfg.vocab_size)
        layers = model.cfg.num_layers
        stamps["model"] = time.time()
        losses = [float(tr.train_step(ids, ids)[0])]
        stamps["step1"] = time.time()
        first = digest(tr)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(steps - 1):
            losses.append(float(tr.train_step(ids, ids)[0]))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t1
        last = digest(tr)
    parallel.set_mesh(None)
    return losses, first, last, sec / max(steps - 1, 1), layers


def worker_gang(torch, np, P, result: str, stamps):
    """9a's worker: the host plane and fleet.metrics over the gloo group,
    then `gang_gpt_step` on a dp 2 mesh spanning the two processes."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.metric import Auc
    from paddle_tpu_torch.ops_cuda import _build
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel import fleet_metrics
    env = parallel.init_parallel_env(timeout=GANG_TIMEOUT_S / 2)
    stamps["gloo"] = time.time()
    rank = env.rank
    out = {"world": env.world_size,
           "gather": C.host_all_gather(
               torch.tensor([rank, 10 + rank]).cuda()).tolist(),
           "bcast": C.host_broadcast(torch.tensor([7.0 * rank + 1]),
                                     src=1).tolist()}
    C.barrier()
    rs = np.random.RandomState(3)
    preds, labels = rs.rand(400), rs.randint(0, 2, 400)
    auc = Auc()
    auc.update(preds[rank::2], labels[rank::2])
    out["auc"] = fleet_metrics.DistributedMetric(auc).accumulate()
    reset_flash_counters(fa)
    C.reset_transport()
    exchange = C.exchange_ranks

    def stamped(local):
        n = len([k for k in stamps if k.startswith("exchange")])
        stamps[f"exchange{n // 2}_in"] = time.time()
        got = exchange(local)
        stamps[f"exchange{n // 2}_out"] = time.time()
        return got

    C.exchange_ranks = stamped
    try:
        (out["losses"], out["first"], out["last"], out["step_s"],
         out["layers"]) = gang_gpt_step(torch, np, P, GANG_STEPS, stamps)
    finally:
        C.exchange_ranks = exchange
    out["transport"] = dict(C.TRANSPORT)
    out["launches"] = (fa.FWD_LAUNCHES.count, fa.BWD_LAUNCHES.count)
    out["builds"] = sum(_build.BUILDS.values())
    stamps["done"] = time.time()
    out["stamps"] = stamps
    with open(result, "w") as f:
        json.dump(out, f)
    return 0


def phase_gang(torch, np, P, card: str):
    """(9a) `launch_local` of 2 worker processes (this script with
    `--worker gang`) on the one card: the gloo group, `host_all_gather`
    / `host_broadcast` / `barrier`, `fleet.metrics`' AUC over the two
    halves == the AUC of the whole; GANG_STEPS GPT-small Momentum steps
    on a dp 2 mesh spanning the processes: the losses and the
    parameters after the first and the last step bitwise the
    one-process dp 2 mesh's; K2/K3 launched 12 layers a step in each
    worker (its one rank); 0 kernel builds in the workers; step ms
    beside the one-process step, with the transport's D2H, gather and
    H2D."""
    import shutil
    import tempfile
    from paddle_tpu_torch.metric import Auc
    from paddle_tpu_torch.parallel.launch import launch_local
    t0 = time.perf_counter()
    want_losses, want_first, want_last, one_s, layers = gang_gpt_step(
        torch, np, P, GANG_STEPS)
    torch.cuda.empty_cache()
    log(f"  [{card}] 9a: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} "
        f"GiB of the card before the workers start")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gang_")
    spawned = time.time()
    try:
        rc = launch_local(os.path.abspath(__file__),
                          ["--worker", "gang", "--result",
                           os.path.join(tmp, "r")],
                          2, devices_per_proc=1, log_dir=tmp,
                          timeout=GANG_TIMEOUT_S)
        logs = {r: open(os.path.join(tmp, f"worker.{r}.log")).read()
                for r in (0, 1)}
        check(rc == 0, f"9a: the gang exited {rc}:\n" + "\n".join(
            v[-2000:] for v in logs.values()))
        outs = [json.load(open(os.path.join(tmp, f"r.{r}")))
                for r in (0, 1)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    whole = Auc()
    rs = np.random.RandomState(3)
    preds, labels = rs.rand(400), rs.randint(0, 2, 400)
    whole.update(preds, labels)
    for r, o in enumerate(outs):
        check(o["world"] == 2 and o["gather"] == [[0, 10], [1, 11]]
              and o["bcast"] == [8.0], f"9a worker {r}: host plane {o}")
        check(o["auc"] == whole.accumulate(), f"9a worker {r}: AUC "
                                              f"{o['auc']}")
        check(o["losses"] == want_losses and o["first"] == want_first
              and o["last"] == want_last,
              f"9a worker {r}: losses {o['losses']} vs one process "
              f"{want_losses}, or the parameters differ")
        check(tuple(o["launches"]) == (layers * GANG_STEPS,) * 2,
              f"9a worker {r}: K2/K3 launches {o['launches']}")
        check(o["builds"] == 0, f"9a worker {r}: {o['builds']} builds")
    tr = outs[0]["transport"]
    steps = GANG_STEPS
    res = {"losses": want_losses, "one_process_step_ms": one_s * 1e3,
           "gang_step_ms": [o["step_s"] * 1e3 for o in outs],
           "transport_ms_per_step": {
               k: tr[k] / steps * 1e3 for k in ("d2h_s", "gather_s",
                                                 "h2d_s")},
           "transport_bytes_per_step": tr["bytes"] / steps,
           "launches": outs[0]["launches"],
           "builds": [o["builds"] for o in outs],
           "worker_stages_s": [stages(spawned, o["stamps"]) for o in outs],
           "seconds": time.perf_counter() - t0}
    log(f"  [{card}] 9a: 2 processes over gloo: host plane and fleet "
        f"AUC across them; GPT-small dp 2 spanning them == one process "
        f"bitwise (losses {want_losses}); step {res['gang_step_ms']} ms "
        f"vs {res['one_process_step_ms']:.1f} ms in one process; the "
        f"exchange a step: D2H "
        f"{res['transport_ms_per_step']['d2h_s']:.1f} ms, gather "
        f"{res['transport_ms_per_step']['gather_s']:.1f} ms, H2D "
        f"{res['transport_ms_per_step']['h2d_s']:.1f} ms, "
        f"{res['transport_bytes_per_step'] / 2**20:.1f} MiB sent; "
        f"K2/K3 {outs[0]['launches']} a worker; builds {res['builds']}")
    log(f"  [{card}] 9a: each worker's stages, seconds after the spawn: "
        f"{res['worker_stages_s']}")
    log(f"  phase 9a took {res['seconds']:.1f} s")
    return res


def elastic_model(torch, P):
    cfg = P.models.GPTConfig(hidden_size=768, num_layers=ELASTIC["layers"],
                             num_heads=12)
    return P.models.GPT(cfg, seed=0, device="cuda")


def elastic_trainer(torch, np, P, world: int):
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.optimizer import Momentum
    model = elastic_model(torch, P)
    tr = Trainer(model, Momentum(1e-2, 0.9),
                 lambda lg, y: model.loss(lg, y),
                 mesh=parallel.init_mesh(dp=2, world_size=world,
                                         device="cuda"))
    return tr, mesh_ids(torch, np, model.cfg.vocab_size)


def worker_elastic(torch, np, P, result: str, ckpt: str, stamps):
    """9b's worker: GPT-small width (ELASTIC["layers"] layers, fp32,
    TF32 off) on a dp 2 mesh over the gang, `AutoCheckpoint` every
    step; process 1 of the first incarnation dies after step
    ELASTIC["die_at"]; a process whose exchange failed waits to be
    stopped. Each writes its K2/K3 launches and builds after every
    step."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.framework import AutoCheckpoint
    from paddle_tpu_torch.ops_cuda import _build
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    env = parallel.init_parallel_env(timeout=GANG_TIMEOUT_S / 2)
    stamps["gloo"] = time.time()
    rank, inc = env.rank, int(os.environ["PTPU_ELASTIC_INCARNATION"])
    with tf32_off(torch):
        tr, ids = elastic_trainer(torch, np, P, 2)
        stamps["model"] = time.time()
        acp = AutoCheckpoint(tr, ckpt, save_every=1, max_to_keep=2,
                             backend="pickle")
        start = acp.restore()
        stamps["restore"] = time.time()
        reset_flash_counters(fa)
        out = {"start": start, "losses": {}, "stamps": stamps,
               "save_s": 0.0}
        for step in range(start + 1, ELASTIC["steps"] + 1):
            try:
                loss, _ = tr.train_step(ids, ids)
            except RuntimeError:
                time.sleep(GANG_TIMEOUT_S)    # a peer is gone
                return 3
            out["losses"][step] = float(loss)
            t_save = time.time()
            acp.step(step)
            out["save_s"] += time.time() - t_save
            stamps[f"step{step}"] = time.time()
            out.update(launches=(fa.FWD_LAUNCHES.count,
                                 fa.BWD_LAUNCHES.count),
                       builds=sum(_build.BUILDS.values()))
            with open(f"{result}.i{inc}.r{rank}", "w") as f:
                json.dump(out, f)
            if inc == 0 and rank == 1 and step == ELASTIC["die_at"]:
                os._exit(1)                   # a failure mid-training
    return 0


def phase_elastic(torch, np, P, card: str):
    """(9b) `ElasticController` over 2 workers (this script with
    `--worker elastic`): GPT-small width (ELASTIC["layers"] layers,
    vocabulary 50304) on a dp 2 mesh spanning them with
    `AutoCheckpoint(save_every=1)`; worker 1 dies after step
    ELASTIC["die_at"]; the gang relaunches (incarnation 1, a rewritten
    endpoint) and resumes from that step; every loss and the final one
    equal an uninterrupted one-process dp 2 run's; each worker's K2/K3
    launches equal layers x the steps it ran, and its builds are 0."""
    import shutil
    import tempfile
    from paddle_tpu_torch.parallel.elastic import ElasticController
    from paddle_tpu_torch.parallel.launch import free_port
    t0 = time.perf_counter()
    with tf32_off(torch):
        tr, ids = elastic_trainer(torch, np, P, 2)
        want = [float(tr.train_step(ids, ids)[0])
                for _ in range(ELASTIC["steps"])]
        del tr
    from paddle_tpu_torch import parallel
    parallel.set_mesh(None)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    spawned = time.time()
    try:
        result = os.path.join(tmp, "r")
        ctrl = ElasticController(
            os.path.abspath(__file__),
            ["--worker", "elastic", "--result", result, "--ckpt",
             os.path.join(tmp, "ckpt")], nproc=2,
            master=f"127.0.0.1:{free_port()}", devices_per_proc=1,
            log_dir=tmp, max_restarts=2, poll_interval=0.1,
            timeout=GANG_TIMEOUT_S)
        rc = ctrl.run()
        logs = sorted(f for f in os.listdir(tmp) if f.endswith(".log"))
        check(rc == 0 and ctrl.restarts == 1,
              f"9b: rc {rc}, restarts {ctrl.restarts}:\n" + "\n".join(
                  open(os.path.join(tmp, f)).read()[-1500:] for f in logs))
        outs = {(i, r): json.load(open(f"{result}.i{i}.r{r}"))
                for i in (0, 1) for r in (0, 1)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    die = ELASTIC["die_at"]
    layers = ELASTIC["layers"]
    for (i, r), o in outs.items():
        ran = len(o["losses"])
        check(o["start"] == (0 if i == 0 else die),
              f"9b i{i} r{r}: resumed from {o['start']}")
        check(tuple(o["launches"]) == (layers * ran,) * 2,
              f"9b i{i} r{r}: K2/K3 {o['launches']} for {ran} steps")
        check(o["builds"] == 0, f"9b i{i} r{r}: {o['builds']} builds")
        for step, loss in o["losses"].items():
            check(loss == want[int(step) - 1],
                  f"9b i{i} r{r} step {step}: loss {loss} vs the "
                  f"uninterrupted {want[int(step) - 1]}")
    check(sorted(int(s) for s in outs[(1, 0)]["losses"]) ==
          list(range(die + 1, ELASTIC["steps"] + 1)), "9b: resumed steps")
    res = {"losses": want, "restarts": ctrl.restarts,
           "launches": {f"i{i}.r{r}": o["launches"]
                        for (i, r), o in outs.items()},
           "builds": {f"i{i}.r{r}": o["builds"] for (i, r), o in
                      outs.items()},
           "save_s": {f"i{i}.r{r}": o["save_s"] for (i, r), o in
                      outs.items()},
           "worker_stages_s": {f"i{i}.r{r}": stages(spawned, o["stamps"])
                               for (i, r), o in outs.items()},
           "seconds": time.perf_counter() - t0}
    log(f"  [{card}] 9b: worker 1 died after step {die}; the gang "
        f"relaunched and resumed; every loss == the uninterrupted run's "
        f"({want}); K2/K3 {res['launches']}; builds {res['builds']}")
    log(f"  [{card}] 9b: seconds saving checkpoints {res['save_s']}; each "
        f"worker's stages after the first spawn: {res['worker_stages_s']}")
    log(f"  phase 9b took {res['seconds']:.1f} s")
    return res


# --------------------------------------------------------------------------- #
# phases 10a-10b: the flat tensor surface (ops/, core, autograd/)
# --------------------------------------------------------------------------- #

SURFACE_BATCH = dict(b=18, s=1024)    # 10b: the bench's GPT-small step
SURFACE_TOL = dict(rtol=1e-5, atol=1e-6)   # 10b's small functions, fp32


def phase_op_sweep(torch, np, P, card: str):
    """(10a) Every case of `testing/op_cases.py` on the card against the
    port's own result on the CPU (TF32 off; each case's tolerance; the
    gradient too where the case takes one; every tensor result on the
    card), the random ops reproducible under `seed` and within their
    law on the card, then the main path's sizes (GPT-small's matmul,
    logits, vocabulary and table; `op_cases.main_path_cases`), each
    within |card - CPU| <= atol · max|CPU| + rtol · |CPU|."""
    from paddle_tpu_torch.testing import op_cases as oc
    t0 = time.perf_counter()
    failed, ran = [], 0
    with tf32_off(torch):
        for case in oc.CASES:
            card_run = oc.port_run(case, "cuda", grad=case.grad)
            cpu_run = oc.port_run(case, "cpu", grad=case.grad)
            ran += 1
            errs = [oc.compare(g, w, case.rtol, case.atol,
                               f"{case.label}[{i}]")
                    for i, (g, w) in enumerate(zip(card_run.values,
                                                   cpu_run.values))]
            if case.grad:
                errs.append(oc.compare(card_run.grad, cpu_run.grad,
                                       case.rtol, case.atol,
                                       f"d {case.label}"))
            if card_run.dtypes != cpu_run.dtypes:
                errs.append(f"{case.label}: dtypes {card_run.dtypes} != "
                            f"{cpu_run.dtypes}")
            if card_run.devices - {"cuda"}:
                errs.append(f"{case.label}: a result on "
                            f"{card_run.devices}")
            failed += [e for e in errs if e]
        o = oc.port_namespace()
        with oc.on_device("cuda"):
            for rc in oc.RANDOM:
                P.seed(99)
                a = rc.draw(o)
                P.seed(99)
                b = rc.draw(o)
                ran += 1
                if a.device.type != "cuda" or not torch.equal(a, b) \
                        or not rc.law(oc.to_numpy(a)):
                    failed.append(f"random {rc.name}: on {a.device}, "
                                  f"reproducible {torch.equal(a, b)}")
        sweep_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        big, on_cpu = [], {}
        for name, fn, inputs, rtol, atol in oc.main_path_cases(torch,
                                                               "cuda"):
            with oc.on_device("cuda"):
                torch.cuda.synchronize()
                t = time.perf_counter()
                got = oc.leaves(fn(o, *inputs))
                torch.cuda.synchronize()
                card_ms = (time.perf_counter() - t) * 1e3
            host = [on_cpu.setdefault(id(v), v.cpu()) for v in inputs]
            with oc.on_device("cpu"):
                want = oc.leaves(fn(o, *host))
            ran += 1
            worst = 0.0
            for g, w in zip(got, want):
                if g.device.type != "cuda":
                    failed.append(f"{name}: a result on {g.device}")
                w = w.to(g.device)        # compared on the card
                if rtol == 0 and atol == 0:
                    if not torch.equal(g, w):
                        failed.append(f"{name}: not bitwise the CPU's")
                    continue
                diff = (g.float() - w.float()).abs()
                wmax = w.float().abs().max()
                err = float((diff - atol * wmax
                             - rtol * w.float().abs()).max())
                worst = max(worst, float(diff.max() / wmax))
                if err > 0:
                    failed.append(f"{name}: beyond rtol {rtol:g}, atol "
                                  f"{atol:g} x max by {err:.3e}")
                del diff
            big.append({"name": name, "card_ms_first_call": card_ms,
                        "max_err_over_max": worst})
            del got, want
        del inputs, on_cpu
        torch.cuda.empty_cache()
    check(not failed, f"10a: {len(failed)} failed:\n" + "\n".join(
        failed[:40]))
    res = {"cases": len(oc.CASES), "random": len(oc.RANDOM),
           "main_path": big, "ran": ran, "failed": 0, "sweep_s": sweep_s,
           "main_path_s": time.perf_counter() - t1,
           "seconds": time.perf_counter() - t0}
    log(f"  [{card}] 10a: {ran} ops run on the card against the CPU "
        f"({len(oc.CASES)} cases, {len(oc.RANDOM)} random laws, "
        f"{len(big)} at the main path's sizes), 0 failed, every result on "
        f"cuda; sweep {sweep_s:.1f} s, main-path sizes "
        f"{res['main_path_s']:.1f} s")
    for b in big:
        log(f"    {b['name']}: max |card - CPU| / max|CPU| "
            f"{b['max_err_over_max']:.2e}, first call "
            f"{b['card_ms_first_call']:.2f} ms")
    log(f"  phase 10a took {res['seconds']:.1f} s")
    return res


def phase_functional_autograd(torch, np, P, card: str):
    """(10b) The reference's training idiom on GPT-small (768 wide, 12
    layers, 12 heads; bf16 parameters with fp32 norms, as phase 7) at
    18 x 1024: `P.seed(0)`, then `P.value_and_grad(loss_fn)(params)`
    over `P.functional_call` and `model.loss`; loss and every gradient
    bitwise `torch.autograd.grad`'s over the same function, 12 K2 and
    12 K3 launches on the wgmma route, no dense attention call. Then
    `jacobian`, `hessian`, `jvp`, `vjp` and a PyLayer on small functions,
    card against CPU."""
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    t0 = time.perf_counter()
    cfg = P.models.GPTConfig(hidden_size=768, num_layers=12, num_heads=12)
    model = P.models.GPT(cfg, seed=0, device="cuda")
    norm = {k for k in dict(model.named_parameters())
            if ".ln" in k or k.startswith("ln_")}
    params = {k: (p.detach() if k in norm else p.detach().to(torch.bfloat16))
              for k, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    ids = gpt_small_ids(torch, np, cfg, SURFACE_BATCH["b"],
                        SURFACE_BATCH["s"])

    def loss_fn(p):
        logits, updates = P.functional_call(model, p, ids)
        check(updates == {}, f"10b: buffer updates {sorted(updates)}")
        return model.loss(logits, ids)

    P.seed(0)
    reset_flash_counters(fa)
    fa.DENSE_ATTENTION_CALLS.reset()
    loss, grads = P.value_and_grad(loss_fn)(params)
    torch.cuda.synchronize()
    launches = {"fwd": fa.FWD_LAUNCHES.count, "bwd": fa.BWD_LAUNCHES.count,
                "wgmma": [c.count for c in fa.ROUTE_COUNTERS[fa.WGMMA]],
                "dense": fa.DENSE_ATTENTION_CALLS.count}
    check(launches["fwd"] == cfg.num_layers == launches["bwd"]
          and launches["wgmma"] == [cfg.num_layers] * 2
          and launches["dense"] == 0,
          f"10b: launches {launches}, want {cfg.num_layers} K2 and K3 on "
          f"the wgmma route, no dense attention")
    loss = loss.detach()
    grads = {k: g.detach() for k, g in grads.items()}
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    ref_loss = loss_fn(leaves)
    ref = dict(zip(leaves, torch.autograd.grad(ref_loss,
                                               list(leaves.values()))))

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    # one more call of each, timed (the first calls above warmed them)
    vg_ms = timed(lambda: P.value_and_grad(loss_fn)(params))
    ref_ms = timed(lambda: torch.autograd.grad(
        loss_fn(leaves), list(leaves.values())))
    check(torch.equal(loss, ref_loss.detach()),
          f"10b: loss {loss.item()} != {ref_loss.item()}")
    check(set(grads) == set(ref), "10b: gradient names differ")
    unequal = [k for k in ref if not torch.equal(grads[k], ref[k])]
    check(not unequal, f"10b: {len(unequal)} gradients not bitwise "
                       f"torch.autograd.grad's: {unequal[:5]}")
    check(all(torch.isfinite(g).all() for g in grads.values()),
          "10b: a gradient is not finite")
    peak = torch.cuda.max_memory_allocated()
    n_grads = len(grads)
    del model, params, grads, ref, leaves, ref_loss
    torch.cuda.empty_cache()

    class Cube(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x ** 3

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return 3 * x ** 2 * dy

    f = lambda x: P.sin(x) * P.sum(x)
    small = {
        "jacobian": lambda x: P.autograd.jacobian(f, x),
        "hessian": lambda x: P.autograd.hessian(
            lambda t: P.sum(t ** 3 * P.exp(t)), x),
        "jvp": lambda x: P.autograd.jvp(f, x, P.ones_like(x))[1],
        "vjp": lambda x: P.autograd.vjp(f, x, P.ones_like(x))[1],
        "PyLayer": lambda x: P.grad(lambda t: P.sum(Cube.apply(t) * t))(x),
        "grad of grad": lambda x: P.grad(
            lambda t: P.sum(P.grad(lambda u: P.sum(P.sin(u) * u ** 3))(t))
        )(x),
    }
    x = torch.from_numpy(np.random.RandomState(5).uniform(
        -1, 1, (6,)).astype(np.float32))
    worst = {}
    with tf32_off(torch):
        for name, fn in small.items():
            got, want = fn(x.cuda()), fn(x)
            check(got.device.type == "cuda", f"10b {name}: on {got.device}")
            check(torch.allclose(got.cpu(), want, **SURFACE_TOL),
                  f"10b {name}: card vs CPU {rel_err(got.cpu(), want):.3e}")
            worst[name] = rel_err(got.cpu(), want)
    res = {"loss": loss.item(), "launches": launches,
           "fwd_launches": launches["fwd"], "bwd_launches": launches["bwd"],
           "value_and_grad_ms": vg_ms, "autograd_grad_ms": ref_ms,
           "peak_bytes": peak, "small_rel_err": worst,
           "seconds": time.perf_counter() - t0}
    log(f"  [{card}] 10b: GPT-small 12 layers bf16, "
        f"{SURFACE_BATCH['b']} x {SURFACE_BATCH['s']}: pt.value_and_grad "
        f"over pt.functional_call, loss {res['loss']:.6f} and "
        f"{n_grads} gradients bitwise torch.autograd.grad's; K2 "
        f"{launches['fwd']} / K3 {launches['bwd']} on wgmma, dense "
        f"attention 0; value_and_grad {vg_ms:.1f} ms vs autograd.grad "
        f"{ref_ms:.1f} ms (a second call each); peak "
        f"{peak / 2**30:.2f} GiB")
    log("    card vs CPU (rtol 1e-5, atol 1e-6): " + ", ".join(
        f"{k} {v:.1e}" for k, v in worst.items()))
    log(f"  phase 10b took {res['seconds']:.1f} s")
    return res


def worker_main(args, stamps) -> int:
    """A worker process of phases 9a / 9b; `stamps` ({stage: time.time()})
    goes into its result."""
    import numpy as np
    import torch
    import paddle_tpu_torch as P
    stamps["import"] = time.time()
    if args.worker == "gang":
        return worker_gang(torch, np, P, args.result + "." + os.environ[
            "PTPU_PROCESS_ID"], stamps)
    return worker_elastic(torch, np, P, args.result, args.ckpt, stamps)


def stages(spawned: float, stamps) -> dict:
    """A worker's stamps as seconds since its spawn, in order."""
    return {k: round(v - spawned, 2) for k, v in sorted(
        stamps.items(), key=lambda kv: kv[1])}


# --------------------------------------------------------------------------- #
# phases 11a-11d: the vision zoo, the image pipeline, quantized
# convolutions, the new layers and the native collate
# --------------------------------------------------------------------------- #

# the 23 constructors, and VGG-16 with batch norm
ZOO = [("LeNet", {}), ("AlexNet", {}), ("vgg11", {}), ("vgg13", {}),
       ("vgg16", {}), ("vgg19", {}), ("vgg16", {"batch_norm": True}),
       ("mobilenet_v1", {}), ("mobilenet_v2", {}),
       ("mobilenet_v3_small", {}), ("mobilenet_v3_large", {}),
       ("densenet121", {}), ("densenet161", {}), ("densenet169", {}),
       ("densenet201", {}), ("inception_v3", {}),
       ("shufflenet_v2_x0_25", {}), ("shufflenet_v2_x0_5", {}),
       ("shufflenet_v2_x1_0", {}), ("shufflenet_v2_x1_5", {}),
       ("shufflenet_v2_x2_0", {}), ("squeezenet1_0", {}),
       ("squeezenet1_1", {}), ("googlenet", {})]
# (parameters, buffers) at 1000 classes: the JAX package's counts, as
# tests/test_torch_vision_models.py pins them
ZOO_FULL_WIDTH = {
    "LeNet": (145760, 0), "AlexNet": (61100840, 0),
    "vgg11": (132863336, 0), "vgg13": (133047848, 0),
    "vgg16": (138357544, 0), "vgg19": (143667240, 0),
    "vgg16_bn": (138365992, 8448),
    "mobilenet_v1": (4231976, 21888), "mobilenet_v2": (3504872, 34112),
    "mobilenet_v3_small": (2542856, 12112),
    "mobilenet_v3_large": (5483032, 24400),
    "densenet121": (7978856, 83648), "densenet161": (28681000, 219936),
    "densenet169": (14149480, 158400), "densenet201": (20013928, 229056),
    "inception_v3": (23834568, 34432),
    "shufflenet_v2_x0_25": (603688, 4024),
    "shufflenet_v2_x0_5": (1366792, 7952),
    "shufflenet_v2_x1_0": (2278604, 16180),
    "shufflenet_v2_x1_5": (3503624, 23440),
    "shufflenet_v2_x2_0": (7393996, 33716),
    "squeezenet1_0": (1248424, 0), "squeezenet1_1": (1235496, 0),
    "googlenet": (6998552, 0)}
# one constructor per family, held against the CPU
ZOO_FAMILIES = ("LeNet", "AlexNet", "vgg11", "mobilenet_v1", "mobilenet_v2",
                "mobilenet_v3_large", "densenet121", "inception_v3",
                "shufflenet_v2_x1_0", "squeezenet1_1", "googlenet")
ZOO_BATCH = 2
ZOO_TOL = 1e-4          # card vs CPU, of the largest logit (fp32, TF32 off)
FIT_BATCH, FIT_STEPS, FIT_WORKERS = 64, 20, 8
QUANT_CALIB = (4, 32)   # batches x images at 224^2
# int8 resnet50 logits card vs CPU, of the largest. Every Int8Conv2D's
# whole forward (codes, int32 accumulators, fp32 rescale and bias) is
# held bitwise on the card's own input; the logits still drift, since
# the float batch norms between the layers round apart on the two
# devices and a code that lands on a half-point flips (the phase prints
# the first such layer). The limit lies below the int8-vs-float gap of
# the same run (2.73e-2 on an H100 80GB HBM3 at 700 W; checked too), so
# a card model left in float fails it; that run read 1.35e-2
QUANT_TOL = 2e-2
COLLATE_N = 64
VISION_DEVICE = "cuda"


def _zoo_key(name, kw):
    return name + ("_bn" if kw.get("batch_norm") else "")


def _zoo_input(name):
    """(channels, side) of a constructor's input at full width."""
    return {"LeNet": (1, 28), "inception_v3": (3, 299)}.get(name, (3, 224))


def _cpu_twin(torch, P, name, kw, model):
    """The port's CPU twin of a card model: laid out on meta, then given
    the card model's state."""
    with torch.device("meta"):
        twin = getattr(P.models, name)(device="meta", **kw)
    twin = twin.to_empty(device="cpu")
    twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return twin.eval()


def phase_zoo(torch, np, P, card: str):
    """(11a) every constructor of the zoo at full width on the card."""
    import io as _io
    t_phase = time.perf_counter()
    rs = np.random.RandomState(0)
    rows = {}
    with tf32_off(torch):
        for name, kw in ZOO:
            key = _zoo_key(name, kw)
            t0 = time.perf_counter()
            m = getattr(P.models, name)(num_classes=1000, seed=0,
                                        device=VISION_DEVICE, **kw).eval()
            build_s = time.perf_counter() - t0
            counts = (sum(p.numel() for p in m.parameters()),
                      sum(b.numel() for b in m.buffers()))
            check(counts == ZOO_FULL_WIDTH[key],
                  f"{key}: (parameters, buffers) {counts}, the JAX "
                  f"package's {ZOO_FULL_WIDTH[key]}")
            check(all(t.device.type == VISION_DEVICE for t in m.state_dict().values()),
                  f"{key}: a tensor off the card")
            c, side = _zoo_input(name)
            with contextlib.redirect_stdout(_io.StringIO()):
                summ = P.summary(m, (ZOO_BATCH, c, side, side))
            check(summ == {"total_params": counts[0],
                           "trainable_params": counts[0]},
                  f"{key}: summary {summ}, {counts[0]} parameters")
            x = torch.from_numpy(rs.randn(ZOO_BATCH, c, side, side)
                                 .astype(np.float32)).to(VISION_DEVICE)
            t0 = time.perf_counter()
            with torch.no_grad():
                out = m(x)
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) * 1e3
            check(tuple(out.shape) == (ZOO_BATCH, 1000)
                  and bool(torch.isfinite(out).all()),
                  f"{key}: output {tuple(out.shape)}, finite "
                  f"{bool(torch.isfinite(out).all())}")
            err = None
            if key in ZOO_FAMILIES:
                twin = _cpu_twin(torch, P, name, dict(kw, num_classes=1000),
                                 m)
                with torch.no_grad():
                    err = rel_err(out.cpu(), twin(x.cpu()))
                check(err <= ZOO_TOL, f"{key} card vs CPU: {err:.2e} > "
                                      f"{ZOO_TOL}")
                del twin
            rows[key] = {"params": counts[0], "buffers": counts[1],
                         "build_s": build_s, "first_forward_ms": fwd_ms,
                         "card_vs_cpu": err}
            log(f"  {key}: {counts[0]} parameters, {counts[1]} buffer "
                f"entries (JAX's), summary's totals equal; built in "
                f"{build_s:.2f} s; first fp32 forward at {ZOO_BATCH} x "
                f"{c} x {side}^2 {fwd_ms:.1f} ms (cuDNN set-up included)"
                + ("" if err is None else
                   f"; card vs CPU {err:.2e} (limit {ZOO_TOL})"))
            del m, out, x
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    held = sum(r["card_vs_cpu"] is not None for r in rows.values())
    log(f"  11a: {len(rows)} constructors, {held} held against the CPU, "
        f"in {seconds:.1f} s [{card}]")
    return {"models": rows, "seconds": seconds}


class _TimedLoader:
    """A DataLoader whose iteration sums the seconds spent blocked in
    `next()`: the wait on the loader."""

    def __init__(self, loader):
        self.loader = loader
        self.wait_s = 0.0

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            finally:
                self.wait_s += time.perf_counter() - t0
            yield batch


def flowers_pipeline(P, size: int, seed: int = 0):
    """The training and eval transforms of 11b on synthetic Flowers
    (64 x 64 uint8 RGB), one random stream for the training ones."""
    from paddle_tpu_torch.vision import transforms as T
    r = T.SeededRandom(seed)
    norm = [T.Normalize(mean=[127.5] * 3, std=[58.0] * 3, data_format="HWC"),
            T.Transpose()]
    train = T.Compose([T.RandomResizedCrop(size, seed=r),
                       T.ColorJitter(0.4, 0.4, 0.4, seed=r),
                       T.RandomHorizontalFlip(seed=r)] + norm)
    return train, T.Compose([T.Resize((size, size))] + norm)


def fit_flowers(torch, P, model, size, batch, steps, workers, log_dir,
                device):
    """`hapi.Model.fit` of `model` over synthetic Flowers: Momentum (0.9,
    weight decay 4e-5) under a cosine schedule stepped each batch by
    `LRSchedulerCallback`, `EarlyStopping` on the valid split's loss,
    `VisualDL` into `log_dir`. Returns (history, the train loader, the
    per-step losses from the scalars file, eval seconds, callbacks)."""
    from paddle_tpu_torch import hapi, metric, nn, optimizer
    from paddle_tpu_torch.hapi.callbacks import (Callback, EarlyStopping,
                                                 LRSchedulerCallback,
                                                 VisualDL)
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision import datasets
    datasets.set_synthetic_fallback(True)
    tf, ev = flowers_pipeline(P, size)
    train = datasets.Flowers(mode="train", transform=tf)
    valid = datasets.Flowers(mode="valid", transform=ev)
    sched = optimizer.lr.CosineAnnealingDecay(0.05, T_max=steps)
    hm = hapi.Model(model)
    hm.prepare(optimizer.Momentum(learning_rate=sched, momentum=0.9,
                                  weight_decay=4e-5),
               nn.CrossEntropyLoss(), metric.Accuracy())
    loader = _TimedLoader(DataLoader(train, batch_size=batch, shuffle=True,
                                     drop_last=True, num_workers=workers,
                                     to_device=device, seed=0))
    valid_loader = DataLoader(valid, batch_size=batch, num_workers=workers,
                              to_device=device)

    class EvalClock(Callback):
        seconds = 0.0

        def on_eval_begin(self, logs=None):
            self._t0 = time.perf_counter()

        def on_eval_end(self, logs=None):
            EvalClock.seconds += time.perf_counter() - self._t0

    stop = EarlyStopping(monitor="loss", patience=steps)
    cbs = [LRSchedulerCallback(by_step=True, by_epoch=False), stop,
           VisualDL(log_dir=log_dir), EvalClock()]
    epochs = -(-steps // len(loader))
    hist = hm.fit(loader, eval_data=valid_loader, epochs=epochs,
                  num_iters=steps, verbose=0, callbacks=cbs)
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["value"] for r in rows if r["tag"] == "train/loss"]
    return hist, loader, losses, EvalClock.seconds, {
        "sched": sched, "stop": stop, "rows": rows, "model": hm}


def phase_mobilenet_fit(torch, np, P, card: str):
    """(11b) mobilenet_v2 trained through the image pipeline."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_vdl_")
    try:
        model = P.models.mobilenet_v2(scale=1.0, num_classes=102, seed=0,
                                      device=VISION_DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hist, loader, losses, eval_s, cb = fit_flowers(
            torch, P, model, 224, FIT_BATCH, FIT_STEPS, FIT_WORKERS,
            log_dir, VISION_DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(len(losses) == FIT_STEPS and all(math.isfinite(v)
                                               for v in losses),
              f"scalars file: {len(losses)} train losses {losses}")
        first, last = (statistics.mean(losses[:5]),
                       statistics.mean(losses[-5:]))
        check(last < first, f"mobilenet_v2 loss did not fall: first 5 "
                            f"{first:.4f}, last 5 {last:.4f}: {losses}")
        evals = [r for r in cb["rows"] if r["tag"] == "eval/loss"]
        check(len(evals) >= 1 and cb["stop"].best is not None,
              f"eval rows {len(evals)}, EarlyStopping best "
              f"{cb['stop'].best}")
        check(cb["sched"].last_epoch == FIT_STEPS,
              f"the schedule stepped {cb['sched'].last_epoch} times, want "
              f"{FIT_STEPS}")
        check(cb["model"]._trainer.state.step == FIT_STEPS,
              f"{cb['model']._trainer.state.step} steps, want {FIT_STEPS}")
        train_s = wall - eval_s
        fit_ips = hist.get("ips", [float("nan")])[-1]
        step_ms = train_s / FIT_STEPS * 1e3
        ips = FIT_BATCH * FIT_STEPS / train_s
        share = loader.wait_s / train_s
        log(f"  mobilenet_v2 (102 classes, fp32) fit over synthetic Flowers "
            f"(256 train images, RandomResizedCrop(224) + ColorJitter + "
            f"flip + normalize + transpose on {FIT_WORKERS} thread "
            f"workers, native collate), {FIT_STEPS} steps at {FIT_BATCH} x "
            f"224^2: losses {[round(v, 4) for v in losses]}; first 5 mean "
            f"{first:.4f}, last 5 {last:.4f}; eval losses "
            f"{[round(r['value'], 4) for r in evals]}")
        log(f"  11b [{card}]: {step_ms:.1f} ms per step, {ips:.1f} images/s "
            f"(wall of fit {wall:.2f} s less {eval_s:.2f} s of evaluation), "
            f"fit's own ips {fit_ips:.1f}; waiting on the loader "
            f"{loader.wait_s:.2f} s = {share:.1%} of the training wall; peak "
            f"memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
        del model, cb
        torch.cuda.empty_cache()
        return {"losses": losses, "step_ms": step_ms, "images_per_s": ips,
                "fit_ips": fit_ips, "loader_wait_s": loader.wait_s,
                "loader_share": share, "peak_bytes": peak, "wall_s": wall,
                "eval_s": eval_s,
                "seconds": time.perf_counter() - t_phase}
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)


def _kinds(model, names):
    out = {n: 0 for n in names}
    for m in model.modules():
        if type(m).__name__ in out:
            out[type(m).__name__] += 1
    return out


def _int8_inputs(torch, model, names, x, rows):
    """{layer name: the first `rows` images of its input} over one
    forward of `model` on `x`, in the order the forward reaches them."""
    seen, hooks = {}, []
    for n in names:
        def grab(mod, args, n=n):
            seen[n] = args[0][:rows].detach().clone()
        hooks.append(model.get_submodule(n).register_forward_pre_hook(grab))
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return seen


def hold_int8_layers(torch, model, cpu_model, inputs):
    """Each named Int8Conv2D on the card against its CPU copy on the
    same input, bitwise: its int32 accumulators and its whole forward
    (the fp32 rescale and bias too); returns {name: (shape, groups)}."""
    out = {}
    with torch.no_grad():
        for n, x in inputs.items():
            layer, twin = model.get_submodule(n), cpu_model.get_submodule(n)
            acc = layer.int32_acc(x)
            ref = twin.int32_acc(x.cpu())
            check(acc.dtype == torch.int32 and torch.equal(acc.cpu(), ref),
                  f"{n}: int32 accumulators card vs CPU differ "
                  f"({int((acc.cpu() != ref).sum())} of {ref.numel()})")
            y, y_ref = layer(x).cpu(), twin(x.cpu())
            check(y.dtype == y_ref.dtype and torch.equal(y, y_ref),
                  f"{n}: forward card vs CPU differs "
                  f"({int((y != y_ref).sum())} of {y_ref.numel()}, "
                  f"max {float((y - y_ref).abs().max()):.3e})")
            out[n] = (tuple(acc.shape), layer._conv_args[3])
    return out


def _ordered_bits(torch, t):
    """fp32 values as integers in the order of the values, so that two
    values' difference counts the ulps between them."""
    i = t.float().contiguous().view(torch.int32).long()
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def flip_cause(torch, Q, cpu_model, card_inputs, cpu_inputs):
    """Where the two devices' own forwards first hand an Int8Conv2D
    codes that differ: that layer (in forward order), its flipped
    codes, the ulps between the two inputs there, and how far each
    input's x / scale lies from the rounding boundary between the two
    codes (in code units); with the count of codes that differ in all
    layers."""
    first, flips, codes = None, 0, 0
    for n, b in cpu_inputs.items():
        a, s = card_inputs[n].cpu(), cpu_model.get_submodule(n).act_scale
        qa, qb = Q.quantize_tensor(a, s), Q.quantize_tensor(b, s)
        diff = qa != qb
        flips += int(diff.sum())
        codes += b.numel()
        if first is None and bool(diff.any()):
            ulps = (_ordered_bits(torch, a) - _ordered_bits(torch, b)).abs()
            edge = (qa.float() + qb.float())[diff] / 2
            sf = s.float()
            first = {"layer": n, "flipped": int(diff.sum()),
                     "codes": b.numel(),
                     "inputs_apart": int((a != b).sum()),
                     "ulps_max": int(ulps[diff].max()),
                     "code_step_max": int((qa.int() - qb.int()).abs().max()),
                     "edge_dist_max": float(torch.maximum(
                         (a[diff].float() / sf - edge).abs(),
                         (b[diff].float() / sf - edge).abs()).max())}
    return first, flips, codes


def phase_quant_conv(torch, np, P, card: str):
    """(11c) PTQ of resnet50 at full width, each int8 layer card vs
    CPU, one QAT step."""
    import copy
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.nn import functional as F
    t_phase = time.perf_counter()
    kinds = ("QuantedConv2D", "QuantedLinear", "Int8Conv2D", "Int8Linear",
             "Conv2D", "Linear")
    rs = np.random.RandomState(0)
    n_batches, bs = QUANT_CALIB
    calib = [rs.randn(bs, 3, 224, 224).astype(np.float32)
             for _ in range(n_batches)]
    with tf32_off(torch):
        model = P.models.resnet50(num_classes=1000, seed=0,
                                  device=VISION_DEVICE).eval()
        fmodel = copy.deepcopy(model)
        ptq = Q.PTQ()
        ptq.quantize(model)
        k = _kinds(model, kinds)
        check((k["QuantedConv2D"], k["QuantedLinear"]) == (53, 1),
              f"PTQ wrapped {k}")
        t0 = time.perf_counter()
        ptq.sample(model, calib)
        ptq.convert(model)
        torch.cuda.synchronize()
        convert_s = time.perf_counter() - t0
        k = _kinds(model, kinds)
        check((k["Int8Conv2D"], k["Int8Linear"], k["Conv2D"], k["Linear"],
               k["QuantedConv2D"]) == (53, 1, 0, 0, 0),
              f"converted resnet50 holds {k}")
        x = torch.from_numpy(calib[0]).to(VISION_DEVICE)
        with torch.no_grad():
            q_out, f_out = model(x), fmodel(x)
        check(bool(torch.isfinite(q_out).all()), "int8 logits not finite")
        agree = float((q_out.argmax(1) == f_out.argmax(1)).float().mean())
        q_rel = rel_err(q_out, f_out)
        with torch.no_grad():
            int8_ms = wall_ms(torch, lambda: model(x), 5)
            float_ms = wall_ms(torch, lambda: fmodel(x), 5)
        names = [n for n, m in model.named_modules()
                 if isinstance(m, Q.Int8Conv2D)]
        inputs = _int8_inputs(torch, model, names, x, 2)
        cpu_model = copy.deepcopy(model).cpu()
        shapes = hold_int8_layers(torch, model, cpu_model, inputs)
        # the codes each device's own forward hands every layer
        cpu_inputs = _int8_inputs(torch, cpu_model, names, x[:2].cpu(), 2)
        first, flips, codes = flip_cause(torch, Q, cpu_model, inputs,
                                         cpu_inputs)
        with torch.no_grad():
            cpu_err = rel_err(q_out[:2].cpu(), cpu_model(x[:2].cpu()))
            f_cpu_err = rel_err(f_out[:2].cpu(),
                                copy.deepcopy(fmodel).cpu()(x[:2].cpu()))
        check(cpu_err <= QUANT_TOL and cpu_err < q_rel,
              f"int8 resnet50 logits card vs CPU {cpu_err:.2e}: over "
              f"{QUANT_TOL} or not under the int8-vs-float gap {q_rel:.2e}")
        del cpu_model, fmodel
        # a grouped (depthwise) layer: a converted mobilenet_v2
        mb = P.models.mobilenet_v2(num_classes=1000, seed=0,
                                   device=VISION_DEVICE).eval()
        ptq2 = Q.PTQ()
        ptq2.quantize(mb)
        ptq2.sample(mb, [calib[1][:8]])
        ptq2.convert(mb)
        mnames = ["features.2.conv.0.0", "features.2.conv.1.0"]
        inputs = _int8_inputs(torch, mb, mnames, x[:8], 2)
        shapes.update(hold_int8_layers(torch, mb, copy.deepcopy(mb).cpu(),
                                       inputs))
        check(shapes["features.2.conv.1.0"][1] == 96,
              f"features.2.conv.1.0 groups {shapes['features.2.conv.1.0']}")
        del mb
        # one QAT step of QuantedConv2D layers
        qm = P.models.resnet18(num_classes=10, seed=0, device=VISION_DEVICE)
        Q.QAT().quantize(qm)
        check(_kinds(qm, kinds)["QuantedConv2D"] == 20, "QAT resnet18")
        qm.train()
        opt = P.optimizer.Momentum(0.01, momentum=0.9).bind(qm)
        params = {n: p for n, p in qm.named_parameters() if p.requires_grad}
        before = {n: p.detach().clone() for n, p in params.items()}
        xb = torch.from_numpy(rs.randn(8, 3, 64, 64).astype(np.float32)
                              ).to(VISION_DEVICE)
        yb = torch.from_numpy(rs.randint(0, 10, (8,))).to(VISION_DEVICE)
        loss = F.cross_entropy(qm(xb), yb)
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.step(dict(zip(params, grads)))
        loss = float(loss.detach())
        moved = sum(not torch.equal(p, before[n]) for n, p in params.items())
        scale = float(qm.conv1._act_scale)
        check(math.isfinite(loss)
              and all(bool(torch.isfinite(g).all()) for g in grads)
              and moved == len(params) and scale != 1.0,
              f"QAT step: loss {loss}, {moved} of {len(params)} "
              f"parameters moved, conv1 act scale {scale}")
        del qm
    torch.cuda.empty_cache()
    held = ", ".join(f"{n} {s} groups {g}" for n, (s, g) in shapes.items()
                     if n.startswith(("conv1", "features")))
    log(f"  resnet50 PTQ (fp32, TF32 off): 53 Conv2D -> Int8Conv2D, fc -> "
        f"Int8Linear; calibrated on {n_batches} x {bs} x 224^2 and "
        f"converted in {convert_s:.2f} s; int32 accumulators and whole "
        f"forwards bitwise the CPU's in all {len(names)} Int8Conv2D layers "
        f"on the card's input (2 images; among them {held}); the two "
        f"devices' own forwards hand the layers codes that differ in "
        f"{flips} of {codes}, first at {first}; "
        f"int8 logits card vs CPU {cpu_err:.2e} (limit {QUANT_TOL} and the "
        f"int8-vs-float gap; the float model's {f_cpu_err:.2e}); int8 "
        f"vs float logits {q_rel:.2e}, top-1 agreement {agree:.3f} on the "
        f"calibration batch; one QAT step of resnet18 (20 QuantedConv2D): "
        f"loss {loss:.4f}, conv1 act scale {scale:.4g}")
    log(f"  11c [{card}]: resnet50 forward at {bs} x 224^2, int8 "
        f"{int8_ms:.2f} ms against float {float_ms:.2f} ms (host clock, "
        f"synchronised, 5 reps)")
    return {"int8_ms": int8_ms, "float_ms": float_ms, "top1_agree": agree,
            "int8_vs_float": q_rel, "card_vs_cpu": cpu_err,
            "float_card_vs_cpu": f_cpu_err, "code_flips": flips,
            "codes": codes, "first_flip": first,
            "convert_s": convert_s,
            "layers": {n: list(s) for n, s in shapes.items()},
            "seconds": time.perf_counter() - t_phase}


def phase_layers_collate(torch, np, P, card: str):
    """(11d) the new layers card vs CPU, the native collate."""
    import copy
    nn = P.nn
    t_phase = time.perf_counter()
    rs = np.random.RandomState(0)

    def relu(*shape):
        return torch.from_numpy(np.maximum(rs.randn(*shape), 0)
                                .astype(np.float32))

    pools = [  # (what, layer, input): max pools on ReLU outputs (ties)
        ("MaxPool2D(3, 2, 1, return_mask)",
         nn.MaxPool2D(3, 2, 1, return_mask=True), relu(8, 64, 112, 112)),
        ("MaxPool2D(2, return_mask)", nn.MaxPool2D(2, return_mask=True),
         relu(8, 128, 56, 56)),
        ("MaxPool1D(3, 2, 1)", nn.MaxPool1D(3, 2, 1), relu(8, 64, 1000)),
        ("MaxPool3D(3, 2, 1)", nn.MaxPool3D(3, 2, 1), relu(2, 32, 16, 32, 32)),
        ("AdaptiveMaxPool1D(7, return_mask)",
         nn.AdaptiveMaxPool1D(7, return_mask=True), relu(8, 64, 100)),
        ("AdaptiveMaxPool2D((7, 5))", nn.AdaptiveMaxPool2D((7, 5)),
         relu(8, 64, 30, 30)),
        ("AdaptiveMaxPool3D(3)", nn.AdaptiveMaxPool3D(3),
         relu(2, 32, 10, 11, 12)),
        ("AvgPool1D(3, 2, 1)", nn.AvgPool1D(3, 2, 1), relu(8, 64, 1000)),
        ("AvgPool3D(3, 2, 1, exclusive)", nn.AvgPool3D(3, 2, 1),
         relu(2, 32, 16, 32, 32)),
        ("AdaptiveAvgPool1D(7)", nn.AdaptiveAvgPool1D(7), relu(8, 64, 100)),
        ("AdaptiveAvgPool3D((2, 3, 5))", nn.AdaptiveAvgPool3D((2, 3, 5)),
         relu(2, 32, 10, 11, 12))]
    convs = [  # (what, layer, input)
        ("Conv1DTranspose(32, 16, 5, 2, 2, output_padding=1)",
         nn.Conv1DTranspose(32, 16, 5, 2, 2, output_padding=1),
         torch.from_numpy(rs.randn(8, 32, 500).astype(np.float32))),
        ("Conv2DTranspose(64, 32, 4, 2, 1)", nn.Conv2DTranspose(64, 32, 4, 2, 1),
         torch.from_numpy(rs.randn(8, 64, 28, 28).astype(np.float32))),
        ("Conv2DTranspose(64, 64, 3, 2, 1, 1, groups=4)",
         nn.Conv2DTranspose(64, 64, 3, 2, 1, 1, groups=4),
         torch.from_numpy(rs.randn(8, 64, 28, 28).astype(np.float32))),
        ("Conv3DTranspose(16, 8, 3, 2, 1, 1)",
         nn.Conv3DTranspose(16, 8, 3, 2, 1, 1),
         torch.from_numpy(rs.randn(2, 16, 8, 16, 16).astype(np.float32)))]
    worst = {"avg": 0.0, "conv": 0.0}
    with tf32_off(torch), torch.no_grad():
        for what, layer, x in pools:
            ref = layer(x)
            got = layer(x.to(VISION_DEVICE))
            ref = ref if isinstance(ref, tuple) else (ref,)
            got = got if isinstance(got, tuple) else (got,)
            for g, r in zip(got, ref):
                check(g.dtype == r.dtype and g.shape == r.shape,
                      f"{what}: {g.dtype} {tuple(g.shape)} vs {r.dtype} "
                      f"{tuple(r.shape)}")
                if "Max" in what or not r.is_floating_point():
                    check(torch.equal(g.cpu(), r),
                          f"{what}: card != CPU bitwise")
                else:
                    e = rel_err(g.cpu(), r)
                    worst["avg"] = max(worst["avg"], e)
                    check(e <= 1e-6, f"{what}: card vs CPU {e:.2e} > 1e-6")
        for what, layer, x in convs:
            ref = layer(x)
            got = copy.deepcopy(layer).to(VISION_DEVICE)(x.to(VISION_DEVICE))
            e = rel_err(got.cpu(), ref)
            worst["conv"] = max(worst["conv"], e)
            check(e <= 1e-5, f"{what}: card vs CPU {e:.2e} > 1e-5")
    samples = [rs.rand(3, 224, 224).astype(np.float32)
               for _ in range(COLLATE_N)]
    got = P.native.collate_batch(samples)          # builds the library
    want = np.stack(samples)
    check(got.dtype == want.dtype and np.array_equal(got, want),
          "native collate != np.stack")

    def median_ms(fn, reps=10):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    collate_ms = median_ms(lambda: P.native.collate_batch(samples))
    stack_ms = median_ms(lambda: np.stack(samples))
    log(f"  {len(pools)} pools on ReLU outputs: max values and indices "
        f"bitwise the CPU's, averages within {worst['avg']:.2e}; "
        f"{len(convs)} transposed convolutions within {worst['conv']:.2e} "
        f"(fp32, TF32 off)")
    log(f"  11d [{card}]: native collate of {COLLATE_N} x 3 x 224 x 224 "
        f"float32 ({want.nbytes / 2**20:.1f} MiB) bitwise np.stack: "
        f"{collate_ms:.2f} ms against np.stack {stack_ms:.2f} ms (median of "
        f"10, host clock)")
    return {"avg_err": worst["avg"], "conv_err": worst["conv"],
            "collate_ms": collate_ms, "stack_ms": stack_ms,
            "seconds": time.perf_counter() - t_phase}


def run_vision_phases(torch, np, P, card: str) -> dict:
    """Phases 11a-11d, each timed."""
    t0 = time.perf_counter()
    log("phase 11a: the vision zoo at full width on the card: 24 builds, "
        "JAX's counts, summary, an fp32 forward, 11 families vs the CPU")
    zoo = phase_zoo(torch, np, P, card)
    log("phase 11b: mobilenet_v2 trained through the image pipeline "
        "(synthetic Flowers, transforms, thread workers, native collate, "
        "hapi.Model.fit with LRSchedulerCallback, EarlyStopping, VisualDL)")
    fit = phase_mobilenet_fit(torch, np, P, card)
    log("phase 11c: quantized convolutions: PTQ of resnet50 at full width, "
        "int32 accumulators card == CPU, one QAT step")
    quant = phase_quant_conv(torch, np, P, card)
    log("phase 11d: transposed convolutions, the new pools and return_mask "
        "card vs CPU; the native collate")
    layers = phase_layers_collate(torch, np, P, card)
    seconds = {"11a": zoo["seconds"], "11b": fit["seconds"],
               "11c": quant["seconds"], "11d": layers["seconds"],
               "all": time.perf_counter() - t0}
    log(f"  phases 11a-11d took {seconds['all']:.1f} s (11a "
        f"{seconds['11a']:.1f}, 11b {seconds['11b']:.1f}, 11c "
        f"{seconds['11c']:.1f}, 11d {seconds['11d']:.1f})")
    return {"zoo": zoo, "fit": fit, "quant": quant, "layers": layers,
            "seconds": seconds}


# --------------------------------------------------------------------------- #
# phase 8: numbers
# --------------------------------------------------------------------------- #

def time_ms(torch, fn, flush, reps: int = 50) -> float:
    """Median device time of one `fn()` call: each call is queued behind
    a ~1 ms device sleep (so host-side launch work is hidden and the
    events time the device only) and after an L2 flush (a cache's rows
    are cold in real decode: a layer's K/V slabs far exceed the 50 MB
    L2)."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def phase_numbers(torch, dec, engine_run, card: str):
    F = torch.nn.functional
    S, T, nh, hd = 8, 1024, 12, 64
    dtype = torch.bfloat16
    isz = 2
    # phase-4 shapes; lengths of the first 8 requests halfway through
    # their 64 new tokens
    lengths = [int(p.size) + 32 for p in engine_run["prompts"][:S]]
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(S, nh, hd, device="cuda", generator=gen).to(dtype)
    kc = torch.randn(S, T, nh, hd, device="cuda", generator=gen).to(dtype)
    vc = torch.randn(S, T, nh, hd, device="cuda", generator=gen).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    keep = (torch.arange(T, device="cuda")[None, :]
            < lens[:, None].long())[:, None, None]           # (B,1,1,T)
    qs, ks, vs = q[:, :, None], kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)

    ms = time_ms(torch, lambda: dec.ragged_decode_attention(q, kc, vc, lens),
                 flush)
    plain_ms = time_ms(torch, lambda: dec.ragged_decode_reference(
        q, kc, vc, lens), flush)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=keep), flush)
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=keep)
    torch.testing.assert_close(lib_out[:, :, 0].float(),
                               dec.ragged_decode_attention(
                                   q, kc, vc, lens).float(), **TOL["bfloat16"])
    live = sum(min(n, T) for n in lengths)
    nbytes = (2 * live * nh * hd * isz          # K and V live rows
              + 2 * S * nh * hd * isz           # q in, output out
              + 4 * S)                          # lengths
    flops = 4 * live * nh * hd                  # q.k and p.v, 2 each
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    C = dec.cluster_size(T)
    log(f"  K1 at phase-4 shapes (B=S={S}, T={T}, nh={nh}, hd={hd}, bf16, "
        f"{C} CTAs per lane and head in one cluster, {C * nh * S} CTAs; "
        f"lengths {lengths}) [card: {card}]")
    log(f"    wrapper median {ms:.4f} ms (one launch: the kernel and its "
        f"cluster merge)")
    log(f"    byte bound {bytes_ms:.5f} ms ({nbytes} B at 3.35 TB/s), op "
        f"bound {ops_ms:.6f} ms -> bound {bound_ms:.5f} ms (bytes)")
    log(f"    plain version (ragged_decode_reference) {plain_ms:.4f} ms; "
        f"library yardstick (scaled_dot_product_attention, full slab + "
        f"keep mask) {library_ms:.4f} ms")
    log(f"  engine, phase 4 [card: {card}]: "
        f"{engine_run['tokens_per_s']:.1f} tokens/s, decode "
        f"{engine_run['decode_ms_per_token']:.3f} ms/token (per decode "
        f"step), TTFT p50 {engine_run['ttft_p50_s'] * 1e3:.1f} ms, p99 "
        f"{engine_run['ttft_p99_s'] * 1e3:.1f} ms")
    return {"ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "lengths": lengths}


def phase_paged_quant_numbers(torch, np, dec, card: str):
    """(e) K4, K5 and K6 at the phase-4 shapes and lengths (bf16 queries;
    K4 over bf16 pages, K5/K6 over int8 codes with f32 scales; pages of
    64 rows at shuffled ids): the wrapper's median (one launch, the
    merge inside it), the plain version (the full-slab reference), the
    library yardstick (gather and/or dequantise, then one
    `scaled_dot_product_attention` with the keep mask; timed only, never
    on the path), and the bound from this run's lengths."""
    from paddle_tpu_torch.quantization.kv import kv_dequant, kv_quantize
    F = torch.nn.functional
    S, T, nh, hd = 8, 1024, 12, 64
    lengths = serving_lengths(np, T)
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(S, nh, hd, device="cuda", generator=gen).bfloat16()
    kc = torch.randn(S, T, nh, hd, device="cuda", generator=gen).bfloat16()
    vc = torch.randn(S, T, nh, hd, device="cuda", generator=gen).bfloat16()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kq, ks = kv_quantize(kc)
    vq, vs = kv_quantize(vc)
    tables, npages, _ = page_tables(torch, gen, S, T, lengths, PAGE)
    kp, vp, kqp, vqp, ksp, vsp = (to_pages(torch, x, tables, npages, PAGE)
                                  for x in (kc, vc, kq, vq, ks, vs))
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    keep = (torch.arange(T, device="cuda")[None, :]
            < lens[:, None].long())[:, None, None]           # (B,1,1,T)

    def gather(pool):
        return pool[tables.long()].reshape(S, T, *pool.shape[2:])

    def sdpa(k_, v_):
        return F.scaled_dot_product_attention(
            q[:, :, None], k_.permute(0, 2, 1, 3), v_.permute(0, 2, 1, 3),
            attn_mask=keep)[:, :, 0]

    bf = torch.bfloat16
    cases = {
        "K4": dict(
            run=lambda: dec.paged_ragged_decode_attention(q, kp, vp, tables,
                                                          lens),
            blocks=dec.pick_paged_decode_blocks(T, PAGE, hd, bf),
            plain=lambda: dec.paged_decode_reference(q, kp, vp, tables,
                                                     lens),
            library=lambda: sdpa(gather(kp), gather(vp)),
            library_what="gather pages + scaled_dot_product_attention",
            row_bytes=hd * 2, ops_per_elem=4, tables=True),
        "K5": dict(
            run=lambda: dec.ragged_decode_attention(q, kq, vq, lens,
                                                    k_scale=ks, v_scale=vs),
            blocks=dec.pick_decode_blocks(T, hd, torch.int8),
            plain=lambda: dec.ragged_decode_reference(
                q, kq, vq, lens, k_scale=ks, v_scale=vs),
            library=lambda: sdpa(kv_dequant(kq, ks, bf),
                                 kv_dequant(vq, vs, bf)),
            library_what="dequantise + scaled_dot_product_attention",
            row_bytes=hd + 4, ops_per_elem=6, tables=False),
        "K6": dict(
            run=lambda: dec.paged_ragged_decode_attention(
                q, kqp, vqp, tables, lens, k_scale=ksp, v_scale=vsp),
            blocks=dec.pick_paged_decode_blocks(T, PAGE, hd, torch.int8),
            plain=lambda: dec.paged_decode_reference(
                q, kqp, vqp, tables, lens, k_scale=ksp, v_scale=vsp),
            library=lambda: sdpa(kv_dequant(gather(kqp), gather(ksp), bf),
                                 kv_dequant(gather(vqp), gather(vsp), bf)),
            library_what="gather + dequantise + "
                         "scaled_dot_product_attention",
            row_bytes=hd + 4, ops_per_elem=6, tables=True)}
    live = sum(min(n, T) for n in lengths)
    log(f"  K4/K5/K6 at phase-4 shapes (B=S={S}, T={T}, nh={nh}, hd={hd}, "
        f"bf16 queries, page {PAGE}, lengths {lengths}) [card: {card}]")
    out = {}
    for name, c in cases.items():
        bk, ns = c["blocks"]
        ms = time_ms(torch, c["run"], flush)
        plain_ms = time_ms(torch, c["plain"], flush)
        library_ms = time_ms(torch, c["library"], flush)
        torch.testing.assert_close(c["library"]().float(), c["run"]().float(),
                                   **TOL["bfloat16"])
        # K and V of the live rows (int8: codes + one f32 scale per row
        # and head), q in, output out, lengths, the page tables
        nbytes = (2 * live * nh * c["row_bytes"] + 2 * S * nh * hd * 2
                  + 4 * S + (4 * tables.numel() if c["tables"] else 0))
        flops = c["ops_per_elem"] * live * nh * hd
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / FP32_FLOPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        C = dec.cluster_size(T)
        log(f"    {name} (reference picks block_k {bk}, splits {ns}; "
            f"{C} CTAs per lane and head, {C * nh * S} CTAs): "
            f"wrapper median {ms:.4f} ms (one launch); "
            f"bound {bound_ms:.5f} ms ({nbytes} B at 3.35 TB/s; "
            f"{flops} fp32 ops = {ops_ms:.6f} ms); plain {plain_ms:.4f} ms; "
            f"library ({c['library_what']}) {library_ms:.4f} ms")
        out[name] = {"ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations", "bytes": nbytes,
                     "block_k": bk, "num_splits": ns}
    del flush
    torch.cuda.empty_cache()
    return out


def phase_int8_numbers(torch, k7, card: str):
    """K7 at each (k, n) of INT8_SHAPES and INT8_1P3B_SHAPES with 4 bf16
    rows (bf16 weight scales and bias, as the PTQ model holds them): the
    median after an L2 flush, the byte bound (weights, scales, bias and
    x read once, the output written once), the plain version, and two
    yardsticks that the port never calls: the bf16 `torch.matmul` with
    the fp weights (what int8 replaces) and `torch._int_mm` on rows
    padded to 32. Beside them, the timer's floor under the same
    `time_ms`: an empty kernel (also without the flush), a read-only
    stream over the shape's weight bytes, an empty launch in clusters of
    8 with one cluster barrier, and K7's timing variants without its
    quantize prologue, without its cluster merge, without its
    cross-thread reduction (merge included), and without both."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    no_flush = torch.empty(16, dtype=torch.uint8, device="cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    m, bf = 4, torch.bfloat16
    empty_ms = time_ms(torch, lambda: k7.timer_empty("cuda"), flush)
    empty_nf_ms = time_ms(torch, lambda: k7.timer_empty("cuda"), no_flush)
    cluster_ms = time_ms(torch, lambda: k7.timer_empty("cuda", 96, 8), flush)
    log(f"  the timer's floor [card: {card}]: an empty kernel reads "
        f"{empty_ms:.4f} ms after the 128 MB flush, {empty_nf_ms:.4f} ms "
        f"without it; 96 empty CTAs in clusters of 8 meeting at one "
        f"cluster barrier {cluster_ms:.4f} ms")
    out = {"floor": {"empty_ms": empty_ms, "empty_no_flush_ms": empty_nf_ms,
                     "empty_cluster8_ms": cluster_ms}}
    log(f"  K7 at 4 bf16 rows, bf16 scales and bias [card: {card}]")
    variants = (("no_prologue", k7.NO_PROLOGUE),
                ("no_merge", k7.NO_MERGE),
                ("no_reduction", k7.NO_REDUCTION),
                ("neither", k7.NO_PROLOGUE | k7.NO_REDUCTION))
    for k, n in INT8_SHAPES + INT8_1P3B_SHAPES:
        x, qw, ws, sx, biases = int8_inputs(torch, gen, m, k, n, bf)
        b = biases["bf16 bias"]
        w = torch.randn(k, n, device="cuda", generator=gen).to(bf)
        q32 = torch.randint(-127, 128, (32, k), generator=gen,
                            device="cuda", dtype=torch.int8)
        ms = time_ms(torch, lambda: k7.int8_linear_fused(x, qw, ws, sx, b),
                     flush)
        plain_ms = time_ms(torch, lambda: k7.int8_linear_plain(
            x, qw, ws, sx, b), flush)
        matmul_ms = time_ms(torch, lambda: torch.matmul(x, w), flush)
        try:
            int_mm_ms = time_ms(torch, lambda: torch._int_mm(q32, qw), flush)
        except RuntimeError as err:        # a yardstick only: log why not
            int_mm_ms = None
            log(f"    torch._int_mm {k}x{n} does not run: {err}")
        read_ms = time_ms(torch, lambda: k7.timer_stream_read(
            qw, sink, 4 * sms), flush)
        parts = {name: time_ms(torch, lambda: k7._launch_cuda(
            x, qw, ws, sx, b, parts=p), flush) for name, p in variants}
        # weights, bf16 scales and bias, the fp32 sx, x in, out out
        nbytes = k * n + 2 * n + 2 * n + 4 + 2 * m * k + 2 * m * n
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * m * k * n / INT8_OPS * 1e3
        log(f"    {k}x{n} {k7.launch_plan(m, k, n, sms)}: median {ms:.4f} "
            f"ms; bound {bound:.5f} ms "
            f"(bytes: {nbytes} B; {2 * m * k * n} int8 ops = "
            f"{ops_ms:.6f} ms); floor: empty {empty_ms:.4f}, stream read "
            f"of the {k * n} weight bytes {read_ms:.4f} ms; variants: "
            + ", ".join(f"{name} {t:.4f}" for name, t in parts.items())
            + f" ms; plain {plain_ms:.4f} ms; bf16 torch.matmul "
            f"{matmul_ms:.4f} ms; torch._int_mm (32 rows) "
            f"{'-' if int_mm_ms is None else f'{int_mm_ms:.4f}'} ms")
        out[f"{k}x{n}"] = {"ms": ms, "plain_ms": plain_ms,
                           "bound_ms": max(bound, ops_ms), "bytes": nbytes,
                           "stream_read_ms": read_ms,
                           **{f"{name}_ms": t for name, t in parts.items()},
                           "bf16_matmul_ms": matmul_ms,
                           "int_mm_ms": int_mm_ms}
    del flush
    torch.cuda.empty_cache()
    return out


def flash_bound(b, sq, sk, h, d, causal, n_products, n_q, n_k,
                itemsize=2, peak=BF16_FLOPS):
    """(bound ms, "bytes" | "operations", bytes, flops) of a flash call:
    `n_q` (b, sq, h, d) and `n_k` (b, sk, h, d) tensors of `itemsize`
    bytes each read or written once, plus the fp32 (b, h, sq)
    logsumexp, over 3.35 TB/s; 2 d flops per product per visible
    (query, key) pair (under the causal rule only the pairs this shape
    keeps: q + sk - sq >= j), over the peak of the inputs' type (bf16
    tensor cores; fp32 67 TFLOP/s, or TF32's 495 with three products
    per product)."""
    if causal:
        off = sk - sq
        pairs = sum(min(q + off + 1, sk) for q in range(sq))
    else:
        pairs = sq * sk
    flops = n_products * 2 * d * pairs * b * h
    nbytes = itemsize * b * h * d * (n_q * sq + n_k * sk) + 4 * b * h * sq
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), nbytes, flops


def phase_flash_numbers(torch, fa, card: str, built):
    F = torch.nn.functional
    f = FLASH_SHAPE
    b, s_, h, d = f["b"], f["s"], f["h"], f["d"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, g = flash_inputs(torch, gen, b, s_, s_, h, d, packed=True)
    scale = 1 / math.sqrt(d)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out, lse = fa._launch_fwd(q, k, v, True, scale)
    fwd_ms = time_ms(torch, lambda: fa._launch_fwd(q, k, v, True, scale),
                     flush, reps=20)
    bwd_ms = time_ms(torch, lambda: fa._launch_bwd(q, k, v, out, lse, g,
                                                   True, scale), flush,
                     reps=20)
    # K3's three kernels one at a time (dk/dv and dq read the rows the
    # delta kernel wrote)
    rows = fa._bwd_rows(b, h, s_, "cuda")
    parts = {name: time_ms(torch, lambda: fa._launch_bwd(
        q, k, v, out, lse, g, True, scale, parts=part, rows=rows), flush,
        reps=20) for name, part in (("delta", fa.BWD_DELTA),
                                    ("dk/dv", fa.BWD_DKDV),
                                    ("dq", fa.BWD_DQ))}
    fwd_plain = time_ms(torch, lambda: fa.flash_forward_plain(
        q, k, v, True, scale), flush, reps=5)
    bwd_plain = time_ms(torch, lambda: fa.flash_backward_plain(
        q, k, v, out, lse, g, True, scale), flush, reps=5)
    # yardstick: one PyTorch call of the same function, (b, h, s, d)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    torch.testing.assert_close(lib_out.transpose(1, 2).float(), out.float(),
                               **TOL["bfloat16"])
    fwd_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), flush, reps=20)
    gt = g.transpose(1, 2)
    bwd_lib = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), gt, retain_graph=True), flush, reps=20)
    # K2: q.k and p.v; reads q, k, v, writes out and lse. K3: the five
    # products of the merged TPU kernel (s, dp, dv, dk, dq); reads q, k,
    # v, out, g and lse, writes dq, dk, dv
    fwd_bound = flash_bound(b, s_, s_, h, d, True, 2, n_q=2, n_k=2)
    bwd_bound = flash_bound(b, s_, s_, h, d, True, 5, n_q=4, n_k=4)
    log(f"  K2/K3 at the training shape (b {b}, s {s_}, h {h}, d {d}, "
        f"causal, bf16, packed qkv) [card: {card}]")
    for name, ms, plain, lib, (bound, by, nbytes, flops) in (
            ("K2 forward", fwd_ms, fwd_plain, fwd_lib, fwd_bound),
            ("K3 backward", bwd_ms, bwd_plain, bwd_lib, bwd_bound)):
        log(f"    {name}: median {ms:.4f} ms; bound {bound:.4f} ms "
            f"({by}: {nbytes} B, {flops / 1e9:.2f} GFLOP); plain "
            f"{plain:.3f} ms; scaled_dot_product_attention {lib:.4f} ms")
    log("    K3 parts, each kernel alone: " + ", ".join(
        f"{name} {ms:.4f} ms" for name, ms in parts.items()))
    info = {f"{tname} d {dd}": fa.kernel_info(dd, getattr(torch, tname))
            for tname in ("bfloat16", "float16", "float32")
            for dd in (32, 64, 128)}
    for dd, kernels in info.items():
        log(f"    {dd}: " + "; ".join(
            f"{name} {regs} registers, {local} local (spill) bytes, "
            f"{smem} B dynamic shared memory, {threads} threads"
            for name, (regs, local, smem, threads) in kernels.items()))
    log("    nvcc: " + (", ".join(
        f"{name} {sec:.1f} s" for name, sec in sorted(built.items())
        if name.startswith("flash")) or "cached, not built in this run"))
    del q, k, v, g, out, lse, qt, kt, vt, lib_out, flush, rows
    torch.cuda.empty_cache()
    return {"fwd": {"ms": fwd_ms, "plain_ms": fwd_plain,
                    "library_ms": fwd_lib, "bound_ms": fwd_bound[0],
                    "bound_by": fwd_bound[1]},
            "bwd": {"ms": bwd_ms, "plain_ms": bwd_plain,
                    "library_ms": bwd_lib, "bound_ms": bwd_bound[0],
                    "bound_by": bwd_bound[1]},
            "bwd_parts_ms": parts,
            "kernel_info": {dd: {n: list(v) for n, v in kernels.items()}
                            for dd, kernels in info.items()},
            "nvcc_s": {n: t for n, t in built.items()
                       if n.startswith("flash")}}


# the other timed rows: the tf32x3 route at GPT-small's fp32 training
# shape (phase 6b), the wgmma route at phase 3's bf16 head dim 32 case,
# the wgmma_f16 route at the training shape and the wgmma route at
# ERNIE's non-causal encoder shape (phases 6k, 6l); (name, b, s, h, d,
# dtype, causal)
ROUTE_TIMING = (("fp32 d 64, GPT-small training shape", FLASH_SHAPE["b"],
                 FLASH_SHAPE["s"], FLASH_SHAPE["h"], 64, "float32", True),
                ("bf16 d 32", 4, 512, 24, 32, "bfloat16", True),
                ("fp16 d 64, GPT-small training shape", FLASH_SHAPE["b"],
                 FLASH_SHAPE["s"], FLASH_SHAPE["h"], 64, "float16", True),
                ("bf16 d 64, ERNIE shape", ERNIE_SHAPE["b"],
                 ERNIE_SHAPE["s"], ERNIE_SHAPE["h"], ERNIE_SHAPE["d"],
                 "bfloat16", False),
                ("bf16 d 128, gpt_1p3b rank shape", P1B_RANK_SHAPE["b"],
                 P1B_RANK_SHAPE["s"], P1B_RANK_SHAPE["h"],
                 P1B_RANK_SHAPE["d"], "bfloat16", True)) + tuple(
    (name, b_, s_, h_, 128, "bfloat16", causal_)
    for name, (b_, s_, h_, causal_, _) in MP_FLASH_SHAPES.items())
ERNIE_TIMING = ROUTE_TIMING[3][0]
P1B_TIMING = ROUTE_TIMING[4][0]


def phase_flash_route_numbers(torch, fa, card: str):
    """K2/K3 at ROUTE_TIMING's shapes (packed qkv), first held
    against their plain versions there (`hold_flash`), then forward and
    backward medians after an L2 flush (fp32: the split kernel's share
    timed alone too) beside their bounds (fp32: three TF32 products per
    product over 495 TFLOP/s, and the FFMA bound over 67 TFLOP/s; bf16
    and fp16 over the tensor cores' peak, 989 TFLOP/s for either), the
    plain versions and
    `scaled_dot_product_attention` (a yardstick only, with TF32 off)."""
    F = torch.nn.functional
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(9)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for name, b, s_, h, d, tname, causal in ROUTE_TIMING:
        dtype = getattr(torch, tname)
        fp32 = dtype == torch.float32
        packed = MP_FLASH_SHAPES[name][4] if name in MP_FLASH_SHAPES \
            else True
        q, k, v, g = flash_inputs(torch, gen, b, s_, s_, h, d, packed,
                                  dtype)
        scale = 1 / math.sqrt(d)
        route = fa._check_cuda_args(q, k, v, causal)
        check(route == fa._ROUTE_OF_DTYPE[dtype], f"{name}: route {route}")
        o, lse = fa._launch_fwd(q, k, v, causal, scale)
        held = hold_flash(torch, fa, name, q, k, v, g, causal, scale, o,
                          lse, fa._launch_bwd(q, k, v, o, lse, g, causal,
                                              scale))
        fwd_ms = time_ms(torch, lambda: fa._launch_fwd(q, k, v, causal,
                                                       scale), flush,
                         reps=10)
        bwd_ms = time_ms(torch, lambda: fa._launch_bwd(q, k, v, o, lse, g,
                                                       causal, scale),
                         flush, reps=10)
        split, parts = {}, {}
        if fp32:    # the split kernel alone, and each backward kernel
            from paddle_tpu_torch.ops_cuda._build import load_library
            lib = load_library("flash_attention_fwd", fa._FWD_SIGNATURES)
            sc = fa._scratch(lib, "fwd", q, k)
            split["forward"] = time_ms(torch, lambda: fa._launch_fwd(
                q, k, v, causal, scale, parts=fa.FWD_SPLIT, scratch=sc),
                flush, reps=10)
            lib = load_library("flash_attention_bwd", fa._BWD_SIGNATURES)
            sc = fa._scratch(lib, "bwd", q, k)
            rows = fa._bwd_rows(b, h, s_, "cuda")
            fa._launch_bwd(q, k, v, o, lse, g, causal, scale, rows=rows,
                           scratch=sc)
            for pname, bit in (("split", fa.BWD_SPLIT),
                               ("delta", fa.BWD_DELTA),
                               ("dk/dv", fa.BWD_DKDV), ("dq", fa.BWD_DQ)):
                parts[pname] = time_ms(torch, lambda: fa._launch_bwd(
                    q, k, v, o, lse, g, causal, scale, parts=bit,
                    rows=rows, scratch=sc), flush, reps=10)
            split["backward"] = parts["split"]
            del sc, rows
        fwd_plain = time_ms(torch, lambda: fa.flash_forward_plain(
            q, k, v, causal, scale), flush, reps=3)
        bwd_plain = time_ms(torch, lambda: fa.flash_backward_plain(
            q, k, v, o, lse, g, causal, scale), flush, reps=3)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal)
        fwd_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), flush, reps=10)
        bwd_lib = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), g.transpose(1, 2), retain_graph=True),
            flush, reps=10)
        isz = 4 if fp32 else 2
        log(f"  {route} route, {name} (b {b}, s {s_}, h {h}, d {d}, causal "
            f"{causal}{LAYOUT_NOTE.get(packed, '')}) [card: {card}]: "
            f"against the plain "
            f"versions, out "
            f"max err {held['out_rel']:.2e} of max|plain|, dq/dk/dv "
            + "/".join(f"{r:.2e}" for r in held["grad_rel"])
            + f" (limit {held['limit']:g})")
        rec = {"held": held}
        for part, ms, plain, lib, n_prod, n_io in (
                ("forward", fwd_ms, fwd_plain, fwd_lib, 2, 2),
                ("backward", bwd_ms, bwd_plain, bwd_lib, 5, 4)):
            if fp32:
                bound, by, nbytes, flops = flash_bound(
                    b, s_, s_, h, d, causal, 3 * n_prod, n_io, n_io, isz,
                    TF32_FLOPS)
                ffma = flash_bound(b, s_, s_, h, d, causal, n_prod, n_io,
                                   n_io, isz, FP32_FLOPS)[0]
                extra = (f"; FFMA bound {ffma:.4f} ms; split kernel alone "
                         f"{split[part]:.4f} ms ({split[part] / ms:.1%})")
            else:
                bound, by, nbytes, flops = flash_bound(
                    b, s_, s_, h, d, causal, n_prod, n_io, n_io, isz,
                    BF16_FLOPS)
                ffma, extra = None, ""
            log(f"    {part}: median {ms:.4f} ms; bound {bound:.4f} ms "
                f"({by}: {nbytes} B, {flops / 1e9:.2f} GFLOP){extra}; plain "
                f"{plain:.3f} ms; scaled_dot_product_attention "
                f"{lib:.4f} ms")
            rec[part] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                         "bound_ms": bound, "bound_by": by,
                         "ffma_bound_ms": ffma, "split_ms": split.get(part)}
        if parts:
            log("    backward parts, each alone: " + ", ".join(
                f"{pname} {ms:.4f} ms" for pname, ms in parts.items()))
            rec["backward_parts_ms"] = parts
        out[name] = rec
        del q, k, v, g, o, lse, qt, kt, vt, lib_out
        torch.cuda.empty_cache()
    del flush
    return out


def main(argv=None) -> int:
    t_main = time.time()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number to this JSON "
                                  "file")
    ap.add_argument("--profile", action="store_true",
                    help="also profile 3 training steps by kernel "
                         "(torch.profiler) after phase 6")
    ap.add_argument("--worker", choices=("gang", "elastic"),
                    help=argparse.SUPPRESS)   # phases 9a / 9b's workers
    ap.add_argument("--result", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt", help=argparse.SUPPRESS)
    ap.add_argument("--vision-only", action="store_true",
                    help="run only phases 11a-11d (a quick check of that "
                         "path; prints no result line)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if args.worker:
        torch.cuda.init()
        return worker_main(args, {"main": t_main, "cuda": time.time()})
    import numpy as np
    import paddle_tpu_torch as P
    from paddle_tpu_torch.ops_cuda import _build
    from paddle_tpu_torch.ops_cuda import decode_attention as dec
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    from paddle_tpu_torch.ops_cuda import int8_linear as k7

    t_start = time.perf_counter()
    card = card_line()
    log(f"phase 1: card {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    if args.vision_only:
        run_vision_phases(torch, np, P, card)
        log(card_line())
        return 0
    t0 = time.perf_counter()
    built = _build.build(verbose=True)
    log(f"  built {sorted(built) or 'nothing (cached)'} with nvcc "
        f"{' '.join(_build.NVCC_FLAGS)} in {time.perf_counter() - t0:.1f} s")

    log("phase 2: K1 against its plain version")
    max_err = phase_kernel(torch, dec)
    log("phase 2a: K4, K5 and K6 against their plain versions")
    pq_err = phase_paged_quant_kernels(torch, np, dec)
    log("phase 2b: K7 against its plain version, bitwise")
    k7_err = phase_int8_kernel(torch, k7)
    log("phase 3: K2 and K3 against their plain versions")
    flash_err = phase_flash_kernels(torch, fa)
    log("phase 3b: the tensor cores' TF32 arithmetic")
    probe = phase_tf32_probe(torch, fa)
    log("phase 4: GPT-small served at full width through K1")
    engine_run = phase_engine(torch, np, P)
    log("phase 4b: the same load through K4 (paged), K5 (int8), K6 "
        "(paged int8)")
    variants = phase_engine_variants(torch, np, dec, engine_run)
    log("phase 4c: paged int8 starved of pages (kv_pages = 49)")
    pressure = phase_page_pressure(torch, dec, engine_run,
                                   variants["K6"]["streams"])
    log("phase 4d: an int8-PTQ GPT-small served through K7")
    int8_run = phase_int8_serving(torch, np, P, dec, k7, engine_run)
    log("phase 4e: speculation on == off, GPT-small bf16")
    spec = phase_speculative(torch, np, dec, k7, engine_run)
    log("phase 4f: the dispatch loop: graph == eager, overlap on == off, "
        "injected faults")
    dispatch = phase_dispatch(torch, np, dec, k7, engine_run, variants,
                              int8_run, spec)
    log("phase 4g: admission: the prefix cache, interleaved chunked "
        "prefill, snapshot / resume, extract / adopt")
    admission = phase_admission(torch, np, dec, engine_run)
    log("phase 4h: the open-loop serving bench, monolithic and "
        "interleaved admission")
    openloop = phase_openloop(torch, np, engine_run)
    log("phase 4i: best-of-n fork groups (the reference's bestof load)")
    bestof = phase_bestof(torch, np, dec, engine_run)
    log("phase 4j: the generation surface: generate, generate_jit and "
        "beam_search as CUDA graphs")
    generation = phase_generation(torch, np, k7, engine_run,
                                  int8_run["model"])
    log("phase 4k: observability, host swap, page payloads and the "
        "serving artifact")
    obs_swap = phase_obs_swap(torch, np, dec, k7, engine_run, variants,
                              int8_run)
    log("phase 4l: the replica fleet: the KV tier A/B, the autoscale "
        "load and the kill soak")
    fleet = phase_fleet(torch, np, dec, engine_run)
    log("phase 4m: the HTTP front door: K4 / K6 at 8-row pages, the "
        "front-door soak in six configurations")
    front_door = phase_front_door(torch, np, dec, k7, engine_run)
    log("phase 4n: TP-sharded serving at tp 2 and 4 on the one card: K1 "
        "/ K4 per shard, K1 / K4 / K5 / K6 per rank, snapshot, a fleet of "
        "TP groups, the front-door soak at --tp 2")
    tp_run = phase_tp(torch, np, dec, k7, engine_run, variants)
    del engine_run["model"], variants["K1"], int8_run["model"]
    torch.cuda.empty_cache()
    log("phase 5: ragged vs masked attention, fp32")
    rvm = phase_ragged_vs_masked(torch, np, P)
    log("phase 5d: paged vs slotted greedy streams, fp32 weights")
    pvs = phase_paged_vs_slotted(torch, np, P)
    log("phase 6: GPT-small trained at full width through K2 and K3")
    train = phase_train(torch, np, P, profile=args.profile)
    log("phase 6b: fp32 training at amp_level=None through the tf32x3 "
        "route (gpt_tiny against the CPU, GPT-small timed), gpt_tiny O2 "
        "through the wgmma route")
    train32 = phase_train_fp32(torch, np, P)
    log("phase 6c: GPT-small O2 fp16 with a GradScaler, a scheduled and "
        "clipped AdamW, through the wgmma_f16 route")
    train16 = phase_train_fp16(torch, np, P, train)
    log("phase 6d: O1 on GPT-small, bf16 and fp16 with a GradScaler")
    train_o1 = phase_train_o1(torch, np, P)
    log("phase 6e: dropout (dense attention) and remat on GPT-small")
    dropout = phase_dropout_remat(torch, np, P)
    log("phase 6f: the 10 optimizer rules, gpt_tiny on the card vs the CPU")
    rules = phase_rules(torch, np, P)
    log("phase 6g: ResNet-50 at bench.py's configuration through "
        "Trainer.train_steps (O2 bf16, bs 128 x 224^2)")
    resnet = phase_resnet50(torch, np, P, card)
    log("phase 6h: config 1 through hapi.Model.fit over the DataLoader of "
        "synthetic CIFAR-10")
    resnet_fit = phase_resnet_fit(torch, np, P, card)
    log("phase 6i: ResNet-18 card vs CPU (fp32, TF32 off), NHWC == NCHW "
        "and stem_s2d == conv1 on the card")
    resnet_cpu = phase_resnet_card_vs_cpu(torch, np, P)
    log("phase 6j: ERNIE-3.0-base at bench.py's configuration through "
        "Trainer.train_steps (O2 bf16, bs 64 x 128, dropout 0.1: dense "
        "attention)")
    ernie = phase_ernie(torch, np, P, card)
    log("phase 6k: ERNIE-base through K2/K3 (attention_dropout 0), an eval "
        "forward, the finetune_bert loop")
    ernie_k = phase_ernie_kernels(torch, np, P, card, ernie)
    log("phase 6l: padded Imdb batches through hapi.Model.fit, the MLM "
        "head, a 2-layer BERT card vs CPU with and without a mask")
    ernie_pad = phase_ernie_padded(torch, np, P, card)
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        t_cap = time.perf_counter()
        log("phase 6m: ResNet-50 through jit.to_static (fp32, TF32 off): "
            "eval forward and one Momentum step against eager")
        captured = phase_to_static_resnet(torch, np, P, card)
        log("phase 6n: jit.save(ResNet-50) and a fresh-process Predictor "
            "on the card at batches 1, 8 and 64")
        predicted = phase_predictor_resnet(torch, np, P, card, tmp)
        torch.cuda.empty_cache()
        log("phase 6o: ERNIE-base exported: the Predictor through K2, the "
            "loaded layer fine-tuned through K2/K3")
        exported = phase_export_ernie(torch, np, P, card, tmp, ernie_k)
        log("phase 6p: dy2static on the card: exported control flow == "
            "eager, served eagerly by the Predictor")
        cflow = phase_dy2static_card(torch, np, P, card, tmp)
        capture_s = time.perf_counter() - t_cap
        log(f"  phases 6m-6p took {capture_s:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t_par = time.perf_counter()
    log("phase 6q: parallel/ on the card: the collectives, GPT-small fp32 "
        "under dp 2 x fsdp 2 at ZeRO stages 1-3 == one rank, O2 stage 2")
    mesh_run = phase_mesh(torch, np, P, card)
    log("phase 6r: config 4, DP ResNet-50 over 4 ranks with synced batch "
        "norm (O2 bf16, bs 128 x 224^2); fp32 4 ranks == one rank")
    dp_resnet = phase_dp_resnet50(torch, np, P, card)
    log("phase 6s: config 5, gpt_1p3b ZeRO stage 2 over 4 ranks through "
        "fleet (O2 bf16, AdamW, 8 x 2048 tokens) through K2/K3")
    p1b = phase_p1b(torch, np, P, card)
    parallel_s = time.perf_counter() - t_par
    log(f"  phases 6q-6s took {parallel_s:.1f} s")
    t_mp = time.perf_counter()
    log("phase 6t: tensor parallelism: GPT-small fp32 dp 2 x tp 2 == one "
        "rank, gpt_1p3b O2 bf16 dp 2 x tp 2 (8 x 2048 tokens) through "
        "K2/K3")
    tp_train, p1b_model = phase_tp_train(torch, np, P, card)
    log("phase 6u: sequence parallelism: GPT-small width at seq 4096, ring "
        "and Ulysses at sp 4 == sp 1; gpt_1p3b O2 bf16 at sp 4 (2 x 2048)")
    sp_train = phase_sp_train(torch, np, P, card, p1b_model)
    del p1b_model
    torch.cuda.empty_cache()
    log("phase 6v: pipeline parallelism: 12 GPT-small blocks at pp 4, v 1 "
        "and 3 == the sequential stack")
    pp_train = phase_pp_train(torch, np, P, card)
    log("phase 6w: expert parallelism: MoE (8 experts, top-2) ep 4 == "
        "dense, an O2 bf16 step")
    moe_train = phase_moe_train(torch, np, P, card)
    mp_s = {"6t": tp_train["seconds"], "6u": sp_train["seconds"],
            "6v": pp_train["seconds"], "6w": moe_train["seconds"],
            "all": time.perf_counter() - t_mp}
    log(f"  phases 6t-6w took {mp_s['all']:.1f} s (6t {mp_s['6t']:.1f}, "
        f"6u {mp_s['6u']:.1f}, 6v {mp_s['6v']:.1f}, 6w {mp_s['6w']:.1f})")
    t_rest = time.perf_counter()
    log("phase 6x: compressed_grad_step (int8 error feedback) on GPT-small "
        "over dp 2 == its formula bitwise, near exact dp")
    compressed = phase_compressed(torch, np, P, card, fa)
    log("phase 6y: LocalSGD on GPT-small over dp 2, k 4, 2 rounds: one "
        "exchange a round")
    lsgd = phase_localsgd(torch, np, P, card, fa)
    log("phase 6z: a multi-slice mesh == init_mesh bitwise; auto.Engine; "
        "Calibrator.fit over time_step_fn")
    mslice = phase_multislice_auto(torch, np, P, card)
    log("phase 9a: launch_local of 2 processes on the card: the gloo "
        "host plane, a dp 2 mesh spanning them == one process bitwise")
    gang = phase_gang(torch, np, P, card)
    log("phase 9b: ElasticController: a worker dies, the gang relaunches "
        "and resumes from AutoCheckpoint, losses == an uninterrupted run")
    elastic = phase_elastic(torch, np, P, card)
    rest_s = {"6x": compressed["seconds"], "6y": lsgd["seconds"],
              "6z": mslice["seconds"], "9a": gang["seconds"],
              "9b": elastic["seconds"], "all": time.perf_counter() - t_rest}
    log(f"  phases 6x-6z and 9a-9b took {rest_s['all']:.1f} s")
    t_surface = time.perf_counter()
    log("phase 10a: the op sweep on the card: every case of "
        "testing/op_cases.py against the CPU, the random laws, GPT-small's "
        "sizes")
    sweep = phase_op_sweep(torch, np, P, card)
    log("phase 10b: functional autograd on GPT-small (bf16, 18 x 1024): "
        "pt.value_and_grad over pt.functional_call through K2/K3 == "
        "torch.autograd.grad bitwise; jacobian, hessian, jvp, vjp, PyLayer")
    fgrad = phase_functional_autograd(torch, np, P, card)
    surface_s = {"10a": sweep["seconds"], "10b": fgrad["seconds"],
                 "all": time.perf_counter() - t_surface}
    log(f"  phases 10a-10b took {surface_s['all']:.1f} s (10a "
        f"{surface_s['10a']:.1f}, 10b {surface_s['10b']:.1f})")
    vision = run_vision_phases(torch, np, P, card)
    log("phase 7: gradients through the kernels vs the plain versions")
    grad = {tname: phase_grad_check(torch, np, P, tname)
            for tname in ("bfloat16", "float16")}
    log("phase 8: numbers")
    nums = phase_numbers(torch, dec, engine_run, card)
    pqnums = phase_paged_quant_numbers(torch, np, dec, card)
    for name, run in variants.items():
        log(f"  engine through {name}, phase 4b [card: {card}]: "
            f"{run['tokens_per_s']:.1f} tokens/s, decode "
            f"{run['decode_ms_per_token']:.3f} ms/token (per decode step), "
            f"TTFT p50 {run['ttft_p50_s'] * 1e3:.1f} ms, kv_bytes_per_token"
            f" {run['kv_bytes_per_token']:.0f}")
    fnums = phase_flash_numbers(torch, fa, card, built)
    rnums = phase_flash_route_numbers(torch, fa, card)
    k7nums = phase_int8_numbers(torch, k7, card)
    log(f"  engine, int8-PTQ GPT-small through K7, phase 4d [card: {card}]: "
        f"{int8_run['tokens_per_s']:.1f} tokens/s, decode "
        f"{int8_run['decode_ms_per_token']:.3f} ms/token (per decode step)")
    log(f"  training, phase 6 [card: {card}]: {train['step_ms']:.2f} ms per "
        f"step, {train['tokens_per_s']:.1f} tokens/s, peak memory "
        f"{train['peak_bytes'] / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    log(f"  training, phase 6c (O2 fp16, GradScaler) [card: {card}]: "
        f"{train16['step_ms']:.2f} ms per step, "
        f"{train16['tokens_per_s']:.1f} tokens/s, peak memory "
        f"{train16['peak_bytes'] / 2**30:.2f} GiB")
    log(f"  ResNet-50 training, phase 6g (O2 bf16, bs {RESNET_BATCH} x "
        f"{RESNET_SIZE}^2) [card: {card}]: {resnet['step_ms']:.2f} ms per "
        f"step, {resnet['images_per_s']:.1f} images/s, peak memory "
        f"{resnet['peak_bytes'] / 2**30:.2f} GiB, compute bound "
        f"{resnet['bound_ms']:.3f} ms; hapi fit, phase 6h: "
        f"{resnet_fit['images_per_s']:.1f} images/s with the loader")
    log(f"  ERNIE-base training, phase 6j (O2 bf16, bs "
        f"{ERNIE_SHAPE['b']} x {ERNIE_SHAPE['s']}, dense attention) "
        f"[card: {card}]: {ernie['step_ms']:.2f} ms per step, "
        f"{ernie['seq_per_s']:.1f} seq/s, peak memory "
        f"{ernie['peak_bytes'] / 2**30:.2f} GiB, compute bound "
        f"{ernie['bound_ms']:.3f} ms; 6k (K2/K3) {ernie_k['step_ms']:.2f} "
        f"ms per step; 6l hapi fit over padded Imdb "
        f"{ernie_pad['seq_per_s']:.1f} seq/s with the loader")
    log(f"  DP ResNet-50, phase 6r (O2 bf16, {DP_RANKS} ranks, bs "
        f"{RESNET_BATCH} x {RESNET_SIZE}^2, synced batch norm) [card: "
        f"{card}]: {dp_resnet['step_ms']:.2f} ms per step, "
        f"{dp_resnet['images_per_s']:.1f} images/s, peak memory "
        f"{dp_resnet['peak_bytes'] / 2**30:.2f} GiB, collectives per step "
        f"{dp_resnet['collectives_per_step']}")
    log(f"  gpt_1p3b ZeRO-2, phase 6s (O2 bf16, {P1B['ranks']} ranks, "
        f"{P1B['b']} x {P1B['s']} tokens) [card: {card}]: "
        f"{p1b['step_ms']:.1f} ms per step, {p1b['tokens_per_s']:.0f} "
        f"tokens/s, peak memory {p1b['peak_bytes'] / 2**30:.2f} GiB, "
        f"per-rank optimizer state "
        f"{p1b['rank_bytes'][0]['slots'] / 2**30:.3f} GiB")
    log(f"  gpt_1p3b dp 2 x tp 2, phase 6t (O2 bf16, {MP_P1B['b']} x "
        f"{MP_P1B['s']}) [card: {card}]: {tp_train['step_ms']:.1f} ms per "
        f"step, {tp_train['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{tp_train['peak_bytes'] / 2**30:.2f} GiB; 6u sp 4 ({SP_P1B['b']} "
        f"x {SP_P1B['s']}): ring {sp_train['ring']['step_ms']:.1f} ms, "
        f"Ulysses {sp_train['ulysses']['step_ms']:.1f} ms per step; 6w MoE "
        f"ep {MOE['ep']} step {moe_train['step_ms']:.1f} ms")

    log(f"  mobilenet_v2 training, phase 11b (fp32, bs {FIT_BATCH} x 224^2, "
        f"{FIT_WORKERS} loader threads) [card: {card}]: "
        f"{vision['fit']['step_ms']:.1f} ms per step, "
        f"{vision['fit']['images_per_s']:.1f} images/s, loader wait "
        f"{vision['fit']['loader_share']:.1%} of the wall, peak memory "
        f"{vision['fit']['peak_bytes'] / 2**30:.2f} GiB; int8 resnet50, "
        f"phase 11c (bs {QUANT_CALIB[1]} x 224^2): "
        f"{vision['quant']['int8_ms']:.2f} ms against float "
        f"{vision['quant']['float_ms']:.2f} ms per forward; phases "
        f"11a-11d {vision['seconds']['all']:.1f} s")

    flash = "paddle_tpu/ops_pallas/flash_attention.py"
    kernels = [{
        "name": "ragged_decode", "route": "cuda",
        "source": "paddle_tpu_torch/ops_cuda/csrc/decode_attention.cu",
        "replaces": "paddle_tpu/ops_pallas/decode_attention.py:225",
        "launches": engine_run["launches"], "max_abs_err": max_err,
        "ms": nums["ms"], "plain_ms": nums["plain_ms"],
        "bound_ms": nums["bound_ms"], "bound_by": nums["bound_by"],
        "library_ms": nums["library_ms"]}, {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/ops_cuda/csrc/flash_attention_fwd.cu",
        "replaces": f"{flash}:90", "launches": train["fwd_launches"],
        "max_abs_err": flash_err["fwd"], **fnums.pop("fwd")}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "paddle_tpu_torch/ops_cuda/csrc/flash_attention_bwd.cu",
        "replaces": f"{flash}:205", "launches": train["bwd_launches"],
        "max_abs_err": flash_err["bwd"], **fnums.pop("bwd")}]
    # the wgmma_f16 route: the same sources, fp16 at the training shape
    # (phase 6c's launches)
    f16_main = rnums[ROUTE_TIMING[2][0]]
    for part, line, key in (("fwd", 90, "forward"), ("bwd", 205,
                                                     "backward")):
        kernels.append({
            "name": f"flash_attention_fp16_{part}", "route": "cuda",
            "source": f"paddle_tpu_torch/ops_cuda/csrc/flash_attention_"
                      f"{part}.cu",
            "replaces": f"{flash}:{line}",
            "launches": train16[f"{part}_launches"],
            "max_abs_err": flash_err[f"fp16_{part}"],
            **{k: f16_main[key][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}})
    # the tf32x3 route: the same sources, fp32 at GPT-small's training
    # shape (phase 6b's launches); bound: three TF32 products per product
    tf32_main = rnums[ROUTE_TIMING[0][0]]
    for part, line, key in (("fwd", 90, "forward"), ("bwd", 205,
                                                     "backward")):
        kernels.append({
            "name": f"flash_attention_tf32x3_{part}", "route": "cuda",
            "source": f"paddle_tpu_torch/ops_cuda/csrc/flash_attention_"
                      f"{part}.cu",
            "replaces": f"{flash}:{line}",
            "launches": train32[f"{part}_launches"],
            "max_abs_err": flash_err[f"tf32x3_{part}"],
            **{k: tf32_main[key][k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")}})
    # the wgmma route at ERNIE's encoder shape (non-causal, packed qkv,
    # s 128): phase 6k's launches
    ernie_t = rnums[ERNIE_TIMING]
    for part, line, key in (("fwd", 90, "forward"), ("bwd", 205,
                                                     "backward")):
        kernels.append({
            "name": f"flash_attention_ernie_{part}", "route": "cuda",
            "source": f"paddle_tpu_torch/ops_cuda/csrc/flash_attention_"
                      f"{part}.cu",
            "replaces": f"{flash}:{line}",
            "launches": ernie_k[f"{part}_launches"],
            "max_abs_err": flash_err[f"ernie_{part}"],
            **{k: ernie_t[key][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}})
    # the wgmma route at gpt_1p3b's rank shape under config 5 (d 128,
    # causal, packed qkv, s 2048): phase 6s's launches
    p1b_t = rnums[P1B_TIMING]
    for part, line, key in (("fwd", 90, "forward"), ("bwd", 205,
                                                     "backward")):
        kernels.append({
            "name": f"flash_attention_1p3b_{part}", "route": "cuda",
            "source": f"paddle_tpu_torch/ops_cuda/csrc/flash_attention_"
                      f"{part}.cu",
            "replaces": f"{flash}:{line}",
            "launches": p1b[f"{part}_launches"],
            "max_abs_err": flash_err[f"1p3b_{part}"],
            **{k: p1b_t[key][k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}})
    # the model-parallel routes' shapes (phases 6t and 6u): the launches
    # of each main-path run; the ring's diagonal pairs are its causal
    # launches and the pairs below it its full ones, each counted
    ring = sp_train["ring"]
    for tag, name, launches in (
            ("tp", "gpt_1p3b tp 2 rank shape",
             (tp_train["fwd_launches"], tp_train["bwd_launches"])),
            ("ulysses", "gpt_1p3b Ulysses sp 4 rank shape",
             (sp_train["ulysses"]["fwd_launches"],
              sp_train["ulysses"]["bwd_launches"])),
            ("ring_diag", "gpt_1p3b ring diagonal pair",
             ring["causal_launches"]),
            ("ring", "gpt_1p3b ring pair below the diagonal",
             ring["full_launches"])):
        t_ = rnums[name]
        for i, (part, line, key) in enumerate((("fwd", 90, "forward"),
                                               ("bwd", 205, "backward"))):
            kernels.append({
                "name": f"flash_attention_{tag}_{part}", "route": "cuda",
                "source": f"paddle_tpu_torch/ops_cuda/csrc/flash_attention_"
                          f"{part}.cu",
                "replaces": f"{flash}:{line}",
                "launches": launches[i],
                "max_abs_err": flash_err[name][i],
                **{k: t_[key][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}})
    dpy = "paddle_tpu/ops_pallas/decode_attention.py"
    for name, line, what in (("K4", 258, "paged_decode"),
                             ("K5", 242, "ragged_decode_int8"),
                             ("K6", 279, "paged_decode_int8")):
        kernels.append({
            "name": what, "route": "cuda",
            "source": "paddle_tpu_torch/ops_cuda/csrc/decode_attention.cu",
            "replaces": f"{dpy}:{line}",
            "launches": variants[name]["launches"],
            "max_abs_err": pq_err[name],
            **{k: pqnums[name][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}})
    # K7's record: one GPT-small block's four linears at 4 bf16 rows
    # (the decode step's K7 work per layer); each shape is in --out. No
    # one PyTorch call computes the fused function (the bf16 matmul and
    # torch._int_mm yardsticks are logged beside it), so library_ms is
    # null
    block = [k7nums[f"{k}x{n}"] for k, n in INT8_SHAPES[:4]]
    kernels.append({
        "name": "int8_linear_fused", "route": "cuda",
        "source": "paddle_tpu_torch/ops_cuda/csrc/int8_linear.cu",
        "replaces": "paddle_tpu/quantization/__init__.py:92",
        "launches": int8_run["launches"], "max_abs_err": k7_err,
        "ms": sum(r["ms"] for r in block),
        "plain_ms": sum(r["plain_ms"] for r in block),
        "bound_ms": sum(r["bound_ms"] for r in block), "bound_by": "bytes",
        "library_ms": None})
    if args.out:
        def drop(run):
            return {k: drop(v) if isinstance(v, dict) else v
                    for k, v in run.items()
                    if k not in ("prompts", "params", "streams", "refs",
                                 "knobs", "model")}
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": kernels,
                       "timing_lengths": nums["lengths"],
                       "engine": drop(engine_run),
                       "engine_variants": {k: drop(v)
                                           for k, v in variants.items()},
                       "page_pressure": pressure,
                       "paged_quant_numbers": pqnums,
                       "ragged_vs_masked": rvm, "paged_vs_slotted": pvs,
                       "train": train, "grad_check": grad,
                       "int8_serving": drop(int8_run),
                       "speculative": drop(spec), "dispatch": dispatch,
                       "admission": admission, "openloop": openloop,
                       "bestof": bestof, "generation": generation,
                       "obs_swap": obs_swap, "fleet": fleet,
                       "front_door": front_door, "tp": tp_run,
                       "int8_numbers": k7nums, "flash_numbers": fnums,
                       "flash_route_numbers": rnums, "tf32_probe": probe,
                       "train_fp32": train32, "train_fp16": train16,
                       "train_o1": train_o1, "dropout_remat": dropout,
                       "optimizer_rules": rules, "resnet50": resnet,
                       "resnet_fit": resnet_fit,
                       "resnet_card_vs_cpu": resnet_cpu,
                       "ernie": ernie, "ernie_kernels": ernie_k,
                       "ernie_padded": ernie_pad,
                       "to_static_resnet": captured,
                       "predictor_resnet": predicted,
                       "export_ernie": exported, "dy2static": cflow,
                       "capture_phases_s": capture_s,
                       "mesh": mesh_run, "dp_resnet50": dp_resnet,
                       "gpt_1p3b_stage2": p1b,
                       "parallel_phases_s": parallel_s,
                       "tp_train": tp_train, "sp_train": sp_train,
                       "pp_train": pp_train, "moe_train": moe_train,
                       "model_parallel_phases_s": mp_s,
                       "compressed": compressed, "localsgd": lsgd,
                       "multislice_auto": mslice, "gang": gang,
                       "elastic": elastic, "rest_phases_s": rest_s,
                       "op_sweep": sweep, "functional_autograd": fgrad,
                       "surface_phases_s": surface_s,
                       "vision": vision,
                       "seconds": time.perf_counter() - t_start}, f,
                      indent=1)
    log(f"  whole run {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
