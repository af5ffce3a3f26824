#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one card: builds the attention
kernels from the sources in this checkout, holds each against its plain
PyTorch version, serves the full-width qwen2-1.5b with the 4-layer
parallel drafter through the kernels (whole batch, and continuous batching
over the paged KV layout), checks greedy losslessness, serves sampled
requests (seeded rejection verification) and checks their streams,
streams requests through the wall-clock front end (AsyncEngine, the NDJSON
server) and runs LLMEngine and the round-based baseline, trains the
full-width drafter (whole-sequence and Algorithm-1 segmented)
through the MTP kernel, and serves the rest of the dense family: gemma2-27b
at full width (GeGLU, softcaps, alternating local/global attention over
ring caches, post-norms, embedding scale), minitron-4b and gemma-7b (head
dim 256 through the decode, paged and flash kernels), the SSM family:
mamba2-780m at full width (chunked SSD, per-token recurrent snapshots
selected at the commit), the hybrid family: recurrentgemma-2b at full
width (RG-LRU, causal conv, MQA local attention at head dim 256), the
MoE family: dbrx-132b at full width on 8 of its 40 layers (sort-based
capacity dispatch, top-4 of 16 experts on every layer), the VLM family:
internvl2-1b at full width (256 stub vision tokens early-fused before
every prompt) and the encoder-decoder family: whisper-base at full width
(a bidirectional encoder over 1500 stub frames, cross-attention through
the flash and decode kernels), then the storage-sharded engine (built
leaf by leaf), the sharded drafter train step and AsyncEngine with rank 0
deciding on a one-rank nccl group, bitwise the unsharded ones,
llama4-maverick at full width on 2 of its 48 layers (interleaved MoE of
128 experts, top-1, beside a shared expert; chunked local attention), and
last the trained drafter from its checkpoint: the P-EAGLE and AR EAGLE-3
drafters trained through the training launcher and served from their
checkpoints through the serving launcher, against none and a random
drafter.

    python3 chip_smoke.py            # from the root of a checkout, on the card

Phases, in order; any failure exits non-zero:

1. card and build: the card's name and power limit (nvidia-smi), then the
   four kernels built with nvcc, all at once (build seconds, -Xptxas -v
   report);
2. kernels: each kernel against its plain version on the card at the
   serving path's shapes and at the JAX kernel sweep's shapes, on inputs
   whose scores spread as a trained model's do (tolerance: two bfloat16
   rounding steps of the output, 1e-4 + 2^-6 |plain|, in bfloat16; 1e-4 in
   float32; the worst share of the limit is printed per kernel), with the
   kernel, the plain version
   and one PyTorch call for the same function (scaled_dot_product_attention,
   a yardstick the port never calls) timed with CUDA events, beside the
   least time the card could take (bytes over 3.35 TB/s or FLOPs over the
   dtype's peak, whichever is larger). The bfloat16 decode, paged decode
   and flash kernels and the MTP kernel run tensor-core bodies (split-K
   decode, the same body through a block table for paged, FlashAttention-2
   style flash, a depth-split key walk in 3xTF32 for MTP), so their edges
   are checked too: decode with S not a multiple of the split chunk, chunks
   holding no live key, rows seeing no key (zeros, l 0, m -1e30), a window
   across chunks and T 511; paged with 64-key tiles over 8, 4 and 2 pages,
   nb x page not a multiple of 64, -1 and out-of-pool ids inside live
   tiles, one split and many, and tables all -1, one launch count a call;
   flash with ragged query and key tiles (500 tokens), one token,
   Sq != Skv and kv_len < Skv.
   Flash is timed at the prefill (B 8 x 512), a training tap (B 1 x 2048)
   and an admission bucket (B 1 x 512), decode at every serving phase
   (phase 3d's hit chunks included: T 256 / 255 against 320 live keys).
   The MTP kernel is held against its plain version, output and stats
   (m, l), at the training shape (n 2048, K 8, r 0.8: M 8522, the
   drafter's 12/12 heads), at the largest Algorithm-1 segment of n 4096 in
   4 segments (its depth-0 context before an interleaved block), at the
   JAX kernel sweep's shapes (per-row layouts, GQA, pad rows), on a COD
   layout in random order, on GQA segments, on a layout with no chain keys
   (K 1) and on a padding-rows case; its SDPA yardstick takes the dense
   predicate mask, built outside the timed call, and its time stands beside
   two bounds, both logged: f32 FLOPs at the f32 FMA peak, and the 3xTF32
   split's three TF32 products at the TF32 tensor-core peak; the kernels
   line's bound_ms is the smaller (for float32, the tensor-core one). The
   paged decode kernel is held against its plain version (which gathers
   each row's pages) at the serving path's phase-1 shapes (batch 8,
   page 16, 64 table entries a row, pages drawn at random from the pool, so
   tables are fragmented), with every row's first 20 table entries naming
   the same pages (phase 3d's shared prefix), and at the JAX kernel sweep's
   shapes; its library call is torch's compiled flex_attention over the
   pools, the table folded into a block mask of page-sized key blocks. Then the gradients of the flash training
   attention (kernel forward, recompute-by-block backward) against autograd
   through the plain version at M 1998, float32. gemma2-27b's attention
   too (query scale 144^-0.5, tanh softcap 50 on every score, 32 query
   heads over 16 KV heads): decode at verify phase 1 and 2, a local layer's
   ring of 4096 + 6 slots after position 4700 (wrapped, the window's edge
   inside a split chunk) and scores 8x larger; paged at verify phase 1;
   flash at the prefill (B 8 x 512) and past the window (B 1 x 4608, window
   4096); its drafter's draft and extend phase 1 (36/36 heads) uncapped, as
   the path runs them; in both dtypes; timed in bfloat16 beside their
   bounds. The library call of a capped case is torch's compiled
   flex_attention too (the cap as a score_mod, the positions and window as
   a block mask built outside the timed call), held against the plain
   version first and timed after the last phase (its compilation leaves a
   thread that slows the next host-bound phase); of an uncapped decode or
   flash case, SDPA. Head dim 256 (gemma-7b: 16/16 heads, query scale
   256^-0.5), both dtypes: decode at its verify phases 1 and 2 and an
   admission chunk of 128, paged at its verify phase 1, flash at its
   prefill (B 8 x 512) and an admission bucket (B 1 x 512), its drafter's
   draft (24/24 heads of 128), and the hd-256 bodies' edges (GQA 8/2 with
   a window across chunks, 40 rows in several row tiles with live and with
   no keys, the JAX paged sweep's layout, flash with a window and cap,
   ragged tiles, Sq < Skv, kv_len without the causal mask); the serving
   shapes timed beside their bounds and SDPA. recurrentgemma-2b's local
   attention (MQA, 10 query heads on 1 KV head of 256, window 2048: 60
   rows a KV head at the verify), both dtypes: decode at its verify phases
   1 and 2, an admission chunk of 128 and a ring of 2048 + 6 slots after
   position 2600 (wrapped), its drafter's draft (20/20 heads of 128),
   paged at its verify phase 1, flash at its prefill (B 8 x 512) and an
   admission bucket (B 1 x 512); timed beside their bounds and SDPA
   (flex_attention for paged). The MoE family's attention (uncapped, hd
   128): dbrx-132b's 48 query heads over 8 KV heads (its drafter 48/48) at
   the verify phases, draft and extend, paged verify and draft, the
   prefill and an admission bucket; llama4-maverick's 40 over 8 (its
   drafter 40/40; window 8192) at the verify, a ring of 8192 + 6 slots
   after position 9000 (wrapped), paged verify and draft, a local prefill
   and one of 8400 tokens past the window (its library call
   flex_attention, the window a block mask); both dtypes, timed.
   whisper-base (8/8 heads of 64, not causal): flash over its encoder's
   1500 frames (B 8; ragged query and key tiles), its prefill's
   cross-attention (128 queries over 1500 frames) and a verify's (6
   queries) both through flash and through the decode kernel with every
   key at position 0 (the path's choice, logged beside flash's time);
   internvl2-1b (14/2 heads of 64): its fused prefill (256 vision + 512
   text positions, causal), its verify phase 1 (832 positions in) through
   the decode and the paged kernels; both dtypes, timed beside SDPA;
3. main path: Engine.run of full-width qwen2-1.5b in bfloat16, batch 8,
   512-token prompts, 128 new tokens, K 5, a 1024-slot bfloat16 cache,
   after a cold run of 8 steps; the warm run is reported (OTPS, prefill seconds, decode seconds
   per step, acceptance length, peak memory) with the kernels' launch
   counts, which must be 28 flash launches per prefill and 8 + 72 decode
   launches per step (drafter prefill extend; target verify 28x2, draft
   4x2, extend 4x2). The drafter is untrained, so AL ~ 1 is expected;
3b. continuous batching: Scheduler.serve of the same model over the paged
   layout (batch 8, max_len 1024, page 16, a 256-page pool: half of what 8
   full rows need, so requests are preempted), incremental growth,
   bucketed admission prefill; 24 requests, prompts of 256-640 tokens and
   budgets of 64-192 drawn from seed 0, Exp(1) arrival gaps on the
   virtual clock, no EOS; after a cold serve of the first 8 prompts with
   8-token budgets, the warm run reported (OTPS, virtual
   clock OTPS and p50/p99 latency, wall seconds, peak pages, preemptions)
   and checked: every request finishes once with its budget, preemptions
   occur, the pool ends empty, and every decode step launched the paged
   kernel 36 times (28 target verify, 4 draft, 4 extend, phase 1);
4. losslessness, at full width in float32: the target's logits through the
   kernels against the same forward with the plain attention, for a
   prefill into the cache (flash) and a verify block read against it
   (decode); then parallel, ar and none on the same prompts, and parallel
   again with oracle drafts (the none run's own tokens, a seeded fifth of
   them spoiled) so that drafts are accepted (AL must exceed 2), and a
   paged Scheduler.serve of the same prompts under pool pressure. A token
   that differs from none must sit at a near-tie of the none run;
3c / 4b. sampled serving: the threefry PRNG's known answers (JAX 0.9.0's
   words) on the card and the CPU, and 3 x 2^20 uniforms bitwise equal
   between them; then, bfloat16 at phase 3's shapes, Engine.run under
   temperature 0.8, top-k 50, top-p 0.95, seed 0 with draft sampling off
   and on, and Scheduler.serve of phase 3b's first 12 requests (cut from
   24 for time) with even requests
   greedy and odd ones sampled (seed = index): OTPS, ms/step or
   ms/iteration and AL beside phase 3 / 3b's greedy numbers (the bfloat16
   runs on 4 of the 28 layers, cut for time), and the
   attention launch counts of the greedy path's formula (sampling adds no
   attention launch); then, float32 full width (phase 4's prompts): two
   seeded runs identical, each sampled request's stream the same served
   alone and in a mixed batch, contiguous and paged under pool pressure
   that preempts sampled requests, greedy rows equal to phase 4's greedy
   run (a stream may part only after a decision of margin < 1e-4 for
   sampled ones, a top-2 logit gap < 1e-3 for greedy ones), and the
   chi-square losslessness check of rejection_verify_rows on the card
   (first committed token over 2^14 rows against the warped target, one-hot
   and sampled drafts, at the 0.999 quantile);
3d / 4c. the serving policies: Scheduler.serve of phase 3b's engine
   (bfloat16, on 4 of its 28 layers) with the prefix cache, swap to a 1 GiB pinned host pool and
   adaptive K (the default SpeculationConfig) on shared-prefix traffic: 24
   requests in 3 groups, each group's own 320-token system prompt and a
   unique suffix of 16-256 tokens, then 4 requests repeating an earlier
   prompt exactly, budgets 64-192, Exp(1) arrival gaps, seed 0, on a pool
   of 192 pages, so that requests are preempted to the host; after
   a cold serve of 8 other prompts and a flush, the warm run reported
   (OTPS, ms/iteration and otps_vt beside phase 3b's, the hit and cold
   admissions' device ms, the same prompt admitted cold and from the
   cache, swap-out / swap-in ms, bytes and GB/s, the k_row histogram and
   the controller's report) and checked: at least 20 requests hit, the
   repeats hit their whole system prompt, at least one preemption goes to
   the host with its swap_out / swap_in events, every request to its
   budget, the attention launches of the stated formula (a hit's suffix
   chunks run the decode kernel), the allocator and the host pool empty
   after a flush and reset_stats; then float32 (4 of the 28 layers, cut
   for time), the same traffic served
   with the three policies on and off (cold prefill, recompute preemption,
   fixed K), one request sampled and swapped out: every stream equal
   between the two (a greedy one may part only at a top-2 gap < 1e-3 of
   the off run, a sampled one after a margin < 1e-4), and the sampled one
   equal to itself served alone;
3e / 4d. the serving front end: phase 3b's engine geometry (bfloat16,
   4 of the 28 layers, cut for time; swap to a 1 GiB pinned host pool)
   under AsyncEngine, the first 16 of
   phase 3b's requests (odd ones sampled, seed = index) submitted at wall-clock
   Exp(0.075 s) gaps, seed 0, twice: as they come, then with every fourth
   request aborted after its first chunk; each pass reports wall OTPS
   beside phase 3b's, TTFT p50/p99 (submit() to the first streamed token),
   the per-request mean inter-token gap p50/p99, health()'s p50/p99 wait,
   the peak queue depth and the abort turnaround (abort() to the next
   admission, when a request waited), and checks the launch formula of
   phase 3b, the streamed tokens against the report's, survivors at their
   budgets, aborted requests stopped after their first chunk, a monotone
   event trace, and the allocator and host pool empty after close(); then
   LLMEngine.generate of requests 0-7 with their budgets in a mixed list
   of SamplingParams (prompt order, budgets), and serve_round_based of
   phase 3b's prompts cut to their shortest length, 256 tokens, and
   budgets on a contiguous twin (OTPS and rounds beside phase 3b's, one
   flash launch a layer a round); then float32 (phase 4's prompts, greedy and
   again sampled, a 30-page pool that preempts): the streamed run with one
   mid-stream abort against virtual_twin_report on the same engine under
   the near-tie rules, and the NDJSON server on 127.0.0.1 (the demo
   client, generate / abort / health, a dropped connection aborting its
   requests, the pool empty after);
5. training at full width: qwen2-1.5b bfloat16 target (seeded weights), the
   4-layer full-width drafter in float32, markov_corpus, batch 1, through
   Trainer.train_batch: (a) 3 whole-sequence steps at n 2048 (M 8522) and
   (b) 3 segmented steps at n 4096 in 4 Algorithm-1 segments, each with
   s/step, label tokens/s, peak memory, a CUDA-event split of each step
   into target taps / drafter forward / backward / optimizer, and launch
   counts (mtp_attention = drafter layers x forward passes, flash = 28 per
   target forward); then segmented grads against whole-sequence grads at
   n 1024, the loss over 4 steps on one repeated batch, a checkpoint round
   trip, and the training launcher (python -m repro_torch.launch.train);
6. gemma2-27b at full width in bfloat16 (8 of its 46 layers, cut for
   time: 4 (local, global) pairs; d 4608, 32/16 heads, d_ff
   36864, vocab 256000; the 4-layer drafter), every earlier phase's models
   freed first and the memory reckoned from the configs in the log: Engine.run
   of batch 8, 512-token prompts, 128 new tokens, K 5, max_len 1024 (the
   4096 window exceeds it, so no layer is a ring) after a cold run (OTPS,
   ms/step, prefill s, AL, peak memory; 8 flash launches and 8 decode at the
   prefill, then 32 decode a step), and Scheduler.serve of phase 3b's first
   8 requests on a paged twin sharing the weights (page 16, a 192-page pool
   that preempts; every request to its budget, 16 paged launches an
   iteration, the pool empty after; cut from 12 requests on 224 pages for
   time);
6b. gemma2-27b in float32 at full width cut to 4 layers (two (local, global)
   super-blocks), max_len 8192, batch 2, 4500-token prompts: the local
   layers' rings (4096 + 6 slots) wrap in prefill and decode; logits through
   the kernels against the plain attention, greedy parallel, ar and oracle
   drafts (AL > 2) against none under phase 4's near-tie rule, and
   Scheduler.serve of a 4200- and a 4800-token prompt (admitted in
   power-of-two chunks) paged (per-slot rings beside the pools) against
   contiguous, launch counts of both stated; then the same model in
   bfloat16, the dtype gemma2 serves in past its window: parallel against
   none and the paged serve against the contiguous one under the bfloat16
   near-tie rule (BF16_NEAR_TIE), launch counts stated;
6c. minitron-4b in float32 at full width (32 layers, ReLU², an untied head):
   4 prompts of 256, 32 new tokens, greedy parallel against none;
7. gemma-7b at full width in bfloat16 (8 of its 28 layers, cut for time;
   d 3072, 16/16 heads of 256, d_ff 24576 GeGLU, vocab 256000; the
   4-layer drafter, 24 heads of 128): Engine.run at phase 3's shapes
   after a cold run (one flash a layer and 8 decode at the prefill, 2
   decode a layer and 16 a step) and Scheduler.serve of phase
   3b's first 12 requests (cut from 24 for time) on a paged twin (pool
   256, preempts; 16 paged an iteration, launches of each admission
   prefill logged); 7b: float32 at full width, 8 layers, phase 4's
   prompts: parallel and ar
   against none, a paged serve under pool pressure against the contiguous
   one, under phase 4's near-tie rule;
8. mamba2-780m at full width in bfloat16 (6 of its 48 SSD layers, cut
   for time; d 1536, d_inner 3072, 48 heads of 64, d_state 128; the
   drafter 12 heads of 128): the
   memory plan with the verify's snapshot peak (the state after each of
   K + 1 tokens, all layers, float32), Engine.run at phase 3's shapes (the
   target launches no attention: 8 decode at the prefill, 16 a step), a
   verify step's measured peak beyond its state, and Scheduler.serve of
   phase 3b's first 12 requests (cut from 24 for time), paged (only the
   drafter's KV), swap to host, on a 256-page pool that preempts (8 paged
   an iteration; the drafter's extend once per MSB chunk of each
   admission); 8b: float32, phase 4's prompts: parallel and ar against
   none, paged against contiguous, a recompute-preempted and a swapped
   request each equal to itself served alone, and a seeded sampled request
   alone equal to itself batched;
9. recurrentgemma-2b at full width in bfloat16 (8 of its 26 layers, cut
   for time: 2 x (recurrent, recurrent, attention) + 2 recurrent, the
   2-slot tail kept; d 2560, RG-LRU width 2560, conv 4, MQA 10/1 heads of
   256, window 2048, d_ff 7680 GeGLU, vocab 256000; the drafter 20 heads
   of 128): the memory plan with the verify's snapshots (conv windows and
   h after each of K + 1 tokens, 6 recurrent layers), Engine.run at phase
   3's shapes (2 flash and 8 decode at the prefill, 20 decode a step: the
   2 attention layers' two phases and the drafter's), a verify step's
   measured peak beyond its state, and Scheduler.serve of phase 3b's first
   12 requests (cut from 24 for time), paged (at max_len 1024 the local
   layers' caches are pools beside the per-slot recurrent rows), swap to
   host, on a 256-page pool
   that preempts (10 paged an iteration; each admission's first MSB chunk
   a prefill, its later chunks in decode mode); 9b: float32 at full width,
   8 layers, phase 4's prompts as 8b, then over
   wrapped rings (max_len 4096: rings of 2048 + 6 slots; batch 2,
   2300-token prompts): parallel with the random drafter and with oracle
   drafts (AL > 2) against none, the logits through the kernels against
   the plain attention, and Scheduler.serve of a 2100- and a 2400-token
   prompt in MSB chunks, parallel against none, launch counts stated;
10. dbrx-132b at full width in bfloat16 on 8 of its 40 layers (40 are ~263
   GB; d 6144, 48/8 heads of 128, 16 experts of d_ff 10752 SwiGLU, top-4
   on every layer, capacity factor 1.25, vocab 100352, untied head; the
   drafter 48/48 heads of 128, d_ff 21504; ~62 GB with the weights drawn
   on the card from a seed, the memory plan logged): Engine.run at phase
   3's shapes after a cold run (8 flash and 8 decode at the prefill, 32
   decode a step), the mean drop_frac of the prefill's and of a verify's
   MoE calls and the smallest router top-4 margin seen, a verify step's
   peak beyond its state, and Scheduler.serve of phase 3b's first 12
   requests, paged, swap to host, on a 256-page pool that preempts (16
   paged an iteration); the prefix cache is never built for an MoE target;
10b. dbrx-132b in float32 at full width on 2 layers (~45 GB), phase 4's
   prompts: the logits of a prefill and a verify through the kernels
   against the plain attention (within 1e-3), the greedy streams of both
   paths (their experts equal call by call, or first differing where a
   router margin, a token's 4th less its 5th probability, is below 1e-5;
   the streams equal under phase 4's rule up to that call: a flipped
   expert moves other tokens' capacity), and, at capacity factor 16 (=
   n_experts: nothing dropped, tokens do not interact), greedy parallel
   and ar against none (a row compared up to the first call at which its
   experts differ, the prefill's, or, where the calls' shapes differ, in
   which a token of it had a router margin below 1e-5). (At capacity
   factor 1.25 a verify of B x (K+1)
   tokens and a decode of B drop other slots, so greedy speculation is
   not lossless there, in the JAX package as in the port.)
11. internvl2-1b at full width in bfloat16 (6 of its 24 layers, cut for
   time; d 896, 14/2 heads
   of 64, vocab 151655; 256 stub vision tokens of 1024 drawn on the card
   with ``make_extras``, projected and prepended to every prompt; the
   drafter 7/7 heads of 128): Engine.run at phase 3's shapes (a fused
   prefill of 768 positions; 6 flash and 8 decode at the prefill, 28
   decode a step at positions 256 past the token index), then
   Scheduler.serve of phase 3b's first 12 requests (cut from 24 for time)
   over paged KV (max_len 1280,
   a 320-page pool: preempts) with swap to host, each request's vision
   extras drawn at admission from its prompt's crc32, the prefix cache
   asked for and never built (14 paged an iteration);
11b. internvl2-1b in float32 at full width, batch 4, 128-token prompts
   after the 256 vision positions: the target's logits of a prefill and a
   verify through the kernels against the plain attention (within 1e-3),
   greedy parallel and ar against none, and a paged serve that preempts
   and resumes against the contiguous one, under phase 4's near-tie rule;
12. whisper-base at full width in bfloat16 (6 encoder + 6 decoder layers,
   d 512, 8/8 heads of 64, vocab 51865; 1500 stub frames): Engine.run of
   batch 8, 128-token prompts, 128 new, K 5, max_len 448 (18 flash at the
   prefill: 6 encoder, 6 self and 6 cross layers; 8 decode at the prefill
   and 34 a step, the cross-attention one decode a layer), then
   Scheduler.serve of 24 requests (prompts 32-192, budgets 64-192, Exp(1)
   gaps) with paged self-attention (page 16, 28 pages a row, a 112-page
   pool: 14 paged an iteration) and swap to host, a slot's 18.4 MB of
   cross K/V swapped with it;
12b. whisper-base in float32 at full width: 11b's checks;
13. storage-sharded serving and training (``EngineConfig(shard_model=
   True)``, ``launch/steps.build_train_step``) on a one-rank nccl group the
   script makes and destroys: full-width qwen2-1.5b in bfloat16 on 4 of 28
   layers, the 4-layer drafter, the sharded engine drawn leaf by leaf
   (``build_engine(shard_model=True)``: its slices bitwise the whole
   draw's, both builds' peak memory logged); Engine.run (batch 8,
   512-token prompts, 64 new, K 5) bitwise the unsharded engine's, tokens
   and gathered state,
   decode and flash launches equal; Scheduler.serve of phase 3b's first 12
   requests over paged KV (3b's 256-page pool) with swap to host, every
   stream equal, a swap at least; one train step on a (data 1, model 1)
   mesh in float32 at n 2048 within atol 2e-5 rtol 2e-4 of the unsharded
   one (loss, updated weights), the MTP kernel launched; 13d:
   AsyncEngine over the sharded paged engine, rank 0 broadcasting a
   decision record before each pass (3b's first 8 prompts at 48-token
   budgets, odd ones sampled): every stream equal to the unsharded
   AsyncEngine's, the records counted; resident bytes, gathers a step and
   ms a step sharded and unsharded logged beside the card's name and
   power limit;
14. llama4-maverick at full width in bfloat16 on 2 of its 48 layers (~44.5
   GB with the drafter: layer 0 local and dense, layer 1 local and MoE;
   d 5120, 40/8 heads of 128, window 8192, 128 experts of d_ff 8192 top-1,
   capacity factor 1.25, a shared expert, vocab 202048, untied head; the
   drafter 40/40 heads of 128): Engine.run at phase 3's shapes (2 flash and
   8 decode at the prefill, 20 decode a step), the routing of a prefill
   and a verify (drop_frac, the smallest router margin), Scheduler.serve
   of phase 3b's first 12 requests, paged, swap to host, on a 256-page
   pool that preempts (10 paged an iteration), and at capacity factor 128
   (nothing dropped) greedy parallel and ar against none, batch 4,
   128-token prompts, under the bfloat16 near-tie rules (a top-2 logit
   gap below 0.25; a row compared up to its first router margin below
   2e-3);
15. the trained drafter from checkpoint to the card: the P-EAGLE drafter
   and the AR EAGLE-3 drafter (4 layers each, float32) trained by
   ``launch.train.main`` against full-width qwen2-1.5b in bfloat16 (seed
   0, 7 of its 28 layers on both sides, cut for time) on its own greedy
   rollouts of 16 random 4-token prompts, 128 tokens each (the MTP kernel
   in training, flash for the target's taps), 40 steps, each written to
   its own checkpoint; then ``launch.serve.main`` serves the corpus's
   first 12 prompts (``--prompts``) with budgets of 60, Exp(1) virtual
   gaps, paged, five ways: none, ar and parallel from their checkpoints,
   parallel with adaptive K, parallel with a random drafter (the
   control); and the trained parallel drafter on 12 unseen random
   prompts (a drafter of a random target learns its rollouts, not the
   target: it accepts next to nothing there). Checks: the served leaves are the trained ones cast to
   bfloat16, bitwise; ar and parallel streams equal none's under the
   bfloat16 near-tie rule; the trained P-EAGLE drafter's AL above the
   random control's; each serve's attention launches by phase 3b's
   formula (ar: K + 1 drafter forwards an iteration). Prints AL, OTPS,
   ms/iteration and peak pages of each way, the P-EAGLE / AR-EAGLE and
   parallel / none OTPS ratios and the adaptive-K k_row histogram, beside
   the card's name and power limit.

The second-to-last line is a JSON object of the kernels' numbers, the last
line the result.
"""
from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
# dense peaks: bf16 and TF32 on the tensor cores, f32 on the CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
L2_BYTES = 50e6
SLEEP_CYCLES_PER_S = 2e9        # torch.cuda._sleep counts SM clock cycles
# (atol, rtol) of |kernel - plain| <= atol + rtol * |plain|, elementwise.
# The kernels and the plain versions both compute in float32 and round the
# output once, so in bfloat16 they differ by at most one rounding step of
# the output (2^-7 of its magnitude); the limit allows two. Float32 sums
# differ in order only.
KERNEL_TOL = {"bfloat16": (1e-4, 2 ** -6), "float32": (1e-4, 0.0)}
# Query scale of the kernel inputs: q ~ 2 N(0, 1), k, v ~ N(0, 1), so scores
# q.k / sqrt(hd) have a std of 2 and attention is peaked, as in a trained
# model: a dropped or misplaced key tile moves the output by far more than
# the tolerance.
Q_SCALE = 2.0
# phase 2's paged case with every row's first 20 table entries the same
PAGED_SHARED = "target verify phase 1, 20 shared pages"
# gemma2-27b's attention (arXiv:2408.00118): query scale 144^-0.5, tanh
# softcap 50 on every score, local layers' window 4096
GEMMA2_SCALE, GEMMA2_CAP, GEMMA2_WINDOW = 144 ** -0.5, 50.0, 4096
# recurrentgemma-2b's local attention (arXiv:2402.19427): MQA, 10 query
# heads on 1 KV head of 256, query scale 256^-0.5, window 2048
RGEMMA_WINDOW = 2048
# llama4-maverick's local layers (hf:meta-llama/Llama-4-Scout-17B-16E):
# chunked local attention over 8192 positions
LLAMA4_WINDOW = 8192
# depth cuts of earlier paths (widths stay the published ones), made as
# phases came in against the 1200 s the script may take (H100 80GB HBM3,
# 700.00 W): phase 9 (895.5 s, 1267.8 s on a slow host: gemma-7b to 14),
# phase 10 (854.7 s: mamba2 to 12, 4c to 7), phases 11 and 12 (826.5 and
# 863.6 s: 3c and 3e to 7), phase 13 (1013.0 s: 3d to 7, recurrentgemma to
# 14), phase 14 (884.7 and 911.6 s: gemma2-27b to 16, internvl2-1b to 12),
# and phase 15 (the trained drafter; 891.9 s before it, 1018.3 s with it
# and the first cuts below, so the qwen2 phases' 7 layers became 4 too):
GEMMA7B_LAYERS = 8          # phase 7 / 7b: gemma-7b, of 28
MAMBA2_LAYERS = 6           # phase 8 / 8b: mamba2-780m, of 48
RGEMMA_LAYERS = 8           # phase 9 / 9b: recurrentgemma-2b, of 26 (2
                            # (recurrent, recurrent, attention) + 2)
INTERNVL2_LAYERS = 6        # phase 11: internvl2-1b in bfloat16, of 24
GEMMA2_LAYERS = 8           # phase 6: gemma2-27b in bfloat16, of 46 (4
                            # (local, global) pairs)
SAMPLED_LAYERS = 4          # phase 3c's bfloat16 runs: qwen2-1.5b, of 28
POLICY_LAYERS = 4           # phase 3d: qwen2-1.5b in bfloat16, of 28
POLICY_F32_LAYERS = 4       # phase 4c: qwen2-1.5b in float32, of 28
STREAM_LAYERS = 4           # phase 3e: qwen2-1.5b, of 28
SHARDED_LAYERS = 4          # phase 13: qwen2-1.5b, of 28
# dbrx-132b's layers in phase 10: 8 of 40 (~62 GB with its drafter in
# bfloat16; 40 are ~263 GB)
DBRX_LAYERS = 8
# llama4-maverick (hf:meta-llama/Llama-4-Maverick-17B-128E) in phase 14: 2
# of its 48 layers (~44.5 GB with its drafter in bfloat16): layer 0 local
# and dense, layer 1 local and MoE (128 experts, top-1, the shared expert);
# its first global NoPE layer is the fourth, and 4 layers (~77 GB) take
# four cards (tests/test_torch_gpu.py::test_llama4_on_four_cards)
LLAMA4 = "llama4-maverick-400b-a17b"
LLAMA4_LAYERS = 2
# internvl2-1b's stub vision tokens, prepended to every prompt, and phase
# 11's page pool at max_len 1280: half of what 8 full rows need
INTERNVL2_VISION = 256
INTERNVL2_POOL = 320
# a router margin (a token's K-th less its (K+1)-th probability) below
# this may flip an expert between two float32 runs whose sums differ in
# order only (~1e-7 of a probability), and a flipped expert moves other
# tokens' capacity
ROUTER_NEAR_TIE = 1e-5
# the same for two bfloat16 runs (phase 14): the router reads a bfloat16
# hidden state, whose rounding (2^-8 of each element, summed over d_model
# against router weights of scale 0.02) moves a router logit by ~6e-3 and
# a probability of ~0.05 by ~3e-4; two such steps, with margin to spare
BF16_ROUTER_NEAR_TIE = 2e-3
# Oracle drafts must lift the acceptance length above this (a fifth of the
# drafts are spoiled, so about 3.7 is expected at K 5).
ORACLE_MIN_AL = 2.0
# A greedy token may differ between modes only where the reference's top-2
# logit gap is below this: the float32 verify (K+1 queries) and the plain
# decode (1 query) run GEMMs of other shapes, whose sums reorder and move
# logits by about 1e-5 at full width.
NEAR_TIE = 1e-3
# The same rule for two bfloat16 runs (phase 6b's bfloat16 pass): bfloat16
# keeps 8 significant bits, so a logit in [16, 32) (gemma2's final cap of 30
# keeps the top ones there) is held to 0.125, and sums in another order
# move the hidden state by about that share; two such steps.
BF16_NEAR_TIE = 0.25
# Full-width float32 logits through the kernels against the same forward
# with the plain attention: the two differ only in the order of float32
# sums inside attention, carried through 28 layers.
REF_TOL = 1e-3
# The flash kernel's timed shapes, one per path that runs it: the serving
# prefill (phase 3), a training tap (phase 5, n 2048) and an admission
# prefill of the scheduler (phase 3b: batch 1, a prompt of 256-640 tokens
# padded to the next power of two).
FLASH_MAIN = [("target prefill", (8, 512, 512, 12, 2, 128)),
              ("training tap", (1, 2048, 2048, 12, 2, 128)),
              ("admission bucket 512", (1, 512, 512, 12, 2, 128))]
# MTP stats (m, l) against the plain version's: |got - want| / (1 + |want|).
STATS_TOL = 1e-4
# Gradients of the flash training attention (kernel forward, plain
# backward) against autograd through the plain version, float32: each
# element within this share of its tensor's largest |gradient|. Both sides
# run f32 with TF32 off; they differ in the order of the sums only.
GRAD_TOL = 1e-4
# Segmented (Algorithm 1) against whole-sequence drafter gradients at full
# width, float32: each leaf within this share of its largest |gradient|.
# The segments change the shapes of every product (and the kernel's tiles),
# so the f32 sums run in another order; nothing else differs.
SEG_GRAD_TOL = 1e-3


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, sets, iters, host_us=200):
    """Mean device ms per call of fn(*inputs), cycling over input sets so
    the working set exceeds the L2 cache, after one warm-up call per set.

    The host enqueues a call more slowly than the card runs a small one, so
    the start event is queued behind a sleep kernel long enough for every
    call to be enqueued before the card reaches them: the events then
    bracket the calls back to back, the device time alone."""
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * host_us * 1e-6 * SLEEP_CYCLES_PER_S))
    a.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def n_sets(nbytes):
    return max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def qkv(g, dev, dtype, q_shape, kv_shape):
    dt = getattr(torch, dtype)
    return tuple((scale * torch.randn(s, generator=g, device=dev)).to(dt)
                 for scale, s in ((Q_SCALE, q_shape), (1.0, kv_shape),
                                  (1.0, kv_shape)))


def decode_case(dev, dtype, B, T, H, KV, hd, S, valid):
    """Inputs shaped like one decode call: a cache of S slots whose first
    `valid` hold positions 0..valid-1 (the rest empty), queries at the next
    T positions. For the phase-2 shapes (S == T) the keys are the block."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = qkv(g, dev, dtype, (B, T, H, hd), (B, S, KV, hd))
    kpos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    if S == T and valid == S:
        qpos = kpos.clone()
    else:
        kpos = torch.where(kpos < valid, kpos, -1).to(torch.int32)
        qpos = (valid + torch.arange(T, dtype=torch.int32, device=dev))[
            None].repeat(B, 1)
    return q, k, v, kpos.contiguous(), qpos.contiguous()


def decode_work(q, k, kpos, qpos, window=0):
    """Bytes and FLOPs a decode call needs for this data: q, out and the
    (m, l) stats once, positions once, K/V of the keys some query of the row
    can see, and 4·hd FLOPs per visible (query head, key) pair."""
    B, T, H, hd = q.shape
    KV, es = k.shape[2], q.element_size()
    vis = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None])
    if window > 0:
        vis &= qpos[:, :, None] - kpos[:, None, :] < window
    live_keys = int(vis.any(1).sum())
    nbytes = (2 * B * T * H * hd * es + 2 * B * T * H * 4
              + 4 * (kpos.numel() + qpos.numel()) + 2 * live_keys * KV * hd * es)
    flops = 4 * hd * H * int(vis.sum())
    return nbytes, flops


def flash_work(q, k, window=0, causal=True):
    """Bytes and FLOPs of a flash call: q, k, v and out once, 4·hd FLOPs
    per visible (query head, key) pair (causal: within the window, if any;
    not causal: every key)."""
    B, Sq, H, hd = q.shape
    Skv, KV, es = k.shape[1], k.shape[2], q.element_size()
    nbytes = 2 * B * Sq * H * hd * es + 2 * B * Skv * KV * hd * es
    pairs = (sum(min(t + 1, Skv, window or Skv) for t in range(Sq))
             if causal else Sq * Skv)
    return nbytes, 4 * hd * H * B * pairs


def sdpa_decode(q, k, v, kpos, qpos, window=0):
    """One PyTorch call for the decode function: SDPA with a boolean mask,
    in SDPA's (B, H, L, hd) layout, prepared outside the timed call."""
    mask = ((kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None]))
    if window > 0:
        mask &= qpos[:, :, None] - kpos[:, None, :] < window
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            mask[:, None])
    return lambda: F.scaled_dot_product_attention(
        args[0], args[1], args[2], attn_mask=args[3], enable_gqa=True)


def sdpa_flash(q, k, v, causal=True):
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return lambda: F.scaled_dot_product_attention(*args, is_causal=causal,
                                                  enable_gqa=True)


_FLEX = []


def flex_call(q, k, v, mask_mod, kv_len, scale, softcap, kv_block=128):
    """One call of torch's compiled flex_attention, the one PyTorch call
    that takes a tanh softcap (a score_mod) and a position or page-table
    predicate (a block mask): the library call of the capped and the paged
    cases. The
    block mask is built here, outside the timed call; q (B, T, H, hd), k
    and v (B or 1, kv_len, KV, hd). Returns the call, whose output is in
    (B, H, T, hd)."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    if not _FLEX:
        from torch._dynamo import config as dynamo_config
        from torch._inductor import config as inductor_config
        inductor_config.compile_threads = 1    # no worker processes
        dynamo_config.recompile_limit = 64     # a graph per case
        _FLEX.append(torch.compile(flex_attention, dynamic=False))
    B, T = q.shape[:2]
    block = create_block_mask(mask_mod, B, None, T, kv_len, device=q.device,
                              BLOCK_SIZE=(128, kv_block))
    cap = (lambda s, b, h, qi, ki: softcap * torch.tanh(s / softcap)
           ) if softcap else None
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return lambda: _FLEX[0](*args, score_mod=cap, block_mask=block,
                            scale=scale, enable_gqa=True)


def flex_decode(q, k, v, kpos, qpos, scale, softcap=0.0, window=0):
    # flex's decode kernel reads whole key blocks past the last key and
    # leaves them to the mask, so the mask bounds its own indices
    T, S = qpos.shape[1], kpos.shape[1]

    def mask(b, h, qi, ki):
        kp, qp = kpos[b, ki.clamp(max=S - 1)], qpos[b, qi.clamp(max=T - 1)]
        seen = (ki < S) & (kp >= 0) & (kp <= qp)
        return seen & (qp - kp < window) if window > 0 else seen
    return flex_call(q, k, v, mask, k.shape[1], scale, softcap)


def flex_paged(q, k, v, pos, table, qpos, scale, softcap=0.0):
    """The paged function over the pools as one sequence of NP x page keys
    (batch 1, broadcast over the rows), a key seen by row b where its page
    is in b's table and its position is live and at most the query's: a
    block mask of page-sized key blocks, as torch's paged flex attention
    builds it. Flex's decode kernel, which takes such blocks, needs a
    power-of-two ratio of query to KV heads; at another ratio (qwen2's 6)
    its main kernel takes key blocks of 128 (8 pages, most of them other
    rows'), which it reads whole."""
    NP, page = pos.shape
    (B, T), ratio = qpos.shape, q.shape[2] // k.shape[2]
    ok = (table >= 0) & (table < NP)
    named = torch.zeros((B, NP), dtype=torch.bool, device=q.device)
    rows = torch.arange(B, device=q.device)[:, None].expand_as(table)
    named[rows[ok], table[ok].long()] = True
    flat = pos.reshape(-1)

    def mask(b, h, qi, ki):      # indices bounded as in flex_decode
        ki_ = ki.clamp(max=NP * page - 1)
        kp = flat[ki_]
        return ((ki < NP * page) & named[b, ki_ // page] & (kp >= 0)
                & (kp <= qpos[b, qi.clamp(max=T - 1)]))
    pool = lambda x: x.reshape(1, NP * page, *x.shape[2:])
    return flex_call(q, pool(k), pool(v), mask, NP * page, scale, softcap,
                     kv_block=page if ratio & (ratio - 1) == 0 else 128)


def flex_flash(q, k, v, scale, softcap=0.0, window=0):
    def mask(b, h, qi, ki):
        seen = qi >= ki
        return seen & (qi - ki < window) if window > 0 else seen
    return flex_call(q, k, v, mask, k.shape[1], scale, softcap)


def ring_case(dev, dtype, B, T, H, KV, hd, ring, last, seed=0):
    """Inputs shaped like a decode call against a local layer's ring of
    ``ring`` slots after positions up to ``last`` were written: slot s
    holds the last position p <= last with p % ring == s (wrapped, not
    monotone in the slot index); queries at the next T positions."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = qkv(g, dev, dtype, (B, T, H, hd), (B, ring, KV, hd))
    s = torch.arange(ring, dtype=torch.int32, device=dev)
    kpos = (last - torch.remainder(last - s, ring))[None].repeat(B, 1)
    qpos = (last + 1 + torch.arange(T, dtype=torch.int32, device=dev)
            )[None].repeat(B, 1)
    return q, k, v, kpos.to(torch.int32).contiguous(), qpos.contiguous()


def paged_case(dev, dtype, B, T, H, KV, hd, page, nb, c, seed=0):
    """Inputs shaped like one phase-1 call of the paged serving path: a pool
    of B * nb pages and the sink, each row's table naming pages drawn at
    random from it (enough for positions up to c + T), the row holding
    positions 0..c-1, queries at c..c+T-1. Pages no table names hold stale
    positions the kernel must not see."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    NP = B * nb + 1
    q, k, v = qkv(g, dev, dtype, (B, T, H, hd), (NP, page, KV, hd))
    pos = rng.integers(0, nb * page, (NP, page)).astype(np.int32)
    table = np.full((B, nb), -1, np.int32)
    n = -(-(c + T) // page)
    perm = rng.permutation(NP - 1)
    for b in range(B):
        table[b, :n] = perm[b * n:(b + 1) * n]
        logical = np.arange(n * page).reshape(n, page)
        pos[table[b, :n]] = np.where(logical < c, logical, -1)
    qpos = np.broadcast_to(c + np.arange(T), (B, T)).astype(np.int32)
    return (q, k, v) + tuple(torch.as_tensor(a, device=dev).contiguous()
                             for a in (pos, table, qpos))


def paged_sweep_case(dev, dtype, B, T, H, KV, hd, NP, page, nb, seed):
    """The JAX paged kernel sweep's layout: rows of random lengths owning
    distinct random pages, later table entries -1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    q, k, v = qkv(g, dev, dtype, (B, T, H, hd), (NP, page, KV, hd))
    pos = np.full((NP, page), -1, np.int32)
    table = np.full((B, nb), -1, np.int32)
    qpos = np.zeros((B, T), np.int32)
    perm, used = rng.permutation(NP), 0
    for b in range(B):
        n = int(rng.integers(1, nb + 1))
        table[b, :n] = perm[used:used + n]
        used += n
        length = int(rng.integers(1, n * page + 1))
        logical = np.arange(n * page).reshape(n, page)
        pos[table[b, :n]] = np.where(logical < length, logical, -1)
        qpos[b] = length - 1 + np.arange(T)
    return (q, k, v) + tuple(torch.as_tensor(a, device=dev).contiguous()
                             for a in (pos, table, qpos))


def paged_work(q, k, pos, table, qpos):
    """Bytes and FLOPs a paged call needs for this data: q, out and the
    (m, l) stats once, the table and query positions once, the positions of
    the pages the tables name once, K/V of the keys some query of the row
    can see, and 4·hd FLOPs per visible (query head, key) pair."""
    from repro_torch.models.layers import paged_view
    B, T, H, hd = q.shape
    NP, page = pos.shape
    KV, es = k.shape[2], q.element_size()
    kpos = paged_view(pos, table, empty=-1)
    vis = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None])
    # a key slot two rows' tables share (a shared prefix) is read once
    ok = (table >= 0) & (table < NP)
    slot = (torch.where(ok, table, 0).long()[:, :, None] * page
            + torch.arange(page, device=table.device)).reshape(B, -1)
    live = torch.zeros(NP * page, dtype=torch.bool, device=table.device)
    live[slot[vis.any(1)]] = True
    live_keys = int(live.sum())
    named = int(torch.unique(table[ok]).numel()) * page
    nbytes = (2 * B * T * H * hd * es + 2 * B * T * H * 4
              + 4 * (table.numel() + qpos.numel() + named)
              + 2 * live_keys * KV * hd * es)
    return nbytes, 4 * hd * H * int(vis.sum())


def gemma2_cases(dev, dtype, c):
    """Phase 2's gemma2-27b cases: (kernel, label, inputs, keywords). The
    target's are capped; its drafter (36/36 heads) runs uncapped at query
    scale 128^-0.5, and its cases are so."""
    cap = dict(scale=GEMMA2_SCALE, softcap=GEMMA2_CAP)
    drafter = dict(scale=128 ** -0.5)
    out = []
    for label, (B, T, H, KV, S, valid), kw in [
            ("gemma2 target verify phase 1", (8, 6, 32, 16, 1024, c), cap),
            ("gemma2 target verify phase 2", (8, 6, 32, 16, 6, 6), cap),
            ("gemma2 drafter draft phase 1", (8, 5, 36, 36, 1024, c - 1),
             drafter),
            ("gemma2 drafter extend phase 1", (8, 6, 36, 36, 1024, c),
             drafter)]:
        out.append(("decode_attention", label,
                    decode_case(dev, dtype, B, T, H, KV, 128, S, valid), kw))
    out.append(("decode_attention", "gemma2 local ring 4096 + 6, wrapped",
                ring_case(dev, dtype, 8, 6, 32, 16, 128, GEMMA2_WINDOW + 6,
                          4700), dict(cap, window=GEMMA2_WINDOW)))
    q, k, v, kpos, qpos = decode_case(dev, dtype, 8, 6, 32, 16, 128, 1024, c)
    big = (q.float() * 8).to(q.dtype)
    out.append(("decode_attention", "gemma2 verify phase 1, scores x8",
                (big, k, v, kpos, qpos), cap))
    for i, (label, (T, H, KV, cc), kw) in enumerate([
            ("gemma2 target verify phase 1", (6, 32, 16, c), cap),
            ("gemma2 drafter draft phase 1", (5, 36, 36, c - 1), drafter),
            ("gemma2 drafter extend phase 1", (6, 36, 36, c), drafter)]):
        out.append(("paged_decode_attention", label,
                    paged_case(dev, dtype, 8, T, H, KV, 128, 16, 64, cc,
                               seed=30 + i), kw))
    g = torch.Generator(device=dev).manual_seed(3)
    for label, (B, S) in [("gemma2 target prefill", (8, 512)),
                          ("gemma2 local prefill past the window",
                           (1, 4608))]:
        out.append(("flash_attention", label,
                    qkv(g, dev, dtype, (B, S, 32, 128), (B, S, 16, 128)),
                    dict(cap, causal=True, window=GEMMA2_WINDOW)))
    return out


def gemma7b_cases(dev, dtype, c):
    """Phase 2's head-dim-256 cases (gemma-7b, arXiv:2403.08295: 16 query
    heads over 16 KV heads, hd 256, query scale 256^-0.5, no cap):
    (kernel, label, inputs, keywords). The serving shapes first (verify
    phases 1 and 2, paged verify phase 1, the prefill and an admission
    bucket; its drafter's draft at hd 128, 24/24 heads), then the edges of
    the hd-256 bodies: GQA rows, a window across chunks, more rows than a
    block (16 at hd 256) with live and with no keys, a JAX sweep paged
    layout, and flash with a window, a cap, ragged tiles, kv_len and no
    causal mask."""
    kw = dict(scale=256 ** -0.5)
    out = []
    for label, (B, T, H, KV, hd, S, valid), extra in [
            ("gemma7b target verify phase 1",
             (8, 6, 16, 16, 256, 1024, c), {}),
            ("gemma7b target verify phase 2", (8, 6, 16, 16, 256, 6, 6), {}),
            ("gemma7b drafter draft phase 1",
             (8, 5, 24, 24, 128, 1024, c - 1), {}),
            ("hd256 edge: GQA 8/2, window across chunks",
             (8, 6, 8, 2, 256, 1024, 600), dict(window=100)),
            ("hd256 edge: T 40, 4 row tiles, live keys",
             (2, 40, 4, 2, 256, 1000, 600), {}),
            ("hd256 edge: every key empty", (2, 40, 4, 2, 256, 1024, 0), {}),
            ("gemma7b admission chunk 128 phase 1",
             (1, 128, 16, 16, 256, 1024, 512), {})]:
        out.append(("decode_attention", label,
                    decode_case(dev, dtype, B, T, H, KV, hd, S, valid),
                    dict(scale=hd ** -0.5, **extra)))
    out.append(("paged_decode_attention", "gemma7b target verify phase 1",
                paged_case(dev, dtype, 8, 6, 16, 16, 256, 16, 64, c,
                           seed=40), kw))
    out.append(("paged_decode_attention", "hd256 sweep (3, 4, 2, 1, 16, 8)",
                paged_sweep_case(dev, dtype, 3, 4, 2, 1, 256, 16, 8, 6,
                                 seed=41), kw))
    g = torch.Generator(device=dev).manual_seed(4)
    for label, (B, Sq, Skv, H, KV), extra in [
            ("gemma7b target prefill", (8, 512, 512, 16, 16), {}),
            ("gemma7b admission bucket 512", (1, 512, 512, 16, 16), {}),
            ("hd256 edge: ragged 500, GQA 8/2", (2, 500, 500, 8, 2), {}),
            ("hd256 edge: window 64, cap 50", (2, 256, 256, 4, 2),
             dict(window=64, softcap=50.0)),
            ("hd256 edge: Sq 100 < Skv 300", (2, 100, 300, 4, 2), {}),
            ("hd256 edge: kv_len 150, not causal", (2, 200, 256, 4, 2),
             dict(causal=False, kv_len=150))]:
        out.append(("flash_attention", label,
                    qkv(g, dev, dtype, (B, Sq, H, 256), (B, Skv, KV, 256)),
                    dict(kw, **{"causal": True, **extra})))
    return out


def rgemma_cases(dev, dtype, c):
    """Phase 2's recurrentgemma-2b cases (its local layers: MQA 10/1 at
    head dim 256, window 2048, no cap; 60 rows a KV head at the verify, so
    four 16-row tiles re-read one KV head): (kernel, label, inputs,
    keywords). Decode at verify phases 1 and 2, an admission chunk of 128
    and a ring of 2048 + 6 slots after position 2600 (wrapped; the window's
    edge inside a split chunk), its drafter's draft (20/20 heads of 128);
    paged at verify phase 1; flash at the prefill (B 8 x 512) and the
    admission bucket (B 1 x 512)."""
    kw = dict(scale=256 ** -0.5, window=RGEMMA_WINDOW)
    out = []
    for label, (B, T, H, KV, hd, S, valid), extra in [
            ("rgemma target verify phase 1", (8, 6, 10, 1, 256, 1024, c), kw),
            ("rgemma target verify phase 2", (8, 6, 10, 1, 256, 6, 6), kw),
            ("rgemma admission chunk 128 phase 1",
             (1, 128, 10, 1, 256, 1024, 512), kw),
            ("rgemma drafter draft phase 1",
             (8, 5, 20, 20, 128, 1024, c - 1), dict(scale=128 ** -0.5))]:
        out.append(("decode_attention", label,
                    decode_case(dev, dtype, B, T, H, KV, hd, S, valid),
                    extra))
    out.append(("decode_attention", "rgemma local ring 2048 + 6, wrapped",
                ring_case(dev, dtype, 8, 6, 10, 1, 256, RGEMMA_WINDOW + 6,
                          2600, seed=7), kw))
    out.append(("paged_decode_attention", "rgemma target verify phase 1",
                paged_case(dev, dtype, 8, 6, 10, 1, 256, 16, 64, c,
                           seed=50), kw))
    g = torch.Generator(device=dev).manual_seed(6)
    for label, B in [("rgemma target prefill", 8),
                     ("rgemma admission bucket 512", 1)]:
        out.append(("flash_attention", label,
                    qkv(g, dev, dtype, (B, 512, 10, 256), (B, 512, 1, 256)),
                    dict(kw, causal=True)))
    return out


def moe_cases(dev, dtype, c):
    """Phase 2's MoE-family cases (no cap, query scale 128^-0.5): dbrx-132b
    (hf:databricks/dbrx-base: 48 query heads over 8 KV heads, its drafter
    48/48) at the serving path's verify phases 1 and 2, draft and extend
    phase 1, paged verify and draft phase 1, the prefill and an admission
    bucket; llama4-maverick (40 over 8, a GQA ratio of 5; local window
    8192; its drafter 40/40), whose model stays on the CPU, at its verify,
    a local layer's ring of 8192 + 6 slots after position 9000 (wrapped),
    its draft, paged verify and draft, a local prefill and one past the
    window: (kernel, label, inputs, keywords)."""
    kw = dict(scale=128 ** -0.5)
    local = dict(kw, window=LLAMA4_WINDOW)
    out = []
    for label, (B, T, H, KV, S, valid), extra in [
            ("dbrx target verify phase 1", (8, 6, 48, 8, 1024, c), kw),
            ("dbrx target verify phase 2", (8, 6, 48, 8, 6, 6), kw),
            ("dbrx drafter draft phase 1", (8, 5, 48, 48, 1024, c - 1), kw),
            ("dbrx drafter extend phase 1", (8, 6, 48, 48, 1024, c), kw),
            ("llama4 target verify phase 1", (8, 6, 40, 8, 1024, c), local),
            ("llama4 drafter draft phase 1", (8, 5, 40, 40, 1024, c - 1),
             kw)]:
        out.append(("decode_attention", label,
                    decode_case(dev, dtype, B, T, H, KV, 128, S, valid),
                    extra))
    out.append(("decode_attention", "llama4 local ring 8192 + 6, wrapped",
                ring_case(dev, dtype, 2, 6, 40, 8, 128, LLAMA4_WINDOW + 6,
                          9000, seed=8), local))
    for i, (label, (T, H, KV, cc), extra) in enumerate([
            ("dbrx target verify phase 1", (6, 48, 8, c), kw),
            ("dbrx drafter draft phase 1", (5, 48, 48, c - 1), kw),
            ("llama4 target verify phase 1", (6, 40, 8, c), local),
            ("llama4 drafter draft phase 1", (5, 40, 40, c - 1), kw)]):
        out.append(("paged_decode_attention", label,
                    paged_case(dev, dtype, 8, T, H, KV, 128, 16, 64, cc,
                               seed=60 + i), extra))
    g = torch.Generator(device=dev).manual_seed(7)
    for label, (B, S, H), extra in [
            ("dbrx target prefill", (8, 512, 48), kw),
            ("dbrx admission bucket 512", (1, 512, 48), kw),
            ("llama4 local prefill", (8, 512, 40), local),
            ("llama4 local prefill past the window", (1, 8400, 40), local)]:
        out.append(("flash_attention", label,
                    qkv(g, dev, dtype, (B, S, H, 128), (B, S, 8, 128)),
                    dict(extra, causal=True)))
    return out


def modality_cases(dev, dtype):
    """Phase 2's VLM and encoder-decoder cases (no cap, no window; query
    scale 64^-0.5, the drafters' 128^-0.5): whisper-base (arXiv:2212.04356:
    8/8 heads of 64, 1500 encoder frames) at its encoder's non-causal flash
    over 1500 frames (ragged query and key tiles), its prefill's
    cross-attention (128 decoder queries over the 1500 frames, non-causal
    flash), its verify's cross-attention (K + 1 = 6 queries over the 1500
    frames) both ways the path could run it: the decode kernel with every
    key at position 0 (what the path runs) and flash without the causal
    mask; its decoder's self-attention at verify phase 1 through the decode
    kernel (448 slots) and the paged one (page 16, 28 entries), a row 320
    positions in (phase 12's serve: prompts up to 192, budgets up to 192);
    its drafter's (4/4 heads of 128) draft phase 1, both layouts;
    internvl2-1b (arXiv:2404.16821: 14/2 heads of 64) at its fused prefill
    (256 vision + 512 text tokens, causal) and its verify phase 1 (a row
    256 + 576 positions in) through the decode and the paged kernels, and
    its drafter's (7/7 heads of 128) draft phase 1 over the text region
    (slots below 256 empty), both layouts: (kernel, label, inputs,
    keywords)."""
    kw = dict(scale=64 ** -0.5)
    drafter = dict(scale=128 ** -0.5)
    g = torch.Generator(device=dev).manual_seed(8)
    out = []
    for label, (B, Sq, Skv) in [("whisper encoder", (8, 1500, 1500)),
                                ("whisper cross prefill", (8, 128, 1500)),
                                ("whisper cross verify flash", (8, 6, 1500))]:
        out.append(("flash_attention", label,
                    qkv(g, dev, dtype, (B, Sq, 8, 64), (B, Skv, 8, 64)),
                    dict(kw, causal=False)))
    q, k, v = qkv(g, dev, dtype, (8, 6, 8, 64), (8, 1500, 8, 64))
    kpos = torch.zeros((8, 1500), dtype=torch.int32, device=dev)
    qpos = (192 + torch.arange(6, dtype=torch.int32, device=dev))[
        None].repeat(8, 1).contiguous()
    out.append(("decode_attention", "whisper cross verify decode",
                (q, k, v, kpos, qpos), kw))
    cw = 320
    out.append(("decode_attention", "whisper self verify phase 1",
                decode_case(dev, dtype, 8, 6, 8, 8, 64, 448, cw), kw))
    out.append(("decode_attention", "whisper drafter draft phase 1",
                decode_case(dev, dtype, 8, 5, 4, 4, 128, 448, cw - 1),
                drafter))
    out.append(("paged_decode_attention", "whisper self verify phase 1",
                paged_case(dev, dtype, 8, 6, 8, 8, 64, 16, 28, cw, seed=71),
                kw))
    out.append(("paged_decode_attention", "whisper drafter draft phase 1",
                paged_case(dev, dtype, 8, 5, 4, 4, 128, 16, 28, cw - 1,
                           seed=72), drafter))
    c = INTERNVL2_VISION + 576
    out.append(("flash_attention", "internvl2 target prefill",
                qkv(g, dev, dtype, (8, 768, 14, 64), (8, 768, 2, 64)),
                dict(kw, causal=True)))
    out.append(("decode_attention", "internvl2 target verify phase 1",
                decode_case(dev, dtype, 8, 6, 14, 2, 64, 1024, c), kw))
    out.append(("paged_decode_attention", "internvl2 target verify phase 1",
                paged_case(dev, dtype, 8, 6, 14, 2, 64, 16, 80, c, seed=70),
                kw))

    def text_only(inp):
        # the drafter writes no key below the vision offset
        inp = list(inp)
        inp[3] = torch.where(inp[3] < INTERNVL2_VISION, -1,
                             inp[3]).to(torch.int32).contiguous()
        return tuple(inp)
    out.append(("decode_attention", "internvl2 drafter draft phase 1",
                text_only(decode_case(dev, dtype, 8, 5, 7, 7, 128, 1024,
                                      c - 1)), drafter))
    out.append(("paged_decode_attention", "internvl2 drafter draft phase 1",
                text_only(paged_case(dev, dtype, 8, 5, 7, 7, 128, 16, 80,
                                     c - 1, seed=73)), drafter))
    return out


def check_kernels(ops, dev):
    """Every kernel against its plain version; returns the per-kernel
    measurements of the main-path shapes (the MTP kernel's keyed by
    (label, dtype))."""
    worst = {"decode_attention": 0.0, "paged_decode_attention": 0.0,
             "flash_attention": 0.0}
    shares = {}      # (kernel, dtype) -> the worst share of the limit
    rows = {}
    row_kw = {}      # (kernel, label) -> the call's keywords, if not plain
    # (family, kernel) -> the worst bfloat16 error at that family's
    # shapes: "gemma2" (softcap 50), "gemma7b" (head dim 256), "rgemma"
    # (recurrentgemma-2b: MQA 10/1 at head dim 256, window 2048), "dbrx"
    # (48/8 and 48/48) and "llama4" (40/8 with window 8192, 40/40)
    fam_worst = {}

    def compare(name, got, want, dtype, label):
        atol, rtol = KERNEL_TOL[dtype]
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        # the worst element's share of its own limit: <= 1 passes
        used = (diff / (atol + rtol * want.float().abs())).max().item()
        shares[(name, dtype)] = max(shares.get((name, dtype), 0.0), used)
        ok = used <= 1.0
        log(f"  {name:22s} {dtype:8s} {label:46s} max_abs_err {err:.3e} "
            f"(max |plain| {want.float().abs().max().item():.3f}, "
            f"{used:.2f} of the limit) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} {label} {dtype}: an element differs by {used:.2f} "
                 f"times its limit {atol} + {rtol} |plain| (max abs err "
                 f"{err})")
        return err

    # serving path shapes: full-width qwen2-1.5b (12 heads over 2 KV heads)
    # and its drafter (12 heads, no GQA), batch 8, cache 1024, K 5, a row
    # 576 tokens in (512 prompt + 64 generated), prompt 512
    c = 576
    decode_main = [
        ("target verify phase 1", (8, 6, 12, 2, 128, 1024, c)),
        ("target verify phase 2", (8, 6, 12, 2, 128, 6, 6)),
        ("drafter draft phase 1", (8, 5, 12, 12, 128, 1024, c - 1)),
        ("drafter draft phase 2", (8, 5, 12, 12, 128, 5, 5)),
        ("drafter extend phase 1", (8, 6, 12, 12, 128, 1024, c)),
        ("drafter extend phase 2", (8, 6, 12, 12, 128, 6, 6)),
        ("drafter prefill extend phase 1", (8, 511, 12, 12, 128, 1024, 0)),
        ("drafter prefill extend phase 2", (8, 511, 12, 12, 128, 511, 511)),
        # phase 3b's batch-1 admission prefill: the drafter's extend over a
        # bucket of 512 or 256, or over an exact-length prompt of up to 640
        # (a bucket of 1024 would reach max_len); 4 splits over 4-10 row tiles
        ("admission extend phase 1", (1, 511, 12, 12, 128, 1024, 0)),
        ("admission extend phase 2", (1, 511, 12, 12, 128, 511, 511)),
        ("admission extend 256 phase 2", (1, 255, 12, 12, 128, 255, 255)),
        ("admission extend exact phase 2", (1, 638, 12, 12, 128, 638, 638)),
        # phase 3d's prefix-cache hits: the suffix chunks (powers of two up
        # to 256 here) run in decode mode on a batch-1 view whose cache
        # holds the shared 320-token system prompt; the drafter extends c-1
        # pairs of the first chunk at 12/12 heads
        ("target hit chunk phase 1", (1, 256, 12, 2, 128, 1024, 320)),
        ("target hit chunk phase 2", (1, 256, 12, 2, 128, 256, 256)),
        ("drafter hit extend phase 1", (1, 255, 12, 12, 128, 1024, 320)),
    ]
    def check_stats(name, label, dtype, got, want):
        # stats: relative to 1 + |value| (l grows with the visible keys)
        for stat, g_, w_ in zip("ml", got, want):
            rel = ((g_ - w_).abs() / (1 + w_.abs())).max().item()
            if not rel <= KERNEL_TOL["float32"][0]:
                fail(f"{name} {label} {dtype}: {stat} relative err {rel}")

    log("phase 2: kernels against their plain versions on the card")
    for dtype in ("bfloat16", "float32"):
        for label, (B, T, H, KV, hd, S, valid) in decode_main:
            inp = decode_case(dev, dtype, B, T, H, KV, hd, S, valid)
            o, m, l = ops.decode_attention(*inp, scale=hd ** -0.5,
                                           return_stats=True)
            torch.cuda.synchronize()
            po, pm, pl = ops.decode_attention_plain(*inp, scale=hd ** -0.5,
                                                    return_stats=True)
            err = compare("decode_attention", o, po, dtype, label)
            check_stats("decode_attention", label, dtype, (m, l), (pm, pl))
            if dtype == "bfloat16":
                worst["decode_attention"] = max(worst["decode_attention"], err)
                rows[("decode_attention", label)] = inp
        # the JAX kernel sweep's shapes, then the edges of the split-K body:
        # at target verify phase 1 (16 chunks of 64 slots) the chunks past
        # the 576 live slots hold no live key
        sweep = [("sweep", (2, 6, 4, 2, 64, 256, 192, 0)),
                 ("sweep", (1, 1, 4, 4, 32, 512, 384, 0)),
                 ("sweep", (2, 6, 4, 2, 64, 256, 192, 64)),
                 ("sweep", (1, 8, 2, 1, 128, 96, 72, 0)),
                 ("S not a multiple of the chunk",
                  (8, 6, 12, 2, 128, 1000, 600, 0)),
                 ("every key empty", (8, 6, 12, 2, 128, 1024, 0, 0)),
                 ("window across chunks", (8, 6, 12, 2, 128, 1024, 600, 100)),
                 ("row tiles x splits, live keys",
                  (1, 200, 12, 2, 128, 1024, 600, 0)),
                 ("row tiles x splits, window",
                  (1, 200, 12, 2, 128, 1024, 600, 150))]
        for what, (B, T, H, KV, hd, S, valid, window) in sweep:
            label = f"{what} {(B, T, H, KV, hd, S)} w{window}"
            inp = decode_case(dev, dtype, B, T, H, KV, hd, S, valid)
            o, m, l = ops.decode_attention(*inp, scale=hd ** -0.5,
                                           window=window, return_stats=True)
            torch.cuda.synchronize()
            po, pm, pl = ops.decode_attention_plain(
                *inp, scale=hd ** -0.5, window=window, return_stats=True)
            compare("decode_attention", o, po, dtype, label)
            check_stats("decode_attention", label, dtype, (m, l), (pm, pl))
            if valid == 0 and not (o.abs().max().item() == 0.0
                                   and (l == 0).all() and (m == -1e30).all()):
                fail(f"decode_attention {label} {dtype}: rows that see no "
                     f"key are not zeros with l 0, m -1e30")

        # paged phase 1 at the serving shapes: the drafter's draft block
        # sits one position back (anchor c - 1), its cache below it
        paged_main = [("target verify phase 1", (8, 6, 12, 2, c)),
                      ("drafter draft phase 1", (8, 5, 12, 12, c - 1)),
                      ("drafter extend phase 1", (8, 6, 12, 12, c))]
        cases = [(label, paged_case(dev, dtype, B, T, H, KV, 128, 16, 64,
                                    cc, seed=i))
                 for i, (label, (B, T, H, KV, cc)) in enumerate(paged_main)]
        for i, shp in enumerate([(2, 6, 4, 2, 64, 12, 16, 4),
                                 (1, 1, 4, 4, 32, 8, 32, 3),
                                 (3, 4, 2, 1, 128, 16, 8, 6)]):
            cases.append((f"sweep {shp}",
                          paged_sweep_case(dev, dtype, *shp, seed=10 + i)))
        # the edges of the split-K body: a 64-key tile over 8 or 2 pages,
        # nb x page not a multiple of 64, one split (row tiles fill the
        # card), -1 and out-of-pool ids inside live tiles, tables all -1
        for label, (B, T, page, nb, cc) in [
                ("edge: tile over 8 pages, page 8", (8, 6, 8, 128, c)),
                ("edge: tile over 2 pages, page 32", (8, 6, 32, 32, c)),
                ("edge: nb x page 592", (8, 6, 16, 37, c)),
                ("edge: one split, T 200", (4, 200, 16, 40, 300))]:
            cases.append((label, paged_case(dev, dtype, B, T, 12, 2, 128,
                                            page, nb, cc, seed=20)))
        q, k, v, pos, table, qpos = paged_case(dev, dtype, 8, 6, 12, 2, 128,
                                               16, 64, c, seed=21)
        holes = table.clone()
        n_live = -(-(c + 6) // 16)
        holes[:, 0] = -1
        holes[:, n_live // 2] = k.shape[0] + 7
        holes[:, n_live - 1] = 2 ** 30
        cases += [("edge: -1, out-of-pool ids in live tiles",
                   (q, k, v, pos, holes, qpos)),
                  ("edge: every table entry -1",
                   (q, k, v, pos, torch.full_like(table, -1), qpos))]
        # phase 3d's shared prefix: all 8 rows' tables name the same first
        # 20 pages (a 320-token system prompt), each row its own after them
        q, k, v, pos, table, qpos = paged_case(dev, dtype, 8, 6, 12, 2, 128,
                                               16, 64, c, seed=22)
        shared = table.clone()
        shared[:, :20] = table[0, :20]
        cases.append((PAGED_SHARED, (q, k, v, pos, shared, qpos)))
        for label, inp in cases:
            hd = inp[0].shape[-1]
            before = ops.launches["paged_decode_attention"]
            o, m, l = ops.paged_decode_attention(*inp, scale=hd ** -0.5,
                                                 return_stats=True)
            torch.cuda.synchronize()
            if ops.launches["paged_decode_attention"] != before + 1:
                fail(f"paged_decode_attention {label}: a call moved the "
                     f"launch count by "
                     f"{ops.launches['paged_decode_attention'] - before}")
            po, pm, pl = ops.paged_decode_attention_plain(
                *inp, scale=hd ** -0.5, return_stats=True)
            err = compare("paged_decode_attention", o, po, dtype, label)
            check_stats("paged_decode_attention", label, dtype, (m, l),
                        (pm, pl))
            if "every table entry -1" in label and not (
                    o.abs().max().item() == 0.0 and (l == 0).all()
                    and (m == -1e30).all()):
                fail(f"paged_decode_attention {label} {dtype}: not zeros "
                     f"with l 0, m -1e30")
            if dtype == "bfloat16" and label in dict(paged_main):
                worst["paged_decode_attention"] = max(
                    worst["paged_decode_attention"], err)
            if dtype == "bfloat16" and (label in dict(paged_main)
                                        or label == PAGED_SHARED):
                rows[("paged_decode_attention", label)] = inp

        g = torch.Generator(device=dev).manual_seed(1)
        # the paths' shapes (prefill, training tap, an admission bucket)
        # first, then the JAX kernel sweep's and the edges of the
        # tensor-core body: ragged query and key tiles, one token, Sq != Skv
        # and keys at index >= kv_len
        flash = [(label, shp, True, 0, 0.0, 0) for label, shp in FLASH_MAIN]
        for shp in [(2, 128, 128, 4, 2, 64), (1, 256, 256, 4, 4, 32),
                    (1, 64, 192, 2, 1, 128), (2, 96, 96, 6, 2, 64)]:
            for causal, window, cap in [(True, 0, 0.0), (True, 64, 0.0),
                                        (True, 0, 50.0), (False, 0, 0.0)]:
                flash.append((f"sweep {shp} c{int(causal)} w{window} cap{cap:g}",
                              shp, causal, window, cap, 0))
        for shp, causal, kv_len in [((8, 500, 500, 12, 2, 128), True, 0),
                                    ((1, 1, 1, 12, 2, 128), True, 0),
                                    ((2, 100, 300, 4, 2, 64), True, 0),
                                    ((2, 300, 100, 4, 2, 64), True, 0),
                                    ((2, 256, 256, 4, 2, 64), True, 200),
                                    ((2, 200, 256, 4, 2, 128), False, 150)]:
            flash.append((f"edge {shp} c{int(causal)} kv_len {kv_len}", shp,
                          causal, 0, 0.0, kv_len))
        for label, shp, causal, window, cap, kv_len in flash:
            B, Sq, Skv, H, KV, hd = shp
            q, k, v = qkv(g, dev, dtype, (B, Sq, H, hd), (B, Skv, KV, hd))
            kw = dict(scale=hd ** -0.5, causal=causal, window=window,
                      softcap=cap, kv_len=kv_len)
            o = ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = compare("flash_attention", o,
                          ops.flash_attention_plain(q, k, v, **kw), dtype,
                          label)
            if dtype == "bfloat16" and label in dict(FLASH_MAIN):
                if label == "target prefill":
                    worst["flash_attention"] = err
                rows[("flash_attention", label)] = (q, k, v)

        # gemma2-27b: softcap 50 and query scale 144^-0.5, 32 query heads
        # over 16 KV heads (its drafter 36/36, uncapped, as the path runs
        # it); decode and paged at the serving path's verify, draft and
        # extend phase-1 shapes and verify phase 2, a local layer's ring of
        # 4096 + 6 slots after position 4700 (wrapped; the window's edge
        # falls inside a split chunk), the cap with scores 8x larger; flash
        # at the prefill and past the window. Then head dim 256 (gemma-7b's
        # serving shapes and the edges of the hd-256 bodies), then
        # recurrentgemma-2b's MQA 10/1 at head dim 256 with its window, then
        # the MoE family's attention (dbrx, llama4)
        for name, label, inp, kw in (gemma2_cases(dev, dtype, c)
                                     + gemma7b_cases(dev, dtype, c)
                                     + rgemma_cases(dev, dtype, c)
                                     + moe_cases(dev, dtype, c)
                                     + modality_cases(dev, dtype)):
            fn = getattr(ops, name)
            before = ops.launches[name]
            if name == "flash_attention":
                o = fn(*inp, **kw)
                torch.cuda.synchronize()
                err = compare(name, o, ops.flash_attention_plain(*inp, **kw),
                              dtype, label)
            else:
                o, m, l = fn(*inp, return_stats=True, **kw)
                torch.cuda.synchronize()
                po, pm, pl = getattr(ops, f"{name}_plain")(
                    *inp, return_stats=True, **kw)
                err = compare(name, o, po, dtype, label)
                check_stats(name, label, dtype, (m, l), (pm, pl))
            if ops.launches[name] != before + 1:
                fail(f"{name} {label}: a call moved the launch count by "
                     f"{ops.launches[name] - before}")
            fam = label.split()[0]
            if dtype == "bfloat16" and fam in ("gemma2", "gemma7b",
                                               "rgemma", "dbrx", "llama4",
                                               "whisper", "internvl2"):
                fam_worst[(fam, name)] = max(fam_worst.get((fam, name), 0.0),
                                             err)
                rows[(name, label)], row_kw[(name, label)] = inp, kw

    log("phase 2: timing at the serving shapes (bfloat16; CUDA events)")
    measured = {}
    pending = []     # the rows flex_library times after every phase
    for (name, label), inp in rows.items():
        kw = row_kw.get((name, label), dict(scale=inp[0].shape[-1] ** -0.5))
        window, cap = kw.get("window", 0), kw.get("softcap", 0.0)
        # the capped, the paged and the windowed flash cases past their
        # window: flex_attention, the one PyTorch call that computes them,
        # timed after every phase (flex_library); the rest: SDPA
        flex = (cap > 0 or name == "paged_decode_attention"
                or (name == "flash_attention" and 0 < window < inp[0].shape[1]))
        if name == "decode_attention":
            q, k, v, kpos, qpos = inp
            nbytes, flops = decode_work(q, k, kpos, qpos, window)
            sets = [inp] + [tuple(x.clone() for x in inp)
                            for _ in range(n_sets(nbytes) - 1)]
            ms = time_ms(lambda *a: ops.decode_attention(
                *a, return_stats=True, **kw), sets, 200)
            plain_ms = time_ms(lambda *a: ops.decode_attention_plain(
                *a, return_stats=True, **kw), sets[:2], 10, host_us=5000)
            lib = None if flex else sdpa_decode(*inp, window=window)
        elif name == "paged_decode_attention":
            q, k, v, pos, table, qpos = inp
            nbytes, flops = paged_work(q, k, pos, table, qpos)
            sets = [inp] + [tuple(x.clone() for x in inp)
                            for _ in range(n_sets(nbytes) - 1)]
            ms = time_ms(lambda *a: ops.paged_decode_attention(
                *a, return_stats=True, **kw), sets, 200)
            plain_ms = time_ms(lambda *a: ops.paged_decode_attention_plain(
                *a, return_stats=True, **kw), sets[:2], 10, host_us=5000)
            lib = None
        else:
            q, k, v = inp
            causal = kw.get("causal", True)
            nbytes, flops = flash_work(q, k, window, causal)
            sets = [inp] + [tuple(x.clone() for x in inp)
                            for _ in range(n_sets(nbytes) - 1)]
            ms = time_ms(lambda *a: ops.flash_attention(*a, **kw), sets, 50)
            plain_ms = time_ms(lambda *a: ops.flash_attention_plain(*a, **kw),
                               sets[:2], 5, host_us=5000)
            lib = None if flex else sdpa_flash(*inp, causal=causal)
        lib_ms = None if flex else time_ms(lambda: lib(), [()], 100)
        bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
        measured[(name, label)] = dict(ms=ms, plain_ms=plain_ms,
                                       library_ms=lib_ms, bound_ms=bound_ms,
                                       bound_by=bound_by, bytes=nbytes,
                                       flops=flops)
        if flex:
            lib_txt = "flex_attention: see the end"
            measured[(name, label)]["library"] = "flex_attention"
            pending.append(((name, label), tuple(x.cpu() for x in inp), kw))
        else:
            lib_txt = f"sdpa {lib_ms * 1e3:8.1f} us"
        log(f"  {name:22s} {label:32s} {ms * 1e3:9.1f} us  plain "
            f"{plain_ms * 1e3:9.1f} us  {lib_txt}  bound "
            f"{bound_ms * 1e3:6.2f} us ({bound_by}; {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP)")
    dec = measured[("decode_attention", "whisper cross verify decode")]
    fl = measured[("flash_attention", "whisper cross verify flash")]
    log(f"phase 2: whisper's decode-mode cross-attention (B 8, 6 queries over "
        f"1500 frames): the decode kernel (keys at position 0) "
        f"{dec['ms'] * 1e3:.1f} us, flash without the causal mask "
        f"{fl['ms'] * 1e3:.1f} us; the path runs the decode kernel")
    log("phase 2: the MTP kernel against its plain version")
    measured["mtp_attention"] = check_mtp(ops, dev, compare)
    log("phase 2: the worst share of the limit, per kernel: " + ", ".join(
        f"{name} {dtype} {share:.3f}"
        for (name, dtype), share in sorted(shares.items())))
    log("phase 2: flash training attention gradients (float32, TF32 off)")
    check_mtp_backward(dev)
    return worst, measured, fam_worst, pending


def flex_library(ops, dev, pending, measured):
    """The library call of phase 2's capped and paged rows, torch's
    compiled flex_attention, timed after every phase: its compilation
    leaves a thread in the process that slowed the next serving phase's
    host-bound step by ~11% (H100 80GB HBM3). Each is first held against
    the plain version, to show its time is of the same function: flex
    rounds the probabilities to bfloat16 before P.V, so the kernels' limit
    is too tight for it; a sixteenth of the output's scale still catches
    another mask, scale or cap (the 8x scores case)."""
    log("library calls of the capped and paged rows: torch's compiled "
        "flex_attention (bfloat16; CUDA events)")
    for (name, label), inp, kw in pending:
        inp = tuple(x.to(dev) for x in inp)
        scale, cap = kw["scale"], kw.get("softcap", 0.0)
        if name == "decode_attention":
            lib = flex_decode(*inp, scale, cap, kw.get("window", 0))
        elif name == "paged_decode_attention":
            lib = flex_paged(*inp, scale, cap)
        else:
            lib = flex_flash(*inp, scale, cap, kw.get("window", 0))
        want = getattr(ops, f"{name}_plain")(*inp, **kw).float()
        got = lib().transpose(1, 2).float()
        err = (got - want).abs().max().item()
        if not err <= want.abs().max().item() / 16:
            fail(f"flex_attention at {name} {label}: max abs err {err} off "
                 f"the plain version (max |plain| "
                 f"{want.abs().max().item()})")
        m = measured[(name, label)]
        m["library_ms"] = time_ms(lambda: lib(), [()], 100, host_us=1000)
        m["library_max_abs_err"] = err
        log(f"  {name:22s} {label:32s} {m['ms'] * 1e3:9.1f} us  "
            f"flex_attention {m['library_ms'] * 1e3:9.1f} us (max abs err "
            f"{err:.2e})")


# ---------------------------------------------------------------------------
# phase 2: the MTP kernel
# ---------------------------------------------------------------------------

def mtp_layout(n, K, r, seed, pad_to=64):
    """A COD layout (pos, depth) of length expanded_length(n, K, r), padded
    with -1 to a multiple of ``pad_to`` (1: no padding)."""
    from repro_torch.core import cod
    pos, dep = cod.sample_cod(np.random.default_rng(seed), n, K, r)
    M = int(np.ceil(len(pos) / pad_to) * pad_to)
    return cod.pad_to(pos, dep, M)


def mtp_segment_layout(n, K, r, S, seed):
    """The largest Algorithm-1 segment of one n-token sequence: its kv set
    (the segment's queries and the depth-0 context below its boundary),
    padded to a multiple of 64 as the pipeline pads it."""
    from repro_torch.core import cod, partition
    pos, dep = cod.sample_cod(np.random.default_rng(seed), n, K, r)
    seg = max(partition.build_segments(pos, dep, n, S),
              key=lambda sg: len(sg.kv_pos))
    M = int(np.ceil(len(seg.kv_pos) / 64) * 64)
    return cod.pad_to(seg.kv_pos, seg.kv_depth, M)


def shuffled(layout, seed):
    """A layout in random order (pad rows among the real ones)."""
    perm = np.random.default_rng(seed).permutation(len(layout[0]))
    return layout[0][perm], layout[1][perm]


def mtp_case(dev, dtype, B, H, KV, hd, layouts, seed):
    """q, k, v and per-row (B, M) pos/depth on the card, one layout a row
    (padded with -1 to the longest)."""
    from repro_torch.core import cod
    g = torch.Generator(device=dev).manual_seed(seed)
    M = max(len(p) for p, _ in layouts)
    layouts = [cod.pad_to(p, d, M) for p, d in layouts]
    q, k, v = qkv(g, dev, dtype, (B, M, H, hd), (B, M, KV, hd))
    pos = torch.as_tensor(np.stack([p for p, _ in layouts]), device=dev)
    dep = torch.as_tensor(np.stack([d for _, d in layouts]), device=dev)
    return q, k, v, pos.contiguous(), dep.contiguous()


def mtp_visible(pos, dep, chunk=1024):
    """(query, key) pairs the predicate allows, per row: (B,) int64,
    counted in row chunks on the card (never an M x M mask at once)."""
    from repro_torch.core.masks import mtp_mask_predicate
    M = pos.shape[1]
    n = torch.zeros(pos.shape[0], dtype=torch.int64, device=pos.device)
    for i in range(0, M, chunk):
        n += mtp_mask_predicate(dep[:, i:i + chunk], pos[:, i:i + chunk],
                                dep, pos).sum((1, 2))
    return n


def mtp_work(q, k, pos, dep):
    """Bytes and FLOPs of an MTP call for this data: q and out once, K/V of
    the live keys (depth >= 0; each sees itself) once, pos/depth once, the
    (m, l) stats once, and 4·hd FLOPs per visible (query head, key) pair
    (the 3xTF32 split does three TF32 products of each: 3x these FLOPs on
    the tensor cores)."""
    B, M, H, hd = q.shape
    KV, es = k.shape[2], q.element_size()
    live = int((dep >= 0).sum())
    nbytes = (2 * B * M * H * hd * es + 2 * live * KV * hd * es
              + 2 * 4 * B * M + 2 * 4 * B * H * M)
    return nbytes, 4 * hd * H * int(mtp_visible(pos, dep).sum())


def sdpa_mtp(q, k, v, pos, dep):
    """One PyTorch call for the MTP function: SDPA with the dense predicate
    mask (B, 1, M, M), built here, outside the timed call."""
    from repro_torch.core.masks import mtp_mask_predicate
    mask = mtp_mask_predicate(dep, pos, dep, pos)[:, None]
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask)
    return lambda: F.scaled_dot_product_attention(
        args[0], args[1], args[2], attn_mask=args[3], enable_gqa=True)


def check_mtp(ops, dev, compare):
    """The MTP kernel against its plain version at every listed shape, in
    bfloat16 and float32, with its stats; returns the worst error per dtype
    at the training shape and the timed rows."""
    timed_labels = ("training shape n 2048 K 8 r 0.8",
                    "segment n 4096 K 8 r 0.8 S 4 (largest)")
    cases = [(timed_labels[0], 1, 12, 12, 128,
              [mtp_layout(2048, 8, 0.8, seed=0, pad_to=1)]),
             (timed_labels[1], 1, 12, 12, 128,
              [mtp_segment_layout(4096, 8, 0.8, 4, seed=0)])]
    for n, K, r in [(48, 4, 0.7), (32, 8, 0.8), (24, 2, 0.5)]:
        for B, H, KV, hd in [(2, 4, 2, 64), (1, 2, 2, 32)]:
            cases.append((f"sweep n{n} K{K} r{r} {(B, H, KV, hd)}", B, H, KV,
                          hd, [mtp_layout(n, K, r, seed=b) for b in range(B)]))
    # the edges of the depth-split walk: rows in random order, GQA segments
    # (context before an interleaved block), no chain keys at all (K 1)
    cases += [("edge: COD n 512 K 8 in random order", 1, 12, 12, 128,
               [shuffled(mtp_layout(512, 8, 0.8, seed=5), seed=5)]),
              ("edge: segments n 1024 S 4, GQA 4/2", 2, 4, 2, 64,
               [mtp_segment_layout(1024, 8, 0.8, 4, seed=b)
                for b in range(2)]),
              ("edge: no chain keys, n 700 K 1", 1, 12, 12, 128,
               [mtp_layout(700, 1, 0.8, seed=6)])]
    worst, timed = {}, {}
    for dtype in ("bfloat16", "float32"):
        for label, B, H, KV, hd, layouts in cases:
            inp = mtp_case(dev, dtype, B, H, KV, hd, layouts, seed=2)
            o, m, l = ops.mtp_attention(*inp, scale=hd ** -0.5,
                                        return_stats=True)
            torch.cuda.synchronize()
            po, pm, pl = ops.mtp_attention_plain(*inp, scale=hd ** -0.5,
                                                 return_stats=True)
            err = compare("mtp_attention", o, po, dtype, label)
            for stat, got, want in (("m", m, pm), ("l", l, pl)):
                rel = ((got - want).abs() / (1 + want.abs())).max().item()
                if not rel <= STATS_TOL:
                    fail(f"mtp_attention {label} {dtype}: {stat} relative "
                         f"err {rel}")
            if label in timed_labels:
                worst[(label, dtype)] = err
                timed[(label, dtype)] = inp
        # pad rows (depth -1) attend nothing and are written as zeros
        layout = mtp_layout(16, 3, 0.6, seed=0)
        inp = mtp_case(dev, dtype, 1, 2, 2, 32, [layout], seed=3)
        o, m, l = ops.mtp_attention(*inp, scale=1.0, return_stats=True)
        torch.cuda.synchronize()
        pad = torch.as_tensor(layout[1] < 0, device=dev)
        compare("mtp_attention", o, ops.mtp_attention_plain(*inp, scale=1.0),
                dtype, "padding rows n 16 K 3 r 0.6 in 64")
        if (o[:, pad].abs().max().item() != 0.0 or (l[..., pad] != 0).any()
                or (m[..., pad] != -1e30).any()):
            fail(f"mtp_attention {dtype}: pad rows are not zero (l 0, m "
                 f"-1e30)")
    log("  mtp_attention pad rows: out exactly 0, l 0, m -1e30 (bf16, f32)")

    log("phase 2: MTP timing (CUDA events; main path dtype float32)")
    measured = {}
    for (label, dtype), inp in timed.items():
        q, k, v, pos, dep = inp
        hd = q.shape[-1]
        nbytes, flops = mtp_work(q, k, pos, dep)
        sets = [inp] + [tuple(x.clone() for x in inp)
                        for _ in range(n_sets(nbytes) - 1)]
        ms = time_ms(lambda *a: ops.mtp_attention(
            *a, scale=hd ** -0.5, return_stats=True), sets, 5, host_us=2000)
        plain_ms = time_ms(lambda *a: ops.mtp_attention_plain(
            *a, scale=hd ** -0.5, return_stats=True), sets[:1], 3,
            host_us=200000)
        lib = sdpa_mtp(*inp)
        lib_ms = time_ms(lambda: lib(), [()], 5, host_us=2000)
        del lib
        # of the kernel's time: the wrapper's index lists (one int32 sort)
        lists_ms = time_ms(ops.mtp_key_lists, [(pos, dep)], 20, host_us=500)
        dt_ms, dt_by = bound(nbytes, flops, dtype)
        # float32 runs as three TF32 products on the tensor cores, bfloat16
        # (exact in TF32) as one for S and two for P·V
        tc_flops = flops * (3 if dtype == "float32" else 1.5)
        tc_ms, tc_by = bound(nbytes, tc_flops, "tf32")
        # the least time the card could take: the smaller of the two
        bound_ms, bound_by = min((dt_ms, dt_by), (tc_ms, tc_by))
        measured[(label, dtype)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=bound_by, bound_dtype_ms=dt_ms, bound_tc_ms=tc_ms,
            lists_ms=lists_ms, bytes=nbytes, flops=flops,
            max_abs_err=worst[(label, dtype)], M=q.shape[1])
        log(f"  mtp_attention {label:38s} {dtype:8s} {ms:8.3f} ms (index "
            f"lists {lists_ms:.3f} ms of it)  plain "
            f"{plain_ms:8.3f} ms  sdpa {lib_ms:8.3f} ms  bound {bound_ms:7.4f}"
            f" ms ({bound_by}; {nbytes / 1e6:.1f} MB, M {q.shape[1]}): "
            f"{dt_ms:7.4f} ms ({dt_by}; {flops / 1e9:.2f} GFLOP at the "
            f"{dtype} peak), {tc_ms:7.4f} ms ({tc_by}; {tc_flops / 1e9:.2f} "
            f"GFLOP of 3xTF32 products at the TF32 tensor-core peak)")
        torch.cuda.empty_cache()
    return measured


def check_mtp_backward(dev):
    """Gradients of the flash training attention (the kernel's forward and
    its saved m, l; the plain recompute-by-block backward) against autograd
    through the plain version, float32 at M 1998 (n 480, K 8, r 0.8), the
    drafter's 12/12 heads, hd 128."""
    from repro_torch.core.flash_train import mtp_flash_attention
    from repro_torch.kernels import ops
    layout = mtp_layout(480, 8, 0.8, seed=4, pad_to=1)
    q, k, v, pos, dep = mtp_case(dev, "float32", 1, 12, 12, 128, [layout],
                                 seed=5)
    g = torch.Generator(device=dev).manual_seed(6)
    cot = torch.randn(q.shape, generator=g, device=dev)
    before = ops.launches["mtp_attention"]
    grads = {}
    for name, fn in (("kernel", mtp_flash_attention),
                     ("plain", ops.mtp_attention_plain)):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, pos, dep, scale=128 ** -0.5)
        grads[name] = torch.autograd.grad(out, leaves, cot)
    torch.cuda.synchronize()
    if ops.launches["mtp_attention"] != before + 1:
        fail("the flash training attention did not launch the MTP kernel")
    for t, got, want in zip("qkv", grads["kernel"], grads["plain"]):
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        log(f"  d{t}: max abs err {err:.3e} (max |grad| {scale:.3e}, "
            f"{err / (GRAD_TOL * scale):.2f} of the limit)")
        if not err <= GRAD_TOL * scale:
            fail(f"flash training attention d{t} differs from autograd "
                 f"through the plain version by {err} > {GRAD_TOL} x {scale}")


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_attention(ops):
    """Route the model's attention through the plain versions (on the card)
    to make a reference run; the kernels' counters do not move."""
    saved = (ops.decode_attention, ops.paged_decode_attention,
             ops.flash_attention)
    ops.decode_attention = ops.decode_attention_plain
    ops.paged_decode_attention = ops.paged_decode_attention_plain
    ops.flash_attention = ops.flash_attention_plain
    try:
        yield
    finally:
        (ops.decode_attention, ops.paged_decode_attention,
         ops.flash_attention) = saved


def main_path(ops, dev):
    from repro_torch.launch.serve import build_engine, random_prompts
    B, P, NEW, K, MAX_LEN = 8, 512, 128, 5, 1024
    log(f"phase 3: full-width qwen2-1.5b bfloat16, 4-layer parallel drafter, "
        f"batch {B}, prompt {P}, max_new {NEW}, K {K}, max_len {MAX_LEN}")
    t0 = time.perf_counter()
    eng = build_engine(mode="parallel", K=K, max_new=NEW, max_len=MAX_LEN,
                       batch=B, seed=0, device=dev)
    torch.cuda.synchronize()
    cfg = eng.tcfg
    log(f"  weights built in {time.perf_counter() - t0:.1f} s "
        f"(layers {cfg.n_layers}, d {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, vocab {cfg.vocab_size}, drafter d "
        f"{eng.dcfg.d_model} heads {eng.dcfg.n_heads}/{eng.dcfg.n_kv_heads} "
        f"d_ff {eng.dcfg.d_ff})")
    prompts = random_prompts(cfg.vocab_size, B, P, seed=0)
    eng.run(prompts, max_iters=8)                      # cold run, 8 steps
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    r = eng.run(prompts)
    counts = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    steps = r["steps"]
    log(f"  warm run: otps {r['otps']:.1f} tok/s, prefill {r['prefill_s']:.4f}"
        f" s, decode {r['decode_s']:.4f} s over {steps} steps "
        f"({r['decode_s'] / steps * 1e3:.2f} ms/step), AL "
        f"{r['acceptance_length']:.4f}, new tokens {r['new_tokens']}, peak "
        f"memory {peak_gb:.2f} GB")
    log(f"  launches: {counts}")
    n_d = eng.dcfg.n_layers
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": 2 * n_d + steps * (2 * cfg.n_layers + 4 * n_d),
            "paged_decode_attention": 0, "mtp_attention": 0}
    if counts != want:
        fail(f"launch counts {counts} != expected {want}")
    state = r["state"]
    if not bool((state["new_count"] == NEW).all()):
        fail(f"new_count {state['new_count'].tolist()} != {NEW}")
    toks = torch.as_tensor(r["tokens"])
    gen = toks[:, P:P + NEW]
    if toks.shape != (B, MAX_LEN) or gen.min() < 0 or gen.max() >= cfg.vocab_size:
        fail("generated tokens out of range")
    lp = state["logprobs"][:, P:P + NEW]
    if not bool(torch.isfinite(lp).all()) or float(lp.max()) > 0:
        fail("logprobs are not finite log-probabilities")
    if not (1.0 <= r["acceptance_length"] <= K + 1):
        fail(f"acceptance length {r['acceptance_length']} out of [1, K+1]")

    result = dict(otps=r["otps"], prefill_s=r["prefill_s"],
                  decode_s=r["decode_s"], steps=steps,
                  decode_ms_per_step=r["decode_s"] / steps * 1e3,
                  acceptance_length=r["acceptance_length"],
                  peak_memory_gb=peak_gb, launches=counts)
    del eng, state, r
    torch.cuda.empty_cache()
    return result


def scheduler_path(ops, dev):
    """Phase 3b: continuous batching over the paged layout at full width."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.scheduler import Request, Scheduler
    B, MAX_LEN, PAGE, POOL, N, K = 8, 1024, 16, 256, 24, 5
    log(f"phase 3b: Scheduler.serve, full-width qwen2-1.5b bfloat16, "
        f"parallel K {K}, batch {B}, max_len {MAX_LEN}, paged: page {PAGE}, "
        f"pool {POOL} pages, incremental growth; {N} requests, prompts "
        f"256-640, budgets 64-192, Exp(1) arrival gaps, sync_every 1")
    eng = build_engine(mode="parallel", K=K, max_new=192, max_len=MAX_LEN,
                       batch=B, seed=0, device=dev, kv_layout="paged",
                       page_size=PAGE, pool_pages=POOL)
    cfg, V = eng.tcfg, eng.tcfg.vocab_size
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 641, N)
    budgets = rng.integers(64, 193, N)
    arrivals = np.cumsum(rng.exponential(1.0, N))
    prompts = [rng.integers(0, V - 1, n).astype(np.int32) for n in lens]

    def requests():
        return [Request(p, max_new_tokens=int(b), arrival_time=float(t))
                for p, b, t in zip(prompts, budgets, arrivals)]

    sched = Scheduler(eng, sync_every=1)
    # cold run: the first 8 requests with 8-token budgets, all at once
    sched.serve([Request(p, max_new_tokens=8) for p in prompts[:8]])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eng.allocator.reset_stats()
    ops.reset_launches()
    rep = sched.serve(requests())
    counts = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    it, pre = rep["iterations"], rep["preemptions"]
    admissions = N + pre
    log(f"  warm run: otps {rep['otps']:.1f} tok/s, wall {rep['wall_s']:.3f} s"
        f" ({rep['wall_s'] / it * 1e3:.2f} ms/iteration over {it}), otps_vt "
        f"{rep['otps_vt']:.4f}, p50/p99 latency_vt {rep['p50_latency_vt']:.2f}"
        f"/{rep['p99_latency_vt']:.2f}, p50/p99 wait_vt "
        f"{rep['p50_wait_vt']:.2f}/{rep['p99_wait_vt']:.2f}, makespan_vt "
        f"{rep['makespan_vt']:.2f}, AL {rep['weighted_acceptance_length']:.4f}"
        f", preemptions {pre}, peak pages {rep['peak_pages']}/{POOL}, new "
        f"tokens {rep['total_new_tokens']}, peak memory {peak_gb:.2f} GB")
    log(f"  launches: {counts}")
    n_d = eng.dcfg.n_layers
    want = sched_launches_want(cfg, n_d, it, admissions)
    if counts != want:
        fail(f"scheduler launch counts {counts} != expected {want} "
             f"({it} iterations, {admissions} admissions)")
    res = rep["results"]
    if len(res) != N or len({r["rid"] for r in res}) != N:
        fail(f"{len(res)} results for {N} requests")
    for r, b in zip(res, budgets):
        toks = r["tokens"]
        if r["n_new"] != b or len(toks) != b:
            fail(f"request {r['rid']} emitted {r['n_new']} tokens, budget {b}")
        if toks.min() < 0 or toks.max() >= V:
            fail(f"request {r['rid']} emitted tokens out of range")
        if not (np.isfinite(r["logprobs"]).all() and r["logprobs"].max() <= 0):
            fail(f"request {r['rid']} logprobs are not log-probabilities")
    if not pre > 0:
        fail("no request was preempted: the pool was meant to run out")
    if eng.allocator.n_used != 0:
        fail(f"{eng.allocator.n_used} pages still allocated after serve")
    result = {k: rep[k] for k in (
        "otps", "otps_vt", "wall_s", "iterations", "total_new_tokens",
        "weighted_acceptance_length", "makespan_vt", "p50_latency_vt",
        "p99_latency_vt", "p50_wait_vt", "p99_wait_vt", "preemptions",
        "peak_pages")}
    result.update(ms_per_iteration=rep["wall_s"] / it * 1e3,
                  admissions=admissions, peak_memory_gb=peak_gb,
                  launches=counts)
    del eng, sched, rep
    torch.cuda.empty_cache()
    return result


@contextlib.contextmanager
def oracle_drafts(table):
    """Replace the parallel drafter's K drafts at anchor c-1 with
    table[:, c+1 .. c+K]; the drafter still runs, so its cache is updated
    as usual."""
    from repro_torch.core import drafter as D
    saved = D.draft_parallel

    def draft(*args, **kw):
        _, logits, cache = saved(*args, **kw)
        anchor, k = args[6], args[7]
        idx = (anchor[:, None] + 2 + torch.arange(k, device=anchor.device)
               ).clamp(max=table.shape[1] - 1)
        return table.gather(1, idx.long()), logits, cache

    D.draft_parallel = draft
    try:
        yield
    finally:
        D.draft_parallel = saved


def kernel_logits_vs_plain(ops, eng, prompts, block, max_len,
                           last_only=False, extras=None):
    """Full-width float32 target logits through the kernels against the same
    forward with the plain attention: a prefill into a fresh cache (flash)
    with the target's ``extras`` and a verify block at the next positions
    (after a VLM target's vision positions) read against it (decode, both
    phases). ``last_only``: the prefill's logits at its last position only
    (a long prompt's (B, P, V) logits would not fit twice). Returns the two
    max abs errors."""
    B, P = prompts.shape
    T = block.shape[1]
    positions = (P + eng.pos_offset + torch.arange(
        T, dtype=torch.int32, device=block.device))[None].repeat(B, 1)
    logits = {}
    for name, ctx in (("kernels", contextlib.nullcontext()),
                      ("plain", plain_attention(ops))):
        with ctx, torch.no_grad():
            cache = eng.model.make_cache(B, max_len, dtype=torch.float32,
                                         device=block.device)
            pre = eng.model.forward(eng.tparams, prompts, mode="prefill",
                                    cache=cache, collect_taps=False,
                                    head_last_only=last_only,
                                    **(extras or {}))
            ver = eng.model.forward(eng.tparams, block, mode="decode",
                                    positions=positions, cache=pre.cache,
                                    collect_taps=False)
            logits[name] = (pre.logits, ver.logits)
            del cache, pre, ver
    errs = []
    for i, what in enumerate((f"prefill {tuple(prompts.shape)} (flash)",
                              f"verify {tuple(block.shape)} against the "
                              f"cache (decode)")):
        got, want = logits["kernels"][i], logits["plain"][i]
        err = (got - want).abs().max().item()
        errs.append(err)
        log(f"  float32 logits, {what}, kernels vs plain attention: max abs "
            f"err {err:.3e} (max |logit| {want.abs().max().item():.3f})")
        if not err <= REF_TOL:
            fail(f"{what} logits through the kernels differ from the plain "
                 f"reference by {err} > {REF_TOL}")
    return errs


def losslessness(ops, dev):
    from repro_torch.launch.serve import build_engine, random_prompts
    B, P, NEW, K, MAX_LEN = 4, 128, 32, 5, 256
    log(f"phase 4: greedy losslessness, full width float32, batch {B}, "
        f"prompt {P}, max_new {NEW}, K {K}")
    toks, engines = {}, {}
    for mode in ("none", "parallel", "ar"):
        eng = build_engine(mode=mode, dtype="float32", K=K, max_new=NEW,
                           max_len=MAX_LEN, batch=B, seed=0, device=dev)
        prompts = random_prompts(eng.tcfg.vocab_size, B, P, seed=1)
        runs = [(mode, eng.run(prompts))]
        if mode == "parallel":
            # oracle drafts: the none run's tokens, a seeded fifth spoiled
            ref = none_full
            bad = np.random.default_rng(2).random(ref.shape) < 0.2
            table = np.where(bad, (ref + 1) % (eng.tcfg.vocab_size - 1), ref)
            with oracle_drafts(torch.as_tensor(table, dtype=torch.int32,
                                               device=dev)):
                runs.append(("oracle", eng.run(prompts)))
        for name, r in runs:
            toks[name] = r["tokens"][:, :P + NEW]
            log(f"  {name:8s} steps {r['steps']:3d} AL "
                f"{r['acceptance_length']:.3f} decode {r['decode_s']:.3f} s")
        if mode == "none":
            none_full = r["tokens"]
            engines["none"] = eng
        else:
            del eng
        if mode == "parallel" and not r["acceptance_length"] > ORACLE_MIN_AL:
            fail(f"oracle drafts reached AL {r['acceptance_length']}, not "
                 f"above {ORACLE_MIN_AL}: the accept path did not run")
    # paged Scheduler.serve under pool pressure: 30 pages of 16 hold three
    # of the four requests' prompts, and their growth preempts
    from repro_torch.serving.scheduler import Request, Scheduler
    eng = build_engine(mode="parallel", dtype="float32", K=K, max_new=NEW,
                       max_len=MAX_LEN, batch=B, seed=0, device=dev,
                       kv_layout="paged", page_size=16, pool_pages=30)
    rep = Scheduler(eng).serve([Request(p, max_new_tokens=NEW)
                                for p in prompts])
    toks["paged"] = np.concatenate(
        [prompts, np.stack([r["tokens"] for r in rep["results"]])], 1)
    log(f"  paged    iterations {rep['iterations']:3d} preemptions "
        f"{rep['preemptions']} peak pages {rep['peak_pages']}/30")
    if not (rep["preemptions"] > 0 and eng.allocator.n_used == 0):
        fail(f"paged serve: {rep['preemptions']} preemptions, "
             f"{eng.allocator.n_used} pages left allocated")
    del eng
    ref_eng = engines["none"]
    kernel_logits_vs_plain(
        ops, ref_eng, torch.as_tensor(prompts, device=dev),
        torch.as_tensor(toks["none"][:, P:P + K + 1], device=dev), MAX_LEN)
    for mode in ("parallel", "ar", "oracle", "paged"):
        diff = (toks[mode] != toks["none"])
        if not diff.any():
            log(f"  {mode}: all {B * NEW} generated tokens equal to none")
            continue
        for b in range(B):
            where = diff[b].nonzero()[0]
            if not len(where):
                continue
            pos = int(where[0])
            ctx = torch.as_tensor(toks["none"][b:b + 1, :pos], device=dev)
            with torch.no_grad():
                logits = ref_eng.model.forward(ref_eng.tparams, ctx,
                                               head_last_only=True).logits[0, -1]
            top2 = logits.topk(2).values
            gap = float(top2[0] - top2[1])
            log(f"  {mode}: row {b} first differs at position {pos}; none's "
                f"top-2 logit gap there {gap:.3e}")
            if gap >= NEAR_TIE:
                fail(f"{mode} row {b} differs from none at {pos} with top-2 "
                     f"gap {gap} >= {NEAR_TIE}")
    del engines, ref_eng
    torch.cuda.empty_cache()
    return {"prompts": prompts, "none": toks["none"]}


# ---------------------------------------------------------------------------
# phase 3c / 4b: sampled serving
# ---------------------------------------------------------------------------

# threefry words from JAX 0.9.0 (jax_threefry_partitionable=True), the
# reference the port's PRNG is bitwise equal to on the CPU
PRNG_KNOWN = {
    "fold_in(PRNGKey(7), 3)": [276534068, 1641862660],
    "split(PRNGKey(7), 3)": [[3625411723, 1954958720],
                             [195045567, 4062205631],
                             [966301609, 1948237315]],
    "bits(PRNGKey(1234), (4,))": [3715183467, 3461522409, 1578076316,
                                  3641478021],
    "uniform(PRNGKey(1234), (4,)) bits": [1063088434, 1062097570, 1052516112,
                                          1062800522],
    "categorical(PRNGKey(1234), log [.1 .2 .3 .4])": 3,
    "step_keys(seed 1234, [517, 518])": [[4162650630, 3893356881],
                                         [3651137254, 884596093]],
    "draft_keys(seed 1234, 517, K 3)": [[1546567615, 1943629236],
                                        [3829688118, 1817850175],
                                        [1043616496, 743150992]],
}
# the sampled phase's policy; a sampled decision's margin below this may
# part two runs (the near-tie rule of the CPU parity tests)
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
SAMPLED_NEAR_TIE = 1e-4


def prng_answers(dev):
    from repro_torch import prng
    from repro_torch.serving import sampling as S
    k7, k1234 = prng.PRNGKey(7, device=dev), prng.PRNGKey(1234, device=dev)
    samp = S.batch_sampling_state(S.SamplingParams(seed=1234), 2, device=dev)
    return {
        "fold_in(PRNGKey(7), 3)": prng.fold_in(k7, 3).tolist(),
        "split(PRNGKey(7), 3)": prng.split(k7, 3).tolist(),
        "bits(PRNGKey(1234), (4,))": prng.bits(k1234, (4,)).tolist(),
        "uniform(PRNGKey(1234), (4,)) bits":
            prng.uniform(k1234, (4,)).view(torch.int32).tolist(),
        "categorical(PRNGKey(1234), log [.1 .2 .3 .4])": prng.categorical(
            k1234, torch.log(torch.tensor([.1, .2, .3, .4], device=dev))
        ).item(),
        "step_keys(seed 1234, [517, 518])": S.step_keys(
            samp, torch.tensor([517, 518], device=dev)).tolist(),
        "draft_keys(seed 1234, 517, K 3)": S.draft_keys(samp, 517, 3)[0]
        .tolist(),
    }


def check_prng(dev):
    from repro_torch import prng
    for where in (torch.device("cpu"), dev):
        got = prng_answers(where)
        for name, want in PRNG_KNOWN.items():
            if got[name] != want:
                fail(f"prng on {where}: {name} = {got[name]}, want {want}")
    n = 1 << 20
    keys = prng.split(prng.PRNGKey(5), 3)
    for i, k in enumerate(keys):
        cpu = prng.uniform(k, (n,)).view(torch.int32)
        card = prng.uniform(k.to(dev), (n,)).view(torch.int32).cpu()
        if not torch.equal(cpu, card):
            fail(f"prng: 2^20 uniforms of key {i} differ between the card "
                 f"and the CPU at {int((cpu != card).sum())} places")
    log(f"  prng: known answers equal on the CPU and the card; 3 x 2^20 "
        f"uniforms bitwise equal between them")


def first_token_chi2(dev, sampled_drafts, N=1 << 14):
    """(statistic, threshold, draws outside the support) of the first
    committed token of rejection_verify_rows over N seeded rows against
    the warped target (the CPU test's check, on the card)."""
    from scipy.stats import chi2
    from repro_torch import prng
    from repro_torch.core import spec_decode as SD
    V, K = 8, 3
    g = np.random.default_rng(0)
    logits = torch.from_numpy((1.5 * g.standard_normal((1, K + 1, V)))
                              .astype(np.float32)).to(dev)
    p = SD.warp_probs(logits, torch.tensor([0.8], device=dev),
                      torch.tensor([6], device=dev),
                      torch.tensor([1.0], device=dev))[0]
    q = torch.softmax(torch.from_numpy(g.standard_normal((K, V)).astype(
        np.float32)).to(dev), -1)
    keys = prng.split(prng.PRNGKey(0, device=dev), N)
    kd, kv = prng.split(keys, 2).unbind(1)
    if sampled_drafts:
        drafts = prng.categorical(prng.split(kd, K), torch.log(q)[None])
        dprobs = q.expand(N, K, V)
    else:
        drafts = q.argmax(-1).expand(N, K)
        dprobs = F.one_hot(drafts, V).float()
    _, committed = SD.rejection_verify_rows(
        kv, drafts.to(torch.int32), dprobs, p.expand(N, K + 1, V))
    obs = torch.bincount(committed[:, 0].long(), minlength=V).cpu().numpy()
    exp = p[0].cpu().numpy().astype(np.float64) * N
    live = exp > 0
    stat = float((((obs - exp) ** 2)[live] / exp[live]).sum())
    return stat, float(chi2.ppf(0.999, live.sum() - 1)), int(obs[~live].sum())


def sched_launches_want(cfg, n_d, iterations, admissions):
    return {"paged_decode_attention": iterations * (cfg.n_layers + 2 * n_d),
            "decode_attention": iterations * (cfg.n_layers + 2 * n_d)
            + admissions * 2 * n_d,
            "flash_attention": admissions * cfg.n_layers, "mtp_attention": 0}


def sampled_throughput(ops, dev, path, sched):
    """bfloat16 full width, the depth cut to SAMPLED_LAYERS: Engine.run
    under the sampled policy with draft sampling off and on (phase 3's
    shapes), and a mixed Scheduler.serve (phase 3b's traffic, odd requests
    sampled); launch counts as greedy."""
    import dataclasses
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.scheduler import Request, Scheduler
    B, P, NEW, K, MAX_LEN = 8, 512, 128, 5, 1024
    sp = SamplingParams(seed=0, **SAMPLED)
    log(f"  Engine.run, {SAMPLED}, seed 0, phase 3's shapes, "
        f"{SAMPLED_LAYERS} of 28 layers (cut for time)")
    eng = build_engine(mode="parallel", n_layers=SAMPLED_LAYERS, K=K,
                       max_new=NEW, max_len=MAX_LEN, batch=B, seed=0,
                       device=dev, sampling=sp)
    cfg, n_d = eng.tcfg, eng.dcfg.n_layers
    prompts = random_prompts(cfg.vocab_size, B, P, seed=0)
    out = {}
    for ds in (False, True):
        e = Engine(cfg, eng.dcfg, eng.tparams, eng.dparams,
                   dataclasses.replace(eng.ecfg, draft_sampling=ds), B,
                   device=dev)
        e.run(prompts, max_iters=4)                    # warm-up
        ops.reset_launches()
        r = e.run(prompts)
        counts = dict(ops.launches)
        steps = r["steps"]
        want = {"flash_attention": cfg.n_layers,
                "decode_attention": 2 * n_d + steps * (2 * cfg.n_layers
                                                       + 4 * n_d),
                "paged_decode_attention": 0, "mtp_attention": 0}
        if counts != want:
            fail(f"sampled Engine.run (draft_sampling {ds}): launch counts "
                 f"{counts} != the greedy path's {want}")
        if not bool((r["state"]["new_count"] == NEW).all()):
            fail(f"sampled run: new_count {r['state']['new_count'].tolist()}")
        gen = r["tokens"][:, P:P + NEW]
        if gen.min() < 0 or gen.max() >= cfg.vocab_size:
            fail("sampled run: tokens out of range")
        row = dict(otps=r["otps"], decode_ms_per_step=r["decode_s"] / steps
                   * 1e3, steps=steps, acceptance_length=r["acceptance_length"],
                   prefill_s=r["prefill_s"], launches=counts)
        out[f"engine_run_draft_sampling_{'on' if ds else 'off'}"] = row
        log(f"    draft_sampling {'on ' if ds else 'off'}: otps "
            f"{row['otps']:.1f} tok/s, {row['decode_ms_per_step']:.2f} ms/step"
            f" over {steps}, AL {row['acceptance_length']:.4f} (greedy, "
            f"phase 3 at 28 layers: {path['otps']:.1f} tok/s, "
            f"{path['decode_ms_per_step']:.2f} ms/step, AL "
            f"{path['acceptance_length']:.4f}); launches as greedy")
        del e, r
    del eng
    torch.cuda.empty_cache()

    POOL, N = 256, 12       # 3b's first 12 requests (cut from 24 for time)
    log(f"  Scheduler.serve, paged, pool {POOL}, phase 3b's first {N} "
        f"requests, "
        f"even greedy, odd sampled ({SAMPLED}, seed = index), "
        f"{SAMPLED_LAYERS} of 28 layers")
    eng = build_engine(mode="parallel", n_layers=SAMPLED_LAYERS, K=K,
                       max_new=192, max_len=MAX_LEN, batch=B, seed=0,
                       device=dev, kv_layout="paged", page_size=16,
                       pool_pages=POOL)
    prompts, budgets, arrivals = sched3b_traffic(cfg.vocab_size, N)
    reqs = [Request(p, max_new_tokens=int(b), arrival_time=float(t),
                    sampling=None if i % 2 == 0
                    else SamplingParams(seed=i, **SAMPLED))
            for i, (p, b, t) in enumerate(zip(prompts, budgets, arrivals))]
    torch.cuda.synchronize()
    ops.reset_launches()
    rep = Scheduler(eng, sync_every=1).serve(reqs)
    counts = dict(ops.launches)
    it, pre = rep["iterations"], rep["preemptions"]
    want = sched_launches_want(cfg, n_d, it, N + pre)
    if counts != want:
        fail(f"sampled scheduler launch counts {counts} != the greedy "
             f"path's {want} ({it} iterations, {N + pre} admissions)")
    for r, b in zip(rep["results"], budgets):
        if r["n_new"] != b:
            fail(f"sampled serve: request {r['rid']} emitted {r['n_new']}, "
                 f"budget {b}")
    if eng.allocator.n_used:
        fail(f"{eng.allocator.n_used} pages allocated after the sampled serve")
    row = {k: rep[k] for k in ("otps", "otps_vt", "wall_s", "iterations",
                               "total_new_tokens", "preemptions",
                               "weighted_acceptance_length", "peak_pages",
                               "p50_latency_vt", "p99_latency_vt")}
    row.update(ms_per_iteration=rep["wall_s"] / it * 1e3, launches=counts,
               sampled_preempted=sum(r["n_preempt"] for r in rep["results"]
                                     if r["rid"] % 2))
    out["scheduler_mixed"] = row
    log(f"    otps {rep['otps']:.1f} tok/s, {row['ms_per_iteration']:.2f} "
        f"ms/iteration over {it}, AL {rep['weighted_acceptance_length']:.4f}"
        f", preemptions {pre} (greedy, phase 3b at 28 layers: "
        f"{sched['otps']:.1f} tok/s, "
        f"{sched['ms_per_iteration']:.2f} ms/iteration over "
        f"{sched['iterations']}, preemptions {sched['preemptions']}); "
        f"launches as greedy")
    del eng, rep
    torch.cuda.empty_cache()
    return out


def greedy_gap(eng, context):
    with torch.no_grad():
        ids = torch.as_tensor(np.asarray(context, np.int32)[None],
                              device=eng.device)
        logits = eng.model.forward(eng.tparams, ids,
                                   head_last_only=True).logits[0, -1]
    top2 = logits.topk(2).values
    return float(top2[0] - top2[1])


def streams_agree(what, eng, log_, req, got, want):
    """Fail unless ``got`` equals ``want`` up to where they part after a
    decision of margin below the near-tie limit (then compare no further);
    returns the position they part at, or None."""
    n = min(len(got), len(want))
    diff = np.flatnonzero(np.asarray(got[:n]) != np.asarray(want[:n]))
    if not len(diff) and len(got) == len(want):
        return None
    j = int(diff[0]) if len(diff) else n
    P = req.prompt.size
    if req.sampling is None or req.sampling.is_greedy:
        margin = greedy_gap(eng, np.concatenate([req.prompt, want[:j]]))
        limit = NEAR_TIE
    else:
        margin = log_.min_margin(req.sampling.seed, P, P + j)
        limit = SAMPLED_NEAR_TIE
    log(f"    {what}: request {req.rid} parts at token {j}, margin "
        f"{margin:.3e}")
    if not margin < limit:
        fail(f"{what}: request {req.rid} differs at token {j} with margin "
             f"{margin} >= {limit}")
    return P + j


def sampled_correctness(dev, greedy_ref):
    """float32 full width: seeded reproducibility, a sampled stream the
    same alone, in a mixed batch, contiguous and paged, preempted or not;
    greedy rows equal to phase 4's greedy run."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.margins import MarginLog
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.scheduler import Request, Scheduler
    B, P, NEW, K, MAX_LEN = 4, 128, 32, 5, 256
    prompts, none = greedy_ref["prompts"], greedy_ref["none"]
    log(f"  float32 full width, batch {B}, prompt {P}, max_new {NEW}, K {K}")
    eng = build_engine(mode="parallel", dtype="float32", K=K, max_new=NEW,
                       max_len=MAX_LEN, batch=B, seed=0, device=dev,
                       sampling=SamplingParams(seed=3, **SAMPLED))
    a, b = eng.run(prompts)["tokens"], eng.run(prompts)["tokens"]
    if not np.array_equal(a, b):
        fail("two sampled runs with the same seeds differ")
    log("    two seeded Engine.run calls: identical tokens")

    # even requests sampled, odd ones greedy: all arrive at once, and the
    # pool's growth preempts the lowest-priority runner, request 2
    def requests():
        return [Request(p, max_new_tokens=NEW,
                        sampling=SamplingParams.greedy() if i % 2
                        else SamplingParams(seed=10 + i, **SAMPLED))
                for i, p in enumerate(prompts)]

    paged = build_engine(mode="parallel", dtype="float32", K=K, max_new=NEW,
                         max_len=MAX_LEN, batch=B, seed=0, device=dev,
                         kv_layout="paged", page_size=16, pool_pages=30)
    runs, parted = {}, 0
    with MarginLog() as margins:
        for i in (0, 2):                           # each sampled one alone
            r = requests()[i]
            runs[f"alone {i}"] = Scheduler(eng).serve([r])["results"][0]
        for name, e in (("contiguous", eng), ("paged", paged)):
            reqs = requests()
            runs[name] = Scheduler(e).serve(reqs)
        pre = [r["n_preempt"] for r in runs["paged"]["results"]]
    if not any(pre[i] for i in (0, 2)):
        fail(f"paged mixed serve preempted no sampled request ({pre})")
    if paged.allocator.n_used:
        fail("pages left allocated after the paged mixed serve")
    reqs = requests()
    for name in ("contiguous", "paged"):
        for i, req in enumerate(reqs):
            got = runs[name]["results"][i]["tokens"]
            if i % 2:
                want = none[i, P:P + NEW]
            else:
                want = runs[f"alone {i}"]["tokens"]
            parted += streams_agree(f"{name} mixed vs "
                                    f"{'greedy' if i % 2 else 'alone'}",
                                    eng, margins, req, got, want) is not None
    log(f"    sampled requests alone == in the mixed batch (contiguous, "
        f"paged with preemptions {pre}); greedy rows == phase 4's greedy "
        f"run; {parted} streams parted at a near-tie")
    out = {"reproducible": True, "paged_preemptions": pre,
           "parted_at_near_tie": parted, "chi2": {}}
    del eng, paged
    torch.cuda.empty_cache()
    for sampled_drafts in (False, True):
        stat, limit, outside = first_token_chi2(dev, sampled_drafts)
        name = "sampled drafts" if sampled_drafts else "one-hot drafts"
        log(f"    rejection_verify_rows on the card, {name}: chi-square "
            f"{stat:.2f} < {limit:.2f} over 2^14 rows, {outside} outside "
            f"the support")
        if outside or not stat < limit:
            fail(f"chi-square of {name}: {stat} (limit {limit}), {outside} "
                 f"draws outside the support")
        out["chi2"][name] = stat
    return out


def sampled_path(ops, dev, path, sched, greedy_ref):
    log("phase 3c / 4b: sampled serving")
    check_prng(dev)
    out = sampled_throughput(ops, dev, path, sched)
    out["correctness"] = sampled_correctness(dev, greedy_ref)
    return out


# ---------------------------------------------------------------------------
# phase 3d / 4c: the prefix cache, swap-to-host and adaptive speculation
# ---------------------------------------------------------------------------

# 24 requests in 3 groups, each group's own 320-token system prompt (20 full
# pages) and a unique suffix of 16-256 tokens, then 4 requests repeating an
# earlier prompt exactly; budgets 64-192, Exp(1) arrival gaps, seed 0
POLICY_TRAFFIC = dict(n=24, prefix_len=320, groups=3, suffix_lens=(16, 256),
                      budgets=(64, 192), mean_gap=1.0, seed=0, repeats=4)
# at these lengths phase 3b's 256 pages preempt nothing once the cache is
# on (the groups share 60 pages, and cache-only pages are evicted before a
# slot stalls); 192 pages (3/8 of what 8 full rows need) preempt
POLICY_POOL = 192
HOST_POOL_BYTES = 1 << 30
# phase 3d must see at least this many of its requests admitted on hits
POLICY_MIN_HITS = 20
# phase 4c's one sampled request, among those the pool swaps out
POLICY_SAMPLED = 7


def policy_requests(vocab, sampled=None):
    """Phase 3d's traffic (``launch.serve.shared_prefix_requests``);
    ``sampled``: the index of one request to sample (SAMPLED, seed 5)."""
    from repro_torch.launch.serve import shared_prefix_requests
    from repro_torch.serving.sampling import SamplingParams
    t = POLICY_TRAFFIC
    reqs = shared_prefix_requests(vocab, t["n"], t["prefix_len"], t["groups"],
                                  t["suffix_lens"], t["budgets"],
                                  t["mean_gap"], t["seed"],
                                  repeats=t["repeats"])
    if sampled is not None:
        reqs[sampled].sampling = SamplingParams(seed=5, **SAMPLED)
    return reqs


class PolicyProbe:
    """Host-side record of what a serve did on the engine's policy paths:
    each admission (device ms, cold or served from the cache), the hit
    suffix chunks (width, first or later), each swap (device ms, bytes)
    and the draft caps of every dispatched iteration. It wraps the
    engine's and the scheduler's methods on the instances and restores
    them on exit; the timed calls are bracketed by synchronizations."""

    def __init__(self, eng, sched):
        self.eng, self.sched = eng, sched
        self.admissions, self.chunks, self.swaps = [], [], []
        self.cold_prefills = 0
        self.k_rows = {}

    def _timed(self, fn, after):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            after((time.perf_counter() - t0) * 1e3, out)
            return out
        return run

    def __enter__(self):
        eng, sched = self.eng, self.sched
        prefill, chunk = eng._admission_prefill, eng._chunk
        dispatch = sched._dispatch

        def cold(*a, **kw):
            self.cold_prefills += 1
            return prefill(*a, **kw)

        def hit_chunk(src, piece, start, greedy, hit=False):
            self.chunks.append((piece.shape[1], hit))
            return chunk(src, piece, start, greedy, hit=hit)

        def caps(run):
            for k in sched._k_row[run].tolist():
                self.k_rows[k] = self.k_rows.get(k, 0) + 1
            return dispatch(run)

        eng._admission_prefill, eng._chunk, sched._dispatch = cold, hit_chunk, caps
        eng.prefill_into_slot = self._timed(
            eng.prefill_into_slot, lambda ms, _: self.admissions.append(
                (ms, eng.last_hit_tokens)))
        eng.swap_out_slot = self._timed(
            eng.swap_out_slot, lambda ms, out: out[1] and self.swaps.append(
                ("out", ms, eng.swap_last_bytes)))
        eng.swap_in_slot = self._timed(
            eng.swap_in_slot, lambda ms, _: self.swaps.append(
                ("in", ms, eng.swap_last_bytes)))
        return self

    def __exit__(self, *exc):
        for name in ("_admission_prefill", "_chunk", "prefill_into_slot",
                     "swap_out_slot", "swap_in_slot"):
            delattr(self.eng, name)
        del self.sched._dispatch

    def launches_want(self, cfg, n_d, iterations):
        """Attention launches of the serve: each iteration 36 paged phase-1
        and 36 decode phase-2 launches; a cold admission 28 flash and 2 x 4
        decode (the drafter's extend); a hit chunk 2 x 28 decode (the
        target in decode mode, both phases) and 2 x 4 more when it runs the
        drafter's extend (a later chunk, or a first one wider than 1)."""
        step = iterations * (cfg.n_layers + 2 * n_d)
        chunks = sum(2 * cfg.n_layers + (2 * n_d if (c > 1 or not hit) else 0)
                     for c, hit in self.chunks)
        return {"paged_decode_attention": step,
                "decode_attention": step + self.cold_prefills * 2 * n_d
                + chunks,
                "flash_attention": self.cold_prefills * cfg.n_layers,
                "mtp_attention": 0}

    def summary(self):
        hit = [ms for ms, h in self.admissions if h > 0]
        cold = [ms for ms, h in self.admissions if h == 0]
        out = {"hit_admissions": len(hit), "cold_admissions": len(cold),
               "hit_admission_ms": float(np.mean(hit)) if hit else None,
               "cold_admission_ms": float(np.mean(cold)) if cold else None,
               "hit_chunks": len(self.chunks),
               "k_row_histogram": dict(sorted(self.k_rows.items()))}
        for way in ("out", "in"):
            rows = [(ms, b) for w, ms, b in self.swaps if w == way]
            ms = sum(r[0] for r in rows)
            nbytes = sum(r[1] for r in rows)
            out[f"swap_{way}"] = {"n": len(rows), "ms": ms, "bytes": nbytes,
                                  "gb_per_s": nbytes / ms / 1e6 if ms else None}
        return out


def hit_against_cold(eng, prompt, reps=3):
    """Device ms of admitting ``prompt`` cold (cache flushed) and then again
    from the pages its first admission indexed (everything but the last
    partial page is a hit), ``reps`` times each, into slot 0 of the
    engine's retained serving state."""
    state = eng.serve_state()
    cold, hit, served = [], [], []
    for _ in range(reps):
        eng.prefix_cache.flush(eng.allocator)
        for times in (cold, hit):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _, _ = eng.prefill_into_slot(state, prompt, 0, max_new=64)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            served.append(eng.last_hit_tokens)
            state = eng.free_slot(state, 0, final_tokens=prompt)
    eng.prefix_cache.flush(eng.allocator)
    eng.retain_state(state)
    return {"prompt_len": int(prompt.size), "cold_ms": cold, "hit_ms": hit,
            "hit_tokens": served[1], "cold_mean_ms": float(np.mean(cold)),
            "hit_mean_ms": float(np.mean(hit))}


def policy_engine(dev, dtype, on, build=None, n_layers=None):
    """Phase 3b's engine geometry, with the three policies on (prefix cache,
    swap to a 1 GiB host pool; the scheduler adds adaptive K) or off;
    ``build`` shares its weights; ``n_layers`` cuts the depth."""
    import dataclasses
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.engine import Engine
    kw = dict(prefix_cache=on, swap="host" if on else "none",
              host_pool_bytes=HOST_POOL_BYTES if on else 0)
    if build is None:
        return build_engine(mode="parallel", dtype=dtype, K=5, max_new=192,
                            max_len=1024, batch=8, seed=0, device=dev,
                            kv_layout="paged", page_size=16,
                            pool_pages=POLICY_POOL, n_layers=n_layers, **kw)
    return Engine(build.tcfg, build.dcfg, build.tparams, build.dparams,
                  dataclasses.replace(build.ecfg, **kw), build.batch,
                  device=dev)


def policy_path(ops, dev, sched3b):
    """Phase 3d: the prefix cache, swap-to-host and adaptive K at full
    width, bfloat16, on shared-prefix traffic."""
    from repro_torch.serving.scheduler import Request, Scheduler
    log(f"phase 3d: Scheduler.serve, full-width qwen2-1.5b bfloat16 on "
        f"{POLICY_LAYERS} of 28 layers (cut for time), "
        f"parallel K 5, batch 8, max_len 1024, paged: page 16, pool "
        f"{POLICY_POOL} pages; prefix cache, swap to a {HOST_POOL_BYTES} B "
        f"host pool, adaptive K (default SpeculationConfig); traffic "
        f"{POLICY_TRAFFIC}")
    eng = policy_engine(dev, "bfloat16", True, n_layers=POLICY_LAYERS)
    cfg, V, n_d = eng.tcfg, eng.tcfg.vocab_size, eng.dcfg.n_layers
    # cold run: 8 requests of other prompts, 8-token budgets, all at once;
    # then the cache is flushed so that the measured serve starts cold
    warm = policy_requests(V)[:8]
    rng = np.random.default_rng(1)
    Scheduler(eng, adaptive_k=True).serve([
        Request(rng.integers(0, V - 1, r.prompt.size).astype(np.int32),
                max_new_tokens=8) for r in warm])
    eng.prefix_cache.flush(eng.allocator)
    torch.cuda.synchronize()
    eng.reset_stats()
    sched = Scheduler(eng, adaptive_k=True, sync_every=1)
    reqs = policy_requests(V)
    budgets = [r.max_new_tokens for r in reqs]
    ops.reset_launches()
    with PolicyProbe(eng, sched) as probe:
        rep = sched.serve(reqs)
    counts = dict(ops.launches)
    it = rep["iterations"]
    ms_it = rep["wall_s"] / it * 1e3
    kinds = [e[1] for e in rep["events"]]
    log(f"  warm run: otps {rep['otps']:.1f} tok/s, {ms_it:.2f} ms/iteration "
        f"over {it}, otps_vt {rep['otps_vt']:.4f}, makespan_vt "
        f"{rep['makespan_vt']:.2f}, p50/p99 latency_vt "
        f"{rep['p50_latency_vt']:.2f}/{rep['p99_latency_vt']:.2f}, AL "
        f"{rep['weighted_acceptance_length']:.4f}, new tokens "
        f"{rep['total_new_tokens']} (phase 3b: otps {sched3b['otps']:.1f}, "
        f"{sched3b['ms_per_iteration']:.2f} ms/iteration over "
        f"{sched3b['iterations']}, otps_vt {sched3b['otps_vt']:.4f})")
    log(f"  cache: {rep['cache_hit_requests']} of {len(reqs)} requests hit, "
        f"{rep['cache_hit_tokens']} positions served from cached pages; "
        f"cached_tokens per request "
        f"{[r['cached_tokens'] for r in rep['results']]}; index "
        f"{eng.prefix_cache.stats}")
    log(f"  preemptions {rep['preemptions']} (swap {rep['preempt_swap']}, "
        f"recompute {rep['preempt_recompute']}, swap drops "
        f"{rep['swap_drops']}), host pool {rep['host_pool']}, peak pages "
        f"{rep['peak_pages']}/{POLICY_POOL}")
    summary = probe.summary()
    log(f"  admissions: {summary['hit_admissions']} hits, mean "
        f"{summary['hit_admission_ms']} ms; {summary['cold_admissions']} "
        f"cold, mean {summary['cold_admission_ms']} ms; "
        f"{summary['hit_chunks']} hit chunks")
    for way in ("out", "in"):
        sw = summary[f"swap_{way}"]
        log(f"  swap-{way}: {sw['n']} calls, {sw['ms']:.3f} ms, "
            f"{sw['bytes']} bytes, {sw['gb_per_s']} GB/s")
    log(f"  k_row histogram over live rows of each iteration: "
        f"{summary['k_row_histogram']}; speculation {rep['speculation']}; "
        f"k_final per request {[r['k_final'] for r in rep['results']]} "
        f"(the drafter is untrained, AL ~ 1: the controller drives rows to "
        f"k_row 1)")
    log(f"  launches: {counts}")
    want = probe.launches_want(cfg, n_d, it)
    if counts != want:
        fail(f"phase 3d launch counts {counts} != expected {want} ({it} "
             f"iterations, {probe.cold_prefills} cold admissions, "
             f"{len(probe.chunks)} hit chunks)")
    if not (rep["cache_hit_requests"] >= POLICY_MIN_HITS
            and rep["cache_hit_tokens"] > 0):
        fail(f"{rep['cache_hit_requests']} requests hit the cache, "
             f"{rep['cache_hit_tokens']} positions: expected >= "
             f"{POLICY_MIN_HITS} and > 0")
    for r in rep["results"][POLICY_TRAFFIC["n"]:]:
        if r["cached_tokens"] <= POLICY_TRAFFIC["prefix_len"]:
            fail(f"repeated request {r['rid']} served {r['cached_tokens']} "
                 f"positions from the cache: no more than its system prompt")
    if not rep["preempt_swap"] >= 1:
        fail(f"no preemption went to the host ({rep['preemptions']} "
             f"preemptions)")
    if not (kinds.count("swap_out") == rep["preempt_swap"]
            == kinds.count("swap_in") + kinds.count("swap_drop")):
        fail(f"swap events out {kinds.count('swap_out')}, in "
             f"{kinds.count('swap_in')}, drops {kinds.count('swap_drop')} "
             f"for {rep['preempt_swap']} swap preemptions")
    for r, b in zip(rep["results"], budgets):
        toks = r["tokens"]
        if r["n_new"] != b or toks.min() < 0 or toks.max() >= V:
            fail(f"request {r['rid']} emitted {r['n_new']} tokens (budget "
                 f"{b}) or tokens out of range")
        if not (np.isfinite(r["logprobs"]).all() and r["logprobs"].max() <= 0):
            fail(f"request {r['rid']} logprobs are not log-probabilities")
    if len(eng.host_pool) or eng.host_pool.used_bytes:
        fail("the host pool holds a snapshot after serve")
    held = eng.prefix_cache.pages()
    if eng.allocator.n_used != len(held):
        fail(f"{eng.allocator.n_used} pages allocated, {len(held)} cached")
    same = hit_against_cold(eng, reqs[0].prompt)
    log(f"  the same {same['prompt_len']}-token prompt admitted cold "
        f"{same['cold_mean_ms']:.3f} ms, then from the cache "
        f"({same['hit_tokens']} positions) {same['hit_mean_ms']:.3f} ms "
        f"(means of 3; cold {same['cold_ms']}, hit {same['hit_ms']})")
    eng.reset_stats()
    if (eng.allocator.n_used or eng.allocator.peak_used
            or eng.host_pool.peak_used):
        fail("the allocator or the host pool is not empty after flush and "
             "reset_stats")
    result = {k: rep[k] for k in (
        "otps", "otps_vt", "wall_s", "iterations", "total_new_tokens",
        "weighted_acceptance_length", "makespan_vt", "p50_latency_vt",
        "p99_latency_vt", "preemptions", "preempt_swap", "preempt_recompute",
        "swap_drops", "recomputed_prefill_tokens", "host_pool", "peak_pages",
        "cache_hit_tokens", "cache_hit_requests", "speculation")}
    result.update(ms_per_iteration=ms_it, launches=counts,
                  same_prompt=same, **summary)
    del eng, sched, rep, probe
    torch.cuda.empty_cache()
    return result


def policy_losslessness(dev):
    """Phase 4c: phase 3d's traffic twice in float32 at full width (depth
    cut to POLICY_F32_LAYERS), the three policies on and off; one request
    sampled and swapped."""
    from repro_torch.serving.margins import MarginLog
    from repro_torch.serving.scheduler import Scheduler
    log(f"phase 4c: phase 3d's traffic in float32 at full width, "
        f"{POLICY_F32_LAYERS} of 28 layers (cut for time), prefix cache + "
        f"swap + adaptive K against cold prefill + recompute + fixed K; "
        f"request {POLICY_SAMPLED} sampled ({SAMPLED}, seed 5)")
    off = policy_engine(dev, "float32", False, n_layers=POLICY_F32_LAYERS)
    on = policy_engine(dev, "float32", True, build=off)
    V = off.tcfg.vocab_size
    runs = {}
    with MarginLog() as margins:
        for name, eng, adaptive in (("on", on, True), ("off", off, False)):
            t0 = time.perf_counter()
            runs[name] = Scheduler(eng, adaptive_k=adaptive).serve(
                policy_requests(V, sampled=POLICY_SAMPLED))
            rep = runs[name]
            log(f"  {name:3s}: {rep['iterations']} iterations, "
                f"{time.perf_counter() - t0:.1f} s, preemptions "
                f"{rep['preemptions']} (swap {rep['preempt_swap']}), cache "
                f"hits {rep['cache_hit_requests']}")
        req = policy_requests(V, sampled=POLICY_SAMPLED)[POLICY_SAMPLED]
        alone = Scheduler(off).serve([req])["results"][0]
    swapped = runs["on"]["results"][POLICY_SAMPLED]["n_swap"]
    if not swapped:
        fail(f"the sampled request {POLICY_SAMPLED} was not swapped out "
             f"(n_preempt {runs['on']['results'][POLICY_SAMPLED]['n_preempt']})")
    if not (runs["on"]["preempt_swap"] >= 1
            and runs["on"]["cache_hit_requests"] >= POLICY_MIN_HITS):
        fail("the policies' run did not swap or hit the cache")
    parted = 0
    reqs = policy_requests(V, sampled=POLICY_SAMPLED)
    for i, req in enumerate(reqs):
        got = runs["on"]["results"][i]["tokens"]
        want = runs["off"]["results"][i]["tokens"]
        parted += streams_agree("policies on vs off", off, margins, req, got,
                                want) is not None
    parted += streams_agree("sampled swapped vs alone", off, margins,
                            reqs[POLICY_SAMPLED],
                            runs["on"]["results"][POLICY_SAMPLED]["tokens"],
                            alone["tokens"]) is not None
    log(f"  every stream equal with the policies on and off, the sampled "
        f"request (swapped {swapped} time(s)) equal to itself served alone; "
        f"{parted} streams parted at a near-tie")
    out = {"parted_at_near_tie": parted, "sampled_swaps": swapped,
           **{f"{name}_{k}": runs[name][k] for name in runs
              for k in ("iterations", "preemptions", "preempt_swap",
                        "cache_hit_requests", "cache_hit_tokens")}}
    del on, off, runs
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3e / 4d: the serving front end (AsyncEngine, LLMEngine, the
# round-based baseline, the NDJSON server)
# ---------------------------------------------------------------------------

# phase 3e's wall-clock arrivals: Exp gaps of this mean in seconds, seed 0
# (about one phase-3b iteration on the card)
STREAM_MEAN_GAP_S = 0.075
# the second streamed pass aborts every fourth request after its first chunk
ABORT_EVERY = 4
# the streamed passes serve the first 16 of phase 3b's 24 requests, so the
# phase adds ~110 s, not ~135 s, to the run
STREAM_REQUESTS = 16
# a round stacks equal-length prompts: phase 3b's prompts, cut to the
# shortest of their lengths, for the round-based baseline
ROUND_PROMPT_LEN = 256
# phase 4d's one mid-stream abort
STREAM_ABORTED = 5


def sched3b_traffic(vocab, n=24):
    """Phase 3b's first ``n`` requests, drawn as phase 3b draws them
    (prompts of 256-640 tokens, budgets 64-192, Exp(1) virtual arrivals,
    seed 0): (prompts, budgets, arrivals)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 641, 24)
    budgets = rng.integers(64, 193, 24)
    arrivals = np.cumsum(rng.exponential(1.0, 24))
    prompts = [rng.integers(0, vocab - 1, m).astype(np.int32) for m in lens]
    return (prompts[:n], [int(b) for b in budgets[:n]],
            [float(a) for a in arrivals[:n]])


def pct(xs, p):
    return float(np.percentile(xs, p)) if len(xs) else None


async def stream_pass(eng, prompts, budgets, policies, arrive, abort_every=0):
    """One AsyncEngine session: request i submitted ``arrive[i]`` seconds
    after the session opens; with ``abort_every``, request i with i %
    abort_every == abort_every - 1 aborted after its first chunk. Returns
    the per-request records, the last health() before close, the peak
    queue depth a monitor saw, and the report."""
    from repro_torch.serving.streaming import AsyncEngine
    aeng = AsyncEngine(eng)
    await aeng.start()
    t0 = time.perf_counter()
    peak_queue, stop = [0], asyncio.Event()

    async def monitor():
        while not stop.is_set():
            peak_queue[0] = max(peak_queue[0], aeng.health()["queue_depth"])
            await asyncio.sleep(0.002)

    async def one(i):
        await asyncio.sleep(max(0.0, arrive[i] - (time.perf_counter() - t0)))
        t_sub = time.perf_counter()
        h = await aeng.submit(prompts[i], policies[i],
                              max_new_tokens=budgets[i])
        rec = {"i": i, "rid": h.rid, "t_submit": t_sub, "times": [],
               "tokens": [], "t_abort": None, "queue_at_abort": None}
        async for tok, _ in h:
            rec["times"].append(time.perf_counter())
            rec["tokens"].append(tok)
            if (abort_every and i % abort_every == abort_every - 1
                    and rec["t_abort"] is None):
                rec["queue_at_abort"] = aeng.health()["queue_depth"]
                rec["t_abort"] = time.perf_counter()
                if not h.abort():
                    fail(f"request {i}: abort() after its first chunk "
                         f"returned False")
        rec["aborted"] = h.aborted
        return rec

    mon = asyncio.get_running_loop().create_task(monitor())
    recs = await asyncio.gather(*(one(i) for i in range(len(prompts))))
    health = aeng.health()
    stop.set()
    await mon
    rep = await aeng.close()
    rep["_t_start"] = aeng.scheduler._t_start
    return recs, health, peak_queue[0], rep


def stream_metrics(recs, rep):
    """TTFT (submit() to the first streamed token), each request's mean
    inter-token gap ((last - first) / (n - 1)), and each abort's
    turnaround (abort() to the next admission event, when a request was
    waiting), in ms."""
    ttft = [(r["times"][0] - r["t_submit"]) * 1e3 for r in recs if r["times"]]
    gaps = [(r["times"][-1] - r["times"][0]) / (len(r["times"]) - 1) * 1e3
            for r in recs if len(r["times"]) > 1 and not r["aborted"]]
    admits = sorted(t + rep["_t_start"] for t, kind, _ in rep["events"]
                    if kind in ("admit", "swap_in"))
    turn = []
    for r in recs:
        if r["t_abort"] is not None and r["queue_at_abort"]:
            later = [t for t in admits if t >= r["t_abort"]]
            if later:
                turn.append((later[0] - r["t_abort"]) * 1e3)
    return {"ttft_ms_p50": pct(ttft, 50), "ttft_ms_p99": pct(ttft, 99),
            "inter_token_ms_p50": pct(gaps, 50),
            "inter_token_ms_p99": pct(gaps, 99),
            "abort_turnaround_ms_p50": pct(turn, 50),
            "abort_turnaround_ms_max": max(turn) if turn else None,
            "aborts_with_a_waiter": len(turn)}


def streaming_path(ops, dev, sched3b):
    """Phase 3e: the front end at full width, bfloat16, under wall-clock
    arrivals: two AsyncEngine passes (the second with aborts),
    LLMEngine.generate and the round-based baseline."""
    import dataclasses
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.scheduler import (LLMEngine, Request, Scheduler,
                                               serve_round_based)
    B, K, POOL = 8, 5, 256
    log(f"phase 3e: AsyncEngine, full-width qwen2-1.5b bfloat16 "
        f"({STREAM_LAYERS} of 28 layers, cut for time), parallel K "
        f"{K}, batch {B}, paged: page 16, pool {POOL} pages, swap to a "
        f"{HOST_POOL_BYTES} B host pool; the first {STREAM_REQUESTS} of phase "
        f"3b's requests, odd ones sampled ({SAMPLED}, seed = index), "
        f"submitted at wall-clock Exp gaps of mean {STREAM_MEAN_GAP_S} s, "
        f"seed 0")
    eng = build_engine(mode="parallel", n_layers=STREAM_LAYERS, K=K,
                       max_new=192, max_len=1024, batch=B, seed=0, device=dev,
                       kv_layout="paged", page_size=16, pool_pages=POOL,
                       swap="host", host_pool_bytes=HOST_POOL_BYTES)
    cfg, V, n_d = eng.tcfg, eng.tcfg.vocab_size, eng.dcfg.n_layers
    prompts, budgets, _ = sched3b_traffic(V)
    N = STREAM_REQUESTS
    policies = [None if i % 2 == 0 else SamplingParams(seed=i, **SAMPLED)
                for i in range(N)]
    arrive = np.cumsum(np.random.default_rng(0).exponential(
        STREAM_MEAN_GAP_S, N))
    # cold run: 8 requests, 8-token budgets, one sampled
    Scheduler(eng).serve([Request(p, max_new_tokens=8, sampling=sp)
                          for p, sp in zip(prompts[:8], policies[:8])])
    torch.cuda.synchronize()
    out = {}
    for name, every in (("stream", 0), ("stream_aborts", ABORT_EVERY)):
        eng.reset_stats()
        ops.reset_launches()
        recs, health, peak_q, rep = asyncio.run(asyncio.wait_for(
            stream_pass(eng, prompts[:N], budgets[:N], policies, arrive,
                        every), 300))
        counts = dict(ops.launches)
        it = rep["iterations"]
        kinds = [e[1] for e in rep["events"]]
        admissions = kinds.count("admit")
        m = stream_metrics(recs, rep)
        row = {"otps": rep["otps"], "wall_s": rep["wall_s"],
               "iterations": it, "ms_per_iteration": rep["wall_s"] / it * 1e3,
               "total_new_tokens": rep["total_new_tokens"],
               "preemptions": rep["preemptions"],
               "preempt_swap": rep["preempt_swap"],
               "aborted": rep["aborted"], "admissions": admissions,
               "health_p50_wait_s": health["p50_wait_s"],
               "health_p99_wait_s": health["p99_wait_s"],
               "peak_queue_depth": peak_q, "peak_pages": rep["peak_pages"],
               "launches": counts, **m}
        out[name] = row
        log(f"  {name}: wall otps {row['otps']:.1f} tok/s over "
            f"{row['wall_s']:.3f} s ({row['ms_per_iteration']:.2f} "
            f"ms/iteration over {it}; phase 3b, 28 layers, virtual arrivals: "
            f"{sched3b['otps']:.1f} tok/s, {sched3b['ms_per_iteration']:.2f} "
            f"ms/iteration), TTFT p50/p99 {m['ttft_ms_p50']:.1f}/"
            f"{m['ttft_ms_p99']:.1f} ms, inter-token gap p50/p99 "
            f"{m['inter_token_ms_p50']:.2f}/{m['inter_token_ms_p99']:.2f} ms, "
            f"health wait p50/p99 {health['p50_wait_s'] * 1e3:.1f}/"
            f"{health['p99_wait_s'] * 1e3:.1f} ms, peak queue depth "
            f"{peak_q}, preemptions {rep['preemptions']} (swap "
            f"{rep['preempt_swap']}), aborted {rep['aborted']}, abort "
            f"turnaround p50/max {m['abort_turnaround_ms_p50']}/"
            f"{m['abort_turnaround_ms_max']} ms over "
            f"{m['aborts_with_a_waiter']} aborts with a waiter")
        log(f"  launches: {counts}")
        want = sched_launches_want(cfg, n_d, it, admissions)
        if counts != want:
            fail(f"phase 3e {name}: launch counts {counts} != expected {want}"
                 f" ({it} iterations, {admissions} admissions)")
        times = [t for t, _, _ in rep["events"]]
        if times != sorted(times):
            fail(f"phase 3e {name}: the event trace is not monotone")
        for r, res in zip(recs, sorted(rep["results"],
                                       key=lambda x: x["rid"])):
            b = budgets[r["i"]]
            if res["rid"] != r["rid"] or res["tokens"].tolist() != r["tokens"]:
                fail(f"phase 3e {name}: request {r['i']} streamed tokens "
                     f"other than its report's")
            if r["aborted"]:
                # stopped at once: nothing after the chunk that carried
                # the first token
                if not 0 < len(r["tokens"]) < b or res["n_new"] != len(
                        r["tokens"]):
                    fail(f"phase 3e {name}: aborted request {r['i']} has "
                         f"{len(r['tokens'])} tokens (budget {b})")
            elif len(r["tokens"]) != b or min(r["tokens"]) < 0 \
                    or max(r["tokens"]) >= V:
                fail(f"phase 3e {name}: request {r['i']} streamed "
                     f"{len(r['tokens'])} tokens, budget {b}")
        want_aborts = N // ABORT_EVERY if every else 0
        if rep["aborted"] != want_aborts:
            fail(f"phase 3e {name}: {rep['aborted']} aborted, want "
                 f"{want_aborts}")
        if (eng.allocator.n_used or any(eng._slot_pages)
                or len(eng.host_pool) or eng.host_pool.used_bytes):
            fail(f"phase 3e {name}: the allocator ({eng.allocator.n_used} "
                 f"pages) or the host pool ({eng.host_pool.used_bytes} B) is "
                 f"not empty after close")

    log(f"  LLMEngine.generate of requests 0-7, their budgets, odd ones "
        f"sampled")
    sps = [SamplingParams(seed=i, max_new_tokens=budgets[i],
                          **(SAMPLED if i % 2 else {}))
           for i in range(8)]
    llm = LLMEngine(eng)
    t0 = time.perf_counter()
    outs = llm.generate(prompts[:8], sps)
    gen_s = time.perf_counter() - t0
    rids = [o["rid"] for o in outs]
    if rids != sorted(rids) or [o["n_new"] for o in outs] != budgets[:8]:
        fail(f"LLMEngine.generate: rids {rids}, n_new "
             f"{[o['n_new'] for o in outs]} for budgets {budgets[:8]}")
    out["llm_engine"] = {"wall_s": gen_s,
                         "otps": llm.last_report["otps"],
                         "iterations": llm.last_report["iterations"]}
    log(f"    prompt order and budgets kept; {gen_s:.3f} s, otps "
        f"{llm.last_report['otps']:.1f} tok/s")

    cut = [p[:ROUND_PROMPT_LEN] for p in prompts]
    rb_eng = Engine(cfg, eng.dcfg, eng.tparams, eng.dparams,
                    dataclasses.replace(eng.ecfg, kv_layout="contiguous",
                                        swap="none", host_pool_bytes=0),
                    B, device=dev)
    del eng, llm
    torch.cuda.empty_cache()
    log(f"  serve_round_based: phase 3b's 24 prompts cut to "
        f"{ROUND_PROMPT_LEN} tokens, their budgets, contiguous, batch {B}")
    ops.reset_launches()
    rb = serve_round_based(rb_eng, cut, budgets)
    counts = dict(ops.launches)
    if (counts["flash_attention"] != rb["rounds"] * cfg.n_layers
            or counts["paged_decode_attention"]):
        fail(f"round-based launches {counts}: want {cfg.n_layers} flash a "
             f"round over {rb['rounds']} rounds, no paged")
    if rb["total_new_tokens"] != sum(budgets) or rb["rounds"] != 3:
        fail(f"round-based: {rb['total_new_tokens']} tokens in "
             f"{rb['rounds']} rounds, want {sum(budgets)} in 3")
    out["round_based"] = dict(rb, launches=counts)
    log(f"    otps {rb['otps']:.1f} tok/s, {rb['rounds']} rounds, "
        f"{rb['wall_s']:.3f} s, AL {rb['mean_acceptance_length']:.4f} "
        f"(continuous, phase 3b at 28 layers: {sched3b['otps']:.1f} tok/s; "
        f"streamed: "
        f"{out['stream']['otps']:.1f} tok/s); launches {counts}")
    del rb_eng
    torch.cuda.empty_cache()
    return out


def streaming_losslessness(dev, greedy_ref):
    """Phase 4d: float32 full width on phase 4's prompts: the streamed path
    with one mid-stream abort against the virtual twin on the same engine,
    under the near-tie rules; then the NDJSON server on 127.0.0.1."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.launch.serve_stream import (_demo_client,
                                                 start_stream_server)
    from repro_torch.serving.margins import MarginLog
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.streaming import AsyncEngine, virtual_twin_report
    B, NEW, K, MAX_LEN, POOL = 4, 32, 5, 256, 30
    prompts = greedy_ref["prompts"]
    log(f"phase 4d: AsyncEngine against virtual_twin_report, float32 full "
        f"width, paged (pool {POOL} pages of 16), batch {B}, phase 4's "
        f"{len(prompts)} prompts greedy and again sampled ({SAMPLED}, seed "
        f"20 + i), {NEW} new tokens; request {STREAM_ABORTED} aborted after "
        f"its first chunk")
    eng = build_engine(mode="parallel", dtype="float32", K=K, max_new=NEW,
                       max_len=MAX_LEN, batch=B, seed=0, device=dev,
                       kv_layout="paged", page_size=16, pool_pages=POOL)
    n = len(prompts)
    work = [(p, None, NEW) for p in prompts] + [
        (p, SamplingParams(seed=20 + i, **SAMPLED), NEW)
        for i, p in enumerate(prompts)]
    reqs = [Request(p, sampling=sp, max_new_tokens=b, rid=i)
            for i, (p, sp, b) in enumerate(work)]

    async def streamed():
        aeng = AsyncEngine(eng)
        handles = [await aeng.submit(p, sp, max_new_tokens=b)
                   for p, sp, b in work]

        async def drain(i, h):
            toks = []
            async for tok, _ in h:
                toks.append(tok)
                if i == STREAM_ABORTED and not h.done:
                    h.abort()
            return toks, h.aborted
        got = await asyncio.gather(*(drain(i, h)
                                     for i, h in enumerate(handles)))
        return got, await aeng.close()

    with MarginLog() as margins:
        twin = virtual_twin_report(eng, work)
        got, rep = asyncio.run(asyncio.wait_for(streamed(), 300))
    if eng.allocator.n_used or not rep["aborted"] == 1:
        fail(f"phase 4d: {eng.allocator.n_used} pages left, "
             f"{rep['aborted']} aborted")
    parted = 0
    for i, ((toks, aborted), want) in enumerate(zip(got, twin["results"])):
        want = want["tokens"]
        if aborted != (i == STREAM_ABORTED):
            fail(f"phase 4d: request {i} aborted {aborted}")
        if aborted:
            if not 0 < len(toks) < NEW:
                fail(f"phase 4d: the aborted stream has {len(toks)} tokens")
            want = want[:len(toks)]
        parted += streams_agree("streamed vs twin", eng, margins, reqs[i],
                                np.asarray(toks, np.int32), want) is not None
    log(f"  streams equal to the twin ({twin['iterations']} iterations, "
        f"preemptions {twin['preemptions']} twin / {rep['preemptions']} "
        f"streamed); the aborted one a prefix of its twin; {parted} parted "
        f"at a near-tie")

    async def socket_checks():
        aeng = AsyncEngine(eng)
        server = await start_stream_server(aeng, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        await _demo_client("127.0.0.1", port, 2, 8, 128, 0.8, 1)
        reader, writer = await asyncio.open_connection("127.0.0.1", port)

        def send(obj):
            writer.write((json.dumps(obj) + "\n").encode())
        g = {"op": "generate", "prompt": prompts[0].tolist(),
             "max_new_tokens": NEW}
        send(dict(g, id="g"))
        send(dict(g, id="s", prompt=prompts[1].tolist(), seed=21, **SAMPLED))
        send(dict(g, id="a", prompt=prompts[2].tolist()))
        send({"op": "abort", "id": "a"})
        send({"op": "health"})
        await writer.drain()
        toks, done, health = {}, {}, None
        while len(done) < 3 or health is None:
            msg = json.loads(await reader.readline())
            if msg.get("event") == "tokens":
                toks.setdefault(msg["id"], []).extend(msg["tokens"])
            elif msg.get("event") == "done":
                done[msg["id"]] = msg
            elif msg.get("event") == "health":
                health = msg
            elif msg.get("event") == "error":
                fail(f"NDJSON error event {msg}")
        writer.close()
        # a dropped connection: more requests than slots, closed after the
        # first tokens event, so some are still queued when it drops
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        for i in range(2 * B):
            send(dict(g, id=f"d{i}", prompt=prompts[i % n].tolist()))
        await writer.drain()
        await reader.readline()
        writer.close()
        for _ in range(3000):
            if aeng.health()["inflight"] == 0:
                break
            await asyncio.sleep(0.01)
        server.close()
        await server.wait_closed()
        return toks, done, health, await aeng.close()

    with MarginLog() as margins:
        toks, done, health, rep = asyncio.run(asyncio.wait_for(
            socket_checks(), 300))
    if not (done["a"]["aborted"] and not done["g"]["aborted"]
            and done["g"]["n_new"] == NEW and done["s"]["n_new"] == NEW):
        fail(f"NDJSON done events {done}")
    for cid, i in (("g", 0), ("s", n + 1)):
        parted += streams_agree(f"NDJSON {cid} vs twin", eng, margins,
                                reqs[i], np.asarray(toks[cid], np.int32),
                                twin["results"][i]["tokens"]) is not None
    if not rep["aborted"] >= 2 or eng.allocator.n_used:
        fail(f"NDJSON: {rep['aborted']} aborted (the abort op and the "
             f"dropped connection), {eng.allocator.n_used} pages left")
    log(f"  NDJSON on 127.0.0.1: the demo client, generate / abort / health "
        f"round trip (streams equal to the twin, health "
        f"{ {k: health[k] for k in ('slots', 'pool_pages', 'inflight')} }), "
        f"a dropped connection aborted its requests ({rep['aborted']} "
        f"aborted in the session), the pool empty")
    out = {"iterations": twin["iterations"], "parted_at_near_tie": parted,
           "twin_preemptions": twin["preemptions"],
           "streamed_preemptions": rep["preemptions"],
           "socket_aborted": rep["aborted"]}
    del eng
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 5: training at full width
# ---------------------------------------------------------------------------

class StageTimer:
    """CUDA events around a Trainer's four stage methods (taps, loss, grads,
    apply), set on the instance so train_batch runs through them; removed
    on exit, so the trainer holds no reference to itself afterwards."""
    STAGES = ("taps", "loss", "grads", "apply")

    def __init__(self, tr):
        self.tr = tr
        self.events = []

    def __enter__(self):
        for name in self.STAGES:
            setattr(self.tr, name, self._wrap(name, getattr(self.tr, name)))
        return self

    def __exit__(self, *exc):
        for name in self.STAGES:
            delattr(self.tr, name)

    def _wrap(self, name, fn):
        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            self.events.append((name, start, end))
            return out
        return timed

    def split_ms(self):
        """Device-clock ms per stage, summed over the recorded calls."""
        torch.cuda.synchronize()
        out = dict.fromkeys(self.STAGES, 0.0)
        for name, a, b in self.events:
            out[name] += a.elapsed_time(b)
        self.events.clear()
        return out


def train_steps(ops, dev, tr, batches, label):
    """Run train_batch over ``batches`` with launch counts from 0 and a
    stage split per step; returns the path's numbers."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    steps = []
    with StageTimer(tr) as timer:
        for batch in batches:
            segs = batch if isinstance(batch, list) else [batch]
            t0 = time.perf_counter()
            m = tr.train_batch(batch)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            split = timer.split_ms()
            steps.append(dict(s=sec, loss=m["loss"], grad_norm=m["grad_norm"],
                              labels=sum(int((sg.labels >= 0).sum())
                                         for sg in segs),
                              segments=len(segs), split_ms=split))
            log(f"  {label} step {len(steps)}: {sec:.3f} s, loss "
                f"{m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, stages "
                "(ms) " + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))
    counts = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    n_forward = sum(st["segments"] for st in steps)
    want = {"mtp_attention": tr.dcfg.n_layers * n_forward
            * (2 if tr.dcfg.remat else 1),
            "flash_attention": tr.tcfg.n_layers * len(steps),
            "decode_attention": 0, "paged_decode_attention": 0}
    log(f"  {label} launches: {counts}")
    if counts != want:
        fail(f"{label}: launch counts {counts} != expected {want}")
    for st in steps:
        if not (math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"])):
            fail(f"{label}: loss {st['loss']} / grad_norm {st['grad_norm']}")
    warm = steps[1:]                     # step 1 warms up cuBLAS and caches
    sec = sum(st["s"] for st in warm) / len(warm)
    result = dict(
        s_per_step=sec, s_first_step=steps[0]["s"],
        label_tokens_per_s=sum(st["labels"] for st in warm)
        / sum(st["s"] for st in warm),
        labels_per_step=warm[-1]["labels"], peak_memory_gb=peak_gb,
        stage_ms={k: sum(st["split_ms"][k] for st in warm) / len(warm)
                  for k in StageTimer.STAGES},
        losses=[st["loss"] for st in steps], launches=counts)
    log(f"  {label}: {sec:.3f} s/step, {result['label_tokens_per_s']:.1f} "
        f"label tokens/s, peak memory {peak_gb:.2f} GB")
    return result


def training_path(ops, dev):
    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.configs import DrafterConfig, get_config
    from repro_torch.data import MTPPipeline, markov_corpus
    from repro_torch.launch import train as train_launch
    from repro_torch.models.registry import get_model
    from repro_torch.training import TrainConfig, Trainer
    from repro_torch.tree import leaves_with_paths

    tcfg = get_config("qwen2-1.5b")
    dcfg = DrafterConfig().resolve(tcfg)
    log(f"phase 5: training, full-width qwen2-1.5b {tcfg.dtype} target, "
        f"{dcfg.n_layers}-layer drafter float32 (d {dcfg.d_model}, heads "
        f"{dcfg.n_heads}/{dcfg.n_kv_heads}, K {dcfg.k_train}, r "
        f"{dcfg.cod_rate}), markov_corpus, batch 1")
    gen = torch.Generator(device=dev).manual_seed(0)
    tparams = get_model(tcfg).init(gen, device=dev)
    V = tcfg.vocab_size

    def pipe(n, segments=1, seed=0, n_seqs=3):
        return MTPPipeline(markov_corpus(seed, n_seqs, n, V), k_train=8,
                           cod_rate=0.8, batch=1, seed=seed,
                           segments=segments)

    def trainer(**kw):
        return Trainer(tcfg, dcfg, tparams, TrainConfig(**kw), seed=0,
                       device=dev)

    paths = {}
    for label, n, S in (("(a) whole n 2048", 2048, 1),
                        ("(b) segmented n 4096 S 4", 4096, 4)):
        tr = trainer()
        paths[label] = train_steps(ops, dev, tr, list(pipe(n, S)), label)
        paths[label].update(n=n, segments=S)
        del tr
        torch.cuda.empty_cache()

    log("  segmented vs whole-sequence grads at n 1024, float32")
    tr = trainer()
    whole = next(iter(pipe(1024, 1, seed=1, n_seqs=1)))
    segs = next(iter(pipe(1024, 4, seed=1, n_seqs=1)))
    gw, _ = tr.batch_grads(whole)
    gs, _ = tr.batch_grads(segs)
    worst = 0.0
    for (path, a), (_, b) in zip(leaves_with_paths(gs),
                                 leaves_with_paths(gw)):
        scale = b.abs().max().item()
        share = (a - b).abs().max().item() / max(scale, 1e-30)
        worst = max(worst, share)
        if not share <= SEG_GRAD_TOL:
            fail(f"segmented grads differ from whole at {path}: "
                 f"{share:.3e} of max |grad| {scale:.3e}")
    log(f"  worst leaf: {worst:.3e} of its max |grad| (limit {SEG_GRAD_TOL})")
    del gw, gs

    batch = next(iter(pipe(1024, 1, seed=2, n_seqs=1)))
    losses = [tr.train_batch(batch)["loss"] for _ in range(4)]
    log(f"  loss on one repeated batch, 4 steps: "
        + ", ".join(f"{x:.4f}" for x in losses))
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall on a repeated batch: {losses}")

    with tempfile.TemporaryDirectory() as tmp:
        save_pytree(tr.dparams, tmp, "drafter", step=4)
        back = load_pytree(tr.dparams, tmp, "drafter")
        for (path, a), (_, b) in zip(leaves_with_paths(tr.dparams),
                                     leaves_with_paths(back)):
            if not torch.equal(a, b):
                fail(f"checkpoint round trip changed {path}")
    log("  checkpoint round trip: every leaf equal")
    # the launcher builds its own target: free this one first, so its peak
    # memory is its own
    del tr, back, tparams
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        rep = train_launch.main(["--data", "markov", "--seq-len", "512",
                                 "--batch", "1", "--n-seqs", "2",
                                 "--epochs", "1", "--ckpt", tmp])
    if not (rep["steps"] == 2 and math.isfinite(rep["loss"])):
        fail(f"the training launcher reported {rep}")
    return dict(paths=paths, seg_grad_worst=worst, repeated_losses=losses,
                launcher=rep)


# ---------------------------------------------------------------------------
# phases 6, 6b, 6c: the rest of the dense family (gemma2-27b, minitron-4b)
# ---------------------------------------------------------------------------

def free_card(dev, what):
    """Drop what earlier phases left (their models are out of scope), and
    log what is still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  {what}: {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
        f"allocated before loading")


def drafter_bytes(tcfg, dcfg, dtype_bytes):
    """The drafter's weights: its embedding and head over the target's
    vocabulary, the tap projection, and its layers."""
    d, V = tcfg.d_model, tcfg.vocab_size
    dd, Hd, hdd = dcfg.d_model, dcfg.n_heads, dcfg.head_dim
    return (2 * V * dd + 3 * d * dd + 2 * dd * dd + dcfg.n_layers * (
        4 * dd * Hd * hdd + 3 * dd * dcfg.d_ff)) * dtype_bytes


def verify_graph_bytes(tcfg, dcfg, B, K, dtype_bytes, snaps=0):
    """What a served verify's CUDA graphs keep in their pool for a session
    (``serving/verify_graph.py``): their outputs, the float32 logits and
    the drafter's taps of B x (K + 1) tokens and a recurrent target's
    per-token snapshots (``snaps`` bytes). The forward's temporaries come
    on top, reused inside the pool (an MoE layer's dispatch among them);
    an eager step's peak beyond its state bounds them."""
    T = B * (K + 1)
    return T * (tcfg.vocab_size * 4
                + dcfg.num_taps * tcfg.d_model * dtype_bytes) + snaps


def memory_plan(tcfg, dcfg, B, max_len, dtype_bytes, K=None):
    """The bytes a run will hold, reckoned from the configs: target and
    drafter weights (an MoE layer's experts: w_gate, w_up and w_down each),
    their contiguous KV caches at (B, max_len), and dense_init's
    temporaries of the largest matrix (the vocab x d embedding, or an MoE
    layer's stacked expert weight: its float32 draw, scaled in place, while
    its cast is made); with ``K``, the served verify's graph pool
    (``verify_graph_bytes``)."""
    d, V, L, hd = tcfg.d_model, tcfg.vocab_size, tcfg.n_layers, tcfg.head_dim
    H, KV, E = tcfg.n_heads, tcfg.n_kv_heads, tcfg.moe.n_experts
    gated = tcfg.mlp_variant in ("swiglu", "geglu")
    mlp = (3 if gated else 2) * d * tcfg.d_ff
    moe = E * (d + 3 * d * tcfg.d_ff) + tcfg.moe.n_shared_experts * mlp
    ffn = sum(moe if tcfg.is_moe_layer(li) else mlp for li in range(L))
    layers = L * (2 * d * H * hd + 2 * d * KV * hd) + ffn
    target = (V * d * (1 if tcfg.tie_embeddings else 2) + layers) * dtype_bytes
    drafter = drafter_bytes(tcfg, dcfg, dtype_bytes)
    kv = (L * KV * hd + dcfg.n_layers * dcfg.n_kv_heads * dcfg.head_dim) \
        * 2 * B * max_len * dtype_bytes
    tmp = max(V * d, E * d * tcfg.d_ff) * 4
    graph = 0 if K is None else verify_graph_bytes(tcfg, dcfg, B, K,
                                                   dtype_bytes)
    plan = dict(target_gb=target / 1e9, drafter_gb=drafter / 1e9,
                kv_gb=kv / 1e9, init_temporaries_gb=tmp / 1e9)
    if K is not None:
        plan["verify_graph_gb"] = graph / 1e9
    return dict(plan, total_gb=(target + drafter + kv + tmp + graph) / 1e9)


def near_ties(ref_eng, toks, ref, start, what, dev, tie=NEAR_TIE,
              extras=None):
    """Each row of ``toks`` equals ``ref`` (B, W) from ``start`` on, or
    first parts where ``ref_eng``'s top-2 logit gap over the reference
    context is below ``tie`` (phase 4's rule). Returns the rows that part.
    ``extras`` (leading axis B): the target's modality inputs, row b's with
    row b's context (a VLM target's context is its text after the vision
    positions)."""
    parted = []
    off = ref_eng.pos_offset
    for b in range(ref.shape[0]):
        where = np.flatnonzero(toks[b, start:] != ref[b, start:])
        if not len(where):
            continue
        pos = start + int(where[0])
        ctx = torch.as_tensor(ref[b:b + 1, off:pos], device=dev)
        row = {k: v[b:b + 1] for k, v in (extras or {}).items()}
        with torch.no_grad():
            logits = ref_eng.model.forward(ref_eng.tparams, ctx,
                                           collect_taps=False,
                                           head_last_only=True,
                                           **row).logits[0, -1]
        top2 = logits.topk(2).values
        gap = float(top2[0] - top2[1])
        log(f"  {what}: row {b} first differs at position {pos}; the "
            f"reference's top-2 logit gap there {gap:.3e}")
        if gap >= tie:
            fail(f"{what} row {b} differs at {pos} with top-2 gap {gap} >= "
                 f"{tie}")
        parted.append(b)
    if not parted:
        log(f"  {what}: every token equal")
    return parted


def dense_family_launches(cfg, n_d, iterations, chunk_lists, paged, n_ring):
    """Attention launches of a Scheduler.serve: each iteration runs phase 1
    of every target attention layer (the paged kernel for a pool, the decode kernel
    for one of the ``n_ring`` rings) and phase 2 (decode), the drafter's
    draft and extend (phase 1 paged or not, phase 2 decode); each admission
    prefills its first chunk (flash per target layer, the drafter's extend:
    2 decode per drafter layer) and runs each further chunk in decode mode
    (2 per target and 2 per drafter layer). ``chunk_lists``: each
    admission's chunk sizes."""
    L = attention_layers(cfg)
    per_it_paged = (L - n_ring + 2 * n_d) if paged else 0
    per_it_decode = (L + 2 * n_d) + (n_ring if paged else L + 2 * n_d)
    extra = sum(len(c) - 1 for c in chunk_lists)
    return {"paged_decode_attention": iterations * per_it_paged,
            "decode_attention": iterations * per_it_decode
            + len(chunk_lists) * 2 * n_d + extra * 2 * (L + n_d),
            "flash_attention": len(chunk_lists) * L, "mtp_attention": 0}


def gemma2_path(ops, dev):
    """Phase 6: full-width gemma2-27b in bfloat16, its depth cut to
    GEMMA2_LAYERS for time, through Engine.run and a paged Scheduler.serve
    under pool pressure (weights shared)."""
    from repro_torch.configs import DrafterConfig, get_config
    from repro_torch.launch.serve import build_engine, random_prompts
    B, P, NEW, K, MAX_LEN, PAGE, POOL, N = 8, 512, 128, 5, 1024, 16, 192, 8
    tcfg = get_config("gemma2-27b").replace(n_layers=GEMMA2_LAYERS)
    dcfg = DrafterConfig().resolve(tcfg)
    log(f"phase 6: full-width gemma2-27b bfloat16 ({GEMMA2_LAYERS} of 46 "
        f"layers, d 4608, 32/16 "
        f"heads, d_ff 36864 GeGLU, vocab 256000, local 4096 / global, "
        f"softcaps 50 / 30), 4-layer parallel drafter, batch {B}, prompt {P},"
        f" max_new {NEW}, K {K}, max_len {MAX_LEN} (the window exceeds it: "
        f"no layer is a ring)")
    free_card(dev, "phase 6")
    plan = memory_plan(tcfg, dcfg, B, MAX_LEN, 2)
    log("  memory plan: " + ", ".join(f"{k} {v:.2f}" for k, v in plan.items()))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = build_engine(arch="gemma2-27b", n_layers=GEMMA2_LAYERS,
                       mode="parallel", K=K, max_new=NEW, max_len=MAX_LEN,
                       batch=B, seed=0, device=dev)
    torch.cuda.synchronize()
    built_gb = torch.cuda.memory_allocated(dev) / 1e9
    log(f"  weights built in {time.perf_counter() - t0:.1f} s: "
        f"{built_gb:.2f} GB allocated, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; drafter d "
        f"{eng.dcfg.d_model} heads {eng.dcfg.n_heads}/{eng.dcfg.n_kv_heads} "
        f"d_ff {eng.dcfg.d_ff}")
    if eng.ring:
        fail("gemma2 at max_len 1024 built a ring (its window is 4096)")
    prompts = random_prompts(eng.tcfg.vocab_size, B, P, seed=0)
    run = family_run(ops, dev, eng, prompts, NEW, K, "6")
    run.update(weights_gb=built_gb, memory_plan=plan)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  Scheduler.serve: paged, page {PAGE}, pool {POOL} pages, "
        f"incremental growth; phase 3b's first {N} requests (prompts "
        f"256-640, budgets 64-192, Exp(1) arrival gaps)")
    peng = family_twin(eng, B, dev, kv_layout="paged", page_size=PAGE,
                       pool_pages=POOL, max_new_tokens=192)
    del eng
    serve = family_serve(ops, dev, peng,
                         sched3b_traffic(peng.tcfg.vocab_size, N), "6")
    del peng
    gc.collect()
    torch.cuda.empty_cache()
    return {"run": run, "serve": serve}


def gemma2_rings(ops, dev, dtype="float32"):
    """Phase 6b: gemma2-27b at full width cut to 4 layers (2 (local,
    global) super-blocks), max_len 8192 and prompts of 4200-4800 tokens, so
    the local layers' rings wrap in prefill and in decode. In float32: the
    logits against the plain attention, parallel, ar and oracle drafts
    against none, and the paged serve against the contiguous one, under
    phase 4's near-tie rule. In bfloat16 (the dtype gemma2 serves in past
    its window): parallel against none and the paged serve against the
    contiguous one, under the bfloat16 near-tie rule."""
    import dataclasses
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.models.transformer import ring_length
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request, Scheduler
    B, P, NEW, K, MAX_LEN = 2, 4500, 32, 5, 8192
    f32 = dtype == "float32"
    tie = NEAR_TIE if f32 else BF16_NEAR_TIE
    tag = "6b" if f32 else "6b bf16"
    log(f"phase {tag}: gemma2-27b {dtype}, full width, 4 of 46 layers (a cut"
        f": 46 in float32 are ~109 GB; in bfloat16 phase 6 runs "
        f"{GEMMA2_LAYERS}), "
        f"max_len {MAX_LEN}, batch {B}, prompt {P}, max_new {NEW}, K {K}, "
        f"near tie {tie}")
    free_card(dev, f"phase {tag}")
    eng = build_engine(arch="gemma2-27b", n_layers=4, dtype=dtype,
                       mode="parallel", K=K, max_new=NEW, max_len=MAX_LEN,
                       batch=B, seed=0, device=dev)
    cfg, V = eng.tcfg, eng.tcfg.vocab_size
    rings = [ring_length(cfg, li, MAX_LEN, K + 1) for li in range(4)]
    log(f"  ring slots per layer {rings} (0: full length); weights "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB")
    if rings != [4096 + K + 1, 0, 4096 + K + 1, 0] or not eng.ring:
        fail(f"gemma2 rings {rings}")

    def twin(**kw):
        ecfg = dataclasses.replace(eng.ecfg, **kw)
        use_d = ecfg.drafter_mode != "none"
        return Engine(cfg, eng.dcfg if use_d else None, eng.tparams,
                      eng.dparams if use_d else None, ecfg, B, device=dev)

    none = twin(drafter_mode="none", K=0)
    prompts = random_prompts(V, B, P, seed=1)
    toks = {}
    modes = [("none", none), ("parallel", eng)]
    if f32:
        modes.append(("ar", twin(drafter_mode="ar")))
    for name, e in modes:
        r = e.run(prompts)
        toks[name] = r["tokens"]
        log(f"  {name:8s} steps {r['steps']:3d} AL "
            f"{r['acceptance_length']:.3f} prefill {r['prefill_s']:.3f} s "
            f"decode {r['decode_s']:.3f} s")
    kpos = r["state"]["tcache"]["blocks"][0]["positions"]
    if not (int(kpos.max()) >= P + NEW - 1 and bool(
            (kpos[0].argsort() != torch.arange(kpos.shape[1],
                                               device=dev)).any())):
        fail(f"{tag}: the local layer's ring did not wrap")
    del r
    oracle_al = None
    for mode in toks:
        if mode != "none":
            near_ties(none, toks[mode][:, :P + NEW],
                      toks["none"][:, :P + NEW], P, f"{tag} {mode}", dev, tie)
    if f32:
        oracle_al = gemma2_oracle(ops, eng, none, prompts, toks["none"], P,
                                  NEW, K, MAX_LEN, dev)

    # Scheduler.serve, paged (per-slot rings beside the global layers'
    # pools) against contiguous, prompts of 4200 and 4800 tokens admitted in
    # power-of-two chunks
    lens = (4200, 4800)
    sp = [np.random.default_rng(3 + i).integers(0, V - 1, n).astype(np.int32)
          for i, n in enumerate(lens)]
    out = {}
    for layout in ("contiguous", "paged"):
        e = twin(kv_layout=layout, page_size=16)
        ops.reset_launches()
        rep = Scheduler(e).serve([Request(p, max_new_tokens=NEW, rid=i)
                                  for i, p in enumerate(sp)])
        counts = dict(ops.launches)
        chunks = [e.prefill_buckets(n) for n in lens]
        want = dense_family_launches(cfg, e.dcfg.n_layers, rep["iterations"],
                                     chunks, layout == "paged",
                                     sum(1 for n in rings if n))
        log(f"  Scheduler.serve {layout}: iterations {rep['iterations']}, "
            f"chunks {chunks}, launches {counts}")
        if rep["preemptions"] or counts != want:
            fail(f"{tag} {layout} serve: {rep['preemptions']} preemptions, "
                 f"launches {counts} != {want}")
        out[layout] = [np.concatenate([p, x["tokens"]])[None]
                       for p, x in zip(sp, rep["results"])]
        del e
    for i, n in enumerate(lens):
        near_ties(none, out["paged"][i], out["contiguous"][i], n,
                  f"{tag} paged vs contiguous serve, request {i}", dev, tie)
    del eng, none
    gc.collect()
    torch.cuda.empty_cache()
    return {"dtype": dtype, "ring_slots": rings, "oracle_al": oracle_al,
            "serve_chunks": [Engine.prefill_buckets(n) for n in lens]}


def gemma2_oracle(ops, eng, none, prompts, ref, P, NEW, K, MAX_LEN, dev):
    """Phase 6b's float32 checks beyond parallel: oracle drafts (a fifth
    spoiled) lift AL above ORACLE_MIN_AL with every token equal to none's
    under the near-tie rule, and the logits through the kernels match the
    plain attention over the wrapped rings. Returns the oracle AL."""
    V = eng.tcfg.vocab_size
    bad = np.random.default_rng(2).random(ref.shape) < 0.2
    table = np.where(bad, (ref + 1) % (V - 1), ref)
    with oracle_drafts(torch.as_tensor(table, dtype=torch.int32, device=dev)):
        r = eng.run(prompts)
    oracle_al = r["acceptance_length"]
    log(f"  oracle   steps {r['steps']:3d} AL {oracle_al:.3f}")
    if not oracle_al > ORACLE_MIN_AL:
        fail(f"oracle drafts reached AL {oracle_al}")
    near_ties(none, r["tokens"][:, :P + NEW], ref[:, :P + NEW], P,
              "6b oracle", dev)
    del r
    kernel_logits_vs_plain(
        ops, none, torch.as_tensor(prompts, device=dev),
        torch.as_tensor(ref[:, P:P + K + 1], device=dev), MAX_LEN,
        last_only=True)
    return oracle_al


def minitron_path(ops, dev):
    """Phase 6c: minitron-4b float32 at full width, all 32 layers (ReLU²
    MLP, untied head): greedy parallel equals none."""
    import dataclasses
    from repro_torch.configs import DrafterConfig, get_config
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.serving.engine import Engine
    B, P, NEW, K, MAX_LEN = 4, 256, 32, 5, 512
    tcfg = get_config("minitron-4b")
    log(f"phase 6c: minitron-4b float32, full width (32 layers, d 3072, "
        f"24/8 heads, d_ff 9216 ReLU², untied head), batch {B}, prompt {P}, "
        f"max_new {NEW}, K {K}")
    free_card(dev, "phase 6c")
    plan = memory_plan(tcfg, DrafterConfig().resolve(tcfg), B, MAX_LEN, 4)
    log("  memory plan: " + ", ".join(f"{k} {v:.2f}" for k, v in plan.items()))
    eng = build_engine(arch="minitron-4b", dtype="float32", mode="parallel",
                       K=K, max_new=NEW, max_len=MAX_LEN, batch=B, seed=0,
                       device=dev)
    if "lm_head" not in eng.tparams:
        fail("minitron-4b built no untied lm_head")
    none = Engine(eng.tcfg, None, eng.tparams, None,
                  dataclasses.replace(eng.ecfg, drafter_mode="none", K=0), B,
                  device=dev)
    prompts = random_prompts(eng.tcfg.vocab_size, B, P, seed=1)
    ops.reset_launches()
    r = eng.run(prompts)
    counts = dict(ops.launches)
    n_d, L = eng.dcfg.n_layers, eng.tcfg.n_layers
    want = {"flash_attention": L,
            "decode_attention": 2 * n_d + r["steps"] * (2 * L + 4 * n_d),
            "paged_decode_attention": 0, "mtp_attention": 0}
    log(f"  parallel steps {r['steps']} AL {r['acceptance_length']:.3f}, "
        f"launches {counts}")
    if counts != want:
        fail(f"minitron launch counts {counts} != {want}")
    ref = none.run(prompts)
    near_ties(none, r["tokens"][:, :P + NEW], ref["tokens"][:, :P + NEW], P,
              "6c parallel vs none", dev)
    del eng, none, r, ref
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": counts, "memory_plan": plan}


# ---------------------------------------------------------------------------
# phases 7 and 8: gemma-7b (head dim 256) and the SSM family (mamba2-780m)
# ---------------------------------------------------------------------------

def ssm_memory_plan(tcfg, dcfg, B, max_len, K, dtype_bytes):
    """The bytes an SSM run holds, from the configs: target and drafter
    weights, the per-slot conv and state rows, the drafter's KV at (B,
    max_len), the verify's peak of per-token snapshots (the state after
    each of its K + 1 tokens, float32, every layer: held from the forward
    to the commit), and the served verify's graph pool, which keeps them
    with the logits and taps for the session (``verify_graph_bytes``)."""
    d, V, L = tcfg.d_model, tcfg.vocab_size, tcfg.n_layers
    s = tcfg.ssm
    d_inner = s.expand * d
    H, N = d_inner // s.head_dim, s.d_state
    conv_ch = d_inner + 2 * N
    layer = d * (2 * d_inner + 2 * N + H) + s.conv_width * conv_ch \
        + d_inner * d
    target = (V * d + L * layer) * dtype_bytes
    drafter = drafter_bytes(tcfg, dcfg, dtype_bytes)
    state = L * B * (H * s.head_dim * N * 4
                     + (s.conv_width - 1) * conv_ch * dtype_bytes)
    kv = dcfg.n_layers * dcfg.n_kv_heads * dcfg.head_dim * 2 * B * max_len * dtype_bytes
    snaps = (K + 1) * L * B * H * s.head_dim * N * 4
    graph = verify_graph_bytes(tcfg, dcfg, B, K, dtype_bytes, snaps)
    return dict(target_gb=target / 1e9, drafter_gb=drafter / 1e9,
                recurrent_state_gb=state / 1e9, drafter_kv_gb=kv / 1e9,
                verify_snapshots_gb=snaps / 1e9, verify_graph_gb=graph / 1e9,
                total_gb=(target + drafter + state + kv + snaps + graph)
                / 1e9)


def admissions_logged(eng):
    """Record the prompt length of every admission prefill ``eng`` runs
    (a fresh request's or a recompute resume's; a swap-in runs none)."""
    lens = []
    inner = eng._admission_prefill

    def logged(prompt, sp, extras=None):
        lens.append(int(prompt.shape[1]))
        return inner(prompt, sp, extras)
    eng._admission_prefill = logged
    return lens


def attention_layers(cfg):
    """The target's attention layers: all of a dense target's, none of an
    SSM's, the attention slots of a hybrid's (8 of recurrentgemma-2b's
    26)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import slot_kind
        return sum(slot_kind(cfg, li) == "attention"
                   for li in range(cfg.n_layers))
    return cfg.n_layers


def encoder_cross_layers(cfg):
    """An encoder-decoder target's (encoder layers, cross-attention layers):
    each encoder layer runs one flash (not causal) a prefill, each decoder
    layer's cross-attention one flash a prefill and one decode (every key at
    position 0) a verify; (0, 0) for the other families."""
    if cfg.family != "encdec":
        return 0, 0
    return cfg.n_encoder_layers, cfg.n_layers


def serve_launches_want(eng, iterations, admitted):
    """Attention launches of a paged Scheduler.serve over pools (no ring):
    each iteration runs phase 1 of every target attention layer and of the
    drafter's draft and extend (paged) and their phase 2 (decode), and an
    encoder-decoder target's cross-attention (decode); an admission prefill
    of a P-token prompt runs its first chunk as a prefill (one flash a
    target attention layer, and an encoder-decoder target's encoder and
    cross-attention layers) and, for a chunk-only target (a recurrent one),
    each further MSB chunk of P in decode mode (2 decode a target attention
    layer), and the drafter's extend once a chunk (2 decode a drafter
    layer)."""
    L_att = attention_layers(eng.tcfg)
    n_enc, n_x = encoder_cross_layers(eng.tcfg)
    n_d = eng.dcfg.n_layers
    per_it = L_att + 2 * n_d
    chunks = [len(eng.prefill_buckets(n)) if eng.chunk_only else 1
              for n in admitted]
    return {"paged_decode_attention": iterations * per_it,
            "decode_attention": iterations * (per_it + n_x)
            + sum(chunks) * 2 * n_d + (sum(chunks) - len(chunks)) * 2 * L_att,
            "flash_attention": len(admitted) * (L_att + n_enc + n_x),
            "mtp_attention": 0}


def family_run(ops, dev, eng, prompts, NEW, K, tag, extras=None):
    """Engine.run at phase 3's shapes after a cold run of 8 steps, with the
    target's ``extras``: the warm run's numbers, its launch counts against
    the target's formula (one flash a target attention layer at the prefill
    and 2 decode a step: every layer of a dense target, none of an SSM, the
    hybrid's attention slots; an encoder-decoder target's encoder and
    cross-attention layers one flash each at the prefill and its
    cross-attention one decode a step), and the output's checks (the
    tokens after a VLM target's vision positions)."""
    eng.run(prompts, extras, max_iters=8)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    r = eng.run(prompts, extras)
    counts = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    steps = r["steps"]
    log(f"  Engine.run warm: otps {r['otps']:.1f} tok/s, prefill "
        f"{r['prefill_s']:.4f} s, decode {r['decode_s']:.4f} s over {steps} "
        f"steps ({r['decode_s'] / steps * 1e3:.2f} ms/step), AL "
        f"{r['acceptance_length']:.4f}, new tokens {r['new_tokens']}, peak "
        f"memory {peak_gb:.2f} GB")
    log(f"  launches: {counts}")
    L_att = attention_layers(eng.tcfg)
    n_enc, n_x = encoder_cross_layers(eng.tcfg)
    n_d = eng.dcfg.n_layers
    want = {"flash_attention": L_att + n_enc + n_x,
            "decode_attention": 2 * n_d + steps * (2 * L_att + n_x
                                                   + 4 * n_d),
            "paged_decode_attention": 0, "mtp_attention": 0}
    if counts != want:
        fail(f"{tag} launch counts {counts} != expected {want}")
    state = r["state"]
    P, V = prompts.shape[1] + eng.pos_offset, eng.tcfg.vocab_size
    if not bool((state["new_count"] == NEW).all()):
        fail(f"{tag} new_count {state['new_count'].tolist()} != {NEW}")
    gen = torch.as_tensor(r["tokens"])[:, P:P + NEW]
    if gen.min() < 0 or gen.max() >= V:
        fail(f"{tag} generated tokens out of range")
    lp = state["logprobs"][:, P:P + NEW]
    if not bool(torch.isfinite(lp).all()) or float(lp.max()) > 0:
        fail(f"{tag} logprobs are not finite log-probabilities")
    if not (1.0 <= r["acceptance_length"] <= K + 1):
        fail(f"{tag} acceptance length {r['acceptance_length']}")
    return dict(otps=r["otps"], prefill_s=r["prefill_s"],
                decode_s=r["decode_s"], steps=steps,
                decode_ms_per_step=r["decode_s"] / steps * 1e3,
                acceptance_length=r["acceptance_length"],
                peak_memory_gb=peak_gb, launches=counts)


def family_serve(ops, dev, peng, traffic, tag):
    """Scheduler.serve of ``traffic`` on the paged engine ``peng`` after a
    cold serve of its first 4 prompts (8-token budgets): the warm run's
    numbers, launch counts by ``serve_launches_want``, every request to its
    budget, preemptions, and both pools empty after."""
    from repro_torch.serving.scheduler import Request, Scheduler
    prompts, budgets, arrivals = traffic
    N = len(prompts)
    sched = Scheduler(peng, sync_every=1)
    sched.serve([Request(p, max_new_tokens=8) for p in prompts[:4]])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    peng.reset_stats()
    admitted = admissions_logged(peng)
    ops.reset_launches()
    rep = sched.serve([Request(p, max_new_tokens=b, arrival_time=a)
                       for p, b, a in zip(prompts, budgets, arrivals)])
    counts = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    it, pre = rep["iterations"], rep["preemptions"]
    log(f"  Scheduler.serve warm: otps {rep['otps']:.1f} tok/s, wall "
        f"{rep['wall_s']:.3f} s ({rep['wall_s'] / it * 1e3:.2f} ms/iteration "
        f"over {it}), otps_vt {rep['otps_vt']:.4f}, AL "
        f"{rep['weighted_acceptance_length']:.4f}, preemptions {pre} (swap "
        f"{rep['preempt_swap']}, recompute {rep['preempt_recompute']}), "
        f"admission prefills {len(admitted)}, peak pages "
        f"{rep['peak_pages']}/{peng.pool_pages}, new tokens "
        f"{rep['total_new_tokens']}, peak memory {peak_gb:.2f} GB")
    want = serve_launches_want(peng, it, admitted)
    log(f"  launches: {counts} ({counts['paged_decode_attention'] / it:.1f} "
        f"paged an iteration)")
    if counts != want:
        fail(f"{tag} scheduler launch counts {counts} != expected {want}")
    res = rep["results"]
    V = peng.tcfg.vocab_size
    if len(res) != N or len({x["rid"] for x in res}) != N:
        fail(f"{tag}: {len(res)} results for {N} requests")
    for x, b in zip(res, budgets):
        if x["n_new"] != b or len(x["tokens"]) != b:
            fail(f"{tag} request {x['rid']} emitted {x['n_new']} tokens, "
                 f"budget {b}")
        if x["tokens"].min() < 0 or x["tokens"].max() >= V:
            fail(f"{tag} request {x['rid']} emitted tokens out of range")
        if not (np.isfinite(x["logprobs"]).all() and x["logprobs"].max() <= 0):
            fail(f"{tag} request {x['rid']} logprobs are not "
                 f"log-probabilities")
    if not pre > 0:
        fail(f"{tag} serve: no request was preempted")
    if peng.allocator.n_used != 0:
        fail(f"{tag}: {peng.allocator.n_used} pages allocated after serve")
    if peng.host_pool is not None and len(peng.host_pool):
        fail(f"{tag}: the host pool still holds a snapshot")
    out = {k: rep[k] for k in ("otps", "otps_vt", "wall_s", "iterations",
                               "total_new_tokens", "preemptions",
                               "preempt_swap", "preempt_recompute",
                               "weighted_acceptance_length", "peak_pages")}
    out.update(ms_per_iteration=rep["wall_s"] / it * 1e3,
               admission_prefills=len(admitted), peak_memory_gb=peak_gb,
               launches=counts)
    return out


def family_twin(eng, B, dev, **kw):
    """An Engine sharing ``eng``'s weights under another configuration."""
    import dataclasses
    from repro_torch.serving.engine import Engine
    ecfg = dataclasses.replace(eng.ecfg, **kw)
    use_d = ecfg.drafter_mode != "none"
    return Engine(eng.tcfg, eng.dcfg if use_d else None, eng.tparams,
                  eng.dparams if use_d else None, ecfg, B, device=dev)


def family_lossless(ops, dev, arch, tag, n_layers=None):
    """float32 at full width (``n_layers`` cuts the depth), phase 4's
    prompts (batch 4, 128 tokens, 32 new, K 5): parallel and ar against
    none, and a paged Scheduler.serve under pool pressure (30 pages of 16,
    recompute preemption) against the contiguous one, under phase 4's
    near-tie rule. Returns (the none engine, its tokens, the prompts, the
    parallel engine)."""
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.serving.scheduler import Request, Scheduler
    B, P, NEW, K, MAX_LEN = 4, 128, 32, 5, 256
    eng = build_engine(arch=arch, n_layers=n_layers, mode="parallel",
                       dtype="float32", K=K, max_new=NEW, max_len=MAX_LEN,
                       batch=B, seed=0, device=dev)
    none = family_twin(eng, B, dev, drafter_mode="none", K=0)
    prompts = random_prompts(eng.tcfg.vocab_size, B, P, seed=1)
    toks = {}
    for name, e in (("none", none), ("parallel", eng),
                    ("ar", family_twin(eng, B, dev, drafter_mode="ar"))):
        r = e.run(prompts)
        toks[name] = r["tokens"][:, :P + NEW]
        log(f"  {name:8s} steps {r['steps']:3d} AL "
            f"{r['acceptance_length']:.3f} decode {r['decode_s']:.3f} s")
    for mode in ("parallel", "ar"):
        near_ties(none, toks[mode], toks["none"], P, f"{tag} {mode}", dev)
    served = {}
    for layout in ("contiguous", "paged"):
        e = family_twin(eng, B, dev, kv_layout=layout, page_size=16,
                        pool_pages=30 if layout == "paged" else 0)
        rep = Scheduler(e).serve([Request(p, max_new_tokens=NEW)
                                  for p in prompts])
        served[layout] = np.concatenate(
            [prompts, np.stack([x["tokens"] for x in rep["results"]])], 1)
        log(f"  Scheduler.serve {layout}: iterations {rep['iterations']}, "
            f"preemptions {rep['preemptions']}")
        if layout == "paged" and not (rep["preemptions"] > 0
                                      and e.allocator.n_used == 0):
            fail(f"{tag} paged serve: {rep['preemptions']} preemptions, "
                 f"{e.allocator.n_used} pages left allocated")
        del e
    near_ties(none, served["paged"], served["contiguous"], P,
              f"{tag} paged vs contiguous serve", dev)
    near_ties(none, served["contiguous"], toks["none"], P,
              f"{tag} contiguous serve vs none", dev)
    return none, toks["none"], prompts, eng


def gemma7b_path(ops, dev):
    """Phase 7: full-width gemma-7b (head dim 256 through the decode, paged
    and flash kernels), its depth cut to GEMMA7B_LAYERS for time: bfloat16
    Engine.run at phase 3's shapes and Scheduler.serve of phase 3b's
    traffic on a paged twin; then float32 greedy losslessness."""
    from repro_torch.configs import DrafterConfig, get_config
    from repro_torch.launch.serve import build_engine, random_prompts
    B, P, NEW, K, MAX_LEN, PAGE, POOL = 8, 512, 128, 5, 1024, 16, 256
    tcfg = get_config("gemma-7b").replace(n_layers=GEMMA7B_LAYERS)
    dcfg = DrafterConfig().resolve(tcfg)
    log(f"phase 7: full-width gemma-7b bfloat16 ({GEMMA7B_LAYERS} of 28 "
        f"layers, cut for time; d 3072, 16/16 heads of 256, d_ff 24576 "
        f"GeGLU, vocab 256000, embedding scale), 4-layer parallel drafter (d "
        f"{dcfg.d_model}, {dcfg.n_heads} heads of {dcfg.head_dim}), batch "
        f"{B}, prompt {P}, max_new {NEW}, K {K}, max_len {MAX_LEN}")
    free_card(dev, "phase 7")
    plan = memory_plan(tcfg, dcfg, B, MAX_LEN, 2)
    log("  memory plan: " + ", ".join(f"{k} {v:.2f}" for k, v in plan.items()))
    t0 = time.perf_counter()
    eng = build_engine(arch="gemma-7b", n_layers=GEMMA7B_LAYERS,
                       mode="parallel", K=K, max_new=NEW, max_len=MAX_LEN,
                       batch=B, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  weights built in {time.perf_counter() - t0:.1f} s: "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    prompts = random_prompts(eng.tcfg.vocab_size, B, P, seed=0)
    run = family_run(ops, dev, eng, prompts, NEW, K, "7")
    run["memory_plan"] = plan
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  Scheduler.serve: paged, page {PAGE}, pool {POOL} pages, "
        f"incremental growth; phase 3b's first 12 requests (cut from 24 for "
        f"time)")
    peng = family_twin(eng, B, dev, kv_layout="paged", page_size=PAGE,
                       pool_pages=POOL, max_new_tokens=192)
    del eng
    serve = family_serve(ops, dev, peng,
                         sched3b_traffic(peng.tcfg.vocab_size, 12), "7")
    del peng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 7b: gemma-7b float32 at full width, {GEMMA7B_LAYERS} of 28 "
        f"layers, phase 4's prompts")
    free_card(dev, "phase 7b")
    lossless = family_lossless(ops, dev, "gemma-7b", "7b", GEMMA7B_LAYERS)
    del lossless
    gc.collect()
    torch.cuda.empty_cache()
    return {"run": run, "serve": serve}


def mamba2_path(ops, dev):
    """Phase 8: full-width mamba2-780m (SSD, attention-free; its drafter
    through the decode and paged kernels), its depth cut to MAMBA2_LAYERS
    for time: bfloat16 Engine.run at phase 3's shapes and Scheduler.serve
    of phase 3b's traffic, paged (the drafter's KV only) with swap to host
    on a pool that preempts; then the float32 checks."""
    from repro_torch.configs import DrafterConfig, get_config
    from repro_torch.launch.serve import build_engine, random_prompts
    B, P, NEW, K, MAX_LEN, PAGE, POOL = 8, 512, 128, 5, 1024, 16, 256
    tcfg = get_config("mamba2-780m").replace(n_layers=MAMBA2_LAYERS)
    dcfg = DrafterConfig().resolve(tcfg)
    log(f"phase 8: full-width mamba2-780m bfloat16 ({MAMBA2_LAYERS} of 48 "
        f"SSD layers, cut for time; d 1536, d_inner 3072, 48 heads of 64, "
        f"d_state 128, chunk 128, vocab 50280), 4-layer parallel drafter (d "
        f"{dcfg.d_model}, {dcfg.n_heads} heads of {dcfg.head_dim}), batch "
        f"{B}, prompt {P}, max_new {NEW}, K {K}, max_len {MAX_LEN}")
    free_card(dev, "phase 8")
    plan = ssm_memory_plan(tcfg, dcfg, B, MAX_LEN, K, 2)
    log("  memory plan: " + ", ".join(f"{k} {v:.2f}" for k, v in plan.items()))
    eng = build_engine(arch="mamba2-780m", n_layers=MAMBA2_LAYERS,
                       mode="parallel", K=K, max_new=NEW, max_len=MAX_LEN,
                       batch=B, seed=0, device=dev)
    if not (eng.model.recurrent and eng.chunk_only):
        fail("mamba2 did not build as a recurrent, chunk-only target")
    prompts = random_prompts(eng.tcfg.vocab_size, B, P, seed=0)
    held = torch.cuda.memory_allocated(dev)
    run = family_run(ops, dev, eng, prompts, NEW, K, "8")
    run.update(memory_plan=plan,
               peak_over_weights_gb=run["peak_memory_gb"] - held / 1e9)
    # the verify's snapshots: a step's peak beyond the state it starts from
    state = eng.prefill(prompts)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = eager_steps(eng, state, 4)
    torch.cuda.synchronize()
    run["step_peak_gb"] = (torch.cuda.max_memory_allocated(dev) - before) / 1e9
    log(f"  a verify step holds {run['step_peak_gb']:.3f} GB beyond its "
        f"state (planned snapshots {plan['verify_snapshots_gb']:.3f} GB)")
    if run["step_peak_gb"] < plan["verify_snapshots_gb"]:
        fail("a verify step held less than its snapshots: were they built?")
    state = graph_pool(eng, state, run, plan)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  Scheduler.serve: paged (the drafter's KV), page {PAGE}, pool "
        f"{POOL} pages, swap to host, incremental growth; phase 3b's first "
        f"12 requests (cut from 24 for time)")
    peng = family_twin(eng, B, dev, kv_layout="paged", page_size=PAGE,
                       pool_pages=POOL, max_new_tokens=192, swap="host")
    del eng
    serve = family_serve(ops, dev, peng,
                         sched3b_traffic(peng.tcfg.vocab_size, 12), "8")
    if not serve["preempt_swap"] > 0:
        fail("phase 8 serve: no request was swapped to the host")
    del peng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 8b: mamba2-780m float32 at full width, {MAMBA2_LAYERS} of "
        f"48 layers, phase 4's prompts")
    checks, eng = recurrent_float32(ops, dev, "mamba2-780m", "8b",
                                    MAMBA2_LAYERS)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"run": run, "serve": serve, "float32": checks}


def recurrent_float32(ops, dev, arch, tag, n_layers=None):
    """Phase 8b / 9b for a recurrent target (``n_layers`` cuts the depth,
    as ``family_lossless``): parallel, ar and none;
    paged against contiguous; a recompute-preempted and a swapped request
    each equal to itself served alone; a seeded sampled request alone equal
    to itself in a batch. Returns (the checks, the float32 parallel engine,
    whose weights later checks share)."""
    from repro_torch.serving.margins import MarginLog
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.scheduler import Request, Scheduler
    none, ref, prompts, eng = family_lossless(ops, dev, arch, tag, n_layers)
    B, NEW = 4, 32
    sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=5)
    out = {}
    with MarginLog() as margins:
        for swap in ("none", "host"):
            e = family_twin(eng, B, dev, kv_layout="paged", page_size=16,
                            pool_pages=30, swap=swap)
            reqs = [Request(p, max_new_tokens=NEW, rid=i,
                            sampling=sp if i == 0 else None)
                    for i, p in enumerate(prompts)]
            rep = Scheduler(e).serve(reqs)
            kind = "preempt_swap" if swap == "host" else "preempt_recompute"
            moved = [x for x in rep["results"] if x["n_preempt"] > 0]
            log(f"  paged serve, swap {swap}: preemptions "
                f"{rep['preemptions']} ({kind} {rep[kind]}), preempted "
                f"requests {[x['rid'] for x in moved]}")
            if not (rep[kind] > 0 and moved):
                fail(f"{tag} serve (swap {swap}): no request was preempted so")
            for x in moved + [rep["results"][0]]:
                req = reqs[x["rid"]]
                alone = Scheduler(e).serve([Request(
                    req.prompt, max_new_tokens=NEW, rid=req.rid,
                    sampling=req.sampling)])["results"][0]
                streams_agree(f"{tag} swap {swap} alone vs batched", none,
                              margins, req, x["tokens"], alone["tokens"])
            out[swap] = {k: rep[k] for k in ("preemptions", "preempt_swap",
                                             "preempt_recompute")}
            if e.allocator.n_used or (e.host_pool is not None
                                      and len(e.host_pool)):
                fail(f"{tag} serve (swap {swap}): a pool did not drain")
            del e
    del none
    gc.collect()
    torch.cuda.empty_cache()
    return out, eng


def hybrid_memory_plan(tcfg, dcfg, B, max_len, K, dtype_bytes):
    """The bytes a hybrid run holds, from the configs: target and drafter
    weights, the recurrent layers' per-slot conv and h rows, the attention
    layers' and the drafter's KV at (B, max_len), and the verify's peak of
    per-token snapshots (the conv window and h after each of its K + 1
    tokens, every recurrent layer: held from the forward to the commit),
    and the served verify's graph pool (``verify_graph_bytes``)."""
    d, V, L = tcfg.d_model, tcfg.vocab_size, tcfg.n_layers
    W, cw = tcfg.hybrid.lru_width or d, tcfg.hybrid.conv_width
    H, KV, hd = tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim
    L_att = attention_layers(tcfg)
    L_rec = L - L_att
    mlp = 3 * d * tcfg.d_ff
    rec = 3 * d * W + 2 * W * W + (cw + 1) * W
    att = 2 * d * H * hd + 2 * d * KV * hd
    target = (V * d + L_rec * (rec + mlp) + L_att * (att + mlp)) * dtype_bytes
    drafter = drafter_bytes(tcfg, dcfg, dtype_bytes)
    row = W * 4 + (cw - 1) * W * dtype_bytes
    state = L_rec * B * row
    kv = (L_att * KV * hd + dcfg.n_layers * dcfg.n_kv_heads * dcfg.head_dim) \
        * 2 * B * max_len * dtype_bytes
    snaps = (K + 1) * L_rec * B * row
    graph = verify_graph_bytes(tcfg, dcfg, B, K, dtype_bytes, snaps)
    return dict(target_gb=target / 1e9, drafter_gb=drafter / 1e9,
                recurrent_state_gb=state / 1e9, kv_gb=kv / 1e9,
                verify_snapshots_gb=snaps / 1e9, verify_graph_gb=graph / 1e9,
                total_gb=(target + drafter + state + kv + snaps + graph)
                / 1e9)


def recurrentgemma_path(ops, dev):
    """Phase 9: full-width recurrentgemma-2b (the hybrid family: RG-LRU
    and causal conv per recurrent layer, MQA local attention at head dim
    256 through the decode, paged and flash kernels): bfloat16 Engine.run
    at phase 3's shapes, a verify step's peak beyond its state, and
    Scheduler.serve of phase 3b's traffic, paged (at max_len 1024 < 2048 +
    6 the local layers' caches are pools beside the per-slot recurrent
    rows) with swap to host on a pool that preempts; then the float32
    checks (9b)."""
    from repro_torch.configs import DrafterConfig, get_config
    from repro_torch.launch.serve import build_engine, random_prompts
    B, P, NEW, K, MAX_LEN, PAGE, POOL = 8, 512, 128, 5, 1024, 16, 256
    tcfg = get_config("recurrentgemma-2b").replace(n_layers=RGEMMA_LAYERS)
    dcfg = DrafterConfig().resolve(tcfg)
    n_att = attention_layers(tcfg)
    log(f"phase 9: full-width recurrentgemma-2b bfloat16 ({RGEMMA_LAYERS} "
        f"of 26 layers, cut for time: {n_att} x (recurrent, recurrent, "
        f"attention) + 2 recurrent; d 2560, lru 2560, "
        f"conv 4, MQA 10/1 heads of 256, window {tcfg.window_size}, d_ff "
        f"7680 GeGLU, vocab 256000, embedding scale), 4-layer parallel "
        f"drafter (d {dcfg.d_model}, {dcfg.n_heads} heads of "
        f"{dcfg.head_dim}), batch {B}, prompt {P}, max_new {NEW}, K {K}, "
        f"max_len {MAX_LEN}")
    free_card(dev, "phase 9")
    plan = hybrid_memory_plan(tcfg, dcfg, B, MAX_LEN, K, 2)
    log("  memory plan: " + ", ".join(f"{k} {v:.3f}" for k, v in plan.items()))
    t0 = time.perf_counter()
    eng = build_engine(arch="recurrentgemma-2b", n_layers=RGEMMA_LAYERS,
                       mode="parallel", K=K, max_new=NEW, max_len=MAX_LEN,
                       batch=B, seed=0, device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    log(f"  weights built in {time.perf_counter() - t0:.1f} s: "
        f"{held / 1e9:.2f} GB allocated")
    if not (eng.model.recurrent and eng.chunk_only and not eng.ring):
        fail("recurrentgemma did not build as a recurrent, chunk-only "
             "target without rings at max_len 1024")
    prompts = random_prompts(eng.tcfg.vocab_size, B, P, seed=0)
    run = family_run(ops, dev, eng, prompts, NEW, K, "9")
    run.update(memory_plan=plan,
               peak_over_weights_gb=run["peak_memory_gb"] - held / 1e9)
    state = eng.prefill(prompts)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = eager_steps(eng, state, 4)
    torch.cuda.synchronize()
    run["step_peak_gb"] = (torch.cuda.max_memory_allocated(dev) - before) / 1e9
    log(f"  a verify step holds {run['step_peak_gb']:.3f} GB beyond its "
        f"state (planned snapshots {plan['verify_snapshots_gb']:.3f} GB)")
    if run["step_peak_gb"] < plan["verify_snapshots_gb"]:
        fail("a verify step held less than its snapshots: were they built?")
    state = graph_pool(eng, state, run, plan)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  Scheduler.serve: paged (the local layers' KV and the drafter's),"
        f" page {PAGE}, pool {POOL} pages, swap to host, incremental growth;"
        f" phase 3b's first 12 requests")
    peng = family_twin(eng, B, dev, kv_layout="paged", page_size=PAGE,
                       pool_pages=POOL, max_new_tokens=192, swap="host")
    del eng
    serve = family_serve(ops, dev, peng,
                         sched3b_traffic(peng.tcfg.vocab_size, 12), "9")
    if not serve["preempt_swap"] > 0:
        fail("phase 9 serve: no request was swapped to the host")
    del peng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 9b: recurrentgemma-2b float32 at full width, "
        f"{RGEMMA_LAYERS} of 26 layers, phase 4's prompts")
    free_card(dev, "phase 9b")
    checks, eng = recurrent_float32(ops, dev, "recurrentgemma-2b", "9b",
                                    RGEMMA_LAYERS)
    checks["rings"] = rgemma_rings(ops, dev, eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"run": run, "serve": serve, "float32": checks}


def rgemma_rings(ops, dev, eng):
    """Phase 9b's wrapped rings, on the float32 weights of ``eng``: batch
    2, max_len 4096 (the local layers' rings hold 2048 + 6 slots), K 5,
    2300-token prompts: Engine.run prefills them (the rings wrap at the
    prefill) and decodes 32 tokens, parallel with the random drafter (every
    draft rejected) and with oracle drafts (a fifth spoiled, AL > 2)
    against none under phase 4's near-tie rule; the logits through the
    kernels against the plain attention over the wrapped rings; then
    Scheduler.serve of a 2100- and a 2400-token prompt (MSB chunks: the
    decode-mode chunks past 2048 wrap the rings), parallel against none,
    launch counts by ``dense_family_launches``."""
    from repro_torch.launch.serve import random_prompts
    from repro_torch.models.transformer import ring_length
    from repro_torch.serving.scheduler import Request, Scheduler
    B, P, NEW, K, MAX_LEN = 2, 2300, 32, 5, 4096
    cfg, V = eng.tcfg, eng.tcfg.vocab_size
    log(f"phase 9b: wrapped rings, float32, batch {B}, max_len {MAX_LEN}, "
        f"prompt {P}, max_new {NEW}, K {K}")
    kw = dict(max_len=MAX_LEN, max_new_tokens=NEW)
    par = family_twin(eng, B, dev, **kw)
    none = family_twin(eng, B, dev, drafter_mode="none", K=0, **kw)
    n_ring = attention_layers(cfg)
    slots = ring_length(cfg, 2, MAX_LEN, K + 1)
    if slots != RGEMMA_WINDOW + K + 1 or not (par.ring and none.ring):
        fail(f"recurrentgemma rings of {slots} slots at max_len {MAX_LEN}")
    prompts = random_prompts(V, B, P, seed=2)
    toks = {}
    for name, e in (("none", none), ("parallel", par)):
        r = e.run(prompts)
        toks[name] = r["tokens"][:, :P + NEW]
        log(f"  {name:8s} steps {r['steps']:3d} AL "
            f"{r['acceptance_length']:.3f} prefill {r['prefill_s']:.3f} s "
            f"decode {r['decode_s']:.3f} s")
    kpos = r["state"]["tcache"]["blocks"][2]["positions"]
    if not (kpos.shape[1] == slots and int(kpos.max()) >= P + NEW - 1
            and bool((kpos[0].argsort() != torch.arange(
                slots, device=dev)).any())):
        fail("9b: the local layer's ring did not wrap")
    del r
    near_ties(none, toks["parallel"], toks["none"], P, "9b rings parallel",
              dev)
    ref = toks["none"]
    bad = np.random.default_rng(2).random(ref.shape) < 0.2
    table = np.where(bad, (ref + 1) % (V - 1), ref)
    with oracle_drafts(torch.as_tensor(table, dtype=torch.int32, device=dev)):
        r = par.run(prompts)
    oracle_al = r["acceptance_length"]
    log(f"  oracle   steps {r['steps']:3d} AL {oracle_al:.3f}")
    if not oracle_al > ORACLE_MIN_AL:
        fail(f"9b oracle drafts reached AL {oracle_al}")
    near_ties(none, r["tokens"][:, :P + NEW], ref, P, "9b rings oracle", dev)
    del r
    kernel_logits_vs_plain(ops, none, torch.as_tensor(prompts, device=dev),
                           torch.as_tensor(ref[:, P:P + K + 1], device=dev),
                           MAX_LEN, last_only=True)
    lens = (2100, 2400)
    sp = [np.random.default_rng(5 + i).integers(0, V - 1, n).astype(np.int32)
          for i, n in enumerate(lens)]
    out = {}
    for name, e in (("none", none), ("parallel", par)):
        ops.reset_launches()
        rep = Scheduler(e).serve([Request(p, max_new_tokens=NEW, rid=i)
                                  for i, p in enumerate(sp)])
        counts = dict(ops.launches)
        chunks = [e.prefill_buckets(n) for n in lens]
        want = dense_family_launches(cfg, e.dcfg.n_layers if e.dcfg else 0,
                                     rep["iterations"], chunks, False, n_ring)
        log(f"  Scheduler.serve {name}: iterations {rep['iterations']}, "
            f"chunks {chunks}, launches {counts}")
        if rep["preemptions"] or counts != want:
            fail(f"9b {name} serve: {rep['preemptions']} preemptions, "
                 f"launches {counts} != {want}")
        out[name] = [np.concatenate([p, x["tokens"]])[None]
                     for p, x in zip(sp, rep["results"])]
    for i, n in enumerate(lens):
        near_ties(none, out["parallel"][i], out["none"][i], n,
                  f"9b rings serve, request {i}", dev)
    del par, none
    gc.collect()
    torch.cuda.empty_cache()
    return {"ring_slots": slots, "oracle_al": oracle_al,
            "serve_chunks": [list(c) for c in chunks]}


@contextlib.contextmanager
def eager_verify(eng):
    """``eng``'s verify forward run eagerly inside the block: a replayed
    one (``serving/verify_graph.py``) calls none of the forward's Python
    functions but the paged kernel's, so a probe that wraps one
    (``moe_probe``, which also reads back, and no capture may) or swaps
    the kernels for their plain versions (``plain_attention``) needs the
    eager path; so does a step's memory peak (a replay's buffers, a
    recurrent target's snapshots among them, sit in its graphs' pool,
    reserved when they were captured: ``graph_pool`` reads that)."""
    from repro_torch.serving.verify_graph import eager
    graph, eng.verify = eng.verify, eager
    try:
        yield eng
    finally:
        eng.verify = graph


def eager_steps(eng, state, n: int):
    """``n`` steps of ``eng`` under ``eager_verify``."""
    with eager_verify(eng):
        for _ in range(n):
            state = eng.step(state)
    return state


def graph_pool(eng, state, run, plan):
    """The served path's verify memory: three steps of ``eng`` as it
    serves (eager, capture, replay under a new key), then the device memory
    its graphs' capture reserved for the session (``VerifyGraph
    .pool_bytes``). It has to hold the plan's ``verify_graph_gb`` (the
    graphs' outputs) and at most what an eager step held beyond its state
    (``run["step_peak_gb"]``), by a quarter and 0.1 GB of the allocator's
    rounding more. Returns the state."""
    for _ in range(3):
        state = eng.step(state)
    torch.cuda.synchronize()
    run["graph_pool_gb"] = eng.verify.pool_bytes / 1e9
    log(f"  served (graphed) verify: its pool reserves "
        f"{run['graph_pool_gb']:.3f} GB for the session (planned outputs "
        f"{plan['verify_graph_gb']:.3f} GB; an eager step's peak "
        f"{run['step_peak_gb']:.3f} GB)")
    if run["graph_pool_gb"] < plan["verify_graph_gb"]:
        fail("the verify's graphs hold less than their outputs: were they "
             "captured?")
    if run["graph_pool_gb"] > 1.25 * run["step_peak_gb"] + 0.1:
        fail("the verify's graphs hold more than an eager step did")
    return state


# ---------------------------------------------------------------------------
# phases 10 and 10b: the MoE family (dbrx-132b)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def moe_probe():
    """Record every MoE layer call of the port's target: its (B, S), its
    drop_frac, its experts (the router's top-K ids, on the host) and its
    router margins, the gap between a token's K-th and (K+1)-th router
    probabilities (the smallest of the call, and each row's smallest),
    read from the same router here, not an output of moe_apply. Each
    record syncs the card: not for timed runs."""
    from repro_torch.models import moe, transformer
    records, inner = [], transformer.moe_apply

    def probed(p, x, **kw):
        out, aux = inner(p, x, **kw)
        B, S, K = x.shape[0], x.shape[1], kw["top_k"]
        _, probs, _, experts = moe.route(p, x.reshape(-1, x.shape[-1]), K)
        top = probs.topk(K + 1, dim=-1).values
        gap = (top[:, K - 1] - top[:, K]).view(B, S)
        records.append(dict(shape=(B, S), drop_frac=float(aux["drop_frac"]),
                            margin=float(gap.min()),
                            row_margin=gap.amin(1).cpu().numpy(),
                            experts=experts.cpu()))
        return out, aux
    transformer.moe_apply = probed
    try:
        yield records
    finally:
        transformer.moe_apply = inner


def routing_parts(a, b, n_moe, what, router_tie=ROUTER_NEAR_TIE):
    """The first target call (0: the prefill, s + 1: step s) at which two
    probed runs of the same shapes route a token to other experts, or
    None. Fails unless one of the runs had a router margin below
    ROUTER_NEAR_TIE in that layer call: sums in another order move a
    probability by ~1e-7, so only a near tie flips an expert."""
    for j, (x, y) in enumerate(zip(a, b)):
        if x["shape"] == y["shape"] and torch.equal(x["experts"], y["experts"]):
            continue
        m = min(x["margin"], y["margin"])
        log(f"  {what}: the experts differ at call {j // n_moe} (MoE layer "
            f"{j % n_moe}), router margin {m:.3e}")
        if not m < router_tie:
            fail(f"{what}: the experts differ at call {j // n_moe} with a "
                 f"router margin of {m} >= {router_tie}")
        return j // n_moe
    if len(a) != len(b):
        fail(f"{what}: {len(a)} against {len(b)} MoE calls")
    return None


def row_router_ties(a, b, n_moe, B, what, router_tie=ROUTER_NEAR_TIE):
    """Each row's first target call (as ``routing_parts``) from which two
    probed runs may part for that row, or None: where both runs' layer
    calls have one shape, the first at which the row's experts differ
    (failing unless one run's router margin for the row is below
    ROUTER_NEAR_TIE there); where the shapes differ (a verify against a
    plain decode step) or one run made no such call, the first in which
    either run had a token of the row with a margin below it."""
    first = [None] * B
    for j in range(max(len(a), len(b))):
        x, y = (r[j] if j < len(r) else None for r in (a, b))
        if x is not None and y is not None and x["shape"] == y["shape"]:
            moved = (x["experts"].reshape(B, -1) != y["experts"].reshape(B, -1)
                     ).any(1).numpy()
            low = np.minimum(x["row_margin"], y["row_margin"])
            for rb in np.flatnonzero(moved & ~(low < router_tie)):
                fail(f"{what}: row {rb}'s experts differ at call "
                     f"{j // n_moe} with a router margin of {low[rb]}")
        else:
            moved = np.minimum.reduce([r["row_margin"] for r in (x, y)
                                       if r is not None]) < router_tie
        for rb in np.flatnonzero(moved):
            if first[rb] is None:
                first[rb] = j // n_moe
    return first


def moe_streams_agree(ref_eng, toks, ref, P, what, dev, probes, coupled,
                      tie=NEAR_TIE, router_tie=ROUTER_NEAR_TIE):
    """phase 4's near-tie rule for two greedy MoE runs, with the router's:
    a row may part where the reference's top-2 logit gap is below ``tie``,
    or from position P + i on, call i committing positions P + i and later
    (0: the prefill, s + 1: step s). ``coupled`` (slots dropped: a flipped
    expert moves other tokens' capacity, every row's): i is the first call
    at which the two runs' experts differ (``routing_parts``), for every
    row. Else (nothing dropped: tokens do not interact) i is the row's own
    (``row_router_ties``). ``router_tie``: a router margin below it may
    flip an expert (ROUTER_NEAR_TIE in float32, BF16_ROUTER_NEAR_TIE in
    bfloat16)."""
    n_moe = sum(ref_eng.tcfg.is_moe_layer(li)
                for li in range(ref_eng.tcfg.n_layers))
    B, W = toks.shape
    if coupled:
        i = routing_parts(*probes, n_moe, what, router_tie)
        firsts = [i] * B
    else:
        firsts = row_router_ties(*probes, n_moe, B, what, router_tie)
    toks = toks.copy()
    for b, i in enumerate(firsts):
        if i is not None and P + i < W:
            end = P + i
            same = bool((toks[b, end:] == ref[b, end:]).all())
            log(f"  {what}: row {b} compared up to position {end} (a router "
                f"near tie); past it {'equal all the same' if same else 'it parts'}")
            toks[b, end:] = ref[b, end:]
    return near_ties(ref_eng, toks, ref, P, what, dev, tie=tie)


def dbrx_path(ops, dev):
    """Phase 10: dbrx-132b at full width in bfloat16, its depth cut to
    DBRX_LAYERS (every layer MoE: 16 experts, top-4, capacity factor 1.25;
    its attention 48/8 heads through the flash and decode kernels):
    Engine.run at phase 3's shapes, the routing of a prefill and a verify,
    a step's memory beyond its state, and Scheduler.serve of phase 3b's
    first 12 requests over paged KV with swap to host; then 10b."""
    from repro_torch.configs import DrafterConfig, get_config
    from repro_torch.launch.serve import build_engine, random_prompts
    B, P, NEW, K, MAX_LEN, PAGE, POOL, N = 8, 512, 128, 5, 1024, 16, 256, 12
    tcfg = get_config("dbrx-132b").replace(n_layers=DBRX_LAYERS)
    dcfg = DrafterConfig().resolve(tcfg)
    m = tcfg.moe
    log(f"phase 10: full-width dbrx-132b bfloat16 ({DBRX_LAYERS} of 40 "
        f"layers: 40 do not fit one card; d 6144, 48/8 heads of 128, "
        f"{m.n_experts} experts top-{m.top_k} of d_ff 10752 SwiGLU on every "
        f"layer, capacity factor {m.capacity_factor}, vocab 100352, untied "
        f"head), 4-layer parallel drafter (d {dcfg.d_model}, "
        f"{dcfg.n_heads}/{dcfg.n_kv_heads} heads of {dcfg.head_dim}, d_ff "
        f"{dcfg.d_ff}), batch {B}, prompt {P}, max_new {NEW}, K {K}, "
        f"max_len {MAX_LEN}")
    free_card(dev, "phase 10")
    plan = memory_plan(tcfg, dcfg, B, MAX_LEN, 2, K=K)
    log("  memory plan: " + ", ".join(f"{k} {v:.2f}" for k, v in plan.items()))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = build_engine(arch="dbrx-132b", n_layers=DBRX_LAYERS,
                       mode="parallel", K=K, max_new=NEW, max_len=MAX_LEN,
                       batch=B, seed=0, device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    log(f"  weights built in {time.perf_counter() - t0:.1f} s: "
        f"{held / 1e9:.2f} GB allocated, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    prompts = random_prompts(eng.tcfg.vocab_size, B, P, seed=0)
    run = family_run(ops, dev, eng, prompts, NEW, K, "10")
    run.update(memory_plan=plan, weights_gb=held / 1e9)
    with moe_probe() as probe, torch.no_grad():
        state = eng.prefill(prompts)
        n_pre = len(probe)
        state = eager_steps(eng, state, 1)
    pre, ver = probe[:n_pre], probe[n_pre:]
    if not ([r["shape"] for r in pre] == [(B, P)] * DBRX_LAYERS
            and [r["shape"] for r in ver] == [(B, K + 1)] * DBRX_LAYERS):
        fail(f"phase 10 MoE calls {[r['shape'] for r in probe]}: want "
             f"{DBRX_LAYERS} at ({B}, {P}) then {DBRX_LAYERS} at ({B}, "
             f"{K + 1})")
    run.update(prefill_drop_frac=float(np.mean([r["drop_frac"] for r in pre])),
               verify_drop_frac=float(np.mean([r["drop_frac"] for r in ver])),
               router_min_margin=min(r["margin"] for r in probe))
    log(f"  routing: mean drop_frac {run['prefill_drop_frac']:.4f} at the "
        f"prefill ({B} x {P} tokens, capacity "
        f"{int((B * P * m.top_k) / m.n_experts * m.capacity_factor) + 1}), "
        f"{run['verify_drop_frac']:.4f} at a verify ({B} x {K + 1}, capacity "
        f"{int((B * (K + 1) * m.top_k) / m.n_experts * m.capacity_factor) + 1}"
        f"); smallest router top-{m.top_k} margin "
        f"{run['router_min_margin']:.3e}")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = eager_steps(eng, state, 4)
    torch.cuda.synchronize()
    run["step_peak_gb"] = (torch.cuda.max_memory_allocated(dev) - before) / 1e9
    log(f"  a verify step holds {run['step_peak_gb']:.3f} GB beyond its "
        f"state")
    state = graph_pool(eng, state, run, plan)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  Scheduler.serve: paged, page {PAGE}, pool {POOL} pages, swap to "
        f"host, incremental growth; phase 3b's first {N} requests")
    peng = family_twin(eng, B, dev, kv_layout="paged", page_size=PAGE,
                       pool_pages=POOL, max_new_tokens=192, swap="host")
    del eng
    serve = family_serve(ops, dev, peng,
                         sched3b_traffic(peng.tcfg.vocab_size, N), "10")
    if not serve["preempt_swap"] > 0:
        fail("phase 10 serve: no request was swapped to the host")
    del peng
    gc.collect()
    torch.cuda.empty_cache()
    return {"run": run, "serve": serve, "float32": dbrx_float32(ops, dev)}


def dbrx_float32(ops, dev):
    """Phase 10b: dbrx-132b in float32 at full width on 2 layers (~45 GB),
    phase 4's prompts: (i) the target's logits through the kernels against
    the plain attention (a prefill and a verify), and the greedy streams
    of both paths; (ii) at capacity factor n_experts (no slot dropped, as
    ``reduced()`` sets it) greedy parallel and ar against none. Streams
    under ``moe_streams_agree``'s near-tie rules: (i) coupled (a flipped
    expert moves every row's capacity), (ii) per row."""
    import dataclasses
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.serving.engine import Engine
    B, P, NEW, K, MAX_LEN = 4, 128, 32, 5, 256
    log(f"phase 10b: dbrx-132b float32 at full width, 2 of 40 layers, batch "
        f"{B}, prompt {P}, max_new {NEW}, K {K}")
    free_card(dev, "phase 10b")
    eng = build_engine(arch="dbrx-132b", n_layers=2, mode="parallel",
                       dtype="float32", K=K, max_new=NEW, max_len=MAX_LEN,
                       batch=B, seed=0, device=dev)
    V = eng.tcfg.vocab_size
    prompts = random_prompts(V, B, P, seed=1)
    block = torch.as_tensor(random_prompts(V, B, K + 1, seed=2), device=dev)
    kernel_logits_vs_plain(ops, eng, torch.as_tensor(prompts, device=dev),
                           block, MAX_LEN)
    none = family_twin(eng, B, dev, drafter_mode="none", K=0)
    out = {}
    runs, probes = {}, {}
    for name, ctx in (("kernels", contextlib.nullcontext()),
                      ("plain", plain_attention(ops))):
        with ctx, moe_probe() as probe, eager_verify(eng):
            r = eng.run(prompts)
        runs[name], probes[name] = r["tokens"][:, :P + NEW], probe
        log(f"  {name:7s} steps {r['steps']:3d} AL "
            f"{r['acceptance_length']:.3f}, mean drop_frac "
            f"{np.mean([x['drop_frac'] for x in probe]):.4f}, smallest router "
            f"margin {min(x['margin'] for x in probe):.3e}")
    out["kernels_vs_plain_parted_rows"] = moe_streams_agree(
        none, runs["kernels"], runs["plain"], P, "10b kernels vs plain", dev,
        (probes["kernels"], probes["plain"]), coupled=True)
    tcfg = eng.tcfg.replace(moe=dataclasses.replace(
        eng.tcfg.moe, capacity_factor=float(eng.tcfg.moe.n_experts)))
    runs, probes = {}, {}
    for mode in ("none", "parallel", "ar"):
        use_d = mode != "none"
        e = Engine(tcfg, eng.dcfg if use_d else None, eng.tparams,
                   eng.dparams if use_d else None,
                   dataclasses.replace(eng.ecfg, drafter_mode=mode,
                                       K=K if use_d else 0), B, device=dev)
        with moe_probe() as probe, eager_verify(e):
            r = e.run(prompts)
        runs[mode], probes[mode] = r["tokens"][:, :P + NEW], probe
        dropped = max(x["drop_frac"] for x in probe)
        log(f"  capacity factor {tcfg.moe.capacity_factor:g}, {mode:8s} steps "
            f"{r['steps']:3d}, largest drop_frac {dropped}")
        if dropped != 0.0:
            fail(f"10b {mode} at capacity factor n_experts dropped slots")
        if mode == "none":
            ref_eng = e
        del e
    for mode in ("parallel", "ar"):
        out[f"no_drops_{mode}_vs_none_parted_rows"] = moe_streams_agree(
            ref_eng, runs[mode], runs["none"], P,
            f"10b capacity {tcfg.moe.capacity_factor:g} {mode} vs none", dev,
            (probes[mode], probes["none"]), coupled=False)
    del eng, none, ref_eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 11 - 12b: the VLM (internvl2-1b) and encoder-decoder (whisper-base)
# families, their stub frontends' extras through every entry point
# ---------------------------------------------------------------------------

def stub_extras(eng, batch, seed):
    """``make_extras`` of ``eng``'s target at prefill, drawn on the card
    from threefry key ``seed``."""
    from repro_torch import prng
    from repro_torch.models.registry import make_extras
    return make_extras(eng.tcfg, batch, "prefill",
                       prng.PRNGKey(seed, device=eng.device))


def whisper_traffic(vocab, n=24):
    """Phase 12's requests: decoder prompts of 32-192 tokens, budgets
    64-192, Exp(1) virtual arrivals, seed 0: (prompts, budgets,
    arrivals)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 193, n)
    budgets = rng.integers(64, 193, n)
    arrivals = np.cumsum(rng.exponential(1.0, n))
    prompts = [rng.integers(0, vocab - 1, m).astype(np.int32) for m in lens]
    return prompts, [int(b) for b in budgets], [float(a) for a in arrivals]


def internvl2_path(ops, dev):
    """Phase 11: internvl2-1b at full width in bfloat16 (INTERNVL2_LAYERS
    of its 24 layers, cut for time; 256 stub vision tokens of 1024
    early-fused before each prompt): Engine.run at phase 3's shapes (a
    fused prefill of 768 positions; a flash a layer and 8 decode at the
    prefill, 2 decode a layer and 16 a step, every decode at
    positions 256 past its token index), then Scheduler.serve of phase
    3b's first 12 requests over paged KV with swap to host, each request's
    vision extras drawn from its prompt at admission, at max_len 1280 (256
    + 640 + 192 + 6 exceeds 1024) on a pool of 320 pages (half of 8 full
    rows), the prefix cache asked for and never built; then 11b."""
    from repro_torch.launch.serve import build_engine, random_prompts
    B, P, NEW, K, MAX_LEN, PAGE, POOL = (8, 512, 128, 5, 1024, 16,
                                         INTERNVL2_POOL)
    log(f"phase 11: full-width internvl2-1b bfloat16 ({INTERNVL2_LAYERS} of "
        f"24 layers, d 896, 14/2 "
        f"heads of 64, d_ff 4864 SwiGLU, vocab 151655; {INTERNVL2_VISION} "
        f"stub vision tokens of 1024 through vis_proj), 4-layer parallel "
        f"drafter, batch {B}, prompt {P} (fused {P + INTERNVL2_VISION}), "
        f"max_new {NEW}, K {K}, max_len {MAX_LEN}")
    free_card(dev, "phase 11")
    eng = build_engine(arch="internvl2-1b", n_layers=INTERNVL2_LAYERS,
                       mode="parallel", K=K, max_new=NEW, max_len=MAX_LEN,
                       batch=B, seed=0, device=dev)
    if eng.pos_offset != INTERNVL2_VISION:
        fail(f"phase 11: vision offset {eng.pos_offset}")
    prompts = random_prompts(eng.tcfg.vocab_size, B, P, seed=0)
    extras = stub_extras(eng, B, 0)
    run = family_run(ops, dev, eng, prompts, NEW, K, "11", extras)
    log(f"  Scheduler.serve: paged, page {PAGE}, pool {POOL} pages, swap to "
        f"host, max_len 1280, prefix cache asked for; phase 3b's first 12 "
        f"requests")
    peng = family_twin(eng, B, dev, kv_layout="paged", page_size=PAGE,
                       pool_pages=POOL, max_new_tokens=192, max_len=1280,
                       swap="host", prefix_cache=True)
    del eng
    serve = family_serve(ops, dev, peng,
                         sched3b_traffic(peng.tcfg.vocab_size, 12), "11")
    if peng.prefix_cache is not None:
        fail("phase 11: a prefix cache was built for a VLM target")
    if not serve["preempt_swap"] > 0:
        fail("phase 11 serve: no request was swapped to the host")
    del peng
    gc.collect()
    torch.cuda.empty_cache()
    return {"run": run, "serve": serve,
            "float32": modality_float32(ops, dev, "internvl2-1b", "11b")}


def whisper_path(ops, dev):
    """Phase 12: whisper-base at full width in bfloat16 (6 encoder and 6
    decoder layers, d 512, 8/8 heads of 64; 1500 stub encoder frames):
    Engine.run of batch 8, 128-token decoder prompts, 128 new, K 5, max_len
    448 (18 flash at the prefill: 6 encoder layers, 6 decoder self and 6
    cross layers; 8 decode at the prefill and 34 a step: the decoder's two
    phases, its cross-attention through the decode kernel, the drafter's),
    then Scheduler.serve of 24 requests (prompts 32-192, budgets 64-192,
    Exp(1) gaps) over paged self-attention (page 16, 28 pages a row, a pool
    of 112) with swap to host, the per-slot cross K/V (18.4 MB a slot)
    swapped with the slot; then 12b."""
    from repro_torch.launch.serve import build_engine, random_prompts
    B, P, NEW, K, MAX_LEN, PAGE, POOL = 8, 128, 128, 5, 448, 16, 112
    log(f"phase 12: full-width whisper-base bfloat16 (6 + 6 layers, d 512, "
        f"8/8 heads of 64, d_ff 2048 GELU, vocab 51865, 1500 stub encoder "
        f"frames, sinusoidal positions), 4-layer parallel drafter, batch {B}, "
        f"prompt {P}, max_new {NEW}, K {K}, max_len {MAX_LEN}")
    free_card(dev, "phase 12")
    eng = build_engine(arch="whisper-base", mode="parallel", K=K, max_new=NEW,
                       max_len=MAX_LEN, batch=B, seed=0, device=dev)
    prompts = random_prompts(eng.tcfg.vocab_size, B, P, seed=0)
    run = family_run(ops, dev, eng, prompts, NEW, K, "12",
                     stub_extras(eng, B, 0))
    log(f"  Scheduler.serve: paged, page {PAGE}, pool {POOL} pages, swap to "
        f"host; 24 requests, prompts 32-192, budgets 64-192")
    peng = family_twin(eng, B, dev, kv_layout="paged", page_size=PAGE,
                       pool_pages=POOL, max_new_tokens=192, swap="host",
                       prefix_cache=True)
    del eng
    row_bytes = peng._swap_layout()[0]
    c = peng.tcfg
    cross = (c.n_layers * 2 * c.encoder_seq * c.n_kv_heads * c.head_dim
             * getattr(torch, peng.ecfg.cache_dtype).itemsize)
    log(f"  a slot's per-slot rows {row_bytes / 1e6:.2f} MB (its cross K/V "
        f"{cross / 1e6:.2f} MB)")
    if row_bytes < cross:
        fail(f"phase 12: a slot's swapped rows ({row_bytes} B) do not hold "
             f"its cross K/V ({cross} B)")
    serve = family_serve(ops, dev, peng,
                         whisper_traffic(peng.tcfg.vocab_size), "12")
    if peng.prefix_cache is not None:
        fail("phase 12: a prefix cache was built for an encoder-decoder "
             "target")
    if not serve["preempt_swap"] > 0:
        fail("phase 12 serve: no request was swapped to the host")
    serve["slot_row_mb"] = row_bytes / 1e6
    del peng
    gc.collect()
    torch.cuda.empty_cache()
    return {"run": run, "serve": serve,
            "float32": modality_float32(ops, dev, "whisper-base", "12b")}


def modality_float32(ops, dev, arch, tag):
    """Phases 11b / 12b: ``arch`` in float32 at full width, batch 4,
    128-token prompts, 32 new, K 5, stub extras from seed 1: the target's
    logits through the kernels against the plain attention (a prefill with
    the extras, a verify block against its cache) within 1e-3; greedy
    parallel and ar against none; and a paged Scheduler.serve under pool
    pressure (recompute preemption, each request with its row's extras)
    against the contiguous one, whose requests run uninterrupted, and
    against none: every stream equal under phase 4's near-tie rule, a
    resumed one included."""
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.serving.scheduler import Request, Scheduler
    B, P, NEW, K = 4, 128, 32, 5
    vision = INTERNVL2_VISION if arch == "internvl2-1b" else 0
    MAX_LEN = -(-(256 + vision) // 16) * 16
    # two requests' first claims fit, their whole lifetimes do not: the
    # paged serve preempts and resumes
    POOL = 2 * -(-(vision + P + NEW + K + 1) // 16) - 2
    log(f"phase {tag}: {arch} float32 at full width, batch {B}, prompt {P}, "
        f"max_new {NEW}, K {K}, max_len {MAX_LEN}")
    free_card(dev, f"phase {tag}")
    eng = build_engine(arch=arch, mode="parallel", dtype="float32", K=K,
                       max_new=NEW, max_len=MAX_LEN, batch=B, seed=0,
                       device=dev)
    V, off = eng.tcfg.vocab_size, eng.pos_offset
    prompts = random_prompts(V, B, P, seed=1)
    extras = stub_extras(eng, B, 1)
    block = torch.as_tensor(random_prompts(V, B, K + 1, seed=2), device=dev)
    errs = kernel_logits_vs_plain(ops, eng, torch.as_tensor(prompts,
                                                            device=dev),
                                  block, MAX_LEN, extras=extras)
    none = family_twin(eng, B, dev, drafter_mode="none", K=0)
    W = P + off + NEW
    toks = {}
    for name, e in (("none", none), ("parallel", eng),
                    ("ar", family_twin(eng, B, dev, drafter_mode="ar"))):
        r = e.run(prompts, extras)
        toks[name] = r["tokens"][:, :W]
        log(f"  {name:8s} steps {r['steps']:3d} AL "
            f"{r['acceptance_length']:.3f}")
    out = {"kernels_vs_plain_logits": errs}
    for mode in ("parallel", "ar"):
        out[f"{mode}_vs_none_parted_rows"] = near_ties(
            none, toks[mode], toks["none"], P + off, f"{tag} {mode}", dev,
            extras=extras)
    served = {}
    for layout in ("contiguous", "paged"):
        e = family_twin(eng, B, dev, kv_layout=layout, page_size=16,
                        pool_pages=POOL if layout == "paged" else 0)
        rep = Scheduler(e).serve([
            Request(p, max_new_tokens=NEW,
                    extras={k: v[i:i + 1] for k, v in extras.items()})
            for i, p in enumerate(prompts)])
        gen = np.stack([x["tokens"] for x in rep["results"]])
        served[layout] = np.concatenate(
            [np.zeros((B, off), np.int32), prompts, gen], 1)
        log(f"  Scheduler.serve {layout}: iterations {rep['iterations']}, "
            f"preemptions {rep['preemptions']} (resumed requests "
            f"{[x['rid'] for x in rep['results'] if x['n_preempt']]})")
        if layout == "paged" and not (rep["preemptions"] > 0
                                      and e.allocator.n_used == 0):
            fail(f"{tag} paged serve: {rep['preemptions']} preemptions, "
                 f"{e.allocator.n_used} pages left allocated")
        del e
    out["paged_vs_contiguous_parted_rows"] = near_ties(
        none, served["paged"], served["contiguous"], P + off,
        f"{tag} paged (resumed) vs contiguous serve", dev, extras=extras)
    out["contiguous_vs_none_parted_rows"] = near_ties(
        none, served["contiguous"], toks["none"], P + off,
        f"{tag} contiguous serve vs none", dev, extras=extras)
    del eng, none
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sharded_path(ops, dev):
    """Phase 13: storage-sharded serving and training on a one-rank nccl
    group (``EngineConfig(shard_model=True)``: weights and K/V rest as
    slices, gathered a layer at a time before use; a one-rank mesh gathers
    and writes slices all the same). Full-width qwen2-1.5b on 4 of its 28
    layers in bfloat16 with the 4-layer drafter, the sharded engine built
    by ``build_engine(shard_model=True)``, leaf by leaf: its slices bitwise
    ``shard_tree`` of the unsharded build's draw, both builds' peak card
    memory logged; then (a) Engine.run, batch 8,
    512-token prompts, 64 new, K 5, contiguous: tokens and the gathered
    state bitwise the unsharded engine's on the same weights, decode and
    flash launches equal; (b) Scheduler.serve over paged KV (phase 3b's
    256-page pool) with swap to host of its first 12 requests: every stream
    equal to the unsharded serve's, at least one swap, paged launches
    equal; (c) one ``build_train_step`` step on a (data 1, model 1) mesh,
    float32, n 2048: loss and updated drafter weights within atol 2e-5
    rtol 2e-4 of the unsharded step, the MTP kernel launched; (d)
    AsyncEngine over the sharded paged engine, rank 0 deciding and
    broadcasting a record a pass (``Mesh.broadcast``), on 3b's first 8
    prompts at 48-token budgets, odd requests sampled, all submitted
    before the first pass: every stream equal to the unsharded
    AsyncEngine's, the records counted."""
    import asyncio
    import dataclasses
    import torch.distributed as dist
    from repro_torch.core import cod
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.launch.steps import build_train_step, shard_train_inputs
    from repro_torch.optim import adamw_init
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.scheduler import Request, Scheduler
    from repro_torch.serving.streaming import AsyncEngine
    from repro_torch.sharding import utils as SH
    from repro_torch.sharding.rules import serve_param_specs
    from repro_torch.tree import leaves, leaves_with_paths
    B, P, NEW, K, MAX_LEN, PAGE, POOL = 8, 512, 64, 5, 1024, 16, 256
    LAYERS = SHARDED_LAYERS
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    log(f"phase 13: storage-sharded serving and training on a one-rank nccl "
        f"group; full-width qwen2-1.5b bfloat16 on {LAYERS} of 28 layers, "
        f"4-layer drafter, batch {B}, prompt {P}, max_new {NEW}, K {K}")
    free_card(dev, "phase 13")
    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0,
                            world_size=1)
    out = {"card": card}
    try:
        mesh = SH.serving_mesh()

        def sharded(eng, **kw):
            ecfg = dataclasses.replace(eng.ecfg, shard_model=True, mesh=mesh,
                                       **kw)
            return Engine(eng.tcfg, eng.dcfg, eng.tparams, eng.dparams, ecfg,
                          eng.batch, device=dev)

        def resident(e):
            return sum(t.local.numel() * t.local.element_size()
                       if isinstance(t, SH.Shard) else
                       t.numel() * t.element_size()
                       for t in leaves(e.tparams) + leaves(e.dparams))

        # the leaf-by-leaf build against the whole draw
        peaks, built = {}, {}
        for name, shard_model in (("unsharded", False), ("leafwise", True)):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            built[name] = build_engine(mode="parallel", K=K, max_new=NEW,
                                       max_len=MAX_LEN, batch=B, seed=0,
                                       device=dev, n_layers=LAYERS,
                                       shard_model=shard_model)
            torch.cuda.synchronize()
            peaks[name] = dict(
                held_gb=(torch.cuda.memory_allocated(dev) - before) / 1e9,
                peak_gb=(torch.cuda.max_memory_allocated(dev) - before) / 1e9)
        e0, e1 = built["unsharded"], built["leafwise"]
        del built
        n_shards = 0
        for tree, cut in ((e0.tparams, e1.tparams), (e0.dparams, e1.dparams)):
            want = SH.shard_tree(tree, serve_param_specs(tree, e1.mesh),
                                 e1.mesh)
            for (path, a), (_, b) in zip(leaves_with_paths(cut),
                                         leaves_with_paths(want)):
                if type(a) is not type(b):
                    fail(f"phase 13: leaf {path} is a {type(a).__name__}, "
                         f"the whole draw's cut a {type(b).__name__}")
                if isinstance(a, SH.Shard):
                    n_shards += 1
                    if a.spec != b.spec:
                        fail(f"phase 13: leaf {path} cut by {a.spec}, the "
                             f"whole draw's by {b.spec}")
                    a, b = a.local, b.local
                if not torch.equal(a, b):
                    fail(f"phase 13: leaf {path} drawn leaf by leaf differs "
                         f"from the whole draw's")
            del want
        out["build"] = dict(peaks, shards=n_shards)
        log(f"  13 build: {n_shards} slices bitwise the whole draw's; "
            f"unsharded holds {peaks['unsharded']['held_gb']:.3f} GB, peak "
            f"{peaks['unsharded']['peak_gb']:.3f}; leaf by leaf holds "
            f"{peaks['leafwise']['held_gb']:.3f} GB, peak "
            f"{peaks['leafwise']['peak_gb']:.3f} (one rank: its slices are "
            f"the whole model) ({card})")

        # (a) Engine.run
        prompts = random_prompts(e0.tcfg.vocab_size, B, P, seed=0)
        runs, counts = {}, {}
        for name, e in (("unsharded", e0), ("sharded", e1)):
            e.run(prompts, max_iters=4)                   # cold
            ops.reset_launches()
            SH.reset_counters()
            runs[name] = e.run(prompts)
            counts[name] = dict(ops.launches)
            if name == "sharded":
                gathers = SH.counters()
        r0, r1 = runs["unsharded"], runs["sharded"]
        if not np.array_equal(r0["tokens"], r1["tokens"]):
            fail("phase 13a: sharded Engine.run tokens differ from unsharded")
        full = e1.full_state(r1["state"])
        for (path, a), (_, b) in zip(leaves_with_paths(full),
                                     leaves_with_paths(r0["state"])):
            if isinstance(a, torch.Tensor) and not torch.equal(a, b):
                fail(f"phase 13a: gathered state leaf {path} differs")
        if counts["sharded"] != counts["unsharded"]:
            fail(f"phase 13a: launches {counts['sharded']} != unsharded "
                 f"{counts['unsharded']}")
        for k in ("decode_attention", "flash_attention"):
            if not counts["sharded"][k] > 0:
                fail(f"phase 13a: {k} was not launched")
        steps = r1["steps"]
        ag = gathers["all_gather"]
        ms = {n: r["decode_s"] / r["steps"] * 1e3 for n, r in runs.items()}
        kv1 = sum(t.numel() * t.element_size() for p, t in
                  leaves_with_paths(r1["state"])
                  if p.rsplit("/", 1)[-1] in ("k", "v")
                  and isinstance(t, torch.Tensor) and t.dim() >= 4)
        out["run"] = dict(
            steps=steps, ms_per_step=ms, launches=counts["sharded"],
            gather_calls_per_step=ag["calls"] / (steps + 1),
            gather_bytes_per_step=ag["bytes"] / (steps + 1),
            use_max_bytes=gathers["use"]["max_bytes"],
            resident_weight_bytes=resident(e1), resident_kv_bytes=kv1,
            acceptance_length=r1["acceptance_length"])
        log(f"  13a Engine.run: {steps} steps, tokens and gathered state "
            f"bitwise the unsharded engine's; ms/step sharded "
            f"{ms['sharded']:.2f} unsharded {ms['unsharded']:.2f}; gathers "
            f"{ag['calls'] / (steps + 1):.1f} calls and "
            f"{ag['bytes'] / (steps + 1) / 1e9:.4f} GB a step (prefill "
            f"included), largest use() {gathers['use']['max_bytes'] / 1e6:.1f}"
            f" MB; resident per rank: weights {resident(e1) / 1e9:.3f} GB, "
            f"K/V {kv1 / 1e9:.3f} GB; launches {counts['sharded']} ({card})")
        del runs, r0, r1, full, e1

        # (b) Scheduler.serve, paged, swap to host
        p0 = family_twin(e0, B, dev, kv_layout="paged", page_size=PAGE,
                         pool_pages=POOL, max_new_tokens=192, swap="host")
        p1 = sharded(p0)
        del e0
        traffic = sched3b_traffic(p0.tcfg.vocab_size, 12)
        reps, counts = {}, {}
        for name, e in (("unsharded", p0), ("sharded", p1)):
            ops.reset_launches()
            reps[name] = Scheduler(e, sync_every=1).serve(
                [Request(p, max_new_tokens=b, arrival_time=a)
                 for p, b, a in zip(*traffic)])
            counts[name] = dict(ops.launches)
        s0, s1 = reps["unsharded"], reps["sharded"]
        for a, b in zip(s0["results"], s1["results"]):
            if not np.array_equal(a["tokens"], b["tokens"]):
                fail(f"phase 13b: request {a['rid']} differs sharded")
        if not s1["preempt_swap"] > 0:
            fail("phase 13b: no request was swapped to the host")
        if counts["sharded"] != counts["unsharded"] or not \
                counts["sharded"]["paged_decode_attention"] > 0:
            fail(f"phase 13b: launches {counts}")
        it = {n: r["iterations"] for n, r in reps.items()}
        msi = {n: r["wall_s"] / r["iterations"] * 1e3 for n, r in reps.items()}
        out["serve"] = dict(iterations=it["sharded"], ms_per_iteration=msi,
                            preempt_swap=s1["preempt_swap"],
                            preempt_recompute=s1["preempt_recompute"],
                            host_peak_bytes={n: r["host_pool"]["peak_bytes"]
                                             for n, r in reps.items()},
                            launches=counts["sharded"])
        log(f"  13b Scheduler.serve: 12 requests, {it['sharded']} iterations, "
            f"streams equal; swaps {s1['preempt_swap']}, recompute "
            f"{s1['preempt_recompute']}; ms/iteration sharded "
            f"{msi['sharded']:.2f} unsharded {msi['unsharded']:.2f}; launches "
            f"{counts['sharded']} ({card})")
        del reps

        # (d) AsyncEngine, rank 0 deciding, against the unsharded one
        work = [(p, None if i % 2 == 0 else SamplingParams(
            temperature=0.8, top_k=50, seed=70 + i), 48)
            for i, p in enumerate(traffic[0][:8])]

        async def stream(eng):
            aeng = AsyncEngine(eng)
            handles = [await aeng.submit(p, sp, max_new_tokens=b)
                       for p, sp, b in work]

            async def drain(h):
                return [t async for t, _ in h]
            got = await asyncio.gather(*(drain(h) for h in handles))
            return got, await aeng.close(), aeng.records
        streams = {}
        for name, e in (("unsharded", p0), ("sharded", p1)):
            ops.reset_launches()
            SH.reset_counters()
            t0 = time.perf_counter()
            streams[name] = asyncio.run(asyncio.wait_for(stream(e), 300))
            wall = time.perf_counter() - t0
            counts[name] = dict(ops.launches)
            if name == "sharded":
                bc = SH.counters().get("broadcast", {"calls": 0, "bytes": 0})
        (g0, r0, _), (g1, r1, records) = (streams["unsharded"],
                                          streams["sharded"])
        for i, (a, b) in enumerate(zip(g0, g1)):
            if a != b:
                fail(f"phase 13d: stream {i} differs sharded")
        if not (bc["calls"] == records and records >= r1["iterations"] + 1):
            fail(f"phase 13d: {bc['calls']} broadcasts counted for {records} "
                 f"records over {r1['iterations']} iterations")
        if not counts["sharded"]["paged_decode_attention"] > 0:
            fail(f"phase 13d: launches {counts['sharded']}")
        out["async"] = dict(iterations=r1["iterations"], records=records,
                            records_per_iteration=records / r1["iterations"],
                            record_bytes=bc["bytes"] / max(records, 1),
                            wall_s=wall, preempt_swap=r1["preempt_swap"],
                            launches=counts["sharded"])
        log(f"  13d AsyncEngine: 8 streams (4 sampled) equal to the unsharded "
            f"engine's; {r1['iterations']} iterations, {records} records "
            f"broadcast ({records / r1['iterations']:.3f} an iteration, "
            f"{bc['bytes'] / max(records, 1):.0f} B each), {wall:.1f} s, "
            f"swaps {r1['preempt_swap']} ({card})")
        del p0, p1, streams
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the drafter train step, data 1 x model 1, float32, n 2048
        from repro_torch.configs import DrafterConfig, get_config
        from repro_torch.core import drafter as D
        from repro_torch.models.registry import get_model
        tcfg = get_config("qwen2-1.5b").replace(dtype="float32",
                                                 n_layers=LAYERS)
        dcfg = DrafterConfig().resolve(tcfg)
        g = torch.Generator(device=dev).manual_seed(0)
        tp = get_model(tcfg, dev).init(g, device=dev)
        dp = D.init_params(dcfg, tcfg, g, device=dev)
        n, rng = 2048, np.random.default_rng(0)
        tokens = torch.as_tensor(rng.integers(0, tcfg.vocab_size - 1, (1, n))
                                 .astype(np.int32), device=dev)
        M = cod.expanded_length(n, dcfg.k_train, dcfg.cod_rate)
        pos, depth = cod.pad_to(*cod.sample_cod(rng, n, dcfg.k_train,
                                                dcfg.cod_rate), M)
        tgt = pos + 2
        lab = np.where(((pos >= 0) & (tgt < n))[None],
                       tokens.cpu().numpy()[:, np.clip(tgt, 0, n - 1)], -1)
        pos_t = torch.as_tensor(pos.astype(np.int32), device=dev)
        dep_t = torch.as_tensor(depth.astype(np.int32), device=dev)
        lab_t = torch.as_tensor(lab.astype(np.int32), device=dev)
        rngk = torch.zeros(2, dtype=torch.int64, device=dev)
        fn, _ = build_train_step(tcfg, dcfg, "train_4k", n_micro=1)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_d, _, ref_m = fn(tp, dp, adamw_init(dp), tokens, pos_t, dep_t,
                             lab_t, rngk, {})
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t0
        ref_d = {p: t.detach().clone() for p, t in leaves_with_paths(ref_d)}
        mtp_ref = ops.launches["mtp_attention"]
        tmesh = make_debug_mesh(1, 1)
        tps, dps, opt, toks, labs, ex = shard_train_inputs(
            tmesh, tp, dp, tokens, lab_t)
        del tp
        ops.reset_launches()
        SH.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with SH.mesh_scope(tmesh):
            new_d, _, met = fn(tps, dps, opt, toks, pos_t, dep_t, labs, rngk,
                               ex)
            torch.cuda.synchronize()
            t_sh = time.perf_counter() - t0
            full_d = SH.full_tree(new_d)
        mtp = ops.launches["mtp_attention"]
        tc = SH.counters()
        if not mtp > 0 or mtp != mtp_ref:
            fail(f"phase 13c: mtp_attention launches {mtp} (unsharded "
                 f"{mtp_ref})")
        dl = abs(float(met["loss"]) - float(ref_m["loss"]))
        if not dl <= 2e-5 + 2e-4 * abs(float(ref_m["loss"])):
            fail(f"phase 13c: loss {float(met['loss'])} vs "
                 f"{float(ref_m['loss'])}")
        worst = 0.0
        for p, a in leaves_with_paths(full_d):
            b = ref_d[p]
            err = float((a.float() - b.float()).abs().max())
            worst = max(worst, err)
            if not torch.allclose(a, b, atol=2e-5, rtol=2e-4):
                fail(f"phase 13c: updated weight {p} differs by {err}")
        out["train"] = dict(loss=float(met["loss"]), loss_diff=dl,
                            weights_max_abs_diff=worst,
                            mtp_launches=mtp, step_s={"sharded": t_sh,
                                                      "unsharded": t_ref},
                            collectives={k: v for k, v in tc.items()
                                         if k != "use"})
        log(f"  13c train step: loss {float(met['loss']):.6f} (|diff| {dl:.3g}"
            f"), updated weights within {worst:.3g}, mtp launches {mtp}, "
            f"step {t_sh * 1e3:.1f} ms sharded, {t_ref * 1e3:.1f} ms "
            f"unsharded (the first, cold), gathers "
            f"{tc['all_gather']['calls']} / "
            f"{tc['all_gather']['bytes'] / 1e9:.3f} GB, reduces "
            f"{tc['all_reduce']['calls']} ({card})")
        del tps, dps, opt, new_d, full_d, ref_d
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def llama4_path(ops, dev):
    """Phase 14: llama4-maverick at full width in bfloat16 on one card,
    its depth cut to LLAMA4_LAYERS (layer 1's MoE: 128 experts of d_ff
    8192, top-1, capacity factor 1.25, beside the shared expert; attention
    40/8 heads of 128 with its local window 8192, the drafter's 40/40):
    Engine.run at phase 3's shapes, the routing of a prefill and a verify
    (``moe_probe``), Scheduler.serve of phase 3b's first 12 requests over
    paged KV with swap to host, then greedy parallel and ar against none
    at capacity factor 128 (no slot dropped: rows do not interact) under
    the bfloat16 near-tie rules (BF16_NEAR_TIE, BF16_ROUTER_NEAR_TIE)."""
    import dataclasses
    from repro_torch.configs import DrafterConfig, get_config
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.serving.engine import Engine
    B, P, NEW, K, MAX_LEN, PAGE, POOL, N = 8, 512, 128, 5, 1024, 16, 256, 12
    tcfg = get_config(LLAMA4).replace(n_layers=LLAMA4_LAYERS)
    dcfg = DrafterConfig().resolve(tcfg)
    m = tcfg.moe
    n_moe = sum(tcfg.is_moe_layer(li) for li in range(tcfg.n_layers))
    log(f"phase 14: full-width llama4-maverick bfloat16 ({LLAMA4_LAYERS} of "
        f"48 layers: {[tcfg.attn_kind(li) for li in range(tcfg.n_layers)]}, "
        f"MoE {[tcfg.is_moe_layer(li) for li in range(tcfg.n_layers)]}; d "
        f"{tcfg.d_model}, {tcfg.n_heads}/{tcfg.n_kv_heads} heads of "
        f"{tcfg.head_dim}, window {tcfg.window_size}, {m.n_experts} experts "
        f"top-{m.top_k} of d_ff {tcfg.d_ff} and {m.n_shared_experts} shared, "
        f"capacity factor {m.capacity_factor}, vocab {tcfg.vocab_size}, "
        f"untied head), 4-layer parallel drafter (d {dcfg.d_model}, "
        f"{dcfg.n_heads}/{dcfg.n_kv_heads} heads of {dcfg.head_dim}, d_ff "
        f"{dcfg.d_ff}), batch {B}, prompt {P}, max_new {NEW}, K {K}, "
        f"max_len {MAX_LEN}")
    free_card(dev, "phase 14")
    plan = memory_plan(tcfg, dcfg, B, MAX_LEN, 2)
    log("  memory plan: " + ", ".join(f"{k} {v:.2f}" for k, v in plan.items()))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = build_engine(arch=LLAMA4, n_layers=LLAMA4_LAYERS, mode="parallel",
                       K=K, max_new=NEW, max_len=MAX_LEN, batch=B, seed=0,
                       device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    build_peak = torch.cuda.max_memory_allocated(dev)
    log(f"  weights built in {time.perf_counter() - t0:.1f} s: "
        f"{held / 1e9:.2f} GB allocated, peak {build_peak / 1e9:.2f} GB")
    prompts = random_prompts(eng.tcfg.vocab_size, B, P, seed=0)
    run = family_run(ops, dev, eng, prompts, NEW, K, "14")
    run.update(memory_plan=plan, weights_gb=held / 1e9,
               build_peak_gb=build_peak / 1e9)
    with moe_probe() as probe, torch.no_grad():
        state = eng.prefill(prompts)
        n_pre = len(probe)
        state = eager_steps(eng, state, 1)
    del state
    pre, ver = probe[:n_pre], probe[n_pre:]
    if not ([r["shape"] for r in pre] == [(B, P)] * n_moe
            and [r["shape"] for r in ver] == [(B, K + 1)] * n_moe):
        fail(f"phase 14 MoE calls {[r['shape'] for r in probe]}: want "
             f"{n_moe} at ({B}, {P}) then {n_moe} at ({B}, {K + 1})")
    run.update(prefill_drop_frac=float(np.mean([r["drop_frac"] for r in pre])),
               verify_drop_frac=float(np.mean([r["drop_frac"] for r in ver])),
               router_min_margin=min(r["margin"] for r in probe))
    log(f"  routing: drop_frac {run['prefill_drop_frac']:.4f} at the prefill "
        f"({B} x {P} tokens, capacity "
        f"{int((B * P * m.top_k) / m.n_experts * m.capacity_factor) + 1}), "
        f"{run['verify_drop_frac']:.4f} at a verify ({B} x {K + 1}, capacity "
        f"{int((B * (K + 1) * m.top_k) / m.n_experts * m.capacity_factor) + 1}"
        f"); smallest router top-{m.top_k} margin "
        f"{run['router_min_margin']:.3e}")
    log(f"  Scheduler.serve: paged, page {PAGE}, pool {POOL} pages, swap to "
        f"host, incremental growth; phase 3b's first {N} requests")
    peng = family_twin(eng, B, dev, kv_layout="paged", page_size=PAGE,
                       pool_pages=POOL, max_new_tokens=192, swap="host")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    serve = family_serve(ops, dev, peng,
                         sched3b_traffic(peng.tcfg.vocab_size, N), "14")
    if not serve["preempt_swap"] > 0:
        fail("phase 14 serve: no request was swapped to the host")
    # capacity factor 128: every slot kept, so a row's tokens depend on the
    # row alone; bfloat16 runs of other shapes part only at near ties
    Bn, Pn, NEWn, MAXn = 4, 128, 32, 256
    tcfg128 = peng.tcfg.replace(moe=dataclasses.replace(
        peng.tcfg.moe, capacity_factor=128.0))
    prompts = random_prompts(peng.tcfg.vocab_size, Bn, Pn, seed=1)
    runs, probes, out = {}, {}, {}
    for mode in ("none", "parallel", "ar"):
        use_d = mode != "none"
        e = Engine(tcfg128, peng.dcfg if use_d else None, peng.tparams,
                   peng.dparams if use_d else None, dataclasses.replace(
                       peng.ecfg, kv_layout="contiguous", swap="none",
                       drafter_mode=mode, K=K if use_d else 0,
                       max_new_tokens=NEWn, max_len=MAXn), Bn, device=dev)
        with moe_probe() as probe, eager_verify(e):
            r = e.run(prompts)
        runs[mode], probes[mode] = r["tokens"][:, :Pn + NEWn], probe
        dropped = max(x["drop_frac"] for x in probe)
        log(f"  capacity factor 128, {mode:8s} steps {r['steps']:3d}, "
            f"largest drop_frac {dropped}, smallest router margin "
            f"{min(x['margin'] for x in probe):.3e}")
        if dropped != 0.0:
            fail(f"phase 14 {mode} at capacity factor 128 dropped slots")
        if mode == "none":
            ref_eng = e
        del e
    for mode in ("parallel", "ar"):
        out[f"{mode}_vs_none_parted_rows"] = moe_streams_agree(
            ref_eng, runs[mode], runs["none"], Pn,
            f"14 capacity 128 {mode} vs none", dev,
            (probes[mode], probes["none"]), coupled=False,
            tie=BF16_NEAR_TIE, router_tie=BF16_ROUTER_NEAR_TIE)
    del peng, ref_eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"run": run, "serve": serve, "no_drops": out}


# ---------------------------------------------------------------------------
# phase 15: trained drafters from their checkpoints
# ---------------------------------------------------------------------------

# phase 15's target: qwen2-1.5b at full width in bfloat16, cut to 7 of its
# 28 layers on both the training and the serving side, for time
TRAINED_TARGET_LAYERS = 7
# its drafters: 4 layers at full width, trained through the training
# launcher on the target's own greedy rollouts (128 tokens) of 16 random
# 4-token prompts, 40 steps of batch 8 at lr 3e-3
TRAINED_LAYERS = 4
TRAINED_CORPUS = dict(seed=1, n_seqs=16, batch=16)   # self_generated_corpus
TRAINED_ARGS = ["--data", "self", "--seq-len", "128",
                "--n-seqs", str(TRAINED_CORPUS["n_seqs"]), "--batch", "8",
                "--epochs", "20", "--lr", "3e-3",
                "--layers", str(TRAINED_LAYERS),
                "--n-layers", str(TRAINED_TARGET_LAYERS)]
# the target the launcher trains against, as its report names it
TRAINED_TARGET = {"arch": "qwen2-1.5b", "seed": 0, "dtype": "bfloat16",
                  "n_layers": TRAINED_TARGET_LAYERS}
# its serving traffic: 12 requests, the corpus's first 12 prompts (on
# unseen prompts a drafter trained on a random target's rollouts accepts
# nothing), budgets of 60 (positions within the trained 128), Exp(1)
# virtual gaps, 8 slots over paged KV (page 16, 5 pages a row, 40 in the
# pool), served once
TRAINED_REQUESTS = 12
TRAINED_SERVE_ARGS = ["--max-new", "60", "--requests",
                      str(TRAINED_REQUESTS), "--mean-gap", "1",
                      "--batch", "8", "--max-len", "80",
                      "--kv-layout", "paged", "--page-size", "16", "--k", "5",
                      "--layers", str(TRAINED_LAYERS),
                      "--n-layers", str(TRAINED_TARGET_LAYERS), "--runs", "1"]


@contextlib.contextmanager
def served_reports(k_rows=None):
    """Records each ``Scheduler.serve`` call's (scheduler, report) while
    the block runs (the launcher keeps its scheduler to itself) and, into
    ``k_rows``, the draft cap of every live row each dispatched iteration;
    the class's methods are restored on exit."""
    from repro_torch.serving.scheduler import Scheduler
    serve, dispatch = Scheduler.serve, Scheduler._dispatch
    seen = []

    def serve_and_keep(self, *a, **kw):
        rep = serve(self, *a, **kw)
        seen.append((self, rep))
        return rep

    def dispatch_and_count(self, run):
        if k_rows is not None:
            for k in self._k_row[run].tolist():
                k_rows[k] = k_rows.get(k, 0) + 1
        return dispatch(self, run)
    Scheduler.serve, Scheduler._dispatch = serve_and_keep, dispatch_and_count
    try:
        yield seen
    finally:
        Scheduler.serve, Scheduler._dispatch = serve, dispatch


def trained_launches_want(mode, cfg, n_d, K, iterations, admissions):
    """Attention launches of a paged serve (phase 3b's formula, by mode):
    each iteration's paged phase-1 and decode phase-2 launches, the
    target's n_layers plus the drafter's (parallel: its draft and extend;
    ar: K single-slot forwards and the extend); an admission's flash
    prefill of the target and, with a drafter, its extend in two phases."""
    per = cfg.n_layers + {"none": 0, "parallel": 2 * n_d,
                          "ar": (K + 1) * n_d}[mode]
    return {"paged_decode_attention": iterations * per,
            "decode_attention": iterations * per
            + (admissions * 2 * n_d if mode != "none" else 0),
            "flash_attention": admissions * cfg.n_layers, "mtp_attention": 0}


def loaded_leaves_equal(dev, eng, path, what):
    """The drafter ``eng`` serves equals, leaf for leaf and bitwise, the
    trained float32 leaves of its checkpoint ``path`` after one cast to the
    leaf's serving dtype (bfloat16 weights, float32 norms)."""
    from repro_torch.tree import leaves_with_paths
    n = 0
    with np.load(path) as data:
        for key, t in leaves_with_paths(eng.dparams):
            arr = data[key]
            want = torch.from_numpy(arr).to(device=dev, dtype=t.dtype)
            if arr.dtype != np.float32 or not torch.equal(t, want):
                fail(f"{what}: loaded leaf {key} is not the trained one "
                     f"cast to {t.dtype}")
            n += 1
    return n


def trained_path(ops, dev):
    """Phase 15: the trained drafter from checkpoint to the card. Trains
    the P-EAGLE drafter and the AR EAGLE-3 drafter (``--ar-baseline``),
    4 layers each, against full-width qwen2-1.5b in bfloat16 (seed 0, 7
    of 28 layers) through ``launch.train.main`` (self-generated corpus:
    the MTP kernel in training, flash for the target's taps), each into
    its own checkpoint; then serves the corpus's first 12 prompts through
    ``launch.serve.main`` five ways: none, ar and parallel from their
    checkpoints, parallel with adaptive K, and parallel with a random
    drafter (a directory with no checkpoint); and the trained parallel
    drafter once more on 12 unseen random prompts. Checks: the served
    leaves are the trained ones cast to bfloat16; ar and parallel streams
    equal none's under BF16_NEAR_TIE; the trained parallel drafter's AL
    above the random control's; each serve's launches by
    ``trained_launches_want``."""
    from repro_torch.configs import get_config
    from repro_torch.data import corpus_prompts
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    free_card(dev, "phase 15")
    log(f"phase 15: trained drafters ({TRAINED_LAYERS} layers, float32) "
        f"against full-width qwen2-1.5b bfloat16 on "
        f"{TRAINED_TARGET['n_layers']} layers, seed 0: "
        f"{' '.join(TRAINED_ARGS)}; served {' '.join(TRAINED_SERVE_ARGS)}")
    out = {"train": {}, "serve": {}}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {"parallel": f"{tmp}/parallel", "ar": f"{tmp}/ar",
                "random": f"{tmp}/none"}
        for kind, extra in (("parallel", []), ("ar", ["--ar-baseline"])):
            ops.reset_launches()
            t0 = time.perf_counter()
            rep = train_launch.main(TRAINED_ARGS + extra
                                    + ["--ckpt", dirs[kind]])
            counts = dict(ops.launches)
            rep.update(seconds=time.perf_counter() - t0, launches=counts)
            out["train"][kind] = rep
            log(f"  trained {kind}: {rep['steps']} steps, loss "
                f"{rep['loss']:.4f}, {rep['s_per_step']:.3f} s/step, "
                f"{rep['label_tokens_per_s']:.0f} label tokens/s, peak "
                f"{rep['peak_memory_gb']} GB, {rep['seconds']:.1f} s "
                f"with the corpus; launches {counts}")
            if not math.isfinite(rep["loss"]) or counts["mtp_attention"] == 0:
                fail(f"phase 15 {kind} training: loss {rep['loss']}, "
                     f"launches {counts}")
            if rep["target"] != TRAINED_TARGET:
                fail(f"phase 15 trained against {rep['target']}")
            gc.collect()
            torch.cuda.empty_cache()
        # the corpus's first prompts: the training launcher's rollouts open
        # with them
        prompts = corpus_prompts(get_config(TRAINED_TARGET["arch"]).vocab_size,
                                 **TRAINED_CORPUS)[:TRAINED_REQUESTS]
        seen_prompts = f"{tmp}/prompts.npy"
        np.save(seen_prompts, prompts)
        ways = (("none", "none", dirs["random"], []),
                ("ar", "ar", dirs["ar"], []),
                ("parallel", "parallel", dirs["parallel"], []),
                ("parallel adaptive-K", "parallel", dirs["parallel"],
                 ["--adaptive-k"]),
                ("parallel random drafter", "parallel", dirs["random"], []),
                ("parallel unseen prompts", "parallel", dirs["parallel"],
                 ["--prompt-len", "4"]))
        streams, ref_eng, k_rows = {}, None, {}
        for way, mode, ckpt, extra in ways:
            unseen = way == "parallel unseen prompts"
            ops.reset_launches()
            adaptive = "--adaptive-k" in extra
            t0 = time.perf_counter()
            with served_reports(k_rows if adaptive else None) as seen:
                rep = serve_launch.main(
                    TRAINED_SERVE_ARGS + extra + ["--mode", mode, "--ckpt",
                                                  ckpt]
                    + ([] if unseen else ["--prompts", seen_prompts]))
            counts = dict(ops.launches)
            rep["launcher_s"] = time.perf_counter() - t0
            sched, last = seen[-1]
            eng = sched.engine
            want_src = "random" if ckpt == dirs["random"] else "checkpoint"
            if mode != "none" and rep["drafter"]["source"] != want_src:
                fail(f"phase 15 {way} served a {rep['drafter']} drafter")
            if way in ("ar", "parallel"):
                rep["loaded_leaves"] = loaded_leaves_equal(
                    dev, eng, rep["drafter"]["path"], way)
            it = rep["iterations"]
            adm = rep["requests"] + rep["preemptions"]
            want = trained_launches_want(mode, eng.tcfg, TRAINED_LAYERS,
                                         eng.ecfg.K, it, adm)
            if counts != want:
                fail(f"phase 15 {way} launches {counts} != {want} "
                     f"({it} iterations, {adm} admissions)")
            rep.update(ms_per_iteration=rep["wall_s"] / it * 1e3,
                       launches=counts)
            out["serve"][way] = rep
            log(f"  {way:24s}: AL {rep['acceptance_length']:.4f}, OTPS "
                f"{rep['otps']:.1f}, {rep['ms_per_iteration']:.2f} ms/"
                f"iteration over {it}, peak pages {rep['peak_pages']}, "
                f"preemptions {rep['preemptions']}, new tokens "
                f"{rep['new_tokens']}, {rep['launcher_s']:.1f} s in the "
                f"launcher; drafter {rep['drafter']}; launches {counts}")
            if not unseen:
                res = sorted(last["results"], key=lambda r: r["rid"])
                streams[way] = np.stack([np.concatenate([p, r["tokens"]])
                                         for p, r in zip(prompts, res)])
            if mode == "none":
                ref_eng = eng
            del sched, eng, seen, last
            gc.collect()
            torch.cuda.empty_cache()
    tie = BF16_NEAR_TIE if ref_eng.tcfg.dtype == "bfloat16" else NEAR_TIE
    for way in ("ar", "parallel", "parallel adaptive-K",
                "parallel random drafter"):
        out["serve"][way]["parted_rows"] = near_ties(
            ref_eng, streams[way], streams["none"], prompts.shape[1],
            f"15 {way} vs none", dev, tie=tie)
    del ref_eng
    gc.collect()
    torch.cuda.empty_cache()
    sv = out["serve"]
    al = {way: r["acceptance_length"] for way, r in sv.items()}
    out["ratios"] = {
        "p_eagle_over_ar_eagle_otps": sv["parallel"]["otps"]
        / sv["ar"]["otps"],
        "parallel_over_none_otps": sv["parallel"]["otps"]
        / sv["none"]["otps"],
        "adaptive_over_parallel_otps": sv["parallel adaptive-K"]["otps"]
        / sv["parallel"]["otps"]}
    out["k_row_histogram"] = dict(sorted(k_rows.items()))
    log(f"  on {card_name()}: AL none {al['none']:.4f} / AR EAGLE-3 "
        f"{al['ar']:.4f} / P-EAGLE {al['parallel']:.4f} / P-EAGLE adaptive "
        f"K {al['parallel adaptive-K']:.4f} / random drafter "
        f"{al['parallel random drafter']:.4f} / P-EAGLE on unseen prompts "
        f"{al['parallel unseen prompts']:.4f}; OTPS P-EAGLE / AR-EAGLE "
        f"{out['ratios']['p_eagle_over_ar_eagle_otps']:.3f}, parallel / "
        f"none {out['ratios']['parallel_over_none_otps']:.3f}, adaptive / "
        f"fixed K {out['ratios']['adaptive_over_parallel_otps']:.3f}; k_row "
        f"histogram over live rows of each iteration (adaptive K) "
        f"{out['k_row_histogram']}")
    if not al["parallel"] > al["parallel random drafter"]:
        fail(f"phase 15: the trained P-EAGLE drafter's AL {al['parallel']} "
             f"is not above the random drafter's "
             f"{al['parallel random drafter']}")
    return out


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build, ops

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_name()
    log(card)
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = build.build()
    log(f"phase 1: built {sorted(built) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, report in build.ptxas_reports.items():
        keep = [ln.strip() for ln in report.splitlines()
                if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
        log(f"  -Xptxas -v {name}:\n    " + "\n    ".join(keep))

    kernels = run_phases(ops, dev)
    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(ops, dev) -> list:
    """Phases 2-15 on ``dev``; returns the kernels' JSON rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        what = " ".join([fn.__name__] + [x for x in a if isinstance(x, str)])
        log(f"({what}: {time.perf_counter() - t0:.1f} s)")
        return out

    worst, measured, fam_worst, pending = timed(check_kernels, ops, dev)
    path = timed(main_path, ops, dev)
    sched = timed(scheduler_path, ops, dev)
    greedy_ref = timed(losslessness, ops, dev)
    sampled = timed(sampled_path, ops, dev, path, sched, greedy_ref)
    policies = timed(policy_path, ops, dev, sched)
    policies["losslessness"] = timed(policy_losslessness, dev)
    front = timed(streaming_path, ops, dev, sched)
    front["losslessness"] = timed(streaming_losslessness, dev, greedy_ref)
    train = timed(training_path, ops, dev)
    gemma2 = timed(gemma2_path, ops, dev)
    gemma2["rings"] = timed(gemma2_rings, ops, dev)
    gemma2["rings_bf16"] = timed(gemma2_rings, ops, dev, "bfloat16")
    minitron = timed(minitron_path, ops, dev)
    gemma7b = timed(gemma7b_path, ops, dev)
    mamba2 = timed(mamba2_path, ops, dev)
    rgemma = timed(recurrentgemma_path, ops, dev)
    dbrx = timed(dbrx_path, ops, dev)
    internvl2 = timed(internvl2_path, ops, dev)
    whisper = timed(whisper_path, ops, dev)
    sharded = timed(sharded_path, ops, dev)
    llama4 = timed(llama4_path, ops, dev)
    trained = timed(trained_path, ops, dev)
    timed(flex_library, ops, dev, pending, measured)

    csrc = "src/repro_torch/kernels/csrc"
    sources = {name: f"{csrc}/{name}.cu" for name in (
        "decode_attention", "paged_decode_attention", "flash_attention")}
    replaces = {"decode_attention": "src/repro/kernels/decode_attention.py:73",
                "paged_decode_attention":
                    "src/repro/kernels/decode_attention.py:165",
                "flash_attention": "src/repro/kernels/flash_attention.py:79"}
    main_shape = {"decode_attention": "target verify phase 1",
                  "paged_decode_attention": "target verify phase 1",
                  "flash_attention": "target prefill"}
    # launches: the paged kernel's from the scheduler phase, the others'
    # from the whole-batch serving phase
    launches = dict(path["launches"],
                    paged_decode_attention=sched["launches"][
                        "paged_decode_attention"])
    # each kernel's gemma2-27b numbers: its launches in phase 6 (Engine.run
    # for decode and flash, Scheduler.serve for paged) and its time at
    # gemma2's main shape, softcap 50, beside flex_attention's
    g2_shape = {"decode_attention": "gemma2 target verify phase 1",
                "paged_decode_attention": "gemma2 target verify phase 1",
                "flash_attention": "gemma2 target prefill"}
    g2_launches = dict(gemma2["run"]["launches"],
                       paged_decode_attention=gemma2["serve"]["launches"][
                           "paged_decode_attention"])
    # gemma-7b's (head dim 256) the same way, from phase 7; mamba2's
    # drafter's launches from phase 8 (its target runs no attention)
    g7_shape = {"decode_attention": "gemma7b target verify phase 1",
                "paged_decode_attention": "gemma7b target verify phase 1",
                "flash_attention": "gemma7b target prefill"}
    g7_launches = dict(gemma7b["run"]["launches"],
                       paged_decode_attention=gemma7b["serve"]["launches"][
                           "paged_decode_attention"])
    m2_launches = dict(mamba2["run"]["launches"],
                       paged_decode_attention=mamba2["serve"]["launches"][
                           "paged_decode_attention"])
    # recurrentgemma-2b's from phase 9 (its 8 local layers and drafter),
    # at its MQA 10/1 shapes
    rg_shape = {"decode_attention": "rgemma target verify phase 1",
                "paged_decode_attention": "rgemma target verify phase 1",
                "flash_attention": "rgemma target prefill"}
    rg_launches = dict(rgemma["run"]["launches"],
                       paged_decode_attention=rgemma["serve"]["launches"][
                           "paged_decode_attention"])
    # dbrx-132b's from phase 10, at its 48/8 shapes
    db_shape = {"decode_attention": "dbrx target verify phase 1",
                "paged_decode_attention": "dbrx target verify phase 1",
                "flash_attention": "dbrx target prefill"}
    db_launches = dict(dbrx["run"]["launches"],
                       paged_decode_attention=dbrx["serve"]["launches"][
                           "paged_decode_attention"])
    # internvl2-1b's from phase 11 (14/2 heads of 64 over fused rows) and
    # whisper-base's from phase 12 (its encoder, its cross-attention through
    # the decode kernel and its paged self-attention)
    iv_shape = {"decode_attention": "internvl2 target verify phase 1",
                "paged_decode_attention": "internvl2 target verify phase 1",
                "flash_attention": "internvl2 target prefill"}
    iv_launches = dict(internvl2["run"]["launches"],
                       paged_decode_attention=internvl2["serve"]["launches"][
                           "paged_decode_attention"])
    wh_shape = {"decode_attention": "whisper cross verify decode",
                "paged_decode_attention": "whisper self verify phase 1",
                "flash_attention": "whisper encoder"}
    wh_launches = dict(whisper["run"]["launches"],
                       paged_decode_attention=whisper["serve"]["launches"][
                           "paged_decode_attention"])

    # llama4-maverick's from phase 14 (40/8 heads, window 8192; its
    # drafter 40/40)
    l4_shape = {"decode_attention": "llama4 target verify phase 1",
                "paged_decode_attention": "llama4 target verify phase 1",
                "flash_attention": "llama4 local prefill"}
    l4_launches = dict(llama4["run"]["launches"],
                       paged_decode_attention=llama4["serve"]["launches"][
                           "paged_decode_attention"])

    def family_row(shape, launches, fam, name):
        f = measured[(name, shape)]
        return {"shape": shape, "launches": launches,
                "max_abs_err": fam_worst[(fam, name)], "ms": f["ms"],
                "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
                "bound_by": f["bound_by"], "library_ms": f["library_ms"],
                "library": f.get("library", "scaled_dot_product_attention")}
    kernels = []
    for name in ("decode_attention", "paged_decode_attention",
                 "flash_attention"):
        m = measured[(name, main_shape[name])]
        g2 = measured[(name, g2_shape[name])]
        g7 = measured[(name, g7_shape[name])]
        rg = measured[(name, rg_shape[name])]
        db = measured[(name, db_shape[name])]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": worst[name], "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
            "library": m.get("library", "scaled_dot_product_attention"),
            "shape": main_shape[name],
            "gemma2": {"shape": g2_shape[name], "launches": g2_launches[name],
                       "max_abs_err": fam_worst[("gemma2", name)],
                       "ms": g2["ms"],
                       "plain_ms": g2["plain_ms"], "bound_ms": g2["bound_ms"],
                       "bound_by": g2["bound_by"],
                       "library_ms": g2["library_ms"],
                       "library": "flex_attention"},
            "gemma7b": {"shape": g7_shape[name], "head_dim": 256,
                        "launches": g7_launches[name],
                        "max_abs_err": fam_worst[("gemma7b", name)],
                        "ms": g7["ms"], "plain_ms": g7["plain_ms"],
                        "bound_ms": g7["bound_ms"],
                        "bound_by": g7["bound_by"],
                        "library_ms": g7["library_ms"],
                        "library": g7.get("library",
                                          "scaled_dot_product_attention")},
            "mamba2": {"launches": m2_launches[name]},
            "recurrentgemma": {"shape": rg_shape[name], "head_dim": 256,
                               "launches": rg_launches[name],
                               "max_abs_err": fam_worst[("rgemma", name)],
                               "ms": rg["ms"], "plain_ms": rg["plain_ms"],
                               "bound_ms": rg["bound_ms"],
                               "bound_by": rg["bound_by"],
                               "library_ms": rg["library_ms"],
                               "library": rg.get(
                                   "library", "scaled_dot_product_attention")},
            "dbrx": {"shape": db_shape[name], "launches": db_launches[name],
                     "max_abs_err": fam_worst[("dbrx", name)],
                     "ms": db["ms"], "plain_ms": db["plain_ms"],
                     "bound_ms": db["bound_ms"], "bound_by": db["bound_by"],
                     "library_ms": db["library_ms"],
                     "library": db.get("library",
                                       "scaled_dot_product_attention")},
            "internvl2": family_row(iv_shape[name], iv_launches[name],
                                    "internvl2", name),
            "whisper": family_row(wh_shape[name], wh_launches[name],
                                  "whisper", name),
            "llama4": family_row(l4_shape[name], l4_launches[name],
                                 "llama4", name)})
    # the MTP kernel: timed at the training shape in float32, the dtype the
    # training path gives it; launches over both training paths of phase 5
    mtp_shape = ("training shape n 2048 K 8 r 0.8", "float32")
    m = measured["mtp_attention"][mtp_shape]
    kernels.append({
        "name": "mtp_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mtp_attention.cu",
        "replaces": "src/repro/kernels/mtp_attention.py:77",
        "launches": sum(p["launches"]["mtp_attention"]
                        for p in train["paths"].values()),
        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        "shape": f"{mtp_shape[0]}, {mtp_shape[1]} (M {m['M']})"})
    log(f"serving: {json.dumps({k: v for k, v in path.items()})}")
    log(f"scheduler serving: {json.dumps(sched)}")
    log(f"sampled serving: {json.dumps(sampled)}")
    log(f"policies: {json.dumps(policies)}")
    log(f"front end: {json.dumps(front)}")
    log("decode_attention timing: " + json.dumps(
        {key[1]: v for key, v in measured.items()
         if key[0] == "decode_attention"}))
    log("paged_decode_attention timing: " + json.dumps(
        {key[1]: v for key, v in measured.items()
         if key[0] == "paged_decode_attention"}))
    log(f"training: {json.dumps(train)}")
    log(f"gemma2-27b: {json.dumps(gemma2)}")
    log(f"minitron-4b: {json.dumps(minitron)}")
    log(f"gemma-7b: {json.dumps(gemma7b)}")
    log(f"mamba2-780m: {json.dumps(mamba2)}")
    log(f"recurrentgemma-2b: {json.dumps(rgemma)}")
    log(f"dbrx-132b: {json.dumps(dbrx)}")
    log(f"internvl2-1b: {json.dumps(internvl2)}")
    log(f"whisper-base: {json.dumps(whisper)}")
    log(f"sharded (phase 13): {json.dumps(sharded)}")
    log(f"llama4-maverick (phase 14): {json.dumps(llama4)}")
    log(f"trained drafters (phase 15): {json.dumps(trained)}")
    log("gemma2, gemma7b, rgemma, dbrx, llama4, internvl2 and whisper kernel "
        "timing: " + json.dumps(
            {f"{k[0]} {k[1]}": v for k, v in measured.items()
             if isinstance(k, tuple)
             and k[1].startswith(("gemma2", "gemma7b", "rgemma", "dbrx",
                                  "llama4", "internvl2", "whisper"))}))
    log("mtp_attention timing: " + json.dumps(
        {f"{k[0]} {k[1]}": v for k, v in measured["mtp_attention"].items()}))
    return kernels


if __name__ == "__main__":
    sys.exit(main())
