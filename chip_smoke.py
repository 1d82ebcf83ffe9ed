"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one report line each (any failure exits non-zero):
  1. card + build: the card's name and power limit, torch/CUDA versions,
     and the build of every kernel from csrc/ (seconds), with matmul.cu's
     and flash_attention.cu's registers, spills and serialized-wgmma
     notices by path (ptxas -v); any spill or such notice in a flash
     tensor-core kernel (13: forward, dQ and dK/dV at hd 64, 96, 128 and
     256, and the group sum), or any spill in a sort kernel, fails the run;
     each tensor-core flash instantiation's shared memory, tiles,
     registers, local bytes (none) and CTAs an SM as the runtime reports
     them;
     wkv.cu's registers and spills by kernel (ptxas -v) and, for the
     training instantiations, threads, shared memory, registers, local
     bytes and CTAs an SM as the runtime reports them, written to
     chiprun_out/wkv_build.json; any spill in a WKV kernel fails the run;
     the fp32 FMA flash backward's registers and spills at hd 96 and 256
     (dQ and dK/dV; recorded, not gated), and no bf16 FMA flash kernel
     built above hd 32;
  2. each kernel against its plain PyTorch version at the shapes the main
     path gives it (tinyllama-1.1b serving, bf16), with the matmul path it
     took, timed with CUDA events with a cold L2 beside the plain version,
     one PyTorch library call and the card's bound; then the
     batch-invariance gate: on every matmul path, row i of a product of M
     rows equals that row multiplied alone, bit for bit;
  3. the paper's matmul domain: adaptive_matmul(use_kernel=True) at orders
     1024, 4096 and 8192 (path and TFLOP/s), with the CostEngine's
     decision; matmul_chain in fp32 against a left-to-right torch.matmul
     product;
  4. the paper's sort domain: the bitonic sort kernel, its plain version
     and torch.sort, exactly equal, at the paper's Table 3 sizes, the
     bench's, 2^26 fp32, 2^24 int32, (4096, 4096) and (8, 100), each timed
     beside its bound and its schedule's bound (passes x one read and one
     write), and one 2^26 call's device time, launches and HBM rate by
     launch kind (torch.profiler); the kernel bit for bit its plain
     version on hard inputs (NaN, +-inf, -0.0 beside +0.0, int32 extremes,
     sorted and reversed rows) across the tile boundary, one launch a
     pass; then distributed_sort(local_sort="kernel",
     measure=True) at n = 2000 and 2^26 (the sort's main path, its launch
     count read), with the ledger's predicted and measured rows;
  5. serving: Runtime(device="cuda").serve of full-width tinyllama-1.1b
     (random weights, seed 0), static and continuous, token identity, the
     kernel's launch count (by path), tok/s, host syncs per token, ledger
     rows; one decode step's matmul calls, each checked to run the path
     its dtypes name, profiled (matmul device ms by path, no library GEMM
     kernel), captured and replayed through the kernel,
     through the plain version and, where one torch.matmul computes the
     call, through it (held against each other, timed with
     torch.profiler), and one calibration of the hardware spec; phase
     5's trace again at 4 of the 22 layers (CUT_LAYERS), static and
     continuous, token-identical, its host syncs the whole model's: the
     anchor phases 15-17 hold their tokens and host syncs to;
  6. card against CPU in fp32: one batched prefill + 4 decode steps;
  7. flash: the flash-attention kernels, forward and backward, against
     their plain versions (and the forward against flash_attention_ref;
     bf16 outputs held against their own row's magnitude; kernel forward
     then kernel backward against the plain chain)
     at the training shape (2, 2048, 32, 4, 64) in bf16 and fp32, an
     awkward (3, 100, 8, 2, 64) in fp32, mistral-nemo's heads (32 / 8, hd
     128) in bf16 and a ragged MQA (3, 100, 8, 1, 64) in bf16, and the
     non-causal modes: seamless-m4t-medium's encoder self-attention at
     its training shape (2, 2048, 16, 16, 64) and ragged cross attentions
     (3, 100 queries, 160 keys, 8, 8, 64, and 160 queries, 100 keys),
     each in bf16 and fp32, and hd 96 and 256 (bf16 on the tensor cores,
     fp32 on the FMA kernels): phi3-mini's training shape (2, 2048, 32,
     32, 96), gemma-2b's (2, 2048, 8, 1, 256), recurrentgemma-2b's heads
     (2, 2048, 10, 1, 256) and a ragged (3, 100, 8, 2) at hd 96 and 256,
     in both types; each call on the path its dtype and hd name
     (flash_path, stated apart from choose_path; bf16: the wgmma kernels,
     no operand copied), the bf16 backward bit-identical on a second run,
     each timed (CUDA events, cold L2) beside the plain version,
     scaled_dot_product_attention (is_causal as the case) and the bound;
     and the copy loader at hd 96 and 256 (q strided, k at an odd pitch:
     four operands copied, hd 96's zero columns written by the producer)
     against the plain versions;
  8. train-parity: one make_train_step of full-width tinyllama-1.1b cut to
     2 layers, fp32, batch 2 x 128, on the card and on the CPU from the
     same parameters and batch: the loss within 1e-4 relative, every
     parameter's gradient present and within 2e-3 x max|grad| leaf by leaf;
  9. train: every distinct matmul call (shapes, strides, dtypes,
     epilogue) of one full-width bf16 gradient at batch 2 x 2048, cut to
     1 layer, held against the plain version on its own operands (the
     backward's transposed reads and bf16 x fp32 products among them),
     its path checked and timed beside torch.matmul (bf16 x bf16 only, a
     yardstick);
     Runtime(device="cuda")
     .train of full-width tinyllama-1.1b (22 layers, bf16, random
     weights, seed 0) for 4 steps at batch 2 x 2048 with a checkpoint,
     every loss finite, the kernels' launches per step (every flash call
     on the tensor-core path, no operand copied), tokens/s, peak memory,
     the plan; a 4-step run on one fixed batch whose loss must fall, with
     one step profiled (device busy share, device ms by kernel, matmul
     path and flash kernel, no library GEMM or attention kernel);
 10. wkv: the WKV kernels, forward and backward (every gradient), against
     their plain versions (with the kernels' sub-chunk factorization) at
     rwkv6-3b's training shape (2, 2048, 40, 64) with bf16 r/k/v and fp32
     logw made as the time mix makes them, the same shape in fp32, an
     awkward (3, 100, 5, 64) in fp32, that shape at logw = -50 and at heavy
     mixed decays (every output finite); the backward called twice with
     the same bits, the CUDA launches of each call by kernel; each timed
     (CUDA events, cold L2) beside the plain version and the bound, and at
     the bf16 training shape one forward and one backward profiled by
     kernel (state pass against the per-chunk kernel);
 11. rwkv card against CPU in fp32 (2 layers, full width): prefill logits
     (the WKV kernel) and token-by-token decode_step logits;
 12. rwkv serving: Runtime.serve of full-width rwkv6-3b, 8 of 32 layers
     (RWKV_SERVE_LAYERS), in bf16
     (random weights, seed 0; phase 5's trace cut to 16 new tokens a
     request, SHORT_NEW), static and continuous, token identity,
     tok/s, host syncs per token, the matmul kernel's launches by path,
     one decode step's routing checked and profiled by path;
 13. rwkv train-parity: one make_train_step of full-width rwkv6-3b cut to
     2 layers, fp32, batch 2 x 128, card against CPU: the loss within 1e-4
     relative, all 47 gradients present and within 2e-3 x max|grad|;
 14. rwkv train: Runtime.train of full-width, full-depth rwkv6-3b in bf16
     for 4 steps at batch 2 x 2048 (no checkpoint): every loss finite, the
     WKV kernels' calls per step (64 forward with the recomputation, 32
     backward; two CUDA launches each), step wall, tokens/s, peak memory,
     and one profiled step (device busy share, device ms by kernel, matmul
     path and WKV kernel, every call's routing checked, no library GEMM
     kernel);
 15. paged serving: Runtime.serve of full-width tinyllama-1.1b at 4 of its
     22 layers (CUT_LAYERS; bf16, seed 0) with paged=True, pages of 16 tokens: P1, phase 5's trace
     with K and the prefill chunk pinned, paged (default kv_blocks) beside
     dense and streamed: tokens equal phase 5's, host syncs equal the
     dense run's and the counts the engine made before it had the
     request lifecycle (10 host syncs, 54-55 synchronizing CUDA calls), the stream carries the outputs, the matmul kernel's
     launches counted from 0; the odd row, phase 5's trace at a max_len of
     101 (not a multiple of the page: 7 pages gather 112 positions),
     static, dense and paged token-identical; P2, 16 requests of 320 + 16
     tokens sharing a 264-token prefix, static, dense, paged with
     prefix_cache="force"
     and "auto": token-identical, the forced run prefilling at most half
     the dense run's 5,120 prompt tokens, the serve_prefix ledger rows;
     a trie dedupe swap's pages bit for bit the pages they replace; one
     paged and one dense decode step profiled (matmul against the
     indexing kernels, launches); rwkv6-3b (full width, 4 layers) paged
     == dense == static with prefix reuse off; examples/torch_quickstart.py
     on the card;
 16. the request lifecycle: full-width tinyllama-1.1b at 4 layers (bf16,
     seed 0, 4
     slots, phase 5's trace and max_len), dense and paged (pages of 16),
     on a virtual clock that advances per read: phase 5's serve again with
     its tokens and host syncs, no thread started and no serve_admit
     query; priority preemption (a late priority-5 request evicts one of
     four; every token, the victim's too, equal to phase 5's; paged: pages
     back to the trie's pins, the prefix re-pinned); deadlines (expiry
     while queued, TIMED_OUT while decoding with the slot freed,
     queue_full, deadline_infeasible with a serve_admit row); the fault
     classes (raise and stall under a 1 s watchdog retried to phase 5's
     tokens, raise at the prefill site, nan failing exactly the poisoned
     request, exhausted retries failing what is in flight, a fatal fault
     propagating with the paged BlockPool empty), each followed by phase
     5's trace (its 8 requests cut to 16 new tokens) on the same engine
     with equal tokens; the guarded step on
     a worker thread with the direct step's matmul launches by path, the
     caller's stream and no autograd graph; a step abandoned by the
     watchdog that later writes into the pools it captured, which the
     drained pool's new tensors escape; a stop mid-run; the launcher
     (python -m repro_torch.launch.serve ... --inject-fault raise) exits
     0; recorded, not gated: overload on the real clock (Poisson arrivals
     at 2x the unloaded service rate, a queue of 8, deadlines at 8x the
     unloaded latency), serve_admit with and without the correction loop
     on a calibrated runtime, rwkv6-3b (4 layers) raise (gated) and
     preemption drills; the serve, serve_macro and serve_admit ledger
     rows go to the JSON record;
 17. the multi-process front end: full-width tinyllama-1.1b at 4 layers
     (bf16, seed
     0, 4 slots, phase 5's trace and max_len) through Runtime(device=
     "cuda").serve(..., frontend=2, pin=True, stream=True), dense and
     paged (pages of 16): tokens equal phase 5's, texts the engine's
     tokens detokenized, the stream the outputs, host syncs phase 5's and
     (dense) the synchronizing CUDA calls of the same trace served in
     process and streamed, measured serve_ipc rows for both ops, the
     matmul kernel's launches counted from 0; the reference chaos bench's
     respawn drill (intake workers killed and healed, the emission worker
     killed and its transcript replayed) with nvidia-smi listing no
     worker among the processes holding a context on the card; with
     respawn=0 a killed emission worker fails what is in flight
     ("frontend stream broken"), then the same engine serves phase 5's
     trace again through an unpinned front end; the launcher (python -m
     repro_torch.launch.serve ... --workers 2 --pin --stream) exits 0;
     every worker joined at the end; recorded, not gated: the host's
     layout, the affinity plan, the card's PCI bus id and NUMA node,
     engine and workers pinned, spawn-to-first-pong and respawn seconds,
     IPC messages and bytes, phase 5's calibrated IPC constants,
     frontend="auto"'s verdict against the measured intake, tok/s in
     process, unpinned and pinned, and phase 16's overload recipe through
     the front end.  The calling thread's CPU mask is restored after it;
 18. the dense and hybrid families: Runtime(device="cuda").serve of
     mistral-nemo-12b, phi3-mini-3.8b, gemma-2b and recurrentgemma-2b at
     full width, 8, 8, 6 and 6 layers (FAMILY_SERVE_LAYERS; bf16, seed 0,
     phase 5's trace cut to 16 new
     tokens a request, SHORT_NEW, 4 slots), static
     and continuous (recurrentgemma also paged, pages of 16): tokens equal,
     tok/s, host syncs per token, the matmul kernel's launches by path
     counted from 0 before each run; Model.prefill of 4 x 64 at that depth
     in bf16 (flash forward calls by path counted from 0 before it, one
     per full-attention layer); one call of every matmul signature the
     serves and that prefill ran (shapes, strides, dtypes, epilogue)
     against the plain version at phase 2's tolerance, its path checked
     against its dtypes; one decode step each, every matmul
     call on the path its dtypes name, profiled (device ms, launches, busy
     share; no library GEMM or attention kernel); each family at full
     width cut to 2 layers (recurrentgemma 3) in fp32, card against CPU:
     Model.prefill (flash at hd 96/128/256, the windowed forms, the RG-LRU
     scan; its flash calls counted), a batched prefill and 4 decode steps
     within 2e-3 x max|logit|, and recurrentgemma with its window cut to
     64 streaming 80 tokens (the ring buffer wraps) against the CPU and
     its own full forward; the flash forward at (1, 2048, 32, 32, 96) and
     (1, 2048, 8, 1, 256) in bf16 and fp32 against its plain version on
     the path choose_path names, timed beside it, SDPA and the bound;
 19. the mixture-of-experts family and the VLM backbone: as phase 18,
     moonshot-v1-16b-a3b (8 of 48 layers), qwen3-moe-235b-a22b (2 of 94)
     and qwen2-vl-72b (4 of 80,
     M-RoPE with the text-only positions) at full width, bf16, each freed
     before the next is built: served static and continuous, tokens equal;
     Model.prefill 4 x 64 (one tensor-core flash forward a layer); every
     matmul signature (the fp32 router at N 64 and 128, the experts side
     by side at N = E*F and K = E*F, d_ff 29568, the unembedding at vocab
     163840 and 152064) against the plain version, its path and its
     operands' TMA recorded; one profiled decode step, and the MoE blocks
     of one alone against the bound of the expert weights they read;
     card against CPU in fp32 at 2 layers (qwen3-moe 1): prefill, batched
     prefill and 4 steps within 2e-3 x max|logit|, the selected experts
     compared token by token (a swap allowed only between experts whose
     probabilities differ by less than twice the card-vs-CPU difference),
     and qwen2-vl's forward with vision embeddings and distinct (t, h, w)
     positions;
 20. the encoder-decoder family: seamless-m4t-medium at full width and
     depth (12 + 12 layers, vocab 256,206, bf16, seed 0): served static
     and continuous on phase 5's trace cut to 16 new tokens (4 slots),
     tokens equal, tok/s,
     host syncs per token, the matmul kernel's launches by path counted
     from 0 before each run; Model.prefill 4 x 64 with frames (36
     tensor-core flash forwards: 12 encoder and 12 cross non-causal, 12
     causal; the first of each signature against the plain forward);
     every matmul signature of those against the plain version; one
     profiled decode step; paged=True refused with the reference's
     ValueError; every distinct matmul call of one gradient at 2 x 2048
     cut to 1 + 1 layers against the plain version, its path and which
     operands a tensor map loads recorded (the unembedding's gradient
     products step rows of 256,206 elements, which no tensor map takes),
     timed beside torch.matmul; Runtime.train 4 steps at 2 x 2048 with
     frames (every loss finite; tokens/s, peak memory, launches a step;
     no checkpoint, which phase 9 writes) and a fixed batch whose loss falls, one step
     profiled (busy share, device ms by kernel, flash calls by direction,
     mode and path as the wrapper counts them where the kernels launch:
     encoder and cross non-causal, decoder causal, all tensor core; no
     library GEMM or attention kernel); card against CPU in fp32 at 2 + 2
     layers: Model.prefill, a filled cross cache (cross_kv of
     encode(frames)) and 5 decode steps within 2e-3 x max|logit|, the
     loss within 1e-4 relative, every gradient within 2e-3 x max|grad|;
 21. the seven configurations that train on the card from this slice on
     (mistral-nemo-12b, phi3-mini-3.8b, gemma-2b, recurrentgemma-2b,
     moonshot-v1-16b-a3b, qwen3-moe-235b-a22b, qwen2-vl-72b), each built
     and freed before the next: card against CPU in fp32 at full width, 1
     layer (since phase 25; recurrentgemma one period with its
     window cut to 32, once at 2 x 128 through local_attention and once
     at 2 x 64 through the masked dense form; 64, 256 and 128 before phase
     26), batch 2 x 16 (2 x 64 before phase 26): one gradient and its
     loss on the card (a
     make_train_step too before phase 26), then one gradient on the CPU,
     the loss within 1e-4 relative, every gradient within 2e-3 x
     max|grad|, no selected expert flipped; every distinct matmul call of
     one bf16 gradient at 2 x 2048 and one period of layers (1,
     recurrentgemma 3: its windowed 4-D products and their backward)
     against the plain version, as in phase 20 but not timed (since phase
     23, which took its time); Runtime.train in bf16 at
     full width, 2 steps at 2 x 2048 (4 before phase 26; phi3-mini, gemma
     and recurrentgemma
     whole; mistral-nemo 15 of 40 layers, moonshot 8 of 48, qwen3-moe 1
     of 94, qwen2-vl 2 of 80: each the deepest whose peak stays within
     TRAIN_PEAK_LIMIT_GB, held on the run's own peak and printed with
     it): every loss finite, every flash call on the path its dtype and
     head dim name (bf16: hd 96, 128 and 256 on the tensor cores, no
     operand copied), every tensor-core matmul operand on a tensor map,
     peak memory; one step profiled (its matmul calls each on their
     dtypes' path, device ms by kernel, no library GEMM or attention
     kernel); for the three whole models a fixed batch whose loss falls
     in 3 steps;
 22. the kernel autotuner (autotune_phase): Runtime(RuntimeConfig(
     autotune=True, cache_dir=build/autotune_smoke)) tunes by measurement
     every distinct (path, N, K) of full-width tinyllama-1.1b's decode step
     and bf16 training step (the matmul's tile, 64 or 128, timed at M =
     2048 and at the decode step's 4 rows), WKV's chunk at rwkv6-3b's
     training shape (2, 2048, 40, 64) in bf16 with a gradient, and the sort's tile and group at 10^5, 10^6
     and 2^26 fp32 (the candidate builds made together first); every
     candidate's output held against the prior's (the sort bit for bit),
     none failing; each kernel module's shared-memory formula against the
     runtime's report; phase 5's trace served static and continuous under
     the tuned tiles (tokens equal, and equal to phase 5's); the decode step's
     wall and matmul device ms with prior-only and tuned tiles in turns,
     and the host cost of a lookup; Runtime.train 3 steps at 2 x 2048
     with the tuned tiles and with the prior-only ones (tuned, prior,
     tuned); phase 2's batch-invariance gate with every
     product at each tile the tuner chose; two site=autotune ledger rows
     a measured tune; a second Runtime on the same cache measuring nothing
     and returning the same configs; a repeat tune from an empty cache
     (which configs move, recorded).  The kernels line gains each
     kernel's tuned configs;
 23. the mesh (mesh_phase): the paper's two domains across 8 positions
     placed on the one card (make_mesh({"data": 8}, shards_per_device=8),
     a CUDA stream each): sample sort (distributed_sort(force_parallel=
     True, local_sort="kernel")) with the five pivots on N(0, 1) x 1e4 at
     2^24 fp32 and a skewed, duplicated input of 3,637,005, the sampled
     pivot at 2^26, each output bit for bit torch.sort's, the counts
     summing to n, 16 bitonic kernel calls a sort (a local and a bucket
     sort a shard), counts, imbalance and the wall beside the serial
     kernel sort's, the engine's decision at chips 8 with measured ledger
     rows; adaptive_matmul(use_kernel=True) forced to shard_m, shard_n and
     shard_k at orders 1024, 4096 and 8192 in bf16 and (104 x 72 @ 72 x
     88) in fp32: shard_m bit for bit the serial kernel product, the
     others within phase 2's limits, 8 kernel calls a product, wall and
     TFLOP/s beside the serial path, the decision with a measured row, one
     call of each at 4096 profiled (no library GEMM kernel on the device,
     no GEMM op on the host); matmul_chain
     on the mesh in fp32 within 1e-5 x max of the serial chain; gpipe, 4
     tanh stages on the kernel over 8 microbatches (bf16), bit for bit the
     stages in turn; which of these beat serial on this card, recorded.
     The kernels line gains the launches of phase 23's sorts and products;
 24. tensor-parallel serving (serve_mesh_phase): Runtime.serve on a
     {"data": 1, "model": 8} mesh of 8 positions on the one card
     (shards_per_device=8, a CUDA stream each), shard_params="shard".
     fp32 at full width, cut depth (tinyllama-1.1b, mistral-nemo-12b and
     rwkv6-3b at 1 layer, 2 before phase 26; recurrentgemma-2b at one
     period of 3), 4
     requests x 8+2 tokens (8+4 before phase 26) on 2 slots: the sharded
     tokens equal the
     unsharded card's and an 8-position CPU mesh's, the sharded prefill's
     and decode step's logits within 2e-3 x max|logit| of both, every
     position launching the matmul kernel.  bf16 at full width
     (tinyllama-1.1b at 1 of 22 layers, dense and paged on shared-prefix
     traffic with the prefix cache forced; mistral-nemo-12b at 1 of 40
     layers, its 8 kv heads one a position; both at 4 before phase 26),
     phase 5's trace cut to 16 new tokens:
     tokens equal the unsharded engine's up to a near tie (the unsharded
     top-2 margin under the limit there), the same tokens twice, the
     first decode step's logits within the limit, the sharded
     Model.prefill on flash (one forward call a layer a position), one
     decode step measured both ways (wall, host, device ms, launches a
     position, collective calls) and profiled (no library GEMM on the
     device or the host), serve_shard's predicted and measured rows and
     the auto verdict.  The kernels line gains phase 24's matmul and
     flash launches.
  25. FSDP training with tensor and expert parallelism on 8 positions of
     the card (train_mesh_phase): the engine's auto verdicts on the shared
     card (sort, matmul, serve_shard, layer_shard, moe_dispatch: serial or
     replicate); fp32 at 2 layers, full width (tinyllama-1.1b on {"data":
     4, "model": 2}, moonshot-v1-16b-a3b on {"pod": 2, "data": 2, "model":
     2}) against the unsharded card: the loss within rtol 2e-3, every
     gradient and every parameter after one AdamW step within 2e-3 x its
     max; moonshot's expert-parallel layer against moe_ep_plain at
     capacity factors 8.0 (nothing dropped) and 1.25 (the same drops);
     bf16 at full width (tinyllama at 11 of 22 layers, whole before phase
     27; moonshot at 4 of 48 layers) 3
     steps on a fixed batch of 8 x 512 sharded and unsharded: the first
     sharded loss no further from the fp32 loss than the unsharded bf16
     one is plus 2e-3 x |loss|, the loss falling, matmul (the experts' 4-D
     products among them) and flash forward and backward on every
     position, no library GEMM or attention in a profiled step; step wall,
     tokens/s, host and device ms, peak memory, collective calls and
     FSDP-gathered bytes a step printed; the elastic restore (fp32
     tinyllama at 2 layers, 3 steps on {"data": 2, "model": 2}, saved
     whole, restored on {"data": 4, "model": 2}, step 4's loss the
     uninterrupted unsharded run's within rtol 2e-3).  The kernels line
     gains phase 25's matmul and flash launches.
  26. the encoder-decoder and gradient compression on 8 positions of the
     card (encdec_mesh_phase): seamless-m4t-medium at full width, (a) fp32
     at 2 + 2 layers on {"data": 4, "model": 2} against the unsharded
     card (phase 25's limits: loss, every gradient, every parameter after
     a step); (b) bf16 whole (12 + 12 layers) on the same mesh, 3 steps of
     8 x 512 tokens and frames, every matmul and flash signature of the
     first sharded step held against its plain version (the encoder's
     non-causal flash at 8 heads a position, the decoder's causal, the
     ragged cross attention, the 128,103-row vocab block's products),
     step wall, host and device ms, tokens/s, peak GB, launches a
     position and collectives beside the unsharded step's, then the vocab
     block's products timed on the copy loader; (c) served on {"data": 1,
     "model": 2} (2 positions): fp32 tokens equal to the unsharded static
     and continuous serves', the sharded prefill (the encoder and a cross
     term that is not zero) within 2e-3 x max|logit|, bf16 logits held to
     fp32 as phase 24 holds them (phase 5's trace cut to 8 new tokens),
     serve_shard's rows and its KV bytes with
     the cross caches; (d) compression on {"data": 4, "model": 2}
     (tinyllama-1.1b at 2 layers, fp32, keep_frac 0.1, 3 steps): the
     sharded compressed gradient joined back equals the single-device
     compress_gradients of the joined gradient bit for bit, residual
     carried, the step's residual the same, wire_bytes_ratio equal.  The
     kernels line gains phase 26's matmul and flash launches.
  27. the dry run (dryrun_phase, repro_torch/launch/dryrun.py): (a)
     phase 9's second fixed-batch step of full-width tinyllama-1.1b (bf16,
     2 x 2048) traced again on meta tensors: its kernel calls by kernel,
     path and mode equal the card's launches exactly, its predicted peak
     within 10 % of max_memory_allocated over that step (less what the
     process held besides the step's arguments); (b) phase 25's second
     sharded bf16 tinyllama step (11 layers) on {"data": 4, "model": 2}
     (8 x 512) on
     8 meta positions: the calls on each position, the collectives' calls
     and bytes by kind equal, the peak within 10 %; (c) the roofline
     terms of both with the runtime's hardware spec beside the step's
     wall (printed); (d) dryrun_cell("tinyllama-1.1b", "decode_32k",
     multi_pod=True, probe=False) on 512 meta positions on the card's
     host: status ok, 512 chips, the card's allocated bytes and every
     kernel's launch counters unchanged, its wall printed; the phase's
     wall against its 40 s budget logged.
     Before each of phases 2-27, gc.collect() and gc.freeze() (settle): a
     gen-2 collection of this script's heap took 0.2-0.75 s inside a timed
     step, and a collection walking it slowed phase 25's sharded steps
     1.7x.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  The full record goes to
chiprun_out/chip_smoke.json.  Exits non-zero, printing no result, where
torch.cuda.is_available() is false or the repository is missing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BF16_PEAK = 989e12   # H100 SXM data sheet, dense bf16 tensor cores
F32_PEAK = 67e12     # H100 SXM data sheet, fp32 outside the tensor cores
HBM_BW = 3.35e12     # H100 SXM data sheet, bytes/s
BF16_TOL = 8e-3      # x max|plain|: about one bf16 rounding
F32_TOL = 1e-5       # x max|plain|
CHAIN_TOL = 1e-4     # x max|left-to-right product|: fp32, another order
PROMPT, MAX_NEW, SLOTS, REQUESTS = 64, 32, 4, 8
# new tokens a request in the serves whose tokens nothing holds against
# phase 5's (rwkv6-3b in phase 12, phase 15's P2, the families of phases
# 18-20), to keep the script within its time limit on a slower host
SHORT_NEW = 16
# the batch of the card-against-CPU training checks: 2 x PARITY_SEQ tokens
# in phases 8 and 13 (rwkv6-3b's two WKV chunks of 64), 2 x
# FAMILY_TRAIN_CPU_SEQ in phase 21 (recurrentgemma's cases their own)
PARITY_SEQ = 128
# phase 15: pages of 16 tokens; P2 is system-prompt traffic, 16 requests of
# 320 prompt tokens (and SHORT_NEW new ones) opening with one 264-token
# prefix (16.5 pages, so a
# partial tail page is copied on write); P1 pins the horizon K and the
# prefill chunk, so its host syncs compare with the dense run's
PAGE = 16
P2_REQUESTS, P2_PROMPT, P2_PREFIX = 16, 320, 264
PIN = dict(macro_step=8, prefill_chunk=PROMPT)
# phase 15's odd row: a max_len that is not a multiple of the page, so a
# slot's gathered pages (7 x 16 = 112 positions) are longer than its row
ODD_MAX_LEN = PROMPT + MAX_NEW + 5
# the unperturbed counts measured before the engine had the request
# lifecycle, held again with it: phase 5's continuous host syncs,
# P1's host syncs and its synchronizing CUDA calls (torch's sync debug
# mode; 54 or 55 from run to run)
BASE_PHASE5_SYNCS, BASE_P1_SYNCS, BASE_P1_CUDA_SYNCS = 12, 10, (54, 55)
# phase 16 (the request lifecycle): the drills' trace is phase 5's first
# DRILL_REQUESTS requests with DRILL_NEW new tokens (eos -1: the tokens
# are the first DRILL_NEW of phase 5's); overload follows the reference's
# stress bench (benchmarks/stress_bench.py): Poisson arrivals at
# OVERLOAD_FACTOR x the unloaded service rate, a queue of 2 x slots,
# deadlines at DEADLINE_X x the unloaded mean latency
DRILL_REQUESTS, DRILL_NEW = 4, 16
STALL_WATCHDOG_S = 1.0
OVERLOAD_REQUESTS, OVERLOAD_FACTOR, DEADLINE_X = 16, 2.0, 8.0
# phase 17 (the multi-process front end): intake worker processes (the
# emission worker comes with them)
FE_WORKERS = 2
# the indexing kernels of a decode step: a paged step's page gathers and KV
# scatter, a dense step's cache write; the embedding lookup in both
INDEX_KERNELS = r"index|gather|scatter"
# (B, S, Hq, Hkv, hd, dtype) the flash kernels are held at: the training
# shape of tinyllama-1.1b at batch 2 x 2048 in both types, an awkward one
# (S not a multiple of the block, a GQA group of 4), mistral-nemo's heads
# (32 query, 8 kv, hd 128: the tensor-core path's other head dim) and a
# ragged MQA one on the tensor-core path
FLASH_SHAPES = [(2, 2048, 32, 4, 64, "bfloat16"),
                (2, 2048, 32, 4, 64, "float32"),
                (3, 100, 8, 2, 64, "float32"),
                (2, 1024, 32, 8, 128, "bfloat16"),
                (3, 100, 8, 1, 64, "bfloat16")]
# the non-causal modes, as (B, S, Hq, Hkv, hd, dtype, Skv, causal): the
# encoder self-attention of seamless-m4t-medium at its training shape (16
# MHA heads of 64, S == Skv == 2048) and ragged cross attentions (100
# decoder queries against 160 encoder rows, and 160 against 100), each in
# both types
FLASH_NONCAUSAL_SHAPES = [(2, 2048, 16, 16, 64, "bfloat16", 2048, False),
                          (2, 2048, 16, 16, 64, "float32", 2048, False),
                          (3, 100, 8, 8, 64, "bfloat16", 160, False),
                          (3, 100, 8, 8, 64, "float32", 160, False),
                          (3, 160, 8, 8, 64, "bfloat16", 100, False),
                          (3, 160, 8, 8, 64, "float32", 100, False)]
# hd 96 and 256 (bf16 on the tensor cores, fp32 on the FMA kernels), as
# (B, S, Hq, Hkv, hd, dtype):
# phi3-mini's training shape (32 MHA heads of 96), gemma-2b's (8 query
# heads, 1 kv head of 256) and recurrentgemma-2b's head layout (10 / 1 of
# 256) at batch 2 x 2048, and a ragged GQA (3, 100, 8, 2) at each head
# dim, every one in both types
FLASH_NEW_HD_SHAPES = [(2, 2048, 32, 32, 96, "bfloat16"),
                       (2, 2048, 32, 32, 96, "float32"),
                       (2, 2048, 8, 1, 256, "bfloat16"),
                       (2, 2048, 8, 1, 256, "float32"),
                       (2, 2048, 10, 1, 256, "bfloat16"),
                       (2, 2048, 10, 1, 256, "float32"),
                       (3, 100, 8, 2, 96, "bfloat16"),
                       (3, 100, 8, 2, 96, "float32"),
                       (3, 100, 8, 2, 256, "bfloat16"),
                       (3, 100, 8, 2, 256, "float32")]
FLASH_F32_TOL = 2e-3  # x max|plain|: tests/test_kernels.py's flash tolerance
# bf16 flash outputs, element by element: BF16_TOL x the largest |plain| in
# the element's row (the last axis), one bf16 rounding of that row, plus
# F32_TOL x max|plain| for fp32 summation noise.  A global BF16_TOL x max
# would pass a fault of a typical value: most rows average ~1000 positions,
# |o| ~ 0.05 against a max of 3.4.  Readings it was set from (H100, bf16
# training shape): o 9.8e-4 (|o| < 0.25), dk 1.6e-2 (|dk| in [2, 4)), each
# one bf16 step of its element.
# The chain as training runs it, kernel forward then kernel backward,
# against plain forward then plain backward: bf16 gradients within
# FLASH_CHAIN_TOL x max|plain| (the bf16 output the backward reads brings
# its own rounding), fp32 within FLASH_F32_TOL x max|plain|.
FLASH_CHAIN_TOL = 2e-2
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 2, 2048  # TinyLlama's context
# (B, S, H, N, dtype, logw) the WKV kernels are held at: rwkv6-3b's
# training shape at batch 2 x 2048 (logw as the time mix makes it), in both
# types, an awkward one (S not a multiple of the 64-position chunk, 5
# heads), that one at the strongest decay the reference tests, and at
# heavy mixed decays (logw = -exp(3 + N(0, 1)): cumulative decays near
# -1000 a chunk, the CPU tests' log_offset=3)
WKV_SHAPES = [(2, 2048, 40, 64, "bfloat16", "model"),
              (2, 2048, 40, 64, "float32", "model"),
              (3, 100, 5, 64, "float32", "model"),
              (3, 100, 5, 64, "float32", -50.0),
              (3, 100, 5, 64, "float32", "heavy")]
WKV_CHUNK = 64
# the WKV kernels' device-side names (wkv.cu), by part: the state pass runs
# forward (template flag false) and in reverse for the backward (true)
WKV_KERNELS = {"wkv state forward": r"wkv_state<.*false>",
               "wkv output": r"wkv_fwd_out<",
               "wkv state backward": r"wkv_state<.*true>",
               "wkv backward chunk": r"wkv_bwd_chunk<"}
# WKV limits: fp32 outputs within 1e-4 x max|plain| (the reference's WKV
# tolerance, 1e-4 at unit scale, tests/test_kernels.py); bf16 gradients
# (dr, dk, dv) element by element within BF16_TOL x the largest |plain| of
# the element's row + F32_TOL x max|plain|, as flash's bf16 outputs.
# dlogw is a difference of reverse cumulative sums of terms the size of
# r dr and k dk, so its scale is the largest of those and of |dlogw|: at
# logw = -50 the terms cancel, the exact dlogw is ~e^-50, and both versions
# return rounding noise (H100 700 W: |plain dlogw| 2.1e-5, kernel 3.0e-5
# from it, against |r dr|, |k dk| of order 1 and more).
WKV_F32_TOL = 1e-4
# (shape, dtype name) the sort kernel is held at: the paper's Table 3
# sizes, the sort bench's, a realistic 256 MiB array, a row batch of the
# shape the Pallas grid is built for, an awkward one
SORT_SHAPES = [((1000,), "float32"), ((1100,), "float32"),
               ((1500,), "float32"), ((2000,), "float32"),
               ((100_000,), "float32"), ((1_000_000,), "float32"),
               ((1 << 26,), "float32"), ((1 << 24,), "int32"),
               ((4096, 4096), "float32"), ((8, 100), "float32")]
SORT_MAIN_NS = (2000, 1 << 26)  # distributed_sort's runs
# The serving checks other than phase 5's run at full width, their depth
# cut: a decode step is host-bound, launched a layer at a time, so the
# depth sets the wall, and the script must end within the chip check's
# 1,200 s on card machines whose hosts differ by 1.6x in a decode step's
# wall.  Phases 15-17 (paging, the request lifecycle, the front end)
# serve tinyllama-1.1b at CUT_LAYERS of its 22 layers, held to phase 5's
# trace served at that depth (phase 5's anchor run); phase 12 serves
# rwkv6-3b at RWKV_SERVE_LAYERS of 32.  PERF.md keeps the runs that
# served them whole.
CUT_LAYERS = 4
RWKV_SERVE_LAYERS = 8
# phase 18: the dense and hybrid families served at full width, in the
# order of the port's roadmap (cheapest first), at these depths (of 40,
# 32, 18 and 26; recurrentgemma two periods of its pattern)
FAMILIES = ("mistral-nemo-12b", "phi3-mini-3.8b", "gemma-2b",
            "recurrentgemma-2b")
FAMILY_SERVE_LAYERS = {"mistral-nemo-12b": 8, "phi3-mini-3.8b": 8,
                       "gemma-2b": 6, "recurrentgemma-2b": 6}
# phase 19: the mixture-of-experts family and the VLM backbone at full
# width, served at these depths (of 48, 94 and 80; one 80 GB card holds
# moonshot whole, 56.1 GB, and 10 qwen3-moe layers of 4.98 GB)
MOE_VLM = (("moonshot-v1-16b-a3b", 8), ("qwen3-moe-235b-a22b", 2),
           ("qwen2-vl-72b", 4))
# their card-against-CPU depths in fp32, each CPU copy under about 20 GB
MOE_VLM_CPU_LAYERS = {"moonshot-v1-16b-a3b": 2, "qwen3-moe-235b-a22b": 1,
                      "qwen2-vl-72b": 2}
# the flash forward at the head dims they bring: phi3-mini's MHA at hd 96
# and gemma's MQA at hd 256, at a 2048-token prompt
FAMILY_FLASH_SHAPES = [(1, 2048, 32, 32, 96, "bfloat16"),
                       (1, 2048, 32, 32, 96, "float32"),
                       (1, 2048, 8, 1, 256, "bfloat16"),
                       (1, 2048, 8, 1, 256, "float32")]
# phase 21: the seven configurations that train on the card from this
# slice on, in bf16 at TRAIN_BATCH x TRAIN_SEQ, at full width and the
# deepest depth whose Runtime.train peak stays within TRAIN_PEAK_LIMIT_GB
# (None: all of it).  Training state takes 12 bytes a parameter (bf16
# weights and gradients, fp32 AdamW moments), the activations of a 2 x
# 2048 step another 10-15 GB.  Peaks measured on an H100 80GB HBM3 (85.0
# GB): mistral-nemo at 14 layers 71.10 GB, a layer 3.27 GB more of state;
# moonshot at 8 75.10 GB (a layer 6.85); qwen3-moe at 1 64.21 GB (a layer
# 29.85); qwen2-vl at 2 67.06 GB (a layer 10.53).  family_train_phase
# holds each depth to the rule on the run's own peak
FAMILY_TRAIN = (("mistral-nemo-12b", 15), ("phi3-mini-3.8b", None),
                ("gemma-2b", None), ("recurrentgemma-2b", None),
                ("moonshot-v1-16b-a3b", 8), ("qwen3-moe-235b-a22b", 1),
                ("qwen2-vl-72b", 2))
# the headroom: a peak of allocated memory at most this, of the card's
# 85.0 GB, leaves 9 GB for what max_memory_allocated does not count (the
# CUDA context, the allocator's reserved but free blocks, the profiler's
# buffers)
TRAIN_PEAK_LIMIT_GB = 76.0
# their card-against-CPU depths in fp32 (2; qwen3-moe and qwen2-vl 1,
# recurrentgemma one period): the card holds the step's fp32 weights,
# gradient and two moments, 16 bytes a parameter, qwen2-vl's 4.25 B at 2
# layers 68 GB (it fits since the in-place AdamW updates a leaf by blocks
# of rows, adamw.INPLACE_BLOCK); qwen2-vl is cut to 1 layer (3.37 B), its
# 2.49 B of embedding and unembedding kept, for the script's time limit;
# since phase 25 every other configuration but recurrentgemma is
# cut to 1 layer too, for the same limit: one layer still gives every
# kind of leaf its gradient, and recurrentgemma keeps its period (rglru,
# rglru, local), whose windowed layer needs the third
FAMILY_TRAIN_CPU_LAYERS = {"recurrentgemma-2b": 3}
# since phase 26, batch 2 x 16 (2 x 64 before), for the script's time
# limit: the CPU's fp32 gradient of qwen3-moe's 128 experts at 1 layer
# runs them all for every token (moe_dense); recurrentgemma's window cut
# to FAMILY_RING_WINDOW there (RING_WINDOW before), its two sequences with
# it
FAMILY_TRAIN_CPU_SEQ = PARITY_SEQ // 8
FAMILY_RING_WINDOW = 32
# Runtime.train's steps in phase 21 since phase 26 (TRAIN_STEPS, 4,
# before): step 0 warms up, step 1 gives the wall of the four cut models;
# the three whole ones take theirs from the fixed batch, which keeps 3
# steps (4 before) and must lower its loss
FAMILY_TRAIN_STEPS, FAMILY_FIXED_STEPS = 2, 3
# the fixed batch's peak rate for the three whole models.  From their
# random weights Adam's first steps move every weight by about the rate, a
# change of about rate x d in a product's output against its scale of 1:
# with this constant at 1e-4 phi3-mini's loss rose (11.01 -> 14.13 ->
# 12.05); at 1e-5 all three fall (phi3 11.01 -> 10.22 in 4 steps, gemma
# 13.23 -> 12.44, recurrentgemma 14.90 -> 14.11; H100 80GB HBM3)
FAMILY_TRAIN_FIXED_LR = 1e-5
# phase 20: the encoder-decoder family at full width and depth; its
# card-against-CPU run at 2 + 2 layers holds a decode state of
# ENCDEC_MAX_LEN positions (as many cross-cache rows) and takes one
# gradient at batch 2 x ENCDEC_CPU_SEQ
ENCDEC = "seamless-m4t-medium"
ENCDEC_MAX_LEN, ENCDEC_CPU_SEQ = 32, 128
# recurrentgemma's card-against-CPU stream: the window cut to RING_WINDOW,
# RING_STREAM tokens one at a time, so the ring buffer wraps
RING_WINDOW, RING_STREAM = 64, 80


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


class PhaseClock:
    """Wall seconds of each phase of main(), logged as each ends and kept
    in the record (``phase_s``): the script must end within the chip
    check's time limit, and these say where its time goes."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.seconds: dict = {}

    def lap(self, phase: int) -> None:
        now = time.perf_counter()
        self.seconds[str(phase)] = now - self.last
        self.last = now
        log("clock", f"phase {phase}: {self.seconds[str(phase)]:.1f} s; "
            f"{now - self.start:.1f} s since main() started; host memory "
            f"{host_memory()}")


def settle() -> None:
    """Collect, then freeze the survivors (earlier phases' records, models
    and caches) out of the collector (``gc.freeze``): a collection inside a
    later phase's timed step then walks that phase's objects only, not the
    script's heap of many GB (phase 25's sharded tinyllama step read 7.1 s
    without it and 3.6 s with it on an H100).  Run before each of phases
    2-25."""
    gc.collect()
    gc.freeze()


def host_memory() -> str:
    """This process's resident memory (and its peak, where /proc reports
    it) and the host's total and available memory, in GB: a card machine
    that runs out of host memory is lost with the run's output."""
    try:
        status = Path("/proc/self/status").read_text()
        info = Path("/proc/meminfo").read_text()
    except OSError:
        return "not readable"
    kb = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^(VmHWM|VmRSS|MemAvailable|MemTotal):\s+(\d+) kB", status + info,
        re.M)}
    return ", ".join(f"{k} {v / 1e6:.1f}" for k, v in kb.items())


def cuda_ms(fn, flush, reps: int = 10, warm: int = 2) -> float:
    """Mean ms of ``fn()`` by CUDA events with a cold L2: ``flush``, larger
    than the card's 50 MB L2, is rewritten before every rep, outside the
    timed window, so every input comes from device memory, as the bound
    assumes."""
    for _ in range(warm):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def bound_terms(a, b, out_dtype) -> tuple:
    """(ops ms, bytes ms) for epilogue(a @ b): the FLOPs at the card's peak
    for the inputs' type, and each input read once plus the output written
    once at the memory rate, both counted by the package's
    ``kernels.calls.matmul_cost`` (the count the dry run reads).  The
    bound is the larger of the two."""
    from repro_torch.kernels.calls import matmul_cost

    flops, nbytes = matmul_cost(a, b, out_dtype)
    peak = BF16_PEAK if (a.dtype == b.dtype == torch.bfloat16) else F32_PEAK
    return flops / peak * 1e3, nbytes / HBM_BW * 1e3


def rates(a, b, out_dtype, ms) -> tuple:
    """(TFLOP/s, GB/s) of epilogue(a @ b) done in ``ms``: its FLOPs, and
    each input read once plus the output written once."""
    t_ops, t_bytes = bound_terms(a, b, out_dtype)
    peak = BF16_PEAK if (a.dtype == b.dtype == torch.bfloat16) else F32_PEAK
    return t_ops * peak / 1e3 / ms / 1e9, t_bytes * HBM_BW / 1e3 / ms / 1e6


# the matmul kernel's device-side names, by path (matmul.cu); "matmul" in a
# profile's groups is their sum
MATMUL_KERNELS = {"matmul tensor_core": "matmul_wgmma_kernel",
                  "matmul split": "matmul_wgmma_split_kernel",
                  "matmul fma": "matmul_kernel"}
# names of library GEMM kernels (cuBLAS, cuBLASLt, CUTLASS device GEMMs);
# none may run on a main path
LIBRARY_GEMM = re.compile(r"gemm|xmma|cutlass|nvjet|cublas", re.IGNORECASE)
# the flash kernels' device-side names on the tensor-core path
# (flash_attention.cu); none is part of a PyTorch kernel's name
FLASH_KERNELS = {"flash forward": "repro_flash_tc_fwd",
                 "flash backward dq": "repro_flash_tc_dq",
                 "flash backward dk dv": "repro_flash_tc_dkv",
                 "flash group sum": "repro_flash_tc_group_sum"}
# and on the FMA path (fp32; bf16 at hd 16 and 32), templates in
# an anonymous namespace; no library kernel's name holds "::flash_fwd<"
FLASH_FMA_KERNELS = {"flash fma forward": r"::flash_fwd<",
                     "flash fma backward dq": r"::flash_bwd_dq<",
                     "flash fma backward dk dv": r"::flash_bwd_dkv<"}
FLASH_ALL_KERNELS = {**FLASH_KERNELS, **FLASH_FMA_KERNELS}
# names of library attention kernels (FlashAttention-2 in PyTorch, the
# memory-efficient CUTLASS kernels, cuDNN's SDPA); none may run on a main
# path
LIBRARY_ATTENTION = re.compile(
    r"fmha|flash_fwd_kernel|flash_fwd_splitkv|flash_bwd_dq_dk_dv|"
    r"flash_bwd_dot_do_o|flash_bwd_convert_dq|efficient_attention|sdpa|"
    r"attention_kernel", re.IGNORECASE)


def group_device_ms(by_name, groups) -> dict:
    """Device ms of a profile by group: each matmul path, the ``groups``
    given ({label: pattern a kernel's name matches}), everything else, and
    the matmul total."""
    split = {g: sum(v for k, v in by_name.items() if re.search(key, k))
             for g, key in {**MATMUL_KERNELS, **groups}.items()}
    split["other"] = sum(by_name.values()) - sum(split.values())
    split["matmul"] = sum(split[g] for g in MATMUL_KERNELS)
    return split


def library_gemms(phase, by_name) -> list:
    """Names of library GEMM kernels in a main path's profile, logged."""
    found = sorted(k for k in by_name if LIBRARY_GEMM.search(k))
    if found:
        log(phase, f"FAIL: library GEMM kernels on the main path: {found}")
    return found


def expected_path(a, b) -> str:
    """The routing rule by dtypes, stated apart from the wrapper's."""
    if a.dtype == b.dtype == torch.bfloat16:
        return "tensor_core"
    if a.dtype == b.dtype == torch.float32:
        return "fma"
    return "split"


class RouteAudit:
    """Inside the block every matmul kernel call (``ops.matmul_cuda``) is
    checked: the path it launched, read off ``LAUNCHES.by_path``, against
    the path its dtypes name.  ``counts`` tallies the calls by (a dtype, b
    dtype, path); ``wrong`` lists the misrouted."""

    def __init__(self, ops, mm):
        self.ops, self.mm = ops, mm
        self.counts, self.wrong = {}, []

    def __enter__(self):
        self.launch = self.ops.matmul_cuda

        def audited(a, b, **kw):
            before = dict(self.mm.LAUNCHES.by_path)
            out = self.launch(a, b, **kw)
            ran = [p for p, n in self.mm.LAUNCHES.by_path.items()
                   if n != before[p]]
            key = (f"{str(a.dtype)[6:]} x {str(b.dtype)[6:]} -> "
                   f"{'+'.join(ran)}")
            self.counts[key] = self.counts.get(key, 0) + 1
            if ran != [expected_path(a, b)]:
                self.wrong.append(key)
            return out

        self.ops.matmul_cuda = audited
        return self

    def __exit__(self, *exc):
        self.ops.matmul_cuda = self.launch

    def report(self, phase) -> bool:
        log(phase, f"routing: {self.counts}; misrouted {len(self.wrong)}")
        return not self.wrong and bool(self.counts)


class MatmulShapes:
    """Inside the block every ``ops.matmul`` call is seen, and the first
    call of each signature (the operands' shapes, strides and dtypes, the
    bias's, the activation, the output dtype) is kept, operands included,
    in ``calls``.  It costs a tuple and a dict lookup a call."""

    def __init__(self, ops):
        self.ops, self.calls, self.seen = ops, {}, 0

    def __enter__(self):
        self.launch = self.ops.matmul

        def recording(a, b, **kw):
            bias = kw.get("bias")
            key = (tuple(a.shape), a.stride(), a.dtype, tuple(b.shape),
                   b.stride(), b.dtype,
                   None if bias is None else (tuple(bias.shape), bias.dtype),
                   kw.get("activation"), kw.get("out_dtype"))
            self.seen += 1
            if key not in self.calls:
                self.calls[key] = (a, b, kw)
            return self.launch(a, b, **kw)

        self.ops.matmul = recording
        return self

    def __exit__(self, *exc):
        self.ops.matmul = self.launch


class FlashCalls:
    """Inside the block every ``ops.flash_attention`` call is seen, and the
    first call of each signature (q's and k's shapes, the dtype, causal)
    is kept in ``calls`` with its inputs and its output, so that the main
    path's own result can be held against the plain version afterwards,
    with no launch of its own."""

    def __init__(self, ops):
        self.ops, self.calls = ops, {}

    def __enter__(self):
        self.launch = self.ops.flash_attention

        def recording(q, k, v, **kw):
            out = self.launch(q, k, v, **kw)
            key = (tuple(q.shape), tuple(k.shape), q.dtype,
                   kw.get("causal", True))
            if key not in self.calls:
                self.calls[key] = (q, k, v, kw.get("causal", True), out)
            return out

        self.ops.flash_attention = recording
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.launch


class StepChecks:
    """Inside the block the first call of every matmul signature
    (``ops._matmul``, which the forward, the recomputed products and the
    backward's dA and dB all reach: shapes, strides, dtypes, epilogue) and
    of every flash signature each way (``fa.flash_attention_fwd_cuda`` and
    ``fa.flash_attention_bwd_cuda``: q's and k's shapes, the dtype,
    causal) is held against its plain version on the call's own inputs as
    it returns: the matmul at phase 2's tolerance (``held``), flash at
    phase 7's (``flash_error``; the plain backward fed the kernel's o, lse
    and dO).  The main path's own outputs are checked, with no launch of
    their own.  ``fails`` lists the calls outside their limits."""

    def __init__(self, ops, fa, ref):
        self.ops, self.fa, self.ref = ops, fa, ref
        self.matmuls, self.flash, self.fails = {}, {}, []

    def __enter__(self):
        ops, fa, ref = self.ops, self.fa, self.ref
        self.saved = (ops._matmul, fa.flash_attention_fwd_cuda,
                      fa.flash_attention_bwd_cuda)
        launch, fwd, bwd = self.saved

        def matmul(a, b, bias, activation, out_dtype, tuner=None):
            out = launch(a, b, bias, activation, out_dtype, tuner)
            key = (tuple(a.shape), a.stride(), a.dtype, tuple(b.shape),
                   b.stride(), b.dtype, bias is not None, activation,
                   out_dtype)
            if key not in self.matmuls:
                err, tol = held(out, ref.matmul_fused_ref(
                    a, b, bias=bias, activation=activation,
                    out_dtype=out_dtype))
                call = (f"{tuple(a.shape)}{a.stride()} {str(a.dtype)[6:]} @ "
                        f"{tuple(b.shape)}{b.stride()} {str(b.dtype)[6:]}"
                        f"{' +bias' if bias is not None else ''}"
                        f"{' ' + activation if activation else ''} -> "
                        f"{str(out.dtype)[6:]}")
                self.matmuls[key] = dict(call=call, ndim=a.dim(),
                                         max_abs_err=err, tol=tol)
                if not err <= tol:
                    self.fails.append(f"matmul {call}: max abs err "
                                      f"{err:.3e} > {tol:.3e}")
            return out

        def flash_fwd(q, k, v, causal=True, sm_scale=None):
            o, lse = fwd(q, k, v, causal, sm_scale)
            key = ("forward", tuple(q.shape), tuple(k.shape), q.dtype, causal)
            if key not in self.flash:
                o_p, lse_p = ref.flash_attention_fwd_plain(q, k, v, causal,
                                                           sm_scale)
                self._flash(key, (("o", o, o_p), ("lse", lse, lse_p)))
            return o, lse

        def flash_bwd(q, k, v, o, lse, do, causal=True, sm_scale=None):
            grads = bwd(q, k, v, o, lse, do, causal, sm_scale)
            key = ("backward", tuple(q.shape), tuple(k.shape), q.dtype,
                   causal)
            if key not in self.flash:
                want = ref.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                     causal, sm_scale)
                self._flash(key, tuple(zip(("dq", "dk", "dv"), grads,
                                           want)))
            return grads

        ops._matmul = matmul
        fa.flash_attention_fwd_cuda = flash_fwd
        fa.flash_attention_bwd_cuda = flash_bwd
        return self

    def _flash(self, key, outputs):
        errs = {name: flash_error(got, want) for name, got, want in outputs}
        call = (f"{key[0]} q {key[1]} k {key[2]} {str(key[3])[6:]}"
                f"{'' if key[4] else ' non-causal'}")
        self.flash[key] = dict(call=call, max_abs_err=max(
            e for e, _ in errs.values()), of_limit=max(
            r for _, r in errs.values()))
        if not all(r <= 1.0 for _, r in errs.values()):
            self.fails.append(f"flash {call}: " + ", ".join(
                f"{n} {e:.2e} = {r:.2f} x limit" for n, (e, r) in
                errs.items()))

    def __exit__(self, *exc):
        (self.ops._matmul, self.fa.flash_attention_fwd_cuda,
         self.fa.flash_attention_bwd_cuda) = self.saved


def flash_error(got, want) -> tuple:
    """(max abs error, its largest share of the limit) of a flash output
    against its plain version: bf16 element by element within BF16_TOL x
    the largest |plain| in its row + F32_TOL x max|plain|, fp32 within
    FLASH_F32_TOL x max|plain|."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    top = mag.max().item()
    if want.dtype == torch.bfloat16:
        limit = BF16_TOL * mag.amax(-1, keepdim=True) + F32_TOL * top
    else:
        limit = torch.full_like(mag, FLASH_F32_TOL * top)
    return diff.max().item(), (diff / limit).max().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this check needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.configs import get_config
    from repro_torch.core.costs.calibration import calibrate
    from repro_torch.core.dispatch import adaptive_matmul, matmul_chain
    from repro_torch.core.sort import distributed_sort
    from repro_torch.hw import H100
    from repro_torch.kernels import bitonic_sort, build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import wkv as wkv_k
    from repro_torch.kernels.matmul import LAUNCHES
    from repro_torch.models import build_model
    from repro_torch.runtime import Runtime, synthetic_trace
    from repro_torch.serving.scheduler import ServeScheduler
    from repro_torch.core.costs.engine import CostEngine
    from repro_torch.tree import tree_map

    # fp32 products in full fp32 (no TF32) on both sides of every check
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record: dict = {}
    clock = PhaseClock()
    dev = torch.device("cuda")
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)

    # ------------------------------------------------------------------ 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log("card", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    log("build", f"{', '.join(build.SOURCES)} built in {build_s:.2f} s "
        f"into {build.BUILD_DIR}")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    for name, text in build.LOGS.items():  # the ptxas -v reports, in full
        (ROOT / "chiprun_out" / f"ptxas_{name}.txt").write_text(text)
    ptxas = ptxas_summary(build.LOGS.get("matmul", ""))
    for kind, row in ptxas.items():
        log("build", f"matmul.cu {kind}: {row['kernels']} kernels, "
            f"{row['registers'][0]}-{row['registers'][1]} registers a "
            f"thread, spill stores/loads up to {row['spill_bytes']} bytes "
            f"(ptxas -v); shared memory {row['smem']}; wgmma serialized "
            f"(ptxas C7520) in {row['serialized_wgmma']}")
    flash_ptxas = ptxas_summary(build.LOGS.get("flash_attention", ""),
                                FLASH_PTXAS_KINDS)
    for kind, row in flash_ptxas.items():
        log("build", f"flash_attention.cu {kind}: {row['kernels']} kernels, "
            f"{row['registers'][0]}-{row['registers'][1]} registers a "
            f"thread at launch, spill stores/loads up to "
            f"{row['spill_bytes']} bytes (ptxas -v); ptxas C75xx notices "
            f"(wgmma serialized, setmaxnreg ignored) {row['notices']}")
    # the fp32 backward at hd 96 and 256: registers and spills written
    # down, not gated (the FMA path; a spill there costs time, not
    # correctness); bf16 there takes the tensor cores, so no bf16 FMA
    # kernel at those head dims may be built
    new_bwd = ptxas_summary(build.LOGS.get("flash_attention", ""),
                            FLASH_NEW_BWD_KINDS)
    for kind, row in new_bwd.items():
        log("build", f"flash_attention.cu FMA backward {kind}: "
            f"{row['registers'][1]} registers a thread, spill stores/loads "
            f"up to {row['spill_bytes']} bytes (ptxas -v)")
    dead = [x for x in build.LOGS.get("flash_attention", "").splitlines()
            if re.search(FLASH_FMA_BF16_DEAD, x)]
    if sorted(new_bwd) != sorted(k for k, _ in FLASH_NEW_BWD_KINDS) or any(
            row["kernels"] != 1 for row in new_bwd.values()) or dead:
        log("build", f"FAIL: the fp32 FMA backward must be built once at "
            f"each of hd 96 and 256, dq and dk/dv, and no bf16 FMA kernel "
            f"above hd 32: {new_bwd}; {dead}")
        return 1
    tc = flash_ptxas.get("tensor_core")
    notices = [x for x in build.LOGS.get("flash_attention", "").splitlines()
               if "(C75" in x]  # every wgmma of flash_attention.cu is tc
    if not tc or tc["kernels"] != FLASH_TC_KERNELS or tc["spill_bytes"] \
            or notices:
        log("build", f"FAIL: the flash tensor-core kernels must build "
            f"({FLASH_TC_KERNELS} kernels) with no spill and no C75xx "
            f"notice: {tc}; {notices}")
        return 1
    # each tensor-core instantiation as the runtime sees it: shared memory,
    # tiles, registers at launch, local bytes (none), CTAs an SM (one)
    flash_tc_info = {hd: fa.tc_kernel_info(hd) for hd in fa.TC_HEAD_DIMS}
    for hd, info in flash_tc_info.items():
        for kern, x in info.items():
            log("build", f"flash tensor core hd {hd} {kern}: "
                f"{x['smem_bytes']} bytes dynamic shared memory, "
                f"{x['cta_rows']} rows a CTA, {x['stage_rows']} a stage, "
                f"{x['stages']} stages, {x['registers']} registers a thread "
                f"at launch, {x['local_bytes']} local bytes, "
                f"{x['ctas_per_sm']} CTAs an SM")
    if any(x["local_bytes"] or x["ctas_per_sm"] < 1
           for info in flash_tc_info.values() for x in info.values()):
        log("build", f"FAIL: a tensor-core flash kernel spills or cannot "
            f"be resident: {flash_tc_info}")
        return 1
    sort_ptxas = ptxas_summary(build.LOGS.get("bitonic_sort", ""),
                               SORT_PTXAS_KINDS)
    for kind, row in sort_ptxas.items():
        log("build", f"bitonic_sort.cu {kind}: {row['kernels']} kernels, "
            f"{row['registers'][0]}-{row['registers'][1]} registers a "
            f"thread, spill stores/loads up to {row['spill_bytes']} bytes "
            f"(ptxas -v)")
    sort_counts = {k: v["kernels"] for k, v in sort_ptxas.items()}
    if sort_counts != {"block": 4, "global": 2} or any(
            v["spill_bytes"] for v in sort_ptxas.values()):
        log("build", f"FAIL: the sort kernels (first and finishing block "
            f"passes, global pass; fp32 and int32) must build with no "
            f"spill: {sort_ptxas}")
        return 1
    wkv_build = wkv_build_report(wkv_k, build.LOGS.get("wkv", ""))
    (ROOT / "chiprun_out" / "wkv_build.json").write_text(
        json.dumps(wkv_build, indent=1))
    n_inst = len(wkv_k.CHUNKS) * len(wkv_k.HEAD_SIZES) * 2  # L x N x dtype
    counts = {kind: row["kernels"] for kind, row in wkv_build["ptxas"].items()}
    if wkv_build["spills"] or counts != {
            kind: n_inst for kind in ("state forward", "output",
                                      "state backward", "backward chunk")} \
            or wkv_k.design()["subchunk"] != wkv_k.SUBCHUNK:
        log("build", f"FAIL: the WKV kernels (state pass both ways, output, "
            f"backward chunk; {n_inst} instantiations each) must build with "
            f"no spill, on sub-chunks of wkv.SUBCHUNK rows: kernels {counts}, "
            f"spilling {wkv_build['spills']}, design {wkv_k.design()}")
        return 1
    record.update(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=build_s, matmul_ptxas=ptxas,
                  flash_ptxas=flash_ptxas, flash_new_bwd_ptxas=new_bwd,
                  flash_tc_info=flash_tc_info,
                  sort_ptxas=sort_ptxas,
                  wkv_build=wkv_build)

    # ------------------------------------------------------------------ 2
    clock.lap(1)
    settle()  # now, not as a gen-2 pass inside a timed step
    cfg = get_config("tinyllama-1.1b")
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    hq, hkv, g = cfg.n_heads, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    max_len = PROMPT + MAX_NEW
    chunk, _ = ServeScheduler(cfg, CostEngine(), max_len=max_len).prefill_chunk(
        PROMPT, active_decodes=0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    w = {n: rand(kk, nn, scale=kk ** -0.5) for n, (kk, nn) in {
        "wq": (d, hq * hd), "wk": (d, hkv * hd), "wo": (hq * hd, d),
        "w_gate": (d, f), "w_out": (f, d)}.items()}
    table = rand(cfg.vocab_size, d, scale=0.02)
    cache_k = rand(SLOTS, max_len, hkv, hd)
    cache_v = rand(SLOTS, max_len, hkv, hd)
    # (name, a, b, activation, out_dtype)
    cases = []
    for phase_rows, s_new in (("decode", 1), ("prefill", chunk)):
        m = SLOTS * s_new
        x = rand(m, d)
        x32 = rand(m, d, dtype=torch.float32)
        cases += [
            (f"{phase_rows} rmsnorm x*x.1", x32 * x32,
             torch.ones(d, 1, device=dev), None, torch.float32),
            (f"{phase_rows} wq/wo", x, w["wq"], None, torch.bfloat16),
            (f"{phase_rows} wk/wv", x, w["wk"], None, torch.bfloat16),
            (f"{phase_rows} w_gate silu", x, w["w_gate"], "silu",
             torch.bfloat16),
            (f"{phase_rows} w_in", x, w["w_gate"], None, torch.bfloat16),
            (f"{phase_rows} w_out", rand(m, f), w["w_out"], None,
             torch.bfloat16),
            (f"{phase_rows} attn q.k", rand(SLOTS, hkv, s_new * g, hd,
                                            dtype=torch.float32),
             cache_k.permute(0, 2, 3, 1), None, torch.float32),
            (f"{phase_rows} attn p.v", torch.softmax(rand(
                SLOTS, hkv, s_new * g, max_len, dtype=torch.float32), -1),
             cache_v.permute(0, 2, 1, 3), None, torch.float32),
            (f"{phase_rows} unembed", x, table.t(), None, torch.float32),
        ]
    extra = [("fp32 ragged 37x129x65", rand(37, 65, dtype=torch.float32),
              rand(65, 129, dtype=torch.float32), None, torch.float32)]
    for act in ("relu", "gelu", "silu", "tanh"):
        extra.append((f"bias+{act} 37x129x65", rand(37, 65), rand(65, 129),
                      act, torch.bfloat16))
    rows, worst = [], 0.0
    bias = rand(129, dtype=torch.float32)
    for name, a, b, act, out_dt in cases + extra:
        bb = bias if name.startswith("bias") else None
        kw = dict(bias=bb, activation=act, out_dtype=out_dt)
        err, tol = kernel_error(ops, ref, a, b, kw)
        if not err <= tol:
            log("kernel", f"FAIL {name}: max abs err {err:.3e} > {tol:.3e}")
            return 1
        worst = max(worst, err)
        path = mm.choose_path(a.dtype, b.dtype)
        k_ms = cuda_ms(lambda: ops.matmul(a, b, **kw), flush)
        p_ms = cuda_ms(lambda: ref.matmul_fused_ref(a, b, **kw), flush)
        # one library call computing the same function exists only for a
        # plain product whose output type is its inputs' type
        same_fn = (act is None and bb is None and a.dtype == b.dtype == out_dt)
        l_ms = cuda_ms(lambda: torch.matmul(a, b), flush) if same_fn else None
        t_ops, t_bytes = bound_terms(a, b, out_dt)
        tflops, gbs = rates(a, b, out_dt, k_ms)
        rows.append(dict(name=name, shape=f"{tuple(a.shape)}@{tuple(b.shape)}",
                         path=path, tflops=tflops, gb_per_s=gbs,
                         max_abs_err=err, tol=tol, ms=k_ms, plain_ms=p_ms,
                         library_ms=l_ms, bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes"))
        log("kernel", f"{name:24s} {rows[-1]['shape']:42s} {path:11s} err "
            f"{err:.2e} (tol {tol:.2e})  kernel {k_ms:.4f} ms ({tflops:.2f} "
            f"TFLOP/s, {gbs:.1f} GB/s)  plain {p_ms:.4f} ms  "
            f"library {'-' if l_ms is None else f'{l_ms:.4f}'} ms  "
            f"bound {rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}); "
            f"cold L2")
    record["kernel_rows"] = rows
    record["batch_invariance"] = invariance_gate(ops, mm, gen, d, f)
    if record["batch_invariance"] is None:
        return 1

    # ------------------------------------------------------------------ 3
    clock.lap(2)
    settle()
    engine = CostEngine()
    paper = []
    for order in (1024, 4096, 8192):
        a = rand(order, order, scale=order ** -0.5)
        b = rand(order, order)
        out, rep = adaptive_matmul(a, b, engine=engine, use_kernel=True,
                                   return_report=True)
        want = ref.matmul_ref(a, b)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        tol = BF16_TOL * want.float().abs().max().item()
        if not err <= tol:
            log("paper", f"FAIL order {order}: err {err:.3e} > {tol:.3e}")
            return 1
        row = engine.ledger.entries[-1]
        reps = 3 if order == 8192 else 10
        k_ms = cuda_ms(lambda: adaptive_matmul(a, b, engine=engine,
                                               use_kernel=True), flush, reps, 1)
        l_ms = cuda_ms(lambda: torch.matmul(a, b), flush, reps, 1)
        t_ops, t_bytes = bound_terms(a, b, a.dtype)
        paper.append(dict(order=order, path=mm.choose_path(a.dtype, b.dtype),
                          bound_ms=max(t_ops, t_bytes),
                          choice=rep.decision.choice,
                          predicted_s=rep.decision.predicted_s, err=err,
                          kernel_ms=k_ms, torch_matmul_ms=l_ms,
                          kernel_tflops=2 * order**3 / k_ms / 1e9))
        log("paper", f"order {order}: decision {rep.decision.choice} "
            f"(predicted {rep.decision.predicted_s:.3e} s; ledger "
            f"{row.site}/{row.choice} {row.query['shape']}), err {err:.2e} "
            f"(tol {tol:.2e}), {paper[-1]['path']} kernel {k_ms:.3f} ms "
            f"({paper[-1]['kernel_tflops']:.1f} TFLOP/s), torch.matmul "
            f"{l_ms:.3f} ms, bound {paper[-1]['bound_ms']:.3f} ms")
    record["paper"] = paper
    chain_shapes = [(1024, 4096), (4096, 256), (256, 4096), (4096, 1024)]
    mats = [rand(*s, dtype=torch.float32, scale=s[0] ** -0.5)
            for s in chain_shapes]
    chain_engine = CostEngine()
    got = matmul_chain(mats, engine=chain_engine)
    want = mats[0] @ mats[1] @ mats[2] @ mats[3]  # left to right
    torch.cuda.synchronize()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    decisions = [e.choice for e in chain_engine.ledger.entries
                 if e.site == "matmul"]
    chain_ms = cuda_ms(lambda: matmul_chain(mats, engine=chain_engine), flush)
    ltr_ms = cuda_ms(lambda: mats[0] @ mats[1] @ mats[2] @ mats[3], flush)
    log("paper", f"matmul_chain {chain_shapes} fp32: {len(decisions)} "
        f"decisions {decisions}, rel err {rel:.2e} (limit {CHAIN_TOL:g}) "
        f"against a left-to-right torch.matmul product; chain "
        f"{chain_ms:.3f} ms, left to right {ltr_ms:.3f} ms; cold L2")
    if not (rel <= CHAIN_TOL and len(decisions) == len(mats) - 1):
        return 1
    record["matmul_chain"] = dict(shapes=chain_shapes, rel_err=rel,
                                  decisions=decisions, chain_ms=chain_ms,
                                  left_to_right_ms=ltr_ms)

    # ------------------------------------------------------------------ 4
    clock.lap(3)
    settle()
    sort_rows = []
    for shape, dtype_name in SORT_SHAPES:
        row = sort_case(shape, getattr(torch, dtype_name), gen, ops, ref,
                        bitonic_sort, flush)
        if row is None:
            return 1
        sort_rows.append(row)
    record["sort_rows"] = sort_rows
    big = next(r for r in sort_rows
               if r["shape"] == [1 << 26] and r["dtype"] == "float32")
    record["sort_stages"] = sort_stages(gen, bitonic_sort.bitonic_sort_cuda)
    if not sort_hard_inputs(bitonic_sort, ref):
        return 1
    sort_engine = CostEngine()
    xs = [torch.randn(n, generator=gen, device=dev) for n in SORT_MAIN_NS]
    torch.cuda.synchronize()
    bitonic_sort.LAUNCHES.reset()
    outs = [distributed_sort(x, engine=sort_engine, local_sort="kernel",
                             measure=True) for x in xs]
    torch.cuda.synchronize()
    sort_launches = bitonic_sort.LAUNCHES.count
    sort_grids = bitonic_sort.LAUNCHES.grids
    for x, (out, rep) in zip(xs, outs):
        exact = torch.equal(out, torch.sort(x).values)
        log("sort", f"distributed_sort(local_sort='kernel') n={x.numel()}: "
            f"strategy {rep.strategy}, imbalance {rep.imbalance}, equal to "
            f"torch.sort: {exact}")
        if not exact or rep.strategy != "serial":
            return 1
    log("sort", f"bitonic sort kernel calls on the sort path: "
        f"{sort_launches} ({sort_grids} CUDA launches)")
    if sort_launches != len(SORT_MAIN_NS):  # one kernel call per sort
        return 1
    ledger_rows = []
    for e in sort_engine.ledger.entries:
        if e.site == "sort" and e.measured_s is not None:
            ledger_rows.append(dict(shape=e.query["shape"], choice=e.choice,
                                    predicted_s=e.predicted_s,
                                    measured_s=e.measured_s))
            log("ledger", f"  sort {e.choice} n={e.query['shape']}: "
                f"predicted {e.predicted_s:.3e} s, measured "
                f"{e.measured_s:.3e} s")
    record["sort_path"] = dict(launches=sort_launches, grids=sort_grids,
                               ledger=ledger_rows)

    # ------------------------------------------------------------------ 5
    clock.lap(4)
    settle()
    rt = Runtime(device="cuda")
    model = build_model(cfg, rt.device)
    params = model.init(0)
    trace = lambda: synthetic_trace(  # noqa: E731
        REQUESTS, prompt_len=PROMPT, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="all", seed=0)
    LAUNCHES.reset()
    static = rt.serve(cfg, trace(), mode="static", model=model, params=params,
                      slots=SLOTS, eos_id=-1)
    cont = rt.serve(cfg, trace(), mode="continuous", model=model,
                    params=params, slots=SLOTS, eos_id=-1)
    torch.cuda.synchronize()
    launches = LAUNCHES.count
    same = all((static.outputs[r] == cont.outputs[r]).all()
               for r in static.outputs)
    ntok = sum(len(v) for v in cont.outputs.values())
    log("serve", f"tinyllama-1.1b full width bf16, {REQUESTS} requests x "
        f"{PROMPT}+{MAX_NEW} tokens, {SLOTS} slots: static "
        f"{static.tok_per_s:.1f} tok/s, continuous {cont.tok_per_s:.1f} tok/s, "
        f"host_syncs_per_token {cont.report.host_syncs_per_token:.4f} "
        f"({cont.report.host_syncs} syncs, {cont.report.device_dispatches} "
        f"dispatches, {ntok} tokens)")
    serve_paths = dict(LAUNCHES.by_path)
    log("serve", f"static == continuous tokens: {same}; matmul kernel "
        f"launches during serving: {launches} (by path {serve_paths})")
    if not same or launches <= 0:
        return 1
    for site in ("serve", "serve_macro"):
        rows_site = [e for e in rt.ledger.entries if e.site == site]
        meas = [e for e in rows_site if e.measured_s is not None]
        log("ledger", f"{site}: {len(rows_site)} rows, {len(meas)} measured")
        for e in meas[-3:]:
            log("ledger", f"  {site} {e.choice} {e.note}: predicted "
                f"{e.predicted_s:.3e} s, measured {e.measured_s:.3e} s")
    state = model.init_decode_state(SLOTS, max_len, per_slot=True)
    feed = {"tokens": torch.ones((SLOTS, 1), dtype=torch.int64, device=dev)}
    LAUNCHES.reset()
    with RouteAudit(ops, mm) as audit:
        calls = step_matmuls(model, params, state, feed, ops)
    per_step = LAUNCHES.count
    step_paths = dict(LAUNCHES.by_path)
    log("serve", f"matmul kernel launches per decode step: {per_step} (by "
        f"path {step_paths})")
    prof = profile_decode_step(model, params, state, feed)
    step = replay_step(calls, ops, ref, flush)
    if step is None or not audit.report("serve") or prof["library_gemms"]:
        return 1
    p1_want = {r: np.asarray(v) for r, v in cont.outputs.items()}
    # the anchor of phases 15-17: phase 5's trace at CUT_LAYERS layers
    cut_cfg = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    cut_model = build_model(cut_cfg, rt.device)
    cut_params = cut_model.init(0)
    cut_runs = {mode: rt.serve(cut_cfg, trace(), mode=mode, model=cut_model,
                               params=cut_params, slots=SLOTS, eos_id=-1)
                for mode in ("static", "continuous")}
    cut_same = all(np.array_equal(cut_runs["static"].outputs[r],
                                  cut_runs["continuous"].outputs[r])
                   for r in cut_runs["static"].outputs)
    cut_syncs = cut_runs["continuous"].report.host_syncs
    cut_want = {r: np.asarray(v)
                for r, v in cut_runs["continuous"].outputs.items()}
    log("serve", f"the anchor of phases 15-17, phase 5's trace at "
        f"{CUT_LAYERS} of {cfg.n_layers} layers: static "
        f"{cut_runs['static'].tok_per_s:.1f} tok/s, continuous "
        f"{cut_runs['continuous'].tok_per_s:.1f} tok/s; static == "
        f"continuous tokens {cut_same}; host syncs {cut_syncs} (the whole "
        f"model's {cont.report.host_syncs})")
    if not cut_same or cut_syncs != cont.report.host_syncs:
        return 1
    del cut_runs, cut_model, cut_params
    worst = max(worst, step["max_abs_err"])
    if prof["matmul_ms"] > 0 and step["plain_device_ms"] > 0:
        step.update(ms=prof["matmul_ms"], plain_ms=step["plain_device_ms"],
                    timed_by="torch.profiler device time")
    else:
        step.update(ms=step["kernel_window_ms"],
                    plain_ms=step["plain_window_ms"],
                    timed_by="CUDA-event window of the replay (the profiler "
                    "saw no kernels)")
    log("step", f"one decode step's {len(calls)} matmuls ({SLOTS} slots, "
        f"{cfg.n_layers} layers): kernel {step['ms']:.3f} ms in the real "
        f"step, plain {step['plain_ms']:.3f} ms replayed, by "
        f"{step['timed_by']}; replay windows (cold L2) kernel "
        f"{step['kernel_window_ms']:.3f} ms, plain "
        f"{step['plain_window_ms']:.3f} ms; bound {step['bound_ms']:.3f} ms "
        f"({step['bound_by']}); all within tolerance of the plain version, "
        f"largest error {step['worst_call']}")
    log("step", f"the {step['library_calls']} of {len(calls)} calls that one "
        f"torch.matmul computes (no epilogue, one dtype): torch.matmul "
        f"{step['library_device_ms']:.3f} ms, the kernel "
        f"{step['kernel_device_ms_on_library_calls']:.3f} ms replayed, by "
        f"torch.profiler device time")
    record["decode_step_profile"] = prof
    record["decode_step"] = step
    cal = calibrate(H100, cache_dir=ROOT / "build" / "calibration",
                    force=True, device="cuda")
    fields = {k: v for k, v in cal.measurements.items() if v is not None}
    log("calibrate", " ".join(f"{k}={v:.4g}" for k, v in fields.items()))
    record["serve"] = dict(
        static_tok_per_s=static.tok_per_s, continuous_tok_per_s=cont.tok_per_s,
        host_syncs=cont.report.host_syncs,
        device_dispatches=cont.report.device_dispatches,
        host_syncs_per_token=cont.report.host_syncs_per_token,
        generated_tokens=ntok, launches=launches, launches_by_path=serve_paths,
        launches_per_decode_step=per_step,
        launches_per_decode_step_by_path=step_paths,
        routing=audit.counts, tokens_identical=same)
    record["calibration"] = cal.measurements

    # ------------------------------------------------------------------ 6
    clock.lap(5)
    settle()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p_gpu = tree_map(lambda t: t.float(), params)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    prompts = torch.as_tensor(
        synthetic_trace(2, prompt_len=16, max_new=1, vocab_size=cfg.vocab_size,
                        arrival="all", seed=1)[0].prompt, dtype=torch.int64)
    prompts = torch.stack([prompts, prompts.flip(0)])
    logits = {}
    for where, p_dev in (("cuda", p_gpu), ("cpu", p_cpu)):
        m32 = build_model(cfg32, where)
        st = m32.init_decode_state(2, 32, per_slot=True)
        out, st = m32.decode_step(p_dev, st, {"tokens": prompts.to(where)})
        steps = [out[:, -1]]
        for _ in range(4):
            tok = steps[-1].argmax(-1)[:, None]
            out, st = m32.decode_step(p_dev, st, {"tokens": tok})
            steps.append(out[:, -1])
        logits[where] = [s.float().cpu() for s in steps]
    worst_rel = 0.0
    for i, (lg, lc) in enumerate(zip(logits["cuda"], logits["cpu"])):
        tol = 2e-3 * lc.abs().max().item()
        err = (lg - lc).abs().max().item()
        worst_rel = max(worst_rel, err / lc.abs().max().item())
        if not err <= tol:
            log("card-vs-cpu", f"FAIL step {i}: logits err {err:.3e} > "
                f"{tol:.3e}")
            return 1
        tg, tc = lg.argmax(-1), lc.argmax(-1)
        if not torch.equal(tg, tc):
            top2 = lc.topk(2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).min().item()
            log("card-vs-cpu", f"step {i}: tokens differ at a top-2 gap of "
                f"{gap:.3e} (tolerance {tol:.3e})")
            if gap >= tol:
                return 1
            break
    log("card-vs-cpu", f"fp32 prefill 2x16 + 4 decode steps: logits agree, "
        f"max err {worst_rel:.2e} x max|logit| (limit 2e-3); greedy tokens "
        f"equal")
    record["card_vs_cpu_rel_err"] = worst_rel

    del p_gpu, p_cpu, params, model, static, cont, calls, state
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 7
    clock.lap(6)
    settle()
    flash_rows = []
    for shape in FLASH_SHAPES + FLASH_NONCAUSAL_SHAPES + FLASH_NEW_HD_SHAPES:
        row = flash_case(shape, gen, ref, fa, flush)
        if row is None:
            return 1
        flash_rows.append(row)
    record["flash_rows"] = flash_rows
    record["flash_copy_rows"] = []
    for hd in (96, 256):  # the padded tile's zero fill, the split backward
        row = flash_copy_case(hd, gen, ref, fa)
        if row is None:
            return 1
        record["flash_copy_rows"].append(row)
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 8
    clock.lap(7)
    settle()
    parity = train_parity(cfg)
    if parity is None:
        return 1
    record["train_parity"] = parity
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 9
    clock.lap(8)
    settle()
    record["train_matmuls"] = train_matmuls(cfg, ops, ref, flush)
    if record["train_matmuls"] is None:
        return 1
    train = train_phase(cfg, fa, LAUNCHES)
    if train is None:
        return 1
    record["train"] = train
    flash_main = flash_rows[0]  # the bf16 training shape
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 10
    clock.lap(9)
    settle()
    wkv_rows = []
    for shape in WKV_SHAPES:
        row = wkv_case(shape, gen, ref, wkv_k, flush)
        if row is None:
            return 1
        wkv_rows.append(row)
    record["wkv_rows"] = wkv_rows
    torch.cuda.empty_cache()
    rcfg = get_config("rwkv6-3b")

    # ----------------------------------------------------------------- 11
    clock.lap(10)
    settle()
    record["rwkv_card_vs_cpu"] = rwkv_card_vs_cpu(rcfg, wkv_k)
    if record["rwkv_card_vs_cpu"] is None:
        return 1
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 12
    clock.lap(11)
    settle()
    record["rwkv_serve"] = rwkv_serve(
        dataclasses.replace(rcfg, n_layers=RWKV_SERVE_LAYERS), LAUNCHES,
        wkv_k)
    if record["rwkv_serve"] is None:
        return 1
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 13
    clock.lap(12)
    settle()
    record["rwkv_train_parity"] = train_parity(rcfg, leaves=47)
    if record["rwkv_train_parity"] is None:
        return 1
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 14
    clock.lap(13)
    settle()
    rtrain = rwkv_train_phase(rcfg, wkv_k, LAUNCHES)
    if rtrain is None:
        return 1
    record["rwkv_train"] = rtrain
    wkv_main = wkv_rows[0]  # the bf16 training shape
    wd = wkv_k.design()
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 15
    clock.lap(14)
    settle()
    paged = paged_phase(cut_cfg, rcfg, cut_want, LAUNCHES, card,
                        prof["device_events"])
    if paged is None:
        return 1
    record["paged"] = paged
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 16
    clock.lap(15)
    settle()
    life = lifecycle_phase(cut_cfg, rcfg, cut_want, cut_syncs, LAUNCHES,
                           card)
    if life is None:
        return 1
    record["lifecycle"] = life
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 17
    clock.lap(16)
    settle()
    front = frontend_phase(cut_cfg, cut_want, cut_syncs,
                           record["calibration"], LAUNCHES, card)
    if front is None:
        return 1
    record["frontend"] = front
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 18
    clock.lap(17)
    settle()
    families = families_phase(mm, fa, ops, ref, gen, flush, card)
    if families is None:
        return 1
    record["families"] = families

    # ----------------------------------------------------------------- 19
    clock.lap(18)
    settle()
    del flush  # 512 MiB back for qwen3-moe's 52 GB
    torch.cuda.empty_cache()
    moe_vlm = moe_vlm_phase(mm, fa, ops, ref, card)
    if moe_vlm is None:
        return 1
    record["moe_vlm"] = moe_vlm

    # ----------------------------------------------------------------- 20
    clock.lap(19)
    settle()
    torch.cuda.empty_cache()
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    encdec = encdec_phase(mm, fa, ops, ref, flush, card)
    if encdec is None:
        return 1
    record["encdec"] = encdec
    noncausal = [r for r in flash_rows if not r["causal"]]
    new_hd = [r for r in flash_rows if r["shape"][4] in (96, 256)]

    # ----------------------------------------------------------------- 21
    clock.lap(20)
    settle()
    del flush  # 512 MiB back for the deepest cut each model takes
    torch.cuda.empty_cache()
    family_train = family_train_phase(mm, fa, ops, ref, card)
    if family_train is None:
        return 1
    record["family_train"] = family_train

    # ----------------------------------------------------------------- 22
    clock.lap(21)
    settle()
    torch.cuda.empty_cache()
    autotune = autotune_phase(cfg, p1_want, card)
    if autotune is None:
        return 1
    record["autotune"] = autotune

    def tuned(family):
        """Phase 22's tuned configs of one kernel family."""
        return [{k: r[k] for k in ("key", "source", "prior", "tuned",
                                   "prior_ms", "tuned_ms")}
                for r in autotune["results"] if r["family"] == family]

    # ----------------------------------------------------------------- 23
    clock.lap(22)
    settle()
    torch.cuda.empty_cache()
    mesh = mesh_phase(card)
    if mesh is None:
        return 1
    record["mesh"] = mesh

    # ----------------------------------------------------------------- 24
    clock.lap(23)
    settle()
    torch.cuda.empty_cache()
    serve_mesh = serve_mesh_phase(card)
    if serve_mesh is None:
        return 1
    record["serve_mesh"] = serve_mesh

    # ----------------------------------------------------------------- 25
    clock.lap(24)
    settle()
    torch.cuda.empty_cache()
    train_mesh = train_mesh_phase(card)
    if train_mesh is None:
        return 1
    record["train_mesh"] = train_mesh

    # ----------------------------------------------------------------- 26
    clock.lap(25)
    settle()
    torch.cuda.empty_cache()
    encdec_mesh = encdec_mesh_phase(card)
    if encdec_mesh is None:
        return 1
    record["encdec_mesh"] = encdec_mesh

    # ----------------------------------------------------------------- 27
    clock.lap(26)
    settle()
    torch.cuda.empty_cache()
    dryrun = dryrun_phase(card)
    if dryrun is None:
        return 1
    record["dryrun"] = dryrun

    # ---------------------------------------------------------------- out
    clock.lap(27)
    record["phase_s"] = clock.seconds
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    kernels = [{
        "name": "matmul", "route": "cuda",
        "design": "wgmma bf16 tensor cores fed by TMA (bf16 x bf16), the "
                  "same kernel on hi + lo bf16 halves (fp32 x bf16), the "
                  "FP32 FMA kernel (fp32 x fp32)",
        "source": "src/repro_torch/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:103",
        "launches": launches,
        # phase 2's shapes, phase 5's decode step and one call of every
        # signature phase 18's families ran
        "max_abs_err": max([worst] + [
            rec["matmul_checks"]["max_abs_err"]
            for rec in list(families["serve"].values())
            + list(moe_vlm["serve"].values()) + [encdec["serve"]]]),
        # phase 15's paged serving run (P1), counted from 0 just before it
        "launches_paged_serve": paged["p1"]["matmul_launches"],
        # phase 16's dense preemption drill, counted from 0 just before it
        "launches_lifecycle_serve": life["matmul_launches"],
        # phase 17's dense front-end serve, counted from 0 just before it
        "launches_frontend_serve": front["dense"]["matmul_launches"],
        # phase 18's serves of the four families, static and continuous
        # (and recurrentgemma paged), each counted from 0 just before it
        "launches_families_serve": {
            arch: {mode: n["count"] for mode, n in
                   rec["matmul_launches"].items()}
            for arch, rec in families["serve"].items()},
        # phase 19's serves of moonshot, qwen3-moe and qwen2-vl at the
        # depths MOE_VLM gives, static and continuous, each counted from 0
        # just before it
        "launches_moe_vlm_serve": {
            arch: {mode: n["count"] for mode, n in
                   rec["matmul_launches"].items()}
            for arch, rec in moe_vlm["serve"].items()},
        # phase 20's serves of seamless-m4t-medium (12 + 12 layers), static
        # and continuous, each counted from 0 just before it, and its
        # Runtime.train's launches a step (by path)
        "launches_encdec_serve": {
            mode: n["count"] for mode, n in
            encdec["serve"]["matmul_launches"].items()},
        "launches_encdec_train_per_step": {
            k[7:]: v for k, v in
            encdec["train"]["launches_per_step"].items()
            if k.startswith("matmul ")},
        # phase 21's Runtime.train of the seven new trainers: launches a
        # step by path, and the tensor-core operands no tensor map loaded
        "launches_family_train_per_step": {
            arch: {**{k[7:]: v for k, v in rec["launches_per_step"].items()
                      if k.startswith("matmul ")},
                   "copied_operands":
                       rec["launches_per_step"]["matmul_copied_operands"]}
            for arch, rec in family_train["train"].items()},
        # one decode step's matmul calls: the kernel in the real step, the
        # plain version on the same operands, the bound of the same work
        "ms": step["ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
        # no single library call computes a step's fused-epilogue and
        # fp32-output products; chiprun_out/chip_smoke.json has
        # torch.matmul beside every plain product of phase 2 and summed
        # over the step's calls that one torch.matmul computes
        "library_ms": None,
        # phase 22: the tile of every (path, N, K) of tinyllama-1.1b's
        # decode and training steps, measured at M = 2048
        "tuned": tuned("matmul"),
        # phase 23: calls of one sharded product on the mesh of 8 shards
        # (one a shard) by strategy at order 4096, counted from 0 just
        # before it, the chain's and GPipe's (4 stages x 8 microbatches)
        "launches_mesh": {
            "order_4096": {s: r["launches"] for s, r in mesh["matmul"][
                "4096x4096@4096x4096 bfloat16"]["strategies"].items()},
            "chain": mesh["chain"]["launches"],
            "gpipe": mesh["gpipe"]["launches"]},
        # phase 24: the sharded serves on {"data": 1, "model": 8} (8
        # positions of the card), each counted from 0 just before it (its
        # warmup in it), and one sharded decode step's launches in total
        # and on each position's stream
        "launches_serve_mesh": {
            **{f"{arch} fp32": rec["launches"]
               for arch, rec in serve_mesh["fp32"].items()},
            **{f"{arch} bf16 {name}": run["matmul_launches"]
               for arch, rec in serve_mesh["bf16"].items()
               for name, run in rec["runs"].items()}},
        "launches_serve_mesh_step": {
            arch: {"sharded": rec["step"]["sharded"]["launches"],
                   "by_position": rec["step"]["sharded"][
                       "launches_by_position"],
                   "unsharded": rec["step"]["unsharded"]["launches"]}
            for arch, rec in serve_mesh["bf16"].items()},
        # phase 25: a sharded bf16 training step on 8 positions (counted
        # over its steps and the final loss, per step), the 4-D expert
        # products among them, and one fp32 gradient's
        "launches_train_mesh_step": {
            arch: {k: rec["launches_per_step"][k] for k in (
                "matmul", "matmul_by_position", "batched_by_position",
                "positions")}
            for arch, rec in train_mesh["bf16"].items()},
        "launches_train_mesh_fp32_gradient": {
            arch: {k: rec["launches"][k] for k in (
                "matmul", "matmul_by_position", "batched_by_position",
                "positions")}
            for arch, rec in train_mesh["fp32"].items()},
        # phase 26: seamless-m4t-medium's sharded bf16 training step on 8
        # positions (per step), one fp32 gradient's at 2 + 2 layers, its
        # sharded serves on 2 positions (each counted from 0 just before
        # it) and the compressed steps' (3 steps, with their gradients)
        "launches_encdec_mesh": {
            "train_step": {k: encdec_mesh["bf16"]["launches_per_step"][k]
                           for k in ("matmul", "matmul_by_position",
                                     "positions")},
            "fp32_gradient": {k: encdec_mesh["fp32"]["launches"][k]
                              for k in ("matmul", "matmul_by_position")},
            "serve_fp32": encdec_mesh["serve"]["fp32"]["launches"],
            "serve_bf16": encdec_mesh["serve"]["bf16"]["launches"],
            "compression": encdec_mesh["compression"]["launches"]},
        # phase 26: the products of a position's 128,103-row vocab block
        # (fp32 rows no tensor map loads: the copy loader), timed
        "encdec_vocab_block": encdec_mesh["vocab_block"],
    }, {
        "name": "bitonic_sort", "route": "cuda",
        "design": f"block passes on tiles of "
                  f"2^{bitonic_sort.TILE.bit_length() - 1} in dynamic "
                  f"shared memory, {1 << bitonic_sort.LOG_E} elements a "
                  f"thread in registers, up to {bitonic_sort.LOG_E} stages "
                  f"a register window, one padded exchange between "
                  f"windows; global passes of up to {bitonic_sort.LOG_GROUP}"
                  f" stages, {1 << bitonic_sort.LOG_GROUP} elements a "
                  f"thread ({big['launches_per_call']} launches for "
                  f"2^{big['n_pad'].bit_length() - 1})",
        "source": "src/repro_torch/csrc/bitonic_sort.cu",
        "replaces": "src/repro/kernels/bitonic_sort.py:62",
        "launches": sort_launches,
        "max_abs_err": max(r["max_abs_err"] for r in sort_rows),
        # one 2^26 fp32 array (256 MiB), as distributed_sort's big run
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
        # phase 22: the tile and group at 10^5, 10^6 and 2^26 fp32
        "tuned": tuned("sort"),
        # phase 23: calls of one sample sort on the mesh of 8 shards (a
        # local and a bucket sort a shard), counted from 0 just before it
        "launches_mesh": {
            key: {p: r["launches"] for p, r in mesh["sort"][key][
                "pivots"].items()}
            for key in ("normal_2^24", "skewed", "normal_2^26")},
    }, {
        "name": "flash_attention", "route": "cuda",
        "design": "wgmma bf16 tensor cores fed by TMA, P and dS split into "
                  "bf16 hi + lo, dK/dV per query head summed per kv head "
                  "(bf16 at hd 64, 96 on padded hd-128 tiles, 128, and "
                  "256 with dK/dV split by hd halves); the FP32 FMA "
                  "kernels (fp32; bf16 at hd 16 and 32)",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:86",
        # wrapper calls per training step: forward (each layer, and again
        # in its recomputation) and backward (each layer)
        "launches": train["flash_calls_per_step"],
        # phase 18: forward calls by path in each family's Model.prefill
        # at full width and its served depth in bf16 (SLOTS x PROMPT),
        # counted from 0
        # just before it, and the forward at hd 96 and 256 beside its
        # plain version, SDPA and its bound
        "launches_families_prefill": {
            arch: {"head_dim": rec["prefill"]["head_dim"],
                   "forward": rec["prefill"]["flash_forward_calls"],
                   "by_path": rec["prefill"]["flash_by_path"]}
            for arch, rec in families["serve"].items()},
        # phase 19: the same for moonshot, qwen3-moe and qwen2-vl (hd 128,
        # tensor-core path) at their served depths
        "launches_moe_vlm_prefill": {
            arch: {"head_dim": rec["prefill"]["head_dim"],
                   "forward": rec["prefill"]["flash_forward_calls"],
                   "by_path": rec["prefill"]["flash_by_path"]}
            for arch, rec in moe_vlm["serve"].items()},
        # phase 20: seamless-m4t-medium's Model.prefill (12 encoder
        # non-causal, 12 decoder causal and 12 cross non-causal forward
        # calls) and one profiled training step's calls by direction,
        # mode and path (the recomputation's forwards among them)
        "launches_encdec_prefill": {
            "forward": encdec["serve"]["prefill"]["flash_forward_calls"],
            "by_path": encdec["serve"]["prefill"]["flash_by_path"]},
        "launches_encdec_train_step": encdec["train"]["profile"][
            "flash_calls"],
        # phase 21: each new trainer's profiled bf16 training step, flash
        # calls by direction, mode and path (hd 96, 128 and 256 on the
        # tensor cores; recurrentgemma's windowed layers take none)
        "launches_family_train_step": {
            arch: rec["profile"]["flash_calls"]
            for arch, rec in family_train["train"].items()},
        # phase 24: the sharded Model.prefill of a whole model's layers on
        # each of 8 positions (bf16; none since phase 25 cut its depths),
        # counted from 0 just before
        # it
        "launches_serve_mesh_prefill": {
            arch: {"forward": rec["prefill"]["flash_forward_calls"],
                   "by_path": rec["prefill"]["flash_by_path"]}
            for arch, rec in serve_mesh["bf16"].items() if "prefill" in rec},
        # phase 25: flash calls a sharded bf16 training step on 8
        # positions, each direction, in total and by position
        "launches_train_mesh_step": {
            arch: {k: rec["launches_per_step"][k] for k in (
                "flash_forward", "flash_backward",
                "flash_forward_by_position", "flash_backward_by_position",
                "positions")}
            for arch, rec in train_mesh["bf16"].items()},
        # phase 26: seamless-m4t-medium's sharded bf16 training step (per
        # step) and its sharded fp32 prefill on 2 positions
        "launches_encdec_mesh": {
            "train_step": {k: encdec_mesh["bf16"]["launches_per_step"][k]
                           for k in ("flash_forward", "flash_backward",
                                     "flash_forward_by_position",
                                     "flash_backward_by_position")},
            "serve_prefill": encdec_mesh["serve"]["fp32"]["prefill"][
                "flash_forward_calls"]},
        # phase 7 at hd 96 and 256 (bf16 tensor core, fp32 FMA):
        # phi3-mini's, gemma-2b's and recurrentgemma-2b's training shapes and ragged
        # ones, beside the plain version, SDPA and the bound
        "new_head_dims": [
            {k: r[k] for k in ("shape", "dtype", "path", "max_abs_err",
                               "fwd_ms", "bwd_ms", "fwd_plain_ms",
                               "bwd_plain_ms", "fwd_library_ms",
                               "bwd_library_ms", "bound_ms", "bound_by")}
            for r in new_hd],
        # phase 7's non-causal cases (the encoder's training shape and a
        # ragged cross attention) beside SDPA(is_causal=False) and the bound
        "noncausal": [
            {k: r[k] for k in ("shape", "skv", "dtype", "path", "max_abs_err",
                               "fwd_ms", "bwd_ms", "fwd_plain_ms",
                               "bwd_plain_ms", "fwd_library_ms",
                               "bwd_library_ms", "bound_ms", "bound_by")}
            for r in noncausal],
        "families_forward": [
            {k: r[k] for k in ("shape", "dtype", "path", "max_abs_err", "ms",
                               "plain_ms", "library_ms", "bound_ms",
                               "bound_by")} for r in families["flash"]],
        # and the first call of each signature of phases 18 and 19's
        # bf16 prefills against the plain forward
        "max_abs_err": max([r["max_abs_err"] for r in flash_rows
                            + record["flash_copy_rows"]
                            + families["flash"]] + [
            rec["prefill"]["flash_max_abs_err"]
            for rec in list(families["serve"].values())
            + list(moe_vlm["serve"].values()) + [encdec["serve"]]]),
        # the bf16 training shape, forward plus backward
        "ms": flash_main["fwd_ms"] + flash_main["bwd_ms"],
        "plain_ms": flash_main["fwd_plain_ms"] + flash_main["bwd_plain_ms"],
        "bound_ms": flash_main["bound_ms"],
        "bound_by": flash_main["bound_by"],
        "library_ms": flash_main["fwd_library_ms"]
        + flash_main["bwd_library_ms"],
    }, {
        "name": "wkv", "route": "cuda",
        "design": f"state pass one CTA per (b, h, {wd['state_cols']} value "
                  f"columns), {wd['state_threads']} threads, sequential over "
                  f"the chunks, next chunk by cp.async; per-chunk kernels one "
                  f"CTA per (b, h, chunk), {wd['chunk_threads']} threads; "
                  f"pairwise decay factored by sub-chunks of "
                  f"{wd['subchunk']} rows; FP32 FMA register tiles "
                  f"({len(wkv_k.FORWARD_KERNELS)} launches forward, "
                  f"{len(wkv_k.BACKWARD_KERNELS)} backward)",
        "source": "src/repro_torch/csrc/wkv.cu",
        "replaces": "src/repro/kernels/wkv.py:81",
        # wrapper calls per rwkv6-3b training step: forward (each layer,
        # and again in its recomputation) and backward (each layer)
        "launches": rtrain["wkv_calls_per_step"],
        "cuda_launches": rtrain["wkv_cuda_launches_per_step"],
        "max_abs_err": max(r["max_abs_err"] for r in wkv_rows),
        # the bf16 training shape, forward (keeping the chunk-start states,
        # as training does) plus backward
        "ms": wkv_main["fwd_ms"] + wkv_main["bwd_ms"],
        "plain_ms": wkv_main["fwd_plain_ms"] + wkv_main["bwd_plain_ms"],
        "bound_ms": wkv_main["bound_ms"], "bound_by": wkv_main["bound_by"],
        # no PyTorch call computes the WKV6 recurrence; the packages that
        # do are packages of finished kernels
        "library_ms": None,
        # phase 22: the chunk at rwkv6-3b's training shape, with a gradient
        "tuned": tuned("wkv"),
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_error(ops, ref, a, b, kw) -> tuple:
    """(max abs error, tolerance) of the kernel against its plain version
    on the same operands."""
    return held(ops.matmul(a, b, **kw), ref.matmul_fused_ref(a, b, **kw))


def held(got, want) -> tuple:
    """(max abs error, tolerance) of a matmul result against the plain
    version's: BF16_TOL or F32_TOL x max|plain| by the output's dtype."""
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    return err, (BF16_TOL if want.dtype == torch.bfloat16 else F32_TOL) * top


INVARIANCE_ROWS = (1, 3, 4, 8, 16, 17, 64, 255, 4096)


def invariance_gate(ops, mm, gen, d, f):
    """The batch-invariance contract, bit for bit, on every path: row i of
    a product of M rows (M in INVARIANCE_ROWS; i the first, middle and last
    row) equals that row multiplied alone (torch.equal), for every
    epilogue, with transposed and 4-D operands, at tinyllama-1.1b's widths
    (K = d; N = d_ff, tile 128, and N = d, tile 64), and an fp32 result at
    K 8192, which ops.matmul runs as K blocks (ops.k_blocked: one launch
    a block, the bias in the first).  None on a mismatch."""
    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    bf = torch.bfloat16
    x = rand(4096, d, dtype=bf)
    xt = rand(d, 4096, dtype=bf).t()  # MN-major A, as aᵀ in dB = aᵀ dz
    x32 = rand(4096, d)
    w = {n: rand(d, n, dtype=bf, scale=d ** -0.5) for n in (d, f)}
    bias = rand(f)
    x8k, w8k = rand(4096, 8192, dtype=bf), rand(8192, d, dtype=bf,
                                                 scale=8192 ** -0.5)
    cases = [(f"tensor_core N={n}", x, w[n], {}) for n in (d, f)]
    cases += [(f"tensor_core {act}", x, w[f], dict(activation=act))
              for act in ("relu", "gelu", "silu", "tanh")]
    cases += [
        ("tensor_core bias+silu", x, w[f], dict(bias=bias,
                                                activation="silu")),
        ("tensor_core aᵀ", xt, w[f], {}),
        ("tensor_core bᵀ -> fp32", x, w[f].t().contiguous().t(),
         dict(out_dtype=torch.float32)),
        ("split A gelu -> bf16", x32, w[f], dict(activation="gelu",
                                                  out_dtype=bf)),
        ("split A N=d -> fp32", x32, w[d], dict(out_dtype=torch.float32)),
        ("split B aᵀ dz", xt, rand(d, f), dict(out_dtype=bf)),
        ("fma tanh", x32, w[f].float(), dict(activation="tanh")),
        ("tensor_core K=8192 bias -> fp32 (K blocks)", x8k, w8k,
         dict(bias=bias[:d], out_dtype=torch.float32)),
    ]
    blocks = -(-8192 // ops.TC_K_BLOCK)
    before = mm.LAUNCHES.count
    ops.matmul(x8k[:1], w8k, out_dtype=torch.float32)
    if mm.LAUNCHES.count - before != blocks:
        log("invariance", f"FAIL K=8192 -> fp32: "
            f"{mm.LAUNCHES.count - before} launches, expected {blocks} K "
            f"blocks of {ops.TC_K_BLOCK}")
        return None
    checked = {}
    for name, a, b, kw in cases:
        path = mm.choose_path(a.dtype, b.dtype)
        for m in INVARIANCE_ROWS:
            whole = ops.matmul(a[:m], b, **kw)
            for i in sorted({0, m // 2, m - 1}):
                if not torch.equal(whole[i:i + 1],
                                   ops.matmul(a[i:i + 1], b, **kw)):
                    log("invariance", f"FAIL {name} ({path}): row {i} of "
                        f"{m} differs from the row alone")
                    return None
                checked[path] = checked.get(path, 0) + 1
    # 4-D: the decode-attention contractions, one query row alone
    cache = rand(4, 96, 4, 64, dtype=bf)
    for name, q, kv in (("q.k", rand(4, 4, 17, 64), cache.permute(0, 2, 3, 1)),
                        ("p.v", torch.softmax(rand(4, 4, 17, 96), -1),
                         cache.permute(0, 2, 1, 3))):
        for qq in (q, q.to(bf)):
            path = mm.choose_path(qq.dtype, kv.dtype)
            for m in (1, 4, 8, 17):
                whole = ops.matmul(qq[:, :, :m], kv, out_dtype=torch.float32)
                for i in sorted({0, m - 1}):
                    alone = ops.matmul(qq[:, :, i:i + 1], kv,
                                       out_dtype=torch.float32)
                    if not torch.equal(whole[:, :, i:i + 1], alone):
                        log("invariance", f"FAIL 4-D {name} ({path}): row "
                            f"{i} of {m} differs from the row alone")
                        return None
                    checked[path] = checked.get(path, 0) + 1
    log("invariance", f"rows bit-identical alone and in products of "
        f"{list(INVARIANCE_ROWS)} rows: {checked} comparisons by path "
        f"({len(cases)} 2-D cases, every epilogue, aᵀ, bᵀ, K 8192 -> fp32 "
        f"in {blocks} K blocks, 4-D cache views)")
    if set(checked) != set(mm.PATHS):
        return None
    return checked


# (path, part of the kernel name) of each source's kernels, the first
# match naming the path
MATMUL_PTXAS_KINDS = (("split", "matmul_wgmma_split"),
                      ("tensor_core", "matmul_wgmma"), ("fma", "matmul_kernel"))
FLASH_PTXAS_KINDS = (("tensor_core", "repro_flash_tc_"), ("fma", "flash_"))
# the tensor-core kernels: forward, dQ and dK/dV at hd 64, 96, 128 and 256,
# and the group sum
FLASH_TC_KERNELS = 3 * 4 + 1
# the fp32 FMA backward's instantiations at hd 96 and 256, by kernel and
# head dim, as their mangled names hold them (hd 256 with 32-row kv tiles:
# Li256ELi32E)
FLASH_NEW_BWD_KINDS = tuple(
    (f"{kernel} hd {hd} fp32", f"flash_bwd_{kernel}IfLi{hd}E")
    for kernel in ("dq", "dkv") for hd in (96, 256))
# a bf16 FMA kernel above hd 32, which no call reaches since bf16 at hd 64,
# 96, 128 and 256 takes the tensor cores: phase 1 fails if one is built
FLASH_FMA_BF16_DEAD = (r"Compiling entry function '\w*flash_"
                       r"(fwd|bwd_dq|bwd_dkv)I13__nv_bfloat16"
                       r"Li(64|96|128|256)E")


def flash_path(dtype, hd: int) -> str:
    """The flash kernels' routing rule, stated apart from the wrapper's
    choose_path: bf16 at hd 64, 96, 128 and 256 on the tensor cores,
    everything else (fp32; bf16 at hd 16 and 32) on the FMA kernels."""
    return "tensor_core" if dtype == torch.bfloat16 and hd in (
        64, 96, 128, 256) else "fma"
# the sort kernel's device-side names (bitonic_sort.cu), by launch kind
SORT_KERNELS = ("first_block_pass", "global_pass", "finish_block_pass")
SORT_PTXAS_KINDS = (("block", "block_pass"), ("global", "global_pass"))


def ptxas_summary(text, kinds=MATMUL_PTXAS_KINDS) -> dict:
    """Registers, spills, static shared memory and serialized-wgmma notices
    of one source's kernels by path (``kinds``: matmul.cu's by default),
    from ``nvcc -Xptxas -v``: the C7520 notices (wgmma serialized on a
    path ptxas cannot prove uniform) counted, and every C75xx code (wgmma
    serialized for any reason, setmaxnreg ignored) listed."""
    out = {}

    def kind_of(line):
        return next((p for p, key in kinds if key in line), None)

    def row_of(kind):
        return out.setdefault(kind, dict(kernels=0, registers=[999, 0],
                                         spill_bytes=0, smem="none",
                                         serialized_wgmma=0, notices=[]))

    kind = None
    for line in text.splitlines():
        code = re.search(r"\((C75\d\d)\)", line)
        if code and kind_of(line):  # ptxas: this function's wgmma serialized
            row = row_of(kind_of(line))
            row["notices"].append(code.group(1))
            row["serialized_wgmma"] += code.group(1) == "C7520"
        elif "Compiling entry function" in line:
            kind = kind_of(line)
            if kind:
                row_of(kind)["kernels"] += 1
        elif kind and "spill" in line:
            nums = [int(v) for v in re.findall(r"(\d+) bytes spill", line)]
            out[kind]["spill_bytes"] = max([out[kind]["spill_bytes"]] + nums)
        elif kind and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            r = out[kind]["registers"]
            r[0], r[1] = min(r[0], regs), max(r[1], regs)
            found = re.search(r"(\d+) bytes smem", line)
            if found:
                out[kind]["smem"] = f"{found.group(1)} bytes static"
            elif kind in ("tensor_core", "split"):
                out[kind]["smem"] = "dynamic (TcShape::kSmem)"
            else:
                out[kind]["smem"] = "dynamic"
    return out


def sort_case(shape, dtype, gen, ops, ref, bitonic_sort, flush):
    """Hold the sort kernel at ``shape`` against its plain version and
    torch.sort (exactly equal), and time all three beside the bound.  None
    if they disagree."""
    x = torch.randn(shape, generator=gen, device="cuda") * 1e4
    x = x.to(dtype)
    n = shape[-1]
    padded = ops._sort_pad(x.view(-1, n))  # the kernel's input, as ops.sort
    rows, n_pad = padded.shape
    grids = bitonic_sort.LAUNCHES.grids
    got = ops.sort(x)
    grids = bitonic_sort.LAUNCHES.grids - grids
    plain = ref.bitonic_sort_ref(padded)[:, :n].reshape(shape)
    lib = torch.sort(x, dim=-1).values
    exact = torch.equal(got, plain) and torch.equal(got, lib)
    err = (got.double() - plain.double()).abs().max().item()
    name = f"{tuple(shape)} {dtype}".replace("torch.", "")
    if not exact or grids != bitonic_sort.grid_launches(n_pad):
        log("sort", f"FAIL {name}: kernel == plain == torch.sort is {exact}, "
            f"max abs err {err:.3e}; {grids} CUDA launches, expected "
            f"{bitonic_sort.grid_launches(n_pad)}")
        return None
    big = rows * n_pad >= 1 << 24
    reps, warm = (3, 1) if big else (10, 2)
    k_ms = cuda_ms(lambda: bitonic_sort.bitonic_sort_cuda(padded), flush,
                   reps, warm)
    p_ms = cuda_ms(lambda: ref.bitonic_sort_ref(padded), flush,
                   2 if big else reps, 1)
    l_ms = cuda_ms(lambda: torch.sort(x, dim=-1), flush, reps, warm)
    # each element read once and written once; the n log2 n comparisons
    # any comparison sort makes, at the fp32 rate
    t_bytes = 2 * rows * n_pad * x.element_size() / HBM_BW * 1e3
    t_ops = rows * n_pad * math.log2(n_pad) / F32_PEAK * 1e3
    # the schedule's own bound: every pass reads and writes the array once
    row = dict(shape=list(shape), dtype=str(dtype).replace("torch.", ""),
               n_pad=n_pad, launches_per_call=grids, max_abs_err=err,
               ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               schedule_bound_ms=grids * t_bytes)
    log("sort", f"{name:24s} n_pad {n_pad:>9d}: kernel == plain == "
        f"torch.sort; kernel {k_ms:.4g} ms ({grids} launches)  plain "
        f"{p_ms:.4g} ms  torch.sort {l_ms:.4g} ms  bound "
        f"{row['bound_ms']:.4g} ms ({row['bound_by']}), schedule bound "
        f"{row['schedule_bound_ms']:.4g} ms ({grids} passes); cold L2")
    return row


def sort_hard_inputs(bitonic_sort, ref) -> bool:
    """The sort kernel bit for bit (compared as int32: -0.0 is not +0.0,
    NaN is itself) its plain version on hard values, fp32 and int32: small
    integers (duplicates), -0.0 beside +0.0, +-inf and NaN, the int32
    extremes, sorted and reversed rows; at n = 2, T/2, T, 2T, the first n
    with a k whose global stages end in a group of 1 after a full one, and
    several rows below and above the tile, and a view not 16-byte
    aligned.  Every call's launches equal grid_launches; torch.sort beside
    them where every value is finite."""
    tile, ok = bitonic_sort.TILE, True
    short = tile << (bitonic_sort.LOG_GROUP + 1)
    g = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.int32):
        cases = []
        for rows, n in [(1, 2), (1, tile // 2), (1, tile), (1, 2 * tile),
                        (1, short), (3, tile // 4), (3, 2 * tile)]:
            x = torch.randint(-4, 5, (rows, n), generator=g, device="cuda")
            pick = torch.randint(0, 16, (rows, n), generator=g, device="cuda")
            if dtype == torch.int32:
                x = torch.where(pick == 0, -2**31, x)
                x = torch.where(pick == 1, 2**31 - 1, x).to(torch.int32)
            else:
                x = x.float()
                x = torch.where((x == 0) & (pick < 8), -0.0, x)
                for v, special in enumerate((float("nan"), float("inf"),
                                             -float("inf"))):
                    x = torch.where(pick == 8 + v, special, x)
            cases.append((f"hard ({rows}, {n})", x))
        ramp = torch.arange(1 << 16, device="cuda").to(dtype).view(1, -1)
        cases += [("sorted (1, 65536)", ramp),
                  ("reversed (1, 65536)", ramp.flip(1).contiguous()),
                  # 4 bytes past an allocation: the fill's element path
                  ("misaligned (1, 2T)", torch.cat(
                      [cases[3][1][0, :1], cases[3][1][0]])[1:].view(1, -1))]
        for name, x in cases:
            grids = bitonic_sort.LAUNCHES.grids
            got = bitonic_sort.bitonic_sort_cuda(x)
            grids = bitonic_sort.LAUNCHES.grids - grids
            want = ref.bitonic_sort_ref(x)
            bits = torch.equal(got.view(torch.int32), want.view(torch.int32))
            finite = dtype == torch.int32 or bool(torch.isfinite(x).all())
            lib = torch.equal(got, torch.sort(x, dim=-1).values) \
                if finite else None
            good = bits and lib is not False and \
                grids == bitonic_sort.grid_launches(x.shape[1])
            ok &= good
            log("sort", f"{'ok' if good else 'FAIL'} {name} "
                f"{str(dtype)[6:]}: bits equal to the plain network "
                f"{bits}, torch.sort {'-' if lib is None else lib}, "
                f"{grids} launches")
    return ok


def sort_stages(gen, sort) -> dict:
    """Where one 2^26 fp32 ``sort(x)``'s device time goes, by the kernel's
    launch kinds (torch.profiler): the first block pass, the global passes,
    the finishing block passes; each with its launches and HBM rate (one
    read and one write of the array a launch)."""
    x = torch.randn((1, 1 << 26), generator=gen, device="cuda")
    nbytes = 2 * x.numel() * x.element_size()
    sort(x)  # warm
    counts = {}
    by_name, events = device_ms_by_kernel(lambda: sort(x), counts)
    kinds = {}
    for name, ms in by_name.items():
        kind = next((k for k in SORT_KERNELS if k in name), name)
        row = kinds.setdefault(kind, dict(launches=0, ms=0.0))
        row["launches"] += counts[name]
        row["ms"] += ms
    for row in kinds.values():
        row["tb_per_s"] = row["launches"] * nbytes / row["ms"] / 1e9
    total = sum(by_name.values())
    if not events:
        log("sort", "one 2^26 fp32 call by launch kind: not measured (the "
            "profiler saw no kernels)")
    else:
        log("sort", f"one 2^26 fp32 call by torch.profiler, {events} "
            f"device events: " + "; ".join(
                f"{k} {v['launches']} launches {v['ms']:.3f} ms "
                f"({v['ms'] / v['launches']:.4f} ms, {v['tb_per_s']:.2f} "
                f"TB/s a launch)" for k, v in kinds.items())
            + f"; total {total:.3f} ms")
    return dict(events=events, kinds=kinds, total_ms=total)


def profile_events(prof, device=None) -> list:
    """[(demangled name, ms)] of a finished torch.profiler run's events on
    ``device`` (a torch.autograd.DeviceType; CUDA by default), each kernel
    once, read straight from the profiler's kineto results:
    ``prof.events()`` first builds the tree of every host event, seconds
    for a training step's hundreds of thousands.  Those results are
    private to PyTorch, read as torch 2.11 and 2.13 have them
    (``device_type()``, ``name()``, ``duration_ns()``,
    ``is_hidden_event()``); tests/test_torch_flash.py holds the names on
    the CPU and on a card."""
    from torch.autograd import DeviceType

    device = DeviceType.CUDA if device is None else device
    return [(torch._C._demangle(ev.name()), ev.duration_ns() / 1e6)
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == device and not getattr(
                ev, "is_hidden_event", lambda: False)()]


def device_ms_by_kernel(run, counts=None) -> tuple:
    """({kernel name: device ms}, device events) of what ``run()``
    launches, from torch.profiler (profile_events); ``counts``, where
    given, gets each name's number of launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name = {}
    events = profile_events(prof)
    for name, ms in events:
        by_name[name] = by_name.get(name, 0.0) + ms
        if counts is not None:
            counts[name] = counts.get(name, 0) + 1
    return by_name, len(events)


def step_matmuls(model, params, state, feed, ops) -> list:
    """Run one decode step and return every ``ops.matmul`` call it made as
    (a, b, keyword arguments); the list keeps the operands alive."""
    calls, launch = [], ops.matmul

    def recording(a, b, **kw):
        calls.append((a, b, kw))
        return launch(a, b, **kw)

    ops.matmul = recording
    try:
        model.decode_step(params, state, feed)
    finally:
        ops.matmul = launch
    return calls


def replay_step(calls, ops, ref, flush):
    """Hold one decode step's matmul calls (the model's own weights for
    every layer, in the step's order) against the plain version, time both
    replays, and add up the bound of the same work.  None if a call
    disagrees."""
    worst, worst_call = 0.0, None
    for a, b, kw in calls:
        err, tol = kernel_error(ops, ref, a, b, kw)
        call = f"{tuple(a.shape)} @ {tuple(b.shape)} {kw}"
        if not err <= tol:
            log("step", f"FAIL {call}: max abs err {err:.3e} > {tol:.3e}")
            return None
        if err >= worst:
            worst, worst_call = err, f"{call}: {err:.3e} (tol {tol:.3e})"

    def run_kernel():
        for a, b, kw in calls:
            ops.matmul(a, b, **kw)

    def run_plain():
        for a, b, kw in calls:
            ref.matmul_fused_ref(a, b, **kw)

    # the calls one torch.matmul computes: no epilogue, one dtype in and out
    plain_calls = [(a, b, kw) for a, b, kw in calls
                   if kw.get("bias") is None and kw.get("activation") is None
                   and a.dtype == b.dtype == (kw.get("out_dtype") or a.dtype)]

    def run_library():
        for a, b, _ in plain_calls:
            torch.matmul(a, b)

    def run_kernel_on_those():
        for a, b, kw in plain_calls:
            ops.matmul(a, b, **kw)

    terms = [bound_terms(a, b, kw.get("out_dtype") or a.dtype)
             for a, b, _ in calls]
    t_ops, t_bytes = sum(t[0] for t in terms), sum(t[1] for t in terms)
    run_plain()  # warm the allocator before the profiled replay
    run_library()
    plain_by_name, _ = device_ms_by_kernel(run_plain)
    kernel_by_name, _ = device_ms_by_kernel(run_kernel)
    library_by_name, _ = device_ms_by_kernel(run_library)
    subset_by_name, _ = device_ms_by_kernel(run_kernel_on_those)
    return dict(max_abs_err=worst, worst_call=worst_call, calls=len(calls),
                plain_device_ms=sum(plain_by_name.values()),
                kernel_replay_device_ms=sum(kernel_by_name.values()),
                library_calls=len(plain_calls),
                library_device_ms=sum(library_by_name.values()),
                kernel_device_ms_on_library_calls=sum(
                    subset_by_name.values()),
                kernel_window_ms=cuda_ms(run_kernel, flush, reps=3, warm=1),
                plain_window_ms=cuda_ms(run_plain, flush, reps=3, warm=1),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def profile_decode_step(model, params, state, feed) -> dict:
    """Where one decode step's time goes: its wall time (host clock around
    synchronized steps, profiler off) against the device time of the
    kernels it launches (torch.profiler), split into the matmul kernel and
    everything else."""
    wall_ms = step_wall(model, params, state, feed)
    by_name, n_kernels = device_ms_by_kernel(
        lambda: model.decode_step(params, state, feed))
    device_ms = sum(by_name.values())
    groups = group_device_ms(by_name, {})
    matmul_ms = groups["matmul"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    if device_ms == 0:
        log("profile", f"one decode step ({SLOTS} slots): wall {wall_ms:.3f} "
            f"ms; device time not measured (the profiler saw no kernels)")
    else:
        log("profile", f"one decode step ({SLOTS} slots): wall {wall_ms:.3f} "
            f"ms, device busy {device_ms:.3f} ms "
            f"({100 * device_ms / wall_ms:.1f}% of wall), matmul kernel "
            f"{matmul_ms:.3f} ms, other kernels {device_ms - matmul_ms:.3f} ms; "
            f"{n_kernels} device events under {len(by_name)} kernel names")
        log("profile", "  matmul by path: " + ", ".join(
            f"{g[7:]} {groups[g]:.3f} ms" for g in MATMUL_KERNELS))
    for name, ms in top:
        log("profile", f"  {ms:8.3f} ms  {name[:90]}")
    return dict(wall_ms=wall_ms, device_ms=device_ms, matmul_ms=matmul_ms,
                matmul_ms_by_path={g[7:]: groups[g] for g in MATMUL_KERNELS},
                library_gemms=library_gemms("profile", by_name),
                device_events=n_kernels, top=top)


def flash_case(shape, gen, ref, fa, flush):
    """Hold the flash kernels at ``shape`` against their plain versions,
    forward and backward on the same inputs (the backward fed the plain
    forward's output and log-sum-exp), and the forward against
    flash_attention_ref; time each beside the plain version,
    scaled_dot_product_attention (and its backward) and the bound.  None
    if they disagree."""
    import torch.nn.functional as F

    b, s, hq, hkv, hd, dtype_name, *mode = shape
    skv, causal = mode or (s, True)
    dt = getattr(torch, dtype_name)
    q, k, v, do = (torch.randn((b, rows, h, hd), generator=gen,
                               device="cuda").to(dt)
                   for rows, h in ((s, hq), (skv, hkv), (skv, hkv), (s, hq)))
    path = flash_path(dt, hd)
    mode = "causal" if causal else "non-causal"
    modes = (f"forward {mode} {path}", f"backward {mode} {path}")
    before = (fa.LAUNCHES.forward, fa.LAUNCHES.backward, fa.LAUNCHES.grids,
              fa.LAUNCHES.by_path[path], fa.LAUNCHES.copied_operands,
              *(fa.LAUNCHES.by_mode[m] for m in modes))
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, causal)
    o_p, lse_p = ref.flash_attention_fwd_plain(q, k, v, causal)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o_p, lse_p, do, causal)
    grads_p = ref.flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, causal)
    calls = (fa.LAUNCHES.forward - before[0], fa.LAUNCHES.backward - before[1],
             fa.LAUNCHES.grids - before[2], fa.LAUNCHES.by_path[path]
             - before[3], fa.LAUNCHES.copied_operands - before[4],
             *(fa.LAUNCHES.by_mode[m] - n for m, n in zip(modes, before[5:])))
    # the backward again on the same inputs: the same bits (no atomics, a
    # fixed order for the group sums)
    again = fa.flash_attention_bwd_cuda(q, k, v, o_p, lse_p, do, causal)
    repeat = all(torch.equal(x, y) for x, y in zip(grads, again))
    # the chain as training runs it: the kernel backward fed the kernel
    # forward's o and lse, against the plain chain
    chained = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    del again
    g = hq // hkv
    fold = lambda t: t.repeat_interleave(  # noqa: E731
        hq // t.shape[2], dim=2).transpose(1, 2).reshape(
            b * hq, t.shape[1], hd)
    oracle = ref.flash_attention_ref(fold(q), fold(k), fold(v),
                                     causal=causal)
    torch.cuda.synchronize()
    errs, worst = {}, 0.0
    for name, got, want in [("o", o, o_p), ("lse", lse, lse_p),
                            ("o vs flash_attention_ref", fold(o), oracle),
                            *zip(("dq", "dk", "dv"), grads, grads_p)]:
        err, ratio = flash_error(got, want)
        errs[name] = dict(err=err, of_limit=ratio)
        worst = max(worst, err)
        if not ratio <= 1.0:
            log("flash", f"FAIL {shape} {name}: max abs err {err:.3e}, "
                f"{ratio:.2f} x its limit")
            return None
    grids = 4 if path == "tensor_core" else 3
    chain_tol = FLASH_F32_TOL if dt == torch.float32 else FLASH_CHAIN_TOL
    for name, got, want in zip(("dq", "dk", "dv"), chained, grads_p):
        err = (got.float() - want.float()).abs().max().item()
        ratio = err / (chain_tol * want.float().abs().max().item())
        errs[f"chained {name}"] = dict(err=err, of_limit=ratio)
        if not ratio <= 1.0:
            log("flash", f"FAIL {shape} chained {name}: max abs err "
                f"{err:.3e}, {ratio:.2f} x its limit")
            return None
    del chained
    if calls != (1, 1, grids, 2, 0, 1, 1):
        log("flash", f"FAIL {shape}: wrapper calls (forward, backward, CUDA "
            f"launches, on the {path} path, operands copied, {modes[0]}, "
            f"{modes[1]}) {calls}, expected (1, 1, {grids}, 2, 0, 1, 1)")
        return None
    if not repeat:
        log("flash", f"FAIL {shape}: a second backward on the same inputs "
            f"gave other bits")
        return None

    # SDPA on the same tensors, heads second, as a yardstick only
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa(qq, kk, vv):
        return F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal,
                                              enable_gqa=True)

    leaves = [t.detach().clone().requires_grad_(True) for t in (qt, kt, vt)]
    out_lib = sdpa(*leaves)
    do_t = do.transpose(1, 2)
    big = s >= 1024
    reps = 5 if big else 10
    times = dict(
        fwd_ms=cuda_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v, causal),
                       flush, reps),
        fwd_plain_ms=cuda_ms(lambda: ref.flash_attention_fwd_plain(
            q, k, v, causal), flush, reps),
        fwd_library_ms=cuda_ms(lambda: sdpa(qt, kt, vt), flush, reps),
        bwd_ms=cuda_ms(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, o_p, lse_p, do, causal), flush, reps),
        bwd_plain_ms=cuda_ms(lambda: ref.flash_attention_bwd_plain(
            q, k, v, o_p, lse_p, do, causal), flush, reps),
        bwd_library_ms=cuda_ms(lambda: torch.autograd.grad(
            out_lib, leaves, do_t, retain_graph=True), flush, reps))
    # the pairs a query sees (causal: col <= row, else every key); the
    # forward's two products, the backward's at 2.5x; each input read
    # once, each output written once
    pairs = b * hq * s * (s + 1) / 2 if causal else b * hq * s * skv
    flops_f = 4.0 * pairs * hd
    flops_b = 2.5 * flops_f
    peak = BF16_PEAK if dt == torch.bfloat16 else F32_PEAK
    esz = q.element_size()
    n_q, n_kv = q.numel(), k.numel()
    bytes_f = esz * (2 * n_q + 2 * n_kv) + 4 * b * hq * s  # q k v o, lse
    bytes_b = esz * (3 * n_q + 2 * n_kv) + 4 * b * hq * s \
        + esz * (n_q + 2 * n_kv)  # q k v o do lse in, dq dk dv out
    t_ops = (flops_f + flops_b) / peak * 1e3
    t_bytes = (bytes_f + bytes_b) / HBM_BW * 1e3
    row = dict(shape=list(shape[:5]), dtype=dtype_name, skv=skv,
               causal=causal, group=g, path=path,
               backward_bits_repeat=repeat,
               max_abs_err=worst, errors=errs, launches=dict(
                   forward_calls=1, backward_calls=1, cuda_launches=grids),
               fwd_bound_ms=max(flops_f / peak, bytes_f / HBM_BW) * 1e3,
               bwd_bound_ms=max(flops_b / peak, bytes_b / HBM_BW) * 1e3,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               fwd_tflops=flops_f / times["fwd_ms"] / 1e9,
               bwd_tflops=flops_b / times["bwd_ms"] / 1e9, **times)
    log("flash", f"{tuple(shape[:5])} {dtype_name} Skv {skv} "
        f"{'causal' if causal else 'non-causal'} ({path} path; backward "
        f"bits repeat): kernel == plain within tol (worst {worst:.2e}; "
        + ", ".join(
            f"{k} {e['err']:.1e} = {e['of_limit']:.2f} x limit"
            for k, e in errs.items())
        + ")")
    log("flash", f"  forward: kernel {times['fwd_ms']:.4f} ms "
        f"({row['fwd_tflops']:.2f} TFLOP/s)  plain {times['fwd_plain_ms']:.4f}"
        f" ms  sdpa {times['fwd_library_ms']:.4f} ms  bound "
        f"{row['fwd_bound_ms']:.4f} ms; 1 launch; cold L2")
    log("flash", f"  backward: kernel {times['bwd_ms']:.4f} ms "
        f"({row['bwd_tflops']:.2f} TFLOP/s)  plain {times['bwd_plain_ms']:.4f}"
        f" ms  sdpa {times['bwd_library_ms']:.4f} ms  bound "
        f"{row['bwd_bound_ms']:.4f} ms; {grids - 1} launches; cold L2")
    return row


def flash_copy_case(hd, gen, ref, fa):
    """The tensor-core kernels on operands no tensor map describes (q
    strided in hd, k at a pitch of hd + 1), which the producer's copy
    loader brings in, zero-filling hd 96's padded columns itself: the
    forward and backward against their plain versions by phase 7's bf16
    rule, four operands copied.  The row, or None if they disagree."""
    b, s, hq, hkv = 2, 150, 8, 2
    q = torch.randn((b, s, hq, 2 * hd), generator=gen,
                    device="cuda").to(torch.bfloat16)[..., ::2]
    k = torch.randn((b, s, hkv, hd + 1), generator=gen,
                    device="cuda").to(torch.bfloat16)[..., :hd]
    v, do = (torch.randn((b, s, h, hd), generator=gen, device="cuda")
             .to(torch.bfloat16) for h in (hkv, hq))
    before = fa.LAUNCHES.copied_operands
    o, lse = fa.flash_attention_fwd_cuda(q, k, v)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    copied = fa.LAUNCHES.copied_operands - before
    o_p, lse_p = ref.flash_attention_fwd_plain(q, k, v)
    grads_p = ref.flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    errs = {name: flash_error(got, want) for name, got, want in [
        ("o", o, o_p), ("lse", lse, lse_p),
        *zip(("dq", "dk", "dv"), grads, grads_p)]}
    shown = ", ".join(f"{k} {e:.1e} = {r:.2f} x limit"
                      for k, (e, r) in errs.items())
    if copied != 4 or not all(r <= 1.0 for _, r in errs.values()):
        log("flash", f"FAIL copy loader hd {hd} {(b, s, hq, hkv)}: {copied} "
            f"operands copied (expected 4: q and k, each way); {shown}")
        return None
    log("flash", f"copy loader hd {hd} {(b, s, hq, hkv)} bf16 (q strided, k "
        f"at pitch {hd + 1}; 4 operands copied): kernel == plain within tol "
        f"({shown})")
    return dict(hd=hd, shape=[b, s, hq, hkv, hd], copied=copied,
                max_abs_err=max(e for e, _ in errs.values()))


def train_parity(cfg, leaves=None):
    """One training step of the full-width model cut to 2 layers, in fp32,
    on the card and on the CPU from the same parameters and batch: the
    loss within 1e-4 relative and every gradient within 2e-3 x max|grad|
    of the CPU's, leaf by leaf (``leaves`` of them, where given).  None on
    a mismatch."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.training import (TrainLoopConfig, init_train_state,
                                      make_grad_fn, make_train_step)
    from repro_torch.tree import leaves_with_paths, tree_map

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    loop = TrainLoopConfig(warmup_steps=1, total_steps=4)
    batch = SyntheticLMData(cfg2, seq_len=PARITY_SEQ, global_batch=2,
                            seed=0).batch_at(0)
    out = {}
    state = None
    for where in ("cuda", "cpu"):
        model = build_model(cfg2, where)
        if state is None:
            state = init_train_state(model, 0, loop)
        else:
            state = tree_map(lambda t: t.cpu(), state)
        feed = {k: v.to(where) for k, v in batch.items()}
        t0 = time.perf_counter()
        _, metrics = make_train_step(model, loop)(state, feed)
        loss, _, grads = make_grad_fn(model)(state["params"], feed)
        if where == "cuda":
            torch.cuda.synchronize()
        out[where] = dict(step_loss=float(metrics["loss"]), loss=float(loss),
                          grads=dict(leaves_with_paths(grads)),
                          s=time.perf_counter() - t0)
    gpu, cpu = out["cuda"], out["cpu"]
    rel = abs(gpu["step_loss"] - cpu["step_loss"]) / abs(cpu["step_loss"])
    worst, worst_leaf = 0.0, None
    for path, gc in cpu["grads"].items():
        gg = gpu["grads"].get(path)
        if gg is None or not gg.is_cuda:
            log("train-parity", f"FAIL {path}: no gradient on the card")
            return None
        top = gc.abs().max().item()
        err = (gg.cpu() - gc).abs().max().item()
        if not err <= 2e-3 * top:
            log("train-parity", f"FAIL {path}: gradient err {err:.3e} > "
                f"{2e-3 * top:.3e}")
            return None
        if top > 0 and err / top >= worst:
            worst, worst_leaf = err / top, path
    log("train-parity", f"{cfg.name} full width, 2 layers, fp32, batch "
        f"2 x {PARITY_SEQ}: loss card {gpu['step_loss']:.6f}, cpu "
        f"{cpu['step_loss']:.6f} (rel {rel:.2e}, limit 1e-4); "
        f"{len(cpu['grads'])} gradients on the card, worst leaf {worst_leaf}"
        f" at {worst:.2e} x max|grad| (limit 2e-3); card {gpu['s']:.2f} s, "
        f"cpu {cpu['s']:.2f} s (one step + one gradient each)")
    if not rel <= 1e-4 or (leaves is not None
                           and len(cpu["grads"]) != leaves):
        log("train-parity", f"FAIL: loss rel err {rel:.2e} (limit 1e-4) or "
            f"{len(cpu['grads'])} gradients where {leaves} were expected")
        return None
    return dict(loss_cuda=gpu["step_loss"], loss_cpu=cpu["step_loss"],
                rel_err=rel, leaves=len(cpu["grads"]), worst_leaf=worst_leaf,
                worst_rel=worst)


def tma_flags(a, b, path) -> dict:
    """Whether a tensor map loads each operand of a tensor-core call: the
    operand itself (bf16), or for an fp32 operand of the split path its
    bf16 halves, which keep its strides (a meta tensor of those strides
    stands in for them; a fresh allocation is aligned).  None on the FMA
    path, which loads through no tensor map."""
    from repro_torch.kernels import matmul as mm

    if path == "fma":
        return None

    def bf16(t):
        return t if t.dtype == torch.bfloat16 else torch.empty_strided(
            t.shape, t.stride(), dtype=torch.bfloat16, device="meta")

    return {"a": mm.operand_mode(bf16(a), "a")[1],
            "b": mm.operand_mode(bf16(b), "b")[1]}


def train_matmuls(cfg, ops, ref, flush, label="backward", timed=True):
    """Every distinct matmul call of one training gradient of the
    full-width model in bf16 at batch 2 x 2048, cut to one period of its
    block pattern (1 layer, an encoder-decoder 1 + 1, recurrentgemma 3:
    every later layer repeats one of the period's calls), held
    against the plain version on the call's own operands, its path checked
    against its dtypes, which operands a tensor map loads (``tma``), and
    timed (CUDA events, cold L2) beside torch.matmul where both operands
    are bf16 (a yardstick only).  A call is its shapes, strides, dtypes
    and epilogue, so the backward's products through transposed strides
    and with fp32 gradients against bf16 operands are among them; a
    mixed-dtype call is also timed beside torch.matmul of both operands in
    fp32 (no TF32).  ``timed=False`` holds and routes every call but times
    none (phase 21: its time went to phase 23).  None on a mismatch, or if
    no such product was seen."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import matmul as mm
    from repro_torch.models import build_model
    from repro_torch.training import TrainLoopConfig, make_grad_fn
    from repro_torch.training import init_train_state

    cfg1 = dataclasses.replace(cfg, n_layers=len(cfg.block_pattern),
                               encoder_layers=min(cfg.encoder_layers, 1))
    model = build_model(cfg1, "cuda")
    params = init_train_state(model, 0, TrainLoopConfig())["params"]
    batch = SyntheticLMData(cfg1, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                            seed=0, device="cuda").batch_at(0)
    rows, failed, launch = {}, [], ops._matmul

    def checking(a, b, bias, activation, out_dtype, tuner=None):
        out = launch(a, b, bias, activation, out_dtype, tuner)
        key = (tuple(a.shape), a.stride(), str(a.dtype), tuple(b.shape),
               b.stride(), str(b.dtype), bias is not None, activation,
               str(out_dtype))
        if key not in rows:
            err, tol = held(out, ref.matmul_fused_ref(
                a, b, bias=bias, activation=activation, out_dtype=out_dtype))
            k_ms = cuda_ms(lambda: launch(a, b, bias, activation, out_dtype),
                           flush, reps=5, warm=1) if timed else None
            lib = timed and a.dtype == b.dtype == torch.bfloat16
            tflops, gbs = rates(a, b, out.dtype, k_ms) if timed else \
                (None, None)
            t_ops, t_bytes = bound_terms(a, b, out.dtype)
            path = mm.choose_path(a.dtype, b.dtype)
            rows[key] = dict(a=list(a.shape), a_stride=list(a.stride()),
                             a_dtype=str(a.dtype), b=list(b.shape),
                             b_stride=list(b.stride()), b_dtype=str(b.dtype),
                             bias=bias is not None, activation=activation,
                             out_dtype=str(out.dtype), err=err, tol=tol,
                             path=path, tma=tma_flags(a, b, path), ms=k_ms,
                             tflops=tflops, gb_per_s=gbs,
                             bound_ms=max(t_ops, t_bytes),
                             torch_matmul_ms=cuda_ms(
                                 lambda: torch.matmul(a, b), flush, reps=5,
                                 warm=1) if lib else None,
                             torch_matmul_fp32_ms=None)
            if timed and a.dtype != b.dtype:  # the same product by torch.matmul in
                af, bf = a.float(), b.float()  # fp32 (no TF32), a yardstick
                rows[key]["torch_matmul_fp32_ms"] = cuda_ms(
                    lambda: torch.matmul(af, bf), flush, reps=5, warm=1)
                del af, bf
            if not err <= tol:
                failed.append(rows[key])
        return out

    ops._matmul = checking
    try:
        with RouteAudit(ops, mm) as audit:
            make_grad_fn(model)(params, batch)
    finally:
        ops._matmul = launch
    calls = list(rows.values())
    transposed = [r for r in calls if any(
        r[x + "_stride"][1] != 1 and r[x][1] > 1 for x in "ab")]
    mixed = [r for r in calls if r["a_dtype"] != r["b_dtype"]]
    for r in calls:
        log(label, f"{tuple(r['a'])}{tuple(r['a_stride'])} "
            f"{r['a_dtype'][6:]} @ {tuple(r['b'])}{tuple(r['b_stride'])} "
            f"{r['b_dtype'][6:]} -> {r['out_dtype'][6:]}"
            f"{' +bias' if r['bias'] else ''}"
            f"{' ' + r['activation'] if r['activation'] else ''}: "
            f"max abs err {r['err']:.3e} (limit {r['tol']:.3e}); "
            f"{r['path']} (TMA {r['tma']})"
            + ("; not timed" if r["ms"] is None else
               f" {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, "
               f"{r['gb_per_s']:.0f} GB/s), torch.matmul "
               + ("-" if r["torch_matmul_ms"] is None
                  else f"{r['torch_matmul_ms']:.4f} ms")
               + ("" if r["torch_matmul_fp32_ms"] is None
                  else f" (in fp32 {r['torch_matmul_fp32_ms']:.4f} ms)")
               + "; cold L2"))
    bf16 = [r for r in calls if r["torch_matmul_ms"] is not None]
    log(label, f"{cfg.name}: {len(calls)} distinct matmul calls in one "
        f"gradient (batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"{'1 + 1 layers' if cfg.is_encdec else f'{cfg1.n_layers} layers'}"
        f", bf16), "
        f"{len(transposed)} with a transposed operand, {len(mixed)} with "
        f"mixed dtypes; {len(failed)} outside the limit; the {len(bf16)} "
        f"bf16 x bf16 calls: kernel {sum(r['ms'] for r in bf16):.4f} ms, "
        f"torch.matmul {sum(r['torch_matmul_ms'] for r in bf16):.4f} ms, "
        f"bound {sum(r['bound_ms'] for r in bf16):.4f} ms")
    if failed or not transposed or not mixed or not audit.report(label):
        log(label, "FAIL: a product disagrees with the plain version, "
            "or the backward's transposed or mixed-dtype products were not "
            "seen")
        return None
    del model, params
    torch.cuda.empty_cache()
    return calls


def train_phase(cfg, fa, mm_launches, label="train", ckpt=True,
                fixed_batch=True, tma_only=False, fixed_lr=1e-3,
                steps_n=TRAIN_STEPS, fixed_steps=None):
    """Runtime.train of the full-width model (random weights, bf16): every
    step finite, the kernels' launches per step (every flash call on the
    path its dtype and head dim name, on tensor maps; a decoder-only
    model's 2 forward calls, one in the recomputation, and 1 backward a
    full-attention layer), tokens/s, peak memory and the plan.  With
    ``ckpt`` a checkpoint is written, checked and deleted (phase 9 only:
    the write is the host's disk time, which varies from host to host, and
    phase 21's 4-5 B-parameter states with their moments, about 60 GB,
    would take minutes).  Then, with ``fixed_batch``, a 4-step run
    on one fixed batch at a peak rate of ``fixed_lr`` whose loss must fall,
    every step timed (without, Runtime.train's steps 1-3 give the wall).
    One step is profiled (its matmul calls each on their dtypes' path, its
    flash calls counted by mode and path; no library GEMM or attention
    kernel).  ``tma_only``: no matmul operand of the run may miss a tensor
    map; it is not the default because seamless-m4t-medium's unembedding
    gradient at vocab 256,206 has fp32 rows no tensor map loads, which the
    split path copies (ROADMAP Queue 2).  Every step updates its state in
    place (``make_train_step(donate=True)``, the functional step's
    values), so no second copy of the parameters and moments is made.
    Runtime.train takes ``steps_n`` steps (TRAIN_STEPS; phase 21
    FAMILY_TRAIN_STEPS), the fixed batch ``fixed_steps`` (default as
    many).  None on a failure."""
    import re
    import shutil

    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels.calls import CallLog
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Runtime
    from repro_torch.training import (TrainLoopConfig, init_train_state,
                                      make_train_step)

    rt = Runtime(device="cuda")
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    lines, plans = [], []
    t_run = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mm_launches.reset()
    fa.LAUNCHES.reset()
    res = rt.train(cfg, steps=steps_n, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                   seed=0, ckpt_dir=str(ckpt_dir) if ckpt else None,
                   ckpt_every=10 ** 6, log_every=1, log=lines.append,
                   on_plan=plans.append)
    torch.cuda.synchronize()
    counts = dict(matmul=mm_launches.count, flash_forward=fa.LAUNCHES.forward,
                  flash_backward=fa.LAUNCHES.backward,
                  flash_cuda_launches=fa.LAUNCHES.grids,
                  flash_copied_operands=fa.LAUNCHES.copied_operands,
                  matmul_copied_operands=mm_launches.copied_operands,
                  **{f"matmul {p}": n for p, n in mm_launches.by_path.items()},
                  **{f"flash {p}": n for p, n in fa.LAUNCHES.by_path.items()})
    run_modes = {k: n for k, n in fa.LAUNCHES.by_mode.items() if n}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    saved = sorted(p.name for p in ckpt_dir.iterdir()) \
        if ckpt_dir.exists() else []
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    steps = [dict(step=int(m.group(1)), loss=float(m.group(2)),
                  ms=float(m.group(3))) for m in
             (re.match(r"step\s+(\d+) loss (\S+) .* (\d+)ms$", x)
              for x in lines) if m]
    for line in lines:
        log(label, line)
    plan = plans[0]
    for line in plan.summary().splitlines():
        log(label, "plan " + line.strip())
    per_step = {k: v // steps_n for k, v in counts.items()}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = [x["ms"] for x in steps[1:]]
    tok_s = tokens * len(steady) / (sum(steady) / 1e3) if steady else 0.0
    depth = (f"{cfg.encoder_layers} + {cfg.n_layers} layers" if cfg.is_encdec
             else f"{cfg.n_layers} layers")
    log(label, f"{cfg.name} full width ({depth}) bf16, "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}: {res.steps_run} steps in "
        f"{res.wall_s:.2f} s, final loss {res.final_loss:.4f}, diverged "
        f"{res.diverged}; {tok_s:.1f} tokens/s over steps 1-"
        f"{steps_n - 1}; peak memory {peak_gb:.2f} GB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}; "
        f"checkpoint {saved}; launches per step {per_step}; flash calls by "
        f"direction, mode and path {run_modes}")
    # the flash calls a decoder-only model makes: each full-attention
    # layer's forward, again in its recomputation, and its backward
    n_attn = sum(cfg.block_kind(i) == "attn" for i in range(cfg.n_layers))
    ok = (res.steps_run == steps_n and not res.diverged
          and math.isfinite(res.final_loss) and len(steps) == steps_n
          and all(math.isfinite(x["loss"]) for x in steps)
          and saved == ([f"step_{steps_n:08d}"] if ckpt else [])
          and counts["matmul"] > 0
          and all(v % steps_n == 0 for v in counts.values())
          and (cfg.is_encdec or (per_step["flash_forward"] == 2 * n_attn
                                 and per_step["flash_backward"] == n_attn)))
    if not ok:
        log(label, "FAIL: a step was not finite, the run stopped early, "
            "the checkpoint is missing or a kernel was launched other "
            f"than once a step per layer ({n_attn} full-attention layers)")
        return None
    # bf16: every flash call on the path its head dim names (the wgmma
    # kernels at hd 64, 96, 128 and 256, through tensor maps), the rule
    # stated apart from the wrapper's choose_path
    hd = cfg.resolved_head_dim
    path = flash_path(torch.bfloat16, hd)
    other = "fma" if path == "tensor_core" else "tensor_core"
    if counts[f"flash {other}"] or counts["flash_copied_operands"] or \
            counts[f"flash {path}"] != counts["flash_forward"] + \
            counts["flash_backward"]:
        log(label, f"FAIL: a bf16 flash call at hd {hd} left the {path} "
            f"path or copied an operand: {counts}")
        return None
    if tma_only and counts["matmul_copied_operands"]:
        log(label, f"FAIL: {counts['matmul_copied_operands']} tensor-core "
            f"matmul operands missed a tensor map")
        return None
    t_run = time.perf_counter() - t_run
    t_after = time.perf_counter()

    model = build_model(cfg, "cuda")
    fixed_steps = steps_n if fixed_steps is None else fixed_steps
    if fixed_batch:  # one fixed batch: the loss must fall
        del res
        torch.cuda.empty_cache()
        loop = TrainLoopConfig(optimizer=AdamWConfig(lr=fixed_lr),
                               warmup_steps=1, total_steps=fixed_steps)
        state = init_train_state(model, 1, loop)
        n_timed = fixed_steps
    else:  # the trained state, profiled as it is
        loop = TrainLoopConfig(warmup_steps=1, total_steps=steps_n)
        state = res.state
        del res
        n_timed = 0
    batch = SyntheticLMData(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                            seed=1, device="cuda").batch_at(0)
    step_fn = make_train_step(model, loop, donate=True)
    losses, walls = [], []
    for i in range(n_timed):
        # phase 9's second fixed-batch step is the one phase 27's dry run
        # traces: its kernel calls and its peak memory are kept
        held = label == "train" and fixed_batch and i == 1
        torch.cuda.synchronize()
        if held:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with (CallLog() if held else contextlib.nullcontext()) as calls_:
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
        if held:
            DRYRUN_CAPTURE["train"] = dict(
                arch=cfg.name, loop=loop, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                calls=calls_.counts(), peak=torch.cuda.max_memory_allocated(),
                base=base, args=storage_bytes(state, batch),
                wall_ms=walls[-1])
    end_loss = None
    if fixed_batch:
        with torch.no_grad():
            end_loss = float(model.loss(state["params"], batch)[0])
    launched = {}
    fa.LAUNCHES.reset()
    t_prof = time.perf_counter()
    with RouteAudit(ops, mm) as audit:
        by_name, events = device_ms_by_kernel(lambda: step_fn(state, batch),
                                              launched)
    t_prof = time.perf_counter() - t_prof
    t_after = time.perf_counter() - t_after
    log(label, f"phase seconds: Runtime.train {t_run:.1f}, the timed and "
        f"profiled steps {t_after:.1f} (the profiled one {t_prof:.1f})")
    modes = {k: n for k, n in fa.LAUNCHES.by_mode.items() if n}
    device_ms = sum(by_name.values())
    split = group_device_ms(by_name, FLASH_ALL_KERNELS)
    flash_ms = sum(split[g] for g in FLASH_ALL_KERNELS)
    wall = walls[-1] if walls else steady[-1]
    if fixed_batch:
        log(label, f"fixed batch, lr {fixed_lr:g}: losses {losses}, after "
            f"{fixed_steps} steps {end_loss:.4f} (must be below "
            f"{losses[0]:.4f}); step walls {[round(w, 1) for w in walls]} ms")
    else:
        log(label, f"the profiled step is the trained state's fifth; its "
            f"wall is taken as Runtime.train's step {steps_n - 1}'s, "
            f"{wall:.1f} ms")
    log(label, f"profiled step's flash calls by direction, mode and path: "
        f"{modes}")
    if events == 0:
        log(label, "profiled step: device time not measured (the profiler "
            "saw no kernels)")
    else:
        log(label, f"profiled step: {events} device events, device busy "
            f"{device_ms:.1f} ms of a {wall:.1f} ms step "
            f"({100 * device_ms / wall:.1f}%); " + ", ".join(
                f"{g} {v:.1f} ms" for g, v in split.items()))
        log(label, f"flash device time {flash_ms:.2f} ms by kernel: " +
            ", ".join(f"{k} {v:.3f} ms ({n} launches)" for k, v, n in (
                (name, sum(ms for kn, ms in by_name.items()
                           if re.search(key, kn)),
                 sum(n for kn, n in launched.items() if re.search(key, kn)))
                for name, key in FLASH_ALL_KERNELS.items())))
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log(label, f"  {ms:9.2f} ms  {name[:90]}")
    if not all(math.isfinite(x) for x in losses) or (
            fixed_batch and not end_loss < losses[0]):
        log(label, "FAIL: a loss was not finite, or the loss did not fall "
            "on a fixed batch")
        return None
    if library_gemms(label, by_name) or not audit.report(label):
        return None
    library_attn = sorted(k for k in by_name if LIBRARY_ATTENTION.search(k))
    if library_attn or (events and bool(flash_ms) != bool(n_attn
                                                          or cfg.is_encdec)):
        log(label, f"FAIL: library attention kernels on the main path "
            f"{library_attn}, or flash kernels in the profile ({flash_ms:.3f}"
            f" ms) where the model has {n_attn} full-attention layers")
        return None
    return dict(steps=steps, final_loss=steps[-1]["loss"], tok_per_s=tok_s,
                peak_memory_gb=peak_gb, launches_per_step=per_step,
                flash_calls_per_step=per_step["flash_forward"]
                + per_step["flash_backward"], flash_modes_run=run_modes,
                plan=dict(decisions=[dataclasses.asdict(d)
                                     for d in plan.decisions],
                          fits_hbm=plan.fits_hbm,
                          hbm_per_chip=plan.hbm_per_chip),
                fixed_batch_losses=losses if fixed_batch else None,
                fixed_batch_end_loss=end_loss, step_ms=walls or steady,
                fixed_batch_step_ms=walls if fixed_batch else None,
                seconds=dict(train=t_run, after=t_after, profiled=t_prof),
                profile=dict(
                    flash_calls=modes, routing=audit.counts,
                    events=events, device_ms=device_ms, wall_ms=wall,
                    by_group=split, flash_ms=flash_ms, top=sorted(
                        by_name.items(), key=lambda kv: -kv[1])[:12]))


def wkv_inputs(shape, gen):
    """r, k, v (B, S, H, N) in the shape's dtype, logw fp32, u fp32 on the
    card: r, v ~ N(0, 1); logw as rwkv_time_mix makes it at its init,
    -exp(w0 + tanh(x W1) W2) with w0 = -2, x ~ N(0, 1) and fan-in scaled
    W1 (D, 64), W2 (64, D) ("heavy": -exp(3 + N(0, 1)); or the constant
    given); k ~ N(0, 1) scaled by
    1 - e^{logw}; u ~ 0.1 N(0, 1), as bonus_u's init."""
    b, s, h, n, dtype_name, decay = shape
    dt = getattr(torch, dtype_name)
    dev, d = "cuda", h * n
    r, k, v = (torch.randn((b, s, h, n), generator=gen, device=dev)
               for _ in range(3))
    if decay == "model":
        x = torch.randn((b * s, d), generator=gen, device=dev)
        w1 = torch.randn((d, 64), generator=gen, device=dev) / d ** 0.5
        w2 = torch.randn((64, d), generator=gen, device=dev) / 8.0
        logw = -torch.exp(-2.0 + torch.tanh(x @ w1) @ w2).reshape(b, s, h, n)
    elif decay == "heavy":
        logw = -torch.exp(3.0 + torch.randn((b, s, h, n), generator=gen,
                                            device=dev))
    else:
        logw = torch.full((b, s, h, n), float(decay), device=dev)
    k = k * (1.0 - torch.exp(logw))
    u = 0.1 * torch.randn((h, n), generator=gen, device=dev)
    return r.to(dt), k.to(dt), v.to(dt), logw, u


def wkv_held(got, want, scale=None) -> float:
    """|got - want| over its limit, the largest element's: fp32 outputs
    within WKV_F32_TOL x max|want| (or x ``scale``), bf16 ones within
    BF16_TOL x their row's max|want| + F32_TOL x max|want|."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    top = mag.max().item() if scale is None else scale
    if want.dtype == torch.bfloat16:
        limit = BF16_TOL * mag.amax(-1, keepdim=True) + F32_TOL * top
    else:
        limit = torch.full_like(mag, WKV_F32_TOL * top)
    return (diff / limit.clamp(min=1e-30)).max().item()


def wkv_exps(b, h, nc, L, n, sub) -> tuple:
    """(forward, backward) exponentials the WKV kernels take: the state
    pass's L x N a chunk in each of its N/16 column CTAs; per chunk, the
    diagonal blocks' pairs (A; and dr, dk together in the backward), the
    factors (qf, kf_i; r e^{cwe} in the forward, kd in the backward) and
    the backward's scalings and assembly."""
    nb = L // sub
    pairs = sub * (sub - 1) // 2 * nb * n
    kf = sub * nb * (nb - 1) // 2 * n
    qf = (L - sub) * n
    state = (n // 16) * L * n
    fwd = state + pairs + qf + kf + L * n
    bwd = state + 2 * pairs + 2 * (qf + kf) + L * n + 2 * L * n
    return b * h * nc * fwd, b * h * nc * bwd


def wkv_case(shape, gen, ref, wkv_k, flush):
    """Hold the WKV kernels at ``shape`` against their plain versions
    (``wkv_fwd_plain`` / ``wkv_bwd_plain`` with the kernels' sub-chunk
    factorization), forward (out, final state, chunk-start states) and
    backward (dr, dk, dv, dlogw, du; fed the plain forward's chunk-start
    states and a random dout), the backward twice with the same bits;
    check the wrapper calls and the CUDA launches by kernel; time both
    beside the plain versions and the bound, and at the training shape
    profile one forward and one backward by kernel.  None if they disagree
    or an output is not finite."""
    b, s, h, n, dtype_name, decay = shape
    r, k, v, logw, u = wkv_inputs(shape, gen)
    do = torch.randn((b, s, h, n), generator=gen, device="cuda")
    sub = wkv_k.SUBCHUNK
    before = (wkv_k.LAUNCHES.forward, wkv_k.LAUNCHES.backward)
    cuda_before = dict(wkv_k.LAUNCHES.cuda)
    out, state, starts = wkv_k.wkv_fwd_cuda(r, k, v, logw, u, WKV_CHUNK,
                                            keep_states=True)
    p_out, p_state, p_starts = ref.wkv_fwd_plain(r, k, v, logw, u, WKV_CHUNK,
                                                 sub)
    grads = wkv_k.wkv_bwd_cuda(r, k, v, logw, u, p_starts, do, None,
                               WKV_CHUNK)
    again = wkv_k.wkv_bwd_cuda(r, k, v, logw, u, p_starts, do, None,
                               WKV_CHUNK)
    p_grads = ref.wkv_bwd_plain(r, k, v, logw, u, p_starts, do, None,
                                WKV_CHUNK, sub)
    calls = (wkv_k.LAUNCHES.forward - before[0],
             wkv_k.LAUNCHES.backward - before[1])
    cuda_calls = {kk: vv - cuda_before.get(kk, 0)
                  for kk, vv in wkv_k.LAUNCHES.cuda.items()}
    torch.cuda.synchronize()
    name = f"{tuple(shape[:4])} {dtype_name} logw {decay}"
    dlogw_scale = max((p_grads[3].abs().max().item(),
                       (r.float() * p_grads[0].float()).abs().max().item(),
                       (k.float() * p_grads[1].float()).abs().max().item()))
    errs, worst = {}, 0.0
    for what, got, want in [("out", out, p_out), ("state", state, p_state),
                            ("chunk states", starts, p_starts),
                            *zip(("dr", "dk", "dv", "dlogw", "du"), grads,
                                 p_grads)]:
        finite = bool(torch.isfinite(got).all())
        err = (got.float() - want.float()).abs().max().item()
        ratio = wkv_held(got, want,
                         dlogw_scale if what == "dlogw" else None)
        errs[what] = dict(err=err, of_limit=ratio, finite=finite)
        worst = max(worst, err)
        if not (finite and ratio <= 1.0 and got.dtype == want.dtype):
            log("wkv", f"FAIL {name} {what}: finite {finite}, max abs err "
                f"{err:.3e}, {ratio:.2f} x its limit")
            return None
    same_bits = all(torch.equal(x, y) for x, y in zip(grads, again))
    if not same_bits:
        log("wkv", f"FAIL {name}: two backward calls gave other bits")
        return None
    want_cuda = {}
    for kern in wkv_k.FORWARD_KERNELS + 2 * wkv_k.BACKWARD_KERNELS:
        want_cuda[kern] = want_cuda.get(kern, 0) + 1
    if calls != (1, 2) or cuda_calls != want_cuda:
        log("wkv", f"FAIL {name}: wrapper calls {calls}, CUDA launches "
            f"{cuda_calls}; expected one forward and two backward calls, "
            f"{want_cuda}")
        return None
    big = s >= 1024
    reps = 5 if big else 10
    times = dict(
        fwd_ms=cuda_ms(lambda: wkv_k.wkv_fwd_cuda(
            r, k, v, logw, u, WKV_CHUNK, keep_states=True), flush, reps),
        fwd_plain_ms=cuda_ms(lambda: ref.wkv_fwd_plain(
            r, k, v, logw, u, WKV_CHUNK, sub), flush, 2 if big else reps, 1),
        bwd_ms=cuda_ms(lambda: wkv_k.wkv_bwd_cuda(
            r, k, v, logw, u, p_starts, do, None, WKV_CHUNK), flush, reps),
        bwd_plain_ms=cuda_ms(lambda: ref.wkv_bwd_plain(
            r, k, v, logw, u, p_starts, do, None, WKV_CHUNK, sub), flush,
            2 if big else reps, 1))
    # the chunked form over full L x L tiles: forward A and A v (2 L^2 N
    # FLOPs each), (r e^cwe) S and (k e^{cw_L - cw})^T v (2 L N^2 each);
    # the backward recomputes A and adds dA, A^T dO and the pairwise dr and
    # dk (5 x 2 L^2 N) and four N-wide products (4 x 2 L N^2); each input
    # read once, each output written once (the forward keeps its
    # chunk-start states, as in training; the backward reads them)
    L, nc = WKV_CHUNK, -(-s // WKV_CHUNK)
    tiles = b * h * nc
    flops_f = tiles * (4.0 * L * L * n + 4.0 * L * n * n)
    flops_b = tiles * (10.0 * L * L * n + 8.0 * L * n * n)
    peak = BF16_PEAK if r.dtype == torch.bfloat16 else F32_PEAK
    esz, elems = r.element_size(), b * s * h * n
    states = 4 * tiles * n * n
    bytes_f = (3 * esz + 4 + 4) * elems + 4 * h * n + 4 * b * h * n * n \
        + states
    bytes_b = (3 * esz + 4 + 4) * elems + 4 * h * n + states \
        + (3 * esz + 4) * elems + 4 * h * n
    t_ops = (flops_f + flops_b) / peak * 1e3
    t_bytes = (bytes_f + bytes_b) / HBM_BW * 1e3
    exps_f, exps_b = wkv_exps(b, h, nc, L, n, sub)
    row = dict(shape=list(shape[:4]), dtype=dtype_name, logw=decay,
               chunk=WKV_CHUNK, max_abs_err=worst, errors=errs,
               backward_bits_repeat=same_bits, cuda_launches=cuda_calls,
               exps_fwd=exps_f, exps_bwd=exps_b,
               fwd_bound_ms=max(flops_f / peak, bytes_f / HBM_BW) * 1e3,
               bwd_bound_ms=max(flops_b / peak, bytes_b / HBM_BW) * 1e3,
               fwd_bound_by="operations" if flops_f / peak > bytes_f / HBM_BW
               else "bytes",
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               fwd_gflop=flops_f / 1e9, bwd_gflop=flops_b / 1e9,
               fwd_mb=bytes_f / 1e6, bwd_mb=bytes_b / 1e6, **times)
    log("wkv", f"{name}: kernel == plain (sub-chunk {sub}) within limits, "
        f"all finite, backward bits repeat (" +
        ", ".join(f"{w} {e['err']:.1e} = {e['of_limit']:.2f} x limit"
                  for w, e in errs.items()) + ")")
    log("wkv", f"  forward: kernel {times['fwd_ms']:.4f} ms  plain "
        f"{times['fwd_plain_ms']:.4f} ms  bound {row['fwd_bound_ms']:.4f} ms "
        f"({row['fwd_mb']:.1f} MB, {row['fwd_gflop']:.2f} GFLOP, "
        f"{exps_f:.3g} exp); {len(wkv_k.FORWARD_KERNELS)} launches; cold L2")
    log("wkv", f"  backward: kernel {times['bwd_ms']:.4f} ms  plain "
        f"{times['bwd_plain_ms']:.4f} ms  bound {row['bwd_bound_ms']:.4f} ms "
        f"({row['bwd_mb']:.1f} MB, {row['bwd_gflop']:.2f} GFLOP, "
        f"{exps_b:.3g} exp); {len(wkv_k.BACKWARD_KERNELS)} launches; cold L2")
    if big and dtype_name == "bfloat16":
        prof, reps = {}, 5
        for part, run in (("forward", lambda: wkv_k.wkv_fwd_cuda(
                r, k, v, logw, u, WKV_CHUNK, keep_states=True)),
                          ("backward", lambda: wkv_k.wkv_bwd_cuda(
                              r, k, v, logw, u, p_starts, do, None,
                              WKV_CHUNK))):
            flush.zero_()
            by_name, events = device_ms_by_kernel(
                lambda: [run() for _ in range(reps)])
            prof[part] = {g: sum(ms for kk, ms in by_name.items()
                                 if re.search(key, kk)) / reps
                          for g, key in WKV_KERNELS.items()}
            prof[part] = {g: ms for g, ms in prof[part].items() if ms}
            log("wkv", f"  profiled {part} (torch.profiler device ms a call, "
                f"mean of {reps}): " + (", ".join(
                    f"{g} {ms:.4f}" for g, ms in prof[part].items())
                    if prof[part] else f"not measured ({events} device "
                    f"events)"))
        row["profile"] = prof
    return row


def wkv_build_report(wkv_k, text) -> dict:
    """The WKV kernels' ptxas -v report (registers and spill bytes of each
    compiled kernel, by part) and the CUDA runtime's view of the training
    instantiations (threads, shared memory, registers, local bytes, CTAs an
    SM), logged; ``spills`` lists every kernel that spills."""
    parts, kind = {}, None
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            kind = ("state backward" if "wkv_state" in mangled and "Lb1E" in
                    mangled else "state forward" if "wkv_state" in mangled
                    else "output" if "wkv_fwd_out" in mangled
                    else "backward chunk" if "wkv_bwd_chunk" in mangled
                    else None)
            if kind:
                parts.setdefault(kind, dict(kernels=0, registers=[999, 0],
                                            spill_bytes=0))["kernels"] += 1
        elif kind and "spill" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
            parts[kind]["spill_bytes"] = max([parts[kind]["spill_bytes"]] +
                                             nums)
        elif kind and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            reg = parts[kind]["registers"]
            reg[0], reg[1] = min(reg[0], regs), max(reg[1], regs)
    for kind, row in parts.items():
        log("build", f"wkv.cu {kind}: {row['kernels']} kernels, "
            f"{row['registers'][0]}-{row['registers'][1]} registers a "
            f"thread, spill stores/loads up to {row['spill_bytes']} bytes "
            f"(ptxas -v)")
    runtime = {}
    for dt in ("bfloat16", "float32"):
        info = wkv_k.kernel_info(getattr(torch, dt), WKV_CHUNK, 64)
        runtime[dt] = info
        for kern, x in info.items():
            log("build", f"wkv {dt} L {WKV_CHUNK} N 64 {kern}: "
                f"{x['threads']} threads, {x['smem_bytes']} bytes dynamic "
                f"shared memory, {x['registers']} registers, "
                f"{x['local_bytes']} local bytes a thread, "
                f"{x['ctas_per_sm']} CTAs an SM")
    spills = [k for k, row in parts.items() if row["spill_bytes"]] + [
        f"{dt} {kern}" for dt, info in runtime.items()
        for kern, x in info.items() if x["local_bytes"]]
    return dict(ptxas=parts, runtime=runtime, spills=spills)


def rwkv_card_vs_cpu(cfg, wkv_k):
    """Full-width rwkv6-3b cut to 2 layers, fp32, on the card and on the
    CPU from the same parameters: prefill logits of a 2 x 16 prompt (no
    decode state: the WKV kernel on the card), then the prompt fed token
    by token through decode_step (wkv_step) and 4 greedy steps, each
    step's logits within 2e-3 x max|logit| (phase 6's limit), and the
    card's prefill within it of the card's decode at the last prompt
    token.  None on a mismatch."""
    from repro_torch.models import build_model
    from repro_torch.runtime import synthetic_trace
    from repro_torch.tree import tree_map

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    p_gpu = build_model(cfg2, "cuda").init(0)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    prompt = torch.as_tensor(synthetic_trace(
        1, prompt_len=16, max_new=1, vocab_size=cfg.vocab_size,
        arrival="all", seed=2)[0].prompt, dtype=torch.int64)
    prompts = torch.stack([prompt, prompt.flip(0)])
    logits, fwd_calls = {}, 0
    for where, p_dev in (("cuda", p_gpu), ("cpu", p_cpu)):
        model = build_model(cfg2, where)
        before = wkv_k.LAUNCHES.forward
        pre = model.prefill(p_dev, {"tokens": prompts.to(where)})[:, -1]
        if where == "cuda":
            fwd_calls = wkv_k.LAUNCHES.forward - before
        st = model.init_decode_state(2, 32, per_slot=True)
        for i in range(prompts.shape[1]):
            out, st = model.decode_step(
                p_dev, st, {"tokens": prompts[:, i:i + 1].to(where)})
        steps = [out[:, -1]]
        for _ in range(4):
            tok = steps[-1].argmax(-1)[:, None]
            out, st = model.decode_step(p_dev, st, {"tokens": tok})
            steps.append(out[:, -1])
        logits[where] = [t.float().cpu() for t in [pre] + steps]
    worst = 0.0
    pairs = list(zip(logits["cuda"], logits["cpu"])) + [
        (logits["cuda"][0], logits["cuda"][1])]
    for i, (lg, lc) in enumerate(pairs):
        top = lc.abs().max().item()
        err = (lg - lc).abs().max().item()
        worst = max(worst, err / top)
        if not err <= 2e-3 * top:
            log("rwkv-card-vs-cpu", f"FAIL comparison {i}: logits err "
                f"{err:.3e} > {2e-3 * top:.3e}")
            return None
    if fwd_calls != cfg2.n_layers:
        log("rwkv-card-vs-cpu", f"FAIL: the card's prefill made {fwd_calls} "
            f"WKV kernel calls, expected one per layer")
        return None
    log("rwkv-card-vs-cpu", f"rwkv6-3b full width, 2 layers, fp32: prefill "
        f"2x16 (WKV kernel, {fwd_calls} calls) and 16 + 4 decode steps "
        f"(wkv_step), card against CPU and the card's prefill against its "
        f"decode: logits agree, max err {worst:.2e} x max|logit| (limit "
        f"2e-3)")
    return dict(rel_err=worst, wkv_forward_calls=fwd_calls)


def rwkv_serve(cfg, mm_launches, wkv_k):
    """Runtime.serve of full-width rwkv6-3b in bf16 at the depth ``cfg``
    gives (random weights, seed 0; phase 5's trace cut to SHORT_NEW new
    tokens a request), static and continuous: identical tokens, the matmul
    kernel launched, no WKV kernel (serving decodes through wkv_step);
    tok/s, host syncs per token and one profiled decode step.  None on a
    failure."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.runtime import Runtime, synthetic_trace

    rt = Runtime(device="cuda")
    model = build_model(cfg, rt.device)
    params = model.init(0)
    trace = lambda: synthetic_trace(  # noqa: E731
        REQUESTS, prompt_len=PROMPT, max_new=SHORT_NEW,
        vocab_size=cfg.vocab_size, arrival="all", seed=0)
    torch.cuda.synchronize()
    mm_launches.reset()
    wkv_k.LAUNCHES.reset()
    static = rt.serve(cfg, trace(), mode="static", model=model,
                      params=params, slots=SLOTS, eos_id=-1)
    cont = rt.serve(cfg, trace(), mode="continuous", model=model,
                    params=params, slots=SLOTS, eos_id=-1)
    torch.cuda.synchronize()
    launches, wkv_calls = mm_launches.count, wkv_k.LAUNCHES.forward
    same = all((static.outputs[r] == cont.outputs[r]).all()
               for r in static.outputs)
    ntok = sum(len(v) for v in cont.outputs.values())
    log("rwkv-serve", f"rwkv6-3b full width ({cfg.n_layers} layers) bf16, "
        f"{REQUESTS} requests x {PROMPT}+{SHORT_NEW} tokens, {SLOTS} slots: "
        f"static {static.tok_per_s:.2f} tok/s, continuous "
        f"{cont.tok_per_s:.2f} tok/s, host_syncs_per_token "
        f"{cont.report.host_syncs_per_token:.4f} ({cont.report.host_syncs} "
        f"syncs, {cont.report.device_dispatches} dispatches, {ntok} tokens)")
    log("rwkv-serve", f"static == continuous tokens: {same}; matmul kernel "
        f"launches during serving: {launches}; WKV kernel calls: "
        f"{wkv_calls}")
    if not same or launches <= 0 or wkv_calls != 0 or \
            ntok != REQUESTS * SHORT_NEW:
        return None
    state = model.init_decode_state(SLOTS, PROMPT + MAX_NEW, per_slot=True)
    feed = {"tokens": torch.ones((SLOTS, 1), dtype=torch.int64,
                                 device="cuda")}
    serve_paths = dict(mm_launches.by_path)
    mm_launches.reset()
    with RouteAudit(ops, mm) as audit:
        model.decode_step(params, state, feed)
    per_step = mm_launches.count
    step_paths = dict(mm_launches.by_path)
    log("rwkv-serve", f"matmul kernel launches per decode step: {per_step} "
        f"(by path {step_paths}; during serving {serve_paths})")
    prof = profile_decode_step(model, params, state, feed)
    if not audit.report("rwkv-serve") or prof["library_gemms"]:
        return None
    return dict(static_tok_per_s=static.tok_per_s,
                continuous_tok_per_s=cont.tok_per_s,
                static_wall_s=static.wall_s, continuous_wall_s=cont.wall_s,
                host_syncs=cont.report.host_syncs,
                device_dispatches=cont.report.device_dispatches,
                host_syncs_per_token=cont.report.host_syncs_per_token,
                generated_tokens=ntok, launches=launches,
                launches_by_path=serve_paths,
                launches_per_decode_step=per_step,
                launches_per_decode_step_by_path=step_paths,
                routing=audit.counts, tokens_identical=same,
                decode_step_profile=prof)


def count_syncs(fn) -> tuple:
    """(fn(), the synchronizing CUDA calls it made), the calls counted by
    torch's sync debug mode, one warning each."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def step_wall(model, params, state, batch, reps: int = 5) -> float:
    """Mean wall ms of one decode step: host clock around synchronized
    steps, profiler off."""
    model.decode_step(params, state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        model.decode_step(params, state, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def step_split(model, params, state, batch, wall_ms) -> dict:
    """One decode step's device time (torch.profiler), kernel launches,
    and the device ms of the matmul kernel and of the indexing kernels (the
    page gathers and the KV scatter of a paged step; the cache write and
    the embedding lookup of a dense one), beside its wall ``wall_ms``."""
    by_name, n_kernels = device_ms_by_kernel(
        lambda: model.decode_step(params, state, batch))
    groups = group_device_ms(by_name, {"indexing": INDEX_KERNELS})
    return dict(wall_ms=wall_ms, device_ms=sum(by_name.values()),
                matmul_ms=groups["matmul"], indexing_ms=groups["indexing"],
                other_ms=groups["other"], launches=n_kernels,
                library_gemms=library_gemms("paged", by_name),
                indexing_kernels=sorted(
                    (k, v) for k, v in by_name.items()
                    if re.search(INDEX_KERNELS, k)))


def dedupe_check(model, params, trace, card) -> dict:
    """Two of a shared-prefix trace's requests admitted as ONE group into a
    fresh paged engine (the split that would defer the second is bypassed),
    so the trie keeps the first's pages and swaps out the second's
    duplicates.  Each duplicate must hold the bits of the page it is
    swapped for, in every layer's pk and pv: the same tokens at the same
    positions, computed in another row of the batch.  None on a
    mismatch."""
    from repro_torch.serving import ContinuousServeEngine
    from repro_torch.tree import leaves_with_paths

    engine = ContinuousServeEngine(model, params, n_slots=2,
                                   max_len=P2_PROMPT + MAX_NEW, eos_id=-1,
                                   paged=True, block_size=PAGE,
                                   prefix_cache="force")
    swapped, unequal = [], []
    apply_swaps = engine.pool.apply_swaps

    def checked(slot, swaps):
        for _, old, new in swaps:
            for path, leaf in leaves_with_paths(engine.pool.state["layers"]):
                if path.endswith(("pk", "pv")) and not torch.equal(
                        leaf[old], leaf[new]):
                    unequal.append((path, old, new))
            swapped.append((old, new))
        apply_swaps(slot, swaps)

    engine.pool.apply_swaps = checked
    reqs = trace[:2]
    for r in reqs:
        r.reset_lifecycle()
    engine._group_pad = P2_PROMPT
    engine._admit_group(reqs, lambda: 0.0)
    n_pages = sum(1 for p, _ in leaves_with_paths(engine.pool.state["layers"])
                  if p.endswith(("pk", "pv")))
    # a page copy (copy-on-write) and a table upload make no host sync
    donor = int(engine.pool.slot_table(0)[0])
    engine.pool.blocks.incref(donor)  # the pin cow_block releases
    _, cow_syncs = count_syncs(lambda: engine.pool.cow_block(1, donor))
    _, table_syncs = count_syncs(engine.pool.block_tables)
    log("paged", f"dedupe: {len(swapped)} trie swaps, each page compared "
        f"bit for bit in {n_pages} pools: {len(unequal)} unequal; host "
        f"syncs of a copy-on-write {cow_syncs}, of a table upload "
        f"{table_syncs} ({card})")
    if not swapped or unequal or cow_syncs or table_syncs:
        log("paged", f"FAIL: a deduplicated page differs from the page that "
            f"replaces it (or none was swapped), or a page copy or table "
            f"upload synced: {unequal[:4]}")
        return None
    return dict(swaps=len(swapped), pools=n_pages, unequal=0,
                cow_syncs=cow_syncs, table_syncs=table_syncs)


def paged_phase(cfg, rcfg, p1_want, mm_launches, card, dense_step_launches):
    """Phase 15: paged KV and the radix prefix cache through Runtime.serve
    at full width and the depth ``cfg`` gives (tinyllama-1.1b bf16, random
    weights, seed 0; ``p1_want`` phase 5's trace at that depth),
    rwkv6-3b paged (full width, 4 layers), the token stream, one profiled
    paged decode step, and the quickstart on the card.  None on any
    failed gate."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.runtime import Runtime, synthetic_trace
    from repro_torch.serving.paging import default_kv_blocks

    out: dict = {"card": card}
    rt = Runtime(device="cuda")
    model = build_model(cfg, rt.device)
    params = model.init(0)

    def same(a, b) -> bool:
        return a.keys() == b.keys() and all(
            np.array_equal(np.asarray(a[r]), np.asarray(b[r])) for r in a)

    # --- P1: phase 5's trace, paged (default kv_blocks), K and chunk pinned
    trace1 = lambda: synthetic_trace(  # noqa: E731
        REQUESTS, prompt_len=PROMPT, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="all", seed=0)
    # each run also counts the synchronizing CUDA calls it really made
    # (torch's sync debug mode): paging and the stream may add none
    kw = dict(model=model, params=params, slots=SLOTS, eos_id=-1, **PIN)
    dense1, dense_syncs = count_syncs(lambda: rt.serve(cfg, trace1(), **kw))
    torch.cuda.synchronize()
    mm_launches.reset()
    paged1, paged_syncs = count_syncs(lambda: rt.serve(
        cfg, trace1(), paged=True, block_size=PAGE, **kw))
    torch.cuda.synchronize()
    launches = mm_launches.count
    streamed, stream_syncs = count_syncs(lambda: rt.serve(
        cfg, trace1(), paged=True, block_size=PAGE, stream=True, **kw))
    # dense again, so the paged runs sit between two dense ones: the
    # host's speed drifts, and a first run may pay a one-off sync, so the
    # syncs gate on this one
    dense1b, dense_syncs_b = count_syncs(lambda: rt.serve(cfg, trace1(),
                                                          **kw))
    dense_tps = (dense1.tok_per_s + dense1b.tok_per_s) / 2
    kv_blocks = paged1.engine.kv_blocks
    r1, d1, s1 = paged1.report, dense1.report, streamed.report
    stream_ok = all(streamed.stream.tokens(r) == list(streamed.outputs[r])
                    for r in streamed.outputs)
    p1 = dict(
        kv_blocks=kv_blocks, reserved_blocks=r1.reserved_blocks,
        live_tokens=r1.live_tokens, paged_tok_per_s=paged1.tok_per_s,
        dense_tok_per_s=[dense1.tok_per_s, dense1b.tok_per_s],
        paged_over_dense=paged1.tok_per_s / dense_tps,
        paged_host_syncs=r1.host_syncs, dense_host_syncs=d1.host_syncs,
        paged_host_syncs_per_token=r1.host_syncs_per_token,
        dense_host_syncs_per_token=d1.host_syncs_per_token,
        stream_host_syncs=s1.host_syncs, streamed_tokens=s1.streamed_tokens,
        cuda_syncs=dict(dense=[dense_syncs, dense_syncs_b],
                        paged=paged_syncs, streamed=stream_syncs),
        stream_events=s1.stream_events, stream_tok_per_s=streamed.tok_per_s,
        matmul_launches=launches,
        tokens_equal_phase5=same(paged1.outputs, p1_want),
        dense_equal_phase5=same(dense1.outputs, p1_want),
        stream_equal=same(streamed.outputs, p1_want) and stream_ok)
    out["p1"] = p1
    log("paged", f"P1 ({REQUESTS} x {PROMPT}+{MAX_NEW}, {SLOTS} slots, pages "
        f"of {PAGE}, kv_blocks {kv_blocks}, K {PIN['macro_step']}, chunk "
        f"{PIN['prefill_chunk']}): paged {paged1.tok_per_s:.2f} tok/s, dense "
        f"{dense1.tok_per_s:.2f} and {dense1b.tok_per_s:.2f} tok/s before "
        f"and after (x{p1['paged_over_dense']:.3f} their mean); "
        f"reserved_blocks {r1.reserved_blocks}, live_tokens "
        f"{r1.live_tokens}; host_syncs/token paged "
        f"{r1.host_syncs_per_token:.4f}, dense {d1.host_syncs_per_token:.4f}, "
        f"streamed {s1.host_syncs_per_token:.4f}; synchronizing CUDA calls "
        f"(sync debug mode, warmup included) dense {dense_syncs} and "
        f"{dense_syncs_b}, paged {paged_syncs}, streamed {stream_syncs}; "
        f"matmul kernel launches "
        f"{launches} ({card})")
    log("paged", f"P1 tokens == phase 5 static and continuous: paged "
        f"{p1['tokens_equal_phase5']}, dense {p1['dense_equal_phase5']}, "
        f"streamed {p1['stream_equal']} ({s1.streamed_tokens} tokens in "
        f"{s1.stream_events} events)")
    lo, hi = BASE_P1_CUDA_SYNCS
    if not (p1["tokens_equal_phase5"] and p1["dense_equal_phase5"]
            and p1["stream_equal"] and launches > 0
            and kv_blocks == default_kv_blocks(SLOTS, PROMPT + MAX_NEW, PAGE)
            and r1.host_syncs == d1.host_syncs == s1.host_syncs
            == BASE_P1_SYNCS
            and paged_syncs == stream_syncs == dense_syncs_b
            and lo <= paged_syncs <= hi
            and same(dense1b.outputs, p1_want)
            and s1.streamed_tokens == streamed.generated_tokens):
        log("paged", f"FAIL: P1 gate (tokens, stream, host syncs "
            f"{BASE_P1_SYNCS} and CUDA syncs {lo}-{hi} as before the "
            f"lifecycle, "
            f"launches)")
        return None

    # --- the odd row: max_len not a multiple of the page, so each slot's
    # gathered pages are longer than its dense row; paged == dense ==
    # static at that max_len (and, recorded, against phase 5's max_len)
    odd_pages = -(-ODD_MAX_LEN // PAGE)
    kw = dict(model=model, params=params, slots=SLOTS, eos_id=-1,
              max_len=ODD_MAX_LEN)
    odd_static = rt.serve(cfg, trace1(), mode="static", **kw)
    odd_dense = rt.serve(cfg, trace1(), **kw)
    odd_paged = rt.serve(cfg, trace1(), paged=True, block_size=PAGE, **kw)
    odd = dict(max_len=ODD_MAX_LEN, pages_per_slot=odd_pages,
               gathered_len=odd_pages * PAGE,
               paged_equal_dense=same(odd_paged.outputs, odd_dense.outputs),
               dense_equal_static=same(odd_dense.outputs, odd_static.outputs),
               equal_phase5=same(odd_paged.outputs, p1_want),
               paged_tok_per_s=odd_paged.tok_per_s,
               dense_tok_per_s=odd_dense.tok_per_s)
    out["odd_max_len"] = odd
    log("paged", f"odd row: max_len {ODD_MAX_LEN} ({odd_pages} pages of "
        f"{PAGE} = {odd_pages * PAGE} gathered positions): paged == dense "
        f"{odd['paged_equal_dense']}, dense == static "
        f"{odd['dense_equal_static']}; == phase 5 (max_len "
        f"{PROMPT + MAX_NEW}) {odd['equal_phase5']} ({card})")
    if not (odd["paged_equal_dense"] and odd["dense_equal_static"]):
        log("paged", "FAIL: the odd row's paged tokens differ from the "
            "dense and static runs' at the same max_len")
        return None
    del odd_static, odd_dense, odd_paged

    # --- P2: system-prompt traffic, four ways
    trace2 = lambda: synthetic_trace(  # noqa: E731
        P2_REQUESTS, prompt_len=P2_PROMPT, max_new=SHORT_NEW,
        vocab_size=cfg.vocab_size, arrival="all", prefix_share=1.0,
        prefix_len=P2_PREFIX, seed=0)
    kw = dict(model=model, params=params, slots=SLOTS, eos_id=-1)
    static2 = rt.serve(cfg, trace2(), mode="static", **kw)
    runs, rows, prefill_s = {}, {}, {}
    # dense before and after the paged runs (the host's speed drifts); the
    # prefill walls are the ledger's measured prefill rows of the timed run
    for how in ("dense", "force", "auto", "dense after"):
        n0 = len(rt.ledger.entries)
        paging = {} if how.startswith("dense") else dict(
            paged=True, block_size=PAGE, prefix_cache=how)
        runs[how] = rt.serve(cfg, trace2(), **paging, **kw)
        new = rt.ledger.entries[n0:]
        rows[how] = [dict(choice=e.choice, hit=e.query["hit_tokens"],
                          predicted_s=e.predicted_s, measured_s=e.measured_s,
                          note=e.note)
                     for e in new
                     if e.site == "serve_prefix" and e.measured_s is not None
                     and "hit=" in (e.note or "")]
        prefill = [e.measured_s for e in new if e.site == "serve"
                   and e.measured_s is not None
                   and (e.note or "").startswith("prefill")]
        prefill_s[how] = sum(prefill[1:])  # the warmup's prefill left out
    dense2 = runs.pop("dense")
    dense2b = runs.pop("dense after")
    dense2_tps = (dense2.tok_per_s + dense2b.tok_per_s) / 2
    want = static2.outputs
    p2 = dict(static_tok_per_s=static2.tok_per_s,
              dense_tok_per_s=[dense2.tok_per_s, dense2b.tok_per_s],
              dense_prefill_s=[prefill_s["dense"], prefill_s["dense after"]],
              dense_prefilled_tokens=dense2.report.prefilled_tokens,
              dense_host_syncs_per_token=dense2.report.host_syncs_per_token,
              dense_equal=same(dense2.outputs, want)
              and same(dense2b.outputs, want))
    for how, res in runs.items():
        rep = res.report
        chose = {}
        for r in rows[how]:
            chose[r["choice"]] = chose.get(r["choice"], 0) + 1
        p2[how] = dict(
            tok_per_s=res.tok_per_s,
            over_dense=res.tok_per_s / dense2_tps,
            prefill_s=prefill_s[how],
            prefilled_tokens=rep.prefilled_tokens,
            prefix_hit_tokens=rep.prefix_hit_tokens,
            prefix_hit_rate=rep.prefix_hit_rate, cow_count=rep.cow_count,
            reserved_blocks=rep.reserved_blocks, host_syncs=rep.host_syncs,
            host_syncs_per_token=rep.host_syncs_per_token,
            device_dispatches=rep.device_dispatches, verdicts=chose,
            serve_prefix_rows=rows[how], equal=same(res.outputs, want))
        log("paged", f"P2 {how}: {res.tok_per_s:.2f} tok/s "
            f"(x{p2[how]['over_dense']:.3f} dense), prefill walls "
            f"{prefill_s[how]:.3f} s, prefilled "
            f"{rep.prefilled_tokens} of {P2_REQUESTS * P2_PROMPT} prompt "
            f"tokens, prefix_hit_tokens {rep.prefix_hit_tokens}, hit rate "
            f"{rep.prefix_hit_rate:.4f}, CoW {rep.cow_count}, reserved_blocks "
            f"{rep.reserved_blocks}, host_syncs/token "
            f"{rep.host_syncs_per_token:.4f}; serve_prefix verdicts {chose} "
            f"({card})")
        for r in rows[how][:3]:
            log("ledger", f"  serve_prefix {r['choice']} {r['note']}: "
                f"predicted {r['predicted_s']:.3e} s, measured "
                f"{r['measured_s']:.3e} s")
    log("paged", f"P2 ({P2_REQUESTS} x {P2_PROMPT}+{SHORT_NEW}, prefix "
        f"{P2_PREFIX}, {SLOTS} slots): static {static2.tok_per_s:.2f} tok/s, "
        f"dense {dense2.tok_per_s:.2f} and {dense2b.tok_per_s:.2f} tok/s "
        f"before and after (prefill walls {prefill_s['dense']:.3f} and "
        f"{prefill_s['dense after']:.3f} s, prefilled "
        f"{dense2.report.prefilled_tokens}); tokens equal to static: dense "
        f"{p2['dense_equal']}, force {p2['force']['equal']}, auto "
        f"{p2['auto']['equal']}")
    out["p2"] = p2
    if not (p2["dense_equal"] and p2["force"]["equal"] and p2["auto"]["equal"]
            and p2["dense_prefilled_tokens"] == P2_REQUESTS * P2_PROMPT
            and 2 * p2["force"]["prefilled_tokens"]
            <= p2["dense_prefilled_tokens"]):
        log("paged", "FAIL: P2 gate (four runs token-identical, the forced "
            "run prefilling at most half the dense run's tokens)")
        return None
    out["dedupe"] = dedupe_check(model, params, trace2(), card)
    if out["dedupe"] is None:
        return None
    del static2, dense2, dense2b, runs

    # --- one decode step, paged against dense (P1's shape)
    max_len = PROMPT + MAX_NEW
    feed = torch.ones((SLOTS, 1), dtype=torch.int64, device="cuda")
    dense_state = model.init_decode_state(SLOTS, max_len, per_slot=True)
    per_slot = -(-max_len // PAGE)
    paged_state = model.init_decode_state(
        SLOTS, max_len, per_slot=True,
        paging=(SLOTS * per_slot + 1, PAGE))
    tables = torch.arange(1, SLOTS * per_slot + 1, device="cuda").reshape(
        SLOTS, per_slot)
    batch = {"tokens": feed, "block_tables": tables}
    mm_launches.reset()
    with RouteAudit(ops, mm) as audit:
        model.decode_step(params, paged_state, batch)
    step_matmul_launches = mm_launches.count
    # walls in turns (dense, paged, paged, dense): the host's speed drifts
    args = {"dense": (dense_state, {"tokens": feed}),
            "paged": (paged_state, batch)}
    walls = {"dense": [], "paged": []}
    for how in ("dense", "paged", "paged", "dense"):
        walls[how].append(step_wall(model, params, *args[how]))
    steps = {how: step_split(model, params, *args[how],
                             sum(walls[how]) / len(walls[how]))
             for how in args}
    for how, st in steps.items():
        log("paged", f"one {how} decode step ({SLOTS} slots, max_len "
            f"{max_len}): wall {st['wall_ms']:.3f} ms, device "
            f"{st['device_ms']:.3f} ms, matmul {st['matmul_ms']:.3f} ms, "
            f"indexing kernels {st['indexing_ms']:.3f} ms, other "
            f"{st['other_ms']:.3f} ms; {st['launches']} kernel launches "
            f"(phase 5's whole model's dense step: {dense_step_launches}) "
            f"({card})")
    log("paged", f"  paged indexing kernels: {steps['paged']['indexing_kernels']}")
    out["decode_step"] = dict(steps, matmul_launches=step_matmul_launches,
                              routing=audit.counts)
    if not audit.report("paged") or any(
            st["library_gemms"] for st in steps.values()):
        return None
    del dense_state, paged_state, model, params
    torch.cuda.empty_cache()

    # --- rwkv6-3b paged: full width, depth cut to 4 layers
    rcfg4 = dataclasses.replace(rcfg, n_layers=4)
    rmodel = build_model(rcfg4, rt.device)
    rparams = rmodel.init(0)
    kw = dict(model=rmodel, params=rparams, slots=SLOTS, eos_id=-1)
    rstatic = rt.serve(rcfg4, trace1(), mode="static", **kw)
    rdense = rt.serve(rcfg4, trace1(), **kw)
    rpaged = rt.serve(rcfg4, trace1(), paged=True, block_size=PAGE,
                      prefix_cache="force", **kw)
    rw = dict(layers=rcfg4.n_layers, static_tok_per_s=rstatic.tok_per_s,
              dense_tok_per_s=rdense.tok_per_s,
              paged_tok_per_s=rpaged.tok_per_s,
              prefix_reuse=rpaged.engine.prefix_cache,
              prefix_hit_tokens=rpaged.report.prefix_hit_tokens,
              equal=same(rpaged.outputs, rdense.outputs)
              and same(rdense.outputs, rstatic.outputs))
    out["rwkv"] = rw
    log("paged", f"rwkv6-3b full width, 4 of {rcfg.n_layers} layers, bf16: "
        f"paged == dense == static tokens {rw['equal']}; prefix reuse "
        f"{rw['prefix_reuse']}; paged {rpaged.tok_per_s:.2f} tok/s, dense "
        f"{rdense.tok_per_s:.2f} ({card})")
    if not rw["equal"] or rw["prefix_reuse"] or rw["prefix_hit_tokens"]:
        log("paged", "FAIL: rwkv6-3b paged gate")
        return None
    del rmodel, rparams, rstatic, rdense, rpaged
    torch.cuda.empty_cache()

    # --- the quickstart on the card (reduced config)
    t0 = time.perf_counter()
    qs = subprocess.run([sys.executable,
                         str(ROOT / "examples" / "torch_quickstart.py")],
                        capture_output=True, text=True, timeout=600,
                        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    out["quickstart"] = dict(rc=qs.returncode,
                             wall_s=time.perf_counter() - t0,
                             tail=qs.stdout[-1500:])
    log("paged", f"examples/torch_quickstart.py on the card: exit "
        f"{qs.returncode} in {out['quickstart']['wall_s']:.1f} s; "
        + " / ".join(line for line in qs.stdout.splitlines()
                     if "matched" in line))
    if qs.returncode != 0:
        log("paged", f"FAIL: quickstart: {qs.stderr[-2000:]}")
        return None
    return out


def rwkv_train_phase(cfg, wkv_k, mm_launches):
    """Runtime.train of full-width, full-depth rwkv6-3b (random weights,
    bf16) for TRAIN_STEPS steps at TRAIN_BATCH x TRAIN_SEQ without a
    checkpoint (it would write ~37 GB): every loss finite, the kernels'
    calls per step (WKV: a forward per layer and per recomputation, a
    backward per layer), step wall, tokens/s and peak memory; then one more
    step timed and one profiled (device busy share, device ms by kernel).
    None on a failure."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.runtime import Runtime
    from repro_torch.training import TrainLoopConfig, make_train_step

    rt = Runtime(device="cuda")
    lines, plans = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mm_launches.reset()
    wkv_k.LAUNCHES.reset()
    res = rt.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                   seed=0, log_every=1, log=lines.append,
                   on_plan=plans.append)
    torch.cuda.synchronize()
    counts = dict(matmul=mm_launches.count, wkv_forward=wkv_k.LAUNCHES.forward,
                  wkv_backward=wkv_k.LAUNCHES.backward,
                  wkv_cuda=sum(wkv_k.LAUNCHES.cuda.values()),
                  **{f"matmul {p}": n for p, n in mm_launches.by_path.items()},
                  **{f"wkv {kk}": n for kk, n in wkv_k.LAUNCHES.cuda.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = [dict(step=int(m.group(1)), loss=float(m.group(2)),
                  ms=float(m.group(3))) for m in
             (re.match(r"step\s+(\d+) loss (\S+) .* (\d+)ms$", x)
              for x in lines) if m]
    for line in lines:
        log("rwkv-train", line)
    for line in plans[0].summary().splitlines():
        log("rwkv-train", "plan " + line.strip())
    per_step = {k: v // TRAIN_STEPS for k, v in counts.items()}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = [x["ms"] for x in steps[1:]]
    tok_s = tokens * len(steady) / (sum(steady) / 1e3) if steady else 0.0
    log("rwkv-train", f"rwkv6-3b full width ({cfg.n_layers} layers) bf16, "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}: {res.steps_run} steps in "
        f"{res.wall_s:.2f} s, final loss {res.final_loss:.4f}, diverged "
        f"{res.diverged}; {tok_s:.1f} tokens/s over steps 1-"
        f"{TRAIN_STEPS - 1}; peak memory {peak_gb:.2f} GB; launches per "
        f"step {per_step}")
    ok = (res.steps_run == TRAIN_STEPS and not res.diverged
          and math.isfinite(res.final_loss) and len(steps) == TRAIN_STEPS
          and all(math.isfinite(x["loss"]) for x in steps)
          and counts["matmul"] > 0
          and per_step["wkv_forward"] == 2 * cfg.n_layers
          and per_step["wkv_backward"] == cfg.n_layers
          and per_step["wkv_cuda"] == 2 * cfg.n_layers * len(
              wkv_k.FORWARD_KERNELS) + cfg.n_layers * len(
              wkv_k.BACKWARD_KERNELS)
          and all(v % TRAIN_STEPS == 0 for v in counts.values()))
    if not ok:
        log("rwkv-train", "FAIL: a step was not finite, the run stopped "
            "early, or the WKV kernels did not run once forward per layer "
            "and recomputation and once backward per layer (each call its "
            "kernels once)")
        return None

    # one more step timed, and one profiled, from the trained state, each
    # written into it as Runtime.train's steps are
    model = build_model(cfg, "cuda")
    step_fn = make_train_step(model, TrainLoopConfig(
        warmup_steps=max(TRAIN_STEPS // 20, 1), total_steps=TRAIN_STEPS),
        donate=True)
    batch = SyntheticLMData(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                            seed=0, device="cuda").batch_at(TRAIN_STEPS)
    state = res.state
    del res
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    extra_loss = float(metrics["loss"])
    wall = (time.perf_counter() - t0) * 1e3
    del metrics
    with RouteAudit(ops, mm) as audit:
        by_name, events = device_ms_by_kernel(lambda: step_fn(state, batch))
    device_ms = sum(by_name.values())
    split = group_device_ms(by_name, {
        "wkv forward": "|".join((WKV_KERNELS["wkv state forward"],
                                 WKV_KERNELS["wkv output"])),
        "wkv backward": "|".join((WKV_KERNELS["wkv state backward"],
                                  WKV_KERNELS["wkv backward chunk"]))})
    wkv_parts = {g: sum(ms for kk, ms in by_name.items()
                        if re.search(key, kk))
                 for g, key in WKV_KERNELS.items()}
    if events == 0:
        log("rwkv-train", f"one more step: wall {wall:.1f} ms, loss "
            f"{extra_loss:.4f}; device time not measured (the profiler saw "
            f"no kernels)")
    else:
        log("rwkv-train", f"one more step: wall {wall:.1f} ms, loss "
            f"{extra_loss:.4f}; profiled: {events} device events, device "
            f"busy {device_ms:.1f} ms ({100 * device_ms / wall:.1f}% of the "
            f"timed step); " + ", ".join(f"{g} {v:.1f} ms"
                                         for g, v in split.items()))
        log("rwkv-train", "  wkv by kernel: " + ", ".join(
            f"{g} {v:.1f} ms" for g, v in wkv_parts.items()))
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log("rwkv-train", f"  {ms:9.2f} ms  {name[:90]}")
    if not math.isfinite(extra_loss) or not audit.report("rwkv-train") \
            or library_gemms("rwkv-train", by_name):
        return None
    plan = plans[0]
    return dict(steps=steps, final_loss=steps[-1]["loss"], tok_per_s=tok_s,
                peak_memory_gb=peak_gb, launches_per_step=per_step,
                wkv_calls_per_step=per_step["wkv_forward"]
                + per_step["wkv_backward"],
                plan=dict(decisions=[dataclasses.asdict(d)
                                     for d in plan.decisions],
                          rnn_chunk=plan.rnn_chunk, fits_hbm=plan.fits_hbm,
                          hbm_per_chip=plan.hbm_per_chip),
                extra_step_ms=wall, extra_step_loss=extra_loss,
                wkv_cuda_launches_per_step=per_step["wkv_cuda"],
                profile=dict(events=events, device_ms=device_ms,
                             wall_ms=wall, by_group=split,
                             wkv_by_kernel=wkv_parts,
                             top=sorted(by_name.items(),
                                        key=lambda kv: -kv[1])[:12]))


class StartedThreads:
    """Counts the threads started inside the block (threading.Thread.start
    wrapped): the unperturbed path must start none, the watchdog one a
    guarded step."""

    def __enter__(self):
        import threading

        self.names = []
        self._start = start = threading.Thread.start
        names = self.names

        def counting(thread, *a, **kw):
            names.append(thread.name)
            return start(thread, *a, **kw)

        threading.Thread.start = counting
        return self

    def __exit__(self, *exc):
        import threading

        threading.Thread.start = self._start
        return False


class TripAfter:
    """A stop event that 'fires' once the engine has polled it ``polls``
    times: a shutdown in the middle of a run, on no clock."""

    def __init__(self, polls):
        self.left = polls

    def is_set(self):
        self.left -= 1
        return self.left < 0


def tick_clock(dt=1e-3):
    """A clock that advances ``dt`` on every read: deadlines and arrivals
    resolve the same on a fast host and a slow one."""
    t = [0.0]

    def now():
        t[0] += dt
        return t[0]

    return now


def ledger_rows(ledger, sites=("serve", "serve_macro", "serve_admit")):
    """The serve ledger's rows, predicted beside measured (None where the
    row was not measured), for the JSON record."""
    return [dict(site=e.site, choice=e.choice, predicted_s=e.predicted_s,
                 measured_s=e.measured_s, correction=e.correction,
                 note=e.note, query={k: v for k, v in e.query.items()
                                     if isinstance(v, (int, float, str))})
            for e in ledger.entries if e.site in sites]


def lifecycle_phase(cfg, rcfg, p1_want, phase5_syncs, mm_launches, card):
    """Phase 16: the serving request lifecycle on full-width tinyllama-1.1b
    at the depth ``cfg`` gives (bf16, seed 0, 4 slots, phase 5's trace and
    max_len; ``p1_want`` and ``phase5_syncs`` phase 5's tokens and host
    syncs at that depth), dense and paged
    (pages of 16): the unperturbed path untouched, priority preemption,
    deadlines, the fault classes under the watchdog and retries,
    abandonment, graceful stops and the launcher; overload on the real
    clock and serve_admit with and without the correction loop recorded;
    rwkv6-3b (4 layers) raise and preemption drills.  None on any failed
    gate."""
    import threading

    from repro_torch.models import build_model
    from repro_torch.models.model import is_page_pool
    from repro_torch.runtime import Runtime, RuntimeConfig, synthetic_trace
    from repro_torch.serving import (ContinuousServeEngine, FatalFault,
                                     FaultInjector, FaultSpec, Request)
    from repro_torch.serving.scheduler import ServeScheduler
    from repro_torch.tree import leaves_with_paths

    t_phase = time.perf_counter()
    out: dict = {"card": card}
    rt = Runtime(device="cuda")
    model = build_model(cfg, rt.device)
    params = model.init(0)
    max_len = PROMPT + MAX_NEW
    trace = lambda: synthetic_trace(  # noqa: E731
        REQUESTS, prompt_len=PROMPT, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="all", seed=0)
    prompts = {r.rid: np.asarray(r.prompt) for r in trace()}
    fails = []

    def gate(ok: bool, what: str) -> bool:
        if not ok:
            fails.append(what)
            log("lifecycle", f"FAIL: {what}")
        return ok

    def want(rid, n=MAX_NEW):
        return [int(t) for t in p1_want[rid][:n]]

    def toks(r):
        return [int(t) for t in r.tokens]

    def reqs(n, new, extra=None):
        """phase 5's first ``n`` requests with ``new`` tokens each;
        ``extra`` maps a rid to Request keywords."""
        extra = extra or {}
        return [Request(f"r{i}", prompts[f"r{i}"], new,
                        **extra.get(f"r{i}", {})) for i in range(n)]

    def engine(**kw):
        kw.setdefault("n_slots", SLOTS)
        kw.setdefault("max_len", max_len)
        kw.setdefault("eos_id", -1)
        return ContinuousServeEngine(model, params, cost_engine=rt.engine,
                                     **kw)

    def drill_clean(rep, n=DRILL_REQUESTS, new=DRILL_NEW):
        return all(toks(r) == want(r.rid, new) for r in rep.requests
                   if r.state.value == "COMPLETED")

    def serve_again(eng, label):
        """After a drill, the same engine serves phase 5's trace again, its
        8 requests cut to DRILL_NEW new tokens each."""
        eng.injector, eng.watchdog_s, eng.max_retries = None, None, 2
        rep = eng.run(reqs(REQUESTS, DRILL_NEW), now_fn=lambda: 0.0)
        ok = (rep.state_counts() == {"COMPLETED": REQUESTS}
              and all(toks(r) == want(r.rid, DRILL_NEW)
                      for r in rep.requests))
        gate(ok, f"{label}: the engine serves phase 5's trace again with "
             f"equal tokens")
        return ok

    # --- the unperturbed path: phase 5's continuous serve, untouched
    n0 = len(rt.ledger.entries)
    with StartedThreads() as threads:
        base, base_cuda_syncs = count_syncs(lambda: rt.serve(
            cfg, trace(), model=model, params=params, slots=SLOTS,
            eos_id=-1))
    admits = [e for e in rt.ledger.entries[n0:] if e.site == "serve_admit"]
    out["unperturbed"] = dict(
        host_syncs=base.report.host_syncs, phase5_host_syncs=phase5_syncs,
        cuda_syncs=base_cuda_syncs, threads_started=len(threads.names),
        serve_admit_rows=len(admits), tok_per_s=base.tok_per_s,
        tokens_equal_phase5=all([int(t) for t in v] == want(r)
                                for r, v in base.outputs.items()))
    log("lifecycle", f"unperturbed phase 5 trace: tokens == phase 5 "
        f"{out['unperturbed']['tokens_equal_phase5']}, host syncs "
        f"{base.report.host_syncs} (phase 5 {phase5_syncs}, before the "
        f"lifecycle "
        f"{BASE_PHASE5_SYNCS}), synchronizing CUDA calls {base_cuda_syncs}, "
        f"threads started {len(threads.names)}, serve_admit queries "
        f"{len(admits)} ({card})")
    gate(out["unperturbed"]["tokens_equal_phase5"]
         and base.report.host_syncs == phase5_syncs == BASE_PHASE5_SYNCS
         and not threads.names and not admits,
         "unperturbed: phase 5's tokens and host syncs, no thread, no "
         "serve_admit query")
    del base

    # --- priority preemption, dense and paged: 4 low-priority requests fill
    # the slots, a late priority-5 request evicts one; the victim
    # re-prefills prompt + generated (paged: re-pinning its prompt's pages)
    for how in ("dense", "paged"):
        paging = dict(paged=True, block_size=PAGE, prefix_cache="force",
                      kv_blocks=2 * (SLOTS * -(-max_len // PAGE)) + 1) \
            if how == "paged" else {}
        eng = engine(**paging)
        # the late request arrives after the first macro-step (every clock
        # read is 1 ms), while the others still have tokens to make
        rs = reqs(SLOTS + 1, MAX_NEW,
                  {f"r{SLOTS}": dict(arrival_s=0.003, priority=5)})
        if how == "dense":
            mm_launches.reset()
        rep = eng.run(rs, now_fn=tick_clock())
        if how == "dense":
            torch.cuda.synchronize()
            out["matmul_launches"] = mm_launches.count
        victims = [r for r in rep.requests if r.preemptions]
        row = dict(states=rep.state_counts(), preemptions=rep.preemptions,
                   victims=[r.rid for r in victims],
                   tokens_equal={r.rid: toks(r) == want(r.rid)
                                 for r in rep.requests},
                   first_token_s={r.rid: r.first_token_s
                                  for r in rep.requests},
                   prefix_hit_tokens=rep.prefix_hit_tokens,
                   host_syncs=rep.host_syncs)
        if how == "paged":
            blocks = eng.pool.blocks
            row.update(used_blocks=blocks.used_blocks,
                       trie_blocks=blocks.trie_blocks)
        out[f"preempt_{how}"] = row
        log("lifecycle", f"preemption {how}: states {row['states']}, "
            f"victims {row['victims']} ({rep.preemptions} preemptions), "
            f"tokens == phase 5 {row['tokens_equal']}, prefix hits "
            f"{rep.prefix_hit_tokens}"
            + (f", used_blocks {row['used_blocks']} == trie pins "
               f"{row['trie_blocks']}" if how == "paged" else "")
            + f" ({card})")
        gate(row["states"] == {"COMPLETED": SLOTS + 1} and victims
             and all(row["tokens_equal"].values())
             and (how == "dense" or (row["used_blocks"] == row["trie_blocks"]
                                     and rep.prefix_hit_tokens > 0)),
             f"preemption {how}: a victim, every token equal to phase 5's"
             + (", pages back to the trie's pins, the prefix re-pinned"
                if how == "paged" else ""))
        del eng
    gate(out.get("matmul_launches", 0) > 0,
         "the matmul kernel launched on the lifecycle path")

    # --- deadlines on the tick clock
    dl = {}
    eng = engine(n_slots=1)
    rep = eng.run(reqs(2, 8, {"r1": dict(deadline_s=0.002)}),
                  now_fn=tick_clock())
    late = rep.requests[1]
    dl["queued"] = dict(states=rep.state_counts(), reason=late.reason)
    gate(late.state.value == "TIMED_OUT"
         and late.reason == "deadline expired while queued"
         and toks(rep.requests[0]) == want("r0", 8),
         "a deadline expiring while queued ends TIMED_OUT")
    eng = engine(n_slots=1, macro_step=1)
    rep = eng.run(reqs(1, MAX_NEW, {"r0": dict(deadline_s=0.1)}),
                  now_fn=tick_clock(5e-3))
    r0 = rep.requests[0]
    dl["decoding"] = dict(state=r0.state.value, reason=r0.reason,
                          tokens=len(r0.tokens),
                          free_slots=eng.pool.free_count)
    gate(r0.state.value == "TIMED_OUT" and "decoding" in (r0.reason or "")
         and 0 < len(r0.tokens) < MAX_NEW and eng.pool.free_count == 1
         and toks(r0) == want("r0", len(r0.tokens)),
         "a deadline passing while decoding ends TIMED_OUT and frees the "
         "slot")
    eng = engine(n_slots=1, queue_limit=1)
    rep = eng.run(reqs(4, 4), now_fn=lambda: 0.0)
    dl["queue_full"] = dict(states=rep.state_counts(),
                            reasons=[r.reason for r in rep.requests])
    gate(rep.state_counts() == {"COMPLETED": 1, "REJECTED": 3}
         and all(r.reason == "queue_full" for r in rep.requests
                 if r.state.value == "REJECTED"),
         "queue_limit rejects the overflow as queue_full")
    n0 = len(rt.ledger.entries)
    eng = engine(n_slots=2)
    rep = eng.run(reqs(2, 4, {"r1": dict(deadline_s=1e-12)}),
                  now_fn=lambda: 0.0)
    shed = [e for e in rt.ledger.entries[n0:] if e.site == "serve_admit"]
    dl["infeasible"] = dict(states=rep.state_counts(),
                            reason=rep.requests[1].reason,
                            serve_admit=[(e.choice, e.predicted_s)
                                         for e in shed])
    gate(rep.requests[1].reason == "deadline_infeasible"
         and rep.requests[1].state.value == "REJECTED"
         and any(e.choice == "shed" for e in shed)
         and rep.requests[0].state.value == "COMPLETED",
         "an infeasible deadline is shed as deadline_infeasible with a "
         "serve_admit row")
    out["deadlines"] = dl
    log("lifecycle", f"deadlines: {dl} ({card})")
    del eng

    # --- the fault classes on one dense engine, each followed by phase 5's
    # trace on the same engine
    eng = engine()
    drills = [("raise macro", FaultSpec("raise", site="macro", after=1),
               None, 2),
              ("stall macro", FaultSpec("stall", site="macro", after=1,
                                        stall_s=30.0), STALL_WATCHDOG_S, 2),
              ("raise prefill", FaultSpec("raise", site="prefill", after=0),
               None, 2),
              ("nan macro", FaultSpec("nan", site="macro", after=0), None,
               2),
              ("exhausted", FaultSpec("raise", site="macro", after=0,
                                      count=100), None, 1)]
    faults = {}
    for label, spec, watchdog, retries in drills:
        eng.injector = FaultInjector((spec,))
        eng.watchdog_s, eng.max_retries = watchdog, retries
        t0 = time.perf_counter()
        with StartedThreads() as threads:
            rep = eng.run(reqs(DRILL_REQUESTS, DRILL_NEW),
                          now_fn=lambda: 0.0)
        wall = time.perf_counter() - t0
        states = rep.state_counts()
        faults[label] = dict(states=states, retries=rep.step_retries,
                             watchdog_fires=rep.watchdog_fires,
                             threads_started=len(threads.names),
                             reasons=sorted({r.reason for r in rep.requests
                                             if r.reason}),
                             injected=eng.injector.injected, wall_s=wall)
        if label == "nan macro":
            ok = (states == {"COMPLETED": DRILL_REQUESTS - 1, "FAILED": 1}
                  and drill_clean(rep)
                  and all("corrupt" in (r.reason or "") for r in
                          rep.requests if r.state.value == "FAILED"))
        elif label == "exhausted":
            ok = (states == {"FAILED": DRILL_REQUESTS}
                  and all("macro step failed" in r.reason
                          for r in rep.requests)
                  and eng.pool.free_count == SLOTS)
        else:
            ok = (states == {"COMPLETED": DRILL_REQUESTS}
                  and rep.step_retries >= 1 and drill_clean(rep)
                  and (watchdog is None or (rep.watchdog_fires >= 1
                                            and threads.names)))
        log("lifecycle", f"fault {label}: states {states}, retries "
            f"{rep.step_retries}, watchdog fires {rep.watchdog_fires}, "
            f"threads {len(threads.names)}, {wall:.2f} s ({card})")
        gate(ok, f"fault {label} behaves as its class says")
        serve_again(eng, f"fault {label}")
    del eng
    eng = engine(paged=True, block_size=PAGE)
    eng.injector = FaultInjector((FaultSpec("raise", site="macro", after=0,
                                            fatal=True),))
    rs = reqs(DRILL_REQUESTS, DRILL_NEW)
    try:
        eng.run(rs, now_fn=lambda: 0.0)
        raised = False
    except FatalFault:
        raised = True
    blocks = eng.pool.blocks
    faults["fatal paged"] = dict(
        raised=raised, states=sorted({r.state.value for r in rs}),
        used_blocks=blocks.used_blocks, trie_blocks=blocks.trie_blocks,
        free_slots=eng.pool.free_count)
    log("lifecycle", f"fault fatal (paged): {faults['fatal paged']}")
    gate(raised and all(r.state.terminal for r in rs)
         and blocks.used_blocks == 0 and blocks.trie_blocks == 0
         and eng.pool.free_count == SLOTS,
         "a fatal fault propagates and leaves the BlockPool empty")
    serve_again(eng, "fault fatal paged")
    out["faults"] = faults
    del eng

    # --- the guarded call runs the same kernels as the direct call, on a
    # worker thread under the caller's device, stream and grad mode (a
    # parameter that needs a gradient, served under no_grad)
    guarded = {}
    leaf = params["unembed"]
    for how in ("dense", "paged"):
        paging = dict(paged=True, block_size=PAGE) if how == "paged" else {}
        eng = engine(**PIN, **paging)
        seen = []
        main_stream = torch.cuda.current_stream().cuda_stream
        real_prefill, real_macro = eng._prefill, eng._macro(PIN["macro_step"])

        def spy(fn):
            def wrapped(*a):
                first, st = fn(*a)
                seen.append(dict(
                    thread=threading.current_thread().name,
                    grad=torch.is_grad_enabled(),
                    requires_grad=first.requires_grad,
                    device=torch.cuda.current_device(),
                    stream=torch.cuda.current_stream().cuda_stream))
                return first, st
            return wrapped

        eng._prefill = spy(real_prefill)
        eng._macro_fns[PIN["macro_step"]] = spy(real_macro)
        runs = {}
        leaf.requires_grad_(True)
        try:
            for mode, wd in (("direct", None), ("guarded", 5.0)):
                eng.watchdog_s = wd
                seen.clear()
                torch.cuda.synchronize()
                mm_launches.reset()
                with torch.no_grad(), StartedThreads() as threads:
                    rep = eng.run(reqs(DRILL_REQUESTS, DRILL_NEW),
                                  now_fn=lambda: 0.0)
                torch.cuda.synchronize()
                runs[mode] = dict(
                    by_path=dict(mm_launches.by_path),
                    launches=mm_launches.count,
                    threads_started=len(threads.names),
                    workers=sorted({s["thread"] for s in seen}),
                    grad=any(s["grad"] for s in seen),
                    requires_grad=any(s["requires_grad"] for s in seen),
                    same_stream=all(s["stream"] == main_stream
                                    for s in seen),
                    same_device=all(s["device"] == torch.cuda.current_device()
                                    for s in seen),
                    tokens_equal=drill_clean(rep)
                    and rep.state_counts() == {"COMPLETED": DRILL_REQUESTS})
        finally:
            leaf.requires_grad_(False)
        guarded[how] = runs
        d, g = runs["direct"], runs["guarded"]
        log("lifecycle", f"guarded vs direct ({how}): matmul launches by "
            f"path {g['by_path']} vs {d['by_path']}; threads started "
            f"{g['threads_started']} vs {d['threads_started']}; on the "
            f"worker: grad {g['grad']}, output requires grad "
            f"{g['requires_grad']}, same stream {g['same_stream']}, same "
            f"device {g['same_device']}; tokens equal {g['tokens_equal']}, "
            f"{d['tokens_equal']}")
        gate(g["by_path"] == d["by_path"] and g["launches"] > 0
             and g["threads_started"] > 0 and d["threads_started"] == 0
             and "MainThread" not in g["workers"]
             and not g["grad"] and not g["requires_grad"]
             and g["same_stream"] and g["same_device"]
             and g["tokens_equal"] and d["tokens_equal"],
             f"the guarded step ({how}) runs the direct step's kernels on "
             f"a worker under the caller's stream and grad mode")
        del eng
    out["guarded"] = guarded

    # --- abandonment: a step that ignores cancellation outlives the grace
    # join, then writes into the pools it captured
    eng = engine(paged=True, block_size=PAGE, **PIN)
    k = PIN["macro_step"]
    real = eng._macro(k)
    woke, checked = threading.Event(), threading.Event()
    worker = []

    def pools(state):
        return [leaf_ for path, leaf_ in leaves_with_paths(state["layers"])
                if is_page_pool(path)]

    def hung(params_, state, *args):
        worker.append(threading.current_thread())
        time.sleep(1.5)
        for p_ in pools(state):
            p_.fill_(7.0)
        torch.cuda.synchronize()
        woke.set()
        checked.wait(30.0)
        return real(params_, state, *args)

    eng._macro_fns[k] = hung
    eng.watchdog_s = 0.5
    before = pools(eng.pool.state)
    rep = eng.run(reqs(DRILL_REQUESTS, DRILL_NEW), now_fn=lambda: 0.0)
    after = pools(eng.pool.state)
    woke.wait(30.0)
    try:
        torch.cuda.synchronize()
        old_written = all(bool((b == 7).all()) for b in before)
        new_untouched = all(not bool(a.any()) for a in after)
    finally:
        checked.set()
        if worker:
            worker[0].join(60.0)
    torch.cuda.synchronize()
    ab = dict(states=rep.state_counts(), reasons=sorted(
        {r.reason for r in rep.requests}), watchdog_fires=rep.watchdog_fires,
        new_tensors=all(a.data_ptr() != b.data_ptr()
                        for a, b in zip(after, before)),
        old_pools_written=old_written, new_pools_untouched=new_untouched,
        used_blocks=eng.pool.blocks.used_blocks)
    eng._macro_fns[k] = real
    eng.watchdog_s = None
    again = eng.run(reqs(DRILL_REQUESTS, DRILL_NEW), now_fn=lambda: 0.0)
    ab["next_trace_equal"] = drill_clean(again) and \
        again.state_counts() == {"COMPLETED": DRILL_REQUESTS}
    out["abandoned"] = ab
    log("lifecycle", f"abandonment: {ab} ({card})")
    gate(ab["states"] == {"FAILED": DRILL_REQUESTS}
         and all("abandon" in r for r in ab["reasons"])
         and ab["new_tensors"] and ab["old_pools_written"]
         and ab["new_pools_untouched"] and ab["used_blocks"] == 0
         and ab["next_trace_equal"],
         "an abandoned step fails what is in flight and cannot reach the "
         "drained pool")
    del eng, before, after

    # --- stopping: a stop mid-run drains the active slots, rejects the queue
    eng = engine()
    eng.stop_event = TripAfter(1)
    rep = eng.run(reqs(SLOTS + 2, DRILL_NEW), now_fn=lambda: 0.0)
    stop = dict(states=rep.state_counts(),
                reasons={r.rid: r.reason for r in rep.requests})
    out["stop"] = stop
    log("lifecycle", f"stop mid-run: {stop}")
    gate(rep.state_counts() == {"COMPLETED": SLOTS, "REJECTED": 2}
         and drill_clean(rep)
         and all(r.reason == "shutdown: intake stopped"
                 for r in rep.requests if r.state.value == "REJECTED"),
         "a stop mid-run completes the active slots and rejects the queue")
    del eng
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "tinyllama-1.1b", "--requests", "8", "--max-new", "16",
           "--slots", "4", "--engine", "continuous", "--deadline-ms",
           "60000", "--inject-fault", "raise", "--watchdog-ms", "5000"]
    t0 = time.perf_counter()
    ls = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                        cwd=ROOT, env=dict(os.environ,
                                           PYTHONPATH=str(ROOT / "src")))
    states_line = [ln.strip() for ln in ls.stdout.splitlines()
                   if ln.strip().startswith("states ")]
    out["launcher"] = dict(cmd=" ".join(cmd[1:]), rc=ls.returncode,
                           wall_s=time.perf_counter() - t0,
                           states=states_line, stdout=ls.stdout[-3000:],
                           stderr=ls.stderr[-2000:])
    log("lifecycle", f"launcher: exit {ls.returncode} in "
        f"{out['launcher']['wall_s']:.1f} s; {states_line}")
    gate(ls.returncode == 0 and states_line
         and "retries 1" in states_line[0]
         and "'COMPLETED': 8" in states_line[0],
         "the launcher exits 0 and prints the lifecycle report")

    # --- recorded: overload on the real clock (the reference stress
    # bench's recipe, without its front end)
    kw = dict(model=model, params=params, slots=SLOTS, eos_id=-1,
              max_len=max_len)
    unloaded = rt.serve(cfg, trace(), **kw)
    rep_u = unloaded.report
    lat = [r.latency_s for r in rep_u.requests if r.latency_s is not None]
    mean_latency = float(np.mean(lat))
    service_rate = REQUESTS / rep_u.wall_s
    deadline_ms = DEADLINE_X * mean_latency * 1e3
    rate = OVERLOAD_FACTOR * service_rate
    over = rt.serve(cfg, synthetic_trace(
        OVERLOAD_REQUESTS, prompt_len=PROMPT, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="poisson", rate=rate, seed=1),
        queue_limit=2 * SLOTS, deadline_ms=deadline_ms,
        watchdog_ms=max(5000.0, 10 * deadline_ms), **kw)
    rep_o = over.report
    done = [r for r in rep_o.requests if r.state.value == "COMPLETED"]
    goodput = sum(len(r.tokens) for r in done) / rep_o.wall_s
    ttft = rep_o.ttft_percentiles()
    out["overload"] = dict(
        unloaded_tok_per_s=rep_u.tok_per_s, unloaded_mean_latency_s=mean_latency,
        service_rate_rps=service_rate, rate_rps=rate, deadline_ms=deadline_ms,
        queue_limit=2 * SLOTS, states=rep_o.state_counts(),
        completed_frac=len(done) / OVERLOAD_REQUESTS,
        goodput_tok_per_s=goodput,
        goodput_over_unloaded=goodput / rep_u.tok_per_s,
        ttft_p99_s=ttft["ttft_p99"],
        ttft_p99_over_unloaded_latency=ttft["ttft_p99"] / mean_latency,
        watchdog_fires=rep_o.watchdog_fires, wall_s=rep_o.wall_s,
        all_terminal=rep_o.all_terminal)
    log("lifecycle", f"overload (recorded): {out['overload']} ({card})")
    gate(rep_o.all_terminal and done,
         "overload: every request terminal, at least one completed")
    del unloaded, over

    # --- recorded: serve_admit with and without the correction loop, on a
    # calibrated runtime (phase 5's calibration cache), one warm trace first
    cache = ROOT / "build" / "calibration"
    probe_rt = Runtime(RuntimeConfig(device="cuda", calibrate=True,
                                     cache_dir=cache))
    sched = ServeScheduler(cfg, probe_rt.engine, max_len=max_len)
    _, raw = sched.serve_admit(Request("d0", prompts["r0"], MAX_NEW,
                                       deadline_s=1.0),
                               now=0.0, active=0, n_slots=SLOTS)
    deadline_s = 3.0 * raw.baseline.total  # admits unless corrected > 3x
    admit = {"raw_predicted_s": raw.baseline.total,
             "deadline_s": deadline_s}
    for corr in (False, True):
        crt = Runtime(RuntimeConfig(device="cuda", calibrate=True,
                                    corrections=corr, cache_dir=cache))
        crt.serve(cfg, trace(), **kw)  # the warm trace
        n0 = len(crt.ledger.entries)
        res = crt.serve(cfg, [Request("d0", prompts["r0"], MAX_NEW,
                                      deadline_s=deadline_s)], **kw)
        rows = [e for e in crt.ledger.entries[n0:]
                if e.site == "serve_admit"]
        d0 = res.report.requests[0]
        factors = ({s: crt.engine.corrections.factor(s)
                    for s in crt.engine.corrections.sites()}
                   if crt.engine.corrections is not None else {})
        admit["on" if corr else "off"] = dict(
            verdicts=[e.choice for e in rows],
            predicted_s=[e.predicted_s for e in rows],
            corrections=[e.correction for e in rows],
            measured_latency_s=d0.latency_s, state=d0.state.value,
            reason=d0.reason, site_factors=factors)
    admit["flipped"] = admit["off"]["verdicts"][-1:] != \
        admit["on"]["verdicts"][-1:]
    out["serve_admit"] = admit
    log("lifecycle", f"serve_admit (recorded): {admit} ({card})")

    out["ledger"] = ledger_rows(rt.ledger)
    del model, params
    torch.cuda.empty_cache()

    # --- rwkv6-3b, full width, 4 layers: a raise drill (gated) and a
    # preemption drill (recorded: re-prefill runs the chunked WKV kernel
    # over the generated tokens where decode ran wkv_step)
    rcfg4 = dataclasses.replace(rcfg, n_layers=4)
    rmodel = build_model(rcfg4, rt.device)
    rparams = rmodel.init(0)
    rkw = dict(n_slots=SLOTS, max_len=max_len, eos_id=-1,
               cost_engine=rt.engine)

    def rreqs(n, new, extra=None):
        extra = extra or {}
        return [Request(f"r{i}", prompts[f"r{i}"], new,
                        **extra.get(f"r{i}", {})) for i in range(n)]

    clean_eng = ContinuousServeEngine(rmodel, rparams, **rkw)
    clean = {r.rid: toks(r) for r in clean_eng.run(
        rreqs(SLOTS + 1, MAX_NEW), now_fn=lambda: 0.0).requests}
    reng = ContinuousServeEngine(rmodel, rparams, **rkw, injector=FaultInjector(
        (FaultSpec("raise", site="macro", after=1),)))
    rep = reng.run(rreqs(SLOTS, MAX_NEW), now_fn=lambda: 0.0)
    rw = dict(raise_states=rep.state_counts(), raise_retries=rep.step_retries,
              raise_equal=all(toks(r) == clean[r.rid] for r in rep.requests))
    gate(rep.state_counts() == {"COMPLETED": SLOTS} and rep.step_retries >= 1
         and rw["raise_equal"],
         "rwkv6-3b: a raise retries to the clean tokens")
    peng = ContinuousServeEngine(rmodel, rparams, **rkw)
    rep = peng.run(rreqs(SLOTS + 1, MAX_NEW,
                         {f"r{SLOTS}": dict(arrival_s=0.003, priority=5)}),
                   now_fn=tick_clock())
    first_diff = {}
    for r in rep.requests:
        got = toks(r)
        diff = next((i for i, (a, b) in enumerate(zip(got, clean[r.rid]))
                     if a != b), None)
        first_diff[r.rid] = diff
    rw.update(preempt_states=rep.state_counts(),
              preempt_victims=[r.rid for r in rep.requests if r.preemptions],
              preempt_first_diff=first_diff,
              preempt_equal={r.rid: first_diff[r.rid] is None
                             for r in rep.requests})
    out["rwkv"] = rw
    log("lifecycle", f"rwkv6-3b, 4 layers: {rw} ({card})")
    gate(rep.all_terminal, "rwkv6-3b preemption: every request terminal")
    del rmodel, rparams, clean_eng, reng, peng
    torch.cuda.empty_cache()

    out["wall_s"] = time.perf_counter() - t_phase
    out["fails"] = fails
    log("lifecycle", f"phase 16 wall {out['wall_s']:.1f} s; "
        f"{len(fails)} failed gates ({card})")
    return None if fails else out


def compute_pids() -> list:
    """Pids nvidia-smi lists as holding a CUDA context on the card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [int(x) for x in smi.stdout.split()]


def card_pci() -> tuple:
    """(the card's PCI address as torch reads it, as nvidia-smi prints it,
    the NUMA node sysfs gives that PCI function; None where sysfs has no
    such file)."""
    props = torch.cuda.get_device_properties(0)
    addr = (f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:"
            f"{props.pci_device_id:02x}.0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=pci.bus_id", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    path = Path(f"/sys/bus/pci/devices/{addr}/numa_node")
    try:
        node = int(path.read_text())
    except (OSError, ValueError):
        node = None
    return addr, smi.stdout.strip(), node


def frontend_phase(cfg, p1_want, phase5_syncs, calibration, mm_launches,
                   card):
    """Phase 17: the multi-process front end on full-width tinyllama-1.1b,
    at the depth ``cfg`` gives (``p1_want``, ``phase5_syncs``: phase 5's
    tokens and host syncs at that depth)
    (bf16, seed 0, 4 slots, phase 5's trace and max_len) through
    Runtime.serve(frontend=2, pin=True, stream=True), dense and paged, the
    respawn drills, the launcher with --workers/--pin; the host's layout,
    spawn and respawn times, IPC counts, tok/s in-process, unpinned and
    pinned, serve_ipc's "auto" verdict and overload through the front end
    recorded.  The calling thread's CPU mask is restored on the way out.
    None on any failed gate."""
    import multiprocessing as mp

    saved_mask = os.sched_getaffinity(0)
    try:
        return _frontend_phase(cfg, p1_want, phase5_syncs, calibration,
                               mm_launches, card, mp)
    finally:
        os.sched_setaffinity(0, saved_mask)


def _frontend_phase(cfg, p1_want, phase5_syncs, calibration, mm_launches,
                    card, mp):
    from repro_torch.models import build_model
    from repro_torch.runtime import Runtime, synthetic_trace
    from repro_torch.serving import Request
    from repro_torch.serving.frontend import (FrontendConfig,
                                              ServingFrontend, discover,
                                              plan_affinity)

    t_phase = time.perf_counter()
    out: dict = {"card": card}
    fails = []

    def gate(ok: bool, what: str) -> bool:
        if not ok:
            fails.append(what)
            log("frontend", f"FAIL: {what}")
        return ok

    rt = Runtime(device="cuda")
    model = build_model(cfg, rt.device)
    params = model.init(0)
    max_len = PROMPT + MAX_NEW
    trace = lambda: synthetic_trace(  # noqa: E731
        REQUESTS, prompt_len=PROMPT, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="all", seed=0)
    kw = dict(model=model, params=params, slots=SLOTS, eos_id=-1)
    want = {r: [int(t) for t in v] for r, v in p1_want.items()}
    subs = [dict(rid=r.rid, prompt=[int(t) for t in r.prompt],
                 max_new_tokens=r.max_new_tokens) for r in trace()]

    def toks(rep):
        return {r.rid: [int(t) for t in r.tokens] for r in rep.requests}

    def served(res) -> dict:
        rep = res.report
        t = toks(rep)
        return dict(
            tok_per_s=res.tok_per_s, host_syncs=rep.host_syncs,
            states=rep.state_counts(), tokens_equal_phase5=t == want,
            texts_equal=res.texts == {r: " ".join(map(str, v))
                                      for r, v in t.items()},
            stream_equal=res.stream is not None and all(
                res.stream.tokens(r) == v for r, v in t.items()),
            ipc_messages=rep.ipc_messages, ipc_bytes=rep.ipc_bytes,
            frontend_workers=rep.frontend_workers,
            frontend_respawns=rep.frontend_respawns,
            streamed_tokens=rep.streamed_tokens,
            stream_events=rep.stream_events)

    # --- the host: its layout, the plan, the card's PCI function and node
    topo = discover()
    plan = plan_affinity(topo, FE_WORKERS + 1)
    bus, smi_bus, node = card_pci()
    node_of = {c.cpu: c.node for c in topo.cpus}
    out["host"] = dict(
        topology=topo.describe(), source=topo.source,
        cpu_mask=sorted(os.sched_getaffinity(0)),
        plan_engine_cpus=sorted(plan.engine_cpus),
        plan_worker_cpus=[sorted(m) for m in plan.worker_cpus],
        plan_nodes=sorted({node_of[c] for c in plan.engine_cpus}),
        pci_address=bus, pci_bus_id_smi=smi_bus, card_numa_node=node,
        ipc_round_trip_s=calibration.get("ipc_round_trip_s"),
        ipc_bytes_per_s=calibration.get("ipc_bytes_per_s"))
    log("frontend", f"host {topo.describe()}, mask {len(out['host']['cpu_mask'])}"
        f" cpus; plan: engine {out['host']['plan_engine_cpus']} (node "
        f"{out['host']['plan_nodes']}), workers "
        f"{out['host']['plan_worker_cpus']}; card {bus} on NUMA node {node}; "
        f"calibrated ipc_round_trip_s {out['host']['ipc_round_trip_s']}, "
        f"ipc_bytes_per_s {out['host']['ipc_bytes_per_s']} ({card})")

    # --- in process, streamed, twice: the first run of a phase may pay a
    # one-off synchronizing call (phase 15), so the front end is held to
    # the second run's syncs
    first, first_cuda = count_syncs(lambda: rt.serve(
        cfg, trace(), stream=True, **kw))
    inproc, in_cuda = count_syncs(lambda: rt.serve(cfg, trace(), stream=True,
                                                   **kw))
    out["in_process"] = {**served(inproc), "cuda_syncs": in_cuda,
                         "first_run": dict(tok_per_s=first.tok_per_s,
                                           cuda_syncs=first_cuda)}
    del first

    # --- the front end, pinned, dense; the kernel's launches from 0
    torch.cuda.synchronize()
    mm_launches.reset()
    n0 = len(rt.ledger.entries)
    dense, fe_cuda = count_syncs(lambda: rt.serve(
        cfg, trace(), frontend=FE_WORKERS, pin=True, stream=True, **kw))
    torch.cuda.synchronize()
    launches = mm_launches.count
    ipc = [e for e in rt.ledger.entries[n0:] if e.site == "serve_ipc"]
    out["dense"] = {**served(dense), "cuda_syncs": fe_cuda,
                    "matmul_launches": launches,
                    "mask_after": sorted(os.sched_getaffinity(0)),
                    "serve_ipc": ledger_rows(rt.ledger, ("serve_ipc",))[
                        -len(ipc):] if ipc else []}
    d = out["dense"]
    log("frontend", f"dense, frontend={FE_WORKERS} pinned, streamed: "
        f"{d['tok_per_s']:.2f} tok/s (in process {inproc.tok_per_s:.2f}, "
        f"first run {out['in_process']['first_run']['tok_per_s']:.2f} with "
        f"{first_cuda} synchronizing CUDA calls); "
        f"tokens == phase 5 {d['tokens_equal_phase5']}, texts "
        f"{d['texts_equal']}, stream {d['stream_equal']}; host syncs "
        f"{d['host_syncs']} (phase 5 {phase5_syncs}); synchronizing CUDA "
        f"calls {fe_cuda} (in process, streamed {in_cuda}); IPC "
        f"{d['ipc_messages']} messages, {d['ipc_bytes']} bytes; matmul "
        f"launches {launches}; serve_ipc rows "
        f"{[(e.query.get('op'), e.choice, e.predicted_s, e.measured_s, e.note) for e in ipc]} ({card})")
    gate(d["tokens_equal_phase5"] and d["texts_equal"] and d["stream_equal"]
         and d["frontend_workers"] == FE_WORKERS and launches > 0,
         "dense front end: phase 5's tokens, texts and stream")
    gate(d["host_syncs"] == phase5_syncs and fe_cuda == in_cuda,
         "dense front end: phase 5's host syncs, the in-process run's CUDA "
         "syncs")
    gate({e.query.get("op") for e in ipc if e.measured_s is not None}
         == {"workers", "coalesce"},
         "both serve_ipc ops have predicted and measured rows")
    gate(out["in_process"]["tokens_equal_phase5"],
         "in process, streamed: phase 5's tokens")

    # --- the front end, pinned, paged
    paged, paged_cuda = count_syncs(lambda: rt.serve(
        cfg, trace(), frontend=FE_WORKERS, pin=True, stream=True, paged=True,
        block_size=PAGE, **kw))
    out["paged"] = {**served(paged), "cuda_syncs": paged_cuda}
    p = out["paged"]
    log("frontend", f"paged (pages of {PAGE}), frontend={FE_WORKERS} pinned,"
        f" streamed: {p['tok_per_s']:.2f} tok/s; tokens == phase 5 "
        f"{p['tokens_equal_phase5']}, texts {p['texts_equal']}, stream "
        f"{p['stream_equal']}; host syncs {p['host_syncs']}; synchronizing "
        f"CUDA calls {paged_cuda}; IPC {p['ipc_messages']} messages, "
        f"{p['ipc_bytes']} bytes ({card})")
    gate(p["tokens_equal_phase5"] and p["texts_equal"] and p["stream_equal"]
         and p["host_syncs"] == phase5_syncs,
         "paged front end: phase 5's tokens, texts, stream and host syncs")

    # --- frontend="auto": the verdict, against the intake measured above
    sched = dense.engine.scheduler
    rows = [e for e in ipc if e.query.get("op") == "workers"]
    w, dec = sched.serve_ipc_workers(
        REQUESTS, msg_bytes=rows[0].query["msg_bytes"] if rows else 0,
        prompt_len=PROMPT)
    out["auto"] = dict(
        workers=w, choice=dec.choice, predicted_s=dec.predicted_s,
        alternatives={a.strategy: a.total for a in dec.alternatives},
        measured_intake_s=[e.measured_s for e in rows],
        measured_workers=FE_WORKERS)
    log("frontend", f'frontend="auto" verdict (recorded): {out["auto"]} '
        f"({card})")

    # --- the respawn drill (the reference chaos bench's): intake workers
    # killed and healed, the emission worker killed and its log replayed;
    # no worker may hold a CUDA context
    pids_before = compute_pids()
    fe = ServingFrontend(FrontendConfig(workers=FE_WORKERS, pin=True,
                                        respawn=2), max_len=max_len)
    fe.start()
    try:
        kids = {p.pid for p in fe._intake_procs} | {fe._emit_proc.pid}
        pids_during = compute_pids()
        drill = dict(spawn_s=fe.spawn_s, ping_round_trips_s=list(
            fe.ping_round_trips_s), engine_pinned=fe.engine_pinned,
            workers_pinned=fe.workers_pinned,
            engine_mask=sorted(os.sched_getaffinity(0)))
        ok, bad = fe.submit(subs)
        fe.kill_intake_workers()
        ok2, bad2 = fe.submit(subs)
        intake_respawns = fe.respawns
        stream = fe.stream()
        stream.publish("b0", (11, 12), False, 0.0)
        stream.publish("b1", (21,), False, 0.0)
        fe.kill_emission_worker()
        stream.publish("b0", (13,), True, 0.1)  # respawn + replay here
        stream.publish("b1", (22,), True, 0.1)
        kids |= {p.pid for p in fe._intake_procs} | {fe._emit_proc.pid}
        pids_respawned = compute_pids()
        transcript = fe.finish()
        drill.update(
            validated=[len(ok), len(ok2)], failures=[bad, bad2],
            intake_respawns=intake_respawns, respawns=fe.respawns,
            respawn_s=list(fe.respawn_s), workers_pinned_after=fe.workers_pinned,
            transcript={r: v["tokens"] for r, v in transcript.items()},
            ipc_messages=fe.ipc_messages, ipc_bytes=fe.ipc_bytes,
            compute_pids=dict(before=pids_before, during=pids_during,
                              respawned=pids_respawned, parent=os.getpid(),
                              workers=sorted(kids)))
    finally:
        fe.close()
    out["drill"] = drill
    log("frontend", f"respawn drill: spawn to first pong {drill['spawn_s']:.3f}"
        f" s, respawns {drill['respawns']} in "
        f"{[round(s, 3) for s in drill['respawn_s']]} s, engine pinned "
        f"{drill['engine_pinned']} to {drill['engine_mask']}, workers pinned "
        f"{drill['workers_pinned']}; nvidia-smi compute pids "
        f"{drill['compute_pids']} ({card})")
    gate(drill["validated"] == [REQUESTS, REQUESTS]
         and not any(drill["failures"])
         and intake_respawns == FE_WORKERS
         and drill["respawns"] == FE_WORKERS + 1
         and drill["transcript"] == {"b0": [11, 12, 13], "b1": [21, 22]},
         "respawn drill: intake healed, the emission transcript replayed")
    gate(not kids & set(pids_during + pids_respawned)
         and len(pids_during) == len(pids_respawned) == len(pids_before),
         "while the workers live, only the parent holds a CUDA context")

    # --- respawn=0: a killed emission worker fails what is in flight; the
    # same engine then serves phase 5's trace again, through an unpinned
    # front end (its tok/s: the front end unpinned)
    eng = dense.engine
    coalesce = max((int(e.choice.rsplit("c", 1)[1]) for e in ipc
                    if e.query.get("op") == "coalesce"), default=1)
    fe0 = ServingFrontend(FrontendConfig(workers=FE_WORKERS, respawn=0),
                          max_len=max_len)
    fe0.start()
    try:
        eng.stream = fe0.stream()
        fe0.kill_emission_worker()
        rep0 = eng.run([Request(r.rid, r.prompt, DRILL_NEW)
                        for r in trace()[:DRILL_REQUESTS]],
                       now_fn=lambda: 0.0)
    finally:
        eng.stream = None
        fe0.close()
    fe1 = ServingFrontend(FrontendConfig(workers=FE_WORKERS,
                                         coalesce=coalesce),
                          max_len=max_len)
    fe1.start()
    try:
        ok, bad = fe1.submit(subs)
        eng.stream = fe1.stream()
        rep1 = eng.run(trace())
        eng.stream.close()
        transcript = fe1.finish()
    finally:
        eng.stream = None
        fe1.close()
    out["no_respawn"] = dict(
        states=rep0.state_counts(),
        reasons=sorted({r.reason for r in rep0.requests}),
        again_states=rep1.state_counts(),
        again_tokens_equal_phase5=toks(rep1) == want,
        again_transcript_equal={r: v["tokens"] for r, v in
                                transcript.items()} == toks(rep1),
        unpinned_tok_per_s=rep1.tok_per_s, coalesce=coalesce,
        validated=len(ok), failures=bad)
    n = out["no_respawn"]
    log("frontend", f"respawn=0, emission worker killed: {n['states']} "
        f"{n['reasons']}; the same engine again through an unpinned front "
        f"end: {n['again_states']}, tokens == phase 5 "
        f"{n['again_tokens_equal_phase5']}, transcript "
        f"{n['again_transcript_equal']}, {n['unpinned_tok_per_s']:.2f} tok/s "
        f"({card})")
    gate(n["states"] == {"FAILED": DRILL_REQUESTS}
         and all("frontend stream broken" in (r or "") for r in n["reasons"]),
         "respawn=0: a dead emission worker fails what is in flight")
    gate(n["again_tokens_equal_phase5"] and n["again_transcript_equal"]
         and n["validated"] == REQUESTS and not n["failures"],
         "respawn=0: the same engine then serves phase 5's trace")
    out["tok_per_s"] = dict(in_process=inproc.tok_per_s,
                            unpinned=rep1.tok_per_s, pinned=dense.tok_per_s)
    del eng, paged, dense

    # --- the launcher: --workers 2 --pin --stream
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "tinyllama-1.1b", "--requests", "4", "--max-new", "8", "--slots",
           "4", "--engine", "continuous", "--eos-id", "-1", "--workers",
           str(FE_WORKERS), "--pin", "--stream"]
    t0 = time.perf_counter()
    ls = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                        cwd=ROOT, env=dict(os.environ,
                                           PYTHONPATH=str(ROOT / "src")))
    lines = [ln.strip() for ln in ls.stdout.splitlines()
             if ln.strip().startswith(("states ", "frontend: "))]
    out["launcher"] = dict(cmd=" ".join(cmd[1:]), rc=ls.returncode,
                           wall_s=time.perf_counter() - t0, lines=lines,
                           stdout=ls.stdout[-3000:], stderr=ls.stderr[-2000:])
    log("frontend", f"launcher: exit {ls.returncode} in "
        f"{out['launcher']['wall_s']:.1f} s; {lines}")
    gate(ls.returncode == 0 and "states {'COMPLETED': 4}" in lines
         and any(ln.startswith(f"frontend: {FE_WORKERS} intake")
                 for ln in lines),
         "the launcher with --workers --pin --stream exits 0")

    # --- recorded: phase 16's overload recipe through the front end (the
    # reference stress bench's own), unloaded = the in-process run above
    base_rep = inproc.report
    lat = [r.latency_s for r in base_rep.requests if r.latency_s is not None]
    del inproc
    mean_latency = float(np.mean(lat))
    service_rate = REQUESTS / base_rep.wall_s
    deadline_ms = DEADLINE_X * mean_latency * 1e3
    rate = OVERLOAD_FACTOR * service_rate
    over = rt.serve(cfg, synthetic_trace(
        OVERLOAD_REQUESTS, prompt_len=PROMPT, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="poisson", rate=rate, seed=1),
        queue_limit=2 * SLOTS, deadline_ms=deadline_ms,
        watchdog_ms=max(5000.0, 10 * deadline_ms), frontend=FE_WORKERS,
        stream=True, max_len=max_len, **kw)
    rep_o = over.report
    done = [r for r in rep_o.requests if r.state.value == "COMPLETED"]
    goodput = sum(len(r.tokens) for r in done) / rep_o.wall_s
    ttft = rep_o.ttft_percentiles()
    out["overload"] = dict(
        unloaded_tok_per_s=base_rep.tok_per_s,
        unloaded_mean_latency_s=mean_latency, service_rate_rps=service_rate,
        rate_rps=rate, deadline_ms=deadline_ms, queue_limit=2 * SLOTS,
        states=rep_o.state_counts(), completed_frac=len(done) /
        OVERLOAD_REQUESTS, goodput_tok_per_s=goodput,
        goodput_over_unloaded=goodput / base_rep.tok_per_s,
        ttft_p99_s=ttft["ttft_p99"],
        ttft_p99_over_unloaded_latency=ttft["ttft_p99"] / mean_latency,
        ipc_messages=rep_o.ipc_messages, ipc_bytes=rep_o.ipc_bytes,
        wall_s=rep_o.wall_s, all_terminal=rep_o.all_terminal)
    log("frontend", f"overload through the front end (recorded): "
        f"{out['overload']} ({card})")
    gate(rep_o.all_terminal and done,
         "overload: every request terminal, at least one completed")
    del over, model, params
    torch.cuda.empty_cache()

    alive = mp.active_children()
    gate(not alive, f"every front end closed, its workers joined: {alive}")
    out["wall_s"] = time.perf_counter() - t_phase
    out["fails"] = fails
    log("frontend", f"phase 17 wall {out['wall_s']:.1f} s; "
        f"{len(fails)} failed gates ({card})")
    return None if fails else out


# ---------------------------------------------------------------------------
# Phase 18: the dense and hybrid families
# ---------------------------------------------------------------------------


def family_step(phase, model, params, state, feed, ops, mm):
    """One decode step of a served model: every matmul call's path checked
    against its dtypes (RouteAudit), the kernel's launches by path, then
    the step's wall (host clock around synchronized steps) and its device
    time, launches and busy share (torch.profiler), with the library GEMM
    and attention kernels it ran (none may)."""
    mm.LAUNCHES.reset()
    with RouteAudit(ops, mm) as audit:
        model.decode_step(params, state, feed)
    torch.cuda.synchronize()
    paths = dict(mm.LAUNCHES.by_path)
    launches = mm.LAUNCHES.count
    wall_ms = step_wall(model, params, state, feed)
    by_name, n_kernels = device_ms_by_kernel(
        lambda: model.decode_step(params, state, feed))
    device_ms = sum(by_name.values())
    groups = group_device_ms(by_name, {})
    lib_attn = sorted(k for k in by_name if LIBRARY_ATTENTION.search(k))
    out = dict(wall_ms=wall_ms, device_ms=device_ms,
               busy_share=device_ms / wall_ms if wall_ms else None,
               device_events=n_kernels, matmul_ms=groups["matmul"],
               matmul_ms_by_path={g[7:]: groups[g] for g in MATMUL_KERNELS},
               matmul_launches=launches, matmul_launches_by_path=paths,
               routing=audit.counts, misrouted=audit.wrong,
               library_gemms=library_gemms(phase, by_name),
               library_attention=lib_attn,
               top=sorted(by_name.items(), key=lambda kv: -kv[1])[:5])
    log(phase, f"one decode step ({SLOTS} slots): wall {wall_ms:.3f} ms, "
        f"device {device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f}% busy), "
        f"{n_kernels} device launches; matmul kernel {groups['matmul']:.3f} "
        f"ms in {launches} launches (by path {paths}); routing "
        f"{audit.counts}, misrouted {len(audit.wrong)}; library GEMM "
        f"{out['library_gemms']}, library attention {lib_attn}")
    return out


def family_prefill(arch, model, params, prompts, fa, ops, ref, shapes,
                   label="families"):
    """Model.prefill of phase 5's prompt shape (SLOTS x PROMPT) at full
    width and depth in bf16: the flash forward's calls by path counted
    from 0 just before it, one per full-attention layer on the path
    choose_path names for the model's head dim (recurrentgemma's local
    layers take the windowed forms, never flash); finite logits of shape
    (SLOTS, 1, vocab); the output of the first flash call of each
    signature (FlashCalls) against the plain forward on the same q, k, v,
    at phase 7's tolerance (flash_error).  An mrope model gets the
    text-only (t, h, w) positions; an encoder-decoder model frames of the
    prompts' length (N(0, 1) x 0.1, seed 0), and makes three flash calls a
    layer pair: the encoder's non-causal self-attention, the decoder's
    causal self-attention and its non-causal cross attention.  Its matmul
    calls go to ``shapes``.  Returns (record, failures)."""
    from repro_torch.models.model import mrope_positions

    cfg = model.cfg
    hd = cfg.resolved_head_dim
    n_attn = sum(cfg.block_kind(i) == "attn" for i in range(cfg.n_layers))
    if cfg.is_encdec:
        n_attn = cfg.encoder_layers + 2 * cfg.n_layers
    path = flash_path(torch.bfloat16, hd)
    batch = {"tokens": prompts}
    if cfg.pos_type == "mrope":
        batch["positions"] = mrope_positions(*prompts.shape, 0, "cuda")
    if cfg.is_encdec:
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch["frames"] = torch.randn(prompts.shape + (cfg.d_model,),
                                      generator=gen, device="cuda") * 0.1
    torch.cuda.synchronize()
    fa.LAUNCHES.reset()
    with torch.inference_mode(), shapes, FlashCalls(ops) as flash:
        logits = model.prefill(params, batch)
    torch.cuda.synchronize()
    calls, by_path = fa.LAUNCHES.forward, dict(fa.LAUNCHES.by_path)
    copied = fa.LAUNCHES.copied_operands
    fails, checks = [], []
    with torch.inference_mode():
        for q, k, v, causal, o in flash.calls.values():
            want, _ = ref.flash_attention_fwd_plain(q, k, v, causal)
            err, ratio = flash_error(o, want)
            sig = (f"q {tuple(q.shape)} k {tuple(k.shape)} "
                   f"{str(q.dtype)[6:]}{'' if causal else ' non-causal'}")
            checks.append(dict(call=sig, max_abs_err=err, of_limit=ratio))
            if not ratio <= 1.0:
                fails.append(f"{arch}: flash forward {sig} in Model.prefill: "
                             f"max abs err {err:.3e}, {ratio:.2f} x its "
                             f"limit")
    if n_attn and not checks:
        fails.append(f"{arch}: no flash call in Model.prefill to check")
    flash_err = max((c["max_abs_err"] for c in checks), default=0.0)
    if calls != n_attn or by_path[path] != n_attn:
        fails.append(f"{arch}: Model.prefill made {calls} flash forward "
                     f"calls ({by_path}), expected {n_attn} on the {path} "
                     f"path (one per full-attention layer, hd {hd})")
    if hd in (96, 256) and copied:
        fails.append(f"{arch}: Model.prefill's flash calls at hd {hd} "
                     f"copied {copied} operands; every one should be on a "
                     f"tensor map")
    want = (prompts.shape[0], 1, cfg.vocab_size)
    finite = bool(torch.isfinite(logits).all())
    if tuple(logits.shape) != want or not finite:
        fails.append(f"{arch}: Model.prefill logits {tuple(logits.shape)}, "
                     f"finite {finite}; expected {want}")
    log(label, f"{arch} Model.prefill {tuple(prompts.shape)} "
        f"{cfg.n_layers} layers{' (+ the encoder)' if cfg.is_encdec else ''}"
        f" bf16: flash forward calls {calls} by path {by_path}, operands "
        f"copied {copied} (hd {hd}, {n_attn} full-attention layers), logits "
        f"{tuple(logits.shape)} finite {finite}; flash outputs against the "
        f"plain forward: {checks}")
    return dict(shape=list(prompts.shape), head_dim=hd, flash_path=path,
                flash_forward_calls=calls, flash_by_path=by_path,
                flash_copied_operands=copied,
                attn_layers=n_attn, flash_checks=checks,
                flash_max_abs_err=flash_err), fails


def family_matmuls(arch, calls, ops, ref, mm, label="families"):
    """Hold one call of every matmul signature a family's serves and
    prefill ran (phase 18's shapes: the projections at its width, the
    FFN, the unembedding at its vocab, decode_attention's and the
    windowed forms' contractions at its head dim; phase 19's router and
    expert products) against the plain version, at phase 2's tolerance
    (BF16_TOL or F32_TOL x max|plain| by the output's dtype), each call's
    path checked against its dtypes (RouteAudit), and which of a
    tensor-core call's operands a tensor map loads (TMA) and which the
    producer's threads copy.  Returns (record, failures)."""
    fails, worst, worst_call, copied = [], 0.0, None, []
    with torch.inference_mode(), RouteAudit(ops, mm) as audit:
        for a, b, kw in calls:
            err, tol = kernel_error(ops, ref, a, b, kw)
            call = (f"{tuple(a.shape)} {str(a.dtype)[6:]} @ {tuple(b.shape)} "
                    f"{str(b.dtype)[6:]} {kw.get('activation')} -> "
                    f"{str(kw.get('out_dtype') or a.dtype)[6:]}")
            if mm.choose_path(a.dtype, b.dtype) == "tensor_core":
                tma = {o: mm.operand_mode(t, o)[1]
                       for o, t in (("a", a), ("b", b))}
                if not all(tma.values()):
                    copied.append(f"{call}: on TMA {tma}")
            if not err <= tol:
                fails.append(f"{arch} matmul {call}: max abs err {err:.3e} > "
                             f"{tol:.3e}")
            if err >= worst:
                worst, worst_call = err, f"{call}: {err:.3e} (tol {tol:.3e})"
    torch.cuda.synchronize()
    if audit.wrong:
        fails.append(f"{arch}: misrouted matmul calls {audit.wrong}")
    for f in fails:
        log(label, f"FAIL {f}")
    log(label, f"{arch}: {len(calls)} matmul signatures of its serves "
        f"and prefill against the plain version, routing {audit.counts}, "
        f"misrouted {len(audit.wrong)}; largest error {worst_call}; "
        f"tensor-core calls with an operand off TMA: {copied or 'none'}")
    return dict(signatures=len(calls), max_abs_err=worst,
                worst_call=worst_call, routing=audit.counts,
                off_tma=copied), fails


def family_serve(arch, mm, fa, ops, ref, card, n_layers=None,
                 label="families"):
    """Runtime.serve of one family at full width and depth (``n_layers``
    cuts the depth) in bf16 (random weights, seed 0), phase 5's trace cut
    to SHORT_NEW new tokens a request on 4 slots, static and continuous (and, for recurrentgemma, continuous with
    paged=True, pages of 16), the matmul kernel's launches counted from 0
    just before each run; then Model.prefill at that depth
    (family_prefill), one call of every matmul signature those ran against
    the plain version (family_matmuls), and one decode step (family_step;
    for a mixture of experts also its MoE layers alone, moe_layers_ms).
    Returns (record, failures)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.model import mrope_positions
    from repro_torch.runtime import Runtime, synthetic_trace
    from repro_torch.tree import leaves, leaves_with_paths

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    fails = []
    rt = Runtime(device="cuda")
    model = build_model(cfg, rt.device)
    params = model.init(0)
    n_params = sum(t.numel() for t in leaves(params))
    trace = lambda: synthetic_trace(  # noqa: E731
        REQUESTS, prompt_len=PROMPT, max_new=SHORT_NEW,
        vocab_size=cfg.vocab_size, arrival="all", seed=0)
    runs, launches = {}, {}
    modes = [("static", {}), ("continuous", {})]
    if any(k != "attn" for k in cfg.block_pattern):
        modes.append(("paged", dict(paged=True, block_size=PAGE)))
    shapes = MatmulShapes(ops)
    for name, kw in modes:
        torch.cuda.synchronize()
        mm.LAUNCHES.reset()
        with shapes:
            runs[name] = rt.serve(cfg, trace(), model=model, params=params,
                                  mode="static" if name == "static"
                                  else "continuous", slots=SLOTS, eos_id=-1,
                                  **kw)
        torch.cuda.synchronize()
        launches[name] = dict(count=mm.LAUNCHES.count,
                              by_path=dict(mm.LAUNCHES.by_path))
        if mm.LAUNCHES.count <= 0:
            fails.append(f"{arch} {name}: the matmul kernel never launched")
    static = runs["static"]
    same = {name: all(np.array_equal(static.outputs[r], run.outputs[r])
                      for r in static.outputs)
            for name, run in runs.items() if name != "static"}
    ntok = {name: sum(len(v) for v in run.outputs.values())
            for name, run in runs.items()}
    cont = runs["continuous"]
    depth = (f"{cfg.encoder_layers} + {cfg.n_layers} layers"
             if cfg.is_encdec else f"{cfg.n_layers} layers")
    log(label, f"{arch} full width ({depth}, "
        f"{n_params / 1e9:.2f} B parameters) bf16, {REQUESTS} requests x "
        f"{PROMPT}+{SHORT_NEW} tokens, {SLOTS} slots: "
        + ", ".join(f"{n} {r.tok_per_s:.2f} tok/s" for n, r in runs.items())
        + f"; host_syncs_per_token {cont.report.host_syncs_per_token:.4f} "
        f"({cont.report.host_syncs} syncs, {cont.report.device_dispatches} "
        f"dispatches); tokens equal static's: {same}; matmul launches "
        f"{launches} ({card})")
    if not all(same.values()):
        fails.append(f"{arch}: tokens differ from static's: {same}")
    if any(n != REQUESTS * SHORT_NEW for n in ntok.values()):
        fails.append(f"{arch}: generated tokens {ntok}")
    prompts = torch.as_tensor(np.stack([r.prompt for r in trace()[:SLOTS]]),
                              dtype=torch.int64, device="cuda")
    prefill, f = family_prefill(arch, model, params, prompts, fa, ops, ref,
                                shapes, label)
    fails += f
    checks, f = family_matmuls(arch, list(shapes.calls.values()), ops, ref,
                               mm, label)
    fails += f
    shapes.calls.clear()
    state = model.init_decode_state(SLOTS, PROMPT + MAX_NEW, per_slot=True)
    feed = {"tokens": torch.ones((SLOTS, 1), dtype=torch.int64,
                                 device="cuda")}
    if cfg.pos_type == "mrope":
        feed["positions"] = mrope_positions(SLOTS, 1, state["pos"])
    step = family_step(label, model, params, state, feed, ops, mm)
    if step["misrouted"] or not step["routing"]:
        fails.append(f"{arch}: misrouted matmul calls {step['misrouted']}")
    if step["library_gemms"] or step["library_attention"]:
        fails.append(f"{arch}: library kernels in a decode step: "
                     f"{step['library_gemms'] + step['library_attention']}")
    # every weight but the embedding table (a decode step gathers SLOTS
    # rows of it), an encoder's and the cross attention's K and V
    # projections (decode reads the cross caches in their place) is read
    # once a step: the step's bound by bytes, weights only (the caches'
    # reads are left out, as for every family)
    weight_bytes = sum(t.numel() * t.element_size() for path, t in
                       leaves_with_paths(params)
                       if (path != "embed" or cfg.tie_embeddings)
                       and not path.startswith(("encoder/", "enc_"))
                       and not path.endswith(("cross/wk", "cross/wv")))
    step["weight_bound_ms"] = weight_bytes / HBM_BW * 1e3
    if cfg.is_moe:
        step["moe"] = moe_layers_ms(label, model, params, card)
    rec = dict(n_layers=cfg.n_layers, parameters=n_params,
               tok_per_s={n: r.tok_per_s for n, r in runs.items()},
               wall_s={n: r.wall_s for n, r in runs.items()},
               host_syncs=cont.report.host_syncs,
               device_dispatches=cont.report.device_dispatches,
               host_syncs_per_token=cont.report.host_syncs_per_token,
               generated_tokens=ntok, tokens_equal_static=same,
               matmul_launches=launches, prefill=prefill,
               matmul_checks=checks, decode_step=step)
    del runs, static, cont, model, params, state, shapes
    return rec, fails


def route_check(card_routes, cpu_routes, k) -> tuple:
    """The experts the router selected on the card against the CPU's, call
    by call (each MoE layer of each forward, in order).  A token whose
    expert set differs is a flip; a flip is explained only where the
    swapped experts' CPU probabilities differ by no more than twice that
    token's largest card-vs-CPU probability difference (fp32 rounding of
    the same inputs).  Reports the smallest gap met between the k-th and
    the (k+1)-th CPU probability.  Returns (record, failures)."""
    fails, flips, rows = [], [], 0
    gap_min, perr_max = float("inf"), 0.0
    if len(card_routes) != len(cpu_routes):
        fails.append(f"router calls: card {len(card_routes)}, CPU "
                     f"{len(cpu_routes)}")
    for call, ((lg, ig), (lc, ic)) in enumerate(zip(card_routes,
                                                    cpu_routes)):
        pg = torch.softmax(lg.double(), -1)
        pc = torch.softmax(lc.double(), -1)
        perr = (pg - pc).abs().amax(-1)
        srt = pc.sort(-1, descending=True).values
        gap_min = min(gap_min, (srt[:, k - 1] - srt[:, k]).min().item())
        perr_max = max(perr_max, perr.max().item())
        rows += ig.shape[0]
        for row in range(ig.shape[0]):
            a, b = set(ig[row].tolist()), set(ic[row].tolist())
            if a == b:
                continue
            swapped = sorted(a ^ b)
            spread = (pc[row, swapped].max() - pc[row, swapped].min()).item()
            flips.append(dict(call=call, row=row, swapped=swapped,
                              spread=spread, prob_err=perr[row].item()))
            if spread > 2 * perr[row].item():
                fails.append(f"router call {call} token {row}: experts "
                             f"{swapped} swapped, probabilities {spread:.3e} "
                             f"apart, more than twice the card-vs-CPU "
                             f"difference {perr[row].item():.3e}")
    return dict(calls=len(cpu_routes), tokens=rows, flips=flips,
                smallest_gap=gap_min, max_prob_err=perr_max), fails


def family_card_vs_cpu(arch, fa, card, stream=False, n_layers=None):
    """One family at full width cut to 2 layers (recurrentgemma to 3, one
    period; ``n_layers`` sets it), fp32, on the card and on the CPU from
    the same parameters: Model.prefill of a 2 x 16 prompt (no decode
    state: flash at the model's head dim, the windowed forms and the
    RG-LRU scan), then one batched prefill of it through decode_step and 4
    greedy steps; each logits within 2e-3 x max|logit| (phase 6's limit),
    and the card's Model.prefill within it of its own decode at the last
    prompt token.  An mrope model gets the text-only (t, h, w) positions on
    every call, and a vision model one more forward_logits with vision
    embeddings over the first 2 positions and distinct (t, h, w) planes;
    a mixture of experts' selected experts are compared, card against CPU
    (route_check).  ``stream``: recurrentgemma with its window cut to
    RING_WINDOW, a prompt of RING_STREAM tokens fed one at a time, so that
    the ring buffer wraps on the card; each step's logits card against
    CPU, and the card's last step against its full forward.  Returns
    (record, failures)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, ffn
    from repro_torch.models.model import mrope_positions
    from repro_torch.runtime import synthetic_trace
    from repro_torch.tree import tree_map

    cfg = get_config(arch)
    if n_layers is None:
        n_layers = len(cfg.block_pattern) if len(cfg.block_pattern) > 1 \
            else 2
    cfg = dataclasses.replace(cfg, n_layers=n_layers, dtype="float32")
    if stream:
        cfg = dataclasses.replace(cfg, window_size=RING_WINDOW)
    mrope = cfg.pos_type == "mrope"
    p_gpu = build_model(cfg, "cuda").init(0)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    plen = RING_STREAM if stream else 16
    prompt = torch.as_tensor(synthetic_trace(
        1, prompt_len=plen, max_new=1, vocab_size=cfg.vocab_size,
        arrival="all", seed=3)[0].prompt, dtype=torch.int64)
    prompts = torch.stack([prompt, prompt.flip(0)])
    if cfg.frontend == "vision":  # 2 patch embeddings, distinct planes
        rng = np.random.default_rng(3)
        vision = {"tokens": prompts, "vision_embeds": torch.from_numpy(
            (rng.standard_normal((2, 2, cfg.d_model)) * 0.02).astype(
                np.float32)), "positions": torch.from_numpy(np.stack(
                    [np.arange(plen)[None].repeat(2, 0),
                     rng.integers(0, 6, (2, plen)),
                     rng.integers(0, 9, (2, plen))], -1))}

    def batch(toks, offset):
        out = {"tokens": toks}
        if mrope:
            out["positions"] = mrope_positions(*toks.shape, offset,
                                               toks.device)
        return out

    logits, flash_calls = {}, 0
    routes = {"cuda": [], "cpu": []}
    topk = ffn._router_topk

    def recording(lg, k):
        w, ids = topk(lg, k)
        routes[where].append((lg.float().cpu(), ids.cpu()))
        return w, ids

    ffn._router_topk = recording
    try:
        for where, p_dev in (("cuda", p_gpu), ("cpu", p_cpu)):
            model = build_model(cfg, where)
            toks = prompts.to(where)
            if where == "cuda":
                torch.cuda.synchronize()
                fa.LAUNCHES.reset()
            if stream:
                pre = model.forward_logits(p_dev, {"tokens": toks})[0][:, -1]
            else:
                pre = model.prefill(p_dev, batch(toks, 0))[:, -1]
            if where == "cuda":
                torch.cuda.synchronize()
                flash_calls = fa.LAUNCHES.forward
            st = model.init_decode_state(2, plen + 8, per_slot=True)
            steps = []
            if stream:  # token by token: the ring buffer wraps
                for i in range(plen):
                    out, st = model.decode_step(
                        p_dev, st, {"tokens": toks[:, i:i + 1]})
                    if i % 8 == 7 or i == plen - 1:
                        steps.append(out[:, -1])
            else:
                out, st = model.decode_step(p_dev, st, batch(toks, st["pos"]))
                steps.append(out[:, -1])
                for _ in range(4):
                    tok = steps[-1].argmax(-1)[:, None]
                    out, st = model.decode_step(p_dev, st,
                                                batch(tok, st["pos"]))
                    steps.append(out[:, -1])
            if cfg.frontend == "vision":
                steps.append(model.forward_logits(p_dev, {
                    k: v.to(where) for k, v in vision.items()})[0])
            logits[where] = [t.float().cpu() for t in [pre] + steps]
            del model, st
    finally:
        ffn._router_topk = topk
    fails, worst = [], 0.0
    last_prompt = -1 if stream else 1  # the decode step at the prompt's end
    pairs = list(zip(logits["cuda"], logits["cpu"])) + [
        (logits["cuda"][0], logits["cuda"][last_prompt])]
    for i, (lg, lc) in enumerate(pairs):
        top = lc.abs().max().item()
        err = (lg - lc).abs().max().item()
        worst = max(worst, err / top)
        if not err <= 2e-3 * top:
            fails.append(f"{arch} card vs CPU comparison {i}: logits err "
                         f"{err:.3e} > {2e-3 * top:.3e}")
    attn_layers = sum(cfg.block_kind(i) == "attn" for i in range(n_layers))
    if flash_calls != attn_layers:
        fails.append(f"{arch}: the card's prefill made {flash_calls} flash "
                     f"forward calls, expected {attn_layers} (one per "
                     f"full-attention layer)")
    experts = None
    if cfg.is_moe:
        experts, f = route_check(routes["cuda"], routes["cpu"],
                                 cfg.experts_per_token)
        fails += [f"{arch}: {x}" for x in f]
    what = (f"window {RING_WINDOW}, {plen} tokens streamed one at a time "
            f"(the ring buffer wraps), every 8th step and the last, and the "
            f"forward's last position" if stream else
            "Model.prefill 2x16 and batched prefill + 4 decode steps"
            + (", forward_logits with vision embeddings and distinct "
               "(t, h, w) positions" if cfg.frontend == "vision" else ""))
    for f in fails:
        log("families-card-vs-cpu", f"FAIL {f}")
    log("families-card-vs-cpu", f"{arch} full width, {n_layers} layers, "
        f"fp32: {what}, card against CPU and the card's prefill against its "
        f"decode: max err {worst:.2e} x max|logit| (limit 2e-3); flash "
        f"forward calls in the card's prefill {flash_calls}"
        + ("" if experts is None else
           f"; selected experts: {experts['calls']} router calls, "
           f"{experts['tokens']} tokens, {len(experts['flips'])} flips, "
           f"smallest top-k gap {experts['smallest_gap']:.3e}, largest "
           f"probability difference {experts['max_prob_err']:.3e}")
        + f" ({card})")
    del p_gpu, p_cpu
    return dict(rel_err=worst, n_layers=n_layers, flash_forward_calls=
                flash_calls, stream=stream, experts=experts), fails


def moe_layers_ms(label, model, params, card) -> dict:
    """The mixture-of-experts blocks of one decode step alone: moe_dense
    (no auxiliary loss, as decode runs it) of every layer on SLOTS random
    bf16 tokens, profiled (device ms, launches, the matmul kernel's ms by
    path), against the bound of the work: every expert's weights and the
    router read once (bytes at the memory rate; the FLOPs at the bf16 peak
    take far less)."""
    from repro_torch.models import ffn

    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.randn((SLOTS, 1, cfg.d_model), generator=gen, device="cuda")
         * 0.5).to(model.dtype)
    layers = [lp["ffn"] for lp in params["layers"]]

    def run():
        for p in layers:
            ffn.moe_dense(p, x, top_k=cfg.experts_per_token,
                          activation=cfg.activation, aux=False)

    with torch.inference_mode():
        run()
        torch.cuda.synchronize()
        by_name, n_kernels = device_ms_by_kernel(run)
    groups = group_device_ms(by_name, {})
    device_ms = sum(by_name.values())
    nbytes = sum(t.numel() * t.element_size() for p in layers
                 for t in p.values())
    ef = layers[0]["w_in"].shape[1]
    n_mats = len(layers[0]) - 1  # the expert matrices, router left out
    flops = len(layers) * 2.0 * SLOTS * cfg.d_model * (
        ef * n_mats + cfg.n_experts)
    t_bytes, t_ops = nbytes / HBM_BW * 1e3, flops / BF16_PEAK * 1e3
    out = dict(layers=len(layers), device_ms=device_ms, launches=n_kernels,
               matmul_ms=groups["matmul"],
               matmul_ms_by_path={g[7:]: groups[g] for g in MATMUL_KERNELS},
               weight_bytes=nbytes, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               gb_per_s=nbytes / device_ms / 1e6 if device_ms else None)
    log(label, f"{cfg.name}: the {len(layers)} MoE blocks of a decode step "
        f"({SLOTS} tokens, every expert): device {device_ms:.3f} ms in "
        f"{n_kernels} launches (matmul {groups['matmul']:.3f} ms, by path "
        f"{out['matmul_ms_by_path']}), bound {out['bound_ms']:.3f} ms "
        f"({out['bound_by']}: {nbytes / 1e9:.2f} GB of experts and routers "
        f"at {HBM_BW / 1e12:.2f} TB/s), {out['gb_per_s'] or 0:.0f} GB/s "
        f"({card})")
    return out


def family_flash(shape, gen, ref, fa, flush, card):
    """The flash forward at a new head dim against its plain version, on
    the path choose_path names (the launch counted by path), timed (CUDA
    events, cold L2) beside the plain version,
    scaled_dot_product_attention and the forward's bound.  Returns (row,
    failures)."""
    import torch.nn.functional as F

    b, s, hq, hkv, hd, dtype_name = shape
    dt = getattr(torch, dtype_name)
    q, k, v = (torch.randn((b, s, h, hd), generator=gen, device="cuda")
               .to(dt) for h in (hq, hkv, hkv))
    path = flash_path(dt, hd)
    before = fa.LAUNCHES.by_path[path]
    o, lse = fa.flash_attention_fwd_cuda(q, k, v)
    torch.cuda.synchronize()
    ran = fa.LAUNCHES.by_path[path] - before
    o_p, lse_p = ref.flash_attention_fwd_plain(q, k, v)
    fails, errs = [], {}
    for name, got, want in (("o", o, o_p), ("lse", lse, lse_p)):
        err, ratio = flash_error(got, want)
        errs[name] = dict(err=err, of_limit=ratio)
        if not ratio <= 1.0:
            fails.append(f"flash {shape} {name}: max abs err {err:.3e}, "
                         f"{ratio:.2f} x its limit")
    if ran != 1:
        fails.append(f"flash {shape}: {ran} forward calls on the {path} "
                     f"path, expected 1")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    times = dict(
        ms=cuda_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v), flush, 5),
        plain_ms=cuda_ms(lambda: ref.flash_attention_fwd_plain(q, k, v),
                         flush, 5),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush, 5))
    pairs = b * hq * s * (s + 1) / 2
    flops = 4.0 * pairs * hd
    peak = BF16_PEAK if dt == torch.bfloat16 else F32_PEAK
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel()) \
        + 4 * b * hq * s
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BW * 1e3
    row = dict(shape=list(shape[:5]), dtype=dtype_name, path=path,
               max_abs_err=max(e["err"] for e in errs.values()), errors=errs,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               tflops=flops / times["ms"] / 1e9, **times)
    for f in fails:
        log("families-flash", f"FAIL {f}")
    log("families-flash", f"forward {tuple(shape[:5])} {dtype_name} ({path} "
        f"path, 1 launch): o err {errs['o']['err']:.2e} = "
        f"{errs['o']['of_limit']:.2f} x limit, lse {errs['lse']['err']:.2e}; "
        f"kernel {times['ms']:.4f} ms ({row['tflops']:.2f} TFLOP/s), plain "
        f"{times['plain_ms']:.4f} ms, sdpa {times['library_ms']:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); cold L2 "
        f"({card})")
    del q, k, v, o, lse, o_p, lse_p
    return row, fails


def families_phase(mm, fa, ops, ref, gen, flush, card):
    """Phase 18: serve mistral-nemo-12b, phi3-mini-3.8b, gemma-2b and
    recurrentgemma-2b at full width and the depths FAMILY_SERVE_LAYERS
    gives (family_serve), each family
    card against CPU in fp32 (family_card_vs_cpu, the ring buffer wrapping
    too), and the flash forward at hd 96 and 256 (family_flash).  None on
    any failure."""
    t_phase = time.perf_counter()
    out: dict = {"card": card, "serve": {}, "card_vs_cpu": {}}
    fails = []
    for arch in FAMILIES:
        rec, f = family_serve(arch, mm, fa, ops, ref, card,
                              n_layers=FAMILY_SERVE_LAYERS[arch])
        out["serve"][arch], fails = rec, fails + f
        gc.collect()
        torch.cuda.empty_cache()
    for arch in FAMILIES:
        rec, f = family_card_vs_cpu(arch, fa, card)
        out["card_vs_cpu"][arch], fails = rec, fails + f
        gc.collect()
        torch.cuda.empty_cache()
    rec, f = family_card_vs_cpu("recurrentgemma-2b", fa, card, stream=True)
    out["card_vs_cpu"]["recurrentgemma-2b ring"], fails = rec, fails + f
    gc.collect()
    torch.cuda.empty_cache()
    out["flash"] = []
    for shape in FAMILY_FLASH_SHAPES:
        row, f = family_flash(shape, gen, ref, fa, flush, card)
        out["flash"].append(row)
        fails += f
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    out["fails"] = fails
    for f in fails:
        log("families", f"FAIL {f}")
    log("families", f"phase 18 wall {out['wall_s']:.1f} s; {len(fails)} "
        f"failures ({card})")
    return None if fails else out


# ---------------------------------------------------------------------------
# Phase 19: the mixture-of-experts family and the VLM backbone
# ---------------------------------------------------------------------------


def moe_vlm_phase(mm, fa, ops, ref, card):
    """Phase 19: serve moonshot-v1-16b-a3b, qwen3-moe-235b-a22b and
    qwen2-vl-72b at full width and the depths MOE_VLM gives
    (family_serve, each model freed before the next is built), then each
    card against CPU in fp32 at MOE_VLM_CPU_LAYERS (family_card_vs_cpu:
    the selected experts compared, qwen2-vl's vision forward too).  None
    on any failure."""
    t_phase = time.perf_counter()
    out: dict = {"card": card, "serve": {}, "card_vs_cpu": {}}
    fails = []
    for arch, depth in MOE_VLM:
        rec, f = family_serve(arch, mm, fa, ops, ref, card, n_layers=depth,
                              label="moe-vlm")
        out["serve"][arch], fails = rec, fails + f
        gc.collect()
        torch.cuda.empty_cache()
    for arch, depth in MOE_VLM_CPU_LAYERS.items():
        rec, f = family_card_vs_cpu(arch, fa, card, n_layers=depth)
        out["card_vs_cpu"][arch], fails = rec, fails + f
        gc.collect()
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    out["fails"] = fails
    for f in fails:
        log("moe-vlm", f"FAIL {f}")
    log("moe-vlm", f"phase 19 wall {out['wall_s']:.1f} s; {len(fails)} "
        f"failures ({card})")
    return None if fails else out


# ---------------------------------------------------------------------------
# Phase 20: the encoder-decoder family
# ---------------------------------------------------------------------------


def encdec_card_vs_cpu(fa, card):
    """seamless-m4t-medium at full width cut to 2 + 2 layers, fp32, on the
    card and on the CPU from one set of parameters: Model.prefill of a
    2 x 16 prompt against 2 x ENCDEC_MAX_LEN frames (encoder, cross
    attention, decoder; its flash calls counted), then a decode state
    whose cross caches hold ``cross_kv`` of ``encode(frames)``, the
    prompt as one chunk and 4 more tokens one at a time (fixed tokens,
    the same on both); each logits within 2e-3 x max|logit| (phase 6's
    limit), and the card's prefill within it of its own decode at the
    prompt's end.  Then one gradient at batch 2 x ENCDEC_CPU_SEQ from the
    data pipeline (frames included): the loss within 1e-4 relative and
    every gradient leaf within 2e-3 x max|grad|.  Returns (record,
    failures)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model, encdec
    from repro_torch.runtime import synthetic_trace
    from repro_torch.training import make_grad_fn
    from repro_torch.tree import leaves_with_paths, tree_map

    cfg = dataclasses.replace(get_config(ENCDEC), n_layers=2,
                              encoder_layers=2, dtype="float32")
    p_gpu = build_model(cfg, "cuda").init(0)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    prompt = torch.as_tensor(synthetic_trace(
        1, prompt_len=16, max_new=1, vocab_size=cfg.vocab_size,
        arrival="all", seed=3)[0].prompt, dtype=torch.int64)
    toks = torch.stack([prompt, prompt.flip(0)])
    feed = torch.stack([toks[:, 3], toks[:, 7], toks[:, 11], toks[:, 0]], 1)
    rng = np.random.default_rng(3)
    frames = torch.from_numpy((rng.standard_normal(
        (2, ENCDEC_MAX_LEN, cfg.d_model)) * 0.1).astype(np.float32))
    batch = SyntheticLMData(cfg, seq_len=ENCDEC_CPU_SEQ, global_batch=2,
                            seed=0).batch_at(0)
    out, flash_calls = {}, 0
    for where, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        model = build_model(cfg, where)
        t0 = time.perf_counter()
        if where == "cuda":
            torch.cuda.synchronize()
            fa.LAUNCHES.reset()
        fr = frames.to(where)
        logits = [model.prefill(p, {"tokens": toks.to(where),
                                    "frames": fr})[:, -1]]
        if where == "cuda":
            torch.cuda.synchronize()
            flash_calls = fa.LAUNCHES.forward
        st = model.init_decode_state(2, ENCDEC_MAX_LEN, per_slot=True)
        enc = model.encode(p, fr, remat=False)
        for lp, layer in zip(p["decoder"], st["layers"]):
            layer["cross"]["k"], layer["cross"]["v"] = encdec.cross_kv(
                lp, cfg, enc)
        lg, st = model.decode_step(p, st, {"tokens": toks.to(where)})
        logits.append(lg[:, -1])
        for i in range(feed.shape[1]):
            lg, st = model.decode_step(
                p, st, {"tokens": feed[:, i:i + 1].to(where)})
            logits.append(lg[:, -1])
        loss, _, grads = make_grad_fn(model)(
            p, {k: v.to(where) for k, v in batch.items()})
        out[where] = dict(logits=[t.float().cpu() for t in logits],
                          loss=float(loss),
                          grads={k: g.cpu() for k, g in
                                 leaves_with_paths(grads)},
                          s=time.perf_counter() - t0)
        del model, st, enc, grads
    fails, worst = [], 0.0
    gpu, cpu = out["cuda"], out["cpu"]
    pairs = list(zip(gpu["logits"], cpu["logits"])) + [
        (gpu["logits"][0], gpu["logits"][1])]
    for i, (lg, lc) in enumerate(pairs):
        top = lc.abs().max().item()
        err = (lg - lc).abs().max().item()
        worst = max(worst, err / top)
        if not err <= 2e-3 * top:
            fails.append(f"{ENCDEC} card vs CPU comparison {i}: logits err "
                         f"{err:.3e} > {2e-3 * top:.3e}")
    rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    if not rel <= 1e-4:
        fails.append(f"{ENCDEC} loss card {gpu['loss']:.6f} cpu "
                     f"{cpu['loss']:.6f}: rel {rel:.2e} > 1e-4")
    worst_grad, worst_leaf = 0.0, None
    for path, gc_ in cpu["grads"].items():
        gg = gpu["grads"].get(path)
        top = gc_.abs().max().item()
        err = float("inf") if gg is None else (gg - gc_).abs().max().item()
        if not err <= 2e-3 * top:
            fails.append(f"{ENCDEC} gradient {path}: err {err:.3e} > "
                         f"{2e-3 * top:.3e}")
        if top > 0 and err / top >= worst_grad:
            worst_grad, worst_leaf = err / top, path
    want_flash = cfg.encoder_layers + 2 * cfg.n_layers
    if flash_calls != want_flash:
        fails.append(f"{ENCDEC}: the card's prefill made {flash_calls} flash "
                     f"forward calls, expected {want_flash}")
    for f in fails:
        log("encdec-card-vs-cpu", f"FAIL {f}")
    log("encdec-card-vs-cpu", f"{ENCDEC} full width, 2 + 2 layers, fp32: "
        f"Model.prefill 2x16 against 2x{ENCDEC_MAX_LEN} frames, a filled "
        f"cross cache + 5 decode steps: max err {worst:.2e} x max|logit| "
        f"(limit 2e-3); loss card {gpu['loss']:.6f} cpu {cpu['loss']:.6f} "
        f"(rel {rel:.2e}, limit 1e-4); {len(cpu['grads'])} gradients, worst "
        f"leaf {worst_leaf} at {worst_grad:.2e} x max|grad| (limit 2e-3); "
        f"flash forward calls in the card's prefill {flash_calls}; card "
        f"{gpu['s']:.2f} s, cpu {cpu['s']:.2f} s ({card})")
    del p_gpu, p_cpu, out
    return dict(rel_err=worst, loss_rel_err=rel, grad_leaves=len(
        cpu["grads"]), worst_grad_rel=worst_grad, worst_leaf=worst_leaf,
        flash_forward_calls=flash_calls), fails


def encdec_phase(mm, fa, ops, ref, flush, card):
    """Phase 20: seamless-m4t-medium at full width and depth in bf16 (12 +
    12 layers, random weights, seed 0): served static and continuous on
    phase 5's trace cut to SHORT_NEW tokens (family_serve: tokens equal, Model.prefill's 36 flash
    calls checked, every matmul signature against the plain version, one
    profiled decode step), paged=True refused with the reference's
    message; every distinct matmul call of one gradient at 1 + 1 layers
    (train_matmuls, the vocabulary of 256,206 among them); Runtime.train
    for 4 steps at 2 x 2048 (no checkpoint: phase 9 writes one through the
    same code) and a fixed batch whose loss falls, one step
    profiled (train_phase); card against CPU in fp32 at 2 + 2 layers
    (encdec_card_vs_cpu).  None on any failure."""
    from repro_torch.configs import get_config
    from repro_torch.runtime import Runtime, synthetic_trace

    t_phase = time.perf_counter()
    cfg = get_config(ENCDEC)
    out: dict = {"card": card}
    fails = []
    rec, f = family_serve(ENCDEC, mm, fa, ops, ref, card, label="encdec")
    out["serve"], fails = rec, fails + f
    gc.collect()
    torch.cuda.empty_cache()
    trace = synthetic_trace(2, prompt_len=8, max_new=2,
                            vocab_size=cfg.vocab_size, arrival="all")
    try:
        Runtime(device="cuda").serve(cfg, trace, paged=True, warmup=False)
        refusal = None
    except ValueError as err:
        refusal = str(err)
    want = ("paged=True supports decoder-only models (enc-dec decode state "
            "has no paged layout)")
    log("encdec", f"paged=True: ValueError {refusal!r}")
    if refusal != want:
        fails.append(f"paged=True gave {refusal!r}, not the reference's "
                     f"ValueError")
    out["paged_refusal"] = refusal
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["train_matmuls"] = train_matmuls(cfg, ops, ref, flush,
                                         label="encdec-backward")
    out["train_matmuls_s"] = time.perf_counter() - t0
    if out["train_matmuls"] is None:
        fails.append("a matmul call of the gradient disagrees with its "
                     "plain version or was misrouted")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["train"] = train_phase(cfg, fa, mm.LAUNCHES, label="encdec-train",
                               ckpt=False)
    out["train_s"] = time.perf_counter() - t0
    if out["train"] is None:
        fails.append("Runtime.train or the fixed-batch run failed")
    else:
        # the encoder's and the cross attention's non-causal calls and the
        # decoder's causal ones, forward and backward, all on the tensor
        # cores (read where the kernels launch)
        calls = out["train"]["profile"]["flash_calls"]
        want = {f"{d} {m} tensor_core": 2 * cfg.n_layers if m == "non-causal"
                else cfg.n_layers for d in ("forward", "backward")
                for m in ("causal", "non-causal")}
        got = {k: calls.get(k, 0) for k in want}
        if any(got[k] < n for k, n in want.items()) or \
                set(calls) - set(want):
            fails.append(f"the profiled training step's flash calls "
                         f"{calls}: each of {want} at least, on no other "
                         f"path or mode")
    gc.collect()
    torch.cuda.empty_cache()
    out["card_vs_cpu"], f = encdec_card_vs_cpu(fa, card)
    fails += f
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    out["fails"] = fails
    for f in fails:
        log("encdec", f"FAIL {f}")
    log("encdec", f"phase 20 wall {out['wall_s']:.1f} s; {len(fails)} "
        f"failures ({card})")
    return None if fails else out


# ---------------------------------------------------------------------------
# Phase 21: the seven configurations train on the card
# ---------------------------------------------------------------------------


def max_abs_diff(a, b, block: int = 1 << 24) -> tuple:
    """(max |a - b|, max |b|) of a card tensor ``a`` and a CPU tensor
    ``b`` of one shape, ``b`` brought to the card a block of rows at a
    time and the difference taken there: the card's gradient never
    crosses to the host (since phase 26: on a card's host the copy and the
    comparison of qwen2-vl's 13.5 GB of fp32 gradients at one layer took
    longer than the two gradients), and the host holds no whole
    difference."""
    b_card = b.to(a.device) if a.dim() == 0 else None
    if b_card is not None:
        return (a - b_card).abs().item(), b_card.abs().item()
    rows = max(1, block * a.shape[0] // max(a.numel(), 1))
    err = top = None
    for r in range(0, a.shape[0], rows):
        y = b[r:r + rows].to(a.device)
        e = (a[r:r + rows] - y).abs_().max()
        t = y.abs().max()
        err = e if err is None else torch.maximum(err, e)
        top = t if top is None else torch.maximum(top, t)
    return err.item(), top.item()


def family_train_parity(arch, card, window=None, seq=FAMILY_TRAIN_CPU_SEQ):
    """Card against CPU in fp32 at full width, cut to 1 layer
    (recurrentgemma one period; FAMILY_TRAIN_CPU_LAYERS),
    batch 2 x ``seq``
    from one seed: on the card, one gradient of the initial parameters
    and its loss (make_grad_fn; since phase 26 no train step follows it,
    for the script's time limit: phases 25 and 26 hold fp32 steps on the
    card, and Runtime.train this phase's bf16 ones); then on the CPU one
    gradient (make_grad_fn without the recomputation, which gives the
    same values), each held against the card's (max_abs_diff).
    Gates: the loss within 1e-4 relative, every parameter's gradient
    present and within 2e-3 x its max|grad|, and for a mixture of experts
    the experts the router selected in the first forward of each, token by
    token (route_check; a flip fails).  Returns (record, failures)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model, ffn
    from repro_torch.training import make_grad_fn
    from repro_torch.tree import leaves_with_paths, tree_map

    cfg = get_config(arch)
    n_layers = FAMILY_TRAIN_CPU_LAYERS.get(arch, 1)
    cfg = dataclasses.replace(cfg, n_layers=n_layers, dtype="float32")
    if window is not None:
        cfg = dataclasses.replace(cfg, window_size=window)
    batch = SyntheticLMData(cfg, seq_len=seq, global_batch=2,
                            seed=0).batch_at(0)
    routes, sink = {"cuda": [], "cpu": []}, None
    topk = ffn._router_topk

    def recording(lg, k):  # the router's choices in the two gradients
        w, ids = topk(lg, k)
        if sink is not None:
            sink.append((lg.float().cpu(), ids.cpu()))
        return w, ids

    ffn._router_topk = recording
    try:
        t0 = time.perf_counter()
        model = build_model(cfg, "cuda")
        params = model.init(0)
        p_cpu = tree_map(lambda t: t.cpu(), params)
        feed = {k: v.cuda() for k, v in batch.items()}
        sink = routes["cuda"]
        card_loss, _, grads = make_grad_fn(model)(params, feed)
        sink = None
        card_loss = float(card_loss)
        card_grads = dict(leaves_with_paths(grads))
        del grads
        card_s = time.perf_counter() - t0
        del params, model, feed
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        sink = routes["cpu"]
        cpu_loss, _, g = make_grad_fn(build_model(cfg, "cpu"), remat=False)(
            p_cpu, batch)
        sink = None
        cpu_loss, cpu_s = float(cpu_loss), time.perf_counter() - t0
    finally:
        ffn._router_topk = topk
    del p_cpu
    # (max |card - cpu|, max |cpu|) by leaf, None where the card has no
    # such gradient
    held = {path: None if path not in card_grads else
            max_abs_diff(card_grads[path], x)
            for path, x in leaves_with_paths(g)}
    del g, card_grads
    fails = []
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    if not rel <= 1e-4:
        fails.append(f"{arch}: loss card {card_loss:.6f}, CPU "
                     f"{cpu_loss:.6f}, rel {rel:.2e} > 1e-4")
    worst, worst_leaf = 0.0, None
    for path, pair in held.items():
        if pair is None:
            fails.append(f"{arch} {path}: no gradient on the card")
            continue
        err, top = pair
        if not err <= 2e-3 * top:
            fails.append(f"{arch} {path}: gradient err {err:.3e} > "
                         f"{2e-3 * top:.3e}")
        if top > 0 and err / top >= worst:
            worst, worst_leaf = err / top, path
    experts = None
    if cfg.is_moe:  # the forward's router calls, one a layer
        experts, f = route_check(routes["cuda"][:n_layers],
                                 routes["cpu"][:n_layers],
                                 cfg.experts_per_token)
        fails += [f"{arch}: {x}" for x in f]
        if experts["flips"]:
            fails.append(f"{arch}: {len(experts['flips'])} selected "
                         f"experts differ, card against CPU")
    form = ""
    if cfg.window_size:
        form = ("; the windowed layers on local_attention"
                if seq > 2 * cfg.window_size else
                "; the windowed layers on the masked dense form")
    for f in fails:
        log("family-train-parity", f"FAIL {f}")
    log("family-train-parity", f"{arch} full width, {n_layers} layers, "
        f"fp32, batch 2 x {seq}{form}"
        + (f", window {cfg.window_size}" if cfg.window_size else "")
        + f": loss card {card_loss:.6f}, cpu {cpu_loss:.6f} (rel "
        f"{rel:.2e}, limit 1e-4); {len(held)} gradients on the card, "
        f"worst leaf {worst_leaf} at {worst:.2e} x max|grad| (limit 2e-3)"
        + ("" if experts is None else
           f"; selected experts: {experts['calls']} router calls, "
           f"{experts['tokens']} tokens, {len(experts['flips'])} flips, "
           f"smallest top-k gap {experts['smallest_gap']:.3e}")
        + f"; card {card_s:.1f} s, cpu {cpu_s:.1f} s ({card})")
    return dict(n_layers=n_layers, seq=seq, window=cfg.window_size,
                loss_cuda=card_loss, loss_cpu=cpu_loss, rel_err=rel,
                leaves=len(held), worst_leaf=worst_leaf, worst_rel=worst,
                experts=experts, card_s=card_s, cpu_s=cpu_s), fails


def depth_rule(arch, depth, n_layers, peak_gb, layer_gb) -> tuple:
    """(reason, failure or None) of a training run's depth under the rule:
    its measured peak within TRAIN_PEAK_LIMIT_GB, and for a cut model one
    more layer past it.  One more layer adds at least its own state
    (``layer_gb``, 12 bytes a parameter), so a peak plus that above the
    limit shows the next depth goes past it."""
    limit, nxt = TRAIN_PEAK_LIMIT_GB, peak_gb + layer_gb
    reason = f"peak {peak_gb:.2f} GB, limit {limit:.1f} GB"
    if depth is None:
        reason = f"whole ({n_layers} layers): {reason}"
    else:
        reason = (f"cut to {depth} of {n_layers} layers: {reason}; one more "
                  f"layer adds at least {layer_gb:.2f} GB of state, "
                  f"{nxt:.2f} GB")
    if peak_gb > limit:
        return reason, f"{arch}: {reason}, over the limit"
    if depth is not None and nxt <= limit:
        deeper = depth + int((limit - peak_gb) // layer_gb)
        return reason, (f"{arch}: {reason}, within the limit: the rule "
                        f"gives at least {deeper} layers")
    return reason, None


def family_train_phase(mm, fa, ops, ref, card):
    """Phase 21: the seven configurations that train on the card from this
    slice on.  For each, in FAMILY_TRAIN's order, built and freed before
    the next: card against CPU in fp32 (family_train_parity;
    recurrentgemma twice, its window cut to FAMILY_RING_WINDOW: at 2 x 4
    FAMILY_RING_WINDOW through local_attention and at 2 x 2 of it through
    the masked dense form); every distinct matmul call of one bf16 gradient at 2 x
    2048 and one period of layers, held against the plain version
    (train_matmuls: recurrentgemma's windowed 4-D products and their
    gradients among them; not timed since phase 23, whose time it gave);
    then Runtime.train at full width in bf16, 4
    steps at 2 x 2048, at FAMILY_TRAIN's depth, every loss finite, every
    flash and matmul call on the path its dtypes and head dim name with
    every tensor-core operand on a tensor map, one step profiled
    (train_phase); for the three models that run whole, a fixed batch
    whose loss falls.  Each depth is held to TRAIN_PEAK_LIMIT_GB on the
    run's own peak and printed with its reason (depth_rule).  None on any
    failure."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    out: dict = {"card": card, "train": {}, "card_vs_cpu": {}, "cuts": {},
                 "train_matmuls": {}}
    fails = []
    for arch, depth in FAMILY_TRAIN:
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg = full if depth is None else dataclasses.replace(
            full, n_layers=depth)
        n_params = cfg.param_count()
        layer_gb = 12 * (n_params - dataclasses.replace(
            cfg, n_layers=0).param_count()) / cfg.n_layers / 1e9
        log("family-train", f"{arch}: {cfg.n_layers} of {full.n_layers} "
            f"layers, {n_params / 1e9:.2f} B parameters, "
            f"{12 * n_params / 1e9:.1f} GB of state at 12 bytes a "
            f"parameter (bf16 weights and gradients, fp32 AdamW moments)")
        cases = {arch: (None, FAMILY_TRAIN_CPU_SEQ)}
        if arch == "recurrentgemma-2b":
            # local_attention takes a sequence longer than 2 windows
            w = FAMILY_RING_WINDOW
            cases = {arch: (w, 4 * w), arch + " dense": (w, 2 * w)}
        for name, (w, seq) in cases.items():
            out["card_vs_cpu"][name], f = family_train_parity(
                arch, card, window=w, seq=seq)
            fails += f
            gc.collect()
        torch.cuda.empty_cache()
        calls = train_matmuls(full, ops, ref, None, label="family-backward",
                              timed=False)
        out["train_matmuls"][arch] = calls
        if calls is None:
            fails.append(f"{arch}: a matmul call of the gradient disagrees "
                         f"with its plain version or was misrouted")
        gc.collect()
        torch.cuda.empty_cache()
        rec = train_phase(cfg, fa, mm.LAUNCHES, label="family-train",
                          ckpt=False, fixed_batch=depth is None,
                          tma_only=True, fixed_lr=FAMILY_TRAIN_FIXED_LR,
                          steps_n=FAMILY_TRAIN_STEPS,
                          fixed_steps=FAMILY_FIXED_STEPS)
        out["train"][arch] = rec
        if rec is None:
            fails.append(f"{arch}: Runtime.train, the profiled step or the "
                         f"fixed batch failed")
        else:
            reason, f = depth_rule(arch, depth, full.n_layers,
                                   rec["peak_memory_gb"], layer_gb)
            fails += [f] if f else []
            log("family-train", f"{arch}: {reason} ({card})")
            out["cuts"][arch] = dict(
                layers=cfg.n_layers, of=full.n_layers, parameters=n_params,
                state_gb=12 * n_params / 1e9, layer_state_gb=layer_gb,
                peak_memory_gb=rec["peak_memory_gb"], reason=reason)
        gc.collect()
        torch.cuda.empty_cache()
        log("family-train", f"{arch}: {time.perf_counter() - t0:.1f} s")
    out["wall_s"] = time.perf_counter() - t_phase
    out["fails"] = fails
    for f in fails:
        log("family-train", f"FAIL {f}")
    log("family-train", f"phase 21 wall {out['wall_s']:.1f} s; {len(fails)} "
        f"failures ({card})")
    return None if fails else out


# phase 22: the sort at the paper's bench size, 10^6 and a 256 MiB array
# (fp32, one row each), WKV at rwkv6-3b's training shape with a gradient
AUTOTUNE_SORT_NS = (100_000, 1_000_000, 1 << 26)
AUTOTUNE_WKV = (2, 2048, 40, 64)  # (B, S, H, N), bf16
AUTOTUNE_TRAIN_STEPS = 3  # a run's first step warms up (and tunes)
AUTOTUNE_LOOKUPS = 10_000  # memo hits timed on the host


def autotune_check_formulas(mm, bs, wkv_k, fa, sort_configs) -> list:
    """Each kernel module's shared-memory formula (what the tuner's filter
    reads on the CPU) against what the CUDA runtime reports for the build:
    the matmul at both tiles on both tensor-core paths, every sort build
    the phase tunes, WKV at every chunk at N 64 in both types, and the
    tensor-core flash kernels.  The mismatches, as text."""
    bad = []
    for tile in mm.TILES:
        for split in (False, True):
            info = mm.kernel_info(tile, split)
            want = mm.tc_smem_bytes(tile, split)
            log("autotune", f"matmul tile {tile}{' split' if split else ''}"
                f": {info['smem_bytes']} bytes of shared memory (formula "
                f"{want}), {info['stages']} stages, {info['registers']} "
                f"registers, {info['local_bytes']} local bytes, "
                f"{info['ctas_per_sm']} CTAs an SM")
            if info["smem_bytes"] != want or info["local_bytes"]:
                bad.append(f"matmul tile {tile} split {split}: {info}, "
                           f"formula {want}")
    for lt, lg in sort_configs:
        info = bs.kernel_info(lt, lg)
        want = bs.smem_bytes(lt, 4)
        log("autotune", f"sort tile 2^{lt} group {lg}: {info['smem_bytes']}"
            f" bytes (formula {want}), {info['threads']} threads, "
            f"{info['registers']} registers, {info['ctas_per_sm']} blocks an "
            f"SM")
        if (info["log_tile"], info["log_group"], info["smem_bytes"]) != \
                (lt, lg, want) or info["ctas_per_sm"] < 1:
            bad.append(f"sort {lt}/{lg}: {info}, formula {want}")
    for dtype in (torch.bfloat16, torch.float32):
        for chunk in wkv_k.CHUNKS:
            info = wkv_k.kernel_info(dtype, chunk, 64)
            want = wkv_k.smem_bytes(dtype, chunk, 64)
            got = {k: v["smem_bytes"] for k, v in info.items()}
            if got != want:
                bad.append(f"wkv {dtype} chunk {chunk}: {got}, formula "
                           f"{want}")
    for hd in fa.TC_HEAD_DIMS:
        got = {k: v["smem_bytes"] for k, v in fa.tc_kernel_info(hd).items()}
        want = fa.tc_smem_bytes(hd)
        if got != want:
            bad.append(f"flash hd {hd}: {got}, formula {want}")
    log("autotune", f"shared-memory formulas against the runtime: "
        f"{len(bad)} mismatches (matmul {len(mm.TILES) * 2} builds, sort "
        f"{len(sort_configs)}, wkv {2 * len(wkv_k.CHUNKS)}, flash "
        f"{len(fa.TC_HEAD_DIMS)})")
    return bad


def autotune_retune(tuning, key, tuner):
    """Resolve the lookup behind a memo's tuple ``key`` again on
    ``tuner``."""
    if key[0] == "matmul":
        return tuning.tune_matmul(*key[1:], tuner=tuner)
    if key[0] == "sort":
        return tuning.tune_sort(*key[1:], tuner=tuner)
    return tuning.tune_wkv(*key[1:], tuner=tuner)


def autotune_row(res) -> dict:
    """One tuned lookup as the record and the kernels line keep it."""
    from repro_torch.core.costs.autotune import fmt_config

    ms = lambda s: None if s is None else s * 1e3  # noqa: E731
    failed = [dict(config=fmt_config(t["config"]), error=t["error"])
              for t in res.trials if t.get("error")]
    return dict(key=res.key, family=res.family, source=res.source,
                prior=fmt_config(res.prior_config),
                tuned=fmt_config(res.config),
                prior_ms=ms(res.prior_measured_s), tuned_ms=ms(res.measured_s),
                predicted_prior_ms=ms(res.prior_predicted_s),
                trials=len(res.trials), failed=failed,
                trial_ms={fmt_config(t["config"]): ms(t["seconds"])
                          for t in res.trials})


def autotune_phase(cfg, p1_want, card):
    """Phase 22: the kernel autotuner on the card.  A Runtime with
    RuntimeConfig(autotune=True) and its own cache directory tunes, by
    measurement, every distinct (path, N, K) of full-width tinyllama-1.1b's
    decode step (one step run under its tuner) and of its bf16 training
    step (Runtime.train, whose first step tunes), each tile timed at 2048
    rows and at the decode step's 4, WKV at rwkv6-3b's training shape in
    bf16 with a gradient, and the sort at
    AUTOTUNE_SORT_NS fp32 (its candidate builds made first, together);
    each candidate's output is held against the prior's before it is
    timed, and none may fail.  Printed for each: prior, tuned config,
    prior and tuned ms, trials.  Then phase 5's trace served static and
    continuous under the tuned runtime (tokens equal, and equal to phase
    5's); the decode step's wall and matmul device ms under the prior-only
    and the tuned tiles, in turns; the host cost of a lookup; Runtime.train's
    steps with the tuned tiles and the prior-only ones, in turns (tuned,
    prior, tuned); phase 2's batch-invariance gate with each tile the
    tuner chose; two site=autotune ledger rows a measured tune; a second
    Runtime on the same cache resolving every lookup again with no
    measurement and the same configs; a repeat tune from an empty cache
    (recorded: which configs move).  The shared-memory formulas the
    candidate spaces are filtered by, against what the runtime reports.
    None on any failure."""
    import shutil

    from repro_torch.core.costs.autotune import (Autotuner, TuneResult,
                                                 fmt_config)
    from repro_torch.core.costs.ledger import OverheadLedger
    from repro_torch.kernels import bitonic_sort as bs
    from repro_torch.kernels import build, ops, tuning
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import wkv as wkv_k
    from repro_torch.models import build_model
    from repro_torch.runtime import Runtime, RuntimeConfig, synthetic_trace

    t_phase = time.perf_counter()
    cache = ROOT / "build" / "autotune_smoke"
    shutil.rmtree(cache, ignore_errors=True)
    out: dict = {"card": card}
    fails = []
    rt = Runtime(RuntimeConfig(autotune=True, cache_dir=cache))
    tuner = rt.tuner
    tuning.FIXED._memo.clear()  # a lookup that misses its tuner lands here

    # the sort's candidate builds for every size, one nvcc each, together
    npads = [1 << max((n - 1).bit_length(), 3) for n in AUTOTUNE_SORT_NS]
    sort_configs = sorted({(c.config["log_tile"], c.config["log_group"])
                           for n in npads
                           for c in tuning.sort_candidates(1, n, 4)[1]})
    t0 = time.perf_counter()
    build.build_jobs([("bitonic_sort", bs.defines(*c))
                      for c in sort_configs])
    out["sort_build_s"] = time.perf_counter() - t0
    log("autotune", f"sort builds {sort_configs} in {out['sort_build_s']:.1f}"
        f" s (together)")
    fails += autotune_check_formulas(mm, bs, wkv_k, fa, sort_configs)

    # decode: one step under the tuner tunes its products
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda")
    params = model.init(0)
    max_len = PROMPT + MAX_NEW
    state = model.init_decode_state(SLOTS, max_len, per_slot=True)
    feed = {"tokens": torch.ones((SLOTS, 1), dtype=torch.int64,
                                 device="cuda")}
    with tuning.using(tuner):
        model.decode_step(params, state, feed)
    torch.cuda.synchronize()
    decode_keys = set(tuner.results())
    out["decode_tune_s"] = time.perf_counter() - t0

    # phase 5's trace, static and continuous, under the tuned runtime
    trace = lambda: synthetic_trace(  # noqa: E731
        REQUESTS, prompt_len=PROMPT, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="all", seed=0)
    static = rt.serve(cfg, trace(), mode="static", model=model,
                      params=params, slots=SLOTS, eos_id=-1)
    cont = rt.serve(cfg, trace(), mode="continuous", model=model,
                    params=params, slots=SLOTS, eos_id=-1)
    same = all(np.array_equal(np.asarray(static.outputs[r]),
                              np.asarray(cont.outputs[r]))
               for r in static.outputs)
    as_p5 = all(np.array_equal(np.asarray(cont.outputs[r]), p1_want[r])
                for r in p1_want)
    out["serve"] = dict(tokens_identical=same, tokens_equal_phase5=as_p5,
                        static_tok_per_s=static.tok_per_s,
                        continuous_tok_per_s=cont.tok_per_s)
    log("autotune", f"phase 5's trace under the tuned runtime: static == "
        f"continuous tokens {same}; equal to phase 5's {as_p5}; static "
        f"{static.tok_per_s:.1f} tok/s, continuous {cont.tok_per_s:.1f} "
        f"tok/s")
    if not same:
        fails.append("static and continuous tokens differ under the tuned "
                     "tiles")
    if not as_p5:
        fails.append("tokens under the tuned tiles differ from phase 5's")

    # the decode step under the prior-only and the tuned tiles, in turns
    prior_t = Autotuner(cache_dir=cache / "prior-only", measure=False,
                        device="cuda")
    steps = {"prior": [], "tuned": []}
    for name in ("prior", "tuned", "tuned", "prior"):
        with tuning.using(prior_t if name == "prior" else tuner):
            wall = step_wall(model, params, state, feed)
            by_name, _ = device_ms_by_kernel(
                lambda: model.decode_step(params, state, feed))
        steps[name].append(dict(wall_ms=wall, matmul_ms=group_device_ms(
            by_name, {})["matmul"], device_ms=sum(by_name.values())))
    out["decode_step"] = steps
    for name, runs in steps.items():
        log("autotune", f"decode step ({SLOTS} slots), {name} tiles: wall "
            + ", ".join(f"{r['wall_ms']:.3f}" for r in runs) + " ms; matmul "
            "device " + ", ".join(f"{r['matmul_ms']:.3f}" for r in runs)
            + " ms")
    key = next(k for k in tuner._memo if isinstance(k, tuple)
               and k[0] == "matmul" and len(k) == 6)
    t0 = time.perf_counter()
    for _ in range(AUTOTUNE_LOOKUPS):
        tuning.matmul_tile(*key[1:], tuner)
    out["lookup_us"] = (time.perf_counter() - t0) / AUTOTUNE_LOOKUPS * 1e6
    log("autotune", f"one matmul tile lookup (memo hit): "
        f"{out['lookup_us']:.3f} us on the host")
    del model, params, state, static, cont
    gc.collect()
    torch.cuda.empty_cache()

    # training: the first tuned run's first step tunes the gradient's
    # products; then prior-only and tuned runs in turns
    prior_rt = Runtime(RuntimeConfig(cache_dir=cache / "prior-only"))
    out["train"] = {"tuned": [], "prior": []}
    for name, runtime in (("tuned", rt), ("prior", prior_rt),
                          ("tuned", rt)):
        lines = []
        res = runtime.train(cfg, steps=AUTOTUNE_TRAIN_STEPS,
                            batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0,
                            log_every=1, log=lines.append)
        steps_ = [dict(step=int(m.group(1)), loss=float(m.group(2)),
                       ms=float(m.group(3))) for m in
                  (re.match(r"step\s+(\d+) loss (\S+) .* (\d+)ms$", x)
                   for x in lines) if m]
        out["train"][name].append(steps_)
        log("autotune", f"Runtime.train {cfg.name} bf16 {TRAIN_BATCH} x "
            f"{TRAIN_SEQ}, {name} tiles: steps " + ", ".join(
                f"{x['ms']:.0f} ms (loss {x['loss']:.4f})" for x in steps_))
        if res.diverged or len(steps_) != AUTOTUNE_TRAIN_STEPS or not all(
                math.isfinite(x["loss"]) for x in steps_):
            fails.append(f"training under the {name} tiles: {steps_}")
        del res
        gc.collect()
        torch.cuda.empty_cache()

    train_keys = set(tuner.results()) - decode_keys
    fell = sorted(tuning.FIXED.results())
    out["train_keys"], out["fixed_lookups"] = len(train_keys), fell
    log("autotune", f"the training step tuned {len(train_keys)} keys of "
        f"its own (its backward's and recomputed products on autograd's "
        f"thread); lookups that fell to the fixed choice under the tuned "
        f"runtime: {fell}")
    if not train_keys or fell:
        fails.append(f"tuned runtime: {len(train_keys)} training keys, "
                     f"lookups outside the tuner {fell}")

    # WKV at rwkv6-3b's training shape, the sort at its three sizes
    b, s_len, h, n = AUTOTUNE_WKV
    if (b, s_len) != (tuning.WKV_TUNE_B, tuning.WKV_TUNE_S):
        fails.append(f"WKV is timed at {tuning.WKV_TUNE_B} x "
                     f"{tuning.WKV_TUNE_S}, not rwkv6-3b's {b} x {s_len}")
    tuning.tune_wkv(h, n, torch.bfloat16, True, tuner=tuner)
    gen = torch.Generator(device="cuda").manual_seed(22)
    for size in AUTOTUNE_SORT_NS:
        x = torch.randn(size, generator=gen, device="cuda")
        if not torch.equal(ops.sort(x, tuner=tuner), torch.sort(x).values):
            fails.append(f"sort n={size} under the tuned build differs "
                         f"from torch.sort")
    torch.cuda.synchronize()

    # every lookup the tuner resolved
    results = tuner.results()
    out["results"] = [autotune_row(r) for r in results.values()]
    for row in out["results"]:
        where = "decode" if row["key"] in decode_keys else ""
        log("autotune", f"{row['key']} {where}: prior {row['prior']} "
            f"{row['prior_ms']} ms, tuned {row['tuned']} {row['tuned_ms']} "
            f"ms ({row['source']}, {row['trials']} trials: "
            f"{row['trial_ms']}); failed {row['failed']}")
        if row["failed"]:
            fails.append(f"{row['key']}: candidates failed {row['failed']}")
    measured = [r for r in results.values() if r.source == "measured"]
    families = {r.family for r in measured}
    if not {"matmul", "sort", "wkv"} <= families:
        fails.append(f"measured families {families}")
    rows = [e for e in rt.ledger.entries if e.site == "autotune"]
    out["ledger_rows"] = len(rows)
    log("autotune", f"{len(measured)} measured tunes, {len(rows)} "
        f"site=autotune ledger rows (two a tune: "
        f"{[e.note for e in rows[:2]]})")
    if len(rows) != 2 * len(measured) or any(
            e.measured_s is None for e in rows):
        fails.append(f"{len(rows)} ledger rows for {len(measured)} tunes")

    # phase 2's batch-invariance gate with each tile the tuner chose
    class Pinned(Autotuner):
        """Every matmul lookup answered with one tile."""

        def __init__(self, tile):
            super().__init__(cache_dir=cache / "pinned", device="cuda")
            self.tile = tile

        def tune(self, spec):
            if spec.family != "matmul" or not any(
                    c.config == {"tile_n": self.tile}
                    for c in spec.candidates):
                return super().tune(spec)
            return TuneResult(spec.key, spec.family, {"tile_n": self.tile},
                              "pinned", None, dict(spec.prior), None, None)

    tiles = sorted({r.config["tile_n"] for r in results.values()
                    if r.family == "matmul"})
    out["invariance"] = {}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for tile in tiles:
        with tuning.using(Pinned(tile)):
            checked = invariance_gate(ops, mm, gen, cfg.d_model, cfg.d_ff)
        out["invariance"][tile] = checked
        log("autotune", f"batch invariance with every tensor-core product "
            f"at tile {tile}: {checked}")
        if checked is None:
            fails.append(f"batch invariance at tile {tile}")

    # a second Runtime on the same cache measures nothing
    rt2 = Runtime(RuntimeConfig(autotune=True, cache_dir=cache))
    keys = [k for k in tuner._memo if isinstance(k, tuple)
            and not (k[0] == "matmul" and len(k) == 5)]
    again = {k: autotune_retune(tuning, k, rt2.tuner) for k in keys}
    differ = [k for k in keys if again[k].config != tuner._memo[k].config]
    out["warm"] = dict(lookups=len(keys), bench_calls=rt2.tuner.bench_calls,
                       differ=[str(k) for k in differ],
                       from_cache=sum(r.source == "cache"
                                      for r in again.values()))
    log("autotune", f"a second Runtime on the same cache: {len(keys)} "
        f"lookups, {out['warm']['from_cache']} from the cache, "
        f"{rt2.tuner.bench_calls} measurements, {len(differ)} configs "
        f"differ")
    if rt2.tuner.bench_calls or differ:
        fails.append(f"warm cache: {out['warm']}")

    # a repeat tune from an empty cache: does it pick the same configs?
    repeat = Autotuner(cache_dir=cache / "repeat", measure=True,
                       device="cuda", ledger=OverheadLedger())
    again = {k: autotune_retune(tuning, k, repeat) for k in keys}
    moved = {str(k): (fmt_config(tuner._memo[k].config),
                      fmt_config(again[k].config))
             for k in keys if again[k].config != tuner._memo[k].config}
    out["repeat"] = dict(lookups=len(keys), moved=moved,
                         bench_calls=repeat.bench_calls)
    log("autotune", f"a repeat tune from an empty cache: {len(moved)} of "
        f"{len(keys)} configs moved {moved}")
    shutil.rmtree(cache, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    out["fails"] = fails
    for f in fails:
        log("autotune", f"FAIL {f}")
    log("autotune", f"phase 22 wall {out['wall_s']:.1f} s; {len(fails)} "
        f"failures ({card})")
    return None if fails else out



# phase 23: the paper's two domains on a mesh of 8 positions on the one
# card, one CUDA stream each
MESH_SHARDS = 8
MESH_SORT_N, MESH_SORT_BIG = 1 << 24, 1 << 26
# skewed and duplicated, n = 3,637,005 (not a multiple of 8): exp(N(0, 1)),
# zeros, 3.3, as the reference's test_sample_sort_nonuniform_input
MESH_SKEWED = (3_000_001, 137_003, 500_001)
MESH_ORDERS = (1024, 4096, 8192)  # bf16
MESH_AWKWARD = (104, 72, 88)  # fp32, no shard count divides it
MESH_CHAIN = [(2048, 1024), (1024, 4096), (4096, 512), (512, 2048)]
MESH_PIPE = (4, 8, 256, 1024)  # stages, microbatches, rows each, width
MESH_PARALLEL = ("shard_m", "shard_n", "shard_k")


def enqueue_ms(fn, reps: int = 3) -> float:
    """Median host ms until ``fn()`` returns, the card idle before each
    call and synchronised after it, outside the reading: the host's share
    of a call whose work it only queues."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return sorted(walls)[len(walls) // 2]


# a host op that computes a product through a library (cuBLAS, cuDNN)
HOST_GEMM_OPS = re.compile(
    r"^aten::(mm|addmm|bmm|baddbmm|matmul|linear|addmv|mv|dot|_scaled_mm)$")


def mesh_profile(run) -> dict:
    """One ``run()`` under torch.profiler: the device's kernels (no library
    GEMM kernel among them, phase 5's check; the matmul kernel's launches
    and device ms) and the host's aten ops (no GEMM op among them).  The
    host ops are the firmer half: after phase 22 the profiler's device
    records of this process missed kernels (a lone 0.1 ms product gave no
    event; three sharded products 23 or 0 of their 24 matmul launches),
    while every op the host ran is recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    device = [(torch._C._demangle(ev.name()), ev.duration_ns() / 1e6)
              for ev in events if ev.device_type() == DeviceType.CUDA]
    host = sorted({ev.name() for ev in events
                   if ev.device_type() == DeviceType.CPU
                   and ev.name().startswith("aten::")})
    matmul = [ms for name, ms in device if any(
        re.search(p, name) for p in MATMUL_KERNELS.values())]
    return dict(events=len(device), launches=len(matmul),
                matmul_ms=sum(matmul),
                library_gemms=library_gemms("mesh", dict(device)),
                host_ops=host,
                host_gemm_ops=[op for op in host if HOST_GEMM_OPS.match(op)])


def host_wall_ms(fn, reps: int = 3) -> tuple:
    """(median wall ms, last result) of ``fn()``, the card synchronised
    before and after each call."""
    walls, res = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)[len(walls) // 2], res


def mesh_phase(card):
    """Phase 23: the paper's two domains across a mesh of MESH_SHARDS
    positions placed on the one card (make_mesh(shards_per_device=8), a
    CUDA stream each).  Sample sort (distributed_sort(force_parallel=True,
    local_sort="kernel")) with all five pivots on N(0, 1) x 1e4 at 2^24
    fp32 and on MESH_SKEWED, and the sampled pivot at 2^26: every output
    bit for bit torch.sort's, the counts summing to n, 2 x 8 bitonic
    kernel calls a sort (each shard's local and bucket sort); counts and
    imbalance, the wall beside the serial distributed_sort(local_sort=
    "kernel") at the same n, and the engine's own decision at chips = 8
    with its measured ledger row.  adaptive_matmul(use_kernel=True) forced
    to shard_m, shard_n and shard_k at MESH_ORDERS in bf16 and at
    MESH_AWKWARD in fp32: shard_m bit for bit the serial kernel product,
    the others within BF16_TOL / F32_TOL x max|C|, 8 kernel calls a
    product; wall (CUDA events, cold L2) and TFLOP/s beside the serial
    path, the engine's decision with a measured row; one call of each
    strategy at 4096 profiled (mesh_profile), no library GEMM kernel or
    host GEMM op.  matmul_chain on
    the mesh in fp32 against the serial chain within F32_TOL x max;
    gpipe of 4 tanh stages (the products on the kernel, bf16) over 8
    microbatches against the stages applied in turn, bit for bit (the
    kernel's rows do not depend on the batch).  The mesh's positions must
    all be on the card and every product and sort must launch its kernel
    (a CPU tensor would take the plain version, which counts nothing).
    None on any failure."""
    from repro_torch.core.costs.engine import CostEngine
    from repro_torch.core.dispatch import adaptive_matmul, matmul_chain
    from repro_torch.core.sort import PIVOT_STRATEGIES, distributed_sort
    from repro_torch.distributed import gpipe, make_mesh
    from repro_torch.kernels import bitonic_sort as bs
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    fails = []
    mesh = make_mesh({"data": MESH_SHARDS}, shards_per_device=MESH_SHARDS)
    if any(d.type != "cuda" for d in mesh.devices) or \
            len(set(mesh.streams)) != MESH_SHARDS:
        log("mesh", f"FAIL: {mesh} is not {MESH_SHARDS} positions on the "
            f"card with a stream each")
        return None
    out: dict = {"card": card, "mesh": repr(mesh), "sort": {},
                 "matmul": {}, "faster_than_serial": []}
    gen = torch.Generator(device="cuda").manual_seed(23)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")

    # --- sample sort
    def sort_cases(label, x, pivots, timed):
        want = torch.sort(x).values
        n = x.numel()
        serial_ms, ser = host_wall_ms(
            lambda: distributed_sort(x, local_sort="kernel")[0])
        if not torch.equal(ser, want):
            fails.append(f"{label}: the serial kernel sort is not "
                         f"torch.sort's")
        rows = {}
        for pivot in pivots:
            bs.LAUNCHES.reset()
            got, rep = distributed_sort(x, mesh, pivot=pivot,
                                        force_parallel=True,
                                        local_sort="kernel")
            torch.cuda.synchronize()
            launches = bs.LAUNCHES.count
            ok = (got.is_cuda and torch.equal(got, want)
                  and int(rep.counts.sum()) == n
                  and rep.strategy == "sample_sort"
                  and launches == 2 * MESH_SHARDS)
            if not ok:
                fails.append(f"{label} {pivot}: output, counts or the "
                             f"kernel's {launches} calls (want "
                             f"{2 * MESH_SHARDS}) wrong")
            ms = host_wall_ms(lambda: distributed_sort(
                x, mesh, pivot=pivot, force_parallel=True,
                local_sort="kernel"))[0] if timed else None
            rows[pivot] = dict(counts=rep.counts.tolist(),
                               imbalance=rep.imbalance, launches=launches,
                               grids=bs.LAUNCHES.grids, ms=ms)
            log("mesh", f"sample sort {label} {pivot}: bit for bit "
                f"{ok}, counts {rep.counts.tolist()}, imbalance "
                f"{rep.imbalance:.3f}, kernel calls {launches}"
                + ("" if ms is None else f", wall {ms:.2f} ms against "
                   f"serial {serial_ms:.2f} ms"))
            del got
        return dict(n=n, serial_ms=serial_ms, pivots=rows)

    x = torch.randn(MESH_SORT_N, generator=gen, device="cuda") * 1e4
    out["sort"]["normal_2^24"] = sort_cases("2^24", x, PIVOT_STRATEGIES,
                                            True)
    eng = CostEngine()  # the engine's own choice, with a measured row
    distributed_sort(x, mesh, engine=eng, measure=True, local_sort="kernel")
    skew = torch.cat([
        torch.exp(torch.randn(MESH_SKEWED[0], generator=gen,
                              device="cuda")),
        torch.zeros(MESH_SKEWED[1], device="cuda"),
        torch.full((MESH_SKEWED[2],), 3.3, device="cuda")])
    out["sort"]["skewed"] = sort_cases(f"skewed n={skew.numel()}", skew,
                                       PIVOT_STRATEGIES, False)
    del x, skew
    big = torch.randn(MESH_SORT_BIG, generator=gen, device="cuda") * 1e4
    out["sort"]["normal_2^26"] = sort_cases("2^26", big, ("sampled",), True)
    distributed_sort(big, mesh, engine=eng, measure=True,
                     local_sort="kernel")
    del big
    torch.cuda.empty_cache()
    out["sort"]["ledger"] = [
        dict(n=e.query["shape"], chips=e.query["chips"], choice=e.choice,
             predicted_s=e.predicted_s, measured_s=e.measured_s)
        for e in eng.ledger.entries if e.measured_s is not None]
    for r in out["sort"]["ledger"]:
        log("mesh", f"sort decision at chips {r['chips']}, n {r['n']}: "
            f"{r['choice']}, predicted {r['predicted_s']:.3e} s, measured "
            f"{r['measured_s']:.3e} s")
    for key in ("normal_2^24", "normal_2^26"):
        case = out["sort"][key]
        for pivot, row in case["pivots"].items():
            if row["ms"] < case["serial_ms"]:
                out["faster_than_serial"].append(f"sort {key} {pivot}")

    # --- the sharded matmul
    def rand(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    cases = [(o, o, o, torch.bfloat16) for o in MESH_ORDERS] + \
        [MESH_AWKWARD + (torch.float32,)]
    mm_eng = CostEngine()
    for m, k, n, dtype in cases:
        a = rand(m, k, dtype=dtype, scale=k ** -0.5)
        b = rand(k, n, dtype=dtype)
        label = f"{m}x{k}@{k}x{n} {str(dtype)[6:]}"
        reps = 3 if m == 8192 else 10
        serial = adaptive_matmul(a, b, use_kernel=True)
        serial_ms = cuda_ms(lambda: adaptive_matmul(a, b, use_kernel=True),
                            flush, reps, 1)
        serial_host = enqueue_ms(lambda: adaptive_matmul(a, b,
                                                         use_kernel=True))
        tol = (BF16_TOL if dtype == torch.bfloat16 else F32_TOL) * \
            serial.float().abs().max().item()
        flops = 2.0 * m * n * k
        row = dict(serial_ms=serial_ms, serial_enqueue_ms=serial_host,
                   serial_tflops=flops / serial_ms / 1e9, strategies={})
        for strategy in MESH_PARALLEL:
            mm.LAUNCHES.reset()
            got = adaptive_matmul(a, b, mesh, force_strategy=strategy,
                                  use_kernel=True)
            torch.cuda.synchronize()
            launches = mm.LAUNCHES.count
            bitwise = torch.equal(got, serial)
            err = (got.float() - serial.float()).abs().max().item()
            ok = (got.is_cuda and got.dtype == dtype and err <= tol
                  and launches == MESH_SHARDS
                  and (bitwise or strategy != "shard_m"))
            if not ok:
                fails.append(f"{label} {strategy}: err {err:.3e} (limit "
                             f"{tol:.3e}), bitwise {bitwise}, {launches} "
                             f"kernel calls (want {MESH_SHARDS})")
            ms = cuda_ms(lambda: adaptive_matmul(
                a, b, mesh, force_strategy=strategy, use_kernel=True),
                flush, reps, 1)
            host = enqueue_ms(lambda: adaptive_matmul(
                a, b, mesh, force_strategy=strategy, use_kernel=True))
            row["strategies"][strategy] = dict(
                ms=ms, tflops=flops / ms / 1e9, err=err, tol=tol,
                bitwise=bitwise, launches=launches, enqueue_ms=host)
            if ms < serial_ms:
                out["faster_than_serial"].append(f"matmul {label} "
                                                 f"{strategy}")
            log("mesh", f"{label} {strategy}: {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s; the host returns after "
                f"{host:.4f} ms) against serial "
                f"{serial_ms:.4f} ms ({flops / serial_ms / 1e9:.1f}); max "
                f"abs err {err:.3e} (limit {tol:.3e}), bit for bit "
                f"{bitwise}, kernel calls {launches}; cold L2")
            del got
        _, rep = adaptive_matmul(a, b, mesh, engine=mm_eng, use_kernel=True,
                                 return_report=True)
        chosen = rep.chosen.strategy
        measured = serial_ms if chosen == "serial" else \
            row["strategies"].get(chosen, {}).get("ms")
        if measured is not None:
            mm_eng.record_measured(rep.decision, measured / 1e3)
        row.update(decision=chosen, predicted_s=rep.decision.predicted_s,
                   measured_s=None if measured is None else measured / 1e3)
        log("mesh", f"{label}: the engine at chips {MESH_SHARDS} picks "
            f"{chosen}, predicted {rep.decision.predicted_s:.3e} s, "
            f"measured {row['measured_s']} s")
        out["matmul"][label] = row
        if m == 4096:  # one call of each strategy profiled
            prof = mesh_profile(lambda: [
                adaptive_matmul(a, b, mesh, force_strategy=s,
                                use_kernel=True) for s in MESH_PARALLEL])
            out["profile_4096"] = prof
            log("mesh", f"profile of shard_m, shard_n, shard_k at 4096: "
                f"{prof['events']} device events, matmul kernel "
                f"{prof['matmul_ms']:.3f} ms in {prof['launches']} of the "
                f"{len(MESH_PARALLEL) * MESH_SHARDS} launches; host ops "
                f"{prof['host_ops']}, GEMM ops among them "
                f"{prof['host_gemm_ops']}")
            if prof["library_gemms"] or prof["host_gemm_ops"] or \
                    not prof["host_ops"]:
                fails.append("a library GEMM in the profile of the sharded "
                             "products, or no host ops recorded")
        del a, b, serial

    # --- the chain and the pipeline
    mats = [rand(*s, dtype=torch.float32, scale=s[0] ** -0.5)
            for s in MESH_CHAIN]
    chain_eng = CostEngine()
    serial = matmul_chain(mats, use_kernel=True)
    mm.LAUNCHES.reset()
    got = matmul_chain(mats, mesh, engine=chain_eng, use_kernel=True)
    torch.cuda.synchronize()
    chain_launches = mm.LAUNCHES.count
    err = (got - serial).abs().max().item()
    tol = F32_TOL * serial.abs().max().item()
    choices = [e.choice for e in chain_eng.ledger.entries
               if e.site == "matmul"]
    chain_ms = cuda_ms(lambda: matmul_chain(mats, mesh, engine=chain_eng,
                                            use_kernel=True), flush, 5, 1)
    serial_chain_ms = cuda_ms(lambda: matmul_chain(mats, use_kernel=True),
                              flush, 5, 1)
    out["chain"] = dict(shapes=MESH_CHAIN, err=err, tol=tol,
                        decisions=choices, launches=chain_launches,
                        ms=chain_ms, serial_ms=serial_chain_ms)
    log("mesh", f"matmul_chain {MESH_CHAIN} fp32 on the mesh: decisions "
        f"{choices}, {chain_launches} kernel calls, max abs err {err:.3e} "
        f"(limit {tol:.3e}) against the serial chain; {chain_ms:.3f} ms "
        f"against {serial_chain_ms:.3f} ms; cold L2")
    if not (err <= tol and chain_launches >= len(MESH_CHAIN) - 1):
        fails.append("matmul_chain on the mesh")
    if chain_ms < serial_chain_ms:
        out["faster_than_serial"].append("matmul_chain")
    del mats, serial, got

    stages, micro, rows, d = MESH_PIPE
    pipe_mesh = make_mesh({"pod": stages}, shards_per_device=stages)
    ws = rand(stages, d, d, dtype=torch.bfloat16, scale=d ** -0.5)
    bias = rand(stages, d, dtype=torch.bfloat16, scale=0.1)
    x = rand(micro, rows, d, dtype=torch.bfloat16)

    def stage(params, h):
        w, b = params
        return torch.tanh(ops.matmul(h, w) + b)

    def sequential():
        h = x.reshape(micro * rows, d)
        for s in range(stages):
            h = stage((ws[s], bias[s]), h)
        return h.reshape(micro, rows, d)

    mm.LAUNCHES.reset()
    got = gpipe(stage, (ws, bias), x, pipe_mesh, "pod")
    torch.cuda.synchronize()
    pipe_launches = mm.LAUNCHES.count
    want = sequential()
    bitwise = torch.equal(got, want)
    pipe_ms = host_wall_ms(lambda: gpipe(stage, (ws, bias), x, pipe_mesh,
                                         "pod"))[0]
    seq_ms = host_wall_ms(sequential)[0]
    out["gpipe"] = dict(shape=MESH_PIPE, bitwise=bitwise,
                        launches=pipe_launches, ms=pipe_ms, serial_ms=seq_ms)
    log("mesh", f"gpipe {stages} stages x {micro} microbatches of "
        f"({rows}, {d}) bf16: bit for bit the stages in turn {bitwise}, "
        f"{pipe_launches} kernel calls (want {stages * micro}); "
        f"{pipe_ms:.2f} ms against {seq_ms:.2f} ms in turn")
    if not (bitwise and pipe_launches == stages * micro and got.is_cuda):
        fails.append("gpipe against the stages in turn")
    if pipe_ms < seq_ms:
        out["faster_than_serial"].append("gpipe")
    del ws, bias, x, got, want, flush
    torch.cuda.empty_cache()

    out["wall_s"] = time.perf_counter() - t_phase
    out["fails"] = fails
    for f in fails:
        log("mesh", f"FAIL {f}")
    log("mesh", f"faster than serial on this card: "
        f"{out['faster_than_serial'] or 'none'}")
    log("mesh", f"phase 23 wall {out['wall_s']:.1f} s; {len(fails)} "
        f"failures ({card})")
    return None if fails else out


# ---------------------------------------------------------------------------
# Phase 24: tensor-parallel serving on eight shards of the card
# ---------------------------------------------------------------------------

SERVE_MESH = {"data": 1, "model": 8}
SERVE_MESH_KW = dict(mesh_shape=SERVE_MESH, shard_params="shard",
                     shards_per_device=8)
# fp32 at cut depth, full width: (arch, layers); recurrentgemma keeps one
# period (rglru, rglru, local), so its windowed attention runs too; the
# other three at 1 layer since phase 26 (2 before), for the script's time
# limit
SERVE_MESH_FP32 = (("tinyllama-1.1b", 1), ("mistral-nemo-12b", 1),
                   ("rwkv6-3b", 1), ("recurrentgemma-2b", 3))
# the fp32 trace: requests, prompt tokens, new tokens, slots (turnover);
# its serves run without the engine's warmup (nothing of them is timed);
# 2 new tokens a request since phase 26 (4 before), for the script's time
# limit
SERVE_MESH_FP32_TRACE = (4, 8, 2, 2)
# bf16 at full width: (arch, layers, a paged run too, a second sharded
# run whose tokens must be the first's); tinyllama at CUT_LAYERS of its 22
# and mistral-nemo at CUT_LAYERS of its 40 (its 8 kv heads still one a
# position) since phase 25, for the script's time limit (whole and at 8,
# their checks took 62.7 and 21.3 s of the phase's 112.3 on an H100); at
# SERVE_MESH_BF16_LAYERS since phase 26 (13.3 and 11.8 s at CUT_LAYERS)
SERVE_MESH_BF16_LAYERS = 1
SERVE_MESH_BF16 = (("tinyllama-1.1b", SERVE_MESH_BF16_LAYERS, True, False),
                   ("mistral-nemo-12b", SERVE_MESH_BF16_LAYERS, False, True))
# the paged run's shared prefix: 2.5 pages of PAGE, so a partial tail page
# is copied on write
SERVE_MESH_PREFIX = 40
LOGIT_TOL = 2e-3  # x max|logit|: phase 6's card-against-CPU limit


def mesh_batch(mesh, toks) -> list:
    """One decode batch a position, the tokens replicated to each."""
    from repro_torch.distributed import replicate

    return [{"tokens": t} for t in replicate(mesh, toks)]


def mesh_state(model, engine, rows: int, max_len: int) -> list:
    """A fresh decode state of ``rows`` slots placed on the engine's mesh
    as its slot pool places one (serve_state_sharding, whole caches where
    the kv heads do not divide the model axis)."""
    from repro_torch.distributed.sharding import (place_tree,
                                                  serve_state_sharding)

    st = model.init_decode_state(rows, max_len, per_slot=True)
    mesh = engine.mesh
    return place_tree(mesh, st, serve_state_sharding(st, mesh,
                                                     seq_split=False),
                      copy=True)


def tp_step_logits(model, params, state, toks, ctx=None):
    """(B, S, V) fp32 logits of one decode step over ``toks`` from
    ``state``, sharded where ``ctx`` is given (position 0's logits)."""
    from repro_torch.distributed import take

    if ctx is None:
        return model.decode_step(params, state, {"tokens": toks})
    logits, new = model.decode_step(params, state,
                                    mesh_batch(ctx.mesh, toks), ctx=ctx)
    return take(ctx.mesh, logits, 0), new


def rel_err(got, want) -> float:
    """max|got - want| / max|want|."""
    want = want.float().cpu()
    return ((got.float().cpu() - want).abs().max()
            / want.abs().max()).item()


def rows_of(report, n: int, new: int) -> np.ndarray:
    return np.stack([report.output(f"r{i}", new) for i in range(n)])


def forced_logits(model, params, prompts, toks) -> torch.Tensor:
    """(N, T, V) fp32 logits of the unsharded model at each of the T steps
    that produced ``toks`` (N, T), teacher-forced in one batch: the
    prompts, then each row's tokens one at a time.  Decode is
    batch-invariant, so each row's logits are the engine's for that
    request."""
    n, t = toks.shape
    st = model.init_decode_state(n, prompts.shape[1] + t, per_slot=True)
    logits, st = model.decode_step(params, st, {"tokens": prompts})
    out = [logits[:, -1].float()]
    feed = torch.as_tensor(toks, dtype=torch.int64, device=prompts.device)
    for j in range(t - 1):
        logits, st = model.decode_step(params, st,
                                       {"tokens": feed[:, j:j + 1]})
        out.append(logits[:, -1].float())
    return torch.stack(out, dim=1)


def near_tie_check(logits, plain, sharded, rel_limit) -> tuple:
    """Sharded bf16 tokens against the unsharded engine's, request by
    request: equal up to the first step where they differ, and there the
    unsharded top-2 margin (``logits``, forced_logits') must be under
    ``rel_limit`` x max|logit| of that step, a near tie.  Returns (equal
    tokens before each first difference, summed; the differing requests
    with their margins and limits; failures)."""
    equal, diffs, fails = 0, [], []
    n, new = plain.shape
    for i in range(n):
        a, b = plain[i], sharded[i]
        j = next((t for t in range(new) if a[t] != b[t]), None)
        equal += new if j is None else j
        if j is None:
            continue
        last = logits[i, j]
        top2 = last.topk(2).values
        margin = (top2[0] - top2[1]).item()
        limit = rel_limit * last.abs().max().item()
        diffs.append(dict(request=i, step=j, margin=margin, limit=limit,
                          unsharded=int(a[j]), sharded=int(b[j])))
        if not margin < limit:
            fails.append(f"request {i} differs at step {j} where the "
                         f"unsharded top-2 margin {margin:.3e} is not under "
                         f"{limit:.3e}")
    return equal, diffs, fails


def serve_mesh_step(model, params, state, toks, ctx) -> dict:
    """One decode step measured: wall (host clock around synchronized
    steps), the host's share (enqueue_ms), and one profiled step: device
    ms and events (torch.profiler), the matmul kernel's launches (in total
    and by CUDA stream), the host's aten ops (no GEMM op among them) and
    the device's kernels (no library GEMM), and, sharded, the mesh's
    collective calls; unsharded where ``ctx`` is None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import matmul as mm

    batch = {"tokens": toks} if ctx is None else mesh_batch(ctx.mesh, toks)

    def step():
        if ctx is None:
            return model.decode_step(params, state, batch)
        return model.decode_step(params, state, batch, ctx=ctx)

    step()
    torch.cuda.synchronize()
    wall_ms = host_wall_ms(step)[0]
    host_ms = enqueue_ms(step, reps=1)
    mm.LAUNCHES.reset()
    col0 = ctx.mesh.collectives if ctx is not None else 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    device = [(torch._C._demangle(ev.name()), ev.duration_ns() / 1e6)
              for ev in events if ev.device_type() == DeviceType.CUDA]
    host = sorted({ev.name() for ev in events
                   if ev.device_type() == DeviceType.CPU
                   and ev.name().startswith("aten::")})
    by_name: dict = {}
    for name, ms in device:
        by_name[name] = by_name.get(name, 0.0) + ms
    return dict(wall_ms=wall_ms, host_ms=host_ms,
                launches=mm.LAUNCHES.count,
                launches_by_stream=dict(mm.LAUNCHES.by_stream),
                collectives=(ctx.mesh.collectives - col0
                             if ctx is not None else 0),
                device_ms=sum(by_name.values()), device_events=len(device),
                library_gemms=library_gemms("serve-mesh", by_name),
                host_ops=len(host),
                host_gemm_ops=[op for op in host if HOST_GEMM_OPS.match(op)])


def serve_mesh_fp32(arch, depth, card, mm) -> tuple:
    """One family at full width, ``depth`` layers, fp32: the continuous
    engine unsharded on the card, sharded on the card (8 positions of GPU
    0) and sharded on an 8-position CPU mesh from the same parameters,
    SERVE_MESH_FP32_TRACE's trace; the tokens of all three equal; the
    logits of the sharded Model.prefill and of a sharded decode step over
    the prompts (card) within LOGIT_TOL x max|logit| of the unsharded
    card's and of the CPU mesh's."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import Runtime, synthetic_trace
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=depth,
                              dtype="float32")
    n, plen, new, slots = SERVE_MESH_FP32_TRACE
    trace = lambda: synthetic_trace(  # noqa: E731
        n, prompt_len=plen, max_new=new, vocab_size=cfg.vocab_size,
        arrival="all", seed=0)
    fails = []
    runs, engines = {}, {}
    for where in ("cuda", "cpu"):
        rt = Runtime(device=where)
        model = build_model(cfg, where)
        if where == "cuda":
            params = model.init(0)
            card_params = params
        else:
            params = tree_map(lambda t: t.cpu(), card_params)
        common = dict(model=model, params=params, slots=slots, eos_id=-1,
                      warmup=False)
        if where == "cuda":
            runs["card"] = rt.serve(cfg, trace(), **common)
            mm.LAUNCHES.reset()
        key = "card_sharded" if where == "cuda" else "cpu_sharded"
        runs[key] = rt.serve(cfg, trace(), **common, **SERVE_MESH_KW)
        if where == "cuda":
            torch.cuda.synchronize()
            launches = mm.LAUNCHES.count
            streams = set(runs[key].engine.mesh.streams)
            by_stream = {s.cuda_stream: mm.LAUNCHES.by_stream.get(
                s.cuda_stream, 0) for s in streams}
        engines[where] = (model, params, runs[key].engine)
    toks = {k: rows_of(r.report, n, new) for k, r in runs.items()}
    equal = all(np.array_equal(toks["card"], t) for t in toks.values())
    if not equal:
        fails.append(f"{arch} fp32: sharded tokens differ (card, card "
                     f"sharded, CPU mesh): {toks}")
    if min(by_stream.values()) <= 0 or len(by_stream) != 8:
        fails.append(f"{arch} fp32: a position launched no matmul kernel "
                     f"{by_stream}")
    prompts = torch.as_tensor(np.stack([r.prompt for r in trace()[:slots]]),
                              dtype=torch.int64)
    errs = {}
    model, params, engine = engines["cuda"]
    cmodel, cparams, cengine = engines["cpu"]
    ctx, cctx = engine._ctx, cengine._ctx
    toks_card = prompts.cuda()
    pre = take_logits(model.prefill(params, {"tokens": toks_card}))
    pre_tp = take_logits(model.prefill(engine.params,
                                       mesh_batch(ctx.mesh, toks_card),
                                       ctx=ctx), ctx)
    pre_cpu = take_logits(cmodel.prefill(cengine.params,
                                         mesh_batch(cctx.mesh, prompts),
                                         ctx=cctx), cctx)
    st = model.init_decode_state(slots, plen + new, per_slot=True)
    dec = tp_step_logits(model, params, st, toks_card)[0]
    dec_tp = tp_step_logits(model, engine.params,
                            mesh_state(model, engine, slots, plen + new),
                            toks_card, ctx)[0]
    dec_cpu = tp_step_logits(cmodel, cengine.params,
                             mesh_state(cmodel, cengine, slots, plen + new),
                             prompts, cctx)[0]
    errs = dict(prefill_vs_card=rel_err(pre_tp, pre),
                prefill_vs_cpu_mesh=rel_err(pre_tp, pre_cpu),
                decode_vs_card=rel_err(dec_tp, dec),
                decode_vs_cpu_mesh=rel_err(dec_tp, dec_cpu))
    if not max(errs.values()) <= LOGIT_TOL:
        fails.append(f"{arch} fp32 logits: {errs} (limit {LOGIT_TOL})")
    rep = runs["card_sharded"].report
    log("serve-mesh", f"{arch} full width, {depth} layers, fp32, {n} "
        f"requests x {plen}+{new} tokens on {slots} slots: tokens of the "
        f"card sharded (8 positions), the card unsharded and the CPU mesh "
        f"equal {equal}; logits (x max|logit|, limit {LOGIT_TOL}) "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f"; matmul launches {launches}, by position "
        f"{sorted(by_stream.values())}; collective calls "
        f"{rep.collective_ops}; {time.perf_counter() - t0:.1f} s ({card})")
    rec = dict(layers=depth, tokens_equal=equal, logit_errs=errs,
               launches=launches, launches_by_position=sorted(
                   by_stream.values()), collective_ops=rep.collective_ops,
               tok_per_s={k: r.tok_per_s for k, r in runs.items()})
    del runs, engines, engine, cengine, params, cparams, card_params
    return rec, fails


def take_logits(logits, ctx=None):
    """Whole logits for the caller: position 0's where sharded."""
    from repro_torch.distributed import take

    return logits if ctx is None else take(ctx.mesh, logits, 0)


def serve_mesh_bf16(arch, depth, paged, repeat, card, fa) -> tuple:
    """One family in bf16 at full width (``depth`` layers; None: whole),
    random weights from seed 0, phase 5's trace cut to SHORT_NEW new
    tokens on SLOTS slots: the continuous engine unsharded, then sharded
    (8 positions of GPU 0, forced shard; with ``repeat`` twice, the same
    tokens both times); with ``paged``, the same on shared-prefix traffic
    (SERVE_MESH_PREFIX tokens), pages of PAGE, prefix_cache="force" (a
    hit).

    bf16 rounds the residual stream at every layer, and another order of
    summation (the sharded row sums) moves the logits by about as much as
    bf16 moves them from the same weights' fp32 computation, 1e-2 x
    max|logit| at full depth: far above LOGIT_TOL.  So the bf16 logits are
    held against that fp32 computation (the weights upcast, the same
    kernels' fp32 paths): the first decode step after a batched prefill,
    sharded, may be no further from it than the unsharded step is, plus
    LOGIT_TOL x max|logit|; for the whole tinyllama the same for the
    sharded Model.prefill (flash, one forward call a layer a position).
    The distance between the sharded and the unsharded logits is printed.
    Tokens equal the unsharded engine's up to a near tie (near_tie_check),
    a top-2 margin under twice the largest logit difference those gates
    admit, 2 x (the unsharded step's distance + LOGIT_TOL) x max|logit|.
    One decode step each way measured (serve_mesh_step): launches on every
    position, no library GEMM.  The serve_shard ledger rows (a predicted
    and a measured one), collective calls, and the auto verdict beside the
    forced one."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import matmul as mm
    from repro_torch.models import build_model
    from repro_torch.runtime import Runtime, synthetic_trace
    from repro_torch.training.step import make_batched_prefill
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    fails = []
    rt = Runtime(device="cuda")
    model = build_model(cfg, rt.device)
    params = model.init(0)

    def trace(shared=False):
        kw = dict(prefix_share=1.0, prefix_len=SERVE_MESH_PREFIX) \
            if shared else {}
        return synthetic_trace(REQUESTS, prompt_len=PROMPT,
                               max_new=SHORT_NEW, vocab_size=cfg.vocab_size,
                               arrival="all", seed=0, **kw)

    common = dict(model=model, params=params, slots=SLOTS, eos_id=-1)
    rec = dict(layers=cfg.n_layers, runs={})
    variants = [("dense", {}, repeat)]
    if paged:
        variants.append(("paged", dict(paged=True, block_size=PAGE,
                                       prefix_cache="force"), False))
    engine, tokens = None, {}
    for name, kw, again_too in variants:
        shared = name == "paged"
        plain = rt.serve(cfg, trace(shared), mode="continuous", **common,
                         **kw)
        torch.cuda.synchronize()
        mm.LAUNCHES.reset()
        first = rt.serve(cfg, trace(shared), mode="continuous", **common,
                         **kw, **SERVE_MESH_KW)
        torch.cuda.synchronize()
        launches = mm.LAUNCHES.count
        a = rows_of(plain.report, REQUESTS, SHORT_NEW)
        b = rows_of(first.report, REQUESTS, SHORT_NEW)
        tokens[name] = (trace(shared), a, b)
        rep = first.report
        run = dict(tok_per_s=dict(unsharded=plain.tok_per_s,
                                  sharded=first.tok_per_s),
                   tokens=REQUESTS * SHORT_NEW, matmul_launches=launches,
                   collective_ops=rep.collective_ops,
                   host_syncs=rep.host_syncs,
                   prefix_hit_tokens=rep.prefix_hit_tokens,
                   cow_count=rep.cow_count)
        if again_too:
            again = rt.serve(cfg, trace(shared), mode="continuous",
                             **common, **kw, **SERVE_MESH_KW)
            run["tok_per_s"]["sharded_again"] = again.tok_per_s
            run["repeatable"] = np.array_equal(
                b, rows_of(again.report, REQUESTS, SHORT_NEW))
            if not run["repeatable"]:
                fails.append(f"{arch} {name}: the sharded tokens differ "
                             f"from one run to the next")
            del again
        if rep.collective_ops <= 0 or rep.device_count != 8 or \
                first.engine.tp != 8:
            fails.append(f"{arch} {name}: not sharded over 8 positions "
                         f"(tp {first.engine.tp}, devices "
                         f"{rep.device_count}, collectives "
                         f"{rep.collective_ops})")
        if shared and rep.prefix_hit_tokens <= 0:
            fails.append(f"{arch} paged: no prefix hit")
        rec["runs"][name] = run
        log("serve-mesh", f"{arch} full width ({cfg.n_layers} layers) bf16 "
            f"{name}, {REQUESTS} requests x {PROMPT}+{SHORT_NEW} tokens, "
            f"{SLOTS} slots: unsharded {plain.tok_per_s:.2f} tok/s, sharded "
            f"on 8 positions "
            + " and ".join(f"{v:.2f}" for k, v in run["tok_per_s"].items()
                           if k != "unsharded")
            + f" tok/s" + (f"; the same tokens run to run "
                           f"{run['repeatable']}" if again_too else "")
            + f"; matmul launches {launches}; collective calls "
            f"{rep.collective_ops}"
            + (f"; prefix hit tokens {rep.prefix_hit_tokens}, copies on "
               f"write {rep.cow_count}" if shared else "") + f" ({card})")
        if name == "dense":
            engine = first.engine
        del plain, first
    ctx = engine._ctx
    ledger = [e for e in rt.ledger.entries if e.site == "serve_shard"]
    measured = [e for e in ledger if e.measured_s is not None]
    if not measured or len(measured) == len(ledger):
        fails.append(f"{arch}: serve_shard rows need a predicted and a "
                     f"measured entry: {len(ledger)} rows, {len(measured)} "
                     f"measured")
    auto_tp, auto = engine.scheduler.serve_shard(
        SLOTS, tp=8, devices=engine.mesh.distinct_devices("model"))
    if auto.choice != "replicate":
        fails.append(f"{arch}: serve_shard's auto verdict on 8 positions of "
                     f"one card is {auto.choice}, not replicate")
    rec["serve_shard"] = dict(
        forced=ledger[0].choice, auto=auto.choice,
        predicted_s=ledger[0].predicted_s,
        measured_s=[e.measured_s for e in measured],
        auto_predicted_s=auto.predicted_s)
    log("serve-mesh", f"{arch} serve_shard: forced {ledger[0].choice} "
        f"(predicted {ledger[0].predicted_s:.3e} s a step), measured "
        + ", ".join(f"{e.measured_s:.3e}" for e in measured)
        + f" s a step; the auto verdict at {SLOTS} slots: {auto.choice} "
        f"(tp {auto_tp}, predicted {auto.predicted_s:.3e} s)")
    # the first decode step after a batched prefill: unsharded, sharded,
    # and the fp32 computation of the same weights
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32, rt.device)
    params32 = tree_map(lambda t: t.float(), params)
    prompts = torch.as_tensor(np.stack([r.prompt for r in trace()[:SLOTS]]),
                              dtype=torch.int64, device="cuda")
    max_len = PROMPT + SHORT_NEW
    chunks = prompts[None]
    lengths = torch.full((SLOTS,), PROMPT, dtype=torch.int64, device="cuda")
    tok, st = make_batched_prefill(model)(
        params, model.init_decode_state(SLOTS, max_len, per_slot=True),
        chunks, lengths)
    tok_tp, st_tp = make_batched_prefill(model, ctx=ctx)(
        engine.params, mesh_state(model, engine, SLOTS, max_len), chunks,
        lengths)
    _, st32 = make_batched_prefill(model32)(
        params32, model32.init_decode_state(SLOTS, max_len, per_slot=True),
        chunks, lengths)
    feed = tok[:, None]
    lg = tp_step_logits(model, params, st, feed)[0]
    lg_tp = tp_step_logits(model, engine.params, st_tp, feed, ctx)[0]
    lg32 = tp_step_logits(model32, params32, st32, feed)[0]
    first = dict(unsharded_vs_fp32=rel_err(lg, lg32),
                 sharded_vs_fp32=rel_err(lg_tp, lg32),
                 sharded_vs_unsharded=rel_err(lg_tp, lg),
                 first_tokens_equal=bool(torch.equal(tok.cpu(),
                                                     tok_tp.cpu())))
    rec["first_step"] = first
    if not first["sharded_vs_fp32"] <= first["unsharded_vs_fp32"] + \
            LOGIT_TOL:
        fails.append(f"{arch}: the sharded first decode step is "
                     f"{first['sharded_vs_fp32']:.3e} x max|logit| from the "
                     f"fp32 one, the unsharded "
                     f"{first['unsharded_vs_fp32']:.3e} (limit: that + "
                     f"{LOGIT_TOL})")
    log("serve-mesh", f"{arch} the first decode step after a batched "
        f"prefill ({SLOTS} x {PROMPT}), x max|logit|: unsharded bf16 "
        f"against fp32 {first['unsharded_vs_fp32']:.3e}, sharded bf16 "
        f"against fp32 {first['sharded_vs_fp32']:.3e} (limit the "
        f"unsharded + {LOGIT_TOL}), sharded against unsharded "
        f"{first['sharded_vs_unsharded']:.3e}; first tokens equal "
        f"{first['first_tokens_equal']}")
    del st32
    rel_limit = 2 * (first["unsharded_vs_fp32"] + LOGIT_TOL)
    for name, (tr, a, b) in tokens.items():
        all_prompts = torch.as_tensor(np.stack([r.prompt for r in tr]),
                                      dtype=torch.int64, device="cuda")
        logits = forced_logits(model, params, all_prompts, a)
        equal, diffs, f = near_tie_check(logits, a, b, rel_limit)
        del logits
        fails += [f"{arch} {name}: {x}" for x in f]
        rec["runs"][name].update(equal_tokens=equal, near_ties=diffs,
                                 near_tie_rel_limit=rel_limit)
        log("serve-mesh", f"{arch} {name}: equal tokens {equal} of "
            f"{REQUESTS * SHORT_NEW}; the first differences, each at a "
            f"near tie (unsharded top-2 margin under {rel_limit:.3e} x "
            f"max|logit|): "
            + ("none" if not diffs else "; ".join(
                f"request {d['request']} step {d['step']} margin "
                f"{d['margin']:.3e} (limit {d['limit']:.3e})"
                for d in diffs)))
    if depth is None:  # the whole model's prefill: flash on every position
        fa.LAUNCHES.reset()
        pre_tp = take_logits(model.prefill(
            engine.params, mesh_batch(ctx.mesh, prompts), ctx=ctx), ctx)
        torch.cuda.synchronize()
        flash_calls = fa.LAUNCHES.forward
        flash_by_path = dict(fa.LAUNCHES.by_path)
        pre = model.prefill(params, {"tokens": prompts})
        pre32 = model32.prefill(params32, {"tokens": prompts})
        errs = dict(unsharded_vs_fp32=rel_err(pre, pre32),
                    sharded_vs_fp32=rel_err(pre_tp, pre32),
                    sharded_vs_unsharded=rel_err(pre_tp, pre))
        rec["prefill"] = dict(flash_forward_calls=flash_calls,
                              flash_by_path=flash_by_path, **errs)
        want_calls = 8 * cfg.n_layers
        if flash_calls != want_calls or not errs["sharded_vs_fp32"] <= \
                errs["unsharded_vs_fp32"] + LOGIT_TOL:
            fails.append(f"{arch}: sharded Model.prefill made {flash_calls} "
                         f"flash forward calls (want {want_calls}); logits "
                         f"x max|logit| {errs}")
        log("serve-mesh", f"{arch} sharded Model.prefill ({SLOTS} x "
            f"{PROMPT}): {flash_calls} flash forward calls ({flash_by_path})"
            f"; x max|logit|: unsharded against fp32 "
            f"{errs['unsharded_vs_fp32']:.3e}, sharded against fp32 "
            f"{errs['sharded_vs_fp32']:.3e}, sharded against unsharded "
            f"{errs['sharded_vs_unsharded']:.3e}")
    del model32, params32
    torch.cuda.empty_cache()
    # one decode step each way, measured and profiled
    steps = dict(unsharded=serve_mesh_step(model, params, st, feed, None),
                 sharded=serve_mesh_step(model, engine.params, st_tp, feed,
                                         ctx))
    sh = steps["sharded"]
    per_pos = [sh["launches_by_stream"].get(s.cuda_stream, 0)
               for s in ctx.mesh.streams]
    sh["launches_by_position"] = per_pos
    if min(per_pos) <= 0 or len(set(per_pos)) != 1 or \
            sh["launches"] != 8 * steps["unsharded"]["launches"]:
        fails.append(f"{arch}: sharded step matmul launches {sh['launches']}"
                     f" by position {per_pos}, want 8 x the unsharded "
                     f"step's {steps['unsharded']['launches']} and every "
                     f"position the same")
    if sh["library_gemms"] or sh["host_gemm_ops"] or not sh["host_ops"]:
        fails.append(f"{arch}: a library GEMM in the sharded decode step "
                     f"({sh['library_gemms']}, {sh['host_gemm_ops']}) or "
                     f"no host ops recorded")
    rec["step"] = steps
    for name, r in steps.items():
        log("serve-mesh", f"{arch} one decode step {name} ({SLOTS} slots): "
            f"wall {r['wall_ms']:.2f} ms, host {r['host_ms']:.2f} ms, "
            f"device {r['device_ms']:.2f} ms ({r['device_events']} device "
            f"events), matmul launches {r['launches']}"
            + (f" ({r['launches_by_position']} by position), collective "
               f"calls {r['collectives']}" if name == "sharded" else "")
            + f"; host aten ops {r['host_ops']}, GEMM among them "
            f"{r['host_gemm_ops']}, library GEMM kernels "
            f"{r['library_gemms']} ({card})")
    rec["wall_s"] = time.perf_counter() - t0
    log("serve-mesh", f"{arch} bf16 checks took {rec['wall_s']:.1f} s")
    del engine, params, model, st, st_tp
    return rec, fails


def serve_mesh_phase(card):
    """Phase 24: tensor-parallel serving on a {"data": 1, "model": 8} mesh
    of 8 positions on the one card (Runtime.serve(mesh_shape=,
    shard_params="shard", shards_per_device=8), a CUDA stream a position):
    SERVE_MESH_FP32 in fp32 at full width and cut depth (serve_mesh_fp32:
    card sharded, card unsharded and CPU mesh tokens equal, logits within
    LOGIT_TOL), then SERVE_MESH_BF16 (serve_mesh_bf16: tinyllama-1.1b
    at SERVE_MESH_BF16_LAYERS, dense and paged with the prefix cache,
    mistral-nemo-12b at SERVE_MESH_BF16_LAYERS of 40 layers, whose 8 kv
    heads split one a position: near ties only,
    repeatable tokens, the first step's logits, flash in the sharded
    prefill, launches on every position, no library GEMM, the serve_shard
    ledger).  None on any failure."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm

    t_phase = time.perf_counter()
    out: dict = {"card": card, "fp32": {}, "bf16": {}}
    fails = []
    for arch, depth in SERVE_MESH_FP32:
        rec, f = serve_mesh_fp32(arch, depth, card, mm)
        out["fp32"][arch], fails = rec, fails + f
        gc.collect()
        torch.cuda.empty_cache()
    for arch, depth, paged, repeat in SERVE_MESH_BF16:
        rec, f = serve_mesh_bf16(arch, depth, paged, repeat, card, fa)
        out["bf16"][arch], fails = rec, fails + f
        gc.collect()
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    out["fails"] = fails
    for f in fails:
        log("serve-mesh", f"FAIL {f}")
    log("serve-mesh", f"phase 24 wall {out['wall_s']:.1f} s; {len(fails)} "
        f"failures ({card})")
    return None if fails else out


# ---------------------------------------------------------------------------
# Phase 25: FSDP training with tensor and expert parallelism on 8 positions
# ---------------------------------------------------------------------------

TRAIN_MESH_DP = {"data": 4, "model": 2}
TRAIN_MESH_EP = {"pod": 2, "data": 2, "model": 2}
# fp32 at TRAIN_MESH_FP32_LAYERS layers, full width, against the unsharded
# card: (arch, mesh, MoE capacity factors; the first is the full check)
TRAIN_MESH_FP32 = (("tinyllama-1.1b", TRAIN_MESH_DP, (8.0,)),
                   ("moonshot-v1-16b-a3b", TRAIN_MESH_EP, (8.0, 1.25)))
TRAIN_MESH_FP32_LAYERS = 2
TRAIN_MESH_FP32_BATCH = (8, 64)
# bf16 at full width: (arch, layers or None for whole, mesh); tinyllama at
# 11 of its 22 layers since phase 27 came (its sharded step is host-bound,
# about 5.5 s whole on the card)
TRAIN_MESH_BF16 = (("tinyllama-1.1b", 11, TRAIN_MESH_DP),
                   ("moonshot-v1-16b-a3b", 4, TRAIN_MESH_EP))
TRAIN_MESH_BATCH = (8, 512)  # the bf16 runs' global batch
TRAIN_MESH_STEPS = 3
# a constant rate from the first step (no warmup), as phase 21's fixed
# batch takes it: the first step moves every parameter
TRAIN_MESH_LR = FAMILY_TRAIN_FIXED_LR
# the fp32 one-step check's AdamW eps, the same both ways: at the default
# 1e-8 a first step moves a weight by lr * g / (|g| + 1e-8), a sign for any
# gradient above 1e-7, so a gradient at the noise of another order of
# sums moves either way (a norm scale read 4.4e-3 and 1.8e-2 x max|p|
# apart on an H100); at 1e-3 the update is a smooth
# function of the gradient, which the gate then holds
TRAIN_MESH_EPS = 1e-3
TRAIN_MESH_TOL = 2e-3  # the reference test's rtol; x max|grad| and x max|p|
EP_TOL = 1e-5  # x max|y|: moe_ep against moe_ep_plain, fp32
# the bf16 first-loss gate's capacity factor for a mixture of experts: at
# 8.0 nothing is dropped, so the sharded loss is the function the dense
# fp32 loss computes (at the context's 1.25 it drops assignments)
TRAIN_MESH_GATE_CF = 8.0
# the bf16 first loss three ways on these batches (seeds; the first the
# fixed batch the steps take): how far bf16 lands from fp32 in another
# order of sums, batch by batch
TRAIN_MESH_LOSS_SEEDS = (2, 20, 21)
TRAIN_MESH_ELASTIC = ({"data": 2, "model": 2}, {"data": 4, "model": 2})
SHARED_VERDICTS = {"serial", "replicate", "replicated_psum"}


def train_mesh_ctx(shape, cf=1.25, engine=None, plan=None):
    """A training context on ``shape``'s positions, all on GPU 0 (a CUDA
    stream each); the planner's chunks where ``plan`` is given, as the
    reference's dry run carries them."""
    from repro_torch.distributed import make_mesh
    from repro_torch.distributed.sharding import ShardingCtx

    mesh = make_mesh(shape, shards_per_device=math.prod(shape.values()))
    kw = {} if plan is None else dict(rnn_chunk=plan.rnn_chunk,
                                      attn_chunk=plan.attn_chunk)
    return ShardingCtx(mesh=mesh, data_axes=tuple(
        a for a in shape if a != "model"), moe_capacity_factor=cf,
        cost_engine=engine, **kw)


def train_mesh_batch(cfg, b, s, seed):
    """Tokens (b, s) from ``seed``; an encoder-decoder's frames (b, s, d)
    too, N(0, 1) x 0.1 as the data pipeline makes them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device="cuda")}
    if cfg.is_encdec:
        batch["frames"] = 0.1 * torch.randn((b, s, cfg.d_model),
                                            generator=gen, device="cuda")
    return batch


def placed_state(ctx, model, state):
    """(``state`` on ``ctx``'s mesh with storage of its own on every
    position, its specs)."""
    from repro_torch.distributed.sharding import param_shardings, place_tree

    specs = param_shardings(state, ctx.mesh, data_axes=ctx.data_axes,
                            cfg=model.cfg)
    return place_tree(ctx.mesh, state, specs, copy=True), specs


def placed_batch(ctx, batch):
    from repro_torch.distributed.sharding import batch_sharding, place_tree

    return place_tree(ctx.mesh, batch, batch_sharding(batch, ctx.mesh,
                                                      ctx.data_axes))


def worst_leaf(want, got, scale_of=None) -> tuple:
    """(worst max|got - want| / max|want| over the leaves, its path), on
    the card, leaf by leaf."""
    from repro_torch.tree import leaves_with_paths

    g = dict(leaves_with_paths(got))
    worst, where = 0.0, None
    for path, w in leaves_with_paths(want):
        if not torch.is_tensor(w) or not w.is_floating_point():
            continue
        top = w.float().abs().max().item()
        err = (g[path].float() - w.float()).abs().max().item()
        rel = err / top if top > 0 else (0.0 if err == 0 else math.inf)
        if rel > worst:
            worst, where = rel, path
    return worst, where


def train_launches(mesh, mm, fa) -> dict:
    """The matmul and flash launches since the counters' reset, by mesh
    position (its CUDA stream)."""
    streams = [s.cuda_stream for s in mesh.streams]
    return dict(
        matmul=mm.LAUNCHES.count,
        matmul_by_position=[mm.LAUNCHES.by_stream.get(s, 0) for s in streams],
        batched_by_position=[mm.LAUNCHES.batched_by_stream.get(s, 0)
                             for s in streams],
        flash_forward=fa.LAUNCHES.forward, flash_backward=fa.LAUNCHES.backward,
        flash_forward_by_position=[fa.LAUNCHES.by_stream.get(("forward", s),
                                                             0)
                                   for s in streams],
        flash_backward_by_position=[fa.LAUNCHES.by_stream.get(
            ("backward", s), 0) for s in streams],
        positions=mesh.size)


def launch_fails(label, rec, moe: bool) -> list:
    """Every position launched the matmul kernel (and, for a mixture of
    experts, its 4-D batched expert products) and both flash directions."""
    need = ["matmul_by_position", "flash_forward_by_position",
            "flash_backward_by_position"] + (["batched_by_position"]
                                             if moe else [])
    return [f"{label}: a position launched no {k[:-12]}: {rec[k]}"
            for k in need if min(rec[k]) <= 0 or len(rec[k]) != 8]


def profile_train_step(step) -> dict:
    """One step under torch.profiler: device ms and kernels where the
    profiler records them, the host's aten ops (no GEMM op), and no library
    GEMM or attention kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    by_name: dict = {}
    for ev in events:
        if ev.device_type() == DeviceType.CUDA:
            name = torch._C._demangle(ev.name())
            by_name[name] = by_name.get(name, 0.0) + ev.duration_ns() / 1e6
    host = sorted({ev.name() for ev in events
                   if ev.device_type() == DeviceType.CPU
                   and ev.name().startswith("aten::")})
    return dict(device_ms=sum(by_name.values()), device_kernels=len(by_name),
                library_gemms=library_gemms("train-mesh", by_name),
                library_attention=sorted(k for k in by_name
                                         if LIBRARY_ATTENTION.search(k)),
                host_ops=len(host),
                host_gemm_ops=[op for op in host if HOST_GEMM_OPS.match(op)])


def moe_ep_loop(whole, x, *, top_k, activation, dp, cf) -> tuple:
    """The EP layer written apart from ``ffn._moe_local`` (no one-hot
    slots, no index_put buffer, no 4-D products, no partials by rank):
    for each of ``dp`` data shards of ``x``'s rows and each expert, the
    list of its (token, k) assignments in flattened order, the first
    ``capacity`` of them kept (the reference's rule, written out here),
    the expert's FFN on their tokens by ``torch.matmul`` in fp32, weighted
    by the renormalised router probability and added to the token's row.
    The router logits come from the matmul kernel, which gives a row the
    same bits at any row count, so both sides rank the same experts; the
    top k are taken from the logits.  Returns (y (B, S, D) fp32, the
    load-balance loss over every token, the count of dropped
    assignments)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.common import epilogue_of, is_glu

    router = whole["router"]
    n_exp = router.shape[1]
    b, s, d = x.shape
    f = whole["w_in"].shape[1] // n_exp
    t_local = b // dp * s
    raw = int(t_local * top_k / n_exp * cf)
    step = 128 if raw >= 128 else 8
    capacity = -(-max(raw, 8) // step) * step
    act = ref.EPILOGUES[epilogue_of(activation)]
    tokens = x.reshape(-1, d).float()
    y = torch.zeros_like(tokens)
    prob_sum = torch.zeros(n_exp, device=x.device)
    picks = torch.zeros(n_exp, device=x.device)
    dropped = 0
    for shard in range(dp):
        rows = slice(shard * t_local, (shard + 1) * t_local)
        t = tokens[rows]
        logits = ops.matmul(t, router)
        probs = torch.softmax(logits, -1)
        ids = torch.topk(logits, top_k, -1).indices
        w = probs.gather(1, ids)
        w = (w / w.sum(-1, keepdim=True).clamp(min=1e-9)).reshape(-1)
        prob_sum += probs.sum(0)
        picks += torch.bincount(ids.reshape(-1), minlength=n_exp).float()
        flat = ids.reshape(-1)
        for e in range(n_exp):
            mine = torch.nonzero(flat == e)[:, 0]  # ascending: (token, k)
            kept = mine[:capacity]
            dropped += mine.numel() - kept.numel()
            if not kept.numel():
                continue
            xe = t[kept // top_k]
            cols = slice(e * f, (e + 1) * f)
            h = act(torch.matmul(xe, (whole["w_gate"] if is_glu(activation)
                                      else whole["w_in"])[:, cols].float()))
            if is_glu(activation):
                h = h * torch.matmul(xe, whole["w_in"][:, cols].float())
            out = torch.matmul(h, whole["w_out"][cols].float())
            y[rows].index_add_(0, kept // top_k, out * w[kept, None])
    frac = picks / picks.sum().clamp(min=1.0)
    aux = n_exp * torch.sum(frac * prob_sum / (b * s))
    return y.reshape(b, s, d), aux, dropped


def ep_check(ctx, model, placed, specs, cf, seed) -> dict:
    """Layer 0's experts on ``ctx`` (moe_ep, capacity factor ``cf``)
    against moe_ep_plain on one device from the same whole leaves and
    tokens (the output and the load-balance loss within EP_TOL, the same
    dropped assignments), and against moe_ep_loop, which shares no code of
    the capacity, slot or combine logic with them (the output within
    F32_TOL x max|y|, torch.matmul against the kernel, the load-balance
    loss within EP_TOL, the same drops)."""
    from repro_torch.distributed import take
    from repro_torch.distributed.sharding import place_tree, unplace_tree
    from repro_torch.models import ffn

    cfg = model.cfg
    b, s = TRAIN_MESH_FP32_BATCH
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda")
    lps = [p["params"]["layers"][0]["ffn"] for p in placed]
    lspecs = specs["params"]["layers"][0]["ffn"]
    full = ctx.gather_tree(lps, lspecs)  # each position's expert block
    whole = unplace_tree(ctx.mesh, lps, lspecs)
    xspec = {"x": (ctx.dp_spec, None, None)}
    xs = [t["x"] for t in place_tree(ctx.mesh, {"x": x}, xspec)]
    with torch.no_grad():
        ys, auxs, dropped = ffn.moe_ep(ctx, full, xs,
                                       top_k=cfg.experts_per_token,
                                       activation=cfg.activation,
                                       capacity_factor=cf)
        y = unplace_tree(ctx.mesh, [{"x": t} for t in ys], xspec)["x"]
        want, aux, drop = ffn.moe_ep_plain(
            whole, x, top_k=cfg.experts_per_token, activation=cfg.activation,
            ep=ctx.tp, dp=ctx.dp, capacity_factor=cf)
        loop, loop_aux, loop_drop = moe_ep_loop(
            whole, x, top_k=cfg.experts_per_token, activation=cfg.activation,
            dp=ctx.dp, cf=cf)
    drops = sum(int(take(ctx.mesh, dropped, i)) for i in range(ctx.mesh.size))
    aux0 = float(take(ctx.mesh, auxs, 0))
    return dict(capacity=ffn.moe_capacity(b * s // ctx.dp,
                                          cfg.experts_per_token,
                                          cfg.n_experts, cf),
                y_err=rel_err(y, want),
                aux_err=abs(aux0 - float(aux)) / abs(float(aux)),
                dropped=drops, dropped_plain=int(drop),
                loop_y_err=rel_err(y, loop),
                loop_aux_err=abs(aux0 - float(loop_aux)) / abs(
                    float(loop_aux)),
                dropped_loop=int(loop_drop),
                assignments=b * s * cfg.experts_per_token)


def train_mesh_fp32(arch, shape, cfs, card, mm, fa) -> tuple:
    """fp32 at TRAIN_MESH_FP32_LAYERS layers, full width, the sharded step
    against the unsharded card's: the loss within TRAIN_MESH_TOL (rtol),
    every gradient within TRAIN_MESH_TOL x max|grad| and every parameter
    after one step within TRAIN_MESH_TOL x max|p|; for a mixture of
    experts at each capacity factor the EP layer against moe_ep_plain
    (ep_check), none dropped at 8.0."""
    from repro_torch.configs import get_config
    from repro_torch.core.costs.engine import CostEngine
    from repro_torch.distributed.sharding import unplace_tree
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import (TrainLoopConfig, init_train_state,
                                      make_grad_fn, make_train_step)

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              n_layers=TRAIN_MESH_FP32_LAYERS)
    if cfg.is_encdec:
        cfg = dataclasses.replace(cfg, encoder_layers=TRAIN_MESH_FP32_LAYERS)
    model = build_model(cfg, "cuda")
    loop = TrainLoopConfig(optimizer=AdamWConfig(lr=TRAIN_MESH_LR,
                                                 eps=TRAIN_MESH_EPS),
                           warmup_steps=0)
    state = init_train_state(model, 0, loop)
    batch = train_mesh_batch(cfg, *TRAIN_MESH_FP32_BATCH, seed=1)
    fails, rec = [], {"layers": cfg.n_layers, "mesh": shape, "ep": {}}
    engine = CostEngine()
    for cf in reversed(cfs):  # the full check (the first) last
        ctx = train_mesh_ctx(shape, cf, engine)
        placed, specs = placed_state(ctx, model, state)
        if cfg.is_moe:
            ep = ep_check(ctx, model, placed, specs, cf, seed=3)
            rec["ep"][cf] = ep
            log("train-mesh", f"{arch} fp32 EP at capacity factor {cf} "
                f"({ep['capacity']} slots an expert): y against "
                f"moe_ep_plain {ep['y_err']:.2e} x max|y|, aux "
                f"{ep['aux_err']:.2e} (limit {EP_TOL}); against the "
                f"expert-by-expert loop y {ep['loop_y_err']:.2e} x max|y| "
                f"(limit {F32_TOL}), aux {ep['loop_aux_err']:.2e}; dropped "
                f"{ep['dropped']} of {ep['assignments']} assignments "
                f"(plain {ep['dropped_plain']}, loop {ep['dropped_loop']})")
            if not (ep["y_err"] <= EP_TOL and ep["aux_err"] <= EP_TOL
                    and ep["loop_y_err"] <= F32_TOL
                    and ep["loop_aux_err"] <= EP_TOL
                    and ep["dropped"] == ep["dropped_plain"]
                    == ep["dropped_loop"]):
                fails.append(f"{arch} EP at cf {cf}: {ep}")
            if cf >= 8.0 and ep["dropped"]:
                fails.append(f"{arch} EP at cf {cf} dropped {ep['dropped']}")
        pb = placed_batch(ctx, batch)
        params = [p["params"] for p in placed]
        if cf != cfs[0]:
            with torch.no_grad():
                loss = float(model.loss(params, pb, ctx)[0][0])
            rec[f"loss_cf{cf}"] = loss
            log("train-mesh", f"{arch} fp32 sharded loss at capacity factor "
                f"{cf}: {loss:.6f}")
            del placed, params, pb
            continue
        loss_u, _, grads_u = make_grad_fn(model)(state["params"], batch)
        mm.LAUNCHES.reset()
        fa.LAUNCHES.reset()
        col0 = ctx.mesh.collectives
        loss_s, _, grads_s = make_grad_fn(model, ctx=ctx)(params, pb)
        torch.cuda.synchronize()
        rec["launches"] = train_launches(ctx.mesh, mm, fa)
        rec["collectives"] = ctx.mesh.collectives - col0
        fails += launch_fails(f"{arch} fp32", rec["launches"], cfg.is_moe)
        lu, ls = float(loss_u), float(loss_s[0])
        rec["loss"] = dict(unsharded=lu, sharded=ls,
                           rel=abs(ls - lu) / abs(lu))
        whole = unplace_tree(ctx.mesh, grads_s, specs["params"])
        rec["grad_worst"] = worst_leaf(grads_u, whole)
        del whole, grads_s, grads_u
        step_u = make_train_step(model, loop, donate=True)
        step_s = make_train_step(model, loop, ctx=ctx, donate=True)
        state, m_u = step_u(state, batch)
        placed, m_s = step_s(placed, pb)
        whole = unplace_tree(ctx.mesh, [p["params"] for p in placed],
                             specs["params"])
        rec["param_worst"] = worst_leaf(state["params"], whole)
        rec["grad_norm"] = dict(unsharded=float(m_u["grad_norm"]),
                                sharded=float(m_s[0]["grad_norm"]))
        del whole, placed, params, pb
        if not (rec["loss"]["rel"] <= TRAIN_MESH_TOL
                and rec["grad_worst"][0] <= TRAIN_MESH_TOL
                and rec["param_worst"][0] <= TRAIN_MESH_TOL):
            fails.append(f"{arch} fp32 sharded against unsharded: loss "
                         f"{rec['loss']}, worst gradient "
                         f"{rec['grad_worst']}, worst parameter after a "
                         f"step {rec['param_worst']} (limit "
                         f"{TRAIN_MESH_TOL})")
    rec["moe_dispatch"] = [dict(choice=e.choice, query=e.query)
                           for e in engine.ledger.entries
                           if e.site == "moe_dispatch"]
    rec["wall_s"] = time.perf_counter() - t0
    lr = rec["launches"]
    depth = (f"{cfg.encoder_layers} + {cfg.n_layers}" if cfg.is_encdec
             else cfg.n_layers)
    log("train-mesh", f"{arch} full width, {depth} layers, fp32, "
        f"batch {TRAIN_MESH_FP32_BATCH}, mesh {shape} on 8 positions: loss "
        f"sharded {rec['loss']['sharded']:.6f}, unsharded "
        f"{rec['loss']['unsharded']:.6f} (rel {rec['loss']['rel']:.2e}); "
        f"worst gradient {rec['grad_worst'][0]:.2e} x max|grad| at "
        f"{rec['grad_worst'][1]}; worst parameter after one step "
        f"{rec['param_worst'][0]:.2e} x max|p| at {rec['param_worst'][1]} "
        f"(limit {TRAIN_MESH_TOL}); grad_norm {rec['grad_norm']}; one "
        f"gradient's launches: matmul {lr['matmul']} "
        f"{lr['matmul_by_position']} by position (4-D "
        f"{lr['batched_by_position']}), flash forward "
        f"{lr['flash_forward_by_position']}, backward "
        f"{lr['flash_backward_by_position']}; collective calls "
        f"{rec['collectives']}; {rec['wall_s']:.1f} s ({card})")
    del state, model
    return rec, fails


def train_mesh_bf16(arch, depth, shape, card, mm, fa, checks=None,
                    seeds=TRAIN_MESH_LOSS_SEEDS) -> tuple:
    """bf16 at full width: TRAIN_MESH_STEPS steps on one fixed batch of
    TRAIN_MESH_BATCH, unsharded and on ``shape``'s 8 positions, the state
    made afresh from seed 0 for each (one state on the card at a time).
    Gates: the sharded first loss (a mixture of experts' at
    TRAIN_MESH_GATE_CF, where nothing drops) no further from the same
    weights' fp32 loss than the unsharded bf16 loss is, plus
    TRAIN_MESH_TOL x |loss|; the fixed batch's loss falls; the first call
    of every matmul and flash signature of the first sharded step,
    forward and backward, within its limit against the plain version
    (StepChecks; a mixture of experts' 4-D expert products among them);
    matmul and flash launches on every position; no library GEMM or
    attention in a profiled sharded step.  Printed: the first loss three
    ways on each batch of TRAIN_MESH_LOSS_SEEDS; step wall, tokens/s,
    host ms, device ms, peak memory, collective calls and FSDP-gathered
    bytes a step, both ways.  ``checks``: the StepChecks to hold the
    first sharded step in (a fresh one by default), for the caller to read
    its signatures after; ``seeds``: the batches of the first-loss gate,
    the first the fixed batch the steps take."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core.costs.engine import CostEngine
    from repro_torch.core.planner import plan_model
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.calls import CallLog
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import (TrainLoopConfig, init_train_state,
                                      make_train_step)
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    full = get_config(arch)
    cfg = full if depth is None else dataclasses.replace(full,
                                                         n_layers=depth)
    b, s = TRAIN_MESH_BATCH
    loop = TrainLoopConfig(optimizer=AdamWConfig(lr=TRAIN_MESH_LR),
                           warmup_steps=0)
    fails, rec = [], {"layers": cfg.n_layers, "of": full.n_layers,
                      "mesh": shape}
    model = build_model(cfg, "cuda")
    batches = [train_mesh_batch(cfg, b, s, seed=sd) for sd in seeds]
    batch = batches[0]
    state = init_train_state(model, 0, loop)
    # the fixed batch's bf16 first losses are the steps' first losses (the
    # same forward, the same bits) where the step's loss is the gate's
    # function: for all but a mixture of experts, whose gate runs at
    # TRAIN_MESH_GATE_CF
    reuse = 0 if cfg.is_moe else 1
    with torch.no_grad():  # the first losses: fp32 and unsharded bf16
        model32 = build_model(dataclasses.replace(cfg, dtype="float32"),
                              "cuda")
        p32 = tree_map(lambda t: t.float(), state["params"])
        losses32 = [float(model32.loss(p32, bt, remat=False)[0])
                    for bt in batches]
        del p32, model32
        losses_bf = [float(model.loss(state["params"], bt, remat=False)[0])
                     for bt in batches[reuse:]]
    loss32 = losses32[0]

    def run(step, st, feed, label, ctx=None, counted=None, checks=None):
        """TRAIN_MESH_STEPS steps on ``feed``, the first inside ``checks``
        where given (it then reads slow: step 1 is the warm-up, and the
        reported wall is step 2's), the last profiled, then the loss after
        them; ``counted()`` read right after the steps."""
        losses, walls, hosts = [], [], []
        peak_kept = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(TRAIN_MESH_STEPS):
            if i == 0 and checks is not None:
                with checks:
                    st, m = step(st, feed)
                torch.cuda.synchronize()
            elif i == TRAIN_MESH_STEPS - 1:
                out = {}

                def one():
                    out["r"] = step(st, feed)

                prof = profile_train_step(one)
                st, m = out["r"]
            else:
                # phase 27's dry run traces tinyllama's sharded step: its
                # kernel calls by position, its collectives and its peak
                held = ctx is not None and arch == "tinyllama-1.1b"
                torch.cuda.synchronize()
                if held:
                    peak_before = torch.cuda.max_memory_allocated()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    cols = (ctx.mesh.collectives,
                            dict(ctx.mesh.collective_bytes))
                t = time.perf_counter()
                with (CallLog() if held else contextlib.nullcontext()) \
                        as calls_:
                    st, m = step(st, feed)
                    hosts.append((time.perf_counter() - t) * 1e3)
                    torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
                if held:
                    DRYRUN_CAPTURE["train_mesh"] = dict(
                        arch=arch, layers=cfg.n_layers, loop=loop,
                        batch=(b, s), mesh=dict(ctx.mesh.shape),
                        data_axes=ctx.data_axes, attn_chunk=ctx.attn_chunk,
                        rnn_chunk=ctx.rnn_chunk,
                        moe_capacity_factor=ctx.moe_capacity_factor,
                        calls=calls_.counts(by_position=True),
                        collectives=ctx.mesh.collectives - cols[0],
                        collective_bytes={
                            k: v - cols[1][k] for k, v in
                            ctx.mesh.collective_bytes.items()},
                        peak=torch.cuda.max_memory_allocated(), base=base,
                        args=storage_bytes(st, feed), wall_ms=walls[-1])
                    peak_kept = peak_before
            losses.append(float((m[0] if isinstance(m, list) else m)["loss"]))
        counts = counted() if counted is not None else None
        with torch.no_grad():
            if ctx is None:
                last = model.loss(st["params"], feed, remat=False)[0]
            else:
                last = model.loss([p["params"] for p in st], feed, ctx)[0][0]
        losses.append(float(last))
        # the run's peak, over the step phase 27 reset it for too
        peak = max(torch.cuda.max_memory_allocated(), peak_kept) / 1e9
        wall = walls[-1]
        log("train-mesh", f"{arch} bf16 {label}: losses {losses} (the last "
            f"after step {TRAIN_MESH_STEPS}); step walls {walls} ms, host "
            f"{hosts} ms; {b * s / wall * 1e3:.1f} tokens/s; peak "
            f"{peak:.2f} GB ({card})")
        return st, dict(losses=losses, step_ms=walls, host_ms=hosts,
                        tokens_per_s=b * s / wall * 1e3, peak_gb=peak,
                        profile=prof, counts=counts)

    st, rec["unsharded"] = run(make_train_step(model, loop, donate=True),
                               state, batch, "unsharded")
    losses_bf = rec["unsharded"]["losses"][:reuse] + losses_bf
    loss_bf = losses_bf[0]
    del st, state
    gc.collect()
    torch.cuda.empty_cache()
    engine = CostEngine()
    # the planner over the shared card, its chunks carried into the
    # context as the reference's dry run carries them
    mesh_ctx0 = train_mesh_ctx(shape)
    plan = plan_model(cfg, ShapeSpec("train_mesh", s, b, "train"),
                      mesh_ctx0.mesh, engine=engine)
    ctx = train_mesh_ctx(shape, 1.25, engine, plan)
    placed, _ = placed_state(ctx, model, init_train_state(model, 0, loop))
    gc.collect()
    torch.cuda.empty_cache()
    pb = placed_batch(ctx, batch)
    # the sharded first losses before any step, a mixture of experts' at
    # TRAIN_MESH_GATE_CF (no drops: the dense fp32 loss's function)
    gate_ctx = ctx
    if cfg.is_moe:
        gate_ctx = dataclasses.replace(
            ctx, moe_capacity_factor=TRAIN_MESH_GATE_CF)
    with torch.no_grad():
        params = [p["params"] for p in placed]
        losses_sh = [float(model.loss(params, placed_batch(ctx, bt),
                                      gate_ctx)[0][0])
                     for bt in batches[reuse:]]
        del params
    step = make_train_step(model, loop, ctx=ctx, donate=True)
    checks = StepChecks(ops, fa, ref) if checks is None else checks
    mm.LAUNCHES.reset()
    fa.LAUNCHES.reset()
    col0, gb0 = ctx.mesh.collectives, ctx.mesh.gathered_bytes
    placed, rec["sharded"] = run(
        step, placed, pb, "sharded on 8 positions", ctx=ctx,
        counted=lambda: (train_launches(ctx.mesh, mm, fa),
                         ctx.mesh.collectives - col0,
                         ctx.mesh.gathered_bytes - gb0), checks=checks)
    four_d = [c for c in checks.matmuls.values() if c["ndim"] == 4]
    directions = {k[0] for k in checks.flash}
    rec["signatures"] = dict(
        matmul=len(checks.matmuls), matmul_4d=len(four_d),
        flash=len(checks.flash),
        matmul_worst=max(checks.matmuls.values(),
                         key=lambda c: c["max_abs_err"] / c["tol"]),
        flash_worst=max(checks.flash.values(),
                        key=lambda c: c["of_limit"]),
        four_d=[c["call"] for c in four_d])
    fails += [f"{arch} bf16 sharded step: {f}" for f in checks.fails]
    if directions != {"forward", "backward"} or (cfg.is_moe
                                                 and not four_d):
        fails.append(f"{arch} bf16 sharded step: checked flash directions "
                     f"{sorted(directions)}, 4-D matmul signatures "
                     f"{len(four_d)}")
    sig = rec["signatures"]
    worst = sig["matmul_worst"]
    log("train-mesh", f"{arch} bf16 sharded step 1: {sig['matmul']} matmul "
        f"signatures ({sig['matmul_4d']} 4-D: {sig['four_d']}), worst "
        f"{worst['call']} {worst['max_abs_err']:.3e} (limit "
        f"{worst['tol']:.3e}); {sig['flash']} flash "
        f"signatures, worst {sig['flash_worst']['call']} "
        f"{sig['flash_worst']['of_limit']:.2f} x its limit; outside "
        f"{len(checks.fails)} ({card})")
    n = TRAIN_MESH_STEPS
    lr, cols, gathered = rec["sharded"].pop("counts")
    # counted over the steps: per step
    rec["launches_per_step"] = {
        k: (v / n if isinstance(v, int) and k != "positions" else
            [x / n for x in v] if isinstance(v, list) else v)
        for k, v in lr.items()}
    rec["collectives_per_step"] = cols / n
    rec["gathered_gb_per_step"] = gathered / n / 1e9
    fails += launch_fails(f"{arch} bf16", lr, cfg.is_moe)
    prof = rec["sharded"]["profile"]
    uprof = rec["unsharded"]["profile"]
    for which, pr in (("sharded", prof), ("unsharded", uprof)):
        if pr["library_gemms"] or pr["library_attention"] \
                or pr["host_gemm_ops"]:
            fails.append(f"{arch} bf16: library work in the {which} step: "
                         f"{pr}")
    sh, un = rec["sharded"]["losses"], rec["unsharded"]["losses"]
    losses_sh = sh[:reuse] + losses_sh
    err_sh, err_un = abs(losses_sh[0] - loss32), abs(loss_bf - loss32)
    gate_cf = gate_ctx.moe_capacity_factor if cfg.is_moe else None
    rec["first_loss"] = dict(fp32=losses32, unsharded=losses_bf,
                             sharded=losses_sh, gate_cf=gate_cf,
                             sharded_step=sh[0], sharded_err=err_sh,
                             unsharded_err=err_un)
    if not err_sh <= err_un + TRAIN_MESH_TOL * abs(loss32):
        fails.append(f"{arch} bf16: the sharded first loss {losses_sh[0]} "
                     f"is {err_sh:.3e} from the fp32 {loss32}, the "
                     f"unsharded {loss_bf} {err_un:.3e} (slack "
                     f"{TRAIN_MESH_TOL} x |loss|)")
    log("train-mesh", f"{arch} bf16 first losses by batch (seeds "
        f"{list(seeds)}): fp32 {losses32}, unsharded "
        f"{losses_bf}, sharded (cf {gate_cf}) {losses_sh}; "
        f"|unsharded - fp32| "
        f"{[f'{abs(u - f):.2e}' for u, f in zip(losses_bf, losses32)]}, "
        f"|sharded - fp32| "
        f"{[f'{abs(v - f):.2e}' for v, f in zip(losses_sh, losses32)]}, "
        f"|sharded - unsharded| "
        f"{[f'{abs(v - u):.2e}' for v, u in zip(losses_sh, losses_bf)]}; "
        f"the step's sharded first loss {sh[0]} at cf "
        f"{ctx.moe_capacity_factor if cfg.is_moe else '-'} ({card})")
    if not sh[-1] < sh[0]:
        fails.append(f"{arch} bf16: the fixed batch's sharded loss did not "
                     f"fall: {sh}")
    rec["plan"] = [dict(site=d.site, choice=d.choice, tp_s=d.tp_cost,
                        rep_s=d.rep_cost) for d in plan.decisions]
    rec["moe_dispatch"] = sorted({e.choice for e in engine.ledger.entries
                                  if e.site == "moe_dispatch"})
    rec["wall_s"] = time.perf_counter() - t0
    ls = rec["launches_per_step"]
    log("train-mesh", f"{arch} bf16, {cfg.n_layers} of {full.n_layers} "
        f"layers, batch {b} x {s}, mesh {shape}: first loss fp32 "
        f"{loss32:.5f}, unsharded bf16 {loss_bf:.5f} ({err_un:.2e} off), "
        f"sharded {losses_sh[0]:.5f} ({err_sh:.2e} off); a step sharded | "
        f"unsharded: wall {rec['sharded']['step_ms'][-1]:.1f} | "
        f"{rec['unsharded']['step_ms'][-1]:.1f} ms, host "
        f"{rec['sharded']['host_ms'][-1]:.1f} | "
        f"{rec['unsharded']['host_ms'][-1]:.1f} ms, peak "
        f"{rec['sharded']['peak_gb']:.2f} | "
        f"{rec['unsharded']['peak_gb']:.2f} GB; device ms of the profiled "
        f"step {prof['device_ms']:.1f} | {uprof['device_ms']:.1f} "
        f"({prof['device_kernels']} | {uprof['device_kernels']} kernel "
        f"names), host aten ops {prof['host_ops']}, GEMM among them "
        f"{prof['host_gemm_ops']}, library GEMM {prof['library_gemms']}, "
        f"attention {prof['library_attention']}; launches a step: matmul "
        f"{ls['matmul']:.0f} on {ls['positions']} positions "
        f"({ls['matmul_by_position']} by position, 4-D "
        f"{ls['batched_by_position']}), flash forward "
        f"{ls['flash_forward']:.0f} {ls['flash_forward_by_position']}, "
        f"backward {ls['flash_backward']:.0f} "
        f"{ls['flash_backward_by_position']}; collective calls "
        f"{rec['collectives_per_step']:.0f} a step, FSDP-gathered "
        f"{rec['gathered_gb_per_step']:.2f} GB a step; plan "
        f"{[(d['site'], d['choice']) for d in rec['plan']]}, moe_dispatch "
        f"{rec['moe_dispatch']}; {rec['wall_s']:.1f} s ({card})")
    del placed, pb, model
    return rec, fails


def train_mesh_elastic(card) -> tuple:
    """fp32 tinyllama-1.1b at TRAIN_MESH_FP32_LAYERS layers: 3 steps on the
    first mesh of TRAIN_MESH_ELASTIC, saved whole, restored onto the
    second, a fourth step; its loss equal the uninterrupted unsharded
    run's fourth within TRAIN_MESH_TOL (rtol)."""
    import shutil

    from repro_torch.checkpoint import restore_resharded, save
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import (TrainLoopConfig, init_train_state,
                                      make_train_step)

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), dtype="float32",
                              n_layers=TRAIN_MESH_FP32_LAYERS)
    model = build_model(cfg, "cuda")
    loop = TrainLoopConfig(optimizer=AdamWConfig(lr=TRAIN_MESH_LR),
                           warmup_steps=0)
    batches = [train_mesh_batch(cfg, *TRAIN_MESH_FP32_BATCH, seed=10 + i)
               for i in range(4)]
    state = init_train_state(model, 0, loop)
    step = make_train_step(model, loop, donate=True)
    want = []
    for bt in batches:
        state, m = step(state, bt)
        want.append(float(m["loss"]))
    first, second = (train_mesh_ctx(s) for s in TRAIN_MESH_ELASTIC)
    placed, specs = placed_state(first, model,
                                 init_train_state(model, 0, loop))
    step1 = make_train_step(model, loop, ctx=first, donate=True)
    got = []
    for bt in batches[:3]:
        placed, m = step1(placed, placed_batch(first, bt))
        got.append(float(m[0]["loss"]))
    ckpt = ROOT / "build" / "train_mesh_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t_save = time.perf_counter()
    save(ckpt, 3, placed, mesh=first.mesh, shardings=specs)
    save_s = time.perf_counter() - t_save
    del placed
    specs2 = param_shardings(state, second.mesh, data_axes=second.data_axes,
                             cfg=cfg)
    restored = restore_resharded(ckpt, 3, state, specs2, mesh=second.mesh,
                                 copy=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    steps_ok = all(int(p["step"]) == 3 for p in restored)
    step2 = make_train_step(model, loop, ctx=second, donate=True)
    restored, m = step2(restored, placed_batch(second, batches[3]))
    got.append(float(m[0]["loss"]))
    rel = abs(got[3] - want[3]) / abs(want[3])
    fails = []
    if not (rel <= TRAIN_MESH_TOL and steps_ok):
        fails.append(f"elastic: step 4's loss {got[3]} against the "
                     f"uninterrupted {want[3]} (rel {rel:.2e}, limit "
                     f"{TRAIN_MESH_TOL}); restored step 3 {steps_ok}")
    wall = time.perf_counter() - t0
    log("train-mesh", f"elastic: tinyllama-1.1b fp32 {cfg.n_layers} layers, "
        f"3 steps on {TRAIN_MESH_ELASTIC[0]}, saved whole ({save_s:.1f} s), "
        f"restored on {TRAIN_MESH_ELASTIC[1]}: losses {got}, uninterrupted "
        f"unsharded {want}; step 4 rel {rel:.2e} (limit {TRAIN_MESH_TOL}); "
        f"{wall:.1f} s ({card})")
    del restored, state, model
    return dict(losses=got, unsharded=want, rel=rel, save_s=save_s,
                wall_s=wall), fails


def shared_card_verdicts(card) -> tuple:
    """The engine's auto verdicts on 8 positions of the one card, after
    pricing positions on one device as that device's: the sort at 2^26,
    an order-8192 product, serve_shard for mistral-nemo-12b at 8 of 40
    layers (which picked shard before), the planner's layer_shard and
    moe_dispatch sites for the trained configurations; every one serial,
    replicate or replicated_psum."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core.costs.engine import CostEngine
    from repro_torch.core.planner import plan_model
    from repro_torch.serving.scheduler import ServeScheduler

    eng = CostEngine()
    mesh = train_mesh_ctx(TRAIN_MESH_EP).mesh
    dev = mesh.distinct_devices()
    out = {"devices": dev,
           "sort": eng.decide_sort(1 << 26, chips=8, devices=dev).choice,
           "matmul": eng.decide_matmul(8192, 8192, 8192, chips=8,
                                       devices=dev).choice}
    nemo = dataclasses.replace(get_config("mistral-nemo-12b"), n_layers=8)
    out["serve_shard"] = ServeScheduler(nemo, eng, max_len=96).serve_shard(
        4, tp=8, devices=dev)[1].choice
    for arch, _, shape in TRAIN_MESH_BF16:
        plan = plan_model(get_config(arch), ShapeSpec(
            "train_mesh", TRAIN_MESH_BATCH[1], TRAIN_MESH_BATCH[0], "train"),
            train_mesh_ctx(shape).mesh, engine=eng)
        for d in plan.decisions:
            out[f"{arch} {d.site}"] = d.choice
    rows = [e for e in eng.ledger.entries
            if e.site in ("layer_shard", "moe_dispatch")]
    bad = {k: v for k, v in out.items()
           if k != "devices" and v not in SHARED_VERDICTS}
    log("train-mesh", f"auto verdicts on 8 positions of {dev} device: "
        f"{out}; {len(rows)} layer_shard/moe_dispatch rows, e.g. "
        + "; ".join(f"{e.site} {e.query} -> {e.choice} "
                    f"({e.predicted_s:.3e} s)" for e in rows[:4])
        + f" ({card})")
    return out, ([f"shared-card verdicts not serial or replicate: {bad}"]
                 if bad else [])


def train_mesh_phase(card):
    """Phase 25: FSDP training with tensor and expert parallelism on 8
    positions of the one card (shards_per_device=8, a CUDA stream a
    position), random weights from seed 0: TRAIN_MESH_FP32 (fp32 against
    the unsharded card, the EP layer against moe_ep_plain), TRAIN_MESH_BF16
    (bf16 steps, sharded against unsharded), the elastic restore, and the
    engine's verdicts on the shared card.  None on any failure."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm

    t_phase = time.perf_counter()
    out: dict = {"card": card, "fp32": {}, "bf16": {}}
    fails = []
    out["verdicts"], f = shared_card_verdicts(card)
    fails += f
    for arch, shape, cfs in TRAIN_MESH_FP32:
        out["fp32"][arch], f = train_mesh_fp32(arch, shape, cfs, card, mm,
                                               fa)
        fails += f
        gc.collect()
        torch.cuda.empty_cache()
    for arch, depth, shape in TRAIN_MESH_BF16:
        out["bf16"][arch], f = train_mesh_bf16(arch, depth, shape, card, mm,
                                               fa)
        fails += f
        gc.collect()
        torch.cuda.empty_cache()
    out["elastic"], f = train_mesh_elastic(card)
    fails += f
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    out["fails"] = fails
    for f in fails:
        log("train-mesh", f"FAIL {f}")
    log("train-mesh", f"phase 25 wall {out['wall_s']:.1f} s; {len(fails)} "
        f"failures ({card})")
    return None if fails else out



# ---------------------------------------------------------------------------
# Phase 26: the encoder-decoder and gradient compression on eight positions
# ---------------------------------------------------------------------------

# seamless-m4t-medium trains on TRAIN_MESH_DP (fp32 at
# TRAIN_MESH_FP32_LAYERS + TRAIN_MESH_FP32_LAYERS layers, bf16 whole) and
# serves on 2 positions of the card: at full width the model axis divides
# its vocabulary (256,206 = 2 x 128,103) only at 2
ENCDEC_SERVE_MESH = {"data": 1, "model": 2}
ENCDEC_SERVE_KW = dict(mesh_shape=ENCDEC_SERVE_MESH, shard_params="shard",
                       shards_per_device=2)
# the bf16 first-loss gate on the fixed batch alone (phase 25 reads three)
ENCDEC_MESH_LOSS_SEEDS = TRAIN_MESH_LOSS_SEEDS[:1]
# the bf16 serve: phase 5's trace cut to this many new tokens
ENCDEC_SERVE_NEW = 8
# a position's vocab block at model 2: its fp32 logits rows are 512,412
# bytes and its bf16 hi/lo halves' 256,206, neither a multiple of 16, so
# no tensor map loads them and the split path copies them (copy_tile)
ENCDEC_VOCAB_BLOCK = 128103
# compression: tinyllama-1.1b at TRAIN_MESH_FP32_LAYERS layers, fp32, on
# TRAIN_MESH_DP, keep_frac COMPRESS_KEEP, COMPRESS_STEPS steps
COMPRESS_KEEP = 0.1
COMPRESS_STEPS = 3


def vocab_block_products(checks, rows, ops, ref, flush) -> list:
    """Every matmul signature of a held step (``checks``) with a dimension
    of ``rows``, made again from random tensors of its shapes, strides and
    dtypes: the kernel's ms (cold L2, CUDA events), the operands it copied
    (no tensor map), its plain version's and ``torch.matmul``'s ms in fp32,
    and the bound."""
    from repro_torch.kernels import matmul as mm

    out = []
    for key, rec in checks.matmuls.items():
        a_shape, a_stride, a_dtype, b_shape, b_stride, b_dtype, bias, act, \
            out_dtype = key
        if rows not in a_shape + b_shape or bias or act:
            continue
        a = torch.empty_strided(a_shape, a_stride, dtype=a_dtype,
                                device="cuda").normal_()
        b = torch.empty_strided(b_shape, b_stride, dtype=b_dtype,
                                device="cuda").normal_()
        mm.LAUNCHES.reset()
        ops._matmul(a, b, None, None, out_dtype)
        torch.cuda.synchronize()
        copied, by_path = mm.LAUNCHES.copied_operands, dict(
            mm.LAUNCHES.by_path)
        ms = cuda_ms(lambda: ops._matmul(a, b, None, None, out_dtype), flush,
                     reps=3, warm=1)
        plain_ms = cuda_ms(lambda: ref.matmul_fused_ref(
            a, b, out_dtype=out_dtype), flush, reps=3, warm=1)
        lib_ms = cuda_ms(lambda: torch.matmul(a.float(), b.float()), flush,
                         reps=3, warm=1)
        t_ops, t_bytes = bound_terms(a, b, out_dtype)
        out.append(dict(call=rec["call"], ms=ms, plain_ms=plain_ms,
                        library_ms=lib_ms, bound_ms=max(t_ops, t_bytes),
                        bound_by="operations" if t_ops >= t_bytes
                        else "bytes",
                        tflops=rates(a, b, out_dtype, ms)[0],
                        copied_operands=copied,
                        path=[p for p, n in by_path.items() if n]))
        del a, b
        torch.cuda.empty_cache()
    return out


def encdec_serve_mesh(card, mm, fa) -> tuple:
    """seamless-m4t-medium whole, served on ENCDEC_SERVE_MESH (2 positions
    of GPU 0, forced shard).  fp32, on SERVE_MESH_FP32_TRACE's trace: the
    sharded continuous tokens equal the unsharded card's static and
    continuous ones; the sharded Model.prefill (the encoder over the
    prompts' frames and a cross term that is not zero) within LOGIT_TOL x
    max|logit| of the unsharded card's, its flash calls every layer's on
    both positions.  bf16, on phase 5's trace: the first
    decode step after a batched prefill and the prefill, sharded, no
    further from the fp32 computation than the unsharded are plus
    LOGIT_TOL; the served tokens (ENCDEC_SERVE_NEW a request) equal the
    unsharded engine's up to a near tie; matmul launches on both
    positions; the serve_shard ledger's predicted and measured rows (its
    KV bytes with the cross caches) and the auto verdict on one card,
    replicate."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import Runtime, synthetic_trace
    from repro_torch.training.step import make_batched_prefill
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    fails, rec = [], {"mesh": ENCDEC_SERVE_MESH}
    full = get_config(ENCDEC)
    cfg32 = dataclasses.replace(full, dtype="float32")
    rt = Runtime(device="cuda")
    model32 = build_model(cfg32, "cuda")
    model = build_model(full, "cuda")
    params = model.init(0)
    params32 = tree_map(lambda t: t.float(), params)
    # --- fp32: tokens static, continuous, sharded
    n, plen, new, slots = SERVE_MESH_FP32_TRACE
    trace = lambda: synthetic_trace(  # noqa: E731
        n, prompt_len=plen, max_new=new, vocab_size=full.vocab_size,
        arrival="all", seed=0)
    common = dict(model=model32, params=params32, eos_id=-1, warmup=False)
    static = rt.serve(cfg32, trace(), mode="static", **common)
    cont = rt.serve(cfg32, trace(), slots=slots, **common)
    mm.LAUNCHES.reset()
    sharded = rt.serve(cfg32, trace(), slots=slots, **common,
                       **ENCDEC_SERVE_KW)
    torch.cuda.synchronize()
    engine32 = sharded.engine
    streams = [s.cuda_stream for s in engine32.mesh.streams]
    by_pos = [mm.LAUNCHES.by_stream.get(s, 0) for s in streams]
    toks = {k: np.stack([r.outputs[f"r{i}"][:new] for i in range(n)])
            for k, r in (("static", static), ("continuous", cont))}
    toks["sharded"] = rows_of(sharded.report, n, new)
    equal = all(np.array_equal(toks["static"], t) for t in toks.values())
    rec["fp32"] = dict(tokens_equal=equal, launches=mm.LAUNCHES.count,
                       launches_by_position=by_pos,
                       collective_ops=sharded.report.collective_ops,
                       tp=engine32.tp)
    if not equal or engine32.tp != 2 or min(by_pos) <= 0 or \
            sharded.report.collective_ops <= 0:
        fails.append(f"encdec serve fp32: tokens equal {equal} ({toks}), tp "
                     f"{engine32.tp}, launches by position {by_pos}, "
                     f"collectives {sharded.report.collective_ops}")
    ctx32 = engine32._ctx
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompts = torch.as_tensor(np.stack([r.prompt for r in synthetic_trace(
        REQUESTS, prompt_len=PROMPT, max_new=ENCDEC_SERVE_NEW,
        vocab_size=full.vocab_size, arrival="all", seed=0)[:SLOTS]]),
        dtype=torch.int64, device="cuda")
    pbatch = {"tokens": prompts, "frames": 0.1 * torch.randn(
        (SLOTS, PROMPT, full.d_model), generator=gen, device="cuda")}
    fa.LAUNCHES.reset()
    pre32_tp = take_logits(model32.prefill(engine32.params, pbatch, ctx32),
                           ctx32)
    torch.cuda.synchronize()
    flash_calls = fa.LAUNCHES.forward
    flash_by_pos = [fa.LAUNCHES.by_stream.get(("forward", s), 0)
                    for s in streams]
    pre32 = model32.prefill(params32, pbatch)
    rec["fp32"]["prefill"] = dict(
        sharded_vs_unsharded=rel_err(pre32_tp, pre32),
        flash_forward_calls=flash_calls, by_position=flash_by_pos)
    want_calls = 2 * (full.encoder_layers + 2 * full.n_layers)
    if not rel_err(pre32_tp, pre32) <= LOGIT_TOL or \
            flash_calls != want_calls or len(set(flash_by_pos)) != 1:
        fails.append(f"encdec fp32 sharded prefill: {rec['fp32']['prefill']}"
                     f" (limit {LOGIT_TOL}, {want_calls} flash calls)")
    log("encdec-mesh", f"{ENCDEC} whole ({full.encoder_layers} + "
        f"{full.n_layers} layers), fp32, {n} requests x {plen}+{new} tokens "
        f"on {slots} slots: sharded on {ENCDEC_SERVE_MESH} (2 positions) "
        f"tokens equal to the unsharded static and continuous serves "
        f"{equal}; matmul launches {mm.LAUNCHES.count} ({by_pos} by "
        f"position); collective calls {sharded.report.collective_ops}; the "
        f"sharded prefill ({SLOTS} x {PROMPT} tokens and frames) "
        f"{rel_err(pre32_tp, pre32):.3e} x max|logit| from the unsharded "
        f"(limit {LOGIT_TOL}), {flash_calls} flash forward calls "
        f"({flash_by_pos} by position) ({card})")
    del static, cont, sharded, engine32, ctx32
    # --- bf16: the served tokens, the first step after a prefill, prefill
    trace16 = lambda: synthetic_trace(  # noqa: E731
        REQUESTS, prompt_len=PROMPT, max_new=ENCDEC_SERVE_NEW,
        vocab_size=full.vocab_size, arrival="all", seed=0)
    common = dict(model=model, params=params, slots=SLOTS, eos_id=-1)
    plain = rt.serve(full, trace16(), **common)
    mm.LAUNCHES.reset()
    first = rt.serve(full, trace16(), **common, **ENCDEC_SERVE_KW)
    torch.cuda.synchronize()
    engine = first.engine
    by_pos = [mm.LAUNCHES.by_stream.get(s.cuda_stream, 0)
              for s in engine.mesh.streams]
    a = rows_of(plain.report, REQUESTS, ENCDEC_SERVE_NEW)
    b = rows_of(first.report, REQUESTS, ENCDEC_SERVE_NEW)
    rec["bf16"] = dict(tok_per_s=dict(unsharded=plain.tok_per_s,
                                      sharded=first.tok_per_s),
                       launches=mm.LAUNCHES.count,
                       launches_by_position=by_pos,
                       collective_ops=first.report.collective_ops)
    if min(by_pos) <= 0 or len(set(by_pos)) != 1 or engine.tp != 2:
        fails.append(f"encdec bf16 serve: tp {engine.tp}, launches by "
                     f"position {by_pos}")
    ctx = engine._ctx
    ledger = [e for e in rt.ledger.entries if e.site == "serve_shard"]
    measured = [e for e in ledger if e.measured_s is not None]
    auto_tp, auto = engine.scheduler.serve_shard(
        SLOTS, tp=2, devices=engine.mesh.distinct_devices("model"))
    kv = ledger[-1].query.get("kv_bytes_per_slot")
    rec["serve_shard"] = dict(
        forced=ledger[-1].choice, predicted_s=ledger[-1].predicted_s,
        measured_s=[e.measured_s for e in measured], auto=auto.choice,
        kv_bytes_per_slot=kv,
        self_attention_kv_bytes=engine.scheduler.kv_bytes_per_slot)
    if not measured or len(measured) == len(ledger) or \
            auto.choice != "replicate" or \
            not kv > engine.scheduler.kv_bytes_per_slot:
        fails.append(f"encdec serve_shard: {len(ledger)} rows, "
                     f"{len(measured)} measured; auto {auto.choice}; KV "
                     f"bytes a slot priced {kv} (self-attention alone "
                     f"{engine.scheduler.kv_bytes_per_slot})")
    max_len = PROMPT + ENCDEC_SERVE_NEW
    lengths = torch.full((SLOTS,), PROMPT, dtype=torch.int64, device="cuda")
    tok, st = make_batched_prefill(model)(
        params, model.init_decode_state(SLOTS, max_len, per_slot=True),
        prompts[None], lengths)
    tok_tp, st_tp = make_batched_prefill(model, ctx=ctx)(
        engine.params, mesh_state(model, engine, SLOTS, max_len),
        prompts[None], lengths)
    _, st32 = make_batched_prefill(model32)(
        params32, model32.init_decode_state(SLOTS, max_len, per_slot=True),
        prompts[None], lengths)
    feed = tok[:, None]
    lg = tp_step_logits(model, params, st, feed)[0]
    lg_tp = tp_step_logits(model, engine.params, st_tp, feed, ctx)[0]
    lg32 = tp_step_logits(model32, params32, st32, feed)[0]
    step = dict(unsharded_vs_fp32=rel_err(lg, lg32),
                sharded_vs_fp32=rel_err(lg_tp, lg32),
                sharded_vs_unsharded=rel_err(lg_tp, lg),
                first_tokens_equal=bool(torch.equal(tok.cpu(),
                                                    tok_tp.cpu())))
    pre = model.prefill(params, pbatch)
    pre_tp = take_logits(model.prefill(engine.params, pbatch, ctx), ctx)
    prefill = dict(unsharded_vs_fp32=rel_err(pre, pre32),
                   sharded_vs_fp32=rel_err(pre_tp, pre32),
                   sharded_vs_unsharded=rel_err(pre_tp, pre))
    rec["bf16"].update(first_step=step, prefill=prefill)
    for name, e in (("first decode step", step), ("prefill", prefill)):
        if not e["sharded_vs_fp32"] <= e["unsharded_vs_fp32"] + LOGIT_TOL:
            fails.append(f"encdec bf16 sharded {name}: {e} (limit the "
                         f"unsharded + {LOGIT_TOL})")
    rel_limit = 2 * (step["unsharded_vs_fp32"] + LOGIT_TOL)
    all_prompts = torch.as_tensor(np.stack([r.prompt for r in trace16()]),
                                  dtype=torch.int64, device="cuda")
    logits = forced_logits(model, params, all_prompts, a)
    equal, diffs, f = near_tie_check(logits, a, b, rel_limit)
    del logits
    fails += [f"encdec bf16 serve: {x}" for x in f]
    rec["bf16"].update(equal_tokens=equal, near_ties=diffs)
    log("encdec-mesh", f"{ENCDEC} whole, bf16, {REQUESTS} requests x "
        f"{PROMPT}+{ENCDEC_SERVE_NEW} tokens, {SLOTS} slots: unsharded "
        f"{plain.tok_per_s:.2f} tok/s, sharded on 2 positions "
        f"{first.tok_per_s:.2f} tok/s; equal tokens {equal} of "
        f"{REQUESTS * ENCDEC_SERVE_NEW} (differences at near ties only: "
        f"{[(d['request'], d['step']) for d in diffs]}); matmul launches "
        f"{rec['bf16']['launches']} "
        f"({by_pos} by position), collective calls "
        f"{first.report.collective_ops}; x max|logit| against fp32, the "
        f"first decode step unsharded {step['unsharded_vs_fp32']:.3e}, "
        f"sharded {step['sharded_vs_fp32']:.3e}, the prefill unsharded "
        f"{prefill['unsharded_vs_fp32']:.3e}, sharded "
        f"{prefill['sharded_vs_fp32']:.3e} (limit the unsharded + "
        f"{LOGIT_TOL}); serve_shard forced {ledger[-1].choice} (predicted "
        f"{ledger[-1].predicted_s:.3e} s a step, measured "
        + ", ".join(f"{e.measured_s:.3e}" for e in measured)
        + f"), KV bytes a slot priced {kv} (the self-attention caches "
        f"{engine.scheduler.kv_bytes_per_slot}), auto at {SLOTS} slots "
        f"{auto.choice} (tp {auto_tp}) ({card})")
    rec["wall_s"] = time.perf_counter() - t0
    del plain, first, engine, params, params32, model, model32, st, st_tp
    del st32
    return rec, fails


def compress_mesh(card, mm) -> tuple:
    """Gradient compression on TRAIN_MESH_DP: tinyllama-1.1b at
    TRAIN_MESH_FP32_LAYERS layers, full width, fp32, COMPRESS_STEPS steps
    of make_train_step(ctx=) with compression on a batch of
    TRAIN_MESH_FP32_BATCH.  Before each step the sharded gradient of that
    step's state is compressed on the mesh (compress_gradients_mesh, the
    residual carried); joined back, it equals bit for bit the
    single-device compress_gradients of the joined gradient with its own
    residual carried, and so does the residual; the step's new residual
    equals the mesh compression's (the step ran it on the same gradient);
    wire_bytes_ratio equals the single-device one's; the loss is the
    unsharded compressed run's within TRAIN_MESH_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import unplace_tree
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import (compress_gradients,
                                               compress_gradients_mesh)
    from repro_torch.training import (TrainLoopConfig, init_train_state,
                                      make_grad_fn, make_train_step)
    from repro_torch.tree import leaves_with_paths

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), dtype="float32",
                              n_layers=TRAIN_MESH_FP32_LAYERS)
    model = build_model(cfg, "cuda")
    loop = TrainLoopConfig(optimizer=AdamWConfig(lr=TRAIN_MESH_LR,
                                                 eps=TRAIN_MESH_EPS),
                           warmup_steps=0, compression=True,
                           compression_keep_frac=COMPRESS_KEEP)
    ctx = train_mesh_ctx(TRAIN_MESH_DP)
    batch = train_mesh_batch(cfg, *TRAIN_MESH_FP32_BATCH, seed=5)
    placed, specs = placed_state(ctx, model, init_train_state(model, 0,
                                                              loop))
    pb = placed_batch(ctx, batch)
    grad_fn = make_grad_fn(model, ctx=ctx)
    step = make_train_step(model, loop, ctx=ctx, donate=True)
    fails, rows, plain_res = [], [], None
    col0 = ctx.mesh.collectives
    mm.LAUNCHES.reset()
    for i in range(COMPRESS_STEPS):
        params = [p["params"] for p in placed]
        res = [p["compress"] for p in placed]
        _, _, grads = grad_fn(params, pb)
        got, got_res, met = compress_gradients_mesh(
            ctx, grads, res, specs["params"], keep_frac=COMPRESS_KEEP)
        whole = unplace_tree(ctx.mesh, grads, specs["params"])
        want, plain_res, want_met = compress_gradients(
            whole, plain_res, keep_frac=COMPRESS_KEEP)
        out = dict(leaves_with_paths(unplace_tree(ctx.mesh, got,
                                                  specs["params"])))
        out_res = dict(leaves_with_paths(unplace_tree(
            ctx.mesh, [r.residual for r in got_res], specs["params"])))
        differ = [p for p, w in leaves_with_paths(want)
                  if not torch.equal(out[p], w)]
        differ_res = [p for p, w in leaves_with_paths(plain_res.residual)
                      if not torch.equal(out_res[p], w)]
        kept = sum(int((w != 0).sum()) for _, w in leaves_with_paths(want))
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        placed, m = step(placed, pb)
        torch.cuda.synchronize()
        t_step = (time.perf_counter() - t_step) * 1e3
        step_res = dict(leaves_with_paths(unplace_tree(
            ctx.mesh, [p["compress"].residual for p in placed],
            specs["params"])))
        step_differ = [p for p, r in out_res.items()
                       if not torch.equal(step_res[p], r)]
        row = dict(loss=float(m[0]["loss"]), step_ms=t_step,
                   ratio=m[0]["wire_bytes_ratio"],
                   plain_ratio=want_met["wire_bytes_ratio"],
                   mesh_ratio=met[0]["wire_bytes_ratio"],
                   differ=differ, differ_residual=differ_res,
                   step_differ=step_differ, kept=kept)
        rows.append(row)
        if differ or differ_res or step_differ or not (
                row["ratio"] == row["plain_ratio"] == row["mesh_ratio"]):
            fails.append(f"compression step {i}: {row}")
        del grads, got, got_res, whole, want, out, out_res, step_res
    torch.cuda.synchronize()
    launches = dict(matmul=mm.LAUNCHES.count, matmul_by_position=[
        mm.LAUNCHES.by_stream.get(s.cuda_stream, 0)
        for s in ctx.mesh.streams])
    collectives = ctx.mesh.collectives - col0
    # one uncompressed sharded step from the same state, for its wall
    bare = make_train_step(model, dataclasses.replace(loop, compression=False),
                           ctx=ctx)
    torch.cuda.synchronize()
    t_bare = time.perf_counter()
    bare(placed, pb)
    torch.cuda.synchronize()
    t_bare = (time.perf_counter() - t_bare) * 1e3
    if min(launches["matmul_by_position"]) <= 0:
        fails.append(f"compression: a position launched no matmul "
                     f"{launches}")
    # the unsharded compressed run from the same state and batch
    state = init_train_state(model, 0, loop)
    ustep = make_train_step(model, loop, donate=True)
    ulosses = []
    for _ in range(COMPRESS_STEPS):
        state, um = ustep(state, batch)
        ulosses.append(float(um["loss"]))
    losses = [r["loss"] for r in rows]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ulosses))
    if not rel <= TRAIN_MESH_TOL:
        fails.append(f"compression: sharded losses {losses} against the "
                     f"unsharded {ulosses} (rel {rel:.2e}, limit "
                     f"{TRAIN_MESH_TOL})")
    wall = time.perf_counter() - t0
    log("encdec-mesh", f"compression: tinyllama-1.1b fp32 "
        f"{cfg.n_layers} layers, keep_frac {COMPRESS_KEEP}, "
        f"{COMPRESS_STEPS} steps on {TRAIN_MESH_DP}: the mesh compression "
        f"of the sharded gradient joined back against compress_gradients of "
        f"the joined gradient, leaves differing (values, residual, the "
        f"step's residual) "
        f"{[(len(r['differ']), len(r['differ_residual']), len(r['step_differ'])) for r in rows]}"
        f"; entries kept {[r['kept'] for r in rows]}; wire_bytes_ratio "
        f"{rows[0]['ratio']} (single device {rows[0]['plain_ratio']}); "
        f"losses {losses}, unsharded {ulosses} (rel {rel:.2e}); compressed "
        f"step walls {[round(r['step_ms'], 1) for r in rows]} ms, one "
        f"uncompressed sharded step {t_bare:.1f} ms; matmul launches (the "
        f"gradients and the steps) {launches}; collective calls "
        f"{collectives}; {wall:.1f} s ({card})")
    del placed, state, model
    return dict(steps=rows, unsharded_losses=ulosses, loss_rel=rel,
                launches=launches, collectives=collectives,
                uncompressed_step_ms=t_bare, wall_s=wall), fails


def encdec_mesh_phase(card):
    """Phase 26: seamless-m4t-medium on 8 positions of the one card
    (shards_per_device, a CUDA stream a position) and gradient compression
    under a mesh context.  (a) fp32 at TRAIN_MESH_FP32_LAYERS + as many
    layers on TRAIN_MESH_DP against the unsharded card (train_mesh_fp32);
    (b) bf16 whole on TRAIN_MESH_DP, TRAIN_MESH_STEPS steps of
    TRAIN_MESH_BATCH (frames of as many rows), every signature of the
    first sharded step held against its plain version (train_mesh_bf16),
    then the products of a position's ENCDEC_VOCAB_BLOCK-row vocab block
    timed (vocab_block_products); (c) served on ENCDEC_SERVE_MESH
    (encdec_serve_mesh); (d) compression (compress_mesh).  None on any
    failure."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref

    t_phase = time.perf_counter()
    out: dict = {"card": card}
    fails = []
    laps = {}

    def lap(name):
        laps[name] = time.perf_counter() - sum(laps.values()) - t_phase
        gc.collect()
        torch.cuda.empty_cache()

    out["fp32"], f = train_mesh_fp32(ENCDEC, TRAIN_MESH_DP, (8.0,), card, mm,
                                     fa)
    fails += f
    lap("a")
    checks = StepChecks(ops, fa, ref)
    out["bf16"], f = train_mesh_bf16(ENCDEC, None, TRAIN_MESH_DP, card, mm,
                                     fa, checks=checks,
                                     seeds=ENCDEC_MESH_LOSS_SEEDS)
    fails += f
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    out["vocab_block"] = vocab_block_products(checks, ENCDEC_VOCAB_BLOCK,
                                              ops, ref, flush)
    del flush, checks
    for r in out["vocab_block"]:
        log("encdec-mesh", f"vocab block product {r['call']}: {r['ms']:.2f} "
            f"ms ({r['tflops']:.1f} TFLOP/s, path {r['path']}, operands "
            f"copied {r['copied_operands']}), plain {r['plain_ms']:.2f}, "
            f"torch.matmul fp32 {r['library_ms']:.2f}, bound "
            f"{r['bound_ms']:.3f} ({r['bound_by']}) ({card})")
    if not any(r["copied_operands"] for r in out["vocab_block"]):
        fails.append(f"no product of the {ENCDEC_VOCAB_BLOCK}-row vocab "
                     f"block found, or none on the copy loader: "
                     f"{out['vocab_block']}")
    lap("b")
    out["serve"], f = encdec_serve_mesh(card, mm, fa)
    fails += f
    lap("c")
    out["compression"], f = compress_mesh(card, mm)
    fails += f
    lap("d")
    out["parts_s"] = laps
    out["wall_s"] = time.perf_counter() - t_phase
    out["fails"] = fails
    for f in fails:
        log("encdec-mesh", f"FAIL {f}")
    log("encdec-mesh", f"phase 26 wall {out['wall_s']:.1f} s (parts "
        + ", ".join(f"{k} {v:.1f}" for k, v in laps.items())
        + f"); {len(fails)} failures ({card})")
    return None if fails else out


# ---------------------------------------------------------------------------
# Phase 27: the dry run held against the card
# ---------------------------------------------------------------------------

# what phases 9 and 25 keep of the steps phase 27's dry run traces again:
# "train" (phase 9's second fixed-batch step of full-width tinyllama-1.1b)
# and "train_mesh" (phase 25's second sharded bf16 tinyllama-1.1b step on
# TRAIN_MESH_DP)
DRYRUN_CAPTURE: dict = {}
DRYRUN_PEAK_TOL = 0.10  # the predicted peak within 10 % of the card's
DRYRUN_BUDGET_S = 40.0  # the phase's budget (logged when passed)
DRYRUN_CELL = ("tinyllama-1.1b", "decode_32k")  # on the 512-position mesh


def storage_bytes(*trees) -> int:
    """Bytes of the distinct storages held by the tensors in ``trees``
    (dicts, lists and tuples walked)."""
    seen, total, stack = set(), 0, list(trees)
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif torch.is_tensor(x):
            st = x.untyped_storage()
            key = (x.device, st.data_ptr(), st.nbytes())
            if key not in seen:
                seen.add(key)
                total += st.nbytes()
    return total


def launch_counters() -> tuple:
    """Every kernel wrapper's launch counters, as they stand."""
    from repro_torch.kernels import bitonic_sort
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import wkv as wkv_k

    return (mm.LAUNCHES.count, dict(mm.LAUNCHES.by_path),
            fa.LAUNCHES.forward, fa.LAUNCHES.backward, fa.LAUNCHES.grids,
            wkv_k.LAUNCHES.forward, wkv_k.LAUNCHES.backward,
            dict(wkv_k.LAUNCHES.cuda), bitonic_sort.LAUNCHES.count,
            bitonic_sort.LAUNCHES.grids)


def dryrun_held(label, cap, tr, device, model_flops, hw, card,
                on_mesh: bool) -> tuple:
    """Hold a dry run's trace ``tr`` of a step against what the card kept
    of the same step (``cap``): the kernel calls by kernel, path and mode
    (by position on a mesh) and the collectives exactly, the peak within
    DRYRUN_PEAK_TOL; the roofline terms of the trace against the step's
    wall, printed and not gated.  Returns (record, failures)."""
    from repro_torch.roofline import RooflineTerms

    fails = []
    got = tr.calls.counts(by_position=on_mesh)
    if got != cap["calls"]:
        fails.append(f"{label}: the dry run's kernel calls {got} are not "
                     f"the card's {cap['calls']}")
    # the card's peak over the step, less what the process held besides
    # the step's arguments
    other = cap["base"] - cap["args"]
    measured = cap["peak"] - other
    predicted = tr.counter.peak.get(device, 0)
    rel = abs(predicted - measured) / measured
    if rel > DRYRUN_PEAK_TOL:
        fails.append(f"{label}: predicted peak {predicted / 1e9:.3f} GB, the "
                     f"card's {measured / 1e9:.3f} GB ({rel:.1%} off)")
    rec = dict(calls=sum(sum(c.values()) if on_mesh else c
                         for c in got.values()),
               predicted_peak=predicted, measured_peak=measured,
               peak_rel_err=rel, predicted_args=tr.counter.arguments.get(
                   device, 0), card_args=cap["args"], other=other,
               trace_s=tr.wall_s, step_ms=cap["wall_ms"])
    if on_mesh:
        want = (cap["collectives"], cap["collective_bytes"])
        have = (tr.collectives, tr.collective_bytes)
        if have != want:
            fails.append(f"{label}: the dry run's collectives {have} are not "
                         f"the card's {want}")
        rec.update(collectives=tr.collectives,
                   collective_bytes=tr.collective_bytes)
    terms = RooflineTerms(
        flops=tr.flops, hbm_bytes=tr.bytes, hbm_bytes_min=tr.bytes_min,
        collective_bytes=sum(tr.collective_bytes.values()), chips=1,
        model_flops=model_flops, hw=hw, label=label).as_dict()
    rec["roofline"] = terms
    log("dryrun", f"{label}: {rec['calls']} kernel calls "
        f"{'equal' if got == cap['calls'] else 'UNEQUAL'} to the card's"
        + (f" on every position, {tr.collectives} collectives and "
           f"{tr.collective_bytes} bytes by kind "
           f"{'equal' if not fails else 'checked'}" if on_mesh else "")
        + f"; peak predicted {predicted / 1e9:.3f} GB, the card's "
        f"{measured / 1e9:.3f} GB ({rel:.1%}; the process held "
        f"{other / 1e9:.3f} GB besides the step's {cap['args'] / 1e9:.3f} GB "
        f"of arguments, predicted {rec['predicted_args'] / 1e9:.3f} GB); "
        f"traced in {tr.wall_s:.1f} s; roofline ({hw.name}): compute "
        f"{terms['t_compute_s'] * 1e3:.1f} ms, memory "
        f"{terms['t_memory_s'] * 1e3:.1f} ms (upper "
        f"{terms['t_memory_upper_s'] * 1e3:.1f} ms), collective "
        f"{terms['t_collective_s'] * 1e3:.2f} ms, bound {terms['bound']}, "
        f"against the step's wall {cap['wall_ms']:.1f} ms ({card})")
    return rec, fails


def dryrun_phase(card):
    """Phase 27: the dry run (``launch/dryrun.py``) against the card.
    (a) phase 9's full-width tinyllama-1.1b bf16 training step at 2 x
    2048 traced again on meta tensors: the kernel calls by kernel, path
    and mode equal the card's launches, exactly, and the predicted peak
    within DRYRUN_PEAK_TOL of max_memory_allocated over that step; (b)
    phase 25's sharded bf16 step on TRAIN_MESH_DP's 8 positions: the calls
    on each position equal, the collectives' calls and bytes by kind
    equal, the peak within DRYRUN_PEAK_TOL; (c) the roofline terms of both
    with the runtime's hardware spec beside the steps' walls (printed);
    (d) the production cell DRYRUN_CELL on 512 meta positions: status ok,
    512 chips, the card's allocated memory and every kernel's launch
    counters unchanged across it, its wall printed.  The phase's wall
    against DRYRUN_BUDGET_S is logged.  None on any failure."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import make_mesh
    from repro_torch.distributed.sharding import (ShardingCtx,
                                                  batch_sharding,
                                                  param_shardings,
                                                  place_shapes)
    from repro_torch.launch.dryrun import dryrun_cell, trace
    from repro_torch.models import build_model
    from repro_torch.roofline import model_flops_for
    from repro_torch.configs import ShapeSpec
    from repro_torch.runtime import Runtime
    from repro_torch.training.step import make_train_step, train_state_shapes

    t0 = time.perf_counter()
    rt = Runtime(device="cuda")
    out, fails = {"card": card}, []

    # (a) phase 9's step on one position
    cap = DRYRUN_CAPTURE.get("train")
    if cap is None:
        fails.append("(a): phase 9 kept no step")
    else:
        cfg = get_config(cap["arch"])
        model = build_model(cfg, "meta")
        state = train_state_shapes(model, cap["loop"])
        batch = {"tokens": torch.empty((cap["batch"], cap["seq"]),
                                       dtype=torch.int64, device="meta")}
        step = make_train_step(model, cap["loop"], donate=True)
        tr = trace(lambda: step(state, batch), [(state, batch)], [None],
                   grad=True)
        mf = model_flops_for(cfg, ShapeSpec("p9", cap["seq"], cap["batch"],
                                            "train"))
        out["train"], f = dryrun_held(
            f"(a) {cap['arch']} train {cap['batch']} x {cap['seq']}", cap,
            tr, None, mf, rt.hw, card, on_mesh=False)
        fails += f
        del tr, state, step
    # (b) phase 25's sharded step on 8 positions of the card
    cap = DRYRUN_CAPTURE.get("train_mesh")
    if cap is None:
        fails.append("(b): phase 25 kept no step")
    else:
        cfg = dataclasses.replace(get_config(cap["arch"]),
                                  n_layers=cap["layers"])
        model = build_model(cfg, "meta")
        mesh = make_mesh(cap["mesh"], device="meta")
        ctx = ShardingCtx(mesh=mesh, data_axes=cap["data_axes"],
                          attn_chunk=cap["attn_chunk"],
                          rnn_chunk=cap["rnn_chunk"],
                          moe_capacity_factor=cap["moe_capacity_factor"])
        state = train_state_shapes(model, cap["loop"])
        states = place_shapes(mesh, state, param_shardings(
            state, mesh, data_axes=ctx.data_axes, cfg=cfg))
        b, s = cap["batch"]
        batch = {"tokens": torch.empty((b, s), dtype=torch.int64,
                                       device="meta")}
        feed = place_shapes(mesh, batch, batch_sharding(batch, mesh,
                                                        ctx.data_axes))
        step = make_train_step(model, cap["loop"], ctx=ctx, donate=True)
        n = mesh.size
        # the 8 positions share the one card: their bytes add on it
        tr = trace(lambda: step(states, feed),
                   [(states[i], feed[i]) for i in range(n)], range(n),
                   mesh=mesh, grad=True, device_of=lambda p: 0)
        mf = model_flops_for(cfg, ShapeSpec("p25", s, b, "train"))
        out["train_mesh"], f = dryrun_held(
            f"(b) {cap['arch']} train {b} x {s} on {cap['mesh']}", cap, tr,
            0, mf, rt.hw, card, on_mesh=True)
        fails += f
        del tr, states, feed, step
    # (d) a production cell on the card's host: nothing reaches the card
    torch.cuda.synchronize()
    mem0, launches0 = torch.cuda.memory_allocated(), launch_counters()
    t1 = time.perf_counter()
    rec = dryrun_cell(*DRYRUN_CELL, multi_pod=True, probe=False,
                      verbose=False, runtime=rt)
    cell_s = time.perf_counter() - t1
    torch.cuda.synchronize()
    mem1, launches1 = torch.cuda.memory_allocated(), launch_counters()
    out["cell"] = dict(cell=rec["cell"], status=rec["status"],
                       chips=rec["chips"], wall_s=cell_s,
                       memory_analysis=rec["memory_analysis"],
                       kernel_calls=rec["kernel_calls"],
                       collective_bytes=rec["collective_bytes"],
                       card_memory=(mem0, mem1))
    if rec["status"] != "ok" or rec["chips"] != 512 or mem1 != mem0 \
            or launches1 != launches0:
        fails.append(f"(d) {rec['cell']}: status {rec['status']}, chips "
                     f"{rec['chips']}, card memory {mem0} -> {mem1}, "
                     f"launch counters changed {launches1 != launches0}")
    mem = rec["memory_analysis"]
    log("dryrun", f"(d) {rec['cell']}: {rec['status']} on {rec['chips']} "
        f"meta positions in {cell_s:.1f} s on the card's host; a position "
        f"holds {mem['argument_bytes'] / 1e9:.3f} GB of arguments, peak "
        f"{mem['peak_bytes'] / 1e9:.3f} GB; the card's allocated bytes "
        f"{mem0} before and {mem1} after, launch counters "
        f"{'unchanged' if launches1 == launches0 else 'CHANGED'} ({card})")
    out["wall_s"] = time.perf_counter() - t0
    out["over_budget"] = out["wall_s"] > DRYRUN_BUDGET_S
    if out["over_budget"]:
        # recorded, not gated: the production cell's trace is the host's
        # work at about 20 us a dispatched op, 2.3 million of them
        log("dryrun", f"phase 27 took {out['wall_s']:.1f} s, past its "
            f"{DRYRUN_BUDGET_S:.0f} s budget (the production cell "
            f"{cell_s:.1f} s)")
    out["fails"] = fails
    for f in fails:
        log("dryrun", f"FAIL {f}")
    log("dryrun", f"phase 27 wall {out['wall_s']:.1f} s (the production "
        f"cell {cell_s:.1f} s); {len(fails)} failures ({card})")
    return None if fails else out


if __name__ == "__main__":
    # torch is imported here, not with the module: the front end's spawned
    # workers (phase 17) re-import this file, and need none of it
    import torch

    sys.exit(main())
