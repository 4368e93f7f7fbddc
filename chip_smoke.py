#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit::

    python3 chip_smoke.py

Phases — any failure exits non-zero:

1. device: the card's name, ``nvidia-smi`` name and power limit, torch
   and CUDA versions;
2. build: every kernel of ``paddle_tpu_torch/csrc`` with nvcc (one
   process per source, all at once), with the build seconds, the
   compiler's register/shared-memory/spill report, and each kernel's
   count of tensor-core instructions in its SASS (``cuobjdump``) — no
   ``HMMA`` in an ``mma.sync`` kernel (``_mma``, ``_f32mma``) or no
   ``HGMMA`` in a warpgroup kernel (``_d256_wgmma``, ``_d128_wgmma``,
   ``_d64_wgmma``) fails the run;
3. kernels: K1 (the flash-attention forward) and K2/K3 (its backward,
   dQ and dK/dV) against their plain torch versions on the same inputs,
   on both routes — bf16/fp16 through the 16-bit tensor-core kernels
   (``csrc/flash_fwd_mma.cu``, ``csrc/flash_bwd_dq_mma.cu``,
   ``csrc/flash_bwd_dkv_mma.cu``; at D = 128 K1, K2 and K3 on their
   warpgroup kernels ``csrc/flash_fwd_d128_wgmma.cu``,
   ``csrc/flash_bwd_dq_d128_wgmma.cu`` and
   ``csrc/flash_bwd_dkv_d128_wgmma.cu``), float32 through the split-operand
   tensor-core kernels (``csrc/flash_fwd_f32mma.cu``,
   ``csrc/flash_bwd_dq_f32mma.cu``, ``csrc/flash_bwd_dkv_f32mma.cu``; at
   D = 64 K1, K2 and K3 on their warpgroup kernels
   ``csrc/flash_fwd_f32_d64_wgmma.cu``,
   ``csrc/flash_bwd_dq_f32_d64_wgmma.cu`` and
   ``csrc/flash_bwd_dkv_f32_d64_wgmma.cu``, K1 and K2 sized for two
   blocks an SM, which the card's occupancy count must confirm; at
   D = 128 K1, K2 and K3 on theirs, ``csrc/flash_fwd_f32_d128_wgmma.cu``,
   two blocks an SM, ``csrc/flash_bwd_dq_f32_d128_wgmma.cu`` and
   ``csrc/flash_bwd_dkv_f32_d128_wgmma.cu``) —
   at the serving and training shapes and the edge cases (causal and
   not, tq != tk with fully masked rows, ragged T, D = 64, in f32, bf16
   and fp16), each case asserting which variant launched, with dQ, dK
   and dV each checked on its own, in a tier set by the output's type
   and scale; at the training shape, grid and tile-loop faults planted
   in copies of the outputs, at the tiles of the kernels that ran, must
   fail that tier, as must two faults of each float32 kernel at its own
   tile at the f32 serving shape, ``f32 causal`` and Transformer-base's
   self-attention (D = 64), in the float32 tier; every kernel in bf16
   and float32 at B*H = 65536 (past gridDim.y's 65535, launched in
   chunks; float32 K1-K3 on their D = 64 warpgroup kernels), and at
   D = 128 in bf16 and fp16 (K1, K2 and K3 on their warpgroup kernels)
   and float32 (K1 and K2 on theirs); ``attention_with_lse``'s
   gradient through both outputs against plain autograd of
   ``ref_attention_lse``; each kernel timed beside its plain version,
   its bound and ``scaled_dot_product_attention`` forward or backward (a
   yardstick only — the port never calls it), the float32 ones also at
   B*H = 2 x 32, T = 2048, and each warpgroup kernel beside the mma.sync
   kernel it replaced on the same inputs;
4. serve: the Llama-3-8B-width forward program, all 32 layers (random
   weights from SEED) behind the port's ``ServingEngine``: warmup over the
   buckets, concurrent requests, each answer held against the same
   request run alone through ``Executor.run``, no step build after
   warmup, and K1 launched once per layer per dispatch — in bfloat16
   (every launch ``flash_fwd_d128_wgmma``), then in float32 (every launch
   ``flash_fwd_f32_d128_wgmma``), where answers match the lone runs logit for
   logit; one (4 x 256) dispatch's device time by kind in each dtype;
5. train: the Llama-3-8B-width model cut to 8 layers, bf16, through
   ``build_llama(targets)`` → ``Adam.minimize`` → ``Executor.run`` on one
   fixed batch of 2 x 2048 tokens: 2 warmup and 8 timed steps with
   finite, falling loss, K1/K2/K3 each launched once per layer per step
   (every time on the tensor cores),
   step time, tokens/s, peak memory and one step's device time by kind
   (the main path of slices 2 to 4);
6. train_stack (the main path of this slice, whose launches the kernel
   line reports): the reference's own train benchmark (``bench.py``
   ``transformer_main``) at ``phase_train``'s width, depth, batch and
   steps — ``build_llama(shard_pp=True, fused_head_chunk=2048,
   remat=True)``: the layer-stacked decoder, each layer recomputed in
   the backward pass (K1 twice a layer a step, K2/K3 once), and the
   vocab-chunked fused loss, which never builds the logits; the checks
   of 5, and peak memory below 5's, with both steps' times, tokens/s,
   peak memory and device time by kind side by side;
7. train parity: a narrow float32 model (head dim 128, TF32 off) whose
   step on the card (the kernels: ``flash_fwd_f32_d128_wgmma``,
   ``flash_bwd_dq_f32_d128_wgmma``, ``flash_bwd_dkv_f32_d128_wgmma``) matches
   the same step on the CPU (the plain versions): loss and every
   parameter's
   gradient, then 3 Adam steps' losses; then the same model built as 6
   builds its own (stacked, remat, a fused loss whose last chunk slides
   back), held to the CPU the same way, and its step with remat off and
   under ``memory_optimize`` (``nothing_saveable``, ``dots_saveable``)
   equal to the step with remat on;
8. amp: the 8B width cut to 4 layers with float32 master state,
   unrolled and stacked, under ``amp_transpile`` O1 and O2: 3 Adam steps
   with finite, falling losses, every attention launch on the bf16
   kernels, the state still float32, and the first loss near the same
   program's without AMP;
9. nan guard: on 7's stacked model, the guarded step equals the
   unguarded one, an inf planted in ``blocks.wq`` raises
   FloatingPointError naming the op outputs the CPU names, and
   ``repeats=2`` raises ValueError;
10. plain route: ``LLAMA_TINY`` (head dim 16, off the reference's
   D % 128 == 0 gate) trains one step and 3 Adam steps and serves
   requests through ``ServingEngine`` on the card, matching the same
   runs on the CPU; its attention runs the plain versions, as the
   reference's gate sends that shape to its own, counted as
   ``launches_by_kernel["plain"]``, with no kernel launched;
11. transformer (the Transformer main path): ``TRANSFORMER_BASE``
   (models/transformer.py: d_model 512, 8 heads of 64, 6 + 6 layers,
   vocab 10000, dropout 0.1, label smoothing 0.1) in float32 at full
   width and depth through ``Executor.run``, 32 x 256 source and target
   tokens with lengths drawn from SEED, ``noam_decay(512, 4000)``
   feeding ``Adam(beta1=0.9, beta2=0.98, epsilon=1e-9)``: 2 warmup and 8
   timed steps with finite losses, the first near ln V + d/(d + V), the
   last below the first, every fetched rate equal to its closed form,
   K1/K2/K3 6 launches a step (the causal decoder self-attention) on the
   float32 kernels of head dim 64 (their warpgroup kernels
   ``flash_fwd_f32_d64_wgmma``, ``flash_bwd_dq_f32_d64_wgmma`` and
   ``flash_bwd_dkv_f32_d64_wgmma``); step time, tokens/s, peak memory
   and one step's
   device time by kind;
12. transformer_infer: ``clone(for_test=True)`` of the labels-free
   program on 11's trained scope, logits equal to the CPU's within the
   f32 serving tier and moved by the 1 - p dropout scaling;
13. transformer_unpadded: the same model going on from 11's scope with
   no lengths, 256 source and 128 target tokens, every attention on the
   kernels (18 launches a step each, cross-attention tq 128 != tk 256);
14. transformer_parity: the base width at 2 + 2 layers, dropout 0, its
   step on the card equal to the CPU's (loss and every gradient, then 3
   noam + Adam losses, the rates and the LR counter);
15. dropout: the rule on the card over 32 x 256 x 512 values, kept share
   within 5 sigma of 1 - p, replayed for one seed and step, both
   scalings;
16. transformer_serve (the main path of ROADMAP item 2, run right after
   11 on its trained scope): ``clone(for_test=True)`` of the labels-free
   padded model behind ``ServingEngine`` with its default optimize
   (fold + fuse + cse + dce on a clone, folding on the card), buckets
   (1, 2, 4, 8), 32 concurrent single-pair requests padded to 256 tokens
   with lengths: the optimize report equal to the reference's (26
   fused), every answer within the f32 serving tier of the same request
   run alone through the unoptimized program, one 8 x 256 batch through
   the optimized and the unoptimized program bit-identical, K1 6
   launches a dispatch on ``flash_fwd_f32_d64_wgmma`` and K2/K3 none, no step
   build after warmup; then requests/s and p50/p99 under sustained
   load (32 closed-loop clients, three 3 s windows), that dispatch's
   device time by kind and idle share, its host wall optimized against
   unoptimized in 25 alternating pairs, and the construction's optimize
   (the engine's own ``optimize_ms``) and verify (cheap and full) wall
   times;
17. transformer_optimized: 11's steps again from the same initial state
   under ``PADDLE_TPU_OPTIMIZE=1`` and ``validate="strict"``: the ten
   losses and every persistable after the run bit for bit equal to 11's,
   K1/K2/K3 6 launches a step; the step-time median beside 11's.
18. io_train_resume (ROADMAP item 3, path A): 11's model at 3 layers a
   side, its batch and recipe trained by ``Trainer`` for 6 steps in
   epochs of 2, every batch
   new, written once with ``batcher.write_fixed`` and read through
   ``FixedBatcher`` -> ``DeviceLoader`` (pinned memory, copies on a side
   stream), a checkpoint an epoch; a second run killed by the
   ``torn_write`` fault in its second checkpoint, a third resumed from
   the newest valid one: its losses and every persistable bit for bit
   the uninterrupted run's (``torch.equal``; the checkpoint restores the
   step counter that seeds dropout), K1/K2/K3 3 launches a step on the
   float32 kernels; step time with and without ``DeviceLoader``, each
   with its device busy time and idle share;
19. io_saved_serve (the main path of item 3): 18's trained test clone
   through ``save_inference_model`` (buckets (1, 2, 4, 8) x 256, the
   embedded artifact store, a golden set of 8), then a fresh
   ``ServingEngine.from_saved_model(compile_store=True)``: warmup builds
   no step (4 store hits), 32 requests bit for bit an in-memory engine's answers, K1 on
   ``flash_fwd_f32_d64_wgmma`` (3 a dispatch), K2/K3 none, no build after
   warmup; ``Inferencer.from_inference_model`` and the golden set equal;
   ``CompiledPredictor`` (``__compiled__.pt2``) at batch 1 and 8 within
   the f32 serving tier, K1 launched through its ``torch.library``
   operator; the save, load, construction and warmup times with and
   without the store; K1's operator copies no input;
20. io_llama_saved (path B): ``LLAMA3_8B`` at full width cut to 1
   layer (from 2, for room) in bf16 saved and served back: every
   persistable's bits, 8
   requests across (1, 2, 4) x (128, 256) bit for bit the in-memory
   engine's, K1 on ``flash_fwd_d128_wgmma`` at D 128, ``CompiledPredictor``
   within the bf16 tier;
21. generate (ROADMAP item 4a, the main path of this slice): the 8B
   width at 4 layers (cut from 32, then 16 and 8, for room) in bf16,
   through ``build_llama_generator`` and ``Executor.run``: 4 prompts of
   128 tokens, 64 new tokens each, every
   generated token held against ``build_llama(shard_pp=True)``'s
   forward of the generated sequence on the same scope (K1 once a
   layer on ``flash_fwd_d128_wgmma``), a flip allowed only within twice the row's
   logit error; FirstProbs against that forward's softmax; the int8 KV
   cache and W8A8 (their int8 accumulators exact on the card against
   the CPU; FirstProbs' distance and token agreement reported);
   speculative decoding with the target as its draft (tokens equal
   greedy's under the same tier; acceptance, rounds); sampling
   (replayed for a seed and step, different across steps); float32 at
   4 layers, exact wherever the margin exceeds the f32 tier (K1 on
   ``flash_fwd_f32_d128_wgmma``); prefill and per-token decode ms at
   batch 1 and 4 beside the weights' read bound, speculative tokens/s, the
   device's busy share over a 16-token batch-4 generate;
22. head_dim_256 (the head-dim repair): the 8B width with 16 heads of
   256 and 4 kv heads at 2 layers through ``build_llama`` →
   ``Adam.minimize`` → ``Executor.run``: one bf16 train step at 2 x
   2048 (K1, K2 and K3 once a layer on their warpgroup kernels
   ``flash_fwd_d256_wgmma``, ``flash_bwd_dq_d256_wgmma`` and
   ``flash_bwd_dkv_d256_wgmma``), one ``ServingEngine`` dispatch of the
   trained scope (K1 on ``flash_fwd_d256_wgmma``), one float32 train
   step at 1 x 256 (K1, K2 and K3 on ``flash_fwd_f32_d256_wgmma``,
   ``flash_bwd_dq_f32_d256_wgmma`` and ``flash_bwd_dkv_f32_d256_wgmma``,
   none on the sliced ``_f32mma`` kernels); no launch on the plain
   route; first losses near ln V + dim·0.02²/2;
23. decode_engine (ROADMAP item 4b, the main path of this slice): the
   8B width at 4 of its 32 layers in bf16, behind ``DecodeEngine`` built with
   no place (the card): warmup, 24 requests of 40-256 prompt tokens and
   64 new from 8 concurrent clients, every request's tokens against the
   port's ``llama_generate`` of its prompt at batch 1 (a flip only where
   the K1 recompute puts the two tokens within twice the row's
   first-step logit error), no step build after warmup, the pools
   written in place on the card, every page back after the drain; TTFT
   p50/p99, decode ms a token a slot beside the weights' read bound,
   tokens/s, the device's idle share over a shorter wave, the page
   high-water mark; then chunked prefill (``chunk_size=128``), W8A8
   (``quantize=True`` against the quantized generator) and speculative
   mode (a 2-layer draft cut from the target, gamma 4) at max_batch 4,
   and float32 at 4 layers, exact past the f32 tier (the recompute's K1
   on ``flash_fwd_f32_d128_wgmma``).
24. resnet50_train (ROADMAP item 5, the main path of this slice): the
   reference's primary benchmark, ``bench.py``'s default configuration —
   ``resnet50`` at 3 x 224², 1000 classes, batch 128,
   ``Momentum(0.1, 0.9)``, ``amp_transpile(level="O2")`` — through
   ``Executor()`` with no place, in NHWC and in NCHW from one initial
   scope: 2 warmup steps, then timed steps through ``run(...,
   repeats=4)``: step ms, images/s, the share of the bf16 peak (3 x 4.09
   GFLOP an image over 989 TFLOP/s, bench.py:403-405), peak memory, one
   step's device time by kind (cuDNN convolutions, batch norm and the
   other elementwise ops, casts and clones by aten op, the Momentum
   segment) and idle share; the first losses finite, near ln 1000 and
   within the bf16 tier of each other; no activation-sized copy in the
   NHWC step; no attention launch. Its variants, each timed the same
   way: ``fuse_optimizer_ops`` (parameters bit-equal to the
   per-parameter run after 2 steps, deterministic cuDNN), ``memory_
   optimize`` ``recompute_norms`` and ``save_conv_only`` (losses within
   the bf16 tier, peaks beside the run without remat), and the
   ``"layout"`` pass over the NCHW program (the executed layout as
   bench.py:181 reads it, losses within the tier);
25. resnet50_serve: 24's trained scope, ``clone(for_test=True)`` →
   ``InferenceTranspiler().transpile`` → ``ServingEngine`` with no
   place, buckets (1, 8, 32), 64 single-image requests from 8
   closed-loop clients: no batch_norm left; the fold's logits against
   the unfolded program's (float32 with TF32 off and float64: the
   reference test's 1e-4 / 1e-5, normwise; bf16: the relative-RMS
   tier); a ``QuantizeTranspiler`` program within 0.05 relative max
   error; no step build after warmup; requests/s, p50/p99;
26. resnet_parity: ResNet-50 at full width, batch 2, TF32 off: one
   Momentum step on the card and on the CPU from one scope — in float32
   the loss and every moving statistic within 2e-3 / 2e-4 (the
   gradients' distance reported: ill-conditioned in float32), in
   float64 also the stem filter's gradient and every updated filter;
27. conv_zoo: the zoo's ``mnist``, ``vgg``, ``resnet`` and
   ``se_resnext`` take 3 float32 steps on the card and the CPU from one
   state; ``conv2d_transpose`` / ``conv3d_transpose`` with groups and
   dilation, ``conv3d``, ``pool3d``, ``ceil_mode`` pooling with padding,
   ``lrn``, both interpolations up and down, ``roi_pool`` with an empty
   bin and ``batch_norm`` card against CPU, outputs and gradients; the
   hand-derived ``batch_norm`` backward against
   ``PADDLE_TPU_BN_AUTODIFF=1`` on the card;
28. flowers_train (ROADMAP item 7d, the main path of this slice): 24's
   program with 102 classes, fed the way the reference benchmark feeds
   ``--data_set flowers`` (``dataset.flowers.train()``'s synthetic
   fallback → ``reader.shuffle`` → ``reader.batch`` → ``DataFeeder``):
   the first steps bit-equal to the same batches fed as tensors and read
   back from a ``recordio_writer`` file, then 8 steps reader-fed, 8
   under a ``profiler`` session (8 dispatch slices, the summary, a
   non-empty CUDA kernel profile) and 8 on one resident batch;
   ``compiled_memory_usage`` (its arguments exact), ``memory_usage``,
   ``program_cost`` beside ``compiled_stats`` and the step's peak;
   ``memory_optimize(policy="auto")`` picking the CPU's policy, its
   losses within rtol 2e-2 of no remat's; no attention launch;
29. mesh_llama_train, moe_train, moe_generate (ROADMAP item 6a): the 8B
   width through ``ParallelExecutor`` on the one card's mesh bit-equal
   to the plain Executor; the Mixtral width's MoE trained and
   generating (its float32 check's K1 on ``flash_fwd_f32_d128_wgmma``);
30. pipeline_llama_train (ROADMAP item 6b, the main path of this
   slice): the 8B width at 4 layers, bf16, 4 x 2048 tokens,
   ``build_llama(shard_pp=True)`` with the GPipe op and with
   ``pp_schedule="1f1b"`` from one startup scope, each through
   ``Executor.run`` and ``ParallelExecutor`` on a one-rank
   {"dp": 1, "pp": 1} mesh: the executors bit-equal (first step's loss
   and gradients, 3 timed steps, every persistable), the programs'
   first losses and gradients within the bf16 relative-RMS tier, K1
   twice and K2/K3 once a layer a step; step ms, launches, peak memory;
31. pipeline_schedule: ``gpipe`` and ``one_f_one_b`` on a one-rank 'pp'
   mesh, a 2-layer stage at the 8B width, 4 microbatches of 1 x 2048,
   bf16 (and float32 at 1 layer, T 512, TF32 off: K1, K2 and K3 on
   ``flash_fwd_f32_d128_wgmma``, ``flash_bwd_dq_f32_d128_wgmma`` and
   ``flash_bwd_dkv_f32_d128_wgmma``), against plain autograd of the
   sequential function: loss, stage and head gradients, dx;
32. ring_attention: the ring's step at the 8B attention width over 8
   chunks of T 16384 in bf16 against K1 (causal and not), a wrong-offset
   control that must fail, the float32 gradient over 4 chunks of T 8192
   against K1-K3, ``ring_attention_sharded`` on a one-rank 'sp' mesh;
   the ring's time and peak memory beside K1's;
33. deepfm_train (ROADMAP item 7a, a main path of this slice): DeepFM
   at ``bench.py`` ``ctr_main``'s knobs — 1,000,000 ids, 23 fields,
   embedding 16, hidden (400, 400), batch 4096, ``Adam(1e-3)``,
   ``is_sparse=True`` (its F13 warning caught and checked) — in float32
   through ``Executor()``: 2 warmup and 20 timed steps on one batch of
   the planted rule (losses finite and falling), step ms, examples/s,
   peak memory, one step's device time by kind (the embedding gather,
   its backward, matrix products, the Adam segment) and idle share;
   wide&deep at the same vocab for 3 steps; the first step at vocab
   10,000 on the card equal to the CPU's (loss and every gradient within
   2e-3 / 2e-4, TF32 off); no attention launch;
34. stacked_lstm_train (a main path of this slice): ``bench.py``
   ``seq_main``'s stacked dynamic LSTM (vocab 10,000, emb 128, hid_dim
   512: three LSTMs of hidden 128 with peepholes, the middle reversed),
   batch 32 x 64 tokens, ``Adam(1e-3)``: 2 warmup and 10 timed steps on
   bench.py's all-64 feed (words/s, step ms, launches a step, idle
   share), a variable-length feed (9-64, bucket 8) for 4 steps (finite,
   falling), its first step on the card equal to the CPU's (loss and
   every gradient, TF32 off); no attention launch;
35. seq_zoo: the recommender at MovieLens's table sizes, batch 256 (1-6
   categories and 2-15 title words a movie, fed through ``DataFeeder``
   and through ``create_lod_tensor``, the two feeds equal) and word2vec
   (embed 32, hidden 256, dict 2073, batch 32): each first step on the
   card equal to the CPU's, 3 finite steps; the recommender's inference
   program exported through ``save_inference_model`` (sequence axes
   symbolic) and served by ``CompiledPredictor`` at padded title
   lengths 16 and 8, each within the f32 serving tier of the executor's
   test-mode run; no attention launch;
36. seq2seq_train (ROADMAP item 7b, the main path of this slice):
   ``bench.py`` ``seq_main``'s seq2seq-attention model
   (``seq_to_seq_net``: vocab 10,000 on both sides, width 512, a
   bidirectional GRU encoder and a DynamicRNN decoder, the ``scan`` op),
   batch 32 x 64 words, ``Adam(1e-3)``, float32 and TF32 off: its first
   step on the card equal to the CPU's (loss and every gradient within
   2e-3 / 2e-4), 2 warmup and 10 timed steps on bench.py's all-64 feed
   (words/s, step ms, launches a step, busy ms, idle share, device ms
   by kind, peak memory), 4 steps at lengths 9-64; losses falling;
37. seq2seq_decode: ``greedy_decode`` (a StaticRNN feeding back the
   argmax, 64 steps) and contrib's ``BeamSearchDecoder`` (beam 4) at
   that width, each against the CPU's from the same weights by the flip
   rule (tokens equal up to a first step where the CPU's logits, from
   the greedy decoder's teacher-forced probe, or beam scores tie within
   the card's error), ms and launches per decoded step;
38. srl_crf_train: ``db_lstm`` at the book's widths (word_dim 32,
   mark_dim 5, hidden 512, depth 8) over CoNLL-05's dictionaries (44,068
   words, 3,162 predicates, 59 tags), batch 10 of lengths 10-60,
   ``linear_chain_crf`` with SGD(0.01): the first step against the CPU,
   the trained scope's Viterbi tags equal to the CPU's (a differing row
   only where the CPU scores the card's path within the tier of its
   best) and ``chunk_eval`` over them;
39. ocr_ctc_train: ``ctc_train_net`` at its defaults on 1 x 48 x 512
   images, 95 classes, batch 32, labels of 5-20 tokens: the first step
   against the CPU, greedy CTC tokens equal to the CPU's (a frame's
   argmax may flip only within twice the row's score error);
40. control_flow: a bounded and two unbounded Whiles (one whose limit is
   fed), IfElse, Switch, the tensor arrays and the bounded While's
   gradient, card against CPU; 36-40 each with no attention launch;
41. faster_rcnn_train (ROADMAP item 7c, the main path of this slice):
   ``build_faster_rcnn`` at ``FasterRCNNConfig()``'s full width on 2
   images of 3 x 600 x 800 (Faster R-CNN's training scale, Fast R-CNN's
   two images a minibatch) with 1-6 ground-truth boxes each,
   ``Momentum(1e-3, 0.9)``, float32 and TF32 off: the first step on the
   card against the CPU — the sampled anchors' labels and targets and
   the sampled RoIs and labels equal (a candidate within float error of
   a sampler's threshold may flip, and is printed), then the loss and
   every gradient within 2e-3 / 2e-4 — 2 warmup and 10 timed steps
   (step ms, images/s, launches a step, busy ms, idle share, device ms
   by kind, peak memory), the inference program's RoIs, class
   probabilities and box regressions against the CPU's;
42. ssd_train: ``multi_box_head`` over SSD300's six maps (fed as data,
   512/1024/512/256/256/256 channels at 38/19/10/5/3/1), 21 classes,
   8,732 priors (asserted), ``ssd_loss`` into Momentum: the first step
   at batch 8 against the CPU, 5 timed steps at batch 32;
   ``detection_output`` (nms 0.45, top 400, keep 200, score 0.01) timed
   at batch 32; at batch 8 its NMS rows against the CPU's (a row may
   differ only between scores tied within the tier), the NMS rule on the
   CPU's own inputs on the card equal to the CPU's rows exactly, and
   ``detection_map`` (11point) with ``evaluator.DetectionMAP`` over two
   batches equal to the CPU's;
43. detection_extras: every op of the extras family, ``hierarchical_sigmoid``
   and ``nce`` (equal table rows) against the CPU at small shapes
   (integers exactly, gradients through one cotangent), and a
   WeightNormParamAttr fc step, an hsigmoid step and an nce step;
   41-43 each with no attention launch;
44. mesh_two_ranks: whether the one card admits two NCCL ranks (it is
   expected to refuse them: recorded, not gated).
45. cluster_serve (ROADMAP item 8, the main path of this slice; run
   right after 4's bf16 serve, on its scope): ``cluster.serve_cluster(
   factory, replicas=2, warmup=True)``, the factory building
   ``ServingEngine``s over 4's bf16 scope and buckets (the weights held
   once: the idle pool under half their bytes above the card before it,
   the peak under the weights and two of 4's engine transients); 4's 8
   requests concurrently,
   each answer held to the request alone at 4's bf16 tier, both
   replicas serving, K1 32 launches a dispatch summed over both, all
   flash_fwd_d128_wgmma, K2/K3 none, no step build after warmup; then under
   in-flight traffic a ``rolling_restart()`` and the
   ``serving_replica_crash`` drill: no request lost, the replica
   revived. p50/p99 through the pool beside the lone engine's, the
   restart and failover windows;
46. cluster_remote (run inside 19, on its saved directory): two
   ``python -m paddle_tpu_torch.cluster.net_worker`` processes on the
   card behind ``Inferencer.from_inference_model(D).serve(remotes=)``
   and one ``ProcessReplica``: each request alone bit-equal to a lone
   in-process engine's (K1 f32 at D 64, launches held exact);
   ``provision_from_remote`` copies D with every sha256 equal; a server
   ``kill -9``ed under load, nothing lost; a ``DeploymentManager``
   promotes a canary equal to v1 and rolls back one with perturbed
   weights on the golden-set gate, nothing lost; the RPC overhead;
47. cluster_decode (run inside 23, on its scope and requests):
   ``Inferencer(infer_func, param_path).serve_decode(cfg, replicas=2)``
   over 23's weights, one prefill and one decode replica,
   ``Router.generate`` of 23's requests: the lone engine's tokens, one
   handoff exported and imported per request, no attention kernel;
48. train_fabric: a ``TrainCoordinator`` over ``python -m
   paddle_tpu_torch.cluster.train_worker`` processes on the card
   (``ProgramGradTask``, 12 steps, commits every 4): the two-worker
   run's parameter sha equal in a one-worker run, a run whose worker
   dies at step 6 and is replaced by one provisioned over the wire, and
   a coordinator crash resumed by a new coordinator; the parameters
   within 2e-3 / 2e-4 of the CPU's. Every worker process is killed
   before the script ends.
49. serving_chaos (run right after 45, on 4's bf16 scope, 32 layers,
   buckets (1, 2, 4) x (128, 256); its decode part right after 47, on
   23's weights): one ``ServingEngine`` through the breaker cycle (two
   injected ``serving_device_error`` failures open it, a submit is
   shed, the half-open probe answers bit-equal to the healthy engine),
   a retried request, a graceful drain of 8 requests behind a slowed
   batch; a second engine through a worker crash caught by the
   watchdog, a restart, and a drain deadline against wedged
   dispatches; ``Executor(retry_policy=)`` through injected
   ``device_error``s; K1 32 launches for each dispatch that computed,
   none for a failed or shed one; then a ``DecodeEngine`` wave with one
   device error retried, tokens equal to 23's. One ``serving_chaos:``
   line, before the kernel line, gives the windows, K1 by step and the
   counters.
50. aot_recurrent (run right after 40; F14 closed, the main path of this
   slice): 34's stacked LSTM and 36's seq2seq-attention model at their
   widths, each pruned to its prediction and saved with
   ``save_inference_model`` declaring no padded length, then served
   through one ``load_compiled_predictor`` artifact on the card — the
   LSTM at batch 32 x padded 16, 64 and 128, batch 1 x 37 and batch 32
   at lengths 9-64, seq2seq at batch 32 x (src, trg) (16, 16), (64, 64)
   and (64, 24) — each within 2e-4 / 2e-5 of the eager Executor; 40's
   fed While at three trip counts and its IfElse on each branch, equal
   to the Executor; 43's SRL tagger (linear_chain_crf's cost and
   chunk_eval's counts) and 44's CRNN-CTC (warpctc's cost per row), the
   F14 ops, each exported with no declared length and served at two
   padded lengths within 2e-4 / 2e-5 of the Executor; no attention
   launch. Its line gives each export's wall s and artifact bytes, the
   predictor's and the Executor's ms at each geometry (median of 5) and
   launches a run.
The kernels phase also checks K1-K3 at head dims 256 and 384 on both
routes (T 128 and 2048, causal and not, tq != tk, ragged, and at D 256
B*H past 65535 in bf16 and float32), each launch on its kernel symbol
— K1, K2 and K3 at D 256 on their warpgroup kernels on both routes,
with planted faults at their tiles at the D = 256 training shape and
the float32 train step's shape — and times them at the head_dim_256
phase's bf16 and float32 shapes, whose rows the kernel line adds: each
warpgroup kernel there beside the sliced D = 128 kernel it replaced,
timed in the same run; float32 K2 and K3 also at B*H 4, T 2048
(causal), where operations rather than latency bound them.
The kernels phase also holds K1's operator (``flash_fwd_op``, what an
exported graph calls) to the wrapper bit for bit and to the plain
version, at Transformer-base's f32 D 64 shape, the 8B width's bf16
serving shape and head dim 256 in bf16.
Phase 4 also times the default optimize and the verifier at the
32-layer program's construction, whose report must be empty (the
reference rewrites nothing there). Every phase runs under
``Executor.run``'s default verifier (``validate="1"``) with its
``VerifyWarning`` — and a rewrite falling back to the unoptimized
program, a save falling back to the JSON path (no ``__compiled__.pt2``)
or to an unseeded artifact store, and a bypassed store — raised as an
error.
The kernels phase also checks and times the float32 K1, K2 and K3 at
Transformer-base's shapes (B*H 32 x 8, D 64: causal T 256, and
non-causal tq 128 over tk 256), whose rows the kernel line adds.

It prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and
as its last line ``{"ok": true, "device": {...}}``. Without CUDA, or
without the package beside it, it exits non-zero and prints no result.
"""
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 0   # random weights, inputs and requests all derive from it

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_SPLIT_RATE = "float32 3xbf16"
F32_SPLIT_TF32_RATE = "float32 3xtf32"
F32_SPLIT5_RATE = "float32 5xbf16"
F32_SPLIT6_RATE = "float32 6xbf16"
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,
              # float32 products as three bf16 / three TF32 / five or six
              # bf16 tensor-core products
              F32_SPLIT_RATE: 989e12 / 3, F32_SPLIT_TF32_RATE: 494.7e12 / 3,
              F32_SPLIT5_RATE: 989e12 / 5, F32_SPLIT6_RATE: 989e12 / 6}
# each kind's products, 2 d FLOP per visible (row, key) pair each
PRODUCTS = {"fwd": ("QK^T", "PV"), "dq": ("QK^T", "dOV^T", "dSK"),
            "dkv": ("QK^T", "dOV^T", "P^TdO", "dS^TQ")}
# the float32 kernels take each product as a split on the tensor cores:
# their bounds count each product at its split's rate (a kernel not
# listed runs every product at its dtype's rate)
RATE_OF_KERNEL = {
    "flash_fwd_f32mma": (F32_SPLIT_RATE, F32_SPLIT_RATE),
    "flash_fwd_f32_d256_wgmma": (F32_SPLIT_RATE, F32_SPLIT_RATE),
    "flash_bwd_dq_f32mma": (F32_SPLIT_RATE, F32_SPLIT_TF32_RATE,
                            F32_SPLIT_RATE),
    "flash_bwd_dkv_f32mma": (F32_SPLIT_RATE, F32_SPLIT_TF32_RATE,
                             F32_SPLIT_TF32_RATE, F32_SPLIT_RATE),
    # dO V^T with dO in three bf16 pieces, P^T dO with both in three
    "flash_bwd_dq_f32_d256_wgmma": (F32_SPLIT_RATE, F32_SPLIT5_RATE,
                                    F32_SPLIT_RATE),
    "flash_bwd_dkv_f32_d256_wgmma": (F32_SPLIT_RATE, F32_SPLIT5_RATE,
                                     F32_SPLIT6_RATE, F32_SPLIT_RATE),
    # the same pieces at head dim 64
    "flash_bwd_dkv_f32_d64_wgmma": (F32_SPLIT_RATE, F32_SPLIT5_RATE,
                                    F32_SPLIT6_RATE, F32_SPLIT_RATE),
    "flash_bwd_dq_f32_d64_wgmma": (F32_SPLIT_RATE, F32_SPLIT5_RATE,
                                   F32_SPLIT_RATE),
    "flash_fwd_f32_d64_wgmma": (F32_SPLIT_RATE, F32_SPLIT_RATE),
    # and at head dim 128
    "flash_bwd_dq_f32_d128_wgmma": (F32_SPLIT_RATE, F32_SPLIT5_RATE,
                                    F32_SPLIT_RATE),
    "flash_bwd_dkv_f32_d128_wgmma": (F32_SPLIT_RATE, F32_SPLIT5_RATE,
                                     F32_SPLIT6_RATE, F32_SPLIT_RATE),
    "flash_fwd_f32_d128_wgmma": (F32_SPLIT_RATE, F32_SPLIT_RATE)}

# tolerances (|got - want| <= atol + rtol * |want|). A kernel's plain
# version is evaluated in float32 on the kernel's own inputs and rounded
# once to the output's type, as the kernel does; the tier follows the
# output's type.
TOL_F32 = (2e-4, 2e-5)     # tests/test_attention.py's f32 kernel tier
TOL_HALF_RTOL = 1e-2       # bf16/fp16 outputs: one rounding apart at
                           # most (a bf16 ulp is <= 2**-7 of the value)
TOL_HALF_RMS = 1e-2        # ... plus an atol of this x the plain
                           # output's RMS, for sums that cancel near 0
TOL_LOGITS_F32 = (5e-4, 5e-4)   # 32 float32 layers, summed in other orders
TOL_LOGITS_BF16_RMS = 0.1       # see phase_serve
TOL_GRAD_F32 = (2e-3, 2e-4)     # tests/test_attention.py's f32 gradient tier
TOL_LOSS_F32 = 2e-3             # tests/test_llama.py's loss tier

TRAIN_LAYERS = 8                # 32 → 8: Adam state of 32 layers
                                # (8.03 B params x 8 bytes in bf16) does
                                # not fit in 80 GB
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
TRAIN_LABEL = "training shape"
STACK_CHUNK = 2048              # bench.py's fused_head_chunk
# the f32 parity model (dim 512, head dim 128, vocab 2048): stacked, its
# fused loss in chunks of 384, so the last of 6 slides back by 256
PARITY_CHUNK = 384
AMP_LAYERS = 4                  # 32 → 4: float32 master state (params,
                                # gradients, two Adam moments) of 4 layers
                                # with the embedding and head is 31 GB
AMP_STEPS = 3
F32_LONG_LABEL = "f32 T=2048"   # the float32 kernels where the grid fills
F32_PIPE_LABEL = "f32 T=512"    # pipeline_schedule's float32 stage's shape
# the kernels of the head dims no model path runs, checked in
# phase_kernels and timed there so that they can be ranked: 16-bit at
# D 64 (mma.sync), both routes at D 384 (the mma.sync kernels in
# 128-column slices)
EXTRA_TIMED_LABELS = ("bf16 D=64 causal", "bf16 D=384 causal",
                      "f32 D=384 causal")
BIG_BH = 65536                  # past gridDim.y's 65535
# Transformer-base (models/transformer.py TRANSFORMER_BASE: d_model 512,
# 8 heads of 64, 6 + 6 layers, d_ff 2048, vocab 10000, float32) trained
# as "Attention Is All You Need" section 5.3 does: noam_decay(512, 4000)
# feeding Adam(beta1 0.9, beta2 0.98, eps 1e-9)
TF_BATCH, TF_SEQ = 32, 256
TF_HEAD_DIM = 64                # d_model 512 over 8 heads
TF_LEN_RANGE = (64, 256)        # source/target lengths drawn from SEED
TF_WARMUP, TF_STEPS = 2, 8
TF_UNPADDED_STEPS = 3
TF_NOAM_WARMUP = 4000
TF_CAUSAL_LABEL = "f32 D=64 transformer causal"
TF_CROSS_LABEL = "f32 D=64 transformer cross tq<tk"
# the card-vs-CPU Transformer: the base width (head dim 64, so the
# kernels) at 2 + 2 layers, 4 x 128 tokens with lengths, no dropout
TF_PARITY = dict(n_encoder_layers=2, n_decoder_layers=2, dropout=0.0)
TF_PARITY_BATCH, TF_PARITY_SEQ = 4, 128
TOL_LOGITS_REL_RMS_F32 = 5e-4   # PERF.md section 2's f32 serving tier
# Transformer-base served (the main path of ROADMAP item 2): the
# labels-free padded program's test clone behind ServingEngine with its
# default optimize, TF_SERVE_REQUESTS concurrent single-pair requests
# padded to TF_SEQ tokens with lengths drawn on SEED + 2
TF_SERVE_REQUESTS = 32
TF_SERVE_BATCHES = (1, 2, 4, 8)
# the served rate and tail under sustained load: TF_SERVE_REQUESTS
# closed-loop clients for TF_SERVE_WINDOW_S seconds, TF_SERVE_WINDOWS
# times (one wave of 32 requests is ~4 dispatches, too few to read)
TF_SERVE_WINDOWS, TF_SERVE_WINDOW_S = 3, 3.0
# optimized against unoptimized 8 x TF_SEQ dispatches, in alternation
TF_SERVE_PAIRS = 25
# what the reference's optimize reports on that program
# (tests/test_torch_optimize.py pins these against the JAX package);
# the 8B serving program passes through unchanged
TF_SERVE_OPTIMIZE_COUNTS = {"folded": 0, "fused": 26, "merged": 0,
                            "removed": 0, "converted": 0,
                            "layout_transposes": 0}
SERVE_8B_OPTIMIZE_COUNTS = dict.fromkeys(TF_SERVE_OPTIMIZE_COUNTS, 0)
# ROADMAP item 3 (IO, persistables, checkpoints, the Inferencer): path A
# trains TRANSFORMER_BASE at IO_TF_LAYERS layers a side (TF_BATCH x
# TF_SEQ, lengths) through Trainer for IO_STEPS steps in epochs of
# IO_EPOCH_STEPS, a checkpoint at each
# epoch's end (IO_KEEP kept), then serves it from its saved directory;
# path B saves and serves the 8B width at IO_LLAMA_LAYERS layers in bf16
# (32 layers would be 16 GB of params.npz to write and hash a run)
IO_STEPS, IO_EPOCH_STEPS, IO_KEEP = 6, 2, 3
IO_TIMED_STEPS = 4              # steps timed with and without DeviceLoader
IO_GOLDEN = 8                   # the golden set's requests
IO_LLAMA_LAYERS = 1              # 2 → 1: room for later phases
IO_TF_LAYERS = 3                 # path A's layers a side, 6 → 3: room
                                 # for aot_recurrent
# ROADMAP item 4a (the fused KV-cache generator): the 8B width generates
# GEN_NEW tokens after a GEN_PROMPT-token prompt for GEN_BATCH rows, and
# the layer-stacked forward (K1) scores the generated sequence again
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 128, 64
GEN_LAYERS = 4                  # 32 → 16 → 8 → 4: room for later phases
                                # and the fleet phases
GEN_F32_LAYERS = 4              # 32 → 4: the exact float32 check
GEN_GAMMA = 4
GEN_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9)
GEN_SAMPLED_NEW = 16            # the sampled checks' new tokens
GEN_PROFILED_NEW = 16           # the profiled generate's new tokens
GEN_LABEL = "generate T=192"    # K1 in the recompute: B*H 4*32, T 192
# head dims past 128 (the reference's Pallas gate takes D % 128 == 0):
# the 8B width with HD256_HEADS heads (head dim 4096 / 16 = 256) and
# HD256_KV kv heads (LLAMA3_8B's 4:1 GQA ratio), cut to HD256_LAYERS
# layers, trains one bf16 step at TRAIN_BATCH x TRAIN_SEQ and one
# float32 step at HD256_F32_BATCH x HD256_F32_SEQ, and serves one
# dispatch; the kernels phase adds K1-K3 cases at D 256 and 384
HD256_HEADS, HD256_KV, HD256_LAYERS = 16, 4, 2
HD256_F32_BATCH, HD256_F32_SEQ = 1, 256
HD256_LABEL = "D=256 training shape"
HD256_F32_LABEL = "f32 D=256 train step"
# float32 K2 and K3 at D 256 where operations, not latency, bound them
HD256_F32_LONG_LABEL = "f32 D=256 T=2048 causal"
# the float32 cases where faults planted at the float32 kernels' tiles
# must fail (the float32 warpgroup kernels at head dim 256, and
# Transformer-base's self-attention with K3's at head dim 64)
F32_FAULT_CASES = ("f32 serving T=256", "f32 causal", HD256_F32_LABEL,
                   TF_CAUSAL_LABEL)
# K1 at the phase's served dispatch: one 200-token request in bucket
# 256, B*H 1*16
HD256_OP_LABEL = "bf16 D=256 serving T=256"
# ROADMAP item 4b (the paged decode engine): the 8B width at DEC_LAYERS
# layers in bf16, behind DecodeEngine with DEC_CONFIG, DEC_REQUESTS requests of
# DEC_PROMPT_RANGE prompt tokens (lengths and tokens from SEED + 7)
# submitted by DEC_CLIENTS concurrent clients; float32 at
# DEC_F32_LAYERS layers; quantize, speculative (the target as its own
# draft, then a DEC_DRAFT_LAYERS-layer draft cut from the target, gamma
# DEC_GAMMA) and chunked prefill
# (DEC_CHUNK) once each at max_batch DEC_SMALL_BATCH
# 32 → 16 layers: at 32 the phase took a quarter of the script's time,
# which must stay well inside the chip call's limit; 16 → 8 to make room
# for the control-flow, CRF/CTC and seq2seq phases; 8 → 4 for
# flowers_train (depth cuts: the width stays the 8B model's)
DEC_LAYERS = 4
DEC_CONFIG = dict(max_batch=8, prompt_buckets=(128, 256), max_new_tokens=64,
                  page_size=16, decode_block=4, prefill_batch=4)
DEC_REQUESTS, DEC_CLIENTS = 24, 8
DEC_PROMPT_RANGE = (40, 256)
DEC_F32_LAYERS, DEC_F32_REQUESTS = 4, 8
DEC_SMALL_BATCH, DEC_SMALL_REQUESTS = 4, 4
DEC_DRAFT_LAYERS, DEC_GAMMA, DEC_CHUNK = 2, 4, 128
DEC_PROFILED_REQUESTS, DEC_PROFILED_NEW = 8, 16
DEC_PAGE_SAMPLE_S = 0.005       # the page high-water mark's sampling
# the cases where K1's custom operator is held to the wrapper and the
# plain version: Transformer-base's decoder (f32, D 64), the 8B width's
# serving shape (bf16, D 128) and the head_dim_256 phase's serving
# shape (bf16, D 256)
OP_CASES = (TF_CAUSAL_LABEL, "serving T=256", HD256_OP_LABEL)
# the reference's int8-KV bounds (tests/test_llama_generate.py:533)
KV8_MAX_DP, KV8_MAX_KL = 0.02, 1e-3
DROPOUT_P = 0.1
INIT_STD = 0.02                 # models/llama.py _linear's Normal(0, 0.02)
# ROADMAP item 6a (the device mesh, the ParallelExecutor, the MoE FFNs):
# the 8B width through ParallelExecutor on the one card's mesh beside
# the plain Executor, at MESH_LAYERS layers (two copies of the state
# and compiled_stats' third must fit), MESH_STEPS steps
MESH_LAYERS, MESH_STEPS = 4, 2
# Mixtral-8x7B's published width (dim 4096, 32 heads / 8 kv, expert ffn
# 14336, 8 experts top-2, vocab 32000, rope theta 1e6), cut to
# MOE_LAYERS layers: ~3.2 B params, whose bf16 Adam state fits
MOE_LAYERS = 2
MOE_BATCH, MOE_SEQ = 4, 512
MOE_WARMUP, MOE_STEPS = 1, 4
MOE_GEN_BATCH, MOE_GEN_PROMPT, MOE_GEN_NEW = 4, 128, 32
MOE_F32_LAYERS = 1
MOE_Q_AGREE = 0.9               # tests/test_llama_generate.py:468
# ParallelExecutor's first MoE loss against the plain Executor's: the
# mesh rule sums the aux loss's means in another order (bf16 loss, a
# ulp at ln 32000 is 2**-5 / 10.4 relative)
MOE_TOL_LOSS = 4e-3
TWO_RANK_TIMEOUT_S = 120
# ROADMAP item 6b (the pipeline schedules, ring attention, shard_sp):
# the 8B width's stacked program with the GPipe op and with the 1F1B
# op, at PIPE_LAYERS layers on PIPE_BATCH x PIPE_SEQ tokens, PIPE_STEPS
# timed steps each (one card admits one-rank meshes only, so the 1F1B
# op runs its single-device branch there); the schedules themselves on
# a one-rank 'pp' mesh, a stage of SCHED_LAYERS layers, SCHED_MICRO
# microbatches of 1 x SCHED_SEQ (float32: SCHED_F32_LAYERS layers at
# SCHED_F32_SEQ); the ring's step at the 8B attention width (B 1, 32
# heads, D 128) over RING_CHUNKS chunks of RING_SEQ, its gradient over
# RING_GRAD_CHUNKS chunks of RING_GRAD_SEQ in float32
PIPE_LAYERS, PIPE_BATCH, PIPE_SEQ, PIPE_STEPS = 4, 4, 2048, 3
SCHED_LAYERS, SCHED_MICRO, SCHED_SEQ = 2, 4, 2048
SCHED_F32_LAYERS, SCHED_F32_SEQ = 1, 512
RING_HEADS, RING_D = 32, 128
RING_SEQ, RING_CHUNKS = 16384, 8
RING_GRAD_SEQ, RING_GRAD_CHUNKS = 8192, 4
RING_MESH_SEQ = 2048
# the ring's bf16 output against K1: relative RMS error. Each step's
# probabilities enter P V in bf16, its partial output is bf16, and the
# accumulator is rounded to bf16 at each of the n merges (the
# reference's plain step and merge), so the element-wise kernel tier
# does not apply: ~2n roundings of 2**-9 relative (RMS ~1.1e-3 each)
# come to ~5e-3 at 8 chunks, and the tier allows 4x that
RING_TOL_BF16_RMS = 2e-2

# the profiler's kinds and the kernel functions each covers (every
# route)
KERNEL_NAMES = (("k1_flash_fwd", ("flash_fwd_f32mma_kernel",
                                   "flash_fwd_mma_kernel",
                                   "flash_fwd_d256_wgmma_kernel",
                                   "flash_fwd_f32_d256_wgmma_kernel",
                                   "flash_fwd_d128_wgmma_kernel",
                                   "flash_fwd_f32_d64_wgmma_kernel",
                                   "flash_fwd_f32_d128_wgmma_kernel")),
                ("k2_flash_bwd_dq", ("flash_bwd_dq_f32mma_kernel",
                                     "flash_bwd_dq_mma_kernel",
                                     "flash_bwd_dq_d256_wgmma_kernel",
                                     "flash_bwd_dq_f32_d256_wgmma_kernel",
                                     "flash_bwd_dq_d128_wgmma_kernel",
                                     "flash_bwd_dq_f32_d64_wgmma_kernel",
                                     "flash_bwd_dq_f32_d128_wgmma_kernel")),
                ("k3_flash_bwd_dkv", ("flash_bwd_dkv_f32mma_kernel",
                                      "flash_bwd_dkv_mma_kernel",
                                      "flash_bwd_dkv_d256_wgmma_kernel",
                                      "flash_bwd_dkv_f32_d256_wgmma_kernel",
                                      "flash_bwd_dkv_d128_wgmma_kernel",
                                      "flash_bwd_dkv_f32_d64_wgmma_kernel",
                                      "flash_bwd_dkv_f32_d128_wgmma_kernel")))
# the warpgroup kernels (K1, K2 and K3 at head dims 256 and 128 on both
# routes, float32 K1, K2 and K3 at head dim 64),
# whose SASS must hold HGMMA instructions, and the mma.sync kernels,
# whose SASS must hold HMMA: every kernel is one or the other
WGMMA_KERNELS = ("flash_fwd_d256_wgmma_kernel",
                 "flash_bwd_dq_d256_wgmma_kernel",
                 "flash_bwd_dkv_d256_wgmma_kernel",
                 "flash_fwd_f32_d256_wgmma_kernel",
                 "flash_bwd_dq_f32_d256_wgmma_kernel",
                 "flash_bwd_dkv_f32_d256_wgmma_kernel",
                 "flash_fwd_d128_wgmma_kernel",
                 "flash_bwd_dkv_d128_wgmma_kernel",
                 "flash_bwd_dq_d128_wgmma_kernel",
                 "flash_bwd_dkv_f32_d64_wgmma_kernel",
                 "flash_bwd_dq_f32_d64_wgmma_kernel",
                 "flash_fwd_f32_d64_wgmma_kernel",
                 "flash_fwd_f32_d128_wgmma_kernel",
                 "flash_bwd_dq_f32_d128_wgmma_kernel",
                 "flash_bwd_dkv_f32_d128_wgmma_kernel")
MMA_KERNELS = tuple(kern for _, kerns in KERNEL_NAMES for kern in kerns
                    if kern not in WGMMA_KERNELS)
# kernel symbol -> the constexprs of its source that give its tile's q
# rows and keys, where the planted faults are placed
TILE_CONSTEXPRS = {sym: ("BLOCK_M", "BLOCK_N")
                   for sym in ("flash_fwd_f32mma", "flash_fwd_mma",
                               "flash_bwd_dq_f32mma", "flash_bwd_dq_mma",
                               "flash_bwd_dkv_f32mma", "flash_bwd_dkv_mma",
                               "flash_fwd_d256_wgmma",
                               "flash_bwd_dq_d256_wgmma",
                               "flash_bwd_dkv_d256_wgmma",
                               "flash_fwd_f32_d256_wgmma",
                               "flash_bwd_dq_f32_d256_wgmma",
                               "flash_bwd_dkv_f32_d256_wgmma",
                               "flash_fwd_d128_wgmma",
                               "flash_bwd_dkv_d128_wgmma",
                               "flash_bwd_dq_d128_wgmma",
                               "flash_bwd_dkv_f32_d64_wgmma",
                               "flash_bwd_dq_f32_d64_wgmma",
                               "flash_fwd_f32_d64_wgmma",
                               "flash_fwd_f32_d128_wgmma",
                               "flash_bwd_dq_f32_d128_wgmma",
                               "flash_bwd_dkv_f32_d128_wgmma")}


class SmokeFailure(Exception):
    pass


T_START = [0.0]                 # main()'s start, for the elapsed lines


def _mixtral():
    from paddle_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=32000, dim=4096, n_layers=MOE_LAYERS,
                       n_heads=32, n_kv_heads=8, ffn_hidden=14336,
                       rope_base=1e6, dtype="bfloat16", moe_experts=8,
                       moe_top_k=2)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def f32_kernel(torch, fa, wrapper, d):
    """The symbol of the kernel ``wrapper`` launches on float32
    attention of head dim ``d``, whose launches the float32 paths
    count."""
    return fa.kernel_for(wrapper, torch.float32, d)[1]


def bf16_k1(torch, fa, cfg):
    """The symbol of the kernel K1 launches on bf16 attention of
    ``cfg``'s head dim, whose launches the bf16 serving and generation
    paths count."""
    return fa.kernel_for("flash_fwd", torch.bfloat16,
                         cfg.dim // cfg.n_heads)[1]


def time_ms(fn, torch, iters=20, flush=None):
    """Mean device time of ``fn`` in ms, by CUDA events around each
    call; ``flush`` (a large buffer) is rewritten before every call so
    each call finds a cold L2, as a layer of the model does."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def allclose_err(got, want, tol):
    rtol, atol = tol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    return ok, float(err.max())


def kernel_err(got, want):
    """A kernel output against its plain version, in the tier of the
    output's type: (ok, max abs err, worst err / limit)."""
    wf = want.float()
    if want.element_size() >= 4:
        rtol, atol = TOL_F32
    else:
        rtol = TOL_HALF_RTOL
        atol = TOL_HALF_RMS * float(wf.square().mean().sqrt())
    err = (got.float() - wf).abs()
    ratio = float((err / (atol + rtol * wf.abs())).max())
    return ratio <= 1.0, float(err.max()), ratio


TOL_TEXT = (f"f32 rtol={TOL_F32[0]} atol={TOL_F32[1]}; bf16/fp16 "
            f"rtol={TOL_HALF_RTOL} atol={TOL_HALF_RMS} x rms")


def attention_bound_ms(bh, tq, tk, d, rates, causal, itemsize,
                       kind="fwd"):
    """Least time for one call of K1 (``kind`` "fwd"), K2 ("dq") or K3
    ("dkv"): each input read once and each output written once, against
    the FLOPs this call's mask leaves per visible (row, key) pair, 2*d a
    product (:data:`PRODUCTS`) — K1 4*d (QK^T, PV), K2 6*d (QK^T,
    dO V^T, dS K), K3 8*d (QK^T, dO V^T, P^T dO, dS^T Q) — each product
    at its rate: ``rates`` names one rate of PEAK_FLOPS for all, or is a
    tuple of one a product."""
    q_bytes, kv_bytes = bh * tq * d * itemsize, bh * tk * d * itemsize
    row_bytes = bh * tq * 4                          # lse / delta, f32
    nbytes = {
        # q, k, v in; o, lse out
        "fwd": 2 * q_bytes + 2 * kv_bytes + row_bytes,
        # q, k, v, do, lse, delta in; dq out
        "dq": 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
        # q, k, v, do, lse, delta in; dk, dv out
        "dkv": 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes,
    }[kind]
    if isinstance(rates, str):
        rates = (rates,) * len(PRODUCTS[kind])
    if causal:
        rows = np.arange(tq)
        vis = np.clip(rows + (tk - tq) + 1, 0, tk)
        vis = np.where(rows + (tk - tq) < 0, tk, vis)  # fully masked: all
        pairs = int(vis.sum())
    else:
        pairs = tq * tk
    product_flops = 2.0 * bh * d * pairs
    flops = product_flops * len(rates)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_flops = sum(product_flops / PEAK_FLOPS[r] for r in rates)
    return (max(t_bytes, t_flops) * 1e3,
            "bytes" if t_bytes >= t_flops else "operations",
            nbytes, flops)


def attention_inputs(torch, gen, dev, bh, tq, tk, d, dt):
    q = (torch.randn(bh, tq, d, generator=gen, device=dev) * 0.5).to(dt)
    k = (torch.randn(bh, tk, d, generator=gen, device=dev) * 0.5).to(dt)
    v = (torch.randn(bh, tk, d, generator=gen, device=dev) * 0.5).to(dt)
    do = torch.randn(bh, tq, d, generator=gen, device=dev).to(dt)
    return q, k, v, do


def phase_kernels(torch, fa, seed):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    bh_train = TRAIN_BATCH * 32
    # (label, bh, tq, tk, d, dtype, causal); bf16/fp16 run the 16-bit
    # tensor-core K1, K2 and K3, float32 the split-operand ones
    cases = [
        ("serving T=128", 4 * 32, 128, 128, 128, bf16, True),
        ("serving T=256", 4 * 32, 256, 256, 128, bf16, True),
        (GEN_LABEL, GEN_BATCH * 32, GEN_PROMPT + GEN_NEW,
         GEN_PROMPT + GEN_NEW, 128, bf16, True),
        ("f32 serving T=128", 4 * 32, 128, 128, 128, f32, True),
        ("f32 serving T=256", 4 * 32, 256, 256, 128, f32, True),
        (TRAIN_LABEL, bh_train, TRAIN_SEQ, TRAIN_SEQ, 128, bf16, True),
        ("f32 causal", 8, 256, 256, 128, f32, True),
        ("f32 non-causal", 8, 256, 256, 128, f32, False),
        ("f32 tq<tk causal", 8, 128, 256, 128, f32, True),
        ("f32 tq>tk causal (fully masked rows)", 8, 256, 128, 128, f32,
         True),
        ("f32 ragged T=200 causal", 8, 200, 200, 128, f32, True),
        ("f32 ragged T=200 non-causal", 8, 200, 200, 128, f32, False),
        ("f32 D=64 causal", 8, 256, 256, 64, f32, True),
        ("f32 D=64 tq>tk causal (fully masked rows)", 8, 256, 128, 64, f32,
         True),
        ("f32 D=64 tq<tk causal", 8, 128, 256, 64, f32, True),
        ("f32 D=64 ragged T=200 causal", 8, 200, 200, 64, f32, True),
        ("f32 D=64 ragged T=200 non-causal", 8, 200, 200, 64, f32, False),
        ("bf16 tq<tk causal", 8, 128, 256, 128, bf16, True),
        ("bf16 tq>tk causal (fully masked rows)", 8, 256, 128, 128, bf16,
         True),
        ("bf16 ragged T=200 causal", 8, 200, 200, 128, bf16, True),
        ("bf16 ragged T=200 non-causal", 8, 200, 200, 128, bf16, False),
        ("bf16 T=2048 non-causal", 4, TRAIN_SEQ, TRAIN_SEQ, 128, bf16,
         False),
        ("bf16 D=64 causal", 8, 256, 256, 64, bf16, True),
        ("bf16 D=64 non-causal", 8, 256, 256, 64, bf16, False),
        ("fp16 ragged T=200 causal", 8, 200, 200, 128, f16, True),
        ("fp16 ragged T=200 non-causal", 8, 200, 200, 128, f16, False),
        ("fp16 D=64 causal", 8, 256, 256, 64, f16, True),
        (F32_LONG_LABEL, bh_train, TRAIN_SEQ, TRAIN_SEQ, 128, f32, True),
        (F32_PIPE_LABEL, 32, SCHED_F32_SEQ, SCHED_F32_SEQ, 128, f32, True),
        # Transformer-base's attention (32 x 8 heads, head dim 64, f32):
        # the causal decoder self-attention at T 256, and the unpadded
        # cross-attention of 128 target rows over 256 source keys
        (TF_CAUSAL_LABEL, TF_BATCH * 8, TF_SEQ, TF_SEQ, 64, f32, True),
        (TF_CROSS_LABEL, TF_BATCH * 8, TF_SEQ // 2, TF_SEQ, 64, f32,
         False),
        # head dims past 128: the D = 256 training, serving and f32
        # train-step shapes of the head_dim_256 phase, T 128 and 2048,
        # causal and not, tq != tk, ragged (K1-K3 on their warpgroup
        # kernels on both routes); D = 384, sliced
        (HD256_OP_LABEL, HD256_HEADS, 256, 256, 256, bf16, True),
        ("bf16 D=256 T=128 causal", 8, 128, 128, 256, bf16, True),
        ("bf16 D=256 T=128 non-causal", 8, 128, 128, 256, bf16, False),
        (HD256_LABEL, TRAIN_BATCH * HD256_HEADS, TRAIN_SEQ, TRAIN_SEQ, 256,
         bf16, True),
        ("bf16 D=256 T=2048 non-causal", 4, TRAIN_SEQ, TRAIN_SEQ, 256, bf16,
         False),
        ("bf16 D=256 tq<tk causal", 8, 128, 256, 256, bf16, True),
        ("bf16 D=256 tq>tk causal (fully masked rows)", 8, 256, 128, 256,
         bf16, True),
        ("bf16 D=256 ragged T=200 causal", 8, 200, 200, 256, bf16, True),
        ("fp16 D=256 ragged T=200 non-causal", 8, 200, 200, 256, f16,
         False),
        ("fp16 D=256 tq>tk causal (fully masked rows)", 8, 256, 128, 256,
         f16, True),
        ("f32 D=256 T=128 causal", 8, 128, 128, 256, f32, True),
        ("f32 D=256 T=128 non-causal", 8, 128, 128, 256, f32, False),
        (HD256_F32_LABEL, HD256_F32_BATCH * HD256_HEADS, HD256_F32_SEQ,
         HD256_F32_SEQ, 256, f32, True),
        (HD256_F32_LONG_LABEL, 4, TRAIN_SEQ, TRAIN_SEQ, 256, f32, True),
        ("f32 D=256 T=2048 non-causal", 4, TRAIN_SEQ, TRAIN_SEQ, 256, f32,
         False),
        ("f32 D=256 tq<tk causal", 8, 128, 256, 256, f32, True),
        ("f32 D=256 tq>tk causal (fully masked rows)", 8, 256, 128, 256,
         f32, True),
        ("f32 D=256 ragged T=200 causal", 8, 200, 200, 256, f32, True),
        ("f32 D=256 ragged T=200 non-causal", 8, 200, 200, 256, f32, False),
        ("bf16 D=384 causal", 8, 256, 256, 384, bf16, True),
        ("bf16 D=384 ragged T=200 non-causal", 8, 200, 200, 384, bf16,
         False),
        ("f32 D=384 causal", 8, 256, 256, 384, f32, True),
        ("f32 D=384 tq>tk causal (fully masked rows)", 8, 256, 128, 384, f32,
         True),
    ]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    results = {}
    failures = []
    for label, bh, tq, tk, d, dt, causal in cases:
        q, k, v, do = attention_inputs(torch, gen, dev, bh, tq, tk, d, dt)
        scale = 1.0 / np.sqrt(d)
        fa.reset_launch_counts()
        o, lse = fa.flash_fwd(q, k, v, scale, causal)
        torch.cuda.synchronize()
        # K1's plain version rounds scores and probabilities to the
        # input type; evaluated in float32 it rounds only its output
        o_ref, lse_ref = fa.ref_attention_lse(q.float(), k.float(),
                                              v.float(), scale, causal)
        pairs = {"O": (o, o_ref.to(dt)), "lse": (lse, lse_ref)}
        del o_ref, lse_ref
        # K2 and K3 on the forward's own lse and delta, each output
        # checked on its own against the plain versions on those inputs
        delta = (do.float() * o.float()).sum(-1)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, scale, causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
        torch.cuda.synchronize()
        ran = check_variants(torch, fa, dt, d)
        pairs["dQ"] = (dq, fa.ref_flash_bwd_dq(q, k, v, do, lse, delta,
                                               scale, causal))
        want_k, want_v = fa.ref_flash_bwd_dkv(q, k, v, do, lse, delta,
                                              scale, causal)
        pairs["dK"], pairs["dV"] = (dk, want_k), (dv, want_v)
        errs = {n: kernel_err(g, w) for n, (g, w) in pairs.items()}
        finite = all(bool(torch.isfinite(g).all()) for g, _ in pairs.values())
        ok = finite and all(e[0] for e in errs.values())
        log(f"K1-3 {label}: bh={bh} tq={tq} tk={tk} d={d} {dt} "
            f"causal={causal} ({', '.join(ran)}): max abs err (err/limit) "
            + ", ".join(f"{n} {e:.3e} ({r:.3f})"
                        for n, (_, e, r) in errs.items())
            + f" ({TOL_TEXT}) {'ok' if ok else 'MISMATCH'}")
        if label in OP_CASES and ok:
            check_custom_op(torch, fa, label, (q, k, v), scale, causal,
                            (o, lse), pairs["O"][1])
        if not ok:
            failures.append(label)
        heads = {64: 8, 256: HD256_HEADS}.get(d)
        results[label] = dict(
            inputs=(q, k, v, do, causal),
            heads=heads if heads and bh % heads == 0 else None,
            err_fwd=max(errs["O"][1], errs["lse"][1]), err_dq=errs["dQ"][1],
            err_dkv=max(errs["dK"][1], errs["dV"][1]))
        if label in (TRAIN_LABEL, HD256_LABEL) and ok:
            check_planted_faults(torch, fa, (q, k, v, do, lse, delta), scale,
                                 pairs, errs, label)
        if label in F32_FAULT_CASES and ok:
            check_planted_f32_faults(torch, fa, label,
                                     (q, k, v, do, lse, delta), scale,
                                     pairs, errs)
        del o, lse, delta, dq, dk, dv, pairs, want_k, want_v
    check(not failures,
          f"K1/K2/K3 disagree with their plain versions: {failures}")
    check_lse_gradient(torch, fa, gen, dev)
    check_big_bh(torch, fa, gen, dev)
    # at D 128 K1, K2 and K3 run their warpgroup kernels on both routes
    check_big_bh(torch, fa, gen, dev, d=128,
                 dtypes=(torch.bfloat16, torch.float16, torch.float32))
    # at D 256 K1-K3 run their warpgroup kernels on both routes: inputs,
    # outputs and the plain versions of one float32 case take ~25 GB of
    # the card's 80
    check_big_bh(torch, fa, gen, dev, d=256)

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB
    timing = {}
    for label, kinds in (("serving T=128", ("fwd",)),
                         ("serving T=256", ("fwd",)),
                         (GEN_LABEL, ("fwd",)),
                         ("f32 serving T=128", ("fwd",)),
                         ("f32 serving T=256", ("fwd",)),
                         (TRAIN_LABEL, ("fwd", "dq", "dkv")),
                         ("f32 causal", ("fwd", "dq", "dkv")),
                         (F32_LONG_LABEL, ("fwd", "dq", "dkv")),
                         (F32_PIPE_LABEL, ("fwd", "dq", "dkv")),
                         *((label, ("fwd", "dq", "dkv"))
                           for label in EXTRA_TIMED_LABELS),
                         (TF_CAUSAL_LABEL, ("fwd", "dq", "dkv")),
                         (TF_CROSS_LABEL, ("fwd", "dq", "dkv")),
                         (HD256_LABEL, ("fwd", "dq", "dkv")),
                         (HD256_OP_LABEL, ("fwd",)),
                         (HD256_F32_LABEL, ("fwd", "dq", "dkv")),
                         (HD256_F32_LONG_LABEL, ("dq", "dkv"))):
        timing.update(time_kernels(torch, fa, results[label], label, kinds,
                                   flush))
    del flush, results
    return timing


def check_custom_op(torch, fa, label, qkv, scale, causal, wrapper_out,
                    o_plain):
    """K1 through its ``torch.library`` operator (``fa.flash_fwd_op``,
    what an exported graph calls): one launch of the variant
    ``kernel_for`` names, outputs equal to the wrapper's bit for bit and
    within the tier of the plain version."""
    q = qkv[0]
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd_op(*qkv, scale, causal)
    torch.cuda.synchronize()
    sym = fa.kernel_for("flash_fwd", q.dtype, q.shape[-1])[1]
    ok, err, ratio = kernel_err(o, o_plain)
    check(fa.flash_fwd.launches == 1
          and fa.flash_fwd.launches_by_kernel[sym] == 1,
          f"K1 operator {label}: launches {fa.flash_fwd.launches_by_kernel}"
          f", not one of {sym}")
    check(torch.equal(o, wrapper_out[0]) and torch.equal(lse, wrapper_out[1])
          and ok, f"K1 operator {label}: differs from the wrapper or from "
          f"the plain version (err {err:.3e}, {ratio:.3f} of the limit)")
    log(f"K1 operator {label}: {sym}, equal to the wrapper, max abs err "
        f"{err:.3e} ({ratio:.3f} of the limit)")


def check_variants(torch, fa, dt, d, launches=1):
    """Each wrapper launched ``launches`` kernels (one call, in that many
    B*H chunks) since the counts were reset, all of the variant
    ``kernel_for`` names for ``dt``; returns the variants' symbols."""
    ran = []
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        _, sym = fa.kernel_for(w.__name__, dt, d)
        check((dt == torch.float32) == ("f32" in sym),
              f"{dt} {w.__name__} routes to {sym}, a kernel of the other "
              f"route")
        by = w.launches_by_kernel
        check(w.launches == launches and by[sym] == launches
              and not by[fa.PLAIN],
              f"{w.__name__} on {dt}: launches {by}, expected {launches} "
              f"of {sym}")
        ran.append(sym)
    return ran


def time_kernels(torch, fa, r, label, kinds, flush):
    """Time the wrappers of ``kinds`` ("fwd" K1, "dq" K2, "dkv" K3) on
    case ``r``'s inputs (cold L2), beside their plain versions, SDPA's
    forward or backward and their bounds. Returns {(kind, label): row}."""
    q, k, v, do, causal = r["inputs"]
    bh, tq, d = q.shape
    tk = k.shape[1]
    scale = 1.0 / np.sqrt(d)
    dt_name = str(q.dtype).rsplit(".", 1)[-1]
    heads = r.get("heads") or (32 if bh % 32 == 0 else bh)
    # SDPA's is_causal masks top-left: held only where tq == tk
    check(not causal or tq == tk, f"{label}: SDPA's causal mask is "
          "top-left, the kernels' bottom-right; time causal at tq == tk")
    q4, do4 = (x.view(bh // heads, heads, tq, d) for x in (q, do))
    k4, v4 = (x.view(bh // heads, heads, tk, d) for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    o, lse = fa.flash_fwd(q, k, v, scale, causal)
    delta = (do.float() * o.float()).sum(-1)
    lib_ms = {"fwd": time_ms(lambda: sdpa(q4, k4, v4, is_causal=causal),
                             torch, flush=flush)}
    if set(kinds) - {"fwd"}:
        # SDPA's backward (dQ, dK and dV in one call) on a saved graph
        qg, kg, vg = (x.detach().clone().requires_grad_()
                      for x in (q4, k4, v4))
        out = sdpa(qg, kg, vg, is_causal=causal)
        lib_ms["dq"] = lib_ms["dkv"] = time_ms(
            lambda: torch.autograd.grad(out, (qg, kg, vg), do4,
                                        retain_graph=True),
            torch, flush=flush)
        del out, qg, kg, vg
    bwd = (q, k, v, do, lse, delta, scale, causal)
    calls = {
        "fwd": ("flash_fwd", "err_fwd",
                lambda: fa.flash_fwd(q, k, v, scale, causal),
                lambda: fa.ref_attention_lse(q, k, v, scale, causal), 20),
        "dq": ("flash_bwd_dq", "err_dq", lambda: fa.flash_bwd_dq(*bwd),
               lambda: fa.ref_flash_bwd_dq(*bwd), 5),
        "dkv": ("flash_bwd_dkv", "err_dkv", lambda: fa.flash_bwd_dkv(*bwd),
                lambda: fa.ref_flash_bwd_dkv(*bwd), 5),
    }
    rows = {}
    for kind in kinds:
        wrapper, err, kern, plain, plain_iters = calls[kind]
        ms = time_ms(kern, torch, flush=flush)
        plain_ms = time_ms(plain, torch, iters=plain_iters, flush=flush)
        symbol = fa.kernel_for(wrapper, q.dtype, d)[1]
        route = fa.F32_ROUTE if q.dtype == torch.float32 else fa.HALF_ROUTE
        # a warpgroup kernel: the mma.sync kernel it replaced (in 128-column
        # slices at D 256) on the same inputs in the same run
        replaced = fa._ROUTES[wrapper][route] \
            if (wrapper, route, d) in fa._WGMMA_ROUTES else None
        rates = RATE_OF_KERNEL.get(symbol, (dt_name,) * len(PRODUCTS[kind]))
        bound, by, nbytes, flops = attention_bound_ms(
            bh, tq, tk, d, rates, causal, q.element_size(), kind)
        at_rate = ", ".join(f"{prod} at {PEAK_FLOPS[r] / 1e12:.1f} TFLOP/s"
                            f" {r}" for prod, r in zip(PRODUCTS[kind], rates))
        rows[(kind, label)] = dict(
            kernel=symbol, ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms[kind], bound_ms=bound, bound_by=by,
            max_abs_err=r[err])
        also = ""
        if replaced is not None:
            rows[(kind, label)].update(time_replaced(
                torch, fa, wrapper, replaced, bwd, flush))
            rr = rows[(kind, label)]
            also = (f" (through the launcher {rr['launcher_ms']:.4f} ms; "
                    f"the {replaced[1]} it replaced: "
                    f"{rr['replaced_ms']:.4f} ms, max abs err "
                    f"{rr['replaced_max_abs_err']:.3e}; host time of a "
                    f"launch {rr['launch_host_us']:.1f} us, its tensor "
                    f"maps encoded each call, against "
                    f"{rr['replaced_launch_host_us']:.1f} us)")
        if symbol in RATE_OF_KERNEL:
            # the same work with every product at the 3xbf16 rate: one
            # yardstick for any float32 design, whichever splits it takes
            rows[(kind, label)]["bound_3xbf16_ms"] = attention_bound_ms(
                bh, tq, tk, d, F32_SPLIT_RATE, causal, q.element_size(),
                kind)[0]
            also += (f" (every product at 3xbf16: "
                     f"{rows[(kind, label)]['bound_3xbf16_ms']:.4f} ms)")
        log(f"{symbol} {label} timing (cold L2): kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa "
            f"{'forward' if kind == 'fwd' else 'backward (dQ, dK, dV)'} "
            f"{lib_ms[kind]:.4f} ms, bound {bound:.4f} ms by {by}{also} "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP: {at_rate})")
    del o, lse, delta
    return rows


# what time_replaced adds to a warpgroup kernel's timing row, copied onto
# its row of the kernels line
REPLACED_KEYS = ("launcher_ms", "replaced_kernel", "replaced_ms",
                 "replaced_max_abs_err", "launch_host_us",
                 "replaced_launch_host_us")


def kernel_call(torch, fa, wrapper, route, bwd):
    """(a call of kernel ``route`` (library, symbol) of ``wrapper``
    ("flash_fwd", "flash_bwd_dq" or "flash_bwd_dkv") on ``bwd``'s inputs,
    the outputs it writes) — the mma.sync kernel a warpgroup kernel
    replaced (in 128-column slices past D 128), for timing beside it, or
    the warpgroup kernel itself, launched the same way. Its launches
    count on the wrapper under that kernel's symbol."""
    q, k, v, do, lse, delta, scale, causal = bwd
    if wrapper == "flash_fwd":
        outs = (torch.empty_like(q), torch.empty_like(lse))
        ins = (q, k, v)
    elif wrapper == "flash_bwd_dq":
        outs = (torch.empty_like(q),)
        ins = (q, k, v, do, lse, delta)
    else:
        outs = (torch.empty_like(k), torch.empty_like(v))
        ins = (q, k, v, do, lse, delta)
    ptrs = tuple(x.data_ptr() for x in ins + outs)
    return (lambda: fa._launch(getattr(fa, wrapper), route, ptrs, q,
                               k.shape[1], scale, causal)), outs


def launch_host_us(fn, torch, n=100):
    """Host microseconds a call of ``fn`` takes to return (no
    synchronize between calls): for a kernel launch, its arguments, any
    tensor maps it encodes and the launch itself."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / n * 1e6


def time_replaced(torch, fa, wrapper, replaced, bwd, flush):
    """The mma.sync kernel ``replaced`` that a warpgroup kernel replaced
    (in 128-column slices at D 256), on the same inputs in the same run: its device ms (cold
    L2) and the warpgroup kernel's through the same launcher, in turns
    (``launcher_ms``: without the wrapper's checks and allocations,
    which a small kernel's time may not hide), its worst error against
    the plain version, and the host time of one launch of each kernel
    through that launcher (the warpgroup kernels encode their TMA
    tensor maps on every call)."""
    q, k, v, do, lse, delta, scale, causal = bwd
    call, outs = kernel_call(torch, fa, wrapper, replaced, bwd)
    new, _ = kernel_call(torch, fa, wrapper,
                         fa.kernel_for(wrapper, q.dtype, q.shape[-1]), bwd)
    turns = {"replaced_ms": [], "launcher_ms": []}
    for key, fn in (("replaced_ms", call), ("launcher_ms", new),
                    ("launcher_ms", new), ("replaced_ms", call)):
        turns[key].append(time_ms(fn, torch, flush=flush))
    out = {"replaced_kernel": replaced[1],
           **{key: sum(ms) / len(ms) for key, ms in turns.items()}}
    torch.cuda.synchronize()
    if wrapper == "flash_fwd":
        o_ref, lse_ref = fa.ref_attention_lse(q.float(), k.float(),
                                              v.float(), scale, causal)
        wants = (o_ref.to(q.dtype), lse_ref)
    elif wrapper == "flash_bwd_dq":
        wants = (fa.ref_flash_bwd_dq(*bwd),)
    else:
        wants = fa.ref_flash_bwd_dkv(*bwd)
    errs = [kernel_err(g, w) for g, w in zip(outs, wants)]
    check(all(e[0] for e in errs),
          f"{replaced[1]} (replaced) disagrees with its plain version: "
          f"{[(e, r) for _, e, r in errs]}")
    out["replaced_max_abs_err"] = max(e for _, e, _ in errs)
    del wants, outs
    out["launch_host_us"] = launch_host_us(new, torch)
    out["replaced_launch_host_us"] = launch_host_us(call, torch)
    return out


def kernel_tile(fa, wrapper, dtype, d=128):
    """(q rows, keys) of a tile of the kernel ``wrapper`` launches on
    ``dtype``, read from its source's constexprs."""
    from paddle_tpu_torch.ops import cuda_build
    lib, sym = fa.kernel_for(wrapper, dtype, d)
    values = cuda_build.constexprs(lib)
    return tuple(values[name] for name in TILE_CONSTEXPRS[sym])


def planted_fault_tiles(torch, fa, d=128):
    """(q rows, keys) of a tile of each kernel a bf16 training shape of
    head dim ``d`` runs (K1, K2 and K3 on the tensor cores)."""
    return {w: kernel_tile(fa, w, torch.bfloat16, d)
            for w in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}


def check_planted_faults(torch, fa, inputs, scale, pairs, errs,
                         label=TRAIN_LABEL):
    """The bf16 tier must catch what a grid or tile-loop fault leaves at
    a training shape (``label``: causal, tq = tk = T), where late rows
    and keys hold the smallest values: each fault is planted in a copy
    of a kernel's output and must fail the check the kernel passed.
    Tiles are those of the kernels that ran at its head dim
    (:func:`planted_fault_tiles`)."""
    q, k, v, do, lse, delta = inputs
    bh, t, d = q.shape
    tiles = planted_fault_tiles(torch, fa, d)
    fwd_rows, _ = tiles["flash_fwd"]
    dq_rows, dq_keys = tiles["flash_bwd_dq"]
    dkv_rows, dkv_keys = tiles["flash_bwd_dkv"]

    def last_tile_lost(x, n):
        x = x.clone()
        x[:, -n:] = 0
        return x

    def minus(x, part):
        return (x.float() - part.float().reshape(x.shape)).to(x.dtype)

    # K2 stops one k tile early: under causal the last k tile of q tile
    # i is keys [(i + 1) dq_rows - dq_keys, (i + 1) dq_rows), whose share
    # of dQ is the plain dQ of those rows against those keys (the masks
    # align bottom-right)
    nt = t // dq_rows
    q_t, do_t = (x.view(bh, nt, dq_rows, d) for x in (q, do))
    k_t, v_t = (x.view(bh, nt, dq_rows // dq_keys, dq_keys, d)[:, :, -1]
                for x in (k, v))
    lse_t, delta_t = (x.view(bh, nt, dq_rows) for x in (lse, delta))
    dq_last_k = fa.ref_flash_bwd_dq(q_t, k_t, v_t, do_t, lse_t, delta_t,
                                    scale, True)
    # K3 stops one q tile early: every k tile's loop ends at rows
    # [T - dkv_rows, T)
    dk_last_q, dv_last_q = fa.ref_flash_bwd_dkv(
        q[:, -dkv_rows:], k, v, do[:, -dkv_rows:], lse[:, -dkv_rows:],
        delta[:, -dkv_rows:], scale, True)
    (o, _), (dq, _), (dk, _), (dv, _) = (pairs[n]
                                         for n in ("O", "dQ", "dK", "dV"))
    faults = (
        ("O", f"K1 leaves its last {fwd_rows}-row q tile unwritten",
         last_tile_lost(o, fwd_rows)),
        ("dQ", f"K2 leaves its last {dq_rows}-row q tile unwritten",
         last_tile_lost(dq, dq_rows)),
        ("dQ", f"K2 skips each q tile's last {dq_keys}-key tile",
         minus(dq, dq_last_k)),
        ("dK", f"K3 leaves its last {dkv_keys}-key tile unwritten",
         last_tile_lost(dk, dkv_keys)),
        ("dV", f"K3 leaves its last {dkv_keys}-key tile unwritten",
         last_tile_lost(dv, dkv_keys)),
        ("dK", f"K3 skips its last {dkv_rows}-row q tile",
         minus(dk, dk_last_q)),
        ("dV", f"K3 skips its last {dkv_rows}-row q tile",
         minus(dv, dv_last_q)),
    )
    for name, what, bad in faults:
        _, err, ratio = kernel_err(bad, pairs[name][1])
        log(f"planted fault, {label}: {what}: {name} max abs err "
            f"{err:.3e}, err/limit {ratio:.3f} (the kernel's own "
            f"{errs[name][2]:.3f}) {'caught' if ratio > 1 else 'MISSED'}")
        check(ratio > 1.0, f"the bf16 tier does not catch a planted fault "
                           f"({what}: {name} err/limit {ratio:.3f})")


def check_planted_f32_faults(torch, fa, label, inputs, scale, pairs,
                             errs):
    """The float32 tier must catch what a grid or tile-loop fault of each
    float32 kernel leaves at a causal case (tq = tk): each fault is
    planted in a copy of the kernel's output and must fail the check the
    kernel passed, at the kernel's own tile (read from its source's
    constexprs) — K1 and K2 leaving their last q tile unwritten or
    skipping each q tile's last visited key tile, K3 leaving its last
    key tile unwritten or skipping its last q tile."""
    q, k, v, do, lse, delta = inputs
    tq, tk, d = q.shape[1], k.shape[1], q.shape[2]
    rows_i = torch.arange(tq, device=q.device)
    cols = torch.arange(tk, device=q.device)[None, :]

    def last_tile_lost(x, n):
        x = x.clone()
        x[:, (x.shape[1] - 1) // n * n:] = 0
        return x

    def last_key_tile(rows, keys, last_row):
        """[tq, tk]: the keys of the last key tile the q tile of each row
        visits, whose loop ends at the causal limit of ``last_row`` (the
        tile's last row) — K1's and K2's loop bound."""
        last = ((last_row(rows_i // rows * rows) + tk - tq) // keys) \
            .clamp(max=(tk - 1) // keys)
        return cols // keys == last[:, None]

    faults = []
    rows, keys = kernel_tile(fa, "flash_fwd", torch.float32, d)
    # K1: the skipped keys leave the softmax of the tile's rows
    skipped = last_key_tile(rows, keys, lambda q0: q0 + rows - 1)
    bias = torch.zeros(tq, tk, device=q.device).masked_fill(skipped,
                                                            -math.inf)
    skip_o, _ = fa.ref_attention_lse(q, k, v, scale, True, bias)
    faults += [("O", f"K1 f32 leaves its last {rows}-row q tile unwritten",
                last_tile_lost(pairs["O"][0], rows)),
               ("O", f"K1 f32 skips each q tile's last {keys}-key tile",
                skip_o)]
    del skip_o, bias
    # K2: the skipped keys' share of dQ, dS K over those keys
    rows, keys = kernel_tile(fa, "flash_bwd_dq", torch.float32, d)
    skipped = last_key_tile(rows, keys,
                            lambda q0: (q0 + rows).clamp(max=tq) - 1)
    _, ds = fa._ref_p_ds(q, k, v, do, lse, delta, scale, True)
    lost_dq = torch.einsum("bqk,bkd->bqd", ds * skipped, k.float())
    del ds
    dq = pairs["dQ"][0]
    faults += [("dQ", f"K2 f32 leaves its last {rows}-row q tile unwritten",
                last_tile_lost(dq, rows)),
               ("dQ", f"K2 f32 skips each q tile's last {keys}-key tile",
                dq - lost_dq)]
    # K3: the last q tile's share of dK and dV
    rows, keys = kernel_tile(fa, "flash_bwd_dkv", torch.float32, d)
    r0 = (tq - 1) // rows * rows
    lost_dk, lost_dv = fa.ref_flash_bwd_dkv(
        q[:, r0:], k, v, do[:, r0:], lse[:, r0:], delta[:, r0:], scale, True)
    for name, lost in (("dK", lost_dk), ("dV", lost_dv)):
        got = pairs[name][0]
        faults += [(name, f"K3 f32 leaves its last {keys}-key tile "
                          f"unwritten", last_tile_lost(got, keys)),
                   (name, f"K3 f32 skips its last {rows}-row q tile",
                    got - lost)]
    for name, what, bad in faults:
        _, err, ratio = kernel_err(bad, pairs[name][1])
        log(f"planted fault, {label}: {what}: {name} max abs err "
            f"{err:.3e}, err/limit {ratio:.3f} (the kernel's own "
            f"{errs[name][2]:.3f}) {'caught' if ratio > 1 else 'MISSED'}")
        check(ratio > 1.0, f"the f32 tier does not catch a planted fault "
                           f"({label}: {what}: {name} err/limit "
                           f"{ratio:.3f})")


def check_big_bh(torch, fa, gen, dev, d=64, dtypes=None):
    """B*H = BIG_BH, one past gridDim.y's 65535, which the launchers take
    in chunks: K1, K2 and K3 in ``dtypes`` (bf16 and float32; causal,
    T = 32, head dim ``d``) against their plain versions in the tier of
    the output's type — the slices past the first chunk among them."""
    for dt in dtypes or (torch.bfloat16, torch.float32):
        q, k, v, do = attention_inputs(torch, gen, dev, BIG_BH, 32, 32, d,
                                       dt)
        scale = 1.0 / math.sqrt(d)
        fa.reset_launch_counts()
        o, lse = fa.flash_fwd(q, k, v, scale, True)
        delta = (do.float() * o.float()).sum(-1)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, scale, True)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True)
        torch.cuda.synchronize()
        # one call a wrapper, launched as two chunks of B*H
        ran = check_variants(torch, fa, dt, d,
                             launches=-(-BIG_BH // fa.MAX_GRID_Y))
        o_ref, lse_ref = fa.ref_attention_lse(q.float(), k.float(),
                                              v.float(), scale, True)
        want_k, want_v = fa.ref_flash_bwd_dkv(q, k, v, do, lse, delta,
                                              scale, True)
        errs = {"O": kernel_err(o, o_ref.to(dt)),
                "lse": kernel_err(lse, lse_ref),
                "dQ": kernel_err(dq, fa.ref_flash_bwd_dq(
                    q, k, v, do, lse, delta, scale, True)),
                "dK": kernel_err(dk, want_k), "dV": kernel_err(dv, want_v)}
        ok = all(e[0] for e in errs.values())
        log(f"K1-3 bh={BIG_BH} (past gridDim.y) t=32 d={d} {dt} causal "
            f"({', '.join(ran)}): max abs err (err/limit) "
            + ", ".join(f"{n} {e:.3e} ({r:.3f})"
                        for n, (_, e, r) in errs.items())
            + f" {'ok' if ok else 'MISMATCH'}")
        check(ok, f"kernels at bh={BIG_BH} disagree with their plain "
                  f"versions ({dt})")
        del q, k, v, do, o, lse, delta, dq, dk, dv, o_ref, lse_ref
        del want_k, want_v


def check_lse_gradient(torch, fa, gen, dev):
    """attention_with_lse is differentiable in o AND lse: its gradient
    (K1, K2, K3) against plain torch autograd through ref_attention_lse,
    on the card, float32, with fully masked rows (tq > tk) and without."""
    for tq, tk in ((256, 256), (256, 128)):
        q, k, v, do = attention_inputs(torch, gen, dev, 8, tq, tk, 128,
                                       torch.float32)
        dl = torch.randn(8, tq, generator=gen, device=dev)
        q, k, v = (x.view(2, 4, -1, 128) for x in (q, k, v))
        do, dl = do.view(2, 4, tq, 128), dl.view(2, 4, tq)
        grads = []
        for f in (lambda a, b, c: fa.attention_with_lse(a, b, c,
                                                         causal=True),
                  lambda a, b, c: fa.ref_attention_lse(
                      a, b, c, 1.0 / math.sqrt(128), True)):
            ts = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            o, lse = f(*ts)
            loss = (o * do).sum() + (lse * dl).sum()
            grads.append(torch.autograd.grad(loss, ts))
        torch.cuda.synchronize()
        errs = [allclose_err(g, w, TOL_GRAD_F32)
                for g, w in zip(grads[0], grads[1])]
        log(f"attention_with_lse gradient through o and lse, f32 tq={tq} "
            f"tk={tk} causal: max|dq|,|dk|,|dv| = "
            + ", ".join(f"{e:.3e}" for _, e in errs)
            + f" vs plain autograd (rtol={TOL_GRAD_F32[0]}, "
            f"atol={TOL_GRAD_F32[1]})")
        check(all(ok for ok, _ in errs),
              f"attention_with_lse gradient differs from plain autograd "
              f"(tq={tq}, tk={tk})")


def where_the_time_goes(torch, exe, program, fetch, scope, feed):
    """Break one dispatch of ``feed`` down: host wall time with and
    without copying the fetched logits to numpy, and the device's kernel
    time by kind from torch.profiler (K1, matrix products, copies, the
    rest). Diagnostic only — reports "not measured" where the profiler
    sees no device time."""
    def run(return_numpy):
        t0 = time.perf_counter()
        out = exe.run(program, feed=feed, fetch_list=[fetch], scope=scope,
                      return_numpy=return_numpy)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    run(True)
    no_fetch = sorted(run(False)[0] for _ in range(3))[1]
    with_fetch = sorted(run(True)[0] for _ in range(3))[1]
    kinds = device_ms_by_kind(torch, lambda: run(False))
    out = {"feed": {k: list(v.shape) for k, v in feed.items()},
           "wall_ms_device_fetch": no_fetch * 1e3,
           "wall_ms_numpy_fetch": with_fetch * 1e3}
    add_busy(out, kinds, no_fetch * 1e3)
    return out


def paired_dispatch_ms(torch, exe, programs, fetch, scope, feed, pairs):
    """Host wall ms of one dispatch of ``feed`` (logits left on the card)
    through each of the two ``programs``, taken in alternation ``pairs``
    times (the order flipping each pair) so the host's drift falls on
    both alike. Returns each program's median and the per-pair ratio's
    (first over second) median and 10th/90th percentiles."""
    times = ([], [])
    for k in range(pairs):
        for i in ((0, 1) if k % 2 == 0 else (1, 0)):
            t0 = time.perf_counter()
            exe.run(programs[i], feed=feed, fetch_list=[fetch],
                    scope=scope, return_numpy=False)
            torch.cuda.synchronize()
            times[i].append((time.perf_counter() - t0) * 1e3)
    ratios = np.asarray(times[0]) / np.asarray(times[1])
    return {"pairs": pairs,
            "median_ms": [float(np.median(t)) for t in times],
            "ratio_median": float(np.median(ratios)),
            "ratio_p10_p90": [float(r) for r in
                              np.percentile(ratios, [10, 90])]}


def device_ms_by_kind(torch, fn):
    """Device time of one call of ``fn`` by kind, from torch.profiler:
    K1/K2/K3, matrix products, copies, the rest — and the rest's eight
    largest kernels by name under ``"other_top"``, and the kernels of a
    train step's optimizer segment (the lowering's profiler range) under
    ``"optimizer_segment"``. None where the profiler sees no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.core.lowering import RANGE_OPTIMIZER

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = dict.fromkeys([k for k, _ in KERNEL_NAMES]
                          + ["matmul", "copy", "other"], 0.0)
    other = {}
    # the optimizer range's mark on the device is a span from its first
    # kernel to its last, not a kernel; the step runs on one stream, so
    # the kernels that start inside it are the optimizer's
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [e.time_range for e in on_device if e.name == RANGE_OPTIMIZER]
    seg = None
    if spans:
        seg = {"span_ms": sum(s.elapsed_us() for s in spans) / 1e3,
               "kernels_ms": sum(
                   e.time_range.elapsed_us() for e in on_device
                   if e.name != RANGE_OPTIMIZER and any(
                       s.start <= e.time_range.start < s.end
                       for s in spans)) / 1e3}
    for e in prof.key_averages():
        if e.key == RANGE_OPTIMIZER:
            continue
        # kernels and copies only: an aten op's device time is its
        # kernels' again
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us:
            continue
        name = e.key.lower()
        kind = next((k for k, kerns in KERNEL_NAMES
                     if any(kern in name for kern in kerns)), None)
        if kind is None:
            if any(w in name for w in ("gemm", "nvjet", "cutlass", "xmma",
                                       "matmul")):
                kind = "matmul"
            elif "memcpy" in name or "memset" in name:
                kind = "copy"
            else:
                kind = "other"
                short = e.key.replace("void at::native::", "")[:120]
                other[short] = other.get(short, 0.0) + us / 1e3
        kinds[kind] += us / 1e3
    if not sum(kinds.values()):
        return None
    kinds["other_top"] = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    kinds["optimizer_segment"] = seg
    return kinds


def add_busy(out, kinds, wall_ms):
    """Device busy ms, idle share of ``wall_ms`` and ms by kind into
    ``out`` ("not measured" where the profiler saw no device time)."""
    if kinds is None:
        out["device_busy_ms"] = "not measured"
        return
    seg = kinds.pop("optimizer_segment")
    busy = sum(v for k, v in kinds.items() if k != "other_top")
    if seg is not None:
        out["optimizer_segment"] = seg
    out.update({"device_busy_ms": busy,
                "device_idle_share": 1 - busy / wall_ms,
                "device_ms_by_kind": kinds})


def phase_serve(torch, fluid, dtype, card, then=None):
    """Serve the 8B-width forward in ``dtype`` and hold every answer to
    the same request run alone; every K1 launch must go to the variant
    the dtype routes to (bf16: flash_fwd_d128_wgmma, float32:
    flash_fwd_f32_d128_wgmma). Returns (K1 launches, serve stats).

    The tiers: in float32 each logit within TOL_LOGITS_F32 and the greedy
    token exact. In bfloat16 a 32-layer network amplifies rounding that
    differs between GEMM shapes (a batch of 4 x 128 rows vs 1 x n): the
    logits are held to a relative RMS error of TOL_LOGITS_BF16_RMS, and a
    greedy flip is allowed only where the top-1 margin is within twice
    that row's logit error. ``then(served)``, when given, runs last with
    the scope, programs, buckets, requests and their lone answers (the
    cluster_serve phase)."""
    from paddle_tpu_torch.models.llama import LLAMA3_8B, build_llama
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.serving import (BucketSpec, ServingConfig,
                                          ServingEngine)

    cfg = dataclasses.replace(LLAMA3_8B, dtype=dtype)   # all 32 layers
    tag = f"serve {dtype}"
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                                   dtype="int64", append_batch_size=False)
        logits, _ = build_llama(cfg, tokens)
    infer = main.clone(for_test=True)
    scope = fluid.Scope()
    exe = fluid.Executor()                     # the card: CUDAPlace(0)
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in scope.vars.values())
    log(f"{tag}: Llama-3-8B width (dim {cfg.dim}, {cfg.n_layers} layers, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, ffn "
        f"{cfg.ffn_hidden}, vocab {cfg.vocab_size}): "
        f"{n_params / 1e9:.3f} B params, startup on the card "
        f"{time.perf_counter() - t0:.2f} s")

    buckets = BucketSpec(batch_sizes=(1, 2, 4),
                         seq_lens={"tokens": (128, 256)})
    t0 = time.perf_counter()
    engine = ServingEngine(infer, ["tokens"], [logits], scope=scope,
                           buckets=buckets,
                           config=ServingConfig(max_wait_ms=20.0,
                                                default_timeout_s=600.0))
    construction = construction_costs(infer, ["tokens"], logits, engine,
                                      time.perf_counter() - t0)
    check(engine.optimize_report.counts() == SERVE_8B_OPTIMIZE_COUNTS,
          f"{tag}: optimize rewrote the Llama program "
          f"({engine.optimize_report.counts()}); the reference rewrites "
          "nothing")
    log(f"{tag}: construction (default optimize + verify of the "
        f"{cfg.n_layers}-layer program): " + json.dumps(construction))
    rng = np.random.RandomState(SEED)
    lengths = [40, 77, 128, 96, 130, 200, 256, 171]
    reqs = [rng.randint(0, cfg.vocab_size, (1, n)).astype(np.int64)
            for n in lengths]
    torch.cuda.reset_peak_memory_stats()
    try:
        # the main path: counts reset just before, read just after
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        warm = engine.warmup()
        warm_s = time.perf_counter() - t0
        start = threading.Barrier(len(reqs))

        def call(r):
            start.wait()
            return engine.infer({"tokens": r}, timeout=600.0)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(reqs)) as pool:
            answers = list(pool.map(call, reqs))
        wall = time.perf_counter() - t0
        launches = fa.flash_fwd.launches
        by_kernel = dict(fa.flash_fwd.launches_by_kernel)
        stats = engine.stats()
        engine.assert_no_recompiles()
    finally:
        engine.close()
    dispatches = warm["signatures"] + stats["batches_total"]
    log(f"{tag}: warmup {warm['signatures']} bucket signatures in "
        f"{warm_s:.2f} s; {len(reqs)} concurrent requests in "
        f"{stats['batches_total']} batches, no step build after warmup")
    check(stats["responses_total"] == len(reqs),
          f"responses {stats['responses_total']} != {len(reqs)}")
    check(launches == cfg.n_layers * dispatches,
          f"K1 launches {launches} != {cfg.n_layers} layers x "
          f"{dispatches} dispatches")
    _, variant = fa.kernel_for("flash_fwd", getattr(torch, dtype),
                               cfg.dim // cfg.n_heads)
    check(by_kernel[variant] == launches,
          f"K1 launches by kernel {by_kernel}: not all {variant}")
    log(f"{tag}: K1 launched {launches} times = {cfg.n_layers} x "
        f"{dispatches} dispatches, all {variant}")

    worst_abs = worst_rms = 0.0
    alones = []
    for n, r, ans in zip(lengths, reqs, answers):
        got = ans[0]
        bucket = buckets.seq_bucket("tokens", n)
        check(got.shape == (1, bucket, cfg.vocab_size),
              f"answer shape {got.shape}")
        got = got[:, :n]
        check(np.isfinite(got).all(), f"non-finite logits (len {n})")
        alone = exe.run(infer, feed={"tokens": r}, fetch_list=[logits],
                        scope=scope)[0]
        if then is not None:
            alones.append(alone)
        err = np.abs(got - alone)
        rel_rms = float(np.sqrt((err ** 2).mean() / (alone ** 2).mean()))
        worst_abs = max(worst_abs, float(err.max()))
        worst_rms = max(worst_rms, rel_rms)
        g_tok, a_tok = int(got[0, -1].argmax()), int(alone[0, -1].argmax())
        top2 = np.sort(alone[0, -1])[-2:]
        margin = float(top2[1] - top2[0])
        row_err = float(err[0, -1].max())
        log(f"{tag}: request len {n}: vs alone max|d logits| "
            f"{float(err.max()):.3e}, rel rms {rel_rms:.3e}; greedy "
            f"{g_tok} vs {a_tok} (alone top-1 margin {margin:.3e})")
        if dtype == "float32":
            rtol, atol = TOL_LOGITS_F32
            check(bool((err <= atol + rtol * np.abs(alone)).all()),
                  f"len {n}: logits differ from the request run alone "
                  f"beyond rtol={rtol}, atol={atol}")
            check(g_tok == a_tok, f"len {n}: greedy token {g_tok} != "
                                  f"{a_tok} of the request run alone")
        else:
            check(rel_rms <= TOL_LOGITS_BF16_RMS,
                  f"len {n}: logits differ from the request run alone by "
                  f"rel rms {rel_rms:.3e} > {TOL_LOGITS_BF16_RMS}")
            # a flip is explicable only by a logit error of half the margin
            check(g_tok == a_tok or margin <= 2 * row_err,
                  f"len {n}: greedy token {g_tok} != {a_tok} of the "
                  f"request run alone, with top-1 margin {margin:.3e} > 2 "
                  f"x the row's logit error {row_err:.3e}")
    lat = stats["request_latency"]
    long_batch, _, _ = buckets.pad_batch(
        [{"tokens": r} for r, n in zip(reqs, lengths) if n > 128][:4])
    dispatch = where_the_time_goes(torch, exe, infer, logits, scope,
                                   long_batch)
    log(f"{tag}: one dispatch: " + json.dumps(dispatch))
    serve = {"dtype": dtype, "requests": len(reqs), "wall_s": wall,
             "requests_per_s": len(reqs) / wall,
             "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"],
             "batches": stats["batches_total"],
             "batch_p50_ms": stats["batch_latency"]["p50_ms"],
             "k1_launches": launches, "k1_variant": variant,
             "dispatches": dispatches,
             "layers": cfg.n_layers,
             "max_abs_logit_err_vs_alone": worst_abs,
             "max_rel_rms_logit_err_vs_alone": worst_rms,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "construction": construction, "card": card}
    log(f"{tag}: " + json.dumps(serve))
    if then is not None:
        then({"cfg": cfg, "infer": infer, "logits": logits, "scope": scope,
              "buckets": buckets, "reqs": reqs, "lengths": lengths,
              "alone": alones, "warm_signatures": warm["signatures"],
              "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"],
              "peak_bytes": torch.cuda.max_memory_allocated()})
    return launches, dict(serve, one_dispatch=dispatch)


def construction_costs(infer, feed_names, fetch, engine, engine_s):
    """The serving engine's construction-time work on the host clock:
    the whole constructor (a clone and the default optimize, folding on
    the card), the optimize pipeline alone (the engine's own
    ``optimize_ms``), and ``Program.verify`` at the executor's level
    ("cheap", once per program version) and in full. The engine must
    hold a report, and the verifier must find no error."""
    from paddle_tpu_torch.analysis import errors
    check(engine.optimize_report is not None,
          "the engine holds no optimize report: its rewrite failed")
    out = {"engine_ctor_ms": engine_s * 1e3,
           "optimize_ms": engine.optimize_ms,
           "ops_before": len(infer.global_block().ops),
           "ops_after": len(engine.program.global_block().ops),
           "report": engine.optimize_report.to_dict()}
    for level in ("cheap", "full"):
        t0 = time.perf_counter()
        diags = infer.verify(fetch_list=[fetch.name], feed_names=feed_names,
                             level=level)
        out[f"verify_{level}_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"verify_{level}_findings"] = sorted({d.code for d in diags})
        check(not errors(diags),
              f"verify ({level}) found errors: "
              + "; ".join(d.format() for d in errors(diags)))
    return out


def build_train(fluid, cfg, lr, policy=None, **llama_kw):
    """``build_llama(cfg, tokens, targets, **llama_kw)`` →
    ``Adam(lr).minimize``, in fresh programs seeded from SEED, with
    ``memory_optimize(policy)`` where a remat policy is given. Returns
    (main, startup, loss)."""
    from paddle_tpu_torch.models.llama import build_llama
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                                   dtype="int64", append_batch_size=False)
        targets = fluid.layers.data(name="targets", shape=[-1, -1],
                                    dtype="int64", append_batch_size=False)
        _, loss = build_llama(cfg, tokens, targets, **llama_kw)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    if policy:
        fluid.memory_optimize(main, policy=policy)
    return main, startup, loss


def train_feed(vocab, batch, seq):
    toks = np.random.RandomState(SEED).randint(0, vocab, (batch, seq)) \
        .astype(np.int64)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def phase_train(torch, fluid, fa, card):
    """Train the 8B-width model, cut to TRAIN_LAYERS layers, in bf16 on
    one fixed batch, unrolled with the full logits (``build_llama``'s
    defaults); every K1, K2 and K3 launch must be the tensor-core
    kernel's, once per layer per step. Returns (launches by kernel
    symbol, train stats)."""
    return train_8b(torch, fluid, fa, card, "train", "l0.wq", 1)


def phase_train_stack(torch, fluid, fa, card, train):
    """The main path of this slice: the reference's own train benchmark
    (``bench.py`` ``transformer_main``: ``build_llama(shard_pp=True,
    fused_head_chunk=2048, remat=True)``, ``Adam(1e-4)``) at the 8B
    width and ``phase_train``'s depth, batch and steps: the layer-stacked
    decoder with each layer recomputed in the backward pass (K1 twice a
    layer a step, K2 and K3 once) and the vocab-chunked fused loss
    (128256 = 62 x 2048 + 1280: 63 chunks, the last slid back by 768
    columns). Its peak memory must be below ``train``'s (phase_train's
    stats, from this run). Returns (launches by kernel symbol, stats)."""
    by_kernel, stats = train_8b(
        torch, fluid, fa, card, "train_stack", "blocks.wq", 2,
        shard_pp=True, fused_head_chunk=STACK_CHUNK, remat=True)
    check(stats["peak_mem_gb"] < train["peak_mem_gb"],
          f"train_stack peak {stats['peak_mem_gb']:.2f} GB is not below "
          f"the unrolled step's {train['peak_mem_gb']:.2f} GB")
    keys = ("step_ms_median", "step_ms_min", "step_ms_max", "tokens_per_s",
            "peak_mem_gb")
    beside = {name: dict({k: st[k] for k in keys},
                         **{k: st["one_step"].get(k, "not measured")
                            for k in ("device_busy_ms", "device_idle_share",
                                      "device_ms_by_kind",
                                      "optimizer_segment")})
              for name, st in (("train", train), ("train_stack", stats))}
    log("train_stack beside train: " + json.dumps(beside))
    return by_kernel, stats


def train_8b(torch, fluid, fa, card, tag, probe_name, k1_per_layer,
             **llama_kw):
    """Train the 8B-width model, cut to TRAIN_LAYERS layers, in bf16 on
    one fixed batch (``build_llama(**llama_kw)``, ``Adam(1e-4)`` as
    bench.py): TRAIN_WARMUP + TRAIN_STEPS steps with finite, falling
    loss, the first near ln V + dim·0.02²/2, K1 launched
    ``k1_per_layer`` times and K2/K3 once per layer per step (each time
    on the tensor cores), ``probe_name`` moved; step time, tokens/s,
    peak memory and one step's device time by kind. Returns (launches by
    kernel symbol, stats)."""
    from paddle_tpu_torch.models.llama import LLAMA3_8B

    cfg = dataclasses.replace(LLAMA3_8B, n_layers=TRAIN_LAYERS)
    main, startup, loss = build_train(fluid, cfg, 1e-4,   # bench.py's lr
                                      **llama_kw)
    scope = fluid.Scope()
    exe = fluid.Executor()                     # the card: CUDAPlace(0)
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in (scope.find_var(v.name)
                                       for v in main.all_parameters()))
    log(f"{tag}: Llama-3-8B width (dim {cfg.dim}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} kv, ffn {cfg.ffn_hidden}, vocab "
        f"{cfg.vocab_size}), {cfg.n_layers} of 32 layers, bf16, Adam, "
        f"build_llama({llama_kw}): {n_params / 1e9:.3f} B params, startup "
        f"on the card {time.perf_counter() - t0:.2f} s")
    feed = train_feed(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)

    def probe():
        w = scope.find_var(probe_name)
        return w.reshape(-1, w.shape[-1])[:8, :8].float().clone()

    before = probe()
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    # the main path: counts reset just before, read just after
    fa.reset_launch_counts()
    for step in range(TRAIN_WARMUP + TRAIN_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(np.asarray(out[0]).reshape(())))
        log(f"{tag}: step {step}: loss {losses[-1]:.4f}, "
            f"{step_s[-1] * 1e3:.1f} ms")
    launches = [w.launches for w in wrappers]
    by_kernel = launches_by_kernel(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    check(all(math.isfinite(x) for x in losses),
          f"{tag}: non-finite loss {losses}")
    # random init: logits ~ N(0, dim * INIT_STD^2) (the final rms_norm
    # makes the hidden state's squared norm dim), so the expected first
    # loss is ln V + dim * INIT_STD^2 / 2
    expected = math.log(cfg.vocab_size) + cfg.dim * INIT_STD ** 2 / 2
    check(abs(losses[0] - expected) < 0.5,
          f"{tag}: first loss {losses[0]:.4f} not within 0.5 of "
          f"{expected:.4f} (ln V = {math.log(cfg.vocab_size):.4f})")
    check(losses[-1] < losses[0],
          f"{tag}: loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    for name, w, n, per_layer in zip(("K1", "K2", "K3"), wrappers, launches,
                                     (k1_per_layer, 1, 1)):
        check(n == per_layer * cfg.n_layers * n_steps,
              f"{tag}: {name} launched {n} times, not {per_layer} x "
              f"{cfg.n_layers} layers x {n_steps} steps")
        _, variant = fa.kernel_for(w.__name__, torch.bfloat16, 128)
        check(by_kernel[variant] == n,
              f"{tag}: {name} launches by kernel {w.launches_by_kernel}: "
              f"not all {variant}")
    changed = float((probe() - before).abs().max())
    check(changed > 0, f"{tag}: parameter {probe_name} did not change")
    log(f"{tag}: K1/K2/K3 launched {launches} times = ({k1_per_layer}, 1, "
        f"1) x {cfg.n_layers} layers x {n_steps} steps ({by_kernel}); "
        f"{probe_name} moved by up to {changed:.3e}")

    timed = sorted(step_s[TRAIN_WARMUP:])
    step_ms = timed[len(timed) // 2] * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    breakdown = {}
    add_busy(breakdown, device_ms_by_kind(
        torch, lambda: exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope)), step_ms)
    breakdown.setdefault("optimizer_segment", "not measured")
    stats = {"layers": cfg.n_layers, "params_b": n_params / 1e9,
             "build_llama": llama_kw,
             "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
             "losses": losses, "first_loss_expected": expected,
             "step_ms_median": step_ms,
             "step_ms_min": timed[0] * 1e3, "step_ms_max": timed[-1] * 1e3,
             "tokens_per_s": tokens / (step_ms / 1e3),
             "peak_mem_gb": peak_gb, "launches_k1_k2_k3": launches,
             "launches_by_kernel": by_kernel,
             "one_step": breakdown, "card": card}
    log(f"{tag}: " + json.dumps(stats))
    return by_kernel, stats


def train_card_vs_cpu(torch, fluid, cfg, lr, batch, seq, tag, **llama_kw):
    """One float32 step of ``cfg`` (``build_llama(**llama_kw)``) on the
    card and on the CPU from one startup scope (TF32 off): the loss and
    every parameter's gradient within the f32 gradient tier, then 3 Adam
    steps' losses within the loss tier. Returns the stats."""
    from paddle_tpu_torch import weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main, startup, loss = build_train(fluid, cfg, lr, **llama_kw)
    gpu_scope = fluid.Scope()
    gpu = fluid.Executor()
    gpu.run(startup, scope=gpu_scope)
    cpu_scope = weights.load_state(fluid.Scope(),
                                   weights.dump_state(gpu_scope),
                                   torch.device("cpu"))
    cpu = fluid.Executor(fluid.CPUPlace())
    feed = train_feed(cfg.vocab_size, batch, seq)
    grads = sorted(v for v in main.global_block().vars
                   if v.endswith("@GRAD"))
    got = gpu.run(main, feed=feed, fetch_list=[loss] + grads,
                  scope=gpu_scope)
    want = cpu.run(main, feed=feed, fetch_list=[loss] + grads,
                   scope=cpu_scope)
    worst = 0.0
    for name, g, w in zip(["loss"] + grads, got, want):
        rtol, atol = TOL_GRAD_F32
        err = np.abs(g - w)
        check(bool((err <= atol + rtol * np.abs(w)).all()),
              f"{tag}: {name} on the card differs from the CPU by "
              f"{float(err.max()):.3e} (rtol={rtol}, atol={atol})")
        worst = max(worst, float((err / (atol + rtol * np.abs(w))).max()))
    lg, lc = [], []
    for _ in range(3):
        lg.append(float(gpu.run(main, feed=feed, fetch_list=[loss],
                                scope=gpu_scope)[0].reshape(())))
        lc.append(float(cpu.run(main, feed=feed, fetch_list=[loss],
                                scope=cpu_scope)[0].reshape(())))
    check(np.allclose(lg, lc, rtol=TOL_LOSS_F32, atol=0),
          f"{tag}: Adam losses differ: card {lg} vs CPU {lc}")
    return {"config": dataclasses.asdict(cfg), "build_llama": llama_kw,
            "batch": [batch, seq],
            "loss_step1": [float(got[0].reshape(())),
                           float(want[0].reshape(()))],
            "grads_checked": len(grads),
            "worst_err_over_tolerance": worst,
            "adam_losses_card": lg, "adam_losses_cpu": lc}


def launches_by_kernel(fa):
    """{kernel symbol: launches} over the three wrappers, and the plain
    route's calls under "<wrapper> plain"."""
    return {(f"{w.__name__} {sym}" if sym == fa.PLAIN else sym): n
            for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
            for sym, n in w.launches_by_kernel.items()}


def phase_train_parity(torch, fluid, fa, card):
    """One float32 step of a narrow model with head dim 128 on the card
    (K1, K2 and K3 on flash_fwd_f32_d128_wgmma,
    flash_bwd_dq_f32_d128_wgmma and flash_bwd_dkv_f32_d128_wgmma: 2
    layers x 4 steps, 8 launches each) and on
    the CPU (the plain versions), from one startup scope: the loss and
    every parameter's gradient within the f32 gradient tier, then 3 Adam
    steps' losses within the loss tier. Returns (launches by kernel
    symbol, stats)."""
    from paddle_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(vocab_size=2048, dim=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_hidden=1024, dtype="float32")
    # this path's counts: reset just before, read after its last step
    fa.reset_launch_counts()
    out = train_card_vs_cpu(torch, fluid, cfg, 1e-3, 2, 256,
                            "train parity f32")
    by_kernel = launches_by_kernel(fa)
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        variant = f32_kernel(torch, fa, w.__name__, cfg.dim // cfg.n_heads)
        check(w.launches == cfg.n_layers * 4
              and by_kernel[variant] == w.launches,
              f"f32 {w.__name__} launches by kernel "
              f"{w.launches_by_kernel}: not {cfg.n_layers} layers x 4 "
              f"steps of {variant}")
    out.update(launches_by_kernel=by_kernel, card=card)
    log("train parity f32: " + json.dumps(out))
    return by_kernel, out


PARITY_CFG = dict(vocab_size=2048, dim=512, n_layers=2, n_heads=4,
                  n_kv_heads=2, ffn_hidden=1024, dtype="float32")


def phase_train_stack_parity(torch, fluid, fa, card):
    """The float32 parity model (``phase_train_parity``'s) built as
    ``phase_train_stack`` builds the 8B one — stacked, remat, its fused
    loss in chunks of PARITY_CHUNK (the last slides back) — on the card
    (K1 twice a layer a step, K2 and K3 once, on the float32 kernels of
    head dim 128) against the CPU at the f32 tiers. Then the same step on
    the card with ``remat=False`` and under ``memory_optimize`` with
    ``nothing_saveable`` and ``dots_saveable`` (a checkpoint of the
    whole forward around each layer's own) gives the loss and gradients
    of ``remat=True`` within the f32 gradient tier; whether they are
    bit-identical is reported. Returns (launches by kernel symbol,
    stats)."""
    from paddle_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(**PARITY_CFG)
    stack = dict(shard_pp=True, fused_head_chunk=PARITY_CHUNK, remat=True)
    fa.reset_launch_counts()
    out = train_card_vs_cpu(torch, fluid, cfg, 1e-3, 2, 256,
                            "train_stack parity f32", **stack)
    by_kernel = launches_by_kernel(fa)
    for w, per_layer in zip((fa.flash_fwd, fa.flash_bwd_dq,
                             fa.flash_bwd_dkv), (2, 1, 1)):
        variant = f32_kernel(torch, fa, w.__name__, cfg.dim // cfg.n_heads)
        check(w.launches == per_layer * cfg.n_layers * 4
              and by_kernel[variant] == w.launches,
              f"train_stack parity f32: {w.__name__} launches by kernel "
              f"{w.launches_by_kernel}: not {per_layer} x {cfg.n_layers} "
              f"layers x 4 steps of {variant}")

    feed = train_feed(cfg.vocab_size, 2, 256)
    variants = {"remat": dict(stack),
                "no_remat": dict(stack, remat=False),
                "nothing_saveable": dict(stack, policy="nothing_saveable"),
                "dots_saveable": dict(stack, policy="dots_saveable")}
    results = {}
    for name, kw in variants.items():
        main, startup, loss = build_train(fluid, cfg, 1e-3, **kw)
        scope = fluid.Scope()
        exe = fluid.Executor()
        exe.run(startup, scope=scope)
        grads = sorted(v for v in main.global_block().vars
                       if v.endswith("@GRAD"))
        fa.reset_launch_counts()
        results[name] = (grads, exe.run(main, feed=feed,
                                        fetch_list=[loss] + grads,
                                        scope=scope),
                         fa.flash_fwd.launches)
    grads, want, _ = results["remat"]
    rtol, atol = TOL_GRAD_F32
    same = {}
    for name, (g_names, got, k1) in results.items():
        check(g_names == grads, f"{name}: other gradients {g_names}")
        for n, g, w in zip(["loss"] + grads, got, want):
            err = np.abs(g - w)
            check(bool((err <= atol + rtol * np.abs(w)).all()),
                  f"train_stack parity f32 {name}: {n} differs from "
                  f"remat=True by {float(err.max()):.3e}")
        same[name] = {"bit_identical": all(np.array_equal(g, w)
                                           for g, w in zip(got, want)),
                      "max_abs_diff": max(float(np.abs(g - w).max())
                                          for g, w in zip(got, want)),
                      "k1_launches": k1}
    # K1 a layer: once without remat, twice with, three times when the
    # whole forward's checkpoint nests around each layer's
    for name, k1 in (("no_remat", 1), ("remat", 2),
                     ("nothing_saveable", 3), ("dots_saveable", 3)):
        check(same[name]["k1_launches"] == k1 * cfg.n_layers,
              f"{name}: K1 launched {same[name]['k1_launches']} times, "
              f"not {k1} x {cfg.n_layers} layers")
    out.update(launches_by_kernel=by_kernel, remat_variants=same,
               card=card)
    log("train_stack parity f32: " + json.dumps(out))
    return by_kernel, out


def phase_amp(torch, fluid, fa, card):
    """AMP on the 8B width, cut to AMP_LAYERS layers, float32 master
    state: the unrolled program and the stacked one (``phase_train_
    stack``'s knobs), each under ``amp_transpile`` O1 and O2 for
    AMP_STEPS Adam steps on one batch of 2 x 2048 from a fresh startup:
    finite, falling losses; K1-K3 on the bf16 tensor-core kernels (the
    f32 program's products run in bf16, attention among them); every
    parameter and Adam moment still float32; and the first loss against
    the same program's forward without AMP (float32, TF32 off) within
    the bf16 tier TOL_HALF_RTOL. Returns (launches by kernel symbol of
    each run, stats)."""
    from paddle_tpu_torch.models.llama import LLAMA3_8B

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(LLAMA3_8B, n_layers=AMP_LAYERS,
                              dtype="float32")
    feed = train_feed(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    out, launches = {}, {}
    for model, kw, k1_per_layer in (
            ("unrolled", {}, 1),
            ("stacked", dict(shard_pp=True, fused_head_chunk=STACK_CHUNK,
                             remat=True), 2)):
        main, startup, loss = build_train(fluid, cfg, 1e-4, **kw)

        def fresh():
            # a fresh Executor draws the startup's numbers anew: the same
            # initial state for every run
            scope = fluid.Scope()
            exe = fluid.Executor()
            exe.run(startup, scope=scope)
            return scope, exe

        scope, exe = fresh()
        ref = float(np.asarray(exe.run(
            main.clone(for_test=True), feed=feed, fetch_list=[loss],
            scope=scope)[0]).reshape(()))
        del scope, exe
        free_card(torch)
        for level in ("O1", "O2"):
            tag = f"amp {model} {level}"
            prog = fluid.transpiler.amp_transpile(main.clone(), level=level)
            scope, exe = fresh()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            losses = [float(np.asarray(exe.run(
                prog, feed=feed, fetch_list=[loss],
                scope=scope)[0]).reshape(())) for _ in range(AMP_STEPS)]
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            by_kernel = launches_by_kernel(fa)
            check(all(math.isfinite(x) for x in losses),
                  f"{tag}: non-finite loss {losses}")
            check(losses[-1] < losses[0],
                  f"{tag}: loss did not fall: {losses}")
            check(abs(losses[0] - ref) <= TOL_HALF_RTOL * abs(ref),
                  f"{tag}: first loss {losses[0]:.5f} vs {ref:.5f} without "
                  f"AMP (rtol {TOL_HALF_RTOL})")
            for name, w, per_layer in zip(("K1", "K2", "K3"), wrappers,
                                          (k1_per_layer, 1, 1)):
                _, variant = fa.kernel_for(w.__name__, torch.bfloat16, 128)
                n = per_layer * cfg.n_layers * AMP_STEPS
                check(w.launches == n and by_kernel[variant] == n,
                      f"{tag}: {name} launches by kernel "
                      f"{w.launches_by_kernel}: not {n} of {variant}")
            state = {v.name: scope.find_var(v.name).dtype
                     for v in main.global_block().vars.values()
                     if v.persistable and scope.find_var(v.name) is not None
                     and scope.find_var(v.name).is_floating_point()}
            check(all(dt == torch.float32 for dt in state.values()),
                  f"{tag}: state not float32: "
                  f"{ {k: str(v) for k, v in state.items()} }")
            check(any("moment1" in n for n in state),
                  f"{tag}: no Adam moment in the scope")
            out[tag] = {"losses": losses, "first_loss_without_amp": ref,
                        "first_loss_rel_diff": abs(losses[0] - ref) / abs(ref),
                        "steps_s": took, "float32_state": len(state),
                        "launches_by_kernel": by_kernel}
            launches[tag] = by_kernel
            del scope, exe
            free_card(torch)
    out = {"layers": cfg.n_layers, "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "runs": out, "card": card}
    log("amp: " + json.dumps(out))
    return launches, out


def phase_nan_guard(torch, fluid, fa, card):
    """The NaN guard on the card, on ``phase_train_stack_parity``'s
    stacked float32 model: with clean weights the guarded step equals
    the unguarded one (loss and every gradient within the f32 gradient
    tier; which are bit-identical is reported); with one
    planted inf in ``blocks.wq`` ``Executor.run`` raises
    FloatingPointError naming the same op outputs as the CPU run of the
    same step; ``repeats=2`` raises ValueError."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(**PARITY_CFG)
    main, startup, loss = build_train(
        fluid, cfg, 1e-3, shard_pp=True, fused_head_chunk=PARITY_CHUNK,
        remat=True)
    guarded = fluid.debugger.enable_nan_guard(main.clone())
    gpu = fluid.Executor()
    cpu = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    gpu.run(startup, scope=scope)
    state = weights.dump_state(scope)
    feed = train_feed(cfg.vocab_size, 2, 256)
    grads = sorted(v for v in main.global_block().vars
                   if v.endswith("@GRAD"))
    plain_scope = weights.load_state(fluid.Scope(), state, gpu.device)
    got = gpu.run(guarded, feed=feed, fetch_list=[loss] + grads,
                  scope=scope)
    want = gpu.run(main, feed=feed, fetch_list=[loss] + grads,
                   scope=plain_scope)
    rtol, atol = TOL_GRAD_F32
    for n, g, w in zip(["loss"] + grads, got, want):
        err = np.abs(g - w)
        check(bool((err <= atol + rtol * np.abs(w)).all()),
              f"nan_guard: {n} of the guarded step differs from the "
              f"unguarded one's by {float(err.max()):.3e}")
    # the embedding's gradient sums rows in an order the device picks
    identical = [n for n, g, w in zip(["loss"] + grads, got, want)
                 if np.array_equal(g, w)]

    wq = state["blocks.wq"].copy()
    wq[0, 0, 0] = np.inf
    messages = {}
    for name, exe, dev in (("card", gpu, gpu.device),
                           ("cpu", cpu, torch.device("cpu"))):
        sc = weights.load_state(fluid.Scope(), dict(state, **{
            "blocks.wq": wq}), dev)
        try:
            exe.run(guarded, feed=feed, fetch_list=[loss], scope=sc)
        except FloatingPointError as e:
            messages[name] = str(e)
        check(name in messages, f"nan_guard: no FloatingPointError on the "
                                f"{name} with an inf in blocks.wq")
    check(messages["card"] == messages["cpu"],
          f"nan_guard: the card names {messages['card']!r}, the CPU "
          f"{messages['cpu']!r}")
    try:
        gpu.run(guarded, feed=feed, fetch_list=[loss], scope=scope,
                repeats=2)
        raised = False
    except ValueError:
        raised = True
    check(raised, "nan_guard: repeats=2 with the guard did not raise")
    out = {"clean_step_within_f32_tier": True,
           "bit_identical": len(identical) == len(grads) + 1,
           "differ_in_bits": sorted(set(["loss"] + grads) - set(identical)),
           "grads": len(grads),
           "tripped": messages["card"], "card": card}
    log("nan_guard: " + json.dumps(out))
    return out


def phase_plain_route(torch, fluid, fa, card):
    """LLAMA_TINY, whose head dim (16) no kernel takes, on the card: its
    attention takes the plain versions, as the reference's gate sends
    such shapes to its own plain path on every backend. One train step
    and 3 Adam steps match the CPU (train_card_vs_cpu), and
    ServingEngine's answers match CPU Executor.run of each request alone
    at TOL_LOGITS_F32; every attention call, forward and backward, is
    counted as the plain route and no kernel launches."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models.llama import LLAMA_TINY, build_llama
    from paddle_tpu_torch.serving import (BucketSpec, ServingConfig,
                                          ServingEngine)

    cfg = LLAMA_TINY
    d = cfg.dim // cfg.n_heads
    for w in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        try:
            fa.kernel_for(w, torch.float32, d)
        except ValueError:
            continue
        raise SmokeFailure(f"{w}: a kernel takes head dim {d}")
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    # the main path of this phase: counts reset just before, read after
    fa.reset_launch_counts()
    train = train_card_vs_cpu(torch, fluid, cfg, 1e-3, 2, 64,
                              "LLAMA_TINY train")
    steps = 4
    for w in wrappers:
        check(w.launches == 0 and
              w.launches_by_kernel[fa.PLAIN] == cfg.n_layers * steps,
              f"LLAMA_TINY train: {w.__name__} {w.launches_by_kernel}, "
              f"launches {w.launches}: not {cfg.n_layers} layers x "
              f"{steps} steps of the plain route")
    train_calls = launches_by_kernel(fa)

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                                   dtype="int64", append_batch_size=False)
        logits, _ = build_llama(cfg, tokens)
    infer = main.clone(for_test=True)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    cpu_scope = weights.load_state(fluid.Scope(), weights.dump_state(scope),
                                   torch.device("cpu"))
    cpu = fluid.Executor(fluid.CPUPlace())
    buckets = BucketSpec(batch_sizes=(1, 2, 4), seq_lens={"tokens": (16, 32)})
    engine = ServingEngine(infer, ["tokens"], [logits], scope=scope,
                           buckets=buckets,
                           config=ServingConfig(max_wait_ms=20.0,
                                                default_timeout_s=120.0))
    check(engine.optimize_report is not None,
          "LLAMA_TINY serve: the engine holds no optimize report: its "
          "rewrite failed")
    rng = np.random.RandomState(SEED)
    lengths = [5, 16, 23, 32]
    reqs = [rng.randint(0, cfg.vocab_size, (1, n)).astype(np.int64)
            for n in lengths]
    fa.reset_launch_counts()
    try:
        warm = engine.warmup()
        with ThreadPoolExecutor(len(reqs)) as pool:
            answers = list(pool.map(
                lambda r: engine.infer({"tokens": r}, timeout=120.0), reqs))
        stats = engine.stats()
        engine.assert_no_recompiles()
    finally:
        engine.close()
    dispatches = warm["signatures"] + stats["batches_total"]
    check(fa.flash_fwd.launches == 0 and fa.flash_fwd.launches_by_kernel[
              fa.PLAIN] == cfg.n_layers * dispatches,
          f"LLAMA_TINY serve: K1 {fa.flash_fwd.launches_by_kernel}: not "
          f"{cfg.n_layers} layers x {dispatches} dispatches of the plain "
          f"route")
    worst = 0.0
    for n, r, ans in zip(lengths, reqs, answers):
        got = ans[0][:, :n]
        want = cpu.run(infer, feed={"tokens": r}, fetch_list=[logits],
                       scope=cpu_scope)[0]
        rtol, atol = TOL_LOGITS_F32
        err = np.abs(got - want)
        check(got.shape == want.shape and np.isfinite(got).all()
              and bool((err <= atol + rtol * np.abs(want)).all()),
              f"LLAMA_TINY serve: len {n}: logits differ from the CPU by "
              f"{float(err.max()):.3e} (rtol={rtol}, atol={atol})")
        worst = max(worst, float((err / (atol + rtol * np.abs(want))).max()))
    out = {"head_dim": d, "train": dict(train, calls=train_calls),
           "serve": {"requests": len(reqs), "dispatches": dispatches,
                     "worst_err_over_tolerance": worst,
                     "calls": launches_by_kernel(fa)},
           "card": card}
    log("plain route LLAMA_TINY: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Transformer-base: the main path of ROADMAP item 1b
# ---------------------------------------------------------------------------


def build_transformer_train(fluid, cfg, src_seq, tgt_seq, padded,
                            labels=True):
    """``build_transformer(cfg, src, tgt, lbl[, src_lengths,
    tgt_lengths])`` and, with labels, ``noam_decay(d_model,
    TF_NOAM_WARMUP)`` feeding ``Adam(lr, beta1=0.9, beta2=0.98,
    epsilon=1e-9)``, in fresh programs seeded from SEED. Returns (main,
    startup, logits, loss, lr)."""
    from paddle_tpu_torch.models.transformer import build_transformer
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        def data(name, shape):
            return fluid.layers.data(name=name, shape=shape, dtype="int64",
                                     append_batch_size=False)
        src, tgt = data("src", [-1, src_seq]), data("tgt", [-1, tgt_seq])
        lbl = data("lbl", [-1, tgt_seq]) if labels else None
        kw = dict(src_lengths=data("src_len", [-1]),
                  tgt_lengths=data("tgt_len", [-1])) if padded else {}
        logits, loss = build_transformer(cfg, src, tgt, lbl, **kw)
        lr = None
        if labels:
            lr = fluid.layers.noam_decay(cfg.d_model, TF_NOAM_WARMUP)
            fluid.optimizer.Adam(lr, beta1=0.9, beta2=0.98,
                                 epsilon=1e-9).minimize(loss)
    return main, startup, logits, loss, lr


def transformer_feed(cfg, batch, src_seq, tgt_seq, padded, labels=True,
                     seed=SEED):
    """Random token ids (as models/zoo.py's transformer feed) and, when
    ``padded``, source and target lengths drawn in TF_LEN_RANGE (capped
    at the sequence)."""
    r = np.random.RandomState(seed)
    feed = {"src": r.randint(0, cfg.src_vocab_size, (batch, src_seq)),
            "tgt": r.randint(0, cfg.tgt_vocab_size, (batch, tgt_seq))}
    if labels:
        feed["lbl"] = r.randint(0, cfg.tgt_vocab_size, (batch, tgt_seq))
    if padded:
        lo, hi = TF_LEN_RANGE
        feed["src_len"] = r.randint(lo, min(hi, src_seq) + 1, batch)
        feed["tgt_len"] = r.randint(lo, min(hi, tgt_seq) + 1, batch)
    return {k: v.astype(np.int64) for k, v in feed.items()}


def noam_closed_form(d_model, counter):
    """The noam rate at LR-counter value ``counter`` (0 on the first
    run): d^-0.5 * min(s^-0.5, s * warmup^-1.5), s = max(counter, 1)."""
    s = max(counter, 1)
    return d_model ** -0.5 * min(s ** -0.5, s * TF_NOAM_WARMUP ** -1.5)


def first_loss_expected(cfg):
    """The expected first loss of a random-init Transformer: the final
    layer_norm gives each target row a squared norm of d_model, and the
    Xavier-uniform ``out_proj`` [d_model, V] has variance
    2 / (d_model + V), so the logits are ~ N(0, s2) with
    s2 = 2 d_model / (d_model + V), and the (label-smoothed) cross
    entropy is ln V + s2 / 2 in expectation."""
    v = cfg.tgt_vocab_size
    return math.log(v) + cfg.d_model / (cfg.d_model + v)


def check_losses(tag, cfg, losses):
    check(all(math.isfinite(x) for x in losses),
          f"{tag}: non-finite loss {losses}")
    expected = first_loss_expected(cfg)
    check(abs(losses[0] - expected) < 0.5,
          f"{tag}: first loss {losses[0]:.4f} not within 0.5 of "
          f"{expected:.4f} (ln V = {math.log(cfg.tgt_vocab_size):.4f})")
    check(losses[-1] < losses[0],
          f"{tag}: loss did not fall: {losses[0]:.5f} -> {losses[-1]:.5f}")
    return expected


def check_tf_launches(torch, fa, tag, by_kernel, per_step, steps):
    """Each of K1, K2 and K3 launched ``per_step`` times a step, every
    launch the float32 kernel's of the Transformer's head dim and none on
    the plain route."""
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        variant = f32_kernel(torch, fa, w.__name__, TF_HEAD_DIM)
        n = per_step * steps
        check(w.launches == n and by_kernel[variant] == n
              and not w.launches_by_kernel[fa.PLAIN],
              f"{tag}: {w.__name__} launches by kernel "
              f"{w.launches_by_kernel}: not {per_step} x {steps} steps of "
              f"{variant}")


def train_transformer(torch, fluid, fa, card, tag, src_seq, tgt_seq,
                      padded, steps, attn_per_layer, scope=None, feed=None,
                      validate=None):
    """TRANSFORMER_BASE at full width and depth in float32 (TF32 off)
    through ``Executor.run`` on the card, on one fixed batch of TF_BATCH
    sequences, with the base recipe (noam + Adam): finite losses, the
    first near :func:`first_loss_expected`, the last below the first,
    the fetched rate equal to its closed form at every step, the LR
    counter one a step, and K1/K2/K3 ``attn_per_layer`` launches a
    decoder layer a step on the float32 kernels. ``scope``: go on
    training that scope (its parameters, Adam moments and LR counter)
    instead of a fresh startup; ``feed``: that batch instead of a new
    one from SEED; ``validate``: ``Executor.run``'s verifier mode (None:
    its default). Returns (launches by kernel symbol, stats, (main,
    scope, feed))."""
    from paddle_tpu_torch.models.transformer import TRANSFORMER_BASE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TRANSFORMER_BASE
    main, startup, _, loss, lr = build_transformer_train(
        fluid, cfg, src_seq, tgt_seq, padded)
    exe = fluid.Executor()                     # the card: CUDAPlace(0)
    t0 = time.perf_counter()
    counter0 = 0
    if scope is None:
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        torch.cuda.synchronize()
    else:
        counter0 = int(scope.find_var("@LR_DECAY_COUNTER@").reshape(())) + 1
    n_params = sum(scope.find_var(p.name).numel()
                   for p in main.all_parameters() if p.trainable)
    log(f"{tag}: Transformer-base (d_model {cfg.d_model}, {cfg.n_head} "
        f"heads of {cfg.d_model // cfg.n_head}, {cfg.n_encoder_layers} + "
        f"{cfg.n_decoder_layers} layers, d_ff {cfg.d_ff}, vocab "
        f"{cfg.tgt_vocab_size}, dropout {cfg.dropout}, label smoothing "
        f"{cfg.label_smooth_eps}, {cfg.dtype}), {n_params / 1e6:.2f} M "
        f"trainable params, batch {TF_BATCH} x {src_seq} source / "
        f"{tgt_seq} target tokens, lengths {padded}, "
        + (f"startup {time.perf_counter() - t0:.2f} s" if not counter0
           else f"going on from LR counter {counter0}"))
    if feed is None:
        feed = transformer_feed(cfg, TF_BATCH, src_seq, tgt_seq, padded)
    torch.cuda.reset_peak_memory_stats()
    losses, rates, step_s = [], [], []
    # the main path: counts reset just before, read just after
    fa.reset_launch_counts()
    for step in range(steps):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope,
                      validate=validate)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(np.asarray(out[0]).reshape(())))
        rates.append(float(np.asarray(out[1]).reshape(())))
        log(f"{tag}: step {step}: loss {losses[-1]:.5f}, lr "
            f"{rates[-1]:.6e}, {step_s[-1] * 1e3:.1f} ms")
    by_kernel = launches_by_kernel(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = check_losses(tag, cfg, losses)
    want = [noam_closed_form(cfg.d_model, counter0 + c)
            for c in range(steps)]
    check(np.allclose(rates, want, rtol=1e-6, atol=0),
          f"{tag}: noam rates {rates} != closed form {want}")
    counter = int(scope.find_var("@LR_DECAY_COUNTER@").reshape(()))
    check(counter == counter0 + steps - 1,
          f"{tag}: LR counter {counter} after {steps} runs from "
          f"{counter0}")
    check_tf_launches(torch, fa, tag, by_kernel,
                      attn_per_layer * cfg.n_decoder_layers, steps)
    stats = {"batch": TF_BATCH, "src_seq": src_seq, "tgt_seq": tgt_seq,
             "padded": padded, "params_m": n_params / 1e6,
             "losses": losses, "first_loss_expected": expected,
             "rates": rates, "lr_counter": counter,
             "launches_by_kernel": by_kernel, "peak_mem_gb": peak_gb,
             "card": card}
    if padded:
        stats["src_len_mean"] = float(feed["src_len"].mean())
        stats["tgt_len_mean"] = float(feed["tgt_len"].mean())
    if steps > TF_WARMUP:
        timed = sorted(step_s[TF_WARMUP:])
        step_ms = timed[len(timed) // 2] * 1e3
        tokens = TF_BATCH * (src_seq + tgt_seq)
        breakdown = {}
        add_busy(breakdown, device_ms_by_kind(
            torch, lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=scope, validate=validate)),
            step_ms)
        breakdown.setdefault("optimizer_segment", "not measured")
        stats.update(step_ms_median=step_ms, step_ms_min=timed[0] * 1e3,
                     step_ms_max=timed[-1] * 1e3,
                     tokens_per_s=tokens / (step_ms / 1e3),
                     tgt_tokens_per_s=TF_BATCH * tgt_seq / (step_ms / 1e3),
                     one_step=breakdown)
    else:
        stats["step_ms"] = [x * 1e3 for x in step_s]
    log(f"{tag}: " + json.dumps(stats))
    return by_kernel, stats, (main, scope, feed)


def phase_transformer(torch, fluid, fa, card):
    """The main path of this slice: TRANSFORMER_BASE with source and
    target lengths (the padded encoder self-attention and cross-attention
    take the biased matmul + softmax path; the causal decoder
    self-attention takes the kernels: K1/K2/K3 6 launches a step),
    TF_WARMUP + TF_STEPS steps; step time, tokens/s, peak memory and one
    step's device time by kind."""
    return train_transformer(
        torch, fluid, fa, card, "transformer", TF_SEQ, TF_SEQ, True,
        TF_WARMUP + TF_STEPS, 1)


def phase_transformer_unpadded(torch, fluid, fa, card, trained):
    """The same model and recipe with no lengths, as models/zoo.py feeds
    it, a source of TF_SEQ and a target of TF_SEQ / 2 tokens: every
    attention on the kernels — encoder self-attention (non-causal, T
    256), decoder self-attention (causal, T 128) and cross-attention
    (non-causal, tq 128 over tk 256) — so K1/K2/K3 18 launches a step,
    TF_UNPADDED_STEPS steps. It goes on training ``phase_transformer``'s
    scope on its batch (the source, and the first TF_SEQ / 2 target
    tokens and labels): the schedule goes on from its counter, and the
    three steps fit the labels the first ten began to fit. Three steps
    from a fresh start (rates ~2e-7), or on a new batch of random labels
    (Adam's moments still pointing at the old batch's), move the loss
    less than a new dropout mask does."""
    _, scope, feed = trained
    half = TF_SEQ // 2
    feed = {"src": feed["src"], "tgt": feed["tgt"][:, :half],
            "lbl": feed["lbl"][:, :half]}
    return train_transformer(
        torch, fluid, fa, card, "transformer_unpadded", TF_SEQ, half,
        False, TF_UNPADDED_STEPS, 3, scope=scope, feed=feed)


def phase_transformer_infer(torch, fluid, fa, card, trained):
    """``clone(for_test=True)`` of the labels-free program serves one
    batch on ``phase_transformer``'s trained scope: finite logits, equal
    on a second run (no draw at test time), within
    TOL_LOGITS_REL_RMS_F32 of the CPU's on the same scope, and away from
    the same scope's logits through a dropout-0 program (the
    ``downgrade_in_infer`` scaling by 1 - p is applied); K1 6 launches,
    no backward."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models.transformer import TRANSFORMER_BASE

    cfg = TRANSFORMER_BASE
    scope = trained[1]
    batch = 4
    main, _, logits, _, _ = build_transformer_train(
        fluid, cfg, TF_SEQ, TF_SEQ, True, labels=False)
    infer = main.clone(for_test=True)
    drops = [o for o in infer.global_block().ops if o.type == "dropout"]
    check(drops and all(o.attrs.get("is_test") for o in drops),
          "transformer_infer: the test clone has dropout not at test time")
    nodrop = build_transformer_train(
        fluid, dataclasses.replace(cfg, dropout=0.0), TF_SEQ, TF_SEQ, True,
        labels=False)
    feed = transformer_feed(cfg, batch, TF_SEQ, TF_SEQ, True, labels=False,
                            seed=SEED + 1)
    exe = fluid.Executor()
    fa.reset_launch_counts()
    got = exe.run(infer, feed=feed, fetch_list=[logits], scope=scope)[0]
    by_kernel = launches_by_kernel(fa)
    launches = {w: w.launches for w in (fa.flash_fwd, fa.flash_bwd_dq,
                                        fa.flash_bwd_dkv)}
    again = exe.run(infer, feed=feed, fetch_list=[logits], scope=scope)[0]
    plain = exe.run(nodrop[0].clone(for_test=True), feed=feed,
                    fetch_list=[nodrop[2]], scope=scope)[0]
    names = [p.name for p in main.all_parameters()]
    cpu_scope = weights.load_state(
        fluid.Scope(), weights.dump_state(scope, names), torch.device("cpu"))
    want = fluid.Executor(fluid.CPUPlace()).run(
        infer, feed=feed, fetch_list=[logits], scope=cpu_scope)[0]
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    rel = float(np.sqrt(np.mean((got.astype(np.float64) - want) ** 2))) / rms
    moved = float(np.sqrt(np.mean((plain.astype(np.float64) - got) ** 2))) \
        / rms
    check(got.shape == (batch, TF_SEQ, cfg.tgt_vocab_size)
          and np.isfinite(got).all(),
          f"transformer_infer: logits {got.shape}, finite "
          f"{np.isfinite(got).all()}")
    check(np.array_equal(got, again),
          "transformer_infer: two runs of the test program differ")
    check(rel <= TOL_LOGITS_REL_RMS_F32,
          f"transformer_infer: card vs CPU relative RMS {rel:.3e} > "
          f"{TOL_LOGITS_REL_RMS_F32}")
    check(moved > 10 * TOL_LOGITS_REL_RMS_F32,
          f"transformer_infer: logits without the 1 - p scaling moved by "
          f"only {moved:.3e} (relative RMS)")
    for w, n in ((fa.flash_fwd, cfg.n_decoder_layers),
                 (fa.flash_bwd_dq, 0), (fa.flash_bwd_dkv, 0)):
        check(launches[w] == n and by_kernel[
                  f32_kernel(torch, fa, w.__name__, TF_HEAD_DIM)] == n,
              f"transformer_infer: {w.__name__} launched {launches[w]} "
              f"times ({by_kernel}), not {n}")
    out = {"batch": batch, "card_vs_cpu_rel_rms": rel,
           "tier": TOL_LOGITS_REL_RMS_F32,
           "without_keep_scaling_rel_rms": moved,
           "launches_by_kernel": by_kernel, "card": card}
    log("transformer_infer: " + json.dumps(out))
    return out


def transformer_requests(cfg, n, seed):
    """``n`` single sentence-pair requests, as a client sends them:
    source and target padded to TF_SEQ tokens (zeros past the lengths,
    drawn in TF_LEN_RANGE on ``seed``) with the source length. The
    labels-free program never reads ``tgt_len`` (the reference's verifier
    reports it as a dangling feed), so the engine's feeds are what the
    program reads: ``src``, ``tgt`` and ``src_len``."""
    feed = transformer_feed(cfg, n, TF_SEQ, TF_SEQ, True, labels=False,
                            seed=seed)
    pos = np.arange(TF_SEQ)[None, :]
    src = np.where(pos < feed["src_len"][:, None], feed["src"], 0)
    tgt = np.where(pos < feed["tgt_len"][:, None], feed["tgt"], 0)
    return [{"src": src[i:i + 1], "tgt": tgt[i:i + 1],
             "src_len": feed["src_len"][i:i + 1]} for i in range(n)]


def sustained_load(engine, reqs, window_s):
    """One window of closed-loop load: a client per request, each sending
    its request again as soon as its answer comes, until ``window_s``
    seconds have passed. Every answer must be finite. Returns the
    window's requests, wall seconds (the last answers included),
    requests/s and client-side p50/p99 latency (host clock)."""
    deadline = time.perf_counter() + window_s
    lat = [[] for _ in reqs]

    def client(i):
        while time.perf_counter() < deadline:
            t = time.perf_counter()
            ans = engine.infer(reqs[i], timeout=600.0)
            lat[i].append(time.perf_counter() - t)
            check(np.isfinite(ans[0]).all(),
                  f"sustained load: request {i}: non-finite logits")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(reqs)) as pool:
        for f in [pool.submit(client, i) for i in range(len(reqs))]:
            f.result()
    wall = time.perf_counter() - t0
    all_lat = np.concatenate([np.asarray(x) for x in lat]) * 1e3
    p50, p99 = np.percentile(all_lat, [50, 99])
    return {"requests": int(all_lat.size), "wall_s": wall,
            "requests_per_s": all_lat.size / wall,
            "p50_ms": float(p50), "p99_ms": float(p99)}


def phase_transformer_serve(torch, fluid, fa, card, trained):
    """The main path of this slice: ``clone(for_test=True)`` of the
    labels-free padded TRANSFORMER_BASE behind ``ServingEngine`` with its
    DEFAULT optimize (the reference's ``optimize=True``), on
    ``phase_transformer``'s trained scope; batch buckets
    TF_SERVE_BATCHES, no sequence bucketing. After ``warmup()``,
    TF_SERVE_REQUESTS concurrent requests (``transformer_requests`` on
    SEED + 2). Checks: the optimize report equals the reference's
    (TF_SERVE_OPTIMIZE_COUNTS); every answer within TOL_LOGITS_F32 of the
    same request run alone through the UNOPTIMIZED program; one 8 x TF_SEQ
    batch through ``engine.program`` and through the unoptimized program
    bit-identical (the reference's optcheck contract, on the card); K1
    launched 6 times a dispatch, all on its float32 kernel at head dim 64
    (flash_fwd_f32_d64_wgmma), K2/K3 never; no
    step build after warmup. Then, counts read, the rate and tail under
    sustained load (``sustained_load``, TF_SERVE_WINDOWS windows), with
    no step build either. Returns (launches by kernel symbol, stats)."""
    from paddle_tpu_torch.models.transformer import TRANSFORMER_BASE
    from paddle_tpu_torch.serving import (BucketSpec, ServingConfig,
                                          ServingEngine)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tag = TRANSFORMER_BASE, "transformer_serve"
    scope = trained[1]
    main, _, logits, _, _ = build_transformer_train(
        fluid, cfg, TF_SEQ, TF_SEQ, True, labels=False)
    infer = main.clone(for_test=True)
    feeds = ["src", "tgt", "src_len"]
    exe = fluid.Executor()                     # the card: CUDAPlace(0)
    buckets = BucketSpec(batch_sizes=TF_SERVE_BATCHES)
    t0 = time.perf_counter()
    engine = ServingEngine(infer, feeds, [logits], scope=scope,
                           buckets=buckets,
                           config=ServingConfig(max_wait_ms=20.0,
                                                default_timeout_s=600.0))
    construction = construction_costs(infer, feeds, logits, engine,
                                      time.perf_counter() - t0)
    counts = engine.optimize_report.counts()
    check(counts == TF_SERVE_OPTIMIZE_COUNTS,
          f"{tag}: optimize report {counts} != the reference's "
          f"{TF_SERVE_OPTIMIZE_COUNTS}")
    log(f"{tag}: construction: " + json.dumps(construction))
    reqs = transformer_requests(cfg, TF_SERVE_REQUESTS, SEED + 2)
    try:
        # the main path: counts reset just before, read just after
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        warm = engine.warmup()
        warm_s = time.perf_counter() - t0
        start = threading.Barrier(len(reqs))

        def call(r):
            start.wait()
            return engine.infer(r, timeout=600.0)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(reqs)) as pool:
            answers = list(pool.map(call, reqs))
        wall = time.perf_counter() - t0
        by_kernel = launches_by_kernel(fa)
        launches = {w: w.launches for w in (fa.flash_fwd, fa.flash_bwd_dq,
                                            fa.flash_bwd_dkv)}
        stats = engine.stats()
        engine.assert_no_recompiles()
        sustained = [sustained_load(engine, reqs, TF_SERVE_WINDOW_S)
                     for _ in range(TF_SERVE_WINDOWS)]
        engine.assert_no_recompiles()
    finally:
        engine.close()
    dispatches = warm["signatures"] + stats["batches_total"]
    log(f"{tag}: warmup {warm['signatures']} bucket signatures in "
        f"{warm_s:.2f} s; {len(reqs)} concurrent requests in "
        f"{stats['batches_total']} batches, no step build after warmup")
    log(f"{tag}: sustained load, {len(reqs)} closed-loop clients, "
        f"{TF_SERVE_WINDOWS} windows of {TF_SERVE_WINDOW_S} s: "
        + json.dumps(sustained))
    check(stats["responses_total"] == len(reqs),
          f"{tag}: responses {stats['responses_total']} != {len(reqs)}")
    check(stats["optimize"] == engine.optimize_report.to_dict(),
          f"{tag}: stats()['optimize'] is not the engine's report")
    n_k1 = cfg.n_decoder_layers * dispatches
    for w, n in ((fa.flash_fwd, n_k1), (fa.flash_bwd_dq, 0),
                 (fa.flash_bwd_dkv, 0)):
        check(launches[w] == n and by_kernel[
                  f32_kernel(torch, fa, w.__name__, TF_HEAD_DIM)] == n
              and not w.launches_by_kernel[fa.PLAIN],
              f"{tag}: {w.__name__} launched {launches[w]} times "
              f"({by_kernel}), not {n}")
    log(f"{tag}: K1 launched {n_k1} times = {cfg.n_decoder_layers} x "
        f"{dispatches} dispatches, all "
        f"{f32_kernel(torch, fa, 'flash_fwd', TF_HEAD_DIM)}; K2/K3 0")

    worst = 0.0
    rtol, atol = TOL_LOGITS_F32
    for i, (r, ans) in enumerate(zip(reqs, answers)):
        got = ans[0]
        check(got.shape == (1, TF_SEQ, cfg.tgt_vocab_size)
              and np.isfinite(got).all(),
              f"{tag}: request {i}: logits {got.shape}, finite "
              f"{np.isfinite(got).all()}")
        alone = exe.run(infer, feed=r, fetch_list=[logits], scope=scope)[0]
        err = np.abs(got - alone)
        worst = max(worst, float((err / (atol + rtol * np.abs(alone)))
                                 .max()))
        check(bool((err <= atol + rtol * np.abs(alone)).all()),
              f"{tag}: request {i}: served logits differ from the "
              f"unoptimized program run alone beyond rtol={rtol}, "
              f"atol={atol} (max |d| {float(err.max()):.3e})")
    batch, _, _ = buckets.pad_batch(reqs[:max(TF_SERVE_BATCHES)])
    opt_out = exe.run(engine.program, feed=batch, fetch_list=[logits],
                      scope=scope)[0]
    plain_out = exe.run(infer, feed=batch, fetch_list=[logits],
                        scope=scope)[0]
    check(np.array_equal(opt_out, plain_out),
          f"{tag}: the optimized program's {max(TF_SERVE_BATCHES)} x "
          f"{TF_SEQ} batch differs from the unoptimized program's (max "
          f"|d| {float(np.abs(opt_out - plain_out).max()):.3e}): the "
          "rewrite is not bit-exact on the card")
    dispatch = where_the_time_goes(torch, exe, engine.program, logits,
                                   scope, batch)
    dispatch_plain = where_the_time_goes(torch, exe, infer, logits, scope,
                                         batch)
    paired = paired_dispatch_ms(torch, exe, (engine.program, infer), logits,
                                scope, batch, TF_SERVE_PAIRS)
    lat = stats["request_latency"]
    out = {"requests": len(reqs), "wall_s": wall,
           "requests_per_s": len(reqs) / wall,
           "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"],
           "batches": stats["batches_total"],
           "batch_p50_ms": stats["batch_latency"]["p50_ms"],
           "dispatches": dispatches, "k1_launches": n_k1,
           "worst_err_over_tolerance": worst,
           "sustained_requests_per_s": [w["requests_per_s"]
                                        for w in sustained],
           "sustained_p50_ms": [w["p50_ms"] for w in sustained],
           "sustained_p99_ms": [w["p99_ms"] for w in sustained],
           "batch_bit_exact_vs_unoptimized": True,
           "construction": construction,
           "launches_by_kernel": by_kernel, "card": card}
    log(f"{tag}: " + json.dumps(out))
    log(f"{tag}: one ({max(TF_SERVE_BATCHES)} x {TF_SEQ}) dispatch, "
        "optimized: " + json.dumps(dispatch))
    log(f"{tag}: the same dispatch, unoptimized: "
        + json.dumps(dispatch_plain))
    log(f"{tag}: the same dispatch, optimized and unoptimized in "
        "alternation: " + json.dumps(paired))
    return by_kernel, dict(out, one_dispatch=dispatch,
                           one_dispatch_unoptimized=dispatch_plain,
                           paired_dispatch=paired)


def phase_transformer_optimized(torch, fluid, fa, card, trained, stats):
    """``phase_transformer``'s TF_WARMUP + TF_STEPS steps again, from the
    same initial state (a fresh startup on a fresh Executor draws the
    same values) and on the same batch, with PADDLE_TPU_OPTIMIZE=1 (the
    executor runs fold + fuse + cse + dce clones) and
    ``validate="strict"`` (the full verifier before lowering): the ten
    losses and every persistable after the run — parameters, both Adam
    moments, the beta powers, the LR counter — bit for bit equal to the
    unoptimized run's; K1/K2/K3 6 launches a step on the f32 kernels
    (``train_transformer``'s checks). Returns (launches by kernel
    symbol, stats)."""
    _, scope, feed = trained
    old = os.environ.get("PADDLE_TPU_OPTIMIZE")
    os.environ["PADDLE_TPU_OPTIMIZE"] = "1"
    try:
        by_kernel, opt_stats, (main, opt_scope, _) = train_transformer(
            torch, fluid, fa, card, "transformer_optimized", TF_SEQ, TF_SEQ,
            True, TF_WARMUP + TF_STEPS, 1, feed=feed, validate="strict")
    finally:
        if old is None:
            os.environ.pop("PADDLE_TPU_OPTIMIZE", None)
        else:
            os.environ["PADDLE_TPU_OPTIMIZE"] = old
    check(opt_stats["losses"] == stats["losses"],
          "transformer_optimized: losses differ from the unoptimized "
          f"run: {opt_stats['losses']} vs {stats['losses']}")
    names = sorted(n for n, v in main.global_block().vars.items()
                   if v.persistable)
    differ = []
    for n in names:
        a, b = scope.find_var(n), opt_scope.find_var(n)
        if a is None or b is None or not torch.equal(a, b):
            differ.append(n)
    check(not differ,
          f"transformer_optimized: {len(differ)} of {len(names)} "
          f"persistables differ from the unoptimized run's (first: "
          f"{differ[:4]})")
    out = {"losses_bit_exact": True, "persistables_bit_exact": len(names),
           "step_ms_median": opt_stats.get("step_ms_median"),
           "step_ms_median_unoptimized": stats.get("step_ms_median"),
           "launches_by_kernel": by_kernel, "card": card}
    log("transformer_optimized: " + json.dumps(out))
    return by_kernel, dict(out, one_step=opt_stats.get("one_step"))


def phase_transformer_parity(torch, fluid, fa, card):
    """The base width at TF_PARITY's depth (head dim 64: the float32
    kernels on the card, their plain versions on the CPU) in float32,
    TF32 off, batch TF_PARITY_BATCH x TF_PARITY_SEQ with lengths, dropout
    0, label smoothing 0.1: one step on the card and on the CPU from one
    startup scope — the loss and every parameter's gradient within the
    f32 gradient tier — then 3 noam + Adam steps' losses within the loss
    tier, the rates and the LR counter equal."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models.transformer import TRANSFORMER_BASE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(TRANSFORMER_BASE, **TF_PARITY)
    main, startup, _, loss, lr = build_transformer_train(
        fluid, cfg, TF_PARITY_SEQ, TF_PARITY_SEQ, True)
    gpu_scope = fluid.Scope()
    gpu = fluid.Executor()
    gpu.run(startup, scope=gpu_scope)
    cpu_scope = weights.load_state(fluid.Scope(),
                                   weights.dump_state(gpu_scope),
                                   torch.device("cpu"))
    cpu = fluid.Executor(fluid.CPUPlace())
    feed = transformer_feed(cfg, TF_PARITY_BATCH, TF_PARITY_SEQ,
                            TF_PARITY_SEQ, True)
    grads = sorted(v for v in main.global_block().vars
                   if v.endswith("@GRAD"))
    fa.reset_launch_counts()
    got = gpu.run(main, feed=feed, fetch_list=[loss] + grads,
                  scope=gpu_scope)
    want = cpu.run(main, feed=feed, fetch_list=[loss] + grads,
                   scope=cpu_scope)
    worst = 0.0
    rtol, atol = TOL_GRAD_F32
    for name, g, w in zip(["loss"] + grads, got, want):
        err = np.abs(g - w)
        check(g.shape == w.shape
              and bool((err <= atol + rtol * np.abs(w)).all()),
              f"transformer_parity: {name} on the card differs from the "
              f"CPU by {float(err.max()):.3e} (rtol={rtol}, atol={atol})")
        worst = max(worst, float((err / (atol + rtol * np.abs(w))).max()))
    lg, lc, rg, rc = [], [], [], []
    for _ in range(3):
        g = gpu.run(main, feed=feed, fetch_list=[loss, lr], scope=gpu_scope)
        c = cpu.run(main, feed=feed, fetch_list=[loss, lr], scope=cpu_scope)
        lg.append(float(g[0].reshape(())))
        lc.append(float(c[0].reshape(())))
        rg.append(float(g[1].reshape(())))
        rc.append(float(c[1].reshape(())))
    by_kernel = launches_by_kernel(fa)
    check(np.allclose(lg, lc, rtol=TOL_LOSS_F32, atol=0),
          f"transformer_parity: Adam losses differ: card {lg} vs CPU {lc}")
    check(rg == rc, f"transformer_parity: rates differ: {rg} vs {rc}")
    counters = [int(s.find_var("@LR_DECAY_COUNTER@").reshape(()))
                for s in (gpu_scope, cpu_scope)]
    check(counters == [3, 3],
          f"transformer_parity: LR counters {counters}, not [3, 3]")
    # 4 card steps, the causal decoder self-attention of each layer
    check_tf_launches(torch, fa, "transformer_parity", by_kernel,
                      cfg.n_decoder_layers, 4)
    out = {"config": dataclasses.asdict(cfg),
           "batch": [TF_PARITY_BATCH, TF_PARITY_SEQ],
           "loss_step1": [float(got[0].reshape(())),
                          float(want[0].reshape(()))],
           "grads_checked": len(grads),
           "worst_err_over_tolerance": worst,
           "adam_losses_card": lg, "adam_losses_cpu": lc, "rates": rg,
           "lr_counter": counters[0], "launches_by_kernel": by_kernel,
           "card": card}
    log("transformer_parity: " + json.dumps(out))
    return by_kernel, out


# ---------------------------------------------------------------------------
# IO, persistables, checkpoints and the Inferencer (ROADMAP item 3)
# ---------------------------------------------------------------------------


# checkpoints, saved models and record files are written and read back
# here, in the package's git-ignored build directory inside the checkout
IO_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "paddle_tpu_torch", "_build", "chip_smoke_io")


def io_workdir(name):
    """A fresh directory ``name`` under IO_ROOT."""
    import shutil
    path = os.path.join(IO_ROOT, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def io_batches(cfg, workdir):
    """The IO_STEPS training batches of ``phase_io_train_resume``
    (``transformer_feed`` on SEED + 10 + step), written once with
    ``batcher.write_fixed``: one record file an epoch of IO_EPOCH_STEPS
    batches, one record a sentence pair. Returns (feed names, record
    specs, the files, the batches as numpy)."""
    from paddle_tpu_torch.io import batcher
    names = ["src", "tgt", "lbl", "src_len", "tgt_len"]
    specs = [((TF_SEQ,), "int64")] * 3 + [((1,), "int64")] * 2
    feeds = [transformer_feed(cfg, TF_BATCH, TF_SEQ, TF_SEQ, True,
                              seed=SEED + 10 + s) for s in range(IO_STEPS)]
    paths = []
    for e in range(IO_STEPS // IO_EPOCH_STEPS):
        path = os.path.join(workdir, f"epoch{e}.recordio")
        rows = [tuple(np.reshape(feeds[s][n][i], (-1,)) for n in names)
                for s in range(e * IO_EPOCH_STEPS, (e + 1) * IO_EPOCH_STEPS)
                for i in range(TF_BATCH)]
        batcher.write_fixed(path, rows, specs)
        paths.append(path)
    return names, specs, paths, feeds


class IOTrainRun:
    """One ``Trainer`` over TRANSFORMER_BASE (float32, the base recipe)
    fed by ``FixedBatcher`` -> ``DeviceLoader``, checkpointing at every
    epoch's end into ``ckpt_dir``; the epoch's record file is chosen by
    its BeginEpochEvent. Records each step's loss and wall time."""

    def __init__(self, fluid, cfg, ckpt_dir, names, specs, paths):
        from paddle_tpu_torch.io import DeviceLoader, batcher
        from paddle_tpu_torch.models.transformer import build_transformer
        self.losses, self.step_s = [], []
        self.model_cfg = cfg
        self.logits = None
        self._epoch = 0
        self._t = None

        def train_func():
            def data(name, shape):
                return fluid.layers.data(name=name, shape=shape,
                                         dtype="int64",
                                         append_batch_size=False)
            src, tgt = data("src", [-1, TF_SEQ]), data("tgt", [-1, TF_SEQ])
            lbl = data("lbl", [-1, TF_SEQ])
            logits, loss = build_transformer(
                cfg, src, tgt, lbl, src_lengths=data("src_len", [-1]),
                tgt_lengths=data("tgt_len", [-1]))
            self.logits = logits.name
            return [loss]

        def optimizer_func():
            lr = fluid.layers.noam_decay(cfg.d_model, TF_NOAM_WARMUP)
            return fluid.optimizer.Adam(lr, beta1=0.9, beta2=0.98,
                                        epsilon=1e-9)

        self.cfg = fluid.CheckpointConfig(
            checkpoint_dir=ckpt_dir, max_num_checkpoints=IO_KEEP,
            epoch_interval=1, step_interval=10 ** 9)
        # the card: Trainer's and DeviceLoader's default place
        self.trainer = fluid.Trainer(train_func, optimizer_func,
                                     checkpoint_config=self.cfg)

        def batches():
            # the lengths come back as [batch, 1] records
            for fields in batcher.FixedBatcher(paths[self._epoch], specs,
                                               TF_BATCH, n_threads=1):
                yield fields[:3] + tuple(f[:, 0] for f in fields[3:])

        self.reader = lambda: DeviceLoader(batches, feed_names=names,
                                           buffer_size=2)

    def handler(self, event):
        import paddle_tpu_torch as fluid
        if isinstance(event, fluid.BeginEpochEvent):
            self._epoch = event.epoch
        elif isinstance(event, fluid.BeginStepEvent):
            self._t = time.perf_counter()
        elif isinstance(event, fluid.EndStepEvent):
            # the fetched loss is on the host: the step is done
            self.step_s.append(time.perf_counter() - self._t)
            self.losses.append(float(np.asarray(event.metrics[0])))

    def train(self):
        self.trainer.train(num_epochs=IO_STEPS // IO_EPOCH_STEPS,
                           event_handler=self.handler, reader=self.reader)

    def state(self):
        scope = self.trainer.scope
        return {n: scope.find_var(n) for n in scope.keys()
                if scope.find_var(n) is not None}


def phase_io_train_resume(torch, fluid, fa, card):
    """Path A's training (ROADMAP item 3): TRANSFORMER_BASE in float32
    at full width, IO_TF_LAYERS layers a side, and the ``transformer``
    phase's batch (TF_BATCH x TF_SEQ a side, lengths from SEED), trained
    by ``Trainer`` (noam +
    Adam, dropout 0.1) for IO_STEPS steps, fed from record files written
    once with ``batcher.write_fixed`` and read through ``FixedBatcher``
    -> ``DeviceLoader`` (pinned memory, side-stream copies), a
    checkpoint at every epoch's end (IO_EPOCH_STEPS steps). Run 1 goes
    through; run 2 is killed by the ``torn_write`` fault during its
    second checkpoint; run 3, a fresh Trainer on run 2's directory,
    resumes from the newest valid checkpoint (the torn temp is ignored)
    and finishes. Checks: run 3's losses and every persistable after the
    last step equal run 1's bit for bit (``torch.equal``: the step
    counter that seeds dropout is restored), run 2's first epoch equals
    run 1's, K1/K2/K3 3 launches a step on the float32 kernels (run 1,
    counts reset just before and read just after). Then the step time
    with and without ``DeviceLoader`` (host numpy feeds), each with one
    step's device busy time and idle share. Returns (launches by kernel
    symbol, stats, run 1)."""
    from paddle_tpu_torch.models.transformer import TRANSFORMER_BASE
    from paddle_tpu_torch.resilience import faultinject
    from paddle_tpu_torch.resilience.checkpoint import list_serials

    tag = "io_train_resume"
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(TRANSFORMER_BASE,
                              n_encoder_layers=IO_TF_LAYERS,
                              n_decoder_layers=IO_TF_LAYERS)
    work = io_workdir("train")
    t0 = time.perf_counter()
    names, specs, paths, feeds = io_batches(cfg, work)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run1 = IOTrainRun(fluid, cfg, os.path.join(work, "ckpt1"),
                      names, specs, paths)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    # the main path: counts reset just before, read just after
    fa.reset_launch_counts()
    run1.train()
    by_kernel = launches_by_kernel(fa)
    check_tf_launches(torch, fa, tag, by_kernel, cfg.n_decoder_layers,
                      IO_STEPS)
    # a new batch of random labels every step, at noam's first rates
    # (~1e-7): the loss stays near its expected start, it need not fall
    expected = first_loss_expected(cfg)
    check(all(math.isfinite(x) and abs(x - expected) < 0.5
              for x in run1.losses),
          f"{tag}: losses {run1.losses} not finite within 0.5 of "
          f"{expected:.4f}")
    check(len(run1.losses) == IO_STEPS, f"{tag}: run 1 took "
          f"{len(run1.losses)} steps, not {IO_STEPS}")

    run2 = IOTrainRun(fluid, cfg, os.path.join(work, "ckpt2"),
                      names, specs, paths)
    faultinject.arm("torn_write", at=1)
    try:
        run2.train()
        check(False, f"{tag}: run 2 was not killed by the torn write")
    except faultinject.SimulatedCrash:
        pass
    finally:
        faultinject.disarm("torn_write")
    ckpt2 = os.path.join(work, "ckpt2")
    torn = [e for e in os.listdir(ckpt2) if e.startswith(".tmp_ckpt_")]
    check(list_serials(ckpt2) == [1] and len(torn) == 1,
          f"{tag}: after the crash {ckpt2} holds serials "
          f"{list_serials(ckpt2)} and temps {torn}")
    check(run2.losses == run1.losses[:len(run2.losses)]
          and len(run2.losses) == 2 * IO_EPOCH_STEPS,
          f"{tag}: run 2's losses {run2.losses} are not run 1's "
          f"{run1.losses}")
    del run2
    free_card(torch)

    t0 = time.perf_counter()
    run3 = IOTrainRun(fluid, cfg, ckpt2, names, specs, paths)
    resume_s = time.perf_counter() - t0
    check(run3.cfg.epoch_id == 1, f"{tag}: run 3 resumes at epoch "
          f"{run3.cfg.epoch_id}, not 1")
    run3.train()
    check(run3.losses == run1.losses[IO_EPOCH_STEPS:],
          f"{tag}: resumed losses {run3.losses} != uninterrupted "
          f"{run1.losses[IO_EPOCH_STEPS:]}")
    s1, s3 = run1.state(), run3.state()
    check(sorted(s1) == sorted(s3), f"{tag}: persistables differ: "
          f"{sorted(set(s1) ^ set(s3))}")
    differ = [n for n in s1 if not torch.equal(s1[n], s3[n])]
    check(not differ, f"{tag}: {len(differ)} persistables differ after "
          f"the resume: {differ[:5]}")
    del run3
    free_card(torch)

    # step time with and without DeviceLoader, on run 1's scope
    t1 = run1.trainer
    loss = t1.train_outputs[0]
    timing = {}
    for label in ("device_loader", "host_feed"):
        walls = []
        if label == "device_loader":
            it = iter(run1.reader())
            feed_of = lambda: next(it)                  # noqa: E731
        else:
            host = iter(feeds * 4)
            feed_of = lambda: next(host)                # noqa: E731
        for _ in range(IO_TIMED_STEPS):
            t0 = time.perf_counter()
            t1.exe.run(t1.train_program, feed=feed_of(), fetch_list=[loss],
                       scope=t1.scope)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if label == "device_loader" and len(walls) % IO_EPOCH_STEPS \
                    == 0:
                run1._epoch = (run1._epoch + 1) % len(paths)
                it = iter(run1.reader())
        med = sorted(walls)[len(walls) // 2] * 1e3
        entry = {"step_ms_median": med, "step_ms": [w * 1e3 for w in walls]}
        if label == "device_loader":
            it = iter(run1.reader())
        add_busy(entry, device_ms_by_kind(
            torch, lambda: t1.exe.run(t1.train_program, feed=feed_of(),
                                      fetch_list=[loss], scope=t1.scope)),
            med)
        timing[label] = entry
    stats = {"steps": IO_STEPS, "epoch_steps": IO_EPOCH_STEPS,
             "losses": run1.losses, "first_loss_expected": expected,
             "trainer_step_ms": [s * 1e3 for s in run1.step_s],
             "record_write_s": write_s, "trainer_startup_s": startup_s,
             "resume_construction_s": resume_s,
             "launches_by_kernel": by_kernel, **timing, "card": card}
    log(f"{tag}: " + json.dumps(stats))
    return by_kernel, stats, run1


def engine_answers(engine, reqs):
    """Every request submitted before the worker starts (one wave, FIFO,
    batches of the largest bucket), then the answers in request order."""
    pending = [engine.submit(r, timeout=600.0) for r in reqs]
    engine.start()
    return [p.result(600.0) for p in pending]


def rel_rms(got, want):
    want = np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((np.asarray(got, np.float64) - want) ** 2))
                 / np.sqrt(np.mean(want ** 2)))


def phase_io_saved_serve(torch, fluid, fa, card, run, then=None):
    """Path A's serving, the main path of this slice:
    ``save_inference_model`` of ``phase_io_train_resume``'s trained test
    clone (feeds src, tgt, src_len; the logits), with buckets
    TF_SERVE_BATCHES x TF_SEQ, ``artifact_store=True`` (``__artifacts__/``
    seeded by replaying ``from_saved_model`` + ``warmup()``), and a golden
    set of IO_GOLDEN requests recorded from an engine on the trained
    in-memory scope. Then a fresh ``ServingEngine.from_saved_model(dir,
    compile_store=True)``:
    ``warmup()`` builds no step (every bucket a store hit), TF_SERVE_
    REQUESTS concurrent requests get answers bit-identical to the
    in-memory engine's (the same wave, batched alike), K1 on
    flash_fwd_f32_d64_wgmma 6 launches a dispatch and K2/K3 none, no step build
    after warmup; ``Inferencer.from_inference_model(dir).infer`` of the
    first 8 requests equals them; the golden set replays equal; the
    ``CompiledPredictor`` of ``__compiled__.pt2`` at batch 1 and 8 within
    TOL_LOGITS_REL_RMS_F32 of the engine, K1 launched through the custom
    op, which copies no input there nor in the engine. The save, load, construction and warmup times, with the store and
    without it. ``then(saved)``, when given, runs last with the directory,
    the requests and the engine config (the cluster_remote phase).
    Returns (launches by kernel symbol, stats)."""
    from paddle_tpu_torch import io as fio
    from paddle_tpu_torch.serving import (BucketSpec, ServingConfig,
                                          ServingEngine)

    tag = "io_saved_serve"
    t1 = run.trainer
    feeds = ["src", "tgt", "src_len"]
    buckets = BucketSpec(batch_sizes=TF_SERVE_BATCHES)
    config = ServingConfig(max_wait_ms=20.0, default_timeout_s=600.0)
    work = io_workdir("saved")
    reqs = transformer_requests(run.model_cfg, TF_SERVE_REQUESTS, SEED + 2)
    mem = ServingEngine(t1.test_program.prune(feeds, [run.logits]), feeds,
                        [run.logits], scope=t1.scope,
                        buckets=buckets, config=config, auto_start=False)
    mem.warmup()
    golden_feeds = reqs[:IO_GOLDEN]
    t0 = time.perf_counter()
    with fluid.scope_guard(t1.scope):
        fio.save_inference_model(
            work, feeds, [run.logits], t1.exe, main_program=t1.test_program,
            serving_buckets=buckets, artifact_store=True)
    save_s = time.perf_counter() - t0
    want = engine_answers(mem, reqs)
    # the golden set is recorded one request at a time, as it replays
    fio.save_golden_set(work, golden_feeds,
                        [mem.infer(f, timeout=600.0) for f in golden_feeds])
    mem.close()
    with open(os.path.join(work, "__meta__.json")) as f:
        meta = json.load(f)
    store_entries = len(os.listdir(os.path.join(work, "__artifacts__")))
    check(meta["model_version"] == 1 and meta["feed_names"] == feeds
          and meta["serving"]["buckets"]["batch_sizes"]
          == list(TF_SERVE_BATCHES),
          f"{tag}: __meta__.json {meta}")

    t0 = time.perf_counter()
    eng = ServingEngine.from_saved_model(work, config=config,
                                         auto_start=False,
                                         compile_store=True)
    construct_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    store = eng.stats()["artifact_store"]
    check(warm["compiles"] == 0 and eng.exe.total_compiles() == 0,
          f"{tag}: warmup built {warm} steps with the store")
    check(store["hits_total"] == len(TF_SERVE_BATCHES)
          and store["misses_total"] == 0,
          f"{tag}: store counters after warmup {store}")
    # the main path: counts reset just before, read just after
    fa.reset_launch_counts()
    got = engine_answers(eng, reqs)
    by_kernel = launches_by_kernel(fa)
    engine_copies = fa.flash_fwd.input_copies
    dispatches = eng.stats().get("batches_total")
    eng.assert_no_recompiles()
    check(eng.exe.total_compiles() == 0,
          f"{tag}: a step was built after warmup")
    same = [i for i, (g, w) in enumerate(zip(got, want))
            if not np.array_equal(g[0], w[0])]
    check(not same, f"{tag}: answers {same} differ from the in-memory "
          "engine's")
    k1 = f32_kernel(torch, fa, "flash_fwd", TF_HEAD_DIM)
    n_dec = run.model_cfg.n_decoder_layers
    check(by_kernel[k1] > 0 and by_kernel[k1] % n_dec == 0
          and fa.flash_fwd.launches == by_kernel[k1]
          and not fa.flash_bwd_dq.launches
          and not fa.flash_bwd_dkv.launches,
          f"{tag}: launches {by_kernel}")
    if dispatches is not None:
        check(by_kernel[k1] == n_dec * dispatches,
              f"{tag}: K1 {by_kernel[k1]} launches for {dispatches} "
              "dispatches")
    golden = fio.load_golden_set(work)
    replay = [eng.infer(f, timeout=600.0) for f in golden[0]]
    check(len(golden[0]) == IO_GOLDEN
          and all(np.array_equal(r[0], o[0])
                  for r, o in zip(replay, golden[1])),
          f"{tag}: the golden set does not replay equal")
    eng.close()

    t0 = time.perf_counter()
    inf = fluid.Inferencer.from_inference_model(work)
    inf_load_s = time.perf_counter() - t0
    first = {n: np.concatenate([r[n] for r in reqs[:8]]) for n in feeds}
    out = inf.infer(first)[0]
    check(all(np.array_equal(out[i:i + 1], got[i][0]) for i in range(8)),
          f"{tag}: Inferencer.infer differs from the engine")
    del inf

    t0 = time.perf_counter()
    pred = fio.load_compiled_predictor(work)
    pred_load_s = time.perf_counter() - t0
    pred_err, pred_copies = {}, {}
    for b in (1, 8):
        feed = {n: np.concatenate([r[n] for r in reqs[:b]]) for n in feeds}
        fa.reset_launch_counts()
        p = pred.run(feed)[0]
        pred_copies[b] = fa.flash_fwd.input_copies
        check(pred_copies[b] == 0 and engine_copies == 0,
              f"{tag}: K1's operator copied inputs (engine "
              f"{engine_copies}, the predictor at batch {b} "
              f"{pred_copies[b]})")
        check(fa.flash_fwd.launches == n_dec
              and fa.flash_fwd.launches_by_kernel[k1] == n_dec,
              f"{tag}: the CompiledPredictor at batch {b} launched K1 "
              f"{fa.flash_fwd.launches_by_kernel}")
        err = max(rel_rms(p[i:i + 1], got[i][0]) for i in range(b))
        check(err <= TOL_LOGITS_REL_RMS_F32,
              f"{tag}: CompiledPredictor batch {b}: relative RMS {err:.3e}")
        pred_err[b] = err
    del pred

    # without the store (the default): the same load builds every bucket
    t0 = time.perf_counter()
    bare = ServingEngine.from_saved_model(work, config=config,
                                          auto_start=False,
                                          compile_store=False)
    bare_construct_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bare_warm = bare.warmup()
    torch.cuda.synchronize()
    bare_warm_s = time.perf_counter() - t0
    check(bare_warm["compiles"] == len(TF_SERVE_BATCHES),
          f"{tag}: warmup without the store built {bare_warm}")
    bare.close()
    stats = {"save_s": save_s, "store_entries": store_entries,
             "construct_s": construct_s, "warmup_s": warm_s,
             "warmup": warm, "store": {k: store[k] for k in (
                 "hits_total", "misses_total", "puts_total", "entries",
                 "total_bytes")},
             "construct_s_no_store": bare_construct_s,
             "warmup_s_no_store": bare_warm_s, "warmup_no_store": bare_warm,
             "inferencer_load_s": inf_load_s,
             "predictor_load_s": pred_load_s,
             "predictor_rel_rms": pred_err, "dispatches": dispatches,
             "k1_input_copies": {"engine": engine_copies,
                                 "predictor": pred_copies},
             "launches_by_kernel": by_kernel, "card": card}
    log(f"{tag}: " + json.dumps(stats))
    if then is not None:
        then({"dir": work, "reqs": reqs, "config": config,
              "n_dec": n_dec})
    return by_kernel, stats


def phase_io_llama_saved(torch, fluid, fa, card):
    """Path B: the Llama-3-8B width (dim 4096, head dim 128, vocab
    128256) cut to IO_LLAMA_LAYERS layers, in bfloat16, saved with
    ``save_inference_model`` (buckets (1, 2, 4) x (128, 256)) and served
    back by ``ServingEngine.from_saved_model``: every persistable's bits
    survive the round trip (the bfloat16 ``params.npz`` members are
    2-byte void arrays that the port reads by the program's dtype), 8
    requests across the buckets get answers bit-identical to an engine
    on the in-memory scope, K1 launched on flash_fwd_d128_wgmma at D 128, and
    the ``CompiledPredictor`` within TOL_LOGITS_BF16_RMS of the engine,
    K1's operator copying no input. Returns (launches by kernel symbol, stats)."""
    from paddle_tpu_torch import io as fio
    from paddle_tpu_torch.models.llama import LLAMA3_8B, build_llama
    from paddle_tpu_torch.serving import (BucketSpec, ServingConfig,
                                          ServingEngine)

    tag = "io_llama_saved"
    cfg = dataclasses.replace(LLAMA3_8B, n_layers=IO_LLAMA_LAYERS,
                              dtype="bfloat16")
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                                   dtype="int64", append_batch_size=False)
        logits, _ = build_llama(cfg, tokens)
    infer = main.clone(for_test=True)
    scope = fluid.Scope()
    exe = fluid.Executor()                     # the card: CUDAPlace(0)
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in scope.vars.values())
    buckets = BucketSpec(batch_sizes=(1, 2, 4),
                         seq_lens={"tokens": (128, 256)})
    config = ServingConfig(max_wait_ms=20.0, default_timeout_s=600.0)
    work = io_workdir("llama")
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        fio.save_inference_model(work, ["tokens"], [logits], exe,
                                 main_program=infer,
                                 serving_buckets=buckets)
    save_s = time.perf_counter() - t0
    npz_bytes = os.path.getsize(os.path.join(work, "params.npz"))
    t0 = time.perf_counter()
    eng = ServingEngine.from_saved_model(work, config=config,
                                         auto_start=False)
    load_s = time.perf_counter() - t0
    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    loaded = sorted(eng.scope.keys())
    differ = [n for n in loaded
              if eng.scope.find_var(n).dtype != scope.find_var(n).dtype
              or not torch.equal(bits(eng.scope.find_var(n)),
                                 bits(scope.find_var(n)))]
    check(loaded and not differ,
          f"{tag}: persistables changed across the round trip: {differ}")
    t0 = time.perf_counter()
    warm = eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    mem = ServingEngine(infer, ["tokens"], [logits], scope=scope,
                        buckets=buckets, config=config,
                        auto_start=False)
    mem.warmup()
    rng = np.random.RandomState(SEED + 3)
    lengths = [40, 130, 256, 77, 128, 200, 96, 171]
    reqs = [{"tokens": rng.randint(0, cfg.vocab_size, (1, n))
             .astype(np.int64)} for n in lengths]
    want = engine_answers(mem, reqs)
    mem.close()
    # the main path: counts reset just before, read just after
    fa.reset_launch_counts()
    got = engine_answers(eng, reqs)
    by_kernel = launches_by_kernel(fa)
    engine_copies = fa.flash_fwd.input_copies
    eng.assert_no_recompiles()
    eng.close()
    same = [i for i, (g, w) in enumerate(zip(got, want))
            if not np.array_equal(g[0], w[0])]
    check(not same, f"{tag}: answers {same} differ from the in-memory "
          "engine's")
    # answers come back padded to their length bucket; causal attention
    # leaves a request's own rows untouched by the padding after them
    check(all(np.isfinite(g[0]).all() and g[0].shape[0] == 1
              and g[0].shape[1] >= n and g[0].shape[2] == cfg.vocab_size
              for g, n in zip(got, lengths)),
          f"{tag}: logits not finite or of the wrong shape")
    k1 = bf16_k1(torch, fa, cfg)
    check(by_kernel[k1] > 0
          and by_kernel[k1] == fa.flash_fwd.launches
          and by_kernel[k1] % cfg.n_layers == 0
          and not fa.flash_bwd_dq.launches,
          f"{tag}: launches {by_kernel}")
    t0 = time.perf_counter()
    pred = fio.load_compiled_predictor(work)
    pred_load_s = time.perf_counter() - t0
    errs, pred_copies = [], []
    for i in (0, 2):
        fa.reset_launch_counts()
        p = pred.run(reqs[i])[0]
        pred_copies.append(fa.flash_fwd.input_copies)
        check(pred_copies[-1] == 0 and engine_copies == 0,
              f"{tag}: K1's operator copied inputs (engine "
              f"{engine_copies}, the predictor {pred_copies[-1]})")
        check(fa.flash_fwd.launches_by_kernel[k1] == cfg.n_layers,
              f"{tag}: CompiledPredictor launched K1 "
              f"{fa.flash_fwd.launches_by_kernel}")
        errs.append(rel_rms(p, got[i][0][:, :lengths[i]]))
    check(max(errs) <= TOL_LOGITS_BF16_RMS,
          f"{tag}: CompiledPredictor relative RMS {errs}")
    del pred, eng
    stats = {"layers": cfg.n_layers, "params_b": n_params / 1e9,
             "params_npz_gb": npz_bytes / 1e9, "save_s": save_s,
             "load_and_construct_s": load_s, "warmup_s": warm_s,
             "warmup": warm, "predictor_load_s": pred_load_s,
             "predictor_rel_rms": errs,
             "k1_input_copies": {"engine": engine_copies,
                                 "predictor": pred_copies},
             "launches_by_kernel": by_kernel, "card": card}
    log(f"{tag}: " + json.dumps(stats))
    return by_kernel, stats


def phase_dropout(torch, card):
    """The dropout rule on the card at DROPOUT_P over a TF_BATCH x TF_SEQ
    x 512 float32 tensor: the kept share within 5 sigma of 1 - p, the
    mask replayed for the same program seed and step (``ctx.next_key``)
    and changed for the next step, ``upscale_in_train`` scaling kept
    values by 1 / (1 - p) and ``downgrade_in_infer`` keeping them."""
    from paddle_tpu_torch.core import lowering, registry

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    x = torch.randn(TF_BATCH, TF_SEQ, 512, generator=gen, device=dev) + 3.0
    rule = registry.get_op("dropout").lower

    def draw(step, impl):
        ctx = lowering.LoweringContext(None, "train", dev, SEED, step)
        return rule(ctx, {"X": [x]}, {"dropout_prob": DROPOUT_P,
                                      "dropout_implementation": impl})

    p, n = DROPOUT_P, x.numel()
    out = {}
    for impl, kept_values in (("downgrade_in_infer", x),
                              ("upscale_in_train", x / (1.0 - p))):
        a = draw(1, impl)
        mask = a["Mask"][0]
        kept = float(mask.mean())
        sigma = math.sqrt(p * (1 - p) / n)
        check(abs(kept - (1 - p)) < 5 * sigma,
              f"dropout {impl}: kept share {kept:.6f}, not within 5 sigma "
              f"({5 * sigma:.2e}) of {1 - p}")
        check(torch.equal(a["Out"][0], torch.where(
            mask.bool(), kept_values, torch.zeros_like(x))),
              f"dropout {impl}: kept values are not "
              + ("x / (1 - p)" if impl == "upscale_in_train" else "x"))
        check(torch.equal(draw(1, impl)["Mask"][0], mask),
              f"dropout {impl}: the mask does not replay for one seed and "
              "step")
        check(not torch.equal(draw(2, impl)["Mask"][0], mask),
              f"dropout {impl}: step 2 drew step 1's mask")
        out[impl] = {"kept_share": kept, "five_sigma": 5 * sigma}
    out.update(shape=list(x.shape), p=p, card=card)
    log("dropout: " + json.dumps(out))
    return out


def gen_programs(fluid, cfg, prompt_len, **gen_kw):
    """A generator program over a [-1, prompt_len] prompt; returns
    (program, startup, fetches)."""
    from paddle_tpu_torch.models.llama import build_llama_generator
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = SEED
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        ptok = fluid.layers.data(name="ptok", shape=[-1, prompt_len],
                                 dtype="int64", append_batch_size=False)
        out = build_llama_generator(cfg, ptok, **gen_kw)
    return prog, startup, list(out) if isinstance(out, tuple) else [out]


def recompute_program(fluid, cfg):
    """``build_llama(cfg, tokens, shard_pp=True)``'s test clone: the
    layer-stacked forward (K1 once a layer) over the same parameter
    names as the generator. Returns (program, logits)."""
    from paddle_tpu_torch.models.llama import build_llama
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()), \
            fluid.unique_name.guard():
        ftok = fluid.layers.data(name="ftok", shape=[-1, -1],
                                 dtype="int64", append_batch_size=False)
        logits, _ = build_llama(cfg, ftok, shard_pp=True)
    return main.clone(for_test=True), logits


def greedy_against_recompute(tag, gen, logits, prompt_len, row_err,
                             stop_at_flip):
    """Each generated token of ``gen`` [b, T] against the argmax of the
    recompute's float32 ``logits`` [b, T, V] at the position before it.
    A token that differs passes only where the recompute's top-1 margin
    over the generated token is within twice ``row_err`` (per row); with
    ``stop_at_flip`` the row is compared no further after such a flip.
    Returns the tokens compared and agreeing per row."""
    agreed = []
    for r in range(gen.shape[0]):
        n = 0
        for pos in range(prompt_len, gen.shape[1]):
            row = logits[r, pos - 1]
            want = int(row.argmax())
            got = int(gen[r, pos])
            if got != want:
                margin = float(row[want] - row[got])
                check(margin <= 2 * row_err[r],
                      f"{tag}: row {r} position {pos}: generated {got}, "
                      f"the recompute's argmax {want} with a margin "
                      f"{margin:.3e} > 2 x the row's logit error "
                      f"{row_err[r]:.3e}")
                if stop_at_flip:
                    break
                continue
            n += 1
        agreed.append(n)
    return agreed


def log_prob_error(torch, probs, logits):
    """Per row, the largest |log p - log_softmax(logits)| over the
    vocabulary: the logit error of the generator's first step against
    the recompute (a softmax removes the rows' constant)."""
    lp = torch.log(probs.float().clamp_min(1e-30))
    return (lp - torch.log_softmax(logits.float(), dim=-1)).abs() \
        .amax(dim=-1).tolist()


def run_gen(exe, prog, fetches, scope, prompt, return_numpy=True):
    return exe.run(prog, feed={"ptok": prompt}, fetch_list=fetches,
                   scope=scope, mode="test", return_numpy=return_numpy)


def timed(torch, fn):
    """(``fn()``, its host wall ms, ending in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def wall_ms(torch, fn, reps=3):
    """Median host wall ms of ``fn`` over ``reps`` runs."""
    return float(np.median([timed(torch, fn)[1] for _ in range(reps)]))


def decode_weight_bytes(scope):
    """Bytes of the weights a decode step reads once: the seven stacked
    matmul weights and the lm head (their scales too, where int8)."""
    names = [f"blocks.{s}" for s in ("wq", "wk", "wv", "wo", "w_gate",
                                     "w_up", "w_down")] + ["lm_head"]
    total = 0
    for n in names + [n + "@scale" for n in names]:
        t = scope.find_var(n)
        if t is not None:
            total += t.numel() * t.element_size()
    return total


def check_int8_exact(torch, tag, got, a, b, eq):
    """``got`` (int32 on the card) against the exact product of the
    int8 operands ``a`` and ``b`` on the CPU, in float64 (exact: every
    partial sum is an integer far below 2**53)."""
    want = torch.einsum(eq, a.cpu().double(), b.cpu().double())
    check(torch.equal(got.cpu().to(torch.int64), want.to(torch.int64)),
          f"{tag}: int32 accumulators differ from the exact product "
          f"({eq}, {tuple(a.shape)} x {tuple(b.shape)})")
    return int(got.numel())


def gen_layer0_activations(torch, scope, cfg, prompt):
    """Layer 0's tensors of the prefill, on the card: the attention input
    ``pre`` [b, T, D], roped q [b, T, H, hd] and k, v [b, T, n_kv, hd],
    and the attention output at each row's last position [b, H*hd] (what
    ``wo`` takes there), from the plain causal GQA attention."""
    from paddle_tpu_torch.ops import transformer_ops as tops
    dev = scope.find_var("tok_emb").device
    h = scope.find_var("tok_emb")[torch.as_tensor(prompt, device=dev)]
    hd = cfg.dim // cfg.n_heads
    b, t = prompt.shape
    pre = tops.rms_normalize(h, scope.find_var("blocks.attn_norm")[0],
                             cfg.norm_eps)
    pos = torch.arange(t, device=dev)
    q = tops.apply_rope_at((pre @ scope.find_var("blocks.wq")[0]).reshape(
        b, t, cfg.n_heads, hd), pos, cfg.rope_base)
    k = tops.apply_rope_at((pre @ scope.find_var("blocks.wk")[0]).reshape(
        b, t, cfg.n_kv_heads, hd), pos, cfg.rope_base)
    v = (pre @ scope.find_var("blocks.wv")[0]).reshape(b, t,
                                                      cfg.n_kv_heads, hd)
    rep = cfg.n_heads // cfg.n_kv_heads
    kr, vr = (x.float().repeat_interleave(rep, dim=2) for x in (k, v))
    w = torch.softmax(torch.einsum("bhd,bkhd->bhk", q[:, -1].float(), kr)
                      / math.sqrt(hd), dim=-1)
    attn = torch.einsum("bhk,bkhd->bhd", w, vr).reshape(b, -1).to(q.dtype)
    return pre, q, k, v, attn


def check_kv8_contractions(torch, tag, cfg, q, k, v):
    """The int8 KV cache's two contractions (``int8_einsum``) on card
    tensors of the prefill against the exact product on the CPU: Q.K^T
    over the head dim, and the quantized softmax weights times V over
    every position."""
    from paddle_tpu_torch.ops import transformer_ops as tops
    b, t, n_kv, hd = k.shape
    rep = cfg.n_heads // n_kv
    qq, _ = tops._act_quant(q.reshape(b, t, n_kv, rep, hd))
    kq, _ = tops._act_quant(k)
    vq, _ = tops._act_quant(v)
    eq_qk, eq_wv = "bqgrd,bkgd->bgrqk", "bgrqk,bkgd->bqgrd"
    l32 = tops.int8_einsum(eq_qk, qq, kq)
    n = check_int8_exact(torch, tag, l32, qq, kq, eq_qk)
    w = torch.softmax(l32.float(), dim=-1)
    wq8, _ = tops._act_quant(w)
    o32 = tops.int8_einsum(eq_wv, wq8, vq)
    n += check_int8_exact(torch, tag, o32, wq8, vq, eq_wv)
    return n


def check_qmat_exact(torch, tag, qscope, pre, attn):
    """``int8_mm`` (qmat's product) on layer 0's int8 weights and
    activations: each row's last position (M = batch, padded to 17
    inside) and, for the products that take ``pre``, a prefill block of
    32 rows, against the exact product."""
    from paddle_tpu_torch.ops import transformer_ops as tops
    n = 0
    for s in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        w = qscope.find_var(f"blocks.{s}")[0]
        if s == "w_down":
            # the SwiGLU product w_down takes, through the int8 qmat
            p = {"G": qscope.find_var("blocks.w_gate")[0],
                 "GScale": qscope.find_var("blocks.w_gate@scale")[0],
                 "U": qscope.find_var("blocks.w_up")[0],
                 "UScale": qscope.find_var("blocks.w_up@scale")[0]}
            g = tops.qmat(pre[:, -1], p, "G")
            rows = [(g * torch.sigmoid(g)) * tops.qmat(pre[:, -1], p, "U")]
        elif s == "wo":
            rows = [attn]
        else:
            rows = [pre[:, -1], pre[0, :32]]
        for x in rows:
            xq, _ = tops._act_quant(x)
            n += check_int8_exact(torch, f"{tag} {s}", tops.int8_mm(xq, w),
                                  xq, w, "mk,kn->mn")
    return n


def phase_generate(torch, fluid, fa, card):
    """ROADMAP item 4a, the main path of this slice: the Llama-3-8B width
    (GEN_LAYERS of its 32 layers, bf16, random weights from SEED) generating
    GEN_NEW tokens after a GEN_PROMPT-token prompt for GEN_BATCH rows
    through ``Executor.run(gen_program, feed={"ptok": prompt},
    fetch_list=[out])``, held against ``build_llama(shard_pp=True)``'s
    forward of the generated sequence on the same scope (K1 once a layer
    a dispatch, on flash_fwd_d128_wgmma): the prompt echoed, every generated
    token the recompute's argmax at its position (a flip only where the
    recompute's margin is within twice the row's logit error, and the
    row compared no further), FirstProbs within TOL_LOGITS_BF16_RMS of
    the recompute's softmax at the last prompt position. Then: the int8
    KV cache (its contractions exact on the card; FirstProbs' distance
    reported against the reference's bounds), W8A8 (qmat's accumulators
    exact on the card; agreement reported), speculative decoding with
    the target as its own draft (tokens equal greedy's under the same
    tier; acceptance and rounds), sampling (in the vocabulary, replayed
    for a seed and step, different across steps), the float32 check at
    GEN_F32_LAYERS layers (exact where the margin exceeds the f32 tier,
    K1 on flash_fwd_f32_d128_wgmma), and the timings: prefill,
    per-token decode at batch 1 and GEN_BATCH for bf16, W8A8 and the
    int8 cache beside the weights' read bound, speculative tokens/s, the
    device's busy share over a GEN_PROFILED_NEW-token generate. Returns
    (K1 launches by kernel, stats)."""
    from paddle_tpu_torch.models.llama import (LLAMA3_8B,
                                               build_llama_spec_generator,
                                               copy_weights_as_draft,
                                               quantize_generator_weights)
    tag = "generate"
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(LLAMA3_8B, n_layers=GEN_LAYERS)    # bf16
    total = GEN_PROMPT + GEN_NEW
    gen_p, startup, (out_v, probs_v) = gen_programs(
        fluid, cfg, GEN_PROMPT, max_new_tokens=GEN_NEW, return_probs=True)
    fwd_p, logits_v = recompute_program(fluid, cfg)
    scope = fluid.Scope()
    exe = fluid.Executor()                     # the card: CUDAPlace(0)
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED + 5)
    prompt = rng.randint(0, cfg.vocab_size,
                         (GEN_BATCH, GEN_PROMPT)).astype(np.int64)

    # the main path: counts reset just before, read just after
    fa.reset_launch_counts()
    gen, probs = run_gen(exe, gen_p, [out_v, probs_v], scope, prompt)
    logits = exe.run(fwd_p, feed={"ftok": gen}, fetch_list=[logits_v],
                     scope=scope, mode="test", return_numpy=False)[0]
    torch.cuda.synchronize()
    by_kernel = launches_by_kernel(fa)
    check(gen.shape == (GEN_BATCH, total), f"{tag}: tokens {gen.shape}")
    check(np.array_equal(gen[:, :GEN_PROMPT], prompt),
          f"{tag}: the prompt is not echoed")
    check(((gen >= 0) & (gen < cfg.vocab_size)).all(),
          f"{tag}: a token outside the vocabulary")
    k1 = bf16_k1(torch, fa, cfg)
    check(by_kernel[k1] == cfg.n_layers
          and fa.flash_fwd.launches == cfg.n_layers
          and not fa.flash_bwd_dq.launches,
          f"{tag}: K1 launches {by_kernel}, not {cfg.n_layers} on "
          f"{k1} (one dispatch)")
    logits = logits.float()
    check(bool(torch.isfinite(logits).all()), f"{tag}: recompute logits")
    probs_t = torch.as_tensor(probs, device=logits.device)
    row_err = log_prob_error(torch, probs_t, logits[:, GEN_PROMPT - 1])
    want_p = torch.softmax(logits[:, GEN_PROMPT - 1], dim=-1)
    p_rms = rel_rms(probs, want_p.cpu().numpy())
    check(p_rms <= TOL_LOGITS_BF16_RMS,
          f"{tag}: FirstProbs differ from the recompute's softmax by rel "
          f"rms {p_rms:.3e} > {TOL_LOGITS_BF16_RMS}")
    # the same distance for the two bf16 programs, beside the int8
    # cache's below: KL(recompute || generator) at the first step
    kl_bf16 = torch.nn.functional.kl_div(
        torch.log(probs_t.float().clamp_min(1e-12)), want_p,
        reduction="none").sum(-1)
    logits_h = logits.cpu().numpy()
    del logits
    agreed = greedy_against_recompute(tag, gen, logits_h, GEN_PROMPT,
                                      row_err, stop_at_flip=True)
    log(f"{tag}: bf16 greedy, {GEN_BATCH} x ({GEN_PROMPT} + {GEN_NEW}): "
        f"tokens agreeing with the K1 recompute before any flip {agreed} "
        f"of {GEN_NEW}; FirstProbs rel rms {p_rms:.3e}; the rows' "
        f"first-step logit error {[f'{e:.3e}' for e in row_err]}; K1 "
        f"{by_kernel[k1]} launches on {k1}")
    stats = {"layers": cfg.n_layers, "batch": GEN_BATCH,
             "prompt": GEN_PROMPT, "new_tokens": GEN_NEW,
             "startup_s": startup_s, "agreed_before_flip": agreed,
             "first_probs_rel_rms": p_rms, "row_logit_err": row_err,
             "first_probs_kl_vs_recompute": kl_bf16.tolist(),
             "launches_by_kernel": by_kernel}

    # the int8 KV cache: its contractions exact on the card; FirstProbs
    # against the bf16 cache's, with the reference's bounds beside
    pre, q, k, v, attn = gen_layer0_activations(torch, scope, cfg, prompt)
    n_kv8 = check_kv8_contractions(torch, tag, cfg, q, k, v)
    del q, k, v
    kv8_p, _, (kv8_out, kv8_probs) = gen_programs(
        fluid, cfg, GEN_PROMPT, max_new_tokens=GEN_NEW, kv_int8=True,
        return_probs=True)
    # the int8 programs' runs at GEN_BATCH are their timed runs: the
    # checks above warmed their kernels
    main_ms = {}
    (kv8, p8), main_ms["kv_int8"] = timed(torch, lambda: run_gen(
        exe, kv8_p, [kv8_out, kv8_probs], scope, prompt))
    check(np.array_equal(kv8[:, :GEN_PROMPT], prompt),
          f"{tag} kv_int8: the prompt is not echoed")
    kl = (probs * (np.log(probs + 1e-12) - np.log(p8 + 1e-12))).sum(-1)
    stats["kv_int8"] = {
        "exact_accumulators": n_kv8,
        "max_abs_dp": float(np.abs(p8 - probs).max()),
        "mean_kl": float(kl.mean()), "max_kl": float(kl.max()),
        "bounds_max_dp_kl": [KV8_MAX_DP, KV8_MAX_KL],
        "token_agreement": float((kv8 == gen)[:, GEN_PROMPT:].mean())}
    log(f"{tag} kv_int8: " + json.dumps(stats["kv_int8"]))

    # W8A8: a second scope aliasing the bf16 tensors, its matmul
    # weights and head replaced by int8 with @scale companions
    qscope = fluid.Scope()
    for n in scope.keys():
        qscope.set(n, scope.find_var(n))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_generator_weights(qscope)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    n_q = check_qmat_exact(torch, f"{tag} w8a8", qscope, pre, attn)
    del pre, attn
    q_p, _, (q_out, q_probs) = gen_programs(
        fluid, cfg, GEN_PROMPT, max_new_tokens=GEN_NEW, quantize=True,
        return_probs=True)
    (wq, pq), main_ms["w8a8"] = timed(torch, lambda: run_gen(
        exe, q_p, [q_out, q_probs], qscope, prompt))
    check(np.array_equal(wq[:, :GEN_PROMPT], prompt)
          and ((wq >= 0) & (wq < cfg.vocab_size)).all(),
          f"{tag} w8a8: prompt not echoed or a token out of range")
    stats["w8a8"] = {
        "quantize_s": quant_s, "exact_accumulators": n_q,
        "weights_gb": decode_weight_bytes(qscope) / 1e9,
        "first_probs_max_abs_dp": float(np.abs(pq - probs).max()),
        "first_probs_rel_rms": rel_rms(pq, probs),
        "token_agreement": float((wq == gen)[:, GEN_PROMPT:].mean())}
    log(f"{tag} w8a8: " + json.dumps(stats["w8a8"]))

    # speculative decoding, the target as its own draft (aliases)
    copy_weights_as_draft(scope)
    spec_p = fluid.Program()
    with fluid.program_guard(spec_p, fluid.Program()), \
            fluid.unique_name.guard():
        ptok = fluid.layers.data(name="ptok", shape=[-1, GEN_PROMPT],
                                 dtype="int64", append_batch_size=False)
        spec_vars = build_llama_spec_generator(
            cfg, cfg, ptok, GEN_NEW, gamma=GEN_GAMMA, return_stats=True)
    (spec, rounds, emitted), spec_ms = timed(torch, lambda: run_gen(
        exe, spec_p, list(spec_vars), scope, prompt))
    rounds, emitted = int(rounds), int(emitted)
    check(emitted == GEN_NEW, f"{tag} spec: emitted {emitted}")
    differ = [(r, int(np.nonzero(spec[r] != gen[r])[0][0]))
              for r in range(GEN_BATCH) if not np.array_equal(spec[r],
                                                               gen[r])]
    for r, pos in differ:
        # a flip explicable by rounding: the recompute (of greedy's own
        # sequence) puts the two tokens within twice the row's error
        row = logits_h[r, pos - 1]
        margin = abs(float(row[gen[r, pos]] - row[spec[r, pos]]))
        check(margin <= 2 * row_err[r],
              f"{tag} spec: row {r} leaves greedy at {pos} with a margin "
              f"{margin:.3e} > 2 x {row_err[r]:.3e}")
    stats["spec"] = {"gamma": GEN_GAMMA, "rounds": rounds,
                     "emitted": emitted,
                     "tokens_per_round": (emitted - 1) / max(rounds, 1),
                     "rows_equal_to_greedy": GEN_BATCH - len(differ),
                     "first_difference": differ}
    log(f"{tag} spec: " + json.dumps(stats["spec"]))

    # sampling: in the vocabulary, replayed for a seed and step (a fresh
    # executor starts at the same step), different across steps
    s_p, _, (s_out,) = gen_programs(fluid, cfg, GEN_PROMPT,
                                    max_new_tokens=GEN_SAMPLED_NEW,
                                    **GEN_SAMPLING)
    exe1 = fluid.Executor()
    s1 = run_gen(exe1, s_p, [s_out], scope, prompt)[0]
    s2 = run_gen(exe1, s_p, [s_out], scope, prompt)[0]
    s1_again = run_gen(fluid.Executor(), s_p, [s_out], scope, prompt)[0]
    check(((s1 >= 0) & (s1 < cfg.vocab_size)).all()
          and np.array_equal(s1[:, :GEN_PROMPT], prompt),
          f"{tag} sampled: prompt not echoed or a token out of range")
    check(np.array_equal(s1, s1_again),
          f"{tag} sampled: the same seed and step drew other tokens")
    check(not np.array_equal(s1[:, GEN_PROMPT:], s2[:, GEN_PROMPT:]),
          f"{tag} sampled: two successive steps drew the same tokens")
    stats["sampled"] = dict(GEN_SAMPLING, replayed=True,
                            steps_differ=True)

    # timings: prefill alone (one new token), then decode per token at
    # batch 1 and GEN_BATCH beside the weights' read bound (the int8
    # programs' generate at GEN_BATCH is their run above)
    timing = {}
    progs = {"bf16": (gen_p, out_v, scope, {}),
             "w8a8": (q_p, q_out, qscope, dict(quantize=True)),
             "kv_int8": (kv8_p, kv8_out, scope, dict(kv_int8=True))}
    for name, (prog, out, sc, kw) in progs.items():
        one_p, _, (one_out,) = gen_programs(fluid, cfg, GEN_PROMPT,
                                            max_new_tokens=1, **kw)
        bound = decode_weight_bytes(sc) / HBM_BYTES_PER_S * 1e3
        row = {"decode_bound_ms": bound}
        for b in (1, GEN_BATCH):
            pb = prompt[:b]
            pre_ms = wall_ms(torch, lambda: run_gen(
                exe, one_p, [one_out], sc, pb, return_numpy=False))
            # one run: its GEN_NEW - 1 decode steps are the average
            full_ms = main_ms.get(name) if b == GEN_BATCH else None
            full_ms = full_ms or timed(torch, lambda: run_gen(
                exe, prog, [out], sc, pb, return_numpy=False))[1]
            row[f"b{b}"] = {"prefill_ms": pre_ms, "generate_ms": full_ms,
                            "decode_ms_per_token":
                                (full_ms - pre_ms) / (GEN_NEW - 1)}
        timing[name] = row
        log(f"{tag} timing {name}: " + json.dumps(row))
    timing["spec_tokens_per_s"] = GEN_BATCH * GEN_NEW / (spec_ms / 1e3)
    # the device's busy share over a shorter bf16 generate (fewer events
    # for the profiler), against the same run unprofiled
    pf_p, _, (pf_out,) = gen_programs(fluid, cfg, GEN_PROMPT,
                                      max_new_tokens=GEN_PROFILED_NEW)

    def profiled():
        return run_gen(exe, pf_p, [pf_out], scope, prompt,
                       return_numpy=False)
    profiled()
    wall = timed(torch, profiled)[1]
    busy = {"new_tokens": GEN_PROFILED_NEW, "wall_ms": wall}
    add_busy(busy, device_ms_by_kind(torch, profiled), wall)
    timing["bf16_decode_device"] = busy
    stats["timing"] = timing
    log(f"{tag} timing: spec {timing['spec_tokens_per_s']:.1f} tokens/s; "
        f"bf16 b{GEN_BATCH} device: " + json.dumps(busy))
    del scope, qscope, logits_h
    free_card(torch)

    # float32 at GEN_F32_LAYERS layers, TF32 off: exact wherever the
    # recompute's margin exceeds the f32 logit tier
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(LLAMA3_8B, n_layers=GEN_F32_LAYERS,
                                dtype="float32")
    g32_p, st32, (g32_out, g32_probs) = gen_programs(
        fluid, cfg32, GEN_PROMPT, max_new_tokens=GEN_NEW,
        return_probs=True)
    f32_p, f32_logits = recompute_program(fluid, cfg32)
    scope32 = fluid.Scope()
    exe.run(st32, scope=scope32)
    fa.reset_launch_counts()
    g32, p32 = run_gen(exe, g32_p, [g32_out, g32_probs], scope32, prompt)
    l32 = exe.run(f32_p, feed={"ftok": g32}, fetch_list=[f32_logits],
                  scope=scope32, mode="test")[0]
    f32_launches = launches_by_kernel(fa)
    check(f32_launches[f32_kernel(torch, fa, "flash_fwd", cfg32.dim
                                  // cfg32.n_heads)] == GEN_F32_LAYERS
          and fa.flash_fwd.launches == GEN_F32_LAYERS,
          f"{tag} f32: K1 launches {f32_launches}")
    # the logits before each generated token, their top two and argmax
    before = l32[:, GEN_PROMPT - 1:total - 1]
    top2 = np.partition(before, -2, axis=-1)[..., -2:]
    rtol, atol = TOL_LOGITS_F32
    decided = top2[..., 1] - top2[..., 0] > 2 * (
        atol + rtol * np.abs(top2[..., 1]))
    wrong = np.argwhere(decided & (g32[:, GEN_PROMPT:]
                                   != before.argmax(-1)))
    check(not len(wrong), f"{tag} f32: generated tokens at (row, new "
          f"token) {wrong.tolist()} differ from the recompute's argmax "
          "where its margin exceeds the f32 tier")
    want32 = np.exp(before[:, 0] - before[:, 0].max(-1, keepdims=True))
    want32 /= want32.sum(-1, keepdims=True)
    p_rms32 = rel_rms(p32, want32)
    check(p_rms32 <= TOL_LOGITS_REL_RMS_F32,
          f"{tag} f32: FirstProbs differ from the recompute's softmax by "
          f"rel rms {p_rms32:.3e} > {TOL_LOGITS_REL_RMS_F32}")
    stats["f32"] = {"layers": GEN_F32_LAYERS,
                    "tokens_decided": int(decided.sum()),
                    "tokens_within_tier": int((~decided).sum()),
                    "first_probs_rel_rms": p_rms32,
                    "launches_by_kernel": f32_launches}
    log(f"{tag} f32: " + json.dumps(stats["f32"]))
    del scope32
    stats["card"] = card
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"{tag}: " + json.dumps({k: v for k, v in stats.items()
                                  if k != "timing"}))
    return by_kernel, stats


def phase_head_dim_256(torch, fluid, fa, card):
    """Head dims past 128 on the main path: the 8B width with
    HD256_HEADS heads (head dim 256) and HD256_KV kv heads, cut to
    HD256_LAYERS layers, through ``build_llama`` → ``Adam(1e-4)`` →
    ``Executor.run``: one bf16 train step at TRAIN_BATCH x TRAIN_SEQ (K1,
    K2 and K3 once a layer on their warpgroup kernels), one
    ``ServingEngine`` dispatch of that scope's test clone (K1 once a
    layer), and one float32 train step at
    HD256_F32_BATCH x HD256_F32_SEQ with TF32 off (K1, K2 and K3 once a
    layer on their float32 warpgroup kernels, none on the sliced
    ``_f32mma`` ones); every launch on its kernel symbol, none on the
    plain route, finite losses near ln V + dim·0.02²/2. Returns ({"bf16": ...,
    "f32": ...} launches by kernel symbol, stats)."""
    from paddle_tpu_torch.models.llama import LLAMA3_8B, build_llama
    from paddle_tpu_torch.serving import BucketSpec, ServingEngine
    tag = "head_dim_256"
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(LLAMA3_8B, n_layers=HD256_LAYERS,
                              n_heads=HD256_HEADS, n_kv_heads=HD256_KV)
    d = cfg.dim // cfg.n_heads
    check(d == 256, f"{tag}: head dim {d}")
    expected = math.log(cfg.vocab_size) + cfg.dim * INIT_STD ** 2 / 2
    stats = {"head_dim": d, "layers": cfg.n_layers, "heads": cfg.n_heads,
             "kv_heads": cfg.n_kv_heads, "first_loss_expected": expected,
             "card": card}
    launches = {}

    def one_step(name, cfg_, batch, seq, kernels):
        main, startup, loss = build_train(fluid, cfg_, 1e-4)
        scope = fluid.Scope()
        exe = fluid.Executor()                 # the card: CUDAPlace(0)
        exe.run(startup, scope=scope)
        feed = train_feed(cfg_.vocab_size, batch, seq)
        # the main path: counts reset just before, read just after
        fa.reset_launch_counts()
        out, ms = timed(torch, lambda: exe.run(main, feed=feed,
                                               fetch_list=[loss],
                                               scope=scope))
        by_kernel = launches_by_kernel(fa)
        first = float(np.asarray(out[0]).reshape(()))
        check(math.isfinite(first) and abs(first - expected) < 0.5,
              f"{tag} {name}: first loss {first:.4f} not within 0.5 of "
              f"{expected:.4f}")
        for sym in kernels:
            check(by_kernel[sym] == cfg_.n_layers,
                  f"{tag} {name}: {sym} launched {by_kernel[sym]} times, "
                  f"not once a layer ({cfg_.n_layers}): {by_kernel}")
        plain = {k: n for k, n in by_kernel.items() if "plain" in k and n}
        others = {k: n for k, n in by_kernel.items()
                  if k not in kernels and "plain" not in k and n}
        check(not plain and not others,
              f"{tag} {name}: launches off the {kernels}: {by_kernel}")
        stats[name] = {"batch": batch, "seq": seq, "first_loss": first,
                       "step_ms": ms, "launches_by_kernel": by_kernel}
        log(f"{tag} {name}: head dim {d}, {cfg_.n_layers} layers, "
            f"{batch} x {seq}: loss {first:.4f} (expected {expected:.4f}), "
            f"{ms:.1f} ms, launches {by_kernel}")
        return main, scope, exe, by_kernel

    # bf16: a train step (K1, K2 and K3 on their warpgroup kernels),
    # then one served dispatch of the scope
    bf16_kernels = tuple(fa.kernel_for(w, torch.bfloat16, d)[1]
                         for w in ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv"))
    check(bf16_kernels == ("flash_fwd_d256_wgmma", "flash_bwd_dq_d256_wgmma",
                           "flash_bwd_dkv_d256_wgmma"),
          f"{tag}: bf16 K1-K3 at D {d} route to {bf16_kernels}")
    k1 = bf16_kernels[0]
    _, scope, exe, by_kernel = one_step("bf16 train", cfg, TRAIN_BATCH,
                                        TRAIN_SEQ, bf16_kernels)
    launches["bf16"] = by_kernel
    serve_p, serve_s = fluid.Program(), fluid.Program()
    with fluid.program_guard(serve_p, serve_s), fluid.unique_name.guard():
        tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                                   dtype="int64", append_batch_size=False)
        logits, _ = build_llama(cfg, tokens)
    engine = ServingEngine(serve_p.clone(for_test=True), ["tokens"],
                           [logits], scope=scope,
                           buckets=BucketSpec(batch_sizes=(1,),
                                              seq_lens={"tokens": (256,)}))
    try:
        fa.reset_launch_counts()
        engine.warmup()
        req = np.random.RandomState(SEED + 6).randint(
            0, cfg.vocab_size, (1, 200)).astype(np.int64)
        ans = engine.infer({"tokens": req}, timeout=600.0)
        torch.cuda.synchronize()
        served = launches_by_kernel(fa)
        engine.assert_no_recompiles()
    finally:
        engine.close()
    ans = np.asarray(ans[0], np.float32)
    check(np.isfinite(ans).all() and ans.shape[-1] == cfg.vocab_size,
          f"{tag} serve: logits {ans.shape}, finite "
          f"{bool(np.isfinite(ans).all())}")
    check(served[k1] == 2 * cfg.n_layers
          and sum(served.values()) == 2 * cfg.n_layers,
          f"{tag} serve: K1 launches {served}, not {cfg.n_layers} a "
          f"dispatch (warmup + one request) on {k1}")
    launches["serve"] = served
    stats["serve"] = {"launches_by_kernel": served}
    log(f"{tag} serve: one request of 200 tokens (bucket 256), K1 "
        f"{served[k1]} launches on {k1}")
    del scope, exe, engine
    free_card(torch)

    # float32 with TF32 off: K1, K2 and K3 on their warpgroup kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    f32_kernels = tuple(fa.kernel_for(w, torch.float32, d)[1]
                        for w in ("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"))
    check(f32_kernels == ("flash_fwd_f32_d256_wgmma",
                          "flash_bwd_dq_f32_d256_wgmma",
                          "flash_bwd_dkv_f32_d256_wgmma"),
          f"{tag}: float32 K1-K3 at D {d} route to {f32_kernels}")
    _, scope, exe, by_kernel = one_step(
        "f32 train", dataclasses.replace(cfg, dtype="float32"),
        HD256_F32_BATCH, HD256_F32_SEQ, f32_kernels)
    launches["f32"] = by_kernel
    del scope, exe
    free_card(torch)
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"{tag}: " + json.dumps(stats))
    return launches, stats


def dec_prompts(vocab, n, rng):
    """``n`` prompts of DEC_PROMPT_RANGE tokens (lengths and tokens from
    ``rng``)."""
    lo, hi = DEC_PROMPT_RANGE
    return [rng.randint(0, vocab, (int(n_tok),)).astype(np.int64)
            for n_tok in rng.randint(lo, hi + 1, n)]


def dec_reference(fluid, exe, scope, cfg, prompt, fwd, new, **gen_kw):
    """The port's own ``llama_generate`` of ``prompt`` at batch 1 (its
    generated tokens and FirstProbs), and the float32 logits [T, V] of
    ``fwd`` (the K1 recompute, ``build_llama(shard_pp=True)``) over the
    generated sequence. Returns (tokens, first probs, logits)."""
    gen_p, _, (out_v, probs_v) = gen_programs(
        fluid, cfg, len(prompt), max_new_tokens=new, return_probs=True,
        **gen_kw)
    toks, probs = run_gen(exe, gen_p, [out_v, probs_v], scope, prompt[None])
    logits = None if fwd is None else dec_recompute(exe, scope, fwd, toks[0])
    return toks[0, len(prompt):], probs[0], logits


def dec_recompute(exe, scope, fwd, seq):
    """The float32 logits [T, V] of ``fwd`` (the K1 recompute,
    ``build_llama(shard_pp=True)``) over the token sequence ``seq``."""
    fwd_p, logits_v = fwd
    return exe.run(fwd_p, feed={"ftok": np.asarray(seq)[None]},
                   fetch_list=[logits_v], scope=scope, mode="test",
                   return_numpy=False)[0][0].float()


def dec_margins(torch, logits, prompt_len, toks):
    """Per generated token of ``toks`` (after a ``prompt_len``-token
    prompt), how far the logits [T, V] at the position before it put it
    below their argmax (0 where it is the argmax)."""
    rows = logits[prompt_len - 1:prompt_len - 1 + len(toks)]
    idx = torch.as_tensor(np.asarray(toks, np.int64), device=rows.device)
    return rows.amax(-1) - rows.gather(1, idx[:, None])[:, 0]


def dec_own_rule(torch, tag, exe, scope, fwd, prompt, got, allowed):
    """``got`` (an engine's tokens after ``prompt``) against the K1
    recompute of the engine's own sequence: at every position, the
    token within ``allowed`` logits of the recompute's argmax. Then a
    control, the same tokens after the prompt rolled by one position
    (what an engine reading each prompt token's K/V one place off would
    be conditioned on), which the rule must reject somewhere. Returns
    (positions at the argmax, the largest margin / ``allowed``,
    positions the control rejects)."""
    m = dec_margins(torch, dec_recompute(
        exe, scope, fwd, np.concatenate([prompt, got])), len(prompt), got)
    j = int(m.argmax())
    check(float(m[j]) <= allowed,
          f"{tag}: token {j} is {int(got[j])}, {float(m[j]):.3e} below the "
          f"argmax of the recompute of the engine's own sequence, past "
          f"{allowed:.3e}")
    ctl = dec_margins(torch, dec_recompute(
        exe, scope, fwd, np.concatenate([np.roll(prompt, 1), got])),
        len(prompt), got)
    rejected = int((ctl > allowed).sum())
    check(rejected > 0,
          f"{tag}: the rule passes the tokens after a prompt rolled by one "
          "(it cannot tell a wrong context)")
    return int((m == 0).sum()), float(m[j]) / allowed, rejected


def dec_within_flip_rule(tag, got, want, margin_of, allowed):
    """``got`` (an engine's tokens) against ``want`` (the generator's)
    of one request: equal, or equal up to a first difference at j where
    ``margin_of(j)`` (the reference's preference of want[j] over got[j],
    in logits) is at most ``allowed``; past a flip the two sequences go
    their own ways. Returns the tokens agreeing before the flip."""
    got, want = np.asarray(got), np.asarray(want)
    check(got.shape == want.shape,
          f"{tag}: {got.shape[0]} tokens, the generator's {want.shape[0]}")
    diff = np.nonzero(got != want)[0]
    if not len(diff):
        return int(got.shape[0])
    j = int(diff[0])
    margin = margin_of(j)
    check(margin <= allowed,
          f"{tag}: token {j} is {int(got[j])} where the generator's is "
          f"{int(want[j])}, with a margin {margin:.3e} > {allowed:.3e}")
    return j


def dec_serve(engine, prompts, clients, max_new=None):
    """Every prompt through ``engine`` by ``clients`` concurrent clients
    (each ``generate``s its share in turn), the engine's page occupancy
    sampled every DEC_PAGE_SAMPLE_S meanwhile. Returns (outputs in
    prompt order, wall s, page high-water mark)."""
    high = [engine.allocator.in_use]
    done = threading.Event()

    def sample():
        while not done.wait(DEC_PAGE_SAMPLE_S):
            high.append(engine.allocator.in_use)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    order = list(range(len(prompts)))

    def client(c):
        return [(i, engine.generate(prompts[i], max_new=max_new,
                                    timeout=900.0))
                for i in order[c::clients]]

    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(clients) as pool:
            results = [x for part in pool.map(client, range(clients))
                       for x in part]
    finally:
        done.set()
        sampler.join()
    wall = time.perf_counter() - t0
    outs = [None] * len(prompts)
    for i, toks in results:
        outs[i] = toks
    return outs, wall, max(high + [engine.allocator.in_use])


def phase_decode_engine(torch, fluid, fa, card, then=None):
    """ROADMAP item 4b, the main path of this slice: the Llama-3-8B width
    (DEC_LAYERS of its 32 layers, bf16, random weights from SEED through
    ``build_llama_generator``'s startup) behind ``DecodeEngine`` built
    with no place (the card) and DEC_CONFIG: warmup, then DEC_REQUESTS
    requests of DEC_PROMPT_RANGE prompt tokens from DEC_CLIENTS
    concurrent clients; every request's tokens against the port's own
    ``llama_generate`` of that prompt at batch 1, a flip allowed only
    where the K1 recompute of the generator's sequence puts the two
    tokens within twice the row's first-step logit error (the generate
    phase's rule: a batch of 8 rounds bf16 in other GEMM shapes than
    batch 1), and at every one of the new tokens, past any flip, each
    token within that error of the argmax of the K1 recompute of the
    engine's own sequence (with a control the rule must reject); no
    step build after warmup; the pools written in place on the card;
    every page back after a drain. Then a float32 engine at
    DEC_F32_LAYERS layers (TF32 off), exact wherever the recompute's
    margin exceeds the f32 logit tier; and, at max_batch
    DEC_SMALL_BATCH on DEC_SMALL_REQUESTS prompts, ``quantize=True``
    against the quantized generator, speculative mode (the target as
    its own draft, accepting drafts, then a DEC_DRAFT_LAYERS-layer draft
    cut from the target, gamma DEC_GAMMA) and ``chunk_size=DEC_CHUNK`` against the generator. Prints TTFT
    p50/p99, decode ms a token per slot beside the bound of reading the
    weights once, aggregate tokens/s, the device's idle share and the
    page high-water mark. ``then(dec)``, when given, runs after the main
    wave's checks with its config, scope, prompts and tokens (the
    cluster_decode phase). Returns (K1 launches of the checks'
    recompute, stats)."""
    from paddle_tpu_torch.models.llama import (LLAMA3_8B,
                                               copy_weights_as_draft,
                                               quantize_generator_weights)
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine
    tag = "decode_engine"
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(LLAMA3_8B, n_layers=DEC_LAYERS)
    _, startup, _ = gen_programs(fluid, cfg, DEC_PROMPT_RANGE[1],
                                 max_new_tokens=1)
    scope = fluid.Scope()
    exe = fluid.Executor()                     # the card: CUDAPlace(0)
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    stats = {"layers": cfg.n_layers, "config": DEC_CONFIG,
             "requests": DEC_REQUESTS, "clients": DEC_CLIENTS,
             "startup_s": time.perf_counter() - t0, "card": card}
    rng = np.random.RandomState(SEED + 7)
    prompts = dec_prompts(cfg.vocab_size, DEC_REQUESTS, rng)
    new = DEC_CONFIG["max_new_tokens"]
    # the prompts of the max_batch DEC_SMALL_BATCH engines below: the
    # longest (chunked prefill needs prompts past DEC_CHUNK)
    small = sorted(range(DEC_REQUESTS), key=lambda i: -len(prompts[i]))
    small = small[:DEC_SMALL_REQUESTS]

    # the main path: counts reset just before, read just after
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    engine = DecodeEngine(cfg, scope=scope, config=DecodeConfig(
        default_timeout_s=900.0, **DEC_CONFIG))
    try:
        check(engine.exe.device.type == "cuda"
              and engine._kp.device.type == "cuda",
              f"{tag}: the engine with no place runs on "
              f"{engine.exe.device}, its pools on {engine._kp.device}")
        pools = (engine._kp.data_ptr(), engine._vp.data_ptr())
        warm = engine.warmup()
        warm_s = time.perf_counter() - t0
        outs, wall, high = dec_serve(engine, prompts, DEC_CLIENTS)
        engine.assert_no_recompiles()
        st = engine.stats()
        check((engine._kp.data_ptr(), engine._vp.data_ptr()) == pools,
              f"{tag}: the pools were replaced, not written in place")
    finally:
        engine.close(drain=True)
    by_kernel = launches_by_kernel(fa)
    check(not any(by_kernel.values()),
          f"{tag}: the paged ops launched attention kernels {by_kernel}")
    check(engine.allocator.in_use == 0 and st["pages_in_use"] == 0,
          f"{tag}: {engine.allocator.in_use} pages still held after the "
          "drain")
    check(st["responses_total"] == DEC_REQUESTS
          and all(o is not None and len(o) == new for o in outs),
          f"{tag}: {st['responses_total']} responses of {DEC_REQUESTS}")
    generated = sum(len(o) for o in outs)
    bound_ms = decode_weight_bytes(scope) / HBM_BYTES_PER_S * 1e3
    stats.update({
        "warmup": warm, "warmup_s": warm_s, "wave_s": wall,
        "tokens_per_s": generated / wall,
        "ttft_ms": {k: st["ttft_s"][k] for k in ("p50_ms", "p99_ms")},
        "decode_ms_per_token_per_slot": {
            k: st["tpot_s"][k] for k in ("p50_ms", "p99_ms")},
        "decode_bound_ms": bound_ms, "page_high_water": high,
        "pages_usable": engine.allocator.usable_pages,
        "step_builds_after_warmup": 0,
        "dispatches": {k: st[k] for k in ("prefill_total",
                                          "decode_batches_total")}})
    log(f"{tag}: {DEC_REQUESTS} requests ({min(map(len, prompts))}-"
        f"{max(map(len, prompts))} prompt tokens, {new} new) from "
        f"{DEC_CLIENTS} clients in {wall:.2f} s on {card}: "
        f"{stats['tokens_per_s']:.1f} tokens/s, TTFT p50/p99 "
        f"{stats['ttft_ms']['p50_ms']:.1f}/{stats['ttft_ms']['p99_ms']:.1f}"
        f" ms, decode {stats['decode_ms_per_token_per_slot']['p50_ms']:.2f}"
        f"/{stats['decode_ms_per_token_per_slot']['p99_ms']:.2f} ms a "
        f"token a slot (p50/p99) beside the {bound_ms:.2f} ms bound of "
        f"reading the weights once, page high-water {high} of "
        f"{engine.allocator.usable_pages}; warmup {warm} in {warm_s:.2f} s,"
        " no step build after it, every page back after the drain")

    # each request against the generator at batch 1 (the checks: K1 in
    # the recompute, counted apart from the engine's path above)
    fwd = recompute_program(fluid, cfg)
    fa.reset_launch_counts()
    refs, agreed, own = [], [], []
    for i, (p, got) in enumerate(zip(prompts, outs)):
        want, probs, logits = dec_reference(fluid, exe, scope, cfg, p, fwd,
                                            new)
        row_err = log_prob_error(torch, torch.as_tensor(probs)[None].to(
            logits.device), logits[None, len(p) - 1])[0]
        # the recompute's logits are kept for the prompts served again
        refs.append((want, logits if i in small else None, row_err))
        agreed.append(dec_within_flip_rule(
            f"{tag} request {i}", got, want,
            lambda j: float(logits[len(p) + j - 1, want[j]]
                            - logits[len(p) + j - 1, got[j]]),
            2 * row_err))
        own.append(dec_own_rule(torch, f"{tag} request {i}", exe, scope,
                                fwd, p, got, 2 * row_err))
    check_launches = launches_by_kernel(fa)
    # three recomputes a request: the generator's sequence, the
    # engine's, and the engine's tokens after the rolled prompt
    check(check_launches[bf16_k1(torch, fa, cfg)]
          == 3 * cfg.n_layers * DEC_REQUESTS,
          f"{tag}: the recompute's K1 launches {check_launches}")
    stats["agreed_before_flip"] = agreed
    stats["own_sequence"] = {
        "at_argmax": [o[0] for o in own],
        "worst_margin_over_allowed": max(o[1] for o in own),
        "control_rejected": [o[2] for o in own]}
    worst = stats["own_sequence"]["worst_margin_over_allowed"]
    log(f"{tag}: tokens equal to the generator's before any allowed flip "
        f"{agreed} of {new} (equal throughout: "
        f"{sum(a == new for a in agreed)} of {DEC_REQUESTS}); against the "
        f"recompute of the engine's own sequence, every token within the "
        f"rule (worst {worst:.3f} of it), at the argmax "
        f"{stats['own_sequence']['at_argmax']} of {new}; the control "
        f"(prompt rolled by one) rejected at "
        f"{stats['own_sequence']['control_rejected']} of {new} positions")
    if then is not None:
        free_card(torch)
        then({"cfg": cfg, "scope": scope, "prompts": prompts, "outs": outs})
        free_card(torch)

    # the device's idle share over a shorter wave, against the same wave
    # unprofiled
    prof_prompts = prompts[:DEC_PROFILED_REQUESTS]
    engine = DecodeEngine(cfg, scope=scope, config=DecodeConfig(
        default_timeout_s=900.0, **DEC_CONFIG))
    try:
        engine.warmup()
        dec_serve(engine, prof_prompts, DEC_CLIENTS, DEC_PROFILED_NEW)
        _, prof_wall, _ = dec_serve(engine, prof_prompts, DEC_CLIENTS,
                                    DEC_PROFILED_NEW)
        busy = {"requests": DEC_PROFILED_REQUESTS,
                "new_tokens": DEC_PROFILED_NEW, "wall_ms": prof_wall * 1e3}
        add_busy(busy, device_ms_by_kind(torch, lambda: dec_serve(
            engine, prof_prompts, DEC_CLIENTS, DEC_PROFILED_NEW)),
            prof_wall * 1e3)
    finally:
        engine.close()
    stats["device"] = busy
    log(f"{tag}: device over {DEC_PROFILED_REQUESTS} requests x "
        f"{DEC_PROFILED_NEW} tokens on {card}: " + json.dumps(busy))

    # once each at max_batch DEC_SMALL_BATCH: chunked prefill (the
    # longest prompts, past DEC_CHUNK), W8A8, speculative
    check(len(prompts[small[0]]) > DEC_CHUNK,
          f"{tag}: no prompt past the chunk size {DEC_CHUNK}")
    small_conf = dict(DEC_CONFIG, max_batch=DEC_SMALL_BATCH,
                      default_timeout_s=900.0)

    def bf16_rule(name, eng_outs):
        """Each of the small runs' requests against the generator up to
        a flip, and against the recompute of its own sequence at every
        position; returns the tokens agreeing before the flip."""
        out = []
        for i, got in zip(small, eng_outs):
            want, logits, row_err = refs[i]
            p = prompts[i]
            out.append(dec_within_flip_rule(
                f"{tag} {name} request {i}", got, want,
                lambda j: float(logits[len(p) + j - 1, want[j]]
                                - logits[len(p) + j - 1, got[j]]),
                2 * row_err))
            dec_own_rule(torch, f"{tag} {name} request {i}", exe, scope,
                         fwd, p, got, 2 * row_err)
        return out

    engine = DecodeEngine(cfg, scope=scope, config=DecodeConfig(
        chunk_size=DEC_CHUNK, **small_conf))
    try:
        engine.warmup()
        c_outs, _, _ = dec_serve(engine, [prompts[i] for i in small],
                                 DEC_SMALL_BATCH)
        engine.assert_no_recompiles()
        c_st = engine.stats()
    finally:
        engine.close()
    check(c_st["chunk_prefill_total"] > 0, f"{tag} chunk: no chunk ran")
    stats["chunk"] = {"chunk_size": DEC_CHUNK,
                      "chunk_dispatches": c_st["chunk_prefill_total"],
                      "agreed_before_flip": bf16_rule("chunk", c_outs)}
    log(f"{tag} chunk: " + json.dumps(stats["chunk"]))

    # W8A8: a scope aliasing the bf16 tensors, its matmul weights and
    # head replaced by int8 with @scale companions; held to the
    # quantized generator at batch 1. Where the two differ, the
    # generator fed the shared prefix scores the two tokens, within
    # twice the row's first-step logit error: the larger of its
    # log-prob distance between that generator at batch 1 with a cache
    # of prompt + new and at batch DEC_SMALL_BATCH (the prompt repeated)
    # with a cache of prompt + 1 (other GEMM shapes and reduction
    # lengths, the same rows), and the bf16 row's error (the int8
    # products are exact; what rounds differently is the bf16 work
    # between them)
    qscope = fluid.Scope()
    for n in scope.keys():
        qscope.set(n, scope.find_var(n))
    quantize_generator_weights(qscope)
    engine = DecodeEngine(cfg, scope=qscope, config=DecodeConfig(
        quantize=True, **small_conf))
    try:
        engine.warmup()
        q_outs, _, _ = dec_serve(engine, [prompts[i] for i in small],
                                 DEC_SMALL_BATCH)
        engine.assert_no_recompiles()
    finally:
        engine.close()
    q_agreed = []
    for i, got in zip(small, q_outs):
        p = prompts[i]
        want, probs, _ = dec_reference(fluid, exe, qscope, cfg, p, None,
                                       new, quantize=True)
        g4_p, _, (_, g4_probs) = gen_programs(
            fluid, cfg, len(p), max_new_tokens=1, return_probs=True,
            quantize=True)
        p4 = run_gen(exe, g4_p, [g4_probs], qscope,
                     np.repeat(p[None], DEC_SMALL_BATCH, 0))[0]
        row_err = max(refs[i][2], float(np.abs(
            np.log(np.maximum(p4, 1e-30))
            - np.log(np.maximum(probs, 1e-30))).max()))

        def margin(j, p=p, want=want, got=got):
            tf = np.concatenate([p, want[:j]])
            tf_p, _, (_, tf_probs) = gen_programs(
                fluid, cfg, len(tf), max_new_tokens=1, return_probs=True,
                quantize=True)
            dist = run_gen(exe, tf_p, [tf_probs], qscope, tf[None])[0][0]
            return float(np.log(max(dist[want[j]], 1e-30))
                         - np.log(max(dist[got[j]], 1e-30)))
        q_agreed.append(dec_within_flip_rule(
            f"{tag} w8a8 request {i}", got, want, margin,
            2 * row_err))
    stats["w8a8"] = {"agreed_before_flip": q_agreed}
    log(f"{tag} w8a8: " + json.dumps(stats["w8a8"]))
    del qscope
    free_card(torch)

    # speculative, first with the target as its own draft (the drafts
    # accepted, so the multi-token commit, the truncation of rejected
    # rows and the advance across pages run), then a DEC_DRAFT_LAYERS-
    # layer draft, the target's first layers (views of its stacks) with
    # its embedding and head
    copy_weights_as_draft(scope)
    engine = DecodeEngine(cfg, scope=scope, draft_cfg=cfg,
                          config=DecodeConfig(gamma=DEC_GAMMA,
                                              **small_conf))
    try:
        engine.warmup()
        ss_outs, ss_wall, _ = dec_serve(engine, [prompts[i] for i in small],
                                        DEC_SMALL_BATCH)
        engine.assert_no_recompiles()
        ss_st = engine.stats()
    finally:
        engine.close()
    check(ss_st["spec_rounds_total"] > 0,
          f"{tag} spec self-draft: no round ran")
    accepted = ss_st["spec_tokens_accepted_total"] / ss_st[
        "spec_rounds_total"]
    check(accepted > 1, f"{tag} spec self-draft: {accepted:.3f} tokens a "
          "round, no draft token accepted")
    stats["spec_self_draft"] = {
        "draft_layers": cfg.n_layers, "gamma": DEC_GAMMA,
        "rounds": ss_st["spec_rounds_total"],
        "accepted_per_round": accepted,
        "tokens_per_s": sum(map(len, ss_outs)) / ss_wall,
        "agreed_before_flip": bf16_rule("spec self-draft", ss_outs)}
    log(f"{tag} spec self-draft: " + json.dumps(stats["spec_self_draft"]))
    for sfx in ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
                "w_up", "w_down"):
        scope.set(f"draft.{sfx}", scope.find_var(f"draft.{sfx}")[
            :DEC_DRAFT_LAYERS])
    draft_cfg = dataclasses.replace(cfg, n_layers=DEC_DRAFT_LAYERS)
    engine = DecodeEngine(cfg, scope=scope, draft_cfg=draft_cfg,
                          config=DecodeConfig(gamma=DEC_GAMMA,
                                              **small_conf))
    try:
        engine.warmup()
        s_outs, s_wall, _ = dec_serve(engine, [prompts[i] for i in small],
                                      DEC_SMALL_BATCH)
        engine.assert_no_recompiles()
        s_st = engine.stats()
    finally:
        engine.close()
    check(s_st["spec_rounds_total"] > 0, f"{tag} spec: no round ran")
    stats["spec"] = {
        "draft_layers": DEC_DRAFT_LAYERS, "gamma": DEC_GAMMA,
        "rounds": s_st["spec_rounds_total"],
        "accepted_per_round": s_st["spec_tokens_accepted_total"]
        / s_st["spec_rounds_total"],
        "tokens_per_s": sum(map(len, s_outs)) / s_wall,
        "agreed_before_flip": bf16_rule("spec", s_outs)}
    log(f"{tag} spec: " + json.dumps(stats["spec"]))
    del scope, refs
    free_card(torch)

    # float32 at DEC_F32_LAYERS layers, TF32 off: exact wherever the
    # recompute's margin exceeds the f32 logit tier
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, n_layers=DEC_F32_LAYERS,
                                dtype="float32")
    _, st32, _ = gen_programs(fluid, cfg32, DEC_PROMPT_RANGE[1],
                              max_new_tokens=1)
    scope32 = fluid.Scope()
    exe.run(st32, scope=scope32)
    p32 = prompts[:DEC_F32_REQUESTS]
    engine = DecodeEngine(cfg32, scope=scope32, config=DecodeConfig(
        default_timeout_s=900.0, **DEC_CONFIG))
    try:
        engine.warmup()
        o32, _, _ = dec_serve(engine, p32, DEC_CLIENTS)
        engine.assert_no_recompiles()
    finally:
        engine.close(drain=True)
    fwd32 = recompute_program(fluid, cfg32)
    rtol, atol = TOL_LOGITS_F32
    f32_agreed = []
    fa.reset_launch_counts()
    for i, (p, got) in enumerate(zip(p32, o32)):
        want, _, logits = dec_reference(fluid, exe, scope32, cfg32, p,
                                        fwd32, new)

        def undecided(j, p=p, want=want, got=got, logits=logits):
            row = logits[len(p) + j - 1]
            # the preference of the generator's token over the engine's,
            # less twice the f32 tier: > 0 only where the tier decides
            return float(row[want[j]] - row[got[j]]) - 2 * (
                atol + rtol * float(row[want[j]].abs()))
        f32_agreed.append(dec_within_flip_rule(
            f"{tag} f32 request {i}", got, want, undecided, 0.0))
    # the recompute: K1 once a layer a request, on the kernel float32
    # routes to at the 8B head dim
    f32_launches = launches_by_kernel(fa)
    check(f32_launches[f32_kernel(torch, fa, "flash_fwd",
                                  cfg.dim // cfg.n_heads)]
          == fa.flash_fwd.launches == DEC_F32_LAYERS * DEC_F32_REQUESTS,
          f"{tag} f32: the recompute's K1 launches {f32_launches}")
    stats["f32"] = {"layers": DEC_F32_LAYERS, "requests": DEC_F32_REQUESTS,
                    "agreed_before_undecided": f32_agreed,
                    "launches_by_kernel": f32_launches}
    log(f"{tag} f32: " + json.dumps(stats["f32"]))
    del scope32
    free_card(torch)
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"{tag}: " + json.dumps(stats))
    return check_launches, stats


# ---------------------------------------------------------------------------
# ROADMAP item 5: conv nets (ResNet-50, the reference's primary benchmark)
# ---------------------------------------------------------------------------

RN_BATCH = 128                  # bench.py conv_main's batch on the chip
RN_HW = 224
RN_CLASSES = 1000
RN_LR = 0.1                     # bench.py: Momentum(0.1, 0.9)
RN_REPEATS = 4                  # steps a timed run(repeats=) takes
RN_TIMED_RUNS = 2               # timed runs a configuration
RN_VARIANT_STEPS = 2            # steps a variant is held over
# train FLOP an image at 224² (bench.py:403-405: 3 x the forward's 4.09
# GFLOP) against the card's bf16 peak
RN_TRAIN_FLOP = 3 * 4.09e9
RN_LOSS_BAND = 1.5              # |first loss - ln 1000| allowed
RN_BF16_RTOL = 2e-2             # losses of two bf16 runs (layouts, remat)
RN_PARITY_BATCH = 2
RN_STEM = "conv2d_0.w_0"
RN_PARITY_TOL = (2e-3, 2e-4)    # card against host, float32, TF32 off
RN_SERVE_BUCKETS = (1, 8, 32)
RN_SERVE_REQUESTS = 64
RN_SERVE_CLIENTS = 8
# tests/test_transpilers.py's fold tier, held normwise as
# tools/optcheck.py holds its tolerances (|Δ| <= atol + rtol · max|want|):
# a trained model's logits span decades, and float32 rounds the largest
# (1.6e8 after the train phase's steps) to 16
RN_FOLD_TOL = (1e-4, 1e-5)
# an NHWC step may copy no activation to relayout it: a clone of more
# elements than the largest filter (512 x 512 x 3 x 3) is an activation
RN_ACTIVATION_NUMEL = 512 * 512 * 3 * 3
RN_QUANT_REL = 0.05             # tests/test_quantize.py:79
ZOO_CONV = ("mnist", "vgg", "resnet", "se_resnext")
ZOO_BATCH = 16
ZOO_STEPS = 3
# the zoo's later steps, card against CPU: VGG's fc batch norm over 16
# rows amplifies the float order (the two packages' float32 losses on
# the CPU reach 6.1e-3 of |a| + 0.1 apart by step 3), so steps past the
# first hold at this rtol; the first step at RN_PARITY_TOL
ZOO_LATER_RTOL = 2e-2


def conv_kind(name):
    """The kind of one device kernel of a conv-net step, by its name."""
    n = name.lower()
    if "direct_copy" in n:
        return "direct_copy"
    if any(w in n for w in ("nchwtonhwc", "nhwctonchw", "nchw_to_nhwc",
                            "nhwc_to_nchw")):
        return "layout_transform"
    if any(w in n for w in ("conv", "cudnn", "xmma", "implicit", "dgrad",
                            "wgrad", "fprop", "sm90_", "sm80_")):
        return "conv"
    if any(w in n for w in ("gemm", "nvjet", "cutlass", "matmul")):
        return "matmul"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if any(w in n for w in ("elementwise", "reduce", "batch_norm",
                            "vectorized", "unrolled", "pool", "norm")):
        return "bn_and_elementwise"
    return "other"


def activation_clones(torch, fn):
    """The ``aten.clone`` calls (what ``.contiguous()`` and
    ``.clone()`` dispatch) of one call of ``fn`` whose input is
    activation-sized (more than RN_ACTIVATION_NUMEL elements), as
    (shape, strides) pairs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Clones(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.clone.default \
                    and args[0].numel() > RN_ACTIVATION_NUMEL:
                self.seen.append((list(args[0].shape),
                                  list(args[0].stride())))
            return func(*args, **(kwargs or {}))

    with Clones() as mode:
        fn()
        torch.cuda.synchronize()
    return mode.seen


def normwise_close(got, want, tol):
    """(max |got - want| <= atol + rtol · max |want|, that error)."""
    rtol, atol = tol
    err = float(np.abs(got.astype(np.float64) - want).max())
    return err <= atol + rtol * float(np.abs(want).max()), err


def conv_ms_by_kind(torch, fn):
    """Device ms of one call of ``fn`` by kind (``conv_kind``), the
    optimizer segment's span and kernels (the lowering's profiler range)
    and the eight largest kernels by name; None where the profiler sees
    no device time."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.core.lowering import RANGE_OPTIMIZER

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [e.time_range for e in on_device if e.name == RANGE_OPTIMIZER]
    kinds, names = {}, {}
    opt_ms = 0.0
    # the device time of the copies by the aten op that made them:
    # dtype casts (the AMP casts, batch norm's float32 widening) and
    # clones (.contiguous(): relayouts)
    by_op = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
             if e.key in ("aten::_to_copy", "aten::clone")}
    for e in on_device:
        if e.name == RANGE_OPTIMIZER:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        k = conv_kind(e.name)
        kinds[k] = kinds.get(k, 0.0) + ms
        names[e.name[:100]] = names.get(e.name[:100], 0.0) + ms
        if any(s.start <= e.time_range.start < s.end for s in spans):
            opt_ms += ms
    if not kinds:
        return None
    return {"device_busy_ms": sum(kinds.values()),
            "device_ms_by_kind": kinds,
            "optimizer_kernels_ms": opt_ms,
            "optimizer_span_ms": sum(s.elapsed_us() for s in spans) / 1e3,
            "copies_ms_by_aten_op": by_op,
            "top": sorted(names.items(), key=lambda kv: -kv[1])[:8]}


def resnet_program(fluid, layout, amp=True, fuse=False, policy=None,
                   dtype="float32", classes=RN_CLASSES, recordio=None):
    """``bench.py`` conv_main's program: ``resnet50`` at 3 x 224²,
    ``classes`` classes (its 1000 unless named), ``Momentum(0.1, 0.9)``,
    then its transpiles in its order (fused updates, remat, AMP O2).
    With ``recordio`` (a path) the images and labels come from
    ``open_recordio_file`` -> ``batch(RN_BATCH)`` -> ``read_file``
    instead of data layers. Returns (main, startup, loss), and with
    ``recordio`` the reader too."""
    from paddle_tpu_torch.models.resnet import resnet50
    from paddle_tpu_torch.transpiler import (amp_transpile,
                                             fuse_optimizer_ops)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if recordio is None:
            img = fluid.layers.data(name="img", shape=[3, RN_HW, RN_HW],
                                    dtype=dtype)
            label = fluid.layers.data(name="label", shape=[1],
                                      dtype="int64")
        else:
            reader = fluid.layers.batch(fluid.layers.open_recordio_file(
                recordio, shapes=[[-1, 3, RN_HW, RN_HW], [-1, 1]],
                dtypes=[dtype, "int64"]), RN_BATCH)
            img, label = fluid.layers.read_file(reader)
        loss, _, _ = resnet50(img, label, class_num=classes,
                              layout=layout)
        fluid.optimizer.Momentum(learning_rate=RN_LR,
                                 momentum=0.9).minimize(loss)
    if fuse:
        fuse_optimizer_ops(main, startup)
    if policy:
        fluid.memory_optimize(main, policy=policy)
    if amp:
        amp_transpile(main, level="O2")
    if recordio is not None:
        return main, startup, loss, reader
    return main, startup, loss


def resnet_infer_program(fluid, layout, amp=True, dtype="float32"):
    """The served forward: ``resnet_imagenet(depth=50)``'s softmax over
    an image feed of ``dtype`` (the training program's parameter names),
    AMP O2 when ``amp``. Returns (program, prediction)."""
    from paddle_tpu_torch.models.resnet import resnet_imagenet
    from paddle_tpu_torch.transpiler import amp_transpile
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, RN_HW, RN_HW],
                                dtype=dtype)
        pred = resnet_imagenet(img, class_num=RN_CLASSES, depth=50,
                               layout=layout)
    test = main.clone(for_test=True)
    if amp:
        amp_transpile(test, level="O2")
    return test, pred


def resnet_feed(torch, batch, dev, seed=SEED):
    """bench.py's images (uniform [0, 1), 3 x 224²) and labels, staged on
    ``dev`` once."""
    rng = np.random.RandomState(seed)
    return {"img": torch.from_numpy(rng.rand(batch, 3, RN_HW, RN_HW)
                                    .astype(np.float32)).to(dev),
            "label": torch.from_numpy(rng.randint(
                0, RN_CLASSES, (batch, 1)).astype(np.int64)).to(dev)}


def scope_from(fluid, state):
    """A scope of its own holding a copy of each tensor of ``state``."""
    scope = fluid.Scope()
    for n, v in state.items():
        scope.set(n, v.clone())
    return scope


def executed_layout(program):
    """bench.py:181's rule: the formats the conv, pool and batch-norm ops
    of ``program`` run in ("NCHW", "NHWC" or "mixed(...)")."""
    fmts = {op.attrs.get("data_format", op.attrs.get("data_layout", "NCHW"))
            for op in program.global_block().ops
            if op.type in ("conv2d", "depthwise_conv2d", "pool2d",
                           "batch_norm")}
    return fmts.pop() if len(fmts) == 1 else \
        "mixed(" + ",".join(sorted(fmts)) + ")"


def resnet_steps(exe, main, loss, scope, feed, steps):
    """``steps`` train steps, one ``run`` each; the losses."""
    return [float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0].reshape(()))
            for _ in range(steps)]


def resnet_timed(torch, exe, main, loss, scope, feed, tag):
    """RN_TIMED_RUNS runs of ``run(..., repeats=RN_REPEATS)`` after the
    caller's warmup: each run's ms a step (host clock, synchronized),
    images/s, the share of the bf16 peak, the peak memory over them, and
    one more step's device time by kind, with the idle share of the
    median step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(RN_TIMED_RUNS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                      return_numpy=False, repeats=RN_REPEATS)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3 / RN_REPEATS)
    last = float(out[0].float().reshape(()).cpu())
    check(math.isfinite(last), f"{tag}: non-finite loss {last}")
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(step_ms))
    ips = RN_BATCH / (med / 1e3)
    prof = conv_ms_by_kind(torch, lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope,
        return_numpy=False))
    stats = {"step_ms": step_ms, "images_per_s": ips,
             "bf16_peak_share": ips * RN_TRAIN_FLOP / PEAK_FLOPS["bfloat16"],
             "peak_gb": peak / 1e9, "last_loss": last}
    if prof is None:
        stats["device_busy_ms"] = "not measured"
    else:
        stats.update(prof)
        # against the timed steps' median: the profiled step's own wall
        # carries the profiler's start-up
        stats["device_idle_share"] = 1 - prof["device_busy_ms"] / med
    return stats


def phase_resnet50_train(torch, fluid, fa, card):
    """The main path of this slice: ``bench.py``'s default configuration
    (ResNet-50, 3 x 224², 1000 classes, batch 128, Momentum(0.1, 0.9),
    AMP O2) through ``Executor()`` with no place, once with
    ``layout="NHWC"`` and once with ``"NCHW"``, both from one initial
    scope: 2 warmup steps, then RN_TIMED_RUNS x RN_REPEATS timed steps.
    Checks: the first losses finite, within RN_LOSS_BAND of ln 1000 and
    within RN_BF16_RTOL of each other; no attention kernel launched.
    Then the variants, each timed the same way: ``fuse_optimizer_ops``
    (its parameters after RN_VARIANT_STEPS steps bit-equal to the
    per-parameter run's, both with deterministic cuDNN),
    ``memory_optimize`` ``recompute_norms`` and ``save_conv_only``
    (losses within RN_BF16_RTOL of no remat) and the ``"layout"`` pass
    over the NCHW program (its executed layout, losses within
    RN_BF16_RTOL). Returns (attention launches by kernel symbol, the
    trained NHWC scope, stats)."""
    tag = "resnet50_train"
    exe = fluid.Executor()                    # the card: CUDAPlace(0)
    dev = exe.device
    feed = resnet_feed(torch, RN_BATCH, dev)
    torch.backends.cudnn.allow_tf32 = True    # the defaults: bf16 convs
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = False
    stats, first, scopes = {}, {}, {}
    init = None
    fa.reset_launch_counts()
    for layout in ("NHWC", "NCHW"):
        main, startup, loss = resnet_program(fluid, layout)
        if init is None:
            s0 = fluid.Scope()
            exe.run(startup, scope=s0)
            init = {n: v.clone() for n, v in s0.vars.items()}
            del s0
        scope = scope_from(fluid, init)
        warm = resnet_steps(exe, main, loss, scope, feed, 2)
        first[layout] = warm[0]
        s = resnet_timed(torch, exe, main, loss, scope, feed,
                         f"{tag} {layout}")
        s["first_losses"] = warm
        clones = activation_clones(torch, lambda: exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope,
            return_numpy=False))
        s["activation_clones"] = len(clones)
        check(layout != "NHWC" or not clones,
              f"{tag} NHWC: {len(clones)} activation-sized copies a step "
              f"(first: {clones[:2]})")
        stats[layout] = s
        scopes[layout] = scope
        log(f"{tag} {layout}: " + json.dumps(s))
        free_card(torch)
    by_kernel = launches_by_kernel(fa)
    check(not any(by_kernel.values()),
          f"{tag}: attention launched on a ResNet step: {by_kernel}")
    for layout, loss0 in first.items():
        check(math.isfinite(loss0) and abs(loss0 - math.log(RN_CLASSES))
              < RN_LOSS_BAND,
              f"{tag} {layout}: first loss {loss0} not near ln "
              f"{RN_CLASSES} = {math.log(RN_CLASSES):.4f}")
    check(abs(first["NHWC"] - first["NCHW"])
          <= RN_BF16_RTOL * abs(first["NCHW"]),
          f"{tag}: first losses NHWC {first['NHWC']} and NCHW "
          f"{first['NCHW']} differ beyond rtol {RN_BF16_RTOL}")
    del scopes["NCHW"]
    free_card(torch)

    # fused optimizer updates: exact against the per-parameter updates
    # with deterministic cuDNN, then timed
    torch.backends.cudnn.deterministic = True
    per_main, _, per_loss = resnet_program(fluid, "NHWC")
    fused_main, fused_startup, fused_loss = resnet_program(
        fluid, "NHWC", fuse=True)
    per_scope = scope_from(fluid, init)
    fused_scope = fluid.Scope()
    exe.run(fused_startup, scope=fused_scope)
    for n in [p.name for p in per_main.all_parameters()] + [
            n for n in init if ".global_" in n]:
        fused_scope.set(n, init[n].clone())
    per_losses = resnet_steps(exe, per_main, per_loss, per_scope,
                              feed, RN_VARIANT_STEPS)
    fused_losses = resnet_steps(exe, fused_main, fused_loss,
                                fused_scope, feed, RN_VARIANT_STEPS)
    params = [p.name for p in per_main.all_parameters()]
    unequal = [n for n in params if not torch.equal(
        per_scope.find_var(n), fused_scope.find_var(n))]
    check(not unequal and per_losses == fused_losses,
          f"{tag} fused: {len(unequal)} of {len(params)} parameters differ "
          f"from the per-parameter run after {RN_VARIANT_STEPS} steps "
          f"(first: {unequal[:3]}); losses {fused_losses} vs {per_losses}")
    n_update_ops = (sum(op.type == "momentum" for op in
                        per_main.global_block().ops),
                    sum(op.type == "momentum" for op in
                        fused_main.global_block().ops))
    torch.backends.cudnn.deterministic = False
    del per_scope
    free_card(torch)
    s = resnet_timed(torch, exe, fused_main, fused_loss, fused_scope, feed,
                     f"{tag} fused")
    s.update(first_losses=fused_losses, bit_equal_params=len(params),
             momentum_ops=n_update_ops, deterministic_check="cudnn."
             "deterministic=True, benchmark=False")
    stats["fuse_optimizer_ops"] = s
    log(f"{tag} fuse_optimizer_ops: " + json.dumps(s))
    del fused_scope
    free_card(torch)

    # remat: the two conv-net policies against no remat
    base = stats["NHWC"]["first_losses"]
    for policy in ("recompute_norms", "save_conv_only"):
        main, _, loss = resnet_program(fluid, "NHWC", policy=policy)
        scope = scope_from(fluid, init)
        losses = resnet_steps(exe, main, loss, scope, feed, 2)
        check(np.allclose(losses, base, rtol=RN_BF16_RTOL, atol=0),
              f"{tag} {policy}: losses {losses} vs no remat {base} beyond "
              f"rtol {RN_BF16_RTOL}")
        s = resnet_timed(torch, exe, main, loss, scope, feed,
                         f"{tag} {policy}")
        s.update(first_losses=losses,
                 peak_gb_without_remat=stats["NHWC"]["peak_gb"])
        stats[policy] = s
        log(f"{tag} {policy}: " + json.dumps(s))
        del scope
        free_card(torch)

    # the "layout" rewrite over the NCHW program
    main, _, loss = resnet_program(fluid, "NCHW")
    report = main.optimize(fetch_list=[loss.name], passes=("layout",))
    scope = scope_from(fluid, init)
    losses = resnet_steps(exe, main, loss, scope, feed, 2)
    nchw = stats["NCHW"]["first_losses"]
    check(np.allclose(losses, nchw, rtol=RN_BF16_RTOL, atol=0),
          f"{tag} layout pass: losses {losses} vs NCHW {nchw} beyond rtol "
          f"{RN_BF16_RTOL}")
    s = resnet_timed(torch, exe, main, loss, scope, feed,
                     f"{tag} layout pass")
    s.update(first_losses=losses, executed_layout=executed_layout(main),
             declared_layout="NCHW", converted=report.n_converted,
             layout_transposes=report.n_layout_transposes)
    stats["layout_pass"] = s
    log(f"{tag} layout pass: " + json.dumps(s))
    del scope
    free_card(torch)
    log(f"{tag}: {card}; step ms / images/s / bf16 peak share / peak GB: "
        + json.dumps({k: [float(np.median(v["step_ms"])),
                          v["images_per_s"], v["bf16_peak_share"],
                          v["peak_gb"]] for k, v in stats.items()}))
    return by_kernel, (scopes["NHWC"], init), stats


def rn_step_card_and_cpu(torch, fluid, fa, dtype):
    """One Momentum step of ResNet-50 (NCHW, batch RN_PARITY_BATCH,
    ``dtype``) on the card and on the CPU from one initial scope: (card
    fetches, CPU fetches, card scope, CPU scope, names held after the
    step, attention launches on the card, seconds each)."""
    main, startup, loss = resnet_program(fluid, "NCHW", amp=False,
                                         dtype=dtype)
    fetch = [loss, RN_STEM + "@GRAD"]
    card_exe = fluid.Executor()
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    s0 = fluid.Scope()
    cpu_exe.run(startup, scope=s0)
    init = {n: v.clone() for n, v in s0.vars.items()}
    feed = {k: v.to(torch.float64 if v.is_floating_point()
                    and dtype == "float64" else v.dtype)
            for k, v in resnet_feed(torch, RN_PARITY_BATCH,
                                    torch.device("cpu"),
                                    seed=SEED + 1).items()}
    card_scope = fluid.Scope()
    for n, v in init.items():
        card_scope.set(n, v.clone().to(card_exe.device))
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    got = card_exe.run(main, feed=feed, fetch_list=fetch, scope=card_scope)
    card_s = time.perf_counter() - t0
    by_kernel = launches_by_kernel(fa)
    cpu_scope = scope_from(fluid, init)
    t0 = time.perf_counter()
    want = cpu_exe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    held = [n for n in init if n.endswith(".w_0") or ".global_" in n]
    return got, want, card_scope, cpu_scope, held, by_kernel, (card_s,
                                                               cpu_s)


def phase_resnet_parity(torch, fluid, fa, card):
    """ResNet-50 at full width, batch RN_PARITY_BATCH at 224², TF32 off:
    one Momentum step on the card and the same step on the port's CPU
    path from one initial scope. In float32 the forward's quantities —
    the loss and every batch-norm moving statistic after the step — hold
    within RN_PARITY_TOL, and the gradients' card-vs-CPU distance is
    reported: a random-init ResNet-50's backward is ill-conditioned in
    float32 (on the CPU, the port's float32 stem gradient sits 2.9% of
    its largest value from float64's at batch 16, a late conv's 19.5%;
    at batch 2, 150%), so two correct float orders cannot meet that tier
    there. The same step in float64 then holds the loss, the stem
    filter's gradient, every updated filter and every moving statistic
    within RN_PARITY_TOL. Returns (attention launches, stats)."""
    tag = "resnet_parity"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stats = {"tf32": "off (cuda.matmul and cudnn)"}
    launches = {}
    for dtype in ("float32", "float64"):
        got, want, cs, hs, held, by_kernel, secs = rn_step_card_and_cpu(
            torch, fluid, fa, dtype)
        launches = {k: launches.get(k, 0) + v for k, v in by_kernel.items()}
        worst = {}
        gated = ["loss"] + ([RN_STEM + "@GRAD"] if dtype == "float64"
                            else [])
        for name, g, w in zip(["loss", RN_STEM + "@GRAD"], got, want):
            ok, err = allclose_err(torch.from_numpy(g),
                                   torch.from_numpy(w), RN_PARITY_TOL)
            check(ok or name not in gated,
                  f"{tag} {dtype}: {name} card vs CPU max err {err} "
                  f"beyond rtol/atol {RN_PARITY_TOL}")
            worst[name] = [err, float(np.abs(w).max())]
        for n in held:
            ok, err = allclose_err(cs.find_var(n).cpu(), hs.find_var(n),
                                   RN_PARITY_TOL)
            gate = dtype == "float64" or ".global_" in n
            check(ok or not gate,
                  f"{tag} {dtype}: {n} after the step, card vs CPU max err "
                  f"{err} beyond {RN_PARITY_TOL}")
            worst[n] = [err, float(hs.find_var(n).abs().max())]
        moving = max((worst[n][0], n) for n in worst if ".global_" in n)
        filters = max((worst[n][0], n) for n in worst if n.endswith(".w_0"))
        stats[dtype] = {
            "loss": [float(got[0].reshape(())), float(want[0].reshape(()))],
            "stem_grad_max_err_and_max": worst[RN_STEM + "@GRAD"],
            "worst_moving_stat": moving, "worst_updated_filter": filters,
            "held": len(held) + 1 + (dtype == "float64"),
            "card_s": secs[0], "cpu_s": secs[1]}
        del cs, hs
        free_card(torch)
    check(not any(launches.values()),
          f"{tag}: attention launched: {launches}")
    log(f"{tag}: {card}: " + json.dumps(stats))
    return launches, stats


def rn_requests(n, seed):
    rng = np.random.RandomState(seed)
    return [{"img": rng.rand(1, 3, RN_HW, RN_HW).astype(np.float32)}
            for _ in range(n)]


def phase_resnet50_serve(torch, fluid, fa, card, trained):
    """``resnet50_train``'s trained NHWC scope served: the bf16 test
    program (AMP O2) through ``InferenceTranspiler().transpile`` on a copy
    of the scope, behind ``ServingEngine`` with no place, buckets
    RN_SERVE_BUCKETS; RN_SERVE_REQUESTS single-image requests from
    RN_SERVE_CLIENTS closed-loop clients. Checks, on the logits (the
    softmax's input) of 8 images: no batch_norm op in the served
    program; the folded bf16 program against the unfolded one within
    the relative-RMS tier; the float32 fold (TF32 off) and the float64
    fold (of a float64 copy of the scope) against their unfolded
    programs within RN_FOLD_TOL, normwise; a ``QuantizeTranspiler``
    float32 program within RN_QUANT_REL relative max error; no step
    build after warmup. Prints requests/s and p50/p99. Returns
    (attention launches, stats)."""
    from paddle_tpu_torch.serving import (BucketSpec, ServingConfig,
                                          ServingEngine)
    from paddle_tpu_torch.transpiler import (InferenceTranspiler,
                                             QuantizeTranspiler)
    tag = "resnet50_serve"
    trained_scope, _ = trained
    state = {n: v for n, v in trained_scope.vars.items()}
    exe = fluid.Executor()
    test, pred = resnet_infer_program(fluid, "NHWC")
    test32, _ = resnet_infer_program(fluid, "NHWC", amp=False)
    # the fc's logits, the softmax's input: a trained model's
    # probabilities can saturate, its logits carry the fold's error
    logits = [op for op in test32.global_block().ops
              if op.type == "softmax"][-1].input("X")[0]
    reqs = rn_requests(RN_SERVE_REQUESTS, SEED + 3)
    batch8 = {"img": np.concatenate([r["img"] for r in reqs[:8]])}
    stats = {}

    # float32, TF32 off: the fold and int8 against the unfolded program
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want32 = exe.run(test32, feed=batch8, fetch_list=[logits],
                     scope=scope_from(fluid, state), mode="test")[0]
    fscope = scope_from(fluid, state)
    folded32 = InferenceTranspiler().transpile(test32, scope=fscope)
    got32 = exe.run(folded32, feed=batch8, fetch_list=[logits],
                    scope=fscope, mode="test")[0]
    ok, err = normwise_close(got32, want32, RN_FOLD_TOL)
    stats["f32_fold"] = {"max_err": err,
                         "max_abs_logit": float(np.abs(want32).max())}
    check(ok, f"{tag}: float32 fold vs unfolded max err {err} (logits up "
              f"to {np.abs(want32).max()}), beyond rtol/atol "
              f"{RN_FOLD_TOL}")
    # the same fold in float64, on a float64 copy of the trained scope
    test64, _ = resnet_infer_program(fluid, "NHWC", amp=False,
                                     dtype="float64")
    state64 = {n: v.double() for n, v in state.items()}
    batch64 = {"img": batch8["img"].astype(np.float64)}
    want64 = exe.run(test64, feed=batch64, fetch_list=[logits],
                     scope=scope_from(fluid, state64), mode="test")[0]
    fscope64 = scope_from(fluid, state64)
    folded64 = InferenceTranspiler().transpile(test64, scope=fscope64)
    got64 = exe.run(folded64, feed=batch64, fetch_list=[logits],
                    scope=fscope64, mode="test")[0]
    ok, err = normwise_close(got64, want64, RN_FOLD_TOL)
    check(ok, f"{tag}: float64 fold vs unfolded max err {err}")
    stats["f64_fold_max_err"] = err
    del state64, fscope64
    qscope = scope_from(fluid, state)
    quant = QuantizeTranspiler().transpile(test32, scope=qscope)
    gotq = exe.run(quant, feed=batch8, fetch_list=[logits], scope=qscope,
                   mode="test")[0]
    rel = float(np.abs(gotq - want32).max() / (np.abs(want32).max() + 1e-6))
    check(rel < RN_QUANT_REL, f"{tag}: int8 relative max error {rel} >= "
                              f"{RN_QUANT_REL}")
    stats["int8_rel_max_err"] = rel
    stats["quantized_ops"] = sum(op.type.startswith("quantized_")
                                 for op in quant.global_block().ops)
    del fscope, qscope
    free_card(torch)

    # bf16: the served program
    torch.backends.cudnn.allow_tf32 = True
    want16 = exe.run(test, feed=batch8, fetch_list=[logits],
                     scope=scope_from(fluid, state), mode="test")[0]
    sscope = scope_from(fluid, state)
    folded = InferenceTranspiler().transpile(test, scope=sscope)
    types = [op.type for op in folded.global_block().ops]
    check("batch_norm" not in types,
          f"{tag}: a batch_norm op is left in the served program")
    stats["folded_ops"] = [len(test.global_block().ops), len(types)]
    engine = ServingEngine(folded, ["img"], [pred], scope=sscope,
                           buckets=BucketSpec(batch_sizes=RN_SERVE_BUCKETS),
                           config=ServingConfig(max_wait_ms=5.0,
                                                default_timeout_s=600.0))
    try:
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        engine.warmup()
        stats["warmup_s"] = time.perf_counter() - t0
        got16 = exe.run(folded, feed=batch8, fetch_list=[logits],
                        scope=sscope, mode="test")[0]
        err16 = rel_rms(got16, want16)
        check(err16 <= TOL_LOGITS_BF16_RMS,
              f"{tag}: bf16 folded answers vs unfolded relative RMS "
              f"{err16} > {TOL_LOGITS_BF16_RMS}")
        stats["bf16_fold_rel_rms"] = err16
        lat = [[] for _ in range(RN_SERVE_CLIENTS)]
        per = RN_SERVE_REQUESTS // RN_SERVE_CLIENTS

        def client(i):
            for r in reqs[i * per:(i + 1) * per]:
                t = time.perf_counter()
                ans = engine.infer(r, timeout=600.0)
                lat[i].append(time.perf_counter() - t)
                check(ans[0].shape == (1, RN_CLASSES)
                      and np.isfinite(ans[0]).all(),
                      f"{tag}: a bad answer {ans[0].shape}")

        t0 = time.perf_counter()
        with ThreadPoolExecutor(RN_SERVE_CLIENTS) as pool:
            for f in [pool.submit(client, i)
                      for i in range(RN_SERVE_CLIENTS)]:
                f.result()
        wall = time.perf_counter() - t0
        by_kernel = launches_by_kernel(fa)
        all_lat = np.concatenate([np.asarray(x) for x in lat]) * 1e3
        p50, p99 = np.percentile(all_lat, [50, 99])
        engine.assert_no_recompiles()
        st = engine.stats()
        stats.update(requests=int(all_lat.size), wall_s=wall,
                     requests_per_s=all_lat.size / wall,
                     p50_ms=float(p50), p99_ms=float(p99),
                     batch_latency=st.get("batch_latency"),
                     batch_fill=st.get("batch_fill"))
    finally:
        engine.close()
    check(not any(by_kernel.values()),
          f"{tag}: attention launched: {by_kernel}")
    log(f"{tag}: {card}: " + json.dumps(stats, default=str))
    return by_kernel, stats


def card_vs_cpu(torch, card_dev, rule, ins, attrs, grad, tag,
                mode="test"):
    """One op rule on ``card_dev`` and on the CPU, same inputs: outputs
    and the gradients of ``grad`` slots (one random cotangent) within the
    float32 kernel tier (TF32 off). Returns the worst error."""
    from paddle_tpu_torch.core import lowering
    worst = 0.0
    res = []
    for dev in (card_dev, torch.device("cpu")):
        tins = {s: [torch.from_numpy(a).to(dev) for a in v]
                for s, v in ins.items()}
        leaves = [t.requires_grad_() for s in grad for t in tins[s]]
        ctx = lowering.LoweringContext(None, mode, dev, SEED, 1)
        with torch.enable_grad():
            out = rule(ctx, tins, dict(attrs))
            flat = [t for s in sorted(out) for t in out[s]
                    if t.is_floating_point()]
            gen = torch.Generator().manual_seed(SEED)
            total = sum((t * torch.randn(t.shape, generator=gen).to(dev))
                        .sum() for t in flat if t.requires_grad)
            grads = torch.autograd.grad(total, leaves) if leaves else []
        res.append([t.detach().cpu() for t in flat] + [g.cpu() for g in grads])
    card, host = res
    for i, (a, b) in enumerate(zip(card, host)):
        ok, err = allclose_err(a, b, TOL_F32)
        check(ok, f"conv_zoo {tag}: output/gradient {i} card vs CPU max "
                  f"err {err}")
        worst = max(worst, err)
    return worst


def phase_conv_zoo(torch, fluid, fa, card):
    """The rest of the conv family on the card, float32, TF32 off:
    the zoo's ``mnist`` (conv), ``vgg``, ``resnet`` and ``se_resnext``
    take ZOO_STEPS steps at batch ZOO_BATCH on the card and on the CPU
    from one state (losses within RN_PARITY_TOL); single ops card against
    CPU (outputs and gradients within the float32 kernel tier):
    ``conv2d_transpose`` and ``conv3d_transpose`` with groups and
    dilation, ``conv3d``, ``pool3d``, ``ceil_mode`` pooling with padding
    in both layouts, ``lrn``, both interpolations up and down,
    ``roi_pool`` with an empty bin, and the ``batch_norm``
    autograd.Function against ``PADDLE_TPU_BN_AUTODIFF=1``. Returns
    (attention launches, stats)."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.models import zoo
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stats = {"models": {}, "ops": {}}
    fa.reset_launch_counts()
    for name in ZOO_CONV:
        zp = zoo.build_zoo_program(name)
        for op in zp.main.global_block().ops:
            if op.type == "dropout":       # the packages draw apart
                op.attrs["dropout_prob"] = 0.0
        cpu = fluid.Executor(fluid.CPUPlace())
        s0 = fluid.Scope()
        cpu.run(zp.startup, scope=s0)
        init = {n: v.clone() for n, v in s0.vars.items()}
        losses = {}
        for side, exe in (("card", fluid.Executor()), ("cpu", cpu)):
            scope = fluid.Scope()
            for n, v in init.items():
                scope.set(n, v.clone())
            losses[side] = [
                np.asarray(exe.run(zp.main, feed=zoo.example_feed(
                    name, ZOO_BATCH, step), fetch_list=zp.fetch_list[:1],
                    scope=scope)[0], np.float64).ravel()
                for step in range(ZOO_STEPS)]
        got, want = np.stack(losses["card"]), np.stack(losses["cpu"])
        ok, err = allclose_err(torch.from_numpy(got[0]),
                               torch.from_numpy(want[0]), RN_PARITY_TOL)
        later_ok, later = allclose_err(torch.from_numpy(got),
                                       torch.from_numpy(want),
                                       (ZOO_LATER_RTOL, 0.0))
        check(ok and later_ok and np.isfinite(got).all(),
              f"conv_zoo {name}: card {got[:, 0]} vs CPU {want[:, 0]} "
              f"(first step max err {err}, all steps {later})")
        stats["models"][name] = {"first_step_max_err": err,
                                 "all_steps_max_err": later,
                                 "card": got[:, 0].tolist()}
    rng = np.random.RandomState(SEED)

    def f(*shape):
        return rng.randn(*shape).astype(np.float32)

    def nhwc(x):
        return np.ascontiguousarray(x.transpose(0, 2, 3, 1))

    # 8 wide: ceil_mode adds one column of right padding, and no window
    # lies wholly in the padding (where the reference's avg divides 0 by
    # 0 and its max gives -inf: ROADMAP §3, R2)
    pool_x = (np.arange(2 * 4 * 8 * 8, dtype=np.float32)
              [rng.permutation(512)].reshape(2, 4, 8, 8) / 100.0)
    ops = {
        "conv2d_transpose g2 d2": ("conv2d_transpose", {
            "Input": [f(2, 4, 6, 6)], "Filter": [f(4, 3, 3, 3)]},
            dict(strides=[2, 2], paddings=[1, 1], dilations=[2, 2],
                 groups=2), ("Input", "Filter")),
        "conv3d_transpose g2 d2": ("conv3d_transpose", {
            "Input": [f(1, 4, 3, 4, 4)], "Filter": [f(4, 2, 3, 3, 3)]},
            dict(strides=[1, 2, 2], paddings=[1, 1, 1], dilations=[2, 1, 1],
                 groups=2), ("Input", "Filter")),
        "conv3d g2": ("conv3d", {"Input": [f(2, 4, 5, 6, 6)],
                                 "Filter": [f(6, 2, 2, 3, 3)]},
                      dict(strides=[1, 2, 2], paddings=[1, 1, 1],
                           dilations=[1, 1, 1], groups=2),
                      ("Input", "Filter")),
        "pool3d avg ceil": ("pool3d", {"X": [f(1, 3, 5, 8, 8)]},
                            dict(ksize=[2, 3, 3], strides=[2, 2, 2],
                                 paddings=[0, 1, 1], pooling_type="avg",
                                 ceil_mode=True), ("X",)),
        "pool2d max ceil pad": ("pool2d", {"X": [pool_x]},
                                dict(ksize=[3, 3], strides=[2, 2],
                                     paddings=[1, 1], pooling_type="max",
                                     ceil_mode=True), ("X",)),
        "pool2d avg ceil pad NHWC": ("pool2d", {"X": [nhwc(pool_x)]},
                                     dict(ksize=[3, 3], strides=[2, 2],
                                          paddings=[1, 1],
                                          pooling_type="avg",
                                          ceil_mode=True,
                                          data_format="NHWC"), ("X",)),
        "lrn": ("lrn", {"X": [f(2, 7, 5, 5)]},
                dict(n=5, alpha=0.3, beta=0.75), ("X",)),
        "bilinear up": ("bilinear_interp", {"X": [f(2, 3, 5, 7)]},
                        dict(out_h=10, out_w=12), ("X",)),
        "bilinear down": ("bilinear_interp", {"X": [f(2, 3, 12, 10)]},
                          dict(out_h=5, out_w=3), ("X",)),
        "nearest up": ("nearest_interp", {"X": [f(2, 3, 5, 7)]},
                       dict(out_h=10, out_w=12), ("X",)),
        "nearest down": ("nearest_interp", {"X": [f(2, 3, 12, 10)]},
                         dict(out_h=5, out_w=3), ("X",)),
        "roi_pool empty bin": ("roi_pool", {
            "X": [f(2, 3, 8, 8)],
            "ROIs": [np.asarray([[0, 0, 5, 4], [6, 6, 12, 14]],
                                np.float32)],
            "RoisBatchId": [np.asarray([1, 0], np.int64)]},
            dict(pooled_height=2, pooled_width=3), ("X",)),
        "batch_norm NHWC train": ("batch_norm", {
            "X": [nhwc(f(8, 6, 7, 7) * 2 + 1)],
            "Scale": [np.abs(f(6)) + 0.5], "Bias": [f(6)],
            "Mean": [f(6) * 0.1], "Variance": [np.abs(f(6)) + 0.5]},
            dict(data_layout="NHWC", momentum=0.9),
            ("X", "Scale", "Bias")),
    }
    dev = fluid.Executor().device            # the card
    for label, (op, ins, attrs, grad) in ops.items():
        mode = "train" if op == "batch_norm" else "test"
        stats["ops"][label] = card_vs_cpu(
            torch, dev, registry.get_op(op).lower, ins, attrs, grad, label,
            mode)
    # the hand-derived batch_norm backward against autograd on the card
    bn = ops["batch_norm NHWC train"]
    prev = os.environ.get("PADDLE_TPU_BN_AUTODIFF")
    outs = []
    for flag in ("0", "1"):
        os.environ["PADDLE_TPU_BN_AUTODIFF"] = flag
        from paddle_tpu_torch.core import lowering
        ctx = lowering.LoweringContext(None, "train", dev, SEED, 1)
        tins = {s: [torch.from_numpy(a).to(dev) for a in v]
                for s, v in bn[1].items()}
        leaves = [tins[s][0].requires_grad_() for s in bn[3]]
        with torch.enable_grad():
            y = registry.get_op("batch_norm").lower(ctx, tins, bn[2])["Y"][0]
            gen = torch.Generator().manual_seed(SEED + 1)
            dy = torch.randn(y.shape, generator=gen).to(dev)
            outs.append([g.cpu() for g in torch.autograd.grad(
                (y * dy).sum(), leaves)])
    if prev is None:
        os.environ.pop("PADDLE_TPU_BN_AUTODIFF", None)
    else:
        os.environ["PADDLE_TPU_BN_AUTODIFF"] = prev
    for name, a, b in zip(bn[3], *outs):
        ok, err = allclose_err(a, b, TOL_F32)
        check(ok, f"conv_zoo: batch_norm hand backward d{name} vs autograd "
                  f"on the card, max err {err}")
        stats["ops"][f"batch_norm hand vs autodiff d{name}"] = err
    by_kernel = launches_by_kernel(fa)
    check(not any(by_kernel.values()),
          f"conv_zoo: attention launched: {by_kernel}")
    log(f"conv_zoo: {card}, TF32 off: " + json.dumps(stats))
    return by_kernel, stats


# ----------------------------------------------------------------------
# ROADMAP item 6a: the device mesh, the ParallelExecutor and the MoE FFNs
# ----------------------------------------------------------------------
# ---------------------------------------------------------------------------
# flowers_train: ResNet-50 fed by the flowers reader under the profiler
# ---------------------------------------------------------------------------
FL_CLASSES = 102                # Oxford 102 Flowers
FL_BUF = 5120                   # benchmark/fluid/models/resnet.py's shuffle
FL_WARMUP = 2                   # reader-fed steps before the timed sets,
                                # held against tensor and recordio feeds
FL_STEPS = 8                    # steps a timed set
FL_PASS = 256                   # samples a pass of the flowers fallback
# the policy memory_optimize(policy="auto") picks for the flowers
# program: the reference's pick on the same program, which
# tests/test_torch_dataflow.py holds on the CPU
FL_AUTO_POLICY = "save_conv_only"
FL_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "paddle_tpu_torch", "_build", "chip_smoke_flowers")


def flowers_batches(fluid):
    """The reference benchmark's flowers feed (``--data_set flowers``):
    ``reader.batch(reader.shuffle(dataset.flowers.train(), FL_BUF),
    RN_BATCH)``, the pass run again for each epoch: an endless iterator
    of batches. ``flowers.train()`` finds no file under FL_ROOT's data
    home and takes its synthetic fallback, whose one warning is expected
    here; any other warning it raises fails the phase."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        base = fluid.dataset.flowers.train()
    msgs = [str(w.message) for w in caught]
    check(len(msgs) == 1 and msgs[0].startswith("flowers.train:")
          and msgs[0].endswith("synthetic fallback"),
          f"flowers_train: expected the fallback's one warning, got {msgs}")
    reader = fluid.reader.batch(fluid.reader.shuffle(base, buf_size=FL_BUF),
                                RN_BATCH)

    def batches():
        while True:
            yield from reader()
    return batches()


def check_flowers_samples(batch):
    check(len(batch) == RN_BATCH and all(
        im.shape == (3, RN_HW, RN_HW) and im.dtype == np.float32
        and 0 <= lab < FL_CLASSES for im, lab in batch),
        "flowers_train: a sample is not 3 x 224² float32 with a label in "
        f"[0, {FL_CLASSES})")


def flowers_step(torch, exe, main, loss, scope, feeder, batches,
                 region=None):
    """One reader-fed step: the next batch through the DataFeeder, then
    ``run``; ``region`` (profiler.record_event) wraps the feed as "feed"
    and the run as "step". Returns (ms on the host clock, synchronized;
    the loss; the batch)."""
    region = region or (lambda name: contextlib.nullcontext())
    t0 = time.perf_counter()
    with region("feed"):
        batch = next(batches)
        check_flowers_samples(batch)
        feed = feeder.feed(batch)
    with region("step"):
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                      return_numpy=False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return ms, float(out[0].float().reshape(()).cpu()), batch


def tensor_feed(torch, feeder, batch, dev):
    return {k: torch.from_numpy(v).to(dev)
            for k, v in feeder.feed(batch).items()}


def step_set(ms, key="step_ms"):
    med = float(np.median(ms))
    return {key: ms, "median_ms": med, "images_per_s": RN_BATCH / med * 1e3}


def phase_flowers_train(torch, fluid, fa, card):
    """The main path of this slice: ``resnet_program``'s ResNet-50 (NHWC,
    Momentum(0.1, 0.9), AMP O2) with FL_CLASSES classes, fed the way the
    reference benchmark feeds ``--data_set flowers`` (``flowers_batches``
    → ``DataFeeder(place=exe.place)`` → ``Executor().run``). Checks:

    - every sample 3 x 224² float32 with a label in [0, FL_CLASSES); the
      first losses finite and within RN_LOSS_BAND of ln FL_CLASSES;
    - the FL_WARMUP reader-fed steps (deterministic cuDNN) bit-equal to
      the same batches passed as tensors, and to the same samples
      written with ``recordio_writer`` and read back through
      ``open_recordio_file`` → ``batch`` → ``read_file`` in the same
      network, all from one initial scope;
    - then three timed sets of FL_STEPS: reader-fed; reader-fed inside a
      ``profiler`` session (each feed in ``record_event("feed")``, each
      run in ``record_event("step")``), whose host timeline holds
      exactly FL_STEPS ``dispatch step N`` slices with consecutive N and
      FL_STEPS of each region, whose summary names both and
      ``<session>``, and whose torch.profiler trace holds convolution
      and batch-norm/elementwise kernels (``conv_kind``) adding up to no
      more than the session's wall time; one resident device batch;
    - ``contrib.compiled_memory_usage``'s ``argument_bytes`` equal to the
      scope's state plus the feeds, the scope left as it was;
      ``memory_usage``, ``program_cost`` and ``exe.compiled_stats``
      printed beside one step's peak;
    - ``memory_optimize(policy="auto", print_log=True)`` picks
      FL_AUTO_POLICY, and two steps under it give losses within
      RN_BF16_RTOL of no remat's.

    Returns (attention launches by kernel symbol, stats)."""
    import io
    import random
    import shutil
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.analysis import program_cost
    from paddle_tpu_torch.contrib import compiled_memory_usage, memory_usage
    from paddle_tpu_torch.core.executor import EOFException
    tag = "flowers_train"
    shutil.rmtree(FL_ROOT, ignore_errors=True)
    os.makedirs(FL_ROOT)
    data_home = fluid.dataset.common.DATA_HOME
    fluid.dataset.common.DATA_HOME = os.path.join(FL_ROOT, "data")
    random.seed(SEED)                     # the shuffle's draws
    fa.reset_launch_counts()
    exe = fluid.Executor()                # the card: CUDAPlace(0)
    dev = exe.device
    t_phase = time.perf_counter()
    main, startup, loss = resnet_program(fluid, "NHWC", classes=FL_CLASSES)
    s0 = fluid.Scope()
    exe.run(startup, scope=s0)
    init = {n: v.clone() for n, v in s0.vars.items()}
    del s0
    feeder = fluid.DataFeeder(feed_list=["img", "label"], place=exe.place,
                              program=main)
    batches = flowers_batches(fluid)
    stats = {"classes": FL_CLASSES, "batch": RN_BATCH}

    # the first reader-fed steps, held bit for bit against the same
    # batches fed as tensors and read back from a recordio file
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    scope = scope_from(fluid, init)
    warm, fed, warm_ms = [], [], []
    for _ in range(FL_WARMUP):
        ms, lv, batch = flowers_step(torch, exe, main, loss, scope, feeder,
                                     batches)
        warm.append(lv)
        fed.append(batch)
        warm_ms.append(ms)
    check(all(math.isfinite(v) for v in warm)
          and abs(warm[0] - math.log(FL_CLASSES)) < RN_LOSS_BAND,
          f"{tag}: first losses {warm} not near ln {FL_CLASSES} = "
          f"{math.log(FL_CLASSES):.4f}")
    tscope = scope_from(fluid, init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tensor_losses = [float(exe.run(
        main, feed=tensor_feed(torch, feeder, b, dev), fetch_list=[loss],
        scope=tscope, return_numpy=False)[0].float().reshape(()).cpu())
        for b in fed]
    peak_no_remat = torch.cuda.max_memory_allocated()
    check(tensor_losses == warm,
          f"{tag}: tensor-fed losses {tensor_losses} differ from the "
          f"reader-fed {warm}")
    del tscope
    free_card(torch)
    path = os.path.join(FL_ROOT, "flowers.recordio")
    t0 = time.perf_counter()
    n = fluid.recordio_writer.convert_reader_to_recordio_file(
        path, lambda: (s for b in fed for s in b), feeder,
        compressor="none")
    write_s = time.perf_counter() - t0
    check(n == FL_WARMUP * RN_BATCH == FL_PASS,
          f"{tag}: {n} records written")
    rmain, rstartup, rloss, rreader = resnet_program(
        fluid, "NHWC", classes=FL_CLASSES, recordio=path)
    rscope = fluid.Scope()
    exe.run(rstartup, scope=rscope)
    for k, v in init.items():
        rscope.set(k, v.clone())
    rreader.start()
    rec_losses = [float(exe.run(rmain, fetch_list=[rloss], scope=rscope,
                                return_numpy=False)[0].float()
                        .reshape(()).cpu()) for _ in range(FL_WARMUP)]
    try:
        exe.run(rmain, fetch_list=[rloss], scope=rscope)
        eof = False
    except EOFException:
        eof = True
    check(rec_losses == warm and eof,
          f"{tag}: recordio-fed losses {rec_losses} (EOF after "
          f"{FL_WARMUP} batches: {eof}) differ from the reader-fed {warm}")
    del rscope, rmain
    os.remove(path)
    torch.backends.cudnn.deterministic = False
    stats.update(first_losses=warm, tensor_fed_losses=tensor_losses,
                 recordio_fed_losses=rec_losses, warmup_ms=warm_ms,
                 recordio_write_s=write_s)
    free_card(torch)

    # the timed sets: reader-fed, reader-fed under the profiler, one
    # resident batch
    stats["reader_fed"] = step_set(
        [flowers_step(torch, exe, main, loss, scope, feeder, batches)[0]
         for _ in range(FL_STEPS)])
    prof_dir = os.path.join(FL_ROOT, "profile")
    profiler.reset_profiler()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        with profiler.profiler("All", sorted_key="total",
                               profile_path=prof_dir):
            prof_ms = [flowers_step(torch, exe, main, loss, scope, feeder,
                                    batches, profiler.record_event)[0]
                       for _ in range(FL_STEPS)]
    stop_s = time.perf_counter() - t0 - sum(prof_ms) / 1e3
    summary = printed.getvalue()
    log(f"{tag}: the profiler's summary:\n{summary}")
    stats["profiled"] = step_set(prof_ms)
    session_s = [s for name, s in profiler._records
                 if name == "<session>"][-1]
    with open(os.path.join(prof_dir, "host_timeline.json")) as f:
        timeline = json.load(f)["traceEvents"]
    names = [e["name"] for e in timeline]
    steps = [int(m.group(1)) for m in (re.fullmatch(r"dispatch step (\d+)",
                                                    n) for n in names) if m]
    check(len(steps) == FL_STEPS and steps == list(
        range(steps[0], steps[0] + FL_STEPS))
          and names.count("feed") == names.count("step") == FL_STEPS,
          f"{tag}: the host timeline holds dispatch steps {steps}, "
          f"{names.count('feed')} feed and {names.count('step')} step "
          "slices")
    rows = re.findall(r"^(\S+)\s+\d+\.\d+$", summary, re.M)
    check({"feed", "step", "<session>"} <= set(rows),
          f"{tag}: the printed summary names {sorted(set(rows))}")
    kernels = profiler.device_kernel_profile(prof_dir, top_k=10 ** 6)
    check(kernels is not None and kernels["n_kernels"] > 0,
          f"{tag}: the session's device trace is missing or empty "
          f"({kernels and {k: kernels[k] for k in ('planes', 'n_kernels')}})")
    by_kind = {}
    for k in kernels["top_kernels"]:
        kind = conv_kind(k["name"])
        by_kind[kind] = by_kind.get(kind, 0.0) + k["total_ms"]
    check(by_kind.get("conv", 0) > 0 and by_kind.get("bn_and_elementwise", 0)
          > 0 and kernels["device_total_ms"] <= session_s * 1e3,
          f"{tag}: device kernels by kind {by_kind}, "
          f"{kernels['device_total_ms']} ms over a {session_s * 1e3:.1f} "
          "ms session")
    stats["profiled"].update(
        session_ms=session_s * 1e3, stop_and_export_s=stop_s,
        device_total_ms=kernels["device_total_ms"],
        n_kernels=kernels["n_kernels"], planes=kernels["planes"],
        device_ms_by_kind=by_kind,
        trace_mb=os.path.getsize(os.path.join(
            prof_dir, profiler.TORCH_TRACE)) / 2 ** 20,
        top_kernels=[dict(k, name=k["name"][:100])
                     for k in kernels["top_kernels"][:6]])
    resident = tensor_feed(torch, feeder, next(batches), dev)
    res_ms = []
    for _ in range(FL_STEPS):
        t0 = time.perf_counter()
        exe.run(main, feed=resident, fetch_list=[loss], scope=scope,
                return_numpy=False)
        torch.cuda.synchronize()
        res_ms.append((time.perf_counter() - t0) * 1e3)
    stats["resident"] = step_set(res_ms)
    med = {k: stats[k]["median_ms"] for k in ("reader_fed", "profiled",
                                              "resident")}
    log(f"{tag}: {card}; median step ms reader-fed | profiled | resident: "
        f"{med['reader_fed']:.2f} | {med['profiled']:.2f} | "
        f"{med['resident']:.2f}; images/s " + " | ".join(
            f"{stats[k]['images_per_s']:.1f}" for k in med))
    free_card(torch)

    # the memory and cost readings, beside one step's peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    exe.run(main, feed=resident, fetch_list=[loss], scope=scope,
            return_numpy=False)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated()
    gb = main.global_block()
    state = {n: scope.find_var(n) for n, v in gb.vars.items()
             if v.persistable and scope.find_var(n) is not None}
    state_bytes = sum(t.numel() * t.element_size() for t in state.values())
    feed_bytes = sum(t.numel() * t.element_size() for t in resident.values())
    probe = {n: t.clone() for n, t in list(state.items())[:4]}
    step_before = exe._step
    cmu = compiled_memory_usage(
        main, {"img": ((RN_BATCH, 3, RN_HW, RN_HW), "float32"),
               "label": ((RN_BATCH, 1), "int64")},
        fetch_list=[loss], scope=scope)
    check(cmu["argument_bytes"] == state_bytes + feed_bytes
          and exe._step == step_before
          and all(torch.equal(scope.find_var(n), t)
                  for n, t in probe.items()),
          f"{tag}: compiled_memory_usage's arguments {cmu['argument_bytes']}"
          f" against the state's {state_bytes} + the feeds' {feed_bytes}, "
          "or the caller's scope or step moved")
    del probe
    cost = program_cost(main, fetch_list=[loss], assume_batch=RN_BATCH)
    measured = exe.compiled_stats(main, feed=resident, fetch_list=[loss],
                                  scope=scope, top_k=0)
    lo, hi, unit = memory_usage(main, RN_BATCH)
    scale = {"B": 1, "KB": 2 ** 10, "MB": 2 ** 20}[unit]
    stats["memory"] = {
        "step_peak_bytes": step_peak, "memory_usage": [lo, hi, unit],
        "memory_usage_max_bytes": hi * scale,
        "compiled_memory_usage": cmu,
        "program_cost": {k: cost.to_dict()[k] for k in (
            "total_flops", "total_bytes", "params_bytes",
            "peak_residency_bytes", "residual_at_backward_bytes",
            "recommended_remat_policy")},
        "compiled_stats": {k: measured[k] for k in (
            "flops", "bytes_accessed", "n_kernels")},
        "compiled_stats_peak_bytes": measured.get("peak_memory_bytes"),
        "flop_ratio_static_to_measured":
            cost.total_flops / measured["flops"],
        "bytes_ratio_static_to_measured":
            cost.total_bytes / measured["bytes_accessed"],
        "peak_ratio_static_to_measured":
            cost.peak_residency_bytes / step_peak}
    log(f"{tag} memory and cost: " + json.dumps(stats["memory"]))
    del resident
    free_card(torch)

    # the static remat recommendation, against no remat
    auto = main.clone()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        fluid.memory_optimize(auto, policy="auto", print_log=True)
    log(f"{tag}: {printed.getvalue().strip()}")
    check(auto._remat_policy == FL_AUTO_POLICY,
          f"{tag}: policy 'auto' picked {auto._remat_policy!r}, the CPU's "
          f"pick is {FL_AUTO_POLICY!r}")
    ascope = scope_from(fluid, init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    auto_losses = [float(exe.run(
        auto, feed=tensor_feed(torch, feeder, b, dev), fetch_list=[loss],
        scope=ascope, return_numpy=False)[0].float().reshape(()).cpu())
        for b in fed]
    auto_peak = torch.cuda.max_memory_allocated()
    check(np.allclose(auto_losses, warm, rtol=RN_BF16_RTOL, atol=0),
          f"{tag} {FL_AUTO_POLICY}: losses {auto_losses} vs no remat "
          f"{warm} beyond rtol {RN_BF16_RTOL}")
    stats["auto_remat"] = {"policy": auto._remat_policy,
                           "losses": auto_losses, "peak_bytes": auto_peak,
                           "peak_bytes_without_remat": peak_no_remat}
    del ascope, scope, init, fed
    fluid.dataset.common.DATA_HOME = data_home
    shutil.rmtree(FL_ROOT, ignore_errors=True)
    by_kernel = attention_idle(fa, tag)
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"{tag}: {card}: " + json.dumps(stats))
    return by_kernel, stats


def range_ms(torch, fn, names):
    """Device ms of the kernels that start inside each torch.profiler
    range of ``names`` during one call of ``fn`` (the ranges' device
    spans; one stream), by name; None where the profiler sees none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {}
    for name in names:
        spans = [e.time_range for e in on_device if e.name == name]
        if spans:
            out[name] = sum(
                e.time_range.elapsed_us() for e in on_device
                if e.name not in names and any(
                    s.start <= e.time_range.start < s.end
                    for s in spans)) / 1e3
    return out or None


def phase_mesh_llama_train(torch, fluid, fa, card):
    """The main path of this slice for dense models: the Llama-3-8B width
    cut to MESH_LAYERS layers, bf16, Adam(1e-4), ``build_llama(shard_dp=
    True, shard_tp=True)`` with ``ShardingTranspiler().shard_optimizer``
    (the Adam moments on 'dp'), stepped MESH_STEPS times through
    ``fluid.ParallelExecutor(mesh=make_mesh({"dp": -1, "tp": 1}))``, the
    one card's mesh (a one-rank NCCL group), and through a plain
    ``Executor.run`` on a copy of the same startup scope and feed, with
    deterministic algorithms on: every loss and, after the last step,
    every persistable bit-equal; K1-K3 once a layer a step on the
    tensor cores; the step ms of both beside each other (the mesh
    machinery's host cost) and ``compiled_stats`` (flops, kernels,
    peak, a collectives histogram of one-rank reductions or none).
    Returns (the PE's launches by kernel, stats)."""
    from paddle_tpu_torch.core.executor import global_value
    from paddle_tpu_torch.models.llama import LLAMA3_8B
    from paddle_tpu_torch.parallel import ShardingTranspiler, make_mesh
    tag = "mesh_llama_train"
    cfg = dataclasses.replace(LLAMA3_8B, n_layers=MESH_LAYERS)
    main, startup, loss = build_train(fluid, cfg, 1e-4, shard_dp=True,
                                      shard_tp=True)
    ShardingTranspiler().shard_optimizer(main)
    feed = train_feed(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    exe = fluid.Executor()                     # the card: CUDAPlace(0)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    plain_scope = scope_from(fluid, scope.vars)
    mesh = make_mesh({"dp": -1, "tp": 1})
    check(mesh.axes == {"dp": 1, "tp": 1} and mesh.device.type == "cuda",
          f"{tag}: the one card's mesh is {mesh.axes} on {mesh.device}")
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                scope=scope, mesh=mesh)
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            pe_losses, pe_ms = [], []
            # the main path: counts reset just before, read just after
            fa.reset_launch_counts()
            for _ in range(MESH_STEPS):
                out, ms = timed(torch, lambda: pe.run(
                    feed=feed, fetch_list=[loss.name]))
                pe_losses.append(float(np.asarray(out[0]).reshape(())))
                pe_ms.append(ms)
            launches = [w.launches for w in wrappers]
            by_kernel = launches_by_kernel(fa)
            plain_losses, plain_ms = [], []
            for _ in range(MESH_STEPS):
                out, ms = timed(torch, lambda: exe.run(
                    main, feed=feed, fetch_list=[loss], scope=plain_scope))
                plain_losses.append(float(np.asarray(out[0]).reshape(())))
                plain_ms.append(ms)
            differing = [n for n in plain_scope.keys() if not torch.equal(
                global_value(scope.find_var(n)), plain_scope.find_var(n))]
    finally:
        torch.use_deterministic_algorithms(False)
    check(pe_losses == plain_losses,
          f"{tag}: ParallelExecutor losses {pe_losses} are not the plain "
          f"Executor's {plain_losses} bit for bit")
    check(not differing, f"{tag}: {len(differing)} persistables differ "
          f"after {MESH_STEPS} steps: {differing[:6]}")
    check(all(math.isfinite(x) for x in pe_losses), f"{tag}: {pe_losses}")
    for name, w, n in zip(("K1", "K2", "K3"), wrappers, launches):
        check(n == cfg.n_layers * MESH_STEPS,
              f"{tag}: {name} launched {n} times, not {cfg.n_layers} "
              f"layers x {MESH_STEPS} steps")
        _, variant = fa.kernel_for(w.__name__, torch.bfloat16, 128)
        check(by_kernel[variant] == n,
              f"{tag}: {name} by kernel {by_kernel}: not all {variant}")
    del plain_scope
    free_card(torch)
    st = pe.compiled_stats([loss.name], feed=feed)
    coll = st["collectives"]
    check(set(coll) <= {"all-reduce", "all-gather"},
          f"{tag}: collectives {coll} on a one-rank mesh")
    stats = {"layers": cfg.n_layers, "mesh": mesh.axes,
             "losses": pe_losses, "pe_step_ms": pe_ms,
             "plain_step_ms": plain_ms,
             "host_cost_ms_last_step": pe_ms[-1] - plain_ms[-1],
             "compiled_stats": {k: st.get(k) for k in (
                 "flops", "bytes_accessed", "n_kernels", "kernel_source",
                 "peak_memory_bytes", "collectives", "mesh")},
             "top_kernels": st.get("kernel_histogram", [])[:6],
             "launches_by_kernel": by_kernel, "card": card}
    log(f"{tag}: " + json.dumps(stats))
    return by_kernel, stats


def moe_feed(cfg):
    toks = np.random.RandomState(SEED + 11).randint(
        0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ)).astype(np.int64)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def phase_moe_train(torch, fluid, fa, card):
    """The MoE main path: the Mixtral-8x7B width (``_mixtral()``; 8 experts,
    top-2, capacity factor 2) cut to MOE_LAYERS layers, bf16,
    Adam(1e-4), MOE_BATCH x MOE_SEQ tokens, one step through the plain
    Executor and MOE_WARMUP + MOE_STEPS through ``ParallelExecutor`` on
    ``make_mesh({"dp": 1, "ep": 1})`` from the same startup, on one
    repeated batch: the first losses equal, finite and near ln V +
    dim·0.02²/2 plus the weighted aux loss (E·Σ f·P ≈ 1 at a random
    router); the loss falling; K1-K3 once a layer a step. Step ms,
    tokens/s, peak memory, the (token, choice) pairs capacity dropped,
    and one step's device ms by kind, with the MoE ranges (gating,
    dispatch einsum, expert products, combine einsum). Returns (the PE's
    launches by kernel, stats, the trained scope)."""
    from paddle_tpu_torch.ops import moe as moe_ops
    from paddle_tpu_torch.parallel import make_mesh
    tag = "moe_train"
    cfg = _mixtral()
    main, startup, loss = build_train(fluid, cfg, 1e-4)
    feed = moe_feed(cfg)
    # one Executor per startup: both draw the same weights (the draws
    # follow the executor's step)
    plain_scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=plain_scope)
    plain_first = float(np.asarray(exe.run(
        main, feed=feed, fetch_list=[loss], scope=plain_scope)[0])
        .reshape(()))
    del plain_scope
    free_card(torch)
    scope = fluid.Scope()
    t0 = time.perf_counter()
    fluid.Executor().run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in (scope.find_var(v.name)
                                       for v in main.all_parameters()))
    log(f"{tag}: Mixtral-8x7B width (dim {cfg.dim}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} kv, {cfg.moe_experts} experts of ffn "
        f"{cfg.ffn_hidden}, top-{cfg.moe_top_k}, vocab {cfg.vocab_size}, "
        f"rope {cfg.rope_base:g}), {cfg.n_layers} of 32 layers, bf16, "
        f"Adam: {n_params / 1e9:.3f} B params, startup "
        f"{time.perf_counter() - t0:.2f} s")
    mesh = make_mesh({"dp": 1, "ep": 1})
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                scope=scope, mesh=mesh)
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    n_steps = MOE_WARMUP + MOE_STEPS
    moe_ops.DROPPED = []
    # the main path: counts reset just before, read just after
    fa.reset_launch_counts()
    for step in range(n_steps):
        out, ms = timed(torch, lambda: pe.run(feed=feed,
                                              fetch_list=[loss.name]))
        losses.append(float(np.asarray(out[0]).reshape(())))
        step_ms.append(ms)
        log(f"{tag}: step {step}: loss {losses[-1]:.4f}, {ms:.1f} ms")
    launches = [w.launches for w in wrappers]
    by_kernel = launches_by_kernel(fa)
    dropped = [int(d) for d in moe_ops.DROPPED]
    moe_ops.DROPPED = None
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(x) for x in losses), f"{tag}: {losses}")
    check(abs(losses[0] - plain_first) <= MOE_TOL_LOSS * abs(plain_first),
          f"{tag}: first loss {losses[0]} vs the plain Executor's "
          f"{plain_first}")
    expected = (math.log(cfg.vocab_size) + cfg.dim * INIT_STD ** 2 / 2
                + cfg.n_layers * cfg.moe_aux_weight)
    check(abs(losses[0] - expected) < 0.5,
          f"{tag}: first loss {losses[0]:.4f} not within 0.5 of "
          f"{expected:.4f}")
    check(losses[-1] < losses[0],
          f"{tag}: loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    for name, w, n in zip(("K1", "K2", "K3"), wrappers, launches):
        check(n == cfg.n_layers * n_steps,
              f"{tag}: {name} launched {n} times, not {cfg.n_layers} x "
              f"{n_steps}")
        _, variant = fa.kernel_for(w.__name__, torch.bfloat16, 128)
        check(by_kernel[variant] == n, f"{tag}: {name} {by_kernel}")
    timed_ms = sorted(step_ms[MOE_WARMUP:])
    med = timed_ms[len(timed_ms) // 2]
    run = lambda: pe.run(feed=feed, fetch_list=[loss.name])  # noqa: E731
    breakdown = {}
    add_busy(breakdown, device_ms_by_kind(torch, run), med)
    breakdown["moe_ranges_ms"] = range_ms(torch, run, moe_ops.RANGES) \
        or "not measured"
    stats = {"layers": cfg.n_layers, "params_b": n_params / 1e9,
             "mesh": mesh.axes, "batch": MOE_BATCH, "seq": MOE_SEQ,
             "losses": losses, "plain_first_loss": plain_first,
             "first_loss_expected": expected,
             "step_ms_median": med, "step_ms_min": timed_ms[0],
             "step_ms_max": timed_ms[-1],
             "tokens_per_s": MOE_BATCH * MOE_SEQ / (med / 1e3),
             "peak_mem_gb": peak_gb,
             "dropped_pairs_per_layer_call": dropped,
             "routed_pairs_per_layer_call": MOE_BATCH * MOE_SEQ
             * cfg.moe_top_k,
             "one_step": breakdown, "launches_by_kernel": by_kernel,
             "card": card}
    log(f"{tag}: " + json.dumps(stats))
    return by_kernel, stats, scope


def moe_eval_program(fluid, cfg):
    """``build_llama(cfg, tokens)``'s test clone: the per-layer MoE
    forward (test-mode moe_ffn, drop-free; K1 once a layer)."""
    from paddle_tpu_torch.models.llama import build_llama
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()), \
            fluid.unique_name.guard():
        ftok = fluid.layers.data(name="ftok", shape=[-1, -1],
                                 dtype="int64", append_batch_size=False)
        logits, _ = build_llama(cfg, ftok)
    return main.clone(for_test=True), logits


def moe_generate_check(torch, fluid, exe, scope, cfg, tag, prompt, new):
    """Generate ``new`` tokens for ``prompt`` from a stacked MoE scope and
    hold each against the eval forward teacher-forced on the generated
    sequence (flips only within twice the row's first-step logit
    error). Returns (tokens, agreed per row, first-step errors, wall ms
    of the generate)."""
    gen_p, _, (out_v, probs_v) = gen_programs(
        fluid, cfg, prompt.shape[1], max_new_tokens=new, return_probs=True)
    fwd_p, logits_v = moe_eval_program(fluid, cfg)
    (gen, probs), ms = timed(torch, lambda: run_gen(
        exe, gen_p, [out_v, probs_v], scope, prompt))
    check(np.array_equal(gen[:, :prompt.shape[1]], prompt),
          f"{tag}: the prompt is not echoed")
    logits = exe.run(fwd_p, feed={"ftok": gen}, fetch_list=[logits_v],
                     scope=scope, mode="test", return_numpy=False)[0]
    logits = logits.float()
    check(bool(torch.isfinite(logits).all()), f"{tag}: eval logits")
    row_err = log_prob_error(
        torch, torch.as_tensor(probs, device=logits.device),
        logits[:, prompt.shape[1] - 1])
    agreed = greedy_against_recompute(tag, gen, logits.cpu().numpy(),
                                      prompt.shape[1], row_err,
                                      stop_at_flip=True)
    return gen, agreed, row_err, ms


def phase_moe_generate(torch, fluid, fa, card, trained):
    """The MoE generation path: ``moe_train``'s trained scope through
    ``stack_generator_weights`` and ``build_llama_generator`` (bf16,
    drop-free MoE FFNs), MOE_GEN_BATCH prompts of MOE_GEN_PROMPT tokens
    and MOE_GEN_NEW new ones, each greedy token held against the eval
    forward of ``build_llama`` teacher-forced on the generated sequence
    (bf16 flips within twice the row's first-step logit error); a
    float32 model at MOE_F32_LAYERS layer the same way, where a flip
    must stay within the f32 error; W8A8 (``quantize_generator_weights``)
    with its int8 expert products exact on the card, the reference's
    measure (the share of tokens equal to the float generator's;
    tests/test_llama_generate.py:468 asserts >= MOE_Q_AGREE on its
    trained tiny model) and each row's first disagreement with the float
    eval forward reported. Prints ms per token.
    Returns (K1 launches by kernel of the bf16 generate and eval, stats)."""
    from paddle_tpu_torch.models.llama import (quantize_generator_weights,
                                               stack_generator_weights)
    tag = "moe_generate"
    cfg = _mixtral()
    exe = fluid.Executor()
    stack_generator_weights(cfg, trained)
    prompt = np.random.RandomState(SEED + 13).randint(
        0, cfg.vocab_size, (MOE_GEN_BATCH, MOE_GEN_PROMPT)).astype(np.int64)
    # the main path: counts reset just before, read just after
    fa.reset_launch_counts()
    gen, agreed, row_err, ms = moe_generate_check(
        torch, fluid, exe, trained, cfg, tag, prompt, MOE_GEN_NEW)
    by_kernel = launches_by_kernel(fa)
    check(by_kernel.get(bf16_k1(torch, fa, cfg), 0) == cfg.n_layers,
          f"{tag}: K1 launches {by_kernel} (the eval forward: one a layer)")
    # W8A8: the int8 expert products exact on the card at a decode
    # step's shape; the reference's measure (tokens equal to the float
    # generator's, position by position; >= MOE_Q_AGREE on its trained
    # tiny model), and each row's first disagreement with the float
    # eval forward on the W8A8 sequence beside its first-step error,
    # reported
    from paddle_tpu_torch.ops.transformer_ops import int8_einsum
    qgen_p, _, (q_out, q_probs) = gen_programs(
        fluid, cfg, MOE_GEN_PROMPT, max_new_tokens=MOE_GEN_NEW,
        quantize=True, return_probs=True)
    fwd_p, logits_v = moe_eval_program(fluid, cfg)
    float_logits = exe.run(fwd_p, feed={"ftok": prompt},
                           fetch_list=[logits_v], scope=trained,
                           mode="test", return_numpy=False)[0].float()
    float_head = trained.find_var("lm_head")     # the eval forward's
    quantize_generator_weights(trained)
    (qgen, qprobs), q_ms = timed(torch, lambda: run_gen(
        exe, qgen_p, [q_out, q_probs], trained, prompt))
    trained.set("lm_head", float_head)
    w8 = trained.find_var("blocks.moe_w_gate")[0]            # [E, D, H]
    x8 = torch.randint(-127, 128, (MOE_GEN_BATCH, cfg.dim),
                       generator=torch.Generator().manual_seed(SEED),
                       dtype=torch.int8).to(w8.device)
    n_exact = check_int8_exact(torch, f"{tag} W8A8",
                               int8_einsum("td,edh->teh", x8, w8), x8, w8,
                               "td,edh->teh")
    q_err = log_prob_error(
        torch, torch.as_tensor(qprobs, device=float_logits.device),
        float_logits[:, MOE_GEN_PROMPT - 1])
    del float_logits
    qlogits = exe.run(fwd_p, feed={"ftok": qgen}, fetch_list=[logits_v],
                      scope=trained, mode="test",
                      return_numpy=False)[0].float().cpu().numpy()
    q_flips = []
    for r in range(MOE_GEN_BATCH):
        for pos in range(MOE_GEN_PROMPT, qgen.shape[1]):
            row = qlogits[r, pos - 1]
            want, got = int(row.argmax()), int(qgen[r, pos])
            if got != want:
                q_flips.append({"row": r, "pos": pos,
                                "margin": float(row[want] - row[got]),
                                "first_step_err": q_err[r]})
                break
    del qlogits
    agree = float((qgen[:, MOE_GEN_PROMPT:] == gen[:, MOE_GEN_PROMPT:])
                  .mean())
    check(np.array_equal(qgen[:, :MOE_GEN_PROMPT], prompt),
          f"{tag}: W8A8 does not echo the prompt")
    check(((qgen >= 0) & (qgen < cfg.vocab_size)).all(),
          f"{tag}: a W8A8 token outside the vocabulary")
    q_first = float((qgen[:, MOE_GEN_PROMPT] == gen[:, MOE_GEN_PROMPT])
                    .mean())
    # float32 at MOE_F32_LAYERS layer(s): random weights from SEED
    fcfg = dataclasses.replace(cfg, n_layers=MOE_F32_LAYERS,
                               dtype="float32")
    _, fstart, _ = build_train(fluid, fcfg, 1e-4)
    fscope = fluid.Scope()
    exe.run(fstart, scope=fscope)
    stack_generator_weights(fcfg, fscope)
    fa.reset_launch_counts()
    _, f_agreed, f_err, _ = moe_generate_check(
        torch, fluid, exe, fscope, fcfg, f"{tag} f32", prompt[:2],
        MOE_GEN_NEW // 2)
    # the eval forward: K1 once a layer, on the kernel float32 routes to
    # at the Mixtral head dim
    f_by_kernel = launches_by_kernel(fa)
    check(f_by_kernel[f32_kernel(torch, fa, "flash_fwd",
                                 fcfg.dim // fcfg.n_heads)]
          == fa.flash_fwd.launches == MOE_F32_LAYERS,
          f"{tag} f32: K1 launches {f_by_kernel} (one a layer)")
    del fscope
    stats = {"layers": cfg.n_layers, "batch": MOE_GEN_BATCH,
             "prompt": MOE_GEN_PROMPT, "new_tokens": MOE_GEN_NEW,
             "bf16_agreed_before_flip": agreed,
             "bf16_row_logit_err": row_err,
             "bf16_generate_ms": ms,
             "bf16_ms_per_token": ms / MOE_GEN_NEW,
             "w8a8_generate_ms": q_ms,
             "w8a8_ms_per_token": q_ms / MOE_GEN_NEW,
             "w8a8_int8_products_exact": n_exact,
             "w8a8_first_disagreement_vs_float_eval": q_flips,
             "w8a8_agreement": agree,
             "w8a8_agreement_reference_bound": MOE_Q_AGREE,
             "w8a8_first_token_agreement": q_first,
             "w8a8_row_first_step_err": q_err,
             "f32_layers": MOE_F32_LAYERS, "f32_agreed_before_flip": f_agreed,
             "f32_row_logit_err": f_err,
             "f32_launches_by_kernel": f_by_kernel,
             "launches_by_kernel": by_kernel, "card": card}
    log(f"{tag}: " + json.dumps(stats))
    return by_kernel, stats


def _two_rank_entry(rank, path, q):
    """One rank of the two-rank attempt: an NCCL group of two processes
    on the one card, one all-reduce."""
    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(path, 2),
                                rank=rank, world_size=2)
        t = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        q.put((rank, "ok", float(t[0])))
        dist.destroy_process_group()
    except Exception as e:                   # noqa: BLE001 — recorded
        q.put((rank, "error", f"{type(e).__name__}: {e}"[:600]))


def phase_mesh_two_ranks(torch, card):
    """Whether the one card admits a mesh of two ranks: two processes
    (spawned) join one NCCL group on device 0 and all-reduce. NCCL is
    expected to refuse two ranks on one device; gloo would carry CUDA
    tensors through host memory, which is staging through the host, so
    it is not tried. The outcome and the error text are logged; the
    phase passes either way (it records, it does not gate). Returns the
    outcome."""
    import multiprocessing
    import tempfile
    tag = "mesh_two_ranks"
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_two_rank_entry,
                             args=(r, os.path.join(d, "store"), q))
                 for r in range(2)]
        for p in procs:
            p.start()
        results = []
        deadline = time.monotonic() + TWO_RANK_TIMEOUT_S
        while len(results) < 2 and time.monotonic() < deadline:
            try:
                results.append(q.get(timeout=max(0.1, deadline
                                                 - time.monotonic())))
            except Exception:                # noqa: BLE001 — queue.Empty
                break
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
    admitted = len(results) == 2 and all(r[1] == "ok" for r in results)
    outcome = {"admitted": admitted, "ranks": sorted(results),
               "hung": len(results) < 2, "card": card}
    if admitted:
        check(all(r[2] == 3.0 for r in results),
              f"{tag}: the two ranks' all-reduce gave {results}")
    log(f"{tag}: " + json.dumps(outcome))
    return outcome


def rel_rms_t(got, want):
    """Relative RMS error of tensor ``got`` against ``want`` (float32)."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def phase_pipeline_llama_train(torch, fluid, fa, card):
    """The main path of this slice's pipeline: the Llama-3-8B width cut
    to PIPE_LAYERS layers, bf16, Adam(1e-4), ``build_llama(shard_pp=True,
    fused_head_chunk=STACK_CHUNK)`` as two programs over one startup
    scope — the GPipe op (``llama_decoder_stack``) and
    ``pp_schedule="1f1b"`` (``llama_stack_1f1b_loss``, head and loss
    inside the op). One card admits only one-rank meshes, where both ops
    take their single-device branch (the 1F1B one is the reference's
    ``test_llama_1f1b_single_device_fallback``). Each program runs
    through ``Executor.run`` and through ``ParallelExecutor`` on a
    one-rank {"dp": 1, "pp": 1} NCCL mesh, on copies of the scope, with
    deterministic algorithms: the first step's loss and every gradient,
    then PIPE_STEPS timed steps' losses and every persistable after
    them, bit-equal between the executors; the two programs' first
    losses and first-step gradients within the bf16 relative-RMS tier
    (TOL_LOGITS_BF16_RMS) of each other; K1 twice (remat) and K2/K3 once
    a layer a step on the tensor cores. Records each program's step ms
    on both executors, its launches a step and peak memory. Returns
    ({program: launches by kernel of its timed Executor steps}, stats)."""
    from paddle_tpu_torch.core.executor import global_value
    from paddle_tpu_torch.models.llama import LLAMA3_8B
    from paddle_tpu_torch.parallel import make_mesh
    tag = "pipeline_llama_train"
    cfg = dataclasses.replace(LLAMA3_8B, n_layers=PIPE_LAYERS)
    progs = {"gpipe": build_train(fluid, cfg, 1e-4, shard_pp=True,
                                  fused_head_chunk=STACK_CHUNK),
             "1f1b": build_train(fluid, cfg, 1e-4, shard_pp=True,
                                 pp_schedule="1f1b",
                                 fused_head_chunk=STACK_CHUNK)}
    op_types = {n: [op.type for op in m.global_block().ops]
                for n, (m, _, _) in progs.items()}
    check("llama_decoder_stack" in op_types["gpipe"]
          and "llama_stack_1f1b_loss" in op_types["1f1b"]
          and "llama_decoder_stack" not in op_types["1f1b"],
          f"{tag}: the programs' ops {op_types}")
    persist = {n: sorted(v for v, var in m.global_block().vars.items()
                         if var.persistable) for n, (m, _, _) in progs.items()}
    check(persist["gpipe"] == persist["1f1b"],
          f"{tag}: the programs' persistables differ: "
          f"{set(persist['gpipe']) ^ set(persist['1f1b'])}")
    exe = fluid.Executor()                     # the card: CUDAPlace(0)
    init = fluid.Scope()
    exe.run(progs["gpipe"][1], scope=init)
    feed = train_feed(cfg.vocab_size, PIPE_BATCH, PIPE_SEQ)
    mesh = make_mesh({"dp": 1, "pp": 1})
    check(mesh.axes == {"dp": 1, "pp": 1} and mesh.device.type == "cuda",
          f"{tag}: the one card's mesh is {mesh.axes} on {mesh.device}")
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    expected = math.log(cfg.vocab_size) + cfg.dim * INIT_STD ** 2 / 2
    first, launches, stats = {}, {}, {"layers": cfg.n_layers,
                                      "batch": [PIPE_BATCH, PIPE_SEQ],
                                      "mesh": mesh.axes, "card": card}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for name, (main, _, loss) in progs.items():
                grads = sorted(v for v in main.global_block().vars
                               if v.endswith("@GRAD"))
                e_scope, p_scope = scope_from(fluid, init.vars), \
                    scope_from(fluid, init.vars)
                pe = fluid.ParallelExecutor(loss_name=loss.name,
                                            main_program=main,
                                            scope=p_scope, mesh=mesh)
                # the first step, every gradient fetched, on both
                ge = exe.run(main, feed=feed, fetch_list=[loss] + grads,
                             scope=e_scope, return_numpy=False)
                gp = [global_value(g) for g in pe.run(
                    fetch_list=[loss.name] + grads, feed=feed,
                    return_numpy=False)]
                differing = [n for n, a, b in zip(["loss"] + grads, ge, gp)
                             if not torch.equal(a, b)]
                check(not differing,
                      f"{tag} {name}: the ParallelExecutor's first step "
                      f"differs from the Executor's in {differing[:6]}")
                del gp
                first[name] = (float(ge[0].reshape(())),
                               dict(zip(grads, ge[1:])))
                del ge
                check(abs(first[name][0] - expected) < 0.5,
                      f"{tag} {name}: first loss {first[name][0]:.4f} not "
                      f"within 0.5 of {expected:.4f}")
                # the main path: counts reset just before, read just after
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated() / 1e9
                torch.cuda.reset_peak_memory_stats()
                fa.reset_launch_counts()
                e_losses, e_ms = [], []
                for _ in range(PIPE_STEPS):
                    out, ms = timed(torch, lambda: exe.run(
                        main, feed=feed, fetch_list=[loss], scope=e_scope))
                    e_losses.append(float(np.asarray(out[0]).reshape(())))
                    e_ms.append(ms)
                counts = [w.launches for w in wrappers]
                launches[name] = launches_by_kernel(fa)
                peak = torch.cuda.max_memory_allocated() / 1e9
                p_losses, p_ms = [], []
                for _ in range(PIPE_STEPS):
                    out, ms = timed(torch, lambda: pe.run(
                        feed=feed, fetch_list=[loss.name]))
                    p_losses.append(float(np.asarray(out[0]).reshape(())))
                    p_ms.append(ms)
                differing = [n for n in e_scope.keys() if not torch.equal(
                    global_value(p_scope.find_var(n)), e_scope.find_var(n))]
                check(p_losses == e_losses,
                      f"{tag} {name}: ParallelExecutor losses {p_losses} "
                      f"are not the Executor's {e_losses} bit for bit")
                check(not differing,
                      f"{tag} {name}: {len(differing)} persistables differ "
                      f"after {PIPE_STEPS} steps: {differing[:6]}")
                check(all(math.isfinite(x) for x in e_losses)
                      and e_losses[-1] < first[name][0],
                      f"{tag} {name}: losses {first[name][0]} then "
                      f"{e_losses}")
                for k, w, n, per in zip(("K1", "K2", "K3"), wrappers,
                                        counts, (2, 1, 1)):
                    check(n == per * cfg.n_layers * PIPE_STEPS,
                          f"{tag} {name}: {k} launched {n} times, not "
                          f"{per} x {cfg.n_layers} layers x {PIPE_STEPS} "
                          "steps")
                    _, variant = fa.kernel_for(w.__name__, torch.bfloat16,
                                               128)
                    check(launches[name][variant] == n,
                          f"{tag} {name}: {k} by kernel {launches[name]}: "
                          f"not all {variant}")
                stats[name] = {
                    "first_loss": first[name][0], "losses": e_losses,
                    "executor_step_ms": e_ms, "pe_step_ms": p_ms,
                    "tokens_per_s": PIPE_BATCH * PIPE_SEQ
                    / (float(np.median(e_ms)) / 1e3),
                    "launches_per_step": [n // PIPE_STEPS for n in counts],
                    "resident_gb_before": resident, "peak_gb": peak}
                del e_scope, p_scope, pe
                free_card(torch)
    finally:
        torch.use_deterministic_algorithms(False)
    del init
    (lg, gg), (lf, gf) = first["gpipe"], first["1f1b"]
    loss_err = abs(lf - lg) / abs(lg)
    check(loss_err <= TOL_LOGITS_BF16_RMS and set(gg) == set(gf),
          f"{tag}: first losses gpipe {lg} vs 1f1b {lf}, gradients "
          f"{sorted(set(gg) ^ set(gf))}")
    errs = {n: rel_rms_t(gf[n], gg[n]) for n in gg}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= TOL_LOGITS_BF16_RMS,
          f"{tag}: 1F1B's first-step gradient of {worst} is {errs[worst]:.3e}"
          f" (relative RMS) from GPipe's, over {TOL_LOGITS_BF16_RMS}")
    stats["first_loss_rel_err"] = loss_err
    stats["grads_rel_rms_worst"] = [worst, errs[worst]]
    stats["grads_checked"] = len(errs)
    log(f"{tag}: " + json.dumps(stats))
    return launches, stats


def sched_stage(torch, cfg, layers, dtype, dev, gen):
    """One stage's stacked decoder weights ([1, layers, ...] per slot of
    ``transformer_ops._STACK_SLOTS``: norms 1, matrices N(0, INIT_STD)),
    the head's (final norm, lm head [dim, vocab]) and the stage function
    of the layer-stacked ops (``make_flash_block``, remat on)."""
    from paddle_tpu_torch.ops import transformer_ops as tops
    d, hd = cfg.dim, cfg.dim // cfg.n_heads
    shapes = {"AttnNorm": (d,), "Wq": (d, cfg.n_heads * hd),
              "Wk": (d, cfg.n_kv_heads * hd),
              "Wv": (d, cfg.n_kv_heads * hd), "Wo": (cfg.n_heads * hd, d),
              "MlpNorm": (d,), "WGate": (d, cfg.ffn_hidden),
              "WUp": (d, cfg.ffn_hidden), "WDown": (cfg.ffn_hidden, d)}

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=dev) * INIT_STD) \
            .to(dtype)

    stage = {s: (torch.ones((1, layers) + sh, device=dev, dtype=dtype)
                 if len(sh) == 1 else normal((1, layers) + sh))
             for s, sh in shapes.items()}
    head = {"fnorm": torch.ones(d, device=dev, dtype=dtype),
            "head": normal((d, cfg.vocab_size))}
    blk = tops.make_flash_block(cfg.n_heads, cfg.n_kv_heads, cfg.rope_base,
                                cfg.norm_eps, remat=True)
    return stage, head, lambda sp, h: tops._run_layers(blk, sp, h)


def sched_loss(cfg):
    """The 1F1B op's loss of a microbatch: final rms_norm, then the
    vocab-chunked cross entropy's mean."""
    from paddle_tpu_torch.ops.fused_loss import fused_head_cross_entropy
    from paddle_tpu_torch.ops.transformer_ops import rms_normalize

    def ce(lp, y, t):
        h = rms_normalize(y, lp["fnorm"], cfg.norm_eps)
        return fused_head_cross_entropy(h.reshape(-1, h.shape[-1]),
                                        lp["head"], t.reshape(-1),
                                        STACK_CHUNK).mean()
    return ce


def sched_case(torch, fa, cfg, layers, seq, dtype, mesh, seed):
    """gpipe and one_f_one_b(loss_params=True, return_dx=True) on a
    one-rank 'pp' mesh against plain autograd of the sequential function
    (the stage over each microbatch, the mean of the microbatches'
    losses): {schedule: (loss, {gradient name: tensor}, [K1, K2, K3
    launches], launches by kernel)}."""
    from paddle_tpu_torch.parallel.pipeline import gpipe, one_f_one_b
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + seed)
    stage, head, stage_fn = sched_stage(torch, cfg, layers, dtype, dev, gen)
    ce = sched_loss(cfg)
    x = torch.randn((SCHED_MICRO, 1, seq, cfg.dim), generator=gen,
                    device=dev).to(dtype)
    y = torch.randint(0, cfg.vocab_size, (SCHED_MICRO, 1, seq),
                      generator=gen, device=dev)
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)

    def leaves():
        return ({s: w.detach().clone().requires_grad_()
                 for s, w in stage.items()},
                {s: w.detach().clone().requires_grad_()
                 for s, w in head.items()},
                x.detach().clone().requires_grad_())

    def by_autograd(total, sp, lp, xl):
        names = [f"stage.{s}" for s in sp] + [f"head.{s}" for s in lp] + [
            "dx"]
        got = torch.autograd.grad(total, list(sp.values())
                                  + list(lp.values()) + [xl])
        return float(total.detach()), dict(zip(names, got))

    def sequential():
        sp, lp, xl = leaves()
        layers_ = {s: w[0] for s, w in sp.items()}
        total = sum(ce(lp, stage_fn(layers_, xl[k]), y[k])
                    for k in range(SCHED_MICRO)) / SCHED_MICRO
        return by_autograd(total, sp, lp, xl)

    def piped():
        sp, lp, xl = leaves()
        out = gpipe(stage_fn, mesh, checkpoint_stages=False)(sp, xl)
        total = sum(ce(lp, out[k], y[k])
                    for k in range(SCHED_MICRO)) / SCHED_MICRO
        return by_autograd(total, sp, lp, xl)

    def one_f_one_b_():
        step = one_f_one_b(stage_fn, ce, mesh, loss_params=True,
                           return_dx=True)
        loss, grads, lgrads, dx = step(stage, head, x, y)
        out = {f"stage.{s}": g for s, g in grads.items()}
        out.update({f"head.{s}": g for s, g in lgrads.items()})
        out["dx"] = dx
        return float(loss), out

    res = {}
    for name, fn in (("sequential", sequential), ("gpipe", piped),
                     ("1f1b", one_f_one_b_)):
        fa.reset_launch_counts()
        loss, grads = fn()
        torch.cuda.synchronize()
        res[name] = (loss, grads, [w.launches for w in wrappers],
                     launches_by_kernel(fa))
    return res


def phase_pipeline_schedule(torch, fa, card):
    """The schedules themselves on the card: ``gpipe`` and
    ``one_f_one_b(loss_params=True, return_dx=True)`` on a one-rank
    {"pp": 1} NCCL mesh, a stage of SCHED_LAYERS decoder layers at the 8B
    width with the 8B head and loss, SCHED_MICRO microbatches of 1 x
    SCHED_SEQ, in bf16: loss, stage gradients, head gradients and dx
    against plain autograd of the sequential function within the bf16
    relative-RMS tier; then in float32 at SCHED_F32_LAYERS layer(s) and
    T SCHED_F32_SEQ with TF32 off, at the f32 gradient tier. A one-stage
    pipeline exchanges nothing: its ticks, the 1F1B slot ring, the
    in-schedule recompute and the accumulation are what run; the float32
    case's K1, K2 and K3 launches on their warpgroup kernels of head dim
    128. Returns ({schedule: the bf16 case's
    launches by kernel}, stats; the float32 case's launches by kernel
    under stats["f32"]["launches_by_kernel"])."""
    from paddle_tpu_torch.models.llama import LLAMA3_8B
    from paddle_tpu_torch.parallel import collectives, make_mesh
    tag = "pipeline_schedule"
    mesh = make_mesh({"pp": 1})
    cfg = LLAMA3_8B
    log(f"{tag}: a one-stage pipeline exchanges nothing (each permute is "
        "a copy to itself; the shares and sums over 'pp' are one-rank "
        "all-reduces): what runs is the schedules' ticks, 1F1B's slot "
        "ring, its in-schedule recompute and the accumulation")
    stats = {"card": card, "mesh": mesh.axes}
    allow = torch.backends.cuda.matmul.allow_tf32
    try:
        for label, layers, seq, dtype in (
                ("bf16", SCHED_LAYERS, SCHED_SEQ, torch.bfloat16),
                ("f32", SCHED_F32_LAYERS, SCHED_F32_SEQ, torch.float32)):
            torch.backends.cuda.matmul.allow_tf32 = False
            with collectives.counting() as coll:
                res = sched_case(torch, fa, cfg, layers, seq, dtype, mesh,
                                 seed=21 if label == "bf16" else 22)
            want_loss, want = res["sequential"][:2]
            worst = {}
            for name in ("gpipe", "1f1b"):
                loss, grads = res[name][:2]
                check(set(grads) == set(want),
                      f"{tag} {label} {name}: gradients {sorted(grads)}")
                if label == "bf16":
                    errs = {g: rel_rms_t(grads[g], want[g]) for g in want}
                    errs["loss"] = abs(loss - want_loss) / abs(want_loss)
                    bad = {g: e for g, e in errs.items()
                           if not e <= TOL_LOGITS_BF16_RMS}
                    check(not bad, f"{tag} bf16 {name}: relative RMS "
                          f"errors over {TOL_LOGITS_BF16_RMS}: {bad}")
                else:
                    errs = {}
                    for g in want:
                        ok, err = allclose_err(grads[g], want[g],
                                               TOL_GRAD_F32)
                        check(ok, f"{tag} f32 {name}: {g} off by {err:.3e}"
                              f" (rtol, atol {TOL_GRAD_F32})")
                        errs[g] = err
                    check(abs(loss - want_loss) <= TOL_GRAD_F32[1]
                          + TOL_GRAD_F32[0] * abs(want_loss),
                          f"{tag} f32 {name}: loss {loss} vs {want_loss}")
                    errs["loss"] = abs(loss - want_loss)
                w = max(errs, key=errs.get)
                worst[name] = [w, errs[w]]
            k1 = {n: r[2] for n, r in res.items()}
            # the stage's layers run the flash kernels in every schedule:
            # the sequential and GPipe forward once and recompute once
            # (remat) a layer a microbatch, 1F1B forward, recompute
            # under its in-schedule grad and again in the backward
            m, nl = SCHED_MICRO, layers
            want_k = {"sequential": [2 * nl * m, nl * m, nl * m],
                      "gpipe": [2 * nl * m, nl * m, nl * m],
                      "1f1b": [3 * nl * m, nl * m, nl * m]}
            check(k1 == want_k, f"{tag} {label}: K1/K2/K3 launches "
                  f"{k1}, expected {want_k}")
            by_kernel = {n: r[3] for n, r in res.items()}
            if label == "f32":
                # every launch on the kernel float32 routes to at the
                # 8B head dim
                syms = [f32_kernel(torch, fa, w, cfg.dim // cfg.n_heads)
                        for w in ("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv")]
                for n, counts in k1.items():
                    check([by_kernel[n][s] for s in syms] == counts,
                          f"{tag} f32 {n}: launches {by_kernel[n]}, "
                          f"expected {dict(zip(syms, counts))}")
            stats[label] = {"layers": layers, "seq": seq,
                            "loss": {n: r[0] for n, r in res.items()},
                            "worst_err": worst, "launches_k1_k2_k3": k1,
                            "collectives": dict(coll)}
            if label == "bf16":
                launches = by_kernel
            else:
                stats[label]["launches_by_kernel"] = by_kernel
            del res
            free_card(torch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    log(f"{tag}: " + json.dumps(stats))
    return launches, stats


def ring_rows(torch, q, k, v, n, i, causal, zero_offsets=False):
    """Query chunk i's ring output over n chunks of q, k, v [B, H, T, D]:
    the steps rank i of an n-rank 'sp' axis runs
    (``parallel.ring_attention.ring_step``). At step s it attends chunk
    (i - s) mod n, masked at global positions, or, with
    ``zero_offsets``, as if both chunks started at 0 (a wrong bias: the
    control). Differentiable."""
    from paddle_tpu_torch.parallel.ring_attention import ring_step
    tl = q.shape[2] // n
    scale = 1.0 / math.sqrt(q.shape[-1])
    qi = q[:, :, i * tl:(i + 1) * tl]
    o = torch.zeros_like(qi)
    lse = torch.full(qi.shape[:3], -1e30, dtype=torch.float32,
                     device=q.device)
    for s in range(n):
        src = (i - s) % n
        q_off, k_off = (0, 0) if zero_offsets else (i * tl, src * tl)
        o, lse = ring_step(qi, k[:, :, src * tl:(src + 1) * tl],
                           v[:, :, src * tl:(src + 1) * tl], o, lse, q_off,
                           k_off, causal, scale)
    return o


def ring_over_chunks(torch, q, k, v, n, causal, zero_offsets=False):
    """The ring's output over n chunks: every query chunk's rows."""
    return torch.cat([ring_rows(torch, q, k, v, n, i, causal, zero_offsets)
                      for i in range(n)], dim=2)


def phase_ring_attention(torch, fa, card):
    """The ring's step (``ring_step``: the bias from the chunks' global
    offsets, the plain biased attention, the lse merge — the code each
    rank of an 'sp' axis runs) at the 8B attention width (B 1, 32 heads,
    D 128) on the card. Forward: T RING_SEQ as RING_CHUNKS chunks in
    bf16 against K1 over the whole sequence, causal and not, within
    RING_TOL_BF16_RMS (relative RMS); the same ring with a bias built as
    if every chunk started at 0 (the control) must miss it. Gradient: T
    RING_GRAD_SEQ as RING_GRAD_CHUNKS chunks in float32 (TF32 off) against
    K1-K3 at the f32 gradient tier. ``ring_attention_sharded`` on a
    one-rank 'sp' NCCL mesh at T RING_MESH_SEQ against K1. Records the
    ring's and K1's time and peak memory (the plain step materialises
    [32, Tl, Tl] float32 scores). Returns stats."""
    from torch.distributed.tensor import DTensor, Shard
    from paddle_tpu_torch.parallel import collectives, make_mesh
    from paddle_tpu_torch.parallel.ring_attention import \
        ring_attention_sharded
    tag = "ring_attention"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 31)

    def qkv(seq, dtype, grad=False):
        return [torch.randn((1, RING_HEADS, seq, RING_D), generator=gen,
                            device=dev).to(dtype).requires_grad_(grad)
                for _ in range(3)]

    def measured(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, ms = timed(torch, fn)
        return out, ms, (torch.cuda.max_memory_allocated() - base) / 1e9

    stats = {"card": card, "chunks": RING_CHUNKS, "seq": RING_SEQ}
    q, k, v = qkv(RING_SEQ, torch.bfloat16)
    for causal in (True, False):
        with torch.no_grad():
            ring, ring_ms, ring_gb = measured(lambda: ring_over_chunks(
                torch, q, k, v, RING_CHUNKS, causal))
            want, k1_ms, k1_gb = measured(lambda: fa.flash_attention(
                q, k, v, causal))
        err = rel_rms_t(ring, want)
        check(err <= RING_TOL_BF16_RMS,
              f"{tag}: the bf16 ring (causal={causal}) is {err:.3e} from K1 "
              f"(relative RMS), over {RING_TOL_BF16_RMS}")
        stats[f"bf16_causal={causal}"] = {
            "rel_rms": err, "max_abs_err": float((ring.float()
                                                  - want.float()).abs().max()),
            "ring_ms": ring_ms, "ring_peak_gb": ring_gb, "k1_ms": k1_ms,
            "k1_peak_gb": k1_gb}
        del ring, want
    # the control: offsets of 0 for every chunk mask the wrong keys
    with torch.no_grad():
        bad = ring_over_chunks(torch, q, k, v, RING_CHUNKS, True,
                               zero_offsets=True)
        err = rel_rms_t(bad, fa.flash_attention(q, k, v, True))
    check(err > RING_TOL_BF16_RMS,
          f"{tag}: the control (every chunk's offset 0) passed the rule "
          f"({err:.3e} <= {RING_TOL_BF16_RMS})")
    stats["control_rel_rms"] = err
    del q, k, v, bad
    # the gradient, float32: a weighted sum of the output, one query
    # chunk's graph at a time
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        q, k, v = qkv(RING_GRAD_SEQ, torch.float32, grad=True)
        w = torch.randn(q.shape, generator=gen, device=dev)
        n, tl = RING_GRAD_CHUNKS, RING_GRAD_SEQ // RING_GRAD_CHUNKS
        outs = []
        for i in range(n):
            oi = ring_rows(torch, q, k, v, n, i, True)
            (oi * w[:, :, i * tl:(i + 1) * tl]).sum().backward()
            outs.append(oi.detach())
            del oi
        ring_out = torch.cat(outs, dim=2)
        ring_grads = [x.grad for x in (q, k, v)]
        q2, k2, v2 = (x.detach().clone().requires_grad_() for x in (q, k, v))
        want = fa.flash_attention(q2, k2, v2, True)
        (want * w).sum().backward()
        ok, fwd_err = allclose_err(ring_out, want.detach(), TOL_F32)
        check(ok, f"{tag}: the f32 ring is {fwd_err:.3e} from K1 "
              f"(rtol, atol {TOL_F32})")
        grad_errs = {}
        for name, g, g2 in zip(("dq", "dk", "dv"), ring_grads,
                               (q2.grad, k2.grad, v2.grad)):
            ok, err = allclose_err(g, g2, TOL_GRAD_F32)
            check(ok, f"{tag}: the f32 ring's {name} is {err:.3e} from "
                  f"K2/K3's (rtol, atol {TOL_GRAD_F32})")
            grad_errs[name] = err
        stats["f32_grad"] = {"seq": RING_GRAD_SEQ, "chunks": n,
                             "fwd_max_abs_err": fwd_err,
                             "grad_max_abs_err": grad_errs}
        del q, k, v, q2, k2, v2, w, want, ring_out, ring_grads, outs
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    # the global entry on the one card's 'sp' mesh: one chunk, no permute
    mesh = make_mesh({"sp": 1})
    q, k, v = qkv(RING_MESH_SEQ, torch.bfloat16)
    placed = [DTensor.from_local(x, mesh.mesh, [Shard(2)], run_check=False)
              for x in (q, k, v)]
    with torch.no_grad(), collectives.counting() as coll:
        got = ring_attention_sharded(*placed, mesh, axis="sp", causal=True)
        want = fa.flash_attention(q, k, v, True)
    check(isinstance(got, DTensor) and list(got.placements) == [Shard(2)],
          f"{tag}: the sharded ring returned {type(got).__name__} "
          f"{getattr(got, 'placements', None)}")
    err = rel_rms_t(got.to_local(), want)
    check(err <= RING_TOL_BF16_RMS and not coll,
          f"{tag}: the one-rank sharded ring is {err:.3e} from K1, "
          f"collectives {coll}")
    stats["one_rank_mesh"] = {"seq": RING_MESH_SEQ, "rel_rms": err,
                              "collectives": dict(coll)}
    log(f"{tag}: " + json.dumps(stats))
    return stats


# ----------------------------------------------------------------------
# ROADMAP item 7a: the dense zoo leftovers, sequences and the recurrent
# ops — DeepFM and the stacked dynamic LSTM at bench.py's widths, the
# recommender and word2vec
# ----------------------------------------------------------------------
CTR_VOCAB = 1_000_000           # bench.py ctr_main's knobs (:1024-1031)
CTR_FIELDS = 23
CTR_EMBED = 16
CTR_HIDDEN = (400, 400)
CTR_BATCH = 4096
CTR_WARMUP = 2
CTR_STEPS = 20
CTR_WIDE_STEPS = 3
CTR_PARITY_VOCAB = 10_000       # card vs CPU at a vocab the CPU steps fast
CTR_PARITY_BATCH = 512
SEQ_TOL = (2e-3, 2e-4)          # card vs CPU, float32, TF32 off
LSTM_VOCAB = 10_000             # bench.py seq_main's knobs (:793-825)
LSTM_EMB = 128
LSTM_HID = 512                  # dynamic_lstm size: hidden 128, 3 stacked
LSTM_BATCH = 32
LSTM_SEQ = 64
LSTM_WARMUP = 2
LSTM_STEPS = 10                 # bench.py's iters on the chip
LSTM_VAR_LENS = (9, 64)         # the variable-length feed's lengths
LSTM_VAR_STEPS = 4
REC_BATCH = 256
REC_CATS = (1, 6)               # categories a movie
REC_TITLE = (2, 15)             # title words a movie
W2V_DICT = 2073                 # the PTB dictionary's size (book example)
W2V_BATCH = 32
SEQ_ZOO_STEPS = 3
SEQ_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "paddle_tpu_torch", "_build", "chip_smoke_seq")


def np_close(got, want, tol):
    """(within ``tol`` = (rtol, atol) everywhere, max abs error) of two
    arrays of one shape."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return False, float("inf")
    err = np.abs(got - want)
    return (bool((err <= tol[1] + tol[0] * np.abs(want)).all()),
            float(err.max()) if err.size else 0.0)


def kernel_table(torch, fn):
    """One call of ``fn`` under torch.profiler: {kernel name: [ms,
    launches]} of the device's kernels and copies, and the call's wall
    ms. Empty where the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.core.lowering import RANGE_OPTIMIZER
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    table = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.key == RANGE_OPTIMIZER:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        table[e.key] = [us / 1e3, int(e.count)]
    return table, wall


# kernel-name fragments of the CTR step's kinds (lower case)
CTR_KINDS = (("embedding_backward", ("indexing_backward", "index_put",
                                     "radix", "sort", "scatter",
                                     "embedding_backward")),
             ("embedding_gather", ("index_elementwise", "gather",
                                   "index_select", "indexselect")),
             ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "matmul")),
             ("copy", ("memcpy", "memset")))


def step_breakdown(torch, fn, step_ms, kinds=CTR_KINDS, top=12):
    """One profiled step: device ms by kind (name fragments), the
    optimizer segment's ms (its profiler range), kernel launches, busy
    ms and its idle share of ``step_ms`` (the unprofiled steps' median;
    the profiled step's own wall time, which the profiler inflates, is
    reported beside it), and the ``top`` kernels by device time."""
    table, wall = kernel_table(torch, fn)
    if not table:
        return {"device_busy_ms": "not measured", "profiled_wall_ms": wall}
    by_kind = dict.fromkeys([k for k, _ in kinds] + ["other"], 0.0)
    for name, (ms, _) in table.items():
        low = name.lower()
        kind = next((k for k, frags in kinds
                     if any(f in low for f in frags)), "other")
        by_kind[kind] += ms
    busy = sum(ms for ms, _ in table.values())
    seg = device_ms_by_kind(torch, fn)
    return {"profiled_wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / step_ms,
            "launches": sum(n for _, n in table.values()),
            "device_ms_by_kind": by_kind,
            "optimizer_segment": (seg or {}).get("optimizer_segment"),
            "top_kernels": sorted(([k[:90], ms, n]
                                   for k, (ms, n) in table.items()),
                                  key=lambda r: -r[1])[:top]}


def card_and_cpu(fluid, main, startup, fetch, feed, scope0=None):
    """One run of ``main`` on the card and on the CPU from one initial
    state (the CPU's startup, or ``scope0``), each in a fresh Executor
    (so both take the same step's draws). Returns {side: fetches}."""
    if scope0 is None:
        scope0 = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope0)
    outs = {}
    for side, exe in (("card", fluid.Executor()),
                      ("cpu", fluid.Executor(fluid.CPUPlace()))):
        scope = fluid.Scope()
        for n, v in scope0.vars.items():
            scope.set(n, v.detach().clone())
        outs[side] = [np.asarray(o.data if isinstance(o, fluid.SequenceBatch)
                                 else o)
                      for o in exe.run(main, feed=feed, fetch_list=fetch,
                                       scope=scope)]
    return outs


def first_step_card_vs_cpu(torch, fluid, tag, main, startup, fetch, feed,
                           dtype=None):
    """One step of ``main`` on the card and on the CPU from one initial
    state (the CPU's startup, its floating tensors cast to ``dtype``
    when one is given): the fetched loss and every trainable
    parameter's gradient within SEQ_TOL. Returns the worst error and the
    card's loss."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = sorted(p.name for p in main.all_parameters() if p.trainable)
    names = [fetch] + [p + "@GRAD" for p in params]
    s0 = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=s0)
    if dtype is not None:
        for n, v in list(s0.vars.items()):
            if v.is_floating_point():
                s0.set(n, v.to(dtype))
    outs = card_and_cpu(fluid, main, startup, names, feed, scope0=s0)
    worst = 0.0
    for n, a, b in zip(names, outs["card"], outs["cpu"]):
        ok, err = np_close(a, b, SEQ_TOL)
        check(ok and np.isfinite(np.asarray(a)).all(),
              f"{tag}: {n} card vs CPU max err {err}")
        worst = max(worst, err)
    return worst, float(np.asarray(outs["card"][0]).reshape(()))


def timed_steps(torch, exe, main, fetch, scope, feed, warmup, steps):
    """``warmup`` then ``steps`` train steps on one feed: each step's
    wall ms (ending in a synchronize), the losses (read after the
    window), and the window's peak memory."""
    for _ in range(warmup):
        exe.run(main, feed=feed, fetch_list=[fetch], scope=scope,
                return_numpy=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[fetch], scope=scope,
                      return_numpy=False)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(out[0])
    losses = [float(v.reshape(()).item()) for v in losses]
    return ms, losses, torch.cuda.max_memory_allocated()


def ctr_feed(rng, batch, fields, vocab):
    """ids and tests/test_model_zoo.py TestCTR's planted rule: click iff
    any even id below vocab / 4."""
    ids = rng.randint(0, vocab, size=(batch, fields)).astype(np.int64)
    label = ((ids < vocab // 4) & (ids % 2 == 0)).any(1)
    return ids, label.astype(np.float32).reshape(-1, 1)


def ctr_program(fluid, vocab, wide=False):
    """DeepFM (or wide&deep) at bench.py's width over ``vocab`` ids,
    Adam(1e-3); returns (main, startup, loss, the warnings the build
    raised)."""
    from paddle_tpu_torch.models.ctr import build_deepfm, build_wide_deep
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        feat = fluid.layers.data(name="feat", shape=[-1, CTR_FIELDS],
                                 dtype="int64", append_batch_size=False)
        label = fluid.layers.data(name="label", shape=[-1, 1],
                                  dtype="float32", append_batch_size=False)
        if wide:
            _, loss = build_wide_deep(feat, feat, label, num_features=vocab,
                                      embed_size=CTR_EMBED,
                                      hidden_sizes=CTR_HIDDEN)
        else:
            _, loss = build_deepfm(feat, label, num_features=vocab,
                                   num_fields=CTR_FIELDS,
                                   embed_size=CTR_EMBED,
                                   hidden_sizes=CTR_HIDDEN)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss, [str(w.message) for w in caught]


def phase_deepfm_train(torch, fluid, fa, card):
    """DeepFM at bench.py ``ctr_main``'s knobs in float32 through
    ``Executor()`` (the card): the F13 warning at the million-row table,
    2 warmup and 20 timed steps on one batch of the planted rule (losses
    finite and falling), step ms, examples/s, peak memory and one step's
    device time by kind; wide&deep at the same vocab for 3 steps; and
    the first step at vocab 10,000 on the card equal to the CPU's (loss
    and every gradient, TF32 off). Returns (attention launches,
    stats)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.reset_launch_counts()
    main, startup, loss, caught = ctr_program(fluid, CTR_VOCAB)
    check(any("is_distributed=True" in m for m in caught),
          f"deepfm_train: no F13 warning for the {CTR_VOCAB}-row table "
          f"({caught})")
    exe = fluid.Executor()
    dev = exe.device
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    ids, lbl = ctr_feed(rng, CTR_BATCH, CTR_FIELDS, CTR_VOCAB)
    feed = {"feat": torch.from_numpy(ids).to(dev),
            "label": torch.from_numpy(lbl).to(dev)}
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    ms, losses, peak = timed_steps(torch, exe, main, loss.name, scope, feed,
                                   CTR_WARMUP, CTR_STEPS)
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"deepfm_train: losses not finite and falling: {losses}")
    med = float(np.median(ms))
    stats = {"vocab": CTR_VOCAB, "fields": CTR_FIELDS, "embed": CTR_EMBED,
             "hidden": list(CTR_HIDDEN), "batch": CTR_BATCH,
             "params": n_params, "steps": CTR_STEPS, "step_ms": ms,
             "step_ms_median": med,
             "examples_per_s": CTR_BATCH / (med / 1e3),
             "peak_memory_gb": peak / 1e9,
             "losses": [losses[0], losses[-1]],
             "one_step": step_breakdown(torch, lambda: exe.run(
                 main, feed=feed, fetch_list=[loss.name], scope=scope,
                 return_numpy=False), med)}
    del scope
    # wide&deep at the same vocab and embedding
    wmain, wstart, wloss, _ = ctr_program(fluid, CTR_VOCAB, wide=True)
    wscope = fluid.Scope()
    exe.run(wstart, scope=wscope)
    wl = [float(np.asarray(exe.run(wmain, feed=feed, fetch_list=[wloss],
                                   scope=wscope)[0]).reshape(()))
          for _ in range(CTR_WIDE_STEPS)]
    check(np.isfinite(wl).all(), f"deepfm_train: wide&deep losses {wl}")
    stats["wide_deep_losses"] = wl
    del wscope
    # the first step, card vs CPU, at a vocab the CPU steps fast
    pmain, pstart, ploss, _ = ctr_program(fluid, CTR_PARITY_VOCAB)
    pids, plbl = ctr_feed(np.random.RandomState(SEED + 1), CTR_PARITY_BATCH,
                          CTR_FIELDS, CTR_PARITY_VOCAB)
    stats["parity_max_err"], _ = first_step_card_vs_cpu(
        torch, fluid, "deepfm_train parity", pmain, pstart, ploss.name,
        {"feat": pids, "label": plbl})
    by_kernel = launches_by_kernel(fa)
    check(not any(by_kernel.values()),
          f"deepfm_train: attention launched: {by_kernel}")
    log(f"deepfm_train: {card}, float32, TF32 off: " + json.dumps(stats))
    return by_kernel, stats


def lstm_program(fluid):
    """bench.py seq_main's stacked dynamic LSTM (``stacked_lstm_net`` at
    vocab 10,000, emb 128, hid_dim 512: three LSTMs of hidden 128 with
    peepholes, the middle one reversed), Adam(1e-3)."""
    from paddle_tpu_torch.models.stacked_dynamic_lstm import \
        stacked_lstm_net
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        data = fluid.layers.data(name="src", shape=[1], dtype="int64",
                                 lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss, _, _ = stacked_lstm_net(data, label, LSTM_VOCAB,
                                      emb_dim=LSTM_EMB, hid_dim=LSTM_HID)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def phase_stacked_lstm_train(torch, fluid, fa, card):
    """The stacked dynamic LSTM at bench.py ``seq_main``'s width in
    float32 through ``Executor()``: bench.py's all-64 feed (batch 32)
    for 2 warmup and 10 timed steps — words/s as bench.py counts them
    (batch x seq a step), step ms, launches a step and the device's idle
    share; a variable-length feed (lengths 9-64, bucket 8) through the
    same program for 4 steps (finite, falling); and that feed's first
    step on the card equal to the CPU's (loss and every gradient, TF32
    off). Returns (attention launches, stats)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.reset_launch_counts()
    main, startup, loss = lstm_program(fluid)
    exe = fluid.Executor()
    dev = exe.device
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    sb = fluid.to_sequence_batch(
        [rng.randint(1, LSTM_VOCAB, (LSTM_SEQ, 1)).astype(np.int64)
         for _ in range(LSTM_BATCH)])
    labels = rng.randint(0, 2, (LSTM_BATCH, 1)).astype(np.int64)
    feed = {"src": fluid.SequenceBatch(sb.data.to(dev), sb.lengths.to(dev)),
            "label": torch.from_numpy(labels).to(dev)}
    ms, losses, peak = timed_steps(torch, exe, main, loss.name, scope, feed,
                                   LSTM_WARMUP, LSTM_STEPS)
    check(np.isfinite(losses).all(),
          f"stacked_lstm_train: losses not finite: {losses}")
    med = float(np.median(ms))
    stats = {"vocab": LSTM_VOCAB, "emb": LSTM_EMB, "hid_dim": LSTM_HID,
             "batch": LSTM_BATCH, "seq": LSTM_SEQ, "steps": LSTM_STEPS,
             "step_ms": ms, "step_ms_median": med,
             "words_per_s": LSTM_BATCH * LSTM_SEQ * LSTM_STEPS
             / (sum(ms) / 1e3),
             "peak_memory_gb": peak / 1e9, "losses": [losses[0],
                                                     losses[-1]],
             "one_step": step_breakdown(torch, lambda: exe.run(
                 main, feed=feed, fetch_list=[loss.name], scope=scope,
                 return_numpy=False), med)}
    # lengths 9-64 through the same program (padded 64, bucket 8)
    vrng = np.random.RandomState(SEED + 1)
    vseqs = [vrng.randint(1, LSTM_VOCAB, (int(n), 1)).astype(np.int64)
             for n in vrng.randint(LSTM_VAR_LENS[0], LSTM_VAR_LENS[1] + 1,
                                   LSTM_BATCH)]
    vfeed = {"src": fluid.to_sequence_batch(vseqs),
             "label": vrng.randint(0, 2, (LSTM_BATCH, 1)).astype(np.int64)}
    vl = [float(np.asarray(exe.run(main, feed=vfeed, fetch_list=[loss],
                                   scope=scope)[0]).reshape(()))
          for _ in range(LSTM_VAR_STEPS)]
    check(np.isfinite(vl).all() and vl[-1] < vl[0],
          f"stacked_lstm_train: variable-length losses {vl}")
    stats["variable_lengths"] = {
        "lengths": [int(a.shape[0]) for a in vseqs],
        "padded": int(vfeed["src"].data.shape[1]), "losses": vl}
    del scope
    stats["parity_max_err"], _ = first_step_card_vs_cpu(
        torch, fluid, "stacked_lstm_train parity", main, startup, loss.name,
        vfeed)
    by_kernel = launches_by_kernel(fa)
    check(not any(by_kernel.values()),
          f"stacked_lstm_train: attention launched: {by_kernel}")
    log(f"stacked_lstm_train: {card}, float32, TF32 off: "
        + json.dumps(stats))
    return by_kernel, stats


REC_NAMES = ("uid", "gender", "age", "job", "mid", "cats", "title")


def rec_program(fluid, train):
    """The recommender at its MovieLens table sizes (``DEFAULT_SIZES``):
    the training program with Adam(5e-3), or the inference one (the
    scaled cosine, no rating)."""
    from paddle_tpu_torch.models.recommender import build_recommender
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ins = [fluid.layers.data(name=n, shape=[1], dtype="int64",
                                 lod_level=1 if n in ("cats", "title") else 0)
               for n in REC_NAMES]
        rating = fluid.layers.data(name="rating", shape=[1],
                                   dtype="float32") if train else None
        score, loss = build_recommender(*ins, rating)
        if train:
            fluid.optimizer.Adam(learning_rate=5e-3).minimize(loss)
    return main, startup, (loss if train else score)


def rec_rows(rng, n, title_max=REC_TITLE[1]):
    """``n`` movie-rating rows at MovieLens's id ranges: 1-6 categories
    and 2-``title_max`` title words a movie, a rating of 1-5."""
    from paddle_tpu_torch.models.recommender import DEFAULT_SIZES as sz
    return [(np.array([rng.randint(1, sz["uid"])], np.int64),
             np.array([rng.randint(0, sz["gender"])], np.int64),
             np.array([rng.randint(0, sz["age"])], np.int64),
             np.array([rng.randint(0, sz["job"])], np.int64),
             np.array([rng.randint(1, sz["mid"])], np.int64),
             rng.randint(0, sz["category"],
                         rng.randint(REC_CATS[0], REC_CATS[1] + 1)),
             rng.randint(0, sz["title"],
                         rng.randint(REC_TITLE[0], title_max + 1)),
             np.array([float(rng.randint(1, 6))], np.float32))
            for _ in range(n)]


def phase_seq_zoo(torch, fluid, fa, card):
    """The recommender at MovieLens's table sizes (batch 256, sequence
    feeds built by ``DataFeeder`` and by ``create_lod_tensor``) and
    word2vec (embed 32, hidden 256, 4 context words, dict 2073, batch
    32) in float32: each model's first step on the card equal to the
    CPU's (loss and every gradient, TF32 off) and 3 finite steps; the
    recommender's inference program exported through ``io/aot.py``
    (sequence axes symbolic) and served by ``CompiledPredictor`` at two
    padded title lengths, each within the f32 serving tier of the
    executor's test-mode run. Returns (attention launches, stats)."""
    import shutil
    from paddle_tpu_torch.io import load_compiled_predictor
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.reset_launch_counts()
    stats = {}
    rng = np.random.RandomState(SEED)
    main, startup, loss = rec_program(fluid, train=True)
    names = list(REC_NAMES) + ["rating"]
    feeder = fluid.DataFeeder(names, program=main)
    rows = rec_rows(rng, REC_BATCH)
    feed = feeder.feed(rows)
    check(isinstance(feed["title"], fluid.SequenceBatch)
          and feed["title"].data.shape[1] == 16,
          f"seq_zoo: DataFeeder title {feed['title']}")
    # the same rows' sequences through create_lod_tensor
    lod_feed = dict(feed)
    for col, n in ((5, "cats"), (6, "title")):
        seqs = [r[col] for r in rows]
        lod_feed[n] = fluid.create_lod_tensor(
            np.concatenate(seqs), [[len(s) for s in seqs]])
        check(torch.equal(lod_feed[n].data, feed[n].data)
              and torch.equal(lod_feed[n].lengths, feed[n].lengths),
              f"seq_zoo: create_lod_tensor {n} differs from DataFeeder's")
    err, first = first_step_card_vs_cpu(torch, fluid, "seq_zoo recommender",
                                        main, startup, loss.name, feed)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rl = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                   scope=scope)[0]).reshape(()))
          for f in (feed, lod_feed, feeder.feed(rec_rows(rng, REC_BATCH)))]
    check(np.isfinite(rl).all(), f"seq_zoo: recommender losses {rl}")
    stats["recommender"] = {"batch": REC_BATCH, "parity_max_err": err,
                            "losses": rl}
    # the inference program, exported and served at two padded lengths
    imain, _, score = rec_program(fluid, train=False)
    shutil.rmtree(SEQ_ROOT, ignore_errors=True)
    d = os.path.join(SEQ_ROOT, "recommender")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, list(REC_NAMES), [score], exe,
                                      main_program=imain)
    meta = json.load(open(os.path.join(d, "__compiled_meta__.json")))
    check(not any(s.get("fixed_seq_len") for s in meta["feed_specs"]),
          f"seq_zoo: the recommender exported at fixed lengths: {meta}")
    pred = load_compiled_predictor(d)
    served = {}
    for title_max in (REC_TITLE[1], 7):
        f = fluid.DataFeeder(list(REC_NAMES), program=imain).feed(
            [r[:7] for r in rec_rows(rng, 64, title_max)])
        want = exe.run(imain, feed=f, fetch_list=[score], scope=scope,
                       mode="test")[0]
        got = pred.run(f)[0]
        ok, perr = np_close(got, want, TOL_F32)
        padded = int(f["title"].data.shape[1])
        check(ok, f"seq_zoo: predictor at title length {padded} max err "
                  f"{perr}")
        served[padded] = perr
    check(len(served) == 2, f"seq_zoo: padded lengths served {served}")
    stats["recommender"]["predictor_max_err_by_padded_title"] = served
    shutil.rmtree(SEQ_ROOT, ignore_errors=True)
    del scope
    # word2vec at build_word2vec's default widths
    from paddle_tpu_torch.models.word2vec import build_word2vec
    wmain, wstart = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(wmain, wstart):
        words = [fluid.layers.data(name=f"w{i}", shape=[1], dtype="int64")
                 for i in range(4)]
        nxt = fluid.layers.data(name="next", shape=[1], dtype="int64")
        _, wloss = build_word2vec(words, nxt, W2V_DICT)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(wloss)
    wfeed = {f"w{i}": rng.randint(0, W2V_DICT, (W2V_BATCH, 1))
             for i in range(4)}
    wfeed["next"] = rng.randint(0, W2V_DICT, (W2V_BATCH, 1))
    werr, _ = first_step_card_vs_cpu(torch, fluid, "seq_zoo word2vec",
                                     wmain, wstart, wloss.name, wfeed)
    wscope = fluid.Scope()
    exe.run(wstart, scope=wscope)
    wl = [float(np.asarray(exe.run(wmain, feed=wfeed, fetch_list=[wloss],
                                   scope=wscope)[0]).reshape(()))
          for _ in range(SEQ_ZOO_STEPS)]
    check(np.isfinite(wl).all() and wl[-1] < wl[0],
          f"seq_zoo: word2vec losses {wl}")
    stats["word2vec"] = {"dict": W2V_DICT, "batch": W2V_BATCH,
                         "parity_max_err": werr, "losses": wl}
    by_kernel = launches_by_kernel(fa)
    check(not any(by_kernel.values()),
          f"seq_zoo: attention launched: {by_kernel}")
    log(f"seq_zoo: {card}, float32, TF32 off: " + json.dumps(stats))
    return by_kernel, stats


# ROADMAP item 7b: bench.py seq_main's seq2seq knobs (BENCH_MODEL=seq2seq,
# :779-876): vocab 10,000 on both sides, width 512, batch 32 x 64 words,
# Adam(1e-3), float32; its all-64 feed is src = trg = lbl
MT_VOCAB = 10_000
MT_WIDTH = 512
MT_BATCH, MT_SEQ = 32, 64
MT_WARMUP, MT_STEPS = 2, 10
MT_VAR_LENS, MT_VAR_STEPS = (9, 64), 4
MT_BEAM, MT_BOS, MT_EOS = 4, 0, 1
# db_lstm at its own defaults (the book chapter's widths) over CoNLL-05's
# dictionaries as the book prints them; SGD(0.01)
SRL_DICTS = dict(word_dict_len=44_068, pred_dict_len=3_162,
                 label_dict_len=59)
SRL_BATCH, SRL_LENS, SRL_STEPS = 10, (10, 60), 3
SRL_NAMES = ("word", "predicate", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1",
             "ctx_p2", "mark")
# ctc_train_net at its defaults on 1 x 48 x 512 images, 95 classes
OCR_CLASSES, OCR_SHAPE, OCR_BATCH = 95, (1, 48, 512), 32
OCR_LABEL_LENS, OCR_STEPS = (5, 20), 3
# kernel-name fragments of the recurrent steps' kinds (lower case)
RNN_KINDS = (("matmul", ("gemm", "nvjet", "cutlass", "xmma", "matmul")),
             ("copy", ("memcpy", "memset")),
             ("reduce_softmax", ("reduce", "softmax", "logsumexp")),
             ("index", ("index", "gather", "scatter", "embedding")),
             ("elementwise", ("elementwise", "vectorized", "unrolled")))


def attention_idle(fa, tag):
    """K1-K3's launches since the phase reset them, which must all be
    0: no attention lies on the recurrent paths."""
    by_kernel = launches_by_kernel(fa)
    check(not any(by_kernel.values()),
          f"{tag}: attention launched: {by_kernel}")
    return by_kernel


def mt_programs(fluid):
    """seq_to_seq_net at bench.py's seq2seq width with Adam(1e-3):
    (main, startup, loss)."""
    from paddle_tpu_torch.models.machine_translation import seq_to_seq_net
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src, trg, lbl = (fluid.layers.data(name=n, shape=[1], dtype="int64",
                                           lod_level=1)
                         for n in ("src", "trg", "lbl"))
        loss, _ = seq_to_seq_net(src, trg, lbl, MT_VOCAB, MT_VOCAB,
                                 embedding_dim=MT_WIDTH,
                                 encoder_size=MT_WIDTH,
                                 decoder_size=MT_WIDTH)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def mt_feed(fluid, rng, lens, dev=None):
    """src = trg = lbl, random ids (bench.py's feed) of ``lens``."""
    sb = fluid.to_sequence_batch([rng.randint(1, MT_VOCAB, (int(n), 1))
                                  .astype(np.int64) for n in lens])
    if dev is not None:
        sb = fluid.SequenceBatch(sb.data.to(dev), sb.lengths.to(dev))
    return {"src": sb, "trg": sb, "lbl": sb}


def phase_seq2seq_train(torch, fluid, fa, card):
    """The seq2seq-attention model at bench.py ``seq_main``'s width in
    float32 through ``Executor()``: the first step of the all-64 feed
    on the card equal to the CPU's (loss and every gradient, TF32 off),
    2 warmup and 10 timed steps (words/s as bench.py counts them, step
    ms, launches a step, busy ms, idle share, device ms by kind, peak
    memory), then 4 steps on a feed of lengths 9-64; losses finite and
    falling. Returns (attention launches, stats)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.reset_launch_counts()
    main, startup, loss = mt_programs(fluid)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    cpu_feed = mt_feed(fluid, np.random.RandomState(SEED),
                       [MT_SEQ] * MT_BATCH)
    err, first = first_step_card_vs_cpu(torch, fluid, "seq2seq_train",
                                        main, startup, loss.name, cpu_feed)
    fa.reset_launch_counts()
    exe = fluid.Executor()
    dev = exe.device
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = mt_feed(fluid, np.random.RandomState(SEED), [MT_SEQ] * MT_BATCH,
                   dev)
    ms, losses, peak = timed_steps(torch, exe, main, loss.name, scope, feed,
                                   MT_WARMUP, MT_STEPS)
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"seq2seq_train: losses not finite and falling: {losses}")
    med = float(np.median(ms))
    stats = {"vocab": MT_VOCAB, "width": MT_WIDTH, "batch": MT_BATCH,
             "seq": MT_SEQ, "params": n_params, "parity_max_err": err,
             "first_loss": first, "steps": MT_STEPS, "step_ms": ms,
             "step_ms_median": med,
             "words_per_s": MT_BATCH * MT_SEQ * MT_STEPS / (sum(ms) / 1e3),
             "peak_memory_gb": peak / 1e9,
             "losses": [losses[0], losses[-1]],
             "one_step": step_breakdown(torch, lambda: exe.run(
                 main, feed=feed, fetch_list=[loss.name], scope=scope,
                 return_numpy=False), med, kinds=RNN_KINDS)}
    vrng = np.random.RandomState(SEED + 1)
    lens = vrng.randint(MT_VAR_LENS[0], MT_VAR_LENS[1] + 1, MT_BATCH)
    vfeed = mt_feed(fluid, vrng, lens)
    vl = [float(np.asarray(exe.run(main, feed=vfeed, fetch_list=[loss],
                                   scope=scope)[0]).reshape(()))
          for _ in range(MT_VAR_STEPS)]
    check(np.isfinite(vl).all() and vl[-1] < vl[0],
          f"seq2seq_train: variable-length losses {vl}")
    stats["variable_lengths"] = {
        "lengths": [int(n) for n in lens],
        "padded": int(vfeed["src"].data.shape[1]), "losses": vl}
    by_kernel = attention_idle(fa, "seq2seq_train")
    log(f"seq2seq_train: {card}, float32, TF32 off: " + json.dumps(stats))
    return by_kernel, stats


def mt_decoders(fluid):
    """The inference programs at the training width, each with its own
    startup: ``greedy_decode`` for MT_SEQ steps; contrib's
    ``BeamSearchDecoder`` (beam MT_BEAM, a GRU StateCell over the
    previous word's embedding, booted from the encoder's last state);
    and the greedy decoder's teacher-forced probe (its step body with
    the fed history in place of the fed-back argmax and the logits as
    step outputs, built in the same order, so its parameters are
    greedy_decode's by name). Returns ((main, startup, tokens), (main,
    startup, ids, scores, the beam's per-step scores), (probe,
    logits))."""
    from paddle_tpu_torch.contrib.decoder import (BeamSearchDecoder,
                                                  InitState, StateCell)
    from paddle_tpu_torch.models import machine_translation as mt
    layers = fluid.layers

    def fresh():
        return fluid.Program(), fluid.Program()

    def src_var():
        return layers.data(name="src", shape=[1], dtype="int64",
                           lod_level=1)

    greedy, g_start = fresh()
    with fluid.unique_name.guard(), fluid.program_guard(greedy, g_start):
        tokens = mt.greedy_decode(src_var(), MT_VOCAB, MT_VOCAB, MT_SEQ,
                                  embedding_dim=MT_WIDTH,
                                  encoder_size=MT_WIDTH,
                                  decoder_size=MT_WIDTH, bos_id=MT_BOS)
    beam, b_start = fresh()
    with fluid.unique_name.guard(), fluid.program_guard(beam, b_start):
        boot = layers.fc(layers.sequence_last_step(
            mt._encoder(src_var(), MT_VOCAB, MT_WIDTH, MT_WIDTH)),
            size=MT_WIDTH, act="tanh", bias_attr=False)
        cell = StateCell(inputs={"x": None}, states={"h": InitState(
            init=boot)}, out_state="h")

        @cell.state_updater
        def _update(c):
            h, _, _ = layers.gru_unit(
                input=layers.fc(c.get_input("x"), size=3 * MT_WIDTH,
                                bias_attr=False),
                hidden=c.get_state("h"), size=3 * MT_WIDTH)
            c.set_state("h", h)

        init_ids = layers.fill_constant_batch_size_like(
            input=boot, shape=[-1, 1], dtype="int64", value=MT_BOS)
        init_scores = layers.fill_constant_batch_size_like(
            input=boot, shape=[-1, 1], dtype="float32", value=0.0)
        dec = BeamSearchDecoder(cell, init_ids, init_scores,
                                target_dict_dim=MT_VOCAB, word_dim=MT_WIDTH,
                                max_len=MT_SEQ, beam_size=MT_BEAM,
                                end_id=MT_EOS, name="mt_beam")
        ids, scores = dec.decode()
        step_scores = [op for op in beam.global_block().ops
                       if op.type == "scan"][-1].output("Out")[2]
    probe, _ = fresh()
    with fluid.unique_name.guard(), fluid.program_guard(probe, _):
        src = src_var()
        hist = layers.data(name="hist", shape=[-1, MT_SEQ, 1],
                           dtype="int64", append_batch_size=False)
        encoded = mt._encoder(src, MT_VOCAB, MT_WIDTH, MT_WIDTH)
        proj = layers.fc(input=encoded, size=MT_WIDTH, bias_attr=False)
        proj.lod_level = 1
        mem0 = layers.fc(input=layers.sequence_last_step(input=encoded),
                         size=MT_WIDTH, act="tanh", bias_attr=False)
        rnn = layers.StaticRNN(masked=False)
        with rnn.step():
            word = rnn.step_input(hist)
            mem = rnn.memory(init=mem0)
            emb = layers.embedding(input=word, size=[MT_VOCAB, MT_WIDTH],
                                   param_attr="decode_emb")
            context = mt._attention(mem, encoded, proj)
            h, _, _ = layers.gru_unit(
                input=layers.fc(input=layers.concat([context, emb], axis=1),
                                size=MT_WIDTH * 3, bias_attr=False),
                hidden=mem, size=MT_WIDTH * 3)
            rnn.update_memory(mem, h)
            rnn.step_output(layers.fc(input=h, size=MT_VOCAB))
        logits = rnn()
    check({p.name for p in probe.all_parameters()}
          == {p.name for p in greedy.all_parameters()},
          "seq2seq_decode: the probe's parameters are not greedy_decode's")
    return ((greedy, g_start, tokens),
            (beam, b_start, ids, scores, step_scores), (probe, logits))


def greedy_flips(tag, got, want, cpu_logits, row_err):
    """``got`` (the card's greedy tokens [B, T]) against ``want`` (the
    CPU's): each row equal, or equal up to a first difference at step j
    where the CPU's logits put want[j] at most twice the row's logit
    error (card vs CPU, on the same history) above got[j]; past a flip
    the rows go their own ways. Returns (rows equal, the rows' steps
    before a flip)."""
    equal, agreed = 0, []
    for r in range(want.shape[0]):
        diff = np.nonzero(got[r] != want[r])[0]
        if not len(diff):
            equal += 1
            agreed.append(int(want.shape[1]))
            continue
        j = int(diff[0])
        row = cpu_logits[r, j]
        margin = float(row[want[r, j]] - row[got[r, j]])
        check(margin <= 2 * row_err[r],
              f"{tag}: row {r} step {j}: the card chose {got[r, j]}, the "
              f"CPU {want[r, j]} by a margin {margin:.3e} > 2 x the row's "
              f"logit error {row_err[r]:.3e}")
        agreed.append(j)
    return equal, agreed


def beam_flips(tag, got, want):
    """The card's beam search (ids [B, W, T], per-step selected scores
    [B, T, W]) against the CPU's: per row, the ids equal, or equal up to
    a first step whose selected scores agree with the CPU's within the
    float32 card tier (SEQ_TOL) — the card chose among candidates that
    tie within rounding. Returns the rows whose ids are equal."""
    gid, gsc = got
    wid, wsc = want
    equal = []
    for r in range(wid.shape[0]):
        diff = np.nonzero((gid[r] != wid[r]).any(axis=0))[0]
        if not len(diff):
            equal.append(r)
            continue
        j = int(diff[0])
        ok, err = np_close(np.sort(gsc[r, j]), np.sort(wsc[r, j]), SEQ_TOL)
        check(ok, f"{tag}: row {r} step {j}: the beams differ and their "
                  f"scores differ by {err:.3e}, past the card tier")
    return equal


def phase_seq2seq_decode(torch, fluid, fa, card):
    """``greedy_decode`` (MT_SEQ steps) and contrib's ``BeamSearchDecoder``
    (beam MT_BEAM) at the seq2seq width, float32 and TF32 off, on random
    weights from SEED over 32 sources of 64 words: each against the
    CPU's from the same weights by the flip rule (greedy_flips, whose
    logits come from the greedy decoder's teacher-forced probe;
    beam_flips, and the best beam's score on every row whose ids are
    equal within the card tier); ms per decoded step and launches per
    step of each. Returns (attention launches, stats)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.reset_launch_counts()
    (greedy, g_start, tokens), (beam, b_start, ids, scores, step_scores), \
        (probe, logits) = mt_decoders(fluid)
    rng = np.random.RandomState(SEED + 2)
    src = mt_feed(fluid, rng, [MT_SEQ] * MT_BATCH)["src"]
    exes = {"cpu": fluid.Executor(fluid.CPUPlace()), "card": fluid.Executor()}
    scopes = {"cpu": {}, "card": {}}
    outs = {"cpu": {}, "card": {}}
    for name, main, start, fetch in (
            ("greedy", greedy, g_start, [tokens.name]),
            ("beam", beam, b_start, [ids.name, scores.name, step_scores])):
        s0 = fluid.Scope()
        exes["cpu"].run(start, scope=s0)
        for side, exe in exes.items():
            scope = fluid.Scope()
            for n, v in s0.vars.items():
                scope.set(n, v.clone())
            outs[side][name] = [np.asarray(v) for v in exe.run(
                main, feed={"src": src}, fetch_list=fetch, scope=scope,
                mode="test")]
            scopes[side][name] = scope
    gw = outs["cpu"]["greedy"][0][..., 0]
    gg = outs["card"]["greedy"][0][..., 0]
    # the probe on the CPU's own history: its argmax is the CPU's tokens,
    # and the card's probe of the same history gives each row's error
    hist = np.concatenate([np.full((MT_BATCH, 1), MT_BOS, np.int64),
                           gw[:, :-1]], axis=1)[..., None]
    pl = {side: np.asarray(exes[side].run(
        probe, feed={"src": src, "hist": hist}, fetch_list=[logits.name],
        scope=scopes[side]["greedy"], mode="test")[0]) for side in exes}
    check(np.array_equal(pl["cpu"].argmax(-1), gw),
          "seq2seq_decode: the probe's argmax is not greedy_decode's tokens "
          "on the CPU")
    row_err = np.abs(pl["card"] - pl["cpu"]).reshape(MT_BATCH, -1).max(1)
    g_equal, agreed = greedy_flips("seq2seq_decode greedy", gg, gw,
                                   pl["cpu"], row_err)
    bg, bw = outs["card"]["beam"], outs["cpu"]["beam"]
    b_equal = beam_flips("seq2seq_decode beam", (bg[0], bg[2]),
                         (bw[0], bw[2]))
    ok, serr = np_close(bg[1][b_equal, 0], bw[1][b_equal, 0], SEQ_TOL)
    check(ok, f"seq2seq_decode: best beam scores of the equal rows differ "
              f"by {serr:.3e}")
    stats = {"batch": MT_BATCH, "src_len": MT_SEQ, "steps": MT_SEQ,
             "beam": MT_BEAM, "greedy_rows_equal": g_equal,
             "greedy_steps_before_flip": agreed,
             "greedy_logit_err_max": float(row_err.max()),
             "beam_rows_equal": len(b_equal),
             "beam_best_score_err": serr}
    dev = exes["card"].device
    feed = {"src": fluid.SequenceBatch(src.data.to(dev),
                                       src.lengths.to(dev))}
    for name, main, fetch_name in (("greedy", greedy, tokens.name),
                                   ("beam", beam, ids.name)):
        def run():
            return exes["card"].run(main, feed=feed, fetch_list=[fetch_name],
                                    scope=scopes["card"][name], mode="test",
                                    return_numpy=False)
        ms = wall_ms(torch, run)
        table, _ = kernel_table(torch, run)
        stats[name] = {"ms": ms, "ms_per_step": ms / MT_SEQ,
                       "launches_per_step": (sum(n for _, n in
                                                 table.values()) / MT_SEQ
                                             if table else "not measured")}
    by_kernel = attention_idle(fa, "seq2seq_decode")
    log(f"seq2seq_decode: {card}, float32, TF32 off: " + json.dumps(stats))
    return by_kernel, stats


def srl_program(fluid):
    """db_lstm at its defaults over SRL_DICTS, linear_chain_crf's cost
    with SGD(0.01), crf_decoding and chunk_eval (IOB) over the decode:
    (main, startup, loss, decoded, feature_out, chunk counts)."""
    import math as _m
    from paddle_tpu_torch.models.label_semantic_roles import db_lstm
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ins = [layers.data(name=n, shape=[1], dtype="int64", lod_level=1)
               for n in SRL_NAMES]
        target = layers.data(name="target", shape=[1], dtype="int64",
                             lod_level=1)
        feature = db_lstm(*ins, **SRL_DICTS)
        loss = layers.mean(layers.linear_chain_crf(
            input=feature, label=target,
            param_attr=fluid.ParamAttr(name="crfw")))
        decoded = layers.crf_decoding(
            input=feature, param_attr=fluid.ParamAttr(name="crfw"))
        counts = layers.chunk_eval(
            decoded, target, chunk_scheme="IOB",
            num_chunk_types=int(_m.ceil((SRL_DICTS["label_dict_len"] - 1)
                                        / 2.0)))
        fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return main, startup, loss, decoded, feature, counts[3:]


def srl_feed(fluid, rng):
    lens = rng.randint(SRL_LENS[0], SRL_LENS[1] + 1, SRL_BATCH)
    hi = {"predicate": SRL_DICTS["pred_dict_len"], "mark": 2,
          "target": SRL_DICTS["label_dict_len"]}
    return {n: fluid.to_sequence_batch(
        [rng.randint(0, hi.get(n, SRL_DICTS["word_dict_len"]), (int(k), 1))
         .astype(np.int64) for k in lens])
        for n in SRL_NAMES + ("target",)}


def viterbi_score(emission, trans, path):
    """The CRF score of ``path`` over one row's [T, K] emissions."""
    s = trans[0, path[0]] + trans[1, path[-1]] + emission[
        np.arange(len(path)), path].sum()
    return s + trans[2:][path[:-1], path[1:]].sum()


def phase_srl_crf_train(torch, fluid, fa, card):
    """db_lstm + the CRF at the book chapter's widths over CoNLL-05's
    dictionaries, batch 10 of lengths 10-60, float32 and TF32 off: the
    first SGD step on the card equal to the CPU's (loss and every
    gradient), SRL_STEPS steps finite, and from the same trained scope
    the Viterbi tags on the card equal to the CPU's (a row may differ
    only where the CPU scores the card's path within the card tier of
    its best) with chunk_eval's counts over them. Returns (attention
    launches, stats)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.reset_launch_counts()
    main, startup, loss, decoded, feature, counts = srl_program(fluid)
    rng = np.random.RandomState(SEED + 3)
    feed = srl_feed(fluid, rng)
    err, first = first_step_card_vs_cpu(torch, fluid, "srl_crf_train", main,
                                        startup, loss.name, feed)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    ms, losses = [], []
    for _ in range(SRL_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(out[0]).reshape(())))
    check(np.isfinite(losses).all(), f"srl_crf_train: losses {losses}")
    # the trained scope's decode, card and CPU
    fetch = [decoded.name, feature.name] + [c.name for c in counts]
    cpu_scope = fluid.Scope()
    for n, v in scope.vars.items():
        cpu_scope.set(n, v.detach().cpu().clone())
    test_feed = srl_feed(fluid, rng)
    got = exe.run(main, feed=test_feed, fetch_list=fetch, scope=scope,
                  mode="test")
    want = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=test_feed, fetch_list=fetch, scope=cpu_scope, mode="test")
    trans = np.asarray(cpu_scope.find_var("crfw"))
    lens = np.asarray(want[0].lengths)
    gt, wt = np.asarray(got[0].data), np.asarray(want[0].data)
    emis = np.asarray(want[1].data)
    equal = 0
    for r, n in enumerate(lens):
        if np.array_equal(gt[r, :n], wt[r, :n]):
            equal += 1
            continue
        best = viterbi_score(emis[r, :n], trans, wt[r, :n])
        mine = viterbi_score(emis[r, :n], trans, gt[r, :n])
        check(best - mine <= SEQ_TOL[1] + SEQ_TOL[0] * abs(best),
              f"srl_crf_train: row {r}: the card's Viterbi path scores "
              f"{mine:.6f} against the CPU's best {best:.6f}")
    if equal == len(lens):
        check([int(np.asarray(c)) for c in got[2:]]
              == [int(np.asarray(c)) for c in want[2:]],
              f"srl_crf_train: chunk_eval counts {got[2:]} vs {want[2:]}")
    stats = {"dicts": SRL_DICTS, "batch": SRL_BATCH,
             "lengths": [int(n) for n in lens],
             "parity_max_err": err, "first_loss": first,
             "step_ms": ms, "losses": losses, "viterbi_rows_equal": equal,
             "chunk_counts": [int(np.asarray(c)) for c in got[2:]]}
    by_kernel = attention_idle(fa, "srl_crf_train")
    log(f"srl_crf_train: {card}, float32, TF32 off: " + json.dumps(stats))
    return by_kernel, stats


def ocr_program(fluid, dtype="float32"):
    """ctc_train_net at its defaults (rnn_hidden 64, conv_filters
    (16, 32)) over OCR_CLASSES classes in ``dtype``, Adam(1e-3): (main,
    startup, loss, decoded, per-column scores)."""
    from paddle_tpu_torch.models.ocr_recognition import ctc_train_net
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        images = fluid.layers.data(name="images", shape=list(OCR_SHAPE),
                                   dtype=dtype)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64",
                                  lod_level=1)
        loss, decoded = ctc_train_net(images, label, OCR_CLASSES)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    scores = [op for op in main.global_block().ops
              if op.type == "warpctc"][0].input("Logits")[0]
    return main, startup, loss, decoded, scores


def phase_ocr_ctc_train(torch, fluid, fa, card):
    """CRNN-CTC on 1 x 48 x 512 images (batch 32, 95 classes, labels of
    5-20 tokens), TF32 off: the first step on the card equal to the
    CPU's (loss and every gradient) in float64 — in float32 the batch
    norms' scale gradients, sums over 32 x 48 x 512 terms that cancel,
    sit up to 6.8e-4 apart in two correct orders (the conv-net gotcha;
    resnet_parity holds ResNet the same way) — and its loss in float32;
    OCR_STEPS finite float32 steps, and the greedy CTC tokens on the
    card equal to the CPU's from the same scope (a frame's argmax may
    differ only within twice the row's score error, card vs CPU).
    Returns (attention launches, stats)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.reset_launch_counts()
    rng = np.random.RandomState(SEED + 4)
    images = rng.randn(OCR_BATCH, *OCR_SHAPE)
    label = fluid.to_sequence_batch(
        [rng.randint(0, OCR_CLASSES, (int(n), 1)).astype(np.int64)
         for n in rng.randint(OCR_LABEL_LENS[0], OCR_LABEL_LENS[1] + 1,
                              OCR_BATCH)])
    pmain, pstart, ploss, _, _ = ocr_program(fluid, "float64")
    err, first64 = first_step_card_vs_cpu(
        torch, fluid, "ocr_ctc_train float64", pmain, pstart, ploss.name,
        {"images": images, "label": label}, dtype=torch.float64)
    main, startup, loss, decoded, scores = ocr_program(fluid)
    feed = {"images": images.astype(np.float32), "label": label}
    s0 = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=s0)
    firsts = []
    for exe_ in (fluid.Executor(), fluid.Executor(fluid.CPUPlace())):
        sc = fluid.Scope()
        for n, v in s0.vars.items():
            sc.set(n, v.clone())
        firsts.append(np.asarray(exe_.run(main, feed=feed, fetch_list=[loss],
                                          scope=sc)[0]))
    ok, lerr = np_close(firsts[0], firsts[1], SEQ_TOL)
    check(ok, f"ocr_ctc_train: the float32 first loss card vs CPU {lerr}")
    first = float(firsts[0].reshape(()))
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    ms, losses = [], []
    for _ in range(OCR_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(out[0]).reshape(())))
    check(np.isfinite(losses).all(), f"ocr_ctc_train: losses {losses}")
    cpu_scope = fluid.Scope()
    for n, v in scope.vars.items():
        cpu_scope.set(n, v.detach().cpu().clone())
    fetch = [decoded.name, scores]
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                  mode="test")
    want = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=cpu_scope, mode="test")
    gs, ws = np.asarray(got[1].data), np.asarray(want[1].data)
    row_err = np.abs(gs - ws).reshape(OCR_BATCH, -1).max(1)
    ga, wa = gs.argmax(-1), ws.argmax(-1)
    flipped = set()
    for r, t in zip(*np.nonzero(ga != wa)):
        margin = float(ws[r, t, wa[r, t]] - ws[r, t, ga[r, t]])
        check(margin <= 2 * row_err[r],
              f"ocr_ctc_train: row {r} frame {t}: argmax {ga[r, t]} on the "
              f"card, {wa[r, t]} on the CPU, margin {margin:.3e}")
        flipped.add(int(r))
    gd, wd = got[0], want[0]
    for r in range(OCR_BATCH):
        if r in flipped:
            continue
        n = int(np.asarray(wd.lengths)[r])
        check(int(np.asarray(gd.lengths)[r]) == n and np.array_equal(
            np.asarray(gd.data)[r, :n], np.asarray(wd.data)[r, :n]),
            f"ocr_ctc_train: row {r}'s greedy CTC tokens differ")
    stats = {"classes": OCR_CLASSES, "image": list(OCR_SHAPE),
             "batch": OCR_BATCH, "frames": int(ws.shape[1]),
             "parity_max_err_float64": err, "first_loss_float64": first64,
             "first_loss_err_float32": lerr, "first_loss": first,
             "step_ms": ms,
             "losses": losses, "score_err_max": float(row_err.max()),
             "rows_with_flipped_frames": sorted(flipped),
             "decoded_lengths": [int(n) for n in
                                 np.asarray(gd.lengths)]}
    by_kernel = attention_idle(fa, "ocr_ctc_train")
    log(f"ocr_ctc_train: {card}, float32, TF32 off: " + json.dumps(stats))
    return by_kernel, stats


def cf_programs(fluid):
    """Small control-flow programs, each (name, main, startup, feed,
    fetch names): a bounded and an unbounded While, an unbounded While
    whose trip count is the fed ``lim``, an IfElse, a Switch, the tensor
    arrays, the bounded While's gradient."""
    layers = fluid.layers
    out = []

    def build(name, fn, feed, grads=False):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fetch = fn()
            if grads:
                params = [p.name for p in main.all_parameters()]
                fluid.append_backward(fetch[0], parameter_list=params)
                fetch = fetch + [p + "@GRAD" for p in params]
        out.append((name, main, startup, feed,
                    [v if isinstance(v, str) else v.name for v in fetch]))

    def loop(max_iters, grads=False, fed_limit=False):
        def fn():
            w = layers.create_parameter(
                [64], "float32", attr=fluid.ParamAttr(name="cf_w"),
                default_initializer=fluid.initializer.Normal(0.0, 1.0))
            x = layers.data("x", shape=[-1, 64], append_batch_size=False)
            i = layers.fill_constant([1], "float32", 0.0)
            acc = layers.scale(x, scale=1.0)
            acc.stop_gradient = False
            limit = (layers.data("lim", shape=[1], append_batch_size=False)
                     if fed_limit
                     else layers.fill_constant([1], "float32", 6.0))
            cond = layers.less_than(i, limit)
            loop_ = layers.While(cond, max_iters=max_iters)
            with loop_.block():
                layers.assign(layers.elementwise_add(
                    i, layers.fill_constant([1], "float32", 1.0)), output=i)
                layers.assign(layers.tanh(layers.elementwise_add(
                    layers.elementwise_mul(acc, w), x)), output=acc)
                layers.less_than(i, limit, cond=cond)
            return [layers.reduce_sum(acc), i]
        return fn

    x = np.random.RandomState(SEED + 5).randn(256, 64).astype(np.float32)
    build("while_bounded", loop(10), {"x": x})
    build("while_unbounded", loop(None), {"x": x})
    build("while_fed_limit", loop(None, fed_limit=True),
          {"x": x, "lim": np.asarray([6.0], np.float32)})
    build("while_bounded_grad", loop(10), {"x": x}, grads=True)

    def ifelse():
        x_ = layers.data("x", shape=[-1, 64], append_batch_size=False)
        total = layers.reduce_sum(x_)
        ie = layers.IfElse(layers.greater_than(
            total, layers.fill_constant([1], "float32", 0.0)))
        with ie.true_block():
            ie.output(layers.tanh(x_))
        with ie.false_block():
            ie.output(layers.sigmoid(x_))
        return [ie()[0]]
    build("ifelse", ifelse, {"x": x})

    def switch():
        x_ = layers.data("x", shape=[-1, 64], append_batch_size=False)
        m = layers.reduce_mean(x_)
        out_ = layers.fill_constant([1], "float32", 0.0)
        with layers.Switch().block() as sw:
            with sw.case(layers.less_than(
                    m, layers.fill_constant([1], "float32", -1.0))):
                layers.assign(layers.fill_constant([1], "float32", 1.0),
                              output=out_)
            with sw.case(layers.less_than(
                    m, layers.fill_constant([1], "float32", 1.0))):
                layers.assign(layers.reduce_max(x_), output=out_)
            with sw.default():
                layers.assign(layers.fill_constant([1], "float32", 3.0),
                              output=out_)
        return [out_]
    build("switch", switch, {"x": x})

    def arrays():
        x_ = layers.data("x", shape=[-1, 64], append_batch_size=False)
        i0 = layers.fill_constant([1], "int64", 0)
        i1 = layers.fill_constant([1], "int64", 1)
        arr = layers.array_write(x_, i0)
        layers.array_write(layers.scale(x_, scale=2.0), i1, array=arr)
        return [layers.array_read(arr, i1), layers.array_length(arr)]
    build("arrays", arrays, {"x": x})
    return out


def phase_control_flow(torch, fluid, fa, card):
    """Each of cf_programs on the card against the CPU from one startup
    (float32, TF32 off): a bounded and two unbounded Whiles, IfElse,
    Switch, the tensor arrays, the bounded While's gradient, within the
    card tier (integers exactly). Returns (attention launches, stats)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.reset_launch_counts()
    stats = {}
    for name, main, startup, feed, fetch in cf_programs(fluid):
        s0 = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=s0)
        outs = {}
        for side, exe in (("card", fluid.Executor()),
                          ("cpu", fluid.Executor(fluid.CPUPlace()))):
            scope = fluid.Scope()
            for n, v in s0.vars.items():
                scope.set(n, v.clone())
            outs[side] = exe.run(main, feed=feed, fetch_list=fetch,
                                 scope=scope)
        worst = 0.0
        for n, a, b in zip(fetch, outs["card"], outs["cpu"]):
            ok, e = np_close(a, b, SEQ_TOL)
            check(ok, f"control_flow {name}: {n} card vs CPU max err {e}")
            worst = max(worst, e)
        stats[name] = worst
    by_kernel = attention_idle(fa, "control_flow")
    log(f"control_flow: {card}, float32, TF32 off, max err by program: "
        + json.dumps(stats))
    return by_kernel, stats


# F14 closed: one exported artifact of each recurrent and control-flow
# program, served at every padded length; float32, TF32 off
AOT_TOL = (2e-4, 2e-5)          # the sequence tests' FWD tier
AOT_LSTM_GEOMS = (("b32 t16", 32, 16), ("b32 t64", 32, LSTM_SEQ),
                  ("b32 t128", 32, 128), ("b1 t37", 1, 37),
                  ("b32 var", 32, None))  # None: LSTM_VAR_LENS lengths
AOT_MT_GEOMS = ((16, 16), (MT_SEQ, MT_SEQ), (MT_SEQ, 24))
AOT_WHILE_LIMITS = (2.0, 6.0, 11.0)    # the fed While's trip counts
AOT_REPS = 5
AOT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "paddle_tpu_torch", "_build", "chip_smoke_aot")


def aot_export(fluid, main, startup, feeds, fetch, tag):
    """``main``'s startup on the card, then ``save_inference_model`` of
    its slice from ``feeds`` to ``fetch`` (variables) with no declared
    length, and ``load_compiled_predictor`` of it on the card. Returns
    (Executor, scope, the pruned program, the predictor, export wall s,
    the artifact's bytes); an export that fails warns "AOT export
    skipped", which main() makes an error."""
    import shutil
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    d = os.path.join(AOT_ROOT, tag)
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, feeds, fetch, exe,
                                      main_program=main)
    export_s = time.perf_counter() - t0
    art = os.path.join(d, "__compiled__.pt2")
    check(os.path.exists(art), f"aot_recurrent {tag}: no artifact")
    with open(os.path.join(d, "__compiled_meta__.json")) as f:
        specs = json.load(f)["feed_specs"]
    check(not any("fixed_seq_len" in sp for sp in specs),
          f"aot_recurrent {tag}: a padded length was fixed: {specs}")
    infer = main.prune(list(feeds), [v.name for v in fetch])
    pred = fluid.io.load_compiled_predictor(d)
    return exe, scope, infer, pred, export_s, os.path.getsize(art)


def aot_serve(torch, tag, exe, scope, infer, pred, feed, tol):
    """One geometry through the predictor and the eager Executor on the
    card: the worst error of the predictor's fetches against the
    Executor's (a fetched sequence by its padded data), which must be
    within ``tol`` (exactly for None), and each side's ms (host clock
    around a synchronized call, median of AOT_REPS after a warmup)."""
    names = pred.fetch_names

    def eager():
        return exe.run(infer, feed=feed, fetch_list=names, scope=scope,
                       mode="test", return_numpy=False)

    def served():
        return pred.run(feed, return_numpy=False)

    ms = {}
    for side, fn in (("predictor", served), ("executor", eager)):
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(AOT_REPS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        ms[side] = float(np.median(runs))
    worst = 0.0
    for n, g, w in zip(names, served(), eager()):
        g = g.detach().cpu().numpy()
        w = getattr(w, "data", w).detach().cpu().numpy()
        if tol is None:
            check(g.shape == w.shape and np.array_equal(g, w),
                  f"aot_recurrent {tag}: {n} not equal to the Executor's")
            e = float(np.abs(g.astype(np.float64) - w).max()) if g.size \
                else 0.0
        else:
            ok, e = np_close(g, w, tol)
            check(ok and np.isfinite(g).all(),
                  f"aot_recurrent {tag}: {n} max err {e} against the "
                  "Executor's")
        worst = max(worst, e)
    return worst, ms


def aot_launches(torch, exe, scope, infer, pred, feed):
    """Kernel launches of one predictor run and one Executor run (the
    profiler's count; None where it sees no device time)."""
    out = {}
    for side, fn in (
            ("predictor", lambda: pred.run(feed, return_numpy=False)),
            ("executor", lambda: exe.run(
                infer, feed=feed, fetch_list=pred.fetch_names, scope=scope,
                mode="test", return_numpy=False))):
        table, _ = kernel_table(torch, fn)
        out[side] = sum(n for _, n in table.values()) if table else None
    return out


def seq_on(fluid, dev, rows):
    """``rows`` padded to the longest on the card."""
    sb = fluid.to_sequence_batch(rows, bucket=1)
    return fluid.SequenceBatch(sb.data.to(dev), sb.lengths.to(dev))


def phase_aot_recurrent(torch, fluid, fa, card):
    """F14 closed on the card: the stacked dynamic LSTM at bench.py
    ``seq_main``'s width and the seq2seq-attention model at its width,
    each pruned to its prediction and saved with ``save_inference_model``
    declaring no padded length, then served through one
    ``load_compiled_predictor`` artifact at every geometry of
    AOT_LSTM_GEOMS / AOT_MT_GEOMS within the FWD tier of the eager
    Executor; cf_programs' unbounded While (its trip count fed) and
    IfElse exported and served at feeds that take different trip counts
    and each branch, equal to the Executor; srl_crf_train's tagger
    (linear_chain_crf's cost, chunk_eval's counts) and ocr_ctc_train's
    CRNN (warpctc's cost), exported with no declared length and served
    at two batch x padded-length geometries each within AOT_TOL of the
    Executor. Logs export s, artifact bytes, the predictor's and the
    Executor's ms at each geometry, launches a run, the worst error per
    case; K1-K3 launch 0. Returns (attention launches, stats)."""
    from paddle_tpu_torch.models.machine_translation import seq_to_seq_net
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.reset_launch_counts()
    t_phase = time.perf_counter()
    stats = {"torch": torch.__version__, "card": card}

    def record(tag, export_s, size, rows):
        stats[tag] = {"export_s": export_s, "artifact_bytes": size,
                      "geometries": rows}

    # (a) the stacked dynamic LSTM, prediction only
    main, startup, _ = lstm_program(fluid)
    pred_var = main.global_block().var(next(
        op.output("Out")[0] for op in reversed(main.global_block().ops)
        if op.type == "softmax"))
    exe, scope, infer, pred, export_s, size = aot_export(
        fluid, main, startup, ["src"], [pred_var], "stacked_lstm")
    dev = exe.device
    rng = np.random.RandomState(SEED + 22)
    rows = {}
    for label, batch, t in AOT_LSTM_GEOMS:
        lens = ([t] * batch if t is not None else
                rng.randint(LSTM_VAR_LENS[0], LSTM_VAR_LENS[1] + 1, batch))
        feed = {"src": seq_on(fluid, dev, [
            rng.randint(1, LSTM_VOCAB, (int(n), 1)).astype(np.int64)
            for n in lens])}
        err, ms = aot_serve(torch, f"stacked_lstm {label}", exe, scope,
                            infer, pred, feed, AOT_TOL)
        rows[label] = {"padded": int(feed["src"].data.shape[1]),
                       "max_err": err, "ms": ms}
        if t == LSTM_SEQ:
            rows[label]["launches"] = aot_launches(torch, exe, scope, infer,
                                                   pred, feed)
    record("stacked_lstm", export_s, size, rows)
    del exe, scope, infer, pred

    # (b) seq2seq with attention, teacher-forced prediction
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src, trg, lbl = (fluid.layers.data(name=n, shape=[1], dtype="int64",
                                           lod_level=1)
                         for n in ("src", "trg", "lbl"))
        _, prediction = seq_to_seq_net(src, trg, lbl, MT_VOCAB, MT_VOCAB,
                                       embedding_dim=MT_WIDTH,
                                       encoder_size=MT_WIDTH,
                                       decoder_size=MT_WIDTH)
    exe, scope, infer, pred, export_s, size = aot_export(
        fluid, main, startup, ["src", "trg"], [prediction], "seq2seq")
    rows = {}
    for ts, tt in AOT_MT_GEOMS:
        feed = {n: seq_on(fluid, dev, [
            rng.randint(1, MT_VOCAB, (int(k), 1)).astype(np.int64)
            for k in [t] + list(rng.randint(1, t + 1, MT_BATCH - 1))])
            for n, t in (("src", ts), ("trg", tt))}
        label = f"b{MT_BATCH} src{ts} trg{tt}"
        err, ms = aot_serve(torch, f"seq2seq {label}", exe, scope, infer,
                            pred, feed, AOT_TOL)
        rows[label] = {"padded": [int(feed["src"].data.shape[1]),
                                  int(feed["trg"].data.shape[1])],
                       "max_err": err, "ms": ms}
        if (ts, tt) == (MT_SEQ, MT_SEQ):
            rows[label]["launches"] = aot_launches(torch, exe, scope, infer,
                                                   pred, feed)
    record("seq2seq", export_s, size, rows)
    del exe, scope, infer, pred

    # (c) the unbounded While (trip count fed) and the IfElse
    progs = {name: (m, st, feed, fetch)
             for name, m, st, feed, fetch in cf_programs(fluid)}
    for name, feeds in (
            ("while_fed_limit", [
                dict(progs["while_fed_limit"][2],
                     lim=np.asarray([lim], np.float32))
                for lim in AOT_WHILE_LIMITS]),
            ("ifelse", [{"x": sign * np.abs(progs["ifelse"][2]["x"])}
                        for sign in (1.0, -1.0)])):
        m, st, feed0, fetch = progs[name]
        gb = m.global_block()
        exe, scope, infer, pred, export_s, size = aot_export(
            fluid, m, st, sorted(feed0), [gb.var(n) for n in fetch], name)
        rows = {}
        for k, feed in enumerate(feeds):
            want = ([feed["lim"][0]] if name == "while_fed_limit"
                    else np.tanh(feed["x"]) if k == 0
                    else 1 / (1 + np.exp(-feed["x"])))
            feed = {n: torch.from_numpy(np.asarray(v)).to(dev)
                    for n, v in feed.items()}
            err, ms = aot_serve(torch, f"{name} {k}", exe, scope, infer,
                                pred, feed, None)
            # the trip count (the While's counter), or the branch taken
            ok, _ = np_close(pred.run(feed)[-1], want, AOT_TOL)
            check(ok, f"aot_recurrent {name} {k}: not the expected "
                  "trip count or branch")
            rows[str(k)] = {"max_err": err, "ms": ms}
        record(name, export_s, size, rows)
        del exe, scope, infer, pred

    # (d) F14's last ops: srl_crf_train's tagger (linear_chain_crf's
    # cost a row, chunk_eval's counts over crf_decoding's tags; its nine
    # feeds share one padded length) and ocr_ctc_train's CRNN (warpctc's
    # cost a row; the label's padded length is the symbol)
    t_f14 = time.perf_counter()
    main, startup, _, _, _, counts = srl_program(fluid)
    gb = main.global_block()
    cost = gb.var(next(op.output("LogLikelihood")[0] for op in gb.ops
                       if op.type == "linear_chain_crf"))
    names = SRL_NAMES + ("target",)
    exe, scope, infer, pred, export_s, size = aot_export(
        fluid, main, startup, list(names), [cost] + list(counts), "srl_crf")
    hi = {"predicate": SRL_DICTS["pred_dict_len"], "mark": 2,
          "target": SRL_DICTS["label_dict_len"]}
    rows = {}
    for batch, t in ((SRL_BATCH, SRL_LENS[1]), (4, 24)):
        lens = [t] + list(rng.randint(SRL_LENS[0], t + 1, batch - 1))
        feed = {n: seq_on(fluid, dev, [
            rng.randint(0, hi.get(n, SRL_DICTS["word_dict_len"]),
                        (int(k), 1)).astype(np.int64) for k in lens])
            for n in names}
        err, ms = aot_serve(torch, f"srl_crf b{batch} t{t}", exe, scope,
                            infer, pred, feed, AOT_TOL)
        rows[f"b{batch} t{t}"] = {"max_err": err, "ms": ms}
    record("srl_crf", export_s, size, rows)
    del exe, scope, infer, pred
    main, startup, _, _, _ = ocr_program(fluid)
    gb = main.global_block()
    cost = gb.var(next(op.output("Loss")[0] for op in gb.ops
                       if op.type == "warpctc"))
    exe, scope, infer, pred, export_s, size = aot_export(
        fluid, main, startup, ["images", "label"], [cost], "ocr_ctc")
    rows = {}
    for batch, t in ((OCR_BATCH, OCR_LABEL_LENS[1]), (8, 9)):
        lens = [t] + list(rng.randint(OCR_LABEL_LENS[0], t + 1, batch - 1))
        feed = {"images": torch.from_numpy(rng.randn(batch, *OCR_SHAPE)
                                           .astype(np.float32)).to(dev),
                "label": seq_on(fluid, dev, [
                    rng.randint(0, OCR_CLASSES, (int(k), 1)).astype(np.int64)
                    for k in lens])}
        err, ms = aot_serve(torch, f"ocr_ctc b{batch} label t{t}", exe,
                            scope, infer, pred, feed, AOT_TOL)
        rows[f"b{batch} label t{t}"] = {"max_err": err, "ms": ms}
    record("ocr_ctc", export_s, size, rows)
    del exe, scope, infer, pred
    stats["f14_ops_s"] = time.perf_counter() - t_f14
    import shutil
    shutil.rmtree(AOT_ROOT, ignore_errors=True)
    by_kernel = attention_idle(fa, "aot_recurrent")
    stats["attention_launches"] = by_kernel
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"aot_recurrent: {card}, float32, TF32 off: " + json.dumps(stats))
    return by_kernel, stats


# ROADMAP item 7c: Faster R-CNN at its published training scale and an
# SSD300 head, float32, TF32 off
FRCNN_BATCH = 2                 # Fast R-CNN's N = 2 images a minibatch
FRCNN_HW = (600, 800)           # shorter side 600 (a 375 x 500 VOC image)
FRCNN_GT = (1, 6)               # ground-truth boxes an image
FRCNN_WARMUP = 2
FRCNN_STEPS = 10
SSD_MAPS = ((512, 38), (1024, 19), (512, 10), (256, 5), (256, 3), (256, 1))
SSD_RATIOS = [[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0], [2.0]]
SSD_PRIORS = 8732
SSD_CLASSES = 21
SSD_BATCH = 32
SSD_PARITY_BATCH = 8
SSD_WARMUP = 2
SSD_STEPS = 5
SSD_NMS = dict(nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
               score_threshold=0.01)
IOU_EPS = 1e-5                  # a candidate this near a threshold may flip
DET_KINDS = (("conv", ("conv", "cudnn", "implicit", "winograd", "fprop",
                       "dgrad", "wgrad", "sm90_xmma")),
             ("matmul", ("gemm", "nvjet", "cutlass", "matmul")),
             ("sort_topk", ("sort", "topk", "radix", "scan")),
             ("reduce", ("reduce",)),
             ("index", ("index", "gather", "scatter")),
             ("copy", ("memcpy", "memset")),
             ("elementwise", ("elementwise", "vectorized", "unrolled")))


def op_output(main, op_type, slot):
    """The name of ``op_type``'s ``slot`` output in ``main`` (its first
    such op)."""
    op = next(o for o in main.global_block().ops if o.type == op_type)
    return op.outputs[slot][0]


def op_input(main, op_type, slot):
    op = next(o for o in main.global_block().ops if o.type == op_type)
    return op.inputs[slot][0]


def iou_np(a, b, off=1.0):
    """IoU in float64 of boxes a [M, 4] against b [N, 4] (+1 pixel
    widths by default, the samplers' convention)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    area = lambda x: (np.maximum(x[:, 2] - x[:, 0] + off, 0)   # noqa: E731
                      * np.maximum(x[:, 3] - x[:, 1] + off, 0))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt + off, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-30), 0.0)


def near_thresholds(iou_max, thresholds):
    """How many of ``iou_max`` lie within IOU_EPS of a threshold."""
    return int(sum((np.abs(iou_max - t) < IOU_EPS).sum()
                   for t in thresholds))


def frcnn_programs(fluid):
    """Faster R-CNN at ``FasterRCNNConfig()``'s defaults (its full
    width): the train program with ``Momentum(1e-3, 0.9)`` (Ren et al.)
    and the inference program, which share their parameter names."""
    from paddle_tpu_torch.models.faster_rcnn import (FasterRCNNConfig,
                                                     build_faster_rcnn)
    h, w = FRCNN_HW
    progs = []
    for train in (True, False):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.layers.data("img", shape=[-1, 3, h, w],
                                    dtype="float32", append_batch_size=False)
            info = fluid.layers.data("info", shape=[-1, 3], dtype="float32",
                                     append_batch_size=False)
            if train:
                gtb = fluid.layers.data("gtb", shape=[4], dtype="float32",
                                        lod_level=1)
                gtl = fluid.layers.data("gtl", shape=[1], dtype="int64",
                                        lod_level=1)
                loss, _, _ = build_faster_rcnn(img, gtb, gtl, info,
                                               FasterRCNNConfig())
                fluid.optimizer.Momentum(learning_rate=1e-3,
                                         momentum=0.9).minimize(loss)
                fetch = [loss.name]
            else:
                fetch = [v.name for v in build_faster_rcnn(
                    img, None, None, info, FasterRCNNConfig(),
                    is_train=False)]
        progs.append((main, startup, fetch))
    return progs


def frcnn_feed(fluid, rng, batch, dev=None):
    """``batch`` random 3 x 600 x 800 images with 1-6 ground-truth boxes
    each (40-400 pixels a side, labels 1-20), im_info (600, 800, 1)."""
    h, w = FRCNN_HW
    boxes, labels = [], []
    for _ in range(batch):
        n = rng.randint(FRCNN_GT[0], FRCNN_GT[1] + 1)
        wh = rng.uniform(40, 400, (n, 2))
        xy = rng.uniform(0, 1, (n, 2)) * (np.asarray([w, h]) - wh)
        boxes.append(np.concatenate([xy, xy + wh], 1).astype(np.float32))
        labels.append(rng.randint(1, 21, (n, 1)).astype(np.int64))
    feed = {"img": rng.rand(batch, 3, h, w).astype(np.float32),
            "gtb": fluid.to_sequence_batch(boxes, np.float32),
            "gtl": fluid.to_sequence_batch(labels, np.int64),
            "info": np.asarray([[h, w, 1.0]] * batch, np.float32)}
    if dev is not None:
        import torch
        feed = {k: (fluid.SequenceBatch(v.data.to(dev), v.lengths.to(dev))
                    if isinstance(v, fluid.SequenceBatch)
                    else torch.from_numpy(v).to(dev))
                for k, v in feed.items()}
    return feed, boxes


def phase_faster_rcnn_train(torch, fluid, fa, card):
    """Faster R-CNN at its full width (``FasterRCNNConfig()``: 21
    classes, anchors 32/64/128 x 0.5/1/2 at stride 16, RPN 64, backbone
    (16, 32), 64 RPN samples, 512 -> 64 proposals, 32 RoIs, 7 x 7
    pooling, head 128) on 2 images of 3 x 600 x 800, Momentum(1e-3,
    0.9), float32, TF32 off: the first step on the card against the CPU
    (the sampled anchors' labels and targets and the sampled RoIs and
    labels equal, then the loss and every gradient within 2e-3 / 2e-4;
    a candidate within float error of a threshold may flip, and is
    printed), 2 warmup and 10 timed steps (step ms, images/s, launches a
    step, busy ms, idle share, device ms by kind, peak memory), losses
    finite, the inference program's RoIs, class probabilities and box
    regressions on the card against the CPU from the trained scope; no
    attention launch. Returns (attention launches, stats)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.reset_launch_counts()
    (main, startup, fetch), (infer, _, infer_fetch) = frcnn_programs(fluid)
    check(sorted(p.name for p in infer.all_parameters())
          == sorted(p.name for p in main.all_parameters()),
          "faster_rcnn_train: the inference program's parameters differ")
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    rng = np.random.RandomState(SEED + 11)
    feed, gt_boxes = frcnn_feed(fluid, rng, FRCNN_BATCH)
    params = sorted(p.name for p in main.all_parameters() if p.trainable)
    samples = [op_output(main, "rpn_target_assign", "ScoreTarget"),
               op_output(main, "rpn_target_assign", "LocTarget"),
               op_output(main, "generate_proposal_labels", "LabelsInt32"),
               op_output(main, "generate_proposal_labels", "Rois"),
               op_output(main, "generate_proposals", "RpnRois"),
               op_output(main, "anchor_generator", "Anchors")]
    names = fetch + [p + "@GRAD" for p in params] + samples
    t0 = time.perf_counter()
    outs = card_and_cpu(fluid, main, startup, names, feed)
    parity_s = time.perf_counter() - t0
    card_s, cpu_s = outs["card"][-6:], outs["cpu"][-6:]
    same = (np.array_equal(card_s[0], cpu_s[0])
            and np.array_equal(card_s[2], cpu_s[2])
            and np_close(card_s[1], cpu_s[1], SEQ_TOL)[0]
            and np_close(card_s[3], cpu_s[3], SEQ_TOL)[0])
    # the candidates within float error of a sampler's threshold: anchors
    # at the RPN's 0.7 / 0.3, proposals and gts at the RoI sampler's 0.5
    anchors = cpu_s[5].reshape(-1, 4)
    near_rpn = sum(near_thresholds(iou_np(g, anchors).max(0), (0.7, 0.3))
                   for g in gt_boxes)
    near_roi = sum(near_thresholds(
        iou_np(g, np.concatenate([cpu_s[4][b], g])).max(0), (0.5,))
        for b, g in enumerate(gt_boxes))
    sampled = {"rpn_fg": int((cpu_s[0] == 1).sum()),
               "rpn_bg": int((cpu_s[0] == 0).sum()),
               "roi_fg": int((cpu_s[2] > 0).sum()),
               "roi_bg": int((cpu_s[2] == 0).sum()),
               "equal": bool(same),
               "candidates_near_a_threshold": near_rpn + near_roi}
    if not same:
        # allowed only where a candidate lies within float error of a
        # threshold; then the two steps trained on different samples
        log(f"faster_rcnn_train: the card sampled other boxes than the "
            f"CPU: {sampled}")
        check(near_rpn + near_roi > 0,
              "faster_rcnn_train: the card's sampled anchors or RoIs "
              "differ from the CPU's with no candidate near a threshold")
        worst = None
    else:
        worst = 0.0
        for n, a, b in zip(names[:-6], outs["card"], outs["cpu"]):
            ok, err = np_close(a, b, SEQ_TOL)
            check(ok and np.isfinite(a).all(),
                  f"faster_rcnn_train: {n} card vs CPU max err {err}")
            worst = max(worst, err)
    fa.reset_launch_counts()
    exe = fluid.Executor()
    dev = exe.device
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    dfeed, _ = frcnn_feed(fluid, np.random.RandomState(SEED + 11),
                          FRCNN_BATCH, dev)
    ms, losses, peak = timed_steps(torch, exe, main, fetch[0], scope, dfeed,
                                   FRCNN_WARMUP, FRCNN_STEPS)
    check(np.isfinite(losses).all(),
          f"faster_rcnn_train: losses not finite: {losses}")
    med = float(np.median(ms))
    stats = {"config": "FasterRCNNConfig()", "params": n_params,
             "batch": FRCNN_BATCH, "image": list(FRCNN_HW),
             "anchors_an_image": int(anchors.shape[0]),
             "gt_boxes": [int(g.shape[0]) for g in gt_boxes],
             "sampled": sampled, "parity_max_err": worst,
             "parity_s": parity_s, "steps": FRCNN_STEPS, "step_ms": ms,
             "step_ms_median": med,
             "images_per_s": FRCNN_BATCH * FRCNN_STEPS / (sum(ms) / 1e3),
             "peak_memory_gb": peak / 1e9, "losses": [losses[0], losses[-1]],
             "one_step": step_breakdown(torch, lambda: exe.run(
                 main, feed=dfeed, fetch_list=fetch, scope=scope,
                 return_numpy=False), med, kinds=DET_KINDS)}
    # the inference program from the trained scope, card and CPU
    cpu_scope = fluid.Scope()
    for n, v in scope.vars.items():
        cpu_scope.set(n, v.detach().cpu().clone())
    ifeed = {k: feed[k] for k in ("img", "info")}
    got = exe.run(infer, feed=ifeed, fetch_list=infer_fetch, scope=scope)
    want = fluid.Executor(fluid.CPUPlace()).run(
        infer, feed=ifeed, fetch_list=infer_fetch, scope=cpu_scope)
    ierr = 0.0
    for n, a, b in zip(("rois", "cls_prob", "bbox_pred"), got, want):
        ok, err = np_close(a, b, SEQ_TOL)
        check(ok and np.isfinite(a).all(),
              f"faster_rcnn_train: inference {n} card vs CPU max err {err}")
        ierr = max(ierr, err)
    stats["inference_max_err"] = ierr
    stats["inference_rois"] = list(np.asarray(got[0]).shape)
    by_kernel = attention_idle(fa, "faster_rcnn_train")
    log(f"faster_rcnn_train: {card}, float32, TF32 off: " + json.dumps(stats))
    return by_kernel, stats


def ssd_programs(fluid):
    """The SSD300 multibox head over the six maps (data at SSD300's
    shapes), ``base_size`` 300, 21 classes, ``min_ratio`` 20,
    ``max_ratio`` 90, 3 x 3 heads, flipped ratios: (train main, startup,
    loss, priors) with ``ssd_loss`` -> ``reduce_sum`` -> Momentum(1e-3,
    0.9); (infer main, nms rows) with ``detection_output`` at SSD's
    evaluation settings; (eval main, nms rows, evaluator) adding
    ``evaluator.DetectionMAP`` (11point). All share parameter names."""
    out = {}
    for kind in ("train", "infer", "eval"):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.layers.data("img", shape=[-1, 3, 300, 300],
                                    dtype="float32", append_batch_size=False)
            maps = [fluid.layers.data(f"map{i}", shape=[-1, c, s, s],
                                      dtype="float32",
                                      append_batch_size=False)
                    for i, (c, s) in enumerate(SSD_MAPS)]
            locs, confs, boxes, var = fluid.layers.multi_box_head(
                maps, img, base_size=300, num_classes=SSD_CLASSES,
                aspect_ratios=SSD_RATIOS, min_ratio=20, max_ratio=90,
                kernel_size=3, pad=1, flip=True)
            if kind == "train":
                gb = fluid.layers.data("gb", shape=[4], dtype="float32",
                                       lod_level=1)
                gl = fluid.layers.data("gl", shape=[1], dtype="int64",
                                       lod_level=1)
                loss = fluid.layers.reduce_sum(fluid.layers.ssd_loss(
                    locs, confs, gb, gl, boxes, var))
                fluid.optimizer.Momentum(learning_rate=1e-3,
                                         momentum=0.9).minimize(loss)
                out[kind] = (main, startup, loss.name, boxes.name)
                continue
            nms = fluid.layers.detection_output(locs, confs, boxes, var,
                                                **SSD_NMS)
            if kind == "infer":
                out[kind] = (main, nms.name)
                continue
            gl = fluid.layers.data("gl", shape=[1], dtype="int64",
                                   lod_level=1)
            gb = fluid.layers.data("gb", shape=[4], dtype="float32",
                                   lod_level=1)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # deprecation
                ev = fluid.evaluator.DetectionMAP(
                    nms, gl, gb, class_num=SSD_CLASSES, overlap_threshold=0.5,
                    ap_version="11point")
            out[kind] = (main, nms.name, ev)
    return out


def ssd_feed(rng, batch, dev=None):
    """Feature maps drawn from N(0, 1) at SSD300's six shapes, a zero
    image (only its shape is read), and 1-6 ground-truth boxes an image
    (normalized, 0.05-0.6 a side, labels 1-20)."""
    import torch
    feed = {"img": np.zeros((batch, 3, 300, 300), np.float32)}
    for i, (c, s) in enumerate(SSD_MAPS):
        feed[f"map{i}"] = rng.randn(batch, c, s, s).astype(np.float32)
    boxes, labels = [], []
    for _ in range(batch):
        n = rng.randint(1, 7)
        wh = rng.uniform(0.05, 0.6, (n, 2))
        xy = rng.uniform(0, 1, (n, 2)) * (1 - wh)
        boxes.append(np.concatenate([xy, xy + wh], 1).astype(np.float32))
        labels.append(rng.randint(1, SSD_CLASSES, (n, 1)).astype(np.int64))
    if dev is not None:
        feed = {k: torch.from_numpy(v).to(dev) for k, v in feed.items()}
    return feed, boxes, labels


def nms_rows_agree(tag, got, want):
    """NMS rows of the card against the CPU's: labels equal and scores
    and boxes within the card tier, but where two candidates' scores tie
    within the tier (the card may order them the other way). Returns the
    rows that differ."""
    differ = 0
    for b in range(want.shape[0]):
        for k in range(want.shape[1]):
            if np.array_equal(got[b, k, :1], want[b, k, :1]) and \
                    np_close(got[b, k], want[b, k], SEQ_TOL)[0]:
                continue
            differ += 1
            check(abs(got[b, k, 1] - want[b, k, 1])
                  <= SEQ_TOL[1] + SEQ_TOL[0] * abs(want[b, k, 1]),
                  f"{tag}: image {b} slot {k}: card row {got[b, k]} against "
                  f"the CPU's {want[b, k]}, scores not tied")
    return differ


def phase_ssd_train(torch, fluid, fa, card):
    """The SSD300 multibox head (``multi_box_head`` over SSD300's six
    maps, fed as data): 8,732 priors, ``ssd_loss`` -> ``reduce_sum`` ->
    Momentum; the first step at batch 8 on the card against the CPU
    (loss and every gradient within 2e-3 / 2e-4), 2 warmup and 5 timed
    steps at batch 32 (step ms, launches, peak memory);
    ``detection_output`` (nms 0.45, top 400, keep 200, score 0.01) at
    batch 32 timed (ms, launches); at batch 8 its NMS rows on the card
    against the CPU's (a differing row only between scores tied within
    the tier), the NMS rule on the CPU's own inputs moved to the card
    equal to the CPU's rows exactly, and ``detection_map`` (11point)
    with ``evaluator.DetectionMAP`` over two batches (ground truth drawn
    from the CPU's detections) equal to the CPU's; no attention launch.
    Returns (attention launches, stats)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.reset_launch_counts()
    progs = ssd_programs(fluid)
    main, startup, loss, priors = progs["train"]
    rng = np.random.RandomState(SEED + 12)
    pfeed, pboxes, plabels = ssd_feed(rng, SSD_PARITY_BATCH)
    pfeed["gb"] = fluid.to_sequence_batch(pboxes, np.float32)
    pfeed["gl"] = fluid.to_sequence_batch(plabels, np.int64)
    t0 = time.perf_counter()
    err, first = first_step_card_vs_cpu(torch, fluid, "ssd_train", main,
                                        startup, loss, pfeed)
    parity_s = time.perf_counter() - t0
    fa.reset_launch_counts()
    exe = fluid.Executor()
    dev = exe.device
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    n_priors = exe.run(main, feed=pfeed, fetch_list=[priors],
                       scope=scope)[0].shape[0]
    check(n_priors == SSD_PRIORS,
          f"ssd_train: {n_priors} priors, not SSD300's {SSD_PRIORS}")
    feed, boxes, labels = ssd_feed(np.random.RandomState(SEED + 13),
                                   SSD_BATCH, dev)
    gb = fluid.to_sequence_batch(boxes, np.float32)
    gl = fluid.to_sequence_batch(labels, np.int64)
    feed["gb"] = fluid.SequenceBatch(gb.data.to(dev), gb.lengths.to(dev))
    feed["gl"] = fluid.SequenceBatch(gl.data.to(dev), gl.lengths.to(dev))
    ms, losses, peak = timed_steps(torch, exe, main, loss, scope, feed,
                                   SSD_WARMUP, SSD_STEPS)
    check(np.isfinite(losses).all(), f"ssd_train: losses {losses}")
    med = float(np.median(ms))
    stats = {"maps": [list(m) for m in SSD_MAPS], "priors": n_priors,
             "batch": SSD_BATCH, "parity_batch": SSD_PARITY_BATCH,
             "parity_max_err": err, "first_loss": first,
             "parity_s": parity_s, "step_ms": ms, "step_ms_median": med,
             "peak_memory_gb": peak / 1e9,
             "losses": [losses[0], losses[-1]],
             "one_step": step_breakdown(torch, lambda: exe.run(
                 main, feed=feed, fetch_list=[loss], scope=scope,
                 return_numpy=False), med, kinds=DET_KINDS)}
    # detection_output at batch 32 from the trained scope
    infer, nms = progs["infer"]
    ifeed = {k: v for k, v in feed.items() if k not in ("gb", "gl")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dms = []
    for _ in range(3):
        t0 = time.perf_counter()
        rows = exe.run(infer, feed=ifeed, fetch_list=[nms], scope=scope,
                       return_numpy=False)[0]
        torch.cuda.synchronize()
        dms.append((time.perf_counter() - t0) * 1e3)
    dmed = float(np.median(dms))
    stats["detection_output"] = {
        "ms": dms, "ms_median": dmed,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "kept_rows": int((rows[..., 0] >= 0).sum().item()),
        "one_call": step_breakdown(torch, lambda: exe.run(
            infer, feed=ifeed, fetch_list=[nms], scope=scope,
            return_numpy=False), dmed, kinds=DET_KINDS)}
    # NMS rows and mAP at batch 8, card against CPU, one trained state
    cpu_scope = fluid.Scope()
    for n, v in scope.vars.items():
        cpu_scope.set(n, v.detach().cpu().clone())
    emain, enms, ev_cpu = progs["eval"]
    ev_card = ssd_programs(fluid)["eval"][2]
    boxes_in = op_input(emain, "multiclass_nms", "BBoxes")
    scores_in = op_input(emain, "multiclass_nms", "Scores")
    nms_attrs = next(o for o in emain.global_block().ops
                     if o.type == "multiclass_nms").attrs
    differ, exact_rows, maps = 0, True, {"card": [], "cpu": []}
    for batch in range(2):
        bfeed, _, _ = ssd_feed(np.random.RandomState(SEED + 20 + batch),
                               SSD_PARITY_BATCH)
        want = fluid.Executor(fluid.CPUPlace()).run(
            infer, feed=bfeed, fetch_list=[nms], scope=cpu_scope)[0]
        # ground truth: three of each image's detections, nudged, and
        # one box no detection is near (so the AP is neither 0 nor 1)
        pick = [0, 3, 7]
        gtb = [np.concatenate([np.clip(want[b, pick, 2:] + 0.02, 0, 1),
                               [[0.9, 0.9, 0.99, 0.99]]]).astype(np.float32)
               for b in range(len(want))]
        gtl = [np.maximum(want[b, pick + [1], :1], 1).astype(np.int64)
               for b in range(len(want))]
        bfeed["gb"] = fluid.to_sequence_batch(gtb, np.float32)
        bfeed["gl"] = fluid.to_sequence_batch(gtl, np.int64)
        fetch = [enms, boxes_in, scores_in] + [v.name for v in ev_cpu.metrics]
        res = {}
        for side, e, sc, ev in (("card", exe, scope, ev_card),
                                ("cpu", fluid.Executor(fluid.CPUPlace()),
                                 cpu_scope, ev_cpu)):
            out = e.run(emain, feed=bfeed, fetch_list=fetch, scope=sc)
            ev.update(*out[3:])
            maps[side].append(float(np.asarray(out[3]).reshape(())))
            res[side] = out
        differ += nms_rows_agree("ssd_train", res["card"][0], res["cpu"][0])
        # the NMS rule alone on the CPU's own inputs, on the card: exact
        from paddle_tpu_torch.core import lowering
        from paddle_tpu_torch.core.registry import get_op
        ctx = lowering.LoweringContext(None, "test", dev, SEED, 1)
        rows = get_op("multiclass_nms").lower(ctx, {
            "BBoxes": [torch.from_numpy(res["cpu"][1]).to(dev)],
            "Scores": [torch.from_numpy(res["cpu"][2]).to(dev)]},
            dict(nms_attrs))["Out"][0].cpu().numpy()
        exact_rows = exact_rows and np.array_equal(rows, res["cpu"][0])
        check(np.array_equal(rows, res["cpu"][0]),
              "ssd_train: multiclass_nms on the CPU's inputs gave other "
              "rows on the card")
    maps["card_dataset"] = ev_card.eval(exe)
    maps["cpu_dataset"] = ev_cpu.eval(None)
    if differ == 0:
        for a, b in ((maps["card"], maps["cpu"]),
                     ([maps["card_dataset"]], [maps["cpu_dataset"]])):
            check(np.allclose(a, b, rtol=0, atol=1e-6),
                  f"ssd_train: mAP card {a} against CPU {b}")
    stats.update(nms_rows_differing=differ, nms_rule_exact=exact_rows,
                 map_11point=maps)
    by_kernel = attention_idle(fa, "ssd_train")
    log(f"ssd_train: {card}, float32, TF32 off: " + json.dumps(stats))
    return by_kernel, stats


def extras_cases():
    """(name, op, inputs, attrs, grad slots, mode) for every op of the
    extras family and hsigmoid / nce at small shapes."""
    r = np.random.RandomState(SEED + 30)

    def f(*shape, lo=-1.0, hi=1.0):
        return r.uniform(lo, hi, shape).astype(np.float32)

    def ids(hi, *shape):
        return r.randint(0, hi, shape).astype(np.int64)

    pool_idx = ((np.arange(3)[:, None] * 2 + ids(2, 2, 3, 3, 3)) * 6
                + np.arange(3)[None, :] * 2 + ids(2, 2, 3, 3, 3))
    return [
        ("minus", "minus", {"X": [f(3, 4)], "Y": [f(3, 4)]}, {},
         ("X", "Y"), "test"),
        ("modified_huber_loss", "modified_huber_loss",
         {"X": [f(16, 1, lo=-3, hi=3)],
          "Y": [ids(2, 16, 1).astype(np.float32)]}, {}, ("X",), "test"),
        ("pad_constant_like", "pad_constant_like",
         {"X": [f(4, 5, 6)], "Y": [f(2, 3, 6)]}, {"pad_value": 1.5},
         ("Y",), "test"),
        ("conv_shift", "conv_shift", {"X": [f(4, 9)], "Y": [f(4, 5)]}, {},
         ("X", "Y"), "test"),
        ("max_pool2d_with_index", "max_pool2d_with_index",
         {"X": [f(2, 3, 7, 5)]}, {"ksize": 3, "strides": 2, "paddings": 1},
         ("X",), "test"),
        ("unpool", "unpool", {"X": [f(2, 3, 3, 3)], "Indices": [pool_idx]},
         {"unpooled_height": 6, "unpooled_width": 6}, ("X",), "test"),
        ("spp_max", "spp", {"X": [f(2, 3, 5, 7)]},
         {"pyramid_height": 3, "pooling_type": "max"}, ("X",), "test"),
        ("spp_avg", "spp", {"X": [f(2, 3, 5, 7)]},
         {"pyramid_height": 3, "pooling_type": "avg"}, ("X",), "test"),
        ("positive_negative_pair", "positive_negative_pair",
         {"Score": [np.round(f(32, 1), 1)],
          "Label": [ids(3, 32, 1).astype(np.float32)],
          "QueryID": [ids(4, 32, 1)]}, {}, (), "test"),
        ("precision_recall", "precision_recall",
         {"Indices": [ids(5, 64, 1)], "Labels": [ids(5, 64, 1)],
          "Weights": [f(64, 1, lo=0.5, hi=2)],
          "StatesInfo": [np.abs(f(5, 4)) * 5]}, {"class_number": 5}, (),
         "test"),
        ("fake_quantize_abs_max", "fake_quantize_abs_max",
         {"X": [f(64, 64)]}, {"bit_length": 8}, ("X",), "test"),
        ("fake_dequantize_max_abs", "fake_dequantize_max_abs",
         {"X": [np.round(f(8, 8) * 127)],
          "Scale": [np.asarray([0.75], np.float32)]}, {"max_range": 127.0},
         ("X", "Scale"), "test"),
        ("weight_norm", "weight_norm", {"V": [f(16, 8)],
                                        "G": [f(8, lo=0.5)]},
         {"dim": 1}, ("V", "G"), "test"),
        ("weight_norm_g_init", "weight_norm_g_init", {"V": [f(16, 8)]},
         {"dim": -1}, (), "test"),
        ("hierarchical_sigmoid", "hierarchical_sigmoid",
         {"X": [f(32, 16)], "Label": [ids(100, 32, 1)], "W": [f(99, 16)],
          "Bias": [f(99)]}, {"num_classes": 100}, ("X", "W", "Bias"),
         "test"),
        ("nce_same_rows", "nce",
         {"Input": [f(32, 16)], "Label": [ids(1000, 32, 1)],
          "Weight": [np.tile(f(1, 16), (1000, 1))],
          "Bias": [np.full((1000,), 0.3, np.float32)]},
         {"num_total_classes": 1000, "num_neg_samples": 10}, ("Input",),
         "train"),
    ]


def extras_programs(fluid):
    """(name, main, startup, loss, feed): a WeightNormParamAttr fc step,
    an hsigmoid step and an nce step whose table rows are equal (its
    table and bias not trained, so every gradient is independent of the
    negatives drawn)."""
    layers = fluid.layers
    r = np.random.RandomState(SEED + 31)
    out = []

    def build(name, fn, feed):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            loss = fn()
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        out.append((name, main, startup, loss.name, feed))

    x = r.randn(64, 32).astype(np.float32)
    lbl = r.randint(0, 100, (64, 1)).astype(np.int64)

    def weight_norm():
        xv = layers.data("x", shape=[32], dtype="float32")
        yv = layers.data("y", shape=[1], dtype="float32")
        pred = layers.fc(xv, size=1, param_attr=fluid.WeightNormParamAttr(
            dim=None, name="wn"))
        h = layers.fc(xv, size=16, param_attr=fluid.WeightNormParamAttr(
            dim=1, name="wn1"))
        return layers.mean(layers.square_error_cost(pred, yv)) + \
            layers.mean(h * h)
    build("weight_norm_fc", weight_norm,
          {"x": x, "y": x[:, :1] * 2.0 - x[:, 1:2]})

    def hsig():
        xv = layers.data("x", shape=[32], dtype="float32")
        lv = layers.data("lbl", shape=[1], dtype="int64")
        h = layers.fc(xv, size=16, act="tanh")
        return layers.mean(layers.hsigmoid(h, lv, num_classes=100))
    build("hsigmoid", hsig, {"x": x, "lbl": lbl})

    def nce():
        xv = layers.data("x", shape=[32], dtype="float32")
        lv = layers.data("lbl", shape=[1], dtype="int64")
        h = layers.fc(xv, size=16, act="tanh")
        return layers.mean(layers.nce(
            h, lv, num_total_classes=100, num_neg_samples=8,
            param_attr=fluid.ParamAttr(
                name="nce_w", trainable=False,
                initializer=fluid.initializer.Constant(0.2)),
            bias_attr=False))
    build("nce", nce, {"x": x, "lbl": lbl})
    return out


def phase_detection_extras(torch, fluid, fa, card):
    """Every extras op, ``hierarchical_sigmoid`` and ``nce`` (identical
    table rows) on the card against the CPU at small shapes, float32,
    TF32 off: outputs within the float32 tier, integers (pooling
    indices, pair counts, the quantized domain) exactly, the gradients
    of the float inputs through one random cotangent; then a
    WeightNormParamAttr fc step, an hsigmoid step and an nce step on the
    card against the CPU (loss and every gradient). Returns (attention
    launches, stats)."""
    from paddle_tpu_torch.core import lowering
    from paddle_tpu_torch.core.registry import get_op
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.reset_launch_counts()
    dev = fluid.Executor().device
    stats = {}
    for name, op, ins, attrs, grad, mode in extras_cases():
        res = []
        for d in (dev, torch.device("cpu")):
            tins = {s: [torch.from_numpy(np.array(a)).to(d) for a in v]
                    for s, v in ins.items()}
            leaves = [t.requires_grad_() for s in grad for t in tins[s]]
            ctx = lowering.LoweringContext(None, mode, d, SEED, 1)
            with torch.enable_grad():
                out = get_op(op).lower(ctx, tins, dict(attrs))
                flat = [t for s in sorted(out) for t in out[s]]
                gen = torch.Generator().manual_seed(SEED)
                total = sum((t * torch.randn(t.shape, generator=gen).to(d))
                            .sum() for t in flat if t.requires_grad)
                grads = torch.autograd.grad(total, leaves) if leaves else []
            res.append([t.detach().cpu().numpy() for t in flat]
                       + [g.cpu().numpy() for g in grads])
        worst = 0.0
        for i, (a, b) in enumerate(zip(*res)):
            if b.dtype.kind in "iub" or (op == "fake_quantize_abs_max"
                                         and i == 0):
                check(np.array_equal(a, b),
                      f"detection_extras {name}: output {i} not exact")
                continue
            ok, e = np_close(a, b, TOL_F32)
            check(ok, f"detection_extras {name}: output/gradient {i} card "
                      f"vs CPU max err {e}")
            worst = max(worst, e)
        stats[name] = worst
    for name, main, startup, loss, feed in extras_programs(fluid):
        stats[f"{name}_step"] = first_step_card_vs_cpu(
            torch, fluid, f"detection_extras {name}", main, startup, loss,
            feed)[0]
    by_kernel = attention_idle(fa, "detection_extras")
    log(f"detection_extras: {card}, float32, TF32 off, max err: "
        + json.dumps(stats))
    return by_kernel, stats



# ---------------------------------------------------------------------------
# ROADMAP item 8: the fleet (paddle_tpu_torch/cluster/)
# ---------------------------------------------------------------------------

FLEET_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "paddle_tpu_torch", "_build", "chip_smoke_fleet")
FLEET_READY_S = 240.0           # a worker's start: torch, the card, warmup
FLEET_CLIENTS = 4               # client threads of the chaos drills
FLEET_PROCS = []                # every worker process the script started
TRAIN_FABRIC_STEPS, TRAIN_FABRIC_COMMIT = 12, 4
TRAIN_FABRIC_SHARDS, TRAIN_FABRIC_CRASH_STEP = 4, 6
TOL_TRAIN_FABRIC_CPU = (2e-3, 2e-4)     # rtol, atol: card vs CPU params
# the pool holds the scope once: with both replicas up and idle the card
# holds under CLUSTER_IDLE_OVER_WEIGHTS x the weights more than before the
# pool (a replica's own copy would add 1x), and the peak stays under
# cluster_peak_bound's
CLUSTER_IDLE_OVER_WEIGHTS = 0.5
CLUSTER_TRANSIENT_SLACK = 1.1           # the allocator, two streams


def cluster_peak_bound(weight_bytes, lone_peak_bytes):
    """The most a pool of two engines over one scope of
    ``weight_bytes`` may peak at: the weights once, and each engine's
    transient (its activations and logits while it serves) up to what
    one engine serving the same requests alone took above the weights
    (``lone_peak_bytes``, phase_serve's peak on that scope), with
    CLUSTER_TRANSIENT_SLACK for the allocator. Capped at twice the
    weights, which a second copy of them alone reaches. The two
    replicas' transients overlap in time or not, as their threads run:
    a bound of 1.5 x the weights passed or failed on that alone."""
    transient = max(lone_peak_bytes - weight_bytes, 0)
    return min(weight_bytes + 2 * CLUSTER_TRANSIENT_SLACK * transient,
               2 * weight_bytes)


def fleet_workdir(name):
    """A fresh directory ``name`` under FLEET_ROOT."""
    import shutil
    path = os.path.join(FLEET_ROOT, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def spawn_worker(module, args, env=None):
    """``python -m paddle_tpu_torch.cluster.<module>`` in a fresh
    interpreter, on this process's default place (the card); a thread
    keeps its output lines. Registered in FLEET_PROCS, which
    ``stop_workers`` empties."""
    from paddle_tpu_torch.cluster.replica import worker_argv, worker_env
    full_env, root = worker_env()
    full_env["PYTHONUNBUFFERED"] = "1"
    full_env.update(env or {})
    proc = subprocess.Popen(worker_argv(module) + list(args),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=full_env, cwd=root)
    proc.lines, proc.ready = [], threading.Event()

    def read():
        for line in proc.stdout:
            proc.lines.append(line.rstrip())
            if "ready on" in line:
                proc.ready.set()

    threading.Thread(target=read, daemon=True).start()
    FLEET_PROCS.append(proc)
    return proc


def worker_addr(proc, tag):
    """The ``host:port`` a worker's ready line names, waiting up to
    FLEET_READY_S; a worker that dies or never gets ready fails."""
    deadline = time.monotonic() + FLEET_READY_S
    while not proc.ready.wait(0.2):
        if proc.poll() is not None or time.monotonic() > deadline:
            check(False, f"{tag}: worker {proc.args[2:]} not ready (rc "
                  f"{proc.poll()}): {proc.lines[-12:]}")
    line = next(ln for ln in proc.lines if "ready on" in ln)
    return line.split("ready on ")[1].split()[0]


def stop_workers(procs=None):
    """Kill and reap ``procs`` (default: every worker still listed)."""
    procs = list(FLEET_PROCS if procs is None else procs)
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(30)
        except subprocess.TimeoutExpired:
            pass
        if p in FLEET_PROCS:
            FLEET_PROCS.remove(p)


class ChaosLoad:
    """FLEET_CLIENTS threads sending ``call(i)`` in a loop while a drill
    runs; each outcome tallied as ok, typed (a ServingError, by class
    name in ``typed_by``) or lost (anything else, or a result check that
    failed)."""

    def __init__(self, call, n_items):
        from paddle_tpu_torch.serving import ServingError
        self._typed = ServingError
        self.call, self.n = call, n_items
        self.outcomes = {"ok": 0, "typed": 0, "lost": 0}
        self.typed_by, self.errors = {}, []
        self._lock, self._stop = threading.Lock(), threading.Event()
        self._threads = [threading.Thread(target=self._client, args=(k,),
                                          daemon=True)
                         for k in range(FLEET_CLIENTS)]

    def _client(self, k):
        i = k
        while not self._stop.is_set():
            try:
                self.call(i % self.n)
                key = "ok"
            except self._typed as e:
                key, err = "typed", e
            except Exception as e:           # noqa: BLE001 — tallied
                key, err = "lost", e
            with self._lock:
                self.outcomes[key] += 1
                if key == "typed":
                    name = type(err).__name__
                    self.typed_by[name] = self.typed_by.get(name, 0) + 1
                if key != "ok" and len(self.errors) < 8:
                    self.errors.append(f"{type(err).__name__}: {err}")
            i += FLEET_CLIENTS

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(900.0)
        return False

    def ok_count(self):
        with self._lock:
            return self.outcomes["ok"]

    def check_nothing_lost(self, tag, typed_ok=None, most=0):
        """Every request answered, or (at most ``most`` of them) failed
        with the typed error ``typed_ok`` names, none lost."""
        o = self.outcomes
        allowed = o["typed"] == 0 or (
            set(self.typed_by) == {typed_ok} and o["typed"] <= most)
        check(o["ok"] > 0 and o["lost"] == 0 and allowed,
              f"{tag}: requests under the drill {o} {self.typed_by}: "
              f"{self.errors}")


def pct_ms(samples):
    """p50 / p99 of ``samples`` (ms)."""
    s = np.asarray(samples, np.float64)
    return {"p50_ms": float(np.percentile(s, 50)),
            "p99_ms": float(np.percentile(s, 99)), "n": int(s.size)}


def phase_cluster_serve(torch, fluid, fa, card, served):
    """ROADMAP item 8, the main path of this slice: the Llama-3-8B width,
    all 32 layers in bf16, behind ``cluster.serve_cluster(factory,
    replicas=2, warmup=True)`` (the call ``Inferencer.serve(replicas=2)``
    makes), the factory building ``ServingEngine``s over ``phase_serve``'s
    bf16 scope and buckets, so the pool holds the weights once. Its 8
    request lengths sent concurrently; each answer held to the request
    alone at ``phase_serve``'s bf16 tier; both replicas take traffic; K1
    launched 32 times a dispatch summed over both replicas, all on
    flash_fwd_d128_wgmma, K2/K3 none; no step build after warmup; the pool, up
    and idle, under CLUSTER_IDLE_OVER_WEIGHTS x the weights' bytes above
    what the card held before it, and its peak under
    :func:`cluster_peak_bound`. Then under in-flight
    traffic a ``pool.rolling_restart()`` and the ``serving_replica_crash``
    drill: no request lost, the replica revived. Returns (launches by
    kernel symbol, stats)."""
    from paddle_tpu_torch import cluster
    from paddle_tpu_torch.resilience import faultinject
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    tag = "cluster_serve"
    t_phase = time.perf_counter()
    cfg, infer, logits, scope = (served[k] for k in ("cfg", "infer",
                                                     "logits", "scope"))
    buckets, reqs, lengths, alone = (served[k] for k in (
        "buckets", "reqs", "lengths", "alone"))
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in scope.vars.values())

    def factory():
        return ServingEngine(infer, ["tokens"], [logits], scope=scope,
                             buckets=buckets,
                             config=ServingConfig(max_wait_ms=20.0,
                                                  default_timeout_s=600.0))

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts reset just before, read just after
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    router = cluster.serve_cluster(factory, replicas=2, warmup=True)
    try:
        up_s = time.perf_counter() - t0
        engines = [r.engine for r in router.pool.replicas()]
        check(len(engines) == 2 and engines[0] is not engines[1]
              and all(e.scope is scope for e in engines),
              f"{tag}: the pool's engines do not share the one scope")
        start = threading.Barrier(len(reqs))

        def call(r):
            start.wait()
            t = time.perf_counter()
            out = router.infer({"tokens": r}, timeout=600.0)
            return out, (time.perf_counter() - t) * 1e3

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(reqs)) as pool:
            results = list(pool.map(call, reqs))
        wall = time.perf_counter() - t0
        by_kernel = launches_by_kernel(fa)
        launches = fa.flash_fwd.launches
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        idle = torch.cuda.memory_allocated() - before
        per = [e.stats() for e in engines]
        for e in engines:
            e.assert_no_recompiles()
        warm = [e.exe.total_compiles() for e in engines]
        snap = router.stats()

        # the drills, under in-flight traffic
        def chaos_call(i):
            out = router.infer({"tokens": reqs[i]}, timeout=600.0)
            check(out[0].shape[-1] == cfg.vocab_size, "answer shape")

        t0 = time.perf_counter()
        with ChaosLoad(chaos_call, len(reqs)) as load:
            time.sleep(0.5)
            t1 = time.perf_counter()
            restart = router.pool.rolling_restart()
            restart_s = time.perf_counter() - t1
            spec = faultinject.arm("serving_replica_crash", at=0, times=1)
            t1 = time.perf_counter()
            while not spec.fired and time.perf_counter() - t1 < 120.0:
                time.sleep(0.01)
            faultinject.disarm("serving_replica_crash")
            check(spec.fired, f"{tag}: the replica crash never fired")
            while router.pool.ready_count() < 2 \
                    and time.perf_counter() - t1 < 120.0:
                time.sleep(0.01)
            failover_s = time.perf_counter() - t1
            time.sleep(0.5)
        drill_s = time.perf_counter() - t0
        load.check_nothing_lost(tag)
        after = router.stats()
    finally:
        faultinject.disarm()
        router.close(drain=True)
    dispatches = [w + p["batches_total"] for w, p in zip(warm, per)]
    check(all(w == served["warm_signatures"] for w in warm),
          f"{tag}: warmup built {warm} steps, phase_serve "
          f"{served['warm_signatures']}")
    check(all(p["batches_total"] > 0 for p in per),
          f"{tag}: a replica took no traffic "
          f"({[p['batches_total'] for p in per]} batches)")
    check(snap["cluster"]["responses_total"] == len(reqs),
          f"{tag}: {snap['cluster']['responses_total']} responses of "
          f"{len(reqs)}")
    k1 = bf16_k1(torch, fa, cfg)
    check(launches == cfg.n_layers * sum(dispatches)
          and by_kernel[k1] == launches
          and not fa_others(by_kernel, k1),
          f"{tag}: K1 launches {by_kernel} != {cfg.n_layers} layers x "
          f"{dispatches} dispatches, all {k1}")
    worst_rms = 0.0
    for n, (ans, _), want in zip(lengths, results, alone):
        got = ans[0][:, :n]
        check(np.isfinite(got).all(), f"{tag}: non-finite logits (len {n})")
        err = np.abs(got - want)
        rms = float(np.sqrt((err ** 2).mean() / (want ** 2).mean()))
        worst_rms = max(worst_rms, rms)
        g_tok, a_tok = int(got[0, -1].argmax()), int(want[0, -1].argmax())
        top2 = np.sort(want[0, -1])[-2:]
        check(rms <= TOL_LOGITS_BF16_RMS,
              f"{tag}: len {n}: rel rms {rms:.3e} > {TOL_LOGITS_BF16_RMS}")
        check(g_tok == a_tok or float(top2[1] - top2[0])
              <= 2 * float(err[0, -1].max()),
              f"{tag}: len {n}: greedy {g_tok} != {a_tok} beyond the "
              "flip rule")
    check(idle < CLUSTER_IDLE_OVER_WEIGHTS * weight_bytes,
          f"{tag}: the idle pool holds {idle / 1e9:.2f} GB more than the "
          f"card did before it, >= {CLUSTER_IDLE_OVER_WEIGHTS} x the "
          f"{weight_bytes / 1e9:.2f} GB of weights: the scope is not held "
          "once")
    bound = cluster_peak_bound(weight_bytes, served["peak_bytes"])
    check(peak < bound,
          f"{tag}: peak {peak / 1e9:.2f} GB >= {bound / 1e9:.2f} GB, the "
          f"{weight_bytes / 1e9:.2f} GB of weights and two lone engines' "
          f"transients ({served['peak_bytes'] / 1e9:.2f} GB alone): the "
          "scope is not held once")
    check(len(restart["restarted"]) == 2
          and restart["min_ready_observed"] >= 1,
          f"{tag}: rolling restart {restart}")
    check(after["revives_total"] >= 1 and after["ready_replicas"] == 2,
          f"{tag}: the crashed replica was not revived "
          f"(revives {after['revives_total']}, ready "
          f"{after['ready_replicas']})")
    lat = pct_ms([ms for _, ms in results])
    stats = {"replicas": 2, "requests": len(reqs), "wall_s": wall,
             "pool_up_s": up_s, "request_ms": lat,
             "cluster_latency": after["cluster"]["request_latency"],
             "lone_engine_p50_ms": served["p50_ms"],
             "lone_engine_p99_ms": served["p99_ms"],
             "batches_by_replica": [p["batches_total"] for p in per],
             "dispatches": dispatches, "k1_launches": launches,
             "max_rel_rms_vs_alone": worst_rms,
             "peak_gb": peak / 1e9, "weights_gb": weight_bytes / 1e9,
             "peak_bound_gb": bound / 1e9,
             "lone_engine_peak_gb": served["peak_bytes"] / 1e9,
             "idle_over_before_gb": idle / 1e9,
             "rolling_restart_s": restart_s,
             "failover_window_s": failover_s, "drill_s": drill_s,
             "drill_requests": load.outcomes,
             "revives_total": after["revives_total"],
             "restarts_total": after["restarts_total"],
             "phase_s": time.perf_counter() - t_phase, "card": card}
    log(f"{tag}: " + json.dumps(stats))
    return by_kernel, stats


def fa_others(by_kernel, keep):
    """The launches in ``by_kernel`` other than ``keep``'s (plain route
    entries included)."""
    return {k: n for k, n in by_kernel.items() if k != keep and n}


def phase_cluster_remote(torch, fluid, fa, card, saved):
    """The socket fabric on the card, over ``phase_io_saved_serve``'s
    saved Transformer-base (float32, K1 f32 at D = 64): two ``python -m
    paddle_tpu_torch.cluster.net_worker --dir D --port 0`` processes and
    ``Inferencer.from_inference_model(D).serve(remotes=[a, b])``; each
    request, sent alone, answered bit-equal to a lone in-process engine
    on the same directory (whose K1 launches are held exact), as is one
    ``ProcessReplica`` (the pipe transport); ``provision_from_remote``
    fills a fresh directory whose files' sha256 equal the source's; one
    server ``kill -9``ed under load, the router re-routing on typed
    RemoteUnavailableErrors, nothing lost; then a ``DeploymentManager``
    over an in-process pool on D: a canary equal to v1 promotes, one with
    perturbed weights fails the golden-set numerics gate and rolls back,
    nothing lost. Returns (launches by kernel symbol, stats)."""
    from paddle_tpu_torch import cluster
    from paddle_tpu_torch.io.artifact_store import dir_manifest
    from paddle_tpu_torch.serving import ServingEngine

    tag = "cluster_remote"
    t_phase = time.perf_counter()
    work, reqs, config, n_dec = (saved[k] for k in ("dir", "reqs",
                                                    "config", "n_dec"))
    k1 = f32_kernel(torch, fa, "flash_fwd", TF_HEAD_DIM)
    args = ["--dir", work, "--host", "127.0.0.1", "--port", "0",
            "--max-wait-ms", str(config.max_wait_ms),
            "--default-timeout-s", str(config.default_timeout_s)]
    t0 = time.perf_counter()
    procs = [spawn_worker("net_worker", args) for _ in range(2)]
    proc_rep = cluster.ProcessReplica(
        work, name="proc-0", max_wait_ms=config.max_wait_ms,
        default_timeout_s=config.default_timeout_s)
    router = None
    try:
        # the lone in-process engine: each request alone (the main path
        # here: counts reset just before, read just after)
        fa.reset_launch_counts()
        lone = ServingEngine.from_saved_model(work, config=config)
        try:
            warm = lone.warmup()
            alone, lone_ms = [], []
            for r in reqs:
                t = time.perf_counter()
                alone.append(lone.infer(r, timeout=600.0))
                lone_ms.append((time.perf_counter() - t) * 1e3)
            lone.assert_no_recompiles()
            lone_batches = lone.stats()["batches_total"]
        finally:
            lone.close()
        by_kernel = launches_by_kernel(fa)
        dispatches = warm["signatures"] + lone_batches
        check(by_kernel[k1] == n_dec * dispatches
              and not fa_others(by_kernel, k1),
              f"{tag}: the lone engine's launches {by_kernel} != {n_dec} "
              f"x {dispatches} dispatches on {k1}")

        addrs = [worker_addr(p, tag) for p in procs]
        spawn_s = time.perf_counter() - t0
        inf = fluid.Inferencer.from_inference_model(work)
        router = inf.serve(remotes=addrs)
        check(isinstance(router, cluster.Router),
              f"{tag}: serve(remotes=) gave {type(router).__name__}")
        remote_ms = []
        for i, r in enumerate(reqs):
            t = time.perf_counter()
            got = router.infer(r, timeout=600.0)
            remote_ms.append((time.perf_counter() - t) * 1e3)
            check(isinstance(got[0], np.ndarray)
                  and np.array_equal(got[0], alone[i][0]),
                  f"{tag}: request {i} through the remotes differs from "
                  "the lone engine's")
        served_by = [r.stats().get("responses_total", 0)
                     for r in router.pool.replicas()]
        proc_rep.wait_ready()
        proc_ms = []
        for i, r in enumerate(reqs):
            t = time.perf_counter()
            got = proc_rep.submit(r, timeout=600.0).result(600.0)
            proc_ms.append((time.perf_counter() - t) * 1e3)
            check(np.array_equal(got[0], alone[i][0]),
                  f"{tag}: request {i} through the ProcessReplica differs "
                  "from the lone engine's")

        dest = fleet_workdir("provisioned")
        t0 = time.perf_counter()
        prov = cluster.provision_from_remote(addrs[0], dest)
        prov_s = time.perf_counter() - t0
        check(dir_manifest(dest) == dir_manifest(work)
              and prov["files"] == len(dir_manifest(work)),
              f"{tag}: the provisioned directory's sha256s differ "
              f"({prov})")

        def remote_call(i):
            # batched with other clients' requests: another GEMM shape
            # than alone, so held at the float32 tier, not bit for bit
            got = router.infer(reqs[i], timeout=600.0)
            check(rel_rms(got[0], alone[i][0]) <= TOL_LOGITS_REL_RMS_F32,
                  f"request {i} answered beyond the f32 tier under the "
                  "drill")

        before = router.pool.stats()
        with ChaosLoad(remote_call, len(reqs)) as load:
            time.sleep(1.0)
            t1 = time.perf_counter()
            procs[1].kill()                 # kill -9
            procs[1].wait(30)
            ok_at_kill = load.ok_count()
            time.sleep(2.0)
            ok_after = load.ok_count() - ok_at_kill
        kill_s = time.perf_counter() - t1
        # a request in flight on the killed server resolves with the
        # typed, retriable RemoteUnavailableError (Router.infer fails
        # over on a dead worker or a closed engine, as the reference's);
        # every later request is re-routed and answered
        load.check_nothing_lost(tag, typed_ok="RemoteUnavailableError",
                                most=FLEET_CLIENTS)
        check(ok_after > 0, f"{tag}: nothing answered after the kill")
        after = router.pool.stats()
        rerouted = sum(after[k] - before[k]
                       for k in ("reroutes_total", "failovers_total"))
        dead = router.pool.replicas()[1]
        check(not dead.alive() and dead.health_state() != "READY",
              f"{tag}: the killed server's replica is still in rotation "
              f"({dead.health_state()})")
        router.close()
        router = None
        deploy = fleet_deploy(tag, work, reqs, config)
    finally:
        if router is not None:
            router.close()
        proc_rep.close()
        stop_workers(procs)
    stats = {"requests": len(reqs), "servers": 2, "spawn_s": spawn_s,
             "lone_request_ms": pct_ms(lone_ms),
             "remote_request_ms": pct_ms(remote_ms),
             "process_replica_request_ms": pct_ms(proc_ms),
             "remote_overhead_p50_ms": float(np.median(remote_ms))
             - float(np.median(lone_ms)),
             "responses_by_server": served_by,
             "provision": dict(prov, wall_s=prov_s),
             "kill_drill": {"requests": load.outcomes,
                            "typed": load.typed_by, "window_s": kill_s,
                            "answered_after_kill": ok_after,
                            "rerouted": rerouted,
                            "killed_replica_state": str(
                                dead.health_state())},
             "deploy": deploy, "k1_launches_lone": by_kernel[k1],
             "phase_s": time.perf_counter() - t_phase, "card": card}
    log(f"{tag}: " + json.dumps(stats))
    return by_kernel, stats


def fleet_deploy(tag, work, reqs, config):
    """Two canaries through a ``DeploymentManager`` over an in-process
    pool of two engines on ``work``, under load: v2 (the same model)
    promotes; v3 (every weight x 1.01) fails the golden-set numerics
    gate and rolls back. Returns the reports' summary."""
    from paddle_tpu_torch import cluster
    from paddle_tpu_torch.serving import ServingEngine

    def v1():
        return ServingEngine.from_saved_model(work, config=config)

    def perturbed():
        eng = ServingEngine.from_saved_model(work, config=config)
        for t in eng.scope.vars.values():
            if hasattr(t, "is_floating_point") and t.is_floating_point():
                t.mul_(1.01)
        return eng

    router = cluster.serve_cluster(v1, replicas=2, warmup=True)
    try:
        mgr = cluster.DeploymentManager(router)
        mgr.register("v1", factory=v1)
        mgr.register("v2", factory=v1)
        mgr.register("v3", factory=perturbed)
        mgr.set_incumbent("v1")
        golden = reqs[:4]
        mgr.record_golden(golden, save=False)

        def call(i):
            router.infer(reqs[i], timeout=600.0)

        t0 = time.perf_counter()
        with ChaosLoad(call, len(reqs)) as load:
            good = mgr.deploy_canary("v2", replicas=1)
            check(good["accepted"] and good["numerics"]["ok"],
                  f"{tag}: the v1-equal canary was rejected: "
                  f"{good.get('rejected')} {good.get('numerics')}")
            promo = mgr.promote(stages=(0.5, 1.0), stage_s=1.0,
                                poll_s=0.05)
            check(promo["accepted"] and mgr.incumbent == "v2",
                  f"{tag}: promotion of v2 {promo.get('rejected')}: "
                  f"{promo.get('reason')}")
            mgr.record_golden(golden, save=False)
            bad = mgr.deploy_canary("v3", replicas=1)
            check(not bad["accepted"] and bad["rejected"] == "numerics"
                  and bad["rollback"]["action"] == "rollback",
                  f"{tag}: the perturbed canary was not rolled back: "
                  f"{bad.get('rejected')}")
            check(mgr.canary is None and mgr.incumbent == "v2"
                  and router.weights() == {"v2": 1.0}
                  and all(r.version == "v2"
                          for r in router.pool.replicas()),
                  f"{tag}: after the rollback {mgr.status()['weights']}")
        load.check_nothing_lost(f"{tag} deploy")
        return {"wall_s": time.perf_counter() - t0,
                "requests": load.outcomes,
                "v2": {"accepted": True,
                       "rewarm_compiles": good["rewarm_compiles"],
                       "promote_rewarm_compiles":
                           promo.get("rewarm_compiles")},
                "v3": {"rejected": bad["rejected"],
                       "worst": bad["numerics"].get("worst"),
                       "rollback_rewarm_compiles":
                           bad["rollback"]["rewarm_compiles"]}}
    finally:
        router.close(drain=True)


def phase_cluster_decode(torch, fluid, fa, card, dec):
    """The decode engine behind a pool on the card, at the
    ``decode_engine`` phase's depth (DEC_LAYERS of the 8B width, bf16)
    and weights: those weights saved with ``save_persistables`` and
    loaded by ``Inferencer(infer_func, param_path)``, whose
    ``serve_decode(cfg, replicas=2)`` is the pool; one replica takes the
    prefill role (``prefill_only`` submits that come back as KV handoff
    blobs) and one the decode role, and ``Router.generate`` serves that
    phase's DEC_REQUESTS prompts from DEC_CLIENTS clients: the tokens
    equal the lone engine's, every request crosses one handoff
    (exported and imported once each), no step build after warmup, and
    the paged ops launch no attention kernel. Returns (launches by
    kernel symbol, stats)."""
    from paddle_tpu_torch.models.llama import build_llama_generator
    from paddle_tpu_torch.serving import DecodeConfig

    tag = "cluster_decode"
    t_phase = time.perf_counter()
    cfg, scope, prompts, outs = (dec[k] for k in ("cfg", "scope",
                                                  "prompts", "outs"))
    gen, _, _ = gen_programs(fluid, cfg, DEC_PROMPT_RANGE[1],
                             max_new_tokens=1)
    params = fleet_workdir("decode_params")
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(fluid.Executor(), params,
                                   main_program=gen)

    def infer_func():
        ptok = fluid.layers.data(name="ptok",
                                 shape=[-1, DEC_PROMPT_RANGE[1]],
                                 dtype="int64", append_batch_size=False)
        return build_llama_generator(cfg, ptok, max_new_tokens=1)

    inf = fluid.Inferencer(infer_func, params)      # the card
    load_s = time.perf_counter() - t0
    new = DEC_CONFIG["max_new_tokens"]
    # the main path: counts reset just before, read just after
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    router = inf.serve_decode(cfg, config=DecodeConfig(
        default_timeout_s=900.0, **DEC_CONFIG), replicas=2, warmup=True)
    try:
        up_s = time.perf_counter() - t0
        reps = router.pool.replicas()
        reps[0].role, reps[1].role = "prefill", "decode"
        engines = [r.engine for r in reps]
        check(all(e.scope is inf.scope for e in engines),
              f"{tag}: the decode engines do not share the Inferencer's "
              "scope")
        got, ms = [None] * len(prompts), [None] * len(prompts)

        def client(k):
            for i in range(k, len(prompts), DEC_CLIENTS):
                t = time.perf_counter()
                got[i] = np.asarray(router.generate(
                    prompts[i], max_new=new, timeout=900.0))
                ms[i] = (time.perf_counter() - t) * 1e3

        t0 = time.perf_counter()
        with ThreadPoolExecutor(DEC_CLIENTS) as pool:
            list(pool.map(client, range(DEC_CLIENTS)))
        wall = time.perf_counter() - t0
        by_kernel = launches_by_kernel(fa)
        for e in engines:
            e.assert_no_recompiles()
        est = [e.stats() for e in engines]
        pst = router.pool.stats()
    finally:
        router.close(drain=True)
    same = [i for i, (g, w) in enumerate(zip(got, outs))
            if g is None or not np.array_equal(g, np.asarray(w))]
    check(not same, f"{tag}: requests {same} differ from the lone "
                    "engine's tokens")
    exports, imports = (est[0]["handoff_export_total"],
                        est[1]["handoff_import_total"])
    check(exports == imports == len(prompts)
          and pst["handoffs_total"] == len(prompts)
          and est[0].get("handoff_import_total", 0) == 0
          and est[1].get("handoff_export_total", 0) == 0,
          f"{tag}: handoffs exported {exports}, imported {imports}, "
          f"routed {pst['handoffs_total']} for {len(prompts)} requests")
    check(not any(by_kernel.values()),
          f"{tag}: the paged ops launched attention kernels {by_kernel}")
    stats = {"layers": cfg.n_layers, "requests": len(prompts),
             "clients": DEC_CLIENTS, "save_and_load_s": load_s,
             "pool_up_s": up_s, "wave_s": wall,
             "tokens_per_s": sum(len(g) for g in got) / wall,
             "request_ms": pct_ms(ms),
             "handoffs": {"exported": exports, "imported": imports,
                          "redrives": pst["handoff_redrives_total"]},
             "ttft_ms_prefill_replica": {
                 k: est[0]["ttft_s"][k] for k in ("p50_ms", "p99_ms")},
             "phase_s": time.perf_counter() - t_phase, "card": card}
    log(f"{tag}: " + json.dumps(stats))
    del inf
    return by_kernel, stats


def phase_train_fabric(torch, fluid, fa, card):
    """The train fabric on the card: a ``TrainCoordinator`` over
    ``python -m paddle_tpu_torch.cluster.train_worker`` processes
    computing ``ProgramGradTask`` (its defaults, the reference's one
    program task) gradient sums, TRAIN_FABRIC_STEPS steps, commits every
    TRAIN_FABRIC_COMMIT, TRAIN_FABRIC_SHARDS shards. The uninterrupted
    two-worker run's parameter sha is held by a one-worker run, by a run
    whose worker dies at step TRAIN_FABRIC_CRASH_STEP
    (``trainer_crash_at_step``, a hard exit) and is replaced by one that
    provisions over the wire and rejoins, and by a ``coordinator_crash``
    run resumed by a new coordinator; its parameters within
    TOL_TRAIN_FABRIC_CPU of the same run on the CPU (in-process workers).
    Returns (launches by kernel symbol in this process, stats)."""
    from paddle_tpu_torch.cluster.train_fabric import (ProgramGradTask,
                                                       TrainCoordinator)
    from paddle_tpu_torch.cluster.train_worker import TrainWorkerServer
    from paddle_tpu_torch.resilience import faultinject
    from paddle_tpu_torch.resilience.checkpoint import state_sha

    tag = "train_fabric"
    t_phase = time.perf_counter()
    root = fleet_workdir("train")

    def worker(name, *extra, env=None):
        return spawn_worker("train_worker", [
            "--host", "127.0.0.1", "--port", "0",
            "--artifact-dir", os.path.join(root, f"af_{name}"),
            *extra], env=env)

    t0 = time.perf_counter()
    w1, w2 = worker("w1"), worker("w2")
    w3 = worker("w3", "--hard-exit", env={
        "PADDLE_TPU_FAULTS":
            f"trainer_crash_at_step@{TRAIN_FABRIC_CRASH_STEP - 1}"})
    procs = [w1, w2, w3]
    runs = {}

    def coordinator(name, addrs):
        return TrainCoordinator(
            ProgramGradTask(), addrs, os.path.join(root, name),
            commit_interval=TRAIN_FABRIC_COMMIT,
            n_shards=TRAIN_FABRIC_SHARDS, step_deadline_s=120.0,
            admit_deadline_s=60.0, readmit_interval_s=0.1)

    def finish(name, co, t_start, steps):
        runs[name] = {"commits": co.commits(), "sha": state_sha(co.state),
                      "state": {k: np.array(v) for k, v in
                                co.state.items()},
                      "step_ms": (time.perf_counter() - t_start) * 1e3
                      / steps, "evictions": co.evictions_total,
                      "rejoins": co.rejoins_total}
        co.close()

    try:
        a1, a2, a3 = (worker_addr(p, tag) for p in procs)
        # the replacement provisions from w1 while the first runs go
        w4 = worker("w4", "--provision-from", a1)
        procs.append(w4)
        spawn_s = time.perf_counter() - t0
        fa.reset_launch_counts()
        for name, addrs in (("two_workers", [a1, a2]),
                            ("one_worker", [a1])):
            co = coordinator(name, addrs)
            t0 = time.perf_counter()
            co.run(TRAIN_FABRIC_STEPS)
            finish(name, co, t0, TRAIN_FABRIC_STEPS)
        # a worker dies at the crash step; the replacement rejoins
        co = coordinator("trainer_crash", [a3, a1])
        t0 = time.perf_counter()
        co.run(TRAIN_FABRIC_CRASH_STEP)
        w3.wait(60)
        check(co.evictions_total >= 1 and w3.returncode is not None,
              f"{tag}: the crashed worker was not evicted "
              f"(evictions {co.evictions_total}, rc {w3.returncode})")
        t1 = time.perf_counter()
        a4 = worker_addr(w4, tag)
        client = co.admit(a4)
        co.run(TRAIN_FABRIC_STEPS - TRAIN_FABRIC_CRASH_STEP)
        rejoin_s = time.perf_counter() - t1
        check(client.admitted and w4.poll() is None,
              f"{tag}: the replacement worker was not admitted")
        finish("trainer_crash", co, t0, TRAIN_FABRIC_STEPS)
        # the coordinator dies before step TRAIN_FABRIC_CRASH_STEP + 1; a
        # new one resumes from the last commit
        co = coordinator("coordinator_crash", [a1, a2])
        t0 = time.perf_counter()
        faultinject.arm("coordinator_crash", at=TRAIN_FABRIC_CRASH_STEP)
        try:
            co.run(TRAIN_FABRIC_STEPS)
            check(False, f"{tag}: the coordinator crash never fired")
        except faultinject.SimulatedCrash:
            pass
        finally:
            faultinject.disarm()
        check(co.step == TRAIN_FABRIC_CRASH_STEP,
              f"{tag}: the coordinator crashed at step {co.step}")
        co.close()
        co = coordinator("coordinator_crash", [a1, a2])
        resumed_at = co.step
        check(resumed_at == TRAIN_FABRIC_CRASH_STEP
              // TRAIN_FABRIC_COMMIT * TRAIN_FABRIC_COMMIT,
              f"{tag}: the new coordinator resumed at step {resumed_at}")
        co.run(TRAIN_FABRIC_STEPS - resumed_at)
        finish("coordinator_crash", co, t0, TRAIN_FABRIC_STEPS)
        by_kernel = launches_by_kernel(fa)
    finally:
        faultinject.disarm()
        stop_workers(procs)
    # the same run on the CPU, in-process workers on the host
    host = [TrainWorkerServer(place=fluid.CPUPlace()) for _ in range(2)]
    try:
        co = coordinator("cpu", [w.addr for w in host])
        t0 = time.perf_counter()
        co.run(TRAIN_FABRIC_STEPS)
        finish("cpu", co, t0, TRAIN_FABRIC_STEPS)
    finally:
        for w in host:
            w.close()
    want = runs["two_workers"]
    for name in ("one_worker", "trainer_crash", "coordinator_crash"):
        check(runs[name]["sha"] == want["sha"]
              and runs[name]["commits"][-1] == want["commits"][-1],
              f"{tag}: the {name} run's parameter sha "
              f"{runs[name]['sha'][:12]} != the two-worker run's "
              f"{want['sha'][:12]}")
    rtol, atol = TOL_TRAIN_FABRIC_CPU
    cpu_err = 0.0
    for name, v in want["state"].items():
        c = runs["cpu"]["state"][name]
        cpu_err = max(cpu_err, float(np.abs(v - c).max()))
        check(np.allclose(v, c, rtol=rtol, atol=atol),
              f"{tag}: {name} on the card vs the CPU beyond rtol {rtol}, "
              f"atol {atol} (max |d| {cpu_err:.3e})")
    check(not any(by_kernel.values()),
          f"{tag}: this process launched attention kernels {by_kernel}")
    stats = {"steps": TRAIN_FABRIC_STEPS,
             "commit_interval": TRAIN_FABRIC_COMMIT,
             "shards": TRAIN_FABRIC_SHARDS, "spawn_s": spawn_s,
             "step_ms": {n: r["step_ms"] for n, r in runs.items()},
             "sha": want["sha"][:16], "resumed_at": resumed_at,
             "replacement_rejoin_s": rejoin_s,
             "max_abs_vs_cpu": cpu_err,
             "phase_s": time.perf_counter() - t_phase, "card": card}
    log(f"{tag}: " + json.dumps(stats))
    return by_kernel, stats


# serving_chaos: the serving engines' failure paths
CHAOS_COOLDOWN_S = 0.5          # the breaker's cooldown
CHAOS_BACKOFF_S = 0.01          # the retry policies' first backoff
CHAOS_WATCHDOG_S = 0.05         # the watchdog's interval
CHAOS_DETECT_S = 5.0            # bound on the watchdog's detection
CHAOS_SLOW_S = 1.0              # a wedged dispatch (serving_slow_batch)
CHAOS_DRAIN_DEADLINE_S = 0.2    # close(drain=True)'s budget against it
CHAOS_DEC_REQUESTS = 8          # the decode wave under a device error


def recording_sleep(delays):
    """A retry policy's ``sleep`` that records each delay, then sleeps."""
    def sleep(d):
        delays.append(d)
        time.sleep(d)
    return sleep


def raises(exc_type, fn):
    """True iff ``fn()`` raises ``exc_type``; any other outcome fails."""
    try:
        fn()
    except exc_type:
        return True
    return False


def phase_serving_chaos(torch, fluid, fa, card, served):
    """The serving engine's failure paths on the card, at the Llama-3-8B
    width with all 32 layers in bf16, on ``phase_serve``'s scope, program
    and buckets (no weights built again), each fault armed through
    ``resilience.faultinject`` as the CPU tests arm it
    (tests/test_torch_serving_chaos.py):

    1. breaker: an engine with ``breaker_threshold=2`` and a one-attempt
       policy; ``serving_device_error`` twice fails two requests with
       ``TransientDeviceError``, opens the engine's and the bucket's
       breakers (health DEGRADED), and a submit is shed with
       ``ServiceUnavailableError``, K1 not moving across the failures
       and the shed (the fault fires before ``exe.run``); after the
       cooldown the half-open probe answers with the logits of the same
       request served alone by the healthy engine bit for bit (the same
       bucket), the breaker closes, health reads READY, no step build
       after warmup;
    2. retry: the policy at 3 attempts and the fault twice: one answer,
       ``retries_total`` 2, the backoff schedule, the same logits;
    3. drain: ``serving_slow_batch`` on the first of 8 requests, then
       ``close(drain=True)``: all 8 answered;
    4. watchdog, on a second engine: ``serving_worker_crash`` fails the
       pending request with ``WorkerDiedError`` within CHAOS_DETECT_S,
       ``start()`` revives it and the next request answers bit-equal;
       then every dispatch wedged CHAOS_SLOW_S: ``close(drain=True,
       drain_timeout=CHAOS_DRAIN_DEADLINE_S)`` returns within the wedged
       dispatch, every request answered or refused with
       ``ServerClosedError``;
    5. executor: ``Executor(retry_policy=)`` runs the served program;
       ``device_error`` twice gives one answer after two recorded
       sleeps, equal bit for bit; past the policy ``TransientDeviceError``
       is raised, and a plain run afterwards answers the same logits.

    K1 adds exactly 32 launches for each dispatch that computed, none
    for one that failed or was shed. Returns (launches by kernel symbol,
    stats: the windows in seconds, K1 launches by step, the counters)."""
    from paddle_tpu_torch.resilience import faultinject
    from paddle_tpu_torch.resilience.retry import (RetryPolicy,
                                                   TransientDeviceError)
    from paddle_tpu_torch.serving import (HealthState, ServerClosedError,
                                          ServiceUnavailableError,
                                          ServingConfig, ServingEngine,
                                          WorkerDiedError)

    tag = "serving_chaos"
    t_phase = time.perf_counter()
    cfg, infer, logits, scope, buckets, reqs, alone = (served[k] for k in (
        "cfg", "infer", "logits", "scope", "buckets", "reqs", "alone"))
    per = cfg.n_layers                  # K1 launches a computed dispatch
    feed = {"tokens": reqs[0]}          # 40 tokens: the (1, 128) bucket
    windows, steps, counts = {}, {}, {}

    def k1():
        return fa.flash_fwd.launches

    def engine_of(**config):
        return ServingEngine(infer, ["tokens"], [logits], scope=scope,
                             buckets=buckets, auto_start=False,
                             config=ServingConfig(max_wait_ms=5.0,
                                                  default_timeout_s=600.0,
                                                  **config))

    sleeps = []
    policy = RetryPolicy(max_attempts=1, initial_backoff=CHAOS_BACKOFF_S,
                         sleep=recording_sleep(sleeps))
    slow_env = os.environ.get("PADDLE_TPU_FAULT_SLOW_S")
    faultinject.disarm()
    # the main path: counts reset just before, read just after
    fa.reset_launch_counts()
    engine = engine_of(breaker_threshold=2,
                       breaker_cooldown_s=CHAOS_COOLDOWN_S,
                       retry_policy=policy).start()
    try:
        warm = engine.warmup()
        steps["warmup"] = k1()
        check(steps["warmup"] == per * warm["signatures"],
              f"{tag}: warmup K1 {steps['warmup']} != {per} x "
              f"{warm['signatures']} signatures")
        n0 = k1()
        healthy = engine.infer(feed, timeout=600.0)[0]
        steps["healthy"] = k1() - n0
        check(np.isfinite(healthy).all(), f"{tag}: non-finite logits")

        # 1. the breaker: open, shed, half-open, recover
        n0 = k1()
        faultinject.arm("serving_device_error", at=0, times=2)
        failed = [raises(TransientDeviceError,
                         lambda: engine.infer(feed, timeout=600.0))
                  for _ in range(2)]
        t_open = time.perf_counter()
        faultinject.disarm("serving_device_error")
        opened = engine.stats()
        check(failed == [True, True]
              and opened["health_state"] == HealthState.DEGRADED
              and opened["breaker"]["state"] == "open"
              and opened["breaker_open_total"] == 2
              and opened["errors_total"] == 2
              and opened["bucket_breakers_not_closed"],
              f"{tag}: after two injected failures {failed}: health "
              f"{opened['health_state']}, breaker {opened['breaker']}, "
              f"opened {opened['breaker_open_total']}, errors "
              f"{opened['errors_total']}, bucket breakers "
              f"{opened['bucket_breakers_not_closed']}")
        shed = raises(ServiceUnavailableError, lambda: engine.submit(feed))
        counts["breaker_shed_total"] = engine.stats()["breaker_shed_total"]
        check(shed and counts["breaker_shed_total"] == 1,
              f"{tag}: the open breaker did not shed the submit ({shed}, "
              f"{counts['breaker_shed_total']})")
        steps["failures_and_shed"] = k1() - n0
        time.sleep(max(0.0, CHAOS_COOLDOWN_S
                       - (time.perf_counter() - t_open)) + 0.05)
        n0 = k1()
        probe = engine.infer(feed, timeout=600.0)[0]
        windows["breaker_open_to_recovered_s"] = time.perf_counter() - t_open
        steps["probe"] = k1() - n0
        recovered = engine.stats()
        check(recovered["breaker"]["state"] == "closed"
              and recovered["health_state"] == HealthState.READY
              and recovered["breaker_probe_total"] == 1,
              f"{tag}: after the probe: breaker {recovered['breaker']}, "
              f"health {recovered['health_state']}, probes "
              f"{recovered['breaker_probe_total']}")
        check(probe.shape == healthy.shape and np.array_equal(probe, healthy),
              f"{tag}: the probe's logits differ from the healthy engine's "
              f"(max |d| {float(np.abs(probe - healthy).max()):.3e})")
        engine.assert_no_recompiles()

        # 2. retry: the same policy object, now three attempts
        policy.max_attempts = 3
        n0 = k1()
        faultinject.arm("serving_device_error", at=0, times=2)
        retried = engine.infer(feed, timeout=600.0)[0]
        faultinject.disarm("serving_device_error")
        steps["retry"] = k1() - n0
        st = engine.stats()
        counts.update({k: st[k] for k in (
            "retries_total", "errors_total", "breaker_open_total",
            "breaker_probe_total")})
        check(counts["retries_total"] == 2 and counts["errors_total"] == 2
              and sleeps == [CHAOS_BACKOFF_S, 2 * CHAOS_BACKOFF_S],
              f"{tag}: retried request: {counts}, sleeps {sleeps}")
        check(np.array_equal(retried, healthy),
              f"{tag}: the retried request's logits differ from the "
              "healthy engine's")

        # 3. graceful drain: 8 requests, the first batch slowed
        n0 = k1()
        before = engine.stats()
        faultinject.arm("serving_slow_batch", at=0, times=1)
        pending = [engine.submit({"tokens": r}, timeout=600.0) for r in reqs]
        t0 = time.perf_counter()
        engine.close(drain=True, drain_timeout=600.0)
        windows["drain_s"] = time.perf_counter() - t0
        faultinject.disarm("serving_slow_batch")
        answers = [p.result(timeout=1.0)[0] for p in pending]
        drained = engine.stats()
        batches = drained["batches_total"] - before["batches_total"]
        steps["drain"] = k1() - n0
        counts["drained_total"] = drained["drained_total"]
        check(drained["responses_total"] - before["responses_total"]
              == len(reqs) and drained["errors_total"] == 2
              and drained["health_state"] == HealthState.STOPPED,
              f"{tag}: the drain answered "
              f"{drained['responses_total'] - before['responses_total']} of "
              f"{len(reqs)} (errors {drained['errors_total']}, health "
              f"{drained['health_state']})")
        check(steps["drain"] == per * batches,
              f"{tag}: the drain's K1 {steps['drain']} != {per} x {batches} "
              "batches")
        worst = 0.0
        for r, got, want in zip(reqs, answers, alone):
            got = got[:, :r.shape[1]]
            check(np.isfinite(got).all(), f"{tag}: non-finite drain answer")
            worst = max(worst, float(np.sqrt(
                ((got - want) ** 2).mean() / (want ** 2).mean())))
        check(worst <= TOL_LOGITS_BF16_RMS,
              f"{tag}: a drained answer differs from its request alone by "
              f"rel rms {worst:.3e}")
        check(raises(ServerClosedError, lambda: engine.submit(feed)),
              f"{tag}: the stopped engine admitted a request")
    finally:
        faultinject.disarm()
        engine.close()

    # 4. the watchdog, then the drain deadline, on a second engine
    engine = engine_of(watchdog_interval_s=CHAOS_WATCHDOG_S)
    try:
        pending = engine.submit(feed, timeout=600.0)
        n0 = k1()
        faultinject.arm("serving_worker_crash", at=0, times=1)
        t0 = time.perf_counter()
        engine.start()                      # the worker dies at once
        died = raises(WorkerDiedError, lambda: pending.result(timeout=60.0))
        windows["watchdog_detection_s"] = time.perf_counter() - t0
        faultinject.disarm("serving_worker_crash")
        st = engine.stats()
        check(died and st["worker_died_total"] == 1
              and st["health_state"] == HealthState.DEGRADED
              and windows["watchdog_detection_s"] < CHAOS_DETECT_S,
              f"{tag}: the crashed worker's request: WorkerDiedError "
              f"{died} after {windows['watchdog_detection_s']:.3f} s, "
              f"deaths {st['worker_died_total']}, health "
              f"{st['health_state']}")
        steps["worker_crash"] = k1() - n0
        n0 = k1()
        t0 = time.perf_counter()
        engine.start()
        ready = engine.stats()["health_state"]
        revived = engine.infer(feed, timeout=600.0)[0]
        windows["restart_s"] = time.perf_counter() - t0
        steps["restart"] = k1() - n0
        counts["worker_died_total"] = engine.stats()["worker_died_total"]
        check(ready == HealthState.READY and counts["worker_died_total"] == 1
              and np.array_equal(revived, healthy),
              f"{tag}: after the restart: health {ready}, deaths "
              f"{counts['worker_died_total']}, logits equal "
              f"{np.array_equal(revived, healthy)}")
        # every dispatch wedged: the drain deadline binds
        n0 = k1()
        before = engine.stats()
        os.environ["PADDLE_TPU_FAULT_SLOW_S"] = str(CHAOS_SLOW_S)
        faultinject.arm("serving_slow_batch", at=0, times=len(reqs))
        pending = [engine.submit({"tokens": r}, timeout=600.0) for r in reqs]
        t0 = time.perf_counter()
        engine.close(drain=True, drain_timeout=CHAOS_DRAIN_DEADLINE_S)
        windows["drain_deadline_close_s"] = time.perf_counter() - t0
        outcome = {"served": 0, "refused": 0}
        for p in pending:
            if raises(ServerClosedError, lambda: p.result(timeout=10.0)):
                outcome["refused"] += 1
            else:
                p.result(timeout=0)
                outcome["served"] += 1
        after = engine.stats()
        batches = after["batches_total"] - before["batches_total"]
        steps["drain_deadline"] = k1() - n0
        counts["drain_deadline"] = outcome
        check(windows["drain_deadline_close_s"] < CHAOS_SLOW_S + 2.0
              and outcome["refused"] >= 1 and outcome["served"] >= 1
              and sum(outcome.values()) == len(reqs),
              f"{tag}: the drain deadline: close took "
              f"{windows['drain_deadline_close_s']:.3f} s against a "
              f"{CHAOS_SLOW_S} s wedged dispatch, outcome {outcome}")
        check(steps["drain_deadline"] == per * batches,
              f"{tag}: the wedged drain's K1 {steps['drain_deadline']} != "
              f"{per} x {batches} batches")
    finally:
        faultinject.disarm()
        if slow_env is None:
            os.environ.pop("PADDLE_TPU_FAULT_SLOW_S", None)
        else:
            os.environ["PADDLE_TPU_FAULT_SLOW_S"] = slow_env
        engine.close()

    # 5. the executor's own retry, on the served program
    ex_sleeps = []
    exe = fluid.Executor(retry_policy=RetryPolicy(
        max_attempts=3, initial_backoff=CHAOS_BACKOFF_S,
        sleep=recording_sleep(ex_sleeps)))
    batch, _, _ = buckets.pad_batch([feed])

    def run():
        return exe.run(infer, feed=batch, fetch_list=[logits], scope=scope,
                       mode="test")[0]

    try:
        n0 = k1()
        faultinject.arm("device_error", at=0, times=2)
        # the retry warnings recorded; the run's error filters still raise
        with warnings.catch_warnings(record=True) as caught:
            warnings.filterwarnings("always",
                                    message=".*transient device error.*")
            out = run()
        faultinject.disarm("device_error")
        steps["executor_retry"] = k1() - n0
        retry_warnings = sum("transient device error" in str(w.message)
                             for w in caught)
        check(ex_sleeps == [CHAOS_BACKOFF_S, 2 * CHAOS_BACKOFF_S]
              and retry_warnings == 2 and np.array_equal(out, healthy),
              f"{tag}: the executor's retried run: sleeps {ex_sleeps}, "
              f"warnings {retry_warnings}, logits equal "
              f"{np.array_equal(out, healthy)}")
        n0 = k1()
        spec = faultinject.arm("device_error", at=0, times=10)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore",
                                    message=".*transient device error.*")
            exhausted = raises(TransientDeviceError, run)
        faultinject.disarm("device_error")
        steps["executor_exhausted"] = k1() - n0
        n0 = k1()
        plain = run()
        steps["executor_plain"] = k1() - n0
        check(exhausted and spec.fired == 3 and np.array_equal(plain, healthy),
              f"{tag}: past the policy: raised {exhausted} after "
              f"{spec.fired} attempts; the plain run equal "
              f"{np.array_equal(plain, healthy)}")
    finally:
        faultinject.disarm()
    by_kernel = launches_by_kernel(fa)
    computed = ("healthy", "probe", "retry", "restart", "executor_retry",
                "executor_plain")
    check(all(steps[s] == per for s in computed)
          and steps["failures_and_shed"] == steps["worker_crash"]
          == steps["executor_exhausted"] == 0
          and by_kernel[bf16_k1(torch, fa, cfg)] == k1()
          and not fa_others(by_kernel, bf16_k1(torch, fa, cfg)),
          f"{tag}: K1 launches by step {steps} (by kernel {by_kernel}): "
          f"{per} for each computed dispatch, 0 for a failed one")
    stats = {"layers": cfg.n_layers, "windows_s": windows,
             "k1_launches_by_step": steps, "counters": counts,
             "k1_launches": k1(), "phase_s": time.perf_counter() - t_phase,
             "card": card}
    return by_kernel, stats


def phase_serving_chaos_decode(torch, fluid, fa, card, dec):
    """The decode engine's ``serving_device_error`` point on the card, on
    the ``decode_engine`` phase's weights (DEC_LAYERS of the 8B width,
    bf16) and config: a new ``DecodeEngine`` with a three-attempt policy,
    one injected device error, CHAOS_DEC_REQUESTS of that phase's
    prompts from DEC_CLIENTS clients: the error retried once on the
    policy's backoff, nothing failed, the breaker closed, no step build
    after warmup, and the tokens equal to the unfaulted wave's. Returns
    (launches by kernel symbol, stats)."""
    from paddle_tpu_torch.resilience import faultinject
    from paddle_tpu_torch.resilience.retry import RetryPolicy
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    tag = "serving_chaos decode"
    t_phase = time.perf_counter()
    cfg, scope = dec["cfg"], dec["scope"]
    prompts = dec["prompts"][:CHAOS_DEC_REQUESTS]
    want = dec["outs"][:CHAOS_DEC_REQUESTS]
    sleeps = []
    policy = RetryPolicy(max_attempts=3, initial_backoff=CHAOS_BACKOFF_S,
                         sleep=recording_sleep(sleeps))
    faultinject.disarm()
    # the main path: counts reset just before, read just after
    fa.reset_launch_counts()
    engine = DecodeEngine(cfg, scope=scope, config=DecodeConfig(
        default_timeout_s=900.0, retry_policy=policy, **DEC_CONFIG))
    try:
        warm = engine.warmup()
        faultinject.arm("serving_device_error", at=0, times=1)
        got, wall, _ = dec_serve(engine, prompts, DEC_CLIENTS)
        faultinject.disarm("serving_device_error")
        engine.assert_no_recompiles()
        st = engine.stats()
    finally:
        faultinject.disarm()
        engine.close(drain=True)
    by_kernel = launches_by_kernel(fa)
    counts = {k: st[k] for k in ("retries_total", "errors_total",
                                 "breaker_open_total", "retired_total",
                                 "warmup_compiles")}
    check(counts["retries_total"] == 1 and counts["errors_total"] == 0
          and counts["breaker_open_total"] == 0
          and counts["retired_total"] == len(prompts)
          and sleeps == [CHAOS_BACKOFF_S]
          and st["breaker"]["state"] == "closed",
          f"{tag}: {counts}, sleeps {sleeps}, breaker {st['breaker']}")
    differ = [i for i, (g, w) in enumerate(zip(got, want))
              if not np.array_equal(np.asarray(g), np.asarray(w))]
    check(not differ, f"{tag}: requests {differ} differ from the unfaulted "
                      "wave's tokens")
    check(not any(by_kernel.values()),
          f"{tag}: the paged ops launched attention kernels {by_kernel}")
    stats = {"layers": cfg.n_layers, "requests": len(prompts),
             "warmup": warm, "wave_s": wall, "counters": counts,
             "phase_s": time.perf_counter() - t_phase, "card": card}
    return by_kernel, stats


def check_sass(cuda_build):
    """Log each kernel's count of tensor-core instructions from its
    SASS, mma.sync's (HMMA) and wgmma's (HGMMA); fail if an mma.sync
    kernel has no HMMA or a warpgroup kernel no HGMMA (one that fell
    back to mma.sync or to SIMT)."""
    counts = {"HMMA": {}, "HGMMA": {}}
    for name in cuda_build.SOURCES:
        for opcode, found in counts.items():
            for fn, n in cuda_build.sass_counts(name, opcode).items():
                found[fn] = n
                log(f"sass {name}: {fn}: {n} {opcode}")
    for opcode, kernels in (("HMMA", MMA_KERNELS),
                            ("HGMMA", WGMMA_KERNELS)):
        for kern in kernels:
            fns = {fn: n for fn, n in counts[opcode].items() if kern in fn}
            check(fns and all(fns.values()),
                  f"{kern}: no {opcode} instruction in its SASS ({fns})")
    return counts


def check_occupancy(fa, cuda_build):
    """Log the resident blocks an SM of each warpgroup kernel whose
    source is sized for a count of them (its ``BLOCKS_PER_SM``), as the
    card's occupancy calculator reports them at the kernel's shared
    memory (``fa.blocks_per_sm``); fail if one differs from its design.
    Returns {symbol: blocks}."""
    got = {}
    for route in sorted(set(fa._WGMMA_ROUTES.values())):
        want = cuda_build.constexprs(route[0]).get("BLOCKS_PER_SM")
        if want is None:
            continue
        n = got[route[1]] = fa.blocks_per_sm(route)
        log(f"occupancy {route[1]}: {n} resident blocks an SM "
            f"(BLOCKS_PER_SM {want})")
        check(n == want, f"{route[1]}: {n} resident blocks an SM, not its "
                         f"source's BLOCKS_PER_SM {want}")
    return got


def replaced_row(t, row, launches, paths):
    """The kernel line's row of the mma.sync kernel that the warpgroup
    kernel of ``row`` replaced at its shape, timed and held to its plain
    version on the same inputs in phase_kernels (``t``, its timing row);
    it still runs at the head dims and routes that keep it."""
    old = t["replaced_kernel"]
    return {"name": old, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{old}.cu",
            "replaces": row["replaces"], "replaced_by": row["name"],
            "launches": launches[old],
            "launches_by_path": {p: n.get(old, 0) for p, n in paths.items()},
            "max_abs_err": t["replaced_max_abs_err"],
            "ms": t["replaced_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "launch_host_us": t["replaced_launch_host_us"],
            **{key: row[key] for key in ("shape", "card", "power_limit")}}


def free_card(torch):
    """Drop what the last phase left on the card; log the script's time
    so far (the phases' own times are the differences)."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"elapsed: {time.perf_counter() - T_START[0]:.1f} s")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.analysis import VerifyWarning
        from paddle_tpu_torch.ops import cuda_build
        from paddle_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2

    t_start = T_START[0] = time.perf_counter()
    # every Executor.run verifies its program first (the default
    # validate="1"), and the serving engine and PADDLE_TPU_OPTIMIZE
    # rewrite theirs: a finding the verifier raises as a warning, or a
    # rewrite that falls back to the unoptimized program, fails the run
    warnings.simplefilter("error", VerifyWarning)
    warnings.filterwarnings("error", message=".*rewrite failed.*")
    # save_inference_model degrading to the JSON path (no
    # __compiled__.pt2) or to an unseeded store, and an artifact store
    # bypassed, fail the run too
    warnings.filterwarnings("error", message=".*AOT export skipped.*")
    warnings.filterwarnings("error", message=".*artifact.store.*")
    try:
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi()
        log(f"device: {kind}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.device_count()} card(s)")
        log(f"nvidia-smi: {smi}")

        t0 = time.perf_counter()
        took = cuda_build.build()
        log(f"build: {sorted(cuda_build.SOURCES)} in "
            f"{time.perf_counter() - t0:.2f} s ({took})")
        for name in cuda_build.SOURCES:
            report = f"{cuda_build.library_path(name)}.log"
            if os.path.exists(report):
                for line in open(report).read().splitlines():
                    if any(w in line for w in ("Function properties",
                                               "registers", "spill",
                                               "Performance Loss")):
                        log(f"build {name}: {line.strip()}")
        check_sass(cuda_build)
        check_occupancy(fa, cuda_build)

        timing = phase_kernels(torch, fa, SEED)
        free_card(torch)
        # serving: bf16, then float32, where the answers can be held to
        # the request run alone logit for logit
        # ... and (ROADMAP item 8) the same scope behind a pool of two
        # replicas, then (the serving engine's failure paths) one engine
        # under the breaker, retry, drain, watchdog and executor drills
        fleet, chaos = {}, {}

        def cluster_serve(served):
            free_card(torch)
            fleet["cluster_serve"] = phase_cluster_serve(torch, fluid, fa,
                                                         smi, served)
            free_card(torch)
            chaos["serve"] = phase_serving_chaos(torch, fluid, fa, smi,
                                                 served)

        serve_launches, serve_bf16 = phase_serve(torch, fluid, "bfloat16",
                                                 smi, then=cluster_serve)
        free_card(torch)
        serve_f32_launches, serve_f32 = phase_serve(torch, fluid, "float32",
                                                    smi)
        free_card(torch)
        log("serve: one (4 x 256) dispatch's device ms by kind, bf16 | "
            "float32: " + json.dumps({
                s["dtype"]: {k: s["one_dispatch"].get(k, "not measured")
                             for k in ("device_busy_ms", "device_ms_by_kind")}
                for s in (serve_bf16, serve_f32)}))
        # training, the main path of slices 2 to 4
        train_launches, train = phase_train(torch, fluid, fa, smi)
        free_card(torch)
        # the reference's own train benchmark (stacked, remat, fused
        # loss): the main path whose launches the kernel line reports
        stack_launches, _ = phase_train_stack(torch, fluid, fa, smi, train)
        free_card(torch)
        # float32 training, the main path of slices 5 and 6
        parity_launches, _ = phase_train_parity(torch, fluid, fa, smi)
        free_card(torch)
        stack_parity_launches, _ = phase_train_stack_parity(torch, fluid,
                                                            fa, smi)
        free_card(torch)
        amp_launches, _ = phase_amp(torch, fluid, fa, smi)
        free_card(torch)
        phase_nan_guard(torch, fluid, fa, smi)
        free_card(torch)
        phase_plain_route(torch, fluid, fa, smi)
        free_card(torch)
        # Transformer-base: the main path of ROADMAP item 1b, then its
        # unpadded form, serving on the trained scope, card vs CPU, dropout
        tf_launches, tf_stats, trained = phase_transformer(torch, fluid, fa,
                                                          smi)
        # the main path of this slice: served through the engine's
        # default optimize; then the training path under the
        # PADDLE_TPU_OPTIMIZE rewrite, bit for bit
        tf_serve_launches, tf_serve = phase_transformer_serve(
            torch, fluid, fa, smi, trained)
        tf_opt_launches, tf_opt = phase_transformer_optimized(
            torch, fluid, fa, smi, trained, tf_stats)
        log("transformer: step ms median, unoptimized | optimized: "
            f"{tf_stats.get('step_ms_median')} | "
            f"{tf_opt['step_ms_median']}")
        phase_transformer_infer(torch, fluid, fa, smi, trained)
        tf_unpadded_launches, _, _ = phase_transformer_unpadded(
            torch, fluid, fa, smi, trained)
        del trained
        free_card(torch)
        tf_parity_launches, _ = phase_transformer_parity(torch, fluid, fa,
                                                         smi)
        free_card(torch)
        phase_dropout(torch, smi)
        free_card(torch)
        # ROADMAP item 3: path A trained through the native input
        # pipeline with a crash and a resume, then served from its saved
        # directory (the main path of this slice); path B, the 8B width
        # in bf16 from disk
        io_train_launches, _, io_run = phase_io_train_resume(
            torch, fluid, fa, smi)
        # and (item 8) that directory behind remote and process
        # replicas, provisioned over the wire, with canary deploys

        def cluster_remote(saved):
            fleet["cluster_remote"] = phase_cluster_remote(
                torch, fluid, fa, smi, saved)

        io_serve_launches, _ = phase_io_saved_serve(torch, fluid, fa, smi,
                                                    io_run,
                                                    then=cluster_remote)
        del io_run
        free_card(torch)
        io_llama_launches, _ = phase_io_llama_saved(torch, fluid, fa, smi)
        free_card(torch)
        import shutil
        shutil.rmtree(IO_ROOT, ignore_errors=True)
        # ROADMAP item 4a, the main path of this slice: the 8B width
        # generating tokens, held against the K1 recompute
        gen_launches, gen_stats = phase_generate(torch, fluid, fa, smi)
        free_card(torch)
        # the head-dim repair: K1-K3 at D = 256 on the main path
        hd_launches, _ = phase_head_dim_256(torch, fluid, fa, smi)
        free_card(torch)
        # ROADMAP item 4b, the main path of this slice: the paged decode
        # engine serving the 8B width
        # and (item 8) the engine's scope behind a prefill replica and a
        # decode replica, then a decode engine under a device error

        def cluster_decode(dec):
            fleet["cluster_decode"] = phase_cluster_decode(
                torch, fluid, fa, smi, dec)
            free_card(torch)
            chaos["decode"] = phase_serving_chaos_decode(torch, fluid, fa,
                                                         smi, dec)

        dec_launches, dec_stats = phase_decode_engine(
            torch, fluid, fa, smi, then=cluster_decode)
        free_card(torch)
        # item 8: the train fabric's workers on the card
        fleet["train_fabric"] = phase_train_fabric(torch, fluid, fa, smi)
        check(sorted(fleet) == ["cluster_decode", "cluster_remote",
                                "cluster_serve", "train_fabric"],
              f"the fleet phases that ran: {sorted(fleet)}")
        check(sorted(chaos) == ["decode", "serve"],
              f"the serving_chaos parts that ran: {sorted(chaos)}")
        shutil.rmtree(FLEET_ROOT, ignore_errors=True)
        free_card(torch)
        # ROADMAP item 5, the main path of this slice: the reference's
        # primary benchmark, ResNet-50 at 224² and batch 128, trained in
        # both layouts (with the fused updates, the conv-net remat
        # policies and the layout pass), held to the CPU in float32,
        # served after the conv + batch_norm fold; then the rest of the
        # conv family
        rn_launches, rn_trained, _ = phase_resnet50_train(torch, fluid, fa,
                                                          smi)
        rn_serve_launches, _ = phase_resnet50_serve(torch, fluid, fa, smi,
                                                    rn_trained)
        del rn_trained
        free_card(torch)
        rn_parity_launches, _ = phase_resnet_parity(torch, fluid, fa, smi)
        free_card(torch)
        zoo_launches, _ = phase_conv_zoo(torch, fluid, fa, smi)
        free_card(torch)
        # ROADMAP item 7d, the main path of this slice: ResNet-50 fed by
        # the flowers reader through the DataFeeder, under the profiler,
        # with the memory and cost readings
        flowers_launches, _ = phase_flowers_train(torch, fluid, fa, smi)
        free_card(torch)
        # ROADMAP item 6a, the main paths of this slice: the 8B width
        # through ParallelExecutor on the one card's mesh, bit-equal to
        # the plain Executor; the Mixtral width's MoE trained and
        # generating; whether the card admits two ranks
        mesh_launches, _ = phase_mesh_llama_train(torch, fluid, fa, smi)
        free_card(torch)
        moe_launches, _, moe_scope = phase_moe_train(torch, fluid, fa, smi)
        moe_gen_launches, moe_gen_stats = phase_moe_generate(
            torch, fluid, fa, smi, moe_scope)
        del moe_scope
        free_card(torch)
        # ROADMAP item 6b, the main paths of this slice: the 8B width's
        # pipelined programs (GPipe and 1F1B), the schedules themselves
        # and the ring's step
        pipe_launches, _ = phase_pipeline_llama_train(torch, fluid, fa, smi)
        free_card(torch)
        sched_launches, sched_stats = phase_pipeline_schedule(torch, fa,
                                                              smi)
        free_card(torch)
        phase_ring_attention(torch, fa, smi)
        free_card(torch)
        # ROADMAP item 7a, the main paths of this slice: DeepFM at
        # bench.py's million-row width, the stacked dynamic LSTM at its
        # width, the recommender and word2vec with sequence feeds
        ctr_launches, _ = phase_deepfm_train(torch, fluid, fa, smi)
        free_card(torch)
        lstm_launches, _ = phase_stacked_lstm_train(torch, fluid, fa, smi)
        free_card(torch)
        seq_zoo_launches, _ = phase_seq_zoo(torch, fluid, fa, smi)
        free_card(torch)
        # ROADMAP item 7b, the main path of this slice: the seq2seq
        # attention model at bench.py's width, trained and decoded
        # (greedy and beam search); SRL through the CRF, OCR through
        # CTC; the control-flow ops against the CPU
        mt_launches, _ = phase_seq2seq_train(torch, fluid, fa, smi)
        free_card(torch)
        mt_dec_launches, _ = phase_seq2seq_decode(torch, fluid, fa, smi)
        free_card(torch)
        srl_launches, _ = phase_srl_crf_train(torch, fluid, fa, smi)
        free_card(torch)
        ocr_launches, _ = phase_ocr_ctc_train(torch, fluid, fa, smi)
        free_card(torch)
        cf_launches, _ = phase_control_flow(torch, fluid, fa, smi)
        free_card(torch)
        # F14 closed, the main path of this slice: recurrent and
        # control-flow programs exported once and served at every length
        aot_launches_, _ = phase_aot_recurrent(torch, fluid, fa, smi)
        free_card(torch)
        # ROADMAP item 7c, the main path of this slice: Faster R-CNN at
        # its full width on 2 x 600 x 800, the SSD300 head with
        # detection_output and detection_map, the extras ops
        frcnn_launches, _ = phase_faster_rcnn_train(torch, fluid, fa, smi)
        free_card(torch)
        ssd_launches, _ = phase_ssd_train(torch, fluid, fa, smi)
        free_card(torch)
        extras_launches, _ = phase_detection_extras(torch, fluid, fa, smi)
        free_card(torch)
        phase_mesh_two_ranks(torch, smi)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        stop_workers()
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")

    power = smi.rsplit(",", 1)[-1].strip()
    train_shape = (f"bh={TRAIN_BATCH}*32 t={TRAIN_SEQ} d=128 causal bf16 "
                   f"(training)")
    f32_shape = "bh=8 t=256 d=128 causal f32 (train parity)"
    replaces = {"fwd": ":59", "dq": ":223", "dkv": ":189"}
    kernels = []
    # bf16 rows at the training shape (launches: this slice's main path,
    # the stacked bf16 train step, K1 with its remat recompute), then the
    # float32 K1, K2 and K3 (split-operand tensor cores; launches: the
    # f32 train step); every path's launches under "launches_by_path"
    paths = {"train": train_launches, "train_stack": stack_launches,
             "train_parity_f32": parity_launches,
             "train_stack_parity_f32": stack_parity_launches,
             **amp_launches, "transformer": tf_launches,
             "transformer_serve": tf_serve_launches,
             "transformer_optimized": tf_opt_launches,
             "transformer_unpadded": tf_unpadded_launches,
             "transformer_parity_f32": tf_parity_launches,
             "io_train_resume": io_train_launches,
             "io_saved_serve": io_serve_launches,
             "io_llama_saved": io_llama_launches,
             "serve_f32": {f32_kernel(torch, fa, "flash_fwd", 128):
                           serve_f32_launches},
             "generate": gen_launches,
             "generate_f32": gen_stats["f32"]["launches_by_kernel"],
             "head_dim_256_bf16_train": hd_launches["bf16"],
             "head_dim_256_serve": hd_launches["serve"],
             "head_dim_256_f32_train": hd_launches["f32"],
             "decode_engine_checks": dec_launches,
             "decode_engine_f32_checks": dec_stats["f32"][
                 "launches_by_kernel"],
             "resnet50_train": rn_launches,
             "resnet50_serve": rn_serve_launches,
             "resnet_parity": rn_parity_launches,
             "conv_zoo": zoo_launches,
             "flowers_train": flowers_launches,
             "mesh_llama_train": mesh_launches,
             "moe_train": moe_launches,
             "moe_generate": moe_gen_launches,
             "moe_generate_f32": moe_gen_stats["f32_launches_by_kernel"],
             "pipeline_llama_train_gpipe": pipe_launches["gpipe"],
             "pipeline_llama_train_1f1b": pipe_launches["1f1b"],
             "pipeline_schedule_gpipe": sched_launches["gpipe"],
             "pipeline_schedule_1f1b": sched_launches["1f1b"],
             **{f"pipeline_schedule_f32_{n}": by_kernel for n, by_kernel
                in sched_stats["f32"]["launches_by_kernel"].items()},
             "deepfm_train": ctr_launches,
             "stacked_lstm_train": lstm_launches,
             "seq_zoo": seq_zoo_launches,
             "seq2seq_train": mt_launches,
             "seq2seq_decode": mt_dec_launches,
             "srl_crf_train": srl_launches,
             "ocr_ctc_train": ocr_launches,
             "control_flow": cf_launches,
             "aot_recurrent": aot_launches_,
             "faster_rcnn_train": frcnn_launches,
             "ssd_train": ssd_launches,
             "detection_extras": extras_launches,
             **{name: launches for name, (launches, _) in fleet.items()},
             "serving_chaos": {
                 k: chaos["serve"][0].get(k, 0) + chaos["decode"][0].get(k, 0)
                 for k in set(chaos["serve"][0]) | set(chaos["decode"][0])}}
    for kind_, label, launches, shape in (
            ("fwd", TRAIN_LABEL, stack_launches, train_shape),
            ("dq", TRAIN_LABEL, stack_launches, train_shape),
            ("dkv", TRAIN_LABEL, stack_launches, train_shape),
            ("fwd", "f32 causal", parity_launches, f32_shape),
            ("dq", "f32 causal", parity_launches, f32_shape),
            ("dkv", "f32 causal", parity_launches, f32_shape)):
        t = timing[(kind_, label)]
        fn = t["kernel"]
        lib = fa.kernel_for(
            {"fwd": "flash_fwd", "dq": "flash_bwd_dq",
             "dkv": "flash_bwd_dkv"}[kind_],
            torch.float32 if label == "f32 causal" else torch.bfloat16,
            128)[0]
        row = {"name": fn, "route": "cuda",
               "source": f"paddle_tpu_torch/csrc/{lib}.cu",
               "replaces": "paddle_tpu/ops/pallas_attention.py"
                           + replaces[kind_],
               "launches": launches[fn],
               "launches_by_path": {p: n.get(fn, 0)
                                    for p, n in paths.items()},
               "max_abs_err": t["max_abs_err"], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"],
               "shape": shape, "card": kind, "power_limit": power}
        if label == "f32 causal":
            # the float32 kernel where its grid fills the card, timed and
            # held to its plain version in phase_kernels (not launched on
            # the main path)
            long = dict(timing[(kind_, F32_LONG_LABEL)])
            long.pop("kernel")
            row["t2048"] = dict(long, shape=f"bh={TRAIN_BATCH}*32 "
                                f"t={TRAIN_SEQ} d=128 causal f32")
            # and at pipeline_schedule's float32 stage's shape; launches:
            # that phase's float32 schedules
            pipe = dict(timing[(kind_, F32_PIPE_LABEL)])
            pipe.pop("kernel")
            row["t512"] = dict(
                pipe, shape=f"bh=32 t={SCHED_F32_SEQ} d=128 causal f32",
                launches=sum(n.get(fn, 0) for p, n in paths.items()
                             if p.startswith("pipeline_schedule_f32_")))
        row.update((key, t[key]) for key in REPLACED_KEYS if key in t)
        if kind_ == "fwd":
            # K1 at this dtype's serving shape, timed and held to its
            # plain version in phase_kernels; launches: that serve phase
            # and at the other serving bucket (T 128); launches: that
            # serve phase's, in both buckets
            f32 = label == "f32 causal"
            dt = "f32" if f32 else "bf16"
            for key, bucket in (("serving", 256), ("serving_t128", 128)):
                serve = dict(timing[
                    ("fwd", f"{'f32 ' if f32 else ''}serving T={bucket}")])
                serve.pop("kernel")
                row[key] = dict(
                    serve,
                    launches=serve_f32_launches if f32 else serve_launches,
                    shape=f"bh=4*32 t={bucket} d=128 causal {dt}")
            if not f32:
                # K1 at the recompute's shape of the generate phase, timed
                # and held to its plain version in phase_kernels;
                # launches: that phase's recompute
                g = dict(timing[("fwd", GEN_LABEL)])
                g.pop("kernel")
                row["generate"] = dict(
                    g, launches=gen_launches[fn],
                    shape=f"bh={GEN_BATCH}*32 t={GEN_PROMPT + GEN_NEW} "
                          "d=128 causal bf16")
        kernels.append(row)
        if "replaced_kernel" in t:
            kernels.append(replaced_row(t, row, launches, paths))
    # K1-K3 at head dim 256 on both routes: the bf16 training shape of
    # the head_dim_256 phase (launches: its bf16 train step; its serve
    # dispatch under launches_by_path) and its float32 train step's
    # shape, every kernel on its warpgroup kernel; each with the sliced
    # kernel it replaced timed beside it (REPLACED_KEYS), float32 K2 and
    # K3 also at T 2048 under "t2048"
    for label, path, dtype, shape in (
            (HD256_LABEL, "bf16", torch.bfloat16,
             f"bh={TRAIN_BATCH}*{HD256_HEADS} t={TRAIN_SEQ} d=256 causal "
             "bf16 (head_dim_256 train step)"),
            (HD256_F32_LABEL, "f32", torch.float32,
             f"bh={HD256_F32_BATCH}*{HD256_HEADS} t={HD256_F32_SEQ} d=256 "
             "causal f32 (head_dim_256 f32 train step)")):
        for kind_ in ("fwd", "dq", "dkv"):
            t = timing[(kind_, label)]
            fn = t["kernel"]
            lib = fa.kernel_for({"fwd": "flash_fwd", "dq": "flash_bwd_dq",
                                 "dkv": "flash_bwd_dkv"}[kind_], dtype,
                                256)[0]
            kernels.append({
                "name": fn, "route": "cuda",
                "source": f"paddle_tpu_torch/csrc/{lib}.cu",
                "replaces": "paddle_tpu/ops/pallas_attention.py"
                            + replaces[kind_],
                "launches": hd_launches[path][fn],
                "path": f"head_dim_256_{path}_train",
                "launches_by_path": {p: n.get(fn, 0)
                                     for p, n in paths.items()},
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": shape, "card": kind, "power_limit": power})
            kernels[-1].update((key, t[key]) for key in REPLACED_KEYS)
            if path == "f32" and kind_ != "fwd":
                # where operations bound it, timed and held to its plain
                # version in phase_kernels (not launched on the main path)
                long = dict(timing[(kind_, HD256_F32_LONG_LABEL)])
                long.pop("kernel")
                kernels[-1]["t2048"] = dict(
                    long, shape=f"bh=4 t={TRAIN_SEQ} d=256 causal f32")
            if kind_ == "fwd" and path == "bf16":
                # K1 at the phase's served shape, timed and held to its
                # plain version in phase_kernels; launches: its dispatch
                serve = dict(timing[("fwd", HD256_OP_LABEL)])
                serve.pop("kernel")
                kernels[-1]["serving"] = dict(
                    serve, launches=hd_launches["serve"][fn],
                    shape=f"bh=1*{HD256_HEADS} t=256 d=256 causal bf16")
    # float32 rows at Transformer-base's attention shapes, head dim 64
    # (launches: the Transformer main path, the padded model, for the
    # causal decoder self-attention; its unpadded form for the
    # cross-attention, tq 128 over tk 256)
    tf_shapes = {
        TF_CAUSAL_LABEL: ("transformer", tf_launches,
                          f"bh={TF_BATCH}*8 t={TF_SEQ} d=64 causal f32"),
        TF_CROSS_LABEL: ("transformer_unpadded", tf_unpadded_launches,
                         f"bh={TF_BATCH}*8 tq={TF_SEQ // 2} tk={TF_SEQ} "
                         "d=64 non-causal f32")}
    for label, (path, launches, shape) in tf_shapes.items():
        for kind_ in ("fwd", "dq", "dkv"):
            t = timing[(kind_, label)]
            fn = t["kernel"]
            row = {
                "name": fn, "route": "cuda",
                "source": f"paddle_tpu_torch/csrc/{fn}.cu",
                "replaces": "paddle_tpu/ops/pallas_attention.py"
                            + replaces[kind_],
                "launches": launches[fn], "path": path,
                "launches_by_path": {p: n.get(fn, 0)
                                     for p, n in paths.items()},
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": shape, "card": kind, "power_limit": power}
            row.update((key, t[key]) for key in REPLACED_KEYS if key in t)
            kernels.append(row)
            if "replaced_kernel" in t:
                kernels.append(replaced_row(t, row, launches, paths))
    # the kernels of the head dims no model path runs (no launches
    # there), timed in phase_kernels: on the row of the kernel that runs
    # them, under "timed_at"
    for label in EXTRA_TIMED_LABELS:
        for kind_ in ("fwd", "dq", "dkv"):
            t = dict(timing[(kind_, label)])
            fn = t.pop("kernel")
            rows = [r for r in kernels if r["name"] == fn]
            check(rows, f"{fn} ({label}) has no row in the kernel line")
            rows[0].setdefault("timed_at", {})[label] = dict(
                t, launches=0, shape=label)
    print("serving_chaos: " + json.dumps(
        {"serve": chaos["serve"][1], "decode": chaos["decode"][1]}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
