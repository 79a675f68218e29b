#!/usr/bin/env python3
"""Drive the PyTorch port (mxnet_tpu_torch) on one CUDA card, end to end.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases; any failure raises, exits non-zero and prints no result line:

1. Card report (name, count, power limit); TF32 off for matmuls and cuDNN.
2. Build every kernel from the checkout's sources (one nvcc per source,
   all started together); print build seconds, the ptxas register,
   shared-memory and spill lines, and for each instantiation of the
   tensor-core kernels (forward, dQ, dK/dV) its registers, spills and HMMA
   instructions (from cuobjdump --dump-sass); fail if any of the three has
   an instantiation without HMMA.
3. The forward kernel against its plain PyTorch version on the card, at
   the serving path's shape (4, 12, 1024, 64), causal and not, f32 and
   bf16, plus a ragged T=1000, BERT's shape (32, 12, 512, 64)
   non-causal, Transformer-base's (32, 8, 128, 64) causal and not, and
   its decoder's self-attention at T = 1, 9 and 33 (causal, below one
   tile, as beam_search and greedy_decode run it); max abs and rel error
   beside the tolerance.
3b. The backward kernels (dQ, dK/dV) against their plain version at the
   training path's shape (8, 12, 1024, 64), causal and not, f32 and bf16,
   plus a ragged T=1000, BERT's shape and ViT-B/16's (64, 12, 197, 64)
   non-causal and Transformer-base's causal and not, with dO random and O, L from the forward kernel (itself
   checked there against its plain version).
4. Forward timing with CUDA events at the serving shape and BERT's:
   kernel, plain version, the PyTorch library call as a yardstick (the
   port never calls it; SDPA pinned to one backend, flash for bf16 and
   memory-efficient for f32, its name printed; the median of 5 timed
   loops, with their min-max), and the bound reckoned from shapes.
4b. Backward timing at (8, 12, 1024, 64) causal, at BERT's and ViT's
   shapes non-causal and at Transformer-base's causal and not, f32 and
   bf16: each kernel, their sum, the plain backward,
   the bounds, and the backward of the pinned SDPA as a yardstick
   (median of 5 loops).
5. The serving path at GPT-2 small's full width (random f32 weights from
   a numpy seed, loaded through convert.load_state): (a) generate() over
   the flash trunk, with the kernel's launch count checked; (b) the
   ServingEngine agrees with (a); (c) a coalesced mixed-length group
   equals the same prompts served one by one; (d) the flash trunk's
   logits agree with the dense trunk's.
5e. The training path at full width: ShardedTrainer(adamw) on
   gpt2_small(scan_layers=True, attention_impl="flash", dropout=0.0) at
   B=8, T=1024 on the permutation corpus of
   examples/gpt_pretrain_sharded.py: (i) loss and every gradient against a
   dense trunk's at B=2; (ii) one step launches each kernel once per
   layer; (iii) 20 steps, loss falls, ms per step; (iv) 3 bf16 steps and
   a torch.profiler split of one (GEMM and the other families); (v) the
   trained weights through state_for_serving into
   ServingEngine.reload_from_state agree with generate().
5f. Where a training step's device time goes: three f32 steps under
   torch.profiler, kernel time by family, and the device's busy share.
7. The imperative path (``mx.nd`` + ``autograd``) through the user's entry
   points: a linear regression with X (65536, 4096) f32 on gpu(0) by
   default, 20 steps whose SGD update is the NVRTC-compiled ``axpy``
   (``rtc.CudaModule``, [2] compiles both sources): the loss falls, the
   kernel's update equals ``w - lr * w.grad`` by nd ops, ms per step and
   peak memory; then nd.save/nd.load bit-exact, grad_req="add" and
   create_graph at a small size.
7b. The runtime-compiled kernels ``scale2`` (the JAX package's PallasModule
   test kernel) and ``axpy`` against their plain versions at 2^26 elements
   and at 1000003; a write reaches only the non-const pointer's array; a
   wrong dtype, a CPU array and a syntax error raise MXNetError; CUDA-event
   times beside the byte bounds and the library calls; the host cost of
   one launch.
8. BERT-base pretraining at bench_bert's configuration (bench.py:179-183,
   3432-3500): bert_base(scan_layers=True, attention_impl="flash"),
   Xavier, bf16, ShardedTrainer(adamw, mesh=data_parallel_mesh(1)) at
   B=32, T=512: (i) the f32 flash trunk's loss and gradients against the
   dense trunk's at B=2; (ii) one bf16 step launches each flash kernel
   once per layer; (iii) mxnet_tpu_torch.tools.bench_bert.run, 10 timed
   steps: the loss falls, ms per step, tokens/s, MFU, peak memory;
   (iv) bf16 outputs and loss against f32 at B=2; (v) torch.profiler over
   three bf16 steps.
9. ResNet-50 v1 training at bench_resnet's configuration (bench.py:150-154,
   2100-2184): (i) the card against the host, in training mode, on the
   same weights: a ResNetV1(BottleneckV1, [1, 1, 1, 1]) in f32 and
   resnet50_v1 in f64 (outputs, loss, every gradient, the moved running
   statistics, at rtol 2e-4 / atol 2e-5 and 2e-3 / 2e-4), resnet50_v1 in
   f32 against the host's f64 run; (ii) resnet50_v1 at (8, 3, 224, 224):
   in predict mode (drawn running statistics) bf16 against f32 on the
   card, in training mode the card's bf16 error against the host's;
   (iii) mxnet_tpu_torch.tools.bench_resnet.run at B=256 (B=64 if that runs out of memory, said so), NCHW then NHWC: the
   loss falls, ms per step, samples/s, MFU, peak memory, and the kernel
   launches of one step (none: the path runs cuDNN, cuBLAS and PyTorch's
   own kernels); (iv) torch.profiler over three bf16 steps by family
   (convolutions, BN reductions, elementwise, the optimizer update);
   (v) mxnet_tpu_torch.entry.entry()'s forward on the card.
10. ResNet-50 v1 through gluon.Trainer: (i) three Trainer.steps (SGD,
   momentum 0.9, wd 1e-4) card against host, the small ResNet in f32 and
   resnet50_v1 in f64 (losses, weights, running statistics, momenta);
   (ii) under torch.use_deterministic_algorithms(True), the captured
   train_step (one CUDA graph a step) against the eager one, bitwise in
   losses, weights and states: Adam with the guard and a NaN batch (both
   skip it), SGD with every step clipped, and a Dense/BatchNorm/Dropout
   net at grad_accum=2; the captured counters (one dispatch and one
   readback a step, no recording after the first); (iii)
   tools.bench_resnet.run at B=256, 224x224, bf16, NCHW through the eager
   Gluon loop (record, backward, Trainer.step(256), kvstore "device"),
   the captured train_step and ShardedTrainer: the loss falls, ms per
   step, samples/s, peak memory; each path's kernel launches (none of the
   port's own) and torch.profiler over three steps of the first two (the
   eager update's kernels against its span on the device timeline);
   (iv) tools.bench_trainer.run: the captured, grouped and legacy steps'
   microseconds.
11. BERT-base and ViT-B/16 as Gluon blocks: (i) bench_bert's Gluon BERT
   (bf16, flash, B=32, T=512) at dropout 0.1 under deterministic
   algorithms: three captured train_steps equal three eager ones bitwise
   (losses, weights, AdamW states), one recording; the eager step
   launches each flash kernel 12 times; (ii) the per-layer trunk
   (scan_layers=False), f32, B=2: flash against dense, loss and every
   gradient; (iii) tools.bench_bert.run through the eager Gluon loop, the
   captured train_step and ShardedTrainer (dropout 0, 2 warm-up + 10
   timed steps): ms per step, tokens/s, MFU, peak memory; each path's
   flash kernels counted on the device by torch.profiler (12 each, the
   captured one inside the graph's replay) and its busy share over three
   steps; (iv) hybridize(remat="full"): gradients at dropout 0.1 equal
   the run without remat bitwise, peak memory with and without; (v) LoRA
   (trunk adapters of rank 8 and apply_lora on the heads, then
   freeze_for_lora): three captured steps move only the adapters, and
   merge() makes the next step record again; (vi) ViT-B/16: f32 flash
   logits (T=197) against the dense trunk's, then five bf16 steps of the
   eager Gluon loop at B=64: the loss falls, 12 launches of each kernel a
   step.
12. The input path (gluon.data, io, recordio, image): (i) a 1024-sample
   uint8 ArrayDataset through DataLoader with thread workers, process
   workers and pin_memory=True, each in DevicePrefetcher at depths 0 and
   2, read back after a sleep on the consumer's stream (the pinned ring
   wraps): bitwise the host's bytes, two host-to-device copies a batch
   (torch.profiler); then a dataset held on the card through ToTensor
   behind a sleep on the worker threads' stream, at depths 0 and 2:
   bitwise; (ii) ResNet-50 v1 at bench_resnet's configuration
   through the captured train_step, fed as bench.py feeds it
   (normalize_flip_batch_np, host bf16 cast, DevicePrefetcher):
   data_stall_share at depth 2 and 0, samples/s, and from a torch.profiler
   trace of every thread over as many steps as the timed loop, from an
   empty ring, the copies' overlap with the step's kernels on another
   stream and the busy share; (iii) bench_input_pipeline's JPEG
   loader where a codec is installed (said which, or that none is);
   (iv) GPT-2 small (bf16, flash, B=8, T=1024) trained by three
   gluon.Trainer.train_step steps from a DataLoader over CharTokenDataset
   (the repo's Markdown) with an IntervalSampler, through DevicePrefetcher:
   the loss falls, each flash kernel 12 launches a step; (v) raw records
   written with recordio.pack read back through MXIndexedRecordIO,
   RecordFileDataset and the prefetcher bitwise, and a seed= loader
   stopped mid-epoch, restored and drained: every sample exactly once.
13. The recommender path at bench_embedding's configuration
   (bench.py:216-221, 2534-2643): ShardedEmbedding and Dense(1) in a
   hybridized HybridSequential, Xavier from a seed, Adam at lr 1e-3, the
   loss (out ** 2).sum(), zipf(1.3) ids; (a) vocab 4096 at batch 512,
   (b) 2^24 rows at batch 8192 (4 GiB of table, 8 GiB of Adam states):
   (i) at both, five captured train_steps against five of the eager
   row-sparse oracle from the same state, bitwise in losses, weights and
   both Adam states; untouched rows keep their bytes; one guard readback
   a step (the ids, resident on the card, add one device-to-host read a
   step); one recording a bucket; no sparse_fallback event; (ii) (a) card
   against host, three steps, rtol 2e-4 / atol 2e-5 on the weights;
   (iii) tools.bench_embedding.run's line at (a) and (b) with the peak
   allocated memory ((b) under 13 GiB: no dense (2^24, 64) temporary),
   then (b) with a dense-gradient Embedding for the record; (iv)
   DevicePrefetcher(sparse_tables=net) at depth 2 feeding (a)'s captured
   step: every prep popped once, lookup_us with and without it; (v)
   nd.sparse.dot at 8192 x 1,000,000 (~15 nonzeros a row) and its
   gradient, card against host, and three steps of
   examples/linear_classification_libsvm.py's model on one LibSVMIter
   CSR batch (the loss falls each step); CTC's probe (a sample its frames
   cannot fit) finite on the card, and CTC's loss and gradient timed at
   N=32, T=500, C=30, L=100 by route (F.ctc_loss when every sample fits,
   the floored recursion for one that cannot).  No kernel of the port's
   own runs on this path.
14. The decode and serving path and the encoder-decoder Transformer:
   (i) tools.bench_serving.run at bench_serving's configuration
   (bench.py:281-286: buckets 1, 2, 4, 8, 8 closed-loop clients, 24
   requests, 8 new tokens) on GPT-2 small in bf16 through
   ContinuousBatcher over a ServingEngine with one CUDA graph a bucket:
   its JSON line, 36 graphs, no recording and no step run outside a
   replay after warm-up, every request its 8 tokens, batched_ratio beside
   the reference's gate (>= 1, logged, not enforced), the peak memory
   after warm-up; (ii) GPT-2 small f32: tokens replayed from the graphs
   for 4 x 64-token prompts and [5](c)'s mixed lengths against
   CachedDecoder.decode and generate() (the top-2 gap rule), the first
   logits at rtol 2e-4 / atol 1e-5, reload_from_model between two groups
   (generation 1, no recording, the new weights served);
   (iii) tools.bench_decode.run at GPT-2 small (B=8, a 16-token seed, 48
   new tokens): ms a token cached f32 / bf16 against generate(), bf16
   first logits within 0.05 max|f32|; (iv) speculative_decode, target
   GPT-2 small f32, a self-draft, a 2-layer draft (the target's first
   two layers) and a noisy draft (the target's weights plus seeded noise):
   lossless by the reference's rule, the accepted proposals of every
   round logged, at least one round of the noisy draft's accepting some
   proposals and not all; (v) beam_generate (beam
   4, alpha 0.6, 8 new tokens) card against host: the same tokens, scores
   at rtol 1e-4; (vi) Transformer-base (37000-token vocabulary, d_model
   512, 6 + 6 layers, 8 heads, d_ff 2048, flash self-attention): f32
   logits flash against dense, five bf16 steps of the eager Gluon loop at
   B=32, T=128 (dropout 0.1, label smoothing 0.1, Adam beta2 0.98, eps
   1e-9): the loss falls, each flash kernel 12 launches a step by the
   counters and the fenced profiler, ms a step, tokens/s, peak memory;
   beam_search (beam 4, 32 steps) and greedy_decode on the trained
   weights with their launches, greedy's first 8 steps flash against
   dense in f32; transformer_tiny card against host over 3 SGD steps.  The
   engine and the decoders launch no kernel of the port's own (their
   attention is dense over the cache).
15. The recurrent path: (i) the fused RNN op (ops/rnn.py) on the card
   against the same code on the host, f32, TF32 off, T=9, B=3, I=5, H=7,
   2 layers: lstm, gru, rnn_tanh, rnn_relu, bidirectional, LSTMP, ragged
   sequence lengths and the state clip; outputs, final states and the
   gradients with respect to data, parameters and states, each error
   beside its tolerance; (ii) the medium PTB LM of Zaremba et al.
   (tools/bench_lstm.RNNModel: vocab 10000, embedding and hidden 650, 2
   layers, T=35, B=20) at dropout 0 on the same numpy weights, card
   against host: the first window's loss and every gradient; (iii) 30
   BPTT windows at dropout 0.5 through gluon.Trainer (Adam, lr 0.01,
   clip 0.25), the hidden state carried and detached: the loss falls, ms
   a step and tokens/s (median and spread), peak memory, torch.profiler
   over three steps (busy share, kernel time by family), the flash and
   rtc kernels launched 0 times (wrappers and a fenced trace), then
   tools.bench_lstm.run's line; (iv) the yardstick: cuDNN's LSTM
   (torch.nn.LSTM, never on the port's path) against the port's RNN op,
   forward and backward, at hidden 650 and 1500, T=35, B=20 (CUDA
   events, median of 5 loops); (v) a CustomOp's forward and backward,
   while_loop with max_iterations, cond, linalg potrf, trsm and syevd and
   LinearRegressionOutput's gradient, card against host.
16. The detection path: (i) each detection op on the card against the
   same code on the host, on the same seeded inputs at its users' sizes:
   MultiBoxTarget at bench_ssd.VOC300 (32 x 134296 anchors x 16 gts, 3:1
   mining), MultiBoxDetection at nms_topk 400, box_nms at (4, 6000) with
   and without topk, force_suppress and background_id, ROIAlign and
   ROIPooling (7x7, 256 ROIs on a (2, 512, 38, 50) map), Proposal (6000
   -> 300) and DeformableConvolution at (8, 256, 38, 38): keep-sets,
   matches and integer targets equal, floats within DET_TOL, each worst
   error beside its tolerance; (ii) SSD at the width of SSD-300 on VOC
   (tools/bench_ssd.VOC300) at B=2 on the same weights: the loss and
   every gradient card against host; then bench_ssd.run, 20
   gluon.Trainer steps at B=32: the loss falls, ms a step, images/s,
   peak memory, the busy share and kernels a step from a fenced
   torch.profiler trace, the flash and rtc kernels launched 0 times; then
   ssd_detect at B=32: its ms and launches, its decode equal to the
   host's on the card's scores; (iii) alexnet, vgg16_bn, densenet121,
   squeezenet1.1, mobilenet1.0, mobilenetv2_1.0 at 224 and inceptionv3 at
   299: logits card against host at B=2, a training step at B=32 timed,
   pretrained=True from a .params file written to a temporary root (the
   same outputs; a missing file raises); (iv) a detection .rec of 96
   JPEGs read through ImageDetIter with CreateDetAugmenter(rand_crop=0.5,
   rand_pad=0.5, rand_mirror=True, mean=True, std=True) at 300x300:
   boxes in [0, 1] and over the bright pixels they label, three SSD steps
   fed from it; (v) Estimator.fit for two epochs on the card: the
   accuracy moves.  No kernel of the port's own runs on this path.
17. The production planes on BERT-base at bench_bert's configuration
   (B=32, T=512, bf16, AdamW on f32 masters, dropout 0.1, the flash
   kernels) through gluon.Trainer's captured step, fed by a seeded
   resumable DataLoader, MXTPU_INTEGRITY=1: (ii) 40 steps under
   run_resilient with an AsyncCheckpointer every 10 (the loader's state
   in each manifest) and MXTPU_FAULT_INJECT=sigterm_at_step:25, against
   an uninterrupted 40-step run: one restart, the loader resumed at the
   restored step's batch, every loss (the replayed ones too) and the
   final weights, masters and Adam states bitwise, 12 launches of each
   flash kernel a step (fenced trace), both runs' ms a step; (i) the
   trainer state's integrity fingerprint on the card against the numpy
   mirror, bitwise, a flipped bit changing it, one attest pass's ms;
   (iii) ckpt_stall_us async against sync (median of 5 saves),
   async_commit_ms and the bytes on disk, then crash_during_save,
   crash_before_manifest and corrupt_shard in child processes, each
   restoring the previous checkpoint; (iv) integrity_overhead_pct of
   non-due steps (plane attached against detached, in turns, 20 steps a
   side), an attest round's us, a bit_flip_grad named by the next
   attestation against two clean replays' votes, every step record
   under validate_record (path captured, flops, MFU <= 1 and within 5%
   of bench_bert's, device_peak_bytes), a record's host us, /metrics on
   a free port; (v) nan_grad skipping its step with the state bitwise
   untouched, and a DivergenceMonitor rollback after two bad steps
   restoring the checkpoint and rewinding the loader; (vi) a
   ReplicaServer over GPT-2 small bf16 at bench_serving's buckets: a
   checkpoint with the attested fingerprint swapped in (its tokens a
   fresh engine's), a mismatch refused, the front door routing round a
   closed replica, no flash launch.
18. The gang slice on BERT-base at bench_bert's configuration: (i)
   MXTPU_AUTOTUNE=search with MXTPU_TUNE_BUDGET=10 through
   Trainer.train_step over the one-card knobs (device_prefetch,
   shm_slot_mb, remat, group_max_items, unique_bucket),
   MXTPU_CAPTURE_CACHE reckoned from [8]'s peak: the
   trials, the search's seconds, the winner's score_us against the
   defaults', the peak memory, any infeasible trial; then a fresh
   trainer under replay applies the stored winner with zero trials and
   one capture, 12 launches of each flash kernel a step (fenced trace);
   (ii) tools/gang_bert.py: two BERT-base replicas (same seeds, same
   batches) as an ElasticGang over a GangKVServer on localhost, a peer
   snapshot every 4 steps through AsyncCheckpointer.attach_peers, rank
   1 SIGKILLed after step 9: rank 0 confirms the death, recovers from
   peer RAM with zero restores from disk at the newest common snapshot
   and replays from it bitwise as it ran first; the push, fetch, stall,
   detect_s, recover_s, step_tick's host us and the kernels of a step.
6. The kernel JSON line (f32 numbers at the training shape, and the
   bf16 ones under *_bf16 keys; the same at BERT's shape under
   ``at_bert_shape``, at ViT's under ``at_vit_shape`` and at
   Transformer-base's under ``at_transformer_shape``, its encoder
   (non-causal) and decoder (causal), with the forward's errors at
   TFM_DECODE_T; launches by path, [12]'s two training paths, [14]'s
   paths, [16]'s SSD path and zoo, [17]'s three paths and [18]'s
   autotune and gang paths among them),
   the nvidia-smi line, then the result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
SHAPE = (4, 12, 1024, 64)          # (B, H, T, D) of GPT-2 small at B=4
TRAIN_SHAPE = (8, 12, 1024, 64)    # ... at the training batch, B=8
TRAIN_STEPS = 20
# bench_bert's configuration (bench.py:179-183): BERT-base at B=32, T=512,
# bf16, flash trunk, non-causal; its attention runs at (32, 12, 512, 64)
BERT_BATCH, BERT_SEQ, BERT_STEPS = 32, 512, 10
BERT_SHAPE = (BERT_BATCH, 12, BERT_SEQ, 64)
# [14](vi)'s Transformer-base: 8 heads of 64 at B=32, T=128 source and
# target, the encoder's self-attention non-causal and the decoder's causal;
# beam_search (8 sources x beam 4 = 32 rows) and greedy_decode grow the
# target one token at a time, so the decoder's forward also runs far below
# one tile: TFM_DECODE_T are three of those lengths
TFM_BATCH, TFM_SEQ = 32, 128
TFM_SHAPE = (TFM_BATCH, 8, TFM_SEQ, 64)
TFM_DECODE_T = (1, 9, 33)
NEW_TOKENS = 16
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# f32: the flash kernels run f32 products as 3xTF32 on the tensor cores
# (three TF32 products per f32 product, 495 / 3 = 165 TFLOP/s); at the
# FMA units' 67 TFLOP/s a 3xTF32 kernel could read faster than its own
# bound.  bf16: the dense tensor-core rate.
PEAK_FLOPS = {"float32": 165e12, "bfloat16": 989e12}
# f32: as the JAX package's flash tests.  bf16: each version rounds P to
# bf16 relative to its running row maximum, and the kernel's 64-key tiles
# (128-row q tiles) reach other maxima than the plain version's 128-key
# tiles, so each rounded p_j may differ by 2^-8 relative: O may differ by
# 2^-8 * sum_j p_j |v_j| / l (the plain version run on |v|), plus one bf16
# step of O itself (2^-7 relative).  Two tilings of the plain version on
# the CPU differ the same way and stay within half this bound.
TOL = {"float32": (2e-4, 2e-5), "bfloat16": (2 ** -7, 1e-6)}
P_ROUND = 2 ** -8
LSE_TOL = (2e-4, 2e-5)             # LSE is f32 arithmetic in both types
# Greedy paths that sum in different orders (flash over the full window,
# dense attention over the cache, batch-size-dependent GEMM tiling) may
# only part ways at a near-tie: the top-2 logit gap there must be below
# this (f32 logits differ by ~1e-5 between the paths).
TIE_GAP = 1e-3
# Flash and dense trunks over 12 f32 layers: attention sums differ in
# order; logits are O(1).
TRUNK_TOL = (1e-3, 1e-3)
# Backward kernels against their plain version (the dQ kernel streams
# 64-row kv tiles, 32 at D = 128, past 64-row q tiles, and the dK/dV kernel
# 64-row q tiles, 32 at D = 128, past 64-row kv tiles; the plain version
# takes 128 x 128 tiles).  f32: the JAX package's gradient tolerance
# (tests/test_parallel.py:346-348).  bf16: both versions round P and dS
# to bf16 before their products, from f32 values summed in
# different orders, so a rounding may tip: each term of a sum may differ
# by one bf16 step (2^-7 relative), so a gradient by at most 2^-7 times the
# sum of |term| behind it (``bwd_magnitudes``), plus one bf16 step of the
# stored gradient.  tests/test_torch_kernels_gpu.py states the same.
BWD_TOL = {"float32": (2e-3, 2e-4), "bfloat16": (2 ** -7, 1e-6)}
BF16_STEP = 2 ** -7
# Flash and dense trunks' gradients at B=2 over 12 f32 layers: relative L2
# error per parameter (attention sums differ in order only).
GRAD_REL_L2 = 1e-3
LOSS_RTOL = 1e-5

# -- ResNet-50 v1 training ([9]) ----------------------------------------------
# bench_resnet's configuration (bench.py:150-154, 2100-2184): B=256, 224x224,
# bf16, SGD (lr 0.1, momentum 0.9, wd 1e-4), NCHW then NHWC; B=64 is
# bench.py's own fallback should B=256 not fit.
RESNET_BATCH, RESNET_IMAGE, RESNET_STEPS = 256, 224, 10
RESNET_FALLBACK_BATCH = 64
RESNET_SMALL = ([1, 1, 1, 1], [16, 32, 64, 128, 256])
# Card against host, f32 (TF32 off): tests/test_parallel.py's tolerances.
RESNET_OUT_TOL = (2e-4, 2e-5)
RESNET_GRAD_TOL = (2e-3, 2e-4)
# ResNet-50 at (2, 3, 64, 64) in training mode is ill-conditioned in f32:
# its last stage's BatchNorms normalise over 8 values a channel, and on the
# host alone an f32 run stands from an f64 run by more than the gradient
# tolerance (by 5.2 where gradients reach 289, reckoned on the CPU).  So
# (i) holds it in f64, card against host, at the tolerances above, and
# holds the card's f32 run against the host's f64 run within F32_NOISE
# times the host's own f32 error (plus the tolerance), for the logits, the
# loss and the worst gradient element: two f32 runs that sum in other
# orders land at comparable distances from f64, and the worst of ~27 M
# gradient elements lands elsewhere for each order of summation (the card
# run: 9.0 against the host's 6.5, largest |gradient| 406).
F32_NOISE = 2.0
# (ii) bf16 at (8, 3, 224, 224).  In predict mode, with drawn running
# statistics, ResNet-50's bf16 logits stand ~0.007 max|f32| from its f32
# ones, held within RESNET_BF16_TOL max|f32|, the tolerance [8](iv) holds
# BERT to (tests/test_model_zoo.py's), and the loss within one bf16 step
# (2^-7) of the f32 loss.  In training mode, at Xavier weights, batch
# statistics carry bf16 rounding much further in both packages (~0.1
# relative L2 here; the JAX package's own run at 2 x 64x64: 0.33), and
# any change in the order of a sum sends a bf16 run elsewhere: the card's
# bf16 logits stand 0.078 (relative L2) from the host's bf16 run on the
# same weights and input, 0.72 of their distance from f32.  So there the
# size of the error is what is held: the card's bf16-vs-f32 relative L2
# error within BF16_VS_HOST times the host's (the two read alike to four
# digits; on the host, six inputs 1e-3 apart read 0.1018-0.1064), and the
# layer-level card tests hold training-mode BatchNorm in bf16 card
# against host.
RESNET_BF16_TOL = 0.05
RESNET_BF16_LOSS_RTOL = BF16_STEP
BF16_VS_HOST = 1.1

# -- ResNet-50 v1 through gluon.Trainer ([10]) --------------------------------
# (i) Trainer.step against the host, at [9](i)'s tolerances on the losses,
# the running statistics (RESNET_OUT_TOL) and the trained weights and
# momenta (RESNET_GRAD_TOL): SGD, momentum 0.9, wd 1e-4, three steps of 4
# images of 64x64 (16 values a channel in the last stage's BatchNorms), at
# lr 0.02, PR 7's rate for three steps without amplified f32 rounding;
# ResNet-50 runs in f64.
TRAINER_SHAPE, TRAINER_STEPS, TRAINER_LR = (4, 3, 64, 64), 3, 0.02
# (ii) captured against eager, bitwise, under deterministic algorithms
# (cuDNN's weight-gradient algorithms are not deterministic otherwise, so
# two eager runs already differ): six steps of the small ResNet with Adam,
# the guard on and a NaN at CAPTURE_NAN_AT (both paths skip that step),
# six with SGD and every step clipped at CAPTURE_CLIP, and test_captured_
# step.py:122's Dense/BatchNorm/Dropout net with grad_accum=2.
CAPTURE_STEPS, CAPTURE_NAN_AT, CAPTURE_CLIP = 6, 3, 0.5
# (iv) tools.bench_trainer's timed steps
TRAINER_BENCH_STEPS = 30

# -- BERT-base and ViT-B/16 as Gluon blocks ([11]) ----------------------------
# (i) captured against eager over this many bench_bert steps at dropout 0.1;
# (v) the LoRA steps' batch; (vi) ViT-B/16 at 224x224 (T = 14 * 14 + 1 =
# 197, ragged against the kernels' 64-row tiles), B=64, bf16, AdamW at a
# fine-tuning rate: from Xavier weights without warm-up, on one repeated
# batch of random labels, the loss fell and then rose again at 1e-4 and
# 3e-4, and fell step by step at 3e-5 and 1e-5 (an H100 80GB HBM3 at
# 700 W).
GLUON_BERT_STEPS = 3
LORA_BATCH = 8
VIT_BATCH, VIT_IMAGE, VIT_STEPS, VIT_LR = 64, 224, 5, 1e-5
VIT_SHAPE = (VIT_BATCH, 12, (VIT_IMAGE // 16) ** 2 + 1, 64)

# -- the imperative path ([7]) and the runtime-compiled kernels ([7b]) -------
# Hand-written CUDA C++ sources compiled at runtime by rtc.CudaModule
# (NVRTC, sm_90a); tests/test_torch_kernels_gpu.py holds the same two.
# scale2 is the counterpart of the JAX package's PallasModule kernel
# (tests/test_aux.py:256-272): y = 2x, any length, grid-stride loop.  axpy
# is MXNet's rtc example: y += alpha * x with an n bound.
SCALE2_SRC = r"""
extern "C" __global__ void scale2(const float *__restrict__ x,
                                  float *__restrict__ y, long long n)
{
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride)
        y[i] = 2.0f * x[i];
}
"""
AXPY_SRC = r"""
extern "C" __global__ void axpy(const float *x, float *y, float alpha, int n)
{
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] += alpha * x[i];
}
"""
REG_SHAPE = (65536, 4096)          # X of the linear regression: 1 GiB f32
REG_STEPS = 20
REG_LR = 0.25                      # stable: 2 * lr * max eig(X^T X / N) < 2
RTC_N = 1 << 26                    # 2^26 f32 elements, 256 MiB an array
RTC_ODD = 1000003
# axpy against w - lr * w.grad by nd ops, elementwise: the kernel may fuse
# y + alpha * x into one FMA (one rounding, 2^-24 |y + ax|) where torch
# rounds alpha * x and then the sum (2^-24 |ax| + 2^-24 |y + ax|), so they
# differ by at most 2^-24 (|ax| + 2 |y + ax|) <= 2^-22 (|y| + |ax|).
AXPY_TOL = 2 ** -22


def log(*args):
    print(*args, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def cuda_ms_spread(fn, iters, loops=5):
    """(median, min, max) of ``loops`` timed loops of ``iters`` calls each:
    a library call's time wanders between runs of the same code, so a
    yardstick is a median with its spread."""
    times = sorted(cuda_ms(fn, iters) for _ in range(loops))
    return times[len(times) // 2], times[0], times[-1]


def errors(got, want, rtol, atol):
    """(max abs err, max rel err, max of err / tolerance); ``atol`` may
    be a tensor of per-element tolerances."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(1e-30)
    ratio = diff / (atol + rtol * want.abs())
    return float(diff.max()), float(rel.max()), float(ratio.max())


def bound(flops, nbytes, dtype):
    """Least time (ms) for ``flops`` operations and ``nbytes`` of device
    memory traffic, and which of the two bounds it."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


# (flops per visible (query, key) pair in units of D, (B, H, T, D)
# tensors moved, f32 (B*H, T) rows moved) of each function: each input
# read once and each output written once
WORK = {
    "fwd": (4, 4, 1),    # QK^T, PV; q, k, v -> O, LSE
    "dq": (6, 6, 2),     # QK^T, dO V^T, dS K; q, k, v, O, dO, L -> dQ, D
    "dkv": (8, 6, 2),    # QK^T, dO V^T, P^T dO, dS^T Q; q, k, v, dO, L, D
                         # -> dK, dV
    "bwd": (10, 8, 1),   # the whole backward: QK^T, dO V^T, dQ, dK, dV;
                         # q, k, v, O, dO, L -> dQ, dK, dV
}


def flash_bound(B, H, T, D, causal, dtype, fn="fwd"):
    """Least time (ms) for ``fn``'s work at this shape, and what bounds
    it (``WORK`` gives the counts)."""
    per_pair, tensors, rows = WORK[fn]
    elem = 4 if dtype == "float32" else 2
    nbytes = tensors * B * H * T * D * elem + rows * B * H * T * 4
    pairs = T * (T + 1) // 2 if causal else T * T
    return bound(per_pair * D * B * H * pairs, nbytes, dtype)


# mangled template arguments of the two element types
DTYPE_MANGLE = (("float32", "If"), ("bfloat16", "I13__nv_bfloat16"))


def ptxas_table(lines):
    """{kernel: [registers, spill store bytes]} from ptxas' -v lines (the
    spill line comes before the register line of the same kernel)."""
    import re

    rows, kernel = {}, None
    for ln in lines:
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            kernel = m.group(1)
            rows[kernel] = [None, None]
        m = re.search(r"Used (\d+) registers", ln)
        if m and kernel:
            rows[kernel][0] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and kernel:
            rows[kernel][1] = int(m.group(1))
    return rows


def phase_build_report():
    """[2] registers and spills of the tensor-core kernels, and the HMMA
    instructions in each of their instantiations; raises if the forward,
    dQ or dK/dV kernel has an instantiation without HMMA in either
    dtype."""
    import re

    from mxnet_tpu_torch import _kernels

    for name, lines in _kernels.PTXAS_LOG.items():
        for kernel, (regs, spill) in ptxas_table(lines).items():
            m = re.search(r"(flash_(?:fwd|dq|dkv)_kernel)(I\w+?)Li(\d+)E",
                          kernel)
            if m:
                dtype = dict((b, a) for a, b in DTYPE_MANGLE)[m.group(2)]
                log(f"    {m.group(1)} {dtype} D={m.group(3)}: {regs} "
                    f"registers, {spill} bytes spill stores")
    for lib, family in (("flash_attention_fwd", "flash_fwd_kernel"),
                        ("flash_attention_bwd", "flash_dkv_kernel"),
                        ("flash_attention_bwd", "flash_dq_kernel")):
        counts = {k: n for k, n in _kernels.sass_counts(lib).items()
                  if family in k}
        for dtype, mangled in DTYPE_MANGLE:
            mine = {k: n for k, n in counts.items() if family + mangled in k}
            log(f"    HMMA instructions in {family} {dtype}: "
                f"{sorted(mine.values())} over {len(mine)} head dims")
            if not mine or min(mine.values()) == 0:
                raise AssertionError(f"{family} ({dtype}) has an "
                                     f"instantiation without HMMA")


def phase_kernels(dev):
    """[3] the forward kernel against its plain version: the serving
    shape causal and not, a ragged T=1000, BERT's shape non-causal,
    Transformer-base's causal and not, and its decoder at TFM_DECODE_T.
    Returns O's max abs error by (shape, dtype name, causal)."""
    import torch

    from mxnet_tpu_torch.ops import flash_attention as fa

    ragged = SHAPE[:2] + (1000, SHAPE[3])
    cases = [(SHAPE, True), (SHAPE, False), (ragged, True),
             (BERT_SHAPE, False), (TFM_SHAPE, False), (TFM_SHAPE, True)]
    cases += [(TFM_SHAPE[:2] + (T, TFM_SHAPE[3]), True)
              for T in TFM_DECODE_T]
    errs = {}
    for shape, causal in cases:
        T = shape[2]
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(SEED + T)
            q, k, v = (torch.randn(shape, device=dev, generator=g).to(dtype)
                       for _ in range(3))
            got, got_lse = fa.flash_attention_fwd(q, k, v, causal)
            want, want_lse = fa.flash_attention_plain(q, k, v, causal)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[1]
            rtol, atol = TOL[name]
            tol_note = f"rtol {rtol:.2e} atol {atol:.0e}"
            if dtype == torch.bfloat16:
                mag, _ = fa.flash_attention_plain(q, k, v.abs(), causal)
                atol = atol + P_ROUND * mag.double()
                tol_note += " + 2^-8 * plain(q, k, |v|)"
            o_abs, o_rel, o_ratio = errors(got, want, rtol, atol)
            l_abs, l_rel, l_ratio = errors(got_lse, want_lse, *LSE_TOL)
            finite = bool(torch.isfinite(got.float()).all())
            errs[(shape, name, causal)] = o_abs
            log(f"  {shape} {name:8s} causal={causal!s:5s}  O max abs "
                f"{o_abs:.3e} rel {o_rel:.3e}, err/tol {o_ratio:.3f} "
                f"({tol_note})  LSE max abs {l_abs:.3e} rel {l_rel:.3e}, "
                f"err/tol {l_ratio:.3f} (rtol {LSE_TOL[0]:.0e} atol "
                f"{LSE_TOL[1]:.0e})")
            if not (o_ratio <= 1 and l_ratio <= 1 and finite):
                raise AssertionError(
                    f"flash_attention_fwd disagrees with its plain version "
                    f"at {shape} {name} causal={causal}")
            del q, k, v, got, got_lse, want, want_lse
    torch.cuda.empty_cache()
    return errs


def sdpa_pinned(q, k, v, causal):
    """F.scaled_dot_product_attention pinned to one backend, so that the
    yardstick does not change kernels between runs: flash for bf16,
    memory-efficient (else math) for f32, which flash does not take.
    Returns (the call, the backend's name)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    order = ((SDPBackend.FLASH_ATTENTION,) if q.dtype == torch.bfloat16
             else (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH))
    for backend in order:
        def call(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)
        try:
            call()
        except RuntimeError:
            continue
        return call, backend.name
    raise AssertionError(f"no pinned SDPA backend ran for {q.dtype}")


def phase_timing(dev):
    """[4] the forward kernel, its plain version and pinned SDPA at the
    serving shape (causal and not) and at BERT's (non-causal)."""
    import torch

    from mxnet_tpu_torch.ops import flash_attention as fa

    cases = [(SHAPE, True), (SHAPE, False), (BERT_SHAPE, False)]
    for dtype in (torch.float32, torch.bfloat16):
        for shape, causal in cases:
            g = torch.Generator(device=dev).manual_seed(SEED)
            q, k, v = (torch.randn(shape, device=dev, generator=g).to(dtype)
                       for _ in range(3))
            name = str(dtype).split(".")[1]
            ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal), 50)
            plain = cuda_ms(
                lambda: fa.flash_attention_plain(q, k, v, causal), 5, 1)
            sdpa, backend = sdpa_pinned(q, k, v, causal)
            lib, lo, hi = cuda_ms_spread(sdpa, 20)
            bound, by = flash_bound(*shape, causal, name)
            log(f"  {shape} {name:8s} causal={causal!s:5s}  kernel "
                f"{ms:.4f} ms  plain {plain:.4f} ms  sdpa[{backend}] "
                f"{lib:.4f} ms (median of 5, {lo:.4f}-{hi:.4f})  "
                f"bound {bound:.4f} ms ({by})  kernel/bound "
                f"{ms / bound:.1f}x")
            del q, k, v


def bwd_magnitudes(q, k, v, o, lse, do, causal):
    """Dense f32 sums of |term| behind dQ, dK and dV, with |dS| bounded by
    P * (|dO| |V|^T + |D|) * scale: the bf16 tolerance's scale."""
    import torch

    B, H, T, D = q.shape
    scale = D ** -0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(torch.ones((T, T), dtype=torch.bool,
                                     device=q.device).triu(1), -1e30)
    p = torch.exp(s - lse.reshape(B, H, T, 1)).masked_fill(s <= -5e29, 0.0)
    del s
    delta = (gf * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(gf.abs(), vf.abs().transpose(-1, -2))
              + delta.abs()) * scale
    return (torch.matmul(ds, kf.abs()),
            torch.matmul(p.transpose(-1, -2), gf.abs()),
            torch.matmul(ds.transpose(-1, -2), qf.abs()))


def phase_bwd_kernels(dev):
    """[3b] dQ and dK/dV kernels against flash_attention_bwd_plain; the
    forward kernel's O and L (the backward's inputs) against the plain
    forward too.  Returns max abs errors by (what, T, dtype, causal)."""
    import torch

    from mxnet_tpu_torch.ops import flash_attention as fa

    ragged = TRAIN_SHAPE[:2] + (1000, TRAIN_SHAPE[3])
    cases = [(TRAIN_SHAPE, True), (TRAIN_SHAPE, False), (ragged, True),
             (BERT_SHAPE, False), (VIT_SHAPE, False), (TFM_SHAPE, False),
             (TFM_SHAPE, True)]
    results = {}
    for shape, causal in cases:
        T = shape[2]
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            g = torch.Generator(device=dev).manual_seed(SEED + 7 + T)
            q, k, v, do = (torch.randn(shape, device=dev,
                                       generator=g).to(dtype)
                           for _ in range(4))
            o, lse = fa.flash_attention_fwd(q, k, v, causal)
            o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
            want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                causal)
            torch.cuda.synchronize()
            rtol, atol = BWD_TOL[name]
            note = f"rtol {rtol:.2e} atol {atol:.0e}"
            mags = (bwd_magnitudes(q, k, v, o, lse, do, causal)
                    if dtype == torch.bfloat16 else (0.0,) * 3)
            if dtype == torch.bfloat16:
                note += " + 2^-7 * sum|term|"
            line, ok = [], True
            for gname, a, b, m in zip(("dQ", "dK", "dV"), got, want,
                                      mags):
                tol_a = atol + BF16_STEP * m \
                    if dtype == torch.bfloat16 else atol
                e_abs, e_rel, ratio = errors(a, b, rtol, tol_a)
                ok &= ratio <= 1 and bool(torch.isfinite(a.float()).all())
                line.append(f"{gname} max abs {e_abs:.3e} rel "
                            f"{e_rel:.3e} err/tol {ratio:.3f}")
                results[(gname, T, name, causal)] = e_abs
            del mags
            f_abs = float((o.float() - o_ref.float()).abs().max())
            l_abs = float((lse - lse_ref).abs().max())
            results[("O", T, name, causal)] = f_abs
            log(f"  {shape} {name:8s} causal={causal!s:5s}  "
                + "; ".join(line) + f"  ({note}); forward O max abs "
                f"{f_abs:.3e}, LSE {l_abs:.3e}")
            if not ok:
                raise AssertionError(
                    f"backward kernels disagree with their plain version "
                    f"at {shape} {name} causal={causal}")
            del q, k, v, do, o, lse, o_ref, lse_ref, got, want
            torch.cuda.empty_cache()
    return results


def phase_bwd_timing(dev):
    """[4b] each backward kernel, the plain backward, the bounds and the
    pinned SDPA backward yardstick, plus the forward, at the training
    shape (causal), at BERT's and ViT's (non-causal) and at
    Transformer-base's (non-causal and causal).  Returns the numbers by
    (shape, dtype name, causal)."""
    import torch

    from mxnet_tpu_torch.ops import flash_attention as fa

    rows = {}
    for shape, causal in ((TRAIN_SHAPE, True), (BERT_SHAPE, False),
                          (VIT_SHAPE, False), (TFM_SHAPE, False),
                          (TFM_SHAPE, True)):
        mask = "causal" if causal else "non-causal"
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            g = torch.Generator(device=dev).manual_seed(SEED + 11)
            q, k, v, do = (torch.randn(shape, device=dev,
                                       generator=g).to(dtype)
                           for _ in range(4))
            o, lse = fa.flash_attention_fwd(q, k, v, causal)
            _, delta = fa.flash_attention_dq(q, k, v, o, lse, do, causal)
            t_fwd = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal),
                            20)
            t_dq = cuda_ms(lambda: fa.flash_attention_dq(
                q, k, v, o, lse, do, causal), 20)
            t_dkv = cuda_ms(lambda: fa.flash_attention_dkv(
                q, k, v, lse, do, delta, causal), 20)
            plain_fwd = cuda_ms(
                lambda: fa.flash_attention_plain(q, k, v, causal), 3, 1)
            plain_bwd = cuda_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal), 3, 1)
            sdpa, backend = sdpa_pinned(q, k, v, causal)
            lib_fwd, *fwd_spread = cuda_ms_spread(sdpa, 20)
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            out = sdpa_pinned(qg, kg, vg, causal)[0]()
            lib_bwd, *bwd_spread = cuda_ms_spread(lambda: torch.autograd.grad(
                out, (qg, kg, vg), do, retain_graph=True), 20)
            b = {fn: flash_bound(*shape, causal, name, fn)
                 for fn in ("fwd", "dq", "dkv", "bwd")}
            rows[(shape, name, causal)] = {
                "fwd": t_fwd, "dq": t_dq, "dkv": t_dkv,
                "plain_fwd": plain_fwd, "plain_bwd": plain_bwd,
                "lib_fwd": lib_fwd, "lib_bwd": lib_bwd, "bound": b,
                "sdpa_backend": backend}
            log(f"  {shape} {name:8s} {mask}  dQ kernel {t_dq:.4f} ms "
                f"(bound {b['dq'][0]:.4f}, {b['dq'][1]})  dK/dV kernel "
                f"{t_dkv:.4f} ms (bound {b['dkv'][0]:.4f}, {b['dkv'][1]})  "
                f"sum {t_dq + t_dkv:.4f} ms against the backward's bound "
                f"{b['bwd'][0]:.4f} ms ({b['bwd'][1]}; sum/bound "
                f"{(t_dq + t_dkv) / b['bwd'][0]:.1f}x)  plain backward "
                f"{plain_bwd:.4f} ms  sdpa[{backend}] backward {lib_bwd:.4f} "
                f"ms (median of 5, {bwd_spread[0]:.4f}-{bwd_spread[1]:.4f})")
            log(f"  {shape} {name:8s} {mask}  forward kernel {t_fwd:.4f} "
                f"ms (bound {b['fwd'][0]:.4f}, {b['fwd'][1]})  plain "
                f"{plain_fwd:.4f} ms  sdpa[{backend}] {lib_fwd:.4f} ms "
                f"(median of 5, {fwd_spread[0]:.4f}-{fwd_spread[1]:.4f})")
            del q, k, v, do, o, lse, delta, qg, kg, vg, out
            torch.cuda.empty_cache()
    return rows


def _numpy_state(model, rng):
    """A serving checkpoint in the JAX package's naming, with random f32
    values at the model's shapes."""
    import numpy as np

    state = {}
    for name, p in model.named_parameters():
        short = name.split(".")[-1]
        key = ("gptmodel0_trunk_" if name.startswith("encoder.")
               else "gptmodel0_") + short
        a = rng.standard_normal(tuple(p.shape), dtype=np.float32) * 0.02
        if short.endswith("gamma"):
            a += 1.0
        state[key] = a
    return state


def _top2_gap(model, prefix):
    """Top-2 logit gap at the last position of a (1, T) prefix."""
    import torch

    from mxnet_tpu_torch.gluon.model_zoo.gpt import _windowed_last_logits

    with torch.inference_mode():
        top = _windowed_last_logits(model, prefix).topk(2, dim=-1).values
    return float(top[0, 0] - top[0, 1])


def _agree(model, prompts, ref, got, what):
    """Token rows must be equal, or part ways only at a near-tie of the
    reference model's logits."""
    import torch

    for i, (a, b) in enumerate(zip(ref, got)):
        diff = [j for j in range(len(a)) if int(a[j]) != int(b[j])]
        if not diff:
            continue
        j = diff[0]
        prefix = torch.as_tensor(list(prompts[i]) + [int(t) for t in a[:j]],
                                 device=model.tok_embed_weight.data()._data
                                 .device)
        gap = _top2_gap(model, prefix[None])
        log(f"  {what}: request {i} parts at step {j}, top-2 gap {gap:.3e} "
            f"(tol {TIE_GAP:.0e})")
        if gap >= TIE_GAP:
            raise AssertionError(f"{what}: request {i} differs at step {j} "
                                 f"with a top-2 gap of {gap}")
    same = all(len(a) == len(b) and all(int(x) == int(y)
                                        for x, y in zip(a, b))
               for a, b in zip(ref, got))
    log(f"  {what}: tokens identical: {same}")


def phase_main_path(dev, card):
    import numpy as np
    import torch

    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(SEED)
    model = gpt.gpt2_small(scan_layers=True, attention_impl="flash")
    landed = model.tok_embed_weight.data()._data.device
    if landed != dev:
        raise AssertionError(f"gpt2_small() landed on {landed}, not {dev}")
    state = _numpy_state(model, rng)
    convert.load_state(model, state)
    L = model.encoder._num_layers
    vocab = model._vocab
    prompts = rng.integers(0, vocab, (4, 64))

    gpt.generate(model, prompts, max_new_tokens=1)       # warm-up
    torch.cuda.synchronize()
    # (a) the main path: every kernel count from 0, read right after
    fa.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    toks = gpt.generate(model, prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = fa.flash_attention_fwd.launches
    out_a = toks.asnumpy()[:, 64:].astype(np.int64)
    log(f"  (a) generate: 4 x 64-token prompts, {NEW_TOKENS} new tokens: "
        f"{t_gen * 1e3:.1f} ms, {t_gen / NEW_TOKENS * 1e3:.2f} ms per step "
        f"(full {model._max_length}-token window), "
        f"{4 * NEW_TOKENS / t_gen:.1f} tokens/s  [{card}]")
    log(f"      flash_attention_fwd launches: {launches} (want {L} x "
        f"{NEW_TOKENS} = {L * NEW_TOKENS})")
    if launches != L * NEW_TOKENS:
        raise AssertionError("generate() did not launch the kernel once per "
                             "layer per token")
    if toks.shape != (4, 64 + NEW_TOKENS) or toks.dtype != np.float32 \
            or not ((out_a >= 0) & (out_a < vocab)).all():
        raise AssertionError(f"generate() returned {tuple(toks.shape)} "
                             f"{toks.dtype} tokens outside the vocabulary")

    # (b) the serving engine on the same weights and prompts
    eng = ServingEngine(model, batch_buckets=(1, 2, 4))
    eng.serve_group([prompts[0]], 1)                      # warm-up
    before = fa.flash_attention_fwd.launches
    outs, tm = eng.serve_group(list(prompts), NEW_TOKENS)
    log(f"  (b) ServingEngine: prefill {tm['prefill_us'] / 1e3:.2f} ms, "
        f"decode {tm['decode_us_per_token'] / 1e3:.2f} ms per token, "
        f"bucket {tm['bucket']}, "
        f"{4 * NEW_TOKENS / ((tm['prefill_us'] + tm['decode_us']) / 1e6):.1f}"
        f" tokens/s  [{card}]  (flash launches: "
        f"{fa.flash_attention_fwd.launches - before}; the engine's "
        f"attention is dense over its cache)")
    _agree(model, prompts, out_a, outs, "(b) engine vs generate")

    # (c) a coalesced mixed-length group against one-by-one serving
    lens = (17, 64, 200, 511)
    mixed = [rng.integers(0, vocab, n) for n in lens]
    grouped, tg = eng.serve_group(mixed, NEW_TOKENS)
    solo = [eng.serve_group([p], NEW_TOKENS)[0][0] for p in mixed]
    log(f"  (c) coalesced group of {lens}: bucket {tg['bucket']}, prefill "
        f"{tg['prefill_us'] / 1e3:.2f} ms, decode "
        f"{tg['decode_us_per_token'] / 1e3:.2f} ms per token  [{card}]")
    _agree(model, mixed, solo, grouped, "(c) coalesced vs one-by-one")

    # (d) flash trunk against the dense trunk at the full window
    dense = gpt.gpt2_small(scan_layers=True, attention_impl="dense")
    convert.load_state(dense, state)
    ids = torch.as_tensor(rng.integers(0, vocab, (1, model._max_length)),
                          device=dev)
    with torch.inference_mode():
        lf, ld = model(ids), dense(ids)
    torch.cuda.synchronize()
    d_abs, d_rel, d_ratio = errors(lf, ld, *TRUNK_TOL)
    finite = bool(torch.isfinite(lf).all())
    log(f"  (d) flash vs dense trunk logits {tuple(lf.shape)}: max abs "
        f"{d_abs:.3e} rel {d_rel:.3e}, err/tol {d_ratio:.3f} (rtol "
        f"{TRUNK_TOL[0]:.0e} atol {TRUNK_TOL[1]:.0e}), finite {finite}")
    if not (d_ratio <= 1 and finite):
        raise AssertionError("flash trunk disagrees with the dense trunk")
    return launches


def _corpus(rng, B, T, vocab):
    """examples/gpt_pretrain_sharded.py's synthetic corpus with learnable
    structure: tok_{t+1} = perm[tok_t]."""
    import numpy as np

    perm = rng.permutation(vocab)
    seqs = [rng.integers(0, vocab, (B,))]
    for _ in range(T - 1):
        seqs.append(perm[seqs[-1]])
    return np.stack(seqs, axis=1).astype(np.int64)


def _loss_and_grads(model, ids):
    """The LM loss and every parameter's gradient, in training mode (the
    models here have no dropout, so it is deterministic)."""
    import torch

    from mxnet_tpu_torch.gluon.model_zoo import gpt

    model.train()
    try:
        loss = gpt.GPTLMLoss()(model(ids), ids)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
    finally:
        model.eval()
    return float(loss.detach()), dict(zip(names, grads))


def _counts():
    from mxnet_tpu_torch.ops import flash_attention as fa

    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "flash_attention_dq": fa.flash_attention_dq.launches,
            "flash_attention_dkv": fa.flash_attention_dkv.launches}


def _zero_counts():
    from mxnet_tpu_torch.ops import flash_attention as fa

    for fn in (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv):
        fn.launches = 0


def phase_train(dev, card):
    """[5e] The training path at GPT-2 small's full width.  Returns the
    kernel launches of one ShardedTrainer step."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.serving import ServingEngine, state_for_serving

    B, H, T, _ = TRAIN_SHAPE
    rng = np.random.default_rng(SEED + 5)
    model = gpt.gpt2_small(scan_layers=True, attention_impl="flash",
                           dropout=0.0)
    state = _numpy_state(model, rng)
    convert.load_state(model, state)
    dense = gpt.gpt2_small(scan_layers=True, attention_impl="dense",
                           dropout=0.0)
    convert.load_state(dense, state)
    L, vocab = model.encoder._num_layers, model._vocab
    ids = torch.as_tensor(_corpus(rng, B, T, vocab), device=dev)

    # (i) loss and every gradient, flash trunk against dense trunk, B=2
    lf, gf = _loss_and_grads(model, ids[:2])
    ld, gd = _loss_and_grads(dense, ids[:2])
    worst = max(((float((gf[n] - gd[n]).norm() / gd[n].norm()), n)
                 for n in gd), key=lambda x: x[0])
    finite = all(bool(torch.isfinite(g).all()) for g in gf.values())
    log(f"  (i) B=2 loss flash {lf:.6f} dense {ld:.6f} (rel diff "
        f"{abs(lf - ld) / abs(ld):.2e}, tol {LOSS_RTOL:.0e}); largest "
        f"per-parameter gradient rel L2 error {worst[0]:.3e} ({worst[1]}; "
        f"tol {GRAD_REL_L2:.0e}) over {len(gd)} parameters; finite "
        f"{finite}")
    if not (abs(lf - ld) <= LOSS_RTOL * abs(ld) and worst[0] <= GRAD_REL_L2
            and finite):
        raise AssertionError("flash trunk's loss or gradients disagree with "
                             "the dense trunk's")
    del gf, gd
    torch.cuda.empty_cache()

    # (ii) one trainer step: each kernel once per layer
    trainer = ShardedTrainer(model, gpt.GPTLMLoss(), "adamw",
                             {"learning_rate": 3e-4})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses = [float(trainer.step(ids, ids))]
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  (ii) one ShardedTrainer.step at B={B}, T={T}: launches "
        f"{launches} (want {L} each); peak device memory {peak:.2f} GiB")
    if any(n != L for n in launches.values()):
        raise AssertionError("a train step did not launch each flash kernel "
                             "once per layer")

    # (iii) the rest of the 20 steps: the loss falls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS - 1):
        losses.append(float(trainer.step(ids, ids)))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (TRAIN_STEPS - 1) * 1e3
    log(f"  (iii) {TRAIN_STEPS} steps, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (every 5th: "
        f"{[round(x, 4) for x in losses[::5]]}); {ms:.2f} ms per step, "
        f"{B * T / ms * 1e3:.0f} tokens/s (steps 2-{TRAIN_STEPS}, f32, TF32 "
        f"off)  [{card}]")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"training did not lower the loss: {losses}")

    # (iv) the model cast to bf16: three finite steps, then one under the
    # profiler (its FFN products run as bf16 GEMMs since ops/nn.py's
    # fully_connected keeps the stream dtype)
    bf = gpt.gpt2_small(scan_layers=True, attention_impl="flash",
                        dropout=0.0)
    convert.load_state(bf, state)
    bf.cast("bfloat16")
    btr = ShardedTrainer(bf, gpt.GPTLMLoss(), "adamw",
                         {"learning_rate": 3e-4})
    before = _counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bl = [float(btr.step(ids, ids))]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    bl += [float(btr.step(ids, ids)) for _ in range(2)]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    bms = (t2 - t0) / 3 * 1e3
    bms_warm = (t2 - t1) / 2 * 1e3
    dtypes = {p.dtype for p in bf.parameters()}
    after = _counts()
    log(f"  (iv) bf16: losses {[round(x, 4) for x in bl]}, {bms:.2f} ms per "
        f"step (first included), {bms_warm:.2f} ms per step (steps 2-3), "
        f"{B * T / bms_warm * 1e3:.0f} tokens/s, parameters "
        f"{sorted(map(str, dtypes))}, kernel launches "
        f"{({k: after[k] - before[k] for k in after})}  [{card}]")
    if not (all(np.isfinite(bl)) and dtypes == {torch.bfloat16}):
        raise AssertionError(f"bf16 training failed: {bl}, {dtypes}")
    profile_steps(lambda: btr.step(ids, ids), 1,
                  f"(iv) one bf16 step at B={B}, T={T}", card, top=8)
    del bf, btr
    torch.cuda.empty_cache()

    # (v) the trained weights through the serving checkpoint into an engine
    # that served the untrained ones
    eng = ServingEngine(dense, batch_buckets=(2,))
    eng.reload_from_state(state_for_serving(model))
    plen = min(64, model._max_length // 2)
    prompts = rng.integers(0, vocab, (2, plen))
    ref = gpt.generate(model, prompts, max_new_tokens=NEW_TOKENS)
    outs, _ = eng.serve_group(list(prompts), NEW_TOKENS)
    log(f"  (v) engine generation {eng.generation} after "
        f"reload_from_state(state_for_serving(trained model))")
    _agree(model, prompts, ref.asnumpy()[:, plen:].astype(np.int64), outs,
           "(v) engine after reload vs generate() on the trained model")
    return launches, ms


def _bert_loss_and_grads(model, tokens, labels):
    """The pretraining loss and every parameter's gradient, in training
    mode (no dropout here, so deterministic)."""
    import torch

    from mxnet_tpu_torch.gluon.model_zoo import bert

    model.train()
    try:
        loss = bert.BERTPretrainLoss()(model(tokens), labels)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
    finally:
        model.eval()
    return float(loss.detach()), dict(zip(names, grads))


def phase_bert(dev, card):
    """[8] BERT-base pretraining at bench_bert's configuration: (i) the
    flash trunk's f32 loss and gradients against a dense trunk's at B=2;
    (iv) the bf16 model's outputs and loss against the f32 ones at B=2;
    (ii) one bf16 step of the bench's path launches each flash kernel once
    per layer; (v) three bf16 steps under torch.profiler; (iii)
    tools.bench_bert.run at B=32, T=512 for BERT_STEPS timed steps.
    Returns the launches of (ii) and the bench's result."""
    import copy

    import numpy as np
    import torch

    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.tools import bench_bert

    B, T = BERT_BATCH, BERT_SEQ
    # (i) N(0, 0.02) weights (Xavier's stacked-trunk scale, ~0.002, leaves
    # attention uniform to 0.1% and would hide the attention gradients)
    flash = bert.bert_base(dropout=0.0, max_length=T, scan_layers=True,
                           attention_impl="flash")
    landed = flash.word_embed_weight.data()._data.device
    if landed != dev:
        raise AssertionError(f"bert_base() landed on {landed}, not {dev}")
    flash.initialize(initializer.Normal(0.02),
                     generator=torch.Generator(device=dev).manual_seed(
                         SEED + 31))
    dense = bert.bert_base(dropout=0.0, max_length=T, scan_layers=True,
                           attention_impl="dense")
    dense.load_state_dict(flash.state_dict())
    tokens, mlm, nsp = bench_bert.make_data(2, T, flash._vocab, dev, seed=1)
    lf, gf = _bert_loss_and_grads(flash, tokens, (mlm, nsp))
    ld, gd = _bert_loss_and_grads(dense, tokens, (mlm, nsp))
    worst = max(((float((gf[n] - gd[n]).norm() / gd[n].norm()), n)
                 for n in gd), key=lambda x: x[0])
    finite = all(bool(torch.isfinite(g).all()) for g in gf.values())
    tied = float((gf["word_embed_weight"] - gd["word_embed_weight"]).norm()
                 / gd["word_embed_weight"].norm())
    log(f"  (i) f32 B=2 T={T} loss flash {lf:.6f} dense {ld:.6f} (rel diff "
        f"{abs(lf - ld) / abs(ld):.2e}, tol {LOSS_RTOL:.0e}); largest "
        f"per-parameter gradient rel L2 error {worst[0]:.3e} ({worst[1]}; "
        f"tol {GRAD_REL_L2:.0e}) over {len(gd)} parameters, the tied "
        f"word_embed_weight's {tied:.3e}; finite {finite}")
    if not (abs(lf - ld) <= LOSS_RTOL * abs(ld) and worst[0] <= GRAD_REL_L2
            and finite):
        raise AssertionError("BERT's flash trunk: loss or gradients disagree "
                             "with the dense trunk's")
    del gf, gd, dense
    torch.cuda.empty_cache()

    # (iv) bf16 against f32 on the same weights.  Each output is held at
    # 0.05 max|f32| (tests/test_model_zoo.py's bf16 tolerance).  The loss
    # then follows: per token |d(lse(z) - z_y)| <= 2 max_j |d z_j| (lse is
    # 1-Lipschitz in the max norm), and a mean keeps the bound, so
    # |d loss| <= 2 tol_mlm + 2 tol_nsp, plus LOSS_RTOL for the f32 sums.
    bf = copy.deepcopy(flash).cast("bfloat16")
    with torch.inference_mode():
        ref, got = flash(tokens), bf(tokens)
        loss32 = float(bert.BERTPretrainLoss()(ref, (mlm, nsp)))
        loss16 = float(bert.BERTPretrainLoss()(got, (mlm, nsp)))
    worst_ratio, tols = 0.0, {}
    for name, a, b in zip(("seq", "pooled", "nsp", "mlm"), got, ref):
        tols[name] = 0.05 * float(b.abs().max())
        err = float((a.float() - b).abs().max())
        worst_ratio = max(worst_ratio, err / tols[name])
        log(f"  (iv) bf16 vs f32 {name} {tuple(a.shape)}: max abs err "
            f"{err:.3e} (tol 0.05 max|f32| = {tols[name]:.3e})")
    loss_tol = 2 * tols["mlm"] + 2 * tols["nsp"] + LOSS_RTOL * abs(loss32)
    log(f"  (iv) first-step loss bf16 {loss16:.6f} f32 {loss32:.6f}: diff "
        f"{abs(loss16 - loss32):.3e} (tol 2 tol_mlm + 2 tol_nsp + 1e-5 "
        f"|loss| = {loss_tol:.3e})")
    if not (worst_ratio <= 1 and abs(loss16 - loss32) <= loss_tol
            and np.isfinite(loss16)):
        raise AssertionError("bf16 BERT disagrees with f32")
    del flash, bf, ref, got
    torch.cuda.empty_cache()

    # (ii) one step of the bench's path (bf16): each kernel once per layer
    trainer, btok, blabels = bench_bert.build(B, T, "flash", "bfloat16")
    L = trainer.block.encoder._num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    first = float(trainer.step(btok, blabels))
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  (ii) one bf16 ShardedTrainer.step at B={B}, T={T}: loss "
        f"{first:.4f}, launches {launches} (want {L} each); peak device "
        f"memory {peak:.2f} GiB")
    if any(n != L for n in launches.values()):
        raise AssertionError("a BERT step did not launch each flash kernel "
                             "once per layer")

    # (v) where a bf16 step's device time goes
    for _ in range(2):
        trainer.step(btok, blabels)
    profile_steps(lambda: trainer.step(btok, blabels), 3,
                  f"(v) 3 bf16 BERT steps at B={B}, T={T}", card)
    del trainer, btok, blabels
    torch.cuda.empty_cache()

    # (iii) the bench
    res = bench_bert.run(B, T, BERT_STEPS)
    mfu = res["mfu"]
    log(f"  (iii) bench_bert.run: loss {[round(x, 4) for x in res['losses']]}"
        f" (2 warm-up + {BERT_STEPS} timed); {res['ms_per_step']:.2f} ms per "
        f"step, {res['value']:.0f} tokens/s, mfu "
        f"{'null' if mfu is None else format(mfu, '.4f')}, peak device memory "
        f"{res['peak_mem_gib']:.2f} GiB  [{res['nvidia_smi']}]")
    log("  (iii) " + json.dumps(res))
    losses = res["losses"]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the BERT bench failed: {losses}")
    return launches, res


def _resnet_small(v, layout="NCHW"):
    return v.ResNetV1(v.BottleneckV1, *RESNET_SMALL, classes=1000,
                      layout=layout)


def _resnet_numpy(net, rng):
    """The net's parameters as numpy, BatchNorm's scales, shifts and
    running statistics drawn from ``rng`` (so inference mode is not the
    identity and every parameter matters)."""
    import numpy as np

    out = {}
    for name, p in net.collect_params().items():
        a = p.data().asnumpy()
        if name.endswith(("gamma", "running_var")):
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif name.endswith(("beta", "running_mean")):
            a = rng.uniform(-0.2, 0.2, a.shape).astype(np.float32)
        out[name] = a
    return out


def _resnet_pass(net, x, y):
    """A training-mode forward, the mean loss and every gradient; the
    forward moves the running statistics.  Returns (logits, loss,
    {name: grad}, {name: running stat}) as f64 host tensors."""
    import torch

    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    with autograd.train_mode():
        out = net(x)
        loss = SoftmaxCrossEntropyLoss()(out, y).mean()
    params = net.collect_params()
    train = [(k[len(net.prefix):], p._value()) for k, p in params.items()
             if p.grad_req != "null"]
    grads = torch.autograd.grad(loss, [t for _, t in train])
    stats = {k[len(net.prefix):]: p._value().detach().double().cpu()
             for k, p in params.items() if p.grad_req == "null"}
    return (out.detach().double().cpu(), float(loss),
            {n: g.double().cpu() for (n, _), g in zip(train, grads)}, stats)


def _excess(got, want, rtol, atol):
    """max(|got - want| - rtol |want|) / atol: <= 1 passes allclose."""
    return float(((got - want).abs() - rtol * want.abs()).max()) / atol


def _resnet_card_vs_host(make, shape, dev, rng, dtypes):
    """(i) One model, the same weights on the host and the card; returns
    {dtype: result on the card, result on the host} of ``_resnet_pass``."""
    import numpy as np

    import torch

    from mxnet_tpu_torch import convert, initializer
    from mxnet_tpu_torch.context import context_of, cpu
    from mxnet_tpu_torch.gluon.model_zoo import vision

    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    y = torch.as_tensor(rng.randint(0, 1000, shape[0]).astype(np.float32))
    with cpu():
        host = make(vision)
        host.initialize(init=initializer.Xavier(),
                        generator=torch.Generator().manual_seed(SEED))
        host._ensure_initialized(x)
    params = _resnet_numpy(host, rng)
    convert.load_gluon_params(host, params)
    res = {}
    for dt in dtypes:
        card = make(vision)
        card.initialize(ctx=context_of(dev))
        convert.load_gluon_params(card, params)
        h = make(vision)
        with cpu():
            h.initialize()
        convert.load_gluon_params(h, params)
        card.cast(dt)
        h.cast(dt)
        tdt = getattr(torch, dt)
        res[dt] = (_resnet_pass(card, x.to(dev, tdt), y.to(dev)),
                   _resnet_pass(h, x.to(tdt), y))
    return res


def _resnet_report(what, card_run, host_run):
    """Print and return the worst err/tol ratio of outputs, loss, gradients
    and running statistics, card against host."""
    (o1, l1, g1, s1), (o0, l0, g0, s0) = card_run, host_run
    worst = {
        "logits": _excess(o1, o0, *RESNET_OUT_TOL),
        "loss": (abs(l1 - l0) - RESNET_OUT_TOL[0] * abs(l0))
        / RESNET_OUT_TOL[1],
        "grads": max(_excess(g1[k], g0[k], *RESNET_GRAD_TOL) for k in g0),
        "running stats": max(_excess(s1[k], s0[k], *RESNET_OUT_TOL)
                             for k in s0),
    }
    log(f"  (i) {what}: loss card {l1:.8f} host {l0:.8f}; excess over "
        f"tolerance (<= 1 passes): " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items()))
    return max(worst.values())


def phase_resnet(dev, card, rtc_kernels):
    """[9] ResNet-50 v1 at bench_resnet's configuration: (i) card against
    host in f32 (ResNet-50 in f64 too, see RESNET_*_TOL); (ii) bf16 against
    f32 on the card at (8, 3, 224, 224); (iii) tools.bench_resnet.run at
    B=256, NCHW then NHWC, with the launches of one of its steps; (iv)
    torch.profiler over three bf16 steps; (v) entry() on the card.
    Returns (launches of one bench step, {layout: bench result})."""
    import copy

    import numpy as np
    import torch

    from mxnet_tpu_torch import autograd, convert, initializer
    from mxnet_tpu_torch.context import context_of, cpu
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.tools import bench_resnet

    rng = np.random.RandomState(SEED + 9)
    # (i) the small net in f32; ResNet-50 in f64 and f32
    res = _resnet_card_vs_host(_resnet_small, (2, 3, 64, 64), dev, rng,
                               ("float32",))
    bad = _resnet_report("ResNetV1(BottleneckV1, [1,1,1,1]) f32 at "
                         "(2, 3, 64, 64)", *res["float32"]) > 1
    res = _resnet_card_vs_host(lambda v: v.resnet50_v1(classes=1000),
                               (2, 3, 64, 64), dev, rng,
                               ("float64", "float32"))
    bad |= _resnet_report("resnet50_v1 f64 at (2, 3, 64, 64)",
                          *res["float64"]) > 1
    card32, host32 = res["float32"]
    host64 = res["float64"][1]
    for what, (o, l, g, s) in (("card", card32), ("host", host32)):
        log(f"  (i) resnet50_v1 f32 {what} against host f64: logits max abs "
            f"err {float((o - host64[0]).abs().max()):.3e}, loss "
            f"{abs(l - host64[1]):.3e}, worst gradient abs err "
            f"{max(float((g[k] - host64[2][k]).abs().max()) for k in g):.3e}"
            f" (largest |grad| "
            f"{max(float(v.abs().max()) for v in host64[2].values()):.1f})")

    def err_over(run, ref):
        o, l, g, _ = run
        return [float((o - ref[0]).abs().max()), abs(l - ref[1]),
                max(float((g[k] - ref[2][k]).abs().max()) for k in g)]

    card_err, host_err = err_over(card32, host64), err_over(host32, host64)
    tols = [RESNET_OUT_TOL[1], RESNET_OUT_TOL[1], RESNET_GRAD_TOL[1]]
    ratio = max(c / (F32_NOISE * h + t) for c, h, t in zip(card_err, host_err,
                                                         tols))
    log(f"  (i) resnet50_v1 f32: card error against host f64 over "
        f"({F32_NOISE} x the host f32's own error + tol) for logits, loss "
        f"and the worst gradient, worst {ratio:.3f} (<= 1 passes)")
    if bad or ratio > 1:
        raise AssertionError("ResNet on the card disagrees with the host")
    del res, card32, host32, host64
    torch.cuda.empty_cache()

    # (ii) bf16 at (8, 3, 224, 224), same weights and input throughout:
    # predict mode (drawn running statistics) bf16 against f32 on the card;
    # training mode, the card's bf16 error against the host's
    x = rng.standard_normal((8, 3, 224, 224)).astype(np.float32)
    y = rng.randint(0, 1000, 8).astype(np.float32)
    f32 = vision.resnet50_v1(classes=1000)
    f32.initialize(init=initializer.Xavier(), ctx=context_of(dev),
                   generator=torch.Generator(device=dev).manual_seed(SEED))
    f32._ensure_initialized(torch.as_tensor(x[:1], device=dev))
    drawn = copy.deepcopy(f32)
    convert.load_gluon_params(drawn, _resnet_numpy(drawn, rng))
    host32 = copy.deepcopy(f32)
    host32.collect_params().reset_ctx(cpu())
    if any(t.device.type != "cpu" for t in host32.state_dict().values()):
        raise AssertionError("reset_ctx(cpu()) left a tensor on the card")

    def bf16_vs_f32(net, d, mode):
        """(f32 logits, bf16 logits as f32, f32 loss, bf16 loss)."""
        bf = copy.deepcopy(net).cast("bfloat16")
        xt, yt = torch.as_tensor(x, device=d), torch.as_tensor(y, device=d)
        with torch.no_grad(), mode():
            ref, got = net(xt), bf(xt.bfloat16()).float()
            return (ref, got, float(SoftmaxCrossEntropyLoss()(ref, yt).mean()),
                    float(SoftmaxCrossEntropyLoss()(got, yt).mean()))

    ref, got, loss32, loss16 = bf16_vs_f32(drawn, dev, autograd.predict_mode)
    peak = float(ref.abs().max())
    err = float((got - ref).abs().max())
    ok = err <= RESNET_BF16_TOL * peak and abs(loss16 - loss32) <= \
        RESNET_BF16_LOSS_RTOL * abs(loss32) and np.isfinite(loss16)
    log(f"  (ii) predict mode, drawn running statistics: bf16 against f32 "
        f"logits max abs err {err:.4e} = {err / peak:.4f} max|f32| (tol "
        f"{RESNET_BF16_TOL}), relative L2 "
        f"{float((got - ref).norm() / ref.norm()):.4f}; loss bf16 "
        f"{loss16:.6f} f32 {loss32:.6f} (rtol 2^-7)")
    del drawn, ref, got
    rel, b16 = {}, {}
    for where, net, d in (("card", f32, dev), ("host", host32,
                                               torch.device("cpu"))):
        r32, r16, l32, l16 = bf16_vs_f32(net, d, autograd.train_mode)
        r32, b16[where] = r32.cpu(), r16.cpu()
        diff = b16[where] - r32
        rel[where] = float(diff.norm() / r32.norm())
        log(f"  (ii) training mode, {where}: bf16 against f32 logits "
            f"relative L2 {rel[where]:.4f}, max abs "
            f"{float(diff.abs().max()):.4e} = "
            f"{float(diff.abs().max() / r32.abs().max()):.4f} max|f32|; "
            f"loss bf16 {l16:.6f} f32 {l32:.6f}")
    apart = float((b16["card"] - b16["host"]).norm() / b16["host"].norm())
    log(f"  (ii) training mode: card bf16 against host bf16 logits relative "
        f"L2 {apart:.4f} (not held: the order of a sum moves a bf16 run); "
        f"the card's bf16 error {rel['card'] / rel['host']:.4f} x the "
        f"host's (want <= {BF16_VS_HOST})")
    ok &= rel["card"] <= BF16_VS_HOST * rel["host"]
    if not ok:
        raise AssertionError("bf16 ResNet-50 disagrees with its reference")
    del f32, host32, b16
    torch.cuda.empty_cache()

    # (iii) the bench, both layouts; the launches of one of its steps
    batch = RESNET_BATCH
    results, launches = {}, None
    for layout in ("NCHW", "NHWC"):
        try:
            r = bench_resnet.run(batch, RESNET_IMAGE, RESNET_STEPS, layout,
                                 stall=False)
        except torch.cuda.OutOfMemoryError as e:
            if batch == RESNET_FALLBACK_BATCH:
                raise
            log(f"  (iii) FINDING: B={batch} {layout} ran out of device "
                f"memory ({str(e).splitlines()[0]}); running bench.py's "
                f"fallback B={RESNET_FALLBACK_BATCH}")
            batch = RESNET_FALLBACK_BATCH
            torch.cuda.empty_cache()
            r = bench_resnet.run(batch, RESNET_IMAGE, RESNET_STEPS, layout,
                                 stall=False)
        results[layout] = r
        log(f"  (iii) bench_resnet.run {layout} B={batch}: loss "
            f"{[round(v, 4) for v in r['losses']]} (2 warm-up + "
            f"{RESNET_STEPS} timed); {r['ms_per_step']:.2f} ms per step, "
            f"{r['value']:.1f} samples/s, mfu "
            f"{'null' if r['mfu'] is None else format(r['mfu'], '.4f')}, "
            f"peak device memory {r['peak_mem_gib']:.2f} GiB, cudnn.benchmark "
            f"{r['cudnn_benchmark']}  [{r['nvidia_smi']}]")
        log("  (iii) " + json.dumps(r))
        losses = r["losses"]
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"the ResNet bench failed: {losses}")
        torch.cuda.empty_cache()

    # one step of the bench's path, NCHW, counted; then the profile
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        trainer, bx, by = bench_resnet.build(batch, RESNET_IMAGE, "NCHW")
        trainer.step(bx, by)
        torch.cuda.synchronize()
        _zero_counts()
        for k in rtc_kernels:
            k.launches = 0
        float(trainer.step(bx, by))
        launches = dict(_counts(), rtc_scale2=rtc_kernels[0].launches,
                        rtc_axpy=rtc_kernels[1].launches)
        log(f"  (iii) one bench step's kernel launches {launches} (the "
            f"ResNet path runs no kernel of the port's own)")
        # (iv) where a bf16 step's device time goes
        apply = trainer.optimizer.apply

        def timed_apply(*a, **kw):
            with torch.profiler.record_function("optimizer update"):
                return apply(*a, **kw)

        trainer.optimizer.apply = timed_apply
        trainer.step(bx, by)
        profile_steps(lambda: trainer.step(bx, by), 3,
                      f"(iv) 3 bf16 ResNet-50 steps at B={batch}, NCHW",
                      card, families=RESNET_FAMILIES,
                      ranges=("optimizer update",))
    finally:
        torch.backends.cudnn.benchmark = prev
    del trainer, bx, by
    torch.cuda.empty_cache()

    # (v) the entry point on the card
    from mxnet_tpu_torch.entry import entry

    fn, (example,) = entry()
    with torch.no_grad():
        out = fn(example)
    torch.cuda.synchronize()
    ok = tuple(out.shape) == (8, 1000) and out.device == dev and \
        bool(torch.isfinite(out).all())
    log(f"  (v) entry(): ResNet-50 forward of {tuple(example.shape)} "
        f"{example.dtype} on {out.device}: {tuple(out.shape)}, finite "
        f"{bool(torch.isfinite(out).all())}")
    if not ok:
        raise AssertionError("entry() failed on the card")
    return launches, results


def _trainer_steps(make, params, x, y, dev, dtype):
    """TRAINER_STEPS eager Gluon steps (record, backward,
    ``Trainer.step``) of ``make``'s net loaded with ``params``, in
    ``dtype`` on ``dev``; returns (losses, trained weights, running
    statistics, optimizer states) as f64 host tensors by name."""
    import torch

    from mxnet_tpu_torch import autograd, convert
    from mxnet_tpu_torch.context import context_of
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    ctx = context_of(dev)
    net = make(vision)
    net.initialize(ctx=ctx)
    convert.load_gluon_params(net, params)
    net.cast(dtype)
    tr = Trainer(net.collect_params(), "sgd",
                 {"learning_rate": TRAINER_LR, "momentum": 0.9, "wd": 1e-4})
    xn = NDArray(torch.as_tensor(x, device=dev).to(getattr(torch, dtype)),
                 ctx)
    yn = NDArray(torch.as_tensor(y, device=dev), ctx)
    losses = []
    for _ in range(TRAINER_STEPS):
        with autograd.record():
            loss = SoftmaxCrossEntropyLoss()(net(xn), yn)
        loss.backward()
        tr.step(x.shape[0])
        losses.append(float(loss.mean().asscalar()))
    names = [k[len(net.prefix):] for k in net.collect_params()]
    host = {n: p.data()._data.detach().double().cpu()
            for n, p in zip(names, net.collect_params().values())}
    trained = {n: host[n] for n, p in zip(names,
                                          net.collect_params().values())
               if p.grad_req != "null"}
    stats = {n: v for n, v in host.items() if n not in trained}
    states = {names[i]: st._data.detach().double().cpu()
              for i, st in tr._updaters[0].states.items()}
    return losses, trained, stats, states


def _trainer_card_vs_host(make, what, dev, rng, dtype):
    """(i) ``_trainer_steps`` on the card and on the host from the same
    weights and batch; prints and returns the worst excess over the
    tolerance (<= 1 passes)."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.context import cpu
    from mxnet_tpu_torch.gluon.model_zoo import vision

    x = rng.standard_normal(TRAINER_SHAPE).astype(np.float32)
    y = rng.randint(0, 1000, TRAINER_SHAPE[0]).astype(np.float32)
    with cpu():
        src = make(vision)
        src.initialize(init=initializer.Xavier(),
                       generator=torch.Generator().manual_seed(SEED))
        src._ensure_initialized(torch.as_tensor(x[:1]))
    params = _resnet_numpy(src, rng)
    card = _trainer_steps(make, params, x, y, dev, dtype)
    host = _trainer_steps(make, params, x, y, torch.device("cpu"), dtype)
    (l1, w1, s1, m1), (l0, w0, s0, m0) = card, host
    worst = {
        "losses": max((abs(a - b) - RESNET_OUT_TOL[0] * abs(b))
                      / RESNET_OUT_TOL[1] for a, b in zip(l1, l0)),
        "weights": max(_excess(w1[k], w0[k], *RESNET_GRAD_TOL) for k in w0),
        "running stats": max(_excess(s1[k], s0[k], *RESNET_OUT_TOL)
                             for k in s0),
        "momenta": max(_excess(m1[k], m0[k], *RESNET_GRAD_TOL) for k in m0),
    }
    log(f"  (i) {what}: {TRAINER_STEPS} Trainer.steps, losses card "
        f"{[round(v, 6) for v in l1]} host {[round(v, 6) for v in l0]}; "
        f"excess over tolerance (<= 1 passes): " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items()))
    if not l1[-1] < l1[0]:
        raise AssertionError(f"{what}: the loss did not fall: {l1}")
    return max(worst.values())


def _capture_net(kind, dev):
    """The net of a (ii) run: the small ResNet, or test_captured_step.py's
    Dense/BatchNorm/Dropout net; Xavier from a fixed seed, hybridized."""
    import torch

    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.context import context_of
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo import vision

    mxrandom.seed(SEED + 10)
    if kind == "resnet":
        net = _resnet_small(vision)
    else:
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(16, activation="relu"), nn.BatchNorm(axis=1),
                    nn.Dropout(0.3), nn.Dense(3))
    net.initialize(init=initializer.Xavier(), ctx=context_of(dev),
                   generator=torch.Generator(device=dev).manual_seed(SEED))
    net.hybridize()
    return net


def _capture_run(dev, captured_on, kind, opt, opt_params, guard, clip=None,
                 nan_at=None, k=1):
    """CAPTURE_STEPS ``train_step``s of a fresh ``_capture_net`` (eager
    with ``captured_on`` False); returns (losses, weights, states, skipped
    steps, counters) as host numpy."""
    import os

    import numpy as np
    import torch

    from mxnet_tpu_torch import gluon, numerics
    from mxnet_tpu_torch.context import context_of
    from mxnet_tpu_torch.gluon import captured
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.optimizer import grouped

    os.environ["MXTPU_CAPTURED_STEP"] = "1" if captured_on else "0"
    os.environ["MXTPU_GRAD_GUARD"] = guard
    try:
        net = _capture_net(kind, dev)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        loss_fn.hybridize()
        tr = gluon.Trainer(net.collect_params(), opt, dict(opt_params),
                           clip_global_norm=clip)
        rng = np.random.RandomState(SEED + 11)
        shape = (4, 3, 64, 64) if kind == "resnet" else (8, 6)
        classes = 1000 if kind == "resnet" else 3
        ctx = context_of(dev)
        losses = []
        for s in range(CAPTURE_STEPS):
            x = rng.standard_normal(shape).astype(np.float32)
            if s == nan_at:
                x.flat[0] = np.nan
            y = rng.randint(0, classes, shape[0]).astype(np.float32)
            if s == 1:
                captured.reset_counters()
                grouped.reset_dispatch_count()
                numerics.reset_readback_count()
            out = tr.train_step(net, loss_fn,
                                NDArray(torch.as_tensor(x, device=dev), ctx),
                                NDArray(torch.as_tensor(y, device=dev), ctx),
                                grad_accum=k)
            losses.append(out.asnumpy())
        counters = dict(captured.cache_stats(),
                        dispatches=captured.dispatch_count(),
                        traces=captured.trace_count(),
                        grouped=grouped.dispatch_count(),
                        readbacks=numerics.readback_count())
        weights = [p.data().asnumpy() for p in net.collect_params().values()]
        states = [st.asnumpy() for i in sorted(tr._updaters[0].states)
                  for st in _flat_states(tr._updaters[0].states[i])]
        return losses, weights, states, \
            [r.step for r in tr.skipped_steps], counters
    finally:
        os.environ.pop("MXTPU_CAPTURED_STEP", None)
        os.environ.pop("MXTPU_GRAD_GUARD", None)


def _flat_states(state):
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [a for s in state for a in _flat_states(s)]
    return [state]


def _bitwise(a, b):
    import numpy as np

    return len(a) == len(b) and all(
        x.shape == y.shape and np.array_equal(x, y, equal_nan=True)
        for x, y in zip(a, b))


def phase_trainer(dev, card, rtc_kernels):
    """[10] ResNet-50 v1 through gluon.Trainer: (i) Trainer.step, card
    against host (the small ResNet in f32, ResNet-50 in f64); (ii) the
    captured train_step against the eager one, bitwise, under
    deterministic algorithms, with its counters; (iii)
    tools.bench_resnet.run at B=256 through the eager Gluon loop, the
    captured train_step and ShardedTrainer, each path's kernel launches,
    and torch.profiler over three steps of the first two; (iv)
    tools.bench_trainer.run.  Returns (launches of one captured step,
    {path: bench result})."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.tools import bench_resnet, bench_trainer

    rng = np.random.RandomState(SEED + 10)
    # (i) Trainer.step, card against host
    worst = _trainer_card_vs_host(_resnet_small, "ResNetV1(BottleneckV1, "
                                  "[1,1,1,1]) f32", dev, rng, "float32")
    worst = max(worst, _trainer_card_vs_host(
        lambda v: v.resnet50_v1(classes=1000), "resnet50_v1 f64", dev, rng,
        "float64"))
    if worst > 1:
        raise AssertionError("Trainer.step on the card disagrees with the "
                             "host")
    torch.cuda.empty_cache()

    # (ii) captured against eager, bitwise, deterministic algorithms
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = (
            ("small ResNet, Adam, guard on, NaN batch", "resnet", "adam",
             {"learning_rate": 0.01}, "1", None, CAPTURE_NAN_AT, 1),
            ("small ResNet, SGD, guard off, clip", "resnet", "sgd",
             {"learning_rate": 0.1, "momentum": 0.9}, "0", CAPTURE_CLIP,
             None, 1),
            ("Dense/BatchNorm/Dropout, Adam, grad_accum=2", "dropout",
             "adam", {"learning_rate": 0.01}, "1", None, None, 2),
        )
        for what, kind, opt, hp, guard, clip, nan_at, k in runs:
            eager = _capture_run(dev, False, kind, opt, hp, guard, clip,
                                 nan_at, k)
            cap = _capture_run(dev, True, kind, opt, hp, guard, clip,
                               nan_at, k)
            same = [_bitwise(e, c) for e, c in zip(eager[:3], cap[:3])]
            counters = cap[4]
            n = CAPTURE_STEPS - 1
            want = {"dispatches": n, "traces": 0, "grouped": 0,
                    "hits": n, "misses": 0,
                    "readbacks": n if guard == "1" else 0}
            ok = all(same) and eager[3] == cap[3] and all(
                counters[key] == v for key, v in want.items()) and \
                (nan_at is None or eager[3] == [nan_at + 1])
            log(f"  (ii) {what}: losses / weights / states bitwise "
                f"{same}; skipped steps eager {eager[3]} captured {cap[3]}; "
                f"captured counters over steps 2-{CAPTURE_STEPS} "
                f"{counters} (want {want}); eager grouped dispatches "
                f"{eager[4]['grouped']}; last loss "
                f"{float(np.mean(cap[0][-1])):.6f}")
            if not ok:
                raise AssertionError(f"captured differs from eager: {what}")
    finally:
        torch.use_deterministic_algorithms(prev)
    torch.cuda.empty_cache()

    # (iii) ResNet-50 at bench_resnet's configuration, three ways
    results = {}
    for path in ("gluon", "captured", "sharded"):
        r = bench_resnet.run(RESNET_BATCH, RESNET_IMAGE, RESNET_STEPS,
                             "NCHW", path=path, stall=False)
        results[path] = r
        log(f"  (iii) {path}: loss {[round(v, 4) for v in r['losses']]} "
            f"(2 warm-up + {RESNET_STEPS} timed); {r['ms_per_step']:.2f} ms "
            f"per step, {r['value']:.1f} samples/s, mfu "
            f"{'null' if r['mfu'] is None else format(r['mfu'], '.4f')}, "
            f"peak device memory {r['peak_mem_gib']:.2f} GiB  "
            f"[{r['nvidia_smi']}]")
        log("  (iii) " + json.dumps(r))
        losses = r["losses"]
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"ResNet-50 {path}: {losses}")
        torch.cuda.empty_cache()
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    launches = {}
    try:
        for path in ("gluon", "captured"):
            step = bench_resnet.step_fn(path, RESNET_BATCH, RESNET_IMAGE,
                                        "NCHW")
            for _ in range(2):
                float(step())
            torch.cuda.synchronize()
            _zero_counts()
            for kern in rtc_kernels:
                kern.launches = 0
            float(step())
            launches[path] = dict(_counts(),
                                  rtc_scale2=rtc_kernels[0].launches,
                                  rtc_axpy=rtc_kernels[1].launches)
            log(f"  (iii) one {path} step's kernel launches "
                f"{launches[path]}")
            profile_steps(step, 3, f"(iii) 3 bf16 ResNet-50 {path} steps "
                          f"at B={RESNET_BATCH}, NCHW", card,
                          families=TRAINER_FAMILIES,
                          ranges=("optimizer_update",)
                          if path == "gluon" else ())
            del step
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = prev

    # (iv) the Gluon step's host cost
    bt = bench_trainer.run(160, TRAINER_BENCH_STEPS)
    log(f"  (iv) bench_trainer: captured {bt['value']:.1f} us, grouped "
        f"{bt['grouped_us']:.1f} us, legacy {bt['legacy_us']:.1f} us a "
        f"step; first step {bt['first_step_ms']:.1f} ms  "
        f"[{bt['nvidia_smi']}]")
    log("  (iv) " + json.dumps(bt))
    if not (bt["cache_misses"] == 0 and bt["traces"] == 0
            and bt["dispatches"] == TRAINER_BENCH_STEPS):
        raise AssertionError(f"bench_trainer's captured counters: {bt}")
    results["bench_trainer"] = bt
    return launches["captured"], results


# kernel-name fragments -> family, first match wins
FAMILIES = (("axpy", "rtc axpy kernel"), ("scale2", "rtc scale2 kernel"),
            ("flash_dq", "flash dQ kernel"),
            ("flash_dkv", "flash dK/dV kernel"),
            ("flash_fwd", "flash forward kernel"),
            ("gemm", "GEMM"), ("gemv", "GEMM"), ("cutlass", "GEMM"),
            ("nvjet", "GEMM"),
            ("softmax", "softmax / log-softmax"),
            ("reduce", "reductions"), ("elementwise", "elementwise"),
            ("vectorized", "elementwise"), ("index", "gather / scatter"),
            ("scatter", "gather / scatter"), ("gather", "gather / scatter"),
            ("copy", "copies"), ("cat", "copies"))


def phase_profile(dev, card, steps=3):
    """[5f] torch.profiler over ``steps`` f32 ShardedTrainer steps at the
    training shape: device time by kernel family, host wall time, and the
    device's busy share (its kernel time over the wall time)."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    from mxnet_tpu_torch.parallel import ShardedTrainer

    B, _, T, _ = TRAIN_SHAPE
    rng = np.random.default_rng(SEED + 5)
    model = gpt.gpt2_small(scan_layers=True, attention_impl="flash",
                           dropout=0.0)
    convert.load_state(model, _numpy_state(model, rng))
    ids = torch.as_tensor(_corpus(rng, B, T, model._vocab), device=dev)
    trainer = ShardedTrainer(model, gpt.GPTLMLoss(), "adamw",
                             {"learning_rate": 3e-4})
    for _ in range(2):
        trainer.step(ids, ids)
    what = f"{steps} f32 steps at B={B}, T={T}"
    profile_steps(lambda: trainer.step(ids, ids), steps, what, card)


# the ResNet step's kernel families: cuDNN's convolutions (and its layout
# transforms), reductions (BatchNorm's statistics and their backward
# sums, the loss), and the rest
RESNET_FAMILIES = (("conv", "conv / cuDNN"), ("xmma", "conv / cuDNN"),
                   ("implicit", "conv / cuDNN"), ("cudnn", "conv / cuDNN"),
                   ("sm90", "conv / cuDNN"), ("cutlass", "conv / cuDNN"),
                   ("nhwc", "conv / cuDNN"), ("nchw", "conv / cuDNN"),
                   ("gemm", "GEMM"), ("nvjet", "GEMM"),
                   ("reduce", "reductions (BN statistics)"),
                   ("max_pool", "pooling"), ("pool", "pooling"),
                   ("elementwise", "elementwise"),
                   ("vectorized", "elementwise"), ("copy", "copies"))


# [10]'s families: [9]'s, with the multi-tensor (_foreach_*) kernels of the
# grouped update and the health reduction apart
TRAINER_FAMILIES = (("multi_tensor", "foreach (update, health)"),) + \
    RESNET_FAMILIES


# [11]'s families: FAMILIES, with the grouped update's multi-tensor
# (_foreach_*) kernels apart
BERT_FAMILIES = (("multi_tensor", "foreach (update, health)"),) + FAMILIES


def profile_steps(step, steps, what, card, top=12, families=FAMILIES,
                  ranges=()):
    """torch.profiler over ``steps`` calls of ``step``: device kernel time
    by family and by kernel, host wall time, and the device's busy share
    (its kernel time over the wall time); for each name in ``ranges`` (a
    ``record_function`` range), the device time of the kernels it
    launched.  Returns (wall ms, busy ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    fam, names = {}, {}
    for evt in prof.key_averages():
        # kernels only: a CPU op's entry repeats its kernels' device time,
        # and a range's annotation on the device timeline spans its kernels
        if evt.device_type != DeviceType.CUDA or evt.key in ranges:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if not dev_us:
            continue
        key = evt.key.lower()
        f = next((v for k, v in families if k in key), "other")
        fam[f] = fam.get(f, 0.0) + dev_us / 1e3 / steps
        names[evt.key] = dev_us / 1e3 / steps
    busy = sum(fam.values())
    if busy <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    log(f"  {what}: host wall {wall:.3f} ms per step, device kernel time "
        f"{busy:.3f} ms per step, busy share {busy / wall:.3f}  [{card}]")
    for f, ms in sorted(fam.items(), key=lambda x: -x[1]):
        log(f"    {f:24s} {ms:9.3f} ms per step  {ms / busy:6.1%}")
    for r in ranges:
        # the CPU range: the device time of the kernels it launched; the
        # device annotation: the span they took on the device timeline
        spans = {e.device_type: e for e in prof.key_averages()
                 if e.key == r}
        cpu_evt, dev_evt = spans.get(DeviceType.CPU), spans.get(
            DeviceType.CUDA)
        kern = 0.0 if cpu_evt is None else getattr(
            cpu_evt, "device_time_total",
            getattr(cpu_evt, "cuda_time_total", 0.0))
        span = 0.0 if dev_evt is None else getattr(
            dev_evt, "self_device_time_total",
            getattr(dev_evt, "self_cuda_time_total", 0.0))
        log(f"    of which in {r!r}: kernels {kern / 1e3 / steps:9.3f} ms "
            f"per step, spanning {span / 1e3 / steps:9.3f} ms of the device "
            f"timeline")
    log("    top kernels:")
    for k, ms in sorted(names.items(), key=lambda x: -x[1])[:top]:
        log(f"      {ms:9.3f} ms  {k[:110]}")
    return wall, busy


# -- [11] the transformers as Gluon blocks ------------------------------------



def _kernel_counts(step, steps=1):
    """The port's kernels the device ran over ``steps`` calls of ``step``,
    by wrapper name, counted from torch.profiler's kernel records (a CUDA
    graph's replay launches kernels no wrapper sees) in a trace that
    fences show held the steps whole: a trace can drop its first records,
    a replay's first kernels among them (``tools/trace_edges.py``)."""
    from mxnet_tpu_torch.tools.trace_edges import kernel_records

    def steps_fn():
        for _ in range(steps):
            step()

    events = kernel_records(steps_fn)
    if not events:
        raise AssertionError("torch.profiler recorded no device kernels")
    frags = (("flash_fwd", "flash_attention_fwd"),
             ("flash_dq", "flash_attention_dq"),
             ("flash_dkv", "flash_attention_dkv"),
             ("scale2", "rtc_scale2"), ("axpy", "rtc_axpy"))
    got = {name: 0 for _f, name in frags}
    for evt in events:
        key = evt.name.lower()
        for frag, name in frags:
            if frag in key:
                got[name] += 1
    return {k: v // steps for k, v in got.items()}


def _gluon_bert_run(dev, captured_on, steps, batch, seq):
    """``steps`` train_steps of bench_bert's Gluon BERT at dropout 0.1
    (eager with ``captured_on`` False); returns the losses, the weights
    and the optimizer states on the device, and the captured counters."""
    import os

    import torch

    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon import captured
    from mxnet_tpu_torch.tools import bench_bert

    os.environ["MXTPU_CAPTURED_STEP"] = "1" if captured_on else "0"
    try:
        net, tr, loss_fn, tok, labels = bench_bert.build_gluon(
            batch, seq, "flash", "bfloat16", dev, seed=SEED, dropout=0.1)
        mxrandom.seed(SEED + 40)
        captured.reset_counters()
        _zero_counts()
        losses = []
        for _ in range(steps):
            losses.append(tr.train_step(net, loss_fn, tok, labels)
                          ._data.detach().clone())
        counters = dict(captured.cache_stats(),
                        dispatches=captured.dispatch_count(),
                        traces=captured.trace_count(), **_counts())
        weights = [p.data()._data.detach().clone()
                   for p in net.collect_params().values()]
        states = [st._data.detach().clone()
                  for i in sorted(tr._updaters[0].states)
                  for st in _flat_states(tr._updaters[0].states[i])]
        return losses, weights, states, counters
    finally:
        os.environ.pop("MXTPU_CAPTURED_STEP", None)


def _equal_lists(a, b):
    import torch

    return len(a) == len(b) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))


def _block_loss_and_grads(model, tokens, labels):
    """The pretraining loss and every Gluon parameter's gradient of a BERT
    block on tensors, in training mode."""
    import torch

    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.model_zoo import bert

    params = model.collect_params()
    with autograd.train_mode():
        loss = bert.BERTPretrainLoss()(model(tokens), labels)
    grads = torch.autograd.grad(loss, [p._value() for p in params.values()])
    return float(loss.detach()), dict(zip(
        (n[len(model.prefix):] for n in params), grads))


def _nd_grads(net, loss_fn, tok, labels, seed):
    """One recorded forward and backward of a Gluon BERT on NDArrays (the
    hybridized forward's dropout generator drawn from the chain at
    ``seed``): the loss, every gradient and the peak memory over the
    step, in GiB above what was allocated before it."""
    import torch

    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch import random as mxrandom

    params = net.collect_params()
    for p in params.values():
        p.zero_grad()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mxrandom.seed(seed)
    with autograd.record():
        loss = loss_fn(net(tok), labels)
    loss.backward()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    grads = [p.grad()._data.detach().clone() for p in params.values()
             if p.grad_req != "null"]
    return float(loss.asnumpy()), grads, peak


def phase_gluon_transformers(dev, card, rtc_kernels):
    """[11] BERT-base and ViT-B/16 as Gluon blocks: (i) the captured
    train_step against the eager one, bitwise, at dropout 0.1, with the
    flash kernels counted inside the replay; (ii) the per-layer flash
    trunk against the dense one; (iii) bench_bert through the eager Gluon
    loop, the captured step and ShardedTrainer; (iv) remat="full"; (v)
    LoRA adapters through the captured step; (vi) ViT-B/16 training.
    Returns ({path: launches by kernel, the rtc kernels' too}, {path:
    bench result})."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.tools import bench_bert

    B, T = BERT_BATCH, BERT_SEQ
    L = 12
    launches = {}

    # (i) captured train_step against the eager one, bitwise
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        eager = _gluon_bert_run(dev, False, GLUON_BERT_STEPS, B, T)
        cap = _gluon_bert_run(dev, True, GLUON_BERT_STEPS, B, T)
    finally:
        torch.use_deterministic_algorithms(prev)
    same = [_equal_lists(eager[i], cap[i]) for i in range(3)]
    losses = [float(x) for x in cap[0]]
    log(f"  (i) BERT-base bf16 flash, B={B}, T={T}, dropout 0.1, "
        f"{GLUON_BERT_STEPS} train_steps: captured = eager bitwise in "
        f"losses / weights / states {same}; losses {losses}; eager kernel "
        f"launches {dict((k, eager[3][k]) for k in _counts())}; captured "
        f"counters {cap[3]} (the wrappers count the warm-up and the "
        f"recording, none of the replays)")
    if not (all(same) and cap[3]["traces"] == 1
            and cap[3]["dispatches"] == GLUON_BERT_STEPS
            and all(eager[3][k] == L * GLUON_BERT_STEPS for k in _counts())
            and all(cap[3][k] == 2 * L for k in _counts())
            and all(np.isfinite(losses))):
        raise AssertionError("BERT's captured train_step differs from the "
                             "eager one")
    del eager, cap
    torch.cuda.empty_cache()

    # (ii) the per-layer flash trunk against the dense one, f32, B=2
    flash = bert.bert_base(dropout=0.0, max_length=T, scan_layers=False,
                           attention_impl="flash")
    flash.initialize(initializer.Normal(0.02),
                     generator=torch.Generator(device=dev).manual_seed(
                         SEED + 42))
    dense = bert.bert_base(dropout=0.0, max_length=T, scan_layers=False,
                           attention_impl="dense")
    dense.load_state_dict(flash.state_dict())
    tokens, mlm, nsp = bench_bert.make_data(2, T, flash._vocab, dev, seed=3)
    _zero_counts()
    lf, gf = _block_loss_and_grads(flash, tokens, (mlm, nsp))
    per_layer_launches = _counts()
    ld, gd = _block_loss_and_grads(dense, tokens, (mlm, nsp))
    worst = max(((float((gf[n] - gd[n]).norm() / gd[n].norm()), n)
                 for n in gd), key=lambda x: x[0])
    finite = all(bool(torch.isfinite(g).all()) for g in gf.values())
    log(f"  (ii) per-layer trunk (scan_layers=False), f32, B=2: loss flash "
        f"{lf:.6f} dense {ld:.6f} (rel diff {abs(lf - ld) / abs(ld):.2e}, "
        f"tol {LOSS_RTOL:.0e}); largest per-parameter gradient rel L2 error "
        f"{worst[0]:.3e} ({worst[1]}; tol {GRAD_REL_L2:.0e}) over "
        f"{len(gd)} parameters; finite {finite}; launches "
        f"{per_layer_launches}")
    if not (abs(lf - ld) <= LOSS_RTOL * abs(ld) and worst[0] <= GRAD_REL_L2
            and finite and all(n == L for n in per_layer_launches.values())):
        raise AssertionError("the per-layer flash trunk disagrees with the "
                             "dense one")
    del flash, dense, gf, gd
    torch.cuda.empty_cache()

    # (iii) bench_bert's configuration through the three paths
    results = {}
    for path in ("gluon", "captured", "sharded"):
        r = bench_bert.run(B, T, BERT_STEPS, path=path)
        results[path] = r
        log(f"  (iii) {path}: loss {[round(v, 4) for v in r['losses']]} "
            f"(2 warm-up + {BERT_STEPS} timed); {r['ms_per_step']:.2f} ms "
            f"per step, {r['value']:.0f} tokens/s, mfu "
            f"{'null' if r['mfu'] is None else format(r['mfu'], '.4f')}, "
            f"peak device memory {r['peak_mem_gib']:.2f} GiB  "
            f"[{r['nvidia_smi']}]")
        log("  (iii) " + json.dumps(r))
        if not (all(np.isfinite(r["losses"]))
                and r["losses"][-1] < r["losses"][0]):
            raise AssertionError(f"BERT {path}: {r['losses']}")
        torch.cuda.empty_cache()
    for path in ("gluon", "captured", "sharded"):
        step = bench_bert.step_fn(path, B, T)
        for _ in range(2):
            float(step())
        _zero_counts()
        for kern in rtc_kernels:
            kern.launches = 0
        float(step())
        counted = dict(_counts(), rtc_scale2=rtc_kernels[0].launches,
                       rtc_axpy=rtc_kernels[1].launches)
        ran = _kernel_counts(step)
        log(f"  (iii) one {path} step: wrapper launches {counted}, the "
            f"port's kernels the device ran (torch.profiler) {ran}")
        if ran != dict(dict.fromkeys(_counts(), L), rtc_scale2=0,
                       rtc_axpy=0):
            raise AssertionError(f"a {path} BERT step did not run each "
                                 f"flash kernel once per layer: {ran}")
        if path == "gluon":
            launches["bert_gluon_train_step"] = counted
        elif path == "captured":
            launches["bert_captured_train_step"] = ran
        wall, busy = profile_steps(step, 3, f"(iii) 3 bf16 BERT {path} "
                                   f"steps at B={B}, T={T}", card, top=6,
                                   families=BERT_FAMILIES,
                                   ranges=("optimizer_update",)
                                   if path == "gluon" else ())
        results[path]["busy_share"] = busy / wall
        del step
        torch.cuda.empty_cache()

    # (iv) remat="full" on the block: the same gradients, less memory
    # (deterministic algorithms: the embedding gradient's scatter-add)
    runs = []
    torch.use_deterministic_algorithms(True)
    try:
        for remat in (None, "full"):
            net, _tr, loss_fn, tok, labels = bench_bert.build_gluon(
                B, T, "flash", "bfloat16", dev, seed=SEED, dropout=0.1)
            if remat:
                net.hybridize(remat=remat)
            _nd_grads(net, loss_fn, tok, labels, SEED + 43)   # warm-up
            _zero_counts()
            runs.append(_nd_grads(net, loss_fn, tok, labels, SEED + 44)
                        + (_counts(),))
            del net, _tr
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(prev)
    same = runs[0][0] == runs[1][0] and _equal_lists(runs[0][1], runs[1][1])
    log(f"  (iv) remat='full' at B={B}, T={T}, dropout 0.1: loss and "
        f"{len(runs[0][1])} gradients equal to the run without remat "
        f"(bitwise) {same}; peak memory over the step {runs[0][2]:.2f} GiB "
        f"without, {runs[1][2]:.2f} GiB with; launches without "
        f"{runs[0][3]}, with {runs[1][3]} (the recompute runs the forward "
        f"again)  [{card}]")
    if not same or runs[1][3]["flash_attention_fwd"] != 2 * L:
        raise AssertionError("remat changed BERT's gradients")
    del runs
    torch.cuda.empty_cache()

    _lora_captured(dev)
    for kern in rtc_kernels:
        kern.launches = 0
    launches["vit_train_step"] = dict(
        _vit_training(dev, card), rtc_scale2=rtc_kernels[0].launches,
        rtc_axpy=rtc_kernels[1].launches)
    return launches, results


def _lora_captured(dev):
    """[11](v) LoRA adapters (the trunk's, rank 8, and apply_lora on the
    heads; then freeze_for_lora) through the captured train_step: only
    the adapters move, and merge() makes the next step record again."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.context import context_of
    from mxnet_tpu_torch.gluon import captured
    from mxnet_tpu_torch.gluon.contrib import lora
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.tools import bench_bert

    T = BERT_SEQ
    # (v) LoRA: trunk adapters (lora_rank=8) and LoRADense on the heads
    net = bert.bert_base(dropout=0.0, max_length=T, scan_layers=True,
                         attention_impl="flash", lora_rank=8)
    net.cast("bfloat16")
    wrapped = lora.apply_lora(net, rank=8, patterns=("pooler",
                                                     "dec_transform"))
    for name, p in net.collect_params().items():
        if "lora" in name:
            p.grad_req = "write"
    n_train, n_total = lora.freeze_for_lora(net)
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "adamw",
                       dict(bench_bert.GLUON_ADAMW))
    ctx = context_of(dev)
    tok, mlm, nsp = bench_bert.make_data(LORA_BATCH, T, net._vocab, dev,
                                         seed=5)
    tok, labels = NDArray(tok, ctx), (NDArray(mlm, ctx), NDArray(nsp, ctx))
    params = net.collect_params()
    before = {n: p.data()._data.detach().clone() for n, p in params.items()}
    captured.reset_counters()
    pretrain_loss = bert.BERTPretrainLoss()
    lora_losses = [float(tr.train_step(net, pretrain_loss, tok,
                                       labels).asnumpy())
                   for _ in range(3)]
    traces = captured.trace_count()
    moved = [n for n, p in params.items()
             if not torch.equal(p.data()._data, before[n])]
    frozen_moved = [n for n in moved if "lora" in n] != moved
    for ld in wrapped:
        ld.merge()
    tr.train_step(net, pretrain_loss, tok, labels)
    traces_after = captured.trace_count()
    log(f"  (v) LoRA rank 8 (trunk qkv and {len(wrapped)} LoRADense "
        f"heads), {n_train} of {n_total} parameters trainable, B="
        f"{LORA_BATCH}: 3 captured steps, losses {lora_losses}, "
        f"recordings {traces}; parameters changed {len(moved)} (all "
        f"adapters: {not frozen_moved}); after merge() the next step "
        f"recorded again: {traces_after == traces + 1}")
    if not (traces == 1 and not frozen_moved and len(moved) > 0
            and traces_after == traces + 1 and all(np.isfinite(lora_losses))):
        raise AssertionError("LoRA's captured steps moved frozen weights "
                             "or merge did not invalidate the capture")
    del net, tr, before, params
    torch.cuda.empty_cache()


def _vit_training(dev, card):
    """[11](vi) ViT-B/16: f32 flash logits (T=197) against the dense
    trunk's at B=4, then VIT_STEPS bf16 steps of the eager Gluon loop at
    B=64.  Returns the flash launches of the last step."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import autograd, gluon, initializer
    from mxnet_tpu_torch.context import context_of
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    L = 12
    ctx = context_of(dev)
    # (vi) ViT-B/16: flash against dense at B=4 (f32), then Gluon training
    rng = np.random.RandomState(SEED + 45)
    nets = []
    for impl in ("flash", "dense"):
        v = vision.vit_base(attention_impl=impl)
        v.initialize(init=initializer.Xavier(), ctx=context_of(dev),
                     generator=torch.Generator(device=dev).manual_seed(
                         SEED + 46))
        nets.append(v)
    x = torch.as_tensor(rng.standard_normal(
        (4, 3, VIT_IMAGE, VIT_IMAGE)).astype(np.float32), device=dev)
    with torch.inference_mode():
        lf, ld = nets[0](x), nets[1](x)
    v_abs, v_rel, v_ratio = errors(lf, ld, *TRUNK_TOL)
    log(f"  (vi) ViT-B/16 f32 logits {tuple(lf.shape)}, flash (T=197) "
        f"against dense: max abs {v_abs:.3e} rel {v_rel:.3e}, err/tol "
        f"{v_ratio:.3f} (rtol {TRUNK_TOL[0]:.0e} atol {TRUNK_TOL[1]:.0e})")
    if not (v_ratio <= 1 and bool(torch.isfinite(lf).all())):
        raise AssertionError("ViT's flash trunk disagrees with the dense one")
    del nets, lf, ld, x
    torch.cuda.empty_cache()
    vit = vision.vit_base(attention_impl="flash")
    vit.initialize(init=initializer.Xavier(), ctx=context_of(dev),
                   generator=torch.Generator(device=dev).manual_seed(
                       SEED + 47))
    vit.cast("bfloat16")
    vit.hybridize()
    vtr = gluon.Trainer(vit.collect_params(), "adamw",
                        {"learning_rate": VIT_LR, "wd": 0.01,
                         "multi_precision": True})
    vloss = gluon.loss.SoftmaxCrossEntropyLoss()
    xs = NDArray(torch.as_tensor(rng.standard_normal(
        (VIT_BATCH, 3, VIT_IMAGE, VIT_IMAGE)).astype(np.float32),
        device=dev).bfloat16(), ctx)
    ys = NDArray(torch.as_tensor(rng.randint(0, 1000, VIT_BATCH).astype(
        np.float32), device=dev), ctx)
    vit_losses, per_step = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for s in range(VIT_STEPS):
        if s == 1:
            t1 = time.perf_counter()
        _zero_counts()
        with autograd.record():
            loss = vloss(vit(xs), ys)
        loss.backward()
        vtr.step(VIT_BATCH)
        vit_losses.append(float(loss.mean().asnumpy()))
        per_step.append(_counts())
    t2 = time.perf_counter()
    ms = (t2 - t0) / VIT_STEPS * 1e3
    ms_warm = (t2 - t1) / (VIT_STEPS - 1) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  (vi) ViT-B/16 bf16 flash, B={VIT_BATCH}, {VIT_IMAGE}x"
        f"{VIT_IMAGE}, eager Gluon loop (AdamW lr {VIT_LR}): losses "
        f"{[round(v, 4) for v in vit_losses]}, {ms:.2f} ms a step (first "
        f"included), {ms_warm:.2f} ms a step after it, "
        f"{VIT_BATCH / ms_warm * 1e3:.1f} images/s, peak {peak:.2f} GiB, "
        f"launches a step {per_step[-1]}  [{card}]")
    if not (all(np.isfinite(vit_losses)) and vit_losses[-1] < vit_losses[0]
            and all(all(n == L for n in c.values()) for c in per_step)):
        raise AssertionError(f"ViT training: {vit_losses}, {per_step}")
    del vit, vtr, xs, ys
    torch.cuda.empty_cache()
    return per_step[-1]


def _grid(n, block=256):
    """A grid-stride launch: enough 256-thread blocks to fill the card."""
    return (max(1, min((n + block - 1) // block, 132 * 16)), 1, 1)


def _rtc_kernels():
    """Compile both sources at runtime; returns the kernels and the NVRTC
    seconds each took."""
    from mxnet_tpu_torch import rtc

    m_s2 = rtc.CudaModule(SCALE2_SRC)
    m_ax = rtc.CudaModule(AXPY_SRC)
    s2 = m_s2.get_kernel("scale2", "const float *x, float *y, int64_t n")
    ax = m_ax.get_kernel("axpy",
                         "const float *x, float *y, float alpha, int n")
    return s2, ax, {"scale2": m_s2.compile_seconds,
                    "axpy": m_ax.compile_seconds}


def phase_imperative(dev, card):
    """[7] The imperative path through the user's entry points: an
    nd/autograd linear regression at REG_SHAPE whose SGD update is the
    runtime-compiled axpy kernel; then nd.save/nd.load, grad_req="add"
    and create_graph at a small size.  Returns the path's numbers."""
    import math

    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd

    rng = np.random.default_rng(SEED + 17)
    N, D = REG_SHAPE
    X_np = rng.standard_normal(REG_SHAPE, dtype=np.float32)
    w_true = rng.standard_normal((D, 1), dtype=np.float32) / math.sqrt(D)
    y_np = X_np @ w_true + 0.5 + 0.01 * rng.standard_normal(
        (N, 1), dtype=np.float32)
    X = nd.array(X_np)                   # no ctx: gpu(0) by default
    y = nd.array(y_np)
    del X_np
    if X.context != mx.gpu(0) or X._data.device != dev:
        raise AssertionError(f"nd.array landed on {X._data.device}")
    w, b = nd.zeros((D, 1)), nd.zeros((1,))
    for p in (w, b):
        p.attach_grad()
    ax = mx.rtc.CudaModule(AXPY_SRC).get_kernel(
        "axpy", "const float *x, float *y, float alpha, int n")
    lr = REG_LR
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ax.launches = 0                      # the path's count, from 0
    losses, worst, t1 = [], 0.0, None
    t0 = time.perf_counter()
    for step in range(REG_STEPS):
        if step == 1:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        with autograd.record():
            loss = nd.mean(nd.square(nd.dot(X, w) + b - y))
        loss.backward()
        check = step in (0, REG_STEPS - 1)
        if check:                        # the update by nd ops, to compare
            refs = [(p - lr * p.grad, p.asnumpy(), p.grad.asnumpy())
                    for p in (w, b)]
        for p in (w, b):                 # SGD by the runtime-compiled kernel
            axpy_launch(ax, p.grad, p, -lr, p.size, mx)
        if check:
            for p, (ref, p0, g0) in zip((w, b), refs):
                diff = np.abs(p.asnumpy() - ref.asnumpy())
                tol = AXPY_TOL * (np.abs(p0) + lr * np.abs(g0))
                worst = max(worst, float(diff.max()))
                if not (diff <= tol).all():
                    raise AssertionError(
                        f"axpy update differs from w - lr * w.grad by "
                        f"{diff.max():.3e} at step {step}")
        losses.append(float(loss.asscalar()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = ax.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = wall / (REG_STEPS - 1) * 1e3
    log(f"  linear regression X {REG_SHAPE} f32 on {X._data.device}, "
        f"{REG_STEPS} steps, lr {lr}: loss {losses[0]:.6f} (step 0) -> "
        f"{losses[-1]:.6f} (step {REG_STEPS - 1}); every 5th "
        f"{[round(v, 6) for v in losses[::5]]}")
    log(f"  axpy update vs nd's w - lr*w.grad: max abs diff {worst:.3e} "
        f"(tol 2^-22 * (|w| + lr |grad|) elementwise); axpy launches "
        f"{launches} (want 2 x {REG_STEPS})")
    log(f"  {ms:.3f} ms per step (steps 2-{REG_STEPS}, host wall after "
        f"synchronize, the per-step loss readback included); peak device "
        f"memory {peak:.3f} GiB  [{card}]")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")
    if launches != 2 * REG_STEPS:
        raise AssertionError(f"axpy launched {launches} times, not "
                             f"{2 * REG_STEPS}")

    def one_step():
        with autograd.record():
            loss = nd.mean(nd.square(nd.dot(X, w) + b - y))
        loss.backward()
        for p in (w, b):
            axpy_launch(ax, p.grad, p, -lr, p.size, mx)
        return float(loss.asscalar())

    prof_wall, prof_busy = profile_steps(
        one_step, 5, f"5 more imperative steps at X {REG_SHAPE}", card,
        top=8)

    # nd.save / nd.load round trip, bit-exact, back onto the card
    out_dir = Path(__file__).resolve().parent / "build" / "smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    f = str(out_dir / "linreg.params")
    nd.save(f, {"w": w, "b": b})
    back = nd.load(f)
    exact = all(torch.equal(back[k]._data, v._data)
                for k, v in (("w", w), ("b", b)))
    log(f"  nd.save/nd.load: keys {sorted(back)}, on "
        f"{back['w']._data.device}, bit-exact {exact}")
    if not (exact and back["w"]._data.device == dev):
        raise AssertionError("nd.save/nd.load round trip is not bit-exact")

    # grad_req="add" and create_graph at a small size
    xs = nd.array(rng.standard_normal(1000))
    xs.attach_grad(grad_req="add")
    for _ in range(3):
        with autograd.record():
            yv = (xs * xs * xs).sum()
        yv.backward()
    xv = xs.asnumpy().astype(np.float64)
    add_err = float(np.abs(xs.grad.asnumpy() - 9 * xv ** 2).max())
    xc = nd.array(rng.standard_normal(1000))
    xc.attach_grad()
    with autograd.record():
        yc = xc * xc * xc
        dy = autograd.grad(yc, xc, create_graph=True)
    dy.backward()
    xcv = xc.asnumpy().astype(np.float64)
    cg_err = float(np.abs(xc.grad.asnumpy() - 6 * xcv).max())
    cg_d1 = float(np.abs(dy.asnumpy() - 3 * xcv ** 2).max())
    log(f"  grad_req='add' over 3 backward passes vs 9x^2: max abs err "
        f"{add_err:.3e}; create_graph d/dx of 3x^2 vs 6x: {cg_err:.3e} "
        f"(first grad vs 3x^2: {cg_d1:.3e}); tol rtol 2e-3 atol 2e-4")
    if not (np.allclose(xs.grad.asnumpy(), 9 * xv ** 2, 2e-3, 2e-4)
            and np.allclose(xc.grad.asnumpy(), 6 * xcv, 2e-3, 2e-4)
            and np.allclose(dy.asnumpy(), 3 * xcv ** 2, 2e-3, 2e-4)):
        raise AssertionError("grad_req='add' or create_graph disagree")
    del X, y
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": worst, "ms_step": ms,
            "peak_gib": peak, "loss0": losses[0], "loss_last": losses[-1],
            "busy_share": prof_busy / prof_wall}


def axpy_launch(ax, x, y, alpha, n, mx):
    """y += alpha * x through the axpy kernel, one thread an element."""
    ax.launch([x, y, alpha, n], mx.gpu(0), ((n + 255) // 256, 1, 1),
              (256, 1, 1))


def phase_rtc(dev, card, s2, ax):
    """[7b] The runtime-compiled kernels: scale2 and axpy driven through
    CudaModule at 2^26 elements and at an odd length, each result held
    against its plain version; the write, dtype, device and compile-error
    checks; then CUDA-event times beside the byte bounds and the library
    calls, and the host cost of one launch."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd, rtc
    from mxnet_tpu_torch.base import MXNetError

    res = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    s2.launches = ax.launches = 0        # the path's counts, from 0
    outs = {}
    for n in (RTC_N, RTC_ODD):
        x = nd.NDArray(torch.randn(n, device=dev, generator=g))
        y = nd.NDArray(torch.randn(n, device=dev, generator=g))
        y0 = y._data.clone()
        out = nd.zeros((n,))
        s2.launch([x, out, n], mx.gpu(0), _grid(n), (256, 1, 1))
        axpy_launch(ax, x, y, -0.75, n, mx)
        outs[n] = (x, y, y0, out)
    torch.cuda.synchronize()
    path = {"rtc_scale2": s2.launches, "rtc_axpy": ax.launches}
    for n, (x, y, y0, out) in outs.items():
        e_s2 = float((out._data - 2 * x._data).abs().max())
        want = y0 + -0.75 * x._data
        d = (y._data - want).abs()
        ratio = float((d / (AXPY_TOL * (y0.abs() + 0.75 * x._data.abs())
                            ).clamp_min(1e-30)).max())
        e_ax = float(d.max())
        res[n] = (e_s2, e_ax)
        log(f"  n={n}: scale2 vs 2*x max abs err {e_s2:.3e} (tol 0: one "
            f"exact multiply); axpy vs y + a*x max abs err {e_ax:.3e}, "
            f"err/tol {ratio:.3f} (tol 2^-22 (|y| + |a x|))")
        if e_s2 != 0.0 or ratio > 1.0:
            raise AssertionError(f"rtc kernels disagree at n={n}")
    del outs
    log(f"  path launches {path} (want 2 each)")
    if path != {"rtc_scale2": 2, "rtc_axpy": 2}:
        raise AssertionError(f"rtc path launches {path}")

    # a write reaches only the non-const pointer's array
    x = nd.array(np.arange(4096, dtype=np.float32))
    y = nd.ones((4096,))
    aliases = [y[0:100], y.detach(), y.reshape((64, 64)), y.copy(),
               y.astype("float32")]
    snaps = [a.asnumpy().copy() for a in aliases]
    versions = (x.version, y.version)
    axpy_launch(ax, x, y, 2.0, 4096, mx)
    torch.cuda.synchronize()
    only = (np.array_equal(y.asnumpy(), 1 + 2 * np.arange(4096))
            and all(np.array_equal(a.asnumpy(), s)
                    for a, s in zip(aliases, snaps))
            and np.array_equal(x.asnumpy(), np.arange(4096))
            and (x.version, y.version) == (versions[0], versions[1] + 1))
    errors_seen = []
    for what, fn in (
            ("wrong dtype", lambda: axpy_launch(ax, x, y.astype("float64"),
                                                1.0, 8, mx)),
            ("non-const CPU array", lambda: axpy_launch(
                ax, x, y.as_in_context(mx.cpu()), 1.0, 8, mx)),
            ("syntax error", lambda: rtc.CudaModule(
                'extern "C" __global__ void k(float *y) { y[0] = ; }'))):
        try:
            fn()
            errors_seen.append((what, None))
        except MXNetError as e:
            errors_seen.append((what, str(e)))
    log(f"  a write reaches only y (aliases, x and versions unchanged): "
        f"{only}")
    for what, msg in errors_seen:
        first = (msg or "NO ERROR").strip().splitlines()
        log(f"  {what}: MXNetError: {first[0][:100]}"
            + (f" ... [{len(first)} lines of log]" if len(first) > 1
               else ""))
    syntax = errors_seen[-1][1] or ""
    if not (only and all(m for _, m in errors_seen) and "error" in syntax
            and "log" in syntax):
        raise AssertionError("an rtc write or error check failed")

    # times at 2^26 f32, CUDA events; the bounds by bytes
    n = RTC_N
    x = nd.NDArray(torch.randn(n, device=dev, generator=g))
    y = nd.NDArray(torch.randn(n, device=dev, generator=g))
    alpha = 1e-3
    t = {
        "rtc_scale2": cuda_ms(lambda: s2.launch([x, y, n], mx.gpu(0),
                                                _grid(n), (256, 1, 1)), 50),
        "rtc_axpy": cuda_ms(lambda: axpy_launch(ax, x, y, alpha, n, mx), 50),
    }
    plain = {"rtc_scale2": cuda_ms(lambda: 2 * x._data, 50),
             "rtc_axpy": cuda_ms(lambda: y._data + alpha * x._data, 50)}
    lib = {"rtc_scale2": cuda_ms(lambda: torch.mul(x._data, 2,
                                                   out=y._data), 50),
           "rtc_axpy": cuda_ms(lambda: y._data.add_(x._data, alpha=alpha),
                               50)}
    bounds = {"rtc_scale2": bound(n, 8 * n, "float32"),
              "rtc_axpy": bound(2 * n, 12 * n, "float32")}
    for k in t:
        log(f"  {k} at n=2^26 f32: kernel {t[k]:.4f} ms  plain "
            f"{plain[k]:.4f} ms  library {lib[k]:.4f} ms  bound "
            f"{bounds[k][0]:.4f} ms ({bounds[k][1]})  kernel/bound "
            f"{t[k] / bounds[k][0]:.2f}x  [{card}]")

    # the host's cost of one launch: checks, packing and cuLaunchKernel on
    # a 256-element array (the device's share is negligible there)
    xs, ys = nd.ones((256,)), nd.zeros((256,))
    for _ in range(100):
        axpy_launch(ax, xs, ys, 1.0, 256, mx)
    torch.cuda.synchronize()
    reps = 2000
    t0 = time.perf_counter()
    for _ in range(reps):
        axpy_launch(ax, xs, ys, 1.0, 256, mx)
    host_us = (time.perf_counter() - t0) / reps * 1e6
    t0 = time.perf_counter()
    for _ in range(reps):
        ax._pack([xs, ys, 1.0, 256], dev)
    pack_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    log(f"  host cost of one launch: {host_us:.2f} us (of it the "
        f"signature checks and argument packing {pack_us:.2f} us)  "
        f"[{card}]")
    return {"path": path, "err": {"rtc_scale2": res[RTC_N][0],
                                  "rtc_axpy": res[RTC_N][1]},
            "ms": t, "plain": plain, "lib": lib, "bounds": bounds,
            "host_us": host_us, "pack_us": pack_us}


# -- [12] the input path -------------------------------------------------------
# (i) bitwise delivery: INPUT_N uint8 (32, 32, 3) images and int32 labels in
# batches of INPUT_BATCH through three loaders at depths 0 and 2; before
# reading each batch the consumer's stream sleeps INPUT_SLEEP cycles (~2.5 ms
# at the H100's 1.98 GHz), so the producer runs ahead and the three-slot
# ring wraps ten times an epoch.
INPUT_N, INPUT_BATCH, INPUT_SLEEP = 1024, 32, 5_000_000
# (iv) GPT-2 small, full width, B=8, T=1024, bf16, fed by the DataLoader
GPT_INPUT_BATCH, GPT_INPUT_STEPS, GPT_INPUT_LR = 8, 3, 6e-4


def _trace_events(prof, name):
    """The events of a torch.profiler run, from its chrome trace (written
    under build/): the trace holds every copy, where ``key_averages()``
    may miss some."""
    import json as _json

    out = Path(__file__).resolve().parent / "build"
    out.mkdir(exist_ok=True)
    path = out / f"{name}_trace.json"
    prof.export_chrome_trace(str(path))
    events = _json.loads(path.read_text())["traceEvents"]
    path.unlink()
    return events


def _delivery(dev, kind, depth, ds, img, lab):
    """[12](i) one loader kind at one depth: every batch read back after a
    sleep on the consumer's stream equals the host's bytes; returns the
    batches and the seconds."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.gluon.data import DataLoader, DevicePrefetcher

    kw = {"threads": dict(num_workers=2),
          "processes": dict(num_workers=2, thread_pool=False),
          "pinned": dict(num_workers=2, pin_memory=True)}[kind]
    loader = DataLoader(ds, batch_size=INPUT_BATCH, **kw)
    held_x = torch.empty(img.shape, dtype=torch.uint8, device=dev)
    held_y = torch.empty(lab.shape, dtype=torch.int32, device=dev)
    n = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (x, y) in enumerate(DevicePrefetcher(loader, depth=depth)):
        if x._data.device != dev or y._data.device != dev:
            raise AssertionError(f"batch {i} landed on {x.context}")
        torch.cuda._sleep(INPUT_SLEEP)
        sl = slice(i * INPUT_BATCH, (i + 1) * INPUT_BATCH)
        held_x[sl].copy_(x._data)
        held_y[sl].copy_(y._data)
        del x, y
        n += 1
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ok = bool(np.array_equal(held_x.cpu().numpy(), img)) and \
        bool(np.array_equal(held_y.cpu().numpy(), lab))
    return n, ok, secs


#: a marker copy of this many bytes (plus the case's index) opens each
#: case of [12](i) in the one trace they share
MARK_BYTES = 1000


def _delivery_data():
    import numpy as np

    rng = np.random.RandomState(SEED + 70)
    img = rng.randint(0, 256, (INPUT_N, 32, 32, 3)).astype(np.uint8)
    lab = rng.randint(0, 1000, INPUT_N).astype(np.int32)
    return img, lab


def delivery_check(dev=None):
    """[12](i), run by ``phase_input`` in a process of its own: every
    loader kind at depths 0 and 2."""
    import torch

    from mxnet_tpu_torch.context import context_of
    from mxnet_tpu_torch.gluon.data import ArrayDataset

    from torch.profiler import ProfilerActivity, profile

    dev = dev or torch.device("cuda", 0)
    img, lab = _delivery_data()
    ds = ArrayDataset(img, lab)
    cases = [(k, d) for k in ("threads", "processes", "pinned")
             for d in (0, 2)]
    runs = []
    torch.cuda.synchronize()
    # one trace for every case: in a process that has opened several,
    # torch.profiler's trace lost some copy records
    with context_of(dev), profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)     # the trace drops what runs as it starts
        for i, (kind, depth) in enumerate(cases + [(None, None)]):
            torch.ones(MARK_BYTES + i, dtype=torch.uint8).to(dev)
            torch.cuda.synchronize()
            if kind is not None:
                runs.append(_delivery(dev, kind, depth, ds, img, lab))
    h2d = sorted((e for e in _trace_events(prof, "input_delivery")
                  if e.get("cat") == "gpu_memcpy"
                  and "HtoD" in e.get("name", "")), key=lambda e: e["ts"])
    marks = [j for j, e in enumerate(h2d)
             if e["args"].get("bytes", 0) - MARK_BYTES in range(len(cases)
                                                                 + 1)]
    nb = -(-INPUT_N // INPUT_BATCH)
    bad = len(marks) != len(cases) + 1
    for i, ((kind, depth), (n, ok, secs)) in enumerate(zip(cases, runs)):
        kinds = {}
        for e in (h2d[marks[i] + 1:marks[i + 1]] if not bad else []):
            kinds[e["name"]] = kinds.get(e["name"], 0) + 1
        per_batch = sum(kinds.values()) / max(n, 1)
        log(f"  (i) {kind:9s} depth {depth}: {n} batches of {INPUT_BATCH}, "
            f"bitwise {ok}; host-to-device copies a batch {per_batch:g} "
            f"(arrays a batch: 2; {kinds}); {secs:.2f} s")
        bad = bad or not (n == nb and ok and per_batch == 2)
    for depth in (0, 2):
        n, ok = _card_samples(dev, img, lab, depth)
        log(f"  (i) card samples depth {depth}: a dataset on the card through "
            f"ToTensor behind a sleep on the worker's stream, {n} batches of "
            f"{INPUT_BATCH}, bitwise {ok}")
        bad = bad or not (n == CARD_SAMPLES // INPUT_BATCH and ok)
    if bad:
        raise AssertionError("[12](i) a loader delivered wrong batches or "
                             f"copies ({len(marks)} markers in the trace)")


#: [12](i)'s samples held on the card, and the cycles each sample's
#: transform sleeps first (~2.5 ms at 1.98 GHz)
CARD_SAMPLES, CARD_SLEEP = 256, 5_000_000


def _card_samples(dev, img, lab, depth):
    """[12](i) a dataset on the card, transformed by
    ``vision.transforms.ToTensor`` in two worker threads behind a sleep on
    their stream: the prefetcher must stack each batch after the
    transform's kernels; bitwise against ToTensor of the whole array."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.context import context_of
    from mxnet_tpu_torch.gluon.data import (ArrayDataset, DataLoader,
                                            DevicePrefetcher)
    from mxnet_tpu_torch.gluon.data.vision import transforms

    ctx = context_of(dev)
    img, lab = img[:CARD_SAMPLES], lab[:CARD_SAMPLES]
    to_tensor = transforms.ToTensor()
    want = to_tensor(nd.array(img, ctx=ctx, dtype="uint8")).asnumpy()

    def slow_to_tensor(x):
        torch.cuda._sleep(CARD_SLEEP)
        return to_tensor(x)

    ds = ArrayDataset(nd.array(img, ctx=ctx, dtype="uint8"), lab) \
        .transform_first(slow_to_tensor)
    xs, ys = [], []
    with ctx:
        for x, y in DevicePrefetcher(DataLoader(ds, batch_size=INPUT_BATCH,
                                                num_workers=2), depth=depth):
            xs.append(x.asnumpy())
            ys.append(y.asnumpy())
    ok = bool(np.array_equal(np.concatenate(xs), want)) and \
        bool(np.array_equal(np.concatenate(ys), lab))
    return len(xs), ok


def _intervals_union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(iv, union):
    tot = 0.0
    for a, b in iv:
        for c, d in union:
            tot += max(0.0, min(b, d) - max(a, c))
    return tot


def _copy_overlap(step, steps, what, card, start=None):
    """torch.profiler (every thread) over ``steps`` calls of ``step``: the
    prefetcher's host-to-device copies (those on a stream that runs no
    kernel) against the step's kernels, the h2d_prefetch spans, and the
    device's busy share.  ``start``, when given, runs inside the trace
    before the clock starts (it starts a prefetcher, so the window opens
    on an empty ring, as a timed loop's does)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch import profiler as mxprof

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **mxprof.all_threads()) as prof:
        time.sleep(0.2)     # the trace drops what runs as it starts
        if start is not None:
            start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = _trace_events(prof, "input_overlap")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    kstreams = {e["args"].get("stream") for e in kernels}
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "HtoD" in e.get("name", "")]
    copies = [e for e in h2d if e["args"].get("stream") not in kstreams]
    spans = [e for e in events if e.get("name") == "h2d_prefetch"
             and e.get("cat") in ("user_annotation", "cpu_op")]
    kern = _intervals_union([(e["ts"], e["ts"] + e["dur"])
                             for e in kernels])
    civ = [(e["ts"], e["ts"] + e["dur"]) for e in copies]
    copy_ms = sum(b - a for a, b in civ) / 1e3
    over_ms = _overlap(civ, kern) / 1e3
    busy = sum(b - a for a, b in _intervals_union(
        [(e["ts"], e["ts"] + e["dur"]) for e in kernels + h2d])) / 1e3
    log(f"  {what}: {len(copies)} prefetch copies on stream(s) "
        f"{sorted({e['args'].get('stream') for e in copies})} "
        f"({len(h2d) - len(copies)} other host-to-device copies, on the "
        f"kernels' stream(s) {sorted(kstreams)}); prefetch copies "
        f"{copy_ms:.3f} ms, of which {over_ms:.3f} ms overlap the step's "
        f"kernels ({'yes' if over_ms > 0 else 'no'}); {len(spans)} "
        f"h2d_prefetch spans; wall {wall / steps:.3f} ms a step, device "
        f"busy {busy / steps:.3f} ms a step, busy share {busy / wall:.3f}"
        f"  [{card}]")
    return {"copies": len(copies), "copy_ms": copy_ms, "overlap_ms": over_ms,
            "busy_share": busy / wall, "h2d_prefetch_spans": len(spans)}


def phase_input(dev, card, rtc_kernels):
    """[12] The input path on the card: (i) bitwise delivery through every
    transport and depth; (ii) ResNet-50 v1 at bench_resnet's configuration
    fed by the prefetcher; (iii) the JPEG pipeline where a codec exists;
    (iv) GPT-2 small trained from a DataLoader over the repo's Markdown;
    (v) records and the resumable loader.  Returns the kernel launches of
    each path's step and the numbers of (ii)-(iv)."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import _native, recordio
    from mxnet_tpu_torch.context import context_of
    from mxnet_tpu_torch.gluon.data import (DataLoader, DevicePrefetcher,
                                            RecordFileDataset)
    from mxnet_tpu_torch.tools import bench_resnet

    root = Path(__file__).resolve().parent
    ctx = context_of(dev)
    res, launches = {}, {}

    # (i) bitwise delivery, every transport at depths 0 and 2, in a
    # process of its own: in a process that had traced the earlier phases,
    # torch.profiler's trace lost some copy records (6 of 64 in one run)
    r = subprocess.run([sys.executable, "-c",
                        "import chip_smoke; chip_smoke.delivery_check()"],
                       cwd=str(root), capture_output=True, text=True,
                       timeout=600)
    for line in r.stdout.splitlines():
        log(line)
    if r.returncode != 0:
        log(r.stderr[-4000:])
        raise AssertionError("[12](i) delivery check failed")
    img, _ = _delivery_data()

    # (ii) ResNet-50 through the captured train_step, fed as bench.py feeds
    with ctx:
        step, x, y = bench_resnet.stepper("captured", RESNET_BATCH,
                                          RESNET_IMAGE, "NCHW", dev)
        prev = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        try:
            warm = [float(step(x, y)) for _ in range(2)]
            stall, stall_sync = bench_resnet.stall_shares(
                step, y, RESNET_BATCH, RESNET_IMAGE, "NCHW", dev,
                RESNET_STEPS)
            it = iter(DevicePrefetcher(bench_resnet.host_batches(
                RESNET_BATCH, RESNET_IMAGE, "NCHW", y, RESNET_STEPS + 1),
                depth=2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = []
            for _ in range(RESNET_STEPS):
                xb, yb = next(it)
                outs.append(step(xb, yb))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            losses = [float(o) for o in outs]
            _zero_counts()
            _rtc_zero(rtc_kernels)
            step(*next(it))
            torch.cuda.synchronize()
            launches["input_path_resnet_train_step"] = dict(
                _counts(), **_rtc_counts(rtc_kernels))
            it.close()
            # the timed loop's window again under the profiler: a fresh
            # prefetcher, its ring empty as the clock starts, over as many
            # steps, so the busy share is the producer-bound loop's
            fed = {}

            def start():
                fed["it"] = iter(DevicePrefetcher(bench_resnet.host_batches(
                    RESNET_BATCH, RESNET_IMAGE, "NCHW", y, RESNET_STEPS),
                    depth=2))

            ov = _copy_overlap(lambda: step(*next(fed["it"])), RESNET_STEPS,
                               f"(ii) {RESNET_STEPS} prefetched captured "
                               "steps from an empty ring", card, start=start)
            # the same with the host work done ahead: the producer only
            # stages and copies, so the copies land inside the steps
            xb0 = next(bench_resnet.host_batches(
                RESNET_BATCH, RESNET_IMAGE, "NCHW", y, 1))[0]
            ready = iter(DevicePrefetcher(
                ((xb0, y) for _ in range(8)), depth=2))
            step(*next(ready))
            ov_ready = _copy_overlap(lambda: step(*next(ready)), 3,
                                     "(ii) the same, host work done ahead",
                                     card)
        finally:
            torch.backends.cudnn.benchmark = prev
    sps = RESNET_BATCH * RESNET_STEPS / dt
    res["resnet"] = dict(data_stall_share=stall,
                         data_stall_share_sync=stall_sync,
                         samples_per_sec=sps, ms_per_step=dt / RESNET_STEPS
                         * 1e3, overlap_ms_host_ahead=ov_ready["overlap_ms"],
                         **ov)
    log(f"  (ii) ResNet-50 v1 B={RESNET_BATCH} {RESNET_IMAGE}x{RESNET_IMAGE} "
        f"bf16 NCHW, captured train_step fed by DevicePrefetcher "
        f"(normalize_flip_batch_np, host bf16 cast): data_stall_share "
        f"{stall} (depth 2), data_stall_share_sync {stall_sync} (depth 0); "
        f"{sps:.1f} samples/s, {dt / RESNET_STEPS * 1e3:.2f} ms a step over "
        f"{RESNET_STEPS} prefetched steps; losses {warm + losses[:3]}...; "
        f"busy share {ov['busy_share']:.3f}; launches "
        f"{launches['input_path_resnet_train_step']}  [{card}]")
    if not (all(np.isfinite(warm + losses)) and ov["copies"] >= 1
            and ov["h2d_prefetch_spans"] >= 1 and ov_ready["overlap_ms"] > 0
            and not any(launches["input_path_resnet_train_step"].values())):
        raise AssertionError(f"[12](ii) ResNet input path: {res['resnet']}")
    del step, x, y, it, fed, outs, ready, xb0
    torch.cuda.empty_cache()

    # (iii) the JPEG input pipeline, where a codec exists
    try:
        import PIL  # noqa: F401
        codec = True
    except ImportError:
        codec = False
    log(f"  (iii) codecs: PIL {'installed' if codec else 'not installed'}; "
        f"native libjpeg path (src/libmxtpu_img.so) "
        f"{'built' if _native.has_jpeg() else 'not built'}")
    if codec:
        from mxnet_tpu_torch.tools import bench_input_pipeline

        pipe = bench_input_pipeline.run(device=dev)
        res["jpeg"] = pipe
        log(f"  (iii) input_pipeline_imgs_per_sec {pipe['value']:.1f} "
            f"(legacy per-sample batchify {pipe['legacy_ips']:.1f}, speedup "
            f"{pipe['speedup']:.3f}), stall share prefetch "
            f"{pipe['stall_share_prefetch']} sync "
            f"{pipe['stall_share_sync']}, codec {pipe['codec']}  [{card}]")
    else:
        log("  (iii) not run: no image codec is installed on this host")

    # (iv) GPT-2 small trained from a DataLoader over the repo's Markdown
    launches["input_path_gpt_train_step"], res["gpt"] = _gpt_from_loader(
        dev, card, root, rtc_kernels)

    # (v) records written with recordio.pack, read back, and the resumable
    # loader stopped mid-epoch and restored
    rec_dir = root / "build" / "input_records"
    rec_dir.mkdir(parents=True, exist_ok=True)
    rec, idx = str(rec_dir / "raw.rec"), str(rec_dir / "raw.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    packed = []
    for i in range(256):
        packed.append(recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                                    img[i].tobytes()))
        w.write_idx(i, packed[-1])
    w.close()
    r = recordio.MXIndexedRecordIO(idx, rec, "r")
    same_idx = all(r.read_idx(i) == packed[i] for i in range(256))
    r.close()
    rds = RecordFileDataset(rec)
    same_ds = all(rds[i] == packed[i] for i in range(len(rds)))

    def decode(raw):
        hdr, payload = recordio.unpack(raw)
        return (np.frombuffer(payload, np.uint8).reshape(32, 32, 3),
                np.int32(hdr.id))

    dec = rds.transform(decode)
    with ctx:
        got = list(DevicePrefetcher(DataLoader(dec, batch_size=INPUT_BATCH,
                                               num_workers=2), depth=2))
    same_card = bool(np.array_equal(
        np.concatenate([b[0].asnumpy() for b in got]), img[:256]))
    seen = []
    with ctx:
        first = DevicePrefetcher(DataLoader(dec, batch_size=16,
                                            shuffle=True, seed=7,
                                            num_workers=2), depth=2)
        itr = iter(first)
        for _ in range(5):
            seen.extend(next(itr)[1].asnumpy().tolist())
        sd = first.state_dict()
        first.close()
        again = DevicePrefetcher(DataLoader(dec, batch_size=16, shuffle=True,
                                            seed=0, num_workers=2), depth=2)
        again.load_state_dict(sd)
        for b in again:
            seen.extend(b[1].asnumpy().tolist())
    once = sorted(seen) == list(range(256))
    log(f"  (v) 256 raw records (recordio.pack) read back bitwise through "
        f"MXIndexedRecordIO {same_idx} and RecordFileDataset {same_ds}, "
        f"through DataLoader and DevicePrefetcher to the card {same_card}; "
        f"a seed= loader stopped after 80 samples (cursor {sd['cursor']}), "
        f"restored, delivered the other {len(seen) - 80}: every sample "
        f"exactly once {once}")
    if not (same_idx and same_ds and same_card and once
            and sd["cursor"] == 80):
        raise AssertionError("[12](v) records or the resumable loader")
    return launches, res


def _rtc_zero(rtc_kernels):
    for k in rtc_kernels:
        k.launches = 0


def _rtc_counts(rtc_kernels):
    return dict(zip(("rtc_scale2", "rtc_axpy"),
                    (k.launches for k in rtc_kernels)))


def _gpt_from_loader(dev, card, root, rtc_kernels):
    """[12](iv) GPT-2 small (full width, bf16, flash trunk) trained by
    gluon.Trainer.train_step on batches of a DataLoader over
    CharTokenDataset (the repo's Markdown files, T=1024) with an
    IntervalSampler, through DevicePrefetcher.  Returns the kernel
    launches of each step (all equal) and the numbers."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import gluon, random as mxrandom
    from mxnet_tpu_torch.context import context_of
    from mxnet_tpu_torch.gluon.contrib.data import (CharTokenDataset,
                                                    IntervalSampler)
    from mxnet_tpu_torch.gluon.data import DataLoader, DevicePrefetcher
    from mxnet_tpu_torch.gluon.model_zoo import gpt

    ctx = context_of(dev)
    B, T = GPT_INPUT_BATCH, TRAIN_SHAPE[2]
    corpus = root / "build" / "input_corpus.txt"
    corpus.parent.mkdir(exist_ok=True)
    corpus.write_text("\n".join(p.read_text(encoding="utf-8")
                                for p in sorted(root.glob("*.md"))),
                      encoding="utf-8")
    ds = CharTokenDataset(str(corpus), seq_len=T)
    with ctx:
        loader = DataLoader(ds, batch_size=B, last_batch="discard",
                            sampler=IntervalSampler(len(ds), len(ds) // B),
                            num_workers=2)
        mxrandom.seed(SEED + 80)
        model = gpt.gpt2_small(scan_layers=True, attention_impl="flash",
                               dropout=0.0)
        model.cast("bfloat16")
        trainer = gluon.Trainer(model.collect_params(), "adamw",
                                {"learning_rate": GPT_INPUT_LR, "wd": 0.01,
                                 "multi_precision": True})
        loss_fn = gpt.GPTLMLoss()
        losses, per_step = [], []
        it = iter(DevicePrefetcher(loader, depth=2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GPT_INPUT_STEPS):
            xb, _yb = next(it)
            _zero_counts()
            _rtc_zero(rtc_kernels)
            losses.append(float(trainer.train_step(model, loss_fn, xb,
                                                   xb).mean().asnumpy()))
            per_step.append(dict(_counts(), **_rtc_counts(rtc_kernels)))
        dt = time.perf_counter() - t0
    L = 12
    log(f"  (iv) GPT-2 small bf16 flash, B={B}, T={T}, gluon.Trainer "
        f"train_step (AdamW lr {GPT_INPUT_LR}) on DataLoader(CharTokenDataset"
        f"({len(ds)} windows of the repo's Markdown, vocabulary "
        f"{len(ds.vocab)}), IntervalSampler) through DevicePrefetcher: "
        f"losses {[round(v, 4) for v in losses]}, {dt / GPT_INPUT_STEPS * 1e3:.2f} "
        f"ms a step (first included); launches a step {per_step}  [{card}]")
    flash = ("flash_attention_fwd", "flash_attention_dq",
             "flash_attention_dkv")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and all(c[k] == L for c in per_step for k in flash)):
        raise AssertionError(f"[12](iv) GPT input path: {losses}, {per_step}")
    del model, trainer, it
    torch.cuda.empty_cache()
    return per_step[-1], {"losses": losses, "ms_per_step":
                          dt / GPT_INPUT_STEPS * 1e3}


# -- [13] the recommender path (row-sparse tables, CSR) -----------------------
# bench_embedding's configuration (bench.py:216-221, 2556-2577): (a) a
# ShardedEmbedding(4096, 64) and Dense(1) at batch 512; (b) the same model
# at a table a recommender holds, 2^24 rows (BENCH_EMB_VOCAB) at batch 8192
# (BENCH_EMB_BATCH): 4 GiB of table and 8 GiB of Adam states in f32.
EMB_DIM, EMB_STEPS = 64, 20
EMB_CONFIGS = {"a": (4096, 512), "b": (1 << 24, 8192)}
EMB_BITWISE_STEPS, EMB_HOST_STEPS, EMB_DENSE_STEPS = 5, 3, 5
# (b)'s peak allocated memory over the bench run alone (above what earlier
# phases still hold): the table and Adam's two states, plus less than 1 GiB
# of everything else; a dense (2^24, 64) f32 gradient or update temporary
# would add 4 GiB
EMB_PEAK_GIB = 13.0
# (ii) card against host: the ROADMAP's training tolerances on the weights
EMB_TRAIN_TOL = (2e-4, 2e-5)
# (v) the CSR product at the width at which upstream's
# example/sparse/linear_classification reads Avazu: 8192 rows of 1,000,000
# features, ~15 nonzeros a row
CSR_ROWS, CSR_COLS, CSR_NNZ_ROW = 8192, 1_000_000, 15
CSR_OUT_TOL, CSR_GRAD_TOL = (1e-4, 1e-5), (2e-3, 2e-4)
LIBSVM_STEPS = 3
# CTC timed at a speech-recognition shape: N, T frames, C classes, L labels.
CTC_SHAPE = (32, 500, 30, 100)


def _emb_touched(xs, vocab, dev):
    """A (vocab,) bool of the rows the id batches touch."""
    import torch

    mask = torch.zeros(vocab, dtype=torch.bool, device=dev)
    for x in xs:
        mask[x._data.long().clamp(0, vocab - 1)] = True
    return mask


def _emb_states(trainer):
    out = []
    for i in sorted(trainer._updaters[0].states):
        st = trainer._updaters[0].states[i]
        out.extend(s._data for s in (st if isinstance(st, (list, tuple))
                                     else [st]) if s is not None)
    return out


def _emb_bitwise(dev, card, name, vocab, batch):
    """[13](i) at one configuration: EMB_BITWISE_STEPS captured steps
    against the eager row-sparse oracle from the same state, bitwise in
    losses, weights and both Adam states; rows no batch touched keep their
    initial bytes (states zero there); one readback a step; one recording
    a bucket; no sparse_fallback event."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import numerics, telemetry
    from mxnet_tpu_torch.embedding import prep
    from mxnet_tpu_torch.gluon import captured
    from mxnet_tpu_torch.tools import bench_embedding
    from mxnet_tpu_torch.tools.bench_trainer import _env

    steps = EMB_BITWISE_STEPS
    runs = {}
    for mode in ("1", "0"):
        net, trainer, loss_fn, xs = bench_embedding.build(
            vocab, EMB_DIM, batch, steps, dev)
        xs = xs[:steps]
        table = net[0].weight.data()._data
        init = table.detach().clone() if mode == "1" else None
        fallbacks = telemetry.event_counts().get("sparse_fallback", 0)
        captured.reset_counters()
        numerics.reset_readback_count()
        with _env(MXTPU_SPARSE_CAPTURED=mode):
            losses = [trainer.train_step(net, loss_fn, x,
                                         batch_size=batch).asnumpy()
                      for x in xs]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        fired = telemetry.event_counts().get("sparse_fallback", 0) \
            - fallbacks
        runs[mode] = dict(
            losses=losses, params=[p.data()._data for p in trainer._params],
            states=_emb_states(trainer), init=init,
            dispatches=captured.dispatch_count(),
            traces=captured.trace_count(),
            readbacks=numerics.readback_count(), fired=fired, xs=xs)
        del net, trainer
    cap, eag = runs["1"], runs["0"]
    buckets = {prep.bucket_for(len(np.unique(np.clip(
        x.asnumpy().astype(np.int64), 0, vocab - 1)))) for x in cap["xs"]}
    same = (all(np.array_equal(a, b) for a, b in zip(cap["losses"],
                                                     eag["losses"]))
            and all(torch.equal(a, b) for a, b in zip(cap["params"],
                                                      eag["params"]))
            and len(cap["states"]) == len(eag["states"]) == 2 * len(
                cap["params"])
            and all(torch.equal(a, b) for a, b in zip(cap["states"],
                                                      eag["states"])))
    touched = _emb_touched(cap["xs"], vocab, dev)
    moved = (cap["params"][0] != cap["init"]).any(dim=1)
    state_set = [(s != 0).any(dim=1) for s in cap["states"][:2]]
    still = not bool((moved & ~touched).any()) and not any(
        bool((m & ~touched).any()) for m in state_set)
    log(f"    ({name}) vocab {vocab}, batch {batch}: {steps} captured steps "
        f"{'==' if same else '!='} eager bitwise (losses, "
        f"{len(cap['params'])} weights, {len(cap['states'])} Adam states); "
        f"untouched rows {'unmoved' if still else 'MOVED'} "
        f"({int(touched.sum())} of {vocab} rows touched); dispatches "
        f"{cap['dispatches']}, guard readbacks {cap['readbacks']} (plus "
        f"one read of the resident ids a step), recordings "
        f"{cap['traces']} for buckets {sorted(buckets)}, sparse_fallback "
        f"events {cap['fired']}; eager: fallback events {eag['fired']}  "
        f"[{card}]")
    if not same or not still:
        raise AssertionError(f"[13](i) {name}: captured != eager bitwise or "
                             "an untouched row moved")
    if cap["dispatches"] != steps or cap["readbacks"] != steps \
            or cap["traces"] != len(buckets) or cap["fired"] \
            or eag["fired"] != steps:
        raise AssertionError(f"[13](i) {name}: dispatches, readbacks, "
                             "recordings or fallback events off")
    return {"bitwise": same, "buckets": sorted(buckets),
            "recordings": cap["traces"], "touched_rows": int(touched.sum())}


def _emb_card_vs_host(dev, card):
    """[13](ii) (a) for EMB_HOST_STEPS captured steps on the card and on
    the host from the same numpy state and ids: losses and weights within
    EMB_TRAIN_TOL."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.context import cpu
    from mxnet_tpu_torch.tools import bench_embedding

    vocab, batch = EMB_CONFIGS["a"]
    out = []
    state = None
    for where in (dev, torch.device("cpu")):
        net, trainer, loss_fn, xs = bench_embedding.build(
            vocab, EMB_DIM, batch, EMB_HOST_STEPS, where)
        params = list(net.collect_params().values())
        if state is None:
            state = [p.data().asnumpy() for p in params]
        else:
            for p, v in zip(params, state):
                p.set_data(nd.array(v, ctx=cpu()))
        losses = [float(trainer.train_step(net, loss_fn, x,
                                           batch_size=batch).asscalar())
                  for x in xs[:EMB_HOST_STEPS]]
        out.append((losses, [p.data().asnumpy() for p in params]))
    (card_losses, card_w), (host_losses, host_w) = out
    rtol, atol = EMB_TRAIN_TOL
    worst = max(float(np.max(np.abs(a - b) / (atol + rtol * np.abs(b))))
                for a, b in zip(card_w + [np.array(card_losses)],
                                host_w + [np.array(host_losses)]))
    log(f"    (ii) (a) card against host, {EMB_HOST_STEPS} captured Adam "
        f"steps: losses {card_losses} vs {host_losses}; worst |err| / "
        f"(atol + rtol |host|) over the losses and weights {worst:.3f} "
        f"(rtol {rtol}, atol {atol})  [{card}]")
    if not worst <= 1.0:
        raise AssertionError("[13](ii) card and host disagree")
    return worst


def _emb_bench(dev, card):
    """[13](iii) tools.bench_embedding.run at (a) and (b), each with its
    peak allocated memory; (b)'s peak under EMB_PEAK_GIB; then (b) with a
    dense-gradient Embedding for the record."""
    import gc

    import torch

    from mxnet_tpu_torch.tools import bench_embedding

    lines = {}
    for name, (vocab, batch) in EMB_CONFIGS.items():
        gc.collect()
        torch.cuda.empty_cache()
        line = bench_embedding.run(vocab, EMB_DIM, batch, EMB_STEPS, dev)
        line["config"] = name
        log("    (iii) " + json.dumps(line))
        lines[name] = line
    peak = lines["b"]["peak_mem_gib"]
    log(f"    (iii) (b) peak allocated by the run {peak:.3f} GiB against "
        f"{EMB_PEAK_GIB} (table + Adam states: "
        f"{3 * (1 << 24) * EMB_DIM * 4 / 2 ** 30:.1f} GiB; earlier phases "
        f"still hold {lines['b']['base_mem_gib']:.3f} GiB)  [{card}]")
    if not peak < EMB_PEAK_GIB:
        raise AssertionError("[13](iii) (b) holds a dense temporary")
    gc.collect()
    torch.cuda.empty_cache()
    vocab, batch = EMB_CONFIGS["b"]
    dense = bench_embedding.run(vocab, EMB_DIM, batch, EMB_DENSE_STEPS, dev,
                                sparse=False)
    dense["config"] = "b, dense gradient (for the record)"
    log("    (iii) " + json.dumps(dense))
    lines["b_dense"] = dense
    return lines


def _emb_prefetched(dev, card, resident_lookup_us):
    """[13](iv) DevicePrefetcher(sparse_tables=net) at depth 2 feeding (a)'s
    captured step from host id batches: every prep popped exactly once,
    lookup_us with and without the prefetcher."""
    import numpy as np

    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.embedding import prep
    from mxnet_tpu_torch.gluon import captured
    from mxnet_tpu_torch.gluon.data import DevicePrefetcher
    from mxnet_tpu_torch.tools import bench_embedding

    vocab, batch = EMB_CONFIGS["a"]
    net, trainer, loss_fn, xs = bench_embedding.build(vocab, EMB_DIM, batch,
                                                      EMB_STEPS, dev)
    host = [x.asnumpy() for x in xs]
    popped, real_pop = [], prep.pop_prep

    def pop(data):
        got = real_pop(data)
        popped.append(got is not None)
        return got

    prep.pop_prep = pop
    try:
        lookups, n = [], 0
        captured.reset_counters()
        for x in DevicePrefetcher(host, depth=2, sparse_tables=net):
            float(trainer.train_step(net, loss_fn, x,
                                     batch_size=batch).asscalar())
            lookups.append(telemetry.recent_steps()[-1]["lookup_us"])
            n += 1
    finally:
        prep.pop_prep = real_pop
    left = len(prep._PREP_CACHE)
    warm = lookups[4:]
    lookup_us = float(np.mean(warm))
    log(f"    (iv) DevicePrefetcher(sparse_tables=net, depth=2) feeding "
        f"(a)'s captured step: {n} steps, {sum(popped)} preps popped of "
        f"{len(popped)} pops, {left} left stashed, dispatches "
        f"{captured.dispatch_count()}; lookup_us {lookup_us:.1f} prefetched "
        f"(mean of steps 5-{n}) against {resident_lookup_us:.1f} on "
        f"resident batches (the bench's line)  [{card}]")
    if n != len(host) or popped != [True] * n or left \
            or captured.dispatch_count() != n:
        raise AssertionError("[13](iv) a prep was not popped exactly once")
    if not lookup_us < resident_lookup_us:
        raise AssertionError("[13](iv) the prefetched lookup is no cheaper")
    return {"lookup_us_prefetched": lookup_us,
            "lookup_us_resident": resident_lookup_us}


def _csr_parts(rng, rows):
    """(indptr, cols, vals) of a ``rows`` x CSR_COLS matrix with about
    CSR_NNZ_ROW distinct sorted columns a row."""
    import numpy as np

    r = rng.randint(0, rows, rows * CSR_NNZ_ROW).astype(np.int64)
    key = np.unique(r * CSR_COLS + rng.randint(0, CSR_COLS, r.size))
    counts = np.bincount(key // CSR_COLS, minlength=rows)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return (indptr, key % CSR_COLS,
            rng.standard_normal(key.size).astype(np.float32))


def _write_libsvm(path, rng):
    """CSR_ROWS rows in LibSVM text, labelled by the sign of a hidden linear
    model (examples/linear_classification_libsvm.py's problem at CSR_COLS
    features)."""
    import numpy as np

    w_true = rng.standard_normal(CSR_COLS).astype(np.float32)
    indptr, cols, vals = _csr_parts(rng, CSR_ROWS)
    with open(path, "w") as f:
        for i in range(len(indptr) - 1):
            c, v = cols[indptr[i]:indptr[i + 1]], vals[indptr[i]:indptr[i + 1]]
            y = 1 if float(v @ w_true[c]) > 0 else 0
            f.write(f"{y} " + " ".join(f"{a}:{b:.4f}" for a, b in zip(c, v))
                    + "\n")


def _csr_card_vs_host(dev, card):
    """[13](v) nd.sparse.dot(csr, W) and its gradient with respect to W at
    CSR_ROWS x CSR_COLS, card against host; then LIBSVM_STEPS steps of
    examples/linear_classification_libsvm.py's model (logistic regression
    by nd.sparse.dot, SGD at lr 1) from a LibSVMIter over a file written
    here."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import autograd, io, nd
    from mxnet_tpu_torch.context import context_of, cpu
    from mxnet_tpu_torch.ndarray import sparse

    rng = np.random.RandomState(SEED)
    indptr, cols, vals = _csr_parts(rng, CSR_ROWS)
    w = (rng.standard_normal((CSR_COLS, 1)) * 0.01).astype(np.float32)
    cot = rng.standard_normal((CSR_ROWS, 1)).astype(np.float32)
    got = []
    for ctx in (context_of(dev), cpu()):
        with ctx:
            a = sparse.csr_matrix((vals, cols, indptr),
                                  shape=(CSR_ROWS, CSR_COLS))
            wn = nd.array(w)
            wn.attach_grad()
            with autograd.record():
                y = nd.sparse.dot(a, wn)
                loss = (y * nd.array(cot)).sum()
            loss.backward()
            got.append((y.asnumpy(), wn.grad.asnumpy()))
    errs = []
    for i, (rtol, atol) in enumerate((CSR_OUT_TOL, CSR_GRAD_TOL)):
        c, h = got[0][i], got[1][i]
        errs.append(float(np.max(np.abs(c - h) / (atol + rtol * np.abs(h)))))
    log(f"    (v) nd.sparse.dot(csr {CSR_ROWS}x{CSR_COLS}, "
        f"{indptr[-1]} stored, W ({CSR_COLS}, 1)) card against host: "
        f"worst |err| / tol {errs[0]:.3f} (output), {errs[1]:.3f} "
        f"(dW)  [{card}]")
    if not max(errs) <= 1.0:
        raise AssertionError("[13](v) CSR dot disagrees card/host")

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.libsvm")
        _write_libsvm(path, np.random.RandomState(SEED + 1))
        with context_of(dev):
            train = io.LibSVMIter(data_libsvm=path, data_shape=(CSR_COLS,),
                                  batch_size=CSR_ROWS)
            w_nd, b_nd = nd.zeros((CSR_COLS, 1)), nd.zeros((1,))
            w_nd.attach_grad()
            b_nd.attach_grad()
            losses = []
            for _ in range(LIBSVM_STEPS):        # one batch an epoch
                train.reset()
                batch = next(iter(train))
                x_csr, y = batch.data[0], batch.label[0]
                assert x_csr.stype == "csr"
                yv = y.reshape((-1, 1))
                with autograd.record():
                    logits = nd.sparse.dot(x_csr, w_nd) + b_nd
                    loss = nd.mean(nd.relu(logits) - logits * yv
                                   + nd.log(1 + nd.exp(-nd.abs(logits))))
                loss.backward()
                for p in (w_nd, b_nd):
                    p._set_data(p._data - 1.0 * p.grad._data)
                losses.append(float(loss.asscalar()))
    log(f"    (v) linear_classification_libsvm's model, {LIBSVM_STEPS} steps "
        f"on one LibSVMIter CSR batch of {CSR_ROWS} x {CSR_COLS}: losses "
        f"{losses}  [{card}]")
    if len(losses) != LIBSVM_STEPS or not all(np.isfinite(losses)) \
            or not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError("[13](v) the LibSVM model did not train")
    return {"dot_err": errs, "libsvm_losses": losses}


def _ctc_on_card(dev, card):
    """CTC's probe batch (one sample that cannot fit its frames) on the card:
    a finite loss of 1e30 and a finite gradient, as on the host."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import ctc

    pred = np.random.RandomState(0).randn(2, 3, 5).astype(np.float32)
    label = np.array([[1, 2, 0, 0], [1, 1, 2, 2]], np.float32)
    got = []
    for where in (dev, torch.device("cpu")):
        p = torch.tensor(pred, device=where, requires_grad=True)
        loss = ctc.ctc_loss(p, torch.tensor(label, device=where))
        loss.sum().backward()
        got.append((loss.detach().cpu().numpy(), p.grad.cpu().numpy()))
    (lc, gc_), (lh, gh) = got
    ok = (np.isfinite(lc).all() and np.isfinite(gc_).all()
          and abs(lc[1] - 1e30) <= 1e24
          and np.allclose(lc, lh, rtol=1e-4, atol=1e-5)
          and np.allclose(gc_, gh, rtol=2e-3, atol=2e-4))
    log(f"    CTC probe on the card: loss {lc.tolist()}, gradient finite "
        f"{bool(np.isfinite(gc_).all())}, max |card - host| gradient "
        f"{float(np.abs(gc_ - gh).max()):.3e}  [{card}]")
    if not ok:
        raise AssertionError("CTC on the card: not finite or not the host's")


def _ctc_timing(dev, card):
    """CTC's loss and gradient at CTC_SHAPE on the card, ms a forward and
    backward by route: the port's op when every sample fits (F.ctc_loss)
    and when one sample cannot (that one through the floored recursion),
    the floored recursion over every sample, and F.ctc_loss alone.  The
    port's op matches F.ctc_loss on the samples that fit (its loss
    bitwise), and the floored
    recursion matches it within the gradient tolerance."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import ctc

    n, t, c, n_lab = CTC_SHAPE
    rng = np.random.RandomState(0)
    pred = torch.tensor(rng.randn(n, t, c).astype(np.float32), device=dev)
    label = torch.tensor(rng.randint(1, c, size=(n, n_lab)), device=dev)
    frames = torch.full((n,), t, dtype=torch.long, device=dev)
    short = frames.clone()
    short[0] = n_lab // 2                   # sample 0 cannot fit
    lens = torch.full((n,), n_lab, dtype=torch.long, device=dev)
    routes = {
        "port, every sample fits": lambda p: ctc.ctc_loss(p, label),
        "port, one sample cannot fit": lambda p: ctc.ctc_loss(p, label,
                                                              short),
        "floored recursion, every sample": lambda p: ctc._floored(
            torch.log_softmax(p, -1), label, frames, lens),
        "F.ctc_loss": lambda p: F.ctc_loss(
            torch.log_softmax(p, -1).transpose(0, 1), label, frames.cpu(),
            lens.cpu(), blank=0, reduction="none"),
    }
    out, ms = {}, {}
    for name, fn in routes.items():
        for rep in range(4):                # the first is a warm-up
            p = pred.detach().requires_grad_()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            loss = fn(p)
            loss.sum().backward()
            torch.cuda.synchronize(dev)
            if rep:
                ms.setdefault(name, []).append(
                    (time.perf_counter() - t0) * 1e3)
        out[name] = (loss.detach().cpu().numpy(), p.grad.cpu().numpy())
        ms[name] = float(np.median(ms[name]))
    lib_l, lib_g = out["F.ctc_loss"]
    fit_l, fit_g = out["port, every sample fits"]
    mix_l, mix_g = out["port, one sample cannot fit"]
    rec_l, rec_g = out["floored recursion, every sample"]
    # F.ctc_loss's backward on the card sums with atomics: equal to a few ulp
    ok = (np.array_equal(fit_l, lib_l)
          and np.allclose(fit_g, lib_g, rtol=1e-5, atol=1e-6)
          and np.isfinite(mix_l).all() and np.isfinite(mix_g).all()
          and abs(mix_l[0] - 1e30) <= 1e24
          and np.allclose(mix_l[1:], lib_l[1:], rtol=1e-4, atol=1e-5)
          and np.allclose(rec_l, lib_l, rtol=1e-4, atol=1e-5)
          and np.allclose(rec_g, lib_g, rtol=2e-3, atol=2e-4))
    log("    CTC at N, T, C, L = " + ", ".join(map(str, CTC_SHAPE))
        + ", ms a loss and gradient (wall, median of 3): "
        + "; ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f"; floored recursion against F.ctc_loss: max |loss| err "
        f"{float(np.abs(rec_l - lib_l).max()):.3e}, max |grad| err "
        f"{float(np.abs(rec_g - lib_g).max()):.3e}  [{card}]")
    if not ok:
        raise AssertionError("CTC at CTC_SHAPE: the routes disagree")
    return ms


def phase_embedding(dev, card, rtc_kernels):
    """[13] The recommender path: row-sparse ShardedEmbedding tables through
    the captured train_step at bench_embedding's configuration (a) and at
    a 2^24-row table (b); (i) captured against eager bitwise; (ii) card
    against host; (iii) the bench lines; (iv) the DLRM feed; (v) CSR; and
    CTC's probe.  Returns the kernel launches of the path (none: it runs
    no kernel of the port's own) and the numbers."""
    import gc

    import torch

    res = {}
    _zero_counts()
    _rtc_zero(rtc_kernels)
    for name, (vocab, batch) in EMB_CONFIGS.items():
        res[name] = _emb_bitwise(dev, card, name, vocab, batch)
        gc.collect()
        torch.cuda.empty_cache()
    res["card_vs_host"] = _emb_card_vs_host(dev, card)
    res["bench"] = _emb_bench(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    res["prefetch"] = _emb_prefetched(
        dev, card, res["bench"]["a"]["lookup_us"])
    res["csr"] = _csr_card_vs_host(dev, card)
    _ctc_on_card(dev, card)
    res["ctc_ms"] = _ctc_timing(dev, card)
    launches = dict(_counts(), **_rtc_counts(rtc_kernels))
    log(f"    [13] kernel launches of the port's own: {launches}")
    if any(launches.values()):
        raise AssertionError("[13] the recommender path launched a flash or "
                             "rtc kernel")
    return launches, res


# -- [14] the decode and serving path, and the encoder-decoder Transformer ---
# bench_serving's configuration (bench.py:281-286) is tools/bench_serving's
# own.  (ii): the mixed prompt lengths of [5](c), 16 new tokens, f32.
SERVE_LENS, SERVE_NEW = (17, 64, 200, 511), 16
# the reference's bf16 decoder tolerance (tests/test_model_zoo.py:453-483):
# the first logits within 0.05 max|f32 logit|
BF16_DECODE_TOL = 0.05
# (iv) speculative decoding: 4 prompts of 64 tokens, 32 new, k=4 proposals;
# the noisy draft's noise, in standard deviations of each weight tensor
# (on an H100 80GB HBM3 at 700 W, 0.01 accepted 0.48 of the proposals,
# with rounds of every m from 0 to 4; 0.02 0.28, 0.05 0.04, 0.1 0.01,
# 0.2 none)
SPEC_BATCH, SPEC_SEED, SPEC_NEW, SPEC_K = 4, 64, 32, 4
SPEC_NOISE = 0.01
# (v) beam_generate: beam 4, alpha 0.6, 8 new tokens from a 32-token prompt
BEAM_SIZE, BEAM_ALPHA, BEAM_NEW, BEAM_SEED = 4, 0.6, 8, 32
# (vi) Transformer-base ("Attention Is All You Need", WMT14 En-De: a shared
# BPE vocabulary of ~37000): B=32, T=128 source and target (TFM_SHAPE),
# bf16, dropout 0.1, label smoothing 0.1, Adam (beta2 0.98, eps 1e-9),
# five steps
TFM_VOCAB, TFM_STEPS, TFM_LR = 37000, 5, 5e-4
TFM_BOS, TFM_EOS = 1, 2
# beam_search (beam 4, alpha 0.6, 32 steps) and greedy_decode on 8 sources
TFM_DECODE_SRC, TFM_BEAM_STEPS, TFM_GREEDY_CHECK = 8, 32, 8
# card against host at transformer_tiny: the weights after 3 steps
TFM_HOST_TOL, TFM_HOST_STEPS = (2e-4, 2e-5), 3


def _launches(rtc_kernels):
    """Every port kernel's launch count since the last zeroing."""
    return dict(_counts(), **_rtc_counts(rtc_kernels))


def _zero_all(rtc_kernels):
    _zero_counts()
    _rtc_zero(rtc_kernels)


def _decode_lossless(spec, ref, ref_lg, T0, what):
    """The reference's speculative rule (tests/test_model_zoo.py:500-511):
    token-exact, or parting only where the reference's top-2 margin is
    inside 1e-3 max|logit|."""
    import numpy as np

    if np.array_equal(spec, ref):
        log(f"      {what}: tokens identical to CachedDecoder.decode")
        return
    j = int(np.argwhere((spec != ref).any(axis=0))[0, 0]) - T0
    top2 = np.sort(ref_lg[j], axis=-1)[:, -2:]
    margin = float((top2[:, 1] - top2[:, 0]).min())
    log(f"      {what}: parts at step {j}, top-2 margin {margin:.3e} (tol "
        f"{1e-3 * np.abs(ref_lg[j]).max():.3e})")
    if margin >= 1e-3 * np.abs(ref_lg[j]).max():
        raise AssertionError(f"{what}: diverged with a decisive margin")


def _serving_bench(dev, card, rtc_kernels):
    """(i) tools.bench_serving.run at bench_serving's configuration on
    GPT-2 small bf16: 36 recorded graphs, no recording or step run outside
    a replay after warm-up, every request its 8 tokens."""
    from mxnet_tpu_torch.tools import bench_serving

    _zero_all(rtc_kernels)
    res = bench_serving.run(dev)
    launches = _launches(rtc_kernels)
    log(f"  (i) {json.dumps(res)}")
    gate = res["batched_ratio"] >= 1.0
    log(f"      batched_ratio {res['batched_ratio']:.3f} against the "
        f"reference's gate (>= 1.0): {'met' if gate else 'NOT met'}; "
        f"retraces_after_warmup {res['retraces_after_warmup']}, recordings "
        f"after warm-up {res['recordings_after_warmup']}, programs "
        f"{res['programs']} (want 4 x 9 = 36), peak memory after warm-up "
        f"{res['peak_mem_after_warmup_gib']:.3f} GiB; kernel launches "
        f"{launches}  [{card}]")
    if not (res["retraces_after_warmup"] == 0 and res["programs"] == 36
            and res["recordings_after_warmup"] == 0):
        raise AssertionError(f"bench_serving: {res}")
    return res, launches


def _first_logits(eng, prompts):
    """The engine's first-token logits of a uniform-length batch from its
    (B, prefill bucket) graph."""
    import numpy as np
    import torch

    B, T = len(prompts), len(prompts[0])
    S = eng._pick_bucket(eng.prefill_buckets, T, "prompt length")
    toks = np.zeros((B, S), np.int64)
    toks[:, :T] = np.asarray(prompts)
    eng._program(B, S)
    zero = torch.zeros(B, dtype=torch.int64, device=eng._device)
    with torch.no_grad():
        return eng._call(B, S, zero, torch.as_tensor(toks),
                         zero + T - 1).clone()


def _graphs_vs_eager(dev, card, rtc_kernels):
    """(ii) Tokens replayed from the engine's graphs against
    CachedDecoder.decode and generate() (f32, GPT-2 small): 4 x 64-token
    prompts, then [5](c)'s mixed lengths one by one; the first logits;
    a reload between two groups.  Returns the model, the (flash-trunk)
    launches of the engine and of the cached decoder, and ms a token."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import convert, serving
    from mxnet_tpu_torch.gluon.model_zoo import gpt

    rng = np.random.default_rng(SEED + 60)
    model = gpt.gpt2_small(scan_layers=True, attention_impl="flash",
                           dropout=0.0)
    state = _numpy_state(model, rng)
    convert.load_state(model, state)
    vocab = model._vocab
    eng = serving.ServingEngine(model, batch_buckets=(4,))
    prompts = rng.integers(0, vocab, (4, 64))
    mixed = [rng.integers(0, vocab, n) for n in SERVE_LENS]
    # every program the groups below run, recorded up front
    for S in (64, 512, 1):
        eng._program(4, S)
    dec = gpt.CachedDecoder(model)
    torch.cuda.synchronize()
    traces, records = serving.trace_count(), serving.compile_count()
    _zero_all(rtc_kernels)
    t0 = time.perf_counter()
    outs, tm = eng.serve_group(list(prompts), SERVE_NEW)
    t_eng = time.perf_counter() - t0
    grouped, tg = eng.serve_group(mixed, SERVE_NEW)
    eng_launches = _launches(rtc_kernels)
    if (serving.trace_count(), serving.compile_count()) != (traces, records):
        raise AssertionError("the engine ran its step outside a replay")
    dec.decode(prompts, 2)                                  # warm-up
    torch.cuda.synchronize()
    _zero_all(rtc_kernels)
    t0 = time.perf_counter()
    ref, lg = dec.decode(prompts, SERVE_NEW, return_logits=True)
    ref = ref.asnumpy()
    t_dec = time.perf_counter() - t0
    solo = [dec.decode(p[None], SERVE_NEW).asnumpy()[0, len(p):]
            for p in mixed]
    dec_launches = _launches(rtc_kernels)
    gen = gpt.generate(model, prompts, SERVE_NEW).asnumpy()[:, 64:]
    log(f"  (ii) GPT-2 small f32: engine (graphs) 4 x 64 + {SERVE_NEW}: "
        f"{t_eng * 1e3:.1f} ms, prefill {tm['prefill_us'] / 1e3:.3f} ms, "
        f"decode {tm['decode_us_per_token'] / 1e3:.3f} ms a token; mixed "
        f"{SERVE_LENS} bucket {tg['bucket']}, decode "
        f"{tg['decode_us_per_token'] / 1e3:.3f} ms a token; "
        f"CachedDecoder.decode (eager) {t_dec / SERVE_NEW * 1e3:.3f} ms a "
        f"token; launches engine {eng_launches}, cached decoder "
        f"{dec_launches}  [{card}]")
    profile_steps(lambda: eng.serve_group(list(prompts), SERVE_NEW), 1,
                  f"(ii) one engine group (4 x 64 + {SERVE_NEW}, graphs)",
                  card, top=8)
    _agree(model, prompts, ref[:, 64:], outs, "(ii) graphs vs CachedDecoder")
    _agree(model, prompts, gen, outs, "(ii) graphs vs generate()")
    _agree(model, mixed, solo, grouped,
           "(ii) mixed group from graphs vs CachedDecoder one by one")
    first = _first_logits(eng, prompts)
    f_abs, f_rel, f_ratio = errors(first, torch.as_tensor(lg[0], device=dev),
                                   2e-4, 1e-5)
    log(f"      first-token logits, graph against CachedDecoder: max abs "
        f"{f_abs:.3e} rel {f_rel:.3e}, err/tol {f_ratio:.3f} (rtol 2e-4 "
        f"atol 1e-5)")
    if f_ratio > 1:
        raise AssertionError("the graph's first logits disagree")
    # a reload between two groups: the next group serves the new weights
    other = gpt.gpt2_small(scan_layers=True, attention_impl="dense",
                           dropout=0.0)
    convert.load_state(other, _numpy_state(other, rng))
    eng.reload_from_model(other)
    after, ta = eng.serve_group(list(prompts), SERVE_NEW)
    want = gpt.CachedDecoder(other).decode(prompts, SERVE_NEW).asnumpy()
    log(f"      reload_from_model: generation {ta['generation']}, no "
        f"recording: {serving.compile_count() == records}")
    if ta["generation"] != 1 or serving.compile_count() != records:
        raise AssertionError("reload_from_model did not swap in place")
    _agree(other, prompts, want[:, 64:], after,
           "(ii) graphs after reload vs the new model's CachedDecoder")
    if any(eng_launches.values()) or any(dec_launches.values()):
        raise AssertionError("the engine or the cached decoder launched a "
                             "kernel of the port's own")
    del eng, other
    torch.cuda.empty_cache()
    return model, eng_launches, dec_launches, t_dec / SERVE_NEW * 1e3


def _decode_bench(model, card, rtc_kernels):
    """(iii) tools.bench_decode.run at GPT-2 small: ms a token, cached
    (f32, bf16) against generate(); bf16 logits against f32."""
    from mxnet_tpu_torch.tools import bench_decode

    res = bench_decode.run(model)
    log(f"  (iii) {json.dumps(res)}")
    log(f"      ms a token: cached f32 {res['kv_cache_ms_per_token']:.3f}, "
        f"bf16 {res['kv_cache_bf16_ms_per_token']:.3f}, generate() "
        f"{res['recompute_ms_per_token']:.3f}; bf16 first logits err / "
        f"max|f32| {res['bf16_first_logits_err_over_scale']:.4f} (tol "
        f"{BF16_DECODE_TOL})  [{card}]")
    if res["bf16_first_logits_err_over_scale"] > BF16_DECODE_TOL:
        raise AssertionError("bf16 decoding left the reference's tolerance")
    return res


def _noisy_draft(model, rng, eps):
    """GPT-2 small holding the target's weights plus seeded noise, eps
    times each tensor's standard deviation: a draft that agrees with the
    target part of the time."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    from mxnet_tpu_torch.serving import state_for_serving

    draft = gpt.gpt2_small(scan_layers=True, dropout=0.0)
    convert.load_state(draft, {
        k: v + eps * v.std() * rng.standard_normal(v.shape, dtype=v.dtype)
        for k, v in state_for_serving(model).items()})
    return draft


def _record_rounds(dec, k):
    """Wrap a target CachedDecoder's block step so that each (k+1)-token
    verify step appends the batch's accepted prefix m (the rows' smallest
    run of proposals its greedy picks agree with) to the returned list."""
    import numpy as np

    step, rounds = dec._step, []

    def wrapped(ck, cv, pos, toks):
        logits = step(ck, cv, pos, toks)
        if toks.shape[1] == k + 1:
            agree = (toks[:, 1:] == logits[:, :k].argmax(dim=-1)) \
                .cpu().numpy()
            rounds.append(int(np.where(agree.all(axis=1), k,
                                       np.argmin(agree, axis=1)).min()))
        return logits

    dec._step = wrapped
    return rounds


def _speculative(model, dev, card, rtc_kernels):
    """(iv) speculative_decode with GPT-2 small as the target, f32: a
    self-draft (every proposal accepted up to the trim), a 2-layer draft
    of the same width and vocabulary (the target's first two layers) and
    a noisy draft (the target's weights plus SPEC_NOISE of noise), all
    lossless; the noisy draft must run at least one round that accepts
    some proposals and not all (0 < m < k)."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    from mxnet_tpu_torch.serving import state_for_serving

    rng = np.random.default_rng(SEED + 61)
    ids = rng.integers(0, model._vocab, (SPEC_BATCH, SPEC_SEED))
    tgt = gpt.CachedDecoder(model)
    # the draft: the target's first two layers under its own embeddings
    # and final LayerNorm
    draft = gpt.gpt2_small(scan_layers=True, num_layers=2, dropout=0.0)
    convert.load_state(draft, {
        k: (v[:2] if "_stack_" in k else v)
        for k, v in state_for_serving(model).items()})
    noisy = _noisy_draft(model, rng, SPEC_NOISE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_t, ref_lg = tgt.decode(ids, SPEC_NEW, return_logits=True)
    ref = ref_t.asnumpy()
    t_ref = time.perf_counter() - t0
    accepted = _record_rounds(tgt, SPEC_K)
    out = {}
    _zero_all(rtc_kernels)
    for name, drf in (("self-draft", tgt), ("2-layer draft", draft),
                      (f"noisy draft ({SPEC_NOISE} std)", noisy)):
        accepted.clear()
        t0 = time.perf_counter()
        spec, st = gpt.speculative_decode(tgt, drf, ids, SPEC_NEW, k=SPEC_K,
                                          return_stats=True)
        spec = spec.asnumpy()
        dt = time.perf_counter() - t0
        rate = st["accepted_draft_tokens"] / (st["rounds"] * SPEC_K)
        log(f"  (iv) speculative_decode, {name}, k={SPEC_K}: {st['rounds']} "
            f"rounds, {st['accepted_draft_tokens']} draft tokens accepted "
            f"(rate {rate:.3f}), accepted a round {accepted}, "
            f"{dt / SPEC_NEW * 1e3:.3f} ms a token against "
            f"CachedDecoder.decode's {t_ref / SPEC_NEW * 1e3:.3f}  [{card}]")
        _decode_lossless(spec, ref, ref_lg, SPEC_SEED, f"(iv) {name}")
        out[name] = dict(st, ms_per_token=dt / SPEC_NEW * 1e3,
                         acceptance_rate=rate, accepted_per_round=
                         list(accepted))
    launches = _launches(rtc_kernels)
    st = out["self-draft"]
    # a round commits its accepted proposals and one token of the
    # target's: all accepted, ceil(N / (k + 1)) rounds; the reference's
    # bound allows one round more (tests/test_model_zoo.py:513-516)
    want = SPEC_NEW - -(-SPEC_NEW // (SPEC_K + 1))
    if st["accepted_draft_tokens"] < want:
        raise AssertionError(f"self-draft accepted {st['accepted_draft_tokens']}"
                             f" of {want} proposals")
    partial = out[f"noisy draft ({SPEC_NOISE} std)"]["accepted_per_round"]
    if not any(0 < m < SPEC_K for m in partial):
        raise AssertionError(f"the noisy draft ran no round of partial "
                             f"acceptance: {partial}")
    if any(launches.values()):
        raise AssertionError(f"speculative decoding launched {launches}")
    out["ref_ms_per_token"] = t_ref / SPEC_NEW * 1e3
    return out, launches


def _beam_card_vs_host(model, dev, card, rtc_kernels):
    """(v) beam_generate on GPT-2 small (flash trunk: each step one window
    forward of the beams), card against host: the same tokens, scores
    within rtol 1e-4."""
    import numpy as np

    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.context import cpu
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    from mxnet_tpu_torch.serving import state_for_serving

    ids = np.random.default_rng(SEED + 62).integers(
        0, model._vocab, (1, BEAM_SEED))
    _zero_all(rtc_kernels)
    t0 = time.perf_counter()
    toks, scores = gpt.beam_generate(model, ids, BEAM_NEW, BEAM_SIZE,
                                     alpha=BEAM_ALPHA)
    toks = toks.asnumpy()
    dt = time.perf_counter() - t0
    launches = _launches(rtc_kernels)
    host = gpt.gpt2_small(scan_layers=True, attention_impl="flash",
                          dropout=0.0, device=cpu())
    convert.load_state(host, state_for_serving(model))
    t0 = time.perf_counter()
    htoks, hscores = gpt.beam_generate(host, ids, BEAM_NEW, BEAM_SIZE,
                                       alpha=BEAM_ALPHA)
    dt_host = time.perf_counter() - t0
    same = bool(np.array_equal(toks, htoks.asnumpy()))
    rel = float(np.abs(scores - hscores).max() / np.abs(hscores).max())
    log(f"  (v) beam_generate beam {BEAM_SIZE}, alpha {BEAM_ALPHA}, "
        f"{BEAM_NEW} new tokens: card {dt * 1e3:.1f} ms, host "
        f"{dt_host:.1f} s; tokens equal {same}, scores card {scores} host "
        f"{hscores} (rel err {rel:.2e}, rtol 1e-4); launches {launches} "
        f"(want {model.encoder._num_layers * BEAM_NEW} flash forwards)  "
        f"[{card}]")
    if not (same and rel <= 1e-4 and launches["flash_attention_fwd"]
            == model.encoder._num_layers * BEAM_NEW):
        raise AssertionError("beam_generate: card and host disagree")
    del host
    return launches


def _tfm_data(rng, B, T, vocab):
    """A source batch, the target's teacher-forced input (BOS then the
    target less its last token) and the target as labels."""
    import numpy as np

    src = rng.integers(3, vocab, (B, T))
    tgt = rng.integers(3, vocab, (B, T))
    tgt_in = np.concatenate([np.full((B, 1), TFM_BOS), tgt[:, :-1]], axis=1)
    return src, tgt_in, tgt


def _tfm_host_steps(dev, rng):
    """(vi) transformer_tiny card against host: three SGD-momentum steps
    of the eager Gluon loop in f32 from the same weights (flash on the
    card, its plain path on the host); the worst err/tol over the
    weights.  SGD, not Adam: the key bias's gradient is zero, and Adam
    would turn each side's rounding noise there into steps of +-lr."""
    import torch

    from mxnet_tpu_torch import autograd, convert, gluon, initializer
    from mxnet_tpu_torch.context import context_of
    from mxnet_tpu_torch.gluon.model_zoo import transformer as tfm
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    data = _tfm_data(rng, 4, 16, 50)
    params, out = None, []
    for d in (torch.device("cpu"), dev):
        net = tfm.transformer_tiny(50, 50, dropout=0.0, max_length=32,
                                   attention_impl="flash", device=d)
        if params is None:
            net.initialize(initializer.Xavier(),
                           generator=torch.Generator().manual_seed(SEED + 63))
            params = {k: p.data().asnumpy()
                      for k, p in net.collect_params().items()}
        else:
            convert.load_transformer_params(net, params)
        src, tgt_in, lab = (NDArray(torch.as_tensor(a, device=d).float(),
                                    context_of(d)) for a in data)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
        loss_fn = tfm.LabelSmoothedCELoss(0.1)
        for _ in range(TFM_HOST_STEPS):
            with autograd.record():
                loss = loss_fn(net(src, tgt_in), lab)
            loss.backward()
            tr.step(4)
        out.append({k.split("_", 1)[1]: p.data()._data.detach().cpu()
                    for k, p in net.collect_params().items()})
    return max(errors(out[1][k], out[0][k], *TFM_HOST_TOL)[2]
               for k in out[0])


def _transformer(dev, card, rtc_kernels):
    """(vi) Transformer-base at full width: flash logits against dense
    (f32), five bf16 steps of the eager Gluon loop (12 launches of each
    flash kernel a step, by the counters and the fenced profiler), then
    beam_search and greedy_decode on the trained weights, greedy's first
    steps held against the dense model's; transformer_tiny card against
    host.  Returns ({path: launches}, the step's numbers)."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import autograd, convert, gluon, initializer
    from mxnet_tpu_torch.context import context_of
    from mxnet_tpu_torch.gluon.model_zoo import transformer as tfm
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    rng = np.random.default_rng(SEED + 64)
    ctx = context_of(dev)
    L = 6
    paths = {}

    def build(impl, dropout=0.1):
        net = tfm.transformer_base(TFM_VOCAB, TFM_VOCAB, dropout=dropout,
                                   attention_impl=impl, device=dev)
        net.initialize(initializer.Xavier(),
                       generator=torch.Generator(device=dev).manual_seed(
                           SEED + 65))
        return net

    # flash against dense logits, f32, B=4, at the same weights
    src, tgt_in, lab = _tfm_data(rng, TFM_BATCH, TFM_SEQ, TFM_VOCAB)
    flash32, dense32 = build("flash", 0.0), build("dense", 0.0)
    s4, t4 = (torch.as_tensor(a[:4], device=dev) for a in (src, tgt_in))
    with autograd.predict_mode(), torch.no_grad():
        lf, ld = flash32(s4, t4), dense32(s4, t4)
    f_abs, f_rel, f_ratio = errors(lf, ld, *TRUNK_TOL)
    log(f"  (vi) Transformer-base f32 logits {tuple(lf.shape)}, flash "
        f"against dense: max abs {f_abs:.3e} rel {f_rel:.3e}, err/tol "
        f"{f_ratio:.3f} (rtol {TRUNK_TOL[0]:.0e} atol {TRUNK_TOL[1]:.0e})")
    if not (f_ratio <= 1 and bool(torch.isfinite(lf).all())):
        raise AssertionError("Transformer-base: flash disagrees with dense")
    del flash32, dense32, lf, ld
    torch.cuda.empty_cache()

    # five bf16 steps of the eager Gluon loop, hybridized
    net = build("flash")
    net.cast("bfloat16")
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": TFM_LR, "beta1": 0.9,
                        "beta2": 0.98, "epsilon": 1e-9,
                        "multi_precision": True})
    loss_fn = tfm.LabelSmoothedCELoss(0.1)
    xs, ys, ls = (NDArray(torch.as_tensor(a, device=dev).float(), ctx)
                  for a in (src, tgt_in, lab))

    def step():
        with autograd.record():
            loss = loss_fn(net(xs, ys), ls)
        loss.backward()
        tr.step(TFM_BATCH)
        return loss

    losses, per_step = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for s in range(TFM_STEPS):
        if s == 1:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        _zero_all(rtc_kernels)
        losses.append(float(step().asnumpy()))
        per_step.append(_launches(rtc_kernels))
    t2 = time.perf_counter()
    ms_warm = (t2 - t1) / (TFM_STEPS - 1) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    profiled = _kernel_counts(step)
    wall, busy = profile_steps(step, 2, "(vi) Transformer-base bf16 step",
                               card, top=10, families=BERT_FAMILIES,
                               ranges=("optimizer_update",))
    tokens = TFM_BATCH * TFM_SEQ
    log(f"  (vi) Transformer-base bf16 flash, B={TFM_BATCH}, T={TFM_SEQ} "
        f"source and target, dropout 0.1, label smoothing 0.1, Adam lr "
        f"{TFM_LR} (beta2 0.98, eps 1e-9), eager Gluon loop, hybridized: "
        f"losses {[round(v, 4) for v in losses]}, "
        f"{(t2 - t0) / TFM_STEPS * 1e3:.2f} ms a step (first included), "
        f"{ms_warm:.2f} ms a step after it, {tokens / ms_warm * 1e3:.0f} "
        f"target tokens/s, peak {peak:.2f} GiB; launches a step "
        f"{per_step[-1]}, by the fenced profiler {profiled}  [{card}]")
    want = {"flash_attention_fwd": 2 * L, "flash_attention_dq": 2 * L,
            "flash_attention_dkv": 2 * L, "rtc_scale2": 0, "rtc_axpy": 0}
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and all(c == want for c in per_step) and profiled == want):
        raise AssertionError(f"Transformer-base training: {losses}, "
                             f"{per_step}, {profiled}")
    paths["transformer_base_train_step"] = per_step[-1]

    # beam_search and greedy_decode on the trained weights (bf16, flash)
    srcs = torch.as_tensor(src[:TFM_DECODE_SRC], device=dev)
    _zero_all(rtc_kernels)
    t0 = time.perf_counter()
    btoks, bscores = tfm.beam_search(net, srcs, TFM_BOS, TFM_EOS, beam_size=4,
                                     max_len=TFM_BEAM_STEPS + 1, alpha=0.6)
    dt_beam = time.perf_counter() - t0
    paths["transformer_beam_search"] = _launches(rtc_kernels)
    _zero_all(rtc_kernels)
    t0 = time.perf_counter()
    gtoks = net.greedy_decode(srcs, TFM_BOS, TFM_EOS,
                              max_len=TFM_BEAM_STEPS + 1)
    dt_greedy = time.perf_counter() - t0
    paths["transformer_greedy_decode"] = _launches(rtc_kernels)
    log(f"      beam_search (beam 4, alpha 0.6, {TFM_BEAM_STEPS} steps, "
        f"{TFM_DECODE_SRC} sources): {dt_beam * 1e3:.1f} ms, tokens "
        f"{btoks.shape}, scores finite {bool(np.isfinite(bscores).all())}, "
        f"launches {paths['transformer_beam_search']}; greedy_decode: "
        f"{dt_greedy * 1e3:.1f} ms, tokens {gtoks.shape}, launches "
        f"{paths['transformer_greedy_decode']}  [{card}]")
    steps_beam = btoks.shape[1] - 1
    if not (np.isfinite(bscores).all() and paths["transformer_beam_search"]
            ["flash_attention_fwd"] == 2 * L * steps_beam
            and paths["transformer_greedy_decode"]["flash_attention_fwd"]
            == 2 * L * (gtoks.shape[1] - 1)):
        raise AssertionError("Transformer decoding: launches or scores")
    # greedy's first steps against the dense model's, both f32 from the
    # trained weights (the decoder's flash runs at T = 1, 2, 3 ...)
    trained = {k: p.data()._data.detach().float().cpu().numpy()
               for k, p in net.collect_params().items()}
    del net, tr, xs, ys, ls
    torch.cuda.empty_cache()
    pair = []
    for impl in ("flash", "dense"):
        m = tfm.transformer_base(TFM_VOCAB, TFM_VOCAB, dropout=0.0,
                                 attention_impl=impl, device=dev)
        convert.load_transformer_params(m, trained)
        pair.append(m)
    g_f = pair[0].greedy_decode(srcs, TFM_BOS, TFM_EOS,
                                max_len=TFM_GREEDY_CHECK + 1)
    g_d = pair[1].greedy_decode(srcs, TFM_BOS, TFM_EOS,
                                max_len=TFM_GREEDY_CHECK + 1)
    same = bool(np.array_equal(g_f, g_d))
    log(f"      greedy_decode f32, flash against dense, first "
        f"{TFM_GREEDY_CHECK} steps: tokens equal {same}")
    if not same:
        # a part is allowed only at a near-tie of the dense model's logits
        j = int(np.argwhere((g_f != g_d).any(axis=0))[0, 0])
        with autograd.predict_mode(), torch.no_grad():
            last = pair[1](srcs, torch.as_tensor(g_d[:, :j], device=dev)
                           .long())[:, -1].float()
        top = last.topk(2, dim=-1).values
        gap = float((top[:, 0] - top[:, 1]).min())
        log(f"      parts at step {j}, smallest top-2 gap {gap:.3e} (tol "
            f"{TIE_GAP:.0e})")
        if gap >= TIE_GAP:
            raise AssertionError("greedy flash decoding parts from dense")
    del pair
    torch.cuda.empty_cache()
    host_ratio = _tfm_host_steps(dev, rng)
    log(f"      transformer_tiny card against host, {TFM_HOST_STEPS} SGD "
        f"steps (f32, flash / plain): weights err/tol {host_ratio:.3f} "
        f"(rtol {TFM_HOST_TOL[0]:.0e} atol {TFM_HOST_TOL[1]:.0e})")
    if host_ratio > 1:
        raise AssertionError("transformer_tiny: card and host disagree")
    return paths, {"ms_per_step": ms_warm, "tokens_per_sec":
                   tokens / ms_warm * 1e3, "peak_gib": peak,
                   "losses": losses, "busy_share": busy / wall}


def phase_serving(dev, card, rtc_kernels):
    """[14] The decode and serving path and the encoder-decoder
    Transformer: (i) bench_serving; (ii) graph-served tokens against the
    eager decoders; (iii) bench_decode; (iv) speculative decoding; (v)
    beam_generate card against host; (vi) Transformer-base.  Returns
    ({path: launches}, the numbers)."""
    import gc

    import torch

    res, paths = {}, {}
    res["serving"], paths["serving_engine_bench"] = _serving_bench(
        dev, card, rtc_kernels)
    gc.collect()
    torch.cuda.empty_cache()
    model, paths["serving_engine"], paths["cached_decoder"], res[
        "cached_ms"] = _graphs_vs_eager(dev, card, rtc_kernels)
    res["decode"] = _decode_bench(model, card, rtc_kernels)
    res["speculative"], paths["speculative_decode"] = _speculative(
        model, dev, card, rtc_kernels)
    paths["gpt_beam_generate"] = _beam_card_vs_host(model, dev, card,
                                                    rtc_kernels)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    tpaths, res["transformer"] = _transformer(dev, card, rtc_kernels)
    paths.update(tpaths)
    return paths, res


# -- [15] the recurrent path ---------------------------------------------------
# (i) the RNN op, card against host: T=9, B=3, I=5, H=7, 2 layers, f32 with
# TF32 off; (mode, bidirectional, projection_size, ragged lengths, clip)
RNN_SMALL = (9, 3, 5, 7, 2)
RNN_CASES = (("lstm", False, None, False, False),
             ("gru", False, None, False, False),
             ("rnn_tanh", False, None, False, False),
             ("rnn_relu", False, None, False, False),
             ("lstm", True, None, False, False),
             ("gru", True, None, True, False),
             ("lstm", False, 4, False, False),
             ("lstm", True, None, True, False),
             ("lstm", False, None, False, True),
             ("lstm", True, 4, True, True))
RNN_OUT_TOL, RNN_GRAD_TOL = (2e-4, 2e-5), (2e-3, 2e-4)
# (ii)/(iii) the medium PTB LM (Zaremba et al. 2014, section 4.1):
# tools/bench_lstm.MEDIUM; (ii) at dropout 0 with each gradient's atol
# scaled by its tensor's max |gradient| (the embedding's rows and the
# decoder's columns span orders of magnitude)
LSTM_WINDOWS, LSTM_PROFILE_STEPS = 30, 3
# (iv) the cuDNN yardstick: (hidden = input width) at T=35, B=20, 2 layers
LSTM_YARDSTICK = (("medium", 650), ("large", 1500))
# (v) the linear-algebra and head checks
SMALL_TOL = (1e-4, 1e-5)


def _rnn_case_inputs(case, rs):
    import numpy as np

    from mxnet_tpu_torch.ops import rnn as trnn

    mode, bi, proj, seq, clip = case
    T, B, I, H, L = RNN_SMALL
    dirs = 2 if bi else 1
    rec = proj or H
    n = trnn.rnn_param_size(mode, I, H, L, bi, proj)
    arrays = [rs.randn(T, B, I), rs.randn(n) * 0.3,
              rs.randn(L * dirs, B, rec) * 0.5]
    if mode == "lstm":
        arrays.append(rs.randn(L * dirs, B, H) * 0.5)
    kw = dict(state_size=H, num_layers=L, mode=mode, bidirectional=bi,
              projection_size=proj, state_outputs=True, _is_training=False)
    if clip:
        kw.update(lstm_state_clip_min=-0.2, lstm_state_clip_max=0.3)
    lens = np.array([T, 4, 1], np.int32) if seq else None
    if seq:
        kw["use_sequence_length"] = True
    shapes = [(T, B, rec * dirs), (L * dirs, B, rec)] + (
        [(L * dirs, B, H)] if mode == "lstm" else [])
    cots = [rs.randn(*s) for s in shapes]
    f32 = (lambda a: a.astype(np.float32))
    return [f32(a) for a in arrays], lens, kw, [f32(c) for c in cots]


def _rnn_op_run(device, arrays, lens, kw, cots):
    import torch

    from mxnet_tpu_torch.ops import rnn as trnn

    args = [torch.as_tensor(a, device=device).requires_grad_()
            for a in arrays]
    if len(args) == 3:
        args.append(None)
    outs = trnn.rnn(*args, sequence_length=None if lens is None else
                    torch.as_tensor(lens, device=device), **kw)
    sum((o * torch.as_tensor(c, device=device)).sum()
        for o, c in zip(outs, cots)).backward()
    return ([o.detach().cpu() for o in outs],
            [a.grad.cpu() for a in args if a is not None])


def _rnn_card_vs_host(dev, card):
    """(i) Every case of RNN_CASES on the card against the host."""
    import numpy as np

    rs = np.random.RandomState(SEED + 15)
    worst = {"out": 0.0, "grad": 0.0}
    for case in RNN_CASES:
        inputs = _rnn_case_inputs(case, rs)
        got, want = _rnn_op_run(dev, *inputs), _rnn_op_run("cpu", *inputs)
        ratios = []
        for (g, w), tol in [(p, RNN_OUT_TOL) for p in zip(got[0], want[0])] \
                + [(p, RNN_GRAD_TOL) for p in zip(got[1], want[1])]:
            ratios.append(errors(g, w, *tol))
        n_out = len(got[0])
        out_err = max(r[0] for r in ratios[:n_out])
        grad_err = max(r[0] for r in ratios[n_out:])
        out_ratio = max(r[2] for r in ratios[:n_out])
        grad_ratio = max(r[2] for r in ratios[n_out:])
        log(f"    (i) {case}: outputs and final states max abs err "
            f"{out_err:.3e} (err/tol {out_ratio:.3f} at rtol/atol "
            f"{RNN_OUT_TOL}); gradients (data, parameters, states) "
            f"{grad_err:.3e} (err/tol {grad_ratio:.3f} at {RNN_GRAD_TOL})")
        if out_ratio > 1 or grad_ratio > 1:
            raise AssertionError(f"[15](i) RNN op {case}: card against "
                                 f"host beyond tolerance")
        if case[3] and got[0][0][4:, 1, :case[2] or RNN_SMALL[3]].any():
            raise AssertionError(f"[15](i) {case}: a step past its "
                                 "length emitted output")
        worst["out"] = max(worst["out"], out_ratio)
        worst["grad"] = max(worst["grad"], grad_ratio)
    return worst


def _lm_loss_and_grads(model, loss_fn, x, y, hidden):
    """The first window's mean loss and every parameter's gradient."""
    from mxnet_tpu_torch import autograd

    with autograd.record():
        out, _ = model(x, hidden)
        ls = loss_fn(out.reshape((-1, out.shape[-1])), y.reshape((-1,)))
    ls.backward()
    return (float(ls.mean().asscalar()),
            {k: p.grad()._data.cpu() for k, p in
             sorted(model.collect_params().items())})


def _lm_card_vs_host(dev, card):
    """(ii) The medium LM at dropout 0, the same numpy weights on the card
    and the host: the first window's loss and every gradient."""
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.tools import bench_lstm as bl

    m = dict(bl.MEDIUM, dropout=0.0)
    rs = np.random.RandomState(SEED + 16)
    runs, weights = {}, None
    for where in (dev, "cpu"):
        ctx = mx.context.context_of(mx.context.resolve(where))
        model = bl.RNNModel(m["vocab"], m["embed"], m["hidden"],
                            m["layers"], 0.0)
        model.initialize(ctx=ctx)
        if weights is None:
            weights = {k: rs.uniform(-0.1, 0.1, p.shape).astype(np.float32)
                       for k, p in model.collect_params().items()}
        convert.load_gluon_params(model, weights)
        x, y = bl.windows(m["vocab"], m["bptt"], m["batch"], 1, where,
                          SEED)[0]
        hidden = model.begin_state(batch_size=m["batch"], ctx=ctx)
        runs[str(where)] = _lm_loss_and_grads(
            model, mx.gluon.loss.SoftmaxCrossEntropyLoss(), x, y, hidden)
    (lc, gc), (lh, gh) = runs[str(dev)], runs["cpu"]
    loss_rel = abs(lc - lh) / abs(lh)
    worst, worst_name = 0.0, None
    for (kc, c), (kh, h) in zip(gc.items(), gh.items()):
        atol = RNN_GRAD_TOL[1] * float(h.abs().max())
        ratio = errors(c, h, RNN_GRAD_TOL[0], atol)[2] if atol else \
            float((c - h).abs().max())
        if ratio > worst:
            worst, worst_name = ratio, kc
    log(f"    (ii) medium LM (vocab {m['vocab']}, {m['embed']}/"
        f"{m['hidden']}, {m['layers']} layers, T={m['bptt']}, "
        f"B={m['batch']}, dropout 0): first loss card {lc:.6f}, host "
        f"{lh:.6f} (rel {loss_rel:.2e}, tol 1e-5); {len(gc)} gradients, "
        f"worst err/tol {worst:.3f} ({worst_name}) at rtol "
        f"{RNN_GRAD_TOL[0]}, atol {RNN_GRAD_TOL[1]} x max|grad|")
    if loss_rel > LOSS_RTOL or worst > 1:
        raise AssertionError("[15](ii) the medium LM's card run parts from "
                             "the host's")
    return {"loss_rel": loss_rel, "grad_err_over_tol": worst}


def _lm_training(dev, card, rtc_kernels):
    """(iii) LSTM_WINDOWS windows of the medium LM at dropout 0.5 on the
    card, the hidden state carried and detached: the loss falls; ms a
    step and tokens/s; torch.profiler over LSTM_PROFILE_STEPS more; the
    kernels of the port's own counted (none)."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.tools import bench_lstm as bl

    m = bl.MEDIUM
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model, trainer, loss_fn = bl.build(m["vocab"], m["embed"], m["hidden"],
                                       m["layers"], m["dropout"], dev, SEED)
    data = bl.windows(m["vocab"], m["bptt"], m["batch"],
                      LSTM_WINDOWS + LSTM_PROFILE_STEPS + 2, dev, SEED)
    state = [model.begin_state(batch_size=m["batch"],
                               ctx=mx.context.context_of(dev))]
    losses, times = [], []

    def step(i):
        ls, state[0] = bl.train_window(model, trainer, loss_fn, state[0],
                                       *data[i])
        return float(ls.mean().asscalar())

    _zero_all(rtc_kernels)
    for i in range(LSTM_WINDOWS):
        t0 = time.perf_counter()
        losses.append(step(i))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = _launches(rtc_kernels)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    ms = sorted(times[2:])
    med = ms[len(ms) // 2]
    tokens = m["bptt"] * m["batch"]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"    (iii) {LSTM_WINDOWS} windows at dropout {m['dropout']}: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (first five {first:.4f}, "
        f"last five {last:.4f}); ms a step median {med:.3f} "
        f"(min {ms[0]:.3f}, max {ms[-1]:.3f}, windows 3-{LSTM_WINDOWS}), "
        f"{tokens / med * 1e3:.1f} tokens/s; peak {peak:.3f} GiB over "
        f"{base / 2 ** 30:.3f} GiB  [{card}]")
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"[15](iii) the loss did not fall: {losses}")
    i = [LSTM_WINDOWS]

    def next_step():
        step(i[0])
        i[0] += 1

    wall, busy = profile_steps(next_step, LSTM_PROFILE_STEPS,
                               f"{LSTM_PROFILE_STEPS} medium LM steps "
                               f"(dropout {m['dropout']})", card,
                               families=BERT_FAMILIES,
                               ranges=("optimizer_update",))
    traced = _kernel_counts(next_step)
    log(f"    (iii) flash and rtc launches: {launches} by the wrappers over "
        f"the {LSTM_WINDOWS} windows, {traced} in a fenced trace of one "
        f"step")
    if any(launches.values()) or any(traced.values()):
        raise AssertionError("[15](iii) the LSTM LM launched a flash or rtc "
                             "kernel")
    return launches, {"ms_per_step": med, "ms_min": ms[0],
                      "ms_max": ms[-1], "tokens_per_sec": tokens / med * 1e3,
                      "loss_first": losses[0], "loss_last": losses[-1],
                      "peak_mem_gib": peak, "busy_share": busy / wall,
                      "profile_wall_ms": wall, "profile_busy_ms": busy}


def _lstm_yardstick(dev, card):
    """(iv) cuDNN's LSTM (torch.nn.LSTM, never on the port's path) against
    the port's RNN op, forward and backward, at T=35, B=20, 2 layers, f32:
    CUDA events, the median of 5 loops."""
    import torch

    from mxnet_tpu_torch.ops import rnn as trnn
    from mxnet_tpu_torch.tools.bench_lstm import MEDIUM

    T, B, L = MEDIUM["bptt"], MEDIUM["batch"], MEDIUM["layers"]
    rows = {}
    g = torch.Generator(device=dev).manual_seed(SEED)
    for name, H in LSTM_YARDSTICK:
        lstm = torch.nn.LSTM(H, H, L).to(dev)
        x = torch.randn(T, B, H, device=dev, generator=g,
                        requires_grad=True)
        n = trnn.rnn_param_size("lstm", H, H, L)
        params = (torch.randn(n, device=dev, generator=g) * 0.04) \
            .requires_grad_()
        h0 = torch.zeros(L, B, H, device=dev)
        dy = torch.randn(T, B, H, device=dev, generator=g)

        def port():
            out = trnn.rnn(x, params, h0, h0, state_size=H, num_layers=L,
                           mode="lstm", _is_training=True)
            out.backward(dy)

        def cudnn():
            out, _ = lstm(x, (h0, h0))
            out.backward(dy)

        t_port = cuda_ms_spread(port, 3)
        t_lib = cuda_ms_spread(cudnn, 3)
        # 2 * (T*B) * (4H) * (in + H) a layer forward, x3 with backward
        gflop = 3 * 2 * T * B * 4 * H * 2 * H * L / 1e9
        log(f"    (iv) {name} (H={H}): port RNN op forward+backward "
            f"{t_port[0]:.3f} ms (min {t_port[1]:.3f}, max {t_port[2]:.3f}), "
            f"cuDNN LSTM {t_lib[0]:.3f} ms (min {t_lib[1]:.3f}, max "
            f"{t_lib[2]:.3f}), ratio {t_port[0] / t_lib[0]:.2f}; "
            f"{gflop:.2f} GFLOP  [{card}]")
        rows[name] = {"port_ms": t_port, "cudnn_ms": t_lib, "gflop": gflop}
        del lstm, x, params
    return rows


def _small_families(dev, card):
    """(v) CustomOp, while_loop, cond, linalg and a legacy head on the card
    against the host."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd

    class Op(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            a, b = in_data
            self.assign(out_data[0], req[0], a * 3 + b * b)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            g = out_grad[0]
            self.assign(in_grad[0], req[0], g * 3)
            self.assign(in_grad[1], req[1], g * 2 * in_data[1])

    @mx.operator.register("chip_smoke_scale3")
    class Prop(mx.operator.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def create_operator(self, ctx, shapes, dtypes):
            return Op()

    rs = np.random.RandomState(SEED + 17)
    a, b, g = (rs.randn(4, 5).astype(np.float32) for _ in range(3))
    spd = rs.randn(6, 6)
    spd = (spd @ spd.T + 6 * np.eye(6)).astype(np.float32)
    tri = np.tril(rs.randn(6, 6) + 4 * np.eye(6)).astype(np.float32)
    rhs = rs.randn(6, 3).astype(np.float32)
    pred, lab = rs.randn(8, 2).astype(np.float32), rs.randn(8, 2).astype(
        np.float32)

    def run(ctx):
        out = {}
        with ctx:
            xa, xb = nd.array(a), nd.array(b)
            xa.attach_grad()
            xb.attach_grad()
            with autograd.record():
                y = nd.Custom(xa, xb, op_type="chip_smoke_scale3")
            y.backward(nd.array(g))
            out["custom"] = [y, xa.grad, xb.grad]
            bufs, final = nd.contrib.while_loop(
                lambda i, s: i < 3, lambda i, s: ([s * i], [i + 1, s + i]),
                [nd.array([0.0]), nd.array(b[0])], max_iterations=5)
            out["while_loop"] = bufs + final
            out["cond"] = [nd.contrib.cond(nd.array([1.0]),
                                           lambda: nd.array(a) * 2,
                                           lambda: nd.array(a) - 1)]
            out["potrf"] = [nd.linalg.potrf(nd.array(spd))]
            out["trsm"] = [nd.linalg.trsm(nd.array(tri), nd.array(rhs))]
            u, w = nd.linalg.syevd(nd.array(spd))
            # eigenvectors up to sign: each row's largest entry positive
            un = u.asnumpy()
            sign = np.sign(un[np.arange(6), np.abs(un).argmax(1)])
            out["syevd"] = [w, un * sign[:, None]]
            xp = nd.array(pred)
            xp.attach_grad()
            with autograd.record():
                z = nd.LinearRegressionOutput(xp, nd.array(lab),
                                              grad_scale=2.0)
            z.backward()
            out["LinearRegressionOutput"] = [z, xp.grad]
        return {k: [torch.as_tensor(v.asnumpy() if hasattr(v, "asnumpy")
                                    else v) for v in vs]
                for k, vs in out.items()}

    got, want = run(mx.gpu(0)), run(mx.cpu())
    worst = 0.0
    for k in want:
        ratio = max(errors(gv, wv, *SMALL_TOL)[2]
                    for gv, wv in zip(got[k], want[k]))
        log(f"    (v) {k}: card against host err/tol {ratio:.3f} at "
            f"rtol/atol {SMALL_TOL}")
        if ratio > 1:
            raise AssertionError(f"[15](v) {k}: card against host beyond "
                                 "tolerance")
        worst = max(worst, ratio)
    return worst


def phase_recurrent(dev, card, rtc_kernels):
    """[15] The recurrent path: (i) the RNN op card against host in every
    mode; (ii) the medium PTB LM card against host; (iii) 30 windows of
    its training on the card, the profile and tools.bench_lstm.run;
    (iv) the cuDNN yardstick; (v) the small families.  Returns the kernel
    launches of the path (none of the port's own) and the numbers."""
    import gc

    import torch

    from mxnet_tpu_torch.tools import bench_lstm

    res = {}
    t0 = time.perf_counter()
    res["op"] = _rnn_card_vs_host(dev, card)
    res["card_vs_host"] = _lm_card_vs_host(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches, res["train"] = _lm_training(dev, card, rtc_kernels)
    gc.collect()
    torch.cuda.empty_cache()
    res["bench"] = bench_lstm.run(device=dev)
    log("    (iii) bench_lstm " + json.dumps(res["bench"]))
    res["yardstick"] = _lstm_yardstick(dev, card)
    res["small"] = _small_families(dev, card)
    log(f"    [15] done in {time.perf_counter() - t0:.1f} s; kernel "
        f"launches of the port's own: {launches}")
    return launches, res


# -- [16] the detection path ----------------------------------------------------
# (i) each detection op card against host on the same seeded inputs: keep-sets,
# matches and integer targets equal, floats within DET_TOL; the deformable
# convolution's 2304-term sums within DET_TOL with atol scaled by max |out|
DET_TOL = (1e-4, 1e-5)
ROI_MAP = (2, 512, 38, 50)         # Faster R-CNN's conv5 map of a 600x800 image
ROI_COUNT, ROI_POOL = 256, (7, 7)
PROPOSAL = dict(rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300)
DEFORM_SHAPE = (8, 256, 38, 38)
NMS_SHAPE = (4, 6000)
# (ii) SSD at bench_ssd.VOC300: card against host at B=2 on the same weights;
# each gradient's atol scaled by its tensor's max |gradient|
SSD_CHECK_BATCH = 2
SSD_LOSS_RTOL = 1e-4
SSD_GRAD_TOL = (2e-3, 2e-4)
SSD_STEPS = 20
# (iii) the zoo at published widths: one training step timed at B=32 (after
# ZOO_WARMUP), logits card against host at B=2 in predict mode
ZOO = (("alexnet", 224), ("vgg16_bn", 224), ("densenet121", 224),
       ("squeezenet1.1", 224), ("mobilenet1.0", 224),
       ("mobilenetv2_1.0", 224), ("inceptionv3", 299))
ZOO_BATCH, ZOO_WARMUP, ZOO_STEPS = 32, 2, 5
ZOO_TOL = (2e-4, 2e-5)
# (iv) the detection input path
DET_REC_IMAGES = 96
# the SSD step's kernels by family (first match wins): cuDNN's BatchNorm
# kernels before the convolutions, whose names they share
DET_FAMILIES = (("bn_", "BatchNorm (cuDNN)"), ("batch_norm", "BatchNorm"),
                ("multi_tensor", "foreach (update)"),
                ("sort", "sort (targets)"), ("radix", "sort (targets)"),
                ("scatter", "gather / scatter / index"),
                ("gather", "gather / scatter / index"),
                ("index", "gather / scatter / index"),
                ("softmax", "softmax")) + RESNET_FAMILIES


def _det_compare(what, got, want, exact=(), tol=DET_TOL, scale_atol=False,
                 tag="(i)"):
    """Card outputs against host outputs: the columns or outputs named by
    ``exact`` equal, the rest within ``tol``.  Returns the worst
    err / tolerance."""
    import torch

    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().cpu()
        w = w.detach().cpu()
        if g.shape != w.shape:
            raise AssertionError(f"[16]{tag} {what}: shape "
                                 f"{tuple(g.shape)} against {tuple(w.shape)}")
        if i in exact:
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"[16]{tag} {what}: output {i} "
                                     f"differs in {bad} of {g.numel()} "
                                     "entries")
            continue
        atol = tol[1] * max(1.0, float(w.abs().max())) if scale_atol \
            else tol[1]
        worst = max(worst, errors(g, w, tol[0], atol)[2])
    log(f"    {tag} {what}: card against host, integer outputs equal, worst "
        f"err/tol {worst:.3f} at rtol/atol {tol}"
        + (" (atol x max|out|)" if scale_atol else ""))
    if worst > 1:
        raise AssertionError(f"[16]{tag} {what}: beyond tolerance")
    return worst


def _det_ops(dev, card):
    """(i) every detection op of the SSD and Faster R-CNN paths on the
    card against the host."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import contrib_det as det
    from mxnet_tpu_torch.ops import vision_extra as vx
    from mxnet_tpu_torch.tools import bench_ssd as bs

    cfg = bs.VOC300
    rs = np.random.RandomState(SEED + 16)
    res = {}

    def both(fn, arrays, **kw):
        host = fn(*[torch.as_tensor(a) for a in arrays], **kw)
        t0 = time.perf_counter()
        card_out = fn(*[torch.as_tensor(a).to(dev) for a in arrays], **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return ([o for o in card_out] if isinstance(card_out, tuple)
                else [card_out]), ([o for o in host] if isinstance(
                    host, tuple) else [host]), ms

    # anchors of the SSD-300-width head: the model zoo's six maps
    maps = [cfg["image"] // 2 ** (i + 1) for i in range(6)]
    anchors = torch.cat([det.multibox_prior(
        torch.zeros(1, 1, m, m), sizes=s, ratios=r)
        for m, s, r in zip(maps, cfg["scale_sizes"], cfg["scale_ratios"])],
        dim=1)
    N = anchors.shape[1]
    B = cfg["batch"]
    _, lab = bs.synthetic_batch(rs, B, 32, cfg["num_classes"],
                                cfg["max_objects"])
    logits = rs.standard_normal((B, cfg["num_classes"] + 1, N)) \
        .astype(np.float32)
    prob = torch.softmax(torch.from_numpy(logits), 1).numpy()
    got, want, ms = both(det.multibox_target, [anchors.numpy(), lab, prob],
                         negative_mining_ratio=3)
    res["MultiBoxTarget"] = _det_compare(
        f"MultiBoxTarget ({B} x {N} anchors x {cfg['max_objects']} gts, "
        f"3:1 mining; {ms:.1f} ms on the card, first call)", got, want,
        exact=(1, 2))
    matched = int((want[2] > 0).sum())
    mined = int((want[2] == 0).sum())
    log(f"      {matched} anchors matched, {mined} negatives mined")

    loc = (rs.standard_normal((B, N * 4)) * 0.5).astype(np.float32)
    got, want, ms = both(det.multibox_detection, [prob, loc,
                                                  anchors.numpy()],
                         nms_topk=400, nms_threshold=0.45, threshold=0.01)
    got = [g[..., :1] for g in got] + [g[..., 1:] for g in got]
    want = [w[..., :1] for w in want] + [w[..., 1:] for w in want]
    res["MultiBoxDetection"] = _det_compare(
        f"MultiBoxDetection (nms_topk 400; {ms:.1f} ms on the card, first "
        f"call)", got, want, exact=(0,))
    log(f"      {int((want[0] >= 0).sum())} rows kept of {B} x 400")

    nb, nn_ = NMS_SHAPE
    data = np.concatenate([
        rs.randint(0, 3, (nb, nn_, 1)), rs.uniform(-0.5, 1, (nb, nn_, 1)),
        rs.uniform(0, 0.8, (nb, nn_, 2))], axis=-1)
    data = np.concatenate([data, data[..., 2:4] + rs.uniform(
        0.02, 0.2, (nb, nn_, 2))], axis=-1).astype(np.float32)
    for kw in (dict(), dict(topk=400), dict(id_index=0, force_suppress=True,
                                           topk=1000),
               dict(id_index=0, background_id=0)):
        got, want, ms = both(det.box_nms, [data], overlap_thresh=0.5, **kw)
        keep_c, keep_h = got[0][..., 1] >= 0, want[0][..., 1] >= 0
        got = [keep_c, got[0]]
        want = [keep_h, want[0]]
        res[f"box_nms {kw}"] = _det_compare(
            f"box_nms {NMS_SHAPE} {kw} ({ms:.1f} ms, {int(keep_h.sum())} "
            "kept)", got, want, exact=(0,))

    data_map = rs.standard_normal(ROI_MAP).astype(np.float32)
    H, W = ROI_MAP[2] * 16, ROI_MAP[3] * 16
    x1 = rs.uniform(0, W - 64, ROI_COUNT)
    y1 = rs.uniform(0, H - 64, ROI_COUNT)
    rois = np.stack([rs.randint(0, ROI_MAP[0], ROI_COUNT), x1, y1,
                     np.minimum(x1 + rs.uniform(32, 400, ROI_COUNT), W - 1),
                     np.minimum(y1 + rs.uniform(32, 400, ROI_COUNT), H - 1)],
                    1).astype(np.float32)
    for name, fn in (("ROIAlign", det.roi_align),
                     ("ROIPooling", det.roi_pooling)):
        got, want, ms = both(fn, [data_map, rois], pooled_size=ROI_POOL,
                             spatial_scale=1 / 16)
        # ROIPooling's maxima are exact; ROIAlign's sample positions carry
        # f32 rounding of pixel coordinates up to 50 (~3e-6 pixel) times
        # the map's slope: atol scaled by max |out|
        res[name] = _det_compare(
            f"{name} ({ROI_COUNT} ROIs {ROI_POOL} on {ROI_MAP}; "
            f"{ms:.1f} ms)", got, want,
            exact=(0,) if name == "ROIPooling" else (),
            scale_atol=name == "ROIAlign")

    A = 12
    cls_prob = rs.uniform(0, 1, (2, 2 * A, ROI_MAP[2], ROI_MAP[3])) \
        .astype(np.float32)
    bbox = (rs.standard_normal((2, 4 * A, ROI_MAP[2], ROI_MAP[3])) * 0.1) \
        .astype(np.float32)
    info = np.array([[H, W, 1.0]] * 2, np.float32)
    got, want, ms = both(vx.proposal, [cls_prob, bbox, info],
                         output_score=True, **PROPOSAL)
    res["Proposal"] = _det_compare(
        f"Proposal ({PROPOSAL['rpn_pre_nms_top_n']} -> "
        f"{PROPOSAL['rpn_post_nms_top_n']} of {A * ROI_MAP[2] * ROI_MAP[3]} "
        f"anchors an image; {ms:.1f} ms)", got, want)

    Bd, Cd, Hd, Wd = DEFORM_SHAPE
    xd = rs.standard_normal(DEFORM_SHAPE).astype(np.float32)
    off = (rs.standard_normal((Bd, 18, Hd, Wd)) * 1.5).astype(np.float32)
    wd = (rs.standard_normal((Cd, Cd, 3, 3)) / 48).astype(np.float32)
    got, want, ms = both(vx.deformable_convolution, [xd, off, wd],
                         kernel=(3, 3), pad=(1, 1), num_filter=Cd)
    res["DeformableConvolution"] = _det_compare(
        f"DeformableConvolution ({DEFORM_SHAPE}, 3x3, {Cd} filters; "
        f"{ms:.1f} ms)", got, want, scale_atol=True)
    return res


def _ssd_card_vs_host(dev, card):
    """(ii) one SSDTrainLoss pass of the SSD-300-width detector at B=2 on
    the card and on the host, same weights and data: the loss and every
    gradient."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import autograd, cpu, gpu, nd
    from mxnet_tpu_torch.tools import bench_ssd as bs

    cfg = dict(bs.VOC300, batch=SSD_CHECK_BATCH)
    x, y = bs.synthetic_batch(np.random.RandomState(SEED + 160),
                              SSD_CHECK_BATCH, cfg["image"],
                              cfg["num_classes"], cfg["max_objects"])
    out = {}
    weights = None
    for name, ctx, device in (("card", gpu(0), dev),
                              ("host", cpu(), torch.device("cpu"))):
        with ctx:
            net, _, loss_fn = bs.build(cfg, device, SEED)
            net(nd.array(x[:1]))                   # deferred shapes
            if weights is None:
                weights = {k: p.data().asnumpy()
                           for k, p in net.collect_params().items()}
            else:
                for (k, p), v in zip(net.collect_params().items(),
                                     weights.values()):
                    p.set_data(nd.array(v))
            with autograd.record():
                loss = loss_fn(net(nd.array(x)), nd.array(y))
            loss.backward()
            out[name] = (float(loss.asscalar()), [
                torch.from_numpy(p.grad().asnumpy())
                for p in net.collect_params().values()
                if p.grad_req != "null"])
        del net
    lc, gc = out["card"]
    lh, gh = out["host"]
    rel = abs(lc - lh) / abs(lh)
    worst = max(errors(a, b, SSD_GRAD_TOL[0], SSD_GRAD_TOL[1] * max(
        float(b.abs().max()), 1e-30))[2] for a, b in zip(gc, gh))
    log(f"    (ii) SSD-300 width at B={SSD_CHECK_BATCH}, card against host: "
        f"loss {lc:.6f} against {lh:.6f} (relative {rel:.2e}, tolerance "
        f"{SSD_LOSS_RTOL}); {len(gc)} gradients, worst err/tol "
        f"{worst:.3f} at rtol/atol {SSD_GRAD_TOL} (atol x max|grad|)")
    if rel > SSD_LOSS_RTOL or worst > 1:
        raise AssertionError("[16](ii) SSD card against host beyond "
                             "tolerance")
    return {"loss_rel": rel, "grad_err_over_tol": worst}


def _ssd_detect(dev, card, rtc_kernels):
    """(ii) ssd_detect on a B=32 batch on the card: its ms and launches;
    its decode (MultiBoxDetection, nms_topk 400) equal to the host's on the
    card's scores."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon.model_zoo import ssd_detect
    from mxnet_tpu_torch.ops import contrib_det as det
    from mxnet_tpu_torch.tools import bench_ssd as bs

    cfg = bs.VOC300
    net, _, _ = bs.build(cfg, dev, SEED)
    x, _ = bs.synthetic_batch(np.random.RandomState(SEED + 161),
                              cfg["batch"], cfg["image"],
                              cfg["num_classes"])
    xb = nd.array(x)
    with torch.no_grad():
        det_card = ssd_detect(net, xb).asnumpy()
        _zero_all(rtc_kernels)
        t = cuda_ms_spread(lambda: ssd_detect(net, xb), 1, loops=5)
        launches = _launches(rtc_kernels)
        cls, loc, anc = (o._data for o in net(xb))
        prob = torch.softmax(cls, dim=1)
        kw = dict(nms_threshold=0.45, threshold=0.01, nms_topk=400)
        on_card = det.multibox_detection(prob, loc, anc, **kw)
        on_host = det.multibox_detection(prob.cpu(), loc.cpu(), anc.cpu(),
                                         **kw)
    if not np.array_equal(det_card, on_card.cpu().numpy()):
        raise AssertionError("[16](ii) ssd_detect is not its forward, "
                             "softmax and MultiBoxDetection")
    worst = _det_compare("ssd_detect's decode (nms_topk 400) on the card's "
                         "scores", [on_card[..., :1], on_card[..., 1:]],
                         [on_host[..., :1], on_host[..., 1:]], exact=(0,),
                         tag="(ii)")
    kept = int((det_card[..., 0] >= 0).sum())
    log(f"    (ii) ssd_detect at B={cfg['batch']}: {t[0]:.3f} ms (min "
        f"{t[1]:.3f}, max {t[2]:.3f}; CUDA events, 5 calls), {kept} rows "
        f"kept; flash/rtc launches {launches}  [{card}]")
    if any(launches.values()):
        raise AssertionError("[16](ii) ssd_detect launched a flash or rtc "
                             "kernel")
    return launches, {"ms": t, "rows_kept": kept, "err_over_tol": worst}


def _zoo(dev, card, rtc_kernels):
    """(iii) each vision family at its published width: the logits card
    against host at B=2 in predict mode, ZOO_STEPS timed training steps at
    B=32 (SGD), and pretrained=True from a file the phase wrote."""
    import tempfile

    import numpy as np
    import torch

    from mxnet_tpu_torch import autograd, cpu, gluon, initializer
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.context import context_of
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    rows = {}
    launches = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    for name, side in ZOO:
        rs = np.random.RandomState(SEED + 162)
        ctx = context_of(dev)
        x = NDArray(torch.from_numpy(rs.uniform(
            -1, 1, (ZOO_BATCH, 3, side, side)).astype(np.float32)).to(dev),
            ctx)
        y = NDArray(torch.from_numpy(rs.randint(0, 1000, ZOO_BATCH)
                                     .astype(np.float32)).to(dev), ctx)
        x2 = x._data[:2]
        net = vision.get_model(name)
        net.initialize(init=initializer.Xavier(), ctx=ctx,
                       generator=torch.Generator(device=dev).manual_seed(
                           SEED))
        with torch.no_grad():
            net(x2)
        with cpu():
            host = vision.get_model(name)
            host.initialize()
            with torch.no_grad():
                host(x2[:1].cpu())
        for p, q in zip(net.collect_params().values(),
                        host.collect_params().values()):
            q.set_data(torch.from_numpy(p.data().asnumpy()))
        with torch.no_grad():
            want = host(x2.cpu())
            got = net(x2).cpu()
        err = errors(got, want, ZOO_TOL[0],
                     ZOO_TOL[1] * max(1.0, float(want.abs().max())))[2]
        if err > 1:
            raise AssertionError(f"[16](iii) {name}: logits card against "
                                 "host beyond tolerance")
        del host
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.01, "momentum": 0.9})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

        def step():
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(ZOO_BATCH)
            return float(loss.mean().asscalar())

        for _ in range(ZOO_WARMUP):
            step()
        _zero_all(rtc_kernels)
        times, losses = [], []
        for _ in range(ZOO_STEPS):
            t0 = time.perf_counter()
            losses.append(step())
            times.append((time.perf_counter() - t0) * 1e3)
        launches[name] = _launches(rtc_kernels)
        times.sort()
        if not np.isfinite(losses).all():
            raise AssertionError(f"[16](iii) {name}: loss not finite")
        # pretrained=True: the file written here, the same outputs
        fname = name
        net.save_parameters(os.path.join(root, fname + ".params"))
        loaded = vision.get_model(name, pretrained=True, root=root, ctx=ctx)
        with torch.no_grad():
            same = torch.equal(loaded(x2), net(x2))
        if not same:
            raise AssertionError(f"[16](iii) {name}: pretrained=True gave "
                                 "other outputs")
        os.remove(os.path.join(root, fname + ".params"))
        try:
            vision.get_model(name, pretrained=True, root=root)
        except MXNetError:
            pass
        else:
            raise AssertionError(f"[16](iii) {name}: a missing file did "
                                 "not raise")
        med = times[len(times) // 2]
        rows[name] = {"ms_per_step": med, "ms_min": times[0],
                      "ms_max": times[-1], "images_per_sec":
                      ZOO_BATCH / med * 1e3, "logits_err_over_tol": err,
                      "input": side}
        log(f"    (iii) {name} at {side}x{side}: logits card against host "
            f"err/tol {err:.3f} at {ZOO_TOL} (atol x max|logit|); step at "
            f"B={ZOO_BATCH} {med:.2f} ms (min {times[0]:.2f}, max "
            f"{times[-1]:.2f}), {ZOO_BATCH / med * 1e3:.1f} images/s; "
            f"pretrained=True from {fname}.params: same outputs, a "
            f"missing file raises  [{card}]")
        del net, loaded, trainer
        torch.cuda.empty_cache()
    os.rmdir(root)
    for name, counts in launches.items():
        if any(counts.values()):
            raise AssertionError(f"[16](iii) {name} launched a flash or "
                                 "rtc kernel")
    return {k: sum(v[k] for v in launches.values())
            for k in next(iter(launches.values()))}, rows


def _write_det_rec(path, n, side, rs, classes):
    """A detection .rec of ``n`` JPEGs: 1-4 bright boxes on a dark field,
    labels [2, 5, (cls, xmin, ymin, xmax, ymax)...]."""
    import numpy as np

    from mxnet_tpu_torch import recordio

    rec = recordio.MXRecordIO(path, "w")
    for i in range(n):
        img = rs.randint(0, 40, (side, side + 40, 3)).astype(np.uint8)
        objs = []
        for _ in range(1 + i % 4):
            w, h = rs.uniform(0.15, 0.4, 2)
            x0, y0 = rs.uniform(0, 1 - w), rs.uniform(0, 1 - h)
            img[int(y0 * side):int((y0 + h) * side),
                int(x0 * (side + 40)):int((x0 + w) * (side + 40))] = 220
            objs += [rs.randint(classes), x0, y0, x0 + w, y0 + h]
        rec.write(recordio.pack_img(recordio.IRHeader(
            0, np.array([2, 5] + objs, np.float32), i, 0), img, quality=92))
    rec.close()


def _det_input(dev, card, rtc_kernels):
    """(iv) a detection .rec read through ImageDetIter with
    CreateDetAugmenter(rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
    mean=True, std=True) at 300x300: boxes in [0, 1] and over the bright
    pixels they label (they followed the crops, pads and flips); three SSD
    steps fed from it."""
    import tempfile

    import numpy as np

    from mxnet_tpu_torch import image
    from mxnet_tpu_torch.tools import bench_ssd as bs

    cfg = bs.VOC300
    rs = np.random.RandomState(SEED + 163)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_det_")
    path = os.path.join(tmp, "det.rec")
    _write_det_rec(path, DET_REC_IMAGES, 320, rs, cfg["num_classes"])
    np.random.seed(SEED + 164)
    it = image.ImageDetIter(
        batch_size=cfg["batch"], data_shape=(3, 300, 300), path_imgrec=path,
        shuffle=True, aug_list=image.CreateDetAugmenter(
            (3, 300, 300), rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
            mean=True, std=True))
    net, trainer, loss_fn = bs.build(cfg, dev, SEED)
    t0 = time.perf_counter()
    losses, boxes, inside = [], 0, []
    for batch in it:
        data, label = batch.data[0], batch.label[0]
        if data._data.device.type != dev.type:
            raise AssertionError("[16](iv) ImageDetIter's batch is not on "
                                 "the card")
        lab = label.asnumpy()
        img = data.asnumpy()
        real = lab[lab[:, :, 0] >= 0]
        if not ((real[:, 1:] >= 0) & (real[:, 1:] <= 1)).all():
            raise AssertionError("[16](iv) a box left [0, 1]")
        for b in range(lab.shape[0]):
            for row in lab[b][lab[b, :, 0] >= 0]:
                x0, y0, x1, y1 = (int(round(v * 300)) for v in row[1:])
                if x1 - x0 >= 4 and y1 - y0 >= 4:
                    patch = img[b, :, y0 + 1:y1 - 1, x0 + 1:x1 - 1]
                    inside.append(float(patch.mean() > img[b].mean()))
        boxes += len(real)
        losses.append(float(bs.train_step(net, trainer, loss_fn, data,
                                           label).asscalar()))
    secs = time.perf_counter() - t0
    os.remove(path)
    os.rmdir(tmp)
    share = float(np.mean(inside))
    log(f"    (iv) ImageDetIter over {DET_REC_IMAGES} JPEGs at 300x300: "
        f"{len(losses)} batches of {cfg['batch']} fed SSD steps, losses "
        f"{[round(v, 4) for v in losses]}; {boxes} boxes, all in [0, 1], "
        f"{share:.3f} of them brighter inside than their image; "
        f"{secs:.1f} s in all")
    if len(losses) != 3 or not np.isfinite(losses).all() or share < 0.95:
        raise AssertionError("[16](iv) the detection input path failed")
    return {"losses": losses, "boxes": boxes, "inside_share": share}


def _estimator(dev, card):
    """(v) Estimator.fit for two epochs on the card over a DataLoader
    (behind its DevicePrefetcher): the accuracy moves."""
    import numpy as np

    from mxnet_tpu_torch import gluon, initializer
    from mxnet_tpu_torch.context import context_of
    from mxnet_tpu_torch.gluon.contrib import Estimator

    rs = np.random.RandomState(SEED + 165)
    X = rs.standard_normal((2048, 32)).astype(np.float32)
    Y = (X[:, :4].sum(1) > 0).astype(np.float32)
    loader = gluon.data.DataLoader(gluon.data.ArrayDataset(X, Y),
                                   batch_size=128)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(64, activation="relu"), gluon.nn.Dense(2))
    net.initialize(init=initializer.Xavier(), ctx=context_of(dev))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    est = Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                    metrics=["acc"], trainer=trainer)
    accs = []
    est.fit(loader, epochs=2,
            epoch_end_callback=lambda e, ms, t: accs.append(ms[0].get()[1]))
    final = est.evaluate(loader)[0][1]
    log(f"    (v) Estimator.fit, 2 epochs of 16 batches on the card: "
        f"training accuracy {accs}, evaluate {final:.4f}")
    if len(accs) != 2 or not final > 0.8 or not accs[1] > accs[0]:
        raise AssertionError("[16](v) the Estimator's metric did not move")
    return {"epoch_acc": accs, "eval_acc": final}


def phase_detection(dev, card, rtc_kernels):
    """[16] The detection path: (i) the detection ops card against host;
    (ii) SSD at the width of SSD-300 on VOC card against host, 20 steps
    through bench_ssd.run, ssd_detect; (iii) the vision zoo; (iv) the
    detection input path; (v) Estimator.  Returns the kernel launches of
    the SSD path and of the zoo (none of the port's own) and the
    numbers."""
    import gc

    import torch

    from mxnet_tpu_torch.tools import bench_ssd

    res = {}
    t0 = time.perf_counter()
    res["ops"] = _det_ops(dev, card)
    res["card_vs_host"] = _ssd_card_vs_host(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    _zero_all(rtc_kernels)
    res["bench"] = bench_ssd.run(steps=SSD_STEPS,
                                 batch=bench_ssd.VOC300["batch"],
                                 image=bench_ssd.VOC300["image"], device=dev)
    ssd_launches = _launches(rtc_kernels)
    b = res["bench"]
    log(f"    (ii) {SSD_STEPS} gluon.Trainer steps at bench_ssd.VOC300 "
        f"(B={b['batch']}, {b['anchors']} anchors): loss "
        f"{b['loss_first']:.4f} -> {b['loss_last']:.4f}; ms a step median "
        f"{b['ms_per_step']:.2f} (min {b['ms_min']:.2f}, max "
        f"{b['ms_max']:.2f}), {b['images_per_sec']:.1f} images/s, peak "
        f"{b['peak_mem_gib']:.2f} GiB; busy {b['busy_share']:.3f}, "
        f"{b['kernel_ms_per_step']:.2f} ms of kernels and "
        f"{b['kernels_per_step']:.0f} kernels a step (fenced trace); "
        f"flash/rtc launches {ssd_launches}  [{card}]")
    log("    (ii) bench_ssd " + json.dumps(b))
    import numpy as np

    head, tail = np.mean(b["losses"][:5]), np.mean(b["losses"][-5:])
    log(f"    (ii) mean loss of the first five steps {head:.4f}, of the "
        f"last five {tail:.4f}")
    if not (np.isfinite(b["losses"]).all() and tail < head):
        raise AssertionError("[16](ii) the SSD loss did not fall")
    if any(ssd_launches.values()):
        raise AssertionError("[16](ii) the SSD step launched a flash or rtc "
                             "kernel")
    cfg = bench_ssd.VOC300
    net, trainer, loss_fn = bench_ssd.build(cfg, dev, SEED)
    data = bench_ssd.batches(cfg, 2, dev, SEED)
    i = [0]

    def step():
        bench_ssd.train_step(net, trainer, loss_fn, *data[i[0] % 2])
        i[0] += 1

    for _ in range(2):
        step()
    wall, busy = profile_steps(step, 3, f"(ii) 3 SSD-300-width steps at "
                               f"B={cfg['batch']}", card,
                               families=DET_FAMILIES)
    res["profile"] = {"wall_ms": wall, "kernel_ms": busy}
    del net, trainer, data
    gc.collect()
    torch.cuda.empty_cache()
    detect_launches, res["detect"] = _ssd_detect(dev, card, rtc_kernels)
    gc.collect()
    torch.cuda.empty_cache()
    zoo_launches, res["zoo"] = _zoo(dev, card, rtc_kernels)
    gc.collect()
    torch.cuda.empty_cache()
    res["input"] = _det_input(dev, card, rtc_kernels)
    res["estimator"] = _estimator(dev, card)
    ssd_path = {k: ssd_launches[k] + detect_launches[k]
                for k in ssd_launches}
    log(f"    [16] done in {time.perf_counter() - t0:.1f} s; kernel "
        f"launches of the port's own: SSD path {ssd_path}, zoo "
        f"{zoo_launches}")
    return ssd_path, zoo_launches, res


PLANES_STEPS, PLANES_EVERY, PLANES_SIGTERM = 40, 10, 25
PLANES_BATCHES = 48            # the loader's epoch: 48 batches of B=32
PLANES_SEED = SEED + 170
CKPT_REPS = 5                  # saves a median of ckpt_stall_us is over
OVERHEAD_STEPS = 20            # captured steps a side of the overhead pair
ATTEST_ROUNDS = 3
RECORD_REPS = 2000             # host-only step records timed for their cost
MFU_AGREE = 0.05               # step-record MFU against bench_bert's


def _planes_build(dev):
    """bench_bert's Gluon BERT-base (B=32, T=512, bf16, AdamW on f32
    masters, dropout 0.1, the flash kernels) and a seeded resumable
    DataLoader over PLANES_BATCHES batches of its synthetic corpus."""
    import numpy as np

    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.tools import bench_bert

    net, tr, loss_fn, _tok, _lab = bench_bert.build_gluon(
        BERT_BATCH, BERT_SEQ, "flash", "bfloat16", dev, seed=SEED,
        dropout=0.1)
    rs = np.random.RandomState(PLANES_SEED)
    n, top = PLANES_BATCHES * BERT_BATCH, min(30000, net._vocab)
    tokens = rs.randint(0, top, (n, BERT_SEQ)).astype(np.int64)
    mlm = np.full((n, BERT_SEQ), -1, np.int64)
    mask = rs.rand(n, BERT_SEQ) < 0.15
    mlm[mask] = rs.randint(0, top, int(mask.sum()))
    nsp = rs.randint(0, 2, (n,)).astype(np.int64)
    loader = DataLoader(ArrayDataset(tokens, mlm, nsp),
                        batch_size=BERT_BATCH, shuffle=True,
                        seed=PLANES_SEED, last_batch="discard")
    return net, tr, loss_fn, loader


class _Feed:
    """The loader's batches, one a step, from an iterator made anew after
    every rewind."""

    def __init__(self, loader):
        self.loader = loader
        self.it = None

    def next(self):
        if self.it is None:
            self.it = iter(self.loader)
        try:
            return next(self.it)
        except StopIteration:
            self.it = iter(self.loader)
            return next(self.it)

    def load(self, sd):
        self.loader.load_state_dict(sd)
        self.it = None


def _planes_step_fn(net, tr, loss_fn, feed, losses):
    """``run_resilient``'s step: the dropout draws are a function of the
    step (``mx.random.seed(S + step)``), so a replayed step is bitwise the
    first."""
    from mxnet_tpu_torch import random as mxrandom

    def step_fn(step):
        mxrandom.seed(PLANES_SEED + step)
        tok, mlm, nsp = feed.next()
        loss = tr.train_step(net, loss_fn, tok, (mlm, nsp))
        value = loss._data.detach().float().cpu().numpy().copy()
        losses.append((step, value))
        return float(value)

    return step_fn


def _resilient_bert(dev, ckdir, spec):
    """PLANES_STEPS steps of BERT-base under run_resilient with an
    AsyncCheckpointer every PLANES_EVERY steps and the loader's state in
    every manifest, with ``spec`` as MXTPU_FAULT_INJECT (None: no fault).
    Returns the report, every (step, loss) in the order run, the final
    trainer leaves (device clones), the loader's position after each
    resume, ms a step, and the trainer (for a profiled step)."""
    import torch

    from mxnet_tpu_torch import checkpoint, integrity, resilience

    net, tr, loss_fn, loader = _planes_build(dev)
    feed = _Feed(loader)
    losses, resumed_at = [], []

    def set_data(sd):
        feed.load(sd)
        resumed_at.append(int(sd["cursor"]))

    ck = checkpoint.AsyncCheckpointer(ckdir, max_to_keep=2, rank=0,
                                      world_size=1)
    if spec is None:
        os.environ.pop("MXTPU_FAULT_INJECT", None)
    else:
        os.environ["MXTPU_FAULT_INJECT"] = spec
    resilience.reset_faults()
    t0 = time.perf_counter()
    try:
        report = resilience.run_resilient(
            _planes_step_fn(net, tr, loss_fn, feed, losses), ck,
            PLANES_STEPS, get_state=lambda: checkpoint.trainer_state(
                tr, copy=False),
            set_state=lambda s: checkpoint.load_trainer_state(tr, s),
            checkpoint_every=PLANES_EVERY, get_data_state=loader.state_dict,
            set_data_state=set_data, max_restarts=1)
    finally:
        os.environ.pop("MXTPU_FAULT_INJECT", None)
        resilience.reset_faults()
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / len(losses)
    leaves = [t.detach().clone() for t in integrity.trainer_leaves(tr)]
    return dict(report=report, losses=losses, leaves=leaves,
                resumed_at=resumed_at, ms=ms, trainer=(net, tr, loss_fn),
                feed=feed, saved=sorted(ck.all_steps()))


def _planes_fingerprint(dev, card, tr):
    """(i) The card's fingerprint of the trainer state against the host
    mirror, a flipped bit, and one attest pass's ms."""
    from mxnet_tpu_torch import integrity, resilience

    leaves = integrity.trainer_leaves(tr)
    words = sum(t.numel() * max(t.element_size(), 4) // 4 for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    fp = integrity.combine(integrity.fingerprint_arrays(leaves))
    t0 = time.perf_counter()
    host = integrity.fingerprint_host([t.cpu() for t in leaves])
    host_s = time.perf_counter() - t0
    if fp != host:
        raise AssertionError(f"[17](i) card fingerprint {fp:016x} != host "
                             f"mirror {host:016x}")
    ms = cuda_ms(lambda: integrity.fingerprint_arrays(leaves), 5, warmup=1)
    os.environ["MXTPU_FAULT_INJECT"] = "bit_flip_param:0"
    resilience.reset_faults()
    try:
        if not integrity.maybe_bit_flip_param(params=tr._params):
            raise AssertionError("[17](i) bit_flip_param did not fire")
    finally:
        os.environ.pop("MXTPU_FAULT_INJECT", None)
        resilience.reset_faults()
    flipped = integrity.combine(integrity.fingerprint_arrays(leaves))
    integrity._flip_bit(tr._params[0].data()._data)     # flip it back
    if flipped == fp or integrity.combine(
            integrity.fingerprint_arrays(leaves)) != fp:
        raise AssertionError("[17](i) one flipped bit did not change the "
                             "fingerprint, or flipping it back did not "
                             "restore it")
    dtypes = sorted({str(t.dtype).replace("torch.", "") for t in leaves})
    log(f"    (i) BERT-base trainer state: {len(leaves)} leaves "
        f"({', '.join(dtypes)}), {words} words, {nbytes / 2 ** 30:.3f} "
        f"GiB; card fingerprint {fp:016x} == host mirror (numpy, "
        f"{host_s:.1f} s); one flipped bit -> {flipped:016x}; one attest "
        f"pass {ms:.3f} ms  [{card}]")
    return {"fp": f"{fp:016x}", "attest_pass_ms": ms, "leaves": len(leaves),
            "words": words, "bytes": nbytes}


def _planes_resilient(dev, card, root, rtc_kernels):
    """(ii) The resilient run against an uninterrupted one."""
    import gc

    import torch

    clean = _resilient_bert(dev, os.path.join(root, "clean"), None)
    want = dict(clean["losses"])
    leaves_a, ms_a = clean["leaves"], clean["ms"]
    del clean
    gc.collect()
    torch.cuda.empty_cache()
    _zero_all(rtc_kernels)
    run = _resilient_bert(dev, os.path.join(root, "preempted"),
                          f"sigterm_at_step:{PLANES_SIGTERM}")
    rep = run["report"]
    counts = _launches(rtc_kernels)
    if not all(v for k, v in counts.items() if k.startswith("flash")):
        raise AssertionError(f"[17](ii) a flash kernel was not launched "
                             f"on the resilient path: {counts}")
    if not (rep.preempted and rep.restarts == 1
            and rep.final_step == PLANES_STEPS
            and len(rep.resumed_from) == 2):
        raise AssertionError(f"[17](ii) report {rep!r}")
    back = rep.resumed_from[-1]
    periodic = PLANES_SIGTERM - PLANES_SIGTERM % PLANES_EVERY
    # the step-20 save still in flight at the SIGTERM: the grace window
    # completes it and the run resumes there; a save already committed:
    # PreemptionHandler saves step 25 (without the loader's position, as
    # the reference's does: in process the loader is already there)
    if back not in (periodic, PLANES_SIGTERM):
        raise AssertionError(f"[17](ii) resumed from {back}")
    want_at = [back * BERT_BATCH] if back == periodic else []
    if run["resumed_at"] != want_at:
        raise AssertionError(f"[17](ii) the loader resumed at "
                             f"{run['resumed_at']} samples, not step "
                             f"{back}'s batch ({want_at})")
    replayed = PLANES_SIGTERM - back
    import numpy as np

    if len(run["losses"]) != PLANES_STEPS + replayed:
        raise AssertionError(f"[17](ii) {len(run['losses'])} steps run")
    for s, v in run["losses"]:
        if not np.array_equal(v, want[s]):
            raise AssertionError(f"[17](ii) step {s}'s loss {v} != the "
                                 f"uninterrupted run's {want[s]}")
    for a, b in zip(run["leaves"], leaves_a):
        if not torch.equal(a, b):
            raise AssertionError("[17](ii) the resumed run's final state "
                                 "is not bitwise the uninterrupted run's")
    net, tr, loss_fn = run["trainer"]
    feed = run["feed"]

    def one_step():
        tok, mlm, nsp = feed.next()
        tr.train_step(net, loss_fn, tok, (mlm, nsp))

    per_step = _kernel_counts(one_step)
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv"):
        if per_step[name] != 12:
            raise AssertionError(f"[17](ii) a step ran {name} "
                                 f"{per_step[name]} times, not 12")
    log(f"    (ii) {PLANES_STEPS} steps under run_resilient, a save every "
        f"{PLANES_EVERY}, MXTPU_FAULT_INJECT=sigterm_at_step:"
        f"{PLANES_SIGTERM}: {rep!r}; the loader resumed at step {back}'s "
        f"batch ({back * BERT_BATCH} samples); {replayed} replayed "
        f"steps, every loss and the final weights, masters and Adam "
        f"states bitwise the uninterrupted run's; kernels a step "
        f"(fenced trace) {per_step}; ms a step (saves and the restart "
        f"included) {run['ms']:.2f} preempted, {ms_a:.2f} uninterrupted  "
        f"[{card}]")
    out = {"report": repr(rep), "resumed_from": back,
           "replayed_steps": replayed, "ms_per_step": run["ms"],
           "ms_per_step_uninterrupted": ms_a, "kernels_per_step": per_step,
           "launches": counts}
    return out, run


def _planes_checkpoints(dev, card, tr, root):
    """(iii) ckpt_stall_us async against sync, async_commit_ms and the
    bytes on disk for BERT-base's state; then the crash sites in
    subprocesses."""
    import shutil
    import statistics

    import torch

    from mxnet_tpu_torch import checkpoint

    def stalls(async_save):
        d = os.path.join(root, "async" if async_save else "sync")
        ck = checkpoint.AsyncCheckpointer(d, max_to_keep=2, rank=0,
                                          world_size=1,
                                          async_save=async_save)
        ck.save(0, checkpoint.trainer_state(tr, copy=False))  # warm
        ck.wait()
        host, dev_us, commit = [], [], []
        for r in range(1, CKPT_REPS + 1):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            ck.save(r, checkpoint.trainer_state(tr, copy=False))
            t1 = time.perf_counter()
            torch.cuda.current_stream(dev).synchronize()
            t2 = time.perf_counter()
            ck.wait()
            commit.append((time.perf_counter() - t2) * 1e3)
            host.append((t1 - t0) * 1e6)
            dev_us.append((t2 - t0) * 1e6)
        sdir = ck._step_dir(CKPT_REPS)
        size = sum(os.path.getsize(os.path.join(sdir, f))
                   for f in os.listdir(sdir))
        shutil.rmtree(d, ignore_errors=True)
        return (statistics.median(dev_us), statistics.median(host),
                statistics.mean(commit), size)

    a_us, a_host, a_commit, size = stalls(True)
    s_us, s_host, _c, _s = stalls(False)
    log(f"    (iii) ckpt_stall_us (median of {CKPT_REPS} saves of "
        f"BERT-base's state, until the train stream may go on): async "
        f"{a_us:.1f} (host {a_host:.1f}), sync {s_us:.1f}; "
        f"async_commit_ms {a_commit:.1f}; {size} bytes on disk a "
        f"checkpoint  [{card}]")
    crashes = _planes_crashes(root)
    return {"ckpt_stall_us": a_us, "ckpt_stall_us_host": a_host,
            "sync_stall_us": s_us, "async_commit_ms": a_commit,
            "bytes_on_disk": size, "crashes": crashes}


CRASH_CHILD = r"""
import os, sys
import numpy as np
sys.path.insert(0, os.getcwd())
from mxnet_tpu_torch import checkpoint, resilience
d, site = sys.argv[1], sys.argv[2]
ck = checkpoint.AsyncCheckpointer(d, max_to_keep=5, rank=0, world_size=1)
for step in (1, 2):
    if step == 2:
        os.environ["MXTPU_FAULT_INJECT"] = site
        resilience.reset_faults()
    ck.save(step, {"w": np.full(1 << 20, step, np.float32), "step": step})
    ck.wait()
"""


def _planes_crashes(root):
    """crash_during_save and crash_before_manifest kill a child in the
    middle of its second save; a corrupt_shard rots the second save's
    shard after its commit.  Each time the first checkpoint restores."""
    from mxnet_tpu_torch import checkpoint, resilience

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MXTPU_")}
    sites = ("crash_during_save", "crash_before_manifest", "corrupt_shard:0")
    procs = {site: subprocess.Popen(
        [sys.executable, "-c", CRASH_CHILD,
         os.path.join(root, "crash_" + site.split(":")[0]), site],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for site in sites}
    out = {}
    for site, proc in procs.items():
        _o, err = proc.communicate(timeout=300)
        want = 0 if site.startswith("corrupt") \
            else resilience.CRASH_EXIT_CODE
        if proc.returncode != want:
            raise AssertionError(f"[17](iii) {site}: the child exited "
                                 f"{proc.returncode}: {err[-2000:]}")
        got = {}
        step = resilience.resume_latest(checkpoint.AsyncCheckpointer(
            os.path.join(root, "crash_" + site.split(":")[0]), rank=0,
            world_size=1), got.update)
        if step != 1 or got["step"] != 1 or float(got["w"][0]) != 1.0:
            raise AssertionError(f"[17](iii) after {site} the restore "
                                 f"gave step {step}")
        out[site] = step
    log(f"    (iii) crash_during_save and crash_before_manifest (children "
        f"killed in their second save, exit {resilience.CRASH_EXIT_CODE}) "
        f"and a corrupt_shard: each restores the first checkpoint, step "
        f"{out}")
    return out


def _planes_integrity(dev, card, tr, net, loss_fn, feed, root):
    """(iv) The attestation's cost on non-due steps, each attest round's
    us, a bit_flip_grad caught by the next attestation, the step records
    and the exporter."""
    import statistics
    import urllib.request

    import numpy as np
    import torch

    from mxnet_tpu_torch import (checkpoint, distributed, integrity,
                                 resilience, telemetry)
    from mxnet_tpu_torch.obs.exporter import MetricsExporter
    from mxnet_tpu_torch.tools import bench_bert

    batch = feed.next()

    def steps(n):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            tr.train_step(net, loss_fn, batch[0], (batch[1], batch[2]))
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3 / n

    plane = integrity.IntegrityPlane(every=10 ** 9)
    pair = []
    for attached in (False, True, True, False):      # in turns
        tr._integrity_plane = plane if attached else None
        pair.append((attached, steps(OVERHEAD_STEPS)))
    off = statistics.mean(ms for a, ms in pair if not a)
    on = statistics.mean(ms for a, ms in pair if a)
    overhead = (on - off) / off * 100
    every = integrity.IntegrityPlane(every=1)
    tr._integrity_plane = every
    attest_ms = steps(ATTEST_ROUNDS)
    if every.attestations != ATTEST_ROUNDS:
        raise AssertionError(f"[17](iv) {every.attestations} attestations "
                             f"in {ATTEST_ROUNDS} due steps")
    round_us = (attest_ms - off) * 1e3
    log(f"    (iv) {OVERHEAD_STEPS} captured steps a side, in turns: plane "
        f"detached {off:.3f} ms, attached with no attestation due "
        f"{on:.3f} ms: integrity_overhead_pct {overhead:.3f}; a due step "
        f"{attest_ms:.3f} ms, so one attest round (fingerprint pass, its "
        f"readback, the vote) {round_us:.1f} us  [{card}]")

    # a bit_flip_grad is caught by the next attestation: replicas 1 and
    # 2 vote the fingerprint of a clean replay of the same two steps
    from mxnet_tpu_torch import random as mxrandom

    kv = distributed.FileKV(os.path.join(root, "gang"))
    base = checkpoint.trainer_state(tr)
    n0 = tr._step_count
    b2, b3 = feed.next(), feed.next()

    def two_steps(flip, plane=None):
        checkpoint.load_trainer_state(tr, base)
        tr._step_count = n0
        tr._integrity_plane = None
        os.environ["MXTPU_FAULT_INJECT" if flip else
                   "MXTPU_CAPTURED_STEP"] = "bit_flip_grad:0" if flip \
            else "0"
        resilience.reset_faults()
        try:
            mxrandom.seed(PLANES_SEED + 1000)
            tr.train_step(net, loss_fn, b2[0], (b2[1], b2[2]))  # eager
        finally:
            os.environ.pop("MXTPU_FAULT_INJECT", None)
            os.environ.pop("MXTPU_CAPTURED_STEP", None)
            resilience.reset_faults()
        tr._integrity_plane = plane
        mxrandom.seed(PLANES_SEED + 1001)
        tr.train_step(net, loss_fn, b3[0], (b3[1], b3[2]))      # captured

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        two_steps(False)
        clean_fp = integrity.combine(integrity.fingerprint_arrays(
            integrity.trainer_leaves(tr)))
        for r in (1, 2):
            integrity.IntegrityPlane(rank=r, world=3, kv=kv).publish(
                n0 + 2, clean_fp)
        voter = integrity.IntegrityPlane(rank=0, world=3, kv=kv, every=1,
                                         timeout=30.0)
        two_steps(True, voter)
    finally:
        torch.use_deterministic_algorithms(prev)
        tr._integrity_plane = None
    v = voter.last_verdict
    if v is None or v["ok"] or v["corrupt"] != [0] or v["step"] != n0 + 2:
        raise AssertionError(f"[17](iv) the attestation after a "
                             f"bit_flip_grad gave {v}")
    log(f"    (iv) bit_flip_grad on rank 0 in an eager step, then one "
        f"captured step: its attestation (step {v['step']}) votes "
        f"{v['votes']} -> corrupt {v['corrupt']}")

    # step records
    telemetry.reset()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    n = OVERHEAD_STEPS
    for _ in range(n):
        tr.train_step(net, loss_fn, batch[0], (batch[1], batch[2]))
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    recs = telemetry.recent_steps()[-n:]
    for rec in recs:
        telemetry.validate_record(json.loads(json.dumps(rec)))
        if rec["path"] != "captured" or not rec["flops"] or \
                rec["mfu"] is None or not 0 < rec["mfu"] <= 1 or \
                not rec.get("device_peak_bytes"):
            raise AssertionError(f"[17](iv) step record {rec}")
    bench_flops = bench_bert.flops_per_step(BERT_BATCH, BERT_SEQ)
    bench_mfu = bench_bert.mfu(bench_flops * n, dt,
                               torch.cuda.get_device_name(dev))
    rec_mfu = sum(r["flops"] for r in recs) / dt \
        / telemetry.peak_flops()
    if bench_mfu is not None and abs(rec_mfu / bench_mfu - 1) > MFU_AGREE:
        raise AssertionError(f"[17](iv) the records' MFU {rec_mfu:.4f} "
                             f"against bench_bert's {bench_mfu:.4f}")
    t0 = time.perf_counter()
    for i in range(RECORD_REPS):
        acc = telemetry.step_begin("captured")
        telemetry.note(flops=1e12, grad_norm=1.0, device_peak_bytes=1)
        telemetry.step_end(acc, step=i)
    record_us = (time.perf_counter() - t0) * 1e6 / RECORD_REPS
    telemetry.gauge_set("obs.step_record_us", record_us)
    exp = MetricsExporter(port=0)
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{exp.port}/metrics", timeout=30).read()
    finally:
        exp.close()
    if b"mxtpu_obs_step_record_us " not in body:
        raise AssertionError("[17](iv) /metrics answered without metrics")
    mean_mfu = float(np.mean([r["mfu"] for r in recs]))
    log(f"    (iv) {n} step records: validate_record passes, path "
        f"captured, flops {recs[0]['flops']:.4e} a step (bench_bert's "
        f"formula {bench_flops:.4e}), mean record MFU {mean_mfu:.4f}, "
        f"records' FLOPs over the timed span {rec_mfu:.4f} against "
        f"bench_bert's MFU {bench_mfu if bench_mfu is None else round(bench_mfu, 4)}, "
        f"device_peak_bytes {recs[0]['device_peak_bytes']}; a record costs "
        f"{record_us:.2f} us of host time; /metrics answered "
        f"{len(body)} bytes on port {exp.port}  [{card}]")
    return {"integrity_overhead_pct": overhead, "ms_detached": off,
            "ms_attached": on, "attest_round_us": round_us,
            "step_record_us": record_us, "record_mfu": rec_mfu,
            "bench_mfu": bench_mfu, "flops": recs[0]["flops"],
            "bench_flops": bench_flops,
            "device_peak_bytes": recs[0]["device_peak_bytes"]}


def _planes_numerics(dev, card, tr, net, loss_fn, feed, root):
    """(v) nan_grad skips its step with the weights untouched; a streak of
    max_bad_steps bad steps rolls back to the checkpoint and rewinds the
    loader."""
    import torch

    from mxnet_tpu_torch import checkpoint, integrity, numerics, resilience

    batch = feed.next()
    before = [t.detach().clone() for t in integrity.trainer_leaves(tr)]
    n_skip = len(tr.skipped_steps)
    os.environ["MXTPU_FAULT_INJECT"] = "nan_grad:1"
    resilience.reset_faults()
    try:
        tr.train_step(net, loss_fn, batch[0], (batch[1], batch[2]))
    finally:
        os.environ.pop("MXTPU_FAULT_INJECT", None)
        resilience.reset_faults()
    after = integrity.trainer_leaves(tr)
    if len(tr.skipped_steps) != n_skip + 1 or not all(
            torch.equal(a, b) for a, b in zip(before, after)):
        raise AssertionError("[17](v) the nan_grad step was not skipped "
                             "with the state bitwise untouched")
    del before
    ck = checkpoint.AsyncCheckpointer(os.path.join(root, "rollback"),
                                      rank=0, world_size=1)
    loader = feed.loader
    ck.save(tr._step_count, checkpoint.trainer_state(tr, copy=False),
            data_state=loader.state_dict())
    ck.wait()
    saved_fp = integrity.combine(integrity.fingerprint_arrays(
        integrity.trainer_leaves(tr)))
    saved_cursor = loader.state_dict()["cursor"]
    mon = numerics.DivergenceMonitor(
        checkpointer=ck, max_bad_steps=2,
        set_state=lambda s: checkpoint.load_trainer_state(tr, s))
    tr.divergence_monitor = mon
    tr.attach_data_pipeline(loader)
    try:
        for _ in range(2):
            b = feed.next()
            os.environ["MXTPU_FAULT_INJECT"] = "nan_grad:1"
            resilience.reset_faults()
            tr.train_step(net, loss_fn, b[0], (b[1], b[2]))
    finally:
        os.environ.pop("MXTPU_FAULT_INJECT", None)
        resilience.reset_faults()
        tr.divergence_monitor = None
        tr._data_pipeline = None
    feed.it = None
    got_fp = integrity.combine(integrity.fingerprint_arrays(
        integrity.trainer_leaves(tr)))
    cursor = loader.state_dict()["cursor"]
    if mon.recoveries != 1 or got_fp != saved_fp or \
            cursor != saved_cursor or len(mon.quarantined) != 2:
        raise AssertionError(f"[17](v) rollback: recoveries "
                             f"{mon.recoveries}, fingerprint "
                             f"{got_fp:016x} against {saved_fp:016x}, "
                             f"cursor {cursor} against {saved_cursor}, "
                             f"quarantined {mon.quarantined}")
    log(f"    (v) nan_grad: the step skipped, weights, masters and states "
        f"bitwise untouched; two bad steps in a row (max_bad_steps=2): "
        f"rolled back to the checkpoint (fingerprint {got_fp:016x}), the "
        f"loader rewound to sample {cursor}, batches {mon.quarantined} "
        f"quarantined")
    return {"rollback_fp": f"{got_fp:016x}", "cursor": cursor,
            "quarantined": [list(b) for b in mon.quarantined]}


def _planes_replica(dev, card, root, rtc_kernels):
    """(vi) ReplicaServer over GPT-2 small in bf16 at bench_serving's
    buckets: a checkpoint with the right expect_fp swaps in and serves a
    fresh engine's tokens; a mismatch is refused; the front door routes
    around a closed replica."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import checkpoint, initializer, integrity, serving
    from mxnet_tpu_torch.gluon.model_zoo import gpt
    from mxnet_tpu_torch.tools import bench_serving

    _zero_all(rtc_kernels)
    net, engine = bench_serving.build(dev)
    new = gpt.gpt2_small(scan_layers=True, dropout=0.0, device=dev)
    new.initialize(initializer.Xavier(),
                   generator=torch.Generator(device=dev).manual_seed(1))
    state = serving.state_for_serving(new)
    ckdir = os.path.join(root, "serving")
    ck = checkpoint.AsyncCheckpointer(ckdir, max_to_keep=3, rank=0,
                                      world_size=1)
    attested = {1: integrity.fingerprint_host(state), 2: 0}
    rep = serving.ReplicaServer(engine, ckpt_dir=ckdir, poll_ms=10 ** 6,
                                max_delay_ms=2.0, expect_fp=attested.get)
    closed = serving.ReplicaServer(engine, rank=1)
    closed.close()
    door = serving.FrontDoor([closed, rep])
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, net._vocab, rng.randint(4, 17)).tolist()
               for _ in range(8)]

    def serve(target):
        futs = [target.submit(p, bench_serving.NEW_TOKENS) for p in prompts]
        return [f.result(timeout=240)["tokens"] for f in futs]

    try:
        before = serve(door)
        ck.save(1, state)
        ck.wait()
        t0 = time.perf_counter()
        rep.poll_once()
        poll_ms = (time.perf_counter() - t0) * 1e3
        got = serve(door)
        if rep.loaded_step != 1:
            raise AssertionError(f"[17](vi) the good checkpoint was not "
                                 f"swapped in (loaded {rep.loaded_step})")
        fresh = serving.ContinuousBatcher(serving.ServingEngine(
            new, batch_buckets=engine.batch_buckets, dtype=torch.bfloat16),
            max_delay_ms=2.0)
        try:
            want = serve(fresh)
        finally:
            fresh.close()
        if any(not np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("[17](vi) after the swap the replica's "
                                 "tokens are not a fresh engine's")
        ck.save(2, serving.state_for_serving(net))
        ck.wait()
        rep.poll_once()
        again = serve(door)
        if rep.loaded_step != 1 or rep.rejected != 1 or any(
                not np.array_equal(a, b) for a, b in zip(again, want)):
            raise AssertionError("[17](vi) a checkpoint with the wrong "
                                 "fingerprint was not refused")
        alive = [r.rank for r in door.alive()]
    finally:
        rep.close()
    launches = _launches(rtc_kernels)
    if any(launches.values()):
        raise AssertionError(f"[17](vi) the serving path launched {launches}")
    changed = sum(not np.array_equal(a, b) for a, b in zip(before, got))
    log(f"    (vi) ReplicaServer over GPT-2 small bf16, buckets "
        f"{engine.batch_buckets}: step 1 (expect_fp matches) swapped in "
        f"after a {poll_ms:.1f} ms poll (verify + restore), its tokens a "
        f"fresh engine's ({changed} of {len(got)} requests changed); step 2 "
        f"(fingerprint mismatch) refused, the old weights served on; the "
        f"front door routed round the closed replica (alive {alive}); "
        f"flash launches {launches}  [{card}]")
    return {"swapped": 1, "rejected": rep.rejected, "alive": alive,
            "launches": launches}


def phase_planes(dev, card, rtc_kernels):
    """[17] The production planes on BERT-base (i)-(v) and the serving
    replica (vi).  Returns the flash launches of each BERT path and the
    numbers."""
    import gc
    import shutil
    import tempfile

    import torch

    from mxnet_tpu_torch import integrity

    res = {}
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="planes_")
    os.environ["MXTPU_INTEGRITY"] = "1"
    prev = torch.are_deterministic_algorithms_enabled()
    try:
        res["resilient"], run = _planes_resilient(dev, card, root,
                                                  rtc_kernels)
        launches = {"resilient_bert": res["resilient"]["launches"]}
        net, tr, loss_fn = run["trainer"]
        feed = run["feed"]
        del run
        gc.collect()
        res["fingerprint"] = _planes_fingerprint(dev, card, tr)
        res["checkpoints"] = _planes_checkpoints(dev, card, tr, root)
        _zero_all(rtc_kernels)
        res["integrity"] = _planes_integrity(dev, card, tr, net, loss_fn,
                                             feed, root)
        res["numerics"] = _planes_numerics(dev, card, tr, net, loss_fn,
                                           feed, root)
        launches["integrity_numerics_bert"] = _launches(rtc_kernels)
        del net, tr, loss_fn, feed
        gc.collect()
        torch.cuda.empty_cache()
        res["replica"] = _planes_replica(dev, card, root, rtc_kernels)
        launches["replica_serving"] = res["replica"]["launches"]
    finally:
        os.environ.pop("MXTPU_INTEGRITY", None)
        torch.use_deterministic_algorithms(prev)
        integrity._ODD.clear()
        shutil.rmtree(root, ignore_errors=True)
    log("    [17] " + json.dumps({k: v for k, v in res.items()},
                                 default=str))
    log(f"    [17] done in {time.perf_counter() - t0:.1f} s; flash launches "
        f"{launches}")
    return launches, res


# [18] the gang slice: BERT-base autotuned, and a two-rank BERT-base gang
# surviving a killed rank
TUNE_BUDGET = 10               # trials of the search
TUNE_STEPS = 2                 # timed steps a trial's first rung
TUNE_HEADROOM = 0.8            # share of the card the cached graphs may fill
REPLAY_STEPS = 3
GANG_STEPS = 28
GANG_SNAP_EVERY = 4
GANG_KILL_AFTER = 9            # rank 1 is SIGKILLed after this step
GANG_HB_TIMEOUT = 2.0
GANG_RETAIN_S = 30.0


def _gang_env_clean():
    from mxnet_tpu_torch.autotune import space

    for k in space.KNOBS.values():
        os.environ.pop(k.env, None)
    for name in ("MXTPU_AUTOTUNE", "MXTPU_TUNE_BUDGET", "MXTPU_TUNE_STEPS",
                 "MXTPU_TUNE_DB", "MXTPU_CAPTURE_CACHE"):
        os.environ.pop(name, None)


def _tune_bert(dev, card, root, bert_peak_gib, rtc_kernels):
    """(i) MXTPU_AUTOTUNE=search through Trainer.train_step on bench_bert's
    BERT-base over the knobs a consumer in the port reads (the one-card
    knobs), then a fresh trainer on the same signature under replay."""
    import gc

    import torch

    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.autotune import db, space
    from mxnet_tpu_torch.gluon import captured
    from mxnet_tpu_torch.tools import bench_bert

    total_gib = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    cache = max(1, int(TUNE_HEADROOM * total_gib // bert_peak_gib))
    path = os.path.join(root, "tune_db.jsonl")
    _gang_env_clean()
    os.environ.update(MXTPU_AUTOTUNE="search",
                      MXTPU_TUNE_BUDGET=str(TUNE_BUDGET),
                      MXTPU_TUNE_STEPS=str(TUNE_STEPS),
                      MXTPU_TUNE_DB=path,
                      MXTPU_CAPTURE_CACHE=str(cache))
    log(f"    (i) MXTPU_CAPTURE_CACHE={cache}: {TUNE_HEADROOM} of the card's "
        f"{total_gib:.2f} GiB over [8]'s peak of {bert_peak_gib:.2f} GiB a "
        f"step")
    base = space.current_config()
    net, tr, loss_fn, tok, lab = bench_bert.build_gluon(
        BERT_BATCH, BERT_SEQ, "flash", "bfloat16", dev, seed=SEED)
    telemetry.reset()
    captured.reset_counters()
    _zero_all(rtc_kernels)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr.train_step(net, loss_fn, tok, lab)
    torch.cuda.synchronize(dev)
    search_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    reserved_gib = torch.cuda.max_memory_reserved(dev) / 2 ** 30
    counts = _launches(rtc_kernels)
    if not all(v for k, v in counts.items() if k.startswith("flash")):
        raise AssertionError(f"[18](i) a flash kernel was not launched in "
                             f"the search: {counts}")
    results = tr._autotune_results
    entries = db.load(path)
    if len(entries) != 1 or len(results) != TUNE_BUDGET:
        raise AssertionError(f"[18](i) {len(results)} trials, database "
                             f"{list(entries)}")
    (entry,) = entries.values()
    if space.current_config() != entry["config"]:
        raise AssertionError("[18](i) the winner is not applied")
    ev = telemetry.event_counts()
    trials = [{"config": {k: v for k, v in r.config.items()
                          if v != base[k]} or "base",
               "fingerprint": r.fingerprint, "feasible": r.feasible,
               "score_us": r.score_us, "steps": r.steps}
              for r in results]
    infeasible = [t["config"] for t in trials if not t["feasible"]]
    misses = captured.cache_stats()["misses"]
    log(f"    (i) search: {len(results)} trials in {search_s:.2f} s "
        f"(with the step that asked), {misses} captures, peak "
        f"{peak_gib:.2f} GiB allocated ({reserved_gib:.2f} GiB reserved, "
        f"the graphs' pools included) across the search, events "
        f"{ {k: v for k, v in ev.items() if k.startswith(('tune', 'capture'))} }")
    for t in trials:
        log(f"      trial {t['config']}: "
            + (f"{t['score_us']:.1f} us a step over {t['steps']}"
               if t["feasible"] else "infeasible"))
    winner = {k: v for k, v in entry["config"].items() if v != base[k]} \
        or "base"
    log(f"    (i) winner {winner}: score_us {entry['score_us']:.1f} against "
        f"default_score_us {entry.get('default_score_us')}; infeasible "
        f"{infeasible or 'none'}  [{card}]")
    del net, tr, loss_fn, tok, lab
    gc.collect()
    torch.cuda.empty_cache()

    # replay: the defaults back in the environment, a fresh trainer
    for k in space.KNOBS.values():
        os.environ.pop(k.env, None)
    os.environ["MXTPU_AUTOTUNE"] = "replay"
    net, tr, loss_fn, tok, lab = bench_bert.build_gluon(
        BERT_BATCH, BERT_SEQ, "flash", "bfloat16", dev, seed=SEED)
    telemetry.reset()
    captured.reset_counters()
    _zero_all(rtc_kernels)
    losses = [float(tr.train_step(net, loss_fn, tok, lab)._data.float())
              for _ in range(REPLAY_STEPS)]
    replay_counts = _launches(rtc_kernels)
    ev = telemetry.event_counts()
    if ev.get("tune_db_hit") != 1 or any(
            k in ev for k in ("tune_trial", "tune_search_start")):
        raise AssertionError(f"[18](i) replay events {ev}")
    if space.current_config() != entry["config"] or \
            captured.cache_stats()["misses"] != 1:
        raise AssertionError("[18](i) replay did not apply the winner once")
    per_step = _kernel_counts(lambda: tr.train_step(net, loss_fn, tok, lab))
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv"):
        if per_step[name] != 12:
            raise AssertionError(f"[18](i) a replayed step ran {name} "
                                 f"{per_step[name]} times, not 12")
    log(f"    (i) replay: tune_db_hit, 0 trials, the winner applied, one "
        f"capture; losses {[round(x, 4) for x in losses]}; kernels a step "
        f"(fenced trace) {per_step}")
    del net, tr, loss_fn, tok, lab
    gc.collect()
    torch.cuda.empty_cache()
    _gang_env_clean()
    return {"capture_cache": cache, "trials": trials, "search_s": search_s,
            "peak_gib": peak_gib, "peak_reserved_gib": reserved_gib,
            "winner": winner,
            "score_us": entry["score_us"],
            "default_score_us": entry.get("default_score_us"),
            "infeasible": infeasible, "captures": misses,
            "replay_kernels_per_step": per_step, "launches": counts,
            "replay_launches": replay_counts}


def _gang_bert(dev, card, root):
    """(ii) Two BERT-base replicas as a gang on one card, rank 1 killed."""
    from mxnet_tpu_torch.tools import gang_bert

    work = os.path.join(root, "gang")
    os.makedirs(work)
    out = gang_bert.drive(work, kill_after=GANG_KILL_AFTER, fetch_step=4,
                          steps=GANG_STEPS, snap_every=GANG_SNAP_EVERY,
                          batch=BERT_BATCH, seq=BERT_SEQ, model="base",
                          hb_timeout=GANG_HB_TIMEOUT,
                          retain_s=GANG_RETAIN_S,
                          trace_step=GANG_STEPS - 1, timeout=600)
    r0 = out[0]
    if len(r0["recoveries"]) != 1:
        raise AssertionError(f"[18](ii) recoveries {r0['recoveries']}")
    (rec,) = r0["recoveries"]
    if rec["source"] != "peer" or r0["disk_restores"] != 0 or \
            rec["members"] != [0] or rec["dead"] != [1]:
        raise AssertionError(f"[18](ii) recovery {rec}, disk restores "
                             f"{r0['disk_restores']}")
    if r0["report"]["final_step"] != GANG_STEPS:
        raise AssertionError(f"[18](ii) report {r0['report']}")
    first, replayed, seen = {}, {}, set()
    for step, loss in r0["losses"]:
        (replayed if step in seen else first)[step] = loss
        seen.add(step)
    k = rec["snap_step"]
    if not replayed or min(replayed) != k:
        raise AssertionError(f"[18](ii) replayed {sorted(replayed)} from "
                             f"snapshot step {k}")
    compared = [s for s in replayed if s in first]
    for s in compared:
        if replayed[s] != first[s]:
            raise AssertionError(f"[18](ii) step {s} replayed as "
                                 f"{replayed[s]}, first {first[s]}")
    for line in out["doomed_lines"]:
        if line["loss"] != first[line["step"]]:
            raise AssertionError(f"[18](ii) rank 1's step {line['step']} "
                                 f"differs from rank 0's")
    traced = r0["kernels_traced_step"]
    if any(traced.get(n) != 12 for n in ("flash_fwd", "flash_dq",
                                        "flash_dkv")):
        raise AssertionError(f"[18](ii) rank 0's traced step ran {traced}")
    if not all(r0["launches"].values()):
        raise AssertionError(f"[18](ii) rank 0 launched {r0['launches']}")
    stalls = [s["stall_ms"] for s in r0["snapshot_stalls"]]
    joins = [s["join_ms"] for s in r0["snapshot_stalls"]]
    last = out["doomed_lines"][-1]["stats"]
    res = {
        "snapshot_step": k, "replayed_steps": len(replayed),
        "compared_bitwise": len(compared),
        "detect_s": rec["detect_t"] - out["kill_t"],
        "recover_s": rec["first_step_t"] - out["kill_t"],
        "recovery_ms": rec["recovery_ms"],
        "peer_snap_push_ms": last.get("pack_ms", 0) + last.get("send_ms", 0),
        "peer_snap_pack_ms": last.get("pack_ms"),
        "peer_snap_send_ms": last.get("send_ms"),
        "peer_snap_bytes": last.get("bytes"),
        "peer_fetch_ms": out["fetch"]["ms"],
        "snapshot_stall_ms": sorted(stalls)[len(stalls) // 2],
        "snapshot_stalls_ms": stalls, "snapshot_join_ms": joins,
        "step_tick_us": r0["step_tick_us_median"]["writer_idle"],
        "step_tick_us_writer_busy": r0["step_tick_us_median"]["writer_busy"],
        "step_ticks_idle_busy": r0["step_tick_us_median"]["ticks"],
        "kv_round_trip_us": r0["kv_round_trip_us_median"],
        "kernels_per_step": traced, "launches_rank0": r0["launches"],
        "disk_restores": r0["disk_restores"],
    }
    log(f"    (ii) 2 ranks of BERT-base on one card, a peer snapshot every "
        f"{GANG_SNAP_EVERY} steps through attach_peers, rank 1 SIGKILLed "
        f"after step {GANG_KILL_AFTER}: rank 0 recovered from peer RAM "
        f"(0 disk restores) at step {k}, replayed {len(replayed)} steps, "
        f"{len(compared)} of them bitwise its first pass; detect_s "
        f"{res['detect_s']:.3f}, recover_s {res['recover_s']:.3f} "
        f"(recover() {rec['recovery_ms']:.1f} ms); a push "
        f"{res['peer_snap_push_ms']:.1f} ms (pack "
        f"{res['peer_snap_pack_ms']:.1f}, send "
        f"{res['peer_snap_send_ms']:.1f}) for {res['peer_snap_bytes']} "
        f"bytes; a TCP fetch {res['peer_fetch_ms']:.1f} ms; the train "
        f"stream held {res['snapshot_stall_ms']:.2f} ms a snapshot "
        f"(median; waits for the previous writer {joins}); step_tick "
        f"{res['step_tick_us']} us on other steps with no snapshot in "
        f"flight, {res['step_tick_us_writer_busy']} us with one (medians, "
        f"ticks {res['step_ticks_idle_busy']}), one KV round trip "
        f"{res['kv_round_trip_us']:.1f} us; kernels a step "
        f"(fenced trace) {traced}  [{card}]")
    return res


def phase_gang(dev, card, rtc_kernels, bert_peak_gib):
    """[18] (i) autotune search and replay on BERT-base; (ii) the two-rank
    BERT-base gang surviving a killed rank.  Returns the flash launches of
    each path and the numbers."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="gang_")
    try:
        tune = _tune_bert(dev, card, root, bert_peak_gib, rtc_kernels)
        gang = _gang_bert(dev, card, root)
    finally:
        _gang_env_clean()
        shutil.rmtree(root, ignore_errors=True)
    zero_rtc = {"rtc_scale2": 0, "rtc_axpy": 0}
    names = {"flash_fwd": "flash_attention_fwd",
             "flash_dq": "flash_attention_dq",
             "flash_dkv": "flash_attention_dkv"}
    launches = {
        "autotune_search_bert": tune["launches"],
        "autotune_replay_bert": tune["replay_launches"],
        "gang_bert_rank0": dict(gang["launches_rank0"], **zero_rtc),
        "gang_bert_rank0_traced_step": dict(
            {names[k]: v for k, v in gang["kernels_per_step"].items()},
            **zero_rtc),
    }
    log("    [18] " + json.dumps({"autotune": tune, "gang": gang},
                                 default=str))
    log(f"    [18] done in {time.perf_counter() - t0:.1f} s; flash launches "
        f"{launches}")
    return launches, {"autotune": tune, "gang": gang}


DIST_BATCH, DIST_SEQ, DIST_STEPS, DIST_TIMED = 32, 512, 3, 5
DIST_LOSS_TOL = (2e-4, 2e-5)
DIST_PARAM_TOL = (2e-3, 2e-4)
DIST_PROBED = ("all_reduce", "broadcast", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single")


def phase_dist(dev, card, rtc_kernels):
    """[19] multi-rank training on the one card: a two-rank gang
    (tools/dist_bert.py) whose backend rule picks gloo (the ranks share
    the card); (i) the gloo-on-CUDA probe; (ii) the dist store's sums and
    2-bit compression card against host; (iii) BERT-base at bench_bert's
    width in f32 through ShardedTrainer at dp=2, tp=2, fsdp=2 and
    gluon.Trainer(kvstore="dist_sync"), each held against the one-rank
    ShardedTrainer on the same global batches; (iv) the same paths in
    bf16, timed.  Returns the flash launches of each path (rank 0) and the
    numbers."""
    import shutil
    import tempfile

    import torch

    from mxnet_tpu_torch.tools import dist_bert

    t0 = time.perf_counter()
    ref = dist_bert.reference("base", DIST_BATCH, DIST_SEQ, DIST_STEPS, dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    log(f"    [19] one-rank reference: losses {ref['losses']} "
        f"({ref_s:.1f} s)")
    root = tempfile.mkdtemp(prefix="dist_")
    try:
        ranks = dist_bert.drive(root, world=2, batch=DIST_BATCH,
                                seq=DIST_SEQ, steps=DIST_STEPS,
                                timed=DIST_TIMED, model="base",
                                timeout=900.0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    failed = []
    for r, res in enumerate(ranks):
        said = [ln for ln in res["log"].splitlines()
                if "process group backend" in ln]
        log(f"    [19] rank {r}: {said[0] if said else 'no backend line'}")
        if res["backend"] != "gloo" or not said:
            failed.append(f"rank {r} backend {res['backend']}")
        log(f"    [19](i) rank {r} gloo on CUDA: {json.dumps(res['probe'])}")
        for name in DIST_PROBED:
            if res["probe"][name] != "ok":
                failed.append(f"rank {r} probe {name}: {res['probe'][name]}")
        log(f"    [19](ii) rank {r} store: {json.dumps(res['kv'])}")
        if not all(res["kv"][k] for k in ("sum_ok", "codes_equal",
                                          "residual_equal",
                                          "pulled_equal")):
            failed.append(f"rank {r} store {res['kv']}")
        for path, got in res["check"].items():
            lerr = _excess(torch.tensor(got["losses"], dtype=torch.float64),
                           torch.tensor(ref["losses"], dtype=torch.float64),
                           *DIST_LOSS_TOL)
            perr = max(_excess(torch.tensor(got["samples"][k],
                                            dtype=torch.float64),
                               torch.tensor(v, dtype=torch.float64),
                               *DIST_PARAM_TOL)
                       for k, v in ref["samples"].items())
            want = 12 * DIST_STEPS
            log(f"    [19](iii) rank {r} {path}: losses {got['losses']} "
                f"(loss excess {lerr:.3f}, sampled-parameter excess "
                f"{perr:.3f}: <= 1 within rtol/atol {DIST_LOSS_TOL} / "
                f"{DIST_PARAM_TOL}); flash launches {got['launches']} "
                f"(want {want} each)")
            if lerr > 1 or perr > 1:
                failed.append(f"rank {r} {path} disagrees with one rank")
            if any(n != want for n in got["launches"].values()):
                failed.append(f"rank {r} {path} launches {got['launches']}")
        for path, t in res["timing"].items():
            log(f"    [19](iv) rank {r} {path} bf16: {t['ms_median']:.2f} ms "
                f"a step (min {t['ms_min']:.2f}, max {t['ms_max']:.2f}; "
                f"{t['ms']}); collectives {t['collective_bytes']} bytes a "
                f"step, {t['collective_s_median'] * 1e3:.2f} ms in steps with "
                f"the card synchronized around each collective; peak "
                f"{t['peak_mem_gib']:.2f} GiB  [{card}]")
    for path in dist_bert.PATHS:
        a = ranks[0]["check"][path]["samples"]
        b = ranks[1]["check"][path]["samples"]
        if a != b:
            failed.append(f"{path}: the ranks' parameters differ")
    if failed:
        raise RuntimeError("[19] failed: " + "; ".join(failed))
    zero_rtc = {"rtc_scale2": 0, "rtc_axpy": 0}
    launches = {f"dist_{path}_rank0": dict(
        ranks[0]["check"][path]["launches"], **zero_rtc)
        for path in dist_bert.PATHS}
    out = {"reference": ref["losses"], "reference_s": ref_s,
           "probe": ranks[0]["probe"], "kv": ranks[0]["kv"],
           "timing": {r: res["timing"] for r, res in enumerate(ranks)},
           "check_s": ranks[0]["check_s"],
           "timing_s": ranks[0]["timing_s"]}
    log(f"    [19] done in {time.perf_counter() - t0:.1f} s; flash launches "
        f"{launches}")
    return launches, out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mxnet_tpu_torch import _kernels

    t_start = time.perf_counter()
    # cuBLAS's deterministic workspace, set before its first handle: [10](ii)
    # runs under torch.use_deterministic_algorithms(True)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = torch.device("cuda", 0)
    card = smi_line()
    log("[1] card:", torch.cuda.get_device_name(0), "| count",
        torch.cuda.device_count(), "| nvidia-smi:", card)
    log("    torch", torch.__version__, "cuda", torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("    TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")

    log("[2] build")
    t0 = time.perf_counter()
    secs = _kernels.build()
    log(f"    built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(per source: { {k: round(v, 1) for k, v in secs.items()} })")
    for name, lines in _kernels.PTXAS_LOG.items():
        for ln in lines:
            log(f"    {name}: {ln.strip()}")
    phase_build_report()
    s2, ax, nvrtc_s = _rtc_kernels()
    log(f"    NVRTC (rtc.CudaModule, sm_90a) compile seconds: "
        f"{ {k: round(v, 4) for k, v in nvrtc_s.items()} }")

    log("[3] forward kernel against its plain version")
    fwd_errs = phase_kernels(dev)

    log("[3b] backward kernels against their plain version")
    bwd_errs = phase_bwd_kernels(dev)

    log("[4] forward timing (CUDA events)  [" + card + "]")
    phase_timing(dev)

    log("[4b] backward timing (CUDA events)  [" + card + "]")
    bwd_rows = phase_bwd_timing(dev)

    log("[5] serving path: gpt2_small, flash trunk, full width")
    _zero_counts()
    gen_launches = phase_main_path(dev, card)

    log("[5e] training path: gpt2_small, flash trunk, ShardedTrainer, "
        "full width")
    train_launches, step_ms = phase_train(dev, card)

    log("[5f] where a training step's device time goes (torch.profiler)")
    phase_profile(dev, card)

    log("[7] imperative path: nd + autograd linear regression, SGD by the "
        "NVRTC-compiled axpy")
    reg = phase_imperative(dev, card)

    log("[7b] runtime-compiled kernels (rtc.CudaModule) against their plain "
        "versions")
    rt = phase_rtc(dev, card, s2, ax)

    log("[8] BERT-base pretraining path: bert_base, flash trunk, bf16, "
        "ShardedTrainer on a one-device mesh, bench_bert's configuration")
    bert_launches, bert_res = phase_bert(dev, card)

    log("[9] ResNet-50 v1 training path: resnet50_v1, bf16, ShardedTrainer "
        "(SGD) on a one-device mesh, bench_resnet's configuration, NCHW "
        "and NHWC")
    resnet_launches, resnet_res = phase_resnet(dev, card, (s2, ax))

    log("[10] ResNet-50 v1 through gluon.Trainer: Trainer.step card "
        "against host, the captured train_step against the eager one "
        "(bitwise), bench_resnet's configuration through the eager loop, "
        "the captured step and ShardedTrainer, bench_trainer")
    trainer_launches, trainer_res = phase_trainer(dev, card, (s2, ax))

    log("[11] BERT-base and ViT-B/16 as Gluon blocks: the captured "
        "train_step against the eager one (bitwise), the per-layer trunk, "
        "bench_bert through gluon.Trainer eager and captured and "
        "ShardedTrainer, remat, LoRA, ViT-B/16 training")
    gluon_launches, gluon_res = phase_gluon_transformers(dev, card,
                                                         (s2, ax))

    log("[12] the input path: DataLoader and DevicePrefetcher (pinned "
        "staging, its own copy stream) bitwise through every transport "
        "and depth, ResNet-50 v1 and GPT-2 small trained from it, the "
        "JPEG pipeline, records and the resumable loader")
    input_launches, input_res = phase_input(dev, card, (s2, ax))
    gluon_launches.update(input_launches)

    log("[13] the recommender path: row-sparse ShardedEmbedding tables "
        "through the captured train_step at bench_embedding's "
        "configuration and at a 2^24-row table (bitwise against the eager "
        "oracle, card against host, the bench, the prefetcher's id prep), "
        "CSR dot and LibSVM training, CTC's probe")
    emb_launches, emb_res = phase_embedding(dev, card, (s2, ax))
    gluon_launches["recommender_path"] = emb_launches

    log("[14] the decode and serving path: bench_serving through "
        "ContinuousBatcher over one CUDA graph a bucket (GPT-2 small, "
        "bf16), graph-served tokens against CachedDecoder and generate(), "
        "bench_decode, speculative and beam decoding; Transformer-base on "
        "the flash kernels: training, beam_search, greedy_decode")
    serve_launches, serve_res = phase_serving(dev, card, (s2, ax))
    gluon_launches.update(serve_launches)

    log("[15] the recurrent path: the RNN op card against host in every "
        "mode, the medium PTB LSTM LM (vocab 10000, 650/650, 2 layers, "
        "T=35, B=20) card against host and trained 30 windows on the card "
        "through gluon.Trainer, tools.bench_lstm, the cuDNN yardstick, "
        "CustomOp, control flow, linalg and a legacy head")
    lstm_launches, lstm_res = phase_recurrent(dev, card, (s2, ax))
    gluon_launches["lstm_lm_path"] = lstm_launches

    log("[16] the detection path: the detection ops card against host at "
        "their users' sizes, SSD at the width of SSD-300 on VOC (20 "
        "classes, 3x300x300, B=32, 134296 anchors) card against host and "
        "trained 20 steps through gluon.Trainer by tools.bench_ssd, "
        "ssd_detect, the vision zoo at published widths with "
        "pretrained=True from a local file, ImageDetIter feeding SSD, "
        "Estimator.fit")
    ssd_launches, zoo_launches, det_res = phase_detection(dev, card,
                                                          (s2, ax))
    gluon_launches["ssd_path"] = ssd_launches
    gluon_launches["vision_zoo"] = zoo_launches

    log("[17] the production planes on BERT-base at bench_bert's "
        "configuration: (i) the card's integrity fingerprint against the "
        "host mirror; (ii) 40 steps under run_resilient through a SIGTERM "
        "at step 25, bitwise against an uninterrupted run; (iii) "
        "checkpoint stalls and the crash sites; (iv) the attestation's "
        "cost, a bit_flip_grad caught, the step records, /metrics; (v) "
        "nan_grad and the divergence rollback; (vi) ReplicaServer over "
        "GPT-2 small with hot reload and a refused fingerprint")
    planes_launches, planes_res = phase_planes(dev, card, (s2, ax))
    gluon_launches.update(planes_launches)

    log("[18] the gang slice on BERT-base at bench_bert's configuration: "
        "(i) MXTPU_AUTOTUNE=search through Trainer.train_step over the "
        "one-card knobs (device_prefetch, shm_slot_mb, remat, "
        "group_max_items, unique_bucket), MXTPU_CAPTURE_CACHE from [8]'s "
        "peak, then a fresh "
        "trainer replaying the stored winner with zero trials; (ii) two "
        "BERT-base replicas as an ElasticGang over a GangKVServer "
        "(tools/gang_bert.py), peer snapshots every 4 steps through "
        "attach_peers, rank 1 SIGKILLed after step 9, rank 0 recovering "
        "from peer RAM and replaying bitwise")
    gang_launches, gang_res = phase_gang(dev, card, (s2, ax),
                                         bert_res["peak_mem_gib"])
    gluon_launches.update(gang_launches)

    log("[19] multi-rank training on BERT-base at bench_bert's width: a "
        "two-rank gang on the one card (the backend rule picks gloo); (i) "
        "the collectives gloo accepts on CUDA tensors; (ii) the dist store "
        "and 2-bit compression card against host; (iii) f32, dropout 0, "
        "TF32 off: ShardedTrainer at dp=2, tp=2, fsdp=2 and "
        "gluon.Trainer(kvstore='dist_sync'), 3 AdamW steps each, against "
        "the one-rank ShardedTrainer; (iv) the same paths in bf16, timed")
    dist_launches, dist_res = phase_dist(dev, card, (s2, ax))
    gluon_launches.update(dist_launches)

    T0, Tb, Tv, Tt = TRAIN_SHAPE[2], BERT_SHAPE[2], VIT_SHAPE[2], TFM_SEQ
    sources = {"fwd": ("flash_attention_fwd", "flash_attention_fwd.cu",
                       ":78", "lib_fwd", "plain_fwd"),
               "dq": ("flash_attention_dq", "flash_attention_bwd.cu", ":190",
                      "lib_bwd", "plain_bwd"),
               "dkv": ("flash_attention_dkv", "flash_attention_bwd.cu",
                       ":241", "lib_bwd", "plain_bwd")}

    def errs_by(fn, T, dtype, causal):
        if fn == "fwd":
            return bwd_errs[("O", T, dtype, causal)]
        if fn == "dq":
            return bwd_errs[("dQ", T, dtype, causal)]
        return max(bwd_errs[("dK", T, dtype, causal)],
                   bwd_errs[("dV", T, dtype, causal)])

    def numbers(fn, lib, plain, shape, T, causal):
        f32 = bwd_rows[(shape, "float32", causal)]
        bf16 = bwd_rows[(shape, "bfloat16", causal)]
        return {
            "max_abs_err": errs_by(fn, T, "float32", causal),
            "ms": f32[fn], "plain_ms": f32[plain],
            "bound_ms": f32["bound"][fn][0], "bound_by": f32["bound"][fn][1],
            "library_ms": f32[lib],
            "max_abs_err_bf16": errs_by(fn, T, "bfloat16", causal),
            "ms_bf16": bf16[fn], "plain_ms_bf16": bf16[plain],
            "bound_ms_bf16": bf16["bound"][fn][0],
            "bound_by_bf16": bf16["bound"][fn][1],
            "library_ms_bf16": bf16[lib],
            "sdpa_backend": f32["sdpa_backend"],
            "sdpa_backend_bf16": bf16["sdpa_backend"],
        }

    kernels = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"mxnet_tpu_torch/csrc/{src}",
        "replaces": f"mxnet_tpu/ops/pallas_attention.py{line}",
        "launches": train_launches[name],
        **numbers(fn, lib, plain, TRAIN_SHAPE, T0, True),
        "shape": f"{TRAIN_SHAPE} causal (float32; *_bf16: bfloat16)",
        "at_bert_shape": dict(
            numbers(fn, lib, plain, BERT_SHAPE, Tb, False),
            shape=f"{BERT_SHAPE} non-causal"),
        "at_vit_shape": dict(
            numbers(fn, lib, plain, VIT_SHAPE, Tv, False),
            shape=f"{VIT_SHAPE} non-causal"),
        "at_transformer_shape": dict(
            encoder=dict(numbers(fn, lib, plain, TFM_SHAPE, Tt, False),
                         shape=f"{TFM_SHAPE} non-causal"),
            decoder=dict(numbers(fn, lib, plain, TFM_SHAPE, Tt, True),
                         shape=f"{TFM_SHAPE} causal"),
            **({"decode_steps": {
                f"T={T}": {"shape": str(TFM_SHAPE[:2] + (T, TFM_SHAPE[3]))
                           + " causal",
                           "max_abs_err": fwd_errs[(
                               TFM_SHAPE[:2] + (T, TFM_SHAPE[3]), "float32",
                               True)],
                           "max_abs_err_bf16": fwd_errs[(
                               TFM_SHAPE[:2] + (T, TFM_SHAPE[3]), "bfloat16",
                               True)]}
                for T in TFM_DECODE_T}} if fn == "fwd" else {})),
        "launches_by_path": dict(
            {"generate": gen_launches} if fn == "fwd" else {},
            train_step=train_launches[name],
            bert_train_step=bert_launches[name],
            resnet_train_step=resnet_launches[name],
            gluon_captured_train_step=trainer_launches[name],
            **{path: counts[name]
               for path, counts in gluon_launches.items()}),
        "plain_and_library_cover": ("the forward" if fn == "fwd" else
                                    "the whole backward (dQ, dK, dV)"),
    } for fn, (name, src, line, lib, plain) in sources.items()]}
    rtc_launches = {"rtc_scale2": {"rtc_path": rt["path"]["rtc_scale2"],
                                   "resnet_train_step":
                                       resnet_launches["rtc_scale2"],
                                   "gluon_captured_train_step":
                                       trainer_launches["rtc_scale2"]},
                    "rtc_axpy": {"imperative_sgd": reg["launches"],
                                 "rtc_path": rt["path"]["rtc_axpy"],
                                 "resnet_train_step":
                                     resnet_launches["rtc_axpy"],
                                 "gluon_captured_train_step":
                                     trainer_launches["rtc_axpy"]}}
    for name in rtc_launches:
        rtc_launches[name].update(
            {path: counts[name] for path, counts in gluon_launches.items()})
    for name, replaces in (("rtc_scale2", "mxnet_tpu/rtc.py:53, "
                                          "tests/test_aux.py:256"),
                           ("rtc_axpy", "mxnet_tpu/rtc.py:53")):
        kernels["kernels"].append({
            "name": name,
            "route": "cuda (NVRTC, runtime)",
            "source": "chip_smoke.py:" + ("SCALE2_SRC" if name ==
                                          "rtc_scale2" else "AXPY_SRC"),
            "replaces": replaces,
            "launches": (reg["launches"] if name == "rtc_axpy"
                         else rt["path"][name]),
            "max_abs_err": (reg["max_abs_err"] if name == "rtc_axpy"
                            else rt["err"][name]),
            "ms": rt["ms"][name],
            "plain_ms": rt["plain"][name],
            "bound_ms": rt["bounds"][name][0],
            "bound_by": rt["bounds"][name][1],
            "library_ms": rt["lib"][name],
            "shape": f"({RTC_N},) float32",
            "launches_by_path": rtc_launches[name],
            "compile_s": nvrtc_s[name.split("_")[1]],
            "host_launch_us": rt["host_us"],
        })

    log(f"[6] done in {time.perf_counter() - t_start:.1f} s "
        f"(train step {step_ms:.2f} ms; imperative step "
        f"{reg['ms_step']:.3f} ms; BERT bf16 step "
        f"{bert_res['ms_per_step']:.2f} ms; ResNet-50 bf16 step "
        f"{resnet_res['NCHW']['ms_per_step']:.2f} ms NCHW, "
        f"{resnet_res['NHWC']['ms_per_step']:.2f} ms NHWC at "
        f"B={resnet_res['NCHW']['batch']}; through gluon.Trainer "
        f"{trainer_res['gluon']['ms_per_step']:.2f} ms eager, "
        f"{trainer_res['captured']['ms_per_step']:.2f} ms captured; "
        f"bench_trainer {trainer_res['bench_trainer']['value']:.1f} us "
        f"captured; Gluon BERT bf16 step "
        f"{gluon_res['gluon']['ms_per_step']:.2f} ms eager, "
        f"{gluon_res['captured']['ms_per_step']:.2f} ms captured, "
        f"{gluon_res['sharded']['ms_per_step']:.2f} ms ShardedTrainer; "
        f"input path: ResNet-50 data_stall_share "
        f"{input_res['resnet']['data_stall_share']:.4f}, sync "
        f"{input_res['resnet']['data_stall_share_sync']:.4f}, "
        f"{input_res['resnet']['samples_per_sec']:.1f} samples/s fed by "
        f"the prefetcher; GPT-2 from the DataLoader "
        f"{input_res['gpt']['ms_per_step']:.2f} ms a step; "
        f"recommender: {emb_res['bench']['a']['value']:.1f} ids/s at (a), "
        f"{emb_res['bench']['b']['value']:.1f} ids/s at (b) in "
        f"{emb_res['bench']['b']['peak_mem_gib']:.3f} GiB peak; serving: "
        f"p50 {serve_res['serving']['value'] / 1e3:.2f} ms, "
        f"{serve_res['serving']['tokens_per_sec']:.1f} tokens/s batched, "
        f"{serve_res['serving']['tokens_per_sec_unbatched']:.1f} one by one; "
        f"Transformer-base bf16 step "
        f"{serve_res['transformer']['ms_per_step']:.2f} ms; medium LSTM "
        f"LM step {lstm_res['train']['ms_per_step']:.2f} ms, "
        f"{lstm_res['train']['tokens_per_sec']:.1f} tokens/s, busy "
        f"{lstm_res['train']['busy_share']:.3f}; SSD-300-width step "
        f"{det_res['bench']['ms_per_step']:.2f} ms, "
        f"{det_res['bench']['images_per_sec']:.1f} images/s, busy "
        f"{det_res['bench']['busy_share']:.3f}; ssd_detect "
        f"{det_res['detect']['ms'][0]:.2f} ms at B=32; production "
        f"planes: resilient BERT "
        f"{planes_res['resilient']['ms_per_step']:.2f} ms a step "
        f"(uninterrupted "
        f"{planes_res['resilient']['ms_per_step_uninterrupted']:.2f}), "
        f"ckpt_stall_us "
        f"{planes_res['checkpoints']['ckpt_stall_us']:.1f} async, "
        f"{planes_res['checkpoints']['sync_stall_us']:.1f} sync, "
        f"integrity_overhead_pct "
        f"{planes_res['integrity']['integrity_overhead_pct']:.3f}; "
        f"gang: autotune {len(gang_res['autotune']['trials'])} trials in "
        f"{gang_res['autotune']['search_s']:.1f} s, detect_s "
        f"{gang_res['gang']['detect_s']:.3f}, recover_s "
        f"{gang_res['gang']['recover_s']:.3f}; two ranks on one card "
        f"(gloo) bf16 ms a step: "
        f"{ {p: round(t['ms_median'], 2) for p, t in dist_res['timing'][0].items()} }; "
        f"forward O max abs err at BERT's "
        f"shape {fwd_errs[(BERT_SHAPE, 'float32', False)]:.3e} f32, "
        f"{fwd_errs[(BERT_SHAPE, 'bfloat16', False)]:.3e} bf16)")
    log(json.dumps(kernels))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
