#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

1. Requires a CUDA device (exits non-zero without one) and prints the
   card's name and power limit as nvidia-smi reports them.
2. Builds every kernel of the port from paddle_tpu_torch/csrc with nvcc
   (one process per source, all at once) and prints the build seconds.
3. Kernel phase: holds each attention and optimizer kernel against its
   plain PyTorch version on the card: the flash-attention forward
   (without and with attention dropout), its dq and dk/dv backward
   kernels (float32 through the tensor-core (3xTF32) forward and the
   CUDA-core backward kernels; bf16 through the tensor-core forward, dq
   (di fused in) and dk/dv kernels, as the entry points choose; both
   dtypes again through the CUDA-core ones; head dims 192, 256, 264, 320
   and 512 through the CUDA-core kernels in both dtypes; the bf16
   gradients of rows whose keys are all padded against
   flash_attention.bf16_backward_bound), one call under
   PT_KERNEL_DENY=flash_attention (no launch), Adam (one multi-tensor
   launch a list, 0 ulp over three steps in p, m, v and the beta powers:
   the 99 parameter shapes of Transformer-base that the registry routes
   to it, lengths 1, 3, 4097 and 65537 with and without weight decay,
   views one element past a 16-byte boundary, and 1100 tensors, three
   launches), and SGD (one multi-tensor launch a list, 0 ulp, over
   lengths 1, 127, 129 and 513, LeNet's six parameter shapes and the 255
   parameter shapes of Transformer-base). Then times kernel, plain
   version and the library yardstick: the float32 forward at the serving
   shape in both designs, the attention kernels of both designs at the
   training shape (B=96, S=128, H=8, D=64, bf16; device time, sdpa's
   too), Adam's one launch over the 99 routed parameters against
   torch.optim.Adam(fused=True) (and the plain update of the other 156
   on the host's clock), and SGD at Transformer-base's and LeNet's sizes
   (one list a launch, and the same kernel a parameter at a time,
   against torch._foreach_add_).
4. Scoring phase: builds full-width Transformer-base (6+6 layers,
   d_model 512, 8 heads, vocab 32000, fuse_attention) with the port's
   layers, initializes it on the card from a seed, and scores 3 ragged
   batches of 32 x 256 tokens through Executor.run in float32. Checks
   finite logits and cost, 18 attention launches per forward (all of
   them the float32 tensor-core forward), and the logits against the
   same forward under plain_reference().
5. Training phase: the same model as bench.py trains it (dropout 0.1,
   contrib.mixed_precision.decorate(AdamOptimizer(2e-4)): bf16 compute,
   float32 master weights) takes 5 steps on one ragged batch of
   96 x 128. Checks a finite, falling loss, exactly 18 forward, 18 dq,
   18 dk/dv (all of them the tensor-core kernels) and 1 Adam launch
   per step (the registry routes the 99
   parameters of at least PT_KERNEL_MIN_NUMEL = 65536 elements to the
   kernel and lowers the other 156, and the engine hands the 99 to one
   multi-tensor launch; no GEMM kernel: none is opted in),
   the registry's decisions, and one step from a copy of the initial
   scope under
   plain_reference() against the kernels' first step. Prints steps/s,
   tokens/s, peak memory and a profile of one step.
6. GEMM kernels: quantized_matmul int8 (bit-equal) and bf16 against
   their plain versions at the four GEMM shapes of the serving forward
   and at 256x384x128, and every instantiated tuned_matmul variant of
   both designs (the CUDA-core tiles of tuned_matmul.cu and the 3xTF32
   tensor-core tiles of tuned_matmul_sm90.cu; epilogues none,
   layer_norm, dropout_residual) at every serving shape it divides, and
   a probe of how the tensor cores round a float32 sum. Then
   tuning.variants.search_variants on the card at the serving forward's
   most frequent GEMM (M=8192, N=512, K=512), the path of the
   layer_norm and dropout_residual epilogues and of the CUDA-core tiles
   (both designs timed in the same run, each variant by runs of calls
   queued back to back; the none and layer_norm winners must be
   tensor-core tiles), and the device times of every GEMM kernel (the
   search's winning tiles and the fastest CUDA-core ones; for
   dropout_residual the fastest tile of each design; the quantized GEMM
   and the tensor-core tuned GEMM split into pre-pass and GEMM), its
   plain version and its library yardstick at the four serving shapes.
   With `--baseline DIR` (an earlier checkout of the repo, e.g. unpacked
   with git archive) the CUDA-core attention forward, the SGD and Adam
   kernels and the quantized GEMM of that checkout are built and timed
   in turns with this one's (phases 3 and 6).
7. Serving in the GEMM modes: the batches of phase 4 again with every
   one of the 97 mul ops through a GEMM kernel:
   PT_KERNEL_QUANT_MATMUL=int8, =bf16, and with the search's float32
   winner registered (register_winner; a tensor-core tile, so
   tuned_matmul_sm90). Each mode requires 97 launches of its kernel a
   forward, prints the registry's dispatch stats, and
   holds its logits against the same forward with only the GEMMs plain
   (int8: bit-equal), under plain_reference(), and against float32.
   Serving phase: the JAX package's book LM (inference/serving
   build_book_lm: single-head, 6 layers, hidden 512, vocab 32000, the
   decoder widths and depth of bench.py's Transformer-base) initialized
   on the card from SEED, exported and loaded, then served by the
   continuous-batching engine at BucketSpec(batch=128, prefill 64/128/
   256, cache 128/256/512) from a paged KV cache of 4098 pages. warmup()
   must capture the 6 signatures; a burst of 512 requests
   (RandomState(0): prompts of 8-256 tokens, 32-128 new tokens) must
   end all ok with no page in use, and plan, capture and run eagerly
   nothing; prints tokens/s, requests/s, occupancy, prefill and decode
   ms by bucket (median, p99), peak memory and the census's KV bytes,
   the busy share and top kernels of 20 profiled decode steps. The
   first 4 requests' tokens must equal reference_generate's, one
   prefill and one decode dispatch plain_reference()'s (LOGITS_ATOL).
   Then bursts of 128 in float32 and with every mul in the bf16, int8
   and tuned GEMM kernel: 37 launches a prefill and a decode dispatch,
   tokens/s, the share of tokens equal to float32's, a solo run
   against the batch (not required in int8: its scales tie a row to its
   batch mates), the dispatches against plain_reference()
   (QUANT_FWD_RTOL); the GEMMs at a decode dispatch's shapes timed
   against their plain versions, library calls and bounds; and 8
   generate calls from 4 threads through ServeServer, equal to the
   in-process tokens, then a drained shutdown().
8. Graph capture phase: Executor.run replaying one CUDA graph a run
   (core/engine.py _Captured) on every main path, captured against
   eager (use_program_cache=False) in turns: ResNet-50 (bench.py's,
   B=128, bf16 AMP, Momentum) with the batch on the card and from
   numpy, Transformer-base training (B=96, S=128, dropout 0.1) and
   serving (B=32, S=256, float32 and int8); for each the rate, the
   busy share and top kernels of a profiled replay, the host ms of a
   captured run, peak memory and the graph pools, and the engine's
   counters. 5 captured runs against 5 eager ones from one state in
   deterministic mode, bit for bit (ResNet-50, the Transformer with
   dropout and 18/18/18/1 attention and Adam launches a run, LeNet
   with its SGD in the fused_sgd kernel), serving within LOGITS_ATOL of
   eager, iterations=3 against three single runs, a scope write
   between replays, and Wide&Deep dense and sparse captured or kept
   eager as the capture rule decides (printed with the reason).
9. CTR phase (BASELINE config 4, bench.py's bench_ctr): Wide&Deep with
   dense embedding gradients (the bench default), Wide&Deep with
   is_sparse=True (SelectedRows gradients) and DeepFM, at vocab
   1000001, B=4096, AdagradOptimizer(0.01), 10 steps each through
   Executor.run. Prints examples/s (steps 2-10, fetch included), peak
   memory, the losses, the device-busy share and top kernels of a
   profiled step and a cProfile of one step; requires finite,
   pairwise-distinct losses, no launch of the port's kernels, sparse
   against dense from the same initial scope (the first loss, the
   parameters after 3 steps), and one more sparse step with every
   sparse lowering under sync debug mode "error". Times dense and
   sparse Wide&Deep in turns, and the embedding table's gradient and
   update on each path against its byte bound (the sparse update kernel
   by kernel). Then a padding_idx table with
   duplicate ids through the sparse update of SGD, Momentum, Adagrad
   and Adam: no device-side assert, no host sync, the padding row and
   the rows never looked up unchanged.
10. Dygraph phase (BASELINE config 5, bench.py's bench_dygraph): the
   dygraph ResNet-50 (dygraph_resnet: bottleneck [3, 4, 6, 3], NCHW,
   1000 classes) built under dygraph.guard(CUDAPlace(0)) and trained
   with MomentumOptimizer(0.1, 0.9) under dygraph.jit.capture(amp=True)
   at B=128, 224x224 on RandomState(0)'s batch on the card. Discovery
   (the step on meta tensors) must create the parameters an eager build
   from the same seed draws and move no statistic or velocity; each of
   10 calls must be one CUDA-graph replay (the capture under sync debug
   mode "error": no host sync in the step), no kernel of the port
   captured, the master parameters float32, the loss finite and falling
   below its first value. Prints images/s over the bench's windows of 10
   and 20 steps, the host ms of a captured call, the busy share and top
   kernels of a profiled replay and peak memory; eager and captured
   steps in turns (images/s, host ms); 5 captured and 5 eager steps from
   one state in deterministic mode, bit-equal; the first float32 loss
   at B=8 against graph-mode ResNet-50 (models/resnet.py) on the same
   parameters, mapped by creation order; and 2 eager Adam steps in
   float32 at B=32, one fused_adam launch a step, bit-equal to the same
   steps under plain_reference().
11. Sequence phase (BASELINE config 3's variable-length path): the
   PaddlePaddle book's sentiment classifiers (models/sentiment.py:
   stacked_lstm_net with 3 LSTMs, convolution_net with two
   sequence_conv_pool branches) at the book's widths (emb 128, hid 512,
   vocab 5148), Adagrad(0.002) on a sparse embedding, B=128, on LoD
   batches of RandomState(i) reviews whose lengths are log-normal
   (median 174, sigma 0.75, clipped to [10, 2494]: IMDB's shape). For
   each net: a pool of SEQ_POOL batches, each run three times with the
   plan cache (its first run eager, its second captures, its third
   replays) and the same runs with use_program_cache=False, from one
   startup state in deterministic mode: fetches and persistables
   bit-equal; the first loss against the port on the CPU from the same
   parameters (SEQ_LOSS_RTOL); the captures clocked; eager against
   captured in turns (examples/s, tokens/s, host s a run), a profiled
   replay (busy share, kernels a step, top kernels), peak memory and
   the graph pools; a stream of SEQ_STREAM distinct batches (a plan
   each, eager); for the stacked net, save_inference_model and the
   AnalysisPredictor on the card on LoD feeds (a capture a signature at
   warmup, then none; outputs equal to the Executor's). Prints each
   batch's padded share (N * longest / tokens). No kernel of the port
   is launched.
12. Control flow phase: the PaddlePaddle book's RNN encoder-decoder
   (chapter 08; models/seq2seq.py: a DynamicRNN encoder, its last step
   booting a DynamicRNN decoder, a softmax fc over the target
   vocabulary, AdamOptimizer(0.01)) at vocab 30000, word 512, hidden
   512, B=64, on LoD batches of random ids whose lengths are WMT14's
   shape (log-normal, median 26, sigma 0.55, clipped to [2, 80]),
   source and target apart. A pool of CF_POOL batches, each run CF_RUNS
   times with the plan cache (eager, the capture, replays) and the same
   runs with use_program_cache=False from one startup state in
   deterministic mode: losses and persistables bit-equal, no block kept
   eager, exactly one fused_adam launch a step over the 7 parameters the
   registry routes; one step against the same step under
   plain_reference() (bit-equal); the first loss against the port on
   the CPU (CF_LOSS_RTOL); eager against captured in turns (examples/s,
   target tokens/s), the captures clocked, a profiled replay (busy
   share, kernels), peak memory and the graph pools; a stream of
   CF_STREAM distinct batches (eager); save_inference_model with the
   logits as the fetch and the AnalysisPredictor on the src and tgt_in
   LoD feeds (no capture after warm-up, equal to the Executor); a While
   loop (kept eager, its reason printed), an IfElse row-wise branch and
   a StaticRNN trained 3 Adam steps captured, each against the CPU
   (CF_ATOL); Adam timed at the seq2seq's parameter shapes.
13. Book models phase: the book's last two models.
   label_semantic_roles (models/label_semantic_roles.py: embedding, a
   DynamicRNN, the emission fc, linear_chain_crf, Adam(0.01)) at the
   CoNLL-05 widths (vocab 44068, 59 tags, embedding 32, hidden 512),
   B=64 on synthetic CoNLL-05 batches (lengths uniform in 5-29): SRL_POOL
   batches SRL_RUNS times each captured against eager, bit-equal, one
   fused_adam launch a step over its 2 routed tensors, the first loss
   against the CPU (SRL_LOSS_RTOL), one step against plain_reference(),
   eager against captured in turns, a profiled replay, peak memory; its
   crf_decoding program on the trained scope captured against eager and
   through the AnalysisPredictor (the Viterbi paths and their LoD equal
   the Executor's). machine_translation (models/machine_translation.py)
   at chapter 08's widths (30000 / 512 / 512): 4 Adam steps at B=64
   captured against eager, then its beam-search decoder (statically
   unrolled: 128 sources, beam 4, 80 steps) on the trained scope,
   captured as one CUDA graph against eager in float32 and with every
   eligible GEMM in the int8 and bf16 kernels (2 x the longest source +
   160 quantized_matmul launches a decode), each against the same
   decode under plain_reference() (float32 and int8 bit-equal, bf16
   within MT_SCORE_RTOL / MT_SCORE_ATOL up to a near-tie); sources/s,
   generated tokens/s, ms a decode, the captures clocked, a profiled
   replay (busy share, kernels), peak memory, and the AnalysisPredictor
   on its two-level LoD feed (equal to the Executor).
14. The bucket sweep, schedule, contrib decoder, value-dependent
   sequence and op sweep phases. Flash lse phase: flash_attention_lse at the
   training shape (B=96, S=128, H=8, D=64, [B, H, S, D]) in bf16
   (tensor-core kernels) and float32 (CUDA-core backward): g_lse = 0
   gives fused_attention_backward's gradients bit for bit, a random
   g_lse float64 exact gradients of the composed (out, lse) within
   BWD_F32_TOL (float32) and bf16_backward_bound (bf16). Bucket sweep
   phase: Transformer-base's training program planned into gradient
   buckets (parallel/comm_scheduler.py), one step's parameters,
   gradients and Adam moments flattened a bucket, and
   kernels.fused_optimizer.bucket_sweep's Adam and SGD kernels over
   every bucket: bit-equal to the plain version and to the
   per-parameter fused_*_multi, 4 ZeRO-1 windows (each writing only its
   own rows) together equal to the unsharded sweep, the guard's
   nonfinite (inputs back) and spike (damp 0.5) gates, a captured sweep
   replayed with a new hyper table and one replayed with new beta
   powers and shard index (tensors); timed by queued events behind a
   card sleep the host must finish queuing inside (its ms printed),
   beside the profiler's time of the sweep's kernels alone (the window
   may hold nothing but the one launch a bucket), shard 0 of 4 against
   its own byte bound, the plain version, torch.optim.Adam(fused=True)
   / torch._foreach_add_ and the byte bound (with --baseline, the
   earlier checkout's sweep in turns). LR schedule phase:
   Transformer-base (the training phase's program) under
   AdamOptimizer(noam_decay(512, 4000)), 5 captured runs against 5
   eager ones bit for bit with 18/18/18/1 launches a run and
   each run's rate against the schedule (LR_RTOL); ResNet-50 under
   piecewise_decay, one eager and one captured run against two eager.
   Contrib decoder phase: the book's machine translation model through
   the contrib API (models/machine_translation.py contrib_train,
   contrib_decode) at 30000 / 512 / 512: 4 Adam steps of the
   TrainingDecoder against mt_train's (targets of 26 words), losses
   bit-equal; the BeamSearchDecoder (128 sources, beam 4, 80 steps)
   captured as one CUDA graph against eager and against mt_decode in
   float32, int8 (bit-equal) and bf16 (ids equal, scores within
   MT_BF16_RTOL). Value-dependent sequence phase: sequence_erase,
   sequence_slice and edit_distance on 128 IMDB-shaped sequences, the
   card against the CPU (values, LoDs), each block eager with the op
   named in Engine.eager_reasons. Op sweep: every case of
   ops/family_cases.py (the basic, reduce, elementwise, activation and
   nn families, the nine update ops without a kernel, the three
   sequence ops and SSD's eight detection ops) on the card against the
   CPU.
15. Detection phase: MobileNet-SSD as PaddleCV's object_detection
   defines it (mobilenet_ssd: MobileNet-v1 at scale 1.0, extra blocks,
   multi_box_head over six maps: 1917 priors) at Pascal VOC's 300x300,
   21 classes, B=64, ssd_loss summed, RMSProp(piecewise_decay from
   1e-3, L2Decay(5e-5)) as train.py runs it, on VOC-shaped LoD batches
   (a geometric number of boxes an image, mean 2.4, 1-42; labels 1-20;
   difficult flags). SSD_POOL batches SSD_RUNS times each captured
   against eager in deterministic mode, bit-equal; the first loss
   against the port on the CPU (SSD_LOSS_RTOL); images/s eager against
   captured in turns, the captures clocked; a profiled replay (busy
   share, top kernels), peak memory; a stream of SSD_STREAM new LoD
   batches (eager). Then eval.py's detection_output (nms 0.45, top 400,
   keep 200, score 0.01) on the trained net's test clone through
   Executor.run (eager, captured, replayed rows equal) and
   AnalysisPredictor (within SSD_ROWS_ATOL), images/s eager against
   captured, a profiled replay, multiclass_nms alone at 64 x 21 x 1917
   eager and captured (rows equal to the CPU's), and the DetectionMAP
   evaluator (11point) over two batches, eager. No kernel of the port
   lies on this path.
16. MNIST phase: LeNet (BASELINE config 1: conv 20 and 50, 5x5, max
   pool 2, fc 10 softmax) with SGD(0.05) takes 10 steps at B=512 on
   bench.py's batch, through Executor, twice from the same startup
   state: with the default knobs (every parameter below the 65536
   floor: 0 SGD launches, 6 lowered updates a step) and with
   PT_KERNEL_MIN_NUMEL=1 (the engine hands the six sgd ops to one
   multi-tensor SGD launch a step); losses and final parameters must be
   equal (cuDNN deterministic). Then
   save_persistables / load_persistables into a fresh scope (the next
   step gives the same loss from both) and save_inference_model /
   load_inference_model in a fresh scope (B=512 inference equal to the
   live test clone's). Prints steps/s, images/s and the device-busy
   share of one profiled step.
17. Prints one JSON line of per-kernel numbers (fused_adam's launches:
   the training phase's, the dygraph phase's, the control flow
   phase's, the book models phase's, the lr schedule phase's and the
   contrib decoder phase's captured steps; the quantized and tuned
   GEMMs': the scoring and the serving phase's, and the quantized ones'
   also the book models and contrib decoder phases' captured decodes;
   the bucket sweep rows: the bucket sweep phase's main sweep; the
   attention backward rows' g_lse_launches: the flash lse phase's),
   then, last, the device
   line {"ok": true, "device": {...}}. Any failed check raises: the
   script exits non-zero and prints no result.

float32 matmuls and convolutions run in full float32 (TF32 off), as the
port assumes. Executor.run captures a plan's block at the plan's second
run and replays it after (core/engine.py), so from their second step on
the phases' runs are graph replays; the sparse step of the CTR phase
that must run its lowerings under sync debug mode "error" runs op by
op (use_program_cache=False).
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234

# tolerances of the kernel phase: float32 differs from the plain version
# only in the order of float32 sums; bf16 rounds p and out to bf16
F32_TOL = 1e-5
BF16_TOL = 2e-2
# backward, float32: each gradient sums up to S products of the
# recomputed p, in another order than the plain version's matmuls
BWD_F32_TOL = 1e-4
# Adam: both round each operation once, in the same order
ADAM_ULP = 0
# SGD: the same two roundings (lr*g, then the difference), never
# contracted into a fused multiply-add
SGD_ULP = 0
# whole-forward logits, kernel vs plain_reference(): the attention
# outputs' float32 rounding differences (~5e-7), carried through 12
# layers and 30 layer norms; logits have std ~0.45 at this
# initialization, and the measured difference is ~2e-6
LOGITS_ATOL = 1e-4
COST_RTOL = 1e-4

# one training step from copies of the initial scope: the kernels' bf16
# step against the same step under plain_reference() and against the
# same Program run in float32 (no AMP, same dropout masks).
# * the loss to a relative LOSS_STEP_RTOL (bf16 outputs of the attention
#   round differently where the float32 sums differ in their last bits);
# * the gradients, read from the first moments (m = 0.1 g after one step)
#   in the norm over all parameters: the kernels' bf16 gradients must be
#   as close to the float32 ones as the plain version's bf16 gradients
#   are, within GRAD_NOISE_RATIO of that distance. bf16 keeps 8 bits, and
#   its rounding, not the kernels, sets how far a bf16 step is from the
#   float32 one;
# * a parameter to at most 2 * lr: Adam's first step moves an element by
#   lr * g / (|g| + 3.2e-7), about lr in the gradient's sign, so where a
#   gradient near zero takes the other sign two steps part by up to
#   2 * lr (the key biases' gradients are zero but for rounding noise).
LOSS_STEP_RTOL = 1e-3
GRAD_NOISE_RATIO = 1.5

# GEMM kernels, each against its plain version on the same inputs,
# relative error in the norm: bf16 and the tuned float32 GEMMs differ
# only in the order of their float32 sums (products of bf16 values are
# exact in float32); int8 must be bit-equal (exact int32 tile sums, then
# the same two roundings a tile, in K order)
GEMM_RTOL = 1e-5
# a whole serving forward through the GEMM kernels against the same
# forward with the GEMMs (or every kernel) on their plain versions,
# relative error of the logits in the norm. int8: with only the GEMMs
# plain, bit-equal (each GEMM is, on the same inputs). Otherwise a
# last-bit difference (the attention kernel's or bf16 GEMMs' float32
# sums) moves a value across a rounding boundary of the next GEMM's
# quantization, by one int8 step (1/127 of its tile's range) or one bf16
# step (2^-8); the next GEMMs carry the change on and cross more
# boundaries, and over 12 layers the two forwards end as far apart as
# two draws of the quantization noise (1.7e-2 in int8, measured on an
# H100). So the bound there is the mode's parity bound. Tuned float32:
# sum order only.
QUANT_FWD_RTOL = {"int8": 5e-2, "bf16": 1e-2, "tuned": 1e-5}
# the same forward against the float32 (cuBLAS) one: the parity bounds
# of kernels/parity.py (int8 5e-2, bf16 1e-2, tuned 1e-4)
PARITY_RTOL = {"int8": 5e-2, "bf16": 1e-2, "tuned": 1e-4}
# the serving forward's mul ops at B=32, S=256: (M, K, N, ops a forward)
SERVE_GEMMS = ((8192, 512, 512, 72), (8192, 512, 2048, 12),
               (8192, 2048, 512, 12), (8192, 512, 32000, 1))
SERVE_MULS = sum(g[3] for g in SERVE_GEMMS)      # 97
# the variant search runs on the serving forward's most frequent GEMM
SEARCH_PROBLEM = (8192, 512, 512)                 # M, N, K

# Published peaks (NVIDIA data sheets, dense): float32 outside the tensor
# cores, bf16 in them, HBM bytes/s, int8 and TF32 in the tensor cores, in
# FLOP/s (OP/s). Keyed by the name torch reports.
_PEAKS = {"PCIe": (51e12, 756e12, 2.0e12, 1513e12, 378e12),
          "NVL": (60e12, 835e12, 3.9e12, 1671e12, 417e12),
          "SXM": (67e12, 989e12, 3.35e12, 1979e12, 495e12)}

# the training shape: bench.py's Transformer-base batch
TRAIN_B, TRAIN_S, LR = 96, 128, 2e-4
# LeNet on MNIST: bench.py's batch (bench_lenet) and the SGD rate of
# tests/test_executor_mnist.py
MNIST_B, MNIST_STEPS, MNIST_LR = 512, 10, 0.05
# LeNet inference from a loaded inference model against the live test
# clone: the same ops on the same weights (cuDNN deterministic)
INFER_ATOL = 1e-6
# ResNet-50 (BASELINE config 2): bench.py's batch and optimizer
# (bench_resnet50: B=128, 224x224, Momentum(0.1, 0.9) under decorate)
RN_B, RN_HW, RN_STEPS, RN_LR, RN_MU = 128, 224, 5, 0.1, 0.9
# the first step's loss under bf16 AMP against the same step in float32
# from a copy of the same scope, relative: every conv rounds its output
# to bf16 (2^-9 relative) through 53 layers; at depth 18 on the CPU the
# two packages' bf16 first-step losses are 0.8 % and 1.3 % from float32
# (tests/test_torch_resnet.py's sizes), and full width and B=128 average
# more values a statistic
RN_AMP_LOSS_RTOL = 2e-2
# the float32 NHWC step from the NCHW graph's weights against the NCHW
# step, relative: the same sums in another order (cuDNN picks other
# algorithms for the two layouts) through 53 convolutions and 53 batch
# norms; the CPU tests hold it to 1e-5 at depth 18
RN_NHWC_RTOL = 1e-4
# the plan cache A/B: turns of each mode and steps a turn
AB_TURNS, AB_STEPS = 4, 3
# dygraph (BASELINE config 5, bench.py's bench_dygraph): the captured
# ResNet-50 at B=128 under bf16 AMP, DY_STEPS steps, then the bench's
# windows of 10 and 20 steps; eager against captured in DY_TURNS turns of
# DY_TURN_STEPS steps each; the two compared bit for bit over
# DY_CMP_STEPS steps from one initial state in deterministic mode (the
# same kernels in the same order: the graph replays the kernels its
# capture launched, so the bound is 0)
DY_B, DY_STEPS, DY_TURNS, DY_TURN_STEPS, DY_CMP_STEPS = 128, 10, 3, 3, 5
# dygraph against graph-mode ResNet-50: the first loss in float32 at
# B=8, relative (the same lowerings on the same parameters and batch in
# deterministic mode: measured equal, held to float32 sums in another
# order)
DY_GRAPH_B, DY_GRAPH_RTOL = 8, 1e-5
# eager dygraph Adam through the fused_adam kernel: B=32, 2 steps
DY_ADAM_B, DY_ADAM_STEPS, DY_ADAM_LR = 32, 2, 1e-3
# CTR (BASELINE config 4): bench.py's bench_ctr (ctr_train(vocab_size=
# 1000001), AdagradOptimizer(0.01), B=4096, 26 slots, 13 dense features)
CTR_B, CTR_VOCAB, CTR_SLOTS, CTR_DENSE = 4096, 1000001, 26, 13
CTR_STEPS, CTR_LR = 10, 0.01
# Wide&Deep with is_sparse=True against the dense default, from copies of
# one initial scope. The first loss is the same forward on the same
# parameters: to CTR_LOSS_RTOL. After 3 steps the parameters: the sparse
# path merges duplicate ids with one scatter-add and the dense one adds
# them into the table with another, in orders the card's atomics leave
# open, so the two differ in the last bits of those rows' gradients and,
# from step 2, of every activation. Each element to CTR_RTOL/CTR_ATOL,
# but where every gradient it saw stayed below CTR_TINY_G (its Adagrad
# moment below CTR_TINY_G^2): there Adagrad's update lr*g/(|g| + 1e-6)
# multiplies the absolute rounding of a cancelling gradient by up to 2500,
# and such elements are held to CTR_TINY_G_ATOL, a hundredth of one step's
# move (tests/test_torch_ctr.py holds the port to the JAX package on the
# CPU the same way)
CTR_LOSS_RTOL = 1e-6
CTR_RTOL = CTR_ATOL = 1e-5
CTR_TINY_G, CTR_TINY_G_ATOL = 1e-4, 1e-4
# Wide&Deep dense against sparse in turns: turns, and steps a turn
CTR_AB_TURNS, CTR_AB_STEPS = 6, 5
# the graph capture phase: captured and eager runs in CAP_TURNS turns of
# CAP_TURN_STEPS runs each; CAP_CMP_STEPS captured runs (after the plan's
# first, eager, run) against as many eager ones from one state, bit for
# bit (the graph replays the kernels its capture launched, on the same
# inputs, with the same random words: the bound is 0)
CAP_TURNS, CAP_TURN_STEPS, CAP_CMP_STEPS = 3, 3, 5


def _require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _peaks(name):
    for key in ("PCIe", "NVL"):
        if key in name:
            return _PEAKS[key]
    return _PEAKS["SXM"]   # "H100 80GB HBM3" is the SXM part


def _time_ms(fn, iters=30, warmup=3):
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


def _queued_ms(torch, fn, iters=10):
    """Device time per call of fn from CUDA events around `iters` calls
    queued behind torch.cuda._sleep (about 50 ms of the card's time, in
    which the host queues them), so the card runs them back to back
    whatever the host takes a call: a check on the profiler's reading,
    printed beside it. Returns (ms a call, host ms to queue them)."""
    return _queued_inside(torch, fn, "", iters, 100_000_000, False)[:2]


def _attn_inputs(torch, dev, dtype, layout, B, H, Sq, Sk, D, bias_kind,
                 pad_all=False, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def t(S):
        shape = (B, S, H, D) if layout == "bshd" else (B, H, S, D)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q, k, v = t(Sq), t(Sk), t(Sk)
    if bias_kind == "key_pad":
        lens = torch.randint(1, Sk + 1, (B,), generator=g, device=dev)
        lens[0] = Sk
        if pad_all:
            lens[-1] = 0          # every key of the last row padded
        keep = torch.arange(Sk, device=dev)[None, :] < lens[:, None]
        bias = torch.where(keep, 0.0, -1e9)[:, None, None, :].float()
    elif bias_kind == "per_head":
        bias = torch.randn((B, H, Sq, Sk), generator=g, device=dev)
    else:
        bias = None
    return q, k, v, bias


# (name, layout, B, H, Sq, Sk, D, bias, causal, pad_all)
_CASES = [
    ("bshd key-padding bias", "bshd", 4, 8, 256, 256, 64, "key_pad",
     False, False),
    ("bshd causal + bias", "bshd", 4, 8, 256, 256, 64, "key_pad", True,
     False),
    ("cross Sq != Sk", "bshd", 4, 8, 192, 256, 64, "key_pad", False,
     False),
    ("bhsd per-head bias", "bhsd", 2, 8, 128, 160, 64, "per_head", True,
     False),
    ("ragged S=77, D=96", "bshd", 3, 4, 77, 77, 96, "key_pad", True,
     False),
    ("no bias, ragged S=77", "bhsd", 3, 4, 77, 77, 64, "none", False,
     False),
    ("ragged Sq=50 Sk=130, D=128", "bhsd", 2, 3, 50, 130, 128, "key_pad",
     False, False),
    ("rows with all keys padded", "bshd", 4, 8, 128, 128, 64, "key_pad",
     False, True),
    ("serving shape", "bshd", 32, 8, 256, 256, 64, "key_pad", False,
     False),
    ("serving shape, causal", "bshd", 32, 8, 256, 256, 64, "key_pad",
     True, False),
    ("training shape", "bshd", TRAIN_B, 8, TRAIN_S, TRAIN_S, 64, "key_pad",
     False, False),
    ("training shape, causal", "bshd", TRAIN_B, 8, TRAIN_S, TRAIN_S, 64,
     "key_pad", True, False),
    # head dims above 128 take the CUDA-core kernels in both dtypes;
    # above 256 in 256-column groups of the output
    ("head dim 256, causal", "bshd", 2, 4, 128, 128, 256, "key_pad", True,
     False),
    ("head dim 192, Sq != Sk", "bhsd", 2, 4, 96, 160, 192, "per_head",
     False, False),
    ("head dim 264, causal", "bshd", 2, 4, 96, 80, 264, "key_pad", True,
     False),
    ("head dim 320, Sq != Sk", "bhsd", 2, 2, 77, 130, 320, "per_head",
     False, False),
    ("head dim 512", "bshd", 2, 2, 64, 64, 512, "key_pad", False, False),
]
# attention dropout: (seed word 0, seed word 1, keep threshold t);
# t = 230 is dropout 0.1, the training path's
_DROPOUTS = [(0x12345678, 0x9ABCDEF0, 230), (7, 11, 128)]


def _close(torch, got, ref, tol):
    """(max |err|, ok) of got against ref at tolerance tol, relative and
    absolute."""
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= tol + tol * ref.float().abs()).all()
              and torch.isfinite(got.float()).all())
    return err.max().item(), ok


def _dname(torch, dtype):
    return str(dtype).replace("torch.", "")


@contextlib.contextmanager
def _cuda_core_kernels(fa):
    """While it lasts, every attention call takes the CUDA-core kernels
    (the wrappers' choice, _sm90_eligible, reads False): to check and
    time that design on bf16 calls the tensor-core one would take."""
    eligible = fa._sm90_eligible
    fa._sm90_eligible = lambda *args: False
    try:
        yield
    finally:
        fa._sm90_eligible = eligible


def _bound_check(torch, fa, got, q, k, v, bias, out, lse, g, scale, causal,
                 layout, drop):
    """{grad: (max |err - bound| excess, max |err|)} of bf16 dq, dk, dv
    against flash_attention.bf16_backward_bound: what a correct bf16
    kernel meets where a row's keys are all padded (p = 1 on every key,
    |ds| in the tens)."""
    exact, bound = fa.bf16_backward_bound(q, k, v, bias, out, lse, g, scale,
                                          causal, layout, drop)
    res = {}
    for name, a, e, b in zip(("dq", "dk", "dv"), got, exact, bound):
        err = (a.double() - e).abs()
        res[name] = ((err - b).max().item(), err.max().item())
    return res


def kernel_phase(torch, dev):
    """Every attention kernel against its plain version over the case
    list, without and with dropout: float32 through the tensor-core
    (3xTF32) forward and the CUDA-core backward kernels, bf16 through
    the tensor-core forward, dq and dk/dv kernels (the wrappers' choice,
    checked by the launch counters), and both again through the
    CUDA-core ones; head dims above 128 through the CUDA-core kernels in
    both dtypes. bf16 gradients of the case whose rows have all keys
    padded are held to flash_attention.bf16_backward_bound, those above
    D = 256 to it and to BF16_TOL, the rest to BF16_TOL. Then one call
    under PT_KERNEL_DENY=flash_attention launches nothing. Returns
    {(kernel, dtype, case): max |err|}."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import registry as kreg
    worst = {}
    for dtype, tol, btol in ((torch.float32, F32_TOL, BWD_F32_TOL),
                             (torch.bfloat16, BF16_TOL, BF16_TOL)):
        dname = _dname(torch, dtype)
        for (name, layout, B, H, Sq, Sk, D, bias_kind, causal,
             pad_all) in _CASES:
            q, k, v, bias = _attn_inputs(torch, dev, dtype, layout, B, H,
                                         Sq, Sk, D, bias_kind, pad_all)
            eligible = fa._sm90_eligible(q, k, v, q, layout)
            designs = ("sm90", "simt") if eligible else ("simt",)
            scale = D ** -0.5
            want_dbias = bias_kind == "per_head"
            bounded = dtype == torch.bfloat16 and pad_all
            # bf16 above D = 256: BF16_TOL and the bound, both
            also_bound = dtype == torch.bfloat16 and D > 256
            for drop in [None] + _DROPOUTS:
                tag = "" if drop is None else f" drop t={drop[2]}"
                ref, ref_lse = fa.fused_attention_plain(
                    q, k, v, bias, scale, causal, layout, return_lse=True,
                    dropout=drop)
                g = torch.randn(q.shape, device=dev,
                                generator=torch.Generator(device=dev)
                                .manual_seed(3)).to(dtype)
                exp = fa.fused_attention_backward_plain(
                    q, k, v, bias, ref, ref_lse, g, scale, causal, layout,
                    dropout=drop, want_dbias=want_dbias)
                for design in designs:
                    kreg.reset_counts()
                    # the entry points, as the main path calls them
                    with (_cuda_core_kernels(fa) if design == "simt"
                          else contextlib.nullcontext()):
                        out, lse = fa.fused_attention_forward(
                            q, k, v, bias, scale, causal, layout,
                            return_lse=True, dropout=drop)
                        got = fa.fused_attention_backward(
                            q, k, v, bias, ref, ref_lse, g, scale, causal,
                            layout, dropout=drop, want_dbias=want_dbias)
                    torch.cuda.synchronize()
                    # bf16: the three tensor-core kernels; float32: the
                    # tensor-core forward, the CUDA-core backward
                    sm90 = design == "sm90"
                    bf = sm90 and dtype == torch.bfloat16
                    fwd_k = "flash_attention_fwd" + (
                        "" if not sm90 else "_sm90" if bf else "_f32_sm90")
                    dq_k = "flash_attention_bwd_dq" + ("_sm90" if bf
                                                       else "")
                    dkv_k = "flash_attention_bwd_dkv" + ("_sm90" if bf
                                                         else "")
                    want = {n: 0 for n in kreg.launches()}
                    for n in ("flash_attention_fwd", fwd_k,
                              "flash_attention_bwd_dq", dq_k,
                              "flash_attention_bwd_dkv", dkv_k):
                        want[n] = 1
                    c = kreg.launches()
                    _require(c == want, f"{dname} {name}{tag}: launches "
                                        f"{c}, want the {design} kernels")
                    err, ok = _close(torch, out, ref, tol)
                    lerr, lok = _close(torch, lse, ref_lse, tol)
                    print(f"  fwd vs plain [{dname:8s} {design:4s}] "
                          f"{name + tag:36s} out max|err|={err:.3e} lse "
                          f"max|err|={lerr:.3e} tol={tol:g} "
                          f"{'ok' if ok and lok else 'FAIL'}")
                    _require(ok and lok, f"{fwd_k} {dname} {name}{tag} "
                                         f"disagrees with its plain version")
                    worst[(fwd_k, dname, name + tag)] = err
                    errs = {}
                    for gname, a, r in zip(("dq", "dk", "dv", "dbias"), got,
                                           exp):
                        if r is None:
                            continue
                        errs[gname], ok = _close(torch, a, r, btol)
                        ok = (ok or (bounded and gname != "dbias")) and \
                            r.abs().max().item() > 0   # not vacuous
                        _require(ok, f"flash attention backward {gname} "
                                     f"{dname} {design} {name}{tag} "
                                     f"disagrees with its plain version")
                    line = " ".join(f"{k}={e:.3e}" for k, e in errs.items())
                    if bounded or also_bound:
                        bd = _bound_check(torch, fa, got, q, k, v, bias, ref,
                                          ref_lse, g, scale, causal, layout,
                                          drop)
                        for gname, (excess, e) in bd.items():
                            _require(excess <= 0,
                                     f"{gname} {design} {name}{tag} is "
                                     f"beyond the bf16 bound by {excess:.3e}")
                        line += " (vs exact: " + " ".join(
                            f"{k}={e:.3e} bound-excess={x:.2e}"
                            for k, (x, e) in bd.items()) + (
                            "; bf16_backward_bound, not BF16_TOL)"
                            if bounded else f"; and tol={btol:g})")
                    else:
                        line += f" tol={btol:g}"
                    print(f"  bwd vs plain [{dname:8s} {design:4s}] "
                          f"{name + tag:36s} {line} ok")
                    worst[(dq_k, dname, name + tag)] = errs["dq"]
                    worst[(dkv_k, dname, name + tag)] = \
                        max(errs["dk"], errs["dv"])
    # the registry's deny list: the plain version, no launch
    os.environ["PT_KERNEL_DENY"] = "flash_attention"
    try:
        q, k, v, bias = _attn_inputs(torch, dev, torch.bfloat16, "bshd", 2,
                                     8, 128, 128, 64, "key_pad")
        kreg.reset_counts()
        kreg.reset_stats()
        out, lse = fa.fused_attention_forward(q, k, v, bias, 0.125, False,
                                              "bshd", return_lse=True)
        fa.fused_attention_backward(q, k, v, bias, out, lse, out, 0.125,
                                    False, "bshd")
        torch.cuda.synchronize()
        stats = kreg.dispatch_stats()["per_kernel"]
        print(f"  PT_KERNEL_DENY=flash_attention: launches "
              f"{sum(kreg.launches().values())}, decisions {stats}")
        _require(not any(kreg.launches().values()) and stats == {
            "flash_attention": {"denied": 2}},
            "a denied attention call launched a kernel")
    finally:
        os.environ.pop("PT_KERNEL_DENY", None)
        kreg.reset_stats()
    return worst


def _ulps(torch, a, b):
    """Distance in units in the last place between float32 tensors."""
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


def _adam_state(torch, dev, n, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    p = torch.randn(n, device=dev, generator=g)
    grad = torch.randn(n, device=dev, generator=g) * 1e-2
    m = torch.randn(n, device=dev, generator=g) * 1e-3
    v = torch.rand(n, device=dev, generator=g) * 1e-5
    return p, grad, m, v


def _lr_t(torch, dev, step=3):
    return torch.tensor([LR * (1 - 0.999 ** step) ** 0.5
                         / (1 - 0.9 ** step)], device=dev)


def _adam_list(torch, dev, sizes, seed, offset=0):
    """Per tensor (p, g, m, v) of the given lengths, views `offset`
    elements past the start of their buffers, and each tensor's beta
    powers (steps 1 to 8, one float32 each on the card)."""
    state, b1ps, b2ps = [], [], []
    for i, n in enumerate(sizes):
        ts = _adam_state(torch, dev, n + offset, seed + i)
        state.append([t[offset:] for t in ts])
        step = i % 8 + 1
        b1ps.append(torch.tensor([0.9 ** step], device=dev))
        b2ps.append(torch.tensor([0.999 ** step], device=dev))
    return state, b1ps, b2ps


def _adam_list_ulp(torch, dev, label, sizes, seed, offset=0, wd=0.0,
                   steps=3, launches=1):
    """fused_adam_multi over one list, `steps` consecutive steps (each
    from the previous one's outputs, the beta powers included) against
    adam_multi_plain on copies: the worst ulp and |err| over p, m, v and
    the beta powers, and the launches each step reported."""
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    from paddle_tpu_torch.kernels import registry as kreg
    state, b1, b2 = _adam_list(torch, dev, sizes, seed, offset)
    ps, gs, ms, vs = (list(c) for c in zip(*state))
    rp, rm, rv = ([t.clone() for t in c] for c in (ps, ms, vs))
    r1, r2 = b1, b2
    lr = torch.tensor([LR], device=dev)
    ulp, err = 0, 0.0
    for _ in range(steps):
        ref = fo.adam_multi_plain(rp, gs, rm, rv, lr, r1, r2, 0.9, 0.999,
                                  1e-8, wd)
        kreg.reset_counts()
        got = fo.fused_adam_multi(ps, gs, ms, vs, lr, b1, b2, 0.9, 0.999,
                                  1e-8, wd)
        torch.cuda.synchronize()
        n_launch = kreg.launches()["fused_adam"]
        _require(n_launch == launches, f"fused_adam_multi ({label}): "
                                       f"{n_launch} launches, want "
                                       f"{launches}")
        for a, r in zip(got, ref):
            for x, y in zip(a, r):
                if x.numel():
                    ulp = max(ulp, int(_ulps(torch, x, y).max()))
                    err = max(err, (x - y).abs().max().item())
        rp, rm, rv, r1, r2 = ref
        ps, ms, vs, b1, b2 = got     # on the card p, m and v themselves
    n = sum(int(x) for x in sizes)
    print(f"  adam list vs plain, {label} ({len(sizes)} tensors, {n} "
          f"elements, {launches} launch(es) a step, {steps} steps, "
          f"wd {wd:g}): max ulp {ulp} over p, m, v and the beta powers, "
          f"max|err| {err:.3e} (bound {ADAM_ULP} ulp) "
          f"{'ok' if ulp <= ADAM_ULP else 'FAIL'}")
    _require(ulp <= ADAM_ULP, f"fused_adam_multi ({label}) is {ulp} ulp "
                              f"from its plain version")
    return err, ulp


def adam_phase(torch, dev, shapes):
    """The Adam kernel against its plain version, 0 ulp: the single entry
    (a list of one) on lengths that cut blocks and a Transformer-base
    embedding; the list entry over the parameter shapes the registry
    routes in Transformer-base (one launch), odd lengths, operands one
    element past a 16-byte boundary, and a list longer than one table
    (1100 tensors, three launches), several steps each, the beta powers
    and weight decay included. Returns the worst |err| and ulp
    distance."""
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    worst_err, worst_ulp = 0.0, 0
    lr_t = _lr_t(torch, dev)
    for n in (1, 511, 513, 262144, 16384000):
        p, g, m, v = _adam_state(torch, dev, n, n)
        ref = fo.adam_plain(p, g, m, v, lr_t[0], 0.9, 0.999, 1e-8)
        got = fo.fused_adam(p.clone(), g, m.clone(), v.clone(), lr_t)
        torch.cuda.synchronize()
        ulp = max(int(_ulps(torch, a, r).max()) for a, r in zip(got, ref))
        err = max((a - r).abs().max().item() for a, r in zip(got, ref))
        print(f"  adam vs plain n={n:9d}: max ulp {ulp}, max|err| "
              f"{err:.3e} (bound {ADAM_ULP} ulp) "
              f"{'ok' if ulp <= ADAM_ULP else 'FAIL'}")
        _require(ulp <= ADAM_ULP, f"fused_adam n={n} is {ulp} ulp from "
                                  f"its plain version")
        worst_err, worst_ulp = max(worst_err, err), max(worst_ulp, ulp)
    routed = [int(np.prod(sh)) for sh in _routed(shapes)[0]]
    odd = [1, 3, 4097, 65537]
    for label, sizes, offset, wd, launches in (
            (f"Transformer-base's {len(routed)} routed shapes", routed, 0,
             0.0, 1),
            ("lengths 1, 3, 4097, 65537", odd, 0, 0.0, 1),
            ("lengths 1, 3, 4097, 65537, weight decay", odd, 0, 0.01, 1),
            ("views 1 element past 16 bytes", odd + [513, 4096], 1, 0.0, 1),
            ("1100 tensors (512 a table)",
             [(i * 37) % 300 + 1 for i in range(1100)], 0, 0.0, 3)):
        err, ulp = _adam_list_ulp(torch, dev, label, sizes, len(sizes),
                                  offset, wd, 3, launches)
        worst_err, worst_ulp = max(worst_err, err), max(worst_ulp, ulp)
    return worst_err, worst_ulp


def time_attention(torch, dev, card, baseline=None):
    """The float32 forward at the serving shape (the main path of
    float32 attention) in both designs: the tensor-core (3xTF32) kernel
    the entry point takes and the CUDA-core one (_cuda_core_kernels),
    their plain version and sdpa, and the bound of each design's work:
    3xTF32 at the TF32 peak, float32 FMA at the float32 peak. With
    `baseline` (an earlier checkout) its CUDA-core forward too, in turns
    with this one's (baseline, this, this, baseline), its output against
    this one's. Kernel and library times are device time
    (torch.profiler); the plain version's and the kernels' events figure
    the host's clock."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    peak_flops, _, peak_bw, _, peak_tf32 = _peaks(card)
    B, H, S, D = 32, 8, 256, 64
    q, k, v, bias = _attn_inputs(torch, dev, torch.float32, "bshd", B, H,
                                 S, S, D, "key_pad", seed=7)
    scale = D ** -0.5
    nbytes = 4 * q.numel() * 4 + bias.numel() * 4
    res = {}
    for causal in (False, True):
        def fwd(causal=causal):
            return fa.fused_attention_forward(q, k, v, bias, scale, causal,
                                              "bshd")

        tc = _device_ms(torch, fwd, 20, ("fa_fwd_f32_sm90_kernel",))[
            "fa_fwd_f32_sm90_kernel"]
        tc_ev = _time_ms(fwd)
        tc_q, tc_host = _queued_ms(torch, fwd)
        simt = ("fa_fwd_kernel",)
        with _cuda_core_kernels(fa):
            if baseline:
                base = _baseline_fwd(torch, fa, baseline, q, k, v, bias,
                                     scale, causal)
                _require(torch.equal(base(), fwd()),
                         "the baseline's CUDA-core forward disagrees")
                b1 = _device_ms(torch, base, 20, simt)[simt[0]]
            kern = _device_ms(torch, fwd, 20, simt)[simt[0]]
            kern_ev = _time_ms(fwd)
            if baseline:
                kern = (kern + _device_ms(torch, fwd, 20, simt)[simt[0]]) / 2
                base_ms = (b1 + _device_ms(torch, base, 20, simt)[simt[0]]) / 2
                print(f"    CUDA-core forward, the baseline checkout's "
                      f"{base_ms:.4f} ms against this one's {kern:.4f} ms "
                      f"(in turns; equal outputs)")
        plain = _time_ms(lambda: fa.fused_attention_plain(
            q, k, v, bias, scale, causal, "bshd"))
        pairs = S * (S + 1) // 2 if causal else S * S
        flops = 4 * B * H * pairs * D
        lib = None
        if not causal:   # sdpa takes no mask together with is_causal
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = _call_device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=bias, scale=scale), 20)
        bound, by = _bound(flops, nbytes, peak_flops, peak_bw)
        tc_bound, tc_by = _bound(3 * flops, nbytes, peak_tf32, peak_bw)
        common = {"plain_ms": plain, "library_ms": lib,
                  "gflop": flops / 1e9, "mb": nbytes / 1e6}
        res[causal] = {"ms": kern, "bound_ms": bound, "bound_by": by,
                       **common}
        if baseline:
            res[causal]["baseline_ms"] = base_ms
        res[("f32_sm90", causal)] = {"ms": tc, "bound_ms": tc_bound,
                                     "bound_by": tc_by, **common}
        print(f"  float32 forward B={B} S={S} H={H} D={D} causal={causal}: "
              f"tensor-core (3xTF32) kernel {tc:.4f} ms (device; events "
              f"{tc_ev:.4f} ms; queued events {tc_q:.4f} ms, host "
              f"{tc_host:.1f} ms to queue 10), bound {tc_bound:.4f} ms ({tc_by}: "
              f"{3 * flops / 1e9:.3f} GFLOP of TF32 at "
              f"{peak_tf32 / 1e12:g} TFLOP/s); CUDA-core kernel "
              f"{kern:.4f} ms (device; events {kern_ev:.4f} ms), bound "
              f"{bound:.4f} ms ({by}: {flops / 1e9:.3f} GFLOP at "
              f"{peak_flops / 1e12:g} TFLOP/s fp32); {nbytes / 1e6:.1f} MB "
              f"at {peak_bw / 1e12:g} TB/s; plain {plain:.4f} ms (events), "
              f"sdpa {'n/a' if lib is None else f'{lib:.4f} ms'}")
    return res


def _baseline_fwd(torch, fa, baseline, q, k, v, bias, scale, causal):
    """A call of the CUDA-core forward of an earlier checkout (its
    flash_attention_fwd.cu, the same C interface) on these bshd inputs,
    returning out."""
    import ctypes
    fn = fa._bind(_baseline_lib(baseline, "flash_attention_fwd.cu"),
                  "pt_flash_attention_fwd")
    B, S, H, D = q.shape

    def call():
        out = torch.empty_like(q)
        strides = (ctypes.c_int64 * 15)(
            *(st for x in (q, k, v, out)
              for st in fa._seq_strides(x, "bshd")), *fa._bias_strides(bias))
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), None, 0, B, H, S, k.shape[1], D, strides,
                 float(scale), int(causal), 0, 0, 0,
                 torch.cuda.current_stream().cuda_stream)
        _require(err == 0, f"baseline flash_attention_fwd failed: {err}")
        return out
    return call


def _baseline_sgd(torch, baseline, pairs, lr):
    """One SGD step of an earlier checkout over (p, g) pairs: its
    fused_optimizer.cu's single-tensor pt_fused_sgd, one launch a
    parameter (the design before the multi-tensor launch); None where
    the checkout has none (its SGD is this one's list launch)."""
    import ctypes
    lib = _baseline_lib(baseline, "fused_optimizer.cu")
    if not hasattr(lib, "pt_fused_sgd"):
        return None           # the baseline has this checkout's design
    fn = lib.pt_fused_sgd
    P = ctypes.c_void_p
    fn.argtypes = [P, P, P, ctypes.c_int64, ctypes.c_float, P]
    fn.restype = ctypes.c_int

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        for p, g in pairs:
            err = fn(p.data_ptr(), g.data_ptr(), lr.data_ptr(), p.numel(),
                     0.0, stream)
            _require(err == 0, f"baseline fused_sgd failed: {err}")
    return call


def _build_ctr(pt, kind, optimizer=None):
    """bench.py's CTR training program (bench_ctr): kind "wide_deep" or
    "deepfm" is ctr_train(kind, vocab_size=1000001); "sparse" is
    Wide&Deep with is_sparse=True and ctr_train's loss, as a user builds
    it; "padded" looks a sparse [1000001, 16] table up with padding_idx
    0 into one fc. Minimized by AdagradOptimizer(0.01), or `optimizer`.
    Returns (main, startup, cost, feed names)."""
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        if kind in ("wide_deep", "deepfm"):
            cost, _, feeds = pt.models.ctr_train(kind, vocab_size=CTR_VOCAB)
        else:
            L = pt.layers
            slots = L.data("slot_ids", [-1, CTR_SLOTS],
                           append_batch_size=False, dtype="int32")
            dense = L.data("dense_feat", [-1, CTR_DENSE],
                           append_batch_size=False, dtype="float32")
            label = L.data("ctr_label", [-1, 1], append_batch_size=False,
                           dtype="float32")
            feeds = ["slot_ids", "dense_feat", "ctr_label"]
            if kind == "sparse":
                logit = pt.models.wide_deep.wide_deep(
                    slots, dense, CTR_VOCAB, 16, is_sparse=True)
            else:
                emb = L.embedding(slots, [CTR_VOCAB, 16], is_sparse=True,
                                  padding_idx=0,
                                  param_attr=pt.ParamAttr(name="pad_emb.w_0"))
                logit = L.fc(L.concat([L.flatten(emb), dense], axis=1), 1)
            cost = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
            L.sigmoid(logit)                  # ctr_train's probability
        (optimizer or pt.optimizer.AdagradOptimizer(CTR_LR)).minimize(cost)
    main.random_seed = startup.random_seed = SEED
    return main, startup, cost, feeds


def _ctr_feed(feeds):
    """bench.py's batch (RandomState(0): slot ids in [0, 1000001), rand
    dense features, 0/1 labels) at B=4096, the named feeds of it."""
    rng = np.random.RandomState(0)
    batch = {
        "slot_ids": rng.randint(0, CTR_VOCAB,
                                (CTR_B, CTR_SLOTS)).astype(np.int32),
        "dense_feat": rng.rand(CTR_B, CTR_DENSE).astype(np.float32),
        "ctr_label": rng.randint(0, 2, (CTR_B, 1)).astype(np.float32)}
    return {k: batch[k] for k in feeds}


@contextlib.contextmanager
def _sync_checked(torch, op_types):
    """Each lowering of `op_types` (a group lowering too) runs under
    torch.cuda.set_sync_debug_mode("error"): one that blocks the host
    until the card drains raises. Yields the count of lowerings run so."""
    import functools
    from paddle_tpu_torch.core.registry import OPS
    ran = {"lowerings": 0}

    def checked(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            old = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(old)
                ran["lowerings"] += 1
        return wrapper

    saved = [(OPS.get(t), OPS.get(t).lowering, OPS.get(t)._group)
             for t in op_types]
    for info, lowering, group in saved:
        info.lowering = checked(lowering)
        if group is not None:   # the plans' spans stand: no new plan
            info._group = (group[0], checked(group[1]))
    try:
        yield ran
    finally:
        for info, lowering, group in saved:
            info.lowering, info._group = lowering, group


# the op types of the sparse updates: their lowerings must not sync
_SPARSE_OPS = ("lookup_table_grad", "sum", "scale", "sgd", "momentum",
               "adagrad", "adam")


def _ctr_run(torch, pt, kreg, label, main, cost, feed, scope, exe,
             sync_check=False):
    """CTR_STEPS steps through Executor.run on the card; prints the
    losses, the step seconds (each ends at the fetched loss),
    examples/s, peak memory and the device-busy share of one profiled
    step after them; requires finite, distinct losses and no launch of
    the port's kernels. sync_check: then one more step with the sparse
    lowerings under sync debug mode "error" (the fetch outside it).
    Returns the losses and the parameters and moments after 3 steps
    (host copies)."""
    params = [p.name for p in main.all_parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kreg.reset_counts()
    losses, secs, after3 = [], [], None
    for step in range(CTR_STEPS):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main, feed=feed, fetch_list=[cost],
                                    scope=scope)[0]))
        secs.append(time.perf_counter() - t0)
        if step == 2:
            after3 = {n: scope.find_var(n).get_tensor().tensor.to(
                "cpu", copy=True)
                for n in params + [n + "_moment_0" for n in params]}
    launches = kreg.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady = secs[1:]
    print(f"  {label}: losses {', '.join(f'{x:.6f}' for x in losses)}")
    print(f"  {label}: step seconds {', '.join(f'{x:.4f}' for x in secs)} "
          f"(first includes warm-up); examples/s (steps 2-{CTR_STEPS}, "
          f"fetch included) {CTR_B * len(steady) / sum(steady):.1f}; peak "
          f"memory allocated {peak_gb:.3f} GB")
    _require(all(np.isfinite(losses)) and
             len(set(losses)) == len(losses),
             f"{label}: the losses are not finite and pairwise distinct")
    _require(not any(launches.values()),
             f"{label}: the CTR path launched {launches}")
    if sync_check:
        # op by op (use_program_cache=False): a captured block replays
        # without running its lowerings (its capture ran them under the
        # same mode)
        with _sync_checked(torch, _SPARSE_OPS) as ran:
            out = exe.run(main, feed=feed, fetch_list=[cost], scope=scope,
                          return_numpy=False, use_program_cache=False)[0]
        print(f"  {label}: one more step, {ran['lowerings']} sparse-path "
              f"lowerings under sync debug mode 'error', loss "
              f"{float(out):.6f}")
        _require(ran["lowerings"] >= 2,
                 f"{label}: no sparse lowering ran under the sync check")
    busy = profile_step(torch, exe, main, feed, cost, scope, kernel=None)
    print(f"  {label}: device busy share of a profiled step "
          f"{100 * busy:.1f} %")
    host_profile(torch, label, exe, scope, main, cost, feed)
    return losses, after3


def _ctr_compare(torch, dense, sparse):
    """Dense against sparse Wide&Deep after 3 steps: the largest
    elementwise difference of each parameter over its bound (CTR_RTOL /
    CTR_ATOL, CTR_TINY_G_ATOL where every gradient stayed below
    CTR_TINY_G)."""
    worst, tiny = 0.0, 0
    for n, d in dense.items():
        if n.endswith("_moment_0"):
            continue
        s = sparse[n]
        small = dense[n + "_moment_0"] < CTR_TINY_G ** 2
        atol = torch.where(small, CTR_TINY_G_ATOL, CTR_ATOL)
        ratio = ((s - d).abs() / (atol + CTR_RTOL * d.abs())).max().item()
        worst = max(worst, ratio)
        tiny += int(small.sum())
    return worst, tiny


def ctr_phase(torch, dev):
    """Wide&Deep (dense embedding gradients, the bench default), Wide&Deep
    with is_sparse=True and DeepFM at vocab 1000001, B=4096, CTR_STEPS
    Adagrad steps each through Executor.run on the card; the sparse
    run's sparse lowerings under sync debug mode "error"; dense against
    sparse from copies of one initial scope; then the padded program
    (padding_idx and duplicate ids) with each optimizer's sparse
    update, 2 steps under the sync check: no device-side assert, the
    padding row and the rows never looked up unchanged. Between them,
    the device time of the embedding table's update on each path
    (ctr_update_times)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg

    t0 = time.perf_counter()
    runs, init = {}, None
    for label, kind in (("Wide&Deep dense", "wide_deep"),
                        ("Wide&Deep sparse", "sparse"),
                        ("DeepFM dense", "deepfm")):
        main, startup, cost, feeds = _build_ctr(pt, kind)
        types = [op.type for op in main.global_block().ops]
        print(f"  {label}: {len(types)} ops ({types.count('adagrad')} "
              f"adagrad, {types.count('mul')} mul), "
              f"{len(startup.global_block().ops)} startup ops")
        _require((len(types), len(startup.global_block().ops)) ==
                 ((58, 17) if kind == "deepfm" else (55, 23)),
                 f"{label}: not the JAX package's program")
        # an Executor a run: its plans hold their scope, and each run's
        # peak memory is its own
        exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
        if kind == "sparse":    # the dense run's initial scope
            for n, t in init.items():
                scope.var(n).get_tensor().set_tensor(t.to(dev))
            init = None
        else:
            exe.run(startup, scope=scope)
            if kind == "wide_deep":
                init = {n: v.get_tensor().tensor.to("cpu", copy=True)
                        for n, v in scope._vars.items()}
        runs[label] = _ctr_run(torch, pt, kreg, label, main, cost,
                               _ctr_feed(feeds), scope, exe,
                               sync_check=kind == "sparse")
        del exe, scope
        torch.cuda.empty_cache()
        if kind == "sparse":
            (ld, pd), (ls, ps) = (runs.pop("Wide&Deep dense"),
                                  runs.pop("Wide&Deep sparse"))
            e_loss = abs(ls[0] - ld[0]) / abs(ld[0])
            worst, tiny = _ctr_compare(torch, pd, ps)
            print(f"  Wide&Deep sparse against dense: first loss rel err "
                  f"{e_loss:.3e} (bound {CTR_LOSS_RTOL:g}); parameters "
                  f"after 3 steps: largest |diff| over its bound "
                  f"{worst:.3f} ({tiny} elements whose gradients stayed "
                  f"below {CTR_TINY_G:g} held to {CTR_TINY_G_ATOL:g}, the "
                  f"rest to {CTR_ATOL:g})")
            _require(e_loss <= CTR_LOSS_RTOL and worst <= 1.0,
                     "sparse Wide&Deep disagrees with dense")
            del pd, ps
    ctr_ab(torch, pt)
    ctr_update_times(torch, dev)

    # padding_idx and duplicate ids through each optimizer's sparse update
    rng = np.random.RandomState(1)
    for name, opt in (("sgd", pt.optimizer.SGD(CTR_LR)),
                      ("momentum", pt.optimizer.Momentum(CTR_LR, 0.9)),
                      ("adagrad", pt.optimizer.Adagrad(CTR_LR)),
                      ("adam", pt.optimizer.Adam(CTR_LR))):
        main, startup, cost, feeds = _build_ctr(pt, "padded", opt)
        exe = pt.Executor(pt.CUDAPlace(0))
        feed = _ctr_feed(feeds)
        ids = feed["slot_ids"]
        ids[::3, 0] = 0                        # padding_idx
        ids[:, 1] = ids[:, 2]                  # duplicates
        ids[rng.rand(*ids.shape) < 0.1] = 7    # a row hit ~10,000 times
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        table = scope.find_var("pad_emb.w_0").get_tensor()
        before = table.tensor.clone()
        with _sync_checked(torch, _SPARSE_OPS) as ran:
            losses = [exe.run(main, feed=feed, fetch_list=[cost],
                              scope=scope, return_numpy=False)[0]
                      for _ in range(2)]
        losses = [float(x) for x in losses]
        torch.cuda.synchronize()               # a device assert raises
        untouched = torch.ones(CTR_VOCAB, dtype=torch.bool, device=dev)
        untouched[torch.from_numpy(ids.reshape(-1).astype(np.int64))
                  .to(dev)] = False
        untouched[0] = True
        moved = (table.tensor - before).abs().amax(dim=1)
        still = moved[untouched].max().item()
        touched = moved[~untouched].min().item()
        print(f"  padded {name}: losses {losses[0]:.6f}, {losses[1]:.6f}; "
              f"{ran['lowerings']} sparse-path lowerings under sync debug "
              f"mode 'error'; padding row and {int(untouched.sum()) - 1} "
              f"rows never looked up: max|change| {still:.3e}; looked-up "
              f"rows: min max|change| {touched:.3e}")
        _require(all(np.isfinite(losses)) and losses[0] != losses[1],
                 f"padded {name}: losses {losses}")
        _require(still == 0.0 and touched > 0.0 and ran["lowerings"] >= 2,
                 f"padded {name}: parked rows moved or looked-up rows did "
                 f"not")
        del exe, scope, table, before
    torch.cuda.empty_cache()
    print(f"  CTR phase: {time.perf_counter() - t0:.1f} s")


def ctr_ab(torch, pt):
    """Wide&Deep with dense and with sparse embedding gradients in turns
    (dense first in even turns, sparse first in odd ones), each from a
    copy of one initial scope on its own Executor: examples/s of each
    turn of CTR_AB_STEPS steps, each step ending at its fetched loss. The
    host's clock drifts through a long process, so only turns compare."""
    built = {k: _build_ctr(pt, k) for k in ("wide_deep", "sparse")}
    init = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(built["wide_deep"][1], scope=init)
    runs = {}
    for k, (main, _, cost, feeds) in built.items():
        runs[k] = (pt.Executor(pt.CUDAPlace(0)),
                   _copy_scope(pt, init, list(init._vars)), main, cost,
                   _ctr_feed(feeds))
    del init
    for exe, scope, main, cost, feed in runs.values():   # plans built
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    rates = {k: [] for k in runs}
    for turn in range(CTR_AB_TURNS):
        for k in sorted(runs, reverse=turn % 2 == 1):
            exe, scope, main, cost, feed = runs[k]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CTR_AB_STEPS):
                loss = float(exe.run(main, feed=feed, fetch_list=[cost],
                                     scope=scope)[0])
            rates[k].append(CTR_B * CTR_AB_STEPS /
                            (time.perf_counter() - t0))
            _require(np.isfinite(loss), f"CTR A/B {k}: loss {loss}")
    for k, label in (("wide_deep", "dense"), ("sparse", "sparse")):
        print(f"  Wide&Deep {label} in turns ({CTR_AB_TURNS} x "
              f"{CTR_AB_STEPS} steps): examples/s "
              f"{', '.join(f'{r:.1f}' for r in rates[k])}; median "
              f"{float(np.median(rates[k])):.1f}")
    wins = sum(d > s for d, s in zip(rates["wide_deep"], rates["sparse"]))
    print(f"  dense read faster in {wins} of {CTR_AB_TURNS} turns")


def ctr_update_times(torch, dev, iters=20):
    """Device ms (CUDA events around `iters` calls, after 3) of the
    embedding table's gradient and Adagrad update at bench.py's shape
    (ids of a B=4096 x 26 batch into the [1000001, 16] table), through
    the ops' lowerings: dense (lookup_table_grad: a zero table and
    index_add_; adagrad over the whole table) and sparse
    (lookup_table_grad's SelectedRows; adagrad's merge, gathers and row
    writes), beside the byte bound of each at 3.35 TB/s: each input
    read once, each output written once."""
    from paddle_tpu_torch.core.registry import OPS, ExecContext, _SlotView
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, CTR_VOCAB, (CTR_B, CTR_SLOTS))
                           .astype(np.int32)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    g_out = 1e-4 * torch.randn(CTR_B, CTR_SLOTS, 16, device=dev,
                               generator=gen)
    w = 0.01 * torch.randn(CTR_VOCAB, 16, device=dev, generator=gen)
    m = torch.zeros_like(w)
    lr = torch.full((1,), CTR_LR, device=dev)

    def grad(sparse):
        env = {"w": w, "ids": ids, "g": g_out}
        view = _SlotView("lookup_table_grad",
                         {"W": ["w"], "Ids": ["ids"], "Out@GRAD": ["g"]},
                         {"W@GRAD": ["dw"]},
                         {"is_sparse": sparse, "padding_idx": -1})
        OPS.get("lookup_table_grad").lowering(ExecContext(view, env, dev))
        return env["dw"]

    def update(dw):
        env = {"p": w, "g": dw, "m": m, "lr": lr}
        view = _SlotView("adagrad", {"Param": ["p"], "Grad": ["g"],
                                     "Moment": ["m"], "LearningRate": ["lr"]},
                         {"ParamOut": ["p"], "MomentOut": ["m"]},
                         {"epsilon": 1e-6})
        OPS.get("adagrad").lowering(ExecContext(view, env, dev))

    def events_ms(fn):
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

    dense_g, sparse_g = grad(False), grad(True)
    n_ids, table = CTR_B * CTR_SLOTS, w.numel() * 4
    slices = n_ids * 16 * 4
    rows = [("dense grad (zero table, index_add_)", lambda: grad(False),
             table + slices + n_ids * 4),
            ("dense adagrad (whole table)", lambda: update(dense_g),
             5 * table),
            ("sparse grad (SelectedRows)", lambda: grad(True),
             slices + n_ids * 4),
            ("sparse adagrad (merge, gather, write rows)",
             lambda: update(sparse_g), slices + n_ids * 8 + 4 * slices)]
    for label, fn, nbytes in rows:
        ms = events_ms(fn)
        bound = nbytes / 3.35e12 * 1e3
        print(f"  table update, {label}: {ms:.4f} ms device (CUDA events); "
              f"byte bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB), "
              f"{ms / bound:.1f}x")
    # where the sparse update's device time goes, kernel by kernel
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        update(sparse_g)
        torch.cuda.synchronize()
    kernels = _kernels(prof)
    print(f"  sparse adagrad, one call: {len(kernels)} kernel names, "
          f"{sum(e.count for e in kernels)} launches, "
          f"{sum(e.self_device_time_total for e in kernels) / 1e3:.4f} ms "
          f"device (profiler)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.4f} ms x{e.count:<3d} "
              f"{e.key[:90]}")


def _kernels(prof):
    """The CUDA kernels' events of a profiler session, as torch's own
    tables sum them: without user annotations, which carry device time
    too (torch.optim's Optimizer.step#Adam.step range read as much as
    the kernels under it)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _device_ms(torch, fn, iters, keys):
    """Device time per call of fn, summed over the CUDA kernels whose
    name holds each key, from torch.profiler over `iters` calls: the
    median of three sessions that saw all of each key's kernels, all
    readings printed. On the card a session sometimes drops a kernel's
    events (a GEMM once read 0.0000 ms in two of three sessions, sdpa's
    forward and backward once half the others' time, torch.matmul once
    0.0234 against 0.0715), so a session counts for a key only where it
    saw as many of its kernels as the fullest session did (a reading of
    0 never counts), and up to eight are run to find three that do."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    reads = {k: [] for k in keys}      # (ms, kernels seen) a session

    def full(r):
        most = max(n for _, n in r)
        return [ms for ms, n in r if n == most and ms > 0]

    for _ in range(8):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        got = {k: [0.0, 0] for k in keys}
        for e in _kernels(prof):
            for k in keys:
                if k in e.key:
                    got[k][0] += e.self_device_time_total / 1e3 / iters
                    got[k][1] += e.count
        for k in keys:
            reads[k].append(tuple(got[k]))
        if all(len(full(r)) >= 3 for r in reads.values()):
            break
    print("    profiler sessions (ms): " + "; ".join(
        f"{k or 'every kernel'} " + ", ".join(f"{x:.4f}" for x, _ in r)
        for k, r in reads.items()))
    return {k: sorted(full(r))[len(full(r)) // 2] if full(r) else 0.0
            for k, r in reads.items()}


def _bound(flops, nbytes, peak_flops, peak_bw):
    t_f, t_b = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return max(t_f, t_b), "operations" if t_f >= t_b else "bytes"


def time_training_attention(torch, dev, card):
    """Forward (with dropout, returning lse) and backward kernels at the
    training shape in bf16, key-padding bias, without and with the
    causal mask, each attention kernel in both designs (tensor-core, the
    main path's, and CUDA-core; the CUDA-core dq with its di pre-pass, the
    tensor-core one with di fused in): kernel, plain and library times and the
    bounds. Kernel and library times are device time (torch.profiler):
    each kernel's own, and every CUDA kernel that sdpa launches; the
    events figures of earlier runs are printed on their own line."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    _, peak_bf16, peak_bw, _, _ = _peaks(card)
    B, H, S, D = TRAIN_B, 8, TRAIN_S, 64
    q, k, v, bias = _attn_inputs(torch, dev, torch.bfloat16, "bshd", B, H,
                                 S, S, D, "key_pad", seed=7)
    g = torch.randn(q.shape, device=dev).to(torch.bfloat16)
    drop = (0x2545F491, 0x9E3779B9, 230)
    scale = D ** -0.5
    el = q.numel()           # elements of each of q, k, v, out, dO
    rows = B * H * S         # lse and di
    res = {}
    for causal in (False, True):
        pairs = S * (S + 1) // 2 if causal else S * S
        mm = 2 * B * H * pairs * D       # one [S, S] x [S, D] product
        out, lse = fa.fused_attention_forward(q, k, v, bias, scale, causal,
                                              "bshd", return_lse=True,
                                              dropout=drop)
        t = {}
        for design, fkey, qkeys, dkey in (
                ("sm90", "fa_fwd_sm90_kernel", ("dq_sm90_kernel",),
                 "dkv_sm90_kernel"),
                ("simt", "fa_fwd_kernel", ("di_kernel", "dq_kernel"),
                 "dkv_kernel")):
            def fwd_call():
                return fa._launch(q, k, v, bias, scale, causal, "bshd",
                                  True, drop)

            def bwd_call():
                return fa._launch_bwd(q, k, v, bias, out, lse, g, scale,
                                      causal, "bshd", drop, False)

            with (_cuda_core_kernels(fa) if design == "simt"
                  else contextlib.nullcontext()):
                t[design] = {
                    "fwd": _device_ms(torch, fwd_call, 20, (fkey,))[fkey],
                    "fwd_ev": _time_ms(fwd_call),
                    "bwd": _device_ms(torch, bwd_call, 20, qkeys + (dkey,)),
                    "bwd_ev": _time_ms(bwd_call)}
            t[design]["dkv"] = t[design]["bwd"][dkey]
            t[design]["dq"] = sum(t[design]["bwd"][k] for k in qkeys)
        fwd_plain = _time_ms(lambda: fa.fused_attention_plain(
            q, k, v, bias, scale, causal, "bshd", return_lse=True,
            dropout=drop))
        bwd_plain = _time_ms(lambda: fa.fused_attention_backward_plain(
            q, k, v, bias, out, lse, g, scale, causal, "bshd",
            dropout=drop))
        # library: sdpa with the same bias (and causal mask) as one float
        # mask, dropout 0.1 from its own generator
        mask = bias.to(torch.bfloat16).expand(B, 1, S, S)
        if causal:
            tri = torch.ones(S, S, device=dev, dtype=torch.bool).triu(1)
            mask = mask.masked_fill(tri, float("-inf"))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        gt = g.transpose(1, 2)

        def lib_fwd():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, dropout_p=0.1, scale=scale)

        def lib_fwd_bwd():
            torch.autograd.backward(lib_fwd(), gt)

        lib_f = _call_device_ms(torch, lib_fwd, 20)
        lib_fb = _call_device_ms(torch, lib_fwd_bwd, 20)
        lib_f_ev = _time_ms(lib_fwd)
        lib_fb_ev = _time_ms(lib_fwd_bwd)
        fb, fby = _bound(2 * mm, 4 * el * 2 + bias.numel() * 4 + rows * 4,
                         peak_bf16, peak_bw)
        qb, qby = _bound(3 * mm, 6 * el * 2 + bias.numel() * 4 + rows * 8,
                         peak_bf16, peak_bw)
        kb, kby = _bound(4 * mm, 6 * el * 2 + bias.numel() * 4 + rows * 8,
                         peak_bf16, peak_bw)
        simt_bwd = t["simt"]["bwd"]
        fwd_row = {"plain_ms": fwd_plain, "library_ms": lib_f,
                   "bound_ms": fb, "bound_by": fby}
        dq_row = {"plain_ms": bwd_plain, "library_ms": lib_fb - lib_f,
                  "bound_ms": qb, "bound_by": qby}
        dkv_row = {"plain_ms": bwd_plain, "library_ms": lib_fb - lib_f,
                   "bound_ms": kb, "bound_by": kby}
        res[causal] = {
            "fwd": {"ms": t["simt"]["fwd"], **fwd_row},
            "fwd_sm90": {"ms": t["sm90"]["fwd"], **fwd_row},
            "dq": {"ms": t["simt"]["dq"], **dq_row},
            "dq_sm90": {"ms": t["sm90"]["dq"], **dq_row},
            "dkv": {"ms": t["simt"]["dkv"], **dkv_row},
            "dkv_sm90": {"ms": t["sm90"]["dkv"], **dkv_row}}
        print(f"  training shape B={B} S={S} H={H} D={D} bf16 dropout 0.1 "
              f"causal={causal} (device time):")
        print(f"    forward+lse: tensor-core kernel {t['sm90']['fwd']:.4f} "
              f"ms, CUDA-core kernel {t['simt']['fwd']:.4f} ms, plain "
              f"{fwd_plain:.4f} ms (events), sdpa {lib_f:.4f} ms, bound "
              f"{fb:.4f} ms ({fby}; {2 * mm / 1e9:.3f} GFLOP)")
        print(f"    backward: dq tensor-core (di fused) "
              f"{t['sm90']['dq']:.4f} ms, CUDA-core di "
              f"{simt_bwd['di_kernel']:.4f} + dq "
              f"{simt_bwd['dq_kernel']:.4f} ms (bound {qb:.4f}, {qby}); dk/dv "
              f"tensor-core {t['sm90']['dkv']:.4f} ms, CUDA-core "
              f"{t['simt']['dkv']:.4f} ms (bound {kb:.4f}, {kby}); plain "
              f"backward {bwd_plain:.4f} ms (events); sdpa backward "
              f"{lib_fb - lib_f:.4f} ms (fwd+bwd {lib_fb:.4f} - fwd)")
        print(f"    events over a loop of calls, as in earlier runs: "
              f"forward tensor-core {t['sm90']['fwd_ev']:.4f} ms, CUDA-core "
              f"{t['simt']['fwd_ev']:.4f} ms; the backward's kernels, "
              f"tensor-core {t['sm90']['bwd_ev']:.4f} ms, CUDA-core "
              f"{t['simt']['bwd_ev']:.4f} ms; sdpa forward "
              f"{lib_f_ev:.4f} ms, sdpa backward {lib_fb_ev - lib_f_ev:.4f} "
              f"ms (fwd+bwd {lib_fb_ev:.4f})")
    return res


def _routed(shapes):
    """The parameter shapes the registry routes to an optimizer kernel
    at the current PT_KERNEL_MIN_NUMEL, and the others."""
    from paddle_tpu_torch.kernels import registry as kreg
    floor = kreg.min_numel()
    routed = [sh for sh in shapes if int(np.prod(sh)) >= floor]
    return routed, [sh for sh in shapes if int(np.prod(sh)) < floor]


def _baseline_adam(torch, baseline, state, lr_t):
    """One Adam step of an earlier checkout over (p, g, m, v) tensors:
    its fused_optimizer.cu's per-parameter pt_fused_adam, one launch a
    parameter, with the bias-corrected rate lr_t (the design before the
    multi-tensor launch)."""
    import ctypes
    fn = _baseline_lib(baseline, "fused_optimizer.cu").pt_fused_adam
    P, F = ctypes.c_void_p, ctypes.c_float
    fn.argtypes = [P, P, P, P, P, ctypes.c_int64, F, F, F, F, F, P]
    fn.restype = ctypes.c_int

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        for p, g, m, v in state:
            err = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                     lr_t.data_ptr(), p.numel(), 0.9, 1.0 - 0.9, 0.999,
                     1.0 - 0.999, 1e-8, stream)
            _require(err == 0, f"baseline fused_adam failed: {err}")
    return call


def time_adam(torch, dev, card, shapes, baseline=None):
    """One Adam step over the parameter shapes of the training program that
    the registry routes to the kernel: the kernel as the engine calls it
    (one list, one launch; events around ten calls queued behind a sleep,
    the row's time, beside the profiler's reading and events over one call
    at a time), the plain version, torch.optim.Adam(fused=True) (the
    yardstick, queued events too) and the bound of 28 bytes an element. With
    `baseline` (an earlier checkout) its per-parameter kernel too, in turns
    with this one's list launch (its results against this one's, 0 ulp).
    Then the plain update of the parameters the registry lowers, as the adam
    op runs it on the card: host clock and device time."""
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    from paddle_tpu_torch.kernels import registry as kreg
    _, _, peak_bw, _, _ = _peaks(card)
    routed, lowered = _routed(shapes)
    state, b1ps, b2ps = _adam_list(torch, dev, [int(np.prod(sh))
                                                for sh in routed], 0)
    ps, gs, ms, vs = (list(c) for c in zip(*state))
    low_state = [_adam_state(torch, dev, int(np.prod(sh)), i)
                 for i, sh in enumerate(lowered)]
    n = sum(p.numel() for p in ps)
    n_low = sum(p.numel() for p, _, _, _ in low_state)
    lr = torch.tensor([LR], device=dev)
    lr_t = _lr_t(torch, dev)
    key = ("adam_multi_kernel",)

    def kernel():
        fo.fused_adam_multi(ps, gs, ms, vs, lr, b1ps, b2ps)

    def plain():
        fo.adam_multi_plain(ps, gs, ms, vs, lr, b1ps, b2ps, 0.9, 0.999,
                            1e-8)

    kreg.reset_counts()
    kernel()
    launches = kreg.launches()["fused_adam"]
    _require(launches == 1, f"{launches} Adam launches for one list")
    base_ms = None
    if baseline:
        # one bias-corrected rate for every parameter (step 3's), which
        # the baseline takes as it is and the list kernel computes from
        # the beta powers, both in float32 and rounded alike
        b3 = [torch.tensor([0.9 ** 3], device=dev)] * len(ps)
        b3v = [torch.tensor([0.999 ** 3], device=dev)] * len(ps)
        rate = (lr * torch.sqrt(1 - b3v[0]) / (1 - b3[0])).reshape(1)
        twins = [[t.clone() for t in ts] for ts in state]
        base = _baseline_adam(torch, baseline, twins, rate)
        base()
        fo.fused_adam_multi(ps, gs, ms, vs, lr, b3, b3v)
        torch.cuda.synchronize()
        _require(all(torch.equal(a, b) for ts, tw in zip(state, twins)
                     for a, b in zip(ts, tw)),
                 "the baseline's Adam disagrees")
        old = ("adam_kernel",)
        runs = [_device_ms(torch, base, 5, old)[old[0]],
                _device_ms(torch, kernel, 5, key)[key[0]],
                _device_ms(torch, kernel, 5, key)[key[0]],
                _device_ms(torch, base, 5, old)[old[0]]]
        queued = [_queued_ms(torch, f)[0]
                  for f in (base, kernel, kernel, base)]
        base_ms = (queued[0] + queued[3]) / 2
        print(f"  adam over the {len(routed)} routed parameters: the "
              f"baseline checkout's kernel ({len(routed)} launches) "
              f"{base_ms:.4f} ms against this one's list launch "
              f"{(queued[1] + queued[2]) / 2:.4f} ms (queued events, in "
              f"turns: {', '.join(f'{x:.4f}' for x in queued)}; "
              f"profiler, in turns: {', '.join(f'{x:.4f}' for x in runs)};"
              f" equal results)")
        del twins
    ev = _time_ms(kernel, iters=10, warmup=2)
    kq, kq_host = _queued_ms(torch, kernel)
    prof_ms = _device_ms(torch, kernel, 5, key)[key[0]]
    pl = _time_ms(plain, iters=5, warmup=1)
    params = [p.clone().requires_grad_(True) for p in ps]
    for prm, g in zip(params, gs):
        prm.grad = g.clone()
    opt = torch.optim.Adam(params, lr=LR, fused=True)
    lib_prof = _device_ms(torch, opt.step, 5, ("",))[""]
    lib_ev = _time_ms(opt.step, iters=10, warmup=2)
    lib, _ = _queued_ms(torch, opt.step)
    del params, opt
    bound = 28 * n / peak_bw * 1e3
    # the profiler has read this launch (and SGD's list launch) below its
    # byte bound, which no kernel can beat: the row's time is the queued
    # events', the card running calls back to back (the yardstick's too)
    below = " (below the byte bound: not a time)" if prof_ms < bound else ""
    low_ev = _time_ms(lambda: [fo.adam_plain(p, g, m, v, lr_t[0], 0.9,
                                             0.999, 1e-8)
                               for p, g, m, v in low_state],
                      iters=10, warmup=2)
    low_dev = _device_ms(torch, lambda: [
        fo.adam_plain(p, g, m, v, lr_t[0], 0.9, 0.999, 1e-8)
        for p, g, m, v in low_state], 5, ("",))[""]
    print(f"  adam over the {len(routed)} routed parameters, {n} elements: "
          f"kernel {kq:.4f} ms ({launches} launch; queued events, host "
          f"{kq_host:.1f} ms to queue 10; the profiler {prof_ms:.4f} ms"
          f"{below}; events over one call at a time {ev:.4f} ms), plain "
          f"{pl:.4f} ms (events), "
          f"torch.optim.Adam(fused=True) {lib:.4f} ms (queued events; "
          f"the profiler {lib_prof:.4f} ms, events over the loop "
          f"{lib_ev:.4f} ms), bound {bound:.4f} ms (bytes: "
          f"28 B x {n})")
    print(f"  adam plain update of the {len(lowered)} lowered parameters, "
          f"{n_low} elements: host clock (events over the loop) "
          f"{low_ev:.4f} ms, device {low_dev:.4f} ms")
    return {"ms": kq, "events_ms": ev, "profiler_ms": prof_ms,
            "plain_ms": pl, "library_ms": lib, "bound_ms": bound,
            "bound_by": "bytes", "elements": n, "routed": len(routed),
            "launches": launches, "baseline_ms": base_ms,
            "lowered_events_ms": low_ev, "lowered_device_ms": low_dev}


def _sgd_pair(torch, dev, n, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return (torch.randn(n, device=dev, generator=g),
            torch.randn(n, device=dev, generator=g) * 1e-2)


def sgd_phase(torch, dev, groups):
    """The SGD kernel against its plain version, 0 ulp: one multi-tensor
    launch over each group's list of parameter shapes (weight decay 1e-4
    too on the odd lengths); returns the worst |err|."""
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    from paddle_tpu_torch.kernels import registry as kreg
    lr = torch.tensor([MNIST_LR], device=dev)
    worst = 0.0
    for label, shapes, wds in groups:
        pairs = [_sgd_pair(torch, dev, int(np.prod(sh)), i)
                 for i, sh in enumerate(shapes)]
        n = sum(p.numel() for p, _ in pairs)
        ulp, err = 0, 0.0
        for wd in wds:
            refs = [fo.sgd_plain(p, g, lr[0], wd) for p, g in pairs]
            kreg.reset_counts()
            got = fo.fused_sgd_multi([p.clone() for p, _ in pairs],
                                     [g for _, g in pairs], lr,
                                     weight_decay=wd)
            torch.cuda.synchronize()
            _require(kreg.launches()["fused_sgd"] == 1,
                     f"fused_sgd ({label}): {kreg.launches()['fused_sgd']} "
                     f"launches for one list")
            for a, r in zip(got, refs):
                ulp = max(ulp, int(_ulps(torch, a, r).max()))
                err = max(err, (a - r).abs().max().item())
        print(f"  sgd vs plain, {label} ({len(shapes)} tensors, {n} "
              f"elements, one launch): max ulp {ulp}, max|err| {err:.3e} "
              f"(bound {SGD_ULP} ulp) {'ok' if ulp <= SGD_ULP else 'FAIL'}")
        _require(ulp <= SGD_ULP, f"fused_sgd ({label}) is {ulp} ulp from "
                                 f"its plain version")
        worst = max(worst, err)
    return worst


def time_sgd(torch, dev, card, shapes, label, baseline=None):
    """One SGD step over the given parameter shapes: the kernel as the
    engine calls it (one list, one launch), the same kernel a parameter
    at a time (a list of one a launch, as many launches as the design
    before the list launch made),
    the plain version and two library calls that compute the same
    update (p.add_(g, alpha=-lr) per parameter, and torch._foreach_add_
    over the list, the yardstick: one call), all by profiler device
    time; and the bound of 12 bytes an element (read p and g, write
    p). With `baseline` (an earlier checkout) its SGD kernel too, one
    launch a parameter, in turns with this one's list launch, its
    parameters against this one's (0 ulp)."""
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    from paddle_tpu_torch.kernels import registry as kreg
    _, _, peak_bw, _, _ = _peaks(card)
    pairs = [_sgd_pair(torch, dev, int(np.prod(sh)), i)
             for i, sh in enumerate(shapes)]
    ps, gs = [p for p, _ in pairs], [g for _, g in pairs]
    n = sum(p.numel() for p in ps)
    lr = torch.tensor([MNIST_LR], device=dev)

    def kernel():
        fo.fused_sgd_multi(ps, gs, lr)

    def per_param():
        for p, g in pairs:
            fo.fused_sgd(p, g, lr)

    def plain():
        for p, g in pairs:
            fo.sgd_plain(p, g, lr[0])

    def each():
        for p, g in pairs:
            p.add_(g, alpha=-MNIST_LR)

    def foreach():
        torch._foreach_add_(ps, gs, alpha=-MNIST_LR)

    kreg.reset_counts()
    kernel()
    launches = kreg.launches()["fused_sgd"]
    base_ms = None
    base = _baseline_sgd(torch, baseline, pairs, lr) if baseline else None
    if baseline and base is None:
        print(f"  sgd over {label}: the baseline checkout has this one's "
              f"list launch (no per-parameter kernel to time)")
    if base is not None:
        twins = [(p.clone(), g) for p, g in pairs]
        base()
        fo.fused_sgd_multi([p for p, _ in twins], [g for _, g in twins], lr)
        _require(all(torch.equal(p, t) for (p, _), (t, _) in
                     zip(pairs, twins)), "the baseline's SGD disagrees")
        old = ("sgd_kernel",)
        runs = [_device_ms(torch, base, 5, old)[old[0]],
                _device_ms(torch, kernel, 5, ("sgd_multi_kernel",))[
                    "sgd_multi_kernel"],
                _device_ms(torch, kernel, 5, ("sgd_multi_kernel",))[
                    "sgd_multi_kernel"],
                _device_ms(torch, base, 5, old)[old[0]]]
        base_ms = (runs[0] + runs[3]) / 2
        print(f"  sgd over {label}: the baseline checkout's kernel "
              f"({len(shapes)} launches) {base_ms:.4f} ms against this "
              f"one's list launch {(runs[1] + runs[2]) / 2:.4f} ms (in "
              f"turns: {', '.join(f'{x:.4f}' for x in runs)}; equal "
              f"parameters)")
    ev = _time_ms(kernel, iters=10, warmup=2)
    kq, kq_host = _queued_ms(torch, kernel)
    fq, fq_host = _queued_ms(torch, foreach)
    each_ev = _time_ms(per_param, iters=10, warmup=2)
    pl_ev = _time_ms(plain, iters=10, warmup=2)
    key = ("sgd_multi_kernel",)
    dev_ms = _device_ms(torch, kernel, 5, key)[key[0]]
    each_ms = _device_ms(torch, per_param, 5, key)[key[0]]
    pl = _device_ms(torch, plain, 5, ("",))[""]
    lib_each = _device_ms(torch, each, 5, ("",))[""]
    lib = _device_ms(torch, foreach, 5, ("",))[""]
    bound = 12 * n / peak_bw * 1e3
    print(f"  sgd over {label}'s {len(shapes)} parameters, {n} elements "
          f"(device ms a step): kernel {dev_ms:.4f} ({launches} launch(es) "
          f"a list; events {ev:.4f}; queued events {kq:.4f}, host "
          f"{kq_host:.1f} ms to queue 10; torch._foreach_add_ queued "
          f"{fq:.4f}, host {fq_host:.1f} ms), the same kernel a parameter at a "
          f"time {each_ms:.4f} ({len(shapes)} launches; events "
          f"{each_ev:.4f}), plain {pl:.4f} (events {pl_ev:.4f}), p.add_ "
          f"per parameter {lib_each:.4f}, torch._foreach_add_ {lib:.4f}, "
          f"bound {bound:.4f} (bytes: 12 B x {n})")
    return {"ms": dev_ms, "events_ms": ev, "per_param_ms": each_ms,
            "baseline_ms": base_ms, "queued_ms": kq,
            "launches": launches, "plain_ms": pl, "library_ms": lib,
            "library_each_ms": lib_each, "bound_ms": bound,
            "bound_by": "bytes", "elements": n}


def where_time_goes(torch, exe, main, feed, cost, scope):
    """The forward again fetching only the cost (the difference to a
    full run is the logits' trip to the host), then once under
    torch.profiler: device busy share and the kernels that take most
    device time."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    cost_only = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"  forward fetching only the cost: {cost_only:.4f} s; "
          f"profiled: wall {wall:.4f} s, device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f} %)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<4d} {e.key[:90]}")
    return {"cost_only_s": cost_only, "wall_s": wall, "busy_s": busy}


def slice_phase(torch, dev):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    from paddle_tpu_torch.models import transformer as T

    cfg = T.transformer_base(fuse_attention=True)   # full width
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, logits, _ = T.transformer_train(cfg, is_test=True)
    startup.random_seed = SEED
    n_attn = sum(op.type == "fused_attention"
                 for op in main.global_block().ops)
    _require(n_attn == 18, f"expected 18 fused_attention ops, got {n_attn}")
    n_mul = sum(op.type == "mul" for op in main.global_block().ops)
    _require(n_mul == SERVE_MULS, f"expected {SERVE_MULS} mul ops, got "
                                  f"{n_mul}")

    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    print(f"  startup on the card: {time.perf_counter() - t0:.3f} s, "
          f"{sum(int(np.prod(p.shape)) for p in main.all_parameters())} "
          f"parameters")

    B, S = 32, 256
    rng = np.random.default_rng(SEED)
    batches = [T.make_batch(cfg, B, S, S, rng=rng,
                            src_lens=rng.integers(S // 2, S + 1, B),
                            trg_lens=rng.integers(S // 2, S + 1, B))
               for _ in range(3)]

    torch.cuda.reset_peak_memory_stats()
    kreg.reset_counts()
    outs, secs = [], []
    for feed in batches:
        t0 = time.perf_counter()
        outs.append(exe.run(main, feed=feed, fetch_list=[logits, cost],
                            scope=scope))
        secs.append(time.perf_counter() - t0)
    counts = kreg.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    _require(counts["flash_attention_fwd"] == 18 * len(batches)
             and counts["flash_attention_fwd_f32_sm90"] == 18 * len(batches)
             and counts["flash_attention_fwd_sm90"] == 0,
             f"flash_attention_fwd launched "
             f"{counts['flash_attention_fwd']} times in "
             f"{len(batches)} float32 forwards (want 18 each, all of them "
             f"the float32 tensor-core kernel's)")
    for (lg, c), feed in zip(outs, batches):
        _require(lg.shape == (B, S, cfg.trg_vocab_size),
                 f"logits shape {lg.shape}")
        _require(bool(np.isfinite(lg).all()) and np.isfinite(c),
                 "non-finite logits or cost")
        # random weights score near-uniformly: cost ~ log(vocab)
        _require(abs(float(c) - np.log(cfg.trg_vocab_size)) < 1.0,
                 f"cost {float(c)} far from log(vocab)")

    with kreg.plain_reference():
        ref_lg, ref_c = exe.run(main, feed=batches[-1],
                                fetch_list=[logits, cost], scope=scope)
    _require(kreg.launches() == counts,
             "plain_reference() launched a kernel")
    lg, c = outs[-1]
    lerr = float(np.abs(lg - ref_lg).max())
    cerr = abs(float(c) - float(ref_c)) / abs(float(ref_c))
    print(f"  logits kernel vs plain_reference(): max|err|={lerr:.3e} "
          f"(atol {LOGITS_ATOL:g}), cost rel err={cerr:.3e} "
          f"(rtol {COST_RTOL:g})")
    _require(lerr <= LOGITS_ATOL and cerr <= COST_RTOL,
             "forward disagrees with plain_reference()")

    where_time_goes(torch, exe, main, batches[-1], cost, scope)
    _serving_rates(batches, secs, B, S)
    print(f"  peak memory allocated: {peak_gb:.3f} GB; launches per "
          f"forward: {counts['flash_attention_fwd'] // len(batches)}")
    served = {"exe": exe, "main": main, "scope": scope, "batches": batches,
              "logits": logits, "cost": cost, "f32": outs[-1]}
    return counts, lerr, served


def _serving_rates(batches, secs, B, S):
    tokens = [int(f["lbl_w"].sum() + (f["src_bias"] == 0).sum())
              for f in batches]
    steady = secs[1:]
    tps = sum(tokens[1:]) / sum(steady)
    print(f"  forward seconds per batch: "
          f"{', '.join(f'{s:.4f}' for s in secs)} (first includes "
          f"warm-up)")
    print(f"  tokens/s (non-pad src+trg, batches 2-3, fetch included): "
          f"{tps:.1f}; padded tokens/s: "
          f"{B * 2 * S * len(steady) / sum(steady):.1f}")
    return tps


def _rel(torch, got, ref):
    """Relative error in the norm, in float64."""
    got, ref = got.double(), ref.double()
    return ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def _gemm_inputs(torch, dev, M, K, N, seed, dtype=None):
    """x [M, K], y [K, N] on the card from a seed; every 97th row of x
    is 30x larger, so that some tiles' scales are set by a few rows."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn(M, K, device=dev, generator=g)
    x[::97] *= 30.0
    y = torch.randn(K, N, device=dev, generator=g) * K ** -0.5
    dtype = dtype or torch.float32
    return x.to(dtype), y.to(dtype)


def _epilogue_inputs(torch, dev, M, N, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return {"gamma": 1.0 + 0.1 * torch.randn(N, device=dev, generator=g),
            "beta": 0.1 * torch.randn(N, device=dev, generator=g),
            "mask": (torch.rand(M, N, device=dev, generator=g) < 0.9)
            .float(),
            "residual": torch.randn(M, N, device=dev, generator=g)}


def gemm_kernel_phase(torch, dev):
    """quantized_matmul (int8 bit-equal, bf16 within GEMM_RTOL) at the
    four serving shapes and 256x384x128, float32 and bf16 operands; every
    instantiated tuned_matmul variant within GEMM_RTOL at every serving
    shape it divides. Returns {(kernel, M, K, N): max |err|} (float32
    operands)."""
    from paddle_tpu_torch.kernels import quantized_matmul as qm
    from paddle_tpu_torch.kernels import registry as kreg
    from paddle_tpu_torch.tuning import variants as V
    worst = {}
    shapes = [(M, K, N) for M, K, N, _ in SERVE_GEMMS] + [(256, 384, 128)]
    for M, K, N in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x, y = _gemm_inputs(torch, dev, M, K, N, M + K + N, dtype)
            for mode in ("int8", "bf16"):
                got = qm.quantized_matmul(x, y, mode=mode)
                ref = qm.quantized_matmul_plain(x, y, mode)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                diff = int((got != ref).sum())
                rel = _rel(torch, got, ref)
                ok = diff == 0 if mode == "int8" else rel <= GEMM_RTOL
                ok = ok and bool(torch.isfinite(got).all())
                print(f"  quantized_matmul_{mode} vs plain [{_dname(torch, dtype):8s}] "
                      f"{M}x{K}x{N}: {diff} elements differ, rel "
                      f"{rel:.3e}, max|err| {err:.3e} "
                      f"({'bit-equal required' if mode == 'int8' else f'rtol {GEMM_RTOL:g}'}) "
                      f"{'ok' if ok else 'FAIL'}")
                _require(ok, f"quantized_matmul_{mode} {dtype} {M}x{K}x{N} "
                             f"disagrees with its plain version")
                if dtype == torch.float32:
                    worst[(f"quantized_matmul_{mode}", M, K, N)] = err
                del got, ref
    built = V.instantiated_variants()
    print(f"  tuned_matmul variants built: "
          f"{[f'{bm}x{bn}x{bk}/{ep}' for bm, bn, bk, ep in built]}")
    _require(sorted(built) == sorted(
        (*b, ep) for ep, blocks in V._BLOCKS.items() for b in blocks),
        "the built tuned_matmul variants are not the search space")
    probe = V.round_probe(dev)
    torch.cuda.synchronize()
    mags = probe.abs()
    near, zero = int((mags == 1 + 2.0 ** -23).sum()), int((mags == 1).sum())
    print(f"  tensor cores' float32 sums (one tf32 wgmma adding 0.625 ulp to "
          f"+-1): {near} of 4096 rounded to nearest, {zero} toward zero")
    _require(near + zero == 4096, "the rounding probe read neither")
    for M, K, N, _ in SERVE_GEMMS:
        x, y = _gemm_inputs(torch, dev, M, K, N, 7 * M + N)
        e = _epilogue_inputs(torch, dev, M, N, 11 + N)
        for v in V.enumerate_variants(M, N, K):
            kw = V._kwargs(v, e)
            got = V.tuned_matmul(x, y, variant=v, **kw)
            with kreg.plain_reference():
                ref = V.tuned_matmul(x, y, variant=v, **kw)
            torch.cuda.synchronize()
            rel = _rel(torch, got, ref)
            err = (got - ref).abs().max().item()
            ok = rel <= GEMM_RTOL and bool(torch.isfinite(got).all())
            print(f"  {v.label} [{v.kernel}] vs plain {M}x{K}x{N}: rel "
                  f"{rel:.3e}, max|err| {err:.3e} (rtol {GEMM_RTOL:g}) "
                  f"{'ok' if ok else 'FAIL'}")
            _require(ok, f"{v.label} {M}x{K}x{N} disagrees with its plain "
                         f"version")
            key = (v.kernel, M, K, N)
            worst[key] = max(worst.get(key, 0.0), err)
            del got, ref
    return worst


def search_phase(torch, dev):
    """The tuned_matmul variant search on the card at SEARCH_PROBLEM, the
    path of the layer_norm and dropout_residual epilogues and of the
    CUDA-core tiles; it times both designs in the same run, and the none
    and layer_norm winners must be tensor-core tiles. Returns (search
    result, launches during the search)."""
    from paddle_tpu_torch.kernels import registry as kreg
    from paddle_tpu_torch.tuning import variants as V
    M, N, K = SEARCH_PROBLEM
    kreg.reset_counts()
    res = V.search_variants(M, N, K, iters=20, device=dev)
    counts = kreg.launches()
    _require(res["timed"], "the variant search did not time on the card")
    _require(res["considered"] == len(res["admitted"]),
             f"only {len(res['admitted'])} of {res['considered']} variants "
             f"passed parity")
    for row in res["admitted"]:
        v = _variant(V, row)
        print(f"  {v.label} [{'tensor cores' if v.sm90 else 'CUDA cores'}]"
              f": {row['ms']:.4f} ms a call (the ranking: median of "
              f"{V._RUNS} runs of 20 calls queued back to back), "
              f"{row['single_ms']:.4f} ms a single call (median of 20, "
              f"the host's launch included), rel err "
              f"{row['rel_err']:.3e}")
    _require(set(res["winners"]) == {"none", "layer_norm",
                                     "dropout_residual"},
             f"winners {res['winners']}")
    for ep in ("none", "layer_norm"):
        _require(_variant(V, res["winners"][ep]).sm90,
                 f"the {ep} winner is not a tensor-core tile")
    print(f"  winners at M={M} N={N} K={K}: "
          + ", ".join(f"{ep} {w['bm']}x{w['bn']}x{w['bk']} {w['ms']:.4f} ms "
                      f"({'tensor' if _variant(V, w).sm90 else 'CUDA'} "
                      f"cores)" for ep, w in res["winners"].items()))
    print(f"  launches during the search: "
          f"{ {k: c for k, c in counts.items() if c} }")
    for name in ("tuned_matmul", "tuned_matmul_ln", "tuned_matmul_dr",
                 "tuned_matmul_sm90", "tuned_matmul_ln_sm90",
                 "tuned_matmul_dr_sm90"):
        _require(counts[name] > 0, f"the search never launched {name}")
    return res, counts


def _variant(V, row):
    return V.Variant(row["bm"], row["bn"], row["bk"], row["epilogue"])


def _best_tile(V, search, ep, sm90):
    """The fastest admitted tile of epilogue `ep` in the search of one
    design: the tensor-core one (sm90), or the CUDA-core one (the earlier
    design, timed beside it)."""
    rows = [r for r in search["admitted"]
            if r["epilogue"] == ep and _variant(V, r).sm90 == sm90]
    return min(rows, key=lambda r: r["ms"])


def _int_mm_call(torch, x, y):
    """torch._int_mm on the already-quantized operands: the int8 product
    alone (no quantization, no scales, int32 out), so not the same
    function. None when this torch build refuses both layouts of B."""
    from paddle_tpu_torch.kernels import quantized_matmul as qm
    qa = qm.quantize_int8(x, qm.tile_scales(x)).to(torch.int8)
    qb = qm.quantize_int8(y, qm.tile_scales(y)).to(torch.int8)
    for b in (qb.t().contiguous().t(), qb):      # column-major, row-major
        try:
            torch._int_mm(qa, b)
        except RuntimeError as exc:
            print(f"  torch._int_mm refused B of strides {b.stride()}: "
                  f"{str(exc).splitlines()[0][:100]}")
            continue
        return lambda b=b: torch._int_mm(qa, b)
    return None


def _call_device_ms(torch, fn, iters=10):
    """Device time of one call of fn: every CUDA kernel it launches,
    summed, from torch.profiler over `iters` calls (host launch time, which
    CUDA events over back-to-back calls of a small GEMM would measure, is
    left out)."""
    return _device_ms(torch, fn, iters, ("",))[""]


def _mm_f32_out(torch, xb, yb):
    """torch.mm(xb, yb, out_dtype=torch.float32) where this torch has the
    overload (bf16 operands, float32 out), else None."""
    try:
        torch.mm(xb[:128, :128], yb[:128, :128], out_dtype=torch.float32)
    except (TypeError, RuntimeError) as exc:
        print(f"  torch.mm(out_dtype=float32) refused: "
              f"{str(exc).splitlines()[0][:100]}")
        return None
    return lambda: torch.mm(xb, yb, out_dtype=torch.float32)


def _baseline_lib(baseline, source):
    """The library of one source of an earlier checkout of this repo (its
    paddle_tpu_torch/csrc/<source>), built with the port's nvcc flags into
    _build/baseline/: to time both versions of a kernel in one run."""
    import ctypes
    from paddle_tpu_torch.kernels import registry as kreg
    src = os.path.join(baseline, "paddle_tpu_torch", "csrc", source)
    out_dir = kreg.BUILD_DIR / "baseline"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{source[:-3]}_baseline.so"
    res = subprocess.run([kreg.nvcc_path(), *kreg.NVCC_FLAGS, "-o", str(so),
                          src], capture_output=True, text=True)
    _require(res.returncode == 0, f"the baseline's build failed:\n"
                                  f"{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(so))


def _baseline_qmm(torch, baseline):
    """call(x, y, mode) of the quantized GEMM of an earlier checkout of
    this repo (its quantized_matmul.cu, the same C interface)."""
    import ctypes
    fn = _baseline_lib(baseline, "quantized_matmul.cu").pt_quantized_matmul
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, i, i, i, i, i, p, p, p, p, p, p]
    fn.restype = i

    def call(x, y, mode):
        M, K = x.shape
        N = y.shape[1]

        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=x.device)

        out = empty((M, N), torch.float32)
        sa = sb = None
        if mode == "int8":
            wa, wb = empty((M, K), torch.int8), empty((N, K), torch.int8)
            sa = empty((M // 128, K // 128), torch.float32)
            sb = empty((K // 128, N // 128), torch.float32)
        else:   # the baseline reads only a bf16 x as it is
            wa = None if x.dtype == torch.bfloat16 \
                else empty((M, K), torch.bfloat16)
            wb = empty((N, K), torch.bfloat16)
        ptr = (lambda t: None if t is None else t.data_ptr())
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), y.data_ptr(),
                 int(y.dtype == torch.bfloat16), M, N, K,
                 0 if mode == "int8" else 1, ptr(wa), ptr(wb), ptr(sa),
                 ptr(sb), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        _require(err == 0, f"baseline quantized_matmul failed: {err}")
        return out
    return call


def time_gemms(torch, dev, card, search, baseline=None):
    """Each GEMM kernel at the four serving shapes (float32 operands, as the
    serving forward gives them): kernel, plain and library device times per
    call (all the kernels each launches; the quantized GEMM split into its
    pre-pass and its GEMM, the tensor-core tuned GEMM into its B^T pre-pass
    and its GEMM), the kernel on the host's clock (CUDA events around back-
    to-back calls) and the bound. The tuned rows: the search's tensor-core
    winners (none; layer_norm where N is its bn) and, beside them, the
    fastest CUDA-core tile of each, and the fastest dropout_residual tile of
    each design; their bound counts the float32 product as 3xTF32 operations
    at the TF32 peak (the least the card can do for a float32-accurate
    product) plus the epilogue's float32 operations. With `baseline` (an
    earlier checkout), the quantized GEMM of that checkout too, in turns
    with this one (baseline, this, this, baseline), each result against this
    one's (int8 bit-equal). Returns {(kernel, M, K, N): row}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import quantized_matmul as qm
    from paddle_tpu_torch.tuning import variants as V
    peak_f32, peak_bf16, peak_bw, peak_i8, peak_tf32 = _peaks(card)
    base = _baseline_qmm(torch, baseline) if baseline else None
    winners = search["winners"]
    tuned = [winners["none"], _best_tile(V, search, "none", False),
             winners["layer_norm"], _best_tile(V, search, "layer_norm", False),
             _best_tile(V, search, "dropout_residual", True),
             _best_tile(V, search, "dropout_residual", False)]
    out = {}
    for M, K, N, per_fwd in SERVE_GEMMS:
        x, y = _gemm_inputs(torch, dev, M, K, N, 5 * M + K)
        e = _epilogue_inputs(torch, dev, M, N, 13 + K)
        mnk = 2 * M * N * K
        io = 4 * (M * K + K * N + M * N)
        xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
        mm32 = _mm_f32_out(torch, xb, yb)
        rows = {
            "quantized_matmul_int8": (
                lambda: qm.quantized_matmul(x, y, mode="int8"),
                lambda: qm.quantized_matmul_plain(x, y, "int8"),
                _int_mm_call(torch, x, y),
                "torch._int_mm on the quantized operands (the int8 "
                "product alone: no quantization, no scales, int32 out; not "
                "the same function)",
                [(mnk, peak_i8)], io),
            "quantized_matmul_bf16": (
                lambda: qm.quantized_matmul(x, y, mode="bf16"),
                lambda: qm.quantized_matmul_plain(x, y, "bf16"),
                mm32 or (lambda: torch.matmul(xb, yb)),
                "torch.mm(out_dtype=float32) of the bf16 operands (the "
                "float32 output; leaves out the casts of x and y)"
                if mm32 else "torch.matmul of the bf16 operands (leaves "
                "out the casts and writes bf16, half the output bytes)",
                [(mnk, peak_bf16)], io),
        }
        for w in tuned:
            v = _variant(V, w)
            if M % v.bm or N % v.bn or K % v.bk or (
                    v.epilogue == "layer_norm" and v.bn != N):
                continue
            kw = V._kwargs(v, e)
            if v.epilogue == "none":
                lib = (lambda: torch.matmul(x, y))
                what, extra_b, extra_f = "torch.matmul float32 (cuBLAS, " \
                    "TF32 off): the same function", 0, 0
            elif v.epilogue == "layer_norm":
                lib = (lambda kw=kw: F.layer_norm(
                    torch.matmul(x, y), (N,), kw["gamma"], kw["beta"],
                    1e-5))
                what, extra_b, extra_f = "F.layer_norm(torch.matmul) " \
                    "(composed)", 8 * N, 8 * M * N
            else:
                lib = (lambda kw=kw: torch.matmul(x, y) * kw["mask"]
                       * (1 / 0.9) + kw["residual"])
                what, extra_b, extra_f = "torch.matmul * mask / 0.9 + " \
                    "residual (composed)", 8 * M * N, 3 * M * N
            rows[v.kernel] = (
                lambda v=v, kw=kw: V.tuned_matmul(x, y, variant=v, **kw),
                lambda v=v, kw=kw: V.tuned_matmul_plain(x, y, variant=v,
                                                        **kw),
                lib, f"{what}; tile {v.bm}x{v.bn}x{v.bk}",
                [(3 * mnk, peak_tf32), (extra_f, peak_f32)], io + extra_b)
        for name, (kern, plain, lib, what, ops, nbytes) in rows.items():
            quant = name.startswith("quantized_matmul")
            old_a = mode = None
            if quant and base is not None:
                mode = name.rsplit("_", 1)[1]
                got, ref = base(x, y, mode), kern()
                torch.cuda.synchronize()
                same = bool(torch.equal(got, ref)) if mode == "int8" else \
                    _rel(torch, got, ref) <= GEMM_RTOL
                _require(same, f"baseline {name} {M}x{K}x{N} disagrees")
                del got, ref
                old_a = _call_device_ms(torch, lambda: base(x, y, mode))
            parts = (("pack_both", "qmm_sm90_kernel") if quant else
                     ("split_transpose", "tmm_sm90_kernel")
                     if name.endswith("_sm90") else ())
            split = _device_ms(torch, kern, 10, ("", *parts))
            ms = split[""]
            events_ms = _time_ms(kern, iters=10, warmup=2)
            plain_ms = _call_device_ms(torch, plain, iters=5)
            lib_ms = None if lib is None else _call_device_ms(torch, lib)
            t_ops = sum(f / pk for f, pk in ops) * 1e3
            t_bytes = nbytes / peak_bw * 1e3
            bound = max(t_ops, t_bytes)
            by = "operations" if t_ops >= t_bytes else "bytes"
            out[(name, M, K, N)] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound, "bound_by": by, "per_forward": per_fwd,
                "library": what, "events_ms": events_ms}
            extra = ""
            if parts:
                extra = (f" = pre-pass {split[parts[0]]:.4f} + GEMM "
                         f"{split[parts[1]]:.4f}")
            if name == "quantized_matmul_bf16" and mm32 is not None:
                mm_ms = _call_device_ms(torch, lambda: torch.matmul(xb, yb))
                extra += (f"; torch.matmul of the bf16 operands (bf16 out) "
                          f"{mm_ms:.4f} ms")
            if old_a is not None:
                new_b = _call_device_ms(torch, kern)
                old_b = _call_device_ms(torch, lambda: base(x, y, mode))
                out[(name, M, K, N)]["baseline_ms"] = (old_a + old_b) / 2
                extra += (f"; the baseline checkout's design "
                          f"{old_a:.4f} / {old_b:.4f} ms around this one's "
                          f"{ms:.4f} / {new_b:.4f} ms (device, in turns)")
            opstr = " + ".join(f"{f / 1e9:.3g} GFLOP at {pk / 1e12:g} T/s"
                               for f, pk in ops if f)
            print(f"  {name} {M}x{K}x{N} (x{per_fwd} a forward): kernel "
                  f"{ms:.4f} ms device{extra} ({events_ms:.4f} ms a call on "
                  f"the host's clock), plain {plain_ms:.4f} ms, library "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} "
                  f"[{what}], bound {bound:.4f} ms ({by}: {opstr}, "
                  f"{nbytes / 1e6:.1f} MB at {peak_bw / 1e12:g} TB/s)")
        del x, y, xb, yb, e
    for name in ("quantized_matmul_int8", "quantized_matmul_bf16",
                 "tuned_matmul_sm90", "tuned_matmul"):
        tot = sum(r["ms"] * r["per_forward"] for (n, *_), r in out.items()
                  if n == name)
        bnd = sum(r["bound_ms"] * r["per_forward"]
                  for (n, *_), r in out.items() if n == name)
        print(f"  {name}: the {SERVE_MULS} GEMMs of one serving forward "
              f"take {tot:.3f} ms of kernel time (bound {bnd:.3f} ms)")
    return out


def _gemm_plain_forward(kreg, name, run):
    """run() with registry kernel `name` replaced by a stand-in with the
    same gate whose run is the kernel's wrapper under plain_reference():
    the GEMMs take their plain version, every other kernel launches."""
    kern = kreg.get(name)

    def plain_run(x, y, out_dtype=None, **_kw):
        with kreg.plain_reference():
            return kern.run(x, y, out_dtype=out_dtype)

    kreg.register_kernel(name, op_types=kern.op_types,
                         eligible=kern.eligible, run=plain_run)
    try:
        return run()
    finally:
        kreg.register_kernel(name, op_types=kern.op_types,
                             eligible=kern.eligible, run=kern.run,
                             doc=kern.doc)


def serve_mode(torch, served, mode):
    """The serving forward again with every mul through one GEMM kernel:
    mode int8 / bf16 (PT_KERNEL_QUANT_MATMUL) or tuned (the registered
    search winner). Requires 97 launches of that kernel and 18 of the
    float32 tensor-core attention forward a forward, compares the logits
    with the same forward with only the GEMMs plain (int8: bit-equal),
    with the same forward under plain_reference(), and with the float32
    forward, and prints the dispatch stats. Returns the kernel's launches
    in this mode's three forwards."""
    from paddle_tpu_torch.kernels import registry as kreg
    exe, main, scope = served["exe"], served["main"], served["scope"]
    batches, logits, cost = served["batches"], served["logits"], \
        served["cost"]
    # tuned: the search's none winner, a tensor-core tile (search_phase)
    routed = {"int8": "quantized_matmul_int8",
              "bf16": "quantized_matmul_bf16",
              "tuned": "tuned_matmul_sm90"}[mode]
    if mode != "tuned":
        os.environ["PT_KERNEL_QUANT_MATMUL"] = mode
    try:
        kreg.reset_stats()
        kreg.reset_counts()
        secs, last = [], None
        for feed in batches:
            t0 = time.perf_counter()
            last = exe.run(main, feed=feed, fetch_list=[logits, cost],
                           scope=scope)
            secs.append(time.perf_counter() - t0)
        counts = kreg.launches()
        stats = kreg.dispatch_stats()
        print(f"  dispatch stats: {stats['per_kernel']} (decisions "
              f"{stats['decisions']}, custom {stats['custom']})")
        n = len(batches)
        want = {k: 0 for k in counts}
        want.update({routed: SERVE_MULS * n, "flash_attention_fwd": 18 * n,
                     "flash_attention_fwd_f32_sm90": 18 * n})
        _require(counts == want, f"{mode} serving launched {counts}, want "
                                 f"{want}")
        lg, c = last
        _require(bool(np.isfinite(lg).all()) and np.isfinite(c),
                 "non-finite logits or cost")
        with kreg.plain_reference():
            ref_lg, ref_c = exe.run(main, feed=batches[-1],
                                    fetch_list=[logits, cost], scope=scope)
        _require(kreg.launches() == counts,
                 "plain_reference() launched a kernel")
        gp_lg, gp_c = _gemm_plain_forward(
            kreg, "tuned_matmul" if mode == "tuned" else "quantized_matmul",
            lambda: exe.run(main, feed=batches[-1],
                            fetch_list=[logits, cost], scope=scope))
        _require(kreg.launches()[routed] == counts[routed],
                 "the GEMMs' plain stand-in launched the kernel")
        f32_lg, f32_c = served["f32"]

        def rel(a, b):
            return float(np.linalg.norm((a - b).ravel().astype(np.float64))
                         / np.linalg.norm(b.ravel().astype(np.float64)))

        r_gp, r_plain, r_f32 = rel(lg, gp_lg), rel(lg, ref_lg), \
            rel(lg, f32_lg)
        gp_equal = bool(np.array_equal(lg, gp_lg)) and float(c) == \
            float(gp_c)
        print(f"  logits vs the same forward with only the GEMMs plain: "
              f"rel {r_gp:.3e}, max|err| "
              f"{float(np.abs(lg - gp_lg).max()):.3e}, bit-equal "
              f"{gp_equal} (rtol {QUANT_FWD_RTOL[mode]:g}"
              f"{'; int8 must be bit-equal' if mode == 'int8' else ''}); "
              f"vs plain_reference() in {mode} mode: rel {r_plain:.3e}, "
              f"max|err| {float(np.abs(lg - ref_lg).max()):.3e} (rtol "
              f"{QUANT_FWD_RTOL[mode]:g}); vs the float32 forward: rel "
              f"{r_f32:.3e} (parity bound {PARITY_RTOL[mode]:g}); cost "
              f"{float(c):.6f}, GEMMs plain {float(gp_c):.6f}, all plain "
              f"{float(ref_c):.6f}, float32 {float(f32_c):.6f}")
        _require(gp_equal if mode == "int8" else
                 r_gp <= QUANT_FWD_RTOL[mode],
                 f"{mode} forward disagrees with the same forward with "
                 f"its GEMMs plain")
        _require(r_plain <= QUANT_FWD_RTOL[mode],
                 f"{mode} forward disagrees with plain_reference()")
        _require(r_f32 <= PARITY_RTOL[mode],
                 f"{mode} forward is beyond the parity bound of float32")
        wt = where_time_goes(torch, exe, main, batches[-1], cost, scope)
        tps = _serving_rates(batches, secs, *lg.shape[:2])
        return counts[routed], {"tokens_s": tps, **wt, "rel_plain": r_plain,
                                "rel_gemm_plain": r_gp, "rel_f32": r_f32}
    finally:
        os.environ.pop("PT_KERNEL_QUANT_MATMUL", None)


def _build_training(pt, T):
    """bench.py's Transformer-base training program, built with the
    port: dropout 0.1, decorate(AdamOptimizer(2e-4))."""
    cfg = T.transformer_base(fuse_attention=True, dropout=0.1)
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, _, _ = T.transformer_train(cfg)
        opt = pt.contrib.mixed_precision.decorate(
            pt.optimizer.AdamOptimizer(learning_rate=LR))
        opt.minimize(cost)
    main.random_seed = startup.random_seed = SEED
    return cfg, main, startup, cost


def _training_feed(T, cfg):
    """One ragged batch of TRAIN_B x TRAIN_S from SEED."""
    B, S = TRAIN_B, TRAIN_S
    rng = np.random.default_rng(SEED)
    return T.make_batch(cfg, B, S, S, rng=rng,
                        src_lens=rng.integers(S // 2, S + 1, B),
                        trg_lens=rng.integers(S // 2, S + 1, B))


def _copy_scope(pt, scope, names):
    new = pt.Scope()
    for n in names:
        new.var(n).get_tensor().set_tensor(
            scope.find_var(n).get_tensor().tensor.clone())
    return new


def profile_step(torch, exe, main, feed, cost, scope, kernel="adam"):
    """One training step under torch.profiler: wall time, device busy
    share, the device time of the kernels whose name holds `kernel`
    (None: no such line) and the kernels that take most device time.
    Returns the busy share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    line = f"  profiled step: wall {wall:.4f} s, device busy {busy:.4f} s " \
        f"({100 * busy / wall:.1f} %)"
    if kernel is not None:
        mine = [e for e in kernels if kernel in e.key]
        line += f"; the {kernel} kernel " \
            f"{sum(e.self_device_time_total for e in mine) / 1e3:.3f} ms " \
            f"in {sum(e.count for e in mine)} launch(es)"
    print(line)
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}")
    return busy / wall


def training_phase(torch, dev, built):
    """5 steps of Transformer-base at B=96, S=128 under bf16 AMP with
    dropout 0.1; returns the launch counts of the 5 steps."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    from paddle_tpu_torch.models import transformer as T

    cfg, main, startup, cost = built
    block = main.global_block()
    types = [op.type for op in block.ops]
    n_params = len(main.all_parameters())
    routed, lowered = _routed([p.shape for p in main.all_parameters()])
    print(f"  training program: {len(types)} ops, {n_params} parameters, "
          f"{types.count('fused_attention')} attention, "
          f"{types.count('adam')} adam; at PT_KERNEL_MIN_NUMEL="
          f"{kreg.min_numel()} the registry routes {len(routed)} "
          f"parameters ({sum(int(np.prod(s)) for s in routed)} of "
          f"{sum(int(np.prod(p.shape)) for p in main.all_parameters())} "
          f"elements) to fused_adam and lowers {len(lowered)}")
    _require(types.count("fused_attention") == 18 and
             types.count("fused_attention_grad") == 18 and
             types.count("adam") == n_params == 255,
             "the training program is not bench.py's Transformer-base")
    _require(len(routed) == 99, f"{len(routed)} parameters reach the "
                                f"floor, want 99")
    # the attention biases are masks built from the feed: no grad op
    # binds BiasQK@GRAD, so no dq call writes the per-element ds
    dbias = [op for op in block.ops if op.type == "fused_attention_grad"
             and any(op.output("BiasQK@GRAD"))]
    print(f"  attention grad ops binding BiasQK@GRAD: {len(dbias)}")

    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    persist = [v.name for v in block.vars.values()
               if v.persistable and scope.find_var(v.name) is not None]
    ref_scope = _copy_scope(pt, scope, persist)
    f32_scope = _copy_scope(pt, scope, persist)

    B, S = TRAIN_B, TRAIN_S
    feed = _training_feed(T, cfg)
    masks = [op.output("Mask")[0] for op in block.ops
             if op.type == "dropout"][:3]
    params = [p.name for p in main.all_parameters()]
    moments = [op.input("Moment1")[0] for op in block.ops
               if op.type == "adam"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, per_step, decisions = [], [], [], []
    first_masks = after_first = None
    for step in range(5):
        kreg.reset_counts()
        kreg.reset_stats()
        t0 = time.perf_counter()
        res = exe.run(main, feed=feed,
                      fetch_list=[cost] + (masks if step == 0 else []),
                      scope=scope)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(kreg.launches())
        decisions.append(kreg.dispatch_stats()["per_kernel"])
        losses.append(float(res[0]))
        if step == 0:
            first_masks = res[1:]
            after_first = {n: scope.find_var(n).get_tensor().tensor.clone()
                           for n in params + moments}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  losses: {', '.join(f'{x:.6f}' for x in losses)}")
    _require(all(np.isfinite(losses)), "non-finite loss")
    _require(losses[-1] < losses[0], "the loss did not fall in 5 steps")
    want = {k: 0 for k in kreg.launches()}      # no GEMM kernel
    want.update({"flash_attention_fwd": 18, "flash_attention_bwd_dq": 18,
                 "flash_attention_bwd_dkv": 18,
                 "flash_attention_fwd_sm90": 18,
                 "flash_attention_bwd_dq_sm90": 18,
                 "flash_attention_bwd_dkv_sm90": 18,
                 # the engine hands the step's adam ops to one list: one
                 # multi-tensor launch takes every routed parameter
                 "fused_adam": 1})
    for i, (c, d) in enumerate(zip(per_step, decisions)):
        _require(c == want, f"step {i + 1} launched {c}, want {want}")
        _require(d.get("fused_adam") == {"custom": len(routed),
                                         "lowered": len(lowered)},
                 f"step {i + 1}: fused_adam decisions {d.get('fused_adam')}")
        _require(d.get("flash_attention") == {"custom": 36},
                 f"step {i + 1}: flash_attention decisions "
                 f"{d.get('flash_attention')}")
    print(f"  launches per step: {per_step[0]}")
    print(f"  registry decisions per step: {decisions[0]}")

    # the first step again, from copies of the initial scope: with every
    # wrapper on its plain version, and in float32 (AMP off)
    with kreg.plain_reference():
        ref = exe.run(main, feed=feed, fetch_list=[cost] + masks,
                      scope=ref_scope)
    _require(kreg.launches() == per_step[-1],
             "plain_reference() launched a kernel")
    for a, b in zip(first_masks, ref[1:]):
        _require(np.array_equal(a, b), "a dropout mask differs between "
                                       "the kernels' and the plain step")
    amp, main._amp = main._amp, None
    try:
        f32 = exe.run(main, feed=feed, fetch_list=[cost], scope=f32_scope)
    finally:
        main._amp = amp
    lerr = abs(float(ref[0]) - losses[0]) / abs(losses[0])

    def value(sc, n):
        return after_first[n] if sc is None else \
            sc.find_var(n).get_tensor().tensor

    def grad_err(sa, sb):
        d2 = r2 = 0.0
        for n in moments:
            a, b = value(sa, n).double(), value(sb, n).double()
            d2 += float(((a - b) ** 2).sum())
            r2 += float((b ** 2).sum())
        return (d2 / r2) ** 0.5

    e_kp = grad_err(None, ref_scope)
    e_k32 = grad_err(None, f32_scope)
    e_p32 = grad_err(ref_scope, f32_scope)
    worst = max((value(None, n) - value(ref_scope, n)).abs().max().item()
                for n in params)
    print(f"  first step, kernels vs plain_reference(): loss rel err "
          f"{lerr:.3e} (rtol {LOSS_STEP_RTOL:g}); float32 step loss "
          f"{float(f32[0]):.6f}; gradients (first moments) rel err in the "
          f"norm over all parameters: kernels bf16 vs plain bf16 "
          f"{e_kp:.3e}, kernels bf16 vs float32 {e_k32:.3e}, plain bf16 "
          f"vs float32 {e_p32:.3e} (bound {GRAD_NOISE_RATIO:g}x that); "
          f"parameters max|err| vs plain {worst:.3e} (bound {2 * LR:g}); "
          f"dropout masks equal")
    _require(lerr <= LOSS_STEP_RTOL and
             e_k32 <= GRAD_NOISE_RATIO * e_p32 + 1e-6 and
             worst <= 2 * LR * 1.01,
             "the training step disagrees with plain_reference()")

    profile_step(torch, exe, main, feed, cost, scope)
    steady = secs[1:]
    tokens = int(feed["lbl_w"].sum())
    # step 1 runs a plan of its own (it fetches masks too); the plan of
    # steps 2-5 runs eager at step 2, captures its block at step 3 and
    # replays it at steps 4-5
    replays = secs[3:]
    print(f"  step seconds: {', '.join(f'{x:.4f}' for x in secs)} (first "
          f"includes warm-up, third the capture)")
    print(f"  steps/s (steps 2-5): {len(steady) / sum(steady):.3f}; "
          f"non-pad target tokens/s: {tokens * len(steady) / sum(steady):.1f}"
          f" ({tokens} per step); padded tokens/s: "
          f"{B * S * len(steady) / sum(steady):.1f}; steps/s of the "
          f"replays (steps 4-5): {len(replays) / sum(replays):.3f}")
    print(f"  peak memory allocated: {peak_gb:.3f} GB")
    total = {k: sum(c[k] for c in per_step) for k in want}
    return total


def _build_resnet(pt, layout="NCHW"):
    """bench.py's ResNet-50 training program (bench_resnet50), built with
    the port: resnet_train(depth=50) under
    decorate(MomentumOptimizer(0.1, 0.9))."""
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, acc, _ = pt.models.resnet_train(depth=50, layout=layout)
        opt = pt.contrib.mixed_precision.decorate(
            pt.optimizer.MomentumOptimizer(RN_LR, RN_MU))
        opt.minimize(cost)
    main.random_seed = startup.random_seed = SEED
    return main, startup, cost, acc


def _resnet_feed(layout="NCHW"):
    """bench.py's random batch: B=128 images of 3x224x224 in [0, 1) and
    1000-class labels from RandomState(0) (NHWC: the same images
    transposed)."""
    rng = np.random.RandomState(0)
    img = rng.rand(RN_B, 3, RN_HW, RN_HW).astype(np.float32)
    if layout == "NHWC":
        img = np.ascontiguousarray(img.transpose(0, 2, 3, 1))
    return {"image": img,
            "label": rng.randint(0, 1000, (RN_B, 1)).astype(np.int64)}


def resnet_phase(torch, dev):
    """RN_STEPS steps of ResNet-50 at B=128, 224x224, under bf16 AMP with
    Momentum, through Executor.run on the card: a finite, falling loss,
    no launch of any of the port's kernels, the running statistics of
    res_conv1 moved; the first step against the same step in float32
    from a copy of the initial scope, and the float32 NHWC step from the
    same weights against the NCHW one. Prints images/s (steps 2-5, the
    fetch included), the device-busy share of one profiled step, its
    top kernels and peak memory. Returns the program, its startup, cost
    and feed for the cache A/B."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg

    t0 = time.perf_counter()
    main, startup, cost, acc = _build_resnet(pt)
    types = [op.type for op in main.global_block().ops]
    n_params = len(main.all_parameters())
    print(f"  ResNet-50 program built in {time.perf_counter() - t0:.2f} s: "
          f"{len(types)} ops ({types.count('conv2d')} conv2d, "
          f"{types.count('batch_norm')} batch_norm, "
          f"{types.count('momentum')} momentum), {n_params} parameters "
          f"(trained and running statistics), "
          f"{len([op for op in startup.global_block().ops])} startup ops; "
          f"cudnn.benchmark {torch.backends.cudnn.benchmark} (the port "
          f"does not set it)")
    _require(len(types) == 535 and types.count("conv2d") == 53 and
             types.count("batch_norm") == 53 and
             types.count("momentum") == 161,
             "the ResNet-50 program is not the JAX package's 535 ops")
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    persist = [v.name for v in main.global_block().vars.values()
               if v.persistable and scope.find_var(v.name) is not None]
    f32_scope = _copy_scope(pt, scope, persist)
    nhwc_scope = _copy_scope(pt, scope, persist)
    stats = ("res_conv1.bn.mean", "res_conv1.bn.var")
    stats0 = {n: scope.find_var(n).get_tensor().tensor.clone()
              for n in stats}
    feed = _resnet_feed()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kreg.reset_counts()
    losses, accs, secs = [], [], []
    for _ in range(RN_STEPS):
        t0 = time.perf_counter()
        loss, a = exe.run(main, feed=feed, fetch_list=[cost, acc],
                          scope=scope)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        accs.append(float(a[0]))
    launches = kreg.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  losses: {', '.join(f'{x:.6f}' for x in losses)}; accuracy "
          f"{accs[0]:.4f} -> {accs[-1]:.4f}")
    _require(all(np.isfinite(losses)), "non-finite ResNet-50 loss")
    _require(losses[-1] < losses[0],
             f"the ResNet-50 loss did not fall in {RN_STEPS} steps")
    print(f"  launches of the port's kernels in the {RN_STEPS} steps: "
          f"{ {k: v for k, v in launches.items() if v} or 'none'}")
    _require(not any(launches.values()),
             f"the ResNet-50 path launched {launches}")
    moved = {n: (scope.find_var(n).get_tensor().tensor - stats0[n])
             .abs().max().item() for n in stats}
    print(f"  running statistics, max|change| over {RN_STEPS} steps: "
          + ", ".join(f"{n} {v:.4e}" for n, v in moved.items()))
    _require(all(v > 0 for v in moved.values()),
             "the running statistics of res_conv1 did not move")

    # the first step in float32 (AMP off) from a copy of the initial
    # scope; then the NHWC graph's float32 step from the same weights
    amp, main._amp = main._amp, None
    try:
        f32 = float(exe.run(main, feed=feed, fetch_list=[cost],
                            scope=f32_scope)[0])
    finally:
        main._amp = amp
    hmain, _, hcost, _ = _build_resnet(pt, "NHWC")
    hmain._amp = None
    nhwc = float(exe.run(hmain, feed=_resnet_feed("NHWC"),
                         fetch_list=[hcost], scope=nhwc_scope)[0])
    e_amp = abs(losses[0] - f32) / abs(f32)
    e_nhwc = abs(nhwc - f32) / abs(f32)
    print(f"  first step: bf16 AMP loss {losses[0]:.6f}, float32 "
          f"{f32:.6f}, rel err {e_amp:.3e} (bound {RN_AMP_LOSS_RTOL:g}); "
          f"float32 NHWC from the same weights {nhwc:.6f}, rel err vs "
          f"NCHW {e_nhwc:.3e} (bound {RN_NHWC_RTOL:g})")
    _require(e_amp <= RN_AMP_LOSS_RTOL,
             "the AMP step is not within its bound of float32")
    _require(e_nhwc <= RN_NHWC_RTOL, "NHWC disagrees with NCHW")
    del f32_scope, nhwc_scope, hmain

    busy = profile_step(torch, exe, main, feed, cost, scope, kernel=None)
    steady, replays = secs[1:], secs[2:]
    print(f"  step seconds: {', '.join(f'{x:.4f}' for x in secs)} (first "
          f"includes warm-up, second the capture)")
    print(f"  steps/s (steps 2-{RN_STEPS}): {len(steady) / sum(steady):.3f}"
          f"; images/s {RN_B * len(steady) / sum(steady):.1f} (fetch "
          f"included), of the replays (steps 3-{RN_STEPS}) "
          f"{RN_B * len(replays) / sum(replays):.1f}; device busy share of "
          f"a profiled step {100 * busy:.1f} %")
    print(f"  peak memory allocated: {peak_gb:.3f} GB")
    return main, startup, cost, feed


@contextlib.contextmanager
def _deterministic(torch):
    """cuDNN's deterministic algorithms and torch's deterministic
    implementations (index_add_ among them), so that two runs of the
    same steps give the same bits."""
    old = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = old[:2]
        torch.use_deterministic_algorithms(old[2], warn_only=old[3])


@contextlib.contextmanager
def _lowering_clock():
    """Host seconds inside Engine.run, inside the op lowerings (group
    lowerings and forward records included; a lowering called from
    another counts once) and in the fetches' trip to numpy, which waits
    for the card: Engine.run less the other two is the engine's own
    host time."""
    import functools
    from paddle_tpu_torch.core import engine as E
    from paddle_tpu_torch.core.registry import OPS
    acc = {"run": 0.0, "lower": 0.0, "fetch": 0.0}
    depth = {k: 0 for k in acc}

    def timed(fn, key):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if depth[key]:
                return fn(*a, **kw)
            depth[key] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[key] += time.perf_counter() - t0
                depth[key] -= 1
        return wrapper

    saved = [(info, info.lowering, info._group)
             for info in OPS._map.values()]
    run, fetch = E.Engine.run, E.tensor_to_numpy
    for info, lowering, group in saved:
        info.lowering = timed(lowering, "lower")
        if group is not None:   # the plans' spans stand: no new plan
            info._group = (group[0], timed(group[1], "lower"))
    E.Engine.run = timed(run, "run")
    E.tensor_to_numpy = timed(fetch, "fetch")
    try:
        yield acc
    finally:
        E.Engine.run, E.tensor_to_numpy = run, fetch
        for info, lowering, group in saved:
            info.lowering, info._group = lowering, group


def cache_ab_phase(torch, dev, models):
    """For each (label, program, startup, cost, feed): the training step
    with the engine's plan cache on (one Executor) and with
    use_program_cache=False (another), from two copies of one startup
    scope, in turns (AB_TURNS x on then off, AB_STEPS steps a turn) in
    deterministic mode. The fetched losses must be bit-equal between
    the two, and the cache-on run must reuse its plan at every step but
    the first. Prints steps/s for each and the host ms a step spends in
    Engine.run outside the lowerings; returns the cache-on Executor and
    scope of each model for the host profiles."""
    import paddle_tpu_torch as pt
    kept = {}
    with _deterministic(torch):
        for label, main, startup, cost, feed in models:
            exe0, scope0 = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
            exe0.run(startup, scope=scope0)
            persist = [v.name for v in main.global_block().vars.values()
                       if v.persistable and
                       scope0.find_var(v.name) is not None]
            scopes = {c: _copy_scope(pt, scope0, persist)
                      for c in (True, False)}
            del scope0
            exes = {c: pt.Executor(pt.CUDAPlace(0)) for c in (True, False)}
            losses = {True: [], False: []}
            secs = {True: [], False: []}
            for _ in range(AB_TURNS):
                for cached in (True, False):
                    torch.cuda.synchronize()
                    for _ in range(AB_STEPS):
                        t0 = time.perf_counter()
                        loss, = exes[cached].run(
                            main, feed=feed, fetch_list=[cost],
                            scope=scopes[cached],
                            use_program_cache=cached)
                        secs[cached].append(time.perf_counter() - t0)
                        losses[cached].append(loss)
            n = AB_TURNS * AB_STEPS
            equal = all(np.array_equal(a, b) for a, b in
                        zip(losses[True], losses[False]))
            counters = {c: dict(exes[c]._engine.counters)
                        for c in (True, False)}
            rates = {c: [AB_STEPS / sum(secs[c][t * AB_STEPS:
                                                (t + 1) * AB_STEPS])
                         for t in range(AB_TURNS)] for c in (True, False)}
            print(f"  {label}: steps/s a turn, cache on "
                  f"{', '.join(f'{r:.3f}' for r in rates[True])}; off "
                  f"{', '.join(f'{r:.3f}' for r in rates[False])}; over "
                  f"steps 2-{n}: on "
                  f"{(n - 1) / sum(secs[True][1:]):.3f}, off "
                  f"{(n - 1) / sum(secs[False][1:]):.3f}")
            print(f"  {label}: losses bit-equal over {n} steps: {equal} "
                  f"(last {float(losses[True][-1]):.6f}); counters on "
                  f"{counters[True]}, off {counters[False]}")
            _require(equal, f"{label}: the losses differ with and without "
                            f"the plan cache")
            _require(counters[True]["fast_path_hits"] == n - 1 and
                     counters[True]["traces"] == 1 and
                     counters[False]["fast_path_hits"] == 0 and
                     counters[False]["traces"] == n,
                     f"{label}: plan counters {counters}")
            split = {}
            for cached in (True, False):
                with _lowering_clock() as acc:
                    for _ in range(AB_STEPS):
                        exes[cached].run(main, feed=feed,
                                         fetch_list=[cost],
                                         scope=scopes[cached],
                                         use_program_cache=cached)
                split[cached] = {k: 1e3 * v / AB_STEPS
                                 for k, v in acc.items()}
            print(f"  {label}: host ms a step in Engine.run outside the "
                  f"lowerings and the fetch: on "
                  f"{split[True]['run'] - split[True]['lower'] - split[True]['fetch']:.2f}"
                  f", off "
                  f"{split[False]['run'] - split[False]['lower'] - split[False]['fetch']:.2f}"
                  f" (inside the lowerings: on {split[True]['lower']:.2f}, "
                  f"off {split[False]['lower']:.2f}; fetch, waiting for "
                  f"the card: on {split[True]['fetch']:.2f}, off "
                  f"{split[False]['fetch']:.2f}; clocked over {AB_STEPS} "
                  f"steps each)")
            kept[label] = (exes[True], scopes[True], main, cost, feed)
            del scopes[False], exes[False]
    return kept


def host_profile(torch, label, exe, scope, main, cost, feed):
    """One training step with the plan cache on under cProfile: the top
    10 functions by cumulative host time."""
    import cProfile
    import io
    import pstats
    exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    torch.cuda.synchronize()
    prof.disable()
    out = io.StringIO()
    stats = pstats.Stats(prof, stream=out).sort_stats("cumulative")
    stats.print_stats(10)
    print(f"  {label}: {stats.total_calls} calls, "
          f"{stats.total_tt:.4f} s under cProfile")
    body = out.getvalue().splitlines()
    start = next(i for i, ln in enumerate(body) if "ncalls" in ln)
    for ln in body[start:start + 11]:
        print(f"    {ln.rstrip()}")


def _mnist_program(pt):
    """LeNet with SGD(MNIST_LR) as the port builds it, its test clone and
    the prediction var."""
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, acc, _ = pt.models.lenet_train()
        test_prog = main.clone(for_test=True)
        pt.optimizer.SGD(learning_rate=MNIST_LR).minimize(cost)
    main.random_seed = startup.random_seed = SEED
    pred = [op for op in main.global_block().ops
            if op.type == "softmax"][0].output("Out")[0]
    return main, startup, test_prog, cost, acc, pred


def _mnist_run(torch, pt, kreg, exe, main, feed, cost, acc, scope, floor):
    """MNIST_STEPS steps at PT_KERNEL_MIN_NUMEL=floor (None: the
    default), the launch counts set to 0 just before and read just
    after; returns losses, seconds a step, launches and the fused_sgd
    decisions of each step."""
    old = os.environ.pop("PT_KERNEL_MIN_NUMEL", None)
    if floor is not None:
        os.environ["PT_KERNEL_MIN_NUMEL"] = floor
    try:
        losses, accs, secs, decisions = [], [], [], []
        kreg.reset_counts()
        for _ in range(MNIST_STEPS):
            kreg.reset_stats()
            t0 = time.perf_counter()
            loss, a = exe.run(main, feed=feed, fetch_list=[cost, acc],
                              scope=scope)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(loss))
            accs.append(float(a[0]))
            decisions.append(kreg.dispatch_stats()["per_kernel"]
                             .get("fused_sgd"))
        launches = kreg.launches()
    finally:
        os.environ.pop("PT_KERNEL_MIN_NUMEL", None)
        if old is not None:
            os.environ["PT_KERNEL_MIN_NUMEL"] = old
    return losses, accs, secs, launches, decisions


def mnist_phase(torch, dev, card):
    """LeNet with SGD at B=512 through Executor: 10 steps with the
    default floor and 10 with PT_KERNEL_MIN_NUMEL=1 from the same startup
    state (equal results), then save/load of the persistables and of the
    inference model. Returns the SGD kernel's launches in the floor-1
    run and the LeNet parameter shapes."""
    import tempfile
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg

    main, startup, test_prog, cost, acc, pred = _mnist_program(pt)
    types = [op.type for op in main.global_block().ops]
    shapes = [p.shape for p in main.all_parameters()]
    n_el = sum(int(np.prod(s)) for s in shapes)
    print(f"  LeNet SGD program: {len(types)} ops ({types.count('sgd')} "
          f"sgd, {sum(t.endswith('_grad') for t in types)} grad), "
          f"parameters {shapes} ({n_el} elements)")
    _require(len(types) == 35 and types.count("sgd") == 6 and
             sum(t.endswith("_grad") for t in types) == 13,
             "the LeNet program is not the JAX package's 35 ops")
    rng = np.random.RandomState(0)              # bench.py's batch
    feed = {"img": rng.rand(MNIST_B, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (MNIST_B, 1)).astype(np.int64)}
    exe = pt.Executor(pt.CUDAPlace(0))
    scope0 = pt.Scope()
    exe.run(startup, scope=scope0)
    persist = [v.name for v in main.global_block().vars.values()
               if v.persistable and scope0.find_var(v.name) is not None]
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        runs = {}
        for label, floor in (("default floor", None), ("floor 1", "1")):
            scope = _copy_scope(pt, scope0, persist)
            runs[label] = _mnist_run(torch, pt, kreg, exe, main, feed, cost,
                                     acc, scope, floor) + (scope,)
            losses, accs, secs, launches, dec, _ = runs[label]
            steady = secs[1:]
            print(f"  {label}: losses {', '.join(f'{x:.6f}' for x in losses)}"
                  f"; accuracy {accs[0]:.4f} -> {accs[-1]:.4f}")
            print(f"  {label}: steps/s (steps 2-{MNIST_STEPS}) "
                  f"{len(steady) / sum(steady):.3f}, images/s "
                  f"{MNIST_B * len(steady) / sum(steady):.1f}; step seconds "
                  f"{', '.join(f'{x:.4f}' for x in secs)}; launches "
                  f"{ {k: v for k, v in launches.items() if v} }; fused_sgd "
                  f"decisions a step {dec[0]}")
            _require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                     f"{label}: the LeNet loss did not fall")
            # the engine hands the six sgd ops to one list launch a step
            want = MNIST_STEPS if floor else 0
            _require(launches == {**{k: 0 for k in launches},
                                  "fused_sgd": want},
                     f"{label}: launches {launches}, want {want} fused_sgd "
                     f"and nothing else")
            _require(all(d == ({"custom": 6} if floor else {"lowered": 6})
                         for d in dec), f"{label}: decisions {dec}")
        a, b = runs["default floor"], runs["floor 1"]
        _require(a[0] == b[0], f"losses differ: {a[0]} vs {b[0]}")
        worst = max((b[5].find_var(n).get_tensor().tensor -
                     a[5].find_var(n).get_tensor().tensor).abs().max().item()
                    for n in persist)
        print(f"  floor 1 against the default floor: losses equal, "
              f"parameters max|diff| {worst:.3e}")
        _require(worst == 0.0, "the kernel's parameters differ from the "
                               "plain updates'")
        sgd_launches = b[3]["fused_sgd"]
        profile_step(torch, exe, main, feed, cost, b[5], kernel="sgd")

        # save / load: persistables, then the inference model
        trained = a[5]
        os.makedirs(os.path.join(ROOT, "paddle_tpu_torch", "_build"),
                    exist_ok=True)
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "paddle_tpu_torch", "_build")) as tmp:
            ckpt, model = os.path.join(tmp, "ckpt"), os.path.join(tmp, "m")
            with pt.scope_guard(trained):
                pt.io.save_persistables(exe, ckpt, main)
            loaded = pt.Scope()
            with pt.scope_guard(loaded):
                pt.io.load_persistables(exe, ckpt, main)
            live_out, = exe.run(test_prog, feed=feed, fetch_list=[pred],
                                scope=trained)
            with pt.scope_guard(trained):
                pt.io.save_inference_model(model, ["img"], [pred], exe, main)
            steps = [float(exe.run(main, feed=feed, fetch_list=[cost],
                                   scope=sc)[0]) for sc in (trained, loaded)]
            print(f"  save_persistables / load_persistables "
                  f"({len(os.listdir(ckpt))} files): next step loss {steps[0]:.6f} (trained scope) "
                  f"vs {steps[1]:.6f} (loaded scope)")
            _require(steps[0] == steps[1], "the loaded checkpoint steps "
                                           "differently")
            fresh = pt.Scope()
            with pt.scope_guard(fresh):
                prog, feeds, fetches = pt.io.load_inference_model(model, exe)
            img = {feeds[0]: feed["img"]}
            out, = exe.run(prog, feed=img, fetch_list=fetches, scope=fresh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MNIST_STEPS):
                exe.run(prog, feed=img, fetch_list=fetches, scope=fresh)
            torch.cuda.synchronize()
            secs = (time.perf_counter() - t0) / MNIST_STEPS
            err = float(np.abs(out - live_out).max())
            print(f"  inference model ({len(prog.global_block().ops)} ops) "
                  f"loaded in a fresh scope: output {out.shape}, max|err| vs "
                  f"the live test clone {err:.3e} (atol {INFER_ATOL:g}); "
                  f"{secs:.4f} s a batch, {MNIST_B / secs:.1f} images/s "
                  f"(fetch included)")
            _require(out.shape == (MNIST_B, 10) and
                     bool(np.isfinite(out).all()) and err <= INFER_ATOL,
                     "the loaded inference model disagrees with the live "
                     "test clone")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
    return sgd_launches, shapes


# ---------------------------------------------------------------------------
# dygraph (BASELINE config 5)
# ---------------------------------------------------------------------------

def dygraph_resnet(fluid, stages=(3, 4, 6, 3), width=64, class_dim=1000):
    """bench.py's dygraph ResNet-50 (_DyBottleneck and _dygraph_resnet50:
    bottleneck blocks [3, 4, 6, 3], NCHW, a 7x7 stem of 64 channels, 1000
    classes) as a dygraph Layer of the package `fluid` (any with the
    fluid dygraph API), with the stage counts, the base width (the stem's
    channels; stage i's bottlenecks have width * 2**i) and the classes as
    parameters, so that a test builds a small one from the same code."""
    dygraph = fluid.dygraph
    nn = dygraph.nn

    class Bottleneck(dygraph.Layer):
        def __init__(self, name, ch, stride, shortcut):
            super().__init__(name)
            self.c1 = nn.Conv2D(name + "_1", ch, 1, bias_attr=False)
            self.b1 = nn.BatchNorm(name + "_b1", act="relu")
            self.c2 = nn.Conv2D(name + "_2", ch, 3, stride=stride,
                                padding=1, bias_attr=False)
            self.b2 = nn.BatchNorm(name + "_b2", act="relu")
            self.c3 = nn.Conv2D(name + "_3", ch * 4, 1, bias_attr=False)
            self.b3 = nn.BatchNorm(name + "_b3")
            self.shortcut = shortcut
            if not shortcut:
                self.cs = nn.Conv2D(name + "_s", ch * 4, 1, stride=stride,
                                    bias_attr=False)
                self.bs = nn.BatchNorm(name + "_bs")

        def forward(self, x):
            y = self.b3(self.c3(self.b2(self.c2(self.b1(self.c1(x))))))
            sc = x if self.shortcut else self.bs(self.cs(x))
            return fluid.layers.relu(fluid.layers.elementwise_add(sc, y))

    class ResNet(dygraph.Layer):
        def __init__(self):
            super().__init__("dyres")
            self.stem = nn.Conv2D("stem", width, 7, stride=2, padding=3,
                                  bias_attr=False)
            self.bn = nn.BatchNorm("stem_bn", act="relu")
            self.pool = nn.Pool2D("pool", 3, "max", 2, 1)
            self.blocks = []
            for si, n in enumerate(stages):
                for bi in range(n):
                    blk = Bottleneck(f"s{si}b{bi}", width * 2 ** si,
                                     2 if bi == 0 and si > 0 else 1,
                                     shortcut=bi != 0)
                    setattr(self, f"blk_{si}_{bi}", blk)
                    self.blocks.append(blk)
            self.gap = nn.Pool2D("gap", global_pooling=True,
                                 pool_type="avg")
            self.fc = nn.FC("fc", class_dim)

        def forward(self, x):
            h = self.pool(self.bn(self.stem(x)))
            for blk in self.blocks:
                h = blk(h)
            return self.fc(self.gap(h))

    return ResNet()


def dygraph_step(fluid, net, opt):
    """bench.py's bench_dygraph step: softmax cross-entropy, backward,
    minimize, clear the gradients; returns the loss."""
    def step(x, y):
        logits = net(x)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        loss.backward()
        opt.minimize(loss)
        net.clear_gradients()
        return loss
    return step


def _dy_batch(torch, dev, n):
    """bench.py's bench_dygraph batch: n images of 3x224x224 in [0, 1)
    and 1000-class labels from RandomState(0), on the card."""
    rng = np.random.RandomState(0)
    x = rng.rand(n, 3, RN_HW, RN_HW).astype(np.float32)
    y = rng.randint(0, 1000, (n, 1)).astype(np.int64)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def _dy_guard(pt):
    """dygraph.guard on the card with the tracer's generator seeded
    (from numpy's, as in the JAX package)."""
    np.random.seed(SEED)
    return pt.dygraph.guard(pt.CUDAPlace(0))


def _dy_snapshot(state):
    return {n: vb.value.clone() for n, vb in state.items()}


def _dy_restore(state, snap):
    for n, vb in state.items():
        vb.value = snap[n].clone()


def _dy_loss(loss):
    return float(loss.numpy().reshape(()))


def _dy_eager(pt, step, cap, x, y):
    """One eager step under the capture's AMP guard."""
    with cap._amp_cm():
        return step(pt.dygraph.VarBase(x, stop_gradient=True),
                    pt.dygraph.VarBase(y, stop_gradient=True))


def _dy_discovery(torch, pt, tracer, net, cap, x, y):
    """The capture's discovery on the bench batch: the state it finds,
    created with the values an eager build from the same seed draws,
    batch norms at their initial statistics, velocities zero: no update
    applied. Returns the state's snapshot."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cap._discover_state(tracer, [x, y])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    state = cap._state
    params = {n: vb for n, vb in state.items() if n.startswith("p:")}
    vel = [vb for n, vb in state.items() if n.startswith("a:velocity:")]
    bns = [layer for layer in net.sublayers()
           if isinstance(layer, pt.dygraph.nn.BatchNorm)]
    print(f"  discovery (the step on meta tensors) {secs:.3f} s: "
          f"{len(params)} parameters ({sum(vb.trainable for vb in params.values())} "
          f"trained, {len(bns)} batch norms), {len(vel)} velocities, "
          f"eager_calls {cap.eager_calls}")
    _require(len(params) == 53 + 53 * 4 + 2 and len(vel) == 161 and
             len(bns) == 53, "the dygraph ResNet-50 is not bench.py's")
    _require(all(vb.value.dtype == torch.float32 and
                 vb.value.device.type == "cuda"
                 for vb in state.values()),
             "the state is not float32 on the card")
    _require(all(not v.value.any() for v in vel), "discovery moved a "
                                                  "velocity")
    for bn in bns:
        scale, bias, mean, var = (p.value for p in bn._parameters.values())
        _require(bool((scale == 1).all() and (bias == 0).all() and
                      (mean == 0).all() and (var == 1).all()),
                 f"discovery moved {bn.full_name()}")
    # the same seed's eager build, its parameters made by an evaluation
    # forward of two images: the values discovery created
    with _dy_guard(pt):
        other = dygraph_resnet(pt)
        other.eval()
        with pt.dygraph.no_grad():
            other(pt.dygraph.VarBase(x[:2], stop_gradient=True))
        ref = [p.value for _, p in other._stable_named_parameters()]
    got = [p.value for _, p in net._stable_named_parameters()]
    same = len(ref) == len(got) and all(torch.equal(a, b)
                                        for a, b in zip(got, ref))
    print(f"  discovered parameters equal an eager build's from seed "
          f"{SEED}: {same}")
    _require(same, "discovery's parameters are not the initializers'")
    return _dy_snapshot(state)


def _dy_bench(torch, pt, kreg, cap, x, y):
    """bench.py's bench_dygraph on the capture: DY_STEPS calls (the
    first captures), the windows of 10 and 20 steps, one profiled
    replay. Returns images/s, the busy share and the captured call's
    host ms."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kreg.reset_counts()
    t0 = time.perf_counter()
    losses = [_dy_loss(cap(x, y))]
    first = time.perf_counter() - t0
    captured = kreg.launches()
    losses += [_dy_loss(cap(x, y)) for _ in range(DY_STEPS - 1)]
    replays = sum(getattr(e, "replays", 0) for e in cap._cache.values())
    print(f"  first call (two warm-up steps on a side stream, the capture "
          f"under sync debug mode 'error': no host sync in the step, one "
          f"replay) {first:.3f} s; launches of the port's kernels "
          f"captured: {({k: v for k, v in captured.items() if v}) or 'none'}")
    print(f"  losses: {', '.join(f'{v:.6f}' for v in losses)}")
    print(f"  captured_calls {cap.captured_calls}, graph replays {replays}, "
          f"signatures {len(cap._cache)}, eager_calls {cap.eager_calls}")
    _require(not any(captured.values()),
             "the captured Momentum step launched a kernel of the port")
    # at bench.py's lr 0.1 the loss of this initialization falls for
    # two steps and then rises above its first value, as graph mode's
    # does from the same parameters (PERF.md §6): the check is that
    # it fell below the first loss
    _require(all(np.isfinite(losses)) and min(losses[1:]) < losses[0],
             f"the captured loss did not fall in {DY_STEPS} steps")
    _require(cap.captured_calls == replays == DY_STEPS and
             len(cap._cache) == 1 and cap.eager_calls == 1,
             "not one graph replay a call")
    _require(all(vb.value.dtype == torch.float32
                 for vb in cap._state.values()),
             "a master parameter left float32")

    for _ in range(2):
        cap(x, y)
    _dy_loss(cap(x, y))

    def window(n):
        t0 = time.perf_counter()
        for _ in range(n):
            loss = cap(x, y)
        _dy_loss(loss)                      # the fetch fences
        return time.perf_counter() - t0
    t1, t2 = window(10), window(20)
    sps = 10 / (t2 - t1) if t2 - t1 > 0.02 * t2 else 30 / (t1 + t2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cap(x, y)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cap(x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  images/s: windows of 10 and 20 steps {DY_B * 10 / t1:.1f} and "
          f"{DY_B * 20 / t2:.1f}; bench.py's rate {DY_B * sps:.1f} "
          f"({sps:.3f} steps/s); host {host_ms:.3f} ms a captured call")
    print(f"  profiled replay: wall {wall:.4f} s, device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f} %), {sum(e.count for e in kernels)} "
          f"kernels; peak memory allocated {peak:.3f} GB")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}")
    return DY_B * sps, busy / wall, host_ms


def _dy_turns(torch, pt, step, cap, x, y):
    """Eager and captured steps in turns: images/s and host ms a step of
    each (an eager step is bound by the host)."""
    rates = {"eager": [], "captured": []}
    host = {"eager": [], "captured": []}
    for _ in range(DY_TURNS):
        for mode in ("eager", "captured"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DY_TURN_STEPS):
                loss = _dy_eager(pt, step, cap, x, y) if mode == "eager" \
                    else cap(x, y)
            enq = time.perf_counter() - t0
            _dy_loss(loss)
            secs = time.perf_counter() - t0
            rates[mode].append(DY_B * DY_TURN_STEPS / secs)
            host[mode].append(enq * 1e3 / DY_TURN_STEPS)
    for mode in rates:
        print(f"  {mode}: images/s a turn "
              f"{', '.join(f'{r:.1f}' for r in rates[mode])} (median "
              f"{np.median(rates[mode]):.1f}); host ms a step before the "
              f"fetch {', '.join(f'{h:.1f}' for h in host[mode])}")
    return {m: float(np.median(r)) for m, r in rates.items()}


def _dy_compare(torch, pt, step, opt, snap, state, x, y):
    """DY_CMP_STEPS captured steps (a new capture) and DY_CMP_STEPS
    eager ones from the same initial state, in deterministic mode: equal
    losses and state, bit for bit."""
    with _deterministic(torch):
        _dy_restore(state, snap)
        cap = pt.dygraph.jit.capture(step, optimizer=opt, amp=True)
        lc = [_dy_loss(cap(x, y)) for _ in range(DY_CMP_STEPS)]
        sc = _dy_snapshot(state)
        _dy_restore(state, snap)
        le = [_dy_loss(_dy_eager(pt, step, cap, x, y))
              for _ in range(DY_CMP_STEPS)]
        se = _dy_snapshot(state)
        del cap
    diff = max(float((sc[n].double() - se[n].double()).abs().max())
               for n in state)
    differ = sum(not torch.equal(sc[n], se[n]) for n in state)
    print(f"  deterministic, {DY_CMP_STEPS} steps from one state: captured "
          f"losses {', '.join(f'{v:.6f}' for v in lc)}; eager "
          f"{', '.join(f'{v:.6f}' for v in le)}; {differ} of {len(state)} "
          f"state tensors differ, max|diff| {diff:.3e} (bound 0)")
    _require(lc == le and differ == 0,
             "the captured steps are not the eager steps")


def _dy_against_graph(torch, pt, dev):
    """The dygraph ResNet-50's first loss against graph-mode ResNet-50's
    (models/resnet.py) on the same parameters, float32, B=DY_GRAPH_B.
    The parameters map by creation order, which both builds share
    (stem, then each bottleneck's 1x1, 3x3, 1x1 and shortcut convolution
    each followed by its batch norm, then the fc); a parameter whose
    shape differs fails the step."""
    x, y = _dy_batch(torch, dev, DY_GRAPH_B)
    with _deterministic(torch):
        with _dy_guard(pt):
            tracer = pt.framework._dygraph_tracer()
            net = dygraph_resnet(pt)
            with pt.dygraph.no_grad():
                loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
                    net(pt.dygraph.VarBase(x, stop_gradient=True)),
                    pt.dygraph.VarBase(y, stop_gradient=True)))
            dy_loss = _dy_loss(loss)
            dy = list(tracer._params.values())
        pt.framework.unique_name.reset()
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            cost, _, _ = pt.models.resnet_train(depth=50)
        exe = pt.Executor(pt.CUDAPlace(0))
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        graph = main.all_parameters()
        differ = [(i, p.name, tuple(p.shape), d.shape)
                  for i, (p, d) in enumerate(zip(graph, dy))
                  if tuple(p.shape) != d.shape]
        print(f"  dygraph against graph mode: {len(dy)} parameters against "
              f"{len(graph)}, {len(differ)} shapes differ {differ[:4]}")
        _require(len(dy) == len(graph) and not differ,
                 "the dygraph and graph-mode ResNet-50 differ")
        for p, d in zip(graph, dy):
            scope.var(p.name).get_tensor().set_tensor(d.value.clone())
        g_loss = float(exe.run(main, feed={"image": x.cpu().numpy(),
                                           "label": y.cpu().numpy()},
                               fetch_list=[cost], scope=scope)[0])
    err = abs(dy_loss - g_loss) / abs(g_loss)
    print(f"  first loss, float32, B={DY_GRAPH_B}: dygraph {dy_loss:.7f}, "
          f"graph mode {g_loss:.7f}, rel err {err:.3e} (bound "
          f"{DY_GRAPH_RTOL:g})")
    _require(err <= DY_GRAPH_RTOL, "dygraph and graph mode disagree")


def _dy_adam(torch, pt, kreg, dev):
    """DY_ADAM_STEPS eager Adam steps of the dygraph ResNet-50 in
    float32 at B=DY_ADAM_B: fused_adam launched as the registry's rules
    predict (one list launch a step for the parameters of at least
    PT_KERNEL_MIN_NUMEL elements, a launch taking up to 512), the
    parameters bit-equal to the same steps under plain_reference() in
    deterministic mode. Returns fused_adam's launches."""
    x, y = _dy_batch(torch, dev, DY_ADAM_B)
    xv = pt.dygraph.VarBase(x, stop_gradient=True)
    yv = pt.dygraph.VarBase(y, stop_gradient=True)
    with _deterministic(torch), \
            _dy_guard(pt):
        tracer = pt.framework._dygraph_tracer()
        net = dygraph_resnet(pt)
        net.eval()
        with pt.dygraph.no_grad():
            net(pt.dygraph.VarBase(x[:2], stop_gradient=True))
        net.train()
        p0 = _dy_snapshot(tracer._params)
        routed = [p for p in tracer._params.values() if p.trainable and
                  p.value.numel() >= kreg.min_numel()]
        want = DY_ADAM_STEPS * -(-len(routed) // 512)
        runs = {}
        for mode in ("kernel", "plain"):
            _dy_restore(tracer._params, p0)
            opt = pt.optimizer.AdamOptimizer(DY_ADAM_LR)
            step = dygraph_step(pt, net, opt)
            kreg.reset_counts()
            kreg.reset_stats()
            with (kreg.plain_reference() if mode == "plain"
                  else contextlib.nullcontext()):
                losses = [_dy_loss(step(xv, yv))
                          for _ in range(DY_ADAM_STEPS)]
            runs[mode] = (losses, _dy_snapshot(tracer._params),
                          kreg.launches()["fused_adam"],
                          kreg.dispatch_stats()["per_kernel"]
                          .get("fused_adam", {}))
    (lk, sk, nk, dk), (lp, sp, n_plain, _) = runs["kernel"], runs["plain"]
    differ = sum(not torch.equal(sk[n], sp[n]) for n in sk)
    print(f"  eager Adam, float32, B={DY_ADAM_B}: {len(routed)} of "
          f"{len(p0)} parameters reach PT_KERNEL_MIN_NUMEL="
          f"{kreg.min_numel()}; fused_adam launches {nk} in "
          f"{DY_ADAM_STEPS} steps (predicted {want}), dispatch {dk}; "
          f"losses {lk} (kernel) and {lp} (plain_reference, {n_plain} "
          f"launches); {differ} of {len(sk)} tensors differ (bound 0)")
    _require(len(routed) > 0 and nk == want and
             dk.get("custom") == DY_ADAM_STEPS * len(routed),
             "fused_adam did not launch as the registry predicts")
    _require(n_plain == 0 and lk == lp and differ == 0,
             "the Adam kernel's steps are not plain_reference()'s")
    return nk


def dygraph_phase(torch, dev):
    """BASELINE config 5 (bench.py's bench_dygraph): the dygraph
    ResNet-50 captured at B=128 under bf16 AMP with Momentum, eager
    against captured, dygraph against graph mode, eager Adam through the
    kernel. Returns fused_adam's launches and the rates."""
    import gc
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg

    x, y = _dy_batch(torch, dev, DY_B)
    with _dy_guard(pt):
        tracer = pt.framework._dygraph_tracer()
        net = dygraph_resnet(pt)
        opt = pt.optimizer.MomentumOptimizer(RN_LR, RN_MU)
        step = dygraph_step(pt, net, opt)
        cap = pt.dygraph.jit.capture(step, optimizer=opt, amp=True)
        snap = _dy_discovery(torch, pt, tracer, net, cap, x, y)
        state = cap._state
        rate, busy, host_ms = _dy_bench(torch, pt, kreg, cap, x, y)
        turns = _dy_turns(torch, pt, step, cap, x, y)
        del cap
        gc.collect()
        torch.cuda.empty_cache()
        _dy_compare(torch, pt, step, opt, snap, state, x, y)
    del net, opt, step, snap, state, tracer
    gc.collect()
    torch.cuda.empty_cache()
    _dy_against_graph(torch, pt, dev)
    launches = _dy_adam(torch, pt, kreg, dev)
    torch.cuda.empty_cache()
    return launches, {"images_s": rate, "busy": busy, "host_ms": host_ms,
                      **turns}


# ---------------------------------------------------------------------------
# graph capture: Executor.run as one CUDA graph replay a run
# ---------------------------------------------------------------------------

def _graph_pool_gb(torch):
    """(allocated, reserved) GB of the caching allocator's CUDA-graph
    private pools (the segments of a pool other than the default one)."""
    segs = [s for s in torch.cuda.memory_snapshot()
            if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0)]
    return (sum(s["allocated_size"] for s in segs) / 1e9,
            sum(s["total_size"] for s in segs) / 1e9)


def _counters(exe):
    c = exe._engine.counters
    return {k: c[k] for k in ("runs", "captures", "replays", "eager_runs",
                              "fast_path_hits", "traces")}


@contextlib.contextmanager
def _capture_clock():
    """Host seconds of the parts of a capture: the capture rule on meta
    tensors, the warm-up runs, gc.collect and the capture itself
    (gc.collect and the allocator's empty_cache run inside it)."""
    import functools
    import gc
    from paddle_tpu_torch.core import cuda_graph, engine as E
    acc = {"rule": 0.0, "warm_up": 0.0, "gc": 0.0, "capture": 0.0}
    saved = [(E, "capture_blocker", "rule"), (cuda_graph, "warm_up",
             "warm_up"), (cuda_graph, "capture", "capture"),
             (gc, "collect", "gc")]

    def timed(fn, key):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[key] += time.perf_counter() - t0
        return wrapper

    old = [getattr(mod, name) for mod, name, _ in saved]
    for (mod, name, key), fn in zip(saved, old):
        setattr(mod, name, timed(fn, key))
    try:
        yield acc
    finally:
        for (mod, name, _), fn in zip(saved, old):
            setattr(mod, name, fn)


def _cap_first_runs(torch, label, exe, main, feed, fetch, scope):
    """A plan's first run (eager) and its second (the capture and a
    replay), each to its fetch, with the capture's parts clocked."""
    secs = []
    with _capture_clock() as acc:
        for _ in range(2):
            t0 = time.perf_counter()
            _cap_run(exe, main, feed, fetch, scope)
            secs.append(time.perf_counter() - t0)
    print(f"  {label}: first run (eager) {secs[0]:.3f} s; second run "
          f"{secs[1]:.3f} s: the capture rule {acc['rule']:.3f}, warm-up "
          f"{acc['warm_up']:.3f}, capture {acc['capture']:.3f} (of it "
          f"gc.collect {acc['gc']:.3f})")


def _cap_run(exe, main, feed, fetch, scope, cached=True, numpy=True):
    return exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                   use_program_cache=cached, return_numpy=numpy)


def _cap_turns(torch, label, units, per_step, modes):
    """Runs of each mode in CAP_TURNS turns of CAP_TURN_STEPS steps (the
    order alternating between turns): `units` a second (units a step
    per_step), each turn ending at its last step's fetched loss, and the
    host ms of a run before that fetch (the enqueue). modes: name ->
    step() returning the fetched value. Returns the median rates."""
    rates = {m: [] for m in modes}
    host = {m: [] for m in modes}
    for turn in range(CAP_TURNS):
        for m in (list(modes) if turn % 2 == 0 else list(modes)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enq = 0.0
            for _ in range(CAP_TURN_STEPS):
                t1 = time.perf_counter()
                out = modes[m]()
                enq += time.perf_counter() - t1
            float(out.reshape(-1)[0])          # the fetch fences
            secs = time.perf_counter() - t0
            rates[m].append(per_step * CAP_TURN_STEPS / secs)
            host[m].append(enq * 1e3 / CAP_TURN_STEPS)
    for m in modes:
        print(f"  {label} {m}: {units} a turn "
              f"{', '.join(f'{r:.1f}' for r in rates[m])} (median "
              f"{np.median(rates[m]):.1f}); host ms a run "
              f"{', '.join(f'{h:.2f}' for h in host[m])}")
    return {m: float(np.median(r)) for m, r in rates.items()}


def _cap_compare(torch, pt, kreg, label, main, startup, feed, fetch, steps,
                 want_launches=None, env=None, fetched=None):
    """steps + 1 runs with the plan cache (the first eager, the second
    captures, the rest replay) and steps + 1 with use_program_cache=False
    from copies of one startup scope, with the same run indices, in
    deterministic mode: the fetches of every run and every persistable
    at the end must be equal bit for bit; with want_launches, the launch
    counts of every run too. Returns the captured engine's counters; the
    cached runs' fetches are appended to `fetched` where it is a list."""
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        with _deterministic(torch):
            init = pt.Scope()
            pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init)
            persist = [v.name for v in main.global_block().vars.values()
                       if v.persistable and init.find_var(v.name)
                       is not None]
            outs, counts, state, counters = {}, {}, {}, {}
            for cached in (True, False):
                exe = pt.Executor(pt.CUDAPlace(0))
                scope = _copy_scope(pt, init, persist)
                outs[cached], counts[cached] = [], []
                for _ in range(steps + 1):
                    kreg.reset_counts()
                    outs[cached].append(_cap_run(exe, main, feed, fetch,
                                                 scope, cached))
                    counts[cached].append(kreg.launches())
                state[cached] = {n: scope.find_var(n).get_tensor().tensor
                                 .clone() for n in persist}
                counters[cached] = _counters(exe)
                exe.close()
                del exe, scope
            del init
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    if fetched is not None:
        fetched.extend(outs[True])
    equal_out = all(np.array_equal(a, b) for x, y in
                    zip(outs[True], outs[False]) for a, b in zip(x, y))
    equal_state = all(torch.equal(state[True][n], state[False][n])
                      for n in state[True])
    c = counters[True]
    print(f"  {label}: {steps + 1} runs with the plan cache ({c['captures']} "
          f"capture, {c['replays']} replays, {c['eager_runs']} eager) and "
          f"{steps + 1} eager, deterministic mode: fetches bit-equal "
          f"{equal_out}, {len(state[True])} persistables bit-equal "
          f"{equal_state}; first fetch {float(outs[True][0][0]):.6f}, "
          f"last {float(outs[True][-1][0]):.6f}")
    _require(equal_out and equal_state,
             f"{label}: captured runs differ from eager runs")
    _require(c["captures"] == 1 and c["replays"] == steps and
             c["eager_runs"] == 1 and
             counters[False]["eager_runs"] == steps + 1,
             f"{label}: counters {counters}")
    _require(counts[True] == counts[False],
             f"{label}: launches captured {counts[True]} vs eager "
             f"{counts[False]}")
    if want_launches is not None:
        for i, cnt in enumerate(counts[True]):
            _require({k: v for k, v in cnt.items() if v} == want_launches,
                     f"{label}: run {i + 1} launched {cnt}, want "
                     f"{want_launches}")
    return c


def _cap_measure(torch, pt, label, exe, main, scope, fetch, modes, units,
                 per_step):
    """The captured plan's numbers: the turns of `modes`, a profiled
    replay (busy share, top kernels), the host ms of a captured run
    (return_numpy=False: the enqueue), peak memory and the graph pool.
    `modes["captured"]` must be a replay."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates = _cap_turns(torch, label, units, per_step, modes)
    peak = torch.cuda.max_memory_allocated() / 1e9
    pool = _graph_pool_gb(torch)
    feed = modes.feed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
            return_numpy=False)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    print(f"  {label}: host ms of one captured run before its fetch "
          f"{host_ms:.3f}; peak memory allocated {peak:.3f} GB; graph "
          f"pools after the turns: {pool[0]:.3f} GB allocated, "
          f"{pool[1]:.3f} GB reserved")
    busy = profile_step(torch, exe, main, feed, fetch[0], scope,
                        kernel=None)
    print(f"  {label}: counters {_counters(exe)}")
    return {**rates, "busy": busy, "host_ms": host_ms, "peak_gb": peak,
            "pool_gb": pool}


class _Modes(dict):
    """name -> step(); `feed` is the captured mode's feed."""
    feed = None


def _cap_resnet(torch, pt, kreg, dev):
    """ResNet-50 (BASELINE config 2), B=128, bf16 AMP, Momentum: captured
    with the numpy batch and with the batch on the card, eager
    (use_program_cache=False) in turns; 5 captured runs against 5 eager
    ones bit for bit; no launch of the port's kernels."""
    main, startup, cost, acc = _build_resnet(pt)
    feed = _resnet_feed()
    card = {k: torch.from_numpy(v).to(dev) for k, v in feed.items()}
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
    exe.run(startup, scope=scope)
    kreg.reset_counts()
    for f, kind in ((feed, "numpy batch"), (card, "batch on the card")):
        _cap_first_runs(torch, f"ResNet-50, {kind}", exe, main, f, [cost],
                        scope)
    modes = _Modes(
        captured_card=lambda: _cap_run(exe, main, card, [cost], scope,
                                       numpy=False)[0],
        captured_numpy=lambda: _cap_run(exe, main, feed, [cost], scope,
                                        numpy=False)[0],
        eager_numpy=lambda: _cap_run(exe, main, feed, [cost], scope,
                                     False, False)[0])
    modes.feed = card
    m = _cap_measure(torch, pt, "ResNet-50", exe, main, scope, [cost],
                     modes, "images/s", RN_B)
    launches = kreg.launches()
    _require(not any(launches.values()),
             f"the captured ResNet-50 launched {launches}")
    c = _counters(exe)
    _require(c["captures"] == 2 and c["replays"] >= 5,
             f"ResNet-50: counters {c}")
    exe.close()
    del exe, scope, card
    gc_cuda(torch)
    _cap_compare(torch, pt, kreg, "ResNet-50", main, startup, feed,
                 [cost, acc], CAP_CMP_STEPS)
    gc_cuda(torch)
    return m


def gc_cuda(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _cap_transformer(torch, pt, kreg, dev, built):
    """Transformer-base training (B=96, S=128, dropout 0.1, bf16 AMP,
    Adam): captured and eager in turns; 5 captured runs against 5 eager
    ones with the same run indices, dropout on, bit for bit, each with
    18 forward, 18 dq, 18 dk/dv attention launches and 1 Adam launch."""
    from paddle_tpu_torch.models import transformer as T
    cfg, main, startup, cost = built
    feed = _training_feed(T, cfg)
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
    exe.run(startup, scope=scope)
    _cap_first_runs(torch, "Transformer-base training", exe, main, feed,
                    [cost], scope)
    modes = _Modes(
        captured=lambda: _cap_run(exe, main, feed, [cost], scope,
                                  numpy=False)[0],
        eager=lambda: _cap_run(exe, main, feed, [cost], scope, False,
                               False)[0])
    modes.feed = feed
    m = _cap_measure(torch, pt, "Transformer-base training", exe, main,
                     scope, [cost], modes, "steps/s", 1)
    exe.close()
    del exe, scope
    gc_cuda(torch)
    want = {"flash_attention_fwd": 18, "flash_attention_bwd_dq": 18,
            "flash_attention_bwd_dkv": 18, "flash_attention_fwd_sm90": 18,
            "flash_attention_bwd_dq_sm90": 18,
            "flash_attention_bwd_dkv_sm90": 18, "fused_adam": 1}
    _cap_compare(torch, pt, kreg, "Transformer-base training", main,
                 startup, feed, [cost], CAP_CMP_STEPS, want)
    gc_cuda(torch)
    tokens = int(feed["lbl_w"].sum())
    print(f"  Transformer-base training: non-pad target tokens/s "
          f"captured {tokens * m['captured']:.1f}, eager "
          f"{tokens * m['eager']:.1f}")
    return m


def _cap_serving(torch, pt, kreg, dev):
    """Transformer-base serving (B=32, S=256) in float32 and with every
    mul in the int8 GEMM kernel: captured runs (one replay a forward)
    against the eager forward, within LOGITS_ATOL, and tokens/s of both
    in turns."""
    from paddle_tpu_torch.models import transformer as T
    cfg = T.transformer_base(fuse_attention=True)
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, logits, _ = T.transformer_train(cfg, is_test=True)
    startup.random_seed = SEED
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
    exe.run(startup, scope=scope)
    B, S = 32, 256
    rng = np.random.default_rng(SEED)
    feed = T.make_batch(cfg, B, S, S, rng=rng,
                        src_lens=rng.integers(S // 2, S + 1, B),
                        trg_lens=rng.integers(S // 2, S + 1, B))
    tokens = int(feed["lbl_w"].sum() + (feed["src_bias"] == 0).sum())
    out = {}
    for mode in ("float32", "int8"):
        if mode == "int8":
            os.environ["PT_KERNEL_QUANT_MATMUL"] = "int8"
        try:
            kreg.reset_counts()
            runs = [_cap_run(exe, main, feed, [logits, cost], scope)
                    for _ in range(3)]
            eager = _cap_run(exe, main, feed, [logits, cost], scope, False)
            counts = kreg.launches()
            err = max(float(np.abs(r[0] - eager[0]).max()) for r in runs)
            cerr = max(abs(float(r[1]) - float(eager[1])) /
                       abs(float(eager[1])) for r in runs)
            print(f"  serving {mode}: captured forwards vs the eager one: "
                  f"logits max|err| {err:.3e} (atol {LOGITS_ATOL:g}), cost "
                  f"rel err {cerr:.3e} (rtol {COST_RTOL:g}); launches in "
                  f"3 captured + 1 eager forwards "
                  f"{ {k: v for k, v in counts.items() if v} }")
            _require(err <= LOGITS_ATOL and cerr <= COST_RTOL,
                     f"serving {mode}: captured disagrees with eager")
            _require(counts["flash_attention_fwd_f32_sm90"] == 18 * 4 and
                     (mode == "float32" or
                      counts["quantized_matmul_int8"] == SERVE_MULS * 4),
                     f"serving {mode}: launches {counts}")
            modes = _Modes(
                captured=lambda: _cap_run(exe, main, feed, [cost], scope,
                                          numpy=False)[0],
                eager=lambda: _cap_run(exe, main, feed, [cost], scope,
                                       False, False)[0])
            modes.feed = feed
            for _ in range(2):      # the cost-only plan: eager, capture
                _cap_run(exe, main, feed, [cost], scope)
            m = _cap_measure(torch, pt, f"serving {mode}", exe, main,
                             scope, [cost], modes, "tokens/s", tokens)
            out[mode] = {**m, "err": err}
        finally:
            os.environ.pop("PT_KERNEL_QUANT_MATMUL", None)
    exe.close()
    del exe, scope
    gc_cuda(torch)
    return out


def _cap_lenet(torch, pt, kreg):
    """LeNet at B=512 with SGD through the fused_sgd list kernel
    (PT_KERNEL_MIN_NUMEL=1): 5 captured runs against 5 eager ones bit for
    bit, one launch a run; then iterations=3 (the scope after one call
    equals the scope after three single runs) and a scope write between
    two replays (load_params_from_numpy), which the next replay reads."""
    from paddle_tpu_torch.io import load_params_from_numpy
    main, startup, _, cost, acc, _ = _mnist_program(pt)
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(MNIST_B, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (MNIST_B, 1)).astype(np.int64)}
    _cap_compare(torch, pt, kreg, "LeNet SGD (PT_KERNEL_MIN_NUMEL=1)",
                 main, startup, feed, [cost, acc], CAP_CMP_STEPS,
                 {"fused_sgd": 1}, env={"PT_KERNEL_MIN_NUMEL": "1"})
    with _deterministic(torch):
        init = pt.Scope()
        pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init)
        persist = [v.name for v in main.global_block().vars.values()
                   if v.persistable and init.find_var(v.name) is not None]
        scopes = [_copy_scope(pt, init, persist) for _ in range(4)]
        exes = [pt.Executor(pt.CUDAPlace(0)) for _ in range(4)]
        for exe, sc in zip(exes, scopes):
            _cap_run(exe, main, feed, [cost], sc)
        # iterations=3 in one call against three single runs (replays)
        exes[0]._engine.run(main, scopes[0], pt.CUDAPlace(0), feed,
                            [cost.name], iterations=3)
        for _ in range(3):
            _cap_run(exes[1], main, feed, [cost], scopes[1])
        equal = all(torch.equal(scopes[0].find_var(n).get_tensor().tensor,
                                scopes[1].find_var(n).get_tensor().tensor)
                    for n in persist)
        c0, c1 = _counters(exes[0]), _counters(exes[1])
        print(f"  LeNet iterations=3 in one call vs three single runs: "
              f"{len(persist)} persistables bit-equal {equal}; counters "
              f"{c0} vs {c1}")
        _require(equal and c0["replays"] == c1["replays"] == 3,
                 "iterations=3 disagrees with three single runs")
        # a scope write between two replays: captured and eager alike
        w = main.all_parameters()[0].name
        new_w = np.full(tuple(scopes[2].find_var(w).get_tensor().tensor
                              .shape), 0.01, np.float32)
        losses = {}
        for i, cached in ((2, True), (3, False)):
            out = [_cap_run(exes[i], main, feed, [cost], scopes[i],
                            cached)[0] for _ in range(2)]
            load_params_from_numpy(scopes[i], {w: new_w}, pt.CUDAPlace(0))
            out += [_cap_run(exes[i], main, feed, [cost], scopes[i],
                             cached)[0] for _ in range(2)]
            losses[cached] = [float(x) for x in out]
        print(f"  LeNet scope write between replays: losses captured "
              f"{losses[True]}, eager {losses[False]}; counters "
              f"{_counters(exes[2])}")
        _require(losses[True] == losses[False] and
                 losses[True][2] != losses[True][1] and
                 _counters(exes[2])["captures"] == 1,
                 "a scope write between replays did not take effect")
        for exe in exes:
            exe.close()
    gc_cuda(torch)


def _cap_ctr(torch, pt, kreg):
    """Wide&Deep with dense and with sparse embedding gradients at
    bench.py's size: three runs each; captured or eager as the capture
    rule decides, and why."""
    for kind in ("wide_deep", "sparse"):
        main, startup, cost, feeds = _build_ctr(pt, kind)
        feed = _ctr_feed(feeds)
        exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
        exe.run(startup, scope=scope)
        losses = [float(_cap_run(exe, main, feed, [cost], scope)[0])
                  for _ in range(3)]
        c = _counters(exe)
        reasons = list(exe._engine.eager_reasons.values())
        print(f"  CTR {kind}: losses {', '.join(f'{x:.6f}' for x in losses)}"
              f"; {'captured' if c['captures'] else 'eager'} "
              f"({'the capture rule admits the block' if not reasons else 'the capture rule keeps it eager: ' + reasons[0]}); "
              f"counters {c}")
        _require(all(np.isfinite(losses)) and len(set(losses)) == 3,
                 f"CTR {kind}: losses {losses}")
        _require(c["captures"] + len(reasons) == 1,
                 f"CTR {kind}: neither captured nor refused: {c}")
        exe.close()
        del exe, scope
    gc_cuda(torch)


def capture_phase(torch, dev, built):
    """Executor.run as one CUDA graph replay a run (core/engine.py
    _Captured) on every main path: ResNet-50, Transformer-base training
    and serving, LeNet (iterations=3, a scope write), the CTR models.
    Returns the measured numbers."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    t0 = time.perf_counter()
    out = {"resnet": _cap_resnet(torch, pt, kreg, dev),
           "training": _cap_transformer(torch, pt, kreg, dev, built),
           "serving": _cap_serving(torch, pt, kreg, dev)}
    _cap_lenet(torch, pt, kreg)
    _cap_ctr(torch, pt, kreg)
    print(f"  graph capture phase: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# [serving phase]: the book LM through the serving engine
# ---------------------------------------------------------------------------

# Transformer-base's decoder widths and depth (bench.py:828-840), the book
# LM single-head as the JAX package builds it
BOOK = {"vocab": 32000, "hidden": 512, "num_layers": 6, "max_len": 1024}
BOOK_BUCKETS = {"batch": 128, "prefill_lens": (64, 128, 256),
                "cache_lens": (128, 256, 512)}
BOOK_REQUESTS = 512        # the float32 burst
BOOK_MODE_REQUESTS = 128   # the burst in each GEMM mode
BOOK_PARITY = 4            # requests held to reference_generate in full
BOOK_PROFILED_STEPS = 20
# the mul ops of one prefill or decode dispatch: 6 fc a layer, the head
BOOK_MULS = 6 * BOOK["num_layers"] + 1
# a decode dispatch's GEMMs, (M, K, N, ops a dispatch)
BOOK_GEMMS = ((128, 512, 512, 4 * BOOK["num_layers"]),
              (128, 512, 1024, BOOK["num_layers"]),
              (128, 1024, 512, BOOK["num_layers"]),
              (128, 512, 32000, 1))
_BOOK_KERNEL = {"bf16": "quantized_matmul_bf16",
                "int8": "quantized_matmul_int8", "tuned": "tuned_matmul_sm90"}


def _book_specs(n, seed=0):
    """n (prompt, max_new_tokens) pairs from RandomState(seed): prompt
    lengths uniform in 8-256, ids in 1..31999, max_new_tokens uniform in
    32-128 (every context fits the 512 bucket)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        length = int(rs.randint(8, 257))
        prompt = rs.randint(1, BOOK["vocab"], length).tolist()
        out.append((prompt, int(rs.randint(32, 129))))
    return out


def _book_model(torch, pt, S, d):
    """The book LM initialized on the card from SEED, exported to d and
    loaded there."""
    pt.framework.unique_name.reset()
    pre, dec, startup, meta = S.build_book_lm(**BOOK)
    startup.random_seed = SEED
    bk = S.BucketSpec(**BOOK_BUCKETS)
    with pt.scope_guard(pt.Scope()):
        exe = pt.Executor()
        exe.run(startup)
        S.export_serving_model(d, exe, pre, dec, meta, buckets=bk)
        exe.close()
    return S.load_serving_model(d)


def _book_engine(S, model, n):
    """A ServingEngine whose queue and default tenant take n requests at
    once (the reference's default tenant runs 8 at a time), so that the
    batch and the KV cache bound the occupancy."""
    return S.ServingEngine(model, max_queue=n, quotas={
        "default": S.TenantQuota(max_concurrent=n)})


def _book_burst(torch, S, model, specs):
    """specs submitted at once to a new engine (_book_engine), then
    step() until drained; every dispatch timed on the host's clock (to
    its logits' host copy, so the device's time is in it), by bucket.
    Returns the engine, the requests, the wall seconds, the steps and
    the times."""
    eng = _book_engine(S, model, len(specs))
    times = {"prefill": {}, "decode": {}}

    def timed(kind, fn, bucket):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            times[kind].setdefault(bucket(a), []).append(
                (time.perf_counter() - t0) * 1e3)
            return out
        return call

    model.prefill_rows = timed("prefill", model.prefill_rows,
                               lambda a: a[0].shape[1])
    model.decode = timed("decode", model.decode,
                         lambda a: a[2].shape[2] - 1)
    try:
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in specs]
        steps = 0
        while eng.pending():
            eng.step()
            steps += 1
        wall = time.perf_counter() - t0
    finally:
        del model.prefill_rows, model.decode
    _require(all(r.status == S.STATUS_OK for r in reqs),
             f"requests not ok: "
             f"{sorted({r.status for r in reqs if r.status != 'ok'})}")
    tokens = sum(len(r.tokens) for r in reqs)
    occ = list(eng.occupancy_history)
    print(f"  {len(reqs)} requests, {tokens} generated tokens in "
          f"{wall:.3f} s ({steps} steps): {tokens / wall:.1f} tokens/s, "
          f"{len(reqs) / wall:.2f} requests/s (logits' host copies "
          f"included); decode occupancy mean {np.mean(occ):.1f}, max "
          f"{max(occ)} of {model.buckets.batch}; "
          f"{sum(r.status == S.STATUS_OK for r in reqs)} ok; pages in use "
          f"after the drain {eng.kv.pages_in_use}")
    for kind in ("prefill", "decode"):
        for b, ms in sorted(times[kind].items()):
            print(f"    {kind} bucket {b}: {len(ms)} dispatches, median "
                  f"{np.median(ms):.3f} ms, p99 "
                  f"{np.percentile(ms, 99):.3f} ms")
    _require(eng.kv.pages_in_use == 0, "pages left in use after the drain")
    return eng, reqs, wall, steps, times


def _book_busy(torch, S, model, specs):
    """The device-busy share of BOOK_PROFILED_STEPS decode steps of a
    full batch under torch.profiler, and its top kernels."""
    from torch.profiler import ProfilerActivity, profile
    eng = _book_engine(S, model, len(specs))
    for p, _ in specs:
        eng.submit(p, max_new_tokens=BOOK_PROFILED_STEPS + 8)
    while eng._queue or eng._admitted:
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(BOOK_PROFILED_STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"  {BOOK_PROFILED_STEPS} profiled decode steps of "
          f"{len(eng._running)} sequences: wall {wall:.4f} s, device busy "
          f"{busy:.4f} s ({100 * busy / wall:.1f} %), "
          f"{1e3 * busy / BOOK_PROFILED_STEPS:.3f} ms of device time a "
          f"step")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:10]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}")
    while eng.pending():
        eng.step()
    return busy / wall


def _book_dispatches(S, model, prompts):
    """One prefill dispatch of up to a batch of prompts at the 256
    bucket, then one decode dispatch on its k/v (the 256 cache bucket):
    (prefill logits at each prompt's last position, k, v, decode logits,
    k_new, v_new)."""
    B = model.buckets.batch
    Sp = model.buckets.prefill_lens[-1]
    prompts = prompts[:B]
    tok, pos, mask = S.export.prefill_feeds(prompts, Sp, B)
    rows = [len(p) - 1 for p in prompts] + [0] * (B - len(prompts))
    lg, k, v = model.prefill_rows(tok, pos, mask, rows)
    last = [int(np.argmax(lg[b])) for b in range(len(prompts))]
    t, p, m = S.export.decode_feeds(
        last + [None] * (B - len(prompts)),
        [len(x) for x in prompts] + [0] * (B - len(prompts)), Sp, B)
    dl, kn, vn = model.decode(t, p, m, k, v)
    return lg, k, v, dl, kn, vn


def _book_vs_plain(torch, kreg, S, model, prompts, mode):
    """A prefill and a decode dispatch against the same under
    plain_reference(): the max |err| of each output; float32 within
    LOGITS_ATOL, a GEMM mode within its QUANT_FWD_RTOL in the norm."""
    got = _book_dispatches(S, model, prompts)
    with kreg.plain_reference():
        ref = _book_dispatches(S, model, prompts)
    errs = []
    for g, r in zip(got, ref):
        g = torch.as_tensor(g).double().cpu()
        r = torch.as_tensor(r).double().cpu()
        errs.append(((g - r).abs().max().item(),
                     ((g - r).norm() / r.norm()).item()))
    names = ("prefill logits", "k", "v", "decode logits", "k_new",
             "v_new")
    print("  against plain_reference(): " + "; ".join(
        f"{n} max|err| {e:.3e} rel {r:.3e}" for n, (e, r) in
        zip(names, errs)))
    if mode == "float32":
        _require(max(e for e, _ in errs) <= LOGITS_ATOL,
                 "a float32 dispatch disagrees with plain_reference()")
    else:
        _require(max(r for _, r in errs) <= QUANT_FWD_RTOL[mode],
                 f"a {mode} dispatch disagrees with plain_reference()")
    return max(e for e, _ in errs)


def _book_launches(kreg, S, model, prompts):
    """The kernel launches of one prefill and of one decode dispatch."""
    B = model.buckets.batch
    Sp = model.buckets.prefill_lens[-1]
    tok, pos, mask = S.export.prefill_feeds(prompts, Sp, B)
    kreg.reset_counts()
    _, k, v = model.prefill_rows(tok, pos, mask, [0] * B)
    pre = {n: c for n, c in kreg.launches().items() if c}
    t, p, m = S.export.decode_feeds([1] * B, [Sp] * B, Sp, B)
    kreg.reset_counts()
    model.decode(t, p, m, k, v)
    dec = {n: c for n, c in kreg.launches().items() if c}
    print(f"  launches of one prefill dispatch {pre}, of one decode "
          f"dispatch {dec}")
    return pre, dec


def time_book_gemms(torch, dev, card, search):
    """The GEMM kernels at the shapes of a decode dispatch (float32
    operands, as the engine gives them): device time per call of the
    kernel (all it launches), its plain version and its library call,
    and the bound."""
    from paddle_tpu_torch.kernels import quantized_matmul as qm
    from paddle_tpu_torch.tuning import variants as V
    peak_f32, peak_bf16, peak_bw, peak_i8, peak_tf32 = _peaks(card)
    win = _variant(V, search["winners"]["none"])
    out = {}
    for M, K, N, per in BOOK_GEMMS:
        x, y = _gemm_inputs(torch, dev, M, K, N, 7 * M + K + N)
        xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
        mm32 = _mm_f32_out(torch, xb, yb)
        mnk = 2 * M * N * K
        io = 4 * (M * K + K * N + M * N)
        rows = {"quantized_matmul_int8": (
                    lambda: qm.quantized_matmul(x, y, mode="int8"),
                    lambda: qm.quantized_matmul_plain(x, y, "int8"),
                    _int_mm_call(torch, x, y), [(mnk, peak_i8)],
                    "torch._int_mm on the quantized operands"),
                "quantized_matmul_bf16": (
                    lambda: qm.quantized_matmul(x, y, mode="bf16"),
                    lambda: qm.quantized_matmul_plain(x, y, "bf16"),
                    mm32 or (lambda: torch.matmul(xb, yb)),
                    [(mnk, peak_bf16)],
                    "torch.mm(out_dtype=float32)" if mm32 else
                    "torch.matmul bf16"),
                "tuned_matmul_sm90": (
                    lambda: V.tuned_matmul(x, y, variant=win),
                    lambda: V.tuned_matmul_plain(x, y, variant=win),
                    lambda: torch.matmul(x, y),
                    [(3 * mnk, peak_tf32)],
                    f"torch.matmul float32; tile {win.bm}x{win.bn}x"
                    f"{win.bk}")}
        for name, (kern, plain, lib, ops, what) in rows.items():
            ms = _call_device_ms(torch, kern)
            plain_ms = _call_device_ms(torch, plain, iters=5)
            lib_ms = None if lib is None else _call_device_ms(torch, lib)
            t_ops = sum(f / pk for f, pk in ops) * 1e3
            t_bytes = io / peak_bw * 1e3
            bound = max(t_ops, t_bytes)
            by = "operations" if t_ops >= t_bytes else "bytes"
            out[(name, M, K, N)] = {"ms": ms, "plain_ms": plain_ms,
                                    "library_ms": lib_ms,
                                    "bound_ms": bound, "bound_by": by,
                                    "per_dispatch": per}
            print(f"  {name} {M}x{K}x{N} (x{per} a decode dispatch): "
                  f"kernel {ms:.4f} ms device, plain {plain_ms:.4f} ms, "
                  f"library "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} "
                  f"[{what}], bound {bound:.4f} ms ({by})")
        del x, y, xb, yb
    for name in _BOOK_KERNEL.values():
        tot = sum(r["ms"] * r["per_dispatch"]
                  for (n, *_), r in out.items() if n == name)
        lib = sum((r["library_ms"] or 0.0) * r["per_dispatch"]
                  for (n, *_), r in out.items() if n == name)
        bnd = sum(r["bound_ms"] * r["per_dispatch"]
                  for (n, *_), r in out.items() if n == name)
        print(f"  {name}: the {BOOK_MULS} GEMMs of a decode dispatch take "
              f"{tot:.3f} ms of kernel time (library {lib:.3f} ms, bound "
              f"{bnd:.3f} ms)")
    return out


def _book_mode(torch, kreg, S, model, specs, f32_reqs, mode):
    """The GEMM mode's signatures captured again (the routing changed),
    37 launches of its kernel per prefill and per decode dispatch (none
    in float32), a burst of BOOK_MODE_REQUESTS, its dispatches against
    plain_reference() and its tokens against the float32 burst's and
    against reference_generate. Returns the kernel's launches on the
    main path (the dispatches and the burst) and the tokens/s."""
    name = _BOOK_KERNEL.get(mode)
    t0 = time.perf_counter()
    model.warmup()
    print(f"  warmup in {mode} mode: {time.perf_counter() - t0:.2f} s")
    prompts = [p for p, _ in specs]
    pre, dec = _book_launches(kreg, S, model, prompts)
    want = {name: BOOK_MULS} if name else {}
    _require(pre == want and dec == want,
             f"{mode}: want {want} launched a dispatch")
    kreg.reset_counts()
    c0 = model.engine_counters()
    _, reqs, wall, steps, _ = _book_burst(torch, S, model, specs)
    launches = kreg.launches()[name] + 2 * BOOK_MULS if name else 0
    c1 = model.engine_counters()
    _require(c1["captures"] == c0["captures"]
             and c1["eager_runs"] == c0["eager_runs"],
             f"{mode}: the burst captured or ran eagerly")
    same = sum(a == b for r, f in zip(reqs, f32_reqs)
               for a, b in zip(r.tokens, f.tokens))
    total = sum(len(r.tokens) for r in reqs)
    first = sum(r.tokens[0] == f.tokens[0] for r, f in zip(reqs, f32_reqs))
    print(f"  tokens equal to the float32 run's: {same} of {total} "
          f"({100 * same / total:.1f} %); first tokens {first} of "
          f"{len(reqs)}")
    n = 16
    solo = S.reference_generate(model, specs[0][0], n)
    print(f"  request 0 alone (reference_generate, {n} tokens) equal to "
          f"its batched tokens: {solo == reqs[0].tokens[:n]}")
    if mode != "int8":     # int8 scales tie a row to its batch mates
        _require(solo == reqs[0].tokens[:n],
                 f"{mode}: batched tokens differ from the solo run")
    _book_vs_plain(torch, kreg, S, model, prompts, mode)
    return launches, total / wall


def serving_phase(torch, dev, card, search):
    """The book LM at Transformer-base's decoder widths served on the
    card through the serving engine (inference/serving): export, load,
    warmup (one CUDA graph a signature), a float32 burst, parity, the
    GEMM modes, decode-shape GEMM times, and the RPC server. Returns
    ({kernel: launches on this phase's main path}, GEMM times)."""
    import socket
    import tempfile
    import threading
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.inference import serving as S
    from paddle_tpu_torch.kernels import registry as kreg
    from paddle_tpu_torch.observability import memory as obs_memory
    from paddle_tpu_torch.tuning import variants as V
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        model = _book_model(torch, pt, S, d)
        print(f"  book LM {BOOK}, buckets {BOOK_BUCKETS}: built, "
              f"initialized, exported and loaded in "
              f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    n_sig = model.warmup()
    torch.cuda.synchronize()
    c_warm = dict(model.engine_counters())
    print(f"  warmup: {n_sig} signatures in {time.perf_counter() - t0:.2f}"
          f" s; engine counters {c_warm}")
    _require(n_sig == 6 and c_warm["captures"] == 6,
             "warmup did not capture the 6 signatures")

    specs = _book_specs(BOOK_REQUESTS)
    kreg.reset_counts()
    eng, reqs, wall, steps, times = _book_burst(torch, S, model, specs)
    c = {k: v - c_warm[k] for k, v in model.engine_counters().items()}
    print(f"  engine since warmup: captures {c['captures']}, replays "
          f"{c['replays']}, eager runs {c['eager_runs']}, plans built "
          f"{c['traces']}; kernel launches "
          f"{ {n: v for n, v in kreg.launches().items() if v} }")
    _require(c["captures"] == 0 and c["eager_runs"] == 0
             and c["traces"] == 0, "the burst planned, captured or ran "
             "eagerly after warmup")
    cen = obs_memory.census(top_n=4)
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
          f"; census: kv_cache {cen['owners']['kv_cache']['bytes'] / 1e9:.3f}"
          f" GB, predictor {cen['owners']['predictor']['bytes'] / 1e9:.3f} "
          f"GB, orphan (graph pools, the allocator's blocks) "
          f"{cen['orphan_bytes'] / 1e9:.3f} GB of "
          f"{cen['live_bytes'] / 1e9:.3f} GB allocated")
    del eng
    busy = _book_busy(torch, S, model, [(p, n) for p, n in specs[:128]])

    t0 = time.perf_counter()
    for r, (p, n) in zip(reqs[:BOOK_PARITY], specs):
        ref = S.reference_generate(model, p, n)
        _require(ref == r.tokens, "float32 tokens differ from "
                 "reference_generate")
    print(f"  the first {BOOK_PARITY} requests' tokens equal "
          f"reference_generate bit for bit "
          f"({time.perf_counter() - t0:.2f} s)")
    prompts = [p for p, _ in specs[:model.buckets.batch]]
    _book_vs_plain(torch, kreg, S, model, prompts, "float32")

    # each GEMM mode beside a float32 burst of the same requests
    launches, rates = {}, {}
    for mode in ("float32", "bf16", "int8", "tuned"):
        print(f"  [{mode} GEMMs]")
        if mode == "tuned":
            _require(V.register_winner(search["winners"]) == "tuned_matmul",
                     "no none winner to register")
        elif mode != "float32":
            os.environ["PT_KERNEL_QUANT_MATMUL"] = mode
        try:
            n, rates[mode] = _book_mode(
                torch, kreg, S, model, specs[:BOOK_MODE_REQUESTS],
                reqs[:BOOK_MODE_REQUESTS], mode)
            if mode != "float32":
                launches[_BOOK_KERNEL[mode]] = n
        finally:
            os.environ.pop("PT_KERNEL_QUANT_MATMUL", None)
            kreg.unregister_kernel("tuned_matmul")
    print(f"  tokens/s by GEMM mode, bursts of {BOOK_MODE_REQUESTS}: "
          + ", ".join(f"{m} {r:.1f}" for m, r in rates.items()))
    gtimes = time_book_gemms(torch, dev, card, search)

    print("  [RPC]")
    model.warmup()      # float32 again, before the server's threads
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    ep = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    srv = S.ServeServer(ep, S.ServingEngine(model)).start()
    got = {}

    def client(i):
        for j in (i, i + 4):
            p, n = specs[j]
            got[j] = S.generate(ep, p, max_new_tokens=n, timeout=300.0)

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
        rpc_s = time.perf_counter() - t0
    finally:
        drained = srv.shutdown()
    _require(drained, "the server did not drain")
    _require(sorted(got) == list(range(8)) and all(
        got[j]["status"] == S.STATUS_OK and got[j]["tokens"] ==
        reqs[j].tokens for j in range(8)),
        "the RPC clients' tokens differ from the in-process engine's")
    print(f"  4 client threads, 8 generate calls in {rpc_s:.2f} s: tokens "
          f"equal the in-process engine's; shutdown() drained")
    print(f"  [serving phase] wall {time.perf_counter() - t_phase:.1f} s, "
          f"device busy {100 * busy:.1f} % of the profiled decode steps")
    return launches, gtimes


# ---------------------------------------------------------------------------
# sequence phase: LoD batches through the book's sentiment classifiers
# ---------------------------------------------------------------------------

# the book's widths (understand_sentiment): emb 128, hid 512 (each LSTM's
# hidden 128), 3 stacked LSTMs, 2 classes; vocab about the book's IMDB
# word_dict(); Adagrad(0.002), sparse embedding, B=128
SEQ = {"input_dim": 5148, "emb_dim": 128, "hid_dim": 512}
SEQ_B = 128
# review lengths: log-normal, median 174 words, sigma 0.75, clipped to
# [10, 2494] (IMDB's shape): batches 0 and 1 hold 33,145 and 29,353
# tokens, their longest reviews 955 and 896
SEQ_LEN = (174.0, 0.75, 10, 2494)
SEQ_POOL = 2        # LoD batches cycled (each its own plan and graph)
SEQ_STREAM = 3      # distinct batches run once each, eagerly
SEQ_TURNS = 2       # turns of one pass over the pool, eager and captured
SEQ_SERVE_RUNS = 4  # predictor runs a warmed signature
# the first step's loss on the card against the port on the CPU from the
# same parameters: float32 on both (TF32 off), sums in another order;
# measured 8.6e-8 (stacked_lstm_net) and 0 (convolution_net) on the H100
SEQ_LOSS_RTOL = 1e-6
# the predictor's replayed forward against the Executor's eager one on
# the card: the same kernels
SEQ_INFER_ATOL = 1e-6


def _seq_batch(seed):
    """(ids [T, 1] int64, [lengths], labels [B, 1] int64) of one batch of
    SEQ_B reviews from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    med, sigma, lo, hi = SEQ_LEN
    lens = np.clip(np.round(np.exp(rng.normal(np.log(med), sigma, SEQ_B))),
                   lo, hi).astype(np.int64)
    ids = rng.randint(0, SEQ["input_dim"], (int(lens.sum()), 1))
    labels = rng.randint(0, 2, (SEQ_B, 1))
    return ids.astype(np.int64), [lens.tolist()], labels.astype(np.int64)


def _seq_feed(pt, batch, place):
    ids, lens, labels = batch
    return {"words": pt.create_lod_tensor(ids, lens, place),
            "label": labels}


def _seq_padded_share(batch):
    lens = batch[1][0]
    return len(lens) * max(lens) / sum(lens)


def _seq_first_loss_cpu(pt, main, cost, state, feed):
    """The forward of `main` (the ops `cost` needs) on the CPU from the
    card's initial `state` (name -> CPU tensor) on `feed` (on the
    CPU)."""
    prog = pt.io._prune_program(main, [cost.name])
    scope = pt.Scope()
    for n, t in state.items():
        scope.var(n).get_tensor().set_tensor(t.clone())
    exe = pt.Executor(pt.CPUPlace())
    return float(exe.run(prog, feed=feed, fetch_list=[cost], scope=scope,
                         use_program_cache=False)[0])


def _seq_profile(torch, fn):
    """One call of fn() under torch.profiler: (wall s, busy share, device
    kernels launched, the top kernels by device time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return wall, busy / wall, sum(e.count for e in kernels), top


def _seq_compare(torch, pt, kreg, label, main, fetch, init, feeds,
                 runs=3, routed=None, kernels=None):
    """Each pool batch `runs` times through the plan cache (its first
    run eager, its second captures, the others replay) and the same runs
    with use_program_cache=False, from copies of the initial state, in
    deterministic mode: fetches and persistables bit-equal. With
    `routed` (a count of parameters) exactly one fused_adam launch a
    step covers that many parameter updates; `kernels` ({name: launches
    a run}) are the other kernels each run launches; no other kernel of
    the port launches. Returns (exe, scope, losses (the first fetch
    where it is one number), eager reasons, the cached runs' launches by
    kernel)."""
    steps = [f for f in feeds] * runs
    out, state, adam, counted = {}, {}, {}, {}
    want = {k: n * len(steps) for k, n in (kernels or {}).items()}
    with _deterministic(torch):
        for cached in (True, False):
            exe = pt.Executor(pt.CUDAPlace(0))
            scope = _copy_scope(pt, init, list(init._vars))
            kreg.reset_counts()
            if routed is not None:
                kreg.reset_stats()
            with _capture_clock() as clock:
                out[cached] = [[np.asarray(v) for v in _cap_run(
                    exe, main, f, fetch, scope, cached)] for f in steps]
            launched = {k: v for k, v in kreg.launches().items() if v}
            counted[cached] = dict(launched)
            if routed is not None:
                adam[cached] = (launched.pop("fused_adam", 0),
                                kreg.dispatch_stats()["per_kernel"]
                                .get("fused_adam", {}).get("custom", 0))
                _require(adam[cached] == (len(steps), routed * len(steps)),
                         f"{label}: fused_adam {adam[cached]}, want one "
                         f"launch over {routed} parameters in each of "
                         f"{len(steps)} steps")
            _require(launched == want,
                     f"{label}: the phase launched {launched}, want {want}")
            state[cached] = {n: v.get_tensor().tensor.clone()
                             for n, v in scope._vars.items()}
            if cached:
                kept = (exe, scope, clock, dict(exe._engine.eager_reasons))
            else:
                exe.close()
    equal_out = all(np.array_equal(a, b) for x, y in
                    zip(out[True], out[False]) for a, b in zip(x, y))
    equal_state = all(torch.equal(state[True][n], state[False][n])
                      for n in state[True])
    exe, scope, clock, reasons = kept
    c = _counters(exe)
    firsts = [o[0] for o in out[True]]
    losses = [float(x) for x in firsts if x.size == 1]
    shown = (f"losses {', '.join(f'{x:.6f}' for x in losses)}" if losses
             else f"first fetch {firsts[0].dtype} {list(firsts[0].shape)}")
    print(f"  {label}: {len(steps)} runs over {len(feeds)} LoD batches "
          f"with the plan cache ({c['captures']} captures, {c['replays']} "
          f"replays, {c['eager_runs']} eager) and {len(steps)} eager, "
          f"deterministic mode: fetches bit-equal {equal_out}, "
          f"{len(state[True])} persistables bit-equal {equal_state}; "
          f"{shown}")
    if routed is not None:
        print(f"  {label}: fused_adam launches {adam[True][0]} captured / "
              f"{adam[False][0]} eager in {len(steps)} steps, covering "
              f"{adam[True][1]} / {adam[False][1]} parameter updates "
              f"({routed} routed parameters a step)")
    others = [{k: v for k, v in counted[c].items() if k != "fused_adam"}
              or 0 for c in (True, False)]
    print(f"  {label}: other kernel launches {others[0]} captured / "
          f"{others[1]} eager in {len(steps)} runs")
    print(f"  {label}: the captures' parts: the capture rule "
          f"{clock['rule']:.3f} s, warm-up {clock['warm_up']:.3f} s, "
          f"capture {clock['capture']:.3f} s (of it gc.collect "
          f"{clock['gc']:.3f} s); eager reasons {reasons or 'none'}")
    _require(equal_out and equal_state,
             f"{label}: captured runs differ from eager runs")
    _require(all(np.isfinite(x).all() for x in firsts),
             f"{label}: first fetches not finite")
    if not reasons:
        _require((c["captures"], c["replays"], c["eager_runs"]) ==
                 (len(feeds), (runs - 1) * len(feeds), len(feeds)),
                 f"{label}: counters {c}")
    return exe, scope, losses, reasons, counted[True]


def _seq_rates(torch, pt, label, exe, main, fetch, scope, feeds, tokens,
               captured, B=SEQ_B, units=("examples", "tokens")):
    """Eager (use_program_cache=False) against the plan cache's runs
    (replays where `captured`: `fetch` is the fetch list the plans were
    made for) in SEQ_TURNS turns of one pass over the pool each, the
    order alternating: examples/s and tokens/s, each turn ending at its
    last run's first fetch on the host. First one pass of cached runs: the plans were
    captured in deterministic mode, and leaving it changes the routing a
    capture bakes in, so each is captured again (clocked). `units`
    name the examples and the tokens. Returns the median s a pass by
    mode."""
    with _capture_clock() as clock:
        c0 = _counters(exe)
        t0 = time.perf_counter()
        for f in feeds:
            _cap_run(exe, main, f, fetch, scope)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    print(f"  {label}: {_counters(exe)['captures'] - c0['captures']} "
          f"captures again outside deterministic mode in {secs:.3f} s: "
          f"warm-up {clock['warm_up']:.3f} s, capture "
          f"{clock['capture']:.3f} s")
    modes = ("eager", "captured")
    secs = {m: [] for m in modes}
    runs = {m: [] for m in modes}
    before = _counters(exe)
    for turn in range(SEQ_TURNS):
        for m in (modes if turn % 2 == 0 else modes[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for f in feeds:
                t1 = time.perf_counter()
                loss = _cap_run(exe, main, f, fetch, scope,
                                cached=m == "captured", numpy=False)[0]
                runs[m].append(time.perf_counter() - t1)
            loss.reshape(-1)[0].item()      # waits for the fetch
            secs[m].append(time.perf_counter() - t0)
    after = _counters(exe)
    for m in modes:
        med = float(np.median(secs[m]))
        print(f"  {label} {m if m == 'eager' or captured else 'cached'}: "
              f"s a pass over the pool "
              f"{', '.join(f'{x:.3f}' for x in secs[m])} (median "
              f"{med:.3f}; host s a run before its fetch "
              f"{', '.join(f'{x:.3f}' for x in runs[m])}): "
              f"{B * len(feeds) / med:.1f} {units[0]}/s, "
              f"{tokens / med:.1f} {units[1]}/s")
    delta = {k: after[k] - before[k] for k in after}
    print(f"  {label}: counters over the turns {delta}")
    _require(delta["captures"] == 0, f"{label}: the turns captured again")
    return {m: float(np.median(secs[m])) for m in modes}


def _seq_stream(torch, pt, label, main, cost, init, feeds, tokens, B,
                unit="tokens"):
    """`feeds`, batches never seen before, one run each through the
    plan cache on a fresh Executor: each builds its own plan and runs
    eagerly (a user without bucketing)."""
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = _copy_scope(pt, init, list(init._vars))
    n = len(feeds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in feeds:
        loss = _cap_run(exe, main, f, [cost], scope, numpy=False)[0]
    float(loss)
    secs = time.perf_counter() - t0
    c = _counters(exe)
    print(f"  {label}: a stream of {n} distinct batches ({tokens} {unit}): "
          f"{secs:.3f} s, {B * n / secs:.1f} examples/s, "
          f"{tokens / secs:.1f} {unit}/s; counters {c}")
    _require(c["traces"] == n and c["eager_runs"] == n and
             c["captures"] == 0, f"{label}: stream counters {c}")
    exe.close()


def _seq_serve(torch, pt, label, exe, main, pred, scope, names, host,
               feeds, B):
    """save_inference_model of the trained net with `pred` as the fetch,
    then AnalysisPredictor on the card (a fresh scope) on the LoD inputs
    `names` of each pool batch (`host`, on the CPU; `feeds`, the same on
    the card): each warmed (its plan, then its capture), then
    SEQ_SERVE_RUNS runs each with no capture, their outputs against the
    Executor's eager forward on the same scope."""
    import tempfile
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    test = pt.io._prune_program(main, [pred.name])
    with tempfile.TemporaryDirectory() as d:
        with pt.scope_guard(scope):
            pt.io.save_inference_model(d, names, [pred], exe,
                                       main_program=main)
        predictor = create_paddle_predictor(AnalysisConfig(d))
    ins = {n: predictor.get_input_tensor(n) for n in names}
    ot = predictor.get_output_tensor(predictor.get_output_names()[0])

    def run(f):
        for n, it in ins.items():
            it.copy_from_cpu(np.asarray(f[n]))
            if hasattr(f[n], "lod"):
                it.set_lod(f[n].lod())
        predictor.zero_copy_run()
        return ot.copy_to_cpu(), ot.lod()

    t0 = time.perf_counter()
    for f in host:
        for _ in range(2):
            run(f)
    warm = time.perf_counter() - t0
    c0 = dict(predictor._engine.counters)
    worst = 0.0
    t0 = time.perf_counter()
    outs = [[run(f) for f in host] for _ in range(SEQ_SERVE_RUNS)]
    secs = time.perf_counter() - t0
    c1 = predictor._engine.counters
    lods_equal = True
    for i, f in enumerate(feeds):
        ref = exe.run(test, feed=f, fetch_list=[pred], scope=scope,
                      use_program_cache=False)[0]
        for o in outs:
            worst = max(worst, float(np.abs(o[i][0] - np.asarray(ref))
                                     .max()))
            lods_equal &= o[i][1] == (ref.lod() if hasattr(ref, "lod")
                                      else [])
    n = SEQ_SERVE_RUNS * len(host)
    new = {k: c1[k] - c0[k] for k in ("captures", "eager_runs", "traces")}
    print(f"  {label} serving: AnalysisPredictor on {len(host)} LoD "
          f"signatures of B={B}: warmup {warm:.3f} s ({c0['captures']} "
          f"captures); then {n} runs in {secs:.3f} s ({B * n / secs:.1f} "
          f"examples/s, the outputs' host copies included) with "
          f"{new['captures']} captures, {new['eager_runs']} eager runs; "
          f"max |predictor - Executor| {worst:.3e} (bound "
          f"{SEQ_INFER_ATOL:g}); output LoDs equal {lods_equal}")
    _require(c0["captures"] == len(host) and not any(new.values()),
             f"{label} serving: counters {c0} -> {dict(c1)}")
    _require(worst <= SEQ_INFER_ATOL and lods_equal,
             f"{label} serving: the predictor disagrees with the Executor")


def _seq_net(torch, pt, kreg, net, batches, feeds, tokens):
    """One net (models/sentiment.py NETS key) through the phase."""
    from paddle_tpu_torch.models import sentiment
    label = {"stacked_lstm": "stacked_lstm_net",
             "conv": "convolution_net"}[net]
    t0 = time.perf_counter()
    pt.framework.unique_name.reset()
    main, startup, cost, acc, pred = sentiment.sentiment_train(net, **SEQ)
    main.random_seed = startup.random_seed = SEED
    types = [op.type for op in main.global_block().ops]
    init = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init)
    print(f"  {label}: {len(types)} ops ({types.count('lstm')} lstm, "
          f"{types.count('sequence_conv')} sequence_conv, "
          f"{types.count('sequence_pool')} sequence_pool, "
          f"{types.count('adagrad')} adagrad), "
          f"{sum(int(np.prod(p.shape)) for p in main.all_parameters())} "
          f"parameters")
    cpu_state = {n: v.get_tensor().tensor.to("cpu", copy=True)
                 for n, v in init._vars.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    exe, scope, losses, reasons, _ = _seq_compare(
        torch, pt, kreg, label, main, [cost, acc], init, feeds)
    t1 = time.perf_counter()
    cpu = _seq_first_loss_cpu(pt, main, cost, cpu_state,
                              _seq_feed(pt, batches[0], pt.CPUPlace()))
    err = abs(losses[0] - cpu) / abs(cpu)
    print(f"  {label}: first loss {losses[0]:.7f} on the card, {cpu:.7f} "
          f"on the CPU ({time.perf_counter() - t1:.1f} s): rel err "
          f"{err:.3e} (bound {SEQ_LOSS_RTOL:g})")
    _require(err <= SEQ_LOSS_RTOL, f"{label}: card and CPU disagree")
    kreg.reset_counts()
    _seq_rates(torch, pt, label, exe, main, [cost, acc], scope, feeds,
               tokens, not reasons)
    peak = torch.cuda.max_memory_allocated() / 1e9
    pool = _graph_pool_gb(torch)
    c0 = _counters(exe)
    wall, busy, n_kernels, top = _seq_profile(torch, lambda: _cap_run(
        exe, main, feeds[0], [cost, acc], scope, numpy=False))
    c1 = _counters(exe)
    _require(c1["replays"] == c0["replays"] + 1 or reasons,
             f"{label}: the profiled run was no replay: {c0} -> {c1}")
    print(f"  {label}: peak memory allocated {peak:.3f} GB; graph pools "
          f"{pool[0]:.3f} GB allocated, {pool[1]:.3f} GB reserved")
    print(f"  {label}: profiled {'replay' if not reasons else 'eager run'}"
          f" of batch 0: wall {wall:.4f} s, device busy "
          f"{100 * busy:.1f} %, {n_kernels} kernels")
    for e in top:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<6d} {e.key[:90]}")
    stream = [_seq_batch(1000 + i) for i in range(SEQ_STREAM)]
    _seq_stream(torch, pt, label, main, cost, init,
                [_seq_feed(pt, b, pt.CUDAPlace(0)) for b in stream],
                sum(sum(b[1][0]) for b in stream), SEQ_B)
    if net == "stacked_lstm":
        _seq_serve(torch, pt, label, exe, main, pred, scope, ["words"],
                   [_seq_feed(pt, b, pt.CPUPlace()) for b in batches],
                   feeds, SEQ_B)
    launched = {k: v for k, v in kreg.launches().items() if v}
    _require(not launched, f"{label}: the phase launched {launched}")
    exe.close()
    del exe, scope, init
    gc_cuda(torch)
    print(f"  {label}: {time.perf_counter() - t0:.1f} s")


def sequence_phase(torch, dev):
    """The book's sentiment classifiers (stacked_lstm_net, then
    convolution_net) at the book's widths on IMDB-shaped LoD batches of
    B=128 through Executor.run on the card: a pool of SEQ_POOL batches
    captured against eager bit for bit, the first loss against the CPU,
    eager against captured in turns, a profiled replay, peak memory, a
    stream of SEQ_STREAM distinct batches run eagerly, and for the
    stacked net the predictor on LoD feeds. No kernel of the port is
    launched."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    t0 = time.perf_counter()
    batches = [_seq_batch(i) for i in range(SEQ_POOL)]
    feeds = [_seq_feed(pt, b, pt.CUDAPlace(0)) for b in batches]
    tokens = sum(sum(b[1][0]) for b in batches)
    for i, b in enumerate(batches):
        lens = b[1][0]
        print(f"  batch {i}: {SEQ_B} reviews, {sum(lens)} tokens, lengths "
              f"{min(lens)}-{max(lens)} (median {int(np.median(lens))}); "
              f"padded share N*maxT/sum(T) {_seq_padded_share(b):.3f}")
    for net in ("stacked_lstm", "conv"):
        _seq_net(torch, pt, kreg, net, batches, feeds, tokens)
    print(f"  sequence phase: {time.perf_counter() - t0:.1f} s")


# [control flow phase]: the book's RNN encoder-decoder (models/seq2seq.py)
# at chapter 08's widths, and small programs with sub-blocks
CF = {"src_vocab": 30000, "tgt_vocab": 30000, "word_dim": 512,
      "hidden_dim": 512}
CF_B = 64
CF_LR = 0.01
# WMT14-shaped sentence lengths: log-normal, median 26, sigma 0.55,
# clipped to [2, 80] (the paddle.dataset.wmt14 reader's bound)
CF_LEN = {"median": 26.0, "sigma": 0.55, "lo": 2, "hi": 80}
CF_POOL = 2         # LoD batches cycled (each its own plan and graph)
CF_RUNS = 4         # runs of each pool batch in the captured-vs-eager check
CF_STREAM = 2       # distinct batches run once each, eagerly
# the first loss on the card against the port on the CPU from the same
# parameters and feed (float32 on both, TF32 off; sums in another order)
CF_LOSS_RTOL = 1e-6
# the small programs (While, IfElse, StaticRNN) on the card against the
# CPU
CF_ATOL = 1e-6


def _cf_feed(pt, seed, place):
    from paddle_tpu_torch.models import seq2seq
    return seq2seq.wmt14_batch(np.random.default_rng(seed), CF_B,
                               CF["src_vocab"], CF["tgt_vocab"],
                               place=place, **CF_LEN)


def _cf_lens(feed, name):
    return np.diff(feed[name].lod()[0])


def _routed_params(kreg, main):
    params = main.all_parameters()
    routed = [p for p in params
              if int(np.prod(p.shape)) >= kreg.min_numel()]
    return params, routed


def _profiled_replay(torch, label, exe, main, feed, fetch, scope):
    """Peak memory, the graph pools, and one profiled replay of `feed`:
    busy share, kernels, the top kernels by device time."""
    peak = torch.cuda.max_memory_allocated() / 1e9
    pool = _graph_pool_gb(torch)
    c0 = _counters(exe)
    wall, busy, n_kernels, top = _seq_profile(torch, lambda: _cap_run(
        exe, main, feed, fetch, scope, numpy=False))
    c1 = _counters(exe)
    _require(c1["replays"] == c0["replays"] + 1,
             f"{label}: the profiled run was no replay: {c0} -> {c1}")
    print(f"  {label}: peak memory allocated {peak:.3f} GB; graph pools "
          f"{pool[0]:.3f} GB allocated, {pool[1]:.3f} GB reserved")
    print(f"  {label}: profiled replay: wall {wall:.4f} s, device busy "
          f"{100 * busy:.1f} %, {n_kernels} kernels")
    for e in top:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<6d} {e.key[:90]}")
    return wall, busy, n_kernels


def _against_plain(torch, pt, kreg, label, main, loss, init, feed):
    """One eager step from the initial state with the Adam kernel and
    the same step under plain_reference(), in deterministic mode: every
    persistable bit-equal."""
    state = {}
    with _deterministic(torch):
        for mode in ("kernel", "plain"):
            exe = pt.Executor(pt.CUDAPlace(0))
            scope = _copy_scope(pt, init, list(init._vars))
            kreg.reset_counts()
            with (kreg.plain_reference() if mode == "plain"
                  else contextlib.nullcontext()):
                _cap_run(exe, main, feed, [loss], scope, cached=False)
            state[mode] = ({n: v.get_tensor().tensor.clone()
                            for n, v in scope._vars.items()},
                           kreg.launches()["fused_adam"])
            exe.close()
    (sk, nk), (sp, n_plain) = state["kernel"], state["plain"]
    differ = sum(not torch.equal(sk[n], sp[n]) for n in sk)
    print(f"  {label}: one step with the Adam kernel ({nk} launch) against "
          f"plain_reference() ({n_plain} launches): {differ} of {len(sk)} "
          f"persistables differ (bound 0)")
    _require(nk == 1 and n_plain == 0 and differ == 0,
             f"{label}: the Adam kernel's step is not plain_reference()'s")


def _cf_small_programs(pt):
    """(name, builder) of the small programs: each builder returns
    (main, startup, fetch list, feed, steps, optimizer) in the current
    program guard."""
    L = pt.layers

    def while_loop():
        x = L.data("x", [3], dtype="float32")
        i = L.fill_constant([1], "float32", 0.0)
        n = L.fill_constant([1], "float32", 5.0)
        acc = L.assign(x)
        cond = L.less_than(i, n)
        loop = L.While(cond)
        with loop.block():
            L.assign(L.elementwise_add(acc * 0.5, x), output=acc)
            L.increment(i, in_place=True)
            L.less_than(i, n, cond=cond)
        return [acc * 1.0], {"x": np.arange(12, dtype=np.float32)
                             .reshape(4, 3)}, 2

    def ifelse():
        x = L.data("x", [8], dtype="float32")
        h = L.fc(x, 8, act="tanh")
        cond = L.less_than(L.reduce_sum(h, dim=1, keep_dim=True),
                           L.fill_constant([1], "float32", 0.0))
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(ie.input(h) * 2.0)
        with ie.false_block():
            ie.output(ie.input(h) - 1.0)
        out = ie()[0]
        return [out], {"x": np.random.default_rng(1).standard_normal(
            (16, 8)).astype(np.float32)}, 2

    def static_rnn():
        T, B, D, H = 12, 16, 32, 64
        x = L.data("x", [T, B, D], dtype="float32", append_batch_size=False)
        y = L.data("y", [T, B, H], dtype="float32", append_batch_size=False)
        rnn = L.StaticRNN()
        with rnn.step():
            word = rnn.step_input(x)
            prev = rnn.memory(shape=[-1, H], batch_ref=word)
            hidden = L.fc([word, prev], H, act="tanh")
            rnn.update_memory(prev, hidden)
            rnn.step_output(hidden)
        loss = L.mean(L.square(rnn() - y))
        pt.optimizer.AdamOptimizer(0.01).minimize(loss)
        rng = np.random.default_rng(2)
        return [loss], {"x": rng.standard_normal((T, B, D))
                        .astype(np.float32),
                        "y": rng.standard_normal((T, B, H))
                        .astype(np.float32)}, 3

    return (("While", while_loop), ("IfElse", ifelse),
            ("StaticRNN", static_rnn))


def _cf_small(torch, pt):
    """Each small program on the card and on the CPU from the same
    startup state: every fetch of every run within CF_ATOL. While stays
    eager with its reason; IfElse and the StaticRNN's 3 Adam steps are
    captured from their second run."""
    for name, build in _cf_small_programs(pt):
        res = {}
        for where, place in (("card", pt.CUDAPlace(0)),
                             ("cpu", pt.CPUPlace())):
            pt.framework.unique_name.reset()
            main, startup = pt.Program(), pt.Program()
            main.random_seed = startup.random_seed = SEED
            with pt.program_guard(main, startup):
                fetch, feed, steps = build()
            exe, scope = pt.Executor(place), pt.Scope()
            if where == "cpu":
                for n, t in res["card"][2].items():
                    scope.var(n).get_tensor().set_tensor(t.cpu())
            else:
                exe.run(startup, scope=scope)
            init = {n: v.get_tensor().tensor.clone()
                    for n, v in scope._vars.items()}
            outs = [[np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=fetch, scope=scope)]
                for _ in range(steps)]
            res[where] = (outs, dict(exe._engine.eager_reasons), init,
                          _counters(exe))
        (oc, reasons, _, c), (oh, _, _, _) = res["card"], res["cpu"]
        worst = max(float(np.abs(a - b).max()) for x, y in zip(oc, oh)
                    for a, b in zip(x, y))
        print(f"  {name}: {len(oc)} runs on the card against the CPU: max "
              f"|card - cpu| {worst:.3e} (bound {CF_ATOL:g}); captures "
              f"{c['captures']}, replays {c['replays']}, eager runs "
              f"{c['eager_runs']}; eager reasons "
              f"{list(reasons.values()) or 'none'}")
        _require(worst <= CF_ATOL, f"{name}: the card disagrees with "
                 f"the CPU")
        if name == "While":
            _require(list(reasons.values()) == ["while"] and
                     c["captures"] == 0, f"While: {reasons} {c}")
        else:
            _require(not reasons and c["captures"] == 1,
                     f"{name}: {reasons} {c}")


def control_flow_phase(torch, dev, card):
    """The book's RNN encoder-decoder (models/seq2seq.py: two DynamicRNN
    blocks, AdamOptimizer(0.01)) at chapter 08's widths (vocab 30000,
    word 512, hidden 512), B=64, on WMT14-shaped LoD batches through
    Executor.run on the card; the predictor on its LoD feeds; the small
    programs with sub-blocks. Returns the fused_adam launches of the
    captured steps (the main path)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    from paddle_tpu_torch.models import seq2seq
    t0 = time.perf_counter()
    pt.framework.unique_name.reset()
    main, startup, loss, logits = seq2seq.seq2seq_train(lr=CF_LR, **CF)
    main.random_seed = startup.random_seed = SEED
    params, routed = _routed_params(kreg, main)
    types = [op.type for op in main.global_block().ops]
    print(f"  seq2seq: {len(main.blocks)} blocks, {len(types)} ops in "
          f"block 0 ({types.count('recurrent')} recurrent, "
          f"{types.count('recurrent_grad')} recurrent_grad, "
          f"{types.count('adam')} adam), "
          f"{sum(len(b.ops) for b in main.blocks[1:])} in the sub-blocks; "
          f"{len(params)} parameters, "
          f"{sum(int(np.prod(p.shape)) for p in params)} elements, "
          f"{len(routed)} routed to fused_adam "
          f"({sum(int(np.prod(p.shape)) for p in routed)} elements)")
    init = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init)
    cpu_state = {n: v.get_tensor().tensor.to("cpu", copy=True)
                 for n, v in init._vars.items()}
    seeds = list(range(CF_POOL))
    feeds = [_cf_feed(pt, s, pt.CUDAPlace(0)) for s in seeds]
    tokens = sum(int(_cf_lens(f, "tgt_in").sum()) for f in feeds)
    for s, f in zip(seeds, feeds):
        share = {n: CF_B * _cf_lens(f, n).max() / _cf_lens(f, n).sum()
                 for n in ("src", "tgt_in")}
        print(f"  batch {s}: {CF_B} pairs, source {_cf_lens(f, 'src').sum()}"
              f" tokens (lengths {_cf_lens(f, 'src').min()}-"
              f"{_cf_lens(f, 'src').max()}), target "
              f"{_cf_lens(f, 'tgt_in').sum()} tokens (lengths "
              f"{_cf_lens(f, 'tgt_in').min()}-{_cf_lens(f, 'tgt_in').max()})"
              f"; padded share N*maxT/sum(T) source {share['src']:.3f}, "
              f"target {share['tgt_in']:.3f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    exe, scope, losses, reasons, launches = _seq_compare(
        torch, pt, kreg, "seq2seq", main, [loss], init, feeds, CF_RUNS,
        len(routed))
    _require(not reasons, f"seq2seq: a block was kept eager: {reasons}")
    t1 = time.perf_counter()
    cpu = _seq_first_loss_cpu(pt, main, loss, cpu_state,
                              _cf_feed(pt, seeds[0], pt.CPUPlace()))
    err = abs(losses[0] - cpu) / abs(cpu)
    print(f"  seq2seq: first loss {losses[0]:.7f} on the card, {cpu:.7f} "
          f"on the CPU ({time.perf_counter() - t1:.1f} s): rel err "
          f"{err:.3e} (bound {CF_LOSS_RTOL:g})")
    _require(err <= CF_LOSS_RTOL, "seq2seq: card and CPU disagree")
    _against_plain(torch, pt, kreg, "seq2seq", main, loss, init, feeds[0])
    _seq_rates(torch, pt, "seq2seq", exe, main, [loss], scope, feeds,
               tokens, True, B=CF_B)
    _profiled_replay(torch, "seq2seq", exe, main, feeds[0], [loss], scope)
    stream = [_cf_feed(pt, 100 + i, pt.CUDAPlace(0))
              for i in range(CF_STREAM)]
    _seq_stream(torch, pt, "seq2seq", main, loss, init, stream,
                sum(int(_cf_lens(f, "tgt_in").sum()) for f in stream),
                CF_B, "target tokens")
    _seq_serve(torch, pt, "seq2seq", exe, main, logits, scope,
               ["src", "tgt_in"],
               [_cf_feed(pt, s, pt.CPUPlace()) for s in seeds], feeds,
               CF_B)
    exe.close()
    del exe, scope, init
    gc_cuda(torch)
    _cf_small(torch, pt)
    print("  fused_adam at the seq2seq's parameter shapes:")
    at = time_adam(torch, dev, card, [p.shape for p in params])
    print(f"  fused_adam seq2seq row: " + json.dumps(
        {k: at[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "bound_by", "elements", "routed")}))
    print(f"  control flow phase: {time.perf_counter() - t0:.1f} s")
    return launches.get("fused_adam", 0)


# [book models phase]: the book's last two models, label_semantic_roles
# at the CoNLL-05 widths and machine_translation's beam-search decoder at
# chapter 08's
SRL = {"vocab": 44068, "n_tag": 59, "emb_dim": 32, "hidden_dim": 512}
SRL_B = 64
SRL_POOL = 2        # LoD batches cycled (each its own plan and graph)
SRL_RUNS = 4        # runs of each pool batch: 8 steps captured vs eager
# the first loss on the card against the port on the CPU from the same
# parameters and feed (float32 on both, TF32 off; sums in another order)
SRL_LOSS_RTOL = 1e-6
MT = {"vocab": 30000, "word_dim": 512, "hidden_dim": 512}
MT_POOL = 2         # training batches (B=CF_B, CF_LEN's lengths)
MT_RUNS = 2         # training runs of each: 4 Adam steps
MT_SOURCES = 128    # sources a decode
MT_BEAM = 4
MT_LEN = 80         # decode steps: the wmt14 reader's length bound
MT_RUNS_DECODE = 3  # decode runs a mode: eager, the capture, a replay
MT_TIMED = 5        # replays timed a mode
# the bf16 GEMM kernel against its plain version sums float32 in another
# order (GEMM_RTOL), and each step's GEMM inputs are rounded to bf16
# anew: a float32 difference that moves one across a bf16 rounding
# boundary moves it by a bf16 ulp, and the encoder's 80-step recurrence
# and the decoder's carry such moves on. The two decodes then hold the
# same hypotheses, or part at a near-tie (a near-random model's top
# candidates lie close). A source's hypotheses are held equal until the
# first step its selections (ids, parents) differ; there its sorted
# selected scores, and before it all of its scores, agree within
# MT_SCORE_ATOL + MT_SCORE_RTOL * |score|, the relative term bf16's unit
# roundoff 2^-9: the two decodes agree to one bf16 rounding. (Measured
# on the H100: 6.1e-4 relative at worst.)
MT_SCORE_RTOL, MT_SCORE_ATOL = 2.0 ** -9, 1e-4


def _srl_feed(pt, seed, place, words_only=False):
    from paddle_tpu_torch.models import label_semantic_roles as srl
    f = srl.conll05_batch(np.random.default_rng(seed), SRL_B,
                          SRL["vocab"], SRL["n_tag"], place)
    return {"word": f["word"]} if words_only else f


def srl_phase(torch, dev, card, pt, kreg):
    """The book's CRF tagger (models/label_semantic_roles.py) at the
    CoNLL-05 widths, B=64: trained captured against eager, its first
    loss against the CPU, one step against plain_reference(); then its
    decode program on the trained scope, captured against eager, and
    through AnalysisPredictor. Returns the fused_adam launches of the
    captured steps."""
    import warnings
    from paddle_tpu_torch.models import label_semantic_roles as srl
    t0 = time.perf_counter()
    pt.framework.unique_name.reset()
    main, startup, loss, _ = srl.srl_train(lr=CF_LR, **SRL)
    main.random_seed = startup.random_seed = SEED
    with warnings.catch_warnings():
        # crfw is declared there: its value is the trained scope's
        warnings.simplefilter("ignore", UserWarning)
        decode, path = srl.srl_decode(**SRL)
    params, routed = _routed_params(kreg, main)
    types = [op.type for op in main.global_block().ops]
    print(f"  srl: {len(types)} ops in block 0 ({types.count('recurrent')} "
          f"recurrent, {types.count('linear_chain_crf')} linear_chain_crf, "
          f"{types.count('linear_chain_crf_grad')} linear_chain_crf_grad, "
          f"{types.count('adam')} adam); {len(params)} parameters, "
          f"{sum(int(np.prod(p.shape)) for p in params)} elements, "
          f"{len(routed)} routed to fused_adam "
          f"({sum(int(np.prod(p.shape)) for p in routed)} elements: "
          f"{', '.join(f'{p.name} {list(p.shape)}' for p in routed)})")
    init = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init)
    cpu_state = {n: v.get_tensor().tensor.to("cpu", copy=True)
                 for n, v in init._vars.items()}
    seeds = list(range(SRL_POOL))
    feeds = [_srl_feed(pt, s, pt.CUDAPlace(0)) for s in seeds]
    lens = [np.diff(f["word"].lod()[0]) for f in feeds]
    tokens = int(sum(x.sum() for x in lens))
    for s, x in zip(seeds, lens):
        print(f"  batch {s}: {SRL_B} sentences, {x.sum()} tokens (lengths "
              f"{x.min()}-{x.max()}); padded share N*maxT/sum(T) "
              f"{SRL_B * x.max() / x.sum():.3f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    exe, scope, losses, reasons, launched = _seq_compare(
        torch, pt, kreg, "srl", main, [loss], init, feeds, SRL_RUNS,
        len(routed))
    _require(not reasons, f"srl: a block was kept eager: {reasons}")
    t1 = time.perf_counter()
    cpu = _seq_first_loss_cpu(pt, main, loss, cpu_state,
                              _srl_feed(pt, seeds[0], pt.CPUPlace()))
    err = abs(losses[0] - cpu) / abs(cpu)
    print(f"  srl: first loss {losses[0]:.7f} on the card, {cpu:.7f} on "
          f"the CPU ({time.perf_counter() - t1:.1f} s): rel err "
          f"{err:.3e} (bound {SRL_LOSS_RTOL:g})")
    _require(err <= SRL_LOSS_RTOL, "srl: card and CPU disagree")
    _against_plain(torch, pt, kreg, "srl", main, loss, init, feeds[0])
    _seq_rates(torch, pt, "srl", exe, main, [loss], scope, feeds, tokens,
               True, B=SRL_B)
    _profiled_replay(torch, "srl", exe, main, feeds[0], [loss], scope)

    # the decode program on the trained scope
    words = [_srl_feed(pt, s, pt.CUDAPlace(0), True) for s in seeds]
    dexe, _, _, dreasons, _ = _seq_compare(
        torch, pt, kreg, "srl decode", decode, [path], scope, words)
    _require(not dreasons, f"srl decode: kept eager: {dreasons}")
    got = dexe.run(decode, feed=words[0], fetch_list=[path], scope=scope,
                   use_program_cache=False)[0]
    tags = np.asarray(got)
    print(f"  srl decode: ViterbiPath {tags.dtype} {list(tags.shape)}, LoD "
          f"the feed's {got.lod() == words[0]['word'].lod()}, tags in "
          f"[{tags.min()}, {tags.max()}]")
    _require(tags.dtype == np.int32 and got.lod() == words[0]["word"].lod()
             and 0 <= tags.min() and tags.max() < SRL["n_tag"],
             "srl decode: the paths")
    _seq_serve(torch, pt, "srl decode", dexe, decode, path, scope, ["word"],
               [_srl_feed(pt, s, pt.CPUPlace(), True) for s in seeds],
               words, SRL_B)
    for e in (exe, dexe):
        e.close()
    del exe, dexe, scope, init
    gc_cuda(torch)
    print("  fused_adam at the srl's parameter shapes:")
    at = time_adam(torch, dev, card, [p.shape for p in params])
    print("  fused_adam srl row: " + json.dumps(
        {k: at[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "bound_by", "elements", "routed")}))
    print(f"  srl: {time.perf_counter() - t0:.1f} s")
    return launched.get("fused_adam", 0)


def _mt_decode_feed(pt, place):
    from paddle_tpu_torch.models import machine_translation as mt
    return mt.decode_feed(np.random.default_rng(500), MT_SOURCES,
                          MT["vocab"], place, **CF_LEN)


def _mt_generated(ids):
    """Positions each hypothesis generates: up to its first end id,
    that included, else all MT_LEN."""
    from paddle_tpu_torch.models import machine_translation as mt
    ended = ids == mt.EOS
    return int(np.where(ended.any(1), ended.argmax(1) + 1, MT_LEN).sum())


def _mt_beam_agree(ref, got):
    """Two decodes of one feed, each (sentence ids, sentence scores,
    stacked step ids, step scores, step parents): (the sources that
    part, their first parting steps, the worst excess over the score
    bound, the worst relative score difference). A source is held to the reference's hypotheses until the
    first step its selections (ids, parents) differ; its scores before
    that step, and its sorted selected scores at it (a near-tie swaps
    candidates, not their scores), within MT_SCORE_ATOL +
    MT_SCORE_RTOL * |score|."""
    K = MT_BEAM
    r_ids, r_sc, r_si, r_ss, r_sp = ref
    g_ids, g_sc, g_si, g_ss, g_sp = got
    T = r_si.shape[0]
    B = r_si.shape[1] // K

    def by_source(a):
        return a.reshape(T, B, K)

    ri, gi, rs, gs, rp, gp = (by_source(a) for a in
                              (r_si, g_si, r_ss, g_ss, r_sp, g_sp))
    parted, steps, excess, rel = [], [], 0.0, [0.0]

    def over(a, b):
        d = np.abs(a - b)
        rel[0] = max(rel[0], float((d / np.maximum(np.abs(a), 1e-30))
                                   .max()))
        return float((d - MT_SCORE_ATOL - MT_SCORE_RTOL * np.abs(a)).max())

    for b in range(B):
        differ = np.flatnonzero(((ri[:, b] != gi[:, b]) |
                                 (rp[:, b] != gp[:, b])).any(1))
        t = int(differ[0]) if differ.size else T
        if t:
            excess = max(excess, over(rs[:t, b], gs[:t, b]))
        if t < T:
            excess = max(excess, over(np.sort(rs[t, b]),
                                      np.sort(gs[t, b])))
            parted.append(b)
            steps.append(t)
        else:
            rows = slice(b * K, (b + 1) * K)
            _require(np.array_equal(r_ids[rows], g_ids[rows]),
                     f"source {b}: equal selections, other sentences")
            excess = max(excess, over(r_sc[rows], g_sc[rows]))
    return parted, steps, excess, rel[0]


def _mt_mode(torch, pt, kreg, mode, decode, fetch, steps, scope, feed,
             t_src):
    """The decode in one GEMM mode ("" = float32): captured against
    eager (_seq_compare, with the quantized_matmul launches a run that
    the shapes give), then one eager decode against the same decode
    under plain_reference(). Returns the kernel's launches in the
    captured runs."""
    label = f"mt decode {mode or 'float32'}"
    name = f"quantized_matmul_{mode}" if mode else None
    # the encoder's two step GEMMs at M = MT_SOURCES a source step, the
    # decoder's two at M = MT_SOURCES (step 0) then MT_SOURCES * MT_BEAM
    # a step; K = N = 512 (multiples of 128); the softmax fc's N = 30000
    # is no multiple of 128: cuBLAS
    per_run = 2 * t_src + 2 * MT_LEN
    old = os.environ.get("PT_KERNEL_QUANT_MATMUL")
    os.environ["PT_KERNEL_QUANT_MATMUL"] = mode
    try:
        exe, dscope, _, reasons, launched = _seq_compare(
            torch, pt, kreg, label, decode, fetch[:2], scope, [feed],
            MT_RUNS_DECODE, kernels={name: per_run} if mode else None)
        _require(not reasons, f"{label}: kept eager: {reasons}")
        # out of deterministic mode: one run captures again, then
        # MT_TIMED replays, each to its end on the card
        _cap_run(exe, decode, feed, fetch[:2], dscope, numpy=False)
        secs = []
        for _ in range(MT_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _cap_run(exe, decode, feed, fetch[:2], dscope, numpy=False)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        print(f"  {label}: ms a decode (replays) "
              f"{', '.join(f'{1e3 * x:.2f}' for x in secs)} (median "
              f"{1e3 * float(np.median(secs)):.2f})")
        if mode:
            print(f"  {label}: {per_run} {name} launches a decode = 2 x "
                  f"{t_src} encoder steps (M = {MT_SOURCES}, K = N = "
                  f"{MT['hidden_dim']}) + 2 x {MT_LEN} decoder steps (M = "
                  f"{MT_SOURCES} at step 0, {MT_SOURCES * MT_BEAM} after); "
                  f"the softmax fc's N = {MT['vocab']} (% 128 = "
                  f"{MT['vocab'] % 128}) stays on cuBLAS")
        res = {}
        with _deterministic(torch):
            for ref in (False, True):
                kreg.reset_counts()
                with (kreg.plain_reference() if ref
                      else contextlib.nullcontext()):
                    res[ref] = [np.asarray(v) for v in _cap_run(
                        exe, decode, feed, fetch + steps, scope, False)]
                n = kreg.launches().get(name, 0) if name else 0
                _require(n == (0 if ref or not mode else per_run),
                         f"{label}: {n} launches (plain_reference {ref})")
        exe.close()
    finally:
        if old is None:
            os.environ.pop("PT_KERNEL_QUANT_MATMUL")
        else:
            os.environ["PT_KERNEL_QUANT_MATMUL"] = old
    same = all(np.array_equal(a, b) for a, b in zip(res[False], res[True]))
    parted, at, excess, rel = _mt_beam_agree(res[True], res[False])
    print(f"  {label}: against plain_reference(): bit-equal {same}; "
          f"{len(parted)} of {MT_SOURCES} sources part at a near-tie "
          f"(first parting steps {sorted(at) or '-'}); worst relative "
          f"score difference {rel:.3e}, worst excess over the bound "
          f"{excess:.3e} (<= 0)")
    # float32 launches nothing, int8 is bit-equal to its plain version
    _require(same if mode != "bf16" else excess <= 0,
             f"{label}: the decode disagrees with plain_reference()")
    return launched.get(name, 0) if name else 0


def mt_phase(torch, pt, kreg):
    """The book's machine translation model
    (models/machine_translation.py) at chapter 08's widths: 4 Adam steps
    at B=64 captured against eager, then its beam-search decoder on the
    trained scope: 128 sources, beam 4, 80 steps, captured as one CUDA
    graph a source LoD against eager in float32 and with its step GEMMs
    in the int8 and bf16 kernels (each against plain_reference()), the
    decode's rates, a profiled replay and peak memory, and the
    AnalysisPredictor on its two-level LoD feed. Returns (fused_adam
    launches of the captured steps, quantized_matmul launches of the
    captured decodes by mode)."""
    from paddle_tpu_torch.models import machine_translation as mt, seq2seq
    t0 = time.perf_counter()
    pt.framework.unique_name.reset()
    main, startup, loss = mt.mt_train(lr=CF_LR, **MT)
    main.random_seed = startup.random_seed = SEED
    decode, ids, scores = mt.mt_decode(beam=MT_BEAM, max_len=MT_LEN, **MT)
    stacks = [op.output("Y")[0] for op in decode.global_block().ops
              if op.type == "stack"]           # step ids, scores, parents
    params, routed = _routed_params(kreg, main)
    dtypes = [op.type for op in decode.global_block().ops]
    print(f"  mt: training {len(main.global_block().ops)} ops in block 0, "
          f"{len(params)} parameters, {len(routed)} routed to fused_adam; "
          f"decode {len(dtypes)} ops ({dtypes.count('beam_search')} "
          f"beam_search, {dtypes.count('mul')} mul, "
          f"{dtypes.count('top_k')} top_k, {dtypes.count('gather')} "
          f"gather)")
    init = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init)
    feeds = [seq2seq.wmt14_batch(np.random.default_rng(200 + s), CF_B,
                                 MT["vocab"], MT["vocab"],
                                 place=pt.CUDAPlace(0), **CF_LEN)
             for s in range(MT_POOL)]
    texe, trained, _, reasons, launched = _seq_compare(
        torch, pt, kreg, "mt", main, [loss], init, feeds, MT_RUNS,
        len(routed))
    _require(not reasons, f"mt: a block was kept eager: {reasons}")
    texe.close()
    del init, texe
    gc_cuda(torch)

    feed = _mt_decode_feed(pt, pt.CUDAPlace(0))
    src = np.diff(feed["src"].lod()[0])
    t_src = int(src.max())
    print(f"  mt decode: {MT_SOURCES} sources, {src.sum()} tokens "
          f"(lengths {src.min()}-{t_src}), beam {MT_BEAM}, {MT_LEN} steps; "
          f"init_ids LoD {len(feed['init_ids'].lod())} levels")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fetch = [ids, scores]
    qmm = {}
    for mode in ("", "int8", "bf16"):
        n = _mt_mode(torch, pt, kreg, mode, decode, fetch, stacks, trained,
                     feed, t_src)
        if mode:
            qmm[mode] = n
    # rates, a profiled replay and peak memory, in float32
    exe = pt.Executor(pt.CUDAPlace(0))
    out = _cap_run(exe, decode, feed, fetch, trained)
    sent, sent_sc = (np.asarray(v) for v in out)
    _require(sent.shape == (MT_SOURCES * MT_BEAM, MT_LEN) and
             sent.dtype == np.int32 and np.isfinite(sent_sc).all() and
             ((sent >= 0) & (sent < MT["vocab"])).all(),
             f"mt decode: sentences {sent.dtype} {sent.shape}")
    tokens = _mt_generated(sent)
    print(f"  mt decode: SentenceIds {sent.dtype} {list(sent.shape)}, "
          f"scores in [{sent_sc.min():.3f}, {sent_sc.max():.3f}]; "
          f"{tokens} generated tokens a decode (each hypothesis up to its "
          f"end id)")
    med = _seq_rates(torch, pt, "mt decode", exe, decode, fetch, trained,
                     [feed], tokens, True, B=MT_SOURCES,
                     units=("sources", "generated tokens"))
    print(f"  mt decode: {1e3 * med['captured']:.2f} ms a decode captured "
          f"(one replay), {1e3 * med['eager']:.2f} ms eager")
    _profiled_replay(torch, "mt decode", exe, decode, feed, fetch, trained)
    _seq_serve(torch, pt, "mt decode", exe, decode, ids, trained,
               ["src", "init_ids", "init_scores"],
               [_mt_decode_feed(pt, pt.CPUPlace())], [feed], MT_SOURCES)
    exe.close()
    del exe, trained
    gc_cuda(torch)
    print(f"  mt: {time.perf_counter() - t0:.1f} s")
    return launched.get("fused_adam", 0), qmm


def book_models_phase(torch, dev, card):
    """label_semantic_roles, then machine_translation (srl_phase,
    mt_phase). Returns (fused_adam launches, quantized_matmul launches
    by mode)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    t0 = time.perf_counter()
    adam = srl_phase(torch, dev, card, pt, kreg)
    mt_adam, qmm = mt_phase(torch, pt, kreg)
    print(f"  book models phase: {time.perf_counter() - t0:.1f} s")
    return adam + mt_adam, qmm


# ---------------------------------------------------------------------------
# the bucket sweep, flash_attention_lse
# ---------------------------------------------------------------------------

SWEEP_SHARDS = 4   # ZeRO-1 windows checked a bucket
SWEEP_LR = 1e-3    # the sweep's rate (Adam: with step 3's beta powers)


def _sweep_state(torch, pt, built):
    """Transformer-base's training program (`built`) planned into buckets
    (parallel/comm_scheduler.py, FLAGS_allreduce_bucket_mb), one step run
    from a fresh scope fetching every planned gradient, and each bucket's
    parameters, gradients and Adam moments flattened in plan order:
    [(bucket, p, g, m, v, [(name, numel)])]."""
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel import comm_scheduler as cs
    cfg, main, startup, cost = built
    plan = cs.plan_program_buckets(main)
    stats = cs.plan_stats(plan, len(main.global_block().ops))
    block = main.global_block()
    moments = {op.input("Param")[0]: (op.input("Moment1")[0],
                                      op.input("Moment2")[0])
               for op in block.ops if op.type == "adam"}
    names = [n for b in plan for n in b.names]
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    grads = exe.run(main, feed=_training_feed(T, cfg), fetch_list=names,
                    scope=scope, return_numpy=False)
    grads = dict(zip(names, grads))

    def tensor(n):
        return scope.find_var(n).get_tensor().tensor

    out = []
    for b in plan:
        params = [n[:-len("@GRAD")] for n in b.names]
        parts = ([tensor(n) for n in params],
                 [grads[n].float() for n in b.names],
                 [tensor(moments[n][0]) for n in params],
                 [tensor(moments[n][1]) for n in params])
        flat = [torch.cat([t.reshape(-1) for t in ts]) for ts in parts]
        out.append((b, *flat, [(n, t.numel())
                               for n, t in zip(params, parts[0])]))
    print(f"  plan: {stats['buckets']} buckets of Transformer-base's "
          f"{len(names)} gradients at FLAGS_allreduce_bucket_mb="
          f"{cs.bucket_bytes_from_flags() / 2 ** 20:g}, {stats['bytes']} "
          f"bytes; bucket sizes {[b.size for b in plan]}")
    _require(len(names) == len(main.all_parameters()) == 255 and
             len(plan) > 1, "the plan does not hold Transformer-base's "
                            "255 gradients in several buckets")
    del scope, exe
    return out


def _sweep_pows(torch, dev):
    return (torch.tensor([0.9 ** 3], device=dev),
            torch.tensor([0.999 ** 3], device=dev))


def _sweep(fo, kind, st, lr, b1p, b2p, **kw):
    _, p, g, m, v, _ = st
    if kind == "adam":
        return fo.bucket_sweep("adam", p, g, m, v, lr=lr, beta1_pow=b1p,
                               beta2_pow=b2p, **kw)
    return (fo.bucket_sweep("sgd", p, g, lr=lr, **kw),)


def _bit_equal(torch, a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def _sweep_checks(torch, fo, kreg, kind, state, dev):
    """Every check of one kind's sweep over every bucket; returns the
    launches of the main sweep and the worst difference from the plain
    version (0 when bit-equal)."""
    lr = torch.tensor([SWEEP_LR], device=dev)
    b1p, b2p = _sweep_pows(torch, dev)
    kreg.reset_counts()
    outs = [_sweep(fo, kind, st, lr, b1p, b2p) for st in state]
    torch.cuda.synchronize()
    launches = kreg.launches()["bucket_sweep_" + kind]
    _require(launches == len(state), f"{kind} sweep: {launches} launches "
                                     f"for {len(state)} buckets")
    with kreg.plain_reference():
        plain = [_sweep(fo, kind, st, lr, b1p, b2p) for st in state]
    worst = max(float((a - b).abs().max()) for o, q in zip(outs, plain)
                for a, b in zip(o, q))
    _require(all(_bit_equal(torch, o, q) for o, q in zip(outs, plain)),
             f"{kind} sweep differs from its plain version by {worst}")
    # the per-parameter update over the same tensors
    for st, o in zip(state, outs):
        _, p, g, m, v, members = st
        sizes = [n for _, n in members]
        ps, gs, ms, vs = ([t.clone() for t in x.split(sizes)]
                          for x in (p, g, m, v))
        if kind == "adam":
            fo.fused_adam_multi(ps, gs, ms, vs, lr, [b1p] * len(ps),
                                [b2p] * len(ps))
            per = [torch.cat(x) for x in (ps, ms, vs)]
        else:
            per = [torch.cat(fo.fused_sgd_multi(ps, gs, lr))]
        _require(_bit_equal(torch, o, per), f"{kind} sweep differs from "
                                            f"the per-parameter update")
    # ZeRO-1: each shard writes its window alone; the four make the whole
    olds = [(st[1], st[3], st[4]) if kind == "adam" else (st[1],)
            for st in state]
    for st, o, old in zip(state, outs, olds):
        n = st[1].numel()
        per = fo.rows_padded(n) // SWEEP_SHARDS * 128
        merged = [t.clone() for t in old]
        for i in range(SWEEP_SHARDS):
            part = _sweep(fo, kind, st, lr, b1p, b2p,
                          shard=(torch.tensor(i, device=dev), SWEEP_SHARDS))
            lo, hi = min(i * per, n), min((i + 1) * per, n)
            for a, was, acc in zip(part, old, merged):
                _require(torch.equal(a[:lo], was[:lo]) and
                         torch.equal(a[hi:], was[hi:]),
                         f"{kind} shard {i} wrote outside its window")
                acc[lo:hi] = a[lo:hi]
        _require(_bit_equal(torch, merged, o),
                 f"{kind}: the {SWEEP_SHARDS} windows differ from the "
                 f"unsharded sweep")
    # the guard: a nonfinite step changes nothing; a spike is damped
    for st, old in zip(state, olds):
        nf = _sweep(fo, kind, st, lr, b1p, b2p, guard=(1.0, 0.0, 0.0))
        _require(_bit_equal(torch, nf, old),
                 f"{kind}: nonfinite=1 changed the state")
        sp = _sweep(fo, kind, st, lr, b1p, b2p, guard=(0.0, 1.0, 0.5))
        with kreg.plain_reference():
            sp_plain = _sweep(fo, kind, st, lr, b1p, b2p,
                              guard=(0.0, 1.0, 0.5))
        _require(_bit_equal(torch, sp, sp_plain),
                 f"{kind}: the spike gate differs from the plain _gate")
    # capture: one graph, replayed with a new hyper table
    st = state[0]
    guard = [torch.zeros((), device=dev) for _ in range(3)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _sweep(fo, kind, st, lr, b1p, b2p, guard=guard)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap = _sweep(fo, kind, st, lr, b1p, b2p, guard=guard)
    for new_lr, new_guard in ((5e-4, (0.0, 1.0, 0.25)), (2e-3, (0.0, 0.0,
                                                                 0.0))):
        lr.fill_(new_lr)
        for t, x in zip(guard, new_guard):
            t.fill_(x)
        graph.replay()
        eager = _sweep(fo, kind, st, lr, b1p, b2p, guard=new_guard)
        torch.cuda.synchronize()
        _require(_bit_equal(torch, cap, eager),
                 f"{kind}: a replay with a new hyper table differs from "
                 f"the eager sweep")
    del graph, cap
    # capture: the beta powers and the window's index are tensors too,
    # changed between replays; eager takes them as numbers (value slots)
    pows = [t.clone() for t in (b1p, b2p)]
    idx = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.cuda.stream(side):
        _sweep(fo, kind, st, lr, *pows, shard=(idx, SWEEP_SHARDS))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap = _sweep(fo, kind, st, lr, *pows, shard=(idx, SWEEP_SHARDS))
    for step, i in ((7, 2), (20, 3)):
        new_pows = (0.9 ** step, 0.999 ** step)
        for t, x in zip(pows, new_pows):
            t.fill_(x)
        idx.fill_(i)
        graph.replay()
        eager = _sweep(fo, kind, st, lr, *new_pows, shard=(i, SWEEP_SHARDS))
        torch.cuda.synchronize()
        _require(_bit_equal(torch, cap, eager),
                 f"{kind}: a replay with new beta powers and shard index "
                 f"{i} differs from the eager sweep")
    del graph, cap
    print(f"  {kind} sweep over {len(state)} buckets: {launches} launches, "
          f"bit-equal to the plain version, to the per-parameter "
          f"fused_{kind}_multi, across {SWEEP_SHARDS} ZeRO-1 windows (each "
          f"writing only its own), under the guard (nonfinite, spike damp "
          f"0.5), in a replay with a new hyper table and in replays with "
          f"new beta powers and shard index (tensors)")
    return launches, worst


SWEEP_SLEEP = 400_000_000   # card cycles the sweep timings queue behind


def _queued_inside(torch, fn, label, iters=10, cycles=SWEEP_SLEEP,
                   require=True):
    """Device time per call of fn from CUDA events around `iters` calls
    queued behind torch.cuda._sleep(cycles) (SWEEP_SLEEP: about 0.2 s),
    the sleep timed by its own events: raises unless the host queued the
    calls inside the sleep (else the reading holds host gaps), or with
    `require` False returns all the same. Returns (ms a call, host ms
    to queue them, the sleep's ms)."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(cycles)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ev[2].record()
    host = (time.perf_counter() - t0) * 1e3
    ev[2].synchronize()
    sleep = ev[0].elapsed_time(ev[1])
    _require(host < sleep or not require,
             f"{label}: the host took {host:.1f} ms to queue "
                           f"{iters} calls, longer than the card's "
                           f"{sleep:.1f} ms sleep")
    return ev[1].elapsed_time(ev[2]) / iters, host, sleep


# sleep kernels a sweep's profiler session launches first: a session
# loses the events of its first one or two kernels (on the H100: 8 of a
# sweep's 10 seen after the book models phase)
SWEEP_PRIMERS = 4

CU_GRAPH_NODE_TYPE_KERNEL = 0   # cuda.h's CUgraphNodeType


def _graph_kernels(torch, fn):
    """The names of the nodes of a CUDA graph captured from one call of
    fn, read through the driver API (cuGraphGetNodes): every kernel that
    call queues, which no profiler can drop. A node that is no kernel
    reads '<node type N>'."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    ptr = ctypes.c_void_p

    def check(err, what):
        _require(err == 0, f"{what} failed: CUresult {err}")

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = ptr(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(count)),
          "cuGraphGetNodes")
    nodes = (ptr * count.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)),
          "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ptr(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != CU_GRAPH_NODE_TYPE_KERNEL:
            names.append(f"<node type {kind.value}>")
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2 in pointer slots: func [0], kern [7]
        params = (ptr * 16)()
        check(cu.cuGraphKernelNodeGetParams_v2(ptr(node), params),
              "cuGraphKernelNodeGetParams")
        name, err = ctypes.c_char_p(), -1
        if params[0]:
            err = cu.cuFuncGetName(ctypes.byref(name), ptr(params[0]))
        if err and params[7]:
            err = cu.cuKernelGetName(ctypes.byref(name), ptr(params[7]))
        check(err, "cuFuncGetName / cuKernelGetName")
        names.append(name.value.decode())
    del graph
    return names


def _sweep_profile(torch, fn, kind, launches):
    """One sweep's kernels. A CUDA graph captured from one call must hold
    `launches` nodes, each a bucket_sweep_<kind> kernel (_graph_kernels):
    raises otherwise. Then their device ms alone, from torch.profiler:
    each session warms up on one sweep (its events discarded), then
    launches SWEEP_PRIMERS sleep kernels, waits for them and runs the
    sweep; raises if that window holds any kernel but those and the
    sweep's. The median of up to three sessions that saw exactly
    `launches` of the sweep's kernels, out of at most eight; None, said
    in a printed line, where none did (the profiler loses events on this
    card: _device_ms). Returns (ms or None, the graph's node names)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    name = "bucket_sweep_" + kind
    nodes = _graph_kernels(torch, fn)
    _require(len(nodes) == launches and all(name in n for n in nodes),
             f"{kind} sweep: a captured call holds {len(nodes)} nodes "
             f"{sorted(set(n[:60] for n in nodes))}, not {launches} "
             f"{name} kernels")
    fn()
    torch.cuda.synchronize()
    reads, seen_all = [], []
    for _ in range(8):
        got = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=lambda p: got.append(_kernels(p))) \
                as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(SWEEP_PRIMERS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            prof.step()
        kernels = [e for e in (got[0] if got else [])
                   if "spin_kernel" not in e.key]
        others = [e.key[:80] for e in kernels if name not in e.key]
        seen = sum(e.count for e in kernels if name in e.key)
        seen_all.append(seen)
        _require(not others, f"{kind} sweep: the profiled window holds "
                             f"other kernels {others[:4]}")
        if seen == launches:
            reads.append(sum(e.self_device_time_total
                             for e in kernels) / 1e3)
            if len(reads) == 3:
                break
    if not reads:
        print(f"  {kind} sweep: no profiler session saw exactly its "
              f"{launches} launches (saw {seen_all}): its profiler time "
              f"is not measured")
        return None, nodes
    return sorted(reads)[len(reads) // 2], nodes


def _baseline_sweep(torch, fo, baseline, kind, state, lr, b1p, b2p):
    """call() -> outputs of one sweep of an earlier checkout's bucket
    kernels (its fused_optimizer.cu) over every bucket, through that
    checkout's host route: a library without pt_bucket_sweep_args_size
    (the design before the packed arguments) takes a device hyper table
    and window that its wrapper made with 12 (Adam) or 7 (SGD) torch ops
    a bucket, made here as it made them; one with it takes this
    checkout's packed arguments."""
    import ctypes
    lib = _baseline_lib(baseline, "fused_optimizer.cu")
    fn = getattr(lib, "pt_bucket_sweep_" + kind)
    fn.restype = ctypes.c_int
    adam = kind == "adam"
    packed = hasattr(lib, "pt_bucket_sweep_args_size")
    P, F, N = ctypes.c_void_p, ctypes.c_float, ctypes.c_int64
    if packed:
        fn.argtypes = fo._SWEEP_ADAM_ARGS if adam else fo._SWEEP_SGD_ARGS
        _require(lib.pt_bucket_sweep_args_size() ==
                 ctypes.sizeof(fo._SweepArgs),
                 "the baseline's SweepArgs differs from _SweepArgs")
    else:
        fn.argtypes = [P] * 9 + [N] + [F] * 6 + [P] if adam else \
            [P] * 5 + [N, F, P]

    def call():
        outs = []
        stream = torch.cuda.current_stream().cuda_stream
        for _, p, g, m, v, _ in state:
            n, dev = p.numel(), p.device
            bufs = (p, g, m, v) if adam else (p, g)
            out = [torch.empty_like(p) for _ in bufs[1:]]
            if packed:
                args, keep = fo.sweep_args(n, lr, b1p if adam else None,
                                           b2p if adam else None,
                                           device=dev)
                head = [ctypes.byref(args)]
            else:
                rate = fo._on(lr, torch.float32, dev)
                if adam:
                    rate = rate * torch.sqrt(1.0 - b2p.reshape(())) / \
                        (1.0 - b1p.reshape(()))
                hyper = fo.sweep_hyper(rate, None, dev)
                bounds = fo.sweep_bounds(fo.rows_padded(n), None, dev)
                head = [hyper.data_ptr(), bounds.data_ptr()]
            tail = [n, 0.9, 1.0 - 0.9, 0.999, 1.0 - 0.999, 1e-8, 0.0] \
                if adam else [n, 0.0]
            err = fn(*head, *(t.data_ptr() for t in bufs + tuple(out)),
                     *tail, stream)
            _require(err == 0, f"baseline bucket_sweep_{kind} failed: "
                               f"{err}")
            outs.append(out)
        return outs
    return call


def _time_sweep(torch, fo, kind, state, card, dev, baseline=None):
    """Device time of one sweep over every bucket (one launch a bucket):
    queued events around ten sweeps behind a card sleep the host must
    finish queuing inside (the row's time, and the host's ms to queue
    them), beside the profiler's time of the sweep's kernels alone (the
    window may hold nothing else); shard 0 of SWEEP_SHARDS (ZeRO-1) against
    its own bound; its plain version; the bound (Adam 28 bytes an element,
    SGD 12; outside a window 24 and 8); and the library yardstick over the
    same flat tensors: torch.optim.Adam(fused=True), or
    torch._foreach_add_. With `baseline` (an earlier checkout) its sweep
    in turns with this one's (baseline, this, this, baseline), equal
    results required."""
    _, _, peak_bw, _, _ = _peaks(card)
    lr = torch.tensor([SWEEP_LR], device=dev)
    b1p, b2p = _sweep_pows(torch, dev)
    n = sum(st[1].numel() for st in state)

    def kernel(**kw):
        return [_sweep(fo, kind, st, lr, b1p, b2p, **kw) for st in state]

    from paddle_tpu_torch.kernels import registry as kreg

    def plain():
        with kreg.plain_reference():
            kernel()

    label = f"{kind} sweep"
    ms, host, sleep = _queued_inside(torch, kernel, label)
    prof, nodes = _sweep_profile(torch, kernel, kind, len(state))

    def shard():
        return kernel(shard=(0, SWEEP_SHARDS))

    shard_ms, _, _ = _queued_inside(torch, shard, label + ", shard 0")
    pl = _time_ms(plain, iters=3, warmup=1)
    base_ms = None
    if baseline:
        base = _baseline_sweep(torch, fo, baseline, kind, state, lr, b1p,
                               b2p)
        _require(all(_bit_equal(torch, a, b)
                     for a, b in zip(base(), kernel())),
                 f"the baseline's {kind} sweep disagrees")
        # the earlier route queues 13 (Adam) or 8 launches a bucket: more
        # than the launch queue holds, so its host outlasts the sleep
        turns = [_queued_inside(torch, f, label, require=False)
                 for f in (base, kernel, kernel, base)]
        base_ms = (turns[0][0] + turns[3][0]) / 2
        print(f"  {kind} sweep: the baseline checkout's {base_ms:.4f} ms "
              f"against this one's {(turns[1][0] + turns[2][0]) / 2:.4f} "
              f"ms (queued events, in turns: "
              f"{', '.join(f'{t[0]:.4f}' for t in turns)}; host ms to "
              f"queue 10: {', '.join(f'{t[1]:.1f}' for t in turns)}, "
              f"the card's sleep {turns[0][2]:.1f} ms; equal results)")
    params = [st[1].clone() for st in state]
    grads = [st[2].clone() for st in state]
    if kind == "adam":
        leaves = [p.requires_grad_(True) for p in params]
        for prm, g in zip(leaves, grads):
            prm.grad = g
        opt = torch.optim.Adam(leaves, lr=SWEEP_LR, fused=True)
        lib, _, _ = _queued_inside(torch, opt.step, "Adam(fused=True)")
        del opt, leaves
    else:
        lib, _, _ = _queued_inside(torch, lambda: torch._foreach_add_(
            params, grads, alpha=-SWEEP_LR), "_foreach_add_")
    del params, grads
    per = 28 if kind == "adam" else 12
    bound = per * n / peak_bw * 1e3
    inside = sum(min(st[1].numel(), fo.rows_padded(st[1].numel())
                     // SWEEP_SHARDS * 128) for st in state)
    shard_bound = (per * inside + (per - 4) * (n - inside)) / peak_bw * 1e3
    print(f"  {kind} sweep over {len(state)} buckets, {n} elements: kernel "
          f"{ms:.4f} ms ({len(state)} launches, queued events; host "
          f"{host:.1f} ms to queue 10 inside the card's {sleep:.1f} ms "
          f"sleep; a captured call holds {len(nodes)} graph nodes, each a "
          f"bucket_sweep_{kind} kernel), the profiler "
          f"{'not measured' if prof is None else f'{prof:.4f} ms'} for "
          f"the {len(state)} kernels alone (nothing else in the window), "
          f"plain {pl:.4f} "
          f"ms, library {lib:.4f} ms, bound {bound:.4f} ms ({per} B x "
          f"{n}); shard 0 of {SWEEP_SHARDS} {shard_ms:.4f} ms against its "
          f"bound {shard_bound:.4f} ms ({per} B x {inside} inside, "
          f"{per - 4} B x {n - inside} outside)")
    return {"ms": ms, "plain_ms": pl, "library_ms": lib, "bound_ms": bound,
            "bound_by": "bytes", "profiler_ms": prof, "host_ms": host,
            "shard_ms": shard_ms, "shard_bound_ms": shard_bound,
            "baseline_ms": base_ms}


BWD_F32_TOL = 1e-4   # tests/test_torch_cuda.py's float32 backward tolerance


def _lse_exact(torch, q, k, v, bias, g_out, g_lse, scale):
    """float64 gradients of the composed (out, lse) of attention."""
    qd, kd, vd = (x.detach().double().requires_grad_() for x in (q, k, v))
    s = qd @ kd.transpose(-1, -2) * scale + bias.double()
    torch.autograd.backward(
        [torch.softmax(s, -1) @ vd, torch.logsumexp(s, -1)],
        [g_out.double(), g_lse.double()])
    return qd.grad, kd.grad, vd.grad


def flash_lse_phase(torch, dev):
    """flash_attention_lse at the training shape (B=96, S=128, H=8, D=64,
    [B, H, S, D], key-padding bias) in bf16 (tensor-core kernels) and
    float32 (tensor-core forward, CUDA-core backward): with g_lse = 0 the
    gradients equal fused_attention_backward's bit for bit; with a random
    g_lse they are held to float64 exact gradients of the composed
    (out, lse), float32 within BWD_F32_TOL, bf16 within
    bf16_backward_bound (its step 3). Returns {kernel: launches made
    with a g_lse} and the worst errors."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import registry as kreg
    B, H, S, D = TRAIN_B, 8, TRAIN_S, 64
    scale = D ** -0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 18)
    lens = torch.randint(S // 2, S + 1, (B,), generator=gen, device=dev)
    bias = torch.where(torch.arange(S, device=dev)[None] < lens[:, None],
                       0.0, -1e9).float()[:, None, None, :]
    launches, worst = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, g_out = (torch.randn((B, H, S, D), generator=gen,
                                      device=dev).to(dtype)
                          for _ in range(4))
        g_lse = torch.randn((B, H, S), generator=gen, device=dev)
        kreg.reset_counts()
        grads = {}
        for label, gl in (("zero", torch.zeros_like(g_lse)),
                          ("random", g_lse)):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            out, lse = fa.flash_attention_lse(*leaves, bias, scale)
            torch.autograd.backward([out, lse], [g_out, gl])
            grads[label] = [x.grad for x in leaves]
        torch.cuda.synchronize()
        got = kreg.launches()
        sm90 = dtype == torch.bfloat16
        dq_name = "flash_attention_bwd_dq_sm90" if sm90 else \
            "flash_attention_bwd_dq"
        dkv_name = "flash_attention_bwd_dkv_sm90" if sm90 else \
            "flash_attention_bwd_dkv"
        fwd_name = "flash_attention_fwd_sm90" if sm90 else \
            "flash_attention_fwd_f32_sm90"
        _require(got[fwd_name] == 2 and got[dq_name] == 2 and
                 got[dkv_name] == 2 and got["flash_attention_bwd_dq"] == 2,
                 f"flash_attention_lse {_dname(torch, dtype)}: launches "
                 f"{ {n: c for n, c in got.items() if c} }")
        # both calls pass a g_lse tensor (zeros, then random)
        launches[dq_name] = launches.get(dq_name, 0) + 2
        launches[dkv_name] = launches.get(dkv_name, 0) + 2
        out, lse = fa.fused_attention_forward(q, k, v, bias, scale, False,
                                              "bhsd", return_lse=True)
        ref = fa.fused_attention_backward(q, k, v, bias, out, lse, g_out,
                                          scale, False, "bhsd")
        _require(all(torch.equal(a, b) for a, b in zip(grads["zero"], ref)),
                 f"flash_attention_lse {_dname(torch, dtype)}: g_lse = 0 "
                 f"differs from fused_attention_backward")
        name = _dname(torch, dtype)
        if sm90:
            exact, bound = fa.bf16_backward_bound(q, k, v, bias, out, lse,
                                                  g_out, scale, False,
                                                  "bhsd", g_lse=g_lse)
            excess = max(float(((a.double() - e).abs() - w).max())
                         for a, e, w in zip(grads["random"], exact, bound))
            err = max(float((a.double() - e).abs().max())
                      for a, e in zip(grads["random"], exact))
            _require(excess <= 0, f"flash_attention_lse bf16 exceeds "
                                  f"bf16_backward_bound by {excess}")
            print(f"  {name}: g_lse=0 bit-equal to fused_attention_backward; "
                  f"random g_lse: worst |err| {err:.3e} against exact, "
                  f"within bf16_backward_bound (worst excess {excess:.3e})")
        else:
            exact = _lse_exact(torch, q, k, v, bias, g_out, g_lse, scale)
            err, ok = 0.0, True
            for a, e in zip(grads["random"], exact):
                e_, ok_ = _close(torch, a, e, BWD_F32_TOL)
                err, ok = max(err, e_), ok and ok_
            _require(ok, f"flash_attention_lse float32 off the exact "
                         f"gradients by {err}")
            print(f"  {name}: g_lse=0 bit-equal to fused_attention_backward; "
                  f"random g_lse: worst |err| {err:.3e} against float64 exact "
                  f"(BWD_F32_TOL {BWD_F32_TOL})")
        worst[name] = err
        del q, k, v, g_out, grads, ref, out, lse
    print(f"  launches with a g_lse: {launches}")
    return launches, worst


def bucket_sweep_phase(torch, dev, card, built, baseline=None):
    """kernels.fused_optimizer.bucket_sweep over Transformer-base's planned
    buckets at full width: Adam then SGD, each held to its plain version,
    the per-parameter update, the ZeRO-1 windows, the guard's gate and
    captured replays; then timed (with `baseline`, an earlier checkout's
    sweep in turns). Returns ({kind: launches}, {kind: worst}, {kind:
    times})."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    from paddle_tpu_torch.kernels import registry as kreg
    state = _sweep_state(torch, pt, built)
    launches, worst, times = {}, {}, {}
    for kind in ("adam", "sgd"):
        launches[kind], worst[kind] = _sweep_checks(torch, fo, kreg, kind,
                                                    state, dev)
    for kind in ("adam", "sgd"):
        times[kind] = _time_sweep(torch, fo, kind, state, card, dev,
                                  baseline)
    del state
    gc_cuda(torch)
    return launches, worst, times



# ---------------------------------------------------------------------------
# the learning-rate schedules, the contrib decoder, the value-dependent
# sequence ops and the op sweep
# ---------------------------------------------------------------------------

NOAM = (512, 4000)    # Transformer-base's noam_decay(d_model, warmup)
# the rate a step reads against the schedule's closed form (the JAX
# package's formula, in float64): float32 ops on the card
LR_RTOL = 1e-6
RN_BOUNDS, RN_VALUES = [1, 3], [0.1, 0.01, 0.001]   # piecewise_decay
CT_TGT = 26           # the contrib training decoder's target length
CT_RUNS = 4           # Adam steps, contrib against mt_train
# bf16 decodes: scores within bf16's unit roundoff of each other (the
# bound mt_phase holds the bf16 decode to, MT_SCORE_RTOL)
MT_BF16_RTOL = 2.0 ** -9


def _noam(step):
    d, w = NOAM
    return d ** -0.5 * min(step ** -0.5, step * w ** -1.5)


def lr_schedule_phase(torch, dev):
    """Transformer-base as the training phase builds it (B=96, S=128,
    dropout 0.1, bf16 AMP) with AdamOptimizer(noam_decay(512, 4000)):
    CAP_CMP_STEPS + 1 runs captured against as many eager ones, bit for
    bit, 18 / 18 / 18 attention and 1 fused_adam launch a run, and the
    rate each run reads against the schedule; then ResNet-50 (bf16 AMP,
    Momentum) under piecewise_decay, one eager run and one captured,
    against two eager runs, with the capture rule's verdict. Returns the
    fused_adam launches of the captured runs."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    from paddle_tpu_torch.models import transformer as T
    t0 = time.perf_counter()
    cfg = T.transformer_base(fuse_attention=True, dropout=0.1)
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, _, _ = T.transformer_train(cfg)
        lr = pt.layers.noam_decay(*NOAM)
        pt.contrib.mixed_precision.decorate(
            pt.optimizer.AdamOptimizer(learning_rate=lr)).minimize(cost)
    main.random_seed = startup.random_seed = SEED
    want = {"flash_attention_fwd": 18, "flash_attention_bwd_dq": 18,
            "flash_attention_bwd_dkv": 18, "flash_attention_fwd_sm90": 18,
            "flash_attention_bwd_dq_sm90": 18,
            "flash_attention_bwd_dkv_sm90": 18, "fused_adam": 1}
    runs = []
    c = _cap_compare(torch, pt, kreg, "Transformer-base noam_decay", main,
                     startup, _training_feed(T, cfg), [cost, lr],
                     CAP_CMP_STEPS, want, fetched=runs)
    rates = [float(np.asarray(r[1]).reshape(-1)[0]) for r in runs]
    rel = max(abs(r - _noam(i + 1)) / _noam(i + 1)
              for i, r in enumerate(rates))
    print(f"  noam_decay{NOAM}: rates read by the {len(rates)} runs "
          f"{', '.join(f'{r:.6e}' for r in rates)}; worst relative "
          f"difference from the schedule {rel:.3e} (<= {LR_RTOL})")
    _require(rel <= LR_RTOL, f"noam_decay rates off by {rel}")
    adam = c["replays"] + 1   # one launch a run: the eager one's too
    gc_cuda(torch)

    pt.framework.unique_name.reset()
    rmain, rstart = pt.Program(), pt.Program()
    with pt.program_guard(rmain, rstart):
        rcost, _, _ = pt.models.resnet_train(depth=50)
        rlr = pt.layers.piecewise_decay(RN_BOUNDS, RN_VALUES)
        pt.contrib.mixed_precision.decorate(pt.optimizer.MomentumOptimizer(
            rlr, RN_MU)).minimize(rcost)
    rmain.random_seed = rstart.random_seed = SEED
    runs = []
    rc = _cap_compare(torch, pt, kreg, "ResNet-50 piecewise_decay", rmain,
                      rstart, _resnet_feed(), [rcost, rlr], 1,
                      fetched=runs)
    rates = [float(np.asarray(r[1]).reshape(-1)[0]) for r in runs]
    _require(rates == [np.float32(RN_VALUES[1]).item()] * 2,
             f"piecewise_decay rates {rates}")
    print(f"  ResNet-50 piecewise_decay{RN_BOUNDS, RN_VALUES}: runs read "
          f"{rates}; the capture rule captured the step ({rc['captures']} "
          f"capture, eager reasons none: the JAX package's schedule "
          f"selects arithmetically, with no Switch block)")
    gc_cuda(torch)
    print(f"  lr schedule phase: {time.perf_counter() - t0:.1f} s")
    return adam


def _mt_contrib_scopes(torch, pt, mt):
    """The init scopes of contrib_train and mt_train at full width, with
    the same parameters (contrib_train's startup's)."""
    scopes = {}
    progs = {}
    for name, build in (("contrib", lambda: mt.contrib_train(
            lr=CF_LR, tgt_len=CT_TGT, **MT)),
                        ("mt", lambda: mt.mt_train(lr=CF_LR, **MT))):
        pt.framework.unique_name.reset()
        main, startup, loss = build()
        main.random_seed = startup.random_seed = SEED
        scopes[name] = pt.Scope()
        pt.Executor(pt.CUDAPlace(0)).run(startup, scope=scopes[name])
        progs[name] = (main, loss)
    for p in progs["mt"][0].all_parameters():
        scopes["mt"].find_var(p.name).get_tensor().set_tensor(
            scopes["contrib"].find_var(p.name).get_tensor().tensor.clone())
    return scopes, progs


def _decode_pair(torch, pt, kreg, mt, mode, progs, scope, feed, t_src):
    """contrib_decode against mt_decode in one GEMM mode ("" float32):
    the contrib decode captured against eager (one CUDA graph, bit for
    bit), then a replay of each program: (quantized_matmul launches a
    decode, ids equal, worst relative score difference)."""
    label = f"contrib decode {mode or 'float32'}"
    name = f"quantized_matmul_{mode}" if mode else None
    per_run = 2 * t_src + 2 * MT_LEN
    old = os.environ.get("PT_KERNEL_QUANT_MATMUL")
    os.environ["PT_KERNEL_QUANT_MATMUL"] = mode
    try:
        cexe, _, _, reasons, launched = _seq_compare(
            torch, pt, kreg, label, progs["contrib"][0],
            progs["contrib"][1], scope, [feed], MT_RUNS_DECODE,
            kernels={name: per_run} if mode else None)
        _require(not reasons, f"{label}: kept eager: {reasons}")
        got = {}
        for key in ("contrib", "mt"):
            exe = pt.Executor(pt.CUDAPlace(0))
            for _ in range(2):       # the plan, then the capture
                out = _cap_run(exe, progs[key][0], feed, progs[key][1],
                               scope)
            got[key] = [np.asarray(v) for v in out]
            exe.close()
        cexe.close()
    finally:
        if old is None:
            os.environ.pop("PT_KERNEL_QUANT_MATMUL")
        else:
            os.environ["PT_KERNEL_QUANT_MATMUL"] = old
    ids_equal = np.array_equal(got["contrib"][0], got["mt"][0])
    d = np.abs(got["contrib"][1] - got["mt"][1])
    rel = float((d / np.maximum(np.abs(got["mt"][1]), 1e-30)).max())
    n = launched.get(name, 0) // MT_RUNS_DECODE if name else 0
    print(f"  {label}: against mt_decode: ids equal {ids_equal}, scores "
          f"bit-equal {bool((d == 0).all())}, worst relative difference "
          f"{rel:.3e}; {n} {name or 'quantized_matmul'} launches a decode")
    return n, ids_equal, rel


def contrib_decoder_phase(torch, dev):
    """The book's machine translation model through the contrib decoder
    API (models/machine_translation.py contrib_train, contrib_decode) at
    chapter 08's widths (30000 / 512 / 512): CT_RUNS Adam steps of the
    TrainingDecoder captured against eager and against mt_train's on
    the same sources and targets of CT_TGT words, losses bit-equal; then
    the BeamSearchDecoder (128 sources, beam 4, 80 steps) captured as one
    CUDA graph against eager and against mt_decode in float32, int8
    (bit-equal) and bf16 (ids equal, scores within MT_BF16_RTOL).
    Returns (fused_adam launches, quantized_matmul launches by mode)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    from paddle_tpu_torch.models import machine_translation as mt
    t0 = time.perf_counter()
    scopes, progs = _mt_contrib_scopes(torch, pt, mt)
    cfeed, mfeed = mt.dense_target_feed(np.random.default_rng(300), CF_B,
                                        MT["vocab"], CT_TGT,
                                        pt.CUDAPlace(0), **CF_LEN)
    losses, adam, trained = {}, 0, None
    for name, feed in (("contrib", cfeed), ("mt", mfeed)):
        main, loss = progs[name]
        _, routed = _routed_params(kreg, main)
        exe, scope, losses[name], reasons, launched = _seq_compare(
            torch, pt, kreg, f"{name} training", main, [loss],
            scopes[name], [feed], CT_RUNS, len(routed))
        _require(not reasons, f"{name} training kept eager: {reasons}")
        adam += launched.get("fused_adam", 0)
        exe.close()
        if name == "mt":
            trained = scope
    print(f"  contrib TrainingDecoder against mt_train, {CT_RUNS} Adam "
          f"steps at B={CF_B}, targets of {CT_TGT} words: losses "
          f"{losses['contrib']} / {losses['mt']}, bit-equal "
          f"{losses['contrib'] == losses['mt']}")
    _require(losses["contrib"] == losses["mt"],
             "the contrib training decoder's losses differ from mt_train's")
    del scopes
    gc_cuda(torch)
    for mine, theirs in mt.CONTRIB_NAMES.items():
        trained.var(mine).get_tensor().set_tensor(
            trained.find_var(theirs).get_tensor().tensor.clone())
    pt.framework.unique_name.reset()
    cdec, cids, csc = mt.contrib_decode(beam=MT_BEAM, max_len=MT_LEN, **MT)
    pt.framework.unique_name.reset()
    mdec, mids, msc = mt.mt_decode(beam=MT_BEAM, max_len=MT_LEN, **MT)
    dprogs = {"contrib": (cdec, [cids, csc]), "mt": (mdec, [mids, msc])}
    feed = _mt_decode_feed(pt, pt.CUDAPlace(0))
    t_src = int(np.diff(feed["src"].lod()[0]).max())
    qmm = {}
    for mode in ("", "int8", "bf16"):
        n, same_ids, rel = _decode_pair(torch, pt, kreg, mt, mode, dprogs,
                                        trained, feed, t_src)
        if mode:
            qmm[mode] = n * MT_RUNS_DECODE
        _require(same_ids and (rel == 0 if mode != "bf16"
                               else rel <= MT_BF16_RTOL),
                 f"contrib decode {mode or 'float32'} differs from "
                 f"mt_decode")
    del trained
    gc_cuda(torch)
    print(f"  contrib decoder phase: {time.perf_counter() - t0:.1f} s")
    return adam, qmm


def value_sequence_phase(torch, dev):
    """sequence_erase, sequence_slice and edit_distance on a CTC-style
    batch (SEQ_B sequences of IMDB-shaped lengths, the sequence phase's
    first batch, ids below 30): the program on the card against the same
    program on the CPU, values and output LoDs equal, the block eager
    with each op named in Engine.eager_reasons."""
    import paddle_tpu_torch as pt
    t0 = time.perf_counter()
    ids, lens, _ = _seq_batch(0)
    ids = ids % 30
    refs = (ids + (np.arange(len(ids))[:, None] % 7 == 0)) % 30
    n = len(lens[0])
    offsets = np.array([[min(3, L - 1)] for L in lens[0]], np.int64)
    lengths = np.array([[max(1, (L - 3) // 2)] for L in lens[0]],
                       np.int64)
    for op_type in ("sequence_erase", "sequence_slice", "edit_distance"):
        pt.framework.unique_name.reset()
        main = pt.Program()
        L = pt.layers
        with pt.program_guard(main, pt.Program()):
            x = L.data("ids", [1], dtype="int64", lod_level=1)
            if op_type == "sequence_erase":
                out = L.sequence_erase(x, tokens=[0, 1, 2])
            elif op_type == "sequence_slice":
                out = L.sequence_slice(x, L.data("off", [1], dtype="int64"),
                                       L.data("len", [1], dtype="int64"))
            else:
                y = L.data("refs", [1], dtype="int64", lod_level=1)
                out, _ = L.edit_distance(x, y, normalized=True)
        got = []
        for place in (pt.CUDAPlace(0), pt.CPUPlace()):
            feed = {"ids": pt.create_lod_tensor(ids, lens, place),
                    "refs": pt.create_lod_tensor(refs, lens, place),
                    "off": offsets, "len": lengths}
            exe = pt.Executor(place)
            for _ in range(2):
                res = exe.run(main, feed=feed, fetch_list=[out],
                              return_numpy=False)[0]
            vals = res.cpu() if isinstance(res, torch.Tensor) else res
            got.append((np.asarray(vals), getattr(res, "lod", list)(),
                        list(exe._engine.eager_reasons.values()),
                        _counters(exe)))
            exe.close()
        (a, alod, reasons, cnt), (b, blod, _, _) = got
        _require(np.array_equal(a, b) and alod == blod,
                 f"{op_type}: the card's output differs from the CPU's")
        _require(reasons == [op_type] and cnt["captures"] == 0 and
                 cnt["eager_runs"] == 2,
                 f"{op_type}: eager reasons {reasons}, counters {cnt}")
        print(f"  {op_type} on {n} sequences ({len(ids)} rows): output "
              f"{a.dtype} {list(a.shape)} equal to the CPU's, LoD equal; "
              f"2 eager runs, eager reasons {reasons}")
    print(f"  value-dependent sequence phase: "
          f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# [detection phase]: MobileNet-SSD as PaddleCV's object_detection defines it
# ---------------------------------------------------------------------------

SSD = {"num_classes": 21, "image": 300, "scale": 1.0}   # Pascal VOC
SSD_B = 64          # train.py's batch
SSD_POOL = 2        # LoD batches cycled (each its own plan and graph)
SSD_RUNS = 4        # runs of each pool batch: 8 steps captured vs eager
SSD_STREAM = 3      # new LoD batches run once each, eagerly
SSD_TIMED = 5       # detection runs timed a mode
# gt boxes an image: geometric with mean SSD_BOXES[0], clipped to
# [SSD_BOXES[1], SSD_BOXES[2]] (VOC 2007+2012 trainval: 2.4 objects an
# image on average, 1 to 42)
SSD_BOXES = (2.4, 1, 42)
SSD_DIFFICULT = 0.1     # share of boxes flagged difficult
# train.py's schedule: lr 1e-3, decayed at epochs 40, 60, 80, 100 of
# 16551 images (VOC 2007+2012 trainval) at SSD_B a step; L2Decay(5e-5)
SSD_LR = 1e-3
SSD_LR_EPOCHS = (40, 60, 80, 100)
SSD_LR_DECAY = (1.0, 0.5, 0.25, 0.1, 0.01)
SSD_L2 = 5e-5
# eval.py / infer.py's detection_output
SSD_DET = {"nms_threshold": 0.45, "nms_top_k": 400, "keep_top_k": 200,
           "score_threshold": 0.01}
# the first loss, card against CPU: float32 convolutions (TF32 off)
# summed in other orders; the mining's sort can take another of two
# near-equal negatives
SSD_LOSS_RTOL = 1e-4
# detection rows, predictor against the Executor (both on the card)
SSD_ROWS_ATOL = 1e-6


def mobilenet_ssd(L, img, num_classes, scale=1.0):
    """PaddleCV object_detection/mobilenet_ssd.py's MobileNetSSD.ssd_net
    built with the layers module `L` (the port's or the JAX package's):
    MobileNet-v1 at `scale` with depthwise-separable blocks (a depthwise
    conv2d(groups=C, use_cudnn=False), then a 1x1 conv, each with batch
    norm and relu; every conv's filter MSRA-initialized at learning rate
    0.1, no bias), four extra blocks down to 1x1, and multi_box_head over
    the 19, 10, 5, 3, 2 and 1 maps of a 300x300 image: 1917 priors.
    Returns (locs [N, P, 4], confs [N, P, num_classes], boxes [P, 4],
    variances [P, 4])."""
    import importlib
    pkg = importlib.import_module(L.__name__.rpartition(".")[0])

    def conv_bn(x, k, n, stride, padding, groups=1, use_cudnn=True):
        conv = L.conv2d(x, n, k, stride=stride, padding=padding,
                        groups=groups, act=None, use_cudnn=use_cudnn,
                        param_attr=pkg.ParamAttr(
                            learning_rate=0.1,
                            initializer=pkg.initializer.MSRA()),
                        bias_attr=False)
        return L.batch_norm(conv, act="relu")

    def separable(x, n1, n2, groups, stride):
        dw = conv_bn(x, 3, int(n1 * scale), stride, 1,
                     groups=int(groups * scale), use_cudnn=False)
        return conv_bn(dw, 1, int(n2 * scale), 1, 0)

    def extra(x, n1, n2, stride):
        x = conv_bn(x, 1, int(n1 * scale), 1, 0)
        return conv_bn(x, 3, int(n2 * scale), stride, 1)

    x = conv_bn(img, 3, int(32 * scale), 2, 1)                  # 150
    for n1, n2, g, s in ((32, 64, 32, 1), (64, 128, 64, 2),     # 75
                         (128, 128, 128, 1), (128, 256, 128, 2),  # 38
                         (256, 256, 256, 1), (256, 512, 256, 2)):  # 19
        x = separable(x, n1, n2, g, s)
    for _ in range(5):
        x = separable(x, 512, 512, 512, 1)
    m11 = x
    x = separable(x, 512, 1024, 512, 2)                         # 10
    m13 = separable(x, 1024, 1024, 1024, 1)
    m14 = extra(m13, 256, 512, 2)                               # 5
    m15 = extra(m14, 128, 256, 2)                               # 3
    m16 = extra(m15, 128, 256, 2)                               # 2
    m17 = extra(m16, 64, 128, 2)                                # 1
    return L.multi_box_head(
        inputs=[m11, m13, m14, m15, m16, m17], image=img,
        num_classes=num_classes, min_ratio=20, max_ratio=90,
        min_sizes=[60.0, 105.0, 150.0, 195.0, 240.0, 285.0],
        max_sizes=[[], 150.0, 195.0, 240.0, 285.0, 300.0],
        aspect_ratios=[[2.], [2., 3.], [2., 3.], [2., 3.], [2., 3.],
                       [2., 3.]],
        base_size=img.shape[2], offset=0.5, flip=True)


def ssd_train(pt, num_classes, image, scale, batch=None):
    """(main, startup, loss, (locs, confs, boxes, variances)) of train.py:
    mobilenet_ssd, ssd_loss over the LoD ground truth (gt_box float32,
    gt_label int32, one segment an image) summed, minimized by
    RMSProp(piecewise_decay from SSD_LR, L2Decay(SSD_L2))."""
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = L.data("img", [3, image, image], dtype="float32")
        gt_box = L.data("gt_box", [4], dtype="float32", lod_level=1)
        gt_label = L.data("gt_label", [1], dtype="int32", lod_level=1)
        head = mobilenet_ssd(L, img, num_classes, scale)
        loss = L.reduce_sum(L.ssd_loss(head[0], head[1], gt_box, gt_label,
                                       head[2], head[3]))
        iters = 16551 // (batch or SSD_B)
        lr = L.piecewise_decay([e * iters for e in SSD_LR_EPOCHS],
                               [SSD_LR * d for d in SSD_LR_DECAY])
        pt.optimizer.RMSProp(
            learning_rate=lr,
            regularization=pt.regularizer.L2Decay(SSD_L2)).minimize(loss)
    return main, startup, loss, head


def ssd_detect(pt, main, head, with_map=False):
    """eval.py's program on the trained net: the forward of `main` up to
    the head (batch norm in inference mode), detection_output with
    SSD_DET; with `with_map`, also the difficult flags and the
    DetectionMAP evaluator (11point, overlap 0.5, difficult boxes not
    evaluated). Returns (program, nmsed, evaluator or None)."""
    L = pt.layers
    prog = pt.io._prune_program(main, [v.name for v in head])
    block = prog.global_block()
    with pt.program_guard(prog, pt.Program()):
        nmsed = L.detection_output(*[block.var(v.name) for v in head],
                                   **SSD_DET)
        ev = None
        if with_map:
            difficult = L.data("difficult", [1], dtype="int32",
                               lod_level=1)
            ev = pt.evaluator.DetectionMAP(
                nmsed, block.var("gt_label"), block.var("gt_box"),
                difficult, SSD["num_classes"], overlap_threshold=0.5,
                evaluate_difficult=False, ap_version="11point")
    return prog, nmsed, ev


def _voc_batch(torch, pt, seed, place, B=None, image=None):
    """A VOC-shaped batch from default_rng(seed): B images (standard
    normal, on `place`'s device), a geometric number of boxes an image
    (SSD_BOXES), each normalized with sides log-uniform in [0.05, 0.95],
    labels 1-20, SSD_DIFFICULT of them difficult; gt_box, gt_label and
    difficult as LoD tensors on `place`."""
    B, image = B or SSD_B, image or SSD["image"]
    rng = np.random.default_rng(seed)
    mean, lo, hi = SSD_BOXES
    n = np.clip(rng.geometric(1.0 / mean, B), lo, hi)
    g = int(n.sum())
    wh = np.exp(rng.uniform(np.log(0.05), np.log(0.95), (g, 2)))
    c = rng.uniform(wh / 2, 1 - wh / 2)
    box = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    label = rng.integers(1, SSD["num_classes"], (g, 1)).astype(np.int32)
    difficult = (rng.random((g, 1)) < SSD_DIFFICULT).astype(np.int32)
    gen = torch.Generator()
    gen.manual_seed(seed)
    img = torch.randn((B, 3, image, image), generator=gen).to(
        place.torch_device())
    lens = [n.tolist()]
    return {"img": img,
            "gt_box": pt.create_lod_tensor(box, lens, place),
            "gt_label": pt.create_lod_tensor(label, lens, place),
            "difficult": pt.create_lod_tensor(difficult, lens, place)}


def _train_mode_loss_cpu(pt, main, loss, state, feed):
    """The forward of `main` up to `loss` on the CPU from `state` (name
    -> CPU tensor) on `feed`, batch norm in training mode (a test clone
    would normalize by the running statistics)."""
    prog = main.clone()
    block = prog.global_block()
    needed, keep = {loss.name}, []
    for op in reversed(block.ops):
        if op.attr("op_role", "forward") == "forward" and \
                set(op.output_arg_names) & needed:
            keep.append(op)
            needed.update(op.input_arg_names)
    block.ops = keep[::-1]
    scope = pt.Scope()
    for n, t in state.items():
        scope.var(n).get_tensor().set_tensor(t.clone())
    return float(pt.Executor(pt.CPUPlace()).run(
        prog, feed=feed, fetch_list=[loss], scope=scope,
        use_program_cache=False)[0])


def _train_feed(f):
    return {k: f[k] for k in ("img", "gt_box", "gt_label")}


def _ssd_train_phase(torch, pt, kreg, card):
    """MobileNet-SSD trained captured against eager: returns (main, the
    trained scope, head, feeds)."""
    t0 = time.perf_counter()
    pt.framework.unique_name.reset()
    main, startup, loss, head = ssd_train(pt, SSD["num_classes"],
                                          SSD["image"], SSD["scale"])
    main.random_seed = startup.random_seed = SEED
    types = [op.type for op in main.global_block().ops]
    priors = int(head[2].shape[0])
    params = main.all_parameters()
    print(f"  ssd: {len(types)} ops in block 0 "
          f"({types.count('depthwise_conv2d')} depthwise_conv2d, "
          f"{types.count('conv2d')} conv2d, {types.count('rmsprop')} "
          f"rmsprop, {types.count('sum')} sum); {len(params)} parameters, "
          f"{sum(int(np.prod(p.shape)) for p in params)} elements; "
          f"{priors} priors, {SSD['num_classes']} classes, "
          f"{SSD['image']}x{SSD['image']}, B={SSD_B}")
    _require(priors == 1917, f"ssd: {priors} priors, want 1917")
    init = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init)
    cpu_state = {n: v.get_tensor().tensor.to("cpu", copy=True)
                 for n, v in init._vars.items()}
    seeds = list(range(SSD_POOL))
    batches = [_voc_batch(torch, pt, s, pt.CUDAPlace(0)) for s in seeds]
    feeds = [_train_feed(b) for b in batches]
    boxes = 0
    for s, f in zip(seeds, feeds):
        n = np.diff(f["gt_box"].lod()[0])
        boxes += int(n.sum())
        print(f"  batch {s}: {SSD_B} images, {n.sum()} boxes ({n.min()}-"
              f"{n.max()} an image, mean {n.mean():.2f})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    exe, scope, losses, reasons, _ = _seq_compare(
        torch, pt, kreg, "ssd", main, [loss], init, feeds, SSD_RUNS)
    _require(not reasons, f"ssd: a block was kept eager: {reasons}")
    t1 = time.perf_counter()
    cpu_feed = {k: v if k != "img" else v.cpu() for k, v in
                _train_feed(_voc_batch(torch, pt, seeds[0],
                                       pt.CPUPlace())).items()}
    cpu = _train_mode_loss_cpu(pt, main, loss, cpu_state, cpu_feed)
    err = abs(losses[0] - cpu) / abs(cpu)
    print(f"  ssd: first loss {losses[0]:.6f} on the card, {cpu:.6f} on "
          f"the CPU ({time.perf_counter() - t1:.1f} s): rel err "
          f"{err:.3e} (bound {SSD_LOSS_RTOL:g})")
    _require(err <= SSD_LOSS_RTOL, "ssd: card and CPU disagree")
    _seq_rates(torch, pt, "ssd", exe, main, [loss], scope, feeds, boxes,
               True, B=SSD_B, units=("images", "gt boxes"))
    _profiled_replay(torch, "ssd", exe, main, feeds[0], [loss], scope)
    stream = [_train_feed(_voc_batch(torch, pt, 100 + i, pt.CUDAPlace(0)))
              for i in range(SSD_STREAM)]
    _seq_stream(torch, pt, "ssd", main, loss, init, stream,
                sum(int(f["gt_box"].lod()[0][-1]) for f in stream), SSD_B,
                unit="gt boxes")
    exe.close()
    print(f"  ssd training: {time.perf_counter() - t0:.1f} s")
    return main, scope, head, batches


def _det_rows(out):
    rows = np.asarray(out)
    lod = out.lod() if hasattr(out, "lod") else []
    return rows, lod


def _ssd_nms_alone(torch, pt, scope, det_prog, feed):
    """multiclass_nms alone on the detection program's decoded boxes
    and transposed scores (B x 21 x 1917): eager and captured, device
    rows against the CPU's, ms a call each way."""
    L = pt.layers
    block = det_prog.global_block()
    nms_op = [op for op in block.ops if op.type == "multiclass_nms"][0]
    names = (nms_op.input("BBoxes")[0], nms_op.input("Scores")[0])
    exe = pt.Executor(pt.CUDAPlace(0))
    bx, sc = exe.run(det_prog, feed=feed, fetch_list=list(names),
                     scope=scope, use_program_cache=False,
                     return_numpy=False)
    exe.close()
    pt.framework.unique_name.reset()
    prog = pt.Program()
    with pt.program_guard(prog, pt.Program()):
        b = L.data("bboxes", list(bx.shape[1:]), dtype="float32")
        s = L.data("scores", list(sc.shape[1:]), dtype="float32")
        out = L.multiclass_nms(b, s, background_label=0, normalized=False,
                               nms_eta=1.0, **SSD_DET)
    f = {"bboxes": bx, "scores": sc}
    exe = pt.Executor(pt.CUDAPlace(0))
    secs = {}
    for mode in ("eager", "captured"):
        cached = mode == "captured"
        for _ in range(2):
            _cap_run(exe, prog, f, [out], None, cached, numpy=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SSD_TIMED):
            got = _cap_run(exe, prog, f, [out], None, cached,
                           numpy=False)[0]
        torch.cuda.synchronize()     # a fetch with a LoD stays on the card
        secs[mode] = (time.perf_counter() - t0) / SSD_TIMED
    wall, busy, n_kernels, _ = _seq_profile(torch, lambda: _cap_run(
        exe, prog, f, [out], None, numpy=False))
    secs["device"] = wall * busy
    cpu = pt.Executor(pt.CPUPlace()).run(
        prog, feed={"bboxes": bx.cpu(), "scores": sc.cpu()},
        fetch_list=[out])[0]
    equal = np.array_equal(np.asarray(got), np.asarray(cpu))
    c = _counters(exe)
    exe.close()
    print(f"  multiclass_nms alone at {list(sc.shape)} (nms_top_k "
          f"{SSD_DET['nms_top_k']}, keep_top_k {SSD_DET['keep_top_k']}): "
          f"eager {1e3 * secs['eager']:.3f} ms a call, captured "
          f"{1e3 * secs['captured']:.3f} ms a call (the host's clock to "
          f"a synchronize); a profiled replay {n_kernels} kernels, "
          f"{1e3 * secs['device']:.3f} ms of device time in {1e3 * wall:.3f} "
          f"ms; rows equal to the CPU's {equal}; counters {c}")
    _require(equal, "multiclass_nms: the card's rows differ from the CPU's")
    return secs


def _ssd_detect_phase(torch, pt, main, scope, head, batches):
    """detection_output on the trained net through Executor.run (eager,
    then captured) and through AnalysisPredictor; DetectionMAP over two
    batches, eager; images/s of detection and a profiled replay."""
    import tempfile
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    t0 = time.perf_counter()
    prog, nmsed, _ = ssd_detect(pt, main, head)
    feeds = [{"img": b["img"]} for b in batches]
    exe = pt.Executor(pt.CUDAPlace(0))
    rows = []
    with _deterministic(torch):
        for cached in (False, True, True, True):
            rows.append(_det_rows(_cap_run(exe, prog, feeds[0], [nmsed],
                                           scope, cached)[0]))
    c = _counters(exe)
    eq = all(np.array_equal(r[0], rows[0][0]) and r[1] == rows[0][1]
             for r in rows)
    det, lod = rows[0]
    kept = det[det[:, 0] >= 0]
    print(f"  detect: {len(prog.global_block().ops)} ops; rows "
          f"{list(det.shape)}, LoD {lod[0][:3]}...{lod[0][-1]}; "
          f"{len(kept)} detections (labels {int(kept[:, 0].min()) if len(kept) else '-'}-"
          f"{int(kept[:, 0].max()) if len(kept) else '-'}, scores "
          f"{kept[:, 1].min() if len(kept) else 0:.4f}-"
          f"{kept[:, 1].max() if len(kept) else 0:.4f}); eager, captured "
          f"and replayed rows equal {eq}; counters {c}; eager reasons "
          f"{list(exe._engine.eager_reasons.values()) or 'none'}")
    _require(eq and c["captures"] == 1 and c["replays"] == 2 and
             det.shape == (SSD_B * SSD_DET["keep_top_k"], 6) and
             np.isfinite(det).all(), "ssd detect: the rows")
    # the predictor
    with tempfile.TemporaryDirectory() as d:
        with pt.scope_guard(scope):
            pt.io.save_inference_model(d, ["img"], [nmsed], exe,
                                       main_program=prog)
        predictor = create_paddle_predictor(AnalysisConfig(d))
    it = predictor.get_input_tensor("img")
    ot = predictor.get_output_tensor(predictor.get_output_names()[0])
    host = np.asarray(feeds[0]["img"].cpu())
    for _ in range(3):
        it.copy_from_cpu(host)
        predictor.zero_copy_run()
    prow = ot.copy_to_cpu()
    worst = float(np.abs(prow - det).max())
    pc = dict(predictor._engine.counters)
    print(f"  detect serving: AnalysisPredictor rows {list(prow.shape)}, "
          f"LoD {ot.lod() == lod}, max |predictor - Executor| {worst:.3e} "
          f"(bound {SSD_ROWS_ATOL:g}); counters captures {pc['captures']}, "
          f"replays {pc['replays']}")
    _require(worst <= SSD_ROWS_ATOL and ot.lod() == lod and
             pc["captures"] == 1, "ssd detect: the predictor's rows")
    # images/s, eager against captured in turns (each batch's plan
    # captured first)
    for f in feeds[1:]:
        for _ in range(2):
            _cap_run(exe, prog, f, [nmsed], scope, numpy=False)
    secs = {"eager": [], "captured": []}
    for turn in range(2):
        for m in (("eager", "captured") if turn == 0 else
                  ("captured", "eager")):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for f in feeds * 2:
                _cap_run(exe, prog, f, [nmsed], scope, m == "captured",
                         numpy=False)
            torch.cuda.synchronize()
            secs[m].append(time.perf_counter() - t1)
    n_img = SSD_B * len(feeds) * 2
    for m, s in secs.items():
        print(f"  detect {m}: s a pass of {n_img} images "
              f"{', '.join(f'{x:.3f}' for x in s)}: "
              f"{n_img / float(np.median(s)):.1f} images/s")
    wall, busy, _ = _profiled_replay(torch, "detect", exe, prog,
                                     feeds[0], [nmsed], scope)
    nms = _ssd_nms_alone(torch, pt, scope, prog, feeds[0])
    print(f"  detect: multiclass_nms alone takes {1e3 * nms['device']:.3f} "
          f"ms of device time captured, "
          f"{100 * nms['device'] / (wall * busy):.1f} % of a captured "
          f"detection run's {1e3 * wall * busy:.3f} ms")
    exe.close()
    # DetectionMAP over two batches, eager
    mprog, mnmsed, ev = ssd_detect(pt, main, head, with_map=True)
    mexe = pt.Executor(pt.CUDAPlace(0))
    fetch = list(ev.get_map_var())
    with pt.scope_guard(scope):
        ev.reset(mexe)
        maps = [tuple(float(v) for v in mexe.run(
            mprog, feed=b, fetch_list=fetch, scope=scope)) for b in batches]
        # batch 0 again from a fresh state: its plan's second run, where
        # the capture rule decides (and keeps the block eager)
        ev.reset(mexe)
        again = tuple(float(v) for v in mexe.run(
            mprog, feed=batches[0], fetch_list=fetch, scope=scope))
    reasons = list(mexe._engine.eager_reasons.values())
    c = _counters(mexe)
    mexe.close()
    print(f"  DetectionMAP (11point, overlap 0.5, difficult not "
          f"evaluated) over {len(batches)} batches: (batch mAP, "
          f"accumulated mAP) {maps}; batch 0 again after reset {again}; "
          f"counters {c}; eager reasons {reasons}")
    _require(all(0.0 <= x <= 1.0 for m in maps for x in m) and
             maps[0][0] == maps[0][1] == again[0] == again[1] and
             c["captures"] == 0 and c["eager_runs"] == 3 and reasons,
             "ssd DetectionMAP: the maps or the block's mode")
    print(f"  ssd detection: {time.perf_counter() - t0:.1f} s")


def detection_phase(torch, dev, card):
    """MobileNet-SSD (mobilenet_ssd) at Pascal VOC's 300x300, 21 classes,
    B=64: trained with RMSProp and L2Decay on VOC-shaped LoD batches,
    captured against eager bit for bit, its first loss against the CPU,
    rates, a stream of new LoDs, a profiled replay and peak memory; then
    detection_output through Executor.run (eager and captured) and
    AnalysisPredictor, multiclass_nms alone eager and captured, and the
    DetectionMAP evaluator. No kernel of the port lies on this path."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    main, scope, head, batches = _ssd_train_phase(torch, pt, kreg, card)
    _ssd_detect_phase(torch, pt, main, scope, head, batches)
    del scope, batches
    gc_cuda(torch)


# the op sweep's tolerance, card against CPU: float32 within 1e-5
# relative and absolute (libm and summation order differ); the rest exact
SWEEP_TOL = 1e-5


def op_sweep_phase(torch, dev):
    """Every op type of the basic, reduce, elementwise, activation and nn
    families, the nine update ops without a kernel, the three
    value-dependent sequence ops and SSD's eight detection ops, each
    case of ops/family_cases.py once through its lowering on the card
    against the same lowering on the CPU."""
    from paddle_tpu_torch.ops import family_cases as fc
    t0 = time.perf_counter()
    worst, types = 0.0, set()
    runs = [(c[0], c[1], c[2], c[3], None) for cs in fc.cases().values()
            for c in cs]
    runs += [(c[0], c[1], c[3], {s: 1 for s in c[4]}, c[2])
             for c in fc.sequence_cases() + fc.detection_cases()]
    for op_type, ins, attrs, outs, lods in runs:
        card, clod = fc.run(op_type, ins, attrs, outs, dev, lods)
        cpu, plod = fc.run(op_type, ins, attrs, outs, "cpu", lods)
        for n, v in card.items():
            a, b = v.cpu(), cpu[n]
            ok = a.dtype == b.dtype and a.shape == b.shape
            if ok and a.is_floating_point():
                err = float((a - b).abs().max()) if a.numel() else 0.0
                worst = max(worst, err)
                ok = bool(torch.allclose(a, b, rtol=SWEEP_TOL,
                                         atol=SWEEP_TOL))
            elif ok:
                ok = torch.equal(a, b)
            _require(ok and clod[n] == plod[n],
                     f"op sweep: {op_type} {n} on the card differs from "
                     f"the CPU")
        types.add(op_type)
    torch.cuda.synchronize()
    print(f"  op sweep: {len(runs)} cases of {len(types)} op types on the "
          f"card equal to their CPU lowerings (float32 worst |err| "
          f"{worst:.3e}, SWEEP_TOL {SWEEP_TOL}); "
          f"{time.perf_counter() - t0:.1f} s")
    return len(types)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="DIR",
                    help="an earlier checkout of this repo: time its "
                         "CUDA-core attention forward, SGD and Adam "
                         "kernels, quantized GEMM and bucket sweeps in "
                         "turns with this one's")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.kernels import registry as kreg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,clocks.max.sm,"
         "clocks.max.mem", "--format=csv"], capture_output=True,
        text=True).stdout.strip().replace("\n", "; ")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{card}; TF32 off; nvidia-smi {clocks}")

    print("[build]")
    t0 = time.perf_counter()
    per_kernel = kreg.build()
    print(f"  built {sorted(per_kernel) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in sorted({src[:-3] for src in kreg.SOURCES.values()}):
        log = kreg.BUILD_DIR / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    # slices 1 and 2 first, in the order they always ran, so that their
    # host-bound times meet the same process state as before; then the
    # GEMM kernels of slice 3
    print("[kernel phase]")
    worst = kernel_phase(torch, dev)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.tuning import variants as V
    built = _build_training(pt, T)
    shapes = [p.shape for p in built[1].all_parameters()]
    adam_err, adam_ulp = adam_phase(torch, dev, shapes)
    times = time_attention(torch, dev, card, args.baseline)
    ttimes = time_training_attention(torch, dev, card)
    atimes = time_adam(torch, dev, card, shapes, args.baseline)
    lenet_shapes = [p.shape for p in _mnist_program(pt)[0].all_parameters()]
    sgd_err = sgd_phase(torch, dev, (
        ("lengths 1, 127, 129, 513", [(1,), (127,), (129,), (513,)],
         (0.0, 1e-4)),
        ("LeNet", lenet_shapes, (0.0,)),
        ("Transformer-base", shapes, (0.0,))))
    stimes = time_sgd(torch, dev, card, shapes, "Transformer-base",
                      args.baseline)
    slenet = time_sgd(torch, dev, card, lenet_shapes, "LeNet",
                      args.baseline)
    for t in (times[False], times[("f32_sm90", False)], ttimes[False]["fwd"],
              ttimes[False]["fwd_sm90"], ttimes[False]["dq"],
              ttimes[False]["dq_sm90"], ttimes[False]["dkv"],
              ttimes[False]["dkv_sm90"], atimes, stimes, slenet):
        _require(t["ms"] > 0, "the profiler saw no device time")

    print("[scoring phase]")
    counts, _, served = slice_phase(torch, dev)
    print(f"  launches in the scoring phase: {counts}")

    print("[training phase]")
    tcounts = training_phase(torch, dev, built)

    print("[GEMM kernel phase]")
    gemm_worst = gemm_kernel_phase(torch, dev)
    print("[variant search]")
    search, search_counts = search_phase(torch, dev)
    print("[GEMM times]")
    gtimes = time_gemms(torch, dev, card, search, args.baseline)

    serve_launches = {}
    for mode in ("int8", "bf16", "tuned"):
        print(f"[scoring phase, {mode} GEMMs]")
        if mode == "tuned":
            _require(V.register_winner(search["winners"]) == "tuned_matmul",
                     "no none winner to register")
        try:
            serve_launches[mode], _ = serve_mode(torch, served, mode)
        finally:
            kreg.unregister_kernel("tuned_matmul")
    served["exe"].close()
    del served
    gc_cuda(torch)

    print("[serving phase]")
    book_launches, book_gemms = serving_phase(torch, dev, card, search)
    for name, n in book_launches.items():
        serve_launches[{"quantized_matmul_int8": "int8",
                        "quantized_matmul_bf16": "bf16",
                        "tuned_matmul_sm90": "tuned"}[name]] += n
    gc_cuda(torch)

    print("[graph capture phase]")
    capture_phase(torch, dev, built)

    print("[resnet50 phase]")
    rn = resnet_phase(torch, dev)
    torch.cuda.empty_cache()

    print("[plan cache A/B]")
    cfg = built[0]
    kept = cache_ab_phase(torch, dev, (
        ("Transformer-base", built[1], built[2], built[3],
         _training_feed(T, cfg)),
        ("ResNet-50", *rn)))
    print("[host profile]")
    for label, (exe, scope, main, cost, feed) in kept.items():
        host_profile(torch, label, exe, scope, main, cost, feed)
    del kept, rn
    torch.cuda.empty_cache()

    print("[ctr phase]")
    ctr_phase(torch, dev)

    print("[dygraph phase]")
    dy_adam, _ = dygraph_phase(torch, dev)

    print("[sequence phase]")
    sequence_phase(torch, dev)

    print("[control flow phase]")
    cf_adam = control_flow_phase(torch, dev, card)

    print("[book models phase]")
    book_adam, book_qmm = book_models_phase(torch, dev, card)
    for mode, n in book_qmm.items():
        serve_launches[mode] += n

    print("[flash lse phase]")
    lse_launches, _ = flash_lse_phase(torch, dev)
    print("[bucket sweep phase]")
    sweep_launches, sweep_worst, sweep_times = bucket_sweep_phase(
        torch, dev, card, built, args.baseline)
    print("[lr schedule phase]")
    lr_adam = lr_schedule_phase(torch, dev)
    print("[contrib decoder phase]")
    ct_adam, ct_qmm = contrib_decoder_phase(torch, dev)
    for mode, n in ct_qmm.items():
        serve_launches[mode] += n
    print("[value-dependent sequence phase]")
    value_sequence_phase(torch, dev)
    print("[op sweep]")
    op_sweep_phase(torch, dev)
    print("[detection phase]")
    detection_phase(torch, dev, card)

    # LeNet last: earlier profiler sessions and large buffers slowed a
    # later step in one process (PERF.md, PR 3)
    print("[mnist phase]")
    sgd_launches, _ = mnist_phase(torch, dev, card)

    src = "paddle_tpu_torch/csrc/"
    bf = "bfloat16"
    train = "training shape drop t=230"
    # the shared attention counters count both designs: a CUDA-core row
    # takes its main path's launches less the tensor-core ones. The
    # float32 forward's main path is serving (the tensor-core row: the
    # serving phase's launches, times at the serving shape); the
    # CUDA-core forward, dq (with its di pre-pass) and dk/dv run on no
    # main path (0 launches; their times are of the serving and the bf16
    # training shape through that design, beside the new kernels')
    rows = []
    for name, source, replaces, t, err, launches in (
            ("flash_attention_fwd", "flash_attention_fwd.cu",
             "paddle_tpu/kernels/flash_attention.py:353", times[False],
             worst[("flash_attention_fwd", "float32", "serving shape")],
             counts["flash_attention_fwd"]
             - counts["flash_attention_fwd_sm90"]
             - counts["flash_attention_fwd_f32_sm90"]),
            ("flash_attention_fwd_f32_sm90", "flash_attention_fwd_f32_sm90.cu",
             "paddle_tpu/kernels/flash_attention.py:353",
             times[("f32_sm90", False)],
             worst[("flash_attention_fwd_f32_sm90", "float32",
                    "serving shape")],
             counts["flash_attention_fwd_f32_sm90"]),
            ("flash_attention_fwd_sm90", "flash_attention_fwd_sm90.cu",
             "paddle_tpu/kernels/flash_attention.py:353",
             ttimes[False]["fwd_sm90"],
             worst[("flash_attention_fwd_sm90", bf, train)],
             tcounts["flash_attention_fwd_sm90"]),
            ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
             "paddle_tpu/kernels/flash_attention.py:426",
             ttimes[False]["dq"],
             worst[("flash_attention_bwd_dq", bf, train)],
             tcounts["flash_attention_bwd_dq"]
             - tcounts["flash_attention_bwd_dq_sm90"]),
            ("flash_attention_bwd_dq_sm90", "flash_attention_bwd_dq_sm90.cu",
             "paddle_tpu/kernels/flash_attention.py:426",
             ttimes[False]["dq_sm90"],
             worst[("flash_attention_bwd_dq_sm90", bf, train)],
             tcounts["flash_attention_bwd_dq_sm90"]),
            ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
             "paddle_tpu/kernels/flash_attention.py:502",
             ttimes[False]["dkv"],
             worst[("flash_attention_bwd_dkv", bf, train)],
             tcounts["flash_attention_bwd_dkv"]
             - tcounts["flash_attention_bwd_dkv_sm90"]),
            ("flash_attention_bwd_dkv_sm90",
             "flash_attention_bwd_dkv_sm90.cu",
             "paddle_tpu/kernels/flash_attention.py:502",
             ttimes[False]["dkv_sm90"],
             worst[("flash_attention_bwd_dkv_sm90", bf, train)],
             tcounts["flash_attention_bwd_dkv_sm90"]),
            ("fused_adam", "fused_optimizer.cu",
             "paddle_tpu/kernels/fused_optimizer.py:108", atimes,
             adam_err, tcounts["fused_adam"] + dy_adam + cf_adam +
             book_adam + lr_adam + ct_adam),
            ("fused_sgd", "fused_optimizer.cu",
             "paddle_tpu/kernels/fused_optimizer.py:133", slenet,
             sgd_err, sgd_launches),
            ("bucket_sweep_adam", "fused_optimizer.cu",
             "paddle_tpu/kernels/fused_optimizer.py:238",
             sweep_times["adam"], sweep_worst["adam"],
             sweep_launches["adam"]),
            ("bucket_sweep_sgd", "fused_optimizer.cu",
             "paddle_tpu/kernels/fused_optimizer.py:238",
             sweep_times["sgd"], sweep_worst["sgd"],
             sweep_launches["sgd"])):
        rows.append({"name": name, "route": "cuda", "source": src + source,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": err, "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
        if name in lse_launches:
            # the backward launches the flash lse phase made with an
            # lse cotangent (flash_attention_lse's g_lse term)
            rows[-1]["g_lse_launches"] = lse_launches[name]
    # the GEMM kernels at the serving forward's most frequent shape; the
    # launches of the routed ones are those of their serving mode, those
    # of the two fused epilogues and of the CUDA-core tiles the variant
    # search's (their path)
    M, N, K = SEARCH_PROBLEM
    for name, source, replaces, launches in (
            ("quantized_matmul_int8", "quantized_matmul.cu",
             "paddle_tpu/kernels/quantized_matmul.py:64",
             serve_launches["int8"]),
            ("quantized_matmul_bf16", "quantized_matmul.cu",
             "paddle_tpu/kernels/quantized_matmul.py:64",
             serve_launches["bf16"]),
            ("tuned_matmul_sm90", "tuned_matmul_sm90.cu",
             "paddle_tpu/tuning/variants.py:70", serve_launches["tuned"]),
            ("tuned_matmul", "tuned_matmul.cu",
             "paddle_tpu/tuning/variants.py:70",
             search_counts["tuned_matmul"]),
            ("tuned_matmul_ln_sm90", "tuned_matmul_sm90.cu",
             "paddle_tpu/tuning/variants.py:88",
             search_counts["tuned_matmul_ln_sm90"]),
            ("tuned_matmul_ln", "tuned_matmul.cu",
             "paddle_tpu/tuning/variants.py:88",
             search_counts["tuned_matmul_ln"]),
            ("tuned_matmul_dr_sm90", "tuned_matmul_sm90.cu",
             "paddle_tpu/tuning/variants.py:110",
             search_counts["tuned_matmul_dr_sm90"]),
            ("tuned_matmul_dr", "tuned_matmul.cu",
             "paddle_tpu/tuning/variants.py:110",
             search_counts["tuned_matmul_dr"])):
        t = gtimes[(name, M, K, N)]
        rows.append({"name": name, "route": "cuda", "source": src + source,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": gemm_worst[(name, M, K, N)],
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    for row in rows:
        _require(row["ms"] > 0 and (row["library_ms"] is None
                                    or row["library_ms"] > 0),
                 f"{row['name']}: the profiler saw no device time")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
