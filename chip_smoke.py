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
   the rows never looked up unchanged. Then layers.auc over Wide&Deep's
   probability (PaddleRec's streaming AUC): 8 captured steps against 8
   eager ones, the AUC and both stats bit-equal.
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
   captured in turns over the first SEQ_RATE_POOL batches (examples/s,
   tokens/s, host s a run), a profiled
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
   ops/family_cases.py (the basic, reduce, elementwise, activation, nn
   and conv families, the nine update ops without a kernel, the three
   sequence ops, SSD's eight detection ops, the one- and two-stage
   detectors' ten each, and slice 24's eleven nlp, metric and bilinear
   ops with their gradients) on the card against the CPU (nce and
   sample_logits' draws held to the numpy reckoning on the card's own
   samples).
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
16. Pose phase: SimpleBaseline as PaddleCV's human_pose_estimation
   defines it (pose_resnet: ResNet-50 up to res5c, three
   conv2d_transpose of 256 filters, 4x4, stride 2, padding 1, each with
   batch norm and relu, a 1x1 conv to 17 heatmaps) at COCO's 256x192,
   float32, B=32, Adam(1e-3), the paper's half mean squared heatmap
   error weighted by target_weight, on COCO-shaped batches (Gaussian
   heatmaps of sigma 2 at seeded joints, POSE_VISIBLE of them weighted
   1). POSE_RUNS steps captured against eager in deterministic mode,
   bit-equal, one fused_adam launch a step; the first loss and heatmaps
   against the port on the CPU (POSE_LOSS_RTOL, POSE_HEAT_RTOL); one
   step against plain_reference(); images/s eager against captured in
   turns, the capture clocked; a profiled replay (busy share, top
   kernels, the ranks of the kernels the deconvolutions launch, their
   device time alone), peak memory; the heatmaps through
   save_inference_model and AnalysisPredictor against Executor.run.
17. Yolo phase: YOLOv3 as PaddleCV's yolov3 defines it (yolov3:
   DarkNet-53's stages of 1, 2, 8, 8 and 4 residual blocks, three heads
   on strides 32, 16 and 8 with their routes, resize_nearest(scale=2),
   COCO's 9 anchors) at 608x608, 80 classes, float32, B=8, the sum of
   the heads' yolov3_loss (ignore 0.7, label smoothing, gt_score)
   minimized by Momentum(0.9) under linear_lr_warmup(piecewise_decay)
   and L2Decay(5e-4), on COCO-shaped batches (a geometric number of
   boxes an image, mean 7.3, padded to 50; im_shape from COCO's sizes).
   YOLO_RUNS steps captured against eager in deterministic mode,
   bit-equal; the first loss and the heads' outputs at B=2 against the
   port on the CPU (YOLO_LOSS_RTOL); images/s eager against captured in
   turns, the capture clocked; a profiled replay (busy share, top
   kernels, the three yolov3_loss ops' device time alone and the ranks
   of their kernels), peak memory. Then infer.py's program (yolo_box on
   each head, multiclass_nms over 80 classes, background -1) through
   Executor.run (eager, captured, replayed rows equal) and
   AnalysisPredictor (within YOLO_ROWS_ATOL), images/s eager against
   captured, a profiled replay and multiclass_nms alone at 8 x 80 x
   22743. Then a RetinaNet head (retinanet: two levels,
   anchor_generator, retinanet_target_assign on a LoD of boxes,
   sigmoid_focal_loss, smooth_l1, SGD) at B=4, RETINA_RUNS steps
   captured against eager bit-equal, and its retinanet_detection_output
   captured against eager. No kernel of the port lies on this path.
18. Rcnn phase: Faster R-CNN as PaddleCV's rcnn defines it
   (faster_rcnn: ResNet-50-C4 with frozen affine_channels, calibrated on
   one batch by rcnn_calibrate; the RPN's anchors, rpn_target_assign and
   generate_proposals (12000 / 2000); generate_proposal_labels (512
   RoIs an image); roi_align 14x14; res5; the two fc heads) on COCO's
   800x1344 canvas, 81 classes, float32, B=2, the sum of the RPN's and
   the head's losses minimized by Momentum(0.9) under
   linear_lr_warmup(piecewise_decay) and L2Decay(1e-4), on COCO-shaped
   LoD batches (landscape sizes resized to a short side of 800, a
   geometric number of boxes an image, mean 7.3, a crowd box).
   RCNN_RUNS steps captured against eager in deterministic mode,
   bit-equal (losses, persistables, the sampled ScoreIndex and RoIs);
   at B=1 res4, the RPN's outputs and the head's logits on the card's
   RoIs against the CPU (RCNN_RTOL), and generate_proposals,
   rpn_target_assign and generate_proposal_labels on the card's inputs
   against the CPU (rows that differ); images/s eager against captured
   in turns, the capture clocked, peak memory, a profiled replay (busy
   share, top kernels), generate_proposals and its greedy loop alone
   (kernels, device ms, share of a replay), roi_align alone (forward,
   backward, peak bytes). Then the detection program
   (box_decoder_and_assign, multiclass_nms) through Executor.run
   (eager, captured, replayed rows equal) and AnalysisPredictor (within
   RCNN_ROWS_ATOL), images/s eager against captured, a profiled replay
   and multiclass_nms alone at 2 x 81 x 1000. No kernel of the port
   lies on this path.
   Ocr phase: CRNN-CTC as PaddleCV's ocr_recognition defines it
   (crnn_ctc: four conv_bn_pool groups of widths 16-128, im2sequence to
   64 columns of 768, two 600-wide projections, a forward and a reverse
   dynamic_gru of 200 with relu candidates, fc to 96; warpctc(blank 95,
   norm_by_times), reduce_sum, Momentum(1e-3, 0.9) with L2Decay(4e-4))
   at 48x512 grayscale, B=32, on OCR-shaped batches (labels of 4-20
   characters, one repeat). OCR_RUNS steps captured against eager in
   deterministic mode, bit-equal; the first step against the CPU
   (fc_out within OCR_RTOL, per-image losses, each image's CTC gradient
   and the last fc's gradients within bounds that must also reject a
   planted fault, one image's loss dropped; the card's fc_out aligned to
   spell the labels, decoded equal on both and back to the labels);
   images/s eager
   against captured in turns, the capture clocked; a profiled replay,
   peak memory; warpctc alone against F.ctc_loss (a yardstick on no
   path) and the GRUs alone; the program with ctc_greedy_decoder and
   the EditDistance evaluator as PaddleCV trains it (eager: ctc_align);
   a stream of new label LoDs (each one's capture clocked); the decode
   program, the blank's bias lowered so that columns decode to
   characters, through Executor.run (against a numpy greedy decode) and
   AnalysisPredictor. Sampled heads
   phase: nce (uniform, log-uniform, a Zipf custom_dist), hsigmoid and
   sampled_softmax_with_cross_entropy at 4096 x 512 over 32000 classes:
   captured steps against eager bit-equal, draws included, and each
   step's device ms. SRL's decode paths through ChunkEvaluator (IOB, 29
   types) on the card and the CPU (book models phase). No kernel of the
   port lies on these paths.
19. QAT phase (slice 25): ResNet-50 (full depth and width, 1000
   classes, B=128, 224x224, float32, Momentum(0.1, 0.9)) trained
   quantization-aware through contrib.slim: the Compressor (2 epochs of
   3 batches, a new Executor an epoch and an evaluation) with one
   QuantizationStrategy (channel-wise abs_max weights, moving-average
   activations) built in Python. Checks that the transform quantizes
   the 53 conv2d and the fc's mul; 4 steps captured bit-equal to 4 eager
   (the moving averages included); one QAT training step at B=4 held to
   the CPU op by op: the forward quantized tensor by quantized tensor
   (qat_forward_check: an element is equal, or one quantum away across
   a half-step the two pre-round values straddle), the quantizers'
   gradients and the Momentum updates within derived bounds, the checks
   failing a bin count of 126, a per-tensor weight scale, a dropped
   scale gradient and a momentum of 0.8; the frozen int8 export's int8 weights on
   the grid and through the tensor files, served by AnalysisPredictor
   (equal to Executor.run, held to the QAT eval program the same way,
   top-1 agreement) and again under PT_KERNEL_QUANT_MATMUL=int8 (the
   fc's launches of quantized_matmul_int8, or why it takes none).
   Times QAT captured and eager and float32 ResNet-50 captured in turns,
   a replay's device ms of each, an eager QAT step's device time by op
   (the fake-quantize ops' share). Then small checks: the other QAT
   variants (abs_max weights; range_abs_max and abs_max activations;
   depthwise_conv2d) against the CPU, the random ops against their laws
   (scipy, alpha 1e-3), a block with sampling_id and random_crop
   captured against eager, and a Compressor run with distillation and
   pruning, card against CPU.
20. MNIST phase: LeNet (BASELINE config 1: conv 20 and 50, 5x5, max
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
21. Prints one JSON line of per-kernel numbers (fused_adam's launches:
   the training phase's, the dygraph phase's, the control flow
   phase's, the book models phase's, the lr schedule phase's, the
   contrib decoder phase's and the pose phase's captured steps; the quantized and tuned
   GEMMs': the scoring and the serving phase's, and the quantized ones'
   also the book models and contrib decoder phases' captured decodes
   and the int8 one the QAT phase's int8 serving;
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
import math
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


def _build_ctr(pt, kind, optimizer=None, auc=False):
    """bench.py's CTR training program (bench_ctr): kind "wide_deep" or
    "deepfm" is ctr_train(kind, vocab_size=1000001); "sparse" is
    Wide&Deep with is_sparse=True and ctr_train's loss, as a user builds
    it; "padded" looks a sparse [1000001, 16] table up with padding_idx
    0 into one fc. Minimized by AdagradOptimizer(0.01), or `optimizer`.
    With `auc` (wide_deep and deepfm), layers.auc over the probability
    ctr_train computes ([1 - p, p]), as PaddleRec's CTR nets report it.
    Returns (main, startup, cost, feed names); with `auc`, the cost is
    a list [cost, auc, stat_pos, stat_neg]."""
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        if kind in ("wide_deep", "deepfm"):
            cost, prob, feeds = pt.models.ctr_train(kind,
                                                    vocab_size=CTR_VOCAB)
            if auc:
                L = pt.layers
                label = main.global_block().var("ctr_label")
                a, _, stats = L.auc(
                    L.concat([L.scale(prob, scale=-1.0, bias=1.0), prob],
                             axis=1), L.cast(label, "int64"))
                auc = [a] + stats
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
    return main, startup, [cost] + auc if auc else cost, feeds


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
    ctr_auc(torch, pt, kreg)

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


CTR_AUC_STEPS = 8


def ctr_auc(torch, pt, kreg):
    """layers.auc over Wide&Deep's probability (PaddleRec's streaming
    AUC, 4096 thresholds): CTR_AUC_STEPS captured steps (after the
    plan's eager first) against as many eager ones from one startup, in
    deterministic mode: the AUC fetched each step, both stats and every
    parameter bit-equal; the stats count every example of every step."""
    t0 = time.perf_counter()
    main, startup, fetch, feeds = _build_ctr(pt, "wide_deep", auc=True)
    got = []
    _cap_compare(torch, pt, kreg, "Wide&Deep + auc", main, startup,
                 _ctr_feed(feeds), fetch, CTR_AUC_STEPS, fetched=got)
    aucs = [float(np.asarray(f[1]).reshape(-1)[0]) for f in got]
    counted = float(got[-1][2].sum() + got[-1][3].sum())
    runs = CTR_AUC_STEPS + 1
    print(f"  Wide&Deep + auc: AUC after each run "
          f"{', '.join(f'{v:.6f}' for v in aucs)}; the stats hold "
          f"{counted:.0f} examples ({runs} runs of {CTR_B}); "
          f"{time.perf_counter() - t0:.1f} s")
    _require(all(0.0 < v < 1.0 for v in aucs) and
             counted == runs * CTR_B, "Wide&Deep + auc: the stats")


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


def _cap_turns(torch, label, units, per_step, modes, fresh=()):
    """Runs of each mode in CAP_TURNS turns of CAP_TURN_STEPS steps (the
    order alternating between turns): `units` a second (units a step
    per_step), each turn ending at its last step's fetched loss, and the
    host ms of a run before that fetch (the enqueue). modes: name ->
    step() returning the fetched value; for a mode named in `fresh`,
    name -> a context manager that builds the step for one turn and
    takes it down after (outside the turn's clock). Returns the median
    rates."""
    rates = {m: [] for m in modes}
    host = {m: [] for m in modes}
    for turn in range(CAP_TURNS):
        for m in (list(modes) if turn % 2 == 0 else list(modes)[::-1]):
            with (modes[m]() if m in fresh else
                  contextlib.nullcontext(modes[m])) as step:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                enq = 0.0
                for _ in range(CAP_TURN_STEPS):
                    t1 = time.perf_counter()
                    out = step()
                    enq += time.perf_counter() - t1
                float(out.reshape(-1)[0])          # the fetch fences
                secs = time.perf_counter() - t0
            rates[m].append(per_step * CAP_TURN_STEPS / secs)
            host[m].append(enq * 1e3 / CAP_TURN_STEPS)
    for m in modes:
        print(f"  {label} {m}: {units} a turn "
              f"{', '.join(f'{r:.1f}' for r in rates[m])} (median "
              f"{np.median(rates[m]):.1f}); host ms a run "
              f"{', '.join(f'{h:.2f}' for h in host[m])}"
              + ("; its graph captured anew each turn" if m in fresh
                 else ""))
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
# the batches of the pool that the turns pass over (each captured again
# outside deterministic mode first: ~17 s a batch for stacked_lstm_net)
SEQ_RATE_POOL = 1
SEQ_STREAM = 2      # distinct batches run once each, eagerly
SEQ_TURNS = 2       # turns of one pass over SEQ_RATE_POOL batches
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


def _seq_net(torch, pt, kreg, net, batches, feeds):
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
    _seq_rates(torch, pt, label, exe, main, [cost, acc], scope,
               feeds[:SEQ_RATE_POOL],
               sum(sum(b[1][0]) for b in batches[:SEQ_RATE_POOL]),
               not reasons)
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
    eager against captured in turns over SEQ_RATE_POOL of them, a
    profiled replay, peak memory, a stream of SEQ_STREAM distinct batches run eagerly, and for the
    stacked net the predictor on LoD feeds. No kernel of the port is
    launched."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    t0 = time.perf_counter()
    batches = [_seq_batch(i) for i in range(SEQ_POOL)]
    feeds = [_seq_feed(pt, b, pt.CUDAPlace(0)) for b in batches]
    for i, b in enumerate(batches):
        lens = b[1][0]
        print(f"  batch {i}: {SEQ_B} reviews, {sum(lens)} tokens, lengths "
              f"{min(lens)}-{max(lens)} (median {int(np.median(lens))}); "
              f"padded share N*maxT/sum(T) {_seq_padded_share(b):.3f}")
    for net in ("stacked_lstm", "conv"):
        _seq_net(torch, pt, kreg, net, batches, feeds)
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
    """(parameters, the trainable ones the registry routes to a kernel:
    at least its minimum size)."""
    params = main.all_parameters()
    routed = [p for p in params if p.trainable and
              int(np.prod(p.shape)) >= kreg.min_numel()]
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


def _chunk_program(pt):
    """ChunkEvaluator over fed decoded tags and gold tags: IOB with
    SRL_CHUNK_TYPES types (the book's 59 tags: a B and an I tag a type
    and the outside tag), as chapter 07 evaluates the tagger."""
    import warnings
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        inf = pt.layers.data("inf", [1], dtype="int64", lod_level=1)
        lab = pt.layers.data("lab", [1], dtype="int64", lod_level=1)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # deprecated
            ev = pt.evaluator.ChunkEvaluator(inf, lab, "IOB",
                                             SRL_CHUNK_TYPES)
    return main, startup, ev


SRL_CHUNK_TYPES = (SRL["n_tag"] - 1) // 2


def _srl_chunk_eval(pt, exe, decode, path, scope, seeds):
    """ChunkEvaluator on the decode program's paths of the pool batches
    against their tags, accumulated on the card and on the CPU (the same
    paths, copied): the chunk counts and the epoch's metrics equal."""
    t0 = time.perf_counter()
    counts = {}
    for where, place in (("card", pt.CUDAPlace(0)), ("cpu", pt.CPUPlace())):
        main, startup, ev = _chunk_program(pt)
        cexe, cscope = pt.Executor(place), pt.Scope()
        cexe.run(startup, scope=cscope)
        for s in seeds:
            f = _srl_feed(pt, s, pt.CUDAPlace(0))
            got = exe.run(decode, feed={"word": f["word"]}, fetch_list=[path],
                          scope=scope, return_numpy=False)[0]
            lod = [np.diff(got.lod()[0]).tolist()]
            cexe.run(main, scope=cscope, feed={
                "inf": pt.create_lod_tensor(
                    np.asarray(got).astype(np.int64), lod, place),
                "lab": pt.create_lod_tensor(np.asarray(f["tag"]), lod,
                                            place)})
        with pt.scope_guard(cscope):
            metrics = [float(v) for v in ev.eval(cexe)]
        counts[where] = (
            [int(np.asarray(cscope.find_var(v.name).get_tensor())[0])
             for v in ev.states], metrics)
    print(f"  srl ChunkEvaluator (IOB, {SRL_CHUNK_TYPES} types) over "
          f"{len(seeds)} decoded batches: inferred / labelled / correct "
          f"chunks {counts['card'][0]} on the card, {counts['cpu'][0]} on "
          f"the CPU; precision, recall, F1 "
          f"{', '.join(f'{v:.4f}' for v in counts['card'][1])}; "
          f"{time.perf_counter() - t0:.1f} s")
    _require(counts["card"] == counts["cpu"] and counts["card"][0][1] > 0,
             "srl ChunkEvaluator: card and CPU counts differ")


def srl_phase(torch, dev, card, pt, kreg):
    """The book's CRF tagger (models/label_semantic_roles.py) at the
    CoNLL-05 widths, B=64: trained captured against eager, its first
    loss against the CPU, one step against plain_reference(); then its
    decode program on the trained scope, captured against eager, and
    through AnalysisPredictor, and ChunkEvaluator on its paths, on the
    card against the CPU. Returns the fused_adam launches of the
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
    _srl_chunk_eval(pt, dexe, decode, path, scope, seeds)
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


def _train_mode_forward(pt, main, fetch, state, feed, place=None):
    """The fetches of the forward of `main` up to `fetch` from `state`
    (name -> CPU tensor) on `feed`, on `place` (the CPU by default),
    batch norm in training mode (a test clone would normalize by the
    running statistics), as numpy arrays."""
    place = place or pt.CPUPlace()
    prog = main.clone()
    block = prog.global_block()
    needed, keep = {v.name for v in fetch}, []
    for op in reversed(block.ops):
        if op.attr("op_role", "forward") == "forward" and \
                set(op.output_arg_names) & needed:
            keep.append(op)
            needed.update(op.input_arg_names)
    block.ops = keep[::-1]
    scope = pt.Scope()
    dev = place.torch_device()
    for n, t in state.items():
        scope.var(n).get_tensor().set_tensor(t.to(dev, copy=True))
    return [np.asarray(v) for v in pt.Executor(place).run(
        prog, feed=feed, fetch_list=fetch, scope=scope,
        use_program_cache=False)]


def _train_mode_loss_cpu(pt, main, loss, state, feed):
    """The forward's loss on the CPU (_train_mode_forward)."""
    return float(_train_mode_forward(pt, main, [loss], state, feed)[0])


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


def _nms_alone(torch, pt, scope, det_prog, feed, label="multiclass_nms"):
    """multiclass_nms alone, with the detection program's own attrs, on
    its decoded boxes and transposed scores (SSD: B x 21 x 1917; YOLOv3:
    B x 80 x 22743): eager and captured, device rows against the CPU's,
    ms a call each way."""
    L = pt.layers
    block = det_prog.global_block()
    nms_op = [op for op in block.ops if op.type == "multiclass_nms"][0]
    names = (nms_op.input("BBoxes")[0], nms_op.input("Scores")[0])
    attrs = {k: nms_op.attr(k) for k in (
        "score_threshold", "nms_top_k", "keep_top_k", "nms_threshold",
        "normalized", "nms_eta", "background_label")}
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
        out = L.multiclass_nms(b, s, **attrs)
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
    print(f"  {label} alone at {list(sc.shape)} (nms_top_k "
          f"{attrs['nms_top_k']}, keep_top_k {attrs['keep_top_k']}): "
          f"eager {1e3 * secs['eager']:.3f} ms a call, captured "
          f"{1e3 * secs['captured']:.3f} ms a call (the host's clock to "
          f"a synchronize); a profiled replay {n_kernels} kernels, "
          f"{1e3 * secs['device']:.3f} ms of device time in {1e3 * wall:.3f} "
          f"ms; rows equal to the CPU's {equal}; counters {c}")
    _require(equal, f"{label}: the card's rows differ from the CPU's")
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
    nms = _nms_alone(torch, pt, scope, prog, feeds[0])
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


# SimpleBaseline (Xiao, Wu and Wei, ECCV 2018; PaddleCV's
# human_pose_estimation/lib/pose_resnet.py) on COCO keypoints: ResNet-50,
# three 4x4 stride-2 deconvolutions of 256 filters, 17 joint heatmaps;
# input 256x192, heatmaps 64x48; Adam at 1e-3, 32 images a card
POSE = {"kps": 17, "image": (256, 192), "stages": (3, 4, 6, 3)}
POSE_B = 32
POSE_LR = 1e-3
POSE_RUNS = 8       # steps of one batch, captured against eager
POSE_SIGMA = 2.0    # the target heatmaps' Gaussian, in heatmap pixels
# share of joints whose target_weight is 1: assumed, for a COCO person
# that is annotated with keypoints (most of its 17 joints are labelled;
# an unlabelled joint has a zero heatmap and weight 0, as in the
# paper's target generator)
POSE_VISIBLE = 0.7
# the first loss and heatmaps, card against CPU: float32 convolutions
# (TF32 off) summed in other orders. The heatmaps' bound, of the largest
# |heatmap|: the rounding of a dot product of K terms grows as a random
# walk, sqrt(K) units of 2^-24, and adds up over the layers: 60 (the 53
# convolutions of ResNet-50 up to res5c, 3 deconvolutions and the head,
# rounded up), K at most 4608 (3 x 3 x 512)
POSE_LOSS_RTOL = 1e-5
POSE_HEAT_RTOL = 60 * 4608 ** 0.5 * 2.0 ** -24     # 2.43e-4


def pose_resnet(L, img, kps=17, stages=(3, 4, 6, 3)):
    """SimpleBaseline's network built with the layers module `L` (the
    port's or the JAX package's) and that package's models/resnet.py
    blocks: ResNet (conv_bn_layer stem, max pool, `stages` bottleneck
    blocks a stage; ResNet-50 up to res5c at (3, 4, 6, 3)) with no pool
    and no fc, then three conv2d_transpose(256, 4x4, stride 2, padding
    1, no bias, weights Normal(0, 0.001)) each with batch_norm and relu,
    then a 1x1 conv2d to `kps` heatmaps (weights Normal(0, 0.001), a
    bias). Returns the heatmaps [N, kps, H', W']."""
    import importlib
    pkg = importlib.import_module(L.__name__.rpartition(".")[0])
    R = importlib.import_module(pkg.__name__ + ".models.resnet")

    def normal():
        return pkg.ParamAttr(initializer=pkg.initializer.Normal(0.0, 0.001))

    x = R.conv_bn_layer(img, 64, 7, stride=2, act="relu", name="res_conv1")
    x = L.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                 pool_type="max")
    for stage, n_blocks in enumerate(stages):
        for blk in range(n_blocks):
            x = R._bottleneck(x, (64, 128, 256, 512)[stage],
                              2 if blk == 0 and stage != 0 else 1,
                              f"res{stage + 2}{chr(ord('a') + blk)}", False,
                              "NCHW")
    for _ in range(3):
        x = L.conv2d_transpose(x, num_filters=256, filter_size=4, stride=2,
                               padding=1, bias_attr=False,
                               param_attr=normal())
        x = L.batch_norm(x, act="relu")
    return L.conv2d(x, kps, 1, param_attr=normal())


def pose_loss(L, heat, target, weight):
    """The paper's loss: half the mean over joints of the squared heatmap
    error, each joint's weighted by its target_weight ([N, kps])."""
    sq = L.square_error_cost(heat, target)
    return L.scale(L.reduce_mean(L.elementwise_mul(sq, weight, axis=0)),
                   scale=0.5)


def pose_train(pt, image=None, kps=None, stages=None, lr=POSE_LR):
    """(main, startup, loss, heatmaps) of SimpleBaseline's training
    program in package `pt`: feeds image [3, H, W], target [kps, H', W']
    and target_weight [kps]; AdamOptimizer(lr) minimizes pose_loss."""
    L = pt.layers
    image, kps = image or POSE["image"], kps or POSE["kps"]
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = L.data("image", [3, *image], dtype="float32")
        heat = pose_resnet(L, img, kps, stages or POSE["stages"])
        target = L.data("target", list(heat.shape[1:]), dtype="float32")
        weight = L.data("target_weight", [kps], dtype="float32")
        loss = pose_loss(L, heat, target, weight)
        pt.optimizer.AdamOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, loss, heat


def _pose_batch(torch, seed, device, B=None, image=None, heat=(64, 48),
                kps=None):
    """A COCO-shaped batch from `seed`: B images (standard normal, made
    by a torch generator on the CPU, then moved to `device`), joints
    uniform over the heatmap, target heatmaps exp(-d^2 / (2 sigma^2))
    within 3 sigma of the joint (POSE_SIGMA), zero for a joint whose
    target_weight is 0 (POSE_VISIBLE of them are 1)."""
    B, image, kps = B or POSE_B, image or POSE["image"], kps or POSE["kps"]
    rng = np.random.default_rng(seed)
    h, w = heat
    joints = rng.uniform(0, 1, (B, kps, 2)) * [w - 1, h - 1]
    weight = (rng.random((B, kps)) < POSE_VISIBLE).astype(np.float32)
    dx = np.arange(w)[None, None, None, :] - joints[..., 0, None, None]
    dy = np.arange(h)[None, None, :, None] - joints[..., 1, None, None]
    g = np.exp(-(dx ** 2 + dy ** 2) / (2 * POSE_SIGMA ** 2))
    near = (np.abs(dx) <= 3 * POSE_SIGMA) & (np.abs(dy) <= 3 * POSE_SIGMA)
    target = (g * near * weight[..., None, None]).astype(np.float32)
    gen = torch.Generator()
    gen.manual_seed(seed)
    img = torch.randn((B, 3, *image), generator=gen)
    return {"image": img.to(device),
            "target": torch.from_numpy(target).to(device),
            "target_weight": torch.from_numpy(weight).to(device)}


POSE_DECONV_ITERS = 5     # calls a timing of the deconvolutions alone


def _timed_parts(torch, parts, iters):
    """({part: device ms a call of parts[part](), by CUDA events over
    `iters` calls}, {part: {the profiler key of each kernel it launches:
    device ms}}; the latter empty where every one of three profiler
    sessions lost its events)."""
    from torch.profiler import ProfilerActivity, profile
    ms, names = {}, {}
    for part, fn in parts.items():
        fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        ms[part] = a.elapsed_time(b) / iters
        names[part] = {}
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names[part] = {e.key: e.self_device_time_total / 1e3
                           for e in _kernels(prof)}
            if names[part]:
                break
    return ms, names


def _pose_deconv_alone(torch, heat_shape, B):
    """The three deconvolutions alone at their shapes, forward and
    backward (the input's and the filter's gradients): _timed_parts over
    POSE_DECONV_ITERS calls."""
    F = torch.nn.functional
    h, w = heat_shape
    shapes = [(2048, h // 8, w // 8), (256, h // 4, w // 4),
              (256, h // 2, w // 2)]
    xs = [torch.randn((B, c, hh, ww), device="cuda", requires_grad=True)
          for c, hh, ww in shapes]
    ws = [torch.randn((c, 256, 4, 4), device="cuda", requires_grad=True)
          for c, _, _ in shapes]

    def forward():
        return [F.conv_transpose2d(x, wt, stride=2, padding=1)
                for x, wt in zip(xs, ws)]

    outs = forward()
    grads = [torch.ones_like(o) for o in outs]
    return _timed_parts(torch, {
        "forward": forward,
        "backward": lambda: torch.autograd.backward(outs, grads,
                                                    retain_graph=True)},
        POSE_DECONV_ITERS)


def _profile_with_alone(torch, label, exe, main, feed, fetch, scope, what,
                        alone, names):
    """One profiled replay: wall, busy share, kernels, the top kernels
    by device time; then `what`'s time alone, from CUDA events over its
    calls (`alone`: {part: ms}), beside the sum of its kernels' device
    time where a profiler session caught them (`names`: {part: {kernel
    key: ms}}), where that sum would rank among the replay's kernels,
    and the rank in the replay of each kernel it launches. Returns (wall
    s, busy share, replay device ms)."""
    from torch.profiler import ProfilerActivity, profile
    c0 = _counters(exe)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _cap_run(exe, main, feed, fetch, scope, numpy=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    c1 = _counters(exe)
    _require(c1["replays"] == c0["replays"] + 1,
             f"{label}: the profiled run was no replay: {c0} -> {c1}")
    kernels = sorted(_kernels(prof), key=lambda e: e.self_device_time_total,
                     reverse=True)
    _require(kernels, f"{label}: the profiler saw no kernel of the replay")
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"  {label}: profiled replay: wall {wall:.4f} s, device busy "
          f"{100 * busy / wall:.1f} %, {sum(e.count for e in kernels)} "
          f"kernels, {total:.3f} ms of device time")
    for e in kernels[:10]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<6d} {e.key[:90]}")
    times = [e.self_device_time_total / 1e3 for e in kernels]
    rank = {e.key: i + 1 for i, e in enumerate(kernels)}
    for part in alone:
        # events_ms also counts the gaps where the card waits for the
        # host to launch the next kernel, which a replay does not have,
        # so the rank among the replay's kernels is the profiler's sum's
        if names[part]:
            dev_ms = sum(names[part].values())
            prof = (f"{dev_ms:.3f} ms; as one entry it would rank "
                    f"{sum(t > dev_ms for t in times) + 1} of "
                    f"{len(kernels) + 1} by device time")
        else:
            prof = ("not measured, nor its rank (three profiler sessions "
                    "lost their events)")
        print(f"  {label}: {what}' {part} alone: events_ms "
              f"{alone[part]:.3f} a call (CUDA events over the calls; "
              f"the replay: {total:.3f} ms of device time), profiler_ms "
              f"(its kernels' device time in a profiler session) {prof}")
        for key in sorted(names[part], key=lambda k: rank.get(k, 10 ** 6)):
            e = kernels[rank[key] - 1] if key in rank else None
            print(f"  {label}: {what} {part} kernel ranks "
                  f"{rank.get(key, 'absent')} of {len(kernels)}"
                  + (f" ({e.self_device_time_total / 1e3:.3f} ms x"
                     f"{e.count}, shared with every op that launches it)"
                     if e else "") + f": {key[:80]}")
    return wall, busy / wall, total


def _pose_profile(torch, exe, main, feed, fetch, scope, heat_shape):
    """A profiled replay with the three deconvolutions' time alone and
    ranks (_profile_with_alone)."""
    alone, deconv = _pose_deconv_alone(torch, heat_shape, POSE_B)
    wall, busy, _ = _profile_with_alone(
        torch, "pose", exe, main, feed, fetch, scope,
        "the three deconvolutions", alone, deconv)
    return wall, busy


def pose_phase(torch, dev, card):
    """SimpleBaseline (pose_resnet: ResNet-50 and three deconvolutions)
    at COCO's 256x192 and 17 joints, float32, B=32: Adam(1e-3) trained
    POSE_RUNS steps captured against eager bit for bit (one fused_adam
    launch a step), the first loss and heatmaps against the CPU, one
    step against plain_reference(), images/s eager against captured in
    turns, the capture clocked, a profiled replay (busy share, top
    kernels, the deconvolutions' ranks), peak memory; then
    save_inference_model and the heatmaps through AnalysisPredictor
    against Executor.run. Returns the captured steps' fused_adam
    launches."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    t0 = time.perf_counter()
    pt.framework.unique_name.reset()
    main, startup, loss, heat = pose_train(pt)
    main.random_seed = startup.random_seed = SEED
    params, routed = _routed_params(kreg, main)
    types = [op.type for op in main.global_block().ops]
    hw = tuple(int(d) for d in heat.shape[2:])
    print(f"  pose: {len(types)} ops in block 0 "
          f"({types.count('conv2d_transpose')} conv2d_transpose, "
          f"{types.count('conv2d_transpose_grad')} conv2d_transpose_grad, "
          f"{types.count('conv2d')} conv2d, {types.count('batch_norm')} "
          f"batch_norm, {types.count('adam')} adam); {len(params)} "
          f"parameters, {sum(int(np.prod(p.shape)) for p in params)} "
          f"elements, {len(routed)} routed to fused_adam; "
          f"{POSE['image'][0]}x{POSE['image'][1]} -> heatmaps "
          f"{POSE['kps']}x{hw[0]}x{hw[1]}, B={POSE_B}")
    _require(hw == (POSE["image"][0] // 4, POSE["image"][1] // 4) and
             types.count("conv2d_transpose") == 3, "pose: the network")
    init = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init)
    cpu_state = {n: v.get_tensor().tensor.to("cpu", copy=True)
                 for n, v in init._vars.items()}
    feed = _pose_batch(torch, 0, dev, heat=hw)
    w = feed["target_weight"]
    print(f"  batch: {POSE_B} images, {int(w.sum())} of {w.numel()} joints "
          f"weighted 1, heatmap peaks 1 (sigma {POSE_SIGMA})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    exe, scope, losses, reasons, launched = _seq_compare(
        torch, pt, kreg, "pose", main, [loss], init, [feed], POSE_RUNS,
        len(routed))
    _require(not reasons, f"pose: the block was kept eager: {reasons}")
    t1 = time.perf_counter()
    cpu_feed = _pose_batch(torch, 0, "cpu", heat=hw)
    cpu_loss, cpu_heat = _train_mode_forward(pt, main, [loss, heat],
                                             cpu_state, cpu_feed)
    _, card_heat = _train_mode_forward(pt, main, [loss, heat], cpu_state,
                                       feed, pt.CUDAPlace(0))
    err = abs(losses[0] - float(cpu_loss)) / abs(float(cpu_loss))
    herr = float(np.abs(card_heat - cpu_heat).max() /
                 np.abs(cpu_heat).max())
    print(f"  pose: first loss {losses[0]:.8f} on the card, "
          f"{float(cpu_loss):.8f} on the CPU: rel err {err:.3e} (bound "
          f"{POSE_LOSS_RTOL:g}); first heatmaps {list(card_heat.shape)}, "
          f"max |card - CPU| / max |CPU| {herr:.3e} (bound "
          f"{POSE_HEAT_RTOL:.3e}); {time.perf_counter() - t1:.1f} s")
    _require(err <= POSE_LOSS_RTOL and herr <= POSE_HEAT_RTOL and
             np.isfinite(card_heat).all() and
             card_heat.shape == (POSE_B, POSE["kps"], *hw),
             "pose: card and CPU disagree")
    _against_plain(torch, pt, kreg, "pose", main, loss, init, feed)
    with _capture_clock() as clock:
        c0 = _counters(exe)
        t1 = time.perf_counter()
        _cap_run(exe, main, feed, [loss], scope)
        secs = time.perf_counter() - t1
    print(f"  pose: {_counters(exe)['captures'] - c0['captures']} capture "
          f"outside deterministic mode, {secs:.3f} s for the run: the "
          f"capture rule {clock['rule']:.3f} s, warm-up "
          f"{clock['warm_up']:.3f} s, capture {clock['capture']:.3f} s")
    rates = _cap_turns(torch, "pose", "images/s", POSE_B, {
        "eager": lambda: _cap_run(exe, main, feed, [loss], scope,
                                  cached=False, numpy=False)[0],
        "captured": lambda: _cap_run(exe, main, feed, [loss], scope,
                                     numpy=False)[0]})
    print(f"  pose: captured / eager {rates['captured'] / rates['eager']:.3f}")
    print(f"  pose: peak memory allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; graph pools "
          f"{_graph_pool_gb(torch)[0]:.3f} GB allocated")
    _pose_profile(torch, exe, main, feed, [loss], scope, hw)
    _seq_serve(torch, pt, "pose", exe, main, heat, scope, ["image"],
               [{"image": cpu_feed["image"].numpy()}],
               [{"image": feed["image"]}], POSE_B)
    exe.close()
    del exe, scope, init
    gc_cuda(torch)
    print(f"  pose: {time.perf_counter() - t0:.1f} s")
    return launched.get("fused_adam", 0)


# YOLOv3 (Redmon and Farhadi, 2018) as PaddleCV ships it
# (PaddleCV/yolov3: models/darknet.py, models/yolov3.py, config.py,
# train.py): DarkNet-53, three heads, COCO's 80 classes at 608x608
YOLO = {"class_num": 80, "image": 608, "stages": (1, 2, 8, 8, 4),
        "width": 32}
YOLO_B = 8            # PaddleCV's batch a card
YOLO_BOXES = 50       # gt slots an image (config.py max_box_num)
YOLO_RUNS = 8         # steps of one batch, captured against eager
# COCO's 9 anchors (config.py), the masks of the heads at strides 32,
# 16 and 8
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]
YOLO_IGNORE = 0.7
# train.py: Momentum(0.9) under L2Decay(5e-4) (batch norm's parameters
# and the heads' biases L2Decay(0)), piecewise_decay([400000, 450000],
# [1e-3, 1e-4, 1e-5]) under linear_lr_warmup(4000, 0, 1e-3)
YOLO_LR = 1e-3
YOLO_LR_STEPS = (400000, 450000)
YOLO_WARMUP = 4000
YOLO_L2 = 5e-4
# infer.py: yolo_box's conf_thresh, then multiclass_nms
YOLO_DET = {"score_threshold": 0.005, "nms_top_k": 400, "keep_top_k": 100,
            "nms_threshold": 0.45}
# gt boxes an image: geometric with mean 7.3 (COCO train2017's instances
# an image), clipped to [1, YOLO_BOXES]; sides log-uniform in
# [0.02, 0.8] of the image
YOLO_OBJECTS = 7.3
# (h, w) of COCO's most common image sizes, one drawn an image
COCO_SIZES = ((480, 640), (640, 480), (427, 640), (640, 427), (426, 640),
              (424, 640), (375, 500), (640, 640))
# the first loss at B=2, card against CPU: float32 convolutions (TF32
# off) summed in other orders. The heads' outputs move, relative to the
# largest, by at most the sum over the layers of a random walk of sqrt(K)
# units of 2^-24: 75 convolutions (52 of DarkNet-53, 23 of the heads),
# K at most 9216 (3 x 3 x 1024); every term of the loss is 1-Lipschitz
# in those outputs (a sigmoid cross entropy or an absolute difference)
YOLO_LOSS_RTOL = 75 * 9216 ** 0.5 * 2.0 ** -24      # 4.29e-4
# detection rows, the predictor against Executor.run (both on the card,
# in deterministic mode)
YOLO_ROWS_ATOL = 1e-6
YOLO_TIMED = 3        # detection passes timed a mode
YOLO_LOSS_ITERS = 5   # calls a timing of yolov3_loss alone


def yolov3(L, img, class_num=80, stages=(1, 2, 8, 8, 4), width=32,
           is_test=False):
    """PaddleCV's YOLOv3 built with the layers module `L` (the port's or
    the JAX package's): DarkNet-53 (`stages` residual blocks a stage, each
    a 1x1 then a 3x3 conv_bn; a 3x3 stride-2 conv_bn before each stage,
    `width` channels at the stem), then three heads on the last three
    stages (strides 32, 16, 8): five alternating 1x1 / 3x3 conv_bn, a 3x3
    tip and a 1x1 conv with a bias to 3 x (5 + class_num) channels; the
    routes between the heads a 1x1 conv_bn, resize_nearest(scale=2) and
    a concat. Every conv_bn is a conv2d (no bias, Normal(0, 0.02)), batch
    norm (Normal(0, 0.02) scale, 0 offset, both L2Decay(0)) and
    leaky_relu(0.1) (batch norm in inference mode with `is_test`); the
    parameters carry PaddleCV's names, so a program built again (the
    detection program) shares them. Returns the three heads' outputs."""
    import importlib
    pkg = importlib.import_module(L.__name__.rpartition(".")[0])
    normal = pkg.initializer.Normal(0.0, 0.02)
    no_decay = pkg.regularizer.L2Decay(0.0)

    def conv_bn(x, ch, k, stride, padding, name):
        x = L.conv2d(x, ch, k, stride=stride, padding=padding, act=None,
                     param_attr=pkg.ParamAttr(name=name + ".conv.weights",
                                              initializer=normal),
                     bias_attr=False)
        x = L.batch_norm(
            x, act=None, is_test=is_test,
            param_attr=pkg.ParamAttr(name=name + ".bn.scale",
                                     initializer=normal,
                                     regularizer=no_decay),
            bias_attr=pkg.ParamAttr(name=name + ".bn.offset",
                                    initializer=pkg.initializer.Constant(0.0),
                                    regularizer=no_decay),
            moving_mean_name=name + ".bn.mean",
            moving_variance_name=name + ".bn.var")
        return L.leaky_relu(x, alpha=0.1)

    x = conv_bn(img, width, 3, 1, 1, "yolo_input")
    x = conv_bn(x, 2 * width, 3, 2, 1, "yolo_input.downsample")
    blocks = []
    for i, n_blocks in enumerate(stages):
        ch = width * 2 ** i
        for j in range(n_blocks):
            name = f"stage.{i}.{j}"
            y = conv_bn(x, ch, 1, 1, 0, name + ".0")
            x = L.elementwise_add(x, conv_bn(y, 2 * ch, 3, 1, 1,
                                             name + ".1"))
        blocks.append(x)
        if i < len(stages) - 1:
            x = conv_bn(x, 4 * ch, 3, 2, 1, f"stage.{i}.downsample")
    outs, route = [], None
    for i, block in enumerate(blocks[-1:-4:-1]):
        if i:
            block = L.concat([route, block], axis=1)
        ch = 16 * width // 2 ** i
        name = f"yolo_block.{i}"
        for j in range(2):
            block = conv_bn(block, ch, 1, 1, 0, f"{name}.{j}.0")
            block = conv_bn(block, 2 * ch, 3, 1, 1, f"{name}.{j}.1")
        route = conv_bn(block, ch, 1, 1, 0, f"{name}.2")
        tip = conv_bn(route, 2 * ch, 3, 1, 1, f"{name}.tip")
        outs.append(L.conv2d(
            tip, len(YOLO_MASKS[i]) * (class_num + 5), 1, stride=1,
            padding=0, act=None,
            param_attr=pkg.ParamAttr(name=f"yolo_output.{i}.conv.weights",
                                     initializer=normal),
            bias_attr=pkg.ParamAttr(name=f"yolo_output.{i}.conv.bias",
                                    initializer=pkg.initializer.Constant(0.0),
                                    regularizer=no_decay)))
        if i < 2:
            route = conv_bn(route, 8 * width // 2 ** i, 1, 1, 0,
                            f"yolo_transition.{i}")
            route = L.resize_nearest(route, scale=2)
    return outs


def yolov3_losses(L, outs, gt_box, gt_label, gt_score, class_num):
    """The sum over the heads of each head's yolov3_loss (label
    smoothing on, ignore_thresh YOLO_IGNORE), averaged over the batch."""
    losses = [L.reduce_mean(L.yolov3_loss(
        o, gt_box, gt_label, YOLO_ANCHORS, YOLO_MASKS[i], class_num,
        YOLO_IGNORE, 32 // 2 ** i, gt_score=gt_score, use_label_smooth=True))
        for i, o in enumerate(outs)]
    return L.sum(losses)


def yolov3_train(pt, image=None, class_num=None, stages=None, width=None,
                 boxes=YOLO_BOXES):
    """(main, startup, loss, heads) of PaddleCV's train.py in package `pt`:
    feeds image [3, image, image], gt_box [boxes, 4] (normalized cx, cy,
    w, h; w = 0 pads), gt_label [boxes] int32, gt_score [boxes]; Momentum
    (0.9) under the warm-up and piecewise schedule and L2Decay minimizes
    yolov3_losses."""
    L = pt.layers
    image = image or YOLO["image"]
    class_num = class_num or YOLO["class_num"]
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = L.data("image", [3, image, image], dtype="float32")
        gt_box = L.data("gt_box", [boxes, 4], dtype="float32")
        gt_label = L.data("gt_label", [boxes], dtype="int32")
        gt_score = L.data("gt_score", [boxes], dtype="float32")
        outs = yolov3(L, img, class_num, stages or YOLO["stages"],
                      width or YOLO["width"])
        loss = yolov3_losses(L, outs, gt_box, gt_label, gt_score, class_num)
        lr = L.linear_lr_warmup(
            L.piecewise_decay(list(YOLO_LR_STEPS),
                              [YOLO_LR * 0.1 ** i for i in range(3)]),
            YOLO_WARMUP, 0.0, YOLO_LR)
        pt.optimizer.MomentumOptimizer(
            learning_rate=lr, momentum=0.9,
            regularization=pt.regularizer.L2Decay(YOLO_L2)).minimize(loss)
    return main, startup, loss, outs


def yolov3_detect(pt, image=None, class_num=None, stages=None, width=None):
    """(program, startup, nmsed) of infer.py in package `pt`: yolov3 built
    again with batch norm in inference mode (its parameters those of
    the trained program, by name), yolo_box on each head (feed im_shape
    [2] int32, (h, w) an image; the head's mask's anchors, conf_thresh
    YOLO_DET's score_threshold), then multiclass_nms over the three
    heads' boxes (background -1)."""
    L = pt.layers
    image = image or YOLO["image"]
    class_num = class_num or YOLO["class_num"]
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        img = L.data("image", [3, image, image], dtype="float32")
        im_shape = L.data("im_shape", [2], dtype="int32")
        outs = yolov3(L, img, class_num, stages or YOLO["stages"],
                      width or YOLO["width"], is_test=True)
        boxes, scores = [], []
        for i, o in enumerate(outs):
            anchors = [YOLO_ANCHORS[2 * m + k] for m in YOLO_MASKS[i]
                       for k in (0, 1)]
            b, sc = L.yolo_box(o, im_shape, anchors, class_num,
                               YOLO_DET["score_threshold"], 32 // 2 ** i)
            boxes.append(b)
            scores.append(L.transpose(sc, perm=[0, 2, 1]))
        nmsed = L.multiclass_nms(L.concat(boxes, axis=1),
                                 L.concat(scores, axis=2),
                                 background_label=-1, **YOLO_DET)
    return prog, startup, nmsed


def _coco_batch(torch, seed, device, B=None, image=None, boxes=YOLO_BOXES,
                class_num=None):
    """A COCO-shaped batch from `seed`: B images (standard normal, made by
    a torch generator on the CPU, then moved to `device`); per image a
    geometric number of boxes (YOLO_OBJECTS, at most `boxes`), normalized
    (cx, cy, w, h) with sides log-uniform in [0.02, 0.8] inside the
    image, labels uniform in [0, class_num), scores 1, the rest of the
    slots zero; im_shape one of COCO_SIZES an image."""
    B, image = B or YOLO_B, image or YOLO["image"]
    class_num = class_num or YOLO["class_num"]
    rng = np.random.default_rng(seed)
    n = np.clip(rng.geometric(1.0 / YOLO_OBJECTS, B), 1, boxes)
    box = np.zeros((B, boxes, 4), np.float32)
    label = np.zeros((B, boxes), np.int32)
    score = np.zeros((B, boxes), np.float32)
    for b, k in enumerate(n):
        wh = np.exp(rng.uniform(np.log(0.02), np.log(0.8), (k, 2)))
        box[b, :k, :2] = rng.uniform(wh / 2, 1 - wh / 2)
        box[b, :k, 2:] = wh
        label[b, :k] = rng.integers(0, class_num, k)
        score[b, :k] = 1.0
    sizes = np.array(COCO_SIZES, np.int32)[
        rng.integers(0, len(COCO_SIZES), B)]
    gen = torch.Generator()
    gen.manual_seed(seed)
    img = torch.randn((B, 3, image, image), generator=gen)
    t = {"image": img, "gt_box": torch.from_numpy(box),
         "gt_label": torch.from_numpy(label),
         "gt_score": torch.from_numpy(score),
         "im_shape": torch.from_numpy(sizes)}
    return {k: v.to(device) for k, v in t.items()}


def _yolo_train_feed(f):
    return {k: f[k] for k in ("image", "gt_box", "gt_label", "gt_score")}


# RetinaNet's head at test size (Lin et al., 2017): two levels (strides 8
# and 16) of a 64x64 image, 3 anchors a cell, 5 classes, width 16
RETINA = {"num_classes": 5, "image": 64, "width": 16}
RETINA_RATIOS = (0.5, 1.0, 2.0)
RETINA_B = 4
RETINA_RUNS = 3
RETINA_LR = 0.01
RETINA_DET = {"score_threshold": 0.05, "nms_top_k": 1000, "keep_top_k": 100,
              "nms_threshold": 0.5}


def retinanet(L, img, num_classes, width):
    """A RetinaNet head at test size built with the layers module `L`:
    three stride-2 3x3 convs (relu) to stride 8, a fourth to stride 16;
    on each of the two levels anchor_generator (size 4 x stride, the
    RETINA_RATIOS), a 3x3 class conv (bias -log(99): prior 0.01) and a
    3x3 box conv. Returns per level (boxes [N, M, 4], class logits [N,
    M, num_classes], anchors [M, 4], variances [M, 4])."""
    import importlib
    pkg = importlib.import_module(L.__name__.rpartition(".")[0])
    x, levels = img, []
    for _ in range(3):
        x = L.conv2d(x, width, 3, stride=2, padding=1, act="relu")
    for lvl in range(2):
        if lvl:
            x = L.conv2d(x, width, 3, stride=2, padding=1, act="relu")
        stride = 8.0 * 2 ** lvl
        anchors, var = L.anchor_generator(
            x, anchor_sizes=[4 * stride], aspect_ratios=list(RETINA_RATIOS),
            stride=[stride, stride])
        a = len(RETINA_RATIOS)
        cls = L.conv2d(x, a * num_classes, 3, padding=1,
                       bias_attr=pkg.ParamAttr(
                           initializer=pkg.initializer.Constant(
                               -math.log(99.0))))
        box = L.conv2d(x, a * 4, 3, padding=1)
        levels.append((
            L.reshape(L.transpose(box, perm=[0, 2, 3, 1]), [0, -1, 4]),
            L.reshape(L.transpose(cls, perm=[0, 2, 3, 1]),
                      [0, -1, num_classes]),
            L.reshape(anchors, [-1, 4]), L.reshape(var, [-1, 4])))
    return levels


def retinanet_loss(L, levels, gt_box, gt_label, is_crowd, im_info,
                   num_classes):
    """retinanet_target_assign over the levels' concatenated predictions
    and anchors, then sigmoid_focal_loss (gamma 2, alpha 0.25) over the
    batch's foreground count plus smooth_l1 (sigma 3) of the positives'
    boxes over it. The builder gathers the predictions by [R, 1] indices,
    which gather (jnp.take's rule) keeps: [R, 1, C] and [R, 1, 4], where
    the reference's builder returns [R, C] and [R, 4]; reshaped to those,
    or the losses would broadcast them against [R] labels to [R, R, C]."""
    box = L.concat([lv[0] for lv in levels], axis=1)
    cls = L.concat([lv[1] for lv in levels], axis=1)
    anchors = L.concat([lv[2] for lv in levels], axis=0)
    var = L.concat([lv[3] for lv in levels], axis=0)
    score, loc, label, target, weight, fg = L.retinanet_target_assign(
        box, cls, anchors, var, gt_box, gt_label, is_crowd, im_info,
        num_classes, positive_overlap=0.5, negative_overlap=0.4)
    score = L.reshape(score, [-1, num_classes])
    loc = L.reshape(loc, [-1, 4])
    fg = L.reduce_sum(fg)
    focal = L.reduce_sum(L.sigmoid_focal_loss(score, label, fg, gamma=2.0,
                                              alpha=0.25))
    l1 = L.reduce_sum(L.smooth_l1(loc, target, inside_weight=weight,
                                  outside_weight=weight, sigma=3.0))
    return L.elementwise_add(focal, L.elementwise_div(
        l1, L.cast(fg, "float32")))


def retinanet_train(pt):
    """(main, startup, loss, levels) of the RetinaNet head in package
    `pt`: feeds image, gt_box [4] / gt_label [1] int32 / is_crowd [1]
    int32 (LoD tensors, a segment an image, pixel boxes), im_info [3]
    (h, w, scale); SGD(RETINA_LR) minimizes retinanet_loss."""
    L = pt.layers
    c, image = RETINA["num_classes"], RETINA["image"]
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = L.data("image", [3, image, image], dtype="float32")
        gt_box = L.data("gt_box", [4], dtype="float32", lod_level=1)
        gt_label = L.data("gt_label", [1], dtype="int32", lod_level=1)
        is_crowd = L.data("is_crowd", [1], dtype="int32", lod_level=1)
        im_info = L.data("im_info", [3], dtype="float32")
        levels = retinanet(L, img, c, RETINA["width"])
        loss = retinanet_loss(L, levels, gt_box, gt_label, is_crowd,
                              im_info, c)
        pt.optimizer.SGD(learning_rate=RETINA_LR).minimize(loss)
    return main, startup, loss, levels


def retinanet_detect(pt, main, levels):
    """The forward up to the levels, then retinanet_detection_output on
    the sigmoid of their class logits (RETINA_DET). Returns (program,
    out)."""
    L = pt.layers
    prog = pt.io._prune_program(main, [v.name for lv in levels
                                       for v in lv])
    block = prog.global_block()
    with pt.program_guard(prog, pt.Program()):
        out = L.retinanet_detection_output(
            [block.var(lv[0].name) for lv in levels],
            [L.sigmoid(block.var(lv[1].name)) for lv in levels],
            [block.var(lv[2].name) for lv in levels],
            block.var("im_info"), **RETINA_DET)
    return prog, out


def _retina_batch(pt, seed, place, B=None):
    """A batch from default_rng(seed): B images (standard normal), 1-4
    pixel boxes an image (sides 8-40 of the 64-pixel image, labels 1 to
    num_classes - 1, one in ten crowd) as LoD tensors on `place`,
    im_info (64, 64, 1) an image."""
    import torch
    B = B or RETINA_B
    rng = np.random.default_rng(seed)
    image = RETINA["image"]
    n = rng.integers(1, 5, B)
    g = int(n.sum())
    wh = rng.uniform(8.0, 40.0, (g, 2))
    xy = rng.uniform(0.0, image - wh)
    box = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    label = rng.integers(1, RETINA["num_classes"], (g, 1)).astype(np.int32)
    crowd = (rng.random((g, 1)) < 0.1).astype(np.int32)
    img = rng.standard_normal((B, 3, image, image)).astype(np.float32)
    lens = [n.tolist()]
    dev = place.torch_device()
    return {"image": torch.from_numpy(img).to(dev),
            "gt_box": pt.create_lod_tensor(box, lens, place),
            "gt_label": pt.create_lod_tensor(label, lens, place),
            "is_crowd": pt.create_lod_tensor(crowd, lens, place),
            "im_info": torch.tensor([[image, image, 1.0]] * B,
                                    dtype=torch.float32, device=dev)}


def _yolo_loss_alone(torch, outs, feed):
    """The three heads' yolov3_loss ops alone at the replay's shapes
    (`outs`: the heads' outputs on the card, the feed's boxes), forward
    (recording for autograd, as a training step runs it) and backward
    (the generic gradient: torch's reverse mode through the lowering):
    _timed_parts over YOLO_LOSS_ITERS calls."""
    from paddle_tpu_torch.core.registry import OPS, ExecContext, _SlotView
    xs = [o.detach().clone().requires_grad_(True) for o in outs]
    ins = {"X": ["x"], "GTBox": ["gtb"], "GTLabel": ["gtl"],
           "GTScore": ["gts"]}
    slots = {"Loss": ["loss"], "ObjectnessMask": ["om"],
             "GTMatchMask": ["gm"]}

    def forward():
        total = 0.0
        for i, x in enumerate(xs):
            env = {"x": x, "gtb": feed["gt_box"], "gtl": feed["gt_label"],
                   "gts": feed["gt_score"]}
            view = _SlotView("yolov3_loss", ins, slots, {
                "anchors": YOLO_ANCHORS, "anchor_mask": YOLO_MASKS[i],
                "class_num": YOLO["class_num"],
                "ignore_thresh": YOLO_IGNORE,
                "downsample_ratio": 32 // 2 ** i,
                "use_label_smooth": True})
            OPS.get("yolov3_loss").lowering(ExecContext(view, env, x.device,
                                                        None, {}))
            total = total + env["loss"].mean()
        return total

    loss = forward()
    return _timed_parts(torch, {
        "forward": forward,
        "backward": lambda: torch.autograd.backward(loss, retain_graph=True)},
        YOLO_LOSS_ITERS)


def _yolo_train(torch, pt, kreg, dev):
    """YOLOv3 trained captured against eager: returns (the trained scope,
    the feed)."""
    t0 = time.perf_counter()
    pt.framework.unique_name.reset()
    main, startup, loss, outs = yolov3_train(pt)
    main.random_seed = startup.random_seed = SEED
    types = [op.type for op in main.global_block().ops]
    params = main.all_parameters()
    shapes = [tuple(int(d) for d in o.shape[1:]) for o in outs]
    print(f"  yolov3: {len(types)} ops in block 0 ({types.count('conv2d')} "
          f"conv2d, {types.count('batch_norm')} batch_norm, "
          f"{types.count('yolov3_loss')} yolov3_loss, "
          f"{types.count('nearest_interp')} nearest_interp, "
          f"{types.count('momentum')} momentum); {len(params)} parameters, "
          f"{sum(int(np.prod(p.shape)) for p in params)} elements; heads "
          f"{shapes}, {YOLO['image']}x{YOLO['image']}, B={YOLO_B}")
    # DarkNet-53: 2 stem convs, 2 a block, a downsample between stages;
    # the heads 23 (75 in all at (1, 2, 8, 8, 4))
    stages = YOLO["stages"]
    _require(types.count("conv2d") == 2 + 2 * sum(stages) + len(stages) - 1
             + 23 and types.count("yolov3_loss") == 3
             and shapes[0] == (255, YOLO["image"] // 32,
                               YOLO["image"] // 32), "yolov3: the network")
    init = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init)
    cpu_state = {n: v.get_tensor().tensor.to("cpu", copy=True)
                 for n, v in init._vars.items()}
    batch = _coco_batch(torch, 0, dev)
    feed = _yolo_train_feed(batch)
    n = (feed["gt_box"][:, :, 2] > 0).sum(1).tolist()
    print(f"  batch: {YOLO_B} images, {sum(n)} gt boxes ({min(n)}-{max(n)} "
          f"an image), im_shape {batch['im_shape'].tolist()}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    exe, scope, losses, reasons, _ = _seq_compare(
        torch, pt, kreg, "yolov3", main, [loss], init, [feed], YOLO_RUNS)
    _require(not reasons, f"yolov3: the block was kept eager: {reasons}")
    # the first loss at B=2 (the same program, the batch's first two
    # images), card against CPU
    t1 = time.perf_counter()
    two = {k: v[:2] for k, v in feed.items()}
    card2 = _train_mode_forward(pt, main, [loss] + outs, cpu_state, two,
                                pt.CUDAPlace(0))
    cpu2 = _train_mode_forward(pt, main, [loss] + outs, cpu_state,
                               {k: v.cpu() for k, v in two.items()})
    err = abs(float(card2[0]) - float(cpu2[0])) / abs(float(cpu2[0]))
    herr = max(float(np.abs(a - b).max() / np.abs(b).max())
               for a, b in zip(card2[1:], cpu2[1:]))
    print(f"  yolov3: first loss at B=2 {float(card2[0]):.8f} on the card, "
          f"{float(cpu2[0]):.8f} on the CPU: rel err {err:.3e}; the heads' "
          f"outputs max |card - CPU| / max |CPU| {herr:.3e} (bound of "
          f"both {YOLO_LOSS_RTOL:.3e}); {time.perf_counter() - t1:.1f} s")
    _require(err <= YOLO_LOSS_RTOL and herr <= YOLO_LOSS_RTOL and
             all(np.isfinite(a).all() for a in card2),
             "yolov3: card and CPU disagree")
    with _capture_clock() as clock:
        c0 = _counters(exe)
        t1 = time.perf_counter()
        _cap_run(exe, main, feed, [loss], scope)
        secs = time.perf_counter() - t1
    print(f"  yolov3: {_counters(exe)['captures'] - c0['captures']} capture "
          f"outside deterministic mode, {secs:.3f} s for the run: the "
          f"capture rule {clock['rule']:.3f} s, warm-up "
          f"{clock['warm_up']:.3f} s, capture {clock['capture']:.3f} s")
    rates = _cap_turns(torch, "yolov3", "images/s", YOLO_B, {
        "eager": lambda: _cap_run(exe, main, feed, [loss], scope,
                                  cached=False, numpy=False)[0],
        "captured": lambda: _cap_run(exe, main, feed, [loss], scope,
                                     numpy=False)[0]})
    print(f"  yolov3: captured / eager "
          f"{rates['captured'] / rates['eager']:.3f}")
    print(f"  yolov3: peak memory allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; graph pools "
          f"{_graph_pool_gb(torch)[0]:.3f} GB allocated")
    heads = exe.run(main, feed=feed, fetch_list=outs, scope=scope,
                    use_program_cache=False, return_numpy=False)
    alone, names = _yolo_loss_alone(torch, heads, feed)
    del heads
    _profile_with_alone(torch, "yolov3", exe, main, feed, [loss], scope,
                        "the three yolov3_loss ops", alone, names)
    exe.close()
    print(f"  yolov3 training: {time.perf_counter() - t0:.1f} s")
    return scope, batch


def _yolo_detect(torch, pt, scope, batch):
    """The detection program on the trained parameters through
    Executor.run (eager, captured, replays) and AnalysisPredictor, in
    deterministic mode: rows equal; images/s eager against captured;
    multiclass_nms's device time in a detection replay and alone."""
    import tempfile
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    t0 = time.perf_counter()
    pt.framework.unique_name.reset()
    prog, _, nmsed = yolov3_detect(pt)
    feed = {"image": batch["image"], "im_shape": batch["im_shape"]}
    exe = pt.Executor(pt.CUDAPlace(0))
    rows = []
    with _deterministic(torch):
        for cached in (False, True, True, True):
            rows.append(_det_rows(_cap_run(exe, prog, feed, [nmsed],
                                           scope, cached)[0]))
    c = _counters(exe)
    eq = all(np.array_equal(r[0], rows[0][0]) and r[1] == rows[0][1]
             for r in rows)
    det, lod = rows[0]
    kept = det[det[:, 0] >= 0]
    print(f"  yolov3 detect: {len(prog.global_block().ops)} ops; rows "
          f"{list(det.shape)}, LoD {lod[0][:3]}...{lod[0][-1]}; "
          f"{len(kept)} detections (labels "
          f"{int(kept[:, 0].min()) if len(kept) else '-'}-"
          f"{int(kept[:, 0].max()) if len(kept) else '-'}); eager, captured "
          f"and replayed rows equal {eq}; counters {c}; eager reasons "
          f"{list(exe._engine.eager_reasons.values()) or 'none'}")
    _require(eq and c["captures"] == 1 and c["replays"] == 2 and
             det.shape == (YOLO_B * YOLO_DET["keep_top_k"], 6) and
             np.isfinite(det).all(), "yolov3 detect: the rows")
    with tempfile.TemporaryDirectory() as d:
        with pt.scope_guard(scope):
            pt.io.save_inference_model(d, ["image", "im_shape"], [nmsed],
                                       exe, main_program=prog)
        predictor = create_paddle_predictor(AnalysisConfig(d))
    host = {k: np.asarray(v.cpu()) for k, v in feed.items()}
    with _deterministic(torch):
        for _ in range(3):
            for k, v in host.items():
                predictor.get_input_tensor(k).copy_from_cpu(v)
            predictor.zero_copy_run()
    ot = predictor.get_output_tensor(predictor.get_output_names()[0])
    prow = ot.copy_to_cpu()
    worst = float(np.abs(prow - det).max())
    pc = dict(predictor._engine.counters)
    print(f"  yolov3 detect serving: AnalysisPredictor rows "
          f"{list(prow.shape)}, LoD {ot.lod() == lod}, max |predictor - "
          f"Executor| {worst:.3e} (bound {YOLO_ROWS_ATOL:g}); counters "
          f"captures {pc['captures']}, replays {pc['replays']}")
    _require(worst <= YOLO_ROWS_ATOL and ot.lod() == lod and
             pc["captures"] == 1, "yolov3 detect: the predictor's rows")
    # leaving deterministic mode changes the routing a capture bakes in:
    # the plan captures again before the turns
    for _ in range(2):
        _cap_run(exe, prog, feed, [nmsed], scope, numpy=False)
    secs = {"eager": [], "captured": []}
    for turn in range(2):
        for m in (("eager", "captured") if turn == 0 else
                  ("captured", "eager")):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(YOLO_TIMED):
                _cap_run(exe, prog, feed, [nmsed], scope, m == "captured",
                         numpy=False)
            torch.cuda.synchronize()
            secs[m].append(time.perf_counter() - t1)
    n_img = YOLO_B * YOLO_TIMED
    for m, v in secs.items():
        print(f"  yolov3 detect {m}: s a pass of {n_img} images "
              f"{', '.join(f'{x:.3f}' for x in v)}: "
              f"{n_img / float(np.median(v)):.1f} images/s")
    wall, busy, _ = _profiled_replay(torch, "yolov3 detect", exe, prog,
                                     feed, [nmsed], scope)
    nms = _nms_alone(torch, pt, scope, prog, feed,
                     label="yolov3 multiclass_nms")
    print(f"  yolov3 detect: multiclass_nms alone takes "
          f"{1e3 * nms['device']:.3f} ms of device time captured, "
          f"{100 * nms['device'] / (wall * busy):.1f} % of a captured "
          f"detection run's {1e3 * wall * busy:.3f} ms")
    exe.close()
    print(f"  yolov3 detection: {time.perf_counter() - t0:.1f} s")


def _retina_phase(torch, pt, kreg):
    """The RetinaNet head of the CPU tests at RETINA_B on the card: SGD
    RETINA_RUNS steps captured against eager bit for bit, then its
    detection program captured against eager."""
    t0 = time.perf_counter()
    pt.framework.unique_name.reset()
    main, startup, loss, levels = retinanet_train(pt)
    main.random_seed = startup.random_seed = SEED
    types = [op.type for op in main.global_block().ops]
    init = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init)
    feed = _retina_batch(pt, 0, pt.CUDAPlace(0))
    print(f"  retinanet: {len(types)} ops in block 0, B={RETINA_B}, "
          f"{int(feed['gt_box'].lod()[0][-1])} gt boxes, "
          f"{sum(int(np.prod(lv[2].shape[:1])) for lv in levels)} anchors")
    exe, scope, losses, reasons, _ = _seq_compare(
        torch, pt, kreg, "retinanet", main, [loss], init, [feed],
        RETINA_RUNS)
    _require(not reasons, f"retinanet: the block was kept eager: {reasons}")
    det, out = retinanet_detect(pt, main, levels)
    f = {k: feed[k] for k in ("image", "im_info")}
    rows = []
    with _deterministic(torch):
        for cached in (False, True, True):
            rows.append(_det_rows(_cap_run(exe, det, f, [out], scope,
                                           cached)[0]))
    eq = all(np.array_equal(r[0], rows[0][0]) and r[1] == rows[0][1]
             for r in rows)
    r = rows[0][0]
    print(f"  retinanet detect: rows {list(r.shape)}, "
          f"{int((r[:, 0] >= 0).sum())} detections; eager, captured and "
          f"replayed rows equal {eq}; eager reasons "
          f"{list(exe._engine.eager_reasons.values()) or 'none'}; "
          f"{time.perf_counter() - t0:.1f} s")
    _require(eq and np.isfinite(r).all() and not exe._engine.eager_reasons
             and r.shape == (RETINA_B * RETINA_DET["keep_top_k"], 6),
             "retinanet detect: the rows")
    exe.close()


def yolo_phase(torch, dev):
    """YOLOv3 (yolov3: DarkNet-53 and three heads) at COCO's 608x608 and
    80 classes, float32, B=8: Momentum (warm-up, piecewise decay,
    L2Decay) trained YOLO_RUNS steps captured against eager bit for bit,
    the first loss at B=2 against the CPU, images/s eager against
    captured in turns, the capture clocked, peak memory, a profiled
    replay (busy share, top kernels, the yolov3_loss ops' time alone and
    their kernels' ranks); then the detection program (yolo_box and
    multiclass_nms) through Executor.run and AnalysisPredictor, its
    images/s and multiclass_nms's device time; then the RetinaNet head
    at B=4 (retinanet_target_assign, sigmoid_focal_loss, gather,
    retinanet_detection_output) captured against eager. No kernel of the
    port lies on this path."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    t0 = time.perf_counter()
    scope, batch = _yolo_train(torch, pt, kreg, dev)
    _yolo_detect(torch, pt, scope, batch)
    del scope, batch
    gc_cuda(torch)
    _retina_phase(torch, pt, kreg)
    gc_cuda(torch)
    print(f"  yolo phase: {time.perf_counter() - t0:.1f} s")


# Faster R-CNN (Ren et al., 2015) as PaddleCV ships it (PaddleCV/rcnn:
# models/model_builder.py, models/resnet.py, config.py), Detectron's
# e2e_faster_rcnn_R-50-C4_1x layout: ResNet-50 to res4 (conv1 and res2
# frozen), an RPN on res4, roi_align to 14x14, res5 and a 7x7 average
# pool, COCO's 81 classes, images resized to a short side of 800 (long
# side at most 1333) on a fixed 800x1344 canvas
RCNN = {"class_num": 81, "image": (800, 1344), "stages": (3, 4, 6, 3),
        "width": 64}
RCNN_B = 2            # images a card (Detectron's C4 config takes 1)
RCNN_RUNS = 8         # steps of one batch, captured against eager
RCNN_ANCHOR_SIZES = [32.0, 64.0, 128.0, 256.0, 512.0]
RCNN_RATIOS = [0.5, 1.0, 2.0]
RCNN_STRIDE = 16.0
# (pre_nms_topN, post_nms_topN) of generate_proposals; NMS 0.7, min_size 0
RCNN_PROPOSALS = {"train": (12000, 2000), "detect": (6000, 1000)}
RCNN_RPN_BATCH = 256  # rpn_target_assign's anchors an image
RCNN_ROI_BATCH = 512  # generate_proposal_labels' RoIs an image
RCNN_REG_WEIGHTS = [0.1, 0.1, 0.2, 0.2]
RCNN_CALIBRATION_SEED = 100   # the batch rcnn_calibrate reads
# train.py: Momentum(0.9) under L2Decay(1e-4); piecewise_decay([120000,
# 160000], [0.01, 0.001, 0.0001]) under linear_lr_warmup(500, 0.01 / 3,
# 0.01)
RCNN_LR = 0.01
RCNN_LR_STEPS = (120000, 160000)
RCNN_WARMUP = 500
RCNN_L2 = 1e-4
# config.py TEST: score 0.05, NMS 0.5, 100 detections an image
RCNN_DET = {"score_threshold": 0.05, "nms_threshold": 0.5,
            "keep_top_k": 100}
# COCO's landscape (w, h) sizes, one drawn an image
COCO_LANDSCAPE = ((640, 480), (640, 427), (500, 375), (640, 426),
                  (640, 424), (500, 333), (640, 512))


def _frozen_affine(L, pkg, x, ch, name):
    """PaddleCV's frozen batch norm after a conv: affine_channel with a
    scale (1) and an offset (0) that no step updates."""
    bn = "bn_" + name if name == "conv1" else "bn" + name[3:]
    scale = L.create_parameter(
        [ch], "float32", attr=pkg.ParamAttr(name=bn + "_scale",
                                            learning_rate=0.0),
        default_initializer=pkg.initializer.Constant(1.0))
    offset = L.create_parameter(
        [ch], "float32", attr=pkg.ParamAttr(name=bn + "_offset",
                                            learning_rate=0.0),
        default_initializer=pkg.initializer.Constant(0.0))
    scale.stop_gradient = offset.stop_gradient = True
    return L.affine_channel(x, scale=scale, bias=offset)


def _conv_affine(L, pkg, x, ch, k, stride, padding, name, act=True):
    x = L.conv2d(x, ch, k, stride=stride, padding=padding, act=None,
                 param_attr=pkg.ParamAttr(name=name + "_weights"),
                 bias_attr=False)
    x = _frozen_affine(L, pkg, x, ch, name)
    return L.relu(x) if act else x


def _bottleneck(L, pkg, x, ch, stride, name):
    """resnet.py's bottleneck: the stride on the first 1x1 (Detectron's
    STRIDE_1X1), a projection shortcut where the width changes."""
    short = x if int(x.shape[1]) == 4 * ch else _conv_affine(
        L, pkg, x, 4 * ch, 1, stride, 0, name + "_branch1", act=False)
    y = _conv_affine(L, pkg, x, ch, 1, stride, 0, name + "_branch2a")
    y = _conv_affine(L, pkg, y, ch, 3, 1, 1, name + "_branch2b")
    y = _conv_affine(L, pkg, y, 4 * ch, 1, 1, 0, name + "_branch2c",
                     act=False)
    return L.relu(L.elementwise_add(short, y))


def _res_stage(L, pkg, x, ch, count, stride, name):
    for i in range(count):
        x = _bottleneck(L, pkg, x, ch, stride if i == 0 else 1,
                        name + chr(ord("a") + i))
    return x


def faster_rcnn(L, img, im_info, gt_box=None, gt_label=None,
                is_crowd=None, class_num=81, stages=(3, 4, 6, 3),
                mode="train", width=64, proposals=None, rpn_batch=None,
                roi_batch=None, use_random=True, rois=None):
    """PaddleCV's Faster R-CNN (ResNet-50-C4) built with the layers module
    `L` (the port's or the JAX package's), its parameters under
    PaddleCV's names. The backbone: conv1 (7x7, stride 2; `width`
    channels) and a 3x3 max pool, then res2-res4 of `stages[:3]`
    bottlenecks (res2 stops the gradient: freeze_at 2), every conv
    without a bias and followed by a frozen affine_channel. The RPN: a
    3x3 conv of res4's width (relu), 1x1 convs to 15 objectness logits
    and 60 deltas, anchor_generator (RCNN_ANCHOR_SIZES x RCNN_RATIOS,
    stride 16, variances 1) and generate_proposals (sigmoid scores;
    `proposals` = (pre, post), RCNN_PROPOSALS[mode] by default; NMS 0.7,
    min_size 0). mode "train": rpn_target_assign (`rpn_batch` anchors an
    image, RCNN_RPN_BATCH by default; fg 0.5, 0.7 / 0.3, straddle 0) and
    generate_proposal_labels (`roi_batch` RoIs an image, RCNN_ROI_BATCH
    by default; fg 0.25, fg 0.5, bg [0, 0.5),
    RCNN_REG_WEIGHTS) with `use_random`; the head pools the sampled
    RoIs. mode "detect": the head pools the proposals. mode "head": the
    head pools `rois` (a fed LoD var). The head: roi_align (14x14, 1/16,
    sampling_ratio 0), res5 (`stages[3]` bottlenecks of 8 x width, the
    first stride 2), a 7x7 average pool, an fc to class_num scores
    (Normal(0, 0.001)) and an fc to 4 class_num deltas (Normal(0,
    0.01)). Returns a dict of the vars: res4, rpn_cls, rpn_bbox,
    rpn_rois, cls_score, bbox_pred; in training also rois, labels,
    score_index and the losses (rpn_cls_loss, rpn_reg_loss, cls_loss,
    bbox_loss, loss: their sum); in detection nmsed."""
    import importlib
    pkg = importlib.import_module(L.__name__.rpartition(".")[0])
    lr2 = {"learning_rate": 2.0, "regularizer": pkg.regularizer.L2Decay(0.0)}
    rpn_batch = rpn_batch or RCNN_RPN_BATCH
    roi_batch = roi_batch or RCNN_ROI_BATCH
    x = _conv_affine(L, pkg, img, width, 7, 2, 3, "conv1")
    x = L.pool2d(x, pool_size=3, pool_type="max", pool_stride=2,
                 pool_padding=1)
    res2 = _res_stage(L, pkg, x, width, stages[0], 1, "res2")
    res2.stop_gradient = True
    res3 = _res_stage(L, pkg, res2, 2 * width, stages[1], 2, "res3")
    res4 = _res_stage(L, pkg, res3, 4 * width, stages[2], 2, "res4")
    out = {"res4": res4}
    dim = int(res4.shape[1])
    rpn = L.conv2d(res4, dim, 3, padding=1, act="relu",
                   param_attr=pkg.ParamAttr(
                       name="conv_rpn_w",
                       initializer=pkg.initializer.Normal(0.0, 0.01)),
                   bias_attr=pkg.ParamAttr(name="conv_rpn_b", **lr2))
    anchor, var = L.anchor_generator(
        rpn, anchor_sizes=RCNN_ANCHOR_SIZES, aspect_ratios=RCNN_RATIOS,
        variance=[1.0, 1.0, 1.0, 1.0], stride=[RCNN_STRIDE, RCNN_STRIDE])
    a = len(RCNN_ANCHOR_SIZES) * len(RCNN_RATIOS)

    def rpn_conv(ch, name):
        return L.conv2d(rpn, ch, 1, act=None, param_attr=pkg.ParamAttr(
            name=name + "_w", initializer=pkg.initializer.Normal(0.0, 0.01)),
            bias_attr=pkg.ParamAttr(name=name + "_b", **lr2))
    out["rpn_cls"] = rpn_cls = rpn_conv(a, "rpn_cls_logits")
    out["rpn_bbox"] = rpn_bbox = rpn_conv(4 * a, "rpn_bbox_pred")
    pre, post = proposals or RCNN_PROPOSALS[
        "train" if mode == "train" else "detect"]
    rpn_rois, _ = L.generate_proposals(
        L.sigmoid(rpn_cls), rpn_bbox, im_info, anchor, var,
        pre_nms_top_n=pre, post_nms_top_n=post, nms_thresh=0.7,
        min_size=0.0, eta=1.0)
    out["rpn_rois"] = rpn_rois
    pool_rois = rpn_rois if mode == "detect" else rois
    if mode == "train":
        (pool_rois, labels, targets, inside,
         outside) = L.generate_proposal_labels(
            rpn_rois, gt_label, is_crowd, gt_box, im_info,
            batch_size_per_im=roi_batch, fg_fraction=0.25, fg_thresh=0.5,
            bg_thresh_hi=0.5, bg_thresh_lo=0.0,
            bbox_reg_weights=RCNN_REG_WEIGHTS, class_nums=class_num,
            use_random=use_random)
        out.update(rois=pool_rois, labels=labels)
    pool = L.roi_align(res4, pool_rois, 14, 14, 1.0 / RCNN_STRIDE, 0)
    res5 = _res_stage(L, pkg, pool, 8 * width, stages[3], 2, "res5")
    head = L.pool2d(res5, pool_size=7, pool_type="avg", pool_stride=1)
    out["cls_score"] = cls_score = L.fc(
        head, class_num, act=None, param_attr=pkg.ParamAttr(
            name="cls_score_w",
            initializer=pkg.initializer.Normal(0.0, 0.001)),
        bias_attr=pkg.ParamAttr(name="cls_score_b", **lr2))
    out["bbox_pred"] = bbox_pred = L.fc(
        head, 4 * class_num, act=None, param_attr=pkg.ParamAttr(
            name="bbox_pred_w",
            initializer=pkg.initializer.Normal(0.0, 0.01)),
        bias_attr=pkg.ParamAttr(name="bbox_pred_b", **lr2))
    if mode == "train":
        out.update(_rcnn_losses(L, rpn_cls, rpn_bbox, anchor, var, gt_box,
                                is_crowd, im_info, rpn_batch, use_random,
                                cls_score, bbox_pred, labels, targets,
                                inside, outside))
    elif mode == "detect":
        prob = L.softmax(cls_score)
        pvar = L.elementwise_mul(
            L.fill_constant_batch_size_like(rpn_rois, [-1, 4], "float32",
                                            1.0),
            L.assign(np.asarray(RCNN_REG_WEIGHTS, np.float32)))
        _, boxes = L.box_decoder_and_assign(rpn_rois, pvar, bbox_pred, prob,
                                            box_clip=4.135)
        out["nmsed"] = L.multiclass_nms(
            L.reshape(boxes, [-1, post, 4]),
            L.transpose(L.reshape(prob, [-1, post, class_num]),
                        perm=[0, 2, 1]),
            nms_top_k=-1, background_label=0, normalized=False,
            **RCNN_DET)
    return out


def _rcnn_losses(L, rpn_cls, rpn_bbox, anchor, var, gt_box, is_crowd,
                 im_info, rpn_batch, use_random, cls_score, bbox_pred,
                 labels, targets, inside, outside):
    """model_builder.py's rpn_loss and fast_rcnn_loss over the targets'
    -1-padded rows: the RPN's sigmoid cross entropy (ignore_index -1,
    normalized: a mean over the sampled anchors) and smooth_l1 (sigma 3,
    the inside weights) summed over the sampled anchors' count; the
    head's softmax cross entropy (ignore_index -1) and smooth_l1 (sigma
    1) summed over the sampled RoIs' count. The gathers of the RPN's
    predictions by [R, 1] indices keep a dim: reshaped to [R, 1] and [R,
    4], as retinanet_loss does."""
    cls_t = L.reshape(L.transpose(rpn_cls, perm=[0, 2, 3, 1]), [0, -1, 1])
    box_t = L.reshape(L.transpose(rpn_bbox, perm=[0, 2, 3, 1]), [0, -1, 4])
    score, loc, label, target, weight = L.rpn_target_assign(
        box_t, cls_t, L.reshape(anchor, [-1, 4]), L.reshape(var, [-1, 4]),
        gt_box, is_crowd, im_info, rpn_batch_size_per_im=rpn_batch,
        rpn_straddle_thresh=0.0, rpn_fg_fraction=0.5,
        rpn_positive_overlap=0.7, rpn_negative_overlap=0.3,
        use_random=use_random)
    score = L.reshape(score, [-1, 1])
    loc = L.reshape(loc, [-1, 4])
    zero = L.fill_constant([1], "int32", 0)

    def count(lbl):
        return L.reduce_sum(L.cast(L.greater_equal(lbl, zero), "float32"))
    rpn_cls_loss = L.reduce_sum(L.sigmoid_cross_entropy_with_logits(
        score, L.cast(label, "float32"), ignore_index=-1, normalize=True))
    rpn_reg_loss = L.elementwise_div(L.reduce_sum(L.smooth_l1(
        loc, target, inside_weight=weight, outside_weight=weight,
        sigma=3.0)), count(label))
    n_rois = count(labels)
    cls_loss = L.elementwise_div(L.reduce_sum(L.softmax_with_cross_entropy(
        cls_score, L.cast(labels, "int64"), ignore_index=-1)), n_rois)
    bbox_loss = L.elementwise_div(L.reduce_sum(L.smooth_l1(
        bbox_pred, targets, inside_weight=inside, outside_weight=outside,
        sigma=1.0)), n_rois)
    return {"rpn_cls_loss": rpn_cls_loss,
            "rpn_reg_loss": rpn_reg_loss, "cls_loss": cls_loss,
            "bbox_loss": bbox_loss,
            "loss": L.sum([rpn_cls_loss, rpn_reg_loss, cls_loss,
                           bbox_loss])}


def rcnn_calibrate(pt, main, scope, feed, place):
    """Sets every frozen affine_channel's scale and offset in `scope` so
    that its output has zero mean and unit variance a channel on `feed`
    (a frozen batch norm with that batch's statistics, the form in which
    PaddleCV's pretrained weights carry theirs; random convolutions
    under identity affines grow res4 to ~1e3 and the first steps
    diverge). One forward pass of `main`'s forward ops, op by op through
    their lowerings on `place`: each affine_channel is set from its input
    just before it runs."""
    from paddle_tpu_torch.core.registry import (OPS, ExecContext,
                                                HostTableCache, RunState)
    block = main.global_block()
    ops = [op for op in block.ops if op.attr("op_role", "forward") ==
           "forward"]
    last = max(i for i, op in enumerate(ops) if op.type == "affine_channel")
    dev = place.torch_device()
    env, lods = {}, {}
    for name, v in feed.items():
        env[name] = (v.tensor if hasattr(v, "tensor") else v).to(dev)
        if hasattr(v, "lod") and v.lod():
            lods[name] = v.lod()
    made = set(env)
    for op in ops[:last + 1]:
        for name in op.input_arg_names:
            if name not in made:
                env[name] = scope.find_var(name).get_tensor().tensor
        made.update(op.output_arg_names)
    run = RunState(program_seed=main.random_seed, lod_env=lods,
                   host_tables=HostTableCache())
    with __import__("torch").no_grad():
        for op in ops[:last + 1]:
            if op.type == "affine_channel":
                x = env[op.input("X")[0]]
                mean, std = x.mean((0, 2, 3)), x.std((0, 2, 3))
                scale = 1.0 / (std + 1e-5)
                for slot, value in (("Scale", scale), ("Bias", -mean * scale)):
                    env[op.input(slot)[0]].copy_(value)
            OPS.get(op.type).lowering(ExecContext(op, env, dev, run))


def _rcnn_inputs(L, image):
    """The feeds' vars: image [3, h, w], im_info [3] (h, w, scale), and
    gt_box [4] / gt_label [1] int32 / is_crowd [1] int32 LoD vars."""
    return (L.data("image", [3, image[0], image[1]], dtype="float32"),
            L.data("im_info", [3], dtype="float32"),
            L.data("gt_box", [4], dtype="float32", lod_level=1),
            L.data("gt_label", [1], dtype="int32", lod_level=1),
            L.data("is_crowd", [1], dtype="int32", lod_level=1))


def faster_rcnn_train(pt, image=None, class_num=None, stages=None,
                      width=None, **kw):
    """(main, startup, outs) of PaddleCV's train.py in package `pt`:
    faster_rcnn in training mode (`kw`: its proposals, rpn_batch,
    roi_batch and use_random) minimized by Momentum(0.9) under the
    warm-up and piecewise schedule and L2Decay(RCNN_L2)."""
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img, im_info, gt_box, gt_label, is_crowd = _rcnn_inputs(
            L, image or RCNN["image"])
        outs = faster_rcnn(L, img, im_info, gt_box, gt_label, is_crowd,
                           class_num or RCNN["class_num"],
                           stages or RCNN["stages"], "train",
                           width or RCNN["width"], **kw)
        lr = L.linear_lr_warmup(
            L.piecewise_decay(list(RCNN_LR_STEPS),
                              [RCNN_LR * 0.1 ** i for i in range(3)]),
            RCNN_WARMUP, RCNN_LR / 3, RCNN_LR)
        pt.optimizer.MomentumOptimizer(
            learning_rate=lr, momentum=0.9,
            regularization=pt.regularizer.L2Decay(RCNN_L2)).minimize(
                outs["loss"])
    return main, startup, outs


def faster_rcnn_detect(pt, image=None, class_num=None, stages=None,
                       width=None, mode="detect", **kw):
    """(program, startup, outs) of PaddleCV's eval and infer in package
    `pt`: faster_rcnn in detection mode (its parameters those of the
    trained program, by name): softmax scores, box_decoder_and_assign of
    each proposal's best class (the per-class deltas times
    RCNN_REG_WEIGHTS), multiclass_nms (RCNN_DET, background 0, pixel
    boxes). mode "head": faster_rcnn's head on fed `rois`."""
    L = pt.layers
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        image = image or RCNN["image"]
        img = L.data("image", [3, image[0], image[1]], dtype="float32")
        im_info = L.data("im_info", [3], dtype="float32")
        rois = L.data("rois", [4], dtype="float32", lod_level=1) \
            if mode == "head" else None
        outs = faster_rcnn(L, img, im_info, None, None, None,
                           class_num or RCNN["class_num"],
                           stages or RCNN["stages"], mode,
                           width or RCNN["width"], rois=rois, **kw)
    return prog, startup, outs


def _rcnn_batch(torch, pt, seed, place, B=None, image=None, short=800,
                long_max=1333, class_num=None):
    """A COCO-shaped batch from default_rng(seed): B images on the
    canvas `image` (h, w), each a COCO landscape size resized to a short
    side of `short` (the long side at most long_max), its pixels standard
    normal and the rest of the canvas 0; im_info (h, w, 1.0) an image;
    a geometric number of boxes an image (mean YOLO_OBJECTS, at most
    50) in the resized frame, sides log-uniform in [0.03, 0.8] of the
    image's, labels uniform in [1, class_num), one box in a hundred a
    crowd box and at least one in the batch, crowd boxes first in their
    image; as LoD tensors on `place`."""
    B, image = B or RCNN_B, image or RCNN["image"]
    class_num = class_num or RCNN["class_num"]
    rng = np.random.default_rng(seed)
    img = np.zeros((B, 3) + tuple(image), np.float32)
    info = np.zeros((B, 3), np.float32)
    boxes, labels, crowd, lens = [], [], [], []
    for b in range(B):
        w0, h0 = COCO_LANDSCAPE[rng.integers(len(COCO_LANDSCAPE))]
        s = min(short / h0, long_max / w0)
        h, w = int(round(h0 * s)), int(round(w0 * s))
        info[b] = (h, w, 1.0)
        img[b, :, :h, :w] = rng.standard_normal((3, h, w))
        k = int(np.clip(rng.geometric(1.0 / YOLO_OBJECTS), 1, 50))
        side = np.exp(rng.uniform(np.log(0.03), np.log(0.8), (k, 2))) * \
            np.array([w, h])
        side = np.maximum(side, 2.0)
        xy = rng.uniform(0.0, 1.0, (k, 2)) * (np.array([w, h]) - side)
        boxes.append(np.concatenate([xy, xy + side - 1.0], axis=1))
        labels.append(rng.integers(1, class_num, (k, 1)))
        crowd.append((rng.random((k, 1)) < 0.01).astype(np.int32))
        lens.append(k)
    crowd[int(np.argmax(lens))][-1, 0] = 1
    for b in range(B):
        # crowd boxes first in their image: where one and a non-crowd box
        # pick the same anchor, the JAX lowering's last scatter write is
        # then the non-crowd box's, the reference's rule
        order = np.argsort(-crowd[b][:, 0], kind="stable")
        boxes[b], labels[b], crowd[b] = (boxes[b][order], labels[b][order],
                                         crowd[b][order])
    dev = place.torch_device()
    lod = [lens]
    return {"image": torch.from_numpy(img).to(dev),
            "im_info": torch.from_numpy(info).to(dev),
            "gt_box": pt.create_lod_tensor(
                np.concatenate(boxes).astype(np.float32), lod, place),
            "gt_label": pt.create_lod_tensor(
                np.concatenate(labels).astype(np.int32), lod, place),
            "is_crowd": pt.create_lod_tensor(np.concatenate(crowd), lod,
                                             place)}


# the card against the CPU at B=1, float32 (TF32 off): res4, the RPN's
# outputs and the head's logits on the same RoIs move, relative to the
# largest, by at most the sum over the layers of a random walk of sqrt(K)
# units of 2^-24: 50 layers on the longest path (conv1, three convs a
# bottleneck of res2-res5's 16, the fc), K at most 9216 (the RPN's 3 x 3
# x 1024)
RCNN_RTOL = 50 * 9216 ** 0.5 * 2.0 ** -24           # 2.86e-4
# the discrete ops on the card's inputs, card against CPU: libm's exp
# (the decode) moves a box by a few units in the last place, and may
# flip a near-tie of the sort or the NMS; a row more than RCNN_ROW_MOVE
# pixels from the CPU's is another row chosen, and a share of those
# above RCNN_ROWS_SHARE is a fault
RCNN_ROW_MOVE = 1e-2
RCNN_ROWS_SHARE = 0.05
RCNN_ROWS_ATOL = 1e-6     # detection rows, the predictor against Executor
RCNN_TIMED = 3            # detection passes timed a mode
RCNN_ALONE_ITERS = 3      # calls a timing of an op alone


def _rcnn_check_cpu(torch, pt, main, outs, state):
    """The first step's forward at B=1 (batch seed 1) from `state` on the
    card and on the CPU: res4 and the RPN's logits and deltas within
    RCNN_RTOL of the largest; the head's scores and deltas on the card's
    sampled RoIs (faster_rcnn_detect's head program, fed them) within
    RCNN_RTOL; then generate_proposals on the card's Scores, deltas and
    anchors, and rpn_target_assign and generate_proposal_labels
    (use_random=False) on the card's RpnRois, each run on the card and
    on the CPU: the rows that differ."""
    from paddle_tpu_torch.ops import family_cases as fc
    t0 = time.perf_counter()
    card_f = _rcnn_batch(torch, pt, 1, pt.CUDAPlace(0), B=1)
    cpu_f = _rcnn_batch(torch, pt, 1, pt.CPUPlace(), B=1)
    block = main.global_block()
    ops = {op.type: op for op in block.ops}
    gp, ra, pl = (ops["generate_proposals"], ops["rpn_target_assign"],
                  ops["generate_proposal_labels"])
    gp_in = {s: block.var(gp.input(s)[0]) for s in
             ("Scores", "BboxDeltas", "ImInfo", "Anchors", "Variances")}
    dense = [outs["res4"], outs["rpn_cls"], outs["rpn_bbox"]]
    fetch = dense + list(gp_in.values()) + [outs["rpn_rois"], outs["rois"]]
    card = _train_mode_forward(pt, main, fetch, state, card_f,
                               pt.CUDAPlace(0))
    cpu = _train_mode_forward(pt, main, dense, state, cpu_f)
    errs = [float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip(card[:3], cpu)]
    print(f"  faster_rcnn: B=1 card against CPU, max |card - CPU| / max "
          f"|CPU|: res4 {errs[0]:.3e}, RPN logits {errs[1]:.3e}, RPN "
          f"deltas {errs[2]:.3e} (bound RCNN_RTOL {RCNN_RTOL:.3e}); "
          f"{time.perf_counter() - t0:.1f} s")
    _require(max(errs) <= RCNN_RTOL and
             all(np.isfinite(a).all() for a in card[:3]),
             "faster_rcnn: res4 or the RPN, card and CPU disagree")
    # the head on the card's RoIs
    t1 = time.perf_counter()
    pt.framework.unique_name.reset()
    head, _, hout = faster_rcnn_detect(pt, mode="head")
    rois = card[-1]
    lod = [[len(rois)]]
    hfeed = {"image": card_f["image"], "im_info": card_f["im_info"],
             "rois": pt.create_lod_tensor(rois, lod, pt.CUDAPlace(0))}
    hfetch = [hout["cls_score"], hout["bbox_pred"]]
    hcard = _train_mode_forward(pt, head, hfetch, state, hfeed,
                                pt.CUDAPlace(0))
    hcpu = _train_mode_forward(pt, head, hfetch, state, {
        "image": cpu_f["image"], "im_info": cpu_f["im_info"],
        "rois": pt.create_lod_tensor(rois, lod, pt.CPUPlace())})
    herrs = [float(np.abs(a - b).max() / np.abs(b).max())
             for a, b in zip(hcard, hcpu)]
    print(f"  faster_rcnn: the head on the card's {len(rois)} sampled RoIs, "
          f"max |card - CPU| / max |CPU|: scores {herrs[0]:.3e}, deltas "
          f"{herrs[1]:.3e} (bound {RCNN_RTOL:.3e}); "
          f"{time.perf_counter() - t1:.1f} s")
    _require(max(herrs) <= RCNN_RTOL and
             all(np.isfinite(a).all() for a in hcard),
             "faster_rcnn: the head, card and CPU disagree")
    # the discrete ops on the card's inputs
    rpn_rois = card[-2]
    gt = {"GtBoxes": np.asarray(cpu_f["gt_box"]),
          "IsCrowd": np.asarray(cpu_f["is_crowd"]),
          "ImInfo": cpu_f["im_info"].numpy()}
    gt_lod = cpu_f["gt_box"].lod()
    runs = [
        ("generate_proposals", dict(zip(gp_in, card[3:8])), {},
         gp.all_attrs(), {"RpnRois": 1, "RpnRoiProbs": 1}, "rpnrois_out0"),
        ("rpn_target_assign", dict(gt, Anchor=card[6]),
         {"gtboxes": gt_lod}, dict(ra.all_attrs(), use_random=False),
         {"LocationIndex": 1, "ScoreIndex": 1, "TargetLabel": 1,
          "TargetBBox": 1, "BBoxInsideWeight": 1}, "scoreindex_out0"),
        ("generate_proposal_labels",
         dict(gt, RpnRois=rpn_rois, GtClasses=np.asarray(cpu_f["gt_label"])),
         {"rpnrois": [[0, len(rpn_rois)]], "gtboxes": gt_lod,
          "gtclasses": gt_lod, "iscrowd": gt_lod},
         dict(pl.all_attrs(), use_random=False),
         {"Rois": 1, "LabelsInt32": 1, "BboxTargets": 1,
          "BboxInsideWeights": 1, "BboxOutsideWeights": 1}, "rois_out0")]
    for op_type, ins, lods, attrs, slots, key in runs:
        a, _ = fc.run(op_type, ins, attrs, slots, "cuda", lods)
        b, _ = fc.run(op_type, ins, attrs, slots, "cpu", lods)
        x, y = a[key].cpu().numpy(), b[key].numpy()
        gap = np.abs(x.astype(np.float64) - y).reshape(len(x), -1).max(1)
        moved = int((gap > RCNN_ROW_MOVE).sum())
        print(f"  faster_rcnn: {op_type} on the card's inputs, card against "
              f"CPU: of {len(x)} rows of {key.split('_')[0]}, "
              f"{int((gap > 0).sum())} not bit-equal, {moved} apart by more "
              f"than {RCNN_ROW_MOVE} (another row chosen)")
        _require(moved <= RCNN_ROWS_SHARE * len(x),
                 f"faster_rcnn: {op_type}'s rows, card and CPU differ")


def _lowering_call(op_type, env, ins, outs, attrs, device, lods=None):
    """A call of op `op_type`'s lowering on `env` (input slot -> names in
    `ins`, outputs to the names in `outs`), with one host-table cache
    for all calls (made at the first: a later call, and a CUDA graph
    captured from one, copies nothing to the card)."""
    from paddle_tpu_torch.core.registry import (OPS, ExecContext,
                                                HostTableCache, RunState,
                                                _SlotView)
    view = _SlotView(op_type, ins, outs, attrs)
    run = RunState(host_tables=HostTableCache())

    def call():
        OPS.get(op_type).lowering(ExecContext(view, env, device, run,
                                              dict(lods or {})))
        return env
    return call


def _rcnn_roi_align_alone(torch, res4, rois, lod):
    """roi_align at the step's shapes alone, forward (recording for
    autograd) and backward (the generic gradient: torch's reverse mode
    through the lowering): device ms a call (_timed_parts) by default
    and in deterministic mode (the backward's accumulate then sorts its
    rows), and the peak bytes of a forward and backward beyond their
    inputs. Returns ({part: ms}, {part: ms deterministic}, peak)."""
    x = res4.detach().clone().requires_grad_(True)
    env = {"x": x, "rois": rois}
    call = _lowering_call(
        "roi_align", env, {"X": ["x"], "ROIs": ["rois"]}, {"Out": ["out"]},
        {"pooled_height": 14, "pooled_width": 14,
         "spatial_scale": 1.0 / RCNN_STRIDE, "sampling_ratio": 0},
        x.device, {"rois": lod})

    def forward():
        return call()["out"]

    out = forward()
    g = torch.ones_like(out)
    torch.autograd.backward(out, g)
    del out
    x.grad = None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = forward()
    torch.autograd.backward(out, g)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = []
    for mode in (contextlib.nullcontext(), _deterministic(torch)):
        with mode:
            out = forward()
            ms.append(_timed_parts(torch, {
                "forward": forward,
                "backward": lambda: torch.autograd.backward(
                    out, g, retain_graph=True)}, RCNN_ALONE_ITERS)[0])
    return ms[0], ms[1], peak


def _rcnn_nms_alone(torch, inputs, attrs):
    """generate_proposals on the step's inputs (`inputs`: slot -> card
    tensor) alone, and its greedy NMS loop alone on a mask of the same
    [N, K, K] shape: each captured as one CUDA graph, its kernel nodes
    counted (_graph_kernels) and its replays timed by CUDA events (device
    ms a call)."""
    from paddle_tpu_torch.ops import detection as det
    dev = inputs["Scores"].device
    env = {s.lower(): v for s, v in inputs.items()}
    whole = _lowering_call("generate_proposals", env,
                           {s: [s.lower()] for s in inputs},
                           {"RpnRois": ["rois"], "RpnRoiProbs": ["probs"]},
                           attrs, dev)
    n = inputs["Scores"].shape[0]
    k = min(attrs["pre_nms_topN"], inputs["Scores"][0].numel())
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    boxes = torch.rand((n, k, 4), generator=gen, device=dev) * 600
    boxes[..., 2:] += boxes[..., :2]
    thr = torch.full((k,), attrs["nms_thresh"], device=dev)
    over = det._over_rows(boxes, thr, False)
    keep = torch.ones((n, k), dtype=torch.bool, device=dev)

    def loop():
        keep.fill_(True)
        det._greedy_keep(over, keep)
    out = {}
    for name, fn in (("generate_proposals", whole), ("its greedy loop", loop)):
        fn()
        torch.cuda.synchronize()
        kernels = len(_graph_kernels(torch, fn))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(RCNN_ALONE_ITERS):
            graph.replay()
        b.record()
        torch.cuda.synchronize()
        out[name] = (kernels, a.elapsed_time(b) / RCNN_ALONE_ITERS)
        del graph
    return out


def _rcnn_train(torch, pt, kreg, dev):
    """Faster R-CNN trained captured against eager: returns (the trained
    scope, the feed)."""
    t0 = time.perf_counter()
    pt.framework.unique_name.reset()
    main, startup, outs = faster_rcnn_train(pt)
    main.random_seed = startup.random_seed = SEED
    block = main.global_block()
    types = [op.type for op in block.ops]
    params = main.all_parameters()
    stages = RCNN["stages"]
    print(f"  faster_rcnn: {len(types)} ops in block 0 "
          f"({types.count('conv2d')} conv2d, "
          f"{types.count('affine_channel')} affine_channel, "
          f"{types.count('momentum')} momentum, roi_align and its grad, "
          f"generate_proposals, rpn_target_assign, "
          f"generate_proposal_labels); {len(params)} parameters, "
          f"{sum(int(np.prod(p.shape)) for p in params)} elements; "
          f"{RCNN['image'][0]}x{RCNN['image'][1]}, B={RCNN_B}")
    # conv1, three convs a bottleneck and a projection a stage, the RPN's
    # three
    _require(types.count("conv2d") == 1 + 3 * sum(stages) + 4 + 3 and
             types.count("roi_align_grad") == 1 and
             tuple(outs["res4"].shape[1:2]) == (16 * RCNN["width"],),
             "faster_rcnn: the network")
    init = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init)
    t1 = time.perf_counter()
    rcnn_calibrate(pt, main, init, _rcnn_batch(
        torch, pt, RCNN_CALIBRATION_SEED, pt.CUDAPlace(0)), pt.CUDAPlace(0))
    torch.cuda.synchronize()
    print(f"  faster_rcnn: the frozen affine_channels calibrated on batch "
          f"{RCNN_CALIBRATION_SEED} in {time.perf_counter() - t1:.1f} s")
    cpu_state = {n: v.get_tensor().tensor.to("cpu", copy=True)
                 for n, v in init._vars.items()}
    feed = _rcnn_batch(torch, pt, 0, pt.CUDAPlace(0))
    lens = np.diff(feed["gt_box"].lod()[0]).tolist()
    print(f"  batch: {RCNN_B} images, im_info "
          f"{feed['im_info'].cpu().numpy()[:, :2].astype(int).tolist()}, "
          f"{sum(lens)} gt boxes ({lens} an image), "
          f"{int(np.asarray(feed['is_crowd']).sum())} crowd")
    ra = [op for op in block.ops if op.type == "rpn_target_assign"][0]
    score_index = block.var(ra.output("ScoreIndex")[0])
    fetch = [outs["loss"], score_index, outs["rois"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    exe, scope, losses, reasons, _ = _seq_compare(
        torch, pt, kreg, "faster_rcnn", main, fetch, init, [feed],
        RCNN_RUNS)
    _require(not reasons,
             f"faster_rcnn: the block was kept eager: {reasons}")
    _rcnn_check_cpu(torch, pt, main, outs, cpu_state)
    # the plan of [loss] alone: its first run eager, its second captures
    _cap_run(exe, main, feed, [outs["loss"]], scope)
    with _capture_clock() as clock:
        c0 = _counters(exe)
        t1 = time.perf_counter()
        _cap_run(exe, main, feed, [outs["loss"]], scope)
        secs = time.perf_counter() - t1
    print(f"  faster_rcnn: {_counters(exe)['captures'] - c0['captures']} "
          f"capture outside deterministic mode, {secs:.3f} s for the run: "
          f"the capture rule {clock['rule']:.3f} s, warm-up "
          f"{clock['warm_up']:.3f} s, capture {clock['capture']:.3f} s")
    rates = _cap_turns(torch, "faster_rcnn", "images/s", RCNN_B, {
        "eager": lambda: _cap_run(exe, main, feed, [outs["loss"]], scope,
                                  cached=False, numpy=False)[0],
        "captured": lambda: _cap_run(exe, main, feed, [outs["loss"]], scope,
                                     numpy=False)[0]})
    print(f"  faster_rcnn: captured / eager "
          f"{rates['captured'] / rates['eager']:.3f}")
    print(f"  faster_rcnn: peak memory allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; graph pools "
          f"{_graph_pool_gb(torch)[0]:.3f} GB allocated")
    gp = [op for op in block.ops if op.type == "generate_proposals"][0]
    slots = ("Scores", "BboxDeltas", "ImInfo", "Anchors", "Variances")
    got = exe.run(main, feed=feed, fetch_list=[gp.input(s)[0] for s in slots]
                  + [outs["res4"].name, outs["rois"].name], scope=scope,
                  use_program_cache=False, return_numpy=False)
    tensors = [v.tensor if hasattr(v, "tensor") else v for v in got]
    nms = _rcnn_nms_alone(torch, dict(zip(slots, tensors[:5])),
                          gp.all_attrs())
    roi_ms, roi_det, roi_peak = _rcnn_roi_align_alone(
        torch, tensors[5], tensors[6], got[6].lod())
    del got, tensors
    gc_cuda(torch)
    c0 = _counters(exe)
    wall, busy, n_kernels, top = _seq_profile(torch, lambda: _cap_run(
        exe, main, feed, [outs["loss"]], scope, numpy=False))
    _require(_counters(exe)["replays"] == c0["replays"] + 1,
             "faster_rcnn: the profiled run was no replay")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    _cap_run(exe, main, feed, [outs["loss"]], scope, numpy=False)
    b.record()
    torch.cuda.synchronize()
    replay_ms = a.elapsed_time(b)
    busy_ms = 1e3 * wall * busy
    print(f"  faster_rcnn: profiled replay: wall {wall:.4f} s, device busy "
          f"{100 * busy:.1f} % ({busy_ms:.3f} ms), {n_kernels} kernels "
          f"seen by the profiler; a replay between CUDA events "
          f"{replay_ms:.3f} ms")
    for e in top:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<6d} {e.key[:90]}")
    for name, (kernels, ms) in nms.items():
        print(f"  faster_rcnn: {name} alone at the step's shapes "
              f"({RCNN_PROPOSALS['train'][0]} candidates an image, {RCNN_B} "
              f"images): {kernels} kernels, {ms:.3f} ms a captured call, "
              f"{100 * ms / replay_ms:.1f} % of a replay's {replay_ms:.3f} ms")
    print(f"  faster_rcnn: roi_align alone (14x14 of {RCNN_B * RCNN_ROI_BATCH}"
          f" RoIs on res4 {list(outs['res4'].shape[1:])}): forward "
          f"{roi_ms['forward']:.3f} ms, backward {roi_ms['backward']:.3f} ms "
          f"a call (CUDA events); in deterministic mode "
          f"{roi_det['forward']:.3f} / {roi_det['backward']:.3f} ms; peak "
          f"{roi_peak / 1e9:.3f} GB beyond its inputs")
    exe.close()
    print(f"  faster_rcnn training: {time.perf_counter() - t0:.1f} s")
    return scope, feed


def _rcnn_detect(torch, pt, scope, batch):
    """The detection program on the trained parameters through
    Executor.run (eager, captured, replays) and AnalysisPredictor, in
    deterministic mode: rows equal; images/s eager against captured;
    multiclass_nms's device time alone and its share of a replay."""
    import tempfile
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    t0 = time.perf_counter()
    pt.framework.unique_name.reset()
    prog, _, outs = faster_rcnn_detect(pt)
    nmsed = outs["nmsed"]
    feed = {"image": batch["image"], "im_info": batch["im_info"]}
    exe = pt.Executor(pt.CUDAPlace(0))
    rows = []
    with _deterministic(torch):
        for cached in (False, True, True, True):
            rows.append(_det_rows(_cap_run(exe, prog, feed, [nmsed], scope,
                                           cached)[0]))
    c = _counters(exe)
    eq = all(np.array_equal(r[0], rows[0][0]) and r[1] == rows[0][1]
             for r in rows)
    det, lod = rows[0]
    kept = det[det[:, 0] >= 0]
    print(f"  faster_rcnn detect: {len(prog.global_block().ops)} ops; rows "
          f"{list(det.shape)}, LoD {lod}; {len(kept)} detections; eager, "
          f"captured and replayed rows equal {eq}; counters {c}; eager "
          f"reasons {list(exe._engine.eager_reasons.values()) or 'none'}")
    _require(eq and c["captures"] == 1 and c["replays"] == 2 and
             det.shape == (RCNN_B * RCNN_DET["keep_top_k"], 6) and
             np.isfinite(det).all(), "faster_rcnn detect: the rows")
    with tempfile.TemporaryDirectory() as d:
        with pt.scope_guard(scope):
            pt.io.save_inference_model(d, ["image", "im_info"], [nmsed],
                                       exe, main_program=prog)
        predictor = create_paddle_predictor(AnalysisConfig(d))
    host = {k: np.asarray(v.cpu()) for k, v in feed.items()}
    with _deterministic(torch):
        for _ in range(3):
            for k, v in host.items():
                predictor.get_input_tensor(k).copy_from_cpu(v)
            predictor.zero_copy_run()
    ot = predictor.get_output_tensor(predictor.get_output_names()[0])
    prow = ot.copy_to_cpu()
    worst = float(np.abs(prow - det).max())
    pc = dict(predictor._engine.counters)
    print(f"  faster_rcnn detect serving: AnalysisPredictor rows "
          f"{list(prow.shape)}, LoD {ot.lod() == lod}, max |predictor - "
          f"Executor| {worst:.3e} (bound {RCNN_ROWS_ATOL:g}); counters "
          f"captures {pc['captures']}, replays {pc['replays']}")
    _require(worst <= RCNN_ROWS_ATOL and ot.lod() == lod and
             pc["captures"] == 1, "faster_rcnn detect: the predictor's rows")
    del predictor, ot       # its graph's pool
    gc_cuda(torch)
    for _ in range(2):
        _cap_run(exe, prog, feed, [nmsed], scope, numpy=False)
    secs = {"eager": [], "captured": []}
    for turn in range(2):
        for m in (("eager", "captured") if turn == 0 else
                  ("captured", "eager")):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(RCNN_TIMED):
                _cap_run(exe, prog, feed, [nmsed], scope, m == "captured",
                         numpy=False)
            torch.cuda.synchronize()
            secs[m].append(time.perf_counter() - t1)
    n_img = RCNN_B * RCNN_TIMED
    for m, v in secs.items():
        print(f"  faster_rcnn detect {m}: s a pass of {n_img} images "
              f"{', '.join(f'{x:.3f}' for x in v)}: "
              f"{n_img / float(np.median(v)):.2f} images/s")
    wall, busy, _ = _profiled_replay(torch, "faster_rcnn detect", exe, prog,
                                     feed, [nmsed], scope)
    nms = _nms_alone(torch, pt, scope, prog, feed,
                     label="faster_rcnn multiclass_nms")
    print(f"  faster_rcnn detect: multiclass_nms alone takes "
          f"{1e3 * nms['device']:.3f} ms of device time captured, "
          f"{100 * nms['device'] / (wall * busy):.1f} % of a captured "
          f"detection run's {1e3 * wall * busy:.3f} ms")
    exe.close()
    print(f"  faster_rcnn detection: {time.perf_counter() - t0:.1f} s")


def rcnn_phase(torch, dev):
    """Faster R-CNN (faster_rcnn: ResNet-50-C4, the RPN, roi_align, res5)
    at COCO's 800x1344 canvas and 81 classes, float32, B=2: Momentum
    (warm-up, piecewise decay, L2Decay) trained RCNN_RUNS steps captured
    against eager bit for bit (losses, parameters, the sampled ScoreIndex
    and RoIs), the first step at B=1 against the CPU (dense outputs
    within RCNN_RTOL, the discrete ops' rows on the card's inputs),
    images/s eager against captured in turns, the capture clocked, peak
    memory, a profiled replay, generate_proposals and its greedy NMS
    loop alone (kernels, device ms, share of a replay), roi_align alone
    (forward, backward, peak bytes); then the detection program through
    Executor.run and AnalysisPredictor, its images/s and multiclass_nms's
    device time. No kernel of the port lies on this path."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    t0 = time.perf_counter()
    scope, batch = _rcnn_train(torch, pt, kreg, dev)
    _rcnn_detect(torch, pt, scope, batch)
    del scope, batch
    gc_cuda(torch)
    print(f"  rcnn phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# OCR: CRNN-CTC (PaddleCV ocr_recognition, crnn_ctc_model.py)
# ---------------------------------------------------------------------------

OCR = {"image": (48, 512), "num_classes": 95, "rnn_hidden": 200,
       "widths": (16, 32, 64, 128)}
OCR_B = 32            # train.py's batch
OCR_RUNS = 8          # steps of one batch, captured against eager
OCR_LR, OCR_MOMENTUM, OCR_L2 = 1e-3, 0.9, 4e-4
OCR_LABEL_LEN = (4, 20)   # characters a label
OCR_STREAM = 4        # batches of distinct label LoDs in the stream
OCR_EVAL_STEPS = 4    # steps of the program with the evaluator, timed
OCR_ALONE_ITERS = 5   # calls a timing of warpctc or a GRU alone


def crnn_ctc(L, images, label=None, num_classes=95, rnn_hidden=200,
             widths=(16, 32, 64, 128), mode="train"):
    """PaddleCV's CRNN-CTC (crnn_ctc_model.py: ocr_convs, conv_bn_pool,
    encoder_net, ctc_train_net) built with the layers module `L` (the
    port's or the JAX package's): four conv_bn_pool groups of two 3x3
    convs (padding 1, no bias) of `widths` channels, each followed by
    batch_norm(act="relu"), the first three groups ending in a 2x2 max
    pool of stride 2 with ceil_mode; im2sequence with a filter of the
    map's height and width 1 (one row a column); two fcs of 3 x
    rnn_hidden (no bias) feeding a forward and a reverse dynamic_gru
    (candidate_activation relu); fc([forward, reverse], num_classes + 1).
    Every parameter has L2Decay(OCR_L2); the convs of the first group are
    Normal(0, 0.0005), the other convs and the batch norms' scales
    Normal(0, 0.01), the fc and GRU weights and the GRU biases (learning
    rate 2.0) Normal(0, 0.02), the output fc's bias and the batch norms'
    shifts Normal(0, 0). mode "train": warpctc(blank=num_classes,
    norm_by_times=True) on the int32 LoD `label`, reduce_sum; "eval":
    that and ctc_greedy_decoder; "decode": batch norm in inference mode
    and ctc_greedy_decoder alone. Returns {"fc_out", and "cost", "loss"
    and "decoded" where the mode makes them}."""
    import importlib
    pkg = importlib.import_module(L.__name__.rpartition(".")[0])
    decay = pkg.regularizer.L2Decay(OCR_L2)

    def attr(std, lr=1.0):
        return pkg.ParamAttr(initializer=pkg.initializer.Normal(0.0, std),
                             regularizer=decay, learning_rate=lr)

    x = images
    for g, ch in enumerate(widths):
        for _ in range(2):
            x = L.conv2d(x, ch, 3, padding=1, act=None, bias_attr=False,
                         param_attr=attr(0.0005 if g == 0 else 0.01))
            x = L.batch_norm(x, act="relu", is_test=mode == "decode",
                             param_attr=attr(0.01), bias_attr=attr(0.0))
        if g < len(widths) - 1:
            x = L.pool2d(x, pool_size=2, pool_type="max", pool_stride=2,
                         ceil_mode=True)
    seq = L.im2sequence(x, filter_size=[x.shape[2], 1], stride=[1, 1])
    projs = [L.fc(seq, 3 * rnn_hidden, param_attr=attr(0.02),
                  bias_attr=False) for _ in range(2)]
    grus = [L.dynamic_gru(proj, rnn_hidden, is_reverse=reverse,
                          param_attr=attr(0.02), bias_attr=attr(0.02, 2.0),
                          candidate_activation="relu")
            for proj, reverse in zip(projs, (False, True))]
    fc_out = L.fc(grus, num_classes + 1, param_attr=attr(0.02),
                  bias_attr=attr(0.0))
    outs = {"fc_out": fc_out}
    if mode != "decode":
        outs["cost"] = L.warpctc(fc_out, label, blank=num_classes,
                                 norm_by_times=True)
        outs["loss"] = L.reduce_sum(outs["cost"])
    if mode != "train":
        outs["decoded"] = L.ctc_greedy_decoder(fc_out, blank=num_classes)
    return outs


def crnn_ctc_train(pt, evaluate=False, image=None, **size):
    """(main, startup, outs) of PaddleCV's train.py in package `pt`:
    crnn_ctc on a `pixel` [1, h, w] feed and an int32 `label` LoD feed,
    minimized by Momentum(OCR_LR, OCR_MOMENTUM). With `evaluate`, as
    ctc_train_net builds it: ctc_greedy_decoder and the EditDistance
    evaluator against the label cast to int64 too (outs["evaluator"]),
    before the backward."""
    import warnings
    L = pt.layers
    image = image or OCR["image"]
    size = {k: size.get(k, OCR[k]) for k in ("num_classes", "rnn_hidden",
                                             "widths")}
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = L.data("pixel", [1, image[0], image[1]], dtype="float32")
        label = L.data("label", [1], dtype="int32", lod_level=1)
        outs = crnn_ctc(L, img, label, mode="eval" if evaluate else "train",
                        **size)
        if evaluate:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # deprecated
                outs["evaluator"] = pt.evaluator.EditDistance(
                    outs["decoded"], L.cast(label, "int64"))
        pt.optimizer.Momentum(learning_rate=OCR_LR,
                              momentum=OCR_MOMENTUM).minimize(outs["loss"])
    return main, startup, outs


def crnn_ctc_decode(pt, image=None, **size):
    """(program, startup, outs) of PaddleCV's infer.py in package `pt`:
    crnn_ctc in decode mode on a `pixel` feed; its parameters those of
    the trained program, by name (built after unique_name.reset())."""
    L = pt.layers
    image = image or OCR["image"]
    size = {k: size.get(k, OCR[k]) for k in ("num_classes", "rnn_hidden",
                                             "widths")}
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        img = L.data("pixel", [1, image[0], image[1]], dtype="float32")
        outs = crnn_ctc(L, img, mode="decode", **size)
    return prog, startup, outs


def ocr_batch(torch, pt, seed, place, B=None, image=None, num_classes=None):
    """An OCR-shaped batch from default_rng(seed): B grayscale images of
    `image` (h, w), uniform 8-bit pixels less 127.5 as data_reader.py
    makes them, [B, 1, h, w] float32 on `place`; labels of
    OCR_LABEL_LEN (lo, hi) characters an image, ids uniform in [0, num_classes), the
    first label's second character a repeat of its first ("aa": the
    skip rule matters), as an int32 LoD tensor on `place`."""
    B = B or OCR_B
    image = image or OCR["image"]
    num_classes = num_classes or OCR["num_classes"]
    lo, hi = OCR_LABEL_LEN
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, 256, (B, 1) + tuple(image)) - 127.5).astype(
        np.float32)
    lens = rng.integers(lo, hi + 1, B)
    ids = rng.integers(0, num_classes, (int(lens.sum()), 1)).astype(np.int32)
    ids[1] = ids[0]
    return {"pixel": torch.from_numpy(img).to(place.torch_device()),
            "label": pt.create_lod_tensor(ids, [lens.tolist()], place)}


# the first step at B=32, card against CPU: float32 convolutions (TF32
# off), batch statistics and products summed in other orders. fc_out
# moves, relative to its largest, by at most the sum over the layers of
# a random walk of sqrt(K) units of 2^-24: the 8 convs (K at most 3 x 3
# x 128), their 8 batch norms (means over at most B x 48 x 512), the
# 768-wide projection, 64 GRU steps (K 200) and the output fc (K 400)
OCR_RTOL = (8 * 1152 ** 0.5 + 8 * (32 * 48 * 512) ** 0.5 + 768 ** 0.5 +
            64 * 200 ** 0.5 + 400 ** 0.5) * 2.0 ** -24       # 4.96e-4
# a loss over T (norm_by_times) has the gradient (softmax - posterior) /
# T in each row of its logits, of L1 norm at most 2 / T: it moves by at
# most 2 x the logits' largest move, plus its recursion's own rounding
# (3 logaddexp a step over 64 steps)
OCR_LOSS_ULPS = 3 * 64


def _ocr_state_run(pt, main, fetch, state, feed, place):
    """The fetches of one run of `main` (a step) from `state` (name ->
    CPU tensor) on `feed` on `place`, as numpy arrays (LoD fetches with
    their LoD)."""
    scope = pt.Scope()
    dev = place.torch_device()
    for n, t in state.items():
        scope.var(n).get_tensor().set_tensor(t.to(dev, copy=True))
    got = pt.Executor(place).run(main, feed=feed, fetch_list=fetch,
                                 scope=scope, use_program_cache=False,
                                 return_numpy=False)
    return [(np.asarray((v.tensor if hasattr(v, "tensor") else v).cpu()),
             v.lod() if hasattr(v, "lod") else None) for v in got]


def _ocr_grad_ratios(card, cpu, T, dz, dh):
    """|card - CPU| over its bound, the largest: for each image of the
    CTC gradient (fc_out's), and for the last fc's gradients (its two
    weights, its bias). `card`, `cpu`: dicts of numpy arrays (`cost`
    [B], `g` [B*T, C], `h` the fc's two inputs, `dw` their weights'
    gradients, `db`); dz, dh: the measured largest moves of fc_out and
    of each h. The bounds:

    a row of the CTC gradient is (softmax - posterior) / T. The softmax
    moves by at most 2 dz. A posterior is exp(alpha + beta - log Z):
    alpha, beta and log Z each walk T steps whose inputs (log softmax)
    move by 2 dz and whose sums round at the size of log Z (T x the
    image's loss), so it moves, relative, by a random walk of 3T such
    steps. The weights' gradients are h^T g (plus the decay, equal on
    both): they move by dh x sum |g| + |h|^T (g's bound), plus the sum's
    rounding, a random walk over the rows; the bias's by the sum of g's
    bounds. Returns ([B] ratios, [3] ratios)."""
    def ratio(diff, bound):           # 0 where equal, inf past a 0 bound
        with np.errstate(divide="ignore"):
            return np.divide(diff, bound, out=np.zeros(diff.shape),
                             where=diff > 0)
    u = 2.0 ** -24
    g = cpu["g"]
    B = cpu["cost"].size
    log_z = T * np.abs(cpu["cost"].reshape(B).astype(np.float64))
    walk = np.sqrt(3 * T) * (2 * dz + 3 * u * log_z)
    d = np.repeat((2 * dz + walk) / T, T)[:, None] + u * np.abs(g)
    per_image = ratio(np.abs(card["g"] - g), d).reshape(B, -1).max(1)
    rows = np.sqrt(g.shape[0]) * u
    fc = []
    for h, dh_i, wa, wb in zip(cpu["h"], dh, card["dw"], cpu["dw"]):
        ah = np.abs(h).astype(np.float64).T
        bound = (dh_i * np.abs(g).sum(0)[None, :] + ah @ d +
                 rows * (ah @ np.abs(g)) + u * np.abs(wb))
        fc.append(float(ratio(np.abs(wa - wb), bound).max()))
    bound = d.sum(0) + rows * np.abs(g).sum(0) + u * np.abs(cpu["db"])
    fc.append(float(ratio(np.abs(card["db"] - cpu["db"]), bound).max()))
    return per_image, fc


def _ocr_aligned(fc_out, label, blank):
    """fc_out with a large one-hot added along a feasible alignment of
    each image: images 0, 3, 6, ... spell their label, images 1, 4, 7,
    ... their label with its first character changed and its last
    dropped (each character on two columns, or one where T is short,
    then one blank column; blank to the end); images 2, 5, 8, ... keep
    the net's own columns. Returns (fc_out, {image: its label} of the
    first kind, [images] of the second)."""
    lod = label.lod()[0]
    ids = np.asarray(label).reshape(-1)
    B = len(lod) - 1
    T = fc_out.shape[0] // B
    out = fc_out.copy()
    big = 1.0 + 2.0 * float(np.abs(fc_out).max())
    want, changed = {}, []
    for b in range(B):
        row = ids[lod[b]:lod[b + 1]].tolist()
        if b % 3 == 2:
            continue
        if b % 3 == 1:
            row = [(row[0] + 1) % blank] + row[1:-1]
        k = 2 if 3 * len(row) <= T else 1
        if (k + 1) * len(row) > T:
            continue
        cols = [c for ch in row for c in [ch] * k + [blank]]
        cols += [blank] * (T - len(cols))
        out[b * T + np.arange(T), cols] += big
        if b % 3 == 0:
            want[b] = row
        else:
            changed.append(b)
    return out, want, changed


def _ocr_decode_ops(torch, pt, fc_out, label, device):
    """top_k(k=1), ctc_align and edit_distance (the decoder and the
    EditDistance evaluator's op) on fc_out with its images' LoD, on
    `device`: (rows, their LoD, distances)."""
    from paddle_tpu_torch.ops import family_cases as fc
    B = len(label.lod()[0]) - 1
    T = fc_out.shape[0] // B
    lod = {"x": [list(range(0, B * T + 1, T))]}
    idx, ilod = fc.run("top_k", {"X": fc_out}, {"k": 1},
                       {"Out": 1, "Indices": 1}, device, lod)
    ids = idx["indices_out0"].cpu().numpy()
    rows, rlod = fc.run("ctc_align", {"Input": ids},
                        {"blank": OCR["num_classes"]}, {"Output": 1}, device,
                        {"input": ilod["indices_out0"]})
    hyps = rows["output_out0"].cpu().numpy().astype(np.int64)
    dist, _ = fc.run("edit_distance", {
        "Hyps": hyps, "Refs": np.asarray(label).astype(np.int64)},
        {"normalized": True}, {"Out": 1, "SequenceNum": 1}, device,
        {"hyps": rlod["output_out0"], "refs": label.lod()})
    return (hyps, rlod["output_out0"],
            dist["out_out0"].cpu().numpy().reshape(-1))


def _ocr_check_cpu(torch, pt, main, outs, state):
    """The first step from `state` on the card and on the CPU (batch 0):
    fc_out within OCR_RTOL of its largest, each image's loss within 2 x
    OCR_RTOL x max |fc_out| plus OCR_LOSS_ULPS of itself, the CTC
    gradient of each image and the last fc's gradients within the
    bounds of _ocr_grad_ratios; the same bounds must reject the card's
    reading with the longest label's loss dropped (a planted fault).
    Then the card's fc_out, aligned to spell the labels (_ocr_aligned),
    through the decoder and edit_distance on the card and on the CPU:
    the rows, their LoD and the distances equal, the spelt images decoded
    to their labels at distance 0, the changed ones at a distance."""
    t0 = time.perf_counter()
    card_f = ocr_batch(torch, pt, 0, pt.CUDAPlace(0))
    cpu_f = ocr_batch(torch, pt, 0, pt.CPUPlace())
    block = main.global_block()
    last = main.all_parameters()[-3:]        # the output fc's W, W, bias
    hs = [next(op.input("X")[0] for op in block.ops
               if op.type == "mul" and op.input("Y") == [p.name])
          for p in last[:2]]
    fetch = ([outs["fc_out"], outs["cost"],
              block.var(outs["fc_out"].name + "@GRAD")] +
             [block.var(p.name + "@GRAD") for p in last] +
             [block.var(h) for h in hs])
    card = [a for a, _ in _ocr_state_run(pt, main, fetch, state, card_f,
                                         pt.CUDAPlace(0))]
    cpu = [a for a, _ in _ocr_state_run(pt, main, fetch, state, cpu_f,
                                        pt.CPUPlace())]
    fa, fb = card[0], cpu[0]
    top = float(np.abs(fb).max())
    dz = float(np.abs(fa - fb).max())
    e_fc = dz / top
    la, lb = card[1].reshape(-1), cpu[1].reshape(-1)
    bound = 2 * OCR_RTOL * top + OCR_LOSS_ULPS * 2.0 ** -24 * np.abs(lb)
    e_loss = float(np.max(np.abs(la - lb) / bound))
    B = lb.size
    T = fa.shape[0] // B

    def reading(r):
        return {"cost": r[1], "g": r[2], "dw": r[3:5], "db": r[5],
                "h": r[6:8]}
    rc, rp = reading(card), reading(cpu)
    dh = [float(np.abs(a - b).max()) for a, b in zip(rc["h"], rp["h"])]
    per_image, fc = _ocr_grad_ratios(rc, rp, T, dz, dh)
    rel = [float(np.abs(rc["g"][b * T:(b + 1) * T] -
                        rp["g"][b * T:(b + 1) * T]).max() /
                 np.abs(rp["g"][b * T:(b + 1) * T]).max()) for b in range(B)]
    print(f"  crnn_ctc: first step at B={OCR_B}, card against CPU: max "
          f"|fc_out| {top:.4f}, max |card - CPU| / max |CPU| {e_fc:.3e} "
          f"(bound OCR_RTOL {OCR_RTOL:.3e}); per-image losses "
          f"{', '.join(f'{v:.4f}' for v in lb[:4])}, ... worst |diff| / "
          f"bound {e_loss:.3f}; the CTC gradient, per image: worst |diff| / "
          f"bound {per_image.max():.3e} (worst |diff| / the image's largest "
          f"{max(rel):.3e}); the last fc's gradients (W, W, bias) |diff| / "
          f"bound {', '.join(f'{e:.3e}' for e in fc)}; "
          f"{time.perf_counter() - t0:.1f} s")
    _require(e_fc <= OCR_RTOL and e_loss <= 1.0 and per_image.max() <= 1.0
             and max(fc) <= 1.0 and np.isfinite(la).all(),
             "crnn_ctc: card and CPU disagree")
    # the planted fault: the longest label's loss dropped from the card's
    # reading (its cost 0, its rows of the CTC gradient 0, its share taken
    # out of the last fc's gradients)
    k = int(np.argmax(np.diff(cpu_f["label"].lod()[0])))
    rows = slice(k * T, (k + 1) * T)
    gk = rc["g"][rows]
    bad = {"cost": rc["cost"].copy(), "g": rc["g"].copy(),
           "dw": [w - h[rows].T @ gk for w, h in zip(rc["dw"], rc["h"])],
           "db": rc["db"] - gk.sum(0), "h": rc["h"]}
    bad["cost"].reshape(-1)[k] = 0.0
    bad["g"][rows] = 0.0
    f_image, f_fc = _ocr_grad_ratios(bad, rp, T, dz, dh)
    print(f"  crnn_ctc: planted fault, image {k}'s loss dropped (its label "
          f"the longest): the CTC gradient's |diff| / bound {f_image[k]:.3e}"
          f" on that image; the last fc's (W, W, bias) "
          f"{', '.join(f'{e:.3e}' for e in f_fc)}: rejected "
          f"{bool(f_image[k] > 1.0)}")
    _require(f_image[k] > 1.0, "crnn_ctc: the gradient bound does not "
             "reject a dropped sequence")
    blank = OCR["num_classes"]
    aligned, want, changed = _ocr_aligned(fa, cpu_f["label"], blank)
    got = [_ocr_decode_ops(torch, pt, aligned, cpu_f["label"], d)
           for d in ("cuda", "cpu")]
    same = (np.array_equal(got[0][0], got[1][0]) and got[0][1] == got[1][1]
            and np.array_equal(got[0][2], got[1][2]))
    hyps, (off, *_), dist = got[0]
    spelt = all(hyps[off[b]:off[b + 1]].reshape(-1).tolist() == row and
                dist[b] == 0.0 for b, row in want.items())
    print(f"  crnn_ctc: the card's fc_out aligned to {len(want)} labels and "
          f"{len(changed)} changed ones, decoded on the card and on the "
          f"CPU: {hyps.shape[0]} characters, "
          f"{int((np.diff(off) > 0).sum())} of {B} images not empty; rows, "
          f"LoD and edit distances equal {same}; the labels spelt back at "
          f"distance 0 {spelt}; mean normalized distance "
          f"{float(dist.mean()):.4f}")
    _require(same and spelt and want and changed and
             all(dist[b] > 0.0 for b in changed),
             "crnn_ctc: the decoder differs between card and CPU")


def _kernels_ms(torch, fn):
    """The device time of one call of fn, after one: the sum of its
    kernels' device time under torch.profiler (_seq_profile), which a
    replay would take; the host's gaps between them left out."""
    fn()
    wall, busy, _, _ = _seq_profile(torch, fn)
    return 1e3 * wall * busy


def _ocr_alone(torch, fc_out, label, projs, gru_ops):
    """warpctc (forward, forward + backward) at the step's shapes: ms a
    call eager between CUDA events, and its kernels' device time; then
    F.ctc_loss on the same losses (log_softmax included, divided by T as
    norm_by_times divides) between CUDA events and the largest |port -
    F.ctc_loss|; the two GRUs' kernels forward + backward at theirs.
    Returns a dict of ms and the difference."""
    import torch.nn.functional as F
    B = len(label.lod()[0]) - 1
    T = fc_out.shape[0] // B
    C = fc_out.shape[1]
    t_lod = [list(range(0, B * T + 1, T))]
    lab = label.tensor
    env = {"label": lab}
    call = _lowering_call(
        "warpctc", env, {"Logits": ["logits"], "Label": ["label"]},
        {"Loss": ["loss"], "WarpCTCGrad": ["g"]},
        {"blank": OCR["num_classes"], "norm_by_times": True}, fc_out.device,
        {"logits": t_lod, "label": label.lod()})

    def fwd():
        env["logits"] = fc_out
        with torch.no_grad():
            call()

    def fwd_bwd():
        x = env["logits"] = fc_out.detach().requires_grad_(True)
        with torch.enable_grad():
            call()
            env["loss"].sum().backward()
        return x

    targets = lab.reshape(-1).long()
    in_lens = torch.full((B,), T, dtype=torch.long, device=fc_out.device)
    tg_lens = torch.tensor(np.diff(label.lod()[0]), dtype=torch.long,
                           device=fc_out.device)

    def lib(x):
        lp = torch.log_softmax(x.reshape(B, T, C), -1).transpose(0, 1)
        return F.ctc_loss(lp, targets, in_lens, tg_lens,
                          blank=OCR["num_classes"], reduction="none") / T

    def lib_fwd_bwd():
        x = fc_out.detach().requires_grad_(True)
        lib(x).sum().backward()

    out = {"fwd": _time_ms(fwd, OCR_ALONE_ITERS, 1),
           "fwd_bwd": _time_ms(fwd_bwd, OCR_ALONE_ITERS, 1),
           "dev_fwd": _kernels_ms(torch, fwd),
           "dev_fwd_bwd": _kernels_ms(torch, fwd_bwd)}
    fwd()
    with torch.no_grad():
        ref = lib(fc_out)
    out["ctc_diff"] = float((env["loss"].reshape(-1) - ref).abs().max())
    out["ctc_rel"] = out["ctc_diff"] / float(ref.abs().max())
    # a few kernels a call, so its time between CUDA events is its device
    # time (a profiler session saw none of them on the card)
    out["lib_fwd"] = _time_ms(lambda: lib(fc_out), OCR_ALONE_ITERS, 1)
    out["lib_fwd_bwd"] = _time_ms(lib_fwd_bwd, OCR_ALONE_ITERS, 1)
    gru = 0.0
    for proj, op in zip(projs, gru_ops):
        genv = dict(proj)
        gcall = _lowering_call(
            "gru", genv, {"Input": ["x"], "Weight": ["w"], "Bias": ["b"]},
            {"Hidden": ["h"], "BatchGate": ["g1"],
             "BatchResetHiddenPrev": ["g2"], "BatchHidden": ["g3"]},
            op.all_attrs(), fc_out.device, {"x": t_lod})

        def gru_step(genv=genv, gcall=gcall, base=proj):
            for k in ("x", "w", "b"):
                genv[k] = base[k].detach().requires_grad_(True)
            with torch.enable_grad():
                gcall()
                genv["h"].sum().backward()
        gru += _kernels_ms(torch, gru_step)
    out["gru_fwd_bwd"] = gru
    return out


def _ocr_stream(torch, pt, main, loss, init):
    """OCR_STREAM batches of new label LoDs (as every OCR batch has): once
    each through a fresh Executor's plan cache (_seq_stream: each plans
    and runs eagerly), then on another each run twice (its plan's first
    run, then the run that captures and replays: the capture's parts
    clocked), and once each with use_program_cache=False. Prints
    images/s of the stream at first sight, captured at first sight (a
    capture a batch) and eager."""
    feeds = [ocr_batch(torch, pt, 100 + i, pt.CUDAPlace(0))
             for i in range(OCR_STREAM)]
    chars = [int(np.diff(f["label"].lod()[0]).sum()) for f in feeds]
    _seq_stream(torch, pt, "crnn_ctc stream", main, loss, init, feeds,
                sum(chars), OCR_B, unit="characters")
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = _copy_scope(pt, init, list(init._vars))
    caps, whole = [], 0.0
    for f in feeds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _cap_run(exe, main, f, [loss], scope)
        with _capture_clock() as clock:
            _cap_run(exe, main, f, [loss], scope)
        whole += time.perf_counter() - t0
        caps.append(clock["rule"] + clock["warm_up"] + clock["capture"])
    c = _counters(exe)
    exe.close()
    exe = pt.Executor(pt.CUDAPlace(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in feeds:
        _cap_run(exe, main, f, [loss], scope, cached=False)
    eager = time.perf_counter() - t0
    exe.close()
    n = OCR_B * len(feeds)
    print(f"  crnn_ctc stream: each LoD's capture (the rule, warm-up and "
          f"capture) {', '.join(f'{x:.3f}' for x in caps)} s; images/s "
          f"captured at first sight (a plan, then a capture and a replay "
          f"each, the images counted once) {n / whole:.1f}, eager "
          f"(use_program_cache=False) {n / eager:.1f}; counters {c}")
    _require(c["captures"] == len(feeds) and c["replays"] == len(feeds),
             f"crnn_ctc stream: counters {c}")


def _ocr_evaluated(torch, pt, init):
    """The program as PaddleCV's train.py runs it (ctc_greedy_decoder
    and the EditDistance evaluator in the step, their metric fetched):
    its block stays eager (ctc_align reads the decoded ids on the host).
    OCR_EVAL_STEPS steps from the initial parameters after one; prints
    images/s, the eager reasons and the evaluator's numbers."""
    pt.framework.unique_name.reset()
    main, startup, outs = crnn_ctc_train(pt, evaluate=True)
    main.random_seed = startup.random_seed = SEED
    ev = outs["evaluator"]
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = _copy_scope(pt, init, list(init._vars))
    with pt.scope_guard(scope):
        ev.reset(exe)          # the evaluator's states, zeroed
    feed = ocr_batch(torch, pt, 0, pt.CUDAPlace(0))
    fetch = [outs["loss"]] + ev.metrics
    _cap_run(exe, main, feed, fetch, scope, numpy=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(OCR_EVAL_STEPS):
        got = _cap_run(exe, main, feed, fetch, scope)
    secs = time.perf_counter() - t0
    with pt.scope_guard(scope):
        avg, err = ev.eval(exe)
    reasons = list(exe._engine.eager_reasons.values())
    c = _counters(exe)
    print(f"  crnn_ctc as PaddleCV trains it (decoder and EditDistance in "
          f"the step): {OCR_B * OCR_EVAL_STEPS / secs:.1f} images/s over "
          f"{OCR_EVAL_STEPS} steps; eager reasons {reasons}; counters {c}; "
          f"last loss {float(got[0].reshape(-1)[0]):.4f}, the epoch's "
          f"average distance {float(avg):.4f}, instance error "
          f"{float(err):.4f}")
    _require(reasons == ["ctc_align"] and c["captures"] == 0 and
             np.isfinite(float(avg)), "crnn_ctc with the evaluator")
    exe.close()
    return OCR_B * OCR_EVAL_STEPS / secs


def _ctc_greedy_numpy(fc_out, B, blank):
    """The greedy CTC decode in numpy: each column's argmax, repeats
    merged, blanks dropped, for B images of equal T. Returns (ids, their
    level-0 LoD)."""
    best = fc_out.argmax(1).reshape(B, -1)
    ids, lod = [], [0]
    for seq in best:
        keep = [int(c) for i, c in enumerate(seq)
                if c != blank and (i == 0 or c != seq[i - 1])]
        ids += keep
        lod.append(lod[-1] + len(keep))
    return ids, lod


def _ocr_decode(torch, pt, scope):
    """The decode program (batch norm in inference mode, the decoder) on
    the trained parameters through Executor.run and AnalysisPredictor
    after save_inference_model. The random net puts the blank first in
    every column, so the output fc's bias of the blank is first lowered
    by the median of its margins over the best other class: about half
    the columns then decode to a character. Executor.run's rows equal the
    numpy decode (_ctc_greedy_numpy) of the same run's fc_out and the
    predictor's rows and LoD; images/s of Executor.run."""
    import tempfile
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    pt.framework.unique_name.reset()
    prog, _, outs = crnn_ctc_decode(pt)
    blank = OCR["num_classes"]
    bias = next(op.input("Y")[0] for op in prog.global_block().ops
                if outs["fc_out"].name in op.output_arg_names)
    feed = {"pixel": ocr_batch(torch, pt, 1, pt.CUDAPlace(0))["pixel"]}
    exe = pt.Executor(pt.CUDAPlace(0))
    fc0 = np.asarray(exe.run(prog, feed=feed, fetch_list=[outs["fc_out"]],
                             scope=scope)[0])
    margin = np.sort(fc0[:, blank] - np.delete(fc0, blank, 1).max(1))
    n = margin.size
    shift = 0.5 * float(margin[n // 2 - 1] + margin[n // 2])
    with torch.no_grad():
        scope.find_var(bias).get_tensor().tensor.view(-1)[blank] -= shift
    got = exe.run(prog, feed=feed, fetch_list=[outs["decoded"],
                                                outs["fc_out"]],
                  scope=scope, return_numpy=False)
    rows, lod = np.asarray(got[0]), got[0].lod()
    ids, want_lod = _ctc_greedy_numpy(np.asarray(got[1]), OCR_B, blank)
    greedy = rows.reshape(-1).tolist() == ids and lod[0] == want_lod
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        exe.run(prog, feed=feed, fetch_list=[outs["decoded"]], scope=scope)
    rate = 3 * OCR_B / (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as d:
        with pt.scope_guard(scope):
            pt.io.save_inference_model(d, ["pixel"], [outs["decoded"]], exe,
                                       main_program=prog)
        predictor = create_paddle_predictor(AnalysisConfig(d))
    predictor.get_input_tensor("pixel").copy_from_cpu(
        feed["pixel"].cpu().numpy())
    predictor.zero_copy_run()
    ot = predictor.get_output_tensor(predictor.get_output_names()[0])
    prow = ot.copy_to_cpu()
    same = np.array_equal(prow, rows) and ot.lod() == lod
    filled = int((np.diff(lod[0]) > 0).sum())
    print(f"  crnn_ctc decode: {len(prog.global_block().ops)} ops; the "
          f"blank's bias lowered by {shift:.4e}; {rows.shape[0]} characters"
          f", {filled} of {len(lod[0]) - 1} images not empty, ids in "
          f"[{rows.min()}, {rows.max()}]; equal to the numpy decode of the "
          f"run's fc_out {greedy}; {rate:.1f} images/s through Executor.run "
          f"(eager reasons {list(exe._engine.eager_reasons.values())}); "
          f"AnalysisPredictor rows and LoD equal {same}")
    _require(same and greedy and filled > 0 and len(lod[0]) == OCR_B + 1
             and rows.max() < blank, "crnn_ctc decode: the rows")
    del predictor
    exe.close()


def ocr_phase(torch, dev):
    """CRNN-CTC (crnn_ctc: PaddleCV's ocr_recognition model) at 48x512,
    95 classes, B=32, float32, Momentum with L2Decay: OCR_RUNS steps of
    one batch captured against eager bit for bit (the loss and every
    persistable), the first step against the CPU (_ocr_check_cpu: fc_out,
    the per-image losses, the CTC and the last fc's gradients, a planted
    fault; the decoder on the card's fc_out aligned to the labels),
    images/s eager against captured in turns, the capture clocked, peak
    memory, a profiled replay; warpctc alone (forward, backward) against
    F.ctc_loss on the same losses, the two GRUs alone, and their shares
    of a replay; the program with the decoder and the EditDistance
    evaluator as PaddleCV trains it (eager: ctc_align); a stream of new
    label LoDs; then the decode program through Executor.run and
    AnalysisPredictor. No kernel of the port lies on this path."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    t0 = time.perf_counter()
    pt.framework.unique_name.reset()
    main, startup, outs = crnn_ctc_train(pt)
    main.random_seed = startup.random_seed = SEED
    block = main.global_block()
    types = [op.type for op in block.ops]
    params = main.all_parameters()
    print(f"  crnn_ctc: {len(types)} ops in block 0 "
          f"({types.count('conv2d')} conv2d, {types.count('gru')} gru, "
          f"{types.count('warpctc')} warpctc and its grad, "
          f"{types.count('momentum')} momentum); {len(params)} parameters, "
          f"{sum(int(np.prod(p.shape)) for p in params)} elements; "
          f"{OCR['image'][0]}x{OCR['image'][1]}, {OCR['num_classes']} "
          f"classes and the blank, B={OCR_B}")
    _require(types.count("conv2d") == 8 and types.count("gru") == 2 and
             types.count("warpctc_grad") == 1 and "ctc_align" not in types
             and tuple(outs["fc_out"].shape[1:]) ==
             (OCR["num_classes"] + 1,), "crnn_ctc: the network")
    init = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init)
    cpu_state = {n: v.get_tensor().tensor.to("cpu", copy=True)
                 for n, v in init._vars.items()}
    feed = ocr_batch(torch, pt, 0, pt.CUDAPlace(0))
    lens = np.diff(feed["label"].lod()[0])
    print(f"  batch: {OCR_B} images, labels of {lens.min()}-{lens.max()} "
          f"characters ({lens.sum()} in all), the first a repeat "
          f"{np.asarray(feed['label'])[:2, 0].tolist()}; T = "
          f"{OCR['image'][1] // 8} columns an image")
    loss = outs["loss"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    exe, scope, losses, reasons, _ = _seq_compare(
        torch, pt, kreg, "crnn_ctc", main, [loss], init, [feed], OCR_RUNS)
    _require(not reasons, f"crnn_ctc: the block was kept eager: {reasons}")
    _require(losses[-1] < losses[0], "crnn_ctc: the loss did not fall")
    _ocr_check_cpu(torch, pt, main, outs, cpu_state)
    with _capture_clock() as clock:
        c0 = _counters(exe)
        t1 = time.perf_counter()
        _cap_run(exe, main, feed, [loss], scope)
        secs = time.perf_counter() - t1
    print(f"  crnn_ctc: {_counters(exe)['captures'] - c0['captures']} "
          f"capture outside deterministic mode, {secs:.3f} s for the run: "
          f"the capture rule {clock['rule']:.3f} s, warm-up "
          f"{clock['warm_up']:.3f} s, capture {clock['capture']:.3f} s")
    rates = _cap_turns(torch, "crnn_ctc", "images/s", OCR_B, {
        "eager": lambda: _cap_run(exe, main, feed, [loss], scope,
                                  cached=False, numpy=False)[0],
        "captured": lambda: _cap_run(exe, main, feed, [loss], scope,
                                     numpy=False)[0]})
    print(f"  crnn_ctc: captured / eager "
          f"{rates['captured'] / rates['eager']:.3f}")
    wall, busy, n_kernels = _profiled_replay(torch, "crnn_ctc", exe, main,
                                             feed, [loss], scope)
    replay_ms = _time_ms(lambda: _cap_run(
        exe, main, feed, [loss], scope, numpy=False), 3, 1)
    # warpctc and the GRUs alone at the step's shapes
    gru_ops = [op for op in block.ops if op.type == "gru"]
    fetch = [outs["fc_out"]] + [block.var(op.input("Input")[0])
                                for op in gru_ops]
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                  use_program_cache=False, return_numpy=False)
    tensors = [v.tensor if hasattr(v, "tensor") else v for v in got]
    projs = [{"x": x, "w": scope.find_var(op.input("Weight")[0])
              .get_tensor().tensor,
              "b": scope.find_var(op.input("Bias")[0]).get_tensor().tensor}
             for x, op in zip(tensors[1:], gru_ops)]
    alone = _ocr_alone(torch, tensors[0], feed["label"], projs, gru_ops)
    busy_ms = 1e3 * wall * busy
    print(f"  crnn_ctc: warpctc alone at B={OCR_B}, T={OCR['image'][1] // 8}"
          f", C={OCR['num_classes'] + 1}: eager between CUDA events forward "
          f"{alone['fwd']:.3f} ms, backward "
          f"{alone['fwd_bwd'] - alone['fwd']:.3f} ms; its kernels' device "
          f"time forward {alone['dev_fwd']:.3f} ms, forward + backward "
          f"{alone['dev_fwd_bwd']:.3f} ms, "
          f"{100 * alone['dev_fwd_bwd'] / busy_ms:.1f} % of the profiled "
          f"replay's {busy_ms:.3f} ms of device time (a replay between "
          f"CUDA events {replay_ms:.3f} ms); F.ctc_loss (yardstick, on no "
          f"path) between CUDA events forward {alone['lib_fwd']:.3f} ms, "
          f"forward + backward {alone['lib_fwd_bwd']:.3f} ms; max |warpctc - "
          f"F.ctc_loss| {alone['ctc_diff']:.3e} ({alone['ctc_rel']:.3e} of "
          f"the largest loss)")
    print(f"  crnn_ctc: the two GRUs' kernels alone (forward + backward) "
          f"{alone['gru_fwd_bwd']:.3f} ms of device time, "
          f"{100 * alone['gru_fwd_bwd'] / busy_ms:.1f} % of a replay's")
    _require(alone["ctc_rel"] <= 1e-4, "crnn_ctc: warpctc against "
             "F.ctc_loss")
    del got, tensors, projs
    exe.close()
    _ocr_evaluated(torch, pt, init)
    _ocr_stream(torch, pt, main, loss, init)
    _ocr_decode(torch, pt, scope)
    del scope, init
    gc_cuda(torch)
    print(f"  ocr phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# sampled output heads at Transformer-base's output widths
# ---------------------------------------------------------------------------

HEADS = {"rows": 4096, "width": 512, "classes": 32000}
HEADS_NEG = 10          # nce's noise samples a row
HEADS_SAMPLES = 1024    # sampled softmax's samples a row
HEADS_RUNS = 4          # captured runs against as many eager ones
HEADS_LR = 0.01


def _zipf(n):
    """A Zipf distribution over n classes, p(c) proportional to 1 / (c +
    1): the word frequencies of a vocabulary sorted by count."""
    p = 1.0 / np.arange(1, n + 1)
    return (p / p.sum()).astype(np.float32)


def _heads_program(pt, kind):
    """(main, startup, loss) of one sampled head over a [rows, width]
    input fed as `x` and int64 labels `label`: nce (sampler "uniform",
    "log_uniform" or "custom_dist" over _zipf, HEADS_NEG noise samples),
    hsigmoid, or an fc to the classes and
    sampled_softmax_with_cross_entropy (HEADS_SAMPLES log-uniform
    samples); mean loss, Momentum(HEADS_LR, 0.9)."""
    L = pt.layers
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    C = HEADS["classes"]
    with pt.program_guard(main, startup):
        x = L.data("x", [HEADS["width"]], dtype="float32")
        label = L.data("label", [1], dtype="int64")
        if kind.startswith("nce"):
            sampler = kind.split(" ", 1)[1]
            cost = L.nce(x, label, C, num_neg_samples=HEADS_NEG,
                         sampler=sampler,
                         custom_dist=_zipf(C) if sampler == "custom_dist"
                         else None)
        elif kind == "hsigmoid":
            cost = L.hsigmoid(x, label, C)
        else:
            cost = L.sampled_softmax_with_cross_entropy(
                L.fc(x, C), label, HEADS_SAMPLES)
        loss = L.mean(cost)
        pt.optimizer.Momentum(HEADS_LR, 0.9).minimize(loss)
    main.random_seed = startup.random_seed = SEED
    return main, startup, loss


def sampled_heads_phase(torch, dev):
    """nce (uniform, log-uniform, custom_dist over a Zipf distribution),
    hsigmoid and sampled_softmax_with_cross_entropy at 4096 rows of width
    512 over 32000 classes, forward, backward and a Momentum update:
    HEADS_RUNS captured steps against as many eager ones from one
    startup in deterministic mode, bit for bit (the draws included), and
    each one's device ms a step from a profiled replay. The labels are
    drawn from the same Zipf distribution."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    feed = {"x": rng.standard_normal((HEADS["rows"], HEADS["width"]))
            .astype(np.float32),
            "label": rng.choice(HEADS["classes"], (HEADS["rows"], 1),
                                p=_zipf(HEADS["classes"]).astype(np.float64))
            .astype(np.int64)}
    for kind in ("nce uniform", "nce log_uniform", "nce custom_dist",
                 "hsigmoid", "sampled_softmax"):
        t1 = time.perf_counter()
        main, startup, loss = _heads_program(pt, kind)
        got = []
        _cap_compare(torch, pt, kreg, kind, main, startup, feed, [loss],
                     HEADS_RUNS, fetched=got)
        losses = [float(np.asarray(f[0]).reshape(-1)[0]) for f in got]
        exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
        exe.run(startup, scope=scope)
        for _ in range(2):      # the plan, then the capture
            _cap_run(exe, main, feed, [loss], scope)
        wall, busy, n_kernels, _ = _seq_profile(torch, lambda: _cap_run(
            exe, main, feed, [loss], scope, numpy=False))
        print(f"  {kind}: {HEADS['rows']} rows x {HEADS['width']} over "
              f"{HEADS['classes']} classes: a captured step {1e3 * wall * busy:.3f}"
              f" ms of device time ({n_kernels} kernels, wall "
              f"{1e3 * wall:.3f} ms); losses "
              f"{', '.join(f'{v:.5f}' for v in losses)}; "
              f"{time.perf_counter() - t1:.1f} s")
        _require(all(np.isfinite(losses)), f"{kind}: the losses")
        exe.close()
        del exe, scope
        gc_cuda(torch)
    print(f"  sampled heads phase: {time.perf_counter() - t0:.1f} s")


# the op sweep's tolerance, card against CPU: float32 within 1e-5
# relative and absolute (libm and summation order differ); the rest exact
SWEEP_TOL = 1e-5


def _sweep_check(torch, op_type, card, cpu, clod=None, plod=None):
    """Each output on the card against the CPU's: float32 within
    SWEEP_TOL, the rest (and the LoDs) exactly. Returns the worst float
    |err|."""
    worst = 0.0
    for n, v in card.items():
        a, b = v.detach().cpu(), cpu[n].detach()
        ok = a.dtype == b.dtype and a.shape == b.shape
        if ok and a.is_floating_point():
            finite = b.abs() < 1e29         # not an infeasible CTC loss
            if finite.any():
                worst = max(worst, float((a - b).abs()[finite].max()))
            ok = bool(torch.allclose(a, b, rtol=SWEEP_TOL, atol=SWEEP_TOL))
        elif ok:
            ok = torch.equal(a, b)
        _require(ok and (clod or {}).get(n) == (plod or {}).get(n),
                 f"op sweep: {op_type} {n} on the card differs from the CPU")
    return worst


def _sweep_nlp(torch, dev):
    """Slice 24's cases (family_cases.nlp_cases) on the card against the
    CPU, with each gradient (under one cotangent of every float output)
    where the op has one. nce and sample_logits without
    CustomizedSamples draw on the card what the CPU cannot draw: their
    outputs and gradients are held to the numpy reckoning of the JAX
    op's formula on the card's own samples. Returns (cases, types, the
    worst float |err|)."""
    from paddle_tpu_torch.ops import family_cases as fc
    worst, types, cases = 0.0, set(), fc.nlp_cases()
    for case in cases:
        op_type, ins, lods, attrs, outs, diff = case
        card, clod = fc.run(op_type, ins, attrs, outs, dev, lods)
        rng = np.random.default_rng(7)
        cot = {s: rng.standard_normal(tuple(card[f"{s.lower()}_out0"].shape))
               .astype(np.float32) for s in outs
               if card[f"{s.lower()}_out0"].is_floating_point()}
        if fc.drawn(case):
            if op_type == "nce":
                key, slot = "samplelabels_out0", "Cost"
                cost, grads = fc.nce_numpy(
                    ins, attrs, card[key].cpu().numpy(), cot[slot])
                want = {"cost_out0": cost}
            else:
                key, slot = "samples_out0", "SampledLogits"
                logits, probs, grads = fc.sample_logits_numpy(
                    ins, attrs, card[key].cpu().numpy(), cot[slot])
                want = {"sampledlogits_out0": logits,
                        "probabilities_out0": probs}
            cot = {slot: cot[slot]}
            cpu = {n: torch.from_numpy(v) for n, v in want.items()}
            worst = max(worst, _sweep_check(
                torch, op_type, {n: card[n] for n in want}, cpu))
            cpu_g = {s: torch.from_numpy(g) for s, g in grads.items()}
        else:
            cpu, plod = fc.run(op_type, ins, attrs, outs, "cpu", lods)
            worst = max(worst, _sweep_check(torch, op_type, card, cpu, clod,
                                            plod))
            cpu_g = fc.run_grad(op_type, ins, attrs, outs, diff, "cpu",
                                lods, cpu, cot) if diff else {}
        if diff:
            card_g = fc.run_grad(op_type, ins, attrs, outs, diff, dev, lods,
                                 card, cot)
            worst = max(worst, _sweep_check(
                torch, op_type + "_grad", {s: card_g[s] for s in diff},
                {s: cpu_g[s] for s in diff}))
        types.add(op_type)
    return len(cases), types, worst


def op_sweep_phase(torch, dev):
    """Every op type of the basic, reduce, elementwise, activation, nn
    and conv families, the nine update ops without a kernel, the three
    value-dependent sequence ops, SSD's eight detection ops, the one- and
    two-stage detectors' ten each and slice 24's eleven nlp, metric and
    bilinear ops, each case of ops/family_cases.py once through its
    lowering on the card against the same lowering on the CPU (slice
    24's with their gradients; _sweep_nlp)."""
    from paddle_tpu_torch.ops import family_cases as fc
    t0 = time.perf_counter()
    worst, types = 0.0, set()
    runs = [(c[0], c[1], c[2], c[3], None) for cs in fc.cases().values()
            for c in cs]
    runs += [(c[0], c[1], c[2], c[3], None) for c in fc.conv_cases()]
    runs += [(c[0], c[1], c[3], {s: 1 for s in c[4]}, c[2])
             for c in fc.sequence_cases() + fc.detection_cases()]
    runs += [(c[0], c[1], c[3], c[4], c[2]) for c in fc.one_stage_cases()
             + fc.two_stage_cases()]
    for op_type, ins, attrs, outs, lods in runs:
        card, clod = fc.run(op_type, ins, attrs, outs, dev, lods)
        cpu, plod = fc.run(op_type, ins, attrs, outs, "cpu", lods)
        worst = max(worst, _sweep_check(torch, op_type, card, cpu, clod,
                                        plod))
        types.add(op_type)
    n_nlp, nlp_types, nlp_worst = _sweep_nlp(torch, dev)
    _require(len(nlp_types) == 11, f"op sweep: nlp types {nlp_types}")
    types |= nlp_types
    worst = max(worst, nlp_worst)
    torch.cuda.synchronize()
    print(f"  op sweep: {len(runs) + n_nlp} cases of {len(types)} op types "
          f"on the card equal to their CPU lowerings (float32 worst |err| "
          f"{worst:.3e}, SWEEP_TOL {SWEEP_TOL}); of them slice 24's "
          f"{n_nlp} cases of {len(nlp_types)} types, with their gradients "
          f"(worst |err| {nlp_worst:.3e}); "
          f"{time.perf_counter() - t0:.1f} s")
    return len(types)


# ---------------------------------------------------------------------------
# slice 25: quantization-aware training (contrib.slim) and the random ops
# ---------------------------------------------------------------------------

QAT = {"depth": 50, "class_dim": 1000, "image": (3, 224, 224)}
QAT_B = 128          # bench.py's ResNet-50 batch
QAT_LR, QAT_MU = 0.1, 0.9
QAT_BATCHES = 3      # train batches an epoch: the plan, the capture, a replay
QAT_EPOCHS = 2       # the strategy quantizes at epoch 0 and ends at epoch 1
QAT_STEPS = 3        # captured steps against as many eager ones
QAT_CHECK_B = 4      # the forward held to the CPU, element by element
QAT_TIMED = 2        # profiled or timed replays
# The card's float32 sums (cuDNN, TF32 off) are in another order than the
# CPU's: a pre-quantization tensor (a conv's output through batch norm
# and relu) moves by up to ~sqrt(K) roundings of the largest products of
# a K-term sum, K = 4608 (ResNet-50's 3x3x512 convolutions); 50 of them,
# as RCNN_RTOL reckons, relative to the tensor's largest: 2.02e-4.
QAT_X_RTOL = 50 * 4608 ** 0.5 * 2.0 ** -24
# a quantized element's own rounding: 4 float32 ulps of the bin count (the
# pre-round value is computed from float32 x and s in two roundings)
QAT_HALF_EPS = 4 * 127 * 2.0 ** -23
# the fake-quantize ops; of them those whose Out is the integer grid (the
# rest give the grid value back in x's units)
QAT_FAKE = ("fake_quantize_abs_max", "fake_quantize_dequantize_abs_max",
            "fake_channel_wise_quantize_abs_max", "fake_dequantize_max_abs",
            "fake_channel_wise_dequantize_max_abs",
            "fake_quantize_range_abs_max",
            "fake_quantize_moving_average_abs_max",
            "fake_quantize_dequantize_moving_average_abs_max",
            "moving_average_abs_max_scale")
QAT_GRID = ("fake_quantize_abs_max", "fake_channel_wise_quantize_abs_max",
            "fake_quantize_range_abs_max",
            "fake_quantize_moving_average_abs_max")
QAT_ROUNDING = QAT_GRID + ("fake_quantize_dequantize_abs_max",
                           "fake_quantize_dequantize_moving_average_abs_max")


def qat_train_program(pt, depth=None, class_dim=None, image=None):
    """resnet_train's forward and loss program (no optimizer: the
    Compressor applies it) with the port; returns main, startup, cost,
    acc and the logits' name."""
    depth = depth or QAT["depth"]
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, acc, _ = pt.models.resnet_train(
            class_dim=class_dim or QAT["class_dim"], depth=depth,
            image_shape=image or QAT["image"])
    main.random_seed = startup.random_seed = SEED
    logits = [op.input("Logits")[0] for op in main.global_block().ops
              if op.type == "softmax_with_cross_entropy"][0]
    return main, startup, cost, acc, logits


def _qat_batch(seed, B=None, image=None, class_dim=None):
    """ImageNet-shaped numpy batch: images in [0, 1), labels."""
    r = np.random.RandomState(seed)
    B, image = B or QAT_B, image or QAT["image"]
    return {"image": r.rand(B, *image).astype(np.float32),
            "label": r.randint(0, class_dim or QAT["class_dim"],
                               (B, 1)).astype(np.int64)}


def qat_fetch_names(program, loss_name):
    """The input X and every output of each fake-quantize op of the
    program, then the loss: what qat_forward_check reads of a reference
    run."""
    names = []
    for op in program.global_block().ops:
        if op.type in QAT_FAKE:
            for n in op.input("X") + op.output_arg_names:
                if n not in names:
                    names.append(n)
    return names + [loss_name]


def _qat_verdict(torch, op, x, x_ref, out, out_ref, s, s_ref):
    """The elements of one fake-quantize output that neither equal the
    reference's nor sit one quantum away across a half-step that lies
    between the two pre-round values (float64 arithmetic); the flips
    (the elements one quantum away, explained); and the first violating
    element's values (None where there is none)."""
    f = torch.float64
    bits = op.attr("bit_length", 8)
    bin_cnt = float((1 << (bits - 1)) - 1)
    x, x_ref, out, out_ref = (v.to(f) for v in (x, x_ref, out, out_ref))
    shape = (-1,) + (1,) * (x.ndim - 1) if s.numel() > 1 else ()
    s = s.to(f).reshape(shape).clamp_min(1e-8)
    s_ref = s_ref.to(f).reshape(shape).clamp_min(1e-8)

    def pre(v, sc):
        return torch.minimum(sc, torch.maximum(-sc, v)) / sc * bin_cnt

    p, p_ref = pre(x, s), pre(x_ref, s_ref)
    grid = op.type in QAT_GRID
    q = torch.round(out if grid else out / s * bin_cnt)
    q_ref = torch.round(out_ref if grid else out_ref / s_ref * bin_cnt)
    ulp = 2.0 ** -23
    if grid:
        tol = 2 * ulp * bin_cnt
    else:
        # out - out_ref = (q - q_ref) s_ref / bin + q (s - s_ref) / bin
        # plus each side's roundings: v = q s / bin in two (2u |v|), then
        # the straight-through sum x + (v - x) in two (u |v - x| + u |v|),
        # u = 2^-24; taken as 4u |out| + 2u |out - x| a side. The scale
        # term takes the larger |q|: a flip's own quantum on the side
        # whose q is the larger is s / bin, not s_ref / bin.
        u = ulp / 2
        tol = torch.maximum(q.abs(), q_ref.abs()) * (s - s_ref).abs() / \
            bin_cnt + 4 * u * (out.abs() + out_ref.abs()) + \
            2 * u * ((out - x).abs() + (out_ref - x_ref).abs()) + 1e-30
    same = (q == q_ref) & ((out - out_ref).abs() <= tol)
    half = torch.minimum(q, q_ref) + 0.5
    lo, hi = torch.minimum(p, p_ref), torch.maximum(p, p_ref)
    quantum = 1.0 if grid else (s_ref / bin_cnt).expand_as(out)
    flip = ((q - q_ref).abs() == 1) & (half >= lo - QAT_HALF_EPS) & \
        (half <= hi + QAT_HALF_EPS) & \
        ((out - out_ref).abs() <= quantum + tol)
    bad = ~(same | flip)
    first = None
    if bool(bad.any()):
        i = int(torch.nonzero(bad.reshape(-1))[0])
        tol = tol + torch.zeros_like(out)

        def at(v):
            return float(v.expand_as(out).reshape(-1)[i])
        first = {"i": i, "x": at(x), "x_ref": at(x_ref), "out": at(out),
                 "out_ref": at(out_ref), "pre": at(p), "pre_ref": at(p_ref),
                 "diff": at((out - out_ref).abs()), "tol": at(tol)}
    return int(bad.sum()), int((flip & ~same).sum()), first


def _rel(torch, a, b):
    """max|a - b| / max|b| (0 where b is all zeros and a equals it)."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    d = float((a - b).abs().max()) if a.numel() else 0.0
    m = float(b.abs().max()) if b.numel() else 0.0
    return d / m if m > 0 else d


def _qat_mutants(torch, op, env, device, run):
    """The op's outputs under each planted fault: the bin count 126 in
    place of 127, and (for the channel-wise weight quantizer) one scale
    for the whole tensor in place of one a channel."""
    from paddle_tpu_torch.core.registry import OPS, ExecContext
    from paddle_tpu_torch.ops import quantize as Q
    outs = {}
    e = dict(env)
    real = Q._bin_cnt
    Q._bin_cnt = lambda bits: real(bits) - 1.0
    try:
        OPS.get(op.type).lowering(ExecContext(op, e, device, run))
    finally:
        Q._bin_cnt = real
    outs["bin_cnt 126"] = e
    if op.type == "fake_channel_wise_quantize_abs_max":
        x = env[op.input("X")[0]]
        s = Q._abs_max(x)
        e = dict(env)
        e[op.output("Out")[0]] = Q._quant(x, s, real(op.attr("bit_length",
                                                              8)))
        e[op.output("OutScale")[0]] = s.expand(x.shape[0])
        outs["per-tensor scale"] = e
    return outs


def qat_forward_check(torch, pt, program, state, feed, ref, loss_name,
                      device):
    """The QAT forward `program` run op by op on `device` from `state`
    and `feed` (numpy), held to a reference run's values `ref` (numpy or
    tensors, named as qat_fetch_names names them) segment by segment:
    each fake-quantize op's output is compared with the reference's and
    then replaced by it (the reference's scales and state too), so each
    segment between two quantizations starts from the reference's
    quantized tensors. A quantized element must equal the reference's
    (to the rounding of the scale), or be one quantum away where the
    half-step lies between the two pre-round values: the segment's float
    sums moved it across. Returns the counts: violations (must be 0),
    flips, elements, the largest relative difference of a
    pre-quantization tensor (x_rel) and of a scale state (scale_rel),
    the loss's (loss_rel) with its bound (loss_bound, _qat_loss_bound),
    and the violations under each planted fault (mutants; each must be
    > 0)."""
    from paddle_tpu_torch.core.registry import OPS, ExecContext, RunState

    def tensor(v):
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
        return t.to(device)

    env = {n: tensor(a) for n, a in state.items()}
    env.update((n, tensor(a)) for n, a in feed.items())
    run = RunState(program.random_seed, 0)
    res = {"violations": 0, "flips": 0, "elements": 0, "quant_ops": 0,
           "x_rel": 0.0, "scale_rel": 0.0, "loss_rel": 0.0,
           "mutants": {"bin_cnt 126": 0, "per-tensor scale": 0}}
    with torch.no_grad():
        for op in program.global_block().ops:
            info = OPS.get(op.type)
            checked = op.type in QAT_FAKE and all(
                n in ref for n in op.output_arg_names)
            if not checked:
                info.lowering(ExecContext(op, env, device, run))
                continue
            res["quant_ops"] += 1
            x_name = op.input("X")[0]
            x_ref = tensor(ref[x_name])
            res["x_rel"] = max(res["x_rel"], _rel(torch, env[x_name], x_ref))
            mutants = _qat_mutants(torch, op, env, device, run) \
                if op.type in QAT_ROUNDING else {}
            info.lowering(ExecContext(op, env, device, run))
            for label, got in [("", env)] + list(mutants.items()):
                bad = 0
                for slot in op.output_slots():
                    n = op.output(slot)[0]
                    r = tensor(ref[n])
                    if slot == "Out" and op.type in QAT_ROUNDING:
                        sn = op.output("OutScale")[0]
                        v, flips, first = _qat_verdict(
                            torch, op, env[x_name], x_ref, got[n], r,
                            got[sn], tensor(ref[sn]))
                        bad += v
                        if first and not label and "element" not in res:
                            res["element"] = first
                        if not label:
                            res["flips"] += flips
                            res["elements"] += r.numel()
                    elif slot == "Out":     # a dequantize, to an ulp
                        d = (got[n].to(torch.float64) - r.to(torch.float64))
                        bad += int((d.abs() > 2.0 ** -23 * r.abs().to(
                            torch.float64)).sum())
                    elif got[n].is_floating_point():
                        rel = _rel(torch, got[n], r)
                        bad += int(rel > QAT_X_RTOL)
                        if not label:
                            res["scale_rel"] = max(res["scale_rel"], rel)
                    else:                   # the iteration counter
                        bad += int(not torch.equal(got[n].to(r.dtype), r))
                if label:
                    res["mutants"][label] += bad
                else:
                    res["violations"] += bad
                    if bad and "first" not in res:
                        res["first"] = (op.type, op.output("Out")[0], bad)
            for n in op.output_arg_names:
                env[n] = tensor(ref[n]).to(env[n].dtype)
    res["loss_rel"] = _rel(torch, env[loss_name].reshape(-1),
                           tensor(ref[loss_name]).reshape(-1))
    res["loss_bound"] = _qat_loss_bound(torch, program, env, loss_name)
    return res


def _qat_loss_bound(torch, program, env, loss_name):
    """The bound of loss_rel: the segment after the last quantization is
    the fc (its mul, K its input width, 2048 in ResNet-50) on the
    reference's quantized input and weight, then the bias. Its sum in
    another order moves the logits, relative to the largest, by a random
    walk of sqrt(K) units of 2^-24, the bias add by one more. Where
    `loss_name` is a mean of softmax cross entropies, each term moves
    by at most twice the logits' largest move, and the exp, log and
    mean round on each side: 8 units of 2^-24 of max |logits| + |loss|,
    relative to |loss|."""
    u = 2.0 ** -24
    ops = program.global_block().ops
    fc = [op for op in ops if op.type == "mul"][-1]
    k = env[fc.input("Y")[0]].shape[0]
    walk = k ** 0.5 * u + u
    ce = [op for op in ops if op.type == "softmax_with_cross_entropy"]
    if not ce or loss_name == ce[0].input("Logits")[0]:
        return walk                       # the logits themselves
    z = float(env[ce[0].input("Logits")[0]].abs().max())
    loss = float(env[loss_name].abs().max())
    return (2 * walk * z + 8 * u * (z + loss)) / loss


def _qat_print_check(label, res):
    print(f"  {label}: {res['quant_ops']} fake-quantize ops, "
          f"{res['elements']} quantized elements, {res['flips']} one "
          f"quantum away across a half-step "
          f"({res['flips'] / max(res['elements'], 1):.3e} of them), "
          f"{res['violations']} violations; pre-quantization tensors "
          f"within {res['x_rel']:.3e} of their largest, scale state "
          f"{res['scale_rel']:.3e} (QAT_X_RTOL {QAT_X_RTOL:.3e}); loss "
          f"{res['loss_rel']:.3e} (bound {res['loss_bound']:.3e}); "
          f"planted faults: " + ", ".join(
              f"{k} {v} violations" for k, v in res["mutants"].items())
          + (f"; first violation {res['first']}" if "first" in res else "")
          + (f", its element {res['element']}" if "element" in res else ""))


def _state_numpy(torch, scope, names):
    out = {}
    for n in names:
        v = scope.find_var(n)
        t = v.get_tensor().tensor if v is not None else None
        if isinstance(t, torch.Tensor):
            out[n] = t.detach().cpu().numpy()
    return out


def _persistable(program):
    return [v.name for v in program.global_block().vars.values()
            if v.persistable]


@contextlib.contextmanager
def _made_executors(pt):
    """The engine counters of the Executors made while the block runs
    (the Compressor makes one an epoch and one an evaluation). Only the
    counters are kept: an Executor kept alive would keep its graphs."""
    made = []
    init = pt.Executor.__init__

    def record(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self._engine.counters)
    pt.Executor.__init__ = record
    try:
        yield made
    finally:
        pt.Executor.__init__ = init


def _op_profile(torch, fn):
    """fn() (an eager run) under torch.profiler with one record_function
    range around each op of the engine's runs: {op type: device ms of
    the kernels launched inside its ranges}."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from paddle_tpu_torch.core import engine as E
    span = E._run_span

    def ranged(block, env, device, run, s):
        with record_function("op:" + block.ops[s[0]].type):
            span(block, env, device, run, s)
    E._run_span = ranged
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        E._run_span = span
    # the host-side range of each op, whose device time is that of the
    # kernels launched under it; its device-side twin (a user annotation
    # on the card's timeline, spanning from its first kernel to its last)
    # is left out
    from torch.autograd import DeviceType
    ms = {}
    for e in prof.events():
        if e.name.startswith("op:") and e.device_type == DeviceType.CPU:
            ms[e.name[3:]] = ms.get(e.name[3:], 0.0) + \
                e.device_time_total / 1e3
    return ms


def _qat_compress(torch, pt, tmp):
    """The Compressor's QAT run over full-width ResNet-50: returns the
    context, the scope, the programs' names and what the run cost."""
    from paddle_tpu_torch.contrib import Compressor
    from paddle_tpu_torch.contrib.slim.quantization import \
        QuantizationStrategy
    main, startup, cost, acc, logits = qat_train_program(pt)
    test = main.clone(for_test=True)
    scope = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=scope)
    batches = [_qat_batch(i) for i in range(QAT_BATCHES)]
    strategy = QuantizationStrategy(
        start_epoch=0, end_epoch=1,
        weight_quantize_type="channel_wise_abs_max",
        activation_quantize_type="moving_average_abs_max",
        float_model_save_path=os.path.join(tmp, "float"),
        int8_model_save_path=os.path.join(tmp, "int8"),
        save_in_nodes=["image"], save_out_nodes=[logits])
    comp = Compressor(
        pt.CUDAPlace(0), scope, main,
        train_reader=lambda: iter(batches),
        train_feed_list=["image", "label"],
        train_fetch_list=[cost.name, acc.name],
        eval_program=test, eval_reader=lambda: iter(batches[:1]),
        eval_feed_list=["image", "label"],
        eval_fetch_list=[cost.name, acc.name],
        train_optimizer=pt.optimizer.MomentumOptimizer(QAT_LR, QAT_MU),
        epoch=QAT_EPOCHS, log_period=1)
    comp.strategies = [strategy]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _made_executors(pt) as made, _capture_clock() as clock:
        ctx = comp.run()
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counters = [{k: c[k] for k in ("runs", "captures", "replays",
                                   "eager_runs")} for c in made]
    caps = sum(c["captures"] for c in counters)
    print(f"  Compressor.run: {QAT_EPOCHS} epochs of {QAT_BATCHES} "
          f"batches and an evaluation each, then freeze and both exports, "
          f"{secs:.2f} s; {len(made)} Executors, {caps} captures "
          f"(capture rule {clock['rule']:.3f} s, warm-up "
          f"{clock['warm_up']:.3f}, capture {clock['capture']:.3f}); "
          f"eval results {ctx.eval_results}")
    for c in counters:
        print(f"    executor counters {c}")
    _require(caps >= QAT_EPOCHS,
             f"the epochs captured {caps} graphs, want one an epoch")
    return ctx, scope, cost, logits, batches


def _qat_types(ctx):
    """The transform's counts on the train graph: the quantized conv2d
    and mul ops and the fake-quantize ops."""
    ops = ctx.train_graph[0].global_block().ops
    types = [o.type for o in ops]
    quantized = {t: sum(1 for o in ops if o.type == t and all(
        n.endswith(".quant.dequant") for n in o.input_arg_names))
        for t in ("conv2d", "mul")}
    fake = {t: types.count(t) for t in QAT_FAKE if types.count(t)}
    print(f"  transform: {quantized['conv2d']} of {types.count('conv2d')} "
          f"conv2d and {quantized['mul']} of {types.count('mul')} mul "
          f"quantized; {sum(fake.values())} fake-quantize ops {fake}")
    want = {"conv2d": 53 if QAT["depth"] == 50 else types.count("conv2d"),
            "mul": 1}
    _require(quantized == want and types.count("conv2d") == want["conv2d"],
             f"the transform quantized {quantized}, want {want}")
    return sum(quantized.values())


def _qat_steady(torch, pt, ctx, scope, batches):
    """The steady state on one Executor over the optimize graph: K
    captured steps against K eager ones from one state, bit for bit (the
    moving averages included); then QAT captured in turns with QAT eager
    and with float32 ResNet-50 captured; a QAT replay's device ms, an
    eager step's device time attributed by op (the fake-quantize ops'
    share)."""
    prog, feeds, fetches = ctx.optimize_graph
    names = [n for n in _persistable(prog) if scope.find_var(n)]
    state = {n: scope.find_var(n).get_tensor().tensor.clone()
             for n in names}
    feed = batches[0]

    def fresh():
        s = pt.Scope()
        for n, t in state.items():
            s.var(n).get_tensor().set_tensor(t.clone())
        return s

    outs, ends, counters = {}, {}, {}
    with _deterministic(torch):
        for cached in (True, False):
            exe, s = pt.Executor(pt.CUDAPlace(0)), fresh()
            outs[cached] = [_cap_run(exe, prog, feed, fetches, s, cached)
                            for _ in range(QAT_STEPS + 1)]
            ends[cached] = {n: s.find_var(n).get_tensor().tensor.clone()
                            for n in names}
            counters[cached] = _counters(exe)
            exe.close()
            del exe, s
    gc_cuda(torch)
    same_out = all(np.array_equal(a, b) for x, y in
                   zip(outs[True], outs[False]) for a, b in zip(x, y))
    same = {n: torch.equal(ends[True][n], ends[False][n]) for n in names}
    kinds = {k: sum(1 for n in names if k in n) for k in
             (".quant_scale", ".quant_accum", ".quant_state")}
    print(f"  {QAT_STEPS + 1} steps with the plan cache "
          f"({counters[True]['captures']} capture, "
          f"{counters[True]['replays']} replays) against "
          f"{QAT_STEPS + 1} eager, deterministic mode: losses "
          f"{[float(o[0]) for o in outs[True]]}, bit-equal {same_out}; "
          f"{sum(same.values())} of {len(names)} persistables bit-equal "
          f"(of them {kinds})")
    _require(same_out and all(same.values()) and
             counters[True]["replays"] == QAT_STEPS,
             "QAT: captured steps differ from eager ones")
    del ends

    # QAT captured against QAT eager in turns, then QAT captured against
    # float32 ResNet-50 (no QAT, Momentum) captured. The QAT graph's pool
    # (41 GB at B=128) and an eager step's memory do not fit the card
    # together after the earlier phases, so each captured turn captures
    # its graph first and releases it after
    def new_captured():
        exe, sc = pt.Executor(pt.CUDAPlace(0)), fresh()
        for _ in range(2):           # the plan, then the capture
            _cap_run(exe, prog, feed, fetches, sc)
        return exe, sc

    @contextlib.contextmanager
    def captured_turn():
        gc_cuda(torch)
        qexe, qscope = new_captured()
        try:
            yield lambda: _cap_run(qexe, prog, feed, fetches, qscope,
                                   numpy=False)[0]
        finally:
            qexe.close()
            del qexe, qscope
            gc_cuda(torch)

    eexe, escope = pt.Executor(pt.CUDAPlace(0)), fresh()

    def eager():
        return _cap_run(eexe, prog, feed, fetches, escope, cached=False,
                        numpy=False)[0]
    _cap_turns(torch, "ResNet-50 B=128", "images/s", QAT_B, _Modes(
        qat_captured=captured_turn, qat_eager=eager),
        fresh=("qat_captured",))
    torch.cuda.reset_peak_memory_stats()
    by_op = _op_profile(torch, eager)
    peak = torch.cuda.max_memory_allocated() / 1e9
    eexe.close()
    del eexe, escope
    gc_cuda(torch)
    qexe, qscope = new_captured()

    def captured():
        return _cap_run(qexe, prog, feed, fetches, qscope, numpy=False)[0]

    fmain, fstart, fcost, _, _ = qat_train_program(pt)
    with pt.program_guard(fmain, fstart):
        pt.optimizer.MomentumOptimizer(QAT_LR, QAT_MU).minimize(fcost)
    fscope, fexe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    fexe.run(fstart, scope=fscope)

    def float32():
        return _cap_run(fexe, fmain, feed, [fcost.name], fscope,
                        numpy=False)[0]
    for _ in range(2):
        float32()
    _cap_turns(torch, "ResNet-50 B=128", "images/s", QAT_B, _Modes(
        qat_captured=captured, float32_captured=float32))
    ms = {"qat": _kernels_ms(torch, captured),
          "float32": _kernels_ms(torch, float32)}
    pool = _graph_pool_gb(torch)
    print(f"  a replay's device ms (its kernels): QAT {ms['qat']:.3f}, "
          f"float32 {ms['float32']:.3f} (QAT adds "
          f"{100 * (ms['qat'] / ms['float32'] - 1):.1f} %, "
          f"{100 * (1 - ms['float32'] / ms['qat']):.1f} % of a QAT replay); "
          f"the two graphs' pools {pool[0]:.3f} GB allocated, "
          f"{pool[1]:.3f} GB reserved; an eager step's peak memory "
          f"allocated {peak:.3f} GB")
    total = sum(by_op.values())
    fake = sum(v for k, v in by_op.items() if k.startswith("fake_"))
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:8]
    share = fake / total if total else float("nan")
    print(f"  an eager QAT step attributed by op (a record_function range "
          f"an op; the kernels autograd's device thread launches for the "
          f"generic gradients fall outside them): {total:.3f} ms of the "
          f"{ms['qat']:.3f} ms a replay's kernels take; the fake-quantize "
          f"ops {fake:.3f} ms, {100 * share:.1f} % of the attributed, "
          f"{100 * fake / ms['qat']:.1f} % of a replay (QAT less float32: "
          f"{ms['qat'] - ms['float32']:.3f} ms); top: " + ", ".join(
              f"{k} {v:.2f}" for k, v in top))
    for e in (qexe, fexe):
        e.close()
    del qscope, fscope
    gc_cuda(torch)


def _qat_step_reads(train, prog, cost_name):
    """What _qat_card_vs_cpu reads of the card's step: the forward's
    tensors (qat_fetch_names); for each quantized weight its gradient and
    that of its dequantized copy; for each activation quantizer whose X
    has one reader in the forward, the gradients of X and of Out; the
    loss. Returns (fetch names, weight chains [(quantize op, dequantize
    op)], activation quantizers)."""
    ops = train.global_block().ops
    block = prog.global_block()
    params = {p.name for p in train.all_parameters()}
    readers = {}
    for op in ops:
        for n in set(op.input_arg_names):
            readers[n] = readers.get(n, 0) + 1
    fetch = qat_fetch_names(train, cost_name)
    chains, acts = [], []
    for op in ops:
        if op.type not in QAT_ROUNDING:
            continue
        x, out = op.input("X")[0], op.output("Out")[0]
        if x in params:
            deq = [o for o in ops if o.type in QAT_FAKE and
                   out in o.input("X")]
            chains.append((op, deq[0]))
            grads = [x + "@GRAD", deq[0].output("Out")[0] + "@GRAD"]
        elif readers[x] == 1 and block.has_var(x + "@GRAD"):
            acts.append(op)
            grads = [x + "@GRAD", out + "@GRAD"]
        else:
            continue
        fetch += [n for n in grads if n not in fetch]
    return fetch, chains, acts


def _qat_vjp(torch, op, env, wrt, cot, run):
    """The gradient of op's Out with respect to input `wrt` under the
    cotangent `cot`: the op's forward lowering on the CPU under autograd,
    as the engine's generic gradient runs it (the other inputs are
    constants)."""
    from paddle_tpu_torch.core.registry import OPS, ExecContext
    env = dict(env)
    env[wrt] = env[wrt].detach().requires_grad_()
    with torch.enable_grad():
        OPS.get(op.type).lowering(ExecContext(op, env, torch.device("cpu"),
                                              run))
        g, = torch.autograd.grad(env[op.output("Out")[0]], env[wrt], cot)
    return g


def _qat_grad_checks(torch, chains, acts, card, state, run):
    """Each quantized weight's gradient reckoned on the CPU through its
    dequantize and quantize ops' gradients from the card's gradient of
    the dequantized copy, and each activation quantizer's gradient of X
    from the card's gradient of Out, against the card's. The elementwise
    operations are the same IEEE operations on both sides: 4 units of
    2^-24 of the value. The one sum is the gradient through the scale
    (the clip's and the division's terms, summed over the K elements a
    scale covers, then sent by the abs max to its element): in another
    order a K-term sum moves by at most 2 (K - 1) units of 2^-24 of the
    sum of its terms' magnitudes, which is sum |g x| / s for a weight
    quantized and dequantized (g the dequantized copy's gradient) and
    sum |g x| bin_cnt / s^2 for an activation's integer grid; an
    activation quantized and dequantized passes its gradient straight
    through (no sum). Planted faults: the scale's gradient dropped (a
    weight's) and the gradient masked outside the clip (an
    activation's). Returns the counts."""
    from paddle_tpu_torch.core.registry import OPS, ExecContext
    from paddle_tpu_torch.ops import quantize as Q
    u = 2.0 ** -24
    f64 = torch.float64
    res = {"weights": 0, "acts": 0, "elements": 0, "violations": 0,
           "worst": 0.0, "no scale grad": 0, "clip mask": 0, "beyond": 0}

    def t(a):
        return torch.from_numpy(np.array(a))

    def verdict(got, want, tol):
        d = (got.to(f64) - want.to(f64)).abs()
        return int((d > tol).sum()), float((d / tol.clamp_min(1e-300))
                                           .max())

    def weight_grad(q, dq, w, g):
        env = {q.input("X")[0]: w}
        OPS.get(q.type).lowering(ExecContext(q, env, torch.device("cpu"),
                                             run))
        env = {n: v.detach() for n, v in env.items()}
        g_q = _qat_vjp(torch, dq, env, dq.input("X")[0], g, run)
        return _qat_vjp(torch, q, env, q.input("X")[0], g_q, run)

    for q, dq in chains:
        w_name = q.input("X")[0]
        w = t(state[w_name])
        g = t(card[dq.output("Out")[0] + "@GRAD"])
        got = t(card[w_name + "@GRAD"])
        want = weight_grad(q, dq, w, g)
        rows = w.shape[0] if q.type.startswith("fake_channel_wise") else 1
        wd, gd = w.to(f64).reshape(rows, -1), g.to(f64).reshape(rows, -1)
        s = wd.abs().amax(1, keepdim=True).clamp_min(1e-8)
        terms = (gd.abs() * wd.abs()).sum(1, keepdim=True) / s
        tol = (4 * u * want.to(f64).abs().reshape(rows, -1) +
               2 * wd.shape[1] * u * terms).reshape(w.shape)
        bad, worst = verdict(got, want, tol)
        res["weights"] += 1
        res["elements"] += w.numel()
        res["violations"] += bad
        res["worst"] = max(res["worst"], worst)
        if bad and "first" not in res:
            res["first"] = (q.type, w_name, bad, worst)
        floor = Q._floor_scale
        Q._floor_scale = lambda sc: floor(sc).detach()
        try:
            res["no scale grad"] += verdict(got, weight_grad(q, dq, w, g),
                                            tol)[0]
        finally:
            Q._floor_scale = floor
    for op in acts:
        x_name, out = op.input("X")[0], op.output("Out")[0]
        env = {n: t(state[n]) for n in op.input_arg_names if n in state}
        env[x_name] = x = t(card[x_name])
        g = t(card[out + "@GRAD"])
        got = t(card[x_name + "@GRAD"])
        want = _qat_vjp(torch, op, env, x_name, g, run)
        tol = 4 * u * want.to(f64).abs()
        s = float(t(card[op.output("OutScale")[0]]).reshape(-1)[0])
        if op.type in QAT_GRID:
            bins = Q._bin_cnt(op.attr("bit_length", 8))
            tol = tol + 2 * x.numel() * u * float(
                (g.to(f64).abs() * x.to(f64).abs()).sum()) * bins / s ** 2
        bad, worst = verdict(got, want, tol)
        res["acts"] += 1
        res["elements"] += x.numel()
        res["violations"] += bad
        res["worst"] = max(res["worst"], worst)
        if bad and "first" not in res:
            res["first"] = (op.type, x_name, bad, worst)
        inside = x.abs() <= s
        res["beyond"] += int((~inside).sum())
        res["clip mask"] += verdict(got, want * inside, tol)[0]
    return res


def _qat_momentum_checks(torch, prog, card_after, card, state):
    """Each Momentum update reckoned on the CPU (the op's lowering) from
    the step's state and the card's gradient, against the card's
    parameter and velocity after the step. v' = mu v + g and p' = p - lr
    v' are the same IEEE operations on both sides, each rounded once:
    within 4 units of 2^-24 of mu |v| + |g| (v') and of |p| + lr (mu |v|
    + |g|) (p'). Planted fault: mu 0.8 in place of the op's."""
    from paddle_tpu_torch.core.registry import OPS, ExecContext, _SlotView
    u = 2.0 ** -24
    f64 = torch.float64
    res = {"updates": 0, "elements": 0, "violations": 0, "mu 0.8": 0,
           "worst": 0.0}
    for op in prog.global_block().ops:
        if op.type != "momentum":
            continue
        p, v = op.input("Param")[0], op.input("Velocity")[0]
        env = {n: torch.from_numpy(np.array(state[n]))
               for n in (p, v, op.input("LearningRate")[0])}
        g = op.input("Grad")[0]
        env[g] = torch.from_numpy(np.array(card[g]))
        lr = float(env[op.input("LearningRate")[0]].reshape(-1)[0])
        mag_v = op.attr("mu") * env[v].to(f64).abs() + env[g].to(f64).abs()
        tol = {"VelocityOut": 4 * u * mag_v,
               "ParamOut": 4 * u * (env[p].to(f64).abs() + lr * mag_v)}
        mutant = _SlotView(op.type,
                           {s: op.input(s) for s in op.input_slots()},
                           {s: op.output(s) for s in op.output_slots()},
                           dict(op.all_attrs(), mu=0.8))
        for label, view in (("", op), ("mu 0.8", mutant)):
            e = dict(env)
            OPS.get("momentum").lowering(ExecContext(
                view, e, torch.device("cpu"), None))
            for slot, n in (("ParamOut", p), ("VelocityOut", v)):
                d = (torch.from_numpy(card_after[n]).to(f64) -
                     e[op.output(slot)[0]].to(f64)).abs()
                bad = int((d > tol[slot]).sum())
                if label:
                    res[label] += bad
                else:
                    res["violations"] += bad
                    res["elements"] += d.numel()
                    if bad and "first" not in res:
                        res["first"] = (n, slot, bad)
                    res["worst"] = max(res["worst"], float(
                        (d / tol[slot].clamp_min(1e-300)).max()))
        res["updates"] += 1
    return res


def _qat_card_vs_cpu(torch, pt, ctx, scope, cost):
    """One QAT training step (the optimize graph: forward, backward,
    Momentum) at B=QAT_CHECK_B on the card from the scope's state, held
    to the CPU op by op: the forward by qat_forward_check, the
    quantizers' gradients by _qat_grad_checks, the Momentum updates by
    _qat_momentum_checks; each planted fault must fail its check. B=4:
    the CPU reckons the forward element by element (~12 s at B=4)."""
    train = ctx.train_graph[0]
    prog = ctx.optimize_graph[0]
    names = [n for n in _persistable(prog) if scope.find_var(n)]
    state = _state_numpy(torch, scope, names)
    feed = _qat_batch(100, B=QAT_CHECK_B)
    fetch, chains, acts = _qat_step_reads(train, prog, cost.name)
    fetch += [n for op in prog.global_block().ops if op.type == "momentum"
              for n in op.input("Grad") if n not in fetch]
    s = pt.Scope()
    pt.io.load_params_from_numpy(s, state, pt.CUDAPlace(0))
    vals = pt.Executor(pt.CUDAPlace(0)).run(prog, feed=feed,
                                            fetch_list=fetch, scope=s,
                                            use_program_cache=False)
    card = {n: np.asarray(v) for n, v in zip(fetch, vals)}
    after = _state_numpy(torch, s, names)
    # a weight fetched after the step is the updated one; its quantizer
    # read the state's
    card.update((p.name, state[p.name]) for p in train.all_parameters()
                if p.name in card)
    del s, vals
    t0 = time.perf_counter()
    res = qat_forward_check(torch, pt, train, state, feed, card, cost.name,
                            torch.device("cpu"))
    from paddle_tpu_torch.core.registry import RunState
    grads = _qat_grad_checks(torch, chains, acts, card, state,
                             RunState(train.random_seed, 0))
    mom = _qat_momentum_checks(torch, prog, after, card, state)
    secs = time.perf_counter() - t0
    _qat_print_check(f"one QAT step on the card against the CPU, "
                     f"B={QAT_CHECK_B} ({secs:.1f} s): the forward", res)
    print(f"    the gradients: {grads['weights']} quantized weights through "
          f"their quantize and dequantize ops and {grads['acts']} "
          f"activation quantizers, {grads['elements']} elements, "
          f"{grads['violations']} violations (worst |diff| / bound "
          f"{grads['worst']:.3e}); planted faults: the scale's gradient "
          f"dropped {grads['no scale grad']} violations, the gradient "
          f"masked outside the clip {grads['clip mask']} ({grads['beyond']}"
          f" activation elements beyond their scale)")
    print(f"    the Momentum updates: {mom['updates']} parameters, "
          f"{mom['elements']} elements of parameters and velocities, "
          f"{mom['violations']} violations (worst |diff| / bound "
          f"{mom['worst']:.3e}); planted fault: mu 0.8 {mom['mu 0.8']} "
          f"violations")
    failed = [label for label, ok in (
        (f"forward violations {res['violations']} (first "
         f"{res.get('first')}, {res.get('element')})",
         res["violations"] == 0),
        (f"x_rel {res['x_rel']:.3e}", res["x_rel"] <= QAT_X_RTOL),
        (f"scale_rel {res['scale_rel']:.3e}",
         res["scale_rel"] <= QAT_X_RTOL),
        (f"loss_rel {res['loss_rel']:.3e} > {res['loss_bound']:.3e}",
         res["loss_rel"] <= res["loss_bound"]),
        (f"gradient violations {grads['violations']} (first "
         f"{grads.get('first')})", grads["violations"] == 0),
        (f"Momentum violations {mom['violations']} (first "
         f"{mom.get('first')})", mom["violations"] == 0)) if not ok]
    _require(not failed, f"QAT: the card's step is not the CPU's: "
                         f"{'; '.join(failed)}")
    _require(all(v > 0 for v in res["mutants"].values()) and
             grads["no scale grad"] > 0 and mom["mu 0.8"] > 0 and
             (grads["clip mask"] > 0 or grads["beyond"] == 0),
             f"QAT: a planted fault passed the check {res['mutants']}, "
             f"{grads}, {mom}")
    _require(chains and acts,
             "QAT: the step check found no quantizer to hold")
    return res


def _qat_export(torch, pt, kreg, ctx, scope, logits, tmp, n_quantized):
    """The frozen float and int8 exports: the int8 weights on the grid and
    through the tensor files; the int8 export in AnalysisPredictor against
    the frozen program through Executor.run and, quantized tensor by
    quantized tensor, against the QAT eval program; then served under
    PT_KERNEL_QUANT_MATMUL=int8. Returns the quantized_matmul_int8
    launches of that run and their largest error against the plain
    version."""
    from paddle_tpu_torch.kernels import quantized_matmul as qmm
    int8_dir = os.path.join(tmp, "int8")
    _require(os.path.exists(os.path.join(int8_dir, "__model__")) and
             os.path.exists(os.path.join(tmp, "float", "__model__")),
             "QAT: the compression end wrote no inference model")
    params = [p.name for p in ctx.eval_graph[0].all_parameters()]
    q8 = [n for n in params if scope.find_var(n + "@int8")]
    worst = 0
    arrays = _state_numpy(torch, scope, [m for n in q8 for m in (
        n, n + "@int8", n + ".quant_scale")])
    for n in q8:
        w, q, s = arrays[n], arrays[n + "@int8"], arrays[n + ".quant_scale"]
        _require(q.dtype == np.int8 and int(np.abs(q).max()) <= 127,
                 f"{n}@int8 is not int8 on the grid")
        # the freeze pass's grid value, q * s / 127 in float32 (numpy)
        back = q.astype(np.float32) * s.reshape(
            (-1,) + (1,) * (w.ndim - 1)) / np.float32(127.0)
        worst = max(worst, int((back != w).sum()))

    class _Named:
        def __init__(self, name):
            self.name = name
    with pt.scope_guard(scope):
        pt.io.save_vars(pt.Executor(pt.CPUPlace()), tmp,
                        vars=[_Named(n + "@int8") for n in q8],
                        filename="int8_weights")
    back_scope = pt.Scope()
    with pt.scope_guard(back_scope):
        pt.io.load_vars(pt.Executor(pt.CPUPlace()), tmp,
                        vars=[_Named(n + "@int8") for n in q8],
                        filename="int8_weights")
    trip = all(torch.equal(back_scope.find_var(n + "@int8").get_tensor()
                           .tensor, scope.find_var(n + "@int8")
                           .get_tensor().tensor.cpu()) for n in q8)
    print(f"  int8 export: {len(q8)} of {len(params)} parameters with an "
          f"int8 array, each int8 in [-127, 127] and q * scale / 127 "
          f"equal to the frozen weight ({worst} elements differ); through "
          f"the tensor files ({os.path.getsize(os.path.join(tmp, 'int8_weights'))} "
          f"bytes) and back bit-equal {trip}")
    _require(len(q8) == n_quantized and worst == 0 and trip,
             "QAT: the int8 weights are not the frozen grid")

    batch = _qat_batch(200)
    cfg = pt.inference.AnalysisConfig(int8_dir)
    pred = pt.inference.create_paddle_predictor(cfg)
    name = pred.get_input_names()[0]

    def serve():
        pred.get_input_tensor(name).copy_from_cpu(batch["image"])
        pred.zero_copy_run()
        return pred.get_output_tensor(pred.get_output_names()[0]) \
            .copy_to_cpu()
    served = serve()
    # the frozen program through Executor.run, fetching its quantized
    # tensors too, from the exported weights
    exe = pt.Executor(pt.CUDAPlace(0))
    fscope = pt.Scope()
    with pt.scope_guard(fscope):
        frozen, feeds, fetch_vars = pt.io.load_inference_model(int8_dir,
                                                               exe)
    eval_prog = ctx.eval_graph[0]
    fetch = qat_fetch_names(frozen, logits)
    small = {"image": batch["image"][:QAT_CHECK_B]}
    vals = exe.run(frozen, feed=small, fetch_list=fetch, scope=fscope,
                   use_program_cache=False)
    ref = dict(zip(fetch, vals))
    full = exe.run(frozen, feed={"image": batch["image"]},
                   fetch_list=[logits], scope=fscope)[0]
    err = float(np.abs(served - full).max())
    ev_scope = _copy_scope(pt, scope, [
        n for n in _persistable(eval_prog) if scope.find_var(n)])
    ev = exe.run(eval_prog, feed=batch, fetch_list=[logits],
                 scope=ev_scope)[0]
    top1 = float(np.mean(np.argmax(ev, 1) == np.argmax(served, 1)))
    state = _state_numpy(torch, scope, [n for n in _persistable(eval_prog)
                                        if scope.find_var(n)])
    res = qat_forward_check(torch, pt, eval_prog, state, dict(
        small, label=batch["label"][:QAT_CHECK_B]), ref, logits,
        torch.device("cpu"))
    print(f"  the int8 export in AnalysisPredictor, B={QAT_B}: logits "
          f"{served.shape}, max |predictor - Executor.run| {err:.3e} "
          f"(INFER_ATOL {INFER_ATOL:g}); top-1 equal to the QAT eval "
          f"program's for {100 * top1:.1f} % of the images, max |logits "
          f"diff| {float(np.abs(served - ev).max()):.3e}")
    _qat_print_check(f"the export against the QAT eval program, "
                     f"B={QAT_CHECK_B}", res)
    _require(err <= INFER_ATOL and np.isfinite(served).all(),
             "QAT: the predictor differs from Executor.run")
    _require(res["violations"] == 0 and res["x_rel"] <= QAT_X_RTOL and
             res["loss_rel"] <= res["loss_bound"],
             "QAT: the export differs from the QAT eval program")

    # the fc's mul under PT_KERNEL_QUANT_MATMUL=int8
    fc = [op for op in frozen.global_block().ops if op.type == "mul"][0]
    w_shape = tuple(fscope.find_var(fc.input("Y")[0]).get_tensor().shape())
    M, K, N = QAT_B, w_shape[0], w_shape[1]
    old = os.environ.get("PT_KERNEL_QUANT_MATMUL")
    os.environ["PT_KERNEL_QUANT_MATMUL"] = "int8"
    try:
        pred8 = pt.inference.create_paddle_predictor(cfg)

        def serve8():
            pred8.get_input_tensor(name).copy_from_cpu(batch["image"])
            pred8.zero_copy_run()
            return pred8.get_output_tensor(pred8.get_output_names()[0]) \
                .copy_to_cpu()
        kreg.reset_counts()
        out8 = serve8()
        launches = kreg.launches().get("quantized_matmul_int8", 0)
        eligible = qmm._qmm_eligible(kreg.Signature(
            "mul", ("float32", "float32"), ((M, K), (K, N))))
        err = 0.0
        if launches:     # the kernel against its plain version
            with kreg.plain_reference():
                plain = serve8()
            err = float(np.abs(out8 - plain).max() / np.abs(plain).max())
    finally:
        if old is None:
            os.environ.pop("PT_KERNEL_QUANT_MATMUL", None)
        else:
            os.environ["PT_KERNEL_QUANT_MATMUL"] = old
    why = "" if eligible else (
        f": the fc is [{M}, {K}] x [{K}, {N}] and the kernel takes dims "
        f"that are multiples of 128 ({N} % 128 = {N % 128}); the registry "
        f"keeps it on torch.matmul")
    print(f"  served again under PT_KERNEL_QUANT_MATMUL=int8: "
          f"quantized_matmul_int8 launches {launches}{why}; max |logits - "
          f"float32 serving| {float(np.abs(out8 - served).max()):.3e}; "
          f"against the plain version {err:.3e} of the largest "
          f"(QUANT_FWD_RTOL {QUANT_FWD_RTOL['int8']:g})")
    _require(launches == (1 if eligible else 0) and
             err <= QUANT_FWD_RTOL["int8"],
             f"QAT: {launches} int8 GEMM launches (eligible {eligible}), "
             f"{err:.3e} from the plain version")
    return launches, err


def _qat_variants(torch, pt, dev):
    """The other QAT configurations in a small net (conv2d,
    depthwise_conv2d, fc; B=16, 16x16): abs_max weights with
    range_abs_max and abs_max activations, channel-wise weights with
    moving averages; 3 Momentum steps each on the card, then one
    forward held to the CPU by qat_forward_check."""
    from paddle_tpu_torch.contrib.slim.quantization import \
        QuantizationTransformPass
    for w_type, a_type in (("abs_max", "range_abs_max"),
                           ("abs_max", "abs_max"),
                           ("channel_wise_abs_max",
                            "moving_average_abs_max")):
        pt.framework.unique_name.reset()
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            x = pt.layers.data("image", [3, 16, 16], dtype="float32")
            y = pt.layers.data("label", [1], dtype="int64")
            h = pt.layers.conv2d(x, 8, 3, padding=1, act="relu")
            h = pt.layers.conv2d(h, 8, 3, padding=1, groups=8, act="relu")
            logits = pt.layers.fc(h, 10)
            cost = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
                logits, y))
        main.random_seed = startup.random_seed = SEED
        fwd = main.clone()
        with pt.program_guard(main, startup):
            pt.optimizer.MomentumOptimizer(0.01, 0.9).minimize(cost)
        scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
        exe.run(startup, scope=scope)
        tp = QuantizationTransformPass(
            scope=scope, weight_quantize_type=w_type,
            activation_quantize_type=a_type)
        tp.apply(main)
        tp.apply(fwd)
        types = [o.type for o in main.global_block().ops]
        _require("depthwise_conv2d" in types,
                 "the small net has no depthwise_conv2d")
        for i in range(3):
            loss = exe.run(main, feed=_qat_batch(i, 16, (3, 16, 16), 10),
                           fetch_list=[cost], scope=scope)[0]
        names = [n for n in _persistable(fwd) if scope.find_var(n)]
        state = _state_numpy(torch, scope, names)
        feed = _qat_batch(50, 16, (3, 16, 16), 10)
        fetch = qat_fetch_names(fwd, cost.name)
        s = pt.Scope()
        pt.io.load_params_from_numpy(s, state, pt.CUDAPlace(0))
        ref = dict(zip(fetch, exe.run(fwd, feed=feed, fetch_list=fetch,
                                      scope=s, use_program_cache=False)))
        res = qat_forward_check(torch, pt, fwd, state, feed, ref,
                                cost.name, torch.device("cpu"))
        _qat_print_check(f"small net, {w_type} weights, {a_type} "
                         f"activations (3 steps, loss {float(loss):.4f})",
                         res)
        _require(res["violations"] == 0 and res["x_rel"] <= QAT_X_RTOL and
                 res["loss_rel"] <= res["loss_bound"] and
                 res["mutants"]["bin_cnt 126"] > 0,
                 f"QAT {w_type}/{a_type}: the card is not the CPU")


# statistical checks of the random ops: each test at this level
QAT_ALPHA = 1e-3


def _random_stats(torch, pt, kreg, dev):
    """The random ops on the card against their laws (scipy): the
    truncated normal by a Kolmogorov-Smirnov test, sampling_id's ids by
    chi-square against the rows' probabilities, random_crop's starts by
    their bounds and chi-square against uniform, each at QAT_ALPHA; then
    a block with sampling_id and random_crop captured against eager."""
    from scipy import stats
    from paddle_tpu_torch.core.registry import OPS, ExecContext, RunState
    from paddle_tpu_torch.framework import Operator

    def draw(op_type, inputs, outs, attrs, run=0):
        prog = pt.Program()
        op = Operator(prog.global_block(), op_type,
                      {s: [s.lower()] for s in inputs},
                      {s: [s.lower() + "_out"] for s in outs},
                      dict(attrs, __op_uid__=7))
        env = {s.lower(): v for s, v in inputs.items()}
        OPS.get(op_type).lowering(ExecContext(op, env, dev,
                                              RunState(SEED, run)))
        return {s: env[s.lower() + "_out"] for s in outs}

    n = 200_000
    z = draw("truncated_gaussian_random", {}, ["Out"],
             {"shape": [n], "mean": 0.0, "std": 1.0, "dtype": 9})["Out"]
    z = z.cpu().double().numpy()
    law = stats.truncnorm(-2.0, 2.0)
    ks = stats.kstest(z, law.cdf)
    print(f"  truncated_gaussian_random: {n} draws in [{z.min():.4f}, "
          f"{z.max():.4f}], KS p {ks.pvalue:.3f} (alpha {QAT_ALPHA})")
    _require(ks.pvalue > QAT_ALPHA and z.min() >= -2 and z.max() <= 2,
             "truncated_gaussian_random is not the truncated normal")
    rng = np.random.default_rng(5)
    p = rng.random(12) ** 2
    p /= p.sum()
    rows = 100_000
    x = torch.from_numpy(np.tile(p.astype(np.float32), (rows, 1))).to(dev)
    ids = draw("sampling_id", {"X": x}, ["Out"], {})["Out"]
    _require(ids.dtype == torch.int64 and tuple(ids.shape) == (rows,),
             "sampling_id's ids")
    counts = np.bincount(ids.cpu().numpy(), minlength=12)
    chi = stats.chisquare(counts, rows * p)
    print(f"  sampling_id: {rows} ids over 12 classes, chi-square p "
          f"{chi.pvalue:.3f}")
    _require(chi.pvalue > QAT_ALPHA, "sampling_id's ids are off their law")
    img = torch.arange(40 * 30, dtype=torch.float32,
                       device=dev).reshape(1, 40, 30)
    starts = np.array([[int(o[0, 0, 0]) // 30, int(o[0, 0, 0]) % 30]
                       for o in (draw("random_crop", {"X": img},
                                      ["Out", "SeedOut"],
                                      {"shape": [24, 21]}, r)["Out"]
                                 for r in range(1500))])
    lims = (40 - 24, 30 - 21)
    chis = [stats.chisquare(np.bincount(starts[:, i], minlength=L + 1))
            for i, L in enumerate(lims)]
    print(f"  random_crop: 1500 crops of 40x30 to 24x21, starts in "
          f"[0, {starts[:, 0].max()}] x [0, {starts[:, 1].max()}] (limits "
          f"{lims}), chi-square p {chis[0].pvalue:.3f}, {chis[1].pvalue:.3f}")
    _require((starts >= 0).all() and starts[:, 0].max() <= lims[0] and
             starts[:, 1].max() <= lims[1] and
             all(c.pvalue > QAT_ALPHA for c in chis),
             "random_crop's starts are off their law")
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        probs = pt.layers.data("probs", [12], dtype="float32")
        ims = pt.layers.data("ims", [3, 40, 30], dtype="float32")
        sid = pt.layers.sampling_id(probs)
        crop = pt.layers.random_crop(ims, [3, 24, 21])
        total = pt.layers.reduce_sum(crop)
    feed = {"probs": np.tile(p.astype(np.float32), (64, 1)),
            "ims": np.random.RandomState(3).rand(8, 3, 40, 30)
            .astype(np.float32)}
    fetched = []
    _cap_compare(torch, pt, kreg, "sampling_id + random_crop", main,
                 startup, feed, [total.name, sid.name], 4,
                 fetched=fetched)
    _require(len({f[1].tobytes() for f in fetched}) > 1,
             "the captured runs drew the same ids every run")


# the student's weights after the slim run (24 Momentum steps of fcs of
# K <= 64 with pruning and soft labels), card against CPU: 1.805e-7 of
# their largest in each of 8 runs on the H100, float32 (TF32 off); the
# bound is 5.5 times that
SLIM_W_RTOL = 1e-6


def _slim_small(torch, pt, dev):
    """A Compressor run built in Python: a width-64 teacher distilled into
    a width-24 student (soft labels) while the student's first fc is
    pruned by a quarter of its columns (StructuredPruner) at epoch 0;
    Momentum; the card against the CPU from the same weights."""
    from paddle_tpu_torch.contrib import Compressor
    from paddle_tpu_torch.contrib.slim.distillation import (
        DistillationStrategy, SoftLabelDistiller)
    from paddle_tpu_torch.contrib.slim.prune import (StructuredPruner,
                                                     UniformPruneStrategy)
    protos = np.random.RandomState(42).normal(0, 1, (10, 64)) \
        .astype(np.float32)

    def data(n, seed):
        r = np.random.RandomState(seed)
        y = r.randint(0, 10, (n, 1))
        x = protos[y[:, 0]] + r.normal(0, 0.35, (n, 64))
        return x.astype(np.float32), y.astype(np.int64)

    def net(width, prefix=""):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            x = pt.layers.data("img", [64], dtype="float32")
            y = pt.layers.data("label", [1], dtype="int64")
            h = pt.layers.fc(x, width, act="relu",
                             param_attr=pt.ParamAttr(name=prefix + "w0"))
            logits = pt.layers.fc(h, 10, param_attr=pt.ParamAttr(
                name=prefix + "w1"))
            sm = pt.layers.softmax(logits)
            loss = pt.layers.mean(pt.layers.cross_entropy(sm, y))
            acc = pt.layers.accuracy(sm, y)
        main.random_seed = startup.random_seed = SEED
        return main, startup, loss, acc, logits

    xs, ys = data(512, 0)

    def reader():
        for i in range(0, 512, 64):
            yield {"img": xs[i:i + 64], "label": ys[i:i + 64]}

    init, results = None, {}
    for key, place in (("card", pt.CUDAPlace(0)), ("cpu", pt.CPUPlace())):
        pt.framework.unique_name.reset()
        scope = pt.Scope()
        t_main, t_start, _, _, t_logits = net(64, "t_")
        s_main, s_start, s_loss, s_acc, s_logits = net(24)
        exe = pt.Executor(place)
        exe.run(t_start, scope=scope)
        exe.run(s_start, scope=scope)
        names = ["t_w0", "t_w1", "w0", "w1"] + [
            p.name for p in t_main.all_parameters() + s_main.all_parameters()
            if p.name not in ("t_w0", "t_w1", "w0", "w1")]
        if init is None:
            init = _state_numpy(torch, scope, names)
        pt.io.load_params_from_numpy(scope, init, place)
        comp = Compressor(
            place, scope, s_main, train_reader=reader,
            train_feed_list=["img", "label"],
            train_fetch_list=[s_loss.name, s_acc.name],
            eval_program=s_main.clone(for_test=True), eval_reader=reader,
            eval_feed_list=["img", "label"], eval_fetch_list=[s_acc.name],
            teacher_programs=[t_main.clone(for_test=True)],
            train_optimizer=pt.optimizer.MomentumOptimizer(0.05, 0.9),
            distiller_optimizer=pt.optimizer.MomentumOptimizer(0.05, 0.9),
            epoch=3, log_period=1000)
        comp.strategies = [
            DistillationStrategy(
                distillers=[SoftLabelDistiller(t_logits.name,
                                               s_logits.name)],
                start_epoch=0, end_epoch=2),
            UniformPruneStrategy(
                pruner=StructuredPruner(scope=scope), start_epoch=0,
                target_ratio=0.25, pruned_params="w0")]
        ctx = comp.run()
        results[key] = (
            ctx.eval_results[s_acc.name],
            _state_numpy(torch, scope, ["w0", "w1"]))
    (card_acc, card_w), (cpu_acc, cpu_w) = results["card"], results["cpu"]
    rel = max(_rel(torch, torch.from_numpy(card_w[n]),
                   torch.from_numpy(cpu_w[n])) for n in card_w)
    zero_cols = float((np.abs(card_w["w0"]).sum(0) == 0).mean())
    print(f"  slim without a config (distillation + pruning, Momentum, 3 "
          f"epochs of 8 batches): accuracy on the card {card_acc}, on the "
          f"CPU {cpu_acc}; the student's weights within {rel:.3e} of the "
          f"CPU's (SLIM_W_RTOL {SLIM_W_RTOL:g}); {100 * zero_cols:.0f} % "
          f"of w0's columns pruned on both: "
          f"{np.array_equal(card_w['w0'] == 0, cpu_w['w0'] == 0)}")
    _require(rel <= SLIM_W_RTOL and zero_cols == 0.25 and
             np.array_equal(card_w["w0"] == 0, cpu_w["w0"] == 0) and
             card_acc[-1] > 0.7,
             "slim: the card's compression is not the CPU's")


def qat_phase(torch, dev):
    """ResNet-50 (full depth and width, 1000 classes, B=128, 224x224,
    float32) trained quantization-aware through contrib.slim's
    Compressor and QuantizationStrategy, frozen, exported to int8 and
    served; then the small card checks of slice 25. Returns the
    quantized_matmul_int8 launches (row 6) and their worst error."""
    import tempfile
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    gc_cuda(torch)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx, scope, cost, logits, batches = _qat_compress(torch, pt, tmp)
        n_quantized = _qat_types(ctx)
        _qat_steady(torch, pt, ctx, scope, batches)
        _qat_card_vs_cpu(torch, pt, ctx, scope, cost)
        launches, err = _qat_export(torch, pt, kreg, ctx, scope, logits,
                                    tmp, n_quantized)
    del ctx, scope, batches
    gc_cuda(torch)
    print(f"  ResNet-50 QAT: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    _qat_variants(torch, pt, dev)
    _random_stats(torch, pt, kreg, dev)
    _slim_small(torch, pt, dev)
    print(f"  the small checks: {time.perf_counter() - t1:.1f} s; the "
          f"phase {time.perf_counter() - t0:.1f} s")
    return launches, err


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="DIR",
                    help="an earlier checkout of this repo: time its "
                         "CUDA-core attention forward, SGD and Adam "
                         "kernels, quantized GEMM and bucket sweeps in "
                         "turns with this one's")
    args = ap.parse_args(argv)
    t_script = time.perf_counter()
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
    print("[pose phase]")
    pose_adam = pose_phase(torch, dev, card)
    print("[yolo phase]")
    yolo_phase(torch, dev)
    print("[rcnn phase]")
    rcnn_phase(torch, dev)
    print("[ocr phase]")
    ocr_phase(torch, dev)
    print("[sampled heads phase]")
    sampled_heads_phase(torch, dev)
    print("[qat phase]")
    qat_launches, _ = qat_phase(torch, dev)
    serve_launches["int8"] += qat_launches

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
             book_adam + lr_adam + ct_adam + pose_adam),
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
    print(f"the script: {time.perf_counter() - t_script:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
