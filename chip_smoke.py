#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py             # every phase below
    python3 chip_smoke.py --profile   # device, build, then the profiles
    python3 chip_smoke.py --serve-ab  # device, build, fp and int8 serving
                                      # in turns (fp, wo, dyn, dyn, wo, fp)
    python3 chip_smoke.py --conv-bn   # device, build, kernels #8-#11 only
    python3 chip_smoke.py --train-kernels  # device, build, kernels #1-#6
    python3 chip_smoke.py --serve-kernels  # device, build, kernels #1, #3,
                                           # #7
    python3 chip_smoke.py --resnet-default # device, build, ResNet-50 steps
                                           # with cuDNN's default algorithms
    python3 chip_smoke.py rnn         # device, build, #5/#6 at machine
                                      # translation's shape, rnn_check,
                                      # and the rnn phase (21) alone
    python3 chip_smoke.py serve_paged # device, build, #1/#3 at the
                                      # verify's shapes, and the
                                      # serve_paged phase (4b) alone
    python3 chip_smoke.py plain_ops   # device, build, and phase 23 alone
    python3 chip_smoke.py mnist_cnn   # device, build, and phase 24 alone
    python3 chip_smoke.py seq_ops     # device, build, and phase 25 alone
    python3 chip_smoke.py beam        # device, build, and phase 26 alone
    python3 chip_smoke.py srl         # device, build, and phase 27 alone
    python3 chip_smoke.py ssd         # device, build, and phase 28 alone
    python3 chip_smoke.py a4_ops      # device, build, and phase 29 alone
                                      # (several words: those phases)

Run from the root of a checkout.  Phases, one line each:

1. ``device``  — the card's name and power limit (``nvidia-smi``), and the
   TF32 switches, which this script turns off so that float32 products
   stay float32, and cuBLAS's reduced-precision bf16 reduction, which the
   port turns off so that bf16 products sum in float32;
2. ``build``   — compiles every kernel under ``paddle_tpu_torch/csrc``
   with ``nvcc`` (in parallel) and reports the seconds taken, each
   kernel's registers and spills, the ``HGMMA`` (wgmma) instructions in
   the ``conv_bn`` and ``conv_bn_nhwc`` libraries, the ``HMMA`` (mma.sync
   TF32 / bf16 / f16) ones in ``flash_attention_fwd``,
   ``flash_attention_bwd`` and ``quant_matmul`` and the ``IMMA`` (int8
   mma.sync) ones in ``quant_matmul`` (``cuobjdump --dump-sass``); it
   fails if any of them is 0;
3. ``kernels`` — each hand-written kernel against its plain PyTorch
   version at the shapes its paths give it (the serving slice's and the
   training slice's): max abs error and tolerance, the kernel's, the plain
   version's and one PyTorch library call's median time (CUDA events, L2
   flushed before every launch), the device time of one kernel call and of
   one library call (``device_ms``: the sum of the device kernels it ran,
   ``torch.profiler``; a library backward is several launches, whose event
   time also counts the host's gaps), and the least time the card could take
   (device-memory bytes at 3.35 TB/s or operations at the data-sheet peak
   of the input type; #1 float32 at three TF32 passes, #7's
   weight_only float32 at two, with the float32 units' bound beside);
   #1 and #7 also give the same bits twice, run one device kernel a call
   (the dynamic prefill two) and launch with the key / K split their
   wrappers plan; the fused conv+BN kernels #8-#11 at ResNet-50's
   stage 1, 3 and 4 shapes in both layouts (tensor cores, float32 as
   three TF32 passes, bound at 3 x operations / 495 TFLOP/s beside the
   float32-unit bound), and at a ragged shape in each (NHWC M 1000, NCHW 3
   images of 7x7; C 72, O 200); #2, #4 and their library calls also name
   the device kernels they ran (SDPA's backend); the AMP paths' shapes
   and types too: #1/#2 in bfloat16 at the training shape with dropout
   0.1, #8-#11 in bfloat16 at stages 1, 3 and 4, and at SE-ResNeXt-50's
   fused shapes (``SE_CONV_BN_CASES``, each layout); #5/#6 at machine
   translation's loss, [1920, 30000] float32; #3 and #5 also give the
   same bits twice and report the plan they launched with, #5 at
   rows that start off 16-byte boundaries ([64, 30001] float32, [64,
   1001] bfloat16) and on its streaming path ([128, 100003]), #3 on its
   generic loop ([1000, 97] float32, [5, 4096] bfloat16) with the host
   time of a call beside ``F.layer_norm``'s; #1 and #3 at the
   speculative verify's shapes ([8, 8, 4, 64] over 1024 keys with its key
   lengths, [32, 512]);
Every path below runs twice, in turns: captured (the default
``Executor``: each dispatch signature's first run eager, its second
captured as a CUDA graph and replayed, later ones replayed; the main path,
whose launch counts the kernel table reports) and eager
(``capture=False``, the path ``<name>:eager``).  The two must give the
same bits.  Each reports wall, device busy time and idle share, tokens/s
or images/s and peak memory; its timed runs are taken with the launch
counters zeroed just before and read just after, then it runs once more
under ``torch.profiler`` (a pass or a step: busy time, idle share, and
each kernel's launches counted in the device trace).  Launches must be
exactly what the programs imply (``launch_faults``): an eager path's
wrappers count them in the timed runs and in the profiled window, whose
trace shows the same; a captured path's wrappers count none (every timed
and profiled run replays a graph), and its window's trace shows each
kernel as often as the eager one.  The kernel table reports the traced
counts of each path's profiled window.  The profiler now and then loses
a few kernel records of a long serving window (about 1 to 11 of 15,000
events, the window's wrappers having launched every one): a serving
pass, which changes no state, is then profiled again, up to
``TRACE_TRIES`` windows, and the losses are logged (``trace_losses``).
Each window first runs ``TRACE_PADS`` tiny spin kernels, left out of its
counts, since late in a whole run the trace dropped the first records of
a window (``pads_traced`` shows how many pads it kept; not gated).  A
window whose trace holds no device event at all is a fault; where the
path's bit comparison is taken before the window (phases 16-20), an
empty window is profiled again first (``empty_windows``).

4. ``serve``   — a decoder LM at Transformer-base width (6 layers,
   d_model 512, 8 heads, d_inner 2048, vocab 32000, 1024-token cache,
   8 slots, float32, random weights from build_decoder_lm's seed) served by
   ``GenerationEngine`` on ``CUDAPlace(0)``: after two dispatches of every
   prefill bucket, 16 requests with prompts of 64..700 tokens, 32 new
   tokens each.  Every prefill and decode dispatch must launch the
   attention kernel 6 times and the layer-norm kernel 12 times (the
   dequant-matmul kernel never), and one request's recorded logits must
   match a full forward recompute of the score program (rtol/atol 2e-4);
   the generated tokens and recorded logits of the captured and the eager
   engine are the same bits (``capture_check``);
5. ``serve_int8`` — the same model and requests with
   ``GenerationEngine(..., quantize=mode)`` for ``weight_only`` and
   ``dynamic``: every dispatch launches the dequant-matmul kernel once per
   ``dequant_matmul`` op (37); weight_only decode logits match the
   quantized score program's recompute within 2e-4 (dynamic within
   relative L1 0.02), and the quantized score logits the fp ones within
   relative L1 0.02 (the int8 accuracy budget); the int8 weights are a
   quarter of the float32 bytes;
4b. ``serve_paged`` — the same width with a paged cache (pages of 8, the
   default 1024 pages): 16 requests of 64..700 tokens (the serve phase's
   lengths) whose first 32 tokens are one system prompt (4 shared pages),
   32 new tokens each, through the fixed region (the reference) and three
   arms, each eager and captured: paged float32 (tokens equal the fixed
   region's, logits within 2e-4; the live shared pages a later prefill
   writes again, and how many changed bits), paged int8 KV (logits within
   relative L1 0.02 of paged float32; bytes a session against the fixed
   region's, bench.py's accounting) and speculative decoding (spec_k 4,
   a fixed-region draft carrying the target's weights: tokens equal paged
   float32's, a parting allowed only under a top-two gap of
   ``PARTING_GAP`` and printed; the acceptance rate).  Captured = eager
   bit for bit, one graph for every signature (prefill buckets, decode,
   verify, the draft's prefill buckets and decode), no leaked page,
   prefix hits, and exact launches (a speculative prefill #1 11 / #3 22:
   the draft's prefill fetches nothing, so its last layer's attention and
   norms do not run; a round 24 / 48).  Then ``kv_cache_paged_write`` on
   card tensors against the same op on CPU copies, bit for bit (prefill,
   decode and verify writes with sentinel entries, float32 and int8);
6. ``infer``   — the score program saved with ``io.save_inference_model``
   and served cold by ``InferenceEngine(model_dir=..., quantize=
   "weight_only")``: 16 requests of 32..256 tokens, each [T, 32000] output
   against a direct ``Executor.run`` of the quantized program (2e-4) and of
   the fp program (relative L1 0.02); the quantized program saved again
   and served cold with no pass, to the same outputs;
6b. ``infer_bf16`` — the score program saved in float32, rewritten by
   ``contrib.Bfloat16Transpiler`` (bf16 parameters, #1 and #3 in bf16,
   the logits cast back to float32), saved, and served cold by
   ``InferenceEngine`` (captured): every output float32 and within
   relative L1 0.02 of a direct run of the float32 program, the engine's
   parameters bf16 on the card, #1 6 and #3 12 launches a batch;
7. ``train_check`` — the Transformer-base train program at dropout 0,
   one batch of 4 rows at full width, one step on ``CUDAPlace(0)`` (the
   kernels) and one on ``CPUPlace()`` (the plain versions) from one
   startup state: the losses agree within rtol 1e-4, the parameters'
   gradients within relative L2 1e-4 at the median and 1e-2 for each,
   the CPU taking the card's ReLU decisions (see ``train_check_phase``),
   and the step moved the parameters;
8. ``train``   — Transformer-base training as bench.py configures it
   (6+6 layers, d_model 512, 8 heads, d_inner 2048, vocab 32000, batch
   256 x 64 tokens, source and target lengths drawn per row in [16, 64],
   dropout 0.1, label smoothing 0.1, noam(512, 4000), Adam(0.9, 0.997,
   1e-9)) on ``CUDAPlace(0)``, captured and eager from one startup
   state: two untimed steps each (the captured second is the capture),
   then timed steps in turns; each kernel must launch exactly as often
   as the program's ops imply; the losses at every step and every scope
   tensor after them are the same bits, and after a parameter is swapped
   in both scopes (``scope.set_var``; numpy in the captured one) the next
   step is too, the captured scope pointing back at its captured tensor;
7b/8b. ``train_amp_check`` and ``train_amp`` — the same two phases with
   the optimizer wrapped in ``contrib.mixed_precision.decorate``
   (bench.py's default rungs): #1/#2 in bfloat16, #3-#6 in float32; the
   check holds the loss within rtol 1e-2 and the gradients within 3x a
   floor measured in the same call by ``resnet_check``'s 1e-7 nudge (no
   fixed band holds under AMP at batch 4: ``AMP_NUDGE``), and every
   float32 persistable (parameters, moments, counters) stays float32;
9. ``resnet_check`` — bench.py's ResNet-50 (depth 50, 3x224x224, class_dim
   1000, Momentum(1e-3, 0.9)) after ``fuse_conv_bn`` and after
   ``convert_to_nhwc`` + ``fuse_conv_bn``, batch 4 at full width: one step
   on the card (kernels #8-#11) against one on the CPU from one startup
   state, and against the plain program on the card: loss rtol 1e-4, and
   gradients within 3x the relative-L2 floor that a 1e-7 nudge of the
   weights gives the plain program in the same call (median and maximum;
   see ``resnet_check_phase``);
10. ``resnet_train`` — the same model at batch 128 (cut from bench.py's
   512) in three programs, plain, fused and NHWC + fused, on the same
   batches, each eager and captured: two untimed steps each, then 5
   timed steps taken in turns (exactly 30 launches of #8 and #9 a step on
   the fused program, of #10 and #11 on the NHWC one, none on the plain
   one), then one profiled step each.  The phase runs with cuDNN's
   deterministic algorithms and ``torch.use_deterministic_algorithms``
   (cuDNN's default backward sums with atomics in no fixed order), and
   the captured arm's losses and every scope tensor (parameters, running
   statistics, velocities) are the eager arm's bits;
9b/10b. ``resnet_amp_check`` and ``resnet_amp`` — the same two phases
   under ``decorate``: the trunk runs in bfloat16 after the first
   convolution, #8-#11 in bfloat16; the check's loss band is rtol 1e-2
   and its gradient floor is of the order of the gradients under AMP
   (``resnet_check_phase``); every float32 persistable stays float32.

3b. ``train_amp_small_check`` and ``resnet_amp_small_check`` (after
   ``kernels``) — the AMP step, card against CPU, at
   ``tests/test_torch_amp.py``'s small configurations (the 2+2-layer
   Transformer with one 64-wide head; the bf16-stem net plain, fused and
   NHWC + fused): the fixed band (loss rtol 1e-2, gradients relative L2
   2e-2 at the median) and the same-call floor of a 1e-7 weight nudge,
   each reported; the stem net is held to the band, the Transformer to
   3x its floor (``amp_small_checks``);
11. ``mlp_trainer`` — the MNIST MLP (784-256-256-10, Adam 1e-3, batch
   256, ``tests/test_mnist_mlp.py``'s synthetic rule): captured = eager
   bit for bit over 20 steps, bench.py's compute rung (a staged batch,
   replays, one graph) and ``Trainer.train`` over a ``reader.batch``
   reader with the ``DataFeeder`` converting every step, images/s each;
   the loss falls;
12. ``realdist`` — bench.py's ``transformer_realdist`` under AMP:
   Transformer-base fed pad-to-max (128 x 64) and bucketed
   (``bucket_by_length``, bounds 16 / 32 / 48 / 64, 512 / 256 / 170 /
   128 rows, ``DataFeeder.feed(pad_to=bound)``): real tokens/s of each
   and their ratio; 5 graphs; captured = eager over the four buckets;
   exact launches of #1-#6 in each bucket's replayed step (paths
   ``realdist:b16`` .. ``realdist:b64``); and ``realdist_check_b16`` /
   ``realdist_check_b64``, a float32 step of a whole bucket batch, card
   against CPU, at ``train_check``'s bands, and ``realdist_fault_tf32_b64``
   / ``realdist_fault_klen_b16``, the same check on a planted fault (TF32
   products, key lengths one short), which it must fail;
13. ``resnet_feed`` — ResNet-50 plain under AMP at batch 128 fed staged
   on the card, synchronously from the host, and through ``PyReader``
   (``DevicePrefetcher``), with float32 and with uint8 images: wall,
   device busy, wall minus busy and images/s of each; the prefetched
   losses are the synchronous arm's bits;
14. ``rec_sparse`` — bench.py's vocab A/B (``bench.py:583-639``): ids
   [64, 16] -> embedding (D 16) -> reduce_sum -> fc 32 relu -> fc 1,
   square loss, Adam(1e-3), at vocab 1e4, 1e5 and 1e6, ``is_sparse``
   against dense, 6 steps (2 warm-up) on the same id batches, captured and
   eager: wall and device busy a step, the peak memory a step allocates
   above the resident state, dense / sparse at each vocab and the sparse
   step's spread across vocab (reported, not gated); gates: captured =
   eager bit for bit, a warm sparse step at 1e6 allocates under a quarter
   of the table, the rows a step does not touch keep their bits (table and
   Adam moments), no hand kernel launches;
15. ``ctr_check``, ``ctr_sparse_vs_dense`` and ``ctr`` — ``models/
   ctr_dnn.py`` at full width over two 1e6-row tables: 3 Adam steps at
   batch 64, card against CPU (loss rtol 1e-4; the touched rows and the
   dense parameters relative L2 1e-4 at the median, 1e-2 each; the CPU
   taking the card's ReLU decisions); one Adagrad step at batch 512 with
   the sparse and with dense gradients, the same bits; then 200 Adam
   steps at batch 512 (1-16 dnn ids a row, padded to 16), captured =
   eager over the first 20, examples/s, busy, idle share, peak memory,
   the streaming AUC after 200 steps (> 0.85), no hand kernel launches;
16. ``resnext_check`` — ``resnet_check`` on SE-ResNeXt-50, NCHW fused,
   float32, dropout 0, the other runs taking the fused card step's ReLU
   decisions at the squeeze fcs; the same comparison with each run's own
   decisions and the units the fused step and the others decide
   differently are logged beside it (``resnext_check_phase``);
17. ``zoo`` — bench.py's image ladder (SmallNet, AlexNet, VGG-16,
   GoogLeNet, SE-ResNeXt-50) under AMP and in float32, captured = eager
   (``two_arm_run``), images/s, no hand kernel launches;
18. ``zoo_infer`` — the ``--infer`` rungs at batch 16 (ResNet-50 too,
   its batch norms calibrated on the first batch), float32 and bf16
   (``Bfloat16Transpiler``), captured = eager, bf16 within relative L1
   0.02 of float32 (ResNet-50, whose bf16 drift is ~0.13 on the CPU too:
   held against the same programs on the CPU), no hand kernel launches;
18b. ``zoo_infer_bn_folded`` and ``zoo_infer_predictor`` — ResNet-50's
   inference program after ``InferenceTranspiler`` (53 batch norms
   folded), captured = eager, its softmax within relative L1 1e-4 of the
   unfolded program's; the unfolded program saved and served by
   ``create_paddle_predictor(AnalysisConfig(model_dir))`` on
   ``CUDAPlace(0)`` and a clone, bit-equal to an executor's run of the
   saved program, images/s;
19. ``se_resnext_fused`` and ``se_resnext152`` — SE-ResNeXt-50 after
   ``fuse_conv_bn`` (#8 and #9 33 times a step each), float32 and AMP;
   BASELINE's SE-ResNeXt-152 under AMP at the largest batch up to 128
   that leaves 8 GB free;
19b. ``resnext_nhwc_check`` and ``se_resnext_nhwc_fused`` (between the
   two above) — ``resnext_check`` on the NHWC + fused program, then
   SE-ResNeXt-50 after ``convert_to_nhwc`` and ``fuse_conv_bn`` at batch
   128, float32 and AMP, captured = eager, one graph, #10 and #11 33
   times a step each and #8/#9 none; the program's 50 transposes and 49
   ``transpose_grad``s run alone under the profiler as the port runs
   them (``permute`` views, ``transpose_ops_ms``);
20. ``optimizers`` — bench.py's MLP under the six new optimizers, five
   LR schedules, ``append_LARS``, ``ModelAverage`` and QAT: 3 steps card
   against CPU at ``train_check``'s band, 20 steps captured = eager, no
   hand kernel launches;
21. ``rnn_check``, ``rnn_fault_length`` and ``rnn`` — bench.py's two RNN
   rungs: the stacked dynamic LSTM (batch 64 x 80 words, dict 5147, 512
   wide, 3 layers, the second reversed, Adam(1e-3)) and attention
   machine translation (64 x 30 tokens, dicts 30000, 512 wide, bi-LSTM
   encoder, ``DynamicRNN`` decoder: the ``recurrent`` op, Adam(1e-4)).
   First one step of each at a small width (dict 50, 32 wide, T 7,
   batch 4, ragged lengths), card against CPU at ``train_check``'s band
   (the CPU taking the card's max-pool decisions, ``max_decisions``),
   and again with the lengths one short on the card, which the check must
   fail.  Then each in float32 and under ``decorate``, captured = eager
   bit for bit (``two_arm_run``), words/s, wall, busy, idle share, top
   device events, peak memory, one graph an entry, the capture's
   seconds; #5 twice and #6 once a machine-translation step, no hand
   kernel in the LSTM;
22. ``cnn_ops`` — each op type of the CNN family (``conv3d``, the
   transposed convolutions, ``conv_shift``, adaptive ``pool2d`` /
   ``pool3d``, ``pool3d``, ``max_pool*_with_index``, ``spp``,
   ``unpool``, ``group_norm``, ``norm``, the two interpolations) as a
   one-op program on the card against the CPU, forward and gradients
   (``Mask``, the max picks, ``unpool`` with offsets out of the plane and
   ``nearest_interp`` bit for bit);
23. ``plain_ops`` — each of the 58 op types of the plain op library as a
   one-op program on the card (its second run a CUDA graph's replay,
   which must repeat the eager run's bits) against the CPU, the row ops
   at serving-logit shape [256, 32000], ``gather`` / ``scatter`` on a
   [32000, 512] table with 8192 repeated, negative and out-of-range ids:
   bool, integer, index and copied outputs bit for bit, the rest within
   rtol 1e-5 / atol 1e-6 (``cumsum`` within ``CUMSUM_BAND`` of the
   running sum of |x|), gradients within relative L2 1e-5; the four
   random ops by their moments, range and frequencies, captured = eager
   bit for bit; ``print`` on both devices; no hand kernel launches;
24. ``mnist_cnn_check``, ``mnist_cnn`` and ``mnist_cnn_print`` —
   ``models/mnist.py``'s conv net with its loss and accuracy written in
   the frontend (``Variable`` operators, ``argmax`` / ``equal`` /
   ``cast``): one step at batch 4 card against CPU within 3x the
   same-call floor; at bench.py's batch 256 under Adam(1e-3), captured
   = eager bit for bit over 20 steps (``two_arm_run``, deterministic
   algorithms; paths ``mnist_cnn`` and ``mnist_cnn:eager``, no hand
   kernel), images/s, idle share, peak memory, one graph; ``Trainer``
   epochs over a ``reader.batch`` reader with ``metrics.Accuracy``; a
   program holding a ``print`` op runs eagerly every time, never
   captured, and prints each run;
25. ``seq_ops`` — each of the 31 op types of the control-flow and
   sequence slice (no hand kernel) on the card against the CPU: the 29
   one-op types as one-op programs at machine translation's shapes
   ([64, 30, 512] sequences, ragged lengths with a zero, ``beam_search``
   on [16, 4, 30000] log-probs with planted ties, ``sequence_scatter``
   with repeated, negative and out-of-row ids), ``while`` (unbounded:
   three segments, its body graph replayed a trip; bounded with
   ``while_grad``) and ``conditional_block`` (taken and not, with its
   gradient) in programs: integer, bool and index outputs exact, floats
   within rtol 1e-5 / atol 1e-6 (the programs' fc outputs, 512-term
   sums, within relative L2 1e-5), gradients within relative L2 1e-5, all
   read from the card's second run, a replay of its CUDA graphs, which
   must repeat the eager run's bits; an unbounded ``while`` nested in a
   ``while`` body raises under capture and runs with ``capture=False``
   (equal to the CPU); no hand kernel launches;
26. ``beam`` — beam-search decoding at machine translation's width
   (``build_beam_decoder``: dicts 30000, 512 wide, an embedding and a
   ``DynamicRNN`` tanh-fc encoder, a ``StateCell`` with dot-product
   attention over the tiled encoder states, ``BeamSearchDecoder`` with
   beam 4, ``max_len`` 30, ``end_id`` 0) on 16 sentences of 30 tokens,
   float32, random weights of seed 1: captured and eager, each with two
   weight settings in one entry (the random weights, which run all 30
   trips, and the score bias at ``end_id`` raised by ``BEAM_END_BIAS`` in
   place, which finishes every beam after a few trips): captured = eager
   bit for bit in ids, scores and trips; one graph a segment and one body
   graph (3), a host flag read a trip, no hand kernel launch; card = CPU
   at batch 4 (ids equal, a parting allowed only under a top-two
   candidate gap of ``PARTING_GAP`` at some step of that sentence;
   scores within rtol 1e-4); ms a decode and a trip, sentences/s,
   beam-tokens/s, capture seconds, peak memory, and a profiled decode's
   idle share and top device events;
27. ``srl`` — the Paddle book's label_semantic_roles (``build_srl``:
   CoNLL-05's vocabularies, word_dim 32, mark_dim 5, hidden 512, depth 8,
   59 tags, the CRF cost, SGD on exponential decay) at the book's batch
   of 10 padded to 64 (lengths in [5, 64]), float32: ``srl_check`` (one
   step at batch 4, card against CPU at ``train_check``'s band), the step
   captured and eager over 20 steps (same bits, one graph, ms a step,
   real tokens/s, idle share, top device events, capture seconds, peak
   memory), 50 captured steps on one batch (the loss under ``SRL_FALL``
   of the first), the pruned ``crf_decoding`` program captured (paths
   equal the CPU's at batch 4) and a ``ChunkEvaluator`` over 5 batches
   (counts on the card equal to a numpy chunk count of the same paths);
   no hand kernel launches;
28. ``ssd`` — the SSD300 head at VOC width (``build_ssd``: SSD300's six
   feature maps fed as data, 8732 priors, 21 classes, ``ssd_loss`` against
   1-16 synthetic boxes an image, Momentum(1e-3, 0.9); inference decodes,
   softmaxes and runs ``multiclass_nms`` (0.01, top 400, 0.45, keep 200)
   into an 11-point ``DetectionMAP``) at batch 32 under deterministic
   algorithms: ``ssd_check`` (batch 2, card against CPU: the matching,
   assignment and mining outputs and the NMS rows exact, NMS scores rtol
   1e-5, loss rtol 1e-4, gradients at ``train_check``'s band, mAP equal),
   the training step and the inference batch captured and eager (same
   bits in the loss, the gradients, the NMS rows, ``OutLength`` and the
   mAP; #5 twice and #6 once a training step, from ``ssd_loss``'s
   ``softmax_with_cross_entropy``), the NMS op's share of the inference
   batch, mAP over 3 batches;
29. ``a4_ops`` — each of the slice's 27 op types card against CPU at its
   path's shape (``_a4_op_cases``; ``nce`` and random
   ``generate_proposal_labels`` by ``_a4_random_checks``), read from a
   replay that repeats the eager bits; no hand kernel launches.

Then the script's total seconds (``total``, with the seconds since the
previous log line summed by phase name), the kernel table as one JSON
line, the ``nvidia-smi`` line, and, as the last line, ``{"ok": true,
"device": {...}}``.  Any failure raises and
exits nonzero; without a CUDA device the script exits 2 and prints no
result.
"""

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12,
                  torch.int8: 1979e12}
# the tensor cores' TF32 rate: #1, #2 and #8-#11 take a float32 product as
# three TF32 passes, #7 (weight_only, whose int8 weight has no lo part) as
# two, so their float32 bound counts 3 x or 2 x the operations at it
TF32_OPS_PER_S = 495e12
REPO = os.path.dirname(os.path.abspath(__file__))

# the serving slice: Transformer-base widths, float32
MODEL = dict(vocab_size=32000, max_len=1024, slots=8, n_layer=6, n_head=8,
             d_model=512, d_inner=2048, dtype="float32")
N_REQUESTS, MAX_NEW = 16, 32
SERVE_PROMPTS = (64, 700)   # the served prompts' shortest and longest
# the paged slice (serve_paged): pages of 8 tokens (the default buckets
# 8..1024 are page-aligned), the default pool of 1024 pages (the fixed
# region's footprint), a 32-token system prompt shared by every request
# (4 full pages), speculative rounds of 4 tokens
PAGE_SIZE, SYSTEM_TOKENS, SPEC_K = 8, 32, 4
# the verify dispatch's key lengths (cache_len = base + SPEC_K; an
# inactive slot's is SPEC_K)
VERIFY_KLEN = [1024, 68, 704, SPEC_K, 337, 516, 1000, 36]

# tolerances (allclose: |kernel - plain| <= atol + rtol * |plain|).
# float32: both sum ~1e3 terms in float32 in different orders.  bfloat16:
# the kernel rounds the probabilities to bf16 before normalizing, the
# plain version after (as the JAX kernel and reference do), and each
# output is then rounded to bf16: a few bf16 ulps (2^-8 relative).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# outputs whose entries are probabilities of a 32000-way softmax (~3e-5
# each) and their gradients: the same relative terms, an absolute term
# below the values themselves
TOL_P = {torch.float32: (1e-7, 1e-4), torch.bfloat16: (1e-5, 2e-2)}

# the training slice: bench.py's Transformer-base configuration
TRAIN = dict(n_layer=6, n_head=8, d_model=512, d_inner=2048)
TRAIN_VOCAB, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 32000, 64, 256, 5


_T0 = time.perf_counter()
# seconds from the previous log line to each line, summed by phase name
PHASE_SECONDS = {}
_LAST = [0.0]


def log(phase, payload):
    at = time.perf_counter() - _T0
    PHASE_SECONDS[phase] = PHASE_SECONDS.get(phase, 0.0) + at - _LAST[0]
    _LAST[0] = at
    if isinstance(payload, dict):
        payload = dict(payload, at_s=at)
    print("%s: %s" % (phase, json.dumps(payload)), flush=True)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


class Timer:
    """Median device time of one call, from CUDA events around each
    launch, with the 50 MB L2 evicted before every launch (the serving
    loop touches every layer's weights and cache between two calls of one
    kernel on the same data)."""

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=15, warmup=2, queued=False):
        """``queued``: a spin kernel of ~60 us runs after the flush, so
        that ``fn``'s launches are queued before the card reaches them and
        its host path stays out of the reading."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        for start, end in events:
            self.flush.zero_()
            if queued:
                torch.cuda._sleep(100_000)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(got, want, dtype, tol=TOL):
    atol, rtol = tol[dtype]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all()) \
        and bool(torch.isfinite(got).all())
    return float(err.max()), ok


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_case(fa, timer, name, tq, tk, causal, klen, dtype,
                   rate=0.0, seed=None, split=False):
    from torch.nn.functional import scaled_dot_product_attention

    b, h, d = len(klen), 8, 64
    g = torch.Generator(device="cuda").manual_seed(len(name))
    q, k, v = (torch.randn((b, h, t, d), generator=g, device="cuda")
               .to(dtype) for t in (tq, tk, tk))
    kl = torch.tensor(klen, dtype=torch.int32, device="cuda")
    # the dropout seed is device data, as the executor hands it over
    seed = None if seed is None else fa.seed_tensor(seed, "cuda")
    args = (q, k, v, kl, seed, causal, rate)
    out, lse = fa.flash_attention_fwd(*args)
    again = fa.flash_attention_fwd(*args)
    want = fa.reference_attention(*args)
    torch.cuda.synchronize()
    err, ok = max_err(out, want, dtype)
    # the decode split combines its ranks in a fixed order: the same bits
    # every launch
    same_bits = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    # the cluster the kernel launched with, against the wrapper's planner
    from paddle_tpu_torch.ops.cuda import build
    cluster = build.library(
        "flash_attention_fwd").ptt_flash_attention_fwd_cluster(b, h, tq, tk)
    planned = fa._split_cluster(b, h, tq, tk)
    calls = kernel_calls(lambda: fa.flash_attention_fwd(*args))
    ok = ok and same_bits and cluster == planned and sum(calls.values()) == 1
    # a case meant for the key split must take it
    ok = ok and (cluster > 1 or not split)
    # fully masked rows: zeros and the +1e30 LSE sentinel
    empty = (kl == 0).nonzero().flatten().tolist()
    for i in empty:
        ok = ok and bool((out[i] == 0).all()) and bool((lse[i] == 1e30).all())
    ok = ok and bool(torch.isfinite(lse[kl > 0]).all())

    valid, pairs, keys = _pairs_and_keys(b, h, tq, tk, causal, kl)
    item = q.element_size()
    nbytes = (q.numel() * item + 2 * keys * d * item + out.numel() * item
              + lse.numel() * 4 + kl.numel() * 4)
    bound_ms, bound_by, bound_simt = tf32_bound(nbytes, 4 * d * pairs, dtype)

    library_ms = library_dev = None
    if not rate:
        scale = 1.0 / d ** 0.5

        def lib():
            scaled_dot_product_attention(q, k, v, attn_mask=valid,
                                         scale=scale)
        library_ms = timer(lib)
        library_dev = device_ms(library_kernels(lib))
    res = {"check": name, "q": list(q.shape), "k": list(k.shape),
           "dtype": str(dtype).replace("torch.", ""), "causal": causal,
           "dropout": rate, "klen": list(klen)[:8], "cluster": cluster,
           "cluster_planned": planned, "repeatable_bits": same_bits,
           "device_kernel_calls": calls,
           "max_abs_err": err, "tol": TOL[dtype],
           "kernel_ms": timer(lambda: fa.flash_attention_fwd(*args)),
           "device_ms": device_ms(library_kernels(
               lambda: fa.flash_attention_fwd(*args))),
           "plain_ms": timer(lambda: fa.reference_attention(*args), iters=5),
           "library_ms": library_ms, "library_device_ms": library_dev,
           "bound_ms": bound_ms,
           "bound_by": bound_by, "ok": ok}
    if bound_simt is not None:
        res.update(bound_rate="3xTF32", bound_simt_ms=bound_simt)
    return res


def host_us(fn, calls=200):
    """Host microseconds a call of ``fn`` takes to return (its launches
    enqueued, not run): the wrapper's own path, which a launch-bound
    caller waits for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


def layer_norm_case(ln, timer, n, d, dtype):
    """Kernel #3 against ``layer_norm_reference`` and twice against
    itself (each row's sums are one warp's, in a fixed order: the same
    bits), with the plan it launched with (``ptt_layer_norm_fwd_plan``).
    Also the host time of a wrapper call and of ``F.layer_norm``'s
    (``host_us``)."""
    import ctypes

    from torch.nn.functional import layer_norm
    from paddle_tpu_torch.ops.cuda import build

    g = torch.Generator(device="cuda").manual_seed(n)
    x = (torch.randn((n, d), generator=g, device="cuda") * 3 + 1).to(dtype)
    gamma = torch.randn((d,), generator=g, device="cuda").to(dtype)
    beta = torch.randn((d,), generator=g, device="cuda").to(dtype)
    got = ln.layer_norm_fwd(x, gamma, beta, 1e-5)
    again = ln.layer_norm_fwd(x, gamma, beta, 1e-5)
    want = ln.layer_norm_reference(x, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    errs = [max_err(a, b, dtype) for a, b in zip(got, want)]
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    item = x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, gamma, beta, got[0]))
    out = (ctypes.c_int * 5)()
    build.check(build.library("layer_norm_fwd").ptt_layer_norm_fwd_plan(
        n, d, ln._DTYPE_CODE[dtype], int(aligned), x.device.index, out),
        "ptt_layer_norm_fwd_plan")
    nbytes = 2 * x.numel() * item + 2 * d * item + 2 * n * 4
    bound_ms, bound_by = bound(nbytes, 8 * n * d, dtype)
    return {"check": "layer_norm_%dx%d" % (n, d), "x": [n, d],
            "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": max(e for e, _ in errs), "tol": TOL[dtype],
            "repeatable_bits": same_bits,
            "plan": list(out[:3]), "sms_blocks_an_sm": list(out[3:5]),
            "kernel_ms": timer(lambda: ln.layer_norm_fwd(x, gamma, beta,
                                                         1e-5)),
            "device_ms": device_ms(library_kernels(
                lambda: ln.layer_norm_fwd(x, gamma, beta, 1e-5))),
            "plain_ms": timer(lambda: ln.layer_norm_reference(
                x, gamma, beta, 1e-5)),
            "library_ms": timer(lambda: layer_norm(x, (d,), gamma, beta,
                                                   1e-5)),
            "library_device_ms": device_ms(library_kernels(
                lambda: layer_norm(x, (d,), gamma, beta, 1e-5))),
            # the same two readings with the launches queued behind a
            # spin kernel: at a few rows the plain reading can hold the
            # wrapper's host path, which ``host_us`` gives apart
            "kernel_ms_queued": timer(lambda: ln.layer_norm_fwd(
                x, gamma, beta, 1e-5), queued=True),
            "library_ms_queued": timer(lambda: layer_norm(
                x, (d,), gamma, beta, 1e-5), queued=True),
            # the same bytes through a device-to-device copy: what the
            # card and this timer give a pass that reads x and writes y
            "copy_ms": timer(lambda: got[0].copy_(x)),
            "host_us": host_us(lambda: ln.layer_norm_fwd(x, gamma, beta,
                                                         1e-5)),
            "library_host_us": host_us(lambda: layer_norm(
                x, (d,), gamma, beta, 1e-5)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "ok": all(ok for _, ok in errs) and same_bits}


def _pairs_and_keys(b, h, tq, tk, causal, kl):
    """The boolean mask [B,1,Tq,Tk] of the (query, key) pairs the klen and
    causal masks keep, their count over all heads, and the count of keys
    any query of a row reads (what this run's data needs)."""
    gq = torch.arange(tq, device="cuda")[:, None]
    gk = torch.arange(tk, device="cuda")[None, :]
    klc = kl.long().clamp(max=tk).reshape(b, 1, 1, 1)
    valid = gk < klc
    if causal:
        valid = valid & ((gq >= gk) if tq == tk else (gq + klc - tq >= gk))
    return valid, int(valid.sum()) * h, int(valid.any(dim=2).sum()) * h


# seconds a profiled window waits after the profiler starts before it
# runs anything: kernels launched at once were now and then missing from
# the trace (a serving window lost most of its first dispatch's), while
# none went missing once the profiler had this long to settle
TRACE_SETTLE_S = 0.05
# and may still drop the first records of a window: late in a whole run
# (past ~400 s) a captured inference pass's window lost its first 21-32
# device records every time (all of SmallNet's), the eager pass's none.
# Each ``device_window`` first runs this many tiny spin kernels
# (``torch.cuda._sleep``), which take such a loss and are left out of
# its counts by name; ``pads_traced`` reports how many the trace kept
# (0-41 lost a window over a whole run, once all 128 with every record
# of the window's own work kept: NVIDIA H100 80GB HBM3)
TRACE_PADS = 128


def _device_kernels(fn, tries=3):
    """The device kernels one call of ``fn`` runs, as ``torch.profiler``'s
    averages (after a warm-up call).  A window that recorded no device
    event at all is a profiler miss (it happens now and then), not a call
    that ran nothing: it is profiled again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_SETTLE_S)
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0)) > 0]
        if kernels:
            break
    return kernels


def library_kernels(fn):
    """The device kernels one call of ``fn`` runs, {name: device us}: which
    backend a library call took."""
    return {e.key[:100]: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
            for e in _device_kernels(fn)}


def kernel_calls(fn):
    """{device kernel name: launches} of one call of ``fn``: how many
    kernels a wrapper call runs."""
    return {e.key[:100]: e.count for e in _device_kernels(fn)}


def device_ms(kernels):
    """Device time of one call, ms: the sum of the kernels it ran (a
    ``library_kernels`` dict).  The like-for-like reading beside a
    library call's, whose CUDA-event time also counts the host's gaps
    between its launches."""
    return sum(kernels.values()) / 1e3


def attention_bwd_case(fa, timer, name, tq, tk, causal, klen, dtype,
                       rate=0.0, seed=None):
    """Kernel #2 against ``attention_bwd_reference`` on the kernel
    forward's O and LSE, and twice against itself; the library yardstick
    is the backward of ``scaled_dot_product_attention`` under the same
    boolean mask."""
    from torch.nn.functional import scaled_dot_product_attention

    b, h, d = len(klen), 8, 64
    g = torch.Generator(device="cuda").manual_seed(len(name) + 101)
    q, k, v, dout = (torch.randn((b, h, t, d), generator=g, device="cuda")
                     .to(dtype) for t in (tq, tk, tk, tq))
    kl = torch.tensor(klen, dtype=torch.int32, device="cuda")
    seed = None if seed is None else fa.seed_tensor(seed, "cuda")
    out, lse = fa.flash_attention_fwd(q, k, v, kl, seed, causal, rate)
    args = (q, k, v, kl, seed, causal, rate, None, out, lse, dout)
    got = fa.flash_attention_bwd(*args)
    again = fa.flash_attention_bwd(*args)
    want = fa.attention_bwd_reference(*args)
    torch.cuda.synchronize()
    errs = [max_err(a, w, dtype) for a, w in zip(got, want)]
    # no atomics (dQ's key-tile parts are added in a fixed order): the
    # same bits every launch
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = all(o for _, o in errs) and same_bits
    # fully masked rows: zero gradients, never NaN
    for i in (kl == 0).nonzero().flatten().tolist():
        ok = ok and all(bool((t[i] == 0).all()) for t in got)
    valid, pairs, keys = _pairs_and_keys(b, h, tq, tk, causal, kl)
    item = q.element_size()
    nbytes = (3 * q.numel() * item + 2 * keys * d * item + lse.numel() * 4
              + kl.numel() * 4 + q.numel() * item + 2 * k.numel() * item)
    # S and G recomputed once, then dQ, dK and dV: five products a pair
    bound_ms, bound_by = bound(nbytes, 10 * d * pairs, dtype)

    library_ms, library = None, {}
    if not rate and bool((kl > 0).all()):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o = scaled_dot_product_attention(*leaves, attn_mask=valid,
                                         scale=1.0 / d ** 0.5)

        def lib():
            torch.autograd.grad(o, leaves, dout, retain_graph=True)
        library_ms = timer(lib)
        lib_kernels = library_kernels(lib)
        library = {"library_kernels": lib_kernels,
                   "library_device_ms": device_ms(lib_kernels),
                   "library_ms_again": timer(lib)}
    # the kernels one wrapper call runs on the device, by name: what of
    # its time is the kernel itself and what the wrapper's own launches
    kernels = library_kernels(lambda: fa.flash_attention_bwd(*args))
    return dict(library, **{"check": name, "q": list(q.shape), "k": list(k.shape),
            "dtype": str(dtype).replace("torch.", ""), "causal": causal,
            "dropout": rate, "klen_zero_rows": int((kl == 0).sum()),
            "repeatable_bits": same_bits,
            "max_abs_err": max(e for e, _ in errs), "tol": TOL[dtype],
            "max_abs_plain": max(float(w.float().abs().max()) for w in want),
            "kernel_ms": timer(lambda: fa.flash_attention_bwd(*args)),
            "device_ms": device_ms(kernels), "device_kernels": kernels,
            "plain_ms": timer(lambda: fa.attention_bwd_reference(*args),
                              iters=5),
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "ok": ok})


def layer_norm_bwd_case(ln, timer, n, d, dtype):
    """Kernel #4 against ``layer_norm_bwd_reference``, and twice against
    itself: dgamma/dbeta are reduced without atomics, so the bits repeat.
    The library yardstick is the backward of ``F.layer_norm``."""
    from torch.nn.functional import layer_norm

    g = torch.Generator(device="cuda").manual_seed(n + 1)
    x = (torch.randn((n, d), generator=g, device="cuda") * 3 + 1).to(dtype)
    gamma, beta = (torch.randn((d,), generator=g, device="cuda").to(dtype)
                   for _ in range(2))
    dy = torch.randn((n, d), generator=g, device="cuda").to(dtype)
    _, mean, var = ln.layer_norm_fwd(x, gamma, beta, 1e-5)
    rstd = torch.rsqrt(var + 1e-5)
    args = (x, gamma, mean, rstd, dy)
    got = ln.layer_norm_bwd(*args)
    again = ln.layer_norm_bwd(*args)
    want = ln.layer_norm_bwd_reference(*args)
    torch.cuda.synchronize()
    errs = [max_err(a, w, dtype) for a, w in zip(got, want)]
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    item = x.element_size()
    nbytes = 3 * x.numel() * item + 3 * d * item + 2 * n * 4
    bound_ms, bound_by = bound(nbytes, 13 * n * d, dtype)
    leaves = [t.detach().clone().requires_grad_() for t in (x, gamma, beta)]
    y = layer_norm(leaves[0], (d,), leaves[1], leaves[2], 1e-5)

    def lib():
        torch.autograd.grad(y, leaves, dy, retain_graph=True)
    kernels = library_kernels(lambda: ln.layer_norm_bwd(*args))
    lib_kernels = library_kernels(lib)
    return {"check": "layer_norm_bwd_%dx%d" % (n, d), "x": [n, d],
            "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": max(e for e, _ in errs), "tol": TOL[dtype],
            "repeatable_bits": same_bits,
            "kernel_ms": timer(lambda: ln.layer_norm_bwd(*args)),
            "device_ms": device_ms(kernels), "device_kernels": kernels,
            "plain_ms": timer(lambda: ln.layer_norm_bwd_reference(*args)),
            "library_ms": timer(lib), "library_kernels": lib_kernels,
            "library_device_ms": device_ms(lib_kernels),
            "library_ms_again": timer(lib),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "ok": all(o for _, o in errs) and same_bits}


def softmax_xent_cases(sx, timer, n, c, eps, dtype):
    """Kernel #5, and kernel #6 without and with the softmax cotangent,
    against their plain versions.  One label lies past C: it must pick 0
    and read nothing out of bounds.  The library yardstick is
    ``F.cross_entropy(..., label_smoothing=eps, reduction="none")`` (same
    loss formula, no softmax output) and its backward, on in-range
    labels."""
    from torch.nn.functional import cross_entropy

    tag = str(dtype).replace("torch.", "")
    g = torch.Generator(device="cuda").manual_seed(c)
    logits = (torch.randn((n, c), generator=g, device="cuda") * 2).to(dtype)
    label = torch.randint(0, c, (n,), generator=g, device="cuda")
    label_in = label.clone()
    label[n // 2] = c + 3
    loss, sm = sx.softmax_xent_fwd(logits, label, eps)
    again = sx.softmax_xent_fwd(logits, label, eps)
    want_loss, want_sm = sx.softmax_xent_reference(logits, label, eps)
    torch.cuda.synchronize()
    errs = [max_err(loss, want_loss, dtype), max_err(sm, want_sm, dtype,
                                                     TOL_P)]
    # the cluster's partials meet in rank order: the same bits every launch
    same_bits = torch.equal(loss, again[0]) and torch.equal(sm, again[1])
    del again
    item = logits.element_size()
    # the plan the wrapper launched with
    plan = list(sx._fwd_plan(n, c, item, torch.cuda.get_device_properties(
        0).multi_processor_count))
    nbytes = 2 * logits.numel() * item + n * 8 + n * item
    bound_ms, bound_by = bound(nbytes, 6 * n * c, dtype)
    lib_leaf = logits.detach().clone().requires_grad_()
    lib_loss = cross_entropy(lib_leaf, label_in, label_smoothing=eps,
                             reduction="none")
    fwd = {"check": "softmax_xent_fwd_%dx%d_%s" % (n, c, tag),
           "logits": [n, c], "dtype": tag, "eps": eps,
           "plan": plan, "path": "streaming" if plan[0] == 0 else "cluster",
           "repeatable_bits": same_bits,
           "max_abs_err": max(e for e, _ in errs),
           "tol": {"loss": TOL[dtype], "softmax": TOL_P[dtype]},
           "kernel_ms": timer(lambda: sx.softmax_xent_fwd(logits, label,
                                                          eps)),
           # the launches queued behind a spin kernel: the wrapper's host
           # path out of the reading
           "kernel_ms_queued": timer(lambda: sx.softmax_xent_fwd(
               logits, label, eps), queued=True),
           "device_ms": device_ms(library_kernels(
               lambda: sx.softmax_xent_fwd(logits, label, eps))),
           "plain_ms": timer(lambda: sx.softmax_xent_reference(
               logits, label, eps), iters=5),
           "library_ms": timer(lambda: cross_entropy(
               logits, label_in, label_smoothing=eps, reduction="none")),
           "library_device_ms": device_ms(library_kernels(
               lambda: cross_entropy(logits, label_in, label_smoothing=eps,
                                     reduction="none"))),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "ok": all(o for _, o in errs) and same_bits}
    del want_loss, want_sm

    bwd = []
    dloss = torch.randn((n, 1), generator=g, device="cuda").to(dtype)
    for with_dsm in (False, True):
        dsm = (torch.randn((n, c), generator=g, device="cuda").to(dtype)
               if with_dsm else None)
        args = (sm, label, dloss, dsm, eps)
        got = sx.softmax_xent_bwd(*args)
        err, ok = max_err(got, sx.softmax_xent_bwd_reference(*args), dtype,
                          TOL_P)
        del got
        nbytes = ((3 if with_dsm else 2) * sm.numel() * item + n * 8
                  + n * item)
        bound_ms, bound_by = bound(nbytes, (7 if with_dsm else 3) * n * c,
                                   dtype)
        library_ms = library_dev = None
        if not with_dsm:
            def lib():
                torch.autograd.grad(lib_loss, [lib_leaf], dloss.reshape(n),
                                    retain_graph=True)
            library_ms = timer(lib)
            library_dev = device_ms(library_kernels(lib))
        bwd.append({
            "check": "softmax_xent_bwd_%dx%d_%s%s" % (
                n, c, tag, "_dsm" if with_dsm else ""),
            "logits": [n, c], "dtype": tag, "eps": eps, "dsm": with_dsm,
            "max_abs_err": err, "tol": TOL_P[dtype],
            "kernel_ms": timer(lambda: sx.softmax_xent_bwd(*args)),
            "device_ms": device_ms(library_kernels(
                lambda: sx.softmax_xent_bwd(*args))),
            "plain_ms": timer(lambda: sx.softmax_xent_bwd_reference(*args),
                              iters=5),
            "library_ms": library_ms, "library_device_ms": library_dev,
            "bound_ms": bound_ms, "bound_by": bound_by, "ok": ok})
        del dsm, args
    del logits, sm, lib_leaf, lib_loss
    torch.cuda.empty_cache()
    return fwd, bwd


def quant_matmul_case(qm, timer, m, k, n, mode, dtype, xscale=None):
    """Kernel #7 against ``dequant_matmul_reference``.  weight_only within
    TOL (float32 sums in another order); dynamic: the int8 grid qx, its
    scales sx and the int32 accumulator must equal the plain version's bit
    for bit (the output follows from them).  The library yardstick is
    ``torch.matmul`` on a weight dequantized beforehand (the float32 path
    int8 replaces) for weight_only, and ``torch._int_mm`` (the int32
    product alone) for dynamic where it takes the shape."""
    tag = str(dtype).replace("torch.", "")
    g = torch.Generator(device="cuda").manual_seed(m * 7 + k * 3 + n)
    x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
    w = torch.randn((k, n), generator=g, device="cuda") * 0.05
    scale = torch.clamp(w.abs().amax(dim=0), min=1e-12) / 127.0
    qw = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    del w
    xs = (None if xscale is None
          else torch.tensor([xscale], dtype=torch.float32, device="cuda"))
    name = "%s_%dx%dx%d_%s%s" % (mode, m, k, n, tag,
                                 "_xscale" if xscale is not None else "")
    # the K split the kernel takes, against the wrapper's planner
    from paddle_tpu_torch.ops.cuda import build
    gemv, planned, _ = qm._k_splits(m, n, k)
    planned = planned if gemv else 0
    splits = build.library("quant_matmul").ptt_dequant_matmul_splits(
        m, n, k, int(mode == "dynamic"))
    res = {"check": name, "mnk": [m, k, n], "mode": mode, "dtype": tag,
           "xscale": xscale, "splits": splits, "splits_planned": planned}
    want = qm.dequant_matmul_reference(x, qw, scale, mode, xs)
    if mode == "dynamic":
        out, qx, sx, acc = qm.dequant_matmul_kernel(x, qw, scale, mode, xs,
                                                    parts=True)
        again = qm.dequant_matmul_kernel(x, qw, scale, mode, xs, parts=True)
        pqx, psx = qm.quantize_rows_reference(x, xs)
        pacc = qm.int8_matmul_reference(pqx, qw)
        torch.cuda.synchronize()
        res["grid_bit_exact"] = bool(
            torch.equal(qx, pqx)
            and torch.equal(sx, psx.reshape(-1).expand(m))
            and torch.equal(acc, pacc))
        res["out_bit_exact"] = bool(torch.equal(out, want))
        same_bits = all(torch.equal(a, b)
                        for a, b in zip((out, qx, sx, acc), again))
        ok = res["grid_bit_exact"]
        del qx, sx, acc, pqx, pacc, again
    else:
        out = qm.dequant_matmul_kernel(x, qw, scale, mode, xs)
        again = qm.dequant_matmul_kernel(x, qw, scale, mode, xs)
        torch.cuda.synchronize()
        # the K split's partial sums are added in rank order
        same_bits = torch.equal(out, again)
        ok = True
        del again
    # one device kernel a call; the dynamic prefill runs its row grid first
    calls = kernel_calls(lambda: qm.dequant_matmul_kernel(x, qw, scale, mode,
                                                          xs))
    want_calls = 1 if gemv or mode == "weight_only" else 2
    err, close = max_err(out, want, torch.float32)
    res.update(max_abs_err=err, tol=TOL[torch.float32],
               repeatable_bits=same_bits, device_kernel_calls=calls,
               ok=(ok and close and same_bits and splits == planned
                   and sum(calls.values()) == want_calls))
    del out, want
    nbytes = m * k * x.element_size() + k * n + 4 * n + 4 * m * n
    ops = 2.0 * m * k * n
    if mode == "dynamic":
        bound_ms, bound_by = bound(nbytes, ops, torch.int8)
    elif dtype == torch.float32:
        # x_hi w + x_lo w: two TF32 passes (the int8 weight has no lo part)
        bound_ms, bound_by, simt = tf32_bound(nbytes, ops, dtype, passes=2)
        res.update(bound_rate="2xTF32", bound_simt_ms=simt)
    else:
        # one bfloat16 / float16 pass at the tensor cores' 16-bit rate
        bound_ms, bound_by = bound(nbytes, ops, torch.bfloat16)
    res.update(bound_ms=bound_ms, bound_by=bound_by,
               kernel_ms=timer(lambda: qm.dequant_matmul_kernel(
                   x, qw, scale, mode, xs)),
               device_ms=device_ms(library_kernels(
                   lambda: qm.dequant_matmul_kernel(x, qw, scale, mode,
                                                    xs))),
               plain_ms=timer(lambda: qm.dequant_matmul_reference(
                   x, qw, scale, mode, xs), iters=5))
    lib = None
    if mode == "weight_only":
        w_deq = qw.float() * scale
        xf = x.float()

        def lib():
            torch.matmul(xf, w_deq)
        res["library"] = "torch.matmul(x_f32, w_dequantized_f32)"
    else:
        qx_lib = qm.quantize_rows_reference(x, xs)[0]
        try:
            torch._int_mm(qx_lib, qw)

            def lib():
                torch._int_mm(qx_lib, qw)
            res["library"] = "torch._int_mm(qx, qw): the int32 product alone"
        except RuntimeError as e:   # the yardstick does not take the shape
            res["library"] = "none (torch._int_mm: %s)" % str(e)[:80]
    res["library_ms"] = None if lib is None else timer(lib)
    res["library_device_ms"] = (None if lib is None
                                else device_ms(library_kernels(lib)))
    del lib
    torch.cuda.empty_cache()
    return res


def quant_matmul_cases(qm, timer):
    """Kernel #7 at the serving slice's shapes (decode M = 8 against each
    weight, the logits projection first; prefill M = 4096 = 8 slots x the
    512 bucket), then off-path cases: a ragged shape, K < 128, bfloat16 and
    float16 activations and the static XScale."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    cases = []
    for mode in ("weight_only", "dynamic"):
        for k, n in ((512, 32000), (512, 512), (512, 2048), (2048, 512)):
            cases.append((8, k, n, mode, f32, None))
        cases.append((4096, 512, 32000, mode, f32, None))
        cases += [(5, 130, 200, mode, f32, None),
                  (5, 130, 200, mode, bf16, None),
                  (8, 40, 512, mode, f32, None),
                  (8, 512, 32000, mode, bf16, None)]
    # the decode kernel's 16- and 32-row blocks, K split past a stage edge
    cases += [(13, 512, 2048, "weight_only", f32, None),
              (29, 520, 512, "dynamic", f32, None),
              (8, 512, 2048, "weight_only", f16, None),
              (8, 512, 2048, "dynamic", f16, None),
              (8, 512, 2048, "dynamic", f32, 3.0),
              (5, 130, 200, "dynamic", bf16, 3.0)]
    return [quant_matmul_case(qm, timer, *c) for c in cases]


# the fused conv+BN layers of ResNet-50 at batch 128: (B, C, O, HW)
CONV_BN_STAGES = {"stage1": (128, 64, 256, 3136),
                  "stage3": (128, 256, 1024, 196),
                  "stage4": (128, 2048, 512, 49),
                  # off the path: every NHWC tile edge ragged, C and O not
                  # multiples of the 128-wide tile, C not of the k tile
                  "ragged": (1, 72, 200, 1000),
                  # the same in NCHW: 147 positions, HW 49 straddles the
                  # 16-byte chunks of positions and the images the tiles
                  "ragged_hw49": (3, 72, 200, 49),
                  # SE-ResNeXt-50's fused layers at batch 128, inner widths
                  # twice ResNet-50's: stage 1's conv2 (BN + ReLU prologue)
                  # and conv0 (raw), stage 4's conv2
                  "rx_s1_conv2": (128, 128, 256, 3136),
                  "rx_s1_conv0": (128, 256, 128, 3136),
                  "rx_s4_conv2": (128, 1024, 2048, 49)}
# the SE-ResNeXt-50 cases of kernels #8/#9 (NCHW, the fused program's
# layout) and #10/#11 (NHWC, the NHWC + fused program's): (stage,
# apply_bn); every one folds the next BN's stats backward
SE_CONV_BN_CASES = (("rx_s1_conv2", True), ("rx_s1_conv0", False),
                    ("rx_s4_conv2", True))
# allclose with a magnitude term: |kernel - plain| <= rtol |plain| +
# scale_tol * scale, where scale is the sum of the absolute values of the
# terms each output sums (|W| @ |xn| for z); the two sum ~1e2-4e5 terms in
# different orders.  bfloat16: z and dx are rounded to bf16 (rtol 1e-2),
# and an operand the two round to bf16 from float32 values one ulp apart
# may differ by a bf16 ulp (the scale term).
CONV_BN_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 1e-3)}


def tf32_bound(nbytes, ops, dtype, passes=3):
    """(bound ms, by, the float32 units' bound ms or None): a kernel that
    takes float32 on the tensor cores as ``passes`` TF32 passes (#1, #2,
    #8-#11: three; #7: two) is bound at passes x operations / 495 TFLOP/s,
    with the float32 units' bound beside it."""
    bound_ms, bound_by = bound(nbytes, ops, dtype)
    if dtype != torch.float32:
        return bound_ms, bound_by, None
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, passes * ops / TF32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops
            else "operations (%dxTF32)" % passes, bound_ms)


def _close(got, want, scale, dtype, f32_out=False):
    rtol, stol = CONV_BN_TOL[dtype]
    if f32_out:
        rtol = CONV_BN_TOL[torch.float32][0]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= rtol * want.abs() + stol * scale.float()).all()) \
        and bool(torch.isfinite(got).all())
    return float(err.max()), ok


def _conv_bn_inputs(b, c, o, hw, nhwc, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = (rnd(*((b * hw, c) if nhwc else (b, c, hw))) + 0.5).to(dtype)
    w = (rnd(o, c) / c ** 0.5).to(dtype)
    mean = rnd(c) * 0.1 + 0.5
    rstd = torch.rand(c, generator=g, device="cuda") + 0.5
    gamma = torch.rand(c, generator=g, device="cuda") + 0.5
    beta = rnd(c) * 0.1
    shift = rnd(o) * 0.1
    return g, x, w, mean, rstd, gamma, beta, shift


def _conv_bn_prologue(cb, x, mean, rstd, gamma, beta, apply_bn, nhwc):
    """xn as the kernels feed it to the product (rounded to x's dtype),
    and the view that broadcasts a channel vector."""
    view = (1, -1) if nhwc else (1, -1, 1)
    act = "relu" if apply_bn else ""
    return cb._act_norm(x, mean, rstd, gamma, beta, act, apply_bn,
                        view).to(x.dtype), view


def conv_bn_fwd_case(cb, timer, stage, nhwc, apply_bn, dtype):
    """Kernel #8 (NCHW) or #10 (NHWC) against ``bn_act_matmul_reference``,
    and twice against itself (the stats are reduced without atomics).
    ``apply_bn``: the BN-apply + ReLU prologue; else the raw input.  The
    library yardstick computes less: ``F.conv2d`` 1x1 (NCHW) or
    ``torch.matmul`` (NHWC) on an input normalised beforehand, no stats."""
    from torch.nn.functional import conv2d

    b, c, o, hw = CONV_BN_STAGES[stage]
    _, x, w, mean, rstd, gamma, beta, shift = _conv_bn_inputs(
        b, c, o, hw, nhwc, dtype, seed=c + o)
    act = "relu" if apply_bn else ""
    args = (x, w, mean, rstd, gamma, beta, shift, act, apply_bn, True)
    kern = cb.conv_bn_fwd_nhwc if nhwc else cb.conv_bn_fwd
    got = kern(*args)
    again = kern(*args)
    want = cb.bn_act_matmul_reference(*args, nhwc=nhwc)
    xn, view = _conv_bn_prologue(cb, x, mean, rstd, gamma, beta, apply_bn,
                                 nhwc)
    pos = (0,) if nhwc else (0, 2)
    absprod = cb.bn_act_matmul_reference(xn.abs(), w.abs(), None, None, None,
                                         None, None, "", False, False,
                                         nhwc=nhwc)[0].float()
    zc = want[0].float() - shift.view(view)
    scales = [absprod, (zc.abs() + absprod).sum(dim=pos),
              (zc * zc + 2 * zc.abs() * absprod).sum(dim=pos)]
    del absprod, zc
    torch.cuda.synchronize()
    errs = [_close(gt, wt, sc, dtype, f32_out=i > 0)
            for i, (gt, wt, sc) in enumerate(zip(got, want, scales))]
    same_bits = all(torch.equal(a_, b_) for a_, b_ in zip(got, again))
    del got, again, want, scales
    n, item = b * hw, x.element_size()
    bound_ms, bound_by, bound_simt = tf32_bound(
        n * c * item + n * o * item + o * c * item, 2.0 * n * c * o, dtype)
    if nhwc:
        wt = w.t()
        library = "torch.matmul(xn, w.t()) on xn normalised beforehand"

        def lib():
            torch.matmul(xn, wt)
    else:
        xn4, w4 = xn.reshape(b, c, hw, 1), w.reshape(o, c, 1, 1)
        library = "F.conv2d 1x1 on xn normalised beforehand"

        def lib():
            conv2d(xn4, w4)
    tag = str(dtype).replace("torch.", "")
    res = {"check": "%s_%s_%s_%s" % ("nhwc" if nhwc else "nchw", stage,
                                     "bn_relu" if apply_bn else "raw", tag),
           "bcoh": [b, c, o, hw], "nhwc": nhwc, "apply_bn": apply_bn,
           "dtype": tag, "max_abs_err": max(e for e, _ in errs),
           "max_abs_err_z_sum_sumsq": [e for e, _ in errs],
           "tol": CONV_BN_TOL[dtype], "repeatable_bits": same_bits,
           "kernel_ms": timer(lambda: kern(*args)),
           "device_ms": device_ms(library_kernels(lambda: kern(*args))),
           "plain_ms": timer(lambda: cb.bn_act_matmul_reference(
               *args, nhwc=nhwc), iters=5),
           "library_ms": timer(lib), "library": library,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "ok": all(ok for _, ok in errs) and same_bits}
    if bound_simt is not None:
        res["bound_simt_ms"] = bound_simt
    del xn, lib
    torch.cuda.empty_cache()
    return res


def conv_bn_bwd_case(cb, timer, stage, nhwc, apply_bn, with_stats, dtype):
    """Kernel #9 (NCHW) or #11 (NHWC) against
    ``bn_act_matmul_bwd_reference``, and twice against itself (dW, dgamma
    and dbeta are reduced in a fixed order).  ``with_stats``: the stats'
    cotangents are folded into dz.  The library yardstick computes less:
    the two products (dx and dW) by ``torch.matmul`` on operands prepared
    beforehand."""
    b, c, o, hw = CONV_BN_STAGES[stage]
    g, x, w, mean, rstd, gamma, beta, shift = _conv_bn_inputs(
        b, c, o, hw, nhwc, dtype, seed=c + o + 1)
    act = "relu" if apply_bn else ""
    z = cb.bn_act_matmul_reference(x, w, mean, rstd, gamma, beta, shift, act,
                                   apply_bn, False, nhwc=nhwc)[0]
    dz = torch.randn(z.shape, generator=g, device="cuda").to(dtype)
    dsum = torch.randn(o, generator=g, device="cuda") if with_stats else None
    dsumsq = (torch.randn(o, generator=g, device="cuda") * 1e-2
              if with_stats else None)
    args = (x, w, z, dz, dsum, dsumsq, mean, rstd, gamma, beta, shift, act,
            apply_bn, with_stats)
    kern = cb.conv_bn_bwd_nhwc if nhwc else cb.conv_bn_bwd
    got = kern(*args)
    again = kern(*args)
    want = cb.bn_act_matmul_bwd_reference(*args, nhwc=nhwc)
    # magnitudes: the plain backward on |operands| with no prologue gives
    # |W|^T |dz'| and |dz'| |xn|^T
    xn, view = _conv_bn_prologue(cb, x, mean, rstd, gamma, beta, apply_bn,
                                 nhwc)
    d = dz.float()
    if with_stats:
        d = d + dsum.view(view) \
            + 2.0 * (z.float() - shift.view(view)) * dsumsq.view(view)
    d = d.to(dtype)
    dxn_scale, dw_scale, _, _ = cb.bn_act_matmul_bwd_reference(
        xn.abs(), w.abs(), None, d.abs(), None, None, None, None, None, None,
        None, "", False, False, nhwc=nhwc)
    dxn_scale = dxn_scale.float()
    del xn, d
    pos = (0,) if nhwc else (0, 2)
    if apply_bn:
        pre = ((x.float() - mean.view(view)) * rstd.view(view)).abs()
        scales = [dxn_scale * (gamma * rstd).view(view), dw_scale,
                  (dxn_scale * pre).sum(dim=pos), dxn_scale.sum(dim=pos)]
        del pre
    else:
        scales = [dxn_scale, dw_scale, torch.zeros_like(gamma),
                  torch.zeros_like(gamma)]
    torch.cuda.synchronize()
    errs = [_close(gt, wt, sc, dtype, f32_out=i > 0)
            for i, (gt, wt, sc) in enumerate(zip(got, want, scales))]
    same_bits = all(torch.equal(a_, b_) for a_, b_ in zip(got, again))
    del got, again, want, scales, dxn_scale, dw_scale
    n, item = b * hw, x.element_size()
    nbytes = (2 * n * c * item + n * o * item * (2 if with_stats else 1)
              + o * c * (item + 4))
    bound_ms, bound_by, bound_simt = tf32_bound(nbytes, 4.0 * n * c * o,
                                                   dtype)
    if nhwc:
        def lib():
            torch.matmul(dz, w)
            torch.matmul(dz.t(), x)
    else:
        wt, xt = w.t(), x.transpose(1, 2)

        def lib():
            torch.matmul(wt, dz)
            torch.matmul(dz, xt).sum(dim=0)
    tag = str(dtype).replace("torch.", "")
    res = {"check": "%s_%s_%s%s_%s" % (
               "nhwc" if nhwc else "nchw", stage,
               "bn_relu" if apply_bn else "raw",
               "_stats" if with_stats else "", tag),
           "bcoh": [b, c, o, hw], "nhwc": nhwc, "apply_bn": apply_bn,
           "with_stats": with_stats, "dtype": tag,
           "max_abs_err": max(e for e, _ in errs),
           "max_abs_err_dx_dw_dgamma_dbeta": [e for e, _ in errs],
           "tol": CONV_BN_TOL[dtype], "repeatable_bits": same_bits,
           "kernel_ms": timer(lambda: kern(*args)),
           "device_ms": device_ms(library_kernels(lambda: kern(*args))),
           "plain_ms": timer(lambda: cb.bn_act_matmul_bwd_reference(
               *args, nhwc=nhwc), iters=5),
           "library_ms": timer(lib),
           "library": "the two products (dx, dW) by torch.matmul",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "ok": all(ok for _, ok in errs) and same_bits}
    if bound_simt is not None:
        res["bound_simt_ms"] = bound_simt
    del x, z, dz, args
    torch.cuda.empty_cache()
    return res


def conv_bn_cases(cb, timer):
    """Kernels #8-#11: the main path's shape first (stage 3, 256 -> 1024
    at 14x14, the most frequent fused layer, with the BN + ReLU prologue
    and, backward, the stats fold), then stage 1 (64 -> 256 at 56x56, raw
    input), stage 4 (2048 -> 512 at 7x7, no stats cotangent backward) and
    stages 3, 1 and 4 in bfloat16 (the AMP path's); each layout.  Then
    each layout's ragged shape in both types, with the prologue and the
    fold.  Then #8/#9 and #10/#11 at SE-ResNeXt-50's fused shapes
    (``SE_CONV_BN_CASES``) in both types."""
    f32, bf16 = torch.float32, torch.bfloat16
    out = {}
    for nhwc in (False, True):
        sfx = "_nhwc" if nhwc else ""
        ragged = [("ragged" if nhwc else "ragged_hw49", dt)
                  for dt in (f32, bf16)]
        out["conv_bn_fwd" + sfx] = [
            conv_bn_fwd_case(cb, timer, st, nhwc, bn, dt)
            for st, bn, dt in (("stage3", True, f32), ("stage1", False, f32),
                               ("stage4", True, f32), ("stage3", True, bf16),
                               ("stage1", False, bf16), ("stage4", True, bf16))
            + tuple((st, True, dt) for st, dt in ragged)]
        out["conv_bn_bwd" + sfx] = [
            conv_bn_bwd_case(cb, timer, st, nhwc, bn, ws, dt)
            for st, bn, ws, dt in (("stage3", True, True, f32),
                                   ("stage1", False, True, f32),
                                   ("stage4", True, False, f32),
                                   ("stage3", True, True, bf16),
                                   ("stage1", False, True, bf16),
                                   ("stage4", True, False, bf16))
            + tuple((st, True, True, dt) for st, dt in ragged)]
    # SE-ResNeXt-50's shapes, float32 and bfloat16, after the others (the
    # first check of each kernel stays its main path's)
    for nhwc in (False, True):
        sfx = "_nhwc" if nhwc else ""
        for dt in (f32, bf16):
            for st, bn in SE_CONV_BN_CASES:
                out["conv_bn_fwd" + sfx].append(
                    conv_bn_fwd_case(cb, timer, st, nhwc, bn, dt))
                out["conv_bn_bwd" + sfx].append(
                    conv_bn_bwd_case(cb, timer, st, nhwc, bn, True, dt))
    return out


def _train_klen():
    """The training slice's key lengths: 256 rows of 64 tokens, lengths
    in [16, 64]; and the same with row 7 empty."""
    train_klen = np.random.RandomState(3).randint(
        16, TRAIN_SEQ + 1, TRAIN_BATCH).tolist()
    train_klen0 = list(train_klen)
    train_klen0[7] = 0
    return train_klen, train_klen0


# the realdist path's buckets (bench.py's transformer_realdist): pad
# bounds and the rows a bucket's batch holds
REALDIST_BOUNDS, REALDIST_SIZES = (16, 32, 48, 64), (512, 256, 170, 128)


def _bucket_klen(bound, rows):
    """Key lengths of one realdist bucket's rows: in (previous bound,
    bound], the first bucket's from 4 (bench.py's shortest sentence)."""
    lo = max([3] + [b for b in REALDIST_BOUNDS if b < bound]) + 1
    return np.random.RandomState(bound).randint(lo, bound + 1, rows).tolist()


def _bucket_attention_cases(case, fa, timer):
    """#1 or #2 (``case``) in bfloat16 with dropout 0.1, causal, at the
    realdist buckets of bound 16, 32 and 48 (64 is the training shape)."""
    return [case(fa, timer, "realdist_b%d_causal_dropout_bfloat16" % bound,
                 bound, bound, True, _bucket_klen(bound, rows),
                 torch.bfloat16, rate=0.1, seed=1234)
            for bound, rows in zip(REALDIST_BOUNDS[:3], REALDIST_SIZES[:3])]


def attention_fwd_cases(timer):
    """Kernel #1 at the training, prefill and decode shapes, the main
    path's (training, causal float32) first."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    train_klen, train_klen0 = _train_klen()
    prefill_klen = [1024, 700, 513, 64, 1, 0, 300, 999]
    decode_klen = [1024, 65, 700, 1, 333, 512, 1000, 2]
    # the decode split (8 ranks of 128 keys at klen 1024) with empty
    # slices: no key, one or two keys, and a klen just past a tile edge
    empty_klen = [0, 65, 129, 1, 2, 193, 1024, 64]
    t = TRAIN_SEQ
    fwd = [attention_case(fa, timer, "train_causal_" + tag, t, t, True,
                          train_klen, dtype)
           for dtype, tag in ((torch.float32, "float32"),
                              (torch.bfloat16, "bfloat16"))]
    fwd.append(attention_case(fa, timer, "train_self_dropout_klen0", t, t,
                              False, train_klen0, torch.float32, rate=0.1,
                              seed=1234))
    # the AMP training path's calls: bfloat16 with dropout 0.1, causal
    # (decoder self-attention) and not (encoder and cross attention)
    for causal, tag in ((True, "causal"), (False, "self")):
        fwd.append(attention_case(fa, timer,
                                  "train_%s_dropout_bfloat16" % tag, t, t,
                                  causal, train_klen, torch.bfloat16,
                                  rate=0.1, seed=1234))
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        fwd.append(attention_case(fa, timer, "prefill_" + tag, 1024, 1024,
                                  True, prefill_klen, dtype))
        fwd.append(attention_case(fa, timer, "decode_" + tag, 1, 1024,
                                  True, decode_klen, dtype))
    fwd.append(attention_case(fa, timer, "prefill_float32_dropout", 1024,
                              1024, True, prefill_klen, torch.float32,
                              rate=0.1, seed=1234))
    fwd.append(attention_case(fa, timer, "decode_empty_slices_float32", 1,
                              1024, True, empty_klen, torch.float32))
    # the key split of Tq > 1 (the tiles' 64-row partials combined): the
    # engine's 128 and 256 prefill buckets at 8 slots (cluster 2), the
    # suffix (Tq < Tk) alignment (cluster 4), and the B = 1 causal score
    # program over the longest served sequence (cluster 4)
    for t, kl in ((128, [128, 100, 65, 64, 1, 0, 127, 33]),
                  (256, [256, 200, 129, 64, 1, 0, 255, 130])):
        for dtype in (torch.float32, torch.bfloat16):
            fwd.append(attention_case(
                fa, timer, "prefill_bucket%d_%s" % (t, str(dtype)[6:]), t, t,
                True, kl, dtype, split=True))
    fwd.append(attention_case(fa, timer, "suffix_dropout_float32", 70, 300,
                              True, [300, 150, 70, 71, 299, 100, 3, 250],
                              torch.float32, rate=0.1, seed=99, split=True))
    t = max(SERVE_PROMPTS) + MAX_NEW
    fwd.append(attention_case(fa, timer, "score_b1_float32", t, t, True, [t],
                              torch.float32, split=True))
    fwd.append(verify_attention_case(fa, timer))
    return fwd + _bucket_attention_cases(attention_case, fa, timer)


def verify_attention_case(fa, timer):
    """#1 at the speculative verify's shape (``serve_paged``): a
    SPEC_K-row suffix query a slot over the 1024 keys gathered from its
    pages, [8, 8, 4, 64] over [8, 8, 1024, 64] with the verify's key
    lengths (the key split: cluster 4)."""
    return attention_case(fa, timer, "verify_float32", SPEC_K,
                          MODEL["max_len"], True, VERIFY_KLEN,
                          torch.float32, split=True)


def verify_layer_norm_case(ln, timer):
    """#3 at the verify's rows: 8 slots x SPEC_K tokens, 512 wide."""
    return layer_norm_case(ln, timer, MODEL["slots"] * SPEC_K,
                           MODEL["d_model"], torch.float32)


def layer_norm_fwd_cases(timer):
    """Kernel #3 at the training rows (the main path's shape first), the
    prefill, decode and verify rows, and bfloat16."""
    from paddle_tpu_torch.ops.cuda import layer_norm as ln

    rows, d = TRAIN_BATCH * TRAIN_SEQ, TRAIN["d_model"]
    # 8192 and 8160: the realdist buckets' rows (512 x 16 ... 128 x 64,
    # and 170 x 48)
    norm = [layer_norm_case(ln, timer, n, d, torch.float32)
            for n in (rows, 8 * 1024, 8, 8160)]
    norm.append(layer_norm_case(ln, timer, rows, d, torch.bfloat16))
    norm.append(verify_layer_norm_case(ln, timer))
    # off the path: the generic loop (a width that is not a multiple of 4,
    # a width other than 512 in bfloat16, both with fewer rows than SMs)
    norm += [layer_norm_case(ln, timer, 1000, 97, torch.float32),
             layer_norm_case(ln, timer, 5, 4096, torch.bfloat16)]
    return norm


def serve_paged_kernel_cases(timer):
    """Kernels #1 and #3 at the shapes the paged slice adds (the
    speculative verify's), against their plain versions."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import layer_norm as ln

    return {"flash_attention_fwd": [verify_attention_case(fa, timer)],
            "layer_norm_fwd": [verify_layer_norm_case(ln, timer)]}


def serve_kernel_cases(timer):
    """Kernels #1, #3 and #7, the serving path's, against their plain
    versions (``--serve-kernels``)."""
    from paddle_tpu_torch.ops.cuda import quant_matmul as qm

    return {"flash_attention_fwd": attention_fwd_cases(timer),
            "layer_norm_fwd": layer_norm_fwd_cases(timer),
            "dequant_matmul": quant_matmul_cases(qm, timer)}


def train_kernel_cases(timer):
    """Kernels #1-#6 (the serving and Transformer-training slices)
    against their plain versions; {kernel name: [checks]}, the main
    path's shape first."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    from paddle_tpu_torch.ops.cuda import softmax_xent as sx

    train_klen, train_klen0 = _train_klen()
    t = TRAIN_SEQ
    bwd = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        bwd.append(attention_bwd_case(fa, timer, "train_causal_" + tag, t,
                                      t, True, train_klen, dtype))
        bwd.append(attention_bwd_case(fa, timer, "train_self_" + tag, t, t,
                                      False, train_klen, dtype))
    bwd.append(attention_bwd_case(fa, timer, "train_causal_dropout_klen0", t,
                                  t, True, train_klen0, torch.float32,
                                  rate=0.1, seed=1234))
    for causal, tag in ((True, "causal"), (False, "self")):
        bwd.append(attention_bwd_case(fa, timer,
                                      "train_%s_dropout_bfloat16" % tag, t,
                                      t, causal, train_klen, torch.bfloat16,
                                      rate=0.1, seed=1234))
    # off the training path: several tiles per row, ragged last tiles,
    # and the suffix (Tq < Tk) causal alignment
    ragged_klen = [200, 150, 65, 64, 1, 0, 130, 199]
    for dtype in (torch.float32, torch.bfloat16):
        bwd.append(attention_bwd_case(
            fa, timer, "ragged_causal_" + str(dtype)[6:], 200, 200, True,
            ragged_klen, dtype))
    bwd.append(attention_bwd_case(fa, timer, "suffix_dropout", 70, 300,
                                  True, [300, 150, 70, 71, 299, 100, 3, 250],
                                  torch.float32, rate=0.1, seed=99))
    bwd += _bucket_attention_cases(attention_bwd_case, fa, timer)
    rows = TRAIN_BATCH * TRAIN_SEQ
    d = TRAIN["d_model"]
    norm_bwd = [layer_norm_bwd_case(ln, timer, rows, d, dt)
                for dt in (torch.float32, torch.bfloat16)]
    # off the path: a ragged last block of rows and other row widths
    norm_bwd += [layer_norm_bwd_case(ln, timer, 1000, 96, torch.float32),
                 layer_norm_bwd_case(ln, timer, 5, 1024, torch.bfloat16)]
    norm_bwd += [layer_norm_bwd_case(ln, timer, n, d, torch.float32)
                 for n in (8192, 8160)]
    return dict({"flash_attention_fwd": attention_fwd_cases(timer),
                 "flash_attention_bwd": bwd, "layer_norm_bwd": norm_bwd},
                **row_kernel_cases(timer))


# machine translation's loss (``rnn``): [64 x 30, 30000] float32 (black
# under AMP too), no smoothing
MT_XENT = ((64 * 30, 30000, 0.0),)


# kernel #5's shapes (rows, classes, smoothing, dtype), the Transformer's
# first: its float32 and bfloat16 loss; 300 x 1000 off the path; 8192 and
# 8160: the realdist buckets; machine translation's loss (MT_XENT); rows
# that start off 16-byte boundaries (C * itemsize mod 16 != 0: a scalar
# head and tail), and rows too wide for a cluster's registers (the
# streaming path)
XENT_CASES = (
    (TRAIN_BATCH * TRAIN_SEQ, TRAIN_VOCAB, 0.1, torch.float32),
    (TRAIN_BATCH * TRAIN_SEQ, TRAIN_VOCAB, 0.1, torch.bfloat16),
    (300, 1000, 0.0, torch.float32),
    (8192, TRAIN_VOCAB, 0.1, torch.float32),
    (8160, TRAIN_VOCAB, 0.1, torch.float32),
    MT_XENT[0] + (torch.float32,),
    (64, 30001, 0.1, torch.float32),
    (64, 1001, 0.0, torch.bfloat16),
    (128, 100003, 0.1, torch.float32))


def row_kernel_cases(timer):
    """Kernels #3, #5 and #6 (the row kernels) against their plain
    versions at ``layer_norm_fwd_cases``' and ``XENT_CASES``' shapes."""
    from paddle_tpu_torch.ops.cuda import softmax_xent as sx

    xent_fwd, xent_bwd = [], []
    for n, c, eps, dtype in XENT_CASES:
        f, b = softmax_xent_cases(sx, timer, n, c, eps, dtype)
        xent_fwd.append(f)
        xent_bwd += b
    return {"layer_norm_fwd": layer_norm_fwd_cases(timer),
            "softmax_xent_fwd": xent_fwd, "softmax_xent_bwd": xent_bwd}


def mt_xent_cases(timer):
    """#5/#6 at machine translation's shape alone (``rnn`` mode)."""
    from paddle_tpu_torch.ops.cuda import softmax_xent as sx

    f, b = softmax_xent_cases(sx, timer, *MT_XENT[0], torch.float32)
    return {"softmax_xent_fwd": [f], "softmax_xent_bwd": b}


def log_checks(checks):
    """Log the kernel checks, with the launches they and their timing
    loops made (the main paths' counts are taken separately, in the
    serve and train phases); fail if any kernel disagrees."""
    from paddle_tpu_torch.ops import cuda

    log("kernels", dict(checks, check_launches=cuda.launch_counts()))
    bad = [c["check"] for cs in checks.values() for c in cs if not c["ok"]]
    if bad:
        raise SystemExit("kernel disagrees with its plain version: %s"
                         % bad)
    return checks


def kernels_phase():
    """Every kernel against its plain version at its paths' shapes.
    Returns {kernel name: [checks]}, the main path's shape first."""
    from paddle_tpu_torch.ops.cuda import conv_bn as cb
    from paddle_tpu_torch.ops.cuda import quant_matmul as qm

    timer = Timer()
    checks = train_kernel_cases(timer)
    checks["dequant_matmul"] = quant_matmul_cases(qm, timer)
    checks.update(conv_bn_cases(cb, timer))
    return log_checks(checks)


# ---------------------------------------------------------------------------
# phases 4-6: the serving slices
# ---------------------------------------------------------------------------

def count_ops(program, op_type):
    return sum(op.type == op_type for op in program.global_block().ops)


def rel_l1(ref, out):
    """Relative L1 distance (the JAX package's ``autotune.eval_delta``): the
    int8 accuracy budget's metric, ``FLAGS_quantize_accuracy_budget``
    0.02."""
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(out - ref).sum() / (np.abs(ref).sum() + 1e-12))


INT8_BUDGET = 0.02
# the bfloat16 score program's logits against the float32 program's, by
# the same metric: the one-shot inference band (bf16 weights and
# activations round at 2^-8 relative, well inside the int8 budget)
INFER_BF16_BAND = 0.02


# profiled windows a serving path may take when the trace lost kernels
TRACE_TRIES = 3


def device_window(fn, lost=None, again=False):
    """Run ``fn`` under ``torch.profiler``: its host wall (which the
    profiler's own host work lengthens), the device's busy time (the union
    of the kernel and copy intervals) and idle share, the number of device
    events, each kernel's launches as the device trace shows them
    (``trace_launches``: what a replayed CUDA graph ran) and as its wrapper
    counted them in the window (``wrapper_launches``: launches made from
    the host, none in a replay), and the ten device events (kernels,
    copies) that took the most summed time (``top_device_us``: name, us,
    count).

    ``lost`` (for an ``fn`` that can run again with nothing else changed:
    a serving pass) takes the window and returns the kernels whose records
    the trace lost (``trace_lost``); while it returns any, ``fn`` is
    profiled again, up to ``TRACE_TRIES`` windows in all, and each lossy
    window's losses are kept in ``trace_losses``.  With ``lost`` or
    ``again`` (an ``fn`` whose extra runs nothing compares) a window whose
    trace holds no device event at all is profiled again too, counted in
    ``empty_windows``: every path runs device work, so such a trace lost
    the window (seen once on a SmallNet inference pass, captured and
    eager alike), and ``launch_faults`` refuses a window left empty."""
    losses, empty = [], 0
    for _ in range(TRACE_TRIES if lost or again else 1):
        out = _profiled(fn)
        if not out["device_events"]:
            empty += 1
            continue
        missing = lost(out) if lost else {}
        if not missing:
            break
        losses.append(missing)
    out.update(trace_losses=losses, empty_windows=empty)
    return out


def _profiled(fn):
    """One ``device_window`` of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import cuda

    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_PADS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(TRACE_SETTLE_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    wrapper = cuda.launch_counts()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.name.startswith("dispatch/")]
    events = [e for e in device if "spin_kernel" not in e.name]
    busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                         for e in events]) / 1e3
    out = {"wall_ms": wall * 1e3, "busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / (wall * 1e3),
           "device_events": len(events),
           # under TRACE_PADS: the trace dropped records at the head
           "pads_traced": len(device) - len(events),
           "trace_launches": cuda.device_launch_counts(
               e.name for e in events),
           "wrapper_launches": wrapper}
    by = {}
    for e in events:
        us, n = by.get(e.name, (0.0, 0))
        by[e.name] = (us + e.time_range.end - e.time_range.start, n + 1)
    out["top_device_us"] = [[name[:80], us, n] for name, (us, n) in
                            sorted(by.items(), key=lambda kv: -kv[1][0])[:10]]
    return out


def launch_record(captured, timed, need, window, window_need):
    """A path's launch counts beside what its program implies (read by
    ``launch_faults``): its wrappers' counts over its timed runs
    (``timed``, implied ``need``) and its profiled window (``window``, a
    ``device_window``, implied ``window_need``)."""
    return dict(captured=captured, timed=timed, need=need, window=window,
                window_need=window_need)


def launch_faults(rec):
    """{check:kernel: (counted, implied)} where a path's launches are not
    what its program implies (kernels it leaves out: none).  A captured
    path's timed runs and profiled window replay graphs: its wrappers
    launch nothing, and the window's device trace shows each kernel as
    often as the program implies.  An eager path's wrappers launch each
    kernel as often as the program implies, in the timed runs and in the
    window, whose trace shows the same counts.  A window whose trace holds
    no device event measured nothing (every path runs device work): it is
    a fault, ``window_trace:device_events``, whatever the counts."""
    from paddle_tpu_torch.ops.cuda import KERNELS

    window, eager = rec["window"], not rec["captured"]
    checks = (("timed", rec["timed"], rec["need"] if eager else {}),
              ("window_wrapper", window["wrapper_launches"],
               rec["window_need"] if eager else {}),
              ("window_trace", window["trace_launches"], rec["window_need"]))
    faults = {"%s:%s" % (check, k): (got.get(k, 0), want.get(k, 0))
              for check, got, want in checks for k in KERNELS
              if got.get(k, 0) != want.get(k, 0)}
    if not window["device_events"]:
        faults["window_trace:device_events"] = (0, "at least 1")
    return faults


def trace_lost(window, need, captured):
    """{kernel: (in the trace, implied)} for the kernels a serving window's
    device trace shows fewer times than its dispatches imply (``need``)
    although they ran: their wrappers launched every one of them (an eager
    window) or none (a captured one, whose replays run them).  A window
    whose wrappers launched fewer than implied has lost no record: it is
    ``launch_faults``' to report."""
    return {k: (window["trace_launches"].get(k, 0), n)
            for k, n in need.items()
            if window["trace_launches"].get(k, 0) < n
            and window["wrapper_launches"].get(k, 0) == (0 if captured
                                                          else n)}


def serving_per_dispatch(model, program):
    """{kernel: launches} one dispatch of a decoder ``program`` implies."""
    return {"flash_attention_fwd": model["n_layer"],
            "layer_norm_fwd": 2 * model["n_layer"],
            "dequant_matmul": count_ops(program, "dequant_matmul")}


def _warm_buckets(eng, lengths, submit):
    """Two dispatches of every bucket the lengths fall in, one request at
    a time, so that a captured engine has captured each of them before it
    is timed (an entry runs eagerly first, captures at its second run)."""
    for n in sorted({eng._sched.bucket_for(n): n for n in lengths}.values()):
        for _ in range(2):
            submit(n).result(900)


def serve_phase(place, model=MODEL, n_requests=N_REQUESTS, max_new=MAX_NEW,
                prompt_range=SERVE_PROMPTS, quantize=None, capture=True):
    """Serve ``n_requests`` prompts through ``GenerationEngine`` on
    ``place`` (int8 weights with ``quantize``; CUDA graphs of every
    dispatch with ``capture``, every dispatch eager without); returns (the
    summary dict, its ``launch_record``, the results).  The engine first
    dispatches every bucket the prompts fall in twice; then the requests
    are served with the launch counters zeroed just before and read just
    after (timed), and once more under the profiler (device busy time,
    idle share, launches in the trace)."""
    from paddle_tpu_torch.ops import cuda
    from paddle_tpu_torch.serving import GenerationEngine, build_decoder_lm
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    fp_spec = build_decoder_lm(**model)
    eng = GenerationEngine(fp_spec, place=place, max_new_tokens=max_new,
                           record_logits=True, timeout_s=900.0, start=False,
                           quantize=quantize, capture=capture)
    spec = eng.spec
    rng = np.random.RandomState(0)
    # arrival order shuffled, so admissions mix buckets as traffic would
    lens = rng.permutation(np.linspace(prompt_range[0], prompt_range[1],
                                       n_requests).astype(int))
    prompts = [list(rng.randint(0, model["vocab_size"], n)) for n in lens]
    try:
        torch.cuda.reset_peak_memory_stats()
        eng.start()
        _warm_buckets(eng, lens, lambda n: eng.submit(
            prompts[list(lens).index(n)], max_new_tokens=2))
        eng.metrics = ServingMetrics()
        # the main path, in one piece: counters zeroed just before, read
        # just after
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = [eng.submit(p) for p in prompts]
        results = [r.result(900) for r in reqs]
        if place.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        metrics = eng.metrics
        per = serving_per_dispatch(model, spec.decode_program)

        def served():
            eng.metrics = ServingMetrics()
            [r.result(900) for r in [eng.submit(p) for p in prompts]]

        def lost(window):
            c = eng.metrics.summary()["counts"]
            return trace_lost(window, {k: n * (c["batches"]
                                               + c["decode_steps"])
                                       for k, n in per.items()}, capture)
        window = device_window(served, lost)
        profiled = eng.metrics.summary()["counts"]
    finally:
        eng.close()

    counts = metrics.summary()["counts"]
    dispatches = counts["batches"] + counts["decode_steps"]
    profiled_dispatches = profiled["batches"] + profiled["decode_steps"]
    tokens = sum(len(r["tokens"]) for r in results)
    assert counts["completed"] == n_requests, counts
    assert all(len(r["tokens"]) == max_new for r in results), \
        [len(r["tokens"]) for r in results]

    # decode-vs-recompute: the longest request's recorded logits against
    # a full causal forward of the score program over prompt + output
    i = int(np.argmax(lens))
    seq = prompts[i] + results[i]["tokens"]
    t = len(seq)
    feed = {"tok": np.asarray(seq, "int64").reshape(1, t, 1),
            "tok@LEN": np.asarray([t], "int32"),
            "pos": np.arange(t, dtype="int64").reshape(1, t, 1)}
    with torch.inference_mode():
        (full,) = eng._exe.run(spec.score_program, feed=feed,
                               fetch_list=[spec.score_logits],
                               scope=eng._scope)
        # the fp masters stay in the scope beside the int8 weights
        (fp_full,) = eng._exe.run(fp_spec.score_program, feed=feed,
                                  fetch_list=[fp_spec.score_logits],
                                  scope=eng._scope) if quantize else (full,)
    assert full.shape == (1, t, model["vocab_size"]), full.shape
    assert np.isfinite(full).all()
    want = full[0, len(prompts[i]) - 1:t - 1]
    got = np.stack(results[i]["logits"])
    recompute_rel_l1 = rel_l1(want, got)
    if quantize == "dynamic":
        # a per-row int8 grid may round an activation differently when the
        # decode and the recompute differ in the last float bits
        assert recompute_rel_l1 < INT8_BUDGET, recompute_rel_l1
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    vs_fp = rel_l1(fp_full, full)
    assert vs_fp < INT8_BUDGET, vs_fp

    pre = metrics.percentiles("prefill")
    dec = metrics.percentiles("decode")
    summary = {
        "capture": capture, "requests": n_requests, "tokens": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "prefills": counts["batches"],
        "decode_steps": counts["decode_steps"],
        "p50_prefill_ms": pre["p50_s"] * 1e3,
        "p50_decode_step_ms": dec["p50_s"] * 1e3,
        "p50_request_ms": metrics.percentiles()["p50_s"] * 1e3,
        "profiled_pass": window, "peak_mem_gb": peak / 1e9,
        "graphs": sum(s.graph is not None for s in eng._exe._steps.values()),
        "recompute_max_abs_err": float(np.abs(got - want).max()),
        "recompute_rel_l1": recompute_rel_l1,
        "quantize": quantize, "score_vs_fp_rel_l1": vs_fp,
        "launches": launches, "dispatches": dispatches,
        "profiled_dispatches": profiled_dispatches,
        "cache_mb": spec.cache.bytes() / 1e6,
        "params_mb": sum(
            eng._scope.var(n).numel() * eng._scope.var(n).element_size()
            for n in eng._scope.local_var_names()
            if n not in spec.cache.names()) / 1e6}
    n_dq = per["dequant_matmul"]
    assert n_dq == count_ops(spec.prefill_program, "dequant_matmul")
    assert (n_dq > 0) == bool(quantize), n_dq
    if quantize:
        info = spec.score_program._quantize_info["weights"]
        assert all(4 * w["bytes_int8"] == w["bytes_fp"]
                   for w in info.values()), info
        # the engine's scope holds the int8 weights on the engine's device
        assert all(eng._scope.var(w["int8"]).dtype == torch.int8
                   and eng._scope.var(w["int8"]).device == place.device
                   for w in info.values())
        summary.update(
            int8_weights=len(info),
            int8_weight_mb=sum(w["bytes_int8"] for w in info.values()) / 1e6,
            fp_weight_mb=sum(w["bytes_fp"] for w in info.values()) / 1e6,
            dequant_matmul_per_dispatch=n_dq)
    return summary, launch_record(
        capture, launches, {k: n * dispatches for k, n in per.items()},
        window, {k: n * profiled_dispatches for k, n in per.items()}), results


def serve_phases(place):
    """fp, weight_only and dynamic serving, each captured and eager in
    turns (the order flips from mode to mode, as host load drifts within
    a call); the generated tokens and the recorded logits of the two runs
    must be the same bits.  Returns {path: (summary, launch record)}, the
    captured runs as ``serve`` / ``serve_int8:<mode>`` and the eager ones
    with ``:eager`` after."""
    # what a captured dispatch adds: the clone of a prefill's fetched
    # [slots, 512, vocab] logits (a replay rewrites the graph's own)
    logits = torch.empty((MODEL["slots"], 512, MODEL["vocab_size"]),
                         device="cuda")
    nbytes = 2 * logits.numel() * logits.element_size()
    log("fetch_clone", {"shape": list(logits.shape),
                        "ms": Timer()(logits.clone, iters=10),
                        "bound_ms": bound(nbytes, 0, torch.float32)[0]})
    del logits
    out, bad = {}, []
    for i, quantize in enumerate((None, "weight_only", "dynamic")):
        path = "serve_int8:" + quantize if quantize else "serve"
        runs = {}
        for capture in ((True, False) if i % 2 else (False, True)):
            summary, record, results = serve_phase(
                place, quantize=quantize, capture=capture)
            runs[capture] = results
            name = path if capture else path + ":eager"
            log("serve_int8" if quantize else "serve", summary)
            out[name] = summary, record
        same = [a["tokens"] == b["tokens"]
                and all(np.array_equal(x, y)
                        for x, y in zip(a["logits"], b["logits"]))
                for a, b in zip(runs[True], runs[False])]
        log("capture_check", {"path": path, "same_bits_as_eager": all(same)})
        if not all(same):
            bad.append(path)
    if bad:
        raise SystemExit("captured serving differs from eager: %s" % bad)
    return out


# ---------------------------------------------------------------------------
# phase 4b: the paged cache, int8 KV and speculative decoding
# ---------------------------------------------------------------------------

# the arms of serve_paged: build_decoder_lm's options and the kernel path
# each reports under (its eager run with ":eager" after)
PAGED_ARMS = {
    "fixed": ({}, None),
    "f32": (dict(paged=True, page_size=PAGE_SIZE), "serve_paged"),
    "int8": (dict(paged=True, page_size=PAGE_SIZE, kv_dtype="int8"),
             "serve_paged_int8"),
    "spec": (dict(paged=True, page_size=PAGE_SIZE, spec_k=SPEC_K),
             "serve_paged_spec"),
}
# a speculative parting is rounding only where the target's two best
# logits lie within twice the 2e-4 decode band of each other
PARTING_GAP = 4e-4


def paged_prompts(model=MODEL, n_requests=N_REQUESTS,
                  prompt_range=SERVE_PROMPTS):
    """The serve phase's prompt lengths (same seed), each prompt's first
    SYSTEM_TOKENS tokens one shared system prompt: (lengths, prompts)."""
    rng = np.random.RandomState(0)
    lens = rng.permutation(np.linspace(prompt_range[0], prompt_range[1],
                                       n_requests).astype(int))
    prompts = [list(rng.randint(0, model["vocab_size"], n)) for n in lens]
    system = list(np.random.RandomState(1).randint(
        0, model["vocab_size"], SYSTEM_TOKENS))
    return lens, [system + p[SYSTEM_TOKENS:] for p in prompts]


def live_kernel_ops(program, fetch_names):
    """{kernel: launches} one dispatch of ``program`` fetching
    ``fetch_names`` implies: the executor runs only the ops whose outputs
    a later running op reads, a fetch names or the scope keeps (the
    draft's prefill fetches nothing, so its last layer's attention and
    norms do not run)."""
    block = program.global_block()
    needed = set(fetch_names)
    for op in block.ops:
        for n in op.output_arg_names:
            v = block._find_var_recursive(n) if n else None
            if v is not None and v.persistable:
                needed.add(n)
    types = []
    for op in reversed(block.ops):
        outs = [n for n in op.output_arg_names if n]
        if not outs or any(n in needed for n in outs):
            needed.update(n for n in op.input_arg_names if n)
            types.append(op.type)
    return {"flash_attention_fwd": types.count("fused_attention")
            + types.count("paged_attention"),
            "layer_norm_fwd": types.count("layer_norm"),
            "dequant_matmul": types.count("dequant_matmul")}


def _add(*counts):
    out = {}
    for c in counts:
        for k, n in c.items():
            out[k] = out.get(k, 0) + n
    return out


def _scale(counts, n):
    return {k: v * n for k, v in counts.items()}


def _submit_all(eng, prompts):
    """Queue every prompt before the loop admits any (the scheduler's lock
    held while submitting), so that admissions, and with them the prefill
    buckets that write the shared pages, are the same in every pass."""
    with eng._sched._cv:
        reqs = [eng.submit(p) for p in prompts]
    return [r.result(900) for r in reqs]


def _rewrite_watch(eng):
    """Wrap the engine's executor so that each target prefill records the
    live shared pages it writes again (pages held by a slot outside the
    admitted batch): how many, and how many came out in other bits.
    Returns the record dict."""
    spec, real = eng.spec, eng._exe.run
    rec = {"prefills": 0, "page_rewrites": 0, "pages_changed": 0,
           "max_abs_diff": 0.0, "buckets": []}

    def run(program, feed=None, **kw):
        if program is not spec.prefill_program:
            return real(program, feed=feed, **kw)
        batch = {int(x) for x in feed["slot"]}
        npg = feed["tok"].shape[1] // PAGE_SIZE
        held = set()
        for slot, pages in eng._alloc._slot_pages.items():
            if slot not in batch:
                held.update(pages)
        pages = sorted({int(p) for slot in batch
                        for p in eng._table[slot, :npg]} & held)
        dev = eng._scope.find_var(spec.cache.names()[0]).device
        idx = torch.tensor(pages, dtype=torch.long, device=dev)
        before = {n: eng._scope.find_var(n)[idx].clone()
                  for n in spec.cache.names()}
        out = real(program, feed=feed, **kw)
        torch.cuda.synchronize()
        rec["prefills"] += 1
        if pages:
            rec["page_rewrites"] += len(pages)
            rec["buckets"].append(feed["tok"].shape[1])
            changed = torch.zeros(len(pages), dtype=torch.bool,
                                  device=dev)
            for n, old in before.items():
                new = eng._scope.find_var(n)[idx]
                changed |= (new != old).reshape(len(pages), -1).any(1)
                rec["max_abs_diff"] = max(rec["max_abs_diff"], float(
                    (new.float() - old.float()).abs().max()))
            rec["pages_changed"] += int(changed.sum())
        return out

    eng._exe.run = run
    return rec


def _signatures(eng, spec, draft):
    """{program: [executor entries, CUDA graphs]} of the serving programs
    the engine ran (an entry a feed signature: a prefill bucket, the
    decode or verify step)."""
    programs = {"prefill": spec.prefill_program,
                "decode": spec.decode_program,
                "verify": spec.verify_program}
    if draft is not None:
        programs.update(draft_prefill=draft.prefill_program,
                        draft_decode=draft.decode_program)
    names = {id(p): n for n, p in programs.items() if p is not None}
    out = {}
    for key in eng._exe._analysis:
        name = names.get(key[0])
        if name is not None:
            step = eng._exe._steps.get(key)
            n = out.setdefault(name, [0, 0])
            n[0] += 1
            n[1] += int(step is not None and step.graph is not None)
    return out


def paged_arm(arm, capture, lens, prompts, model=MODEL, max_new=MAX_NEW,
              rewrite_check=False):
    """Serve ``prompts`` through a ``GenerationEngine`` of the arm
    (``PAGED_ARMS``) on the card, captured or eager, as ``serve_phase``
    does: every bucket dispatched twice first, then the requests with the
    launch counters zeroed just before and read just after (timed), then
    once more under the profiler; with ``rewrite_check`` once more
    watching the shared pages (``_rewrite_watch``).  Returns (summary,
    launch record, results, the spec)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda
    from paddle_tpu_torch.serving import (GenerationEngine, build_decoder_lm,
                                          sync_draft_weights)
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    kw, _ = PAGED_ARMS[arm]
    spec = build_decoder_lm(**model, **kw)
    draft = (build_decoder_lm(**model, prefix="draft") if arm == "spec"
             else None)
    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(spec, place=pt.CUDAPlace(0),
                           max_new_tokens=max_new, record_logits=True,
                           timeout_s=900.0, start=False, capture=capture,
                           draft_spec=draft)
    if draft is not None:
        assert sync_draft_weights(eng._scope, spec, draft) > 0
    # every arm draws the same weights from the startup program's seed
    weights = float(eng._scope.find_var(
        "declm_logits.w_0").double().sum())
    # one dispatch of each kind implies these launches
    prefill = live_kernel_ops(spec.prefill_program,
                              [spec.prefill_logits.name])
    step = live_kernel_ops(spec.decode_program, [spec.decode_logits.name])
    if draft is not None:
        prefill = _add(prefill, live_kernel_ops(draft.prefill_program, []))
        step = _add(live_kernel_ops(spec.verify_program,
                                    [spec.verify_logits.name]),
                    _scale(live_kernel_ops(draft.decode_program,
                                           [draft.decode_logits.name]),
                           SPEC_K - 1))

    def implied(counts):
        return _add(_scale(prefill, counts["batches"]),
                    _scale(step, counts["decode_steps"]))

    rewrites = None
    # each pass's admissions, (bucket, requests) in order
    admissions, admit = [], eng._sched.admit

    def logged_admit(*args, **kw):
        plan, expired = admit(*args, **kw)
        if plan is not None:
            admissions.append([plan.bucket, len(plan.requests)])
        return plan, expired

    eng._sched.admit = logged_admit
    try:
        eng.start()
        _warm_buckets(eng, lens, lambda n: eng.submit(
            prompts[list(lens).index(n)], max_new_tokens=2))
        eng.metrics = ServingMetrics()
        cuda.reset_launch_counts()
        del admissions[:]
        t0 = time.perf_counter()
        results = _submit_all(eng, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cuda.launch_counts()
        metrics = eng.metrics
        counts = metrics.summary()["counts"]
        timed_admissions, again = list(admissions), []

        def served():
            eng.metrics = ServingMetrics()
            del admissions[:]
            again[:] = _submit_all(eng, prompts)

        def lost(win):
            return trace_lost(win, implied(eng.metrics.summary()["counts"]),
                              capture)
        window = device_window(served, lost)
        profiled_counts = eng.metrics.summary()["counts"]
        profiled = implied(profiled_counts)
        # the profiled pass against the timed one: same admissions, same
        # tokens (the same prompts, the engine's state aside)
        window["passes_agree"] = {
            "prefills": [counts["batches"], profiled_counts["batches"]],
            "decode_steps": [counts["decode_steps"],
                             profiled_counts["decode_steps"]],
            "tokens_equal": [r["tokens"] for r in again]
            == [r["tokens"] for r in results],
            "admissions": [timed_admissions, list(admissions)]}
        if rewrite_check:
            rewrites = _rewrite_watch(eng)
            eng.metrics = ServingMetrics()
            _submit_all(eng, prompts)
        peak = torch.cuda.max_memory_allocated()
        leaks = eng._alloc.check_leaks() if eng.paged else []
        in_use = eng._alloc.pages_in_use() if eng.paged else 0
        signatures = _signatures(eng, spec, draft)
        # a CPU place (a rehearsal) never captures
        graphs = capture and eng.place.device.type == "cuda"
    finally:
        eng.close()
    assert counts["completed"] == len(prompts), counts
    assert all(len(r["tokens"]) == max_new for r in results)
    assert all(np.isfinite(np.stack(r["logits"])).all() for r in results)
    tokens = sum(len(r["tokens"]) for r in results)
    dec = metrics.percentiles("decode")
    snap = metrics.paged_snapshot()
    summary = {
        "arm": arm, "capture": capture, "requests": len(prompts),
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
        "prefills": counts["batches"], "decode_steps": counts["decode_steps"],
        "p50_prefill_ms": metrics.percentiles("prefill")["p50_s"] * 1e3,
        # a speculative round: SPEC_K - 1 draft decodes and one verify
        "p50_decode_step_ms": dec["p50_s"] * 1e3,
        "p50_request_ms": metrics.percentiles()["p50_s"] * 1e3,
        "peak_mem_gb": peak / 1e9, "profiled_pass": window,
        "launches": launches, "per_prefill": prefill, "per_step": step,
        "paged_snapshot": snap, "leaked_pages": leaks,
        "pages_in_use_after": in_use, "weights_sum": weights,
        "cache_mb": spec.cache.bytes() / 1e6, "signatures": signatures,
        "graphs_expected": graphs}
    if arm == "spec":
        v = metrics.percentiles("verify")
        summary["p50_verify_ms"] = v["p50_s"] * 1e3
    if rewrites is not None:
        summary["shared_page_rewrites"] = rewrites
    record = launch_record(capture, launches, implied(counts), window,
                           profiled)
    return summary, record, results, spec


def paged_write_check(model=MODEL, seed=0, device="cuda"):
    """``kv_cache_paged_write`` on card tensors at the serving width
    against the same op on CPU copies of the same inputs, bit for bit:
    the prefill (scattered, a 128 bucket), decode (identity) and verify
    (SPEC_K tokens across page edges) writes, each table holding sentinel
    entries, float32 and int8 pools (values and scales); the pages no
    table entry names keep their bits.  The inputs are drawn on the
    card (``device``)."""
    from paddle_tpu_torch.ops import kv_cache as pkv

    s, h = model["slots"], model["n_head"]
    d = model["d_model"] // h
    n_pages = model["slots"] * model["max_len"] // PAGE_SIZE
    mp = model["max_len"] // PAGE_SIZE
    g = torch.Generator(device=device).manual_seed(seed)
    perm = torch.randperm(n_pages, generator=g, device=device)
    table = perm[:s * mp].reshape(s, mp).to(torch.int32)
    # unheld entries: the back half of every row, all of one slot's, and
    # a hole in another
    table[:, mp // 2:] = n_pages
    table[s // 2] = n_pages
    table[s - 1, 1] = n_pages
    rng = np.random.RandomState(seed)

    def positions(hi, first):
        pos = rng.randint(0, hi, s)
        pos[0] = first
        return torch.tensor(pos, dtype=torch.int32, device=device)

    held = mp // 2 * PAGE_SIZE
    cases = {
        # a scattered prefill of the 128 bucket, slots rotated by one
        "prefill_b128": (torch.randn((s, h, 128, d), generator=g,
                                     device=device),
                         torch.zeros(s, dtype=torch.int32, device=device),
                         torch.roll(torch.arange(s, dtype=torch.int32,
                                                 device=device), 1)),
        # decode, some positions past the held pages
        "decode": (torch.randn((s, h, 1, d), generator=g, device=device),
                   positions(held + 2 * PAGE_SIZE, held - 1), None),
        # the verify's tokens, the first slot's across a page edge
        "verify_k4": (torch.randn((s, h, SPEC_K, d), generator=g,
                                  device=device),
                      positions(held, PAGE_SIZE - 2), None),
    }
    out = {}
    for kv_dtype in ("float32", "int8"):
        if kv_dtype == "int8":
            pool = torch.randint(-127, 128, (n_pages, h, PAGE_SIZE, d),
                                 generator=g, device=device,
                                 dtype=torch.int8)
            scale = torch.rand((n_pages, h, PAGE_SIZE), generator=g,
                               device=device)
        else:
            pool = torch.randn((n_pages, h, PAGE_SIZE, d), generator=g,
                               device=device)
            scale = None
        for name, (x, pos, slot) in cases.items():
            ins = {"Cache": pool, "X": x, "Pos": pos, "PageTable": table}
            if slot is not None:
                ins["Slot"] = slot
            if scale is not None:
                ins["Scale"] = scale
            card = pkv._paged_write_compute(
                {k: [v.clone()] for k, v in ins.items()}, {}, None, 0)
            host = pkv._paged_write_compute(
                {k: [v.to("cpu", copy=True)] for k, v in ins.items()}, {},
                None, 0)
            named = set(table.reshape(-1).tolist()) - {n_pages}
            untouched = torch.tensor(sorted(set(range(n_pages)) - named),
                                     device=device)
            same = all(torch.equal(card[k].cpu(), host[k]) for k in card)
            kept = torch.equal(card["Out"][untouched], pool[untouched])
            if scale is not None:
                kept = kept and torch.equal(card["OutScale"][untouched],
                                            scale[untouched])
            out["%s_%s" % (name, kv_dtype)] = {
                "x": list(x.shape), "outputs": sorted(card),
                "same_bits_as_cpu": same, "untouched_pages_kept": kept,
                "pages_written": int((card["Out"] != pool).reshape(
                    n_pages, -1).any(1).sum())}
    log("serve_paged_write_check", out)
    bad = [k for k, v in out.items()
           if not (v["same_bits_as_cpu"] and v["untouched_pages_kept"])]
    if bad:
        raise SystemExit("kv_cache_paged_write on the card differs from "
                         "the CPU: %s" % bad)
    return out


def _partings(got, want):
    """Where a speculative stream first leaves the plain one: (request,
    position, the plain run's top-two logit gap there)."""
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        for j, (x, y) in enumerate(zip(a["tokens"], b["tokens"])):
            if x != y:
                top = np.sort(b["logits"][j])[-2:]
                out.append({"request": i, "position": j,
                            "top_two_gap": float(top[1] - top[0])})
                break
    return out


def serve_paged_phase(model=MODEL, n_requests=N_REQUESTS, max_new=MAX_NEW,
                      prompt_range=SERVE_PROMPTS, device="cuda"):
    """The paged slice at Transformer-base width: the fixed-region engine
    on the phase's prompts (captured; the reference), then the paged
    float32, int8-KV and speculative arms, each eager and captured in
    turns.  Gates: paged float32 tokens equal the fixed region's, logits
    within 2e-4; int8 KV logits within relative L1 0.02 of paged float32
    and ``kv_cache_paged_write`` card = CPU bit for bit; speculative tokens
    equal paged float32's (a parting only where the top-two gap is under
    ``PARTING_GAP``, each printed); captured = eager bit for bit; every
    entry captured (one graph a signature); no leaked page; prefix hits;
    exact launches (``launch_faults``, by the caller).  Returns {path:
    launch record}."""
    lens, prompts = paged_prompts(model, n_requests, prompt_range)
    # the reference, profiled too: its busy time beside the paged arms'
    # is what the pages cost the device
    fixed, _, want, _ = paged_arm("fixed", True, lens, prompts, model,
                                  max_new)
    log("serve_paged", fixed)
    release_memory()
    paths, runs, summaries, bad = {}, {}, {}, []
    for i, arm in enumerate(("f32", "int8", "spec")):
        path = PAGED_ARMS[arm][1]
        for capture in ((True, False) if i % 2 else (False, True)):
            summary, record, results, spec = paged_arm(
                arm, capture, lens, prompts, model, max_new,
                rewrite_check=(arm == "f32" and capture))
            name = path if capture else path + ":eager"
            paths[name] = record
            runs[arm, capture] = results
            summaries[arm, capture] = summary
            if summary["weights_sum"] != fixed["weights_sum"]:
                bad.append("%s: other weights" % name)
            if summary["leaked_pages"] or summary["pages_in_use_after"]:
                bad.append("%s: pages leaked" % name)
            if summary["paged_snapshot"]["prefix_hits"] <= 0:
                bad.append("%s: no prefix hit" % name)
            # one graph a signature: every entry captured (none eager),
            # one entry for each step program
            sig = summary["signatures"]
            if any(g != (e if summary["graphs_expected"] else 0)
                   for e, g in sig.values()) \
                    or any(sig.get(k, [1])[0] != 1 for k in (
                        "decode", "verify", "draft_decode")):
                bad.append("%s: signatures %s" % (name, sig))
            if arm == "int8":
                # bench.py's accounting: the pages the prompts and their
                # new tokens need less the prefix hits, against the fixed
                # region's cache a slot
                store = spec.cache
                alloc = store.make_allocator()
                demand = sum(alloc.pages_needed(len(p), max_new)
                             for p in prompts)
                fresh = demand - summary["paged_snapshot"]["prefix_hits"]
                f32_page = 2 * store.n_layer * store.n_head * PAGE_SIZE \
                    * store.head_dim * 4
                per = {"fixed": fixed["cache_mb"] * 1e6 / model["slots"],
                       "paged_int8": fresh / len(prompts)
                       * store.bytes_per_page(),
                       "paged_f32": fresh / len(prompts) * f32_page}
                summary["bytes_per_session"] = per
                summary["sessions_at_fixed_bytes"] = \
                    per["fixed"] / per["paged_int8"]
            log("serve_paged", summary)
            release_memory()
        same = [a["tokens"] == b["tokens"]
                and all(np.array_equal(x, y)
                        for x, y in zip(a["logits"], b["logits"]))
                for a, b in zip(runs[arm, True], runs[arm, False])]
        log("capture_check", {"path": path,
                              "same_bits_as_eager": all(same)})
        if not all(same):
            bad.append("%s: captured differs from eager" % path)

    def logits_err(a_runs, b_runs):
        return max(float(np.abs(np.stack(a["logits"])
                                - np.stack(b["logits"])).max())
                   for a, b in zip(a_runs, b_runs))

    paged = runs["f32", True]
    f32_tokens = [r["tokens"] for r in paged] == [r["tokens"] for r in want]
    f32_err = logits_err(paged, want)
    int8_rel = max(rel_l1(np.stack(a["logits"]), np.stack(b["logits"]))
                   for a, b in zip(paged, runs["int8", True]))
    partings = _partings(runs["spec", True], paged)
    # the logits up to each stream's parting (all of them without one)
    spec_err = 0.0
    cut = {p["request"]: p["position"] for p in partings}
    for i, (a, b) in enumerate(zip(runs["spec", True], paged)):
        n = cut.get(i, len(a["logits"]))
        if n:
            spec_err = max(spec_err, float(np.abs(
                np.stack(a["logits"][:n]) - np.stack(b["logits"][:n]))
                .max()))
    gates = {
        "f32_tokens_equal_fixed": f32_tokens,
        "f32_logits_max_abs_err_vs_fixed": f32_err,
        "int8_logits_rel_l1_vs_f32": int8_rel,
        "spec_tokens_equal_f32": not partings,
        "spec_partings": partings,
        "spec_logits_max_abs_err_vs_f32": spec_err,
        "spec_acceptance_rate":
            summaries["spec", True]["paged_snapshot"]["spec_acceptance_rate"],
        "write_check_cases": sorted(paged_write_check(model,
                                                      device=device))}
    log("serve_paged_gates", gates)
    if not f32_tokens or f32_err > 2e-4:
        bad.append("paged f32 against the fixed region: tokens %s, logits "
                   "%.3g" % (f32_tokens, f32_err))
    if int8_rel >= INT8_BUDGET:
        bad.append("int8 KV logits %.4g from f32" % int8_rel)
    if spec_err > 2e-4 or any(p["top_two_gap"] > PARTING_GAP
                              for p in partings):
        bad.append("speculative against paged f32: logits %.3g, partings "
                   "%s" % (spec_err, partings))
    if bad:
        raise SystemExit("serve_paged: %s" % bad)
    return paths


def _infer_requests(n_requests, length_range, vocab, seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.permutation(np.linspace(length_range[0], length_range[1],
                                       n_requests).astype(int))
    return [{"tok": rng.randint(0, vocab, (n, 1)).astype("int64"),
             "pos": np.arange(n, dtype="int64").reshape(n, 1)}
            for n in lens]


def _direct(exe, program, fetch, scope, req):
    """One request through ``Executor.run`` alone: the engine's oracle."""
    t = len(req["tok"])
    (out,) = exe.run(program, feed={"tok": req["tok"].reshape(1, t, 1),
                                    "tok@LEN": np.asarray([t], "int32"),
                                    "pos": req["pos"].reshape(1, t, 1)},
                     fetch_list=[fetch], scope=scope)
    return out[0]


def _serve_infer(eng, reqs, per):
    """Two dispatches of every bucket ``reqs`` fall in, then ``reqs`` with
    the launch counters zeroed just before and read just after (timed),
    then once more under the profiler (``per``: the launches one batch
    implies); returns (outputs, launches, summary, with the profiled
    pass's batches)."""
    from paddle_tpu_torch.ops import cuda
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    lens = [len(q["tok"]) for q in reqs]
    torch.cuda.reset_peak_memory_stats()
    _warm_buckets(eng, lens, lambda n: eng.submit(reqs[lens.index(n)]))
    eng.metrics = ServingMetrics()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [r.result(900)[0] for r in [eng.submit(q) for q in reqs]]
    if eng.place.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    counts = eng.metrics.summary()["counts"]
    assert counts["completed"] == len(reqs), counts
    tokens = sum(len(q["tok"]) for q in reqs)
    summary = {
        "capture": eng._exe.capture, "requests": len(reqs),
        "tokens": tokens, "wall_s": wall,
        "requests_per_s": len(reqs) / wall, "tokens_per_s": tokens / wall,
        "batches": counts["batches"],
        "p50_batch_ms": eng.metrics.percentiles("batch")["p50_s"] * 1e3,
        "p50_request_ms": eng.metrics.percentiles()["p50_s"] * 1e3,
        "peak_mem_gb": peak / 1e9}

    def served():
        eng.metrics = ServingMetrics()
        [r.result(900) for r in [eng.submit(q) for q in reqs]]

    def lost(window):
        n = eng.metrics.summary()["counts"]["batches"]
        return trace_lost(window, {k: v * n for k, v in per.items()},
                          eng._exe.capture)
    summary["profiled_pass"] = device_window(served, lost)
    summary["profiled_batches"] = eng.metrics.summary()["counts"]["batches"]
    summary["graphs"] = sum(s.graph is not None
                            for s in eng._exe._steps.values())
    return outs, launches, summary


def infer_phase(place, model=MODEL, n_requests=N_REQUESTS,
                length_range=(32, 256)):
    """The decoder's score program (feeds tok, tok@LEN, pos; fetch the
    logits) saved with ``io.save_inference_model`` and served cold by
    ``InferenceEngine(model_dir=..., quantize="weight_only")``; then the
    quantized program saved again and served cold with no pass.  Each
    request's [T, vocab] logits must match a direct ``Executor.run`` of the
    quantized program (2e-4) and the fp program (relative L1 < 0.02).  The
    first engine is served eagerly too (``capture=False``, before the
    captured one): the two give the same bits.  Returns (summary, {path:
    launch record}) for the engines' runs."""
    import shutil
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving import InferenceEngine, build_decoder_lm

    tmp = os.path.join(REPO, "_smoke_tmp")
    os.makedirs(tmp, exist_ok=True)
    work = tempfile.mkdtemp(dir=tmp)
    try:
        spec = build_decoder_lm(**model)
        exe, scope = pt.Executor(place), pt.Scope()
        spec.init_scope(exe, scope)
        feeds = ["tok", "tok@LEN", "pos"]
        fp_dir, q_dir = os.path.join(work, "fp"), os.path.join(work, "int8")
        with pt.scope_guard(scope):
            pt.io.save_inference_model(fp_dir, feeds, [spec.score_logits],
                                       exe, main_program=spec.score_program)
        reqs = _infer_requests(n_requests, length_range,
                               model["vocab_size"])
        served = {}
        for capture in (False, True):
            eng = InferenceEngine(model_dir=fp_dir, place=place,
                                  slots=model["slots"],
                                  quantize="weight_only", timeout_s=900.0,
                                  capture=capture)
            try:
                per = serving_per_dispatch(model, eng._program)
                served[capture] = _serve_infer(eng, reqs, per)
            finally:
                eng.close()
        outs, launches, summary = served[True]
        eager_outs, eager_launches, eager_summary = served[False]
        same_bits = all(np.array_equal(a, b)
                        for a, b in zip(outs, eager_outs))
        prog, logits = eng._program, eng._fetch_vars[0]
        n_dq = per["dequant_matmul"]
        int8 = {n for n in eng._scope.local_var_names()
                if n.endswith("@INT8")}
        assert int8 and all(eng._scope.var(n).dtype == torch.int8
                            and eng._scope.var(n).device == place.device
                            for n in int8), "int8 weights off the card"
        # the oracles: each request alone through the quantized and the fp
        # programs (the fp masters are still in the engine's scope)
        errs, deltas = [], []
        with torch.inference_mode():
            with open(os.path.join(fp_dir, "__model__")) as f:
                fp_prog = pt.Program.from_dict(json.load(f)["program"])
            for q, out in zip(reqs, outs):
                assert out.shape == (len(q["tok"]), model["vocab_size"])
                want = _direct(eng._exe, prog, logits.name, eng._scope, q)
                np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-4)
                errs.append(float(np.abs(out - want).max()))
                deltas.append(rel_l1(_direct(
                    eng._exe, fp_prog, logits.name, eng._scope, q), out))
        assert max(deltas) < INT8_BUDGET, deltas
        # the quantized program saved again and loaded cold: no pass
        with pt.scope_guard(eng._scope):
            pt.io.save_inference_model(q_dir, feeds, [logits], eng._exe,
                                       main_program=prog)
        cold = InferenceEngine(model_dir=q_dir, place=place,
                               slots=model["slots"], timeout_s=900.0)
        try:
            assert cold.quantize_mode is None
            assert count_ops(cold._program, "dequant_matmul") == n_dq
            assert cold._scope.find_var("declm_logits.w_0") is None
            cold_outs, cold_launches, cold_summary = _serve_infer(cold, reqs,
                                                                  per)
        finally:
            cold.close()
        cold_err = max(float(np.abs(a - b).max())
                       for a, b in zip(cold_outs, outs))
        assert cold_err <= 2e-4, cold_err

        def mb(d):
            return sum(os.path.getsize(os.path.join(d, f))
                       for f in os.listdir(d)) / 1e6
        summary.update(
            eager=eager_summary, same_bits_as_eager=same_bits,
            quantize="weight_only", dequant_matmul_per_batch=n_dq,
            launches=launches, vs_direct_max_abs_err=max(errs),
            vs_fp_rel_l1_max=max(deltas), artifact_fp_mb=mb(fp_dir),
            artifact_int8_mb=mb(q_dir), cold=cold_summary,
            cold_launches=cold_launches, cold_vs_first_max_abs_err=cold_err)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if not os.listdir(tmp):
            os.rmdir(tmp)

    def record(launches, s):
        return launch_record(
            s["capture"], launches,
            {k: n * s["batches"] for k, n in per.items()},
            s["profiled_pass"],
            {k: n * s["profiled_batches"] for k, n in per.items()})
    return summary, {"infer": record(launches, summary),
                     "infer:eager": record(eager_launches, eager_summary),
                     "infer_cold": record(cold_launches, cold_summary)}


def infer_bf16_phase(place, model=MODEL, n_requests=N_REQUESTS,
                     length_range=(32, 256)):
    """The decoder's score program saved in float32, loaded, rewritten by
    ``contrib.Bfloat16Transpiler`` (bfloat16 parameters in the scope, #1
    and #3 in bfloat16, the logits cast back to float32) and saved again
    (``io`` writes bfloat16 as float32); served cold from that artifact
    by ``InferenceEngine`` (captured: each bucket's second dispatch
    captured, the rest replayed).  Each request's [T, vocab] logits come
    back float32 and within relative L1 ``INFER_BF16_BAND`` of a direct
    run of the float32 program; the engine's parameters are bfloat16 on
    the card.  Returns (summary, {path: launch record})."""
    import shutil
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import Bfloat16Transpiler
    from paddle_tpu_torch.serving import InferenceEngine, build_decoder_lm

    tmp = os.path.join(REPO, "_smoke_tmp")
    os.makedirs(tmp, exist_ok=True)
    work = tempfile.mkdtemp(dir=tmp)
    try:
        spec = build_decoder_lm(**model)
        exe, scope = pt.Executor(place), pt.Scope()
        spec.init_scope(exe, scope)
        feeds = ["tok", "tok@LEN", "pos"]
        fp_dir, bf_dir = os.path.join(work, "fp"), os.path.join(work, "bf16")
        with pt.scope_guard(scope):
            pt.io.save_inference_model(fp_dir, feeds, [spec.score_logits],
                                       exe, main_program=spec.score_program)
        rewrite_scope = pt.Scope()
        with pt.scope_guard(rewrite_scope):
            prog, _, fetch = pt.io.load_inference_model(fp_dir, exe)
            Bfloat16Transpiler().transpile(prog, place, scope=rewrite_scope,
                                           fetch_targets=fetch)
            pt.io.save_inference_model(bf_dir, feeds, fetch, exe,
                                       main_program=prog)
        del rewrite_scope
        reqs = _infer_requests(n_requests, length_range,
                               model["vocab_size"])
        eng = InferenceEngine(model_dir=bf_dir, place=place,
                              slots=model["slots"], timeout_s=900.0)
        try:
            per = serving_per_dispatch(model, eng._program)
            outs, launches, summary = _serve_infer(eng, reqs, per)
            params = [p.name for p in eng._program.all_parameters()]
            not_bf16 = [n for n in params
                        if eng._scope.var(n).dtype != torch.bfloat16
                        or eng._scope.var(n).device != place.device]
            casts = count_ops(eng._program, "cast")
            fetch_dtype = str(eng._fetch_vars[0].dtype)
        finally:
            eng.close()
        deltas = []
        with torch.inference_mode():
            for q, out in zip(reqs, outs):
                assert out.dtype == np.float32, out.dtype
                assert out.shape == (len(q["tok"]), model["vocab_size"])
                deltas.append(rel_l1(_direct(
                    exe, spec.score_program, spec.score_logits.name, scope,
                    q), out))
        summary.update(params=len(params), not_bfloat16=not_bf16,
                       cast_ops=casts, fetch_dtype=fetch_dtype,
                       vs_fp32_rel_l1_max=max(deltas),
                       vs_fp32_rel_l1_median=statistics.median(deltas),
                       band=INFER_BF16_BAND, launches=launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if not os.listdir(tmp):
            os.rmdir(tmp)
    log("infer_bf16", summary)
    if not_bf16 or max(deltas) >= INFER_BF16_BAND \
            or fetch_dtype != "torch.float32":
        raise SystemExit("the bf16 score program disagrees: %s" % summary)
    return summary, {"infer_bf16": launch_record(
        summary["capture"], launches,
        {k: n * summary["batches"] for k, n in per.items()},
        summary["profiled_pass"],
        {k: n * summary["profiled_batches"] for k, n in per.items()})}


# ---------------------------------------------------------------------------
# phases 7 and 8: the training slice
# ---------------------------------------------------------------------------

def build_train(dropout, amp=False):
    """(main, startup, cost) of bench.py's Transformer-base train program,
    built with the port's layers; with ``amp`` the optimizer is wrapped in
    ``contrib.mixed_precision.decorate``, as bench.py's ``_maybe_amp``
    does for its default (bf16) rungs.  Fixed program seeds: every run
    starts from the same random weights and draws the same dropout
    masks."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import transformer

    main, startup = pt.Program(), pt.Program()
    main.random_seed, startup.random_seed = 2, 1
    with pt.program_guard(main, startup):
        words = [pt.layers.data(n, shape=[1], dtype="int64", lod_level=1)
                 for n in ("src_word", "tgt_word", "lbl_word")]
        cost, _ = transformer.transformer(
            *words, TRAIN_SEQ, TRAIN_SEQ, TRAIN_VOCAB, TRAIN_VOCAB,
            dropout_rate=dropout, label_smooth_eps=0.1, **TRAIN)
        lr = pt.layers.noam_decay(TRAIN["d_model"], 4000)
        opt = optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.997,
                             epsilon=1e-9)
        if amp:
            opt = mixed_precision.decorate(opt)
        opt.minimize(cost)
    return main, startup, cost


def float32_state_faults(program, scope):
    """The persistables ``program`` declares float32 whose scope value is
    not: under AMP the parameters, the optimizer's moments and velocities
    and the running statistics stay float32 masters."""
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and v.dtype == torch.float32
                  and scope.find_var(v.name) is not None
                  and scope.find_var(v.name).dtype != torch.float32)


def train_feed(rng, batch):
    """Random ids in [2, vocab) (as bench.py draws them); source and
    target lengths drawn per row in [16, 64], the labels padded as the
    target."""
    src_len = rng.randint(16, TRAIN_SEQ + 1, batch).astype("int32")
    tgt_len = rng.randint(16, TRAIN_SEQ + 1, batch).astype("int32")
    feed = {n: rng.randint(2, TRAIN_VOCAB, (batch, TRAIN_SEQ, 1))
            .astype("int64") for n in ("src_word", "tgt_word", "lbl_word")}
    feed.update({"src_word@LEN": src_len, "tgt_word@LEN": tgt_len,
                 "lbl_word@LEN": tgt_len})
    return feed


def kernel_launches_per_step(program):
    """Each kernel's launches in one step, from the program's ops: a grad
    op reruns its forward (the generic grad's recompute), so each forward
    kernel launches once per forward op and once per grad op."""
    n = {}
    for op in program.global_block().ops:
        n[op.type] = n.get(op.type, 0) + 1
    per = {}
    for kernel, op in (("flash_attention", "fused_attention"),
                       ("layer_norm", "layer_norm"),
                       ("softmax_xent", "softmax_with_cross_entropy")):
        grads = n.get(op + "_grad", 0)
        per[kernel + "_fwd"] = n.get(op, 0) + grads
        per[kernel + "_bwd"] = grads
    return per


# Under AMP no fixed gradient band holds at batch 4, on either device:
# scaling every weight by (1 + 1e-7 N(0, 1)) moves the AMP step's
# gradients by 3.5e-2 relative L2 at the median and 2.46 at most on the
# CPU (the decoder's self-attention q/k weights: near-uniform attention
# at initialisation makes their gradient a difference of near-equal sums,
# and bf16 rounds each term at 2^-8).  So under AMP the card is held to
# the CPU as ``resnet_check`` holds it: within ``floor_scale`` times a
# floor that nudge gives on the card in the same call, median and maximum.
AMP_NUDGE = 1e-7


def relu_sign_flips(program, feed, got, want):
    """The ReLU inputs (the FFNs' first products) whose sign differs
    between two runs of ``program`` (``got``, ``want``: the fetches of
    ``relu_inputs``), at the rows' valid positions: (count, the largest
    magnitude among them)."""
    n, top = 0, 0.0
    for name, a, b in zip(relu_inputs(program), got, want):
        lens = feed["src_word@LEN" if name.startswith("enc")
                    else "tgt_word@LEN"]
        valid = np.arange(a.shape[1])[None, :] < lens[:, None]
        flip = np.sign(a[valid]) != np.sign(b[valid])
        n += int(flip.sum())
        if flip.any():
            top = max(top, float(np.abs(a[valid][flip]).max()))
    return n, top


def relu_inputs(program):
    return [op.inputs["X"][0] for op in program.global_block().ops
            if op.type == "relu"]


@contextlib.contextmanager
def relu_decisions(program, card_inputs):
    """While open, each ``relu`` op of ``program`` keeps the units that the
    card kept: Out = X * (the card's X > 0), ``card_inputs`` being the
    card's fetches of ``relu_inputs`` (or {relu input name: the card's
    fetch of it}; a relu whose input is not named computes as usual).  The
    CPU step then takes the card's side wherever a ReLU input lies within
    float32 rounding of 0 and computes every value itself; its backward
    (the generic grad reruns the forward) passes the gradient through the
    same units."""
    from paddle_tpu_torch import registry

    if not isinstance(card_inputs, dict):
        card_inputs = dict(zip(relu_inputs(program), card_inputs))
    keep = {i: torch.from_numpy(card_inputs[op.inputs["X"][0]] > 0)
            for i, op in enumerate(program.global_block().ops)
            if op.type == "relu" and op.inputs["X"][0] in card_inputs}
    relu = registry.get_op_def("relu")
    plain = relu.compute

    def compute(ins, attrs, ctx, op_index):
        if op_index not in keep:
            return plain(ins, attrs, ctx, op_index)
        x = ins["X"][0]
        return {"Out": x * keep[op_index].to(x.device, x.dtype)}

    relu.compute = compute
    try:
        yield
    finally:
        relu.compute = plain


TRAIN_CHECK_FAULTS = ("tf32", "klen")


def train_check_phase(batch=4, amp=False, floor_scale=3.0, feed=None,
                      name=None, fault=None):
    """One step of the dropout-0 program on the card and on the CPU from
    one startup state: losses within rtol 1e-4; the parameters' gradients
    within relative L2 1e-4 at the median and 1e-2 for every one; the
    parameters moved.  ``feed`` (``realdist``: a bucket's ragged rows at
    its pad bound) replaces the random batch of ``batch`` rows; the phase
    logs as ``name``.

    In float32 the CPU step takes the card's ReLU decisions
    (``relu_decisions``): where a ReLU input lies within float32 rounding
    of 0 (~1e-6 relative), the two devices may take opposite sides, and
    that unit's gradient for that token appears on one side only.  One
    such flip moves an FFN weight's gradient by ~1e-3 relative L2 and
    every parameter upstream of it a little; a whole realdist bucket
    (6-7k real tokens, 2048 units a layer) flips tens of them, which
    alone puts the median above 1e-4.  With the card's decisions the
    comparison sees rounding and faults only, at the fixed band.  The
    inputs that did take opposite sides are counted and reported
    (``relu_sign_flips``).

    ``fault`` plants a fault on the card's side, to show that the check
    fails on it: ``"tf32"`` lets cuBLAS round float32 products to TF32,
    ``"klen"`` feeds the card every ``src_word@LEN`` one shorter.  The
    phase then returns its summary (``within`` False when the check
    caught the fault) and does not raise.

    With ``amp`` (``train_amp_check``) the program is built under
    ``decorate`` and the CPU takes its own ReLU decisions; the losses
    agree within rtol 1e-2, the gradients within ``floor_scale`` times the
    floor of an ``AMP_NUDGE`` nudge (the CPU tests' fixed band, 2e-2 at
    the median, is reported beside it), and every float32 persistable is
    still float32 after the step."""
    import paddle_tpu_torch as pt

    assert fault in (None,) + TRAIN_CHECK_FAULTS and not (fault and amp)
    main, startup, cost = build_train(0.0, amp)
    params = [p.name for p in main.all_parameters() if p.trainable]
    card_scope, cpu_scope = pt.Scope(), pt.Scope()
    card = pt.Executor(pt.CUDAPlace(0))
    card.run(startup, scope=card_scope)
    for n in card_scope.local_var_names():
        cpu_scope.set_var(n, card_scope.var(n).cpu().clone())
    before = {n: cpu_scope.var(n).clone() for n in params}
    if feed is None:
        feed = train_feed(np.random.RandomState(11), batch)
    card_feed = dict(feed)
    if fault == "klen":
        card_feed["src_word@LEN"] = np.maximum(feed["src_word@LEN"] - 1,
                                               1).astype("int32")
    fetch = [cost.name] + [n + "@GRAD" for n in params] + relu_inputs(main)
    k = 1 + len(params)
    if amp:
        # the floor: the same step on the card with every weight nudged
        g = torch.Generator().manual_seed(0)
        nudged_scope = pt.Scope()
        for n in cpu_scope.local_var_names():
            v = cpu_scope.var(n).clone()
            if n in params:
                v.mul_(1 + AMP_NUDGE * torch.randn(v.shape, generator=g))
            nudged_scope.set_var(n, v.cuda())
        nudged = card.run(main, feed=feed, fetch_list=fetch[:k],
                          scope=nudged_scope)
    torch.backends.cuda.matmul.allow_tf32 = fault == "tf32"
    try:
        t0 = time.perf_counter()
        got = card.run(main, feed=card_feed, fetch_list=fetch,
                       scope=card_scope)
        card_s = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    cpu = pt.Executor(pt.CPUPlace())
    t0 = time.perf_counter()
    with (contextlib.nullcontext() if amp
          else relu_decisions(main, got[k:])):
        want = cpu.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    assert all(np.isfinite(a).all() for a in got), "non-finite on the card"
    flips, flip_top = relu_sign_flips(main, feed, got[k:], want[k:])
    got, want = got[:k], want[:k]
    loss_rtol = 1e-2 if amp else 1e-4
    loss_within = bool(np.all(np.abs(got[0] - want[0])
                              <= loss_rtol * np.abs(want[0])))
    rel = _grad_rel_l2(params, got[1:], want[1:])
    ranked = sorted(rel, key=rel.get, reverse=True)
    med = statistics.median(rel.values())
    moved = sum(not torch.equal(before[n], card_scope.var(n).cpu())
                for n in params)
    rows, seq = feed["src_word"].shape[:2]
    summary = {"batch": rows, "seq": seq, "tokens": rows * seq, "amp": amp,
               "fault": fault,
               "real_tokens": int(feed["src_word@LEN"].sum()),
               "loss_card": float(got[0][0]), "loss_cpu": float(want[0][0]),
               "params": len(params), "moved": moved,
               "grad_rel_l2_top5": [[n, rel[n]] for n in ranked[:5]],
               "grad_rel_l2_median": med,
               "relu_sign_flips": flips, "relu_flip_max_abs": flip_top,
               "cpu_takes_card_relu": not amp,
               "not_float32": float32_state_faults(main, card_scope),
               "card_step_s": card_s, "cpu_step_s": cpu_s}
    if amp:
        floor = _grad_rel_l2(params, nudged[1:], got[1:])
        floor_med = statistics.median(floor.values())
        floor_max = max(floor.values())
        summary.update(nudge=AMP_NUDGE, floor_scale=floor_scale,
                       floor_rel_l2_median=floor_med,
                       floor_rel_l2_max=floor_max,
                       floor_worst=max(floor, key=floor.get),
                       fixed_band_median_2e_2_met=med <= 2e-2)
        within = med <= floor_scale * floor_med \
            and rel[ranked[0]] <= floor_scale * floor_max
    else:
        within = rel[ranked[0]] <= 1e-2 and med <= 1e-4
    summary["within"] = within = bool(within and loss_within)
    log(name or ("train_amp_check" if amp else "train_check"), summary)
    if fault:
        return summary
    if not within or moved != len(params) or summary["not_float32"]:
        raise SystemExit("card and CPU disagree on the training step: %s"
                         % summary)
    return summary


def copy_scope(scope, device=None):
    """A scope holding clones of ``scope``'s tensors (copies on ``device``
    if given)."""
    import paddle_tpu_torch as pt

    out = pt.Scope()
    for n in scope.local_var_names():
        t = scope.var(n)
        out.set_var(n, t.clone() if device is None
                    else t.to(device, copy=True))
    return out


def state_rel_l2(a, b):
    """{name: relative L2 distance} of the tensors of two scopes that are
    not the same bits (empty when every one is)."""
    out = {}
    for n in a.local_var_names():
        x, y = a.var(n), b.var(n)
        if not torch.equal(x, y):
            x, y = x.double(), y.double()
            out[n] = float((x - y).norm() / y.norm().clamp_min(1e-30))
    return out


def _step(run, program, feed, fetch):
    """One timed ``Executor.run`` of ``run`` (its executor and scope) that
    fetches the loss (the fetch waits for the step's device work); keeps
    the loss's float32 value and the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (loss,) = run["exe"].run(program, feed=feed, fetch_list=[fetch],
                             scope=run["scope"])
    dt = time.perf_counter() - t0
    run["losses"].append(float(loss[0]))
    run["peak"] = max(run["peak"], torch.cuda.max_memory_allocated())
    return dt


def train_phase(place, steps=TRAIN_STEPS, batch=TRAIN_BATCH, amp=False):
    """The dropout-0.1 program from one startup state in two executors:
    eager (``capture=False``) and captured (the default: the first step
    eager, the second captured and replayed, the rest replayed).  Two
    untimed steps each (the captured executor's second is its capture,
    timed apart), then ``steps`` timed steps taken in turns, each with the
    launch counters zeroed just before and read just after, then one
    profiled step each (device busy time, idle share).  The two must give
    the same loss bits at every step and the same bits in every scope
    tensor (parameters, moments, counters) after them; then a parameter
    is swapped in both scopes (a tensor in the eager one, a numpy array in
    the captured one) between two runs, and the next step must again give
    the same bits, with the captured scope pointed back at the captured
    tensor.  With ``amp`` (``train_amp``, paths ``train_amp`` and
    ``train_amp:eager``) the program is built under ``decorate``: #1 and #2
    run in bfloat16, and every float32 persistable (parameters, Adam
    moments, the step counter) must still be float32 in both scopes at
    the end.  Returns (summary, {path: launch record})."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda

    main, startup, cost = build_train(0.1, amp)
    start = pt.Scope()
    pt.Executor(place).run(startup, scope=start)
    rng = np.random.RandomState(0)
    feeds = [train_feed(rng, batch) for _ in range(steps + 4)]
    # the captured arm first: a capture empties the allocator's cache, which
    # the eager arm then refills before it is timed
    runs = {arm: {"exe": pt.Executor(place, capture=arm == "captured"),
                  "scope": copy_scope(start), "losses": [], "times": [],
                  "launches": {}, "peak": 0}
            for arm in ("captured", "eager")}
    del start
    first = {arm: [_step(r, main, f, cost) for f in feeds[:2]]
             for arm, r in runs.items()}
    for i, f in enumerate(feeds[2:2 + steps]):
        for arm in (("eager", "captured") if i % 2 == 0
                    else ("captured", "eager")):
            r = runs[arm]
            cuda.reset_launch_counts()
            r["times"].append(_step(r, main, f, cost))
            for k, n in cuda.launch_counts().items():
                r["launches"][k] = r["launches"].get(k, 0) + n
    windows = {arm: device_window(lambda r=r: _step(r, main,
                                                    feeds[2 + steps], cost))
               for arm, r in runs.items()}
    same_losses = runs["eager"]["losses"] == runs["captured"]["losses"]
    diff = state_rel_l2(runs["captured"]["scope"], runs["eager"]["scope"])
    # a state swap between two captured runs: the next replay must see it
    name = main.all_parameters()[0].name
    captured_tensor = runs["captured"]["scope"].find_var(name)
    swapped = runs["eager"]["scope"].find_var(name) * 0.5
    runs["eager"]["scope"].set_var(name, swapped.clone())
    runs["captured"]["scope"].set_var(name, swapped.cpu().numpy())
    for r in runs.values():
        _step(r, main, feeds[-1], cost)
    swap_same = runs["eager"]["losses"] == runs["captured"]["losses"] \
        and not state_rel_l2(runs["captured"]["scope"],
                             runs["eager"]["scope"])
    swap_seen = runs["captured"]["scope"].find_var(name) is captured_tensor
    per_step = kernel_launches_per_step(main)
    not_f32 = {arm: float32_state_faults(main, r["scope"])
               for arm, r in runs.items()}
    summary = {"batch": batch, "seq": TRAIN_SEQ, "steps": steps, "amp": amp,
               "ops": len(main.global_block().ops),
               "not_float32": not_f32,
               "same_loss_bits": same_losses,
               "state_not_bit_equal": diff, "swap_param": name,
               "swap_same_bits": swap_same, "swap_seen_by_replay": swap_seen,
               "launches_per_step": per_step,
               "reserved_gb": torch.cuda.memory_reserved() / 1e9}
    for arm, r in runs.items():
        step_s = statistics.median(r["times"])
        summary[arm] = {
            "first_steps_ms": [t * 1e3 for t in first[arm]],
            "losses": r["losses"], "step_ms": [t * 1e3 for t in r["times"]],
            "median_step_ms": step_s * 1e3,
            "tokens_per_s": batch * TRAIN_SEQ / step_s,
            "target_tokens_per_s": float(np.median(
                [f["tgt_word@LEN"].sum() for f in feeds[2:2 + steps]]))
            / step_s,
            "profiled_step": windows[arm], "peak_mem_gb": r["peak"] / 1e9,
            "launches": r["launches"]}
        assert all(np.isfinite(r["losses"])), r["losses"]
    name = "train_amp" if amp else "train"
    log(name, summary)
    if not (same_losses and not diff and swap_same and swap_seen) \
            or any(not_f32.values()):
        raise SystemExit("the captured training step differs from the "
                         "eager one, or a master left float32: %s" % {
                             k: summary[k] for k in (
                                 "same_loss_bits", "state_not_bit_equal",
                                 "swap_same_bits", "swap_seen_by_replay",
                                 "not_float32")})
    return summary, {
        (name if arm == "captured" else name + ":eager"): launch_record(
            arm == "captured", r["launches"],
            {k: n * steps for k, n in per_step.items()}, windows[arm],
            per_step)
        for arm, r in runs.items()}


# ---------------------------------------------------------------------------
# phases 9 and 10: the ResNet-50 training slice
# ---------------------------------------------------------------------------

RESNET_MODES = ("plain", "fuse", "nhwc_fuse")
RESNET_BATCH, RESNET_STEPS, RESNET_FUSED = 128, 5, 30


def build_resnet(mode, amp=False, uint8=False):
    """(main, startup, loss) of bench.py's ResNet-50 train program
    (``resnet_imagenet`` depth 50 on 3x224x224 float32, class_dim 1000,
    mean cross-entropy, Momentum(1e-3, 0.9)), built with the port's
    layers; ``mode`` adds ``fuse_conv_bn`` (fuse) or ``convert_to_nhwc``
    then ``fuse_conv_bn`` (nhwc_fuse) before ``minimize``, as bench.py
    does, and ``amp`` wraps the optimizer in ``decorate`` (bench.py's
    default rungs).  With ``uint8`` the image feed is bench.py's
    reader-included one (``bench.py:1476-1481``): uint8 pixels, cast to
    float32 and scaled by 1/255 on the device.  Fixed seeds and fresh
    names: every mode has the same parameters and the same startup
    state."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models.resnet import resnet_imagenet

    main, startup = pt.Program(), pt.Program()
    main.random_seed, startup.random_seed = 2, 1
    with pt.program_guard(main, startup), pt.unique_name.guard():
        if uint8:
            raw = pt.layers.data("img", shape=[3, 224, 224], dtype="uint8")
            img = pt.layers.scale(pt.layers.cast(raw, "float32"),
                                  scale=1.0 / 255.0)
        else:
            img = pt.layers.data("img", shape=[3, 224, 224])
        label = pt.layers.data("label", shape=[1], dtype="int64")
        pred = resnet_imagenet(img, class_dim=1000, depth=50)
        loss = pt.layers.mean(pt.layers.cross_entropy(pred, label))
        if mode == "nhwc_fuse":
            assert pt.transpiler.convert_to_nhwc(main) == 53
        if mode != "plain":
            assert pt.transpiler.fuse_conv_bn(main) == 53
        opt = pt.optimizer.Momentum(learning_rate=1e-3, momentum=0.9)
        if amp:
            opt = mixed_precision.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def resnet_feed(rng, batch):
    return {"img": rng.rand(batch, 3, 224, 224).astype("float32"),
            "label": rng.randint(0, 1000, (batch, 1)).astype("int64")}


def shared_relus(main, other):
    """The inputs of the ``relu`` ops that ``main`` runs (their output is
    read by a later op) and ``other`` has too."""
    ops = main.global_block().ops
    read = {n for op in ops for n in op.input_arg_names}
    other_inputs = set(relu_inputs(other))
    return [op.inputs["X"][0] for op in ops if op.type == "relu"
            and op.outputs["Out"][0] in read
            and op.inputs["X"][0] in other_inputs]


def _grad_rel_l2(names, got, want):
    rel = {}
    for n, a, b in zip(names, got, want):
        den = float(np.linalg.norm(b))
        rel[n] = float(np.linalg.norm(a - b)) / den if den else \
            float(np.linalg.norm(a))
    return rel


def resnet_check_phase(batch=4, floor_scale=3.0, amp=False,
                       build=build_resnet, modes=("fuse", "nhwc_fuse"),
                       name=None, take_relus=None):
    """The fused programs (NCHW and NHWC) at full width, batch 4, from one
    startup state: one step on the card (kernels #8-#11) against one on the
    CPU (their plain versions), and against the plain program on the card.
    Losses within rtol 1e-4.

    Gradients are held against a floor measured in the same call, not a
    fixed band: the plain program on the card from the startup state with
    every parameter scaled by (1 + 1e-7 N(0, 1)), against the plain
    program from the state itself.  At batch 4 ResNet-50's backward
    through 53 batch norms amplifies rounding with depth: on the CPU (port,
    plain versions) that perturbation moved the gradients by 2.3e-2
    relative L2 at the median and 2.7e-2 at most (the first conv's most,
    the fc's 2.4e-5), so no run that sums in another order can match to
    1e-4.  Each comparison must stay within ``floor_scale`` times the
    floor's median (at the median) and its maximum (for every parameter).
    On the CPU the fused program sat at 7.2e-3 / 1.0e-2 from the plain
    one, and a fused backward folding with the running mean after its
    update (the JAX package's shift fault) at 2.9e-2 / 4.15: the maximum
    is what catches a wrong backward.

    With ``amp`` (``resnet_amp_check``) every program is built under
    ``decorate`` and held by the same method; the losses agree within
    rtol 1e-2, and every float32 persistable must still be float32 after
    the card's step.  Under AMP the floor is of the order of the gradients
    themselves: on the CPU the nudge moved the batch-4 step's gradients by
    0.96 relative L2 at the median (1.16 at most), and the last stage's
    forward activations by 0.33 already (bf16 rounds each layer's output
    at 2^-8 and the net amplifies it block by block); at batch 64 still
    0.97.  So there the gradients catch only a gross fault; the fused
    kernels are held to their plain versions in bfloat16 in the kernels
    phase.

    ``build(mode, amp)`` and ``modes`` take another model through the same
    check (``resnext_check``: SE-ResNeXt-50, NCHW fused), logged under
    ``name``.  With ``take_relus`` (a name prefix) every other run (the
    plain program, the nudged one, the CPU) takes the fused card step's
    ReLU decisions (``relu_decisions``) at the ``relu`` ops both programs
    run on the same input (``shared_relus``) whose input is named with
    that prefix: at SE-ResNeXt's squeeze fcs (``fc_*``, 128-512 units a
    block at batch 4) an input within rounding of 0 that takes the other
    sign moves that fc's whole gradient column, which a 1e-7 nudge of the
    weights seldom does.  The same comparison with each run's own
    decisions is logged beside it, not gated (``own_relus``), and each
    comparison logs the units of every shared relu whose input takes the
    other sign than in the fused card step (``relus_differ_plain_card``,
    ``relus_differ_cpu``)."""
    import paddle_tpu_torch as pt

    card = pt.Executor(pt.CUDAPlace(0))
    cpu = pt.Executor(pt.CPUPlace())
    feed = resnet_feed(np.random.RandomState(11), batch)
    plain, startup, plain_loss = build("plain", amp)
    start = pt.Scope()
    card.run(startup, scope=start)
    params = [p.name for p in plain.all_parameters() if p.trainable]
    fetch = [n + "@GRAD" for n in params]

    def scope_copy(device, perturb=0.0):
        sc = pt.Scope()
        g = torch.Generator().manual_seed(0)
        for n in start.local_var_names():
            v = start.var(n).to(device, copy=True)
            if perturb and n in params:
                v.mul_(1 + perturb * torch.randn(v.shape, generator=g)
                       .to(device))
            sc.set_var(n, v)
        return sc

    relus, fused, decisions = [], {}, {}
    if take_relus:
        main, _, loss = build(modes[0], amp)
        relus = shared_relus(main, plain)
        got = card.run(main, feed=feed, fetch_list=[loss] + relus,
                       scope=scope_copy("cuda"))
        fused = dict(zip(relus, got[1:]))
        decisions = {n: x for n, x in fused.items()
                     if n.startswith(take_relus)}
    n_fetch = 1 + len(fetch)

    def differ(inputs):
        # {relu input: [units whose input takes the other sign than in the
        # fused card step (with each run's own decisions: the units that
        # decide otherwise; with the fused step's: those it overrides),
        # the largest |fused card input| among them]}
        out = {}
        for n, x in zip(relus, inputs):
            if x.ndim == 4 and fused[n].shape != x.shape:
                # an NHWC fused step against the NCHW plain program
                x = x.transpose(0, 2, 3, 1)
            d = (fused[n] > 0) != (x > 0)
            if d.any():
                out[n] = [int(d.sum()), float(np.abs(fused[n][d]).max())]
        return out

    def compare(taken):
        """(summary, modes out of bounds): every run but the fused card
        step taking the ReLU decisions ``taken``."""
        with relu_decisions(plain, taken):
            plain_out = card.run(plain, feed=feed,
                                 fetch_list=[plain_loss] + fetch + relus,
                                 scope=scope_copy("cuda"))
            nudged = card.run(plain, feed=feed,
                              fetch_list=[plain_loss] + fetch,
                              scope=scope_copy("cuda", perturb=1e-7))
        floor = _grad_rel_l2(params, nudged[1:], plain_out[1:n_fetch])
        floor_med, floor_max = statistics.median(floor.values()), \
            max(floor.values())
        summary = {"floor_rel_l2_median": floor_med,
                   "floor_rel_l2_max": floor_max,
                   "loss_plain_card": float(plain_out[0][0])}
        if relus:
            summary["relus_differ_plain_card"] = differ(plain_out[n_fetch:])
        bad = []
        for mode in modes:
            main, _, loss = build(mode, amp)
            card_scope = scope_copy("cuda")
            before = {n: card_scope.var(n).clone() for n in params}
            t0 = time.perf_counter()
            got = card.run(main, feed=feed, fetch_list=[loss] + fetch,
                           scope=card_scope)
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            with relu_decisions(main, taken):
                want = cpu.run(main, feed=feed,
                               fetch_list=[loss] + fetch + relus,
                               scope=scope_copy("cpu"))
            cpu_s = time.perf_counter() - t0
            assert all(np.isfinite(a).all() for a in got), \
                "non-finite on card"
            rel = _grad_rel_l2(params, got[1:], want[1:n_fetch])
            vs_plain = _grad_rel_l2(params, got[1:], plain_out[1:n_fetch])
            moved = sum(not torch.equal(before[n], card_scope.var(n))
                        for n in params)
            m = {"loss_card": float(got[0][0]),
                 "loss_cpu": float(want[0][0]), "moved": moved,
                 "not_float32": float32_state_faults(main, card_scope),
                 "vs_cpu_rel_l2_median": statistics.median(rel.values()),
                 "vs_cpu_rel_l2_max": max(rel.values()),
                 "vs_cpu_worst": max(rel, key=rel.get),
                 "vs_plain_rel_l2_median":
                     statistics.median(vs_plain.values()),
                 "vs_plain_rel_l2_max": max(vs_plain.values()),
                 "vs_plain_worst": max(vs_plain, key=vs_plain.get),
                 "card_step_s": card_s, "cpu_step_s": cpu_s}
            if relus:
                m["relus_differ_cpu"] = differ(want[n_fetch:])
            m["within"] = all(
                m[k + "_median"] <= floor_scale * floor_med
                and m[k + "_max"] <= floor_scale * floor_max
                for k in ("vs_cpu_rel_l2", "vs_plain_rel_l2"))
            summary[mode] = m
            loss_rtol = 1e-2 if amp else 1e-4
            if abs(m["loss_card"] - m["loss_cpu"]) \
                    > loss_rtol * abs(m["loss_cpu"]) \
                    or not m["within"] or moved != len(params) \
                    or m["not_float32"]:
                bad.append(mode)
        return summary, bad

    summary = {"batch": batch, "params": len(params), "amp": amp,
               "floor_scale": floor_scale,
               "relus_taken_from_fused_card": len(decisions)}
    if take_relus:
        # the same comparison, not gated, with each run's own decisions:
        # the units that decide otherwise, and how far that moves it
        summary["own_relus"] = compare({})[0]
    out, bad = compare(decisions)
    summary.update(out)
    name = name or ("resnet_amp_check" if amp else "resnet_check")
    log(name, summary)
    if bad:
        raise SystemExit("%s: the step disagrees (card vs CPU, or fused vs "
                         "plain): %s" % (name, bad))
    return summary


def resnet_train_phase(steps=RESNET_STEPS, batch=RESNET_BATCH,
                       deterministic=True, amp=False):
    """bench.py's ResNet-50 at batch 128 (images ``rand`` in [0, 1) from
    ``RandomState(0)``, labels in [0, 1000)) on ``CUDAPlace(0)``: the three
    programs of ``RESNET_MODES``, each from one startup state in two arms,
    eager and captured, on two executors (the captured one holds the three
    programs' graphs in one memory pool), each program in a scope of its
    own per arm, all on the same batches.  Two untimed steps each (the
    captured arm's second is its capture), then ``steps`` timed steps
    taken in turns (plain, fused, NHWC, then the reverse; eager and
    captured flipping each step), each bracketed by zeroing the launch
    counters and reading them, then one profiled step each for the
    device's busy time, idle share and launches.

    With ``deterministic`` the phase runs with cuDNN's deterministic
    algorithms and PyTorch's deterministic mode
    (``use_deterministic_algorithms``, warning where an op has none; the
    warnings seen are logged), so two runs of one program sum in one
    order: the captured arm's losses at every step and every scope tensor
    after them (parameters, running statistics, velocities) must be the
    eager arm's bits.  Without it, cuDNN picks its default algorithms,
    whose backward sums with atomics in no fixed order, and the bits are
    only reported (``--resnet-default``: what determinism costs).

    With ``amp`` (``resnet_amp``) the three programs are built under
    ``decorate``: the trunk is bfloat16 after the first convolution, so the
    fused layers launch the bfloat16 #8-#11, and every float32 persistable
    (parameters, velocities, running statistics) must still be float32 in
    every scope at the end.
    Returns {mode: (summary, {arm: launch record})}."""
    import warnings

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda

    rng = np.random.RandomState(0)
    feeds = [resnet_feed(rng, batch) for _ in range(steps + 3)]
    # the captured arm first in the untimed steps: a capture empties the
    # allocator's cache, which the eager arm then refills
    arms = ("captured", "eager")
    exes = {arm: pt.Executor(pt.CUDAPlace(0), capture=arm == "captured")
            for arm in arms}
    runs = {}
    for mode in RESNET_MODES:
        main, startup, loss = build_resnet(mode, amp)
        fused = count_ops(main, "bn_act_conv2d")
        assert fused == count_ops(main, "bn_act_conv2d_grad") \
            == (RESNET_FUSED if mode != "plain" else 0), fused
        start = pt.Scope()
        # a fresh executor: every mode starts from the same weights
        pt.Executor(pt.CUDAPlace(0)).run(startup, scope=start)
        for arm in arms:
            runs[mode, arm] = dict(main=main, loss=loss, exe=exes[arm],
                                   scope=copy_scope(start), fused=fused,
                                   times=[], losses=[], peak=0, launches={})
    torch.backends.cudnn.deterministic = deterministic
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            first = {key: [_step(r, r["main"], f, r["loss"])
                           for f in feeds[:2]]
                     for key, r in runs.items()}
            for i in range(steps):
                f = feeds[2 + i]
                for mode in (RESNET_MODES if i % 2 == 0
                             else RESNET_MODES[::-1]):
                    for arm in (arms[::-1] if i % 2 == 0 else arms):
                        r = runs[mode, arm]
                        cuda.reset_launch_counts()
                        r["times"].append(_step(r, r["main"], f, r["loss"]))
                        for k, n in cuda.launch_counts().items():
                            r["launches"][k] = r["launches"].get(k, 0) + n
            windows = {key: device_window(
                lambda r=r: _step(r, r["main"], feeds[-1], r["loss"]))
                for key, r in runs.items()}
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    nondeterministic = sorted({str(w.message)[:200] for w in seen
                               if "deterministic" in str(w.message)})
    nchw = "conv_bn_fwd", "conv_bn_bwd"
    nhwc = "conv_bn_fwd_nhwc", "conv_bn_bwd_nhwc"
    out, bad = {}, []
    for mode in RESNET_MODES:
        c, e = runs[mode, "captured"], runs[mode, "eager"]
        same_losses = c["losses"] == e["losses"]
        diff = state_rel_l2(c["scope"], e["scope"])
        on = nhwc if mode == "nhwc_fuse" else nchw if mode == "fuse" else ()
        per_step = {k: e["fused"] for k in on}
        not_f32 = {arm: float32_state_faults(r["main"], r["scope"])
                   for arm, r in (("eager", e), ("captured", c))}
        summary = {"mode": mode, "batch": batch, "steps": steps,
                   "deterministic": deterministic, "amp": amp,
                   "not_float32": not_f32,
                   "ops": len(e["main"].global_block().ops),
                   "fused_layers": e["fused"],
                   "launches_per_step": per_step,
                   "same_loss_bits": same_losses,
                   "state_not_bit_equal": diff,
                   "nondeterministic_ops_warned": nondeterministic,
                   "reserved_gb": torch.cuda.memory_reserved() / 1e9}
        records = {}
        for arm, r in (("eager", e), ("captured", c)):
            step_s = statistics.median(r["times"])
            summary[arm] = {
                "first_steps_ms": [t * 1e3 for t in first[mode, arm]],
                "losses": r["losses"],
                "step_ms": [t * 1e3 for t in r["times"]],
                "median_step_ms": step_s * 1e3,
                "images_per_s": batch / step_s,
                "peak_mem_gb": r["peak"] / 1e9,
                "profiled_step": windows[mode, arm],
                "launches": r["launches"]}
            assert all(np.isfinite(r["losses"])), r["losses"]
            records[arm] = launch_record(
                arm == "captured", r["launches"],
                {k: n * steps for k, n in per_step.items()},
                windows[mode, arm], per_step)
        if deterministic and (not same_losses or diff) \
                or any(not_f32.values()):
            bad.append(mode)
        out[mode] = summary, records
    if bad:
        for mode in bad:
            log("resnet_amp" if amp else "resnet_train", out[mode][0])
        raise SystemExit("captured ResNet-50 steps differ from the eager "
                         "ones, or a master left float32: %s" % bad)
    return out


# ---------------------------------------------------------------------------
# C1/C2: the AMP check, card against CPU, at the CPU tests' configurations
# ---------------------------------------------------------------------------

# the fixed band of the AMP checks (PERF.md §2, ``tests/test_torch_amp.py``):
# loss rtol 1e-2, parameter gradients within relative L2 2e-2 at the median
AMP_LOSS_RTOL, AMP_GRAD_BAND = 1e-2, 2e-2


def build_small_transformer():
    """``tests/test_torch_amp.py``'s 2+2-layer Transformer (d_model 64,
    d_inner 128, vocab 20, max_len 8, dropout 0, noam(64, 10) + Adam under
    ``decorate``) with one head of 64: the card's attention kernels take
    a head dim of 64 only (the test's two heads are 32 wide)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import transformer

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 5
    with pt.program_guard(main, startup), pt.unique_name.guard("t_"):
        words = [pt.layers.data(n, shape=[1], dtype="int64", lod_level=1)
                 for n in ("src_word", "tgt_word", "lbl_word")]
        cost, _ = transformer.transformer(
            *words, 8, 8, 20, 20, n_layer=2, n_head=1, d_model=64,
            d_inner=128, dropout_rate=0.0)
        opt = pt.optimizer.Adam(learning_rate=pt.layers.noam_decay(64, 10),
                                beta1=0.9, beta2=0.997, epsilon=1e-9)
        mixed_precision.decorate(opt).minimize(cost)
    rng = np.random.RandomState(0)
    lens = rng.randint(3, 9, 4).astype("int32")
    feed = {n: rng.randint(0, 20, (4, 8, 1)).astype("int64")
            for n in ("src_word", "tgt_word", "lbl_word")}
    feed.update({n + "@LEN": lens for n in ("src_word", "tgt_word",
                                            "lbl_word")})
    return main, startup, cost, feed


def build_stem_net(mode):
    """``tests/test_torch_amp.py``'s bf16-stem net (3x16x16 images, a 3x3
    conv into BN + ReLU, 1x1 -> 128, 1x1 -> 64, 3x3, a residual add,
    global pool, fc to 5 classes; BN momentum 1.0) under ``decorate``
    (Momentum(0.05, 0.9)), plain, fused or NHWC + fused: the fused layers
    take bfloat16 (#8-#11 in bf16).  Batch 8."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import mixed_precision

    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 7
    with pt.program_guard(main, startup), pt.unique_name.guard("t_"):
        img = L.data("img", shape=[3, 16, 16])
        label = L.data("label", shape=[1], dtype="int64")
        c0 = L.conv2d(img, num_filters=64, filter_size=3, padding=1,
                      bias_attr=False)
        b0 = L.batch_norm(c0, act="relu", momentum=1.0)
        c1 = L.conv2d(b0, num_filters=128, filter_size=1, bias_attr=False)
        b1 = L.batch_norm(c1, act="relu", momentum=1.0)
        c2 = L.conv2d(b1, num_filters=64, filter_size=1, bias_attr=False)
        b2 = L.batch_norm(c2, act="relu", momentum=1.0)
        c3 = L.conv2d(b2, num_filters=64, filter_size=3, padding=1,
                      bias_attr=False)
        b3 = L.batch_norm(c3, act=None, momentum=1.0)
        res = L.elementwise_add(x=b3, y=b0, act="relu")
        pool = L.pool2d(res, pool_size=16, pool_type="avg",
                        global_pooling=True)
        pred = L.fc(pool, size=5, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        if "nhwc" in mode:
            assert pt.transpiler.convert_to_nhwc(main) > 0
        if "fuse" in mode:
            assert pt.transpiler.fuse_conv_bn(main) > 0
        mixed_precision.decorate(pt.optimizer.Momentum(
            learning_rate=0.05, momentum=0.9)).minimize(loss)
    rng = np.random.RandomState(3)
    feed = {"img": rng.rand(8, 3, 16, 16).astype("float32"),
            "label": rng.randint(0, 5, (8, 1)).astype("int64")}
    return main, startup, loss, feed


def amp_small_check(build, floor_scale=3.0):
    """One AMP step of a small program on the card and on the CPU from one
    startup state (the CPU tests' configuration): the fixed band (loss
    rtol 1e-2, gradients relative L2 2e-2 at the median) and, beside it,
    the floor a 1e-7 nudge of every weight gives on the card in the same
    call (median and maximum).  Returns the summary; ``band_met`` says
    whether the fixed band held."""
    import paddle_tpu_torch as pt

    main, startup, loss, feed = build()
    params = [p.name for p in main.all_parameters() if p.trainable]
    card = pt.Executor(pt.CUDAPlace(0))
    card_scope, cpu_scope, nudged_scope = pt.Scope(), pt.Scope(), pt.Scope()
    card.run(startup, scope=card_scope)
    g = torch.Generator().manual_seed(0)
    for n in card_scope.local_var_names():
        v = card_scope.var(n).cpu().clone()
        cpu_scope.set_var(n, v)
        if n in params:
            v = v * (1 + AMP_NUDGE * torch.randn(v.shape, generator=g))
        nudged_scope.set_var(n, v.cuda())
    fetch = [loss.name] + [n + "@GRAD" for n in params]
    nudged = card.run(main, feed=feed, fetch_list=fetch, scope=nudged_scope)
    got = card.run(main, feed=feed, fetch_list=fetch, scope=card_scope)
    want = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                          scope=cpu_scope)
    assert all(np.isfinite(a).all() for a in got), "non-finite on the card"
    rel = _grad_rel_l2(params, got[1:], want[1:])
    floor = _grad_rel_l2(params, nudged[1:], got[1:])
    med, floor_med = statistics.median(rel.values()), \
        statistics.median(floor.values())
    loss_rel = abs(float(got[0][0]) - float(want[0][0])) \
        / abs(float(want[0][0]))
    ranked = sorted(rel, key=rel.get, reverse=True)
    return {"params": len(params), "loss_card": float(got[0][0]),
            "loss_cpu": float(want[0][0]), "loss_rel": loss_rel,
            "grad_rel_l2_median": med, "grad_rel_l2_max": rel[ranked[0]],
            "grad_rel_l2_top3": [[n, rel[n]] for n in ranked[:3]],
            "floor_rel_l2_median": floor_med,
            "floor_rel_l2_max": max(floor.values()),
            "band": {"loss_rtol": AMP_LOSS_RTOL,
                     "grad_median": AMP_GRAD_BAND},
            "band_met": loss_rel <= AMP_LOSS_RTOL and med <= AMP_GRAD_BAND,
            "within_3x_floor": med <= floor_scale * floor_med
            and rel[ranked[0]] <= floor_scale * max(floor.values()),
            "not_float32": float32_state_faults(main, card_scope)}


def amp_small_checks():
    """``resnet_amp_small_check`` (the stem net, plain / fused / NHWC +
    fused) must meet the fixed band.  ``train_amp_small_check`` (the
    2+2-layer Transformer) is held, as ``train_amp_check`` is, within 3x
    its same-call floor, and reports the fixed band beside it: on an
    NVIDIA H100 80GB HBM3 at 700 W the floor itself (a 1e-7 nudge, card
    against card) read 3.19e-2 at the median, above the band's 2e-2, so
    no two implementations that round in another order can meet the band
    there (ROADMAP Queue C1)."""
    t = amp_small_check(build_small_transformer)
    log("train_amp_small_check", t)
    r = {mode: amp_small_check(lambda m=mode: build_stem_net(m))
         for mode in RESNET_MODES}
    log("resnet_amp_small_check", r)
    bad = [mode for mode, s in r.items()
           if not s["band_met"] or s["not_float32"]]
    if not t["within_3x_floor"] or t["not_float32"]:
        bad.append("transformer")
    if bad:
        raise SystemExit("the AMP step, card against CPU, at the small "
                         "configurations: %s" % bad)


# ---------------------------------------------------------------------------
# the input pipeline and the high-level trainer
# ---------------------------------------------------------------------------

MLP_BATCH = 256


def synthetic_mnist(rng, n):
    """``tests/test_mnist_mlp.py``'s learnable rule: the class is the
    argmax of 10 fixed projections of 784 uniform pixels."""
    x = rng.rand(n, 784).astype("float32")
    proj = np.linspace(-1, 1, 7840).reshape(784, 10).astype("float32")
    return x, (x @ proj).argmax(axis=1).astype("int64").reshape(-1, 1)


def mlp_train_func():
    """bench.py's MLP (``bench.py:1408-1450``): 784-256-256-10, softmax,
    mean cross-entropy; returns [loss, accuracy]."""
    import paddle_tpu_torch as pt

    img = pt.layers.data("img", shape=[784])
    label = pt.layers.data("label", shape=[1], dtype="int64")
    h = pt.layers.fc(img, size=256, act="relu")
    h = pt.layers.fc(h, size=256, act="relu")
    pred = pt.layers.fc(h, size=10, act="softmax")
    return [pt.layers.mean(pt.layers.cross_entropy(pred, label)),
            pt.layers.accuracy(pred, label)]


def mlp_trainer_phase(steps=20, windows=3, window_steps=50,
                      trainer_epochs=6, trainer_batches=60):
    """The MNIST MLP (Adam 1e-3, batch 256) on ``CUDAPlace(0)``:

    * captured and eager from one startup state over ``steps`` steps on
      the same batches: the losses and accuracies and every scope tensor
      after them are the same bits;
    * bench.py's compute rung: ``Executor.run`` on one batch staged on the
      card, ``windows`` windows of ``window_steps`` replays, one loss read
      a window (images/s of the best and the median window), a profiled
      window for the idle share, and the executor's graph count (1);
    * the user path: ``Trainer.train`` over a ``reader.batch`` reader of
      256 sample rows a batch, the ``DataFeeder`` converting every batch
      and the loss and accuracy fetched every step (images/s of each
      epoch after the first: median, least and most), whose loss must
      fall as in
      ``test_mnist_mlp_trains`` (last < 0.8 x first, the last ten
      accuracies >= the first ten)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import Trainer

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 3
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, acc = mlp_train_func()
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    start = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=start)
    rng = np.random.RandomState(42)
    feeds = [dict(zip(("img", "label"), synthetic_mnist(rng, MLP_BATCH)))
             for _ in range(steps)]
    runs = {arm: (pt.Executor(pt.CUDAPlace(0), capture=arm == "captured"),
                  copy_scope(start), []) for arm in ("captured", "eager")}
    for f in feeds:
        for arm, (exe, scope, out) in runs.items():
            out.append([a.tobytes() for a in exe.run(
                main, feed=f, fetch_list=[loss, acc], scope=scope)])
    same_bits = runs["captured"][2] == runs["eager"][2]
    diff = state_rel_l2(runs["captured"][1], runs["eager"][1])

    # the compute rung: one batch staged on the card, replays
    exe, scope, _ = runs["captured"]
    staged = {k: torch.from_numpy(v).cuda() for k, v in feeds[0].items()}

    def window(n):
        # the fetches of the steps above: the same entry, its one graph
        for _ in range(n):
            last = exe.run(main, feed=staged, fetch_list=[loss, acc],
                           scope=scope, return_numpy=False)
        float(last[0][0])

    window(3)
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        window(window_steps)
        times.append(time.perf_counter() - t0)
    prof = device_window(lambda: window(window_steps))
    graphs = sum(st.graph is not None for st in exe._steps.values())

    # the user path: rows of (784 pixels, [label]), batched by the reader
    x, y = synthetic_mnist(np.random.RandomState(7),
                           MLP_BATCH * trainer_batches)
    rows = [(x[i], [int(y[i, 0])]) for i in range(len(x))]

    def reader():
        return iter(rows)

    losses, accs, epoch_s = [], [], []

    def handler(e):
        name = type(e).__name__
        if name == "BeginEpochEvent":
            epoch_s.append(time.perf_counter())
        elif name == "EndEpochEvent":
            epoch_s[-1] = time.perf_counter() - epoch_s[-1]
        elif name == "EndStepEvent":
            losses.append(float(e.metrics[0][0]))
            accs.append(float(e.metrics[1][0]))

    trainer = Trainer(mlp_train_func, lambda: pt.optimizer.Adam(1e-3),
                      place=pt.CUDAPlace(0))
    trainer.train(trainer_epochs, handler,
                  reader=pt.batch(reader, MLP_BATCH),
                  feed_order=["img", "label"])
    falls = bool(losses[-1] < 0.8 * losses[0]
                 and np.mean(accs[-10:]) >= np.mean(accs[:10]))
    summary = {
        "batch": MLP_BATCH, "same_bits_captured_eager": same_bits,
        "state_not_bit_equal": diff, "steps_compared": steps,
        "staged": {"window_steps": window_steps,
                   "window_s": times,
                   "images_per_s_best": MLP_BATCH * window_steps
                   / min(times),
                   "images_per_s_median": MLP_BATCH * window_steps
                   / statistics.median(times),
                   "step_ms": statistics.median(times) / window_steps * 1e3,
                   "profiled_window": {k: prof[k] for k in (
                       "wall_ms", "busy_ms", "idle_share",
                       "device_events")},
                   "graphs": graphs},
        "trainer": {"epochs": trainer_epochs, "steps": len(losses),
                    "epoch_s": epoch_s,
                    "images_per_s_median": MLP_BATCH * trainer_batches
                    / statistics.median(epoch_s[1:]),
                    "images_per_s_range": [
                        MLP_BATCH * trainer_batches / max(epoch_s[1:]),
                        MLP_BATCH * trainer_batches / min(epoch_s[1:])],
                    "first_loss": losses[0], "last_loss": losses[-1],
                    "first_acc10": float(np.mean(accs[:10])),
                    "last_acc10": float(np.mean(accs[-10:])),
                    "loss_falls": falls}}
    log("mlp_trainer", summary)
    if not (same_bits and not diff and falls and graphs == 1):
        raise SystemExit("mlp_trainer: captured differs from eager, the "
                         "loss did not fall, or the graphs are not 1: %s"
                         % {k: summary[k] for k in (
                             "same_bits_captured_eager",
                             "state_not_bit_equal")})
    return summary


def realdist_pools(amp=True):
    """bench.py's ``transformer_realdist`` (``bench.py:1932-2079``): the
    Transformer-base program (dropout 0.1, under ``decorate`` with
    ``amp``), its ``DataFeeder``, and the two feed pools drawn from one
    wmt16-like stream (``RandomState(0)``, lengths clip(lognormal(3.2,
    0.55), 4, 64), ids in [2, 32000)): 8 pad-to-max feeds of 128 rows,
    and 3 feeds of each bucket of ``bucket_by_length`` (bounds 16, 32,
    48, 64; sizes 512, 256, 170, 128; ``drop_last``) padded to its bound
    by ``DataFeeder.feed(samples, pad_to=bound)``, shuffled.  Each feed
    comes with its real tokens (the ``src_word@LEN`` sum)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.reader import decorator as dec

    main, startup, cost = build_train(0.1, amp)
    block = main.global_block()
    feeder = pt.DataFeeder(feed_list=[block.var(n) for n in (
        "src_word", "tgt_word", "lbl_word")], program=main)
    rng = np.random.RandomState(0)

    def sample_stream():
        while True:
            n = int(np.clip(rng.lognormal(3.2, 0.55), 4, TRAIN_SEQ))
            yield (rng.randint(2, TRAIN_VOCAB, (n, 1)).astype("int64"),)

    def make_feed(samples, pad_to):
        feed = feeder.feed([(s, s, s) for (s,) in samples], pad_to=pad_to)
        return feed, int(feed["src_word@LEN"].sum())

    stream = sample_stream()
    fixed = [make_feed([next(stream) for _ in range(128)], TRAIN_SEQ)
             for _ in range(8)]
    per_bound = {}
    for bound, samples in dec.bucket_by_length(
            lambda: sample_stream(), lambda s: len(s[0]),
            list(REALDIST_BOUNDS), list(REALDIST_SIZES), drop_last=True)():
        if len(per_bound.setdefault(bound, [])) < 3:
            per_bound[bound].append(make_feed(samples, bound))
        if len(per_bound) == len(REALDIST_BOUNDS) \
                and all(len(v) >= 3 for v in per_bound.values()):
            break
    bucketed = [f for b in REALDIST_BOUNDS for f in per_bound[b]]
    rng.shuffle(bucketed)
    return main, startup, cost, fixed, bucketed, per_bound


def realdist_phase(windows=3, window_steps=12):
    """bench.py's ``transformer_realdist`` rung on ``CUDAPlace(0)`` under
    AMP (``realdist_pools``): both pools' feeds staged on the card, one
    captured executor, each pool in a scope of its own from one startup
    state; every feed run once to warm (each signature: eager, then
    captured), then ``windows`` timed windows of ``window_steps`` steps,
    one loss read a window.  Real tokens/s (``src_word@LEN`` over wall)
    of the best and the median window for ``fixed_pad_max`` and
    ``bucketed``, and their ratio.  Gates:

    * the executor holds 5 captured graphs (1 pad-to-max + 4 buckets);
    * captured equals eager bit for bit: from one startup state, a
      captured and an eager executor run the four buckets three times
      over (each bucket eager, captured, replayed), the same loss bits at
      every step and every scope tensor after;
    * one replayed step of each bucket launches exactly what the program
      implies (#1 36, #2 18, #3 60, #4 30, #5 2, #6 1), from its device
      trace, and its wrappers none;
    * one float32 step of a whole batch of the smallest and the largest
      bucket (dropout 0) on the card against the CPU at ``train_check``'s
      bands, and the same check failing on each planted fault
      (``realdist_checks``).

    Returns (summary, {path: launch record})."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda

    main, startup, cost, fixed, bucketed, per_bound = realdist_pools()
    start = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=start)

    def staged(pool):
        return [({k: torch.from_numpy(v).cuda() for k, v in f.items()}, t)
                for f, t in pool]

    exe = pt.Executor(pt.CUDAPlace(0))
    arms = {}
    cuda.reset_launch_counts()
    for name, pool in (("fixed_pad_max", fixed), ("bucketed", bucketed)):
        scope, pool = copy_scope(start), staged(pool)
        t0 = time.perf_counter()
        for f, _ in pool:
            last = exe.run(main, feed=f, fetch_list=[cost], scope=scope,
                           return_numpy=False)
        float(last[0][0])
        warm_s = time.perf_counter() - t0
        cuda.reset_launch_counts()
        times, toks, losses = [], [], []
        for _ in range(windows):
            t0, tk = time.perf_counter(), 0
            for i in range(window_steps):
                f, t = pool[i % len(pool)]
                last = exe.run(main, feed=f, fetch_list=[cost], scope=scope,
                               return_numpy=False)
                losses.append(last[0])
                tk += t
            float(last[0][0])
            times.append(time.perf_counter() - t0)
            toks.append(tk)
        timed_launches = cuda.launch_counts()
        rates = [t / w for t, w in zip(toks, times)]
        arms[name] = {"scope": scope, "pool": pool, "summary": {
            "feeds": len(pool), "warm_s": warm_s,
            "real_tokens_per_s_best": max(rates),
            "real_tokens_per_s_median": statistics.median(rates),
            "window_s": times, "window_real_tokens": toks,
            "step_ms_median": statistics.median(times) / window_steps * 1e3,
            "slots_filled": sum(t for _, t in pool) / sum(
                f["src_word"].shape[0] * f["src_word"].shape[1]
                for f, _ in pool),
            "losses_finite": bool(torch.isfinite(
                torch.cat(losses)).all()),
            "timed_wrapper_launches": timed_launches}}
    graphs = sum(st.graph is not None for st in exe._steps.values())

    # one replayed step of each bucket under the profiler
    per_step = kernel_launches_per_step(main)
    records = {}
    bucket_pool = arms["bucketed"]["pool"]
    for bound in REALDIST_BOUNDS:
        f = next(f for f, _ in bucket_pool if f["src_word"].shape[1] == bound)
        win = device_window(lambda f=f: float(exe.run(
            main, feed=f, fetch_list=[cost], scope=arms["bucketed"]["scope"],
            return_numpy=False)[0][0]))
        records["realdist:b%d" % bound] = launch_record(
            True, arms["bucketed"]["summary"]["timed_wrapper_launches"], {},
            win, per_step)
    del exe, arms["fixed_pad_max"]["scope"], arms["bucketed"]["scope"]
    release_memory()

    # captured against eager over every bucket
    order = [f for _ in range(3) for b in REALDIST_BOUNDS
             for f in [next(f for f, _ in bucket_pool
                            if f["src_word"].shape[1] == b)]]
    pair = {arm: (pt.Executor(pt.CUDAPlace(0), capture=arm == "captured"),
                  copy_scope(start), []) for arm in ("captured", "eager")}
    for f in order:
        for arm, (e, scope, out) in pair.items():
            out.append(e.run(main, feed=f, fetch_list=[cost],
                             scope=scope)[0].tobytes())
    same_bits = pair["captured"][2] == pair["eager"][2]
    diff = state_rel_l2(pair["captured"][1], pair["eager"][1])
    del pair, start
    release_memory()

    summary = {"amp": True, "bounds": list(REALDIST_BOUNDS),
               "sizes": list(REALDIST_SIZES), "graphs": graphs,
               "same_bits_captured_eager": same_bits,
               "state_not_bit_equal": diff,
               "launches_per_step": per_step,
               "fixed_pad_max": arms["fixed_pad_max"]["summary"],
               "bucketed": arms["bucketed"]["summary"],
               "profiled_steps": {p: {k: r["window"][k] for k in (
                   "wall_ms", "busy_ms", "idle_share", "trace_launches",
                   "wrapper_launches")} for p, r in records.items()}}
    summary["bucketed_vs_fixed"] = (
        summary["bucketed"]["real_tokens_per_s_best"]
        / summary["fixed_pad_max"]["real_tokens_per_s_best"])
    log("realdist", summary)
    if graphs != 5 or not same_bits or diff or not all(
            summary[a]["losses_finite"] for a in ("fixed_pad_max",
                                                  "bucketed")):
        raise SystemExit("realdist: graphs %d (5 expected), captured equal "
                         "to eager %s, state differing %s"
                         % (graphs, same_bits, sorted(diff)[:5]))
    realdist_checks(per_bound)
    return summary, records


def realdist_checks(per_bound):
    """The float32 card-vs-CPU step (``train_check_phase``, the CPU taking
    the card's ReLU decisions, at ``train_check``'s fixed band) on a whole
    batch of the smallest and the largest bucket (512 x 16, 128 x 64),
    then each planted fault of ``TRAIN_CHECK_FAULTS`` on the card, which
    the same check must fail: TF32 products on the 64 bucket, key lengths
    one short on the 16 bucket."""
    first, last = REALDIST_BOUNDS[0], REALDIST_BOUNDS[-1]
    for bound in (first, last):
        train_check_phase(feed=per_bound[bound][0][0],
                          name="realdist_check_b%d" % bound)
        release_memory()
    passed = []
    for fault, bound in (("tf32", last), ("klen", first)):
        s = train_check_phase(feed=per_bound[bound][0][0], fault=fault,
                              name="realdist_fault_%s_b%d" % (fault, bound))
        if s["within"]:
            passed.append(fault)
        release_memory()
    if passed:
        raise SystemExit("realdist: the card-vs-CPU check passed a planted "
                         "fault: %s" % passed)


RESNET_FEED_POOL = 8


def resnet_feed_phase(windows=3, window_steps=7, batch=RESNET_BATCH):
    """ResNet-50 plain under AMP at batch 128 (the fastest of the three
    AMP programs at that batch), fed three ways from one pool of
    ``RESNET_FEED_POOL`` host batches built before timing (so the arms
    time feeding, not image synthesis),
    each arm a captured executor and a scope from one startup state,
    under cuDNN's deterministic algorithms:

    * ``staged``: the pool copied to the card once, CUDA tensors fed;
    * ``sync``: a host (numpy) batch every step, ``Executor.run`` with
      the loss fetched every step;
    * ``prefetch``: the same host batches through
      ``PyReader(capacity=2)`` (``DevicePrefetcher``: pinned copies on its
      side stream under the previous step), ``return_numpy=False`` and
      one loss read a window, as bench.py's ``with_reader`` path.

    Each with the float32 image feed and with bench.py's reader-included
    uint8 feed (cast and scale on the card).  Two untimed steps each
    (the second captures), then ``windows`` windows of ``window_steps``
    steps (wall a step: the median window's, and each window's), then
    one profiled window of as many steps (device busy a step, and wall
    minus busy within that window, where the profiler slows both alike).
    Gate: the prefetched arm's losses are the synchronous arm's bits,
    step for step."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.reader import PyReader

    steps = 2 + windows * window_steps + window_steps
    out, bad = {}, []
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for uint8 in (False, True):
            feed_name = "uint8" if uint8 else "float32"
            main, startup, loss = build_resnet("plain", amp=True,
                                               uint8=uint8)
            start = pt.Scope()
            pt.Executor(pt.CUDAPlace(0)).run(startup, scope=start)
            rng = np.random.RandomState(0)
            pool = []
            for _ in range(RESNET_FEED_POOL):
                img = rng.randint(0, 256, (batch, 3, 224, 224)).astype(
                    "uint8") if uint8 else rng.rand(
                        batch, 3, 224, 224).astype("float32")
                pool.append({"img": img, "label": rng.randint(
                    0, 1000, (batch, 1)).astype("int64")})
            batches = [pool[i % len(pool)] for i in range(steps)]
            arms = {}
            for arm in ("staged", "sync", "prefetch"):
                exe, scope = pt.Executor(pt.CUDAPlace(0)), copy_scope(start)
                if arm == "staged":
                    on_card = [{k: torch.from_numpy(v).cuda()
                                for k, v in f.items()} for f in pool]
                    it = iter([on_card[i % len(pool)] for i in range(steps)])
                elif arm == "sync":
                    it = iter(batches)
                else:
                    it = iter(PyReader(capacity=2).decorate_batch_reader(
                        lambda: iter(batches), None, pt.CUDAPlace(0)))
                sync = arm == "sync"
                losses = []

                def run(n):
                    for _ in range(n):
                        last = exe.run(main, feed=next(it),
                                       fetch_list=[loss], scope=scope,
                                       return_numpy=sync)
                        losses.append(last[0])
                    if not sync:
                        float(last[0][0])

                run(2)
                times = []
                for _ in range(windows):
                    t0 = time.perf_counter()
                    run(window_steps)
                    times.append(time.perf_counter() - t0)
                prof = device_window(lambda: run(window_steps))
                wall = statistics.median(times) / window_steps * 1e3
                busy = prof["busy_ms"] / window_steps
                profiled = prof["wall_ms"] / window_steps
                arms[arm] = {
                    "step_ms": wall, "busy_ms": busy,
                    "wall_minus_busy_ms": profiled - busy,
                    "images_per_s": batch / wall * 1e3,
                    "window_step_ms": [t / window_steps * 1e3
                                       for t in times],
                    "profiled_idle_share": prof["idle_share"],
                    "profiled_wall_ms": profiled,
                    "losses": [np.asarray(l.cpu() if isinstance(
                        l, torch.Tensor) else l, np.float32).tobytes()
                        for l in losses]}
                del exe, scope, it
                release_memory()
            same = arms["prefetch"]["losses"] == arms["sync"]["losses"]
            for a in arms.values():
                a["losses"] = [float(np.frombuffer(b, np.float32)[0])
                               for b in a.pop("losses")]
            out[feed_name] = dict(arms, prefetch_same_bits_as_sync=same,
                                  sync_minus_prefetch_ms=arms["sync"][
                                      "step_ms"] - arms["prefetch"][
                                      "step_ms"],
                                  feed_mb=sum(v.nbytes for v in pool[0]
                                              .values()) / 1e6)
            if not same or not all(np.isfinite(a["losses"]).all()
                                   for a in arms.values()):
                bad.append(feed_name)
            del start
            release_memory()
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    summary = {"batch": batch, "amp": True, "program": "plain",
               "pool": RESNET_FEED_POOL, "steps_per_arm": steps, **out}
    log("resnet_feed", summary)
    if bad:
        raise SystemExit("resnet_feed: the prefetched losses are not the "
                         "synchronous ones' bits: %s" % bad)
    return summary


# ---------------------------------------------------------------------------
# phases 14 and 15: sparse embeddings (bench.py's rec_sparse A/B, CTR DNN)
# ---------------------------------------------------------------------------

# bench.py's rec_sparse rung (bench.py:583-639): the model at :588-602, the
# batches at :604-607
REC_VOCABS = (10_000, 100_000, 1_000_000)
REC_B, REC_S, REC_D = 64, 16, 16
REC_STEPS, REC_WARM = 6, 2


def build_rec_sparse(vocab, is_sparse):
    """bench.py's rec_sparse model: ids [B, 16] -> embedding (D 16,
    ``is_sparse`` or not) -> reduce_sum -> fc 32 relu -> fc 1 -> square
    loss, Adam(1e-3), seed 11; (main, startup, loss)."""
    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 11
    with pt.program_guard(main, startup), pt.unique_name.guard():
        ids = pt.layers.data("ids", shape=[REC_S, 1], dtype="int64")
        y = pt.layers.data("y", shape=[1], dtype="float32")
        emb = pt.layers.embedding(ids, size=[vocab, REC_D],
                                  is_sparse=is_sparse,
                                  param_attr=pt.ParamAttr(name="table"))
        x = pt.layers.fc(pt.layers.reduce_sum(emb, dim=1), size=32,
                         act="relu")
        pred = pt.layers.fc(x, size=1)
        loss = pt.layers.mean(pt.layers.square(
            pt.layers.elementwise_sub(pred, y)))
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def rec_batches(vocab, n):
    """bench.py's batches: the same ids at every variant (RandomState(3))."""
    r = np.random.RandomState(3)
    return [{"ids": r.randint(0, vocab, (REC_B, REC_S, 1)).astype("int64"),
             "y": r.rand(REC_B, 1).astype("float32")} for _ in range(n)]


def _measured_step(exe, program, feed, fetch, scope):
    """One ``Executor.run`` that fetches ``fetch`` to the host: (wall s,
    the fetches, the peak memory during the step above what was allocated
    before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = exe.run(program, feed=feed, fetch_list=fetch, scope=scope)
    dt = time.perf_counter() - t0
    return dt, out, torch.cuda.max_memory_allocated() - base


def _untouched_faults(before, scope, ids, table):
    """Of ``table`` and its row-slot accumulators (``before``: their
    tensors before a step): the names whose rows outside ``ids`` changed
    bits, and whether the table's touched rows moved."""
    dev = before[table].device
    rows = torch.from_numpy(np.unique(ids)).to(dev)
    keep = torch.ones(before[table].shape[0], dtype=torch.bool, device=dev)
    keep[rows] = False
    faults = [n for n, t in before.items()
              if not torch.equal(t[keep], scope.find_var(n)[keep])]
    moved = not torch.equal(before[table][rows],
                            scope.find_var(table)[rows])
    return faults, moved


def rec_sparse_phase(profile_steps=4):
    """bench.py's rec_sparse A/B on ``CUDAPlace(0)``: at vocab 1e4, 1e5
    and 1e6, the model with ``is_sparse`` True (a SelectedRows gradient,
    lazy Adam over the 1,024 looked-up rows) and False (a dense [vocab,
    16] gradient, Adam over the whole table), on the same 6 id batches (2
    warm-up).  Each variant runs captured (its second step captures) and
    eager from one startup state, the same steps in each: the 6 steps
    (wall a step of the 4 warm ones, the loss fetched every step; the peak
    memory above what was allocated before each step), a profiled window
    of ``profile_steps`` steps (device busy a step, idle share, the kernels
    in the trace), then one more step (sparse: the rows it does not touch
    and their Adam moments keep their bits; the touched rows move).

    Gates: the captured arm's losses and every scope tensor are the eager
    arm's bits; a warm sparse step at 1e6 (eager or replayed) allocates
    less than a quarter of the table (no table-sized temporary: the dense
    gradient alone is the table's size); the lazy invariant; no hand
    kernel launches.  The dense / sparse ratio and the sparse step's
    spread across vocab are reported, not gated (bench.py's >= 5x is the
    JAX package's TPU acceptance).  Returns {path: launch record}, one
    for each variant and arm, each from that run's own warm steps and
    window: ``rec_sparse`` is the sparse step at 1e6 captured,
    ``rec_sparse:dense_10000:eager`` the dense step at 1e4 eager."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda
    from paddle_tpu_torch.ops.selected_rows import is_row_slot_of

    out, faults, records = {}, [], {}
    for vocab in REC_VOCABS:
        feeds = rec_batches(vocab, REC_STEPS)
        for sparse in (True, False):
            main, startup, loss = build_rec_sparse(vocab, sparse)
            start = pt.Scope()
            pt.Executor(pt.CUDAPlace(0)).run(startup, scope=start)
            slots = [n for n in start.local_var_names()
                     if is_row_slot_of(n, "table")]
            arms = {}
            for arm in ("captured", "eager"):
                exe = pt.Executor(pt.CUDAPlace(0),
                                  capture=arm == "captured")
                scope = copy_scope(start)
                r = {"walls": [], "peaks": [], "losses": []}
                for i, f in enumerate(feeds):
                    if i == REC_WARM:
                        cuda.reset_launch_counts()
                    dt, (lv,), peak = _measured_step(exe, main, f, [loss],
                                                     scope)
                    r["losses"].append(lv.tobytes())
                    r["walls"].append(dt)
                    r["peaks"].append(peak)
                # this variant's warm steps alone: zeroed before the
                # first, read after the last
                timed = cuda.launch_counts()

                def window(exe=exe, scope=scope, r=r):
                    for f in feeds[REC_WARM:REC_WARM + profile_steps]:
                        (lv,) = exe.run(main, feed=f, fetch_list=[loss],
                                        scope=scope)
                        r["losses"].append(lv.tobytes())

                prof = device_window(window)
                before = {n: scope.find_var(n).clone()
                          for n in ["table"] + slots}
                _, (lv,), _ = _measured_step(exe, main, feeds[0], [loss],
                                             scope)
                r["losses"].append(lv.tobytes())
                lazy = _untouched_faults(before, scope, feeds[0]["ids"],
                                         "table") if sparse else None
                del before
                warm = r["walls"][REC_WARM:]
                arms[arm] = {
                    "step_ms_median": statistics.median(warm) * 1e3,
                    "step_ms_min": min(warm) * 1e3,
                    "first_steps_ms": [t * 1e3 for t in
                                       r["walls"][:REC_WARM]],
                    "busy_ms_per_step": prof["busy_ms"] / profile_steps,
                    "profiled_idle_share": prof["idle_share"],
                    "peak_above_resident_mb": [p / 1e6 for p in r["peaks"]],
                    "warm_peak_above_resident_mb": max(
                        r["peaks"][REC_WARM:]) / 1e6,
                    "untouched_changed": lazy[0] if lazy else None,
                    "touched_moved": lazy[1] if lazy else None,
                    "top_device_us": prof["top_device_us"],
                    "exe": exe, "scope": scope, "losses": r["losses"],
                    "window": prof}
                path = "rec_sparse" if (sparse and vocab == REC_VOCABS[-1]) \
                    else "rec_sparse:%s_%d" % ("sparse" if sparse else "dense",
                                               vocab)
                records[path if arm == "captured" else path + ":eager"] = \
                    launch_record(arm == "captured", timed, {}, prof, {})
            same = arms["captured"]["losses"] == arms["eager"]["losses"]
            diff = state_rel_l2(arms["captured"]["scope"],
                                arms["eager"]["scope"])
            table_mb = vocab * REC_D * 4 / 1e6
            entry = {"table_mb": table_mb, "same_bits_captured_eager": same,
                     "state_not_bit_equal": diff,
                     "graphs": sum(s.graph is not None for s in
                                   arms["captured"]["exe"]._steps.values())}
            for arm, a in arms.items():
                entry[arm] = {k: v for k, v in a.items()
                              if k not in ("exe", "scope", "losses",
                                           "window")}
            key = "%s_%d" % ("sparse" if sparse else "dense", vocab)
            out[key] = entry
            if not same or diff:
                faults.append("%s: captured != eager" % key)
            if sparse:
                for arm, a in arms.items():
                    if a["untouched_changed"] or not a["touched_moved"]:
                        faults.append("%s %s: untouched rows changed %s or "
                                      "touched rows did not move"
                                      % (key, arm, a["untouched_changed"]))
                if vocab == REC_VOCABS[-1]:
                    worst = max(a["warm_peak_above_resident_mb"]
                                for a in entry.values()
                                if isinstance(a, dict) and "busy_ms_per_step"
                                in a)
                    entry["warm_peak_under_quarter_table"] = \
                        worst < table_mb / 4
                    if worst >= table_mb / 4:
                        faults.append("%s: a warm step allocated %.1f MB "
                                      "above resident, table %.1f MB"
                                      % (key, worst, table_mb))
            del arms, start
            release_memory()
    ratio = {str(v): {
        "wall": out["dense_%d" % v]["captured"]["step_ms_median"]
        / out["sparse_%d" % v]["captured"]["step_ms_median"],
        "busy": out["dense_%d" % v]["captured"]["busy_ms_per_step"]
        / out["sparse_%d" % v]["captured"]["busy_ms_per_step"]}
        for v in REC_VOCABS}

    def spread(arm, key):
        vals = [out["sparse_%d" % v][arm][key] for v in REC_VOCABS]
        return max(vals) / min(vals)

    summary = {"batch": REC_B, "seq": REC_S, "dim": REC_D,
               "steps": REC_STEPS, "warm": REC_WARM,
               "dense_over_sparse": ratio,
               "sparse_spread": {arm: {"wall": spread(arm, "step_ms_median"),
                                       "busy": spread(arm,
                                                      "busy_ms_per_step")}
                                 for arm in ("captured", "eager")},
               **out}
    log("rec_sparse", summary)
    if faults:
        raise SystemExit("rec_sparse: %s" % faults)
    return records


CTR_VOCAB, CTR_T, CTR_BATCH, CTR_STEPS = 1_000_000, 16, 512, 200
CTR_CHECK_BATCH, CTR_CHECK_STEPS = 64, 3


def build_ctr(opt="adam", sparse=True):
    """``models/ctr_dnn.py`` at its full width (embedding 16, tower 128 /
    128 / 128, a 2-way softmax) over two 1e6-row tables, seed 7, with
    Adam(1e-3) (bench.py's ``rec_sparse`` rate) or Adagrad(1e-2); with
    ``sparse`` False the lookups are made dense before ``minimize`` (the
    comparison program); (main, startup, cost, auc).
    ``tests/test_ctr_dnn.py``'s Adam(1e-2) drives this run's loss to 0
    by step 20 and to inf at step 177: confident on every row, it meets
    a cold row whose ids it saw in hot rows before and gives its label
    probability 0 (the same -log(p) as the JAX package's
    ``cross_entropy``)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.ctr_dnn import ctr_dnn

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 7
    with pt.program_guard(main, startup), pt.unique_name.guard():
        dnn = pt.layers.data("dnn_ids", shape=[1], dtype="int64",
                             lod_level=1)
        lr_ids = pt.layers.data("lr_ids", shape=[1], dtype="int64",
                                lod_level=1)
        click = pt.layers.data("click", shape=[1], dtype="int64")
        cost, _, auc = ctr_dnn(dnn, lr_ids, click, CTR_VOCAB, CTR_VOCAB)
        for op in main.global_block().ops:
            if op.type == "lookup_table":
                op.attrs["is_sparse"] = sparse
        (pt.optimizer.Adam(learning_rate=1e-3) if opt == "adam"
         else pt.optimizer.Adagrad(learning_rate=1e-2)).minimize(cost)
    return main, startup, cost, auc


def ctr_feeds(n, batch, seed=0):
    """``tests/test_ctr_dnn.py``'s rule at 1e6 ids: a click when the first
    dnn id is in the hot range [0, 50) (half the rows); 1..16 dnn ids a
    row (uniform), the rest of the 16 slots id 0, and 2 lr ids."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = rng.randint(1, CTR_T + 1, batch).astype("int64")
        ids = rng.randint(50, CTR_VOCAB, (batch, CTR_T, 1)).astype("int64")
        hot = rng.rand(batch) < 0.5
        ids[hot, 0, 0] = rng.randint(0, 50, hot.sum())
        ids[np.arange(CTR_T)[None, :] >= lens[:, None]] = 0
        out.append({"dnn_ids": ids, "dnn_ids@LEN": lens,
                    "lr_ids": rng.randint(0, CTR_VOCAB, (batch, 2, 1))
                    .astype("int64"),
                    "lr_ids@LEN": np.full(batch, 2, "int64"),
                    "click": hot.astype("int64").reshape(-1, 1)})
    return out


def ctr_check():
    """The card against the CPU port over the first 3 Adam steps at batch
    64 from one startup state, the CPU taking the card's ReLU decisions
    (``relu_decisions``): each loss within rtol 1e-4; the touched rows of
    both tables and every dense parameter within relative L2 1e-4 at the
    median (1e-2 each, as ``train_check``)."""
    import paddle_tpu_torch as pt

    main, startup, cost, _ = build_ctr()
    card_scope, cpu_scope = pt.Scope(), pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=card_scope)
    for n in card_scope.local_var_names():
        cpu_scope.set_var(n, card_scope.var(n).cpu().clone())
    card = pt.Executor(pt.CUDAPlace(0), capture=False)
    cpu = pt.Executor(pt.CPUPlace())
    fetch = [cost.name] + relu_inputs(main)
    feeds = ctr_feeds(CTR_CHECK_STEPS, CTR_CHECK_BATCH, seed=1)
    losses, flips = [], 0
    for f in feeds:
        got = card.run(main, feed=f, fetch_list=fetch, scope=card_scope)
        with relu_decisions(main, got[1:]):
            want = cpu.run(main, feed=f, fetch_list=fetch, scope=cpu_scope)
        flips += sum(int((np.sign(a) != np.sign(b)).sum())
                     for a, b in zip(got[1:], want[1:]))
        losses.append((float(got[0][0]), float(want[0][0])))
    touched = {"deep_embedding": np.unique(np.concatenate(
        [f["dnn_ids"].ravel() for f in feeds]))}
    lr_table = [p.name for p in main.all_parameters()
                if p.name != "deep_embedding" and p.shape[0] == CTR_VOCAB][0]
    touched[lr_table] = np.unique(np.concatenate(
        [f["lr_ids"].ravel() for f in feeds]))
    rel = {}
    for p in main.all_parameters():
        a, b = card_scope.var(p.name).cpu().double(), \
            cpu_scope.var(p.name).double()
        if p.name in touched:
            a, b = a[touched[p.name]], b[touched[p.name]]
        rel[p.name] = float((a - b).norm() / b.norm().clamp_min(1e-30))
    med = statistics.median(rel.values())
    loss_ok = all(abs(g - w) <= 1e-4 * abs(w) for g, w in losses)
    summary = {"batch": CTR_CHECK_BATCH, "steps": CTR_CHECK_STEPS,
               "losses_card_cpu": losses, "rel_l2": rel,
               "rel_l2_median": med, "rel_l2_max": max(rel.values()),
               "touched_rows": {k: len(v) for k, v in touched.items()},
               "relu_sign_flips": flips, "cpu_takes_card_relu": True,
               "within": bool(loss_ok and med <= 1e-4
                              and max(rel.values()) <= 1e-2)}
    log("ctr_check", summary)
    if not summary["within"]:
        raise SystemExit("ctr_check: card and CPU disagree: %s" % summary)
    return summary


def ctr_sparse_equals_dense():
    """One Adagrad step of CTR at batch 512 on the card, with the sparse
    gradients and with the lookups made dense, from one startup state:
    every tensor of the two scopes (both tables, their moments, the
    dense parameters) is the same bits."""
    import paddle_tpu_torch as pt

    scopes = {}
    feed = ctr_feeds(1, CTR_BATCH, seed=2)[0]
    start = None
    for sparse in (True, False):
        main, startup, cost, _ = build_ctr("adagrad", sparse)
        if start is None:
            start = pt.Scope()
            pt.Executor(pt.CUDAPlace(0)).run(startup, scope=start)
        scope = copy_scope(start)
        pt.Executor(pt.CUDAPlace(0)).run(main, feed=feed, fetch_list=[cost],
                                         scope=scope)
        scopes[sparse] = scope
    diff = state_rel_l2(scopes[True], scopes[False])
    summary = {"batch": CTR_BATCH, "optimizer": "adagrad",
               "tensors": len(scopes[True].local_var_names()),
               "not_bit_equal": diff}
    log("ctr_sparse_vs_dense", summary)
    if diff:
        raise SystemExit("ctr: the first sparse Adagrad step is not the "
                         "dense one's bits: %s" % diff)
    del scopes, start
    release_memory()
    return summary


def ctr_phase(compare_steps=20, profile_steps=10):
    """CTR DNN training on ``CUDAPlace(0)`` (``build_ctr``, Adam, batch
    512, ``ctr_feeds``), after ``ctr_check`` and
    ``ctr_sparse_equals_dense``.  Captured and eager from one startup
    state over the first ``compare_steps`` steps in turns, the loss and
    the streaming AUC fetched every step: the same bits, and every scope
    tensor after them.  The eager arm's wall a step (from step 3) and a
    profiled window of ``profile_steps`` steps; the captured arm then
    trains on to ``CTR_STEPS`` steps (wall a step from step 3,
    examples/s, the streaming AUC after the last step, which must exceed
    0.85) and runs a profiled window.  Memory: the peak above resident of
    the warm steps of each arm, and the phase's peak.  Returns {path:
    launch record}: no hand kernel may launch on either path."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda

    ctr_check()
    release_memory()
    ctr_sparse_equals_dense()
    torch.cuda.reset_peak_memory_stats()
    main, startup, cost, auc = build_ctr()
    start = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=start)
    resident = torch.cuda.memory_allocated()
    feeds = ctr_feeds(CTR_STEPS, CTR_BATCH)
    arms = {arm: {"exe": pt.Executor(pt.CUDAPlace(0),
                                     capture=arm == "captured"),
                  "scope": copy_scope(start), "out": [], "walls": [],
                  "peaks": [], "launches": {}}
            for arm in ("captured", "eager")}
    del start

    def step(r, f):
        cuda.reset_launch_counts()
        dt, out, peak = _measured_step(r["exe"], main, f, [cost, auc],
                                       r["scope"])
        if len(r["walls"]) >= 2:   # the warm steps' launches
            for k, n in cuda.launch_counts().items():
                r["launches"][k] = r["launches"].get(k, 0) + n
        r["out"].append([a.tobytes() for a in out])
        r["walls"].append(dt)
        r["peaks"].append(peak)
        return out

    def window(r):
        return device_window(lambda: [r["exe"].run(
            main, feed=f, fetch_list=[cost, auc], scope=r["scope"])
            for f in feeds[:profile_steps]])

    def timing(r, win):
        wall = statistics.median(r["walls"][2:])
        return {"step_ms_median": wall * 1e3,
                "step_ms_range": [min(r["walls"][2:]) * 1e3,
                                  max(r["walls"][2:]) * 1e3],
                "examples_per_s": CTR_BATCH / wall,
                "busy_ms_per_step": win["busy_ms"] / profile_steps,
                "profiled_idle_share": win["idle_share"],
                "warm_peak_above_resident_mb": max(r["peaks"][2:]) / 1e6,
                "top_device_us": win["top_device_us"]}

    for i, f in enumerate(feeds[:compare_steps]):
        for arm in (("eager", "captured") if i % 2 == 0
                    else ("captured", "eager")):
            step(arms[arm], f)
    same = arms["captured"]["out"] == arms["eager"]["out"]
    diff = state_rel_l2(arms["captured"]["scope"], arms["eager"]["scope"])
    windows = {"eager": window(arms["eager"])}
    eager = timing(arms["eager"], windows["eager"])
    eager_launches = arms["eager"]["launches"]
    del arms["eager"]
    release_memory()
    c = arms["captured"]
    for f in feeds[compare_steps:]:
        last = step(c, f)
    auc_last = float(last[1][0])
    losses = [float(np.frombuffer(o[0], np.float32)[0]) for o in c["out"]]
    windows["captured"] = window(c)
    summary = {
        "batch": CTR_BATCH, "vocab": CTR_VOCAB, "pad": CTR_T,
        "embedding": 16, "tower": [128, 128, 128], "steps": CTR_STEPS,
        "same_bits_captured_eager": same, "steps_compared": compare_steps,
        "state_not_bit_equal": diff,
        "graphs": sum(s.graph is not None
                      for s in c["exe"]._steps.values()),
        "resident_mb": resident / 1e6,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "captured": timing(c, windows["captured"]), "eager": eager,
        "first_loss": losses[0], "last_loss": losses[-1],
        "auc_after_%d" % CTR_STEPS: auc_last}
    log("ctr", summary)
    if not (same and not diff and auc_last > 0.85
            and np.isfinite(losses).all()):
        raise SystemExit("ctr: captured differs from eager (%s, %s), or "
                         "the AUC after %d steps is %.4f (needs > 0.85)"
                         % (same, diff, CTR_STEPS, auc_last))
    return {"ctr": launch_record(True, c["launches"], {},
                                 windows["captured"], {}),
            "ctr:eager": launch_record(False, eager_launches, {},
                                       windows["eager"], {})}


# ---------------------------------------------------------------------------
# bench.py's image-model ladder, fused SE-ResNeXt, SE-ResNeXt-152 and the
# rest of the optimizers
# ---------------------------------------------------------------------------

# bench.py's ``_bench_image_model`` rungs (``bench.py:1712-1850``): image
# size, class_dim, training batch, and the reference's published K40m ms a
# training batch at that batch (``benchmark/README.md``), where it has one
ZOO = {"smallnet": (32, 10, 256, 33.1),
       "alexnet": (227, 1000, 128, 334.0),
       "vgg16": (224, 1000, 128, None),
       "googlenet": (224, 1000, 128, 1149.0),
       "se_resnext50": (224, 1000, 128, None),
       "se_resnext152": (224, 1000, 128, None),
       # bench.py's ``--infer`` rung of ResNet-50 (``bench.py:1451-1461``)
       "resnet50": (224, 1000, 16, None)}
# timed steps a training rung takes: 20 where 20 steps take under 4 s,
# 3 for VGG-16 and the SE-ResNeXts (0.2-0.5 s a step, and two arms)
ZOO_STEPS = {"smallnet": 20, "alexnet": 20, "googlenet": 20, "vgg16": 3,
             "se_resnext50": 3, "se_resnext152": 3}
ZOO_INFER_BATCH, ZOO_INFER_STEPS = 16, 5
SE_FUSED = 33     # fused conv+BN layers of SE-ResNeXt-50
SE152_FREE_GB = 8.0   # the least device memory a SE-ResNeXt-152 step leaves


def zoo_model(name):
    """The port's builder of a ladder model: fn(img, class_dim, is_test)."""
    from paddle_tpu_torch.models import (alexnet, googlenet, resnet,
                                         se_resnext, smallnet, vgg)

    return {"resnet50": lambda img, class_dim, is_test=False:
            resnet.resnet_imagenet(img, class_dim=class_dim, depth=50,
                                   is_test=is_test),
            "smallnet": smallnet.smallnet, "alexnet": alexnet.alexnet,
            "vgg16": vgg.vgg16_bn_drop, "googlenet": googlenet.googlenet_v1,
            "se_resnext50": se_resnext.se_resnext_50,
            "se_resnext152": lambda img, class_dim, is_test=False:
            se_resnext.SE_ResNeXt(img, class_dim=class_dim, depth=152,
                                  is_test=is_test)}[name]


def build_zoo(name, amp=False, fuse=False, infer=False, dropout=True,
              nhwc=False):
    """(main, startup, fetches) of bench.py's ``_bench_image_model``
    program for ``name``: training (mean cross-entropy, Momentum(1e-3,
    0.9), under ``decorate`` with ``amp``, ``fuse_conv_bn`` before
    minimize with ``fuse``, after ``convert_to_nhwc`` with ``nhwc`` too;
    fetches [loss]) or inference (``is_test``;
    fetches [softmax, its mean], bench.py fetching the mean).  Fixed
    seeds and fresh names; ``dropout`` False sets every dropout's rate to
    0 (the card-against-CPU checks: the two devices draw other masks)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import mixed_precision

    size, classes, _, _ = ZOO[name]
    main, startup = pt.Program(), pt.Program()
    main.random_seed, startup.random_seed = 2, 1
    with pt.program_guard(main, startup), pt.unique_name.guard():
        img = pt.layers.data("img", shape=[3, size, size])
        pred = zoo_model(name)(img, class_dim=classes, is_test=infer)
        if infer:
            fetches = [pred, pt.layers.mean(pred)]
        else:
            label = pt.layers.data("label", shape=[1], dtype="int64")
            loss = pt.layers.mean(pt.layers.cross_entropy(pred, label))
            if nhwc:
                assert pt.transpiler.convert_to_nhwc(main) == 53
            if fuse:
                assert pt.transpiler.fuse_conv_bn(main) == 53
            opt = pt.optimizer.Momentum(learning_rate=1e-3, momentum=0.9)
            if amp:
                opt = mixed_precision.decorate(opt)
            opt.minimize(loss)
            fetches = [loss]
    if not dropout:
        for op in main.global_block().ops:
            if op.type == "dropout":
                op.attrs["dropout_prob"] = 0.0
    return main, startup, fetches


def zoo_feeds(name, n, batch, infer=False):
    """bench.py's feed: ``RandomState(0)`` images ``rand`` in [0, 1) and
    labels in [0, class_dim)."""
    size, classes, _, _ = ZOO[name]
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        f = {"img": rng.rand(batch, 3, size, size).astype("float32")}
        if not infer:
            f["label"] = rng.randint(0, classes, (batch, 1)).astype("int64")
        out.append(f)
    return out


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's deterministic algorithms and PyTorch's deterministic mode
    (warning where an op has none) while open; yields the list of the
    warnings seen."""
    import warnings

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            yield seen
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)


def started(startup):
    """A scope holding ``startup``'s state, run on ``CUDAPlace(0)``."""
    import paddle_tpu_torch as pt

    scope = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=scope)
    return scope


def two_arm_run(main, start, fetch, feeds, steps, batch, need=None, warm=2,
                sequential=False, deterministic=True):
    """One program from one state (``start``, a scope: each arm takes a
    copy) in two arms, captured and eager (each an executor and a scope of
    its own), on the same feeds: ``warm`` untimed runs each (the captured
    arm's second is its capture), then ``steps`` timed runs in turns, each
    bracketed by zeroing the launch counters and reading them.  With
    ``sequential`` the eager arm takes all its runs and is freed before
    the captured arm starts (a model whose two arms do not fit the card
    together).  Under deterministic algorithms (``deterministic``: the
    training ladder's convolutions; no other path needs them, and they
    fill every new tensor, which slows an eager step) the fetches of every
    run and every scope tensor after them must be the same bits in the two
    arms; then each arm runs once more under the profiler
    (``device_window``; the bits are compared before it).  A window whose
    trace holds no device event is profiled again, up to ``TRACE_TRIES``
    windows, in both arms when they run in turns (so that their states
    stay equal for what the caller runs next), and ``empty_windows``
    counts the windows profiled again.  ``fetch`` is a training program's
    [loss] or an inference program's outputs.  Returns (summary, {arm:
    launch record}, {arm: its run: ``out`` (every run's fetches), and
    ``exe`` and ``scope`` but in a freed arm}) with ``need`` the launches
    a run implies."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda

    need = need or {}
    arms = ("captured", "eager")
    runs = {arm: dict(exe=pt.Executor(pt.CUDAPlace(0),
                                      capture=arm == "captured"),
                      scope=copy_scope(start), times=[], out=[], peak=0,
                      launches={}, first=[])
            for arm in arms}

    def run(r, f):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = r["exe"].run(main, feed=f, fetch_list=fetch, scope=r["scope"])
        dt = time.perf_counter() - t0
        r["peak"] = max(r["peak"], torch.cuda.max_memory_allocated())
        return got, dt

    def warm_runs(r):
        for f in feeds[:warm]:
            got, dt = run(r, f)
            r["out"].append(got)
            r["first"].append(dt)

    def timed(r, f):
        cuda.reset_launch_counts()
        got, dt = run(r, f)
        r["out"].append(got)
        r["times"].append(dt)
        for k, n in cuda.launch_counts().items():
            r["launches"][k] = r["launches"].get(k, 0) + n

    windows = {}
    with (deterministic_algorithms() if deterministic
          else contextlib.nullcontext([])) as seen:
        if sequential:
            keep = {}
            for arm in ("eager", "captured"):
                r = runs[arm]
                warm_runs(r)
                for f in feeds[warm:warm + steps]:
                    timed(r, f)
                keep[arm] = {n: r["scope"].var(n).to("cpu", copy=True)
                             for n in r["scope"].local_var_names()}
                windows[arm] = device_window(lambda: run(r, feeds[-1]),
                                             again=True)
                if arm == "eager":
                    del r["exe"], r["scope"]
                    release_memory()
            diff = {}
            for n, t in keep["eager"].items():
                if not torch.equal(t, keep["captured"][n]):
                    x, y = t.double(), keep["captured"][n].double()
                    diff[n] = float((x - y).norm()
                                    / y.norm().clamp_min(1e-30))
        else:
            for arm in arms:
                warm_runs(runs[arm])
            for i in range(steps):
                for arm in (arms[::-1] if i % 2 == 0 else arms):
                    timed(runs[arm], feeds[warm + i])
            diff = state_rel_l2(runs["captured"]["scope"],
                                runs["eager"]["scope"])
            for empty in range(TRACE_TRIES):
                windows = {arm: device_window(lambda r=r: run(r, feeds[-1]))
                           for arm, r in runs.items()}
                if all(w["device_events"] for w in windows.values()):
                    break
            for w in windows.values():
                w["empty_windows"] = empty
    nondeterministic = sorted({str(w.message)[:200] for w in seen
                               if "deterministic" in str(w.message)})
    c, e = runs["captured"], runs["eager"]
    same = [[a.tobytes() for a in o] for o in c["out"]] \
        == [[a.tobytes() for a in o] for o in e["out"]]
    finite = all(np.isfinite(a).all() for r in (c, e) for o in r["out"]
                 for a in o)
    summary = {"batch": batch, "steps": steps, "sequential": sequential,
               "ops": len(main.global_block().ops),
               "launches_per_run": need, "same_bits": same,
               "finite": finite, "state_not_bit_equal": diff,
               "nondeterministic_ops_warned": nondeterministic}
    records = {}
    for arm in arms:
        r = runs[arm]
        step_s = statistics.median(r["times"])
        summary[arm] = {
            "first_ms": [t * 1e3 for t in r["first"]],
            # a training program's losses
            "values": [float(o[0].ravel()[0]) for o in r["out"]],
            "step_ms": [t * 1e3 for t in r["times"]],
            "median_step_ms": step_s * 1e3,
            "step_ms_range": [min(r["times"]) * 1e3, max(r["times"]) * 1e3],
            "images_per_s": batch / step_s,
            "peak_mem_gb": r["peak"] / 1e9,
            "device_events": windows[arm]["device_events"],
            "empty_windows": windows[arm]["empty_windows"],
            "profiled_step": windows[arm], "launches": r["launches"]}
        records[arm] = launch_record(
            arm == "captured", r["launches"],
            {k: n * steps for k, n in need.items()}, windows[arm], need)
    summary["ok"] = same and finite and not diff
    return summary, records, runs


def zoo_phase(steps=ZOO_STEPS):
    """bench.py's image ladder on ``CUDAPlace(0)`` (``two_arm_run``,
    ``steps[name]`` timed steps):
    SmallNet (batch 256, 32x32, 10 classes), AlexNet (128, 227x227),
    VGG-16, GoogLeNet and SE-ResNeXt-50 (128, 224x224), 1000 classes,
    under AMP (bench.py's scored dtype), then each in float32:
    images/s and ms a step of each arm, busy and idle share of a profiled
    step, peak memory; for AlexNet, GoogLeNet and SmallNet the reference's
    K40m ms a batch beside (not a target).  Captured = eager bit for bit;
    no hand kernel launches (the gate expects 0).  Returns {path: launch
    record}."""
    paths, bad = {}, []
    for amp in (True, False):
        for name in ("smallnet", "alexnet", "vgg16", "googlenet",
                     "se_resnext50"):
            s, records = _zoo_rung(name, amp, steps[name])
            path = "zoo:%s%s" % (name, "" if amp else "_float32")
            paths[path] = records["captured"]
            paths[path + ":eager"] = records["eager"]
            if not s["ok"]:
                bad.append(path)
            release_memory()
    if bad:
        raise SystemExit("zoo: captured steps differ from eager: %s" % bad)
    return paths


def _zoo_rung(name, amp, steps):
    """One ``zoo`` rung: (summary, launch records).  VGG-16 runs its arms
    one after the other (``sequential``): under AMP its captured graph's
    pool held 47.6 GB and an eager step peaks at 34 GB, which with what
    the earlier phases leave does not fit the 80 GB card (NVIDIA H100
    80GB HBM3: out of memory in a whole run)."""
    batch, era = ZOO[name][2], ZOO[name][3]
    main, startup, fetch = build_zoo(name, amp=amp)
    s, records, _ = two_arm_run(main, started(startup), fetch,
                                zoo_feeds(name, steps + 3, batch), steps,
                                batch, sequential=name == "vgg16")
    s.update(model=name, dtype="amp_bf16" if amp else "float32")
    if era:
        s["era_ms_per_batch_k40m"] = era
        s["era_ratio_k40m_over_captured"] = \
            era / s["captured"]["median_step_ms"]
    log("zoo", s)
    return s, records


def zoo_infer_phase(steps=ZOO_INFER_STEPS, batch=ZOO_INFER_BATCH):
    """bench.py's ``--infer`` rungs at batch 16 (``bench.py:1736-1748``,
    ResNet-50's ``bench.py:1451-1461``): each model's ``is_test`` program
    in float32, and in bfloat16 through ``contrib.Bfloat16Transpiler``
    after startup, captured and eager (``two_arm_run``: two untimed runs
    each, ``steps`` timed runs in turns, one profiled run each).  Captured
    = eager bit for bit; the bfloat16 softmax within relative L1
    ``INFER_BF16_BAND`` (0.02) of the float32 one on the same images;
    images/s; no hand kernel.  ResNet-50 runs with its batch norms
    calibrated on the first batch (``calibrate_batch_norms``), and its
    bfloat16 program is held against its own run on the CPU instead of
    the band (``resnet50_host_witness``); it also runs its BN-folded
    program and the predictor (``resnet50_fold_and_predictor``).  Returns
    {path: launch record}."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import Bfloat16Transpiler

    paths, bad = {}, []
    for name in ("smallnet", "alexnet", "vgg16", "googlenet",
                 "se_resnext50", "resnet50"):
        feeds = zoo_feeds(name, steps + 3, batch, infer=True)
        out = {"model": name, "batch": batch}
        preds = {}
        for dtype in ("float32", "bfloat16"):
            main, startup, fetch = build_zoo(name, infer=True)
            start = started(startup)
            if name == "resnet50":
                calibrate_batch_norms(pt.Executor(pt.CUDAPlace(0),
                                                  capture=False),
                                      main, start, feeds[0])
                if dtype == "float32":
                    host = copy_scope(start, "cpu")
            if dtype == "bfloat16":
                Bfloat16Transpiler().transpile(main, pt.CUDAPlace(0),
                                               scope=start,
                                               fetch_targets=fetch)
            s, records, runs = two_arm_run(main, start, fetch, feeds,
                                           steps, batch, deterministic=False)
            preds[dtype] = runs["eager"]["out"][0][0]
            s["out_dtype"] = str(preds[dtype].dtype)
            out[dtype] = s
            for arm, rec in records.items():
                paths["zoo_infer:%s:%s%s" % (
                    name, dtype, "" if arm == "captured" else ":eager")] = rec
            if not s["ok"]:
                bad.append("%s:%s" % (name, dtype))
            del runs, start, main, startup
            release_memory()
        out["bf16_rel_l1"] = rel_l1(preds["float32"], preds["bfloat16"])
        out["band"] = INFER_BF16_BAND
        if name == "resnet50":
            out["host_witness"] = witness = resnet50_host_witness(
                host, feeds[0], preds)
            held = witness["ok"]
            del host
        else:
            held = out["bf16_rel_l1"] <= INFER_BF16_BAND
        log("zoo_infer", out)
        if not held:
            bad.append("%s:bf16_rel_l1" % name)
        if name == "resnet50":
            more, faults = resnet50_fold_and_predictor(feeds, steps, batch)
            paths.update(more)
            bad.extend(faults)
    if bad:
        raise SystemExit("zoo_infer: captured differs from eager, or bf16 "
                         "out of its band: %s" % bad)
    return paths


INFER_FOLD_BAND = 1e-4   # relative L1, BN-folded against unfolded softmax
# relative L1 of ResNet-50's float32 softmax on the card against the CPU
INFER_HOST_BAND = 1e-4
HOST_IMAGES = 4          # the images ResNet-50's host witness runs
# how far the card's bf16 drift from float32 may exceed the CPU's on the
# same images (an H100 reads 0.125 against the CPU's 0.126)
HOST_DRIFT_SCALE = 1.5
RESNET_BNS = 53


def calibrate_batch_norms(exe, main, scope, feed):
    """Set every batch norm's running statistics in ``scope`` to the batch
    statistics of ``feed``: ``exe`` runs once a copy of the inference
    program ``main`` with each batch norm in training mode, momentum 0
    (``tools/resnet50_bf16_drift.py`` passes either package's executor
    and program).  Without it ResNet-50's inference program at its
    initial statistics (mean 0, variance 1) normalizes nothing, its logits
    grow through the 53 blocks and the softmax saturates to exact 0s and
    1s in float32 and bfloat16 alike, so a comparison of two programs'
    softmax reads 0 whatever they compute."""
    calib = main.clone()
    for op in calib.global_block().ops:
        if op.type == "batch_norm":
            op.attrs.update(is_test=False, momentum=0.0)
    exe.run(calib, feed=feed, fetch_list=[], scope=scope)


def resnet50_host_witness(host, feed, card):
    """ResNet-50's calibrated inference program in float32 and after
    ``Bfloat16Transpiler`` on ``CPUPlace()``, from ``host`` (the card's
    calibrated state, copied to the CPU), on the first ``HOST_IMAGES``
    images of ``feed``; ``card`` holds the card's softmaxes of ``feed``
    {dtype: array}.  bfloat16 moves an untrained ResNet-50's calibrated softmax
    far from float32's, on the CPU as on the card and in the reference
    package (``tools/resnet50_bf16_drift.py``), and the net amplifies
    every rounding that the two devices' sums order differently, so the
    card's bfloat16 program is held against the CPU's run of it, not to
    ``INFER_BF16_BAND``: its drift from float32 within
    ``HOST_DRIFT_SCALE`` times the CPU's on the same images, and its
    softmax within half of ``other_image_rel_l1`` (the distance between
    two images' float32 softmaxes on the card, which an answer to another
    image would read) of the CPU's.  The float32 softmax within
    ``INFER_HOST_BAND`` of the CPU's."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import Bfloat16Transpiler

    exe = pt.Executor(pt.CPUPlace())
    sub = {"img": feed["img"][:HOST_IMAGES]}
    main, _, fetch = build_zoo("resnet50", infer=True)
    f32 = exe.run(main, feed=sub, fetch_list=fetch, scope=host)[0]
    main16, _, fetch16 = build_zoo("resnet50", infer=True)
    Bfloat16Transpiler().transpile(main16, pt.CPUPlace(), scope=host,
                                   fetch_targets=fetch16)
    b16 = exe.run(main16, feed=sub, fetch_list=fetch16, scope=host)[0]
    c32 = card["float32"][:HOST_IMAGES]
    c16 = card["bfloat16"][:HOST_IMAGES]
    out = {"images": HOST_IMAGES,
           "float32_softmax_max": float(c32.max()),
           "card_vs_host_float32": rel_l1(f32, c32),
           "card_vs_host_bf16": rel_l1(b16, c16),
           "bf16_rel_l1_card": rel_l1(c32, c16),
           "bf16_rel_l1_host": rel_l1(f32, b16),
           "top1_agree_card": int((c32.argmax(1) == c16.argmax(1)).sum()),
           "top1_agree_host": int((f32.argmax(1) == b16.argmax(1)).sum()),
           "other_image_rel_l1": rel_l1(c32, np.roll(c32, 1, axis=0)),
           "float32_band": INFER_HOST_BAND,
           "drift_scale": HOST_DRIFT_SCALE}
    out["ok"] = (out["card_vs_host_float32"] <= INFER_HOST_BAND
                 and out["bf16_rel_l1_card"]
                 <= HOST_DRIFT_SCALE * out["bf16_rel_l1_host"]
                 and out["card_vs_host_bf16"]
                 <= out["other_image_rel_l1"] / 2)
    return out


def resnet50_fold_and_predictor(feeds, steps, batch):
    """ResNet-50's inference program with its batch norms calibrated on
    ``feeds[0]`` (``calibrate_batch_norms``), float32, one eager run on
    ``feeds[0]``.  Then the program after ``InferenceTranspiler`` (all 53
    batch norms folded into their convs) in ``two_arm_run``: captured =
    eager bit for bit, its softmax within relative L1 ``INFER_FOLD_BAND``
    of the unfolded program's on ``feeds[0]``.  Then the unfolded program
    saved with ``io.save_inference_model`` and served by
    ``create_paddle_predictor(AnalysisConfig(model_dir))`` (``CUDAPlace(0)``
    by default) and by a clone: every output bit-equal to an executor's
    run of the same saved program on the same images, images/s of the
    predictor's replays.  Returns ({path: launch record}, [faults])."""
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)

    paths, bad = {}, []
    main, startup, fetch = build_zoo("resnet50", infer=True)
    start = started(startup)
    eager = pt.Executor(pt.CUDAPlace(0), capture=False)
    calibrate_batch_norms(eager, main, start, feeds[0])
    unfolded = eager.run(main, feed=feeds[0], fetch_list=fetch,
                         scope=copy_scope(start))[0]
    folded = pt.transpiler.InferenceTranspiler().transpile(
        main, pt.CUDAPlace(0), scope=start)
    n_folded = sum("@BNFOLD_BIAS@" in n for n in start.local_var_names())
    s, records, runs = two_arm_run(folded, start, fetch, feeds, steps, batch,
                                   deterministic=False)
    s.update(model="resnet50", program="bn_folded",
             batch_norms_left=count_ops(folded, "batch_norm"),
             batch_norms_folded=n_folded,
             rel_l1_vs_unfolded=rel_l1(unfolded,
                                       runs["eager"]["out"][0][0]),
             band=INFER_FOLD_BAND)
    log("zoo_infer_bn_folded", s)
    for arm, rec in records.items():
        paths["zoo_infer:resnet50:bn_folded%s" % (
            "" if arm == "captured" else ":eager")] = rec
    if not (s["ok"] and n_folded == RESNET_BNS
            and s["batch_norms_left"] == 0
            and s["rel_l1_vs_unfolded"] <= INFER_FOLD_BAND):
        bad.append("resnet50:bn_folded")
    del runs, folded

    with tempfile.TemporaryDirectory() as model_dir:
        with pt.scope_guard(start):
            pt.io.save_inference_model(model_dir, ["img"], [fetch[0]],
                                       pt.Executor(pt.CUDAPlace(0)),
                                       main_program=main)
        pred = create_paddle_predictor(AnalysisConfig(model_dir))
        clone = pred.clone()
        exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
        with pt.scope_guard(scope):
            program, feed_names, fetch_vars = pt.io.load_inference_model(
                model_dir, exe)
        same, times = [], []
        for i, f in enumerate(feeds):
            want = exe.run(program, feed=f, fetch_list=fetch_vars,
                           scope=scope)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = (pred if i % 2 == 0 else clone).run(f)
            times.append(time.perf_counter() - t0)
            same.append(all(np.asarray(g.data).tobytes() == w.tobytes()
                            for g, w in zip(got, want)))
        r = {"model": "resnet50", "place": repr(pred._place),
             "feed_names": feed_names, "runs": len(feeds),
             "same_bits_as_executor": same,
             "run_ms": [t * 1e3 for t in times],
             # the replays (each predictor's third run on)
             "images_per_s": batch / statistics.median(times[4:])}
        log("zoo_infer_predictor", r)
        if not all(same) or pred._place != pt.CUDAPlace(0):
            bad.append("resnet50:predictor")
        del pred, clone, exe, scope, program
    del start
    release_memory()
    return paths, bad


def resnext_check_phase(batch=4, floor_scale=3.0, modes=("fuse",),
                        name="resnext_check"):
    """``resnet_check_phase`` on SE-ResNeXt-50 (the fused program of each
    of ``modes``: NCHW ``fuse``, or ``nhwc_fuse`` as
    ``resnext_nhwc_check``; against plain and against the CPU, dropout 0
    in every copy of the program, float32) under deterministic
    algorithms, every other run taking the fused card step's ReLU
    decisions at the squeeze fcs (relu inputs ``fc_*``).
    With each run's own decisions (``own_relus``, logged) the card run
    (NVIDIA H100 80GB HBM3, 700 W) reads 1.38e-2 at the median against a
    floor of 1.27e-2, but 7.47e-2 at most (3x the floor's maximum: 5.2e-2)
    at stage 4's first squeeze fc (``fc_26.w_0``), fused against plain
    and against the CPU alike; the one squeeze unit that decides
    otherwise is ``fc_26.tmp_1``'s (|input| 9.5e-7), and with its
    decision taken the maximum falls to 1.74e-2 / 1.88e-2 (floor 1.74e-2);
    the other 87-103 units that flip, in the conv and residual relus
    (|input| up to 8e-5), stay within the floor."""
    def build(mode, amp):
        main, startup, (loss,) = build_zoo("se_resnext50", amp=amp,
                                           fuse=mode != "plain",
                                           nhwc=mode == "nhwc_fuse",
                                           dropout=False)
        return main, startup, loss

    with deterministic_algorithms():
        return resnet_check_phase(batch=batch, floor_scale=floor_scale,
                                  build=build, modes=modes, name=name,
                                  take_relus="fc_")


def se_resnext_fused_phase(steps=ZOO_STEPS["se_resnext50"], batch=128):
    """SE-ResNeXt-50 after ``fuse_conv_bn`` at batch 128, float32 and AMP
    (``two_arm_run``): #8 and #9 launch exactly ``SE_FUSED`` (33) times
    a step, counted by the eager arm's wrappers and by both arms' traces.
    Returns {path: launch record}."""
    paths, bad = {}, []
    need = {"conv_bn_fwd": SE_FUSED, "conv_bn_bwd": SE_FUSED}
    for amp in (False, True):
        main, startup, fetch = build_zoo("se_resnext50", amp=amp,
                                         fuse=True)
        assert count_ops(main, "bn_act_conv2d") == SE_FUSED \
            == count_ops(main, "bn_act_conv2d_grad")
        s, records, _ = two_arm_run(main, started(startup), fetch,
                                    zoo_feeds("se_resnext50", steps + 3,
                                              batch), steps, batch, need)
        s.update(model="se_resnext50", fused_layers=SE_FUSED,
                 dtype="amp_bf16" if amp else "float32")
        log("se_resnext_fused", s)
        path = "se_resnext_fused" + ("_amp" if amp else "")
        paths[path] = records["captured"]
        paths[path + ":eager"] = records["eager"]
        if not s["ok"]:
            bad.append(path)
        del main, startup, fetch, records, _
        release_memory()
    if bad:
        raise SystemExit("se_resnext_fused: captured steps differ from "
                         "eager: %s" % bad)
    return paths


def transpose_ops_ms(program, batch, dtype, device="cuda"):
    """``program``'s ``transpose`` ops and their ``transpose_grad`` ops run
    alone at ``batch`` in ``dtype`` as the port runs them (``permute``: a
    view), each on inputs made with ``torch.empty`` (no kernel), under the
    profiler (``_profiled``: device busy ms, device events, the top
    events)."""
    from paddle_tpu_torch import registry

    block = program.global_block()
    ops = [op for op in block.ops
           if op.type in ("transpose", "transpose_grad")]
    ctx = registry.ComputeContext(torch.device(device), None,
                                  len(block.ops), program=program)

    def shape(name):
        return [batch if d in (-1, None) else d
                for d in block._find_var_recursive(name).shape]

    def run():
        for op in ops:
            ins = {slot: [torch.empty(shape(n), dtype=dtype, device=device)
                          for n in names]
                   for slot, names in op.inputs.items()}
            attrs = {k: v for k, v in op.attrs.items()
                     if k != "__fwd_op_index__"}
            registry.get_op_def(op.type).compute(ins, attrs, ctx, 0)

    w = _profiled(run)
    return {"ops": len(ops),
            "transpose": sum(op.type == "transpose" for op in ops),
            "dtype": str(dtype).replace("torch.", ""), "batch": batch,
            "as_run": {k: w[k] for k in ("busy_ms", "wall_ms",
                                         "device_events", "top_device_us")}}


def se_resnext_nhwc_fused_phase(steps=ZOO_STEPS["se_resnext50"],
                                batch=128):
    """SE-ResNeXt-50 after ``convert_to_nhwc`` (53 convs) then
    ``fuse_conv_bn`` (53 batch norms) at batch 128, float32 and AMP
    (``two_arm_run``): one graph for the entry, #10 and #11 exactly
    ``SE_FUSED`` (33) times a step and #8/#9 none, counted by the eager
    arm's wrappers and by both arms' traces; the step's transposes (50
    forward, 49 backward) timed alone (``transpose_ops_ms``).  Returns
    {path: launch record}."""
    paths, bad = {}, []
    need = {"conv_bn_fwd_nhwc": SE_FUSED, "conv_bn_bwd_nhwc": SE_FUSED}
    for amp in (False, True):
        main, startup, fetch = build_zoo("se_resnext50", amp=amp,
                                         fuse=True, nhwc=True)
        assert count_ops(main, "bn_act_conv2d") == SE_FUSED \
            == count_ops(main, "bn_act_conv2d_grad")
        assert count_ops(main, "transpose") == 50
        s, records, runs = two_arm_run(main, started(startup), fetch,
                                       zoo_feeds("se_resnext50", steps + 3,
                                                 batch), steps, batch, need)
        s.update(model="se_resnext50", layout="NHWC", fused_layers=SE_FUSED,
                 dtype="amp_bf16" if amp else "float32",
                 graphs=sum(st.graph is not None for st in
                            runs["captured"]["exe"]._steps.values()),
                 transposes=transpose_ops_ms(
                     main, batch, torch.bfloat16 if amp else torch.float32))
        log("se_resnext_nhwc_fused", s)
        path = "se_resnext_nhwc_fused" + ("_amp" if amp else "")
        paths[path] = records["captured"]
        paths[path + ":eager"] = records["eager"]
        if not s["ok"] or s["graphs"] != 1:
            bad.append(path)
        del main, startup, fetch, records, runs
        release_memory()
    if bad:
        raise SystemExit("se_resnext_nhwc_fused: captured steps differ from "
                         "eager, or more than one graph: %s" % bad)
    return paths


def se_resnext152_phase(steps=ZOO_STEPS["se_resnext152"], batch=128):
    """BASELINE's fifth configuration on one card: SE-ResNeXt-152 (the
    3-conv stem, cardinality 32, reduction 16) under AMP, Momentum(1e-3,
    0.9).  The batch is 128 if an eager step's peak leaves
    ``SE152_FREE_GB`` of the card free (else the largest power of two
    that does, the cut logged); the eager arm then the captured one
    (``two_arm_run(sequential=True)``), the same bits.  Multi-card
    ParallelExecutor stays ROADMAP A7.  Returns {path: launch record}."""
    import paddle_tpu_torch as pt

    total = torch.cuda.get_device_properties(0).total_memory
    main, startup, fetch = build_zoo("se_resnext152", amp=True)
    loss = fetch[0]
    first, probes = batch, []
    while True:
        scope = pt.Scope()
        exe = pt.Executor(pt.CUDAPlace(0), capture=False)
        try:
            exe.run(startup, scope=scope)
            torch.cuda.reset_peak_memory_stats()
            exe.run(main, feed=zoo_feeds("se_resnext152", 1, batch)[0],
                    fetch_list=[loss], scope=scope)
            peak = torch.cuda.max_memory_allocated()
        except torch.cuda.OutOfMemoryError:
            peak = None
        probes.append({"batch": batch,
                       "peak_gb": None if peak is None else peak / 1e9})
        del scope, exe
        release_memory()
        if peak is not None and total - peak >= SE152_FREE_GB * 1e9:
            break
        if batch == 1:
            raise SystemExit("se_resnext152: no batch fits: %s" % probes)
        batch //= 2
    s, records, _ = two_arm_run(main, started(startup), fetch,
                                zoo_feeds("se_resnext152", steps + 3,
                                          batch), steps, batch,
                                sequential=True)
    s.update(model="se_resnext152", dtype="amp_bf16", batch=batch,
             batch_probes=probes, card_memory_gb=total / 1e9,
             batch_cut_from=first if batch != first else None,
             multi_card="ROADMAP A7 (not run)")
    log("se_resnext152", s)
    if not s["ok"]:
        raise SystemExit("se_resnext152: captured steps differ from eager")
    return {"se_resnext152": records["captured"],
            "se_resnext152:eager": records["eager"]}


# ---------------------------------------------------------------------------
# the CNN op family's plain ops on the card against the CPU
# ---------------------------------------------------------------------------

def _cnn_op_cases():
    """(op type, inputs, attrs, outputs, differentiated inputs, outputs
    compared exactly): each op type of the CNN family the port gained
    beside ``pool2d``'s adaptive form, at small shapes (values distinct
    where a max picks)."""
    rng = np.random.RandomState(0)

    def randn(*shape):
        return rng.randn(*shape).astype("float32")

    def distinct(*shape):
        n = int(np.prod(shape))
        return (rng.permutation(n).reshape(shape) / n * 4 - 2) \
            .astype("float32")

    idx = np.stack([rng.permutation(47)[:12] for _ in range(6)])
    idx[:, 3], idx[:, 7], idx[:, 10] = -1, 48, -60   # -1 wraps; 2 dropped
    conv = ("Output",)
    io = ("Input", "Filter")
    return [
        ("conv3d", {"Input": randn(2, 3, 5, 6, 4),
                    "Filter": randn(4, 3, 3, 3, 3)},
         {"strides": [1, 2, 1], "paddings": [1, 0, 1],
          "dilations": [1, 1, 2], "groups": 1}, conv, io, ()),
        ("conv2d_transpose", {"Input": randn(2, 4, 5, 6),
                              "Filter": randn(4, 3, 3, 3)},
         {"strides": [2, 1], "paddings": [1, 0], "dilations": [1, 2],
          "groups": 1}, conv, io, ()),
        ("conv3d_transpose", {"Input": randn(2, 4, 3, 4, 3),
                              "Filter": randn(4, 2, 2, 3, 2)},
         {"strides": [2, 1, 2], "paddings": [0, 1, 0],
          "dilations": [1, 1, 1], "groups": 1}, conv, io, ()),
        ("depthwise_conv2d_transpose", {"Input": randn(2, 4, 5, 5),
                                        "Filter": randn(4, 1, 3, 3)},
         {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
          "groups": 4}, conv, io, ()),
        ("conv_shift", {"X": randn(3, 8), "Y": randn(3, 5)}, {}, ("Out",),
         ("X", "Y"), ()),
        ("pool2d", {"X": distinct(2, 3, 7, 9)},
         {"pooling_type": "max", "ksize": [3, 4], "adaptive": True},
         ("Out",), ("X",), ("Out",)),
        ("pool2d", {"X": randn(2, 7, 9, 3)},
         {"pooling_type": "avg", "ksize": [2, 5], "adaptive": True,
          "data_format": "NHWC"}, ("Out",), ("X",), ()),
        ("pool3d", {"X": randn(2, 3, 5, 6, 7)},
         {"pooling_type": "avg", "ksize": [3, 3, 2], "strides": [2, 2, 2],
          "paddings": [1, 1, 0], "ceil_mode": True}, ("Out",), ("X",), ()),
        ("pool3d", {"X": randn(2, 3, 5, 6, 7)},
         {"pooling_type": "avg", "ksize": [2, 4, 3], "adaptive": True},
         ("Out",), ("X",), ()),
        ("max_pool2d_with_index", {"X": distinct(2, 3, 7, 8)},
         {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]},
         ("Out", "Mask"), ("X",), ("Out", "Mask")),
        ("max_pool3d_with_index", {"X": distinct(2, 2, 5, 6, 4)},
         {"ksize": [2, 3, 2], "strides": [2, 2, 2], "paddings": [1, 0, 1]},
         ("Out", "Mask"), ("X",), ("Out", "Mask")),
        ("spp", {"X": distinct(2, 3, 9, 7)},
         {"pyramid_height": 3, "pooling_type": "max"}, ("Out",), ("X",),
         ("Out",)),
        ("unpool", {"X": randn(2, 3, 3, 4),
                    "Indices": idx.reshape(2, 3, 3, 4).astype("int32")},
         {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]},
         ("Out",), ("X",), ("Out",)),
        ("group_norm", {"X": randn(2, 6, 4, 5) + 0.5,
                        "Scale": randn(6) + 1, "Bias": randn(6)},
         {"groups": 3, "epsilon": 1e-5}, ("Y", "Mean", "Variance"),
         ("X", "Scale", "Bias"), ()),
        ("norm", {"X": randn(3, 5, 4)}, {"axis": 1, "epsilon": 1e-10},
         ("Out", "Norm"), ("X",), ()),
        ("bilinear_interp", {"X": randn(2, 3, 5, 7)},
         {"out_h": 8, "out_w": 4}, ("Out",), ("X",), ()),
        ("nearest_interp", {"X": randn(2, 3, 5, 7)},
         {"out_h": 9, "out_w": 13}, ("Out",), ("X",), ("Out",)),
    ]


def cnn_ops_phase():
    """Each op type of the CNN family (no hand kernel: ``F.conv*``, pooling,
    gathers and scatters) as a one-op program on ``CUDAPlace(0)`` against
    ``CPUPlace()``: forward outputs within rtol 1e-5 / atol 1e-6 (``Mask``,
    the max picks, ``unpool``'s placement with offsets out of the plane
    and ``nearest_interp``'s gather bit for bit) and the gradients of
    every floating input within relative L2 1e-5.  Raises on a fault."""
    import paddle_tpu_torch as pt

    rows, bad = [], []
    for op_type, inputs, attrs, outputs, diff, exact in _cnn_op_cases():
        slots = {k: 1 for k in outputs}
        (card,), _ = _one_op_run(pt.CUDAPlace(0), op_type, inputs, attrs,
                                 slots, diff)
        (host,), _ = _one_op_run(pt.CPUPlace(), op_type, inputs, attrs,
                                 slots, diff)
        names = list(outputs) + [k + "@GRAD" for k in diff]
        errs, ok = {}, True
        for name, c, h in zip(names, card, host):
            if name in exact:
                same = c.dtype == h.dtype and np.array_equal(c, h)
                errs[name] = "same bits" if same else "differ"
                ok = ok and same
            elif name.endswith("@GRAD"):
                den = max(float(np.linalg.norm(h)), 1e-30)
                errs[name] = float(np.linalg.norm(c - h)) / den
                ok = ok and errs[name] <= 1e-5
            else:
                errs[name] = float(np.abs(c - h).max())
                ok = ok and bool(np.allclose(c, h, rtol=1e-5, atol=1e-6))
        tag = op_type + ("_adaptive" if attrs.get("adaptive") else "")
        rows.append({"op": tag, "attrs": attrs, "errors": errs, "ok": ok})
        if not ok:
            bad.append(tag)
    log("cnn_ops", {"cases": rows, "ok": not bad})
    if bad:
        raise SystemExit("cnn_ops: the card differs from the CPU: %s" % bad)


# ---------------------------------------------------------------------------
# the plain op library and the Fluid frontend: each op type card against
# CPU, and models/mnist.py's conv net through the Trainer
# ---------------------------------------------------------------------------

ROW = (256, 32000)          # serving logits: the row ops' shape
TABLE = (32000, 512)        # gather / scatter table
N_IDS = 8192
PLAIN_RTOL, PLAIN_ATOL, PLAIN_GRAD = 1e-5, 1e-6, 1e-5
# a scan of k float32 terms rounds within ~k u sum|x|; the card's scan
# adds in another order than the host's, so cumsum is held elementwise to
# CUMSUM_BAND times the running sum of |x| (about 8 u at k = 1)
CUMSUM_BAND = 1e-6


def _plain_ids(rng, rows, n):
    """``n`` ids into ``rows`` rows: repeated ids, negative ones (counting
    from the end) and ids out of range either way (gathered as NaN,
    dropped by a scatter)."""
    ids = rng.randint(0, rows, n).astype("int64")
    ids[: n // 8] = ids[n // 8: n // 4]                  # repeats
    ids[n // 4: n // 4 + 64] = -rng.randint(1, rows, 64)  # from the end
    ids[n // 2: n // 2 + 32] = rows + rng.randint(0, 9, 32)
    ids[-32:] = -rows - 1 - rng.randint(0, 9, 32)
    return rng.permutation(ids)


def _plain_op_cases():
    """(op type, inputs, attrs, {output slot: vars}, differentiated
    slots, check): each of the 58 op types of the plain op library but the
    random four and ``print`` (``_plain_random_checks``,
    ``mnist_cnn_print_check``); ``check`` is "exact" (bool, integer and
    index outputs, copies), "float" (rtol 1e-5 / atol 1e-6) or "cumsum"
    (``CUMSUM_BAND``).  Row ops at serving-logit shape [256, 32000];
    ``gather`` / ``scatter`` on a [32000, 512] table with 8192 ids."""
    rng = np.random.RandomState(0)

    def randn(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype("float32")

    def ties(*shape):
        return rng.randint(-3, 4, shape).astype("float32")

    def divisor(*shape):
        return ((rng.rand(*shape) * 2 + 0.5)
                * rng.choice([-1, 1], shape)).astype("float32")

    row_b = rng.rand(*ROW) > 0.5
    sort_x = ties(*ROW)
    sort_x[rng.randint(0, ROW[0], 64), rng.randint(0, ROW[1], 64)] = np.nan
    prod = randn(64, 16) * 0.5 + 1.0
    prod[3, 5] = 0.0
    prod[7, [1, 9]] = 0.0
    bad = [randn(*ROW), randn(8, 8)]
    bad[1][2, 3] = np.inf
    bad[0][100, 200] = np.nan
    ids = _plain_ids(rng, TABLE[0], N_IDS)
    mux_ids = rng.randint(0, 3, (8192, 1)).astype("int32")
    mux_ids[:16] = -1
    mux_ids[16:32] = 3
    lens = rng.randint(1, 51, 512).astype("int32")
    one = {"Out": 1}
    cases = [
        ("elementwise_mod", {"X": randn(*ROW, scale=5), "Y": divisor(*ROW)},
         {}, one, ("X", "Y"), "float"),
        ("elementwise_mod", {"X": rng.randint(-99, 99, (256, 1000))
                             .astype("int32"),
                             "Y": rng.randint(-4, 5, (256, 1000))
                             .astype("int32")},
         {}, one, (), "exact"),
        ("elementwise_floordiv", {"X": randn(*ROW, scale=5),
                                  "Y": divisor(*ROW)},
         {}, one, ("X", "Y"), "float"),
        ("elementwise_floordiv", {"X": rng.randint(-99, 99, (256, 1000))
                                  .astype("int64"),
                                  "Y": rng.randint(-4, 5, (256, 1000))
                                  .astype("int64")},
         {}, one, (), "exact"),
    ]
    cmp_x, cmp_y = ties(*ROW), ties(*ROW)
    for t in ("less_than", "less_equal", "greater_than", "greater_equal",
              "equal", "not_equal"):
        cases.append((t, {"X": cmp_x, "Y": cmp_y}, {}, one, (), "exact"))
    cases.append(("less_than", {"X": cmp_x, "Y": cmp_y[:1]}, {}, one, (),
                  "exact"))
    by = rng.rand(*ROW) > 0.5
    for t in ("logical_and", "logical_or", "logical_xor"):
        cases.append((t, {"X": row_b, "Y": by}, {}, one, (), "exact"))
    cases += [
        ("logical_not", {"X": row_b}, {}, one, (), "exact"),
        ("reduce_max", {"X": ties(*ROW)}, {"dim": [1]}, one, ("X",),
         "float"),
        ("reduce_min", {"X": randn(*ROW)}, {"dim": [0], "keep_dim": True},
         one, ("X",), "float"),
        ("reduce_prod", {"X": prod}, {"dim": [1]}, one, ("X",), "float"),
        ("arg_max", {"X": ties(*ROW)}, {"axis": 1}, one, (), "exact"),
        ("arg_min", {"X": ties(*ROW)}, {"axis": 1}, one, (), "exact"),
        ("cumsum", {"X": randn(*ROW)}, {"axis": -1}, one, ("X",),
         "cumsum"),
        ("cumsum", {"X": randn(*ROW)},
         {"axis": 1, "exclusive": True, "reverse": True}, one, ("X",),
         "cumsum"),
        ("minus", {"X": randn(*ROW), "Y": randn(*ROW)}, {}, one,
         ("X", "Y"), "float"),
        ("l1_norm", {"X": randn(*ROW)}, {}, one, ("X",), "float"),
        ("squared_l2_distance", {"X": randn(4096, 512),
                                 "Y": randn(1, 512)}, {},
         {"Out": 1, "sub_result": 1}, ("X", "Y"), "float"),
        ("isfinite", {"X": bad}, {}, one, (), "exact"),
        ("has_inf", {"X": bad}, {}, one, (), "exact"),
        ("has_nan", {"X": bad}, {}, one, (), "exact"),
        ("flatten", {"X": randn(64, 8, 16, 32)}, {"axis": 2}, one, ("X",),
         "exact"),
        ("split", {"X": randn(*ROW)},
         {"axis": 1, "sections": [16000, 8000, 8000], "num": 3},
         {"Out": 3}, ("X",), "exact"),
        ("stack", {"X": [randn(256, 4096) for _ in range(3)]},
         {"axis": 1}, {"Y": 1}, ("X",), "exact"),
        ("unstack", {"X": randn(16, 256, 512)}, {"axis": 0, "num": 16},
         {"Y": 16}, ("X",), "exact"),
        ("expand", {"X": randn(256, 1, 128)}, {"expand_times": [1, 8, 1]},
         one, ("X",), "exact"),
        ("reverse", {"X": randn(*ROW)}, {"axis": [0, 1]}, one, ("X",),
         "exact"),
        ("pad", {"X": randn(256, 1000)}, {"paddings": [3, 1, 0, 24],
                                          "pad_value": -1.5},
         one, ("X",), "exact"),
        ("gather", {"X": randn(*TABLE), "Index": ids}, {}, one, ("X",),
         "exact"),
        ("scatter", {"X": randn(*TABLE), "Ids": ids,
                     "Updates": randn(N_IDS, TABLE[1])},
         {"overwrite": True}, one, ("X", "Updates"), "exact"),
        ("scatter", {"X": randn(*TABLE), "Ids": ids,
                     "Updates": randn(N_IDS, TABLE[1])},
         {"overwrite": False}, one, ("X", "Updates"), "float"),
        ("one_hot", {"X": np.concatenate([rng.randint(
            0, ROW[1], (ROW[0] - 4, 1)), [[-1], [ROW[1]], [0],
                                          [ROW[1] - 1]]]).astype("int64")},
         {"depth": ROW[1]}, one, (), "exact"),
        ("label_smooth", {"X": rng.rand(*ROW).astype("float32")},
         {"epsilon": 0.1}, one, ("X",), "float"),
        ("multiplex", {"X": [randn(8192, 64) for _ in range(3)],
                       "Ids": mux_ids}, {}, one, ("X",), "exact"),
        ("argsort", {"X": sort_x}, {"axis": -1},
         {"Out": 1, "Indices": 1}, (), "exact"),
        ("crop", {"X": randn(64, 128, 96),
                  "Offsets": np.asarray([3, -40, 70], "int32")},
         {"shape": [32, 64, 48]}, one, ("X",), "exact"),
        ("pad2d", {"X": randn(32, 16, 64, 64)},
         {"paddings": [2, 1, 3, 2], "mode": "reflect"}, one, ("X",),
         "float"),
        ("pad_constant_like", {"X": randn(256, 1024),
                               "Y": randn(200, 1000)},
         {"pad_value": 0.5}, one, ("Y",), "exact"),
        ("is_empty", {"X": randn(256, 64)}, {}, one, (), "exact"),
        ("fill", {}, {"shape": [64, 8], "dtype": "float32",
                      "value": rng.randn(512).tolist()}, one, (), "exact"),
        ("scale_sub_region", {"X": randn(32, 16, 64, 64),
                              "Indices": np.stack([
                                  rng.randint(1, 8, 32),
                                  rng.randint(8, 17, 32),
                                  rng.randint(1, 32, 32),
                                  rng.randint(32, 65, 32),
                                  rng.randint(1, 32, 32),
                                  rng.randint(32, 65, 32)], 1)
                              .astype("int32")},
         {"value": 2.5}, one, ("X",), "float"),
        ("shape", {"Input": randn(64, 8, 16)}, {}, one, (), "exact"),
        ("fill_zeros_like", {"X": randn(*ROW)}, {}, one, (), "exact"),
        ("sigmoid_cross_entropy_with_logits",
         {"X": randn(*ROW, scale=3), "Label": (rng.rand(*ROW) > 0.5)
          .astype("float32")}, {}, one, ("X",), "float"),
        ("huber_loss", {"X": randn(8192, 1), "Y": randn(8192, 1)},
         {"delta": 0.7}, {"Out": 1, "Residual": 1}, ("X",), "float"),
        ("smooth_l1_loss", {"X": randn(4096, 64), "Y": randn(4096, 64),
                            "InsideWeight": rng.rand(4096, 64)
                            .astype("float32"),
                            "OutsideWeight": rng.rand(4096, 64)
                            .astype("float32")},
         {"sigma": 1.5}, {"Out": 1, "Diff": 1}, ("X",), "float"),
        ("hinge_loss", {"Logits": randn(8192, 1),
                        "Labels": rng.randint(0, 2, (8192, 1))
                        .astype("float32")},
         {}, {"Loss": 1}, ("Logits",), "float"),
        ("log_loss", {"Predicted": rng.rand(8192, 1).astype("float32"),
                      "Labels": rng.randint(0, 2, (8192, 1))
                      .astype("float32")},
         {"epsilon": 1e-4}, {"Loss": 1}, ("Predicted",), "float"),
        ("rank_loss", {"Label": rng.randint(0, 2, (8192, 1))
                       .astype("float32"), "Left": randn(8192, 1),
                       "Right": randn(8192, 1)},
         {}, one, ("Left", "Right"), "float"),
        ("modified_huber_loss", {"X": randn(8192, 1, scale=2),
                                 "Y": rng.randint(0, 2, (8192, 1))
                                 .astype("float32")},
         {}, {"Out": 1, "IntermediateVal": 1}, ("X",), "float"),
        ("lambda_cost", {"Score": randn(512, 50, 1),
                         "Rel": rng.randint(0, 4, (512, 50, 1))
                         .astype("float32"), "Length": lens},
         {"ndcg_num": 5}, one, ("Score",), "float"),
    ]
    return cases


def _one_op_run(place, op_type, inputs, attrs, outputs, diff, seed=0,
                capture=True, runs=1):
    """The outputs (flattened in slot order) and the gradients of
    ``mean(first output * w)`` with respect to ``diff``'s inputs of a
    one-op program at ``place``, for each of ``runs`` runs of one
    executor."""
    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = seed
    feed = {}
    with pt.program_guard(main, startup), pt.unique_name.guard():
        block = main.global_block()
        ins = {}
        for slot, arr in inputs.items():
            arrs = arr if isinstance(arr, list) else [arr]
            ins[slot] = []
            for i, a in enumerate(arrs):
                name = slot.lower() + ("%d" % i if isinstance(arr, list)
                                       else "")
                v = pt.layers.data(name, shape=list(a.shape),
                                   append_batch_size=False,
                                   dtype=str(a.dtype))
                v.stop_gradient = slot not in diff
                ins[slot].append(v)
                feed[name] = a
        outs = {k: [block.create_var(name=pt.unique_name.generate(
            k.lower())) for _ in range(n)] for k, n in outputs.items()}
        block.append_op(type=op_type, inputs=ins, outputs=outs,
                        attrs=dict(attrs))
        head = next(iter(outs.values()))[0]
        grads = []
        if diff:
            w = pt.layers.data("loss_w", shape=list(head.shape),
                               append_batch_size=False)
            feed["loss_w"] = np.random.RandomState(1).rand(
                *head.shape).astype("float32")
            pt.backward.append_backward(
                pt.layers.mean(pt.layers.elementwise_mul(head, w)))
            grads = [v.name + "@GRAD" for k in diff for v in ins[k]]
    exe = pt.Executor(place, capture=capture)
    scope = pt.Scope()
    fetch = [v for k in outputs for v in outs[k]] + grads
    return [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            for _ in range(runs)], len(fetch) - len(grads)


def _plain_compare(check, card, host, x=None):
    """(error, within) of one output: "exact" bits (NaN at the same
    places), "float" rtol / atol, "cumsum" the scan band."""
    if check == "exact":
        same = card.dtype == host.dtype and np.array_equal(
            card, host, equal_nan=card.dtype.kind == "f")
        return ("same bits" if same else "differ"), bool(same)
    diff = np.abs(card.astype(np.float64) - host)
    err = float(np.nanmax(diff)) if diff.size else 0.0
    if not np.array_equal(np.isnan(card), np.isnan(host)):
        return err, False
    if check == "cumsum":
        return err, bool(np.all(diff <= CUMSUM_BAND * x + 1e-30))
    return err, bool(np.allclose(card, host, rtol=PLAIN_RTOL,
                                 atol=PLAIN_ATOL, equal_nan=True))


def _running_abs(x, attrs):
    """cumsum's band scale: the running sum of |x| along the scan."""
    a = np.abs(x.astype(np.float64))
    axis = attrs.get("axis", -1)
    if attrs.get("reverse"):
        a = np.flip(a, axis)
    a = np.cumsum(a, axis=axis)
    return np.flip(a, axis) if attrs.get("reverse") else a


def plain_ops_phase():
    """Each of the 58 op types of the plain op library (no hand kernel) as
    a one-op program on ``CUDAPlace(0)`` against ``CPUPlace()``: bool,
    integer and index outputs and the copies (gather, scatter's
    overwrite, the pads, crop, split, ...) bit for bit, the rest within
    rtol 1e-5 / atol 1e-6 (cumsum: ``CUMSUM_BAND``), the gradient of
    every floating input the op differentiates within relative L2 1e-5,
    all read from the card's second run, a CUDA graph's replay, whose
    outputs must be the first (eager) run's bits; the random ops by their
    moments and range, captured = eager bit for bit over three runs
    (``_plain_random_checks``); ``print`` passes its
    input through bit for bit, and writes a line a run on both devices.
    The launch counters, zeroed before and read after, count no hand
    kernel.  Raises on a fault."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda

    cuda.reset_launch_counts()
    rows, bad, types = [], [], set()
    for op_type, inputs, attrs, outputs, diff, check in _plain_op_cases():
        t0 = time.perf_counter()
        # the first run eager, the second captured into a graph and
        # replayed: the graph's outputs are compared with the CPU's
        (first, card), n = _one_op_run(pt.CUDAPlace(0), op_type, inputs,
                                         attrs, outputs, diff, runs=2)
        card_s = time.perf_counter() - t0
        repeatable = all(np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
                         for a, b in zip(first[:n], card[:n]))
        t0 = time.perf_counter()
        (host,), _ = _one_op_run(pt.CPUPlace(), op_type, inputs, attrs,
                                   outputs, diff)
        cpu_s = time.perf_counter() - t0
        x = _running_abs(inputs["X"], attrs) if check == "cumsum" else None
        errs, ok = {}, repeatable
        for i, (c, h) in enumerate(zip(card, host)):
            if i < n:
                e, within = _plain_compare(check, c, h, x)
            else:
                den = max(float(np.linalg.norm(h)), 1e-30)
                e = float(np.linalg.norm(c.astype(np.float64) - h)) / den
                within = e <= PLAIN_GRAD and bool(
                    np.isfinite(c).all() == np.isfinite(h).all())
            errs["out%d" % i if i < n else "grad%d" % (i - n)] = e
            ok = ok and within
        rows.append({"op": op_type, "check": check, "errors": errs,
                     "captured_repeats_eager": repeatable, "ok": ok,
                     "card_s": card_s, "cpu_s": cpu_s})
        types.add(op_type)
        if not ok:
            bad.append(op_type)
    random_rows, random_bad = _plain_random_checks()
    types.update(r["op"] for r in random_rows)
    bad += random_bad
    printed = _plain_print_check()
    types.add("print")
    if not printed["ok"]:
        bad.append("print")
    launches = {k: n for k, n in cuda.launch_counts().items() if n}
    summary = {"types": len(types), "cases": rows, "random": random_rows,
               "print": printed, "hand_kernel_launches": launches,
               "ok": not bad and not launches and len(types) == 58}
    log("plain_ops", summary)
    if not summary["ok"]:
        raise SystemExit("plain_ops: the card differs from the CPU or a "
                         "case is missing: %s %s (%d types)"
                         % (bad, launches, len(types)))
    return summary


def _plain_random_checks():
    """The four random op types: a program of seed 11 run three times by
    a capturing executor and by an eager one on the card (the first run
    eager in both, the second the capture, the third a replay): every run
    the same bits in the two; the third run's draws within their bounds:
    the batch-size-like randoms' range and first two moments within 1% of
    the distribution's, ``sampling_id``'s frequencies within 0.01 of the
    probabilities (262144 rows), ``random_crop``'s windows whole and each
    offset's frequency within 0.01 of uniform (32768 planes: ~6 standard
    deviations); a replay draws numbers the run before did not."""
    import paddle_tpu_torch as pt

    rng = np.random.RandomState(2)
    p = np.asarray([0.05, 0.4, 0.0, 0.25, 0.3], "float32")
    planes = rng.rand(32768, 16, 20).astype("float32")
    cases = [
        ("uniform_random_batch_size_like",
         {"Input": np.zeros((4096, 3), "float32")},
         {"shape": [-1, 512], "min": -2.0, "max": 3.0,
          "dtype": "float32"}, {"Out": 1}),
        ("gaussian_random_batch_size_like",
         {"Input": np.zeros((4096, 3), "float32")},
         {"shape": [-1, 512], "mean": 1.5, "std": 0.5,
          "dtype": "float32"}, {"Out": 1}),
        ("sampling_id", {"X": np.tile(p, (262144, 1))}, {}, {"Out": 1}),
        ("random_crop", {"X": planes, "Seed": np.asarray([5], "int64")},
         {"shape": [8, 12], "startup_seed": 0},
         {"Out": 1, "SeedOut": 1}),
    ]
    rows, bad = [], []
    for op_type, inputs, attrs, outputs in cases:
        arms = {cap: _one_op_run(pt.CUDAPlace(0), op_type, inputs, attrs,
                                   outputs, (), seed=11, capture=cap,
                                   runs=3)[0]
                for cap in (True, False)}
        same = all(np.array_equal(a, b)
                   for ra, rb in zip(arms[True], arms[False])
                   for a, b in zip(ra, rb))
        out = arms[True][2][0]
        row = {"op": op_type, "same_bits_captured_eager": same,
               "replay_draws_anew": not np.array_equal(arms[True][1][0],
                                                       out)}
        if op_type == "uniform_random_batch_size_like":
            lo, hi = attrs["min"], attrs["max"]
            mean, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
            within = lo <= out.min() and out.max() < hi
        elif op_type == "gaussian_random_batch_size_like":
            mean, var, within = attrs["mean"], attrs["std"] ** 2, True
        if "Input" in inputs:
            row.update(shape=list(out.shape), mean=float(out.mean()),
                       var=float(out.var()), want_mean=mean, want_var=var)
            within = within and out.shape == (4096, 512) \
                and abs(out.mean() - mean) < 0.01 * max(abs(mean), 1.0) \
                and abs(out.var() - var) < 0.01 * var
        elif op_type == "sampling_id":
            freq = np.bincount(out, minlength=len(p)) / len(out)
            row["freq"] = freq.tolist()
            within = np.abs(freq - p).max() < 0.01 and freq[2] == 0
        else:
            # each window's first value names its offset (the values of
            # a plane are distinct)
            first = np.argmax((planes == out[:, :1, :1])
                              .reshape(len(out), -1), axis=1)
            oh, ow = first // 20, first % 20
            window = planes[np.arange(len(out))[:, None, None],
                            oh[:, None, None] + np.arange(8)[:, None],
                            ow[:, None, None] + np.arange(12)]
            fh = np.bincount(oh, minlength=9) / len(oh)
            fw = np.bincount(ow, minlength=9) / len(ow)
            row.update(offset_freq_h=fh.tolist(), offset_freq_w=fw.tolist(),
                       seed_out=int(arms[True][2][1][0]))
            within = np.array_equal(out, window) and len(fh) == len(fw) == 9 \
                and np.abs(fh - 1 / 9).max() < 0.01 \
                and np.abs(fw - 1 / 9).max() < 0.01 and row["seed_out"] == 5
        row["within"] = bool(within)
        row["ok"] = bool(same and row["replay_draws_anew"] and within)
        rows.append(row)
        if not row["ok"]:
            bad.append(op_type)
    return rows, bad


def _plain_print_check():
    """A ``print`` of a [4, 3] tensor with its backward printed too, on
    the card (a capturing executor, three runs) and on the CPU: the
    output and the gradient the same bits, a forward and a backward line
    a run on both devices (the card's entry is never captured)."""
    import io

    import paddle_tpu_torch as pt

    x = np.random.RandomState(3).randn(4, 3).astype("float32")
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        v = pt.layers.data("x", shape=[4, 3], append_batch_size=False)
        v.stop_gradient = False
        out = pt.layers.Print(v, message="plain_ops_print",
                              print_phase="both")
        pt.backward.append_backward(pt.layers.mean(out))
    res, lines = {}, {}
    for name, place, runs in (("card", pt.CUDAPlace(0), 3),
                              ("cpu", pt.CPUPlace(), 1)):
        exe, buf = pt.Executor(place), io.StringIO()
        with contextlib.redirect_stdout(buf):
            for _ in range(runs):
                got = exe.run(main, feed={"x": x},
                              fetch_list=[out, "x@GRAD"], scope=pt.Scope())
        res[name] = got
        lines[name] = [ln for ln in buf.getvalue().splitlines()
                       if ln.startswith("plain_ops_print")]
        if name == "card":
            graphs = sum(st.graph is not None for st in exe._steps.values())
    same = all(np.array_equal(a, b) for a, b in zip(res["card"],
                                                    res["cpu"]))
    return {"same_bits": same, "card_lines": len(lines["card"]),
            "cpu_lines": len(lines["cpu"]), "graphs": graphs,
            "first_line": lines["card"][:1],
            "ok": bool(same and len(lines["card"]) == 6
                       and len(lines["cpu"]) == 2 and graphs == 0)}


MNIST_BATCH = 256           # bench.py's MNIST batch (bench.py:1411)
MNIST_STEPS = 20


def mnist_cnn_train_func():
    """``models/mnist.py``'s ``cnn_model`` (two conv-pools of 20 and 50
    5x5 filters, a softmax fc over 1x28x28) with its loss written in the
    frontend: the mean cross-entropy plus a confidence penalty ``1e-4 *
    sum(p * p)`` (``Variable`` operators), and an in-program accuracy
    (``argmax`` / ``equal`` / ``cast``).  Returns [loss, accuracy]."""
    import paddle_tpu_torch as pt

    L = pt.layers
    img = L.data("img", shape=[1, 28, 28])
    label = L.data("label", shape=[1], dtype="int64")
    pred = pt.models.mnist.cnn_model(img)
    loss = L.mean(L.cross_entropy(pred, label)) \
        + 1e-4 * L.reduce_sum(pred * pred)
    hit = L.equal(L.argmax(pred, axis=1), L.reshape(label, [-1]))
    return [loss, L.mean(L.cast(hit, "float32"))]


def synthetic_digits(rng, n):
    """``n`` learnable 1x28x28 images: the class is the row band (rows
    2c .. 2c + 3) lit above uniform noise."""
    y = rng.randint(0, 10, n)
    x = rng.rand(n, 1, 28, 28).astype("float32") * 0.2
    for c in range(10):
        x[y == c, 0, 2 * c:2 * c + 4, :] += 1.0
    return x, y.astype("int64").reshape(-1, 1)


def build_mnist_cnn(batch=None):
    """(main, startup, [loss, accuracy]) under Adam(1e-3)."""
    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 3
    with pt.program_guard(main, startup), pt.unique_name.guard():
        fetch = mnist_cnn_train_func()
        pt.optimizer.Adam(learning_rate=1e-3).minimize(fetch[0])
    return main, startup, fetch


def mnist_cnn_check(floor_scale=3.0):
    """One step at batch 4, card against CPU from one startup state,
    within ``floor_scale`` times the floor a 1e-7 nudge of every weight
    gives on the card in the same call (``amp_small_check``; float32)."""
    def build():
        main, startup, fetch = build_mnist_cnn()
        x, y = synthetic_digits(np.random.RandomState(8), 4)
        return main, startup, fetch[0], {"img": x, "label": y}

    r = amp_small_check(build, floor_scale)
    r = {k: r[k] for k in ("params", "loss_card", "loss_cpu", "loss_rel",
                           "grad_rel_l2_median", "grad_rel_l2_max",
                           "grad_rel_l2_top3", "floor_rel_l2_median",
                           "floor_rel_l2_max", "within_3x_floor",
                           "not_float32")}
    r.update(batch=4, floor_scale=floor_scale,
             ok=r["within_3x_floor"] and not r["not_float32"])
    log("mnist_cnn_check", r)
    if not r["ok"]:
        raise SystemExit("mnist_cnn: the card's step is not within %gx "
                         "its floor of the CPU's" % floor_scale)
    return r


def mnist_cnn_print_check():
    """The rule for ``print``: a program holding one (the conv net's
    first two predictions) on a capturing executor runs eagerly every
    time and is never captured, so each of three runs prints; its
    wrappers launch no hand kernel."""
    import io

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        img = pt.layers.data("img", shape=[1, 28, 28])
        pred = pt.models.mnist.cnn_model(img)
        shown = pt.layers.Print(pt.layers.slice(pred, [0], [0], [2]),
                                message="mnist_cnn_print")
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = started(startup)
    x, _ = synthetic_digits(np.random.RandomState(9), 8)
    buf = io.StringIO()
    cuda.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        for _ in range(3):
            exe.run(main, feed={"img": x}, fetch_list=[shown], scope=scope)
    launches = {k: n for k, n in cuda.launch_counts().items() if n}
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("mnist_cnn_print")]
    graphs = sum(st.graph is not None for st in exe._steps.values())
    r = {"runs": 3, "lines": len(lines), "graphs": graphs,
         "never_captured": len(exe._host_entries) == 1,
         "output": buf.getvalue().splitlines(),
         "hand_kernel_launches": launches}
    r["ok"] = len(lines) == 3 and graphs == 0 and r["never_captured"] \
        and not launches
    log("mnist_cnn_print", r)
    if not r["ok"]:
        raise SystemExit("mnist_cnn: the print rule does not hold: %s" % r)
    return r


def mnist_cnn_phase(steps=MNIST_STEPS, trainer_epochs=4,
                    trainer_batches=40):
    """``models/mnist.py``'s conv net at bench.py's MNIST batch (256),
    Adam(1e-3), float32, on ``CUDAPlace(0)``:

    * ``mnist_cnn_check``: batch 4, card against CPU within 3x the
      same-call floor;
    * ``two_arm_run``: captured and eager from one startup state over
      ``steps`` steps on the same batches, under deterministic algorithms
      (cuDNN's convolution backward): the losses and accuracies and every
      scope tensor the same bits; images/s of each arm, peak memory, the
      idle share of a profiled step; one graph for the entry; no hand
      kernel launches (the launch gate expects 0);
    * the user path: ``Trainer.train`` over a ``reader.batch`` reader
      (``trainer_batches`` batches of 256 an epoch, ``DataFeeder``
      converting each): images/s of each epoch after the first, the loss
      falling, ``metrics.Accuracy`` over the fetched accuracies;
    * ``mnist_cnn_print_check``.

    Returns {path: launch record}."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import metrics
    from paddle_tpu_torch.contrib import Trainer

    mnist_cnn_check()
    main, startup, fetch = build_mnist_cnn()
    rng = np.random.RandomState(42)
    feeds = [dict(zip(("img", "label"), synthetic_digits(rng, MNIST_BATCH)))
             for _ in range(steps + 3)]
    s, records, runs = two_arm_run(main, started(startup), fetch, feeds,
                                   steps, MNIST_BATCH)
    s["graphs"] = sum(st.graph is not None
                      for st in runs["captured"]["exe"]._steps.values())
    s["accuracy_last"] = [float(o[1][0]) for o in
                          runs["captured"]["out"][-3:]]
    del runs
    release_memory()

    x, y = synthetic_digits(np.random.RandomState(7),
                            MNIST_BATCH * trainer_batches)
    rows = [(x[i], [int(y[i, 0])]) for i in range(len(x))]
    losses, epoch_s, acc = [], [], metrics.Accuracy()
    epoch_acc = []

    def handler(e):
        name = type(e).__name__
        if name == "BeginEpochEvent":
            epoch_s.append(time.perf_counter())
            acc.reset()
        elif name == "EndEpochEvent":
            epoch_s[-1] = time.perf_counter() - epoch_s[-1]
            epoch_acc.append(acc.eval())
        elif name == "EndStepEvent":
            losses.append(float(e.metrics[0][0]))
            acc.update(value=float(e.metrics[1][0]), weight=MNIST_BATCH)

    trainer = Trainer(mnist_cnn_train_func, lambda: pt.optimizer.Adam(1e-3),
                      place=pt.CUDAPlace(0))
    trainer.train(trainer_epochs, handler,
                  reader=pt.batch(lambda: iter(rows), MNIST_BATCH),
                  feed_order=["img", "label"])
    per_epoch = [MNIST_BATCH * trainer_batches / t for t in epoch_s[1:]]
    falls = bool(losses[-1] < 0.5 * losses[0]
                 and epoch_acc[-1] > epoch_acc[0])
    s["trainer"] = {"epochs": trainer_epochs, "steps": len(losses),
                    "epoch_s": epoch_s,
                    "images_per_s_median": statistics.median(per_epoch),
                    "images_per_s_range": [min(per_epoch), max(per_epoch)],
                    "first_loss": losses[0], "last_loss": losses[-1],
                    "epoch_accuracy": epoch_acc, "loss_falls": falls}
    del trainer
    release_memory()
    s["model"] = "mnist_cnn"
    log("mnist_cnn", s)
    if not (s["ok"] and s["graphs"] == 1 and falls):
        raise SystemExit("mnist_cnn: captured differs from eager, the "
                         "graphs are not 1, or the loss did not fall: %s"
                         % {k: s[k] for k in ("same_bits",
                                              "state_not_bit_equal",
                                              "graphs")})
    mnist_cnn_print_check()
    return {"mnist_cnn": records["captured"],
            "mnist_cnn:eager": records["eager"]}


# ---------------------------------------------------------------------------
# the optimizers, schedules, ModelAverage and QAT on bench.py's MLP
# ---------------------------------------------------------------------------

OPT_STEPS, OPT_CHECK_STEPS = 20, 3


def _opt_configs():
    """{name: fn(pt, loss) appending the update ops}: the six dense
    optimizers, Momentum under each of five schedules and under
    ``append_LARS``, ModelAverage, and QAT (``abs_max`` / ``range_abs_max``
    activations; the rewrite is made before ``minimize`` by the builder).
    The rates keep 20 steps finite: DecayedAdagrad, RMSProp and Ftrl move
    each weight by about 4.5, 4.5 and 1 times the rate a step whatever the
    gradient's size (at 1e-2 and 1e-1 the MLP diverges in two steps)."""
    def momentum(lr):
        return lambda pt, loss: pt.optimizer.Momentum(
            learning_rate=lr(pt.layers), momentum=0.9).minimize(loss)

    def lars(pt, loss):
        params_grads = pt.backward.append_backward(loss)
        pt.layers.append_LARS(params_grads, 0.01, weight_decay=5e-4)
        pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9) \
            .apply_gradients(params_grads, loss)

    return {
        "adamax": lambda pt, loss: pt.optimizer.Adamax(1e-3).minimize(loss),
        "decayed_adagrad": lambda pt, loss: pt.optimizer.DecayedAdagrad(
            2e-4).minimize(loss),
        "adadelta": lambda pt, loss: pt.optimizer.Adadelta(
            1.0, rho=0.95).minimize(loss),
        "rmsprop": lambda pt, loss: pt.optimizer.RMSProp(1e-3).minimize(loss),
        "rmsprop_centered": lambda pt, loss: pt.optimizer.RMSProp(
            1e-4, momentum=0.9, centered=True).minimize(loss),
        "ftrl": lambda pt, loss: pt.optimizer.Ftrl(
            1e-3, l1=1e-4, l2=1e-4).minimize(loss),
        "exponential_staircase": momentum(
            lambda L: L.exponential_decay(0.05, 5, 0.5, staircase=True)),
        "natural_exp": momentum(lambda L: L.natural_exp_decay(0.05, 5, 0.5)),
        "inverse_time": momentum(
            lambda L: L.inverse_time_decay(0.05, 5, 0.5)),
        "polynomial_cycle": momentum(lambda L: L.polynomial_decay(
            0.05, 6, 1e-3, power=2.0, cycle=True)),
        "piecewise": momentum(
            lambda L: L.piecewise_decay([5, 10], [0.05, 0.01, 0.002])),
        "lars": lars,
        "model_average": lambda pt, loss: pt.optimizer.Momentum(
            0.05, momentum=0.9).minimize(loss),
        "qat_abs_max": lambda pt, loss: pt.optimizer.Momentum(
            0.05, momentum=0.9).minimize(loss),
        "qat_range_abs_max": lambda pt, loss: pt.optimizer.Momentum(
            0.05, momentum=0.9).minimize(loss),
    }


def build_opt_mlp(name):
    """bench.py's MLP (``mlp_train_func``, batch 256) under the optimizer
    ``name`` of ``_opt_configs``; (main, startup, loss, eval program,
    softmax, ModelAverage or None, QuantizeTranspiler or None).  The
    evaluation program is the forward, cloned before minimize."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import QuantizeTranspiler

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 4
    ma = qt = None
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss = mlp_train_func()[0]
        pred = [op for op in main.global_block().ops
                if op.type == "softmax"][-1].outputs["Out"][0]
        if name.startswith("qat_"):
            qt = QuantizeTranspiler(activation_quantize_type=name[4:])
            assert qt.training_transpile(main, startup) == 6
        test = main.clone(for_test=True)
        _opt_configs()[name](pt, loss)
        if name == "model_average":
            ma = pt.optimizer.ModelAverage(0.15, min_average_window=4,
                                           max_average_window=8)
            ma._ensure_accumulators(main)
    return main, startup, loss, test, pred, ma, qt


def _state_rel(card_scope, cpu_scope, names):
    out = {}
    for n in names:
        a = card_scope.var(n).detach().cpu().double()
        b = cpu_scope.var(n).detach().double()
        out[n] = float((a - b).norm() / b.norm().clamp_min(1e-30)) \
            if not torch.equal(a, b) else 0.0
    return out


def optimizers_phase(steps=OPT_STEPS, check_steps=OPT_CHECK_STEPS):
    """bench.py's MLP (784-256-256-10, batch 256; ``rand`` pixels and
    random labels) trained ``steps`` steps under each of ``_opt_configs``
    on ``CUDAPlace(0)``:

    * the first ``check_steps`` steps on the card (eager) against the
      CPU from one startup state, the CPU taking the card's ReLU
      decisions: each loss within rtol 1e-4, and every persistable tensor
      after them (parameters, moments, counters, running scales) within
      relative L2 1e-4 at the median and 1e-2 each (``train_check``'s
      band);
    * captured and eager from one startup state (``two_arm_run``): 3
      untimed steps each, ``steps`` - 3 timed ones in turns, the losses
      and every scope tensor the same bits; ms a step of each arm, a
      profiled step each; no hand kernel;
    * ModelAverage: the evaluation program run captured inside
      ``apply()`` gives the softmax of the averaged parameters, computed
      on the host from the sums (rtol 1e-5), and the parameters are the
      same bits after the block as before it;
    * QAT: the frozen program (``freeze_program``) captured = eager, its
      running scales unmoved.
    Returns {path: launch record} (``optimizers:<name>`` and ``:eager``)."""
    import paddle_tpu_torch as pt

    # random labels: no step saturates the loss to exactly 0, where a
    # zero gradient makes LARS's rate for a zero bias 0 / 0
    rng = np.random.RandomState(0)
    feeds = [{"img": rng.rand(MLP_BATCH, 784).astype("float32"),
              "label": rng.randint(0, 10, (MLP_BATCH, 1)).astype("int64")}
             for _ in range(steps)]
    paths, bad = {}, []
    for name in _opt_configs():
        main, startup, loss, test, pred, ma, qt = build_opt_mlp(name)
        start = started(startup)
        persist = [v.name for v in main.list_vars()
                   if v.persistable and start.find_var(v.name) is not None]
        # card against CPU
        card_scope, cpu_scope = copy_scope(start), pt.Scope()
        for n in start.local_var_names():
            cpu_scope.set_var(n, start.var(n).cpu().clone())
        card = pt.Executor(pt.CUDAPlace(0), capture=False)
        cpu = pt.Executor(pt.CPUPlace())
        fetch = [loss.name] + relu_inputs(main)
        losses = []
        for f in feeds[:check_steps]:
            got = card.run(main, feed=f, fetch_list=fetch, scope=card_scope)
            with relu_decisions(main, got[1:]):
                want = cpu.run(main, feed=f, fetch_list=fetch,
                               scope=cpu_scope)
            losses.append((float(got[0][0]), float(want[0][0])))
        rel = _state_rel(card_scope, cpu_scope, persist)
        med = statistics.median(rel.values())
        check_ok = all(abs(g - w) <= 1e-4 * abs(w) for g, w in losses) \
            and med <= 1e-4 and max(rel.values()) <= 1e-2
        del card_scope, cpu_scope
        # captured against eager
        cmp, records, runs = two_arm_run(main, start, [loss], feeds,
                                         steps - 3, MLP_BATCH, warm=3,
                                         deterministic=False)
        values = cmp["eager"]["values"]
        s = {"optimizer": name, "batch": MLP_BATCH, "steps": steps,
             "check_losses_card_cpu": losses, "check_rel_l2_median": med,
             "check_rel_l2_max": max(rel.values()),
             "check_worst": max(rel, key=rel.get), "check_ok": check_ok,
             "same_bits_captured_eager": cmp["same_bits"],
             "state_not_bit_equal": cmp["state_not_bit_equal"],
             "first_loss": values[0], "last_loss": values[-1]}
        for arm, rec in records.items():
            s[arm + "_ms_per_step"] = cmp[arm]["median_step_ms"]
            s[arm + "_ms_range"] = cmp[arm]["step_ms_range"]
            s[arm + "_busy_ms"] = rec["window"]["busy_ms"]
            s[arm + "_idle_share"] = rec["window"]["idle_share"]
            s[arm + "_device_events"] = rec["window"]["device_events"]
            paths["optimizers:%s%s" % (
                name, "" if arm == "captured" else ":eager")] = rec
        ok = check_ok and cmp["ok"]
        c = runs["captured"]
        if ma is not None:
            s["model_average"] = _model_average_check(
                ma, main, test, pred, c["exe"], c["scope"], feeds[0])
            ok = ok and s["model_average"]["ok"]
        if qt is not None:
            s["frozen"] = _qat_frozen_check(qt, main, pred, c["exe"],
                                            runs["eager"]["exe"],
                                            c["scope"], runs["eager"]["scope"],
                                            feeds[0])
            ok = ok and s["frozen"]["ok"]
        s["ok"] = ok
        log("optimizers", s)
        if not ok:
            bad.append(name)
        del runs, start
        release_memory()
    if bad:
        raise SystemExit("optimizers: card against CPU out of the band, or "
                         "captured differs from eager: %s" % bad)
    return paths


def _model_average_check(ma, main, test, pred, exe, scope, feed):
    """The evaluation program captured (two runs before the block), then
    run inside ``ma.apply``: its softmax against the float64 host forward
    of the averages computed from the scope's sums; the parameters the
    same bits after the block."""
    for _ in range(2):
        exe.run(test, feed=feed, fetch_list=[pred], scope=scope)
    params = [p.name for p in main.all_parameters()]
    before = {n: scope.var(n).clone() for n in params}
    avg = {}
    for n in params:
        s1, s2, s3, na, ona, _ = ma._avg_sums[n]
        total = sum(scope.var(a.name).double() for a in (s1, s2, s3))
        cnt = max(int(scope.var(na.name)[0]) + int(scope.var(ona.name)[0]),
                  1)
        avg[n] = (total / cnt).cpu()
    with ma.apply(exe, scope):
        (got,) = exe.run(test, feed=feed, fetch_list=[pred], scope=scope)
    restored = all(torch.equal(before[n], scope.var(n)) for n in params)
    h = torch.from_numpy(feed["img"]).double()
    ws = [p.name for p in main.all_parameters() if p.name.endswith(".w_0")]
    bs = [p.name for p in main.all_parameters() if p.name.endswith(".b_0")]
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = h @ avg[w] + avg[b]
        h = torch.relu(h) if i < len(ws) - 1 else torch.softmax(h, dim=1)
    err = float(np.abs(got - h.numpy()).max())
    ok = bool(np.allclose(got, h.numpy(), rtol=1e-5, atol=1e-6)) \
        and restored
    return {"max_abs_err_vs_host_average": err, "restored": restored,
            "captured_eval_entries": sum(
                st.graph is not None for st in exe._steps.values()),
            "ok": ok}


def _qat_frozen_check(qt, main, pred, exe_c, exe_e, scope_c, scope_e, feed):
    """``freeze_program``'s program captured and eager: the softmax the
    same bits in the two arms and finite, and the running scales unmoved
    by it."""
    frozen = qt.freeze_program(main, scope=scope_c)
    scales = [op.inputs["InScale"][0] for op in frozen.global_block().ops
              if op.type == "fake_quantize_range_abs_max"]
    before = {n: scope_c.var(n).clone() for n in scales}
    # the frozen program still holds the optimizer ops; evaluate on the
    # forward: prune to the softmax
    fwd = frozen.prune_feed_fetch(["img"], [pred])
    outs = [[exe.run(fwd, feed=feed, fetch_list=[pred], scope=sc)[0]
             for _ in range(3)] for exe, sc in ((exe_c, scope_c),
                                                (exe_e, scope_e))]
    same = all(a.tobytes() == b.tobytes() for a, b in zip(*outs))
    unmoved = all(torch.equal(before[n], scope_c.var(n)) for n in scales)
    return {"running_scales": len(scales), "same_bits": same,
            "scales_unmoved": unmoved,
            "ok": same and unmoved and bool(np.isfinite(outs[0][0]).all())}


# ---------------------------------------------------------------------------
# --profile: where a dispatch's time goes
# ---------------------------------------------------------------------------

def _union_us(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _profile_report(prof, window):
    """Per ``dispatch/<kind>`` range: host wall time, device busy time
    (union of kernel intervals inside it) and the device's idle share; the
    kernels and host ops that take the most time."""
    from torch.autograd import DeviceType

    events = prof.events()
    # device activity: kernels and copies; the dispatch/* ranges are also
    # mirrored onto the device timeline as annotations, which are not work
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("dispatch/")]
    kernels = [(e.time_range.start, e.time_range.end) for e in device]
    by_name = {}
    for e in device:
        d = by_name.setdefault(e.name[:70], [0.0, 0])
        d[0] += e.time_range.end - e.time_range.start
        d[1] += 1
    per_kind = {}
    for e in events:
        if e.device_type != DeviceType.CPU \
                or not e.name.startswith("dispatch/"):
            continue
        a, b = e.time_range.start, e.time_range.end
        busy = _union_us([(max(x, a), min(y, b)) for x, y in kernels
                          if y > a and x < b])
        d = per_kind.setdefault(e.name[len("dispatch/"):],
                                {"n": 0, "wall_us": 0.0, "busy_us": 0.0})
        d["n"] += 1
        d["wall_us"] += b - a
        d["busy_us"] += busy
    for d in per_kind.values():
        d["idle_share"] = 1.0 - d["busy_us"] / d["wall_us"]
        d["wall_ms_each"] = d["wall_us"] / d["n"] / 1e3
        d["busy_ms_each"] = d["busy_us"] / d["n"] / 1e3

    top_dev = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    # the port's own kernels (csrc/*.cu, all in anonymous namespaces),
    # whatever their rank
    port = {k: v for k, v in by_name.items()
            if k.startswith("void (anonymous namespace)::")
            and "at::" not in k}
    top_host = sorted(prof.key_averages(),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:15]
    log("profile", {
        "window": window, "kernel_events": len(kernels),
        "dispatch": per_kind,
        "top_device_us": [(k, us, n) for k, (us, n) in top_dev],
        "port_kernels_us": [(k, us, n) for k, (us, n) in sorted(
            port.items(), key=lambda kv: -kv[1][0])],
        "device_us": sum(us for us, _ in by_name.values()),
        "top_host_self_us": [(e.key[:70], e.self_cpu_time_total, e.count)
                             for e in top_host]})
    return per_kind


def profile_phase(place, model=MODEL, steps=20, prompt=400, bucket=512,
                  quantize=None):
    """torch.profiler over one prefill (every slot, ``prompt`` tokens in
    the ``bucket`` bucket) and ``steps`` decode steps of the serving
    slice (int8 weights with ``quantize``), each driven through
    ``Executor.run`` and fetched as the engine fetches it."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving import build_decoder_lm
    from torch.profiler import ProfilerActivity, profile, record_function

    spec = build_decoder_lm(**model)
    exe, scope = pt.Executor(place), pt.Scope()
    spec.init_scope(exe, scope)
    if quantize:
        spec = spec.quantize(scope, mode=quantize)
    s, v = spec.slots, model["vocab_size"]
    rng = np.random.RandomState(1)
    prefill = {"tok": rng.randint(0, v, (s, bucket, 1)).astype("int64"),
               "tok@LEN": np.full((s,), prompt, "int32"),
               "pos": np.broadcast_to(
                   np.arange(bucket, dtype="int64")[None, :, None],
                   (s, bucket, 1)).copy(),
               "slot": np.arange(s, dtype="int32"),
               "wpos": np.zeros((s,), "int32")}
    last = (torch.arange(s), torch.full((s,), prompt - 1))

    def decode(i):
        p = prompt + i
        return {"tok": rng.randint(0, v, (s, 1, 1)).astype("int64"),
                "pos": np.full((s, 1, 1), p, "int64"),
                "wpos": np.full((s,), p, "int32"),
                "cache_len": np.full((s,), p + 1, "int32")}

    def dispatch(kind, feed):
        prog, var, rows = ((spec.prefill_program, spec.prefill_logits, last)
                           if kind == "prefill" else
                           (spec.decode_program, spec.decode_logits,
                            (slice(None), 0)))
        with record_function("dispatch/" + kind):
            (out,) = exe.run(prog, feed=feed, fetch_list=[var], scope=scope,
                             return_numpy=False)
            out[rows].float().cpu()

    with torch.inference_mode():
        dispatch("prefill", prefill)
        for i in range(2):
            dispatch("decode", decode(i))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dispatch("prefill", prefill)
            for i in range(steps):
                dispatch("decode", decode(i))
            torch.cuda.synchronize()
    _profile_report(prof, "1 prefill (%d x %d, bucket %d) + %d decode steps"
                    ", quantize=%s" % (s, prompt, bucket, steps, quantize))


def _profile_steps(place, program, startup, loss, feeds, warm, window):
    """torch.profiler over the steps of ``feeds[warm:]``, after ``warm``
    untimed steps (the second of which captures the step), each fetched
    as the train phases fetch it."""
    import paddle_tpu_torch as pt
    from torch.profiler import ProfilerActivity, profile, record_function

    exe, scope = pt.Executor(place), pt.Scope()
    exe.run(startup, scope=scope)
    for f in feeds[:warm]:
        exe.run(program, feed=f, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for f in feeds[warm:]:
            with record_function("dispatch/train_step"):
                exe.run(program, feed=f, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
    _profile_report(prof, window)


def train_profile_phase(place, steps=2, batch=TRAIN_BATCH, amp=False):
    """torch.profiler over ``steps`` replayed training steps of the train
    phase's program (under ``amp``, ``train_amp``'s)."""
    main, startup, cost = build_train(0.1, amp)
    rng = np.random.RandomState(2)
    feeds = [train_feed(rng, batch) for _ in range(steps + 2)]
    _profile_steps(place, main, startup, cost, feeds, 2,
                   "%d training steps%s, batch %d x %d" % (
                       steps, " (AMP)" if amp else "", batch, TRAIN_SEQ))


def resnet_profile_phase(place, steps=2, batch=RESNET_BATCH, amp=False):
    """torch.profiler over ``steps`` replayed steps of each ResNet-50
    program of ``resnet_train`` (under ``amp``: ``resnet_amp``'s), with
    cuDNN's deterministic algorithms as those phases run."""
    rng = np.random.RandomState(0)
    feeds = [resnet_feed(rng, batch) for _ in range(steps + 2)]
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mode in RESNET_MODES:
            main, startup, loss = build_resnet(mode, amp)
            _profile_steps(place, main, startup, loss, feeds, 2,
                           "%d ResNet-50 %s steps%s, batch %d" % (
                               steps, mode, " (AMP)" if amp else "", batch))
            release_memory()
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)


# ---------------------------------------------------------------------------
# phase 21: bench.py's RNN rungs
# ---------------------------------------------------------------------------

# bench.py's two RNN rungs (``bench.py:1852-1929``): batch, words a
# sequence (full length), dictionary size, Adam's learning rate; 512 wide
RNN = {"stacked_lstm": (64, 80, 5147, 1e-3),
       "machine_translation": (64, 30, 30000, 1e-4)}
RNN_WIDTH = 512
# ``rnn_check``'s configuration, the CPU tests' size: ragged lengths in
# [2, seq]
RNN_SMALL = dict(batch=4, seq=7, dict_dim=50, width=32)
RNN_STEPS = 8
# the length feed that ``rnn_check``'s planted fault shortens
RNN_LEN = {"stacked_lstm": "word@LEN", "machine_translation": "src@LEN"}


def build_rnn(name, amp=False, small=False):
    """bench.py's ``stacked_lstm`` (3 layers, the second reversed) or
    ``machine_translation`` (bi-LSTM encoder, ``DynamicRNN`` attention
    decoder) program through the port, seed 1, Adam at bench's rate, under
    ``decorate`` with ``amp``; at ``RNN_SMALL``'s widths with ``small``.
    Returns (main, startup, [loss])."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import (machine_translation,
                                         stacked_dynamic_lstm)

    dict_dim, lr = RNN[name][2:]
    width = RNN_WIDTH
    if small:
        dict_dim, width = RNN_SMALL["dict_dim"], RNN_SMALL["width"]
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 1
    with pt.program_guard(main, startup), pt.unique_name.guard():
        if name == "stacked_lstm":
            word = pt.layers.data("word", shape=[1], dtype="int64",
                                  lod_level=1)
            label = pt.layers.data("label", shape=[1], dtype="int64")
            pred = stacked_dynamic_lstm.stacked_lstm_net(
                word, dict_dim, emb_dim=width, hid_dim=width)
            loss = pt.layers.mean(pt.layers.cross_entropy(pred, label))
        else:
            src, tgt, lbl = (pt.layers.data(n, shape=[1], dtype="int64",
                                            lod_level=1)
                             for n in ("src", "tgt", "lbl"))
            loss, _ = machine_translation.seq_to_seq_net(
                src, tgt, lbl, dict_dim, dict_dim, width, width, width)
        opt = pt.optimizer.Adam(learning_rate=lr)
        if amp:
            opt = mixed_precision.decorate(opt)
        opt.minimize(loss)
    return main, startup, [loss]


def rnn_feeds(name, n, small=False, seed=0):
    """bench.py's feeds, drawn in its order from ``RandomState(seed)``:
    random ids (MT: from 1) at full length, the LSTM's 2-way labels; with
    ``small``, ``RNN_SMALL``'s shape and ragged lengths in [2, seq]."""
    batch, seq, dict_dim = RNN[name][:3]
    if small:
        batch, seq, dict_dim = (RNN_SMALL[k] for k in
                                ("batch", "seq", "dict_dim"))
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if name == "stacked_lstm":
            ids = rng.randint(0, dict_dim, (batch, seq, 1)).astype("int64")
            lens = (rng.randint(2, seq + 1, batch) if small
                    else np.full(batch, seq)).astype("int32")
            out.append({"word": ids, "word@LEN": lens,
                        "label": rng.randint(0, 2, (batch, 1))
                        .astype("int64")})
            continue
        f = {}
        lens = (rng.randint(2, seq + 1, batch) if small
                else np.full(batch, seq)).astype("int32")
        for n_ in ("src", "tgt", "lbl"):
            f[n_] = rng.randint(1, dict_dim, (batch, seq, 1)).astype("int64")
            f[n_ + "@LEN"] = lens
        out.append(f)
    return out


def max_pools(program):
    """The ``sequence_pool`` ops of ``program`` that take the maximum."""
    return [op for op in program.global_block().ops
            if op.type == "sequence_pool"
            and op.attrs.get("pooltype") == "MAX"]


@contextlib.contextmanager
def max_decisions(program, card_index):
    """While open, each max ``sequence_pool`` of ``program`` pools the
    steps the card picked (``card_index``: {MaxIndex name: the card's
    fetch}) instead of its own argmax, the analogue of ``relu_decisions``
    for the LSTM's max pools: where two steps' values lie within float32
    rounding of each other, the two devices may pick different ones, and
    the gradient then flows to different steps.  Yields {op index: the
    units whose own argmax differed from the card's}."""
    from paddle_tpu_torch import registry

    keep = {i: torch.from_numpy(card_index[op.outputs["MaxIndex"][0]])
            .long() for i, op in enumerate(program.global_block().ops)
            if op in max_pools(program)}
    pool = registry.get_op_def("sequence_pool")
    plain = pool.compute
    flips = {}

    def compute(ins, attrs, ctx, op_index):
        out = plain(ins, attrs, ctx, op_index)
        if op_index not in keep:
            return out
        x, length = ins["X"][0], ins["Length"][0]
        idx = keep[op_index].to(x.device)
        flips[op_index] = int((out["MaxIndex"].long() != idx).sum())
        picked = torch.take_along_dim(x, idx.unsqueeze(1), dim=1).squeeze(1)
        nonempty = (length > 0).reshape((-1,) + (1,) * (x.dim() - 2))
        return {"Out": torch.where(nonempty, picked, 0),
                "MaxIndex": idx.to(torch.int32)}

    pool.compute = compute
    try:
        yield flips
    finally:
        pool.compute = plain


def rnn_check(name, fault=None):
    """One Adam step of ``build_rnn(name, small=True)`` on a ragged batch,
    float32, on ``CUDAPlace(0)`` and on ``CPUPlace()`` from one startup
    state, at ``train_check``'s band: the losses within rtol 1e-4, the
    parameters' gradients within relative L2 1e-4 at the median and 1e-2
    for each; the step moved every parameter.  The CPU takes the card's
    max-pool decisions (``max_decisions``; the units that decided
    otherwise are counted).  ``fault="length"`` feeds the card the
    ``RNN_LEN`` lengths one short: the check must fail, and the phase
    returns its summary instead of raising."""
    import paddle_tpu_torch as pt

    assert fault in (None, "length")
    main, startup, (loss,) = build_rnn(name, small=True)
    params = [p.name for p in main.all_parameters() if p.trainable]
    card_scope, cpu_scope = pt.Scope(), pt.Scope()
    card = pt.Executor(pt.CUDAPlace(0))
    card.run(startup, scope=card_scope)
    for n in card_scope.local_var_names():
        cpu_scope.set_var(n, card_scope.var(n).cpu().clone())
    before = {n: cpu_scope.var(n).clone() for n in params}
    feed = rnn_feeds(name, 1, small=True, seed=5)[0]
    card_feed = dict(feed)
    if fault:
        card_feed[RNN_LEN[name]] = np.maximum(feed[RNN_LEN[name]] - 1,
                                              1).astype("int32")
    idx_names = [op.outputs["MaxIndex"][0] for op in max_pools(main)]
    fetch = [loss.name] + [n + "@GRAD" for n in params] + idx_names
    k = 1 + len(params)
    got = card.run(main, feed=card_feed, fetch_list=fetch, scope=card_scope)
    with max_decisions(main, dict(zip(idx_names, got[k:]))) as flips:
        want = pt.Executor(pt.CPUPlace()).run(main, feed=feed,
                                              fetch_list=fetch,
                                              scope=cpu_scope)
    finite = all(np.isfinite(a).all() for a in got[:k])
    got, want = got[:k], want[:k]
    loss_within = bool(np.all(np.abs(got[0] - want[0])
                              <= 1e-4 * np.abs(want[0])))
    rel = _grad_rel_l2(params, got[1:], want[1:])
    ranked = sorted(rel, key=rel.get, reverse=True)
    med = statistics.median(rel.values())
    moved = sum(not torch.equal(before[n], card_scope.var(n).cpu())
                for n in params)
    within = bool(finite and loss_within and med <= 1e-4
                  and rel[ranked[0]] <= 1e-2)
    summary = {"model": name, "fault": fault, "config": RNN_SMALL,
               "lengths": feed[RNN_LEN[name]].tolist(),
               "loss_card": float(got[0][0]), "loss_cpu": float(want[0][0]),
               "params": len(params), "moved": moved,
               "grad_rel_l2_top5": [[n, rel[n]] for n in ranked[:5]],
               "grad_rel_l2_median": med,
               "max_pools": len(idx_names),
               "max_decisions_taken_from_card": sum(flips.values()),
               "within": within}
    log("rnn_fault_length" if fault else "rnn_check", summary)
    if fault:
        return summary
    if not within or moved != len(params):
        raise SystemExit("rnn_check: card and CPU disagree on %s: %s"
                         % (name, summary))
    return summary


def rnn_checks():
    """``rnn_check`` on both models, and on both with the planted fault,
    which it must catch."""
    caught = {}
    for name in RNN:
        rnn_check(name)
        caught[name] = not rnn_check(name, fault="length")["within"]
    if not all(caught.values()):
        raise SystemExit("rnn_check passed a planted fault: %s" % caught)


def rnn_phase(steps=RNN_STEPS):
    """bench.py's ``stacked_lstm`` (batch 64 x 80 words, dict 5147, 512
    wide, 3 layers) and ``machine_translation`` (64 x 30 tokens, dicts
    30000, 512 wide) rungs on ``CUDAPlace(0)``, float32 and under
    ``decorate`` (bench's ``--amp``), each captured and eager from one
    startup state (``two_arm_run``, ``steps`` timed steps in turns): the
    same bits, words/s (batch x seq / the median step), wall and busy ms
    a step and idle share of a profiled step, its top device events,
    peak memory, the captured executor's entries and graphs, and the
    capture's seconds (the captured arm's second run: capture and first
    replay).  Launches are exact (``launch_faults``): #5 twice and #6
    once a machine-translation step (its loss), none in the LSTM.
    Returns {path: launch record}."""
    paths, bad = {}, []
    for name in RNN:
        batch, seq = RNN[name][:2]
        for amp in (False, True):
            t0 = time.perf_counter()
            main, startup, fetch = build_rnn(name, amp)
            need = {k: n for k, n in kernel_launches_per_step(main).items()
                    if n}
            s, records, runs = two_arm_run(
                main, started(startup), fetch, rnn_feeds(name, steps + 3),
                steps, batch, need=need, deterministic=False)
            exe = runs["captured"]["exe"]
            for arm in ("captured", "eager"):
                a, w = s[arm], s[arm]["profiled_step"]
                a.update(words_per_s=batch * seq / a["median_step_ms"] * 1e3,
                         wall_ms=w["wall_ms"], busy_ms=w["busy_ms"],
                         idle_share=w["idle_share"],
                         top_device_us=w["top_device_us"])
            s["captured"]["capture_s"] = s["captured"]["first_ms"][1] / 1e3
            s.update(model=name, dtype="amp_bf16" if amp else "float32",
                     words=batch * seq, entries=len(exe._steps),
                     graphs=sum(st.graph is not None
                                for st in exe._steps.values()),
                     seconds=time.perf_counter() - t0)
            log("rnn", s)
            path = "rnn:%s%s" % (name, "_amp" if amp else "")
            paths[path] = records["captured"]
            paths[path + ":eager"] = records["eager"]
            if not s["ok"] or s["graphs"] != 1:
                bad.append(path)
            del runs, exe
            release_memory()
    if bad:
        raise SystemExit("rnn: captured steps differ from eager, or an "
                         "entry is not one graph: %s" % bad)
    return paths


# ---------------------------------------------------------------------------
# phase 25: the control-flow and sequence slice's op types
# ---------------------------------------------------------------------------

SEQ = (64, 30, 512)           # machine translation's batch, length, width


def _seq_lengths(rng, b, t):
    lens = rng.randint(1, t + 1, b).astype("int32")
    lens[3] = 0
    lens[:2] = t
    return lens


def _seq_batch(rng, b, t, d, lens):
    x = rng.randn(b, t, d).astype("float32")
    x[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    return x


def _beam_ties(rng, b, k, v):
    """``beam_search`` inputs with exact ties: half the rows have finished
    beams (their other candidates at -1e9 + score, absorbed into -1e9),
    the rest take the -1e9 lane penalty on every beam but one, and beams
    carry equal log-prob rows."""
    pre_ids = rng.randint(1, v, (b, k)).astype("int64")
    pre_ids[: b // 2, :2] = 0
    pre_scores = -rng.rand(b, k).astype("float32")
    pre_scores[b // 2:, 1:] = -1e9
    logp = np.log(rng.dirichlet(np.ones(v), size=(b, k)).astype("float32")
                  + 1e-30).astype("float32")
    logp[:, 1] = logp[:, 0]
    return {"PreIds": pre_ids, "PreScores": pre_scores, "Scores": logp}


def _seq_op_cases():
    """(op type, inputs, attrs, {output slot: vars}, differentiated slots)
    of the 29 one-op types of the slice at machine translation's shapes."""
    rng = np.random.RandomState(0)
    b, t, d = SEQ
    lens = _seq_lengths(rng, b, t)
    lens2 = _seq_lengths(rng, b, t)
    x = _seq_batch(rng, b, t, d, lens)
    x2 = _seq_batch(rng, b, t, d, lens2)
    ids = rng.randint(0, 8, (b, t)).astype("int64")
    table = np.stack([np.argsort(-lens, kind="stable"),
                      np.sort(lens)[::-1]], 1).astype("int64")
    scatter_ids = rng.randint(-40, 36, (b, t, 1)).astype("int64")
    one = {"Out": 1}
    two = {"Out": 1, "OutLength": 1}
    return [
        ("sequence_mask", {"X": lens}, {"maxlen": t, "out_dtype": "float32"},
         {"Y": 1}, ()),
        ("sequence_concat", {"X": [x, x2], "Length": [lens, lens2]}, {},
         two, ("X",)),
        ("sequence_conv", {"X": x, "Filter": rng.randn(3 * d, d).astype(
            "float32") * 0.05, "Length": lens},
         {"contextLength": 3, "contextStart": -1}, one, ("X", "Filter")),
        ("row_conv", {"X": x, "Filter": rng.randn(3, d).astype("float32"),
                      "Length": lens}, {}, one, ("X", "Filter")),
        ("sequence_erase", {"X": ids, "Length": lens}, {"tokens": [2, 5]},
         two, ()),
        ("sequence_enumerate", {"X": ids, "Length": lens},
         {"win_size": 3, "pad_value": 0}, one, ()),
        ("sequence_slice", {"X": x, "Offset": rng.randint(
            0, 10, (b, 1)).astype("int64"), "Size": rng.randint(
            0, 20, (b, 1)).astype("int64"), "Length": lens}, {}, two,
         ("X",)),
        ("sequence_reverse", {"X": x, "Length": lens}, {}, one, ("X",)),
        ("causal_mask", {"Ref": x}, {"mask_value": -1e9,
                                     "dtype": "float32"}, one, ()),
        ("padding_attn_bias", {"Length": lens, "Ref": x},
         {"mask_value": -1e9, "dtype": "float32"}, one, ()),
        ("sequence_pad", {"X": x, "Length": lens, "PadValue": np.asarray(
            [-1.5], "float32")}, {"padded_length": 40},
         {"Out": 1, "SeqLength": 1}, ("X",)),
        ("sequence_unpad", {"X": rng.randn(b, t, d).astype("float32"),
                            "Length": lens}, {}, two, ("X",)),
        ("sequence_reshape", {"X": x, "Length": lens}, {"new_dim": d // 2},
         two, ("X",)),
        ("sequence_expand_as", {"X": rng.randn(b, d).astype("float32"),
                                "Y": x, "YLength": lens}, {}, two, ("X",)),
        ("sequence_scatter", {"X": rng.randn(b, 32).astype("float32"),
                              "Ids": scatter_ids,
                              "Updates": rng.randn(b, t, 1)
                              .astype("float32"), "Length": lens}, {}, one,
         ("X", "Updates")),
        ("im2sequence", {"X": rng.randn(16, 3, 32, 32).astype("float32")},
         {"kernels": [3, 3], "strides": [2, 2], "paddings": [1, 1, 1, 1]},
         two, ("X",)),
        ("lod_reset", {"X": x, "Y": np.concatenate(
            [[0], np.cumsum(lens2)]).astype("int64")}, {},
         {"Out": 1, "Length": 1}, ("X",)),
        ("lod_rank_table", {"Length": lens}, {}, one, ()),
        ("max_sequence_len", {"RankTable": table}, {}, one, ()),
        ("reorder_lod_tensor_by_rank", {"X": x, "RankTable": table}, {},
         two, ("X",)),
        ("lod_tensor_to_array", {"X": x, "RankTable": table}, {}, two,
         ("X",)),
        ("array_to_lod_tensor", {"X": rng.randn(t, b, d).astype("float32"),
                                 "RankTable": table}, {}, two, ("X",)),
        ("array_write", {"X": rng.randn(16, 4, d).astype("float32"),
                         "I": np.asarray([7], "int64"),
                         "Array": rng.randn(t, 16, 4, d).astype("float32")},
         {}, one, ("X", "Array")),
        ("array_read", {"Array": rng.randn(t, 16, 4, d).astype("float32"),
                        "I": np.asarray([-2], "int64")}, {}, one,
         ("Array",)),
        ("lod_array_length", {"X": rng.randn(t, 16, 4).astype("float32")},
         {}, one, ()),
        ("split_lod_tensor", {"X": rng.randn(b, d).astype("float32"),
                              "Mask": rng.rand(b, 1) > 0.5}, {},
         {"OutTrue": 1, "OutFalse": 1}, ("X",)),
        ("merge_lod_tensor", {"Mask": rng.rand(b, 1) > 0.5,
                              "InTrue": rng.randn(b, d).astype("float32"),
                              "InFalse": rng.randn(b, d).astype("float32")},
         {}, one, ("InTrue", "InFalse")),
        ("beam_search", _beam_ties(rng, 16, 4, 30000),
         {"beam_size": 4, "end_id": 0},
         {"SelectedIds": 1, "SelectedScores": 1, "ParentIdx": 1}, ()),
        ("beam_search_decode", {
            "Ids": rng.randint(0, 30000, (30, 16, 4)).astype("int64"),
            "Parents": rng.randint(0, 4, (30, 16, 4)).astype("int64"),
            "Scores": rng.randn(16, 4).astype("float32")},
         {"beam_size": 4, "end_id": 0},
         {"SentenceIds": 1, "SentenceScores": 1}, ()),
    ]


def _seq_compare(card, host, n, summed=False):
    """(errors, within): outputs ``[:n]`` exact where integer or bool,
    else within rtol 1e-5 / atol 1e-6 (with ``summed``, outputs of
    512-term products, whose values near 0 carry the sums' rounding:
    within relative L2 1e-5); the gradients after them within relative L2
    1e-5."""
    errs, ok = {}, True
    for i, (c, h) in enumerate(zip(card, host)):
        if i >= n or (summed and c.dtype.kind == "f"):
            den = max(float(np.linalg.norm(h)), 1e-30)
            e = float(np.linalg.norm(c.astype(np.float64) - h)) / den
            within = e <= PLAIN_GRAD and bool(np.isfinite(c).all())
        elif c.dtype.kind in "biu":
            e = "same bits" if np.array_equal(c, h) else "differ"
            within = c.dtype == h.dtype and e == "same bits"
        else:
            e, within = _plain_compare("float", c, h)
        errs["out%d" % i if i < n else "grad%d" % (i - n)] = e
        ok = ok and within
    return errs, ok


def _loop_program(kind):
    """(main, startup, fetch, feeds) of a program holding a ``while``
    (``kind`` "while": unbounded, y <- tanh(fc(y)) over [64, 512] for n
    trips; "while_bounded": the same bounded at 8, with the gradient of
    sum(y^2) to x and the fc weight) or a ``conditional_block`` (y =
    tanh(fc(x)) where the fed flag is set, with the same gradient; two
    feeds, taken and not)."""
    import paddle_tpu_torch as pt

    L = pt.layers
    b, d = SEQ[0], SEQ[2]
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 3
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = L.data("x", shape=[d])
        x.stop_gradient = False
        y = L.scale(x, scale=1.0)
        fc = dict(size=d, act="tanh", param_attr=pt.ParamAttr(name="cf_w"),
                  bias_attr=pt.ParamAttr(name="cf_b"))
        if kind == "cond_block":
            flag = L.data("flag", shape=[1], dtype="bool",
                          append_batch_size=False)
            with L.ConditionalBlock([flag]).block():
                L.assign(L.fc(x, **fc), output=y)
        else:
            n = L.data("n", shape=[1], dtype="int64", append_batch_size=False)
            i = L.fill_constant(shape=[1], dtype="int64", value=0)
            cond = L.less_than(i, n)
            loop = L.While(cond, max_trip_count=8 if kind == "while_bounded"
                           else None)
            with loop.block():
                L.assign(L.fc(y, **fc), output=y)
                L.increment(i, value=1)
                L.less_than(i, n, cond=cond)
        fetch = [y]
        if kind != "while":
            (gx, gw) = pt.backward.calc_gradient(
                L.reduce_sum(L.square(y)),
                [x, main.global_block().var("cf_w")])
            fetch += [gx, gw]
    rng = np.random.RandomState(4)
    xv = rng.randn(b, d).astype("float32")
    if kind == "cond_block":
        feeds = [{"x": xv, "flag": np.asarray([v])} for v in (True, False)]
    else:
        feeds = [{"x": xv, "n": np.asarray([5], "int64")}]
    return main, startup, fetch, feeds


def _loop_checks():
    """The ``while`` and ``conditional_block`` programs, card (captured:
    eager, then a capture and its replay) against the CPU from one
    startup state."""
    import paddle_tpu_torch as pt

    rows, bad = [], []
    for kind in ("while", "while_bounded", "cond_block"):
        main, startup, fetch, feeds = _loop_program(kind)
        start = started(startup)
        exe = pt.Executor(pt.CUDAPlace(0))
        scope = copy_scope(start)
        host = pt.Executor(pt.CPUPlace())
        host_scope = copy_scope(start, "cpu")
        for f in feeds:
            first = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
            card = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
            trips = list(exe.loop_trips)
            want = host.run(main, feed=f, fetch_list=fetch,
                            scope=host_scope)
            repeat = all(np.array_equal(a, c) for a, c in zip(first, card))
            errs, ok = _seq_compare(card, want, 1, summed=True)
            # one graph a run of ops and one body graph a loop
            graphs = [st.graphs for st in exe._steps.values()]
            plans = [len(a[-1]) for a in exe._analysis.values()]
            ok = ok and trips == host.loop_trips and graphs == plans
            row = {"op": "while" if kind.startswith("while") else
                   "conditional_block", "program": kind,
                   "feed": {k: v.tolist() for k, v in f.items()
                            if k != "x"}, "errors": errs,
                   "captured_repeats_eager": repeat, "trips": trips,
                   "graphs": graphs, "segments": plans,
                   "ok": ok and repeat}
            rows.append(row)
            if not row["ok"]:
                bad.append(kind)
        del exe, scope
        release_memory()
    return rows, bad


def _nested_loop_check():
    """An unbounded ``while`` in a ``while`` body: a capturing executor
    on the card refuses the entry, naming the inner op; ``capture=False``
    runs it, equal to the CPU."""
    import paddle_tpu_torch as pt

    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = L.data("x", shape=[8])
        y = L.scale(x, scale=1.0)
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        n = L.fill_constant(shape=[1], dtype="int64", value=3)
        cond = L.less_than(i, n)
        outer = L.While(cond)
        with outer.block():
            j = L.fill_constant(shape=[1], dtype="int64", value=0)
            two = L.fill_constant(shape=[1], dtype="int64", value=2)
            c2 = L.less_than(j, two)
            inner = L.While(c2)
            with inner.block():
                L.assign(L.scale(y, scale=1.5, bias=0.25), output=y)
                L.increment(j, value=1)
                L.less_than(j, two, cond=c2)
            L.increment(i, value=1)
            L.less_than(i, n, cond=cond)
    feed = {"x": np.random.RandomState(5).randn(4, 8).astype("float32")}
    try:
        pt.Executor(pt.CUDAPlace(0)).run(main, feed=feed, fetch_list=[y])
        refused = None
    except RuntimeError as e:
        refused = str(e)
    (eager,) = pt.Executor(pt.CUDAPlace(0), capture=False).run(
        main, feed=feed, fetch_list=[y])
    (host,) = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=[y])
    ok = bool(refused and "inside op" in refused) and np.allclose(
        eager, host, rtol=1e-5, atol=1e-6)
    return {"refused_under_capture": refused, "eager_equals_cpu": bool(
        np.allclose(eager, host, rtol=1e-5, atol=1e-6)), "ok": ok}


def seq_ops_phase():
    """Phase 25: each of the 31 op types of the control-flow and sequence
    slice, card against CPU (``_seq_op_cases``, ``_loop_checks``), and
    the nested loop's refusal (``_nested_loop_check``).  Raises on a
    fault."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda

    cuda.reset_launch_counts()
    rows, bad, types = [], [], set()
    for op_type, inputs, attrs, outputs, diff in _seq_op_cases():
        t0 = time.perf_counter()
        (first, card), n = _one_op_run(pt.CUDAPlace(0), op_type, inputs,
                                       attrs, outputs, diff, runs=2)
        card_s = time.perf_counter() - t0
        repeat = all(np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
                     for a, b in zip(first, card))
        (host,), _ = _one_op_run(pt.CPUPlace(), op_type, inputs, attrs,
                                 outputs, diff)
        errs, ok = _seq_compare(card, host, n)
        rows.append({"op": op_type, "errors": errs,
                     "captured_repeats_eager": repeat, "ok": ok and repeat,
                     "card_s": card_s})
        types.add(op_type)
        if not (ok and repeat):
            bad.append(op_type)
    loop_rows, loop_bad = _loop_checks()
    rows += loop_rows
    bad += loop_bad
    types.update(r["op"] for r in loop_rows)
    nested = _nested_loop_check()
    if not nested["ok"]:
        bad.append("nested_while")
    launches = {k: v for k, v in cuda.launch_counts().items() if v}
    summary = {"types": len(types), "cases": rows, "nested_while": nested,
               "hand_kernel_launches": launches,
               "ok": not bad and not launches and len(types) == 31}
    log("seq_ops", summary)
    if not summary["ok"]:
        raise SystemExit("seq_ops: the card differs from the CPU, a replay "
                         "from the eager run, or a case is missing: %s %s "
                         "(%d types)" % (bad, launches, len(types)))
    return summary


# ---------------------------------------------------------------------------
# phase 26: beam-search decoding at machine translation's width
# ---------------------------------------------------------------------------

# bench.py's machine_translation rung's dictionaries and width
# (bench.py:1898-1900), the contrib decoder's beam and length
BEAM = dict(dict_dim=30000, word_dim=512, hidden=512, src_len=30, beam=4,
            max_len=30, end_id=0)
BEAM_BATCH, BEAM_CHECK_BATCH = 16, 4
BEAM_END_BIAS = 50.0
BEAM_DECODES = 5


def build_beam_decoder(pkg, dict_dim, word_dim, hidden, src_len, beam,
                       max_len, end_id, seed=1):
    """``tests/test_contrib_decoder.py``'s attention decoder built through
    ``pkg`` (``paddle_tpu_torch``; the CPU tests build it through the JAX
    package too): an embedding and a ``DynamicRNN`` tanh-fc encoder over
    ``src`` [B, src_len]; a ``StateCell`` whose state h updates by
    dot-product attention over the encoder states tiled across the beams
    and a tanh fc; ``BeamSearchDecoder(...).decode()``, an unbounded
    ``While`` of at most ``max_len`` trips that stops when every beam has
    emitted ``end_id``.  The score fc's bias is ``score_b``.  Returns
    (main, startup, [sentence ids [B, beam, max_len], scores [B, beam]])."""
    import importlib

    dec = importlib.import_module(pkg.__name__ + ".contrib.decoder")
    L, P = pkg.layers, pkg.ParamAttr
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        src = L.data("src", shape=[1], dtype="int64", lod_level=1)
        emb = L.embedding(src, size=[dict_dim, word_dim],
                          param_attr=P(name="src_emb"))
        drnn = L.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(emb)
            hp = drnn.memory(shape=[hidden], value=0.0)
            h = L.fc(L.concat([x_t, hp], axis=1), size=hidden, act="tanh",
                     param_attr=P(name="enc_w"), bias_attr=P(name="enc_b"))
            drnn.update_memory(hp, h)
            drnn.output(h)
        enc_seq = drnn()
        enc_last = L.sequence_pool(enc_seq, "last")

        def attend(cell):
            x = cell.get_input("x")                  # [B*K, word_dim]
            ctx_seq = cell.get_input("enc")          # [B*K, src_len, hidden]
            h_pre = cell.get_state("h")              # [B*K, hidden]
            att = L.matmul(ctx_seq, L.unsqueeze(h_pre, axes=[2]))
            w = L.softmax(L.reshape(att, shape=[-1, src_len]))
            ctx = L.reshape(L.matmul(L.unsqueeze(w, axes=[1]), ctx_seq),
                            shape=[-1, hidden])
            cell.set_state("h", L.fc(
                L.concat([x, h_pre, ctx], axis=1), size=hidden, act="tanh",
                param_attr=P(name="dec_w"), bias_attr=P(name="dec_b")))

        cell = dec.StateCell(inputs={"x": None, "enc": None},
                             states={"h": dec.InitState(init=enc_last)},
                             out_state="h")
        cell.state_updater(attend)
        ids0 = L.fill_constant_batch_size_like(enc_last, shape=[-1, 1],
                                               dtype="int64", value=1)
        sc0 = L.fill_constant_batch_size_like(enc_last, shape=[-1, 1],
                                              dtype="float32", value=0.0)
        decoder = dec.BeamSearchDecoder(
            cell, ids0, sc0, target_dict_dim=dict_dim, word_dim=word_dim,
            input_var_dict={"enc": enc_seq}, max_len=max_len,
            beam_size=beam, end_id=end_id, emb_param_attr=P(name="tgt_emb"),
            score_param_attr=P(name="score_w"),
            score_bias_attr=P(name="score_b"))
        decoder.decode()
        sent, scores = decoder()
    return main, startup, [sent, scores]


def beam_feed(batch, src_len, dict_dim, seed=0):
    """``batch`` sentences of ``src_len`` ids in [2, dict_dim)."""
    rng = np.random.RandomState(seed)
    return {"src": rng.randint(2, dict_dim, (batch, src_len, 1))
            .astype("int64"),
            "src@LEN": np.full(batch, src_len, "int32")}


@contextlib.contextmanager
def beam_gaps():
    """While open, each ``beam_search`` op records, a row, the least gap
    between consecutive scores among its K + 1 best candidates (where a
    device's rounding could swap two choices); yields the list of the
    steps' [B] gaps."""
    from paddle_tpu_torch import registry
    from paddle_tpu_torch.ops.control_flow import beam_candidates

    d = registry.get_op_def("beam_search")
    plain, gaps = d.compute, []

    def compute(ins, attrs, ctx, op_index):
        out = plain(ins, attrs, ctx, op_index)
        k = ins["Scores"][0].shape[1]
        top = torch.topk(beam_candidates(
            ins["PreIds"][0], ins["PreScores"][0], ins["Scores"][0],
            attrs["end_id"]), k + 1, dim=1).values
        gaps.append((top[:, :-1] - top[:, 1:]).min(dim=1).values.numpy())
        return out

    d.compute = compute
    try:
        yield gaps
    finally:
        d.compute = plain


def _beam_partings(card, host, gaps):
    """Sentences whose ids part between card and CPU, each with the least
    candidate gap of its steps on the CPU, and whether every parting lies
    under ``PARTING_GAP``."""
    least = np.min(np.stack(gaps), axis=0) if gaps else None
    parts = [[b, float(least[b])] for b in range(card.shape[0])
             if not np.array_equal(card[b], host[b])]
    return parts, all(g < PARTING_GAP for _, g in parts)


def beam_check(start, main, fetch):
    """Card (eager) = CPU at ``BEAM_CHECK_BATCH`` sentences, both weight
    settings, from the card's startup state."""
    import paddle_tpu_torch as pt

    feed = beam_feed(BEAM_CHECK_BATCH, BEAM["src_len"], BEAM["dict_dim"],
                     seed=1)
    card_scope, host_scope = copy_scope(start), copy_scope(start, "cpu")
    card, host = pt.Executor(pt.CUDAPlace(0), capture=False), \
        pt.Executor(pt.CPUPlace())
    out, ok = {}, True
    for setting, bias in _beam_biases(start).items():
        card_scope.var("score_b").copy_(bias)
        host_scope.var("score_b").copy_(bias.cpu())
        c = card.run(main, feed=feed, fetch_list=fetch, scope=card_scope)
        c_trips = list(card.loop_trips)
        with beam_gaps() as gaps:
            h = host.run(main, feed=feed, fetch_list=fetch, scope=host_scope)
        parts, allowed = _beam_partings(c[0], h[0], gaps)
        same = [b for b in range(c[0].shape[0])
                if np.array_equal(c[0][b], h[0][b])]
        scores_ok = bool(np.allclose(c[1][same], h[1][same], rtol=1e-4))
        out[setting] = {"trips_card": c_trips, "trips_cpu": host.loop_trips,
                        "partings": parts, "scores_rtol_1e-4": scores_ok,
                        "least_gap": float(np.min(np.stack(gaps))),
                        "max_abs_score_diff": float(
                            np.abs(c[1][same] - h[1][same]).max())
                        if same else None}
        ok = ok and allowed and scores_ok
    out["ok"] = ok
    return out


def _beam_biases(start):
    """The score bias of the two weight settings: as drawn, and raised by
    ``BEAM_END_BIAS`` at ``end_id``."""
    bias = start.var("score_b")
    end = bias.clone()
    end[BEAM["end_id"]] += BEAM_END_BIAS
    return {"random": bias.clone(), "end": end}


def beam_phase(decodes=BEAM_DECODES):
    """Phase 26: the beam decoder at ``BEAM``'s width on
    ``BEAM_BATCH`` sentences, captured and eager, each arm running both
    weight settings in one entry (the bias copied into the scope's tensor
    in place before each decode); ``decodes`` timed decodes of each in
    turns.  Returns {path: launch record}."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda

    t_start = time.perf_counter()
    main, startup, fetch = build_beam_decoder(pt, **BEAM)
    start = started(startup)
    check = beam_check(start, main, fetch)
    log("beam_check", check)
    feed = beam_feed(BEAM_BATCH, BEAM["src_len"], BEAM["dict_dim"])
    biases = _beam_biases(start)
    arms = {arm: dict(exe=pt.Executor(pt.CUDAPlace(0),
                                      capture=arm == "captured"),
                      scope=copy_scope(start), runs=[], peak=0, first=[])
            for arm in ("captured", "eager")}

    def decode(r, setting):
        r["scope"].var("score_b").copy_(biases[setting])
        exe = r["exe"]
        reads = exe.flag_reads
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=r["scope"])
        dt = time.perf_counter() - t0
        r["peak"] = max(r["peak"], torch.cuda.max_memory_allocated())
        trips = sum(n for _, n in exe.loop_trips)
        return dict(setting=setting, out=out, s=dt, trips=trips,
                    reads=exe.flag_reads - reads)

    for arm, r in arms.items():
        for setting in ("random", "end"):      # the capture: the second
            r["first"].append(decode(r, setting))
    launches = {}
    for i in range(decodes):
        for arm in (("eager", "captured") if i % 2 else
                    ("captured", "eager")):
            for setting in ("random", "end"):
                cuda.reset_launch_counts()
                arms[arm]["runs"].append(decode(arms[arm], setting))
                for k, n in cuda.launch_counts().items():
                    launches[k] = launches.get(k, 0) + n
    windows = {arm: device_window(lambda r=r: decode(r, "random"),
                                  again=True) for arm, r in arms.items()}
    c_runs, e_runs = arms["captured"]["runs"], arms["eager"]["runs"]
    same = all(a["setting"] == b["setting"] and a["trips"] == b["trips"]
               and all(x.tobytes() == y.tobytes()
                       for x, y in zip(a["out"], b["out"]))
               for a, b in zip(c_runs + arms["captured"]["first"],
                               e_runs + arms["eager"]["first"]))
    reads_ok = all(r["reads"] == r["trips"]
                   for a in arms.values() for r in a["runs"] + a["first"])
    exe = arms["captured"]["exe"]
    # ops / loop / ops: a graph each
    graphs = [st.graphs for st in exe._steps.values()]
    segments = [len(a[-1]) for a in exe._analysis.values()]
    summary = {"config": dict(BEAM, batch=BEAM_BATCH),
               "end_bias": BEAM_END_BIAS, "decodes": decodes,
               "same_bits": same, "flag_reads_equal_trips": reads_ok,
               "entries": len(exe._steps), "graphs": graphs,
               "segments": segments,
               "hand_kernel_launches": {k: n for k, n in launches.items()
                                        if n}}
    k = BEAM["beam"]
    for arm, r in arms.items():
        summary[arm] = {}
        for setting in ("random", "end"):
            runs = [x for x in r["runs"] if x["setting"] == setting]
            ms = statistics.median(x["s"] for x in runs) * 1e3
            trips = runs[0]["trips"]
            out = runs[-1]["out"]
            summary[arm][setting] = {
                "trips": trips, "median_ms_per_decode": ms,
                "ms_per_decode": [x["s"] * 1e3 for x in runs],
                "ms_per_trip": ms / trips,
                "sentences_per_s": BEAM_BATCH / ms * 1e3,
                "beam_tokens_per_s": BEAM_BATCH * k * trips / ms * 1e3,
                "finite": bool(np.isfinite(out[1]).all()),
                "ids_in_range": bool(((out[0] >= 0)
                                      & (out[0] < BEAM["dict_dim"])).all()),
                "top_sentence_0": out[0][0, 0].tolist()}
        w = windows[arm]
        summary[arm].update(
            first_ms=[x["s"] * 1e3 for x in r["first"]],
            peak_mem_gb=r["peak"] / 1e9, profiled_decode={
                key: w[key] for key in ("wall_ms", "busy_ms", "idle_share",
                                        "device_events", "top_device_us",
                                        "trace_launches")})
    summary["captured"]["capture_s"] = arms["captured"]["first"][1]["s"]
    rand_trips = summary["captured"]["random"]["trips"]
    end_trips = summary["captured"]["end"]["trips"]
    summary["seconds"] = time.perf_counter() - t_start
    summary["ok"] = bool(
        same and reads_ok and check["ok"] and graphs == segments == [3]
        and not summary["hand_kernel_launches"]
        and rand_trips == BEAM["max_len"] and end_trips < rand_trips
        and all(summary[a][s]["finite"] and summary[a][s]["ids_in_range"]
                for a in arms for s in ("random", "end")))
    log("beam", summary)
    if not summary["ok"]:
        raise SystemExit("beam: captured differs from eager, the card from "
                         "the CPU, or the loop ran other than planned: %s"
                         % {k_: summary[k_] for k_ in (
                             "same_bits", "flag_reads_equal_trips", "graphs",
                             "hand_kernel_launches")})
    need = {}
    return {"beam": launch_record(True, launches, need, windows["captured"],
                                  need),
            "beam:eager": launch_record(False, {}, need, windows["eager"],
                                        need)}


# ---------------------------------------------------------------------------
# phase 27: the Paddle book's label_semantic_roles, trained
# ---------------------------------------------------------------------------

# the book's db_lstm at its width (word_dim 32, mark_dim 5, hidden 512,
# depth 8, SGD on exponential_decay(0.01, 100000, 0.5, staircase), the CRF
# transition at mix_hidden_lr 1e-3) over CoNLL-05's vocabularies; 59 tags
# (IOB over 29 chunk types and O); the book's batch of 10, padded to 64
SRL = dict(word_dict=44068, pred_dict=3162, mark_dict=2, word_dim=32,
           mark_dim=5, hidden=512, depth=8, labels=59)
SRL_BATCH, SRL_CHECK_BATCH, SRL_LEN, SRL_MIN_LEN = 10, 4, 64, 5
SRL_STEPS, SRL_FALL_STEPS, SRL_EVAL_BATCHES = 20, 50, 5
SRL_FEATURES = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2",
                "predicate", "mark")


def build_srl(pkg, word_dict, pred_dict, mark_dict, word_dim, mark_dim,
              hidden, depth, labels, lr=0.01, seed=1):
    """The book's label_semantic_roles (``tests/test_label_semantic_roles.py``
    ``_db_lstm``'s topology) through ``pkg`` (``paddle_tpu_torch``; the CPU
    tests build it through the JAX package too): six word features share
    the frozen embedding ``emb``, the predicate has ``vemb``, the mark its
    own; each feature through an fc of ``hidden`` with tanh, summed, a
    ``dynamic_lstm`` (relu candidate, sigmoid gates and cell) and
    ``depth`` - 1 more, alternating direction, each fed by the sum of two
    tanh fcs of the level below's input and output; ``feature_out`` the sum
    of two tanh fcs to ``labels``; the cost ``linear_chain_crf`` (``crfw``
    at learning rate 1e-3, the book's mix_hidden_lr) then ``mean``; SGD on
    ``exponential_decay(lr, 100000, 0.5, staircase=True)``.  The Viterbi
    decoding shares ``crfw``: ``infer`` is the train program pruned to it,
    ``evaluate`` that program with a ``ChunkEvaluator`` (IOB, (labels - 1)
    / 2 chunk types) of the paths against ``target``.  Returns (main,
    startup, infer, evaluate, {"cost": .., "path": .., "evaluator": ..})."""
    L, P = pkg.layers, pkg.ParamAttr
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        feats = {n: L.data(n, shape=[1], dtype="int64", lod_level=1)
                 for n in SRL_FEATURES}
        target = L.data("target", shape=[1], dtype="int64", lod_level=1)
        length = feats["word"]._seq_len_name
        embs = [L.embedding(feats[n], size=[word_dict, word_dim],
                            param_attr=P(name="emb", trainable=False))
                for n in SRL_FEATURES[:6]]
        embs.append(L.embedding(feats["predicate"],
                                size=[pred_dict, word_dim],
                                param_attr=P(name="vemb")))
        embs.append(L.embedding(feats["mark"], size=[mark_dict, mark_dim]))

        def mixed(xs, size):
            out = L.sums([L.fc(x, size=size, num_flatten_dims=2, act="tanh")
                          for x in xs])
            out._seq_len_name = length
            return out

        hidden_0 = mixed(embs, hidden)
        lstm, _ = L.dynamic_lstm(hidden_0, size=hidden,
                                 candidate_activation="relu",
                                 gate_activation="sigmoid",
                                 cell_activation="sigmoid")
        below = [hidden_0, lstm]
        for i in range(1, depth):
            mix = mixed(below, hidden)
            lstm, _ = L.dynamic_lstm(mix, size=hidden,
                                     candidate_activation="relu",
                                     gate_activation="sigmoid",
                                     cell_activation="sigmoid",
                                     is_reverse=i % 2 == 1)
            below = [mix, lstm]
        feature_out = mixed(below, labels)
        cost = L.linear_chain_crf(feature_out, target, param_attr=P(
            name="crfw", learning_rate=1e-3))
        avg_cost = L.mean(cost)
        path = L.crf_decoding(feature_out, param_attr=P(name="crfw"))
        feed_names = list(SRL_FEATURES) + [n + "@LEN" for n in SRL_FEATURES]
        infer = main.clone(for_test=True).prune_feed_fetch(feed_names,
                                                           [path.name])
        evaluate = infer.clone(for_test=True)
        with pkg.program_guard(evaluate, pkg.Program()):
            block = evaluate.global_block()
            tgt = L.data("target", shape=[1], dtype="int64", lod_level=1)
            evaluator = pkg.evaluator.ChunkEvaluator(
                block.var(path.name), tgt, "IOB", (labels - 1) // 2,
                seq_length=block.var(length))
        pkg.optimizer.SGD(learning_rate=L.exponential_decay(
            learning_rate=lr, decay_steps=100000, decay_rate=0.5,
            staircase=True)).minimize(avg_cost)
    return main, startup, infer, evaluate, dict(
        cost=avg_cost, path=path, evaluator=evaluator)


def srl_feeds(n, batch, max_len, word_dict, pred_dict, mark_dict, labels,
              min_len=SRL_MIN_LEN, seed=0, **_):
    """``n`` batches drawn from ``RandomState(seed)``: lengths in
    [min_len, max_len], random ids of each feature, and the JAX test's
    learnable target (word + mark) mod labels."""
    rng = np.random.RandomState(seed)
    out = []
    vocab = [word_dict] * 6 + [pred_dict, mark_dict]
    for _ in range(n):
        lens = rng.randint(min_len, max_len + 1, batch).astype("int32")
        f = {}
        for name, v in zip(SRL_FEATURES, vocab):
            f[name] = rng.randint(0, v, (batch, max_len, 1)).astype("int64")
            f[name + "@LEN"] = lens
        f["target"] = (f["word"] + f["mark"]) % labels
        f["target@LEN"] = lens
        out.append(f)
    return out


def srl_infer_feed(feed):
    return {k: v for k, v in feed.items() if not k.startswith("target")}


def numpy_chunk_counts(paths, target, lens, num_chunk_types):
    """(inferred, labelled, correct) IOB chunks of ``paths`` against
    ``target`` ([B, T(, 1)] tags, O = 2 * num_chunk_types), counted by
    walking each sequence: a chunk is (type, start, end)."""
    def chunks(tags):
        out, cur = set(), None
        for i, t in enumerate(list(tags) + [2 * num_chunk_types]):
            t = int(t)
            other = t >= 2 * num_chunk_types
            typ, inside = t // 2, t % 2 == 1
            if cur is not None and (other or not inside or typ != cur[0]):
                out.add((cur[0], cur[1], i - 1))
                cur = None
            if not other and cur is None:
                cur = (typ, i)
        return out

    n_inf = n_lab = n_cor = 0
    for b, ln in enumerate(lens):
        a = chunks(np.asarray(paths[b]).reshape(-1)[:ln])
        g = chunks(np.asarray(target[b]).reshape(-1)[:ln])
        n_inf, n_lab, n_cor = n_inf + len(a), n_lab + len(g), \
            n_cor + len(a & g)
    return n_inf, n_lab, n_cor


# ---------------------------------------------------------------------------
# phase 28: the SSD300 head at VOC width
# ---------------------------------------------------------------------------

# SSD300's six feature maps (channels, side): VGG's conv4_3 and fc7 and
# the four extra layers; VOC's 21 classes; the paper's scale schedule
SSD_MAPS = ((512, 38), (1024, 19), (512, 10), (256, 5), (256, 3), (256, 1))
SSD = dict(maps=SSD_MAPS, image_size=300, num_classes=21, base_size=300,
           min_ratio=20, max_ratio=90,
           aspect_ratios=((2.0,), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0),
                          (2.0,), (2.0,)), max_gt=16)
SSD_NMS = dict(score_threshold=0.01, nms_top_k=400, nms_threshold=0.45,
               keep_top_k=200)
SSD_BATCH, SSD_CHECK_BATCH, SSD_STEPS, SSD_MAP_BATCHES = 32, 2, 5, 3


def build_ssd(pkg, maps, image_size, num_classes, base_size, min_ratio,
              max_ratio, aspect_ratios, max_gt, lr=1e-3, seed=1):
    """The SSD head (``tests/test_multi_box_head.py``'s ``multi_box_head``
    over fed feature maps ``f0``.. of ``maps``' (channels, side), 3x3
    convolutions, flip) and its training and inference programs through
    ``pkg``: ``ssd_loss`` against ``gt_box`` [B, max_gt, 4] / ``gt_label``
    [B, max_gt, 1] (zero-area rows pad), summed, and a Momentum(lr, 0.9)
    step; ``infer`` (the forward pruned before the loss) decodes the
    locations on the priors (``box_coder``), takes the softmax and runs
    ``multiclass_nms`` (``SSD_NMS``) into an 11-point ``DetectionMAP``
    (overlap 0.5) against the ground truth and ``gt_difficult``.  Returns
    (main, startup, infer, {"loss", "nms", "map", "evaluator", "head"})."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        feats = [L.data("f%d" % i, shape=[c, s, s])
                 for i, (c, s) in enumerate(maps)]
        image = L.data("image", shape=[3, image_size, image_size])
        gt_box = L.data("gt_box", shape=[max_gt, 4])
        gt_label = L.data("gt_label", shape=[max_gt, 1], dtype="int64")
        difficult = L.data("gt_difficult", shape=[max_gt, 1], dtype="int64")
        loc, conf, box, var = L.multi_box_head(
            feats, image, base_size=base_size, num_classes=num_classes,
            aspect_ratios=[list(a) for a in aspect_ratios],
            min_ratio=min_ratio, max_ratio=max_ratio, flip=True,
            kernel_size=3, pad=1)
        decoded = L.box_coder(box, var, loc, code_type="decode_center_size")
        scores = L.transpose(L.softmax(conf), perm=[0, 2, 1])
        nms = L.multiclass_nms(decoded, scores, **SSD_NMS)
        evaluator = pkg.evaluator.DetectionMAP(
            nms, gt_label, gt_box, difficult, class_num=num_classes,
            overlap_threshold=0.5, evaluate_difficult=False,
            ap_version="11point")
        cur_map, _ = evaluator.get_map_var()
        feed_names = ["f%d" % i for i in range(len(maps))] + [
            "image", "gt_box", "gt_label", "gt_difficult"]
        infer = main.clone(for_test=True).prune_feed_fetch(
            feed_names, [nms.name, cur_map.name])
        loss = L.reduce_sum(L.ssd_loss(loc, conf, gt_box, gt_label, box,
                                       var))
        pkg.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
    return main, startup, infer, dict(loss=loss, nms=nms, map=cur_map,
                                      evaluator=evaluator,
                                      head=[loc, conf, box, var])


def ssd_feeds(n, batch, maps, image_size, num_classes, max_gt, seed=0,
              **_):
    """``n`` batches from ``RandomState(seed)``: feature maps of normal
    values, one zero image (the priors read its size), 1..max_gt ground
    truths an image with labels 1..num_classes - 1 (a sixth difficult)
    and zero-area padding rows, label 0."""
    rng = np.random.RandomState(seed)
    image = np.zeros((1, 3, image_size, image_size), "float32")
    out = []
    for _ in range(n):
        f = {"f%d" % i: rng.randn(batch, c, s, s).astype("float32")
             for i, (c, s) in enumerate(maps)}
        n_gt = rng.randint(1, max_gt + 1, batch)
        xy = rng.rand(batch, max_gt, 2) * 0.7
        wh = 0.05 + rng.rand(batch, max_gt, 2) * 0.3
        box = np.concatenate([xy, xy + wh], -1).astype("float32")
        lbl = rng.randint(1, num_classes, (batch, max_gt, 1))
        diff = (rng.rand(batch, max_gt, 1) < 1 / 6).astype("int64")
        pad = np.arange(max_gt)[None, :] >= n_gt[:, None]
        box[pad] = 0.0
        lbl[pad] = 0
        diff[pad] = 0
        f.update(image=image, gt_box=box, gt_label=lbl.astype("int64"),
                 gt_difficult=diff)
        out.append(f)
    return out


# the loss after SRL_FALL_STEPS captured steps on one batch must be under
# SRL_FALL of the first: at the book's SGD rate (0.01) the full-width
# program falls from 136.58 to 126.45 (0.926) in 50 steps on the CPU
SRL_FALL = 0.95


def srl_check(start, main, cost, batch=SRL_CHECK_BATCH):
    """One SGD step of ``build_srl`` at ``SRL``'s width on ``batch``
    sequences, on ``CUDAPlace(0)`` and on ``CPUPlace()`` from one state
    (``start``), at ``train_check``'s band: the losses within rtol 1e-4,
    the trained parameters' gradients within relative L2 1e-4 at the
    median and 1e-2 each; the step moved every trained parameter."""
    import paddle_tpu_torch as pt

    params = [p.name for p in main.all_parameters() if p.trainable]
    card_scope, cpu_scope = copy_scope(start), copy_scope(start, "cpu")
    before = {n: cpu_scope.var(n).clone() for n in params}
    (feed,) = srl_feeds(1, batch, SRL_LEN, seed=5, **SRL)
    fetch = [cost.name] + [n + "@GRAD" for n in params]
    got = pt.Executor(pt.CUDAPlace(0), capture=False).run(
        main, feed=feed, fetch_list=fetch, scope=card_scope)
    want = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                         scope=cpu_scope)
    rel = _grad_rel_l2(params, got[1:], want[1:])
    ranked = sorted(rel, key=rel.get, reverse=True)
    med = statistics.median(rel.values())
    moved = sum(not torch.equal(before[n], card_scope.var(n).cpu())
                for n in params)
    loss_within = bool(abs(got[0][0] - want[0][0])
                       <= 1e-4 * abs(want[0][0]))
    summary = {"batch": batch, "lengths": feed["word@LEN"].tolist(),
               "loss_card": float(got[0][0]), "loss_cpu": float(want[0][0]),
               "params": len(params), "moved": moved,
               "grad_rel_l2_median": med,
               "grad_rel_l2_top5": [[n, rel[n]] for n in ranked[:5]],
               "finite": all(bool(np.isfinite(a).all()) for a in got)}
    summary["ok"] = bool(summary["finite"] and loss_within and med <= 1e-4
                         and rel[ranked[0]] <= 1e-2
                         and moved == len(params))
    return summary


def srl_decode_checks(scope, infer, evaluate, path, evaluator):
    """The pruned decoding program captured on the card (its second run a
    replay) against ``CPUPlace()`` at ``SRL_CHECK_BATCH`` from ``scope``'s
    state: the paths equal, and the replay repeats the eager bits; then
    the ``ChunkEvaluator`` program over ``SRL_EVAL_BATCHES`` batches of
    ``SRL_BATCH``, captured, its counts accumulating in the scope on the
    card: the counts equal a numpy walk of the fetched paths, and
    precision, recall and F1 the ratios of those counts."""
    import paddle_tpu_torch as pt

    (feed,) = srl_feeds(1, SRL_CHECK_BATCH, SRL_LEN, seed=6, **SRL)
    card = pt.Executor(pt.CUDAPlace(0))
    runs = [card.run(infer, feed=srl_infer_feed(feed), fetch_list=[path],
                     scope=scope)[0] for _ in range(2)]
    host = pt.Executor(pt.CPUPlace()).run(
        infer, feed=srl_infer_feed(feed), fetch_list=[path],
        scope=copy_scope(scope, "cpu"))[0]
    out = {"paths_equal_cpu": bool(np.array_equal(runs[1], host)),
           "replay_repeats_eager": bool(np.array_equal(runs[0], runs[1])),
           "differing_positions": int((runs[1] != host).sum())}
    feeds = srl_feeds(SRL_EVAL_BATCHES, SRL_BATCH, SRL_LEN, seed=7, **SRL)
    with pt.scope_guard(scope):
        evaluator.reset(card)
        paths = [card.run(evaluate, feed=f, fetch_list=[path])[0]
                 for f in feeds]
        counts = [int(np.asarray(v).ravel()[0])
                  for v in evaluator._fetch_states(card)]
        prf = [float(v[0]) for v in evaluator.eval(card)]
    types = (SRL["labels"] - 1) // 2
    want = np.sum([numpy_chunk_counts(p, f["target"], f["word@LEN"], types)
                   for p, f in zip(paths, feeds)], axis=0).tolist()
    n_inf, n_lab, n_cor = want
    p = n_cor / n_inf if n_inf else 0.0
    r = n_cor / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if n_cor else 0.0
    out.update(chunk_counts=counts, numpy_counts=want,
               precision_recall_f1=prf, numpy_prf=[p, r, f1],
               counts_on_device=all(
                   scope.var(s.name).device.type == "cuda"
                   for s in evaluator.states))
    out["ok"] = bool(out["paths_equal_cpu"] and out["replay_repeats_eager"]
                     and counts == want and out["counts_on_device"]
                     and np.allclose(prf, [p, r, f1], rtol=1e-6))
    return out


def srl_phase(steps=SRL_STEPS, fall_steps=SRL_FALL_STEPS):
    """Phase 27: ``build_srl`` at ``SRL``'s width on ``CUDAPlace(0)``,
    float32, TF32 off.  ``srl_check`` (card against CPU at batch 4); then
    the train step captured and eager (``two_arm_run``, ``steps`` timed
    steps in turns over ``SRL_BATCH`` x ``SRL_LEN`` batches of lengths in
    [5, 64]): the same bits, ms a step, real tokens/s (the lengths' sum
    over the median step), one profiled step's idle share and top device
    events, capture seconds, peak memory, one graph; ``fall_steps``
    captured steps on one batch from the start state, the loss under
    ``SRL_FALL`` of the first; ``srl_decode_checks`` on the trained
    state.  No hand kernel is on the path.  Returns {path: launch
    record}."""
    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    main, startup, infer, evaluate, v = build_srl(pt, **SRL)
    start = started(startup)
    check = srl_check(start, main, v["cost"])
    log("srl_check", check)
    feeds = srl_feeds(steps + 3, SRL_BATCH, SRL_LEN, **SRL)
    need = {k: n for k, n in kernel_launches_per_step(main).items() if n}
    s, records, runs = two_arm_run(main, start, [v["cost"]], feeds, steps,
                                   SRL_BATCH, need=need, deterministic=False)
    exe = runs["captured"]["exe"]
    tokens = statistics.mean(int(f["word@LEN"].sum())
                             for f in feeds[2:steps + 2])
    for arm in ("captured", "eager"):
        a, w = s[arm], s[arm]["profiled_step"]
        a.update(real_tokens_per_s=tokens / a["median_step_ms"] * 1e3,
                 wall_ms=w["wall_ms"], busy_ms=w["busy_ms"],
                 idle_share=w["idle_share"], top_device_us=w["top_device_us"])
    s["captured"]["capture_s"] = s["captured"]["first_ms"][1] / 1e3
    s.update(config=dict(SRL, batch=SRL_BATCH, max_len=SRL_LEN,
                         min_len=SRL_MIN_LEN, optimizer="SGD(exponential_"
                         "decay(0.01, 100000, 0.5, staircase))"),
             mean_real_tokens=tokens, entries=len(exe._steps),
             graphs=sum(st.graph is not None for st in exe._steps.values()))
    fall_scope = copy_scope(start)
    fall = [float(exe.run(main, feed=feeds[0], fetch_list=[v["cost"]],
                          scope=fall_scope)[0][0])
            for _ in range(fall_steps)]
    s["fall"] = {"steps": fall_steps, "first": fall[0], "last": fall[-1],
                 "ratio": fall[-1] / fall[0], "gate": SRL_FALL,
                 "losses": fall[::5]}
    decode = srl_decode_checks(fall_scope, infer, evaluate, v["path"],
                               v["evaluator"])
    log("srl_decode", decode)
    s["seconds"] = time.perf_counter() - t0
    s["ok"] = bool(s["ok"] and s["graphs"] == 1 and check["ok"]
                   and decode["ok"] and fall[-1] < SRL_FALL * fall[0])
    log("srl", s)
    if not s["ok"]:
        raise SystemExit("srl: captured differs from eager, the card from "
                         "the CPU, the loss did not fall or the decoding "
                         "disagrees: %s" % {k: s[k] for k in (
                             "same_bits", "graphs", "fall")})
    del runs, exe
    release_memory()
    return {"srl": records["captured"], "srl:eager": records["eager"]}


# the outputs of ssd_loss's matching that the card must give bit for bit
# (target_assign's encoded location targets within rtol 1e-5)
SSD_MATCHING = {"bipartite_match": ("ColToRowMatchIndices",
                                     "ColToRowMatchDist"),
                "target_assign": ("Out", "OutWeight"),
                "mine_hard_examples": ("NegIndices", "NegCount",
                                       "UpdatedMatchIndices")}


def _ssd_intermediates(main):
    """The names of ``ssd_loss``'s matching, assignment and mining
    outputs in ``main``."""
    return [op.outputs[slot][0] for op in main.global_block().ops
            for slot in SSD_MATCHING.get(op.type, ())]


def ssd_check(start, main, infer, v, batch=SSD_CHECK_BATCH):
    """One Momentum step of ``build_ssd`` at ``SSD``'s width on ``batch``
    images, eager on ``CUDAPlace(0)`` and on ``CPUPlace()`` from one state:
    ``bipartite_match``'s, ``mine_hard_examples``' and the index and
    weight outputs of ``target_assign`` equal (its encoded location
    targets, ``box_coder``'s logs, within rtol 1e-5), the loss within
    rtol 1e-4, the head's gradients within relative L2 1e-4 at the median
    and 1e-2 each.  Then the inference program from the stepped state:
    the NMS counts and classes equal, its boxes and scores (decoded with
    ``exp`` on each device) within rtol 1e-5, the batch mAP equal; and
    ``multiclass_nms`` on the CPU, fed the card's own decoded boxes and
    scores, gives the card's rows bit for bit."""
    import paddle_tpu_torch as pt

    params = sorted(p.name for p in main.all_parameters())
    inter = _ssd_intermediates(main)
    (neg_count,) = [op.outputs["NegCount"][0]
                    for op in main.global_block().ops
                    if op.type == "mine_hard_examples"]
    card_scope, cpu_scope = copy_scope(start), copy_scope(start, "cpu")
    feed, test = ssd_feeds(2, batch, seed=5, **SSD)
    fetch = [v["loss"].name] + [n + "@GRAD" for n in params] + inter
    card = pt.Executor(pt.CUDAPlace(0), capture=False)
    host = pt.Executor(pt.CPUPlace())
    got = card.run(main, feed=feed, fetch_list=fetch, scope=card_scope)
    want = host.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    k = 1 + len(params)
    rel = _grad_rel_l2(params, got[1:k], want[1:k])
    med = statistics.median(rel.values())
    differ = {}
    for n, a, b in zip(inter, got[k:], want[k:]):
        if a.dtype.kind == "f" and a.shape[-1] == 4:   # encoded targets
            e, ok = _plain_compare("float", a, b)
        else:
            e, ok = ("same bits", True) if np.array_equal(a, b) else \
                ("differ", False)
        if not ok:
            differ[n] = e
    (nms_op,) = [op for op in infer.global_block().ops
                 if op.type == "multiclass_nms"]
    ifetch = [v["nms"].name, v["nms"]._seq_len_name, v["map"].name,
              nms_op.inputs["BBoxes"][0], nms_op.inputs["Scores"][0]]
    gi = card.run(infer, feed=test, fetch_list=ifetch, scope=card_scope)
    wi = host.run(infer, feed=test, fetch_list=ifetch, scope=cpu_scope)
    (alone,), _ = _one_op_run(pt.CPUPlace(), "multiclass_nms",
                              {"BBoxes": gi[3], "Scores": gi[4]}, SSD_NMS,
                              {"Out": 1, "OutLength": 1}, ())
    box_err, box_ok = _plain_compare("float", gi[0][..., 1:], wi[0][..., 1:])
    summary = {
        "batch": batch, "priors": int(got[k].shape[-1]),
        "loss_card": float(got[0][0]), "loss_cpu": float(want[0][0]),
        "grad_rel_l2_median": med, "grad_rel_l2_max": max(rel.values()),
        "matching_outputs": len(inter), "matching_differ": differ,
        "neg_count": got[k + inter.index(neg_count)].tolist(),
        "nms_count_card": gi[1].tolist(), "nms_count_cpu": wi[1].tolist(),
        "nms_classes_equal": bool(np.array_equal(gi[0][..., 0],
                                                 wi[0][..., 0])),
        "nms_rows_differing": int((gi[0] != wi[0]).any(-1).sum()),
        "nms_box_score_max_abs": box_err,
        "nms_alone_on_card_inputs_same_bits": bool(
            np.array_equal(alone[0], gi[0]) and np.array_equal(alone[1],
                                                              gi[1])),
        "map_card": float(gi[2][0]), "map_cpu": float(wi[2][0])}
    summary["ok"] = bool(
        abs(got[0][0] - want[0][0]) <= 1e-4 * abs(want[0][0])
        and med <= 1e-4 and max(rel.values()) <= 1e-2 and not differ
        and np.array_equal(gi[1], wi[1]) and int(gi[1].sum()) > 0
        and summary["nms_classes_equal"] and box_ok
        and summary["nms_alone_on_card_inputs_same_bits"]
        and summary["map_card"] == summary["map_cpu"])
    return summary


def ssd_phase(steps=SSD_STEPS):
    """Phase 28: ``build_ssd`` at ``SSD``'s width (8732 priors, 21
    classes) on ``SSD_BATCH`` images, float32, under deterministic
    algorithms (the head's convolutions).  ``ssd_check`` (card against CPU
    at batch 2); the training step captured and eager (``two_arm_run``,
    ``steps`` timed steps in turns; its ``softmax_with_cross_entropy``
    launches #5 twice and #6 once a step, the generic grad rerunning the
    forward) fetching the loss and every gradient; the inference program
    (decode, softmax, ``multiclass_nms``, the batch mAP) captured and
    eager the same way, its NMS rows and counts the same bits; the NMS
    op alone (a one-op program on the inference's own decoded boxes and
    scores, captured) for its share of the inference batch;
    ``DetectionMAP`` over ``SSD_MAP_BATCHES`` batches.  Returns {path:
    launch record}."""
    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    main, startup, infer, v = build_ssd(pt, **SSD)
    start = started(startup)
    check = ssd_check(start, main, infer, v)
    log("ssd_check", check)
    params = sorted(p.name for p in main.all_parameters())
    # the feature maps stand in for a backbone's output: staged on the card
    # once, so a step times the head and not ~150 MB of host copies
    feeds = [{k: torch.from_numpy(a).cuda() for k, a in f.items()}
             for f in ssd_feeds(steps + 3, SSD_BATCH, **SSD)]
    need = {k: n for k, n in kernel_launches_per_step(main).items() if n}
    out, paths = {"check": check["ok"]}, {}
    train, records, runs = two_arm_run(
        main, start, [v["loss"]] + [n + "@GRAD" for n in params], feeds,
        steps, SSD_BATCH, need=need)
    trained = runs["captured"]["scope"]
    paths["ssd"], paths["ssd:eager"] = records["captured"], records["eager"]
    ifetch = [v["nms"], v["nms"]._seq_len_name, v["map"]]
    infer_s, irecords, iruns = two_arm_run(infer, trained, ifetch, feeds,
                                           steps, SSD_BATCH)
    paths["ssd_infer"] = irecords["captured"]
    paths["ssd_infer:eager"] = irecords["eager"]
    for s, what in ((train, "step"), (infer_s, "batch")):
        for arm in ("captured", "eager"):
            a, w = s[arm], s[arm]["profiled_step"]
            a.update(wall_ms=w["wall_ms"], busy_ms=w["busy_ms"],
                     idle_share=w["idle_share"],
                     top_device_us=w["top_device_us"])
            a["ms_per_" + what] = a["median_step_ms"]
        s["captured"]["capture_s"] = s["captured"]["first_ms"][1] / 1e3
        exe = (runs if s is train else iruns)["captured"]["exe"]
        s["graphs"] = sum(st.graph is not None for st in exe._steps.values())
    # the NMS op alone on the inference's own decoded boxes and scores
    (nms_op,) = [op for op in infer.global_block().ops
                 if op.type == "multiclass_nms"]
    dec, sc = iruns["captured"]["exe"].run(
        infer, feed=feeds[-1], fetch_list=[nms_op.inputs["BBoxes"][0],
                                           nms_op.inputs["Scores"][0]],
        scope=trained, return_numpy=False)
    nms = _captured_op_ms("multiclass_nms", {"BBoxes": dec, "Scores": sc},
                          dict(SSD_NMS), {"Out": 1, "OutLength": 1})
    # DetectionMAP over SSD_MAP_BATCHES batches, captured
    ev = v["evaluator"]
    ev.reset()
    exe = iruns["captured"]["exe"]
    for f in feeds[:SSD_MAP_BATCHES]:
        ev.update(exe.run(infer, feed=f, fetch_list=[v["map"]],
                          scope=trained)[0])
    out.update(
        config=dict(SSD, batch=SSD_BATCH, nms=SSD_NMS, priors=8732,
                    optimizer="Momentum(1e-3, 0.9)"),
        train=train, infer=infer_s, nms_alone=nms,
        nms_share_of_infer_device=nms["device_ms"] / infer_s["captured"][
            "busy_ms"],
        map_batches=SSD_MAP_BATCHES, map_per_batch=list(ev._maps),
        map=float(ev.eval()[0]), train_images_per_s=train["captured"][
            "images_per_s"], infer_images_per_s=infer_s["captured"][
            "images_per_s"], seconds=time.perf_counter() - t0)
    out["ok"] = bool(check["ok"] and train["ok"] and infer_s["ok"]
                     and train["graphs"] == 1 and infer_s["graphs"] == 1
                     and np.isfinite(out["map"]))
    log("ssd", out)
    if not out["ok"]:
        raise SystemExit("ssd: captured differs from eager or the card from "
                         "the CPU: %s" % {k: out[k] for k in ("check",)})
    del runs, iruns, exe
    release_memory()
    return paths


def _captured_op_ms(op_type, inputs, attrs, outputs, runs=6):
    """A one-op program whose inputs are ``inputs`` already on the card
    (persistable vars in its scope, so a run copies nothing in), captured:
    {"ms": the median wall of ``runs`` replays, "device_ms": the device
    busy time of one profiled replay}."""
    import paddle_tpu_torch as pt

    main = pt.Program()
    scope = pt.Scope()
    with pt.program_guard(main, pt.Program()), pt.unique_name.guard():
        block = main.global_block()
        ins = {}
        for slot, a in inputs.items():
            ins[slot] = [block.create_var(name=slot.lower(), shape=a.shape,
                                          dtype=str(a.dtype).split(".")[-1],
                                          persistable=True)]
            scope.set_var(slot.lower(), a)
        outs = {k: [block.create_var(name=pt.unique_name.generate(
            k.lower())) for _ in range(n)] for k, n in outputs.items()}
        block.append_op(type=op_type, inputs=ins, outputs=outs, attrs=attrs)
    exe = pt.Executor(pt.CUDAPlace(0))
    fetch = [v for k in outputs for v in outs[k]]

    def run():
        return exe.run(main, fetch_list=fetch, scope=scope)

    times = []
    for i in range(runs + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        if i >= 2:
            times.append(time.perf_counter() - t0)
    window = device_window(run, again=True)
    return {"ms": statistics.median(times) * 1e3,
            "device_ms": window["busy_ms"],
            "device_events": window["device_events"]}


# ---------------------------------------------------------------------------
# phase 29: the CRF, CTC, sampled-loss, metric and detection op types
# ---------------------------------------------------------------------------

# Faster R-CNN at stride 16 on a 800 x 1344 image: a [1, 1024, 50, 84]
# map, 5 anchor sizes x 3 ratios (63000 anchors), COCO's 81 classes
RCNN = dict(channels=1024, h=50, w=84, image=(800, 1344), classes=81,
            sizes=[32.0, 64.0, 128.0, 256.0, 512.0], ratios=[0.5, 1.0, 2.0])
CHUNK_OUTS = ("Precision", "Recall", "F1-Score", "NumInferChunks",
              "NumLabelChunks", "NumCorrectChunks")
GPL_OUTS = ("Rois", "LabelsInt32", "BboxTargets", "BboxInsideWeights",
            "BboxOutsideWeights", "RoisNum")


def _pixel_boxes(rng, n, hw, lo=16.0, hi=400.0):
    """n (x1, y1, x2, y2) pixel boxes inside an image of ``hw``."""
    wh = lo + rng.rand(n, 2) * (hi - lo)
    xy = rng.rand(n, 2) * (np.asarray(hw[::-1]) - wh)
    return np.concatenate([xy, xy + wh], 1).astype("float32")


def _rcnn_inputs(rng):
    """The anchors of the RCNN map (the port's ``anchor_generator`` on the
    host), 12 ground truths, and 2000 proposals: each ground truth
    jittered 60 times, the rest at random."""
    from paddle_tpu_torch import registry

    attrs = {"anchor_sizes": RCNN["sizes"], "aspect_ratios": RCNN["ratios"],
             "stride": [16.0, 16.0], "offset": 0.5}
    anchors = registry.get_op_def("anchor_generator").compute(
        {"Input": [torch.zeros(1, 1, RCNN["h"], RCNN["w"])]}, attrs, None,
        0)["Anchors"].numpy()
    gt = _pixel_boxes(rng, 12, RCNN["image"])
    jit = np.repeat(gt, 60, 0) + rng.randn(720, 4).astype("float32") * 12
    rois = np.concatenate([jit, _pixel_boxes(rng, 1280, RCNN["image"])])
    return anchors, attrs, gt, rois.astype("float32")


def _a4_op_cases():
    """(op type, inputs, attrs, {output slot: vars}, differentiated
    slots, whether float outputs are long sums) of the slice's deterministic
    op types at their paths' shapes: the CRF at the SRL step's [10, 64,
    59], CTC on a CRNN line ([32, 100, 96] logits, labels up to 24),
    ``hierarchical_sigmoid`` over 30000 classes on machine translation's
    [1920, 512] loss rows, the SSD types at SSD300's 8732 priors and batch
    32 (planted equal scores in NMS and mining), the Faster R-CNN types
    on one image of ``RCNN`` (pre-NMS 6000 / post 1000 at 0.7, 256 RPN
    samples, 512 RoIs at fg 0.25, 7x7 RoI pooling at 1/16)."""
    from paddle_tpu_torch import registry
    from paddle_tpu_torch.ops.detection import bipartite_match, iou_matrix

    rng = np.random.RandomState(0)
    cases = []
    b, t, d = SRL_BATCH, SRL_LEN, SRL["labels"]
    lens = rng.randint(SRL_MIN_LEN, t + 1, b).astype("int32")
    lens[:2] = [t, 1]
    em = rng.randn(b, t, d).astype("float32")
    trans = (rng.randn(d + 2, d) * 0.5).astype("float32")
    tags = rng.randint(0, d, (b, t, 1)).astype("int64")
    cases += [
        ("linear_chain_crf", {"Emission": em, "Length": lens,
                              "Transition": trans, "Label": tags}, {},
         {"LogLikelihood": 1}, ("Emission", "Transition"), False),
        ("crf_decoding", {"Emission": em, "Length": lens,
                          "Transition": trans}, {}, {"ViterbiPath": 1}, (),
         False),
        ("chunk_eval", {"Inference": np.where(rng.rand(b, t, 1) < 0.7, tags,
                                              rng.randint(0, d, (b, t, 1))),
                        "Label": tags, "Length": lens},
         {"num_chunk_types": (d - 1) // 2, "chunk_scheme": "IOB"},
         {k: 1 for k in CHUNK_OUTS}, (), False)]
    logits = rng.randn(32, 100, 96).astype("float32")
    t_len = rng.randint(60, 101, 32).astype("int32")
    lbl = rng.randint(1, 96, (32, 24, 1)).astype("int64")
    l_len = rng.randint(1, 25, 32).astype("int32")
    best = logits.argmax(-1).astype("int64")
    cases += [
        ("warpctc", {"Logits": logits, "LogitsLength": t_len, "Label": lbl,
                     "LabelLength": l_len}, {"blank": 0}, {"Loss": 1},
         ("Logits",), False),
        ("ctc_align", {"Input": best, "Length": t_len}, {"blank": 0},
         {"Output": 1, "OutputLength": 1}, (), False),
        ("edit_distance", {"Hyps": best, "HypsLength": t_len,
                           "Refs": lbl[:, :, 0], "RefsLength": l_len}, {},
         {"Out": 1, "SequenceNum": 1}, (), False)]
    x = rng.randn(1920, 512).astype("float32")
    cases += [
        ("hierarchical_sigmoid", {
            "X": x, "W": (rng.randn(29999, 512) * 0.05).astype("float32"),
            "Label": rng.randint(0, 30000, (1920, 1)).astype("int64"),
            "Bias": rng.randn(29999, 1).astype("float32")},
         {"num_classes": 30000}, {"Out": 1}, ("X", "W", "Bias"), True),
        ("bilinear_tensor_product", {
            "X": x[:256, :256], "Y": x[256:512, :256],
            "Weight": (rng.randn(64, 256, 256) * 0.05).astype("float32"),
            "Bias": rng.randn(1, 64).astype("float32")}, {}, {"Out": 1},
         ("X", "Y", "Weight", "Bias"), True)]
    seg = rng.randint(0, 21, (8, 512, 512)).astype("int32")
    cases += [
        ("mean_iou", {"Predictions": seg, "Labels": np.where(
            rng.rand(8, 512, 512) < 0.6, seg, rng.randint(0, 21, seg.shape))
            .astype("int32")}, {"num_classes": 21},
         {"OutMeanIou": 1, "OutWrong": 1, "OutCorrect": 1}, (), False),
        ("precision_recall", {
            "MaxProbs": rng.rand(8192, 1).astype("float32"),
            "Indices": rng.randint(0, 1000, (8192, 1)).astype("int64"),
            "Labels": rng.randint(0, 1000, (8192, 1)).astype("int64"),
            "Weights": rng.rand(8192, 1).astype("float32"),
            "StatesInfo": rng.randint(0, 9, (1000, 4)).astype("float32")},
         {"class_number": 1000}, {"BatchMetrics": 1, "AccumMetrics": 1,
                                  "AccumStatesInfo": 1}, (), False),
        ("positive_negative_pair", {
            "Score": np.round(rng.rand(4096, 1), 3).astype("float32"),
            "Label": rng.randint(0, 5, (4096, 1)).astype("float32"),
            "QueryID": rng.randint(0, 64, (4096, 1)).astype("int64"),
            "Weight": rng.rand(4096, 1).astype("float32")}, {},
         {"PositivePair": 1, "NegativePair": 1, "NeutralPair": 1}, (),
         True)]
    # SSD300: 8732 priors, 32 images of up to 16 ground truths, 21 classes
    n_p = 8732
    xy = rng.rand(n_p, 2) * 0.8
    pri = np.concatenate([xy, xy + 0.02 + rng.rand(n_p, 2) * 0.2], 1) \
        .astype("float32")
    var = np.tile(np.asarray([[0.1, 0.1, 0.2, 0.2]], "float32"), (n_p, 1))
    gxy = rng.rand(32, 16, 2) * 0.7
    gt = np.concatenate([gxy, gxy + 0.05 + rng.rand(32, 16, 2) * 0.25], -1) \
        .astype("float32")
    n_gt = rng.randint(1, 17, 32)
    gt[np.arange(16)[None] >= n_gt[:, None]] = 0.0
    iou = iou_matrix(torch.from_numpy(gt), torch.from_numpy(pri)).numpy()
    match, mdist = (a.numpy() for a in bipartite_match(
        torch.from_numpy(iou), True, 0.5))
    enc = rng.randn(32, 16, n_p, 4).astype("float32")
    cls_loss = np.round(rng.rand(32, n_p) * 4, 2).astype("float32")
    scores = np.round(rng.dirichlet(np.ones(21), (32, n_p)), 3).astype(
        "float32").transpose(0, 2, 1).copy()
    dec = np.concatenate([rng.rand(32, n_p, 2) * 0.8, np.zeros(
        (32, n_p, 2))], -1).astype("float32")
    dec[..., 2:] = dec[..., :2] + 0.02 + rng.rand(32, n_p, 2).astype(
        "float32") * 0.2
    dets = np.zeros((32, 200, 6), "float32")
    dets[..., 0] = rng.randint(1, 21, (32, 200))
    dets[..., 1] = np.round(rng.rand(32, 200), 2)
    dets[:, :16, 0] = rng.randint(1, 21, (32, 16))
    dets[:, :16, 2:] = gt + rng.randn(32, 16, 4).astype("float32") * 0.02
    dets[:, 16:, 2:4] = rng.rand(32, 184, 2) * 0.7
    dets[:, 16:, 4:] = dets[:, 16:, 2:4] + 0.05 + rng.rand(32, 184, 2) * 0.2
    glab = np.concatenate([rng.randint(1, 21, (32, 16, 1)), gt,
                           rng.rand(32, 16, 1) < 0.15], -1).astype("float32")
    glab[:, :, 0] = np.where(np.arange(16)[None] < n_gt[:, None],
                             dets[:, :16, 0], 0)
    mine_in = {"ClsLoss": cls_loss, "MatchIndices": match,
               "MatchDist": mdist}
    mine_attrs = {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5,
                  "mining_type": "max_negative"}
    cases += [
        ("iou_similarity", {"X": gt, "Y": pri}, {}, {"Out": 1}, (), False),
        ("prior_box", {"Input": np.zeros((1, 512, 38, 38), "float32"),
                       "Image": np.zeros((1, 3, 300, 300), "float32")},
         {"min_sizes": [30.0], "max_sizes": [60.0], "aspect_ratios": [2.0],
          "flip": True, "clip": False, "variances": [0.1, 0.1, 0.2, 0.2],
          "step_w": 0.0, "step_h": 0.0, "offset": 0.5},
         {"Boxes": 1, "Variances": 1}, (), False),
        ("box_coder", {"TargetBox": gt.reshape(-1, 4), "PriorBox": pri,
                       "PriorBoxVar": var},
         {"code_type": "encode_center_size"}, {"OutputBox": 1}, (), False),
        ("box_coder", {"TargetBox": (rng.randn(32, n_p, 4) * 0.5).astype(
            "float32"), "PriorBox": pri, "PriorBoxVar": var},
         {"code_type": "decode_center_size"}, {"OutputBox": 1}, (), False),
        ("bipartite_match", {"DistMat": iou},
         {"match_type": "per_prediction", "dist_threshold": 0.5},
         {"ColToRowMatchIndices": 1, "ColToRowMatchDist": 1}, (), False),
        ("target_assign", {"X": enc, "MatchIndices": match}, {},
         {"Out": 1, "OutWeight": 1}, (), False),
        ("mine_hard_examples", mine_in, mine_attrs,
         {"NegIndices": 1, "NegCount": 1, "UpdatedMatchIndices": 1}, (),
         False),
        ("multiclass_nms", {"BBoxes": dec, "Scores": scores}, dict(SSD_NMS),
         {"Out": 1, "OutLength": 1}, (), False),
        ("detection_map", {"DetectRes": dets, "DetectResLength": np.full(
            32, 200, "int32"), "Label": glab, "GtLength": n_gt.astype(
            "int32")}, {"class_num": 21, "overlap_threshold": 0.5,
                        "evaluate_difficult": False, "ap_type": "11point"},
         {"MAP": 1, "AccumPosCount": 1}, (), False),
        ("polygon_box_transform", {"X": rng.randn(8, 8, 128, 128).astype(
            "float32")}, {}, {"Out": 1}, (), False)]
    # the mined negatives of that case, as ``ssd_loss`` hands them to its
    # second ``target_assign``
    mined = registry.get_op_def("mine_hard_examples").compute(
        {k: [torch.from_numpy(v)] for k, v in mine_in.items()},
        mine_attrs, None, 0)["NegIndices"].numpy()
    cases.append(("target_assign", {
        "X": glab[..., :1].astype("int64"), "MatchIndices": match,
        "NegIndices": mined}, {"mismatch_value": 0},
        {"Out": 1, "OutWeight": 1}, (), False))
    anchors, a_attrs, gt_px, rois = _rcnn_inputs(rng)
    c, h, w = RCNN["channels"], RCNN["h"], RCNN["w"]
    info = np.asarray([[RCNN["image"][0], RCNN["image"][1], 1.0]],
                      "float32")
    fmap = rng.randn(1, c, h, w).astype("float32")
    quads = np.concatenate([_pixel_boxes(rng, 128, (256, 640), 20, 200)]
                           * 2, 1)[:, [0, 1, 2, 1, 6, 7, 0, 7]]
    quads[:, 2:6] += rng.randn(128, 4).astype("float32") * 3
    cases += [
        ("anchor_generator", {"Input": np.zeros((1, c, h, w), "float32")},
         a_attrs, {"Anchors": 1, "Variances": 1}, (), False),
        ("generate_proposals", {
            "Scores": rng.randn(1, 15, h, w).astype("float32"),
            "BboxDeltas": (rng.randn(1, 60, h, w) * 0.2).astype("float32"),
            "ImInfo": info, "Anchors": anchors,
            "Variances": np.ones_like(anchors)},
         {"pre_nms_topN": 6000, "post_nms_topN": 1000, "nms_thresh": 0.7,
          "min_size": 0.1}, {"RpnRois": 1, "RpnRoiProbs": 1,
                             "RpnRoisLength": 1}, (), False),
        ("rpn_target_assign", {"Anchor": anchors, "GtBoxes": gt_px[None],
                               "GtLength": np.asarray([12], "int32")},
         {"rpn_batch_size_per_im": 256, "rpn_fg_fraction": 0.5,
          "rpn_positive_overlap": 0.7, "rpn_negative_overlap": 0.3},
         {"ScoreLabels": 1, "TargetBBox": 1, "BBoxWeight": 1}, (), False),
        ("generate_proposal_labels", _gpl_inputs(rng, gt_px, rois, info),
         dict(GPL_ATTRS, use_random=False), {k: 1 for k in GPL_OUTS}, (),
         False),
        ("roi_pool", {"X": fmap, "ROIs": rois[::3][:512].copy()},
         {"pooled_height": 7, "pooled_width": 7, "spatial_scale": 1 / 16},
         {"Out": 1}, ("X",), False),
        ("roi_perspective_transform", {
            "X": rng.randn(1, 256, 64, 160).astype("float32"),
            "ROIs": quads.astype("float32")},
         {"transformed_height": 8, "transformed_width": 64,
          "spatial_scale": 0.25}, {"Out": 1}, ("X",), False)]
    return cases


GPL_ATTRS = dict(batch_size_per_im=512, fg_fraction=0.25, fg_thresh=0.5,
                 bg_thresh_hi=0.5, bg_thresh_lo=0.0, class_nums=81,
                 bbox_reg_weights=[0.1, 0.1, 0.2, 0.2])


def _gpl_inputs(rng, gt_px, rois, info):
    crowd = np.zeros((1, 12), "int32")
    crowd[0, 3] = 1
    return {"RpnRois": rois[None], "RpnRoisLength": np.asarray(
        [len(rois)], "int32"), "GtClasses": rng.randint(
        1, RCNN["classes"], (1, 12)).astype("int32"), "IsCrowd": crowd,
        "GtBoxes": gt_px[None], "GtLength": np.asarray([12], "int32"),
        "ImInfo": info}


def gpl_eligible(inputs, attrs):
    """Per image: the candidate boxes (ground truths, then the proposals in
    the image's scale) and which are fg- and bg-eligible, by a numpy IoU
    of pixel boxes."""
    out = []
    for i in range(inputs["GtBoxes"].shape[0]):
        g = inputs["GtBoxes"][i][:inputs["GtLength"][i]]
        r = inputs["RpnRois"][i][:inputs["RpnRoisLength"][i]] / \
            inputs["ImInfo"][i, 2]
        cand = np.concatenate([g, r])

        def area(bx):
            return (bx[:, 2] - bx[:, 0] + 1) * (bx[:, 3] - bx[:, 1] + 1)

        iw = np.minimum(cand[:, None, 2], g[None, :, 2]) - \
            np.maximum(cand[:, None, 0], g[None, :, 0]) + 1
        ih = np.minimum(cand[:, None, 3], g[None, :, 3]) - \
            np.maximum(cand[:, None, 1], g[None, :, 1]) + 1
        inter = np.maximum(iw, 0) * np.maximum(ih, 0)
        ov = (inter / (area(cand)[:, None] + area(g)[None] - inter)).max(1)
        ov[:len(g)][inputs["IsCrowd"][i][:len(g)] > 0] = -1
        fg = ov > attrs["fg_thresh"]
        bg = ~fg & (ov >= attrs["bg_thresh_lo"]) & \
            (ov < attrs["bg_thresh_hi"])
        out.append((cand, fg, bg))
    return out


def gpl_faults(inputs, attrs, got, want_counts):
    """What breaks ``generate_proposal_labels``' invariants in ``got`` (its
    six outputs): each image's fg and bg counts those of ``want_counts``
    ([image][fg, bg], from a run without ``use_random``: the counts do not
    depend on the draw), each fg row an fg-eligible box with four target
    weights, each bg row a bg-eligible box, zeros past ``RoisNum``."""
    rois, labels, _, inside, _, num = got
    faults = []
    for i, (cand, fg, bg) in enumerate(gpl_eligible(inputs, attrs)):
        n = int(num[i])
        lab = labels[i, :n, 0]
        if [int((lab > 0).sum()), int((lab == 0).sum())] != \
                list(want_counts[i]):
            faults.append((i, "counts"))
        for row in range(n):
            box = rois[i, row] / inputs["ImInfo"][i, 2]
            hit = np.abs(cand - box).max(1) < 1e-3
            eligible = fg if lab[row] > 0 else bg
            if not (hit & eligible).any() or \
                    (inside[i, row] > 0).sum() != (4 if lab[row] > 0 else 0):
                faults.append((i, row))
        if rois[i, n:].any() or labels[i, n:].any():
            faults.append((i, "padding"))
    return faults


def _a4_random_checks():
    """``nce`` (100000 classes, 20 negatives, [2048, 512]) and
    ``generate_proposal_labels`` with ``use_random`` (``RCNN``): a program
    of seed 11 run three times by a capturing executor and an eager one
    on the card, every run the same bits in the two, a replay drawing
    anew; ``nce``'s Cost and SampleLogits, and its gradients, equal the
    port's formula (``nce_cost``) evaluated on the CPU on the card's own
    SampleLabels, the negatives in range with uniform moments; the random
    labels keep ``gpl_faults``' invariants."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.sampled_loss import nce_cost

    rng = np.random.RandomState(3)
    n_cls, n_neg = 100000, 20
    nce_in = {"Input": rng.randn(2048, 512).astype("float32"),
              "Label": rng.randint(0, n_cls, (2048, 1)).astype("int64"),
              "Weight": (rng.randn(n_cls, 512) * 0.05).astype("float32"),
              "Bias": rng.randn(n_cls, 1).astype("float32")}
    nce_attrs = {"num_total_classes": n_cls, "num_neg_samples": n_neg,
                 "num_true": 1}
    _, _, gt_px, rois = _rcnn_inputs(np.random.RandomState(4))
    info = np.asarray([[RCNN["image"][0], RCNN["image"][1], 1.0]],
                      "float32")
    gpl_in = _gpl_inputs(rng, gt_px, rois, info)
    rows, bad = [], []
    for op_type, inputs, attrs, outputs, diff in (
            ("nce", nce_in, nce_attrs, {"Cost": 1, "SampleLogits": 1,
                                        "SampleLabels": 1},
             ("Input", "Weight", "Bias")),
            ("generate_proposal_labels", gpl_in,
             dict(GPL_ATTRS, use_random=True), {k: 1 for k in GPL_OUTS},
             ())):
        arms = {cap: _one_op_run(pt.CUDAPlace(0), op_type, inputs, attrs,
                                   outputs, diff, seed=11, capture=cap,
                                   runs=3)[0]
                for cap in (True, False)}
        same = all(np.array_equal(a, b)
                   for ra, rb in zip(arms[True], arms[False])
                   for a, b in zip(ra, rb))
        got = arms[True][2]
        row = {"op": op_type, "same_bits_captured_eager": same,
               "replay_draws_anew": not all(
                   np.array_equal(a, b)
                   for a, b in zip(arms[True][1], got))}
        if op_type == "nce":
            samples = torch.from_numpy(got[2])
            t = {k: torch.from_numpy(v).requires_grad_(k in diff)
                 for k, v in inputs.items()}
            cost, o = nce_cost(t["Input"], samples, 1, t["Weight"],
                               t["Bias"], None, n_neg / n_cls)
            w = torch.from_numpy(np.random.RandomState(1).rand(
                2048, 1).astype("float32"))
            grads = torch.autograd.grad((cost[:, None] * w).mean(),
                                        [t[k] for k in diff])
            negs = got[2][:, 1:]
            errs = {"cost": _plain_compare("float", got[0],
                                           cost[:, None].detach().numpy()),
                    "logits": _plain_compare("float", got[1],
                                             o.detach().numpy())}
            rel = [float(np.linalg.norm(g - h.numpy()) / max(
                np.linalg.norm(h.numpy()), 1e-30))
                for g, h in zip(got[3:], grads)]
            row.update(errors={k: e for k, (e, _) in errs.items()},
                       grad_rel_l2=rel, neg_mean=float(negs.mean()),
                       neg_var=float(negs.var()))
            within = all(ok for _, ok in errs.values()) and \
                max(rel) <= PLAIN_GRAD and negs.min() >= 0 and \
                negs.max() < n_cls and np.array_equal(
                    got[2][:, :1], inputs["Label"]) and \
                abs(negs.mean() - (n_cls - 1) / 2) < 0.01 * n_cls and \
                abs(negs.var() / ((n_cls ** 2 - 1) / 12) - 1) < 0.02
        else:
            (host,), _ = _one_op_run(pt.CPUPlace(), op_type, inputs, dict(
                attrs, use_random=False), outputs, ())
            want = []
            for lab, n in zip(host[1][..., 0], host[5]):
                lab = lab[:int(n)]
                want.append([int((lab > 0).sum()), int((lab == 0).sum())])
            faults = gpl_faults(inputs, attrs, got, want)
            row.update(counts=want, rois=int(got[5][0]), faults=faults[:5])
            within = not faults
        row["within"] = bool(within)
        row["ok"] = bool(same and row["replay_draws_anew"] and within)
        rows.append(row)
        if not row["ok"]:
            bad.append(op_type)
    return rows, bad


def a4_ops_phase():
    """Phase 29: each of the 27 op types of the CRF, CTC, sampled-loss,
    metric and detection families (no hand kernel) as a one-op program on
    ``CUDAPlace(0)`` against ``CPUPlace()`` at their paths' shapes
    (``_a4_op_cases``): integer, bool and index outputs exact, floats
    within rtol 1e-5 / atol 1e-6 (the 512-term products within relative
    L2 1e-5), gradients within relative L2 1e-5, all read from the card's
    second run, a replay of its CUDA graph, which must repeat the eager
    run's bits; the two random ones by ``_a4_random_checks``.  No hand
    kernel launches.  Raises on a fault."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda

    cuda.reset_launch_counts()
    rows, bad, types = [], [], set()
    for op_type, inputs, attrs, outputs, diff, summed in _a4_op_cases():
        t0 = time.perf_counter()
        (first, card), n = _one_op_run(pt.CUDAPlace(0), op_type, inputs,
                                       attrs, outputs, diff, runs=2)
        card_s = time.perf_counter() - t0
        repeat = all(np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
                     for a, b in zip(first, card))
        t0 = time.perf_counter()
        (host,), _ = _one_op_run(pt.CPUPlace(), op_type, inputs, attrs,
                                 outputs, diff)
        errs, ok = _seq_compare(card, host, n, summed)
        rows.append({"op": op_type, "errors": errs,
                     "captured_repeats_eager": repeat, "ok": ok and repeat,
                     "card_s": card_s, "cpu_s": time.perf_counter() - t0})
        types.add(op_type)
        if not (ok and repeat):
            bad.append(op_type)
    random_rows, random_bad = _a4_random_checks()
    rows += random_rows
    bad += random_bad
    types.update(r["op"] for r in random_rows)
    launches = {k: v for k, v in cuda.launch_counts().items() if v}
    summary = {"types": len(types), "cases": rows,
               "hand_kernel_launches": launches,
               "ok": not bad and not launches and len(types) == 27}
    log("a4_ops", summary)
    if not summary["ok"]:
        raise SystemExit("a4_ops: the card differs from the CPU, a replay "
                         "from the eager run, or a case is missing: %s %s "
                         "(%d types)" % (bad, launches, len(types)))
    return summary


# (kernel, source, the TPU kernel's pallas_call, the path whose launches
# the row's "launches" reports)
KERNEL_ROWS = (
    ("flash_attention_fwd", "csrc/flash_attention_fwd.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:328", "train"),
    ("flash_attention_bwd", "csrc/flash_attention_bwd.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:364", "train"),
    ("layer_norm_fwd", "csrc/layer_norm_fwd.cu",
     "paddle_tpu/ops/pallas/layer_norm.py:59", "train"),
    ("layer_norm_bwd", "csrc/layer_norm_bwd.cu",
     "paddle_tpu/ops/pallas/layer_norm.py:94", "train"),
    ("softmax_xent_fwd", "csrc/softmax_xent.cu",
     "paddle_tpu/ops/pallas/softmax_xent.py:89", "train"),
    ("softmax_xent_bwd", "csrc/softmax_xent.cu",
     "paddle_tpu/ops/pallas/softmax_xent.py:111", "train"),
    ("dequant_matmul", "csrc/quant_matmul.cu",
     "paddle_tpu/ops/pallas/quant_matmul.py:121", "serve_int8:weight_only"),
    ("conv_bn_fwd", "csrc/conv_bn.cu",
     "paddle_tpu/ops/pallas/conv_bn.py:156", "resnet_train:fuse"),
    ("conv_bn_bwd", "csrc/conv_bn.cu",
     "paddle_tpu/ops/pallas/conv_bn.py:248", "resnet_train:fuse"),
    ("conv_bn_fwd_nhwc", "csrc/conv_bn_nhwc.cu",
     "paddle_tpu/ops/pallas/conv_bn.py:332", "resnet_train:nhwc_fuse"),
    ("conv_bn_bwd_nhwc", "csrc/conv_bn_nhwc.cu",
     "paddle_tpu/ops/pallas/conv_bn.py:417", "resnet_train:nhwc_fuse"),
)


# each kernel's AMP path and the kernels-phase check at its dtype and shape
# there (#7 serves int8 and has none): #1/#2 in bfloat16 with dropout, #3-#6
# in float32 (the residual stream and the black-listed loss), #8-#11 in
# bfloat16 at stage 3
AMP_ROWS = {
    "flash_attention_fwd": ("train_amp", "train_causal_dropout_bfloat16"),
    "flash_attention_bwd": ("train_amp", "train_causal_dropout_bfloat16"),
    "layer_norm_fwd": ("train_amp", "layer_norm_16384x512"),
    "layer_norm_bwd": ("train_amp", "layer_norm_bwd_16384x512"),
    "softmax_xent_fwd": ("train_amp", "softmax_xent_fwd_16384x32000_float32"),
    "softmax_xent_bwd": ("train_amp", "softmax_xent_bwd_16384x32000_float32"),
    "dequant_matmul": (None, None),
    "conv_bn_fwd": ("resnet_amp:fuse", "nchw_stage3_bn_relu_bfloat16"),
    "conv_bn_bwd": ("resnet_amp:fuse", "nchw_stage3_bn_relu_stats_bfloat16"),
    "conv_bn_fwd_nhwc": ("resnet_amp:nhwc_fuse",
                         "nhwc_stage3_bn_relu_bfloat16"),
    "conv_bn_bwd_nhwc": ("resnet_amp:nhwc_fuse",
                         "nhwc_stage3_bn_relu_stats_bfloat16"),
}


def release_memory():
    """Free what the last phase's executors, graphs and scopes held."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def count_sass(lib, opcode):
    """How many instructions of ``opcode`` the library's SASS holds
    (``cuobjdump --dump-sass``): HGMMA is wgmma on the tensor cores."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", lib], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    return sum(opcode in ln for ln in sass.splitlines())


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import build

    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", {"nvidia_smi": smi,
                   "name": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count(),
                   "torch": torch.__version__, "cuda": torch.version.cuda,
                   "matmul.allow_tf32":
                       torch.backends.cuda.matmul.allow_tf32,
                   "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                   # the port turns it off: bf16 products sum in float32
                   "matmul.allow_bf16_reduced_precision_reduction":
                       torch.backends.cuda.matmul
                       .allow_bf16_reduced_precision_reduction})

    t0 = time.perf_counter()
    built = build.build()
    ptxas = {n: [ln.split("info    : ")[-1] for ln in
                 build.build_log.get(n, "").splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in built}
    # tensor-core instructions in the SASS: wgmma (HGMMA) in #8-#11,
    # mma.sync (HMMA: TF32 / bf16 / f16; IMMA: int8) in #1, #2 and #7
    hgmma = {n: count_sass(built[n], "HGMMA")
             for n in ("conv_bn", "conv_bn_nhwc")}
    hmma = {n: count_sass(built[n], "HMMA") for n in (
        "flash_attention_fwd", "flash_attention_bwd", "quant_matmul")}
    imma = {"quant_matmul": count_sass(built["quant_matmul"], "IMMA")}
    log("build", {"seconds": time.perf_counter() - t0,
                  "kernels": sorted(built), "ptxas": ptxas,
                  "hgmma": hgmma,
                  "hmma": hmma, "imma": imma})
    if not all(hgmma.values()) or not all(hmma.values()) \
            or not all(imma.values()):
        raise SystemExit("a tensor-core kernel holds no tensor-core "
                         "instruction: %s %s %s" % (hgmma, hmma, imma))
    if "--conv-bn" in sys.argv[1:]:
        from paddle_tpu_torch.ops.cuda import conv_bn as cb
        log_checks(conv_bn_cases(cb, Timer()))
        return 0
    if "--train-kernels" in sys.argv[1:]:
        log_checks(train_kernel_cases(Timer()))
        return 0
    if "--serve-kernels" in sys.argv[1:]:
        log_checks(serve_kernel_cases(Timer()))
        return 0
    if "--profile" in sys.argv[1:]:
        for quantize in (None, "weight_only", "dynamic"):
            profile_phase(pt.CUDAPlace(0), quantize=quantize)
        for amp in (False, True):
            train_profile_phase(pt.CUDAPlace(0), amp=amp)
            release_memory()
            resnet_profile_phase(pt.CUDAPlace(0), amp=amp)
        return 0
    if "--resnet-default" in sys.argv[1:]:
        for r, _ in resnet_train_phase(deterministic=False).values():
            log("resnet_train", r)
        return 0
    if "rnn" in sys.argv[1:]:
        log_checks(mt_xent_cases(Timer()))
        rnn_checks()
        for path, record in rnn_phase().items():
            faults = launch_faults(record)
            if faults:
                raise SystemExit("rnn: %s launched %s" % (path, faults))
        return 0
    alone = {"plain_ops", "mnist_cnn", "seq_ops", "beam", "a4_ops", "srl",
             "ssd"} & set(sys.argv[1:])
    if alone:
        # the frontend, control-flow and CRF / detection slices alone (no
        # hand kernel on their paths but #5 / #6 in ssd_loss)
        if "plain_ops" in alone:
            plain_ops_phase()
            release_memory()
        if "mnist_cnn" in alone:
            for path, record in mnist_cnn_phase().items():
                faults = launch_faults(record)
                if faults:
                    raise SystemExit("mnist_cnn: %s launched %s"
                                     % (path, faults))
        if "seq_ops" in alone:
            seq_ops_phase()
            release_memory()
        if "beam" in alone:
            for path, record in beam_phase().items():
                faults = launch_faults(record)
                if faults:
                    raise SystemExit("beam: %s launched %s" % (path, faults))
        if "a4_ops" in alone:
            a4_ops_phase()
            release_memory()
        for name, phase in (("srl", srl_phase), ("ssd", ssd_phase)):
            if name in alone:
                for path, record in phase().items():
                    faults = launch_faults(record)
                    if faults:
                        raise SystemExit("%s: %s launched %s"
                                         % (name, path, faults))
        log("total", {"seconds": time.perf_counter() - t_start,
                      "phase_seconds": dict(PHASE_SECONDS)})
        return 0
    if "serve_paged" in sys.argv[1:]:
        log_checks(serve_paged_kernel_cases(Timer()))
        for path, record in serve_paged_phase().items():
            faults = launch_faults(record)
            if faults:
                raise SystemExit("serve_paged: %s launched %s"
                                 % (path, faults))
        log("total", {"seconds": time.perf_counter() - t_start,
                      "phase_seconds": dict(PHASE_SECONDS)})
        return 0
    if "--serve-ab" in sys.argv[1:]:
        # fp and int8 serving in turns (fp, weight_only, dynamic, then the
        # reverse), so host load drifting within the call shows as spread
        for quantize in (None, "weight_only", "dynamic", "dynamic",
                         "weight_only", None):
            summary = serve_phase(pt.CUDAPlace(0), quantize=quantize)[0]
            log("serve_ab", summary)
        return 0

    checks = kernels_phase()
    # the AMP check, card against CPU, at the CPU tests' configurations
    amp_small_checks()
    release_memory()
    # each path with the counters zeroed just before it and read just
    # after: fp serving (kernels #1 and #3), int8 serving in both modes and
    # one-shot int8 inference (#1, #3 and #7), the bf16 score program (#1,
    # #3), Transformer training in float32 and under AMP (#1-#6), then
    # ResNet-50 training in float32 and under AMP: plain (none), fused
    # (#8, #9) and NHWC + fused (#10, #11)
    short, path_launches = {}, {}

    def check_path(path, record):
        # the kernel table reports each path's launches in its profiled
        # window's device trace
        path_launches[path] = record["window"]["trace_launches"]
        short.update({"%s:%s" % (path, k): v
                      for k, v in launch_faults(record).items()})

    # every path runs captured (the main path, whose counts the kernel
    # table reports) and eager (``:eager``), in turns
    for path, (summary, record) in serve_phases(pt.CUDAPlace(0)).items():
        check_path(path, record)
    # the paged cache, int8 KV and speculative decoding (#1 over gathered
    # pages, at decode and at the verify's 4-row suffix query; #3)
    for path, record in serve_paged_phase().items():
        check_path(path, record)
    release_memory()
    infer, paths = infer_phase(pt.CUDAPlace(0))
    log("infer", infer)
    if not infer["same_bits_as_eager"]:
        raise SystemExit("captured one-shot serving differs from eager")
    for path, record in paths.items():
        check_path(path, record)
    for path, record in infer_bf16_phase(pt.CUDAPlace(0))[1].items():
        check_path(path, record)
    for amp in (False, True):
        train_check_phase(amp=amp)
        _, paths = train_phase(pt.CUDAPlace(0), amp=amp)
        for path, record in paths.items():
            check_path(path, record)
        release_memory()
    for amp, name in ((False, "resnet_train"), (True, "resnet_amp")):
        resnet_check_phase(amp=amp)
        release_memory()
        for mode, (r, records) in resnet_train_phase(amp=amp).items():
            log(name, r)
            check_path("%s:%s" % (name, mode), records["captured"])
            check_path("%s:%s:eager" % (name, mode), records["eager"])
        release_memory()
    # the input pipeline and the high-level trainer: the MLP through
    # Trainer, bench.py's realdist rung (#1-#6 at the bucket shapes) and
    # ResNet-50 AMP fed three ways
    mlp_trainer_phase()
    release_memory()
    for path, record in realdist_phase()[1].items():
        check_path(path, record)
    resnet_feed_phase()
    release_memory()
    # sparse embeddings: bench.py's rec_sparse A/B and the CTR DNN (no hand
    # kernel on either path)
    for path, record in rec_sparse_phase().items():
        check_path(path, record)
    release_memory()
    for path, record in ctr_phase().items():
        check_path(path, record)
    release_memory()
    # bench.py's image ladder (no hand kernel; inference with ResNet-50,
    # its BN-folded program and the predictor), fused SE-ResNeXt-50 (#8,
    # #9 at its shapes, after its card-against-CPU check), NHWC + fused
    # SE-ResNeXt-50 (#10, #11 at its shapes, after its own), BASELINE's
    # SE-ResNeXt-152 and the optimizers on the MLP (no hand kernel)
    resnext_check_phase()
    release_memory()
    for phase in (zoo_phase, zoo_infer_phase, se_resnext_fused_phase):
        for path, record in phase().items():
            check_path(path, record)
        release_memory()
    resnext_check_phase(modes=("nhwc_fuse",), name="resnext_nhwc_check")
    release_memory()
    for phase in (se_resnext_nhwc_fused_phase, se_resnext152_phase,
                  optimizers_phase):
        for path, record in phase().items():
            check_path(path, record)
        release_memory()
    # bench.py's RNN rungs: the stacked LSTM (no hand kernel) and attention
    # machine translation (#5/#6 at [1920, 30000]), after their
    # card-against-CPU checks
    rnn_checks()
    for path, record in rnn_phase().items():
        check_path(path, record)
    release_memory()
    # the CNN op family and the plain op library, card against CPU, and
    # models/mnist.py's conv net through the Trainer (no hand kernel)
    cnn_ops_phase()
    plain_ops_phase()
    release_memory()
    for path, record in mnist_cnn_phase().items():
        check_path(path, record)
    release_memory()
    # the control-flow and sequence slice's op types, card against CPU,
    # and beam-search decoding at machine translation's width (no hand
    # kernel)
    seq_ops_phase()
    release_memory()
    for path, record in beam_phase().items():
        check_path(path, record)
    release_memory()
    # the CRF, CTC, sampled-loss, metric and detection op types, card
    # against CPU; the book's label_semantic_roles trained (no hand
    # kernel) and the SSD300 head (#5 / #6 in its ssd_loss)
    a4_ops_phase()
    release_memory()
    for phase in (srl_phase, ssd_phase):
        for path, record in phase().items():
            check_path(path, record)
        release_memory()
    if short:
        raise SystemExit("a path did not launch its kernels as its program "
                         "implies (counted, implied): %s" % short)

    rows = []
    for name, src, tpu, main_path in KERNEL_ROWS:
        # the float32 check at the main path's shape (training for #1-#6,
        # the decode logits projection for #7, ResNet-50's stage-3 layer
        # for #8-#11)
        head = checks[name][0]
        row = {"name": name, "route": "cuda",
               "source": "paddle_tpu_torch/" + src, "replaces": tpu,
               "launches": path_launches[main_path][name],
               "max_abs_err": head["max_abs_err"],
               "ms": head["kernel_ms"], "device_ms": head["device_ms"],
               "plain_ms": head["plain_ms"],
               "bound_ms": head["bound_ms"],
               "bound_by": head["bound_by"].split(" ")[0],
               "library_ms": head["library_ms"],
               "library_device_ms": head.get("library_device_ms"),
               "at": head["check"],
               "launches_path": main_path}
        if "bound_simt_ms" in head:  # #1, #7, #8-#11: the tensor cores'
            # TF32 bound, and the float32 units' beside it
            row.update(bound_rate=head.get("bound_rate", "3xTF32"),
                       bound_simt_ms=head["bound_simt_ms"])
        row.update({"launches_" + p: path_launches[p][name]
                    for p in path_launches})
        if name in ("softmax_xent_fwd", "softmax_xent_bwd"):
            # machine translation's loss ([1920, 30000] float32, rnn)
            row["machine_translation_shape"] = [
                {k: c.get(k) for k in ("check", "max_abs_err", "kernel_ms",
                                       "device_ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}
                for c in checks[name]
                if c["logits"] == list(MT_XENT[0][:2])]
        if name in ("flash_attention_fwd", "layer_norm_fwd"):
            # the speculative verify's shapes (serve_paged)
            row["serve_paged_shapes"] = [
                {k: c.get(k) for k in ("check", "max_abs_err", "kernel_ms",
                                       "device_ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "library_device_ms")}
                for c in checks[name]
                if c["check"] in ("verify_float32", "layer_norm_%dx%d" % (
                    MODEL["slots"] * SPEC_K, MODEL["d_model"]))]
        if name.startswith("conv_bn_"):
            # the other shapes: SE-ResNeXt-50's fused layers (NCHW for
            # #8/#9, NHWC for #10/#11)
            prefix = "nhwc_rx_" if name.endswith("_nhwc") else "nchw_rx_"
            row["se_resnext_shapes"] = [
                {k: c.get(k) for k in ("check", "bcoh", "dtype",
                                       "max_abs_err", "kernel_ms",
                                       "device_ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}
                for c in checks[name] if c["check"].startswith(prefix)]
        # the kernel on its AMP path: the check at that path's dtype and
        # shape, and the path's launches
        amp_path, amp_check = AMP_ROWS[name]
        row["amp"] = None
        if amp_path:
            amp = next(c for c in checks[name] if c["check"] == amp_check)
            row["amp"] = {
                "path": amp_path, "dtype": amp["dtype"],
                "launches": path_launches[amp_path][name], "at": amp_check,
                "max_abs_err": amp["max_abs_err"], "ms": amp["kernel_ms"],
                "device_ms": amp["device_ms"], "plain_ms": amp["plain_ms"],
                "bound_ms": amp["bound_ms"],
                "bound_by": amp["bound_by"].split(" ")[0],
                "library_ms": amp["library_ms"]}
        rows.append(row)
    log("total", {"seconds": time.perf_counter() - t_start,
                  "phase_seconds": dict(PHASE_SECONDS)})
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
