#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py [--seed N] [--reps N] [--train-steps N]
                          [--resnet-steps N] [--mnist-epochs N]
                          [--ptb-steps N]

Phases, in order; any fault ends the run with a non-zero exit and no
``ok`` line:

1. device — the card's name and power limit from nvidia-smi.
2. build — compile every hand-written kernel from
   ``mxnet_tpu_torch/csrc`` (one nvcc per source, all started together)
   into ``mxnet_tpu_torch/_build/``; print what ``-Xptxas -v`` reports,
   each kernel by name with its registers, spills and shared memory (the
   attention kernels' dynamic shared memory from their launcher).
3. kernel parity — each kernel against its plain PyTorch version on the
   card, in bf16: the forward kernels at the shapes BERT-base serving
   gives them; the LayerNorm, bias+GeLU and attention backward kernels
   (dgamma, dbeta, db and the packed dQKV included), attention at
   dropout 0.1 and the dropout kernel at the shapes BERT-base training
   gives them; the dual backward (dx, dW, the masked jg and the
   chaining sums) at every call shape of ResNet-50's fused stages. The dropout masks of kernel and plain version must be
   identical (zero patterns compared exactly), its output bit for bit,
   also from an x one element off 16-byte alignment (the kernel's
   one-element variant, ``cuda_dropout.scalar_launches``; every dropout
   launch of the BERT, PTB and VGG-16 steps must take the 16-byte one),
   and the dropout keep rate
   within 5 binomial sigma of 0.9. Attention also at ``ATT_SHAPES`` (L
   77, 512 and 1024, hd 64, 32 and 128; both backward routes), each
   element within ``order_limit`` (the tolerance widened by exactly the
   plain version's distance from its float64-summed twin), and a
   control: the backward with dV from the bf16 Pd must fail the
   bit-equal share. The kernels' division (``div_rn``) bit for bit with
   '/' on 3 x 2^30 operand pairs, x * rcp(y) caught. The forward
   kernels also at the training step's shapes; the LayerNorm forward and
   bias+GeLU held to the 0.99 bit-equal share, bias+residual to every
   element bit for bit. Planted faults that must fail their checks:
   bias+GeLU (forward and backward) and bias+residual with the bias read
   one column off, the LayerNorm forward with gamma read one column
   off.
4. serving — BERT-base (12 layers, 768 units, 12 heads, vocab 30522) at
   full width with weights, biases, LayerNorm gamma and beta drawn from
   ``--seed``, cast to bf16 and served through ``InferenceSession``: the
   launch counts are reset just before and read just after, and every
   output is held against the same model run with the kernels swapped
   for their plain versions. A control then serves one request with
   bias_residual's bias dropped and requires that check to fail.
5. training — the same model with dropout 0.1 and
   ``BERTMLMLoss(mode="dense")``, batch 32 x seq 128, trained through
   ``autograd.record()`` -> ``backward()`` -> ``gluon.Trainer`` (LAMB,
   lr 1e-3, wd 0.01). One forward and backward is held against the same
   step with every kernel swapped for its plain version (same seeds, so
   the same masks): the loss and every parameter's gradient, with the
   plain bf16 step's own distance from its f32 twin as the yardstick. A
   control drops bias+GeLU's db (its kernel still launches) and must be
   caught. Then the launch counts of one full step (counts reset just
   before, read just after) must equal the expected table, and
   ``--train-steps`` LAMB steps on one fixed batch must keep the loss
   finite and end below where they began.
5a. AMP pretraining — BERT-base as the reference's flagship
   configuration runs it: ``bert_12_768_12`` at dropout 0.1 with f32
   parameters under ``amp.init(target_dtype="bfloat16")`` and the
   default ``BERTMLMLoss()`` (auto: the chunked LM head, chunk 4096),
   batch 32 x seq 128. First the kernels at the step's dtype mixes
   against their plain versions: the LayerNorm forward and backward on
   bf16 x with f32 gamma and on f32 x, dropout on f32. One forward and
   backward is held against the same step with every kernel swapped
   for its plain version, per gradient and for the loss, with the plain
   AMP step's distance from the same step in f32 without AMP as the
   yardstick (``AMP_RATIO``); a control drops the LayerNorm backward's
   dgamma where x is bf16 and gamma f32 and must be caught. The launch
   counts of one full step (reset just before, read just after) must
   equal the training table, with the LayerNorm instances by dtype
   (``AMP_LN_INSTANCES``); ``AMP_STEPS`` LAMB steps driven by a
   ``PolyScheduler`` with warmup must lower the loss. The chunked head
   is held against the full-vocab head on the step's hidden states
   (loss, dh, dW, db; a control pads with 0 bias logits), and each
   head's device time and peak memory are printed with the dense
   mode's; then the AMP step on the host clock and under the profiler.
5b. float16 — the same widths at ``FP16_LAYERS`` layers cast to
   float16, LAMB with ``multi_precision=True`` (f32 masters),
   ``amp.init("float16")``, ``init_trainer``, ``scale_loss`` and
   ``unscale``: ``FP16_STEPS`` steps must keep the loss finite and
   lower it, and a non-finite gradient planted halfway must halve the
   loss scale and zero that step's gradients.
6. fused stages — ResNet-50 v1's four bottleneck stages at full width
   (batch 32 at 224^2: 56^2, 28^2, 14^2 and 7^2, HWNC bf16), laid out
   as tools/layout_exp.py mode hwnc5 runs them, forward and backward
   through ``cuda_fused.fused_stage``: the launch counts (reset just
   before, read just after) must be 27 ``dual_bwd`` and nothing else,
   and the output and every gradient are held against the same stages
   with the plain version, the plain bf16 stages' distance from their
   f32 twin as the yardstick. A control drops the shortcut gradient
   from the head kernels and must be caught. (The kernel is first held
   against its plain version, every variant at every call shape of
   these stages, in phase 3.)
7. ResNet-50 — ``resnet50_v1`` initialized with MSRAPrelu from
   ``--seed``, cast to bf16 with BatchNorm in f32, trained through
   ``autograd.record()`` -> ``backward()`` -> ``gluon.Trainer`` (SGD lr
   0.1, momentum 0.9) on a batch of 128 at 224^2 (bench.py's headline
   loop without AMP or hybridize): the stem BatchNorm's moving
   statistics after one step against the momentum update of its batch
   statistics (a swapped momentum must be caught), every moving
   statistic moved and finite, one step's gradients against the same
   step's f32 twin (TF32 off; BatchNorm without its shift must be
   caught), and ``--resnet-steps`` SGD steps on one fixed batch must
   keep the loss finite and take it at least ``RESNET_FALL`` below the
   first step's (lr 0.1 without warmup overshoots afterwards).
8. rtc — the user module of ``RTC_SOURCE`` (CUDA C written as a user
   of ``mx.rtc`` writes it: ``saxpy``, ``twoout``, ``relu_fwd``,
   ``relu_bwd``) compiled at runtime by ``mx.rtc.CudaModule``, and a
   second module with the same source, which must reuse the first's
   build. Each kernel against its plain function at 2^24 f32 elements
   and at the MLP's activation shapes: ``saxpy`` within 2^-23 of each
   element (nvcc contracts it into an FMA), the others bit for bit. A
   const output pointer, a wrong dtype and a wrong input count must be
   refused before any launch; ``relu_bwd`` with ``>=`` for ``>`` must
   fail on inputs with exact zeros (the control). Then the reference
   docstring's launches through NDArrays, counted.
9. MNIST MLP — ``train_mnist.py --synthetic``'s data (6000 examples, a
   sixth held out) through ``gluon.data.ArrayDataset`` and
   ``DataLoader(batch_size=64, shuffle=True)``; the 784-128-64-10 MLP
   with Xavier init whose relus are ``F.Custom(op_type="rtc_relu")``, a
   ``CustomOp`` launching ``relu_fwd`` and ``relu_bwd``, trained three
   epochs with ``SoftmaxCrossEntropyLoss`` and SGD lr 0.1 beside its
   twin with ``Dense(activation="relu")`` from the same weights on the
   same batches (TF32 off for both): every loss and weight after every
   step equal bit for bit, the last epoch's train accuracy above the
   first's, the launch counts (reset just before, read just after) two
   of each relu kernel per step and per validation forward; a custom op
   whose backward passes dy through unmasked must be caught.
10. times — median time of each kernel, its plain version and the one
   PyTorch call (or, for ``dual_bwd``, composition) that computes the
   same function; per-request latency and tokens/s of serving; ms per
   training step and samples/s; the fused stages' forward and backward;
   the ResNet-50 step and images/s; the MLP step with the custom op and
   its twin; then one served forward, one BERT training step (with the
   attention kernels' share), the fused stages, one ResNet-50 step and
   one MLP step under torch.profiler, the device time by kernel group.
   The attention, LayerNorm, bias+GeLU and bias+residual forwards are
   timed at the serving shape and at the training shape (the ``*_train``
   rows; attention at p = 0.1). The LayerNorm and bias+GeLU backwards
   and every ``dual_bwd`` call also by launch (``launch_ms``, profiler);
   where one block takes a whole ``dual_bwd`` call, the cdy pass's path
   is timed beside it in turns. The LayerNorm forward, bias+GeLU and
   bias+residual rows also carry an issue floor (``issue_ms``): the SASS
   instructions an element of the kernel's row loop (``cuobjdump
   -sass``) issued one a lane a cycle at the card's highest SM clock;
   the LayerNorm forward and bias+residual serving rows their fixed cost
   (``fixed_ms``, ``fixed_library_ms``): kernel and library call on one
   row, a launch and one row's latency.

11. compiled — ``hybridize()`` as captured CUDA graphs
   (``mxnet_tpu_torch/cached_op.py``) on three paths at full width, each
   against its eager twin on the card (the same blocks run under
   ``cached_op.eager()``), each driven with the launch counts set to 0
   just before and read just after, and its graphs freed before the
   next path: (a) the phase-4 session, every bucket a replayed graph,
   every request's outputs equal to the eager session's; (b) BERT-base
   pretrained as phase 5a runs it (``amp.init("bfloat16")``, the
   chunked ``BERTMLMLoss()``, LAMB with ``PolyScheduler``, 32 x 128),
   model and loss hybridized, ``COMPILED_STEPS`` steps at dropout 0
   against the eager steps, then at dropout 0.1 two replays must draw
   different masks (keep rate within 5 binomial sigma of 0.9); (c)
   ResNet-50 v1 as bench.py's headline loop runs it (``amp.init
   ("bfloat16")``, ``hybridize(static_alloc=True, static_shape=True)``
   on the net and the loss, SGD lr 0.1 momentum 0.9, batch 128 at
   224^2, ``MXNET_TRAINER_FUSED_UPDATE`` on), every step from the
   second the consumed plan with the update in its graph, losses and
   parameters after ``COMPILED_STEPS`` steps against the eager loop's.
   Parity: serving bit for bit; each BERT step in lockstep with the
   eager step from the same parameters, within ``COMPILED_AMP_RATIO``
   times AMP's own error (all but the embeddings' gradients bit for
   bit); the ResNet loop within ``COMPILED_SPREAD`` times the distance
   between two eager loops, bit for bit where they are.
   Each path prints graph replays and launches of a steady step (no
   kernel wrapper and no model op may run in it), the host-clock step
   eager against compiled (in turns), one profiled compiled step (busy
   time, idle share) and the memory its graphs hold; the kernel
   launches recorded into each path's graphs (counted inside each
   capture alone, the eager warm-ups apart) go into the kernels line as
   ``launches_per_compiled_capture``. Planted controls that must fail: a weight changed in place after capture, its replay
   held to the output from before; a ResNet step whose replay is
   skipped, held to the eager loop.

12. PTB LSTM — upstream MXNet's ``example/gluon/word_language_model``
   as its README runs it (``--tied --nhid 650 --emsize 650 --dropout
   0.5``): ``ptb_model`` (Embedding 10 000 x 650, dropout 0.5, a 2-layer
   ``gluon.rnn.LSTM`` with dropout between its layers, dropout, a Dense
   decoder tied to the embedding), bptt 35 x batch 32, f32, token ids
   from ``ptb_stream(--seed)`` (Zipf's law, batchified), trained by
   ``ptb_step`` as MXNet 1.x's train.py trains it (the state carried and
   detached, ``SoftmaxCrossEntropyLoss`` over 35 x 32 tokens,
   ``clip_global_norm`` to 0.25, SGD lr 20, ``trainer.step(1)``). First
   the dropout kernel at (35, 32, 650) and (1120, 650), p 0.5, bit for
   bit with its plain version forward and backward; then one forward and backward at
   dropout 0 on the card (TF32 off) against the same weights through the
   port on the CPU (``ptb_parity``: the loss, every gradient, the final
   and carried (h, c), within ``PTB_PARITY``; the i and f gate blocks
   swapped in the packing, and the h2h bias dropped, must be caught);
   ``--ptb-steps`` clipped SGD steps at dropout 0.5 on consecutive
   windows must keep the loss and the clip's norm finite, take the loss
   ``PTB_FALL`` below the first step's and launch
   ``PTB_DROPOUT_LAUNCHES`` dropout kernels a step (counted from 0 just before, read just after); the
   LSTM layer's forward and backward beside ``torch.nn.LSTM`` (cuDNN, a
   yardstick) on its weights; the dropout kernel's time at (1120, 650)
   against its bound and ``F.dropout`` (the ``dropout_ptb`` row). Then
   the model hybridized (its embedding, dropouts, LSTM and decoder each
   captured through ``cached_op.py``): ``COMPILED_STEPS`` steps at
   dropout 0 against two eager loops (``COMPILED_SPREAD``); at dropout
   0.5, two replays of the Dropout drawing different masks within 5
   binomial sigma of 0.5, and a steady step with no kernel launched
   outside its graphs and the ``PTB_DROPOUT_LAUNCHES`` dropout launches
   of the eager step inside the graphs it replays; the step eager
   against compiled in turns with tokens/s, and one profiled step of
   each. The rows gain ``launches_per_ptb_step`` and a ``ptb`` entry in
   ``launches_per_compiled_capture``.

13. resume — checkpoints in the reference's file formats
   (``save_parameters``, ``save_states``, ``nd.save``), written into a
   temporary directory that is removed at the end. On each path a run
   of ``RESUME_STEPS`` (N) steps is saved, loaded into a fresh model and
   Trainer (initialized from another seed) and trained N more, and held
   bit for bit against 2N steps without a break: every loss, parameter
   (the BatchNorm moving statistics too) and optimizer state; then step
   N's files are loaded into the same model and Trainer, whose graphs
   are captured, and the N steps replayed must agree bit for bit again.
   (a) ResNet-50 as phase 11 runs it (bf16 AMP, SGD momentum 0.9, batch
   128 at 224^2, hybridized, the fused SGD step in its graph); the
   rollback must capture nothing anew, and a planted fault, the states
   rebound to new tensors while the captured step that reads the old
   ones is kept, must fail the check. (b) The PTB LSTM at dropout 0.5,
   hybridized, with its carried state saved by ``nd.save`` and
   ``mx.random.seed`` called at step N in every run (the dropout counter
   on the card restarts alike); the last resumed step's graphs must
   carry phase 12's ``PTB_DROPOUT_LAUNCHES``. (c) BERT-base as phase 5a
   runs it (f32 parameters under bf16 AMP, the chunked head, LAMB with a
   ``PolyScheduler``, 32 x 128): three steps, saved and loaded, every
   parameter and LAMB (mean, var) equal to the saved ones with its
   dtype, the fresh optimizer's ``num_update`` 0 (as the reference, the
   blob carries no optimizer), one resumed forward and backward against
   its plain-version twin within ``AMP_RATIO`` and the resumed step
   taken, its states then on the card. (d) NAG, RMSProp (plain and
   centered), Ftrl, SignSGD and AdaGrad train the MNIST MLP
   ``RESUME_OPT_STEPS`` steps on the card at aggregation width 1 and at
   its default, saved and loaded after step 2 (the round trip bit for
   bit), against the port's CPU run within ``OPT_PARITY``; a load of the
   parameters of one step before the save must fail that check. The
   kernels of these paths launch outside graphs (counted from 0 just
   before the phase, read just after; the rows gain
   ``launches_per_resume``), and one line gives each path's file sizes
   and its ``save_parameters``, ``save_states``, ``load_parameters`` and
   ``load_states`` times beside the card's name and power limit.

14. scan — K-step whole-loop compilation (``MXNET_SCAN_STEPS=4``,
   ``mxnet_tpu_torch/scan.py``) and the grad guard on BERT-base as
   ``_build_train`` builds it (bf16, dropout 0.1, the dense MLM head,
   32 x 128), model and loss hybridized, backward from the loss block's
   output, plain SGD (momentum 0.9, wd 0.01, a ``PolyScheduler``), each
   run from one snapshot and one ``mx.random.seed`` with its graphs
   freed first. (b) ``SCAN_STEPS`` steps at K=4 (the arming step, two
   chunks, a tail of two drained by the read) bit for bit with the
   per-step fused path at K=1: every loss, parameter and momentum. (c)
   The same with a ``skip_step`` guard and ``nan_grad`` planted at step
   ``SCAN_PLANT``, bit for bit with the classic guarded path at K=1, one
   skipped step in both, 4 host reads against 11. (d) The ladder, each
   rung with its one warning: a loss read every step bails after three
   forces and stays bit for bit; ``MXNET_GUARD_CLIP_NORM`` runs the
   classic path with the gradients' norm at the clip norm within 1e-3
   (of the norm times the factor as rounded to bf16); phase 11's
   compiled ResNet-50 loop bails (BatchNorm writes moving statistics)
   and stays bit for bit with K=1 over 4 steps. (e) Planted faults that
   must fail: the chunk reading row 0's lr for every step, the verdict
   ignored in the graph. (a) A steady chunk makes one chunk replay, no
   forward or plan replay and no launch outside its graph, and its graph
   carries K times a per-step fused step's launches of the eight BERT
   kernels. (f) ms a step at K=1 and K=4 in turns (medians of
   ``2 * SCAN_TURNS`` segments of ``SCAN_SEGMENT`` chunks), a profiled
   chunk and K profiled per-step steps (busy and idle share), the
   memory each captured graph holds, and the
   same for tools/loop_micro.py's MLP (width 256, f32, a skip_step
   guard); each line with the card's name and power limit. The rows
   gain ``launches_per_scan_run`` (the K=4 parity run's launches through
   the wrappers, its eager chunk and tail) and a ``scan`` entry in
   ``launches_per_compiled_capture``.

15. vision — the vision model zoo, ``gluon.data.vision`` and the
   DataLoader's worker processes, under TF32 off, f32. (b) The loader:
   ``VisionChain`` (a flip drawn from the seed and the sample index,
   HWC to CHW, /255, ImageNet's mean and std; numpy only) over
   ``SyntheticImageDataset(shape=(224, 224, 3))``, ``DataLoader(
   batch_size=64, shuffle=True, num_workers=4)``: one epoch bit for bit
   with ``num_workers=0``'s; ``transforms.Compose([ToTensor(),
   Normalize()])`` warns once and runs in a thread, bit for bit with the
   numpy chain without the flip; no worker reaches
   ``torch.cuda._lazy_init``; no segment left in ``/dev/shm``. Controls:
   batches yielded in completion order (the first batch slowed), and a
   worker creating a CUDA tensor, must be caught. (a) ``get_model(
   "vgg16", classes=1000)``, Xavier from ``--seed``, SGD lr 0.01,
   momentum 0.9, wd 5e-4: the first step against its float64 twin (the
   same weights, batch and dropout seeds, the plain dropout in f64)
   within ``VISION_TWIN``, a step whose two dropouts share one seed
   caught; ``VISION_STEPS`` steps eager, then hybridized (SGD fused into
   the backward's graph) from the same snapshot and seed, bit for bit,
   the loss falling; row 8 launched 4 times by an eager step and
   recorded 4 times into the graphs. (c) alexnet, vgg16_bn,
   mobilenet1_0, mobilenet_v2_1_0, densenet121, squeezenet1_0 and 1_1
   at 224^2, inception_v3 at 299^2, batch 32: each first step against
   its float64 twin, one SGD step, its row-8 launches. (d)
   ``BASELINE.json`` configs[0] through ``gluon.data.vision.MNIST``: idx
   files from ``--seed`` (training gzipped, test raw), train_mnist.py's
   ``to_float``, the MLP trained 2 epochs with ``num_workers=2``, every
   loss bit for bit with ``num_workers=0``. (e) ``Conv2DTranspose``
   (32, 512, 14, 14) -> (32, 256, 28, 28), kernel 4, stride 2, groups 1
   and 2, forward and backward against the float64 twin; the kernel left
   unflipped caught. (g) ms a VGG-16 step and images/s eager against
   hybridized in turns, one profiled step of each, the loop's wait on
   the loader at 4 workers and at 0, the graphs' and the peak memory,
   each family's step, row 8 at (64, 4096) f32 against its plain
   version, ``F.dropout`` and its byte bound (the ``dropout_vgg`` row),
   each line with the card's name, power limit and ``/dev/shm`` size.
   The rows gain ``launches_per_vision_step``, ``launches_per_family_step``
   and a ``vision`` entry in ``launches_per_compiled_capture``.
   ``vision_readings(seeds, card_line)`` prints the twin readings behind
   ``VISION_TWIN``.

16. imagenet — ``BASELINE.json`` configs[1] fed from a JPEG .rec as the
   reference feeds ImageNet (``bench.py``'s ``MXNET_BENCH_PIPELINE``):
   ``IMAGENET_RECORDS`` synthetic photos from ``--seed`` (smooth random
   fields plus noise, each side 300-500 px, labels 0-999) packed by
   ``recordio.pack_img`` at quality 95 into a temporary directory, read
   by ``io.ImageRecordIter`` (``IMAGENET_ITER``: resize 256, random
   224^2 crop, mirror, ImageNet's mean and std, shuffle, 4 threads,
   batch 128, seed ``--seed``). (a) The io library built from
   ``mxnet_tpu_torch/csrc/io.cc`` with g++ under
   ``mxnet_tpu_torch/_build/host/``: the libjpeg linked, its path, the
   build seconds; a build against ABI-80 headers must be refused when it
   loads. (b) ``DECODE_RECORDS`` records of one size, no resize, crop or
   mirror: the pixels bit for bit with ``cv2.imdecode`` in RGB (OpenCV's
   BGR must fail). (c) One epoch on the card bit for bit with the same
   iterator and seed on the CPU (batches uploaded from the previous
   staging slot must fail). (d) ``resnet50_v1`` as phase 11(c) trains it
   (bf16 AMP, hybridized net and loss, SGD 0.1 momentum 0.9 with the
   fused update, cuDNN's deterministic algorithms): ``IMAGENET_STEPS``
   steps fed by the iterator, then the same batches collected first
   from a second iterator with the same seed and replayed resident from
   the same snapshot: every loss and parameter bit for bit, the losses
   finite (two batches swapped must fail); the port's kernels launched
   in the fed run (none: the rows gain ``launches_per_fed_run``). (e)
   ``RAW_RECORDS`` raw 224^2 records as bench.py writes them: the
   pipeline's images/s at 1 and 4 threads, and the native producer's
   alone. (f) The JPEG pipeline's images/s at 1, 4 and
   ``os.cpu_count()`` threads; the fed step at 4 and at
   ``os.cpu_count()`` threads against the resident step in turns, with
   the loop's wait inside ``next()``; one profiled steady fed step and
   one resident (busy and idle share); the
   host's CPU count; each line with the card's name and power limit. To
   run it alone: ``python3 -c "import chip_smoke as cs; line =
   cs.phase_device(); cs.phase_imagenet(0, line)"``.

17. random — the creation and random ops: each sampler's draws held by
   a KS statistic or a chi-square, ``seed`` repeatable, a random block
   hybridized bit for bit with its eager twin, the norms and losses at
   full width card against CPU (``phase_random``).
18. ops tail — the rest of the op registry (``ops/tensor_tail.py``, the
   rest of ``ops/matrix.py`` with ``linalg_*``, five contrib ops,
   ``ops/vision_ops.py``) in f32 at the published widths of the public
   models that use it: SSD-300 (``ssd_300_vgg16_atrous_voc``:
   MultiBoxPrior over its six maps, 8732 anchors; MultiBoxTarget at
   batch 32 with 1-40 boxes an image; MultiBoxDetection at (32, 21,
   8732), NMS 0.45 over the top 400; box_iou, bipartite_matching,
   box_encode and box_decode on (32, 8732, 40); box_nms at (32, 8732)
   top 400 and (2, 8732) over all), Faster R-CNN and R-FCN (ROIAlign on
   (2, 1024, 38, 63) x 256 ROIs at 14 x 14, ROIPooling on (2, 512, 38,
   63) x 256 at 7 x 7, PSROIPooling on (1, 1029, 38, 63) x 300, 21 x 7 x
   7), Deformable ConvNets (both deformable 3 x 3 convolutions, 512 ->
   512, dilation 2, 4 groups, on (2, 512, 38, 63)), FlowNetC
   (Correlation, displacement 20, stride2 2, on two (8, 256, 48, 64)
   maps), the Transformer base (the encoder-decoder products at L 128, N
   32, 512 units, 8 heads; masked_softmax over (256, 128, 128)), the
   linalg family at (256, 64, 64) SPD and (32, 512, 512) against a
   float64 twin on the CPU (syevd and gelqf by reconstruction and
   orthogonality), the rest at ResNet-50's stage 1 and BERT-base's
   hidden states, LRN at AlexNet's conv1 and an FCN head's x32
   upsampling. Each output and gradient on the card against the same
   call on the port's CPU path: the group's largest max|got - ref| /
   max|ref| within ``OPS_TAIL_LIMIT`` (twice the largest reading of
   ``ops_tail_readings`` over seeds 0-4), and each group's planted
   fault beyond it. ROIPooling's separable form bit for bit with the
   reference's 6-D formulation at 8 ROIs, and the peak memory of both.
   The SSD head and an offset conv -> deformable conv -> ROIAlign block
   hybridized bit for bit with their eager twins; boolean_mask eager on
   the card, refused under capture. Each call's median time over
   ``--reps``, the peaks of the ROI, NMS and deformable calls, the
   phase's seconds. To run it alone: ``python3 -c "import chip_smoke as
   cs; line = cs.phase_device(); cs.phase_ops_tail(0, line)"``.

19. layout — the NHWC layout pass on the hybridized path
   (``MXNET_LAYOUT_OPT``, ``symbol/layout_opt.py``: an island opens
   for tensor-core data, 16-bit or f32 under TF32) and the S2D stem
   (``MXNET_CONV_S2D``). Phases 11, 15 and 18 keep their bit-for-bit
   checks of a hybridized conv net against its eager twin with the pass
   off (``layout_opt("0")``; their timings run on the default path);
   their twins with the pass on run here, each within ``LAYOUT_LIMIT``
   (twice the largest reading of ``layout_readings`` over seeds 0-4) and
   each with a planted fault (every 2-D convolution of a hybridized call
   reading its kernel mirrored) beyond it: phase 11's compiled bf16
   ResNet-50 v1 (128 x 224^2, 3 SGD steps: losses, parameters and the
   first gradients; every conv bias elided, exactly zero-gradient and
   unmoved) against the eager loop, and against the eager loop fed
   channels-last with its conv biases frozen (the same cuDNN kernels:
   every component, the fault beyond each), phase 15's VGG-16 (64 x
   224^2 f32, TF32 off, 2 steps) and phase 18's offset conv ->
   deformable conv -> ROIAlign block. Then the ResNet-50 step with the
   pass on and off in turns (ms, images/s, graph memory, one profiled
   step each way: kernels and cuDNN's layout-change kernels by name)
   and with the S2D stem on and off (ms, device busy), VGG-16's step
   both ways with TF32 off and on, the stem at (128, 3, 224, 224) bf16
   with S2D on and off (device time, the output's distance within
   ``LAYOUT_LIMIT["stem"]``), and a dropout after a channels-last conv
   (structured, and row 8's kernel) bit for bit with NCHW.
   ``layout_readings`` also prints the witness of the ResNet-50 gap
   (``_layout_witness``: the eager steps channels-last against NCHW in
   bf16 and in f32 with TF32 off, by kind of leaf).
20. engine — the dependency engine built from ``csrc/engine.cc`` with
   g++; the MNIST MLP with its rtc custom op (phase 9's net), three SGD
   steps with ``nd.Custom`` on the engine's workers bit for bit with the
   inline callback; a slow custom op (``ENGINE_SLOW_S`` of host work)
   beside ``ENGINE_MAIN_MATMULS`` bf16 matmuls on the main stream, wall
   time against the sum of the two apart (at most 75%); an exploding
   custom op raising at ``wait_to_read``, the context computing after
   it; the served BERT-base (8, 128) request and one eager ResNet-50 step
   under ``NaiveEngine`` bit for bit with the default, timed both ways.
   To run 19 and 20 alone: ``python3 -c "import chip_smoke as cs; line =
   cs.phase_device(); cs.phase_layout(0, line)"``; ``layout_readings(
   range(5), line)`` prints the readings behind ``LAYOUT_LIMIT``.
21. services — BERT-base (``bert_12_768_12``, dropout 0.1, bf16) with its
   dense MLM head over ``SERVICES_MASKED`` masked positions, one
   HybridBlock over token ids, hybridized with ``static_alloc`` with its
   ``SoftmaxCrossEntropyLoss``, trained by SGD with momentum 0.9 (the
   fused step) through ``gluon.contrib.estimator.Estimator.fit``: 2
   epochs of 4 batches of 32 x 128 from a ``DataLoader`` over tokens
   masked from ``--seed``, a checkpoint an epoch, with
   ``MXNET_TELEMETRY=1``, ``MXNET_MODELWATCH=1`` and the profiler running
   with ``profile_device=True``. Checked: ``mx_steps_total`` 8, no program
   recorded or recaptured by compilewatch after step ``SERVICES_WARM``,
   one host read in each steady step (``set_sync_debug_mode``, inside
   ``Trainer.step``, none outside it) and modelwatch's one read a step,
   the dumped trace (the phase spans, the engine's checkpoint ops, the
   device events of rows 1-8 by kernel name on the host clock), rows 1-8
   launched (the wrappers' counts and the graphs' capture records); the
   same run with every service off (in two fit calls) bit for bit in its
   losses, parameters and momenta, and the first run's epoch-1
   checkpoint bit for bit with its epoch-1 parameters. Printed: the phase
   p50s, ``mx_mfu`` and ``mx_goodput``, the FLOPs of a step beside 6 x
   parameters x tokens, the graphs' memory and capture seconds, the
   steady step with the services on against off in turns. Then at
   ``SERVICES_SMALL_LAYERS`` layers and full width: ``scaled_grad`` named
   by modelwatch as an exploding layer, ``nan_grad`` under ``skip_step``
   counted and debited from goodput, a raising guard's crash bundle,
   ``ckpt_write`` raising at ``wait_checkpoints``, and ``fit(resume=True)``
   with the newest ``.params`` truncated resuming from the one before, bit
   for bit with the uninterrupted run (dropout 0). To run it alone:
   ``python3 -c "import chip_smoke as cs; line = cs.phase_device();
   cs.phase_build(); cs.phase_services(0, line)"``.
22. serving stack — BERT-base (``bert_12_768_12``, bf16, drawn as phase 4
   draws it) behind the rest of serving. (a) ``SERVING_REQUESTS``
   requests from ``--seed`` (1-2 rows, lengths 16-128; the first one a
   sequence rung) through a ``serve.Scheduler`` at ``inflight`` 2 (a
   bucket's first batch, its capture, on the Scheduler's thread, the
   others on the native engine) for two tenants, ``free`` (weight 1,
   ``deadline_ms`` 200) and ``paid`` (weight 4), over a session with one
   batch bucket (``SERVING_BUCKETS``), the clients closed-loop: every
   served output bit for bit with ``sess.infer`` of the same request (the
   decoder output's own rows), rows 1, 3, 5 and 7 launched in the run
   (the wrappers' counts, the launches the replayed graphs carried),
   ``slo_report``, the heartbeat line, the bucket table, the forward
   against the output's host copy. (b) The weights published with
   ``model.save_checkpoint``; a ``ReplicaManager`` spawns
   ``SERVING_REPLICAS`` replica processes on the card
   (``chip_smoke:serving_replica``: each loads the checkpoint and
   captures its buckets before its lease, so a kernel that does not build
   fails its join) and ``SERVING_FLEET_REQUESTS`` requests go through a
   ``Router`` with ``MXNET_TRACE=1`` at sample rate 1, one replica
   SIGKILLed midway: every request completes once, its outputs and its
   own columns of the batch's decoder output within ``SLICE_RATIO`` of
   the plain path (phase 4's yardstick: its f32 twin) and bit for bit
   with the single-process session's; each replica's launches (its
   lease's ``mx_serve_kernel_launches`` gauges) nonzero; one assembled
   trace's critical path. (c) ``SERVING_FRONTEND`` 1-row requests through
   the HTTP ``Frontend`` equal the Router's answers, which equal the
   session's bit for bit; ``/metrics`` carries
   the replicas' series, ``/v1/trace/<id>`` the request's trace, an
   unknown id 404. Printed beside the card's line: latency p50/p99 per
   tenant through the Scheduler and the Router, the Router's wire cost a
   hop, where a routed request's time goes, the Frontend's cost a
   request. To run it alone: ``python3 -c "import chip_smoke as cs; line
   = cs.phase_device(); cs.phase_build(); cs.phase_serving(0, line)"``.

23. data parallel — training through the kvstore, each part's ranks
   started by ``python -m mxnet_tpu_torch.tools.launch`` running
   ``dp_worker``. (a) Two ranks of ``bert_12_768_12`` with the dense
   MLM head of phase 21 (f32 parameters under bf16 AMP: the attention
   kernel takes 16-bit data; TF32 off), both on the one card, so the
   group is gloo (NCCL refuses two ranks on one card), ``Trainer(...,
   kvstore="dist_sync")``, SGD with momentum, ``DP_ROWS`` x 128 a rank,
   a warm-up and ``DP_STEPS`` steps, at dropout 0 and again at 0.1: the
   ranks begin and end bit for bit equal (parameters and momenta), rows
   1-7 launched on each rank (row 8 too at dropout 0.1), the
   cross-process all-reduce in commwatch's report (bytes, algbw, busbw,
   exposed seconds), the steps timed; rank 0 then trains one process on
   the concatenated batch without a kvstore, and the change of the
   dropout-0 run's parameters must lie within ``DP_TOL`` of it (relative
   L2); a control with the cross-process sum planted away must fail
   both checks. (d) In the same group, with ``MXNET_GUARD_COMM_VOTE=1`` and
   ``nan_grad`` armed on rank 1 only, both ranks raise
   NonFiniteGradientError naming rank 1. (b) One rank on NCCL: the same
   model through ``dist_sync``, ``p3store_dist`` (slices of
   ``DP_P3_BOUND`` elements) and no kvstore, all three bit for bit. (c)
   In this process, 2 layers at full width in f32 over ``[gpu(0),
   cpu(0)]`` with ``kvstore="device"``: the replicas equal and within
   ``DP_CTX_TOL`` of the one-context run on the concatenated batch; on
   two cards also ``[gpu(0), gpu(1)]`` through the grouped NCCL reduce,
   else a line says it did not run. To run it alone: ``python3 -c
   "import chip_smoke as cs; line = cs.phase_device(); cs.phase_build();
   cs.phase_dp(0, line)"``; ``dp_readings(range(5), line)`` prints the
   readings behind ``DP_TOL``.
24. the sharded step — ``parallel.ShardedTrainStep`` on the card. (a)
   ``tools/bert_bench.py``'s pinned configuration: BERT-base without
   pooler, classifier and decoder, the chunked ``BERTMLMLoss`` head
   (bert_bench's mean), LAMB lr 1e-3 wd 0.01, ``dtype="bfloat16"``, 3
   inputs replicated, 32 x 128 on ``make_mesh(MeshConfig(dp=1),
   devices=[gpu(0)])``: at dropout 0, against the plain versions, the
   first step's gradients (SGD at lr 1) within ``SHARD_TOL["bert_grads"]``
   and ``SHARD_PARITY_STEPS`` captured LAMB steps' change within
   ``SHARD_TOL["bert"]`` (relative L2), a control with every LayerNorm
   kernel's output ``SHARD_FAULT`` times its own caught by the first; at
   dropout 0.1 the main run (the counts from 0: the
   warm-up, the capture, ``SHARD_STEPS`` timed replays): the step's
   median (CUDA events), host reads in a steady step (0), the graph's
   MB, rows 1-8's launches in the one-step graph and over the run; at lr
   0 three steps whose losses differ (the masks move on each replay);
   ``save_states``, 2 steps, ``load_states``, 2 steps bit for bit. (b)
   ``bench.py``'s headline: ``resnet50_v1``, SGD lr 0.1 momentum 0.9,
   bf16, 128 x 224^2 resident, the layout pass on. On bench.py's uniform
   batch and on phase 11's normal one, the first update (eager, before
   the weights go channels-last) against ``MXNET_LAYOUT_OPT=0``: the
   loss bit for bit, exactly the ``SHARD_BIASES`` conv biases still,
   the change within ``SHARD_TOL["resnet"]``, printed beside its
   witness (the pass off on the same batch in reverse sample order) by
   kind and by stage. The hoisted step against a twin that converts its
   weights in every step, under deterministic cuDNN: 3 steps (eager,
   capture, replay) bit for bit, no conversion in the hoisted capture,
   and the twin's profiled replay running exactly its conversions'
   number of copy kernels more. The
   step's median; no port kernel launched. (c) Two processes sharing
   the card over gloo (``shard_worker`` through the port's launcher), a
   mesh across them, BERT at ``SHARD_TWO_LAYERS`` layers and full width,
   LAMB in bf16, ``SHARD_TWO_ROWS`` x 128 a rank, the sum of the
   per-position losses: the step split around the cross-process reduce,
   both ranks bit for bit, within ``SHARD_TOL["two"]`` of one process on
   the joined batch, the all-reduce in commwatch's report (bytes,
   GB/s); in the same launch, a control (a fresh step with the
   cross-process sum planted away) caught. Alone: ``python3 -c "import
   chip_smoke as cs; line = cs.phase_device(); cs.phase_build();
   cs.phase_sharded(0, line)"``;
   ``shard_readings(range(5), line)`` prints the readings behind
   ``SHARD_TOL``.
25. ZeRO, the quantized wire and elastic resharding over ``[gpu(0),
   cpu(0)]`` (``phase_zero``); after (a), one more step of its
   replicated Trainer (``NOISE_ROWS`` rows a replica, the first shared,
   modelwatch on) gives phase 26 (e)'s noise scale.
26. the rest of multi-GPU over ``[gpu(0), cpu(0)]`` (``phase_multi``),
   f32 with TF32 off, each reading beside its limit: (a) ring attention,
   causal and not, and Ulysses attention at B ``MULTI_B``, T
   ``MULTI_T`` (half a device), 12 heads of 64 over ``sp=2``, the output
   and the q, k, v gradients against the card alone; (b)
   ``make_moe_layer`` at d 768, d_hidden 3072, ``ep=2``,
   ``MOE_TOKENS`` tokens a device, against the dense per-token expert,
   and at capacity ``MOE_CAP`` the dropped rows zero and as many as the
   host counts; (c) ``make_pipeline_step`` with ``pp=2``, a
   ``BERTEncoderCell`` a stage, ``PIPE_MICRO`` microbatches of
   ``PIPE_MB``, ``PIPE_STEPS`` SGD steps against the two layers in
   sequence on the card, the card stage's launches; (d) BERT-base
   without decoder served over the mesh on ``mp`` (the FFN weights
   split, the request split by ``data_spec``) against the unsharded
   session on the card, ``refresh_weights`` after halving the weights,
   a Scheduler at in-flight 2 pushing with the collective descriptor
   while ``engine_collective_overlap`` strips its lock; (e) phase 25's
   noise scale, gauge and suggested batch against the formula over its
   noise step's replica gradients read on the host, rtol
   ``NOISE_RTOL``; (f) phase 23's two ranks:
   int8 ``dist_sync`` against the in-process device store over the
   same values, and its wire bytes. Alone (without (e) and (f)):
   ``python3 -c "import chip_smoke as cs; line = cs.phase_device();
   cs.phase_build(); cs.phase_multi(0, line, None, None)"``.
27. autotune and perfwatch (``phase_autotune``): ``MXNET_AUTOTUNE=
   measure`` into a fresh ``MXNET_AUTOTUNE_CACHE`` under a temporary
   directory. Every tunable launch is consulted once through its own
   wrapper (its candidates timed in paired rounds with CUDA events,
   uncounted): the LayerNorm forward at BERT-base's served (8 x 128)
   and trained (32 x 128) rows, its backward, attention at (32, 128) p
   0.1 through the op's consult, bias+GeLU forward and backward,
   bias+residual, dropout, ``dual_bwd`` at ResNet-50's stage-1 and
   stage-4 shapes (``AUTOTUNE_DUAL``) and the CE chunk over the
   30522-word vocab. For each, the default plan, the tuned plan and
   both CUDA-event medians of ``AUTOTUNE_REPS`` calls; the tuned plan
   and an alternative held against the default plan's outputs and the
   plain version (bit for bit where a row's work is the same on every
   plan, the summed rows within ``AUTOTUNE_SUM_TOL`` of their largest
   sum, attention at p 0.1 against the plain version at the same head
   block, the CE loss within ``HEAD_LOSS_TOL``); the launch counts of
   that run (reset just before, read just after); the table reloaded
   from the file in a new lookup without tuning; a bogus entry planted
   (a warning, the default runs); the timings as one bench-JSON record
   in a temporary ``MXNET_PERF_DB`` under the card's name, and the
   trend report's row. Alone: ``python3 -c "import chip_smoke as cs;
   line = cs.phase_device(); cs.phase_build(); cs.phase_autotune(0,
   line)"``.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

# published peaks of the card, dense, by product name (NVIDIA data sheets)
_PEAKS = {
    # name fragment: (bytes/s of device memory, bf16 tensor FLOP/s,
    #                 f32 FLOP/s outside the tensor cores)
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100": (3.35e12, 989e12, 67e12),
}

# parity tolerances in bf16, elementwise |got - ref| <= atol + rtol*|ref|.
# One kernel against its plain version: the two differ only in the
# order of f32 sums, so at most an ulp or two of bf16 (2^-8 relative).
KERNEL_ATOL = KERNEL_RTOL = 1e-2
# The training kernels keep their plain versions' rounding points, so all
# but a few elements come out bit-equal (sums in another order flip a
# bf16 rounding now and then); a misplaced rounding point, such as the
# attention's dV taken from a bf16 Pd, leaves about 86% equal (measured
# against the reference on the CPU), which the tolerance above misses.
KERNEL_EQUAL = 0.99
# The served model against itself with the plain versions: one-ulp flips
# in one layer's bf16 output are rounded again by every later layer. The
# yardstick is what bf16 arithmetic itself costs: the same model (its
# bf16 weights widened) run in f32 with the plain versions. Each output of
# the kernel path may differ from the plain bf16 path by at most
# SLICE_RATIO times the plain bf16 path's own difference from f32, in max
# abs error and in relative L2 error alike. On an H100 the ratio read
# 0.36-1.59 over seeds 0-4, and 15-56 with bias_residual's bias dropped
# (the control); the limit is twice the largest correct reading.
SLICE_RATIO = 3.2
# The training step against itself with the plain versions, per
# parameter gradient and for the loss, with the same yardstick: the plain
# bf16 step's own distance from its f32 twin. On an H100 the largest of
# the 156 ratios read 1.44, 1.79, 1.45, 1.28 and 1.30 for seeds 0-4
# (medians 0.78-1.04), and 56-229 on the 12 ffn_1 biases with
# bias+GeLU's db dropped (the control); the limit is twice the largest
# correct reading.
TRAIN_RATIO = 3.6
# one training step of bert_12_768_12 at dropout 0.1 with BERTMLMLoss:
# 12 layers x 2 LayerNorms + the embedding's + the MLM head's; proj
# always fuses its residual, ffn_2 does not when dropout > 0; dropout
# after the embedding and in each FFN, each forward and backward
TRAIN_LAUNCHES = {"layer_norm_fwd": 26, "layer_norm_bwd": 26,
                  "selfatt_fwd": 12, "selfatt_bwd": 12,
                  "bias_gelu_fwd": 12, "bias_gelu_bwd": 12,
                  "bias_residual_fwd": 12, "dropout": 26, "dual_bwd": 0}
TRAIN_FWD_DROPOUT = 13
# the redesigned kernels' bf16 vector instances, by a regular expression
# over the mangled name, and the elements one pass of each one's row loop
# takes: the epilogues (csrc/epilogue.cu) 2 rows x 8 columns a thread;
# the LayerNorm forward's register path (csrc/layer_norm.cu) a row of 3 x
# 8 columns a lane (its loop leaves out the set-up before it, gamma's and
# beta's loads and the first row's, which a warp runs once for its one or
# two rows)
GELU_FWD_SASS, GELU_FWD_PASS = (
    r"bias_fwd_kernelI13__nv_bfloat16Li8E.*13bias_gelu_fwdE", 16)
RESIDUAL_SASS, RESIDUAL_PASS = (
    r"bias_fwd_kernelI13__nv_bfloat16Li8E.*17bias_residual_fwdE", 16)
GELU_BWD_SASS, GELU_BWD_PASS = "bias_gelu_bwd_kernelI13__nv_bfloat16Li8EE", 16
LN_FWD_SASS, LN_FWD_PASS = "layer_norm_fwd_rowsI13__nv_bfloat16Li3EE", 24
TRAIN_BATCH, TRAIN_SEQ, VOCAB = 32, 128, 30522
UNITS, HIDDEN, HEADS, HEAD_DIM = 768, 3072, 12, 64
# ResNet-50 v1's fused stages as tools/layout_exp.py mode hwnc5 runs them
# (HWNC, bf16, batch 32 at 224^2): stage 1 fuses its three blocks, the
# first with the downsample; stages 2-4 fuse the stride-1 blocks after
# their stride-2 entry block. (blocks, input channels, bottleneck width,
# output channels, side)
STAGES = ((3, 64, 64, 256, 56), (3, 512, 128, 512, 28),
          (5, 1024, 256, 1024, 14), (2, 2048, 512, 2048, 7))
STAGE_BATCH = 32
# dual_bwd per stage backward: tail and head of every block, and the
# downsample of stage 1's first
STAGE_LAUNCHES = 7 + 6 + 10 + 4
# The fused stages with the kernel against the same stages with the plain
# version, per output and gradient, with the plain bf16 stages' distance
# from their f32 twin (no bf16 rounding, no TF32) as the yardstick. On
# an H100 the largest of the 128 ratios read 0.0335, 0.0326, 0.0333,
# 0.0396 and 0.0417 for seeds 0-4, and 3 or more on 80-83 of them with
# the head kernels' shortcut gradient dropped (the control); the limit is
# twice the largest correct reading.
STAGE_RATIO = 0.084
# ResNet-50 v1 trained through Gluon (bench.py's headline loop without
# AMP or hybridize): batch 128 at 224^2, bf16 with BN in f32, SGD lr 0.1
# momentum 0.9. One step's gradients against the same step's f32 twin,
# per parameter, relative L2, and its loss. At MSRAPrelu init, 50 layers
# of bf16 rounding leave the gradients far from f32 (on an H100 the
# median array read 1.3 and the largest, the stem BatchNorm's beta,
# 4.87, 4.46, 4.08, 4.69 and 4.63 for seeds 0-4), while the loss agrees
# closely (relative differences 0.00173, 0.00231, 0.00314, 0.00232 and
# 0.000727; 0.87-1.15 with BatchNorm's shift dropped, the control). Each
# limit is twice the largest correct reading.
RESNET_BATCH, RESNET_SIDE = 128, 224
RESNET_REL_L2 = 9.74
RESNET_LOSS_REL = 0.0063
# SGD at lr 0.1 without warmup overshoots after a few steps on one
# batch; the loss must fall by at least this much below the first step's
# at some step (on an H100 it fell by 2.44-2.69 by the third step, seeds
# 0-4)
RESNET_FALL = 1.0
# The AMP step (bf16 compute over f32 parameters, the chunked head)
# against itself with the plain versions, per parameter gradient and for
# the loss, with the plain AMP step's own distance from the same step in
# f32 without AMP (plain versions, TF32 off) as the yardstick. On an H100
# (full runs, --seed 0 to 4) the largest of the 156 ratios read 0.893,
# 0.86, 0.906, 0.829 and 0.975 (medians 0.475-0.528), and 34-129 on the
# 25 LayerNorm gammas of bf16 x with the LayerNorm backward's dgamma
# dropped there (the control); the limit is twice the largest correct
# reading.
AMP_RATIO = 1.95
# The chunked head against the full-vocab head on the same bf16 hidden
# states: tests/test_chunked_ce.py's bf16 tolerances, the loss within
# 1e-5 (abs + rel) and each gradient's max abs error below 1e-2 of its
# largest magnitude. On an H100 (seeds 0-4) the loss read at most 0.021
# of its limit and dh 0.0065-0.0067 (one bf16 ulp of dh where it is
# near the bottom of its binade, 2^-7 relative), dW 2e-5-4.2e-5, db
# below 1.3e-6; with 0 pad logits (the control) the loss 573-599 times
# its limit and dW, db 0.041-0.057.
HEAD_LOSS_TOL, HEAD_GRAD_TOL = 1e-5, 1e-2
# the LayerNorms of one AMP step by (x, gamma) dtype: the embedding's in
# f32, the rest (two a layer and the MLM head's) on bf16 x, f32 gamma
AMP_LN_INSTANCES = {"x float32, gamma float32": 1,
                    "x bfloat16, gamma float32": 25}
# BERT's linear warmup and decay (pwr 1), with LAMB at lr 1e-3
AMP_POLY = {"max_update": 100, "warmup_steps": 2, "pwr": 1}
AMP_STEPS = 10
# the float16 run plants its inf at step FP16_STEPS // 2
FP16_LAYERS, FP16_STEPS = 2, 6
DEV = "cuda"


class SmokeFailure(Exception):
    pass


def _peaks(name):
    for frag, peaks in _PEAKS.items():
        if frag in name:
            return peaks
    raise SmokeFailure("no published peaks for card %r" % name)


def _compare(what, got, ref, atol, rtol):
    """(max abs error, relative L2 error, whether beyond tolerance)."""
    import torch
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise SmokeFailure("%s: shape %s != %s" % (what, tuple(got.shape),
                                                   tuple(ref.shape)))
    if not torch.isfinite(got).all():
        raise SmokeFailure("%s: non-finite values" % what)
    err = (got - ref).abs()
    bad = int((err > atol + rtol * ref.abs()).sum())
    l2 = float(err.norm() / ref.norm().clamp_min(1e-30))
    return float(err.max()), l2, bool(bad)


def _check_close(what, got, ref, atol, rtol, min_equal=None):
    """Elementwise tolerance; with ``min_equal``, also the least share of
    elements that must be bit-equal."""
    max_err, l2, fail = _compare(what, got, ref, atol, rtol)
    equal = ""
    if min_equal is not None:
        share = float((got == ref).float().mean())
        fail = fail or share < min_equal
        equal = " equal=%.5f (>= %g)" % (share, min_equal)
    print("[parity] %-44s max_abs_err=%.3g rel_l2=%.3g tol=%.3g+%g*|ref|%s %s"
          % (what, max_err, l2, atol, rtol, equal, "FAIL" if fail else "ok"))
    if fail:
        raise SmokeFailure("%s: beyond tolerance, max_abs_err %.3g%s"
                           % (what, max_err, equal))
    return max_err


def order_limit(got, ref, wit, atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
    """The elementwise limit on a kernel that sums its products in
    another f32 order than its plain version ``ref``: |got - ref| <=
    tol(ref) + |ref - wit| at every element, with tol(ref) = atol + rtol *
    |ref| and ``wit`` the same plain version with its products and row
    sums summed in float64 (``sum_dtype=torch.float64``), which depends
    on no summation order. Where the two plain versions agree the limit
    is tol itself; where they differ it widens by exactly their
    difference, and nowhere else. (For bf16, tol is tests/test_torch_cuda.py's bound: one ulp,
    at most 2^-7 |ref|, never exceeds 1e-2 |ref|.) Returns (elements
    beyond the limit, a non-finite one among them; elements where |ref -
    wit| > tol; the largest |got - ref| at those elements, 0 where there
    are none)."""
    got, ref, wit = (t.float() for t in (got, ref, wit))
    tol = atol + rtol * ref.abs()
    gap = (ref - wit).abs()
    err = (got - ref).abs()
    beyond = int((~(err <= tol + gap)).sum())
    apart = gap > tol
    there = float(err[apart].max()) if bool(apart.any()) else 0.0
    return beyond, int(apart.sum()), there


def _check_order(what, got, ref, wit, min_equal=None):
    """order_limit, and with ``min_equal`` the least share of elements
    that must equal ``ref`` bit for bit; prints the readings."""
    beyond, apart, there = order_limit(got, ref, wit)
    max_err = float((got.float() - ref.float()).abs().max())
    fail = bool(beyond)
    equal = ""
    if min_equal is not None:
        share = float((got == ref).float().mean())
        fail = fail or share < min_equal
        equal = " equal=%.5f (>= %g)" % (share, min_equal)
    print("[parity] %-44s max_abs_err=%.3g; plain f32 vs float64-summed "
          "apart beyond tol at %d, max_abs_err there %.3g; beyond "
          "tol+|ref-wit| %d%s %s" % (what, max_err, apart, there, beyond,
                                     equal, "FAIL" if fail else "ok"))
    if fail:
        raise SmokeFailure("%s: beyond the order limit at %d elements%s"
                           % (what, beyond, equal))
    return max_err


def _slice_check(tag, what, out, ref, anchor, limit=SLICE_RATIO,
                 quiet=False):
    """Hold one output of the kernel path against the plain path's, with
    the plain path's distance from f32 as the yardstick; returns (ratio,
    fail). Arrays may be numpy or torch."""
    import torch
    o, r, a = (torch.as_tensor(x).float() for x in (out, ref, anchor))
    got_max, got_l2, _ = _compare(what, o, r, 0.0, 0.0)
    bf16_max, bf16_l2, _ = _compare(what + " (plain path)", r, a, 0.0, 0.0)
    ratio = max(got_max / max(bf16_max, 1e-30), got_l2 / max(bf16_l2, 1e-30))
    fail = ratio > limit
    verdict = (("caught" if fail else "MISSED") if tag == "control"
               else ("FAIL" if fail else "ok"))
    if fail or not quiet:
        print("[%s] %-34s max_abs_err=%.3g rel_l2=%.3g; plain bf16 vs f32: "
              "max_abs_err=%.3g rel_l2=%.3g; ratio %.3g (limit %g) %s"
              % (tag, what, got_max, got_l2, bf16_max, bf16_l2, ratio,
                 limit, verdict))
    return ratio, fail


def _gpu_ms(fn, reps, trials=7):
    """Median device time of one ``fn()`` call: the launches are queued
    behind a sleeping kernel, so the events time the card, not the
    host's enqueue rate."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print("[device] %s" % line)
    print("[device] torch %s cuda %s, %d device(s), running on %s"
          % (torch.__version__, torch.version.cuda,
             torch.cuda.device_count(), torch.cuda.get_device_name(0)))
    return line


def phase_build():
    from mxnet_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    paths = cuda_build.build()
    info = cuda_build.build_info()
    print("[build] %d sources in %.1f s (%s) into %s"
          % (len(paths), time.perf_counter() - t0,
             "compiled " + ", ".join(info["built"]) if info else "reused",
             paths[cuda_build.SOURCES[0]].parent))
    for src, log in sorted(info.get("logs", {}).items()):
        if src == "selfatt.cu":
            continue
        for _, name, regs, spills, smem in _ptxas_report(log):
            print("[build] %s %s: %s registers, spill stores/loads %s bytes, "
                  "shared memory %s bytes" % (src, name, regs,
                                              "/".join(spills), smem))
    if "selfatt.cu" in info.get("logs", {}):
        from mxnet_tpu_torch.ops import cuda_attention
        lib = cuda_attention._lib()
        for name, args, regs, spills in _selfatt_kernels(
                info["logs"]["selfatt.cu"]):
            # mxt_selfatt_smem's kernel numbers
            which = {"selfatt_fwd_kernel": 0, "selfatt_bwd_kv_kernel": 2}.get(
                name, 3 if "true" in args else 1)
            print("[build] attention %s<%s>: %s registers, spill stores/"
                  "loads %s bytes, dynamic shared memory %d bytes"
                  % (name, ", ".join(args), regs, "/".join(spills),
                     lib.mxt_selfatt_smem(which, int(args[0]))))


def _ptxas_report(log):
    """[(mangled name, name, registers, [spill stores, spill loads],
    static shared memory bytes)] of every entry function in the
    ``-Xptxas -v`` report of one source; the name demangled where c++filt
    is at hand, else the mangled one."""
    import re
    import shutil
    out = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            out.append([m.group(1), m.group(1), "?", ["?", "?"], "0"])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and out:
            out[-1][3] = [m.group(1), m.group(2)]
        m = re.search(r"Used (\d+) registers", ln)
        if m and out:
            out[-1][2] = m.group(1)
            m = re.search(r"(\d+) bytes smem", ln)
            out[-1][4] = m.group(1) if m else "0"
    cxxfilt = shutil.which("c++filt")
    if out and cxxfilt:
        names = subprocess.run([cxxfilt], input="\n".join(r[0] for r in out),
                               capture_output=True, text=True, timeout=60)
        for r, name in zip(out, names.stdout.splitlines()):
            r[1] = re.sub(r"\(anonymous namespace\)::|\(.*\)$|^void ", "",
                          name)
    return [tuple(r) for r in out]


def _launch_ms(fn, reps):
    """Device time of each kernel ``fn()`` launches, by name, in ms per
    ``fn()`` call, from torch.profiler over ``reps`` calls (empty when
    the profiler sees no device kernel)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(3):      # the profiler now and then returns no events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = re.sub(r"\(anonymous namespace\)::|\(.*\)$|^void ", "",
                          ev.name)
            us = ev.device_time_total if hasattr(ev, "device_time_total") \
                else ev.cuda_time_total
            out[name] = out.get(name, 0.0) + us / 1e3 / reps
        if out:
            break
    return out


def _sass_per_element(lib_path, fragment, per_pass):
    """Instructions an element costs in the kernel whose mangled name
    matches the regular expression ``fragment``, counted from ``cuobjdump
    -sass`` of the built library ``lib_path``: those of its longest loop
    (of the whole kernel where it has none) over ``per_pass``, the
    elements one pass of that code takes; no-ops left out, both arms of a
    branch counted. None where cuobjdump is not at hand or no kernel
    matches. The count is static: it says what one pass issues, not how
    often a branch is taken."""
    import re
    import shutil
    from pathlib import Path
    from mxnet_tpu_torch.ops import cuda_build
    tool = shutil.which("cuobjdump") or str(
        Path(cuda_build._nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300).stdout
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        if not re.search(fragment, func.split(None, 1)[0]):
            continue
        at, ins = {}, []         # branch target (label or address) -> index
        for ln in func.splitlines():
            m = re.match(r"\s*(\.L_x_\d+):", ln)
            if m:
                at[m.group(1)] = len(ins)
                continue
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", ln)
            if m:
                at["0x%x" % int(m.group(1), 16)] = len(ins)
                ins.append(m.group(2).strip())
        real = [0 if re.search(r"\bNOP\b", t) else 1 for t in ins]
        loops = []
        for i, t in enumerate(ins):
            m = re.search(r"\bBRA\b\s*`?\(?(\.L_x_\d+|0x[0-9a-f]+)", t)
            j = at.get("0x%x" % int(m.group(1), 16)
                       if m and m.group(1).startswith("0x")
                       else m and m.group(1))
            if j == i:                          # the padding after EXIT
                real[i] = 0
            elif j is not None and j < i:
                loops.append(sum(real[j:i + 1]))
        return (max(loops) if loops else sum(real)) / per_pass
    return None


def _issue_ms(per_element, n, sms, clock_mhz):
    """The least time ``n`` elements of ``per_element`` instructions take
    to issue: one instruction a lane a cycle on the card's sms x 128
    lanes at its highest SM clock."""
    if per_element is None or not clock_mhz:
        return None
    return per_element * n / (sms * 128 * clock_mhz * 1e6) * 1e3


def _max_sm_clock():
    """The card's highest SM clock in MHz (nvidia-smi), None if unread."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _issue_floor(row, source, fragment, per_pass, n):
    """Add a redesigned kernel's issue floor to its row of times (the SASS
    of ``fragment`` in the library of ``source``), and print it."""
    import torch
    from mxnet_tpu_torch.ops import cuda_build
    per = _sass_per_element(cuda_build.build()[source], fragment, per_pass)
    clock = _max_sm_clock()
    row["sass_per_element"] = per
    row["issue_ms"] = _issue_ms(per, n, cuda_build.sm_count(
        torch.device(DEV)), clock)
    print("[times] %s issue floor: %s SASS instructions an element, %s ms at "
          "%s MHz (bytes bound %.4f ms)" % (
              row["name"], "not measured" if per is None else "%.2f" % per,
              "not measured" if row["issue_ms"] is None
              else "%.4f" % row["issue_ms"], clock, row["bound_ms"]))


def _bias_shift(x, b, dy=None, r=None):
    """The bias+GeLU kernel, forward (or backward, given ``dy``), or the
    bias+residual kernel (given ``r``), with the bias read one column
    off: the planted fault, through ``mxt_bias_gelu_{fwd,bwd}_bias_shift``
    and ``mxt_bias_residual_fwd_bias_shift``. Returns y, or (dx, db)."""
    import torch
    from mxnet_tpu_torch.ops import cuda_build as cb, cuda_epilogue as ce
    lib = ce._lib()
    M, C = x.shape
    code = cb.DTYPE_CODES[x.dtype]
    sms = cb.sm_count(x.device)
    if r is not None:
        out = torch.empty_like(x)
        rc = lib.mxt_bias_residual_fwd_bias_shift(
            x.data_ptr(), b.data_ptr(), r.data_ptr(), out.data_ptr(), M, C,
            sms, code, code, 1, cb.stream_of(x))
    elif dy is None:
        out = torch.empty_like(x)
        rc = lib.mxt_bias_gelu_fwd_bias_shift(
            x.data_ptr(), b.data_ptr(), out.data_ptr(), M, C, sms, code,
            code, 1, cb.stream_of(x))
    else:
        out = (torch.empty_like(x), torch.empty_like(b))
        part = torch.empty(ce.bwd_scratch_shape(M, C, x.dtype, True, sms),
                           dtype=torch.float32, device=x.device)
        rc = lib.mxt_bias_gelu_bwd_bias_shift(
            dy.data_ptr(), x.data_ptr(), b.data_ptr(), out[0].data_ptr(),
            part.data_ptr(), part.shape[0], out[1].data_ptr(), M, C, sms,
            code, code, 1, cb.stream_of(x))
    if rc:
        raise SmokeFailure("bias-shift control: launch failed (%d)" % rc)
    torch.cuda.synchronize()
    return out


def _gamma_shift(x, g, b):
    """The LayerNorm forward with gamma read one column off: the planted
    fault, through ``mxt_layer_norm_fwd_gamma_shift``. Returns y."""
    import torch
    from mxnet_tpu_torch.ops import cuda_build as cb, cuda_norm
    M, C = x.shape
    y = torch.empty_like(x)
    rc = cuda_norm._lib().mxt_layer_norm_fwd_gamma_shift(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), M, C, 1e-5,
        cb.DTYPE_CODES[x.dtype], cb.DTYPE_CODES[g.dtype],
        cb.sm_count(x.device), 1, cb.stream_of(x))
    if rc:
        raise SmokeFailure("gamma-shift control: launch failed (%d)" % rc)
    torch.cuda.synchronize()
    return y


def _must_fail(what, check):
    """A control: ``check()`` must raise SmokeFailure."""
    try:
        check()
    except SmokeFailure:
        print("[control] %s: caught" % what)
        return
    raise SmokeFailure("control: the parity check passed %s" % what)


def _selfatt_kernels(log):
    """[(kernel, template arguments, registers, [spill stores, spill
    loads])] of the attention kernels in the ``-Xptxas -v`` report of
    selfatt.cu, the template arguments read from the mangled names."""
    import re
    out = []
    for mangled, _, regs, spills, _ in _ptxas_report(log):
        m = re.search(r"(selfatt_(?:fwd|bwd_q|bwd_kv)_kernel)I"
                      r"((?:L[ib]\d+E)+)E", mangled)
        if m:
            args = [("true" if v == "1" else "false") if k == "b" else v
                    for k, v in re.findall(r"L([ib])(\d+)E", m.group(2))]
            out.append((m.group(1), args, regs, spills))
    return out


def _randn(seed):
    """A bf16 normal sampler on the card, seeded."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=DEV)
                * scale).to(torch.bfloat16)
    return randn


def phase_parity(seed):
    """Each kernel against its plain version; returns {kernel: err}."""
    from mxnet_tpu_torch.ops import cuda_attention, cuda_epilogue, cuda_norm
    randn = _randn(seed)
    errs = {}
    x, g, b = randn(1024, 768), randn(768), randn(768)
    ref = cuda_norm.layer_norm_plain(x, g, b, 1e-5)
    errs["layer_norm_fwd"] = _check_close(
        "layer_norm_fwd (1024, 768)",
        cuda_norm.layer_norm_cuda(x, g, b, 1e-5), ref,
        KERNEL_ATOL, KERNEL_RTOL, KERNEL_EQUAL)
    _must_fail("layer_norm_fwd with gamma one column off", lambda: (
        _check_close("control: layer_norm_fwd, gamma shifted",
                     _gamma_shift(x, g, b), ref, KERNEL_ATOL, KERNEL_RTOL,
                     KERNEL_EQUAL)))
    x, b = randn(1024, 3072, scale=2.0), randn(3072)
    ref = cuda_epilogue.bias_gelu_plain(x, b)
    errs["bias_gelu_fwd"] = _check_close(
        "bias_gelu_fwd (1024, 3072)", cuda_epilogue.bias_gelu_cuda(x, b),
        ref, KERNEL_ATOL, KERNEL_RTOL, KERNEL_EQUAL)
    _must_fail("bias_gelu_fwd with its bias one column off", lambda: (
        _check_close("control: bias_gelu_fwd, bias shifted", _bias_shift(x, b),
                     ref, KERNEL_ATOL, KERNEL_RTOL, KERNEL_EQUAL)))
    # bias+residual keeps the plain version's two adds in their order:
    # every element bit for bit
    x, b, r = randn(1024, 768), randn(768), randn(1024, 768)
    ref = cuda_epilogue.bias_residual_plain(x, b, r)
    errs["bias_residual_fwd"] = _check_close(
        "bias_residual_fwd (1024, 768)",
        cuda_epilogue.bias_residual_cuda(x, b, r), ref,
        KERNEL_ATOL, KERNEL_RTOL, 1.0)
    _must_fail("bias_residual_fwd with its bias one column off", lambda: (
        _check_close("control: bias_residual_fwd, bias shifted",
                     _bias_shift(x, b, r=r), ref, KERNEL_ATOL, KERNEL_RTOL,
                     1.0)))
    for L, N, heads in ((128, 8, 12), (127, 8, 12), (128, 8, 5)):
        qkv = randn(L, N, heads * 3 * 64)
        err = _check_close(
            "selfatt_fwd L=%d N=%d heads=%d hd=64" % (L, N, heads),
            cuda_attention.selfatt_cuda(qkv, heads),
            cuda_attention.selfatt_plain(qkv, heads),
            KERNEL_ATOL, KERNEL_RTOL)
        if (L, N, heads) == (128, 8, 12):
            errs["selfatt_fwd"] = err
    return errs


@contextlib.contextmanager
def _plain_kernels(f32_twin=False):
    """Swap each kernel wrapper, forward and backward, for its plain
    version (the slices' reference runs on the card). ``f32_twin`` also
    sends f32 attention to the plain kernel functions with their bf16
    rounding points dropped, so that the f32 yardstick draws the same
    dropout masks (the op would run its composition for f32), and runs
    the fused stages' dual backward in f32 without its bf16 roundings."""
    import functools
    from unittest import mock
    from mxnet_tpu_torch.ops import (cuda_attention, cuda_dropout,
                                     cuda_epilogue, cuda_fused, cuda_norm)
    swaps = [(cuda_norm, "layer_norm", cuda_norm.layer_norm_plain),
             (cuda_norm, "layer_norm_bwd", cuda_norm.layer_norm_bwd_plain),
             (cuda_attention, "selfatt", cuda_attention.selfatt_plain),
             (cuda_attention, "selfatt_bwd",
              cuda_attention.selfatt_bwd_plain),
             (cuda_epilogue, "bias_gelu", cuda_epilogue.bias_gelu_plain),
             (cuda_epilogue, "bias_gelu_bwd",
              cuda_epilogue.bias_gelu_bwd_plain),
             (cuda_epilogue, "bias_residual",
              cuda_epilogue.bias_residual_plain),
             (cuda_dropout, "dropout", cuda_dropout.dropout_plain),
             (cuda_fused, "dual_bwd", cuda_fused.dual_bwd_plain)]
    if f32_twin:
        swaps += [
            (cuda_attention, "selfatt", functools.partial(
                cuda_attention.selfatt_plain, rounding=False)),
            (cuda_attention, "selfatt_bwd", functools.partial(
                cuda_attention.selfatt_bwd_plain, rounding=False)),
            (cuda_attention, "selfatt_available",
             lambda L, heads, batch, dtype: True),
            (cuda_fused, "_run_dual", functools.partial(
                cuda_fused._run_dual, rounding=False))]
    with contextlib.ExitStack() as stack:
        for mod, name, fn in swaps:
            stack.enter_context(mock.patch.object(mod, name, fn))
        yield


REQUESTS = ((8, 128), (1, 128), (3, 77))
# the kernels of the serving path (the others are training's)
SERVE_KERNELS = ("layer_norm_fwd", "selfatt_fwd", "bias_gelu_fwd",
                 "bias_residual_fwd")
AFFINE_SCALE = 0.1


def _draw_affine(net, seed):
    """Draw every Dense bias, LayerNorm beta and gamma - 1 from
    N(0, AFFINE_SCALE^2) (seeded), so that a kernel which mishandles one
    changes the outputs. The initializers leave them 0 and 1."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed + 2)
    for name, p in net.collect_params().items():
        if name.endswith(("_bias", "_beta", "_gamma")):
            t = p.data().tensor()
            draw = torch.randn(t.shape, generator=g, device=t.device,
                               dtype=torch.float32) * AFFINE_SCALE
            p.set_data(draw + 1.0 if name.endswith("_gamma") else draw)


def phase_slice(seed):
    """Serve BERT-base on the card; returns (launch counts, number of
    forwards, session, requests, model)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.ops import cuda_build

    rng = np.random.RandomState(seed)
    reqs = [(rng.randint(0, 30522, shape).astype(np.int32),
             rng.randint(0, 2, shape).astype(np.int32)) for shape in REQUESTS]
    ex_ids, ex_tok = (mx.nd.array(a, ctx=mx.gpu(0)) for a in reqs[0])
    mx.random.seed(seed)
    t0 = time.perf_counter()
    net = bert_12_768_12(dropout=0.0)
    net.initialize(ctx=mx.gpu(0))
    with torch.no_grad():
        net(ex_ids, ex_tok)          # gives the Dense weights their shapes
    _draw_affine(net, seed)
    net.cast("bfloat16")
    torch.cuda.synchronize()
    print("[serve] bert_12_768_12 drawn from seed %d (biases, beta and "
          "gamma - 1 from N(0, %g^2)) and cast to bf16 in %.1f s"
          % (seed, AFFINE_SCALE, time.perf_counter() - t0))

    cuda_build.reset_launch_counts()
    sess = net.serve_session(ex_ids, ex_tok, seq_axis=1, max_batch=8,
                             max_seq=128)
    outs = [sess.infer(ids, tok) for ids, tok in reqs]
    torch.cuda.synchronize()
    counts = cuda_build.launch_counts()
    n_forwards = 1 + len(reqs)
    n_params = sum(p.data().size for p in net.collect_params().values())
    print("[serve] %d parameters" % n_params)
    print("[serve] launches over %d forwards (session build + %d "
          "requests): %s" % (n_forwards, len(reqs), counts))
    missing = [k for k in SERVE_KERNELS if counts[k] == 0]
    if missing:
        raise SmokeFailure("kernels never launched on the main path: %s"
                           % missing)

    with _plain_kernels():
        before = cuda_build.launch_counts()
        refs = [sess.infer(ids, tok) for ids, tok in reqs]
        net.cast("float32")
        anchors = [sess.infer(ids, tok) for ids, tok in reqs]
        net.cast("bfloat16")
        if cuda_build.launch_counts() != before:
            raise SmokeFailure("the plain run launched a kernel")

    U, V = net._units, net.decoder[2]._units
    ratios = []
    for (b, s), out, ref, anchor in zip(REQUESTS, outs, refs, anchors):
        bb, sb = sess.ladder.bucket_for(b, s)[0]
        # the decoder output (seq, batch, vocab) stays at bucket size:
        # the reference's unpad heuristic leaves it so
        want = [(b, s, U), (b, U), (b, 2), (sb, bb, V)]
        got = [tuple(o.shape) for o in out]
        if got != want:
            raise SmokeFailure("request (%d, %d): output shapes %s, "
                               "expected %s" % (b, s, got, want))
        for i, args in enumerate(zip(out, ref, anchor)):
            ratios.append(_slice_check("parity", "slice request (%d, %d) "
                                       "output %d" % (b, s, i), *args))
    print("[serve] slice: largest ratio %.3g over %d outputs (limit %g)"
          % (max(r for r, _ in ratios), len(ratios), SLICE_RATIO))
    if any(fail for _, fail in ratios):
        raise SmokeFailure("the served outputs differ from the plain path "
                           "by more than %g times bf16's own error"
                           % SLICE_RATIO)
    print("[serve] buckets: %s" % sess.bucket_table())
    _control(sess, reqs[0], refs[0], anchors[0])
    return counts, n_forwards, sess, reqs, net


def _control(sess, req, ref, anchor):
    """The slice check must fail a wrong kernel: serve ``req`` again with
    bias_residual's bias dropped (its kernel still launches)."""
    import torch
    from unittest import mock
    from mxnet_tpu_torch.ops import cuda_epilogue
    real = cuda_epilogue.bias_residual

    def bias_dropped(x, bias, residual):
        return real(x, torch.zeros_like(bias), residual)
    with mock.patch.object(cuda_epilogue, "bias_residual", bias_dropped):
        bad = sess.infer(*req)
    caught = [_slice_check("control", "bias dropped, request %s output %d"
                           % (req[0].shape, i), *args)[1]
              for i, args in enumerate(zip(bad, ref, anchor))]
    if not all(caught):
        raise SmokeFailure("control: the slice check passed a kernel that "
                           "drops its bias")


def phase_times(seed, reps, counts, n_forwards, errs, sess, reqs, net,
                card):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import cuda_attention, cuda_epilogue, cuda_norm
    randn = _randn(seed + 1)
    bw, bf16_peak, f32_peak = _peaks(card)
    E = 2  # bytes per bf16 element

    def bound(nbytes, flops, peak):
        t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    rows = []

    def row(name, source, replaces, fn, plain, lib, nbytes, flops, peak):
        ms, plain_ms, lib_ms = (_gpu_ms(f, reps) for f in (fn, plain, lib))
        b_ms, b_by = bound(nbytes, flops, peak)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "launches_per_forward": counts[name] / n_forwards,
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms})
        print("[times] %-18s kernel %.4f ms  plain %.4f ms  library %.4f ms"
              "  bound %.4f ms (%s)" % (name, ms, plain_ms, lib_ms, b_ms,
                                        b_by))

    def fixed(fn, lib):
        """The last row's fixed cost: the kernel and the library call on
        one row, a launch and one row's latency."""
        r = rows[-1]
        r["fixed_ms"], r["fixed_library_ms"] = (_gpu_ms(f, reps)
                                                for f in (fn, lib))
        print("[times] %s fixed cost (one row): kernel %.4f ms, library "
              "%.4f ms; at (%d, %d) %.4f ms, bound %.4f ms" % (
                  r["name"], r["fixed_ms"], r["fixed_library_ms"], M, C,
                  r["ms"], r["bound_ms"]))

    M, C, H = 1024, 768, 3072
    x, g, b = randn(M, C), randn(C), randn(C)
    row("layer_norm_fwd", "mxnet_tpu_torch/csrc/layer_norm.cu",
        "mxnet_tpu/ops/pallas_norm.py:89",
        lambda: cuda_norm.layer_norm_cuda(x, g, b, 1e-5),
        lambda: cuda_norm.layer_norm_plain(x, g, b, 1e-5),
        lambda: F.layer_norm(x, (C,), g, b, 1e-5),
        (2 * M * C + 2 * C) * E, 8 * M * C, f32_peak)
    x1 = x[:1]
    fixed(lambda: cuda_norm.layer_norm_cuda(x1, g, b, 1e-5),
          lambda: F.layer_norm(x1, (C,), g, b, 1e-5))
    _issue_floor(rows[-1], cuda_norm.SOURCE, LN_FWD_SASS, LN_FWD_PASS, M * C)

    L, N, heads, hd = 128, 8, 12, 64
    qkv = randn(L, N, heads * 3 * hd)
    q, k, v = (qkv.reshape(L, N, heads, 3, hd)[:, :, :, i]
               .permute(1, 2, 0, 3).contiguous() for i in range(3))
    row("selfatt_fwd", "mxnet_tpu_torch/csrc/selfatt.cu",
        "mxnet_tpu/ops/pallas_attention.py:256",
        lambda: cuda_attention.selfatt_cuda(qkv, heads),
        lambda: cuda_attention.selfatt_plain(qkv, heads),
        lambda: F.scaled_dot_product_attention(q, k, v),
        (L * N * heads * 3 * hd + L * N * heads * hd) * E,
        4 * N * heads * L * L * hd, bf16_peak)

    xg, bg = randn(M, H), randn(H)
    row("bias_gelu_fwd", "mxnet_tpu_torch/csrc/epilogue.cu",
        "mxnet_tpu/ops/pallas_epilogue.py:126",
        lambda: cuda_epilogue.bias_gelu_cuda(xg, bg),
        lambda: cuda_epilogue.bias_gelu_plain(xg, bg),
        lambda: F.gelu(xg + bg),
        (2 * M * H + H) * E, 20 * M * H, f32_peak)
    _issue_floor(rows[-1], cuda_epilogue.SOURCE, GELU_FWD_SASS, GELU_FWD_PASS,
                 M * H)

    r = randn(M, C)
    row("bias_residual_fwd", "mxnet_tpu_torch/csrc/epilogue.cu",
        "mxnet_tpu/ops/pallas_epilogue.py:267",
        lambda: cuda_epilogue.bias_residual_cuda(x, b, r),
        lambda: cuda_epilogue.bias_residual_plain(x, b, r),
        lambda: x + b + r,
        (3 * M * C + C) * E, 2 * M * C, f32_peak)
    r1 = r[:1]
    fixed(lambda: cuda_epilogue.bias_residual_cuda(x1, b, r1),
          lambda: x1 + b + r1)
    _issue_floor(rows[-1], cuda_epilogue.SOURCE, RESIDUAL_SASS, RESIDUAL_PASS,
                 M * C)

    import mxnet_tpu_torch as mx
    for ids, tok in reqs:
        bucket = sess.ladder.bucket_for(*ids.shape)[0]
        med = _host_ms(lambda: sess.infer(ids, tok))
        # the forward alone, on inputs already padded and on the card
        padded = [mx.nd.zeros(bucket, ctx=mx.gpu(0), dtype="int32")
                  for _ in range(2)]
        with torch.no_grad():
            fwd = _host_ms(lambda: net(*padded))
        print("[times] serve request %s: %.2f ms per request, %.0f "
              "tokens/s (bucket %s; host clock, outputs copied to host); "
              "forward alone %.2f ms" % (ids.shape, med, ids.size / med * 1e3,
                                         bucket, fwd))
    return rows


def _host_ms(fn, reps=5):
    """Median host-clock time of ``fn()`` in ms, the card synchronised."""
    import torch
    fn()
    lat = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat)


def phase_profile(net, bucket=(8, 128)):
    """Device time of one served forward at ``bucket``, by kernel group,
    from torch.profiler, and the card's busy share of the forward's wall
    time."""
    import torch
    import mxnet_tpu_torch as mx
    padded = [mx.nd.zeros(bucket, ctx=mx.gpu(0), dtype="int32")
              for _ in range(2)]

    def forward():
        with torch.no_grad():
            net(*padded)
    _profile("one forward at bucket %s" % (bucket,), forward)


def _profile(what, fn, n_other=8):
    """Run ``fn`` once warm, then once under torch.profiler; print the
    wall time, the device's busy time and share, and device time by
    kernel group (the port's kernels by name, cuBLAS, the largest other
    kernels by name). Returns {group: device ms}, empty when the
    profiler saw no device kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.ops import cuda_build
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, n_kernels = {}, 0
    names = sorted(tuple(cuda_build.KERNELS) + RTC_KERNELS, key=len,
                   reverse=True)
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += 1
        name = ev.name
        group = next((k for k in names if k in name), None)
        if group is None:
            low = name.lower()
            group = ("matmul, conv (cuBLAS, cuDNN)" if any(
                k in low for k in ("gemm", "nvjet", "xmma", "cutlass"))
                else "other: " + name[:40])
        us = ev.device_time_total if hasattr(ev, "device_time_total") \
            else ev.cuda_time_total
        groups[group] = groups.get(group, 0.0) + us / 1e3
    busy = sum(groups.values())
    if not n_kernels:
        print("[profile] the profiler saw no device kernels: device time "
              "not measured")
        return {}
    print("[profile] %s: wall %.2f ms (host clock, profiler on), %d "
          "kernels, device busy %.2f ms (%.0f%% of wall, idle %.0f%%)"
          % (what, wall_ms, n_kernels, busy, 100 * busy / wall_ms,
             max(0.0, 100 - 100 * busy / wall_ms)))
    ranked = sorted(groups.items(), key=lambda kv: -kv[1])
    others = [kv for kv in ranked if kv[0].startswith("other: ")]
    rest = others[n_other:]
    for g, ms in ranked:
        if (g, ms) not in rest:
            print("[profile]   %-48s %8.3f ms  %5.1f%% of device time"
                  % (g, ms, 100 * ms / busy))
    if rest:
        ms = sum(v for _, v in rest)
        print("[profile]   %-48s %8.3f ms  %5.1f%% of device time"
              % ("other: %d more kernel names" % len(rest), ms,
                 100 * ms / busy))
    return groups


def _drop_pattern(what, got, ref):
    """The zero patterns of two dropout outputs must be identical."""
    import torch
    torch.cuda.synchronize()
    differ = int(((got == 0) != (ref == 0)).sum())
    print("[parity] %-44s zero patterns differ at %d of %d elements %s"
          % (what, differ, got.numel(), "FAIL" if differ else "ok"))
    if differ:
        raise SmokeFailure("%s: the kernel's dropout mask is not the plain "
                           "version's" % what)


def _vector_dropouts(tag, scalar_before, what):
    """Every dropout launch of a path (``what`` says which) took the
    16-byte variant: ``cuda_dropout.scalar_launches`` still reads
    ``scalar_before``."""
    from mxnet_tpu_torch.ops import cuda_dropout
    scalar = cuda_dropout.scalar_launches - scalar_before
    print("[%s] dropout launches (%s): %d of the one-element variant, the "
          "rest of the 16-byte one %s" % (tag, what, scalar,
                                          "FAIL" if scalar else "ok"))
    if scalar:
        raise SmokeFailure("%s: %d dropout launches took the one-element "
                           "variant" % (tag, scalar))


def phase_parity_train(seed):
    """The training kernels against their plain versions at the shapes
    BERT-base training gives them; returns {kernel: max abs error}."""
    import math
    import torch
    from mxnet_tpu_torch.ops import (cuda_attention, cuda_dropout,
                                     cuda_epilogue, cuda_norm)
    randn = _randn(seed + 3)
    M, C, H = TRAIN_BATCH * TRAIN_SEQ, UNITS, HIDDEN
    errs = {}
    x, dy, g = randn(M, C, scale=2.0), randn(M, C), randn(C)
    got = cuda_norm.layer_norm_bwd_cuda(dy, x, g, 1e-5)
    ref = cuda_norm.layer_norm_bwd_plain(dy, x, g, 1e-5)
    errs["layer_norm_bwd"] = max(
        _check_close("layer_norm_bwd %s (%d, %d)" % (name, M, C), a, b,
                     KERNEL_ATOL, KERNEL_RTOL, KERNEL_EQUAL)
        for name, a, b in zip(("dx", "dgamma", "dbeta"), got, ref))

    x, dy, b = randn(M, H, scale=2.0), randn(M, H), randn(H)
    got = cuda_epilogue.bias_gelu_bwd_cuda(dy, x, b)
    ref = cuda_epilogue.bias_gelu_bwd_plain(dy, x, b)
    errs["bias_gelu_bwd"] = max(
        _check_close("bias_gelu_bwd %s (%d, %d)" % (name, M, H), a, b_,
                     KERNEL_ATOL, KERNEL_RTOL, KERNEL_EQUAL)
        for name, a, b_ in zip(("dx", "db"), got, ref))
    bad = _bias_shift(x, b, dy)
    _must_fail("bias_gelu_bwd with its bias one column off", lambda: [
        _check_close("control: bias_gelu_bwd %s, bias shifted" % name, a, b_,
                     KERNEL_ATOL, KERNEL_RTOL, KERNEL_EQUAL)
        for name, a, b_ in zip(("dx", "db"), bad, ref)])

    x = randn(M, C) + 3          # no zeros: a zero output is a drop
    seed_t = torch.tensor([seed * 7919 + 1], dtype=torch.int32,
                          device=DEV)
    got = cuda_dropout.dropout_cuda(x, 0.1, seed_t)
    ref = cuda_dropout.dropout_plain(x, 0.1, seed_t)
    errs["dropout"] = _check_close("dropout p=0.1 (%d, %d)" % (M, C), got,
                                   ref, KERNEL_ATOL, KERNEL_RTOL)
    _check_exact("dropout p=0.1 (%d, %d)" % (M, C), got, ref)
    _drop_pattern("dropout mask (%d, %d)" % (M, C), got, ref)
    # the one-element variant: the same x one element off 16-byte alignment
    scalar = cuda_dropout.scalar_launches
    shifted = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(M, C)
    _check_exact("dropout p=0.1 (%d, %d), x off alignment" % (M, C),
                 cuda_dropout.dropout_cuda(shifted, 0.1, seed_t), ref)
    if cuda_dropout.scalar_launches != scalar + 1:
        raise SmokeFailure("dropout: x off 16-byte alignment did not take "
                           "the one-element variant")
    keep = float((got != 0).float().mean())
    sigma = math.sqrt(0.9 * 0.1 / got.numel())
    print("[parity] dropout keep rate %.6f, 0.9 +- %.2g (5 sigma = %.2g) %s"
          % (keep, sigma, 5 * sigma, "ok" if abs(keep - 0.9) <= 5 * sigma
             else "FAIL"))
    if abs(keep - 0.9) > 5 * sigma:
        raise SmokeFailure("dropout keep rate %.6f beyond 5 sigma of 0.9"
                           % keep)

    L, N, heads, hd = TRAIN_SEQ, TRAIN_BATCH, HEADS, HEAD_DIM
    plan = cuda_attention.selfatt_plan(L, heads, N)
    seeds = torch.randint(0, 2 ** 31 - 1, (plan["n_blocks"],),
                          generator=torch.Generator(device=DEV)
                          .manual_seed(seed + 4), device=DEV,
                          dtype=torch.int32)
    args = (heads, 0.1, seeds, plan["bbh"])
    qkv, dout = randn(L, N, heads * 3 * hd), randn(L, N, heads * hd)
    errs["selfatt_fwd_train"] = _check_close(
        "selfatt_fwd p=0.1 L=%d N=%d heads=%d" % (L, N, heads),
        cuda_attention.selfatt_cuda(qkv, *args),
        cuda_attention.selfatt_plain(qkv, *args),
        KERNEL_ATOL, KERNEL_RTOL, KERNEL_EQUAL)
    errs["selfatt_bwd"] = _check_close(
        "selfatt_bwd dqkv p=0.1 L=%d N=%d heads=%d" % (L, N, heads),
        cuda_attention.selfatt_bwd_cuda(qkv, dout, *args),
        cuda_attention.selfatt_bwd_plain(qkv, dout, *args),
        KERNEL_ATOL, KERNEL_RTOL, KERNEL_EQUAL)
    # the mask: q = 0 makes P uniform (1/L) and v one-hot per key makes
    # the context the dropped probabilities themselves, so the context's
    # zeros are the mask; keys [k0, k0 + hd) per run
    want = cuda_attention.keep_mask(seeds, N, heads, L, 0.1, plan["bbh"])
    for k0 in range(0, L, hd):
        x = torch.zeros(L, N, heads, 3, hd, device=DEV)
        x[k0:k0 + hd, :, :, 2] = torch.eye(hd, device=DEV)[:, None, None]
        x = x.reshape(L, N, heads * 3 * hd).to(torch.bfloat16)
        pattern = [(f(x, *args).reshape(L, N, heads, hd)
                    .permute(1, 2, 0, 3) != 0) for f in (
                        cuda_attention.selfatt_cuda,
                        cuda_attention.selfatt_plain)]
        for name, got in zip(("kernel", "plain"), pattern):
            _drop_pattern("selfatt mask, %s, keys %d-%d" % (name, k0,
                                                           k0 + hd - 1),
                          got.to(torch.float32),
                          want[..., k0:k0 + hd].to(torch.float32))

    # the forward kernels at the training step's shapes
    x, g, b = randn(M, C), randn(C), randn(C)
    errs["layer_norm_fwd_train"] = _check_close(
        "layer_norm_fwd (%d, %d)" % (M, C),
        cuda_norm.layer_norm_cuda(x, g, b, 1e-5),
        cuda_norm.layer_norm_plain(x, g, b, 1e-5), KERNEL_ATOL, KERNEL_RTOL,
        KERNEL_EQUAL)
    r = randn(M, C)
    errs["bias_residual_fwd_train"] = _check_close(
        "bias_residual_fwd (%d, %d)" % (M, C),
        cuda_epilogue.bias_residual_cuda(x, b, r),
        cuda_epilogue.bias_residual_plain(x, b, r), KERNEL_ATOL, KERNEL_RTOL,
        1.0)
    x, b = randn(M, H, scale=2.0), randn(H)
    errs["bias_gelu_fwd_train"] = _check_close(
        "bias_gelu_fwd (%d, %d)" % (M, H), cuda_epilogue.bias_gelu_cuda(x, b),
        cuda_epilogue.bias_gelu_plain(x, b), KERNEL_ATOL, KERNEL_RTOL,
        KERNEL_EQUAL)
    return errs


# Attention beyond BERT's shapes, at dropout 0.1: a ragged L, and L
# above the single-pass backward and the one-sweep softmax (csrc/
# selfatt.cu), at (L, N, heads, hd). At hd = 64 (scale 2^-3) the kernels
# keep every rounding point and are held to KERNEL_EQUAL; at hd = 32 and
# 128 they scale the f32 sum of Q.K^T, not q, and are held to the
# tolerance only.
ATT_SHAPES = tuple((L, N, 12, hd) for hd in (64, 32, 128)
                   for L, N in ((77, 8), (512, 4), (1024, 2)))


def _att_inputs(randn, L, N, heads, hd, seed):
    import torch
    from mxnet_tpu_torch.ops import cuda_attention
    plan = cuda_attention.selfatt_plan(L, heads, N)
    seeds = torch.randint(0, 2 ** 31 - 1, (plan["n_blocks"],),
                          generator=torch.Generator(device=DEV)
                          .manual_seed(seed), device=DEV, dtype=torch.int32)
    return (randn(L, N, heads * 3 * hd), randn(L, N, heads * hd),
            (heads, 0.1, seeds, plan["bbh"]))


# div_rn (csrc/common.cuh), the attention kernels' division, against the
# compiler's '/' on operands drawn in-kernel from a counter hash: x with a
# random sign, exponent in [-100, 100] and mantissa; y by mode: 0 the
# dropout keep probabilities 1 - p, p in [0, 0.999]; 1 softmax sums in
# [1, 1024]; 2 anything div_ok admits (magnitudes 2^-24 to 2^25). With
# ``naive`` the quotient is x * rcp(y), which must differ (the control).
DIV_CHECK_SOURCE = r"""
#include "common.cuh"
__global__ void div_check(unsigned long long* out, unsigned long long n,
                          int mode, int naive) {
  unsigned long long bad = 0, tested = 0;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                              threadIdx.x;
       i < n; i += (unsigned long long)gridDim.x * blockDim.x) {
    const uint32_t h1 = mxt_hash((uint32_t)i, 0x2545F491u + mode);
    const uint32_t h2 = mxt_hash(h1, 1u), h3 = mxt_hash(h2, 2u);
    const float x = __uint_as_float((h2 & 0x80000000u) |
                                    ((27u + h1 % 201u) << 23) |
                                    (h3 & 0x7fffffu));
    float y;
    if (mode == 0) y = 1.f - (float)(h2 % 1000u) * 1e-3f;
    else if (mode == 1) y = (float)(1u + h3 % 1023u) +
        (__uint_as_float(0x3f800000u | (h1 & 0x7fffffu)) - 1.f);
    else y = __uint_as_float(((103u + h3 % 49u) << 23) | (h2 & 0x7fffffu));
    if (!div_ok(x, y)) continue;
    const float q = naive ? x * __frcp_rn(y) : div_rn(x, y);
    ++tested;
    if (__float_as_uint(q) != __float_as_uint(x / y)) ++bad;
  }
  atomicAdd(out, bad);
  atomicAdd(out + 1, tested);
}
MXT_EXPORT int mxt_div_check(void* out, unsigned long long n, int mode,
                             int naive, cudaStream_t stream) {
  div_check<<<1056, 256, 0, stream>>>(
      static_cast<unsigned long long*>(out), n, mode, naive);
  return static_cast<int>(cudaGetLastError());
}
"""
DIV_CHECK_N = 1 << 30


def _division_check():
    """div_rn bit for bit with '/' on DIV_CHECK_N operand pairs per mode;
    x * rcp(y) must be caught."""
    import ctypes
    import torch
    from mxnet_tpu_torch.ops import cuda_build
    # the header's text, not an include path, so that the build's digest
    # covers it
    header = (cuda_build.CSRC_DIR / "common.cuh").read_text()
    lib = cuda_build.load_library(cuda_build.build_source(
        DIV_CHECK_SOURCE.replace('#include "common.cuh"', header)))
    lib.mxt_div_check.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    counts = {}
    for naive in (0, 1):
        for mode in (0, 1, 2):
            out = torch.zeros(2, dtype=torch.int64, device=DEV)
            rc = lib.mxt_div_check(out.data_ptr(), DIV_CHECK_N, mode, naive,
                                   torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SmokeFailure("div_check launch failed (%d)" % rc)
            counts[naive, mode] = [int(v) for v in out.cpu()]
    bad = sum(counts[0, m][0] for m in range(3))
    tested = sum(counts[0, m][1] for m in range(3))
    control = sum(counts[1, m][0] for m in range(3))
    print("[parity] div_rn against '/': %d of %d quotients differ (keep "
          "probabilities, softmax sums, any divisor) %s; control x * rcp(y): "
          "%d differ, %s" % (bad, tested, "FAIL" if bad else "ok", control,
                             "caught" if control else "MISSED"))
    if bad or not tested:
        raise SmokeFailure("div_rn differs from '/' in %d quotients" % bad)
    if not control:
        raise SmokeFailure("control: the division check passed x * rcp(y)")


def _selfatt_bwd_pd_terms(qkv, dout, heads, p, seeds, block_heads, terms):
    """The attention backward through ``mxt_selfatt_bwd_pd_terms``: dV
    from ``terms`` bf16 terms of the f32 Pd (3: the kernel's own; 1, the
    bf16 Pd, and 2 only at 32 < hd <= 64) - a planted fault for the
    checks, which the port never launches."""
    import torch
    from mxnet_tpu_torch.ops import cuda_attention as ca, cuda_build
    L, N, hd, lib, drop = ca._check(ca.BWD_KERNEL, qkv, heads, p, seeds,
                                    block_heads)
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((N, heads, 3, -(-L // 64) * 64),
                        dtype=torch.float32, device=qkv.device)
    rc = lib.mxt_selfatt_bwd_pd_terms(
        qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        L, N, heads, hd, ca._scale(hd), *drop, cuda_build.stream_of(qkv),
        terms)
    if rc:
        raise SmokeFailure("mxt_selfatt_bwd_pd_terms failed (%d)" % rc)
    return dqkv


def phase_parity_attention(seed):
    """The attention kernels' division against '/'; the kernels against
    their plain versions at ATT_SHAPES, every backward route among them,
    under order_limit (the witness: the plain version summing its
    products and row sums in float64); then the control: dV from the
    bf16 Pd (one term, through ``mxt_selfatt_bwd_pd_terms``) must fail
    the equal share at BERT's training shape. Two terms are reported."""
    import torch
    from mxnet_tpu_torch.ops import cuda_attention as ca
    _division_check()
    randn = _randn(seed + 7)
    single = ca._lib().mxt_selfatt_bwd_single_pass
    routes = set()
    for i, (L, N, heads, hd) in enumerate(ATT_SHAPES):
        qkv, dout, args = _att_inputs(randn, L, N, heads, hd, seed + 8 + i)
        route = "single pass" if single(L, hd) else "two passes"
        routes.add(route)
        equal = KERNEL_EQUAL if hd == 64 else None
        tag = "p=0.1 L=%d N=%d heads=%d hd=%d" % (L, N, heads, hd)
        _check_order("selfatt_fwd " + tag, ca.selfatt_cuda(qkv, *args),
                     ca.selfatt_plain(qkv, *args),
                     ca.selfatt_plain(qkv, *args, sum_dtype=torch.float64),
                     equal)
        _check_order("selfatt_bwd %s (%s)" % (tag, route),
                     ca.selfatt_bwd_cuda(qkv, dout, *args),
                     ca.selfatt_bwd_plain(qkv, dout, *args),
                     ca.selfatt_bwd_plain(qkv, dout, *args,
                                          sum_dtype=torch.float64), equal)
    if routes != {"single pass", "two passes"}:
        raise SmokeFailure("the attention checks ran the backward routes %s, "
                           "not both" % sorted(routes))

    L, N, heads, hd = TRAIN_SEQ, TRAIN_BATCH, HEADS, HEAD_DIM
    qkv, dout, args = _att_inputs(randn, L, N, heads, hd, seed + 4)
    ref = ca.selfatt_bwd_plain(qkv, dout, *args)
    shares = {}
    for terms in (3, 2, 1):
        got = _selfatt_bwd_pd_terms(qkv, dout, *args, terms)
        shares[terms] = float((got == ref).float().mean())
    print("[control] selfatt_bwd dV from Pd in bf16 terms at L=%d N=%d: "
          "bit-equal share of dqkv %s (>= %g needed): one term (the bf16 Pd) "
          "%s" % (L, N, ", ".join("%d terms %.5f" % kv for kv in
                                 sorted(shares.items(), reverse=True)),
                  KERNEL_EQUAL, "caught" if shares[1] < KERNEL_EQUAL
                  else "MISSED"))
    if shares[1] >= KERNEL_EQUAL:
        raise SmokeFailure("control: the attention backward check passed dV "
                           "from a bf16 Pd")


def _train_batch(seed):
    import numpy as np
    import mxnet_tpu_torch as mx
    rng = np.random.RandomState(seed + 5)
    shape = (TRAIN_BATCH, TRAIN_SEQ)
    return [mx.nd.array(rng.randint(0, hi, shape).astype(np.int32))
            for hi in (VOCAB, 2, VOCAB)]


def _build_train(seed):
    """bert_12_768_12 at dropout 0.1 and the dense MLM head, as a user
    writes them: initialized on gpu(0) (the default context), biases,
    beta and gamma - 1 drawn from the seed, cast to bf16."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTMLMLoss,
                                                      bert_12_768_12)
    mx.random.seed(seed)
    net = bert_12_768_12(dropout=0.1, use_pooler=False, use_classifier=False,
                         use_decoder=False)
    mlm = BERTMLMLoss(vocab_size=VOCAB, units=net._units, mode="dense",
                      prefix="decoder_")
    net.initialize()
    mlm.initialize()
    ids, tok, _ = _train_batch(seed)
    with torch.no_grad():
        net(ids, tok)
    for i, block in enumerate((net, mlm)):
        _draw_affine(block, seed + 10 * i)
    net.cast("bfloat16")
    mlm.cast("bfloat16")
    params = net.collect_params()
    params.update(mlm.collect_params())
    return net, mlm, params


def _fwd_bwd(net, mlm, params, batch, seed):
    """One forward and backward with the port's generator reseeded (the
    same seeds, so the same dropout masks, in every run); returns the
    loss and every gradient as f32 tensors."""
    import mxnet_tpu_torch as mx
    ids, tok, lab = batch
    mx.random.seed(seed)
    with mx.autograd.record():
        loss = mlm(net(ids, tok)[0], lab).mean()
    loss.backward()
    return (loss.tensor().detach().float().clone(),
            {n: p.grad().tensor().float().clone()
             for n, p in params.items()})


def _train_compare(tag, got, ref, anchor, quiet=True, limit=TRAIN_RATIO):
    """Ratios of the loss and every gradient; returns [(ratio, fail)]."""
    out = [_slice_check(tag, "loss", got[0], ref[0], anchor[0],
                        limit, quiet=tag == "control")]
    for n in ref[1]:
        out.append(_slice_check(tag, "grad " + n, got[1][n], ref[1][n],
                                anchor[1][n], limit, quiet))
    return out


def phase_train(seed, steps):
    """Train BERT-base on the card; returns (launch counts of one step,
    model, loss head, parameters, batch)."""
    import math
    import torch
    from unittest import mock
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_build, cuda_dropout, cuda_epilogue
    t0 = time.perf_counter()
    net, mlm, params = _build_train(seed)
    batch = _train_batch(seed)
    torch.cuda.synchronize()
    print("[train] bert_12_768_12 (dropout 0.1) + BERTMLMLoss(dense), %d "
          "parameters in %d arrays, bf16, built from seed %d in %.1f s"
          % (sum(p.data().size for p in params.values()), len(params), seed,
             time.perf_counter() - t0))

    # one forward and backward: kernels, plain versions, f32 twin
    kern = _fwd_bwd(net, mlm, params, batch, seed)
    with _plain_kernels():
        before = cuda_build.launch_counts()
        plain = _fwd_bwd(net, mlm, params, batch, seed)
        net.cast("float32")
        mlm.cast("float32")
        with _plain_kernels(f32_twin=True):
            twin = _fwd_bwd(net, mlm, params, batch, seed)
        net.cast("bfloat16")
        mlm.cast("bfloat16")
        if cuda_build.launch_counts() != before:
            raise SmokeFailure("the plain runs launched a kernel")
    if not math.isfinite(float(kern[0])):
        raise SmokeFailure("training loss is not finite: %s" % float(kern[0]))
    checks = _train_compare("parity", kern, plain, twin)
    ratios = sorted(((r, n) for (r, _), n in
                     zip(checks, ["loss"] + list(plain[1]))), reverse=True)
    print("[train] loss: kernels %.6f, plain %.6f, f32 twin %.6f"
          % (float(kern[0]), float(plain[0]), float(twin[0])))
    print("[train] step vs plain step: %d ratios, largest %s (limit %g), "
          "median %.3g" % (len(ratios), ", ".join(
              "%s %.3g" % (n, r) for r, n in ratios[:4]), TRAIN_RATIO,
              ratios[len(ratios) // 2][0]))
    if any(fail for _, fail in checks):
        raise SmokeFailure("the training step differs from the plain step "
                           "by more than %g times bf16's own error"
                           % TRAIN_RATIO)

    # control: bias+GeLU's db dropped (its kernel still launches)
    real = cuda_epilogue.bias_gelu_bwd

    def db_dropped(dy, x, bias):
        dx, db = real(dy, x, bias)
        return dx, torch.zeros_like(db)
    with mock.patch.object(cuda_epilogue, "bias_gelu_bwd", db_dropped):
        bad = _fwd_bwd(net, mlm, params, batch, seed)
    caught = [(n, r) for (r, fail), n in zip(
        _train_compare("control", bad, plain, twin),
        ["loss"] + list(plain[1])) if fail]
    print("[control] bias_gelu_bwd db dropped: %d of %d checks fail (%s)"
          % (len(caught), len(plain[1]) + 1, ", ".join(
              "%s %.3g" % c for c in caught[:3])))
    if not caught:
        raise SmokeFailure("control: the training check passed a backward "
                           "kernel that drops its db")

    # launch counts of one full step, then LAMB on the fixed batch
    trainer = mx.gluon.Trainer(params, "lamb",
                               {"learning_rate": 1e-3, "wd": 0.01})
    ids, tok, lab = batch
    losses = []
    scalar = cuda_dropout.scalar_launches
    for step in range(steps):
        if step == 0:
            cuda_build.reset_launch_counts()
        with mx.autograd.record():
            per_position = mlm(net(ids, tok)[0], lab)
            loss = per_position.mean()
        if step == 0:
            fwd_counts = cuda_build.launch_counts()
        loss.backward()
        trainer.step(TRAIN_BATCH)
        if step == 0:
            torch.cuda.synchronize()
            counts = cuda_build.launch_counts()
            print("[train] launches in one step: %s (dropout %d in the "
                  "forward)" % (counts, fwd_counts["dropout"]))
            if counts != TRAIN_LAUNCHES or \
                    fwd_counts["dropout"] != TRAIN_FWD_DROPOUT:
                raise SmokeFailure("launch counts of one step %s, expected "
                                   "%s with %d dropouts in the forward"
                                   % (counts, TRAIN_LAUNCHES,
                                      TRAIN_FWD_DROPOUT))
            _vector_dropouts("train", scalar, "%d in one step"
                             % counts["dropout"])
        # the mean in f32: the bf16 mean that is differentiated has a
        # resolution of 1/16 at BERT's initial loss
        losses.append(float(per_position.tensor().detach().float().mean()))
    print("[train] LAMB on one fixed batch, loss per step (f32 mean): %s"
          % " ".join("%.4f" % v for v in losses))
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise SmokeFailure("training did not lower the loss: %s" % losses)
    print("[train] loss %.4f at the first step, %.4f after %d steps"
          % (losses[0], losses[-1], steps))
    return counts, net, mlm, params, batch


def phase_times_train(seed, reps, counts, errs, card, net, mlm, params,
                      batch):
    """Times of the training kernels, their plain versions and a PyTorch
    call for each; the training step on the host clock. Returns the
    kernels' rows."""
    import torch
    import torch.nn.functional as F
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import (cuda_attention, cuda_dropout,
                                     cuda_epilogue, cuda_norm)
    randn = _randn(seed + 6)
    bw, bf16_peak, f32_peak = _peaks(card)
    E = 2
    rows = []

    def row(name, source, replaces, fn, plain, lib, nbytes, flops, peak,
            kernel=None):
        ms, plain_ms, lib_ms = (_gpu_ms(f, reps) for f in (fn, plain, lib))
        t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")
        kernel = kernel or name
        rows.append({"name": name, "kernel": kernel, "route": "cuda",
                     "source": source, "replaces": replaces,
                     "launches": counts[kernel],
                     "launches_per_train_step": counts[kernel],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms})
        print("[times] %-18s kernel %.4f ms  plain %.4f ms  library %.4f ms"
              "  bound %.4f ms (%s)" % (name, ms, plain_ms, lib_ms, b_ms,
                                        b_by))

    M, C, H = TRAIN_BATCH * TRAIN_SEQ, UNITS, HIDDEN
    x, dy, g, b = randn(M, C), randn(M, C), randn(C), randn(C)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [C], g, b, 1e-5)
    row("layer_norm_bwd", "mxnet_tpu_torch/csrc/layer_norm.cu",
        "mxnet_tpu/ops/pallas_norm.py:117",
        lambda: cuda_norm.layer_norm_bwd_cuda(dy, x, g, 1e-5),
        lambda: cuda_norm.layer_norm_bwd_plain(dy, x, g, 1e-5),
        lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [C], mean, rstd, g, b, [True, True, True]),
        (3 * M * C + 3 * C) * E, 12 * M * C, f32_peak)
    rows[-1]["launch_ms"] = _launch_ms(
        lambda: cuda_norm.layer_norm_bwd_cuda(dy, x, g, 1e-5), reps)
    print("[times] layer_norm_bwd by launch (profiler, ms a call): %s"
          % ", ".join("%s %.4f" % kv for kv in rows[-1]["launch_ms"].items()))

    L, N, heads, hd = TRAIN_SEQ, TRAIN_BATCH, HEADS, HEAD_DIM
    plan = cuda_attention.selfatt_plan(L, heads, N)
    seeds = torch.randint(0, 2 ** 31 - 1, (plan["n_blocks"],),
                          device=DEV, dtype=torch.int32)
    qkv, dout = randn(L, N, heads * 3 * hd), randn(L, N, heads * hd)
    q, k, v = (qkv.reshape(L, N, heads, 3, hd)[:, :, :, i]
               .permute(1, 2, 0, 3).contiguous().requires_grad_()
               for i in range(3))
    o = F.scaled_dot_product_attention(q, k, v, dropout_p=0.1)
    do = dout.reshape(L, N, heads, hd).permute(1, 2, 0, 3).contiguous()
    args = (heads, 0.1, seeds, plan["bbh"])
    with torch.no_grad():
        row("selfatt_fwd_train", "mxnet_tpu_torch/csrc/selfatt.cu",
            "mxnet_tpu/ops/pallas_attention.py:256",
            lambda: cuda_attention.selfatt_cuda(qkv, *args),
            lambda: cuda_attention.selfatt_plain(qkv, *args),
            lambda: F.scaled_dot_product_attention(q, k, v, dropout_p=0.1),
            (L * N * heads * 3 * hd + L * N * heads * hd) * E,
            4 * N * heads * L * L * hd, bf16_peak, kernel="selfatt_fwd")
    row("selfatt_bwd", "mxnet_tpu_torch/csrc/selfatt.cu",
        "mxnet_tpu/ops/pallas_attention.py:302",
        lambda: cuda_attention.selfatt_bwd_cuda(qkv, dout, *args),
        lambda: cuda_attention.selfatt_bwd_plain(qkv, dout, *args),
        lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True),
        (2 * L * N * heads * 3 * hd + L * N * heads * hd) * E,
        6 * 2 * N * heads * L * L * hd, bf16_peak)

    xg, dyg, bg = randn(M, H), randn(M, H), randn(H)
    xl, bl = xg.clone().requires_grad_(), bg.clone().requires_grad_()
    yl = F.gelu(xl + bl)
    row("bias_gelu_bwd", "mxnet_tpu_torch/csrc/epilogue.cu",
        "mxnet_tpu/ops/pallas_epilogue.py:151",
        lambda: cuda_epilogue.bias_gelu_bwd_cuda(dyg, xg, bg),
        lambda: cuda_epilogue.bias_gelu_bwd_plain(dyg, xg, bg),
        lambda: torch.autograd.grad(yl, (xl, bl), dyg, retain_graph=True),
        (3 * M * H + 2 * H) * E, 30 * M * H, f32_peak)
    rows[-1]["launch_ms"] = _launch_ms(
        lambda: cuda_epilogue.bias_gelu_bwd_cuda(dyg, xg, bg), reps)
    print("[times] bias_gelu_bwd by launch (profiler, ms a call): %s"
          % ", ".join("%s %.4f" % kv for kv in rows[-1]["launch_ms"].items()))
    _issue_floor(rows[-1], cuda_epilogue.SOURCE, GELU_BWD_SASS, GELU_BWD_PASS,
                 M * H)

    # the forward kernels at the training step's shapes
    with torch.no_grad():
        xf, gf, bf, rf = randn(M, C), randn(C), randn(C), randn(M, C)
        row("layer_norm_fwd_train", "mxnet_tpu_torch/csrc/layer_norm.cu",
            "mxnet_tpu/ops/pallas_norm.py:89",
            lambda: cuda_norm.layer_norm_cuda(xf, gf, bf, 1e-5),
            lambda: cuda_norm.layer_norm_plain(xf, gf, bf, 1e-5),
            lambda: F.layer_norm(xf, (C,), gf, bf, 1e-5),
            (2 * M * C + 2 * C) * E, 8 * M * C, f32_peak,
            kernel="layer_norm_fwd")
        _issue_floor(rows[-1], cuda_norm.SOURCE, LN_FWD_SASS, LN_FWD_PASS,
                     M * C)
        row("bias_gelu_fwd_train", "mxnet_tpu_torch/csrc/epilogue.cu",
            "mxnet_tpu/ops/pallas_epilogue.py:126",
            lambda: cuda_epilogue.bias_gelu_cuda(xg, bg),
            lambda: cuda_epilogue.bias_gelu_plain(xg, bg),
            lambda: F.gelu(xg + bg),
            (2 * M * H + H) * E, 20 * M * H, f32_peak, kernel="bias_gelu_fwd")
        _issue_floor(rows[-1], cuda_epilogue.SOURCE, GELU_FWD_SASS,
                     GELU_FWD_PASS, M * H)
        row("bias_residual_fwd_train", "mxnet_tpu_torch/csrc/epilogue.cu",
            "mxnet_tpu/ops/pallas_epilogue.py:267",
            lambda: cuda_epilogue.bias_residual_cuda(xf, bf, rf),
            lambda: cuda_epilogue.bias_residual_plain(xf, bf, rf),
            lambda: xf + bf + rf,
            (3 * M * C + C) * E, 2 * M * C, f32_peak,
            kernel="bias_residual_fwd")
        _issue_floor(rows[-1], cuda_epilogue.SOURCE, RESIDUAL_SASS,
                     RESIDUAL_PASS, M * C)

    xd = randn(M, C)
    sd = torch.tensor([7], dtype=torch.int32, device=DEV)
    row("dropout", "mxnet_tpu_torch/csrc/dropout.cu",
        "mxnet_tpu/ops/pallas_dropout.py:73",
        lambda: cuda_dropout.dropout_cuda(xd, 0.1, sd),
        lambda: cuda_dropout.dropout_plain(xd, 0.1, sd),
        lambda: F.dropout(xd, 0.1, training=True),
        2 * M * C * E, 20 * M * C, f32_peak)

    # the whole step, host clock: forward, backward and the LAMB update
    trainer = mx.gluon.Trainer(params, "lamb",
                               {"learning_rate": 1e-3, "wd": 0.01})
    ids, tok, lab = batch

    def step():
        with mx.autograd.record():
            loss = mlm(net(ids, tok)[0], lab).mean()
        loss.backward()
        trainer.step(TRAIN_BATCH)
    ms = _host_ms(step)
    print("[times] training step (batch %d x seq %d, LAMB): %.2f ms per "
          "step, %.1f samples/s (host clock, median of 5)"
          % (TRAIN_BATCH, TRAIN_SEQ, ms, TRAIN_BATCH / ms * 1e3))
    return rows, step


# ---------------------------------------------------------------------------
# BERT-base pretrained as the reference's flagship configuration runs it:
# bf16 AMP over f32 parameters, the default (chunked) LM head, LAMB with a
# PolyScheduler; then float16 with master weights and loss scaling
# ---------------------------------------------------------------------------
def _build_amp(seed, num_layers=12, dtype=None, dropout=0.1):
    """BERT-base's widths (``bert_12_768_12`` at 12 layers) at
    ``dropout`` with the default ``BERTMLMLoss``, initialized on gpu(0),
    biases, beta and gamma - 1 drawn from the seed, f32 unless
    ``dtype``."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTMLMLoss,
                                                      BERTModel,
                                                      bert_12_768_12)
    mx.random.seed(seed)
    kw = dict(dropout=dropout, use_pooler=False, use_classifier=False,
              use_decoder=False)
    net = bert_12_768_12(**kw) if num_layers == 12 else BERTModel(
        num_layers=num_layers, units=UNITS, hidden_size=HIDDEN,
        num_heads=HEADS, vocab_size=VOCAB, **kw)
    mlm = BERTMLMLoss(vocab_size=VOCAB, units=UNITS, prefix="decoder_")
    net.initialize()
    mlm.initialize()
    ids, tok, _ = _train_batch(seed)
    with torch.no_grad():
        net(ids, tok)
    for i, block in enumerate((net, mlm)):
        _draw_affine(block, seed + 10 * i)
    if dtype is not None:
        net.cast(dtype)
        mlm.cast(dtype)
    params = net.collect_params()
    params.update(mlm.collect_params())
    return net, mlm, params


@contextlib.contextmanager
def _ln_instances():
    """Count the LayerNorm kernels' launches by (x dtype, gamma dtype),
    forward and backward, through their wrappers."""
    from unittest import mock
    from mxnet_tpu_torch.ops import cuda_norm
    seen = {"fwd": {}, "bwd": {}}

    def spy(kind, real):
        def call(*a):
            x, gamma = (a[0], a[1]) if kind == "fwd" else (a[1], a[2])
            key = "x %s, gamma %s" % (str(x.dtype)[6:], str(gamma.dtype)[6:])
            seen[kind][key] = seen[kind].get(key, 0) + 1
            return real(*a)
        return call
    with mock.patch.object(cuda_norm, "layer_norm_cuda",
                           spy("fwd", cuda_norm.layer_norm_cuda)), \
            mock.patch.object(cuda_norm, "layer_norm_bwd_cuda",
                              spy("bwd", cuda_norm.layer_norm_bwd_cuda)):
        yield seen


def _f32_check(what, got, ref, reduced=False):
    """An f32 output within 1e-5 (abs + rel), the absolute part of a sum
    over rows 1e-5 of its largest sum (tests/test_torch_cuda.py's f32
    tolerance)."""
    scale = float(ref.abs().max()) if reduced else 1.0
    return _check_close(what, got, ref, 1e-5 * scale, 1e-5)


def phase_parity_amp(seed):
    """The kernels at the dtype mixes of the AMP step, against their
    plain versions at its shapes: the LayerNorm forward and backward on
    bf16 x with f32 gamma and beta (25 of the step's 26 LayerNorms) and
    on f32 x (the embedding's), the dropout kernel on f32 (the
    embedding's); returns {kernel instance: max abs error}."""
    import torch
    from mxnet_tpu_torch.ops import cuda_dropout, cuda_norm
    randn = _randn(seed + 31)
    M, C = TRAIN_BATCH * TRAIN_SEQ, UNITS
    errs = {}
    x, dy = randn(M, C, scale=2.0), randn(M, C)
    g, b = randn(C).float() + 1, randn(C).float()
    for xx, dyy in ((x, dy), (x.float(), dy.float())):
        tag = "x %s, gamma f32" % str(xx.dtype)[6:]
        f32 = xx.dtype == torch.float32
        got = cuda_norm.layer_norm_cuda(xx, g, b, 1e-5)
        ref = cuda_norm.layer_norm_plain(xx, g, b, 1e-5)
        name = "layer_norm_fwd (%d, %d) %s" % (M, C, tag)
        errs["layer_norm_fwd_amp " + tag] = _f32_check(name, got, ref) \
            if f32 else _check_close(name, got, ref, KERNEL_ATOL,
                                     KERNEL_RTOL, KERNEL_EQUAL)
        got = cuda_norm.layer_norm_bwd_cuda(dyy, xx, g, 1e-5)
        ref = cuda_norm.layer_norm_bwd_plain(dyy, xx, g, 1e-5)
        if got[1].dtype != torch.float32 or got[2].dtype != torch.float32:
            raise SmokeFailure("layer_norm_bwd %s: dgamma/dbeta in %s"
                               % (tag, got[1].dtype))
        out = []
        for i, (n, a, r_) in enumerate(zip(("dx", "dgamma", "dbeta"), got,
                                           ref)):
            name = "layer_norm_bwd %s (%d, %d) %s" % (n, M, C, tag)
            # dgamma and dbeta are f32 sums over rows in either case
            out.append(_f32_check(name, a, r_, reduced=i > 0) if f32 or i
                       else _check_close(name, a, r_, KERNEL_ATOL,
                                         KERNEL_RTOL, KERNEL_EQUAL))
        errs["layer_norm_bwd_amp " + tag] = max(out)
    xd = randn(M, C).float() + 3
    seed_t = torch.tensor([seed * 7919 + 5], dtype=torch.int32, device=DEV)
    got = cuda_dropout.dropout_cuda(xd, 0.1, seed_t)
    ref = cuda_dropout.dropout_plain(xd, 0.1, seed_t)
    errs["dropout_amp f32"] = _f32_check("dropout p=0.1 (%d, %d) f32"
                                         % (M, C), got, ref)
    _drop_pattern("dropout mask (%d, %d) f32" % (M, C), got, ref)
    return errs


def _amp_step(net, mlm, trainer, batch):
    """One training step; returns the per-position loss (f32)."""
    import mxnet_tpu_torch as mx
    ids, tok, lab = batch
    with mx.autograd.record():
        per_position = mlm(net(ids, tok)[0], lab)
        loss = per_position.mean()
    loss.backward()
    trainer.step(TRAIN_BATCH)
    return per_position


def _peak_mb(fn):
    """Device memory ``fn()`` allocates at its peak above what was
    allocated before, in MB."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def _head_check(net, mlm, batch):
    """The chunked head against the full-vocab head on the step's hidden
    states (bf16 under AMP) and f32 head weights: the loss and dh, dW
    and db; a control pads the vocab with 0 bias logits. Then each
    head's device time and peak memory, the dense mode's (Dense,
    log_softmax, pick) beside them."""
    import torch
    from unittest import mock
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.ops import contrib_ops
    ids, tok, lab = batch
    with torch.no_grad():
        h = mlm.layer_norm(mlm.transform(net(ids, tok)[0]))
    H = h.tensor().detach()
    W = mlm.head_weight.data().tensor().detach()
    B = mlm.head_bias.data().tensor().detach()
    LAB = lab.tensor()
    print("[amp] head inputs: hidden %s %s, weight %s %s, bias %s; chunk %d"
          % (tuple(H.shape), str(H.dtype)[6:], tuple(W.shape),
             str(W.dtype)[6:], str(B.dtype)[6:],
             contrib_ops.ce_chunk_size(0, VOCAB)))

    def head(op):
        ts = [t.clone().requires_grad_() for t in (H, W, B)]
        loss = op(*ts, LAB)
        return [loss.detach()] + list(torch.autograd.grad(loss.mean(), ts))

    def compare(tag, got, ref):
        loss_err = float(((got[0] - ref[0]).abs()
                          / (HEAD_LOSS_TOL + HEAD_LOSS_TOL
                             * ref[0].abs())).max())
        errs = [float((a.float() - r.float()).abs().max()
                      / r.float().abs().max()) for a, r in zip(got[1:],
                                                               ref[1:])]
        fail = loss_err > 1 or max(errs) >= HEAD_GRAD_TOL or \
            not torch.isfinite(got[0]).all()
        verdict = ("caught" if fail else "MISSED") if tag == "control" \
            else ("FAIL" if fail else "ok")
        print("[%s] chunked vs full-vocab head: loss max |err| %.3g "
              "(%.3g of %g + %g|ref|); max abs err / max |ref|: dh %.3g, "
              "dW %.3g, db %.3g (limit %g) %s"
              % (tag, float((got[0] - ref[0]).abs().max()), loss_err,
                 HEAD_LOSS_TOL, HEAD_LOSS_TOL, *errs, HEAD_GRAD_TOL,
                 verdict))
        return fail

    full = head(contrib_ops.fused_lm_head_ce)
    chunked = head(contrib_ops.chunked_lm_head_ce)
    if compare("amp", chunked, full):
        raise SmokeFailure("the chunked LM head differs from the full-vocab "
                           "head")
    with mock.patch.object(contrib_ops, "_NEG_BIG", 0.0):
        if not compare("control", head(contrib_ops.chunked_lm_head_ce),
                       full):
            raise SmokeFailure("control: the head check passed a chunked "
                               "head that pads with 0 bias logits")
    del full, chunked

    arrs = [NDArray(t.clone()) for t in (H, W, B)]
    for a in arrs:
        a.attach_grad()

    def op_head(name):
        def run():
            with mx.autograd.record():
                loss = getattr(mx.nd, name)(*arrs, lab).mean()
            loss.backward()
        return run

    def dense():
        with mx.autograd.record():
            logits = mx.nd.FullyConnected(*arrs, num_hidden=VOCAB,
                                          flatten=False)
            logp = mx.nd.log_softmax(logits, axis=-1)
            loss = mx.nd.negative(mx.nd.pick(logp, lab, axis=-1)).mean()
        loss.backward()
    out = {}
    for mode, fn in (("chunked", op_head("_contrib_chunked_lm_head_ce")),
                     ("full-vocab (fused)",
                      op_head("_contrib_fused_lm_head_ce")),
                     ("dense", dense)):
        peak = _peak_mb(fn)
        ms = _gpu_ms(fn, reps=3, trials=5)
        out[mode] = (ms, peak)
        print("[amp] LM head forward + backward, %s: %.3f ms device time "
              "(CUDA events, median of 5 x 3 calls), peak memory +%.1f MB"
              % (mode, ms, peak))
    for mode, fn in (("chunked", op_head("_contrib_chunked_lm_head_ce")),
                     ("dense", dense)):
        _profile("LM head forward + backward, %s" % mode, fn)
    return out


def phase_amp(seed):
    """Train BERT-base under bf16 AMP with the default head; returns the
    launch counts of one AMP step."""
    import math
    import torch
    from unittest import mock
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.ops import cuda_build, cuda_norm
    t0 = time.perf_counter()
    amp.init(target_dtype="bfloat16")
    try:
        net, mlm, params = _build_amp(seed)
        batch = _train_batch(seed)
        torch.cuda.synchronize()
        print("[amp] bert_12_768_12 (dropout 0.1) + BERTMLMLoss() (mode %r), "
              "%d parameters in %d arrays, f32 under amp.init('bfloat16'), "
              "built from seed %d in %.1f s"
              % (mlm._resolve_mode(), sum(p.data().size
                                          for p in params.values()),
                 len(params), seed, time.perf_counter() - t0))

        # one forward and backward: kernels, plain versions, f32 twin
        kern = _fwd_bwd(net, mlm, params, batch, seed)
        with _plain_kernels():
            before = cuda_build.launch_counts()
            plain = _fwd_bwd(net, mlm, params, batch, seed)
            amp.reset()
            try:
                with _plain_kernels(f32_twin=True), _no_tf32():
                    twin = _fwd_bwd(net, mlm, params, batch, seed)
            finally:
                amp.init(target_dtype="bfloat16")
            if cuda_build.launch_counts() != before:
                raise SmokeFailure("the plain runs launched a kernel")
        if not math.isfinite(float(kern[0])):
            raise SmokeFailure("AMP loss is not finite: %s" % float(kern[0]))
        checks = _train_compare("amp parity", kern, plain, twin,
                                limit=AMP_RATIO)
        ratios = sorted(((r, n) for (r, _), n in
                         zip(checks, ["loss"] + list(plain[1]))),
                        reverse=True)
        print("[amp] loss: kernels %.6f, plain %.6f, f32 twin without AMP "
              "%.6f" % (float(kern[0]), float(plain[0]), float(twin[0])))
        print("[amp] step vs plain step: %d ratios, largest %s (limit %g), "
              "median %.3g" % (len(ratios), ", ".join(
                  "%s %.3g" % (n, r) for r, n in ratios[:4]), AMP_RATIO,
                  ratios[len(ratios) // 2][0]))
        if any(fail for _, fail in checks):
            raise SmokeFailure("the AMP step differs from the plain step by "
                               "more than %g times AMP's own error"
                               % AMP_RATIO)

        # control: the LayerNorm backward drops dgamma where x is bf16
        # and gamma f32 (its kernel still launches)
        real = cuda_norm.layer_norm_bwd

        def dgamma_dropped(dy, x, gamma, eps):
            dx, dg, db = real(dy, x, gamma, eps)
            if x.dtype != gamma.dtype:
                dg = torch.zeros_like(dg)
            return dx, dg, db
        with mock.patch.object(cuda_norm, "layer_norm_bwd", dgamma_dropped):
            bad = _fwd_bwd(net, mlm, params, batch, seed)
        caught = [(n, r) for (r, fail), n in zip(
            _train_compare("control", bad, plain, twin, limit=AMP_RATIO),
            ["loss"] + list(plain[1])) if fail]
        print("[control] layer_norm_bwd dgamma dropped for bf16 x, f32 "
              "gamma: %d of %d checks fail (%s)"
              % (len(caught), len(plain[1]) + 1, ", ".join(
                  "%s %.3g" % c for c in caught[:3])))
        if not caught:
            raise SmokeFailure("control: the AMP check passed a LayerNorm "
                               "backward that drops dgamma")
        del kern, plain, twin, bad

        # the launches of one full step, then LAMB with the schedule
        sched = mx.lr_scheduler.PolyScheduler(base_lr=1e-3, **AMP_POLY)
        trainer = mx.gluon.Trainer(params, "lamb", {
            "learning_rate": 1e-3, "wd": 0.01, "lr_scheduler": sched})
        losses = []
        for step in range(AMP_STEPS):
            if step == 0:
                cuda_build.reset_launch_counts()
                with _ln_instances() as inst:
                    per_position = _amp_step(net, mlm, trainer, batch)
                    torch.cuda.synchronize()
                counts = cuda_build.launch_counts()
                print("[amp] launches in one step: %s; LayerNorm instances: "
                      "forward %s, backward %s" % (counts, inst["fwd"],
                                                   inst["bwd"]))
                if counts != TRAIN_LAUNCHES or \
                        inst["fwd"] != AMP_LN_INSTANCES or \
                        inst["bwd"] != AMP_LN_INSTANCES:
                    raise SmokeFailure(
                        "launch counts of one AMP step %s with LayerNorm "
                        "instances %s, expected %s and %s"
                        % (counts, inst, TRAIN_LAUNCHES, AMP_LN_INSTANCES))
            else:
                per_position = _amp_step(net, mlm, trainer, batch)
            losses.append(float(per_position.tensor().detach().mean()))
        print("[amp] LAMB with PolyScheduler(%s) on one fixed batch, loss "
              "per step: %s (lr at the last step %.3g)"
              % (", ".join("%s=%s" % kv for kv in AMP_POLY.items()),
                 " ".join("%.4f" % v for v in losses),
                 trainer.learning_rate))
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            raise SmokeFailure("AMP training did not lower the loss: %s"
                               % losses)

        _head_check(net, mlm, batch)
        ms = _host_ms(lambda: _amp_step(net, mlm, trainer, batch))
        print("[times] AMP training step (batch %d x seq %d, LAMB, chunked "
              "head): %.2f ms per step, %.1f samples/s (host clock, median "
              "of 5)" % (TRAIN_BATCH, TRAIN_SEQ, ms, TRAIN_BATCH / ms * 1e3))
        _attention_share(_profile(
            "one AMP training step (batch %d x seq %d, LAMB)"
            % (TRAIN_BATCH, TRAIN_SEQ),
            lambda: _amp_step(net, mlm, trainer, batch)))
    finally:
        amp.reset()
    return counts


def phase_amp_fp16(seed):
    """BERT at full width and FP16_LAYERS layers in float16: master
    weights, amp.init('float16'), the dynamic loss scaler; a planted
    non-finite gradient must halve the scale and zero the step."""
    import math
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.ops import cuda_build
    amp.init(target_dtype="float16")
    try:
        net, mlm, params = _build_amp(seed, FP16_LAYERS, "float16")
        batch = _train_batch(seed)
        sched = mx.lr_scheduler.PolyScheduler(base_lr=1e-3, **AMP_POLY)
        trainer = mx.gluon.Trainer(params, "lamb", {
            "learning_rate": 1e-3, "wd": 0.01, "multi_precision": True,
            "lr_scheduler": sched})
        amp.init_trainer(trainer)
        scaler = trainer._amp_loss_scaler
        ids, tok, lab = batch
        planted = FP16_STEPS // 2
        losses, scales = [], []
        cuda_build.reset_launch_counts()
        for step in range(FP16_STEPS):
            with mx.autograd.record():
                per_position = mlm(net(ids, tok)[0], lab)
                loss = per_position.mean()
                with amp.scale_loss(loss, trainer) as scaled:
                    pass
            scaled.backward()
            before = scaler.loss_scale
            if step == planted:
                next(iter(params.values())).grad().tensor().view(-1)[0] = \
                    float("inf")
            amp.unscale(trainer)
            if step == planted:
                zero = all(not bool(p.grad().tensor().any())
                           for p in params.values())
                print("[amp fp16] planted inf at step %d: loss scale %g -> "
                      "%g, every gradient zero: %s"
                      % (step, before, scaler.loss_scale, zero))
                if scaler.loss_scale != before / 2 or not zero:
                    raise SmokeFailure("a non-finite gradient did not halve "
                                       "the loss scale and zero the step")
            elif scaler.last_overflow:
                print("[amp fp16] overflow at step %d: loss scale %g -> %g"
                      % (step, before, scaler.loss_scale))
            trainer.step(TRAIN_BATCH)
            losses.append(float(per_position.tensor().detach().mean()))
            scales.append(scaler.loss_scale)
        torch.cuda.synchronize()
        counts = {k: v for k, v in cuda_build.launch_counts().items() if v}
        masters = {str(s[1].dtype) for s in
                   trainer._updater.states.values()}
        print("[amp fp16] %d layers, float16 with f32 masters (%s), LAMB "
              "multi_precision, loss per step: %s; loss scale per step: %s; "
              "launches in %d steps: %s"
              % (FP16_LAYERS, ", ".join(sorted(masters)),
                 " ".join("%.4f" % v for v in losses),
                 " ".join("%g" % v for v in scales), FP16_STEPS, counts))
        if masters != {"float32"}:
            raise SmokeFailure("float16 weights without f32 masters: %s"
                               % masters)
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            raise SmokeFailure("float16 training did not lower the loss: %s"
                               % losses)
    finally:
        amp.reset()


# ---------------------------------------------------------------------------
# ResNet-50: the dual-backward kernel, the fused stages, Gluon training
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _no_tf32():
    """f32 matmuls and convolutions in full f32 (cuDNN's convolutions
    take TF32 by default, which would make an f32 yardstick wrong)."""
    import torch
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def _dual_calls():
    """The distinct dual_bwd calls of one backward of the fused stages:
    (name, M, I, O, mask_mode, addend, emit_jg, emit_next, launches per
    backward). In a stage of n blocks: the last block's tail masks by the
    join and emits jg, the other tails take the pre-masked jg; block 0's
    head adds the shortcut gradient (in stage 1 the downsample's kernel
    does), the other heads add it and emit the chaining sums."""
    calls = []
    for st, (n, cin, c, cout, side) in enumerate(STAGES):
        M, tag = side * side * STAGE_BATCH, "stage%d " % (st + 1)
        calls += [(tag + "tail", M, c, cout, "out", False, True, False, 1),
                  (tag + "chained tail", M, c, cout, "none", False, False,
                   False, n - 1),
                  (tag + "chained head", M, cout, c, "scale_shift", True,
                   False, True, n - 1),
                  (tag + "first head", M, cin, c, "scale_shift", st > 0,
                   False, False, 1)]
        if st == 0:
            calls.append((tag + "downsample", M, cin, cout, "none", True,
                          False, False, 1))
    assert sum(c[-1] for c in calls) == STAGE_LAUNCHES
    return calls


def _dual_args(randn, M, I, O, mask_mode, addend, emit_next):
    import torch
    args = [randn(M, O), randn(M, O), randn(M, I), randn(I, O, scale=I ** -0.5),
            torch.cat([randn(1, O).float(), randn(2, O).float() * 0.1,
                       randn(1, O).float(), randn(1, O).float() * 0.5,
                       torch.zeros(3, O, device=DEV)]), mask_mode]
    kw = {}
    if mask_mode == "out":
        kw["mask"] = randn(M, O)
    if addend:
        kw["addend"] = randn(M, I)
    if emit_next:
        kw["y3p"] = randn(M, I)
        kw["mprev"] = randn(I).float() * 0.1
    return args, kw


def phase_parity_resnet(seed):
    """dual_bwd against its plain version for every variant of the
    fused stages' backward at ResNet-50's stage shapes, plus every option
    at once; returns the largest error."""
    import torch
    from mxnet_tpu_torch.ops import cuda_fused
    randn = _randn(seed + 20)
    worst = 0.0
    calls = _dual_calls() + [("all options", 1568, 2048, 512, "out", True,
                              True, True, 0)]
    for name, M, I, O, mode, addend, emit_jg, emit_next, _ in calls:
        args, kw = _dual_args(randn, M, I, O, mode, addend, emit_next)
        got = cuda_fused.dual_bwd_cuda(*args, emit_jg=emit_jg, **kw)
        ref = cuda_fused.dual_bwd_plain(*args, emit_jg=emit_jg, **kw)
        what = "dual_bwd %s (%d, %d, %d) %s" % (name, M, I, O, mode)
        worst = max(worst, _check_close(what + " dx", got[0], ref[0],
                                        KERNEL_ATOL, KERNEL_RTOL,
                                        KERNEL_EQUAL))
        # an f32 sum over M rows: the tolerance scales with the largest
        _check_close(what + " dW", got[1], ref[1],
                     1e-5 * float(ref[1].abs().max()), 1e-5)
        if emit_jg:
            _check_close(what + " jg", got[2], ref[2], 0.0, 0.0, 1.0)
        if emit_next:
            # the sums are of the kernel's own rounded dx
            dxf = got[0].float()
            want = torch.stack([dxf.sum(0), (dxf * (kw["y3p"].float()
                                                    - kw["mprev"])).sum(0)])
            _check_close(what + " sums", got[3], want,
                         1e-5 * float(want.abs().max()), 1e-5)
    return worst


def _stage_inputs(seed):
    """Random weights and inputs of the four fused stages: per stage
    (x, [block params], head cotangent), x post-relu HWNC bf16."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed + 30)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=DEV) * scale

    def bn(c):
        return [torch.rand(c, generator=g, device=DEV) + 0.5, rn(c, scale=0.1)]
    stages = []
    for st, (n, cin, c, cout, side) in enumerate(STAGES):
        blocks = []
        for b in range(n):
            i = cin if b == 0 else cout
            ps = [rn(i, c, scale=(2.0 / i) ** 0.5), *bn(c),
                  rn(3, 3, c, c, scale=(2.0 / (9 * c)) ** 0.5), *bn(c),
                  rn(c, cout, scale=(2.0 / c) ** 0.5), *bn(cout)]
            if st == 0 and b == 0:
                ps += [rn(i, cout, scale=(2.0 / i) ** 0.5), *bn(cout)]
            blocks.append(ps)
        x = torch.relu(rn(side, side, STAGE_BATCH, cin)).to(torch.bfloat16)
        head = rn(side, side, STAGE_BATCH, cout)
        stages.append((x, blocks, head))
    return stages


def _run_stages(stages, dtype=None):
    """Forward and backward of every fused stage: per stage [out, dx,
    every parameter's gradient]; ``dtype`` recasts the inputs (the f32
    twin)."""
    import torch
    from mxnet_tpu_torch.ops import cuda_fused
    res = []
    for st, (x, blocks, head) in enumerate(stages):
        x = (x if dtype is None else x.to(dtype)).detach().requires_grad_()
        ps = [[p.detach().requires_grad_() for p in b] for b in blocks]
        out, _ = cuda_fused.fused_stage(x, ps, data_format="HWNC",
                                        ds_first=st == 0)
        grads = torch.autograd.grad((out.float() * head).sum(),
                                    [x] + [p for b in ps for p in b])
        res.append([out.detach()] + list(grads))
    return res


def phase_stages(seed):
    """ResNet-50's four fused stages at full width with the kernel, held
    against the plain version; returns (launch counts, the inputs)."""
    import torch
    from unittest import mock
    from mxnet_tpu_torch.ops import cuda_build, cuda_fused
    stages = _stage_inputs(seed)
    cuda_build.reset_launch_counts()
    kern = _run_stages(stages)
    torch.cuda.synchronize()
    counts = cuda_build.launch_counts()
    print("[stages] launches of one forward and backward of the four "
          "fused stages (batch %d, HWNC bf16): %s" % (STAGE_BATCH, counts))
    want = dict({k: 0 for k in cuda_build.KERNELS}, dual_bwd=STAGE_LAUNCHES)
    if counts != want:
        raise SmokeFailure("fused stages: launch counts %s, expected %s"
                           % (counts, want))
    with _plain_kernels():
        plain = _run_stages(stages)
        with _no_tf32(), _plain_kernels(f32_twin=True):
            twin = _run_stages(stages, torch.float32)
    if cuda_build.launch_counts() != counts:
        raise SmokeFailure("the plain stages launched a kernel")

    def check(tag, got, quiet):
        out = []
        for st in range(len(STAGES)):
            for i, (a, r, t) in enumerate(zip(got[st], plain[st], twin[st])):
                what = "stage%d %s" % (st + 1, "out" if i == 0 else
                                       "dx" if i == 1 else "grad %d" % (i - 2))
                out.append((_slice_check(tag, what, a, r, t, STAGE_RATIO,
                                         quiet), what))
        return out
    checks = check("parity", kern, True)
    worst = max(checks, key=lambda c: c[0][0])
    print("[stages] kernel vs plain: %d checks, largest ratio %.3g (%s), "
          "limit %g" % (len(checks), worst[0][0], worst[1], STAGE_RATIO))
    if any(c[0][1] for c in checks):
        raise SmokeFailure("the fused stages differ from the plain stages "
                           "by more than %g times bf16's own error"
                           % STAGE_RATIO)

    # control: the head kernel's residual-gradient addend dropped
    real = cuda_fused.dual_bwd

    def addend_dropped(*args, **kw):
        if args[5] == "scale_shift":
            kw["addend"] = None
        return real(*args, **kw)
    with mock.patch.object(cuda_fused, "dual_bwd", addend_dropped):
        bad = _run_stages(stages)
    caught = [w for (r, fail), w in check("control", bad, True) if fail]
    print("[control] head addend dropped: %d of %d checks fail (%s)"
          % (len(caught), len(checks), ", ".join(caught[:3])))
    if not caught:
        raise SmokeFailure("control: the stage check passed a head kernel "
                           "that drops the shortcut gradient")
    return counts, stages


def _resnet_batch(seed):
    import torch
    import mxnet_tpu_torch as mx
    g = torch.Generator(device=DEV).manual_seed(seed + 40)
    x = torch.randn(RESNET_BATCH, 3, RESNET_SIDE, RESNET_SIDE, generator=g,
                    device=DEV)
    y = torch.randint(0, 1000, (RESNET_BATCH,), generator=g, device=DEV)
    return mx.nd.NDArray(x.to(torch.bfloat16)), mx.nd.NDArray(y.float())


def _resnet_grads(net, loss_fn, params, x, y):
    """One forward and backward; returns the f32 mean loss and every
    gradient as f32."""
    import mxnet_tpu_torch as mx
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    return (float(loss.tensor().detach().float().mean()),
            {n: p.grad().tensor().float().clone() for n, p in params.items()
             if p.grad_req != "null"})


def _stem_stats_check(tag, net, x, before):
    """The stem BatchNorm's moving statistics after one training step
    from ``before``, against the batch statistics of the stem
    convolution computed here: mean' = m * mean + (1 - m) * batch mean,
    likewise the variance, m = 0.9. Returns whether they are beyond a
    1e-3 relative tolerance."""
    import torch
    import torch.nn.functional as F
    conv, bn = net.features[0], net.features[1]
    with torch.no_grad():
        w = conv.weight.data().tensor()
        y = F.conv2d(x.tensor().to(w.dtype), w, stride=2, padding=3).float()
        mean = y.mean(dim=(0, 2, 3))
        var = y.var(dim=(0, 2, 3), unbiased=False)
    m0, v0 = before
    want = [0.9 * m0 + 0.1 * mean, 0.9 * v0 + 0.1 * var]
    got = [bn.running_mean.data().tensor(), bn.running_var.data().tensor()]
    errs = [float(((a - b).abs() / (b.abs() + 1e-3)).max())
            for a, b in zip(got, want)]
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    fail = not finite or max(errs) > 1e-3
    print("[%s] stem BatchNorm moving mean/var after one step: relative "
          "errors %.3g, %.3g (tol 1e-3) %s" % (
              tag, errs[0], errs[1],
              ("caught" if fail else "MISSED") if tag == "control"
              else ("FAIL" if fail else "ok")))
    return fail


def phase_resnet(seed, steps):
    """ResNet-50 v1 trained through Gluon on the card; returns (launch
    counts of one step, the step function)."""
    import math
    import torch
    from unittest import mock
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.ops import cuda_build
    from mxnet_tpu_torch.ops import nn as nn_ops
    t0 = time.perf_counter()
    mx.random.seed(seed)
    net = resnet50_v1(prefix="resnet50_")
    net.initialize(init=mx.init.MSRAPrelu())
    with torch.no_grad():
        net(mx.nd.zeros((1, 3, RESNET_SIDE, RESNET_SIDE)))
    net.cast("bfloat16")
    params = net.collect_params()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = _resnet_batch(seed)
    stats = {n: p for n, p in params.items() if p._is_aux}
    init_stats = {n: p.data().tensor().clone() for n, p in stats.items()}

    def reset_stats():
        for n, p in stats.items():
            p.set_data(init_stats[n])
    torch.cuda.synchronize()
    print("[resnet] resnet50_v1 (MSRAPrelu from seed %d) cast to bf16 with "
          "BatchNorm in f32: %d parameters in %d arrays (%d moving "
          "statistics), built in %.1f s"
          % (seed, sum(p.data().size for p in params.values()), len(params),
             len(stats), time.perf_counter() - t0))

    # one step: bf16, then its f32 twin on the same (bf16-valued) weights
    stem = net.features[1]
    stem_before = (stem.running_mean.data().tensor().clone(),
                   stem.running_var.data().tensor().clone())
    loss16, g16 = _resnet_grads(net, loss_fn, params, x, y)
    if _stem_stats_check("resnet", net, x, stem_before):
        raise SmokeFailure("the moving statistics of the stem BatchNorm are "
                           "not the momentum-0.9 update of its batch "
                           "statistics")
    moved = [n for n, p in stats.items()
             if not torch.equal(p.data().tensor(), init_stats[n])]
    finite = all(bool(torch.isfinite(p.data().tensor()).all())
                 for p in stats.values())
    print("[resnet] one step moved %d of %d moving statistics, all finite: "
          "%s" % (len(moved), len(stats), finite))
    if len(moved) != len(stats) or not finite:
        raise SmokeFailure("moving statistics did not all move, or are not "
                           "finite")
    # control: the moving-stat momentum swapped (0.1 for 0.9)
    reset_stats()
    bns = [b for b in _walk(net) if isinstance(b, mx.gluon.nn.BatchNorm)]
    for b in bns:
        b._kwargs["momentum"] = 0.1
    try:
        _resnet_grads(net, loss_fn, params, x, y)
    finally:
        for b in bns:
            b._kwargs["momentum"] = 0.9
    if not _stem_stats_check("control", net, x, stem_before):
        raise SmokeFailure("control: the moving-statistics check passed a "
                           "swapped momentum")

    reset_stats()
    net.cast("float32")
    with _no_tf32():
        loss32, g32 = _resnet_grads(net, loss_fn, params,
                                    mx.nd.NDArray(x.tensor().float()), y)
    net.cast("bfloat16")
    reset_stats()

    # the biases of the convolutions in front of a BatchNorm get a zero
    # gradient up to rounding (the BatchNorm removes any shift): their
    # f32 norm is rounding noise, and no yardstick
    norms = {n: float(g.norm()) for n, g in g32.items()}
    floor = 1e-4 * statistics.median(norms.values())
    noise = sorted(n for n, v in norms.items() if v < floor)
    held = [n for n in g32 if n not in noise]

    def rel_l2(got, ref):
        return {n: float((got[n] - ref[n]).norm() / norms[n]) for n in held}
    errs = rel_l2(g16, g32)
    ranked = sorted(errs.items(), key=lambda kv: -kv[1])
    print("[resnet] loss bf16 %.6f, f32 twin %.6f; %d gradient arrays at "
          "rounding noise in f32 (norm below %.3g, e.g. %s) not held"
          % (loss16, loss32, len(noise), floor, ", ".join(noise[:2])))
    loss_rel = abs(loss16 - loss32) / abs(loss32)
    print("[resnet] gradients vs the f32 twin, relative L2 over %d arrays: "
          "largest %s, median %.3g (limit %g); loss relative difference "
          "%.3g (limit %g)" % (len(errs), ", ".join(
              "%s %.3g" % kv for kv in ranked[:3]),
              ranked[len(ranked) // 2][1], RESNET_REL_L2, loss_rel,
              RESNET_LOSS_REL))
    if not math.isfinite(loss16) or ranked[0][1] > RESNET_REL_L2 or \
            loss_rel > RESNET_LOSS_REL:
        raise SmokeFailure("the ResNet-50 step is beyond its limits from "
                           "its f32 twin")
    # control: BatchNorm's shift dropped from the training forward
    with mock.patch.object(nn_ops, "_bn_apply",
                           lambda xx, scale, shift: xx * scale.to(xx.dtype)):
        loss_bad, gbad = _resnet_grads(net, loss_fn, params, x, y)
    reset_stats()
    bad = sorted(rel_l2(gbad, g32).items(), key=lambda kv: -kv[1])
    caught = [kv for kv in bad if kv[1] > RESNET_REL_L2]
    bad_loss = abs(loss_bad - loss32) / abs(loss32)
    print("[control] BatchNorm shift dropped: %d of %d gradients beyond the "
          "limit (%s); loss relative difference %.3g" % (
              len(caught), len(bad), ", ".join(
                  "%s %.3g" % kv for kv in caught[:3]), bad_loss))
    if not caught and not bad_loss > RESNET_LOSS_REL:
        raise SmokeFailure("control: the gradient check passed a BatchNorm "
                           "without its shift")

    # SGD on the fixed batch: launch counts of the first step, the loss
    trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.1,
                                               "momentum": 0.9})

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(RESNET_BATCH)
        return loss
    losses = []
    for i in range(steps):
        if i == 0:
            cuda_build.reset_launch_counts()
        losses.append(float(step().tensor().detach().float().mean()))
        if i == 0:
            torch.cuda.synchronize()
            counts = cuda_build.launch_counts()
    print("[resnet] launches of one Gluon step: %s" % counts)
    print("[resnet] SGD (lr 0.1, momentum 0.9) on one fixed batch of %d, "
          "loss per step (f32 mean): %s" % (RESNET_BATCH, " ".join(
              "%.4f" % v for v in losses)))
    if not all(math.isfinite(v) for v in losses) or \
            not min(losses[1:]) < losses[0] - RESNET_FALL:
        raise SmokeFailure("ResNet-50 training did not lower the loss by "
                           "%g: %s" % (RESNET_FALL, losses))
    print("[resnet] loss %.4f at the first step, lowest %.4f (step %d)"
          % (losses[0], min(losses), losses.index(min(losses)) + 1))
    return counts, step


def _walk(block):
    yield block
    for child in block._children.values():
        yield from _walk(child)


def _dual_library(args, kw, emit_jg):
    """The same function from PyTorch calls: the masked cdy, then two
    bf16 matmuls (cuBLAS)."""
    import torch
    jg, y, x, w, coef, mode = args
    jgf, yv = jg.float(), y.float()
    if mode == "scale_shift":
        jgf = torch.where(yv * coef[3] + coef[4] > 0, jgf, 0.0)
    elif mode == "out":
        jgf = torch.where(kw["mask"] > 0, jgf, 0.0)
    jg_out = jgf.to(torch.bfloat16) if emit_jg else None
    cdy = (jgf * coef[0] + yv * coef[1] + coef[2]).to(torch.bfloat16)
    dx = torch.matmul(cdy, w.t())
    if "addend" in kw:
        dx = dx + kw["addend"]
    sums = None
    if "y3p" in kw:
        dx = torch.where(x > 0, dx, 0.0)
        dxf = dx.float()
        sums = (dxf.sum(0), (dxf * (kw["y3p"].float() - kw["mprev"])).sum(0))
    return dx, torch.matmul(x.t(), cdy), jg_out, sums


def phase_times_resnet(seed, reps, counts, err, card, stages, resnet_step):
    """Times of the dual backward per call shape (kernel, plain version,
    the PyTorch composition, bound), the fused stages' backward, the
    ResNet-50 step; returns the kernel's row."""
    from unittest import mock
    import torch
    from mxnet_tpu_torch.ops import cuda_build, cuda_fused
    randn = _randn(seed + 21)
    bw, bf16_peak, _ = _peaks(card)
    sms = cuda_build.sm_count(torch.device(DEV))
    shapes = []
    for (name, M, I, O, mode, addend, emit_jg, emit_next,
         per_step) in _dual_calls():
        args, kw = _dual_args(randn, M, I, O, mode, addend, emit_next)
        ms = _gpu_ms(lambda: cuda_fused.dual_bwd_cuda(
            *args, emit_jg=emit_jg, **kw), reps)
        plain_ms = _gpu_ms(lambda: cuda_fused.dual_bwd_plain(
            *args, emit_jg=emit_jg, **kw), reps)
        lib_ms = _gpu_ms(lambda: _dual_library(args, kw, emit_jg), reps)
        # each input read once, each output written once (bf16 2 B, f32 4)
        mo, mi = M * O * 2, M * I * 2
        nbytes = (2 * mo + mi + I * O * 2 + 8 * O * 4     # jg, y, x, w, coef
                  + (mo if mode == "out" else 0) + (mi if addend else 0)
                  + (mi + I * 4 if emit_next else 0)
                  + mi + I * O * 4 + (mo if emit_jg else 0)   # dx, dW, jg
                  + (2 * I * 4 if emit_next else 0))
        flops = 2 * 2 * M * I * O
        t_bytes, t_ops = nbytes / bw * 1e3, flops / bf16_peak * 1e3
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")
        launch = _launch_ms(lambda: cuda_fused.dual_bwd_cuda(
            *args, emit_jg=emit_jg, **kw), reps)
        # where one block takes both products, the cdy pass's path too,
        # timed in turns with it: the cut-over
        general_ms = None
        if cuda_fused.dual_plan(M, I, O, sms, emit_next)["fused"]:
            real = cuda_fused.dual_plan
            general = {}
            for key in ("fused", "general", "general", "fused"):
                with mock.patch.object(
                        cuda_fused, "dual_plan",
                        lambda *a, **k: real(*a, **dict(
                            k, aligned=k["aligned"] and key == "fused"))):
                    general[key] = _gpu_ms(lambda: cuda_fused.dual_bwd_cuda(
                        *args, emit_jg=emit_jg, **kw), reps)
            ms, general_ms = general["fused"], general["general"]
        shapes.append({"call": name, "M": M, "I": I, "O": O,
                       "mask_mode": mode, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": lib_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "bytes": nbytes, "flops": flops,
                       "launches_per_step": per_step, "launch_ms": launch,
                       "cdy_pass_ms": general_ms})
        print("[times] dual_bwd %-20s (%6d, %4d, %4d) kernel %.4f ms  plain "
              "%.4f ms  library %.4f ms  bound %.4f ms (%s; %.1f MB, %.2f "
              "GFLOP); by launch: %s%s"
              % (name, M, I, O, ms, plain_ms, lib_ms, b_ms, b_by,
                 nbytes / 1e6, flops / 1e9,
                 ", ".join("%s %.4f" % kv for kv in launch.items()),
                 "" if general_ms is None else
                 "; the cdy pass's path instead %.4f ms" % general_ms))
    head = shapes[0]
    row = {"name": "dual_bwd", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/dual_bwd.cu",
           "replaces": "mxnet_tpu/ops/pallas_fused.py:64",
           "launches": counts["dual_bwd"],
           "launches_per_fused_step": counts["dual_bwd"],
           "max_abs_err": err, "ms": head["ms"],
           "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
           "bound_by": head["bound_by"], "library_ms": head["library_ms"],
           "timed_call": head["call"], "shapes": shapes}
    print("[times] dual_bwd over one backward of the four stages (%d "
          "launches at these shapes): kernel %.3f ms, plain %.3f ms, "
          "library %.3f ms, bound %.3f ms" % ((STAGE_LAUNCHES,) + tuple(
              sum(s[k] * s["launches_per_step"] for s in shapes)
              for k in ("ms", "plain_ms", "library_ms", "bound_ms"))))
    by_launch = {}
    for s in shapes:
        for k, v in s["launch_ms"].items():
            by_launch[k] = by_launch.get(k, 0.0) + v * s["launches_per_step"]
    row["launch_ms"] = by_launch
    print("[times] dual_bwd over one backward of the four stages, by launch "
          "(profiler, ms): %s" % ", ".join("%s %.3f" % kv
                                           for kv in by_launch.items()))

    fwd_bwd = _host_ms(lambda: _run_stages(stages))
    fwd = _host_ms(lambda: _stage_forwards(stages))
    print("[times] the four fused stages (batch %d, HWNC bf16): forward and "
          "backward %.2f ms, forward %.2f ms, backward %.2f ms (host clock, "
          "median of 5)" % (STAGE_BATCH, fwd_bwd, fwd, fwd_bwd - fwd))
    _profile("one forward and backward of the four fused stages",
             lambda: _run_stages(stages))
    ms = _host_ms(resnet_step)
    print("[times] ResNet-50 v1 Gluon step (batch %d at 224^2, bf16, SGD "
          "momentum): %.2f ms per step, %.1f images/s (host clock, median "
          "of 5)" % (RESNET_BATCH, ms, RESNET_BATCH / ms * 1e3))
    _profile("one ResNet-50 v1 Gluon step (batch %d, bf16, SGD)"
             % RESNET_BATCH, resnet_step)
    return row


def _stage_forwards(stages):
    import torch
    from mxnet_tpu_torch.ops import cuda_fused
    with torch.no_grad():
        for st, (x, blocks, _) in enumerate(stages):
            cuda_fused.fused_stage(x, blocks, data_format="HWNC",
                                   ds_first=st == 0)


# ---------------------------------------------------------------------------
# mx.rtc: user CUDA C compiled at runtime, and the MNIST MLP whose relu is
# a CustomOp launching two of its kernels
# ---------------------------------------------------------------------------
# The user module, as a user of mx.rtc writes it: saxpy and twoout are the
# reference's rtc tests (tests/test_rtc.py), relu_fwd and relu_bwd the
# MLP custom op's forward and backward.
RTC_SOURCE = r"""
// out = alpha * x + y
__global__ void saxpy(const float* __restrict__ x, const float* __restrict__ y,
                      float* __restrict__ out, float alpha, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = alpha * x[i] + y[i];
}

// a = 2 x, b = x + 1
__global__ void twoout(const float* __restrict__ x, float* __restrict__ a,
                       float* __restrict__ b, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) {
    float v = x[i];
    a[i] = v * 2.0f;
    b[i] = v + 1.0f;
  }
}

// y = max(x, 0)
__global__ void relu_fwd(const float* __restrict__ x, float* __restrict__ y,
                         long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) {
    float v = x[i];
    y[i] = v > 0.0f ? v : 0.0f;
  }
}

// dx = dy where the forward's output is positive, else 0
__global__ void relu_bwd(const float* __restrict__ dy,
                         const float* __restrict__ y, float* __restrict__ dx,
                         long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) dx[i] = y[i] > 0.0f ? dy[i] : 0.0f;
}
"""
RTC_KERNELS = ("saxpy", "twoout", "relu_fwd", "relu_bwd")
# elements of a timed launch, and the MLP's activation shapes
RTC_N = 1 << 24
MLP_SHAPES = ((64, 128), (64, 64))
# nvcc contracts saxpy's alpha * x + y into one FMA, where the plain
# version rounds twice; for non-negative inputs the two differ by at most
# one ulp of the result, which is at most 2^-23 of it
SAXPY_RTOL = 2.0 ** -23
# example/image_classification/train_mnist.py --synthetic
MNIST_EXAMPLES, MNIST_BATCH, MNIST_LR = 6000, 64, 0.1


def rtc_plain():
    """Each user kernel's plain function, in the reference's kernel
    convention: inputs, then outputs written in place."""
    import torch

    def saxpy(x, y, out, *, alpha):
        out[...] = alpha * x[...] + y[...]

    def twoout(x, a, b):
        a[...] = x[...] * 2.0
        b[...] = x[...] + 1.0

    def relu_fwd(x, y):
        y[...] = torch.where(x[...] > 0, x[...], 0.0)

    def relu_bwd(dy, y, dx):
        dx[...] = torch.where(y[...] > 0, dy[...], 0.0)

    return {"saxpy": saxpy, "twoout": twoout, "relu_fwd": relu_fwd,
            "relu_bwd": relu_bwd}


_RELU = {}


def register_rtc_relu(mx, module):
    """Register the custom op ``rtc_relu`` (once; a later call rebinds its
    kernels to ``module``'s): a ``CustomOp`` whose forward launches
    ``relu_fwd`` and whose backward launches ``relu_bwd`` on the forward's
    output. ``leak_grad=True`` is the planted fault: the backward passes
    dy through unmasked."""
    _RELU["fwd"] = module.get_kernel("relu_fwd")
    _RELU["bwd"] = module.get_kernel("relu_bwd")
    if mx.operator.get_prop("rtc_relu") is not None:
        return

    class RtcRelu(mx.operator.CustomOp):
        def __init__(self, leak_grad):
            self._leak = leak_grad

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        _RELU["fwd"].launch([in_data[0]]))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            dx = out_grad[0] if self._leak else \
                _RELU["bwd"].launch([out_grad[0], out_data[0]])
            self.assign(in_grad[0], req[0], dx)

    class RtcReluProp(mx.operator.CustomOpProp):
        def __init__(self, leak_grad=False):
            super().__init__(need_top_grad=True)
            self._leak = bool(leak_grad)

        def create_operator(self, ctx, shapes, dtypes):
            return RtcRelu(self._leak)

    mx.operator.register("rtc_relu")(RtcReluProp)


def mnist_mlp(mx, custom, leak_grad=False):
    """train_mnist.py's MLP, 784-128-64-10 with prefix ``mlp_``: its two
    relus a HybridBlock calling ``F.Custom(op_type="rtc_relu")`` when
    ``custom``, else ``Dense(activation="relu")``. Both have the same
    parameter names."""
    nn = mx.gluon.nn

    class RtcRelu(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.Custom(x, op_type="rtc_relu", leak_grad=leak_grad)

    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        if custom:
            net.add(nn.Dense(128), RtcRelu(), nn.Dense(64), RtcRelu(),
                    nn.Dense(10))
        else:
            net.add(nn.Dense(128, activation="relu"),
                    nn.Dense(64, activation="relu"), nn.Dense(10))
    return net


def mnist_synthetic(n=MNIST_EXAMPLES):
    """``train_mnist.py --synthetic``'s data: (X, y) for training and for
    validation, the last sixth held out."""
    import numpy as np
    rng = np.random.RandomState(42)
    W = rng.rand(784, 10).astype(np.float32)
    X = rng.rand(n, 1, 28, 28).astype(np.float32)
    y = (X.reshape(len(X), -1) @ W).argmax(axis=1).astype(np.float32)
    cut = -len(X) // 6
    return X[:cut], y[:cut], X[cut:], y[cut:]


def _rtc_counts():
    from mxnet_tpu_torch.ops import cuda_build
    counts = cuda_build.launch_counts()
    return {k: counts.get(cuda_build.RTC_PREFIX + k, 0) for k in RTC_KERNELS}


def _check_exact(what, got, ref):
    import torch
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise SmokeFailure("%s: %s %s != %s %s" % (
            what, tuple(got.shape), got.dtype, tuple(ref.shape), ref.dtype))
    diff = int((got != ref).sum())
    print("[parity] %-44s differing elements %d of %d (bit for bit) %s"
          % (what, diff, ref.numel(), "FAIL" if diff else "ok"))
    if diff:
        raise SmokeFailure("%s: %d elements differ from the plain function"
                           % (what, diff))


def phase_rtc(seed):
    """Build the user module, hold each kernel against its plain function,
    check the refusals and the planted fault, then launch as the
    reference's docstring does with the counts reset; returns (module,
    the two-output module, {kernel: max abs error}, launch counts)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_build
    plain = rtc_plain()
    t0 = time.perf_counter()
    mod = mx.rtc.CudaModule(RTC_SOURCE, plain=plain)
    path = mod.build()
    first = time.perf_counter() - t0
    stamp = path.stat().st_mtime_ns
    t0 = time.perf_counter()
    mod2 = mx.rtc.CudaModule(RTC_SOURCE, num_outputs=2, plain=plain)
    path2 = mod2.build()
    second = time.perf_counter() - t0
    print("[rtc] user module (%s) built in %.2f s into %s; a second "
          "CudaModule with the same source in %.4f s"
          % (", ".join(mod.exports), first, path.parent, second))
    if path2 != path or path2.stat().st_mtime_ns != stamp:
        raise SmokeFailure("a second CudaModule with the same source did not "
                           "reuse the first's build")

    g = torch.Generator(device=DEV).manual_seed(seed + 31)
    nd = mx.nd.NDArray
    kern = {"twoout": mod2.get_kernel("twoout"),
            "relu_fwd": mod.get_kernel("relu_fwd"),
            "relu_bwd": mod.get_kernel("relu_bwd")}

    def plain_run(name, ins, n_out=1, **attrs):
        outs = [torch.empty_like(ins[0]) for _ in range(n_out)]
        plain[name](*ins, *outs, **attrs)
        return outs

    errs = {k: 0.0 for k in RTC_KERNELS}
    for shape in ((RTC_N,),) + MLP_SHAPES:
        x = torch.rand(shape, generator=g, device=DEV)
        y = torch.rand(shape, generator=g, device=DEV)
        # alpha 2 as in the reference's test (2 x is exact, so the FMA
        # changes nothing), and 0.7, whose products round
        for alpha in (2.0, 0.7):
            got = mod.get_kernel("saxpy", alpha=alpha).launch(
                [nd(x), nd(y)]).tensor()
            ref, = plain_run("saxpy", [x, y], alpha=alpha)
            torch.cuda.synchronize()
            err = (got - ref).abs()
            bad = int((err > SAXPY_RTOL * ref.abs()).sum())
            print("[parity] %-44s max_abs_err=%.3g bit-equal %.5f, beyond "
                  "2^-23*|ref|: %d %s"
                  % ("rtc saxpy %s alpha %g" % (shape, alpha),
                     float(err.max()), float((got == ref).float().mean()),
                     bad, "FAIL" if bad else "ok"))
            if bad:
                raise SmokeFailure("rtc saxpy %s: %d elements beyond 2^-23 "
                                   "of the plain function" % (shape, bad))
            errs["saxpy"] = max(errs["saxpy"], float(err.max()))
        a, b = kern["twoout"].launch([nd(x)])
        ra, rb = plain_run("twoout", [x], 2)
        _check_exact("rtc twoout a %s" % (shape,), a.tensor(), ra)
        _check_exact("rtc twoout b %s" % (shape,), b.tensor(), rb)
        xs = torch.randn(shape, generator=g, device=DEV)
        xs.view(-1)[::7] = 0.0                   # exact zeros
        h = kern["relu_fwd"].launch([nd(xs)]).tensor()
        rh, = plain_run("relu_fwd", [xs])
        _check_exact("rtc relu_fwd %s" % (shape,), h, rh)
        dy = torch.randn(shape, generator=g, device=DEV)
        _check_exact("rtc relu_bwd %s" % (shape,),
                     kern["relu_bwd"].launch([nd(dy), nd(rh)]).tensor(),
                     plain_run("relu_bwd", [dy, rh])[0])

    before = cuda_build.launch_counts()
    refusals = [
        ("a const output pointer",
         lambda: mod2.get_kernel("saxpy", alpha=2.0)),
        ("a const output in a given signature",
         lambda: mod.get_kernel("relu_fwd", signature="const float* x, "
                                "const float* y, long long n")),
        ("a wrong dtype", lambda: kern["relu_fwd"].launch([nd(xs.half())])),
        ("a wrong input count", lambda: kern["relu_bwd"].launch([nd(xs)]))]
    for what, fn in refusals:
        try:
            fn()
        except mx.MXNetError as e:
            print("[rtc] %s refused: %s" % (what, e))
            continue
        raise SmokeFailure("rtc: %s was not refused" % what)
    if cuda_build.launch_counts() != before:
        raise SmokeFailure("rtc: a refused launch launched a kernel")

    bad_src = RTC_SOURCE.replace("y[i] > 0.0f ? dy[i]", "y[i] >= 0.0f ? dy[i]")
    if bad_src == RTC_SOURCE:
        raise SmokeFailure("control: the planted fault changed nothing")
    bad = mx.rtc.CudaModule(bad_src, exports=("relu_bwd",)).get_kernel(
        "relu_bwd").launch([nd(dy), nd(rh)]).tensor()
    torch.cuda.synchronize()
    diff = int((bad != plain_run("relu_bwd", [dy, rh])[0]).sum())
    print("[control] relu_bwd with >= for >: %d of %d elements differ from "
          "the plain function, %s" % (diff, dy.numel(),
                                      "caught" if diff else "MISSED"))
    if not diff:
        raise SmokeFailure("control: the rtc check passed relu_bwd with >=")

    # the reference docstring's launches, through NDArrays, counted
    rng = np.random.RandomState(seed)
    xa = mx.nd.array(rng.rand(8, 128), ctx=mx.gpu(0))
    ya = mx.nd.array(rng.rand(8, 128), ctx=mx.gpu(0))
    xm = xa - 0.5
    cuda_build.reset_launch_counts()
    out = mod.get_kernel("saxpy", alpha=2.0).launch([xa, ya])
    a, b = mod2.get_kernel("twoout").launch([xa])
    h = mod.get_kernel("relu_fwd").launch([xm])
    d = mod.get_kernel("relu_bwd").launch([ya, h])
    torch.cuda.synchronize()
    counts = _rtc_counts()
    xn, yn, hn = xa.asnumpy(), ya.asnumpy(), np.maximum(xm.asnumpy(), 0)
    for what, got, want in (("saxpy", out, 2 * xn + yn), ("twoout a", a, 2 * xn),
                            ("twoout b", b, xn + 1), ("relu_fwd", h, hn),
                            ("relu_bwd", d, np.where(hn > 0, yn, 0))):
        if not np.allclose(got.asnumpy(), want, rtol=1e-6, atol=1e-6):
            raise SmokeFailure("rtc user launch %s: wrong values" % what)
    print("[rtc] user launches through NDArrays: %s" % counts)
    if any(counts[k] != 1 for k in RTC_KERNELS):
        raise SmokeFailure("rtc: expected one launch of each user kernel, "
                           "got %s" % counts)
    return mod, mod2, errs, counts


def _mnist_step(net, trainer, loss_fn, data, label):
    import mxnet_tpu_torch as mx
    with mx.autograd.record():
        out = net(data)
        loss = loss_fn(out, label)
    loss.backward()
    trainer.step(data.shape[0])
    return out, loss


def _mnist_nets(mx, init, ctx, leak_grad=False):
    """The custom-op MLP and its Dense(relu) twin from the weights
    ``init``, each with its SGD trainer."""
    nets = {"custom": mnist_mlp(mx, True, leak_grad),
            "twin": mnist_mlp(mx, False)}
    out = {}
    for k, net in nets.items():
        mx.params_from_numpy(net, init, ctx=ctx)
        out[k] = (net, mx.gluon.Trainer(net.collect_params(), "sgd",
                                        {"learning_rate": MNIST_LR}))
    return out


def _mnist_diff(nets, loss, tloss):
    """(name, relative L2) of the first of the loss and the weights where
    the custom-op net and its twin differ; None where all are equal."""
    import torch
    pairs = [("loss", loss.tensor(), tloss.tensor())]
    twin = nets["twin"][0].collect_params()
    pairs += [(n, p.data().tensor(), twin[n].data().tensor())
              for n, p in nets["custom"][0].collect_params().items()]
    with torch.no_grad():
        for name, a, b in pairs:
            if not torch.equal(a, b):
                return name, float((a - b).norm() / b.norm().clamp_min(1e-30))
    return None


def phase_mnist(seed, mod, epochs):
    """Train the MNIST MLP with the rtc custom op beside its twin; returns
    (launch counts of the training run, launch counts of one step, the
    nets, the loss, one batch)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_build
    gdata = mx.gluon.data
    ctx = mx.gpu(0)
    X, y, Xv, yv = mnist_synthetic()
    register_rtc_relu(mx, mod)
    mx.random.seed(seed)
    net = mnist_mlp(mx, True)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net(mx.nd.zeros((1, 1, 28, 28), ctx=ctx))       # the deferred shapes
    init = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    nets = _mnist_nets(mx, init, ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    np.random.seed(seed)                            # the loader's shuffle
    train = gdata.DataLoader(gdata.ArrayDataset(X, y),
                             batch_size=MNIST_BATCH, shuffle=True)
    val = gdata.DataLoader(gdata.ArrayDataset(Xv, yv),
                           batch_size=MNIST_BATCH)
    print("[mnist] %d training and %d validation examples, %d + %d batches "
          "of %d; MLP 784-128-64-10 (%d parameters), Xavier from seed %d, "
          "SGD lr %g" % (len(X), len(Xv), len(train), len(val), MNIST_BATCH,
                         sum(v.size for v in init.values()), seed, MNIST_LR))
    accs, steps = [], 0
    with _no_tf32():
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        for epoch in range(epochs):
            metric = mx.metric.Accuracy()
            for data, label in train:
                out, loss = _mnist_step(*nets["custom"], loss_fn, data, label)
                _, tloss = _mnist_step(*nets["twin"], loss_fn, data, label)
                metric.update([label], [out])
                steps += 1
                diff = _mnist_diff(nets, loss, tloss)
                if diff is not None:
                    raise SmokeFailure(
                        "MNIST step %d: %s differs from the Dense(relu) "
                        "twin (relative L2 %.3g)" % ((steps,) + diff))
            vm = mx.metric.Accuracy()
            for data, label in val:
                vm.update([label], [nets["custom"][0](data)])
            accs.append(metric.get()[1])
            print("[mnist] epoch %d: train accuracy %.4f, validation "
                  "accuracy %.4f, loss of the last batch %.4f"
                  % (epoch + 1, accs[-1], vm.get()[1],
                     float(loss.asnumpy().mean())))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _rtc_counts()
    fwd_want = 2 * (steps + epochs * len(val))
    print("[mnist] %d steps of both nets in %.1f s, every loss and weight "
          "bit-equal to the twin's; launches %s (expected relu_fwd %d, "
          "relu_bwd %d)" % (steps, seconds, counts, fwd_want, 2 * steps))
    if counts["relu_fwd"] != fwd_want or counts["relu_bwd"] != 2 * steps:
        raise SmokeFailure("MNIST: the custom op launched %s" % counts)
    if not accs[-1] > accs[0]:
        raise SmokeFailure("MNIST: train accuracy did not rise: %s" % accs)

    data, label = next(iter(train))
    with _no_tf32():
        cuda_build.reset_launch_counts()
        _mnist_step(*nets["custom"], loss_fn, data, label)
        torch.cuda.synchronize()
        step_counts = {k: v for k, v in cuda_build.launch_counts().items()
                       if v}
    print("[mnist] launches of one custom-op step: %s" % step_counts)
    if step_counts != {cuda_build.RTC_PREFIX + "relu_fwd": 2,
                       cuda_build.RTC_PREFIX + "relu_bwd": 2}:
        raise SmokeFailure("MNIST: one step launched %s" % step_counts)

    bad = _mnist_nets(mx, init, ctx, leak_grad=True)
    with _no_tf32():
        _, loss = _mnist_step(*bad["custom"], loss_fn, data, label)
        _, tloss = _mnist_step(*bad["twin"], loss_fn, data, label)
        diff = _mnist_diff(bad, loss, tloss)
    print("[control] custom op passing dy through unmasked: %s"
          % ("%s differs (relative L2 %.3g), caught" % diff if diff
             else "MISSED"))
    if diff is None:
        raise SmokeFailure("control: the MNIST check passed a relu backward "
                           "that does not mask")
    return counts, step_counts, nets, loss_fn, (data, label)


def phase_times_rtc(seed, reps, card, errs, counts, mnist_counts, nets,
                    loss_fn, batch, mod, mod2):
    """Device times of the user kernels at 2^24 elements (kernel, plain
    function, library call, bound), the MLP step on the host clock with
    the custom op and with its twin, and one profiled step of each;
    returns the kernels' rows."""
    import torch
    from mxnet_tpu_torch.ndarray import NDArray
    g = torch.Generator(device=DEV).manual_seed(seed + 41)
    bw, _, f32_peak = _peaks(card)
    plain = rtc_plain()
    x, y, xs, dy = (torch.rand(RTC_N, generator=g, device=DEV)
                    for _ in range(4))
    xs, dy = xs - 0.5, dy - 0.5
    hs = torch.relu(xs)
    X, Y, XS, DY, HS = (NDArray(t) for t in (x, y, xs, dy, hs))
    outs = [torch.empty_like(x) for _ in range(2)]
    k = {"saxpy": mod.get_kernel("saxpy", alpha=2.0),
         "twoout": mod2.get_kernel("twoout"),
         "relu_fwd": mod.get_kernel("relu_fwd"),
         "relu_bwd": mod.get_kernel("relu_bwd")}
    E = 4 * RTC_N       # bytes of one f32 array
    table = [
        ("saxpy", lambda: k["saxpy"].launch([X, Y]),
         lambda: plain["saxpy"](x, y, outs[0], alpha=2.0),
         lambda: torch.add(y, x, alpha=2.0), 3 * E, 2 * RTC_N),
        ("twoout", lambda: k["twoout"].launch([X]),
         lambda: plain["twoout"](x, *outs), lambda: (x * 2, x + 1),
         3 * E, 2 * RTC_N),
        ("relu_fwd", lambda: k["relu_fwd"].launch([XS]),
         lambda: plain["relu_fwd"](xs, outs[0]), lambda: torch.relu(xs),
         2 * E, RTC_N),
        ("relu_bwd", lambda: k["relu_bwd"].launch([DY, HS]),
         lambda: plain["relu_bwd"](dy, hs, outs[0]),
         lambda: torch.where(hs > 0, dy, 0.0), 3 * E, RTC_N)]
    rows = []
    for name, fn, plain_fn, lib, nbytes, flops in table:
        ms, plain_ms, lib_ms = (_gpu_ms(f, reps) for f in (fn, plain_fn, lib))
        t_bytes, t_ops = nbytes / bw * 1e3, flops / f32_peak * 1e3
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")
        relu = name.startswith("relu")
        rows.append({
            "name": "rtc:" + name, "route": "cuda", "source": "chip_smoke.py",
            "launcher": "mxnet_tpu_torch/rtc.py",
            "replaces": "mxnet_tpu/rtc.py:53",
            "launches": (mnist_counts if relu else counts)[name],
            "launches_counted_in": ("the MNIST training run (phase 9)" if relu
                                    else "the rtc user launches (phase 8)"),
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "elements": RTC_N, "bytes": nbytes})
        print("[times] rtc %-9s (2^24 f32) kernel %.4f ms  plain %.4f ms  "
              "library %.4f ms  bound %.4f ms (%s, %.1f MB)"
              % (name, ms, plain_ms, lib_ms, b_ms, b_by, nbytes / 1e6))
    data, label = batch
    with _no_tf32():
        ms = {}
        for key in ("custom", "twin", "custom", "twin"):
            ms[key] = _host_ms(lambda: _mnist_step(*nets[key], loss_fn, data,
                                                   label), reps=20)
        print("[times] MNIST MLP step (batch %d, SGD): %.3f ms with the rtc "
              "custom op, %.3f ms with Dense(relu) (host clock, median of 20; "
              "run custom, twin, custom, twin, the later of each kept)"
              % (MNIST_BATCH, ms["custom"], ms["twin"]))
        for key in ("custom", "twin"):
            _profile("one MNIST MLP step (%s)" % key,
                     lambda: _mnist_step(*nets[key], loss_fn, data, label))
    return rows


def _attention_share(groups):
    """Print the attention kernels' share of a profiled step's device
    time."""
    if not groups:
        return
    att = sum(groups.get(k, 0.0) for k in ("selfatt_fwd", "selfatt_bwd"))
    print("[profile]   attention kernels (selfatt_fwd + selfatt_bwd): "
          "%.3f ms, %.1f%% of device time" % (att, 100 * att /
                                               sum(groups.values())))


# ---------------------------------------------------------------------------
# 11. compiled: hybridize() as captured CUDA graphs
# ---------------------------------------------------------------------------
COMPILED_STEPS = 3
# (b) Each compiled BERT step against the eager step from the same
# parameters, per gradient and for the loss, with the AMP step's own
# distance from its f32 twin as the yardstick (as AMP_RATIO): the first
# step is the eager warm-up, the second captures, the third replays
# only. The graphs replay the eager step's kernels, so all but the
# embedding tables' gradients (then index_add_'s atomics, whose order
# changed between any two runs, eager or not) came out bit for bit: on an H100
# 462-465 of 468 per seed, the largest ratio 6.19e-05, 8.48e-05,
# 5.22e-05, 4.42e-05 and 7.1e-05 for seeds 0-4; the limit is twice the
# largest correct reading.
COMPILED_AMP_RATIO = 1.7e-4
# (c) The compiled ResNet loop against the eager loop, the largest
# relative L2 distance over the losses of every step and the parameters
# after the last, at most COMPILED_SPREAD times the distance between two
# eager loops: on an H100 both were 0 at seeds 0-4, so bit for bit; with
# step 3's replay skipped (the control) 0.481-0.915.
COMPILED_SPREAD = 2.0
COMPILED_TURNS = 5


def _rel(a, b):
    """Relative L2 distance of two tensors in f32 (0 when equal)."""
    a, b = a.float(), b.float()
    d = float((a - b).norm())
    return 0.0 if d == 0 else d / max(float(b.norm()), 1e-30)


def _snapshot(params):
    return {n: p.data().tensor().detach().clone() for n, p in params.items()}


def _restore(params, snap):
    """Write ``snap`` into the parameters in place (their addresses, which
    the graphs read, stay)."""
    import torch
    with torch.no_grad():
        for n, p in params.items():
            p.data().tensor().copy_(snap[n])


def _run_distance(got, ref):
    """The largest relative L2 distance over (losses, parameters) pairs,
    and where it is."""
    worst = (0.0, "none")
    for i, (a, b) in enumerate(zip(got[0], ref[0])):
        worst = max(worst, (_rel(a, b), "loss of step %d" % (i + 1)))
    for n in ref[1]:
        worst = max(worst, (_rel(got[1][n], ref[1][n]), n))
    return worst


def _parity(tag, eager_a, eager_b, compiled):
    """Hold ``compiled`` to ``eager_a`` by COMPILED_SPREAD times the
    distance between the two eager runs; returns (distance, failed)."""
    spread, where_s = _run_distance(eager_b, eager_a)
    dist, where = _run_distance(compiled, eager_a)
    limit = COMPILED_SPREAD * spread
    fail = dist > limit
    verdict = (("caught" if fail else "MISSED") if tag.startswith("control")
               else ("FAIL" if fail else "ok"))
    print("[compiled] %s: compiled vs eager %.3g (%s), eager vs eager "
          "%.3g (%s), limit %.3g%s %s" % (
              tag, dist, where, spread, where_s, limit,
              " (bit for bit)" if limit == 0 else "", verdict))
    return dist, fail


def _in_turns(eager_fn, compiled_fn, turns=COMPILED_TURNS):
    """Host-clock medians (ms) of ``eager_fn`` and ``compiled_fn``, the
    card synchronised around each, run in turns: eager, compiled,
    compiled, eager."""
    import torch
    from mxnet_tpu_torch import cached_op
    times = {"eager": [], "compiled": []}

    def one(kind):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "eager":
            with cached_op.eager():
                eager_fn()
        else:
            compiled_fn()
        torch.cuda.synchronize()
        times[kind].append((time.perf_counter() - t0) * 1e3)
    for _ in range(turns):
        for kind in ("eager", "compiled", "compiled", "eager"):
            one(kind)
    return (statistics.median(times["eager"]),
            statistics.median(times["compiled"]))


def _steady(tag, fn, allowed=()):
    """One steady compiled step: no kernel wrapper may run and no op but
    ``allowed`` (what the step runs outside its graphs) may be
    dispatched; returns the graph replays."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    from mxnet_tpu_torch.ops import cuda_build
    cuda_build.reset_launch_counts()
    cached_op.reset_replay_counts()
    with mx.ops.recording() as seen:
        fn()
    torch.cuda.synchronize()
    launched = {k: v for k, v in cuda_build.launch_counts().items() if v}
    replays = cached_op.replay_counts()
    ops = sorted(op.name for op in seen)
    print("[compiled] %s, one steady step: graph replays %s; kernel "
          "launches outside graphs %s; ops dispatched %s"
          % (tag, replays, launched or "none", ops or "none"))
    extra = [o for o in ops if o not in allowed]
    if launched or extra:
        raise SmokeFailure("%s: a steady compiled step dispatched %s%s "
                           "outside its graphs" % (tag, launched or "",
                                                   extra or ""))
    return replays


def _graph_mb(fn):
    """(device memory held after ``fn()`` above before it, peak above
    before), MB: the graph pools ``fn`` captures stay allocated."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, ((torch.cuda.memory_allocated() - base) / 1e6,
                 (torch.cuda.max_memory_allocated() - base) / 1e6)


@contextlib.contextmanager
def _capture_launches(by_graph=None):
    """Kernel launches recorded into CUDA graphs inside the scope, by
    kernel: a wrapper runs once while its launch is captured, and a
    replay runs what was captured without it. ``by_graph``: a dict that
    gains {id(graph): {kernel: launches}} for each graph captured."""
    from unittest import mock
    from mxnet_tpu_torch import cached_op
    from mxnet_tpu_torch.ops import cuda_build
    total = {k: 0 for k in cuda_build.KERNELS}
    real = cached_op._capture

    def counted(graph, *a, **kw):
        before = cuda_build.launch_counts()
        try:
            return real(graph, *a, **kw)
        finally:
            added = {k: v - before[k]
                     for k, v in cuda_build.launch_counts().items()
                     if v != before[k]}
            for k, v in added.items():
                total[k] += v
            if by_graph is not None:
                by_graph[id(graph)] = added
    with mock.patch.object(cached_op, "_capture", counted):
        yield total


@contextlib.contextmanager
def _replayed_launches(by_graph):
    """Kernel launches that the CUDA graphs replayed inside the scope
    carry, by kernel, from ``by_graph`` (filled by
    ``_capture_launches``)."""
    from unittest import mock
    import torch
    total = collections.Counter()
    real = torch.cuda.CUDAGraph.replay

    def replay(graph):
        total.update(by_graph.get(id(graph), {}))
        return real(graph)
    with mock.patch.object(torch.cuda.CUDAGraph, "replay", replay):
        yield total


def _free_graphs(*blocks):
    """Drop every captured graph of ``blocks``, and with them the plans'
    (a released graph closes the runners that replay over it)."""
    import gc
    import torch
    from mxnet_tpu_torch import autograd
    autograd.disarm_fused_update()
    autograd.flush_pending_step()
    for b in blocks:
        b._clear_cached_op()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _report(tag, eager_ms, compiled_ms, held, what="step"):
    print("[compiled] %s: %s on the host clock %.2f ms eager, %.2f ms "
          "compiled (medians of %d, in turns); graphs hold %.1f MB "
          "(peak +%.1f MB while capturing)" % (
              tag, what, eager_ms, compiled_ms, 2 * COMPILED_TURNS,
              held[0], held[1]))


def phase_compiled_serve(sess, reqs, net):
    """(a) The phase-4 session with every bucket a captured graph; returns
    {"serve": the kernel launches recorded into the graphs}."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import cached_op
    from mxnet_tpu_torch.ops import cuda_build
    with cached_op.eager():
        eager = [sess.infer(ids, tok) for ids, tok in reqs]
    cuda_build.reset_launch_counts()
    with _capture_launches() as counts:
        first, held = _graph_mb(lambda: [sess.infer(ids, tok)
                                         for ids, tok in reqs])
    warm = {k: v - counts[k] for k, v in cuda_build.launch_counts().items()}
    missing = [k for k in SERVE_KERNELS if counts[k] == 0]
    print("[compiled] serve: launches of the %d buckets' eager warm-ups %s; "
          "recorded into their graphs %s" % (len(reqs), warm, counts))
    if missing:
        raise SmokeFailure("compiled serving captured no %s" % missing)
    replays = _steady("serve", lambda: [sess.infer(ids, tok)
                                        for ids, tok in reqs])
    if replays["forward"] != len(reqs):
        raise SmokeFailure("compiled serving: %d forward replays for %d "
                           "requests" % (replays["forward"], len(reqs)))
    outs = [sess.infer(ids, tok) for ids, tok in reqs]
    for (ids, _), got, want, warm in zip(reqs, outs, eager, first):
        for i, (g, w, f) in enumerate(zip(got, want, warm)):
            err = float(np.abs(g - w).max())
            if not (np.array_equal(g, w) and np.array_equal(f, w)):
                raise SmokeFailure(
                    "compiled serving, request %s output %d: max |replay - "
                    "eager| %g, not bit for bit" % (ids.shape, i, err))
    print("[compiled] serve: %d requests x %d outputs equal the eager "
          "session's bit for bit" % (len(reqs), len(outs[0])))
    ids, tok = reqs[0]
    eager_ms, comp_ms = _in_turns(lambda: sess.infer(ids, tok),
                                  lambda: sess.infer(ids, tok))
    _report("serve request %s" % (ids.shape,), eager_ms, comp_ms, held,
            "request")
    _profile("one compiled request %s" % (ids.shape,),
             lambda: sess.infer(ids, tok))

    # control: a weight changed in place after capture must change the
    # replay's output (held to the output from before, the check fails)
    w = net.word_embed.weight.data().tensor()
    keep = w.clone()
    with torch.no_grad():
        w.mul_(-1)
    bad = sess.infer(ids, tok)
    caught = not all(np.array_equal(b, e) for b, e in zip(bad, eager[0]))
    with torch.no_grad():
        w.copy_(keep)
    back = all(np.array_equal(b, e)
               for b, e in zip(sess.infer(ids, tok), eager[0]))
    print("[control] serve: word embeddings negated in place after capture: "
          "replay differs from before: %s; restored: equal again: %s"
          % (caught, back))
    if not (caught and back):
        raise SmokeFailure("control: the replay did not read the weight "
                           "written in place")
    _free_graphs(net)
    return {"serve": counts}


def _bert_seq(out):
    """A hybridized block with one output returns it (the reference's
    CachedOp); the eager forward a tuple."""
    import mxnet_tpu_torch as mx
    return out if isinstance(out, mx.nd.NDArray) else out[0]


def phase_compiled_bert(seed):
    """(b) BERT-base pretrained as phase 5a runs it, model and loss
    hybridized; returns {"bert": the kernel launches recorded into its
    graphs}."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.ops import cuda_build
    amp.init(target_dtype="bfloat16")
    try:
        net, mlm, params = _build_amp(seed, dropout=0.0)
        ids, tok, lab = _train_batch(seed)
        for b in (net, mlm):
            b.hybridize(static_alloc=True, static_shape=True)

        def fwd_bwd():
            with mx.autograd.record():
                per_position = mlm(_bert_seq(net(ids, tok)), lab)
                loss = per_position.mean()
            loss.backward()
            return per_position

        def grads(per_position):
            return (per_position.tensor().detach().float().mean(),
                    {n: p.grad().tensor().float().clone()
                     for n, p in params.items()})

        sched = mx.lr_scheduler.PolyScheduler(base_lr=1e-3, **AMP_POLY)
        trainer = mx.gluon.Trainer(params, "lamb", {
            "learning_rate": 1e-3, "wd": 0.01, "lr_scheduler": sched})
        # in lockstep: each compiled step's loss and gradients against the
        # eager step and the f32 twin step from the same parameters (LAMB
        # turns a gradient's last-bit noise into a whole update, so three
        # steps apart would compare LAMB, not the graphs)
        counts = {k: 0 for k in cuda_build.KERNELS}
        worst, equal, total, spread = 0.0, 0, 0, 0.0
        held = (0.0, 0.0)
        with _capture_launches() as captured:
            for k in range(COMPILED_STEPS):
                snap = _snapshot(params)
                with cached_op.eager():
                    eager = grads(fwd_bwd())
                    again = grads(fwd_bwd())
                    amp.reset()
                    try:
                        with _plain_kernels(f32_twin=True), _no_tf32():
                            twin = grads(fwd_bwd())
                    finally:
                        amp.init(target_dtype="bfloat16")
                _restore(params, snap)
                cuda_build.reset_launch_counts()
                cached_op.reset_replay_counts()
                got, mem = _graph_mb(lambda: grads(fwd_bwd()))
                held = (held[0] + mem[0], max(held[1], mem[1]))
                launched = cuda_build.launch_counts()
                replays = cached_op.replay_counts()
                for name, v in launched.items():
                    counts[name] += v
                print("[compiled] bert step %d (%s): graph replays %s, "
                      "kernel launches through the wrappers %d" % (
                          k + 1, ("eager warm-up", "capture and replay",
                                  "replay")[min(k, 2)], replays,
                          sum(launched.values())))
                if (k == 0) != (replays["forward"] == 0) or \
                        (k > 0 and replays["backward"] != 2) or \
                        (k > 1 and any(launched.values())):
                    raise SmokeFailure(
                        "compiled BERT step %d did not run as its place in "
                        "the sequence says" % (k + 1))
                checks = _train_compare(
                    "compiled bert step %d" % (k + 1), got, eager, twin,
                    limit=COMPILED_AMP_RATIO)
                worst = max([worst] + [r for r, _ in checks])
                pairs = [(got[0], eager[0])] + [(got[1][n], eager[1][n])
                                                for n in eager[1]]
                equal += sum(bool(torch.equal(x, y)) for x, y in pairs)
                total += len(pairs)
                spread = max([spread, _rel(again[0], eager[0])] +
                             [_rel(again[1][n], eager[1][n])
                              for n in eager[1]])
                if any(fail for _, fail in checks):
                    raise SmokeFailure(
                        "compiled BERT step %d differs from the eager step "
                        "by more than %g times AMP's own error"
                        % (k + 1, COMPILED_AMP_RATIO))
                trainer.step(TRAIN_BATCH)
        print("[compiled] bert: launches over %d compiled steps (warm-up, "
              "capture, replay): %s; recorded into the graphs: %s"
              % (COMPILED_STEPS, counts, captured))
        print("[compiled] bert, %d LAMB steps at dropout 0 in lockstep: "
              "largest ratio to AMP's own error %.3g (limit %g); %d of %d "
              "losses and gradients bit for bit; two eager runs apart by "
              "%.3g at most (relative L2)" % (COMPILED_STEPS, worst,
                                              COMPILED_AMP_RATIO, equal,
                                              total,
                                              spread))
        missing = [k for k, v in TRAIN_LAUNCHES.items()
                   if v and k != "dropout" and captured[k] == 0]
        if missing:
            raise SmokeFailure("compiled BERT captured no %s" % missing)

        def step():
            per_position = fwd_bwd()
            trainer.step(TRAIN_BATCH)
            return per_position
        # outside the graphs a step runs the head's mean and LAMB
        with mx.ops.recording() as outside:
            trainer.step(TRAIN_BATCH)
        allowed = {op.name for op in outside} | {"mean"}
        replays = _steady("bert", step, allowed)
        if replays["forward"] != 2 or replays["backward"] != 2:
            raise SmokeFailure("compiled BERT step: replays %s, expected 2 "
                               "forwards and 2 backwards" % replays)
        eager_ms, comp_ms = _in_turns(step, step)
        _report("bert AMP step (batch %d x seq %d, LAMB)"
                % (TRAIN_BATCH, TRAIN_SEQ), eager_ms, comp_ms, held)
        _profile("one compiled AMP step (batch %d x seq %d, LAMB)"
                 % (TRAIN_BATCH, TRAIN_SEQ), step)
        _free_graphs(net, mlm)
        del net, mlm, params, trainer

        # dropout 0.1: two replays of the same forward draw new masks
        net, mlm, params = _build_amp(seed, dropout=0.1)
        for blk in (net, mlm):
            blk.hybridize(static_alloc=True, static_shape=True)
        outs = []
        with _capture_launches() as drops:
            for _ in range(3):
                with mx.autograd.record():
                    outs.append(mlm(_bert_seq(net(ids, tok)), lab)
                                .tensor().detach().clone())
        captured["dropout"] = drops["dropout"]
        drop = nn.Dropout(0.1)
        drop.hybridize(static_alloc=True, static_shape=True)
        x = mx.nd.ones((TRAIN_BATCH * TRAIN_SEQ, UNITS), ctx=mx.gpu(0),
                       dtype="bfloat16")
        masks = []
        for _ in range(3):
            with mx.autograd.train_mode():
                masks.append(drop(x).tensor() != 0)
        n = x.size
        sigma = (n * 0.9 * 0.1) ** 0.5
        keep = [int(m.sum()) for m in masks]
        differ = not torch.equal(outs[1], outs[2]) and \
            not torch.equal(masks[1], masks[2])
        print("[compiled] bert at dropout 0.1: two replays' losses differ: "
              "%s (max |diff| %.3g); Dropout(0.1) on (%d, %d) replayed: "
              "masks differ: %s, keep rates %s (5 sigma of 0.9 is %.5f)"
              % (not torch.equal(outs[1], outs[2]),
                 float((outs[1] - outs[2]).abs().max()),
                 TRAIN_BATCH * TRAIN_SEQ, UNITS,
                 not torch.equal(masks[1], masks[2]),
                 ["%.5f" % (k / n) for k in keep], 5 * sigma / n))
        if not differ or any(abs(k - 0.9 * n) > 5 * sigma for k in keep) \
                or not captured["dropout"]:
            raise SmokeFailure("compiled dropout: replays drew the same "
                               "masks or keep rates beyond 5 sigma")
        _free_graphs(net, mlm, drop)
    finally:
        amp.reset()
    return {"bert": captured}


def phase_compiled_resnet(seed):
    """(c) ResNet-50 v1 as bench.py's headline loop runs it; returns
    {"resnet": the kernel launches recorded into its graphs}."""
    import torch
    from unittest import mock
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, cached_op
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.ops import cuda_build
    amp.init(target_dtype="bfloat16")
    try:
        mx.random.seed(seed)
        net = resnet50_v1(prefix="resnet50c_")
        net.initialize(init=mx.init.MSRAPrelu())
        with torch.no_grad():
            net(mx.nd.zeros((1, 3, RESNET_SIDE, RESNET_SIDE)))
        net.hybridize(static_alloc=True, static_shape=True)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        loss_fn.hybridize(static_alloc=True, static_shape=True)
        params = net.collect_params()
        g = torch.Generator(device=DEV).manual_seed(seed + 41)
        x = mx.nd.NDArray(torch.randn(RESNET_BATCH, 3, RESNET_SIDE,
                                      RESNET_SIDE, generator=g, device=DEV))
        y = mx.nd.NDArray(torch.randint(0, 1000, (RESNET_BATCH,),
                                        generator=g, device=DEV).float())
        snap = _snapshot(params)
        state = {}

        def step(trainer, skip=False):
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            state["stashed"].append(autograd._PENDING[0] is not None)
            if skip:
                with mock.patch.object(torch.cuda.CUDAGraph, "replay",
                                       lambda self: None):
                    trainer.step(RESNET_BATCH)
            else:
                trainer.step(RESNET_BATCH)
            return loss

        def run(compiled, skip_at=None):
            _restore(params, snap)
            # the last run's Trainer (over the same parameters) stays
            # armed otherwise
            autograd.disarm_fused_update()
            state["tr"] = trainer = mx.gluon.Trainer(
                params, "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                kvstore="device")
            state["stashed"] = []
            losses = []
            with (contextlib.nullcontext() if compiled
                  else cached_op.eager()):
                for i in range(COMPILED_STEPS):
                    loss = step(trainer, skip=i == skip_at)
                    losses.append(loss.tensor().detach().float().clone())
            return losses, _snapshot(params)

        # bit for bit with the eager loop with the layout pass off; phase
        # 19 holds the pass's run to the eager loop within LAYOUT_LIMIT
        with layout_opt("0"):
            a, b = run(False), run(False)
            cuda_build.reset_launch_counts()
            cached_op.reset_replay_counts()
            with _capture_launches() as counts:
                c = run(True)
            print("[compiled] resnet: %d compiled steps: stashed plans %s, "
                  "graph replays %s, kernel launches %s (recorded into "
                  "graphs %s)" % (
                      COMPILED_STEPS, state["stashed"],
                      cached_op.replay_counts(),
                      {k: v for k, v in cuda_build.launch_counts().items()
                       if v} or "none",
                      {k: v for k, v in counts.items() if v} or "none"))
            if state["stashed"] != [False] + [True] * (COMPILED_STEPS - 1):
                raise SmokeFailure("the compiled ResNet steps did not "
                                   "consume a plan from the second on: %s"
                                   % state["stashed"])
            _, fail = _parity("resnet, %d SGD steps" % COMPILED_STEPS, a, b,
                              c)
            if fail:
                raise SmokeFailure("the compiled ResNet steps differ from "
                                   "the eager loop")
            # control: a step whose replay is skipped must fail the parity
            bad = run(True, skip_at=COMPILED_STEPS - 1)
            _, caught = _parity("control: step %d's replay skipped"
                                % COMPILED_STEPS, a, b, bad)
            if not caught:
                raise SmokeFailure("control: the parity check passed a step "
                                   "whose replay was skipped")
        # the numbers on the default path (MXNET_LAYOUT_OPT as set)
        _free_graphs(net, loss_fn)
        _, held = _graph_mb(lambda: run(True))
        replays = _steady("resnet", lambda: step(state["tr"]))
        if replays != {"forward": 2, "backward": 0, "tape": 1, "chunk": 0}:
            raise SmokeFailure("compiled ResNet step: replays %s, expected "
                               "2 forwards and one plan" % replays)
        eager_ms, comp_ms = _in_turns(lambda: step(state["tr"]),
                                      lambda: step(state["tr"]))
        _report("resnet step (batch %d, SGD, fused update)" % RESNET_BATCH,
                eager_ms, comp_ms, held)
        _profile("one compiled ResNet-50 step (batch %d)" % RESNET_BATCH,
                 lambda: step(state["tr"]))
        _free_graphs(net, loss_fn)
    finally:
        amp.reset()
    return {"resnet": counts}


# -- phase 12: the PTB word-language model ----------------------------------
# apache/mxnet example/gluon/word_language_model, the README's
# "--tied --nhid 650 --emsize 650 --dropout 0.5" run: vocabulary 10000
# (PTB's), bptt 35, batch 32, SGD lr 20, clip 0.25 per token
PTB_VOCAB = 10000
PTB_UNITS = 650
PTB_LAYERS = 2
PTB_DROPOUT = 0.5
PTB_BPTT = 35
PTB_BATCH = 32
PTB_LR = 20.0
PTB_CLIP = 0.25


def ptb_model(mx, vocab=PTB_VOCAB, units=PTB_UNITS, layers=PTB_LAYERS,
              dropout=PTB_DROPOUT):
    """model.py's ``RNNModel`` with tied weights for the package ``mx``
    (the port or the reference), prefix ``rnnmodel_``: Embedding,
    Dropout, a ``layers``-layer LSTM with dropout between its layers,
    Dropout, and a Dense decoder that shares the embedding's weight. The
    decoder is built with the embedding's prefix as well as its
    parameters: both packages look a shared name up under the block's own
    prefix, so ``params`` alone would leave it untied."""
    gluon = mx.gluon

    class RNNModel(gluon.Block):
        def __init__(self):
            super().__init__(prefix="rnnmodel_")
            with self.name_scope():
                self.drop = gluon.nn.Dropout(dropout)
                self.encoder = gluon.nn.Embedding(vocab, units)
                self.rnn = gluon.rnn.LSTM(units, layers, dropout=dropout,
                                          input_size=units)
            self.decoder = gluon.nn.Dense(vocab, in_units=units,
                                          prefix=self.encoder.prefix,
                                          params=self.encoder.params)

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            return self.decoder(output.reshape((-1, units))), hidden

        def begin_state(self, *args, **kwargs):
            return self.rnn.begin_state(*args, **kwargs)

    return RNNModel()


def ptb_step(mx, net, trainer, loss_fn, data, target, hidden,
             clip=PTB_CLIP):
    """One step of MXNet 1.x's train.py: the carried state detached
    (truncated BPTT), every token's loss divided by bptt x batch, its
    backward, the gradients clipped to ``clip`` by
    ``gluon.utils.clip_global_norm``, ``trainer.step(1)``. Returns (every
    token's loss, state, the norm before clipping)."""
    bptt, batch = data.shape
    hidden = [h.detach() for h in hidden]
    with mx.autograd.record():
        output, hidden = net(data, hidden)
        loss = loss_fn(output, target.reshape((-1,)))
        scaled = loss / (bptt * batch)
    scaled.backward()
    grads = [p.grad(data.context) for p in net.collect_params().values()]
    norm = mx.gluon.utils.clip_global_norm(grads, clip)
    trainer.step(1)
    return loss, hidden, norm


PTB_STEPS = 10
# 12.2 The full-width model's forward and backward at dropout 0 on the
# card (TF32 off) against the same weights through the port on the CPU:
# the largest relative L2 distance over the loss, every gradient, the
# final (h, c) and the gradients of the carried (h, c) must stay within
# PTB_PARITY: twice the largest reading over seeds 0-4, 7.95e-07 to
# 8.66e-07 on an H100 (PERF.md); the planted faults read 0.49 and 1.
PTB_PARITY = 1.75e-6
# 12.3 PTB_STEPS SGD steps at dropout 0.5 on consecutive windows of
# ptb_stream(--seed), the state carried: the last step's per-token loss
# at least PTB_FALL nats below the first's. On an H100 it fell 0.87-1.72
# nats over seeds 0-4 (from 9.21; lr 20 spikes it at step 4 before the
# clip takes hold); the margin is under half the smallest (PERF.md).
PTB_FALL = 0.4
# dropout launches of one eager PTB step: the embedding's, the one
# between the LSTM layers and the output's, forward and backward
PTB_DROPOUT_LAUNCHES = 6
# ops a compiled PTB step dispatches outside its graphs: those of the loss
# and of the clip's global norm, neither of which is hybridized
PTB_HOST_OPS = ("Cast", "Reshape", "_div_scalar", "_plus_scalar",
                "_power_scalar", "_rdiv_scalar", "broadcast_add",
                "broadcast_minimum", "broadcast_mul", "log_softmax", "mean",
                "negative", "pick", "sqrt", "sum")


def ptb_stream(seed, n_windows, vocab=PTB_VOCAB, bptt=PTB_BPTT,
               batch=PTB_BATCH):
    """Token ids drawn from ``seed`` in place of PTB's: a stream with
    Zipf's law for its unigram frequencies (a word of rank k has
    probability proportional to 1/k, as in English text, the ranks
    shuffled over the ids), batchified as train.py's ``batchify`` does
    (``batch`` columns) and cut into ``n_windows`` consecutive (bptt,
    batch) windows: [(data, target)] of float32 numpy arrays, target the
    next token."""
    import numpy as np
    rs = np.random.RandomState(seed + 12)
    pmf = 1.0 / np.arange(1, vocab + 1)
    ids = rs.permutation(vocab)[rs.choice(vocab, n_windows * bptt * batch
                                          + batch, p=pmf / pmf.sum())]
    cols = ids.astype(np.float32).reshape(batch, -1).T
    return [(cols[i * bptt:(i + 1) * bptt], cols[i * bptt + 1:
                                                 (i + 1) * bptt + 1])
            for i in range(n_windows)]


def _ptb_window(mx, seed, ctx):
    """The first window of ``ptb_stream(seed)`` on ``ctx``."""
    data, target = ptb_stream(seed, 1)[0]
    return mx.nd.array(data, ctx=ctx), mx.nd.array(target, ctx=ctx)


def _ptb_net(seed, dropout):
    import mxnet_tpu_torch as mx
    mx.random.seed(seed)
    net = ptb_model(mx, dropout=dropout)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    return net


def _ptb_fwd_bwd(mx, net, ctx, seed):
    """One forward and backward from a carried (h, c) drawn from
    ``seed``: {name: tensor} of the per-token loss, the final (h, c),
    the carried state's gradients and every parameter's gradient."""
    import numpy as np
    data, target = _ptb_window(mx, seed, ctx)
    rs = np.random.RandomState(seed + 13)
    shape = (PTB_LAYERS, PTB_BATCH, PTB_UNITS)
    hidden = [mx.nd.array(rs.randn(*shape) * 0.5, ctx=ctx) for _ in "hc"]
    for h in hidden:
        h.attach_grad()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        out, new = net(data, hidden)
        loss = loss_fn(out, target.reshape((-1,)))
    loss.backward()
    got = {"loss": loss.mean().tensor(), "h": new[0].tensor(),
           "c": new[1].tensor(), "dh": hidden[0].grad.tensor(),
           "dc": hidden[1].grad.tensor()}
    got.update({n: p.grad().tensor() for n, p in
                net.collect_params().items()})
    return {k: v.detach().float().cpu() for k, v in got.items()}


@contextlib.contextmanager
def _ptb_fault(kind):
    """A planted fault in the RNN op's packing: ``swap_if`` swaps the i
    and f gate blocks of every weight and bias, ``no_h2h_bias`` drops the
    h2h bias."""
    from unittest import mock
    import torch
    from mxnet_tpu_torch.ops import rnn_ops
    real = rnn_ops._unpack

    def swap(t):
        i, f, g, o = torch.chunk(t, 4, dim=0)
        return torch.cat([f, i, g, o], 0)

    def unpack(*a):
        ws, bs = real(*a)
        if kind == "swap_if":
            return ([(swap(w), swap(r)) for w, r in ws],
                    [(swap(b), swap(c)) for b, c in bs])
        return ws, [(b, c * 0) for b, c in bs]
    with mock.patch.object(rnn_ops, "_unpack", unpack):
        yield


def ptb_parity(seed, fault=None):
    """12.2: the full-width model at dropout 0 on the card, TF32 off,
    against the same weights through the port on the CPU. Returns the
    largest relative L2 distance and where it is."""
    import mxnet_tpu_torch as mx
    net = _ptb_net(seed, 0.0)
    arrays = {n: p.data().asnumpy() for n, p in
              net.collect_params().items()}
    twin = ptb_model(mx, dropout=0.0)
    mx.params_from_numpy(twin, arrays, ctx=mx.cpu())
    with _no_tf32(), (_ptb_fault(fault) if fault else
                      contextlib.nullcontext()):
        card = _ptb_fwd_bwd(mx, net, mx.gpu(0), seed)
    host = _ptb_fwd_bwd(mx, twin, mx.cpu(), seed)
    return max((_rel(card[k], host[k]), k) for k in host)


def phase_ptb(seed, steps, card, reps):
    """Phase 12, eager: the dropout kernel at PTB's shapes, the model's
    parity with its CPU run (and two planted faults), ``steps`` clipped
    SGD steps at dropout 0.5, the LSTM layer beside cuDNN's. Returns
    (kernel launches per step, the PTB dropout row with the launches of
    the ``steps`` steps)."""
    import torch
    import torch.nn.functional as F
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_build, cuda_dropout
    # 12.1 the dropout kernel at the shapes the model gives it
    gen = torch.Generator(device=DEV).manual_seed(seed + 12)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEV)
    sd = torch.tensor([seed + 12], dtype=torch.int32, device=DEV)
    err = 0.0
    for shape in ((PTB_BPTT, PTB_BATCH, PTB_UNITS),
                  (PTB_BPTT * PTB_BATCH, PTB_UNITS)):
        x = randn(*shape).requires_grad_()
        dy = randn(*shape)
        y = cuda_dropout.dropout_fn(x, PTB_DROPOUT, sd)
        y.backward(dy)
        tag = "dropout p=%g %s f32" % (PTB_DROPOUT, shape)
        for what, got, ref in (
                (tag, y, cuda_dropout.dropout_plain(
                    x.detach(), PTB_DROPOUT, sd)),
                (tag + " backward", x.grad,
                 cuda_dropout.dropout_plain(dy, PTB_DROPOUT, sd))):
            _check_exact(what, got, ref)
            err = max(err, float((got.detach() - ref).abs().max()))
        _drop_pattern(tag + " fwd vs bwd mask", y, x.grad)
    # 12.2 parity at dropout 0, and the planted faults
    reading, where = ptb_parity(seed)
    ok = reading <= PTB_PARITY
    print("[ptb] card vs CPU at dropout 0 (TF32 off), loss, every "
          "gradient and the carried (h, c): largest relative L2 %.3g (%s), "
          "limit %g %s" % (reading, where, PTB_PARITY,
                           "ok" if ok else "FAIL"))
    if not ok:
        raise SmokeFailure("PTB model on the card differs from its CPU run "
                           "by %.3g (%s)" % (reading, where))
    for fault in ("swap_if", "no_h2h_bias"):
        r, w = ptb_parity(seed, fault)
        caught = r > PTB_PARITY
        print("[control] PTB with %s: largest relative L2 %.3g (%s) %s"
              % (fault, r, w, "caught" if caught else "MISSED"))
        if not caught:
            raise SmokeFailure("planted PTB fault %s not caught" % fault)
    # 12.3 training at dropout 0.5
    net = _ptb_net(seed, PTB_DROPOUT)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": PTB_LR})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    windows = [tuple(mx.nd.array(a, ctx=mx.gpu(0)) for a in w)
               for w in ptb_stream(seed, steps)]
    hidden = net.begin_state(batch_size=PTB_BATCH, ctx=mx.gpu(0))
    losses, norms = [], []
    cuda_build.reset_launch_counts()
    scalar = cuda_dropout.scalar_launches
    for data, target in windows:
        loss, hidden, norm = ptb_step(mx, net, trainer, loss_fn, data,
                                      target, hidden)
        losses.append(float(loss.mean().asscalar()))
        norms.append(norm)
    torch.cuda.synchronize()
    totals = {k: v for k, v in cuda_build.launch_counts().items() if v}
    counts = {k: v // steps for k, v in totals.items()}
    print("[ptb] %d SGD steps (lr %g, clip %g) at dropout %g, consecutive "
          "windows: loss per token %s; clip_global_norm's norm %s; "
          "launches per step %s" % (steps, PTB_LR, PTB_CLIP, PTB_DROPOUT,
                                    " ".join("%.4f" % v for v in losses),
                                    " ".join("%.2f" % v for v in norms),
                                    counts))
    import math
    if not all(math.isfinite(v) for v in losses + norms) or \
            losses[-1] > losses[0] - PTB_FALL or \
            totals != {"dropout": PTB_DROPOUT_LAUNCHES * steps}:
        raise SmokeFailure("PTB training: losses %s, norms %s, launches %s "
                           "(the loss must fall by %g, %d dropout launches "
                           "a step)" % (losses, norms, counts, PTB_FALL,
                                        PTB_DROPOUT_LAUNCHES))
    _vector_dropouts("ptb", scalar, "%d in %d steps"
                     % (totals["dropout"], steps))
    # the LSTM layer's forward and backward beside cuDNN's on its weights
    lstm = net.rnn
    cudnn = torch.nn.LSTM(PTB_UNITS, PTB_UNITS, PTB_LAYERS).cuda()
    with torch.no_grad():
        for i in range(PTB_LAYERS):
            for ours, theirs in (("i2h_weight", "weight_ih"),
                                 ("h2h_weight", "weight_hh"),
                                 ("i2h_bias", "bias_ih"),
                                 ("h2h_bias", "bias_hh")):
                getattr(cudnn, "%s_l%d" % (theirs, i)).copy_(
                    getattr(lstm, "l%d_%s" % (i, ours)).data().tensor())
    xs = randn(PTB_BPTT, PTB_BATCH, PTB_UNITS)
    h0 = [randn(PTB_LAYERS, PTB_BATCH, PTB_UNITS) for _ in "hc"]
    xa = mx.nd.NDArray(xs.clone())
    xa.attach_grad()

    def ours():
        # predict mode: no dropout between the layers, as cuDNN's here
        with mx.autograd.record(train_mode=False):
            out, _ = lstm(xa, [mx.nd.NDArray(h) for h in h0])
        out.backward()
        return out.tensor()
    xt = xs.clone().requires_grad_()

    def theirs():
        out, _ = cudnn(xt, tuple(h0))
        out.backward(torch.ones_like(out))
        return out
    with _no_tf32():
        gap = float((ours() - theirs()).detach().abs().max())
    ours_ms, theirs_ms = _host_ms(ours), _host_ms(theirs)
    print("[times] PTB LSTM layer (2 x 650, T %d, N %d) forward+backward: "
          "port %.3f ms, cuDNN (torch.nn.LSTM, a yardstick) %.3f ms, host "
          "clock, card synchronised; outputs apart by %.3g (TF32 off)"
          % (PTB_BPTT, PTB_BATCH, ours_ms, theirs_ms, gap))
    # the row-8 kernel at the model's (bptt x batch, units)
    bw, _, f32_peak = _peaks(card)
    M, C = PTB_BPTT * PTB_BATCH, PTB_UNITS
    xd = randn(M, C)
    ms, plain_ms, lib_ms = (_gpu_ms(f, reps) for f in (
        lambda: cuda_dropout.dropout_cuda(xd, PTB_DROPOUT, sd),
        lambda: cuda_dropout.dropout_plain(xd, PTB_DROPOUT, sd),
        lambda: F.dropout(xd, PTB_DROPOUT, training=True)))
    t_bytes, t_ops = 2 * M * C * 4 / bw * 1e3, 20 * M * C / f32_peak * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    row = {"name": "dropout_ptb", "kernel": "dropout", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/dropout.cu",
           "replaces": "mxnet_tpu/ops/pallas_dropout.py:73",
           "launches": totals["dropout"], "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": lib_ms}
    print("[times] %-18s kernel %.4f ms  plain %.4f ms  library %.4f ms"
          "  bound %.4f ms (%s), (%d, %d) f32 p %g"
          % ("dropout_ptb", ms, plain_ms, lib_ms, bound, by, M, C,
             PTB_DROPOUT))
    return counts, row


def phase_compiled_ptb(seed):
    """12.4: the model hybridized (its embedding, dropouts, LSTM and
    decoder each a CachedOp): COMPILED_STEPS steps at dropout 0 against
    two eager loops; at dropout 0.5, two replays drawing new masks and a
    steady step that launches no kernel outside its graphs and replays
    graphs carrying the eager step's dropout launches; the step eager
    against compiled in turns, one profiled step of each.
    Returns {"ptb": the kernel launches recorded into its graphs}."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    gpu = mx.gpu(0)
    windows = [tuple(mx.nd.array(a, ctx=gpu) for a in w)
               for w in ptb_stream(seed, COMPILED_STEPS)]
    data, target = windows[0]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def loop(net, params, trainer):
        hidden = net.begin_state(batch_size=PTB_BATCH, ctx=gpu)
        losses = []
        for d, t in windows:
            loss, hidden, _ = ptb_step(mx, net, trainer, loss_fn, d, t,
                                       hidden)
            losses.append(loss.tensor().detach().clone())
        return losses, {n: p.data().tensor().detach().clone()
                        for n, p in params.items()}

    net = _ptb_net(seed, 0.0)
    params = net.collect_params()
    trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": PTB_LR})
    snap = _snapshot(params)
    runs = []
    for _ in range(2):
        runs.append(loop(net, params, trainer))
        _restore(params, snap)
    net.hybridize(static_alloc=True, static_shape=True)
    with _capture_launches() as captured:
        compiled, held = _graph_mb(lambda: loop(net, params, trainer))
    _, fail = _parity("ptb", runs[0], runs[1], compiled)
    if fail:
        raise SmokeFailure("compiled PTB loop differs from the eager loop")
    _free_graphs(net)
    del net, params, trainer

    # dropout 0.5: two replays draw new masks at the keep rate
    net = _ptb_net(seed, PTB_DROPOUT)
    params = net.collect_params()
    trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": PTB_LR})
    net.hybridize(static_alloc=True, static_shape=True)
    x = mx.nd.ones((PTB_BPTT, PTB_BATCH, PTB_UNITS), ctx=gpu)
    hidden = net.begin_state(batch_size=PTB_BATCH, ctx=gpu)

    def step():
        nonlocal hidden
        _, hidden, _ = ptb_step(mx, net, trainer, loss_fn, data, target,
                                hidden)
    masks, by_graph = [], {}
    with _capture_launches(by_graph) as drops:
        for _ in range(3):
            with mx.autograd.train_mode():
                masks.append(net.drop(x).tensor() != 0)
        for _ in range(2):
            step()
    # a steady step: no kernel launched outside the graphs, and the
    # graphs it replays carry the eager step's dropout launches
    with _replayed_launches(by_graph) as replayed:
        _steady("ptb at dropout %g" % PTB_DROPOUT, step,
                allowed=PTB_HOST_OPS)
    print("[compiled] ptb at dropout %g, one steady step: kernel launches "
          "in the graphs replayed %s (eager: %d dropout)"
          % (PTB_DROPOUT, dict(replayed) or "none", PTB_DROPOUT_LAUNCHES))
    if dict(replayed) != {"dropout": PTB_DROPOUT_LAUNCHES}:
        raise SmokeFailure("compiled PTB step at dropout %g replayed "
                           "graphs carrying %s, not the eager step's %d "
                           "dropout launches" % (PTB_DROPOUT, dict(replayed),
                                                 PTB_DROPOUT_LAUNCHES))
    n = x.size
    sigma = (n * 0.25) ** 0.5
    keep = [int(m.sum()) for m in masks]
    differ = not torch.equal(masks[1], masks[2])
    print("[compiled] ptb Dropout(%g) on %s replayed: masks differ: %s, "
          "keep rates %s (5 sigma of 0.5 is %.5f); dropout launches "
          "recorded into the graphs %d" % (
              PTB_DROPOUT, x.shape, differ, ["%.5f" % (k / n) for k in keep],
              5 * sigma / n, drops["dropout"]))
    if not differ or any(abs(k - 0.5 * n) > 5 * sigma for k in keep):
        raise SmokeFailure("compiled PTB dropout: replays drew the same "
                           "masks or keep rates beyond 5 sigma")
    captured = {k: captured[k] + drops[k] for k in captured}
    eager_ms, comp_ms = _in_turns(step, step)
    _report("ptb step (bptt %d x batch %d, SGD, clip) at dropout %g"
            % (PTB_BPTT, PTB_BATCH, PTB_DROPOUT), eager_ms, comp_ms, held)
    tokens = PTB_BPTT * PTB_BATCH
    print("[times] ptb step: %.1f tokens/s eager, %.1f tokens/s compiled "
          "(host clock)" % (tokens / eager_ms * 1e3, tokens / comp_ms * 1e3))

    def eager_step():
        with cached_op.eager():
            step()
    _profile("one eager PTB step (dropout %g)" % PTB_DROPOUT, eager_step)
    _profile("one compiled PTB step (dropout %g)" % PTB_DROPOUT, step)
    _free_graphs(net)
    return {"ptb": captured}


# -- phase 13: resume -------------------------------------------------------
# Each path trains RESUME_STEPS (N) steps, saves its parameters and the
# Trainer's states in the reference's formats, loads them into a fresh
# model and Trainer, and trains N more; and trains 2N steps without a
# break. The two runs must agree bit for bit: every loss, parameter (the
# BatchNorm moving statistics too) and optimizer state.
RESUME_STEPS = 3
# the kernels phase 13's paths launch outside graphs: BERT's eager steps
# and the PTB model's warm-up (ResNet-50's path has none)
RESUME_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "selfatt_fwd",
                  "selfatt_bwd", "bias_gelu_fwd", "bias_gelu_bwd",
                  "bias_residual_fwd", "dropout")
# 13.4: the new optimizers on the MNIST MLP, RESUME_OPT_STEPS SGD-style
# steps on the card (TF32 off) against the port's CPU run of the same
# steps from the same weights and batches: the largest relative L2
# distance over the parameters after the last step. OPT_PARITY is twice
# the largest reading over seeds 0-4 on an H100 at both widths, by
# optimizer: NAG 1.40e-07-2.16e-07, RMSProp 1.99e-07-4.97e-07 (centered
# 2.00e-07-5.02e-07), Ftrl 1.26e-07-1.94e-07, AdaGrad up to 2.88e-04
# (the history starts at 0, so a first step divides by |g| + eps) and
# SignSGD 0, so bit for bit; the parameters of one step before the save
# (the control) read 0.044-0.74 (PERF.md §6).
RESUME_OPT_STEPS = 5
RESUME_OPTIMIZERS = (
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("rmsprop", {"learning_rate": 0.001, "wd": 1e-4}),
    ("rmsprop_centered", {"learning_rate": 0.001, "centered": True,
                          "wd": 1e-4}),
    ("ftrl", {"learning_rate": 0.1, "lamda1": 1e-4, "wd": 1e-4}),
    ("signsgd", {"learning_rate": 0.001, "wd": 1e-4}),
    ("adagrad", {"learning_rate": 0.05, "wd": 1e-4}),
)
OPT_PARITY = {"nag": 4.33e-7, "rmsprop": 9.95e-7, "rmsprop_centered": 1.01e-6,
              "ftrl": 3.89e-7, "signsgd": 0.0, "adagrad": 5.77e-4}


def _timed(fn):
    """Seconds ``fn()`` takes, the card synchronised around it."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _save(tag, tmp, blocks, trainer, report, extra=None):
    """Save every block's parameters and the Trainer's states under
    ``tmp``, timed; returns the file names."""
    import os
    import mxnet_tpu_torch as mx
    files = {"params": [os.path.join(tmp, "%s-%d.params" % (tag, i))
                        for i in range(len(blocks))],
             "states": os.path.join(tmp, tag + ".states")}
    t_p = _timed(lambda: [b.save_parameters(f)
                          for b, f in zip(blocks, files["params"])])
    t_s = _timed(lambda: trainer.save_states(files["states"]))
    if extra is not None:
        files["extra"] = os.path.join(tmp, tag + ".nd")
        mx.nd.save(files["extra"], extra)
    report[tag] = {
        "params_mb": sum(os.path.getsize(f) for f in files["params"]) / 1e6,
        "states_mb": os.path.getsize(files["states"]) / 1e6,
        "save_parameters_s": t_p, "save_states_s": t_s}
    return files


def _load(tag, files, blocks, trainer, report):
    t_p = _timed(lambda: [b.load_parameters(f)
                          for b, f in zip(blocks, files["params"])])
    t_s = _timed(lambda: trainer.load_states(files["states"]))
    report[tag].setdefault("load_parameters_s", t_p)
    report[tag].setdefault("load_states_s", t_s)


def _state_tensors(trainer):
    """{index: [state tensors]} of a Trainer (None states give [])."""
    out = {}
    for i, s in trainer._updater.states.items():
        flat = list(s) if isinstance(s, tuple) else [s]
        flat = [x for y in flat for x in (list(y) if isinstance(y, tuple)
                                          else [y])]
        out[i] = [x.tensor().detach().clone() for x in flat
                  if x is not None]
    return out


def _run_state(params, trainer):
    return ({n: p.data().tensor().detach().clone()
             for n, p in zip(range(len(params)), params.values())},
            _state_tensors(trainer))


def _bit_equal(tag, got, want):
    """Hold (losses, (parameters, states)) of a run to another's, bit for
    bit; returns the names that differ."""
    import torch

    def same(a, b):
        return a.dtype == b.dtype and torch.equal(a.to(b.device), b)
    bad = ["loss of step %d" % (i + 1)
           for i, (a, b) in enumerate(zip(got[0], want[0])) if not same(a, b)]
    bad += ["parameter %d" % k for k in want[1][0]
            if not same(got[1][0][k], want[1][0][k])]
    for i, st in want[1][1].items():
        g = got[1][1].get(i, [])
        if len(g) != len(st) or not all(map(same, g, st)):
            bad.append("state %d" % i)
    n = len(want[0]) + len(want[1][0]) + len(want[1][1])
    verdict = (("caught" if bad else "MISSED") if tag.startswith("control")
               else ("FAIL" if bad else "ok"))
    print("[resume] %s: %d of %d losses, parameters and states bit for "
          "bit%s %s" % (tag, n - len(bad), n,
                        " (differ: %s)" % ", ".join(bad[:4]) if bad else "",
                        verdict))
    return bad


def _rekey(key, moved):
    """``key`` with every address in ``moved`` replaced."""
    if isinstance(key, tuple):
        return tuple(_rekey(k, moved) for k in key)
    return moved.get(key, key) if isinstance(key, int) else key


@contextlib.contextmanager
def _rebind_fault(trainer):
    """The planted fault: ``load_states`` rebinds the updater's states to
    new tensors and keeps the captured step, which reads the old ones,
    under the key the new tensors give (what a port whose captured steps
    did not follow the states would do)."""
    from unittest import mock
    import mxnet_tpu_torch as mx

    def rebind(self, loaded):
        upd = self
        old = upd.states
        new = {i: s.as_in_context(mx.gpu(0)) for i, s in loaded.items()}
        moved = {old[i].tensor().data_ptr(): new[i].tensor().data_ptr()
                 for i in new if old.get(i) is not None}
        runners = trainer.optimizer.step_runners
        for k in list(runners):
            runners[_rekey(k, moved)] = runners.pop(k)
        upd.states, upd._unplaced = new, set()
    with mock.patch.object(type(trainer._updater), "load_state_dict",
                           rebind):
        yield


def _resume_resnet(seed, tmp, report):
    """13.1: bench.py's ResNet-50 headline loop compiled (phase 11's);
    returns nothing, raises on a fault."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, cached_op
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    N = RESUME_STEPS
    amp.init(target_dtype="bfloat16")
    try:
        g = torch.Generator(device=DEV).manual_seed(seed + 41)
        x = mx.nd.NDArray(torch.randn(RESNET_BATCH, 3, RESNET_SIDE,
                                      RESNET_SIDE, generator=g, device=DEV))
        y = mx.nd.NDArray(torch.randint(0, 1000, (RESNET_BATCH,),
                                        generator=g, device=DEV).float())

        def build(s):
            autograd.disarm_fused_update()
            mx.random.seed(s)
            net = resnet50_v1(prefix="resnet50r_")
            net.initialize(init=mx.init.MSRAPrelu())
            with torch.no_grad():
                net(mx.nd.zeros((1, 3, RESNET_SIDE, RESNET_SIDE)))
            net.hybridize(static_alloc=True, static_shape=True)
            loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
            loss_fn.hybridize(static_alloc=True, static_shape=True)
            trainer = mx.gluon.Trainer(
                net.collect_params(), "sgd",
                {"learning_rate": 0.1, "momentum": 0.9}, kvstore="device")
            return net, loss_fn, trainer

        def steps(net, loss_fn, trainer, n):
            losses = []
            for _ in range(n):
                with mx.autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                trainer.step(RESNET_BATCH)
                losses.append(loss.tensor().detach().clone())
            return losses, _run_state(net.collect_params(), trainer)

        net, lf, tr = build(seed)
        whole = steps(net, lf, tr, 2 * N)
        _free_graphs(net, lf)
        del net, lf, tr
        net, lf, tr = build(seed)
        steps(net, lf, tr, N)
        files = _save("resnet", tmp, [net], tr, report)
        _free_graphs(net, lf)
        del net, lf, tr
        net, lf, tr = build(seed + 1000)
        _load("resnet", files, [net], tr, report)
        resumed = steps(net, lf, tr, N)
        want = (whole[0][N:], whole[1])
        bad = _bit_equal("resnet: %d steps, saved, loaded into a fresh net "
                         "and Trainer, %d more vs %d uninterrupted"
                         % (N, N, 2 * N), resumed, want)
        # the rollback: step N's files into this net and Trainer, whose
        # graphs (the fused SGD step's too) are captured
        captures = []
        real = cached_op._capture
        from unittest import mock
        with mock.patch.object(cached_op, "_capture",
                               lambda *a, **k: (captures.append(1),
                                                real(*a, **k))[1]):
            _load("resnet", files, [net], tr, report)
            rolled = steps(net, lf, tr, N)
        bad += _bit_equal("resnet: step %d's files loaded into the captured "
                          "net and Trainer, %d replayed steps (%d new "
                          "captures)" % (N, N, len(captures)), rolled, want)
        if captures:
            bad.append("the rollback captured %d graphs anew"
                       % len(captures))
        if bad:
            raise SmokeFailure("resumed ResNet-50 differs from the "
                               "uninterrupted run: %s" % bad[:4])
        # control: the states rebound, the captured step kept
        with _rebind_fault(tr):
            _load("resnet", files, [net], tr, report)
            faulty = steps(net, lf, tr, N)
        if not _bit_equal("control: states rebound, captured step kept",
                          faulty, want):
            raise SmokeFailure("control: the resume check passed states "
                               "rebound under a captured step")
        _free_graphs(net, lf)
    finally:
        amp.reset()


def _resume_ptb(seed, tmp, report, by_graph):
    """13.2: the PTB LSTM at dropout 0.5, hybridized (phase 12's net and
    step); the dropout counter reseeded at step N in every run."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    N = RESUME_STEPS
    gpu = mx.gpu(0)
    windows = [tuple(mx.nd.array(a, ctx=gpu) for a in w)
               for w in ptb_stream(seed, 2 * N)]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def build(s):
        autograd.disarm_fused_update()
        net = _ptb_net(s, PTB_DROPOUT)
        net.hybridize(static_alloc=True, static_shape=True)
        return net, mx.gluon.Trainer(net.collect_params(), "sgd",
                                     {"learning_rate": PTB_LR})

    def steps(net, trainer, hidden, ks, replayed=None):
        losses = []
        for k in ks:
            if k == N:
                mx.random.seed(seed + 13)
            with (_replayed_launches(by_graph) if replayed is not None
                  and k == ks[-1] else contextlib.nullcontext()) as got:
                loss, hidden, _ = ptb_step(mx, net, trainer, loss_fn,
                                           *windows[k], hidden)
            if got is not None:
                replayed.update(got)
            losses.append(loss.tensor().detach().clone())
        return losses, hidden

    net, tr = build(seed)
    losses, _ = steps(net, tr, net.begin_state(batch_size=PTB_BATCH,
                                               ctx=gpu), range(2 * N))
    want = (losses[N:], _run_state(net.collect_params(), tr))
    _free_graphs(net)
    del net, tr
    net, tr = build(seed)
    _, hidden = steps(net, tr, net.begin_state(batch_size=PTB_BATCH,
                                               ctx=gpu), range(N))
    files = _save("ptb", tmp, [net], tr, report, extra=hidden)
    _free_graphs(net)
    del net, tr
    net, tr = build(seed + 1000)
    _load("ptb", files, [net], tr, report)
    replayed = collections.Counter()
    with _capture_launches(by_graph):
        losses, _ = steps(net, tr, mx.nd.load(files["extra"], ctx=gpu),
                          range(N, 2 * N), replayed)
    bad = _bit_equal("ptb: %d steps, saved with the carried state, loaded "
                     "into a fresh net, %d more vs %d uninterrupted"
                     % (N, N, 2 * N), (losses, _run_state(
                         net.collect_params(), tr)), want)
    _load("ptb", files, [net], tr, report)
    losses, _ = steps(net, tr, mx.nd.load(files["extra"], ctx=gpu),
                      range(N, 2 * N))
    bad += _bit_equal("ptb: step %d's files loaded into the captured net, "
                      "%d replayed steps" % (N, N), (losses, _run_state(
                          net.collect_params(), tr)), want)
    print("[resume] ptb: the last resumed step replayed graphs carrying %s "
          "(phase 12's steady step: %d dropout)"
          % (dict(replayed) or "none", PTB_DROPOUT_LAUNCHES))
    if dict(replayed) != {"dropout": PTB_DROPOUT_LAUNCHES}:
        bad.append("replayed launches %s" % dict(replayed))
    _free_graphs(net)
    if bad:
        raise SmokeFailure("resumed PTB run differs from the uninterrupted "
                           "run: %s" % bad[:4])


def _resume_bert(seed, tmp, report):
    """13.3: BERT-base pretrained as phase 5a runs it: 3 LAMB steps under
    a PolyScheduler, saved, loaded into a fresh model and Trainer."""
    import math
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp
    amp.init(target_dtype="bfloat16")
    try:
        batch = _train_batch(seed)

        def build(s):
            net, mlm, params = _build_amp(s)
            sched = mx.lr_scheduler.PolyScheduler(base_lr=1e-3, **AMP_POLY)
            return net, mlm, params, mx.gluon.Trainer(params, "lamb", {
                "learning_rate": 1e-3, "wd": 0.01, "lr_scheduler": sched})

        net, mlm, params, tr = build(seed)
        for _ in range(3):
            _amp_step(net, mlm, tr, batch)
        saved = _run_state(params, tr)
        dtypes = {i: [t.dtype for t in st] for i, st in saved[1].items()}
        files = _save("bert", tmp, [net, mlm], tr, report)
        del net, mlm, params, tr
        torch.cuda.empty_cache()
        net, mlm, params, tr = build(seed + 1000)
        _load("bert", files, [net, mlm], tr, report)
        got = _run_state(params, tr)
        bad = _bit_equal("bert: %d parameters and %d LAMB (mean, var) "
                         "loaded vs saved" % (len(saved[0]), len(saved[1])),
                         ([], got), ([], saved))
        if {i: [t.dtype for t in st] for i, st in got[1].items()} != dtypes:
            bad.append("a state's dtype changed")
        print("[resume] bert: the fresh optimizer's num_update is %d (the "
              "reference restarts it too)" % tr.optimizer.num_update)
        if tr.optimizer.num_update != 0:
            bad.append("num_update %d" % tr.optimizer.num_update)
        if bad:
            raise SmokeFailure("BERT-base states did not load as saved: %s"
                               % bad[:4])
        # one resumed step against its plain-version twin
        kern = _fwd_bwd(net, mlm, params, batch, seed)
        with _plain_kernels():
            plain = _fwd_bwd(net, mlm, params, batch, seed)
            amp.reset()
            try:
                with _plain_kernels(f32_twin=True), _no_tf32():
                    twin = _fwd_bwd(net, mlm, params, batch, seed)
            finally:
                amp.init(target_dtype="bfloat16")
        checks = _train_compare("resume parity", kern, plain, twin,
                                limit=AMP_RATIO)
        worst = max(r for r, _ in checks)
        print("[resume] bert: the resumed step against its plain twin: "
              "largest of %d ratios %.3g (limit %g)"
              % (len(checks), worst, AMP_RATIO))
        per_position = _amp_step(net, mlm, tr, batch)
        loss = float(per_position.tensor().detach().mean())
        on_card = all(t.is_cuda for st in _state_tensors(tr).values()
                      for t in st)
        print("[resume] bert: resumed step loss %.6f (step 4 of the run), "
              "states on the card after it: %s" % (loss, on_card))
        if any(f for _, f in checks) or not math.isfinite(loss) or \
                not on_card:
            raise SmokeFailure("the resumed BERT step failed its checks")
        del net, mlm, params, tr, kern, plain, twin
        torch.cuda.empty_cache()
    finally:
        amp.reset()


def resume_optimizer(seed, name, kw, aggregate, tmp, fault=False):
    """13.4: the MNIST MLP trained RESUME_OPT_STEPS steps by one new
    optimizer on the card (saved and loaded into a fresh net and Trainer
    after step 2, the round trip held bit for bit) and on the CPU;
    returns the largest relative L2 distance over the parameters.
    ``fault`` loads the parameters of one step before the save."""
    import os
    import mxnet_tpu_torch as mx
    X, Y, _, _ = mnist_synthetic()
    batches = [(X[i * MNIST_BATCH:(i + 1) * MNIST_BATCH],
                Y[i * MNIST_BATCH:(i + 1) * MNIST_BATCH])
               for i in range(RESUME_OPT_STEPS)]
    mx.random.seed(seed)
    init = mnist_mlp(mx, False)
    init.initialize(mx.init.Xavier(), ctx=mx.cpu())
    init(mx.nd.array(X[:1], ctx=mx.cpu()))
    arrays = {n: p.data().asnumpy() for n, p in init.collect_params().items()}
    opt = "rmsprop" if name.startswith("rmsprop") else name
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def fresh(ctx, values):
        net = mnist_mlp(mx, False)
        mx.params_from_numpy(net, values, ctx=ctx)
        return net, mx.gluon.Trainer(net.collect_params(), opt, dict(kw))

    def run(ctx, resume_at=None):
        net, tr = fresh(ctx, arrays)
        prev = None
        for k, (data, label) in enumerate(batches):
            if k == resume_at:
                net.save_parameters(os.path.join(tmp, "mlp.params"))
                tr.save_states(os.path.join(tmp, "mlp.states"))
                before = _run_state(net.collect_params(), tr)
                net, tr = fresh(ctx, prev if fault else arrays)
                if not fault:
                    net.load_parameters(os.path.join(tmp, "mlp.params"))
                tr.load_states(os.path.join(tmp, "mlp.states"))
                after = _run_state(net.collect_params(), tr)
                if not fault and _bit_equal("%s round trip" % name,
                                            ([], after), ([], before)):
                    raise SmokeFailure("%s: the saved and loaded MLP "
                                       "differs" % name)
            prev = {n: p.data().asnumpy()
                    for n, p in net.collect_params().items()}
            _mnist_step(net, tr, loss_fn, mx.nd.array(data, ctx=ctx),
                        mx.nd.array(label, ctx=ctx))
        return {n: p.data().tensor().detach().float().cpu()
                for n, p in net.collect_params().items()}

    var = "MXNET_OPTIMIZER_AGGREGATION_SIZE"
    old_width = os.environ.get(var)
    os.environ[var] = str(aggregate)
    try:
        with _no_tf32():
            card = run(mx.gpu(0), resume_at=2)
        host = run(mx.cpu())
    finally:
        if old_width is None:
            del os.environ[var]
        else:
            os.environ[var] = old_width
    return max((_rel(card[n], host[n]), n) for n in host)


def _resume_optimizers(seed, tmp):
    """13.4: every new optimizer at aggregation width 1 and at its
    default, card against CPU within OPT_PARITY; a stale load must fail
    it."""
    for name, kw in RESUME_OPTIMIZERS:
        for agg in (1, 4096):
            dist, where = resume_optimizer(seed, name, kw, agg, tmp)
            limit = OPT_PARITY[name]
            print("[resume] %s at width %d: card vs CPU after %d steps "
                  "%.3g (%s), limit %g %s" % (
                      name, agg, RESUME_OPT_STEPS, dist, where, limit,
                      "ok" if dist <= limit else "FAIL"))
            if dist > limit:
                raise SmokeFailure("%s on the card differs from the CPU run "
                                   "by %.3g (limit %g)" % (name, dist, limit))
        dist, where = resume_optimizer(seed, name, kw, 4096, tmp, fault=True)
        caught = dist > OPT_PARITY[name]
        print("[control] %s, the parameters of one step before the save "
              "loaded: %.3g (%s) %s" % (name, dist, where,
                                        "caught" if caught else "MISSED"))
        if not caught:
            raise SmokeFailure("control: %s's card-vs-CPU check passed a "
                               "stale load" % name)


def phase_resume(seed, card_line):
    """13: resume every trained path from checkpoints in the reference's
    formats (files in a temporary directory, removed at the end); prints
    the file sizes and save and load times."""
    import tempfile
    by_graph, report = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        _resume_resnet(seed, tmp, report)
        _resume_ptb(seed, tmp, report, by_graph)
        _resume_bert(seed, tmp, report)
        _resume_optimizers(seed, tmp)
    print("[resume] checkpoint files (MB) and host-clock times (s) (%s): "
          "%s" % (card_line, json.dumps(report)))


# ---------------------------------------------------------------------------
# 14. scan: K steps as one captured graph a chunk, with the grad guard
# ---------------------------------------------------------------------------
SCAN_K = 4
# one arming step, two chunks, a tail of two drained by a read
SCAN_STEPS = 11
# the step (from 1) whose first gradient gets a NaN: inside chunk 2
SCAN_PLANT = 6
SCAN_POLY = {"max_update": 100, "warmup_steps": 2, "pwr": 1}
# the guard's clip norm, on the norm after rescale_grad: far below
# BERT-base's, so every step clips
SCAN_CLIP = 1e-3
SCAN_TURNS = 5
# chunks in one timed segment
SCAN_SEGMENT = 3
# tools/loop_micro.py's MLP: 4 hidden Dense(256) + Dense(256), batch 64
MLP_WIDTH, MLP_DEPTH, MLP_BATCH = 256, 4, 64
SCAN_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "selfatt_fwd",
                "selfatt_bwd", "bias_gelu_fwd", "bias_gelu_bwd",
                "bias_residual_fwd", "dropout")


class _ScanRig:
    """BERT-base as ``_build_train`` builds it (bf16, dropout 0.1, the
    dense MLM head), model and loss hybridized, its parameters' snapshot
    and ``SCAN_STEPS`` batches of 32 x 128."""

    def __init__(self, seed):
        import os
        os.environ["MXNET_TRAINER_FUSED_UPDATE"] = "1"
        self.seed = seed
        self.net, self.mlm, self.params = _build_train(seed)
        for b in (self.net, self.mlm):
            b.hybridize(static_alloc=True, static_shape=True)
        self.snap = _snapshot(self.params)
        self.batches = [_train_batch(seed + 100 + i)
                        for i in range(SCAN_STEPS + 2)]

    def step(self, trainer, i):
        """One step on batch ``i``, backward from the loss block's
        output; returns it (deferred under a buffering chunk)."""
        import mxnet_tpu_torch as mx
        ids, tok, lab = self.batches[i % len(self.batches)]
        with mx.autograd.record():
            per_position = self.mlm(_bert_seq(self.net(ids, tok)), lab)
        per_position.backward()
        trainer.step(TRAIN_BATCH)
        return per_position

    def trainer(self, k, guard=None):
        """A fresh SGD Trainer (momentum 0.9, wd 0.01, a PolyScheduler)
        at MXNET_SCAN_STEPS=k from the snapshot, the counter reseeded
        and every graph of the blocks freed (so every run starts with
        the same eager warm-up)."""
        import os
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import faultinject
        os.environ["MXNET_SCAN_STEPS"] = str(k)
        _free_graphs(self.net, self.mlm)
        _restore(self.params, self.snap)
        faultinject.reset()
        mx.random.seed(self.seed)
        sched = mx.lr_scheduler.PolyScheduler(base_lr=1e-3, **SCAN_POLY)
        tr = mx.gluon.Trainer(self.params, "sgd", {
            "learning_rate": 1e-3, "momentum": 0.9, "wd": 0.01,
            "lr_scheduler": sched})
        if guard is not None:
            tr.grad_guard = guard
        return tr

    def run(self, k, steps=SCAN_STEPS, guard=None, plant=None,
            read=False, probe=None):
        """``steps`` steps at K = k; returns (losses, (parameters,
        momenta)) as ``_bit_equal`` reads them, and the runner's counts
        (None at K=1). The Trainer and its graphs are dropped."""
        import torch
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import faultinject
        tr = self.trainer(k, guard)
        losses = []
        for i in range(steps):
            if plant is not None and i == plant - 1:
                faultinject.set_fault("nan_grad", 1.0, max_fires=1)
            out = probe(i, lambda: self.step(tr, i)) if probe \
                else self.step(tr, i)
            if read:
                out.wait_to_read()
            losses.append(out)
        mx.autograd.flush_all_pending()
        faultinject.reset()
        torch.cuda.synchronize()
        got = ([l.tensor().detach().clone() for l in losses],
               (_snapshot(self.params),
                {i: [s.tensor().detach().clone()]
                 for i, s in tr._updater.states.items() if s is not None}))
        mx.autograd.disarm_fused_update()
        import gc
        r = tr._scan
        info = None if r is None else {
            "retired": r.retired_chunks, "flushed": r.flushed_steps,
            "bailed": r.bailed}
        del tr, r
        gc.collect()
        return got, info


def _scan_bits(tag, got, want):
    """Hold (losses, (parameters, momenta)) of a run to another's, bit
    for bit; returns the names that differ (a control must differ)."""
    import torch

    def same(a, b):
        return a.dtype == b.dtype and torch.equal(a, b)
    bad = ["loss of step %d" % (i + 1)
           for i, (a, b) in enumerate(zip(got[0], want[0])) if not same(a, b)]
    bad += [n for n in want[1][0] if not same(got[1][0][n], want[1][0][n])]
    bad += ["momentum %d" % i for i, st in want[1][1].items()
            if not all(map(same, got[1][1].get(i, []), st))]
    n = len(want[0]) + len(want[1][0]) + len(want[1][1])
    control = tag.startswith("control")
    print("[scan] %s: %d of %d losses, parameters and momenta bit for "
          "bit%s %s" % (tag, n - len(bad), n,
                        " (differ: %s)" % ", ".join(bad[:4]) if bad else "",
                        ("caught" if bad else "MISSED") if control
                        else ("FAIL" if bad else "ok")))
    if bad and not control:
        raise SmokeFailure("scan %s: not bit for bit (%s)" % (tag, bad[:4]))
    return bad


def _scan_engagement(rig, by_graph):
    """(a): a K=4 run of 13 steps; the third chunk, steady, must make one
    chunk replay and nothing else, launch no kernel outside its graph,
    and carry K times a per-step fused step's launches of kernels 1-8.
    Returns the kernels replayed in one per-step step and in one chunk."""
    import torch
    from mxnet_tpu_torch import cached_op
    from mxnet_tpu_torch.ops import cuda_build
    seen = {}

    def probe_one(i, step):
        if i != 5:
            return step()
        with _replayed_launches(by_graph) as rep:
            cuda_build.reset_launch_counts()
            cached_op.reset_replay_counts()
            out = step()
            torch.cuda.synchronize()
        seen["step"] = (dict(rep), cached_op.replay_counts(),
                        {k: v for k, v in cuda_build.launch_counts().items()
                         if v})
        return out
    with _capture_launches(by_graph):
        rig.run(1, steps=7, probe=probe_one)

    def probe_k(i, step):
        if i < 9:
            return step()
        if i == 9:
            seen["ctx"] = _replayed_launches(by_graph)
            seen["rep"] = seen["ctx"].__enter__()
            cuda_build.reset_launch_counts()
            cached_op.reset_replay_counts()
        out = step()
        if i == 12:
            torch.cuda.synchronize()
            seen["ctx"].__exit__(None, None, None)
            seen["chunk"] = (dict(seen["rep"]), cached_op.replay_counts(),
                             {k: v for k, v in
                              cuda_build.launch_counts().items() if v})
        return out
    with _capture_launches(by_graph):
        _, info = rig.run(SCAN_K, steps=13, probe=probe_k)
    step_rep, step_replays, step_out = seen["step"]
    chunk_rep, chunk_replays, chunk_out = seen["chunk"]
    print("[scan] (a) per-step fused step: replays %s, launches outside "
          "graphs %s, kernels its graphs carry %s" % (
              step_replays, step_out or "none", dict(step_rep)))
    print("[scan] (a) steady chunk of %d steps: replays %s, launches "
          "outside graphs %s, kernels its graph carries %s; runner %s" % (
              SCAN_K, chunk_replays, chunk_out or "none", dict(chunk_rep),
              info))
    want = {"forward": 0, "backward": 0, "tape": 0, "chunk": 1}
    short = [k for k in SCAN_KERNELS
             if not step_rep.get(k) or
             chunk_rep.get(k, 0) != SCAN_K * step_rep[k]]
    if chunk_replays != want or chunk_out or short or \
            step_replays != {"forward": 2, "backward": 0, "tape": 1,
                             "chunk": 0}:
        raise SmokeFailure("scan (a): a steady chunk is not one graph "
                           "with %d steps' kernels (%s)" % (SCAN_K, short))
    return step_rep, chunk_rep


def _scan_resnet(seed):
    """(d) the rung of a forward that writes auxiliary state: phase 11's
    compiled ResNet-50 loop (bf16 AMP, BatchNorm, SGD momentum 0.9, the
    fused update) at K=4 bails with one warning and stays bit for bit
    with K=1 over 4 steps."""
    import logging
    import os
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    amp.init(target_dtype="bfloat16")
    try:
        mx.random.seed(seed)
        net = resnet50_v1(prefix="resnet50s_")
        net.initialize(init=mx.init.MSRAPrelu())
        with torch.no_grad():
            net(mx.nd.zeros((1, 3, RESNET_SIDE, RESNET_SIDE)))
        net.hybridize(static_alloc=True, static_shape=True)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        loss_fn.hybridize(static_alloc=True, static_shape=True)
        params = net.collect_params()
        g = torch.Generator(device=DEV).manual_seed(seed + 41)
        x = mx.nd.NDArray(torch.randn(RESNET_BATCH, 3, RESNET_SIDE,
                                      RESNET_SIDE, generator=g, device=DEV))
        y = mx.nd.NDArray(torch.randint(0, 1000, (RESNET_BATCH,),
                                        generator=g, device=DEV).float())
        snap = _snapshot(params)

        def run(k):
            os.environ["MXNET_SCAN_STEPS"] = str(k)
            _free_graphs(net, loss_fn)
            _restore(params, snap)
            tr = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.1,
                                                  "momentum": 0.9})
            losses = []
            for _ in range(4):
                with mx.autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                tr.step(RESNET_BATCH)
                losses.append(loss.tensor().detach().clone())
            autograd.flush_all_pending()
            autograd.disarm_fused_update()
            return (losses, (_snapshot(params), {
                i: [s.tensor().detach().clone()]
                for i, s in tr._updater.states.items() if s is not None})), tr
        one, _ = run(1)
        warned, h = _warnings_of("mxnet_tpu_torch.scan")
        try:
            four, tr = run(SCAN_K)
        finally:
            logging.getLogger("mxnet_tpu_torch.scan").removeHandler(h)
        print("[scan] (d) ResNet-50 at K=%d: bailed %s, warnings %s"
              % (SCAN_K, tr._scan is not None and tr._scan.bailed, warned))
        if tr._scan is None or not tr._scan.bailed or len(warned) != 1 or \
                "auxiliary state" not in warned[0]:
            raise SmokeFailure("scan (d): the BatchNorm loop did not bail "
                               "with one warning")
        _scan_bits("(d) ResNet-50 K=%d against K=1, 4 steps" % SCAN_K,
                   four, one)
        _free_graphs(net, loss_fn)
    finally:
        amp.reset()


def _scan_clip(rig, card_line):
    """(d) MXNET_GUARD_CLIP_NORM > 0 at K=4: the Trainer never arms, says
    so once, and the guard scales the gradients to the clip norm."""
    import logging
    import os
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import guardrails
    warned, handler = _warnings_of("mxnet_tpu_torch.scan")
    os.environ["MXNET_GUARD_CLIP_NORM"] = repr(SCAN_CLIP)
    try:
        tr = rig.trainer(SCAN_K)
        rels = []
        for i in range(2):
            ids, tok, lab = rig.batches[i]
            with mx.autograd.record():
                per_position = rig.mlm(_bert_seq(rig.net(ids, tok)), lab)
            per_position.backward()
            tr.step(TRAIN_BATCH)
            guard = tr.grad_guard
            grads = [p.grad() for p in rig.params.values()
                     if p.grad_req != "null"]
            _, after = guardrails.finite_report(grads)
            after *= tr.optimizer.rescale_grad
            scale = SCAN_CLIP / (guard.last_norm + 1e-12)
            rounded = torch.tensor(scale, dtype=grads[0].tensor().dtype)
            want = guard.last_norm * float(rounded)
            rels.append((after / SCAN_CLIP - 1, after / want - 1))
    finally:
        os.environ.pop("MXNET_GUARD_CLIP_NORM", None)
        logging.getLogger("mxnet_tpu_torch.scan").removeHandler(handler)
    mx.autograd.disarm_fused_update()
    print("[scan] (d) clip %g at K=%d: armed %s, runner %s, clipped %d of "
          "%d steps, norm after the clip over the clip norm - 1: %s (over "
          "the norm times the bf16-rounded factor - 1: %s); warnings %s; %s"
          % (SCAN_CLIP, SCAN_K, tr._fused_armed, tr._scan,
             guard.clipped_steps, guard.steps,
             ["%.3g" % a for a, _ in rels], ["%.3g" % b for _, b in rels],
             warned, card_line))
    if tr._fused_armed or tr._scan is not None or guard.clipped_steps != 2 \
            or any(abs(b) > 1e-3 for _, b in rels) or len(warned) != 1:
        raise SmokeFailure("scan (d): the clip guard did not run the "
                           "classic path or missed its norm")


def _scan_turns(label, step, k, card_line, profile_label, prime=0):
    """(f) ms a step at K=1 and at K=k in turns: medians of
    2 * SCAN_TURNS segments of SCAN_SEGMENT chunks each (a K=k segment
    after ``prime`` untimed steps, which arm a Trainer that K=1
    disarmed), then one profiled chunk and k profiled per-step steps.
    A segment holds several chunks: a chunk's steps are recorded on the
    host while the card runs the chunk before, as a loop without reads
    runs them."""
    import os
    import torch
    times = {1: [], k: []}

    def seg(kk):
        os.environ["MXNET_SCAN_STEPS"] = str(kk)
        for _ in range(prime if kk == k else 0):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k * SCAN_SEGMENT):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / (k * SCAN_SEGMENT)
    for kk in (1, k, 1, k, 1, k):     # warm: every graph captured
        seg(kk)
    for _ in range(SCAN_TURNS):
        for kk in (1, k, k, 1):
            times[kk].append(seg(kk))
    one, many = statistics.median(times[1]), statistics.median(times[k])
    print("[scan] (f) %s: ms a step on the host clock %.3f at K=1, %.3f at "
          "K=%d (medians of %d, in turns; K=%d / K=1 = %.3f); %s"
          % (label, one, many, k, 2 * SCAN_TURNS, k, many / one,
             card_line))

    def steps():
        for _ in range(k):
            step()
    os.environ["MXNET_SCAN_STEPS"] = str(k)
    for _ in range(prime):
        step()
    _profile("%s, one chunk of %d steps at K=%d" % (profile_label, k, k),
             steps)
    os.environ["MXNET_SCAN_STEPS"] = "1"
    _profile("%s, %d steps at K=1" % (profile_label, k), steps)
    return one, many


def _scan_mlp(seed, card_line):
    """(f) tools/loop_micro.py's MLP (f32, width 256, a skip_step guard,
    SGD lr 0.01 momentum 0.9): K=1 (the classic guarded step: the guard
    needs the gradients on the host every step) against K=4 in turns,
    and the memory of each path's graphs."""
    import os
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import guardrails
    os.environ["MXNET_TRAINER_FUSED_UPDATE"] = "1"
    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential(prefix="loopmlp_")
    with net.name_scope():
        for _ in range(MLP_DEPTH):
            net.add(mx.gluon.nn.Dense(MLP_WIDTH, activation="relu",
                                      in_units=MLP_WIDTH))
        net.add(mx.gluon.nn.Dense(MLP_WIDTH, in_units=MLP_WIDTH))
    net.initialize(mx.init.Xavier())
    net.hybridize(static_alloc=True, static_shape=True)
    lf = mx.gluon.loss.L2Loss()
    lf.hybridize(static_alloc=True, static_shape=True)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.01, "momentum": 0.9})
    tr.grad_guard = guardrails.GradGuard(nonfinite="skip_step")
    g = torch.Generator(device=DEV).manual_seed(seed + 3)
    x = mx.nd.NDArray(torch.rand(MLP_BATCH, MLP_WIDTH, generator=g,
                                 device=DEV))
    y = mx.nd.NDArray(torch.rand(MLP_BATCH, MLP_WIDTH, generator=g,
                                 device=DEV))

    def step():
        with mx.autograd.record():
            loss = lf(net(x), y)
        loss.backward()
        tr.step(MLP_BATCH)
    with _capture_mb() as mb:
        for kk in (1, SCAN_K):
            os.environ["MXNET_SCAN_STEPS"] = str(kk)
            for _ in range(1 + 3 * SCAN_K):
                step()
            mx.autograd.flush_all_pending()
    syncs0, steps0 = tr.grad_guard.sync_count, tr.grad_guard.steps
    _scan_turns("MLP %d x %d, batch %d, f32, skip_step guard" % (
        MLP_DEPTH + 1, MLP_WIDTH, MLP_BATCH), step, SCAN_K, card_line,
        "MLP (loop_micro)", prime=1)
    mx.autograd.flush_all_pending()
    print("[scan] (f) MLP: graphs (MB: pool / allocated / peak) %s; guard "
          "reads %d over %d steps since the warm-up (the runner bailed: "
          "%s)" % ({w: ["%.1f / %.1f / %.1f" % x for x in v]
                    for w, v in mb.items()},
                   tr.grad_guard.sync_count - syncs0,
                   tr.grad_guard.steps - steps0,
                   tr._scan is not None and tr._scan.bailed))
    mx.autograd.disarm_fused_update()
    _free_graphs(net, lf)


@contextlib.contextmanager
def _capture_mb():
    """Device memory of each CUDA graph captured inside the scope, MB, by
    what was captured: {what: [(pool, held, peak)]}: the memory its
    private pool keeps reserved once captured, the tensors still
    allocated from it (static outputs, residuals), and the peak of
    allocated memory above the start while capturing."""
    import torch
    from unittest import mock
    from mxnet_tpu_torch import cached_op
    seen = collections.defaultdict(list)
    real = cached_op._capture

    def measured(graph, what, *a, **kw):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        base_res = torch.cuda.memory_reserved()
        try:
            return real(graph, what, *a, **kw)
        finally:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            seen[what].append(
                ((torch.cuda.memory_reserved() - base_res) / 1e6,
                 (torch.cuda.memory_allocated() - base) / 1e6,
                 (torch.cuda.max_memory_allocated() - base) / 1e6))
    with mock.patch.object(cached_op, "_capture", measured):
        yield seen


def _warnings_of(logger):
    """A list that gains the message of every warning ``logger`` logs
    while the returned handler is attached."""
    import logging
    got = []

    class _Catch(logging.Handler):
        def emit(self, record):
            got.append(record.getMessage())
    h = _Catch(logging.WARNING)
    logging.getLogger(logger).addHandler(h)
    return got, h


def phase_scan(seed, card_line):
    """14. scan: BERT-base trained with fused SGD at MXNET_SCAN_STEPS=4,
    each chunk one captured graph. Returns ({"scan": the kernel launches
    recorded into the graphs of the K=4 parity run}, the launches through
    the wrappers in that run)."""
    import logging
    import os
    from unittest import mock
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import guardrails, optimizer
    from mxnet_tpu_torch.ops import cuda_build
    rig = _ScanRig(seed)
    by_graph = {}
    try:
        # (b) parity: K=4 against the per-step fused path at K=1
        with _capture_launches(by_graph) as cap4, _capture_mb() as mb4:
            cuda_build.reset_launch_counts()
            four, info4 = rig.run(SCAN_K)
            launched = cuda_build.launch_counts()
        with _capture_mb() as mb1:
            one, _ = rig.run(1)
        print("[scan] (b) K=%d: runner %s; kernel launches through the "
              "wrappers %s, recorded into graphs %s" % (
                  SCAN_K, info4, {k: v for k, v in launched.items() if v},
                  {k: v for k, v in cap4.items() if v}))
        if info4 != {"retired": 2, "flushed": 2, "bailed": False}:
            raise SmokeFailure("scan (b): the K=%d run did not retire two "
                               "chunks and drain a tail of two" % SCAN_K)
        _scan_bits("(b) K=%d against K=1, %d steps (losses, parameters, "
                   "momenta)" % (SCAN_K, SCAN_STEPS), four, one)
        chunk_mb = [x for w, v in mb4.items() if "chunk" in w for x in v]
        step_mb = [x for v in mb1.values() for x in v]
        print("[scan] (f) memory of the captured graphs (MB: pool reserved "
              "/ allocated from it after capture / peak allocated above "
              "the start while capturing): the chunk of %d steps %s; the "
              "per-step fused step's graphs %s, pools %.1f in all; %s" % (
                  SCAN_K, ["%.1f / %.1f / %.1f" % x for x in chunk_mb],
                  {w: ["%.1f / %.1f / %.1f" % x for x in v]
                   for w, v in mb1.items()},
                  sum(x[0] for x in step_mb), card_line))

        # (c) the guard: a NaN planted inside chunk 2
        g4 = guardrails.GradGuard(nonfinite="skip_step")
        gfour, _ = rig.run(SCAN_K, guard=g4, plant=SCAN_PLANT)
        g1 = guardrails.GradGuard(nonfinite="skip_step")
        gone, _ = rig.run(1, guard=g1, plant=SCAN_PLANT)
        print("[scan] (c) nan_grad at step %d: skipped %d at K=%d, %d at "
              "K=1; host reads %d at K=%d, %d at K=1; nonfinite %d, %d"
              % (SCAN_PLANT, g4.skipped_steps, SCAN_K, g1.skipped_steps,
                 g4.sync_count, SCAN_K, g1.sync_count, g4.nonfinite_steps,
                 g1.nonfinite_steps))
        if (g4.skipped_steps, g1.skipped_steps) != (1, 1) or \
                (g4.sync_count, g1.sync_count) != (4, SCAN_STEPS):
            raise SmokeFailure("scan (c): the guard's counts differ from "
                               "the reference's for this loop")
        _scan_bits("(c) guarded K=%d against the classic guard at K=1"
                   % SCAN_K, gfour, gone)

        # (d) the ladder: a loss read every step, the clip, BatchNorm
        warned, h = _warnings_of("mxnet_tpu_torch.scan")
        try:
            read, info = rig.run(SCAN_K, read=True)
        finally:
            logging.getLogger("mxnet_tpu_torch.scan").removeHandler(h)
        print("[scan] (d) a loss read every step at K=%d: runner %s, "
              "warnings %s" % (SCAN_K, info, warned))
        if not info["bailed"] or info["retired"] or len(warned) != 1 or \
                "read every chunk" not in warned[0]:
            raise SmokeFailure("scan (d): the loss-read loop did not bail "
                               "after %d forces" % 3)
        _scan_bits("(d) a loss read every step, K=%d against K=1"
                   % SCAN_K, read, one)
        _scan_clip(rig, card_line)

        # (e) planted faults, each must fail its check
        real = optimizer.SGDPrep.apply
        with mock.patch.object(
                optimizer.SGDPrep, "apply",
                lambda self, st, row=0, ok=None, skipped=None:
                real(self, st, 0, ok, skipped)):
            bad, _ = rig.run(SCAN_K)
        if not _scan_bits("control: the chunk reads row 0's lr for every "
                          "step, against (b)'s K=1", bad, one):
            raise SmokeFailure("scan (e): row 0's lr for every step "
                               "passed the parity check")
        with mock.patch.object(
                optimizer.SGDPrep, "apply",
                lambda self, st, row=0, ok=None, skipped=None:
                real(self, st, row, None, skipped)):
            bad, _ = rig.run(SCAN_K, plant=SCAN_PLANT,
                             guard=guardrails.GradGuard(
                                 nonfinite="skip_step"))
        if not _scan_bits("control: the verdict ignored in the graph, "
                          "against (c)'s K=1", bad, gone):
            raise SmokeFailure("scan (e): an ignored verdict passed the "
                               "guard's parity check")

        # (a) engagement of a steady chunk
        _scan_engagement(rig, by_graph)

        # (f) times: the same Trainer at K=1 and K=4 in turns
        tr = rig.trainer(SCAN_K)
        at = [0]

        def step():
            rig.step(tr, at[0])
            at[0] += 1
        _scan_turns("BERT-base %d x %d bf16, SGD, dropout 0.1" % (
            TRAIN_BATCH, TRAIN_SEQ), step, SCAN_K, card_line, "BERT-base")
        mx.autograd.flush_all_pending()
        mx.autograd.disarm_fused_update()
        del tr
        _free_graphs(rig.net, rig.mlm)
        del rig
        _scan_resnet(seed)
        _scan_mlp(seed, card_line)
    finally:
        os.environ.pop("MXNET_SCAN_STEPS", None)
        os.environ.pop("MXNET_GUARD_CLIP_NORM", None)
    return {"scan": cap4}, launched


# -- phase 15: the vision model zoo, gluon.data.vision, worker processes ----
# VGG-16 trained as an ImageNet user trains it: 64 x 224^2, 1000 classes,
# SGD lr 0.01, momentum 0.9, wd 5e-4, fed by DataLoader(num_workers=4)
VISION_BATCH, VISION_SIDE, VISION_STEPS = 64, 224, 10
VISION_WORKERS = 4
# the labels fall in 10 of the 1000 classes, which the net learns within
# the 10 steps of one epoch (the loss falls)
VISION_CLASSES = 10
VISION_SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 5e-4}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# every other family: one full-width training step at batch 32
FAMILY_BATCH = 32
FAMILIES = (("alexnet", 224), ("vgg16_bn", 224), ("mobilenet1_0", 224),
            ("mobilenet_v2_1_0", 224), ("densenet121", 224),
            ("squeezenet1_0", 224), ("squeezenet1_1", 224),
            ("inception_v3", 299))
# row-8 launches of one eager training step (forward and backward of each
# Dropout layer); the others have none
VISION_DROPOUT_LAUNCHES = {"vgg16": 4, "alexnet": 4, "vgg16_bn": 4,
                           "squeezenet1_0": 2, "squeezenet1_1": 2,
                           "inception_v3": 2}
# The first step (f32, TF32 off, the dropout kernel) against its float64
# twin (the same weights, batch and dropout seeds; the plain dropout in
# f64): the largest of the loss's relative distance and each gradient's
# relative L2 distance (a gradient whose f64 norm is below 1e-4 of the
# median, a bias before a BatchNorm, is rounding noise and not held).
# Limits twice the largest reading over seeds 0-4 on an H100
# (vision_readings): vgg16 0.0057-0.00725 (the first convolution's weight
# gradient, a sum over 64 x 224^2 positions), alexnet 0.000631-0.00488,
# vgg16_bn 0.00785-0.0114, mobilenet1_0 0.0104-0.0169, mobilenet_v2_1_0
# 0.012-0.0151, densenet121 0.157-0.253 (the stem BatchNorm's gamma: f32
# E[x^2] - E[x]^2 and sum(dy x) - mean sum(dy) over 401 408 values a
# channel), squeezenet1_0 0.00212-0.00373, squeezenet1_1 0.000617-0.0037,
# inception_v3 0.036-0.0401, Conv2DTranspose 7.19e-07 (groups 2) and
# 1.21e-06 (groups 1) at every seed. The controls read 0.989 (both
# dropouts on one seed) and 1.41 (the kernel unflipped).
VISION_TWIN = {"vgg16": 0.0145, "alexnet": 0.00976, "vgg16_bn": 0.0228,
               "mobilenet1_0": 0.0338, "mobilenet_v2_1_0": 0.0302,
               "densenet121": 0.506, "squeezenet1_0": 0.00746,
               "squeezenet1_1": 0.0074, "inception_v3": 0.0802,
               "deconv": 2.42e-06}
# (e) an FCN-like upsampling: (32, 512, 14, 14) -> (32, 256, 28, 28)
DECONV_IN, DECONV_OUT, DECONV_SIDE = 512, 256, 14
MNIST_IDX_TRAIN, MNIST_IDX_TEST, MNIST_IDX_EPOCHS = 5000, 1000, 2


class VisionChain:
    """Phase 15's input chain over ``base`` (HWC uint8 images, labels):
    a left-right flip drawn from the seed and the sample's index, HWC to
    CHW, /255, ImageNet's mean and std, in f32, with the arithmetic of
    ``transforms.ToTensor`` and ``Normalize``. numpy only, so it runs in
    worker processes; the same sample comes out whichever worker makes
    it."""

    def __init__(self, base, seed, flip=True):
        self.base, self.seed, self.flip = base, seed, flip

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        import numpy as np
        img, label = self.base[i]
        if self.flip and \
                np.random.RandomState(self.seed * 1000003 + i).rand() < 0.5:
            img = img[:, ::-1]
        x = (img.astype(np.float32) / 255.0).transpose(2, 0, 1)
        mean = np.asarray(IMAGENET_MEAN, np.float32).reshape(-1, 1, 1)
        std = np.asarray(IMAGENET_STD, np.float32).reshape(-1, 1, 1)
        return (x - mean) / std, label


def _shm_line():
    import shutil
    total, _, free = shutil.disk_usage("/dev/shm")
    return "/dev/shm %.2f GB, %.2f GB free" % (total / 1e9, free / 1e9)


def _shm_segments():
    import glob
    from mxnet_tpu_torch.gluon.data.dataloader import SHM_PREFIX
    return set(glob.glob("/dev/shm/%s*" % SHM_PREFIX))


def _vision_data(seed):
    """One epoch of (a): VISION_STEPS batches of HWC uint8 images."""
    import mxnet_tpu_torch as mx
    return mx.gluon.data.vision.SyntheticImageDataset(
        num_samples=VISION_BATCH * VISION_STEPS,
        shape=(VISION_SIDE, VISION_SIDE, 3), num_classes=VISION_CLASSES,
        seed=seed)


def _epoch(loader, seed):
    """Every batch of one epoch of ``loader`` under ``np.random.seed``
    (the shuffle), as (data, label) tensors on the card."""
    import numpy as np
    np.random.seed(seed)
    return [(a.tensor(), b.tensor()) for a, b in loader]


def _epochs_equal(got, want):
    import torch
    return len(got) == len(want) and all(
        a.dtype == c.dtype and torch.equal(a, c) and torch.equal(b, d)
        for (a, b), (c, d) in zip(got, want))


class _ArrivalOrder:
    """A fork context whose second Queue (the loader's results) numbers
    each result by its arrival: the loader's reorder buffer then yields
    batches in completion order (the control of (b))."""

    def __init__(self, real):
        self._real, self._made = real, 0

    def __getattr__(self, name):
        return getattr(self._real, name)

    def Queue(self):
        q = self._real.Queue()
        self._made += 1
        if self._made == 2:
            real_get, arrived = q.get, [0]

            def get(*a, **kw):
                seq, status, payload = real_get(*a, **kw)
                arrived[0] += 1
                return arrived[0] - 1, status, payload
            q.get = get
        return q


class _SlowFirst:
    """``base`` whose first batch's samples take 0.3 s each in a worker,
    so that later batches complete before it."""

    def __init__(self, base, first):
        self.base, self.first = base, set(first)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        if i in self.first:
            time.sleep(0.3)
        return self.base[i]


def _vision_loader(seed, where):
    """(b) the loader: worker batches against num_workers=0 bit for bit,
    the Gluon transforms sent to threads, no worker touching the card,
    no segment left. Returns the seconds of one 4-worker epoch and the
    lazy-init count."""
    import multiprocessing
    import os
    import warnings
    from unittest import mock
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.data import dataloader as dl
    from mxnet_tpu_torch.gluon.data.vision import transforms
    gdata = mx.gluon.data
    base = _vision_data(seed)
    chain = VisionChain(base, seed)

    def loader(ds, workers):
        return gdata.DataLoader(ds, batch_size=VISION_BATCH, shuffle=True,
                                num_workers=workers)
    # a worker that reaches for CUDA passes torch.cuda._lazy_init (the C++
    # side calls it too): count such calls made outside the parent
    parent, touched = os.getpid(), multiprocessing.get_context(
        "fork").Value("i", 0)
    real_init = torch.cuda._lazy_init

    def lazy_init():
        if os.getpid() != parent:
            with touched.get_lock():
                touched.value += 1
        return real_init()
    before = _shm_segments()
    with mock.patch.object(torch.cuda, "_lazy_init", lazy_init):
        want = _epoch(loader(chain, 0), seed)
        t0 = time.perf_counter()
        got = _epoch(loader(chain, VISION_WORKERS), seed)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        left = _shm_segments() - before
        same = _epochs_equal(got, want)
        print("[vision] (b) %d batches of %d x 3 x %d^2 f32 from %d worker "
              "processes in %.2f s: bit for bit with num_workers=0 %s; "
              "lazy CUDA inits in workers %d; segments left in /dev/shm %d; "
              "%s" % (len(got), VISION_BATCH, VISION_SIDE, VISION_WORKERS,
                      seconds, same, touched.value, len(left), where))
        if not same or touched.value or left:
            raise SmokeFailure("vision (b): the worker batches differ from "
                               "num_workers=0's, a worker touched CUDA, or "
                               "a shared-memory segment was left")

        # the Gluon transforms make NDArrays: threads, one warning
        gluon_chain = base.transform_first(transforms.Compose([
            transforms.ToTensor(),
            transforms.Normalize(IMAGENET_MEAN, IMAGENET_STD)]))
        threaded = loader(gluon_chain, VISION_WORKERS)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            g1 = _epoch(threaded, seed)
            g2 = _epoch(threaded, seed)
        forks = [str(w.message) for w in rec if "fork" in str(w.message)]
        plain = _epoch(loader(VisionChain(base, seed, flip=False),
                              VISION_WORKERS), seed)
        same = _epochs_equal(g1, plain) and _epochs_equal(g2, plain)
        print("[vision] (b) transforms.Compose([ToTensor(), Normalize()]) "
              "with num_workers=%d: %d warning(s) in two epochs (%s), "
              "threaded, bit for bit with the numpy chain without the flip "
              "%s" % (VISION_WORKERS, len(forks),
                      forks[0][:60] + "..." if forks else "none", same))
        if len(forks) != 1 or not same:
            raise SmokeFailure("vision (b): the Gluon transforms did not go "
                               "to threads with one warning and the numpy "
                               "chain's values")

    # control: a loader yielding worker batches in completion order
    slow = _SlowFirst(chain, [])
    np.random.seed(seed)
    first = list(gdata.RandomSampler(len(chain)))[:VISION_BATCH]
    slow.first = set(first)
    real_ctx = dl.multiprocessing.get_context
    with mock.patch.object(dl.multiprocessing, "get_context",
                           lambda kind: _ArrivalOrder(real_ctx(kind))):
        bad = _epoch(loader(slow, VISION_WORKERS), seed)
    caught = not _epochs_equal(bad, want)
    print("[control] worker batches yielded in completion order (the first "
          "batch slowed): %s" % ("caught" if caught else "MISSED"))
    if not caught:
        raise SmokeFailure("control: the loader check passed batches in "
                           "completion order")
    # control: a worker that touches the card is seen
    class Touching:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            torch.zeros(1, device="cuda")
            return np.zeros(2, np.float32)
    touched.value = 0
    with mock.patch.object(torch.cuda, "_lazy_init", lazy_init):
        try:
            list(gdata.DataLoader(Touching(), batch_size=4, num_workers=2))
            raised = False
        except RuntimeError:
            raised = True
    print("[control] a worker creating a CUDA tensor: the loader raised %s, "
          "lazy CUDA inits in workers %d: %s" % (
              raised, touched.value,
              "caught" if raised and touched.value else "MISSED"))
    if not (raised and touched.value):
        raise SmokeFailure("control: a worker touching CUDA went unseen")
    return seconds


def _vision_step(net, loss_fn, x, y):
    import mxnet_tpu_torch as mx
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    return loss


def _grads(net):
    return {n: p.grad().tensor().detach().double().clone()
            for n, p in net.collect_params().items()
            if p.grad_req != "null"}


@contextlib.contextmanager
def _f64_twin():
    """The plain kernels, the dropout in f64 among them (the op runs its
    composition for f64 otherwise)."""
    from unittest import mock
    from mxnet_tpu_torch.ops import cuda_dropout
    with _plain_kernels(f32_twin=True), mock.patch.object(
            cuda_dropout, "dropout_available",
            lambda shape, dtype, p: 0.0 < p < 1.0):
        yield


@contextlib.contextmanager
def _one_seed_for_both():
    """The planted fault of (a): every dropout of a step reuses the first
    one's seed."""
    from unittest import mock
    import mxnet_tpu_torch as mx
    real, first = mx.random.seeds, []

    def seeds(n, ctx=None):
        if not first:
            first.append(real(n, ctx))
        return first[0]
    with mock.patch.object(mx.random, "seeds", seeds):
        yield


class _Twin:
    """A net's f32 step against its float64 twin: ``build()`` makes the
    net, which gets the f32 net's weights in f64."""

    def __init__(self, tag, net, build, x, y, seed):
        import numpy as np
        import mxnet_tpu_torch as mx
        self.tag, self.net, self.x, self.y, self.seed = tag, net, x, y, seed
        self.loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        twin = build()
        twin.cast("float64")
        mx.params_from_numpy(twin, {
            n: p.data().asnumpy().astype(np.float64)
            for n, p in net.collect_params().items()}, ctx=mx.gpu(0))
        mx.random.seed(seed)
        with _f64_twin():
            loss = _vision_step(twin, self.loss_fn,
                                mx.nd.NDArray(x.tensor().double()), y)
        self.loss64 = loss.tensor().detach().double().mean()
        self.g64 = _grads(twin)
        # a bias before a BatchNorm has a zero gradient: in f64 it is
        # rounding noise, and no yardstick (phase 7's rule)
        norms = sorted(float(g.norm()) for g in self.g64.values())
        floor = 1e-4 * norms[len(norms) // 2]
        self.noise = sorted(n for n, g in self.g64.items()
                            if float(g.norm()) < floor)
        del twin

    def reading(self, fault=None):
        """(the largest distance, where) of the f32 step from the twin."""
        import mxnet_tpu_torch as mx
        mx.random.seed(self.seed)
        with (fault or contextlib.nullcontext)():
            loss = _vision_step(self.net, self.loss_fn, self.x, self.y)
        worst = (float(abs(loss.tensor().detach().double().mean()
                           - self.loss64) / abs(self.loss64)), "loss")
        for n, g in _grads(self.net).items():
            if n not in self.noise:
                d = float((g - self.g64[n]).norm() / self.g64[n].norm())
                worst = max(worst, (d, n))
        return worst

    def check(self, limit):
        worst = self.reading()
        verdict = "unset" if limit is None else \
            ("FAIL" if worst[0] > limit else "ok")
        print("[vision] %s: f32 step (TF32 off) against its float64 twin: "
              "largest distance %.3g (%s), limit %s %s; %d gradient arrays "
              "at f64 rounding noise not held%s" % (
                  self.tag, worst[0], worst[1],
                  "%.3g" % limit if limit is not None else "unset", verdict,
                  len(self.noise),
                  " (e.g. %s)" % self.noise[0] if self.noise else ""))
        if limit is not None and worst[0] > limit:
            raise SmokeFailure("%s: the step is beyond its limit from its "
                               "float64 twin" % self.tag)
        return worst[0]


def _zoo_net(name, side, seed, classes=1000):
    """``get_model(name)`` on the card, prefix ``<name>_``, Xavier from
    ``seed``, its shapes inferred; returns (net, build)."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    def build():
        return vision.get_model(name, classes=classes, prefix=name + "_")
    mx.random.seed(seed)
    net = build()
    net.initialize(mx.init.Xavier())
    with torch.no_grad():
        net(mx.nd.zeros((1, 3, side, side)))
    return net, build


def _card_batch(seed, n, side, classes=1000):
    import torch
    import mxnet_tpu_torch as mx
    g = torch.Generator(device=DEV).manual_seed(seed + 50)
    x = torch.randn(n, 3, side, side, generator=g, device=DEV)
    y = torch.randint(0, classes, (n,), generator=g, device=DEV)
    return mx.nd.NDArray(x), mx.nd.NDArray(y.float())


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms (some of its f32 weight-gradient
    algorithms add with atomics, in another order from run to run)."""
    import torch
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def _vgg_first_batch(seed):
    """The first batch of (a)'s epoch (made in-process)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    np.random.seed(seed)
    loader = mx.gluon.data.DataLoader(
        VisionChain(_vision_data(seed), seed), batch_size=VISION_BATCH,
        shuffle=True)
    x, y = next(iter(loader))
    return x, y


def _vision_vgg(seed, where):
    """(a) VGG-16 trained at 64 x 224^2, eager and hybridized. Returns
    (launches of one eager step, launches recorded into its graphs)."""
    import math
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, cached_op
    from mxnet_tpu_torch.ops import cuda_build, cuda_dropout
    gdata = mx.gluon.data
    net, build = _zoo_net("vgg16", VISION_SIDE, seed)
    params = net.collect_params()
    print("[vision] (a) vgg16: %d parameters in %d arrays, Xavier from seed "
          "%d; SGD %s; batch %d x 3 x %d^2 f32 from DataLoader(shuffle=True, "
          "num_workers=%d)" % (
              sum(p.data().size for p in params.values()), len(params), seed,
              VISION_SGD, VISION_BATCH, VISION_SIDE, VISION_WORKERS))
    loader = gdata.DataLoader(VisionChain(_vision_data(seed), seed),
                              batch_size=VISION_BATCH, shuffle=True,
                              num_workers=VISION_WORKERS)
    x0, y0 = _vgg_first_batch(seed)
    twin = _Twin("(a) vgg16, the first step", net, build, x0, y0, seed)
    twin.check(VISION_TWIN["vgg16"])
    bad = twin.reading(_one_seed_for_both)
    limit = VISION_TWIN["vgg16"]
    caught = limit is not None and bad[0] > limit
    print("[control] both dropouts on one seed: distance %.3g (%s) %s"
          % (bad[0], bad[1], "caught" if caught else "MISSED"))
    if limit is not None and not caught:
        raise SmokeFailure("control: the twin check passed a step whose "
                           "dropouts share one seed")

    net.hybridize(static_alloc=True, static_shape=True)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize(static_alloc=True, static_shape=True)
    snap = _snapshot(params)
    state = {}

    def step(trainer, x, y):
        loss = _vision_step(net, loss_fn, x, y)
        trainer.step(VISION_BATCH)
        return loss

    def run(compiled, ldr=loader):
        _restore(params, snap)
        autograd.disarm_fused_update()
        state["tr"] = trainer = mx.gluon.Trainer(params, "sgd",
                                                 dict(VISION_SGD),
                                                 kvstore="device")
        mx.random.seed(seed)
        np.random.seed(seed)
        losses, waits = [], []
        with (contextlib.nullcontext() if compiled else cached_op.eager()):
            it = iter(ldr)
            for i in range(VISION_STEPS):
                t0 = time.perf_counter()
                x, y = next(it)
                waits.append(time.perf_counter() - t0)
                if i == 0 and not compiled:
                    cuda_build.reset_launch_counts()
                loss = step(trainer, x, y)
                if i == 0 and not compiled:
                    torch.cuda.synchronize()
                    state["counts"] = {k: v for k, v in
                                       cuda_build.launch_counts().items()
                                       if v}
                losses.append(loss.tensor().detach().float().mean().clone())
                state["batch"] = (x, y)
            it.close()
        torch.cuda.synchronize()
        return (losses, _snapshot(params)), waits

    scalar = cuda_dropout.scalar_launches
    # bit for bit with the layout pass off; phase 19 holds the pass's run
    # to the eager steps within LAYOUT_LIMIT
    with _deterministic(), layout_opt("0"):
        (eager, waits4) = run(False)
        counts = state["counts"]
        (again, _) = run(False)
        with _capture_launches() as cap:
            (compiled, _), held = _graph_mb(lambda: run(True))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e6
    dist, where_d = _run_distance(compiled, eager)
    spread, where_s = _run_distance(again, eager)
    losses = [float(v) for v in eager[0]]
    print("[vision] (a) eager losses %s; eager against eager %.3g%s; "
          "losses equal to the eager run's, step by step: hybridized %s"
          % (" ".join("%.4f" % v for v in losses), spread,
             "" if spread == 0 else " at " + where_s,
             "".join("=" if torch.equal(a, b) else "x"
                     for a, b in zip(compiled[0], eager[0]))))
    print("[vision] (a) hybridized against eager over %d steps (losses "
          "and parameters): largest distance %.3g%s; one eager step "
          "launched %s, the graphs recorded %s" % (
              VISION_STEPS, dist, " (bit for bit)" if dist == 0 else
              " at %s FAIL" % where_d, counts,
              {k: v for k, v in cap.items() if v}))
    if dist != 0:
        raise SmokeFailure("vision (a): the hybridized steps differ from the "
                           "eager ones")
    if counts.get("dropout") != 4 or cap.get("dropout") != 4:
        raise SmokeFailure("vision (a): row 8 launched %s an eager step and "
                           "%s into the graphs, 4 expected"
                           % (counts.get("dropout"), cap.get("dropout")))
    _vector_dropouts("vision", scalar, "%d an eager step over two eager "
                     "runs of %d steps, %d into the graphs"
                     % (counts.get("dropout"), VISION_STEPS,
                        cap.get("dropout")))
    if not all(math.isfinite(v) for v in losses) or \
            not sum(losses[-3:]) < sum(losses[:3]):
        raise SmokeFailure("vision (a): the loss did not fall: %s" % losses)

    # (g) numbers: in turns, the profile, the loader's wait, memory,
    # under the algorithms the graphs were captured with, on the default
    # path (MXNET_LAYOUT_OPT as set: other graphs than (a)'s, captured by
    # the first two steps)
    with _deterministic():
        x, y = state["batch"]
        tr = state["tr"]
        step(tr, x, y)
        step(tr, x, y)
        eager_ms, comp_ms = _in_turns(lambda: step(tr, x, y),
                                      lambda: step(tr, x, y), turns=10)
        _, waits0 = run(True, gdata.DataLoader(
            VisionChain(_vision_data(seed), seed), batch_size=VISION_BATCH,
            shuffle=True, num_workers=0))
        print("[vision] (g) vgg16 step (batch %d): %.2f ms eager (%.1f "
              "images/s), %.2f ms hybridized (%.1f images/s), host clock, "
              "medians of 10 in turns; graphs hold %.1f MB (peak %.1f MB "
              "above the start while capturing), peak allocated %.1f MB; "
              "the loop waits on the loader %.2f ms a step at "
              "num_workers=%d, %.2f ms at 0 (medians of steps 2-%d); %s" % (
                  VISION_BATCH, eager_ms, VISION_BATCH / eager_ms * 1e3,
                  comp_ms, VISION_BATCH / comp_ms * 1e3, held[0], held[1],
                  peak, statistics.median(waits4[1:]) * 1e3,
                  VISION_WORKERS, statistics.median(waits0[1:]) * 1e3,
                  VISION_STEPS, where))
        _profile("one hybridized VGG-16 step (batch %d, SGD in the "
                 "backward's graph)" % VISION_BATCH, lambda: step(tr, x, y))
        with cached_op.eager():
            _profile("one eager VGG-16 step (batch %d)" % VISION_BATCH,
                     lambda: step(tr, x, y))
    del tr, state["tr"]
    _free_graphs(net, loss_fn)
    return counts, cap


def _vision_families(seed, where):
    """(c) every other family: its first step against its float64 twin,
    then one SGD step and its time. Returns {name: dropout launches}."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_build
    launches = {}
    for name, side in FAMILIES:
        net, build = _zoo_net(name, side, seed)
        x, y = _card_batch(seed, FAMILY_BATCH, side)
        _Twin("(c) %s, batch %d x %d^2" % (name, FAMILY_BATCH, side), net,
              build, x, y, seed).check(VISION_TWIN[name])
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(VISION_SGD))
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        times = []
        for i in range(4):
            torch.cuda.synchronize()
            if i == 0:
                cuda_build.reset_launch_counts()
            t0 = time.perf_counter()
            loss = _vision_step(net, loss_fn, x, y)
            trainer.step(FAMILY_BATCH)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                launches[name] = cuda_build.launch_counts().get("dropout", 0)
        finite = bool(torch.isfinite(loss.tensor()).all())
        print("[vision] (c) %s: one SGD step %.2f ms (median of 3 after the "
              "first), loss finite %s, row-8 launches %d (expected %d); %s"
              % (name, statistics.median(times[1:]), finite, launches[name],
                 VISION_DROPOUT_LAUNCHES.get(name, 0), where))
        if not finite or launches[name] != \
                VISION_DROPOUT_LAUNCHES.get(name, 0):
            raise SmokeFailure("vision (c): %s's step is not finite or "
                               "launched row 8 %d times" % (name,
                                                            launches[name]))
        del net, trainer
        torch.cuda.empty_cache()
    return launches


def _write_idx(root, prefix, images, labels, gz):
    import gzip
    import os
    import struct
    opener, ext = (gzip.open, ".gz") if gz else (open, "")
    with opener(os.path.join(root, "%s-images-idx3-ubyte%s" % (prefix, ext)),
                "wb") as f:
        f.write(struct.pack(">IIII", 2051, *images.shape) + images.tobytes())
    with opener(os.path.join(root, "%s-labels-idx1-ubyte%s" % (prefix, ext)),
                "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)) + labels.tobytes())


def mnist_idx(root, seed, n_train=MNIST_IDX_TRAIN, n_test=MNIST_IDX_TEST):
    """MNIST idx files under ``root`` from ``seed``: uint8 images and
    mnist_synthetic's learnable labels (the argmax of a random linear map
    of the image in [0, 1]); the training files gzipped, the test files
    not."""
    import numpy as np
    rng = np.random.RandomState(seed)
    W = rng.rand(784, 10)
    for prefix, n, gz in (("train", n_train, True), ("t10k", n_test, False)):
        x = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
        y = (x.reshape(n, -1) / 255.0 @ W).argmax(axis=1).astype(np.uint8)
        _write_idx(root, prefix, x, y, gz)


def _to_float(data, label):
    """train_mnist.py's transform: uint8 0-255 to float 0-1."""
    import numpy as np
    return data.astype(np.float32) / 255.0, label


def _vision_mnist(seed):
    """(d) BASELINE.json configs[0] through gluon.data.vision.MNIST: the
    MLP trained with 2 worker processes, bit for bit with 0."""
    import tempfile
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    gdata = mx.gluon.data
    with tempfile.TemporaryDirectory() as root:
        mnist_idx(root, seed)
        train = gdata.vision.MNIST(root=root, train=True).transform(
            _to_float)
        test = gdata.vision.MNIST(root=root, train=False).transform(
            _to_float)
        mx.random.seed(seed)
        net = mnist_mlp(mx, False)
        net.initialize(mx.init.Xavier())
        net(mx.nd.zeros((1, 28, 28, 1)))
        init = {n: p.data().asnumpy() for n, p in
                net.collect_params().items()}
        runs = {}
        for workers in (2, 0):
            net = mnist_mlp(mx, False)
            mx.params_from_numpy(net, init, ctx=mx.gpu(0))
            trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                       {"learning_rate": MNIST_LR})
            loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
            np.random.seed(seed)
            loader = gdata.DataLoader(train, batch_size=MNIST_BATCH,
                                      shuffle=True, num_workers=workers)
            losses = []
            for _ in range(MNIST_IDX_EPOCHS):
                for data, label in loader:
                    loss = _vision_step(net, loss_fn, data, label)
                    trainer.step(data.shape[0])
                    losses.append(loss.tensor().detach().mean().clone())
            acc = mx.metric.Accuracy()
            for data, label in gdata.DataLoader(test,
                                                batch_size=MNIST_BATCH):
                acc.update([label], [net(data)])
            runs[workers] = (torch.stack(losses), acc.get()[1])
    (l2, a2), (l0, a0) = runs[2], runs[0]
    same = torch.equal(l2, l0)
    per = len(l2) // MNIST_IDX_EPOCHS
    first, last = float(l2[:per].mean()), float(l2[-per:].mean())
    print("[vision] (d) MNIST idx files (%d gz training, %d raw test images "
          "from seed %d) through gluon.data.vision.MNIST and "
          "DataLoader(num_workers=2): %d steps, losses bit for bit with "
          "num_workers=0 %s; mean loss %.4f in epoch 1, %.4f in epoch %d; "
          "test accuracy %.4f (%.4f at num_workers=0)" % (
              MNIST_IDX_TRAIN, MNIST_IDX_TEST, seed, len(l2), same, first,
              last, MNIST_IDX_EPOCHS, a2, a0))
    if not same or not last < first:
        raise SmokeFailure("vision (d): the MNIST run with workers differs "
                           "from num_workers=0's, or its loss did not fall")


def _deconv_reading(layer, twin, x, fault=None):
    """Relative L2 of the f32 output and the data, weight and bias
    gradients from the float64 twin's; the largest."""
    import mxnet_tpu_torch as mx
    outs = []
    for net, xx, f in ((layer, x, fault),
                       (twin, mx.nd.NDArray(x.tensor().double()), None)):
        xx.attach_grad()
        with (f or contextlib.nullcontext)():
            with mx.autograd.record():
                out = net(xx)
                loss = (out * out).sum()
            loss.backward()
        outs.append([out.tensor().detach().double(),
                     xx.grad.tensor().double()]
                    + [p.grad().tensor().double()
                       for p in net.collect_params().values()])
    return max(float((a - b).norm() / b.norm()) for a, b in zip(*outs))


def _vision_deconv(seed, where):
    """(e) Conv2DTranspose at an FCN-like shape against its f64 twin,
    groups 1 and 2, with the unflipped-kernel control."""
    import numpy as np
    import torch
    from unittest import mock
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import nn as nn_ops
    g = torch.Generator(device=DEV).manual_seed(seed + 60)
    x = mx.nd.NDArray(torch.randn(FAMILY_BATCH, DECONV_IN, DECONV_SIDE,
                                  DECONV_SIDE, generator=g, device=DEV))
    worst = 0.0
    for groups in (1, 2):
        def build():
            return mx.gluon.nn.Conv2DTranspose(
                DECONV_OUT, 4, strides=2, padding=1, groups=groups,
                in_channels=DECONV_IN, prefix="up_")
        mx.random.seed(seed)
        layer = build()
        layer.initialize(mx.init.Xavier())
        twin = build()
        twin.cast("float64")
        mx.params_from_numpy(twin, {
            n: p.data().asnumpy().astype(np.float64)
            for n, p in layer.collect_params().items()}, ctx=mx.gpu(0))
        d = _deconv_reading(layer, twin, x)
        t0 = time.perf_counter()
        out = layer(x)
        torch.cuda.synchronize()
        print("[vision] (e) Conv2DTranspose %s -> %s, kernel 4, stride 2, "
              "groups %d: forward and backward against the float64 twin "
              "%.3g (limit %s); forward %.2f ms" % (
                  tuple(x.shape), tuple(out.shape), groups, d,
                  VISION_TWIN["deconv"],
                  (time.perf_counter() - t0) * 1e3))
        worst = max(worst, d)
        real = nn_ops._CONV_T[2]
        bad = _deconv_reading(layer, twin, x, lambda: mock.patch.dict(
            nn_ops._CONV_T, {2: lambda xx, w, *a: real(xx, w.flip((2, 3)),
                                                       *a)}))
        limit = VISION_TWIN["deconv"]
        caught = limit is not None and bad > limit
        print("[control] the kernel left unflipped (groups %d): %.3g %s"
              % (groups, bad, "caught" if caught else "MISSED"))
        if limit is not None and (d > limit or not caught):
            raise SmokeFailure("vision (e): Conv2DTranspose beyond its limit "
                               "from the float64 twin, or the unflipped "
                               "kernel passed")
    return worst


def _vision_dropout_row(seed, reps, card, launches):
    """(g) row 8 at VGG's classifier shape, (64, 4096) f32, p 0.5."""
    import torch
    import torch.nn.functional as F
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_dropout
    g = torch.Generator(device=DEV).manual_seed(seed + 70)
    M, C, p = VISION_BATCH, 4096, 0.5
    x = torch.randn(M, C, generator=g, device=DEV)
    sd = mx.random.seeds(1, mx.gpu(0))
    err = float((cuda_dropout.dropout_cuda(x, p, sd)
                 - cuda_dropout.dropout_plain(x, p, sd)).abs().max())
    ms, plain_ms, lib_ms = (_gpu_ms(f, reps) for f in (
        lambda: cuda_dropout.dropout_cuda(x, p, sd),
        lambda: cuda_dropout.dropout_plain(x, p, sd),
        lambda: F.dropout(x, p, training=True)))
    bw, _, f32_peak = _peaks(card)
    t_bytes, t_ops = 2 * M * C * 4 / bw * 1e3, 20 * M * C / f32_peak * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    row = {"name": "dropout_vgg", "kernel": "dropout", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/dropout.cu",
           "replaces": "mxnet_tpu/ops/pallas_dropout.py:73",
           "launches": launches, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": lib_ms}
    print("[times] %-18s kernel %.4f ms  plain %.4f ms  library %.4f ms"
          "  bound %.4f ms (%s), (%d, %d) f32 p %g"
          % ("dropout_vgg", ms, plain_ms, lib_ms, bound, by, M, C, p))
    if err != 0:
        raise SmokeFailure("dropout at (%d, %d) f32 differs from its plain "
                           "version" % (M, C))
    return row


def vision_readings(seeds, card_line):
    """The readings behind VISION_TWIN: each twin distance at ``seeds``
    (print only; the limits are twice the largest)."""
    import torch
    import mxnet_tpu_torch as mx
    with _no_tf32():
        for seed in seeds:
            for name, side in (("vgg16", VISION_SIDE),) + FAMILIES:
                net, build = _zoo_net(name, side, seed)
                x, y = _vgg_first_batch(seed) if name == "vgg16" else \
                    _card_batch(seed, FAMILY_BATCH, side)
                _Twin("seed %d %s" % (seed, name), net, build, x, y,
                      seed).check(None)
                del net
                torch.cuda.empty_cache()
            _vision_deconv(seed, card_line)


def phase_vision(seed, reps, card, card_line):
    """15. vision. Returns (launches of one eager VGG-16 step, {"vision":
    launches recorded into its graphs}, {family: row-8 launches}, the
    dropout_vgg row)."""
    where = "%s; %s" % (card_line, _shm_line())
    print("[vision] %s" % where)
    with _no_tf32():
        _vision_loader(seed, where)
        counts, cap = _vision_vgg(seed, where)
        families = _vision_families(seed, where)
        _vision_mnist(seed)
        _vision_deconv(seed, where)
        row = _vision_dropout_row(seed, reps, card, counts.get("dropout", 0))
    return counts, {"vision": cap}, families, row


# -- phase 16: the ImageNet input path ---------------------------------------
# BASELINE.json configs[1] fed as the reference feeds ImageNet: JPEG
# records in a .rec/.idx through io.ImageRecordIter, with upstream
# train_imagenet.py's augmentation (resize 256, random 224^2 crop,
# mirror, ImageNet's mean and std) and --data-nthreads default (4)
IMAGENET_RECORDS = 1280           # 10 batches of 128
IMAGENET_SIDES = (300, 501)       # each side drawn from 300-500 px
IMAGENET_QUALITY = 95             # im2rec's default
IMAGENET_BATCH = 128
IMAGENET_STEPS = 10
IMAGENET_ITER = dict(
    data_shape=(3, 224, 224), shuffle=True, rand_crop=True,
    rand_mirror=True, resize=256, mean_r=123.68, mean_g=116.779,
    mean_b=103.939, std_r=58.393, std_g=57.12, std_b=57.375,
    preprocess_threads=4)
DECODE_RECORDS, DECODE_HW = 16, (375, 500)
RAW_RECORDS, RAW_SIDE = 512, 224  # bench.py:80-91: batch * 4 raw records
IMAGENET_TURNS = 2


def imagenet_image(seed, i, h, w):
    """Synthetic photo ``i`` of ``--seed`` (h x w BGR uint8): a smooth
    random field (a few coarse random colours, upsampled by cubic
    interpolation) plus pixel noise, so that its JPEG is of a photo's
    size, not a flat field's."""
    import cv2
    import numpy as np
    rng = np.random.RandomState((seed * 1_000_003 + i) % 2 ** 32)
    coarse = rng.randint(0, 256, (rng.randint(3, 12), rng.randint(3, 12),
                                  3)).astype(np.float32)
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    img += rng.randint(-24, 25, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def imagenet_pack(seed, prefix, n=None, hw=None):
    """Pack ``n`` (``IMAGENET_RECORDS``) synthetic photos (each side
    drawn from ``IMAGENET_SIDES``, or all ``hw``), labels 0-999, with
    ``recordio.pack_img`` at quality 95 into ``prefix``.rec/.idx;
    encoded on 8 threads. Returns (rec, idx, the records' bytes)."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from mxnet_tpu_torch import recordio
    n = n or IMAGENET_RECORDS
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 1000, n)
    shapes = [hw or tuple(rng.randint(*IMAGENET_SIDES, 2)) for _ in range(n)]

    def one(i):
        img = imagenet_image(seed, i, *shapes[i])
        return recordio.pack_img(
            recordio.IRHeader(0, float(labels[i]), i, 0), img,
            quality=IMAGENET_QUALITY)
    with ThreadPoolExecutor(8) as pool:
        records = list(pool.map(one, range(n)))
    w = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i, r in enumerate(records):
        w.write_idx(i, r)
    w.close()
    return prefix + ".rec", prefix + ".idx", sum(len(r) for r in records)


def _imagenet_ctx():
    import mxnet_tpu_torch as mx
    return mx.gpu(0) if DEV == "cuda" else mx.cpu()


def _imagenet_iter(rec, idx, seed, **kw):
    import mxnet_tpu_torch as mx
    args = dict(IMAGENET_ITER, path_imgrec=rec, path_imgidx=idx,
                batch_size=IMAGENET_BATCH, seed=seed, ctx=_imagenet_ctx())
    args.update(kw)
    return mx.io.ImageRecordIter(**args)


def _imagenet_build(card_line):
    """(a) the io library from csrc/io.cc, its libjpeg; a header of
    another libjpeg ABI must be refused."""
    import tempfile
    from pathlib import Path
    from mxnet_tpu_torch import native
    from mxnet_tpu_torch.base import MXNetError
    t0 = time.perf_counter()
    native.load_io_lib()
    info = native.build_info()
    print("[imagenet] (a) io library %s: %s in %.2f s (load %.2f s), "
          "libjpeg %s %s (the loader resolved %s); %s" % (
              info["library"], "compiled" if info["compiled"] else "reused",
              info["seconds"], time.perf_counter() - t0,
              info["libjpeg_kind"], info["libjpeg"], info["linked"],
              card_line))
    build_root = Path(native.__file__).resolve().parent / "_build"
    if not Path(info["library"]).resolve().is_relative_to(build_root):
        raise SmokeFailure("imagenet (a): the io library %s is not under %s"
                           % (info["library"], build_root))
    with tempfile.TemporaryDirectory(prefix="mxt_jpeg_") as hdr:
        for name in native.JPEG_HEADERS:
            text = (native.JPEG_INCLUDE / name).read_text()
            if name == "jconfig.h":
                text = text.replace("#define JPEG_LIB_VERSION  62",
                                    "#define JPEG_LIB_VERSION  80")
            (Path(hdr) / name).write_text(text)
        path, _ = native.build_io(include=Path(hdr))
        try:
            native.load_io_lib(path)
        except MXNetError as e:
            print("[control] libjpeg ABI-80 headers against the ABI-62 "
                  "library refused at load: %s caught" % e)
        else:
            raise SmokeFailure("control: a library built against ABI-80 "
                               "headers loaded")


def _imagenet_decode(seed, tmp):
    """(b) no resize, crop or mirror, data_shape the records' own size:
    the pipeline's pixels against OpenCV's decode, RGB."""
    import cv2
    import numpy as np
    from mxnet_tpu_torch import recordio
    h, w = DECODE_HW
    rec, idx, _ = imagenet_pack(seed + 1, tmp + "/decode",
                                n=DECODE_RECORDS, hw=DECODE_HW)
    it = _imagenet_iter(rec, idx, seed, data_shape=(3, h, w), shuffle=False,
                        rand_crop=False, rand_mirror=False, resize=0,
                        mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0,
                        std_g=1.0, std_b=1.0, batch_size=DECODE_RECORDS)
    got = it.next().data[0].asnumpy().transpose(0, 2, 3, 1)
    r = recordio.MXRecordIO(rec, "r")
    want = np.stack([cv2.imdecode(np.frombuffer(
        recordio.unpack(r.read())[1], np.uint8), cv2.IMREAD_COLOR)
        for _ in range(DECODE_RECORDS)]).astype(np.float32)
    diff = float(np.abs(got - want[..., ::-1]).max())
    bgr = float(np.abs(got - want).max())
    print("[imagenet] (b) %d JPEG records %dx%d decoded by the pipeline "
          "against cv2.imdecode (OpenCV %s) -> RGB: largest difference %g%s;"
          " control, OpenCV's BGR: %g %s" % (
              DECODE_RECORDS, h, w, cv2.__version__, diff,
              " (bit for bit)" if diff == 0 else " FAIL", bgr,
              "caught" if bgr else "MISSED"))
    if diff != 0:
        raise SmokeFailure("imagenet (b): the pipeline's decode differs from "
                           "OpenCV's by up to %g" % diff)
    if not bgr:
        raise SmokeFailure("control: BGR pixels passed the decode check")


def _epoch_batches(it, n=None):
    """The next ``n`` (or an epoch of) batches as host copies (data,
    label, pad)."""
    out = []
    for b in it:
        out.append((b.data[0].tensor().cpu(), b.label[0].tensor().cpu(),
                    b.pad))
        if n is not None and len(out) == n:
            break
    return out


def _batches_equal(got, want):
    """The indices of the batches that differ in data, label or pad."""
    import torch
    return [i for i, (g, w) in enumerate(zip(got, want))
            if not (torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
                    and g[2] == w[2])] + \
        ([len(want)] if len(got) != len(want) else [])


def _imagenet_card_vs_cpu(seed, rec, idx):
    """(c) one epoch on the card against the same iterator and seed on
    the CPU, bit for bit; a batch uploaded from the wrong staging slot
    must be caught."""
    from unittest import mock
    import mxnet_tpu_torch as mx
    card = _epoch_batches(_imagenet_iter(rec, idx, seed))
    host = _epoch_batches(_imagenet_iter(rec, idx, seed, ctx=mx.cpu()))
    bad = _batches_equal(card, host)
    print("[imagenet] (c) %d batches on %s against ctx=mx.cpu(): %s" % (
        len(host), _imagenet_ctx(),
        "bit for bit ok" if not bad else "differ at %s FAIL" % bad))
    if bad:
        raise SmokeFailure("imagenet (c): the card's batches differ from the "
                           "CPU's at %s" % bad)
    upload = mx.io.ImageRecordIter._upload

    def wrong_slot(self, slot):
        return upload(self, self._slots[(self._turn - 2) % len(self._slots)])
    with mock.patch.object(mx.io.ImageRecordIter, "_upload", wrong_slot):
        faulty = _epoch_batches(_imagenet_iter(rec, idx, seed), 3)
    caught = _batches_equal(faulty, host[:3])
    print("[control] batches uploaded from the previous staging slot: "
          "differ at %s %s" % (caught, "caught" if caught else "MISSED"))
    if not caught:
        raise SmokeFailure("control: batches from the wrong staging slot "
                           "passed the card-vs-CPU check")


def _imagenet_resnet(seed, rec, idx, card_line):
    """(d) ResNet-50 v1 as phase 11(c) trains it, fed by the iterator,
    against the same batches resident; (f) its step times and profile.
    Returns the launches of the fed run."""
    import math
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.ops import cuda_build
    side = IMAGENET_ITER["data_shape"][1]
    amp.init(target_dtype="bfloat16")
    try:
        mx.random.seed(seed)
        net = resnet50_v1(prefix="resnet50fed_")
        net.initialize(init=mx.init.MSRAPrelu(), ctx=_imagenet_ctx())
        with torch.no_grad():
            net(mx.nd.zeros((1, 3, side, side), ctx=_imagenet_ctx()))
        net.hybridize(static_alloc=True, static_shape=True)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        loss_fn.hybridize(static_alloc=True, static_shape=True)
        params = net.collect_params()
        snap = _snapshot(params)

        def step(trainer, x, y):
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(IMAGENET_BATCH)
            return loss

        def fresh():
            _restore(params, snap)
            autograd.disarm_fused_update()
            return mx.gluon.Trainer(params, "sgd", {
                "learning_rate": 0.1, "momentum": 0.9}, kvstore="device")

        def fed(it, trainer, n):
            losses, waits = [], []
            for _ in range(n):
                t0 = time.perf_counter()
                b = it.next()
                waits.append(time.perf_counter() - t0)
                loss = step(trainer, b.data[0], b.label[0])
                losses.append(loss.tensor().detach().float().clone())
            torch.cuda.synchronize()
            return losses, waits

        def resident(batches):
            trainer = fresh()
            losses = [step(trainer, x, y).tensor().detach().float().clone()
                      for x, y in batches]
            torch.cuda.synchronize()
            return (losses, _snapshot(params)), trainer

        with _deterministic():
            it = _imagenet_iter(rec, idx, seed)
            trainer = fresh()
            cuda_build.reset_launch_counts()
            losses, waits = fed(it, trainer, IMAGENET_STEPS)
            counts = cuda_build.launch_counts()
            run_fed = (losses, _snapshot(params))
            again = _imagenet_iter(rec, idx, seed)
            batches = [(mx.nd.NDArray(b.data[0].tensor().clone()),
                        mx.nd.NDArray(b.label[0].tensor().clone()))
                       for b, _ in zip(again, range(IMAGENET_STEPS))]
            run_res, _ = resident(batches)
            dist, where = _run_distance(run_res, run_fed)
            vals = [float(v.mean()) for v in losses]
            print("[imagenet] (d) resnet50_v1, bf16 AMP, hybridized, SGD "
                  "0.1 momentum 0.9 (fused), batch %d: %d steps fed by "
                  "ImageRecordIter, losses %s; the same batches resident: "
                  "largest distance %.3g%s; kernel launches in the fed run "
                  "%s" % (IMAGENET_BATCH, IMAGENET_STEPS,
                          " ".join("%.4f" % v for v in vals), dist,
                          " (bit for bit) ok" if dist == 0 else
                          " at %s FAIL" % where,
                          {k: v for k, v in counts.items() if v} or "none"))
            if dist != 0:
                raise SmokeFailure("imagenet (d): the fed run differs from "
                                   "its resident replay at %s" % where)
            if not all(math.isfinite(v) for v in vals):
                raise SmokeFailure("imagenet (d): a loss is not finite: %s"
                                   % vals)
            swapped = list(batches)
            swapped[1], swapped[2] = swapped[2], swapped[1]
            run_bad, _ = resident(swapped)
            bad, where = _run_distance(run_bad, run_fed)
            print("[control] batches 2 and 3 swapped in the resident run: "
                  "distance %.3g (%s) %s" % (bad, where,
                                             "caught" if bad else "MISSED"))
            if not bad:
                raise SmokeFailure("control: swapped batches passed the "
                                   "fed-vs-resident check")

            # (f) the fed loop (at 4 threads and at every host CPU)
            # against the resident loop, in turns
            iters = {"fed": it, "fed_all": _imagenet_iter(
                rec, idx, seed, preprocess_threads=os.cpu_count())}
            times = {k: [] for k in ("fed", "fed_all", "resident")}
            waits_ms = {"fed": [], "fed_all": []}
            x, y = batches[0]
            for _ in range(IMAGENET_TURNS):
                for kind in ("fed", "resident", "fed_all", "fed_all",
                             "resident", "fed"):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if kind == "resident":
                        for _ in range(IMAGENET_STEPS):
                            step(trainer, x, y)
                        torch.cuda.synchronize()
                    else:
                        iters[kind].reset()
                        _, w = fed(iters[kind], trainer, IMAGENET_STEPS)
                        waits_ms[kind].append(statistics.median(w) * 1e3)
                    times[kind].append((time.perf_counter() - t0) * 1e3
                                       / IMAGENET_STEPS)
            ms = {k: statistics.median(v) for k, v in times.items()}
            print("[imagenet] (f) resnet50_v1 step (batch %d, hybridized, "
                  "bf16 AMP): fed by ImageRecordIter at 4 threads %.2f ms "
                  "(%.1f images/s; the loop waits %.2f ms a step inside "
                  "next(), median), at %d threads %.2f ms (%.1f images/s; "
                  "waits %.2f ms), resident %.2f ms (%.1f images/s); medians "
                  "of %d runs of %d steps each in turns, host clock; the "
                  "first fed epoch's waits %s ms; %d host CPUs; %s" % (
                      IMAGENET_BATCH, ms["fed"],
                      IMAGENET_BATCH / ms["fed"] * 1e3,
                      statistics.median(waits_ms["fed"]), os.cpu_count(),
                      ms["fed_all"], IMAGENET_BATCH / ms["fed_all"] * 1e3,
                      statistics.median(waits_ms["fed_all"]),
                      ms["resident"], IMAGENET_BATCH / ms["resident"] * 1e3,
                      2 * IMAGENET_TURNS, IMAGENET_STEPS,
                      " ".join("%.1f" % (v * 1e3) for v in waits),
                      os.cpu_count(), card_line))

            def fed_step():
                b = it.next()
                step(trainer, b.data[0], b.label[0])
            it.reset()
            for _ in range(IMAGENET_STEPS // 2):   # past the run-ahead
                fed_step()
            _profile("one steady fed ResNet-50 step (batch %d, 4 threads, "
                     "next() inside)" % IMAGENET_BATCH, fed_step)
            _profile("one resident ResNet-50 step (batch %d)"
                     % IMAGENET_BATCH, lambda: step(trainer, x, y))
            del trainer, it, iters, again, batches
        _free_graphs(net, loss_fn)
    finally:
        amp.reset()
    return counts


def _pipeline_rate(rec, idx, seed, n_batches, **kw):
    """Images/s of the iterator alone, batches on the card: the first
    batch (the producer's start) apart, ``n_batches`` more, ending in a
    synchronise."""
    import torch
    it = _imagenet_iter(rec, idx, seed, **kw)
    b = it.next()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for _ in range(n_batches):
        try:
            b = it.next()
        except StopIteration:
            it.reset()
            b = it.next()
        n += b.data[0].shape[0] - b.pad
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def _native_rate(rec, idx, threads, n_batches, side, mirror):
    """Images/s of the native producer alone (``MXIONext`` in a loop,
    nothing copied out), raw records, shuffled: the first batch apart,
    resets at each epoch's end included."""
    import ctypes
    from mxnet_tpu_torch import native
    lib = native.load_io_lib()
    h = lib.MXIOCreateImageRecordIter(
        rec.encode(), idx.encode(), IMAGENET_BATCH, side, side, 1, 1, 0,
        int(mirror), 0, threads, 1)
    if not h:
        raise SmokeFailure("imagenet (e): %s" % native.last_error(lib))
    data = ctypes.POINTER(ctypes.c_uint8)()
    label = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int(0)

    def nxt():
        rc = lib.MXIONext(h, ctypes.byref(data), ctypes.byref(label),
                          ctypes.byref(n))
        if rc == 1:
            lib.MXIOReset(h)
            rc = lib.MXIONext(h, ctypes.byref(data), ctypes.byref(label),
                              ctypes.byref(n))
        if rc != 0:
            raise SmokeFailure("imagenet (e): %s" % native.last_error(lib))
        return n.value
    try:
        nxt()
        t0 = time.perf_counter()
        total = sum(nxt() for _ in range(n_batches))
        return total / (time.perf_counter() - t0)
    finally:
        lib.MXIOFree(h)


def _imagenet_rates(seed, tmp, rec, idx, nbytes, card_line):
    """(e) raw records as bench.py writes them; (f) the JPEG pipeline
    alone at 1, 4 and os.cpu_count() threads."""
    import numpy as np
    from mxnet_tpu_torch import recordio
    raw = (np.random.RandomState(0).rand(3, RAW_SIDE, RAW_SIDE)
           .transpose(1, 2, 0) * 255).astype(np.uint8)
    rrec, ridx = tmp + "/raw.rec", tmp + "/raw.idx"
    w = recordio.MXIndexedRecordIO(ridx, rrec, "w")
    for i in range(RAW_RECORDS):
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i % 1000), i,
                                                       0), raw.tobytes()))
    w.close()
    bench = dict(shuffle=True, rand_crop=False, rand_mirror=True, resize=0,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=255.0,
                 std_g=255.0, std_b=255.0)
    raw_rates = {t: _pipeline_rate(rrec, ridx, 1, 3 * RAW_RECORDS //
                                   IMAGENET_BATCH, preprocess_threads=t,
                                   **bench)
                 for t in (1, 4)}
    native_rates = {t: _native_rate(rrec, ridx, t, 3 * RAW_RECORDS //
                                    IMAGENET_BATCH, RAW_SIDE, True)
                    for t in (1, 4)}
    print("[imagenet] (e) raw %d^2 records (bench.py:80-91: shuffle, "
          "mirror, /255), the pipeline alone to the card: %s images/s; the "
          "native producer alone (MXIONext, nothing copied out): %s "
          "images/s; %s" % (
              RAW_SIDE, ", ".join("%.1f at %d thread%s" % (
                  r, t, "s" * (t > 1)) for t, r in raw_rates.items()),
              ", ".join("%.1f at %d thread%s" % (r, t, "s" * (t > 1))
                        for t, r in native_rates.items()), card_line))
    threads = sorted({1, 4, os.cpu_count()})
    rates = {t: _pipeline_rate(rec, idx, seed, IMAGENET_RECORDS //
                               IMAGENET_BATCH - 1, preprocess_threads=t)
             for t in threads}
    print("[imagenet] (f) JPEG records (%d, %.1f KB each on average, sides "
          "%d-%d, quality %d; resize 256, random crop 224, mirror, "
          "normalise), the pipeline alone to the card: %s images/s; %d host "
          "CPUs; %s" % (IMAGENET_RECORDS, nbytes / IMAGENET_RECORDS / 1e3,
                        IMAGENET_SIDES[0], IMAGENET_SIDES[1] - 1,
                        IMAGENET_QUALITY, ", ".join(
                            "%.1f at %d thread%s" % (r, t, "s" * (t > 1))
                            for t, r in rates.items()),
                        os.cpu_count(), card_line))


def phase_imagenet(seed, card_line):
    """16. ResNet-50 v1 trained from a JPEG .rec through
    io.ImageRecordIter. Returns the launches of the fed run."""
    import tempfile
    print("[imagenet] %s" % card_line)
    _imagenet_build(card_line)
    with tempfile.TemporaryDirectory(prefix="mxt_imagenet_") as tmp:
        t0 = time.perf_counter()
        rec, idx, nbytes = imagenet_pack(seed, tmp + "/train")
        print("[imagenet] %d synthetic JPEG records from seed %d (sides "
              "%d-%d px, quality %d): %.1f MB, packed in %.2f s" % (
                  IMAGENET_RECORDS, seed, IMAGENET_SIDES[0],
                  IMAGENET_SIDES[1] - 1, IMAGENET_QUALITY, nbytes / 1e6,
                  time.perf_counter() - t0))
        _imagenet_decode(seed, tmp)
        _imagenet_card_vs_cpu(seed, rec, idx)
        counts = _imagenet_resnet(seed, rec, idx, card_line)
        _imagenet_rates(seed, tmp, rec, idx, nbytes, card_line)
    return counts


# -- phase 17: the creation and random ops, the losses and norms ------------
RANDOM_DRAWS = 1 << 24            # draws of each _random_* sampler
SAMPLE_DRAWS = 1 << 22            # draws of each parameter of a _sample_*
# the Kolmogorov-Smirnov statistic's 0.1% critical value, 1.95 / sqrt(n)
# (Smirnov's asymptotic), and the chi-square's at p = 1e-3
KS_ALPHA = 1.95
CHI2_P = 1e-3
# (name, attrs, scipy distribution, torch CDF of x) of the continuous
# _random_* samplers, and (name, attrs, scipy distribution, dtype) of the
# discrete ones
RANDOM_CONTINUOUS = (
    ("_random_uniform", {"low": -1.0, "high": 3.0}, ("uniform", (-1.0, 4.0))),
    ("_random_normal", {"loc": 2.0, "scale": 0.5}, ("norm", (2.0, 0.5))),
    ("_random_gamma", {"alpha": 2.5, "beta": 1.5}, ("gamma", (2.5, 0, 1.5))),
    ("_random_exponential", {"lam": 2.0}, ("expon", (0, 0.5))),
)
RANDOM_DISCRETE = (
    ("_random_poisson", {"lam": 4.0}, ("poisson", (4.0,))),
    ("_random_randint", {"low": -3, "high": 7}, ("randint", (-3, 7))),
    ("_random_negative_binomial", {"k": 3, "p": 0.4}, ("nbinom", (3, 0.4))),
    # nbinom(1 / alpha, 1 / (1 + alpha mu))
    ("_random_generalized_negative_binomial", {"mu": 2.0, "alpha": 0.5},
     ("nbinom", (2.0, 0.5))),
)
# (name, parameter rows, scipy distribution of row i)
SAMPLE_CONTINUOUS = (
    ("_sample_uniform", ([0.0, -2.0], [1.0, 2.0]),
     lambda i, a, b: ("uniform", (a[i], b[i] - a[i]))),
    ("_sample_normal", ([0.0, 5.0], [1.0, 0.25]),
     lambda i, m, s: ("norm", (m[i], s[i]))),
    ("_sample_exponential", ([1.0, 4.0],),
     lambda i, lam: ("expon", (0, 1 / lam[i]))),
    ("_sample_gamma", ([2.0, 8.0], [1.0, 0.5]),
     lambda i, a, b: ("gamma", (a[i], 0, b[i]))),
)
SAMPLE_DISCRETE = (
    ("_sample_poisson", ([3.0, 0.5],), lambda i, lam: ("poisson", (lam[i],))),
    ("_sample_negative_binomial", ([4.0, 2.0], [0.4, 0.7]),
     lambda i, k, p: ("nbinom", (k[i], p[i]))),
    ("_sample_generalized_negative_binomial", ([2.0, 1.0], [0.5, 0.25]),
     lambda i, mu, al: ("nbinom", (1 / al[i], 1 / (1 + al[i] * mu[i])))),
)
MULTINOMIAL_P = ((0.1, 0.2, 0.3, 0.4), (0.7, 0.05, 0.05, 0.2))
SHUFFLE_N = 1 << 20
# (b): VGG-16's classifier shape through Dense, Dropout (row 8), noise and
# GroupNorm(32)
RANDOM_BATCH, RANDOM_UNITS, RANDOM_GROUPS, RANDOM_P = 64, 4096, 32, 0.5
RANDOM_STEPS = 3
# (c): the widths of the models the repo supports. ResNet-50's stage-1
# output; BERT-base's MLM logits (batch 32 x seq 128, vocab 30522); CTC
# over BERT's vocabulary at seq 128, labels up to 64; the other losses
# at BERT-base's hidden states (32, 128, 768)
NORM_SHAPE = (32, 256, 56, 56)
NORM_GROUPS = 32
MLM_SHAPE = (4096, 30522)
CTC_T, CTC_N, CTC_C, CTC_L = 128, 32, 30522, 64
LOSS_SHAPE = (32, 128, 768)
# card against the port's CPU path on the same inputs, elementwise
# |got - ref| <= atol + rtol |ref|, atol scaled by max |ref| for sums over
# many rows (dgamma, dbeta); each from the f32 summation-order error of
# the reductions involved (sqrt(n) ulps over n terms), with 5x margin
WIDTH_TOL = {
    "norm": (1e-4, 1e-4),         # stats over 3136-25088 elements
    "norm_sum": (1e-4, 1e-4),     # x max|ref|: dgamma, dbeta (10^5 terms)
    "softmax": (1e-9, 1e-5),      # probabilities ~1/30522, exp's ulps
    "ce": (0.0, 1e-5),            # a sum of 4096 logs
    "ctc_loss": (0.0, 1e-5),      # ~1300 a sequence, the recursion in f32
    "ctc_grad": (2e-4, 1e-4),     # posteriors from exp of log-space sums
    "loss": (1e-6, 1e-5),         # means over 98304 elements
}
RANDOM_REPS = 2


def random_block(mx, units=None, groups=None, p=RANDOM_P):
    """Dense(units) -> Dropout(p) -> + N(0, 1) noise -> GroupNorm(groups),
    returning (output, the noise, the dropout output): input noise and
    dropout drawn inside one hybridized block (``RANDOM_UNITS`` and
    ``RANDOM_GROUPS`` by default)."""
    nn = mx.gluon.nn
    units = units or RANDOM_UNITS
    groups = groups or RANDOM_GROUPS

    class NoisyBlock(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.dense = nn.Dense(units, in_units=units)
                self.drop = nn.Dropout(p)
                self.norm = nn.GroupNorm(num_groups=groups,
                                         in_channels=units)

        def hybrid_forward(self, F, x):
            d = self.drop(self.dense(x))
            z = F.random_normal(shape=d.shape, ctx=d.context)
            return self.norm(d + z), z, d
    return NoisyBlock(prefix="noisy_")


def _scipy_dist(spec):
    import scipy.stats as st
    name, args = spec
    return getattr(st, name)(*args)


def _torch_cdf(spec, x):
    """The CDF of ``spec`` at the f64 tensor ``x`` (on the card), held
    against scipy's at a thousand of its quantiles first."""
    import math
    import torch
    name, args = spec
    if name == "uniform":
        lo, width = args
        return ((x - lo) / width).clamp(0, 1)
    if name == "norm":
        mu, sig = args
        return 0.5 * (1 + torch.erf((x - mu) / (sig * math.sqrt(2))))
    if name == "expon":
        _, scale = args
        return (1 - torch.exp(-x.clamp_min(0) / scale))
    if name == "gamma":
        a, _, scale = args
        return torch.special.gammainc(torch.full_like(x, a),
                                      x.clamp_min(0) / scale)
    raise SmokeFailure("no CDF for %s" % name)


def _ks(what, x, spec, quiet=False):
    """The KS statistic of the draws ``x`` (a card tensor) against
    scipy's ``spec``, computed on the card in f64, the torch CDF first
    checked against scipy's; raises above the 0.1% critical value."""
    import numpy as np
    import torch
    dist = _scipy_dist(spec)
    q = dist.ppf(np.linspace(0.001, 0.999, 1000))
    mine = _torch_cdf(spec, torch.tensor(q, dtype=torch.float64,
                                         device=DEV)).cpu().numpy()
    cdf_err = float(np.abs(mine - dist.cdf(q)).max())
    if cdf_err > 1e-9:
        raise SmokeFailure("%s: the torch CDF is %.3g from scipy's"
                           % (what, cdf_err))
    xs = torch.sort(x.reshape(-1).double()).values
    n = xs.numel()
    f = _torch_cdf(spec, xs)
    i = torch.arange(1, n + 1, dtype=torch.float64, device=DEV)
    d = float(torch.maximum((i / n - f).max(), (f - (i - 1) / n).max()))
    bound = KS_ALPHA / n ** 0.5
    if not quiet:
        print("[random] %-46s KS %.3g (< %.3g, n %d) %s"
              % (what, d, bound, n, "ok" if d < bound else "FAIL"))
    if d >= bound:
        raise SmokeFailure("%s: KS statistic %.3g >= %.3g" % (what, d, bound))
    return d


def _chi2(what, x, pmf):
    """A chi-square of the integer draws ``x`` against ``pmf`` over the
    outcomes with at least 5 expected draws (the rest pooled); raises
    above the critical value at ``CHI2_P``."""
    import numpy as np
    import scipy.stats as st
    import torch
    v = x.reshape(-1).long()
    lo, hi = int(v.min()), int(v.max())
    counts = torch.bincount(v - lo, minlength=hi - lo + 1).cpu().numpy()
    n = int(v.numel())
    ks = np.arange(lo, hi + 1)
    probs = np.array([pmf(k) for k in ks])
    keep = probs * n >= 5
    obs = list(counts[keep])
    exp = list(probs[keep] * n)
    rest_o, rest_e = n - sum(obs), n - sum(exp)
    if rest_e >= 5:
        obs.append(rest_o)
        exp.append(rest_e)
    exp = np.array(exp) * (sum(obs) / sum(exp))
    stat = float(((np.array(obs) - exp) ** 2 / exp).sum())
    crit = float(st.chi2.isf(CHI2_P, len(obs) - 1))
    print("[random] %-46s chi2 %.4g (< %.4g, %d bins, n %d) %s"
          % (what, stat, crit, len(obs), n, "ok" if stat < crit else "FAIL"))
    if stat >= crit:
        raise SmokeFailure("%s: chi-square %.4g >= %.4g" % (what, stat, crit))


def _random_samplers(seed):
    """(a) Every sampler on the card, by distribution; seed twice equal;
    shuffle a permutation; the normal sampler's scale doubled caught."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import ops as port_ops
    ctx = mx.gpu(0)
    nd = mx.nd
    for name, attrs, spec in RANDOM_CONTINUOUS:
        mx.random.seed(seed)
        x = getattr(nd, name)(shape=(RANDOM_DRAWS,), ctx=ctx, **attrs)
        if x.shape != (RANDOM_DRAWS,) or x.dtype != np.float32:
            raise SmokeFailure("%s: %s %s" % (name, x.shape, x.dtype))
        _ks("%s %s" % (name, attrs), x.tensor(), spec)
    for name, attrs, spec in RANDOM_DISCRETE:
        mx.random.seed(seed)
        x = getattr(nd, name)(shape=(RANDOM_DRAWS,), ctx=ctx, **attrs)
        want = np.int32 if name == "_random_randint" else np.float32
        if x.dtype != want:
            raise SmokeFailure("%s: dtype %s" % (name, x.dtype))
        _chi2("%s %s" % (name, attrs), x.tensor(), _scipy_dist(spec).pmf)
    for name, params, dist in SAMPLE_CONTINUOUS + SAMPLE_DISCRETE:
        mx.random.seed(seed)
        arrays = [nd.array(np.array(p, np.float32), ctx=ctx) for p in params]
        x = getattr(nd, name)(*arrays, shape=(SAMPLE_DRAWS,)).tensor()
        if tuple(x.shape) != (2, SAMPLE_DRAWS):
            raise SmokeFailure("%s: shape %s" % (name, tuple(x.shape)))
        continuous = name in dict((c[0], c) for c in SAMPLE_CONTINUOUS)
        for i in range(2):
            spec = dist(i, *params)
            what = "%s row %d %s" % (name, i, spec)
            if continuous:
                _ks(what, x[i], spec)
            else:
                _chi2(what, x[i], _scipy_dist(spec).pmf)
    mx.random.seed(seed)
    probs = nd.array(np.array(MULTINOMIAL_P, np.float32), ctx=ctx)
    m = mx.random.multinomial(probs, shape=(SAMPLE_DRAWS,))
    if m.dtype != np.int32 or m.shape != (2, SAMPLE_DRAWS):
        raise SmokeFailure("multinomial: %s %s" % (m.shape, m.dtype))
    for i, row in enumerate(MULTINOMIAL_P):
        _chi2("_sample_multinomial row %d %s" % (i, row), m.tensor()[i],
              lambda k, row=row: row[k] if 0 <= k < len(row) else 0.0)
    s = mx.random.shuffle(nd.arange(SHUFFLE_N, ctx=ctx, dtype="int32"))
    st_ = s.tensor()
    perm = bool(torch.equal(torch.sort(st_).values,
                            torch.arange(SHUFFLE_N, device=DEV,
                                         dtype=torch.int32)))
    moved = int((st_ != torch.arange(SHUFFLE_N, device=DEV)).sum())
    print("[random] shuffle of arange(%d): a permutation %s, %d moved"
          % (SHUFFLE_N, perm, moved))
    if not perm or moved < SHUFFLE_N // 2:
        raise SmokeFailure("shuffle is not a random permutation")
    same = []
    for name, attrs, _ in RANDOM_CONTINUOUS + RANDOM_DISCRETE:
        draws = []
        for _ in range(2):
            mx.random.seed(seed + 1)
            draws.append(getattr(nd, name)(shape=(RANDOM_DRAWS,), ctx=ctx,
                                           **attrs).tensor())
        same.append(bool(torch.equal(draws[0], draws[1])))
    print("[random] seed(%d) twice: every _random_* sampler's %d draws "
          "equal bit for bit: %s" % (seed + 1, RANDOM_DRAWS, all(same)))
    if not all(same):
        raise SmokeFailure("a sampler did not repeat its draws after seed()")
    op = port_ops._OPS["_random_normal"]
    real = op.impl

    def planted():
        op.impl = lambda **kw: real(**kw) * 2.0
        try:
            name, attrs, spec = RANDOM_CONTINUOUS[1]
            x = getattr(nd, name)(shape=(RANDOM_DRAWS,), ctx=ctx, **attrs)
            _ks("%s with its scale doubled" % name, x.tensor() - 2.0, spec)
        finally:
            op.impl = real
    _must_fail("the normal sampler with its scale doubled", planted)


def _noisy_run(net, x, steps):
    """``steps`` recorded steps of ``net`` on ``x``: (output, noise,
    dropout output, dx) of each."""
    import torch
    import mxnet_tpu_torch as mx
    out = []
    w = mx.nd.NDArray(torch.linspace(0.5, 1.5, x.size, device=DEV)
                      .reshape(x.shape))
    for _ in range(steps):
        x.attach_grad()
        with mx.autograd.record():
            y, z, d = net(x)
            loss = (y * w).sum()
        loss.backward()
        out.append([a.tensor().detach().clone()
                    for a in (y, z, d, x.grad)])
    torch.cuda.synchronize()
    return out


def _random_block(seed, card_line):
    """(b) The block eager and hybridized: new draws on every call and
    replay, compiled bit for bit with eager after seed(s); the dropout
    launches of each mode (row 8's ``launches_per_random_block``)."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    from mxnet_tpu_torch.ops import cuda_build
    net = random_block(mx)
    mx.random.seed(seed)
    net.initialize(mx.init.Xavier())
    x = mx.nd.array(__import__("numpy").random.RandomState(seed + 17)
                    .randn(RANDOM_BATCH, RANDOM_UNITS).astype("float32"),
                    ctx=mx.gpu(0))
    net.hybridize(static_alloc=True, static_shape=True)
    mx.random.seed(seed + 5)
    cuda_build.reset_launch_counts()
    with cached_op.eager():
        eager = _noisy_run(net, x, RANDOM_STEPS)
    eager_launches = cuda_build.launch_counts().get("dropout", 0)
    mx.random.seed(seed + 5)
    cached_op.reset_replay_counts()
    by_graph = {}
    with _capture_launches(by_graph) as captured, \
            _replayed_launches(by_graph) as replayed:
        compiled = _noisy_run(net, x, RANDOM_STEPS)
    replays = cached_op.replay_counts()
    names = ("output", "noise", "dropout output", "dx")
    for i, (e, c) in enumerate(zip(eager, compiled)):
        for n, a, b in zip(names, e, c):
            if not torch.equal(a, b):
                raise SmokeFailure(
                    "random block step %d: the compiled %s differs from the "
                    "eager one (max %.3g)" % (i, n, float((a - b).abs()
                                                          .max())))
    for i in range(1, RANDOM_STEPS):
        for n, j in (("noise", 1), ("dropout mask", 2)):
            a, b = compiled[i - 1][j], compiled[i][j]
            if n == "dropout mask":
                a, b = a != 0, b != 0
            if torch.equal(a, b):
                raise SmokeFailure("random block: steps %d and %d drew the "
                                   "same %s" % (i - 1, i, n))
    keep = float((compiled[-1][2] != 0).float().mean())
    z = compiled[-1][1]
    print("[random] block Dense(%d) -> Dropout(%g) -> + N(0, 1) -> "
          "GroupNorm(%d) on (%d, %d) f32, %d steps: compiled equals eager "
          "bit for bit after seed(); new noise and masks each step (keep "
          "%.4f, noise mean %.4f std %.4f); graph replays %s; dropout "
          "launches: eager %d (%d a step), recorded into the graphs %d, "
          "replayed %d; %s" % (
              RANDOM_UNITS, RANDOM_P, RANDOM_GROUPS, RANDOM_BATCH,
              RANDOM_UNITS, RANDOM_STEPS, keep, float(z.mean()),
              float(z.std()), replays, eager_launches,
              eager_launches // RANDOM_STEPS, captured.get("dropout", 0),
              replayed.get("dropout", 0), card_line))
    if not eager_launches or not captured.get("dropout", 0) \
            or not replays.get("forward"):
        raise SmokeFailure("random block: the dropout kernel was not "
                           "launched in both modes, or no graph replayed")
    if abs(keep - (1 - RANDOM_P)) > 0.01:
        raise SmokeFailure("random block: keep rate %.4f" % keep)
    _free_graphs(net)
    return {"dropout": eager_launches // RANDOM_STEPS}


def _graph_generator_cost():
    """Host time of one replay of a one-kernel graph with the context's
    generator registered and without (what ``cached_op._capture`` adds
    to every replay)."""
    import torch
    import mxnet_tpu_torch as mx
    x = torch.zeros(1, device=DEV)
    out = {}
    for reg in (False, True):
        g = torch.cuda.CUDAGraph()
        if reg:
            g.register_generator_state(mx.random.generator(mx.gpu(0)))
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            x.add_(1)
        torch.cuda.current_stream().wait_stream(s)
        with torch.cuda.graph(g):
            x.add_(1)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                g.replay()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[reg] = statistics.median(times)
    print("[random] one replay of a one-kernel graph: %.2f us with the "
          "generator registered, %.2f us without (host clock, 1000 replays, "
          "median of 5)" % (out[True], out[False]))


def _width_check(what, got, ref, tol, scale_by_max=False):
    """Card tensor ``got`` against CPU tensor ``ref``: |got - ref| <= atol
    (x max |ref| with ``scale_by_max``) + rtol |ref|."""
    import torch
    atol, rtol = tol
    g, r = got.detach().float().cpu(), ref.detach().float()
    if g.shape != r.shape:
        raise SmokeFailure("%s: shape %s != %s" % (what, tuple(g.shape),
                                                   tuple(r.shape)))
    if not torch.isfinite(g).all():
        raise SmokeFailure("%s: non-finite values on the card" % what)
    if scale_by_max:
        atol = atol * float(r.abs().max())
    err = (g - r).abs()
    bad = int((err > atol + rtol * r.abs()).sum())
    print("[random] %-46s max_abs_err=%.3g tol=%.3g+%g*|ref| %s"
          % (what, float(err.max()), atol, rtol, "FAIL" if bad else "ok"))
    if bad:
        raise SmokeFailure("%s: %d elements beyond tolerance" % (what, bad))
    return float(err.max())


def _record_fwd_bwd(fn, arrays, head=None):
    """fn(*arrays) under record, backward with ``head`` (ones when None);
    returns (output tensor, the gradients of the arrays)."""
    import mxnet_tpu_torch as mx
    for a in arrays:
        a.attach_grad()
    with mx.autograd.record():
        y = fn(*arrays)
    y.backward(head)
    return y.tensor(), [a.grad.tensor() for a in arrays]


def _on(ctx, *arrays):
    import mxnet_tpu_torch as mx
    return [mx.nd.array(a, ctx=ctx) for a in arrays]


def _random_widths(seed, card_line):
    """(c) the new ops at full width, card against the port's CPU path;
    (d) their device times."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    import mxnet_tpu_torch as mx
    rs = np.random.RandomState(seed + 23)
    gpu, cpu = mx.gpu(0), mx.cpu()
    nd = mx.nd
    times = {}

    def both(what, fn, inputs, tol, grads_tol=None, head=None,
             sum_grads=()):
        outs = {}
        for ctx in (cpu, gpu):
            arrays = _on(ctx, *inputs)
            h = None if head is None else nd.array(head, ctx=ctx)
            outs[ctx] = _record_fwd_bwd(fn, arrays, h)
        _width_check(what, outs[gpu][0], outs[cpu][0], tol)
        for i, (g, r) in enumerate(zip(outs[gpu][1], outs[cpu][1])):
            if i in sum_grads:
                _width_check("%s d[%d]" % (what, i), g, r,
                             WIDTH_TOL["norm_sum"], scale_by_max=True)
            else:
                _width_check("%s d[%d]" % (what, i), g, r, grads_tol or tol)
        arrays = _on(gpu, *inputs)
        h = None if head is None else nd.array(head, ctx=gpu)
        times[what] = _gpu_ms(lambda: _record_fwd_bwd(fn, arrays, h),
                              RANDOM_REPS, trials=3)
        del outs, arrays
        torch.cuda.empty_cache()

    x = rs.randn(*NORM_SHAPE).astype(np.float32)
    g = (rs.rand(NORM_SHAPE[1]) + 0.5).astype(np.float32)
    b = rs.randn(NORM_SHAPE[1]).astype(np.float32)
    head = rs.randn(*NORM_SHAPE).astype(np.float32)
    both("GroupNorm(%d) %s" % (NORM_GROUPS, NORM_SHAPE),
         lambda a, c, d: nd.GroupNorm(a, c, d, num_groups=NORM_GROUPS),
         (x, g, b), WIDTH_TOL["norm"], head=head, sum_grads=(1, 2))
    both("InstanceNorm %s" % (NORM_SHAPE,),
         lambda a, c, d: nd.InstanceNorm(a, c, d), (x, g, b),
         WIDTH_TOL["norm"], head=head, sum_grads=(1, 2))
    del x, head
    logits = (rs.randn(*MLM_SHAPE) * 2).astype(np.float32)
    label = rs.randint(0, MLM_SHAPE[1], MLM_SHAPE[0]).astype(np.float32)
    label[::7] = -1
    both("SoftmaxOutput %s (ignore, valid)" % (MLM_SHAPE,),
         lambda a, lab: nd.SoftmaxOutput(a, lab, use_ignore=True,
                                         normalization="valid"),
         (logits, label), WIDTH_TOL["softmax"])
    label = np.abs(label)
    both("softmax_cross_entropy %s" % (MLM_SHAPE,),
         lambda a, lab: nd.softmax_cross_entropy(a, lab), (logits, label),
         WIDTH_TOL["ce"], grads_tol=WIDTH_TOL["softmax"])
    del logits
    acts = rs.randn(CTC_T, CTC_N, CTC_C).astype(np.float32)
    llen = rs.randint(1, CTC_L + 1, CTC_N)
    dlen = rs.randint(CTC_T - 28, CTC_T + 1, CTC_N).astype(np.float32)
    for blank in ("first", "last"):
        lab = rs.randint(1, CTC_C, (CTC_N, CTC_L)).astype(np.float32)
        if blank == "last":
            lab -= 1
        pad = 0.0 if blank == "first" else -1.0
        lab[np.arange(CTC_L)[None, :] >= llen[:, None]] = pad
        fn = (lambda blank: lambda a, d, lab: nd.CTCLoss(
            a, lab, d, use_data_lengths=True, blank_label=blank))(blank)
        what = "CTCLoss (T %d, N %d, C %d) blank %s" % (CTC_T, CTC_N, CTC_C,
                                                        blank)
        both(what, fn, (acts, dlen, lab), WIDTH_TOL["ctc_loss"],
             grads_tol=WIDTH_TOL["ctc_grad"])
        if blank == "first":
            # torch's own CTC (cuDNN or its native kernel) on the same
            # sequences, for the value and the library time
            a = torch.tensor(acts, device=DEV)
            lp = torch.log_softmax(a, -1)
            tl = torch.tensor(lab, device=DEV).long()
            il = torch.tensor(dlen, device=DEV).long()
            ll = torch.tensor(llen, device=DEV).long()
            mine = nd.CTCLoss(nd.array(acts, ctx=gpu), nd.array(lab, ctx=gpu),
                              nd.array(dlen, ctx=gpu), use_data_lengths=True
                              ).tensor()
            lib = F.ctc_loss(lp, tl, il, ll, blank=0, reduction="none")
            rel = float(((mine - lib).abs() / lib.abs()).max())
            a.requires_grad_(True)

            def lib_step():
                F.ctc_loss(torch.log_softmax(a, -1), tl, il, ll, blank=0,
                           reduction="sum").backward()
            times["torch ctc_loss (library)"] = _gpu_ms(lib_step,
                                                        RANDOM_REPS,
                                                        trials=3)
            print("[random] CTCLoss against torch.nn.functional.ctc_loss "
                  "on the card: max relative difference %.3g" % rel)
            if rel > 1e-4:
                raise SmokeFailure("CTCLoss is %.3g from torch's ctc_loss"
                                   % rel)
            del a, lp
    del acts
    torch.cuda.empty_cache()
    pred = rs.randn(*LOSS_SHAPE).astype(np.float32)
    real = rs.randn(*LOSS_SHAPE).astype(np.float32)
    sign = np.where(rs.rand(*LOSS_SHAPE) > 0.5, 1.0, -1.0).astype(np.float32)
    bits = (sign > 0).astype(np.float32)
    e = np.exp(real - real.max(-1, keepdims=True))
    probs = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    loss = mx.gluon.loss
    flat = (LOSS_SHAPE[0] * LOSS_SHAPE[1], LOSS_SHAPE[2])
    cos_label = np.where(rs.rand(flat[0]) > 0.5, 1.0, -1.0).astype(
        np.float32)
    for name, block, inputs in (
            ("L1Loss", loss.L1Loss(), (pred, real)),
            ("SigmoidBCELoss", loss.SigmoidBCELoss(), (pred, bits)),
            ("KLDivLoss", loss.KLDivLoss(from_logits=False),
             (pred, probs)),
            ("HuberLoss", loss.HuberLoss(rho=0.5), (pred, real)),
            ("HingeLoss", loss.HingeLoss(), (pred, sign)),
            ("SquaredHingeLoss", loss.SquaredHingeLoss(), (pred, sign)),
            ("LogisticLoss", loss.LogisticLoss(), (pred, sign)),
            ("CosineEmbeddingLoss", loss.CosineEmbeddingLoss(margin=0.1),
             (pred.reshape(flat), real.reshape(flat), cos_label))):
        both("%s %s" % (name, tuple(inputs[0].shape)),
             (lambda blk: lambda *a: blk(*a))(block), inputs,
             WIDTH_TOL["loss"])
    for what, ms in times.items():
        print("[times] %-46s %.3f ms forward+backward; %s"
              % (what, ms, card_line))
    return times


def phase_random(seed, card_line):
    """17. The creation and random ops, random ops in a captured graph
    with the dropout kernel, the new losses and norms at full width.
    Returns {"dropout": launches of one eager step of the random
    block}."""
    print("[random] %s" % card_line)
    took = []
    t0 = time.perf_counter()
    _random_samplers(seed)
    took.append(time.perf_counter())
    counts = _random_block(seed, card_line)
    _graph_generator_cost()
    took.append(time.perf_counter())
    _random_widths(seed, card_line)
    took.append(time.perf_counter())
    print("[random] phase 17 took %.1f s: samplers %.1f, the random block "
          "%.1f, the widths (CPU path included) %.1f"
          % (took[-1] - t0, took[0] - t0, took[1] - took[0],
             took[2] - took[1]))
    return counts


# -- phase 18: the rest of the op registry ------------------------------------
# Each group at the published widths of a public model that uses it, f32,
# card against the port's CPU path on the same inputs. SSD-300 (GluonCV's
# ssd_300_vgg16_atrous_voc): six maps of a 300 px image, anchor sizes
# 30-315 px, the ratios and steps of that config, 8732 anchors, 21
# classes, NMS 0.45 over the top 400
SSD_SIDE = 300
SSD_MAPS = (38, 19, 10, 5, 3, 1)
SSD_SIZES = (30, 60, 111, 162, 213, 264, 315)
SSD_RATIOS = ((1, 2, 0.5),) + ((1, 2, 0.5, 3, 1 / 3),) * 3 + \
    ((1, 2, 0.5),) * 2
SSD_STEPS = (8, 16, 32, 64, 100, 300)
SSD_ANCHORS = 8732
SSD_BATCH, SSD_CLASSES, SSD_GT = 32, 21, 40
SSD_NMS = {"nms_threshold": 0.45, "nms_topk": 400, "threshold": 0.01}
# Faster R-CNN (faster_rcnn_resnet50_v1b_voc) and R-FCN on a 600 x 1000
# image: the stride-16 map is 38 x 63
RCNN_IMAGE, RCNN_MAP, RCNN_SCALE = (600, 1000), (38, 63), 1.0 / 16
ROI_ALIGN_SHAPE, ROI_ALIGN_ROIS, ROI_ALIGN_POOL = (2, 1024) + RCNN_MAP, \
    256, (14, 14)
ROI_POOL_SHAPE, ROI_POOL_ROIS, ROI_POOL_POOL = (2, 512) + RCNN_MAP, 256, \
    (7, 7)
PSROI_SHAPE, PSROI_ROIS, PSROI_DIM, PSROI_POOL = (1, 1029) + RCNN_MAP, \
    300, 21, 7
# Deformable ConvNets (R-FCN ResNet-101's res5 3 x 3): 512 -> 512,
# dilation 2, 4 deformable groups (72 offset and 36 mask channels)
DEFORM_SHAPE = (2, 512) + RCNN_MAP
DEFORM = {"kernel": (3, 3), "num_filter": 512, "dilate": (2, 2),
          "pad": (2, 2), "num_deformable_group": 4}
# FlowNetC's correlation: displacement 20, stride2 2 (441 channels)
CORR_SHAPE = (8, 256, 48, 64)
CORR = {"kernel_size": 1, "max_displacement": 20, "stride1": 1,
        "stride2": 2, "pad_size": 20}
# the Transformer base (GluonNLP transformer_en_de_512)
ENCDEC_L, ENCDEC_N, ENCDEC_UNITS, ENCDEC_HEADS = 128, 32, 512, 8
# linalg: SPD batches and square products, against a float64 twin
LINALG_SPD, LINALG_GEMM = (256, 64, 64), (32, 512, 512)
# the rest at the widths of the supported models: ResNet-50's stage-1
# output (and its 3 x 3 conv's 64-channel input), BERT-base's hidden
# states, AlexNet's conv1 output, an FCN head upsampled x32
TAIL_RESNET, TAIL_RESNET_3X3, TAIL_BERT = (32, 256, 56, 56), \
    (32, 64, 56, 56), (32, 128, 768)
LRN_SHAPE, LRN_NSIZE = (64, 96, 55, 55), 5
FCN_HEAD, FCN_SCALE = (32, 21, 16, 16), 32
# card against CPU (linalg: against the float64 twin), the largest
# max|got - ref| / max|ref| of each group's outputs and gradients: twice
# the largest reading of ops_tail_readings(range(5), ...) on one H100
# (700 W). The readings: ssd_prior 0 at every seed, ssd_target
# 2.91e-7-4.04e-7, ssd_detection 6.27e-9, roi_align 2.75e-7-4.81e-7,
# roi_pooling 1.03e-7-1.63e-7, psroi_pooling 3.17e-8-6.42e-8, deformable
# 2.53e-6-3.46e-6, correlation 1.85e-7-2.19e-7, encdec 1.48e-6-2.08e-6,
# linalg 2.20e-5-2.39e-5 (syevd's reconstruction), rest_resnet
# 5.73e-7-8.48e-7, rest_bert 6.36e-7-7.15e-7, lrn 1.34e-7, upsampling
# 4.23e-7-6.40e-7. The planted faults read at least 2.0e-4 (the moments
# scaled by 1.0001), 2.23e-3 (the anchor sizes 0.1% off), 0.095 (NMS past
# the top 400) and 0.36-1.40 for the others.
OPS_TAIL_LIMIT = {
    "ssd_prior": 0.0, "ssd_target": 8.08e-7, "ssd_detection": 1.26e-8,
    "roi_align": 9.62e-7, "roi_pooling": 3.27e-7, "psroi_pooling": 1.29e-7,
    "deformable": 6.92e-6, "correlation": 4.39e-7, "encdec": 4.16e-6,
    "linalg": 4.79e-5, "rest_resnet": 1.70e-6, "rest_bert": 1.44e-6,
    "lrn": 2.68e-7, "upsampling": 1.28e-6}


def _call_ms(fn, reps):
    """Median device time of one synchronised ``fn()`` over ``reps``
    calls, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def _tail_reading(got, ref):
    """max |got - ref| / max |ref| over the elements finite in ``ref``;
    inf where the shapes or the non-finite elements differ. Computed in
    float64 on ``got``'s device (the reference is copied there)."""
    import torch
    g = got.detach().double()
    r = ref.detach().to(g.device, torch.float64)
    if g.shape != r.shape:
        return float("inf")
    fin = torch.isfinite(r)
    if not torch.equal(fin, torch.isfinite(g)) or \
            not torch.equal(g[~fin].nan_to_num(), r[~fin].nan_to_num()):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    scale = float(r[fin].abs().max()) or 1.0
    return float((g[fin] - r[fin]).abs().max()) / scale


def _tail_run(fn, arrays, grad, head):
    """fn(*arrays), under record with a backward when ``grad`` lists
    inputs (``head(k, output)`` the head gradient of output k); returns
    (output tensors, their gradients)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    for i in grad:
        arrays[i].attach_grad()
    with mx.autograd.record() if grad else contextlib.nullcontext():
        y = fn(*arrays)
        ys = list(y) if isinstance(y, (list, tuple)) else [y]
        if grad:
            total = None
            for k, o in enumerate(ys):
                if not np.issubdtype(np.dtype(o.dtype), np.floating):
                    continue
                term = (o * head(k, o)).sum()
                total = term if total is None else total + term
    if grad:
        total.backward()
    return [o.tensor() for o in ys], [arrays[i].grad.tensor() for i in grad]


def _f64_run(fn, arrays, grad, head):
    """A linalg check's reference: fn on float64 twins of the arrays."""
    import mxnet_tpu_torch as mx
    twins = [mx.nd.NDArray(a.tensor().double()) for a in arrays]
    return _tail_run(fn, twins, grad, head)


class _Tail:
    """Phase 18's checks: each call on the port's CPU path, then on the
    card; the readings by group, each call's device time and the peak
    memory of the heavy ones."""

    def __init__(self, seed, reps, card_line, faults):
        self.seed, self.reps, self.card_line = seed, reps, card_line
        self.readings = collections.defaultdict(float)
        self.times, self.peaks = {}, {}
        self.faults = faults
        self.fault_readings = {}

    def check(self, group, what, fn, inputs, grad=(), bad=None, peak=False,
              ref=_tail_run):
        """Hold fn on the card against ``ref`` (fn on the port's CPU path
        by default) on the same inputs and heads; ``bad``, the group's
        planted fault, is a faulty twin of fn run on the card when faults
        are checked. Returns the reference's outputs."""
        import numpy as np
        import torch
        import mxnet_tpu_torch as mx
        heads = {}

        def hs(k, o):
            # head k, uniform in [0.5, 1.5) from the seed, made once a
            # context (not inside the timed calls)
            key = (k, tuple(o.shape), str(o.context))
            if key not in heads:
                h = np.random.RandomState(self.seed + 181 + k).uniform(
                    0.5, 1.5, o.shape).astype(np.float32)
                heads[key] = mx.nd.array(h, ctx=o.context)
            return heads[key]
        t0 = time.perf_counter()
        cpu_out, cpu_grad = ref(
            fn, [mx.nd.array(a, ctx=mx.cpu(), dtype=a.dtype)
                 for a in inputs], grad, hs)
        cpu_s = time.perf_counter() - t0
        gpu = mx.gpu(0)

        def card(f=fn):
            return _tail_run(f, [mx.nd.array(a, ctx=gpu, dtype=a.dtype)
                                 for a in inputs], grad, hs)

        def reading(out, g):
            return max([_tail_reading(a, b) for a, b in zip(out, cpu_out)]
                       + [_tail_reading(a, b) for a, b in zip(g, cpu_grad)])
        r = reading(*card())
        self.readings[group] = max(self.readings[group], r)
        arrays = [mx.nd.array(a, ctx=gpu, dtype=a.dtype) for a in inputs]
        self.times[what] = _call_ms(
            lambda: _tail_run(fn, arrays, grad, hs), self.reps)
        if peak:
            self.peaks[what] = _peak_mb(
                lambda: _tail_run(fn, arrays, grad, hs))
        limit = OPS_TAIL_LIMIT[group]
        print("[ops_tail] %-58s %-13s reading %.3g (limit %s) %.3f ms%s; "
              "CPU path %.1f s" % (what, group, r, limit, self.times[what],
                                   " peak %.1f MB" % self.peaks[what]
                                   if peak else "", cpu_s))
        if limit is not None and r > limit:
            raise SmokeFailure("ops_tail %s: %s reads %.3g beyond its limit "
                               "%g" % (group, what, r, limit))
        if self.faults and bad is not None:
            self.fault_readings[group] = (what, reading(*card(bad)))
        del arrays
        heads.clear()
        torch.cuda.empty_cache()
        return cpu_out

    def controls(self):
        """Each group's planted fault must read beyond its limit."""
        missed = []
        for group, (what, fr) in sorted(self.fault_readings.items()):
            limit = OPS_TAIL_LIMIT[group]
            caught = limit is not None and fr > limit
            print("[control] %-13s planted in %s: reading %.3g (limit %s) %s"
                  % (group, what, fr, limit, "caught" if caught else
                     "MISSED" if limit is not None else "no limit set"))
            if limit is not None and not caught:
                missed.append(group)
        unplanted = [g for g in OPS_TAIL_LIMIT
                     if g not in self.fault_readings]
        if unplanted:
            raise SmokeFailure("ops_tail: no planted fault ran for %s"
                               % unplanted)
        if missed:
            raise SmokeFailure("ops_tail: planted faults passed in %s"
                               % missed)


def ssd_anchors(mx, ctx):
    """SSD-300's 8732 anchors from MultiBoxPrior over its six maps, as
    (1, N, 4), and the per-map calls."""
    outs = []
    for k, m in enumerate(SSD_MAPS):
        s0, s1 = SSD_SIZES[k] / SSD_SIDE, SSD_SIZES[k + 1] / SSD_SIDE
        step = SSD_STEPS[k] / SSD_SIDE
        outs.append(mx.nd._contrib_MultiBoxPrior(
            mx.nd.zeros((1, 1, m, m), ctx=ctx),
            sizes=(s0, (s0 * s1) ** 0.5), ratios=SSD_RATIOS[k],
            steps=(step, step), offsets=(0.5, 0.5)))
    return mx.nd.concat(*outs, dim=1)


def _ssd_labels(rs):
    """(B, SSD_GT, 5) labels: 1-40 boxes an image (class 0-19, corners in
    [0, 1]), the rest -1."""
    import numpy as np
    lab = np.full((SSD_BATCH, SSD_GT, 5), -1.0, np.float32)
    for b in range(SSD_BATCH):
        n = rs.randint(1, SSD_GT + 1)
        xy = rs.uniform(0, 0.8, (n, 2))
        wh = rs.uniform(0.05, 0.5, (n, 2))
        lab[b, :n, 0] = rs.randint(0, SSD_CLASSES - 1, n)
        lab[b, :n, 1:3] = xy
        lab[b, :n, 3:5] = np.minimum(xy + wh, 1.0)
    return lab


def _rcnn_rois(rs, n_img, R):
    """R proposals (batch, x1, y1, x2, y2) on a 600 x 1000 image, 16 to
    400 px a side."""
    import numpy as np
    H, W = RCNN_IMAGE
    wh = rs.uniform(16, 400, (R, 2))
    x1 = rs.uniform(0, W - wh[:, 0])
    y1 = rs.uniform(0, H - wh[:, 1])
    return np.stack([rs.randint(0, n_img, R), x1, y1, x1 + wh[:, 0],
                     y1 + wh[:, 1]], 1).astype(np.float32)


def roi_pool_6d(data, rois, pooled, scale):
    """The reference's ROIPooling formulation (one (R, C, PH, PW, H, W)
    masked tensor, a copy of the map per ROI) transcribed in torch: the
    memory it needs, against the port's separable form."""
    import torch
    PH, PW = pooled
    N, C, H, W = data.shape
    b = rois[:, 0].long()
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale) for i in (1, 2, 3, 4))
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    ph = torch.arange(PH, dtype=data.dtype, device=data.device)
    pw = torch.arange(PW, dtype=data.dtype, device=data.device)
    # IEEE division, as the reference's (CUDA's division by a host
    # number multiplies by its reciprocal)
    ph_, pw_ = (torch.full((), float(v), device=data.device)
                for v in (PH, PW))
    hs = torch.floor(y1[:, None] + ph[None] * rh[:, None] / ph_)
    he = torch.ceil(y1[:, None] + (ph[None] + 1) * rh[:, None] / ph_)
    ws = torch.floor(x1[:, None] + pw[None] * rw[:, None] / pw_)
    we = torch.ceil(x1[:, None] + (pw[None] + 1) * rw[:, None] / pw_)
    hh = torch.arange(H, dtype=data.dtype, device=data.device)
    ww = torch.arange(W, dtype=data.dtype, device=data.device)
    hm = (hh[None, None] >= hs[..., None]) & (hh[None, None] < he[..., None])
    wm = (ww[None, None] >= ws[..., None]) & (ww[None, None] < we[..., None])
    feat = data[b]
    m = hm[:, None, :, None, :, None] & wm[:, None, None, :, None, :]
    vals = torch.where(m, feat[:, :, None, None], torch.finfo(
        torch.float32).min)
    out = vals.amax(dim=(4, 5))
    return torch.where(m.any(dim=(4, 5)), out, 0.0)


def _tail_ssd(t, rs):
    """SSD-300's MultiBox and box ops."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from unittest import mock
    from mxnet_tpu_torch.ops import vision_ops as vo
    nd = mx.nd
    anchors = ssd_anchors(mx, mx.gpu(0))
    if anchors.shape != (1, SSD_ANCHORS, 4):
        raise SmokeFailure("SSD-300's MultiBoxPrior gave %s anchors, not %d"
                           % (anchors.shape, SSD_ANCHORS))
    real_f32 = vo._f32

    def off_f32(x):
        return real_f32(x * 1.001)

    def prior(_):
        return ssd_anchors(mx, _.context)

    def prior_bad(_):
        with mock.patch.object(vo, "_f32", off_f32):
            return ssd_anchors(mx, _.context)
    z = np.zeros((1,), np.float32)
    t.check("ssd_prior", "MultiBoxPrior x6 maps -> (1, %d, 4)" % SSD_ANCHORS,
            prior, [z], bad=prior_bad)
    anc = anchors.asnumpy()
    labels = _ssd_labels(rs)
    logits = rs.normal(0, 2, (SSD_BATCH, SSD_CLASSES, SSD_ANCHORS))
    cls_prob = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
                ).astype(np.float32)
    del logits
    loc = rs.normal(0, 0.5, (SSD_BATCH, SSD_ANCHORS * 4)).astype(np.float32)
    def target(a, lab, cp):
        return nd._contrib_MultiBoxTarget(a, lab, cp)

    t.check("ssd_target", "MultiBoxTarget (32, 8732) anchors, (32, 40, 5) "
            "labels", target, [anc, labels, cls_prob])
    gt = labels[..., 1:5].copy()
    gt[labels[..., 0] < 0] = 0.0
    anc_b = np.broadcast_to(anc, (SSD_BATCH, SSD_ANCHORS, 4)).copy()
    t.check("ssd_target", "box_iou (32, 8732, 4) x (32, 40, 4)",
            lambda a, b: nd._contrib_box_iou(a, b), [anc_b, gt], grad=(0, 1))
    iou = vo._iou_matrix(*(mx.nd.array(x, ctx=mx.cpu()).tensor()
                           for x in (anc_b, gt))).numpy()
    iou[np.broadcast_to((labels[:, None, :, 0] < 0),
                        iou.shape)] = -1.0
    rows = t.check("ssd_target", "bipartite_matching (32, 8732, 40)",
                   lambda s: nd._contrib_bipartite_matching(
                       s, threshold=1e-12), [iou])
    matches = rows[0].numpy()
    samples = (matches >= 0).astype(np.float32)
    def encode_bad(s, m, a, r):
        # planted: the (w, h) variances applied to (x, y)
        return nd._contrib_box_encode(
            s, m, a, r, mx.nd.zeros((4,), ctx=a.context),
            mx.nd.array([0.2, 0.2, 0.1, 0.1], ctx=a.context))
    t.check("ssd_target", "box_encode (32, 8732) matches",
            lambda s, m, a, r: nd._contrib_box_encode(s, m, a, r),
            [samples, matches, anc_b, gt], grad=(2, 3), bad=encode_bad)
    preds = rs.normal(0, 0.5, (SSD_BATCH, SSD_ANCHORS, 4)).astype(np.float32)
    t.check("ssd_target", "box_decode (32, 8732, 4)",
            lambda p, a: nd._contrib_box_decode(p, a, std0=0.1, std1=0.1,
                                                std2=0.2, std3=0.2),
            [preds, anc], grad=(0, 1))

    def detect(cp, lp, a):
        return nd._contrib_MultiBoxDetection(cp, lp, a, **SSD_NMS)

    def detect_bad(*a):
        # planted: NMS over every candidate, past the top 400
        with mock.patch.object(vo, "nms_bound", lambda n, topk: n):
            return detect(*a)
    t.check("ssd_detection", "MultiBoxDetection (32, 21, 8732) top 400",
            detect, [cls_prob, loc, anc], bad=detect_bad, peak=True)
    det = np.concatenate([rs.randint(0, 20, (SSD_BATCH, SSD_ANCHORS, 1)),
                          rs.uniform(0, 1, (SSD_BATCH, SSD_ANCHORS, 1)),
                          anc_b], -1).astype(np.float32)
    for B, topk in ((SSD_BATCH, 400), (2, -1)):
        t.check("ssd_detection", "box_nms (%d, 8732, 6) topk %d" % (B, topk),
                lambda d, k=topk: nd._contrib_box_nms(
                    d, overlap_thresh=0.45, topk=k, id_index=0,
                    valid_thresh=0.01), [det[:B]], peak=True)
    return cls_prob, loc, anc


def _tail_rcnn(t, rs):
    """Faster R-CNN's ROIAlign and ROIPooling, R-FCN's PSROIPooling,
    Deformable ConvNets' two convolutions."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from unittest import mock
    from mxnet_tpu_torch.ops import vision_ops as vo
    nd = mx.nd
    data = rs.normal(0, 1, ROI_ALIGN_SHAPE).astype(np.float32)
    rois = _rcnn_rois(rs, ROI_ALIGN_SHAPE[0], ROI_ALIGN_ROIS)
    real_gather = vo._bilinear_gather

    def three_taps(d, xs, ys, batch=None):
        # planted: the samples a quarter pixel off
        return real_gather(d, xs + 0.25, ys, batch)

    def align(d, r):
        return nd._contrib_ROIAlign(d, r, pooled_size=ROI_ALIGN_POOL,
                                    spatial_scale=RCNN_SCALE,
                                    sample_ratio=2)

    def align_bad(*a):
        with mock.patch.object(vo, "_bilinear_gather", three_taps):
            return align(*a)
    t.check("roi_align", "ROIAlign %s x %d ROIs -> 14 x 14"
            % (ROI_ALIGN_SHAPE, ROI_ALIGN_ROIS), align, [data, rois],
            grad=(0,), bad=align_bad, peak=True)
    data = rs.normal(0, 1, ROI_POOL_SHAPE).astype(np.float32)
    rois = _rcnn_rois(rs, ROI_POOL_SHAPE[0], ROI_POOL_ROIS)
    real_span = vo._span

    def short_span(lo, hi, n):
        a, length = real_span(lo, hi, n)
        return a, length - 1

    def pool(d, r):
        return nd.ROIPooling(d, r, pooled_size=ROI_POOL_POOL,
                             spatial_scale=RCNN_SCALE)

    def pool_bad(*a):
        with mock.patch.object(vo, "_span", short_span):
            return pool(*a)
    t.check("roi_pooling", "ROIPooling %s x %d ROIs -> 7 x 7"
            % (ROI_POOL_SHAPE, ROI_POOL_ROIS), pool, [data, rois],
            grad=(0,), bad=pool_bad, peak=True)
    # the reference's 6-D formulation: its peak at 8 ROIs, which scales
    # with the ROI count, against the separable form at all 256
    d8 = torch.tensor(data, device=DEV)
    r8 = torch.tensor(rois[:8], device=DEV)
    six = _peak_mb(lambda: roi_pool_6d(d8, r8, ROI_POOL_POOL, RCNN_SCALE))
    same = torch.equal(roi_pool_6d(d8, r8, ROI_POOL_POOL, RCNN_SCALE),
                       vo.roi_pooling(d8, r8, pooled_size=ROI_POOL_POOL,
                                      spatial_scale=RCNN_SCALE))
    R, (C, H, W) = ROI_POOL_ROIS, ROI_POOL_SHAPE[1:]
    elems = R * C * ROI_POOL_POOL[0] * ROI_POOL_POOL[1] * H * W
    print("[ops_tail] ROIPooling memory: the reference's (R, C, 7, 7, H, W) "
          "form peaks at %.1f MB for 8 ROIs (bit for bit with the separable "
          "form: %s), so %.0f MB for %d (its masked tensor alone %.1f GB "
          "f32 and %.1f GB of mask); the separable form %.1f MB for %d "
          "forward and backward; %s"
          % (six, same, six * R / 8, R, elems * 4 / 1e9, elems / 1e9,
             t.peaks[[k for k in t.peaks if k.startswith("ROIPooling")][0]],
             R, t.card_line))
    if not same:
        raise SmokeFailure("ROIPooling's separable form differs from the "
                           "6-D form on the card")
    del d8, r8
    data = rs.normal(0, 1, PSROI_SHAPE).astype(np.float32)
    rois = _rcnn_rois(rs, 1, PSROI_ROIS)
    real_bins = vo._quantized_bins

    def tall_bins(*a):
        hs, he, ws, we = real_bins(*a)
        return hs, he + 1, ws, we

    def psroi(d, r):
        return nd._contrib_PSROIPooling(d, r, spatial_scale=RCNN_SCALE,
                                        output_dim=PSROI_DIM,
                                        pooled_size=PSROI_POOL)

    def psroi_bad(*a):
        with mock.patch.object(vo, "_quantized_bins", tall_bins):
            return psroi(*a)
    t.check("psroi_pooling", "PSROIPooling %s x %d ROIs, 21 x 7 x 7"
            % (PSROI_SHAPE, PSROI_ROIS), psroi, [data, rois], grad=(0,),
            bad=psroi_bad, peak=True)
    N, C, H, W = DEFORM_SHAPE
    dg = DEFORM["num_deformable_group"]
    x = rs.normal(0, 1, DEFORM_SHAPE).astype(np.float32)
    off = rs.normal(0, 1, (N, dg * 18, H, W)).astype(np.float32)
    mask = rs.uniform(0, 1, (N, dg * 9, H, W)).astype(np.float32)
    F = DEFORM["num_filter"]
    w = (rs.normal(0, 1, (F, C, 3, 3)) / (9 * C) ** 0.5).astype(np.float32)
    b = rs.normal(0, 0.1, F).astype(np.float32)

    def swapped(d, xs, ys, batch=None):
        # planted: the offsets' (y, x) order swapped
        return real_gather(d, ys, xs, batch)
    for name, ins in (("DeformableConvolution", [x, off, w, b]),
                      ("ModulatedDeformableConvolution",
                       [x, off, mask, w, b])):
        fn = (lambda n: lambda *a: getattr(nd, "_contrib_" + n)(
            *a, **DEFORM))(name)

        def bad(*a, fn=fn):
            with mock.patch.object(vo, "_bilinear_gather", swapped):
                return fn(*a)
        t.check("deformable", "%s %s 3x3 512->512 dil 2, 4 groups"
                % (name, DEFORM_SHAPE), fn, ins,
                grad=tuple(range(len(ins))), bad=bad, peak=True)


def _tail_flow_and_attention(t, rs):
    """FlowNetC's correlation; the Transformer's encoder-decoder
    attention ops."""
    import numpy as np
    import mxnet_tpu_torch as mx
    nd = mx.nd
    a = rs.normal(0, 1, CORR_SHAPE).astype(np.float32)
    b = rs.normal(0, 1, CORR_SHAPE).astype(np.float32)
    t.check("correlation", "Correlation 2 x %s, displacement 20, stride2 2"
            % (CORR_SHAPE,), lambda x, y: nd.Correlation(x, y, **CORR),
            [a, b], grad=(0, 1),
            bad=lambda x, y: nd.Correlation(y, x, **CORR))
    L, N, U, Hh = ENCDEC_L, ENCDEC_N, ENCDEC_UNITS, ENCDEC_HEADS
    q = rs.normal(0, 1, (L, N, U)).astype(np.float32)
    kv = rs.normal(0, 1, (L, N, 2 * U)).astype(np.float32)
    swapped = kv.reshape(L, N, Hh, 2, -1)[:, :, :, ::-1].reshape(L, N, -1)
    t.check("encdec", "interleaved_matmul_encdec_qk L %d N %d %d units %d "
            "heads" % (L, N, U, Hh),
            lambda x, y: nd._contrib_interleaved_matmul_encdec_qk(
                x, y, heads=Hh), [q, kv], grad=(0, 1),
            bad=lambda x, y: nd._contrib_interleaved_matmul_encdec_qk(
                x, mx.nd.array(swapped, ctx=y.context), heads=Hh))
    att = rs.uniform(0, 1, (N * Hh, L, L)).astype(np.float32)
    att /= att.sum(-1, keepdims=True)
    t.check("encdec", "interleaved_matmul_encdec_valatt",
            lambda x, y: nd._contrib_interleaved_matmul_encdec_valatt(
                x, y, heads=Hh), [kv, att], grad=(0, 1))
    scores = rs.normal(0, 3, (N * Hh // 1, L, L)).astype(np.float32)
    lens = rs.randint(1, L + 1, N * Hh)
    mask = (np.arange(L)[None, None, :] < lens[:, None, None]).astype(
        np.float32) * np.ones((1, L, 1), np.float32)
    t.check("encdec", "masked_softmax (%d, %d, %d) valid lengths"
            % scores.shape, lambda s, m: nd.masked_softmax(s, m),
            [scores, mask], grad=(0,))
    t.check("encdec", "masked_log_softmax (%d, %d, %d)" % scores.shape,
            lambda s, m: nd.masked_log_softmax(s, m), [scores, mask])
    t.check("encdec", "div_sqrt_dim (%d, %d, %d)" % q.shape,
            lambda x: nd._contrib_div_sqrt_dim(x), [q], grad=(0,))


def _tail_linalg(t, rs):
    """The la_op family at (256, 64, 64) SPD and (32, 512, 512)
    products, f32 on the card against a float64 twin on the CPU; the
    sign-free checks of syevd and gelqf (reconstruction, orthogonality,
    the eigenvalues)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    nd = mx.nd
    B, n, _ = LINALG_SPD
    x = rs.normal(0, 1, LINALG_SPD)
    spd = (x @ x.transpose(0, 2, 1) / n + np.eye(n)).astype(np.float32)
    low = np.linalg.cholesky(spd.astype(np.float64)).astype(np.float32)
    rect = rs.normal(0, 1, (B, n // 2, n)).astype(np.float32)
    g = LINALG_GEMM
    A, Bm, C = (rs.normal(0, 1, g).astype(np.float32) for _ in range(3))
    checks = [
        ("linalg_gemm (32, 512, 512)", lambda a, b, c: nd.linalg_gemm(
            a, b, c, alpha=0.5, beta=2.0), [A, Bm, C], (0, 1, 2)),
        ("linalg_gemm2 (32, 512, 512) transpose_b",
         lambda a, b: nd.linalg_gemm2(a, b, transpose_b=True), [A, Bm],
         (0, 1)),
        ("linalg_potrf (256, 64, 64)", nd.linalg_potrf, [spd], (0,)),
        ("linalg_potri", nd.linalg_potri, [low], (0,)),
        ("linalg_trsm", lambda a, b: nd.linalg_trsm(a, b, alpha=2.0),
         [low, spd], (0, 1)),
        ("linalg_trmm rightside", lambda a, b: nd.linalg_trmm(
            a, b, rightside=True), [low, spd], (0, 1)),
        ("linalg_syrk", lambda a: nd.linalg_syrk(a, alpha=0.5), [rect],
         (0,)),
        ("linalg_inverse", nd.linalg_inverse, [spd], (0,)),
        ("linalg_det", nd.linalg_det, [spd], (0,)),
        ("linalg_slogdet", nd.linalg_slogdet, [spd], (0,)),
        ("linalg_sumlogdiag", nd.linalg_sumlogdiag, [spd], (0,)),
        ("linalg_extractdiag/makediag", lambda a: nd.linalg_makediag(
            nd.linalg_extractdiag(a, offset=1), offset=-1), [spd], (0,)),
        ("linalg_extracttrian/maketrian", lambda a: nd.linalg_maketrian(
            nd.linalg_extracttrian(a, offset=-1), offset=-1), [spd], (0,)),
    ]
    for what, fn, ins, grad in checks:
        bad = (lambda a, b: nd.linalg_trsm(a, b, alpha=2.0,
                                           transpose=True)) \
            if what == "linalg_trsm" else None
        t.check("linalg", what, fn, ins, grad=grad, bad=bad, ref=_f64_run)

    def syevd_parts(a):
        U, lam = nd.linalg_syevd(a)
        recon = nd.linalg_gemm2(nd.linalg_gemm2(U, nd.linalg_makediag(lam),
                                                transpose_a=True), U)
        gram = nd.linalg_gemm2(U, U, transpose_b=True)
        return recon, gram, lam

    def gelqf_parts(a):
        Q, L = nd.linalg_gelqf(a)
        return nd.linalg_gemm2(L, Q), nd.linalg_gemm2(Q, Q, transpose_b=True)
    for what, fn, ins in (("linalg_syevd: U^T diag(l) U, U U^T, l",
                           syevd_parts, [spd]),
                          ("linalg_gelqf (256, 32, 64): L Q, Q Q^T",
                           gelqf_parts, [rect])):
        t.check("linalg", what, fn, ins, ref=_f64_run)


def _tail_rest(t, rs):
    """The rest of tensor_tail, matrix and vision_ops at ResNet-50's and
    BERT-base's widths; LRN at AlexNet's conv1; the FCN head's x32
    upsampling."""
    import numpy as np
    import mxnet_tpu_torch as mx
    nd = mx.nd
    x = rs.normal(0, 1, TAIL_RESNET).astype(np.float32)
    y = rs.normal(0, 1, TAIL_RESNET).astype(np.float32)
    N, C, H, W = TAIL_RESNET
    resnet = [
        ("add_n x3", lambda a, b: nd.add_n(a, b, a), [x, y], (0, 1)),
        ("_maximum", nd._maximum, [x, y], (0, 1)),
        ("_hypot", nd._hypot, [x, y], (0, 1)),
        ("_greater", nd._greater, [x, y], ()),
        ("relu6", nd.relu6, [x * 4], (0,)),
        ("reverse axis 3", lambda a: nd.reverse(a, axis=3), [x], (0,)),
        ("moments over (0, 2, 3)", lambda a: nd.moments(a, axes=(0, 2, 3)),
         [x], (0,)),
        ("L2Normalization channel", lambda a: nd.L2Normalization(
            a, mode="channel"), [x], (0,)),
        ("Pad reflect 1", lambda a: nd.Pad(
            a, mode="reflect", pad_width=(0, 0, 0, 0, 1, 1, 1, 1)), [x],
         (0,)),
        ("depth_to_space 2", lambda a: nd.depth_to_space(a, block_size=2),
         [x], (0,)),
        ("space_to_depth 2", lambda a: nd.space_to_depth(a, block_size=2),
         [x], (0,)),
        ("UpSampling nearest x2", lambda a: nd.UpSampling(a, scale=2),
         [x], (0,)),
        ("Crop center 48^2", lambda a: nd.Crop(a, h_w=(48, 48),
                                               center_crop=True), [x], (0,)),
        ("SoftmaxActivation channel", lambda a: nd.SoftmaxActivation(
            a, mode="channel"), [x], (0,)),
        ("AdaptiveAvgPooling2D 7x7", lambda a:
         nd._contrib_AdaptiveAvgPooling2D(a, output_size=7), [x], (0,)),
    ]
    loc = np.tile(np.array([[0.9, 0.1, 0.05, -0.1, 0.9, 0.02]], np.float32),
                  (N, 1))
    resnet.append(("SpatialTransformer affine 56^2", lambda a, b:
                   nd.SpatialTransformer(a, b, target_shape=(H, W)),
                   [x, loc], (0, 1)))
    x3 = rs.normal(0, 1, TAIL_RESNET_3X3).astype(np.float32)
    resnet.append(("im2col 3x3 pad 1 %s" % (TAIL_RESNET_3X3,), lambda a:
                   nd.im2col(a, kernel=(3, 3), pad=(1, 1)), [x3], (0,)))
    cols = rs.normal(0, 1, (N, 64 * 9, H * W)).astype(np.float32)
    resnet.append(("col2im 3x3 pad 1 -> %s" % (TAIL_RESNET_3X3,), lambda a:
                   nd.col2im(a, output_size=(H, W), kernel=(3, 3),
                             pad=(1, 1)), [cols], (0,)))
    for what, fn, ins, grad in resnet:
        bad = (lambda a: nd.moments(a * 1.0001, axes=(0, 2, 3))) \
            if what.startswith("moments") else None
        t.check("rest_resnet", "%s %s" % (what, TAIL_RESNET), fn, ins,
                grad=grad, bad=bad)
    del x, y, x3, cols
    h = rs.normal(0, 1, TAIL_BERT).astype(np.float32)
    B, T, U = TAIL_BERT
    ht = np.ascontiguousarray(h.transpose(1, 0, 2))       # (T, N, U)
    lens = rs.randint(1, T + 1, B).astype(np.float32)
    rows = h.reshape(B * T, U)
    idx = rs.randint(0, U, B * T).astype(np.float32)
    hs = rs.randint(0, 512, U).astype(np.float32)
    ss = np.where(rs.rand(U) > 0.5, 1.0, -1.0).astype(np.float32)
    bert = [
        ("SequenceLast lengths", lambda a, b: nd.SequenceLast(
            a, b, use_sequence_length=True), [ht, lens], (0,)),
        ("SequenceReverse lengths", lambda a, b: nd.SequenceReverse(
            a, b, use_sequence_length=True), [ht, lens], (0,)),
        ("moments over units", lambda a: nd.moments(a, axes=(2,)), [h],
         (0,)),
        ("L2Normalization instance", nd.L2Normalization, [h], (0,)),
        ("_split_v2 3 sections", lambda a: nd._split_v2(
            a, sections=3, axis=2), [h], (0,)),
        ("batch_take (4096, 768)", nd.batch_take, [rows, idx], (0,)),
        ("fft then ifft", lambda a: nd._contrib_ifft(nd._contrib_fft(a)),
         [h], (0,)),
        ("count_sketch -> 512", lambda a, b, c: nd._contrib_count_sketch(
            a, b, c, out_dim=512), [rows, hs, ss], (0,)),
        ("quadratic", lambda a: nd._contrib_quadratic(a, a=0.5, b=-1,
                                                      c=2), [h], (0,)),
        ("gradientmultiplier -1", lambda a: nd._contrib_gradientmultiplier(
            a, scalar=-1.0), [h], (0,)),
        ("round_ste, sign_ste", lambda a: nd._contrib_round_ste(a * 3)
         + nd._contrib_sign_ste(a), [h], (0,)),
        ("rcbrt", nd.rcbrt, [h], (0,)),
    ]
    for what, fn, ins, grad in bert:
        bad = (lambda a: nd.moments(a * 1.0001, axes=(2,))) \
            if what.startswith("moments") else None
        t.check("rest_bert", "%s %s" % (what, TAIL_BERT), fn, ins, grad=grad,
                bad=bad)
    del h, ht, rows
    z = rs.uniform(-1, 1, LRN_SHAPE).astype(np.float32)
    t.check("lrn", "LRN %s nsize %d" % (LRN_SHAPE, LRN_NSIZE),
            lambda a: nd.LRN(a, nsize=LRN_NSIZE), [z], grad=(0,),
            bad=lambda a: nd.LRN(a, nsize=LRN_NSIZE, knorm=1.0))
    del z
    f = rs.normal(0, 1, FCN_HEAD).astype(np.float32)
    s = FCN_SCALE
    k = 2 * s - s % 2
    wts = rs.uniform(0, 1, (FCN_HEAD[1], 1, k, k)).astype(np.float32) / k
    side = FCN_HEAD[2] * s
    t.check("upsampling", "UpSampling bilinear x%d %s" % (s, FCN_HEAD),
            lambda a, w: nd.UpSampling(a, w, scale=s, sample_type="bilinear",
                                       num_args=2, num_filter=FCN_HEAD[1]),
            [f, wts], grad=(0, 1))
    t.check("upsampling", "BilinearResize2D %s -> %d^2" % (FCN_HEAD, side),
            lambda a: nd._contrib_BilinearResize2D(a, height=side,
                                                   width=side), [f],
            grad=(0,),
            bad=lambda a: nd._contrib_BilinearResize2D(
                a, height=side, width=side, align_corners=False))


def _tail_blocks(mx):
    class Head(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, cls_prob, loc, anchors):
            return F._contrib_MultiBoxDetection(cls_prob, loc, anchors,
                                                **SSD_NMS)

    class RoiDeform(mx.gluon.HybridBlock):
        """An offset conv, a deformable 3 x 3 at Deformable ConvNets'
        width, then ROIAlign over the proposals."""

        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.offset = mx.gluon.nn.Conv2D(
                    DEFORM["num_deformable_group"] * 18, 3, padding=1,
                    in_channels=DEFORM_SHAPE[1])
                self.weight = self.params.get(
                    "weight", shape=(DEFORM["num_filter"], DEFORM_SHAPE[1],
                                     3, 3))
                self.bias = self.params.get(
                    "bias", shape=(DEFORM["num_filter"],), init="zeros")

        def hybrid_forward(self, F, x, rois, weight, bias):
            off = self.offset(x)
            y = F._contrib_DeformableConvolution(x, off, weight, bias,
                                                 **DEFORM)
            return F._contrib_ROIAlign(y, rois, pooled_size=ROI_ALIGN_POOL,
                                       spatial_scale=RCNN_SCALE,
                                       sample_ratio=2)

    class Mask(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x, m):
            return F._contrib_boolean_mask(x, m)
    return Head, RoiDeform, Mask


def _tail_captured(seed, rs, cls_prob, loc, anc, card_line):
    """The SSD head and an offset conv -> deformable conv -> ROIAlign
    block hybridized (captured graphs) bit for bit with their eager
    twins; boolean_mask eager on the card, and refused under capture."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    gpu = mx.gpu(0)
    Head, RoiDeform, Mask = _tail_blocks(mx)
    head = Head()
    ins = [mx.nd.array(a, ctx=gpu) for a in (cls_prob, loc, anc)]
    with cached_op.eager():
        want = head(*ins).tensor().clone()
    head.hybridize()
    cached_op.reset_replay_counts()
    for _ in range(3):
        got = head(*ins)
    replays = cached_op.replay_counts()["forward"]
    same = torch.equal(got.tensor(), want)
    t0 = time.perf_counter()
    for _ in range(5):
        head(*ins)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) / 5 * 1e3
    t0 = time.perf_counter()
    with cached_op.eager():
        for _ in range(5):
            head(*ins)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / 5 * 1e3
    print("[ops_tail] SSD head (MultiBoxDetection (32, 21, 8732), top 400) "
          "hybridized: bit for bit with eager %s, %d replays of 3 calls; "
          "host clock %.2f ms a call (eager %.2f ms); %s"
          % (same, replays, graph_ms, eager_ms, card_line))
    if not same or replays < 2:
        raise SmokeFailure("the captured SSD head differs from its eager "
                           "twin, or was not replayed")
    mx.random.seed(seed)
    blk = RoiDeform(prefix="rd_")
    blk.initialize(mx.init.Xavier(), ctx=gpu)
    x = mx.nd.array(rs.normal(0, 1, DEFORM_SHAPE).astype(np.float32),
                    ctx=gpu)
    rois = mx.nd.array(_rcnn_rois(rs, DEFORM_SHAPE[0], ROI_ALIGN_ROIS),
                       ctx=gpu)
    # bit for bit with the layout pass off; phase 19 holds the pass's run
    # to eager within LAYOUT_LIMIT["deform"]
    with _no_tf32(), layout_opt("0"):
        with cached_op.eager():
            want = blk(x, rois).tensor().clone()
        blk.hybridize(static_alloc=True)
        cached_op.reset_replay_counts()
        for _ in range(3):
            got = blk(x, rois)
        replays = cached_op.replay_counts()["forward"]
        same = torch.equal(got.tensor(), want)
    print("[ops_tail] offset conv -> DeformableConvolution -> ROIAlign %s, "
          "%d ROIs, hybridized: bit for bit with eager %s, %d replays of 3 "
          "calls" % (DEFORM_SHAPE, ROI_ALIGN_ROIS, same, replays))
    if not same or replays < 2:
        raise SmokeFailure("the captured ROIAlign/deformable block differs "
                           "from its eager twin, or was not replayed")
    data = rs.normal(0, 1, (4096, 768)).astype(np.float32)
    keep = (rs.rand(4096) > 0.5).astype(np.float32)
    card = mx.nd._contrib_boolean_mask(mx.nd.array(data, ctx=gpu),
                                       mx.nd.array(keep, ctx=gpu))
    host = data[keep > 0]
    ok = card.shape == host.shape and np.array_equal(card.asnumpy(), host)
    blk = Mask()
    blk.hybridize()
    try:
        blk(mx.nd.array(data, ctx=gpu), mx.nd.array(keep, ctx=gpu))
        refused = False
    except mx.MXNetError as e:
        refused = "hybridized" in str(e)
    print("[ops_tail] boolean_mask (4096, 768) eager on the card: %d rows, "
          "equal to numpy's %s; refused under capture %s"
          % (card.shape[0], ok, refused))
    if not ok or not refused:
        raise SmokeFailure("boolean_mask: wrong rows on the card, or a "
                           "captured call was not refused")


def _ops_tail(seed, reps, card_line, faults):
    import numpy as np
    t = _Tail(seed, reps, card_line, faults)
    rs = np.random.RandomState(seed + 180)
    took = [time.perf_counter()]
    with _no_tf32():
        cls_prob, loc, anc = _tail_ssd(t, rs)
        took.append(time.perf_counter())
        _tail_rcnn(t, rs)
        took.append(time.perf_counter())
        _tail_flow_and_attention(t, rs)
        _tail_linalg(t, rs)
        took.append(time.perf_counter())
        _tail_rest(t, rs)
        took.append(time.perf_counter())
    return t, (cls_prob, loc, anc), took


def ops_tail_readings(seeds, card_line, reps=2):
    """The readings behind OPS_TAIL_LIMIT at ``seeds`` (print only; the
    limits are twice the largest) and the planted faults' readings."""
    worst = collections.defaultdict(float)
    faults = {}
    for seed in seeds:
        t, _, _ = _ops_tail(seed, reps, card_line, faults=True)
        for g, r in t.readings.items():
            worst[g] = max(worst[g], r)
        for g, (_, fr) in t.fault_readings.items():
            faults[g] = min(faults.get(g, float("inf")), fr)
        print("[readings] seed %d: %s" % (seed, json.dumps(t.readings)))
    print("[readings] largest: %s" % json.dumps(worst))
    print("[readings] limits (2x): %s" % json.dumps(
        {g: 2 * r for g, r in worst.items()}))
    print("[readings] planted faults, smallest: %s" % json.dumps(faults))


def phase_ops_tail(seed, card_line, reps=5):
    """18. The rest of the op registry (tensor_tail, matrix with linalg,
    five contrib ops, vision_ops) at the widths of SSD-300, Faster
    R-CNN/R-FCN, Deformable ConvNets, FlowNetC and the Transformer, card
    against the port's CPU path; the SSD head and a ROIAlign/deformable
    block captured; each group's planted fault."""
    import torch
    print("[ops_tail] %s" % card_line)
    t0 = time.perf_counter()
    t, (cls_prob, loc, anc), took = _ops_tail(seed, reps, card_line, True)
    t.controls()
    import numpy as np
    _tail_captured(seed, np.random.RandomState(seed + 190), cls_prob, loc,
                   anc, card_line)
    torch.cuda.empty_cache()
    for what, mb in sorted(t.peaks.items()):
        print("[ops_tail] peak %-58s %.1f MB; %s" % (what, mb, card_line))
    print("[ops_tail] phase 18 took %.1f s: SSD %.1f, R-CNN %.1f, "
          "correlation + attention + linalg %.1f, the rest %.1f, "
          "captured %.1f; %s"
          % (time.perf_counter() - t0, took[1] - took[0], took[2] - took[1],
             took[3] - took[2], took[4] - took[3],
             time.perf_counter() - took[4], card_line))
    return t


# ---------------------------------------------------------------------------
# 19. the NHWC layout pass (MXNET_LAYOUT_OPT) and the S2D stem
#     (MXNET_CONV_S2D)
# ---------------------------------------------------------------------------
# Each check under MXNET_LAYOUT_OPT=1 against its eager twin (the pass
# runs only in a hybridized call) reads relative L2 distances by
# component, each against its own limit: the first step's output
# ("logits"), the largest over the steps' losses ("loss"), the first
# step's gradients and the parameters after the last step, each as one
# vector with the elided conv biases apart (those must be exactly
# zero-gradient and unmoved under the pass); the deformable block's and
# the S2D stem's "output". Each limit is twice the largest reading of
# ``layout_readings`` over seeds 0-4 on an H100; the planted fault (every
# 2-D convolution inside a hybridized call reads its kernel mirrored, the
# orientation bug of a layout rewrite) must exceed one of them, and for
# "resnet_nhwc" every one.
# "resnet" holds the bf16 ResNet-50 to the eager loop in NCHW. Its
# gradients part by up to ~0.7 and its parameters by ~0.12, and no limit
# there can fail the fault: cuDNN's NHWC kernels alone part them so
# (``_layout_witness``: the eager loop fed channels-last, no pass, reads
# the same by kind of leaf to the printed digits; NHWC against itself 0;
# in f32 with TF32 off 0.023-0.025, against logits 2.1e-5-2.5e-5 apart:
# at initialisation BatchNorm's backward cancels most of a gradient).
# "resnet_nhwc" holds it to the eager loop fed channels-last with the
# conv biases frozen, the same kernels and the elision's effect: bit for
# bit, so every component catches the fault.
# Readings at seeds 0-4 (NVIDIA H100 80GB HBM3, 700 W): "resnet" logits
# 0-0.0234, loss 0.0555-0.0757, gradients 0.0319-0.717, parameters
# 0.0643-0.121 (mirrored: logits 0.216-0.222, gradients 1.40 at least);
# "resnet_nhwc" 0 (mirrored: logits 0.215, loss 0.061, gradients 1.40,
# parameters 0.208 at least); VGG-16 (f32, TF32 off: no island) 0
# (mirrored: loss 5.94e-6, parameters 1.96e-5 at least); the deformable
# block 0 (mirrored 1.22); the stem 1.65e-5-1.85e-5.
LAYOUT_LIMIT = {"resnet": {"logits": 0.0468, "loss": 0.152,
                           "gradients": 1.44, "parameters": 0.243},
                "resnet_nhwc": {"logits": 0.0, "loss": 0.0,
                                "gradients": 0.0, "parameters": 0.0},
                "vgg16": {"loss": 0.0, "parameters": 0.0},
                "deform": {"output": 0.0},
                "stem": {"output": 3.71e-5}}
LAYOUT_TURNS = 5
LAYOUT_VGG_STEPS = 2
# cuDNN's layout-change kernels, matched in lower case
LAYOUT_KERNEL_NAMES = ("nchwtonhwc", "nhwctonchw", "nchw2nhwc",
                       "nhwc2nchw")
S2D_REPS = 20


@contextlib.contextmanager
def _env_flag(name, flag):
    """The environment variable ``name`` set to ``flag`` in the scope."""
    old = os.environ.get(name)
    os.environ[name] = flag
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def layout_opt(flag):
    """``MXNET_LAYOUT_OPT`` set to ``flag`` ("0" or "1") in the scope; a
    CachedOp reads it at each call and keys its graphs on it."""
    return _env_flag("MXNET_LAYOUT_OPT", flag)


def conv_s2d(flag):
    """``MXNET_CONV_S2D`` set to ``flag`` in the scope (also part of a
    CachedOp's signature)."""
    return _env_flag("MXNET_CONV_S2D", flag)


@contextlib.contextmanager
def _mirrored_kernels(on=True):
    """The planted fault: every 2-D convolution inside a hybridized call
    with the pass on reads its kernel mirrored left to right (graphs
    captured before it keep their kernels: release them first)."""
    from unittest import mock
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import nn as nn_ops
    from mxnet_tpu_torch.symbol import layout_opt as lo

    def conv(x, w, b, *a):
        if lo.active() is not None:
            w = w.flip(-1)
        return F.conv2d(x, w, b, *a)
    with (mock.patch.dict(nn_ops._CONV, {2: conv}) if on
          else contextlib.nullcontext()):
        yield


def _layout_check(tag, reading, limit, planted=False):
    """Print a reading (a dict of components) against its limits; returns
    whether a component is beyond its limit (None: a readings run,
    nothing judged)."""
    got = ", ".join("%s %.4g" % kv for kv in sorted(reading.items()))
    if limit is None:
        print("[layout] %s: %s, no limit set" % (tag, got))
        return False
    beyond = sorted(k for k, v in reading.items()
                    if not v <= limit[k])          # NaN is beyond
    verdict = ("caught" if beyond else "MISSED") if planted else \
        ("FAIL" if beyond else "ok")
    print("[layout] %s: %s; limits %s %s%s" % (
        tag, got, ", ".join("%s %.4g" % kv for kv in sorted(limit.items())),
        verdict, " (beyond: %s)" % ", ".join(beyond) if beyond else ""))
    return bool(beyond)


def _vector_distance(got, ref, skip=()):
    """The relative L2 distance of two dicts of tensors as one vector,
    ``skip`` apart."""
    import torch

    def cat(d):
        return torch.cat([d[n].float().flatten() for n in ref
                          if n not in skip])
    return _rel(cat(got), cat(ref))


def _leaf_groups(got, ref, skip=()):
    """``_vector_distance`` of each kind of leaf apart: the conv weights,
    BatchNorm's gamma and beta, the dense layer."""
    def kind(n):
        if "conv" in n and n.endswith("_weight"):
            return "conv"
        if "batch_norm" in n:
            return "batchnorm"
        return "dense" if "dense" in n else "other"
    out = {}
    for k in ("conv", "batchnorm", "dense", "other"):
        names = [n for n in ref if n not in skip and kind(n) == k]
        if names:
            out[k] = _vector_distance({n: got[n] for n in names},
                                      {n: ref[n] for n in names})
    return out


class _LayoutResNet:
    """Phase 11's compiled ResNet-50 v1 (bf16 AMP, 128 x 224^2,
    ``static_alloc``, SGD with the fused update) with the pass on and
    off, from one snapshot of the parameters and one batch."""

    def __init__(self, seed):
        import torch
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
        self.mx = mx
        mx.random.seed(seed)
        self.net = net = resnet50_v1(prefix="resnet50l_")
        net.initialize(init=mx.init.MSRAPrelu())
        with torch.no_grad():
            net(mx.nd.zeros((1, 3, RESNET_SIDE, RESNET_SIDE)))
        net.hybridize(static_alloc=True, static_shape=True)
        self.loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        self.loss_fn.hybridize(static_alloc=True, static_shape=True)
        self.params = net.collect_params()
        # every conv bias of ResNet v1 feeds one BatchNorm: all elided
        self.biases = [n for n in self.params
                       if n.endswith("_bias") and "conv" in n]
        g = torch.Generator(device=DEV).manual_seed(seed + 41)
        self.x = mx.nd.NDArray(torch.randn(RESNET_BATCH, 3, RESNET_SIDE,
                                           RESNET_SIDE, generator=g,
                                           device=DEV))
        self.y = mx.nd.NDArray(torch.randint(0, 1000, (RESNET_BATCH,),
                                             generator=g, device=DEV).float())
        self.snap = _snapshot(self.params)
        self.trainer = None

    def step(self, flag):
        """One more step with the pass ``flag`` (after :meth:`run`)."""
        mx = self.mx
        with layout_opt(flag):
            with mx.autograd.record():
                loss = self.loss_fn(self.net(self.x), self.y)
            loss.backward()
            self.trainer.step(RESNET_BATCH)
        return loss

    def run(self, flag, compiled=True, fault=False, channels_last=False,
            frozen_biases=False):
        """``COMPILED_STEPS`` steps from the snapshot: (the first step's
        output, the losses, the first step's gradients, the parameters
        after). With ``channels_last`` the batch goes in channels-last,
        so an eager run takes cuDNN's NHWC kernels without the pass; with
        ``frozen_biases`` the conv biases take no gradient and stay put
        (``grad_req`` null for the run: the elision's effect, without the
        pass). A run with ``frozen_biases`` gives the parameters new
        gradient arrays: make it before any capture."""
        import torch
        from mxnet_tpu_torch import autograd, cached_op
        mx = self.mx
        x = self.x if not channels_last else mx.nd.NDArray(
            self.x.tensor().contiguous(memory_format=torch.channels_last))
        _restore(self.params, self.snap)
        autograd.disarm_fused_update()
        for n in self.biases if frozen_biases else ():
            self.params[n].grad_req = "null"
        self.trainer = trainer = mx.gluon.Trainer(
            self.params, "sgd", {"learning_rate": 0.1, "momentum": 0.9},
            kvstore="device")
        losses, grads, logits = [], None, None
        try:
            with (contextlib.nullcontext() if compiled
                  else cached_op.eager()), \
                    _mirrored_kernels(fault), layout_opt(flag):
                for i in range(COMPILED_STEPS):
                    with mx.autograd.record():
                        out = self.net(x)
                        loss = self.loss_fn(out, self.y)
                    loss.backward()
                    if i == 0:
                        logits = out.tensor().detach().float().clone()
                        grads = {n: p.grad().tensor().detach().clone()
                                 for n, p in self.params.items()
                                 if p.grad_req != "null"}
                    trainer.step(RESNET_BATCH)
                    losses.append(loss.tensor().detach().float().clone())
            torch.cuda.synchronize()
        finally:
            for n in self.biases if frozen_biases else ():
                self.params[n].grad_req = "write"
        return logits, losses, grads, _snapshot(self.params)

    def reading(self, got, ref):
        """The reading of a run under the pass against the eager run, and
        whether the elided biases stayed exactly put with zero
        gradients."""
        import torch
        skip = set(self.biases)
        reading = {
            "logits": _rel(got[0], ref[0]),
            "loss": max(_rel(a, b) for a, b in zip(got[1], ref[1])),
            "gradients": _vector_distance(got[2], ref[2], skip),
            "parameters": _vector_distance(got[3], ref[3], skip)}
        frozen = all(bool((got[2][n] == 0).all()) and
                     torch.equal(got[3][n], self.snap[n])
                     for n in self.biases)
        return reading, frozen

    def groups(self, got, ref):
        """The first gradients' and the last parameters' distances by
        kind of leaf (the elided biases apart)."""
        skip = set(self.biases)
        return {"gradients": _leaf_groups(got[2], ref[2], skip),
                "parameters": _leaf_groups(got[3], ref[3], skip)}


def _layout_vgg(seed, limit, card_line, fault=False, timing=True):
    """VGG-16 (phase 15's, 64 x 224^2 f32, TF32 off, SGD) hybridized with
    the pass on against its eager steps; with ``timing``, the step both
    ways in turns. Returns the reading."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, cached_op
    from mxnet_tpu_torch.ops import cuda_build
    net, _ = _zoo_net("vgg16", VISION_SIDE, seed)
    params = net.collect_params()
    net.hybridize(static_alloc=True, static_shape=True)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize(static_alloc=True, static_shape=True)
    x, y = _card_batch(seed, VISION_BATCH, VISION_SIDE)
    snap = _snapshot(params)
    state = {}

    def step(flag):
        with layout_opt(flag):
            loss = _vision_step(net, loss_fn, x, y)
            state["tr"].step(VISION_BATCH)
        return loss

    def run(flag, compiled, fault=False):
        _restore(params, snap)
        autograd.disarm_fused_update()
        state["tr"] = mx.gluon.Trainer(params, "sgd", dict(VISION_SGD),
                                       kvstore="device")
        mx.random.seed(seed)
        losses = []
        with (contextlib.nullcontext() if compiled else cached_op.eager()), \
                _mirrored_kernels(fault):
            for _ in range(LAYOUT_VGG_STEPS):
                losses.append(step(flag).tensor().detach().float()
                              .mean().clone())
        torch.cuda.synchronize()
        return losses, _snapshot(params)

    with _deterministic(), _no_tf32():
        eager = run("1", False)
        cuda_build.reset_launch_counts()
        on = run("1", True, fault)
        torch.cuda.synchronize()
        counts = {k: v for k, v in cuda_build.launch_counts().items() if v}
    reading = {"loss": max(_rel(a, b) for a, b in zip(on[0], eager[0])),
               "parameters": _vector_distance(on[1], eager[1])}
    tag = "vgg16 (batch %d x %d^2 f32, %d SGD steps) hybridized with the " \
        "pass against eager" % (VISION_BATCH, VISION_SIDE, LAYOUT_VGG_STEPS)
    if fault:
        tag = "control: " + tag + ", kernels mirrored"
    out = {"reading": reading, "counts": counts}
    if timing:
        # f32 with TF32 off opens no island: the pass computes what NCHW
        # does; with TF32 on (torch's default for cuDNN) every conv runs
        # channels-last under the pass. Fresh graphs for each mode: a
        # graph keeps the kernels of its capture.
        out["ms"] = {}
        for mode, ctx in (("TF32 off", _no_tf32), ("TF32 on",
                                                   contextlib.nullcontext)):
            _free_graphs(net, loss_fn)
            with _deterministic(), ctx():
                run("0", True)
                run("1", True)
                ms = _turns({"0": lambda: step("0"),
                             "1": lambda: step("1")})
            print("[layout] vgg16 step (batch %d, f32, %s, SGD): %.2f ms "
                  "NCHW (%.1f images/s), %.2f ms with the pass (%.1f "
                  "images/s), host clock, medians of %d in turns; %s"
                  % (VISION_BATCH, mode, ms["0"],
                     VISION_BATCH / ms["0"] * 1e3, ms["1"],
                     VISION_BATCH / ms["1"] * 1e3, 2 * LAYOUT_TURNS,
                     card_line))
            out["ms"][mode] = ms
    out["fail"] = _layout_check(tag, reading, limit, planted=fault)
    _free_graphs(net, loss_fn)
    return out


def _turns(fns, turns=LAYOUT_TURNS):
    """Host-clock medians (ms) of each of two callables, the card
    synchronised around each call, in turns: a, b, b, a."""
    import torch
    keys = list(fns)
    times = {k: [] for k in keys}
    for _ in range(turns):
        for k in keys + keys[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def _kernel_census(fn):
    """One call of ``fn`` (run once before, warm) under torch.profiler:
    (kernels launched, device ms, {cuDNN layout-change kernel name:
    launches}, their device ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n, busy, layout, layout_ms = 0, 0.0, collections.Counter(), 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.device_time_total if hasattr(ev, "device_time_total") \
            else ev.cuda_time_total
        n += 1
        busy += us / 1e3
        if any(k in ev.name.lower() for k in LAYOUT_KERNEL_NAMES):
            layout[ev.name[:60]] += 1
            layout_ms += us / 1e3
    return n, busy, dict(layout), layout_ms


def _layout_resnet(seed, card_line, limits, timing=True):
    """The compiled ResNet-50 with the pass against its eager loop (the
    twin of phase 11's bit-for-bit check), and against the eager loop fed
    channels-last with its conv biases frozen (the same cuDNN kernels and
    the elision's effect, without the pass), each with the planted
    fault; then with ``timing`` the pass on and off in turns, their graph
    memory and one profiled step each way, and the S2D stem on and off.
    ``limits``: LAYOUT_LIMIT, or None to judge nothing. Returns the
    readings and the numbers."""
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.ops import cuda_build
    limit = limits and limits["resnet"]
    limit_nhwc = limits and limits["resnet_nhwc"]
    amp.init(target_dtype="bfloat16")
    out = {}
    try:
        rig = _LayoutResNet(seed)
        eager = rig.run("1", compiled=False)
        twin = rig.run("1", compiled=False, channels_last=True,
                       frozen_biases=True)
        held = {}
        cuda_build.reset_launch_counts()
        on, held["1"] = _graph_mb(lambda: rig.run("1"))
        out["counts"] = {k: v for k, v in cuda_build.launch_counts().items()
                         if v}
        plan = rig.net._cached_op.layout_plan()
        reading, frozen = rig.reading(on, eager)
        elided = sum(1 for _, e in plan if e)
        print("[layout] resnet50_v1 plan: %d convs, %d channels-last, %d "
              "biases elided (%d conv biases in the net): those exactly "
              "zero-gradient and unmoved after %d steps %s"
              % (len(plan), sum(1 for n, _ in plan if n), elided,
                 len(rig.biases), COMPILED_STEPS, frozen))
        if elided != len(rig.biases) or not frozen or \
                not all(n for n, _ in plan):
            raise SmokeFailure("layout: the ResNet plan %s does not elide "
                               "and freeze every conv bias" % plan)
        out["reading"] = reading
        out["reading_nhwc"] = rig.reading(on, twin)[0]
        out["groups"] = rig.groups(on, eager)
        tag = "resnet50_v1 compiled with the pass against the eager loop " \
            "(%d steps)" % COMPILED_STEPS
        tag_nhwc = tag + " fed channels-last, conv biases frozen"
        out["fail"] = _layout_check(tag, reading, limit) | \
            _layout_check(tag_nhwc, out["reading_nhwc"], limit_nhwc)
        # the fault needs graphs captured under it
        _free_graphs(rig.net, rig.loss_fn)
        bad_run = rig.run("1", fault=True)
        bad, _ = rig.reading(bad_run, eager)
        out["fault_nhwc"] = rig.reading(bad_run, twin)[0]
        out["fault_groups"] = rig.groups(bad_run, eager)
        _free_graphs(rig.net, rig.loss_fn)
        out["fault"] = bad
        _layout_check("control: " + tag + ", kernels mirrored", bad, limit,
                      planted=True)
        caught = _layout_check("control: " + tag_nhwc + ", kernels "
                               "mirrored", out["fault_nhwc"], limit_nhwc,
                               planted=True)
        if limit_nhwc is not None and \
                not all(out["fault_nhwc"][k] > limit_nhwc[k]
                        for k in limit_nhwc):
            raise SmokeFailure("control: the channels-last layout twin "
                               "check passed mirrored kernels in %s"
                               % sorted(k for k in limit_nhwc if not
                                        out["fault_nhwc"][k] >
                                        limit_nhwc[k]))
        if limit is not None and not caught:
            raise SmokeFailure("control: the layout twin check passed "
                               "mirrored kernels")
        if timing:
            _, held["1"] = _graph_mb(lambda: rig.run("1"))
            _, held["0"] = _graph_mb(lambda: rig.run("0"))
            ms = _turns({"0": lambda: rig.step("0"),
                         "1": lambda: rig.step("1")})
            census = {f: _kernel_census(lambda f=f: rig.step(f))
                      for f in ("0", "1")}
            for f, name in (("0", "NCHW (MXNET_LAYOUT_OPT=0)"),
                            ("1", "with the pass (MXNET_LAYOUT_OPT=1)")):
                n, busy, layout, layout_ms = census[f]
                print("[layout] resnet50_v1 compiled step %s: %.2f ms, %.1f "
                      "images/s (host clock, median of %d in turns); graphs "
                      "hold %.1f MB (peak +%.1f MB capturing); one profiled "
                      "step: %d kernels, device busy %.2f ms; cuDNN layout "
                      "changes %d launches, %.3f ms (%s); %s"
                      % (name, ms[f], RESNET_BATCH / ms[f] * 1e3,
                         2 * LAYOUT_TURNS, held[f][0], held[f][1], n, busy,
                         sum(layout.values()), layout_ms,
                         json.dumps(layout) if layout else "none",
                         card_line))
            out.update(ms=ms, held=held, census=census)
            # the stem's S2D rewrite on and off, each with its own graphs
            # (the flag is part of the signature), the pass on
            _free_graphs(rig.net, rig.loss_fn)
            for f in ("0", "1"):
                with conv_s2d(f):
                    rig.run("1")

            def s2d_step(f):
                with conv_s2d(f):
                    rig.step("1")
            s2d = _turns({f: lambda f=f: s2d_step(f) for f in ("0", "1")})
            busy = {f: _kernel_census(lambda f=f: s2d_step(f))[1]
                    for f in ("0", "1")}
            print("[layout] resnet50_v1 compiled step with the pass, the stem "
                  "plain (MXNET_CONV_S2D=0): %.2f ms, %.1f images/s, device "
                  "busy %.3f ms; with the S2D stem (=1): %.2f ms, %.1f "
                  "images/s, device busy %.3f ms (host clock, medians of %d "
                  "in turns; device time of one profiled step); %s"
                  % (s2d["0"], RESNET_BATCH / s2d["0"] * 1e3, busy["0"],
                     s2d["1"], RESNET_BATCH / s2d["1"] * 1e3, busy["1"],
                     2 * LAYOUT_TURNS, card_line))
            out["s2d_ms"], out["s2d_busy"] = s2d, busy
        _free_graphs(rig.net, rig.loss_fn)
    finally:
        amp.reset()
    return out


def _layout_witness(seed):
    """Where the pass's ResNet-50 gap comes from: the eager steps (no
    pass, no CachedOp) with the batch channels-last against NCHW, in bf16
    AMP and in f32 with TF32 off, and the channels-last eager steps run
    twice (cuDNN's own run-to-run spread); then the pass against eager
    under cuDNN's deterministic algorithms. Readings by kind of leaf."""
    from mxnet_tpu_torch.contrib import amp
    got = {}
    amp.init(target_dtype="bfloat16")
    try:
        rig = _LayoutResNet(seed)
        eager = rig.run("1", compiled=False)
        nhwc = rig.run("1", compiled=False, channels_last=True)
        again = rig.run("1", compiled=False, channels_last=True)
        got["bf16 eager NHWC vs NCHW"] = (rig.reading(nhwc, eager)[0],
                                          rig.groups(nhwc, eager))
        got["bf16 eager NHWC vs itself"] = (rig.reading(again, nhwc)[0],
                                            rig.groups(again, nhwc))
        with _deterministic():
            det = rig.run("1", compiled=False)
            on = rig.run("1")
        got["bf16 pass vs eager, deterministic cuDNN"] = (
            rig.reading(on, det)[0], rig.groups(on, det))
        _free_graphs(rig.net, rig.loss_fn)
        del rig
    finally:
        amp.reset()
    with _no_tf32():
        rig = _LayoutResNet(seed)
        eager = rig.run("1", compiled=False)
        nhwc = rig.run("1", compiled=False, channels_last=True)
        got["f32 eager NHWC vs NCHW, TF32 off"] = (
            rig.reading(nhwc, eager)[0], rig.groups(nhwc, eager))
        del rig
    for k, (reading, groups) in got.items():
        print("[witness] seed %d, %s: %s; by leaf %s"
              % (seed, k, json.dumps(reading), json.dumps(groups)))
    return got


def _layout_stem(seed, card_line, limit, timing=True):
    """ResNet-50's stem convolution (64 filters, 7 x 7 / 2, pad 3) at
    (128, 3, 224, 224) bf16 with MXNET_CONV_S2D on and off: the output's
    distance, and each way's time."""
    import torch
    from mxnet_tpu_torch.ops import nn as nn_ops
    g = torch.Generator(device=DEV).manual_seed(seed + 190)
    x = torch.randn(RESNET_BATCH, 3, RESNET_SIDE, RESNET_SIDE, generator=g,
                    device=DEV).to(torch.bfloat16)
    w = (torch.randn(64, 3, 7, 7, generator=g, device=DEV) * 0.1) \
        .to(torch.bfloat16)
    kw = dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3), num_filter=64,
              no_bias=True)
    outs, ms = {}, {}
    for flag in ("0", "1"):
        with conv_s2d(flag):
            outs[flag] = nn_ops.convolution(x, w, **kw)
            if timing:
                ms[flag] = _gpu_ms(lambda: nn_ops.convolution(x, w, **kw),
                                   S2D_REPS)
    reading = {"output": _rel(outs["1"], outs["0"])}
    fail = _layout_check("stem 7x7/2 over 3 channels at (%d, 3, %d, %d) "
                         "bf16, S2D against the plain convolution"
                         % (RESNET_BATCH, RESNET_SIDE, RESNET_SIDE), reading,
                         limit)
    if timing:
        print("[layout] stem convolution: %.3f ms plain, %.3f ms S2D "
              "(device time, CUDA events, median of 7 trials of %d); %s"
              % (ms["0"], ms["1"], S2D_REPS, card_line))
    return {"reading": reading, "ms": ms, "fail": fail}


def _layout_dropout(seed, card_line):
    """Dropout after a conv inside an island: structured (``axes``, the
    context's generator) and full-shape (row 8's kernel) on the
    channels-last conv output, bit for bit with the same logical tensor
    in NCHW from the same seed."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import nn as nn_ops
    g = torch.Generator(device=DEV).manual_seed(seed + 191)
    x = torch.randn(32, 256, 28, 28, generator=g, device=DEV)
    w = torch.randn(256, 256, 3, 3, generator=g, device=DEV) * 0.02
    y = torch.nn.functional.conv2d(
        x.contiguous(memory_format=torch.channels_last),
        w.contiguous(memory_format=torch.channels_last), None, 1, 1)
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise SmokeFailure("layout: cuDNN gave a channels-last conv an "
                           "NCHW output")
    ok = []
    for axes in ((2, 3), ()):
        got = []
        for t in (y, y.contiguous()):
            mx.random.seed(seed)
            got.append(nn_ops.dropout_op(t, p=0.5, axes=axes, _train=True))
        ok.append(torch.equal(got[0], got[1]))
    print("[layout] Dropout(0.5) on a channels-last conv output (32, 256, "
          "28, 28) f32 against the same values in NCHW, same seed: "
          "structured axes=(2, 3) bit for bit %s, full-shape (row 8) bit "
          "for bit %s; %s" % (ok[0], ok[1], card_line))
    if not all(ok):
        raise SmokeFailure("layout: a dropout after a channels-last conv "
                           "differs from its NCHW run")


def _layout_deform(seed, limit, fault=False):
    """Phase 18's offset conv -> deformable conv -> ROIAlign block,
    hybridized with the pass, against its eager run: the twin of phase
    18's bit-for-bit check (taken with the pass off)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    gpu = mx.gpu(0)
    _, RoiDeform, _ = _tail_blocks(mx)
    rs = np.random.RandomState(seed + 190)
    mx.random.seed(seed)
    blk = RoiDeform(prefix="rdl_")
    blk.initialize(mx.init.Xavier(), ctx=gpu)
    x = mx.nd.array(rs.normal(0, 1, DEFORM_SHAPE).astype(np.float32),
                    ctx=gpu)
    rois = mx.nd.array(_rcnn_rois(rs, DEFORM_SHAPE[0], ROI_ALIGN_ROIS),
                       ctx=gpu)
    with _no_tf32():
        with cached_op.eager():
            want = blk(x, rois).tensor().clone()
        blk.hybridize(static_alloc=True)
        with layout_opt("1"), _mirrored_kernels(fault):
            for _ in range(3):
                got = blk(x, rois)
            plan = blk._cached_op.layout_plan()
        reading = {"output": _rel(got.tensor(), want)}
    blk._clear_cached_op()
    tag = "offset conv -> deformable conv -> ROIAlign %s hybridized with " \
        "the pass (plan %s) against eager" % (DEFORM_SHAPE, plan)
    if fault:
        tag = "control: " + tag + ", kernels mirrored"
    return reading, _layout_check(tag, reading, limit, planted=fault)


def layout_readings(seeds, card_line):
    """The readings behind LAYOUT_LIMIT at ``seeds`` (print only; each
    limit is twice the largest) and the planted faults' readings."""
    worst = collections.defaultdict(dict)
    faults = collections.defaultdict(dict)

    def note(table, name, reading, pick):
        for k, v in reading.items():
            table[name][k] = pick(table[name].get(k, v), v)
    for seed in seeds:
        r = _layout_resnet(seed, card_line, None, timing=False)
        print("[witness] seed %d, bf16 pass vs eager: by leaf %s; mirrored "
              "kernels: by leaf %s" % (seed, json.dumps(r["groups"]),
                                       json.dumps(r["fault_groups"])))
        _layout_witness(seed)
        got = {"resnet": r["reading"], "resnet_nhwc": r["reading_nhwc"],
               "vgg16": _layout_vgg(seed, None, card_line,
                                    timing=False)["reading"],
               "deform": _layout_deform(seed, None)[0],
               "stem": _layout_stem(seed, card_line, None,
                                    timing=False)["reading"]}
        bad = {"resnet": r["fault"], "resnet_nhwc": r["fault_nhwc"],
               "vgg16": _layout_vgg(seed, None, card_line, fault=True,
                                    timing=False)["reading"],
               "deform": _layout_deform(seed, None, fault=True)[0]}
        for name, reading in got.items():
            note(worst, name, reading, max)
        for name, reading in bad.items():
            note(faults, name, reading, min)
        print("[readings] seed %d: %s" % (seed, json.dumps(got)))
    print("[readings] largest: %s" % json.dumps(worst))
    print("[readings] limits (2x): %s" % json.dumps(
        {n: {k: 2 * v for k, v in r.items()} for n, r in worst.items()}))
    print("[readings] planted faults, smallest: %s" % json.dumps(faults))


def phase_layout(seed, card_line):
    """19. The NHWC layout pass on the hybridized path and the S2D stem:
    the compiled ResNet-50, VGG-16 and phase 18's deformable block with
    the pass against their eager twins, each with a planted fault; timed
    in turns against the pass off, with the cuDNN layout changes of one
    step each way; the stem with MXNET_CONV_S2D on and off; a dropout
    after a channels-last conv bit for bit with NCHW. Returns the kernel
    launches of the compiled ResNet-50's and VGG-16's runs with the pass
    (not their controls')."""
    print("[layout] %s" % card_line)
    t0 = time.perf_counter()
    r = _layout_resnet(seed, card_line, LAYOUT_LIMIT)
    v = _layout_vgg(seed, LAYOUT_LIMIT["vgg16"], card_line)
    vf = _layout_vgg(seed, LAYOUT_LIMIT["vgg16"], card_line, fault=True,
                     timing=False)
    _, d_fail = _layout_deform(seed, LAYOUT_LIMIT["deform"])
    _, d_caught = _layout_deform(seed, LAYOUT_LIMIT["deform"], fault=True)
    s = _layout_stem(seed, card_line, LAYOUT_LIMIT["stem"])
    _layout_dropout(seed, card_line)
    # the sound runs with the pass: the compiled ResNet-50's and VGG-16's
    # steps, each counted from a reset just before it
    counts = collections.Counter(r["counts"])
    counts.update(v["counts"])
    counts = dict(counts)
    print("[layout] kernel launches of the compiled runs with the pass: "
          "resnet50_v1 %s, vgg16 %s (its two dropouts, forward and "
          "backward, in each of %d steps)"
          % (r["counts"] or "none", v["counts"] or "none",
             LAYOUT_VGG_STEPS))
    if r["fail"] or v["fail"] or d_fail or s["fail"]:
        raise SmokeFailure("layout: a run with the pass (or the S2D stem) "
                           "is beyond its limit")
    if LAYOUT_LIMIT["vgg16"] is not None and not (vf["fail"] and d_caught):
        raise SmokeFailure("control: the VGG-16 or deformable layout check "
                           "passed mirrored kernels")
    if not counts.get("dropout"):
        raise SmokeFailure("layout: VGG-16's steps launched no dropout "
                           "kernel")
    print("[layout] phase 19 took %.1f s; %s"
          % (time.perf_counter() - t0, card_line))
    return counts


# ---------------------------------------------------------------------------
# 20. the dependency engine: nd.Custom on engine workers, NaiveEngine
# ---------------------------------------------------------------------------
ENGINE_SLOW_S = 0.5       # the slow custom op's host work
ENGINE_MAIN_MATMULS = 300  # the main stream's work beside it: bf16 matmuls
ENGINE_MATMUL_SIDE = 8192


def _engine_ops(mx):
    """The phase's custom ops, registered once: ``engine_slow`` (host work
    of ENGINE_SLOW_S seconds, then x * 2 on its worker's stream) and
    ``engine_boom`` (raises)."""
    from mxnet_tpu_torch import operator as op_mod
    if op_mod.get_prop("engine_slow") is not None:
        return

    class Slow(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            time.sleep(ENGINE_SLOW_S)
            self.assign(out_data[0], req[0], in_data[0] * 2)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 2)

    @mx.operator.register("engine_slow")
    class SlowProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Slow()

    class Boom(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            raise RuntimeError("planted failure in a custom op's forward")

        def backward(self, *a, **kw):
            pass

    @mx.operator.register("engine_boom")
    class BoomProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Boom()


def _engine_mnist(seed, mod, card_line):
    """The MNIST MLP with its rtc custom op (phase 9's net), three SGD
    steps with ``nd.Custom`` on the engine's workers against the same
    steps with the callback inline, bit for bit."""
    from unittest import mock
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import operator as op_mod
    register_rtc_relu(mx, mod)
    data, label = (a[:MNIST_BATCH]
                   for a in mnist_synthetic(6 * MNIST_BATCH)[:2])
    runs = {}
    for how in ("engine", "inline"):
        net, trainer, loss_fn = _mnist_one(mx, seed)
        x = mx.nd.array(data, ctx=mx.gpu(0))
        y = mx.nd.array(label, ctx=mx.gpu(0))
        # the inline callback is the one a hybridized call runs
        patch = mock.patch.object(op_mod._cached_op, "in_call",
                                  lambda: True) if how == "inline" \
            else contextlib.nullcontext()
        losses = []
        with patch:
            for _ in range(3):
                with mx.autograd.record():
                    out = net(x)
                    loss = loss_fn(out, y)
                loss.backward()
                trainer.step(MNIST_BATCH)
                losses.append(loss.tensor().detach().clone())
        torch.cuda.synchronize()
        runs[how] = (losses, {n: p.data().tensor().detach().clone()
                              for n, p in net.collect_params().items()})
    same = all(torch.equal(a, b) for a, b in zip(runs["engine"][0],
                                                 runs["inline"][0])) and \
        all(torch.equal(runs["engine"][1][n], runs["inline"][1][n])
            for n in runs["inline"][1])
    print("[engine] MNIST MLP (rtc_relu custom op), 3 SGD steps at batch "
          "%d: nd.Custom on the engine's workers bit for bit with the "
          "inline callback %s; %s" % (MNIST_BATCH, same, card_line))
    if not same:
        raise SmokeFailure("engine: the engine-gated custom op differs "
                           "from the inline one")


def _mnist_one(mx, seed):
    """Phase 9's MLP with the custom op on the card, initialised from
    ``seed``: (net, trainer, loss)."""
    net = mnist_mlp(mx, True)
    mx.random.seed(seed)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net(mx.nd.zeros((1, 1, 28, 28), ctx=mx.gpu(0)))   # the deferred shapes
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    return net, trainer, mx.gluon.loss.SoftmaxCrossEntropyLoss()


def _engine_overlap(card_line):
    """A slow custom op (ENGINE_SLOW_S of host work, then its output on
    its worker's stream) beside ENGINE_MAIN_MATMULS bf16 matmuls on the
    main stream: wall time of both against the sum of each alone."""
    import torch
    import mxnet_tpu_torch as mx
    a = torch.randn(ENGINE_MATMUL_SIDE, ENGINE_MATMUL_SIDE, device=DEV,
                    dtype=torch.bfloat16)
    x = mx.nd.array(torch.arange(4096, dtype=torch.float32), ctx=mx.gpu(0))

    def main_work():
        c = a
        for _ in range(ENGINE_MAIN_MATMULS):
            c = a @ a
        return c

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    main_work()
    mx.nd.Custom(x, op_type="engine_slow").wait_to_read()
    t_main = timed(main_work)
    t_op = timed(lambda: mx.nd.Custom(x, op_type="engine_slow")
                 .wait_to_read())
    box = {}

    def both():
        y = mx.nd.Custom(x, op_type="engine_slow")
        main_work()
        box["y"] = y.asnumpy()
    t_both = timed(both)
    right = bool((box["y"] == torch.arange(4096).numpy() * 2).all())
    print("[engine] a slow custom op (%.2f s of host work) beside %d "
          "(%d^2) bf16 matmuls on the main stream: %.3f s together, "
          "%.3f s + %.3f s = %.3f s apart (%.0f%% of the sum); its output "
          "right %s; %s" % (ENGINE_SLOW_S, ENGINE_MAIN_MATMULS,
                            ENGINE_MATMUL_SIDE, t_both,
                            t_op, t_main, t_op + t_main,
                            100 * t_both / (t_op + t_main), right,
                            card_line))
    if not right or t_both > 0.75 * (t_op + t_main):
        raise SmokeFailure("engine: the custom op's callback did not "
                           "overlap the main stream's work, or its output "
                           "is wrong")
    return {"together_s": t_both, "op_s": t_op, "main_s": t_main}


def _engine_boom(card_line):
    """An exploding custom op: the call returns, the error raises at
    wait_to_read with its message, and the context computes after it."""
    import torch
    import mxnet_tpu_torch as mx
    x = mx.nd.array(torch.ones(1024), ctx=mx.gpu(0))
    t0 = time.perf_counter()
    y = mx.nd.Custom(x, op_type="engine_boom")
    call_s = time.perf_counter() - t0
    try:
        y.wait_to_read()
        raised = None
    except RuntimeError as e:
        raised = str(e)
    z = (x * 3).sum().asscalar()
    ok = raised is not None and "planted failure" in raised and \
        "custom_op:engine_boom" in raised and z == 3072.0
    print("[engine] exploding custom op: the call returned in %.2f ms, "
          "raised at wait_to_read: %r; the context computes after it "
          "(sum 3 x 1024 ones = %s) %s; %s"
          % (call_s * 1e3, (raised or "nothing")[:90], z,
             "ok" if ok else "FAIL", card_line))
    if not ok:
        raise SmokeFailure("engine: the exploding custom op did not raise "
                           "at the wait, or the context died")


def _engine_naive(sess, reqs, card_line):
    """The served BERT-base (8, 128) request and one eager ResNet-50
    step (f32, SGD) under NaiveEngine against the default engine, bit for
    bit, each timed both ways."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op, engine
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    eng = engine.engine()
    req = reqs[0]
    mx.random.seed(0)
    net = resnet50_v1(prefix="resnet50n_")
    net.initialize(init=mx.init.MSRAPrelu(), ctx=mx.gpu(0))
    g = torch.Generator(device=DEV).manual_seed(43)
    x = mx.nd.NDArray(torch.randn(RESNET_BATCH, 3, RESNET_SIDE, RESNET_SIDE,
                                  generator=g, device=DEV))
    y = mx.nd.NDArray(torch.randint(0, 1000, (RESNET_BATCH,), generator=g,
                                    device=DEV).float())
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = net.collect_params()
    with torch.no_grad():
        net(x)
    snap = _snapshot(params)

    def serve():
        outs = sess.infer(*req)
        torch.cuda.synchronize()
        return outs

    def resnet_step():
        _restore(params, snap)
        for p in params.values():
            if p.grad_req != "null":
                p.zero_grad()
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        torch.cuda.synchronize()
        return loss.tensor().clone(), {n: p.grad().tensor().clone()
                                       for n, p in params.items()
                                       if p.grad_req != "null"}
    res, ms = {}, {}
    with cached_op.eager(), _deterministic():
        serve()
        resnet_step()                     # cuDNN's algorithm choices
        for naive in (False, True, True, False):
            eng.set_naive(naive)
            try:
                t0 = time.perf_counter()
                s = serve()
                t1 = time.perf_counter()
                r = resnet_step()
                t2 = time.perf_counter()
            finally:
                eng.set_naive(False)
            res.setdefault(naive, (s, r))
            ms.setdefault(naive, []).append(((t1 - t0) * 1e3,
                                             (t2 - t1) * 1e3))

    def flat(s):
        return s if isinstance(s, (list, tuple)) else [s]
    serve_same = all(np.array_equal(a, b) for a, b in zip(
        flat(res[True][0]), flat(res[False][0])))
    (l1, g1), (l0, g0) = res[True][1], res[False][1]
    step_same = torch.equal(l1, l0) and all(torch.equal(g1[n], g0[n])
                                            for n in g0)
    med = {k: (statistics.median(v[0] for v in ms[k]),
               statistics.median(v[1] for v in ms[k])) for k in ms}
    print("[engine] NaiveEngine (every op and new array synchronises its "
          "stream) against the default: served BERT-base (8, 128) bit for "
          "bit %s, %.2f ms naive vs %.2f ms; one eager ResNet-50 step "
          "(batch %d, f32) loss and gradients bit for bit %s, %.2f ms "
          "naive vs %.2f ms (host clock, medians of 2, in turns); %s"
          % (serve_same, med[True][0], med[False][0], RESNET_BATCH,
             step_same, med[True][1], med[False][1], card_line))
    if not (serve_same and step_same):
        raise SmokeFailure("engine: NaiveEngine changed a result")
    return med


def phase_engine(seed, mod, sess, reqs, card_line):
    """20. The dependency engine built from csrc/engine.cc; the MNIST MLP
    with its custom op through the engine bit for bit with the inline
    callback; a slow custom op overlapping the main stream; an exploding
    one raising at the wait; the served BERT-base and an eager ResNet-50
    step under NaiveEngine. Returns the kernel launches of its runs."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import native
    from mxnet_tpu_torch.ops import cuda_build
    print("[engine] %s" % card_line)
    t0 = time.perf_counter()
    path, compiled = native.build_engine()
    t1 = time.perf_counter()
    lib = native.load_engine_lib()
    import ctypes
    ver = ctypes.c_int(0)
    lib.MXGetVersion(ctypes.byref(ver))
    print("[engine] built %s from mxnet_tpu_torch/csrc/engine.cc with g++ "
          "in %.2f s (compiled %s), MXGetVersion %d" % (
              path, t1 - t0, compiled, ver.value))
    _engine_ops(mx)
    cuda_build.reset_launch_counts()
    _engine_mnist(seed, mod, card_line)
    _engine_overlap(card_line)
    _engine_boom(card_line)
    _engine_naive(sess, reqs, card_line)
    counts = {k: n for k, n in cuda_build.launch_counts().items() if n}
    print("[engine] kernel launches in phase 20: %s" % counts)
    rtc = [k for k in counts if k.startswith("rtc:")]
    if not rtc or not counts.get("layer_norm_fwd") or \
            not counts.get("selfatt_fwd"):
        raise SmokeFailure("engine: phase 20 launched no rtc, LayerNorm or "
                           "attention kernel: %s" % counts)
    print("[engine] phase 20 took %.1f s; %s"
          % (time.perf_counter() - t0, card_line))
    return counts


# ---------------------------------------------------------------------------
# 21. services: telemetry, profiler, compilewatch, modelwatch, checkpoints,
# through Estimator.fit
# ---------------------------------------------------------------------------
# BERT pretraining's masked tokens: max_predictions_per_seq at 128 tokens,
# the [MASK] id of the uncased BERT-base vocabulary
SERVICES_MASKED = 20
SERVICES_MASK_ID = 103
SERVICES_EPOCHS = 2
SERVICES_BATCHES = 4                 # batches an epoch
SERVICES_SGD = {"learning_rate": 1e-3, "momentum": 0.9}
# steps before a step only replays graphs: the eager warm-up, the classic
# step that arms the fused update, its first (eager) fused step
SERVICES_WARM = 3
SERVICES_SMALL_LAYERS = 2
SERVICES_TURN_STEPS = 4
SERVICES_TURNS = 3
# the device-trace names of rows 1-8: the kernels' own names, and the
# epilogue's template argument for the two bias_fwd_kernel instances
SERVICES_DEVICE_NAMES = {
    "layer_norm_fwd": ("layer_norm_fwd_rows", "layer_norm_fwd_chunked"),
    "layer_norm_bwd": ("layer_norm_bwd_rows", "layer_norm_bwd_chunked"),
    "selfatt_fwd": ("selfatt_fwd_kernel",),
    "selfatt_bwd": ("selfatt_bwd_q_kernel", "selfatt_bwd_kv_kernel"),
    "bias_gelu_fwd": ("bias_gelu_fwd",),
    "bias_gelu_bwd": ("bias_gelu_bwd_kernel",),
    "bias_residual_fwd": ("bias_residual_fwd",),
    "dropout": ("dropout_kernel",),
}
SERVICES_PHASES = ("data", "forward", "backward", "fused_step",
                   "modelwatch")


def services_mlm(mx, bert):
    """BERT with its dense MLM head as one HybridBlock over token ids:
    ``data`` is (batch, seq + masked) int32, the ids then the masked
    positions; the hidden states of those positions (a one-hot batch_dot,
    exact) go through the head's transform, LayerNorm and vocabulary
    projection (``BERTMLMLoss(mode="dense")``'s parameters, by name);
    returns the logits (batch, masked, vocab)."""
    nn = mx.gluon.nn
    seq, masked, vocab, units = TRAIN_SEQ, SERVICES_MASKED, VOCAB, UNITS

    class ServicesMLM(mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self._dtype = "float32"
            self.bert = bert
            with self.name_scope():
                self.transform = nn.Dense(units, flatten=False,
                                          in_units=units,
                                          prefix="transform_")
                self.layer_norm = nn.LayerNorm(in_channels=units)
                self.head_weight = self.params.get(
                    "head_weight", shape=(vocab, units))
                self.head_bias = self.params.get(
                    "head_bias", shape=(vocab,), init="zeros")

        def cast(self, dtype):
            super().cast(dtype)
            self._dtype = dtype

        def hybrid_forward(self, F, data, head_weight, head_bias):
            ids = F.slice_axis(data, axis=1, begin=0, end=seq)
            pos = F.slice_axis(data, axis=1, begin=seq, end=seq + masked)
            out = self.bert(ids, F.zeros_like(ids))
            hidden = out[0] if isinstance(out, (list, tuple)) else out
            sel = F.Cast(F.one_hot(pos, depth=seq), dtype=self._dtype)
            h = self.layer_norm(self.transform(F.batch_dot(sel, hidden)))
            return F.FullyConnected(h, head_weight, head_bias,
                                    num_hidden=vocab, flatten=False)
    return ServicesMLM(prefix="decoder_")


def services_data(seed, rows):
    """Token batches as BERT pretraining masks them, from ``seed``: ids
    drawn over the vocabulary past the special tokens, ``masked`` sorted
    positions a row replaced by [MASK]; returns (data (rows, seq +
    masked) int32, labels (rows, masked) f32: the original ids)."""
    import numpy as np
    seq, masked, vocab = TRAIN_SEQ, SERVICES_MASKED, VOCAB
    rng = np.random.RandomState(seed + 21)
    ids = rng.randint(1000, vocab, (rows, seq)).astype(np.int32)
    pos = np.sort(np.stack([rng.choice(np.arange(1, seq), masked,
                                       replace=False)
                            for _ in range(rows)]), axis=1).astype(np.int32)
    labels = np.take_along_axis(ids, pos, axis=1).astype(np.float32)
    np.put_along_axis(ids, pos, SERVICES_MASK_ID, axis=1)
    return np.concatenate([ids, pos], axis=1), labels


def _build_services(seed, layers=12, dropout=0.1):
    """bert_12_768_12 (or ``layers`` of it) at full width and the MLM
    head as ``_build_train`` builds them: initialized on gpu(0), biases,
    beta and gamma - 1 drawn from the seed, cast to bf16; hybridized with
    static_alloc, as is the loss."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel
    mx.random.seed(seed)
    bert = BERTModel(num_layers=layers, units=UNITS, hidden_size=HIDDEN,
                     num_heads=HEADS, max_length=512, vocab_size=VOCAB,
                     dropout=dropout, use_pooler=False,
                     use_classifier=False, use_decoder=False)
    net = services_mlm(mx, bert)
    net.initialize()
    data, _ = services_data(seed, 2)
    with torch.no_grad():
        net(mx.nd.array(data, dtype="int32"))
    _draw_affine(net, seed)
    net.cast("bfloat16")
    net.hybridize(static_alloc=True)
    loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    loss.hybridize(static_alloc=True)
    return net, loss


class _KeptLoss:
    """The loss block, keeping each step's per-sample loss (a clone on
    the card, no host read) and counting the steps."""

    def __init__(self, loss, state=None):
        self.loss, self.vals, self.state = loss, [], state

    def __call__(self, pred, label):
        out = self.loss(pred, label)
        self.vals.append(out.tensor().detach().clone())
        if self.state is not None:
            self.state["step"] += 1
        return out


def _tokens_metric(mx):
    """A metric that reads nothing from the card: the tokens predicted."""
    class Tokens(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("tokens")

        def update(self, labels, preds):
            for label in labels:
                self.sum_metric += label.size
                self.num_inst += 1
    return Tokens()


def _services_fit(seed, net, loss, epochs, prefix=None, trainer=None,
                  resume=None, state=None, data=None):
    """Estimator.fit over SERVICES_BATCHES batches of 32 a epoch from a
    DataLoader; returns (kept losses, estimator, trainer)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.contrib.estimator import Estimator
    data, labels = data or services_data(seed,
                                         SERVICES_BATCHES * TRAIN_BATCH)
    loader = mx.gluon.data.DataLoader(
        mx.gluon.data.ArrayDataset(data, labels), batch_size=TRAIN_BATCH)
    if trainer is None:
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(SERVICES_SGD))
    kept = _KeptLoss(loss, state)
    est = Estimator(net, kept, train_metrics=[_tokens_metric(mx)],
                    trainer=trainer)
    est.fit(loader, epochs=epochs, ckpt_prefix=prefix, resume=resume)
    return kept.vals, est, trainer


def _momenta(trainer):
    """The SGD momenta by parameter index (clones)."""
    out = {}
    for i, st in trainer._updater.states.items():
        if st is not None:
            out[i] = st.tensor().detach().clone()
    return out


def _bits(t):
    """``t``'s bits as integers (NaNs and signed zeros compare exactly)."""
    import torch
    t = t.detach().contiguous()
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _bits_equal(tag, got, want):
    """Every tensor of ``got`` bit for bit with ``want``'s (dicts or
    lists, on one device); returns the count compared."""
    import torch
    items = (list(enumerate(want)) if isinstance(want, list)
             else list(want.items()))
    if len(got) != len(items):
        raise SmokeFailure("services: %s: %d arrays against %d"
                           % (tag, len(got), len(items)))
    for k, w in items:
        g = got[k]
        if g.shape != w.shape or g.dtype != w.dtype or \
                not torch.equal(_bits(g), _bits(w)):
            raise SmokeFailure("services: %s differs at %s" % (tag, k))
    return len(items)


def _struct_snapshot(net):
    """Clones of the parameters by structural name (the checkpoint's
    keys)."""
    return {n: p.data().tensor().detach().clone()
            for n, p in net._structural_params().items()}


@contextlib.contextmanager
def _sync_regions(state):
    """Synchronising CUDA calls on the calling thread under
    ``torch.cuda.set_sync_debug_mode("warn")``, each recorded as
    (step, region) from ``state`` (kept by the wrappers of the run)."""
    import threading
    import warnings
    import torch
    seen = []
    me = threading.get_ident()
    real = warnings.showwarning

    def show(message, *a, **kw):
        if "synchronizing CUDA operation" in str(message):
            if threading.get_ident() == me:
                seen.append((state["step"], state["region"]))
            return
        return real(message, *a, **kw)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield seen
        finally:
            torch.cuda.set_sync_debug_mode(0)


@contextlib.contextmanager
def _regions(state, trainer):
    """Mark the run's regions for ``_sync_regions``: inside
    ``Trainer.step``, inside a checkpoint's save (the states blob and
    ``save_checkpoint``), else the loop."""
    from unittest import mock
    import mxnet_tpu_torch as mx

    def wrap(fn, region):
        def inner(*a, **kw):
            prev = state["region"]
            state["region"] = region
            try:
                return fn(*a, **kw)
            finally:
                state["region"] = prev
        return inner
    with mock.patch.object(trainer, "step", wrap(trainer.step, "step")), \
            mock.patch.object(trainer, "states_blob",
                              wrap(trainer.states_blob, "ckpt")), \
            mock.patch.object(mx.model, "save_checkpoint",
                              wrap(mx.model.save_checkpoint, "ckpt")):
        yield


def _services_env(on):
    """MXNET_TELEMETRY and MXNET_MODELWATCH on or off, read anew."""
    import mxnet_tpu_torch as mx
    for var in ("MXNET_TELEMETRY", "MXNET_MODELWATCH"):
        if on:
            os.environ[var] = "1"
        else:
            os.environ.pop(var, None)
    mx.telemetry.refresh()
    mx.telemetry.reset()
    mx.compilewatch.reset()
    mx.modelwatch.reset()


def _device_rows(events):
    """Device events of rows 1-8 by kernel, and their device ms."""
    out = {}
    for e in events:
        for k, frags in SERVICES_DEVICE_NAMES.items():
            if any(f in e["name"] for f in frags):
                n, ms = out.get(k, (0, 0.0))
                out[k] = (n + 1, ms + e["dur"] / 1e3)
    return out


def _services_main(seed, tmp, card_line):
    """(a)-(c): the main run with every service on, checked, and its
    twin with every service off. Returns the kernel launches of the
    main run (executed: eager and captured launches, less those only
    recorded into graphs, plus those the replays carry)."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    _services_env(True)
    net, loss = _build_services(seed)
    params = net.collect_params()
    n_params = sum(p.data().size for p in params.values())
    trace = os.path.join(tmp, "services_trace.json")
    mx.profiler.set_config(filename=trace, profile_device=True)
    prefix = os.path.join(tmp, "bert")
    state = {"step": 0, "region": "loop"}
    by_graph = {}
    trainer = mx.gluon.Trainer(params, "sgd", dict(SERVICES_SGD))
    torch.cuda.synchronize()
    print("[services] bert_12_768_12 (dropout 0.1) + the dense MLM head at "
          "%d masked positions, %d parameters, bf16, hybridized "
          "(static_alloc), built from seed %d in %.1f s; SGD momentum 0.9 "
          "through Estimator.fit, %d epochs of %d batches of %d x %d, "
          "MXNET_TELEMETRY=1 MXNET_MODELWATCH=1, the profiler on with "
          "profile_device=True" % (
              SERVICES_MASKED, n_params, seed, time.perf_counter() - t0,
              SERVICES_EPOCHS, SERVICES_BATCHES, TRAIN_BATCH, TRAIN_SEQ))
    warm_programs = {}
    real_mark = mx.telemetry.mark_step

    def mark(*a, **kw):
        real_mark(*a, **kw)
        if state["step"] == SERVICES_WARM:
            warm_programs["n"] = len(mx.compilewatch.programs())
    cuda_build.reset_launch_counts()
    from unittest import mock
    t_run = time.perf_counter()
    with _capture_launches(by_graph) as captured, \
            _replayed_launches(by_graph) as replayed, \
            mock.patch.object(mx.telemetry, "mark_step", mark), \
            _regions(state, trainer), _sync_regions(state) as syncs:
        mx.profiler.set_state("run")
        try:
            losses, est, _ = _services_fit(seed, net, loss, SERVICES_EPOCHS,
                                           prefix=prefix, trainer=trainer,
                                           state=state)
        finally:
            mx.profiler.set_state("stop")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launched = cuda_build.launch_counts()
    executed = {k: launched[k] - captured.get(k, 0) + replayed.get(k, 0)
                for k in cuda_build.KERNELS}
    mx.profiler.dump(reset=True)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    snap = mx.telemetry.snapshot()
    programs = mx.compilewatch.programs()
    mw = trainer.modelwatch
    kept = {"losses": losses, "params": _struct_snapshot(net),
            "momenta": _momenta(trainer)}

    # (b) the checks on the main run
    steps = int(snap["counters"].get("mx_steps_total", 0))
    if steps != SERVICES_EPOCHS * SERVICES_BATCHES:
        raise SmokeFailure("services: mx_steps_total %s, expected %d"
                           % (steps, SERVICES_EPOCHS * SERVICES_BATCHES))
    later = programs[warm_programs.get("n", len(programs)):]
    recaptures = sum(v for k, v in snap["counters"].items()
                     if k.startswith("mx_recaptures_total"))
    print("[services] compilewatch: %d programs (%s), %d recorded after "
          "step %d, recaptures %d" % (
              len(programs), ", ".join("%s %s" % (r["fn"], r["kind"])
                                       for r in programs),
              len(later), SERVICES_WARM, recaptures))
    if later or recaptures:
        raise SmokeFailure("services: programs recorded or recaptured after "
                           "warm-up: %s" % [(r["fn"], r["kind"])
                                            for r in later])
    per_step = collections.Counter(s for s, r in syncs if r == "step")
    loop = collections.Counter(s for s, r in syncs if r == "loop")
    ckpt = sum(1 for s, r in syncs if r == "ckpt")
    steady = range(SERVICES_WARM + 1, steps + 1)
    print("[services] host reads (synchronising calls on the step's thread) "
          "by step inside Trainer.step %s, in the loop outside it %s, in "
          "the checkpoints' saves %d; modelwatch host reads %d over %d "
          "samples" % (dict(sorted(per_step.items())),
                       dict(sorted(loop.items())), ckpt, mw.sync_count,
                       mw.samples))
    if mw.samples != steps or mw.sync_count != steps or \
            any(per_step[s] != 1 or loop[s] for s in steady):
        raise SmokeFailure("services: a sampled steady step did not make "
                           "exactly one host read")

    # the epoch-1 checkpoint, checked below against the twin's epoch-1
    # parameters
    arg1, _ = mx.model.load_params(prefix, 1)
    man = mx.model.checkpoint_entry(prefix, 2)
    print("[services] checkpoints: %s, the manifest's epoch 2 entry %s" % (
        sorted(f for f in os.listdir(tmp) if f.startswith("bert")),
        {k: v for k, v in man.items() if k not in ("time",)}))

    # the trace
    names = collections.Counter(e["name"] for e in events)
    missing = [p for p in SERVICES_PHASES if not names.get("step::" + p)]
    engine_ops = [n for n in names if n.startswith(
        "engine::checkpoint_write:")]
    dev = [e for e in events if str(e.get("cat", "")).startswith("device::")]
    rows = _device_rows(dev)
    host = [e for e in events if e.get("ph") == "X" and
            not str(e.get("cat", "")).startswith("device::")]
    h0 = min(e["ts"] for e in host)
    h1 = max(e["ts"] + e["dur"] for e in host)
    d0 = min(e["ts"] for e in dev) if dev else float("nan")
    d1 = max(e["ts"] + e["dur"] for e in dev) if dev else float("nan")
    unaligned = sum(1 for e in dev if e["args"].get("clock"))
    print("[services] trace: %d events (%d device events, %d on an unaligned "
          "clock, moved %.1f us for kernel-after-launch), host span %.1f ms, "
          "device span [%+.1f, %+.1f] ms from the host's start; phases %s; "
          "engine checkpoint ops %s; rows 1-8 in the device trace (kernels, "
          "device ms): %s" % (
              len(events), len(dev), unaligned,
              mx.profiler.device_clock_shift(), (h1 - h0) / 1e3,
              (d0 - h0) / 1e3, (d1 - h0) / 1e3,
              {p: names.get("step::" + p, 0) for p in SERVICES_PHASES},
              sorted(engine_ops), {k: (n, round(ms, 3))
                                   for k, (n, ms) in sorted(rows.items())}))
    # the device events lie inside the host's span: the first kernels
    # follow the profiler's start, the last end within 100 ms of the
    # last host event (the queue the host runs ahead by)
    faults = [what for what, bad in (
        ("phases %s" % missing, missing),
        ("the engine's checkpoint ops", len(engine_ops) < 2 * SERVICES_EPOCHS),
        ("rows %s" % sorted(set(SERVICES_DEVICE_NAMES) - set(rows)),
         sorted(rows) != sorted(SERVICES_DEVICE_NAMES)),
        ("the device events on the host clock", unaligned or not (
            h0 - 5e4 <= d0 and d1 <= h1 + 1e5))) if bad]
    if faults:
        raise SmokeFailure("services: the trace lacks %s" % faults)
    absent = [k for k in SERVICES_DEVICE_NAMES if not executed.get(k)]
    print("[services] kernel launches of the run (executed: eager, plus "
          "those the graph replays carry): %s" % {
              k: v for k, v in executed.items() if v})
    if absent:
        raise SmokeFailure("services: the main run launched no %s" % absent)

    # (c) what the services read
    phases = {mx.telemetry.parse_metric_key(k)[1]["phase"]: v["p50"] * 1e3
              for k, v in snap["histograms"].items()
              if k.startswith("mx_step_phase_seconds")}
    step_p50 = snap["histograms"]["mx_step_seconds"]["p50"] * 1e3
    by_fn = collections.defaultdict(float)
    for r in programs:
        if r["kind"] != "recapture" and r["flops"]:
            by_fn[r["fn"]] += r["flops"]
    replay_flops = by_fn["CachedOp.fwd_vjp"] + by_fn["autograd.fused_step"]
    graph_mb = sum(r["bytes"].get("graph_reserved", 0)
                   for r in programs) / 1e6
    graph_alloc = sum(r["bytes"].get("graph_allocated", 0)
                      for r in programs) / 1e6
    capture_s = sum(r["stages"].get("capture", 0.0) for r in programs)
    warmup_s = sum(r["stages"].get("warmup", 0.0) for r in programs)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print("[services] phase p50s (ms, host dispatch): %s; step p50 %.2f ms "
          "(bucket bound)" % ({k: round(v, 3) for k, v in
                               sorted(phases.items())}, step_p50))
    print("[services] mx_mfu %.4f, mx_goodput %.4f (over the run's %d "
          "steps, warm-up and compile included; peak %.4g FLOP/s for %s)"
          % (snap["gauges"].get("mx_mfu", float("nan")),
             snap["gauges"].get("mx_goodput", float("nan")), steps,
             mx.telemetry.peak_flops(), card_line))
    print("[services] FLOPs of one steady step (FlopCounterMode over the "
          "warm-ups: the forward graph %.4g, the fused backward+update "
          "%.4g) %.4g, against 6 x %d parameters x %d tokens = %.4g "
          "(ratio %.3f)" % (by_fn["CachedOp.fwd_vjp"],
                             by_fn["autograd.fused_step"], replay_flops,
                             n_params, tokens, 6.0 * n_params * tokens,
                             replay_flops / (6.0 * n_params * tokens)))
    print("[services] graphs: their captures took %.1f MB more allocated "
          "and %.1f MB more reserved from the caching allocator, capture "
          "%.2f s, warm-up %.2f s; the run took %.1f s" % (
              graph_alloc, graph_mb, capture_s, warmup_s, run_s))
    if not replay_flops or (DEV == "cuda" and not graph_alloc):
        raise SmokeFailure("services: compilewatch recorded no FLOPs or no "
                           "graph memory")
    return net, loss, trainer, kept, arg1, executed, (replay_flops, n_params)


def _services_twin(seed, kept, arg1, card_line):
    """The same run with every service off, in two fit calls (the epoch-1
    parameters between them): losses, parameters and momenta bit for bit
    with the main run, and the main run's epoch-1 checkpoint bit for bit
    with the epoch-1 parameters."""
    import torch
    import mxnet_tpu_torch as mx
    _services_env(False)
    net, loss = _build_services(seed)
    params = net.collect_params()
    trainer = mx.gluon.Trainer(params, "sgd", dict(SERVICES_SGD))
    l1, _, _ = _services_fit(seed, net, loss, 1, trainer=trainer)
    epoch1 = _struct_snapshot(net)
    l2, _, _ = _services_fit(seed, net, loss, 1, trainer=trainer)
    torch.cuda.synchronize()
    n = _bits_equal("the losses", l1 + l2, kept["losses"])
    n += _bits_equal("the parameters", _struct_snapshot(net),
                     kept["params"])
    n += _bits_equal("the momenta", _momenta(trainer), kept["momenta"])
    ckpt = {k: v.tensor().to(epoch1[k].device) for k, v in arg1.items()}
    m = _bits_equal("the epoch-1 checkpoint", ckpt, epoch1)
    print("[services] services on against off: %d losses, parameters and "
          "momenta bit for bit; the epoch-1 checkpoint (written while epoch "
          "2 updated the weights in place) bit for bit with the epoch-1 "
          "parameters (%d arrays)" % (n, m))
    return net, loss, trainer


def _services_turns(net, loss, trainer, seed, card_line, step_flops):
    """The steady step with every service off, with telemetry on, and
    with telemetry and modelwatch on, in turns (off, telemetry, both,
    both, telemetry, off), on the host clock around a synchronised card:
    median ms of SERVICES_TURN_STEPS steps. Returns {arm: ms}."""
    import torch
    import mxnet_tpu_torch as mx
    data, labels = services_data(seed + 1, TRAIN_BATCH)
    x = mx.nd.array(data, dtype="int32")
    y = mx.nd.array(labels)
    mw = mx.modelwatch.ModelWatch()
    arms = ("off", "telemetry", "telemetry+modelwatch")

    def steps(arm):
        mx.telemetry.enable(arm != "off")
        trainer.modelwatch = mw if arm == arms[2] else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVICES_TURN_STEPS):
            with mx.autograd.record():
                out = loss(net(x), y)
            out.backward()
            trainer.step(TRAIN_BATCH)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / SERVICES_TURN_STEPS
    for arm in arms:
        steps(arm)
    times = {arm: [] for arm in arms}
    for _ in range(SERVICES_TURNS):
        for arm in arms + arms[::-1]:
            times[arm].append(steps(arm))
    med = {arm: statistics.median(v) for arm, v in times.items()}
    peak = mx.telemetry.peak_flops()
    print("[services] steady step (medians of %d turns of %d steps, in "
          "turns): %s; over off: %s; the step's FlopCounterMode FLOPs over "
          "its time and the peak (MFU): %s; %s" % (
              2 * SERVICES_TURNS, SERVICES_TURN_STEPS,
              ", ".join("%s %.3f ms" % (a, med[a]) for a in arms),
              ", ".join("%s %+.2f%%" % (a, 100 * (med[a] - med["off"])
                                        / med["off"]) for a in arms[1:]),
              ", ".join("%s %.4f" % (a, step_flops / (med[a] / 1e3) / peak)
                        for a in arms) if peak else "no peak",
              card_line))
    mx.telemetry.enable(False)
    trainer.modelwatch = None
    return med


def _services_small(seed, tmp, card_line):
    """(d) At SERVICES_SMALL_LAYERS layers and full width: scaled_grad
    named as an exploding layer, nan_grad under skip_step counted and
    debited, a raising guard's crash bundle, ckpt_write at the wait, and
    fit(resume=True) past a truncated newest checkpoint bit for bit with
    the uninterrupted run (dropout 0 there: a resumed run starts a new
    random stream)."""
    from unittest import mock
    import mxnet_tpu_torch as mx
    data = services_data(seed, 2 * TRAIN_BATCH)
    x = mx.nd.array(data[0][:TRAIN_BATCH], dtype="int32")
    y = mx.nd.array(data[1][:TRAIN_BATCH])

    def trained(guard=None, plant=None, at=None, steps=10, fused="0"):
        _services_env(True)
        os.environ["MXNET_TRAINER_FUSED_UPDATE"] = fused
        try:
            net, loss = _build_services(seed, SERVICES_SMALL_LAYERS)
            tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                                  dict(SERVICES_SGD))
            if guard is not None:
                tr.grad_guard = mx.guardrails.GradGuard(nonfinite=guard)
            marks = []
            real = mx.telemetry.mark_step
            with mock.patch.object(
                    mx.telemetry, "mark_step",
                    lambda *a, **kw: (marks.append(kw.get("useful", True)),
                                      real(*a, **kw))[1]):
                for i in range(steps):
                    if i == at:
                        mx.faultinject.set_fault(plant, 1.0, max_fires=1)
                    with mx.autograd.record():
                        out = loss(net(x), y)
                    out.backward()
                    tr.step(TRAIN_BATCH)
        finally:
            mx.faultinject.clear()
            os.environ.pop("MXNET_TRAINER_FUSED_UPDATE", None)
        return tr, marks

    # scaled_grad: the last gradient x 1e4 at step 10, after the z-score's
    # history of 8 samples
    tr, _ = trained(plant="scaled_grad", at=9)
    anomalies = [(a["kind"], a["param"], a["step"]) for a in
                 mx.modelwatch.recent_anomalies()]
    last = [p.name for p in tr._params if p.grad_req != "null"][-1]
    dead = [a for a in anomalies if a[0] == "dead"]
    print("[services] %d layers: scaled_grad at step 10 -> modelwatch's "
          "exploding layers %s (the last gradient is %s); %d layers named "
          "dead (their bf16 weights did not move under the SGD update, "
          "first at step %s)" % (
              SERVICES_SMALL_LAYERS, [a for a in anomalies
                                      if a[0] != "dead"], last, len(dead),
              min([a[2] for a in dead], default=None)))
    if ("exploding", last, 10) not in anomalies:
        raise SmokeFailure("services: scaled_grad was not named as an "
                           "exploding layer")
    # nan_grad under skip_step
    tr, marks = trained(guard="skip_step", plant="nan_grad", at=4, steps=6)
    counters = mx.telemetry.snapshot()["counters"]
    gp = mx.telemetry.snapshot()["gauges"].get("mx_goodput")
    got = (counters.get('mx_guard_events_total{kind="skip"}'),
           counters.get('mx_guard_events_total{kind="nonfinite"}'),
           counters.get('mx_fault_injections_total{site="nan_grad"}'),
           marks.count(False), tr.grad_guard.skipped_steps)
    print("[services] nan_grad at step 5 under skip_step: guard events "
          "skip %s, nonfinite %s; fault fires %s; steps marked not useful "
          "%d; skipped %d; mx_goodput %.4f" % (got + (gp,)))
    if got != (1, 1, 1, 1, 1):
        raise SmokeFailure("services: the skipped step was not counted and "
                           "debited")
    # a raising guard writes a crash bundle
    bundles = os.path.join(tmp, "bundles")
    os.makedirs(bundles)
    os.environ["MXNET_CRASH_BUNDLE_DIR"] = bundles
    try:
        trained(guard="raise", plant="nan_grad", at=2, steps=3)
        raise SmokeFailure("services: the raising guard did not raise")
    except mx.guardrails.NonFiniteGradientError:
        pass
    finally:
        os.environ.pop("MXNET_CRASH_BUNDLE_DIR", None)
    found = os.listdir(bundles)
    files = sorted(os.listdir(os.path.join(bundles, found[0]))) \
        if len(found) == 1 else []
    anomaly = json.load(open(os.path.join(bundles, found[0],
                                          "anomaly.json"))) if files else {}
    print("[services] the raising guard's crash bundle %s: %s, suspects "
          "%s" % (found, files, [s["param"] for s in
                                 anomaly.get("suspects", [])][:2]))
    if files != ["anomaly.json", "env.txt", "heartbeat.txt",
                 "modelwatch.jsonl", "programs.json", "telemetry.json",
                 "trace.json", "traces.json"] \
            or anomaly.get("reason") != "guard_raise":
        raise SmokeFailure("services: no crash bundle from the raising guard")
    # ckpt_write surfaces at the wait
    net, _ = _build_services(seed, SERVICES_SMALL_LAYERS)
    arg = {n: p.data() for n, p in net.collect_params().items()}
    mx.faultinject.set_fault("ckpt_write", 1.0, max_fires=1)
    try:
        mx.model.save_checkpoint(os.path.join(tmp, "fault"), 1, None, arg,
                                 {})
        try:
            mx.model.wait_checkpoints()
            raise SmokeFailure("services: ckpt_write did not surface")
        except mx.base.MXNetError as e:
            print("[services] ckpt_write surfaced at wait_checkpoints: %s"
                  % str(e).split("[")[0].strip())
    finally:
        mx.faultinject.clear()
    if any(f.startswith("fault-0001.params") for f in os.listdir(tmp)):
        raise SmokeFailure("services: a failed write was published")
    # resume past a truncated newest checkpoint
    _services_env(True)
    small = services_data(seed, 2 * TRAIN_BATCH)

    def fit(prefix, epochs, resume=None):
        net, loss = _build_services(seed, SERVICES_SMALL_LAYERS, dropout=0.0)
        mx.random.seed(seed)
        losses, _, tr = _services_fit(seed, net, loss, epochs, prefix=prefix,
                                      resume=resume, data=small)
        return losses, _struct_snapshot(net), _momenta(tr)
    full = fit(os.path.join(tmp, "full"), 3)
    part = os.path.join(tmp, "part")
    fit(part, 2)
    newest = part + "-0002.params"
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    resumed = fit(part, 3, resume=True)
    n = _bits_equal("the resumed run's losses", resumed[0], full[0][-4:])
    n += _bits_equal("the resumed run's parameters", resumed[1], full[1])
    n += _bits_equal("the resumed run's momenta", resumed[2], full[2])
    print("[services] fit(resume=True) with epoch 2's .params truncated "
          "resumed from epoch 1: epochs 2-3 bit for bit with the "
          "uninterrupted run (%d arrays); %s" % (n, card_line))


def phase_services(seed, card_line):
    """21. The runtime services on BERT-base trained through
    Estimator.fit; returns the kernel launches of the main run and the
    steady step's times."""
    import shutil
    import tempfile
    import torch
    import mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    print("[services] %s" % card_line)
    tmp = tempfile.mkdtemp(prefix="mxt_services_")
    saved = {v: os.environ.get(v) for v in (
        "MXNET_TELEMETRY", "MXNET_MODELWATCH")}
    try:
        net, loss, trainer, kept, arg1, executed, sizes = _services_main(
            seed, tmp, card_line)
        times = _services_turns(net, loss, trainer, seed, card_line,
                                sizes[0])
        _free_graphs(net, loss)
        del net, loss, trainer
        twin = _services_twin(seed, kept, arg1, card_line)
        _free_graphs(*twin[:2])
        del twin, kept, arg1
        torch.cuda.empty_cache()
        _services_small(seed, tmp, card_line)
    finally:
        mx.profiler.set_config(profile_device=False)
        for v, val in saved.items():
            if val is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = val
        mx.telemetry.refresh()
        mx.telemetry.reset()
        mx.compilewatch.reset()
        mx.model.wait_checkpoints()
        shutil.rmtree(tmp, ignore_errors=True)
    print("[services] phase 21 took %.1f s; %s"
          % (time.perf_counter() - t0, card_line))
    return executed, times


# ---------------------------------------------------------------------------
# 22. the serving stack: Scheduler, replica processes behind a Router,
# the HTTP Frontend
# ---------------------------------------------------------------------------
SERVING_REQUESTS = 64
SERVING_FLEET_REQUESTS = 32
SERVING_FRONTEND = (16, 12, 16)      # lengths of the Frontend's requests
SERVING_BUCKETS = "8;16,32,64,128"   # one batch bucket: a batch and a
#                                      direct infer run the same graph
SERVING_RUNGS = (16, 32, 64, 128)
SERVING_CLIENTS = 4
SERVING_REPLICAS = 2
SERVING_HB = 0.5            # lease period; a lease lives SERVING_MISS_K of
SERVING_MISS_K = 8          # them: the KV server lives in this process,
#                             whose JSON work (the Frontend) holds the GIL
SERVING_TENANTS = ({"name": "free", "weight": 1.0, "deadline_ms": 200.0},
                   {"name": "paid", "weight": 4.0})
_REPLICA_PATCHES = []


def serving_net(seed):
    """BERT-base as phase 4 draws it (bf16) on the card, with its example
    request ((8, 128) ids and token types on the card)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    rng = np.random.RandomState(seed)
    ex = [rng.randint(0, 30522, (8, 128)).astype(np.int32),
          rng.randint(0, 2, (8, 128)).astype(np.int32)]
    mx.random.seed(seed)
    # a fixed prefix: a replica process, whose prefix counters start at
    # 0, must find this process's parameter names in the checkpoint
    net = bert_12_768_12(dropout=0.0, prefix="serving_bert_")
    net.initialize(ctx=mx.gpu(0))
    ids, tok = (mx.nd.array(a, ctx=mx.gpu(0)) for a in ex)
    with torch.no_grad():
        net(ids, tok)
    _draw_affine(net, seed)
    net.cast("bfloat16")
    return net, ids, tok


def _serving_session(net, ids, tok):
    return net.serve_session(ids, tok, seq_axis=1, max_batch=8, max_seq=128,
                             buckets=SERVING_BUCKETS)


def _serving_tenants():
    from mxnet_tpu_torch.serve import TenantConfig
    return [TenantConfig(**t) for t in SERVING_TENANTS]


def _counting_scheduler(sess, replayed, tenants):
    """A Scheduler whose load snapshot (published in the replica's lease
    every heartbeat) also sets ``mx_serve_kernel_launches{kernel,kind}``:
    the wrappers' counts and the launches the replayed graphs carried."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.ops import cuda_build
    from mxnet_tpu_torch.serve import Scheduler

    class CountingScheduler(Scheduler):
        def stats(self):
            for k, v in cuda_build.launch_counts().items():
                telemetry.gauge("mx_serve_kernel_launches", kernel=k,
                                kind="wrapper").set(v)
            for k in SERVE_KERNELS:
                telemetry.gauge("mx_serve_kernel_launches", kernel=k,
                                kind="replayed").set(replayed.get(k, 0))
            return super().stats()
    return CountingScheduler(sess, tenants=tenants, inflight=2)


def serving_replica(spec):
    """The factory of one phase-22 replica process (spawned by
    ``ReplicaManager`` as ``chip_smoke:serving_replica``): BERT-base with
    the published weights, its buckets captured before the lease (a
    kernel that does not build fails the join), served by a counting
    Scheduler at ``inflight`` 2."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_build
    from mxnet_tpu_torch.serve import tenancy
    net, ids, tok = serving_net(int(spec["seed"]))
    loaded = mx.model.load_latest_checkpoint(spec["ckpt_prefix"])
    if loaded is None:
        raise SmokeFailure("replica %s: no checkpoint at %s"
                           % (spec.get("replica_id"), spec["ckpt_prefix"]))
    arg, _, _ = loaded
    for name, p in net.collect_params().items():
        p.set_data(arg[name])
    sess = _serving_session(net, ids, tok)
    by_graph = {}
    stack = contextlib.ExitStack()
    stack.enter_context(_capture_launches(by_graph))
    replayed = stack.enter_context(_replayed_launches(by_graph))
    _REPLICA_PATCHES.append(stack)       # for the life of the process
    sess.warmup()
    torch.cuda.synchronize()
    missing = [k for k in SERVE_KERNELS
               if not cuda_build.launch_counts().get(k)]
    if missing:
        raise SmokeFailure("replica %s: warm-up launched no %s"
                           % (spec.get("replica_id"), missing))
    tenants = [tenancy.TenantConfig(**t) for t in spec.get("tenants", ())]
    return _counting_scheduler(sess, replayed, tenants)


def _serving_requests(seed, n, salt):
    """``n`` requests from ``seed``: (ids, token types, tenant), 1-2 rows,
    lengths 16-128; the first len(SERVING_RUNGS) one a rung each."""
    import numpy as np
    rng = np.random.RandomState(seed * 1000 + salt)
    out = []
    for i in range(n):
        rows = int(rng.randint(1, 3))
        seq = (SERVING_RUNGS[i] if i < len(SERVING_RUNGS)
               else int(rng.randint(16, 129)))
        tenant = ("paid" if i < len(SERVING_RUNGS) or rng.rand() < 0.5
                  else "free")
        out.append((rng.randint(0, 30522, (rows, seq)).astype(np.int32),
                    rng.randint(0, 2, (rows, seq)).astype(np.int32), tenant))
    return out


def _pct(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q)) \
        if xs else float("nan")


def _closed_loop(reqs, clients, submit):
    """Drive ``reqs[i]`` through ``submit(i) -> (outputs or exception)``
    from ``clients`` threads, each sending its next request when its last
    completes; returns {i: (outputs or exception, seconds)}."""
    import threading
    out = {}
    lock = threading.Lock()
    todo = list(range(len(reqs)))

    def client():
        while True:
            with lock:
                if not todo:
                    return
                i = todo.pop(0)
            t0 = time.perf_counter()
            try:
                res = submit(i)
            except Exception as e:      # noqa: BLE001 - sorted out below
                res = e
            with lock:
                out[i] = (res, time.perf_counter() - t0)
    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return out


def _own_columns(batch_out, want):
    """The columns of a batch's decoder output (seq, batch, vocab) that
    are bit for bit the request's own ``want`` (seq, rows, vocab: its
    direct infer's), at whatever offset the batch put them; None if no
    offset holds them."""
    import numpy as np
    seq, rows = want.shape[:2]
    for off in range(batch_out.shape[1] - rows + 1):
        got = batch_out[:seq, off:off + rows]
        if np.array_equal(got, want):
            return np.array(got)
    return None


def _serving_scheduler(net, ids, tok, seed, card_line):
    """(a) The Scheduler in this process; returns (wrapper counts,
    replayed counts, session)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_build
    from mxnet_tpu_torch.serve import OverloadError, Scheduler, tenancy
    reqs = _serving_requests(seed, SERVING_REQUESTS, 1)
    sess = _serving_session(net, ids, tok)
    cuda_build.reset_launch_counts()
    by_graph = {}
    t0 = time.perf_counter()
    with _capture_launches(by_graph), \
            _replayed_launches(by_graph) as replayed:
        sched = Scheduler(sess, tenants=_serving_tenants(), inflight=2)
        try:
            rung = len(SERVING_RUNGS)
            warm = [sched.submit(a, b, tenant=t) for a, b, t in reqs[:rung]]
            results = {i: (f.result(300), float("nan"))
                       for i, f in enumerate(warm)}
            rest = _closed_loop(
                reqs[rung:], SERVING_CLIENTS,
                lambda i: sched.submit(*reqs[rung + i][:2],
                                       tenant=reqs[rung + i][2]).result(120))
            results.update({rung + i: v for i, v in rest.items()})
        finally:
            sched.close()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cuda_build.launch_counts()
    replayed = dict(replayed)
    print("[serving] scheduler: %d requests in %.2f s (inflight 2, %d "
          "closed-loop clients after one request a rung); launches through "
          "the wrappers %s; carried by the replayed graphs %s"
          % (len(reqs), wall, SERVING_CLIENTS,
             {k: counts[k] for k in SERVE_KERNELS},
             {k: replayed.get(k, 0) for k in SERVE_KERNELS}))
    missing = [k for k in SERVE_KERNELS if not counts[k]
               or not replayed.get(k)]
    if missing:
        raise SmokeFailure("the Scheduler's run launched no %s" % missing)
    if len(results) != len(reqs):
        raise SmokeFailure("the Scheduler completed %d of %d requests"
                           % (len(results), len(reqs)))
    lat = {"free": [], "paid": []}
    sheds = 0
    for i, (res, secs) in sorted(results.items()):
        a, b, tenant = reqs[i]
        if isinstance(res, OverloadError) and tenant == "free" \
                and res.code == "timeout":
            sheds += 1
            continue
        if isinstance(res, Exception):
            raise SmokeFailure("scheduler request %d (%s) failed: %r"
                               % (i, tenant, res))
        if secs == secs:
            lat[tenant].append(secs * 1e3)
        direct = sess.infer(a, b)
        same = all(np.array_equal(g, w) for g, w in zip(res[:3], direct[:3]))
        rows, seq = a.shape
        if not same or _own_columns(res[3], direct[3][:seq, :rows]) is None:
            raise SmokeFailure("scheduler request %d %s: not bit for bit "
                               "with sess.infer" % (i, a.shape))
    print("[serving] scheduler: %d outputs bit for bit with sess.infer of "
          "the same request (the decoder output's own rows); %d free "
          "requests shed past their 200 ms deadline"
          % (len(results) - sheds, sheds))
    for tenant, xs in sorted(lat.items()):
        print("[serving] scheduler latency %s: p50 %.2f ms p99 %.2f ms over "
              "%d closed-loop requests; %s" % (tenant, _pct(xs, 50),
                                                _pct(xs, 99), len(xs),
                                                card_line))
    print("[serving] slo_report:\n%s" % tenancy.render_slo_report(
        tenants=_serving_tenants()))
    print("[serving] %s" % mx.telemetry.heartbeat_line())
    print("[serving] buckets: %s" % sess.bucket_table())
    # where a 8 x 128 request's time goes: the replayed forward against
    # the decoder output's host copy (session.py's asnumpy)
    staged = [sess._pad_to(torch.as_tensor(x.asnumpy()), (8, 128), t).to(DEV)
              for x, t in zip((ids, tok), sess._templates)]
    fwd, copy = [], []
    for _ in range(7):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs = sess._forward(staged)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for o in outs:
            mx.nd.NDArray(o, mx.gpu(0)).asnumpy()
        t3 = time.perf_counter()
        fwd.append((t2 - t1) * 1e3)
        copy.append((t3 - t2) * 1e3)
    print("[serving] an (8, 128) request: replayed forward %.2f ms, the "
          "outputs' host copy %.2f ms (decoder (128, 8, 30522) f32 of it), "
          "medians of 7; %s" % (_pct(fwd, 50), _pct(copy, 50), card_line))
    return counts, replayed, sess


def _serving_fleet(net, sess, seed, tmp, card_line):
    """(b) Replica processes behind a Router, one SIGKILLed midway;
    returns (router, manager, per-replica counts)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op, telemetry, tracing
    from mxnet_tpu_torch.serve import ReplicaManager, Router
    reqs = _serving_requests(seed, SERVING_FLEET_REQUESTS, 2)
    prefix = os.path.join(tmp, "bert")
    t0 = time.perf_counter()
    mx.model.save_checkpoint(prefix, 0, None, {
        k: p.data() for k, p in net.collect_params().items()}, {}, sync=True)
    print("[serving] weights published in %.1f s"
          % (time.perf_counter() - t0))
    def answers():
        # the three encoder outputs and the request's own columns of the
        # decoder output (seq, batch, vocab)
        out = []
        for a, b, _ in reqs:
            o = sess.infer(a, b)
            rows, seq = a.shape
            out.append(list(o[:3]) + [np.array(o[3][:seq, :rows])])
        return out

    # the single-process answers, and phase 4's yardstick for them
    direct = answers()
    with cached_op.eager(), _plain_kernels():
        plain = answers()
        net.cast("float32")
        anchor = answers()
        net.cast("bfloat16")
    spec = {"ckpt_prefix": prefix, "seed": seed,
            "tenants": list(SERVING_TENANTS),
            "env": {"MXNET_TELEMETRY": "1", "MXNET_TRACE": "1",
                    "MXNET_TRACE_SAMPLE": "1.0"}}
    t0 = time.perf_counter()
    mgr = ReplicaManager(n=SERVING_REPLICAS,
                         factory="chip_smoke:serving_replica", spec=spec,
                         heartbeat_s=SERVING_HB, miss_k=SERVING_MISS_K)
    router = None
    try:
        mgr.start(timeout=300)
        print("[serving] %d replica processes live in %.1f s (each: "
              "BERT-base built, checkpoint loaded, %d buckets captured)"
              % (SERVING_REPLICAS, time.perf_counter() - t0,
                 len(SERVING_RUNGS)))
        router = Router(kv=mgr.kv, tenants=_serving_tenants(),
                        heartbeat_s=SERVING_HB, miss_k=SERVING_MISS_K,
                        retries=2)
        router.refresh()

        def payloads():
            router.refresh()
            return dict(router.replica_payloads())

        futs = {}
        killed = []

        def submit(i):
            a, b, _ = reqs[i]
            fut = router.submit(a, b, tenant="paid")
            futs[i] = fut
            return [np.asarray(o) for o in fut.result(120)]

        def killer():
            t_dead = time.time() + 120
            while time.time() < t_dead:
                p = payloads()
                if len(futs) >= SERVING_FLEET_REQUESTS // 3 and all(
                        p.get(r, {}).get("served", 0) >= 1
                        for r in ("r0", "r1")):
                    mgr.kill("r0")
                    killed.append(len(futs))
                    return
                time.sleep(0.05)
        import threading
        kt = threading.Thread(target=killer)
        fo0 = sum(v for k, v in telemetry.snapshot()["counters"].items()
                  if k.startswith(("mx_fleet_failovers_total",
                                   "mx_fleet_retries_total")))
        t0 = time.perf_counter()
        kt.start()
        results = _closed_loop(reqs, SERVING_CLIENTS, submit)
        kt.join(timeout=130)
        wall = time.perf_counter() - t0
        retried = sum(v for k, v in telemetry.snapshot()["counters"].items()
                      if k.startswith(("mx_fleet_failovers_total",
                                       "mx_fleet_retries_total"))) - fo0
        if not killed:
            raise SmokeFailure("the fleet: replica r0 was never killed")
        errors = {i: r for i, (r, _) in results.items()
                  if isinstance(r, Exception)}
        if errors or len(results) != len(reqs):
            raise SmokeFailure("the fleet lost requests: %d of %d completed, "
                               "errors %s" % (len(results) - len(errors),
                                              len(reqs), errors))
        by = {}
        for fut in futs.values():
            by[fut.replica] = by.get(fut.replica, 0) + 1
        print("[serving] fleet: %d requests, r0 SIGKILLed after %d were "
              "sent; every request completed once (served by %s; %d "
              "retries and failovers) in %.2f s"
              % (len(reqs), killed[0], by, retried, wall))
        ratios, apart = [], 0.0
        for i, (res, _) in sorted(results.items()):
            # the request's own columns of its batch's decoder output,
            # picked after the timed loop
            res[3] = _own_columns(res[3], direct[i][3])
            if res[3] is None:
                raise SmokeFailure(
                    "fleet request %d: no columns of its batch's decoder "
                    "output are bit for bit its own" % i)
            for j in range(4):
                apart = max(apart, float(np.abs(
                    res[j].astype(np.float64) - direct[i][j]).max()))
                ratios.append(_slice_check(
                    "fleet", "fleet request %d output %d" % (i, j), res[j],
                    plain[i][j], anchor[i][j], quiet=True))
        print("[serving] fleet: largest ratio to the plain path %.3g over %d "
              "outputs, the request's own decoder columns among them (limit "
              "%g); max |replica - this process's session| %.3g"
              % (max(r for r, _ in ratios), len(ratios), SLICE_RATIO, apart))
        if any(f for _, f in ratios):
            raise SmokeFailure("fleet outputs differ from the plain path by "
                               "more than %g times bf16's own error"
                               % SLICE_RATIO)
        if apart:
            raise SmokeFailure("fleet outputs are not bit for bit this "
                               "process's session's (the same graphs)")
        lat = [secs * 1e3 for _, secs in results.values()]
        print("[serving] router latency paid: p50 %.2f ms p99 %.2f ms over "
              "%d closed-loop requests (%d clients, a SIGKILL among them); "
              "%s" % (_pct(lat, 50), _pct(lat, 99), len(lat),
                      SERVING_CLIENTS, card_line))
        # where a routed request's time goes, from the assembled traces
        phases, shown = {}, False
        for i, fut in sorted(futs.items()):
            t_dead = time.time() + 10
            bd = router.explain(fut.id)
            while (bd is None or not bd["complete"]) and \
                    time.time() < t_dead:
                time.sleep(0.02)
                bd = router.explain(fut.id)
            if bd is None:
                raise SmokeFailure("no assembled trace for request %d" % i)
            for ph, us in bd["phases"]:
                phases.setdefault(ph, []).append(us / 1e3)
            if not shown and fut.replica == "r1":
                print("[serving] %s" % tracing.render_critical_path(
                    bd, bd["trace_id"]))
                shown = True
        print("[serving] a routed request's time by phase (medians over %d "
              "traces, ms): %s; the Router's wire cost a hop %.3f ms; %s"
              % (len(futs), {k: round(_pct(v, 50), 3)
                             for k, v in sorted(phases.items())},
                 _pct(phases.get("wire", []), 50), card_line))
        # each replica's own launches, from its lease
        time.sleep(2 * SERVING_HB)
        counts = {}
        for rid, payload in payloads().items():
            gauges = (payload.get("tele") or {}).get("gauges") or {}
            c = {"wrapper": {}, "replayed": {}}
            for key, v in gauges.items():
                name, labels = telemetry.parse_metric_key(key)
                if name == "mx_serve_kernel_launches":
                    c[labels["kind"]][labels["kernel"]] = int(v)
            counts[rid] = c
            print("[serving] replica %s (pid %s, served %s): launches "
                  "through the wrappers %s, carried by replayed graphs %s"
                  % (rid, payload.get("pid"), payload.get("served"),
                     {k: c["wrapper"].get(k, 0) for k in SERVE_KERNELS},
                     c["replayed"]))
            if any(not c["replayed"].get(k) or not c["wrapper"].get(k)
                   for k in SERVE_KERNELS):
                raise SmokeFailure("replica %s reports no launch of a "
                                   "serving kernel" % rid)
        if sorted(counts) != ["r%d" % i for i in range(SERVING_REPLICAS)]:
            raise SmokeFailure("launch counts from replicas %s"
                               % sorted(counts))
        return router, mgr, counts
    except BaseException:
        if router is not None:
            router.close()
        mgr.stop(timeout=10)
        raise


def _http(addr, method, path, body=None, headers=None):
    import http.client
    import json as _json
    conn = http.client.HTTPConnection(*addr, timeout=120)
    try:
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        conn.request(method, path, None if body is None
                     else _json.dumps(body), hdrs)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _serving_frontend(router, sess, seed, card_line):
    """(c) The HTTP Frontend on the Router; the Router's answers are this
    process's session's, bit for bit."""
    import json as _json
    import numpy as np
    from mxnet_tpu_torch.serve import Frontend
    rng = np.random.RandomState(seed * 1000 + 3)
    fe = Frontend(router).serve_in_thread()
    try:
        fe_ms, rt_ms = [], []
        trace_id = None
        for k, seq in enumerate(SERVING_FRONTEND):
            ids = rng.randint(0, 30522, (1, seq)).astype(np.int32)
            tok = rng.randint(0, 2, (1, seq)).astype(np.int32)
            t0 = time.perf_counter()
            want = router.infer(ids, tok, tenant="paid")
            rt_ms.append((time.perf_counter() - t0) * 1e3)
            direct = sess.infer(ids, tok)
            if not all(np.array_equal(np.asarray(w), d)
                       for w, d in zip(want[:3], direct[:3])) \
                    or _own_columns(np.asarray(want[3]),
                                    direct[3][:seq, :1]) is None:
                raise SmokeFailure("Frontend request %d: the Router's "
                                   "answer is not the session's" % k)
            stream = k == len(SERVING_FRONTEND) - 1
            t0 = time.perf_counter()
            status, hdrs, raw = _http(fe.addr, "POST", "/v1/infer", {
                "inputs": [ids.tolist(), tok.tolist()], "dtype": "int32",
                "tenant": "paid", "stream": stream})
            body = (_json.loads(raw.decode().strip().splitlines()[0])
                    if stream else _json.loads(raw))
            fe_ms.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise SmokeFailure("Frontend /v1/infer: %d %s"
                                   % (status, raw[:200]))
            got = [np.asarray(o, np.float32) for o in body["outputs"]]
            if len(got) != len(want) or not all(
                    np.array_equal(g, w) for g, w in zip(got, want)):
                raise SmokeFailure("Frontend request %d: outputs differ "
                                   "from the Router's" % k)
            trace_id = body.get("trace_id") or trace_id
        status, _, raw = _http(fe.addr, "GET", "/metrics")
        text = raw.decode()
        if status != 200 or 'replica="r1"' not in text \
                or "mx_fleet_requests_total" not in text:
            raise SmokeFailure("Frontend /metrics lacks the replicas' "
                               "series")
        status, _, raw = _http(fe.addr, "GET", "/v1/trace/%s" % trace_id)
        doc = _json.loads(raw)
        if status != 200 or not doc.get("spans") \
                or doc["critical_path"]["dominant"] == "none":
            raise SmokeFailure("Frontend /v1/trace/%s: %d" % (trace_id,
                                                              status))
        status, _, _ = _http(fe.addr, "GET", "/v1/trace/unknown0")
        if status != 404:
            raise SmokeFailure("an unknown trace answered %d" % status)
        status, _, raw = _http(fe.addr, "GET", "/v1/health")
        print("[serving] frontend: %d requests (1 row, lengths %s, the last "
              "streamed) equal the Router's answers, which are this process's "
              "session's bit for bit; /metrics carries "
              "replica= series; /v1/trace/%s %d spans, unknown id 404; "
              "/v1/health %s" % (len(SERVING_FRONTEND), SERVING_FRONTEND,
                                 trace_id, len(doc["spans"]),
                                 raw.decode().strip()))
        print("[serving] frontend cost a request: %.2f ms through HTTP "
              "against %.2f ms through Router.infer (medians of %d; JSON of "
              "the (16, 8, 30522) decoder output included); %s"
              % (_pct(fe_ms, 50), _pct(rt_ms, 50), len(fe_ms), card_line))
    finally:
        fe.stop()


def phase_serving(seed, card_line):
    """22. The serving stack on BERT-base: Scheduler, replica processes
    behind a Router, the Frontend; returns (the Scheduler run's wrapper
    launches, {replica: its launches})."""
    import shutil
    import tempfile
    import torch
    import mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    print("[serving] %s" % card_line)
    tmp = tempfile.mkdtemp(prefix="mxt_serving_")
    saved = {v: os.environ.get(v) for v in (
        "MXNET_TELEMETRY", "MXNET_TRACE", "MXNET_TRACE_SAMPLE")}
    router = mgr = None
    try:
        os.environ["MXNET_TELEMETRY"] = "1"
        mx.telemetry.refresh()
        mx.telemetry.reset()
        net, ids, tok = serving_net(seed)
        counts, replayed, sess = _serving_scheduler(net, ids, tok, seed,
                                                    card_line)
        os.environ["MXNET_TRACE"] = "1"
        os.environ["MXNET_TRACE_SAMPLE"] = "1.0"
        mx.telemetry.refresh()
        router, mgr, replica_counts = _serving_fleet(net, sess, seed, tmp,
                                                     card_line)
        _serving_frontend(router, sess, seed, card_line)
        _free_graphs(net)
        del net, sess
        torch.cuda.empty_cache()
    finally:
        if router is not None:
            router.close()
        if mgr is not None:
            mgr.stop(timeout=20)
            if any(mgr.alive().values()):
                raise SmokeFailure("replica processes outlived the phase")
        for v, val in saved.items():
            if val is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = val
        mx.telemetry.refresh()
        mx.telemetry.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    print("[serving] phase 22 took %.1f s; %s"
          % (time.perf_counter() - t0, card_line))
    total = {k: counts.get(k, 0) for k in counts}
    return total, {rid: c["replayed"] for rid, c in replica_counts.items()}, \
        replayed


# ---------------------------------------------------------------------------
# 23. data parallel through the kvstore: two ranks on the card over gloo,
# NCCL at world size 1 with the P3 store, a process's contexts, the vote
# ---------------------------------------------------------------------------
DP_ROWS = 8                # rows a rank (and a context): 8 x seq 128
DP_STEPS = 3               # timed steps, after one warm-up
DP_SGD = {"learning_rate": 1e-3, "momentum": 0.9}
DP_DROPOUT = 0.1
DP_SMALL_LAYERS = 2        # part (c)'s depth at full width
# P3's slice bound in elements: BERT-base's word embedding (30522 x 768)
# takes 23 slices, each FFN weight 3
DP_P3_BOUND = 1 << 20
# (a) against the one-process run on the concatenated batch: the relative
# L2 distance of the parameters' change over the 4 steps. Under bf16 AMP
# every weight gradient leaves its matmul rounded to bf16, once for each
# rank's half of the batch against once for the whole. On an H100 the
# distance read 0.0087, 0.0111, 0.0098, 0.0099 and 0.0112 for seeds 0-4
# (dp_readings); the limit is twice the largest. The control (the
# cross-process sum planted away, each rank on its own half) must land
# beyond it, its ranks apart
DP_TOL = 0.0224
# (c) in f32 with TF32 off, a sum over rows in another order: the
# replicas against the one-context run, relative L2 of the change
DP_CTX_TOL = 1e-4
DP_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "selfatt_fwd",
              "selfatt_bwd", "bias_gelu_fwd", "bias_gelu_bwd",
              "bias_residual_fwd")
DP_TIMEOUT = 400           # seconds a launch may take, the build included
DP_LAYERS = 12
# what each launched rank runs (from the checkout's root)
DP_WORKER = "import chip_smoke as cs, sys; sys.exit(cs.dp_worker())"


def _dp_model(seed, layers, dropout, ctx=None):
    """BERT-base's widths at ``layers`` layers with the dense MLM head
    over ``SERVICES_MASKED`` masked positions (``services_mlm``), f32,
    eager: initialized on ``ctx`` (default gpu(0)), biases, beta and
    gamma - 1 drawn from the seed, the same in every process."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel
    mx.random.seed(seed)
    bert = BERTModel(num_layers=layers, units=UNITS, hidden_size=HIDDEN,
                     num_heads=HEADS, max_length=512, vocab_size=VOCAB,
                     dropout=dropout, use_pooler=False,
                     use_classifier=False, use_decoder=False)
    net = services_mlm(mx, bert)
    net.initialize(ctx=ctx)
    first = ctx[0] if isinstance(ctx, (list, tuple)) else ctx
    data, _ = services_data(seed, 2)
    with torch.no_grad():
        net(mx.nd.array(data, dtype="int32", ctx=first))
    _draw_affine(net, seed)
    return net


def _dp_batch(seed, step):
    """The global batch of one step: (2 * DP_ROWS, seq + masked) ids and
    positions, (2 * DP_ROWS, masked) labels."""
    return services_data(seed * 1000 + step, 2 * DP_ROWS)


def _dp_snapshot(net, trainer=None):
    """Clones of every parameter (and momentum) in f32, by position (a
    second model's names carry other counters)."""
    out = {"p%04d" % i: p.data().tensor().detach().float().clone()
           for i, p in enumerate(net.collect_params().values())}
    if trainer is not None:
        for i, st in sorted(trainer._updater.states.items(),
                            key=lambda kv: str(kv[0])):
            if st is not None:
                out["mom:%s" % i] = st.tensor().detach().float().clone()
    return out


def _dp_digest(snap):
    import hashlib
    h = hashlib.sha256()
    for k in sorted(snap):
        h.update(k.encode())
        h.update(_bits(snap[k]).cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_train(net, trainer, seed, rows, total, ctxs=None, steps=None):
    """1 + DP_STEPS SGD steps (``steps`` to override): this process takes
    ``rows`` of each global batch (split over ``ctxs`` when given),
    ``trainer.step(total)``; returns each step's wall time in ms (the
    card synchronised around it)."""
    import torch
    import mxnet_tpu_torch as mx
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    ctxs = ctxs or [mx.gpu(0) if DEV == "cuda" else mx.cpu()]
    times = []
    for s in range(1 + DP_STEPS if steps is None else steps):
        data, labels = _dp_batch(seed, s)
        data, labels = data[rows], labels[rows]
        per = len(data) // len(ctxs)
        parts = [(mx.nd.array(data[i * per:(i + 1) * per], dtype="int32",
                              ctx=c),
                  mx.nd.array(labels[i * per:(i + 1) * per], ctx=c))
                 for i, c in enumerate(ctxs)]
        mx.random.seed(seed + 100 + s)
        if DEV == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            losses = [loss_fn(net(d), lab).sum() for d, lab in parts]
        for loss in losses:
            loss.backward()
        trainer.step(total)
        if DEV == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _dp_comm():
    import mxnet_tpu_torch as mx
    return [{k: r[k] for k in ("op", "axis", "ops", "bytes", "seconds",
                               "algbw", "busbw", "exposed_s")}
            for r in mx.commwatch.report()]


def _dp_rel(snap, base, ref, skip=()):
    """The relative L2 distance of ``snap``'s change from ``base`` to
    ``ref``'s, over every parameter but ``skip``."""
    num = den = 0.0
    for k, r in ref.items():
        if k.startswith("mom:") or k in skip:
            continue
        d = (snap[k] - base[k]).double()
        e = (r - base[k]).double()
        num += float(((d - e) ** 2).sum())
        den += float((e ** 2).sum())
    return (num / den) ** 0.5 if den > 0 else float("inf")


def _dp_run(mx, seed, kv, rows, total, dropout, snap0=False):
    """One data-parallel run of the 12-layer model: launches counted from
    0 over the run, the bits of the parameters and momenta after it."""
    from mxnet_tpu_torch.ops import cuda_build
    net = _dp_model(seed, DP_LAYERS, dropout)
    base = _dp_snapshot(net) if snap0 else None
    init = _dp_digest(_dp_snapshot(net))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(DP_SGD),
                               kvstore=kv)
    mx.telemetry.reset()
    cuda_build.reset_launch_counts()
    times = _dp_train(net, trainer, seed, rows, total)
    counts = {k: v for k, v in cuda_build.launch_counts().items() if v}
    snap = _dp_snapshot(net, trainer)
    run = {"init": init, "final": _dp_digest(snap), "launches": counts,
           "step_ms": times, "comm": _dp_comm(),
           "kv": getattr(trainer._kvstore, "type", None)}
    return run, net, trainer, snap, base


def _dp_gloo(mx, seed):
    """(a) and (d): this rank of two sharing the card over gloo."""
    import torch
    from mxnet_tpu_torch.guardrails import NonFiniteGradientError
    kv = mx.kvstore.create("dist_sync")
    rank, nw = kv.rank, kv.num_workers
    out = {"rank": rank, "nw": nw, "backend": kv.backend,
           "device": torch.cuda.current_device() if DEV == "cuda" else -1}
    rows = slice(rank * DP_ROWS, (rank + 1) * DP_ROWS)
    keep = None
    for dropout in (0.0, DP_DROPOUT):
        run, net, trainer, snap, base = _dp_run(
            mx, seed, kv, rows, nw * DP_ROWS, dropout,
            snap0=(dropout == 0 and rank == 0))
        out["dropout %g" % dropout] = run
        if base is not None:
            keep = (base, snap)
        else:
            del snap
    # (d) the finite vote: nan_grad armed on rank 1 only
    os.environ["MXNET_GUARD_COMM_VOTE"] = "1"
    if rank == 1:
        mx.faultinject.set_fault("nan_grad", 1.0, max_fires=1)
    try:
        _dp_train(net, trainer, seed, rows, nw * DP_ROWS, steps=1)
        out["vote"] = None
    except NonFiniteGradientError as e:
        out["vote"] = str(e)
    finally:
        os.environ.pop("MXNET_GUARD_COMM_VOTE", None)
        mx.faultinject.reset()
    del net, trainer
    # the control: the same run with the cross-process sum planted away
    # (each rank keeps its own gradients) must fail both checks
    from mxnet_tpu_torch.kvstore import dist as kvdist
    real = kvdist._GlobalReducer.allreduce
    kvdist._GlobalReducer.allreduce = lambda self, ts: [t.clone()
                                                         for t in ts]
    try:
        run, net, trainer, fault, _ = _dp_run(mx, seed, kv, rows,
                                              nw * DP_ROWS, 0.0)
    finally:
        kvdist._GlobalReducer.allreduce = real
    out["control"] = run["final"]
    del net, trainer
    out["quant"] = _dp_quant(mx, seed, rank, nw)
    kv.barrier()
    if rank == 0:
        # the one-process run on the concatenated batch, no kvstore
        net = _dp_model(seed, DP_LAYERS, 0.0)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(DP_SGD))
        out["one_init"] = _dp_digest(_dp_snapshot(net))
        out["one_step_ms"] = _dp_train(net, trainer, seed,
                                       slice(0, nw * DP_ROWS),
                                       nw * DP_ROWS)
        one = _dp_snapshot(net)
        out["rel_l2"] = _dp_rel(keep[1], keep[0], one)
        out["control_rel_l2"] = _dp_rel(fault, keep[0], one)
    return out


def _dp_quant(mx, seed, rank, nw):
    """Phase 26 (f), in this rank of phase 23's gloo pair: an FFN's
    ffn_1 weight and biases through int8 ``dist_sync`` (one replica a
    rank), against the in-process device store over ``[gpu(0), cpu(0)]``
    on every rank's values (the rank's result against replica ``rank``'s),
    and the wire's bytes on kv.dcn."""
    import numpy as np
    ctx = _zero_ctxs()[0]
    local = _zero_ctxs()[:nw]
    keys = ["quant%d" % i for i in range(len(DP_QUANT_SHAPES))]

    def values(r):
        rng = np.random.RandomState(seed * 10 + r)
        return [rng.randn(*shape).astype(np.float32)
                for shape in DP_QUANT_SHAPES]
    with _env_flag("MXNET_KVSTORE_QUANTIZE", "int8"):
        kv = mx.kvstore.create("dist_sync")
        mine = [mx.nd.array(a, ctx=ctx) for a in values(rank)]
        kv.init(keys, [a.copy() for a in mine])
        mx.telemetry.reset()
        kv.pushpull_list(keys, [[a] for a in mine])
        wire = {}
        for r in mx.commwatch.report():
            if r["axis"] == "kv.dcn":
                wire[r["dtype"]] = wire.get(r["dtype"], 0) + r["bytes"]
        ref = mx.kvstore.create("device")
        every = [values(r) for r in range(nw)]
        reps = [[mx.nd.array(every[r][i], ctx=c) for r, c in enumerate(local)]
                for i in range(len(keys))]
        ref.init(keys, [v[0].copy() for v in reps])
        ref.pushpull_list(keys, reps)
    got = [a.asnumpy() for a in mine]
    want = [v[rank].asnumpy() for v in reps]
    exact = [sum(e[i].astype(np.float64) for e in every)
             for i in range(len(keys))]
    return {"shapes": [list(sh) for sh in DP_QUANT_SHAPES],
            "ctxs": [str(c) for c in local],
            "bitwise": all(np.array_equal(g, w) for g, w in zip(got, want)),
            "max_abs": max(float(np.abs(g - w).max())
                           for g, w in zip(got, want)),
            "scale": max(float(np.abs(w).max()) for w in want),
            "exact": max(float(np.abs(g - e).max())
                         for g, e in zip(got, exact)),
            "wire": wire}


def _dp_nccl(mx, seed):
    """(b): one rank on NCCL; dist_sync, p3store_dist and no kvstore on
    the same rows."""
    kv = mx.kvstore.create("dist_sync")
    out = {"rank": kv.rank, "nw": kv.num_workers, "backend": kv.backend}
    rows = slice(0, DP_ROWS)
    out["dist_sync"] = _dp_run(mx, seed, kv, rows, DP_ROWS, 0.0)[0]
    os.environ["MXNET_KVSTORE_BIGARRAY_BOUND"] = str(DP_P3_BOUND)
    p3 = mx.kvstore.create("p3store_dist")
    out["p3store_dist"] = _dp_run(mx, seed, p3, rows, DP_ROWS, 0.0)[0]
    out["none"] = _dp_run(mx, seed, None, rows, DP_ROWS, 0.0)[0]
    return out


def dp_worker():
    """One rank of phase 23, started by ``python -m
    mxnet_tpu_torch.tools.launch``: ``MXT_DP_CASE`` ``gloo`` (parts a and
    d) or ``nccl`` (part b), ``MXT_DP_SEED``; writes its findings to
    ``MXT_DP_OUT/<case>-<rank>.json``. f32 parameters under bf16 AMP (the
    attention kernel takes 16-bit data), TF32 off."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp
    case = os.environ["MXT_DP_CASE"]
    seed = int(os.environ["MXT_DP_SEED"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    amp.init(target_dtype="bfloat16")
    res = (_dp_gloo if case == "gloo" else _dp_nccl)(mx, seed)
    with open(os.path.join(os.environ["MXT_DP_OUT"], "%s-%d.json"
                           % (case, res["rank"])), "w") as f:
        json.dump(res, f)
    return 0


def _dp_launch(case, n, seed, tmp):
    """Run ``n`` ranks of ``dp_worker`` through the port's launcher from
    the checkout's root; every process is stopped at the end."""
    import signal
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, MXT_DP_CASE=case, MXT_DP_SEED=str(seed),
               MXT_DP_OUT=tmp, MXNET_TELEMETRY="1", MXNET_COMMWATCH="1")
    for var in ("MXNET_GUARD_COMM_VOTE", "MXNET_FAULT_INJECT",
                "MXNET_KVSTORE_BIGARRAY_BOUND", "MXNET_DIST_CPU_DEVICES"):
        env.pop(var, None)
    log = os.path.join(tmp, "%s.log" % case)
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
             str(n), sys.executable, "-c", DP_WORKER],
            cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT,
            start_new_session=True)
        try:
            rc = proc.wait(timeout=DP_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    with open(log) as f:
        text = f.read()
    if rc != 0:
        raise SmokeFailure("dp: the %s launch of %d rank(s) ended with %s:"
                           "\n%s" % (case, n, rc, text[-6000:]))
    out = {}
    for r in range(n):
        with open(os.path.join(tmp, "%s-%d.json" % (case, r))) as f:
            out[r] = json.load(f)
    return out, time.perf_counter() - t0


def _dp_launch_check(tag, run, want):
    miss = [k for k in want if not run["launches"].get(k)]
    if miss:
        raise SmokeFailure("dp: %s launched no %s (%s)"
                           % (tag, miss, run["launches"]))


def _dp_print_run(tag, run, card_line):
    med = statistics.median(run["step_ms"][1:])
    print("[dp] %s: launches %s; step %.1f ms (median of %d after a "
          "warm-up of %.1f ms); %s" % (tag, run["launches"], med,
                                       len(run["step_ms"]) - 1,
                                       run["step_ms"][0], card_line))
    for r in run["comm"]:
        print("[dp] %s: commwatch %s %s: %d ops, %.1f MB, %.4f s, algbw "
              "%.2f GB/s, busbw %.2f GB/s, exposed %.4f s (%.1f ms a step)"
              % (tag, r["op"], r["axis"], r["ops"], r["bytes"] / 1e6,
                 r["seconds"], r["algbw"] / 1e9, r["busbw"] / 1e9,
                 r["exposed_s"], r["exposed_s"] / max(1, r["ops"]) * 1e3))


def _dp_contexts(seed, card_line):
    """(c): one process, a replica on gpu(0) and one on cpu(0) through
    kvstore 'device' (and gpu(0), gpu(1) through 'nccl' on two cards),
    against the one-context run on the concatenated batch."""
    import torch
    import mxnet_tpu_torch as mx
    gpu = mx.gpu(0) if DEV == "cuda" else mx.cpu(1)
    sets = [("device", [gpu, mx.cpu(0)])]
    if DEV == "cuda" and torch.cuda.device_count() >= 2:
        sets.append(("nccl", [mx.gpu(0), mx.gpu(1)]))
    with _no_tf32():
        one = _dp_model(seed, DP_SMALL_LAYERS, 0.0, ctx=[gpu])
        base = _dp_snapshot(one)
        trainer = mx.gluon.Trainer(one.collect_params(), "sgd",
                                   dict(DP_SGD))
        _dp_train(one, trainer, seed, slice(0, 2 * DP_ROWS), 2 * DP_ROWS,
                  ctxs=[gpu])
        ref = _dp_snapshot(one)
        del one, trainer
        for name, ctxs in sets:
            net = _dp_model(seed, DP_SMALL_LAYERS, 0.0, ctx=ctxs)
            trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                       dict(DP_SGD), kvstore=name)
            times = _dp_train(net, trainer, seed, slice(0, 2 * DP_ROWS),
                              2 * DP_ROWS, ctxs=ctxs)
            reps = [{"p%04d" % i: p.data(c).tensor().detach().float()
                     .to(gpu.torch_device)
                     for i, p in enumerate(net.collect_params().values())}
                    for c in ctxs]
            same = all(torch.equal(_bits(reps[0][n]), _bits(reps[1][n]))
                       for n in reps[0])
            apart = _dp_rel(reps[1], base, reps[0])
            rel = _dp_rel(reps[0], base, ref)
            print("[dp] (c) %s over %s, %d layers at full width, f32, "
                  "TF32 off, %d steps of %d rows a context: replicas %s "
                  "(relative L2 apart %.3g), against the one-context run "
                  "on the concatenated batch %.3g (limit %g); step %.1f ms;"
                  " %s" % (name, [str(c) for c in ctxs], DP_SMALL_LAYERS,
                           len(times), DP_ROWS,
                           "bit for bit equal" if same else "not bit-equal",
                           apart, rel, DP_CTX_TOL,
                           statistics.median(times[1:]), card_line))
            if trainer._kvstore is None or trainer._kvstore.type != name:
                raise SmokeFailure("dp: (c) ran without its kvstore")
            if not rel <= DP_CTX_TOL or not apart <= DP_CTX_TOL:
                raise SmokeFailure("dp: (c) %s: %.3g from the one-context "
                                   "run, replicas %.3g apart (limit %g)"
                                   % (name, rel, apart, DP_CTX_TOL))
            del net, trainer, reps
    if len(sets) == 1:
        print("[dp] (c) the grouped NCCL reduce across cards ([gpu(0), "
              "gpu(1)] through kvstore 'nccl') did not run: this machine "
              "has %d CUDA device(s) and it needs two"
              % (torch.cuda.device_count() if DEV == "cuda" else 0))


def dp_readings(seeds, card_line):
    """(a)'s distance from the one-process run at each seed, the
    readings behind ``DP_TOL``."""
    import shutil
    import tempfile
    out = {}
    for seed in seeds:
        tmp = tempfile.mkdtemp(prefix="mxt_dp_")
        try:
            out[seed] = _dp_launch("gloo", 2, seed, tmp)[0][0]["rel_l2"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print("[dp] readings: seed %d: relative L2 of the change from the "
              "one-process run %.4g; %s" % (seed, out[seed], card_line))
    return out


def phase_dp(seed, card_line):
    """23. Data-parallel training through the kvstore; returns rank 0's
    kernel launches in the two-rank run with dropout."""
    import shutil
    import tempfile
    import torch
    t0 = time.perf_counter()
    print("[dp] %s" % card_line)
    if DEV == "cuda":
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="mxt_dp_")
    try:
        gloo, secs = _dp_launch("gloo", 2, seed, tmp)
        print("[dp] (a) 2 ranks of bert_12_768_12 (f32 parameters under "
              "bf16 AMP, TF32 off, SGD momentum 0.9) on cuda:%s, %d rows x "
              "seq %d a rank, kvstore dist_sync: backends %s, launched and "
              "run in %.1f s" % (" and cuda:".join(
                  str(gloo[r]["device"]) for r in (0, 1)), DP_ROWS,
                  TRAIN_SEQ, [gloo[r]["backend"] for r in (0, 1)], secs))
        if [gloo[r]["backend"] for r in (0, 1)] != ["gloo", "gloo"] and \
                torch.cuda.device_count() < 2:
            raise SmokeFailure("dp: two ranks on one card must take gloo")
        for key in ("dropout 0", "dropout %g" % DP_DROPOUT):
            runs = [gloo[r][key] for r in (0, 1)]
            for r, run in enumerate(runs):
                _dp_print_run("(a) %s rank %d" % (key, r), run, card_line)
                _dp_launch_check("(a) %s rank %d" % (key, r), run,
                                 DP_KERNELS + (("dropout",) if key !=
                                               "dropout 0" else ()))
                if not any(c["axis"] == "kv.dcn" and c["bytes"] > 0
                           for c in run["comm"]):
                    raise SmokeFailure("dp: (a) %s rank %d recorded no "
                                       "cross-process all-reduce" % (key, r))
            if runs[0]["init"] != runs[1]["init"]:
                raise SmokeFailure("dp: (a) %s: the ranks began apart" % key)
            if runs[0]["final"] != runs[1]["final"]:
                raise SmokeFailure("dp: (a) %s: the ranks' parameters and "
                                   "momenta are not bit for bit equal" % key)
            print("[dp] (a) %s: both ranks' parameters and momenta bit for "
                  "bit equal after %d steps" % (key, len(runs[0]["step_ms"])))
        one = gloo[0]
        if one["one_init"] != gloo[0]["dropout 0"]["init"]:
            raise SmokeFailure("dp: the one-process run began elsewhere")
        print("[dp] (a) against one process on the concatenated %d x %d "
              "batch without a kvstore: relative L2 of the change %.3g "
              "(limit %.3g); its step %.1f ms (median), the ranks' %.1f and "
              "%.1f ms; %s"
              % (2 * DP_ROWS, TRAIN_SEQ, one["rel_l2"], DP_TOL,
                 statistics.median(one["one_step_ms"][1:]),
                 statistics.median(gloo[0]["dropout 0"]["step_ms"][1:]),
                 statistics.median(gloo[1]["dropout 0"]["step_ms"][1:]),
                 card_line))
        if not one["rel_l2"] <= DP_TOL:
            raise SmokeFailure("dp: (a) %.3g from the one-process run "
                               "(limit %g)" % (one["rel_l2"], DP_TOL))
        print("[dp] (a) control, the cross-process sum planted away: the "
              "ranks %s, relative L2 %.3g from the one-process run"
              % ("bit for bit" if gloo[0]["control"] == gloo[1]["control"]
                 else "apart", one["control_rel_l2"]))
        if gloo[0]["control"] == gloo[1]["control"] or \
                not one["control_rel_l2"] > DP_TOL:
            raise SmokeFailure("dp: (a) the control was not caught")
        for r in (0, 1):
            vote = gloo[r]["vote"] or ""
            print("[dp] (d) rank %d with MXNET_GUARD_COMM_VOTE=1, nan_grad "
                  "armed on rank 1: %s" % (r, vote or "no error"))
            if "originating rank(s) [1]" not in vote:
                raise SmokeFailure("dp: (d) rank %d did not name rank 1" % r)

        nccl, secs = _dp_launch("nccl", 1, seed, tmp)
        b = nccl[0]
        print("[dp] (b) 1 rank, backend %s, %d rows x seq %d, launched and "
              "run in %.1f s" % (b["backend"], DP_ROWS, TRAIN_SEQ, secs))
        if DEV == "cuda" and b["backend"] != "nccl":
            raise SmokeFailure("dp: one rank on a card must take NCCL")
        for key in ("dist_sync", "p3store_dist", "none"):
            _dp_print_run("(b) %s" % key, b[key], card_line)
            _dp_launch_check("(b) %s" % key, b[key], DP_KERNELS)
        for key in ("p3store_dist", "none"):
            if b[key]["final"] != b["dist_sync"]["final"]:
                raise SmokeFailure("dp: (b) %s is not bit for bit equal to "
                                   "dist_sync" % key)
        print("[dp] (b) p3store_dist (MXNET_KVSTORE_BIGARRAY_BOUND=%d) and "
              "the run without a kvstore bit for bit equal to dist_sync on "
              "NCCL" % DP_P3_BOUND)
        _dp_contexts(seed, card_line)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("[dp] phase 23 took %.1f s; %s" % (time.perf_counter() - t0,
                                            card_line))
    return (gloo[0]["dropout %g" % DP_DROPOUT]["launches"],
            {r: gloo[r]["quant"] for r in (0, 1)})


# ---------------------------------------------------------------------------
# 24. the SPMD sharded step: bert_bench's BERT-base and bench.py's
# ResNet-50 through parallel.ShardedTrainStep, two processes on one mesh
# ---------------------------------------------------------------------------
SHARD_STEPS = 10           # timed steps after the warm-up and the capture
SHARD_PARITY_STEPS = 3     # kernels against plain versions, dropout 0
SHARD_DROPOUT = 0.1
SHARD_LAMB = {"lr": 1e-3, "wd": 0.01}
SHARD_RESNET_SGD = {"lr": 0.1, "momentum": 0.9}
# (b)'s batches: bench.py's uniform one, phase 11's normal one
SHARD_RESNET_KINDS = ("uniform", "normal")
SHARD_BIASES = 32          # resnet50_v1's conv biases, each before a BN
SHARD_TWO_LAYERS = 2       # part (c)'s depth at full width
SHARD_TWO_ROWS = 8         # rows a rank in (c)
SHARD_TWO_STEPS = 3
# (a)'s control: every LayerNorm kernel's output this many times its own
SHARD_FAULT = 1.02
# the relative L2 distances: (a) the kernels against their plain
# versions, of the first step's gradients (bert_grads) and of the change
# over SHARD_PARITY_STEPS LAMB steps (bert); (b) the first loss and
# update with the layout pass on against off, on each batch; (c) two
# ranks against one process on the joined batch. Each limit is twice the
# largest of shard_readings(range(5), line) on an H100 80GB HBM3 at 700
# W: (a) gradients 0.0102, 0.0124, 0.0097, 0.0105, 0.0116 (the control,
# LayerNorm x1.02, read 0.204-0.245; LAMB's change under it 0.140-0.153,
# under this limit: LAMB's first steps are nearly sign(g)); LAMB 0.0775,
# 0.0839, 0.0806, 0.0750, 0.0804; (b) uniform: the loss 0 at every
# seed, the update 0.0446, 0.0357, 0.0732, 0.0524, 0.0774; normal: the
# loss 5.9e-5, 1.0e-3, 1.9e-4, 0, 0, the update 0.0288, 0.635, 0.660,
# 0.0301, 0.0300. The first update of this net at its initialization
# amplifies a change of the forward at the level of bf16's rounding:
# the pass off on the same batch reversed (its sums in another order)
# read up to 1.19 (normal, seed 4, where it moved the loss 9.8e-4), and
# every bf16 update, the pass on or off, is 1.35-1.40 from the f32 one
# (TF32 off); two unrelated updates read about 1.41, so the normal
# batch's limit holds little (ROADMAP queue 3). (c) 0.0339, 0.0341,
# 0.0346, 0.0339, 0.0336; its control, each rank on its own rows,
# 0.671-0.690.
SHARD_TOL = {"bert": 0.168, "bert_grads": 0.0247,
             "resnet": {"uniform": {"loss": 0.0, "update": 0.155},
                        "normal": {"loss": 0.00204, "update": 1.32},
                        "trained": {"loss": 0.000228, "update": 0.000584}},
             "two": 0.0691}
# (b) on phase 11's normal batch from weights past their initialization:
# SHARD_TRAINED_STEPS SGD steps with the pass off on batches of their own,
# then one update with the pass on against off. On an H100 80GB HBM3 at
# 700 W (shard_trained_readings) the loss read 7.2e-5, 3.8e-5, 1.1e-4,
# 3.7e-5, 3.8e-5 and the update 3.5e-5, 2.9e-4, 1.5e-4, 2.7e-4, 6.6e-6
# at seeds 0-4 (the witness, the batch reversed, 1.8e-7 to 4.2e-6); each
# limit ("trained") is twice the largest. At the initialization the same
# comparison read up to 0.660 (the first update amplifies any rounding
# change of the forward there); past it the conditioning is gone
SHARD_TRAINED_STEPS = 20
SHARD_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "selfatt_fwd",
                 "selfatt_bwd", "bias_gelu_fwd", "bias_gelu_bwd",
                 "bias_residual_fwd", "dropout")
SHARD_TIMEOUT = 300        # seconds the two-rank launch may take
SHARD_WORKER = ("import chip_smoke as cs, sys; "
                "sys.exit(cs.shard_worker())")


class _ShardLoss:
    """bert_bench's adapter of the parametric MLM head to the step's
    (outputs, labels): the head's per-position losses, their mean
    (``reduce="mean"``, bert_bench's) or their sum."""

    def __init__(self, blk, reduce="mean"):
        self._blk, self._reduce = blk, reduce

    def collect_params(self):
        return self._blk.collect_params()

    def __call__(self, outputs, labels):
        seq = outputs[0] if isinstance(outputs, (list, tuple)) else outputs
        per = self._blk(seq, labels)
        return [per.mean() if self._reduce == "mean" else per.sum()]


def _shard_bert(seed, dropout, layers=12, mesh=None, reduce="mean",
                specs=None, **kw):
    """bert_bench's pinned configuration at ``layers`` layers (full
    width): BERTModel without pooler, classifier and decoder, the chunked
    BERTMLMLoss head, biases, beta and gamma - 1 drawn from the seed
    (``_draw_affine``), LAMB in bf16 over ``mesh`` (default dp=1 on
    gpu(0)), 3 data inputs replicated (``specs`` to override)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTMLMLoss, BERTModel
    from mxnet_tpu_torch.parallel import (MeshConfig, P, ShardedTrainStep,
                                          make_mesh)
    ctx = mx.gpu(0) if DEV == "cuda" else mx.cpu()
    mx.random.seed(seed)
    net = BERTModel(num_layers=layers, units=UNITS, hidden_size=HIDDEN,
                    num_heads=HEADS, max_length=512, vocab_size=VOCAB,
                    dropout=dropout, use_pooler=False, use_classifier=False,
                    use_decoder=False, prefix="bert_")
    net.initialize(ctx=ctx)
    head = BERTMLMLoss(vocab_size=VOCAB, units=UNITS, mode="chunked",
                       prefix="decoder_")
    head.initialize(ctx=ctx)
    ids = mx.nd.array(np.zeros((2, TRAIN_SEQ), np.int32), dtype="int32",
                      ctx=ctx)
    with torch.no_grad():
        net(ids, ids)
    _draw_affine(net, seed)
    _draw_affine(head, seed + 1)
    if mesh is None:
        mesh = make_mesh(MeshConfig(dp=1), devices=[ctx])
    opts = dict(optimizer="lamb", dtype="bfloat16", n_data_inputs=3,
                data_specs=specs or [P(), P(), P()], seed=seed,
                **SHARD_LAMB)
    opts.update(kw)
    step = ShardedTrainStep(net, _ShardLoss(head, reduce), mesh, **opts)
    return net, head, step


def _shard_batch(seed, rows, lo=0, hi=None):
    """Token ids over the vocabulary past the special tokens, token types
    0, MLM labels on every position (int32), rows ``lo:hi`` of ``rows``."""
    import numpy as np
    import mxnet_tpu_torch as mx
    rng = np.random.RandomState(seed + 24)
    ids = rng.randint(1000, VOCAB, (rows, TRAIN_SEQ)).astype(np.int32)
    labels = rng.randint(1000, VOCAB, (rows, TRAIN_SEQ)).astype(np.int32)
    hi = rows if hi is None else hi
    ctx = mx.gpu(0) if DEV == "cuda" else mx.cpu()
    return [mx.nd.array(a[lo:hi], dtype="int32", ctx=ctx)
            for a in (ids, np.zeros_like(ids), labels)]


def _shard_params(step):
    """The step's masters by position (another model's names carry other
    counters)."""
    return {"p%04d" % i: v.tensor()
            for i, v in enumerate(step.params.values())}


def _shard_digest(step):
    return _dp_digest(_shard_params(step))


def _sync():
    if DEV == "cuda":
        import torch
        torch.cuda.synchronize()


def _planted_layer_norm(scale):
    """(a)'s control: every LayerNorm forward kernel's output ``scale``
    times what it computes (the backward left as it is)."""
    from unittest import mock
    from mxnet_tpu_torch.ops import cuda_norm
    real = cuda_norm.layer_norm_cuda
    return mock.patch.object(
        cuda_norm, "layer_norm_cuda",
        lambda x, g, b, eps: real(x, g, b, eps) * scale)


def _scope(kind):
    """The kernels as they are (``kernels``), their plain versions
    (``plain``) or the planted fault (``fault``: SHARD_FAULT, or
    ``fault@<scale>``)."""
    if kind == "plain":
        return _plain_kernels()
    if kind.startswith("fault"):
        return _planted_layer_norm(float(kind.split("@")[1]) if "@" in kind
                                   else SHARD_FAULT)
    return contextlib.nullcontext()


def _clone_params(step):
    return {k: v.clone() for k, v in _shard_params(step).items()}


def _shard_parity(seed, kinds, lamb_kinds):
    """(a) at dropout 0, from the same weights and batch under each of
    ``kinds`` (:func:`_scope`): the first step's gradients (SGD at lr 1,
    no momentum or weight decay, the loss the sum over the positions:
    each master moves by minus its gradient) and, for ``lamb_kinds``,
    SHARD_PARITY_STEPS captured LAMB steps. Returns the masters before
    and, by kind, after each: ``(base, lamb, gbase, grads)``."""
    batch = _shard_batch(seed, TRAIN_BATCH)
    lamb, grads = {}, {}
    for kind in kinds:
        with _scope(kind):
            if kind in lamb_kinds:
                _, _, step = _shard_bert(seed, 0.0)
                base = _clone_params(step)
                for _ in range(SHARD_PARITY_STEPS):
                    step.step(*batch)
                lamb[kind] = _clone_params(step)
                del step
                _free_cuda()
            _, _, step = _shard_bert(seed, 0.0, reduce="sum",
                                     optimizer="sgd", lr=1.0, momentum=0.0,
                                     wd=0.0)
            gbase = _clone_params(step)
            step.step(*batch)
            grads[kind] = _clone_params(step)
        del step
        _free_cuda()
    return base, lamb, gbase, grads


def _shard_parity_readings(seed, kinds, lamb_kinds=None):
    """The relative L2 distance from the plain versions of each kind's
    first gradients and (for ``lamb_kinds``, default all) LAMB change."""
    lamb_kinds = kinds if lamb_kinds is None else lamb_kinds
    base, lamb, gbase, grads = _shard_parity(seed, kinds, lamb_kinds)
    out = {}
    for kind in kinds:
        if kind != "plain":
            out[kind] = {"grads": _dp_rel(grads[kind], gbase, grads["plain"])}
            if kind in lamb_kinds:
                out[kind]["lamb"] = _dp_rel(lamb[kind], base, lamb["plain"])
    return out


def _free_cuda():
    import gc
    gc.collect()
    if DEV == "cuda":
        import torch
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _resnet_shard(seed, hoist=True, layout=True, dtype="bfloat16"):
    """bench.py's headline step: resnet50_v1 (MSRAPrelu), SGD lr 0.1
    momentum 0.9, in ``dtype``, on dp=1; with ``hoist`` False the conv
    weights stay in their stored layout (the conversions stay in the
    step). Returns the net and the step."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.parallel import (MeshConfig, P, ShardedTrainStep,
                                          make_mesh)
    ctx = mx.gpu(0) if DEV == "cuda" else mx.cpu()
    mx.random.seed(seed)
    net = resnet50_v1(prefix="resnet50_")
    net.initialize(init=mx.init.MSRAPrelu(), ctx=ctx)
    with torch.no_grad():
        net(mx.nd.zeros((1, 3, RESNET_SIDE, RESNET_SIDE), ctx=ctx))
    with _env_flag("MXNET_LAYOUT_OPT", "1" if layout else "0"):
        step = ShardedTrainStep(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
            make_mesh(MeshConfig(dp=1), devices=[ctx]), dtype=dtype,
            data_specs=[P(), P()], **SHARD_RESNET_SGD)
    if not hoist:
        step._hoisted = True
    return net, step


def _resnet_masters(step):
    """The step's f32 masters by name, copied."""
    return {k: v.tensor().clone() for k, v in step.params.items()}


def _resnet_states(step):
    return {k: [s.tensor().clone() for s in v]
            for k, v in step.states.items()}


def _conv_biases(net):
    """The names of ``net``'s conv biases: in resnet50_v1 each feeds one
    training BatchNorm, so the pass elides every one."""
    from mxnet_tpu_torch.gluon import nn
    out, todo = set(), [net]
    while todo:
        blk = todo.pop()
        if isinstance(blk, nn.Conv2D) and blk.bias is not None:
            out.add(blk.bias.name)
        todo.extend(blk._children.values())
    return out


def _replay_kernels(fn):
    """The device kernels one call of ``fn`` runs (torch.profiler), or
    None when the profiler sees none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    return names or None


def _step_ms(step, batch, n):
    """Each of ``n`` steps' device time, ms (CUDA events)."""
    import torch
    out = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step.step(*batch)
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def _shard_resnet_batch(seed, kind="uniform"):
    """bench.py's resident batch (``uniform``: [0, 1) images) or phase
    11's (``normal``: N(0, 1), :func:`_resnet_batch`), in bf16, labels
    over the 1000 classes, drawn on the card from ``seed``."""
    import torch
    import mxnet_tpu_torch as mx
    if kind == "normal":
        return _resnet_batch(seed)
    g = torch.Generator(device=DEV).manual_seed(seed + 24)
    x = torch.rand(RESNET_BATCH, 3, RESNET_SIDE, RESNET_SIDE, generator=g,
                   device=DEV)
    y = torch.randint(0, 1000, (RESNET_BATCH,), generator=g, device=DEV)
    return mx.nd.NDArray(x.to(torch.bfloat16)), mx.nd.NDArray(y.float())


def _rel_by(snap, base, ref, key):
    """:func:`_dp_rel` within each group ``key(name)`` (None: left out)."""
    num, den = collections.Counter(), collections.Counter()
    for k, r in ref.items():
        g = key(k)
        if g is None:
            continue
        d = (snap[k] - base[k]).double()
        e = (r - base[k]).double()
        num[g] += float(((d - e) ** 2).sum())
        den[g] += float((e ** 2).sum())
    return {g: (num[g] / den[g]) ** 0.5 if den[g] else None for g in den}


def _resnet_pass(seed, kind, keep=False, f32=False):
    """The first update (an eager step: the weights go channels-last
    after it) of fresh steps on the ``kind`` batch: the pass on, off, and
    off on the same batch with its samples in reverse order (the same
    function, its sums in another order: the witness of what rounding
    alone moves); with ``f32``, also off in f32 with TF32 off. Returns
    the readings and, with ``keep``, the pass-on step."""
    import torch
    import mxnet_tpu_torch as mx
    x, y = _shard_resnet_batch(seed, kind)
    flip = [mx.nd.NDArray(torch.flip(a.tensor(), [0])) for a in (x, y)]
    runs = [("on", True, (x, y), "bfloat16"), ("off", False, (x, y),
                                                 "bfloat16"),
            ("order", False, flip, "bfloat16")]
    if f32:
        runs.append(("f32", False, (mx.nd.NDArray(x.tensor().float()), y),
                     None))
    snaps, loss, base, kept = {}, {}, None, None
    for name, layout, b, dt in runs:
        with (_no_tf32() if dt is None else contextlib.nullcontext()):
            net, step = _resnet_shard(seed, layout=layout, dtype=dt)
            b0 = _resnet_masters(step)
            loss[name] = float(step.step(*b).asnumpy())
            snaps[name] = _resnet_masters(step)
        if base is None:
            base, biases = b0, _conv_biases(net)
            hoisted = set(step._param_transforms)
            frozen = {k for k in base if torch.equal(snaps[name][k], b0[k])}
            kept = step if keep else None
        elif _dp_digest(b0) != _dp_digest(base):
            raise SmokeFailure("sharded: (b) the %s run started from other "
                               "weights" % name)
        del net, step, b0
        _free_cuda()

    def group(k):
        if k in biases:
            return None
        if k in hoisted:
            return "hoisted"
        if k.endswith(("_gamma", "_beta")):
            return "bn"
        return "head" if "dense" in k else "1x1"

    def stage(k):
        if k in biases:
            return None
        for part in k.split("_"):
            if part.startswith("stage"):
                return part
        return "head" if "dense" in k else "stem"
    rd = {"loss": abs(loss["on"] - loss["off"]) / abs(loss["off"]),
          "pass": _dp_rel(snaps["on"], base, snaps["off"], skip=biases),
          "order": _dp_rel(snaps["order"], base, snaps["off"], skip=biases),
          "losses": [loss["on"], loss["off"], loss["order"]],
          "params": len(base), "biases": len(biases),
          "frozen": len(frozen), "frozen_are_biases": frozen == biases,
          "hoisted": len(hoisted)}
    for name, key in (("group", group), ("stage", stage)):
        rd[name] = {
            "pass": _rel_by(snaps["on"], base, snaps["off"], key),
            "order": _rel_by(snaps["order"], base, snaps["off"], key)}
    if f32:
        rd["f32"] = {w: _dp_rel(snaps[w], base, snaps["f32"], skip=biases)
                     for w in ("on", "off")}
        rd["f32_stage"] = {w: _rel_by(snaps[w], base, snaps["f32"], stage)
                           for w in ("on", "off")}
    return rd, kept


def _short(d):
    return json.dumps(d, default=lambda v: round(v, 4))


def _hoist_pair(seed, card_line):
    """The hoisted weights against a twin that converts them in every
    step (the pass on in both), under deterministic cuDNN on phase 11's
    normal batch: 3 steps (eager, the capture, a replay) bit for bit, then
    one profiled replay each."""
    import torch
    batch = _shard_resnet_batch(seed, "normal")
    got = {}
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for hoist in (True, False):
            _, step = _resnet_shard(seed, hoist=hoist)
            for _ in range(3):
                step.step(*batch)
            _sync()
            got[hoist] = {
                "form": step.form, "hoisted": len(step._param_transforms),
                "conversions": step.stats["weight_conversions"],
                "params": _dp_digest(_resnet_masters(step)),
                "states": _dp_digest({"%s:%d" % (k, i): s for k, v in
                                      _resnet_states(step).items()
                                      for i, s in enumerate(v)}),
                "kernels": _replay_kernels(lambda: step.step(*batch))}
            del step
            _free_cuda()
    finally:
        torch.backends.cudnn.deterministic = old
    h, t = got[True], got[False]
    same = h["params"] == t["params"] and h["states"] == t["states"]
    copies = {k: (None if g["kernels"] is None else
                  sum("copy" in n for n in g["kernels"]))
              for k, g in got.items()}
    print("[sharded] (b) the hoisted weights against the twin that converts "
          "them in every step (deterministic cuDNN, phase 11's normal "
          "batch, 3 steps: eager, the capture, a replay): forms %s / %s; "
          "%d / %d weights stored channels-last; weight conversions in the "
          "capture %s / %s; parameters and momenta %s; a profiled replay "
          "runs %s / %s kernels, %s / %s of them copies; %s"
          % (h["form"], t["form"], h["hoisted"], t["hoisted"],
             h["conversions"], t["conversions"],
             "bit for bit" if same else "APART",
             len(h["kernels"]) if h["kernels"] else "not measured",
             len(t["kernels"]) if t["kernels"] else "not measured",
             copies[True], copies[False], card_line))
    if h["kernels"] and t["kernels"]:
        more = collections.Counter(t["kernels"])
        more.subtract(collections.Counter(h["kernels"]))
        print("[sharded] (b) kernels by name, the twin's replay against the "
              "hoisted one's: more %s; fewer %s" % (
                  [(n[:90], c) for n, c in more.most_common(4) if c > 0],
                  [(n[:90], -c) for n, c in sorted(
                      more.items(), key=lambda kv: kv[1])[:4] if c < 0]))
    if h["form"] != "captured" or t["form"] != "captured":
        raise SmokeFailure("sharded: (b) a step ran %s / %s" % (
            h["form"], t["form"]))
    if h["conversions"] != 0 or not t["conversions"]:
        raise SmokeFailure("sharded: (b) weight conversions in the captures "
                           "%s (hoisted) / %s (twin): want 0 / more" % (
                               h["conversions"], t["conversions"]))
    if not same:
        raise SmokeFailure("sharded: (b) the hoisted step is not bit for bit "
                           "its twin after 3 steps")
    if None in copies.values():
        raise SmokeFailure("sharded: (b) the profiler saw no kernel in a "
                           "replay")
    if copies[False] - copies[True] != t["conversions"]:
        raise SmokeFailure("sharded: (b) the twin's replay runs %d copies "
                           "more than the hoisted one's, not its %d weight "
                           "conversions" % (copies[False] - copies[True],
                                            t["conversions"]))
    return t["conversions"]


def _shard_resnet(seed, card_line, readings=False):
    """(b): returns the readings of the pass on against off on each
    batch of SHARD_RESNET_KINDS (:func:`_resnet_pass`)."""
    out = {}
    first = None
    for kind in SHARD_RESNET_KINDS:
        rd, kept = _resnet_pass(seed, kind, keep=kind == "uniform"
                                and not readings, f32=readings)
        first = first or kept
        out[kind] = rd
        lim = SHARD_TOL["resnet"][kind]
        print("[sharded] (b) %s batch, the first update with the pass on "
              "against off: losses %s (on, off, off on the reversed batch), "
              "relative difference %.3g (limit %s); relative L2 of the "
              "change %.4g (limit %s), of the witness (off on the reversed "
              "batch) %.4g; by kind %s; by stage %s%s; %d of %d parameters "
              "still with the pass on, %s the %d conv biases; %d weights "
              "hoisted after it; %s"
              % (kind, rd["losses"], rd["loss"], lim["loss"], rd["pass"],
                 lim["update"], rd["order"],
                 _short(rd["group"]), _short(rd["stage"]),
                 "; against f32 (TF32 off) %s, by stage %s" % (
                     _short(rd["f32"]), _short(rd["f32_stage"]))
                 if readings else "", rd["frozen"], rd["params"],
                 "exactly" if rd["frozen_are_biases"] else "NOT",
                 rd["biases"], rd["hoisted"], card_line))
    if readings:
        return out
    for kind, rd in out.items():
        lim = SHARD_TOL["resnet"][kind]
        if not rd["loss"] <= lim["loss"]:
            raise SmokeFailure("sharded: (b) %s: the first loss %.3g from the "
                               "pass-off run (limit %g)" % (kind, rd["loss"],
                                                            lim["loss"]))
        if not rd["frozen_are_biases"] or rd["biases"] != SHARD_BIASES:
            raise SmokeFailure("sharded: (b) %s: %d parameters still, want "
                               "exactly the %d conv biases (%d found)" % (
                                   kind, rd["frozen"], SHARD_BIASES,
                                   rd["biases"]))
        if not rd["pass"] <= lim["update"]:
            raise SmokeFailure("sharded: (b) %s: the update %.3g from the "
                               "pass-off run (limit %g)" % (
                                   kind, rd["pass"], lim["update"]))
    _shard_trained(seed, card_line)
    conversions = _hoist_pair(seed, card_line)
    batch = _shard_resnet_batch(seed, "uniform")
    step = first
    step.step(*batch)       # the capture
    if step.form != "captured" or step.stats["weight_conversions"] != 0:
        raise SmokeFailure("sharded: (b) the step ran %s with %s weight "
                           "conversions in its capture" % (
                               step.form, step.stats["weight_conversions"]))
    hoisted = len(step._param_transforms)
    times = _step_ms(step, batch, SHARD_STEPS)
    from mxnet_tpu_torch.ops import cuda_build
    cuda_build.reset_launch_counts()
    step.step(*batch)
    _sync()
    port = {k: v for k, v in cuda_build.launch_counts().items() if v}
    del step, first
    _free_cuda()
    print("[sharded] (b) resnet50_v1, batch %d at %d^2, bf16, SGD lr %g "
          "momentum %g, dp=1, bench.py's uniform batch, the layout pass on: "
          "%d conv weights stored channels-last; the capture made 0 weight "
          "conversions (the twin without the hoisting: %d); step %.2f ms "
          "(median of %d, CUDA events), %.0f images/s; form captured; the "
          "port's kernels launched in a step: %s (no port kernel is on "
          "ResNet-50's path: cuDNN, cuBLAS and PyTorch's elementwise "
          "kernels); %s"
          % (RESNET_BATCH, RESNET_SIDE, SHARD_RESNET_SGD["lr"],
             SHARD_RESNET_SGD["momentum"], hoisted, conversions,
             statistics.median(times), len(times),
             RESNET_BATCH / statistics.median(times) * 1e3, port or "none",
             card_line))
    return out


def _resnet_trained_pass(seed, tmp):
    """(b) from weights past their initialization: SHARD_TRAINED_STEPS
    SGD steps with the pass off on normal batches of their own, saved;
    then one update on phase 11's normal batch from that state with the
    pass on, off, and off on the batch reversed (the witness). Returns
    the readings."""
    import torch
    import mxnet_tpu_torch as mx
    net, step = _resnet_shard(seed, layout=False)
    for s in range(SHARD_TRAINED_STEPS):
        step.step(*_shard_resnet_batch(seed * 1000 + 500 + s, "normal"))
    path = os.path.join(tmp, "trained.npz")
    step.save_states(path)
    biases = _conv_biases(net)
    del net, step
    _free_cuda()
    x, y = _shard_resnet_batch(seed, "normal")
    flip = [mx.nd.NDArray(torch.flip(a.tensor(), [0])) for a in (x, y)]
    snaps, loss, base = {}, {}, None
    for name, layout, b in (("on", True, (x, y)), ("off", False, (x, y)),
                            ("order", False, flip)):
        net, step = _resnet_shard(seed, layout=layout)
        step.load_states(path)
        b0 = _resnet_masters(step)
        loss[name] = float(step.step(*b).asnumpy())
        snaps[name] = _resnet_masters(step)
        if base is None:
            base = b0
        elif _dp_digest(b0) != _dp_digest(base):
            raise SmokeFailure("sharded: (b) the trained %s run started from "
                               "other weights" % name)
        del net, step, b0
        _free_cuda()
    return {"loss": abs(loss["on"] - loss["off"]) / abs(loss["off"]),
            "pass": _dp_rel(snaps["on"], base, snaps["off"], skip=biases),
            "order": _dp_rel(snaps["order"], base, snaps["off"],
                             skip=biases),
            "losses": [loss["on"], loss["off"], loss["order"]]}


def _shard_trained(seed, card_line, readings=False):
    """(b)'s trained comparison: prints it, holds it to its limits."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="mxt_rt_")
    try:
        rd = _resnet_trained_pass(seed, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lim = SHARD_TOL["resnet"]["trained"]
    print("[sharded] (b) normal batch from weights past their "
          "initialization (%d SGD steps with the pass off), one update "
          "with the pass on against off: losses %s (on, off, off on the "
          "reversed batch), relative difference %.3g (limit %s); relative L2 "
          "of the change %.4g (limit %s), of the witness %.4g; %s"
          % (SHARD_TRAINED_STEPS, rd["losses"], rd["loss"], lim["loss"],
             rd["pass"], lim["update"], rd["order"], card_line))
    if readings:
        return rd
    if not rd["loss"] <= lim["loss"]:
        raise SmokeFailure("sharded: (b) trained: the loss %.3g from the "
                           "pass-off run (limit %g)" % (rd["loss"],
                                                        lim["loss"]))
    if not rd["pass"] <= lim["update"]:
        raise SmokeFailure("sharded: (b) trained: the update %.3g from the "
                           "pass-off run (limit %g)" % (rd["pass"],
                                                        lim["update"]))
    return rd


def shard_trained_readings(seeds, card_line):
    """The trained comparison at each seed (the readings behind
    SHARD_TOL["resnet"]["trained"])."""
    return {seed: _shard_trained(seed, card_line, readings=True)
            for seed in seeds}


def shard_worker():
    """One rank of phase 24 (c), started by ``python -m
    mxnet_tpu_torch.tools.launch``: a mesh over both processes (their
    card: each process's gpu), BERT at SHARD_TWO_LAYERS layers and full
    width, LAMB in bf16, SHARD_TWO_ROWS x 128 a rank, the loss the sum of
    the per-position losses; then the control, a fresh step with the
    cross-process sum planted away; ``MXT_SH_SEED``; writes
    ``MXT_SH_OUT/<rank>.json``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist
    from mxnet_tpu_torch.parallel import P, _spmd, make_mesh
    seed = int(os.environ["MXT_SH_SEED"])
    dist.initialize()
    rank, nw = dist.rank(), dist.num_workers()
    mesh = make_mesh()
    rows = nw * SHARD_TWO_ROWS
    lo = rank * SHARD_TWO_ROWS
    out = {"rank": rank, "nw": nw, "backend": dist.backend(),
           "mesh": [[d.process_index, str(d.context)]
                    for d in mesh.devices.flat]}
    got, bases = {}, {}
    for name in ("run", "control"):
        if name == "control":
            _spmd._world_all_reduce = lambda t: None
        _, _, step = _shard_bert(seed, 0.0, SHARD_TWO_LAYERS, mesh=mesh,
                                 reduce="sum", specs=[P("dp")] * 3)
        bases[name] = _clone_params(step)
        times, losses = [], []
        for s in range(SHARD_TWO_STEPS):
            batch = _shard_batch(seed + s, rows, lo, lo + SHARD_TWO_ROWS)
            _sync()
            t0 = time.perf_counter()
            losses.append(float(step.step(*batch).asnumpy()))
            _sync()
            times.append((time.perf_counter() - t0) * 1e3)
        got[name] = _clone_params(step)
        out[name] = {
            "form": step.form, "losses": [repr(v) for v in losses],
            "step_ms": times, "digest": _dp_digest(got[name]),
            "reduce_ms": (None if step.stats["reduce_s"] is None
                          else step.stats["reduce_s"] * 1e3),
            "grad_mb": sum(v.numel() * 4 for v in got[name].values()) / 1e6}
        if name == "run":
            out["comm"] = [{k: r[k] for k in ("op", "axis", "ops", "bytes",
                                              "seconds", "algbw", "busbw")}
                           for r in mx.commwatch.report()]
        del step
        _free_cuda()
    if rank == 0:
        # one process on the joined batch
        _, _, one = _shard_bert(seed, 0.0, SHARD_TWO_LAYERS, reduce="sum")
        for s in range(SHARD_TWO_STEPS):
            one.step(*_shard_batch(seed + s, rows))
        for name in ("run", "control"):
            out[name]["rel_l2"] = _dp_rel(got[name], bases[name],
                                          _shard_params(one))
        out["one_form"] = one.form
    with open(os.path.join(os.environ["MXT_SH_OUT"], "%d.json" % rank),
              "w") as f:
        json.dump(out, f)
    return 0


def _shard_launch(seed, tmp):
    """The two ranks of (c) through the port's launcher from the
    checkout's root; every process is stopped at the end."""
    import signal
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, MXT_SH_SEED=str(seed), MXT_SH_OUT=tmp,
               MXNET_TELEMETRY="1", MXNET_COMMWATCH="1")
    for var in ("MXNET_FAULT_INJECT", "MXNET_DIST_CPU_DEVICES"):
        env.pop(var, None)
    log = os.path.join(tmp, "launch.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", "2",
             sys.executable, "-c", SHARD_WORKER],
            cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT,
            start_new_session=True)
        try:
            rc = proc.wait(timeout=SHARD_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    with open(log) as f:
        text = f.read()
    if rc != 0:
        raise SmokeFailure("sharded: the two-rank launch ended with %s:\n%s"
                           % (rc, text[-6000:]))
    out = {}
    for r in (0, 1):
        with open(os.path.join(tmp, "%d.json" % r)) as f:
            out[r] = json.load(f)
    return out, time.perf_counter() - t0


def _shard_two(seed, card_line, readings=False):
    """(c): returns the distances of the run and of the control from the
    one-process run."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="mxt_sh_")
    try:
        out, secs = _shard_launch(seed, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0, r1 = out[0]["run"], out[1]["run"]
    c0, c1 = out[0]["control"], out[1]["control"]
    if readings:
        return r0["rel_l2"], c0["rel_l2"]
    print("[sharded] (c) 2 ranks on one mesh %s, backend %s, BERT at %d "
          "layers and full width, LAMB in bf16, %d x %d a rank, %d steps: "
          "form %s (the one-process run %s); launched and run, with the "
          "control, in %.1f s; step %.1f / %.1f ms (rank 0 / 1, median, "
          "host clock); %s"
          % (out[0]["mesh"], out[0]["backend"], SHARD_TWO_LAYERS,
             SHARD_TWO_ROWS, TRAIN_SEQ, SHARD_TWO_STEPS, r0["form"],
             out[0]["one_form"], secs, statistics.median(r0["step_ms"][1:]),
             statistics.median(r1["step_ms"][1:]), card_line))
    if r0["form"] != "split" or r1["form"] != "split":
        raise SmokeFailure("sharded: (c) the step ran %s, not split around "
                           "the cross-process reduce" % r0["form"])
    for o in (out[0], out[1]):
        r = o["run"]
        print("[sharded] (c) rank %d: the cross-process all-reduce of the "
              "step's %.1f MB of f32 gradients took %.1f ms (the last step, "
              "host clock: gloo blocks), %.2f GB/s"
              % (o["rank"], r["grad_mb"], r["reduce_ms"],
                 r["grad_mb"] / r["reduce_ms"]))
        for c in o["comm"]:
            print("[sharded] (c) rank %d commwatch %s %s: %d ops, %.1f MB, "
                  "%.4f s, algbw %.2f GB/s, busbw %.2f GB/s (program-"
                  "effective: the payload over each whole step, the first "
                  "one eager)"
                  % (o["rank"], c["op"], c["axis"], c["ops"],
                     c["bytes"] / 1e6, c["seconds"], c["algbw"] / 1e9,
                     c["busbw"] / 1e9))
        if not any(c["op"] == "allreduce" and c["axis"] == "dp"
                   and c["bytes"] > 0 and c["algbw"] > 0
                   for c in o["comm"]):
            raise SmokeFailure("sharded: (c) rank %d recorded no "
                               "cross-process all-reduce" % o["rank"])
    if r0["digest"] != r1["digest"] or r0["losses"] != r1["losses"]:
        raise SmokeFailure("sharded: (c) the ranks' parameters are not bit "
                           "for bit equal")
    print("[sharded] (c) both ranks' parameters bit for bit equal; against "
          "one process on the joined %d x %d batch: relative L2 of the "
          "change %.3g (limit %s); the control (the cross-process sum "
          "planted away): ranks %s, %.3g from the one-process run"
          % (2 * SHARD_TWO_ROWS, TRAIN_SEQ, r0["rel_l2"], SHARD_TOL["two"],
             "bit for bit" if c0["digest"] == c1["digest"] else "apart",
             c0["rel_l2"]))
    if not r0["rel_l2"] <= SHARD_TOL["two"]:
        raise SmokeFailure("sharded: (c) %.3g from the one-process run "
                           "(limit %g)" % (r0["rel_l2"], SHARD_TOL["two"]))
    if c0["digest"] == c1["digest"] or not c0["rel_l2"] > SHARD_TOL["two"]:
        raise SmokeFailure("sharded: (c) the control was not caught")
    return r0["rel_l2"]


def shard_readings(seeds, card_line):
    """The readings behind SHARD_TOL at ``seeds``: (a) kernels against
    plain versions (LAMB's change and the first gradients) and the
    planted fault against them, (b) the pass on against off on both
    batches with their witness and the f32 distances, (c) two ranks
    against one process, and the control."""
    worst = collections.defaultdict(float)
    for seed in seeds:
        res = _shard_resnet(seed, card_line, readings=True)
        par = _shard_parity_readings(seed, ("kernels", "plain", "fault",
                                            "fault@1.05"))
        two, ctl = _shard_two(seed, card_line, readings=True)
        got = {"bert": par["kernels"]["lamb"],
               "bert_grads": par["kernels"]["grads"],
               "two": two, "two_control": ctl}
        for kind in ("fault", "fault@1.05"):
            got[kind + "_lamb"] = par[kind]["lamb"]
            got[kind + "_grads"] = par[kind]["grads"]
        for kind, rd in res.items():
            got["resnet_%s" % kind] = rd["pass"]
            got["resnet_%s_order" % kind] = rd["order"]
            got["resnet_%s_loss" % kind] = rd["loss"]
        for k, v in got.items():
            worst[k] = max(worst[k], v)
        print("[sharded] readings: seed %d: %s; %s"
              % (seed, json.dumps(got), card_line))
    print("[sharded] readings: largest %s, 2x %s"
          % (json.dumps(worst),
             json.dumps({k: 2 * v for k, v in worst.items()})))
    return worst


def phase_sharded(seed, card_line):
    """24. ShardedTrainStep on the card; returns (the wrappers' launches
    in the main run, the launches one captured step carries)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    print("[sharded] %s" % card_line)
    _free_cuda()
    par = _shard_parity_readings(seed, ("kernels", "plain", "fault"),
                                 ("kernels", "plain"))
    rel, grads = par["kernels"]["lamb"], par["kernels"]["grads"]
    print("[sharded] (a) bert_12_768_12 at dropout 0 against the plain "
          "versions: the first step's gradients %.4g (limit %s), %d "
          "captured LAMB steps' change %.4g (limit %s); the control (every "
          "LayerNorm kernel's output x%g): gradients %.4g"
          % (grads, SHARD_TOL["bert_grads"], SHARD_PARITY_STEPS, rel,
             SHARD_TOL["bert"], SHARD_FAULT, par["fault"]["grads"]))
    if not grads <= SHARD_TOL["bert_grads"]:
        raise SmokeFailure("sharded: (a) the gradients %.3g from the plain "
                           "versions' (limit %g)" % (grads,
                                                     SHARD_TOL["bert_grads"]))
    if not rel <= SHARD_TOL["bert"]:
        raise SmokeFailure("sharded: (a) kernels %.3g from their plain "
                           "versions (limit %g)" % (rel, SHARD_TOL["bert"]))
    if not par["fault"]["grads"] > SHARD_TOL["bert_grads"]:
        raise SmokeFailure("sharded: (a) the planted LayerNorm fault was not "
                           "caught (%.3g)" % par["fault"]["grads"])
    # the main run: counts from 0 over the warm-up, the capture and the
    # timed replays
    batch = _shard_batch(seed, TRAIN_BATCH)
    by_graph = {}
    cuda_build.reset_launch_counts()
    _, _, step = _shard_bert(seed, SHARD_DROPOUT)
    loss0 = float(step.step(*batch).asnumpy())
    reserved = torch.cuda.memory_reserved()
    with _capture_launches(by_graph) as per_step:
        _, held = _graph_mb(lambda: step.step(*batch))
    pool_mb = (torch.cuda.memory_reserved() - reserved) / 1e6
    times = _step_ms(step, batch, SHARD_STEPS)
    _sync()
    counts = {k: v for k, v in cuda_build.launch_counts().items() if v}
    per_step = {k: v for k, v in per_step.items() if v}
    state = {"step": 0, "region": "step"}
    with _sync_regions(state) as seen:
        step.step(*batch)
        _sync_free = len(seen)
    missing = [k for k in SHARD_KERNELS if not counts.get(k)]
    print("[sharded] (a) bert_12_768_12 (bert_bench's configuration: the "
          "chunked BERTMLMLoss head, LAMB lr %g wd %g, bf16, 3 inputs "
          "replicated) at %d x %d on dp=1 over gpu(0), dropout %g: form %s; "
          "first loss %.4f; step %.2f ms (median of %d, CUDA events); host "
          "reads in a steady step %d; the capture reserved %.1f MB more for "
          "its pool (allocated +%.1f MB after it, peak +%.1f MB while "
          "capturing); launches a step (rows 1-8, in the captured "
          "graph) %s; the wrappers' launches over the run %s; %s"
          % (SHARD_LAMB["lr"], SHARD_LAMB["wd"], TRAIN_BATCH, TRAIN_SEQ,
             SHARD_DROPOUT, step.form, loss0, statistics.median(times),
             len(times), _sync_free, pool_mb, held[0], held[1], per_step,
             counts,
             card_line))
    if step.form != "captured":
        raise SmokeFailure("sharded: (a) the step ran %s" % step.form)
    if missing or any(not per_step.get(k) for k in SHARD_KERNELS):
        raise SmokeFailure("sharded: (a) the step launched no %s (run %s, "
                           "graph %s)" % (missing, counts, per_step))
    if _sync_free:
        raise SmokeFailure("sharded: (a) a steady step read the card %d "
                           "time(s)" % _sync_free)
    if not np.isfinite(loss0):
        raise SmokeFailure("sharded: (a) the loss is not finite")
    # the random stream: two replays at lr 0 draw other masks
    step._hp["lr"] = 0.0
    step._build()
    frozen = [float(step.step(*batch).asnumpy()) for _ in range(3)]
    print("[sharded] (a) lr 0, dropout %g: losses %s (the first eager, "
          "then the capture's replay and a replay)" % (SHARD_DROPOUT,
                                                       frozen))
    if len(set(frozen)) != 3 or not all(np.isfinite(frozen)):
        raise SmokeFailure("sharded: (a) the dropout masks did not move "
                           "between steps: %s" % frozen)
    # save_states, 2 steps, load_states, 2 steps: bit for bit
    step._hp["lr"] = SHARD_LAMB["lr"]
    step._build()
    for _ in range(2):
        step.step(*batch)
    tmp = tempfile.mkdtemp(prefix="mxt_sh_")
    try:
        path = os.path.join(tmp, "states.npz")
        ts = time.perf_counter()
        step.save_states(path)
        save_s = time.perf_counter() - ts
        ref = [repr(float(step.step(*batch).asnumpy())) for _ in range(2)]
        ref_digest = _shard_digest(step)
        ts = time.perf_counter()
        step.load_states(path)
        load_s = time.perf_counter() - ts
        got = [repr(float(step.step(*batch).asnumpy())) for _ in range(2)]
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = got == ref and _shard_digest(step) == ref_digest
    print("[sharded] (a) save_states (%.0f MB, %.1f s), 2 steps, load_states "
          "(%.1f s), 2 steps: losses %s against %s, parameters %s"
          % (size / 1e6, save_s, load_s, got, ref,
             "bit for bit" if same else "APART"))
    if not same:
        raise SmokeFailure("sharded: (a) the resumed steps are not bit for "
                           "bit the uninterrupted ones")
    del step
    _free_cuda()
    _shard_resnet(seed, card_line)
    _shard_two(seed, card_line)
    print("[sharded] phase 24 took %.1f s; %s" % (time.perf_counter() - t0,
                                                 card_line))
    return counts, per_step

# ---------------------------------------------------------------------------
# 25. ZeRO weight-update sharding, the quantized wire and elastic
# resharding: BERT-base trained by a Trainer over a card replica and a host
# replica ([gpu(0), cpu(0)]: a machine with one card holds only one, and ZeRO
# needs two distinct replica devices in one process)
# ---------------------------------------------------------------------------
ZERO_ROWS = 1              # rows a replica: 1 x seq 128
ZERO_STEPS = 2             # steps after the first
ZERO_LAYERS = 12
ZERO_ADAM = {"learning_rate": 1e-4}
# (a) ZeRO against the same run with MXNET_ZERO=0, relative L2 of the
# parameters' change over the steps (and of the Adam moments): the two
# paths sum the replicas' gradients in the same order on the card, but the
# replicated path updates the card replica on the card where ZeRO updates
# half of every parameter on the host, whose roundings of Adam's square
# root and quotient differ in the last bit. On an H100 80GB HBM3 at 700 W
# the change read 5.03e-08, 4.95e-08, 4.97e-08, 5.12e-08, 5.16e-08 and the
# moments 8.9e-14, 1.5e-11, 0, 0, 1.6e-11 at seeds 0-4 (zero_readings);
# the limit is twice the largest. The control (the reduce-scatter's sum
# planted away: each fragment updated from its owner's own half of the
# batch) read 0.808-0.882
ZERO_TOL = 1.04e-07
ZERO_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "selfatt_fwd",
                "selfatt_bwd", "bias_gelu_fwd", "bias_gelu_bwd",
                "bias_residual_fwd")
ZERO_QUANT_BLOCK = 256
ZERO_QUANT_STEPS = 1       # (b): the identity's steps
NOISE_ROWS = 2             # (a)'s noise step: rows a replica, one shared
NOISE_BATCH = 999          # ... drawn as _dp_batch's step 999
# (c) 2 layers at full width, SGD momentum, ZeRO over 4 contexts, a fit
# of 2 epochs of 2 batches; the slice_preempt site fires at step 3
ELASTIC_LAYERS = 2
ELASTIC_ROWS = 1           # rows a context before the move (4 a batch)
ELASTIC_SGD = {"learning_rate": 1e-3, "momentum": 0.9}
ELASTIC_BLOCK = 1 << 20    # MXNET_ELASTIC_BLOCK: a move of many blocks
ELASTIC_SLACK = 1 << 20    # bytes beside the bound (the transition check)


def _zero_ctxs():
    import mxnet_tpu_torch as mx
    return [mx.gpu(0) if DEV == "cuda" else mx.cpu(1), mx.cpu(0)]


def _zero_parts(mx, seed, step, ctxs, rows):
    data, labels = _dp_batch(seed, step)
    data, labels = data[:rows * len(ctxs)], labels[:rows * len(ctxs)]
    return [(mx.nd.array(data[i * rows:(i + 1) * rows], dtype="int32",
                         ctx=c),
             mx.nd.array(labels[i * rows:(i + 1) * rows], ctx=c))
            for i, c in enumerate(ctxs)]


def _zero_step(mx, net, trainer, seed, s, ctxs, rows=ZERO_ROWS,
               before_step=None):
    """One step of ``rows`` a replica (the global batch's first rows);
    returns its wall ms, the card synchronised around it (the host
    replica runs in the step, so the host clock). ``before_step`` runs
    between the backward and the update."""
    import torch
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    parts = _zero_parts(mx, seed, s, ctxs, rows)
    mx.random.seed(seed + 100 + s)
    if DEV == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mx.autograd.record():
        losses = [loss_fn(net(d), lab).sum() for d, lab in parts]
    for loss in losses:
        loss.backward()
    if before_step is not None:
        before_step()
    trainer.step(rows * len(ctxs))
    if DEV == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _zero_trainer(mx, seed, zero, layers=ZERO_LAYERS, ctxs=None):
    ctxs = ctxs or _zero_ctxs()
    with _env_flag("MXNET_ZERO", "1" if zero else "0"):
        net = _dp_model(seed, layers, 0.0, ctx=ctxs)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   dict(ZERO_ADAM), kvstore="device")
    return net, trainer, ctxs


def _zero_snap(net, trainer, ctx):
    """The parameters on ``ctx`` and the Adam moments, f32 on the card,
    by position (the moments gathered from a ZeRO engine's fragments)."""
    from mxnet_tpu_torch.gluon import zero as zero_mod
    dev = _zero_ctxs()[0].torch_device
    out = {"p%04d" % i: p.data(ctx).tensor().detach().float().to(dev)
           for i, p in enumerate(net.collect_params().values())}
    if isinstance(trainer._zero, zero_mod.ZeroEngine):
        states = trainer._zero.gather_states()
    else:
        states = trainer._updaters[0].states
    for i, st in sorted(states.items()):
        for j, s in enumerate(st):
            out["mom:%d:%04d" % (j, i)] = \
                s.tensor().detach().float().to(dev)
    return out


def _rel_moments(a, b):
    num = den = 0.0
    for k, v in b.items():
        if not k.startswith("mom:"):
            continue
        num += float(((a[k] - v).double() ** 2).sum())
        den += float((v.double() ** 2).sum())
    return (num / den) ** 0.5 if den > 0 else float("inf")


def _zero_main(mx, seed, card_line, readings=False):
    """(a): the ZeRO Trainer and the replicated one from the same
    weights, a step each in turn; returns (the readings, the card
    replica's launches in one ZeRO step)."""
    import torch
    from mxnet_tpu_torch.gluon import zero as zero_mod
    from mxnet_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    netz, trz, ctxs = _zero_trainer(mx, seed, True)
    netr, trr, _ = _zero_trainer(mx, seed, False)
    build_s = time.perf_counter() - t0
    base = _dp_snapshot(netz)
    if _dp_digest(base) != _dp_digest(_dp_snapshot(netr)):
        raise SmokeFailure("zero: (a) the two runs began apart")
    mx.telemetry.reset()
    mx.commwatch.reset()
    times = {"zero": [], "replicated": []}
    counts, step_counts = {}, {}
    for s in range(1 + ZERO_STEPS):
        cuda_build.reset_launch_counts()
        with _env_flag("MXNET_ZERO", "1"):
            times["zero"].append(_zero_step(mx, netz, trz, seed, s, ctxs))
        step_counts = {k: v for k, v in cuda_build.launch_counts().items()
                       if v}
        for k, v in step_counts.items():
            counts[k] = counts.get(k, 0) + v
        if not isinstance(trz._zero, zero_mod.ZeroEngine):
            raise SmokeFailure("zero: (a) the Trainer did not shard: %r"
                               % (trz._zero,))
        for p in netz.collect_params().values():
            a, b = (p.data(c).tensor() for c in ctxs)
            if not torch.equal(_bits(a.cpu()), _bits(b.cpu())):
                raise SmokeFailure("zero: (a) the replicas of %s are apart "
                                   "after step %d" % (p.name, s))
        with _env_flag("MXNET_ZERO", "0"):
            times["replicated"].append(_zero_step(mx, netr, trr, seed, s,
                                                  ctxs))
    if trr._zero is not False or trr._kvstore is None or \
            trr._kvstore.type != "device":
        raise SmokeFailure("zero: (a) the replicated run was not the "
                           "device kvstore's")
    sz, sr = _zero_snap(netz, trz, ctxs[0]), _zero_snap(netr, trr, ctxs[0])
    rel = _dp_rel(sz, base, sr)
    rel_m = _rel_moments(sz, sr)
    bz, br = trz.optimizer_state_bytes(), trr.optimizer_state_bytes()
    eng = trz._zero
    per_ctx = eng.state_bytes_per_replica()
    missing = [k for k in ZERO_KERNELS if not counts.get(k)]
    print("[zero] (a) bert_12_768_12 + dense MLM head, f32 parameters under "
          "bf16 AMP, dropout 0, Adam lr %g, MXNET_ZERO=1 over %s, %d x %d a "
          "replica, %d steps: engine %s, %d fragments in %d group(s); the "
          "replicas bit for bit after every step; against MXNET_ZERO=0 (the "
          "device kvstore) from the same weights: relative L2 of the change "
          "%.3g, of the Adam moments %.3g (limit %g); optimizer state %d "
          "bytes (%d a context) against %d replicated (ratio %.4f); built in "
          "%.1f s"
          % (ZERO_ADAM["learning_rate"], [str(c) for c in ctxs], ZERO_ROWS,
             TRAIN_SEQ, 1 + ZERO_STEPS, type(eng).__name__, len(eng._items),
             len(eng._groups), rel, rel_m, ZERO_TOL, bz, per_ctx, br,
             bz / br, build_s))
    print("[zero] (a) ms a step, in turns (median of the %d after the "
          "first; host clock, the card synchronised): ZeRO %.1f, replicated "
          "%.1f; the card replica's launches in one ZeRO step %s, over the "
          "run %s; %s"
          % (ZERO_STEPS, statistics.median(times["zero"][1:]),
             statistics.median(times["replicated"][1:]), step_counts,
             counts, card_line))
    out = {"rel": rel, "rel_moments": rel_m, "ratio": bz / br,
           "zero_ms": statistics.median(times["zero"][1:]),
           "replicated_ms": statistics.median(times["replicated"][1:]),
           "wire": _wire_bytes()}
    del sr
    _free_cuda()
    out["noise"] = _noise_step(mx, netr, trr, seed, ctxs)
    # the control: the reduce-scatter's sum planted away
    from mxnet_tpu_torch.parallel import collectives as coll
    real = coll.hierarchical_reduce_scatter

    def local(x, ici_axis="dp", dcn_axis=None, scatter_axis=0):
        n = coll.axis_size(ici_axis)
        k = x.shape[scatter_axis] // n
        return x.narrow(scatter_axis, coll._axis_index(ici_axis) * k,
                        k).clone()
    coll.hierarchical_reduce_scatter = local
    try:
        netc, trc, _ = _zero_trainer(mx, seed, True)
        with _env_flag("MXNET_ZERO", "1"):
            for s in range(1 + ZERO_STEPS):
                _zero_step(mx, netc, trc, seed, s, ctxs)
    finally:
        coll.hierarchical_reduce_scatter = real
    sc = _zero_snap(netc, trc, ctxs[0])
    out["control"] = _dp_rel(sc, base, sz)
    print("[zero] (a) control, the reduce-scatter's sum planted away (each "
          "fragment updated from its owner's half of the batch): relative "
          "L2 of the change %.3g from the ZeRO run (must exceed %g)"
          % (out["control"], ZERO_TOL))
    del netc, trc, sc
    _free_cuda()
    runs = (netz, trz, netr, trr)
    if readings:
        return out, step_counts, runs
    if missing and DEV == "cuda":
        raise SmokeFailure("zero: (a) the card replica launched no %s (%s)"
                           % (missing, counts))
    if not rel <= ZERO_TOL or not rel_m <= ZERO_TOL:
        raise SmokeFailure("zero: (a) %.3g (moments %.3g) from the "
                           "replicated run (limit %g)" % (rel, rel_m,
                                                          ZERO_TOL))
    if not out["control"] > ZERO_TOL:
        raise SmokeFailure("zero: (a) the planted reduce-scatter fault was "
                           "not caught (%.3g)" % out["control"])
    if not bz <= 0.5 * br * 1.01:
        raise SmokeFailure("zero: (a) the sharded state is %d bytes against "
                           "%d replicated" % (bz, br))
    return out, step_counts, runs


def _noise_parts(mx, seed, ctxs):
    """The noise step's batch: ``NOISE_ROWS`` rows a replica, the first
    the same row on every replica. At two replicas |G|^2's estimate is
    the dot product of their gradients; at random weights and labels,
    rows drawn apart give one as often negative (the noise scale then
    undefined), a row in common one that stands clear of zero."""
    data, labels = _dp_batch(seed, NOISE_BATCH)
    k = NOISE_ROWS - 1
    parts = []
    for i, c in enumerate(ctxs):
        idx = [0] + list(range(1 + i * k, 1 + (i + 1) * k))
        parts.append((mx.nd.array(data[idx], dtype="int32", ctx=c),
                      mx.nd.array(labels[idx], ctx=c)))
    return parts


def _noise_step(mx, net, trainer, seed, ctxs):
    """One step of (a)'s replicated Trainer with modelwatch on from it
    (a fresh watch, so the step is its first sample): its noise scale,
    gauge and suggested batch, with the host's formula over the
    replicas' gradients read before the all-reduce (phase 26 (e))."""
    from mxnet_tpu_torch import modelwatch as mw_mod
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    parts = _noise_parts(mx, seed, ctxs)
    batch = NOISE_ROWS * len(ctxs)
    with _env_flag("MXNET_MODELWATCH", "1"):
        trainer.modelwatch = mw_mod.from_env()
    with mx.autograd.record():
        losses = [loss_fn(net(d), lab).sum() for d, lab in parts]
    for loss in losses:
        loss.backward()
    grads = [[p.list_grad()[r].asnumpy().astype("float64")
              for p in trainer._params
              if p.grad_req != "null" and p._data is not None]
             for r in range(len(ctxs))]
    with _env_flag("MXNET_ZERO", "0"):
        trainer.step(batch)
    mw = trainer.modelwatch
    out = {"ctxs": [str(c) for c in ctxs], "nrep": len(ctxs),
           "batch": batch, "scale": mw.noise_scale,
           "suggested": mw.suggested_batch(),
           "gauge": mx.telemetry.snapshot()["gauges"].get(
               "mx_grad_noise_scale"),
           "s": mw._noise_ema["s"], "g2": mw._noise_ema["g2"],
           "expect": _noise_expect(grads, batch)}
    trainer.modelwatch = None
    return out


def zero_readings(seeds, card_line):
    """(a)'s distances at each seed (the readings behind ZERO_TOL)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp
    amp.init(target_dtype="bfloat16")
    try:
        for seed in seeds:
            out, _, _ = _zero_main(mx, seed, card_line, readings=True)
            out.pop("wire")
            print("[zero] readings: seed %d: %s; %s"
                  % (seed, json.dumps(out), card_line))
            _free_cuda()
    finally:
        amp.reset()


def _quant_rows_card(seed, eng):
    """quantize_rows on the card bit for bit with its CPU run, int8 and
    fp8, on BERT-base's largest gradient (the word embedding) in the
    ZeRO layout: (N, its fragment length)."""
    import torch
    from mxnet_tpu_torch.parallel import quantize as qz
    n, C = eng._n, max(it.frag for it in eng._items)
    g = torch.Generator(device="cpu").manual_seed(seed + 25)
    x = (torch.randn(n, C, generator=g) *
         torch.logspace(-4, 1, n * C // 4096 + 1).repeat_interleave(4096)
         [:n * C].reshape(n, C))
    out = {}
    for mode in ("int8", "fp8"):
        cfg = qz.QuantConfig(mode=mode, block=ZERO_QUANT_BLOCK)
        qc, sc, ec = qz.quantize_rows(x, cfg)
        qg, sg, eg = qz.quantize_rows(x.to(DEV), cfg)
        same = torch.equal(_bits(qc.view(torch.uint8)),
                           _bits(qg.view(torch.uint8).cpu())) and \
            torch.equal(_bits(sc), _bits(sg.cpu())) and \
            torch.equal(_bits(ec), _bits(eg.cpu()))
        out[mode] = same
        if not same:
            raise SmokeFailure("zero: (b) quantize_rows %s on the card is not "
                               "bit for bit its CPU run" % mode)
    return (n, C), out


def _wire_bytes():
    import mxnet_tpu_torch as mx
    by = collections.Counter()
    for r in mx.commwatch.report():
        by[(r["op"], r.get("dtype") or "f32")] += r["bytes"]
    return dict(by)


def _quant_steps(mx, net, trainer, seed, lo, ctxs, zero, before=None,
                 after=None):
    """Steps lo .. lo + ZERO_QUANT_STEPS of (a)'s run (its batches), with
    ``before(grads)`` on the replicas' local gradients and ``after()``
    around each."""
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for s in range(lo, lo + ZERO_QUANT_STEPS):
        parts = _zero_parts(mx, seed, s, ctxs, ZERO_ROWS)
        with mx.autograd.record():
            losses = [loss_fn(net(d), lab).sum() for d, lab in parts]
        for loss in losses:
            loss.backward()
        if before is not None:
            before()
        with _env_flag("MXNET_ZERO", "1" if zero else "0"):
            trainer.step(ZERO_ROWS * len(ctxs))
        if after is not None:
            after()


def _quant_identity_kv(mx, seed, ctxs, net, tr, lo):
    """(a)'s replicated run continued on the int8 wire of the device
    kvstore: over the steps, the outputs plus the residuals' sum equal
    the true sums plus the first residuals (zero), relative to
    max(|true|, 1); returns that error and the wire bytes."""
    import torch
    dev = ctxs[0].torch_device
    # the store's keys are the Trainer's parameter indices
    live = [(i, p) for i, p in enumerate(tr._params)
            if p.grad_req != "null"]
    acc = {}

    def before():
        true = [sum(g.tensor().double().to(dev) for g in p.list_grad())
                for _, p in live]
        acc["true"] = true if "true" not in acc else \
            [a + b for a, b in zip(acc["true"], true)]

    def after():
        outs = [p.list_grad()[0].tensor().double().to(dev)
                for _, p in live]
        acc["out"] = outs if "out" not in acc else \
            [a + b for a, b in zip(acc["out"], outs)]
    mx.telemetry.reset()
    mx.commwatch.reset()
    _quant_steps(mx, net, tr, seed, lo, ctxs, False, before, after)
    res = tr._kvstore.quant_residuals_export()
    worst = 0.0
    for j, (i, p) in enumerate(live):
        t = acc["true"][j]
        r = torch.from_numpy(res[str(i)]).double().to(dev).reshape(t.shape)
        err = ((acc["out"][j] + r - t).abs() / t.abs().clamp_min(1.0)).max()
        worst = max(worst, float(err))
    return worst, _wire_bytes()


def _quant_identity_zero(mx, seed, ctxs, net, tr, lo):
    """(a)'s ZeRO run continued on the int8 wire: the scattered shards
    (captured at the engine's reduce) plus the replica-summed residual
    equal the true sums plus the first residual (zero) over the steps;
    returns that error and the wire bytes."""
    import torch
    dev = ctxs[0].torch_device
    mx.telemetry.reset()
    mx.commwatch.reset()
    eng = tr._zero
    # the engine takes the wire (zero residuals) at its next step's check;
    # taken here, the identity starts from those zeros
    if not eng._check_rebuild() or eng._quant is None:
        raise SmokeFailure("zero: (b) the engine did not take the wire")
    n, g0 = eng._n, eng._groups[0]
    shards = {}
    real = eng._reduce

    def rec(p, grads, key):
        sh, gres = real(p, grads, key)
        shards[p] = sh[0].double().to(dev)
        return sh, gres

    def gmat(grads):
        cols = []
        for it in g0.items:
            flat = grads[it.pos].reshape(-1).double().to(dev)
            pad = torch.zeros(it.frag * n, dtype=torch.float64, device=dev)
            pad[:it.size] = flat
            cols.append(pad.reshape(n, it.frag))
        return torch.cat(cols, dim=1)

    def res_sum():
        return sum(eng._gres[0][p].double().to(dev).reshape(n, g0.C)
                   for p in range(n))
    res0 = res_sum()
    tot = {"sh": torch.zeros((n, g0.C), dtype=torch.float64, device=dev)}
    tot["true"] = torch.zeros_like(tot["sh"])

    def before():
        grads, _ = eng._tensors()
        tot["true"] += sum(gmat(g) for g in grads)

    def after():
        for p in range(n):
            tot["sh"][eng._owner[p]] += shards[p]
    eng._reduce = rec
    try:
        _quant_steps(mx, net, tr, seed, lo, ctxs, True, before, after)
    finally:
        eng._reduce = real
    err = float(((tot["sh"] + res_sum() - tot["true"] - res0).abs()
                 / tot["true"].abs().clamp_min(1.0)).max())
    return err, _wire_bytes()


def _zero_quant(mx, seed, card_line, runs, f32_wire):
    """(b): quantize_rows on the card; (a)'s two runs continued on the
    int8 wire, ZeRO and the device kvstore."""
    netz, trz, netr, trr = runs
    shape, _ = _quant_rows_card(seed, trz._zero)
    print("[zero] (b) quantize_rows on the card bit for bit with its CPU "
          "run, int8 and fp8, block %d, on the word embedding's %s "
          "gradient fragments (q, scales and the carried error)"
          % (ZERO_QUANT_BLOCK, list(shape)))
    ctxs = _zero_ctxs()
    lo = 1 + ZERO_STEPS
    with _env_flag("MXNET_KVSTORE_QUANTIZE", "int8"), \
            _env_flag("MXNET_KVSTORE_QUANTIZE_BLOCK",
                      str(ZERO_QUANT_BLOCK)):
        err_z, wire_z = _quant_identity_zero(mx, seed, ctxs, netz, trz, lo)
        err_kv, wire_kv = _quant_identity_kv(mx, seed, ctxs, netr, trr, lo)
    print("[zero] (b) (a)'s runs continued with MXNET_KVSTORE_QUANTIZE=int8, "
          "%d steps each: the error-feedback identity (outputs + residuals "
          "against the true sums + the first residuals), largest error "
          "relative to max(|sum|, 1): ZeRO %.3g, device kvstore %.3g (limit "
          "1e-5); wire bytes by (op, dtype) over the steps: ZeRO %s, "
          "kvstore %s; the f32 ZeRO run's over (a)'s %d steps %s; %s"
          % (ZERO_QUANT_STEPS, err_z, err_kv, wire_z, wire_kv,
             1 + ZERO_STEPS, f32_wire, card_line))
    for tag, err, wire in (("ZeRO", err_z, wire_z),
                           ("kvstore", err_kv, wire_kv)):
        if not err <= 1e-5:
            raise SmokeFailure("zero: (b) %s: the error-feedback identity "
                               "is off by %.3g" % (tag, err))
        if not any(d == "int8" and b > 0 for (op, d), b in wire.items()):
            raise SmokeFailure("zero: (b) %s recorded no int8 payload: %s"
                               % (tag, wire))
    return {"zero": err_z, "kv": err_kv}


def _elastic_est(mx, seed, ctxs):
    """BERT at ELASTIC_LAYERS layers, full width, ZeRO with SGD momentum,
    an Estimator over ``ctxs``."""
    with _env_flag("MXNET_ZERO", "1"):
        net = _dp_model(seed, ELASTIC_LAYERS, 0.0, ctx=ctxs)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(ELASTIC_SGD),
                          kvstore="device")
    est = mx.gluon.contrib.estimator.Estimator(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
        train_metrics=[mx.metric.Loss()], trainer=tr, context=list(ctxs))
    return net, tr, est


def _elastic_loader(mx, seed, lo, hi):
    """Batches of 4 * ELASTIC_ROWS rows: the global batches of steps
    lo..hi-1 (each step's own rows, as _dp_batch draws them)."""
    import numpy as np
    rows = 4 * ELASTIC_ROWS
    data, labels = [], []
    for s in range(lo, hi):
        d, lab = _dp_batch(seed + 50, s)
        data.append(d[:rows])
        labels.append(lab[:rows])
    return mx.gluon.data.DataLoader(
        mx.gluon.data.ArrayDataset(np.concatenate(data),
                                   np.concatenate(labels)), batch_size=rows)


def _elastic_digest(net, tr):
    """The digest of the parameters (replica 0) and the optimizer state
    gathered to the replicated layout."""
    snap = _dp_snapshot(net)
    from mxnet_tpu_torch.gluon import zero as zero_mod
    states = tr._zero.gather_states() if isinstance(
        tr._zero, zero_mod.ZeroEngine) else tr._updaters[0].states
    for i, st in sorted(states.items()):
        if st is not None:
            snap["mom:%s" % i] = st.tensor().detach().float().clone()
    return _dp_digest(snap)


def _elastic_run(mx, seed, ctxs, kind, tmp):
    """The fit with MXNET_ELASTIC=1: 2 epochs of 2 batches over ``ctxs``,
    slice_preempt at step 3 (poll every 3 steps), ``reshard_fail`` armed
    for ``kind`` "restored". Returns (net, trainer, the transition's
    outcome and seconds, the card's peak growth over the state move and
    its bound, blocks moved)."""
    import torch
    from mxnet_tpu_torch import elastic
    from mxnet_tpu_torch.gluon import zero as zero_mod
    net, tr, est = _elastic_est(mx, seed, ctxs)
    seen = {"base": _dp_snapshot(net)}
    real_move = zero_mod.ZeroEngine.reshard_from
    real_tr = elastic.run_transition

    def move(self, old, blk_bytes=None):
        dev = torch.device(DEV)
        if DEV == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
        real_move(self, old, blk_bytes=blk_bytes)
        if DEV == "cuda":
            torch.cuda.synchronize()
            seen["growth"] = torch.cuda.max_memory_allocated(dev) - before
        seen["bound"] = self._groups[0].C * 4 + ELASTIC_BLOCK + ELASTIC_SLACK
        seen["shard"] = self._groups[0].C * 4

    def transition(trainer, survivors, restore=None):
        # the state the transition starts from: the live control's start
        seen["state"] = ({k: p.data().copy() for k, p in
                          net._structural_params().items()},
                         trainer.states_blob())
        t0 = time.perf_counter()
        seen["outcome"] = real_tr(trainer, survivors, restore)
        seen["seconds"] = time.perf_counter() - t0
        seen["post"] = _elastic_digest(net, trainer)
        return seen["outcome"]
    zero_mod.ZeroEngine.reshard_from = move
    elastic.run_transition = transition
    mx.telemetry.reset()
    try:
        with _env_flag("MXNET_ZERO", "1"), _env_flag("MXNET_ELASTIC", "1"), \
                _env_flag("MXNET_ELASTIC_POLL", "3"), \
                _env_flag("MXNET_ELASTIC_BLOCK", str(ELASTIC_BLOCK)):
            mx.faultinject.set_fault("slice_preempt", 1.0, 1)
            if kind == "restored":
                mx.faultinject.set_fault("reshard_fail", 1.0)
            est.fit(_elastic_loader(mx, seed, 0, 2), epochs=2,
                    ckpt_prefix=os.path.join(tmp, kind))
    finally:
        zero_mod.ZeroEngine.reshard_from = real_move
        elastic.run_transition = real_tr
        mx.faultinject.clear()
        elastic.clear()
    snap = mx.telemetry.snapshot()["counters"]
    seen["blocks"] = snap.get('mx_reshard_blocks_total{kind="zero.state"}',
                              0)
    return net, tr, seen


def _elastic_control(mx, seed, ctxs, kind, tmp, seen):
    """The run the transition must equal: a fresh Trainer on [gpu(0),
    cpu(0)] resumed from the state it started from (the live move's: the
    parameters and the gathered states at step 3; the restore's: the
    epoch-1 checkpoint's files), then step 4."""
    with _env_flag("MXNET_ZERO", "1"):
        net2, tr2, est2 = _elastic_est(mx, seed, ctxs[:2])
        if kind == "live":
            params, blob = seen["state"]
        else:
            from mxnet_tpu_torch import model
            prefix = os.path.join(tmp, kind)
            saved = mx.nd.load("%s-0001.params" % prefix)
            params = {k[4:]: v for k, v in saved.items()
                      if k.startswith("arg:")}
            blob = model.load_checkpoint_states(prefix, 1)
        est2._restore_arg_params(params)
        tr2.load_states_blob(blob)
        post = _elastic_digest(net2, tr2)
        est2.fit(_elastic_loader(mx, seed, 1, 2), epochs=1)
    return net2, tr2, post


def _zero_elastic(mx, seed, card_line):
    """(c): Estimator.fit with MXNET_ELASTIC=1 over 4 contexts, preempted
    to [gpu(0), cpu(0)], live and restored."""
    import shutil
    import tempfile
    import torch
    from mxnet_tpu_torch.gluon import zero as zero_mod
    ctxs = _zero_ctxs() + ([mx.cpu(1), mx.cpu(2)] if DEV == "cuda"
                           else [mx.cpu(2), mx.cpu(3)])
    tmp = tempfile.mkdtemp(prefix="mxt_el_")
    out = {}
    try:
        for kind in ("live", "restored"):
            net, tr, seen = _elastic_run(mx, seed, ctxs, kind, tmp)
            got = _dp_snapshot(net)
            base = seen["base"]
            on = tr._contexts
            sharded = isinstance(tr._zero, zero_mod.ZeroEngine)
            del net, tr
            _free_cuda()
            net2, tr2, post = _elastic_control(mx, seed, ctxs, kind, tmp,
                                               seen)
            want = _dp_snapshot(net2)
            same = _dp_digest(got) == _dp_digest(want) and \
                seen.get("post") == post
            apart = [k for k in sorted(want) if not torch.equal(
                _bits(got[k]), _bits(want[k]))]
            print("[zero] (c) %s: the state after the transition %s the "
                  "control's before its last step; the final parameters "
                  "apart: %d of %d (%s), relative L2 of the run's change "
                  "%.3g" % (kind, "equals" if seen.get("post") == post
                            else "DIFFERS from", len(apart), len(want),
                            apart[:4], _dp_rel(got, base, want)))
            del net2, tr2
            _free_cuda()
            print("[zero] (c) %s: bert at %d layers, full width, SGD "
                  "momentum %g, ZeRO over %s through Estimator.fit with "
                  "MXNET_ELASTIC=1, slice_preempt at step 3: transition %r "
                  "in %.3f s onto %s (ZeRO: %s); the run bit for bit with "
                  "the control resumed on the survivors: %s%s; %s"
                  % (kind, ELASTIC_LAYERS, ELASTIC_SGD["momentum"],
                     [str(c) for c in ctxs], seen.get("outcome"),
                     seen.get("seconds", float("nan")),
                     [str(c) for c in on], sharded, same,
                     "; the card's peak growth over the state move %d bytes"
                     " (the destination shard %d + one block %d + slack %d "
                     "= %d), %d blocks" % (
                         seen.get("growth", -1), seen["shard"],
                         ELASTIC_BLOCK, ELASTIC_SLACK, seen["bound"],
                         seen["blocks"]) if kind == "live" else "",
                     card_line))
            out[kind] = dict(seen, same=same)
            if seen.get("outcome") != kind:
                raise SmokeFailure("zero: (c) the transition was %r, want %r"
                                   % (seen.get("outcome"), kind))
            if on != ctxs[:2] or not sharded:
                raise SmokeFailure("zero: (c) %s: the run ended on %s (ZeRO "
                                   "%s)" % (kind, on, sharded))
            if not same:
                raise SmokeFailure("zero: (c) %s: the run is not bit for bit "
                                   "the control" % kind)
            if kind == "live":
                if DEV == "cuda" and not seen["growth"] <= seen["bound"]:
                    raise SmokeFailure(
                        "zero: (c) the card grew %d bytes over the move "
                        "(bound %d)" % (seen["growth"], seen["bound"]))
                if not seen["blocks"] > 1:
                    raise SmokeFailure("zero: (c) the move took %d block(s)"
                                       % seen["blocks"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_zero(seed, card_line):
    """25. ZeRO, the quantized wire and elastic resharding over a card
    replica and a host replica; returns the card replica's launches in
    one ZeRO step and the replicated run's noise-scale reading."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp
    t0 = time.perf_counter()
    print("[zero] %s" % card_line)
    _free_cuda()
    amp.init(target_dtype="bfloat16")
    try:
        # commwatch's records (the wire bytes) ride telemetry
        with _env_flag("MXNET_TELEMETRY", "1"):
            mx.telemetry.refresh()
            mx.telemetry.reset()
            mx.commwatch.reset()
            out, step_counts, runs = _zero_main(mx, seed, card_line)
            t_a = time.perf_counter() - t0
            _zero_quant(mx, seed, card_line, runs, out["wire"])
            del runs
            _free_cuda()
            t_b = time.perf_counter() - t0 - t_a
            _zero_elastic(mx, seed, card_line)
    finally:
        amp.reset()
        mx.telemetry.refresh()
    print("[zero] phase 25 took %.1f s: (a) %.1f, (b) %.1f, (c) %.1f; %s"
          % (time.perf_counter() - t0, t_a, t_b,
             time.perf_counter() - t0 - t_a - t_b, card_line))
    return step_counts, out["noise"]


# ---------------------------------------------------------------------------
# 26. the rest of multi-GPU over a card and the host: ring and Ulysses
# attention, MoE, the pipeline schedule, mesh-sharded serving; the noise
# scale (read from phase 25) and the quantized dist wire (phase 23's ranks)
# ---------------------------------------------------------------------------
MULTI_B, MULTI_T = 2, 1024       # (a): batch, global sequence (512 a shard)
# relative L2 from the card alone, f32 with TF32 off: the host half
# differs only in the order of its f32 sums. Each limit is twice the
# largest reading of multi_readings over seeds 0-4 on an H100 (attention
# 6.83e-7 over its 12 outputs and gradients, MoE 6.33e-7, the pipeline's
# losses 1.19e-7 and change 6.30e-6, the served outputs 7.77e-6, the
# classifier's two logits the largest); the ring without its rotation
# (the control) reads about 1
MULTI_TOL = {"attention": 1.4e-6, "moe": 1.3e-6, "pipe_loss": 2.4e-7,
             "pipe": 1.3e-5, "serve": 1.6e-5}
MOE_TOKENS = 256                 # (b): tokens a device; capacity for all
MOE_CAP = 32                     # (b): the capacity that drops tokens
PIPE_MICRO = 4                   # (c): microbatches of
PIPE_MB = (2, 128)               # (c): (batch, seq) a microbatch
PIPE_STEPS = 2
PIPE_LR = 0.1
SHARDED_SERVE = (8, 128)         # (d): one request, split 4 + 4
SHARDED_SERVE_RULES = ((r".*ffn_1_weight", ("mp", None)),
                       (r".*ffn_2_weight", ("mp", None)))
NOISE_RTOL = 1e-4                # (e): against the host's formula
# (f): the dist wire's sum against the in-process device store's over the
# same values, relative to the sum's largest magnitude (one rounding of
# the card's and the host's arithmetic apart at most)
QUANT_DIST_TOL = 1e-6
DP_QUANT_SHAPES = ((HIDDEN, UNITS), (HIDDEN,), (UNITS,))  # an FFN's ffn_1
MULTI_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "bias_gelu_fwd",
                 "bias_gelu_bwd", "bias_residual_fwd")


def _multi_dev():
    return _zero_ctxs()[0].torch_device


def _causal_attention(q, k, v):
    """Plain causal softmax attention on one device ([B, T, H, D])."""
    import math
    import torch
    t = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)


def _multi_attention(seed, ctxs, counted, card_line):
    """(a) ring attention, causal and not, and Ulysses at BERT-base's
    head shape over ``sp=2``: the output and the q, k, v gradients
    (each device differentiating its block) against the card alone."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.parallel.mesh import contexts_mesh
    mesh = contexts_mesh(ctxs, ("sp",))
    dev = _multi_dev()
    rng = np.random.RandomState(seed + 26)
    shape = (MULTI_B, MULTI_T, HEADS, HEAD_DIM)
    q, k, v, cot = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                    for _ in range(4))
    spec = par.P(None, "sp", None, None)
    worst = 0.0
    for name, fn, causal in (("ring", par.ring_attention, False),
                             ("ring causal", par.ring_attention, True),
                             ("ulysses", par.ulysses_attention, False)):
        def body(a, b, c, g, fn=fn, causal=causal):
            ts = [x.tensor().detach().requires_grad_(True) for x in (a, b, c)]
            kw = {"causal": True} if causal else {}
            with torch.enable_grad():
                o = fn(*ts, "sp", **kw)
                grads = torch.autograd.grad(o, ts, g.tensor())
            return [o.detach()] + list(grads)
        f = par.shard_map(body, mesh=mesh, in_specs=(spec,) * 4,
                          out_specs=[spec] * 4)
        t0 = time.perf_counter()
        got = counted(lambda: [x.tensor().to(dev) for x in f(q, k, v, cot)])
        _sync()
        secs = time.perf_counter() - t0
        qq, kk, vv = (x.to(dev).requires_grad_(True) for x in (q, k, v))
        with torch.enable_grad():
            ref = _causal_attention(qq, kk, vv) if causal else \
                par.local_attention(qq, kk, vv)
            grads = torch.autograd.grad(ref, [qq, kk, vv], cot.to(dev))
        rels = [_rel(a, b) for a, b in zip(got, [ref.detach()] + list(grads))]
        worst = max(worst, max(rels))
        print("[multi] (a) %s attention, B %d, T %d (%d a shard), %d x %d, "
              "sp=2 over %s, f32: relative L2 from the card alone: output "
              "%.3g, dq %.3g, dk %.3g, dv %.3g (limit %g); %.2f s; %s"
              % (name, MULTI_B, MULTI_T, MULTI_T // 2, HEADS, HEAD_DIM,
                 [str(c) for c in ctxs], rels[0], rels[1], rels[2], rels[3],
                 MULTI_TOL["attention"], secs, card_line))
        if not max(rels) <= MULTI_TOL["attention"]:
            raise SmokeFailure("multi: (a) %s attention %s from the card "
                               "alone (limit %g)"
                               % (name, rels, MULTI_TOL["attention"]))
        if name == "ring":
            want = ref.detach()
        del got, ref, grads, qq, kk, vv
    # the control: the K/V blocks never leave their device
    from mxnet_tpu_torch.parallel import ring_attention_mod as ra
    real = ra._coll._permute
    ra._coll._permute = lambda m, t, *a, **kw: t.clone()
    try:
        bad = par.shard_map(lambda a, b, c: par.ring_attention(a, b, c, "sp"),
                            mesh=mesh, in_specs=(spec,) * 3,
                            out_specs=spec)(q, k, v).tensor().to(dev)
    finally:
        ra._coll._permute = real
    rel_bad = _rel(bad, want)
    print("[multi] (a) control, the ring without its rotation: the output "
          "%.3g from the card alone (must exceed %g)"
          % (rel_bad, MULTI_TOL["attention"]))
    if not rel_bad > MULTI_TOL["attention"]:
        raise SmokeFailure("multi: (a) the control was not caught")
    return worst


def _host_routing(x, wg, ctxs, cap):
    """The tokens each device drops at capacity ``cap``, counted on the
    host from the gate logits each device computes for its block."""
    import numpy as np
    n = x.shape[0] // len(ctxs)
    drops = []
    for i, c in enumerate(ctxs):
        dv = c.torch_device
        logits = (x[i * n:(i + 1) * n].to(dv) @ wg.to(dv)).cpu().numpy()
        e = logits.argmax(-1)
        seen = {}
        for t, j in enumerate(e):
            seen[j] = seen.get(j, 0) + 1
            if seen[j] > cap:
                drops.append(i * n + t)
    return np.array(drops, np.int64)


def _multi_moe(seed, ctxs, counted, card_line):
    """(b) make_moe_layer at BERT-base's FFN width over ``ep=2``: with
    capacity for every token against the dense per-token expert on the
    card; at MOE_CAP the dropped tokens are zero rows, as many as the
    host counts, the kept ones the full-capacity rows."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.parallel.mesh import contexts_mesh
    mesh = contexts_mesh(ctxs, ("ep",))
    dev = _multi_dev()
    x = torch.from_numpy(np.random.RandomState(seed + 27).randn(
        MOE_TOKENS * len(ctxs), UNITS).astype(np.float32))
    apply_fn, params = par.make_moe_layer(mesh, UNITS, HIDDEN,
                                          capacity=MOE_TOKENS, seed=seed)
    t0 = time.perf_counter()
    got = counted(lambda: apply_fn(params, x).tensor().to(dev))
    _sync()
    secs = time.perf_counter() - t0
    w1, w2, wg = (params[k].to(dev) for k in ("w1", "w2", "wg"))
    xd = x.to(dev)
    probs = torch.softmax(xd @ wg, -1)
    e = probs.argmax(-1)
    want = torch.zeros_like(xd)
    for j in range(len(ctxs)):
        idx = (e == j).nonzero()[:, 0]
        want[idx] = (torch.relu(xd[idx] @ w1[j]) @ w2[j]) * probs[idx, j:j + 1]
    rel = _rel(got, want)
    apply32, _ = par.make_moe_layer(mesh, UNITS, HIDDEN, capacity=MOE_CAP,
                                    seed=seed)
    got32 = counted(lambda: apply32(params, x).tensor().to(dev))
    zero = (got32.abs().amax(-1) == 0).nonzero()[:, 0].cpu().numpy()
    drops = _host_routing(x, params["wg"], ctxs, MOE_CAP)
    keep = torch.ones(len(x), dtype=torch.bool, device=dev)
    keep[torch.from_numpy(drops).to(dev)] = False
    rel_kept = _rel(got32[keep], got[keep])
    print("[multi] (b) make_moe_layer d %d, d_hidden %d, ep=2 over %s, %d "
          "tokens a device, f32: capacity %d (every token) against the "
          "dense per-token expert on the card: relative L2 %.3g (limit %g), "
          "%.2f s; capacity %d: %d zero rows, the host counts %d dropped "
          "(%s), the kept rows %.3g from the full-capacity run (limit %g); "
          "%s" % (UNITS, HIDDEN, [str(c) for c in ctxs], MOE_TOKENS,
                  MOE_TOKENS, rel, MULTI_TOL["moe"], secs, MOE_CAP, len(zero),
                  len(drops), "the same tokens" if np.array_equal(
                      np.sort(zero), np.sort(drops)) else "OTHER tokens",
                  rel_kept, MULTI_TOL["moe"], card_line))
    if not rel <= MULTI_TOL["moe"]:
        raise SmokeFailure("multi: (b) the MoE layer %.3g from the dense "
                           "experts (limit %g)" % (rel, MULTI_TOL["moe"]))
    if not len(drops) or not np.array_equal(np.sort(zero), np.sort(drops)):
        raise SmokeFailure("multi: (b) capacity %d zeroed %d rows, the host "
                           "counts %d dropped" % (MOE_CAP, len(zero),
                                                  len(drops)))
    if not rel_kept <= MULTI_TOL["moe"]:
        raise SmokeFailure("multi: (b) the kept rows %.3g from the full-"
                           "capacity run (limit %g)"
                           % (rel_kept, MULTI_TOL["moe"]))
    return max(rel, rel_kept)


def _pipe_cells(mx, seed, ctx):
    """Two BERT-base encoder layers (dropout 0) on ``ctx``, drawn from
    ``seed``, and their parameters by name without the layer's prefix."""
    import torch
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTEncoderCell
    cells, arrays = [], []
    b, s = PIPE_MB
    for layer in range(2):
        mx.random.seed(seed + 40 + layer)
        prefix = "pipe%d_" % layer
        cell = BERTEncoderCell(UNITS, HIDDEN, HEADS, dropout=0.0,
                               prefix=prefix)
        cell.initialize(ctx=ctx)
        with torch.no_grad():
            cell(mx.nd.zeros((s, b, UNITS), ctx=ctx))
        _draw_affine(cell, seed + layer)
        cells.append(cell)
        arrays.append({n[len(prefix):]: p.data().asnumpy()
                       for n, p in cell.collect_params().items()})
    return cells, arrays


def _multi_pipeline(mx, seed, ctxs, counted, card_line):
    """(c) make_pipeline_step with pp=2, a BERT-base encoder layer a
    stage: the losses and the weights after PIPE_STEPS SGD steps against
    the same two layers run in sequence on the card; the card stage's
    launches."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import cached_op, parallel as par
    from mxnet_tpu_torch.gluon.parameter import substitute
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.ops import cuda_build
    from mxnet_tpu_torch.parallel.mesh import contexts_mesh
    dev = _multi_dev()
    cells, arrays = _pipe_cells(mx, seed, ctxs[0])
    tmpl = {n[len("pipe0_"):]: p
            for n, p in cells[0].collect_params().items()}
    names = sorted(tmpl)

    def stage_fn(p, x):
        ctx = mx.gpu(x.device.index) if x.is_cuda else mx.cpu(0)
        mapping = {tmpl[n]: NDArray(p[n], ctx) for n in names}
        with ctx, cached_op.eager(), substitute(mapping), \
                mx.autograd.record(train_mode=True):
            return cells[0](NDArray(x, ctx)).tensor()

    def loss_fn(out, lab):
        return ((out - lab) ** 2).mean()
    # BERTEncoderCell reads (seq, batch, units)
    b, s = PIPE_MB
    rng = np.random.RandomState(seed + 41)
    xm = torch.from_numpy(rng.randn(PIPE_MICRO, s, b, UNITS)
                          .astype(np.float32))
    lab = torch.from_numpy(rng.randn(PIPE_MICRO, s, b, UNITS)
                           .astype(np.float32))
    stacked = {n: torch.from_numpy(np.stack([a[n] for a in arrays]))
               for n in names}
    step = par.make_pipeline_step(stage_fn, contexts_mesh(ctxs, ("pp",)),
                                  PIPE_MICRO, loss_fn, lr=PIPE_LR)
    params, losses, stage_counts = stacked, [], {}
    t0 = time.perf_counter()
    for _ in range(PIPE_STEPS):
        cuda_build.reset_launch_counts()
        params, loss = counted(lambda: step(params, xm, lab))
        losses.append(float(loss))
        for kname, v in cuda_build.launch_counts().items():
            if v:
                stage_counts[kname] = stage_counts.get(kname, 0) + v
    _sync()
    secs = time.perf_counter() - t0
    # the same layers in sequence on the card
    seq = [{n: torch.from_numpy(a[n]).to(dev) for n in names} for a in arrays]
    xd, ld = xm.to(dev), lab.to(dev)
    seq_losses = []
    for _ in range(PIPE_STEPS):
        leaves = [{n: t.detach().requires_grad_(True) for n, t in p.items()}
                  for p in seq]
        with torch.enable_grad():
            ys = []
            for mb in range(PIPE_MICRO):
                h = xd[mb]
                for layer in range(2):
                    h = stage_fn(leaves[layer], h)
                ys.append(h)
            loss = loss_fn(torch.stack(ys), ld)
            flat = [lv[n] for lv in leaves for n in names]
            grads = torch.autograd.grad(loss, flat)
        seq_losses.append(float(loss.detach()))
        it = iter(grads)
        with torch.no_grad():
            seq = [{n: lv[n].detach() - PIPE_LR * next(it) for n in names}
                   for lv in leaves]
    base = {"%s:%d" % (n, i): stacked[n][i].to(dev)
            for n in names for i in range(2)}
    pipe = {"%s:%d" % (n, i): params[n][i].to(dev)
            for n in names for i in range(2)}
    ref = {"%s:%d" % (n, i): seq[i][n] for n in names for i in range(2)}
    rel = _dp_rel(pipe, base, ref)
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(losses, seq_losses))
    print("[multi] (c) make_pipeline_step pp=2 over %s, a BERTEncoderCell "
          "(%d units, %d heads, FFN %d, dropout 0) a stage, %d microbatches "
          "of batch %d x seq %d, %d SGD steps (lr %g), f32: losses %s "
          "against %s in "
          "sequence on the card (largest relative difference %.3g, limit "
          "%g); relative L2 of the change %.3g (limit %g); %.2f s; the card "
          "stage's launches %s; %s"
          % ([str(c) for c in ctxs], UNITS, HEADS, HIDDEN, PIPE_MICRO,
             b, s, PIPE_STEPS, PIPE_LR, losses, seq_losses, rel_loss,
             MULTI_TOL["pipe_loss"], rel, MULTI_TOL["pipe"], secs,
             stage_counts, card_line))
    if not rel_loss <= MULTI_TOL["pipe_loss"] or \
            not rel <= MULTI_TOL["pipe"]:
        raise SmokeFailure("multi: (c) the pipeline's losses %.3g and "
                           "update %.3g from the sequence" % (rel_loss, rel))
    if DEV == "cuda" and not stage_counts.get("layer_norm_bwd"):
        raise SmokeFailure("multi: (c) the card stage launched no LayerNorm "
                           "backward (%s)" % stage_counts)
    return stage_counts


def _multi_serving(mx, seed, ctxs, counted, card_line):
    """(d) BERT-base (no decoder) served over a mesh of the card and the
    host: the FFN weights split on ``mp``, the request split by
    ``data_spec``; against the unsharded session on the card, after a
    refresh of halved weights, and through a Scheduler pushing with the
    collective tag while engine_collective_overlap strips its lock."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import engine as engine_mod, faultinject
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.parallel import P
    from mxnet_tpu_torch.parallel.mesh import contexts_mesh
    from mxnet_tpu_torch.serve import Scheduler
    b, s = SHARDED_SERVE
    rng = np.random.RandomState(seed + 28)
    ids = rng.randint(0, VOCAB, (b, s)).astype(np.int32)
    tok = rng.randint(0, 2, (b, s)).astype(np.int32)
    mx.random.seed(seed)
    net = bert_12_768_12(dropout=0.0, use_decoder=False, prefix="mesh_bert_")
    net.initialize(ctx=ctxs[0])
    eids, etok = (mx.nd.array(a, dtype="int32", ctx=ctxs[0])
                  for a in (ids, tok))
    with torch.no_grad():
        net(eids, etok)
    _draw_affine(net, seed)
    ref = net.serve_session(eids, etok, seq_axis=1, max_batch=b, max_seq=s,
                            buckets=SERVING_BUCKETS)
    mesh = contexts_mesh(ctxs, ("mp",))
    rules = [(pat, P(*spec)) for pat, spec in SHARDED_SERVE_RULES]
    t0 = time.perf_counter()
    sess = net.serve_session(eids, etok, seq_axis=1, max_batch=b,
                             max_seq=s, buckets=SERVING_BUCKETS, mesh=mesh,
                             param_specs=rules, data_spec=P("mp"))
    build_s = time.perf_counter() - t0
    matched = sum(1 for sp in sess._specs.values() if tuple(sp))
    want = ref.infer(ids, tok)
    t0 = time.perf_counter()
    got = counted(lambda: sess.infer(ids, tok))
    secs = time.perf_counter() - t0
    rels = [_rel(torch.from_numpy(g), torch.from_numpy(w))
            for g, w in zip(got, want)]
    with torch.no_grad():
        for p in net.collect_params().values():
            p.set_data(p.data() * 0.5)
    sess.refresh_weights()
    got2 = counted(lambda: sess.infer(ids, tok))
    moved = min(_rel(torch.from_numpy(a), torch.from_numpy(c))
                for a, c in zip(got2, got))
    want2 = ref.infer(ids, tok)
    rels2 = [_rel(torch.from_numpy(g), torch.from_numpy(w))
             for g, w in zip(got2, want2)]
    print("[multi] (d) bert_12_768_12 (no decoder, dropout 0, f32) served "
          "at %s over mesh %s on 'mp': %d weights matched by param_specs "
          "(rules %s; checked, each weight held whole on each device), the "
          "request split by data_spec P('mp'); built in %.1f s, a request "
          "%.2f s; relative L2 from the unsharded session on the card: %s "
          "(limit %g); after halving every weight and refresh_weights: "
          "outputs moved by at least %.3g (must exceed 0.01), %s from the "
          "card session (limit %g); %s"
          % (SHARDED_SERVE, [str(c) for c in ctxs], matched,
             [r[0] for r in SHARDED_SERVE_RULES], build_s, secs,
             ["%.3g" % r for r in rels], MULTI_TOL["serve"], moved,
             ["%.3g" % r for r in rels2], MULTI_TOL["serve"], card_line))
    if not max(rels + rels2) <= MULTI_TOL["serve"]:
        raise SmokeFailure("multi: (d) the mesh session %s / %s from the "
                           "card session" % (rels, rels2))
    if not moved > 0.01:
        raise SmokeFailure("multi: (d) the refresh moved the outputs by "
                           "%.3g" % moved)
    # the Scheduler at in-flight 2: warm batches go to the engine with the
    # session's descriptor, whose lock the fault site strips
    eng = engine_mod.native_engine()
    before = len(eng.collective_pushes())
    faultinject.set_fault("engine_collective_overlap", 1.0)
    sched = Scheduler(sess, max_wait_ms=1, inflight=2)
    halves = [(ids[i:i + 2], tok[i:i + 2]) for i in range(0, b, 2)]
    try:
        futs = [sched.submit(i, t) for i, t in halves]
        outs = counted(lambda: [f.result(timeout=300) for f in futs])
    finally:
        sched.close()
        fires = faultinject.fires("engine_collective_overlap")
        faultinject.reset()
    pushes = [d for label, d in eng.collective_pushes()[before:]
              if label == "serve.batch"]
    tag = sess.collective_tag()
    rel_s = max(_rel(torch.from_numpy(o[j]), torch.from_numpy(w[2 * i:2 * i
                                                                 + 2]))
                for i, o in enumerate(outs) for j, w in enumerate(got2))
    print("[multi] (d) Scheduler at in-flight 2: %d requests of 2 rows, %d "
          "engine pushes with the collective descriptor (program %r), "
          "engine_collective_overlap fired %d times, the recorded locks %s "
          "(the session's is %d); rows %.3g from the direct requests "
          "(limit %g)" % (len(halves), len(pushes), tag["program"], fires,
                          sorted({d["lock"] for d in pushes}, key=str),
                          tag["lock"], rel_s, MULTI_TOL["serve"]))
    if not pushes or fires < len(pushes) or \
            any(d["lock"] is not None or d["program"] != tag["program"]
                for d in pushes):
        raise SmokeFailure("multi: (d) the collective pushes %s (fires %d)"
                           % (pushes, fires))
    if not rel_s <= MULTI_TOL["serve"]:
        raise SmokeFailure("multi: (d) the scheduled rows %.3g from the "
                           "direct ones" % rel_s)
    return max(rels + rels2 + [rel_s])


def _noise_expect(per_replica, batch):
    """B_simple's estimates and scale from the replicas' gradients read
    on the host (float64, each norm rounded to f32 as the reduction
    gives it); the scale None where either estimate is not positive."""
    import numpy as np
    nrep = len(per_replica)
    B = float(batch)
    b = B / nrep
    small_sq = sum(float(np.float32(np.linalg.norm(g))) ** 2
                   for rep in per_replica for g in rep)
    big_sq = sum(float(np.float32(np.linalg.norm(
        sum(rep[i] for rep in per_replica)))) ** 2
        for i in range(len(per_replica[0])))
    g_small = (small_sq / nrep) / (b * b)
    g_big = big_sq / (B * B)
    s = (g_small - g_big) / (1.0 / b - 1.0 / B)
    g2 = (B * g_big - b * g_small) / (B - b)
    return {"s": s, "g2": g2,
            "scale": s / g2 if s > 0 and g2 > 0 else None}


def _multi_noise(noise, card_line):
    """(e) the noise scale of phase 25's noise step (its replicated
    Trainer, a row shared by the replicas) against the formula over that
    step's replicas' gradients read on the host: the two estimates and
    the scale within NOISE_RTOL, the gauge and the suggested batch the
    scale's."""
    exp = noise["expect"]
    want = exp["scale"]
    got = noise["scale"]
    errs = {"S": abs(noise["s"] / exp["s"] - 1),
            "|G|^2": abs(noise["g2"] / exp["g2"] - 1),
            "scale": abs(got / want - 1) if got is not None and want
            else float("inf")}
    print("[multi] (e) phase 25's replicated Trainer over %s (%d replicas, "
          "batch %d, one row shared), MXNET_MODELWATCH=1, its first "
          "sampled step: noise_scale %s, suggested batch %s, gauge %s; the "
          "host's formula over the replicas' gradients: %s; S %.6g against "
          "%.6g, |G|^2 %.6g against %.6g; relative errors %s (limit %g); %s"
          % (noise["ctxs"], noise["nrep"], noise["batch"], got,
             noise["suggested"], noise["gauge"], want, noise["s"], exp["s"],
             noise["g2"], exp["g2"],
             ", ".join("%s %.3g" % kv for kv in errs.items()), NOISE_RTOL,
             card_line))
    if want is None:
        raise SmokeFailure("multi: (e) the host's formula gives no noise "
                           "scale (S %.6g, |G|^2 %.6g)" % (exp["s"],
                                                          exp["g2"]))
    if not max(errs.values()) <= NOISE_RTOL:
        raise SmokeFailure("multi: (e) the noise scale %s against %s (%s)"
                           % (got, want, errs))
    if noise["gauge"] != got or noise["suggested"] != max(1, round(got)):
        raise SmokeFailure("multi: (e) the gauge %s and suggested batch %s "
                           "against the noise scale %s"
                           % (noise["gauge"], noise["suggested"], got))


def _multi_quant(quant, card_line):
    """(f) phase 23's two ranks: int8 dist_sync against the in-process
    device store over [gpu(0), cpu(0)] on the same values, and its wire
    bytes on kv.dcn."""
    from mxnet_tpu_torch.parallel import quantize as qz
    block = qz.QuantConfig().block
    for r in sorted(quant):
        q = quant[r]
        ratio = (q["wire"]["int8"] + q["wire"]["f32"]) / \
            (4.0 * q["wire"]["int8"])
        print("[multi] (f) rank %d of 2 sharing the card over gloo, "
              "MXNET_KVSTORE_QUANTIZE=int8 dist_sync on %s: against the "
              "in-process device store over %s on every rank's values: %s, "
              "largest difference %.3g of the sum's magnitude %.4g (limit "
              "%g); the exact sum %.3g away (int8's grid); wire on kv.dcn: "
              "%d int8 + %d f32 bytes, %.4f of an f32 wire (%.4f expected); "
              "%s" % (r, q["shapes"], q["ctxs"],
                      "bit for bit" if q["bitwise"] else "not bit for bit",
                      q["max_abs"] / q["scale"], q["scale"], QUANT_DIST_TOL,
                      q["exact"], q["wire"]["int8"], q["wire"]["f32"], ratio,
                      0.25 + 1.0 / block, card_line))
        if not q["max_abs"] <= QUANT_DIST_TOL * q["scale"]:
            raise SmokeFailure("multi: (f) rank %d's dist wire %.3g from "
                               "the device store's" % (r, q["max_abs"]))
        if not abs(ratio - (0.25 + 1.0 / block)) < 1e-6:
            raise SmokeFailure("multi: (f) rank %d's wire is %.4f of f32"
                               % (r, ratio))


def multi_readings(seeds, card_line):
    """(a)-(d)'s readings at each seed with the limits lifted but
    attention's, which (a)'s planted control must exceed: the readings
    behind MULTI_TOL."""
    global MULTI_TOL
    keep = MULTI_TOL
    MULTI_TOL = {k: v if k == "attention" else float("inf")
                 for k, v in keep.items()}
    try:
        for seed in seeds:
            phase_multi(seed, card_line, None, None)
    finally:
        MULTI_TOL = keep


def noise_readings(seeds, card_line):
    """(e)'s reading at each seed: phase 25 (a)'s replicated run alone
    (its AMP, its telemetry), then its noise step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp
    amp.init(target_dtype="bfloat16")
    try:
        with _env_flag("MXNET_TELEMETRY", "1"):
            mx.telemetry.refresh()
            for seed in seeds:
                mx.telemetry.reset()
                net, tr, ctxs = _zero_trainer(mx, seed, False)
                with _env_flag("MXNET_ZERO", "0"):
                    for s in range(1 + ZERO_STEPS):
                        _zero_step(mx, net, tr, seed, s, ctxs)
                try:
                    _multi_noise(_noise_step(mx, net, tr, seed, ctxs),
                                 card_line)
                except SmokeFailure as e:
                    print("[multi] (e) seed %d: %s" % (seed, e))
                del net, tr
                _free_cuda()
    finally:
        amp.reset()
        mx.telemetry.refresh()


def phase_multi(seed, card_line, noise, quant):
    """26. The rest of multi-GPU over ``[gpu(0), cpu(0)]``: ring and
    Ulysses attention, MoE, the pipeline, mesh-sharded serving; then the
    noise scale of phase 25 and the quantized dist wire of phase 23.
    Returns the card's kernel launches in (a)-(d)'s mesh runs."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    print("[multi] %s" % card_line)
    _free_cuda()
    ctxs = _zero_ctxs()
    counts = {}

    def counted(fn):
        # the mesh run only: the card-alone references are not counted
        cuda_build.reset_launch_counts()
        out = fn()
        for k, v in cuda_build.launch_counts().items():
            if v:
                counts[k] = counts.get(k, 0) + v
        return out
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    times = {}
    try:
        for part, fn in (("a", lambda: _multi_attention(seed, ctxs, counted,
                                                        card_line)),
                         ("b", lambda: _multi_moe(seed, ctxs, counted,
                                                  card_line)),
                         ("c", lambda: _multi_pipeline(mx, seed, ctxs,
                                                       counted, card_line)),
                         ("d", lambda: _multi_serving(mx, seed, ctxs,
                                                      counted, card_line))):
            t1 = time.perf_counter()
            fn()
            _free_cuda()
            times[part] = time.perf_counter() - t1
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    if noise is not None:
        _multi_noise(noise, card_line)
    if quant is not None:
        _multi_quant(quant, card_line)
    missing = [k for k in MULTI_KERNELS if not counts.get(k)]
    print("[multi] the card's launches in (a)-(d)'s mesh runs: %s" % counts)
    if missing and DEV == "cuda":
        raise SmokeFailure("multi: the mesh runs launched no %s" % missing)
    print("[multi] phase 26 took %.1f s: %s; %s"
          % (time.perf_counter() - t0, ", ".join(
              "(%s) %.1f" % kv for kv in sorted(times.items())), card_line))
    return counts


# phase 27: the autotuner and perfwatch. BERT-base's served rows (8 x 128)
# and trained rows (32 x 128) at 768 units and 12 heads, ResNet-50's
# stage-1 and stage-4 call shapes for the dual backward, the chunked head
# at 32 x 128 positions over the 30522-word vocab
AUTOTUNE_REPS = 5
AUTOTUNE_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "selfatt_fwd",
                    "selfatt_bwd", "bias_gelu_fwd", "bias_gelu_bwd",
                    "bias_residual_fwd", "dropout", "dual_bwd")
AUTOTUNE_DUAL = ((STAGE_BATCH * 56 * 56, 64, 256), (STAGE_BATCH * 7 * 7,
                                                    512, 2048))
# the kernels' rows whose partial sums a tuned plan adds in another
# order, in f32: within 1e-5 of the largest sum (tests/test_torch_cuda.py)
AUTOTUNE_SUM_TOL = 1e-5


def _tuned_rows(seed, g):
    """(name, row of the PERF.md table, default plan, tuned plan, an
    alternative plan, run(plan) -> outputs, plain() -> outputs, how each
    output is held) of every tunable launch, each consulted once through
    its wrapper in measure mode (the tuning's own launches uncounted)."""
    import torch
    from mxnet_tpu_torch.ops import (contrib_ops, cuda_attention,
                                     cuda_build, cuda_dropout,
                                     cuda_epilogue, cuda_fused, cuda_norm)
    dev = torch.device(DEV)
    sms = cuda_build.sm_count(dev)
    bf = torch.bfloat16

    def randn(shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=g, device=DEV) * scale).to(dtype)
    rows = []
    M, Ms, C, H = TRAIN_BATCH * TRAIN_SEQ, 8 * TRAIN_SEQ, UNITS, HIDDEN
    eps = 1e-12
    # 1: the LayerNorm forward, served and trained rows
    for m in (Ms, M):
        x, gam, bet = randn((m, C), scale=3.0) + 1, randn((C,)), randn((C,))
        cuda_norm.layer_norm_cuda(x, gam, bet, eps)       # consults
        d = cuda_norm.fwd_blocks(m, C, bf, True, sms)
        rows.append(("layer_norm_fwd (%d, %d)" % (m, C), 1, d,
                     cuda_norm.fwd_plan(m, C, bf, True, sms, dev), sms,
                     lambda b, x=x, gam=gam, bet=bet: (
                         cuda_norm.layer_norm_cuda(x, gam, bet, eps, b),),
                     lambda x=x, gam=gam, bet=bet: (
                         cuda_norm.layer_norm_plain(x, gam, bet, eps),),
                     ("equal",)))
    # 2: the LayerNorm backward, trained rows
    # gamma in f32, as under AMP: dgamma and dbeta leave in f32
    x, dy = randn((M, C), scale=3.0) + 1, randn((M, C))
    gam = randn((C,), torch.float32)
    cuda_norm.layer_norm_bwd_cuda(dy, x, gam, eps)
    rows.append(("layer_norm_bwd (%d, %d)" % (M, C), 2,
                 cuda_norm.bwd_blocks(M, sms),
                 cuda_norm.bwd_plan(M, C, bf, sms, dev), sms,
                 lambda b: cuda_norm.layer_norm_bwd_cuda(dy, x, gam, eps, b),
                 lambda: cuda_norm.layer_norm_bwd_plain(dy, x, gam, eps),
                 ("equal", "sum", "sum")))
    # 3-4: attention at the trained shape, dropout 0.1, through the op:
    # bbh names the mask's seed blocks only, so nothing consults the
    # tuner and the op's plan stays selfatt_plan's
    L, N, p = TRAIN_SEQ, TRAIN_BATCH, 0.1
    qkv = randn((L, N, HEADS * 3 * HEAD_DIM), scale=2.0)
    dout = randn((L, N, HEADS * HEAD_DIM))
    contrib_ops.sdp_selfatt(qkv, heads=HEADS, dropout=p, _train=True)
    bbh = cuda_attention.selfatt_plan(L, HEADS, N)["bbh"]

    def seeds_of(b):
        n = cuda_attention.selfatt_plan(L, HEADS, N, b)["n_blocks"]
        return torch.arange(n, dtype=torch.int32, device=DEV) * 7919 + seed

    def att(b, fn, *more):
        return (fn(qkv, *more, HEADS, p, seeds_of(b), b),)
    for name, row, fwd, plain in (
            ("selfatt_fwd", 3, cuda_attention.selfatt_cuda,
             cuda_attention.selfatt_plain),
            ("selfatt_bwd", 4, cuda_attention.selfatt_bwd_cuda,
             cuda_attention.selfatt_bwd_plain)):
        more = () if row == 3 else (dout,)
        # at p > 0 the plan names the mask: the plain version at the
        # tuned run's own head block
        rows.append(("%s (L %d, N %d, p %g)" % (name, L, N, p), row,
                     cuda_attention.selfatt_plan(L, HEADS, N)["bbh"], bbh, 4,
                     lambda b, fwd=fwd, more=more: att(b, fwd, *more),
                     lambda b, plain=plain, more=more: att(b, plain, *more),
                     ("share",)))
    # 5, 7: the epilogue forwards; 6: the bias+GeLU backward
    xg, bg, dyg = randn((M, H)), randn((H,)), randn((M, H))
    xr, br, rr = randn((M, C)), randn((C,)), randn((M, C))
    cuda_epilogue.bias_gelu_cuda(xg, bg)
    cuda_epilogue.bias_gelu_bwd_cuda(dyg, xg, bg)
    cuda_epilogue.bias_residual_cuda(xr, br, rr)
    for name, row, m, c, run, plain in (
            ("bias_gelu_fwd", 5, M, H,
             lambda s: (cuda_epilogue.bias_gelu_cuda(xg, bg, s),),
             lambda: (cuda_epilogue.bias_gelu_plain(xg, bg),)),
            ("bias_residual_fwd", 7, M, C,
             lambda s: (cuda_epilogue.bias_residual_cuda(xr, br, rr, s),),
             lambda: (cuda_epilogue.bias_residual_plain(xr, br, rr),))):
        d = cuda_epilogue.fwd_strips(m, c, bf, True, sms)
        rows.append(("%s (%d, %d)" % (name, m, c), row, d,
                     cuda_epilogue.fwd_plan(name, m, c, bf, True, sms, dev),
                     max(1, d // 2), run, plain, ("equal",)))
    rows.append(("bias_gelu_bwd (%d, %d)" % (M, H), 6,
                 cuda_epilogue.bwd_scratch_shape(M, H, bf, True, sms)[0],
                 cuda_epilogue.bwd_plan(M, H, bf, True, sms, dev), 3 * sms,
                 lambda s: cuda_epilogue.bias_gelu_bwd_cuda(dyg, xg, bg, s),
                 lambda: cuda_epilogue.bias_gelu_bwd_plain(dyg, xg, bg),
                 ("equal", "close")))
    # 8: dropout at the trained rows
    xd = randn((M, C))
    sd = torch.tensor([seed], dtype=torch.int32, device=DEV)
    cuda_dropout.dropout_cuda(xd, 0.1, sd)
    per_sm = cuda_dropout._per_sm(dev, cuda_build.DTYPE_CODES[bf], True)
    base = cuda_dropout.launch_plan(xd.numel(), 2, True, sms, per_sm)
    tuned = cuda_dropout.tuned_launch_plan(xd.numel(), 2, True, sms, per_sm,
                                           dev)
    rows.append(("dropout (%d, %d) p 0.1" % (M, C), 8,
                 {"units": base.units, "blocks": base.blocks},
                 {"units": tuned.units, "blocks": tuned.blocks},
                 {"units": 4, "blocks": sms * per_sm[4]},
                 lambda q: (cuda_dropout.dropout_cuda(xd, 0.1, sd, q),),
                 lambda: (cuda_dropout.dropout_plain(xd, 0.1, sd),),
                 ("equal",)))
    # 9: the dual backward at ResNet-50's stage shapes
    for m, i, o in AUTOTUNE_DUAL:
        jg, y, xx = randn((m, o)), randn((m, o)), randn((m, i))
        w = randn((i, o), scale=i ** -0.5)
        coef = torch.zeros(8, o, device=DEV)
        coef[:5] = torch.randn(5, o, generator=g, device=DEV) * 0.1 + 1
        args = (jg, y, xx, w, coef, "scale_shift")
        cuda_fused.dual_bwd_cuda(*args)
        dp = cuda_fused.dual_plan(m, i, o, sms)
        tp = cuda_fused.tuned_dual_plan(m, i, o, sms, device=dev)
        rows.append(("dual_bwd (%d, %d, %d)" % (m, i, o), 9,
                     {"splits_w": dp["splits_w"], "splits_x": dp["splits_x"]},
                     {"splits_w": tp["splits_w"], "splits_x": tp["splits_x"]},
                     {"splits_w": 2 * dp["splits_w"],
                      "splits_x": dp["splits_x"]},
                     lambda q, args=args: cuda_fused.dual_bwd_cuda(
                         *args, plan=q)[:2],
                     lambda args=args: cuda_fused.dual_bwd_plain(*args)[:2],
                     ("close", "sum")))
    # the CE chunk: bf16 hidden states over f32 weights, as under AMP
    hc = randn((M, C))
    wc = torch.randn((VOCAB, C), generator=g, device=DEV) * 0.02
    bc = torch.zeros(VOCAB, device=DEV)
    lab = torch.randint(0, VOCAB, (M,), generator=g, device=DEV)
    with torch.no_grad():
        contrib_ops.chunked_lm_head_ce(hc, wc, bc, lab)
    d = contrib_ops.ce_chunk_size(0, VOCAB)
    dtypes = (hc.dtype, wc.dtype, bc.dtype)

    def ce(c):
        with torch.no_grad():
            return (contrib_ops._ChunkedCE.apply(hc, wc, bc, lab, c),)
    # no kernel: the chunks against the configured chunk's loss
    rows.append(("chunked_lm_head_ce (%d, %d, %d)" % (M, C, VOCAB), 0, d,
                 contrib_ops.ce_chunk_size(0, VOCAB, M, C, 2, dev, dtypes),
                 1024,
                 ce, lambda: ce(d), ("ce",)))
    return rows


def _hold_tuned(what, got, ref, how):
    """Hold a tuned launch's outputs: bit for bit, within the bf16 kernel
    tolerance, a summed f32 row within AUTOTUNE_SUM_TOL of its largest
    sum, or the attention's bit-equal share."""
    for i, (a, r, h) in enumerate(zip(got, ref, how)):
        tag = "%s [%d]" % (what, i)
        if h == "equal":
            if not bool((a == r).all()):
                raise SmokeFailure("%s: not bit for bit" % tag)
        elif h == "sum":
            top = float(r.float().abs().max())
            _check_close(tag, a, r, AUTOTUNE_SUM_TOL * max(top, 1.0),
                         AUTOTUNE_SUM_TOL)
        elif h == "share":
            _check_close(tag, a, r, KERNEL_ATOL, KERNEL_RTOL,
                         min_equal=KERNEL_EQUAL)
        elif h == "ce":
            _check_close(tag, a, r, HEAD_LOSS_TOL, HEAD_LOSS_TOL)
        else:
            _check_close(tag, a, r, KERNEL_ATOL, KERNEL_RTOL)


def _consult_cost(autotune, card_line, calls=500):
    """Host time a LayerNorm launch at BERT-base's served rows spends on
    its plan: ``blocks`` given (0, the launcher's grid), left to the
    wrapper with the tuner off (the cached gate), and left to it in
    ``measure`` mode (a table hit). The best of 3 runs of ``calls``
    launches on the host's clock, synchronized between runs."""
    import torch
    from mxnet_tpu_torch.ops import cuda_norm
    g = torch.Generator(device=DEV).manual_seed(0)
    x = torch.randn((8 * TRAIN_SEQ, UNITS), generator=g,
                    device=DEV).to(torch.bfloat16)
    gam = torch.ones(UNITS, dtype=torch.bfloat16, device=DEV)
    bet = torch.zeros(UNITS, dtype=torch.bfloat16, device=DEV)

    def per_call(blocks):
        cuda_norm.layer_norm_cuda(x, gam, bet, 1e-12, blocks)
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(calls):
                cuda_norm.layer_norm_cuda(x, gam, bet, 1e-12, blocks)
            runs.append((time.perf_counter() - t) / calls * 1e6)
        torch.cuda.synchronize()
        return min(runs)
    given = per_call(0)
    on = per_call(None)
    os.environ["MXNET_AUTOTUNE"] = "off"
    autotune.refresh()
    try:
        off = per_call(None)
    finally:
        os.environ["MXNET_AUTOTUNE"] = "measure"
        autotune.refresh()
    print("[autotune] host us a layer_norm_fwd launch (%d, %d): blocks "
          "given %.2f, tuner off %.2f, measure mode from the table %.2f "
          "(best of 3 x %d calls; %s)" % (8 * TRAIN_SEQ, UNITS, given, off,
                                         on, calls, card_line))


def phase_autotune(seed, card_line):
    """Phase 27: the launch-plan tuner in ``measure`` mode and the
    perfwatch store, each in a temporary directory. Returns the kernels'
    launches in the tuned run (counts reset just before, read after)."""
    import io
    import logging
    import re
    import tempfile
    import torch
    from mxnet_tpu_torch import autotune, perfwatch
    from mxnet_tpu_torch.ops import cuda_build
    from mxnet_tpu_torch.tools import bench_json
    from mxnet_tpu_torch.tools import perfwatch as perfwatch_cli
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mxt_autotune_")
    cache = os.path.join(tmp, "tune.json")
    saved = {k: os.environ.get(k) for k in (
        "MXNET_AUTOTUNE", "MXNET_AUTOTUNE_CACHE", "MXNET_PERF_DB",
        "MXNET_PERFWATCH")}
    os.environ.update({"MXNET_AUTOTUNE": "measure",
                       "MXNET_AUTOTUNE_CACHE": cache,
                       "MXNET_PERF_DB": os.path.join(tmp, "db"),
                       "MXNET_PERFWATCH": "1"})
    perfwatch.refresh()
    autotune.clear()
    try:
        g = torch.Generator(device=DEV).manual_seed(seed + 27)
        rows = _tuned_rows(seed, g)
        torch.cuda.synchronize()
        table = autotune.table()
        print("[autotune] measure mode: %d table entries in %s (%.1f s)"
              % (len(table), cache, time.perf_counter() - t0))
        if any("|selfatt" in k for k in table):
            raise SmokeFailure("the attention op consulted the tuner: %s"
                               % [k for k in table if "|selfatt" in k])
        print("[autotune] rows 3-4: the head block names the mask's seed "
              "blocks only; not tuned, the op keeps selfatt_plan's")
        # each row: the default, the tuned plan and an alternative, each
        # held against the default's outputs and the plain version
        kernels, counts, ratios = {}, {}, []
        cuda_build.reset_launch_counts()
        for what, row, dflt, tuned, alt, run, plain, how in rows:
            ref_plain = plain(tuned) if row in (3, 4) else plain()
            base = run(dflt)
            for tag, plan in (("tuned", tuned), ("alternative", alt)):
                got = run(plan)
                if row in (3, 4) and plan != dflt:
                    # another head block draws another mask
                    _hold_tuned("%s %s vs plain" % (what, tag), got,
                                plain(plan), how)
                    continue
                _hold_tuned("%s %s vs default" % (what, tag), got, base,
                            tuple("close" if h == "share" else h
                                  for h in how))
                if tag == "tuned":
                    _hold_tuned("%s %s vs plain" % (what, tag), got,
                                ref_plain, tuple("close" if h == "equal"
                                                 else h for h in how))
        counts = {k: v for k, v in cuda_build.launch_counts().items() if v}
        for what, row, dflt, tuned, alt, run, plain, how in rows:
            d_ms = t_ms = _gpu_ms(lambda: run(dflt), AUTOTUNE_REPS)
            if tuned != dflt:
                t_ms = _gpu_ms(lambda: run(tuned), AUTOTUNE_REPS)
            ratios.append(t_ms / d_ms)
            kernels["_".join(re.findall(r"[a-z0-9_.]+", what))] = {
                "row": row, "default": dflt, "tuned": tuned,
                "default_ms": d_ms, "candidate_ms": t_ms}
            print("[autotune] row %s %-40s default %-34s %.4f ms; tuned "
                  "%-34s %.4f ms (%s)" % (row or "CE", what, dflt, d_ms,
                                           tuned, t_ms, card_line))
        _consult_cost(autotune, card_line)
        # a new process's lookup answers from the file without tuning
        autotune.clear()
        tunes = []
        real_tune = autotune._tune
        autotune._tune = lambda *a, **k: tunes.append(a) or real_tune(*a,
                                                                       **k)
        try:
            again = _tuned_rows(seed, torch.Generator(
                device=DEV).manual_seed(seed + 27))
        finally:
            autotune._tune = real_tune
        if tunes or [r[3] for r in again] != [r[3] for r in rows]:
            raise SmokeFailure("the reloaded table tuned %d signature(s) "
                               "or answered other plans" % len(tunes))
        print("[autotune] reload: %d plans from the file, none tuned again"
              % len(again))
        # a bogus entry: warned about, and the default runs
        from mxnet_tpu_torch.ops import cuda_norm
        with open(cache) as f:
            data = json.load(f)
        key = next(k for k in data if "|layer_norm_fwd|" in k
                   and "M=%d," % (TRAIN_BATCH * TRAIN_SEQ) in k)
        data[key] = {"params": {"blocks": -5}, "mode": "measure",
                     "score": 0.0}
        with open(cache, "w") as f:
            json.dump(data, f)
        autotune.clear()
        caught = []
        handler = logging.Handler()
        handler.emit = lambda r: caught.append(r.getMessage())
        logging.getLogger("mxnet_tpu_torch.autotune").addHandler(handler)
        try:
            what, row, dflt, tuned, alt, run, plain, how = next(
                r for r in again if r[0].startswith("layer_norm_fwd (%d"
                                                    % (TRAIN_BATCH
                                                       * TRAIN_SEQ)))
            m = TRAIN_BATCH * TRAIN_SEQ
            bogus = cuda_norm.fwd_plan(m, UNITS, torch.bfloat16, True,
                                       cuda_build.sm_count(
                                           torch.device(DEV)),
                                       torch.device(DEV))
            # the wrapper's own consult reads the same entry
            same = torch.equal(run(None)[0], run(dflt)[0])
        finally:
            logging.getLogger("mxnet_tpu_torch.autotune").removeHandler(
                handler)
        if bogus != dflt or not same or not any("failed validation" in c
                                                for c in caught):
            raise SmokeFailure("a bogus table entry gave plan %r (default "
                               "%r), warnings %r" % (bogus, dflt, caught))
        print("[autotune] bogus entry %s: warned, the default plan %s runs"
              % (key, dflt))
        # the timings as one bench-JSON record, into the store
        record = {"metric": "autotune_paired_median_ratio",
                  "value": statistics.median(ratios),
                  "unit": "tuned/default", "kernels": kernels,
                  "autotune": "measure",
                  "autotune_table": {k: v["params"]
                                     for k, v in table.items()},
                  "card": card_line}
        bench_json.emit(record, source="chip_smoke", stream=io.StringIO())
        card = torch.cuda.get_device_name(0)
        if record["env"]["device_kind"] != card:
            raise SmokeFailure("the record's device kind %r is not the "
                               "card's %r" % (record["env"]["device_kind"],
                                              card))
        db = perfwatch.open_db()
        scan = perfwatch.scan(db)
        if not scan or not db.records(db.device_kinds()[0],
                                      record["metric"]):
            raise SmokeFailure("the store holds no record of the run")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            perfwatch_cli._render([r for r in scan
                                   if r["metric"] == record["metric"]],
                                  db.root)
        for ln in out.getvalue().splitlines():
            print("[autotune] perf: %s" % ln)
        print("[autotune] phase 27 took %.1f s; tuned run launches %s"
              % (time.perf_counter() - t0, counts))
        return counts
    finally:
        autotune.clear()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        perfwatch.refresh()
        autotune.refresh()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10,
                    help="calls per timing trial")
    ap.add_argument("--train-steps", type=int, default=10,
                    help="LAMB steps on one fixed batch")
    ap.add_argument("--resnet-steps", type=int, default=10,
                    help="ResNet-50 SGD steps on one fixed batch")
    ap.add_argument("--mnist-epochs", type=int, default=3,
                    help="epochs of the MNIST MLP with the rtc custom op")
    ap.add_argument("--ptb-steps", type=int, default=PTB_STEPS,
                    help="clipped SGD steps of the PTB LSTM model")
    args = ap.parse_args(argv)
    import torch
    try:
        import mxnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print("FAIL: the port is not importable (run from the root of a "
              "checkout): %s" % e, file=sys.stderr)
        return 1
    try:
        card_line = phase_device()
        card = torch.cuda.get_device_name(0)
        t_start = time.perf_counter()

        def stamp(what):
            # the script runs under a time limit: where it goes, by phase
            print("[time] %s done at %.1f s" % (what,
                                                time.perf_counter() - t_start))
        phase_build()
        stamp("build")
        errs = phase_parity(args.seed)
        errs.update(phase_parity_train(args.seed))
        phase_parity_attention(args.seed)
        stamp("phase parity")
        errs["dual_bwd"] = phase_parity_resnet(args.seed)
        from mxnet_tpu_torch import cached_op
        from mxnet_tpu_torch.ops import cuda_build
        # phases 4 and 10 serve through the eager session; phase 11 is
        # its compiled twin
        with cached_op.eager():
            counts, n_fwd, sess, reqs, net = phase_slice(args.seed)
            stamp("phase 4 (slice)")
        train_counts, tnet, mlm, params, batch = phase_train(
            args.seed, args.train_steps)
        amp_errs = phase_parity_amp(args.seed)
        amp_counts = phase_amp(args.seed)
        phase_amp_fp16(args.seed)
        stamp("phase 5 (amp)")
        stage_counts, stages = phase_stages(args.seed)
        resnet_counts, resnet_step = phase_resnet(args.seed,
                                                  args.resnet_steps)
        stamp("phase 6-7 (stages, resnet)")
        rtc_mod, rtc_mod2, rtc_errs, rtc_counts = phase_rtc(args.seed)
        mnist_counts, mnist_step_counts, mnist_nets, mnist_loss, \
            mnist_batch = phase_mnist(args.seed, rtc_mod, args.mnist_epochs)
        stamp("phase 8-9 (rtc, mnist)")
        with cached_op.eager():
            rows = phase_times(args.seed, args.reps, counts, n_fwd, errs,
                               sess, reqs, net, card)
        train_rows, step = phase_times_train(
            args.seed, args.reps, train_counts, errs, card, tnet, mlm,
            params, batch)
        rows += train_rows
        rows.append(phase_times_resnet(args.seed, args.reps, stage_counts,
                                       errs["dual_bwd"], card, stages,
                                       resnet_step))
        rows += phase_times_rtc(args.seed, args.reps, card, rtc_errs,
                                rtc_counts, mnist_counts, mnist_nets,
                                mnist_loss, mnist_batch, rtc_mod, rtc_mod2)
        for r in rows:
            k = r.get("kernel", r["name"])
            r["launches_per_train_step"] = train_counts.get(k, 0)
            r["launches_per_amp_step"] = amp_counts.get(k, 0)
            amp_err = {n[len(k) + 5:]: e for n, e in amp_errs.items()
                       if n.startswith(k + "_amp ")}
            if amp_err:
                r["max_abs_err_amp"] = amp_err
            r["launches_per_fused_step"] = stage_counts.get(k, 0)
            r["launches_per_resnet_step"] = resnet_counts.get(k, 0)
            r["launches_per_mlp_step"] = mnist_step_counts.get(k, 0)
        with cached_op.eager():
            phase_profile(net)
        _attention_share(_profile("one training step (batch %d x seq %d, "
                                  "LAMB)" % (TRAIN_BATCH, TRAIN_SEQ), step))
        stamp("phase 10 (times, profile)")
        compiled = phase_compiled_serve(sess, reqs, net)
        compiled.update(phase_compiled_bert(args.seed))
        compiled.update(phase_compiled_resnet(args.seed))
        ptb_counts, ptb_row = phase_ptb(args.seed, args.ptb_steps, card,
                                        args.reps)
        compiled.update(phase_compiled_ptb(args.seed))
        stamp("phase 11-12 (compiled, ptb)")
        rows.append(ptb_row)
        cuda_build.reset_launch_counts()
        phase_resume(args.seed, card_line)
        resume_counts = cuda_build.launch_counts()
        missing = [k for k in RESUME_KERNELS if not resume_counts.get(k)]
        print("[resume] kernel launches in phase 13: %s" % {
            k: v for k, v in resume_counts.items() if v})
        if missing:
            raise SmokeFailure("phase 13 launched no %s" % missing)
        stamp("phase 13 (resume)")
        scan_capture, scan_counts = phase_scan(args.seed, card_line)
        compiled.update(scan_capture)
        print("[scan] kernel launches through the wrappers in phase 14's "
              "K=%d parity run: %s" % (SCAN_K, {
                  k: v for k, v in scan_counts.items() if v}))
        missing = [k for k in SCAN_KERNELS if not scan_capture["scan"].get(k)]
        if missing:
            raise SmokeFailure("phase 14 captured no %s" % missing)
        stamp("phase 14 (scan)")
        vision_counts, vision_capture, family_counts, vision_row = \
            phase_vision(args.seed, args.reps, card, card_line)
        compiled.update(vision_capture)
        rows.append(vision_row)
        stamp("phase 15 (vision)")
        fed_counts = phase_imagenet(args.seed, card_line)
        stamp("phase 16 (imagenet)")
        random_counts = phase_random(args.seed, card_line)
        stamp("phase 17 (random)")
        cuda_build.reset_launch_counts()
        # its timings take 5 calls (its own default) where the kernels'
        # take --reps: the tail's slow calls (box_nms, CTC) would spend
        # ~40 s of the script's time limit on 20
        phase_ops_tail(args.seed, card_line)
        tail_counts = cuda_build.launch_counts()
        print("[ops_tail] kernel launches in phase 18: %s (no port kernel "
              "is on its path)" % {k: v for k, v in tail_counts.items()
                                    if v})
        layout_counts = phase_layout(args.seed, card_line)
        stamp("phase 19 (layout)")
        engine_counts = phase_engine(args.seed, rtc_mod, sess, reqs,
                                     card_line)
        services_counts, _ = phase_services(args.seed, card_line)
        stamp("phase 21 (services)")
        serving_counts, replica_counts, serving_replayed = phase_serving(
            args.seed, card_line)
        dp_counts, dp_quant = phase_dp(args.seed, card_line)
        stamp("phase 23 (dp)")
        sharded_counts, sharded_step = phase_sharded(args.seed, card_line)
        stamp("phase 24 (sharded)")
        zero_step, noise = phase_zero(args.seed, card_line)
        stamp("phase 25 (zero)")
        multi_counts = phase_multi(args.seed, card_line, noise, dp_quant)
        stamp("phase 26 (multi)")
        autotune_counts = phase_autotune(args.seed, card_line)
        missing = [k for k in AUTOTUNE_KERNELS if not autotune_counts.get(k)]
        if missing:
            raise SmokeFailure("phase 27 launched no %s" % missing)
        stamp("phase 27 (autotune)")
        for r in rows:
            k = r.get("kernel", r["name"])
            r["launches_per_layout_run"] = layout_counts.get(k, 0)
            r["launches_per_engine_run"] = engine_counts.get(k, 0)
            r["launches_per_services_run"] = services_counts.get(k, 0)
            r["launches_per_serving_run"] = serving_counts.get(k, 0)
            r["launches_per_dp_run"] = dp_counts.get(k, 0)
            r["launches_per_sharded_run"] = sharded_counts.get(k, 0)
            r["launches_per_sharded_step"] = sharded_step.get(k, 0)
            r["launches_per_zero_step"] = zero_step.get(k, 0)
            r["launches_per_multi_run"] = multi_counts.get(k, 0)
            r["launches_per_autotune_run"] = autotune_counts.get(k, 0)
            r["replayed_per_serving_run"] = serving_replayed.get(k, 0)
            r["replayed_per_replica"] = {
                rid: c.get(k, 0) for rid, c in sorted(replica_counts.items())}
        for r in rows:
            r["launches_per_fed_run"] = fed_counts.get(
                r.get("kernel", r["name"]), 0)
            r["launches_per_random_block"] = random_counts.get(
                r.get("kernel", r["name"]), 0)
            r["launches_per_ops_tail"] = tail_counts.get(
                r.get("kernel", r["name"]), 0)
        for r in rows:
            k = r.get("kernel", r["name"])
            r["launches_per_vision_step"] = vision_counts.get(k, 0)
            r["launches_per_family_step"] = {
                name: n if k == "dropout" else 0
                for name, n in family_counts.items()}
            r["launches_per_scan_run"] = scan_counts.get(
                r.get("kernel", r["name"]), 0)
            r["launches_per_ptb_step"] = ptb_counts.get(
                r.get("kernel", r["name"]), 0)
            r["launches_per_resume"] = resume_counts.get(
                r.get("kernel", r["name"]), 0)
            r["launches_per_compiled_capture"] = {
                path: c.get(r.get("kernel", r["name"]), 0)
                for path, c in compiled.items()}
        torch.cuda.synchronize()
    except SmokeFailure as e:
        print("FAIL: %s" % e, file=sys.stderr)
        return 1
    print(card_line)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
