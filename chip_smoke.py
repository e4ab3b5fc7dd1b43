#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (caffe_mpi_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of the repository
    python3 chip_smoke.py --parent DIR   # also time the parent's K1-K5

Phases, in order; any failure exits nonzero and prints no result line:

1. device  — requires torch.cuda.is_available(); prints the card's name and
             power limit as nvidia-smi reports them.
2. build   — builds every CUDA kernel of the port from csrc/ with nvcc for
             sm_90a, and the native data-plane library (csrc/native/:
             the LMDB sidecar's crc32c among it) with the host C++
             compiler (one compiler per library, all started together).
3. kernels — holds each kernel against its plain PyTorch version on the card
             at the shapes the serving and training paths give it (and at
             edge shapes: the LRN kernels at windows 1 to 17, both sides
             of the templated windows' edge, and at 70,000 images, and at
             GoogLeNet's pool1/norm1 and conv2/norm2 at batch 128; the
             flash kernels at 70,000 batch x heads, and at head dims 160
             and 256, past the tensor-core kernels' 128, where the wrappers
             launch the wide kernels), in float32 and bfloat16, and times
             the kernel,
             the plain version and the library call that computes the same
             function: K1, the LRN forward, against F.local_response_norm;
             K2, the LRN backward, against torch.autograd.grad through
             F.local_response_norm; K3, the flash-attention forward, and
             K4 and K5, its dQ and dK/dV kernels (on the tensor cores),
             against F.scaled_dot_product_attention and torch.autograd.grad
             through it (one call for dQ, dK and dV) on 4-D views, each
             fused backend pinned alone, the fastest named, the math path
             beside it — at transformer_lm's shape (BH 32, S 64, D 32),
             non-causal, bf16, the deploy net's BH 40, S 100 with D 20,
             S = 200 padded to 256, a bias masking a whole tile, and S
             1024/2048 at D 32, 64 and 128. With `--parent DIR` (a
             checkout of the parent commit) the parent's K1-K5 are built
             and timed in turns with this tree's. Then autograd
             through flash_attention on the card against the CPU.
4. serve   — serves AlexNet (models/alexnet/deploy.prototxt, full width,
             weights drawn from a seeded torch.Generator) through the
             port's ServingEngine: mixed bursts from several threads with
             every kernel launch count set to 0 just before and read just
             after; parity of rows served on the card (TF32 off) against
             the port's Net forward on the CPU; and a speed run of the
             prototxt as written (img/s, p50/p99 request latency).
4b. serve_http — AlexNet at full width through `make_server` on port 0,
             in f32 and in bf16 (ladder 1, 4, 10; a CUDA graph a bucket,
             captured at load): 8 client threads POST the serve phase's
             bursts of seeded PNG/JPEG uploads at 227-320 px (launch
             counts 0 just before, read just after: K1 twice a bucket, K2
             none; every upload decoded through the ingest, PIL where the
             library has no codecs, and preprocessed by the window-fused
             native call; /readyz with compile_count == warmed_buckets);
             each bucket's graph replay against two eager forwards (twice
             their own distance + 1e-6); softmax rows and fc8 logits of 10
             uploads through `submit_bytes`, and the fc8 top-5 over HTTP,
             against the port's Net on the card (TF32 off, 1e-4); the bf16
             bucket nets forward in bfloat16 and K1 is captured in it; the
             bf16 rows differ from the f32 rows, by at most BF16_SERVE_LIMIT
             of the f32 rows' spread across uploads, where another
             upload's row reads above it; a speed run (8 closed-loop clients, 30
             bursts each: img/s, p50/p99, bucket fill, decode and
             preprocess ms, a bucket-10 replay's device ms and a
             dispatch's wall ms).
4c. residency — AlexNet and GoogLeNet on one engine under serve_hbm_mb
             below the sum of their param bytes, alternating traffic:
             spills and reloads, 3 recaptures a reload, the device memory
             an AlexNet spill gives back (at least its params), rows after
             a reload bitwise the rows before, K1 counted.
4d. resilience — over HTTP: the stall breaker (serve_stall_s 1 with the
             serve_dispatch_stall fault site: 504 in flight, /healthz 503,
             a typed 503, recovery to 200, the journal's reasons), a
             deadline (504), the queue limit (429), and swap_weights from
             a caffemodel the port writes (rows equal to the new weights',
             a poisoned canary rejected, the rows kept bitwise, no
             capture), K1 counted.
5. train   — trains models/alexnet/solver.prototxt at full width, batch
             256, on synthetic data through the CLI's `train` entry point
             (20 iterations, a test pass of 2 batches at iteration 0 and at
             the end, a snapshot in a temporary directory), with the launch
             counts set to 0 just before and read just after: K2 must have
             launched twice an iteration and K1 twice a forward, every loss
             must be finite. Then it resumes the snapshot through the same
             entry point, checks that the weights and history came back
             bitwise, and takes one more step.
6. parity  — one SGD step of the same net cut to batch 16 (for this check
             only) on the card against the CPU, TF32 off through the
             prototxt's `default_forward_math: FLOAT`, the same weights,
             feeds and dropout masks (drawn on the CPU). Limits: the loss
             within 1e-5 of its size; each gradient within 1e-4 of its
             largest element for fc6-fc8 and 2e-2 for conv1-conv5, whose
             gradients pass through a max pool's backward (it sends each
             window's gradient to the window's arg-max, and near-ties flip
             under any change of summation order: one f32 rounding of the
             CPU's own input moves them by ~1e-3); each updated
             parameter within base_lr x lr_mult x that limit x the
             gradient's largest element, plus two f32 ulps of the largest
             weight; conv1's gradient nonzero (it sits below both LRNs, so
             it is reached only through K2). The step is repeated with the
             backward under TF32 (the switches as they stood before the
             solver set them for the backward), for the record: it moves
             the fc gradients past their limit.

7. transformer — trains models/transformer_lm (full width, batch 8,
             sequence 64, Adam) from a temporary copy of its solver and net
             with `use_flash: true`, through the CLI's `train`: 20
             iterations and a final test pass of 2 batches, launch counts
             set to 0 just before and read just after (K3 twice a forward,
             K4 and K5 twice an iteration), finite losses, a nonzero
             gradient on blk0/attn.qkv_weight with the attention output's
             graph through the kernels' autograd Function, a torch.profiler
             breakdown, and a resume from the snapshot (weights and both
             Adam slots bitwise, one more step).
8. induction — the induction task of tests/test_sequence_layers.py with
             use_flash: 300 Adam steps on the card, held-out accuracy
             >= 0.9.
9. transformer parity — one Adam step of transformer_lm at batch 8 on the
             card against the CPU, TF32 off: MoE routes equal first, then
             the loss within 1e-5 of its size, each gradient within 1e-4 of
             its largest element, each update within Adam's sensitivity to
             that limit; and the deploy net's prob rows (batch 10, BH 40)
             within 1e-5 of the largest.
10. resnet50 — trains models/resnet50/solver.prototxt as written (batch
             32, 224x224, 53 BatchNorms with scale_bias, poly LR with
             ramp-up) through the CLI's `train`: 20 iterations, a test
             pass of 2 batches at iteration 0 and at the end through the
             statistics the test net shares, launch counts set to 0 just
             before and read just after (ResNet-50 runs none of K1-K5);
             finite losses, every running mean and variance moved from 0
             and finite, a torch.profiler split of a step (convolution
             forward and backward, BatchNorm, elementwise, the rest; the
             card's busy share). Then a resume from the snapshot (weights,
             history and running statistics bitwise, one more step), the
             deploy net served from the snapshot's caffemodel at buckets
             1, 4 and 10, every row against the TEST-phase Net's forward
             on the card, and one SGD step at batch 16 on the card against
             the CPU (limits at RESNET_SPREAD_FACTOR), with BatchNorm's
             two designs held against each other on the card.
11. googlenet — trains models/googlenet/solver.prototxt as written (batch
             128, three losses weighted 0.3, 0.3 and 1) through the CLI's
             `train`: 20 iterations, finite losses, K1 twice a forward and
             K2 twice an iteration, counts set to 0 just before and read
             just after.

12. lmdb  — trains examples/imagenet/caffenet_train_val.prototxt as written
             (batch 256, crop 227, mirror, a mean file) from a train LMDB
             of 1,280 raw 3x256x256 Datums and a val LMDB of 100, both
             written by the port's writer from seeded clusters, with the
             mean from the port's compute_image_mean, through the CLI's
             `train` without -synthetic (20 iterations, test passes of 2
             batches at iteration 10 and at the end, the device
             transform on): finite losses, test scores, K1 twice a
             forward and K2 twice an iteration (counts set to 0 just
             before, read just after). Then the card's busy share under
             the profiler, the same solver on a synthetic feed, `test`
             on the val LMDB from the snapshot's caffemodel, `time` on
             the net (whole step, MFU), `device_query`, one batch of the
             card's device transform against the host DataTransformer
             (bitwise), three batches of the Feeder's native raw gather
             (csrc/native: crc32c over the mapping, the Datum walk, one
             copy a record, one call a batch) against the plain Python
             build (bitwise), the decoded-record cache's second epoch (all
             hits, no decode), 8 iterations over a JPEG-encoded LMDB of
             256 records with the device transform and 8 with
             `use_gpu_transform: false` (the native host transform), each
             with decode.STATS (native decode where the codecs are built,
             PIL where not) and K1/K2 counted, and 3 iterations over a
             copy of the train LMDB with one corrupted record (quarantined,
             journaled, the run goes on). First it prints the native
             library's codec probe and decode_available() on a line of
             their own.

13. bf16  — trains AlexNet at batch 256 from
             models/alexnet/solver_fp16.prototxt (FLOAT16 net defaults)
             and from solver.prototxt under `-precision bf16` (dynamic
             loss scale, the skip-step guard armed), 20 iterations each,
             and transformer_lm with use_flash under `-precision bf16`,
             through the CLI's `train`, launch counts set to 0 just
             before and read just after: K1/K2 (K3-K5) as many times as
             in f32, every launch's input bfloat16 (recorded at the
             kernels' launchers), finite losses, no skipped or overflow
             step; step ms and img/s beside the f32 runs; `time` on the
             fp16 net with its MFU against the dense bf16 peak; and
             ResNet-50 (b32) and GoogLeNet (b128, K1/K2 in bf16) from
             their solver_fp16.prototxt, 20 iterations each.
14. chunk — `-step_chunk 10` on AlexNet (b256), ResNet-50 (b32) and
             transformer_lm (use_flash): two eager runs (step_chunk 1)
             and one of CUDA graph replays from the same seed and feeds;
             the graph's losses and final params, slots and statistics
             within twice the eager runs' spread (each tensor's distance
             from the nearer eager run as a share of its largest
             element, the worst over all tensors, plus 1e-6), its
             Dropout masks the eager
             path's (and in the graph's static inputs), its kernel
             launches the eager run's (the captured counts added at each
             replay); then, warm, 20 iterations at K = 1 and K = 10 in
             mirrored order under the CUDA sync debugger (one host sync
             a chunk at K = 10, or the phase fails; the K = 1 count and
             every sync's source line reported), step ms, and the card's
             busy share under the profiler.
15. overflow — AlexNet b256 under bf16 and step_chunk 10 with NaN
             batches at iterations 3 and 4: both skipped (params and
             slots bitwise unchanged), counted as overflows, the scale
             2^15 -> 2^13, then regrown to 2^15 by 8 clean steps
             (loss_scale_window 4), finite losses.
16. leveldb — the same CaffeNet solver and net with `backend: LEVELDB`,
             over a train LevelDB of 1,280 raw records and a val LevelDB
             of 100 that the port's write_leveldb writes (snappy blocks)
             from the same seeded clusters: 20 iterations through the
             CLI's `train`, K1/K2 counted; the busy share; the first 4
             batches bitwise those of the same records in an LMDB; a
             block that rots after the open quarantined, not fatal.
17. imagedata — the same net with its Data layers replaced by ImageData
             (new_height/new_width 256, shuffle) over 256 PNG and 256
             JPEG files that PIL writes from the clusters: 8 iterations,
             K1/K2 counted, decode.STATS (PIL records without the
             codecs).
18. rcnn  — the layers of models/rcnn/deploy.prototxt (200 outputs) with
             a WindowData layer (batch 128, crop 227, context_pad 16,
             warp, fg/bg 0.5, fg_fraction 0.25, mirror, mean values) in
             place of its Input and a SoftmaxWithLoss on fc-rcnn, over 64
             seeded 3x375x500 PNG images with 30 windows each: 10
             iterations, K1/K2 counted, each batch's fg share.
19. detectnet — examples/kitti/detectnet_tiny.prototxt as written (b8,
             its DetectNetTransformation a host step) on a copy of
             examples/kitti/run.py's seeded scenes with its Adam solver:
             200 iterations; the coverage loss and the masked bbox L1 on
             a held-out batch must fall; 20 iterations at step_chunk 10
             (eager chunks) against step_chunk 1: the same losses.
20. siamese — examples/siamese/mnist_siamese.prototxt as written (b32
             pairs) on seeded clusters, 100 iterations of
             examples/siamese/run.py's solver: the ContrastiveLoss falls.
21. layers — Sigmoid, Slice, Tile, EuclideanLoss, L1Loss and
             ContrastiveLoss forward and backward on the card against
             the CPU, at the shapes those nets give them.
21b. pycaffe — the pycaffe API (caffe_mpi_tpu_torch.pycaffe) at full
             width: caffe.Classifier on models/caffenet/deploy.prototxt
             with a .caffemodel pycaffe.Net.save wrote from a seeded
             init, 10 seeded 256x256 images oversampled (100 crops of
             227, 10 replays of the batch-10 bucket's CUDA graph, every
             blob a static output); caffe.Detector.detect_windows on
             models/rcnn/deploy.prototxt over 2 seeded 375x500 PNG
             images with 50 windows each (context_pad 16); each with
             launch counts 0 just before and read just after (K1 twice a
             forward, the capture's warm-up included; K2 none), rows
             within 1e-4 of the port's Net forward on the same crops
             (TF32 off in both), a replay against eager, the graphs'
             bytes. caffe.SGDSolver on a copy of
             models/caffenet/solver.prototxt whose net reads an LMDB of
             512 seeded records (batch 256, crop 227, mirror, mean
             values): 10 iterations, K1 and K2 twice an iteration, held
             against two runs of Solver.step on the same solver and LMDB
             by PR 9's rule (cuDNN deterministic in all three). The 27 layer types of slice 15 (and
             STOCHASTIC pooling) forward and backward on the card against
             the CPU, FLOAT math; and `remat: true` on conv, BatchNorm,
             LRN, PReLU and Dropout in a step_chunk 5 CUDA graph, cuDNN
             deterministic, bitwise the same net without remat.
22. survive — survivable training and the train-to-serve loop. Two
             supervised LeNet runs side by side, started before the build
             and joined after it (`cli train -max_restarts 2`,
             -synthetic, 30 iterations, step_chunk 10, snapshots every 10;
             a supervisor process that touches no card, children on the
             card): `dispatch_stall` past `-watchdog_deadline` exits
             86 and journals `watchdog:train dispatch` (read while it
             stands), the restart resumes from iteration 10; NaN feeds
             (`nan_grad`) under `-train_guard -anomaly_action rewind_lr`
             exit 88 and the restart carries `-lr_scale 0.1`. Then AlexNet
             at full width (b256, step_chunk 10, -snapshot_every 10
             -snapshot_keep 2): two uninterrupted 30-iteration runs in
             process (launch counts 0 before, read after); on the first,
             a blocking and an async snapshot at one iteration (files
             byte-equal) with a chunk of graph replays run while the
             writer works, and test_chunk 5 (two passes) and 1 as graph
             replays over 10 distinct test batches, each within 1e-6
             relative of a plain loop of eager forwards;
             the tentpole's supervised CLI run with interval snapshots
             blocking (`snapshot_sync`), the iteration-20 snapshot rotted
             after its manifest, the first child killed at the chunk
             starting at 20: one failure logged, the restart resumed from
             10, exactly the snapshots 20 and 30 left and verifying, K1/K2
             44/40 in each child, the final params and history within
             twice the uninterrupted runs' spread + 1e-6 (PR 9's rule),
             and a planted fault (the iteration-20 snapshot restored with
             its history zeroed, run to 30) outside that limit;
             then an AlexNet engine (ladder 1, 4, 10) with a
             SnapshotWatcher on that prefix and `swap_corrupt` armed once:
             iteration 30 rejected (rows bitwise), 20 swapped in (rows
             within 1e-4 of the port's Net on its caffemodel, TF32 off),
             no capture, K1 counted and K2 none. Prints the snapshot's
             bytes and write ms, the async stall, the restarted child's
             restore and chunk ms, the supervised and uninterrupted wall
             times and the watcher's verify and swap ms.
23. dp    — data-parallel training (caffe_mpi_tpu_torch/parallel/).
             (a) world 1 under NCCL: `train -solver
             models/alexnet/solver.prototxt -synthetic -gpu all` (b256,
             step_chunk 10, 20 iterations) against the same run without
             -gpu, cuDNN deterministic in both: params and history equal
             element for element, the all-reduces (gradients and loss)
             captured in the chunk's graph, K1/K2 counted as the plain
             run's. (b) two ranks on the one card over gloo, through
             the library (`init_distributed` and
             `MeshPlan.from_shape(2, devices=[cuda:0, cuda:0])` in two
             processes of this script, `--dp-rank`): AlexNet at global
             batch 256 (128 a rank) and ResNet-50 at 32 (16 a rank, its
             BatchNorm statistics global), FLOAT math, cuDNN
             deterministic, against one-process runs at the global
             batch: AlexNet's params, history slots and running
             statistics after 3 iterations within 1e-2 of each tensor's
             largest element (`_step_rule`), with rank 1's gradients
             left out of the all-reduce of iteration 1 (the planted
             fault) outside it; ResNet-50's forward after one iteration
             (every BatchNorm's running mean and variance, the loss)
             within 1e-3, with every BatchNorm and the last one alone on
             the rank's own statistics outside it; BatchNorm alone at
             each of ResNet-50's 9 input shapes (y, dx, the summed dscale
             and dbias, mean, var) against F.batch_norm of the global
             batch within 1e-4, the rank's own statistics outside it;
             the ranks' states equal; ResNet-50 timed over 4 iterations
             as configured; then, cuDNN
             deterministic, 5 iterations of AlexNet flat, with
             `reduce_overlap` (6 buckets, the hooks' all-reduces) and
             with `zero_stage: 1`: both equal to flat element for element.
             (c) with more than one card, NCCL over min(cards, 4) through
             `train -gpu 0,..,k-1` (skipped on one card): AlexNet flat
             and with `-reduce_overlap`, and ResNet-50, whose first
             (eager) loss is held to 1e-3 of world 1's; then BatchNorm
             alone under NCCL inside captured CUDA graphs
             (`_bn_graphs`, `--bn-rank` processes, one a card): at each
             of ResNet-50's 9 shapes one graph of `_GlobalBatchNorm`'s
             forward and backward, replayed 3 times on new global
             batches, against F.batch_norm of the global batch within
             1e-4, the rank's own statistics outside it. Prints the
             per-rank step ms, the ms a step spent in collectives (the
             union of CUDA event pairs around them, eager runs), the
             bytes reduced a step
             and the bucket count, K1/K2 launches per rank, whether each
             path replayed graphs, and the card's name and power limit.
24. mp    — the mesh's 'model' axis. (a) ranks sharing the one card
             over gloo (`--mp-rank` processes of this script, a 1 x n
             mesh), FLOAT math, cuDNN deterministic, each run against a
             one-process run at the global batch by `_step_rule` at
             1e-2 over every param, history slot and the losses after 3
             iterations, each with a planted fault outside it: two
             ranks: ring_flash_attention at transformer_lm's shape (B·H
             32, S 64, 32 a rank, D 32), causal, f32 and bf16, against
             the same blocks on one card without the transport
             (`_ring_one_card`) at FLASH_TOL and against single-device
             flash_attention (f32 at FLASH_TOL; bf16 at FLASH_TOL's rtol
             plus 2^-6 of the largest element, MP_RING_BF16_SHARE: the
             ring rounds its partials to bf16), with K3/K4/K5
             launches equal to `ring_flash_launches` (fault, in f32 and
             in bf16: the merge's weights swapped);
             models/transformer_lm/solver_sp.prototxt
             as written (Adam; fault: K/V never rotate), with use_flash
             (fault: the swapped merge; K3-K5 launches per rank as
             predicted) and with its MoE split by experts over the ranks
             (`param_shardings`; fault: the combine not summed);
             AlexNet's solver with fc6 `param_sharding: "rows"` and fc7
             "cols" (fault: fc6's input gradient not summed); four
             ranks: solver_pp.prototxt (the 4-stage Pipeline, one stage
             a rank; fault: the replicated output gradient summed over
             the ranks). (b) with 4 cards, NCCL through the CLI
             (`train -mesh data=2,model=2` for solver_sp, `data=1,
             model=4` for solver_pp; skipped with fewer): the first loss
             within 1e-3 of `-gpu 0`'s. Prints the per-rank step ms, the
             model-axis collective ms and bytes a step, K3-K5 launches
             per rank, and the card's name and power limit. The four
             ranks of (a) then form a 2 x 2 mesh (MP_22_RUNS, each
             against its reference by `_step_rule` at 1e-2): the flash
             ring at step_chunk 10 against step_chunk 1 (eager under
             gloo; K3-K5 as `ring_flash_launches` predicts, every
             iteration), AlexNet rows/cols with ZeRO-1 (K1, K2; fault:
             rank 0 updates the other data rank's slice) and with fc6
             gathered on use (a ("data", "model") split) against one
             process, test nets of batch 3 (whole on every rank) within
             1e-3 of one process's scores, and a sharded (ORBAX)
             snapshot, its write ms beside the gathered one's, restored
             on the 2 x 2 mesh and in one process equal element for
             element to the gathered snapshot, restore_auto falling back
             past a flipped shard. (b) adds the flash solver_sp at
             `-step_chunk 10` over the 4 cards, its captured graphs
             dumped and read (`_graph_nodes`: K3-K5 and NCCL's SendRecv
             kernels inside), its losses against step_chunk 1, step ms
             at both; and AlexNet's sharded snapshot written by 4 NCCL
             ranks, restored on card 0.
25. gpipe — GoogLeNet at full width (b128, three losses) through the
             CLI's `train -gpipe 4 -gpipe_micro 4` on one card, every
             stage on it, 4 iterations, launch counts 0 just before and
             read just after: K1 16 and K2 8 an iteration, as
             `gpipe.lrn_launches` predicts; loss and every param, history
             slot and statistic against the port's iter_size 4 run at
             b32 (FLOAT math, cuDNN deterministic) by `_step_rule` at
             1e-2: the CLI's runs on its one synthetic batch, and in
             process on 16 distinct seeded micro-batches (after one
             iteration and after 4), two planted faults above the bound
             there (stage 1 recomputes the next micro-batch's inputs;
             stage 1 sends no cotangent back); the median step ms and
             each stage device's peak memory. `--only gpipe_cards`
             (4 cards): one stage a card against every stage on card 0,
             the first loss within 1e-3, each card's peak memory and
             params, the step ms.
26. eval  — the asynchronous evaluation at AlexNet's full width (b256,
             step_chunk 10, a pass of 10 test batches at 0, 10 and 20):
             each pass bitwise the synchronous `test_all` at the same
             weights, the params bitwise those of a run with no
             evaluation, a pass on the live params (no copy) off; the
             stall a boundary (start, harvest) beside the synchronous
             pass's ms.
27. elastic — two supervised "hosts" sharing card 0 over gloo (LeNet's
             solver, FLOAT math, -min_hosts 1, -host_deadline 3, a
             snapshot every 40 of 400 iterations), run during the build:
             host 1's worker dies at a beat and its supervisor goes dark
             (the host_loss and host_perma_loss fault sites). In order:
             the survivor's `host_lost:1` journal and exit 87,
             generation 2 at world 1, the revived supervisor parked in
             rejoin-wait, re-admission at a snapshot boundary,
             generation 3 at world 2; the final weights against an
             uninterrupted pair by `_step_rule` at 1e-2, a control (the
             weights the regrown generation resumed from) above it; the
             regrown generation's weights and history, at its first
             snapshot and at the end, against a pair resumed from the
             same snapshot at 1e-2, the planted fault (that snapshot's
             history zeroed) above it; the noise floor beside them (the
             uninterrupted pair run twice, one process at world 1).
28. shapes — the static engine (proto/netshape.py) against the card.
             Every net of models/*/ and examples/*/ built on the card in
             TRAIN and TEST (beside the build; the HDF5 net refused), held
             exactly against `analyze_net` with the CPU tests' record
             probe: each layer's out shapes, the blob table, each param's
             shape, lr_mult and decay_mult, the params' bytes on the card
             against `layer_footprint`'s, each layer's MACs. One forward of
             AlexNet, CaffeNet and GoogLeNet deploy and of transformer_lm
             train_val with use_flash at their own batch: K1 launches the
             engine's count of across-channel LRN layers, K3 its count of
             Attention layers, every blob's shape the engine's. AlexNet
             deploy in the ServingEngine on the ladder 1, 4, 10, f32 and
             bf16: the static plan equals the plan the engine keeps, the
             blobs its bucket nets hold on the card and its param_bytes.
             `utils/timers.Timer` against a bare event pair around the
             same AlexNet forward, within 5% or 20 us. `--only shapes`
             runs it alone.
29. fleet — `cli serve -replicas 2` as FleetSupervisor runs it, on
             AlexNet deploy f32 at full width on card 0, started as soon
             as lrn.cu is built, beside flash_attention.cu's nvcc; each
             replica started through `chip_smoke.py --fleet-replica`,
             which writes its clock marks and, at its SIGTERM, its launch
             counts. Weights from seed 0 as a caffemodel. Two replicas
             admitted through /readyz, each with compile_count ==
             warmed_buckets and its time to readyz split (process start,
             imports, load, warm/capture); rows through the router
             within 1e-4 of the in-process engine's on the same weights;
             the serve_http uploads through the router (all 200, both
             replicas serving). Once the runs beside the build have
             ended (nvcc may still run): 10 s of sequential requests (the two-replica
             baseline), then replica 1 killed by `replica_dead` at a
             beat (armed through the wrapper) while sequential traffic
             flows: no request unresolved or untyped, the journal's
             replica_dead then replica_respawned, the respawn admitted
             (its readyz split), the kill's p99 within max(1.5 x the
             baseline's, + 25 ms); img/s, p50 and p99 through the router
             against replica 0 directly (closed-loop clients in a
             process of their own); a rolling swap of fc8 x 3 (scores
             move on every replica, no build), a NaN candidate (typed
             SwapError, every replica's answer bitwise kept); K1 2 a
             bucket forward in each replica; `serve -serve_program_bank`
             and `-require_bank_warm` exit 1. `--only fleet` runs it
             alone; `--only fleet_cards` (4 cards) runs four replicas,
             one a card, router against one replica.

It prints one {"native_codec": ...} line (during phase 12), one
{"kernels": [...]} line (K1-K5), one {"serving": ...} line (phases
4-4d),
one {"train": ...} line, one {"transformer": ...} line, one
{"resnet50": ...} line, one {"googlenet": ...} line, one {"lmdb": ...}
line, one {"bf16": ...} line, one {"chunk": ...} line (the overflow
phase inside it), one line each for phases 16-21 ({"leveldb": ...},
{"imagedata": ...}, {"rcnn": ...}, {"detectnet": ...}, {"siamese":
...}, {"zoo_layers": ...}), one {"pycaffe": ...} line, one
{"survive": ...} line, one
{"dp": ...} line, one {"mp": ...} line, one {"gpipe": ...}, one
{"eval": ...}, one {"elastic": ...}, one {"shapes": ...} and one
{"fleet": ...} line, one
{"phase_seconds": ...} line (the wall seconds of each group of phases;
"elastic_during_build", "shapes_during_build" and "fleet_during_build"
the elastic runs', the shapes phase's builds' and the fleet phase's,
which overlap the build; "fleet" the fleet phase's wall past the build),
the card line again, and last {"ok": true, ...}.
"""

from __future__ import annotations

import copy
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

T_PROCESS = time.time()  # a fleet replica's clock mark before its imports

from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(ROOT, "models", "alexnet", "deploy.prototxt")
SOLVER = os.path.join(ROOT, "models", "alexnet", "solver.prototxt")
TRAIN_ITERS = 20
TEST_ITER = 2
# ImageNet preprocessing of the reference Classifier recipe: BGR, 0..255,
# mean-subtracted — so the served activations are at a realistic scale
PREPROCESS = dict(raw_scale=255.0, mean=np.array([104.0, 117.0, 123.0]),
                  channel_swap=(2, 1, 0))


def f32_product_rate(rates) -> float:
    """The rate of an f32 matrix product held at f32 accuracy on the tensor
    cores: 3xTF32, three TF32 products (dense TF32 is half the bf16 rate)
    for each — 164.8 TFLOP/s on the H100 SXM. K4 and K5 multiply f32 that
    way, as PyTorch's own f32 attention does, so the flash bounds take this
    rate for f32 inputs; taken at the CUDA cores' 67 TFLOP/s, a 3xTF32
    kernel could read past 100% of its bound."""
    return rates[2] / 2 / 3

LRN = dict(size=5, alpha=1e-4, beta=0.75, k=1.0)  # AlexNet norm1/norm2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# -- 1. device ----------------------------------------------------------------

def device_phase() -> tuple[str, tuple[float, float]]:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    # (memory bytes/s, float32 flop/s outside the tensor cores, dense bf16
    # tensor-core flop/s), NVIDIA data sheets: the repo's one table. The
    # LRN kernels' work is elementwise, so their bounds take the CUDA
    # cores' f32 rate.
    from caffe_mpi_tpu_torch.utils.flops import card_rates
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    if rates is None:
        fail(f"no published rates for {name!r}; add it to CARD_RATES in "
             "caffe_mpi_tpu_torch/utils/flops.py")
    return card, rates


# -- 2. build -----------------------------------------------------------------

def build_phase() -> None:
    from caffe_mpi_tpu_torch.ops import build
    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.1f} s "
        "wall, nvcc for sm_90a, c++ for host code)")


# -- 3. kernels ---------------------------------------------------------------

def time_ms(fn, reps: int = 40, hold_ms: float = 25.0) -> float:
    """Median device time of one call, from CUDA events around it. A 96 MiB
    write before each call flushes the 50 MB L2, as the serving path finds
    its activations after the convolution that wrote them. The stream is
    first held by a device-side sleep of `hold_ms` while the host enqueues
    every rep, so the events time the device's work and not the host's
    launch overhead."""
    flush = torch.empty(96 * 2**20 // 4, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * hold_ms / 1e3))  # cycles at <= 2 GHz
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def lrn_bound(shape, dtype, size, rates, tensors=2,
              ops_per_elem=None) -> tuple[float, str]:
    """Least time for the work: `tensors` full tensors moved once (K1: x
    read and y written; K2: x and dy read, dx written) over the memory
    rate, against the float32 operations an element (K1: 2*size+6 — window
    squares and adds, scale, log, exp, products; K2: 3*size+10 — the same
    scale, the ratio and its window sum, dx) over the f32 peak."""
    mem_rate, f32_rate = rates[:2]
    elems = float(np.prod(shape))
    itemsize = torch.empty((), dtype=dtype).element_size()
    t_bytes = tensors * elems * itemsize / mem_rate * 1e3
    ops = ops_per_elem if ops_per_elem is not None else 2 * size + 6
    t_ops = elems * ops / f32_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# f32 at rtol 1e-5 / atol 1e-6 as the CPU tests; bf16 at one ulp
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.bfloat16: dict(rtol=8e-3, atol=1e-6)}
# edge shapes of the CPU tests: C < size, 1x1 maps, HW not a multiple of
# 128; checked at every window size
EDGE_SHAPES = ((2, 96, 13, 13), (1, 3, 5, 5), (2, 16, 1, 1), (1, 8, 7, 9))
# every templated window's edge, and past it the runtime-window kernels
EDGE_SIZES = (1, 3, 5, 7, 15, 17)
# more images than a second grid axis holds (65,535); two runs of 16
# channels, so the one-axis grid folds runs and images
MANY_IMAGES = (70000, 20, 2, 2)


def _alexnet_lrn_shapes(batches):
    for b in batches:
        yield "norm1", (b, 96, 55, 55)
        yield "norm2", (b, 256, 27, 27)


# GoogLeNet's two LRNs at its training batch, local_size 5, alpha 1e-4,
# beta 0.75, as AlexNet's (models/googlenet/train_val.prototxt
# pool1/norm1, conv2/norm2)
GOOGLENET_LRN_SHAPES = (("googlenet/pool1/norm1", (128, 64, 56, 56)),
                        ("googlenet/conv2/norm2", (128, 192, 56, 56)))


def _kernel_entry(name, source, replaces, cases, max_err, per) -> dict:
    """The kernels-line entry: the head case is norm1 at batch 256 in f32,
    the shape the training path gives the kernel."""
    head = next(c for c in cases if c["layer"] == "norm1"
                and c["shape"][0] == 256 and c["dtype"] == "float32")
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": None,  # the training path's count, filled by train_phase
        "max_abs_err": max_err,
        "shape": head["shape"], "dtype": head["dtype"],
        "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        **({"parent_kernel_ms": head["parent_kernel_ms"]}
           if "parent_kernel_ms" in head else {}),
        **per, "cases": cases,
    }


def _held(kind, got, want, dtype) -> tuple[float, bool]:
    """(max abs error, bitwise) of a kernel's output against its plain
    version's; fails past TOL."""
    try:
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    except AssertionError as e:
        fail(f"{kind} against its plain version: {str(e).splitlines()[0]}")
    return float((got.float() - want.float()).abs().max()), \
        bool(torch.equal(got, want))


def _edge_checks(kind, check) -> dict:
    """`check(shape, dtype, size, alpha, beta, k)` -> (max abs error,
    bitwise) at every edge shape and window size, and at MANY_IMAGES
    (sizes 5 and 17), in both types: the worst error and whether every
    case was bitwise."""
    out = {"max_abs_err": 0.0, "bitwise": True, "cases": 0}
    cases = [(shape, size) for shape in EDGE_SHAPES for size in EDGE_SIZES]
    cases += [(MANY_IMAGES, 5), (MANY_IMAGES, 17)]
    for shape, size in cases:
        for dtype in TOL:
            err, exact = check(shape, dtype, size, 1e-2, 0.75, 2.0)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out["bitwise"] &= exact
            out["cases"] += 1
    log(f"{kind} edges: {json.dumps(out)} (sizes {list(EDGE_SIZES)}, "
        f"{MANY_IMAGES[0]} images at 5 and 17)")
    return out


def kernel_phase(rates, parent_lrn=None) -> dict:
    """K1, the LRN forward, at the edge shapes and windows, at 70,000
    images, and at AlexNet's norm1 and norm2 for every serving bucket (1,
    4, 10) and the training batch 256, each case timed against its bound;
    with `parent_lrn` (a parent checkout's built lrn library), the
    parent's K1 is timed in turns with this tree's."""
    import torch.nn.functional as F
    from caffe_mpi_tpu_torch.ops import lrn as lrn_op

    gen = torch.Generator(device="cuda").manual_seed(0)

    def check(shape, dtype, size, alpha, beta, k):
        x = (torch.randn(shape, generator=gen, device="cuda") * 4).to(dtype)
        y = lrn_op.lrn_across_channels(x, size, alpha, beta, k)
        r = lrn_op.lrn_across_channels_ref(x, size, alpha, beta, k)
        torch.cuda.synchronize()
        return _held("lrn_fwd", y, r, dtype)

    edges = _edge_checks("lrn_fwd", check)
    max_err, bitwise = edges["max_abs_err"], edges["bitwise"]
    cases = []
    args = (LRN["size"], LRN["alpha"], LRN["beta"], LRN["k"])
    for layer, shape in (*_alexnet_lrn_shapes((1, 4, 10, 256)),
                         *GOOGLENET_LRN_SHAPES):
        for dtype in TOL:
            x = (torch.randn(shape, generator=gen, device="cuda") * 4).to(
                dtype)
            err, exact = _held(
                "lrn_fwd", lrn_op.lrn_across_channels(x, *args),
                lrn_op.lrn_across_channels_ref(x, *args), dtype)
            max_err, bitwise = max(max_err, err), bitwise and exact
            bound, by = lrn_bound(shape, dtype, LRN["size"], rates)
            ms, parent = in_turns(
                lambda: lrn_op.lrn_across_channels(x, *args),
                None if parent_lrn is None else
                lambda: call_lrn_fwd(parent_lrn, x, *args))
            case = {
                "layer": layer, "shape": list(shape),
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err, "bitwise": exact, "kernel_ms": ms,
                "plain_ms": time_ms(
                    lambda: lrn_op.lrn_across_channels_ref(x, *args)),
                "library_ms": time_ms(
                    lambda: F.local_response_norm(x, *args)),
                "bound_ms": bound, "bound_by": by,
                "kernel_GB_s": 2 * x.numel() * x.element_size()
                / (ms * 1e-3) / 1e9,
                "share_of_bound": bound / ms, **parent,
            }
            if case["share_of_bound"] > 1:
                fail(f"lrn_fwd {layer} {case['dtype']}: {ms:.4g} ms under "
                     f"its bound {bound:.4g} ms")
            cases.append(case)
            log(f"lrn {json.dumps(case)}")
            del x
            torch.cuda.empty_cache()
    return _kernel_entry("lrn_fwd", "caffe_mpi_tpu_torch/csrc/lrn.cu",
                         lrn_op.REPLACES, cases, max_err,
                         {"launches_per_forward": 2, "bitwise": bitwise,
                          "edges": edges})


def kernel_bwd_phase(rates, parent_lrn=None) -> dict:
    """K2, the LRN backward, at the edge shapes and windows, at 70,000
    images, and at AlexNet's norm1 and norm2 for the training batch 256.
    The library call is the backward of F.local_response_norm, timed as
    torch.autograd.grad over a graph built once; each case frees its
    tensors before the next. With `parent_lrn` (a parent checkout's built
    lrn library), the parent's K2 is timed in turns with this tree's
    (parent, kernel, kernel, parent)."""
    import torch.nn.functional as F
    from caffe_mpi_tpu_torch.ops import lrn as lrn_op

    gen = torch.Generator(device="cuda").manual_seed(1)
    args = (LRN["size"], LRN["alpha"], LRN["beta"], LRN["k"])

    def inputs(shape, dtype):
        x = (torch.randn(shape, generator=gen, device="cuda") * 4).to(dtype)
        return x, torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def check(shape, dtype, size, alpha, beta, k):
        x, dy = inputs(shape, dtype)
        dx = lrn_op.lrn_across_channels_bwd(x, dy, size, alpha, beta, k)
        r = lrn_op.lrn_across_channels_bwd_ref(x, dy, size, alpha, beta, k)
        torch.cuda.synchronize()
        return _held("lrn_bwd", dx, r, dtype)

    edges = _edge_checks("lrn_bwd", check)
    max_err, bitwise = edges["max_abs_err"], edges["bitwise"]
    # autograd reaches K2: a graph through K1 on the card gives the
    # gradient the plain pair gives on the CPU
    xc = torch.randn((2, 16, 6, 6), generator=gen, device="cuda")
    xr = xc.clone().requires_grad_()
    y = lrn_op.lrn_across_channels(xr, 5, 1e-2, 0.75, 2.0)
    if y.grad_fn is None:
        fail("lrn_across_channels on the card returned no autograd graph")
    before = lrn_op.lrn_across_channels_bwd.launches
    y.square().sum().backward()
    if lrn_op.lrn_across_channels_bwd.launches != before + 1:
        fail("backward through lrn_across_channels did not launch K2")
    xh = xc.cpu().requires_grad_()
    lrn_op.lrn_across_channels(xh, 5, 1e-2, 0.75, 2.0).square().sum() \
        .backward()
    torch.testing.assert_close(xr.grad.cpu(), xh.grad, rtol=1e-5, atol=1e-6)
    cases = []
    for layer, shape in (*_alexnet_lrn_shapes((256,)),
                         *GOOGLENET_LRN_SHAPES):
        for dtype in TOL:
            x, dy = inputs(shape, dtype)
            err, exact = _held(
                "lrn_bwd", lrn_op.lrn_across_channels_bwd(x, dy, *args),
                lrn_op.lrn_across_channels_bwd_ref(x, dy, *args), dtype)
            max_err, bitwise = max(max_err, err), bitwise and exact
            bound, by = lrn_bound(shape, dtype, LRN["size"], rates,
                                  tensors=3, ops_per_elem=3 * LRN["size"]
                                  + 10)
            ms, parent = in_turns(
                lambda: lrn_op.lrn_across_channels_bwd(x, dy, *args),
                None if parent_lrn is None else
                lambda: call_lrn_bwd(parent_lrn, x, dy, *args))
            plain = time_ms(
                lambda: lrn_op.lrn_across_channels_bwd_ref(x, dy, *args))
            xg = x.detach().requires_grad_()
            yg = F.local_response_norm(xg, *args)
            library = time_ms(lambda: torch.autograd.grad(
                yg, xg, dy, retain_graph=True))
            del xg, yg
            case = {
                "layer": layer, "shape": list(shape),
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err, "bitwise": exact, "kernel_ms": ms,
                "plain_ms": plain,
                "library_ms": library, "bound_ms": bound, "bound_by": by,
                "kernel_GB_s": 3 * x.numel() * x.element_size()
                / (ms * 1e-3) / 1e9,
                "share_of_bound": bound / ms, **parent,
            }
            if case["share_of_bound"] > 1:
                fail(f"lrn_bwd {layer} {case['dtype']}: {ms:.4g} ms under "
                     f"its bound {bound:.4g} ms")
            cases.append(case)
            log(f"lrn_bwd {json.dumps(case)}")
            del x, dy
            torch.cuda.empty_cache()
    return _kernel_entry("lrn_bwd", "caffe_mpi_tpu_torch/csrc/lrn.cu",
                         lrn_op.REPLACES_BWD, cases, max_err,
                         {"launches_per_iteration": 2, "bitwise": bitwise,
                          "edges": edges})


# -- 3b. flash attention (K3, K4, K5) ------------------------------------------

# kernel against plain: (rtol, atol as a share of the plain output's
# largest element). f32: both sum in f32 in other orders, over up to 2048
# keys or queries; bf16: one bf16 ulp of the output, as the LRN kernels
FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (8e-3, 1e-5)}
# the training path's attention: transformer_lm at batch 8, 4 heads,
# sequence 64, head dim 32
FLASH_PATH = dict(bh=32, s=64, d=32)
# head dims past the tensor-core kernels' 128, which the wide kernels take
WIDE_HEAD_DIMS = (160, 256)


def _flash_cases():
    """(label, BH, S, D, dtype, causal, sk_valid, bias). The first is the
    path's shape; then the edge shapes: non-causal, bf16, the deploy net's
    batch 10, a ragged length with an odd head dim, S = 200 padded to 256
    as flash_attention pads it, a bias masking a whole 128-wide tile, and
    long sequences at three head dims."""
    f32, bf16 = torch.float32, torch.bfloat16
    yield "path", 32, 64, 32, f32, True, None, False
    yield "path_noncausal", 32, 64, 32, f32, False, None, False
    yield "path_bf16", 32, 64, 32, bf16, True, None, False
    yield "deploy_b10", 40, 64, 32, f32, True, None, False
    # lengths up to 128 go unpadded: ragged 64-row tiles, odd head dim
    yield "ragged_s100_d20", 8, 100, 20, f32, True, None, False
    yield "pad_s200", 32, 256, 32, f32, True, 200, False
    yield "pad_s200_noncausal", 32, 256, 32, f32, False, 200, False
    yield "bias_tile", 32, 256, 32, f32, False, None, True
    yield "bias_tile_causal_bf16", 32, 256, 64, bf16, True, None, True
    for s in (1024, 2048):
        for d in (32, 64, 128):
            yield f"s{s}_d{d}", 32, s, d, f32, True, None, False
    yield "s2048_d128_noncausal", 32, 2048, 128, f32, False, None, False
    yield "s2048_d128_bf16", 32, 2048, 128, bf16, True, None, False
    # past the tensor-core kernels' 128: the wide kernels
    for d in WIDE_HEAD_DIMS:
        yield f"wide_s1024_d{d}", 32, 1024, d, f32, True, None, False
        yield f"wide_s1024_d{d}_bf16", 32, 1024, d, bf16, True, None, False
    yield "wide_pad_s200_d160", 8, 256, 160, f32, True, 200, False
    yield "wide_bias_tile_d256_bf16", 8, 256, 256, bf16, False, None, True


def flash_bound(kind, bh, s, d, dtype, causal, sk_valid, bias, rates):
    """Least time for one kernel's work: each input read once and each
    output written once over the memory rate, against 4 (K3), 6 (K4) or 8
    (K5) flops x D for every unmasked (query, key) pair over the 3xTF32
    rate (f32 inputs, `f32_product_rate`) or the bf16 tensor-core peak
    (bf16 inputs). K5 has no sk_valid mask, so its pairs run over every
    key."""
    mem_rate, bf16_rate = rates[0], rates[2]
    isz = torch.empty((), dtype=dtype).element_size()
    mat = bh * s * d * isz                 # one (BH, S, D) tensor
    rows = bh * s * 4                      # one f32 (BH, S) vector
    extra = s * 4 if bias else 0
    nbytes = {"fwd": 4 * mat + rows, "dq": 5 * mat + 2 * rows,
              "dkv": 6 * mat + 2 * rows}[kind] + extra
    limit = s if (kind == "dkv" or sk_valid is None) else sk_valid
    per_row = np.minimum(np.arange(s) + 1, limit) if causal \
        else np.full(s, limit)
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * bh * d \
        * float(per_row.sum())
    peak = f32_product_rate(rates) if dtype == torch.float32 else bf16_rate
    t_bytes, t_ops = nbytes / mem_rate * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _flash_close(name, got, want, dtype):
    """Max abs error of got against want; fails past FLASH_TOL."""
    rtol, share = FLASH_TOL[dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max())
    if not bool(torch.all(diff <= share * float(w.abs().max())
                          + rtol * w.abs())):
        fail(f"{name}: kernel against plain max abs error {err:.3g} "
             f"(largest plain element {float(w.abs().max()):.3g})")
    return err


# PyTorch's fused attention backends, each timed pinned alone
# (FLASH_ATTENTION takes 16-bit inputs without a mask only); MATH, the
# unfused path, is timed beside them.
FUSED_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def sdpa_library(q, k, v, do, mask, causal) -> dict:
    """The library yardstick of K3 (forward) and K4 + K5 (one backward call
    computing dQ, dK and dV): F.scaled_dot_product_attention on 4-D views
    (1, BH, S, D) of the same tensors — the fused backends take only 4-D
    inputs, and a 3-D call falls back to the math path — with the mask as
    (1, 1 or BH, S, S). Each fused backend runs pinned alone under
    sdpa_kernel, so a backend that refuses the case raises and is skipped
    by name instead of falling back to math quietly. The fastest fused
    forward and backward are the library's times; the math path's stand
    beside them."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4, do4 = (t.unsqueeze(0) for t in (q, k, v, do))
    m4 = None if mask is None else mask.reshape(1, -1, *mask.shape[-2:])
    kw = dict(attn_mask=m4, is_causal=causal and mask is None)
    times, refused = {}, {}
    for name in (*FUSED_BACKENDS, "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            refused[name] = "not in this PyTorch"
            continue
        try:
            with sdpa_kernel([backend]):
                fwd = time_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, **kw))
                qg, kg, vg = (t.detach().clone().requires_grad_()
                              for t in (q4, k4, v4))
                og = F.scaled_dot_product_attention(qg, kg, vg, **kw)
            bwd = time_ms(lambda: torch.autograd.grad(
                og, (qg, kg, vg), do4, retain_graph=True))
            del qg, kg, vg, og
        except RuntimeError as e:
            refused[name] = str(e).strip().splitlines()[0][:160]
            continue
        times[name] = (fwd, bwd)
    fused = {n: t for n, t in times.items() if n != "MATH"}
    out = {"refused": refused}
    for i, kind in enumerate(("fwd", "bwd")):
        best = min(fused, key=lambda n: fused[n][i]) if fused else None
        out[kind] = {"library_ms": fused[best][i] if best else None,
                     "library_backend": best,
                     "library_math_ms": times["MATH"][i]
                     if "MATH" in times else None,
                     "library_fused_ms": {n: t[i] for n, t in fused.items()}}
    return out


def in_turns(run, run_parent=None) -> tuple[float, dict]:
    """The kernel's time; with `run_parent`, the parent's kernel and this
    tree's timed in turns (parent, kernel, kernel, parent) on the same
    inputs: (mean of the kernel's two, the parent's fields)."""
    if run_parent is None:
        return time_ms(run), {}
    p1 = time_ms(run_parent)
    ms = time_ms(run)
    ms2 = time_ms(run)
    p2 = time_ms(run_parent)
    ms_mean = (ms + ms2) / 2
    return ms_mean, {"parent_kernel_ms": (p1 + p2) / 2,
                     "parent_kernel_ms_turns": [p1, p2],
                     "kernel_ms_turns": [ms, ms2],
                     "speedup_over_parent": (p1 + p2) / 2 / ms_mean}


def build_lib(src: str, out: str, extra=()) -> str:
    """A kernel source (`src`) built with the port's nvcc flags and
    `extra` into the shared library `out`; returns nvcc's output (the
    `-Xptxas -v` lines where asked for). Fails on an nvcc error."""
    from caffe_mpi_tpu_torch.ops import build
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, *extra,
                           "-o", out, src], capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        fail(f"nvcc failed on {src}: {proc.stderr[-2000:]}")
    return proc.stdout + proc.stderr


def bind_flash(path: str):
    """The K3, K4 and K5 C entry points of a built flash_attention library;
    every version of the source takes the same arguments."""
    import ctypes
    lib = ctypes.CDLL(path)
    P, I, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for dt in ("f32", "bf16"):
        getattr(lib, f"flash_fwd_{dt}").argtypes = [P] * 6 + [I] * 6 \
            + [F_, P]
        getattr(lib, f"flash_bwd_dq_{dt}").argtypes = [P] * 8 + [I] * 6 \
            + [F_, P]
        getattr(lib, f"flash_bwd_dkv_{dt}").argtypes = [P] * 9 + [I] * 5 \
            + [F_, P]
    return lib


def bind_lrn(path: str):
    """The K1 and K2 C entry points of a built lrn library; every version
    of the source takes the same arguments."""
    import ctypes
    lib = ctypes.CDLL(path)
    P, I, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for dt in ("f32", "bf16"):
        getattr(lib, f"lrn_fwd_{dt}").argtypes = [P, P, I, I, I, I, F_, F_,
                                                  F_, P]
        getattr(lib, f"lrn_bwd_{dt}").argtypes = [P, P, P, I, I, I, I, F_,
                                                  F_, F_, F_, P]
    return lib


def parent_libs(parent: str):
    """The kernels of a parent checkout (`--parent DIR`), built from
    DIR/caffe_mpi_tpu_torch/csrc/flash_attention.cu and lrn.cu (in
    parallel) into a temporary directory, so that one call times the
    parent's K1-K5 beside this tree's on the same card and inputs:
    (flash library, lrn library)."""
    srcs = [os.path.join(parent, "caffe_mpi_tpu_torch", "csrc", name)
            for name in ("flash_attention.cu", "lrn.cu")]
    for src in srcs:
        if not os.path.isfile(src):
            fail(f"--parent: no {src}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parent_")
    try:
        outs = [os.path.join(tmp, f"libparent_{i}.so") for i in range(2)]
        with ThreadPoolExecutor(2) as ex:
            list(ex.map(build_lib, srcs, outs))
        return bind_flash(outs[0]), bind_lrn(outs[1])  # loaded
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def call_lrn_fwd(lib, x, size, alpha, beta, k):
    """One launch of a bound library's K1; returns y."""
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    dt = "f32" if x.dtype == torch.float32 else "bf16"
    err = getattr(lib, f"lrn_fwd_{dt}")(
        x.data_ptr(), y.data_ptr(), n, c, h * w, size, alpha / size, beta, k,
        torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"lrn_fwd launch failed: cudaError {err}")
    return y


def call_lrn_bwd(lib, x, dy, size, alpha, beta, k):
    """One launch of a bound library's K2; returns dx."""
    n, c, h, w = x.shape
    dx = torch.empty_like(x)
    dt = "f32" if x.dtype == torch.float32 else "bf16"
    err = getattr(lib, f"lrn_bwd_{dt}")(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, c, h * w, size,
        alpha / size, beta, k, 2.0 * alpha * beta / size,
        torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"lrn_bwd launch failed: cudaError {err}")
    return dx


def call_flash_fwd(lib, q, k, v, causal, sk_valid, kb):
    """One launch of a bound library's K3; returns (o, lse)."""
    import math
    dt = "f32" if q.dtype == torch.float32 else "bf16"
    bh, sq, d = q.shape
    sk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    err = getattr(lib, f"flash_fwd_{dt}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kb is None else kb.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh, sq, sk, d, sk if sk_valid is None else sk_valid, int(causal),
        1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"fwd kernel launch failed: cudaError {err}")
    return o, lse


def call_flash_bwd(lib, kind, q, k, v, do, lse, delta, causal, sk_valid,
                   kb):
    """One launch of a bound library's K4 (kind "dq") or K5 ("dkv");
    returns (dq,) or (dk, dv)."""
    import math
    dt = "f32" if q.dtype == torch.float32 else "bf16"
    bh, sq, d = q.shape
    sk = k.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(),
              None if kb is None else kb.data_ptr())
    if kind == "dq":
        out = (torch.empty_like(q),)
        err = getattr(lib, f"flash_bwd_dq_{dt}")(
            *common, out[0].data_ptr(), bh, sq, sk, d,
            sk if sk_valid is None else sk_valid, int(causal),
            1.0 / math.sqrt(d), stream)
    else:
        out = (torch.empty_like(k), torch.empty_like(v))
        err = getattr(lib, f"flash_bwd_dkv_{dt}")(
            *common, out[0].data_ptr(), out[1].data_ptr(), bh, sq, sk, d,
            int(causal), 1.0 / math.sqrt(d), stream)
    if err:
        fail(f"{kind} kernel launch failed: cudaError {err}")
    return out


def flash_kernel_phase(rates, parent_lib=None) -> list[dict]:
    """K3, K4 and K5 against their plain versions at the path's shape and
    the edge shapes, each timed beside its plain version, the library
    call (`sdpa_library`: the fastest pinned fused backend, and the math
    path) and its bound; with `parent_lib`, the parent's K3, K4 and K5
    too, timed in turns with this tree's (parent, kernel, kernel, parent).
    Then
    autograd through flash_attention on the card against the CPU."""
    from caffe_mpi_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = {"fwd": [], "dq": [], "dkv": []}
    max_err = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for label, bh, s, d, dtype, causal, sk_valid, bias in _flash_cases():
        q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        kb, mask = None, None
        if sk_valid is not None:  # as flash_attention pads: zero rows
            for t in (q, k, v, do):
                t[:, sk_valid:] = 0
            cols = torch.arange(s, device="cuda")
            mask = cols[None, :] < sk_valid
            if causal:
                mask = mask & (cols[:, None] >= cols[None, :])
        if bias:
            kb = torch.zeros((1, s), device="cuda")
            kb[0, :128] = torch.linspace(-1.0, 1.0, 128, device="cuda")
            kb[0, 128:] = -float("inf")
            mask = kb.reshape(1, 1, s).expand(bh, s, s)
            if causal:
                mask = mask.masked_fill(~torch.ones(
                    (s, s), dtype=torch.bool, device="cuda").tril(),
                    -float("inf"))
        kw = dict(causal=causal, k_bias=kb)
        kq = dict(kw, sk_valid=sk_valid)
        o, lse = fa.flash_fwd(q, k, v, **kq)
        o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, **kq)
        delta = fa._delta(do, o)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kq)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        dq_ref = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kq)
        dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        keep = slice(None) if sk_valid is None else slice(0, sk_valid)
        errs = {
            "fwd": max(_flash_close(f"K3 {label} O", o, o_ref, dtype),
                       _flash_close(f"K3 {label} lse", lse, lse_ref,
                                    torch.float32)),
            "dq": _flash_close(f"K4 {label} dQ", dq, dq_ref, dtype),
            # K5's rows past sk_valid are sliced off by flash_attention
            "dkv": max(_flash_close(f"K5 {label} dK", dk[:, keep],
                                    dk_ref[:, keep], dtype),
                       _flash_close(f"K5 {label} dV", dv[:, keep],
                                    dv_ref[:, keep], dtype)),
        }
        plain_max = {"fwd": float(o_ref.float().abs().max()),
                     "dq": float(dq_ref.float().abs().max()),
                     "dkv": max(float(dk_ref[:, keep].float().abs().max()),
                                float(dv_ref[:, keep].float().abs().max()))}
        lib = sdpa_library(q, k, v, do, mask, causal)
        runs = {
            "fwd": lambda: fa.flash_fwd(q, k, v, **kq),
            "dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kq),
            "dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)}
        plains = {
            "fwd": lambda: fa.flash_fwd_ref(q, k, v, **kq),
            "dq": lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kq),
            "dkv": lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                **kw)}
        for kind in ("fwd", "dq", "dkv"):
            run_parent = None
            if parent_lib is not None and kind == "fwd":
                def run_parent():
                    return call_flash_fwd(parent_lib, q, k, v, causal,
                                          sk_valid, kb)
            elif parent_lib is not None:
                def run_parent(kind=kind):
                    return call_flash_bwd(parent_lib, kind, q, k, v, do,
                                          lse, delta, causal, sk_valid, kb)
            ms, parent = in_turns(runs[kind], run_parent)
            bound, by = flash_bound(kind, bh, s, d, dtype, causal, sk_valid,
                                    bias, rates)
            max_err[kind] = max(max_err[kind], errs[kind])
            case = {"case": label, "shape": [bh, s, d],
                    "dtype": str(dtype).replace("torch.", ""),
                    "causal": causal, "sk_valid": sk_valid, "bias": bias,
                    "max_abs_err": errs[kind],
                    "plain_max_abs": plain_max[kind], "kernel_ms": ms,
                    "plain_ms": time_ms(plains[kind]),
                    **{key: val for key, val in
                       lib["fwd" if kind == "fwd" else "bwd"].items()},
                    "library_refused": lib["refused"],
                    "bound_ms": bound, "bound_by": by,
                    "share_of_bound": bound / ms, **parent}
            if case["share_of_bound"] > 1:
                fail(f"{kind} {label}: {ms:.4g} ms under its bound "
                     f"{bound:.4g} ms")
            cases[kind].append(case)
            log(f"flash_{kind} {json.dumps(case)}")
        del q, k, v, do, o, lse, dq, dk, dv
        torch.cuda.empty_cache()

    # autograd: flash_attention on the card launches K3 once forward and
    # K4, K5 once backward, and its gradients are the CPU's
    b, s, h, d = 8, 64, 4, 32
    xs = [torch.randn((b, s, h, d), generator=gen, device="cuda")
          for _ in range(4)]
    tc = [x.clone().requires_grad_() for x in xs[:3]]
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    out = fa.flash_attention(*tc, causal=True)
    if "_FlashFunctionBackward" not in _graph_nodes(out):
        fail("flash_attention on the card returned no _FlashFunction graph")
    (out * xs[3]).sum().backward()
    after = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
             fa.flash_bwd_dkv.launches)
    if [a - b_ for a, b_ in zip(after, before)] != [1, 1, 1]:
        fail(f"flash_attention forward+backward launched {before} -> "
             f"{after}, want one of each")
    th = [x.cpu().requires_grad_() for x in xs[:3]]
    (fa.flash_attention(*th, causal=True) * xs[3].cpu()).sum().backward()
    for name, a, c in zip("qkv", tc, th):
        _flash_close(f"autograd d{name}", a.grad.cpu(), c.grad,
                     torch.float32)
    many = _many_heads_check(fa, gen)

    out = []
    for kind, name, rep, per in (
            ("fwd", "flash_fwd", fa.REPLACES, "launches_per_forward"),
            ("dq", "flash_bwd_dq", fa.REPLACES_DQ, "launches_per_iteration"),
            ("dkv", "flash_bwd_dkv", fa.REPLACES_DKV,
             "launches_per_iteration")):
        head = cases[kind][0]
        out.append({
            "name": name, "route": "cuda",
            "source": "caffe_mpi_tpu_torch/csrc/flash_attention.cu",
            "replaces": rep,
            "launches": None,  # the transformer path's count
            "max_abs_err": max_err[kind],
            "shape": head["shape"], "dtype": head["dtype"],
            "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library_backend": head["library_backend"],
            "library_math_ms": head["library_math_ms"],
            "library": "F.scaled_dot_product_attention on (1, BH, S, D), "
            "the fastest fused backend pinned alone" + (
                "" if kind == "fwd" else "; torch.autograd.grad through it "
                "(dQ, dK, dV together)"),
            **({"parent_kernel_ms": head["parent_kernel_ms"]}
               if "parent_kernel_ms" in head else {}),
            per: 2, "cases": cases[kind],
            "many_heads": many[kind],
        })
    return out


# more batch x heads than the grid's second axis holds, at a tiny S and D
MANY_HEADS = (70000, 16, 8)


def _many_heads_check(fa, gen) -> dict:
    """K3, K4 and K5 at MANY_HEADS batch x heads, causal, in both types,
    against their plain versions (FLASH_TOL): the wrapper launches each in
    runs of at most 65,535 heads, so each launch count moves by two."""
    bh = MANY_HEADS[0]
    runs = -(-bh // fa.MAX_GRID_Y)
    out = {kind: {"shape": list(MANY_HEADS), "launches_a_call": runs,
                  "max_abs_err": {}} for kind in ("fwd", "dq", "dkv")}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(MANY_HEADS, generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        before = _flash_counts()
        o, lse = fa.flash_fwd(q, k, v, causal=True)
        delta = fa._delta(do, o)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True)
        torch.cuda.synchronize()
        moved = [a - b for a, b in zip(_flash_counts(), before)]
        if moved != [runs] * 3:
            fail(f"flash kernels at BH {bh} launched {moved}, want {runs} "
                 "each")
        o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, causal=True)
        dq_ref = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, causal=True)
        dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta,
                                              causal=True)
        label, dt = f"BH {bh}", str(dtype).replace("torch.", "")
        errs = {
            "fwd": max(_flash_close(f"K3 {label} O", o, o_ref, dtype),
                       _flash_close(f"K3 {label} lse", lse, lse_ref,
                                    torch.float32)),
            "dq": _flash_close(f"K4 {label} dQ", dq, dq_ref, dtype),
            "dkv": max(_flash_close(f"K5 {label} dK", dk, dk_ref, dtype),
                       _flash_close(f"K5 {label} dV", dv, dv_ref, dtype))}
        for kind, err in errs.items():
            out[kind]["max_abs_err"][dt] = err
        del q, k, v, do, o, lse, dq, dk, dv, o_ref, dq_ref, dk_ref, dv_ref
        torch.cuda.empty_cache()
    log(f"flash at BH {bh}: {json.dumps(out)}")
    return out


def _graph_nodes(t, limit: int = 4000) -> list[str]:
    """Names of the autograd nodes reachable from t's grad_fn; or, for a
    path, the nodes of a captured CUDA graph in its DOT dump
    (`_dumping_graphs`): each node's whole statement (its label spans
    lines, a kernel node's function name among them)."""
    if isinstance(t, str):
        with open(t) as f:
            statements = f.read().split("];")
        return [st.strip() for st in statements if "label=" in st][:limit]
    seen, todo, names = set(), [t.grad_fn], []
    while todo and len(names) < limit:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return names


# -- 4. serve -----------------------------------------------------------------

def _images(rng, n):
    return [rng.rand(227, 227, 3).astype(np.float32) for _ in range(n)]


def _check_rows(rows, n):
    if rows.shape != (n, 1000) or not np.all(np.isfinite(rows)):
        fail(f"served rows {rows.shape} not finite (n={n}, 1000)")
    if np.abs(rows.sum(axis=1) - 1.0).max() > 1e-4:
        fail("served softmax rows do not sum to 1")


def serve_phase(kernel: dict, card: str) -> dict:
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.ops.lrn import (lrn_across_channels,
                                             lrn_across_channels_bwd)
    from caffe_mpi_tpu_torch.proto import NetParameter
    from caffe_mpi_tpu_torch.serving import ServingEngine

    rng = np.random.RandomState(0)

    # main path: mixed bursts from several client threads
    with ServingEngine(device="cuda") as engine:
        model = engine.load_model("alexnet", MODEL, seed=0, **PREPROCESS)
        if model.fwd.ladder != (1, 4, 10):
            fail(f"ladder {model.fwd.ladder} != (1, 4, 10)")
        bursts = (1, 3, 10, 17, 1, 3, 10, 3)
        batches = [_images(rng, b) for b in bursts]
        lrn_across_channels.launches = 0
        lrn_across_channels_bwd.launches = 0
        with ThreadPoolExecutor(max_workers=4) as ex:
            futs = [ex.submit(engine.classify, "alexnet", imgs)
                    for imgs in batches]
            results = [f.result(timeout=600) for f in futs]
        engine.drain()
        launches = lrn_across_channels.launches
        if lrn_across_channels_bwd.launches:
            fail(f"serving launched the LRN backward "
                 f"{lrn_across_channels_bwd.launches} times")
        stats = engine.stats()
        for rows, b in zip(results, bursts):
            _check_rows(rows, b)
        if stats["requests"] != sum(bursts):
            fail(f"{stats['requests']} requests recorded, sent {sum(bursts)}")
        if launches == 0 or launches != 2 * stats["dispatches"]:
            fail(f"lrn kernel launched {launches} times for "
                 f"{stats['dispatches']} dispatched buckets (want 2 each)")
        kernel["launches_by_path"] = {"serve": launches}
        log(f"main path: {sum(bursts)} requests, {stats['dispatches']} "
            f"buckets, {launches} lrn launches")

        # parity: TF32 off through the prototxt's own math field, rows
        # served on the card against the port's Net forward on the CPU —
        # the softmax rows, and the fc8 logits (a copy of the net without
        # its Softmax layer): random weights leave the softmax rows nearly
        # uniform, so the logits are where a difference would show
        strict = NetParameter.from_file(MODEL)
        strict.default_forward_math = "FLOAT"
        logits = copy.deepcopy(strict)
        logits.layer = [lp for lp in logits.layer if lp.type != "Softmax"]
        tf32_logits = NetParameter.from_file(MODEL)
        tf32_logits.layer = [lp for lp in tf32_logits.layer
                             if lp.type != "Softmax"]
        images = _images(rng, 10)
        with ServingEngine(device="cuda") as eng2:
            par = {}
            for name, param in (("prob", strict), ("fc8", logits),
                                ("fc8_tf32", tf32_logits)):
                m2 = eng2.load_model(name, param, seed=0, **PREPROCESS)
                rows_in = np.stack([m2.preprocess(im) for im in images])
                cpu_net = Net(copy.deepcopy(param), device="cpu")
                cpu_net.import_weights(m2.fwd.net.export_weights())
                with torch.inference_mode():
                    ref = cpu_net({"data": torch.from_numpy(rows_in)})[0][
                        m2.fwd.out_blob()].numpy()
                served = eng2.classify(name, rows_in, preprocess=False)
                top2 = np.sort(ref, axis=1)[:, -2:]
                sure = (top2[:, 1] - top2[:, 0]) > 1e-4
                par[name] = {
                    "max_abs_diff": float(np.abs(served - ref).max()),
                    "ref_max_abs": float(np.abs(ref).max()),
                    "argmax_rows_checked": int(sure.sum()),
                    "argmax_equal": bool(np.all(
                        served.argmax(1)[sure] == ref.argmax(1)[sure])),
                }
        log(f"parity (TF32 off unless named): {json.dumps(par)}")
        for name in ("prob", "fc8"):
            if par[name]["max_abs_diff"] > 1e-4 or \
                    not par[name]["argmax_equal"]:
                fail(f"parity on {name}: {par[name]} (limit 1e-4)")

    # speed: the prototxt as written, closed-loop clients in mixed bursts
    with ServingEngine(device="cuda") as engine:
        model = engine.load_model("alexnet", MODEL, seed=0, **PREPROCESS)
        pool = _images(rng, 17)
        sizes = rng.choice([1, 3, 10, 17], size=(8, 40))

        def client(row):
            for b in row:
                _check_rows(engine.classify("alexnet", pool[:b]), b)

        with ThreadPoolExecutor(max_workers=8) as ex:
            for f in [ex.submit(client, row) for row in sizes]:
                f.result(timeout=900)
        engine.drain()
        st = engine.stats()
        # where a dispatch's time goes, measured apart from the traffic:
        # host preprocessing of one request; one bucket-10 forward of an
        # input already on the card, as device time (events, stream held
        # while the host enqueues) and as host wall time to completion
        t0 = time.perf_counter()
        for im in pool[:10]:
            model.preprocess(im)
        pre_ms = (time.perf_counter() - t0) * 1e3 / 10
        net10 = model.fwd.net_for(10)
        x10 = torch.zeros(net10.blob_shapes["data"], device="cuda")
        with torch.inference_mode():
            fwd_dev_ms = time_ms(lambda: net10({"data": x10}), reps=10,
                                 hold_ms=200.0)
            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                net10({"data": x10})
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        fwd_wall_ms = float(np.median(walls))
    serving = {
        "model": "models/alexnet/deploy.prototxt", "ladder": [1, 4, 10],
        "requests": st["requests"], "dispatches": st["dispatches"],
        "img_per_s": st["img_per_s"], "p50_ms": st["p50_ms"],
        "p99_ms": st["p99_ms"], "mean_bucket_fill": st["mean_bucket_fill"],
        "mean_queue_ms": st["mean_queue_ms"],
        "clients": 8, "window_ms": st["window_ms"],
        "preprocess_ms_per_image": pre_ms,
        "forward_device_ms_bucket10": fwd_dev_ms,
        "forward_wall_ms_bucket10": fwd_wall_ms,
        "parity": par, "main_path_lrn_launches": launches,
        "main_path_dispatches": stats["dispatches"], "card": card,
    }
    return serving


# -- 4b-4d. the serving plane over HTTP -----------------------------------------

HTTP_CLIENTS = 8
SERVE_BURSTS = (1, 3, 10, 17, 1, 3, 10, 3)  # the serve phase's bursts
SPEED_BURSTS = 30  # bursts a client in the speed run
# the bf16 engine's rows against the f32 engine's on the same uploads, in
# units of the rows' spread across uploads (the largest deviation of an
# f32 row from its column's mean over the uploads): with seeded weights
# much of each fc8 row is the same for every upload (fc6 and fc7 carry
# bias 0.1), so a share of the largest value would be loose against the
# part that depends on the input. The control, another upload's f32 row
# in the same units, must read above the limit. On an H100 the bf16 rows
# read 0.21 (softmax) and 0.052 (fc8) of the spread and the control 1.39
# (PERF.md, PR 12): the limit sits between them, 2.4x above the one and
# 2.8x below the other
BF16_SERVE_LIMIT = 0.5
# a graph replay against two eager forwards of the same bucket: within
# twice the eager runs' own distance, plus this floor (the chunk
# phase's rule)
GRAPH_SPREAD, GRAPH_FLOOR = 2.0, 1e-6
UPLOAD_SIZES = ((227, 227), (256, 256), (240, 320), (300, 200))


def _uploads(seed, n):
    """n seeded uploads, PNG and JPEG (quality 90) in turn, at sizes around
    AlexNet's 227 (each is resized to the net's input): smooth cluster
    images with noise, as the lmdb phase draws them."""
    import io

    from PIL import Image
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = UPLOAD_SIZES[i % len(UPLOAD_SIZES)]
        base = rng.randint(0, 256, (1, 1, 3)).astype(np.int16)
        img = np.clip(base + rng.randint(-40, 41, (h, w, 3)), 0,
                      255).astype(np.uint8)
        buf = io.BytesIO()
        if i % 2:
            Image.fromarray(img).save(buf, format="JPEG", quality=90)
        else:
            Image.fromarray(img).save(buf, format="PNG")
        out.append(buf.getvalue())
    return out


def _serve_engine(dtype="f32", **kw):
    from caffe_mpi_tpu_torch.proto.config import ServingParameter
    from caffe_mpi_tpu_torch.serving import ServingEngine
    return ServingEngine(ServingParameter(serve_dtype=dtype), device="cuda",
                         **kw)


def _start_server(engine, name):
    import threading

    from caffe_mpi_tpu_torch.serving.http_front import make_server
    srv = make_server(engine, name, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop_server(srv) -> None:
    srv.shutdown()
    srv.server_close()


def _get(url):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _http_clients(url, uploads, sizes):
    """HTTP clients: each row of `sizes` is one closed-loop client thread
    posting its bursts, each burst's uploads at once. Returns each
    request's (status, negated unless a 200 with 5 predictions; wall ms
    from the POST to the parsed answer). The speed run runs it in a
    process of its own, so that the clients' Python does not share the
    server's interpreter."""
    from caffe_mpi_tpu_torch.tools.cli import post_image

    def one(d):
        t0 = time.perf_counter()
        code, body = post_image(url + "/classify", d)
        ok = code == 200 and len(body.get("predictions", ())) == 5
        return (code if ok else -code), (time.perf_counter() - t0) * 1e3

    def client(row):
        got = []
        for b in row:
            with ThreadPoolExecutor(max_workers=int(b)) as ex:
                got += list(ex.map(one, uploads[:int(b)]))
        return got

    with ThreadPoolExecutor(max_workers=len(sizes)) as ex:
        return [a for part in ex.map(client, sizes) for a in part]


_CLIENTS: list = []  # the clients' process of the HTTP speed runs


def _client_pool():
    """The process the HTTP speed runs' clients run in, so that their
    Python shares no interpreter with the server's: spawned once, on first
    use (the fleet phase's, beside the build), and shut down by main."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    if not _CLIENTS:
        _CLIENTS.append(ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")))
    return _CLIENTS[0]


def _strict_params():
    """(softmax rows, fc8 logits) prototxts with TF32 off through the
    prototxt's own math field, as the serve phase's parity."""
    from caffe_mpi_tpu_torch.proto import NetParameter
    strict = NetParameter.from_file(MODEL)
    strict.default_forward_math = "FLOAT"
    logits = copy.deepcopy(strict)
    logits.layer = [lp for lp in logits.layer if lp.type != "Softmax"]
    return strict, logits


def _rows_by_bytes(engine, name, uploads):
    """Full score rows of the uploads through the library spelling of the
    HTTP path (decode, deferred fused preprocess, a graph replay)."""
    futs = [engine.submit_bytes(name, d) for d in uploads]
    return np.stack([f.result(timeout=300) for f in futs])


def _graph_vs_eager(model, rng) -> dict:
    """Each bucket's graph replay against two eager forwards of its net on
    the same rows: the replay's distance from the nearer eager run, as a
    share of the largest eager value, within GRAPH_SPREAD x the eager
    runs' own distance + GRAPH_FLOOR."""
    fwd = model.fwd
    out = {}
    for b in fwd.ladder:
        x = np.stack([model.preprocess(im) for im in _images(rng, b)])
        g = fwd.to_host(fwd.run_bucket(x))
        e1 = fwd.to_host(fwd.run_bucket(x, eager=True))
        e2 = fwd.to_host(fwd.run_bucket(x, eager=True))
        scale = max(float(np.abs(e1).max()), 1e-30)
        spread = float(np.abs(e2 - e1).max()) / scale
        diff = min(float(np.abs(g - e).max()) for e in (e1, e2)) / scale
        limit = GRAPH_SPREAD * spread + GRAPH_FLOOR
        out[str(b)] = {"diff": diff, "spread": spread, "limit": limit}
        if diff > limit:
            fail(f"graph replay of bucket {b} ({fwd.dtype}) is {diff:.3g} "
                 f"from the eager forward (limit {limit:.3g})")
    return out


def _bucket10_times(model, rng) -> dict:
    """Where a dispatch's time goes at bucket 10: device time of a graph
    replay (events, the stream held while the host enqueues), and host
    wall time of a dispatch, padded rows to scores on the host."""
    x10 = np.stack([model.preprocess(im) for im in _images(rng, 10)])
    fwd = model.fwd
    g10 = fwd._graphs[10]
    with torch.cuda.stream(fwd.stream):
        dev = time_ms(g10.graph.replay, reps=10, hold_ms=200.0)
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        _, done = fwd.run_bucket_to_host(x10)
        done.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"replay_device_ms_bucket10": dev,
            "dispatch_wall_ms_bucket10": float(np.median(walls))}


def _http_traffic(engine, name, k1, k2, path, uploads):
    """The main path over HTTP: SERVE_BURSTS from HTTP_CLIENTS threads,
    the launch counts set to 0 just before and read just after."""
    srv, url = _start_server(engine, name)
    try:
        d0 = engine.stats()["dispatches"]
        _reset_kernel_counts()
        answers = _http_clients(url, uploads, [[b] for b in SERVE_BURSTS])
        engine.drain()
        counts = _kernel_counts()
        bad = [c for c, _ in answers if c != 200]
        if bad:
            fail(f"{path} main path: {len(bad)} of {len(answers)} "
                 f"requests failed, e.g. status {-bad[0]}")
        st = engine.stats()
        code, ready = _get(url + "/readyz")
        code_h, health = _get(url + "/healthz")
    finally:
        _stop_server(srv)
    dispatches = st["dispatches"] - d0
    if counts[1] or any(counts[2:]):
        fail(f"{path}: launched K2-K5 {counts[1:]} (inference runs K1 only)")
    if counts[0] == 0 or counts[0] != 2 * dispatches:
        fail(f"{path}: K1 launched {counts[0]} times for {dispatches} "
             "dispatched buckets (want 2 a bucket)")
    if code != 200 or not ready["ready"] or code_h != 200 \
            or ready["compile_count"] != ready["warmed_buckets"] \
            or ready["recaptures"]:
        fail(f"{path}: /readyz {code} {ready}, /healthz {code_h}")
    k1["launches_by_path"][path] = counts[0]
    k2.setdefault("launches_by_path", {})[path] = counts[1]
    return counts[0], dispatches, st


def serve_http_phase(k1: dict, k2: dict, card: str) -> dict:
    """AlexNet at full width over HTTP in f32 and in bf16 (ladder 1, 4, 10,
    a CUDA graph a bucket): the main path, graph-against-eager, rows
    against the port's Net (f32, TF32 off) and against the f32 engine
    (bf16), and a speed run."""
    from caffe_mpi_tpu_torch import native
    from caffe_mpi_tpu_torch.data.decode import to_float_image
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.tools.cli import post_image

    rng = np.random.RandomState(3)
    uploads = _uploads(3, 17)
    parity_uploads = _uploads(4, 10)
    strict, logits = _strict_params()
    out = {"card": card, "ladder": [1, 4, 10], "clients": HTTP_CLIENTS,
           "codecs_native": native.decode_available()}
    rows = {}
    for dtype in ("f32", "bf16"):
        res = {}
        with _serve_engine(dtype) as engine:
            t0 = time.perf_counter()
            with _LaunchDtypes() as probe:  # the warm forwards and captures
                model = engine.load_model("alexnet", MODEL, seed=0,
                                          **PREPROCESS)
            res["load_ms"] = (time.perf_counter() - t0) * 1e3
            res["launch_dtypes"] = probe.dtypes()
            # every bucket net computes its convolutions, products and
            # LRNs in the engine's dtype, and K1 was captured in it
            want = "bfloat16" if dtype == "bf16" else "float32"
            fwd = {str(l.policy.forward).replace("torch.", "")
                   for b in model.fwd.ladder
                   for l in model.fwd.net_for(b).layers
                   if l.lp.type in ("Convolution", "InnerProduct", "LRN")}
            if fwd != {want} or res["launch_dtypes"] != {"lrn_fwd": [want]}:
                fail(f"serve_http_{dtype}: bucket nets forward in {fwd}, "
                     f"kernels captured in {res['launch_dtypes']}, want "
                     f"{want}")
            if model.fwd.ladder != (1, 4, 10):
                fail(f"ladder {model.fwd.ladder} != (1, 4, 10)")
            res["warm"] = model.fwd.warm_events
            path = f"serve_http_{dtype}"
            from caffe_mpi_tpu_torch.data import decode as decode_mod
            decode_mod.STATS.reset()  # this engine's decodes only
            launches, dispatches, st = _http_traffic(
                engine, "alexnet", k1, k2, path, uploads)
            ing = st["ingest"]
            n = sum(SERVE_BURSTS)
            if st["requests"] != n or ing["deferred_rows"] != n \
                    or ing["fused_rows"] != n:
                fail(f"{path}: {st['requests']} requests, deferred "
                     f"{ing['deferred_rows']}, fused {ing['fused_rows']} "
                     f"(sent {n}): the window-fused preprocess did not "
                     "engage")
            plane = ing["decode_plane"]
            if not out["codecs_native"] and plane["pil_records"] < n:
                fail(f"{path}: {plane['pil_records']} PIL decodes for {n} "
                     "requests on a build without the codecs")
            res.update({"main_path_requests": n,
                        "main_path_dispatches": dispatches,
                        "main_path_k1_launches": launches,
                        "decode_plane": plane,
                        "compile_count": st["compile_count"],
                        "warmed_buckets": st["warmed_buckets"]})
            res["graph_vs_eager"] = _graph_vs_eager(model, rng)
            # parity models on the same engine: the softmax rows and the
            # fc8 logits, TF32 off
            ref_rows = {}
            for name, param in (("prob", strict), ("fc8", logits)):
                m2 = engine.load_model(name, param, seed=0, **PREPROCESS)
                rows[dtype, name] = _rows_by_bytes(engine, name,
                                                   parity_uploads)
                if dtype == "f32":
                    x = np.stack([m2.preprocess(to_float_image(
                        engine.decode_request(d))) for d in parity_uploads])
                    net = Net(copy.deepcopy(param), device="cuda")
                    net.import_weights(m2.fwd.net.export_weights())
                    with torch.inference_mode():
                        ref = net({"data": torch.from_numpy(x).cuda()})[0][
                            m2.fwd.out_blob()].float().cpu().numpy()
                    del net
                    ref_rows[name] = ref
                    diff = float(np.abs(rows[dtype, name] - ref).max())
                    res[f"{name}_max_abs_diff_vs_net"] = diff
                    if diff > 1e-4:
                        fail(f"{path}: {name} rows {diff:.3g} from the "
                             "port Net on the card (limit 1e-4)")
            if dtype == "f32":
                # the HTTP bodies of the same uploads: top-5 fc8 scores
                srv, url = _start_server(engine, "fc8")
                try:
                    bodies = [post_image(url + "/classify", d)
                              for d in parity_uploads]
                finally:
                    _stop_server(srv)
                worst = 0.0
                for (code, body), ref in zip(bodies, ref_rows["fc8"]):
                    if code != 200:
                        fail(f"{path}: fc8 upload answered {code} {body}")
                    for p in body["predictions"]:
                        worst = max(worst, abs(p["score"]
                                               - float(ref[p["label"]])))
                    top = sorted(ref, reverse=True)[:5]
                    got = [p["score"] for p in body["predictions"]]
                    if np.abs(np.array(got) - np.array(top)).max() > 1e-4:
                        fail(f"{path}: HTTP top-5 {got} != Net {top}")
                res["http_top5_max_abs_diff_vs_net"] = worst
            # speed: closed-loop clients over HTTP in mixed bursts
            engine.ingest.preprocess_s = 0.0
            before = engine.stats()
            sizes = rng.choice([1, 3, 10, 17],
                               size=(HTTP_CLIENTS, SPEED_BURSTS))
            srv, url = _start_server(engine, "alexnet")
            with engine._batcher._rec_lock:  # the speed run's records only
                engine._batcher._records.clear()
                engine._batcher.dispatches.clear()
            try:
                got = _client_pool().submit(
                    _http_clients, url, uploads,
                    sizes.tolist()).result(timeout=900)
            finally:
                _stop_server(srv)
            engine.drain()
            bad = [c for c, _ in got if c != 200]
            if bad:
                fail(f"{path} speed: {len(bad)} of {len(got)} requests "
                     f"failed, e.g. status {-bad[0]}")
            http_ms = np.sort([ms for _, ms in got])
            res["http_p50_ms"] = float(np.percentile(http_ms, 50))
            res["http_p99_ms"] = float(np.percentile(http_ms, 99))
            # a connect retried after a lost SYN waits 1 s: this share
            # tells that tail from a slow server
            res["http_over_1s_share"] = float(np.mean(http_ms >= 1000.0))
            st = engine.stats()
            ing = st["ingest"]
            rows_pre = ing["fused_rows"] + ing["fused_fallback_rows"] \
                - before["ingest"]["fused_rows"] \
                - before["ingest"]["fused_fallback_rows"]
            res.update({
                "requests": st["requests"], "img_per_s": st["img_per_s"],
                "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
                "mean_bucket_fill": st["mean_bucket_fill"],
                "mean_queue_ms": st["mean_queue_ms"],
                "window_ms": st["window_ms"],
                "preprocess_ms_per_row": ing["preprocess_ms"]
                / max(rows_pre, 1),
                "decode_ms_per_request": ing["decode_ms"]
                / max(ing["requests"], 1),
                "graph_replays": st["graph_replays"],
                "compile_count_equals_warmed_buckets":
                    st["compile_count"] == st["warmed_buckets"],
            })
            if not res["compile_count_equals_warmed_buckets"] \
                    or st["recaptures"]:
                fail(f"{path}: a bucket was built after warm-up: {st}")
            res.update(_bucket10_times(model, rng))
        out[dtype] = res
        torch.cuda.empty_cache()
    # bf16 against f32 on the same uploads, in units of the f32 rows'
    # spread across uploads
    cmp = {}
    for name in ("prob", "fc8"):
        ref, got = rows["f32", name], rows["bf16", name]
        dev = ref - ref.mean(0)
        spread = float(np.abs(dev).max())
        diff = float(np.abs(got - ref).max())
        cmp[name] = {
            "max_abs_diff": diff, "spread": spread,
            "diff_over_spread": diff / spread,
            "deviation_diff_over_spread": float(np.abs(
                got - got.mean(0) - dev).max()) / spread,
            "control_over_spread": float(np.abs(
                np.roll(ref, 1, 0) - ref).max()) / spread,
            "diff_over_largest": diff / float(np.abs(ref).max()),
            "argmax_equal_share": float(np.mean(
                got.argmax(1) == ref.argmax(1))),
            "limit": BF16_SERVE_LIMIT}
    log(f"serve_http bf16 vs f32: {json.dumps(cmp)}")
    for name, c in cmp.items():
        if not np.all(np.isfinite(rows["bf16", name])) \
                or not 0 < c["diff_over_spread"] <= BF16_SERVE_LIMIT \
                or c["control_over_spread"] <= BF16_SERVE_LIMIT:
            fail(f"bf16 {name} rows {c['max_abs_diff']:.3g} from the f32 "
                 f"rows, {c['diff_over_spread']:.3g} of their spread "
                 f"across uploads (limit {BF16_SERVE_LIMIT}, above 0; "
                 f"another upload's row: {c['control_over_spread']:.3g})")
    out["bf16_vs_f32"] = cmp
    log(f"serve_http: {json.dumps(out)}")
    return out


def residency_phase(k1: dict, k2: dict, card: str) -> dict:
    """AlexNet and GoogLeNet on one engine under a serve_hbm_mb below the
    sum of their param_bytes, alternating traffic: spills, reloads and
    recaptures counted, device memory falling at a spill, rows after a
    reload bitwise the rows before."""
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.proto import NetParameter
    from caffe_mpi_tpu_torch.serving.plan import rewrite_batch
    goog = os.path.join(ROOT, "models", "googlenet", "deploy.prototxt")
    # each net's parameter bytes, counted on an uninitialised CPU net (no
    # BatchNorm state in either); the engine's own count must agree
    sizes = {name: sum(p.numel() * p.element_size() for p in Net(
        rewrite_batch(NetParameter.from_file(path), 1), phase="TEST",
        device="cpu").parameters())
        for name, path in (("alexnet", MODEL), ("googlenet", goog))}
    budget_mb = (max(sizes.values()) + min(sizes.values()) / 2) / 2**20
    rng = np.random.RandomState(5)
    x = {"alexnet": (rng.rand(4, 3, 227, 227) * 255 - 117).astype(
        np.float32),
        "googlenet": (rng.rand(4, 3, 224, 224) * 255 - 117).astype(
            np.float32)}
    seen: dict[str, list] = {"alexnet": [], "googlenet": []}
    fall = []
    with _serve_engine(hbm_mb=budget_mb, window_ms=0) as engine:
        alex = engine.load_model("alexnet", MODEL, seed=0, **PREPROCESS)
        spill = alex.spill

        def measured_spill():
            # the device memory an AlexNet spill gives back
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            spill()
            torch.cuda.synchronize()
            fall.append(before - torch.cuda.memory_allocated())

        alex.spill = measured_spill
        engine.load_model("googlenet", goog, seed=0, **PREPROCESS)
        _reset_kernel_counts()
        for _ in range(3):
            for name in ("alexnet", "googlenet"):
                seen[name].append(engine.classify(name, x[name],
                                                  preprocess=False))
        engine.drain()
        counts = _kernel_counts()
        st = engine.stats()
        ready, doc = engine.ready()
        resident = {n: engine.model(n).resident for n in engine.models}
        charged = {n: engine.model(n).param_bytes for n in engine.models}
    if charged != sizes:
        fail(f"residency: the engine charges {charged} bytes, the nets "
             f"hold {sizes}")
    if not (st["spills"] > 0 and st["reloads"] > 0):
        fail(f"residency: spills {st['spills']}, reloads {st['reloads']}")
    if st["recaptures"] != 3 * st["reloads"] or not ready:
        fail(f"residency: {st['recaptures']} recaptures for "
             f"{st['reloads']} reloads of 3 buckets; readyz {doc}")
    for name, runs in seen.items():
        for r in runs[1:]:
            if not np.array_equal(r, runs[0]):
                fail(f"residency: {name} rows after a reload differ from "
                     "the rows before")
    if not fall or min(fall) < sizes["alexnet"]:
        fail(f"residency: device memory fell by {fall} bytes at AlexNet's "
             f"spills (its params: {sizes['alexnet']} bytes)")
    if counts[0] == 0 or counts[1] or any(counts[2:]):
        fail(f"residency: K1-K5 launches {counts}")
    k1["launches_by_path"]["serve_residency"] = counts[0]
    k2.setdefault("launches_by_path", {})["serve_residency"] = counts[1]
    out = {"param_bytes": sizes, "budget_mb": budget_mb,
           "spills": st["spills"], "reloads": st["reloads"],
           "recaptures": st["recaptures"],
           "compile_count": st["compile_count"],
           "warmed_buckets": st["warmed_buckets"],
           "memory_fall_at_spill_bytes": fall, "resident_at_end": resident,
           "admission": st["plan"]["admission"], "k1_launches": counts[0],
           "card": card}
    log(f"residency: {json.dumps(out)}")
    return out


def resilience_phase(k1: dict, k2: dict, card: str) -> dict:
    """The stall breaker over HTTP (504 in flight, /healthz 503, a typed
    503, recovery to 200), a deadline (504), the queue limit (429), and a
    hot swap from a caffemodel the port writes (rows follow the new
    weights, a poisoned canary is rejected, no capture)."""
    import threading

    from caffe_mpi_tpu_torch import io as port_io
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.proto import NetParameter
    from caffe_mpi_tpu_torch.serving import SwapError
    from caffe_mpi_tpu_torch.tools.cli import post_image
    from caffe_mpi_tpu_torch.utils import resilience

    FAULTS = resilience.FAULTS
    up = _uploads(8, 4)
    out = {"card": card}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    _reset_kernel_counts()
    try:
        # the stall breaker
        prefix = os.path.join(tmp, "alexnet")
        FAULTS.configure("serve_dispatch_stall:1:0:3")
        with _serve_engine(stall_s=1.0, window_ms=0,
                           journal=prefix) as engine:
            engine.load_model("alexnet", MODEL, seed=0, **PREPROCESS)
            srv, url = _start_server(engine, "alexnet")
            try:
                got = [post_image(url + "/classify", up[0])]
                got.append(_get(url + "/healthz"))
                got.append(post_image(url + "/classify", up[1]))
                trip = resilience.read_run_manifest(prefix + ".serve")
                engine.drain(timeout=30)
                recovered = engine.probe_recovery(timeout=10)
                got.append(_get(url + "/healthz"))
                got.append(post_image(url + "/classify", up[2]))
                back = resilience.read_run_manifest(prefix + ".serve")
            finally:
                _stop_server(srv)
        codes = [(c, b.get("kind") or b.get("breaker", {}).get("state")
                  or ("ok" if "predictions" in b else b)) for c, b in got]
        want = [(504, "deadline"), (503, "open"), (503, "unhealthy"),
                (200, "closed"), (200, "ok")]
        if codes != want or not recovered \
                or trip["reason"] != "serve_stall:dispatch:alexnet" \
                or back["reason"] != "serve_recovered":
            fail(f"resilience: stall breaker answered {codes} (want {want})"
                 f", recovered {recovered}, journal {trip} {back}")
        out["breaker"] = {"answers": codes, "journal": [trip["reason"],
                                                        back["reason"]]}
        # the deadline
        FAULTS.configure("serve_dispatch_stall:1:0:1")
        with _serve_engine(deadline_ms=200, window_ms=0) as engine:
            engine.load_model("alexnet", MODEL, seed=0, **PREPROCESS)
            srv, url = _start_server(engine, "alexnet")
            try:
                first = []
                t = threading.Thread(target=lambda: first.append(
                    post_image(url + "/classify", up[0])))
                t.start()
                for _ in range(500):
                    if engine._batcher._inflight:
                        break
                    time.sleep(0.01)
                late = post_image(url + "/classify", up[1])
                t.join(timeout=60)
            finally:
                _stop_server(srv)
            dl = engine.stats()["deadline_failures"]
        if late[0] != 504 or late[1].get("kind") != "deadline" \
                or first[0][0] != 200 or dl != 1:
            fail(f"resilience: deadline answered {late}, first {first}, "
                 f"{dl} deadline failures")
        out["deadline"] = {"answer": [late[0], late[1]["kind"]],
                           "deadline_failures": dl}
        FAULTS.configure("")
        # the queue limit
        with _serve_engine(queue_limit=2, window_ms=600_000) as engine:
            engine.load_model("alexnet", MODEL, seed=0, **PREPROCESS)
            srv, url = _start_server(engine, "alexnet")
            try:
                parked = []
                threads = [threading.Thread(target=lambda d=d: parked.append(
                    post_image(url + "/classify", d))) for d in up[:2]]
                for t in threads:
                    t.start()
                for _ in range(500):
                    if len(engine._batcher._pending) == 2:
                        break
                    time.sleep(0.01)
                shed = post_image(url + "/classify", up[2])
                engine.shutdown()  # flushes the window: both answer
                for t in threads:
                    t.join(timeout=60)
            finally:
                _stop_server(srv)
        if shed[0] != 429 or shed[1].get("kind") != "shed" \
                or sorted(c for c, _ in parked) != [200, 200]:
            fail(f"resilience: queue limit answered {shed}, parked "
                 f"{[c for c, _ in parked]}")
        out["queue_limit"] = {"answer": [shed[0], shed[1]["kind"]],
                              "parked": [c for c, _ in parked]}
        # the hot swap
        new = os.path.join(tmp, "alexnet_seed1.caffemodel")
        net = Net(NetParameter.from_file(MODEL), device="cpu")
        net.init(1)
        port_io.save_caffemodel(new, net.export_weights())
        del net
        rng = np.random.RandomState(9)
        with _serve_engine(window_ms=0) as engine:
            model = engine.load_model("alexnet", MODEL, seed=0,
                                      **PREPROCESS)
            x = np.stack([model.preprocess(im) for im in _images(rng, 4)])
            before = engine.classify("alexnet", x, preprocess=False)
            builds = engine.compile_count
            engine.swap_weights("alexnet", new)
            after = engine.classify("alexnet", x, preprocess=False)
            swapped_builds = engine.compile_count
            FAULTS.configure("swap_canary_bad:1")
            try:
                engine.swap_weights("alexnet", new)
                rejected = False
            except SwapError:
                rejected = True
            FAULTS.configure("")
            kept = engine.classify("alexnet", x, preprocess=False)
            engine.load_model("ref", MODEL, new, **PREPROCESS)
            ref = engine.classify("ref", x, preprocess=False)
            st = engine.stats()
        scale = float(np.abs(ref).max())
        diff = float(np.abs(after - ref).max()) / scale
        moved = float(np.abs(after - before).max()) / scale
        if not rejected or not np.array_equal(kept, after) \
                or swapped_builds != builds or diff > GRAPH_FLOOR \
                or moved < 10 * GRAPH_FLOOR or st["swaps"] != 1 \
                or st["swap_rejections"] != 1:
            fail(f"resilience: swap rejected {rejected}, kept bitwise "
                 f"{np.array_equal(kept, after)}, builds {builds} -> "
                 f"{swapped_builds}, rows {diff:.3g} from the new weights' "
                 f"(moved {moved:.3g}), stats {st['swaps']} "
                 f"{st['swap_rejections']}")
        out["swap"] = {"rel_diff_vs_new_weights": diff,
                       "rel_move": moved, "builds_across_swap":
                       swapped_builds - builds, "canary_rejected": rejected}
    finally:
        FAULTS.configure("")
        shutil.rmtree(tmp, ignore_errors=True)
    counts = _kernel_counts()
    if counts[0] == 0 or counts[1] or any(counts[2:]):
        fail(f"resilience: K1-K5 launches {counts}")
    k1["launches_by_path"]["serve_resilience"] = counts[0]
    k2.setdefault("launches_by_path", {})["serve_resilience"] = counts[1]
    out["k1_launches"] = counts[0]
    log(f"resilience: {json.dumps(out)}")
    return out


# -- 5. train -----------------------------------------------------------------

def _state(solver) -> dict:
    """Every owned parameter, history slot and state buffer (running
    statistics) of a solver, on the host."""
    out = {}
    for lname, pname, _, p in solver._decls:
        out[f"{lname}.{pname}"] = p.detach().cpu().clone()
        for i, h in enumerate(solver.history[(lname, pname)]):
            out[f"{lname}.{pname}.h{i}"] = h.cpu().clone()
    for lname, sname, buf in solver.net.state_buffers():
        out[f"{lname}.{sname}"] = buf.cpu().clone()
    return out


def train_phase(k1: dict, k2: dict, card: str) -> dict:
    from caffe_mpi_tpu_torch.ops.lrn import (lrn_across_channels,
                                             lrn_across_channels_bwd)
    from caffe_mpi_tpu_torch.tools import cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        prefix = os.path.join(tmp, "alexnet")
        argv = ["train", "-solver", SOLVER, "-synthetic",
                "-test_iter", str(TEST_ITER), "-snapshot_prefix", prefix,
                "-device", "cuda"]
        torch.cuda.reset_peak_memory_stats()
        lrn_across_channels.launches = 0
        lrn_across_channels_bwd.launches = 0
        solver, summary = cli.train(cli.parse_args(
            argv + ["-max_iter", str(TRAIN_ITERS)]))
        torch.cuda.synchronize()
        n_fwd, n_bwd = (lrn_across_channels.launches,
                        lrn_across_channels_bwd.launches)
        losses = summary["losses"]
        log(f"train: {json.dumps(summary)}")
        if summary["batch"] != 256 or len(losses) != TRAIN_ITERS:
            fail(f"train ran {len(losses)} iterations at batch "
                 f"{summary['batch']}, want {TRAIN_ITERS} at 256")
        if not np.all(np.isfinite(losses)):
            fail(f"train losses not all finite: {losses}")
        # forwards: every iteration, plus TEST_ITER test batches at
        # iteration 0 (test_initialization) and in the final test pass
        forwards = TRAIN_ITERS + 2 * TEST_ITER
        if n_bwd != 2 * TRAIN_ITERS or n_fwd != 2 * forwards:
            fail(f"K1 launched {n_fwd} times (want {2 * forwards}), K2 "
                 f"{n_bwd} times (want {2 * TRAIN_ITERS})")
        k1["launches"], k2["launches"] = n_fwd, n_bwd
        k1["launches_by_path"]["train"] = n_fwd
        k2.setdefault("launches_by_path", {})["train"] = n_bwd
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = _state(solver)
        feeds = cli.synthetic_feed(solver.net)
        profile = profile_steps(solver, lambda it: feeds)
        log(f"train profile: {json.dumps(profile)}")
        del feeds

        # resume the snapshot through the same entry point: weights and
        # history come back bitwise, and one more step runs
        del solver
        resumed, again = cli.train(cli.parse_args(
            argv + ["-max_iter", str(TRAIN_ITERS + 1), "-snapshot",
                    summary["snapshot"]]))
        if again["start_iter"] != TRAIN_ITERS or again["iters"] != 1 or \
                not np.isfinite(again["losses"][0]):
            fail(f"resume: {again}")
        # the resumed solver has stepped on; restore the snapshot once more
        # to hold it against the trained state
        from caffe_mpi_tpu_torch.solver import Solver
        check = Solver(resumed.sp, model_dir=resumed.model_dir,
                       device="cuda")
        check.restore(summary["snapshot"])
        resumed_state = _state(check)
        bad = [k for k in want if not torch.equal(want[k], resumed_state[k])]
        if bad:
            fail(f"restored state differs from the trained one: {bad[:5]}")
        del resumed, check
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {
        "solver": "models/alexnet/solver.prototxt", "batch": 256,
        "iters": TRAIN_ITERS, "losses": losses,
        "median_step_ms": summary["median_iter_ms"],
        "img_per_s": summary["img_per_s"],
        "step_ms": summary["iter_ms"],
        "test_scores": summary["test_scores"],
        "lrn_fwd_launches": n_fwd, "lrn_bwd_launches": n_bwd,
        "resumed_loss": again["losses"][0], "peak_mem_GB": peak_gb,
        "profile": profile,
        "device_busy": profile["device_ms_per_step"]
        / summary["median_iter_ms"]
        if isinstance(profile["device_ms_per_step"], float) else None,
        "card": card,
    }


def profile_steps(solver, feed_fn, n: int = 3,
                  ours=("lrn_fwd_kernel", "lrn_bwd_kernel"),
                  groups=None) -> dict:
    """Where a training step's device time goes: `n` more iterations under
    torch.profiler, device time summed by kernel and by the aten op that
    launched it, beside the steps' wall time under the profiler (which
    slows the host). `groups` {group: aten op names}: the device time a
    step of those ops (each op's inclusive device time: name leaf ops
    only), and "other", the rest of the device time. If the profiler sees
    no device time, the breakdown is reported as not measured."""
    from torch.profiler import ProfilerActivity, profile

    def dev(evt, self_only):
        for name in (("self_device_time_total", "self_cuda_time_total")
                     if self_only else ("device_time_total",
                                        "cuda_time_total")):
            if hasattr(evt, name):
                return float(getattr(evt, name))
        return 0.0

    solver.step(1, feed_fn)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.step(n, feed_fn)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted(((dev(e, True) / 1e3 / n, e.key) for e in events
                      if str(e.device_type).endswith("CUDA")),
                     reverse=True)
    device_ms = sum(ms for ms, _ in kernels)
    if device_ms == 0.0:
        return {"wall_ms_per_step": wall_ms / n,
                "device_ms_per_step": "not measured"}
    ops = sorted(((dev(e, False) / 1e3 / n, e.key) for e in events
                  if e.key.startswith("aten::") and dev(e, False) > 0),
                 reverse=True)
    split = None
    if groups:
        by_op = {e.key: dev(e, False) / 1e3 / n for e in events}
        split = {g: sum(by_op.get(op, 0.0) for op in ops)
                 for g, ops in groups.items()}
        split["other"] = device_ms - sum(split.values())
    return {
        "wall_ms_per_step": wall_ms / n, "device_ms_per_step": device_ms,
        "device_busy_profiled": device_ms / (wall_ms / n),
        "groups_ms_per_step": split,
        "ours_ms_per_step": {k: sum(ms for ms, name in kernels
                                    if k in name) for k in ours},
        "top_kernels_ms": [[round(ms, 4), name[:90]]
                           for ms, name in kernels[:15]],
        "top_aten_ops_ms": [[round(ms, 4), name] for ms, name in ops[:15]],
    }


# -- 6. parity ----------------------------------------------------------------

PARITY_BATCH = 16


def _parity_solver_param():
    """models/alexnet/solver.prototxt with its net inline, the Input dims
    cut to PARITY_BATCH, TF32 off through default_forward_math: FLOAT, and
    no test net."""
    from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
    sp = SolverParameter.from_file(SOLVER)
    net = NetParameter.from_file(os.path.join(ROOT, sp.net))
    net.default_forward_math = "FLOAT"
    for lp in net.layer:
        if lp.type == "Input":
            for shape in lp.input_param.shape:
                shape.dim[0] = PARITY_BATCH
    sp.net, sp.net_param = "", net
    sp.test_iter, sp.test_interval = [], 0
    return sp


# gradient limits, as a share of the largest element: layers above
# AlexNet's last max pool (fc6-fc8) against those at or below it (conv1-5),
# whose gradients pass through a max pool's backward: it sends each
# window's gradient to the window's arg-max, and near-ties flip under any
# change of summation order (a one-rounding change of the CPU's own input
# moves them by ~1e-3, reported as grad_cpu_perturbed)
GRAD_LIMIT = {"fc": 1e-4, "conv": 2e-2}


def parity_phase() -> dict:
    """One SGD step on the card against the CPU, TF32 off: the loss within
    1e-5 of its size; each parameter's gradient within GRAD_LIMIT of its
    largest element; each updated parameter within base_lr x lr_mult x
    that limit x the gradient's largest element, plus two f32 ulps of the
    largest weight (the update is a step of lr x gradient, rounded into
    the weight)."""
    from caffe_mpi_tpu_torch.core.types import DtypePolicy
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.tools import cli

    def one_step(device, feeds_cpu, tf32_backward=False):
        solver = Solver(_parity_solver_param(), device=device)
        if tf32_backward:
            solver._math = DtypePolicy(precision="default")
        feeds = {k: v.to(device) for k, v in feeds_cpu.items()}
        masks = {k: v.to(device) for k, v in masks_cpu.items()}
        w0 = {f"{l}.{p}": t.detach().cpu().clone()
              for l, p, _, t in solver._decls}
        solver.step(1, lambda it: feeds, dropout_masks=lambda it, m: masks)
        out = {"loss": solver.losses[0], "w0": w0, "grad": {}, "w": {},
               "lr_mult": {}}
        for l, p, decl, t in solver._decls:
            key = f"{l}.{p}"
            out["w"][key] = t.detach().cpu()
            out["grad"][key] = t.grad.detach().cpu()
            out["lr_mult"][key] = decl.lr_mult
        return out

    probe = Solver(_parity_solver_param(), device="cpu")
    base_lr = probe.sp.base_lr
    feeds = cli.synthetic_feed(probe.net, seed=0)
    gen = torch.Generator().manual_seed(0)
    masks_cpu = {layer.name: torch.rand(
        probe.net.blob_shapes[layer.lp.bottom[0]], generator=gen) < 0.5
        for layer in probe.net.layers if layer.lp.type == "Dropout"}
    del probe
    perturbed = dict(feeds)
    perturbed["data"] = feeds["data"] * (1 + 1e-7 * torch.randn(
        feeds["data"].shape, generator=torch.Generator().manual_seed(1)))
    cpu = one_step("cpu", feeds)
    cpu_pert = one_step("cpu", perturbed)
    card = one_step("cuda", feeds)
    if any(not torch.equal(cpu["w0"][k], card["w0"][k]) for k in cpu["w0"]):
        fail("card and CPU solvers did not start from the same weights")
    tf32 = one_step("cuda", feeds, tf32_backward=True)

    def grad_rel(run, key):
        ref = cpu["grad"][key]
        return float((run["grad"][key] - ref).abs().max()) \
            / float(ref.abs().max())

    def w_diff(run, key):
        return float((run["w"][key] - cpu["w"][key]).abs().max())

    params, bad = {}, []
    eps = torch.finfo(torch.float32).eps
    for key in cpu["grad"]:
        limit = GRAD_LIMIT["fc" if key.startswith("fc") else "conv"]
        w_limit = (base_lr * cpu["lr_mult"][key] * limit
                   * float(cpu["grad"][key].abs().max())
                   + 2 * eps * float(cpu["w0"][key].abs().max()))
        row = {"grad": grad_rel(card, key), "grad_limit": limit,
               "grad_cpu_perturbed": grad_rel(cpu_pert, key),
               "grad_tf32_backward": grad_rel(tf32, key),
               "w": w_diff(card, key), "w_limit": w_limit,
               "w_tf32_backward": w_diff(tf32, key)}
        if not row["grad"] <= limit:
            bad.append(f"grad {key}: {row['grad']:.3g} > {limit:.3g}")
        if not row["w"] <= w_limit:
            bad.append(f"updated {key}: {row['w']:.3g} > {w_limit:.3g}")
        params[key] = row
    res = {"batch": PARITY_BATCH, "loss_cpu": cpu["loss"],
           "loss_card": card["loss"], "loss_tf32_backward": tf32["loss"],
           "conv1_grad_max_abs": float(card["grad"]["conv1.weight"].abs()
                                       .max()),
           "params": params}
    log(f"train parity: {json.dumps(res)}")
    if float(cpu["grad"]["conv1.weight"].abs().max()) == 0.0 or \
            res["conv1_grad_max_abs"] == 0.0:
        fail("conv1 got no gradient")
    if abs(card["loss"] - cpu["loss"]) > 1e-5 * abs(cpu["loss"]):
        fail(f"loss on the card {card['loss']} vs CPU {cpu['loss']}")
    if bad:
        fail(f"train parity: {bad}")
    return res


# -- 7. transformer -------------------------------------------------------------

TLM_DIR = os.path.join(ROOT, "models", "transformer_lm")
TLM_ITERS = 20
TLM_SEQ = 64
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel")

# The induction task of tests/test_sequence_layers.py (a one-block
# transformer_lm learns x[t+1] = x[t-3]), with use_flash; the net as
# models/generate_models.py writes transformer_lm(batch=8, seq=32,
# vocab=32, dim=32, heads=2, n_blocks=1, ffn_hidden=64, moe_experts=4).
INDUCTION_NET = """name: "transformer_lm"
layer { name: "tokens" type: "Input" top: "tokens" top: "label" input_param { shape { dim: 8 dim: 32 } shape { dim: 8 dim: 32 } } }
layer { name: "embed" type: "Embed" bottom: "tokens" top: "embed" embed_param { input_dim: 32 num_output: 32 bias_term: false weight_filler { type: "gaussian" std: 0.02 } } }
layer { name: "pos" type: "Parameter" top: "pos" parameter_param { shape { dim: 32 dim: 32 } } }
layer { name: "x0" type: "Bias" bottom: "embed" bottom: "pos" top: "x0" bias_param { axis: 1 } }
layer { name: "blk0/ln1" type: "LayerNorm" bottom: "x0" top: "blk0/ln1" }
layer { name: "blk0/attn" type: "Attention" bottom: "blk0/ln1" top: "blk0/attn" attention_param { num_heads: 2 causal: true use_flash: true weight_filler { type: "gaussian" std: 0.02 } } }
layer { name: "blk0/res1" type: "Eltwise" bottom: "x0" bottom: "blk0/attn" top: "blk0/res1" }
layer { name: "blk0/ln2" type: "LayerNorm" bottom: "blk0/res1" top: "blk0/ln2" }
layer { name: "blk0/moe" type: "MoE" bottom: "blk0/ln2" top: "blk0/moe" top: "blk0/moe_aux" loss_weight: 0.0 loss_weight: 0.01 moe_param { num_experts: 4 hidden_dim: 64 capacity_factor: 2.0 } }
layer { name: "blk0/res2" type: "Eltwise" bottom: "blk0/res1" bottom: "blk0/moe" top: "blk0/res2" }
layer { name: "ln_f" type: "LayerNorm" bottom: "blk0/res2" top: "ln_f" }
layer { name: "logits" type: "InnerProduct" bottom: "ln_f" top: "logits" inner_product_param { num_output: 32 axis: 2 weight_filler { type: "gaussian" std: 0.02 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits" bottom: "label" top: "loss" softmax_param { axis: 2 } }
layer { name: "accuracy" type: "Accuracy" bottom: "logits" bottom: "label" top: "accuracy" include { phase: TEST } accuracy_param { axis: 2 } }
"""


def _with_flash(text: str) -> str:
    """The prototxt with `use_flash: true` after each `causal: true`, as the
    JAX package's own tests switch it on."""
    if "causal: true" not in text:
        fail("no causal Attention layer to switch use_flash on in")
    return text.replace("causal: true", "causal: true\n    use_flash: true")


def _flash_solver(tmp: str, stem: str = "") -> str:
    """Copies of models/transformer_lm/solver<stem>.prototxt and its
    train_val<stem>.prototxt in `tmp`, the net with use_flash; the
    solver's path."""
    with open(os.path.join(TLM_DIR, f"train_val{stem}.prototxt")) as f:
        net = _with_flash(f.read())
    net_path = os.path.join(tmp, f"train_val{stem}.prototxt")
    with open(net_path, "w") as f:
        f.write(net)
    with open(os.path.join(TLM_DIR, f"solver{stem}.prototxt")) as f:
        text = f.read()
    old = f'net: "models/transformer_lm/train_val{stem}.prototxt"'
    if old not in text:
        fail(f"models/transformer_lm/solver{stem}.prototxt does not name "
             f"{old}")
    path = os.path.join(tmp, f"solver{stem}.prototxt")
    with open(path, "w") as f:
        f.write(text.replace(old, f'net: "{net_path}"'))
    return path


def _flash_counts() -> tuple[int, int, int]:
    from caffe_mpi_tpu_torch.ops import flash_attention as fa
    return (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches)


def _reset_flash_counts() -> None:
    from caffe_mpi_tpu_torch.ops import flash_attention as fa
    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = \
        fa.flash_bwd_dkv.launches = 0


def transformer_phase(flash: list[dict], card: str) -> dict:
    """Train transformer_lm (full width, batch 8, sequence 64, Adam) with
    use_flash through the CLI's `train`: 20 iterations, a final test pass
    of TEST_ITER batches, a snapshot in a temporary directory. K3 must
    launch twice a forward, K4 and K5 twice an iteration; every loss
    finite; blk0/attn.qkv_weight's gradient nonzero and its output's graph
    through _FlashFunction. Then resume the snapshot through the same
    entry point: weights and both Adam slots bitwise, one more step."""
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.tools import cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tlm_")
    try:
        solver_path = _flash_solver(tmp)
        prefix = os.path.join(tmp, "transformer_lm")
        argv = ["train", "-solver", solver_path, "-synthetic",
                "-test_iter", str(TEST_ITER), "-snapshot_prefix", prefix,
                "-device", "cuda"]
        torch.cuda.reset_peak_memory_stats()
        _reset_flash_counts()
        solver, summary = cli.train(cli.parse_args(
            argv + ["-max_iter", str(TLM_ITERS)]))
        torch.cuda.synchronize()
        counts = _flash_counts()
        losses = summary["losses"]
        log(f"transformer train: {json.dumps(summary)}")
        if summary["batch"] != 8 or len(losses) != TLM_ITERS:
            fail(f"transformer ran {len(losses)} iterations at batch "
                 f"{summary['batch']}, want {TLM_ITERS} at 8")
        if not np.all(np.isfinite(losses)):
            fail(f"transformer losses not all finite: {losses}")
        # forwards: every iteration and the final test pass; the solver
        # tests at iteration 0 only under test_initialization, and its
        # test_interval (1000) is past the run
        sp = solver.sp
        if sp.test_initialization or sp.test_interval <= TLM_ITERS:
            fail("the schedule below assumes test_initialization: false "
                 f"and test_interval > {TLM_ITERS}")
        forwards = TLM_ITERS + TEST_ITER
        want = (2 * forwards, 2 * TLM_ITERS, 2 * TLM_ITERS)
        if counts != want:
            fail(f"K3/K4/K5 launched {counts} times, want {want}")
        for entry, n in zip(flash, counts):
            entry["launches"] = n
            entry["launches_by_path"] = {"train_transformer_lm": n}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        grad = solver.net.layer_by_name("blk0/attn").qkv_weight.grad
        if grad is None or float(grad.abs().max()) == 0.0:
            fail("blk0/attn.qkv_weight got no gradient")
        qkv_grad_max = float(grad.abs().max())
        feeds = cli.synthetic_feed(solver.net)
        env, _ = solver.net(feeds)
        if "_FlashFunctionBackward" not in _graph_nodes(env["blk0/attn"]):
            fail("blk0/attn's output has no graph through _FlashFunction")
        del env
        trained = _state(solver)
        profile = profile_steps(solver, lambda it: feeds, ours=FLASH_KERNELS)
        log(f"transformer profile: {json.dumps(profile)}")
        del solver, feeds

        resumed, again = cli.train(cli.parse_args(
            argv + ["-max_iter", str(TLM_ITERS + 1), "-snapshot",
                    summary["snapshot"]]))
        if again["start_iter"] != TLM_ITERS or again["iters"] != 1 or \
                not np.isfinite(again["losses"][0]):
            fail(f"transformer resume: {again}")
        check = Solver(resumed.sp, model_dir=resumed.model_dir,
                       device="cuda")
        check.restore(summary["snapshot"])
        restored = _state(check)
        if any(len(h) != 2 for h in check.history.values()):
            fail("the Adam solver did not restore two slots a param")
        bad = [k for k in trained if not torch.equal(trained[k],
                                                     restored[k])]
        if bad:
            fail(f"restored transformer state differs: {bad[:5]}")
        del resumed, check
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    med = summary["median_iter_ms"]
    return {
        "solver": "models/transformer_lm/solver.prototxt",
        "net": "models/transformer_lm/train_val.prototxt with use_flash",
        "batch": 8, "seq": TLM_SEQ, "iters": TLM_ITERS, "losses": losses,
        "median_step_ms": med, "seq_per_s": summary["img_per_s"],
        "tokens_per_s": summary["img_per_s"] * TLM_SEQ,
        "step_ms": summary["iter_ms"], "test_scores": summary["test_scores"],
        "launches": dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                             counts)),
        "qkv_weight_grad_max_abs": qkv_grad_max,
        "resumed_loss": again["losses"][0], "peak_mem_GB": peak_gb,
        "profile": profile,
        "device_busy": profile["device_ms_per_step"] / med
        if isinstance(profile["device_ms_per_step"], float) else None,
        "card": card,
    }


def induction_phase() -> dict:
    """The induction task with use_flash on the card: 300 Adam steps, then
    held-out next-token accuracy past position 8 must reach 0.9, the JAX
    test's bar — the kernels' gradients train a net that has to attend
    backwards."""
    from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver

    sp = SolverParameter.from_text(
        'base_lr: 0.003 momentum: 0.9 momentum2: 0.999 type: "Adam" '
        'lr_policy: "fixed" max_iter: 400 display: 0')
    sp.net_param = NetParameter.from_text(INDUCTION_NET)
    solver = Solver(sp, device="cuda")
    b, s, v = 8, 32, 32

    def feed(it):
        r = np.random.RandomState(it)
        seq = np.tile(r.randint(0, v, (b, 4)), (1, s // 4 + 2))[:, :s + 1]
        return {"tokens": torch.from_numpy(seq[:, :s]).cuda(),
                "label": torch.from_numpy(seq[:, 1:s + 1]).cuda()}

    steps = 300
    _reset_flash_counts()
    t0 = time.perf_counter()
    solver.step(steps, feed)
    f = feed(10_001)
    with torch.no_grad():
        blobs, _ = solver.net(f)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _flash_counts()
    if counts != (steps + 1, steps, steps):
        fail(f"induction: K3/K4/K5 launched {counts}, want "
             f"{(steps + 1, steps, steps)}")
    pred = blobs["logits"].argmax(-1).cpu().numpy()
    lab = f["label"].cpu().numpy()
    acc = float((pred[:, 8:] == lab[:, 8:]).mean())
    res = {"steps": steps, "accuracy": acc, "bar": 0.9,
           "first_loss": solver.losses[0], "last_loss": solver.losses[-1],
           "seconds": secs, "launches": list(counts)}
    log(f"induction: {json.dumps(res)}")
    if acc < 0.9:
        fail(f"induction task reached {acc:.3f} held-out accuracy, < 0.9")
    return res


# limits of the card-against-CPU step, and why: gradients within 1e-4 of
# their largest element (f32 sums in other orders, no max pool here);
# the loss within 1e-5 of its size; the deploy net's prob rows within
# 1e-5 of the largest
TLM_GRAD_LIMIT = 1e-4


def transformer_parity_phase() -> dict:
    """One Adam step of transformer_lm at full width and batch 8 on the
    card against the CPU, TF32 off through default_forward_math: FLOAT,
    from the same weights and feeds. The MoE routes are compared first
    (a near tie can flip under another summation order, and a flipped
    route changes what is compared); then the loss, every gradient, and
    every updated parameter within Adam's sensitivity to the gradient
    limit: at step 1 the update is lr * g / (|g| + c), c = eps /
    sqrt(1 - beta2), which moves by at most lr / c per unit of gradient,
    plus two f32 ulps of the largest weight. Then the deploy net (batch
    10, BH = 40) forward on both, its prob rows compared."""
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.ops.moe import routing
    from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.tools import cli

    def param():
        sp = SolverParameter.from_file(os.path.join(TLM_DIR,
                                                    "solver.prototxt"))
        with open(os.path.join(TLM_DIR, "train_val.prototxt")) as f:
            net = NetParameter.from_text(_with_flash(f.read()))
        net.default_forward_math = "FLOAT"
        sp.net, sp.net_param = "", net
        sp.test_iter, sp.test_interval = [], 0
        return sp

    def one_step(device, feeds_cpu):
        solver = Solver(param(), device=device)
        feeds = {k: v.to(device) for k, v in feeds_cpu.items()}
        moe = solver.net.layer_by_name("blk1/moe")
        with torch.no_grad(), moe.policy.math(solver.device):
            env, _ = solver.net(feeds)
            x = env["blk1/ln2"]
            routes = routing(moe.expert_params(), x.reshape(-1, x.shape[-1]),
                             top_k=max(moe.p.top_k, 1)).cpu()
        del env
        w0 = {f"{l}.{p}": t.detach().cpu().clone()
              for l, p, _, t in solver._decls}
        solver.step(1, lambda it: feeds)
        out = {"loss": solver.losses[0], "w0": w0, "grad": {}, "w": {},
               "lr_mult": {}, "routes": routes}
        for l, p, decl, t in solver._decls:
            key = f"{l}.{p}"
            out["w"][key] = t.detach().cpu()
            out["grad"][key] = t.grad.detach().cpu()
            out["lr_mult"][key] = decl.lr_mult
        return out, solver.sp

    # the frozen statistics: the batch's own, from a CPU forward with
    # moving_average_fraction 0, so the frozen net's activations are at
    # the trained net's scale
    probe = Solver(param(), device="cpu")
    feeds = cli.synthetic_feed(probe.net, seed=0)
    for layer in _batch_norms(probe.net):
        layer.p.moving_average_fraction = 0.0
    with torch.no_grad():
        probe.net(feeds)
    frozen_stats = {l.name: (l.mean.clone(), l.var.clone())
                    for l in _batch_norms(probe.net)}
    del probe
    cpu, sp = one_step("cpu", feeds)
    _reset_flash_counts()
    card, _ = one_step("cuda", feeds)
    counts = _flash_counts()
    # the routing forward and the step's forward; one backward
    if counts != (4, 2, 2):
        fail(f"card step launched K3/K4/K5 {counts}, want (4, 2, 2)")
    flips = int((card["routes"] != cpu["routes"]).any(-1).sum())
    if flips:
        fail(f"{flips} of {cpu['routes'].shape[0]} tokens routed "
             "differently on the card and the CPU")
    if any(not torch.equal(cpu["w0"][k], card["w0"][k]) for k in cpu["w0"]):
        fail("card and CPU solvers did not start from the same weights")
    c = max(sp.delta, 1e-4) / np.sqrt(1.0 - sp.momentum2)
    eps = torch.finfo(torch.float32).eps
    params, bad = {}, []
    for key, gref in cpu["grad"].items():
        gmax = float(gref.abs().max())
        grad = float((card["grad"][key] - gref).abs().max()) / gmax \
            if gmax else float(card["grad"][key].abs().max())
        w_limit = (sp.base_lr * cpu["lr_mult"][key] * TLM_GRAD_LIMIT * gmax
                   / c + 2 * eps * float(cpu["w0"][key].abs().max()))
        w = float((card["w"][key] - cpu["w"][key]).abs().max())
        params[key] = {"grad": grad, "grad_max_abs": gmax, "w": w,
                       "w_limit": w_limit}
        if not grad <= TLM_GRAD_LIMIT:
            bad.append(f"grad {key}: {grad:.3g} > {TLM_GRAD_LIMIT}")
        if not w <= w_limit:
            bad.append(f"updated {key}: {w:.3g} > {w_limit:.3g}")
    res = {"batch": 8, "loss_cpu": cpu["loss"], "loss_card": card["loss"],
           "tokens": int(cpu["routes"].shape[0]), "route_flips": flips,
           "adam_c": c, "params": params}

    # the deploy net, batch 10 (BH = 40), prob rows on both
    with open(os.path.join(TLM_DIR, "deploy.prototxt")) as f:
        dtext = _with_flash(f.read())
    nets = {}
    for device in ("cpu", "cuda"):
        dp = NetParameter.from_text(dtext)
        dp.default_forward_math = "FLOAT"
        net = Net(dp, device=device)
        net.init(0)
        nets[device] = net
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, nets["cpu"].blob_shapes["tokens"]))
    with torch.inference_mode():
        ref = nets["cpu"]({"tokens": tokens})[0]["prob"]
        _reset_flash_counts()
        got = nets["cuda"]({"tokens": tokens.cuda()})[0]["prob"].cpu()
    if _flash_counts() != (2, 0, 0):
        fail(f"deploy forward launched K3/K4/K5 {_flash_counts()}, "
             "want (2, 0, 0)")
    diff = float((got - ref).abs().max())
    res["deploy"] = {"shape": list(ref.shape), "prob_max_abs_diff": diff,
                     "prob_max": float(ref.abs().max()),
                     "bh": int(ref.shape[0]) * 4}
    log(f"transformer parity: {json.dumps(res)}")
    if abs(card["loss"] - cpu["loss"]) > 1e-5 * abs(cpu["loss"]):
        fail(f"transformer loss on the card {card['loss']} vs CPU "
             f"{cpu['loss']}")
    if bad:
        fail(f"transformer parity: {bad}")
    if not np.isfinite(diff) or diff > 1e-5 * float(ref.abs().max()):
        fail(f"deploy prob rows differ by {diff:.3g}")
    return res



# -- 10. resnet50 ----------------------------------------------------------------

RESNET_DIR = os.path.join(ROOT, "models", "resnet50")
RESNET_ITERS = 20
RESNET_BATCH = 32
RESNET_BNS = 53
# device time of a step by the aten op that launched it (inclusive device
# time of these leaf ops, so no kernel is counted twice): convolution
# forward and backward (cuDNN, layout conversions included), BatchNorm
# (cuDNN's forward and backward, and the var_mean of the running update),
# elementwise ops (ReLU forward and backward, residual adds, gradient
# accumulation, the running update's and the SGD update's arithmetic);
# "other" is the rest (pooling, fc, the loss, copies)
RESNET_GROUPS = {
    "conv_forward": ("aten::cudnn_convolution",),
    "conv_backward": ("aten::convolution_backward",),
    "batch_norm": ("aten::cudnn_batch_norm", "aten::native_batch_norm",
                   "aten::cudnn_batch_norm_backward",
                   "aten::native_batch_norm_backward", "aten::var_mean"),
    "elementwise": ("aten::relu", "aten::relu_", "aten::threshold_backward",
                    "aten::add", "aten::add_", "aten::mul", "aten::mul_",
                    "aten::sub", "aten::div"),
}


def _kernel_counts() -> tuple[int, ...]:
    """K1-K5's launch counts."""
    from caffe_mpi_tpu_torch.ops import launch_counters
    return tuple(c.launches for c in launch_counters())


def _reset_kernel_counts() -> None:
    from caffe_mpi_tpu_torch.ops import launch_counters
    for c in launch_counters():
        c.launches = 0


def _train_cli(solver_path, prefix, iters, extra=()):
    from caffe_mpi_tpu_torch.tools import cli
    return cli.train(cli.parse_args(
        ["train", "-solver", solver_path, "-synthetic", "-test_iter",
         str(TEST_ITER), "-snapshot_prefix", prefix, "-device", "cuda",
         "-max_iter", str(iters), *extra]))


def _batch_norms(net):
    return [l for l in net.layers if l.lp.type == "BatchNorm"]


def resnet50_phase(card: str) -> dict:
    """Train models/resnet50/solver.prototxt as written (batch 32, 224^2,
    53 BatchNorms with scale_bias, poly LR with ramp-up) through the CLI's
    `train`: 20 iterations, a test pass of TEST_ITER batches at iteration
    0 and at the end through the statistics the test net shares, with
    every launch count set to 0 just before and read just after (ResNet-50
    has no LRN and no attention: all five stay 0). Every loss finite,
    every running mean and variance moved from 0 and finite. A profile
    of a step. Then the snapshot resumes through the same entry point:
    weights, history and running statistics bitwise, one more step. Then
    the card-against-CPU step and the served deploy rows."""
    from caffe_mpi_tpu_torch.layers import norm
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.tools import cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_resnet50_")
    solver_path = os.path.join(RESNET_DIR, "solver.prototxt")
    try:
        prefix = os.path.join(tmp, "resnet50")
        torch.cuda.reset_peak_memory_stats()
        _reset_kernel_counts()
        solver, summary = _train_cli(solver_path, prefix, RESNET_ITERS)
        torch.cuda.synchronize()
        counts = _kernel_counts()
        losses = summary["losses"]
        log(f"resnet50 train: {json.dumps(summary)}")
        if summary["batch"] != RESNET_BATCH or len(losses) != RESNET_ITERS:
            fail(f"resnet50 ran {len(losses)} iterations at batch "
                 f"{summary['batch']}, want {RESNET_ITERS} at "
                 f"{RESNET_BATCH}")
        if not np.all(np.isfinite(losses)):
            fail(f"resnet50 losses not all finite: {losses}")
        if any(counts):
            fail(f"resnet50 launched K1-K5 {counts}, want none")
        bns = _batch_norms(solver.net)
        if len(bns) != RESNET_BNS or not all(l.scale_bias for l in bns):
            fail(f"{len(bns)} BatchNorms, want {RESNET_BNS} with scale_bias")
        stats = {"min_abs_max": float("inf"), "all_finite": True}
        for l in bns:
            for buf in (l.mean, l.var):
                stats["all_finite"] &= bool(torch.isfinite(buf).all())
                stats["min_abs_max"] = min(stats["min_abs_max"],
                                           float(buf.abs().max()))
        if not stats["all_finite"] or stats["min_abs_max"] == 0.0:
            fail(f"running statistics did not all move and stay finite: "
                 f"{stats}")
        tnet = solver.test_nets[0]
        if any(getattr(tnet.layer_by_name(ln), sn) is not buf
               for ln, sn, buf in solver.net.state_buffers()):
            fail("the test net does not share the train net's statistics")
        if not summary["test_scores"] or not all(
                np.isfinite(v) for v in summary["test_scores"][0].values()):
            fail(f"resnet50 test scores: {summary['test_scores']}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        trained = _state(solver)
        feeds = cli.synthetic_feed(solver.net)
        profile = profile_steps(solver, lambda it: feeds, ours=(),
                                groups=RESNET_GROUPS)
        log(f"resnet50 profile: {json.dumps(profile)}")
        del solver, feeds

        resumed, again = _train_cli(solver_path, prefix, RESNET_ITERS + 1,
                                    ["-snapshot", summary["snapshot"]])
        if again["start_iter"] != RESNET_ITERS or again["iters"] != 1 or \
                not np.isfinite(again["losses"][0]):
            fail(f"resnet50 resume: {again}")
        check = Solver(resumed.sp, model_dir=resumed.model_dir,
                       device="cuda")
        check.restore(summary["snapshot"])
        restored = _state(check)
        bad = [k for k in trained if not torch.equal(trained[k],
                                                     restored[k])]
        if bad:
            fail(f"restored resnet50 state differs: {bad[:5]}")
        n_stats = sum(1 for k in trained if k.endswith((".mean", ".var")))
        del resumed, check
        torch.cuda.empty_cache()
        caffemodel = summary["snapshot"].replace(".solverstate",
                                                 ".caffemodel")
        serving = _resnet_serve(caffemodel)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    med = summary["median_iter_ms"]
    return {
        "solver": "models/resnet50/solver.prototxt", "batch": RESNET_BATCH,
        "iters": RESNET_ITERS, "losses": losses, "median_step_ms": med,
        "img_per_s": summary["img_per_s"], "step_ms": summary["iter_ms"],
        "test_scores": summary["test_scores"],
        "launches_k1_k5": list(counts), "batch_norms": len(bns),
        "statistics": stats, "resumed_statistics_bitwise": n_stats,
        "resumed_loss": again["losses"][0], "peak_mem_GB": peak_gb,
        "batch_norm_design": norm.BATCH_STATS, "profile": profile,
        "device_busy": profile["device_ms_per_step"] / med
        if isinstance(profile["device_ms_per_step"], float) else None,
        "serving": serving, "card": card,
    }


def _strict(param):
    """A NetParameter with TF32 off (default_forward_math: FLOAT)."""
    param.default_forward_math = "FLOAT"
    return param


# served deploy rows against the TEST net's forward, both on the card with
# TF32 off: f32 sums in other orders (cuDNN picks its algorithm by batch)
SERVE_LIMIT = 1e-4


def _resnet_serve(caffemodel: str) -> dict:
    """models/resnet50/deploy.prototxt (TF32 off, its Softmax cut so the
    fc1000 logits are compared: random weights leave the softmax nearly
    uniform) with the trained snapshot's caffemodel through ServingEngine
    at its ladder (1, 4, 10), bursts of 1, 3, 10 and 7 rows from four
    threads; every served row against the TEST-phase Net's forward of the
    same rows on the card, within SERVE_LIMIT of the largest logit. Every
    bucket net must hold the first bucket's statistics, and they must be
    the snapshot's (a bucket at zero statistics would give other rows)."""
    from caffe_mpi_tpu_torch import io as port_io
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.proto import NetParameter
    from caffe_mpi_tpu_torch.serving import ServingEngine

    param = _strict(NetParameter.from_file(os.path.join(RESNET_DIR,
                                                        "deploy.prototxt")))
    param.layer = [lp for lp in param.layer if lp.type != "Softmax"]
    bursts = (1, 3, 10, 7)
    rng = np.random.RandomState(4)
    rows = rng.randn(sum(bursts), 3, 224, 224).astype(np.float32)
    weights = port_io.load_weights(caffemodel)
    with ServingEngine(device="cuda") as engine:
        model = engine.load_model("resnet50", copy.deepcopy(param),
                                  caffemodel)
        ladder = model.fwd.ladder
        owner = model.fwd.net_for(ladder[0])
        for b in ladder[1:]:
            other = model.fwd.net_for(b)
            if any(getattr(other.layer_by_name(ln), sn) is not buf
                   for ln, sn, buf in owner.state_buffers()):
                fail(f"serving bucket {b} does not share the statistics")
        first_bn = _batch_norms(owner)[0]
        if not np.array_equal(first_bn.mean.cpu().numpy(),
                              np.asarray(weights[first_bn.name][0])):
            fail("served statistics are not the snapshot's")
        starts = np.cumsum((0,) + bursts[:-1])
        with ThreadPoolExecutor(max_workers=4) as ex:
            futs = [ex.submit(engine.classify, "resnet50",
                              rows[a:a + b], preprocess=False)
                    for a, b in zip(starts, bursts)]
            served = np.concatenate([f.result(timeout=600) for f in futs])
        engine.drain()
        dispatches = engine.stats()["dispatches"]
        out_blob = model.fwd.out_blob()
    ref_param = copy.deepcopy(param)
    for lp in ref_param.layer:
        if lp.type == "Input":
            lp.input_param.shape[0].dim[0] = len(rows)
    ref_net = Net(ref_param, "TEST", device="cuda")
    ref_net.import_weights(weights)
    with torch.inference_mode():
        ref = ref_net({"data": torch.from_numpy(rows).cuda()})[0][
            out_blob].float().cpu().numpy()
    diff = float(np.abs(served - ref).max())
    res = {"model": "models/resnet50/deploy.prototxt (TF32 off, logits)",
           "ladder": list(ladder), "bursts": list(bursts),
           "dispatches": dispatches, "rows": int(len(rows)),
           "max_abs_diff": diff, "ref_max_abs": float(np.abs(ref).max()),
           "limit": SERVE_LIMIT}
    log(f"resnet50 serving: {json.dumps(res)}")
    if not np.all(np.isfinite(served)) or \
            diff > SERVE_LIMIT * float(np.abs(ref).max()):
        fail(f"served resnet50 rows against the TEST net: {res}")
    return res


RESNET_PARITY_BATCH = 16
RESNET_BELOW_POOL1 = ("conv1.", "conv1/bn.")
# Limits of the card-against-CPU step (TF32 off). ResNet-50's gradients
# at its initial weights amplify rounding: on the CPU alone, a 1e-7
# relative change of the input moves conv and BatchNorm gradients by up
# to ~17% of their largest element, with the running statistics or with
# the batch's own frozen in place of them (the first chip run of this
# check measured the card's differences at 1.05x the CPU's own). So each
# group's gradients (conv1 and conv1/bn below pool1, the layers above it)
# and the running statistics are held to RESNET_SPREAD_FACTOR x the
# largest change the CPU shows in that group under that one rounding of
# its input; fc, above every BatchNorm, to 1e-4 of its largest element
# (AlexNet's fc limit); the loss to 1e-5 of its size.
RESNET_SPREAD_FACTOR = 2.0
RESNET_FC_LIMIT = 1e-4


def _resnet_group(key: str) -> str:
    if key.startswith(RESNET_BELOW_POOL1):
        return "below_pool1"
    return "fc" if key.startswith("fc.") else "above"


def resnet50_parity_phase() -> dict:
    """One SGD step of ResNet-50 at full width, batch cut to
    RESNET_PARITY_BATCH (for this check only), on the card against the
    CPU from the same weights and feeds, TF32 off, within the limits
    above; each updated parameter within lr x lr_mult x its limit x the
    gradient's largest element, plus two f32 ulps of the largest weight.
    Then BatchNorm's two batch-statistics designs against each other on
    the card (`_bn_designs_check`)."""
    from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver, lr_policy
    from caffe_mpi_tpu_torch.tools import cli

    def param():
        sp = SolverParameter.from_file(os.path.join(RESNET_DIR,
                                                    "solver.prototxt"))
        net = _strict(NetParameter.from_file(os.path.join(ROOT, sp.net)))
        for lp in net.layer:
            if lp.type == "Input":
                for shape in lp.input_param.shape:
                    shape.dim[0] = RESNET_PARITY_BATCH
        sp.net, sp.net_param = "", net
        sp.test_iter, sp.test_interval = [], 0
        return sp

    def one_step(device, feeds_cpu):
        solver = Solver(param(), device=device)
        feeds = {k: v.to(device) for k, v in feeds_cpu.items()}
        w0 = {f"{l}.{p}": t.detach().cpu().clone()
              for l, p, _, t in solver._decls}
        solver.step(1, lambda it: feeds)
        out = {"loss": solver.losses[0], "w0": w0, "grad": {}, "w": {},
               "lr_mult": {}, "rate": lr_policy.schedule(solver.sp, 0)[0],
               "stats": {f"{l}.{n}": b.cpu().clone()
                         for l, n, b in solver.net.state_buffers()}}
        for l, p, decl, t in solver._decls:
            key = f"{l}.{p}"
            out["w"][key] = t.detach().cpu()
            out["grad"][key] = t.grad.detach().cpu()
            out["lr_mult"][key] = decl.lr_mult
        return out

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    probe = Solver(param(), device="cpu")
    feeds = cli.synthetic_feed(probe.net, seed=0)
    del probe
    perturbed = dict(feeds)
    perturbed["data"] = feeds["data"] * (1 + 1e-7 * torch.randn(
        feeds["data"].shape, generator=torch.Generator().manual_seed(1)))
    t0 = time.perf_counter()
    cpu = one_step("cpu", feeds)
    cpu_secs = time.perf_counter() - t0
    cpu_self = one_step("cpu", perturbed)
    card = one_step("cuda", feeds)
    if any(not torch.equal(cpu["w0"][k], card["w0"][k]) for k in cpu["w0"]):
        fail("card and CPU solvers did not start from the same weights")
    rows = {key: {"group": _resnet_group(key),
                  "grad": rel(card["grad"][key], gref),
                  "grad_cpu_self": rel(cpu_self["grad"][key], gref),
                  "w": float((card["w"][key] - cpu["w"][key]).abs().max())}
            for key, gref in cpu["grad"].items()}
    groups = ("below_pool1", "above", "fc")
    self_worst = {g: max(r["grad_cpu_self"] for r in rows.values()
                         if r["group"] == g) for g in groups}
    limits = {g: RESNET_SPREAD_FACTOR * self_worst[g] for g in groups}
    limits["fc"] = RESNET_FC_LIMIT
    eps = torch.finfo(torch.float32).eps
    bad = []
    for key, r in rows.items():
        limit = limits[r["group"]]
        r["w_limit"] = (cpu["rate"] * cpu["lr_mult"][key] * limit
                        * float(cpu["grad"][key].abs().max())
                        + 2 * eps * float(cpu["w0"][key].abs().max()))
        if not r["grad"] <= limit:
            bad.append(f"grad {key}: {r['grad']:.3g} > {limit:.3g}")
        if not r["w"] <= r["w_limit"]:
            bad.append(f"updated {key}: {r['w']:.3g} > {r['w_limit']:.3g}")
    stats = max(rel(card["stats"][k], v) for k, v in cpu["stats"].items())
    stats_self = max(rel(cpu_self["stats"][k], v)
                     for k, v in cpu["stats"].items())
    if not stats <= RESNET_SPREAD_FACTOR * stats_self:
        bad.append(f"statistics: {stats:.3g} > {RESNET_SPREAD_FACTOR} x "
                   f"{stats_self:.3g}")
    if abs(card["loss"] - cpu["loss"]) > 1e-5 * abs(cpu["loss"]):
        bad.append(f"loss on the card {card['loss']} vs CPU {cpu['loss']}")
    res = {"batch": RESNET_PARITY_BATCH, "loss_cpu": cpu["loss"],
           "loss_card": card["loss"], "loss_cpu_self": cpu_self["loss"],
           "limits": limits,
           "worst_grad": {g: max(r["grad"] for r in rows.values()
                                 if r["group"] == g) for g in groups},
           "worst_grad_cpu_self": self_worst, "worst_statistic": stats,
           "worst_statistic_cpu_self": stats_self, "cpu_step_s": cpu_secs}
    log(f"resnet50 parity: {json.dumps({**res, 'params': rows})}")
    res["batch_norm_designs"] = _bn_designs_check()
    if bad:
        fail(f"resnet50 parity: {bad[:10]}")
    return res


# BatchNorm's "fused" design (cuDNN) against its "composite" one on the
# card: y, the gradients and the running statistics within 1e-5 of each
# one's largest element (the same f32 math, reductions in other orders)
BN_DESIGN_SHAPES = ((16, 64, 112, 112), (2, 8, 3, 3))
BN_DESIGN_TOL = 1e-5


def _bn_designs_check() -> dict:
    """A BatchNorm(scale_bias) layer at conv1/bn's shape at the parity
    batch and at a small one (where the variance's n / (n - 1) would
    show), in TRAIN, run by both designs from the same input, scale, bias
    and statistics."""
    from caffe_mpi_tpu_torch.core.types import DtypePolicy
    from caffe_mpi_tpu_torch.layers import create_layer, norm
    from caffe_mpi_tpu_torch.proto import LayerParameter

    lp = LayerParameter.from_text(
        'name: "bn" type: "BatchNorm" bottom: "x" top: "y" '
        'batch_norm_param { scale_bias: true eps: 0.0001 '
        'moving_average_fraction: 0.9 }')
    gen = torch.Generator(device="cuda").manual_seed(5)
    out, shipped = {}, norm.BATCH_STATS
    try:
        for shape in BN_DESIGN_SHAPES:
            x = torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
            dy = torch.randn(shape, generator=gen, device="cuda")
            c = shape[1]
            init = [torch.randn(c, generator=gen, device="cuda")
                    for _ in range(3)] + [
                torch.rand(c, generator=gen, device="cuda") + 0.5]
            got = {}
            for design in norm.DESIGNS:
                norm.BATCH_STATS = design
                layer = create_layer(lp, DtypePolicy(), "TRAIN",
                                     torch.device("cuda"))
                layer.setup([shape])
                with torch.no_grad():
                    for t, v in zip((layer.scale, layer.bias, layer.mean,
                                     layer.var), init):
                        t.copy_(v)
                layer.scale.requires_grad_(True)
                layer.bias.requires_grad_(True)
                xg = x.clone().requires_grad_(True)
                y = layer([xg])[0]
                y.backward(dy)
                got[design] = {"y": y.detach(), "dx": xg.grad,
                               "dscale": layer.scale.grad,
                               "dbias": layer.bias.grad,
                               "mean": layer.mean.clone(),
                               "var": layer.var.clone()}
            errs = {k: float((got["fused"][k] - got["composite"][k]).abs()
                             .max()) / float(got["composite"][k].abs().max())
                    for k in got["fused"]}
            out["x".join(map(str, shape))] = errs
            if not all(e <= BN_DESIGN_TOL for e in errs.values()):
                fail(f"BatchNorm designs differ at {shape}: {errs}")
    finally:
        norm.BATCH_STATS = shipped
    log(f"batch norm designs on the card: {json.dumps(out)}")
    return out


# -- 11. googlenet ---------------------------------------------------------------

GOOGLENET_ITERS = 20
GOOGLENET_BATCH = 128


def googlenet_phase(k1: dict, k2: dict, card: str) -> dict:
    """Train models/googlenet/solver.prototxt as written (batch 128, three
    losses weighted 0.3, 0.3 and 1) through the CLI's `train`: 20
    iterations and a test pass of TEST_ITER batches at iteration 0 and at
    the end, launch counts set to 0 just before and read just after: K1
    twice a forward (pool1/norm1, conv2/norm2), K2 twice an iteration, no
    flash kernel; every loss finite."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_googlenet_")
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_kernel_counts()
        solver, summary = _train_cli(
            os.path.join(ROOT, "models", "googlenet", "solver.prototxt"),
            os.path.join(tmp, "googlenet"), GOOGLENET_ITERS)
        torch.cuda.synchronize()
        counts = _kernel_counts()
        weights = sorted(w for _, w in solver.net.loss_blobs)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del solver
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    losses = summary["losses"]
    log(f"googlenet train: {json.dumps(summary)}")
    if summary["batch"] != GOOGLENET_BATCH or \
            len(losses) != GOOGLENET_ITERS:
        fail(f"googlenet ran {len(losses)} iterations at batch "
             f"{summary['batch']}")
    if not np.all(np.isfinite(losses)):
        fail(f"googlenet losses not all finite: {losses}")
    if weights != [0.3, 0.3, 1.0]:
        fail(f"googlenet loss weights {weights}, want 0.3, 0.3, 1")
    forwards = GOOGLENET_ITERS + 2 * TEST_ITER
    want = (2 * forwards, 2 * GOOGLENET_ITERS, 0, 0, 0)
    if counts != want:
        fail(f"googlenet launched K1-K5 {counts}, want {want}")
    k1["launches_by_path"]["train_googlenet"] = counts[0]
    k2["launches_by_path"]["train_googlenet"] = counts[1]
    med = summary["median_iter_ms"]
    return {
        "solver": "models/googlenet/solver.prototxt",
        "batch": GOOGLENET_BATCH, "iters": GOOGLENET_ITERS,
        "losses": losses, "median_step_ms": med,
        "img_per_s": summary["img_per_s"], "step_ms": summary["iter_ms"],
        "test_scores": summary["test_scores"],
        "launches_k1_k5": list(counts), "loss_weights": weights,
        "peak_mem_GB": peak_gb, "card": card,
    }

# -- 12. lmdb -------------------------------------------------------------------

CAFFENET = os.path.join(ROOT, "examples", "imagenet",
                        "caffenet_train_val.prototxt")
CAFFENET_SOLVER = os.path.join(ROOT, "examples", "imagenet",
                               "caffenet_solver.prototxt")
LMDB_SHAPE = (3, 256, 256)
LMDB_TRAIN, LMDB_VAL, LMDB_JPEG = 1280, 100, 256
LMDB_ITERS, LMDB_TEST_INTERVAL = 20, 10
JPEG_ITERS = 8
SYNTHETIC_ITERS = 10
CAFFENET_BATCH, CAFFENET_TEST_BATCH = 256, 50


def _cluster_records(n, seed, codec=None):
    """(key, Datum) of `n` records (raw, or JPEG-encoded) from seeded
    separable clusters (examples/common.py synthetic_clusters: one random
    uint8 template a class, plus bounded noise), drawn in chunks of 64."""
    from caffe_mpi_tpu_torch.data import datasets
    for lo, imgs, labels in _cluster_images(n, seed):
        for i in range(len(labels)):
            enc = (datasets.encode_datum(imgs[i], int(labels[i]))
                   if codec is None else datasets.encode_datum_image(
                       imgs[i], int(labels[i]), codec))
            yield f"{lo + i:08d}".encode(), enc


def _cluster_images(n, seed):
    """(first index, CHW uint8 images, labels) of the seeded clusters, a
    chunk of 64 at a time."""
    templates = np.random.RandomState(42).randint(
        0, 256, (10, *LMDB_SHAPE)).astype(np.int16)
    for lo in range(0, n, 64):
        k = min(64, n - lo)
        rng = np.random.RandomState(seed + lo)
        labels = rng.randint(0, 10, k)
        imgs = np.clip(templates[labels] + rng.randint(
            -40, 41, (k, *LMDB_SHAPE)).astype(np.int16), 0,
            255).astype(np.uint8)
        yield lo, imgs, labels


def _write_clusters(path, n, seed, codec=None):
    """An LMDB of `n` cluster Datums, by the port's writer."""
    from caffe_mpi_tpu_torch.data import lmdb_io
    lmdb_io.write_lmdb(path, _cluster_records(n, seed, codec))


def _caffenet_copy(tmp, train_db, val_db, mean, tag, edits=()):
    """Copies of the CaffeNet example net and solver over these files;
    `edits` are further (old, new) replacements in the net."""
    with open(CAFFENET) as f:
        net = f.read()
    for a, b in (("examples/imagenet/ilsvrc12_train_lmdb", train_db),
                 ("examples/imagenet/ilsvrc12_val_lmdb", val_db),
                 ("examples/imagenet/imagenet_mean.binaryproto", mean),
                 *edits):
        if a not in net:
            fail(f"{CAFFENET} no longer names {a}")
        net = net.replace(a, b)
    net_path = os.path.join(tmp, f"caffenet_{tag}.prototxt")
    with open(net_path, "w") as f:
        f.write(net)
    with open(CAFFENET_SOLVER) as f:
        solver = f.read()
    for a, b in (("examples/imagenet/caffenet_train_val.prototxt", net_path),
                 ("test_iter: 1000", "test_iter: 2"),
                 ("test_interval: 1000",
                  f"test_interval: {LMDB_TEST_INTERVAL}"),
                 ("max_iter: 450000", f"max_iter: {LMDB_ITERS}")):
        if a not in solver:
            fail(f"{CAFFENET_SOLVER} no longer sets {a}")
        solver = solver.replace(a, b)
    solver_path = os.path.join(tmp, f"caffenet_solver_{tag}.prototxt")
    with open(solver_path, "w") as f:
        f.write(solver)
    return net_path, solver_path


def _device_transform_check(solver, train_db) -> dict:
    """One TRAIN batch of the train LMDB through the card's device
    transform against the host DataTransformer over the same records and
    decisions: bitwise. Times both (the host over 256 records, the card's
    one gather)."""
    from caffe_mpi_tpu_torch.data import device_transform as dt
    from caffe_mpi_tpu_torch.data.datasets import open_dataset
    from caffe_mpi_tpu_torch.data.feeder import Feeder
    from caffe_mpi_tpu_torch.data.transformer import DataTransformer
    data = solver.net.layers[0]
    tf = DataTransformer(data.lp.transform_param, "TRAIN")
    feeder = Feeder(open_dataset("LMDB", train_db), tf, CAFFENET_BATCH,
                    device_transform=True, threads=1, lookahead=1)
    try:
        batch = feeder(0)
    finally:
        feeder.close()
    raw, aug = batch["data"], batch["data__aug"]
    flats = list(range(CAFFENET_BATCH))
    t0 = time.perf_counter()
    host = np.stack([tf(r, rng=tf.record_rng(f))
                     for r, f in zip(raw, flats)])
    host_ms = (time.perf_counter() - t0) * 1e3
    raw_d, aug_d = torch.from_numpy(raw).cuda(), torch.from_numpy(aug).cuda()
    mean = torch.from_numpy(tf.mean).cuda()
    tp = data.lp.transform_param

    def run():
        return dt.device_transform(raw_d, aug_d, crop=tp.crop_size,
                                   mean=mean, scale=tp.scale)
    got = run().cpu()
    if not torch.equal(got, torch.from_numpy(host)):
        fail("the card's device transform differs from the host "
             f"DataTransformer (max {float((got - torch.from_numpy(host)).abs().max())})")
    mirrored = int(aug[:, 2].sum())
    if not 0 < mirrored < CAFFENET_BATCH:
        fail(f"{mirrored} of {CAFFENET_BATCH} records mirrored")
    return {"bitwise": True, "records": CAFFENET_BATCH,
            "mirrored": mirrored, "device_ms": time_ms(run),
            "host_ms": host_ms}


def native_codec_line() -> dict:
    """The native library's codec probe (libjpeg's and libpng's headers
    on this machine) and decode_available(), printed on a line of their
    own: where the headers are missing the library is built with stubbed
    decode entry points and encoded records decode through PIL."""
    from caffe_mpi_tpu_torch import native
    from caffe_mpi_tpu_torch.ops import build
    probe = build.codec_probe()
    line = {"native_codec": {
        "headers": probe, "decode_available": native.decode_available(),
        "abi": native.lib().caffe_tpu_native_abi_version()}}
    if not line["native_codec"]["decode_available"]:
        line["native_codec"]["note"] = (
            "this machine lacks the libjpeg/libpng headers: the native "
            "library is built with -DCAFFE_TPU_NO_CODEC and JPEG records "
            "decode through PIL")
    print(json.dumps(line), flush=True)
    return line["native_codec"]


def _jpeg_host_copy(tmp, jpeg_db, val_db, mean, tag):
    """The CaffeNet copies over the JPEG LMDB with the train layer's
    transform on the host (`use_gpu_transform: false`): the native host
    transform, and fused decode-and-transform where the codecs are
    built."""
    net_path, solver_path = _caffenet_copy(tmp, jpeg_db, val_db, mean, tag)
    with open(net_path) as f:
        text = f.read()
    if "mirror: true" not in text:
        fail(f"{CAFFENET} no longer mirrors its train layer")
    with open(net_path, "w") as f:
        f.write(text.replace("mirror: true",
                             "mirror: true use_gpu_transform: false", 1))
    return net_path, solver_path


def _gather_check(solver, train_db) -> dict:
    """Two TRAIN batches of the train LMDB through the Feeder's native
    raw gather (one call a batch: crc32c over the mapping, the Datum
    walk, one copy a record), and through the plain Python build of the
    same batches (the pure-Python LMDB reader, one record at a time):
    bitwise equal, on this host. Times both builds (one thread). Then four
    batches gathered into pinned memory and uploaded by a DeviceFeed
    without its staging copy, read back from the card: bitwise the plain
    build's."""
    from caffe_mpi_tpu_torch.data.datasets import LMDBDataset, open_dataset
    from caffe_mpi_tpu_torch.data.feeder import DeviceFeed, Feeder
    from caffe_mpi_tpu_torch.data.transformer import DataTransformer
    data = solver.net.layers[0]
    tf = DataTransformer(data.lp.transform_param, "TRAIN")
    kw = dict(device_transform=True, threads=1, lookahead=1)
    fast = Feeder(open_dataset("LMDB", train_db), tf, CAFFENET_BATCH, **kw)
    plain = Feeder(LMDBDataset(train_db, reader="python"), tf,
                   CAFFENET_BATCH, **kw)
    plain._gather_ok = False
    ms = {"gather": [], "plain": []}
    try:
        for it in (0, 1, 2):
            batches = {}
            for name, f in (("gather", fast), ("plain", plain)):
                t0 = time.perf_counter()
                batches[name] = f._build_batch_inner(it)
                ms[name].append((time.perf_counter() - t0) * 1e3)
            for key, want in batches["plain"].items():
                got = batches["gather"][key]
                if got.dtype != want.dtype or not np.array_equal(got, want):
                    fail(f"the native raw gather's {key} of batch {it} "
                         "differs from the plain Python build")
        if fast._raw_shape != LMDB_SHAPE:
            fail(f"the Feeder did not gather natively ({fast._raw_shape})")
        # through a DeviceFeed: the stack gathered into pinned memory goes
        # up without the staging copy, and arrives bitwise
        feed = DeviceFeed(Feeder(open_dataset("LMDB", train_db), tf,
                                 CAFFENET_BATCH, **kw), torch.device("cuda"))
        try:
            for it in (0, 1, 2, 3):
                got = {k: v.cpu().numpy() for k, v in feed(it).items()}
                for key, want in plain._build_batch_inner(it).items():
                    if not np.array_equal(got[key], want):
                        fail(f"the pinned upload's {key} of batch {it} "
                             "differs from the plain Python build")
            pinned = feed.feeder.pin_memory
        finally:
            feed.close()
    finally:
        fast.close()
        plain.close()
    if not pinned:
        fail("the DeviceFeed did not ask its Feeder for pinned batches")
    return {"bitwise": True, "batches": 3, "pinned_upload_batches": 4,
            "gather_build_ms": float(np.median(ms["gather"][1:])),
            "plain_build_ms": float(np.median(ms["plain"][1:]))}


def _corrupt_copy(src, dst, index):
    """A copy of the LMDB `src` with one byte of record `index`'s pixels
    flipped (its crc32c in the sidecar no longer matches)."""
    from caffe_mpi_tpu_torch.data.lmdb_io import LMDBReader
    shutil.copytree(src, dst)
    with LMDBReader(dst) as r:
        spans = [s for _, s in r.spans()]
    off, size = spans[index]
    with open(os.path.join(dst, "data.mdb"), "r+b") as f:
        f.seek(off + size - 100)
        b = f.read(1)
        f.seek(off + size - 100)
        f.write(bytes([b[0] ^ 0xFF]))


QUARANTINE_RECORD, QUARANTINE_ITERS = 300, 3


def _quarantine_check(tmp, train_db, val_db, mean) -> dict:
    """CaffeNet through the CLI's `train` from a copy of the train LMDB
    whose record QUARANTINE_RECORD has one byte flipped: the record fails
    its crc32c, the Feeder substitutes the next record and journals it in
    <prefix>.quarantine.json, and the run goes on to its last iteration
    with finite losses."""
    from caffe_mpi_tpu_torch.tools import cli
    bad_db = os.path.join(tmp, "corrupt_lmdb")
    _corrupt_copy(train_db, bad_db, QUARANTINE_RECORD)
    _, solver_path = _caffenet_copy(tmp, bad_db, val_db, mean, "corrupt")
    prefix = os.path.join(tmp, "corrupt")
    solver, summary = cli.train(cli.parse_args(
        ["train", "-solver", solver_path, "-max_iter",
         str(QUARANTINE_ITERS), "-test_iter", "1", "-snapshot_prefix",
         prefix, "-device", "cuda"]))
    del solver
    journal = prefix + ".quarantine.json"
    if not os.path.isfile(journal):
        fail(f"no quarantine journal at {journal}")
    with open(journal) as f:
        records = json.load(f)["records"]
    got = [(r["index"], r["substitute"]) for r in records]
    want = [(QUARANTINE_RECORD, QUARANTINE_RECORD + 1)]
    if got != want or summary["quarantined"] != 1 or \
            "crc32c mismatch" not in records[0]["reason"]:
        fail(f"quarantine journal {records}, want {want}")
    if len(summary["losses"]) != QUARANTINE_ITERS or \
            not np.all(np.isfinite(summary["losses"])):
        fail(f"the run over the corrupt LMDB: {summary['losses']}")
    return {"record": QUARANTINE_RECORD, "journal": got,
            "reason": records[0]["reason"], "iters": QUARANTINE_ITERS,
            "losses": summary["losses"]}


def _cache_check(solver, jpeg_db) -> dict:
    """The decoded-record cache (`decoded_cache_mb`) over the JPEG LMDB:
    a first epoch fills it, the second decodes nothing (every record a
    cache hit) and gives the first epoch's batch bitwise."""
    from caffe_mpi_tpu_torch.data import decode
    from caffe_mpi_tpu_torch.data.datasets import (DecodedCacheDataset,
                                                   open_dataset)
    from caffe_mpi_tpu_torch.data.feeder import Feeder
    from caffe_mpi_tpu_torch.data.transformer import DataTransformer
    data = solver.net.layers[0]
    tf = DataTransformer(data.lp.transform_param, "TRAIN")
    ds = DecodedCacheDataset(open_dataset("LMDB", jpeg_db), 512.0)
    feeder = Feeder(ds, tf, CAFFENET_BATCH, device_transform=True,
                    threads=1, lookahead=1)
    try:
        decode.STATS.reset()
        t0 = time.perf_counter()
        first = feeder._build_batch_inner(0)
        first_ms = (time.perf_counter() - t0) * 1e3
        one = decode.STATS.snapshot()
        decode.STATS.reset()
        t0 = time.perf_counter()
        second = feeder._build_batch_inner(1)  # epoch 2: the same records
        second_ms = (time.perf_counter() - t0) * 1e3
        two = decode.STATS.snapshot()
    finally:
        feeder.close()
    if one["cache_inserts"] != LMDB_JPEG or two["cache_hits"] != LMDB_JPEG \
            or two["decode_calls"] != 0:
        fail(f"decoded cache: epoch 1 {one}, epoch 2 {two}")
    if not np.array_equal(first["data"], second["data"]):
        fail("the decoded cache's second epoch differs from the first")
    return {"epoch1": one, "epoch2": two, "epoch1_build_ms": first_ms,
            "epoch2_build_ms": second_ms}


def lmdb_phase(k1: dict, k2: dict, card: str) -> dict:
    """Train CaffeNet (examples/imagenet/caffenet_train_val.prototxt as
    written: batch 256, crop 227, mirror, a mean file) from a train LMDB
    of 1,280 raw 3x256x256 Datums and a val LMDB of 100 that the port's
    writer makes from seeded clusters, the mean from the port's
    compute_image_mean, through the CLI's `train` (no -synthetic): 20
    iterations, a test pass of 2 batches at iteration 10 and at the end,
    the device transform on. Checks finite losses, test scores, K1 twice
    a forward and K2 twice an iteration (counts set to 0 just before, read
    just after). Then: the card's busy share under the profiler, the same
    solver on a synthetic feed (the same net and device transform, no
    host feed), `test` on the val LMDB from the snapshot's caffemodel,
    `time` on the net, `device_query`, one batch of the device transform
    against the host DataTransformer bitwise, three batches of the
    Feeder's native raw gather against the plain Python build bitwise,
    the decoded-record cache's second epoch (every record a hit, no
    decode), two shorter runs over a JPEG-encoded LMDB of 256 records
    (the device transform, and the host transform: native, fused with
    the decode where the codecs are built), each with its decode counts
    and K1/K2 counts set to 0 just before and read just after, and a run
    over a copy of the train LMDB with one corrupted record, which is
    quarantined and journaled while the run goes on. The native
    library's codec probe is printed on a line of its own first."""
    import contextlib

    from caffe_mpi_tpu_torch.data.feeder import DeviceFeed
    from caffe_mpi_tpu_torch.tools import cli, compute_image_mean
    codec = native_codec_line()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lmdb_")
    try:
        t0 = time.perf_counter()
        train_db = os.path.join(tmp, "train_lmdb")
        val_db = os.path.join(tmp, "val_lmdb")
        jpeg_db = os.path.join(tmp, "train_jpeg_lmdb")
        _write_clusters(train_db, LMDB_TRAIN, seed=7)
        _write_clusters(val_db, LMDB_VAL, seed=100_000)
        write_s = time.perf_counter() - t0
        _write_clusters(jpeg_db, LMDB_JPEG, seed=7, codec="jpeg")
        mean = os.path.join(tmp, "mean.binaryproto")
        with contextlib.redirect_stdout(sys.stderr):
            compute_image_mean.main([train_db, mean])
        db_mb = os.path.getsize(os.path.join(train_db, "data.mdb")) / 1e6
        log(f"lmdb: wrote {LMDB_TRAIN} + {LMDB_VAL} raw records "
            f"({db_mb:.1f} MB) in {write_s:.1f} s")
        net_path, solver_path = _caffenet_copy(tmp, train_db, val_db, mean,
                                               "raw")
        prefix = os.path.join(tmp, "caffenet")
        torch.cuda.reset_peak_memory_stats()
        _reset_kernel_counts()
        solver, summary = cli.train(cli.parse_args(
            ["train", "-solver", solver_path, "-snapshot_prefix", prefix,
             "-device", "cuda"]))
        torch.cuda.synchronize()
        counts = _kernel_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"lmdb train: {json.dumps(summary)}")
        losses = summary["losses"]
        if summary["batch"] != CAFFENET_BATCH or len(losses) != LMDB_ITERS:
            fail(f"lmdb train ran {len(losses)} iterations at batch "
                 f"{summary['batch']}")
        if not np.all(np.isfinite(losses)):
            fail(f"lmdb train losses not all finite: {losses}")
        if summary["data"] != "dataset" or not summary["device_transform"]:
            fail(f"lmdb train fed {summary['data']}, device transform "
                 f"{summary['device_transform']}")
        scores = summary["test_scores"]
        if not scores or set(scores[0]) != {"accuracy", "loss"} or \
                not all(np.isfinite(list(scores[0].values()))):
            fail(f"lmdb train test scores {scores}")
        forwards = LMDB_ITERS + 2 * 2  # two test passes of 2 batches
        want = (2 * forwards, 2 * LMDB_ITERS, 0, 0, 0)
        if counts != want:
            fail(f"lmdb train launched K1-K5 {counts}, want {want}")
        k1["launches_by_path"]["train_caffenet_lmdb"] = counts[0]
        k2["launches_by_path"]["train_caffenet_lmdb"] = counts[1]

        feed = DeviceFeed(cli.build_feeder(solver.net, "TRAIN"),
                          solver.device)
        try:
            profile = profile_steps(solver, feed)
        finally:
            feed.close()
        log(f"lmdb profile: {json.dumps(profile)}")
        syn = cli.synthetic_feed(solver.net)
        n0 = len(solver.iter_ms)
        solver.step(SYNTHETIC_ITERS, lambda it: syn)
        syn_ms = float(np.median(solver.iter_ms[n0 + 1:]))
        syn_window = cli.window_img_per_s(CAFFENET_BATCH,
                                          solver.iter_ms[n0 + 1:])
        transform = _device_transform_check(solver, train_db)
        log(f"device transform: {json.dumps(transform)}")
        gather = _gather_check(solver, train_db)
        log(f"native raw gather: {json.dumps(gather)}")
        cache = _cache_check(solver, jpeg_db)
        log(f"decoded cache: {json.dumps(cache)}")
        del solver, syn

        with contextlib.redirect_stdout(sys.stderr):
            tested = cli.test_net(cli.parse_args(
                ["test", "-model", net_path, "-weights",
                 summary["snapshot"].replace(".solverstate", ".caffemodel"),
                 "-iterations", "2", "-device", "cuda"]))
            timed = cli.time_net(cli.parse_args(
                ["time", "-model", net_path, "-iterations", "10", "-phase",
                 "TRAIN", "-device", "cuda"]))
        if set(tested) != {"accuracy", "loss"} or \
                not all(np.isfinite(list(tested.values()))):
            fail(f"cli test on the val LMDB: {tested}")
        if not (timed["forward_backward_ms"] and timed["mfu"]):
            fail(f"cli time gave no whole step or MFU: {timed}")
        log(f"cli test: {json.dumps(tested)}")
        log(f"cli time: {json.dumps(timed)}")
        from caffe_mpi_tpu_torch.tools import device_query
        devices = device_query.query()
        if len(devices) != torch.cuda.device_count() or \
                devices[0]["name"] != torch.cuda.get_device_name(0):
            fail(f"device_query: {devices}")

        from caffe_mpi_tpu_torch.data import decode
        jpeg_runs = {}
        for tag, copy_fn in (("jpeg", _caffenet_copy),
                             ("jpeg_host", _jpeg_host_copy)):
            _, jsolver = copy_fn(tmp, jpeg_db, val_db, mean, tag)
            torch.cuda.empty_cache()
            decode.STATS.reset()
            _reset_kernel_counts()
            jpeg_solver, run = cli.train(cli.parse_args(
                ["train", "-solver", jsolver, "-max_iter", str(JPEG_ITERS),
                 "-snapshot_prefix", os.path.join(tmp, tag), "-device",
                 "cuda"]))
            torch.cuda.synchronize()
            jcounts = _kernel_counts()
            run["decode_stats"] = decode.STATS.snapshot()
            # JPEG_ITERS < the test interval: one final test pass
            jwant = (2 * (JPEG_ITERS + 2), 2 * JPEG_ITERS, 0, 0, 0)
            if jcounts != jwant:
                fail(f"{tag} train launched K1-K5 {jcounts}, want {jwant}")
            k1["launches_by_path"][f"train_caffenet_{tag}_lmdb"] = jcounts[0]
            k2["launches_by_path"][f"train_caffenet_{tag}_lmdb"] = jcounts[1]
            del jpeg_solver
            log(f"lmdb {tag} train: {json.dumps(run)}")
            if len(run["losses"]) != JPEG_ITERS or \
                    not np.all(np.isfinite(run["losses"])):
                fail(f"{tag} train losses {run['losses']}")
            st = run["decode_stats"]
            native_n = st["native_records"] + st["fused_records"]
            if codec["decode_available"]:
                if st["pil_records"] or native_n < JPEG_ITERS * \
                        CAFFENET_BATCH:
                    fail(f"{tag}: native decode counts {st}")
            elif native_n or st["pil_records"] < JPEG_ITERS * \
                    CAFFENET_BATCH:
                fail(f"{tag}: PIL decode counts {st} without the codecs")
            jpeg_runs[tag] = run
        jpeg, jpeg_host = jpeg_runs["jpeg"], jpeg_runs["jpeg_host"]
        if not jpeg["device_transform"] or jpeg_host["device_transform"]:
            fail("the jpeg run transformed on the host or the jpeg_host "
                 "run on the card")
        torch.cuda.empty_cache()
        quarantine = _quarantine_check(tmp, train_db, val_db, mean)
        log(f"quarantine: {json.dumps(quarantine)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    med = summary["median_iter_ms"]
    return {
        "solver": "examples/imagenet/caffenet_solver.prototxt (copy: "
        f"max_iter {LMDB_ITERS}, test_iter 2, test_interval "
        f"{LMDB_TEST_INTERVAL})",
        "batch": CAFFENET_BATCH, "records": LMDB_TRAIN,
        "record_shape": list(LMDB_SHAPE), "train_db_MB": db_mb,
        "write_s": write_s, "iters": LMDB_ITERS, "losses": losses,
        "test_scores": scores, "median_step_ms": med,
        "lmdb_img_per_s": summary["img_per_s"],
        "lmdb_window_img_per_s": summary["window_img_per_s"],
        "step_ms": summary["iter_ms"],
        "feed_ms_per_batch": summary["feed_ms_per_batch"],
        "feed_threads": summary["feed_threads"],
        "synthetic_step_ms": syn_ms,
        "synthetic_img_per_s": CAFFENET_BATCH / (syn_ms / 1e3),
        "synthetic_window_img_per_s": syn_window,
        "jpeg_records": LMDB_JPEG, "jpeg_iters": JPEG_ITERS,
        "jpeg_img_per_s": jpeg["img_per_s"],
        "jpeg_window_img_per_s": jpeg["window_img_per_s"],
        "jpeg_median_step_ms": jpeg["median_iter_ms"],
        "jpeg_feed_ms_per_batch": jpeg["feed_ms_per_batch"],
        "jpeg_feed_threads": jpeg["feed_threads"],
        "jpeg_decode_stats": jpeg["decode_stats"],
        "jpeg_host_img_per_s": jpeg_host["img_per_s"],
        "jpeg_host_window_img_per_s": jpeg_host["window_img_per_s"],
        "jpeg_host_median_step_ms": jpeg_host["median_iter_ms"],
        "jpeg_host_feed_ms_per_batch": jpeg_host["feed_ms_per_batch"],
        "jpeg_host_decode_stats": jpeg_host["decode_stats"],
        "native_codec": codec, "native_gather": gather,
        "decoded_cache": cache, "quarantine": quarantine,
        "feed_lookahead": summary["feed_lookahead"],
        "device_busy": profile.get("device_busy_profiled"),
        "profile": profile, "launches_k1_k5": list(counts),
        "device_transform": transform, "cli_test": tested,
        "time_step_ms": timed["forward_backward_ms"],
        "time_forward_ms": timed["forward_ms"], "time_mfu": timed["mfu"],
        "time_tflops": timed["tflops"], "time_peak_rate": timed["peak_rate"],
        "time_peak_mem_MiB": timed["peak_mem_MiB"],
        "device_query": devices[0],
        "peak_mem_GB": peak_gb, "card": card,
    }


# -- 13. bf16 ------------------------------------------------------------------

ALEXNET_FP16 = os.path.join(ROOT, "models", "alexnet", "solver_fp16.prototxt")
ALEXNET_FP16_NET = os.path.join(ROOT, "models", "alexnet",
                                "train_val_fp16.prototxt")
# the kernels' launchers (where each wrapper launches its kernel), whose
# input dtype the bf16 phases record
LAUNCHERS = (("lrn", "_launch", "lrn_fwd"), ("lrn", "_launch_bwd", "lrn_bwd"),
             ("flash_attention", "_launch_fwd", "flash_fwd"),
             ("flash_attention", "_launch_dq", "flash_bwd_dq"),
             ("flash_attention", "_launch_dkv", "flash_bwd_dkv"))


class _LaunchDtypes:
    """Within the context, the dtypes each kernel launcher was called
    with ({kernel: [dtype, ...]}), recorded around the launchers."""

    def __enter__(self):
        import importlib
        self.seen = {name: set() for _, _, name in LAUNCHERS}
        self._saved = []
        for mod_name, attr, name in LAUNCHERS:
            mod = importlib.import_module(f"caffe_mpi_tpu_torch.ops.{mod_name}")
            orig = getattr(mod, attr)

            def rec(x, *a, _orig=orig, _name=name, **k):
                self.seen[_name].add(str(x.dtype).replace("torch.", ""))
                return _orig(x, *a, **k)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, rec)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self._saved:
            setattr(mod, attr, orig)
        return False

    def dtypes(self) -> dict:
        return {k: sorted(v) for k, v in self.seen.items() if v}


def _bf16_run(tag, solver_path, prefix, iters, extra, want_counts):
    """One CLI train run with the kernel counts set to 0 just before and
    read just after, and the launchers' dtypes recorded: finite losses,
    the counts `want_counts`, every launch in bf16, no skipped step."""
    _reset_kernel_counts()
    with _LaunchDtypes() as probe:
        solver, summary = _train_cli(solver_path, prefix, iters, extra)
        torch.cuda.synchronize()
    counts = _kernel_counts()
    losses = summary["losses"]
    log(f"bf16 {tag}: {json.dumps(summary)}")
    if len(losses) != iters or not np.all(np.isfinite(losses)):
        fail(f"bf16 {tag}: losses {losses}")
    if counts != want_counts:
        fail(f"bf16 {tag}: K1-K5 launched {counts}, want {want_counts}")
    dtypes = probe.dtypes()
    if set(dtypes) != {name for (_, _, name), n in zip(LAUNCHERS, counts)
                       if n} or any(v != ["bfloat16"]
                                    for v in dtypes.values()):
        fail(f"bf16 {tag}: kernels launched in {dtypes}, want bfloat16")
    if summary["skipped_steps"] or summary["overflow_steps"]:
        fail(f"bf16 {tag}: {summary['skipped_steps']} skipped, "
             f"{summary['overflow_steps']} overflow steps, want none")
    nets = {str(l.policy.forward) for l in solver.net.layers}
    del solver
    torch.cuda.empty_cache()
    return {"losses": losses, "median_step_ms": summary["median_iter_ms"],
            "img_per_s": summary["img_per_s"], "step_ms": summary["iter_ms"],
            "launches_k1_k5": list(counts), "launch_dtypes": dtypes,
            "layer_dtypes": sorted(nets), "precision": summary["precision"],
            "loss_scale": summary["loss_scale"],
            "skipped_steps": summary["skipped_steps"],
            "overflow_steps": summary["overflow_steps"]}


def bf16_phase(k1: dict, k2: dict, flash: list[dict], f32: dict,
               card: str) -> dict:
    """(a) AlexNet at batch 256 from models/alexnet/solver_fp16.prototxt
    (the fp16 net's FLOAT16 defaults) and from solver.prototxt under
    `-precision bf16` (dynamic loss scale, the guard armed): 20
    iterations each through the CLI's `train`, K1 twice a forward and K2
    twice an iteration, every launch in bf16, no overflow; step ms and
    img/s beside the f32 run's; `time` on the fp16 net, MFU against the
    dense bf16 peak. (b) transformer_lm with use_flash under `-precision
    bf16`: 20 iterations, K3 twice a forward, K4 and K5 twice an
    iteration, every launch in bf16. (c) ResNet-50 (b32, 53 BatchNorms,
    bf16 statistics kept f32) and GoogLeNet (b128, K1/K2 in bf16) from
    their solver_fp16.prototxt: 20 iterations each. `f32` holds the f32
    phases' results by net, for their step ms."""
    from caffe_mpi_tpu_torch.tools import cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    try:
        lrn_counts = (2 * (TRAIN_ITERS + 2 * TEST_ITER), 2 * TRAIN_ITERS,
                      0, 0, 0)
        fp16 = _bf16_run("alexnet fp16 prototxt", ALEXNET_FP16,
                         os.path.join(tmp, "fp16"), TRAIN_ITERS, (),
                         lrn_counts)
        bf16 = _bf16_run("alexnet -precision bf16", SOLVER,
                         os.path.join(tmp, "bf16"), TRAIN_ITERS,
                         ("-precision", "bf16"), lrn_counts)
        r50 = _bf16_run("resnet50 fp16 prototxt",
                        os.path.join(RESNET_DIR, "solver_fp16.prototxt"),
                        os.path.join(tmp, "r50"), RESNET_ITERS, (),
                        (0, 0, 0, 0, 0))
        goog = _bf16_run(
            "googlenet fp16 prototxt",
            os.path.join(ROOT, "models", "googlenet", "solver_fp16.prototxt"),
            os.path.join(tmp, "goog"), GOOGLENET_ITERS, (),
            (2 * (GOOGLENET_ITERS + 2 * TEST_ITER), 2 * GOOGLENET_ITERS, 0,
             0, 0))
        for run, net in ((fp16, "train"), (bf16, "train"),
                         (r50, "resnet50"), (goog, "googlenet")):
            run["f32_median_step_ms"] = f32[net]["median_step_ms"]
            run["speedup_over_f32"] = f32[net]["median_step_ms"] \
                / run["median_step_ms"]
        k1["launches_by_path"]["train_alexnet_bf16"] = bf16[
            "launches_k1_k5"][0]
        k2["launches_by_path"]["train_alexnet_bf16"] = bf16[
            "launches_k1_k5"][1]
        timed = cli.time_net(cli.parse_args(
            ["time", "-model", ALEXNET_FP16_NET, "-phase", "TRAIN",
             "-iterations", "10", "-device", "cuda"]))
        if not timed["peak_rate"] or timed["peak_rate"]["name"] != \
                "dense bf16" or not timed["mfu"]:
            fail(f"time on the fp16 net: MFU {timed['mfu']} against "
                 f"{timed['peak_rate']}, want the dense bf16 peak")
        tlm_solver = _flash_solver(tmp)
        forwards = TLM_ITERS + TEST_ITER
        tlm = _bf16_run("transformer_lm -precision bf16", tlm_solver,
                        os.path.join(tmp, "tlm"), TLM_ITERS,
                        ("-precision", "bf16"),
                        (0, 0, 2 * forwards, 2 * TLM_ITERS, 2 * TLM_ITERS))
        tlm["tokens_per_s"] = tlm["img_per_s"] * TLM_SEQ
        tlm["f32_median_step_ms"] = f32["transformer"]["median_step_ms"]
        for entry, n in zip(flash, tlm["launches_k1_k5"][2:]):
            entry["launches_by_path"]["train_transformer_lm_bf16"] = n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"alexnet_fp16_prototxt": fp16, "alexnet_precision_bf16": bf16,
            "resnet50_fp16_prototxt": r50, "googlenet_fp16_prototxt": goog,
            "time_fp16": {k: timed[k] for k in (
                "model", "batch", "forward_ms", "forward_backward_ms",
                "tflops", "mfu", "peak_rate", "peak_mem_MiB")},
            "transformer_lm_bf16": tlm, "card": card}


# -- 14. chunk -----------------------------------------------------------------

CHUNK = 10
CHUNK_ITERS = 20
# graph against eager: each tensor's distance from the nearer eager run,
# as a share of its largest element, at most twice the largest such share
# between the two eager runs, plus 1e-6 (f32 ulps where the eager runs
# agree bitwise); the same for the losses
CHUNK_SPREAD, CHUNK_FLOOR = 2.0, 1e-6


class _MaskLog:
    """Within the context, every iteration's Dropout masks as the solver
    drew them (the masks both the eager iteration and a graph replay
    read), kept on the device."""

    def __enter__(self):
        from caffe_mpi_tpu_torch.solver import solver as solver_mod
        self.cls, self.masks = solver_mod.Solver, {}
        self.orig = self.cls._masks
        log_ = self.masks

        def rec(solver, it, given):
            out = self.orig(solver, it, given)
            log_[it] = [{k: v.clone() for k, v in m.items()} for m in out]
            return out
        self.cls._masks = rec
        return self

    def __exit__(self, *exc):
        self.cls._masks = self.orig
        return False


def _chunk_run(path, prefix, k, extra=()):
    """A CLI train run at step_chunk k: (solver, summary, K1-K5 counts,
    state on the host, masks by iteration)."""
    _reset_kernel_counts()
    with _MaskLog() as masks:
        solver, summary = _train_cli(path, prefix, CHUNK_ITERS,
                                     ("-step_chunk", str(k), *extra))
        torch.cuda.synchronize()
    if len(summary["losses"]) != CHUNK_ITERS or \
            not np.all(np.isfinite(summary["losses"])):
        fail(f"chunk {path} K={k}: losses {summary['losses']}")
    return solver, summary, _kernel_counts(), _state(solver), masks.masks


def _timed_steps(solver, feed_fn, n: int = CHUNK_ITERS) -> dict:
    """n more iterations: ms an iteration (host clock to the last chunk's
    read-back), and the host syncs the CUDA sync debugger reported
    against the chunks run."""
    import warnings
    d0 = solver.dispatch_count
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            solver.step(n, feed_fn)
            ms = (time.perf_counter() - t0) * 1e3 / n
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    return {"ms_per_iter": ms, "chunks": solver.dispatch_count - d0,
            "host_syncs": len(where), "sync_sites": sorted(set(where))}


def _chunk_case(name, path, card, extra=()) -> dict:
    """step_chunk 10 against 1 on one solver: two eager runs (K = 1) and
    one of graph replays (K = 10) from the same seed and feeds; the
    graph's losses and final params, slots and statistics within the
    eager runs' spread, its Dropout masks the eager path's, its kernel
    launches the eager run's (captured x replays), one host sync a chunk;
    then step ms and the card's busy share at K = 1 and K = 10."""
    from caffe_mpi_tpu_torch.tools import cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_chunk_")
    try:
        e1, s1, c1, st1, m1 = _chunk_run(path, os.path.join(tmp, "e1"), 1,
                                         extra)
        del e1
        torch.cuda.empty_cache()
        e2, s2, c2, st2, m2 = _chunk_run(path, os.path.join(tmp, "e2"), 1,
                                         extra)
        g, sg, cg, stg, mg = _chunk_run(path, os.path.join(tmp, "g"), CHUNK,
                                        extra)
        if not g.graph_replays or not g._graphs:
            fail(f"chunk {name}: no graph replayed")
        if c1 != c2 or cg != c1:
            fail(f"chunk {name}: K1-K5 launches eager {c1} / {c2}, graph "
                 f"{cg}")
        graph = next(iter(g._graphs.values()))
        deltas = {c.__name__: n for c, n in graph.deltas.items()}
        # masks: the graph run's every iteration equal to the eager run's,
        # and the graph's static buffers hold the last iteration's
        bad_masks = [it for it in m1 if any(
            not torch.equal(a[k], b[k]) for a, b in zip(m1[it], mg[it])
            for k in a)]
        last = mg[max(mg)]
        if bad_masks or any(not torch.equal(graph.masks[i][k], last[i][k])
                            for i in range(len(last)) for k in last[i]):
            fail(f"chunk {name}: graph masks differ at {bad_masks[:5]}")
        # each tensor's distance as a share of its largest element: the
        # graph run's from the nearer eager run against the eager runs'
        # own, the largest over all tensors on each side
        worst, bad = {}, []
        for key in st1:
            scale = max(float(st1[key].float().abs().max()), 1e-30)
            spread = float((st2[key].float() - st1[key].float()).abs()
                           .max()) / scale
            diff = min(float((stg[key].float() - st[key].float()).abs()
                             .max()) for st in (st1, st2)) / scale
            worst[key] = (diff, spread)
        diff = max(d for d, _ in worst.values())
        spread = max(sp for _, sp in worst.values())
        limit = CHUNK_SPREAD * spread + CHUNK_FLOOR
        if diff > limit:
            bad.append(f"state: {diff:.3g} > {limit:.3g} of the largest "
                       "element")
        l1, l2, lg = (np.array(x["losses"]) for x in (s1, s2, sg))
        l_diff = float(np.max(np.minimum(np.abs(lg - l1), np.abs(lg - l2))
                              / np.abs(l1)))
        l_limit = CHUNK_SPREAD * float(np.max(np.abs(l2 - l1)
                                              / np.abs(l1))) + CHUNK_FLOOR
        if l_diff > l_limit:
            bad.append(f"losses {lg.tolist()} vs eager {l1.tolist()}")
        if bad:
            fail(f"chunk {name}: graph against eager: {bad}")
        del st1, st2, stg, m1, m2, mg
        feeds = cli.synthetic_feed(g.net)
        feed_fn = lambda it: feeds  # noqa: E731
        # timed in mirrored order, warm: eager, graph, graph, eager
        timing = {"k1": [], "k10": []}
        for which in ("k1", "k10", "k10", "k1"):
            timing[which].append(_timed_steps(e2 if which == "k1" else g,
                                              feed_fn))
        for t in timing["k10"]:
            if t["host_syncs"] != t["chunks"]:
                fail(f"chunk {name}: {t['host_syncs']} host syncs in "
                     f"{t['chunks']} chunks at K = {CHUNK} "
                     f"({t['sync_sites']}), want one a chunk")
        prof = {"k1": profile_steps(e2, feed_fn, n=CHUNK),
                "k10": profile_steps(g, feed_fn, n=CHUNK)}
        out = {
            "losses_eager": s1["losses"], "losses_graph": sg["losses"],
            "launches_k1_k5": list(cg), "captured_launches": deltas,
            "graph_replays": g.graph_replays,
            "dispatch_count": sg["dispatch_count"],
            "host_sync_count": sg["host_sync_count"],
            "state_diff": diff, "state_spread": spread,
            "state_limit": limit, "loss_diff": l_diff,
            "loss_limit": l_limit,
            "worst": sorted(((k, d, sp) for k, (d, sp) in worst.items()),
                            key=lambda r: -r[1])[:5],
            "step_ms": {k: [t["ms_per_iter"] for t in v]
                        for k, v in timing.items()},
            "host_syncs": {k: [[t["host_syncs"], t["chunks"]] for t in v]
                           for k, v in timing.items()},
            "sync_sites": {k: sorted({x for t in v for x in t["sync_sites"]})
                           for k, v in timing.items()},
            "device_busy": {k: (p["device_ms_per_step"]
                                / p["wall_ms_per_step"])
                            if isinstance(p["device_ms_per_step"], float)
                            else "not measured" for k, p in prof.items()},
            "device_ms_per_step": {k: p["device_ms_per_step"]
                                   for k, p in prof.items()},
            "card": card,
        }
        k1_ms = float(np.median(out["step_ms"]["k1"]))
        k10_ms = float(np.median(out["step_ms"]["k10"]))
        out["median_step_ms"] = {"k1": k1_ms, "k10": k10_ms}
        out["speedup_k10"] = k1_ms / k10_ms
        log(f"chunk {name}: {json.dumps(out)}")
        del e2, g
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def chunk_phase(k1: dict, k2: dict, flash: list[dict], card: str) -> dict:
    """step_chunk 10 as CUDA graph replays on AlexNet (b256, K1/K2 in the
    graph), ResNet-50 (b32, 53 BatchNorms' statistics updated in the
    graph) and transformer_lm with use_flash (K3-K5 in the graph, Adam)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_chunk_tlm_")
    try:
        res = {
            "alexnet": _chunk_case("alexnet", SOLVER, card),
            "resnet50": _chunk_case(
                "resnet50", os.path.join(RESNET_DIR, "solver.prototxt"),
                card),
            "transformer_lm": _chunk_case("transformer_lm",
                                          _flash_solver(tmp), card),
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = res["alexnet"]["launches_k1_k5"]
    k1["launches_by_path"]["train_alexnet_chunk10"] = counts[0]
    k2["launches_by_path"]["train_alexnet_chunk10"] = counts[1]
    for entry, n in zip(flash, res["transformer_lm"]["launches_k1_k5"][2:]):
        entry["launches_by_path"]["train_transformer_lm_chunk10"] = n
    return res


# -- 15. overflow --------------------------------------------------------------

def overflow_phase() -> dict:
    """A dynamic-scale overflow injected on the card: AlexNet at batch 256
    under precision bf16 and step_chunk 10 (graph replays), NaN batches at
    iterations 3 and 4. Both are skipped (params and slots bitwise
    unchanged across them), counted as overflows, and halve the scale to
    2^13; 8 clean steps (loss_scale_window 4) grow it back to 2^15, with
    finite losses."""
    from caffe_mpi_tpu_torch.proto import SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.tools import cli

    sp = SolverParameter.from_file(SOLVER)
    sp.precision, sp.step_chunk, sp.loss_scale_window = "bf16", CHUNK, 4
    solver = Solver(sp, device="cuda")
    feeds = cli.synthetic_feed(solver.net)
    bad = dict(feeds, data=torch.full_like(feeds["data"], float("nan")))
    feed_fn = lambda it: bad if it in (3, 4) else feeds  # noqa: E731
    solver.step(3, feed_fn)
    before = _state(solver)
    solver.step(2, feed_fn)
    after = _state(solver)
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    scale_after_burst = solver.loss_scale_value
    solver.step(8, feed_fn)
    res = {"skipped_iters": solver.skipped_iters,
           "overflow_steps": solver.overflow_steps,
           "scale_after_burst": scale_after_burst,
           "scale_after_recovery": solver.loss_scale_value,
           "losses": solver.losses, "graph_replays": solver.graph_replays,
           "changed_by_skipped_steps": changed[:5]}
    log(f"overflow: {json.dumps(res)}")
    accepted = [l for i, l in enumerate(solver.losses) if i not in (3, 4)]
    if solver.skipped_iters != [3, 4] or solver.overflow_steps != 2 or \
            scale_after_burst != 2.0 ** 13 or changed or \
            solver.loss_scale_value != 2.0 ** 15 or \
            not np.all(np.isfinite(accepted)) or not solver.graph_replays:
        fail(f"overflow on the card: {res}")
    del solver
    torch.cuda.empty_cache()
    return res


# -- 16. leveldb ----------------------------------------------------------------

LEVELDB_COMPARE_BATCHES = 4


def _data_lp(solver, source, backend):
    """A copy of the train net's Data layer over another database."""
    lp = copy.deepcopy(solver.net.layers[0].lp)
    lp.data_param.source = source
    lp.data_param.backend = backend
    return lp


def _leveldb_against_lmdb(solver, leveldb, lmdb) -> dict:
    """The first LEVELDB_COMPARE_BATCHES TRAIN batches (raw stack,
    decisions, labels) of the train net's Feeder over the LevelDB against
    the same records read from an LMDB the LMDB phase's recipe writes:
    bitwise."""
    from caffe_mpi_tpu_torch.data.feeder import feeder_from_layer
    feeders = [feeder_from_layer(_data_lp(solver, src, backend), "TRAIN",
                                 device_transform=True)
               for src, backend in ((leveldb, "LEVELDB"), (lmdb, "LMDB"))]
    try:
        for it in range(LEVELDB_COMPARE_BATCHES):
            got, want = (f._build_batch_inner(it) for f in feeders)
            if list(got) != list(want) or not all(
                    np.array_equal(got[k], want[k]) for k in want):
                fail(f"leveldb batch {it} differs from the LMDB's")
    finally:
        for f in feeders:
            f.close()
    return {"batches": LEVELDB_COMPARE_BATCHES, "bitwise": True}


def _leveldb_quarantine_check(solver, tmp, train_db) -> dict:
    """A copy of the train LevelDB whose block holding record
    QUARANTINE_RECORD rots after the Feeder opened it (the open reads
    every block for the key index, so a block bad at the open fails the
    open, as in the JAX package): the read fails its masked crc32c, the
    Feeder substitutes the next record and journals it, and
    QUARANTINE_ITERS more iterations train on with finite losses."""
    from caffe_mpi_tpu_torch.data.feeder import DeviceFeed, feeder_from_layer
    from caffe_mpi_tpu_torch.data.leveldb_io import LevelDBReader
    from caffe_mpi_tpu_torch.utils.resilience import (
        QUARANTINE, quarantine_journal_path)
    bad_db = os.path.join(tmp, "corrupt_leveldb")
    shutil.copytree(train_db, bad_db)
    feeder = feeder_from_layer(_data_lp(solver, bad_db, "LEVELDB"), "TRAIN",
                               device_transform=True)
    reader = LevelDBReader(bad_db)
    table = reader._tables[0]
    # one record a block: each record is larger than the block size
    off, size = list(table.block_handles())[QUARANTINE_RECORD]
    path = table.path
    reader.close()
    with open(path, "r+b") as f:
        f.seek(off + size // 2)
        b = f.read(1)
        f.seek(off + size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    journal = quarantine_journal_path(os.path.join(tmp, "leveldb_corrupt"))
    QUARANTINE.configure(journal)
    feed = DeviceFeed(feeder, solver.device)
    start, n0 = solver.iter, len(solver.losses)
    try:
        solver.step(QUARANTINE_ITERS, lambda it: feed(it - start))
    finally:
        feed.close()
        QUARANTINE.flush()
    entries = [(e["index"], e["substitute"], e["reason"])
               for e in QUARANTINE.entries]
    QUARANTINE.configure(None)
    losses = solver.losses[n0:]
    if [e[:2] for e in entries] != [(QUARANTINE_RECORD,
                                     QUARANTINE_RECORD + 1)] or \
            "crc32c" not in entries[0][2] or not os.path.isfile(journal):
        fail(f"leveldb quarantine journal {entries}")
    if len(losses) != QUARANTINE_ITERS or not np.all(np.isfinite(losses)):
        fail(f"the run over the rotting LevelDB: {losses}")
    return {"record": QUARANTINE_RECORD, "journal": [e[:2] for e in entries],
            "reason": entries[0][2], "iters": QUARANTINE_ITERS,
            "losses": losses}


def _caffenet_run(tag, solver_path, prefix, k1, k2, iters, extra=()):
    """CaffeNet through the CLI's `train`, K1/K2 counted (set to 0 just
    before, read just after): finite losses, test scores, K1 twice a
    forward and K2 twice an iteration (a final test pass of 2 batches, and
    one at LMDB_TEST_INTERVAL when the run reaches it)."""
    from caffe_mpi_tpu_torch.tools import cli
    torch.cuda.empty_cache()
    _reset_kernel_counts()
    solver, summary = cli.train(cli.parse_args(
        ["train", "-solver", solver_path, "-snapshot_prefix", prefix,
         "-max_iter", str(iters), "-test_iter", "2", "-device", "cuda",
         *extra]))
    torch.cuda.synchronize()
    counts = _kernel_counts()
    losses = summary["losses"]
    if summary["batch"] != CAFFENET_BATCH or len(losses) != iters or \
            not np.all(np.isfinite(losses)):
        fail(f"{tag} train: {len(losses)} iterations at batch "
             f"{summary['batch']}, losses {losses}")
    scores = summary["test_scores"]
    if not scores or set(scores[0]) != {"accuracy", "loss"} or \
            not all(np.isfinite(list(scores[0].values()))):
        fail(f"{tag} train test scores {scores}")
    passes = 1 + (iters > LMDB_TEST_INTERVAL)
    want = (2 * (iters + 2 * passes), 2 * iters, 0, 0, 0)
    if counts != want:
        fail(f"{tag} train launched K1-K5 {counts}, want {want}")
    k1["launches_by_path"][f"train_{tag}"] = counts[0]
    k2["launches_by_path"][f"train_{tag}"] = counts[1]
    return solver, summary, counts


def _feed_summary(summary, profile, counts, card) -> dict:
    return {"median_step_ms": summary["median_iter_ms"],
            "img_per_s": summary["img_per_s"],
            "window_img_per_s": summary["window_img_per_s"],
            "step_ms": summary["iter_ms"], "losses": summary["losses"],
            "test_scores": summary["test_scores"],
            "feed_ms_per_batch": summary["feed_ms_per_batch"],
            "feed_threads": summary["feed_threads"],
            "device_busy": profile.get("device_busy_profiled"),
            "profile": profile, "launches_k1_k5": list(counts),
            "card": card}


def leveldb_phase(k1: dict, k2: dict, card: str) -> dict:
    """CaffeNet (examples/imagenet/caffenet_solver.prototxt and its net as
    written, `backend: LEVELDB`) from a train LevelDB of 1,280 raw
    3x256x256 Datums and a val LevelDB of 100, written by the port's
    write_leveldb (snappy blocks) from the LMDB phase's seeded clusters,
    through the CLI's `train`: 20 iterations, the device transform, K1/K2
    counted; the busy share under the profiler; the first 4 batches
    bitwise those of the same records in an LMDB; a block rotting after
    the open quarantined, not fatal."""
    from caffe_mpi_tpu_torch.data import leveldb_io
    from caffe_mpi_tpu_torch.data.feeder import DeviceFeed
    from caffe_mpi_tpu_torch.tools import cli, compute_image_mean
    import contextlib
    tmp = tempfile.mkdtemp(prefix="chip_smoke_leveldb_")
    try:
        t0 = time.perf_counter()
        train_db = os.path.join(tmp, "train_leveldb")
        val_db = os.path.join(tmp, "val_leveldb")
        leveldb_io.write_leveldb(train_db, _cluster_records(LMDB_TRAIN, 7),
                                 compress=True)
        leveldb_io.write_leveldb(val_db, _cluster_records(LMDB_VAL, 100_000),
                                 compress=True)
        write_s = time.perf_counter() - t0
        lmdb_db = os.path.join(tmp, "train_lmdb")
        _write_clusters(lmdb_db, LMDB_TRAIN, seed=7)
        mean = os.path.join(tmp, "mean.binaryproto")
        with contextlib.redirect_stdout(sys.stderr):
            compute_image_mean.main([lmdb_db, mean])
        db_mb = sum(os.path.getsize(os.path.join(train_db, f))
                    for f in os.listdir(train_db)) / 1e6
        log(f"leveldb: wrote {LMDB_TRAIN} + {LMDB_VAL} raw records "
            f"({db_mb:.1f} MB) in {write_s:.1f} s")
        _, solver_path = _caffenet_copy(
            tmp, train_db, val_db, mean, "leveldb",
            edits=(("backend: LMDB", "backend: LEVELDB"),))
        solver, summary, counts = _caffenet_run(
            "caffenet_leveldb", solver_path, os.path.join(tmp, "c"), k1, k2,
            LMDB_ITERS)
        if summary["data"] != "dataset" or not summary["device_transform"]:
            fail(f"leveldb train: {summary['data']}, device transform "
                 f"{summary['device_transform']}")
        feed = DeviceFeed(cli.build_feeder(solver.net, "TRAIN"),
                          solver.device)
        try:
            profile = profile_steps(solver, feed)
        finally:
            feed.close()
        same = _leveldb_against_lmdb(solver, train_db, lmdb_db)
        quarantine = _leveldb_quarantine_check(solver, tmp, train_db)
        del solver
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out = _feed_summary(summary, profile, counts, card)
    out.update(records=LMDB_TRAIN, train_db_MB=db_mb, write_s=write_s,
               iters=LMDB_ITERS, against_lmdb=same, quarantine=quarantine)
    log(f"leveldb: {json.dumps(out)}")
    return out


# -- 17. imagedata ----------------------------------------------------------------

IMAGES_PNG, IMAGES_JPEG, IMAGEDATA_ITERS = 256, 256, 8


def _write_image_list(tmp) -> tuple[str, str]:
    """IMAGES_PNG PNG and IMAGES_JPEG JPEG files (3x256x256) that PIL
    writes from the seeded clusters, and the ImageData list over them."""
    from PIL import Image
    root = os.path.join(tmp, "images")
    os.makedirs(root)
    lines = []
    n = IMAGES_PNG + IMAGES_JPEG
    for lo, imgs, labels in _cluster_images(n, 7):
        for i, (img, label) in enumerate(zip(imgs, labels)):
            k = lo + i
            name = f"im{k:05d}." + ("png" if k < IMAGES_PNG else "jpg")
            Image.fromarray(np.ascontiguousarray(
                img[::-1].transpose(1, 2, 0))).save(os.path.join(root, name))
            lines.append(f"{name} {label}")
    source = os.path.join(tmp, "images.txt")
    with open(source, "w") as f:
        f.write("\n".join(lines) + "\n")
    return source, root + "/"


def imagedata_phase(k1: dict, k2: dict, card: str) -> dict:
    """CaffeNet with its Data layers replaced by ImageData (new_height and
    new_width 256, shuffle in TRAIN) over 256 PNG and 256 JPEG files,
    through the CLI's `train`: 8 iterations and a test pass of 2 batches,
    K1/K2 counted, the host transform; decode.STATS printed (PIL records
    where the library has no codecs, as on the card's machine)."""
    from caffe_mpi_tpu_torch import native
    from caffe_mpi_tpu_torch.data import decode
    from caffe_mpi_tpu_torch.data.feeder import DeviceFeed
    from caffe_mpi_tpu_torch.tools import cli, compute_image_mean
    import contextlib
    tmp = tempfile.mkdtemp(prefix="chip_smoke_imagedata_")
    try:
        t0 = time.perf_counter()
        source, root = _write_image_list(tmp)
        write_s = time.perf_counter() - t0
        lmdb_db = os.path.join(tmp, "mean_lmdb")
        _write_clusters(lmdb_db, 256, seed=7)
        mean = os.path.join(tmp, "mean.binaryproto")
        with contextlib.redirect_stdout(sys.stderr):
            compute_image_mean.main([lmdb_db, mean])
        param = ('image_data_param {{ source: "{}" root_folder: "{}" '
                 'batch_size: {} new_height: 256 new_width: 256 {}}}')
        edits = (
            ('type: "Data"', 'type: "ImageData"'),
            (f'data_param {{ source: "TRAIN_DB" batch_size: {CAFFENET_BATCH}'
             ' backend: LMDB }', param.format(source, root, CAFFENET_BATCH,
                                              "shuffle: true ")),
            (f'data_param {{ source: "VAL_DB" batch_size: '
             f'{CAFFENET_TEST_BATCH} backend: LMDB }}',
             param.format(source, root, CAFFENET_TEST_BATCH, "")))
        _, solver_path = _caffenet_copy(tmp, "TRAIN_DB", "VAL_DB", mean,
                                        "imagedata", edits=edits)
        decode.STATS.reset()
        solver, summary, counts = _caffenet_run(
            "caffenet_imagedata", solver_path, os.path.join(tmp, "c"), k1,
            k2, IMAGEDATA_ITERS)
        stats = decode.STATS.snapshot()
        if summary["device_transform"]:
            fail("imagedata ran a device transform")
        images = CAFFENET_BATCH * IMAGEDATA_ITERS
        if native.decode_available():
            if stats["native_records"] < images:
                fail(f"imagedata native decode counts {stats}")
        elif stats["native_records"] or stats["pil_records"] < images:
            fail(f"imagedata: PIL decode counts {stats} without the codecs")
        feed = DeviceFeed(cli.build_feeder(solver.net, "TRAIN"),
                          solver.device)
        try:
            profile = profile_steps(solver, feed)
        finally:
            feed.close()
        del solver
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out = _feed_summary(summary, profile, counts, card)
    out.update(png=IMAGES_PNG, jpeg=IMAGES_JPEG, write_s=write_s,
               iters=IMAGEDATA_ITERS, decode_stats=stats,
               decode_available=native.decode_available())
    log(f"imagedata: {json.dumps(out)}")
    return out


# -- 18. rcnn ---------------------------------------------------------------------

RCNN = os.path.join(ROOT, "models", "rcnn", "deploy.prototxt")
RCNN_IMAGES, RCNN_WINDOWS, RCNN_ITERS, RCNN_BATCH = 64, 30, 10, 128
RCNN_CLASSES = 200


def _write_windows(tmp) -> tuple[str, str]:
    """RCNN_IMAGES PNG files of PASCAL's size (3x375x500) from seeded
    noise, and a window file of RCNN_WINDOWS windows each: class
    indices 1..199 (0 is background), overlaps uniform in [0, 1], boxes of
    20-300 pixels anywhere on the image."""
    from PIL import Image
    r = np.random.RandomState(17)
    root = os.path.join(tmp, "voc")
    os.makedirs(root)
    lines = []
    for i in range(RCNN_IMAGES):
        img = r.randint(0, 256, (375, 500, 3)).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"{i:06d}.png"))
        lines += [f"# {i}", f"{i:06d}.png", "3 375 500", str(RCNN_WINDOWS)]
        for _ in range(RCNN_WINDOWS):
            w, h = r.randint(20, 300), r.randint(20, 300)
            x1, y1 = r.randint(0, 500 - w), r.randint(0, 375 - h)
            lines.append(f"{r.randint(1, RCNN_CLASSES)} {r.rand():.4f} "
                         f"{x1} {y1} {x1 + w - 1} {y1 + h - 1}")
    source = os.path.join(tmp, "window_file.txt")
    with open(source, "w") as f:
        f.write("\n".join(lines) + "\n")
    return source, root + "/"


def _rcnn_copy(tmp, source, root) -> str:
    """The layers of models/rcnn/deploy.prototxt as written, the Input
    replaced by WindowData in the shape of the reference's
    finetune_pascal_detection, a SoftmaxWithLoss on fc-rcnn; and a
    solver over it (the reference's fine-tuning recipe: base_lr 0.001,
    momentum 0.9, weight_decay 0.0005, step)."""
    with open(RCNN) as f:
        text = f.read()
    first = text.index("layer {")
    second = text.index("layer {", first + 1)
    if 'type: "Input"' not in text[first:second]:
        fail(f"{RCNN} no longer starts with its Input layer")
    window = (
        'layer { name: "data" type: "WindowData" top: "data" top: "label" '
        'transform_param { mirror: true crop_size: 227 mean_value: 104 '
        'mean_value: 117 mean_value: 123 } '
        f'window_data_param {{ source: "{source}" root_folder: "{root}" '
        f'batch_size: {RCNN_BATCH} fg_threshold: 0.5 bg_threshold: 0.5 '
        'fg_fraction: 0.25 context_pad: 16 crop_mode: "warp" } }\n')
    loss = ('layer { name: "loss" type: "SoftmaxWithLoss" '
            'bottom: "fc-rcnn" bottom: "label" top: "loss" }\n')
    net = text[:first] + window + text[second:] + loss
    net_path = os.path.join(tmp, "rcnn_finetune.prototxt")
    with open(net_path, "w") as f:
        f.write(net)
    solver_path = os.path.join(tmp, "rcnn_solver.prototxt")
    with open(solver_path, "w") as f:
        f.write(f'net: "{net_path}"\nbase_lr: 0.001\nlr_policy: "step"\n'
                'gamma: 0.1\nstepsize: 20000\ndisplay: 20\n'
                f'max_iter: {RCNN_ITERS}\nmomentum: 0.9\n'
                'weight_decay: 0.0005\nsnapshot: 0\nrandom_seed: 5\n')
    return solver_path


def rcnn_phase(k1: dict, k2: dict, card: str) -> dict:
    """R-CNN fine-tuning from a window file at full width: the layers of
    models/rcnn/deploy.prototxt (200 outputs) with WindowData (batch 128,
    crop 227, context_pad 16, warp, fg/bg threshold 0.5, fg_fraction
    0.25, mirror, mean values) over 64 seeded 3x375x500 PNG images with 30
    windows each, through the CLI's `train`: 10 iterations, K1 twice a
    forward and K2 twice an iteration (counts set to 0 just before, read
    just after); each batch's fg share (the WindowFeeder's batches are a
    function of the iteration: rebuilt and timed after the run), the
    busy share under the profiler."""
    from caffe_mpi_tpu_torch.data.feeder import DeviceFeed
    from caffe_mpi_tpu_torch.tools import cli
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rcnn_")
    try:
        t0 = time.perf_counter()
        source, root = _write_windows(tmp)
        write_s = time.perf_counter() - t0
        solver_path = _rcnn_copy(tmp, source, root)
        torch.cuda.empty_cache()
        _reset_kernel_counts()
        solver, summary = cli.train(cli.parse_args(
            ["train", "-solver", solver_path, "-snapshot_prefix",
             os.path.join(tmp, "r"), "-device", "cuda"]))
        torch.cuda.synchronize()
        counts = _kernel_counts()
        losses = summary["losses"]
        if len(losses) != RCNN_ITERS or summary["batch"] != RCNN_BATCH or \
                not np.all(np.isfinite(losses)):
            fail(f"rcnn train: {summary['batch']} x {len(losses)}, "
                 f"losses {losses}")
        want = (2 * RCNN_ITERS, 2 * RCNN_ITERS, 0, 0, 0)
        if counts != want:
            fail(f"rcnn train launched K1-K5 {counts}, want {want}")
        k1["launches_by_path"]["train_rcnn_windowdata"] = counts[0]
        k2["launches_by_path"]["train_rcnn_windowdata"] = counts[1]
        feeder = cli.build_feeder(solver.net, "TRAIN")
        fg, build_ms = [], []
        for it in range(RCNN_ITERS):
            t1 = time.perf_counter()
            batch = feeder(it)
            build_ms.append((time.perf_counter() - t1) * 1e3)
            fg.append(float(np.mean(batch["label"] > 0)))
        want_fg = round(RCNN_BATCH * 0.25) / RCNN_BATCH
        if any(abs(f - want_fg) > 1e-9 for f in fg):
            fail(f"rcnn fg share {fg}, want {want_fg} every batch")
        if batch["data"].shape != (RCNN_BATCH, 3, 227, 227):
            fail(f"rcnn batch {batch['data'].shape}")
        feed = DeviceFeed(feeder, solver.device)
        try:
            profile = profile_steps(solver, feed)
        finally:
            feed.close()
        del solver
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out = _feed_summary(summary, profile, counts, card)
    out.update(images=RCNN_IMAGES, windows_per_image=RCNN_WINDOWS,
               batch=RCNN_BATCH, iters=RCNN_ITERS, write_s=write_s,
               fg_share=fg, feed_ms_per_batch=float(np.median(build_ms)),
               feed_ms=build_ms)
    log(f"rcnn: {json.dumps(out)}")
    return out


# -- 19. detectnet ----------------------------------------------------------------

KITTI = os.path.join(ROOT, "examples", "kitti", "detectnet_tiny.prototxt")
SIAMESE = os.path.join(ROOT, "examples", "siamese",
                       "mnist_siamese.prototxt")
DETECTNET_ITERS, DETECTNET_CHUNK_ITERS, SIAMESE_ITERS = 200, 20, 100
KITTI_H, KITTI_W, KITTI_MAX_BOXES = 64, 128, 8


def _kitti_scene(r):
    """examples/kitti/run.py's synthetic scene (a copy): dark noise and
    1-3 bright rectangles, class 1; (CHW float image, (n, 5) bboxes)."""
    img = r.randint(0, 60, (3, KITTI_H, KITTI_W)).astype(np.float32)
    boxes = []
    for _ in range(r.randint(1, 4)):
        w, h = r.randint(20, 48), r.randint(12, 28)
        x1 = r.randint(0, KITTI_W - w)
        y1 = r.randint(0, KITTI_H - h)
        color = r.randint(170, 256, 3)[:, None, None]
        img[:, y1:y1 + h, x1:x1 + w] = color + r.randint(
            -15, 16, (3, h, w))
        boxes.append([1, x1, y1, x1 + w, y1 + h])
    return np.clip(img, 0, 255), np.asarray(boxes, np.float32)


def _kitti_feed(batch, seed_base=0):
    """run.py's make_feed: iteration -> {data, label (DIGITS blobs)} on
    the card."""
    from caffe_mpi_tpu_torch.layers.detection import encode_label_blob

    def feed(it):
        r = np.random.RandomState(seed_base + it)
        imgs, labels = [], []
        for _ in range(batch):
            img, boxes = _kitti_scene(r)
            imgs.append(img)
            labels.append(encode_label_blob(boxes, KITTI_MAX_BOXES))
        return {"data": torch.from_numpy(np.stack(imgs)).cuda(),
                "label": torch.from_numpy(np.stack(labels)).cuda()}
    return feed


def _kitti_solver(chunk=1, iters=DETECTNET_ITERS):
    """run.py's solver (Adam, base_lr 0.001, fixed, random_seed 3) over
    the net as written."""
    from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    sp = SolverParameter.from_text(
        'type: "Adam" base_lr: 0.001 momentum: 0.9 momentum2: 0.999 '
        f'lr_policy: "fixed" display: 0 max_iter: {iters} random_seed: 3 '
        f'step_chunk: {chunk}')
    sp.net_param = NetParameter.from_file(KITTI)
    return Solver(sp, device="cuda")


@torch.no_grad()
def _kitti_losses(solver, feeds) -> dict:
    """The coverage loss and the masked bbox L1 of the TRAIN net on a
    fixed batch, its augmentation seed fixed."""
    blobs, _ = solver.net(feeds, dropout_masks={"train_transform": 11})
    return {"coverage_loss": float(blobs["coverage_loss"]),
            "bbox_l1": float(blobs["bbox_loss"])}


def detectnet_phase(card: str) -> dict:
    """examples/kitti/detectnet_tiny.prototxt as written (b8, 3x64x128,
    stride-8 coverage) on chip_smoke's copy of run.py's seeded scenes,
    with run.py's solver: DETECTNET_ITERS iterations (the
    DetectNetTransformation layer a host step on every one); the coverage
    loss and the masked bbox L1 on a held-out batch at the start and the
    end, both must fall. Then DETECTNET_CHUNK_ITERS iterations from the
    same seed at step_chunk 1 and at step_chunk 10 (each chunk eager: the
    host layer is not captured): the same losses."""
    feed = _kitti_feed(8)
    held = _kitti_feed(8, seed_base=10_000)(0)
    solver = _kitti_solver()
    start = _kitti_losses(solver, held)
    t0 = time.perf_counter()
    solver.step(DETECTNET_ITERS, feed)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    end = _kitti_losses(solver, held)
    losses = solver.losses
    if not np.all(np.isfinite(losses)) or not all(
            end[k] < start[k] for k in start):
        fail(f"detectnet: held-out losses {start} -> {end}")
    med = float(np.median(solver.iter_ms[1:]))
    del solver
    runs = {}
    # deterministic cuDNN algorithms for this comparison only, so that the
    # two runs can differ by nothing but the chunking
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for chunk in (1, 10):
            s = _kitti_solver(chunk, DETECTNET_CHUNK_ITERS)
            s.step(DETECTNET_CHUNK_ITERS, feed)
            runs[chunk] = {"losses": list(s.losses),
                           "graph_replays": s.graph_replays,
                           "host_sync_count": s.host_sync_count}
            del s
    finally:
        torch.backends.cudnn.deterministic = saved
    l1, l10 = (np.asarray(runs[k]["losses"]) for k in (1, 10))
    chunk_diff = float(np.max(np.abs(l10 - l1) / np.abs(l1)))
    if runs[10]["graph_replays"] or runs[10]["host_sync_count"] != 2 or \
            chunk_diff > 1e-5:
        fail(f"detectnet step_chunk 10 against 1: {runs}")
    torch.cuda.empty_cache()
    out = {"iters": DETECTNET_ITERS, "batch": 8, "start": start,
           "end": end, "loss_first": losses[0], "loss_last": losses[-1],
           "median_step_ms": med, "train_s": train_s,
           "chunk10_vs_chunk1_max_rel_diff": chunk_diff,
           "chunk10_bitwise": bool(np.array_equal(l1, l10)),
           "chunk_runs": runs, "card": card}
    log(f"detectnet: {json.dumps(out)}")
    return out


# -- 20. siamese ------------------------------------------------------------------

def _siamese_feed(batch, seed_base=0):
    """run.py's pair feed over seeded 1x28x28 clusters (one template a
    class, bounded noise): half similar pairs, half dissimilar, scaled by
    1/256, on the card."""
    r0 = np.random.RandomState(0)
    templates = r0.randint(0, 256, (10, 1, 28, 28)).astype(np.int16)

    def feed(it):
        r = np.random.RandomState(seed_base + it)
        a, b, sim = [], [], []
        for k in range(batch):
            c1 = r.randint(10)
            c2 = c1 if k % 2 == 0 else (c1 + 1 + r.randint(9)) % 10
            a.append(c1)
            b.append(c2)
            sim.append(float(c1 == c2))

        def images(cls):
            noise = r.randint(-40, 41, (batch, 1, 28, 28))
            return torch.from_numpy((np.clip(
                templates[cls] + noise, 0, 255).astype(np.float32)
                / 256.0)).cuda()
        return {"data": images(np.asarray(a)),
                "data_p": images(np.asarray(b)),
                "sim": torch.tensor(sim, dtype=torch.float32).cuda()}
    return feed


def siamese_phase(card: str) -> dict:
    """examples/siamese/mnist_siamese.prototxt as written (b32 pairs,
    28x28, shared conv1/ip1/feat by name) with run.py's solver (the
    reference's mnist_siamese_solver recipe) on seeded clusters for
    SIAMESE_ITERS iterations: the ContrastiveLoss must fall (the mean of
    the last 10 below the mean of the first 10)."""
    from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    sp = SolverParameter.from_text(
        'base_lr: 0.01 momentum: 0.9 weight_decay: 0.0 lr_policy: "inv" '
        f'gamma: 0.0001 power: 0.75 display: 0 max_iter: {SIAMESE_ITERS} '
        'type: "SGD" random_seed: 1')
    sp.net_param = NetParameter.from_file(SIAMESE)
    solver = Solver(sp, device="cuda")
    t0 = time.perf_counter()
    solver.step(SIAMESE_ITERS, _siamese_feed(32))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    losses = solver.losses
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if not np.all(np.isfinite(losses)) or not last < first:
        fail(f"siamese: ContrastiveLoss {first} -> {last}")
    out = {"iters": SIAMESE_ITERS, "batch": 32, "loss_first10": first,
           "loss_last10": last, "median_step_ms": float(np.median(
               solver.iter_ms[1:])), "train_s": train_s, "card": card}
    del solver
    log(f"siamese: {json.dumps(out)}")
    return out


# -- 21. layers -------------------------------------------------------------------

# the layers' f32 tolerances of tests/test_torch_zoo_layers.py: tops rtol
# 1e-5 + 1e-6 of the largest element, gradients rtol 1e-5 + 1e-5 of the
# largest (the same f32 math, reductions in other orders)
ZOO_TOP_TOL, ZOO_GRAD_TOL = (1e-5, 1e-6), (1e-5, 1e-5)
# each layer at the shapes detectnet_tiny (b8) and mnist_siamese (b32) give
# it
ZOO_CASES = {
    "Sigmoid": ('name: "s" type: "Sigmoid" bottom: "x" top: "y"',
                [(8, 1, 8, 16)]),
    "Slice": ('name: "s" type: "Slice" bottom: "x" top: "a" top: "b" '
              'slice_param { axis: 1 slice_point: 1 }', [(8, 5, 8, 16)]),
    "Tile": ('name: "t" type: "Tile" bottom: "x" top: "y" '
             'tile_param { axis: 1 tiles: 4 }', [(8, 1, 8, 16)]),
    "EuclideanLoss": ('name: "l" type: "EuclideanLoss" bottom: "a" '
                      'bottom: "b" top: "loss"',
                      [(8, 1, 8, 16), (8, 1, 8, 16)]),
    "L1Loss": ('name: "l" type: "L1Loss" bottom: "a" bottom: "b" '
               'top: "loss"', [(8, 4, 8, 16), (8, 4, 8, 16)]),
    "ContrastiveLoss": ('name: "l" type: "ContrastiveLoss" bottom: "a" '
                        'bottom: "b" bottom: "sim" top: "loss" '
                        'contrastive_loss_param { margin: 1 }',
                        [(32, 2), (32, 2), "sim"]),
}
# the 27 layer types of slice 15 (and STOCHASTIC pooling), each at a
# CaffeNet-sized activation (256 maps of 13x13 at batch 32) or a
# classifier's scores (batch 64, 200 classes); bottoms: a shape (seeded
# normal), ("pos", shape), ("prob", shape), ("label", n, k), ("binary",
# shape), ("index", n, batch)
ACT, SCORES = (32, 256, 13, 13), (64, 200)
ZOO_REST_CASES = {
    "PReLU": ('type: "PReLU"', [ACT]),
    "ELU": ('type: "ELU" elu_param { alpha: 0.5 }', [ACT]),
    "TanH": ('type: "TanH"', [ACT]),
    "BNLL": ('type: "BNLL"', [ACT]),
    "Power": ('type: "Power" power_param { power: 1.5 scale: 0.5 '
              'shift: 3 }', [ACT]),
    "Exp": ('type: "Exp" exp_param { base: 2 scale: 0.5 }', [ACT]),
    "Log": ('type: "Log"', [("pos", ACT)]),
    "AbsVal": ('type: "AbsVal"', [ACT]),
    "Threshold": ('type: "Threshold" threshold_param { threshold: 0.2 }',
                  [ACT]),
    "Split": ('type: "Split" top: "y2"', [ACT]),
    "Flatten": ('type: "Flatten"', [ACT]),
    "Reshape": ('type: "Reshape" reshape_param { shape { dim: 0 dim: -1 '
                'dim: 169 } }', [ACT]),
    "Reduction": ('type: "Reduction" reduction_param { operation: SUMSQ '
                  'axis: 1 coeff: 0.5 }', [ACT]),
    "ArgMax": ('type: "ArgMax" argmax_param { top_k: 5 out_max_val: true '
               'axis: 1 }', [SCORES]),
    "Silence": ('type: "Silence"', [ACT]),
    "BatchReindex": ('type: "BatchReindex" bottom: "i"',
                     [ACT, ("index", 48, 32)]),
    "SigmoidCrossEntropyLoss": ('type: "SigmoidCrossEntropyLoss" '
                                'bottom: "t"', [SCORES, ("binary", SCORES)]),
    "HingeLoss": ('type: "HingeLoss" bottom: "l" hinge_loss_param { norm: '
                  'L2 }', [SCORES, ("label", 64, 200)]),
    "MultinomialLogisticLoss": ('type: "MultinomialLogisticLoss" '
                                'bottom: "l"', [("prob", SCORES),
                                                ("label", 64, 200)]),
    "InfogainLoss": ('type: "InfogainLoss" bottom: "l" bottom: "h"',
                     [("prob", SCORES), ("label", 64, 200),
                      ("pos", (1, 1, 200, 200))]),
    "MVN": ('type: "MVN"', [ACT]),
    "Deconvolution": ('type: "Deconvolution" convolution_param { '
                      'num_output: 96 kernel_size: 4 stride: 2 pad: 1 '
                      'group: 32 }', [ACT]),
    "Im2col": ('type: "Im2col" convolution_param { kernel_size: 3 pad: 1 '
               '}', [(8, 64, 13, 13)]),
    "Crop": ('type: "Crop" bottom: "ref" crop_param { offset: 1 '
             'offset: 2 }', [ACT, (32, 1, 11, 10)]),
    "SPP": ('type: "SPP" spp_param { pyramid_height: 3 }', [ACT]),
    "Filter": ('type: "Filter" bottom: "s" top: "y2"',
               [ACT, ("binary", (32,))]),
    "Python": ('type: "Python" bottom: "t" python_param { module: '
               '"layers.pyloss" layer: "EuclideanLossLayer" }',
               [SCORES, SCORES]),
    "Pooling_STOCHASTIC": ('type: "Pooling" pooling_param { pool: '
                           'STOCHASTIC kernel_size: 3 stride: 2 }',
                           [("pos", ACT)]),
}


def _zoo_text(body: str) -> str:
    text = f'name: "l" bottom: "x" {body}'
    return text if 'type: "Silence"' in text or 'top: "y"' in text \
        else text + ' top: "y"'


def _zoo_bottoms(specs, seed=3) -> list:
    r = np.random.RandomState(seed)
    out = []
    for s in specs:
        if s == "sim":
            out.append((np.arange(32) % 2).astype(np.float32))
        elif isinstance(s[0], int):
            out.append(r.randn(*s).astype(np.float32))
        elif s[0] == "pos":
            out.append((r.rand(*s[1]) + 0.1).astype(np.float32))
        elif s[0] == "prob":
            z = np.exp(r.randn(*s[1]))
            out.append((z / z.sum(1, keepdims=True)).astype(np.float32))
        elif s[0] == "label":
            out.append(r.randint(0, s[2], s[1]).astype(np.int32))
        elif s[0] == "binary":
            out.append(r.randint(0, 2, s[1]).astype(np.float32))
        elif s[0] == "index":
            out.append(r.randint(0, s[2], s[1]).astype(np.int32))
    return out


def _zoo_run(text, bottoms, device):
    """One layer's tops and the gradients of sum_i <top_i, w_i> by its
    params and float bottoms, on `device`, FLOAT math (no TF32) forward
    and backward; seeded params, and a STOCHASTIC pool's uniforms drawn
    on the host."""
    from caffe_mpi_tpu_torch.core.types import DtypePolicy
    from caffe_mpi_tpu_torch.layers import create_layer
    from caffe_mpi_tpu_torch.proto import LayerParameter
    shapes = [tuple(b.shape) for b in bottoms]
    layer = create_layer(LayerParameter.from_text(text),
                         DtypePolicy(precision="highest"), "TRAIN",
                         torch.device(device))
    layer.in_shapes = shapes
    layer.out_shapes = layer.setup(shapes)
    r = np.random.RandomState(5)
    params = [getattr(layer, n) for n in layer.decls]
    with torch.no_grad():
        for p in params:
            p.copy_(torch.from_numpy(
                (r.randn(*p.shape) * 0.5).astype(np.float32)))
            p.requires_grad_(True)
    kw = {}
    if layer.needs_rng:
        kw["mask"] = torch.from_numpy(r.rand(*layer.out_shapes[0]).astype(
            np.float32)).to(device)
    tb = [torch.from_numpy(b).to(device) for b in bottoms]
    for t in tb:
        if t.is_floating_point():
            t.requires_grad_(True)
    with layer.policy.math(torch.device(device)):
        tops = layer(tb, **kw)
        weights = [torch.from_numpy(np.asarray(np.random.RandomState(
            7 + i).randn(*t.shape), np.float32)).to(device)
            for i, t in enumerate(tops)]
        total = sum(((t.float() * w).sum() for t, w in zip(tops, weights)),
                    torch.zeros((), device=device))
        if total.requires_grad:
            total.backward()
    wrt = params + [t for t in tb if t.is_floating_point()]
    return ([t.detach().float().cpu().numpy() for t in tops],
            [np.zeros(tuple(t.shape), np.float32) if t.grad is None
             else t.grad.cpu().numpy() for t in wrt])


def zoo_layers_phase(cases=None) -> dict:
    """Each case's forward and backward on the card against the port's
    CPU result on the same seeded inputs (default: the six layer types
    of slice 11)."""
    out = {}
    for name, (text, shapes) in (cases or ZOO_CASES).items():
        if not text.startswith("name:"):
            text = _zoo_text(text)
        bottoms = _zoo_bottoms(shapes)
        card = _zoo_run(text, bottoms, "cuda")
        cpu = _zoo_run(text, bottoms, "cpu")
        errs = {}
        for kind, (rtol, atol), got, want in (
                ("top", ZOO_TOP_TOL, card[0], cpu[0]),
                ("grad", ZOO_GRAD_TOL, card[1], cpu[1])):
            for i, (g, w) in enumerate(zip(got, want)):
                big = max(float(np.abs(w).max()), 1e-30)
                err = float(np.abs(g - w).max())
                errs[f"{kind}{i}"] = err / big
                if not np.allclose(g, w, rtol=rtol, atol=atol * big):
                    fail(f"{name} {kind} {i} on the card: {err} against "
                         f"the CPU (largest {big})")
        out[name] = errs
    log(f"layers: {json.dumps(out)}")
    return out


# -- 21b. pycaffe --------------------------------------------------------------

CAFFENET_DEPLOY = os.path.join(ROOT, "models", "caffenet", "deploy.prototxt")
CAFFENET_NET = os.path.join(ROOT, "models", "caffenet", "train_val.prototxt")
CAFFENET_SOLVER_ZOO = os.path.join(ROOT, "models", "caffenet",
                                   "solver.prototxt")
PYCAFFE_IMAGES = 10             # 256x256, oversampled: 100 crops of 227
DETECT_IMAGES, DETECT_WINDOWS = 2, 50
PYCAFFE_ITERS = 10
PYCAFFE_RECORDS = 512           # the solver's LMDB (3x256x256 raw)
PYCAFFE_LIMIT = 1e-4            # rows against the Net, TF32 off
REMAT_ITERS, REMAT_CHUNK = 10, 5
PYCAFFE_DEVICE = "cuda"         # the solvers' (pycaffe's mode: the card)


def _float_math_copy(src, tmp, name) -> str:
    """A copy of a prototxt with TF32 off (default_forward_math: FLOAT)."""
    with open(src) as f:
        text = f.read()
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write("default_forward_math: FLOAT\n" + text)
    return path


def _rows_rule(got, want, what) -> float:
    """The largest distance of any row element over the largest value;
    fails past PYCAFFE_LIMIT."""
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    if not err <= PYCAFFE_LIMIT:
        fail(f"pycaffe {what}: {err:.3g} from the port's Net forward "
             f"(limit {PYCAFFE_LIMIT})")
    return err


def _net_rows(net, crops, transformer, out_blob):
    """The port's Net forward, a declared batch at a time (the tail padded
    with zeros), over preprocessed crops: the out blob's rows."""
    in_ = net.inputs[0]
    batch = net.blobs[in_].data.shape[0]
    rows = []
    for lo in range(0, len(crops), batch):
        x = np.stack([transformer.preprocess(in_, c)
                      for c in crops[lo:lo + batch]])
        n = len(x)
        if n < batch:
            x = np.concatenate([x, np.zeros((batch - n, *x.shape[1:]),
                                            np.float32)])
        rows.append(net.forward(**{in_: x})[out_blob][:n])
    return np.concatenate(rows)


def _replay_vs_eager(fwd, x) -> dict:
    """A bucket's graph replay against two eager forwards of its net
    (PR 12's rule: the nearer eager run, within GRAPH_SPREAD x the eager
    runs' own distance + GRAPH_FLOOR)."""
    out = fwd.out_blob()
    g = fwd.to_host(fwd.run_bucket(x)[out])
    e1 = fwd.to_host(fwd.run_bucket(x, eager=True)[out])
    e2 = fwd.to_host(fwd.run_bucket(x, eager=True)[out])
    scale = max(float(np.abs(e1).max()), 1e-30)
    spread = float(np.abs(e2 - e1).max()) / scale
    diff = min(float(np.abs(g - e).max()) for e in (e1, e2)) / scale
    limit = GRAPH_SPREAD * spread + GRAPH_FLOOR
    if diff > limit:
        fail(f"pycaffe graph replay {diff:.3g} from eager (limit "
             f"{limit:.3g})")
    return {"diff": diff, "spread": spread, "limit": limit}


def _classifier_check(caffe, tmp, k1, k2) -> dict:
    """CaffeNet's deploy net at full width through caffe.Classifier: 10
    seeded 256x256 images oversampled (100 crops of 227, 10 replays of
    the batch-10 bucket's CUDA graph), launch counts 0 just before and
    read just after; the rows against the port's Net forward on the same
    crops (TF32 off in both), a replay against eager, a second timed
    predict, the graphs' bytes."""
    weights = os.path.join(tmp, "caffenet.caffemodel")
    caffe.Net(CAFFENET_DEPLOY, caffe.TEST).save(weights)
    deploy = _float_math_copy(CAFFENET_DEPLOY, tmp, "caffenet_float.prototxt")
    r = np.random.RandomState(11)
    images = [r.rand(256, 256, 3).astype(np.float32)
              for _ in range(PYCAFFE_IMAGES)]
    clf = caffe.Classifier(deploy, weights, image_dims=(256, 256),
                           **PREPROCESS)
    torch.cuda.synchronize()
    _reset_kernel_counts()
    t0 = time.perf_counter()
    preds = clf.predict(images, oversample=True)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = _kernel_counts()
    fwd = clf.bucket_forward()
    builds = len(fwd._graphs)
    if fwd.graph_replays != PYCAFFE_IMAGES or builds != 1:
        fail(f"classifier: {fwd.graph_replays} replays, {builds} graphs; "
             f"want {PYCAFFE_IMAGES} replays of one (bucket 10)")
    # K1 twice a forward: the capture's warm-up forward and each replay
    want = (2 * (PYCAFFE_IMAGES + builds), 0, 0, 0, 0)
    if counts != want:
        fail(f"classifier launched K1-K5 {counts}, want {want}")
    k1["launches_by_path"]["pycaffe_classifier"] = counts[0]
    k2["launches_by_path"]["pycaffe_classifier"] = counts[1]
    if preds.shape != (PYCAFFE_IMAGES, 1000) or \
            not np.all(np.isfinite(preds)) or \
            not np.allclose(preds.sum(1), 1.0, atol=1e-4):
        fail(f"classifier rows {preds.shape}, sums {preds.sum(1)}")
    crops = list(caffe.io.oversample(
        [caffe.io.resize_image(im, (256, 256)) for im in images],
        (227, 227)))
    ref = caffe.Net(deploy, weights, caffe.TEST)
    want_rows = _net_rows(ref, crops, clf.transformer, "prob").reshape(
        PYCAFFE_IMAGES, 10, -1).mean(1)
    err = _rows_rule(preds, want_rows, "classifier")
    x = np.stack([clf.transformer.preprocess("data", c) for c in crops[:10]])
    replay = _replay_vs_eager(fwd, x)
    t0 = time.perf_counter()
    clf.predict(images, oversample=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    # the bucket forwards alone, on the crops preprocessed: the rest of a
    # predict is the host's resize, oversample and preprocess
    x = np.stack([clf.transformer.preprocess("data", c) for c in crops])
    t0 = time.perf_counter()
    fwd.forward(x)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    out = {"images": PYCAFFE_IMAGES, "crops": len(crops),
           "replays": PYCAFFE_IMAGES, "ladder": list(fwd.ladder),
           "k1": counts[0], "k2": counts[1], "max_rel_err": err,
           "replay_vs_eager": replay, "first_predict_ms": first_ms,
           "predict_ms": ms, "crops_per_s": len(crops) / (ms / 1e3),
           "bucket_forward_ms": fwd_ms,
           "graph_bytes": fwd.graph_bytes(),
           "last_env_blobs": len(clf.env)}
    del clf, ref, fwd
    return out


def _detector_check(caffe, tmp, k1, k2) -> dict:
    """R-CNN's deploy net (200 classes, fc-rcnn) at full width through
    caffe.Detector.detect_windows over 2 seeded 375x500 PNG images with
    50 windows each (context_pad 16), counts 0 just before and read just
    after; the rows against the port's Net forward on the same crops."""
    from PIL import Image
    weights = os.path.join(tmp, "rcnn.caffemodel")
    caffe.Net(RCNN, caffe.TEST).save(weights)
    deploy = _float_math_copy(RCNN, tmp, "rcnn_float.prototxt")
    r = np.random.RandomState(12)
    jobs = []
    for i in range(DETECT_IMAGES):
        path = os.path.join(tmp, f"det{i}.png")
        Image.fromarray(r.randint(0, 256, (375, 500, 3)).astype(
            np.uint8)).save(path)
        windows = []
        for _ in range(DETECT_WINDOWS):
            h, w = r.randint(20, 300), r.randint(20, 300)
            y0, x0 = r.randint(0, 375 - h), r.randint(0, 500 - w)
            windows.append((y0, x0, y0 + h, x0 + w))
        jobs.append((path, windows))
    det = caffe.Detector(deploy, weights, context_pad=16, **PREPROCESS)
    torch.cuda.synchronize()
    _reset_kernel_counts()
    t0 = time.perf_counter()
    dets = det.detect_windows(jobs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = _kernel_counts()
    fwd = det.bucket_forward()
    n = DETECT_IMAGES * DETECT_WINDOWS
    want = (2 * (fwd.graph_replays + len(fwd._graphs)), 0, 0, 0, 0)
    if len(dets) != n or fwd.graph_replays != n // 10 or counts != want:
        fail(f"detector: {len(dets)} rows, {fwd.graph_replays} replays, "
             f"K1-K5 {counts} (want {want})")
    k1["launches_by_path"]["pycaffe_detector"] = counts[0]
    k2["launches_by_path"]["pycaffe_detector"] = counts[1]
    got = np.stack([d["prediction"] for d in dets])
    if got.shape != (n, RCNN_CLASSES) or not np.all(np.isfinite(got)):
        fail(f"detector rows {got.shape}")
    crops = []
    for path, windows in jobs:
        image = caffe.io.load_image(path)
        for wnd in windows:
            y0, x0, y1, x1 = det._expand_window(wnd, image.shape, (227, 227))
            crops.append(caffe.io.resize_image(image[y0:y1, x0:x1, :],
                                               (227, 227)))
    ref = caffe.Net(deploy, weights, caffe.TEST)
    err = _rows_rule(got, _net_rows(ref, crops, det.transformer, "fc-rcnn"),
                     "detector")
    out = {"images": DETECT_IMAGES, "windows": n,
           "replays": fwd.graph_replays, "k1": counts[0], "k2": counts[1],
           "max_rel_err": err, "detect_ms": ms,
           "graph_bytes": fwd.graph_bytes()}
    del det, ref, fwd
    return out


def _pycaffe_solver_copy(tmp, db) -> str:
    """models/caffenet/solver.prototxt and train_val.prototxt copied with
    the Input layer replaced by a Data layer over `db` (batch 256, crop
    227, mirror, mean values), PYCAFFE_ITERS iterations, no test net, no
    snapshot."""
    with open(CAFFENET_NET) as f:
        text = f.read()
    first = text.index("layer {")
    second = text.index("layer {", first + 1)
    if 'type: "Input"' not in text[first:second]:
        fail(f"{CAFFENET_NET} no longer starts with its Input layer")
    data = ('layer { name: "data" type: "Data" top: "data" top: "label" '
            'transform_param { mirror: true crop_size: 227 mean_value: 104 '
            'mean_value: 117 mean_value: 123 } '
            f'data_param {{ source: "{db}" backend: LMDB '
            f'batch_size: {CAFFENET_BATCH} }} }}\n')
    net = os.path.join(tmp, "caffenet_lmdb.prototxt")
    with open(net, "w") as f:
        f.write(text[:first] + data + text[second:])
    with open(CAFFENET_SOLVER_ZOO) as f:
        solver = f.read()
    for a, b in (("models/caffenet/train_val.prototxt", net),
                 ("test_iter: 1000\n", ""), ("test_interval: 1000\n", ""),
                 ("max_iter: 450000", f"max_iter: {PYCAFFE_ITERS}"),
                 ("snapshot: 10000", "snapshot: 0"),
                 ('snapshot_prefix: "models/caffenet/caffenet_train"',
                  f'snapshot_prefix: "{os.path.join(tmp, "c")}"')):
        if a not in solver:
            fail(f"{CAFFENET_SOLVER_ZOO} no longer has {a!r}")
        solver = solver.replace(a, b)
    path = os.path.join(tmp, "caffenet_solver_lmdb.prototxt")
    with open(path, "w") as f:
        f.write(solver + "random_seed: 5\n")
    return path


def _solver_check(caffe, tmp, k1, k2) -> dict:
    """caffe.SGDSolver on a copy of models/caffenet/solver.prototxt at
    batch 256 over an LMDB of 512 records the port writes: 10 iterations
    (counts 0 just before, read just after: K1 twice a forward, K2 twice
    an iteration); held against two runs of the port's Solver.step on the
    same solver and LMDB by PR 9's rule (`_resume_rule`). cuDNN is
    deterministic in all three, so the rule's spread is the rest of the
    card's nondeterminism (max pooling's backward adds atomically)."""
    from caffe_mpi_tpu_torch.data.feeder import DeviceFeed
    from caffe_mpi_tpu_torch.proto import SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.tools import cli
    db = os.path.join(tmp, "pycaffe_lmdb")
    t0 = time.perf_counter()
    _write_clusters(db, PYCAFFE_RECORDS, seed=21)
    write_s = time.perf_counter() - t0
    path = _pycaffe_solver_copy(tmp, db)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        sgd = caffe.SGDSolver(path)
        torch.cuda.synchronize()
        _reset_kernel_counts()
        t0 = time.perf_counter()
        sgd.step(1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = sgd.step(PYCAFFE_ITERS - 1)
        torch.cuda.synchronize()
        first_ms, ms = (t1 - t0) * 1e3, \
            (time.perf_counter() - t1) * 1e3 / (PYCAFFE_ITERS - 1)
        counts = _kernel_counts()
        want = (2 * PYCAFFE_ITERS, 2 * PYCAFFE_ITERS, 0, 0, 0)
        if sgd.iter != PYCAFFE_ITERS or counts != want or \
                not np.isfinite(loss):
            fail(f"pycaffe SGDSolver: iter {sgd.iter}, loss {loss}, K1-K5 "
                 f"{counts} (want {want})")
        k1["launches_by_path"]["pycaffe_solver"] = counts[0]
        k2["launches_by_path"]["pycaffe_solver"] = counts[1]
        got = _state(sgd.solver)
        batch = sgd.solver.net.blob_shapes["data"][0]
        sgd.close()
        del sgd
        refs = []
        for _ in range(2):
            solver = Solver(SolverParameter.from_file(path),
                            device=PYCAFFE_DEVICE)
            feed = DeviceFeed(cli.build_feeder(solver.net, "TRAIN",
                                               solver.sp), solver.device)
            try:
                solver.step(PYCAFFE_ITERS, feed)
            finally:
                feed.close()
            torch.cuda.synchronize()
            refs.append(_state(solver))
            solver.close()
            del solver
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = saved
    rule = _resume_rule(refs, got)
    if not rule["held"]:
        fail(f"pycaffe SGDSolver against Solver.step: {rule}")
    torch.cuda.empty_cache()
    return {"iters": PYCAFFE_ITERS, "batch": batch,
            "records": PYCAFFE_RECORDS, "write_s": write_s, "loss": loss,
            "first_iter_ms": first_ms, "ms_per_iter": ms,
            "cudnn_deterministic": True, "k1": counts[0], "k2": counts[1],
            "rule": {k: v for k, v in rule.items() if k != "worst"},
            "worst": [list(w) for w in rule["worst"]]}


REMAT_NET = """name: "remat_probe"
layer {{ name: "data" type: "Input" top: "data" top: "label"
  input_param {{ shape {{ dim: 64 dim: 3 dim: 32 dim: 32 }}
                 shape {{ dim: 64 }} }} }}
layer {{ name: "conv1" type: "Convolution" bottom: "data" top: "conv1"{r}
  convolution_param {{ num_output: 32 kernel_size: 3 pad: 1
    weight_filler {{ type: "gaussian" std: 0.05 }} }} }}
layer {{ name: "bn1" type: "BatchNorm" bottom: "conv1" top: "conv1"{r} }}
layer {{ name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }}
layer {{ name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param {{ pool: MAX kernel_size: 2 stride: 2 }} }}
layer {{ name: "norm1" type: "LRN" bottom: "pool1" top: "norm1"{r}
  lrn_param {{ local_size: 5 alpha: 0.0001 beta: 0.75 }} }}
layer {{ name: "conv2" type: "Convolution" bottom: "norm1" top: "conv2"{r}
  convolution_param {{ num_output: 32 kernel_size: 3 pad: 1
    weight_filler {{ type: "gaussian" std: 0.05 }} }} }}
layer {{ name: "prelu2" type: "PReLU" bottom: "conv2" top: "conv2"{r} }}
layer {{ name: "fc" type: "InnerProduct" bottom: "conv2" top: "fc"
  inner_product_param {{ num_output: 10
    weight_filler {{ type: "gaussian" std: 0.01 }} }} }}
layer {{ name: "drop" type: "Dropout" bottom: "fc" top: "fc"{r} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "fc" bottom: "label"
  top: "loss" }}
"""


def _remat_check() -> dict:
    """`remat: true` on conv, BatchNorm, LRN (K1, K2), PReLU and Dropout
    in a step_chunk 5 CUDA graph on the card, cuDNN deterministic: 10
    iterations, the graph captured and replayed; the losses, params,
    history and running statistics bitwise those of the same net without
    remat."""
    from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.tools import cli
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    runs = {}
    try:
        for remat in (False, True):
            sp = SolverParameter.from_text(
                'base_lr: 0.001 momentum: 0.9 lr_policy: "fixed" '
                f'max_iter: {REMAT_ITERS} random_seed: 3 '
                f'step_chunk: {REMAT_CHUNK}')
            sp.net_param = NetParameter.from_text(REMAT_NET.format(
                r=" remat: true" if remat else ""))
            solver = Solver(sp, device=PYCAFFE_DEVICE)
            feeds = cli.synthetic_feed(solver.net, 0)
            losses = []
            for _ in range(REMAT_ITERS // REMAT_CHUNK):
                losses.append(solver.step(REMAT_CHUNK, lambda it: feeds))
            torch.cuda.synchronize()
            runs[remat] = (losses, _state(solver), len(solver._graphs),
                           solver.graph_replays)
            solver.close()
            del solver
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = saved
    (l0, s0, g0, r0), (l1, s1, g1, r1) = runs[False], runs[True]
    unequal = [k for k in s0 if not torch.equal(s0[k], s1[k])]
    if g1 < 1 or r1 < 1 or l0 != l1 or unequal or \
            not np.all(np.isfinite(l1)):
        fail(f"remat step_chunk: graphs {g1}, replays {r1}, losses {l1} "
             f"against {l0}, unequal tensors {unequal[:5]}")
    return {"graphs": g1, "replays": r1, "losses": l1, "bitwise": True,
            "tensors": len(s0)}


def pycaffe_phase(k1: dict, k2: dict, card: str) -> dict:
    """The pycaffe API on the card (caffe_mpi_tpu_torch.pycaffe):
    Classifier (CaffeNet), Detector (R-CNN), SGDSolver (CaffeNet from an
    LMDB), the 27 layer types of slice 15 card against CPU, and remat in a
    step_chunk CUDA graph."""
    import caffe_mpi_tpu_torch.pycaffe as caffe
    sys.path.insert(0, os.path.join(ROOT, "examples", "pycaffe"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pycaffe_")
    out, seconds = {}, {}
    try:
        for name, check in (
                ("classifier", lambda: _classifier_check(caffe, tmp, k1, k2)),
                ("detector", lambda: _detector_check(caffe, tmp, k1, k2)),
                ("solver", lambda: _solver_check(caffe, tmp, k1, k2)),
                ("layers", lambda: zoo_layers_phase(ZOO_REST_CASES)),
                ("remat", _remat_check)):
            t0 = time.perf_counter()
            out[name] = check()
            seconds[name] = round(time.perf_counter() - t0, 1)
            log(f"pycaffe {name}: {seconds[name]} s")
            torch.cuda.empty_cache()
    finally:
        sys.path.remove(os.path.join(ROOT, "examples", "pycaffe"))
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    out["seconds"], out["card"] = seconds, card
    log(f"pycaffe: {json.dumps(out)}")
    return out


# -- 22. survive ---------------------------------------------------------------

SURVIVE_ITERS = 30       # the tentpole command's -max_iter
SURVIVE_EVERY = 10       # its -snapshot_every
LENET = os.path.join(ROOT, "models", "lenet", "lenet_solver.prototxt")
# the LeNet children's watchdog: the first chunks (cuDNN's search, the
# graph capture, the kernel libraries' first load) must fit it; each
# child's chunk ms are reported beside it
WATCHDOG_DEADLINE_S = 10.0
STALL_S = 30.0
SURVIVE_SPREAD, SURVIVE_FLOOR = 2.0, 1e-6  # PR 9's rule (CHUNK_SPREAD)


class _JournalLog:
    """Every distinct run journal (`<prefix>.run.json`) seen while a
    supervised run goes on, polled every 50 ms: a child's journal is
    rewritten by the next child, so it is read while it stands."""

    def __init__(self, prefix):
        import threading
        from caffe_mpi_tpu_torch.utils import resilience
        self.seen, self._stop = [], threading.Event()

        def poll():
            last = None
            while not self._stop.wait(0.05):
                doc = resilience.read_run_manifest(prefix)
                key = doc and (doc.get("reason"), doc.get("iter"),
                               doc.get("pid"))
                if doc and key != last:
                    last = key
                    self.seen.append({k: doc.get(k) for k in (
                        "reason", "iter", "last_snapshot_iter",
                        "stalled_s", "deadline_s", "consec_skips",
                        "exit_code")})
        self._thread = threading.Thread(target=poll, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        return self.seen


def _supervised(tag, solver, prefix, faults, extra=(), timeout=600):
    """`cli train -max_restarts 2` in a process of its own (a supervisor
    that touches no card, its children on the card), with the fault
    sites `faults` and a once-dir. Returns its exit code, wall time, the
    children's summaries, each `kernel launches so far` line, the
    failure log, the journals seen and the output."""
    import re
    import signal
    fdir = prefix + "_faults"
    os.makedirs(fdir, exist_ok=True)
    env = dict(os.environ, CAFFE_TPU_FAULTS=faults,
               CAFFE_TPU_FAULTS_DIR=fdir)
    env.pop("CAFFE_SUPERVISED_CHILD", None)
    cmd = [sys.executable, "-m", "caffe_mpi_tpu_torch.tools.cli", "train",
           "-solver", solver, "-synthetic", "-max_iter", str(SURVIVE_ITERS),
           "-snapshot_every", str(SURVIVE_EVERY), "-max_restarts", "2",
           "-step_chunk", "10", "-test_iter", str(TEST_ITER),
           "-snapshot_prefix", prefix, "-device", "cuda", *extra]
    journal = _JournalLog(prefix)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        # SIGTERM: the supervisor kills its children's process groups
        proc.send_signal(signal.SIGTERM)
        try:
            proc.communicate(timeout=30)
        finally:
            proc.kill()
        fail(f"survive {tag}: the supervised run passed {timeout} s")
    wall = time.perf_counter() - t0
    seen = journal.stop()
    with open(os.path.join(ROOT, "chiprun_out", f"survive_{tag}.err")
              if os.path.isdir(os.path.join(ROOT, "chiprun_out"))
              else os.devnull, "w") as f:
        f.write(err)
    launches = [(int(m.group(1)), json.loads(m.group(2))) for m in
                re.finditer(r"snapshot at iteration (\d+); kernel launches "
                            r"so far: (\{[^}]*\})", err)]
    log_path = prefix + ".failures.log"
    failures = open(log_path).read() if os.path.exists(log_path) else ""
    return {"rc": proc.returncode, "wall_s": wall,
            "summaries": [json.loads(l)["train"] for l in out.splitlines()
                          if l.startswith('{"train"')],
            "launches": launches, "failures": failures,
            "failure_lines": [l for l in failures.splitlines()
                              if not l.startswith("    ")],
            "journal": seen, "err": err}


def _child(res, tag):
    """The one summary a supervised run prints: its last child's."""
    if res["rc"] != 0 or len(res["summaries"]) != 1:
        fail(f"survive {tag}: rc {res['rc']}, {len(res['summaries'])} "
             f"summaries; failures {res['failure_lines']}; "
             f"{res['err'][-3000:]}")
    return res["summaries"][0]


def _lenet_cases(tmp) -> dict:
    """The watchdog (a stall past the deadline exits 86, journals
    watchdog:train dispatch, the run resumes) and the rewind (NaN feeds
    under the guard exit 88, the restart carries -lr_scale), two
    supervised LeNet runs side by side."""
    cases = {
        "watchdog": (f"dispatch_stall:1:2:{STALL_S:g}",
                     ("-watchdog_deadline", f"{WATCHDOG_DEADLINE_S:g}")),
        "rewind_lr": ("nan_grad:2:0:12",
                      ("-train_guard", "-guard_max_skips", "2",
                       "-anomaly_action", "rewind_lr")),
    }
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = {k: ex.submit(_supervised, f"lenet_{k}", LENET,
                             os.path.join(tmp, k, "lenet"), f, extra)
                for k, (f, extra) in cases.items()}
        res = {k: f.result() for k, f in futs.items()}
    out = {}
    wd = res["watchdog"]
    s = _child(wd, "lenet watchdog")
    trips = [j for j in wd["journal"]
             if j["reason"] == "watchdog:train dispatch"]
    if wd["failure_lines"] == [] or "attempt 1: watchdog" not in \
            wd["failure_lines"][0] or len(wd["failure_lines"]) != 1 \
            or not trips or trips[0]["iter"] != SURVIVE_EVERY \
            or not s["resumed_from"].endswith(
                f"lenet_iter_{SURVIVE_EVERY}.solverstate") \
            or s["iters"] != SURVIVE_ITERS - SURVIVE_EVERY \
            or max(s["chunk_ms"]) > WATCHDOG_DEADLINE_S * 1e3:
        fail(f"survive lenet watchdog: failures {wd['failure_lines']}, "
             f"journal {wd['journal']}, resumed {s['resumed_from']}, "
             f"chunks {s['chunk_ms']}")
    out["watchdog"] = {"failure_lines": wd["failure_lines"],
                       "journal": wd["journal"], "wall_s": wd["wall_s"],
                       "deadline_s": WATCHDOG_DEADLINE_S, "stall_s": STALL_S,
                       "restarted_child_chunk_ms": s["chunk_ms"],
                       "restarted_child_resume_ms": s["resume_ms"],
                       "resumed_from": os.path.basename(s["resumed_from"])}
    rw = res["rewind_lr"]
    s = _child(rw, "lenet rewind_lr")
    attempt2 = [l for l in rw["err"].splitlines()
                if "supervisor: attempt 2/3" in l]
    anomalies = [j for j in rw["journal"] if j["reason"] == "numeric_anomaly"]
    if len(rw["failure_lines"]) != 1 or "attempt 1: numeric divergence" \
            not in rw["failure_lines"][0] or not attempt2 \
            or not attempt2[0].endswith("-resume auto -lr_scale 0.1") \
            or not anomalies or anomalies[0]["exit_code"] != 88 \
            or not s["resumed_from"].endswith(
                f"lenet_iter_{SURVIVE_EVERY}.solverstate") \
            or not np.all(np.isfinite(s["losses"])):
        fail(f"survive lenet rewind_lr: failures {rw['failure_lines']}, "
             f"attempt 2 {attempt2}, journal {rw['journal']}, resumed "
             f"{s['resumed_from']}, losses {s['losses']}")
    out["rewind_lr"] = {"failure_lines": rw["failure_lines"],
                        "journal": rw["journal"], "wall_s": rw["wall_s"],
                        "restart_cmd_tail": attempt2[0][-40:],
                        "resumed_from": os.path.basename(s["resumed_from"])}
    return out


def _files_bytes(prefix, it):
    return sum(os.path.getsize(f"{prefix}_iter_{it}.{e}")
               for e in ("caffemodel", "solverstate"))


def _async_check(solver, tmp) -> dict:
    """On a trained AlexNet solver: a blocking snapshot and an async one
    at the same iteration (relative prefixes, so both state files name
    the same caffemodel), a chunk of 10 graph replays run while the
    writer copies and writes, then two chunks without a writer; the
    files byte-equal, the stall and the spanning chunk's ms against the
    others."""
    from caffe_mpi_tpu_torch.tools import cli
    feeds = cli.synthetic_feed(solver.net)
    feed_fn = lambda it: feeds  # noqa: E731
    solver.sp.snapshot, solver.sp.display = 0, 0  # full chunks of 10
    solver.step(10, feed_fn)
    dirs = {k: os.path.join(tmp, k) for k in ("block", "async")}
    for d in dirs.values():
        os.makedirs(d)
    solver.sp.snapshot_prefix = "s"
    it = solver.iter
    try:
        os.chdir(dirs["block"])
        solver.snapshot(block=True)
        os.chdir(dirs["async"])
        solver.snapshot(block=False)
        t0 = time.perf_counter()
        solver.step(10, feed_fn)
        span_ms = (time.perf_counter() - t0) * 1e3 / 10
        solver.wait_snapshots()
    finally:
        os.chdir(ROOT)
    plain = []
    for _ in range(2):
        t0 = time.perf_counter()
        solver.step(10, feed_fn)
        plain.append((time.perf_counter() - t0) * 1e3 / 10)
    block, asyn = solver.snapshot_log[-2:]
    equal = {e: open(os.path.join(dirs["block"], f"s_iter_{it}.{e}"),
                     "rb").read() == open(os.path.join(
                         dirs["async"], f"s_iter_{it}.{e}"), "rb").read()
             for e in ("caffemodel", "solverstate")}
    if not all(equal.values()) or not block["block"] or asyn["block"]:
        fail(f"survive: async snapshot files equal {equal}, log "
             f"{solver.snapshot_log[-2:]}")
    return {"iteration": it,
            "bytes": _files_bytes(os.path.join(dirs["block"], "s"), it),
            "blocking_write_ms": block["write_ms"],
            "async_stall_ms": asyn["stall_ms"],
            "async_writer_ms": asyn["write_ms"],
            "spanning_chunk_ms_per_iter": span_ms,
            "plain_chunk_ms_per_iter": plain,
            "files_byte_equal": equal}


def _resume_rule(runs, got) -> dict:
    """Each tensor's distance from the nearer uninterrupted run over its
    largest element, the worst over all tensors, against 2x the two runs'
    own, the worst over all tensors, + 1e-6 (PR 9's chunk rule). A
    tensor's own spread is no bound: a sound resume has read 1.09x twice
    its own in one tensor (PERF.md, PR 13). `worst`: the three tensors
    farthest off (distance, own spread)."""
    rows = []
    a, b = runs
    for key in a:
        scale = max(float(a[key].float().abs().max()), 1e-30)
        spread = float((b[key].float() - a[key].float()).abs().max()) / scale
        diff = min(float((got[key].float() - r[key].float()).abs().max())
                   for r in (a, b)) / scale
        rows.append((key, diff, spread))
    rows.sort(key=lambda r: -r[1])
    spread = max(r[2] for r in rows)
    limit = SURVIVE_SPREAD * spread + SURVIVE_FLOOR
    return {"diff": rows[0][1], "spread": spread, "limit": limit,
            "held": rows[0][1] <= limit,
            "tensors_over": sum(r[1] > limit for r in rows),
            "tensors": len(rows), "worst": rows[:3]}


def _resume_control(prefix, feeds) -> dict:
    """The planted fault the resume rule must catch: the supervised run's
    iteration-20 snapshot restored with its history zeroed (a resume that
    loses the momentum), then its last 10 iterations as the child ran
    them (the CLI's synthetic batch, step_chunk 10). Returns the state."""
    from caffe_mpi_tpu_torch.proto import SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    sp = SolverParameter.from_file(SOLVER)
    sp.snapshot, sp.display, sp.test_interval = 0, 0, 0
    sp.step_chunk = 10
    ctrl = Solver(sp, device="cuda")
    ctrl.restore(f"{prefix}_iter_20.solverstate")
    for slots in ctrl.history.values():
        for h in slots:
            h.zero_()
    batch = feeds(ctrl.net)
    ctrl.step(SURVIVE_ITERS - 20, lambda it: batch)
    state = _state(ctrl)
    del ctrl
    return state


def _test_chunk_check(solver) -> dict:
    """test_chunk on a trained AlexNet solver (step_chunk 10: a chunk
    after the test net's first is one CUDA-graph replay of T forwards):
    10 distinct test batches at test_chunk 5 (two passes) and 1, each
    pass within 1e-6 relative of a plain loop of eager forwards over the
    same batches on the default stream."""
    from caffe_mpi_tpu_torch.tools import cli
    tnet = solver.test_nets[0]
    batches = [cli.synthetic_feed(tnet, seed=100 + k) for k in range(10)]
    blobs_out = solver._output_blobs(tnet)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        sums = torch.zeros(len(blobs_out), device="cuda")
        for f in batches:
            blobs, _ = tnet(f)
            sums += torch.stack([blobs[b].float().sum() for b in blobs_out])
    plain = dict(zip(blobs_out, (sums.cpu().numpy() / 10).tolist()))
    plain_ms = (time.perf_counter() - t0) * 1e3
    solver.sp.test_iter = [10]
    scores, graphs0 = [], set(solver._test_graphs)
    for t in (5, 5, 1):
        solver.sp.test_chunk = t
        d0 = solver.test_dispatch_count
        t0 = time.perf_counter()
        got = solver.test_all([batches.__getitem__])[0]
        scores.append({"test_chunk": t, "ms": (time.perf_counter() - t0)
                       * 1e3, **got})
        if solver.test_dispatch_count - d0 != 10 // t:
            fail(f"survive test_chunk {t}: "
                 f"{solver.test_dispatch_count - d0} chunks")
    rel = max(abs(sc[b] - plain[b]) / max(abs(plain[b]), 1e-30)
              for sc in scores for b in plain)
    captured = sorted(set(solver._test_graphs) - graphs0)
    if rel > 1e-6 or not {(0, 5), (0, 1)} <= set(solver._test_graphs):
        fail(f"survive test_chunk: plain {plain}, passes {scores}, "
             f"graphs {sorted(solver._test_graphs)}")
    return {"plain": plain, "plain_ms": plain_ms, "passes": scores,
            "max_rel_diff": rel, "graphs_captured": captured}


def _watch_check(prefix, k1, k2) -> dict:
    """An AlexNet engine (ladder 1, 4, 10) with a SnapshotWatcher on the
    supervised run's prefix and swap_corrupt armed once: iteration 30 is
    rejected (rows bitwise), iteration 20 swaps in (rows within 1e-4 of
    the port's Net on its caffemodel, TF32 off), no capture either way,
    K1 counted in the graphs and K2 never."""
    from caffe_mpi_tpu_torch import io as port_io
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.serving import SnapshotWatcher
    from caffe_mpi_tpu_torch.utils import resilience
    rng = np.random.RandomState(21)
    _reset_kernel_counts()
    with _serve_engine(window_ms=0) as engine:
        model = engine.load_model("alexnet", MODEL, seed=0, **PREPROCESS)
        if model.fwd.ladder != (1, 4, 10):
            fail(f"survive watch: ladder {model.fwd.ladder}")
        x = np.stack([model.preprocess(im) for im in _images(rng, 4)])
        before = engine.classify("alexnet", x, preprocess=False)
        builds, recaps = engine.compile_count, engine.recaptures
        watcher = SnapshotWatcher(engine, "alexnet", prefix)
        t0 = time.perf_counter()
        m20 = f"{prefix}_iter_20.manifest.json"
        if resilience.verify_snapshot(m20) is None:
            fail("survive watch: the iteration-20 snapshot does not verify")
        verify_ms = (time.perf_counter() - t0) * 1e3
        resilience.FAULTS.configure("swap_corrupt:1")
        try:
            first = watcher.check_once()
        finally:
            resilience.FAULTS.configure("")
        kept = engine.classify("alexnet", x, preprocess=False)
        t0 = time.perf_counter()
        second = watcher.check_once()
        swap_ms = (time.perf_counter() - t0) * 1e3
        after = engine.classify("alexnet", x, preprocess=False)
        st = engine.stats()
        d_builds = engine.compile_count - builds
        d_recaps = engine.recaptures - recaps
    counts = _kernel_counts()
    strict, _ = _strict_params()
    net = Net(strict, device="cuda")
    net.import_weights(port_io.load_weights(f"{prefix}_iter_20.caffemodel"))
    with torch.inference_mode():
        pad = np.concatenate([x, np.zeros((6, *x.shape[1:]), np.float32)])
        ref = net({"data": torch.from_numpy(pad).cuda()})[0][
            "prob"].float().cpu().numpy()[:4]
    del net
    diff = float(np.abs(after - ref).max())
    moved = float(np.abs(after - before).max())
    if first or not second or not np.array_equal(kept, before) \
            or watcher._rejected != {30} or diff > 1e-4 or moved <= diff \
            or d_builds or d_recaps or st["swaps"] != 1 \
            or st["swap_rejections"] != 1 or counts[0] == 0 or any(
                counts[1:]):
        fail(f"survive watch: first {first}, second {second}, kept "
             f"bitwise {np.array_equal(kept, before)}, rejected "
             f"{watcher._rejected}, rows {diff:.3g} from the Net (moved "
             f"{moved:.3g}), builds {d_builds}, recaptures {d_recaps}, "
             f"stats {st['swaps']} {st['swap_rejections']}, K1-K5 {counts}")
    k1["launches_by_path"]["survive_watch"] = counts[0]
    k2.setdefault("launches_by_path", {})["survive_watch"] = counts[1]
    return {"rejected": [30], "swapped": 20, "verify_ms": verify_ms,
            "swap_ms": swap_ms, "rows_max_abs_diff_vs_net": diff,
            "rows_moved": moved, "builds_across": d_builds,
            "recaptures_across": d_recaps, "k1_launches": counts[0],
            "k2_launches": counts[1]}


def start_lenet_cases():
    """Start `_lenet_cases` in a thread: its runs are child processes that
    use the card while the parent builds the kernels (main joins it
    before the kernel phase's timings). Returns (future, its tmp dir)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lenet_")
    ex = ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(_lenet_cases, tmp)
    ex.shutdown(wait=False)
    return fut, tmp


def survive_phase(k1: dict, k2: dict, card: str, lenet: dict) -> dict:
    """Survivable training and the train-to-serve loop at AlexNet's full
    width (b256, step_chunk 10): two uninterrupted runs in process, the
    supervised CLI run with an abort and a rotten snapshot, the async
    snapshot, test_chunk, and the snapshot watcher; `lenet` holds the
    watchdog and rewind cases run during the build."""
    from caffe_mpi_tpu_torch.proto import SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.tools import cli
    from caffe_mpi_tpu_torch.utils import resilience
    tmp = tempfile.mkdtemp(prefix="chip_smoke_survive_")
    out = {"card": card, "lenet": lenet}
    try:
        # 1. two uninterrupted runs, in process
        runs, walls, want = [], [], None
        argv = ("-snapshot_every", str(SURVIVE_EVERY), "-snapshot_keep",
                "2", "-step_chunk", "10")
        for i in range(2):
            _reset_kernel_counts()
            t0 = time.perf_counter()
            solver, summary = _train_cli(SOLVER, os.path.join(tmp, f"u{i}"),
                                         SURVIVE_ITERS, argv)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts = _kernel_counts()
            want = (2 * (SURVIVE_ITERS + 2 * TEST_ITER), 2 * SURVIVE_ITERS)
            if counts[:2] != want or any(counts[2:]) or \
                    not np.all(np.isfinite(summary["losses"])):
                fail(f"survive uninterrupted run {i}: K1-K5 {counts} "
                     f"(want {want}), losses {summary['losses']}")
            runs.append(_state(solver))
            if i == 0:
                k1["launches_by_path"]["survive_train"] = counts[0]
                k2.setdefault("launches_by_path", {})[
                    "survive_train"] = counts[1]
                # 4. the async snapshot, 5. test_chunk, on this solver
                out["async_snapshot"] = _async_check(
                    solver, os.path.join(tmp, "snap"))
                out["test_chunk"] = _test_chunk_check(solver)
            del solver
            torch.cuda.empty_cache()
        # 2. the supervised run: snapshots blocking (snapshot_sync), the
        # iteration-20 one rots after its manifest, the first child dies
        # at the chunk starting at 20
        prefix = os.path.join(tmp, "sup", "alexnet")
        sup = _supervised("alexnet", SOLVER, prefix,
                          "snapshot_sync:-1,snapshot_corrupt:1:1,"
                          "train_abort:1:0:20", ("-snapshot_keep", "2"))
        s = _child(sup, "alexnet")
        first = next((c for it, c in sup["launches"] if it == 20), None)
        per_child = (2 * (20 + TEST_ITER), 2 * 20)
        its = [it for it, _ in resilience.iter_snapshot_manifests(prefix)]
        bad = []
        if len(sup["failure_lines"]) != 1 or \
                "attempt 1: fault/cluster" not in sup["failure_lines"][0]:
            bad.append(f"failures {sup['failure_lines']}")
        if not s["resumed_from"].endswith("alexnet_iter_10.solverstate") \
                or s["start_iter"] != 10:
            bad.append(f"resumed from {s['resumed_from']}")
        if its != [30, 20] or any(resilience.verify_snapshot(
                f"{prefix}_iter_{i}.manifest.json") is None for i in its):
            bad.append(f"snapshots kept {its}")
        if first is None or (first["K1"], first["K2"]) != per_child or \
                (s["kernel_launches"]["K1"], s["kernel_launches"]["K2"]) \
                != per_child:
            bad.append(f"K1/K2: first child {first}, second "
                       f"{s['kernel_launches']}, want {per_child} each")
        if bad:
            fail(f"survive supervised AlexNet: {bad}")
        sp = SolverParameter.from_file(SOLVER)
        sp.test_iter = [TEST_ITER]
        check = Solver(sp, device="cuda")
        check.restore(f"{prefix}_iter_30.solverstate")
        rule = _resume_rule(runs, _state(check))
        del check
        torch.cuda.empty_cache()
        control = _resume_rule(runs, _resume_control(prefix,
                                                     cli.synthetic_feed))
        del runs
        torch.cuda.empty_cache()
        if not rule["held"] or control["held"]:
            fail(f"survive: the supervised run's final state {rule}, the "
                 f"zeroed-history control {control}")
        out["supervised"] = {
            "failure_lines": sup["failure_lines"],
            "resumed_from": os.path.basename(s["resumed_from"]),
            "snapshots_kept": its, "first_child_launches_at_20": first,
            "second_child_launches": s["kernel_launches"],
            "resume_rule": rule, "resume_control": control,
            "wall_s": sup["wall_s"],
            "uninterrupted_wall_s_in_process": walls,
            "restarted_child_resume_ms": s["resume_ms"],
            "restarted_child_chunk_ms": s["chunk_ms"],
            "restarted_child_snapshot_log": s["snapshot_log"],
            "journal": sup["journal"]}
        k1["launches_by_path"]["survive_supervised"] = \
            s["kernel_launches"]["K1"]
        k2["launches_by_path"]["survive_supervised"] = \
            s["kernel_launches"]["K2"]
        # 6. the watcher on the supervised run's snapshots
        out["watch"] = _watch_check(prefix, k1, k2)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"survive: {json.dumps(out)}")
    return out


# -- 23. dp -------------------------------------------------------------------

DP_RULE_ITERS = 3      # AlexNet's gloo runs held to the one-process run
DP_RULE_BOUND = 1e-2   # AlexNet: each tensor's distance over its largest
DP_STATS_BOUND = 1e-3  # ResNet-50: each BatchNorm's statistics, the loss
DP_BN_BOUND = 1e-4     # BatchNorm alone: y, dx, dscale, dbias, mean, var
DP_EXACT_ITERS = 5     # the deterministic flat / overlap / ZeRO-1 runs
DP_TIMED_ITERS = 4     # ResNet-50's timed run (TF32 as configured)
DP_FAULT_ITER = 1      # rank 1's gradients left out of this all-reduce
DP_RANK_DEADLINE = 600
DP_CARDS_DEADLINE = 240  # a CLI run over the cards (~1 min when sound)


def _dp_state(solver) -> dict:
    """_state with the whole history (ZeRO-1 shards gathered)."""
    out = _state(solver)
    for (lname, pname), slots in solver.full_history().items():
        for i, h in enumerate(slots):
            out[f"{lname}.{pname}.h{i}"] = h.cpu().clone()
    return out


def _digest(state) -> str:
    import hashlib
    h = hashlib.sha256()
    for key in sorted(state):
        h.update(key.encode())
        h.update(state[key].contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def _float_math(sp) -> None:
    """The solver's net with full float32 multiplies (FLOAT math, TF32
    off): the ranks and the one-process run then differ by the order of
    float32 sums alone, whatever cuDNN algorithm each batch shape gets."""
    from caffe_mpi_tpu_torch.proto import NetParameter
    param = NetParameter.from_file(
        sp.net if os.path.exists(sp.net) else os.path.join(ROOT, sp.net))
    param.default_forward_math = param.default_backward_math = "FLOAT"
    sp.net, sp.net_param = "", param


def _dp_run(net, mesh=None, edit=None, iters=DP_RULE_ITERS, fault=None):
    """`iters` eager iterations of the zoo net's solver on its synthetic
    batch (this rank's slice under `mesh`), every launch count 0 just
    before: (state, facts). `fault` plants one: "reduce" leaves rank 1's
    gradients out of the all-reduce of iteration DP_FAULT_ITER,
    "bn_all" / "bn_last" run every BatchNorm / the last one on the
    rank's own batch statistics."""
    from caffe_mpi_tpu_torch.proto import SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.tools import cli
    path = SOLVER if net == "alexnet" else os.path.join(RESNET_DIR,
                                                        "solver.prototxt")
    sp = SolverParameter.from_file(path)
    sp.snapshot, sp.display, sp.test_interval, sp.step_chunk = 0, 0, 0, 1
    if edit:
        edit(sp)
    # the solver's net path is relative to the working directory
    model_dir = "" if not sp.net or os.path.exists(sp.net) \
        else os.path.dirname(path)
    solver = Solver(sp, model_dir=model_dir,
                    device=None if mesh else "cuda", mesh=mesh)
    rank, world = (mesh.rank, mesh.n_data) if mesh else (0, 1)
    feeds = cli.synthetic_feed(solver.net, 0, rank, world)
    if fault == "reduce" and rank == 1:
        red, finish, calls = solver._reducer, solver._reducer.finish, [0]

        def faulty():
            calls[0] += 1
            if calls[0] == DP_FAULT_ITER + 1:
                for flat in red.flats:
                    flat.zero_()
            finish()
        red.finish = faulty
    elif fault in ("bn_all", "bn_last"):
        bns = [l for l in solver.net.layers if l.lp.type == "BatchNorm"]
        for layer in bns if fault == "bn_all" else bns[-1:]:
            layer.mesh_plan = None
    _reset_kernel_counts()
    torch.cuda.synchronize()
    if iters > 1:  # the collectives are timed over the steps after it
        solver.step(1, lambda it: feeds)
    if mesh is not None:
        mesh.timing = True
        mesh.collective_ms()
        c0 = mesh.collectives.launches
    timed = iters - 1 if iters > 1 else 1
    solver.step(timed, lambda it: feeds)
    torch.cuda.synchronize()
    facts = {"launches": dict(zip(("K1", "K2"), _kernel_counts()[:2])),
             "step_ms": float(np.median(solver.iter_ms[1:]
                                        or solver.iter_ms)),
             "losses": list(solver.losses),
             "graphs": solver.graph_replays > 0}
    if not np.all(np.isfinite(facts["losses"])):
        fail(f"dp {net}: losses {facts['losses']}")
    if mesh is not None:
        facts["collective_ms_per_step"] = mesh.collective_ms() / timed
        facts["collectives_per_step"] = \
            (mesh.collectives.launches - c0) / timed
        facts["reduction"] = solver.reduction_stats()
        mesh.timing = False
    state = _dp_state(solver)
    state["loss"] = torch.tensor(solver.losses)
    del solver, feeds
    torch.cuda.empty_cache()
    return state, facts


def _step_rule(ref, got, bound, keys=None) -> dict:
    """Each tensor's distance from the one-process run's over that
    tensor's largest element (`keys`, default every tensor of `ref`),
    the worst over the tensors, against `bound`. `worst`: the three
    tensors farthest off."""
    rows = []
    for key in keys or ref:
        r = ref[key].float()
        scale = max(float(r.abs().max()), 1e-30)
        rows.append((key, float((got[key].float() - r).abs().max()) / scale))
    rows.sort(key=lambda row: -row[1])
    return {"diff": rows[0][1], "bound": bound, "held": rows[0][1] <= bound,
            "tensors_over": sum(row[1] > bound for row in rows),
            "tensors": len(rows), "worst": rows[:3]}


def _stats_keys(state) -> list:
    """ResNet-50's forward after one iteration: every BatchNorm's running
    mean and variance (its global-batch statistics) and the loss."""
    return [k for k in state if k.endswith((".mean", ".var"))] + ["loss"]


# the rule's runs on the ranks: (name, net, planted fault, iterations);
# AlexNet's over DP_RULE_ITERS against DP_RULE_BOUND, every tensor;
# ResNet-50's forward (one iteration) against DP_STATS_BOUND
DP_RULE_RUNS = (("alexnet", "alexnet", None, DP_RULE_ITERS),
                ("alexnet_fault", "alexnet", "reduce", DP_RULE_ITERS),
                ("resnet50", "resnet50", None, 1),
                ("resnet50_bn_all_local", "resnet50", "bn_all", 1),
                ("resnet50_bn_last_local", "resnet50", "bn_last", 1))


def _bn_grads(fn, x, dy, scale, bias) -> dict:
    """y, dx, dscale, dbias of `fn(x, scale, bias)` (y, mean, var) under
    the upstream gradient dy."""
    x, scale, bias = (t.detach().clone().requires_grad_(True)
                      for t in (x, scale, bias))
    y, mean, var = fn(x, scale, bias)
    y.backward(dy)
    return {"y": y.detach(), "dx": x.grad, "dscale": scale.grad,
            "dbias": bias.grad, "mean": mean.detach(), "var": var.detach()}


def _bn_alone(mesh, shapes, eps) -> dict:
    """BatchNorm alone on this rank at each (rank batch, C, H, W) of
    `shapes`: `_GlobalBatchNorm` ("global") and the rank's own statistics
    ("local", the planted fault) on the rank's slice of a seeded global
    batch, against F.batch_norm of the whole global batch on the same
    device. The scale and bias gradients are summed over the ranks first
    (the solver's reduce). Per kind, the worst distance over the shapes
    and the six tensors, each over its largest element."""
    import torch.nn.functional as F
    from caffe_mpi_tpu_torch.layers.norm import _GlobalBatchNorm

    def whole(x, scale, bias):
        var, mean = torch.var_mean(x, [0, 2, 3], correction=0)
        return F.batch_norm(x, None, None, scale, bias, training=True,
                            eps=eps), mean, var

    def global_(x, scale, bias):
        return _GlobalBatchNorm.apply(x, scale, bias, eps, mesh)

    out = {}
    for kind, fn in (("global", global_), ("local", whole)):
        rows = []
        for i, shape in enumerate(shapes):
            g = torch.Generator().manual_seed(i)
            n, c = shape[0], shape[1]
            full = (n * mesh.n_data, *shape[1:])
            x = (torch.randn(full, generator=g) * 2 + 0.5).to(mesh.device)
            dy = torch.randn(full, generator=g).to(mesh.device)
            scale = (1 + 0.1 * torch.randn(c, generator=g)).to(mesh.device)
            bias = (0.1 * torch.randn(c, generator=g)).to(mesh.device)
            ref = _bn_grads(whole, x, dy, scale, bias)
            part = slice(mesh.rank * n, (mesh.rank + 1) * n)
            got = _bn_grads(fn, x[part], dy[part], scale, bias)
            mesh.all_reduce_(got["dscale"])
            mesh.all_reduce_(got["dbias"])
            ref["y"], ref["dx"] = ref["y"][part], ref["dx"][part]
            rule = _step_rule(ref, got, DP_BN_BOUND)
            rows.append((list(shape), rule["diff"], rule["worst"][0][0]))
            del x, dy, ref, got
        rows.sort(key=lambda row: -row[1])
        out[kind] = {"diff": rows[0][1], "bound": DP_BN_BOUND,
                     "held": rows[0][1] <= DP_BN_BOUND,
                     "shapes": len(rows), "worst": rows[:3]}
    return out


DP_BN_REPLAYS = 3  # replays of each captured BatchNorm graph, new inputs


def _bn_graphs(mesh, shapes, eps) -> dict:
    """BatchNorm alone over the cards under NCCL, inside captured CUDA
    graphs (ROADMAP §3 fault 1): at each (rank batch, C, H, W) of
    `shapes`, one graph of `_GlobalBatchNorm`'s forward, its backward
    and the sums of dscale and dbias over the ranks ("global"), or of
    F.batch_norm on the rank's own statistics ("local", the planted
    fault), captured once and replayed DP_BN_REPLAYS times, each replay
    on a new seeded global batch copied into the graph's inputs, held
    against F.batch_norm of the whole global batch (`_bn_alone`'s rule:
    y, dx, dscale, dbias, mean, var within DP_BN_BOUND of each tensor's
    largest element)."""
    import torch.nn.functional as F
    from caffe_mpi_tpu_torch.layers.norm import _GlobalBatchNorm
    dev = mesh.device

    def whole(x, scale, bias):
        var, mean = torch.var_mean(x, [0, 2, 3], correction=0)
        return F.batch_norm(x, None, None, scale, bias, training=True,
                            eps=eps), mean, var

    def global_(x, scale, bias):
        return _GlobalBatchNorm.apply(x, scale, bias, eps, mesh)

    out = {}
    for kind, fn in (("global", global_), ("local", whole)):
        rows = []
        for i, shape in enumerate(shapes):
            n, c = shape[0], shape[1]
            full = (n * mesh.n_data, *shape[1:])
            xs = torch.zeros(shape, device=dev, requires_grad=True)
            dys = torch.zeros(shape, device=dev)
            scale = torch.ones(c, device=dev, requires_grad=True)
            bias = torch.zeros(c, device=dev, requires_grad=True)

            def step():
                y, mean, var = fn(xs, scale, bias)
                dx, ds, db = torch.autograd.grad(y, (xs, scale, bias), dys)
                return (y.detach(), dx, mesh.all_reduce_(ds.clone()),
                        mesh.all_reduce_(db.clone()), mean.detach(),
                        var.detach())

            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                step()  # warm-up before capture
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outs = step()
            worst = (-1.0, None)
            for r in range(DP_BN_REPLAYS):
                g = torch.Generator().manual_seed(100 * i + r)
                x = (torch.randn(full, generator=g) * 2 + 0.5).to(dev)
                dy = torch.randn(full, generator=g).to(dev)
                sc = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
                bi = (0.1 * torch.randn(c, generator=g)).to(dev)
                part = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
                with torch.no_grad():
                    xs.copy_(x[part])
                    dys.copy_(dy[part])
                    scale.copy_(sc)
                    bias.copy_(bi)
                graph.replay()
                torch.cuda.synchronize(dev)
                ref = _bn_grads(whole, x, dy, sc, bi)
                ref["y"], ref["dx"] = ref["y"][part], ref["dx"][part]
                got = dict(zip(("y", "dx", "dscale", "dbias", "mean", "var"),
                               (t.clone() for t in outs)))
                rule = _step_rule(ref, got, DP_BN_BOUND)
                if rule["diff"] > worst[0]:
                    worst = (rule["diff"], rule["worst"][0][0])
                del x, dy, ref, got
            rows.append((list(shape), worst[0], worst[1]))
            del graph, outs, xs, dys
            torch.cuda.empty_cache()
        rows.sort(key=lambda row: -row[1])
        out[kind] = {"diff": rows[0][1], "bound": DP_BN_BOUND,
                     "held": rows[0][1] <= DP_BN_BOUND, "shapes": len(rows),
                     "replays": DP_BN_REPLAYS, "worst": rows[:3]}
    return out


def bn_rank_main(rank: int, world: int, port: int, tmp: str) -> int:
    """A rank of `_bn_cards` (`--bn-rank`): NCCL over `world` cards, one
    a rank, ResNet-50's BatchNorm shapes at its global batch 32."""
    from caffe_mpi_tpu_torch.layers.norm import BatchNormLayer
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.parallel import mesh as mesh_mod
    from caffe_mpi_tpu_torch.proto import NetParameter
    devices = [f"cuda:{i}" for i in range(world)]
    mesh_mod.init_distributed(f"127.0.0.1:{port}", world, rank,
                              backend="nccl", device=torch.device(
                                  devices[rank]))
    mesh = mesh_mod.MeshPlan.from_shape(world, devices=devices)
    resnet = Net(NetParameter.from_file(
        os.path.join(RESNET_DIR, "train_val.prototxt")), "TRAIN",
        device="cpu", batch_divisor=world)
    bns = [l for l in resnet.layers if isinstance(l, BatchNormLayer)]
    out = _bn_graphs(mesh, sorted({tuple(l.in_shapes[0]) for l in bns}),
                     bns[0].eps)
    mesh_mod.cluster_barrier("exit", 120)
    mesh_mod.shutdown_distributed()
    with open(os.path.join(tmp, f"bn{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _bn_cards(n: int, card: str) -> dict:
    """ROADMAP §3 fault 1 over n cards: `bn_rank_main` in n processes;
    the global statistics must hold on every rank, the local ones
    (the planted fault) must not."""
    from caffe_mpi_tpu_torch.parallel.mesh import free_port
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bn_")
    try:
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--bn-rank", str(r), "--bn-world", str(n), "--bn-port",
             str(port), "--bn-dir", tmp], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(n)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=DP_CARDS_DEADLINE))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for r, (proc, (_, err)) in enumerate(zip(procs, outs)):
            if proc.returncode != 0:
                fail(f"bn rank {r} exited {proc.returncode}: {err[-3000:]}")
        ranks = []
        for r in range(n):
            with open(os.path.join(tmp, f"bn{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r, res in enumerate(ranks):
        if not res["global"]["held"] or res["local"]["held"]:
            fail(f"BatchNorm in replayed NCCL graphs, rank {r}: {res}")
    return {"cards": n, "card": card,
            **{f"rank{r}": res for r, res in enumerate(ranks)}}


def dp_rank_main(rank: int, port: int, tmp: str) -> int:
    """One of the two gloo ranks on the one card (`--dp-rank`): every run
    of the dp phase's part (b); the rank's facts go to tmp/rank<k>.json,
    rank 0's states of the rule's runs to tmp/<run>.pt."""
    from caffe_mpi_tpu_torch.parallel import mesh as mesh_mod
    mesh_mod.init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    mesh = mesh_mod.MeshPlan.from_shape(2, devices=["cuda:0", "cuda:0"])
    out = {}
    torch.backends.cudnn.deterministic = True
    for name, net, fault, iters in DP_RULE_RUNS:
        state, out[name] = _dp_run(net, mesh, edit=_float_math,
                                   iters=iters, fault=fault)
        out[name]["digest"] = _digest(state)
        if rank == 0:
            torch.save(state if net == "alexnet" else
                       {k: state[k] for k in _stats_keys(state)},
                       os.path.join(tmp, f"{name}.pt"))
        del state
    _, out["resnet50_timed"] = _dp_run("resnet50", mesh,
                                       iters=DP_TIMED_ITERS)
    from caffe_mpi_tpu_torch.layers.norm import BatchNormLayer
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.proto import NetParameter
    resnet = Net(NetParameter.from_file(
        os.path.join(RESNET_DIR, "train_val.prototxt")), "TRAIN",
        device="cpu", batch_divisor=2)
    bns = [l for l in resnet.layers if isinstance(l, BatchNormLayer)]
    out["bn_alone"] = _bn_alone(
        mesh, sorted({tuple(l.in_shapes[0]) for l in bns}), bns[0].eps)
    del resnet, bns
    torch.cuda.empty_cache()

    def overlap(sp):
        sp.reduce_overlap = True
        sp.reduce_buckets = 6

    def zero(sp):
        sp.zero_stage = 1

    exact = {}
    for name, edit in (("flat", None), ("overlap", overlap),
                       ("zero", zero)):
        exact[name], out[f"exact_{name}"] = _dp_run(
            "alexnet", mesh, edit=edit, iters=DP_EXACT_ITERS)
        out[f"exact_{name}"]["digest"] = _digest(exact[name])
    for name in ("overlap", "zero"):
        bad = [k for k in exact["flat"]
               if not torch.equal(exact["flat"][k], exact[name][k])]
        out[f"exact_{name}"]["equal_to_flat"] = not bad
        out[f"exact_{name}"]["differ"] = bad[:5]
    mesh_mod.cluster_barrier("exit", 120)
    mesh_mod.shutdown_distributed()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _dp_world1(card: str) -> dict:
    """(a): -gpu all (world 1, NCCL) against no -gpu, cuDNN deterministic
    in both."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        runs = {}
        # world 1: every card of a one-card machine, else card 0 (more
        # local ranks run one process each: part (c))
        gpu = "all" if torch.cuda.device_count() == 1 else "0"
        for name, extra in (("gpu_all", ("-gpu", gpu)), ("plain", ())):
            _reset_kernel_counts()
            solver, summary = _train_cli(
                SOLVER, os.path.join(tmp, name), TRAIN_ITERS,
                ("-step_chunk", "10", *extra))
            torch.cuda.synchronize()
            # collectives a replay issues (the graphs are released before
            # the group is left)
            captured = summary["graph_collectives"] \
                if solver.mesh is not None else None
            # an iteration of the last chunk: graph replays only (the
            # first chunks hold the eager iteration and the capture)
            runs[name] = {"state": _state(solver), "summary": summary,
                          "ms": summary["iter_ms"][-1],
                          "counts": _kernel_counts()[:2],
                          "collectives_in_graph": captured}
            del solver
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(tmp, ignore_errors=True)
    g, p = runs["gpu_all"], runs["plain"]
    bad = [k for k in p["state"]
           if not torch.equal(p["state"][k], g["state"][k])]
    s = g["summary"]
    red = s["reduction"] or {}
    if bad:
        fail(f"dp world 1: -gpu all differs from the plain run in {bad[:5]}")
    if not (s["graphs"] and g["collectives_in_graph"]):
        fail(f"dp world 1: graphs {s['graphs']}, collectives captured "
             f"{g['collectives_in_graph']}")
    if g["counts"] != p["counts"] or not all(g["counts"]):
        fail(f"dp world 1: K1/K2 {g['counts']}, plain {p['counts']}")
    if red.get("backend") != "nccl" or s["world"] != 1:
        fail(f"dp world 1: {red}")
    return {"iters": TRAIN_ITERS, "batch": s["batch"], "equal": True,
            "tensors": len(p["state"]), "graphs": s["graphs"],
            "collectives_captured": g["collectives_in_graph"],
            "K1": g["counts"][0], "K2": g["counts"][1],
            "step_ms_replayed": g["ms"], "plain_step_ms_replayed": p["ms"],
            "reduction": red, "card": card}


def _dp_two_ranks(card: str) -> dict:
    """(b): the one-process runs at the global batch, then the two gloo
    ranks (this script with --dp-rank), then the rule: every run of the
    rule in FLOAT math, cuDNN deterministic, DP_RULE_ITERS iterations
    for AlexNet, its forward for ResNet-50, whose float32 gradients are
    not a usable oracle: one step of it in float32 sits up to 0.29 of a
    tensor's largest element from the same step in float64 on the CPU,
    and three steps of a sound run read 2.0 on the card), BatchNorm alone
    at ResNet-50's shapes for the global backward."""
    from caffe_mpi_tpu_torch.parallel.mesh import free_port
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        refs = {"alexnet": _dp_run("alexnet", edit=_float_math)[0],
                "resnet50": _dp_run("resnet50", edit=_float_math,
                                    iters=1)[0]}
    finally:
        torch.backends.cudnn.deterministic = det
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp2_")
    try:
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--dp-rank", str(r), "--dp-port", str(port), "--dp-dir", tmp],
            cwd=ROOT, env=dict(os.environ,
                               CAFFE_TPU_COLLECTIVE_TIMEOUT="300"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=DP_RANK_DEADLINE))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for r, (proc, (_, err)) in enumerate(zip(procs, outs)):
            if proc.returncode != 0:
                fail(f"dp rank {r} exited {proc.returncode}: {err[-3000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        rules = {}
        for name, net, _, _ in DP_RULE_RUNS:
            got = torch.load(os.path.join(tmp, f"{name}.pt"))
            rules[name] = _step_rule(refs[net], got, DP_RULE_BOUND) \
                if net == "alexnet" else _step_rule(
                    refs[net], got, DP_STATS_BOUND, _stats_keys(got))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del refs
    torch.cuda.empty_cache()
    r0, r1 = ranks
    # under a BatchNorm fault a rank's own statistics differ from the other's
    local_bn = {name for name, _, fault, _ in DP_RULE_RUNS
                if fault in ("bn_all", "bn_last")}
    for name in r0:
        if name not in local_bn and "digest" in r0[name] \
                and r0[name]["digest"] != r1[name]["digest"]:
            fail(f"dp two ranks: {name}: the ranks' states differ")
    for name, _, fault, _ in DP_RULE_RUNS:
        if rules[name]["held"] == bool(fault):
            fail(f"dp two ranks: {name} (planted fault {fault}) "
                 f"{'held' if fault else 'broke'} the rule: {rules[name]}")
    for r, facts in enumerate(ranks):
        bn = facts["bn_alone"]
        if not bn["global"]["held"] or bn["local"]["held"]:
            fail(f"dp two ranks: BatchNorm alone, rank {r}: {bn}")
    for name in ("exact_overlap", "exact_zero"):
        if not r0[name]["equal_to_flat"]:
            fail(f"dp two ranks: {name} differs from flat in "
                 f"{r0[name]['differ']}")
    red = r0["exact_overlap"]["reduction"]
    if red["mode"] != "bucketed" or red["reduce_buckets"] != 6:
        fail(f"dp two ranks: overlap {red}")
    for name in ("alexnet", "exact_flat"):
        for r in ranks:
            if not (r[name]["launches"]["K1"] and r[name]["launches"]["K2"]):
                fail(f"dp two ranks: {name}: K1/K2 {r[name]['launches']}")
    keep = ("step_ms", "collective_ms_per_step", "collectives_per_step",
            "launches", "graphs")
    out = {"rule": rules, "card": card,
           "bn_alone": {f"rank{r}": facts.pop("bn_alone")
                        for r, facts in enumerate(ranks)}}
    for name in r0:
        out[name] = {"rank0": {k: r0[name][k] for k in keep},
                     "rank1": {k: r1[name][k] for k in keep},
                     "reduction": r0[name]["reduction"]}
        if "equal_to_flat" in r0[name]:
            out[name]["equal_to_flat"] = r0[name]["equal_to_flat"]
    return out


def _dp_cli(tmp, name, gpu, extra=(), solver=SOLVER) -> dict:
    """`cli train` of a solver (AlexNet's by default) on `-gpu` in a
    process of its own (its workers, one a card, under NCCL): rank 0's
    summary."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "caffe_mpi_tpu_torch.tools.cli", "train",
         "-solver", solver, "-synthetic", "-max_iter", str(TRAIN_ITERS),
         "-test_iter", str(TEST_ITER), "-step_chunk", "10",
         "-snapshot_prefix", os.path.join(tmp, name), "-gpu", gpu, *extra],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=DP_CARDS_DEADLINE)
    except subprocess.TimeoutExpired:
        # SIGTERM: the CLI kills its workers' process groups, then exits
        proc.terminate()
        out, err = proc.communicate()
        fail(f"dp -gpu {gpu} {' '.join(extra)}: over {DP_CARDS_DEADLINE} s: "
             f"{err[-3000:]}")
    lines = [l for l in out.splitlines() if l.startswith('{"train"')]
    if proc.returncode != 0 or len(lines) != 1:
        fail(f"dp -gpu {gpu} {' '.join(extra)}: exit {proc.returncode}, "
             f"{len(lines)} summaries: {err[-3000:]}")
    return json.loads(lines[0])["train"]


def _dp_cards(card: str) -> dict | None:
    """(c): NCCL over min(cards, 4) through the CLI, flat and with
    `-reduce_overlap` (6 buckets from the hooks, on a side stream, in the
    chunk's graph), against world 1 on card 0 at the same global batch;
    None on one card."""
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        return None
    cards = ",".join(str(i) for i in range(n))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dpn_")
    try:
        runs = {"world1": _dp_cli(tmp, "w1", "0"),
                "flat": _dp_cli(tmp, "flat", cards),
                "overlap": _dp_cli(tmp, "overlap", cards,
                                   ("-reduce_overlap",))}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ref = np.asarray(runs["world1"]["losses"])
    out = {"cards": n, "card": card}
    for name, s in runs.items():
        red = s["reduction"] or {}
        if not (s["graphs"] and s["graph_collectives"]
                and np.all(np.isfinite(s["losses"]))
                and s["kernel_launches"]["K1"] and s["kernel_launches"]["K2"]
                and red.get("backend") == "nccl" and s["batch"] == 256):
            fail(f"dp over {n} cards, {name}: {s}")
        out[name] = {
            "world": s["world"], "rank_batch": s["rank_batch"],
            "step_ms_replayed": s["iter_ms"][-1],
            "window_img_per_s": s["window_img_per_s"],
            "max_rel_loss_diff_vs_world1": float(np.max(
                np.abs(np.asarray(s["losses"]) - ref) / np.abs(ref))),
            "reduction": red, "kernel_launches_rank0": s["kernel_launches"]}
    if out["overlap"]["reduction"].get("mode") != "bucketed":
        fail(f"dp over {n} cards: overlap {out['overlap']['reduction']}")
    out["resnet50"] = _dp_cards_resnet50(n, card)
    out["bn_graphs_nccl"] = _bn_cards(n, card)
    return out


def _dp_cards_resnet50(n: int, card: str) -> dict:
    """ResNet-50 (b32) over n cards under NCCL through the CLI against
    world 1 on card 0: its BatchNorms' all-gathers and all-reduces in
    the chunk's graph. The first iteration (eager, every BatchNorm's
    statistics the global batch's) holds its loss within DP_STATS_BOUND
    of world 1's; later losses are printed, not held (ResNet-50's float32
    gradients differ run to run by more than its updates move them)."""
    solver = os.path.join(RESNET_DIR, "solver.prototxt")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dpr_")
    try:
        w1 = _dp_cli(tmp, "w1", "0", solver=solver)
        s = _dp_cli(tmp, "cards", ",".join(str(i) for i in range(n)),
                    solver=solver)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ref, got = np.asarray(w1["losses"]), np.asarray(s["losses"])
    rel = np.abs(got - ref) / np.abs(ref)
    red = s["reduction"] or {}
    if not (s["graphs"] and s["graph_collectives"] and np.all(np.isfinite(got))
            and red.get("backend") == "nccl" and s["batch"] == 32
            and rel[0] <= DP_STATS_BOUND):
        fail(f"dp ResNet-50 over {n} cards: {s}, first loss {rel[0]}")
    return {"world": s["world"], "rank_batch": s["rank_batch"],
            "first_loss_rel_diff_vs_world1": float(rel[0]),
            "bound": DP_STATS_BOUND,
            "max_rel_loss_diff_vs_world1": float(rel.max()),
            "losses": s["losses"], "world1_losses": w1["losses"],
            "graph_collectives": s["graph_collectives"],
            "step_ms_replayed": s["iter_ms"][-1],
            "world1_step_ms_replayed": w1["iter_ms"][-1],
            "window_img_per_s": s["window_img_per_s"],
            "world1_window_img_per_s": w1["window_img_per_s"],
            "reduction": red, "card": card}


def dp_phase(k1: dict, k2: dict, card: str) -> dict:
    out = {"world1_nccl": _dp_world1(card)}
    log(f"dp world1_nccl: {json.dumps(out['world1_nccl'])}")
    k1["launches_by_path"]["dp_world1"] = out["world1_nccl"]["K1"]
    k2["launches_by_path"]["dp_world1"] = out["world1_nccl"]["K2"]
    out["two_ranks_gloo"] = _dp_two_ranks(card)
    a = out["two_ranks_gloo"]["alexnet"]
    for k, counter in (("K1", k1), ("K2", k2)):
        for r in ("rank0", "rank1"):
            counter["launches_by_path"][f"dp_gloo_{r}"] = \
                a[r]["launches"][k]
    out["nccl_cards"] = _dp_cards(card)
    log(f"dp: {json.dumps(out)}")
    return out


# -- 24. mp: the mesh's 'model' axis ----------------------------------------

MP_ITERS = 3             # Adam (transformer_lm) / SGD (AlexNet) iterations
MP_CARDS_ITERS = 10      # part (b): step ms is the median after the first
MP_RANK_DEADLINE = 600   # a gloo rank process of part (a)
MP_CARDS_DEADLINE = 300  # a CLI run over the cards, part (b)
MP_FIRST_LOSS = 1e-3     # part (b): the first loss against one process
# the bf16 ring against single-device flash_attention (the second check;
# the first holds it against its own blocks on one card at FLASH_TOL):
# FLASH_TOL's rtol plus 2^-6 of the tensor's largest element, at least
# two bf16 ulps of it. The ring rounds each block's output (K3) and dK/dV
# partial (K5) to bf16 before its f32 merge and sum, as the JAX ring does
# (flash_block returns the input's type), so a sum of partials that
# cancel is off by their ulps, not its own; the one-card ring's own
# distance from one device is printed beside it
MP_RING_BF16_SHARE = 2.0 ** -6
TLM_SP_SOLVER = os.path.join(TLM_DIR, "solver_sp.prototxt")
TLM_PP_SOLVER = os.path.join(TLM_DIR, "solver_pp.prototxt")
# expert parallelism over the model ranks: train_val_sp's MoE banks
MP_EP = {"blk1/moe": {"w1": ("model",), "b1": ("model",), "w2": ("model",),
                      "b2": ("model",)}}
# (run, solver, flash, param_shardings, planted fault) of part (a)'s two
# ranks; every run and its fault against the one-process run of its
# reference (the EP run's is the sp run: the split changes no math)
MP_RUNS = (("sp", "sp", False, None, None),
           ("sp_fault", "sp", False, None, "no_rotation"),
           ("sp_flash", "sp", True, None, None),
           ("sp_flash_fault", "sp", True, None, "merge"),
           ("sp_ep", "sp", False, MP_EP, None),
           ("sp_ep_fault", "sp", False, MP_EP, "no_combine_sum"),
           ("alexnet_tp", "alexnet_tp", False, None, None),
           ("alexnet_tp_fault", "alexnet_tp", False, None, "no_copy_sum"))
MP_PP_RUNS = (("pp", "pp", False, None, None),
              ("pp_fault", "pp", False, None, "dy_summed"))
# the four ranks' (2, 2) mesh (the model axis with data parallelism):
# (run, solver, flash, param_shardings, planted fault, solver fields,
# iterations). The flash ring at step_chunk MP_CHUNK against step_chunk
# 1 (one iteration, then one chunk); AlexNet rows/cols with ZeRO-1 and
# its planted fault (rank 0 updates the other data rank's slice of its
# slots' params), and with fc6 gathered on use (a ("data", "model")
# split), each against the one-process AlexNet run
MP_CHUNK = 10
MP_22_RUNS = (
    ("sp_flash_k1", "sp", True, None, None, {"step_chunk": 1},
     MP_CHUNK + 1),
    ("sp_flash_k10", "sp", True, None, None, {"step_chunk": MP_CHUNK},
     MP_CHUNK + 1),
    ("alexnet_zero", "alexnet_tp", False, None, None, {"zero_stage": 1},
     MP_ITERS),
    ("alexnet_zero_fault", "alexnet_tp", False, None, "zero_wrong_slice",
     {"zero_stage": 1}, MP_ITERS),
    ("alexnet_gou", "alexnet_tp", False, {"fc6": ("data", "model")}, None,
     {}, MP_ITERS))
MP_TEST_BATCH = 3  # a test batch that does not divide the 2 data ranks
# the whole-batch test passes of a run on the 2 x 2 mesh before training:
# a second pass at step_chunk MP_CHUNK is a chunk the solver would capture
# on the NCCL route (under gloo it must run eagerly)
MP_22_TESTS = {"sp_flash_k1": 1, "sp_flash_k10": 2, "alexnet_zero": 1}


def _mp_solver_param(net: str, flash: bool, fields=None, test=False):
    """The run's solver in FLOAT math, no snapshots, display or tests:
    transformer_lm's solver_sp / solver_pp as written (use_flash switched
    on in a copy of the net for `flash`), or AlexNet's with fc6 split by
    rows and fc7 by cols; then the solver `fields`. `test`: one test net,
    the train net at batch MP_TEST_BATCH, one batch a pass."""
    from caffe_mpi_tpu_torch.proto import SolverParameter
    path = {"sp": TLM_SP_SOLVER, "pp": TLM_PP_SOLVER,
            "alexnet_tp": SOLVER}[net]
    sp = SolverParameter.from_file(path)
    sp.snapshot, sp.display, sp.test_interval, sp.step_chunk = 0, 0, 0, 1
    _float_math(sp)
    for lp in sp.net_param.layer:
        if flash and lp.type == "Attention":
            lp.attention_param.use_flash = True
        if net == "alexnet_tp" and lp.name in ("fc6", "fc7"):
            lp.param_sharding = "rows" if lp.name == "fc6" else "cols"
    for key, value in (fields or {}).items():
        setattr(sp, key, value)
    if test:
        param = copy.deepcopy(sp.net_param)
        for lp in param.layer:
            if lp.type == "Input" and lp.input_param:
                for shape in lp.input_param.shape:
                    shape.dim[0] = MP_TEST_BATCH
        sp.test_net_param, sp.test_iter = [param], [1]
    return sp


def _mp_state(solver) -> dict:
    """Params, history slots and running statistics whole: a rank's
    shards gathered over the model axis (a collective)."""
    out = {}
    hist = solver.full_history()
    for lname, pname, _, p in solver._decls:
        p = solver.net.gather_param(lname, pname, p)
        out[f"{lname}.{pname}"] = p.detach().cpu().clone()
        for i, h in enumerate(hist[(lname, pname)]):
            out[f"{lname}.{pname}.h{i}"] = h.cpu().clone()
    for lname, sname, buf in solver.net.state_buffers():
        out[f"{lname}.{sname}"] = buf.cpu().clone()
    return out


def _swapped_merge(O, LSE, out_b, lse_b):
    """The planted fault of the flash ring: each side weighted by the
    other's share."""
    M = torch.maximum(LSE, lse_b)
    a, bw = torch.exp(LSE - M), torch.exp(lse_b - M)
    denom = a + bw
    O = (O * bw[..., None] + out_b * a[..., None]) / denom[..., None]
    return O, M + torch.log(denom)


class _SumDy(torch.autograd.Function):
    """Identity forward; the backward multiplies by n: the replicated
    output gradient summed over n model ranks (the pipeline's fault)."""

    @staticmethod
    def forward(ctx, y, n):
        ctx.n = n
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        return dy * ctx.n, None


def _mp_fault(fault, mesh, solver=None):
    """Plant `fault` in this process (`solver`'s own); returns the
    undo."""
    from caffe_mpi_tpu_torch.layers import composite
    from caffe_mpi_tpu_torch.ops import attention
    from caffe_mpi_tpu_torch.parallel import mesh as mesh_mod
    if fault is None:
        return lambda: None
    if fault == "no_rotation":      # K/V never leave their rank
        real = mesh.model_shift
        mesh.model_shift = lambda ts, shift=-1: [t.clone() for t in ts]
        return lambda: setattr(mesh, "model_shift", real)
    if fault == "merge":
        real = attention._merge_blocks
        attention._merge_blocks = _swapped_merge
        return lambda: setattr(attention, "_merge_blocks", real)
    if fault in ("no_combine_sum", "no_copy_sum"):
        # MoE's combine not summed over the ranks / the column-parallel
        # input's gradient not summed
        name = {"no_combine_sum": "reduce_from_model",
                "no_copy_sum": "copy_to_model"}[fault]
        real = getattr(mesh_mod, name)
        setattr(mesh_mod, name, lambda x, plan: x)
        return lambda: setattr(mesh_mod, name, real)
    if fault == "zero_wrong_slice":  # planted after the first step
        return lambda: None
    if fault == "dy_summed":
        real = composite.pipeline_apply
        composite.pipeline_apply = lambda fn, p, mb, plan: _SumDy.apply(
            real(fn, p, mb, plan), plan.n_model)
        return lambda: setattr(composite, "pipeline_apply", real)
    fail(f"unknown planted fault {fault!r}")


def _wrong_slot_slices(solver) -> None:
    """The planted ZeRO-1 fault: rank 0's slot shards over 'data' take
    the next data index's slices (every rank gathers the slots, rank 0
    copies)."""
    whole = solver.full_history()
    mesh = solver.mesh
    if mesh.rank != 0:
        return
    for key, shard in solver._shard_len.items():
        if shard is None:
            continue
        lo = (mesh.data_index + 1) % mesh.n_data * shard
        for slot, w in zip(solver.history[key], whole[key]):
            slot.copy_(w[lo:lo + shard])


def _mp_run(net, flash=False, shardings=None, mesh=None, fault=None,
            iters=MP_ITERS, fields=None, test=0, snap=None):
    """`iters` iterations of a run on its synthetic global batch (this
    rank's data slice under `mesh`), every count 0 just before: (whole
    state, facts). The solver `fields` set (step_chunk runs the last
    iters - 1 as chunks); `test`: that many passes of the whole-batch
    test net before training, each pass's scores; `snap`: sharded
    snapshots in that directory before training and at the end, beside
    the gathered one (`_mp_snapshots`)."""
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.tools import cli
    sp = _mp_solver_param(net, flash, fields, test > 0)
    solver = Solver(sp, device=None if mesh else "cuda", mesh=mesh,
                    param_shardings=shardings)
    rank, world = (mesh.data_index, mesh.n_data) if mesh else (0, 1)
    feeds = cli.synthetic_feed(solver.net, 0, rank, world)
    scores = None
    if test:
        tfeeds = cli.synthetic_feed(solver.test_nets[0], 1, 0, 1)
        scores = [solver.test_all([lambda it: tfeeds])[0]
                  for _ in range(test)]
    if snap is not None:  # the older set restore_auto falls back to
        solver.snapshot_format = "ORBAX"
        solver.sp.snapshot_prefix = os.path.join(snap, "z")
        solver.snapshot()
    undo = _mp_fault(fault, mesh, solver)
    try:
        _reset_kernel_counts()
        torch.cuda.synchronize()
        solver.step(1, lambda it: feeds)
        if fault == "zero_wrong_slice":
            _wrong_slot_slices(solver)
        if mesh is not None:
            mesh.timing = True
            mesh.collective_ms()
            mesh.model_bytes = 0
        solver.step(iters - 1, lambda it: feeds)
        torch.cuda.synchronize()
    finally:
        undo()
    counts = _kernel_counts()
    facts = {"launches": dict(zip(("K1", "K2", "K3", "K4", "K5"), counts)),
             "step_ms": float(np.median(solver.iter_ms[1:])),
             "losses": list(solver.losses), "test_scores": scores,
             "graph_route": solver.graph_route,
             "graph_replays": solver.graph_replays,
             "test_graphs": len(solver._test_graphs)}
    if not np.all(np.isfinite(facts["losses"])):
        fail(f"mp {net}: losses {facts['losses']}")
    if mesh is not None:
        facts["collective_ms_per_step"] = \
            mesh.collective_ms() / (iters - 1)
        facts["model_bytes_per_step"] = mesh.model_bytes / (iters - 1)
        facts["reduction"] = solver.reduction_stats()
        mesh.timing = False
        facts["shards"] = {f"{l.name}.{p}": d
                           for l in solver.net.layers
                           for p, d in l.shards.items()}
    state = _mp_state(solver)
    if snap is not None:
        facts["snapshot"] = _mp_snapshots(solver, sp, shardings, mesh, snap,
                                          state)
    state["loss"] = torch.tensor(solver.losses)
    solver.release_graphs()  # before the group can be left
    del solver, feeds
    torch.cuda.empty_cache()
    return state, facts


def _mp_snapshots(solver, sp, shardings, mesh, snap, state) -> dict:
    """The sharded snapshot of the run's final state and the gathered
    (BINARYPROTO) one of the same state, each call's wall ms on this
    rank; then a fresh solver on the same mesh restores the sharded set,
    whose whole state must equal `state` element for element."""
    from caffe_mpi_tpu_torch.solver import Solver
    out = {}
    for fmt, stem in (("ORBAX", "z"), ("BINARYPROTO", "g")):
        solver.snapshot_format = fmt
        solver.sp.snapshot_prefix = os.path.join(snap, stem)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[fmt] = solver.snapshot()
        out[f"{fmt}_ms"] = (time.perf_counter() - t0) * 1e3
    again = Solver(sp, mesh=mesh, param_shardings=shardings)
    again.restore(out["ORBAX"])
    back = _mp_state(again)
    out["restored_iter"] = again.iter
    out["restored_unequal"] = [k for k, v in state.items()
                               if not torch.equal(back[k], v)]
    del again, back
    return out


def _mp_restore_one(snap: dict) -> dict:
    """The sharded set restored in one process on the card, every array
    against the gathered snapshot of the same iteration, element for
    element; then a byte of its biggest shard flipped, and restore_auto
    must fall back to the older set."""
    from caffe_mpi_tpu_torch import io as caffe_io
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.utils import resilience
    one = Solver(_mp_solver_param("alexnet_tp", False), device="cuda")
    t0 = time.perf_counter()
    one.restore(snap["ORBAX"])
    torch.cuda.synchronize()
    read_ms = (time.perf_counter() - t0) * 1e3
    gathered = snap["BINARYPROTO"]
    model = caffe_io.load_weights(gathered.replace(".solverstate",
                                                   ".caffemodel"))
    it, _, history, _ = caffe_io.load_solverstate(gathered)
    n, unequal, arrays = len(one._decls), [], 0
    for i, (lname, pname, _, p) in enumerate(one._decls):
        arrays += 1 + len(one.history[(lname, pname)])
        names = [b for _, b in one.net.layer_by_name(lname).caffe_blobs()]
        blob = np.asarray(model[lname][names.index(pname)])
        if not np.array_equal(p.detach().float().cpu().numpy(),
                              blob.reshape(tuple(p.shape))):
            unequal.append(f"{lname}.{pname}")
        for k, slot in enumerate(one.history[(lname, pname)]):
            if not np.array_equal(slot.cpu().numpy(), np.asarray(
                    history[i + k * n]).reshape(tuple(slot.shape))):
                unequal.append(f"{lname}.{pname}.h{k}")
    if unequal or one.iter != it:
        fail(f"mp sharded snapshot restored in one process: iter "
             f"{one.iter} against {it}, unequal {unequal[:5]}")
    victim = resilience.sharded_snapshot_files(snap["ORBAX"])[0]
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    prefix = snap["ORBAX"][: -len(f"_iter_{it}.orbax")]
    fell_back = one.restore_auto(prefix)
    if not (fell_back or "").endswith("_iter_0.orbax") or one.iter != 0:
        fail(f"mp: restore_auto past a flipped shard took {fell_back}")
    del one
    torch.cuda.empty_cache()
    return {"iter": it, "arrays": arrays, "read_ms": read_ms,
            "flipped": os.path.basename(victim), "fell_back_to": fell_back}


def _ring_one_card(q, k, v, dy, n: int, causal: bool):
    """The flash ring's arithmetic on one card, without the transport:
    for each of the n ring positions the same S/n blocks through
    flash_block / flash_block_bwd (K3; K4, K5), skipped by the same
    `_block_pred`, merged in f32 by the same `_merge_blocks`, dQ summed
    in ring order and each dK/dV block in the order its sum rides the
    ring. (out, dq, dk, dv) of the whole (B, S, H, D)."""
    from caffe_mpi_tpu_torch.ops import attention as att
    from caffe_mpi_tpu_torch.ops.flash_attention import (
        _delta, flash_block, flash_block_bwd)
    b, s, h, d = q.shape
    sl = s // n
    q2, k2, v2, dy2 = (att._to_heads2(t) for t in (q, k, v, dy))

    def blk(t, j):
        return t[:, j * sl:(j + 1) * sl].contiguous()

    f32 = dict(dtype=torch.float32, device=q.device)
    outs, lses = [], []
    for my in range(n):
        O = torch.zeros((b * h, sl, d), **f32)
        LSE = torch.full((b * h, sl), -math.inf, **f32)
        for i in range(n):
            src = (my + i) % n
            if att._block_pred(i, causal, my, src, sl, None):
                out_b, lse_b = flash_block(
                    blk(q2, my), blk(k2, src), blk(v2, src),
                    causal=causal and i == 0)
                O, LSE = att._merge_blocks(O, LSE, out_b.float(), lse_b)
        outs.append(O.to(q.dtype))
        lses.append(LSE)
    deltas = [_delta(blk(dy2, my), outs[my]) for my in range(n)]
    dq = [torch.zeros((b * h, sl, d), **f32) for _ in range(n)]
    dk = [torch.zeros((b * h, sl, d), **f32) for _ in range(n)]
    dv = [torch.zeros((b * h, sl, d), **f32) for _ in range(n)]
    # ring step i: position my adds to block (my + i) % n, whose sum was
    # started by position src and passed down through src - 1, ...
    for i in range(n):
        for my in range(n):
            src = (my + i) % n
            if not att._block_pred(i, causal, my, src, sl, None):
                continue
            dq_i, dk_b, dv_b = flash_block_bwd(
                blk(q2, my), blk(k2, src), blk(v2, src), outs[my],
                lses[my], blk(dy2, my), causal=causal and i == 0,
                delta=deltas[my])
            dq[my] = dq[my] + dq_i.float()
            dk[src] = dk[src] + dk_b.float()
            dv[src] = dv[src] + dv_b.float()
    return tuple(att._from_heads2(torch.cat(parts, 1).to(q.dtype), b, h)
                 for parts in (outs, dq, dk, dv))


def _within(got, want, rtol: float, share: float) -> tuple[float, bool]:
    """Max abs error of got against want, and whether every element is
    within share x want's largest element + rtol x |want|."""
    got, want = got.detach().float(), want.detach().float()
    diff = (got - want).abs()
    return float(diff.max()), bool(torch.all(
        diff <= share * float(want.abs().max()) + rtol * want.abs()))


def _mp_ring(mesh) -> dict:
    """ring_flash_attention over the ranks at transformer_lm's shape (B 8
    x H 4 = 32, S 64 (32 a rank), D 32), causal, f32 and bf16: the output
    and dQ/dK/dV against the same ring's blocks on one card
    (`_ring_one_card`) at FLASH_TOL, and against single-device
    flash_attention on the same card at FLASH_TOL (bf16: FLASH_TOL's rtol
    with MP_RING_BF16_SHARE); the K3/K4/K5 launches of the ring against
    ring_flash_launches. The swapped merge, planted in f32 and in bf16,
    must break FLASH_TOL against the one-card ring."""
    from caffe_mpi_tpu_torch.ops import attention as att
    from caffe_mpi_tpu_torch.ops.flash_attention import flash_attention
    b, h, s, d = 8, 4, FLASH_PATH["s"], FLASH_PATH["d"]
    want = att.ring_flash_launches(mesh.n_model, True, s // mesh.n_model)
    out = {}
    for label, dtype, fault in (("f32", torch.float32, None),
                                ("bf16", torch.bfloat16, None),
                                ("f32_merge_fault", torch.float32, "merge"),
                                ("bf16_merge_fault", torch.bfloat16,
                                 "merge")):
        g = torch.Generator().manual_seed(7)
        q, k, v, dy = (torch.randn(b, s, h, d, generator=g).to(
            "cuda", dtype) for _ in range(4))
        qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
        ref = flash_attention(qs, ks, vs, causal=True)
        ref.backward(dy)
        one = dict(zip(("out", "dq", "dk", "dv"),
                       _ring_one_card(q, k, v, dy, mesh.n_model, True)))
        qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
        undo = _mp_fault(fault, mesh)
        try:
            _reset_flash_counts()
            got = att.sequence_parallel_attention(qr, kr, vr, mesh,
                                                  causal=True,
                                                  use_flash=True)
            got.backward(dy)
            torch.cuda.synchronize()
            counts = _flash_counts()
        finally:
            undo()
        rtol, share = FLASH_TOL[dtype]
        flash_share = MP_RING_BF16_SHARE if dtype == torch.bfloat16 \
            else share
        errs, errs_flash, errs_one_flash = {}, {}, {}
        held = held_flash = True
        for key, a, w in (("out", got, ref), ("dq", qr.grad, qs.grad),
                          ("dk", kr.grad, ks.grad), ("dv", vr.grad, vs.grad)):
            errs[key], ok = _within(a, one[key], rtol, share)
            held &= ok
            errs_flash[key], ok = _within(a, w, rtol, flash_share)
            held_flash &= ok
            # the one-card ring's own distance from one device
            errs_one_flash[key], _ = _within(one[key], w, rtol, flash_share)
        out[label] = {"max_abs_err": errs, "held": held, "rtol": rtol,
                      "share_of_largest": share,
                      "vs_flash_attention": {
                          "max_abs_err": errs_flash, "held": held_flash,
                          "share_of_largest": flash_share,
                          "one_card_ring_max_abs_err": errs_one_flash},
                      "launches": dict(zip(("K3", "K4", "K5"), counts)),
                      "predicted": want[mesh.model_index]}
        if fault is None and (not held or not held_flash or counts != (
                want[mesh.model_index],) * 3):
            fail(f"mp ring {label}, rank {mesh.model_index}: {out[label]}")
        if fault is not None and held:
            fail(f"mp ring: the planted fault held FLASH_TOL: {out[label]}")
    return out


def mp_rank_main(rank: int, world: int, port: int, tmp: str,
                 nccl: bool = False) -> int:
    """A rank of the mp phase (`--mp-rank`). Part (a), gloo ranks sharing
    card 0: a 1 x world mesh; two ranks run the ring check and MP_RUNS,
    four ranks MP_PP_RUNS and then, on a 2 x 2 mesh, MP_22_RUNS (the
    ZeRO-1 run writes its sharded and gathered snapshots to tmp/snap).
    `nccl` (part (b), a card a rank), on a 2 x 2 mesh: AlexNet rows/cols
    with ZeRO-1 and its snapshots; then the flash solver_sp at step_chunk
    1 and MP_CHUNK with MP_22_TESTS' test passes, the second run's CUDA
    graphs dumped to tmp/graphs/r<k> (`_dumping_graphs`). Facts go to
    tmp/rank<k>.json, rank 0's whole states to tmp/<run>.pt."""
    from caffe_mpi_tpu_torch.parallel import mesh as mesh_mod
    mesh_mod.init_distributed(
        f"127.0.0.1:{port}", world, rank, backend="nccl" if nccl else "gloo",
        device=torch.device(f"cuda:{rank}") if nccl else None)
    torch.backends.cudnn.deterministic = True
    out = {}
    snap = os.path.join(tmp, "snap")
    os.makedirs(snap, exist_ok=True)
    if nccl:
        mesh = mesh_mod.MeshPlan.from_shape(2, 2)
        _, out["alexnet_zero"] = _mp_run("alexnet_tp", mesh=mesh,
                                         fields={"zero_stage": 1}, snap=snap)
        log(f"mp rank {rank}: alexnet_zero {json.dumps(out['alexnet_zero'])}")
        for name, net, flash, _, _, fields, iters in MP_22_RUNS[:2]:
            undo = _dumping_graphs(os.path.join(tmp, "graphs", f"r{rank}")) \
                if fields["step_chunk"] > 1 else (lambda: None)
            try:
                state, out[name] = _mp_run(net, flash, None, mesh, None,
                                           iters, fields,
                                           test=MP_22_TESTS[name])
            finally:
                undo()
            log(f"mp rank {rank}: {name} {json.dumps(out[name])}")
            if rank == 0:
                torch.save(state, os.path.join(tmp, f"{name}.pt"))
            del state
        gc.collect()  # no captured graph outlives the group
        runs = ()
    else:
        mesh = mesh_mod.MeshPlan.from_shape(1, world,
                                            devices=["cuda:0"] * world)
        runs = MP_RUNS if world == 2 else MP_PP_RUNS
    if world == 2:
        out["ring"] = _mp_ring(mesh)
    for name, net, flash, shardings, fault in runs:
        state, out[name] = _mp_run(net, flash, shardings, mesh, fault)
        if rank == 0:
            torch.save(state, os.path.join(tmp, f"{name}.pt"))
        del state
    if world == 4 and not nccl:
        mesh = mesh_mod.MeshPlan.from_shape(2, 2, devices=["cuda:0"] * 4)
        for name, net, flash, shardings, fault, fields, iters in MP_22_RUNS:
            state, out[name] = _mp_run(
                net, flash, shardings, mesh, fault, iters, fields,
                test=MP_22_TESTS.get(name, 0),
                snap=snap if name == "alexnet_zero" else None)
            if rank == 0:
                torch.save(state, os.path.join(tmp, f"{name}.pt"))
            del state
    mesh_mod.cluster_barrier("exit", 120)
    mesh_mod.shutdown_distributed()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _dumping_graphs(dump: str):
    """Make every CUDA graph this process captures from now on keep its
    cudaGraph_t past the capture (`keep_graph`), write it to `dump` as
    DOT (cudaGraphDebugDotPrint: each kernel node by its function's
    name) and then instantiate it; returns the undo."""
    real = torch.cuda.CUDAGraph
    os.makedirs(dump, exist_ok=True)
    written = []

    class Dumped(real):
        def __new__(cls, keep_graph=False):
            return super().__new__(cls, keep_graph=True)

        def __init__(self, keep_graph=False):
            super().__init__(keep_graph=True)

        def capture_end(self):
            super().capture_end()
            written.append(os.path.join(dump, f"graph_{len(written)}.dot"))
            self.debug_dump(written[-1])
            self.instantiate()

    torch.cuda.CUDAGraph = Dumped
    return lambda: setattr(torch.cuda, "CUDAGraph", real)


def _mp_start(world: int, tmp: str, nccl: bool = False) -> list:
    """Start `world` rank processes of this script: gloo ranks on card 0,
    or (`nccl`) one a card."""
    from caffe_mpi_tpu_torch.parallel.mesh import free_port
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--mp-rank", str(r), "--mp-world", str(world), "--mp-port",
         str(port), "--mp-dir", tmp, *(["--mp-nccl"] if nccl else [])],
        cwd=ROOT,
        env=dict(os.environ, CAFFE_TPU_COLLECTIVE_TIMEOUT="300"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def _mp_ranks(procs: list, tmp: str) -> list[dict]:
    """Wait for the rank processes `_mp_start` started; each rank's
    facts."""
    world = len(procs)
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=MP_RANK_DEADLINE))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, (_, err)) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            fail(f"mp rank {r} of {world} exited {proc.returncode}: "
                 f"{err[-3000:]}")
    ranks = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def _mp_one_card(card: str) -> dict:
    """(a): the one-process references (FLOAT math, cuDNN
    deterministic), then two gloo ranks sharing the card (the ring and
    MP_RUNS) and, at the same time, four (MP_PP_RUNS), each run held to
    its reference by
    `_step_rule` at DP_RULE_BOUND over every param, history slot and the
    losses, each planted fault outside it; the ranks' states (whole)
    equal; K3-K5 launches of the flash run as `ring_flash_launches`
    predicts."""
    from caffe_mpi_tpu_torch.ops.attention import ring_flash_launches
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    refs, ref_facts = {}, {}
    try:
        for net, flash in (("sp", False), ("sp", True), ("alexnet_tp", False),
                           ("pp", False)):
            key = net + ("_flash" if flash else "")
            refs[key], ref_facts[key] = _mp_run(
                net, flash, test=int(key in ("alexnet_tp", "sp_flash")))
    finally:
        torch.backends.cudnn.deterministic = det
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        # the two groups run at once (their step ms share the card)
        dirs = {n: os.path.join(tmp, f"w{n}") for n in (2, 4)}
        procs = {}
        try:
            for n, d in dirs.items():
                os.makedirs(d)
                procs[n] = _mp_start(n, d)
            two = _mp_ranks(procs[2], dirs[2])
            four = _mp_ranks(procs[4], dirs[4])
        finally:  # a failed group leaves none of the other's running
            for proc in sum(procs.values(), []):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        rules = {}
        for name, net, flash, _, fault in MP_RUNS + MP_PP_RUNS:
            got = torch.load(os.path.join(
                dirs[4 if net == "pp" else 2], f"{name}.pt"))
            ref = refs[net + ("_flash" if flash else "")]
            rules[name] = _step_rule(ref, got, DP_RULE_BOUND)
            if rules[name]["held"] == bool(fault):
                fail(f"mp {name} (planted fault {fault}) "
                     f"{'held' if fault else 'broke'} the rule: "
                     f"{rules[name]}")
        # the (2, 2) mesh: step_chunk MP_CHUNK against 1, the AlexNet runs
        # against the one-process one
        k1 = torch.load(os.path.join(dirs[4], "sp_flash_k1.pt"))
        for name, net, _, _, fault, _, _ in MP_22_RUNS[1:]:
            got = torch.load(os.path.join(dirs[4], f"{name}.pt"))
            rules[name] = _step_rule(k1 if net == "sp" else refs[net], got,
                                     DP_RULE_BOUND)
            if rules[name]["held"] == bool(fault):
                fail(f"mp {name} (planted fault {fault}) "
                     f"{'held' if fault else 'broke'} the rule: "
                     f"{rules[name]}")
        snap = four[0]["alexnet_zero"]["snapshot"]
        for r, ranks in enumerate(four):
            back = ranks["alexnet_zero"]["snapshot"]
            if back["restored_unequal"] or back["restored_iter"] != MP_ITERS:
                fail(f"mp rank {r}: the sharded set restored on the 2 x 2 "
                     f"mesh differs: {back}")
        restored = _mp_restore_one(snap)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"rule": rules, "bound": DP_RULE_BOUND, "iters": MP_ITERS,
           "ring": {f"rank{r}": facts.pop("ring")
                    for r, facts in enumerate(two)},
           "reference_step_ms": {k: v["step_ms"]
                                 for k, v in ref_facts.items()},
           "card": card}
    for ranks, runs in ((two, MP_RUNS), (four, MP_PP_RUNS + MP_22_RUNS)):
        for name, *_ in runs:
            out[name] = {f"rank{r}": {k: ranks[r][name].get(k) for k in (
                "step_ms", "collective_ms_per_step", "model_bytes_per_step",
                "launches", "losses")} for r in range(len(ranks))}
            out[name]["shards"] = ranks[0][name]["shards"]
    for name, *_ in MP_22_RUNS:
        out[name]["graph_route"] = four[0][name]["graph_route"]
    out["snapshot"] = {
        "sharded_write_ms": {f"rank{r}": four[r]["alexnet_zero"]["snapshot"][
            "ORBAX_ms"] for r in range(4)},
        "gathered_write_ms": {f"rank{r}": four[r]["alexnet_zero"][
            "snapshot"]["BINARYPROTO_ms"] for r in range(4)},
        "restored_2x2": "equal on every rank",
        "restored_one_process": restored}
    # the test nets of MP_TEST_BATCH under the model axis: every rank's
    # scores against one process's, at the initial weights
    # (every pass of each; at step_chunk MP_CHUNK the second pass runs
    # eagerly, as the gloo route says: no test graph)
    out["test_batch_3"] = {"bound": MP_FIRST_LOSS}
    for name, ref in (("alexnet_zero", "alexnet_tp"),
                      ("sp_flash_k1", "sp_flash"),
                      ("sp_flash_k10", "sp_flash")):
        want = ref_facts[ref]["test_scores"][0]
        worst = 0.0
        for r in range(4):
            passes = four[r][name]["test_scores"]
            if len(passes) != MP_22_TESTS[name] \
                    or four[r][name]["test_graphs"]:
                fail(f"mp {name} rank {r}: {len(passes)} test passes, "
                     f"{four[r][name]['test_graphs']} test graphs under "
                     f"gloo")
            for got in passes:
                if set(got) != set(want):
                    fail(f"mp {name} rank {r}: test scores {got} against "
                         f"{want}")
                worst = max([worst] + [abs(got[k] - v) / max(abs(v), 1.0)
                                       for k, v in want.items()])
        if worst > MP_FIRST_LOSS:
            fail(f"mp {name}: test net of batch {MP_TEST_BATCH}: "
                 f"{four[0][name]['test_scores']} against one process's "
                 f"{want} ({worst})")
        out["test_batch_3"][name] = {
            "scores": four[0][name]["test_scores"][0], "one_process": want,
            "worst_rel_diff": worst}
    # K3-K5 of the ring at (2, 2): both attention layers, every iteration
    want22 = ring_flash_launches(2, True, FLASH_PATH["s"] // 2)
    for name in ("sp_flash_k1", "sp_flash_k10"):
        for r in range(4):
            got = out[name][f"rank{r}"]["launches"]
            n = 2 * (MP_CHUNK + 1) * want22[r % 2]
            if (got["K3"], got["K4"], got["K5"]) != (n, n, n):
                fail(f"mp {name} rank {r}: K3-K5 {got}, want {n} each")
    for name in ("alexnet_zero", "alexnet_gou"):
        for r in range(4):
            got = out[name][f"rank{r}"]["launches"]
            if (got["K1"], got["K2"]) != (2 * MP_ITERS, 2 * MP_ITERS):
                fail(f"mp {name} rank {r}: K1/K2 {got}")
    # K3-K5 of the flash ring: both attention layers, every iteration
    want = ring_flash_launches(2, True, FLASH_PATH["s"] // 2)
    for r in range(2):
        got = out["sp_flash"][f"rank{r}"]["launches"]
        n = 2 * MP_ITERS * want[r]
        if (got["K3"], got["K4"], got["K5"]) != (n, n, n):
            fail(f"mp sp_flash rank {r}: K3-K5 {got}, want {n} each")
    for r in range(2):
        got = out["sp"][f"rank{r}"]["launches"]
        if got["K3"] or got["K4"] or got["K5"]:
            fail(f"mp sp (plain ring) rank {r} launched flash: {got}")
        # AlexNet's two LRNs a forward and a backward, every iteration
        got = out["alexnet_tp"][f"rank{r}"]["launches"]
        if (got["K1"], got["K2"]) != (2 * MP_ITERS, 2 * MP_ITERS):
            fail(f"mp alexnet_tp rank {r}: K1/K2 {got}")
    return out


def _mp_cli(tmp, name, solver, extra=(), iters=MP_CARDS_ITERS,
            env=None) -> dict:
    """`cli train` of a transformer_lm solver for `iters` iterations in a
    process of its own (its workers one a card under NCCL with -mesh),
    with `env` added: rank 0's summary."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "caffe_mpi_tpu_torch.tools.cli", "train",
         "-solver", solver, "-synthetic", "-max_iter", str(iters),
         "-test_iter", str(TEST_ITER),
         "-snapshot_prefix", os.path.join(tmp, name), *extra],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONFAULTHANDLER="1", **(env or {})),
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=MP_CARDS_DEADLINE)
    except subprocess.TimeoutExpired:
        # every process of the run (its rank workers too) prints its
        # threads' stacks on SIGABRT (faulthandler), then is killed
        os.killpg(proc.pid, signal.SIGABRT)
        time.sleep(5)
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        fail(f"mp {name}: over {MP_CARDS_DEADLINE} s: {err[-6000:]}")
    lines = [l for l in out.splitlines() if l.startswith('{"train"')]
    if proc.returncode != 0 or len(lines) != 1:
        fail(f"mp {name}: exit {proc.returncode}, {len(lines)} summaries: "
             f"{err[-3000:]}")
    return json.loads(lines[0])["train"]


MP_CARDS_CHUNK_ITERS = 2 * MP_CHUNK + 1  # one iteration, two chunks


def _mp_cards_chunks(tmp) -> dict:
    """(b): solver_sp with use_flash at `-mesh data=2,model=2 -step_chunk
    MP_CHUNK` through the CLI: the graph route, replays; its losses held
    against step_chunk 1 on the same mesh by `_step_rule` at
    DP_RULE_BOUND; step ms at both."""
    solver = _flash_solver(tmp, "_sp")
    runs = {k: _mp_cli(tmp, f"sp_flash_k{k}", solver,
                       ("-mesh", "data=2,model=2", "-step_chunk", str(k)),
                       iters=MP_CARDS_CHUNK_ITERS)
            for k in (1, MP_CHUNK)}
    chunked = runs[MP_CHUNK]
    rule = _step_rule({"loss": torch.tensor(runs[1]["losses"])},
                      {"loss": torch.tensor(chunked["losses"])},
                      DP_RULE_BOUND)
    out = {"graph_route": chunked["graph_route"],
           "graph_replays": chunked["graph_replays"],
           "graph_collectives": chunked["graph_collectives"], "rule": rule,
           "step_ms": {f"k{k}": float(np.median(r["iter_ms"][1:]))
                       for k, r in runs.items()},
           "kernel_launches_rank0": {f"k{k}": r["kernel_launches"]
                                     for k, r in runs.items()},
           "losses": {f"k{k}": r["losses"] for k, r in runs.items()}}
    if chunked["graph_route"] != "graphs" or chunked["graph_replays"] <= 0 \
            or not rule["held"]:
        fail(f"mp over 4 cards, solver_sp at step_chunk {MP_CHUNK}: {out}")
    return out


def _mp_cards_graphs(tmp, ranks: list) -> dict:
    """(b): the NCCL ranks' flash solver_sp at step_chunk MP_CHUNK
    against step_chunk 1 (`_step_rule` at DP_RULE_BOUND), K3-K5 launches
    as `ring_flash_launches` predicts; the graphs rank 0 captured (the
    iteration's and the second test pass's) read from their DOT dumps by
    `_graph_nodes`: they must hold the flash kernels and NCCL's send/recv
    kernels; each test pass's scores against step_chunk 1's eager one."""
    from caffe_mpi_tpu_torch.ops.attention import ring_flash_launches
    dump = os.path.join(tmp, "graphs", "r0")
    dots = sorted(os.listdir(dump)) if os.path.isdir(dump) else []
    nodes = [n for f in dots for n in _graph_nodes(os.path.join(dump, f))]
    kinds = {"flash_fwd_kernel": 0, "flash_bwd_dq_kernel": 0,
             "flash_bwd_dkv_kernel": 0, "SendRecv": 0, "AllReduce": 0,
             "AllGather": 0}
    for label in nodes:
        for kind in kinds:
            kinds[kind] += kind in label
    k1, k10 = (torch.load(os.path.join(tmp, f"{name}.pt"))
               for name, *_ in MP_22_RUNS[:2])
    rule = _step_rule(k1, k10, DP_RULE_BOUND)
    want = ring_flash_launches(2, True, FLASH_PATH["s"] // 2)
    worst = 0.0
    for r, facts in enumerate(ranks):
        n = 2 * (MP_CHUNK + 1) * want[r % 2]
        for name, *_ in MP_22_RUNS[:2]:
            got = facts[name]["launches"]
            if (got["K3"], got["K4"], got["K5"]) != (n, n, n):
                fail(f"mp over 4 cards, {name} rank {r}: K3-K5 {got}, "
                     f"want {n} each")
        eager = facts["sp_flash_k1"]["test_scores"][0]
        for got in facts["sp_flash_k10"]["test_scores"]:
            worst = max([worst] + [abs(got[k] - v) / max(abs(v), 1.0)
                                   for k, v in eager.items()])
    k10 = ranks[0]["sp_flash_k10"]
    out = {"graph_route": k10["graph_route"],
           "graph_replays": k10["graph_replays"],
           "test_graphs": k10["test_graphs"], "graphs_dumped": len(dots),
           "graph_nodes": len(nodes), "graph_kernels": kinds, "rule": rule,
           "test_scores": k10["test_scores"],
           "test_scores_eager": ranks[0]["sp_flash_k1"]["test_scores"],
           "test_worst_rel_diff": worst,
           "launches": {f"rank{r}": f["sp_flash_k10"]["launches"]
                        for r, f in enumerate(ranks)},
           "step_ms": {name: ranks[0][name]["step_ms"]
                       for name, *_ in MP_22_RUNS[:2]}}
    if k10["graph_route"] != "graphs" or k10["graph_replays"] <= 0 \
            or k10["test_graphs"] != 1 or not rule["held"] \
            or worst > MP_FIRST_LOSS or not all(
                kinds[k] for k in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                   "flash_bwd_dkv_kernel", "SendRecv")):
        fail(f"mp over 4 cards, the graphs of solver_sp at step_chunk "
             f"{MP_CHUNK}: {out}")
    return out


def _mp_cards_ranks(tmp) -> dict:
    """(b): four NCCL ranks of this script, a card each (`mp_rank_main`):
    AlexNet rows/cols with ZeRO-1, its sharded snapshot and the gathered
    one of the same state, each write's ms, the set restored on the 2 x 2
    mesh equal to the run, then on card 0 in one process
    (`_mp_restore_one`); the flash solver_sp's graphs
    (`_mp_cards_graphs`)."""
    procs = _mp_start(4, tmp, nccl=True)
    ranks = _mp_ranks(procs, tmp)
    for r, facts in enumerate(ranks):
        back = facts["alexnet_zero"]["snapshot"]
        if back["restored_unequal"] or back["restored_iter"] != MP_ITERS:
            fail(f"mp over 4 cards, rank {r}: the sharded set restored "
                 f"differs: {back}")
    snap = ranks[0]["alexnet_zero"]["snapshot"]
    graphs = _mp_cards_graphs(tmp, ranks)
    return {"snapshot": {
                "sharded_write_ms": {f"rank{r}": f["alexnet_zero"][
                    "snapshot"]["ORBAX_ms"] for r, f in enumerate(ranks)},
                "gathered_write_ms": {f"rank{r}": f["alexnet_zero"][
                    "snapshot"]["BINARYPROTO_ms"]
                    for r, f in enumerate(ranks)},
                "launches": {f"rank{r}": f["alexnet_zero"]["launches"]
                             for r, f in enumerate(ranks)},
                "step_ms": {f"rank{r}": f["alexnet_zero"]["step_ms"]
                            for r, f in enumerate(ranks)},
                "restored_one_card": _mp_restore_one(snap)},
            "sp_flash_graphs": graphs}


def _mp_cards(card: str, built=lambda: None) -> dict | None:
    """(b): NCCL over 4 cards (skipped with fewer): through the CLI the
    solver_sp net at `-mesh data=2,model=2` and solver_pp at
    `-mesh data=1,model=4`, the first loss of each within MP_FIRST_LOSS of
    the one-card run's; once `built()` has returned (K1-K5 built), the
    flash solver_sp at step_chunk MP_CHUNK (`_mp_cards_chunks`), then
    the NCCL ranks of this script: AlexNet's sharded snapshot and the
    flash solver_sp's captured graphs (`_mp_cards_ranks`)."""
    n = min(torch.cuda.device_count(), 4)
    if n < 4:
        return None
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mpn_")
    try:
        runs = {}
        for tag, solver, mesh in (("sp", TLM_SP_SOLVER, "data=2,model=2"),
                                  ("pp", TLM_PP_SOLVER, "data=1,model=4")):
            runs[tag] = (_mp_cli(tmp, f"{tag}_one", solver, ("-gpu", "0")),
                         _mp_cli(tmp, f"{tag}_mesh", solver,
                                 ("-mesh", mesh)))
        built()
        chunks = _mp_cards_chunks(tmp)
        ranks = _mp_cards_ranks(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"cards": n, "card": card, "bound": MP_FIRST_LOSS,
           "sp_flash_chunks": chunks, **ranks}
    for tag, (one, s) in runs.items():
        ref, got = np.asarray(one["losses"]), np.asarray(s["losses"])
        rel = np.abs(got - ref) / np.abs(ref)
        red = s["reduction"] or {}
        if not (np.all(np.isfinite(got)) and red.get("backend") == "nccl"
                and rel[0] <= MP_FIRST_LOSS):
            fail(f"mp over {n} cards, {tag}: {s}, first loss {rel[0]}")
        out[tag] = {"world": s["world"], "n_model": s["n_model"],
                    "first_loss_rel_diff": float(rel[0]),
                    "losses": s["losses"], "one_card_losses": one["losses"],
                    "step_ms": float(np.median(s["iter_ms"][1:])),
                    "one_card_step_ms": float(np.median(one["iter_ms"][1:])),
                    "kernel_launches_rank0": s["kernel_launches"],
                    "reduction": red}
    return out


def mp_phase(k1: dict, k2: dict, flash: list[dict], card: str) -> dict:
    out = {"one_card_gloo": _mp_one_card(card)}
    a = out["one_card_gloo"]
    for entry, k in ((k1, "K1"), (k2, "K2")):
        for r in range(2):
            entry["launches_by_path"][f"mp_alexnet_tp_rank{r}"] = \
                a["alexnet_tp"][f"rank{r}"]["launches"][k]
        for r in range(4):
            entry["launches_by_path"][f"mp_alexnet_zero_2x2_rank{r}"] = \
                a["alexnet_zero"][f"rank{r}"]["launches"][k]
    for entry, k in zip(flash[:3], ("K3", "K4", "K5")):
        for r in range(2):
            entry["launches_by_path"][f"mp_sp_flash_rank{r}"] = \
                a["sp_flash"][f"rank{r}"]["launches"][k]
            entry["launches_by_path"][f"mp_ring_rank{r}"] = \
                a["ring"][f"rank{r}"]["f32"]["launches"][k]
        for r in range(4):
            entry["launches_by_path"][f"mp_sp_flash_k10_2x2_rank{r}"] = \
                a["sp_flash_k10"][f"rank{r}"]["launches"][k]
    out["nccl_cards"] = _mp_cards(card)
    log(f"mp: {json.dumps(out)}")
    return out


# -- 25. gpipe ----------------------------------------------------------------

GOOGLENET_SOLVER = os.path.join(ROOT, "models", "googlenet",
                                "solver.prototxt")
GPIPE_STAGES = 4          # -gpipe
GPIPE_MICRO = 4           # -gpipe_micro: micro-batches of 32 at batch 128
GPIPE_ITERS = 4           # iterations of each run
GPIPE_BOUND = 1e-2        # `_step_rule` against the iter_size run
GPIPE_FIRST_BOUND = 1e-5  # the same after one iteration, in process (read
#                           2.2e-7 on the card: float32 chaos takes it to
#                           ~9e-3 by the fourth iteration)
GPIPE_CARDS_ITERS = 6     # --only gpipe_cards: the median after the first


def _solver_copy(src, tmp, name, *, batch_div=1, iter_size=1,
                 float_math=True) -> str:
    """A copy of a zoo solver (and its net) with no test pass and no
    snapshot: its net in FLOAT math (TF32 off, forward and backward), its
    Input batch divided by `batch_div`, and `iter_size`."""
    from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
    sp = SolverParameter.from_file(src)
    param = NetParameter.from_file(os.path.join(ROOT, sp.net))
    if float_math:
        param.default_forward_math = param.default_backward_math = "FLOAT"
    for lp in param.layer:
        if lp.type == "Input" and lp.input_param:
            for shape in lp.input_param.shape:
                shape.dim[0] //= batch_div
    net = os.path.join(tmp, f"{name}_net.prototxt")
    with open(net, "w") as f:
        f.write(param.to_prototxt())
    sp.net, sp.test_iter, sp.test_interval = net, [], 0
    sp.snapshot, sp.iter_size = 0, iter_size
    path = os.path.join(tmp, f"{name}_solver.prototxt")
    with open(path, "w") as f:
        f.write(sp.to_prototxt())
    return path


def _gpipe_state(solver) -> dict:
    state = _state(solver)
    state["loss"] = torch.tensor(solver.losses)
    return state


def _plant_mixup(gp, stage: int = 1) -> None:
    """The micro-batch mix-up fault: stage `stage`'s recompute of
    micro-batch m reads the feeds and boundary inputs that the forward
    saved for micro-batch m + 1 (mod M), as a wrong m in `saved[s][m]`
    would, while its cotangents still go to micro-batch m's wires."""
    run, fwd, done = gp._run, [], [0]

    def faulty(s, feeds, env_in, mk, params):
        if s != stage:
            return run(s, feeds, env_in, mk, params)
        if not torch.is_grad_enabled():  # the forward wavefront, m = 0, 1..
            if done[0]:
                fwd.clear()
                done[0] = 0
            fwd.append((feeds, {b: v.clone() for b, v in env_in.items()}))
            return run(s, feeds, env_in, mk, params)
        m = len(fwd) - 1 - done[0]  # the backward goes m = M - 1, .. 0
        done[0] += 1
        o_feeds, o_env = fwd[(m + 1) % len(fwd)]
        # the other micro-batch's values; the gradient still reaches this
        # micro-batch's leaves
        mixed = {b: v - v.detach() + o_env[b] if v.requires_grad
                 else o_env[b] for b, v in env_in.items()}
        return run(s, o_feeds, mixed, mk, params)

    gp._run = faulty


def _gpipe_solvers(full, micro, feeds: list, fault=None) -> tuple:
    """GoogLeNet in process on distinct micro-batches, `feeds[k]` for
    micro-batch m of iteration it (k = it x M + m): under GPipe (`full`
    with -gpipe S -gpipe_micro M; `fault` "mixup" or "no_send_back"
    planted), else the iter_size M solver (`micro`). (state after the
    first iteration, state after GPIPE_ITERS)."""
    from caffe_mpi_tpu_torch.proto import SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    sp = SolverParameter.from_file(full if fault != "iter_size" else micro)
    sp.max_iter = GPIPE_ITERS  # the CLI runs' -max_iter (a poly schedule)
    solver = Solver(sp, device="cuda", gpipe=None if fault == "iter_size"
                    else {"stages": GPIPE_STAGES, "micro": GPIPE_MICRO})
    if fault == "mixup":
        _plant_mixup(solver.gpipe)
    elif fault == "no_send_back":
        # stage 1 sends no cotangent back: stage 0's params take no
        # gradient from the stages after it
        solver.gpipe._in_producer[1] = {}
    solver.step(1, lambda k: feeds[k])
    first = _gpipe_state(solver)
    solver.step(GPIPE_ITERS - 1, lambda k: feeds[k])
    last = _gpipe_state(solver)
    del solver
    torch.cuda.empty_cache()
    return first, last


def _gpipe_in_process(full, micro) -> dict:
    """GPipe against iter_size M in process on GPIPE_ITERS x M distinct
    seeded micro-batches, after one iteration (GPIPE_FIRST_BOUND) and
    after GPIPE_ITERS (GPIPE_BOUND): how far float32 chaos carries the
    gap. The two planted faults against the same reference at both."""
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
    from caffe_mpi_tpu_torch.tools import cli
    sp = SolverParameter.from_file(micro)
    net = Net(NetParameter.from_file(sp.net), phase="TRAIN", device="cuda")
    feeds = [cli.synthetic_feed(net, seed=100 + k)
             for k in range(GPIPE_ITERS * GPIPE_MICRO)]
    del net
    runs = {tag: _gpipe_solvers(full, micro, feeds, tag)
            for tag in ("iter_size", None, "mixup", "no_send_back")}
    ref, got = runs.pop("iter_size"), runs.pop(None)

    def rules(run):
        return {"first": _step_rule(ref[0], run[0], GPIPE_FIRST_BOUND),
                "end": _step_rule(ref[1], run[1], GPIPE_BOUND)}
    return {"rule": rules(got),
            "faults": {tag: rules(run) for tag, run in runs.items()},
            "losses": [float(x) for x in got[1]["loss"]],
            "iter_size_losses": [float(x) for x in ref[1]["loss"]]}


def gpipe_phase(k1: dict, k2: dict, card: str) -> dict:
    """GoogLeNet at full width (models/googlenet/solver.prototxt's net,
    batch 128, three losses) through the CLI's `train -gpipe 4
    -gpipe_micro 4` on one card (every stage on it), GPIPE_ITERS
    iterations, launch counts 0 just before and read just after: K1 and
    K2 against `gpipe.lrn_launches`; loss and every param, history slot
    and statistic against the port's `iter_size 4` run at batch 32 (FLOAT
    math, cuDNN deterministic) by `_step_rule` at GPIPE_BOUND, the CLI's
    runs on its one synthetic batch and, in process, on distinct seeded
    micro-batches with two planted faults above the bound (a micro-batch
    mix-up, a cotangent not sent back); the median step ms and each
    stage device's peak memory."""
    from caffe_mpi_tpu_torch.parallel.gpipe import lrn_launches
    from caffe_mpi_tpu_torch.tools import cli
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gpipe_")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        full = _solver_copy(GOOGLENET_SOLVER, tmp, "googlenet")
        micro = _solver_copy(GOOGLENET_SOLVER, tmp, "googlenet_micro",
                             batch_div=GPIPE_MICRO, iter_size=GPIPE_MICRO)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_kernel_counts()
        solver, summary = cli.train(cli.parse_args(
            ["train", "-solver", full, "-synthetic", "-device", "cuda",
             "-max_iter", str(GPIPE_ITERS), "-gpipe", str(GPIPE_STAGES),
             "-gpipe_micro", str(GPIPE_MICRO)]))
        torch.cuda.synchronize()
        counts = _kernel_counts()
        devices = sorted({str(d) for d in solver.gpipe.devices})
        peaks = {d: torch.cuda.max_memory_allocated(d) / 1e9
                 for d in devices}
        pred = lrn_launches(solver.gpipe, GPIPE_MICRO)
        got = _gpipe_state(solver)
        bounds = list(solver.gpipe.bounds)
        del solver
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ref_solver, ref = cli.train(cli.parse_args(
            ["train", "-solver", micro, "-synthetic", "-device", "cuda",
             "-max_iter", str(GPIPE_ITERS)]))
        torch.cuda.synchronize()
        ref_peak = torch.cuda.max_memory_allocated() / 1e9
        want = _gpipe_state(ref_solver)
        del ref_solver
        torch.cuda.empty_cache()
        inproc = _gpipe_in_process(full, micro)
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(tmp, ignore_errors=True)
    rule = _step_rule(want, got, GPIPE_BOUND)
    want_counts = (GPIPE_ITERS * pred[0], GPIPE_ITERS * pred[1], 0, 0, 0)
    if summary["batch"] != GOOGLENET_BATCH or summary["rank_batch"] != \
            GOOGLENET_BATCH // GPIPE_MICRO or summary["gpipe"]["stages"] \
            != GPIPE_STAGES or len(summary["losses"]) != GPIPE_ITERS:
        fail(f"gpipe ran {summary['gpipe']} at batch {summary['batch']} "
             f"({summary['rank_batch']} a micro-batch)")
    if not np.all(np.isfinite(summary["losses"])):
        fail(f"gpipe losses not all finite: {summary['losses']}")
    if counts != want_counts or pred != (16, 8):
        fail(f"gpipe launched K1-K5 {counts}, the predictor says "
             f"{want_counts} ({pred} an iteration)")
    if not (rule["held"] and all(r["held"] for r in
                                 inproc["rule"].values())) \
            or any(r["held"] for f in inproc["faults"].values()
                   for r in f.values()):
        fail(f"gpipe against iter_size {GPIPE_MICRO}: CLI {rule}; in "
             f"process {inproc}")
    k1["launches_by_path"]["gpipe_googlenet"] = counts[0]
    k2["launches_by_path"]["gpipe_googlenet"] = counts[1]
    out = {"solver": "models/googlenet/solver.prototxt",
           "batch": summary["batch"], "micro_batch": summary["rank_batch"],
           "stages": GPIPE_STAGES, "micro": GPIPE_MICRO, "bounds": bounds,
           "devices": summary["gpipe"]["devices"], "iters": GPIPE_ITERS,
           "losses": summary["losses"], "iter_size_losses": ref["losses"],
           "rule": rule, "in_process": inproc,
           "launches_k1_k5": list(counts), "predicted_per_iter": list(pred),
           "median_step_ms": summary["median_iter_ms"],
           "step_ms": summary["iter_ms"],
           "iter_size_median_step_ms": ref["median_iter_ms"],
           "peak_mem_GB": peaks, "iter_size_peak_mem_GB": ref_peak,
           "card": card}
    log(f"gpipe: {json.dumps(out)}")
    return out


def _gpipe_cards(card: str) -> dict | None:
    """`--only gpipe_cards`: GoogLeNet as the gpipe phase runs it, in one
    process, with every stage on card 0 and then one stage a card on 4
    cards (skipped with fewer): the first loss against the one-card
    run's within MP_FIRST_LOSS, each card's peak memory and param bytes
    (the params partitioned), the median step ms after the first."""
    from caffe_mpi_tpu_torch.proto import SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.tools import cli
    n = torch.cuda.device_count()
    if n < GPIPE_STAGES:
        return None
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gpipe_cards_")
    runs = {}
    try:
        path = _solver_copy(GOOGLENET_SOLVER, tmp, "googlenet",
                            float_math=False)
        for tag, devices in (("one_card", ["cuda:0"] * GPIPE_STAGES),
                             ("cards", [f"cuda:{i}" for i in
                                        range(GPIPE_STAGES)])):
            for d in range(n):
                torch.cuda.synchronize(d)
                torch.cuda.reset_peak_memory_stats(d)
            solver = Solver(SolverParameter.from_file(path), device="cuda:0",
                            gpipe={"stages": GPIPE_STAGES,
                                   "micro": GPIPE_MICRO, "devices": devices})
            feeds = cli.synthetic_feed(solver.net, 0)
            solver.step(GPIPE_CARDS_ITERS, lambda it: feeds)
            for d in range(n):
                torch.cuda.synchronize(d)
            param_mb = {}
            for _, _, _, p in solver._decls:
                key = str(p.device)
                param_mb[key] = param_mb.get(key, 0) + p.numel() \
                    * p.element_size() / 2**20
            runs[tag] = {
                "losses": list(solver.losses),
                "median_step_ms": float(np.median(solver.iter_ms[1:])),
                "peak_mem_GB": [torch.cuda.max_memory_allocated(d) / 1e9
                                for d in range(GPIPE_STAGES)],
                "param_MB": param_mb,
                "devices": [str(d) for d in solver.gpipe.devices]}
            del solver, feeds
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    one, cards = runs["one_card"], runs["cards"]
    rel = abs(cards["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
    if not np.all(np.isfinite(cards["losses"])) or rel > MP_FIRST_LOSS \
            or len(cards["param_MB"]) != GPIPE_STAGES:
        fail(f"gpipe over {GPIPE_STAGES} cards: {runs}, first loss {rel}")
    return {"cards": GPIPE_STAGES, "card": card, "bound": MP_FIRST_LOSS,
            "first_loss_rel_diff": rel, **runs}


# -- 26. eval -----------------------------------------------------------------

EVAL_ITERS = 30
EVAL_INTERVAL = 10
EVAL_TEST_ITER = 10
EVAL_CHUNK = 10           # step_chunk: the test chunks are graph replays


def _eval_solver():
    """AlexNet's solver as written (b256, its TEST net at b256) with a
    pass of EVAL_TEST_ITER batches every EVAL_INTERVAL iterations, in
    chunks of EVAL_CHUNK iterations."""
    from caffe_mpi_tpu_torch.proto import SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    sp = SolverParameter.from_file(SOLVER)
    sp.test_iter, sp.test_interval = [EVAL_TEST_ITER], EVAL_INTERVAL
    sp.step_chunk, sp.snapshot, sp.display = EVAL_CHUNK, 0, 0
    model_dir = "" if os.path.exists(sp.net) else os.path.dirname(SOLVER)
    return Solver(sp, model_dir=model_dir, device="cuda")


def _eval_feeds(solver):
    from caffe_mpi_tpu_torch.tools import cli
    train = cli.synthetic_feed(solver.net, 0)
    # EVAL_TEST_ITER distinct test batches, drawn once
    tests = [cli.synthetic_feed(solver.test_nets[0], 1 + k)
             for k in range(EVAL_TEST_ITER)]
    return (lambda it: train), (lambda k: tests[k])


def eval_phase(k1: dict, k2: dict, card: str) -> dict:
    """The asynchronous evaluation at AlexNet's full width: EVAL_ITERS
    iterations with a pass at 0, 10 and 20 (cuDNN deterministic). Each
    boundary's scores against a twin that trains the same steps and runs
    the synchronous `test_all` there (bitwise); the params after the
    run against a twin with no evaluation (bitwise); the planted fault,
    a pass on the live params with no copy, above 0; eval_stall_ms a
    boundary beside the synchronous pass's ms; K1 and K2 counted."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {"card": card, "iters": EVAL_ITERS, "interval": EVAL_INTERVAL,
           "test_iter": EVAL_TEST_ITER, "step_chunk": EVAL_CHUNK}
    try:
        # the asynchronous run
        solver = _eval_solver()
        train, test = _eval_feeds(solver)
        _reset_kernel_counts()
        t0 = time.perf_counter()
        solver.step(EVAL_ITERS, train, [test])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _kernel_counts()
        async_log = list(solver.eval_log)
        stall, stall_log = solver.eval_stall_ms, list(solver.eval_stall_log)
        graphs = sorted(solver._test_graphs)
        params = {k: v for k, v in _state(solver).items()}
        del solver
        # the synchronous twin: test_all at each boundary
        twin = _eval_solver()
        sync_log, sync_ms = [], []
        for it in range(0, EVAL_ITERS, EVAL_INTERVAL):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sync_log.append({"iter": it, "scores": twin.test_all([test])})
            sync_ms.append((time.perf_counter() - t0) * 1e3)
            twin.step(EVAL_INTERVAL, train)
        del twin
        # no evaluation at all
        bare = _eval_solver()
        bare.step(EVAL_ITERS, train)
        bare_params = _state(bare)
        del bare
        # the fault: the pass reads the live params
        faulty = _eval_solver()

        def live(ti, tnet):
            # the view's entries (a module's dict, a name, the tensor
            # read), each the live tensor itself
            return [(d, name, t) for m in tnet.modules()
                    for d in (m._parameters, m._buffers)
                    for name, t in d.items() if t is not None]
        faulty._eval_view = live
        faulty.step(EVAL_ITERS, train, [test])
        fault_log = list(faulty.eval_log)
        del faulty
    finally:
        torch.backends.cudnn.deterministic = det
        torch.cuda.empty_cache()
    iters = [e["iter"] for e in async_log]
    if iters != [0, 10, 20] or async_log != sync_log:
        fail(f"eval: asynchronous passes {async_log} against the "
             f"synchronous {sync_log}")
    differ = [k for k in params if not torch.equal(params[k],
                                                   bare_params[k])]
    if differ:
        fail(f"eval: evaluation changed the training params {differ[:5]}")
    dist = max(abs(a - b) for e, f in zip(sync_log, fault_log)
               for a, b in zip(e["scores"][0].values(),
                               f["scores"][0].values()))
    if not dist > 0:
        fail(f"eval: the no-copy fault scored as the copy: {fault_log}")
    forwards = EVAL_ITERS + len(iters) * EVAL_TEST_ITER
    if counts[:2] != (2 * forwards, 2 * EVAL_ITERS):
        fail(f"eval: K1/K2 {counts[:2]}, want {(2 * forwards, 2 * EVAL_ITERS)}")
    k1["launches_by_path"]["eval_alexnet"] = counts[0]
    k2["launches_by_path"]["eval_alexnet"] = counts[1]
    out.update(passes=async_log, fault_distance=dist,
               eval_stall_ms_per_boundary=stall / len(iters),
               eval_stall_ms=stall, eval_stall_log=stall_log,
               sync_pass_ms=sync_ms,
               train_wall_s=wall, test_graphs=[list(k) for k in graphs],
               launches_k1_k2=list(counts[:2]))
    log(f"eval: {json.dumps(out)}")
    return out


# -- 27. elastic --------------------------------------------------------------

ELASTIC_ITERS = 400       # the regrown generation trains on well past its
#                           rejoin boundary (iteration 120 on an H100)
ELASTIC_EVERY = 40        # the snapshot boundaries a host rejoins at
ELASTIC_DEADLINE = 3.0    # -host_deadline
ELASTIC_KILL_BEAT = 8     # host 1's worker dies at this beat (~6 s in)
ELASTIC_DARK_S = 12.0     # then its supervisor goes dark: past host 0's
#                           detection (~3 s) and membership round (~6 s)
ELASTIC_STALL_S = 0.02    # a sleep an iteration: the degraded generation
#                           still trains when host 1 revives
ELASTIC_BOUND = 1e-2      # `_step_rule` of the final weights against the
#                           uninterrupted run (FLOAT math; LeNet's ReLUs
#                           and max pools still amplify an ulp over the
#                           run, the momentum history most)
ELASTIC_DEADLINE_S = 400  # each pair of supervisors
ELASTIC_RESTORE_BOUND = 1e-2  # `_step_rule` of the regrown generation's
#                           weights and history at its first snapshot
#                           against a world-2 pair resumed from the same
#                           snapshot (0.0 with deterministic kernels)


# imported at the start of every process of the elastic runs (supervisors
# and workers): deterministic kernels, so that two runs of the same
# training agree bitwise and the only differences left are the ones the
# checks measure (one process against two, a restore)
_DETERMINISTIC_SITE = """import importlib.machinery
import importlib.util
import os
import sys

import torch

torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.use_deterministic_algorithms(True, warn_only=True)
# then the interpreter's own sitecustomize, if it has one
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize",
    [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
"""


def _elastic_env(tmp) -> dict:
    """The environment of an elastic run's processes: no CAFFE_ setting
    of this process, and `_DETERMINISTIC_SITE` as their sitecustomize."""
    site = os.path.join(tmp, "site")
    if not os.path.isdir(site):
        os.makedirs(site)
        with open(os.path.join(site, "sitecustomize.py"), "w") as f:
            f.write(_DETERMINISTIC_SITE)
    env = {k: v for k, v in os.environ.items() if not k.startswith("CAFFE_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [site] + [p for p in (os.environ.get("PYTHONPATH", ""),) if p])
    env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    return env


def _elastic_pair(tmp, tag, solver, faults: bool, extra=(),
                  iters=ELASTIC_ITERS):
    """Two supervised `cli train` "hosts" sharing card 0 over gloo (a
    loopback coordinator), each in its own session, training to `iters`,
    `extra` added to each command line: (processes, logs, snapshot
    prefix)."""
    from caffe_mpi_tpu_torch.parallel.mesh import free_port
    prefix = os.path.join(tmp, tag, "lenet")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    port = free_port()
    procs, logs = [], []
    for host in range(2):
        env = _elastic_env(tmp)
        if faults:
            spec = f"dispatch_stall:0:0:{ELASTIC_STALL_S:g}"
            if host == 1:
                spec += (f",host_loss:1:0:{ELASTIC_KILL_BEAT}"
                         f",host_perma_loss:1:0:{ELASTIC_DARK_S:g}")
                env["CAFFE_TPU_FAULTS_DIR"] = prefix + "_faults"
                os.makedirs(env["CAFFE_TPU_FAULTS_DIR"], exist_ok=True)
            env["CAFFE_TPU_FAULTS"] = spec
        logs.append(os.path.join(tmp, f"{tag}_h{host}.log"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "caffe_mpi_tpu_torch.tools.cli", "train",
             "-solver", solver, "-synthetic", "-device", "cuda",
             "-max_iter", str(iters), "-snapshot_every",
             str(ELASTIC_EVERY), "-snapshot_prefix", prefix, "-hosts", "2",
             "-host_id", str(host), "-coordinator", f"127.0.0.1:{port}",
             "-host_deadline", f"{ELASTIC_DEADLINE:g}", "-max_restarts", "3",
             "-min_hosts", "1", *extra], cwd=ROOT, env=env,
            stdout=open(logs[-1], "w"), stderr=subprocess.STDOUT,
            start_new_session=True))
    return procs, logs, prefix


def _elastic_world1(tmp, solver):
    """The same training in one process at world 1 (the degraded
    generation's arithmetic for the whole run): (processes, logs,
    prefix)."""
    prefix = os.path.join(tmp, "world1", "lenet")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    log_path = os.path.join(tmp, "world1.log")
    proc = subprocess.Popen(
        [sys.executable, "-m", "caffe_mpi_tpu_torch.tools.cli", "train",
         "-solver", solver, "-synthetic", "-device", "cuda", "-max_iter",
         str(ELASTIC_ITERS), "-snapshot_every", str(ELASTIC_EVERY),
         "-snapshot_prefix", prefix], cwd=ROOT, env=_elastic_env(tmp),
        stdout=open(log_path, "w"), stderr=subprocess.STDOUT,
        start_new_session=True)
    return [proc], [log_path], prefix


def _elastic_resumed(tmp, tag, solver, src, it, zero_history: bool):
    """A world-2 pair resumed from a copy of `src`'s snapshot at `it`
    and trained to the next snapshot: what the regrown generation does
    first, with no loss. `zero_history` plants the fault a re-admission
    could make: the momentum history dropped at the restore."""
    from caffe_mpi_tpu_torch import io
    d = os.path.join(tmp, tag + "_from")
    os.makedirs(d, exist_ok=True)
    model = os.path.join(d, f"from_iter_{it}.caffemodel")
    shutil.copy(f"{src}_iter_{it}.caffemodel", model)
    n, _, history, step = io.load_solverstate(f"{src}_iter_{it}.solverstate")
    if zero_history:
        history = [np.zeros_like(h) for h in history]
    state = os.path.join(d, f"from_iter_{it}.solverstate")
    io.save_solverstate(state, n, model, history, step)
    return _elastic_pair(tmp, tag, solver, faults=False,
                         extra=("-snapshot", state), iters=it + ELASTIC_EVERY)


def _elastic_wait(procs, t_end) -> list:
    import signal
    try:
        for p in procs:
            p.wait(timeout=max(t_end - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return [p.returncode for p in procs]


def _elastic_state(prefix, it=ELASTIC_ITERS) -> tuple[dict, dict]:
    """(weights, history) of the snapshot at `it`, as tensors."""
    from caffe_mpi_tpu_torch import io
    weights = io.load_caffemodel(f"{prefix}_iter_{it}.caffemodel")
    _, _, history, _ = io.load_solverstate(f"{prefix}_iter_{it}.solverstate")
    return ({f"{name}.{i}": torch.from_numpy(np.asarray(b, np.float32))
             for name, blobs in weights.items()
             for i, b in enumerate(blobs)},
            {f"history.{i}": torch.from_numpy(np.asarray(h, np.float32))
             for i, h in enumerate(history)})


def _elastic_case(tmp) -> dict:
    """Degraded-mode elasticity with two "hosts" on card 0 over gloo
    (models/lenet's solver, batch 64, no test pass, a snapshot every
    ELASTIC_EVERY iterations, -min_hosts 1, -host_deadline
    ELASTIC_DEADLINE): host 1's worker dies at a heartbeat boundary and
    its supervisor goes dark for ELASTIC_DARK_S (the `host_loss` and
    `host_perma_loss` fault sites). Beside it, the same pair with no
    fault (the uninterrupted world-2 run). When that ends, the noise
    floor: the same pair again, and one process at world 1. When the
    degraded run ends, two world-2 pairs resumed from the snapshot the
    regrown generation restored, to its next snapshot: as written, and
    with its history zeroed (the planted fault), started as soon as that
    snapshot is on disk, beside the regrown generation. Returns the
    facts; the checks are `elastic_phase`'s."""
    import re
    solver = _solver_copy(LENET, tmp, "lenet")
    t0 = time.perf_counter()
    base = _elastic_pair(tmp, "base", solver, faults=False)
    deg = _elastic_pair(tmp, "degrade", solver, faults=True)
    journal = _JournalLog(deg[2])
    t_end = time.monotonic() + ELASTIC_DEADLINE_S
    rcs_base = _elastic_wait(base[0], t_end)
    base2 = _elastic_pair(tmp, "base2", solver, faults=False)
    world1 = _elastic_world1(tmp, solver)
    # the resumed pairs start once host 0 names the rejoin boundary (it
    # waits for that snapshot before it exits for the grow-back) and the
    # snapshot's manifest, written last, is there
    resumed = {}
    while not resumed and time.monotonic() < t_end and any(
            p.poll() is None for p in deg[0]):
        with open(deg[1][0]) as f:
            rejoin = re.search(r"snapshot boundary iteration (\d+)",
                               f.read())
        if rejoin and os.path.exists(
                f"{deg[2]}_iter_{rejoin.group(1)}.manifest.json"):
            it = int(rejoin.group(1))
            resumed = {tag: _elastic_resumed(tmp, tag, solver, deg[2], it,
                                             zero)
                       for tag, zero in (("resumed", False),
                                         ("resumed_zero_history", True))}
        else:
            time.sleep(0.5)
    rcs = _elastic_wait(deg[0], t_end)
    seen = journal.stop()
    wall = time.perf_counter() - t0
    logs = [open(p).read() for p in base[1] + deg[1]]

    def gen(prefix, g):
        try:
            with open(os.path.join(prefix + ".cluster",
                                   f"gen_{g}.json")) as f:
                return json.load(f)
        except OSError:
            return {}
    rejoin = re.search(r"snapshot boundary iteration (\d+)", logs[2])
    t_end = time.monotonic() + ELASTIC_DEADLINE_S
    more = {"base2": base2, "world1": world1, **resumed}
    more_rcs = {tag: _elastic_wait(run[0], t_end)
                for tag, run in more.items()}
    facts_wall = time.perf_counter() - t0
    failures = deg[2] + ".failures.log"
    facts = {"rcs_base": rcs_base, "rcs": rcs, "wall_s": wall,
             "more_rcs": more_rcs, "case_wall_s": facts_wall,
             "journal": seen,
             "failure_lines": [l for l in (open(failures).read().splitlines()
                                           if os.path.exists(failures)
                                           else []) if not l.startswith(" ")],
             "base_generations": [g for g in (2, 3) if gen(base[2], g)],
             "gen2": gen(deg[2], 2), "gen3": gen(deg[2], 3),
             "host_lost_logged": "heartbeat: host 1 silent" in logs[2],
             "parked": "rejoin-wait" in logs[3],
             "rejoin_iter": int(rejoin.group(1)) if rejoin else None,
             "done": os.path.exists(os.path.join(deg[2] + ".cluster",
                                                 "done")),
             "tails": [l[-2500:] for l in logs]}
    out_dir = os.path.join(ROOT, "chiprun_out")
    if os.path.isdir(out_dir):
        for name, text in zip(("base_h0", "base_h1", "degrade_h0",
                               "degrade_h1"), logs):
            with open(os.path.join(out_dir, f"elastic_{name}.log"),
                      "w") as f:
                f.write(text[-200000:])
    if rcs_base == [0, 0] and rcs == [0, 0]:
        facts["base_state"] = _elastic_state(base[2])
        facts["state"] = _elastic_state(deg[2])
        if facts["rejoin_iter"] is not None:
            # the control: the weights the regrown generation resumed from
            facts["rejoin_state"] = _elastic_state(deg[2],
                                                   facts["rejoin_iter"])
    # the regrown generation's first snapshot (where the resumed pairs
    # end)
    first = (facts["rejoin_iter"] or 0) + ELASTIC_EVERY
    for tag, run in more.items():
        if facts["more_rcs"][tag] != [0] * len(run[0]):
            facts.setdefault("more_tails", {})[tag] = [
                open(p).read()[-2500:] for p in run[1]]
            continue
        facts[tag] = _elastic_state(run[2], first if tag.startswith(
            "resumed") else ELASTIC_ITERS)
    if "state" in facts and first <= ELASTIC_ITERS:
        facts["first_state"] = _elastic_state(deg[2], first)
    return facts


def start_elastic_case():
    """Start `_elastic_case` in a thread, as `start_lenet_cases` starts
    its runs: child processes on the card while the parent builds the
    kernels. Returns (future, its tmp dir)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    ex = ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(_elastic_case, tmp)
    ex.shutdown(wait=False)
    return fut, tmp


def elastic_phase(facts: dict, card: str) -> dict:
    """The elastic case's checks, in the order the run must show them:
    the survivor's `host_lost:1` journal and exit 87; generation 2 at
    world 1; the revived supervisor parked in rejoin-wait; re-admission
    at a snapshot boundary (generation 3 at world 2); the final weights
    against the uninterrupted run by `_step_rule` at ELASTIC_BOUND, a
    control (the weights of the snapshot the regrown generation resumed
    from: a regrown generation that trained nothing) above it; the
    regrown generation's weights and momentum history at its first
    snapshot against a world-2 pair resumed from the same snapshot by
    `_step_rule` at ELASTIC_RESTORE_BOUND, the planted fault (that
    snapshot's history zeroed) above it. Beside them the noise floor:
    the uninterrupted pair run twice, and one process at world 1
    against the pair."""
    ok = facts["rcs_base"] == [0, 0] and facts["rcs"] == [0, 0]
    lost = [j for j in facts["journal"] if j["reason"] == "host_lost:1"]
    g2, g3 = facts["gen2"], facts["gen3"]
    steps = {
        "host_lost_journal_exit_87": bool(
            lost and lost[0]["exit_code"] == 87 and facts["host_lost_logged"]
            and facts["failure_lines"]
            and "gen 1 attempt 1: fault/cluster" in facts["failure_lines"][0]),
        "generation_2_world_1": (g2.get("reason"), g2.get("hosts"),
                                 g2.get("world")) == ("cluster_degraded",
                                                      [0], 1),
        "parked_in_rejoin_wait": facts["parked"],
        "readmitted_at_snapshot_boundary": facts["rejoin_iter"] is not None
        and facts["rejoin_iter"] % ELASTIC_EVERY == 0,
        "generation_3_world_2": (g3.get("reason"), g3.get("hosts"),
                                 g3.get("world")) == ("cluster_regrown",
                                                      [0, 1], 2),
        "base_stayed_generation_1": not facts["base_generations"],
    }
    if not ok or not all(steps.values()):
        fail(f"elastic: rcs {facts['rcs_base']} / {facts['rcs']}, steps "
             f"{steps}, journal {facts['journal']}, failures "
             f"{facts['failure_lines']}, tails {facts['tails']}")
    missing = [t for t in ("base2", "world1", "resumed",
                           "resumed_zero_history") if t not in facts]
    if missing:
        fail(f"elastic: runs {missing} failed: {facts['more_rcs']}, tails "
             f"{facts.get('more_tails')}")
    (want, want_h), (got, got_h) = facts["base_state"], facts["state"]
    rule = _step_rule(want, got, ELASTIC_BOUND)
    history_rule = _step_rule(want_h, got_h, ELASTIC_BOUND)
    control_rule = _step_rule(want, facts["rejoin_state"][0],
                              ELASTIC_BOUND)

    def both(state):  # weights and history
        return {**state[0], **state[1]}

    res = both(facts["resumed"])
    restore = _step_rule(res, both(facts["first_state"]),
                         ELASTIC_RESTORE_BOUND)
    zeroed = _step_rule(res, both(facts["resumed_zero_history"]),
                        ELASTIC_RESTORE_BOUND)
    noise = {tag: {"weights": _step_rule(want, facts[tag][0],
                                         ELASTIC_BOUND),
                   "history": _step_rule(want_h, facts[tag][1],
                                         ELASTIC_BOUND)}
             for tag in ("base2", "world1")}
    if not rule["held"] or control_rule["held"] or not restore["held"] \
            or zeroed["held"]:
        fail(f"elastic: final weights against the uninterrupted run {rule}"
             f", control {control_rule}, history {history_rule}; against "
             f"the pair resumed from the rejoin snapshot {restore}, its "
             f"history zeroed {zeroed}; noise floor {noise}; steps "
             f"{steps}, rejoin at {facts['rejoin_iter']}, wall "
             f"{facts['wall_s']:.1f} s")
    out = {"card": card, "iters": ELASTIC_ITERS, "every": ELASTIC_EVERY,
           "host_deadline_s": ELASTIC_DEADLINE, "dark_s": ELASTIC_DARK_S,
           "steps": steps, "journal": facts["journal"],
           "failure_lines": facts["failure_lines"],
           "rejoin_iter": facts["rejoin_iter"], "gen2": g2, "gen3": g3,
           "rule": rule, "control_rule": control_rule,
           "history_rule": history_rule, "restore_rule": restore,
           "zeroed_history_rule": zeroed, "noise_floor": noise,
           "wall_s": facts["wall_s"], "case_wall_s": facts["case_wall_s"]}
    log(f"elastic: {json.dumps(out)}")
    return out


# -- 28. shapes: the static engine against the card ---------------------------

# the Data layers' record shapes (C, H, W) before the crop: the probe the
# CPU test of the MAC model uses (tests/test_torch_cli_tools.py), so no
# dataset or mean file is opened; any other Data net gets SHAPES_RECORD
SHAPES_RECORDS = {"examples/mnist/lenet_train_test.prototxt": (1, 28, 28),
                  "examples/imagenet/caffenet_train_val.prototxt": (3, 72, 72)}
SHAPES_RECORD = (3, 32, 32)
# the one net the port refuses to build (HDF5Data, ROADMAP.md §1 item 3)
SHAPES_REFUSED = "examples/hdf5_classification/nonlinear_train_val.prototxt"
SHAPES_LADDER = "1,4,10"
TIMER_RTOL, TIMER_ATOL_S = 0.05, 20e-6   # Timer against a bare event pair
TIMER_REPS = 5


def _zoo_nets() -> list[str]:
    """The net files of models/*/ and examples/*/ (solvers aside), relative
    to the root: those the repo holds (a test writes the net-surgery
    example's windownet*.prototxt, which git ignores)."""
    import glob
    return sorted(
        os.path.relpath(p, ROOT) for d in ("models", "examples")
        for p in glob.glob(os.path.join(ROOT, d, "*", "*.prototxt"))
        if "solver" not in os.path.basename(p)
        and not os.path.basename(p).startswith("windownet"))


def _record_probe(rel: str):
    """The Data layers' probe of net `rel`: the post-crop record shape,
    with no raw shape, so the transform stays on the host."""
    from caffe_mpi_tpu_torch.data.feeder import ProbeShape
    c, h, w = SHAPES_RECORDS.get(rel, SHAPES_RECORD)

    def probe(lp):
        crop = lp.transform_param.crop_size
        return ProbeShape((c, crop or h, crop or w), raw=None)
    return probe


def engine_facts(analysis) -> dict:
    """What the static engine says of a net: each layer's out shapes, each
    param's shape, lr_mult and decay_mult, the params' bytes
    (`layer_footprint`) and MACs, and the blob table."""
    from caffe_mpi_tpu_torch.proto import netshape
    return {
        "layers": [(l.name, [tuple(s) for s in l.out_shapes],
                    {n: (p.shape, p.lr_mult, p.decay_mult)
                     for n, p in l.params.items()},
                    4 * (netshape.layer_footprint(l)["param_count"] or 0),
                    int(netshape.layer_macs(l) or 0))
                   for l in analysis.layers],
        "blobs": {k: tuple(v) for k, v in analysis.blob_shapes.items()}}


def built_facts(net) -> dict:
    """The same facts read off a built net: its layers' out shapes and
    param declarations, the bytes its param tensors hold on its device
    (the card here; the CPU in tests/test_torch_cli_tools.py), and the
    built-layer MAC adapter's counts."""
    from caffe_mpi_tpu_torch.utils.flops import layer_macs_per_image
    layers = []
    for l in net.layers:
        tensors = [getattr(l, n) for n in l.decls]
        if any(t.device.type != net.device.type for t in tensors):
            fail(f"shapes: layer {l.name!r}'s params are not on "
                 f"{net.device}")
        layers.append((l.name, [tuple(s) for s in l.out_shapes],
                       {n: (tuple(d.shape), d.lr_mult, d.decay_mult)
                        for n, d in l.decls.items()},
                       sum(t.numel() * t.element_size() for t in tensors),
                       layer_macs_per_image(l)))
    return {"layers": layers,
            "blobs": {k: tuple(v) for k, v in net.blob_shapes.items()}}


def _shapes_nets() -> dict:
    """Check 1: every net of the zoo and the examples built on the card in
    TRAIN and TEST, held exactly against `analyze_net` of the same file.
    Builds only (no forward, no kernel), so it runs beside the build."""
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.proto import NetParameter, netshape
    t0 = time.perf_counter()
    built, refused, params = 0, [], 0
    nets = _zoo_nets()
    if SHAPES_REFUSED not in nets:
        fail(f"shapes: {SHAPES_REFUSED} is missing")
    for rel in nets:
        path, probe = os.path.join(ROOT, rel), _record_probe(rel)
        for phase in ("TRAIN", "TEST"):
            analysis = netshape.analyze_net(NetParameter.from_file(path),
                                            phase, data_probe=probe)
            if analysis.problems:
                fail(f"shapes: {rel} {phase}: the engine finds "
                     f"{analysis.problems}")
            try:
                net = Net(NetParameter.from_file(path), phase, device="cuda",
                          data_shape_probe=probe)
            except NotImplementedError as e:
                if rel != SHAPES_REFUSED:
                    raise
                refused.append(f"{rel} {phase}: {e}")
                continue
            if rel == SHAPES_REFUSED:
                fail(f"shapes: {rel} built; the port refuses HDF5Data")
            got, want = built_facts(net), engine_facts(analysis)
            if got != want:
                diff = next((f"layer {a[0]}: built {a[1:]}, engine {b[1:]}"
                             for a, b in zip(got["layers"], want["layers"])
                             if a != b), "the blob tables")
                fail(f"shapes: {rel} {phase}: {diff}")
            built += 1
            params += sum(f[3] for f in got["layers"])
            del net
    torch.cuda.synchronize()
    return {"files": len(nets), "builds": built, "refused": refused,
            "param_bytes_on_card": params,
            "wall_s": round(time.perf_counter() - t0, 1)}


def start_shapes_nets():
    """Start `_shapes_nets` in a thread: its builds need no kernel, so
    they run while the parent builds the kernels (main joins it after)."""
    ex = ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(_shapes_nets)
    ex.shutdown(wait=False)
    return fut


def _shapes_kernel_nets() -> list[tuple[str, object, str]]:
    """(name, NetParameter, phase) of the nets that run K1 and K3: AlexNet,
    CaffeNet and GoogLeNet deploy; transformer_lm train_val with
    use_flash."""
    from caffe_mpi_tpu_torch.proto import NetParameter
    with open(os.path.join(TLM_DIR, "train_val.prototxt")) as f:
        tlm = NetParameter.from_text(_with_flash(f.read()))
    return [("alexnet", NetParameter.from_file(MODEL), "TEST"),
            ("caffenet", NetParameter.from_file(CAFFENET_DEPLOY), "TEST"),
            ("googlenet", NetParameter.from_file(os.path.join(
                ROOT, "models", "googlenet", "deploy.prototxt")), "TEST"),
            ("transformer_lm", tlm, "TRAIN")]


def _shapes_kernels() -> dict:
    """Check 2: one forward of each kernel net on a synthetic batch at the
    prototxt's own batch: K1 launches the engine's count of across-channel
    LRN layers, K3 its count of Attention layers, and every blob's shape
    on the card the engine's."""
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.proto import netshape
    from caffe_mpi_tpu_torch.tools import cli
    from caffe_mpi_tpu_torch.utils import model_shapes
    out = {}
    for i, (name, param, phase) in enumerate(_shapes_kernel_nets()):
        analysis = netshape.analyze_net(copy.deepcopy(param), phase)
        want_k1 = sum(1 for l in analysis.layers if l.type == "LRN" and str(
            l.lp.lrn_param.norm_region if l.lp.lrn_param else "")
            != "WITHIN_CHANNEL")
        want_k3 = sum(1 for l in analysis.layers if l.type == "Attention")
        net = Net(copy.deepcopy(param), phase, device="cuda")
        net.init(seed=i)
        if name == "transformer_lm":  # token ids for Embed, class ids
            feeds = cli.synthetic_feed(net, seed=i)
        else:
            gen = torch.Generator(device="cuda").manual_seed(i)
            feeds = model_shapes.synthetic_feeds(
                model_shapes.input_shapes(param, train_only=False),
                generator=gen, device=net.device, npar=param)
        torch.cuda.synchronize()
        _reset_kernel_counts()
        with torch.no_grad():
            env, _ = net(feeds)
        torch.cuda.synchronize()
        counts = _kernel_counts()
        if counts != (want_k1, 0, want_k3, 0, 0):
            fail(f"shapes: {name}'s forward launched K1-K5 {counts}; the "
                 f"engine counts {want_k1} LRN and {want_k3} Attention "
                 "layers")
        shapes = {k: tuple(v.shape) for k, v in env.items()}
        if shapes != analysis.blob_shapes:
            bad = sorted(k for k in set(shapes) | set(analysis.blob_shapes)
                         if shapes.get(k) != analysis.blob_shapes.get(k))
            fail(f"shapes: {name}'s blobs {bad[:5]} on the card "
                 f"{[shapes.get(k) for k in bad[:5]]}, engine "
                 f"{[analysis.blob_shapes.get(k) for k in bad[:5]]}")
        if not all(torch.isfinite(v).all() for v in env.values()
                   if v.is_floating_point()):
            fail(f"shapes: {name}'s forward is not finite")
        out[name] = {"batch": next(iter(shapes.values()))[0],
                     "blobs": len(shapes), "k1": counts[0],
                     "k3": counts[2]}
        del net, env
    return out


def _shapes_plan() -> dict:
    """Check 3: AlexNet deploy in the port's ServingEngine on the ladder 1,
    4, 10, f32 and bf16: the static plan (before load) equals the plan the
    engine keeps, the bytes of the blobs its bucket nets hold on the card
    and the loaded model's param_bytes (AlexNet has no state)."""
    from caffe_mpi_tpu_torch.proto import NetParameter
    from caffe_mpi_tpu_torch.serving.plan import measured_plan, plan_model
    out = {}
    for dtype in ("f32", "bf16"):
        static = plan_model(NetParameter.from_file(MODEL),
                            ladder=SHAPES_LADDER, dtype=dtype)
        with _serve_engine(dtype=dtype, buckets=SHAPES_LADDER,
                           window_ms=0) as engine:
            model = engine.load_model("alexnet", MODEL, seed=0,
                                      **PREPROCESS)
            kept = dict(engine.stats()["plan"]["models"]["alexnet"])
            measured = measured_plan(model.fwd, model.param_bytes)
        kept.pop("load_ms", None)
        if kept != static:
            fail(f"shapes: the engine keeps the plan {kept}, the static "
                 f"plan is {static}")
        if measured != static:
            fail(f"shapes: {dtype}: the bucket nets hold "
                 f"{[b['activation_bytes'] for b in measured['buckets']]} "
                 f"activation bytes and {measured['param_bytes']} param "
                 "bytes on the card; the static plan says "
                 f"{[b['activation_bytes'] for b in static['buckets']]} "
                 f"and {static['param_bytes']}")
        out[dtype] = {"activation_bytes": [b["activation_bytes"]
                                           for b in static["buckets"]],
                      "param_bytes": static["param_bytes"]}
    return out


def _shapes_timer() -> dict:
    """Check 4: `utils/timers.Timer` on the card against a bare
    torch.cuda.Event pair inside it, around the same AlexNet forward."""
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.proto import NetParameter
    from caffe_mpi_tpu_torch.utils import model_shapes
    from caffe_mpi_tpu_torch.utils.timers import Timer
    param = NetParameter.from_file(MODEL)
    net = Net(param, "TEST", device="cuda")
    net.init(seed=7)
    feeds = model_shapes.synthetic_feeds(
        model_shapes.input_shapes(param, train_only=False),
        generator=torch.Generator(device="cuda").manual_seed(7),
        device=net.device)
    pairs = []
    with torch.no_grad():
        for _ in range(3):
            net(feeds)
        torch.cuda.synchronize()
        for _ in range(TIMER_REPS):
            timer = Timer(net.device)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            timer.start()
            e0.record()
            net(feeds)
            e1.record()
            got = timer.stop()
            pairs.append((got, e0.elapsed_time(e1) / 1e3))
    for got, bare in pairs:
        if abs(got - bare) > max(TIMER_RTOL * bare, TIMER_ATOL_S):
            fail(f"shapes: Timer read {got * 1e3:.4f} ms, the bare event "
                 f"pair {bare * 1e3:.4f} ms")
    return {"timer_ms": [round(g * 1e3, 4) for g, _ in pairs],
            "event_pair_ms": [round(b * 1e3, 4) for _, b in pairs]}


def shapes_phase(nets: dict, k1: dict, flash: list[dict],
                 card: str) -> dict:
    """The static engine against the card: check 1's result (`nets`, run
    beside the build), then the kernel nets, the serving plan and the
    timer."""
    t0 = time.perf_counter()
    kernels = _shapes_kernels()
    k1.setdefault("launches_by_path", {})["shapes"] = sum(
        v["k1"] for v in kernels.values())
    flash[0].setdefault("launches_by_path", {})["shapes"] = sum(
        v["k3"] for v in kernels.values())
    out = {"nets": nets, "kernels": kernels, "plan": _shapes_plan(),
           "timer": _shapes_timer(), "card": card,
           "seconds_after_build": round(time.perf_counter() - t0, 1)}
    log(f"shapes: {json.dumps(out)}")
    return out


# -- 29. fleet -----------------------------------------------------------------

FLEET_REPLICAS = 2
FLEET_VICTIM = 1          # spawned second; killed while traffic flows
FLEET_DEADLINE = 2.0      # replica heartbeat deadline (s): a beat each 0.5 s
FLEET_BASELINE_S = 10.0   # sequential requests of the two-replica
#                           baseline, for this long: a p99 over hundreds of
#                           answers, as the kill phase's (40 requests, the
#                           JAX smoke's count, make their second-largest
#                           the p99)
FLEET_P99_FLOOR_MS = 25.0  # the JAX fleet smoke's rule (tools/fleet_smoke.py)
FLEET_CARDS = 4           # --only fleet_cards: one replica a card
FLEET_SPEED_BURSTS = 10   # bursts a client in the fleet's speed runs
FLEET_SWAP_LAYER = "fc8"  # the rolling swap scales its weights by 3


def fleet_replica_main(argv) -> int:
    """A fleet replica as the fleet phase starts it: the port's CLI with
    `argv`, writing `<fleet_dir>/smoke_r<K>_<pid>.json` with its clock
    marks at start and its launch counts when it is terminated (SIGTERM,
    the supervisor's stop), so the phase reads K1's launches inside each
    replica process. When the phase writes this process's pid into
    `<fleet_dir>/kill_r<K>`, the `replica_dead` fault site is armed: the
    replica's heartbeat thread exits the process at its next beat."""
    import signal
    import threading

    from caffe_mpi_tpu_torch.utils.resilience import FAULTS

    from caffe_mpi_tpu_torch.ops import launch_counts
    from caffe_mpi_tpu_torch.tools import cli
    t_cli = time.time()
    fleet_dir = argv[argv.index("-fleet_dir") + 1]
    rid = argv[argv.index("-replica_id") + 1]
    path = os.path.join(fleet_dir, f"smoke_r{rid}_{os.getpid()}.json")
    marks = {"pid": os.getpid(), "t_process": T_PROCESS, "t_cli": t_cli}
    with open(path, "w") as f:
        json.dump(marks, f)

    def on_term(signum, frame):
        with open(path + ".tmp", "w") as f:
            json.dump({**marks, "counts": launch_counts()}, f)
        os.replace(path + ".tmp", path)
        sys.stderr.flush()
        os._exit(0)

    def kill_watch():
        order = os.path.join(fleet_dir, f"kill_r{rid}")
        while True:
            try:
                with open(order) as f:
                    if f.read().strip() == str(os.getpid()):
                        FAULTS.configure("replica_dead:1:0:0")
                        return
            except OSError:
                pass
            time.sleep(0.05)

    signal.signal(signal.SIGTERM, on_term)
    threading.Thread(target=kill_watch, daemon=True).start()
    return cli.main(argv)


def _smoke_fleet_class():
    from caffe_mpi_tpu_torch.serving.fleet import FleetSupervisor

    class SmokeFleet(FleetSupervisor):
        """The fleet supervisor with each replica started through
        `chip_smoke.py --fleet-replica` (launch counts at exit, the kill
        order), each spawn's and admission's clock kept, and the
        journal's reasons recorded in order."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.spawns: list[dict] = []
            self.journal_reasons: list[str] = []
            journal = self.router._journal

            def recorded(reason, **extra):
                self.journal_reasons.append(reason)
                journal(reason, **extra)
            self.router._journal = recorded

        def _replica_cmd(self, rid, port, weights):
            cmd = super()._replica_cmd(rid, port, weights)
            assert cmd[1:4] == ["-m", "caffe_mpi_tpu_torch.tools.cli",
                                "serve"], cmd
            return [self.python, os.path.join(ROOT, "chip_smoke.py"),
                    "--fleet-replica", *cmd[3:]]

        def _spawn(self, rid, weights):
            t = time.time()
            proc, port = super()._spawn(rid, weights)
            self.spawns.append({"rid": rid, "pid": proc.pid, "t_spawn": t})
            return proc, port

        def _await_ready(self, client, proc, rid):
            ok = super()._await_ready(client, proc, rid)
            for s in self.spawns:
                if s["pid"] == proc.pid:
                    s["ready_s"] = time.time() - s["t_spawn"]
                    s["admitted"] = ok
            return ok

    return SmokeFleet


def _fleet_marks(fleet_dir, pid):
    try:
        with open(os.path.join(fleet_dir, next(
                n for n in os.listdir(fleet_dir)
                if n.startswith("smoke_r") and n.endswith(f"_{pid}.json")))
                ) as f:
            return json.load(f)
    except (OSError, StopIteration, ValueError):
        return None


def _readyz_split(spawn, marks, stats) -> dict:
    """A replica's time from spawn to its admitted /readyz, split: the
    interpreter's start, the imports (torch, the port's CLI), the load
    (the CLI's own imports and parsing, the net builds, the weights read
    and uploaded, the front started) and the warm (each bucket's eager
    forward and capture), from its clock marks and its /stats."""
    total = spawn["ready_s"]
    warm = sum(e["ms"] for e in stats["warm"]["default"]) / 1e3
    out = {"readyz_s": total, "warm_capture_s": warm}
    if marks is not None:
        out["process_start_s"] = marks["t_process"] - spawn["t_spawn"]
        out["import_s"] = marks["t_cli"] - marks["t_process"]
        out["load_s"] = total - out["process_start_s"] - out["import_s"] \
            - warm
    return out


def _fleet_send(router, data):
    """(status, doc, wall ms) of one request through the router; a
    request the router let raise is (None, {}, ms): unresolved."""
    t0 = time.perf_counter()
    try:
        status, doc = router.classify(data, "application/octet-stream")
    except Exception as e:  # noqa: BLE001 — counted as unresolved
        log(f"fleet: a routed request raised {e!r}")
        status, doc = None, {}
    return status, doc, (time.perf_counter() - t0) * 1e3


def _fleet_p99(ms):
    return sorted(ms)[max(0, int(len(ms) * 0.99) - 1)] if ms \
        else float("nan")


def _replica_bodies(router, data) -> dict:
    """Each replica's verbatim answer to one upload, by replica id."""
    out = {}
    for h in list(router._handles):
        status, doc = h.client.classify(data, "application/octet-stream")
        out[h.rid] = (status, json.dumps(doc, sort_keys=True))
    return out


def _speed(clients, url, uploads, sizes) -> dict:
    """Closed-loop HTTP clients (a process of their own) against `url`:
    img/s, p50 and p99 of the answers' wall times. One burst from each
    client goes first, untimed: it starts the clients' process and meets
    each replica's first decodes and replays."""
    clients.submit(_http_clients, url, uploads,
                   [row[:1] for row in sizes]).result(timeout=600)
    t0 = time.perf_counter()
    got = clients.submit(_http_clients, url, uploads, sizes).result(
        timeout=600)
    wall = time.perf_counter() - t0
    bad = [c for c, _ in got if c != 200]
    ms = np.sort([m for _, m in got])
    return {"requests": len(got), "failed": len(bad),
            "img_per_s": len(got) / wall,
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def _fleet_weights(tmp) -> tuple[str, dict]:
    """AlexNet deploy's weights drawn from seed 0, as a caffemodel."""
    from caffe_mpi_tpu_torch import io as port_io
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.proto import NetParameter
    net = Net(NetParameter.from_file(MODEL), device="cpu")
    net.init(0)
    weights = net.export_weights()
    del net
    path = os.path.join(tmp, "w1.caffemodel")
    port_io.save_caffemodel(path, weights)
    return path, weights


def fleet_phase(card: str, quiet=None) -> dict:
    """`cli serve -replicas 2` on AlexNet f32 at full width, on card 0:
    two replica processes admitted through /readyz (each one warmed by
    capture: compile_count == warmed_buckets), the serve_http phase's
    uploads through the router (every answer 200 or typed, both replicas
    serving, rows within 1e-4 of the in-process engine's on the same
    weights), the router's img/s, p50 and p99 against one replica over
    HTTP, replica 1 killed at a beat boundary (`replica_dead`) while
    sequential traffic flows (none unresolved or untyped, the journal's
    replica_dead then replica_respawned, the respawn admitted through
    its readyz gate, the kill-phase p99 within the JAX fleet smoke's
    rule), a rolling swap of a second caffemodel (scores move on every
    replica, no capture) and a NaN candidate (a typed SwapError, every
    replica's answer bitwise the previous). K1 launched 2 a bucket
    forward inside each replica process; `serve -serve_program_bank`
    and `-require_bank_warm` still exit 1. Its latency and speed runs
    (from the baseline on) wait for `quiet` (an Event main sets when the
    runs beside the build have ended; flash_attention.cu's nvcc may still
    run on one core), so they time the fleet and not the build."""
    from caffe_mpi_tpu_torch import io as port_io
    from caffe_mpi_tpu_torch.proto.config import ServingParameter
    from caffe_mpi_tpu_torch.serving.errors import SwapError
    from caffe_mpi_tpu_torch.serving.fleet import make_router_server
    from caffe_mpi_tpu_torch.tools import cli
    from caffe_mpi_tpu_torch.utils import resilience

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="smoke_fleet_")
    out = {"card": card, "replicas": FLEET_REPLICAS, "model": MODEL,
           "replica_deadline_s": FLEET_DEADLINE}
    uploads = _uploads(3, 17)
    parity = _uploads(4, 10)
    w1, weights = _fleet_weights(tmp)
    fleet_dir = os.path.join(tmp, "fleet")
    sup = _smoke_fleet_class()(
        MODEL, w1, FLEET_REPLICAS, fleet_dir,
        serving_param=ServingParameter(), replica_deadline=FLEET_DEADLINE,
        device="cuda", spawn_timeout=600.0)
    clients = _client_pool()
    clients.submit(os.getpid).result(timeout=300)  # started beside the build
    srv = None
    # the in-process engine on the same weights: the rows' reference
    with _serve_engine() as engine:
        engine.load_model("alexnet", MODEL, w1)
        ref = _rows_by_bytes(engine, "alexnet", parity)
    torch.cuda.empty_cache()
    try:
        t0 = time.perf_counter()
        sup.start()
        out["admission_s"] = time.perf_counter() - t0
        router = sup.router
        stats = router.stats()["replicas"]
        admitted = {}
        for s in sup.spawns:
            doc = stats[str(s["rid"])]
            if doc.get("compile_count") != doc.get("warmed_buckets") \
                    or doc.get("recaptures") or not s.get("admitted"):
                fail(f"fleet: replica {s['rid']} admitted with "
                     f"{doc.get('compile_count')} builds for "
                     f"{doc.get('warmed_buckets')} warmed buckets")
            admitted[str(s["rid"])] = _readyz_split(
                s, _fleet_marks(fleet_dir, s["pid"]), doc)
            admitted[str(s["rid"])]["compile_count"] = doc["compile_count"]
        out["admitted"] = admitted
        srv = make_router_server(router, port=0)
        _serve_thread(srv)
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        # rows through the router's front against the in-process engine
        worst = 0.0
        for data, row in zip(parity, ref):
            code, body = cli.post_image(url + "/classify", data)
            if code != 200:
                fail(f"fleet: router answered {code} {body}")
            got = [p["score"] for p in body["predictions"]]
            for p in body["predictions"]:
                worst = max(worst, abs(p["score"] - float(row[p["label"]])))
            top = sorted(row, reverse=True)[:5]
            worst = max(worst, float(np.abs(np.array(got)
                                            - np.array(top)).max()))
        out["rows_max_abs_diff_vs_engine"] = worst
        out["rows_spread"] = float(ref.max() - ref.min())
        if worst > 1e-4:
            fail(f"fleet: router rows {worst:.3g} from the in-process "
                 "engine's (limit 1e-4)")
        # the serve_http phase's uploads through the router, its bursts
        answers = _http_clients(url, uploads, [[b] for b in SERVE_BURSTS])
        untyped = [c for c, _ in answers if c != 200]
        served = {rid: doc.get("requests", 0)
                  for rid, doc in router.stats()["replicas"].items()}
        out["traffic"] = {"requests": len(answers), "failed": len(untyped),
                          "replica_requests": served}
        if untyped or min(served.values()) == 0:
            fail(f"fleet: traffic {out['traffic']}")
        # the two-replica baseline, then the kill while traffic flows
        if quiet is not None:
            t0 = time.perf_counter()
            quiet.wait()
            out["waited_for_the_build_s"] = time.perf_counter() - t0
        probe = uploads[0]
        lat = []
        t_base = time.time()
        while time.time() < t_base + FLEET_BASELINE_S:
            status, doc, ms = _fleet_send(router,
                                          uploads[len(lat) % len(uploads)])
            if status != 200:
                fail(f"fleet: baseline answered {status} {doc}")
            lat.append(ms)
        if router.conn_errors or router.health()["replica_deaths"]:
            fail("fleet: a replica died before the kill")
        base_p99 = _fleet_p99(lat)
        # the kill order: the victim arms replica_dead for its next beat
        victim_pid = router.handle(FLEET_VICTIM).proc.pid
        with open(os.path.join(fleet_dir, f"kill_r{FLEET_VICTIM}"),
                  "w") as f:
            f.write(str(victim_pid))
        kill_lat, untyped, unresolved, n_kill, kinds = [], 0, 0, 0, {}
        t_kill = time.time()
        death_at = None
        while time.time() < t_kill + 120:
            status, doc, ms = _fleet_send(
                router, uploads[n_kill % len(uploads)])
            n_kill += 1
            if status is None:
                unresolved += 1
            elif status == 200:
                kill_lat.append(ms)
            elif not doc.get("kind"):
                untyped += 1
            else:
                kinds[doc["kind"]] = kinds.get(doc["kind"], 0) + 1
            if router.health()["replica_deaths"] >= 1:
                death_at = time.time()
                break
        while death_at is not None and time.time() < death_at + 300:
            status, doc, ms = _fleet_send(
                router, uploads[n_kill % len(uploads)])
            n_kill += 1
            if status is None:
                unresolved += 1
            elif status == 200:
                kill_lat.append(ms)
            elif not doc.get("kind"):
                untyped += 1
            else:
                kinds[doc["kind"]] = kinds.get(doc["kind"], 0) + 1
            if router.health()["respawns"] >= 1 and router.ready()[0]:
                break
        readmitted_at = time.time()
        kill_p99 = _fleet_p99(kill_lat)
        bound = max(1.5 * base_p99, base_p99 + FLEET_P99_FLOOR_MS)
        victim = [s for s in sup.spawns if s["rid"] == FLEET_VICTIM]
        out["kill"] = {
            "requests": n_kill, "answered_200": len(kill_lat),
            "typed_failures": kinds, "untyped_failures": untyped,
            "unresolved": unresolved, "baseline_requests": len(lat),
            "baseline_p99_ms": base_p99,
            "p99_ms": kill_p99, "p99_bound_ms": bound,
            "victim_pid": victim_pid,
            "death_detected": death_at is not None,
            "death_to_readmitted_s": (readmitted_at - death_at)
            if death_at is not None else None,
            "readmitted": bool(router.ready()[0]),
            "retries": router.retries, "conn_errors": router.conn_errors,
            "journal_reasons": list(sup.journal_reasons)}
        jdoc = resilience.read_run_manifest(
            os.path.join(fleet_dir, "fleet") + ".serve") or {}
        out["kill"]["journal_last"] = {
            k: jdoc.get(k) for k in ("reason", "replica_deaths",
                                     "respawns", "replica")}
        reasons = sup.journal_reasons
        if death_at is None or untyped or unresolved \
                or not out["kill"]["readmitted"] \
                or "replica_dead" not in reasons \
                or "replica_respawned" not in reasons \
                or reasons.index("replica_dead") \
                > reasons.index("replica_respawned") \
                or (jdoc.get("respawns") or 0) < 1 \
                or kill_p99 > bound:
            fail(f"fleet: the kill phase {out['kill']}")
        respawn = victim[-1]
        vdoc = router.stats()["replicas"][str(FLEET_VICTIM)]
        if len(victim) != 2 or not respawn.get("admitted") \
                or vdoc.get("compile_count") != vdoc.get("warmed_buckets") \
                or vdoc.get("recaptures"):
            fail(f"fleet: respawn {victim} with stats {vdoc}")
        out["respawn"] = _readyz_split(
            respawn, _fleet_marks(fleet_dir, respawn["pid"]), vdoc)
        # speed, both replicas up again: the router against replica 0
        # over HTTP directly
        rng = np.random.RandomState(5)
        sizes = rng.choice([1, 3, 10, 17],
                           size=(HTTP_CLIENTS, FLEET_SPEED_BURSTS)).tolist()
        direct = f"http://127.0.0.1:{router.handle(0).port}"
        out["speed"] = {"router": _speed(clients, url, uploads, sizes),
                        "one_replica": _speed(clients, direct, uploads,
                                              sizes)}
        out["speed"]["router_over_one"] = \
            out["speed"]["router"]["img_per_s"] \
            / out["speed"]["one_replica"]["img_per_s"]
        if out["speed"]["router"]["failed"] \
                or out["speed"]["one_replica"]["failed"]:
            fail(f"fleet: speed runs failed: {out['speed']}")
        # the rolling swap: fc8's weights x 3 land everywhere, no build
        before = _replica_bodies(router, probe)
        builds = {rid: (d["compile_count"], d["recaptures"])
                  for rid, d in router.stats()["replicas"].items()}
        w2 = os.path.join(tmp, "w2.caffemodel")
        layer = FLEET_SWAP_LAYER
        port_io.save_caffemodel(w2, {**weights, layer: [
            weights[layer][0] * 3.0, weights[layer][1]]})
        t0 = time.perf_counter()
        router.swap_weights("default", w2, source="smoke_v2")
        swap_s = time.perf_counter() - t0
        after = _replica_bodies(router, probe)
        rdocs = router.stats()["replicas"]
        out["swap"] = {
            "seconds": swap_s,
            "swaps": {rid: d["swaps"] for rid, d in rdocs.items()},
            "scores_changed_everywhere": all(
                after[r][0] == 200 and after[r][1] != before[r][1]
                for r in before),
            "no_capture": all((d["compile_count"], d["recaptures"])
                              == builds[rid] for rid, d in rdocs.items())}
        if not out["swap"]["scores_changed_everywhere"] \
                or not out["swap"]["no_capture"] \
                or any(n != 1 for n in out["swap"]["swaps"].values()):
            fail(f"fleet: rolling swap {out['swap']}")
        # a NaN candidate: typed, every replica bitwise the previous
        w_bad = os.path.join(tmp, "w_bad.caffemodel")
        port_io.save_caffemodel(w_bad, {**weights, layer: [
            np.full_like(weights[layer][0], np.nan), weights[layer][1]]})
        typed = False
        try:
            router.swap_weights("default", w_bad, source="smoke_bad")
        except SwapError:
            typed = True
        kept = _replica_bodies(router, probe)
        out["reject"] = {"swap_error_typed": typed,
                         "rows_bitwise_kept_everywhere": kept == after,
                         "swap_rejections": router.swap_rejections}
        if not typed or kept != after:
            fail(f"fleet: NaN candidate {out['reject']}")
        final = router.stats()["replicas"]
        out["fleet_stats"] = router.stats()["fleet"]
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        sup.stop()
    # K1 inside each replica process: 2 a bucket forward (each warm's
    # eager forward and each graph replay, the canary's included)
    k1 = {}
    for s in sup.spawns:
        marks = _fleet_marks(fleet_dir, s["pid"])
        if marks is None or "counts" not in marks:
            continue  # the killed incarnation wrote no counts
        doc = final[str(s["rid"])]
        forwards = doc["warmed_buckets"] + doc["graph_replays"]
        k1[str(s["rid"])] = {"k1": marks["counts"]["K1"],
                             "bucket_forwards": forwards,
                             "graph_replays": doc["graph_replays"],
                             "others": sum(v for k, v in
                                           marks["counts"].items()
                                           if k != "K1")}
        if marks["counts"]["K1"] != 2 * forwards or doc["graph_replays"] \
                == 0 or k1[str(s["rid"])]["others"]:
            fail(f"fleet: replica {s['rid']} launched {marks['counts']} "
                 f"for {forwards} bucket forwards (want K1 2 a forward)")
    if set(k1) != {str(r) for r in range(FLEET_REPLICAS)}:
        fail(f"fleet: launch counts from replicas {sorted(k1)} only")
    out["k1_by_replica"] = k1
    out["k1_main_path"] = sum(2 * v["graph_replays"] for v in k1.values())
    # the program bank is still refused, naming its item
    refused = {}
    for flags in (["-serve_program_bank", os.path.join(tmp, "bank")],
                  ["-require_bank_warm"]):
        try:
            rc = cli.main(["serve", "-model", MODEL, "-smoke", "1",
                           "-device", "cuda", *flags])
        except SystemExit as e:
            rc = e.code
        refused[flags[0]] = rc
    try:
        from caffe_mpi_tpu_torch.serving import ServingEngine
        ServingEngine(ServingParameter(serve_program_bank="b"),
                      device="cuda")
        fail("fleet: serve_program_bank was not refused")
    except NotImplementedError as e:
        refused["message"] = str(e)
    out["bank_refused"] = refused
    if any(refused[f] != 1 for f in ("-serve_program_bank",
                                     "-require_bank_warm")) \
            or "ROADMAP.md §1 item 5" not in refused["message"]:
        fail(f"fleet: the program bank was not refused: {refused}")
    shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"fleet: {json.dumps(out)}")
    return out


def _serve_thread(srv) -> None:
    import threading
    threading.Thread(target=srv.serve_forever, daemon=True).start()


def start_fleet_phase(card: str, quiet=None):
    """Build lrn.cu (K1) and the native library, then run `fleet_phase`,
    in a thread: the replicas start while flash_attention.cu's nvcc runs,
    and the timed runs wait for `quiet` (main joins it after the build)."""
    from caffe_mpi_tpu_torch.ops import build

    def run():
        for src in ("lrn.cu", build.NATIVE):
            build.build(src)
        return fleet_phase(card, quiet)

    ex = ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(run)
    ex.shutdown(wait=False)
    return fut


def _fleet_cards(card: str) -> dict | None:
    """`--only fleet_cards`: four replicas, one a card through
    `replica_env` (CUDA_VISIBLE_DEVICES), the serve_http uploads through
    the router against one replica over HTTP directly; K1 2 a bucket
    forward inside each replica."""
    from caffe_mpi_tpu_torch.proto.config import ServingParameter
    from caffe_mpi_tpu_torch.serving.fleet import make_router_server
    if torch.cuda.device_count() < FLEET_CARDS:
        return None
    from caffe_mpi_tpu_torch.ops import build
    for src in ("lrn.cu", build.NATIVE):
        build.build(src)
    tmp = tempfile.mkdtemp(prefix="smoke_fleet_cards_")
    w1, _ = _fleet_weights(tmp)
    fleet_dir = os.path.join(tmp, "fleet")
    sup = _smoke_fleet_class()(
        MODEL, w1, FLEET_CARDS, fleet_dir,
        serving_param=ServingParameter(), replica_deadline=FLEET_DEADLINE,
        device="cuda", spawn_timeout=600.0,
        replica_env={i: {"CUDA_VISIBLE_DEVICES": str(i)}
                     for i in range(FLEET_CARDS)})
    clients = _client_pool()
    uploads = _uploads(3, 17)
    out = {"card": card, "replicas": FLEET_CARDS}
    srv = None
    try:
        t0 = time.perf_counter()
        sup.start()
        out["admission_s"] = time.perf_counter() - t0
        srv = make_router_server(sup.router, port=0)
        _serve_thread(srv)
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        rng = np.random.RandomState(5)
        out["speed"] = {}
        for clients_n in (HTTP_CLIENTS, 4 * HTTP_CLIENTS):
            sizes = rng.choice([1, 3, 10, 17],
                               size=(clients_n, SPEED_BURSTS)).tolist()
            direct = f"http://127.0.0.1:{sup.router.handle(0).port}"
            row = {"router": _speed(clients, url, uploads, sizes),
                   "one_replica": _speed(clients, direct, uploads, sizes)}
            row["router_over_one"] = row["router"]["img_per_s"] \
                / row["one_replica"]["img_per_s"]
            out["speed"][f"clients_{clients_n}"] = row
        final = sup.router.stats()["replicas"]
        out["replica_requests"] = {r: d["requests"]
                                   for r, d in final.items()}
        out["replica_devices"] = {r: d["device"] for r, d in final.items()}
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        sup.stop()
    k1 = {}
    for s in sup.spawns:
        marks = _fleet_marks(fleet_dir, s["pid"])
        doc = final[str(s["rid"])]
        forwards = doc["warmed_buckets"] + doc["graph_replays"]
        k1[str(s["rid"])] = {"k1": (marks or {}).get("counts", {}).get(
            "K1"), "bucket_forwards": forwards}
        if k1[str(s["rid"])]["k1"] != 2 * forwards:
            fail(f"fleet_cards: replica {s['rid']} {k1[str(s['rid'])]}")
    out["k1_by_replica"] = k1
    out["readyz"] = {str(s["rid"]): _readyz_split(
        s, _fleet_marks(fleet_dir, s["pid"]), final[str(s["rid"])])
        for s in sup.spawns}
    shutil.rmtree(tmp, ignore_errors=True)
    return out


class _PhaseClock:
    """Wall seconds of each group of phases, for the time limit."""

    def __init__(self):
        self.seconds, self._t0 = {}, time.perf_counter()

    def __call__(self, name):
        now = time.perf_counter()
        self.seconds[name] = round(now - self._t0, 1)
        self._t0 = now


def main(argv=None) -> int:
    import argparse
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--fleet-replica"]:  # the fleet phase's replicas
        return fleet_replica_main(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="a checkout of the parent commit: its K1-K5 are "
                    "built and timed beside this tree's in each case")
    ap.add_argument("--dp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)  # the dp phase's gloo ranks
    ap.add_argument("--dp-port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--dp-dir", default="", help=argparse.SUPPRESS)
    for part in ("mp", "bn"):   # the mp phase's and the BatchNorm ranks
        ap.add_argument(f"--{part}-rank", type=int, default=None,
                        help=argparse.SUPPRESS)
        ap.add_argument(f"--{part}-world", type=int, default=0,
                        help=argparse.SUPPRESS)
        ap.add_argument(f"--{part}-port", type=int, default=0,
                        help=argparse.SUPPRESS)
        ap.add_argument(f"--{part}-dir", default="", help=argparse.SUPPRESS)
    ap.add_argument("--mp-nccl", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--only", choices=["dp_cards", "mp", "mp_cards",
                                       "gpipe", "gpipe_cards", "eval",
                                       "elastic", "shapes", "fleet",
                                       "fleet_cards"],
                    default=None,
                    help="run one part alone (prints no ok line): "
                    "dp_cards = the dp phase's NCCL runs (AlexNet, "
                    "ResNet-50, BatchNorm in replayed graphs) over "
                    "min(cards, 4) cards against one card (needs more than "
                    "one card); mp = the mp phase's part (a), gloo ranks "
                    "sharing card 0; mp_cards = its part (b), NCCL over 4 "
                    "cards (needs 4); gpipe, eval, elastic = those phases; "
                    "gpipe_cards = GoogLeNet's GPipe with one stage a card "
                    "over 4 cards against all stages on card 0 (needs 4); "
                    "shapes = the static engine against the card; "
                    "fleet = the serving fleet on card 0; fleet_cards = "
                    "four replicas, one a card (needs 4)")
    args = ap.parse_args(argv)
    if args.dp_rank is not None or args.mp_rank is not None \
            or args.bn_rank is not None:
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is False: no card")
        if args.mp_rank is not None:
            return mp_rank_main(args.mp_rank, args.mp_world, args.mp_port,
                                args.mp_dir, args.mp_nccl)
        if args.bn_rank is not None:
            return bn_rank_main(args.bn_rank, args.bn_world, args.bn_port,
                                args.bn_dir)
        return dp_rank_main(args.dp_rank, args.dp_port, args.dp_dir)
    if args.only is not None:
        os.chdir(ROOT)
        card, _ = device_phase()
        from caffe_mpi_tpu_torch.ops import build
        if args.only == "dp_cards":
            for src in ("lrn.cu", build.NATIVE):
                build.build(src)
            res = _dp_cards(card)
        elif args.only == "mp":
            with ThreadPoolExecutor(2) as ex:
                list(ex.map(build.build, ("lrn.cu", "flash_attention.cu")))
            res = _mp_one_card(card)
        elif args.only in ("gpipe", "gpipe_cards", "eval"):
            build.build("lrn.cu")
            entries = ({"launches_by_path": {}}, {"launches_by_path": {}})
            res = gpipe_phase(*entries, card) if args.only == "gpipe" \
                else eval_phase(*entries, card) if args.only == "eval" \
                else _gpipe_cards(card)
        elif args.only == "shapes":
            t0 = time.perf_counter()
            nets_run = start_shapes_nets()
            with ThreadPoolExecutor(2) as ex:
                list(ex.map(build.build, ("lrn.cu", "flash_attention.cu")))
            res = shapes_phase(nets_run.result(), {}, [{}], card)
            res["seconds"] = round(time.perf_counter() - t0, 1)
        elif args.only == "fleet":
            res = start_fleet_phase(card).result()
        elif args.only == "fleet_cards":
            res = _fleet_cards(card)
        elif args.only == "elastic":  # LeNet launches no kernel of the repo
            fut, tmp = start_elastic_case()
            try:
                res = elastic_phase(fut.result(), card)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        else:  # mp_cards: the flash solver_sp and AlexNet run K1-K5,
            # built while the runs before them (none of K1-K5) go
            with ThreadPoolExecutor(2) as ex:
                built = [ex.submit(build.build, f)
                         for f in ("lrn.cu", "flash_attention.cu")]
                res = _mp_cards(card, lambda: [f.result() for f in built])
        if res is None:
            fail(f"--only {args.only} needs more cards than "
                 f"{torch.cuda.device_count()}")
        for pool in _CLIENTS:
            pool.shutdown()
        print(json.dumps({args.only: res}), flush=True)
        print(card, flush=True)
        return 0
    parent = os.path.abspath(args.parent) if args.parent else None
    os.chdir(ROOT)
    clock = _PhaseClock()
    card, rates = device_phase()
    lenet_run, lenet_tmp = start_lenet_cases()
    elastic_run, elastic_tmp = start_elastic_case()
    shapes_run = start_shapes_nets()
    import threading
    quiet = threading.Event()
    fleet_run = start_fleet_phase(card, quiet)
    with ThreadPoolExecutor(max_workers=1) as ex:
        build_run = ex.submit(build_phase)
        try:
            lenet = lenet_run.result()
            elastic_facts = elastic_run.result()
            shapes_nets = shapes_run.result()
        finally:
            shutil.rmtree(lenet_tmp, ignore_errors=True)
            shutil.rmtree(elastic_tmp, ignore_errors=True)
        # the runs beside the build are over (one nvcc may still run): the
        # fleet's timed runs start
        quiet.set()
        build_run.result()
    clock("build")
    fleet = fleet_run.result()
    clock("fleet")  # the fleet phase's wall past the build
    # the elastic runs, the shapes phase's builds and the fleet phase
    # overlap the build; their own wall seconds
    clock.seconds["elastic_during_build"] = round(elastic_facts["wall_s"], 1)
    clock.seconds["shapes_during_build"] = shapes_nets["wall_s"]
    clock.seconds["fleet_during_build"] = round(fleet["seconds"], 1)
    elastic = elastic_phase(elastic_facts, card)
    parent_flash, parent_lrn = parent_libs(parent) if parent else (None,
                                                                   None)
    k1 = kernel_phase(rates, parent_lrn)
    k2 = kernel_bwd_phase(rates, parent_lrn)
    flash = flash_kernel_phase(rates, parent_flash)
    clock("kernels")
    serving = serve_phase(k1, card)
    k1["launches_by_path"]["fleet"] = fleet["k1_main_path"]
    serving["http"] = serve_http_phase(k1, k2, card)
    serving["residency"] = residency_phase(k1, k2, card)
    serving["resilience"] = resilience_phase(k1, k2, card)
    clock("serve")
    train = train_phase(k1, k2, card)
    train["parity"] = parity_phase()
    clock("train")
    transformer = transformer_phase(flash, card)
    transformer["induction"] = induction_phase()
    transformer["parity"] = transformer_parity_phase()
    clock("transformer")
    resnet50 = resnet50_phase(card)
    googlenet = googlenet_phase(k1, k2, card)
    resnet50["parity"] = resnet50_parity_phase()
    clock("resnet50_googlenet")
    lmdb = lmdb_phase(k1, k2, card)
    clock("lmdb")
    bf16 = bf16_phase(k1, k2, flash, {
        "train": train, "transformer": transformer, "resnet50": resnet50,
        "googlenet": googlenet}, card)
    clock("bf16")
    chunk = chunk_phase(k1, k2, flash, card)
    chunk["overflow"] = overflow_phase()
    clock("chunk")
    sources = {"leveldb": leveldb_phase(k1, k2, card),
               "imagedata": imagedata_phase(k1, k2, card),
               "rcnn": rcnn_phase(k1, k2, card),
               "detectnet": detectnet_phase(card),
               "siamese": siamese_phase(card),
               "zoo_layers": zoo_layers_phase()}
    clock("sources")
    pycaffe = pycaffe_phase(k1, k2, card)
    clock("pycaffe")
    survive = survive_phase(k1, k2, card, lenet)
    clock("survive")
    dp = dp_phase(k1, k2, card)
    clock("dp")
    mp = mp_phase(k1, k2, flash, card)
    clock("mp")
    gpipe = gpipe_phase(k1, k2, card)
    clock("gpipe")
    evaluation = eval_phase(k1, k2, card)
    clock("eval")
    shapes = shapes_phase(shapes_nets, k1, flash, card)
    clock("shapes")
    print(json.dumps({"kernels": [k1, k2, *flash]}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"transformer": transformer}), flush=True)
    print(json.dumps({"resnet50": resnet50}), flush=True)
    print(json.dumps({"googlenet": googlenet}), flush=True)
    print(json.dumps({"lmdb": lmdb}), flush=True)
    print(json.dumps({"bf16": bf16}), flush=True)
    print(json.dumps({"chunk": chunk}), flush=True)
    for key, res in sources.items():
        print(json.dumps({key: res}), flush=True)
    print(json.dumps({"pycaffe": pycaffe}), flush=True)
    print(json.dumps({"survive": survive}), flush=True)
    print(json.dumps({"dp": dp}), flush=True)
    print(json.dumps({"mp": mp}), flush=True)
    print(json.dumps({"gpipe": gpipe}), flush=True)
    print(json.dumps({"eval": evaluation}), flush=True)
    print(json.dumps({"elastic": elastic}), flush=True)
    print(json.dumps({"shapes": shapes}), flush=True)
    print(json.dumps({"fleet": fleet}), flush=True)
    for pool in _CLIENTS:
        pool.shutdown()
    print(json.dumps({"phase_seconds": clock.seconds}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
