"""caffe CLI for the port — train, test, time, device_query, serve.

Reference: tools/caffe.cpp; JAX package caffe_mpi_tpu/tools/cli.py
(`cmd_train`, `_build_feeders`, `_synthetic_feed`, `cmd_test`, `cmd_time`,
`cmd_device_query`, `cmd_serve`).

`train` runs a solver prototxt. A net with a Data layer is fed from its
dataset: a Feeder for the train net and one for each test net
(data/feeder.py), each behind a DeviceFeed that uploads its batches
through pinned memory. A net fed through Input layers trains on
`-synthetic` data drawn as the JAX CLI draws it: a numpy RandomState(seed)
in the net's feed order, token ids in [0, input_dim) for a blob an Embed
consumes, class ids in [0, 10) for the label bottom of a classification
loss or accuracy (or a Data layer's label), random bytes for a raw uint8
feed and zero decisions (the top-left crop, no mirror) for its
augmentation, normals for the other blobs; seed 0 for the train net, 1
for the test nets. Each synthetic feed is uploaded once and reused every
iteration. At the end `train` prints one JSON line {"train": {...}}: the
loss and wall time of every iteration, their median, images (batch items)
per second at the median step and over the whole window (the summed
steps, the first left out), whether the batches came from a dataset and
went through the device transform, and the host ms to build one batch.

`test` runs the TEST-phase net of `-model` from `-weights` over
`-iterations` batches of its Data layer (or of synthetic feeds seeded by
the iteration) and prints each terminal blob's mean over the batches,
averaged in float64, as `name = %.5g`, as the JAX `cmd_test` does.

`time` times each layer's forward and its isolated backward (the
gradients of the sum of its squared float tops with respect to its params
and float bottoms, the graph kept and the backward alone repeated), then
the whole forward and the whole forward+backward, over `-iterations` runs
each after one warm run, with CUDA events on the card. It prints the
table, the model GFLOPs (utils/flops.py), the TFLOP/s reached and the MFU
against the card's dense peak for the precision the products run at
(naming the card and the rate), the peak memory the card's allocator saw,
and one JSON line {"time": {...}}; `-profile DIR` writes a torch.profiler
trace of the two whole-net passes there.

`device_query` prints each card's properties (tools/device_query.py); it
raises without a card.

`serve` loads a deploy net into a ServingEngine (every padded batch
bucket built: a CUDA graph each on the card) and serves it over HTTP on
`-port` (serving/http_front.py: POST /classify, GET /classify_path under
`-image_root`, /stats, /healthz, /readyz) until interrupted, then drains.
`-smoke N` instead mounts the server on an ephemeral port, sends N seeded
PNG and JPEG uploads over real HTTP from 4 client threads in mixed bursts,
prints the telemetry as one JSON line {"serve_smoke": {...}} and exits 1
unless every request answered 200 and no bucket was built after warm-up
(`compile_count == warmed_buckets + recaptures`).

`train` takes the JAX CLI's mixed-precision, guard and chunk flags:
`-precision f32|bf16`, `-loss_scale` (0 dynamic, > 0 static; -1 keeps
the prototxt's), `-loss_scale_window`, `-train_guard`,
`-guard_max_skips` (-1 keeps the prototxt's) and `-step_chunk` (0 keeps
the prototxt's); a numeric divergence the guard declares exits 88
(EXIT_NUMERIC). Its summary adds the precision, the chunk length, the
guard's skips, overflows and loss scale, and the chunks run (one
dispatch and one host sync each).

Survivable training (the JAX CLI's flags): `-resume auto` resumes from the
newest verified snapshot under the snapshot prefix (a corrupt one falls
back to an older one; none is a fresh start; a path behaves like
`-snapshot`, which itself falls back to `-resume auto` when its manifest
fails); `-snapshot_every N`, `-snapshot_keep N`, `-watchdog_deadline S`
(a device wait longer than S seconds journals `watchdog:<label>` and
exits 86), `-test_chunk T`, `-lr_scale F` (base_lr x F), and signals
that only set a flag acted on at the next chunk boundary:
`-sigint_effect` (default stop: stop and snapshot, reference
solver.cpp:402-407) and `-sighup_effect` (default snapshot).
`-max_restarts N` makes this process a supervisor
(resilience.supervise): the run goes to a child process (the same argv
without `-max_restarts`, the caller's `-device` with it), restarted with
`-resume auto` and exponential backoff up to N times; its exit 88 goes
through `-anomaly_action` (rewind, rewind_lr: also `-lr_scale
anomaly_lr_mult^k`, abort: no restart). Each failed attempt is a line of
`<prefix>.failures.log`. The supervisor itself touches no card. Exit
codes: 86 a watchdog trip, 87 an injected fault, 88 a numeric
divergence. The summary adds `resumed_from`, `snapshots` (the state
paths written), `snapshot_log` (each snapshot's stall and write ms) and
`kernel_launches` (K1-K5), so a parent reads its children.

`serve -watch PREFIX` hot-swaps each newly verified snapshot of a
training run into the served model (serving/watch.py: verify, canary,
no capture); with `-smoke` the watcher polls once before the traffic.

Data parallelism (the JAX CLI's flags, over the port's
caffe_mpi_tpu_torch/parallel/): `-gpu all|i,j` runs one rank a card of
this host (NCCL), `-mesh data=N[,model=M]` N x M ranks in all (on the
cards, one rank a card, and more ranks than cards raise; with `-device
cpu`, N x M processes over gloo; rank r has data index r // M and model
index r % M: the model ranks of a data index read the same batch slice,
and the net's `param_sharding`, `sequence_parallel` attention and
Pipeline layers run over them), `-hosts H -host_id k
-coordinator host:port` spans H processes or hosts (rank = host_id x
local ranks + local rank; host 0's rank 0 serves the store), and
`-reduce_overlap`, `-reduce_buckets`, `-grad_bucket_mb` and
`-zero_stage` set the solver's fields, with the JAX precedence over the
prototxt. More than one rank on this host runs one worker process a
rank (this argv and CAFFE_TPU_LOCAL_RANK, contained by utils/subproc.py;
when one dies the others are killed). Rank 0 prints the summary, which
adds `rank`, `world` (the data ranks), `n_model`, `rank_batch`,
`reduction` (Solver.reduction_stats) and `graphs`. A
cluster that does not form (or agree on `-resume auto`) journals
`cluster_init_failed` (`cluster_resume_failed`) to the rank's run
journal and exits 87; `-max_restarts` relaunches the whole command.

`-gpipe S [-gpipe_micro M]` trains through GPipe (the JAX CLI's flags,
tools/cli.py:44, :49, :713-726): the net cut into S stages, stage s on
cuda:s when S cards are visible and every stage on the one card
otherwise, the batch into M micro-batches (default S); it is exclusive
of -gpu/-mesh, and the summary adds `gpipe` (stages, micro, bounds,
devices). The in-training test passes are asynchronous (the solver's
`_start_eval`); the summary adds `eval_stall_ms` and `eval_log` (each
pass's iteration and scores).

Multi-host elasticity (the JAX CLI's flags): `-host_deadline S` arms
the cross-host heartbeat (a silent peer journals `host_lost:<peer>` and
exits 87); with `-min_hosts W` and `-max_restarts` on a multi-host
launch the supervisor is the elastic one (resilience.supervise_elastic):
after a host is lost for good the survivors publish a generation of at
least W hosts in `<prefix>.cluster/` and go on from the newest verified
snapshot at the smaller world, a revived host parks in rejoin-wait and
is re-admitted at a snapshot boundary; each generation's child argv is
rewritten to its `-hosts`, `-host_id` and `-coordinator`. Host processes
behind a loopback coordinator share this machine's cards (two on one
card run over gloo). A collective that fails because a peer died exits
87 once the heartbeat names the peer.

`serve -replicas N` runs the serving fleet (serving/fleet.py, the JAX
CLI's flags and wiring): this process becomes the typed-retry router and
the supervisor of N replica processes, each a `cli serve -replica_id K
-fleet_dir D` of its own (heartbeats under D, the admin `POST /swap`
route, a journal `<model>.rK.serve.run.json`); `-serve_retry_budget`
and `-replica_deadline` set the router's retry budget and the heartbeat
deadline, `-watch` tails snapshots router-side (rolling canary swaps),
and `-smoke M` sends M uploads through the router and checks the fleet.
The router process creates no CUDA context.

The JAX CLI's flags for serving fields the port does not honour yet
(`-serve_program_bank`: one flag a field of the engine's
UNPORTED_FIELDS) are accepted and land on their parameter, which the
engine refuses at any value but its default; the command then exits 1.
The JAX CLI's flags of modules the port has not ported
(`-require_bank_warm`: ROADMAP.md §1 item 5) are parsed and exit 1
naming their item. `-decoded_cache_mb` sets
the solver's `decoded_cache_mb`, over the prototxt's.

Usage (gflags-compatible single-dash long flags accepted):
    python -m caffe_mpi_tpu_torch.tools.cli train -solver solver.prototxt [-synthetic] [-max_iter N] [-test_iter T] [-snapshot_prefix P] [-weights w.caffemodel | -snapshot s.solverstate | -resume auto|PATH] [-snapshot_every N] [-snapshot_keep N] [-max_restarts N] [-anomaly_action rewind|rewind_lr|abort] [-watchdog_deadline S] [-test_chunk T] [-precision bf16] [-loss_scale S] [-step_chunk K] [-train_guard] [-gpu all|i,j | -mesh data=N[,model=M]] [-decoded_cache_mb M] [-hosts H -host_id k -coordinator host:port [-host_deadline S] [-min_hosts W]] [-gpipe S [-gpipe_micro M]] [-reduce_overlap] [-reduce_buckets B | -grad_bucket_mb M] [-zero_stage 1] [-device cuda|cpu]
    python -m caffe_mpi_tpu_torch.tools.cli test -model train_val.prototxt [-weights w.caffemodel] [-iterations N] [-device cuda|cpu]
    python -m caffe_mpi_tpu_torch.tools.cli time -model train_val.prototxt [-iterations N] [-phase TRAIN|TEST] [-profile DIR] [-device cuda|cpu]
    python -m caffe_mpi_tpu_torch.tools.cli device_query
    python -m caffe_mpi_tpu_torch.tools.cli serve -model deploy.prototxt [-weights w.caffemodel] [-port P | -smoke N] [-labels L] [-image_root DIR] [-serve_buckets 1,4,10] [-serve_window_ms W] [-serve_dtype f32|bf16] [-serve_hbm_mb M] [-serve_queue_limit Q] [-serve_deadline_ms D] [-serve_stall_s S] [-serve_decoded_cache_mb C] [-require_native_ingest] [-watch PREFIX] [-replicas N [-serve_retry_budget B] [-replica_deadline S] [-fleet_dir D]] [-device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np

from ..utils.model_shapes import _CLASSIFICATION_CONSUMERS

log = logging.getLogger("caffe")

# the JAX CLI's flags of modules not ported yet: (flag, type, ROADMAP.md
# section 1 item); each exits 1 naming its item
UNPORTED_FLAGS = (("require_bank_warm", bool, 5),)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="caffe", description=__doc__)
    p.add_argument("command", choices=["train", "test", "time",
                                        "device_query", "serve"])
    p.add_argument("-solver", "--solver", default="",
                   help="solver prototxt (train)")
    p.add_argument("-synthetic", "--synthetic", action="store_true",
                   help="train a net without a Data layer on random data "
                   "shaped from its Input layers")
    p.add_argument("-max_iter", "--max-iter", dest="max_iter", type=int,
                   default=0, help="override the solver's max_iter")
    p.add_argument("-test_iter", "--test-iter", dest="test_iter", type=int,
                   default=0, help="override the solver's test_iter")
    p.add_argument("-snapshot_prefix", "--snapshot-prefix",
                   dest="snapshot_prefix", default="",
                   help="override the solver's snapshot_prefix")
    p.add_argument("-snapshot", "--snapshot", default="",
                   help=".solverstate to resume from (train)")
    p.add_argument("-model", "--model", default="",
                   help="net prototxt (test, time; serve: a deploy net)")
    p.add_argument("-iterations", "--iterations", type=int, default=50,
                   help="batches (test) or timed runs (time)")
    p.add_argument("-phase", "--phase", default="TEST",
                   choices=["TRAIN", "TEST"], help="net phase (time)")
    p.add_argument("-profile", "--profile", default="",
                   help="write a torch.profiler trace to this directory "
                   "(time)")
    p.add_argument("-weights", "--weights", default="",
                   help=".caffemodel to load (default: weights drawn from "
                   "a torch.Generator: seed 0 for serve, the solver's "
                   "random_seed for train)")
    p.add_argument("-serve_window_ms", "--serve-window-ms",
                   dest="serve_window_ms", type=float, default=-1.0,
                   help="batching window in ms (default: the "
                   "ServingParameter default)")
    p.add_argument("-serve_buckets", "--serve-buckets", dest="serve_buckets",
                   default="", help="explicit bucket ladder, e.g. '1,4,10'")
    p.add_argument("-serve_queue_limit", "--serve-queue-limit",
                   dest="serve_queue_limit", type=int, default=-1,
                   help="bound on the request backlog; over-limit submits "
                   "are shed (0 = unbounded)")
    p.add_argument("-serve_hbm_mb", "--serve-hbm-mb", dest="serve_hbm_mb",
                   type=float, default=-1.0,
                   help="device budget (MiB) for resident model weights; "
                   "the least-recently-used model spills to its host copy "
                   "(-1 = the ServingParameter default 0 = unlimited)")
    p.add_argument("-serve_dtype", "--serve-dtype", dest="serve_dtype",
                   default="", help="bucket forward precision, f32 or bf16 "
                   "(scores come back float32 either way; '' = the "
                   "ServingParameter default f32)")
    p.add_argument("-serve_deadline_ms", "--serve-deadline-ms",
                   dest="serve_deadline_ms", type=float, default=-1.0,
                   help="per-request dispatch deadline: a request whose "
                   "batch cannot dispatch this soon fails with HTTP 504 "
                   "(-1 = the default 0 = no deadline)")
    p.add_argument("-serve_stall_s", "--serve-stall-s", dest="serve_stall_s",
                   type=float, default=-1.0,
                   help="dispatch stall breaker: a device call blocked this "
                   "long fails the in-flight requests, flips /healthz to 503 "
                   "and sheds until a recovery probe succeeds (-1 = the "
                   "default 0 = off)")
    p.add_argument("-serve_decoded_cache_mb", "--serve-decoded-cache-mb",
                   dest="serve_decoded_cache_mb", type=float, default=-1.0,
                   help="decoded-request cache (MiB), keyed by the crc32c "
                   "of the upload bytes (-1 = the default 0 = off)")
    p.add_argument("-port", "--port", type=int, default=5000,
                   help="serve: HTTP port (0 picks an ephemeral port)")
    p.add_argument("-labels", "--labels", default="",
                   help="serve: class-label file, one label per line")
    p.add_argument("-image_root", "--image-root", dest="image_root",
                   default="", help="serve: allow GET /classify_path under "
                   "this directory")
    p.add_argument("-smoke", "--smoke", type=int, default=0,
                   help="serve: send N seeded PNG/JPEG uploads over real "
                   "HTTP, print the telemetry JSON, check that every "
                   "request answered and no bucket was built after "
                   "warm-up, and exit")
    p.add_argument("-require_native_ingest", "--require-native-ingest",
                   dest="require_native_ingest", action="store_true",
                   help="serve -smoke: fail unless the uploads decoded "
                   "natively and preprocessed through the window-fused "
                   "native plane")
    p.add_argument("-step_chunk", "--step_chunk", "--step-chunk",
                   dest="step_chunk", type=int, default=0,
                   help="run up to K iterations a chunk, one host sync "
                   "each; on the card a chunk replays a CUDA graph of one "
                   "iteration (overrides solver step_chunk; 0 = the "
                   "prototxt's, default 1). Chunks stop at display, "
                   "test_interval and snapshot boundaries")
    p.add_argument("-precision", "--precision", default="",
                   help="train: compute precision f32 or bf16 (overrides "
                   "solver precision; '' = the prototxt's, default f32). "
                   "bf16 computes activations and gradients in bfloat16 "
                   "with float32 master params and slots, loss scaling "
                   "per -loss_scale")
    p.add_argument("-loss_scale", "--loss-scale", dest="loss_scale",
                   type=float, default=-1.0,
                   help="bf16 loss scale: 0 = dynamic (an overflow step is "
                   "skipped and the scale halves, regrowing 2x after "
                   "loss_scale_window clean steps), > 0 = that static "
                   "scale (overrides solver loss_scale; -1 = the "
                   "prototxt's, default dynamic)")
    p.add_argument("-loss_scale_window", "--loss-scale-window",
                   dest="loss_scale_window", type=int, default=0,
                   help="clean steps before the dynamic loss scale grows "
                   "2x (overrides solver loss_scale_window; 0 = the "
                   "prototxt's, default 200)")
    p.add_argument("-train_guard", "--train-guard", dest="train_guard",
                   action="store_true",
                   help="arm the skip-step guard: a step with a non-finite "
                   "loss or update keeps params, slots and statistics; "
                   "guard_max_skips consecutive skips exit 88")
    p.add_argument("-guard_max_skips", "--guard-max-skips",
                   dest="guard_max_skips", type=int, default=-1,
                   help="consecutive skipped steps before exit 88; 0 = "
                   "never (overrides solver guard_max_skips; -1 = the "
                   "prototxt's, default 3)")
    p.add_argument("-device", "--device", default="cuda",
                   help="device to run on (default: cuda; 'cpu' runs "
                   "on the CPU)")
    # data parallelism (the JAX CLI's flags)
    p.add_argument("-gpu", "--gpu", default="",
                   help="train: 'all' = one data-parallel rank per card of "
                   "this host, or card indices 'i,j'; NCCL (raises "
                   "without a card)")
    p.add_argument("-mesh", "--mesh", default="",
                   help="train: data=N[,model=M]: N x M ranks in all (over "
                   "-hosts); on the cards one a card, and more ranks than "
                   "cards raise; with -device cpu, N x M processes over "
                   "gloo")
    p.add_argument("-gpipe", "--gpipe", type=int, default=0,
                   help="train: pipeline-train across S stages (GPipe over "
                   "heterogeneous stages, parallel/gpipe.py): the net cut "
                   "into S stages, stage s on cuda:s when S cards are "
                   "visible, else all on the one card; the batch cut into "
                   "micro-batches; stage-local updates; exclusive of "
                   "-gpu/-mesh")
    p.add_argument("-gpipe_micro", "--gpipe-micro", dest="gpipe_micro",
                   type=int, default=0,
                   help="train: micro-batches an iteration under -gpipe "
                   "(default: the stages)")
    p.add_argument("-decoded_cache_mb", "--decoded-cache-mb",
                   dest="decoded_cache_mb", type=float, default=0.0,
                   help="train: host budget (MiB) of the decoded-record "
                   "cache (overrides solver decoded_cache_mb; 0 = the "
                   "prototxt's)")
    for flag, kind, item in UNPORTED_FLAGS:
        extra = dict(action="store_const", const=True) if kind is bool \
            else dict(type=kind)
        p.add_argument(f"-{flag}", f"--{flag.replace('_', '-')}",
                       dest=f"unported_{flag}", default=None, **extra,
                       help=f"the JAX CLI's -{flag}: not ported yet "
                       f"(ROADMAP.md §1 item {item}); exits 1")
    p.add_argument("-reduce_overlap", "--reduce-overlap",
                   dest="reduce_overlap", action="store_true",
                   help="all-reduce the gradients bucket by bucket from "
                   "backward's gradient hooks (enables solver "
                   "reduce_overlap; needs -gpu or -mesh; a net the JAX "
                   "bucketed step does not take falls back with a warning)")
    p.add_argument("-reduce_buckets", "--reduce-buckets",
                   dest="reduce_buckets", type=int, default=0,
                   help="buckets for -reduce_overlap (overrides solver "
                   "reduce_buckets; 0 = the prototxt's, default the net's "
                   "reduce_buckets, 6)")
    p.add_argument("-grad_bucket_mb", "--grad-bucket-mb",
                   dest="grad_bucket_mb", type=float, default=0.0,
                   help="size -reduce_overlap buckets by a MiB budget "
                   "instead of a count (overrides solver grad_bucket_mb; "
                   "exclusive of -reduce_buckets)")
    p.add_argument("-zero_stage", "--zero-stage", dest="zero_stage",
                   type=int, default=-1,
                   help="1 = shard the optimizer slots over the ranks "
                   "(ZeRO-1; overrides solver zero_stage; -1 = the "
                   "prototxt's)")
    p.add_argument("-hosts", "--hosts", type=int, default=0,
                   help="train: host processes in the cluster (the "
                   "reference's mpirun -n); > 1 forms the group against "
                   "-coordinator (a missing one journals and exits 87) "
                   "(overrides solver hosts; env CAFFE_TPU_NUM_HOSTS)")
    p.add_argument("-coordinator", "--coordinator", default="",
                   help="train: host:port of host 0's store (overrides "
                   "solver coordinator; env CAFFE_TPU_COORDINATOR)")
    p.add_argument("-host_id", "--host-id", dest="host_id", type=int,
                   default=-1,
                   help="train: this host's index in [0, hosts) (-1 = env "
                   "CAFFE_TPU_HOST_ID)")
    p.add_argument("-host_deadline", "--host-deadline",
                   dest="host_deadline", type=float, default=0.0,
                   help="train: cross-host heartbeat deadline in seconds: a "
                   "peer host silent this long is journaled to the rank's "
                   "run journal (host_lost:<peer>) and this worker exits 87 "
                   "for the supervisor, instead of hanging in the next "
                   "collective (overrides solver host_deadline; 0 = the "
                   "prototxt's, default off)")
    p.add_argument("-min_hosts", "--min-hosts", dest="min_hosts", type=int,
                   default=0,
                   help="train: degraded-mode quorum (needs -hosts > 1 and "
                   "-max_restarts): after a host is lost for good the "
                   "surviving supervisors publish a generation of W' >= "
                   "min_hosts hosts and training goes on from the newest "
                   "verified snapshot; a revived host parks and is "
                   "re-admitted at a snapshot boundary (overrides solver "
                   "min_hosts; 0 = the prototxt's, default off)")
    # survivable training (the JAX CLI's flags)
    p.add_argument("-resume", "--resume", default="",
                   help="'auto' = resume from the newest VERIFIED snapshot "
                   "under the snapshot prefix (crc32c manifests, newest "
                   "first; a corrupt one falls back to an older one; none "
                   "= a fresh start). A path behaves like -snapshot")
    p.add_argument("-max_restarts", "--max-restarts", dest="max_restarts",
                   type=int, default=0,
                   help="supervise: run training in a contained child "
                   "process and restart it (-resume auto, exponential "
                   "backoff) up to N times on a failure, a watchdog exit "
                   "86 included (0 = unsupervised)")
    p.add_argument("-watchdog_deadline", "--watchdog-deadline",
                   dest="watchdog_deadline", type=float, default=0.0,
                   help="arm the dispatch watchdog: journal the run state "
                   "and exit 86 when a device wait (a chunk, a test pass, "
                   "a snapshot copy) lasts longer than this many seconds "
                   "(overrides solver watchdog_deadline; 0 = the "
                   "prototxt's, default off). It must exceed the first "
                   "chunk, which holds the CUDA graph capture, cuDNN's "
                   "algorithm search and the kernel libraries' first load "
                   "(1.2-1.9 s for LeNet and AlexNet b256 at step_chunk "
                   "10 on an H100, chip_smoke.py's survive phase)")
    p.add_argument("-snapshot_every", "--snapshot-every",
                   dest="snapshot_every", type=int, default=0,
                   help="override the solver's snapshot interval (0 = the "
                   "prototxt's)")
    p.add_argument("-snapshot_keep", "--snapshot-keep",
                   dest="snapshot_keep", type=int, default=0,
                   help="keep the newest N snapshots, deleting older ones "
                   "after each write, never the newest verified one "
                   "(overrides solver snapshot_keep; 0 = the prototxt's, "
                   "default all)")
    p.add_argument("-anomaly_action", "--anomaly-action",
                   dest="anomaly_action", default="",
                   choices=["", "rewind", "rewind_lr", "abort"],
                   help="supervisor policy on exit 88: rewind to the newest "
                   "verified snapshot (default), rewind_lr = also scale "
                   "base_lr by anomaly_lr_mult a numeric restart, abort = "
                   "no restart (overrides solver anomaly_action)")
    p.add_argument("-lr_scale", "--lr-scale", dest="lr_scale", type=float,
                   default=1.0,
                   help="multiply the solver's base_lr (the supervisor sets "
                   "it on rewind_lr restarts)")
    p.add_argument("-test_chunk", "--test-chunk", dest="test_chunk",
                   type=int, default=0,
                   help="test batches a chunk of a test pass (overrides "
                   "solver test_chunk; 0 = the prototxt's, default auto: "
                   "as many as fit 256 MiB of feeds, at most 64)")
    p.add_argument("-sigint_effect", "--sigint-effect", dest="sigint_effect",
                   default="stop", choices=["stop", "snapshot", "none"],
                   help="train: what SIGINT does at the next chunk "
                   "boundary (stop = snapshot and stop)")
    p.add_argument("-sighup_effect", "--sighup-effect", dest="sighup_effect",
                   default="snapshot", choices=["stop", "snapshot", "none"],
                   help="train: what SIGHUP does at the next chunk boundary")
    # the serving fleet (the JAX CLI's flags)
    p.add_argument("-replicas", "--replicas", dest="serve_replicas",
                   type=int, default=-1,
                   help="serve: run N replica processes behind a "
                   "least-loaded typed-retry router, supervised by "
                   "heartbeat, with rolling -watch swaps (sets "
                   "ServingParameter serve_replicas; -1 = the default 0, "
                   "one process)")
    p.add_argument("-serve_retry_budget", "--serve-retry-budget",
                   dest="serve_retry_budget", type=int, default=-1,
                   help="serve -replicas: sibling replicas a retryable "
                   "failure (429 shed, 503 unhealthy or closed, a dead "
                   "replica's connection error) is retried on before it "
                   "goes typed to the client; 504 and 400 never retry "
                   "(-1 = the default 1)")
    p.add_argument("-replica_deadline", "--replica-deadline",
                   dest="replica_deadline", type=float, default=-1.0,
                   help="serve -replicas: heartbeat deadline (s); a replica "
                   "silent this long is drained, journaled replica_dead, "
                   "respawned and re-admitted after its readyz gate (-1 = "
                   "the default 5)")
    p.add_argument("-fleet_dir", "--fleet-dir", dest="fleet_dir",
                   default="",
                   help="serve -replicas: the fleet's directory "
                   "(heartbeats, staged swap weights, replica logs, the "
                   "fleet journal); default <model>_fleet. With "
                   "-replica_id it marks a spawned replica (internal)")
    p.add_argument("-replica_id", "--replica-id", dest="replica_id",
                   type=int, default=-1,
                   help="internal: this process is fleet replica K — it "
                   "beats under -fleet_dir and mounts POST /swap (set by "
                   "the fleet supervisor)")
    p.add_argument("-watch", "--watch", dest="serve_watch", default="",
                   help="serve: a training run's snapshot prefix; each newly "
                   "crc32c-verified snapshot is canary-gated and copied "
                   "into the served model's live tensors (no capture); a "
                   "rejected one is journaled and the previous weights "
                   "keep serving")
    for param, table in _unported():
        for name, item in table:
            default = getattr(param(), name)
            kind = dict(action="store_const", const=True) \
                if isinstance(default, bool) else dict(type=type(default))
            p.add_argument(f"-{name}", f"--{name.replace('_', '-')}",
                           dest=name, default=None, **kind,
                           help=f"{param.__name__}.{name}: not ported yet "
                           f"(ROADMAP.md §1 item {item}); any value but "
                           f"{default!r} is refused")
    return p


def _refuse_unported_flags(args) -> bool:
    """Log the refusal of each UNPORTED_FLAGS flag given; True if any."""
    given = [(flag, item) for flag, _, item in UNPORTED_FLAGS
             if getattr(args, f"unported_{flag}", None) is not None]
    for flag, item in given:
        log.error("-%s is not ported yet (ROADMAP.md §1 item %d)", flag,
                  item)
    return bool(given)


def _unported():
    """(parameter class, its UNPORTED_FIELDS) for the solver and serving."""
    from ..proto.config import ServingParameter, SolverParameter
    from ..serving import engine
    from ..solver import solver
    return ((SolverParameter, solver.UNPORTED_FIELDS),
            (ServingParameter, engine.UNPORTED_FIELDS))


def _apply_unported(args, param) -> None:
    """The unported fields' flags that were given, onto `param`."""
    for cls, table in _unported():
        if isinstance(param, cls):
            for name, _ in table:
                if getattr(args, name) is not None:
                    setattr(param, name, getattr(args, name))


def synthetic_feed(net, seed: int = 0, rank: int = 0,
                   world: int = 1) -> dict:
    """Random feeds shaped from the net's feed specs, on the net's device,
    drawn as the JAX CLI's `_synthetic_feed` draws them: integer feeds are
    chosen by consumer, not by blob name. Under data parallelism (`world`
    ranks, the net at batch/world) the draw is the global batch's and the
    feed is rank `rank`'s slice of it."""
    import torch
    r = np.random.RandomState(seed)
    int_range: dict[str, int] = {}
    for layer in net.layers:
        lp = layer.lp
        if lp.type == "Embed" and lp.bottom:
            int_range[lp.bottom[0]] = lp.embed_param.input_dim
        elif lp.type in _CLASSIFICATION_CONSUMERS and len(lp.bottom) > 1:
            int_range.setdefault(lp.bottom[1], 10)
    feeds = {}
    for key, (shape, kind) in net.feed_specs.items():
        b = shape[0] if shape else 1
        shape = (b * world, *shape[1:]) if shape else shape
        if kind == "uint8":
            a = r.randint(0, 256, shape).astype(np.uint8)
        elif kind == "aug":
            # zeros = the top-left crop, no mirror: always valid offsets
            a = np.zeros(shape, np.int32)
        elif key in int_range or kind == "int":
            a = r.randint(0, max(int_range.get(key, 10), 1), shape)
        else:
            a = r.randn(*shape).astype(np.float32)
        if world > 1:
            a = a[rank * b:(rank + 1) * b]
        feeds[key] = torch.from_numpy(np.ascontiguousarray(a)).to(net.device)
    return feeds


def build_feeder(net, phase: str, solver_param=None, rank: int = 0,
                 world: int = 1):
    """The feeder of the net's data layer: a Feeder for Data and ImageData,
    a WindowFeeder for WindowData; None for a net fed through Input layers
    (the JAX CLI's `_build_feeders`). solver_param gives the run's
    `decoded_cache_mb`; `rank` of `world` data-parallel ranks reads its
    stripe of each global batch."""
    from ..data.feeder import feeder_from_layer
    for layer in net.layers:
        if layer.lp.type in ("Data", "ImageData", "HDF5Data"):
            return feeder_from_layer(
                layer.lp, phase, rank=rank, world=world,
                model_dir=net.model_dir,
                device_transform=getattr(layer, "dev_transform", False),
                solver_param=solver_param)
        if layer.lp.type == "WindowData":
            from ..data.window import WindowFeeder
            return WindowFeeder(layer.lp, phase, model_dir=net.model_dir,
                                rank=rank, world=world)
    return None


def _feed_fns(solver, synthetic: bool):
    """(train feed fn, test feed fns, the DeviceFeeds to close, the train
    Feeder or None)."""
    from ..data.feeder import DeviceFeed
    opened = []
    mesh = solver.mesh
    # the model ranks of a data index read its slice
    rank, world = (mesh.data_index, mesh.n_data) if mesh is not None \
        else (0, 1)
    feeder = build_feeder(solver.net, "TRAIN", solver.sp, rank, world)
    if feeder is None:
        if not synthetic:
            raise ValueError("net has no Data layer; pass -synthetic to "
                             "train on random data or use a Data net")
        feeds = synthetic_feed(solver.net, 0, rank, world)
        feed_fn = lambda it: feeds  # noqa: E731
    else:
        feed_fn = DeviceFeed(feeder, solver.device)
        opened.append(feed_fn)
    test_fns = None
    if solver.test_nets:
        test_fns = []
        for tnet, sharded in zip(solver.test_nets, solver.test_sharded):
            r, w = (rank, world) if sharded else (0, 1)
            f = build_feeder(tnet, "TEST", solver.sp, r, w)
            if f is None:
                tfeeds = synthetic_feed(tnet, 1, r, w)
                test_fns.append(lambda it, tfeeds=tfeeds: tfeeds)
            else:
                test_fns.append(DeviceFeed(f, solver.device))
                opened.append(test_fns[-1])
    return feed_fn, test_fns, opened, feeder


def window_img_per_s(batch: int, step_ms: list[float]) -> float:
    """Images a second over a window of steps: every step's batch over
    their summed time. Unlike a median step it counts each stall."""
    return batch * len(step_ms) / (sum(step_ms) / 1e3) if step_ms \
        else float("nan")


def _layout(args, sp):
    """The data-parallel layout of `train`: None for one device, else
    {hosts, host_id, coordinator, local (this host's rank devices),
    world}. `-gpu all|i,j` takes cards; `-mesh data=N` N ranks over the
    hosts (cards, or CPU processes under -device cpu); `-hosts H` alone
    one rank a host. Raises ValueError / NotImplementedError on a bad
    layout and ClusterError on an incomplete cluster."""
    from ..parallel import mesh as mesh_mod
    hosts, coordinator, host_id = mesh_mod.resolve_cluster(sp, args.host_id)
    hosts, host_id = max(hosts, 1), max(host_id, 0)
    if args.gpu and args.mesh:
        raise ValueError("-gpu and -mesh are exclusive")
    on_cpu = str(args.device).startswith("cpu")
    if args.gpu:
        if on_cpu:
            raise ValueError("-gpu names cards; it cannot run with "
                             "-device cpu")
        cards = mesh_mod._cards()
        if args.gpu == "all":
            local = cards
        else:
            idx = [int(i) for i in args.gpu.split(",")]
            bad = [i for i in idx if not 0 <= i < len(cards)]
            if bad:
                raise ValueError(f"-gpu {args.gpu}: no card {bad} (this "
                                 f"host has {len(cards)})")
            local = [f"cuda:{i}" for i in idx]
    elif args.mesh:
        shape = {"data": 1, "model": 1}
        for kv in args.mesh.split(","):
            k, _, v = kv.partition("=")
            if k.strip() not in shape or not v.strip().isdigit():
                raise ValueError(f"bad -mesh entry {kv!r}: expected "
                                 "data=N[,model=M]")
            shape[k.strip()] = int(v)
        data, model = shape["data"], shape["model"]
        ranks = data * model
        if data < 1 or model < 1 or ranks % hosts:
            raise ValueError(f"-mesh data={data},model={model} does not "
                             f"divide over {hosts} host(s)")
        per = ranks // hosts
        if on_cpu:
            local = ["cpu"] * per
        else:
            cards = mesh_mod._cards()
            if per > len(cards):
                raise ValueError(f"mesh {data}x{model} needs {ranks} "
                                 f"devices, have {len(cards) * hosts}")
            local = cards[:per]
        return dict(hosts=hosts, host_id=host_id, coordinator=coordinator,
                    local=local, world=ranks, data=data, model=model)
    elif hosts > 1:
        local = ["cpu" if on_cpu else "cuda:0"]
    else:
        return None
    return dict(hosts=hosts, host_id=host_id, coordinator=coordinator,
                local=local, world=hosts * len(local),
                data=hosts * len(local), model=1)


def _form_mesh(layout: dict):
    """This process's rank of `layout` (rank = host_id x local ranks +
    local rank): the group formed, the MeshPlan made. ClusterError when
    the group does not form."""
    import torch

    from ..parallel import mesh as mesh_mod
    local = layout["local"]
    local_rank = int(os.environ.get("CAFFE_TPU_LOCAL_RANK", "0") or 0)
    rank = layout["host_id"] * len(local) + local_rank
    devices = local * layout["hosts"]
    coordinator = layout["coordinator"] or f"127.0.0.1:{mesh_mod.free_port()}"
    # host processes behind a loopback coordinator share this machine's
    # cards: two on one card run over gloo (NCCL refuses that)
    machines = 1 if mesh_mod.local_coordinator(coordinator) \
        else layout["hosts"]
    mesh_mod.init_distributed(
        coordinator, layout["world"], rank,
        backend=mesh_mod.backend_for(devices, machines),
        device=torch.device(local[local_rank]))
    if rank == 0:
        # a generation-managed run (min_hosts): its record on the store
        mesh_mod.publish_generation()
    return mesh_mod.MeshPlan.from_shape(layout["data"], layout["model"],
                                        devices=devices,
                                        hosts=layout["hosts"])


def _spawn_workers(args, layout: dict) -> int:
    """One worker process a local rank (this argv, CAFFE_TPU_LOCAL_RANK
    set, the coordinator fixed), each contained in its process group
    (utils/subproc.py). When one fails the others are killed, so none
    waits in a collective until its timeout; returns the first failure's
    code, else 0. A worker stuck on the device is bounded by its own
    collective timeout and `-watchdog_deadline`."""
    import threading

    from ..parallel import mesh as mesh_mod
    from ..utils import subproc
    argv = list(getattr(args, "_argv", None) or sys.argv[1:])
    coordinator = layout["coordinator"] \
        or f"127.0.0.1:{mesh_mod.free_port()}"
    rcs: list = [None] * len(layout["local"])
    failed = threading.Event()

    def run(k):
        env = dict(os.environ, CAFFE_TPU_LOCAL_RANK=str(k),
                   CAFFE_TPU_COORDINATOR=coordinator)
        rcs[k], _, _ = subproc.run_contained(
            [sys.executable, "-m", "caffe_mpi_tpu_torch.tools.cli"] + argv,
            None, env=env, echo=True)
        if rcs[k] != 0 and not failed.is_set():
            failed.set()
            log.error("worker %d exited %s; stopping the others", k, rcs[k])
            subproc.kill_all()

    # the kill-on-signal hooks go in from the main thread (the workers'
    # threads cannot install them)
    subproc._install_hooks()
    threads = [threading.Thread(target=run, args=(k,), daemon=True)
               for k in range(len(layout["local"]))]
    for t in threads:
        t.start()
    for t in threads:
        # lint: ok(deadline-discipline) — each thread waits on its worker
        # process, bounded by the worker's collective timeout and
        # -watchdog_deadline; a failed worker kills the others
        t.join()
    first = next((rc for rc in rcs if rc not in (0, -9)), None)
    return first if first is not None else max(rcs, key=abs)


def _cluster_exit(prefix: str, rank: int, reason: str, error: str) -> int:
    """Journal a cluster failure and exit 87 (the JAX `_cluster_exit`):
    rank 0 owns `<prefix>.run.json`, rank k writes `<prefix>.r<k>`."""
    from ..utils import resilience
    log.error("%s: %s; exiting %d for the supervisor's coordinated "
              "restart", reason, error, resilience.EXIT_CLUSTER)
    try:
        resilience.write_run_manifest(
            prefix if rank <= 0 else f"{prefix}.r{rank}",
            reason=reason, error=error, exit_code=resilience.EXIT_CLUSTER)
    except OSError:
        log.exception("cluster-failure journal failed (continuing)")
    return resilience.EXIT_CLUSTER


def _signal_handlers(solver, args):
    """SIGINT and SIGHUP set the solver's request flags, acted on at the
    next chunk boundary (a handler never touches the device). Returns
    the previous handlers; nothing is installed off the main thread."""
    import signal
    import threading
    if threading.current_thread() is not threading.main_thread():
        return {}

    def handler(effect):
        def on_signal(signum, frame):
            if effect in ("stop", "snapshot"):
                solver.requests[effect] = True
                log.info("signal %d: %s at the next chunk boundary",
                         signum, effect)
        return on_signal

    prev = {}
    for sig, effect in ((signal.SIGINT, args.sigint_effect),
                        (getattr(signal, "SIGHUP", None),
                         args.sighup_effect)):
        if sig is not None:
            prev[sig] = signal.signal(sig, handler(effect))
    return prev


def _resume(solver, args):
    """The JAX CLI's resume order: `-resume auto` first; then `-snapshot`
    (or a `-resume` path), falling back to the newest verified snapshot
    when its manifest fails; then `-weights`. Returns the state path
    resumed from, or None."""
    from ..utils.resilience import SnapshotCorruptError
    snapshot = args.snapshot
    if args.resume and args.resume != "auto":
        snapshot = snapshot or args.resume
    if args.resume == "auto":
        resumed = solver.restore_auto()
        if resumed is not None:
            return resumed
    if snapshot:
        try:
            solver.restore(snapshot)
            return snapshot
        except SnapshotCorruptError as e:
            log.warning("%s", e)
            resumed = solver.restore_auto()
            if resumed is None:
                raise
            log.warning("resumed from %s instead of the corrupt %s",
                        resumed, snapshot)
            return resumed
    if args.weights:
        for w in args.weights.split(","):
            solver.load_weights(w)
    return None


def solver_param(args):
    """The solver prototxt of `args` with the flags' overrides."""
    from ..proto import SolverParameter
    if not args.solver:
        raise ValueError("train requires -solver")
    sp = SolverParameter.from_file(args.solver)
    if args.max_iter:
        sp.max_iter = args.max_iter
    if args.test_iter:
        sp.test_iter = [args.test_iter] * max(len(sp.test_iter), 1)
    if args.snapshot_prefix:
        sp.snapshot_prefix = args.snapshot_prefix
    if args.snapshot_every:
        sp.snapshot = args.snapshot_every
    if args.snapshot_keep:
        sp.snapshot_keep = args.snapshot_keep
    if args.watchdog_deadline:
        sp.watchdog_deadline = args.watchdog_deadline
    if args.test_chunk:
        sp.test_chunk = args.test_chunk
    if args.anomaly_action:
        sp.anomaly_action = args.anomaly_action
    if args.decoded_cache_mb:
        sp.decoded_cache_mb = args.decoded_cache_mb
    if args.step_chunk:
        sp.step_chunk = args.step_chunk
    if args.precision:
        sp.precision = args.precision
    if args.loss_scale >= 0:  # 0 is dynamic; -1 keeps the prototxt's
        sp.loss_scale = args.loss_scale
    if args.loss_scale_window:
        sp.loss_scale_window = args.loss_scale_window
    if args.train_guard:
        sp.train_guard = True
    if args.guard_max_skips >= 0:  # 0 is "never exit"
        sp.guard_max_skips = args.guard_max_skips
    if args.lr_scale != 1.0:
        # a rewind_lr restart: the replay must not step straight back
        # into the divergence
        sp.base_lr = sp.base_lr * args.lr_scale
        log.info("base_lr scaled by %g -> %g (anomaly rewind)",
                 args.lr_scale, sp.base_lr)
    if args.reduce_overlap:
        sp.reduce_overlap = True
    # a CLI sizing mode overrides the prototxt's other mode too; both CLI
    # flags at once reach the solver's "not both" check
    if args.reduce_buckets:
        sp.reduce_buckets = args.reduce_buckets
        if not args.grad_bucket_mb:
            sp.clear("grad_bucket_mb")
    if args.grad_bucket_mb:
        sp.grad_bucket_mb = args.grad_bucket_mb
        if not args.reduce_buckets:
            sp.clear("reduce_buckets")
    if args.zero_stage >= 0:
        sp.zero_stage = args.zero_stage
    if args.hosts:
        sp.hosts = args.hosts
    if args.coordinator:
        sp.coordinator = args.coordinator
    if args.host_deadline:
        sp.host_deadline = args.host_deadline
    if args.min_hosts:
        sp.min_hosts = args.min_hosts
    if args.gpipe and (args.gpu or args.mesh):
        raise ValueError("-gpipe is exclusive of -gpu/-mesh (stages own "
                         "whole devices)")
    if args.gpipe_micro and not args.gpipe:
        raise ValueError("-gpipe_micro needs -gpipe")
    _apply_unported(args, sp)
    return sp


def train(args):
    """Build the solver from `args`, resume or load weights, train to
    max_iter with a test pass at every test_interval and at the end, and
    snapshot after training (or at a stop request). Returns (solver,
    summary dict). A data-parallel layout of one rank on this host (or a
    worker `cmd_train` spawned) forms its group here and leaves it at the
    end; more local ranks need `cmd_train`, which spawns them."""
    from ..parallel import mesh as mesh_mod
    sp = solver_param(args)
    layout = _layout(args, sp)
    if layout and len(layout["local"]) > 1 \
            and "CAFFE_TPU_LOCAL_RANK" not in os.environ:
        raise ValueError(f"{len(layout['local'])} ranks on this host run "
                         "one process each: use `cli train` (cmd_train)")
    # net paths in the solver are relative to the working directory, as
    # the reference's are (and so are its Data layers' sources); an
    # inline or missing one resolves beside the solver file
    model_dir = "" if (sp.net and os.path.exists(sp.net)) \
        else os.path.dirname(os.path.abspath(args.solver))
    mesh = _form_mesh(layout) if layout else None
    try:
        out = _train(args, sp, model_dir, mesh)
    finally:
        # after the exit barrier (_train), or at once after a failure: a
        # peer may be gone
        if mesh is not None:
            mesh_mod.shutdown_distributed()
    return out


def _train(args, sp, model_dir, mesh):
    import signal

    from ..data.feeder import Feeder
    from ..ops import launch_counts
    from ..parallel import mesh as mesh_mod
    from ..solver import Solver
    from ..utils.resilience import (QUARANTINE, ClusterError,
                                    CollectiveError, quarantine_journal_path)
    # the JAX CLI's -gpipe (tools/cli.py:713-726)
    gpipe = {"stages": args.gpipe, "micro": args.gpipe_micro} \
        if args.gpipe else None
    solver = Solver(sp, model_dir=model_dir,
                    device=None if mesh else args.device, mesh=mesh,
                    gpipe=gpipe)
    t0 = time.perf_counter()
    resumed = _resume(solver, args)
    resume_ms = (time.perf_counter() - t0) * 1e3
    feed_fn, test_feed_fns, opened, feeder = _feed_fns(solver,
                                                       args.synthetic)
    # corrupt records the feeders substitute are journaled beside the
    # snapshots, <prefix>.quarantine.json (appended to on a resume); over
    # several hosts one journal a host, keyed on its stable identity in a
    # min_hosts run (a generation remaps ranks), merged by rank 0 at
    # each snapshot
    hosts = mesh.hosts if mesh is not None else 1
    stable = os.environ.get("CAFFE_TPU_CLUSTER_SELF")
    QUARANTINE.configure(quarantine_journal_path(
        sp.snapshot_prefix or "snapshot", rank=solver.rank, world=hosts,
        host=int(stable) if stable else None))
    start = solver.iter
    prev = _signal_handlers(solver, args)
    snapshot, scores = None, None
    try:
        solver.step(sp.max_iter - solver.iter, feed_fn, test_feed_fns)
        stopped = solver.requests["stop"]
        if not stopped and test_feed_fns and sp.test_interval:
            # final evaluation, as the JAX CLI runs it after the last
            # iteration
            scores = solver.test_all(test_feed_fns)
        if stopped or (sp.snapshot_prefix
                       and solver.should_snapshot_after_train()):
            snapshot = solver.snapshot()
        if mesh is not None:
            solver.wait_snapshots()
            solver.release_graphs()
            # rank 0 serves the store: nobody leaves while a peer still
            # uses it. The heartbeat ticks on while the ranks meet, so a
            # peer that crashed instead exits this one 87 within
            # host_deadline
            if not mesh_mod.cluster_barrier("exit"):
                raise ClusterError("the end-of-training barrier timed out "
                                   "(a peer lost after training?)",
                                   reason="cluster_exit_failed")
            # only now is the departure clean
            solver.heartbeat_farewell()
    except BaseException as e:
        if mesh is not None:  # the group is left next (see train)
            solver.release_graphs()
            if isinstance(e, CollectiveError):
                # a collective that failed because its peer died: the
                # heartbeat names the peer (or ClusterError, exit 87)
                solver.await_host_loss(e)
        raise
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
        for f in opened:
            f.close()
        # the journal's debounced tail is written on every exit path
        QUARANTINE.flush()
        # interval snapshots land (or raise) before the run counts as done
        solver.close()
    world = mesh.n_data if mesh is not None else 1
    batch = solver._batch_images() * solver._micro_batches() * world
    med = float(np.median(solver.iter_ms)) if solver.iter_ms \
        else float("nan")
    data = next((l for l in solver.net.layers if l.lp.type == "Data"), None)
    summary = {
        "solver": args.solver, "device": str(solver.device),
        "start_iter": start, "iters": solver.iter - start, "batch": batch,
        "losses": list(solver.losses), "iter_ms": list(solver.iter_ms),
        "chunk_ms": list(solver.chunk_ms), "median_iter_ms": med,
        "img_per_s": batch / (med / 1e3),
        # the first step (its warm-up) left out
        "window_img_per_s": window_img_per_s(batch, solver.iter_ms[1:]),
        "test_scores": scores,
        "snapshot": snapshot,
        "resumed_from": resumed, "resume_ms": resume_ms,
        "stopped": solver.requests["stop"],
        "snapshots": list(solver.snapshots),
        "snapshot_log": list(solver.snapshot_log),
        "kernel_launches": launch_counts(),
        "data": "synthetic" if feeder is None else "dataset",
        "device_transform": bool(data is not None and data.dev_transform),
        # a Feeder's build telemetry (a WindowFeeder builds each batch on
        # the DeviceFeed's thread and keeps none)
        **({"feed_ms_per_batch": feeder.feed_ms_per_batch(),
            "feed_threads": feeder.threads,
            "feed_lookahead": feeder.lookahead}
           if isinstance(feeder, Feeder) else
           {"feed_ms_per_batch": None, "feed_threads": None,
            "feed_lookahead": None}),
        "quarantined": QUARANTINE.count(),
        "precision": solver.precision, "step_chunk": solver.step_chunk,
        "skipped_iters": list(solver.skipped_iters),
        "skipped_steps": solver.skipped_steps,
        "overflow_steps": solver.overflow_steps,
        "loss_scale": solver.loss_scale_value,
        "dispatch_count": solver.dispatch_count,
        "host_sync_count": solver.host_sync_count,
        "graph_replays": solver.graph_replays,
        "test_dispatch_count": solver.test_dispatch_count,
        "test_host_reads": solver.test_host_reads,
        # data parallelism: this rank, the ranks, the reduce, and whether
        # the chunks replayed CUDA graphs (gloo on a card runs eagerly)
        "rank": solver.rank, "world": world,
        "n_model": mesh.n_model if mesh is not None else 1,
        "rank_batch": solver._batch_images(),
        "reduction": solver.reduction_stats(),
        "graphs": solver.graph_replays > 0,
        "graph_route": solver.graph_route,
        "graph_collectives": solver.graph_collectives,
        # the asynchronous evaluation: the host ms training lost to it
        # and each pass's scores, tagged with its iteration
        "eval_stall_ms": solver.eval_stall_ms,
        "eval_log": list(solver.eval_log),
        "gpipe": None if solver.gpipe is None else {
            "stages": solver.gpipe.n_stages, "micro": solver._gpipe_micro,
            "bounds": list(solver.gpipe.bounds),
            "devices": [str(d) for d in solver.gpipe.devices]},
    }
    return solver, summary


def _strip_flags(argv: list[str], flags: tuple[str, ...],
                 with_value: bool = True) -> list[str]:
    """`argv` without `flags` (and their values, or `=`-joined forms)."""
    out, skip = [], False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok in flags:
            skip = with_value
            continue
        if tok.startswith(tuple(f + "=" for f in flags)):
            continue
        out.append(tok)
    return out


def _supervised_train(args) -> int:
    """`train -max_restarts N`: run the training in a contained child (the
    argv without `-max_restarts`, so the caller's `-device` goes with it,
    and an environment marker against recursion) and restart it from the
    newest verified snapshot (`-resume auto`) with exponential backoff,
    a watchdog's exit 86 included, through resilience.supervise. The
    failure log is `<snapshot_prefix>.failures.log`. With min_hosts on a
    multi-host launch the supervisor is resilience.supervise_elastic
    (the JAX CLI's elastic branch). This process touches no card."""
    from ..proto import SolverParameter
    from ..utils import resilience
    argv = list(getattr(args, "_argv", None) or sys.argv[1:])
    child_argv = _strip_flags(
        argv, ("-max_restarts", "--max-restarts", "--max_restarts"))
    sp = SolverParameter.from_file(args.solver)
    prefix = args.snapshot_prefix or sp.snapshot_prefix or "snapshot"
    env = dict(os.environ, CAFFE_SUPERVISED_CHILD="1")
    # this host's journal: its repeated cluster_init_failed stops the
    # restarts early (resilience.supervise)
    journal = prefix if args.host_id <= 0 else f"{prefix}.r{args.host_id}"
    anomaly_action = args.anomaly_action or sp.anomaly_action or "rewind"
    cli_cmd = [sys.executable, "-m", "caffe_mpi_tpu_torch.tools.cli"]
    # degraded-mode elasticity (the JAX CLI's elastic branch): with the
    # quorum floor set on a multi-host launch the supervisor runs the
    # generation protocol, and each generation's child argv is rewritten
    # to its remapped -hosts W' -host_id k' -coordinator
    min_hosts = args.min_hosts or sp.min_hosts
    world = args.hosts or sp.hosts \
        or int(os.environ.get("CAFFE_TPU_NUM_HOSTS", "0") or 0)
    host_id = args.host_id if args.host_id >= 0 \
        else int(os.environ.get("CAFFE_TPU_HOST_ID", "-1") or -1)
    coordinator = args.coordinator or sp.coordinator \
        or os.environ.get("CAFFE_TPU_COORDINATOR", "")
    if min_hosts > 0 and world > 1 and host_id >= 0:
        host_deadline = args.host_deadline or sp.host_deadline or 5.0
        # the address the peers reach this host at (a new generation's
        # publisher serves its store): CAFFE_TPU_HOST_ADDR, else the
        # original coordinator's host
        coord_host = os.environ.get("CAFFE_TPU_HOST_ADDR", "") or (
            coordinator.rsplit(":", 1)[0] if ":" in coordinator
            else "127.0.0.1")
        stable_argv = _strip_flags(child_argv, (
            "-hosts", "--hosts", "-host_id", "--host-id", "--host_id",
            "-coordinator", "--coordinator", "-resume", "--resume"))

        def build_cmd(gen: dict, rank: int, resume: bool) -> list[str]:
            cmd = cli_cmd + stable_argv + ["-hosts", str(gen["world"]),
                                           "-host_id", str(rank)]
            if gen["world"] > 1:
                cmd += ["-coordinator", gen["coordinator"]]
            if resume:
                cmd += ["-resume", "auto"]
            return cmd

        journal = prefix if host_id == 0 else f"{prefix}.r{host_id}"
        return resilience.supervise_elastic(
            build_cmd, prefix=prefix, host_id=host_id, world_full=world,
            min_hosts=min_hosts, host_deadline=host_deadline,
            coordinator_host=coord_host, coordinator=coordinator,
            max_restarts=args.max_restarts,
            failure_log=journal + ".failures.log", env=env,
            anomaly_action=anomaly_action,
            anomaly_lr_mult=sp.anomaly_lr_mult)
    base_cmd = cli_cmd + child_argv
    resume_cmd = base_cmd
    if not any(t in ("-resume", "--resume")
               or t.startswith(("-resume=", "--resume="))
               for t in child_argv):
        resume_cmd = base_cmd + ["-resume", "auto"]
    return resilience.supervise(
        base_cmd, resume_cmd, args.max_restarts,
        failure_log=prefix + ".failures.log", env=env,
        anomaly_action=anomaly_action,
        anomaly_lr_mult=sp.anomaly_lr_mult, journal_prefix=journal)


def cmd_train(args) -> int:
    if args.max_restarts > 0 \
            and os.environ.get("CAFFE_SUPERVISED_CHILD") != "1":
        if not args.solver:
            log.error("train requires -solver")
            return 1
        return _supervised_train(args)
    from ..data.feeder import FeedError
    from ..utils.resilience import (EXIT_NUMERIC, ClusterError,
                                    DataIntegrityError, NumericAnomalyError)
    sp = layout = None
    try:
        sp = solver_param(args)
        layout = _layout(args, sp)
        if layout and len(layout["local"]) > 1 \
                and "CAFFE_TPU_LOCAL_RANK" not in os.environ:
            # one worker process a local rank; rank 0 prints the summary
            return _spawn_workers(args, layout)
        _, summary = train(args)
    except ClusterError as e:
        rank = 0
        if layout:
            rank = layout["host_id"] * len(layout["local"]) + int(
                os.environ.get("CAFFE_TPU_LOCAL_RANK", "0") or 0)
        elif args.host_id > 0:
            rank = args.host_id
        return _cluster_exit(sp.snapshot_prefix or "snapshot", rank,
                             e.reason, str(e))
    except (ValueError, NotImplementedError, FeedError,
            DataIntegrityError) as e:
        log.error("%s", e)
        return 1
    except NumericAnomalyError as e:
        # the solver has journaled it; exit 88 routes the supervisor
        # through anomaly_action
        log.error("%s; exiting %d for the supervisor to rewind", e,
                  EXIT_NUMERIC)
        return EXIT_NUMERIC
    if summary["rank"] == 0:
        print(json.dumps({"train": summary}), flush=True)
    # a step the guard skipped may have a non-finite loss
    skipped = set(summary["skipped_iters"])
    losses = [l for i, l in enumerate(summary["losses"])
              if summary["start_iter"] + i not in skipped]
    if not summary["losses"] or not all(np.isfinite(losses)):
        log.error("train: losses not all finite: %s", summary["losses"])
        return 1
    return 0


def test_net(args) -> dict[str, float]:
    """`test`: the TEST-phase net of args.model from args.weights over
    args.iterations batches; returns {terminal blob: mean over batches}.
    Sources and the mean file resolve against the working directory, as
    the reference's and `train`'s do (the JAX `cmd_test` resolves them
    beside the model file)."""
    import torch

    from .. import io as caffe_io
    from ..data.feeder import DeviceFeed
    from ..net import Net
    from ..proto import NetParameter
    from ..solver import Solver
    if not args.model:
        raise ValueError("test requires -model")
    net = Net(NetParameter.from_file(args.model), "TEST", device=args.device)
    net.init(0)
    if args.weights:
        net.import_weights(caffe_io.load_weights(args.weights))
    feeder = build_feeder(net, "TEST")
    feed = DeviceFeed(feeder, net.device) if feeder else None
    outputs = Solver._output_blobs(net)
    totals: dict[str, list] = {b: [] for b in outputs}
    try:
        with torch.no_grad():
            for it in range(args.iterations):
                feeds = feed(it) if feed else synthetic_feed(net, seed=it)
                blobs, _ = net(feeds)
                for b in outputs:  # per-batch means stay on the device
                    totals[b].append(blobs[b].float().mean())
    finally:
        if feed is not None:
            feed.close()
    # the average over batches in float64 on the host, as the JAX CLI
    # lint: ok(host-sync) — the test scores, read once at the end of the run
    return {b: float(np.mean(torch.stack(totals[b]).cpu().numpy(),
                             dtype=np.float64)) for b in outputs}


def cmd_test(args) -> int:
    from ..data.feeder import FeedError
    from ..utils.resilience import DataIntegrityError
    try:
        scores = test_net(args)
    except (ValueError, NotImplementedError, FeedError,
            DataIntegrityError) as e:
        log.error("%s", e)
        return 1
    for b, avg in scores.items():
        log.info("%s = %.5g", b, avg)
        print(f"{b} = {avg:.5g}")
    return 0


class _Clock:
    """Milliseconds a call of `fn` takes over `iters` calls after one warm
    call: CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device, iters: int):
        self.cuda = device.type == "cuda"
        self.iters = max(iters, 1)

    def __call__(self, fn) -> float:
        import torch
        fn()
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(self.iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / self.iters
        t0 = time.perf_counter()
        for _ in range(self.iters):
            fn()
        return (time.perf_counter() - t0) / self.iters * 1e3


def _layer_call(layer, bottoms, gen):
    if layer.needs_rng:
        return layer(bottoms, generator=gen, mask=None)
    return layer(bottoms)


def _isolated_backward(layer, bottoms, gen, clock, math) -> float:
    """ms of one layer's backward alone: the gradients of the sum of its
    squared float tops with respect to its params and float bottoms (the
    reference times each layer's Backward, tools/caffe.cpp:403-423);
    `math()` gives a fresh context of the net's TF32 setting a call."""
    import torch
    params = [getattr(layer, n) for n in layer.decls]
    inputs = [b.detach().requires_grad_() if b.is_floating_point() else b
              for b in bottoms]
    wrt = params + [b for b in inputs if b.requires_grad]
    if not wrt:
        return float("nan")
    saved = [p.requires_grad for p in params]
    try:
        for p in params:
            p.requires_grad_(True)
        with torch.enable_grad():
            tops = _layer_call(layer, inputs, gen)
            terms = [t.float().square().sum() for t in tops
                     if isinstance(t, torch.Tensor) and t.requires_grad]
            if not terms:
                return float("nan")
            s = sum(terms)

            def bwd():
                with math():
                    torch.autograd.grad(s, wrt, retain_graph=True,
                                        allow_unused=True)
            return clock(bwd)
    finally:
        for p, r in zip(params, saved):
            p.requires_grad_(r)


def time_net(args) -> dict:
    """`time`: prints the per-layer table and the whole-net lines; returns
    them as a dict."""
    import torch

    from ..layers.data_layers import InputLayerBase
    from ..net import Net
    from ..proto import NetParameter
    from ..utils.flops import (layer_macs_per_image, mfu_peak,
                               net_macs_per_image, train_flops_per_image)
    if not args.model:
        raise ValueError("time requires -model")
    net = Net(NetParameter.from_file(args.model), args.phase,
              device=args.device)
    net.init(0)
    dev = net.device
    precision = net.math_precision()
    policy = net.layers[0].policy
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    feeds = synthetic_feed(net)
    gen = torch.Generator(device=dev).manual_seed(0)
    clock = _Clock(dev, args.iterations)
    with torch.no_grad():
        blobs, _ = net(feeds, generator=gen)  # every layer's inputs
    rows = []
    for layer in net.layers:
        if isinstance(layer, InputLayerBase):
            continue
        bottoms = [blobs[b] for b in layer.lp.bottom]
        with torch.no_grad():
            fwd_ms = clock(lambda: _layer_call(layer, bottoms, gen))
        bwd_ms = _isolated_backward(layer, bottoms, gen, clock,
                                    lambda: policy.math(dev))
        rows.append((layer.name, layer.lp.type, fwd_ms, bwd_ms))

    params = [getattr(net.layer_by_name(l), n)
              for l, n, _ in net.learnable_param_decls()]

    def forward():
        with torch.no_grad():
            net(feeds, generator=gen)

    def forward_backward():
        for p in params:
            p.grad = None
        _, loss = net(feeds, generator=gen)
        with policy.math(dev):
            loss.backward()

    def whole():
        fwd = clock(forward)
        if not net.loss_blobs:
            return fwd, float("nan")
        saved = [p.requires_grad for p in params]
        try:
            for p in params:
                p.requires_grad_(True)
            return fwd, clock(forward_backward)
        finally:
            for p, r in zip(params, saved):
                p.requires_grad_(r)
                p.grad = None

    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=acts) as prof:
            fwd_ms, total_ms = whole()
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"profiler trace written to {trace}")
    else:
        fwd_ms, total_ms = whole()

    batch = next((net.blob_shapes[b][0] for b in net.feed_blobs), 1)
    layer_gflops = {l.name: 2 * layer_macs_per_image(l) * batch / 1e9
                    for l in net.layers}
    print(f"{'layer':<28}{'type':<20}{'fwd ms':>12}{'bwd ms':>12}"
          f"{'GFLOPs':>10}  (isolated)")
    for name, tname, fms, bms in rows:
        bs = f"{bms:.3f}" if bms == bms else "-"
        gf = layer_gflops.get(name, 0.0)
        gfs = f"{gf:.2f}" if gf else "-"
        print(f"{name:<28}{tname:<20}{fms:>12.3f}{bs:>12}{gfs:>10}")
    print(f"\nwhole-net forward: {fwd_ms:.3f} ms")
    print(f"whole-net forward+backward: {total_ms:.3f} ms")
    print(f"sum of isolated per-layer fwd: {sum(r[2] for r in rows):.3f} ms")
    fwd_gflops = 2 * net_macs_per_image(net) * batch / 1e9
    train_gflops = train_flops_per_image(net) * batch / 1e9
    print(f"model FLOPs: fwd {fwd_gflops:.2f} GFLOPs/batch (batch {batch}); "
          f"fwd+bwd {train_gflops:.2f}")
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak = mfu_peak(card, precision,
                    forward_bf16=policy.forward == torch.bfloat16)
    achieved = train_gflops / total_ms if total_ms == total_ms and \
        total_ms > 0 else None  # GFLOP / ms = TFLOP/s
    mfu = achieved * 1e12 / peak[0] if (achieved and peak) else None
    line = f"achieved: fwd {fwd_gflops / fwd_ms:.2f} TFLOP/s"
    if achieved is not None:
        line += f", fwd+bwd {achieved:.2f} TFLOP/s"
    if mfu is not None:
        line += (f"; MFU {mfu:.1%} of the {card} {peak[1]} peak "
                 f"{peak[0] / 1e12:.1f} TFLOP/s")
    else:
        line += f"; MFU not measured (no peak rate for {card})"
    print(line)
    peak_mib = None
    if dev.type == "cuda":
        peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
        print(f"peak memory: {peak_mib:.1f} MiB "
              "(torch.cuda.max_memory_allocated)")
    return {
        "model": args.model, "phase": args.phase, "batch": batch,
        "device": str(dev), "card": card, "iterations": clock.iters,
        "layers": [{"name": n, "type": t, "fwd_ms": f,
                    "bwd_ms": b if b == b else None}
                   for n, t, f, b in rows],
        "forward_ms": fwd_ms,
        "forward_backward_ms": total_ms if total_ms == total_ms else None,
        "fwd_gflops": fwd_gflops, "train_gflops": train_gflops,
        "tflops": achieved, "mfu": mfu,
        "peak_rate": None if peak is None else {"name": peak[1],
                                                "flops": peak[0]},
        "peak_mem_MiB": peak_mib,
    }


def cmd_time(args) -> int:
    try:
        summary = time_net(args)
    except (ValueError, NotImplementedError) as e:
        log.error("%s", e)
        return 1
    print(json.dumps({"time": summary}))
    return 0


def cmd_device_query(args) -> int:
    from . import device_query
    device_query.print_devices(device_query.query())
    return 0


def cmd_serve(args) -> int:
    """Load the deploy net into a ServingEngine — weights on the device,
    every padded batch bucket built — and serve it over HTTP (or run the
    smoke over HTTP). With `-replicas N` this process is the fleet's
    router and supervisor instead (`_serve_fleet`)."""
    from ..proto.config import ServingParameter
    if not args.model:
        log.error("serve requires -model (a deploy prototxt)")
        return 1
    sp = ServingParameter()
    if args.serve_window_ms >= 0:
        sp.serve_window_ms = args.serve_window_ms
    if args.serve_buckets:
        sp.serve_buckets = args.serve_buckets
    if args.serve_hbm_mb >= 0:
        sp.serve_hbm_mb = args.serve_hbm_mb
    if args.serve_dtype:
        sp.serve_dtype = args.serve_dtype
    if args.serve_queue_limit >= 0:
        sp.serve_queue_limit = args.serve_queue_limit
    if args.serve_deadline_ms >= 0:
        sp.serve_deadline_ms = args.serve_deadline_ms
    if args.serve_stall_s >= 0:
        sp.serve_stall_s = args.serve_stall_s
    if args.serve_decoded_cache_mb >= 0:
        sp.serve_decoded_cache_mb = args.serve_decoded_cache_mb
    if args.serve_replicas >= 0:
        sp.serve_replicas = args.serve_replicas
    if args.serve_retry_budget >= 0:
        sp.serve_retry_budget = args.serve_retry_budget
    if args.replica_deadline >= 0:
        sp.replica_deadline = args.replica_deadline
    _apply_unported(args, sp)
    # fleet mode: N replica processes behind the typed-retry router; this
    # process routes and supervises and builds no engine
    if sp.serve_replicas >= 1 and args.replica_id < 0:
        from ..serving.engine import UNPORTED_FIELDS
        from ..proto.config import refuse_unported
        try:  # what a replica would refuse, refused before any spawn
            refuse_unported(sp, UNPORTED_FIELDS, "serving")
        except NotImplementedError as e:
            log.error("%s", e)
            return 1
        return _serve_fleet(args, sp)
    from ..serving import ServingEngine
    from ..serving.http_front import make_server
    # a fleet replica journals to <model>.rK.serve.run.json, so that its
    # siblings do not overwrite its record; the run journal otherwise
    # lies next to the deploy prototxt
    journal = os.path.splitext(args.model)[0]
    replica = args.replica_id >= 0 and bool(args.fleet_dir)
    if replica:
        journal += f".r{args.replica_id}"
    try:
        engine = ServingEngine(sp, device=args.device, journal=journal)
    except (ValueError, NotImplementedError) as e:
        log.error("%s", e)
        return 1
    beat = None
    if replica:
        # this process is fleet replica K: heartbeats let the supervisor
        # mourn a silent death, and the admin route takes swaps
        from ..serving.fleet import ReplicaBeat
        beat = ReplicaBeat(args.fleet_dir, args.replica_id,
                           deadline=sp.replica_deadline)
        beat.start()
    try:
        engine.load_model("default", args.model, args.weights or None)
        srv = make_server(engine, "default", labels=args.labels or None,
                          image_root=args.image_root or None,
                          port=args.port if not args.smoke else 0,
                          admin=replica)
    except BaseException:
        if beat is not None:
            beat.stop()
        engine.close()
        raise
    watcher = None
    if args.serve_watch:
        from ..serving.watch import SnapshotWatcher
        watcher = SnapshotWatcher(engine, "default", args.serve_watch)
        if args.smoke:
            watcher.check_once()  # the smoke's traffic meets the swap
        watcher.start()
    if args.smoke:
        try:
            return _serve_smoke(args, engine, srv)
        finally:
            if watcher is not None:
                watcher.stop()
            if beat is not None:
                beat.stop()
            srv.shutdown()
            srv.server_close()
            engine.close()
    host, port = srv.server_address[:2]
    log.info("serving on http://%s:%s (model %s, buckets %s, %s, window "
             "%.1f ms)", host, port, args.model,
             engine.model("default").fwd.ladder, engine.serve_dtype,
             engine.window_ms)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # the watcher stops before the engine: no swap into a closing one
        if watcher is not None:
            watcher.stop()
        if beat is not None:
            beat.stop()
        srv.server_close()
        # graceful: stop accepting, flush the window, resolve every
        # in-flight future, then close
        engine.shutdown()
    return 0


def _serve_fleet(args, sp) -> int:
    """`serve -replicas N`: spawn N replica processes (each a full `cli
    serve` with its own engine, warming by capture), supervise them by
    heartbeat, and mount the typed-retry router as the public HTTP
    front. `-watch` tails snapshots router-side, so each verified
    snapshot canaries on one replica before rolling fleet-wide."""
    from ..serving.fleet import FleetSupervisor, make_router_server
    fleet_dir = args.fleet_dir or os.path.splitext(args.model)[0] + "_fleet"
    sup = FleetSupervisor(args.model, args.weights or "",
                          sp.serve_replicas, fleet_dir, serving_param=sp,
                          device=args.device)
    log.info("fleet: spawning %d replicas under %s (heartbeat deadline "
             "%.1fs, retry budget %d)", sp.serve_replicas, fleet_dir,
             sup.deadline, sup.router.retry_budget)
    try:
        sup.start()
    except RuntimeError as e:
        log.error("%s", e)
        return 1
    watcher = None
    srv = None
    try:
        if args.serve_watch:
            from ..serving.watch import SnapshotWatcher
            watcher = SnapshotWatcher(sup.router, "default",
                                      args.serve_watch)
            watcher.start()
        srv = make_router_server(sup.router,
                                 port=args.port if not args.smoke else 0)
        if args.smoke:
            return _fleet_smoke(args, sup, srv)
        host, port = srv.server_address[:2]
        log.info("fleet router serving on http://%s:%s (%d replicas)",
                 host, port, sp.serve_replicas)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0
    finally:
        if watcher is not None:
            watcher.stop()
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        sup.stop()


def _fleet_smoke(args, sup, srv) -> int:
    """`serve -replicas N -smoke M`: M seeded uploads through the router's
    HTTP front from 4 client threads, then the checks: every request
    resolved (200, or a typed failure), traffic spread over the replicas
    (M >= 8), every replica reachable and ready with no bucket built
    after its warm (`compile_count == warmed_buckets + recaptures`), and
    no CUDA context in this process."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/classify"
    with ThreadPoolExecutor(max_workers=4) as ex:
        answers = list(ex.map(lambda d: post_image(url, d),
                              smoke_uploads(args.smoke, 32, 32)))
    stats = sup.router.stats()
    torch = sys.modules.get("torch")
    stats["router_cuda_initialized"] = bool(
        torch is not None and torch.cuda.is_initialized())
    print(json.dumps({"serve_fleet_smoke": stats}))
    ok_n = sum(1 for code, _ in answers if code == 200)
    untyped = [(code, doc) for code, doc in answers
               if code != 200 and not doc.get("kind")]
    if untyped:
        log.error("fleet smoke: %d untyped failures, e.g. %s",
                  len(untyped), untyped[0])
        return 1
    for rid, doc in stats["replicas"].items():
        if "error" in doc:
            log.error("fleet smoke: replica %s unreachable: %s", rid,
                      doc["error"])
            return 1
        if doc.get("compile_count") != doc.get("warmed_buckets", 0) \
                + doc.get("recaptures", 0):
            log.error("fleet smoke: replica %s built a bucket after its "
                      "warm: %s", rid, doc)
            return 1
    spread = sum(1 for doc in stats["replicas"].values()
                 if doc.get("requests", 0) > 0)
    if ok_n == 0 or (args.smoke >= 8 and spread < 2
                     and stats["fleet"]["replicas"] > 1):
        log.error("fleet smoke: no spread (%d ok, %d replicas served)",
                  ok_n, spread)
        return 1
    if not sup.router.ready()[0]:
        log.error("fleet smoke: the fleet is not ready after the smoke")
        return 1
    if stats["router_cuda_initialized"]:
        log.error("fleet smoke: the router process created a CUDA context")
        return 1
    return 0


def smoke_uploads(n: int, h: int, w: int, seed: int = 0) -> list[bytes]:
    """N seeded uploads at (h, w): PNG and JPEG (quality 90) in turn."""
    import io

    from PIL import Image
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        buf = io.BytesIO()
        img = Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8))
        if i % 2:
            img.save(buf, format="JPEG", quality=90)
        else:
            img.save(buf, format="PNG")
        out.append(buf.getvalue())
    return out


def post_image(url: str, data: bytes, timeout: float = 120.0
               ) -> tuple[int, dict]:
    """POST one upload to `url`; (status, JSON body) for success and
    typed failure alike."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/octet-stream"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _serve_smoke(args, engine, srv) -> int:
    """`serve -smoke N`: N seeded uploads over real HTTP from 4 client
    threads in mixed bursts (a net that takes no 3-channel image gets its
    rows through the engine instead), then the telemetry and the checks:
    every request answered 200, every request recorded, and no bucket
    built after warm-up."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    model = engine.model("default")
    shape = model.fwd.input_shape()
    warmed = engine.compile_count
    url = f"http://127.0.0.1:{srv.server_address[1]}/classify"
    rng = np.random.RandomState(0)
    sizes = []
    left = args.smoke
    while left > 0:
        sizes.append(min(int(rng.randint(1, model.fwd.ladder[-1] + 1)),
                         left))
        left -= sizes[-1]
    bad = []
    if len(shape) == 4 and shape[1] == 3:
        uploads = smoke_uploads(args.smoke, shape[2], shape[3])
        bursts, start = [], 0
        for b in sizes:
            bursts.append(uploads[start:start + b])
            start += b

        def burst(items):
            with ThreadPoolExecutor(max_workers=len(items)) as ex:
                return list(ex.map(lambda d: post_image(url, d), items))

        with ThreadPoolExecutor(max_workers=4) as ex:
            for answers in ex.map(burst, bursts):
                bad += [a for a in answers if a[0] != 200
                        or not a[1].get("predictions")]
    else:
        for b in sizes:
            rows = engine.classify("default", [
                rng.rand(*shape[1:]).astype(np.float32) for _ in range(b)],
                preprocess=False)
            if not np.all(np.isfinite(rows)):
                bad.append((0, {"error": "non-finite scores"}))
    engine.drain()
    stats = engine.stats()
    stats["post_warmup_compiles"] = engine.compile_count - warmed \
        - engine.recaptures
    ing = stats["ingest"]
    stats["native_ingest_engaged"] = bool(
        ing["decode_plane"]["native_records"] > 0 and ing["fused_rows"] > 0)
    print(json.dumps({"serve_smoke": stats}))
    if bad:
        log.error("serve smoke: %d of %d requests failed, e.g. %s",
                  len(bad), args.smoke, bad[0])
        return 1
    if stats["requests"] != args.smoke:
        log.error("serve smoke: %d of %d requests recorded",
                  stats["requests"], args.smoke)
        return 1
    if args.require_native_ingest and not stats["native_ingest_engaged"]:
        log.error("serve smoke: native ingest did not engage (native "
                  "decodes %d, fused rows %d)",
                  ing["decode_plane"]["native_records"], ing["fused_rows"])
        return 1
    ready, doc = engine.ready()
    if stats["post_warmup_compiles"] != 0 or not ready:
        log.error("serve smoke: a bucket was built after warm-up (%d; "
                  "readyz %s)", stats["post_warmup_compiles"], doc)
        return 1
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    return _parser().parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = parse_args(argv)
    # the supervisor hands its children this argv
    args._argv = list(argv) if argv is not None else sys.argv[1:]
    if _refuse_unported_flags(args):
        return 1
    return {"train": cmd_train, "test": cmd_test, "time": cmd_time,
            "device_query": cmd_device_query,
            "serve": cmd_serve}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
