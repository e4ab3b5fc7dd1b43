"""Inference engine — bucketed, device-resident model zoo.

Reference: python/caffe/classifier.py and examples/web_demo/app.py run
inference one padded batch at a time; the JAX package's serving plane
(caffe_mpi_tpu/serving/engine.py) turns a deploy NetParameter into one
AOT-compiled program per padded batch bucket and keeps the weights on the
device across requests, under an HBM budget with LRU spill.

The port keeps that shape on the card. A deploy net is built once per
bucket of a fixed ladder (1, 4, ..., the declared batch), every bucket net
sharing one set of `nn.Parameter`s and state buffers. At load each bucket
runs one eager forward (cuDNN's plan choice, the kernels' first launch),
then its forward is captured into a CUDA graph with a static input and a
static output on the engine's serving stream: the counterpart of the JAX
package's `compile_bucket`, counted by `CompileCounter`
(`compile_count == warmed_buckets + recaptures` is the steady-state
invariant `/readyz` holds). A dispatch copies the padded batch into the
static input and replays the graph; the scores are copied device->host on
the same stream into pinned memory, and an event recorded after the copy
orders the harvest's read behind it. On the CPU there is no graph: a warm
is an eager forward, counted the same, and a dispatch runs the forward.

The pycaffe Classifier and Detector (classifier.py) run their batches
through a `BucketedForward` of their own (`forward`): with `full_env`
every blob is a static output of a bucket's graph (`last_env` after a
forward), and `params_from` makes the bucket nets hold the pycaffe Net's
tensors. A net with a layer that runs on the host (`Layer.host_step`, a
Python layer) is not captured: its buckets run eagerly on the card, as
the JAX engine compiles the host callback into its program.

`serve_dtype: bf16` builds every bucket net with `Net(...,
precision="bf16")`; the output blob is cast back to float32 inside the
graph, so callers always get float32 rows. BatchNorm's statistics are
float32 buffers whatever the compute type.

Residency (`serve_hbm_mb`): each model keeps a host master copy of its
parameters and state. A spill frees the device storage of every tensor
(the storage is resized to 0; shapes stay) and drops the model's graphs,
which hold its old device addresses; the next dispatch uploads the master
copy and recaptures the graphs, counted apart as `recaptures`. A hot swap
(`swap_weights`) instead copies the new weights INTO the existing tensors,
so the graphs stay valid and no capture happens.

Lock order (the JAX package's serving/locks.py LOCK_ORDER):
`InferenceModel._upload_lock` -> `ServingEngine._lock`, and
`Batcher._cv` -> `ServingEngine._lock`; `ServingEngine._lock` is never held
while waiting for an upload lock (the LRU only try-acquires a victim's).
`_upload_lock` -> `BucketedForward._run_lock` (an upload recaptures under
the run lock); a swap takes the run lock alone, after pinning the model.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from collections import OrderedDict
from contextlib import nullcontext

import numpy as np
import torch

from .. import caffe_io
from ..core.device import resolve_device
from ..net import Net
from ..proto.config import NetParameter, ServingParameter, refuse_unported
from ..proto.upgrade import normalize_net
from ..utils.resilience import FAULTS, NULL_SECTION
from .errors import DeadlineError, EngineUnhealthyError, SwapError
from .plan import (bucket_for, declared_batch, plan_admission, plan_ladder,
                   plan_model, rewrite_batch)

log = logging.getLogger(__name__)

# ServingParameter fields that the JAX serving path honours and the port
# does not yet, each with the ROADMAP.md section 1 item that will port it
UNPORTED_FIELDS = (
    ("serve_program_bank", 5), ("serve_replicas", 5),
    ("serve_retry_budget", 5), ("replica_deadline", 5),
)
SERVE_DTYPES = ("", "f32", "bf16")  # the JAX engine's; "" is f32


class CompileCounter:
    """Counts bucket builds: CUDA graph captures on the card, warm eager
    forwards on the CPU. `recaptures` counts the captures made again after
    a spill; steady-state serving moves neither."""

    def __init__(self):
        self.count = 0
        self.recaptures = 0
        self._lock = threading.Lock()

    def bump(self, recapture: bool = False) -> None:
        with self._lock:
            self.count += 1
            self.recaptures += int(recapture)


class _BucketGraph:
    """One bucket's captured forward: the graph, its static input and
    output, and each launch counter's launches a replay."""

    def __init__(self, graph, static_in, static_out, deltas):
        self.graph, self.static_in, self.static_out, self.deltas = (
            graph, static_in, static_out, deltas)


def _device_probe(device: torch.device, timeout: float) -> bool:
    """One tiny device round trip in a side thread, bounded by `timeout`:
    True iff the device answered in time (a hung call leaves the thread
    behind, bounded, while the caller returns False)."""
    done = threading.Event()
    ok: list[bool] = []

    def work():
        try:
            x = torch.ones(8, device=device)
            (x + 1.0).cpu()
            ok.append(True)
        except Exception:  # noqa: BLE001 — any failure = not recovered
            pass
        finally:
            done.set()

    threading.Thread(target=work, daemon=True,
                     name="serve-device-probe").start()
    return done.wait(timeout) and bool(ok)


class BucketedForward:
    """Padded static-batch forward over a bucket ladder.

    One deploy NetParameter, one `Net` per bucket size (the Input batch dim
    rewritten per bucket). Layer params and state (BatchNorm's running
    statistics) are shape-identical across buckets, so every bucket net
    holds the very `nn.Parameter`s and buffers of the first one. On the
    card each bucket's forward is a CUDA graph on `stream`.
    """

    def __init__(self, net_param: NetParameter, *, ladder=None,
                 max_batch: int = 0, device: str | torch.device = "cuda",
                 dtype: str = "f32", counter: CompileCounter | None = None,
                 stream=None, out_blob: str | None = None,
                 model_dir: str = "", full_env: bool = False,
                 params_from: Net | None = None):
        """out_blob: the blob a forward returns (default: the net's last
        top that no layer consumes). model_dir: the base of the layers'
        file paths. full_env: a bucket's forward returns every blob (the
        graph's static outputs), kept as `last_env` by `forward` (the
        pycaffe surface, classifier.py). params_from: a Net whose params
        and state buffers every bucket net holds (by default the first
        bucket net's)."""
        if dtype not in SERVE_DTYPES:
            raise ValueError(f"unknown serve_dtype {dtype!r} "
                             "(expected 'f32' or 'bf16')")
        self._precision = "" if dtype in ("", "f32") else dtype
        self.dtype = dtype or "f32"
        self._base = normalize_net(copy.deepcopy(net_param))
        self.device = resolve_device(device)
        self.max_batch = max_batch or declared_batch(self._base)
        self.ladder = plan_ladder(self.max_batch, ladder)
        self.counter = counter or CompileCounter()
        self.graphs_on = self.device.type == "cuda"
        self.stream = stream
        if self.graphs_on and self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        self._model_dir = model_dir
        self._full_env = full_env
        self._owner = params_from
        self._capturable: bool | None = None
        # the blobs of the last bucket `forward` ran (full_env only)
        self.last_env: dict[str, torch.Tensor] | None = None
        self._nets: dict[int, Net] = {}
        self._graphs: dict[int, _BucketGraph] = {}
        self._out_blob = out_blob
        self._lock = threading.Lock()       # builds the bucket nets
        self._run_lock = threading.RLock()  # the static buffers, a run
        self.graph_replays = 0
        # per-bucket warm time (ms), surfaced via engine.stats()
        self.warm_events: list[dict] = []

    def net_for(self, bucket: int) -> Net:
        with self._lock:
            net = self._nets.get(bucket)
            if net is not None:
                return net
            net = Net(rewrite_batch(self._base, bucket), phase="TEST",
                      device=self.device, precision=self._precision,
                      model_dir=self._model_dir)
            if len(net.feed_blobs) != 1:
                raise ValueError(
                    f"serving needs exactly one input blob, deploy net "
                    f"declares {net.feed_blobs}")
            owner = self._owner
            if owner is None and self._nets:
                owner = next(iter(self._nets.values()))
            if owner is not None:
                for src, dst in zip(owner.layers, net.layers):
                    for name in (*src.decls, *src.state_shapes):
                        setattr(dst, name, getattr(src, name))
            self._nets[bucket] = net
            return net

    @property
    def net(self) -> Net:
        """The net that owns the parameters (any bucket's would do)."""
        return self.net_for(self.ladder[0])

    def out_blob(self) -> str:
        """The net's last top that no layer consumes."""
        if self._out_blob is None:
            net = self.net
            consumed = {b for l in net.layers for b in l.lp.bottom}
            outs = [t for l in net.layers for t in l.lp.top
                    if t not in consumed]
            self._out_blob = outs[-1]
        return self._out_blob

    def input_blob(self) -> str:
        return self.net.feed_blobs[0]

    def input_shape(self, bucket: int | None = None) -> tuple:
        net = self.net_for(bucket or self.ladder[0])
        return net.blob_shapes[net.feed_blobs[0]]

    def _stream_ctx(self):
        return torch.cuda.stream(self.stream) if self.graphs_on \
            else nullcontext()

    def _eager(self, bucket: int, x: torch.Tensor):
        """The bucket net's forward: the output blob as float32, or under
        full_env every blob, the output blob as float32."""
        env, _ = self.net_for(bucket)({self.input_blob(): x})
        out = env[self.out_blob()].float()
        if not self._full_env:
            return out
        env = dict(env)
        env[self.out_blob()] = out
        return env

    def capturable(self) -> bool:
        """False where a layer runs on the host (`Layer.host_step`, a
        Python layer): such a bucket runs eagerly on the card too, as the
        JAX engine compiles its host callback into the program."""
        if self._capturable is None:
            self._capturable = not any(l.host_step for l in self.net.layers)
        return self._capturable

    def graph_bytes(self) -> int:
        """Device bytes of the captured graphs' static inputs and outputs
        (every blob under full_env)."""
        total = 0
        for g in self._graphs.values():
            outs = g.static_out.values() if isinstance(g.static_out, dict) \
                else [g.static_out]
            seen = {id(g.static_in)}
            total += g.static_in.numel() * g.static_in.element_size()
            for t in outs:
                if id(t) not in seen:
                    seen.add(id(t))
                    total += t.numel() * t.element_size()
        return total

    # -- graphs ---------------------------------------------------------
    @torch.inference_mode()
    def build_bucket(self, bucket: int, recapture: bool = False) -> None:
        """One eager forward of `bucket` (first launches, cuDNN's plan),
        then, on the card, its capture into a CUDA graph. Counted once on
        `counter` either way. A capture that fails raises."""
        from ..ops import launch_counters
        shape = self.input_shape(bucket)
        with self._run_lock, self._stream_ctx():
            static_in = torch.zeros(shape, device=self.device)
            self._eager(bucket, static_in)
            if not self.graphs_on or not self.capturable():
                self.counter.bump(recapture)
                return
            self.stream.synchronize()
            counters = launch_counters()
            before = {c: c.launches for c in counters}
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                static_out = self._eager(bucket, static_in)
            deltas = {}
            for c in counters:
                if c.launches != before[c]:
                    deltas[c] = c.launches - before[c]
                    c.launches = before[c]
            self._graphs[bucket] = _BucketGraph(graph, static_in,
                                                static_out, deltas)
            self.counter.bump(recapture)

    def warm(self) -> int:
        """Build every ladder bucket ahead of traffic; returns the number
        of warmed buckets (== len(ladder))."""
        for b in self.ladder:
            t0 = time.perf_counter()
            self.build_bucket(b)
            self.warm_events.append({
                "bucket": b, "source": "capture" if self.graphs_on
                else "eager",
                "ms": round((time.perf_counter() - t0) * 1e3, 3)})
        return len(self.ladder)

    def drop_graphs(self) -> list[int]:
        """Forget every captured graph (their device addresses die with a
        spill); returns the buckets that had one."""
        with self._run_lock:
            buckets = sorted(self._graphs)
            self._graphs.clear()
        return buckets

    # -- dispatch -------------------------------------------------------
    def _run(self, batch: np.ndarray, eager: bool = False) -> torch.Tensor:
        """The bucket's output on the device (the graph's static output on
        the card: valid until this bucket's next replay). The caller holds
        _run_lock inside the stream context and inference mode."""
        bucket = int(batch.shape[0])
        if bucket not in self.ladder:
            raise ValueError(f"batch of {bucket} is not a ladder bucket "
                             f"{self.ladder}")
        x = torch.from_numpy(np.ascontiguousarray(batch, np.float32))
        if self.graphs_on:
            x = x.pin_memory()
        if eager or not self.graphs_on or not self.capturable():
            return self._eager(bucket, x.to(self.device, non_blocking=True))
        g = self._graphs.get(bucket)
        if g is None:
            # a bucket used before warm(): built now, and counted, so the
            # readiness invariant shows it
            self.build_bucket(bucket)
            g = self._graphs[bucket]
        g.static_in.copy_(x, non_blocking=True)
        g.graph.replay()
        for counter, n in g.deltas.items():
            counter.launches += n
        self.graph_replays += 1
        return g.static_out

    @torch.inference_mode()
    def run_bucket(self, batch: np.ndarray, eager: bool = False
                   ) -> torch.Tensor:
        """Run one padded bucket; returns the output blob as a float32
        tensor on the device, a copy of its own. batch.shape[0] must be a
        ladder bucket. eager=True runs the bucket net's forward instead of
        its graph (the graph's yardstick)."""
        with self._run_lock, self._stream_ctx():
            out = self._run(batch, eager)
            if isinstance(out, dict):
                return {k: v.clone() for k, v in out.items()}
            return out.clone()

    @torch.inference_mode()
    def run_bucket_to_host(self, batch: np.ndarray):
        """The dispatcher's path: run one padded bucket and start the
        device->host copy of its scores on the serving stream before the
        bucket can run again; returns (host tensor, event to wait on —
        None on the CPU)."""
        with self._run_lock, self._stream_ctx():
            return self.to_host_async(self._run(batch))

    def to_host_async(self, out: torch.Tensor):
        """Start the device->host copy of `out` on the current stream;
        returns (host tensor, event to wait on — None on the CPU)."""
        if out.device.type != "cuda":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(out.device))
        return host, done

    def to_host(self, out: torch.Tensor) -> np.ndarray:
        with self._stream_ctx():
            host, done = self.to_host_async(out)
        if done is not None:
            done.synchronize()
        return host.numpy()

    @staticmethod
    def pad(chunk: np.ndarray, bucket: int) -> np.ndarray:
        if len(chunk) == bucket:
            return chunk
        pad = np.zeros((bucket - len(chunk), *chunk.shape[1:]), chunk.dtype)
        return np.concatenate([chunk, pad])

    def forward(self, data: np.ndarray) -> np.ndarray:
        """Synchronous padded-bucket forward over N preprocessed inputs
        (the JAX `BucketedForward.forward`): greedy max-bucket chunks, the
        tail padded to its smallest bucket; returns the output blob's
        rows, float32. Under full_env, `last_env` holds every blob of the
        last bucket run (at that bucket's batch)."""
        data = np.asarray(data, np.float32)
        preds = []
        start = 0
        while start < len(data):
            take = min(len(data) - start, self.ladder[-1])
            padded = self.pad(data[start:start + take],
                              bucket_for(take, self.ladder))
            out = self.run_bucket(padded)
            if self._full_env:
                self.last_env = out
                out = out[self.out_blob()]
            preds.append(self.to_host(out)[:take])
            start += take
        return np.concatenate(preds)


class InferenceModel:
    """One servable model: deploy prototxt -> host master weights +
    bucket nets (and their graphs) + preprocessing (classifier.py
    Transformer conventions), its device residency managed by the engine.

    `model_file` is a deploy prototxt path or an already parsed
    NetParameter. The weights are drawn from `torch.Generator(seed)` (or
    loaded from `weights`)."""

    def __init__(self, name: str, model_file: str | NetParameter,
                 weights: str | None = None,
                 *, ladder=None, max_batch: int = 0, mean=None,
                 input_scale=None, raw_scale=None, channel_swap=None,
                 image_dims=None, seed: int = 0, dtype: str = "f32",
                 counter: CompileCounter | None = None, stream=None,
                 device: str | torch.device = "cuda"):
        self.name = name
        param = model_file if isinstance(model_file, NetParameter) \
            else NetParameter.from_file(model_file)
        self.fwd = BucketedForward(param, ladder=ladder, max_batch=max_batch,
                                   device=device, dtype=dtype,
                                   counter=counter, stream=stream)
        net = self.fwd.net
        net.init(seed)
        if weights:
            from .. import io as _io
            net.import_weights(_io.load_weights(weights))
        # every distinct device tensor (params, then state buffers), keyed
        # as Net.import_weights(into=) keys them
        self._tensors: dict[tuple[str, str], torch.Tensor] = {}
        seen = set()
        for layer in net.layers:
            for attr in (*layer.decls, *layer.state_shapes):
                t = getattr(layer, attr)
                if id(t) not in seen:
                    seen.add(id(t))
                    self._tensors[(layer.name, attr)] = t
        # host master copy: the spill target and the upload source
        self.host = self._host_copy()
        self.param_bytes = sum(t.numel() * t.element_size()
                               for t in self._tensors.values())
        self._resident = True
        self._upload_lock = threading.Lock()
        self._recapture: list[int] = []
        self.was_spilled = False
        # dispatches in flight on this model's device tensors (the
        # engine's _lock guards it): the LRU never spills such a model
        self.in_flight = 0

        in_shape = self.fwd.input_shape()
        in_blob = self.fwd.input_blob()
        self.crop_dims = np.array(in_shape[2:]) if len(in_shape) == 4 \
            else None
        self.image_dims = np.array(image_dims) if image_dims is not None \
            else self.crop_dims
        self.transformer = caffe_io.Transformer.for_input(
            in_blob, in_shape,
            transpose=(2, 0, 1) if len(in_shape) == 4 else None,
            mean=mean, input_scale=input_scale, raw_scale=raw_scale,
            channel_swap=channel_swap)
        # the native window-preprocess spec (serving/ingest.py); None
        # keeps this model's requests on the per-request path
        from . import ingest as _ingest
        self.ingest_plan = _ingest.build_plan(self)

    def _host_copy(self) -> dict[tuple[str, str], torch.Tensor]:
        pin = self.fwd.device.type == "cuda"
        out = {}
        for key, t in self._tensors.items():
            h = t.detach().to("cpu", copy=True)
            out[key] = h.pin_memory() if pin else h
        return out

    # -- residency ------------------------------------------------------
    @property
    def resident(self) -> bool:
        return self._resident

    def _upload(self, host: dict) -> None:
        """Copy `host` into the device tensors (on the serving stream;
        returns when the copy is done)."""
        with self.fwd._stream_ctx(), torch.no_grad():
            for key, t in self._tensors.items():
                t.copy_(host[key], non_blocking=True)
        if self.fwd.graphs_on:
            self.fwd.stream.synchronize()

    def ensure_resident(self) -> None:
        """Upload the host master copy after a spill and recapture the
        graphs the spill dropped (counted as recaptures). Serialized per
        model: two racers must not upload twice."""
        with self._upload_lock:
            if self._resident:
                return
            with self.fwd._stream_ctx():
                for key, t in self._tensors.items():
                    t.untyped_storage().resize_(
                        self.host[key].numel() * t.element_size())
            self._upload(self.host)
            self._resident = True
            buckets, self._recapture = self._recapture, []
            for b in buckets:
                self.fwd.build_bucket(b, recapture=True)

    def release_device(self) -> None:
        """Free the device storage of every tensor and drop the graphs;
        the host master copy survives. The caller makes sure no dispatch
        is in flight on this model."""
        self._recapture = sorted(set(self._recapture)
                                 | set(self.fwd.drop_graphs()))
        self._resident = False
        with self.fwd._stream_ctx():
            for t in self._tensors.values():
                t.untyped_storage().resize_(0)

    def spill(self) -> None:
        """LRU spill: release the device copy."""
        self.release_device()
        self.was_spilled = True

    # -- preprocessing --------------------------------------------------
    def preprocess(self, img: np.ndarray) -> np.ndarray:
        """HWC float image -> the net's input row (resize to image_dims,
        center-crop to crop_dims, Transformer pipeline) — the
        Classifier.predict(oversample=False) recipe."""
        in_blob = self.fwd.input_blob()
        if self.crop_dims is None:
            return np.asarray(img, np.float32).reshape(
                self.fwd.input_shape()[1:])
        im = caffe_io.resize_center_crop(img, self.image_dims,
                                         self.crop_dims)
        return self.transformer.preprocess(in_blob, im)


class ServingEngine:
    """Model zoo + continuous batching + telemetry, on `device` (default:
    the card; raises without one).

    Knobs (ServingParameter): `serve_window_ms` — batching window;
    `serve_buckets` — explicit bucket ladder; `serve_dtype` — f32 or bf16
    bucket forwards; `serve_hbm_mb` — device budget for resident weights
    (0 = unlimited), enforced by LRU spill; `serve_queue_limit` — bounded
    backlog, over-limit submits shed with a typed ShedError (0 =
    unbounded); `serve_deadline_ms` — per-request dispatch deadline
    (DeadlineError at window close); `serve_stall_s` — the dispatch stall
    breaker (a device call past it fails the in-flight futures, journals,
    and flips the engine unhealthy so requests shed until a recovery
    probe succeeds); `serve_decoded_cache_mb` — the decoded-request cache.
    The fields in `UNPORTED_FIELDS` raise NotImplementedError at any value
    but their default, before anything is built; an unknown `serve_dtype`
    raises ValueError, as the JAX engine does.

    `journal` names a prefix for the serving run journal
    (`<journal>.serve.run.json`: breaker trips, swaps, swap rejections,
    shutdown); None journals nothing.
    """

    def __init__(self, serving_param: ServingParameter | None = None, *,
                 window_ms: float | None = None, hbm_mb: float | None = None,
                 buckets=None, queue_limit: int | None = None,
                 deadline_ms: float | None = None,
                 stall_s: float | None = None, journal: str | None = None,
                 decoded_cache_mb: float | None = None,
                 start: bool = True, device: str | torch.device = "cuda"):
        sp = serving_param or ServingParameter()
        self.serve_dtype = str(sp.serve_dtype or "f32")
        if self.serve_dtype not in ("f32", "bf16"):
            raise ValueError(f"unknown serve_dtype {sp.serve_dtype!r} "
                             "(expected 'f32' or 'bf16')")
        refuse_unported(sp, UNPORTED_FIELDS, "serving")
        self.window_ms = float(window_ms if window_ms is not None
                               else sp.serve_window_ms)
        budget_mb = float(hbm_mb if hbm_mb is not None else sp.serve_hbm_mb)
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else sp.serve_queue_limit)
        self.deadline_ms = float(deadline_ms if deadline_ms is not None
                                 else sp.serve_deadline_ms)
        self.stall_s = float(stall_s if stall_s is not None
                             else sp.serve_stall_s)
        cache_mb = float(decoded_cache_mb if decoded_cache_mb is not None
                         else sp.serve_decoded_cache_mb)
        for knob, value, off in (
                ("serve_window_ms", self.window_ms, None),
                ("serve_hbm_mb", budget_mb, "unlimited"),
                ("serve_queue_limit", self.queue_limit, "unbounded"),
                ("serve_deadline_ms", self.deadline_ms, "no deadline"),
                ("serve_stall_s", self.stall_s, "breaker off"),
                ("serve_decoded_cache_mb", cache_mb, "cache off")):
            if value < 0:
                raise ValueError(
                    f"{knob} must be >= 0{f' (0 = {off})' if off else ''}"
                    f", got {value}")
        self.device = resolve_device(device)
        self.hbm_budget = int(budget_mb * 2**20)  # 0 = unlimited
        from .ingest import RequestIngest
        self.ingest = RequestIngest(cache_mb)
        self.journal_prefix = journal
        self.ladder_spec = buckets if buckets is not None \
            else (sp.serve_buckets or None)
        self.counter = CompileCounter()
        # one serving stream: warm-ups, captures, replays, uploads and the
        # score copies are ordered on it
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self.cold_start_ms = 0.0
        self._plans: OrderedDict[str, dict] = OrderedDict()  # load order
        self._models: OrderedDict[str, InferenceModel] = OrderedDict()
        self._lock = threading.RLock()
        self.spills = 0
        self.reloads = 0
        # buckets warmed by models since replaced by load_model(same name)
        self._retired_warmed = 0
        # ladder buckets a load_model in flight will warm
        self._pending_warm = 0
        # models whose upload is in flight (resident for budget math, but
        # not spillable)
        self._uploading: set[str] = set()
        self._healthy = True
        self._closed = False
        self._breaker: dict | None = None  # last trip / recovery record
        self._watchdog = None
        self._probe_lock = threading.Lock()
        self._last_probe = 0.0
        self.stall_trips = 0
        self.unhealthy_sheds = 0
        self.swaps = 0
        self.swap_rejections = 0
        self.last_activity = time.monotonic()
        if self.stall_s > 0:
            self._arm_breaker()
        from .batcher import Batcher
        self._batcher = Batcher(self)
        if start:
            self._batcher.start()

    # -- model zoo ------------------------------------------------------
    def load_model(self, name: str, model_file: str | NetParameter,
                   weights: str | None = None, **preprocess
                   ) -> InferenceModel:
        """Load a model and build every ladder bucket (a CUDA graph each
        on the card) before it takes traffic, inside the HBM budget."""
        t_load = time.perf_counter()
        param = model_file if isinstance(model_file, NetParameter) \
            else NetParameter.from_file(model_file)
        model = InferenceModel(
            name, param, weights, ladder=self.ladder_spec,
            counter=self.counter, dtype=self.serve_dtype,
            stream=self.stream, device=self.device, **preprocess)
        # counted on the warmed side BEFORE warming, so a /stats poll
        # mid-load never reads compile_count > warmed_buckets
        with self._lock:
            self._pending_warm += len(model.fwd.ladder)
        try:
            if self.hbm_budget:
                # admitted through the LRU like a reload: the budget
                # decides what it spills before this model's upload
                model.release_device()
            self._make_resident(model)
            model.fwd.warm()
        except BaseException:
            with self._lock:
                self._pending_warm -= len(model.fwd.ladder)
                # a partial warm's builds stay in the counter
                self._retired_warmed += len(model.fwd.warm_events)
            raise
        load_ms = round((time.perf_counter() - t_load) * 1e3, 3)
        plan = plan_model(model.fwd, model.param_bytes)
        plan["load_ms"] = load_ms
        with self._lock:
            self._pending_warm -= len(model.fwd.ladder)
            old = self._models.pop(name, None)
            if old is not None:
                self._retired_warmed += len(old.fwd.ladder)
            self._models[name] = model
            self._plans[name] = plan
            self.cold_start_ms += load_ms
        log.info("serving: model %r loaded on %s in %.0f ms (buckets %s, "
                 "%s, %.1f MiB params)", name, self.device, load_ms,
                 model.fwd.ladder, self.serve_dtype,
                 model.param_bytes / 2**20)
        return model

    def model(self, name: str) -> InferenceModel:
        with self._lock:
            return self._models[name]

    @property
    def models(self) -> list[str]:
        with self._lock:
            return list(self._models)

    @property
    def compile_count(self) -> int:
        return self.counter.count

    @property
    def recaptures(self) -> int:
        return self.counter.recaptures

    @property
    def warmed_buckets(self) -> int:
        with self._lock:
            return self._retired_warmed + self._pending_warm + sum(
                len(m.fwd.ladder) for m in self._models.values())

    def _make_resident(self, model: InferenceModel, *,
                       mark_in_flight: bool = False) -> None:
        """LRU admission: spill the least-recently-used idle resident
        models that `plan_admission` names until `model` fits the budget,
        then upload it. A single model larger than the whole budget stays
        resident with a warning.
        mark_in_flight (the dispatcher, a swap) increments model.in_flight
        in the same locked section that ends the upload reservation, so
        the LRU never sees a model bound for a dispatch as spillable."""
        with self._lock:
            if self._models.get(model.name) is model:
                self._models.move_to_end(model.name)  # most recently used
            was_resident = model.resident or model.name in self._uploading
            if not was_resident and self.hbm_budget:
                # a model mid-upload, mid-dispatch or mid-swap frees
                # nothing now: it stays charged and is not a victim. Upload
                # locks are only tried, never waited for under this lock
                free, busy, busy_bytes = [], 0, 0
                for m in self._models.values():  # OrderedDict: LRU first
                    if m is model or not (m.resident
                                          or m.name in self._uploading):
                        continue
                    if m.name in self._uploading or m.in_flight > 0 \
                            or not m._upload_lock.acquire(blocking=False):
                        busy += 1
                        busy_bytes += m.param_bytes
                    else:
                        free.append(m)
                try:
                    # plan_admission reads a budget of 0 as none; 1 byte
                    # keeps "the busy models already fill it"
                    plan = plan_admission(
                        [(i, m.param_bytes) for i, m in enumerate(free)]
                        + [(len(free), model.param_bytes)],
                        max(self.hbm_budget - busy_bytes, 1))
                    for i in plan["planned_spills"]:
                        victim = free[i]
                        victim.spill()
                        self.spills += 1
                        log.info("serving: spilled %r (%.1f MiB) for %r",
                                 victim.name, victim.param_bytes / 2**20,
                                 model.name)
                finally:
                    for m in free:
                        m._upload_lock.release()
                if plan["over_budget"]:
                    if busy:
                        log.warning(
                            "serving: HBM budget transiently over-committed "
                            "admitting %r (victims mid-upload or "
                            "mid-dispatch; reclaimed at their next LRU "
                            "pass)", model.name)
                    else:
                        log.warning(
                            "serving: model %r (%.1f MiB) alone exceeds "
                            "the %.1f MiB budget; keeping it resident "
                            "anyway", model.name, model.param_bytes / 2**20,
                            self.hbm_budget / 2**20)
            if not was_resident and model.was_spilled:
                self.reloads += 1
            self._uploading.add(model.name)
        # upload OUTSIDE the engine lock: submits resolve models through
        # it while an upload (and its recaptures) runs
        try:
            model.ensure_resident()
        except BaseException:
            with self._lock:
                self._uploading.discard(model.name)
            raise
        with self._lock:
            if mark_in_flight:
                model.in_flight += 1
            self._uploading.discard(model.name)

    def note_retire(self, model: InferenceModel) -> None:
        """The dispatch marked in flight by `_make_resident(mark_in_flight=
        True)` has harvested (or failed)."""
        with self._lock:
            model.in_flight -= 1
            self.last_activity = time.monotonic()

    # -- stall breaker --------------------------------------------------
    def _arm_breaker(self) -> None:
        from ..utils.resilience import DispatchWatchdog
        self._watchdog = DispatchWatchdog(
            self.stall_s, self._on_stall, hard_exit=False)

    def dispatch_section(self, label: str):
        """Watchdog section for one device-blocking serving call (dispatch
        or harvest); a no-op when the breaker is off."""
        wd = self._watchdog
        return NULL_SECTION if wd is None else wd.section(label)

    def _on_stall(self, label: str, elapsed: float) -> None:
        """Watchdog callback: a serving device call ran past
        `serve_stall_s`. The stuck thread cannot be interrupted, but its
        futures can be failed from here: clients get a bounded
        DeadlineError while the engine flips unhealthy and sheds."""
        self._healthy = False
        self.stall_trips += 1
        self._breaker = {"state": "open", "section": label,
                         "elapsed_s": round(elapsed, 1),
                         "time": time.time()}
        log.error("serving: %s stalled %.1fs past the %.1fs breaker "
                  "deadline — failing in-flight futures, shedding new "
                  "requests until a recovery probe succeeds",
                  label, elapsed, self.stall_s)
        self._journal(f"serve_stall:{label}", elapsed_s=round(elapsed, 1),
                      stall_s=self.stall_s)
        failed = self._batcher.fail_inflight(DeadlineError(
            f"serving dispatch {label!r} stalled past "
            f"serve_stall_s={self.stall_s:g}s; engine unhealthy"))
        if failed:
            log.error("serving: failed %d in-flight request future(s) "
                      "after the stall", failed)

    def probe_recovery(self, timeout: float | None = None) -> bool:
        """Try to close the breaker: the stalled call must have retired (a
        section still open means it never returned; only a restart clears
        that) and a fresh tiny device round trip must complete within
        `timeout` (default `serve_stall_s`). On success the watchdog is
        re-armed, dead worker threads respawn, and the engine serves."""
        if self._healthy:
            return True
        with self._probe_lock:
            if self._healthy:
                return True
            if self._closed:
                return False
            self._last_probe = time.monotonic()
            wd = self._watchdog
            if wd is not None:
                still_open = wd.open_sections()
                if still_open:
                    log.warning("serving: recovery probe refused — "
                                "stalled section %r never returned",
                                still_open[0])
                    return False
            if not _device_probe(self.device, timeout if timeout is not None
                                 else max(self.stall_s, 1.0)):
                log.warning("serving: recovery probe failed; breaker "
                            "stays open")
                return False
            if wd is not None:
                wd.stop()
            self._arm_breaker()
            self._batcher.ensure_threads()
            self._breaker = {"state": "closed", "recovered": time.time(),
                             "trips": self.stall_trips}
            self._healthy = True
            log.info("serving: recovery probe succeeded; breaker closed")
            self._journal("serve_recovered", trips=self.stall_trips)
            return True

    def _probe_recovery_guarded(self) -> None:
        try:
            self.probe_recovery()
        except Exception as e:  # noqa: BLE001 — journaled, not silent
            log.exception("serving: recovery probe crashed")
            self._journal("serve_probe_crash", error=str(e))

    def _maybe_probe_async(self) -> None:
        """Start a background recovery probe at most once per breaker
        deadline, so live traffic keeps probing without stacking
        threads."""
        now = time.monotonic()
        if now - self._last_probe < max(self.stall_s, 1.0):
            return
        self._last_probe = now
        threading.Thread(target=self._probe_recovery_guarded, daemon=True,
                         name="serve-recovery-probe").start()

    def note_unhealthy_shed(self) -> None:
        with self._lock:
            self.unhealthy_sheds += 1

    @property
    def healthy(self) -> bool:
        return self._healthy

    def health(self) -> dict:
        """/healthz payload: breaker state + last-dispatch age."""
        idle = time.monotonic() - self.last_activity
        return {
            "healthy": self._healthy,
            "breaker": self._breaker or {"state": "closed", "trips": 0},
            "stall_trips": self.stall_trips,
            "last_dispatch_age_s": round(idle, 3),
            "stall_s": self.stall_s,
        }

    def ready(self) -> tuple[bool, dict]:
        """/readyz payload: ready iff the zoo is loaded and every bucket
        built (`compile_count == warmed_buckets + recaptures`: a capture
        at load for each bucket, one more for each bucket a reload after
        a spill recaptured), no load in flight, the breaker closed, and
        the engine accepting work."""
        with self._lock:
            warming = self._pending_warm > 0
            models = len(self._models)
        doc = {
            "models": models,
            "warming": warming,
            "warmed_buckets": self.warmed_buckets,
            "compile_count": self.compile_count,
            "recaptures": self.recaptures,
            "healthy": self._healthy,
            "closed": self._closed,
        }
        doc["ready"] = (models > 0 and not warming and not self._closed
                        and self._healthy
                        and doc["compile_count"]
                        == doc["warmed_buckets"] + doc["recaptures"])
        return doc["ready"], doc

    def _journal(self, reason: str, **extra) -> None:
        """Serving run journal (`<journal>.serve.run.json`). Best-effort:
        a journaling failure never takes serving down."""
        if not self.journal_prefix:
            return
        try:
            from ..utils import resilience
            resilience.write_run_manifest(
                self.journal_prefix + ".serve", reason=reason, **extra)
        except OSError:
            log.exception("serving: run journal failed (continuing)")

    # -- hot swap -------------------------------------------------------
    def swap_weights(self, name: str, weights: str, *,
                     source: str = "") -> None:
        """Live-reload `name`'s weights from `weights` without a capture:
        the new values are copied INTO the existing device tensors, whose
        addresses the graphs hold, so `compile_count` does not move.

        The canary gate copies the candidate in and replays the smallest
        bucket's graph on a synthetic batch before the swap is committed,
        with the model's dispatches held off: non-finite or wrong-shaped
        scores, or an unloadable weights file, raise SwapError and the
        previous weights are copied back from the host master, bitwise.
        `source` (the watcher's `iter_<N>`) goes into the journal."""
        model = self.model(name)  # KeyError for unknown models
        try:
            from .. import io as _io
            cand = {k: v.clone() for k, v in model.host.items()}
            model.fwd.net.import_weights(_io.load_weights(weights),
                                         into=cand)
        except Exception as e:  # noqa: BLE001 — typed for the caller
            self.note_swap_rejected(name, f"weights load failed: {e}",
                                    source=source)
            raise SwapError(
                f"hot-swap candidate {weights!r} failed to load: {e}"
            ) from e
        if FAULTS.fire("swap_canary_bad") is not None:
            # test-only: rot the candidate so the canary must catch it
            first = next(t for t in cand.values() if t.is_floating_point())
            first.view(-1)[0] = float("nan")
        if model.fwd.device.type == "cuda":
            cand = {k: v.pin_memory() for k, v in cand.items()}
        # pinned in flight: the LRU cannot spill it under the canary
        self._make_resident(model, mark_in_flight=True)
        try:
            with model.fwd._run_lock:
                model._upload(cand)
                try:
                    self._canary_gate(model)
                except SwapError as e:
                    model._upload(model.host)
                    self.note_swap_rejected(name, str(e), source=source)
                    raise
            with model._upload_lock:
                with self._lock:
                    model.host = cand
        finally:
            self.note_retire(model)
        self.swaps += 1
        log.info("serving: hot-swapped model %r from %s (%s); graphs "
                 "untouched", name, weights, source or "manual")
        self._journal("swap", model=name, weights=weights, source=source,
                      swaps=self.swaps)

    def _canary_gate(self, model: InferenceModel) -> None:
        """Run the smallest built bucket on a synthetic batch with the
        weights now in the device tensors; raises SwapError on non-finite
        or wrong-shaped scores."""
        fwd = model.fwd
        b = fwd.ladder[0]
        rng = np.random.RandomState(0)
        batch = rng.rand(b, *fwd.input_shape()[1:]).astype(np.float32)
        try:
            out = fwd.to_host(fwd.run_bucket(batch))
        except Exception as e:  # noqa: BLE001 — mismatch => rejection
            raise SwapError(f"canary forward failed: {e}") from e
        if out.shape[0] != b or out.ndim < 1:
            raise SwapError(
                f"canary scores have wrong shape {out.shape} for "
                f"bucket {b}")
        if not np.all(np.isfinite(out)):
            raise SwapError("canary scores are non-finite")

    def note_swap_rejected(self, name: str, reason: str, *,
                           source: str = "") -> None:
        """Count and journal a rejected hot-swap candidate (a corrupt
        snapshot, unloadable weights, a failed canary); the previous
        weights keep serving."""
        self.swap_rejections += 1
        log.warning("serving: hot-swap for model %r REJECTED (%s); "
                    "previous weights keep serving", name, reason)
        self._journal("swap_rejected", model=name, swap_reason=reason,
                      source=source, swap_rejections=self.swap_rejections)

    # -- request surface ------------------------------------------------
    def _shed_if_unhealthy(self) -> None:
        """Health gate of every submit surface: an open breaker sheds in
        the caller's thread (and starts a background recovery probe)
        before any decode or preprocess cost."""
        if not self._healthy:
            self._maybe_probe_async()
            self.note_unhealthy_shed()
            section = (self._breaker or {}).get("section")
            raise EngineUnhealthyError(
                "serving engine unhealthy (dispatch stall breaker open"
                f"{': ' + str(section) if section else ''}); request shed")

    def submit(self, name: str, img: np.ndarray, *, preprocess: bool = True):
        """Enqueue one image; returns a concurrent.futures.Future whose
        result is the model's score row (np.ndarray). Typed failures:
        EngineUnhealthyError when the stall breaker is open, ShedError
        when the backlog is at `serve_queue_limit`, EngineClosedError
        after shutdown/close."""
        self._shed_if_unhealthy()
        model = self.model(name)  # KeyError for unknown models
        data = model.preprocess(img) if preprocess else \
            np.asarray(img, np.float32)
        want = model.fwd.input_shape()[1:]
        if tuple(data.shape) != tuple(want):
            # reject HERE, in the caller's thread: a wrong-shaped row
            # inside a batch would fail every co-batched request
            raise ValueError(
                f"serving: request row shape {tuple(data.shape)} does "
                f"not match model {name!r} input {tuple(want)}")
        return self._batcher.submit(name, data)

    def decode_request(self, data: bytes) -> np.ndarray:
        """Decode one encoded request (HTTP upload bytes) -> (3, h, w)
        planar BGR uint8 through the decode plane's policy and counters
        and this engine's decoded cache. Raises the decoder's error for
        bytes that are no image (the HTTP front's typed 400)."""
        return self.ingest.decode(data)

    def submit_raw(self, name: str, raw: np.ndarray):
        """Enqueue one DECODED request ((3, h, w) planar BGR uint8). When
        the model's preprocessing is expressible in the native fused
        kernel, it is deferred to the batcher's window close (one
        GIL-released call a window); otherwise this is the per-request
        path."""
        self._shed_if_unhealthy()
        model = self.model(name)  # KeyError for unknown models
        from . import ingest as _ingest
        if _ingest.fused_engaged(model):
            # counted after the submit: a shed request must not count
            fut = self._batcher.submit(name, raw, raw_mode=True)
            self.ingest._count("deferred_rows")
            return fut
        from ..data.decode import to_float_image
        t0 = time.perf_counter()
        try:
            fut = self.submit(name, to_float_image(raw))
        finally:
            with self.ingest._lock:
                self.ingest.preprocess_s += time.perf_counter() - t0
        self.ingest._count("immediate_rows")
        return fut

    def submit_bytes(self, name: str, data: bytes):
        """decode_request + submit_raw in one call (the library spelling
        of the HTTP upload path). Sheds before decoding."""
        self._shed_if_unhealthy()
        return self.submit_raw(name, self.decode_request(data))

    def classify(self, name: str, imgs, *, preprocess: bool = True,
                 timeout: float | None = 600.0) -> np.ndarray:
        """Synchronous convenience: submit all, gather rows in order; the
        gather is bounded by `timeout`."""
        futures = [self.submit(name, im, preprocess=preprocess)
                   for im in imgs]
        return np.stack([f.result(timeout=timeout) for f in futures])

    def drain(self, timeout: float = 60.0) -> None:
        self._batcher.drain(timeout)

    # -- telemetry ------------------------------------------------------
    def stats(self) -> dict:
        """Serving telemetry: p50/p99 end-to-end latency, sustained img/s,
        dispatch fill, the build counters, residency, resilience and
        ingest counters, each model's plan and the residency."""
        recs = self._batcher.records()
        with self._lock:
            warm = {n: list(m.fwd.warm_events)
                    for n, m in self._models.items()}
            replays = sum(m.fwd.graph_replays for m in self._models.values())
            plans = {n: dict(p) for n, p in self._plans.items()}
            resident = [m for m in self._models.values() if m.resident]
        out = {
            "device": str(self.device),
            "serve_dtype": self.serve_dtype,
            "requests": len(recs),
            "dispatches": self._batcher.dispatch_count,
            "models": len(warm),
            "warmed_buckets": self.warmed_buckets,
            "compile_count": self.compile_count,
            "recaptures": self.recaptures,
            "graph_replays": replays,
            "warm": warm,
            "cold_start_ms": round(self.cold_start_ms, 3),
            "spills": self.spills,
            "reloads": self.reloads,
            "window_ms": self.window_ms,
            "healthy": self._healthy,
            "stall_trips": self.stall_trips,
            "shed_requests": self._batcher.shed_count,
            "unhealthy_sheds": self.unhealthy_sheds,
            "deadline_failures": self._batcher.deadline_count,
            "queue_limit": self.queue_limit,
            "max_queue_depth": self._batcher.max_queue_depth,
            "deadline_ms": self.deadline_ms,
            "stall_s": self.stall_s,
            "swaps": self.swaps,
            "swap_rejections": self.swap_rejections,
            "ingest": self.ingest.stats(),
            "plan": {
                "models": plans,
                # the engine's residency now, least recently used first
                "admission": {
                    "hbm_budget_bytes": int(self.hbm_budget),
                    "resident": [m.name for m in resident],
                    "resident_bytes": sum(m.param_bytes for m in resident),
                },
            },
        }
        if recs:
            lat = np.sort(np.array([r["total_ms"] for r in recs]))
            qms = np.array([r["queue_ms"] for r in recs])
            first = min(r["t_enqueue"] for r in recs)
            last = max(r["t_done"] for r in recs)
            fills = [n / b
                     for (_, n, b) in self._batcher.dispatch_snapshot()]
            out.update({
                "p50_ms": round(float(np.percentile(lat, 50)), 3),
                "p99_ms": round(float(np.percentile(lat, 99)), 3),
                "mean_queue_ms": round(float(qms.mean()), 3),
                "img_per_s": round(len(recs) / max(last - first, 1e-9), 1),
                "mean_bucket_fill": round(float(np.mean(fills)), 3),
            })
        return out

    def shutdown(self, timeout: float = 60.0) -> None:
        """Graceful drain: stop accepting (submits fail with
        EngineClosedError), flush the open batching window immediately,
        resolve every in-flight future, then close. `close()` cancels
        pending work instead."""
        self._mark_closed()
        self._journal("serve_shutdown", swaps=self.swaps,
                      stall_trips=self.stall_trips)
        self._batcher.shutdown(timeout)
        self._stop_breaker()

    def close(self) -> None:
        self._mark_closed()
        self._batcher.close()
        self._stop_breaker()

    def _mark_closed(self) -> None:
        """Published under _probe_lock: a recovery probe either commits
        before close proceeds or sees _closed and refuses."""
        with self._probe_lock:
            self._closed = True

    def _stop_breaker(self) -> None:
        with self._probe_lock:
            wd = self._watchdog
            self._watchdog = None
        if wd is not None:
            wd.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
