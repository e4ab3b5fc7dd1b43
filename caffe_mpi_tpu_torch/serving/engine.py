"""Inference engine — bucketed, device-resident model zoo.

Reference: python/caffe/classifier.py and examples/web_demo/app.py run
inference one padded batch at a time; the JAX package's serving plane
(caffe_mpi_tpu/serving/engine.py) turns a deploy NetParameter into one
AOT-compiled program per padded batch bucket and keeps the weights on the
device across requests.

The port keeps that shape on the card: a deploy net is built once per
bucket of a fixed ladder (1, 4, ..., the declared batch), every bucket net
sharing one set of `nn.Parameter`s and state buffers, which are placed on
the device when the model loads and never moved per request. PyTorch
compiles nothing, so the warm step runs each bucket once before traffic
(cuDNN's plan choice and kernel loading happen there) and `stats()`
reports `warmed_buckets`. Scores are copied device->host on the
dispatching stream into pinned memory, and an event recorded after the
copy orders the harvest's read behind it.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from .. import caffe_io
from ..core.device import resolve_device
from ..net import Net
from ..proto.config import NetParameter, ServingParameter, refuse_unported
from ..proto.upgrade import normalize_net
from .plan import plan_ladder

log = logging.getLogger(__name__)

# ServingParameter fields that the JAX serving path honours and the port
# does not yet, each with the ROADMAP.md section 1 item that will port it
UNPORTED_FIELDS = (
    ("serve_dtype", 5), ("serve_hbm_mb", 5), ("serve_deadline_ms", 5),
    ("serve_stall_s", 5), ("serve_decoded_cache_mb", 5),
    ("serve_program_bank", 5), ("serve_replicas", 5),
    ("serve_retry_budget", 5), ("replica_deadline", 5),
)
SERVE_DTYPES = ("", "f32", "bf16")  # the JAX engine's; "" is f32


class BucketedForward:
    """Padded static-batch forward over a bucket ladder.

    One deploy NetParameter, one `Net` per bucket size (the Input batch dim
    rewritten per bucket). Layer params and state (BatchNorm's running
    statistics) are shape-identical across buckets, so every bucket net
    holds the very `nn.Parameter`s and buffers of the first one.
    """

    def __init__(self, net_param: NetParameter, *, ladder=None,
                 device: str | torch.device = "cuda"):
        self._base = normalize_net(copy.deepcopy(net_param))
        self.device = resolve_device(device)
        self.max_batch = self._declared_batch(self._base)
        self.ladder = plan_ladder(self.max_batch, ladder)
        self._nets: dict[int, Net] = {}
        self._out_blob: str | None = None
        self._lock = threading.Lock()
        # per-bucket warm time (ms), surfaced via engine.stats()
        self.warm_events: list[dict] = []

    @staticmethod
    def _declared_batch(param: NetParameter) -> int:
        for lp in param.layer:
            if lp.type == "Input" and lp.input_param and lp.input_param.shape:
                dims = lp.input_param.shape[0].dim
                if dims:
                    return int(dims[0])
        raise ValueError("deploy net has no Input layer with a declared "
                         "shape; serving needs a deploy prototxt")

    def net_for(self, bucket: int) -> Net:
        with self._lock:
            net = self._nets.get(bucket)
            if net is not None:
                return net
            param = copy.deepcopy(self._base)
            for lp in param.layer:
                if lp.type == "Input" and lp.input_param:
                    for shape in lp.input_param.shape:
                        if shape.dim:
                            shape.dim[0] = bucket
            net = Net(param, phase="TEST", device=self.device)
            if len(net.feed_blobs) != 1:
                raise ValueError(
                    f"serving needs exactly one input blob, deploy net "
                    f"declares {net.feed_blobs}")
            if self._nets:
                owner = next(iter(self._nets.values()))
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

    def warm(self) -> int:
        """Run every ladder bucket once ahead of traffic; returns the
        number of warmed buckets (== len(ladder))."""
        for b in self.ladder:
            t0 = time.perf_counter()
            zeros = np.zeros(self.input_shape(b), np.float32)
            self.to_host(self.run_bucket(zeros))
            self.warm_events.append(
                {"bucket": b, "ms": round((time.perf_counter() - t0) * 1e3, 3)})
        return len(self.ladder)

    @torch.inference_mode()
    def run_bucket(self, batch: np.ndarray) -> torch.Tensor:
        """Dispatch one padded bucket; returns the output blob as a float32
        tensor on the device, not yet harvested. batch.shape[0] must be a
        ladder bucket."""
        bucket = int(batch.shape[0])
        if bucket not in self.ladder:
            raise ValueError(f"batch of {bucket} is not a ladder bucket "
                             f"{self.ladder}")
        net = self.net_for(bucket)
        x = torch.from_numpy(np.ascontiguousarray(batch, np.float32))
        env, _ = net({self.input_blob(): x.to(self.device)})
        return env[self.out_blob()].float()

    @staticmethod
    def to_host_async(out: torch.Tensor):
        """Start the device->host copy of `out` on the current stream;
        returns (host tensor, event to wait on — None on the CPU)."""
        if out.device.type != "cuda":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(out.device))
        return host, done

    @classmethod
    def to_host(cls, out: torch.Tensor) -> np.ndarray:
        host, done = cls.to_host_async(out)
        if done is not None:
            done.synchronize()
        return host.numpy()

    @staticmethod
    def pad(chunk: np.ndarray, bucket: int) -> np.ndarray:
        if len(chunk) == bucket:
            return chunk
        pad = np.zeros((bucket - len(chunk), *chunk.shape[1:]), chunk.dtype)
        return np.concatenate([chunk, pad])


class InferenceModel:
    """One servable model: deploy prototxt -> device-resident weights +
    bucket nets + preprocessing (classifier.py Transformer conventions).

    `model_file` is a deploy prototxt path or an already parsed
    NetParameter. The weights are drawn from `torch.Generator(seed)` (or
    loaded from `weights`) and placed on the device here, once."""

    def __init__(self, name: str, model_file: str | NetParameter,
                 weights: str | None = None,
                 *, ladder=None, mean=None, raw_scale=None,
                 channel_swap=None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.name = name
        param = model_file if isinstance(model_file, NetParameter) \
            else NetParameter.from_file(model_file)
        self.fwd = BucketedForward(param, ladder=ladder, device=device)
        net = self.fwd.net
        net.init(seed)
        if weights:
            from .. import io as _io
            net.import_weights(_io.load_weights(weights))
        self.param_bytes = sum(p.numel() * p.element_size()
                               for p in net.parameters())

        in_shape = self.fwd.input_shape()
        in_blob = self.fwd.input_blob()
        self.crop_dims = np.array(in_shape[2:]) if len(in_shape) == 4 \
            else None
        self.transformer = caffe_io.Transformer.for_input(
            in_blob, in_shape,
            transpose=(2, 0, 1) if len(in_shape) == 4 else None,
            mean=mean, raw_scale=raw_scale, channel_swap=channel_swap)

    def preprocess(self, img: np.ndarray) -> np.ndarray:
        """HWC float image -> the net's input row (resized to the input's
        spatial size if it differs, then the Transformer pipeline) — the
        Classifier.predict(oversample=False) recipe with image_dims equal
        to the crop."""
        in_blob = self.fwd.input_blob()
        if self.crop_dims is None:
            return np.asarray(img, np.float32).reshape(
                self.fwd.input_shape()[1:])
        im = caffe_io.resize_center_crop(img, self.crop_dims, self.crop_dims)
        return self.transformer.preprocess(in_blob, im)


class ServingEngine:
    """Model zoo + continuous batching + telemetry, on `device` (default:
    the card; raises without one).

    Knobs (ServingParameter): `serve_window_ms` — batching window;
    `serve_buckets` — explicit bucket ladder; `serve_queue_limit` — bounded
    backlog, over-limit submits shed with a typed ShedError (0 = unbounded).
    The fields in `UNPORTED_FIELDS` raise NotImplementedError at any value
    but their default, before anything is built; an unknown `serve_dtype`
    raises ValueError, as the JAX engine does.
    """

    def __init__(self, serving_param: ServingParameter | None = None, *,
                 window_ms: float | None = None, buckets=None,
                 queue_limit: int | None = None,
                 device: str | torch.device = "cuda"):
        sp = serving_param or ServingParameter()
        if sp.serve_dtype not in SERVE_DTYPES:
            raise ValueError(f"unknown serve_dtype {sp.serve_dtype!r} "
                             "(expected 'f32' or 'bf16')")
        refuse_unported(sp, UNPORTED_FIELDS, "serving",
                        serve_dtype=sp.serve_dtype or "f32")
        self.device = resolve_device(device)
        self.window_ms = float(window_ms if window_ms is not None
                               else sp.serve_window_ms)
        if self.window_ms < 0:
            raise ValueError(
                f"serve_window_ms must be >= 0, got {self.window_ms}")
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else sp.serve_queue_limit)
        if self.queue_limit < 0:
            raise ValueError(
                f"serve_queue_limit must be >= 0 (0 = unbounded), "
                f"got {self.queue_limit}")
        self.ladder_spec = buckets if buckets is not None \
            else (sp.serve_buckets or None)
        self.cold_start_ms = 0.0
        self._models: OrderedDict[str, InferenceModel] = OrderedDict()
        self._lock = threading.Lock()
        from .batcher import Batcher
        self._batcher = Batcher(self)
        self._batcher.start()

    # -- model zoo ------------------------------------------------------
    def load_model(self, name: str, model_file: str | NetParameter,
                   weights: str | None = None, **preprocess) -> InferenceModel:
        """Load a model onto the device and warm every ladder bucket before
        it takes traffic."""
        t_load = time.perf_counter()
        model = InferenceModel(name, model_file, weights,
                               ladder=self.ladder_spec, device=self.device,
                               **preprocess)
        model.fwd.warm()
        load_ms = round((time.perf_counter() - t_load) * 1e3, 3)
        with self._lock:
            self._models[name] = model
            self.cold_start_ms += load_ms
        log.info("serving: model %r loaded on %s in %.0f ms (buckets %s, "
                 "%.1f MiB params)", name, self.device, load_ms,
                 model.fwd.ladder, model.param_bytes / 2**20)
        return model

    def model(self, name: str) -> InferenceModel:
        with self._lock:
            return self._models[name]

    @property
    def models(self) -> list[str]:
        with self._lock:
            return list(self._models)

    @property
    def warmed_buckets(self) -> int:
        with self._lock:
            return sum(len(m.fwd.warm_events) for m in self._models.values())

    # -- request surface ------------------------------------------------
    def submit(self, name: str, img: np.ndarray, *, preprocess: bool = True):
        """Enqueue one image; returns a concurrent.futures.Future whose
        result is the model's score row (np.ndarray). Typed failures:
        ShedError when the backlog is at `serve_queue_limit`,
        EngineClosedError after shutdown/close."""
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

    def classify(self, name: str, imgs, *, preprocess: bool = True,
                 timeout: float | None = 600.0) -> np.ndarray:
        """Synchronous convenience: submit all, gather rows in order."""
        futures = [self.submit(name, im, preprocess=preprocess)
                   for im in imgs]
        return np.stack([f.result(timeout=timeout) for f in futures])

    def drain(self, timeout: float = 60.0) -> None:
        self._batcher.drain(timeout)

    # -- telemetry ------------------------------------------------------
    def stats(self) -> dict:
        """Serving telemetry: p50/p99 end-to-end latency, sustained
        img/s, dispatch fill, and the warm/shed counters."""
        recs = self._batcher.records()
        with self._lock:
            warm = {n: list(m.fwd.warm_events)
                    for n, m in self._models.items()}
        out = {
            "device": str(self.device),
            "requests": len(recs),
            "dispatches": self._batcher.dispatch_count,
            "models": len(warm),
            "warmed_buckets": sum(len(w) for w in warm.values()),
            "warm": warm,
            "cold_start_ms": round(self.cold_start_ms, 3),
            "window_ms": self.window_ms,
            "shed_requests": self._batcher.shed_count,
            "queue_limit": self.queue_limit,
            "max_queue_depth": self._batcher.max_queue_depth,
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
        self._batcher.shutdown(timeout)

    def close(self) -> None:
        self._batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
