"""Batch feeder — the host-side prefetch pipeline, and its upload to the card.

Own copy of the classic path of the JAX package's
caffe_mpi_tpu/data/feeder.py (`Feeder`, `feeder_from_layer`,
`data_shape_probe`, `ProbeShape`). Reference machinery: DataReader's
reader threads with round-robin record striping (CursorManager,
data_reader.hpp:28-53), BasePrefetchingDataLayer's transformer threads and
free/full batch queues (base_data_layer.hpp:100-159), and the GPU-side
asynchronous batch copy.

Batches are built by a thread pool ahead of the training loop, `lookahead`
batches deep (`data_param.prefetch`). The records of (iteration, slot) are
an index calculation:

    flat = it * batch * world + rank * batch + slot      (mod dataset size)

which is the reference's striping without cursors; with `shuffle`, each
epoch reads through `RandomState(seed + epoch).permutation(size)`. A
batch is a pure function of its iteration, so it is the JAX Feeder's bit
for bit: the host transform draws each record's crop and mirror from its
own Philox stream, and with the device transform the batch is the raw
uint8 stack plus the (B, 3) decisions (`device_transform.compute_aug`).

The pool has `data_param.threads` workers; when that is 0, DEFAULT_THREADS
for raw records and ENCODED_THREADS for encoded ones (the JAX package
sizes it from the host's cores and re-tunes the lookahead at run time;
that autotune, the fused native decode path and the
quarantine of corrupt records are not ported yet, ROADMAP.md §1 item 3: a
corrupt record raises).

`DeviceFeed` is the step the JAX package leaves to XLA's transfers: the
feed function a Solver calls, turning each numpy batch into tensors on
the device. On the card it copies the batch into pinned host memory and
uploads it with non_blocking copies on a side stream, batch i + 1 while
step i runs; the step's stream waits on the upload's event before it
reads the tensors. Pinned buffers are a ring, and a buffer is refilled
only after the event of its previous upload has completed.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from .datasets import Dataset, unported
from .transformer import DataTransformer

# workers of a Feeder whose data_param.threads is 0 (the prototxt default),
# by the kind of record (feed_variants.py, CaffeNet b256 on an H100). Raw
# records are Python under the GIL, which the training loop needs too:
# four or eight threads step slower than one or two, and two against one
# is not settled (over 8 mirrored pairs of 30-step windows, 3,813 against
# 3,686 img/s on average, ahead in 5 pairs, each spread over ~1,000).
# Encoded records spend their time in PIL's decode, which lets the GIL
# go: eight threads step fastest (97.0-99.7 ms against 111.5-155.0 at 4
# and 249.8-262.5 at 2).
DEFAULT_THREADS = 2
ENCODED_THREADS = 8


class Feeder:
    def __init__(self, dataset: Dataset, transformer: DataTransformer | None,
                 batch_size: int, *, rank: int = 0, world: int = 1,
                 shuffle: bool = False, seed: int = 0, threads: int = 0,
                 lookahead: int = 3,
                 top_names: tuple[str, ...] = ("data", "label"),
                 device_transform: bool = False):
        """top_names: the data layer's tops (image, then label).
        device_transform: stage raw uint8 batches and the per-record
        decisions instead of transforming on the host; must match the
        consuming Net's DataLayer.dev_transform."""
        n = len(dataset)
        if n == 0:
            raise ValueError("empty dataset")
        self.ds = dataset
        self.tf = transformer
        self.batch = batch_size
        self.rank = rank
        self.world = world
        self.shuffle = shuffle
        self.seed = seed
        self.top_names = tuple(top_names)
        self.lookahead = max(lookahead, 1)
        self.threads = threads if threads > 0 else (
            ENCODED_THREADS if getattr(dataset, "encoded", False)
            else DEFAULT_THREADS)
        self.device_transform = device_transform
        self._size = n
        self._perm_cache: dict[int, np.ndarray] = {}
        self._lock = threading.Lock()
        self._futures: dict[int, Future] = {}
        self.pool = ThreadPoolExecutor(max_workers=self.threads,
                                       thread_name_prefix="feeder")
        self.build_ms: list[float] = []  # host ms of each batch built

    # ------------------------------------------------------------------
    def _record_index(self, it: int, slot: int) -> int:
        flat = it * self.batch * self.world + self.rank * self.batch + slot
        epoch, within = divmod(flat, self._size)
        if not self.shuffle:
            return within
        with self._lock:
            perm = self._perm_cache.get(epoch)
        if perm is None:
            perm = np.random.RandomState(self.seed + epoch).permutation(
                self._size)
            with self._lock:
                self._perm_cache[epoch] = perm
                for k in [k for k in self._perm_cache if k < epoch - 2]:
                    del self._perm_cache[k]
        return int(perm[within])

    def _build_batch(self, it: int) -> dict[str, np.ndarray]:
        t0 = time.perf_counter()
        out = self._build_batch_inner(it)
        with self._lock:
            self.build_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def _build_batch_inner(self, it: int) -> dict[str, np.ndarray]:
        raws, labels, flats = [], [], []
        for slot in range(self.batch):
            img, label = self.ds.get(self._record_index(it, slot))
            raws.append(img)
            labels.append(label)
            flats.append(it * self.batch * self.world
                         + self.rank * self.batch + slot)
        if self.device_transform:
            out = self._raw_batch(raws, flats)
        else:
            out = {self.top_names[0]: self._transform(raws, flats)}
        if len(self.top_names) > 1:
            out[self.top_names[1]] = np.asarray(labels, np.int32)
        return out

    def _raw_batch(self, raws: list[np.ndarray], flats: list[int]) -> dict:
        """Device-transform staging: the uint8 stack and the (B, 3)
        decisions (the host transform's per-record Philox streams)."""
        from .device_transform import aug_key, compute_aug
        first = raws[0]
        if first.dtype != np.uint8 or any(
                r.shape != first.shape or r.dtype != np.uint8 for r in raws):
            raise ValueError(
                "device transform requires uniform uint8 records; set "
                "transform_param { use_gpu_transform: false } for this "
                "dataset")
        aug = compute_aug(self.tf, flats, first.shape[-2:], len(raws))
        return {self.top_names[0]: np.stack(raws),
                aug_key(self.top_names[0]): aug}

    def _transform(self, raws: list[np.ndarray],
                   flats: list[int]) -> np.ndarray:
        tf = self.tf
        if tf is None:
            return np.stack([np.asarray(r, np.float32) for r in raws])
        # per-record Philox stream: the same draws whatever thread builds
        return np.stack([tf(r, rng=tf.record_rng(f))
                         for r, f in zip(raws, flats)])

    # ------------------------------------------------------------------
    def __call__(self, it: int) -> dict[str, np.ndarray]:
        """The batch of micro-iteration `it`; schedules the next
        `lookahead` batches on the pool."""
        with self._lock:
            for ahead in range(it, it + self.lookahead + 1):
                if ahead not in self._futures:
                    self._futures[ahead] = self.pool.submit(
                        self._build_batch, ahead)
            fut = self._futures.pop(it)
            # stale entries (a resume, or a test pass starting over):
            # batches are pure functions of their index, so a dropped one
            # is rebuilt on demand
            for k in [k for k in self._futures
                      if k < it or k > it + self.lookahead]:
                self._futures.pop(k).cancel()
        return fut.result()

    def feed_ms_per_batch(self) -> float:
        """Median host ms to build one batch (one worker's time)."""
        with self._lock:
            ms = list(self.build_ms)
        return float(np.median(ms)) if ms else float("nan")

    def close(self) -> None:
        self.pool.shutdown(wait=False, cancel_futures=True)


class _PinnedSlot:
    """One set of pinned host buffers, and the event of its last upload."""

    def __init__(self):
        self.buffers: dict[str, torch.Tensor] = {}
        self.event: torch.cuda.Event | None = None

    def host(self, key: str, arr: np.ndarray) -> torch.Tensor:
        buf = self.buffers.get(key)
        want = torch.from_numpy(arr[:0]).dtype
        if buf is None or tuple(buf.shape) != arr.shape or buf.dtype != want:
            buf = torch.empty(arr.shape, dtype=want, pin_memory=True)
            self.buffers[key] = buf
        return buf


class DeviceFeed:
    """The feed function of a Solver over a Feeder: `feed(it)` -> {key:
    tensor on `device`}. On the card, batches go up through a ring of
    `depth` pinned buffer sets with non_blocking copies on a side stream;
    the batch of `it + 1` is staged on a worker thread while the caller
    runs step `it`. On the CPU the numpy arrays are wrapped as they are."""

    def __init__(self, feeder, device: torch.device, depth: int = 3):
        self.feeder = feeder
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)
            self._slots = [_PinnedSlot() for _ in range(max(depth, 2))]
            self._next = 0
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="device-feed")
        self._pending: dict[int, Future] = {}
        self.stage_ms: list[float] = []  # host ms of each staging

    def _stage(self, it: int):
        batch = self.feeder(it)
        if not self.cuda:
            return {k: torch.from_numpy(v) for k, v in batch.items()}, None
        t0 = time.perf_counter()
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot.event is not None:
            # the previous upload from these buffers must have finished
            # reading them before they are overwritten
            slot.event.synchronize()
        out = {}
        with torch.cuda.stream(self.stream):
            for key, arr in batch.items():
                host = slot.host(key, arr)
                host.numpy()[...] = arr
                out[key] = host.to(self.device, non_blocking=True)
            slot.event = torch.cuda.Event()
            slot.event.record(self.stream)
        self.stage_ms.append((time.perf_counter() - t0) * 1e3)
        return out, slot.event

    def __call__(self, it: int) -> dict[str, torch.Tensor]:
        fut = self._pending.pop(it, None)
        if fut is None:
            fut = self._pool.submit(self._stage, it)
        for k in list(self._pending):
            if k != it + 1:
                self._pending.pop(k).cancel()
        if it + 1 not in self._pending:
            self._pending[it + 1] = self._pool.submit(self._stage, it + 1)
        out, event = fut.result()
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for t in out.values():
                # allocated on the side stream, read on this one: the
                # allocator must not hand the memory out again before this
                # stream is done with it
                t.record_stream(cur)
        return out

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)
        self.feeder.close()


def feeder_from_layer(lp, phase: str, *, rank: int = 0, world: int = 1,
                      model_dir: str = "",
                      device_transform: bool = False) -> Feeder:
    """A Feeder from a Data layer's prototxt (reference
    DataLayer::LayerSetUp, data_layer.cpp:118-180). device_transform must
    be the consuming net's DataLayer.dev_transform."""
    from .datasets import CachedDataset, open_dataset

    if lp.type == "Data":
        p = lp.data_param
        ds = open_dataset(str(p.backend), os.path.join(model_dir, p.source))
        if p.cache:
            ds = CachedDataset(ds)  # refused: not ported
        tf = DataTransformer(lp.transform_param, phase, model_dir=model_dir)
        return Feeder(ds, tf, p.batch_size, rank=rank, world=world,
                      shuffle=bool(p.shuffle) and phase == "TRAIN",
                      top_names=tuple(lp.top), threads=p.threads,
                      lookahead=max(p.prefetch, 1),
                      device_transform=device_transform)
    if lp.type in ("ImageData", "HDF5Data", "WindowData"):
        raise unported(f"the {lp.type} layer's feeder")
    raise ValueError(f"not a pipeline data layer: {lp.type}")


class ProbeShape(tuple):
    """Post-transform (C, H, W) that also remembers the raw record shape:
    the device-transform path needs both (the feed is the raw uint8
    record; the top blob is the transformed shape)."""

    raw: tuple | None = None

    def __new__(cls, shape, raw=None):
        self = super().__new__(cls, shape)
        self.raw = raw
        return self


def data_shape_probe(lp, model_dir: str = ""):
    """Open the dataset once to find the record shape; returns the
    post-transform (C, H, W) (reference: DataLayer reads one sample in
    LayerSetUp). For uniform uint8 datasets it carries `.raw`, which
    enables the device transform."""
    from .datasets import open_dataset

    if lp.type == "Data":
        ds = open_dataset(str(lp.data_param.backend),
                          os.path.join(model_dir, lp.data_param.source))
        img, _ = ds.get(0)
        tf = DataTransformer(lp.transform_param, "TEST", model_dir=model_dir)
        raw = tuple(img.shape) if img.dtype == np.uint8 else None
        if raw is not None:
            # the device transform needs one record shape; sample records
            # across the DB (a full scan would read the whole dataset)
            n = len(ds)
            for i in {n // 2, n - 1, *range(1, min(n, 8))}:
                rec, _ = ds.get(int(i))
                if rec.shape != img.shape or rec.dtype != np.uint8:
                    raw = None
                    break
        return ProbeShape(tf.output_shape(img.shape), raw=raw)
    raise unported(f"the {lp.type} layer's shape probe")
