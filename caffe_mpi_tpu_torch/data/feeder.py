"""Batch feeder — the host-side prefetch pipeline, and its upload to the card.

Own copy of the JAX package's caffe_mpi_tpu/data/feeder.py (`Feeder`,
`FeedError`, `feeder_from_layer`, `data_shape_probe`, `ProbeShape`).
Reference machinery: DataReader's reader threads with round-robin record
striping (CursorManager, data_reader.hpp:28-53), BasePrefetchingDataLayer's
transformer threads and free/full batch queues (base_data_layer.hpp:100-159),
the prefetch auto-tuning of data_layer.cpp:46-113, and the GPU-side
asynchronous batch copy.

Batches are built by a thread pool ahead of the training loop, `lookahead`
batches deep (`data_param.prefetch`). The records of (iteration, slot) are
an index calculation:

    flat = it * batch * world + rank * batch + slot      (mod dataset size)

which is the reference's striping without cursors; with `shuffle`, each
epoch reads through `RandomState(seed + epoch).permutation(size)`. A
batch is a pure function of its iteration, so it is the JAX Feeder's bit
for bit, on each of its paths:

- raw Datums (an LMDB or datumfile of uint8 records): the batch's records
  are gathered in ONE native call (native.NativeLMDB.gather_raw: crc32c
  over the mapping against the sidecar, the Datum wire walk, one copy of
  each record into the batch's stack; the GIL released). The JAX Feeder
  reads these records one at a time in Python; the stack is the same
  bytes. A record the gather declines (a failed crc32c, a wire it does
  not take) is read again on the per-record path below, which owns the
  quarantine;
- encoded Datums (JPEG, PNG) where the library has the codecs: fused
  ingestion, the whole batch decoded (and, with the host transform,
  cropped, mirrored, mean-subtracted and scaled) in one native call
  (`decode_transform_batch`), records it declines decoded by PIL;
- otherwise the classic per-record path: `dataset.get` a record.

The host transform runs in C++ (native.transform_batch) where the
transform is expressible there (`_native`: no force_color / force_gray),
drawing each record's crop and mirror from splitmix64 keyed on the seed
and the record's flat index; with `_native` False it is the numpy
DataTransformer with a Philox stream a record — the two draw differently,
as in the JAX package. With the device transform the batch is the raw
uint8 stack plus the (B, 3) decisions (`device_transform.compute_aug`,
the Philox draws), and the card transforms it.

Corrupt records are quarantined (`_verified`): a record that fails its
crc32c or parse is replaced by the next healthy record by index, a pure
function of the record, memoised, and journaled (utils/resilience.py
QUARANTINE); past 5% of the dataset (at least 4 records) distinct corrupt
records raise DataIntegrityError. Transient read errors are retried with
a bounded backoff.

`threads: 0` (the prototxt default) is auto mode: min(cpu_count, 8)
workers, and the lookahead re-sized at run time from the measured build
time against the consumer's step time, under a host-memory budget for the
batches in flight (`_maybe_retune`, `_default_mem_budget`) — except for
encoded records that decode through PIL, which take ENCODED_THREADS
pinned workers, as the card measured.

`DeviceFeed` is the step the JAX package leaves to XLA's transfers: the
feed function a Solver calls, turning each numpy batch into tensors on
the device. On the card it copies the batch into pinned host memory and
uploads it with non_blocking copies on a side stream, batch i + 1 while
step i runs; the step's stream waits on the upload's event before it
reads the tensors. Pinned buffers are a ring, and a buffer is refilled
only after the event of its previous upload has completed.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from ..utils.resilience import (FAULTS, QUARANTINE, DataIntegrityError,
                                RecordIntegrityError, retrying)
from .datasets import Dataset, DecodedCacheDataset, unported
from .transformer import DataTransformer

log = logging.getLogger("caffe_mpi_tpu_torch.feeder")

_LOOKAHEAD_HARD_CAP = 16  # queue-depth ceiling even with memory to spare
# how many successive substitutes to probe past a corrupt record before
# declaring the neighbourhood dead, and the share of distinct corrupt
# records past which corruption counts as systematic
_QUARANTINE_PROBES = 16
_QUARANTINE_MAX_FRACTION = 0.05
AUTO_MAX_THREADS = 8  # auto mode's ceiling on workers
# workers of a Feeder whose records decode through PIL when
# data_param.threads is 0: pinned, no retune. On an 8-core host with an
# H100 (feed_variants.py, PERF.md §5) CaffeNet b256 from a JPEG LMDB
# stepped at 98-160 ms with 8 pinned workers (lookahead 4) against
# 166-234 ms in auto mode, whose retune grew the lookahead to 16: every
# worker decoding at once on the host's 8 cores, beside the training
# loop; raw records tie (auto 27.3-29.2 ms, 2 workers 28.1).
ENCODED_THREADS = 8


def auto_threads() -> int:
    """Workers of a Feeder in auto mode (`threads: 0`)."""
    return min(os.cpu_count() or 2, AUTO_MAX_THREADS)


class FeedError(RuntimeError):
    """A batch failed to assemble; names the iteration (the worker's
    exception alone does not say which batch died)."""


def _default_mem_budget() -> int:
    """Host-memory budget for in-flight batches: 25% of physical memory,
    capped at 2 GiB (the reference sizes its queue from free GPU memory,
    data_layer.cpp:66-77; here batches wait in host memory)."""
    try:
        phys = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        phys = 8 << 30
    if phys <= 0:
        phys = 8 << 30
    return min(phys // 4, 2 << 30)


class Feeder:
    def __init__(self, dataset: Dataset, transformer: DataTransformer | None,
                 batch_size: int, *, rank: int = 0, world: int = 1,
                 shuffle: bool = False, seed: int = 0, threads: int = 0,
                 lookahead: int = 3,
                 top_names: tuple[str, ...] = ("data", "label"),
                 device_transform: bool = False,
                 mem_budget: int | None = None):
        """top_names: the data layer's tops (image, then label).
        device_transform: stage raw uint8 batches and the per-record
        decisions instead of transforming on the host; must match the
        consuming Net's DataLayer.dev_transform. threads: 0 is auto mode
        (see the module docstring); a positive count pins the workers and
        the lookahead."""
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
        if threads == 0 and getattr(dataset, "encoded", False):
            from . import decode as _decode
            if not _decode.native_enabled():
                threads = ENCODED_THREADS
        self.auto = threads == 0
        self.threads = auto_threads() if self.auto else max(threads, 1)
        self.device_transform = device_transform
        self.mem_budget = (_default_mem_budget() if mem_budget is None
                           else mem_budget)
        self._size = n
        self._perm_cache: dict[int, np.ndarray] = {}
        self._lock = threading.Lock()
        self._futures: dict[int, Future] = {}
        self.pool = ThreadPoolExecutor(max_workers=self.threads,
                                       thread_name_prefix="feeder")
        self.build_ms: list[float] = []  # host ms of each batch built
        # set by a DeviceFeed on the card: the raw gather writes each batch
        # into pinned host memory, which the DeviceFeed uploads as it is
        self.pin_memory = False
        # auto-tune telemetry: build seconds (producer side), consumer gaps
        # (time spent outside __call__: the training step), batch bytes
        self._build_times: deque[float] = deque(maxlen=32)
        self._gaps: deque[float] = deque(maxlen=32)
        self._last_exit: float | None = None
        self._calls = 0
        self._batch_bytes = 0
        self._inflight = 0  # batch builds running (sizes native threads)
        # the native host transform, where the transform is expressible
        # in C++ (the JAX condition; the library itself builds or raises)
        tp = transformer.tp if transformer is not None else None
        self._native = tp is not None and not tp.force_color \
            and not tp.force_gray
        encoded = getattr(dataset, "encoded", None)
        # fused native ingestion of encoded records: None = undecided
        # until the first batch shows whether records are encoded
        self._fused_ok: bool | None = None
        if getattr(dataset, "get_datum", None) is None or encoded is False:
            self._fused_ok = False
        elif device_transform:
            pass  # fused decode-only staging fill
        elif transformer is None or not self._native:
            self._fused_ok = False  # transform not expressible natively
        elif (transformer.mean is not None
              and transformer.mean.reshape(-1).size not in (1, 3)):
            # a full-image mean needs each record's crop window at its own
            # dims; sizes 1/3 broadcast over the decoder's 3 BGR channels
            self._fused_ok = False
        # the native raw gather: datasets of raw records that have one;
        # the record shape is learned from the first batch
        self._gather_ok = (getattr(dataset, "gather_raw", None) is not None
                           and encoded is False)
        self._raw_shape: tuple | None = None
        # the quarantine: distinct corrupt records so far, and each
        # corrupt record's substitute (a pure function of the record)
        self._quarantined: set[int] = set()
        self._sub_cache: dict[int, int] = {}
        self._quarantine_limit = max(4, int(n * _QUARANTINE_MAX_FRACTION))

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

    def _slots(self, it: int) -> tuple[list[int], list[int]]:
        """(record index, flat index) of each slot of batch `it`."""
        base = it * self.batch * self.world + self.rank * self.batch
        return ([self._record_index(it, s) for s in range(self.batch)],
                [base + s for s in range(self.batch)])

    def _empty(self, shape, dtype) -> np.ndarray:
        """A batch array, in pinned memory when a DeviceFeed on the card
        asked for it (`pin_memory`): uploaded without a staging copy."""
        if self.pin_memory:
            return torch.empty(shape, dtype=torch.from_numpy(
                np.empty(0, dtype)).dtype, pin_memory=True).numpy()
        return np.empty(shape, dtype)

    def _native_threads(self) -> int:
        """Threads for ONE native batch call (gather, fused decode). A
        pinned feeder keeps its pin; auto mode divides the host's cores
        among the builds in flight (8 workers each starting 8 threads
        would oversubscribe the host)."""
        if not self.auto:
            return self.threads
        with self._lock:
            inflight = max(self._inflight, 1)
        return max(1, (os.cpu_count() or 1) // inflight)

    def _build_batch(self, it: int) -> dict[str, np.ndarray]:
        t0 = time.perf_counter()
        with self._lock:
            self._inflight += 1
        try:
            out = self._build_batch_inner(it)
        finally:
            with self._lock:
                self._inflight -= 1
        secs = time.perf_counter() - t0
        with self._lock:
            self.build_ms.append(secs * 1e3)
            if self.auto:
                self._build_times.append(secs)
                if not self._batch_bytes:
                    self._batch_bytes = sum(
                        v.nbytes for v in out.values()
                        if isinstance(v, np.ndarray)) or 1
        return out

    # -- reads, retries and the quarantine ------------------------------
    def _read_record(self, rec: int):
        """One dataset read with a bounded-backoff retry of transient
        errors (and the injected `feeder_read` fault). Integrity failures
        (RecordIntegrityError) are deterministic: they pass the retry and
        quarantine instead (_verified)."""
        def get():
            FAULTS.maybe_raise("feeder_read", OSError,
                               f"injected dataset read fault (record {rec})")
            return self.ds.get(rec)
        return retrying(get, attempts=4, base_delay=0.05,
                        desc=f"dataset read (record {rec})")

    def _fetch_datum(self, rec: int):
        """One wire-fields fetch (no image decode), retried as
        _read_record: the fused path's fetch."""
        def get():
            FAULTS.maybe_raise("feeder_read", OSError,
                               f"injected dataset read fault (record {rec})")
            return self.ds.get_datum(rec)
        return retrying(get, attempts=4, base_delay=0.05,
                        desc=f"dataset read (record {rec})")

    def _read_record_verified(self, rec: int):
        return self._verified(rec, self._read_record)

    def _verified(self, rec: int, read_fn):
        """Read record `rec` via `read_fn`, quarantining it on an
        integrity failure: the substitute is the next healthy record by
        index, `(rec + probe) % size` for probe = 1.., a pure function of
        `rec`, so a resumed or replayed run substitutes alike. Each newly
        quarantined record is journaled; more than `_quarantine_limit`
        distinct corrupt records (or a whole probe window of them) is
        systematic corruption and raises DataIntegrityError."""
        sub = self._sub_cache.get(rec)
        if sub is not None:
            # a memoised substitute that has rotted since is quarantined
            # like any record (depth bounded by the quarantine limit)
            return self._verified(sub, read_fn)
        try:
            return read_fn(rec)
        except RecordIntegrityError as first:
            src = getattr(self.ds, "path", "") or type(self.ds).__name__
            with self._lock:
                self._quarantined.add(rec)
                n_bad = len(self._quarantined)
            if n_bad > self._quarantine_limit:
                raise DataIntegrityError(
                    f"{n_bad} distinct corrupt records in {src} exceeds "
                    f"the quarantine bound ({self._quarantine_limit} = "
                    f"{_QUARANTINE_MAX_FRACTION:.0%} of {self._size}); "
                    "corruption is systematic — regenerate the dataset "
                    f"(first failure: {first})") from first
            for probe in range(1, _QUARANTINE_PROBES + 1):
                sub = (rec + probe) % self._size
                try:
                    out = read_fn(sub)
                except RecordIntegrityError as e:
                    with self._lock:
                        self._quarantined.add(sub)
                    # probe casualties count toward the bound, so they are
                    # journaled too (substitute -1: skipped while probing)
                    QUARANTINE.record(src, sub, -1, e.reason)
                    continue
                QUARANTINE.record(src, rec, sub, first.reason)
                with self._lock:
                    self._sub_cache[rec] = sub
                return out
            raise DataIntegrityError(
                f"records {rec}..{(rec + _QUARANTINE_PROBES) % self._size}"
                f" of {src} are ALL corrupt ({_QUARANTINE_PROBES + 1} "
                "consecutive); corruption is systematic — regenerate "
                f"the dataset (first failure: {first})") from first

    # -- batch assembly -------------------------------------------------
    def _assemble(self, raws, labels, flats) -> dict[str, np.ndarray]:
        """The batch's tail: transform or stage, and the label top."""
        if self.device_transform:
            out = self._raw_batch(raws, flats)
        else:
            out = {self.top_names[0]: self._transform(raws, flats)}
        if len(self.top_names) > 1:
            out[self.top_names[1]] = np.asarray(labels, np.int32)
        return out

    def _build_batch_inner(self, it: int) -> dict[str, np.ndarray]:
        if self._fused_ok is not False:
            from . import decode as _decode
            if _decode.native_enabled():
                out = self._build_batch_fused(it)
                if out is not None:
                    return out
        if self._gather_ok:
            out = self._build_batch_gather(it)
            if out is not None:
                return out
        recs, flats = self._slots(it)
        raws, labels = [], []
        for rec in recs:
            img, label = self._read_record_verified(rec)
            raws.append(img)
            labels.append(label)
        return self._assemble(raws, labels, flats)

    # -- the native raw gather -------------------------------------------
    def _build_batch_gather(self, it: int) -> dict[str, np.ndarray] | None:
        """A batch of raw Datums in one native call into its uint8 stack.
        Records the call declines re-enter through the per-record
        verified read (quarantine, PIL, the error). None sends the batch
        down the classic path: the dataset's reader has no gather now
        (the plain reader, fault injection), or its records are not
        uint8 (then the Feeder stays classic)."""
        recs, flats = self._slots(it)
        if self._raw_shape is None:
            first, _ = self._read_record_verified(recs[0])
            if first.dtype != np.uint8 or first.ndim != 3:
                self._gather_ok = False
                return None
            self._raw_shape = tuple(first.shape)
        # memoised substitutes are read in their records' place
        read = []
        for rec in recs:
            while rec in self._sub_cache:
                rec = self._sub_cache[rec]
            read.append(rec)
        stack = self._empty((self.batch, *self._raw_shape), np.uint8)

        def gather():
            FAULTS.maybe_raise("feeder_read", OSError,
                               f"injected dataset read fault (batch {it})")
            return self.ds.gather_raw(read, self._raw_shape, stack,
                                      num_threads=self._native_threads())
        got = retrying(gather, attempts=4, base_delay=0.05,
                       desc=f"dataset gather (batch {it})")
        if got is None:
            return None
        from .. import native
        labels_nat, status = got
        labels = labels_nat.tolist()
        bad = np.flatnonzero(status != native.GATHER_OK)
        odd = {}  # slot -> a record of another shape or dtype
        for i in bad.tolist():
            img, labels[i] = self._read_record_verified(recs[i])
            if img.dtype == np.uint8 and img.shape == self._raw_shape:
                stack[i] = img
            else:
                odd[i] = img
        if odd:
            # the classic tail takes (and raises on, for the device
            # transform) a batch of mixed records, as the JAX Feeder does
            return self._assemble([odd.get(i, stack[i])
                                   for i in range(self.batch)],
                                  labels, flats)
        return self._assemble(stack, labels, flats)

    # -- fused native ingestion ------------------------------------------
    def _build_batch_fused(self, it: int) -> dict[str, np.ndarray] | None:
        """Batch build for encoded datasets: fetch verified wire fields a
        record, then decode the JPEG/PNG payloads of the WHOLE batch in
        one GIL-released native call — fused with the transform (host
        transform) or decoding straight into the uint8 staging stack
        (device transform). Cache hits (DecodedCacheDataset) skip the
        decode; records the native decoder declines go one at a time
        through the classic read, which owns PIL and the quarantine.

        Returns None exactly once, when the first batch shows the dataset
        has no encoded records: the Feeder then stays classic."""
        from . import decode as _decode
        from .datasets import materialize_datum

        cache = self.ds if isinstance(self.ds, DecodedCacheDataset) else None
        recs, flats = self._slots(it)
        # per slot: ("enc", jpeg/png bytes, label) | ("arr", CHW, label)
        entries: list[tuple] = []
        for rec in recs:
            hit = cache.lookup(rec) if cache is not None else None
            if hit is not None:
                entries.append(("arr", hit[0], hit[1]))
                continue
            fields = self._verified(rec, self._fetch_datum)
            if fields.encoded:
                entries.append(("enc", fields.data, fields.label))
            else:
                try:
                    arr, label = materialize_datum(fields)
                except Exception:
                    arr, label = self._read_record_verified(rec)
                entries.append(("arr", arr, label))
        if self._fused_ok is None:
            self._fused_ok = any(e[0] == "enc" for e in entries)
            if not self._fused_ok:
                return self._assemble([e[1] for e in entries],
                                      [e[2] for e in entries], flats)
        enc = [i for i, e in enumerate(entries) if e[0] == "enc"]
        if self.device_transform:
            out = self._fused_staging(entries, enc, recs, flats, cache)
        else:
            out = self._fused_transform(entries, enc, recs, flats, cache)
        if out is not None and enc:
            _decode.STATS.count("fused_batches")
        return out

    def _fallback_record(self, rec: int):
        """A record the native decoder declined (an exotic variant or
        corrupt bytes): the classic verified read decodes it by PIL and
        owns the quarantine."""
        from . import decode as _decode
        _decode.STATS.count("fused_fallback_records")
        return self._read_record_verified(rec)

    def _fused_transform(self, entries, enc, recs, flats, cache):
        """Host transform: one native call decodes and transforms every
        encoded slot into its f32 row (each record cropped at its own
        decoded size)."""
        from .. import native
        from . import decode as _decode
        if not enc:
            # nothing to decode (cache hits, raw slots): the classic tail
            return self._assemble([e[1] for e in entries],
                                  [e[2] for e in entries], flats)
        tf = self.tf
        crop = tf.tp.crop_size
        n = len(entries)
        labels = [e[2] for e in entries]
        if crop:
            oh = ow = crop
        else:
            # no crop: output dims = decoded dims, which must be uniform
            first = entries[0]
            if first[0] == "arr":
                oh, ow = first[1].shape[-2:]
            else:
                dims = native.decode_probe(first[1])
                if dims is None:
                    arr, labels[0] = self._fallback_record(recs[0])
                    entries[0] = ("arr", arr, labels[0])
                    oh, ow = arr.shape[-2:]
                else:
                    oh, ow = dims
            enc = [i for i in enc if entries[i][0] == "enc"]
        mean = tf.mean
        if mean is not None:
            mean = mean.reshape(-1)
            if mean.size == 1:
                # one mean_value applies to every channel (reference
                # data_transformer.cpp: mean_values_ repeated)
                mean = np.repeat(mean, 3)
        out = self._empty((n, 3, oh, ow), np.float32)
        if enc:
            bufs = [entries[i][1] for i in enc]
            ids = np.asarray([flats[i] for i in enc], np.int64)
            # a whole-batch encoded batch writes its rows straight into
            # `out`; a mixed one stages the encoded subset and scatters
            whole = len(enc) == n
            enc_out = out if whole else np.empty((len(enc), 3, oh, ow),
                                                 np.float32)
            decoded = None
            if cache is not None and cache.admitting():
                decoded = []
                for b in bufs:
                    dims = native.decode_probe(b)
                    decoded.append(None if dims is None else
                                   np.empty((3, *dims), np.uint8))
            status = native.decode_transform_batch(
                bufs, ids, crop=crop, mean=mean, scale=tf.tp.scale,
                train=tf.phase == "TRAIN", mirror=tf.tp.mirror,
                seed=tf.seed or 0, out_h=oh, out_w=ow, out=enc_out,
                decoded_out=decoded, num_threads=self._native_threads())
            for k, i in enumerate(enc):
                if status[k] == native.DECODE_OK:
                    _decode.STATS.count("fused_records")
                    if not whole:
                        out[i] = enc_out[k]
                    if decoded is not None and decoded[k] is not None:
                        cache.insert(recs[i], decoded[k], labels[i])
                else:
                    # the fallback re-read rewrites the row below
                    arr, labels[i] = self._fallback_record(recs[i])
                    entries[i] = ("arr", arr, labels[i])
        # cache hits, raw records and fallbacks: the classic transform
        rest = [i for i in range(n) if entries[i][0] == "arr"]
        if rest:
            shapes = {entries[i][1].shape for i in rest}
            dtypes = {entries[i][1].dtype for i in rest}
            if len(shapes) == 1 and dtypes == {np.dtype(np.uint8)}:
                rows = self._transform([entries[i][1] for i in rest],
                                       [flats[i] for i in rest])
                for k, i in enumerate(rest):
                    out[i] = rows[k]
            else:
                for i in rest:
                    out[i] = self._transform([entries[i][1]], [flats[i]])[0]
        res = {self.top_names[0]: out}
        if len(self.top_names) > 1:
            res[self.top_names[1]] = np.asarray(labels, np.int32)
        return res

    def _fused_staging(self, entries, enc, recs, flats, cache):
        """Device transform: decode the encoded slots straight into the
        uint8 staging stack (the card transforms raw records and the
        decisions)."""
        from .. import native
        from . import decode as _decode
        from .device_transform import aug_key, compute_aug
        n = len(entries)
        labels = [e[2] for e in entries]
        first = entries[0]
        if first[0] == "arr":
            shape = first[1].shape
        else:
            dims = native.decode_probe(first[1])
            if dims is None:
                arr, labels[0] = self._fallback_record(recs[0])
                entries[0] = ("arr", arr, labels[0])
                shape = arr.shape
            else:
                shape = (3, *dims)
            enc = [i for i in enc if entries[i][0] == "enc"]
        if len(shape) != 3 or shape[0] != 3:
            return None  # the classic path handles (and raises on) it
        stack = self._empty((n, *shape), np.uint8)
        if enc:
            bufs = [entries[i][1] for i in enc]
            ids = np.asarray([flats[i] for i in enc], np.int64)
            status = native.decode_transform_batch(
                bufs, ids, out_h=shape[1], out_w=shape[2], out=None,
                decoded_out=[stack[i] for i in enc],
                num_threads=self._native_threads())
            for k, i in enumerate(enc):
                if status[k] != native.DECODE_OK:
                    arr, labels[i] = self._fallback_record(recs[i])
                    entries[i] = ("arr", arr, labels[i])
                else:
                    _decode.STATS.count("fused_records")
                    if cache is not None and cache.admitting():
                        cache.insert(recs[i], stack[i].copy(), labels[i])
        for i in range(n):
            kind, payload = entries[i][0], entries[i][1]
            if kind == "arr":
                if payload.shape != shape or payload.dtype != np.uint8:
                    raise ValueError(
                        "device transform requires uniform uint8 records; "
                        "set transform_param { use_gpu_transform: false } "
                        "for this dataset")
                stack[i] = payload
        aug = compute_aug(self.tf, flats, shape[-2:], n)
        res = {self.top_names[0]: stack, aug_key(self.top_names[0]): aug}
        if len(self.top_names) > 1:
            res[self.top_names[1]] = np.asarray(labels, np.int32)
        return res

    def _raw_batch(self, raws, flats: list[int]) -> dict:
        """Device-transform staging: the uint8 stack and the (B, 3)
        decisions (the host transform's per-record Philox streams).
        `raws` is a list of records or their stack already."""
        from .device_transform import aug_key, compute_aug
        if isinstance(raws, np.ndarray):
            stack = raws
        else:
            first = raws[0]
            if first.dtype != np.uint8 or any(
                    r.shape != first.shape or r.dtype != np.uint8
                    for r in raws):
                raise ValueError(
                    "device transform requires uniform uint8 records; set "
                    "transform_param { use_gpu_transform: false } for this "
                    "dataset")
            stack = np.stack(raws)
        aug = compute_aug(self.tf, flats, stack.shape[-2:], len(stack))
        return {self.top_names[0]: stack,
                aug_key(self.top_names[0]): aug}

    def _transform(self, raws, flats: list[int]) -> np.ndarray:
        """The host transform of a list of records, or of their stack."""
        tf = self.tf
        if tf is None:
            return np.stack([np.asarray(r, np.float32) for r in raws])
        stacked = isinstance(raws, np.ndarray)
        if self._native and (stacked or (
                raws[0].dtype == np.uint8
                and all(r.shape == raws[0].shape for r in raws))):
            from .. import native
            images = raws if stacked else np.stack(raws)
            mean = tf.mean
            if mean is not None and mean.ndim == 3 and mean.shape[1] == 1:
                mean = mean.reshape(-1)  # per-channel (c,1,1) -> (c,)
                if mean.size == 1 and images.shape[1] > 1:
                    # one mean_value broadcasts over the channels; the C
                    # loop indexes mean[ch], so repeat it
                    mean = np.repeat(mean, images.shape[1])
            crop = tf.tp.crop_size
            n, c, h, w = images.shape
            return native.transform_batch(
                images, np.asarray(flats, np.int64),
                crop=crop, mean=mean, scale=tf.tp.scale,
                train=(tf.phase == "TRAIN"), mirror=tf.tp.mirror,
                seed=tf.seed or 0, num_threads=self._native_threads(),
                out=self._empty((n, c, crop or h, crop or w), np.float32))
        # the numpy path: a Philox stream a record, the same draws
        # whatever thread builds it
        return np.stack([tf(r, rng=tf.record_rng(f))
                         for r, f in zip(raws, flats)])

    # ------------------------------------------------------------------
    def _maybe_retune(self) -> None:
        """The lookahead (batches built at once by the pool) must cover
        build time / step time, re-measured at run time and clamped by
        the memory budget for batches in flight (reference
        data_layer.cpp:46-113 sizes its threads once, at iteration 0)."""
        with self._lock:
            builds = list(self._build_times)
            bytes_ = self._batch_bytes
        if len(builds) < 5 or len(self._gaps) < 5:
            return
        build = sorted(builds)[len(builds) // 2]
        gap = sorted(self._gaps)[len(self._gaps) // 2]
        want = math.ceil(build / max(gap, 1e-4)) + 1
        cap = _LOOKAHEAD_HARD_CAP
        if bytes_:
            cap = min(cap, max(int(self.mem_budget // bytes_) - 1, 1))
        want = min(max(want, 1), cap)
        if want != self.lookahead:
            log.info("prefetch auto-tune: lookahead %d -> %d "
                     "(build %.1f ms vs step %.1f ms, batch %.1f MiB, "
                     "budget %.0f MiB)", self.lookahead, want, build * 1e3,
                     gap * 1e3, bytes_ / 2**20, self.mem_budget / 2**20)
            self.lookahead = want

    def __call__(self, it: int) -> dict[str, np.ndarray]:
        """The batch of micro-iteration `it`; schedules the next
        `lookahead` batches on the pool."""
        if self.auto:
            now = time.perf_counter()
            self._calls += 1
            if self._last_exit is not None and self._calls > 2:
                # the first gaps are warm-up (first step's compile, cuDNN
                # autotuning) and left out
                self._gaps.append(now - self._last_exit)
            # tune as soon as the warm-up window fills, then every 64
            if self._calls >= 8 and (self._calls == 8
                                     or self._calls % 64 == 0):
                self._maybe_retune()
        with self._lock:
            for ahead in range(it, it + self.lookahead + 1):
                if ahead not in self._futures:
                    self._futures[ahead] = self.pool.submit(
                        self._build_batch, ahead)
            fut = self._futures.pop(it)
            # stale entries (a resume, a test pass starting over, a window
            # a retune shrank): batches are pure functions of their index,
            # so a dropped one is rebuilt on demand; one already running
            # logs its exception, if any, rather than losing it
            for k in [k for k in self._futures
                      if k < it or k > it + self.lookahead]:
                dropped = self._futures.pop(k)
                if not dropped.cancel():
                    dropped.add_done_callback(self._log_abandoned)
        out = fut.result()
        if self.auto:
            self._last_exit = time.perf_counter()
        return out

    @staticmethod
    def _log_abandoned(fut) -> None:
        exc = None if fut.cancelled() else fut.exception()
        if exc is not None:
            log.warning("abandoned prefetch batch raised: %r", exc)

    def feed_ms_per_batch(self) -> float:
        """Median host ms to build one batch (one worker's time)."""
        with self._lock:
            ms = list(self.build_ms)
        return float(np.median(ms)) if ms else float("nan")

    def close(self) -> None:
        """Cancel the queued builds and wait for the running ones (at most
        one a worker), so no build outlives its Feeder."""
        self.pool.shutdown(wait=True, cancel_futures=True)


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


def _pinned_tensor(arr: np.ndarray) -> torch.Tensor | None:
    """The pinned host tensor `arr` is a whole view of, or None."""
    base = arr.base
    if isinstance(base, torch.Tensor) and base.is_pinned() and \
            base.data_ptr() == arr.ctypes.data and \
            tuple(base.shape) == arr.shape and base.is_contiguous():
        return base
    return None


class DeviceFeed:
    """The feed function of a Solver over a Feeder: `feed(it)` -> {key:
    tensor on `device`}. On the card, batches go up through a ring of
    `depth` pinned buffer sets with non_blocking copies on a side stream;
    the batch of `it + 1` is staged on a worker thread while the caller
    runs step `it`. An array the Feeder built in pinned memory already (the
    raw gather's stack, `Feeder.pin_memory`) goes up as it is, without the
    staging copy; the caching host allocator keeps its block from reuse
    until the upload is done. On the CPU the numpy arrays are wrapped as
    they are."""

    def __init__(self, feeder, device: torch.device, depth: int = 3):
        self.feeder = feeder
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)
            self._slots = [_PinnedSlot() for _ in range(max(depth, 2))]
            self._next = 0
            if hasattr(feeder, "pin_memory"):
                feeder.pin_memory = True
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
                host = _pinned_tensor(arr)
                if host is None:
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
        try:
            out, event = fut.result()
        except Exception as e:
            raise FeedError(f"the feed batch of iteration {it} failed to "
                            f"assemble: {e!r}") from e
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
                      model_dir: str = "", device_transform: bool = False,
                      solver_param=None) -> Feeder:
    """A Feeder from a Data layer's prototxt (reference
    DataLayer::LayerSetUp, data_layer.cpp:118-180), or from an ImageData
    layer's list of image files (image_data_layer.cpp; the transform on
    the host, as in JAX). device_transform must be the consuming net's
    DataLayer.dev_transform. `data_param.cache`
    wraps the dataset in the whole-DB RAM cache; else the solver's
    `decoded_cache_mb` > 0 (solver_param, when given) in the bounded
    decoded-record cache. A negative decoded_cache_mb raises ValueError."""
    from .datasets import CachedDataset, ImageFolderDataset, open_dataset

    cache_mb = float(getattr(solver_param, "decoded_cache_mb", 0.0) or 0.0)
    if cache_mb < 0:
        raise ValueError(f"decoded_cache_mb must be >= 0, got {cache_mb}")
    if lp.type == "Data":
        p = lp.data_param
        ds = open_dataset(str(p.backend), os.path.join(model_dir, p.source))
        if p.cache:
            ds = CachedDataset(ds)
        elif cache_mb > 0:
            ds = DecodedCacheDataset(ds, cache_mb)
        tf = DataTransformer(lp.transform_param, phase, model_dir=model_dir)
        # threads 0 (the prototxt default) is auto mode; prefetch seeds
        # the lookahead (reference data_param.prefetch)
        return Feeder(ds, tf, p.batch_size, rank=rank, world=world,
                      shuffle=bool(p.shuffle) and phase == "TRAIN",
                      top_names=tuple(lp.top), threads=p.threads,
                      lookahead=max(p.prefetch, 1),
                      device_transform=device_transform)
    if lp.type == "ImageData":
        p = lp.image_data_param
        ds = ImageFolderDataset(os.path.join(model_dir, p.source),
                                root=p.root_folder, new_height=p.new_height,
                                new_width=p.new_width, is_color=p.is_color)
        tf = DataTransformer(lp.transform_param, phase, model_dir=model_dir)
        return Feeder(ds, tf, p.batch_size, rank=rank, world=world,
                      shuffle=bool(p.shuffle) and phase == "TRAIN",
                      top_names=tuple(lp.top))
    if lp.type == "HDF5Data":
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
