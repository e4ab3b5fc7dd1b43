"""bench_data — the host data pipeline's throughput (img/s per backend) and
the ingestion stages' ms, on this host.

Own copy of the JAX package's caffe_mpi_tpu/tools/bench_data.py. The
reference's pipeline keeps its GPUs fed with DataReader and transformer
threads (data_layer.cpp:46-113); here the host side (dataset read ->
decode -> transform -> batch) must outrun the card's step, and this tool
measures it alone, with the Feeder the training path uses. Nothing here
touches the card.

The backend sweep writes a dataset of raw Datums a backend (`lmdb`,
`leveldb` (snappy blocks, as the JAX tool writes it), `datumfile`) and
reports the Feeder's img/s at each thread count
(`-threads`, 0 = auto mode), with the host transform (crop, mirror,
mean values: the AlexNet recipe) or, with `-device-transform`, the raw
uint8 staging the card transforms, and the raw batch's native gather ms
(null for leveldb, which the pure-Python reader reads record by record,
as in the JAX package).

The `ingest` section (`--no-ingest` to skip it, `--ingest-only` for just
it) writes a JPEG-encoded LMDB, the ImageNet-convert layout, where decode
dominates, and reports:
  * ms a batch of each stage: read (the native cursor's value copy), crc
    (crc32c over the mapping), decode (per record, PIL and native),
    transform (the native batch transform), assemble (stack and labels);
  * the Feeder's img/s on the PIL path (CAFFE_NATIVE_DECODE=0), the fused
    native path, and the decoded-record cache's second epoch.
Where the native library was built without the codecs, the native decode
and fused figures are "not measured" (null).

    python -m caffe_mpi_tpu_torch.tools.bench_data [-n 4096] [-batch 256] \\
        [-shape 3x256x256] [-crop 227] [-backends lmdb,leveldb,datumfile] \\
        [-threads 0,2] [-device-transform] [--json] [--ingest-only] \\
        [--no-ingest] [--ingest-n N]

`hdf5` raises NotImplementedError: not ported yet (ROADMAP.md §1
item 3).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

MEAN = "mean_value: 104 mean_value: 117 mean_value: 123"
BACKENDS = ("lmdb", "leveldb", "datumfile")
UNPORTED_BACKENDS = ("hdf5",)


def _check_backend(backend: str) -> None:
    from ..data.datasets import unported
    if backend in UNPORTED_BACKENDS:
        raise unported(f"bench_data's {backend} backend")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")


def _make_records(n, shape, seed=0):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, *shape), dtype=np.uint8)
    labels = rng.randint(0, 1000, n)
    return imgs, labels


def _write_db(backend, workdir, imgs, labels):
    """The dataset of one backend, written once; returns its path."""
    from ..data.datasets import DatumFileDataset, encode_datum

    _check_backend(backend)
    recs = ((f"{i:08d}".encode(), encode_datum(imgs[i], int(labels[i])))
            for i in range(len(labels)))
    if backend == "lmdb":
        from ..data.lmdb_io import write_lmdb
        path = os.path.join(workdir, "b_lmdb")
        write_lmdb(path, recs)
        return path
    if backend == "leveldb":
        from ..data.leveldb_io import write_leveldb
        path = os.path.join(workdir, "b_leveldb")
        write_leveldb(path, list(recs), compress=True)
        return path
    path = os.path.join(workdir, "b.datumdb")
    DatumFileDataset.write(path, (r for _, r in recs))
    return path


def _feeder_for(backend, path, batch, crop, threads=0, device=False):
    from ..data import DataTransformer, Feeder
    from ..data.datasets import open_dataset
    from ..proto.config import TransformationParameter

    ds = open_dataset(backend.upper(), path)
    tp = TransformationParameter.from_text(
        f"crop_size: {crop} mirror: true {MEAN}")
    return Feeder(ds, DataTransformer(tp, "TRAIN"), batch_size=batch,
                  shuffle=True, threads=threads, device_transform=device)


def _gather_ms(backend, path, batch, shape, iters) -> float | None:
    """ms of one native raw gather of a batch (one call, auto threads);
    None for a backend without one (leveldb)."""
    from ..data.datasets import open_dataset
    from ..data.feeder import auto_threads
    ds = open_dataset(backend.upper(), path)
    if not hasattr(ds, "gather_raw"):
        return None
    out = np.empty((batch, *shape), np.uint8)
    n = len(ds)
    t = 0.0
    for it in range(iters):
        idx = [(it * batch + i) % n for i in range(batch)]
        t0 = time.perf_counter()
        ds.gather_raw(idx, shape, out, num_threads=auto_threads())
        t += time.perf_counter() - t0
    return t * 1e3 / iters


def _ingest_feeder_img_s(path, batch, iters, crop, env_val, *,
                         decoded_cache_mb=0.0, epochs=1):
    """One worker's batch-build rate over the encoded LMDB with the decode
    pinned to `env_val` ("" auto/native, "0" PIL). Batches are built
    directly (`_build_batch_inner`), not through the prefetch queue,
    which would build them off the clock. With a decoded cache and
    epochs 2, only the SECOND epoch is timed. Returns (img/s, the decode
    counts of the timed batches)."""
    from ..data import DataTransformer, Feeder
    from ..data import decode as dmod
    from ..data.datasets import DecodedCacheDataset, open_dataset
    from ..proto.config import TransformationParameter

    prev = os.environ.get("CAFFE_NATIVE_DECODE")
    if env_val:
        os.environ["CAFFE_NATIVE_DECODE"] = env_val
    else:
        os.environ.pop("CAFFE_NATIVE_DECODE", None)
    try:
        ds = open_dataset("LMDB", path)
        if decoded_cache_mb:
            ds = DecodedCacheDataset(ds, decoded_cache_mb)
        tp = TransformationParameter.from_text(
            f"crop_size: {crop} mirror: true {MEAN}")
        feeder = Feeder(ds, DataTransformer(tp, "TRAIN", seed=3),
                        batch_size=batch, shuffle=True, threads=0)
        it0 = 0
        if epochs > 1:  # a whole first epoch fills the cache
            for it in range(iters):
                feeder._build_batch_inner(it)
            it0 = iters
        feeder._build_batch_inner(it0)  # the path decision, off the clock
        s0 = dmod.STATS.snapshot()
        t0 = time.perf_counter()
        for it in range(it0 + 1, it0 + iters):
            feeder._build_batch_inner(it)
        dt = time.perf_counter() - t0
        feeder.close()
        s1 = dmod.STATS.snapshot()
        return batch * (iters - 1) / dt, {k: s1[k] - s0[k] for k in s1}
    finally:
        if prev is None:
            os.environ.pop("CAFFE_NATIVE_DECODE", None)
        else:
            os.environ["CAFFE_NATIVE_DECODE"] = prev


def _ingest_stage_breakdown(path, batch, iters, crop):
    """Each stage of the Feeder's work over the encoded LMDB timed alone:
    decode on both paths (per record, PIL and native), the native batch
    transform."""
    from .. import native
    from ..data import decode as dmod
    from ..data.datasets import parse_datum_fields
    from ..data.lmdb_io import read_crc_sidecar

    db = native.NativeLMDB(path)
    crcs = read_crc_sidecar(path, expect_count=len(db))
    mean = np.asarray([104.0, 117.0, 123.0], np.float32)
    stages = {k: 0.0 for k in ("read", "crc", "decode_pil",
                               "decode_native", "transform", "assemble")}
    codec = native.decode_available()
    for it in range(iters):
        idx = [(it * batch + i) % len(db) for i in range(batch)]
        t0 = time.perf_counter()
        raws = [db.value(i) for i in idx]
        stages["read"] += time.perf_counter() - t0
        if crcs is not None:
            t0 = time.perf_counter()
            for i in idx:
                if db.value_crc32c(i) != int(crcs[i]):
                    raise RuntimeError(f"record {i}: crc32c mismatch")
            stages["crc"] += time.perf_counter() - t0
        fields = [parse_datum_fields(r) for r in raws]
        t0 = time.perf_counter()
        decoded = [dmod._pil_decode(f.data) for f in fields]
        stages["decode_pil"] += time.perf_counter() - t0
        if codec:
            t0 = time.perf_counter()
            nat = [native.decode_image_native(f.data) for f in fields]
            stages["decode_native"] += time.perf_counter() - t0
            decoded = [d if d is not None else p
                       for d, p in zip(nat, decoded)]
        t0 = time.perf_counter()
        # lint: ok(host-sync) — host batch indices
        out = native.transform_batch(
            np.stack(decoded), np.asarray(idx, np.int64), crop=crop,
            mean=mean, train=True, mirror=True, seed=3)
        stages["transform"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        # lint: ok(host-sync) — host labels
        labels = np.asarray([f.label for f in fields], np.int32)
        batch_out = {"data": np.ascontiguousarray(out), "label": labels}
        stages["assemble"] += time.perf_counter() - t0
        del batch_out
    db.close()
    res = {k: v * 1e3 / iters for k, v in stages.items()}
    if not codec:
        res["decode_native"] = None
    return res


def run_ingest(workdir, n, batch, shape, crop, codec="jpeg",
               cache_mb=512.0) -> dict:
    """Write the JPEG-encoded LMDB and measure the `ingest` block."""
    from .. import native
    from ..data.datasets import encode_datum_image
    from ..data.lmdb_io import write_lmdb

    imgs, labels = _make_records(n, shape, seed=11)
    path = os.path.join(workdir, "ingest_lmdb")
    t0 = time.perf_counter()
    write_lmdb(path, ((f"{i:08d}".encode(),
                       encode_datum_image(imgs[i], int(labels[i]), codec))
                      for i in range(n)))
    build_s = time.perf_counter() - t0
    iters = max(n // batch, 2)
    block = {
        "codec": codec, "n": n, "batch": batch,
        "shape": "x".join(map(str, shape)), "crop": crop,
        "db_build_s": build_s,
        "native_decode_available": native.decode_available(),
        "stages_ms_per_batch": _ingest_stage_breakdown(path, batch, iters,
                                                       crop),
    }
    pil_img_s, _ = _ingest_feeder_img_s(path, batch, iters, crop, "0")
    block["pil_img_s"] = pil_img_s
    if block["native_decode_available"]:
        nat_img_s, nat_stats = _ingest_feeder_img_s(path, batch, iters,
                                                    crop, "")
        block["native_img_s"] = nat_img_s
        block["native_speedup"] = nat_img_s / max(pil_img_s, 1e-9)
        block["fused_batches"] = nat_stats["fused_batches"]
        block["fused_records"] = nat_stats["fused_records"]
    else:
        block["native_img_s"] = None  # not measured: no codecs built
    cached_img_s, cache_stats = _ingest_feeder_img_s(
        path, batch, iters, crop, "", decoded_cache_mb=cache_mb, epochs=2)
    block["cached_img_s"] = cached_img_s
    block["cache_epoch2_decodes"] = cache_stats["decode_calls"]
    return block


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench_data")
    p.add_argument("-n", "--n", type=int, default=4096)
    p.add_argument("-batch", "--batch", type=int, default=256)
    p.add_argument("-shape", "--shape", default="3x256x256")
    p.add_argument("-crop", "--crop", type=int, default=227)
    p.add_argument("-backends", "--backends", default="lmdb,datumfile")
    p.add_argument("-device-transform", "--device-transform",
                   action="store_true",
                   help="stage raw uint8 and the decisions (the card "
                   "transforms) instead of transforming on the host")
    p.add_argument("-threads", "--threads", default="0",
                   help="comma list of Feeder thread counts to sweep "
                   "(0 = auto mode, the prototxt default)")
    p.add_argument("--json", action="store_true",
                   help="one JSON object instead of text lines")
    p.add_argument("--ingest-only", action="store_true",
                   help="only the encoded-LMDB ingest section")
    p.add_argument("--no-ingest", action="store_true",
                   help="only the backend sweep")
    p.add_argument("--ingest-n", type=int, default=0,
                   help="records of the encoded ingest DB (0 = "
                   "min(n, 1024))")
    args = p.parse_args(argv)
    shape = tuple(int(x) for x in args.shape.split("x"))
    sweeps = [int(t) for t in args.threads.split(",")]
    backends = [] if args.ingest_only else args.backends.split(",")
    for backend in backends:
        _check_backend(backend)  # before any dataset is written
    doc: dict = {"backends": []}
    iters = max(args.n // args.batch, 1)
    mode = "raw staging" if args.device_transform else "host transform"
    with tempfile.TemporaryDirectory() as workdir:
        if backends:
            imgs, labels = _make_records(args.n, shape)
        for backend in backends:
            t_build = time.perf_counter()
            path = _write_db(backend, workdir, imgs, labels)
            build_s = time.perf_counter() - t_build
            gather = _gather_ms(backend, path, args.batch, shape,
                                min(iters, 8))
            for threads in sweeps:
                feeder = _feeder_for(backend, path, args.batch, args.crop,
                                     threads, args.device_transform)
                feeder(0)  # warm the pool and the path decisions
                t0 = time.perf_counter()
                for it in range(1, iters + 1):
                    feeder(it)
                dt = time.perf_counter() - t0
                feeder.close()
                row = {"backend": backend, "mode": mode,
                       "threads": feeder.threads, "auto": feeder.auto,
                       "img_s": args.batch * iters / dt,
                       "build_ms_per_batch": feeder.feed_ms_per_batch(),
                       "gather_ms_per_batch": gather}
                doc["backends"].append(row)
                if not args.json:
                    print(f"{backend:>10}: {row['img_s']:8.0f} img/s "
                          f"({args.batch}x{args.shape}, crop {args.crop}, "
                          f"{mode}, {'auto ' if feeder.auto else ''}"
                          f"t={feeder.threads}, build "
                          f"{row['build_ms_per_batch']:.1f} ms/batch, "
                          "gather "
                          + ("none" if gather is None
                             else f"{gather:.1f} ms/batch")
                          + f", db {build_s:.1f} s)")
        if not args.no_ingest:
            n_ing = args.ingest_n or min(args.n, 1024)
            ing = run_ingest(workdir, n_ing, min(args.batch, n_ing), shape,
                             args.crop)
            doc["ingest"] = ing
            if not args.json:
                st = ing["stages_ms_per_batch"]
                print(f"    ingest: JPEG LMDB n={ing['n']} b={ing['batch']}"
                      f" crop={ing['crop']}, ms/batch: " + " ".join(
                          f"{k}={'not measured' if v is None else round(v, 2)}"
                          for k, v in st.items()))
                nat = ing["native_img_s"]
                print(f"    ingest: PIL {ing['pil_img_s']:.0f} img/s | "
                      "native fused "
                      + ("not measured (no codecs)" if nat is None
                         else f"{nat:.0f} img/s") +
                      f" | decoded-cache epoch 2 {ing['cached_img_s']:.0f}"
                      f" img/s ({ing['cache_epoch2_decodes']} decodes)")
    if args.json:
        print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
