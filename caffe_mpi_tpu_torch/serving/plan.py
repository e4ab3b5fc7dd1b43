"""Serving plan — the bucket ladder, the model's footprint and the HBM
admission.

Own copy of the JAX package's caffe_mpi_tpu/serving/plan.py (the port
imports nothing of that package): `plan_ladder`, `bucket_for`,
`declared_batch`, `plan_model` and `plan_admission`. The JAX package sizes
blobs with its shape engine before a model loads; the port reads them off
the loaded model's bucket nets, and its engine admits models through
`plan_admission` itself.
"""

from __future__ import annotations

import copy

# default bucket ladder: geometric x4 growth from 1 up to the model's
# max batch — small arrivals pay a small program, bursts fill max
DEFAULT_LADDER_GROWTH = 4


def plan_ladder(max_batch: int, spec=None) -> tuple[int, ...]:
    """Plan the padded-batch bucket ladder for a model.

    Returns ascending, deduplicated bucket sizes that always include
    `max_batch` (the largest program is the burst path). `spec` pins the
    ladder explicitly — a comma string ("1,4,16") or an iterable of
    ints; entries above `max_batch` are clipped out (the model cannot
    run them). None = geometric default 1, 4, 16, ... max_batch.
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if spec is None:
        sizes = []
        b = 1
        while b < max_batch:
            sizes.append(b)
            b *= DEFAULT_LADDER_GROWTH
        sizes.append(max_batch)
        return tuple(sizes)
    if isinstance(spec, str):
        parts = [p.strip() for p in spec.split(",") if p.strip()]
        try:
            spec = [int(p) for p in parts]
        except ValueError:
            raise ValueError(f"bad bucket ladder spec {spec!r}: expected "
                             "comma-separated ints like '1,4,16'") from None
    sizes = sorted(set(int(b) for b in spec))
    if not sizes:
        raise ValueError("empty bucket ladder spec")
    if sizes[0] < 1:
        raise ValueError(f"bucket sizes must be >= 1, got {sizes[0]}")
    sizes = [b for b in sizes if b <= max_batch]
    if not sizes or sizes[-1] != max_batch:
        sizes.append(max_batch)
    return tuple(sizes)


def bucket_for(n: int, ladder: tuple[int, ...]) -> int:
    """Smallest bucket holding n images (callers chunk at ladder[-1])."""
    if n < 1:
        raise ValueError(f"need at least one image, got {n}")
    for b in ladder:
        if b >= n:
            return b
    return ladder[-1]


def declared_batch(net_param) -> int:
    """The deploy prototxt's declared Input batch."""
    from ..proto.upgrade import normalize_net
    param = normalize_net(copy.deepcopy(net_param))
    for lp in param.layer:
        if lp.type == "Input" and lp.input_param and lp.input_param.shape:
            dims = lp.input_param.shape[0].dim
            if dims:
                return int(dims[0])
    raise ValueError("deploy net has no Input layer with a declared "
                     "shape; serving needs a deploy prototxt")


def rewrite_batch(net_param, bucket: int):
    """Normalized deep copy with every Input batch dim set to `bucket`."""
    from ..proto.upgrade import normalize_net
    param = normalize_net(copy.deepcopy(net_param))
    for lp in param.layer:
        if lp.type == "Input" and lp.input_param:
            for shape in lp.input_param.shape:
                if shape.dim:
                    shape.dim[0] = bucket
    return param


def plan_model(fwd, param_bytes: int) -> dict:
    """Per-model serving plan, read off a loaded model's own bucket nets
    (`fwd` is its BucketedForward): the bucket ladder and per-bucket
    activation bytes (every named blob's final shape x its layer's forward
    width: 2 bytes a bfloat16 element, else 4). `param_bytes` is the
    model's own count, the bytes the LRU charges (its parameters and state
    blobs, a shared tensor once); the JAX plan leaves state out, so the two
    agree for every net without BatchNorm."""
    import torch

    buckets = []
    for b in fwd.ladder:
        blob_bytes: dict[str, int] = {}
        for layer in fwd.net_for(b).layers:
            bpe = 2 if layer.policy.forward == torch.bfloat16 else 4
            for top, shape in zip(layer.lp.top, layer.out_shapes):
                n = 1
                for d in shape:
                    n *= int(d)
                blob_bytes[top] = n * bpe
        buckets.append({"bucket": b,
                        "activation_bytes": sum(blob_bytes.values()),
                        "unknown_shapes": False})
    return {
        "ladder": list(fwd.ladder),
        "dtype": fwd.dtype,
        "param_bytes": int(param_bytes),
        "param_bytes_exact": True,
        "peak_activation_bytes": max(
            b["activation_bytes"] for b in buckets),
        "buckets": buckets,
    }


def plan_admission(models: "list[tuple[str, int]]",
                   hbm_budget: int) -> dict:
    """The LRU admission policy over param bytes, `models` least recently
    used first: which models end resident, which spill, and whether a
    model alone exceeds the budget (kept resident anyway, with a warning).
    Budget 0 = unlimited: nothing ever spills. The engine's
    `_make_resident` spills what this plans."""
    resident: list[tuple[str, int]] = []
    spills: list[str] = []
    used = 0
    over = False
    for name, pbytes in models:
        pbytes = int(pbytes or 0)
        while hbm_budget and used + pbytes > hbm_budget and resident:
            victim, vbytes = resident.pop(0)  # load order = LRU first
            spills.append(victim)
            used -= vbytes
        if hbm_budget and used + pbytes > hbm_budget:
            over = True
        resident.append((name, pbytes))
        used += pbytes
    return {
        "hbm_budget_bytes": int(hbm_budget),
        "resident": [n for n, _ in resident],
        "planned_spills": spills,
        "planned_resident_bytes": used,
        "over_budget": over,
    }
