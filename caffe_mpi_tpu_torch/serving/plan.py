"""Static serving plan — the bucket ladder, the model's footprint and the
HBM admission, decided before a model touches the card.

The port's copy of the JAX package's `caffe_mpi_tpu/serving/plan.py`:
`plan_ladder`, `bucket_for`, `declared_batch`, `plan_model` and
`plan_admission`. Reference memory sizing is runtime-discovered —
`Net<Dtype>::Init` reshapes blobs layer by layer (net.cpp:77-166) and
capacity is whatever cudaMalloc grants mid-load. Here the torch-free
shape engine (proto/netshape.py) prices every bucket's activation bytes
and the model's learnable-param bytes from the prototxt alone, so the
engine's `load_model` plans a model before it builds or uploads anything
(`engine.stats()["plan"]`), and its LRU admits models through
`plan_admission`. `measured_plan` reads the same figures off a loaded
model's bucket nets: chip_smoke.py's `shapes` phase holds the two equal
on the card.
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
    """The deploy prototxt's declared Input batch (BucketedForward's
    max_batch when none is given)."""
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


def _count(shape) -> "int | None":
    if shape is None:
        return None
    n = 1
    for d in shape:
        if d is None:
            return None
        n *= int(d)
    return n


def plan_model(net_param, *, ladder=None, max_batch: int = 0,
               dtype: str = "f32") -> dict:
    """Static per-model serving plan: the bucket ladder plus per-bucket
    activation bytes (every named blob's final shape x its compute
    dtype width — FLOAT16 layers count 2 bytes/elem, matching
    netshape's dtype model) and the model's learnable-param bytes (f32
    host masters, shared params counted once). State blobs (BatchNorm
    running stats) are not statically modeled, so `param_bytes` is a
    floor for stateful nets — exact for stateless ones."""
    from ..proto.netshape import analyze_net
    precision = "" if dtype in ("", "f32") else dtype
    mb = max_batch or declared_batch(net_param)
    ladder = plan_ladder(mb, ladder)
    param_bytes = None
    unknown_params = False
    buckets = []
    for b in ladder:
        analysis = analyze_net(rewrite_batch(net_param, b), phase="TEST",
                               precision=precision)
        blob_bytes: dict[str, int] = {}
        unknown = False
        for info in analysis.layers:
            bpe = 2 if info.fwd_type == "FLOAT16" else 4
            for top, shape in zip(info.lp.top, info.out_shapes):
                n = _count(shape)
                if n is None:
                    unknown = True
                    continue
                blob_bytes[top] = n * bpe
        if param_bytes is None:
            seen: dict[str, int] = {}
            for info in analysis.layers:
                for pname, pi in info.params.items():
                    n = _count(pi.shape)
                    if n is None:
                        unknown_params = True
                        continue
                    seen[pi.shared_name or f"{info.name}/{pname}"] = n * 4
            param_bytes = sum(seen.values())
        buckets.append({
            "bucket": b,
            "activation_bytes": sum(blob_bytes.values()),
            "unknown_shapes": unknown,
        })
    return {
        "ladder": list(ladder),
        "dtype": dtype or "f32",
        "param_bytes": param_bytes or 0,
        "param_bytes_exact": not unknown_params,
        "peak_activation_bytes": max(
            b["activation_bytes"] for b in buckets),
        "buckets": buckets,
    }


def measured_plan(fwd, param_bytes: int) -> dict:
    """`plan_model`'s figures read off a loaded model instead of its
    prototxt (`fwd` is its BucketedForward): each bucket's activation
    bytes are the bytes of the blobs one forward of that bucket net holds
    on its device (every named blob's final tensor, numel x element size),
    and `param_bytes` is the model's own count (the bytes the LRU charges:
    its parameters and state blobs, a shared tensor once)."""
    import torch

    buckets = []
    for b in fwd.ladder:
        net = fwd.net_for(b)
        feed = net.feed_blobs[0]
        with torch.inference_mode():
            env, _ = net({feed: torch.zeros(net.blob_shapes[feed],
                                            device=fwd.device)})
        buckets.append({"bucket": b,
                        "activation_bytes": sum(
                            t.numel() * t.element_size()
                            for t in env.values()),
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
