"""Serving plan — the padded-batch bucket ladder.

Own copy of `plan_ladder`/`bucket_for` from the JAX package's
caffe_mpi_tpu/serving/plan.py (the port imports nothing of that package).
The static footprint and HBM-admission planning there is not ported yet.
"""

from __future__ import annotations

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
