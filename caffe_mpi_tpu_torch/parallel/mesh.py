"""Process group and data-parallel plan: the port's counterpart of the JAX
package's caffe_mpi_tpu/parallel/mesh.py.

The reference runs one worker per GPU over one global NCCL communicator
(parallel.cpp:166-169): rank 0 broadcasts the weights at start
(parallel.cpp:208-227) and the workers all-reduce their gradients every
iteration. The JAX package runs one SPMD program over a device mesh. The
port follows the reference: one process a rank over `torch.distributed`,
its backend fixed by the device layout (`backend_for`): NCCL when every
rank of a host has a card of its own, gloo on the CPU and where ranks
share a card (NCCL refuses two ranks on one device). The backend is never
chosen by trying NCCL and falling back.

- `resolve_cluster` reads `hosts` / `coordinator` / the host id from the
  solver and the CLI, with the JAX package's environment fallbacks;
- `init_distributed` forms the group over a TCPStore at `coordinator`
  (rank 0 serves it) with bounded retries and a timeout, and raises
  resilience.ClusterError when they run out; every collective has the
  group's timeout (`CAFFE_TPU_COLLECTIVE_TIMEOUT`, default 600 s);
- `MeshPlan` is this rank's place on the mesh's two axes, 'data' and
  'model' (`from_shape(data, model)`: rank r has data index r // model
  and model index r % model, the JAX `devs.reshape(data, model)`), and
  the collectives the solver and the layers issue. On 'data': `shard`
  (the batch slice of the rank's data index; a Dropout mask's too),
  `all_reduce_` (sum in place), `all_reduce_start` (the same, waited on
  later), `broadcast_` (from data index 0, the reference's ncclBcast:
  `replicate`), `all_gather` and ZeRO-1's `zero_slot_sharding`. On
  'model': `model_all_reduce_`, `model_all_gather`, `model_broadcast_`
  and `model_shift` (a ring send/recv, `batch_isend_irecv`), and the
  autograd regions of Megatron-style tensor parallelism built on them
  (`copy_to_model`, `reduce_from_model`, `gather_from_model`,
  `split_to_model`). Every rank creates every data group and every
  model group, in the same order. Under gloo a CUDA tensor is staged
  through pinned host memory explicitly. Each collective adds one to
  `collectives.launches` (a model-axis one its bytes to `sent`,
  `model_bytes`), which a captured CUDA graph adds again at every
  replay, as the kernel counters; `model_axis_only` is the rank's plan
  without its data axis;
- `param_sharding_rules` takes the JAX rule forms ("rows", a spec tuple,
  a per-param dict; any spec over 'data' and 'model') and returns a
  `Placement`: which mesh axes split which dims of which param, this
  rank's shard of a full array, and the gather (a collective) that
  rebuilds the full array; `gather_on_use` is that gather as an
  autograd region, for a layer with no model-parallel forward for its
  shards;
- `cluster_barrier` and `cluster_kv_set` / `cluster_kv_get` work on the
  group's store, never on the device.

- `heartbeat_transport` is the cross-host heartbeat's channel:
  `KVBeatTransport` over the group's store, or the shared directory's
  `DirBeatTransport` when CAFFE_TPU_HB_DIR is set;
  `cluster_generation` reads the generation the elastic supervisor
  launched this worker under (`min_hosts`), and `publish_generation`
  mirrors it onto the store.

The jax-version shims (typeof, vma, shard_map, axis_size, mark_varying)
have no counterpart here: they exist for a traced program.
"""

from __future__ import annotations

import datetime
import inspect
import logging
import os
import socket
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("caffe_mpi_tpu_torch.parallel")

# the live group's store (KV and barriers); set by init_distributed
_STORE = None
_BARRIERS: dict[str, int] = {}


class _Counter:
    """A launch counter in the kernels' form (`launches`, `__name__`): the
    solver's graph capture takes a capture's delta back and adds it at
    replays."""

    def __init__(self, name: str = "collectives"):
        self.__name__ = name
        self.launches = 0


class _Clock:
    """Whether a plan times its eager collectives (`MeshPlan.timing`),
    and the event recorded before the first of them."""

    def __init__(self):
        self.on = False
        self.origin = None


def resolve_cluster(sp=None, host_id: int | None = None):
    """(world, coordinator, rank) of the host cluster from the solver's
    `hosts` / `coordinator` and `host_id`, else CAFFE_TPU_NUM_HOSTS /
    CAFFE_TPU_COORDINATOR / CAFFE_TPU_HOST_ID (the JAX `resolve_cluster`;
    the reference reads the same facts from mpirun's environment,
    clusters.cpp:8-45). world <= 1 is one host. An incomplete multi-host
    configuration raises ClusterError."""
    from ..utils import resilience
    world = int(getattr(sp, "hosts", 0) or 0) if sp is not None else 0
    if world <= 0:
        world = int(os.environ.get("CAFFE_TPU_NUM_HOSTS", "0") or 0)
    coordinator = (str(getattr(sp, "coordinator", "") or "")
                   if sp is not None else "")
    if not coordinator:
        coordinator = os.environ.get("CAFFE_TPU_COORDINATOR", "")
    rank = host_id if host_id is not None and host_id >= 0 else int(
        os.environ.get("CAFFE_TPU_HOST_ID", "-1") or -1)
    if world > 1:
        if not coordinator:
            raise resilience.ClusterError(
                f"hosts={world} but no coordinator: set the solver "
                "`coordinator` knob, -coordinator, or "
                "CAFFE_TPU_COORDINATOR")
        if not 0 <= rank < world:
            raise resilience.ClusterError(
                f"hosts={world} needs a host id in [0, {world}): set "
                "-host_id or CAFFE_TPU_HOST_ID")
    return world, coordinator, rank


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(devices, hosts: int = 1) -> str:
    """"nccl" when every device is a card and no card of a host serves
    two ranks; else "gloo". `devices` lists every rank's device, host by
    host (hosts equal slices)."""
    devs = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devs):
        return "gloo"
    per = max(len(devs) // max(hosts, 1), 1)
    for h in range(0, len(devs), per):
        idx = [d.index or 0 for d in devs[h:h + per]]
        if len(set(idx)) != len(idx):
            return "gloo"
    return "nccl"


def local_coordinator(coordinator: str | None = None) -> bool:
    """Whether `coordinator` (host:port; default the live group's store)
    is this machine's loopback: then every host process runs on this
    machine and shares its cards."""
    if coordinator is None:
        if _STORE is None:
            return False
        coordinator = f"{_STORE.host}:{_STORE.port}"
    host = coordinator.rpartition(":")[0].strip("[]")
    return host in ("127.0.0.1", "localhost", "::1")


def _timeout(env: str, default: float) -> float:
    return float(os.environ.get(env, "") or default)


# distributed init: attempts, and the first backoff (doubled each retry)
INIT_ATTEMPTS = 3
INIT_BASE_DELAY_S = 1.0


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     *, backend: str = "gloo",
                     device: torch.device | None = None) -> None:
    """Form the process group (reference Clusters::Init, the ncclUniqueId
    handshake): a TCPStore at `coordinator` (host:port; rank 0 serves
    it), then `init_process_group` over it with the collective timeout.
    Each of INIT_ATTEMPTS attempts is bounded by CAFFE_TPU_INIT_TIMEOUT
    (default 60 s) and backs off through `resilience.retrying`;
    exhaustion raises ClusterError (the CLI journals it and exits 87),
    never a hang. The `coordinator_down` fault site fails the first
    attempts."""
    global _STORE
    from ..utils import resilience
    from ..utils.resilience import FAULTS
    if dist.is_initialized():
        raise resilience.ClusterError("a process group is already live")
    store_timeout = datetime.timedelta(
        seconds=_timeout("CAFFE_TPU_INIT_TIMEOUT", 60.0))
    coll_timeout = datetime.timedelta(seconds=_timeout(
        "CAFFE_TPU_COLLECTIVE_TIMEOUT", 600.0))
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise resilience.ClusterError(
            f"coordinator {coordinator!r} is not host:port")
    kw = {}
    if backend == "nccl" and device is not None and "device_id" in \
            inspect.signature(dist.init_process_group).parameters:
        kw["device_id"] = device  # eager NCCL communicator on this card

    def attempt():
        try:
            FAULTS.maybe_raise("coordinator_down", RuntimeError,
                               "injected coordinator outage")
            store = dist.TCPStore(host, int(port), num_processes,
                                  process_id == 0, timeout=store_timeout,
                                  wait_for_workers=False)
            dist.init_process_group(backend, store=store, rank=process_id,
                                    world_size=num_processes,
                                    timeout=coll_timeout, **kw)
            return store
        except Exception:
            if dist.is_initialized():
                dist.destroy_process_group()
            raise

    try:
        _STORE = resilience.retrying(
            attempt, attempts=INIT_ATTEMPTS, base_delay=INIT_BASE_DELAY_S,
            max_delay=30.0, exc_types=(Exception,),
            desc=f"distributed init against {coordinator}")
    except Exception as e:  # noqa: BLE001 — every failure is a ClusterError
        raise resilience.ClusterError(
            f"distributed init failed after {INIT_ATTEMPTS} attempt(s) "
            f"against coordinator {coordinator!r}: {e}") from e
    log.info("process group: rank %d/%d over %s (coordinator %s)",
             process_id, num_processes, backend, coordinator)


def shutdown_distributed() -> None:
    """Tear the group down (after the exit barrier); a group already
    gone is fine."""
    global _STORE
    if dist.is_initialized():
        dist.destroy_process_group()
    _STORE = None
    _BARRIERS.clear()


def cluster_barrier(name: str, timeout_s: float | None = None) -> bool:
    """Every rank reaches `name` (snapshot commit, end of training) on
    the store, off the device, within `timeout_s` (default the collective
    timeout). True on success, False on a timeout or a dead store
    (callers journal EXIT_CLUSTER); True with no group."""
    if _STORE is None:
        return True
    if timeout_s is None:
        timeout_s = _timeout("CAFFE_TPU_COLLECTIVE_TIMEOUT", 600.0)
    n = _BARRIERS[name] = _BARRIERS.get(name, 0) + 1
    key = f"caffe/barrier/{name}/{n}"
    try:
        _STORE.add(key, 1)
        deadline = time.monotonic() + timeout_s
        world = dist.get_world_size()
        while int(_STORE.add(key, 0)) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{name}: waited {timeout_s:g}s")
            time.sleep(0.005)
        return True
    # lint: ok(typed-failure) — False is the typed result the caller acts on
    # (the barrier failed), logged
    except Exception as e:  # noqa: BLE001 — False is the typed result
        log.error("cluster barrier %r failed: %s", name, e)
        return False


def cluster_kv_set(key: str, value: str) -> bool:
    """Publish `value` under `key` on the store (rank 0's resume
    decision). False with no group or a dead store."""
    if _STORE is None:
        return False
    try:
        _STORE.set(key, value)
        return True
    # lint: ok(typed-failure) — False is the typed result the caller acts on,
    # logged
    except Exception as e:  # noqa: BLE001 — False is the typed result
        log.error("cluster kv set %r failed: %s", key, e)
        return False


def cluster_kv_get(key: str, timeout_s: float = 120.0) -> str | None:
    """Wait for `key` on the store. None on a timeout, a dead store or no
    group."""
    if _STORE is None:
        return None
    try:
        _STORE.wait([key], datetime.timedelta(seconds=timeout_s))
        return _STORE.get(key).decode()
    # lint: ok(typed-failure) — None is the typed result the caller acts on,
    # logged
    except Exception as e:  # noqa: BLE001 — None is the typed result
        log.error("cluster kv get %r failed: %s", key, e)
        return None


class KVBeatTransport:
    """Heartbeat transport over the group's store (the channel the
    cluster already trusts for its formation): `caffe_hb/<host>` holds a
    host's newest beat, overwritten a beat (the store allows it, so
    nothing is pruned), and `caffe_hb/<host>/bye` its farewell. Readers
    take the latest beat, never an exact one. A dead store makes every
    call raise, which the heartbeat reads as silence: the cluster then
    exits 87 within a deadline."""

    _PREFIX = "caffe_hb"

    def __init__(self, store=None):
        self._store = store if store is not None else _STORE
        if self._store is None:
            from ..utils import resilience
            raise resilience.ClusterError(
                "no process group: KVBeatTransport needs init_distributed "
                "first (or set CAFFE_TPU_HB_DIR for the shared-directory "
                "transport)")

    def publish(self, host: int, seq: int) -> None:
        self._store.set(f"{self._PREFIX}/{int(host)}", str(int(seq)))

    def latest_seq(self, host: int) -> int:
        """The newest beat `host` has published, -1 when none."""
        key = f"{self._PREFIX}/{int(host)}"
        if not self._store.check([key]):
            return -1
        return int(self._store.get(key).decode())

    def farewell(self, host: int) -> None:
        self._store.set(f"{self._PREFIX}/{int(host)}/bye", "1")

    def is_bye(self, host: int) -> bool:
        return bool(self._store.check([f"{self._PREFIX}/{int(host)}/bye"]))


def heartbeat_transport():
    """The heartbeat's channel: the shared directory CAFFE_TPU_HB_DIR when
    set, else the group's store."""
    from ..utils import resilience
    hb_dir = os.environ.get("CAFFE_TPU_HB_DIR", "")
    if hb_dir:
        return resilience.DirBeatTransport(hb_dir)
    return KVBeatTransport()


def cluster_generation() -> dict | None:
    """The generation record this worker was launched under, as the
    elastic supervisor (`resilience.supervise_elastic`) exports it:
    {"generation", "hosts", "world_full", "self"}; None outside a
    min_hosts run."""
    gen = os.environ.get("CAFFE_TPU_CLUSTER_GEN", "")
    hosts = os.environ.get("CAFFE_TPU_CLUSTER_HOSTS", "")
    if not gen or not hosts:
        return None
    try:
        return {
            "generation": int(gen),
            "hosts": [int(h) for h in hosts.split(",") if h != ""],
            "world_full": int(
                os.environ.get("CAFFE_TPU_WORLD_FULL", "0") or 0),
            "self": int(os.environ.get("CAFFE_TPU_CLUSTER_SELF", "-1")
                        or -1),
        }
    except ValueError:
        return None


def publish_generation() -> bool:
    """Mirror the live generation record onto the store at
    `caffe/cluster_gen` (rank 0, after formation); the supervisors'
    directory stays the source of truth. False outside a min_hosts run
    or with no store."""
    gen = cluster_generation()
    if gen is None:
        return False
    import json
    return cluster_kv_set("caffe/cluster_gen",
                          json.dumps(gen, sort_keys=True))


def needs_collective_gather(sharded) -> bool:
    """True when exporting state involves a collective: some entry of
    `sharded` (the solver's ZeRO-1 slot shards, {key: dim-0 shard
    length or None}) lives split over the ranks. Every rank must then
    reach the gather, in the same order."""
    return any(v is not None for v in sharded.values())


def union_ms(spans) -> float:
    """The length of the union of (start, end) intervals."""
    ms, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            ms += b - max(a, end)
            end = b
    return ms


def _collective(op, *args, **kw):
    """`op(*args, **kw)`, a torch.distributed call or a wait on one; its
    failure raised as resilience.CollectiveError, the one error the CLI
    hands to the heartbeat."""
    from ..utils import resilience
    try:
        return op(*args, **kw)
    except RuntimeError as e:
        raise resilience.CollectiveError(
            f"{getattr(op, '__name__', 'collective')} failed: {e}") from e


class _Pending:
    """An all-reduce in flight: `wait` joins it, copies a staged result
    back to the card and records the end of its timing pair."""

    def __init__(self, work, host=None, dest=None, pair=None):
        self.work, self.host, self.dest, self.pair = work, host, dest, pair

    def wait(self) -> None:
        if self.work is not None:
            _collective(self.work.wait)
        if self.host is not None:
            self.dest.copy_(self.host, non_blocking=True)
        if self.pair:
            self.pair[1].record()


@dataclass
class MeshPlan:
    """This rank's place on the 'data' and 'model' axes, and its
    collectives. `rank` is the rank in the whole group; the data-axis
    collectives run over `data_group` (the ranks of this model index),
    the model-axis ones over `model_group` (the ranks of this data
    index). With one model rank the data group is the whole group."""

    n_data: int
    rank: int
    device: torch.device
    backend: str
    hosts: int = 1
    n_model: int = 1
    data_group: object = None
    model_group: object = None
    collectives: _Counter = field(default_factory=_Counter)
    # CUDA event pairs around eager collectives while `timing` is on, and
    # whether it is on with the event recorded before the first of them
    # (their common origin): shared with the plan's views
    events: list = field(default_factory=list)
    clock: _Clock = field(default_factory=_Clock)
    # the bytes the model-axis collectives sent (`model_bytes`), a counter
    # that a captured graph adds again at every replay
    sent: _Counter = field(default_factory=lambda: _Counter("model_bytes"))
    _pinned: dict = field(default_factory=dict)

    @classmethod
    def from_shape(cls, data: int, model: int = 1, devices=None,
                   hosts: int = 1) -> "MeshPlan":
        """A mesh of `data` x `model` ranks over `devices` (every rank's
        device, host by host; default every card of this host). The group
        must be live with data x model ranks; with none and one rank, a
        group of one is formed here on a free local port. Every rank
        calls this, and creates every axis group in the same order. Host
        processes behind a loopback coordinator share one machine's
        cards, and the backend is chosen as for one host."""
        from ..utils import resilience
        if data < 1 or model < 1:
            raise ValueError(f"mesh {data}x{model}: axes must be >= 1")
        if devices is None:
            devices = _cards() * max(hosts, 1)
        devices = [torch.device(d) for d in devices]
        world_want = data * model
        if len(devices) != world_want:
            raise ValueError(f"mesh {data}x{model} needs {world_want} "
                             f"devices, have {len(devices)}")
        backend = backend_for(devices, 1 if local_coordinator() else hosts)
        if not dist.is_initialized():
            if world_want != 1:
                raise resilience.ClusterError(
                    f"a mesh of {world_want} ranks needs the process group: "
                    "call init_distributed first")
            init_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                             backend=backend, device=devices[0])
        world, rank = dist.get_world_size(), dist.get_rank()
        if world != world_want:
            raise ValueError(f"mesh data={data} model={model} but the "
                             f"process group has {world} ranks")
        live = dist.get_backend()
        if live != backend:
            raise ValueError(f"the device layout needs {backend}, the "
                             f"group runs {live}")
        device = devices[rank]
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("a mesh over cards, but "
                                   "torch.cuda.is_available() is False")
            torch.cuda.set_device(device)
        data_group = model_group = None
        if model > 1:
            # every rank creates every group, in this order
            for d in range(data):
                g = dist.new_group([d * model + m for m in range(model)])
                if rank // model == d:
                    model_group = g
            for m in range(model):
                g = dist.new_group([d * model + m for d in range(data)])
                if rank % model == m:
                    data_group = g
        return cls(n_data=data, rank=rank, device=device, backend=backend,
                   hosts=hosts, n_model=model, data_group=data_group,
                   model_group=model_group)

    @property
    def timing(self) -> bool:
        return self.clock.on

    @timing.setter
    def timing(self, on: bool) -> None:
        self.clock.on = on

    @property
    def model_bytes(self) -> int:
        return self.sent.launches

    @model_bytes.setter
    def model_bytes(self, n: int) -> None:
        self.sent.launches = n

    def model_axis_only(self) -> "MeshPlan":
        """This rank's plan with the data axis taken away (its collectives
        over 'data' do nothing, its data index is 0; the model group, the
        counters, the timing and the staging buffers shared): for a net
        every rank runs on the whole batch, such as a test net whose
        batch does not divide the data ranks."""
        return replace(self, n_data=1, data_group=None)

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model if self.n_data > 1 else 0

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    def global_rank(self, data_index: int, model_index: int) -> int:
        return data_index * self.n_model + model_index

    def model_peer(self, model_index: int) -> int:
        """The global rank of `model_index` in this rank's model group."""
        return self.rank - self.model_index + model_index

    def param_sharding_rules(self, rules) -> "Placement":
        """The JAX rule forms over the 'model' axis: {layer: "rows" | a
        spec tuple | {param: spec tuple | "rows"}}. "rows" splits a
        weight's dim 0 and its bias (the output dim); a spec tuple names
        "model" at the dim it splits; a dict gives each listed param its
        own spec. Returns the Placement (module docstring)."""
        return Placement(self, rules)

    # -- collectives ----------------------------------------------------
    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _host(self, t: torch.Tensor, slot: int = 0) -> torch.Tensor:
        """A pinned host buffer of t's size and type, reused; tensors in
        flight together take different `slot`s."""
        key = (t.numel(), t.dtype, slot)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(
                t.numel(), dtype=t.dtype, pin_memory=True)
        return buf.view(t.shape)

    def _staged_call(self, op, t: torch.Tensor, **kw) -> torch.Tensor:
        """`op(t, **kw)`, a collective in place on `t`; on a card under
        gloo through a pinned host copy of it. Returns `t`."""
        if not self._staged(t):
            _collective(op, t, **kw)
            return t
        host = self._host(t)
        host.copy_(t)
        _collective(op, host, **kw)
        return t.copy_(host)

    def _timed(self):
        """A (start, end) CUDA event pair to record around a collective,
        or None."""
        if not (self.timing and self.device.type == "cuda") or \
                torch.cuda.is_current_stream_capturing():
            return None
        if self.clock.origin is None:
            self.clock.origin = torch.cuda.Event(enable_timing=True)
            self.clock.origin.record()
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        self.events.append(pair)
        return pair

    def all_reduce_start(self, t: torch.Tensor,
                         host: torch.Tensor | None = None) -> _Pending:
        """Start a sum of `t` over the data axis, in place; `wait()` on
        the result joins it. On a card under gloo `t` is copied to pinned
        host memory now (`host`, else a new buffer: two sums in flight
        never share one), the sum runs on gloo's thread, and `wait`
        copies it back. Timed from here to the end of `wait`."""
        self.collectives.launches += 1
        pair = self._timed()
        if pair:
            pair[0].record()
        if self.n_data == 1 and (self.backend == "gloo" or self.n_model > 1):
            return _Pending(None, pair=pair)
        g = self.data_group
        if self._staged(t):
            if host is None:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            return _Pending(_collective(dist.all_reduce, host, group=g,
                                        async_op=True), host, t, pair)
        return _Pending(_collective(dist.all_reduce, t, group=g,
                                    async_op=True), pair=pair)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the data axis, in place; returns `t`."""
        self.all_reduce_start(t).wait()
        return t

    def world_all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over every rank of both axes, in place (a decision
        all ranks must share: a signal's request, the guard's check)."""
        if self.n_model == 1:
            return self.all_reduce_(t)
        self.collectives.launches += 1
        return self._staged_call(dist.all_reduce, t)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Data index `src`'s `t` on every rank of the data axis, in
        place."""
        self.collectives.launches += 1
        if self.n_data == 1 and self.n_model > 1:
            return t
        return self._staged_call(
            dist.broadcast, t, src=self.global_rank(src, self.model_index),
            group=self.data_group)

    def _gather(self, t: torch.Tensor, n: int, group) -> torch.Tensor:
        src = t.contiguous()
        if n == 1:
            return src.unsqueeze(0)
        if self._staged(src):
            host = self._host(src).copy_(src)
            parts = [torch.empty_like(host) for _ in range(n)]
            _collective(dist.all_gather, parts, host, group=group)
            return torch.stack(parts).to(t.device)
        if self.backend == "gloo":
            parts = [torch.empty_like(src) for _ in range(n)]
            _collective(dist.all_gather, parts, src, group=group)
            return torch.stack(parts)
        out = torch.empty(n * src.numel(), dtype=src.dtype,
                          device=src.device)
        _collective(dist.all_gather_into_tensor, out, src.reshape(-1),
                    group=group)
        return out.view(n, *src.shape)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's `t`, stacked on a new dim 0 in data order."""
        pair = self._timed()
        if pair:
            pair[0].record()
        self.collectives.launches += 1
        out = self._gather(t, self.n_data, self.data_group)
        if pair:
            pair[1].record()
        return out

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch of a batch-split `t`: every data rank's rows
        in data order (the inverse of `shard`)."""
        return self.all_gather(t).flatten(0, 1)

    # -- the 'model' axis -----------------------------------------------
    def _model_timed(self, t: torch.Tensor):
        self.collectives.launches += 1
        self.model_bytes += t.numel() * t.element_size()
        pair = self._timed()
        if pair:
            pair[0].record()
        return pair

    def model_all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the model axis, in place; returns `t`."""
        pair = self._model_timed(t)
        if self.n_model > 1:
            self._staged_call(dist.all_reduce, t, group=self.model_group)
        if pair:
            pair[1].record()
        return t

    def model_all_gather(self, t: torch.Tensor, dim: int = 0
                         ) -> torch.Tensor:
        """The model ranks' `t`, concatenated along `dim` in model
        order."""
        pair = self._model_timed(t)
        parts = self._gather(t, self.n_model, self.model_group)
        out = torch.cat(parts.unbind(0), dim=dim)
        if pair:
            pair[1].record()
        return out

    def model_broadcast_(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Model index `src`'s `t` on every rank of the model axis, in
        place."""
        pair = self._model_timed(t)
        if self.n_model > 1:
            self._staged_call(dist.broadcast, t,
                              src=self.model_peer(src),
                              group=self.model_group)
        if pair:
            pair[1].record()
        return t

    def model_shift(self, tensors, shift: int = -1) -> list[torch.Tensor]:
        """A ring step over the model axis: each of `tensors` goes to
        model index (m + shift) mod n, and what model index (m - shift)
        mod n sent comes back (new tensors). shift -1 is the JAX ring's
        `ppermute` j -> j - 1. One batch of send/recv pairs."""
        n = self.n_model
        tensors = [t.contiguous() for t in tensors]
        if n == 1 or shift % n == 0:
            return [t.clone() for t in tensors]
        self.collectives.launches += len(tensors)
        self.model_bytes += sum(t.numel() * t.element_size()
                                for t in tensors)
        pair = self._timed()
        if pair:
            pair[0].record()
        to = self.model_peer((self.model_index + shift) % n)
        frm = self.model_peer((self.model_index - shift) % n)
        # under gloo on a card each tensor goes through pinned host
        # memory, the sends and the receives in slots of their own
        staged = [self._staged(t) for t in tensors]
        sends = [self._host(t, 2 * i).copy_(t) if st else t
                 for i, (t, st) in enumerate(zip(tensors, staged))]
        recvs = [self._host(t, 2 * i + 1) if st else torch.empty_like(t)
                 for i, (t, st) in enumerate(zip(tensors, staged))]
        ops = []
        for snd, rcv in zip(sends, recvs):
            ops.append(dist.P2POp(dist.isend, snd, to,
                                  group=self.model_group))
            ops.append(dist.P2POp(dist.irecv, rcv, frm,
                                  group=self.model_group))
        for work in _collective(dist.batch_isend_irecv, ops):
            _collective(work.wait)
        out = [r.to(t.device) if st else r
               for r, t, st in zip(recvs, tensors, staged)]
        if pair:
            pair[1].record()
        return out

    def collective_ms(self) -> float:
        """Device ms during which at least one timed collective was in
        flight since the last call: the union of the event pairs'
        intervals (under reduce_overlap the buckets' pairs overlap each
        other and backward; a sum would count that time once per bucket).
        Synchronises."""
        if not self.events:
            return 0.0
        torch.cuda.synchronize(self.device)
        o = self.clock.origin
        ms = union_ms([(o.elapsed_time(a), o.elapsed_time(b))
                       for a, b in self.events])
        self.events.clear()
        self.clock.origin = None
        return ms

    def replicate(self, tensors) -> None:
        """Data index 0's values of `tensors` on every data rank (the
        reference's startup ncclBcast of all weights,
        parallel.cpp:208-227). The model ranks of one data index hold
        alike what they replicate: the same seed, the same files."""
        with torch.no_grad():
            for t in tensors:
                self.broadcast_(t)

    # -- batches --------------------------------------------------------
    def shard(self, x, batch_axis: int = 0):
        """This rank's slice of a global batch along `batch_axis`: the
        slice of its data index (the model ranks of a data index take the
        same slice)."""
        b = x.shape[batch_axis] // self.n_data
        lo = self.data_index * b
        return x.narrow(batch_axis, lo, b) \
            if isinstance(x, torch.Tensor) else \
            x.take(range(lo, lo + b), axis=batch_axis)

    def zero_slot_sharding(self, shape) -> int | None:
        """ZeRO-1: the dim-0 length of this rank's shard of a slot of
        `shape` (dim 0 split over 'data'), or None (replicated) when dim
        0 does not divide n_data or there is one rank."""
        if self.n_data <= 1 or not shape or shape[0] % self.n_data:
            return None
        return shape[0] // self.n_data


# ---------------------------------------------------------------------------
# Megatron-style tensor-parallel regions over the 'model' axis
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Forward identity; backward the sum over the model ranks (the
    input of a column-parallel product is read by every shard)."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.plan.model_all_reduce_(dy.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    """Forward the sum over the model ranks (the partial products of a
    row-parallel product); backward identity."""

    @staticmethod
    def forward(ctx, x, plan):
        return plan.model_all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherFromModel(torch.autograd.Function):
    """Forward the model ranks' pieces concatenated along `dim`; backward
    this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, plan, dim):
        ctx.plan, ctx.dim, ctx.size = plan, dim, x.shape[dim]
        return plan.model_all_gather(x, dim)

    @staticmethod
    def backward(ctx, dy):
        lo = ctx.plan.model_index * ctx.size
        return dy.narrow(ctx.dim, lo, ctx.size).contiguous(), None, None


class _SplitToModel(torch.autograd.Function):
    """Forward this rank's slice along `dim`; backward the model ranks'
    gradient slices concatenated."""

    @staticmethod
    def forward(ctx, x, plan, dim):
        n = plan.n_model
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split over {n} model ranks")
        size = x.shape[dim] // n
        ctx.plan, ctx.dim = plan, dim
        return x.narrow(dim, plan.model_index * size, size).contiguous()

    @staticmethod
    def backward(ctx, dy):
        return ctx.plan.model_all_gather(dy.contiguous(), ctx.dim), None, \
            None


def copy_to_model(x, plan):
    return _CopyToModel.apply(x, plan)


def reduce_from_model(x, plan):
    return _ReduceFromModel.apply(x, plan)


def gather_from_model(x, plan, dim):
    return _GatherFromModel.apply(x, plan, dim % x.dim())


def split_to_model(x, plan, dim):
    return _SplitToModel.apply(x, plan, dim % x.dim())


class _GatherRowsFromData(torch.autograd.Function):
    """Forward the data ranks' rows concatenated along dim 0 (the global
    batch's tokens); backward the sum of the ranks' gradients, this
    rank's rows of it (a reduce-scatter): a row's gradient reaches every
    rank whose loss reads it (MoE's load-balancing loss reads every
    token)."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan, ctx.rows = plan, x.shape[0]
        parts = plan.all_gather(x)
        return parts.reshape(-1, *x.shape[1:])

    @staticmethod
    def backward(ctx, dy):
        dy = ctx.plan.all_reduce_(dy.contiguous().clone())
        lo = ctx.plan.data_index * ctx.rows
        return dy[lo:lo + ctx.rows], None


def gather_rows_from_data(x, plan):
    return _GatherRowsFromData.apply(x, plan)


AXES = ("data", "model")


def spec_slices(spec, shape, mesh_shape, coords) -> list[tuple[int, int]]:
    """The [lo, hi) a dim of the whole array of `shape` that the rank at
    `coords` (data index, model index) of a mesh of `mesh_shape` holds
    under `spec` (`Placement.spec`: a dim over several axes indexes them
    major to minor). A dim that does not split raises ValueError."""
    sizes = dict(zip(AXES, mesh_shape))
    index = dict(zip(AXES, coords))
    out = []
    for d, n in enumerate(shape):
        axes = spec[d] if spec is not None else ()
        parts, idx = 1, 0
        for a in axes:
            parts, idx = parts * sizes[a], idx * sizes[a] + index[a]
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {parts} ranks of {axes}")
        size = n // parts
        out.append((idx * size, (idx + 1) * size))
    return out


class _GatherOnUse(torch.autograd.Function):
    """Forward the whole param from this rank's shard (`Placement.
    gather_spec`); backward this rank's slice of the gradient. Over
    'model' the gradients are already equal (the model ranks of a data
    index see the same batch); over 'data' they are summed over the data
    ranks and divided by N first (a reduce-scatter in the Reducer's
    place: such a param is not in its buffers)."""

    @staticmethod
    def forward(ctx, p, placement, spec):
        ctx.placement, ctx.spec = placement, spec
        return placement.gather_spec(spec, p.detach())

    @staticmethod
    def backward(ctx, g):
        plan = ctx.placement.plan
        g = g.contiguous()
        if any("data" in axes for axes in ctx.spec) and plan.n_data > 1:
            g = plan.all_reduce_(g.clone()) / plan.n_data
        return ctx.placement.local_spec(ctx.spec, g).contiguous(), None, \
            None


def gather_on_use(p, placement, spec):
    """The whole of a param this rank holds a shard of (`spec`), as an
    autograd region: a layer with no model-parallel forward for that
    shard runs on it."""
    return _GatherOnUse.apply(p, placement, spec)


class Placement:
    """The placement of `param_sharding_rules` (the JAX rule forms):
    `spec(layer, param, ndim)` names, dim by dim, the mesh axes that
    split the param (a tuple of axis tuples; None: replicated),
    `model_dim` the one dim a model-parallel forward takes (a spec that
    splits one dim over 'model' alone), `local_spec` this rank's shard of
    a full array and `gather_spec` the full array from the ranks' shards
    (a collective over the axes that split it: every rank calls it, in
    the same order); `Net.place` keeps each param's spec. A dim
    split over several axes indexes them major to minor, as a JAX
    PartitionSpec entry ("data", "model") does."""

    def __init__(self, plan: MeshPlan, rules: dict):
        self.plan = plan
        self.rules = dict(rules or {})
        for lname, rule in self.rules.items():
            specs = rule.values() if isinstance(rule, dict) else [rule]
            for spec in specs:
                if isinstance(spec, str):
                    if spec != "rows":
                        raise ValueError(
                            f"rule for {lname!r} must be a spec tuple or "
                            f"'rows', got {spec!r}")
                    continue
                for entry in spec:
                    axes = entry if isinstance(entry, (tuple, list)) \
                        else (entry,)
                    bad = [a for a in axes if a is not None
                           and a not in AXES]
                    if bad:
                        raise ValueError(
                            f"rule {spec!r} for {lname!r}: unknown mesh "
                            f"axes {bad} (the mesh has {AXES})")

    def _normalize(self, spec, ndim: int) -> tuple | None:
        """A rule's spec as one tuple of axes a dim (the JAX padding and
        truncation to the array's rank), an axis of one rank dropped (a
        split over it is the whole array, as in JAX); None when nothing
        is split."""
        if spec == "rows":
            spec = ("model",)
        sizes = {"data": self.plan.n_data, "model": self.plan.n_model}
        out = []
        for entry in list(spec)[:ndim]:
            axes = entry if isinstance(entry, (tuple, list)) else (entry,)
            out.append(tuple(a for a in axes
                             if a is not None and sizes[a] > 1))
        out += [()] * (ndim - len(out))
        return tuple(out) if any(out) else None

    def spec(self, lname: str, pname: str, ndim: int) -> tuple | None:
        """The JAX `param_sharding_rules` placement of one param: a
        per-param dict's own spec; a layer rule's spec for `weight`, and
        for `bias` ("model" on its only dim) when the rule splits the
        weight's dim 0 over 'model' alone (the per-output bias follows).
        At any mesh size: a split over an axis of one rank is no split."""
        rule = self.rules.get(lname)
        if rule is None:
            return None
        if isinstance(rule, dict):
            spec = rule.get(pname)
        elif pname == "weight":
            spec = rule
        elif pname == "bias" and ndim >= 1 and (
                rule == "rows" or (len(rule) > 0 and rule[0] == "model")):
            spec = ("model",)
        else:
            spec = None
        return None if spec is None else self._normalize(spec, ndim)

    @staticmethod
    def model_dim(spec) -> int | None:
        """The dim a spec splits, when it splits one dim over 'model'
        alone (what a model-parallel forward takes); else None."""
        if spec is None:
            return None
        split = [d for d, axes in enumerate(spec) if axes]
        if len(split) == 1 and spec[split[0]] == ("model",):
            return split[0]
        return None

    def full_shape(self, spec, shape) -> tuple:
        """The whole shape of which `shape` is a shard under `spec`."""
        if spec is None:
            return tuple(shape)
        sizes = {"data": self.plan.n_data, "model": self.plan.n_model}
        # lint: ok(host-sync) — shape arithmetic on host ints
        return tuple(n * int(np.prod([sizes[a] for a in axes]))
                     for n, axes in zip(shape, spec))

    def local_spec(self, spec, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the full array `t` under `spec`."""
        if spec is None:
            return t
        plan = self.plan
        for d, (lo, hi) in enumerate(spec_slices(
                spec, t.shape, (plan.n_data, plan.n_model),
                (plan.data_index, plan.model_index))):
            if hi - lo != t.shape[d]:
                t = t.narrow(d, lo, hi - lo)
        return t

    def gather_spec(self, spec, t: torch.Tensor) -> torch.Tensor:
        """The full array from the ranks' shards under `spec`: each split
        dim gathered over its axes, minor axis first."""
        if spec is None:
            return t
        plan = self.plan
        for d, axes in enumerate(spec):
            for a in reversed(axes):
                if a == "model":
                    t = plan.model_all_gather(t, d)
                else:
                    t = torch.cat(plan.all_gather(t).unbind(0), dim=d)
        return t


def _cards() -> list[str]:
    """Every card of this host; raises without one (`-gpu all` on a
    machine with no card)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError("-gpu all / a mesh over cards, but "
                           "torch.cuda.is_available() is False")
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
