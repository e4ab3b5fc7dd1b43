"""One data-parallel rank of the port's tests (tests/test_torch_parallel.py,
test_torch_reduction.py, test_torch_zero.py), run as its own process:

    python tests/torch_dp_worker.py SPEC RANK WORLD PORT OUT

It imports torch, numpy and the port only. It forms a gloo group of WORLD
ranks on the CPU at 127.0.0.1:PORT (every collective bounded by
CAFFE_TPU_COLLECTIVE_TIMEOUT) and a mesh of data x model ranks over it
(SPEC's "mesh"; data = WORLD by default), then runs each scenario of the
pickled SPEC's "scenarios" (a list of dicts) and pickles {scenario
name: result} to OUT/r<RANK>.pkl. A scenario ("kind") trains a port
Solver from a solver prototxt on its data index's slice of the given
global feeds (with the given global Dropout masks, JAX initial weights,
`param_shardings` and optional NaN poison; "train", the default), checks
BatchNorm alone ("bn"), runs the ring over the model ranks on global
q, k, v with an upstream gradient ("ring"), pipeline_apply of a given
stage function ("pipeline"), or moe_ffn with its experts split over the
model ranks ("moe"), resumes the newest verified snapshot of a
prefix, trains on and snapshots ("resume"), or restores a given
snapshot on this mesh ("restore").
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from caffe_mpi_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from caffe_mpi_tpu_torch.proto import SolverParameter  # noqa: E402
from caffe_mpi_tpu_torch.solver import Solver  # noqa: E402
from caffe_mpi_tpu_torch.weights import load_jax_params  # noqa: E402


def _state(solver) -> dict:
    """Params (whole: the ones split over 'model' gathered), whole history
    slots and running statistics, on the host."""
    out = {}
    for lname, pname, _, p in solver._decls:
        p = solver.net.gather_param(lname, pname, p)
        out[f"{lname}.{pname}"] = p.detach().numpy().copy()
    for (lname, pname), slots in solver.full_history().items():
        for i, h in enumerate(slots):
            out[f"{lname}.{pname}.h{i}"] = h.numpy().copy()
    for lname, sname, buf in solver.net.state_buffers():
        out[f"{lname}.{sname}"] = buf.numpy().copy()
    return out


def train(sc: dict, mesh) -> dict:
    solver = Solver(SolverParameter.from_text(sc["solver"]), mesh=mesh,
                    param_shardings=sc.get("param_shardings"))
    if sc.get("weights") is not None:
        load_jax_params(solver.net, sc["weights"], sc.get("net_state"))
        solver._sync_replicas()
    feeds, poison = sc["feeds"], sc.get("poison")

    def feed_fn(k):
        out = {key: torch.from_numpy(np.ascontiguousarray(mesh.shard(v)))
               for key, v in feeds[k].items()}
        if poison and poison == (k, mesh.rank):
            out["x"] = out["x"].clone()
            out["x"][0, 0] = float("nan")
        return out

    masks = sc.get("masks")
    mask_fn = None if masks is None else (lambda it, m: {
        name: torch.from_numpy(a) for name, a in masks[(it, m)].items()})
    solver.step(sc["iters"], feed_fn, dropout_masks=mask_fn)
    scores = None
    if sc.get("test_feeds"):
        # a test net whose batch does not divide the data ranks takes the
        # whole batch on every rank
        tests, part = sc["test_feeds"], (
            mesh.shard if solver.test_sharded[0] else (lambda v: v))
        scores = solver.test_all([lambda k: {
            key: torch.from_numpy(np.ascontiguousarray(part(v)))
            for key, v in tests[k].items()}])
    res = {"losses": list(solver.losses), "state": _state(solver),
           "skipped": list(solver.skipped_iters), "test_scores": scores,
           "test_sharded": list(solver.test_sharded),
           "stats": solver.reduction_stats(),
           "graph_route": solver.graph_route,
           "shards": {f"{l}.{p}": tuple(h[0].shape)
                      for (l, p), h in solver.history.items()},
           "local": {f"{l}.{p}.h{i}": h.detach().numpy().copy()
                     for (l, p), slots in solver.history.items()
                     for i, h in enumerate(slots)}}
    if sc.get("snapshot"):
        prefix = sc["snapshot"]
        solver.sp.snapshot_prefix = prefix
        res["snapshot"] = solver.snapshot()
        res["snapshot_log"] = list(solver.snapshot_log)
        if sc.get("gathered"):
            # the same state's gathered (BINARYPROTO) snapshot
            solver.snapshot_format = "BINARYPROTO"
            solver.sp.snapshot_prefix = sc["gathered"]
            res["gathered"] = solver.snapshot()
            res["gathered_ms"] = solver.snapshot_log[-1]["write_ms"]
            solver.sp.snapshot_prefix = prefix
        again = Solver(SolverParameter.from_text(sc["solver"]), mesh=mesh,
                       param_shardings=sc.get("param_shardings"))
        again.sp.snapshot_prefix = prefix
        res["restored_auto"] = again.restore_auto()
        res["restored"] = _state(again)
        res["restored_iter"] = again.iter
        again.close()
    solver.close()
    return res


def batch_norm(sc: dict, mesh) -> dict:
    """A TRAIN BatchNorm on the rank's slice: its output, the running
    statistics after one forward, and the gradients of sum(y * w)."""
    from caffe_mpi_tpu_torch.core.types import DtypePolicy
    from caffe_mpi_tpu_torch.layers import create_layer
    from caffe_mpi_tpu_torch.proto import LayerParameter
    layer = create_layer(LayerParameter.from_text(sc["layer"]),
                         DtypePolicy(), "TRAIN", torch.device("cpu"))
    x = mesh.shard(sc["x"])
    layer.in_shapes = [x.shape]
    layer.setup([x.shape])
    layer.mesh_plan = mesh
    layer.train(True)
    with torch.no_grad():
        layer.scale.copy_(torch.from_numpy(sc["scale"]))
        layer.bias.copy_(torch.from_numpy(sc["bias"]))
    layer.scale.requires_grad_(True)
    layer.bias.requires_grad_(True)
    xt = torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(True)
    y = layer([xt])[0]
    w = torch.from_numpy(np.ascontiguousarray(mesh.shard(sc["w"])))
    (y * w).sum().backward()
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
            "dscale": layer.scale.grad.numpy().copy(),
            "dbias": layer.bias.grad.numpy().copy(),
            "mean": layer.mean.numpy().copy(),
            "var": layer.var.numpy().copy()}


def _grads_of(out, inputs, dy):
    """The gradients of sum(out * dy) with respect to `inputs`."""
    (out * dy).sum().backward()
    return [t.grad.numpy().copy() for t in inputs]


def ring(sc: dict, mesh) -> dict:
    """sequence_parallel_attention over the model ranks (plain or flash
    blocks) on global q, k, v; the output and the q, k, v gradients of
    sum(out * dy), and the flash launches."""
    from caffe_mpi_tpu_torch.ops import attention as att
    from caffe_mpi_tpu_torch.ops import flash_attention as fa
    q, k, v = (torch.from_numpy(sc[n]).requires_grad_(True)
               for n in ("q", "k", "v"))
    before = [f.launches for f in (fa.flash_fwd, fa.flash_bwd_dq,
                                   fa.flash_bwd_dkv)]
    calls = {"flash_block": 0, "flash_block_bwd": 0}
    real = {name: getattr(fa, name) for name in calls}

    def counted(name):
        def call(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return call
    for name in calls:
        setattr(fa, name, counted(name))
    try:
        out = att.sequence_parallel_attention(
            q, k, v, mesh, causal=sc["causal"], use_flash=sc["flash"])
        grads = _grads_of(out, [q, k, v], torch.from_numpy(sc["dy"]))
    finally:
        for name, fn in real.items():
            setattr(fa, name, fn)
    return {"out": out.detach().numpy(), "dq": grads[0], "dk": grads[1],
            "dv": grads[2], "blocks": calls,
            "launches": [f.launches - b for f, b in zip(
                (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv), before)]}


def pipeline(sc: dict, mesh) -> dict:
    """pipeline_apply of a stage y = tanh(x @ w + b) over the model ranks,
    stage s's (w, b) from the stacked ones; the output and the gradients
    of sum(out * dy) for x and this rank's stage."""
    from caffe_mpi_tpu_torch.parallel.pipeline import pipeline_apply
    s = mesh.model_index
    w = torch.from_numpy(sc["w"][s].copy()).requires_grad_(True)
    b = torch.from_numpy(sc["b"][s].copy()).requires_grad_(True)
    x = torch.from_numpy(sc["x"]).requires_grad_(True)

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])
    out = pipeline_apply(stage, {"w": w, "b": b}, x, mesh)
    dx, dw, db = _grads_of(out, [x, w, b], torch.from_numpy(sc["dy"]))
    return {"out": out.detach().numpy(), "dx": dx, "dw": dw, "db": db}


def moe(sc: dict, mesh) -> dict:
    """moe_ffn with the experts split over the model ranks
    (shard_experts); y, aux and the gradients of sum(y * dy) + aux for x
    and every param (the experts' this rank's)."""
    from caffe_mpi_tpu_torch.ops.moe import moe_ffn, shard_experts
    full = {k: torch.from_numpy(v) for k, v in sc["params"].items()}
    params = {k: v.clone().requires_grad_(True)
              for k, v in shard_experts(full, mesh).items()}
    x = torch.from_numpy(sc["x"]).requires_grad_(True)
    y, aux = moe_ffn(params, x, top_k=sc["top_k"],
                     capacity_factor=sc["capacity_factor"], plan=mesh)
    ((y * torch.from_numpy(sc["dy"])).sum() + aux).backward()
    return {"y": y.detach().numpy(), "aux": float(aux),
            "dx": x.grad.numpy(),
            "grads": {k: v.grad.numpy() for k, v in params.items()}}


def resume(sc: dict, mesh) -> dict:
    """The elastic path's resume: a solver over this mesh restores the
    newest verified snapshot under sc["prefix"] (when sc["restore"]),
    trains sc["iters"] iterations on its slice of the global feeds and
    snapshots."""
    solver = Solver(SolverParameter.from_text(sc["solver"]), mesh=mesh)
    solver.sp.snapshot_prefix = sc["prefix"]
    restored = solver.restore_auto() if sc.get("restore") else None
    feeds = sc["feeds"]
    solver.step(sc["iters"], lambda k: {
        key: torch.from_numpy(np.ascontiguousarray(mesh.shard(v)))
        for key, v in feeds[k % len(feeds)].items()})
    solver.snapshot()
    res = {"restored": restored, "iter": solver.iter,
           "losses": list(solver.losses), "state": _state(solver),
           "shards": {f"{l}.{p}": tuple(h[0].shape)
                      for (l, p), h in solver.history.items()}}
    solver.close()
    return res


def restore(sc: dict, mesh) -> dict:
    """A solver over this mesh restores sc["path"] (any snapshot, any
    mesh that wrote it); its iteration, whole state and slot shapes."""
    solver = Solver(SolverParameter.from_text(sc["solver"]), mesh=mesh,
                    param_shardings=sc.get("param_shardings"))
    solver.restore(sc["path"])
    res = {"iter": solver.iter, "state": _state(solver),
           "shards": {f"{l}.{p}": tuple(h[0].shape)
                      for (l, p), h in solver.history.items()}}
    solver.close()
    return res


KINDS = {"bn": batch_norm, "train": train, "ring": ring, "pipeline": pipeline,
         "moe": moe, "resume": resume, "restore": restore}


class Ranks:
    """`world` rank processes running `scenarios` (started at once; the
    caller may work meanwhile): `results()` waits for them and returns
    each rank's {name: result}. A rank that fails or outlasts `timeout`
    fails the call, with its output, and every rank is killed."""

    def __init__(self, scenarios, world: int, out_dir: str,
                 timeout: float = 150.0):
        import subprocess
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir, self.world, self.timeout = out_dir, world, timeout
        spec = os.path.join(out_dir, "spec.pkl")
        with open(spec, "wb") as f:
            pickle.dump(scenarios if isinstance(scenarios, dict)
                        else {"scenarios": scenarios}, f)
        port = mesh_mod.free_port()
        env = dict(os.environ, CAFFE_TPU_COLLECTIVE_TIMEOUT="90",
                   CAFFE_TPU_INIT_TIMEOUT="60", OMP_NUM_THREADS="1")
        env.pop("CUDA_VISIBLE_DEVICES", None)
        self.logs = [open(os.path.join(out_dir, f"r{r}.log"), "w")
                     for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), spec, str(r),
             str(world), str(port), out_dir], env=env, stdout=log,
            stderr=subprocess.STDOUT) for r, log in enumerate(self.logs)]

    def results(self) -> list[dict]:
        try:
            for p in self.procs:
                p.wait(timeout=self.timeout)
        finally:
            for p, log in zip(self.procs, self.logs):
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        out = []
        for r, p in enumerate(self.procs):
            if p.returncode != 0:
                with open(os.path.join(self.out_dir, f"r{r}.log")) as f:
                    raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                                       f"{f.read()[-4000:]}")
            with open(os.path.join(self.out_dir, f"r{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def run_ranks(scenarios, world: int, out_dir: str,
              timeout: float = 150.0) -> list[dict]:
    """Ranks(...).results()."""
    return Ranks(scenarios, world, out_dir, timeout).results()


def main(argv) -> int:
    spec, rank, world, port, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    with open(spec, "rb") as f:
        spec = pickle.load(f)
    mesh_mod.init_distributed(f"127.0.0.1:{port}", world, rank,
                              backend="gloo")
    data, model = spec.get("mesh", (world, 1))
    mesh = mesh_mod.MeshPlan.from_shape(data, model,
                                        devices=["cpu"] * world)
    results = {}
    for sc in spec["scenarios"]:
        results[sc["name"]] = KINDS[sc.get("kind", "train")](sc, mesh)
    mesh_mod.cluster_barrier("exit", 60)
    mesh_mod.shutdown_distributed()
    with open(os.path.join(out, f"r{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
