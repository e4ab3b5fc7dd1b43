"""Port parity: `Solver(param_shardings=)` rules at every mesh size
(caffe_mpi_tpu_torch/solver/solver.py, parallel/mesh.py `Placement`)
against the JAX `Solver`, which places its rules whenever a mesh exists
(caffe_mpi_tpu/solver/solver.py:418-419) and keeps every ruled layer's
slots with its params under ZeRO-1 (:435).

- At world 1 (`MeshPlan.from_shape(1)` in each package, the port at
  `device="cpu"`): a spec naming an axis the mesh lacks and a string that
  is not a mode raise a ValueError in both; ("data", None) builds.
- On 2 gloo ranks at data=2, model=1 (tests/torch_dp_worker.py) against
  the JAX `Solver` on a (2, 1) mesh: an ("data", None) rule keeps each
  rank's half of the weight and of its slots, as the JAX
  `PartitionSpec('data', None)` does, and ZeRO-1 splits the slots of the
  layers no rule names; 5 Adam iterations at the solver bars (losses
  rtol 1e-5; params and history rtol 1e-5 / atol 1e-6), ranks equal.
- Through the CLI (`train -mesh data=2 -zero_stage 1`), a prototxt
  `param_sharding` leaves its layer's slots out of ZeRO-1 as the JAX
  solver does, and the run's losses equal one process's.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from caffe_mpi_tpu.parallel import MeshPlan as JaxMeshPlan
from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu_torch.parallel import MeshPlan
from caffe_mpi_tpu_torch.proto import SolverParameter
from caffe_mpi_tpu_torch.solver import Solver
from test_torch_parallel import (MLP, assert_like_jax, assert_ranks_equal,
                                 jax_finish, mlp_feeds, mlp_solver)
from test_torch_refusals import NET
from torch_dp_worker import Ranks

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAM = 'type: "Adam" momentum2: 0.999 delta: 1e-8 '
RULE = {"ip1": ("data", None)}


def _jax_mesh(n):
    return JaxMeshPlan.from_shape(n, devices=jax.devices()[:n])


@pytest.mark.parametrize("rule,match", [
    ({"ip": ("foo", None)}, "foo"),
    ({"ip": "bogus"}, None),
])
def test_an_invalid_rule_raises_at_world_one_as_jax_does(rule, match):
    text = NET + "base_lr: 0.1"
    with pytest.raises(ValueError) as jerr:
        JaxSolver(JaxSP.from_text(text), mesh=_jax_mesh(1),
                  param_shardings=rule)
    with pytest.raises(ValueError, match=match) as perr:
        Solver(SolverParameter.from_text(text), device="cpu",
               mesh=MeshPlan.from_shape(1, devices=["cpu"]),
               param_shardings=rule)
    if match:  # both name the axis
        assert match in str(jerr.value) and match in str(perr.value)


def test_a_data_rule_builds_at_world_one_as_jax_does():
    text = NET + "base_lr: 0.1"
    js = JaxSolver(JaxSP.from_text(text), mesh=_jax_mesh(1),
                   param_shardings={"ip": ("data", None)})
    w = js.params["ip"]["weight"]
    assert w.sharding.shard_shape(w.shape) == w.shape  # one rank: whole
    port = Solver(SolverParameter.from_text(text), device="cpu",
                  mesh=MeshPlan.from_shape(1, devices=["cpu"]),
                  param_shardings={"ip": ("data", None)})
    assert tuple(port.net.layer_by_name("ip").weight.shape) == w.shape
    assert port.net.placement is None  # nothing is split


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """Two ranks of the ruled MLP (Adam, ZeRO-1 and without) while the
    JAX solvers step on a (2, 1) mesh."""
    feeds, jaxes, scs = mlp_feeds(5), {}, []
    for name, extra in (("rule", ""), ("rule_zero", "zero_stage: 1")):
        text = mlp_solver(ADAM + extra)
        js = JaxSolver(JaxSP.from_text(text), mesh=_jax_mesh(2),
                       param_shardings=RULE)
        sc = {"solver": text, "feeds": feeds, "iters": 5,
              "weights": jax.tree_util.tree_map(np.asarray, js.params),
              "param_shardings": RULE}
        # the placement the JAX solver gives each slot (a step's outputs
        # then take whatever sharding XLA propagates)
        sc["jax_shards"] = {
            f"{l}.{p}": slots[0].sharding.shard_shape(slots[0].shape)
            for l, ps in js.opt_state.items() for p, slots in ps.items()}
        jaxes[name] = (js, sc)
        scs.append(dict(sc, name=name))
    ranks = Ranks(scs, 2, str(tmp_path_factory.mktemp("rules")))
    refs = {name: (js, jax_finish(js, sc), sc["jax_shards"])
            for name, (js, sc) in jaxes.items()}
    return ranks.results(), refs


@pytest.mark.parametrize("name", ["rule", "rule_zero"])
def test_a_data_rule_on_two_ranks_holds_the_jax_shards(spawn, name):
    results, refs = spawn
    js, losses, jax_shards = refs[name]
    assert_ranks_equal(results, name)
    res = results[0][name]
    assert_like_jax(js, losses, res)
    # each rank's slot shapes are the JAX placement's shards (the ruled
    # weight's slots with the weight; under ZeRO-1 the other layers'
    # split over 'data' where dim 0 divides)
    assert res["shards"] == jax_shards
    assert res["shards"]["ip1.weight"] == (16, 8)
    zero = sorted(f"{l}.{p}" for l, p in getattr(js, "_zero_shardings", {}))
    assert res["stats"]["zero_slots"] == zero
    if name == "rule_zero":
        assert "ip1.weight" not in zero and "ip2.weight" in zero


def _cli(args):
    env = dict(os.environ, CAFFE_TPU_COLLECTIVE_TIMEOUT="90",
               OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "caffe_mpi_tpu_torch.tools.cli", "train",
         *args], cwd=_ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def test_the_cli_keeps_a_prototxt_rules_slots_out_of_zero(tmp_path):
    """`param_sharding: "rows"` at -mesh data=2 places nothing (a model
    axis of one rank), but its layer's slots stay whole under ZeRO-1, as
    in the JAX solver; the losses equal one process's."""
    net = MLP.replace('name: "ip1" type: "InnerProduct"',
                      'name: "ip1" type: "InnerProduct" '
                      'param_sharding: "rows"').replace(
                          "num_output: 4", "num_output: 10")  # its labels
    text = mlp_solver(net=net).replace("max_iter: 20", "max_iter: 4")
    path = tmp_path / "solver.prototxt"
    path.write_text(text)
    js = JaxSolver(JaxSP.from_text(text + " zero_stage: 1"),
                   mesh=_jax_mesh(2))
    want = sorted(f"{l}.{p}" for l, p in js._zero_shardings)
    runs = {}
    procs = {name: _cli(["-solver", str(path), "-synthetic", "-device",
                         "cpu", "-snapshot_prefix",
                         str(tmp_path / name / "s"), *extra])
             for name, extra in (("one", []),
                                 ("mesh", ["-mesh", "data=2", "-zero_stage", "1"]))}
    for name, p in procs.items():
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err[-3000:]
        line = next(l for l in out.splitlines() if l.startswith('{"train"'))
        runs[name] = json.loads(line)["train"]
    red = runs["mesh"]["reduction"]
    assert red["zero_stage"] == 1 and red["zero_slots"] == want
    assert "ip1.weight" not in want and "ip2.weight" in want
    np.testing.assert_allclose(runs["mesh"]["losses"], runs["one"]["losses"],
                               rtol=1e-5)
