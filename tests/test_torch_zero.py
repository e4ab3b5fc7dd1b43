"""Port parity: ZeRO-1 (`zero_stage: 1`) in the port's Solver against the
replicated data-parallel run and the JAX `Solver` on a mesh
(tests/test_zero.py: the result is the replicated one).

Two gloo ranks on the CPU (tests/torch_dp_worker.py). A history slot
whose dim 0 divides the ranks lives on each rank as its dim-0 shard; the
rank updates its slice of the param and the ranks all-gather it. The
update rules are elementwise, so ZeRO-1 trains to the replicated run's
params and history exactly; the JAX mesh run is held at rtol 1e-5 /
atol 1e-6. A snapshot gathers the slots whole: restored on the same two
ranks it gives back each rank's shards, and in one process it gives the
gathered history.
"""

import numpy as np
import pytest

from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu_torch.proto import SolverParameter
from caffe_mpi_tpu_torch.solver import Solver
from test_torch_parallel import (alexnet_feeds, alexnet_solver,
                                 assert_like_jax, assert_ranks_equal,
                                 jax_reference, mlp_feeds, mlp_solver)
from torch_dp_worker import run_ranks

ADAM = 'type: "Adam" momentum2: 0.999 delta: 1e-8 '


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero")
    js, losses, mlp = jax_reference(mlp_solver(ADAM + "zero_stage: 1"),
                                    mlp_feeds(5), 2)
    alex = {"feeds": alexnet_feeds(3), "iters": 3}
    poisoned = {"feeds": mlp_feeds(5), "iters": 5, "poison": (1, 0)}
    scs = [dict(mlp, name="mlp_zero", snapshot=str(tmp / "snap" / "z")),
           dict(mlp, name="mlp", solver=mlp_solver(ADAM)),
           dict(alex, name="alexnet", solver=alexnet_solver()),
           dict(alex, name="alexnet_zero",
                solver=alexnet_solver("zero_stage: 1")),
           dict(poisoned, name="guard_zero",
                solver=mlp_solver("zero_stage: 1 train_guard: true")),
           dict(mlp, name="overlap_zero",
                solver=mlp_solver(ADAM + "zero_stage: 1 reduce_overlap: "
                                  "true"))]
    return run_ranks(scs, 2, str(tmp)), (js, losses), mlp


def _equal(a, b):
    assert set(a["state"]) == set(b["state"])
    for key, arr in a["state"].items():
        assert np.array_equal(b["state"][key], arr), key


@pytest.mark.parametrize("zero,flat", [("mlp_zero", "mlp"),
                                       ("alexnet_zero", "alexnet")])
def test_zero_one_equals_the_replicated_run(spawn, zero, flat):
    results, _, _ = spawn
    _equal(results[0][flat], results[0][zero])
    assert results[0][zero]["losses"] == results[0][flat]["losses"]
    assert_ranks_equal(results, zero)
    assert results[0][zero]["stats"]["zero_stage"] == 1


def test_zero_one_matches_the_jax_mesh(spawn):
    results, (js, losses), _ = spawn
    assert js._zero == 1 and js._zero_shardings
    assert_like_jax(js, losses, results[0]["mlp_zero"])


def test_slots_are_sharded_where_dim_0_divides(spawn):
    results, (js, _), _ = spawn
    shards = results[0]["mlp_zero"]["shards"]
    # ip1 weight (32, 8) and bias (32,), ip2 weight (4, 32) and bias (4,)
    assert shards == {"ip1.weight": (16, 8), "ip1.bias": (16,),
                      "ip2.weight": (2, 32), "ip2.bias": (2,)}
    assert {f"{l}.{p}" for l, p in js._zero_shardings} == set(shards)
    replicated = results[0]["mlp"]["shards"]
    assert replicated["ip1.weight"] == (32, 8)
    # alexnet: fc8's bias (10) divides, conv1's (8) too; every slot sharded
    alex = results[0]["alexnet_zero"]["shards"]
    assert alex["fc8.weight"][0] == 5


def test_snapshot_gathers_the_slots_and_restores_each_ranks_shard(spawn):
    results, _, mlp = spawn
    for r, res in enumerate(results):
        z = res["mlp_zero"]
        assert z["restored_iter"] == 5
        assert z["restored_auto"] == results[0]["mlp_zero"]["snapshot"]
        for key, arr in z["state"].items():
            assert np.array_equal(z["restored"][key], arr), (r, key)
    # the one-process solver reads the whole history the ranks gathered
    one = Solver(SolverParameter.from_text(mlp_solver(ADAM)), device="cpu")
    one.restore(results[0]["mlp_zero"]["snapshot"])
    state = results[0]["mlp_zero"]["state"]
    for (lname, pname), slots in one.history.items():
        for i, h in enumerate(slots):
            assert np.array_equal(h.numpy(), state[f"{lname}.{pname}.h{i}"])
    one.close()


def test_guard_agrees_across_ranks_under_zero(spawn):
    results, _, _ = spawn
    for res in results:
        assert res["guard_zero"]["skipped"] == [1]
    assert_ranks_equal(results, "guard_zero")


def test_zero_with_reduce_overlap_falls_back_with_the_jax_reason(spawn):
    results, _, _ = spawn
    stats = results[0]["overlap_zero"]["stats"]
    assert stats["mode"] == "implicit"
    assert stats["fallback_reason"] == (
        "zero_stage 1 reduces via reduce-scatter; explicit bucket psums "
        "would defeat it")
    _equal(results[0]["mlp_zero"], results[0]["overlap_zero"])


@pytest.mark.parametrize("extra,match", [
    ("zero_stage: 2", "zero_stage 2 unsupported"),
    ("zero_stage: 1", "requires a device mesh")])
def test_zero_stage_checks_raise_as_jax_does(extra, match):
    from caffe_mpi_tpu.solver import Solver as JaxSolver
    text = mlp_solver(extra)
    with pytest.raises(ValueError, match=match):
        JaxSolver(JaxSP.from_text(text))
    with pytest.raises(ValueError, match=match):
        Solver(SolverParameter.from_text(text), device="cpu")
