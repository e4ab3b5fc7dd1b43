"""Port parity: ZeRO-1 and test nets under the mesh's 'model' axis, against
the JAX `Solver` on the virtual CPU devices.

ZeRO-1 follows the JAX rule (caffe_mpi_tpu/solver/solver.py
`_place_params_opt`): the slots of the layers a rule names stay aligned
with their params (split over 'model' where the param is); every other
slot whose dim 0 divides the data ranks lives on the rank as its dim-0
shard over 'data', the rank updates its slice and the param is
all-gathered over the data group. The updates are elementwise, so the
ZeRO run equals the replicated one element for element.

A test net whose batch (3) does not divide the 2 data ranks evaluates the
whole batch on every rank with the model-parallel forward (the JAX
`_place_test_feeds` fallback).

Four gloo ranks on a 2 x 2 mesh (tests/torch_dp_worker.py). Bars (PR
14/16's): losses rtol 1e-5; params, history and scores rtol 1e-5 / atol
1e-6; ranks element for element.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from test_torch_model_parallel import (ITERS, MESH, TP_MLP, assert_like_jax,
                                       assert_ranks_equal, jax_start,
                                       narrow_alexnet_tp, solver_text)
from torch_dp_worker import Ranks

ADAM = 'type: "Adam" momentum2: 0.999 delta: 1e-8 base_lr: 0.01 '
TEST_NET = TP_MLP.replace("dim: 8 dim: 12 } shape { dim: 8",
                          "dim: 3 dim: 12 } shape { dim: 3")


def uneven_solver() -> str:
    """TP_MLP trained at batch 8 and tested at batch 3."""
    assert TEST_NET != TP_MLP
    return ("train_net_param { " + TP_MLP + " }\ntest_net_param { "
            + TEST_NET + " }\ntest_iter: 2 test_interval: 1000 "
            'base_lr: 0.05 momentum: 0.9 lr_policy: "fixed" max_iter: 20 '
            'random_seed: 7 ')


CASES = {
    # name: (solver text, feeds seed, param_shardings, classes, JAX mesh)
    "tp_mlp_zero": (solver_text(TP_MLP, extra=ADAM + "zero_stage: 1"), 21,
                    None, 32, MESH),
    "tp_mlp": (solver_text(TP_MLP, extra=ADAM), 21, None, 32, MESH),
    # Dropout: held against the JAX Solver on (2, 1), whose masks are the
    # one-device draw the port's ranks replay (test_torch_model_parallel)
    "tp_alexnet_zero": (solver_text(narrow_alexnet_tp(),
                                    extra="weight_decay: 0.0005 "
                                    "clip_gradients: 2.0 zero_stage: 1"),
                        5, None, 10, (2, 1)),
    "uneven_test": (uneven_solver(), 22, None, 32, MESH),
}


def _test_feeds(seed):
    rs = np.random.RandomState(seed)
    return [{"x": rs.randn(3, 12).astype(np.float32),
             "t": rs.randint(0, 4, (3,)).astype(np.int32)}
            for _ in range(2)]


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero_tp")
    with ThreadPoolExecutor(len(CASES)) as ex:
        started = dict(zip(CASES, ex.map(
            lambda n: jax_start(*CASES[n][:4], mesh=CASES[n][4]), CASES)))
    scs = [dict(sc, name=name) for name, (_, sc) in started.items()]
    tests = _test_feeds(23)
    for sc in scs:
        if sc["name"] == "uneven_test":
            sc["test_feeds"] = tests
    ranks = Ranks({"mesh": MESH, "scenarios": scs}, 4, str(tmp / "ranks"),
                  timeout=240)

    def step(name):
        js, sc = started[name]
        losses = [js.step(1, lambda k: sc["feeds"][k])
                  for _ in range(ITERS)]
        scores = js.test_all([lambda k: tests[k]]) \
            if name == "uneven_test" else None
        return name, (js, losses, scores)
    with ThreadPoolExecutor(len(CASES)) as ex:
        refs = dict(ex.map(step, CASES))
    return ranks.results(), refs


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_the_jax_solver(spawn, name):
    results, refs = spawn
    js, losses, _ = refs[name]
    assert_like_jax(js, losses, results[0][name])
    assert_ranks_equal(results, name)


def test_zero_under_the_model_axis_equals_the_replicated_run(spawn):
    results, _ = spawn
    zero, flat = results[0]["tp_mlp_zero"], results[0]["tp_mlp"]
    assert zero["losses"] == flat["losses"]
    for key, arr in flat["state"].items():
        assert np.array_equal(zero["state"][key], arr), key
    assert zero["stats"]["zero_stage"] == 1 and zero["stats"]["n_model"] == 2


@pytest.mark.parametrize("name", ["tp_mlp_zero", "tp_alexnet_zero"])
def test_each_rank_holds_its_slot_shard(spawn, name):
    """A slot of a layer no rule names is the rank's dim-0 half (two
    data ranks), the same on both model ranks; a slot of a named layer
    has its param's shape."""
    results, _ = spawn
    whole = results[0][name]["state"]
    names = {"tp_mlp_zero": ("fc3", ("fc1", "fc2")),
             "tp_alexnet_zero": ("fc8", ("fc6", "fc7"))}[name]
    zeroed, tp = names
    for r, res in enumerate(results):
        d, m = divmod(r, 2)
        got = res[name]["local"][f"{zeroed}.weight.h0"]
        n = whole[f"{zeroed}.weight.h0"].shape[0] // 2
        np.testing.assert_array_equal(
            got, whole[f"{zeroed}.weight.h0"][d * n:(d + 1) * n])
        for lname in tp:
            # TP layers' slots keep their param's shape (no ZeRO split)
            assert res[name]["shards"][f"{lname}.weight"] == \
                res[name]["local"][f"{lname}.weight.h0"].shape
    rows = results[0][name]["shards"][f"{tp[0]}.weight"]
    assert rows[0] * 2 == whole[f"{tp[0]}.weight"].shape[0]
    # a named layer's bias that no split reaches stays whole, not ZeRO'd
    cols_bias = whole[f"{tp[1]}.bias"].shape
    assert results[0][name]["shards"][f"{tp[1]}.bias"] == cols_bias


def test_uneven_test_net_scores_match_jax(spawn):
    results, refs = spawn
    _, _, scores = refs["uneven_test"]
    for res in results:
        got = res["uneven_test"]
        assert got["test_sharded"] == [False]
        assert set(got["test_scores"][0]) == set(scores[0])
        for key, want in scores[0].items():
            np.testing.assert_allclose(got["test_scores"][0][key], want,
                                       rtol=1e-5, atol=1e-6)
        assert got["test_scores"] == results[0]["uneven_test"]["test_scores"]
