"""Port parity: gather on use (caffe_mpi_tpu_torch/parallel/mesh.py
`gather_on_use`, `Net.place`) against the JAX `Solver` on a 2 x 2 mesh of
the virtual CPU devices, for each placement the port's model-parallel
forwards do not take and the JAX `param_sharding_rules` places:

- a ("data", "model") spec (dim 0 over 'data', dim 1 over 'model');
- a cols weight with its bias split, `{"weight": (None, "model"), "bias":
  ("model",)}`;
- a grouped Convolution split by rows;
- a transposed InnerProduct split by rows;
- a bias-only split of a layer that shares its weight;
- an MoE split of two of its four banks.

Each layer keeps its shards and gathers the whole params before its
forward; the backward hands back the rank's slice of the gradient (over
'data' summed over the data ranks first). The port's ranks are four gloo
processes (tests/torch_dp_worker.py). Bars, float32, those of
test_torch_model_parallel.py: losses rtol 1e-5; params and history
(gathered whole) rtol 1e-5 / atol 1e-6 after 5 iterations; the ranks'
whole states equal, element for element.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from test_torch_model_parallel import (ITERS, MESH, MOE_NET, SHARED_NET,
                                       TP_CONV, TP_MLP, assert_like_jax,
                                       assert_ranks_equal, jax_start,
                                       solver_text)
from torch_dp_worker import Ranks

# conv2 grouped (2 groups) and split by rows
GROUPED_CONV = TP_CONV.replace(
    'param_sharding: "cols"\n        convolution_param { num_output: 6 '
    'kernel_size: 3', 'param_sharding: "rows"\n        convolution_param { '
    'num_output: 6 kernel_size: 3 group: 2')
# fc2 transposed (its weight is (in, out)) and split by rows
TRANSPOSED = TP_MLP.replace(
    'param_sharding: "cols"\n        inner_product_param { num_output: 10',
    'param_sharding: "rows"\n        inner_product_param { num_output: 10 '
    'transpose: true')

CASES = {
    # name: (solver text, feeds seed, param_shardings)
    "data_model": (solver_text(TP_MLP, extra="clip_gradients: 0.5"), 11,
                   {"fc1": ("data", "model"), "fc3": ("data", None)}),
    "cols_split_bias": (solver_text(TP_MLP, kind="Adam",
                                    extra="base_lr: 0.01"), 12,
                        {"fc2": {"weight": (None, "model"),
                                 "bias": ("model",)}}),
    "grouped_conv": (solver_text(GROUPED_CONV, extra="clip_gradients: 0.5"),
                     13, None),
    "transposed_ip": (solver_text(TRANSPOSED), 14, None),
    "bias_only_shared": (solver_text(SHARED_NET), 15, {"fb": "rows"}),
    "moe_two_banks": (solver_text(MOE_NET, extra="clip_gradients: 0.5"), 16,
                      {"moe1": {"w1": ("model",), "b1": ("model",)}}),
}


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    assert "group: 2" in GROUPED_CONV and "transpose: true" in TRANSPOSED
    tmp = tmp_path_factory.mktemp("gou")
    with ThreadPoolExecutor(len(CASES)) as ex:
        started = dict(zip(CASES, ex.map(lambda n: jax_start(*CASES[n]),
                                         CASES)))
    scs = [dict(sc, name=name) for name, (_, sc) in started.items()]
    ranks = Ranks({"mesh": MESH, "scenarios": scs}, 4, str(tmp / "ranks"),
                  timeout=240)

    def step(name):
        js, sc = started[name]
        return name, (js, [js.step(1, lambda k: sc["feeds"][k])
                           for _ in range(ITERS)])
    with ThreadPoolExecutor(len(CASES)) as ex:
        refs = dict(ex.map(step, CASES))
    return ranks.results(), refs


@pytest.mark.parametrize("name", sorted(CASES))
def test_gathered_on_use_matches_the_jax_2x2_mesh(spawn, name):
    results, refs = spawn
    js, losses = refs[name]
    assert_like_jax(js, losses, results[0][name])
    assert_ranks_equal(results, name)


def test_each_rank_keeps_only_its_shards(spawn):
    """The placement's shards stay on the ranks (and their slots with
    them); what no rule names stays whole."""
    results, _ = spawn
    dm = results[0]["data_model"]["shards"]
    assert dm["fc1.weight"] == (8, 6) and dm["fc1.bias"] == (16,)
    assert dm["fc3.weight"] == (2, 10)
    cb = results[0]["cols_split_bias"]["shards"]
    assert cb["fc2.weight"] == (10, 8) and cb["fc2.bias"] == (5,)
    assert results[0]["grouped_conv"]["shards"]["conv2.weight"] == (3, 4, 3, 3)
    assert results[0]["transposed_ip"]["shards"]["fc2.weight"] == (8, 10)
    shared = results[0]["bias_only_shared"]["shards"]
    assert shared["fa.weight"] == (16, 12) and shared["fb.bias"] == (8,)
    moe = results[0]["moe_two_banks"]["shards"]
    assert moe["moe1.w1"] == (2, 6, 8) and moe["moe1.w2"] == (4, 8, 6)
    # rank 3 (data 1, model 1) holds the other quarter of fc1's weight
    np.testing.assert_array_equal(
        results[3]["data_model"]["local"]["fc1.weight.h0"],
        results[0]["data_model"]["state"]["fc1.weight.h0"][8:, 6:])
