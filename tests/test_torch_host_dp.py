"""Port parity: host layers under data parallelism (the Solver's `mesh`
over a net with DetectNetTransformation or a Python layer) against the
JAX `Solver` on `MeshPlan.from_shape(2)` over the virtual CPU devices.

The JAX layers run their host step through `jax.pure_callback`, which
gathers its operands: under a (2, 1) mesh the callback is handed the
whole global batch, once a step. The first test holds that finding, so
that a change in JAX's callback is seen. The port runs the same step on
the global batch: its two gloo ranks (tests/torch_dp_worker.py)
all-gather the layer's bottoms over 'data', and each keeps its rows of
the tops. So DetectNet sample i draws Philox((seed << 32) ^ i) with i the
global row, and a Python layer that couples rows (`BatchCenter`, a batch
mean, tests/torch_rowmix_layer.py) sees every row; its loss layer
(`HalfMeanSquare`) gives a top the batch does not split.

Bars: 5 iterations at the solver bars (losses rtol 1e-5; params and
history rtol 1e-5 / atol 1e-6), the ranks equal to each other; the
planted fault (each rank steps its host layer on its own rows, so a
DetectNet sample draws with its local row index and BatchCenter centres
on the rank's mean) must break them. The JAX ReLU takes the reference's
gradient at 0 (tests/test_torch_detectnet.py `caffe_relu`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from caffe_mpi_tpu.layers import activations as jact
from caffe_mpi_tpu.layers import detection as jdetection
from test_torch_detectnet import (KITTI, _jax_seeds, _kitti_feed,
                                  _solver_text)
from test_torch_parallel import (assert_like_jax, assert_ranks_equal,
                                 jax_finish, jax_start)
from torch_dp_worker import Ranks
import torch_rowmix_layer

ITERS = 5
BATCH = 4  # the kitti net's global batch: 2 rows a rank

PY_NET = """
name: "rowmix"
layer { name: "in" type: "Input" top: "x" top: "t"
        input_param { shape { dim: 16 dim: 8 } shape { dim: 16 } } }
layer { name: "ip1" type: "InnerProduct" bottom: "x" top: "h"
        inner_product_param { num_output: 32 weight_filler { type: "xavier" }
                              bias_filler { type: "constant" value: 0.1 } } }
layer { name: "center" type: "Python" bottom: "h" top: "hc"
        python_param { module: "torch_rowmix_layer" layer: "BatchCenter" } }
layer { name: "sq" type: "Python" bottom: "hc" top: "sq" loss_weight: 0.1
        python_param { module: "torch_rowmix_layer"
                       layer: "HalfMeanSquare" } }
layer { name: "r" type: "ReLU" bottom: "hc" top: "a" }
layer { name: "ip2" type: "InnerProduct" bottom: "a" top: "y"
        inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "y" bottom: "t" top: "l" }
"""


def _py_solver():
    return ("net_param { " + PY_NET + " }\n"
            'base_lr: 0.05 momentum: 0.9 lr_policy: "fixed" max_iter: 20 '
            'type: "SGD" random_seed: 7')


def _py_feeds(n, seed=5):
    r = np.random.RandomState(seed)
    return [{"x": r.randn(16, 8).astype(np.float32),
             "t": r.randint(0, 4, 16).astype(np.int32)} for _ in range(n)]


def _kitti_text():
    return open(KITTI).read().replace("dim: 8", f"dim: {BATCH}")


class _Spy:
    """Records the rows a host function is handed (patched on its class
    for the life of the fixture)."""

    def __init__(self, cls, name):
        self.cls, self.name, self.real = cls, name, getattr(cls, name)
        self.rows = []
        real, rows = self.real, self.rows

        def spy(obj, first, *rest, **kw):
            rows.append(np.asarray(first[0] if isinstance(first, list)
                                   else first).shape[0])
            return real(obj, first, *rest, **kw)
        setattr(cls, name, spy)

    def undo(self):
        setattr(self.cls, self.name, self.real)


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """The port's ranks (each net and its planted fault) while the JAX
    solvers step on a (2, 1) mesh, their host functions spied on."""
    plain = jact.ReLULayer.apply

    def caffe_relu(self, params, state, bottoms, *, train, rng):
        if self.lp.relu_param and self.lp.relu_param.negative_slope:
            return plain(self, params, state, bottoms, train=train, rng=rng)
        x = self.f(bottoms[0])
        return [jnp.where(x > 0, x, jnp.zeros_like(x))], state

    jact.ReLULayer.apply = caffe_relu
    spies = {
        "kitti": _Spy(jdetection.DetectNetTransformationLayer,
                      "_host_transform"),
        "python": _Spy(torch_rowmix_layer.BatchCenter, "forward"),
        "python_backward": _Spy(torch_rowmix_layer.BatchCenter,
                                "backward")}
    try:
        cases = {"kitti": (_solver_text(_kitti_text()),
                           [_kitti_feed(BATCH, 40 + k) for k in range(ITERS)]),
                 "python": (_py_solver(), _py_feeds(ITERS))}
        jaxes, scs = {}, []
        for name, (text, feeds) in cases.items():
            js, sc = jax_start(text, feeds, 2)
            if name == "kitti":
                fn = _jax_seeds(js, "train_transform")
                sc["masks"] = {(it, 0): {k: v.numpy() for k, v
                                         in fn(it, 0).items()}
                               for it in range(ITERS)}
            jaxes[name] = (js, sc)
            scs += [dict(sc, name=name),
                    dict(sc, name=f"{name}_local", host_local=True)]
        ranks = Ranks(scs, 2, str(tmp_path_factory.mktemp("host_dp")),
                      timeout=300.0)
        refs = {name: (js, jax_finish(js, sc))
                for name, (js, sc) in jaxes.items()}
        results = ranks.results()
    finally:
        jact.ReLULayer.apply = plain
        for spy in spies.values():
            spy.undo()
    return results, refs, {k: s.rows for k, s in spies.items()}


def test_the_jax_callback_is_handed_the_global_batch(spawn):
    """`jax.pure_callback` without a sharding gathers its operands: each
    step hands DetectNet's host transform and the Python layer's forward
    and backward the whole global batch, once."""
    _, _, rows = spawn
    assert rows["kitti"] == [BATCH] * ITERS
    assert rows["python"] == [16] * ITERS
    assert rows["python_backward"] == [16] * ITERS


@pytest.mark.parametrize("name", ["kitti", "python"])
def test_host_layer_net_trains_on_two_ranks_as_the_jax_mesh(spawn, name):
    results, refs, _ = spawn
    js, losses = refs[name]
    assert_ranks_equal(results, name)
    res = results[0][name]
    assert res["stats"]["mode"] == "implicit"  # the flat reduce
    assert res["graph_route"].startswith("eager")
    assert_like_jax(js, losses, res)


@pytest.mark.parametrize("name", ["kitti", "python"])
def test_host_step_on_the_ranks_own_rows_breaks_parity(spawn, name):
    """The planted fault: each rank steps its host layer on its own rows
    (DetectNet draws by local row index, BatchCenter centres on the
    rank's mean). Its run must fall outside the bars."""
    results, refs, _ = spawn
    js, losses = refs[name]
    with pytest.raises(AssertionError):
        assert_like_jax(js, losses, results[0][f"{name}_local"])
