"""Port parity: a parameter shared by name between a use with `lr_mult: 0`
and a trained use. The JAX Net wraps each TRAIN use whose own ParamSpec
has lr_mult 0 in `stop_gradient` (caffe_mpi_tpu/net.py _layer_params);
the port's Net detaches that use and keeps the one `nn.Parameter`.

The net: data (2, 4) into two InnerProducts (3 outputs, no bias) sharing
`param { name: "w" }`, an Eltwise SUM and a SoftmaxWithLoss, labels
(0, 2). The frozen use is the second layer (over a trained owner) or the
first (the owner itself). Gradients within 1e-6 of `jax.grad`, and 5 SGD
iterations within 1e-5 of the JAX Solver.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.net import Net as JaxNet
from caffe_mpi_tpu.proto import NetParameter as JaxNP
from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu_torch.net import Net
from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
from caffe_mpi_tpu_torch.solver import Solver
from caffe_mpi_tpu_torch.weights import load_jax_params
from test_torch_train import _host

LABELS = np.array([0, 2])


def _net(lr1, lr2):
    return f'''
layer {{ name: "in" type: "Input" top: "data" top: "label"
  input_param {{ shape {{ dim: 2 dim: 4 }} shape {{ dim: 2 }} }} }}
layer {{ name: "ip1" type: "InnerProduct" bottom: "data" top: "a"
  param {{ name: "w" lr_mult: {lr1} }}
  inner_product_param {{ num_output: 3 bias_term: false
    weight_filler {{ type: "gaussian" std: 0.5 }} }} }}
layer {{ name: "ip2" type: "InnerProduct" bottom: "data" top: "b"
  param {{ name: "w" lr_mult: {lr2} }}
  inner_product_param {{ num_output: 3 bias_term: false }} }}
layer {{ name: "sum" type: "Eltwise" bottom: "a" bottom: "b" top: "c" }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "c" bottom: "label"
  top: "loss" }}
'''


def _data(seed):
    return np.random.RandomState(seed).randn(2, 4).astype(np.float32)


@pytest.mark.parametrize("lrs", [(1, 0), (0, 1)])
def test_shared_param_gradient_is_the_jax_gradient(lrs):
    text = _net(*lrs)
    jnet = JaxNet(JaxNP.from_text(text), "TRAIN")
    w = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    params = {"ip1": {"weight": jnp.asarray(w)}}
    x = _data(1)

    def loss(p):
        return jnet.apply(p, {}, {"data": jnp.asarray(x),
                                  "label": jnp.asarray(LABELS)},
                          train=True)[2]

    want = np.asarray(jax.grad(loss)(params)["ip1"]["weight"])
    net = Net(NetParameter.from_text(text), "TRAIN", device="cpu")
    assert net.layer_by_name("ip2").weight is net.layer_by_name("ip1").weight
    weight = net.layer_by_name("ip1").weight
    with torch.no_grad():
        weight.copy_(torch.from_numpy(w))
    weight.requires_grad_(True)
    _, got = net({"data": torch.from_numpy(x),
                  "label": torch.from_numpy(LABELS)})
    got.backward()
    np.testing.assert_allclose(weight.grad.numpy(), want, rtol=1e-6,
                               atol=1e-6)
    assert np.abs(want).max() > 1e-3  # the trained use carries a gradient


@pytest.mark.parametrize("lrs", [(1, 0), (0, 1)])
def test_five_sgd_iterations_with_a_shared_frozen_use_match_jax(lrs):
    text = ('net_param { ' + _net(*lrs) + ' } base_lr: 0.1 momentum: 0.9 '
            'weight_decay: 0.001 lr_policy: "fixed" max_iter: 5 '
            'random_seed: 3')
    jsolver = JaxSolver(JaxSP.from_text(text))
    port = Solver(SolverParameter.from_text(text), device="cpu")
    load_jax_params(port.net, _host(jsolver.params))
    w0 = port.net.layer_by_name("ip1").weight.detach().clone()
    feeds = [{"data": _data(10 + k), "label": LABELS} for k in range(5)]
    jlosses = [jsolver.step(1, lambda k: feeds[k]) for _ in range(5)]
    port.step(5, lambda k: {key: torch.from_numpy(v)
                            for key, v in feeds[k].items()})
    np.testing.assert_allclose(port.losses, jlosses, rtol=1e-5)
    got = port.net.layer_by_name("ip1").weight.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(
        jsolver.params["ip1"]["weight"]), rtol=1e-5, atol=1e-5)
    # trained when the owner's lr_mult is 1, frozen when it is 0
    assert (not np.array_equal(got, w0.numpy())) == (lrs[0] == 1)
