"""Port parity: a narrowed AlexNet deploy net, JAX `Net` vs the port's `Net`.

Same layer types and order as models/alexnet/deploy.prototxt (group-2
convolutions, two across-channel LRNs, ceil-mode pools, dropout, softmax),
narrowed to a 3x67x67 input, channels 8/16/24/24/16, fc 32 and 10 classes.
The input is unit-scale, so AlexNet's LRN alpha (1e-4) would leave the
LRNs near identity; alpha is 0.05 here so that they normalize for real.
The JAX `Net.init` weights go into the port through `load_jax_params`, and
every blob of the forward is compared at rtol 1e-4 / atol 1e-5 (float32
throughout; the sums of eight layers run in another order). A .caffemodel
written by the JAX package loads through the port's own io.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_mpi_tpu import io as jax_io
from caffe_mpi_tpu.net import Net as JaxNet
from caffe_mpi_tpu.proto import NetParameter as JaxNP
from caffe_mpi_tpu_torch import io as port_io
from caffe_mpi_tpu_torch.net import Net
from caffe_mpi_tpu_torch.proto import NetParameter
from caffe_mpi_tpu_torch.weights import load_jax_params

TOL = dict(rtol=1e-4, atol=1e-5)


def _conv(name, bottom, n, k, stride=1, pad=0, group=1):
    return f'''layer {{ name: "{name}" type: "Convolution" bottom: "{bottom}"
  top: "{name}" convolution_param {{ num_output: {n} kernel_size: {k}
  stride: {stride} pad: {pad} group: {group}
  weight_filler {{ type: "xavier" }}
  bias_filler {{ type: "constant" value: 0.1 }} }} }}
layer {{ name: "relu_{name}" type: "ReLU" bottom: "{name}" top: "{name}" }}
'''


def _pool(name, bottom):
    return f'''layer {{ name: "{name}" type: "Pooling" bottom: "{bottom}"
  top: "{name}" pooling_param {{ pool: MAX kernel_size: 3 stride: 2 }} }}
'''


def _lrn(name, bottom):
    return f'''layer {{ name: "{name}" type: "LRN" bottom: "{bottom}"
  top: "{name}" lrn_param {{ local_size: 5 alpha: 0.05 beta: 0.75 }} }}
'''


def _fc(name, bottom, n, relu=True, drop=True):
    s = f'''layer {{ name: "{name}" type: "InnerProduct" bottom: "{bottom}"
  top: "{name}" inner_product_param {{ num_output: {n}
  weight_filler {{ type: "xavier" }}
  bias_filler {{ type: "constant" value: 0.1 }} }} }}
'''
    if relu:
        s += (f'layer {{ name: "relu_{name}" type: "ReLU" bottom: "{name}" '
              f'top: "{name}" }}\n')
    if drop:
        s += (f'layer {{ name: "drop_{name}" type: "Dropout" bottom: "{name}" '
              f'top: "{name}" dropout_param {{ dropout_ratio: 0.5 }} }}\n')
    return s


def small_alexnet(batch=2):
    return (f'name: "SmallAlexNet"\nlayer {{ name: "data" type: "Input" '
            f'top: "data" input_param {{ shape {{ dim: {batch} dim: 3 '
            'dim: 67 dim: 67 } } }\n'
            + _conv("conv1", "data", 8, 11, stride=4) + _lrn("norm1", "conv1")
            + _pool("pool1", "norm1")
            + _conv("conv2", "pool1", 16, 5, pad=2, group=2)
            + _lrn("norm2", "conv2") + _pool("pool2", "norm2")
            + _conv("conv3", "pool2", 24, 3, pad=1)
            + _conv("conv4", "conv3", 24, 3, pad=1, group=2)
            + _conv("conv5", "conv4", 16, 3, pad=1, group=2)
            + _pool("pool5", "conv5")
            + _fc("fc6", "pool5", 32) + _fc("fc7", "fc6", 32)
            + _fc("fc8", "fc7", 10, relu=False, drop=False)
            + 'layer { name: "prob" type: "Softmax" bottom: "fc8" '
              'top: "prob" }\n')


def _input(batch=2, seed=0):
    return np.random.RandomState(seed).randn(batch, 3, 67, 67).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_side():
    net = JaxNet(JaxNP.from_text(small_alexnet()), phase="TEST")
    params, state = net.init(jax.random.PRNGKey(0))
    x = _input()
    env, _, _ = net.forward(params, state, {"data": jnp.asarray(x)})
    return net, params, state, x, {k: np.asarray(v) for k, v in env.items()}


def _port_net():
    return Net(NetParameter.from_text(small_alexnet()), device="cpu")


def _port_forward(net, x):
    with torch.inference_mode():
        return {k: v.numpy() for k, v in
                net({"data": torch.from_numpy(x)})[0].items()}


def test_shapes_and_param_layouts_match(jax_side):
    jnet, params, _, _, _ = jax_side
    net = _port_net()
    assert net.blob_shapes == jnet.blob_shapes
    assert net.blob_shapes["pool5"] == (2, 16, 1, 1)  # ceil-mode pools
    for lname, blobs in params.items():
        layer = net.layer_by_name(lname)
        for pname, arr in blobs.items():
            assert tuple(getattr(layer, pname).shape) == tuple(arr.shape)


def test_every_blob_matches_on_carried_weights(jax_side):
    _, params, state, x, want = jax_side
    net = _port_net()
    load_jax_params(net, jax.tree_util.tree_map(np.asarray, params), state)
    got = _port_forward(net, x)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **TOL)
    # the LRNs did normalize: norm1 differs from its input by more than
    # the tolerance
    assert np.abs(got["norm1"] - got["conv1"]).max() > 1e-2


def test_caffemodel_written_by_jax_loads_through_port_io(jax_side, tmp_path):
    jnet, params, state, x, want = jax_side
    path = str(tmp_path / "small.caffemodel")
    jax_io.save_caffemodel(path, jnet.export_weights(params, state),
                           net_name="SmallAlexNet")
    net = _port_net()
    net.import_weights(port_io.load_weights(path), strict=True)
    got = _port_forward(net, x)
    np.testing.assert_allclose(got["prob"], want["prob"], **TOL)
    # and the port exports the same blobs back
    exported = net.export_weights()
    for lname, blobs in jnet.export_weights(params, state).items():
        for a, b in zip(blobs, exported[lname]):
            np.testing.assert_array_equal(a, b)


def test_load_jax_params_is_a_checked_copy(jax_side):
    _, params, _, _, _ = jax_side
    host = jax.tree_util.tree_map(np.asarray, params)
    net = _port_net()
    bad = {k: dict(v) for k, v in host.items()}
    bad["conv1"]["weight"] = bad["conv1"]["weight"][:, :, :5]
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(net, bad)
    missing = {k: dict(v) for k, v in host.items()}
    del missing["fc8"]
    with pytest.raises(KeyError, match="fc8"):
        load_jax_params(net, missing)
    extra = {k: dict(v) for k, v in host.items()}
    extra["conv1"]["gamma"] = host["conv1"]["bias"]
    with pytest.raises(KeyError, match="gamma"):
        load_jax_params(net, extra)
    with pytest.raises(KeyError, match="nope"):
        load_jax_params(net, {"nope": {}})


def test_in_place_tops_rebind_without_clobbering():
    net = _port_net()
    net.init(0)
    x = _input(seed=1)
    env = _port_forward(net, x)
    # conv1's blob is the ReLU'd value (top == bottom rebinds the env)
    assert env["conv1"].min() >= 0.0
    assert net.training is False  # deploy nets run in TEST phase


def test_seeded_init_is_deterministic_and_fills_every_param():
    a, b = _port_net(), _port_net()
    a.init(7)
    b.init(7)
    for (la, pa), (lb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), la
    assert torch.allclose(a.layer_by_name("conv1").bias,
                          torch.full((8,), 0.1))


def test_entry_point_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Net(NetParameter.from_text(small_alexnet()))
