"""Port parity: each layer of the serving slice against its JAX layer.

The same prototxt layer text builds the JAX layer (caffe_mpi_tpu/layers/)
and the port's (caffe_mpi_tpu_torch/layers/); the JAX layer's initialized
params are copied into the port's under the same names and layouts, and the
same numpy input goes through both. Tolerance rtol 1e-5 / atol 1e-5: both
compute in float32, but convolution, product and pooling sums run in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.core.types import DtypePolicy as JaxPolicy
from caffe_mpi_tpu.layers import create_layer as jax_create_layer
from caffe_mpi_tpu.proto import LayerParameter as JaxLP
from caffe_mpi_tpu_torch.core.types import DtypePolicy
from caffe_mpi_tpu_torch.layers import create_layer
from caffe_mpi_tpu_torch.proto import LayerParameter

TOL = dict(rtol=1e-5, atol=1e-5)


def _run_both(text, shape, seed=0, scale=1.0):
    jl = jax_create_layer(JaxLP.from_text(text), JaxPolicy(), "TEST")
    jl.in_shapes = [shape]
    jl.out_shapes = jl.setup([shape])
    params = jl.init_params(jax.random.PRNGKey(seed))
    tl = create_layer(LayerParameter.from_text(text), DtypePolicy(), "TEST",
                      torch.device("cpu")).eval()
    tl.in_shapes = [shape]
    tl.out_shapes = tl.setup([shape])
    assert list(tl.decls) == list(params)
    with torch.no_grad():
        for name, arr in params.items():
            p = getattr(tl, name)
            assert tuple(p.shape) == tuple(arr.shape), name
            p.copy_(torch.from_numpy(np.array(arr)))
    x = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    (want,), _ = jl.apply(params, {}, [jnp.asarray(x)], train=False,
                          rng=None)
    (got,) = tl([torch.from_numpy(x)])
    assert tuple(got.shape) == tuple(want.shape) == tuple(jl.out_shapes[0])
    assert tuple(tl.out_shapes[0]) == tuple(jl.out_shapes[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


CONV = [
    # AlexNet conv1-like: large kernel, stride, no pad
    ('num_output: 6 kernel_size: 5 stride: 2', (1, 3, 15, 15)),
    # group 2 with pad (conv2/4/5), gaussian bias so the bias path counts
    ('num_output: 8 kernel_size: 3 pad: 1 group: 2', (2, 4, 9, 9)),
    # stride + pad + dilation + group together
    ('num_output: 4 kernel_size: 3 stride: 2 pad: 2 dilation: 2 group: 2',
     (1, 4, 11, 10)),
    # rectangular kernel and stride through the _h/_w fields
    ('num_output: 3 kernel_h: 3 kernel_w: 2 stride_h: 2 stride_w: 1 '
     'pad_h: 1 pad_w: 0', (2, 2, 8, 7)),
]


@pytest.mark.parametrize("spec,shape", CONV)
def test_convolution(spec, shape):
    text = ('name: "c" type: "Convolution" bottom: "x" top: "y" '
            f'convolution_param {{ {spec} weight_filler {{ type: "xavier" }} '
            'bias_filler { type: "gaussian" std: 0.5 } }')
    _run_both(text, shape)


POOL = [
    ('kernel_size: 3 stride: 2', (2, 3, 13, 13)),          # AlexNet pools
    ('kernel_size: 3 stride: 2 pad: 1', (1, 2, 10, 11)),
    ('kernel_size: 2 stride: 3', (1, 2, 10, 11)),          # stride > kernel
    ('kernel_size: 3 stride: 2 pad_h: 0 pad_w: 1', (1, 2, 9, 8)),
    ('kernel_h: 2 kernel_w: 3 stride_h: 1 stride_w: 2 pad_w: 1', (1, 2, 6, 7)),
    ('global_pooling: true', (2, 3, 5, 4)),
]


@pytest.mark.parametrize("method", ["MAX", "AVE"])
@pytest.mark.parametrize("spec,shape", POOL)
def test_pooling(method, spec, shape):
    text = ('name: "p" type: "Pooling" bottom: "x" top: "y" '
            f'pooling_param {{ pool: {method} {spec} }}')
    _run_both(text, shape)


IP = [
    ('num_output: 7', (2, 3, 4, 5)),              # axis 1: K = 60
    ('num_output: 5 axis: 2', (2, 3, 4, 5)),      # lead (2, 3), K = 20
    ('num_output: 6 transpose: true', (3, 10)),   # (K, N) weight layout
    ('num_output: 4 axis: -1', (2, 3, 6)),
]


@pytest.mark.parametrize("spec,shape", IP)
def test_inner_product(spec, shape):
    text = ('name: "ip" type: "InnerProduct" bottom: "x" top: "y" '
            f'inner_product_param {{ {spec} weight_filler {{ type: "xavier" }} '
            'bias_filler { type: "gaussian" std: 0.5 } }')
    _run_both(text, shape)


@pytest.mark.parametrize("slope", ["", "relu_param { negative_slope: 0.1 }"])
def test_relu(slope):
    _run_both(f'name: "r" type: "ReLU" bottom: "x" top: "x" {slope}',
              (2, 3, 4, 5))


def test_dropout_is_identity_at_test():
    _run_both('name: "d" type: "Dropout" bottom: "x" top: "x" '
              'dropout_param { dropout_ratio: 0.5 }', (4, 10))


@pytest.mark.parametrize("axis,shape", [("", (3, 10)),
                                        ("softmax_param { axis: -1 }",
                                         (2, 3, 4)),
                                        ("softmax_param { axis: 2 }",
                                         (2, 3, 4, 2))])
def test_softmax(axis, shape):
    _run_both(f'name: "s" type: "Softmax" bottom: "x" top: "y" {axis}',
              shape, scale=3.0)


@pytest.mark.parametrize("filler,check", [
    ('type: "constant" value: 0.25', lambda t: bool((t == 0.25).all())),
    ('type: "uniform" min: -2 max: 3',
     lambda t: bool(t.min() >= -2 and t.max() <= 3)),
    ('type: "gaussian" mean: 1 std: 0.5',
     lambda t: abs(t.mean() - 1) < 0.05 and abs(t.std() - 0.5) < 0.05),
    # xavier: U(-s, s), s = sqrt(3 / fan_in), fan_in = 8*3*3 = 72
    ('type: "xavier"', lambda t: abs(t.abs().max() - (3 / 72) ** 0.5) < 0.01
     and abs(t.std() - (1 / 72) ** 0.5) < 0.01),
    # msra with FAN_OUT: std = sqrt(2 / fan_out), fan_out = 16*3*3 = 144
    ('type: "msra" variance_norm: FAN_OUT',
     lambda t: abs(t.std() - (2 / 144) ** 0.5) < 0.01),
])
def test_fillers_by_distribution(filler, check):
    from caffe_mpi_tpu_torch.core.fillers import fill
    from caffe_mpi_tpu_torch.proto import FillerParameter
    t = fill(FillerParameter.from_text(filler), torch.Generator().manual_seed(0),
             (16, 8, 3, 3))
    assert check(t.double()), filler
