"""Port parity: the rest of the JAX package's layer types (27), STOCHASTIC
pooling, the bilinear and positive_unitball fillers, and `remat`, against
the JAX layers and nets on the CPU.

Each layer is built in both packages, fed the same numpy params and
bottoms, and held forward and backward: the gradient is that of
sum_i <top_i, w_i> (in float32) with respect to the params and the float
bottoms, through jax.grad and torch autograd; in float32 and under the
FLOAT16 (bfloat16) policy. STOCHASTIC pooling in TRAIN takes the JAX
layer's own draw, `jax.random.uniform(key, (n, c, oh, ow))`, handed to the
port as its mask. ArgMax is held on inputs with ties.

Tolerances: f32 tops rtol 1e-5 / atol 1e-6 of the largest element,
gradients rtol 1e-5 / atol 1e-5 of the largest (the same f32 math,
reductions in other orders); bf16 LAYER_FWD / LAYER_GRAD
(tests/test_torch_precision.py: two bf16 ulps of the largest element for
tops and four for gradients); loss tops in f32 at the f32 tolerance.
`remat: true` is bitwise the run without it, and the JAX net's at the f32
tolerances.
"""

import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.core.fillers import fill as jax_fill
from caffe_mpi_tpu.core.types import DtypePolicy as JaxPolicy
from caffe_mpi_tpu.io import save_blob_binaryproto
from caffe_mpi_tpu.layers import create_layer as jax_create_layer
from caffe_mpi_tpu.net import Net as JaxNet
from caffe_mpi_tpu.proto import FillerParameter as JaxFP
from caffe_mpi_tpu.proto import LayerParameter as JaxLP
from caffe_mpi_tpu.proto import NetParameter as JaxNP
from caffe_mpi_tpu_torch.core.fillers import fill
from caffe_mpi_tpu_torch.core.types import DtypePolicy
from caffe_mpi_tpu_torch.layers import LAYER_REGISTRY, create_layer
from caffe_mpi_tpu_torch.net import Net
from caffe_mpi_tpu_torch.proto import FillerParameter, LayerParameter
from caffe_mpi_tpu_torch.proto import NetParameter
from caffe_mpi_tpu_torch.weights import load_jax_params
from test_torch_precision import (F32_OUT, JAX_BF16, LAYER_FWD, LAYER_GRAD,
                                  PORT_BF16, _close)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_GRAD = dict(rtol=1e-5, atol=1e-5)
POOL_U = "u"  # a STOCHASTIC TRAIN case: JAX draws, the port is handed u

# the 27 types, each in at least one case: (layer text, bottoms, loss)
# bottoms: a shape (seeded normal), or ("pos", shape) positive,
# ("prob", shape) softmax rows, ("label", n, k) int labels,
# ("binary", shape) 0/1 floats, ("index", values), ("ties", shape)
CASES = {
    "prelu": ('type: "PReLU"', [(2, 3, 4, 5)], False),
    "prelu_shared": ('type: "PReLU" prelu_param { channel_shared: true }',
                     [(2, 3, 4)], False),
    "elu": ('type: "ELU" elu_param { alpha: 0.5 }', [(2, 3, 4, 5)], False),
    "tanh": ('type: "TanH"', [(2, 3, 4, 5)], False),
    "bnll": ('type: "BNLL"', [(2, 3, 4, 5)], False),
    "power": ('type: "Power" power_param { power: 1.5 scale: 0.5 '
              'shift: 3 }', [(2, 3, 4, 5)], False),
    "power_square": ('type: "Power" power_param { power: 2 scale: -1 }',
                     [(2, 3, 4)], False),
    "exp": ('type: "Exp"', [(2, 3, 4, 5)], False),
    "exp_base": ('type: "Exp" exp_param { base: 2 scale: 0.5 shift: 0.1 }',
                 [(2, 3, 4)], False),
    "log": ('type: "Log"', [("pos", (2, 3, 4, 5))], False),
    "log_base": ('type: "Log" log_param { base: 10 scale: 0.5 shift: 3 }',
                 [(2, 3, 4)], False),
    "absval": ('type: "AbsVal"', [(2, 3, 4, 5)], False),
    "threshold": ('type: "Threshold" threshold_param { threshold: 0.2 }',
                  [(2, 3, 4, 5)], False),
    "split": ('type: "Split" top: "y2"', [(2, 3, 4)], False),
    "flatten": ('type: "Flatten"', [(2, 3, 4, 5)], False),
    "flatten_axes": ('type: "Flatten" flatten_param { axis: 2 end_axis: 3 }',
                     [(2, 3, 4, 5, 2)], False),
    "reshape": ('type: "Reshape" reshape_param { shape { dim: 0 dim: -1 '
                'dim: 5 } }', [(2, 3, 4, 5)], False),
    "reshape_axes": ('type: "Reshape" reshape_param { shape { dim: 2 '
                     'dim: 2 } axis: 1 num_axes: 1 }', [(2, 4, 3)], False),
    "reduction_sum": ('type: "Reduction"', [(2, 3, 4)], False),
    "reduction_asum": ('type: "Reduction" reduction_param { operation: '
                       'ASUM axis: 1 }', [(2, 3, 4)], False),
    "reduction_sumsq": ('type: "Reduction" reduction_param { operation: '
                        'SUMSQ axis: 2 coeff: 0.5 }', [(2, 3, 4)], False),
    "reduction_mean": ('type: "Reduction" reduction_param { operation: '
                       'MEAN axis: -1 coeff: -2 }', [(2, 3, 4)], False),
    "argmax": ('type: "ArgMax" argmax_param { top_k: 3 }',
               [("ties", (4, 3, 2, 2))], False),
    "argmax_max_val": ('type: "ArgMax" argmax_param { top_k: 2 '
                       'out_max_val: true }', [("ties", (4, 10))], False),
    "argmax_axis": ('type: "ArgMax" argmax_param { top_k: 2 axis: 1 }',
                    [("ties", (3, 6, 2))], False),
    "argmax_axis_values": ('type: "ArgMax" argmax_param { top_k: 1 axis: 2 '
                           'out_max_val: true }', [("ties", (3, 2, 5))],
                           False),
    "silence": ('type: "Silence" bottom: "b"', [(2, 3), (4,)], False),
    "batch_reindex": ('type: "BatchReindex" bottom: "i"',
                      [(4, 3, 2), ("index", [3, 0, 0, 2, 1, 3])], False),
    "sigmoid_ce": ('type: "SigmoidCrossEntropyLoss" bottom: "t"',
                   [(4, 5), ("binary", (4, 5))], True),
    "sigmoid_ce_ignore": ('type: "SigmoidCrossEntropyLoss" bottom: "t" '
                          'loss_param { ignore_label: -1 }',
                          [(4, 5), ("ternary", (4, 5))], True),
    "hinge_l1": ('type: "HingeLoss" bottom: "l"',
                 [(6, 5), ("label", 6, 5)], True),
    "hinge_l2": ('type: "HingeLoss" bottom: "l" hinge_loss_param { norm: '
                 'L2 }', [(6, 5, 1, 1), ("label", 6, 5)], True),
    "multinomial_logistic": ('type: "MultinomialLogisticLoss" bottom: "l"',
                             [("prob", (6, 5)), ("label", 6, 5)], True),
    "infogain": ('type: "InfogainLoss" bottom: "l" bottom: "h"',
                 [("prob", (6, 5)), ("label", 6, 5), ("pos", (1, 1, 5, 5))],
                 True),
    "mvn": ('type: "MVN"', [(2, 3, 4, 5)], False),
    "mvn_across": ('type: "MVN" mvn_param { across_channels: true '
                   'eps: 0.001 }', [(2, 3, 4, 5)], False),
    "mvn_mean_only": ('type: "MVN" mvn_param { normalize_variance: false }',
                      [(2, 3, 4)], False),
    "deconv": ('type: "Deconvolution" convolution_param { num_output: 4 '
               'kernel_size: 4 stride: 2 pad: 1 }', [(2, 3, 5, 5)], False),
    "deconv_group_dilation": (
        'type: "Deconvolution" convolution_param { num_output: 6 '
        'kernel_size: 3 stride: 3 pad: 2 dilation: 2 group: 3 }',
        [(2, 3, 4, 5)], False),
    "deconv_no_bias": ('type: "Deconvolution" convolution_param { '
                       'num_output: 2 kernel_h: 2 kernel_w: 3 stride: 1 '
                       'bias_term: false }', [(1, 2, 3, 3)], False),
    "im2col": ('type: "Im2col" convolution_param { kernel_size: 3 }',
               [(2, 3, 6, 5)], False),
    "im2col_strided": ('type: "Im2col" convolution_param { kernel_size: 3 '
                       'stride: 2 pad: 1 dilation: 2 }', [(2, 2, 7, 7)],
                       False),
    "crop": ('type: "Crop" bottom: "ref" crop_param { offset: 1 }',
             [(2, 3, 7, 6), (2, 1, 4, 3)], False),
    "crop_per_axis": ('type: "Crop" bottom: "ref" crop_param { axis: 1 '
                      'offset: 1 offset: 2 offset: 0 }',
                      [(2, 4, 7, 6), (2, 2, 4, 6)], False),
    "spp_max": ('type: "SPP" spp_param { pyramid_height: 3 }',
                [(2, 3, 7, 9)], False),
    "spp_ave": ('type: "SPP" spp_param { pyramid_height: 2 pool: AVE }',
                [(2, 3, 6, 5)], False),
    "filter": ('type: "Filter" bottom: "s" top: "y2"',
               [(4, 3, 2), ("binary", (4,))], False),
    "filter_mask": ('type: "Filter" bottom: "b2" bottom: "s" top: "y2" '
                    'top: "m"', [(4, 3), (4, 2, 2), ("binary", (4, 1))],
                    False),
    "python_loss": ('type: "Python" bottom: "t" loss_weight: 1 '
                    'python_param { module: "layers.pyloss" '
                    'layer: "EuclideanLossLayer" }', [(4, 3), (4, 3)], True),
    "python_forward_only": ('type: "Python" python_param { '
                            'module: "zoo_rest_pylayer" layer: "Doubler" }',
                            [(2, 3, 4)], False),
    "pool_stochastic_test": ('type: "Pooling" pooling_param { pool: '
                             'STOCHASTIC kernel_size: 3 stride: 2 }',
                             [("pos", (2, 3, 8, 7))], "TEST"),
    "pool_stochastic_train": ('type: "Pooling" pooling_param { pool: '
                              'STOCHASTIC kernel_size: 3 stride: 2 }',
                              [("pos", (2, 3, 8, 7))], POOL_U),
    "pool_stochastic_train_zeros": (
        'type: "Pooling" pooling_param { pool: STOCHASTIC kernel_size: 2 '
        'stride: 2 }', [("relu", (2, 2, 5, 6))], POOL_U),
}

NEW_TYPES = {
    "PReLU", "ELU", "TanH", "BNLL", "Power", "Exp", "Log", "AbsVal",
    "Threshold", "Split", "Flatten", "Reshape", "Reduction", "ArgMax",
    "Silence", "BatchReindex", "SigmoidCrossEntropyLoss", "HingeLoss",
    "MultinomialLogisticLoss", "InfogainLoss", "MVN", "Deconvolution",
    "Im2col", "Crop", "SPP", "Filter", "Python"}

_PYLAYER = '''import numpy as np


class Doubler:
    def infer_shapes(self, bottom_shapes):
        return [tuple(bottom_shapes[0])]

    def forward(self, bottoms):
        return [2.0 * bottoms[0]]
'''


@pytest.fixture(scope="module", autouse=True)
def _python_layers(tmp_path_factory):
    """examples/pycaffe's layers package and a forward-only user layer on
    sys.path, as a Python layer's module must be importable."""
    d = tmp_path_factory.mktemp("pylayers")
    (d / "zoo_rest_pylayer.py").write_text(_PYLAYER)
    added = [str(d), os.path.join(_ROOT, "examples", "pycaffe")]
    sys.path[:0] = added
    yield
    for p in added:
        sys.path.remove(p)


def _layer_text(body: str, n_bottoms: int) -> str:
    text = f'name: "l" {body}'
    if 'bottom: "x"' not in text:
        text = text.replace("name: \"l\" ", 'name: "l" bottom: "x" ', 1)
    if 'type: "Silence"' not in text and 'top: "y"' not in text:
        text += ' top: "y"'
    return text


def _bottoms(specs, seed=1):
    r = np.random.RandomState(seed)
    out = []
    for s in specs:
        kind, shape = ("normal", s) if isinstance(s[0], int) else (s[0], s)
        if kind == "normal":
            out.append(r.randn(*shape).astype(np.float32))
        elif kind == "pos":
            out.append((r.rand(*s[1]) + 0.1).astype(np.float32))
        elif kind == "relu":  # windows of zeros among positive values
            out.append(np.maximum(r.randn(*s[1]), 0).astype(np.float32))
        elif kind == "prob":
            z = np.exp(r.randn(*s[1]))
            out.append((z / z.sum(1, keepdims=True)).astype(np.float32))
        elif kind == "label":
            out.append(r.randint(0, s[2], size=(s[1],)).astype(np.int32))
        elif kind == "binary":
            out.append(r.randint(0, 2, size=s[1]).astype(np.float32))
        elif kind == "ternary":  # 0, 1 and the ignore label -1
            out.append(r.randint(-1, 2, size=s[1]).astype(np.float32))
        elif kind == "index":
            out.append(np.asarray(s[1], np.int32))
        elif kind == "ties":  # few distinct values: ties in every row
            out.append(r.randint(0, 3, size=s[1]).astype(np.float32))
    return out


def _both(body, bottoms, jpolicy, ppolicy, fwd, grad, loss,
          param_scale=0.5):
    """One layer in both packages: tops held, and the gradients of a
    weighted sum of the tops by every param and float bottom."""
    mode = loss if isinstance(loss, str) else ""
    phase = "TEST" if mode == "TEST" else "TRAIN"
    f32_tops = loss is True
    text = _layer_text(body, len(bottoms))
    shapes = [tuple(b.shape) for b in bottoms]
    jl = jax_create_layer(JaxLP.from_text(text), jpolicy, phase)
    jl.in_shapes = shapes
    jl.out_shapes = jl.setup(shapes)
    tl = create_layer(LayerParameter.from_text(text), ppolicy, phase,
                      torch.device("cpu"))
    tl.in_shapes = shapes
    tl.out_shapes = tl.setup(shapes)
    tl.train(phase == "TRAIN")
    assert [tuple(s) for s in tl.out_shapes] == \
        [tuple(s) for s in jl.out_shapes]
    rs = np.random.RandomState(5)
    params = {n: (rs.randn(*d.shape) * param_scale).astype(np.float32)
              for n, d in jl.params.items()}
    assert set(params) == set(tl.decls)
    weights = [np.asarray(np.random.RandomState(7 + i).randn(*s),
                          np.float32) for i, s in enumerate(jl.out_shapes)]
    floats = [i for i, b in enumerate(bottoms) if b.dtype == np.float32]
    key = jax.random.PRNGKey(3)

    def jloss(p, fb):
        bs = [jnp.asarray(b) for b in bottoms]
        for i, b in zip(floats, fb):
            bs[i] = b
        tops, _ = jl.apply(p, {}, bs, train=phase == "TRAIN", rng=key)
        return sum((jnp.sum(t.astype(jnp.float32) * w)
                    for t, w in zip(tops, weights)), jnp.zeros(())), tops

    jp = {n: jnp.asarray(a) for n, a in params.items()}
    (_, jtops), (jgp, jgb) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jp, [jnp.asarray(bottoms[i]) for i in floats])
    with torch.no_grad():
        for n, a in params.items():
            getattr(tl, n).copy_(torch.from_numpy(a))
    for n in params:
        getattr(tl, n).requires_grad_(True)
    tb = [torch.from_numpy(b.copy()) for b in bottoms]
    for i in floats:
        tb[i].requires_grad_(True)
    kw = {}
    if mode == POOL_U:
        n, c, oh, ow = jl.out_shapes[0]
        kw["mask"] = torch.from_numpy(np.asarray(
            jax.random.uniform(key, (n, c, oh, ow))))
    tops = tl(tb, **kw)
    report = []
    assert len(tops) == len(jtops)
    for k, (got, want) in enumerate(zip(tops, jtops)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype), \
            (k, got.dtype, want.dtype)
        _close(got.detach().float().numpy(),
               np.asarray(want.astype(jnp.float32)),
               F32_OUT if f32_tops else fwd, f"top {k}", report)
    total = sum((t.float() * torch.from_numpy(w)).sum()
                for t, w in zip(tops, weights))
    if isinstance(total, torch.Tensor) and total.requires_grad:
        total.backward()
    for n in params:
        g = getattr(tl, n).grad
        got = np.zeros(params[n].shape) if g is None else g.float().numpy()
        _close(got, jgp[n], grad, f"grad {n}", report)
    for i, g in zip(floats, jgb):
        got = tb[i].grad
        got = np.zeros(bottoms[i].shape) if got is None \
            else got.float().numpy()
        _close(got, np.asarray(g, np.float32), grad, f"grad bottom {i}",
               report)
    return tl, tops, report


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_f32_forward_and_gradients_match_jax(case):
    body, specs, loss = CASES[case]
    _, tops, report = _both(body, _bottoms(specs), JaxPolicy(),
                            DtypePolicy(), F32_OUT, F32_GRAD, loss)
    print(case, report)
    assert all(t.dtype == torch.float32 for t in tops)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_bf16_forward_and_gradients_match_jax(case):
    body, specs, loss = CASES[case]
    _, tops, report = _both(body, _bottoms(specs), JAX_BF16, PORT_BF16,
                            LAYER_FWD, LAYER_GRAD, loss)
    print(case, report)
    # loss tops stay f32, but a Python layer's take the policy's type
    assert loss is not True or case.startswith("python") \
        or tops[0].dtype == torch.float32


def test_every_jax_type_but_pipeline_is_registered():
    from caffe_mpi_tpu.layers.base import LAYER_REGISTRY as JAX_REGISTRY
    # Pipeline is registered too (layers/composite.py)
    assert set(JAX_REGISTRY) - set(LAYER_REGISTRY) == set()
    assert NEW_TYPES <= set(LAYER_REGISTRY)
    covered = {LayerParameter.from_text(_layer_text(b, len(s))).type
               for b, s, _ in CASES.values()}
    assert NEW_TYPES <= covered


def test_argmax_ties_take_the_lower_index_first():
    tl = create_layer(LayerParameter.from_text(
        'name: "a" type: "ArgMax" bottom: "x" top: "y" argmax_param { '
        'top_k: 3 out_max_val: true }'), DtypePolicy(), "TEST",
        torch.device("cpu"))
    tl.setup([(1, 6)])
    (y,) = tl([torch.tensor([[1.0, 5.0, 5.0, 0.0, 5.0, 2.0]])])
    assert y.tolist() == [[[1.0, 2.0, 4.0], [5.0, 5.0, 5.0]]]


def test_infogain_matrix_from_a_source_file(tmp_path):
    """H from `infogain_loss_param.source`, a BlobProto the JAX writer
    writes, read relative to the net's model_dir: the loss equals the
    JAX layer's and the port's with H as a third bottom."""
    k = 5
    h = np.random.RandomState(2).rand(1, 1, k, k).astype(np.float32)
    save_blob_binaryproto(str(tmp_path / "H.binaryproto"), h)
    prob, labels = _bottoms([("prob", (6, k)), ("label", 6, k)])
    net = (f'name: "ig" layer {{ name: "in" type: "Input" top: "p" top: "l" '
           f'input_param {{ shape {{ dim: 6 dim: {k} }} shape {{ dim: 6 }} '
           '} } layer { name: "loss" type: "InfogainLoss" bottom: "p" '
           'bottom: "l" top: "loss" infogain_loss_param { source: '
           '"H.binaryproto" } }')
    port = Net(NetParameter.from_text(net), "TRAIN", device="cpu",
               model_dir=str(tmp_path))
    _, loss = port({"p": torch.from_numpy(prob),
                    "l": torch.from_numpy(labels)})
    jnet = JaxNet(JaxNP.from_text(net), "TRAIN", model_dir=str(tmp_path))
    _, _, jloss = jnet.apply({}, {}, {"p": jnp.asarray(prob),
                                      "l": jnp.asarray(labels)}, train=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    _, tops, _ = _both(CASES["infogain"][0], [prob, labels, h],
                       JaxPolicy(), DtypePolicy(), F32_OUT, F32_GRAD, True)
    np.testing.assert_allclose(float(tops[0].detach()), float(loss),
                               rtol=1e-6)


@pytest.mark.parametrize("text,match", [
    ('type: "HDF5Output" bottom: "b" hdf5_output_param { file_name: '
     '"o.h5" }', r"HDF5Output layer is not ported .*ROADMAP\.md §1 item 7"),
    ('type: "Pooling" pooling_param { pool: STOCHASTIC kernel_size: 3 '
     'pad: 1 }', "STOCHASTIC pooling does not support padding"),
])
def test_refused_layers(text, match):
    with pytest.raises((NotImplementedError, ValueError), match=match):
        tl = create_layer(LayerParameter.from_text(
            f'name: "l" bottom: "x" {text}'), DtypePolicy(), "TRAIN",
            torch.device("cpu"))
        tl.setup([(2, 3, 8, 8), (2, 1)])


def test_stochastic_train_draw_is_made_ahead_and_handed_in():
    """A TRAIN forward with a generator draws what `draw_mask` draws from
    the same generator state; a window of zeros gives 0."""
    tl = create_layer(LayerParameter.from_text(
        'name: "p" type: "Pooling" bottom: "x" top: "y" pooling_param { '
        'pool: STOCHASTIC kernel_size: 2 stride: 2 }'), DtypePolicy(),
        "TRAIN", torch.device("cpu"))
    tl.in_shapes = [(2, 3, 6, 6)]
    tl.setup(tl.in_shapes)
    assert tl.needs_rng
    x = torch.from_numpy(_bottoms([("relu", (2, 3, 6, 6))])[0])
    x[0, 0, :2, :2] = 0
    (a,) = tl([x], generator=torch.Generator().manual_seed(4))
    u = tl.draw_mask(torch.Generator().manual_seed(4))
    (b,) = tl([x], mask=u)
    assert torch.equal(a, b) and a[0, 0, 0, 0] == 0
    # every output is one of its window's elements
    win = x.unfold(2, 2, 2).unfold(3, 2, 2).reshape(2, 3, 3, 3, 4)
    assert bool((win == a[..., None]).any(-1).all())


@pytest.mark.parametrize("shape", [(4, 3, 4, 4), (2, 2, 5, 5), (3, 7)])
def test_positive_unitball_and_bilinear_fillers(shape):
    """bilinear: equal to the JAX filler (no draw). positive_unitball:
    the JAX filler's distribution (different generators): each output
    unit's weights in [0, 1], summing to 1."""
    if len(shape) == 4 and shape[2] == shape[3]:
        want = np.asarray(jax_fill(JaxFP(type="bilinear"),
                                   jax.random.PRNGKey(0), shape))
        got = fill(FillerParameter(type="bilinear"), torch.Generator(),
                   shape).numpy()
        np.testing.assert_array_equal(got, want)
    gen = torch.Generator().manual_seed(1)
    got = fill(FillerParameter(type="positive_unitball"), gen, shape)
    want = np.asarray(jax_fill(JaxFP(type="positive_unitball"),
                               jax.random.PRNGKey(0), shape))
    for a in (got.numpy(), want):
        rows = a.reshape(shape[0], -1)
        assert a.shape == shape and rows.min() >= 0 and rows.max() <= 1
        np.testing.assert_allclose(rows.sum(1), 1.0, rtol=1e-6)
    assert fill(FillerParameter(type="positive_unitball"),
                torch.Generator().manual_seed(1), shape).equal(got)


def test_bilinear_deconvolution_upsamples_as_jax():
    """A Deconvolution with the bilinear filler (FCN's upsampling layer)
    initialises as the JAX net does, so the two nets' outputs agree
    without carrying weights."""
    text = ('name: "up" layer { name: "in" type: "Input" top: "x" '
            'input_param { shape { dim: 1 dim: 2 dim: 4 dim: 4 } } } '
            'layer { name: "up" type: "Deconvolution" bottom: "x" top: "y" '
            'convolution_param { num_output: 2 group: 2 kernel_size: 4 '
            'stride: 2 pad: 1 bias_term: false weight_filler { type: '
            '"bilinear" } } }')
    port = Net(NetParameter.from_text(text), "TEST", device="cpu")
    port.init(0)
    jnet = JaxNet(JaxNP.from_text(text), "TEST")
    params, state = jnet.init(jax.random.PRNGKey(0))
    x = _bottoms([(1, 2, 4, 4)])[0]
    env, _ = port({"x": torch.from_numpy(x)})
    jenv, _, _ = jnet.apply(params, state, {"x": jnp.asarray(x)},
                            train=False)
    np.testing.assert_allclose(env["y"].numpy(), np.asarray(jenv["y"]),
                               rtol=1e-6, atol=1e-6)


# -- remat ---------------------------------------------------------------------

def _remat_net(remat: bool, batch: int = 4) -> str:
    flag = " remat: true" if remat else ""
    return f'''name: "remat"
layer {{ name: "in" type: "Input" top: "data" top: "label"
  input_param {{ shape {{ dim: {batch} dim: 3 dim: 12 dim: 12 }}
                 shape {{ dim: {batch} }} }} }}
layer {{ name: "conv1" type: "Convolution" bottom: "data" top: "conv1"{flag}
  convolution_param {{ num_output: 6 kernel_size: 3 pad: 1
    bias_term: false weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "bn1" type: "BatchNorm" bottom: "conv1" top: "conv1"{flag} }}
layer {{ name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }}
layer {{ name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param {{ pool: MAX kernel_size: 2 stride: 2 }} }}
layer {{ name: "norm1" type: "LRN" bottom: "pool1" top: "norm1"{flag}
  lrn_param {{ local_size: 3 alpha: 0.01 beta: 0.75 }} }}
layer {{ name: "conv2" type: "Convolution" bottom: "norm1" top: "conv2"{flag}
  convolution_param {{ num_output: 8 kernel_size: 3 group: 2
    weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "prelu2" type: "PReLU" bottom: "conv2" top: "conv2"{flag} }}
layer {{ name: "fc" type: "InnerProduct" bottom: "conv2" top: "fc"
  inner_product_param {{ num_output: 5 weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "drop" type: "Dropout" bottom: "fc" top: "fc"{flag}
  dropout_param {{ dropout_ratio: 0.3 }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "fc" bottom: "label"
  top: "loss" }}
'''


def _port_grads(net, x, labels, mask, params, state):
    load_jax_params(net, params, state)
    for p in net.parameters():
        p.requires_grad_(True)
        p.grad = None
    env, loss = net({"data": torch.from_numpy(x),
                     "label": torch.from_numpy(labels)},
                    dropout_masks=None if mask is None
                    else {"drop": torch.from_numpy(mask)})
    loss.backward()
    grads = {f"{l.name}.{n}": getattr(l, n).grad.clone()
             for l in net.layers for n in l.decls}
    state = {f"{l.name}.{n}": getattr(l, n).clone()
             for l in net.layers for n in l.state_shapes}
    return env, loss.detach(), grads, state


def test_remat_is_bitwise_and_matches_the_jax_net():
    """`remat: true` on conv, BatchNorm, LRN, PReLU and Dropout: the loss,
    every gradient, every blob and BatchNorm's running statistics are
    bitwise those of the same net without it (the Dropout mask drawn by
    the net's generator, once; the recompute does not move the
    statistics again); and, with the mask handed in, the JAX net's at the
    f32 tolerances (JAX runs those layers under jax.checkpoint)."""
    r = np.random.RandomState(0)
    x = r.randn(4, 3, 12, 12).astype(np.float32)
    labels = r.randint(0, 5, 4).astype(np.int32)
    jnet = JaxNet(JaxNP.from_text(_remat_net(True)), "TRAIN")
    assert [l.lp.remat for l in jnet.layers].count(True) == 6
    params, jstate = jnet.init(jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(np.asarray, params)
    state0 = jax.tree_util.tree_map(np.asarray, jstate)
    runs = {}
    for remat in (False, True):
        net = Net(NetParameter.from_text(_remat_net(remat)), "TRAIN",
                  device="cpu")
        assert sum(l.lp.remat for l in net.layers) == (6 if remat else 0)
        net.init(0)
        gen = torch.Generator().manual_seed(9)
        load_jax_params(net, params, state0)
        for p in net.parameters():
            p.requires_grad_(True)
        env, loss = net({"data": torch.from_numpy(x),
                         "label": torch.from_numpy(labels)}, generator=gen)
        loss.backward()
        runs[remat] = (env, loss, {f"{l.name}.{n}": getattr(l, n).grad
                                   for l in net.layers for n in l.decls},
                       {n: getattr(net.layer_by_name("bn1"), n).clone()
                        for n in ("mean", "var")})
    (e0, l0, g0, s0), (e1, l1, g1, s1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in e0:
        assert torch.equal(e0[k], e1[k]), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k

    # against JAX: its Dropout draws from its key; hand both the same
    # mask by setting the ratio's draw through the port's mask argument
    # and JAX's own (read back from its forward)
    key = jax.random.PRNGKey(2)
    feeds = {"data": jnp.asarray(x), "label": jnp.asarray(labels)}

    def jloss(p):
        env, new_state, loss = jnet.apply(p, jstate, feeds, train=True,
                                          rng=key)
        return loss, (env, new_state)

    (jl, (jenv, jnew)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    keep = np.asarray(jenv["fc"]) != 0  # fc after in-place dropout
    net = Net(NetParameter.from_text(_remat_net(True)), "TRAIN",
              device="cpu")
    net.init(0)
    _, loss, grads, state = _port_grads(net, x, labels, keep, params,
                                        state0)
    report = []
    _close(float(loss), float(jl), F32_OUT, "loss", report)
    for lname, blobs in jg.items():
        for pname, g in blobs.items():
            _close(grads[f"{lname}.{pname}"].numpy(), np.asarray(g),
                   F32_GRAD, f"{lname}.{pname}", report)
    for n in ("mean", "var"):
        _close(state[f"bn1.{n}"].numpy(), np.asarray(jnew["bn1"][n]),
               F32_OUT, f"bn1.{n}", report)
    print(report)


def test_remat_only_in_train():
    """In TEST (and in eval mode) a remat layer runs plainly: no
    checkpoint, the same values."""
    net = Net(NetParameter.from_text(_remat_net(True)), "TEST",
              device="cpu")
    net.init(0)
    x = torch.from_numpy(np.random.RandomState(3).randn(
        4, 3, 12, 12).astype(np.float32))
    env, _ = net({"data": x, "label": torch.zeros(4, dtype=torch.int32)})
    assert env["fc"].grad_fn is None or not env["fc"].requires_grad


def test_a_recompute_does_not_wait_for_the_tf32_lock():
    """On the card autograd runs a remat layer's recompute on its device
    thread while the thread in backward holds the TF32 lock (the solver's
    math context); under `recomputing()` the TF32 switch must not wait
    for it, where any other thread does. (On the CPU the backward runs on
    the calling thread.)"""
    import threading

    from caffe_mpi_tpu_torch.core import types

    def switch(done, recompute):
        with types.recomputing() if recompute else contextlib.nullcontext(), \
                types._tf32(False):
            done.set()

    plain, recomputed = threading.Event(), threading.Event()
    with types._TF32_LOCK:
        waits = threading.Thread(target=switch, args=(plain, False),
                                 daemon=True)
        waits.start()
        t = threading.Thread(target=switch, args=(recomputed, True),
                             daemon=True)
        t.start()
        t.join(10)
        assert recomputed.is_set() and not plain.is_set()
    waits.join(10)
    assert plain.is_set()
