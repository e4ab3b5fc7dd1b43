"""Port parity: the layer types the example nets need (Sigmoid, Slice,
Tile, EuclideanLoss, L1Loss, ContrastiveLoss in its current and legacy
forms) against the JAX layers, forward and gradient (`jax.grad`), in f32
and under the FLOAT16 (bfloat16) policy.

Tolerances: f32 tops rtol 1e-5 / atol 1e-6 of the largest element and
gradients rtol 1e-5 / atol 1e-5 of the largest (the same f32 math,
reductions in other orders); bf16 at the ulps ROADMAP.md §3 states, two
bf16 ulps of the largest element for tops and four for gradients
(tests/test_torch_precision.py LAYER_FWD / LAYER_GRAD), loss tops in f32
at the f32 tolerance.
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
from test_torch_precision import (F32_OUT, JAX_BF16, LAYER_FWD, LAYER_GRAD,
                                  PORT_BF16, _close, _x)

F32_GRAD = dict(rtol=1e-5, atol=1e-5)

CASES = {
    "sigmoid": ('name: "s" type: "Sigmoid" bottom: "x" top: "y"',
                [(2, 3, 4, 5)], False),
    "slice_points": ('name: "s" type: "Slice" bottom: "x" top: "a" '
                     'top: "b" top: "c" slice_param { axis: 1 '
                     'slice_point: 1 slice_point: 3 }', [(2, 5, 3, 2)],
                     False),
    "slice_equal_legacy_dim": ('name: "s" type: "Slice" bottom: "x" '
                               'top: "a" top: "b" slice_param { '
                               'slice_dim: 2 }', [(2, 3, 6, 2)], False),
    "slice_negative_axis": ('name: "s" type: "Slice" bottom: "x" top: "a" '
                            'top: "b" slice_param { axis: -1 '
                            'slice_point: 3 }', [(2, 3, 5)], False),
    "tile": ('name: "t" type: "Tile" bottom: "x" top: "y" '
             'tile_param { axis: 1 tiles: 4 }', [(2, 1, 3, 4)], False),
    "tile_last_axis": ('name: "t" type: "Tile" bottom: "x" top: "y" '
                       'tile_param { axis: -1 tiles: 3 }', [(2, 3, 2)],
                       False),
    "euclidean_loss": ('name: "l" type: "EuclideanLoss" bottom: "a" '
                       'bottom: "b" top: "loss"',
                       [(4, 1, 3, 5), (4, 1, 3, 5)], True),
    "l1_loss": ('name: "l" type: "L1Loss" bottom: "a" bottom: "b" '
                'top: "loss"', [(4, 4, 3, 5), (4, 4, 3, 5)], True),
    "l1_loss_one_bottom": ('name: "l" type: "L1Loss" bottom: "a" '
                           'top: "loss"', [(3, 7)], True),
    "contrastive": ('name: "l" type: "ContrastiveLoss" bottom: "a" '
                    'bottom: "b" bottom: "sim" top: "loss" '
                    'contrastive_loss_param { margin: 1.5 }',
                    [(6, 4), (6, 4), "label"], True),
    "contrastive_legacy": ('name: "l" type: "ContrastiveLoss" bottom: "a" '
                           'bottom: "b" bottom: "sim" top: "loss" '
                           'contrastive_loss_param { margin: 2 '
                           'legacy_version: true }',
                           [(6, 4), (6, 4), "label"], True),
}


def _bottoms(shapes, scale=1.0):
    out = []
    for i, s in enumerate(shapes):
        if s == "label":  # similar (1) / dissimilar (0) pairs
            out.append(np.array([1, 0, 1, 0, 0, 1], np.int32))
        else:
            out.append(_x(*s, seed=i + 1, scale=scale))
    return out


def _both(text, bottoms, jpolicy, ppolicy, fwd, grad, f32_tops):
    """Run one layer in both packages: tops held, and the gradients of a
    weighted sum of the tops by every float bottom."""
    shapes = [tuple(b.shape) for b in bottoms]
    jl = jax_create_layer(JaxLP.from_text(text), jpolicy, "TRAIN")
    jl.in_shapes = shapes
    jl.out_shapes = jl.setup(shapes)
    tl = create_layer(LayerParameter.from_text(text), ppolicy, "TRAIN",
                      torch.device("cpu"))
    tl.in_shapes = shapes
    tl.out_shapes = tl.setup(shapes)
    assert [tuple(s) for s in tl.out_shapes] == \
        [tuple(s) for s in jl.out_shapes]
    weights = [_x(*s, seed=7 + i) for i, s in enumerate(jl.out_shapes)]
    floats = [i for i, b in enumerate(bottoms) if b.dtype == np.float32]

    def jloss(fb):
        bs = [jnp.asarray(b) for b in bottoms]
        for i, b in zip(floats, fb):
            bs[i] = b
        tops, _ = jl.apply({}, {}, bs, train=True, rng=None)
        return sum(jnp.sum(t.astype(jnp.float32) * w)
                   for t, w in zip(tops, weights)), tops

    (_, jtops), jgb = jax.value_and_grad(jloss, has_aux=True)(
        [jnp.asarray(bottoms[i]) for i in floats])
    tb = [torch.from_numpy(b.copy()) for b in bottoms]
    for i in floats:
        tb[i].requires_grad_(True)
    tops = tl(tb)
    report = []
    for k, (got, want) in enumerate(zip(tops, jtops)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        _close(got.detach().float().numpy(),
               np.asarray(want.astype(jnp.float32)),
               F32_OUT if f32_tops else fwd, f"top {k}", report)
    sum((t.float() * torch.from_numpy(w)).sum()
        for t, w in zip(tops, weights)).backward()
    for i, g in zip(floats, jgb):
        _close(tb[i].grad.float().numpy(), np.asarray(g, np.float32), grad,
               f"grad bottom {i}", report)
    return tops, report


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_f32_forward_and_gradients_match_jax(case):
    text, shapes, loss = CASES[case]
    tops, report = _both(text, _bottoms(shapes), JaxPolicy(), DtypePolicy(),
                         F32_OUT, F32_GRAD, loss)
    print(case, report)
    assert all(t.dtype == torch.float32 for t in tops)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_bf16_forward_and_gradients_match_jax(case):
    text, shapes, loss = CASES[case]
    tops, report = _both(text, _bottoms(shapes), JAX_BF16, PORT_BF16,
                         LAYER_FWD, LAYER_GRAD, loss)
    print(case, report)
    # loss tops stay f32; the others take the JAX layer's type (held in
    # _both): bf16, or the bottom's own for Tile, which casts nothing
    assert not loss or tops[0].dtype == torch.float32


def test_contrastive_margin_and_similar_pairs_by_hand():
    """d^2 for a similar pair; max(margin - d, 0)^2 (current) or
    max(margin - d^2, 0) (legacy) for a dissimilar one; over 2N."""
    a = torch.tensor([[0.0, 0.0], [0.0, 0.0]])
    b = torch.tensor([[0.6, 0.8], [0.3, 0.4]])  # d = 1, 0.5
    y = torch.tensor([1, 0])
    for legacy, want in ((False, (1.0 + (2 - 0.5) ** 2) / 4),
                         (True, (1.0 + (2 - 0.25)) / 4)):
        text = ('name: "l" type: "ContrastiveLoss" bottom: "a" bottom: "b" '
                'bottom: "y" top: "loss" contrastive_loss_param { margin: 2 '
                f'legacy_version: {str(legacy).lower()} }}')
        tl = create_layer(LayerParameter.from_text(text), DtypePolicy(),
                          "TRAIN", torch.device("cpu"))
        tl.setup([(2, 2), (2, 2), (2,)])
        (loss,) = tl([a, b, y])
        assert float(loss) == pytest.approx(want, rel=1e-6)
