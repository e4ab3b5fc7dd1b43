"""Port parity: bf16 mixed precision against the JAX package, on the CPU.

Layers: every layer type the bf16 training paths run (AlexNet, CaffeNet,
GoogLeNet, ResNet-50 from their fp16 prototxts, transformer_lm under
`precision: "bf16"`) is built in both packages under a FLOAT16 policy
(bfloat16 forward and backward, float32 params), fed the same numpy
params and bottoms, and held forward and backward: the gradient is that
of sum_i <top_i, w_i> (in float32) with respect to the params and the
float bottoms, through jax.grad and torch autograd. The parts the JAX
layers keep in float32 are kept so: the loss (SoftmaxWithLoss), the
BatchNorm statistics, LayerNorm's normalization; BatchNorm's batch
statistics under bf16 take the shipped "fused" design (F.batch_norm on
the bf16 input, f32 statistics for the update), both designs held.

Solver: the torch-amp master-update oracle of the JAX suite
(tests/test_precision.py:128), updates below bf16 resolution landing in
the float32 master (a property: the JAX case at :157 is a known-red
reference caveat), static and dynamic loss scaling with skips, overflow
counts and scale values equal to the JAX Solver's on feeds with injected
non-finite steps, the scale floor raising NumericAnomalyError, a finite
spike skipping without touching the scale, the knobs' validation, and 5
iterations of a narrow fp16 AlexNet (LRN, Dropout) and a narrow ResNet
(BatchNorm, Scale, Eltwise) against the JAX Solver under bf16.

Tolerances (a bf16 ulp is 2^-8 to 2^-7 of a value):
- LAYER_FWD: rtol 2^-7 + atol 2^-6 of the largest element: both sides
  round one float32 result to bf16 (one ulp), except that XLA's CPU
  reductions of bf16 (AVE pooling's window sum) accumulate in bf16,
  where torch accumulates in float32 and rounds once (measured 1.2e-2 of
  the largest element on AVE pooling, 5.6e-3 on a convolution);
- LAYER_GRAD: rtol 2^-6 + atol 2^-5 of the largest element: a gradient
  passes two or three bf16 roundings (the cotangent, the product, the
  cast back to float32), and a bias gradient is a reduction over every
  position, which XLA's CPU build accumulates in bf16 (measured 1.7e-2
  of the largest element on a grouped convolution's bias, where the
  port's is within one ulp of the float64 sum:
  test_port_bias_gradient_is_the_sum_rounded_once);
- the loss layers' float32 outputs: rtol 1e-5 (they compute in float32 on
  the same bf16 logits);
- whole nets, at most 6 updates: losses rtol 2e-2, params atol 6e-2 of
  the param's largest element. bf16 roundings compound through the
  layers and the updates, and JAX's bias gradients carry its bf16
  reductions: on the 4-layer net below, after 6 updates the port is
  within 3.6e-2 of JAX on conv.bias (a param that starts at 0, so all of
  it is update) and within 3e-3 on the weights, while either bf16 run is
  up to 3.9e-2 from a float32 run of the same steps (measured on the
  CPU). The narrow AlexNet and ResNet (5 iterations) hold each param
  and statistic within BAND = 2 times the JAX bf16 run's own distance
  from the JAX float32 run of the same steps: there the port's bf16 run
  is mostly nearer the float32 one than JAX's is (JAX's bf16
  reductions; e.g. br1.weight 4.7e-5 against JAX's 1.3e-3 of the
  largest), and the two bf16 runs differ by at most 1.2 times JAX's
  distance (the narrow ResNet, measured on the CPU);
- scale telemetry (skips, overflows, scale): equal.
No float32 tolerance of the port's suite is loosened: every float32 case
stays in its own file at its own tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.core.types import DtypePolicy as JaxPolicy
from caffe_mpi_tpu.layers import create_layer as jax_create_layer
from caffe_mpi_tpu.proto import LayerParameter as JaxLP
from caffe_mpi_tpu.proto import NetParameter as JaxNP
from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu.utils import resilience as jax_resilience
from caffe_mpi_tpu_torch.core.types import DtypePolicy
from caffe_mpi_tpu_torch.layers import create_layer
from caffe_mpi_tpu_torch.proto import LayerParameter, NetParameter
from caffe_mpi_tpu_torch.proto import SolverParameter
from caffe_mpi_tpu_torch.solver import Solver
from caffe_mpi_tpu_torch.utils.resilience import (EXIT_NUMERIC,
                                                  NumericAnomalyError)
from caffe_mpi_tpu_torch.weights import load_jax_params

ULP = 2.0 ** -7
LAYER_FWD = dict(rtol=ULP, atol=2 * ULP)      # atol: of the largest
LAYER_GRAD = dict(rtol=2 * ULP, atol=4 * ULP)  # element
F32_OUT = dict(rtol=1e-5, atol=1e-6)

JAX_BF16 = JaxPolicy(forward=jnp.bfloat16, backward=jnp.bfloat16)
PORT_BF16 = DtypePolicy(forward=torch.bfloat16, backward=torch.bfloat16)


def _x(*shape, seed=1, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _close(got, want, tol, name, report):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    big = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / big
    report.append((name, err))
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * big, err_msg=name)


def _bf16_both(text, bottoms, *, phase="TRAIN", seed=0, param_scale=0.5,
               state=None, masks=None, fwd=LAYER_FWD, grad=LAYER_GRAD,
               f32_tops=False):
    """One layer in both packages under the FLOAT16 policy: tops (as
    float32), new state and gradients held; returns (port layer, port
    tops, [(name, max error / largest element)])."""
    shapes = [tuple(b.shape) for b in bottoms]
    jl = jax_create_layer(JaxLP.from_text(text), JAX_BF16, phase)
    jl.in_shapes = shapes
    jl.out_shapes = jl.setup(shapes)
    tl = create_layer(LayerParameter.from_text(text), PORT_BF16, phase,
                      torch.device("cpu"))
    tl.in_shapes = shapes
    tl.out_shapes = tl.setup(shapes)
    tl.train(phase == "TRAIN")
    rs = np.random.RandomState(seed)
    params = {n: (rs.randn(*d.shape) * param_scale).astype(np.float32)
              for n, d in jl.params.items()}
    weights = [_x(*s, seed=seed + 7 + i) for i, s in
               enumerate(jl.out_shapes)]
    floats = [i for i, b in enumerate(bottoms) if b.dtype == np.float32]
    state = state or {}
    train = phase == "TRAIN"

    def jloss(p, fb):
        bs = [jnp.asarray(b) for b in bottoms]
        for i, b in zip(floats, fb):
            bs[i] = b
        tops, new = jl.apply(p, state, bs, train=train,
                             rng=jax.random.PRNGKey(0))
        return sum(jnp.sum(t.astype(jnp.float32) * w)
                   for t, w in zip(tops, weights)), (tops, new)

    jp = {n: jnp.asarray(a) for n, a in params.items()}
    (_, (jtops, jnew)), (jgp, jgb) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jp, [jnp.asarray(bottoms[i]) for i in floats])
    with torch.no_grad():
        for n, a in params.items():
            getattr(tl, n).copy_(torch.from_numpy(a))
        for n, a in state.items():
            getattr(tl, n).copy_(torch.from_numpy(np.array(a)))
    for n in params:
        getattr(tl, n).requires_grad_(True)
    tb = [torch.from_numpy(b.copy()) for b in bottoms]
    for i in floats:
        tb[i].requires_grad_(True)
    tops = tl(tb, mask=masks) if masks is not None else tl(tb)
    report = []
    for k, (got, want) in enumerate(zip(tops, jtops)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype), \
            (k, got.dtype, want.dtype)
        tol = F32_OUT if f32_tops else fwd
        _close(got.detach().float().numpy(),
               np.asarray(want.astype(jnp.float32)), tol, f"top {k}",
               report)
    for n in state:
        _close(getattr(tl, n).numpy(), np.asarray(jnew[n]), F32_OUT,
               f"state {n}", report)
    sum((t.float() * torch.from_numpy(w)).sum()
        for t, w in zip(tops, weights)).backward()
    for n in params:
        assert getattr(tl, n).grad.dtype == torch.float32
        _close(getattr(tl, n).grad.numpy(), jgp[n], grad, f"grad {n}",
               report)
    for i, g in zip(floats, jgb):
        _close(tb[i].grad.numpy(), g, grad, f"grad bottom {i}", report)
    return tl, tops, report


CASES = {
    "conv": ('name: "c" type: "Convolution" bottom: "x" top: "y" '
             'convolution_param { num_output: 6 kernel_size: 3 pad: 1 }',
             [(2, 4, 7, 7)]),
    "conv_strided_group": (
        'name: "c" type: "Convolution" bottom: "x" top: "y" '
        'convolution_param { num_output: 4 kernel_size: 3 stride: 2 '
        'group: 2 }', [(2, 4, 9, 9)]),
    "pool_max": ('name: "p" type: "Pooling" bottom: "x" top: "y" '
                 'pooling_param { pool: MAX kernel_size: 3 stride: 2 }',
                 [(2, 3, 9, 9)]),
    "pool_ave": ('name: "p" type: "Pooling" bottom: "x" top: "y" '
                 'pooling_param { pool: AVE kernel_size: 3 stride: 2 '
                 'pad: 1 }', [(2, 3, 8, 8)]),
    "lrn": ('name: "n" type: "LRN" bottom: "x" top: "y" '
            'lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 }',
            [(2, 8, 5, 5)]),
    "inner_product": ('name: "ip" type: "InnerProduct" bottom: "x" '
                      'top: "y" inner_product_param { num_output: 5 }',
                      [(3, 2, 3, 2)]),
    "relu": ('name: "r" type: "ReLU" bottom: "x" top: "y"', [(2, 3, 4)]),
    "relu_leaky": ('name: "r" type: "ReLU" bottom: "x" top: "y" '
                   'relu_param { negative_slope: 0.1 }', [(2, 3, 4)]),
    "scale": ('name: "s" type: "Scale" bottom: "x" top: "y" '
              'scale_param { bias_term: true }', [(2, 3, 4, 4)]),
    "eltwise_sum": ('name: "e" type: "Eltwise" bottom: "a" bottom: "b" '
                    'top: "y" eltwise_param { coeff: 0.5 coeff: -2 }',
                    [(2, 3, 4), (2, 3, 4)]),
    "eltwise_prod": ('name: "e" type: "Eltwise" bottom: "a" bottom: "b" '
                     'top: "y" eltwise_param { operation: PROD }',
                     [(2, 3, 4), (2, 3, 4)]),
    "concat": ('name: "cc" type: "Concat" bottom: "a" bottom: "b" '
               'top: "y"', [(2, 3, 4, 4), (2, 5, 4, 4)]),
    "layer_norm": ('name: "ln" type: "LayerNorm" bottom: "x" top: "y"',
                   [(2, 5, 12)]),
    "attention": ('name: "a" type: "Attention" bottom: "x" top: "y" '
                  'attention_param { num_heads: 2 causal: true }',
                  [(2, 8, 16)]),
    "attention_flash": ('name: "a" type: "Attention" bottom: "x" '
                        'top: "y" attention_param { num_heads: 2 '
                        'causal: true use_flash: true }', [(2, 8, 16)]),
    "moe": ('name: "m" type: "MoE" bottom: "x" top: "y" top: "aux" '
            'loss_weight: 0 loss_weight: 0.01 '
            'moe_param { num_experts: 4 hidden_dim: 8 }', [(2, 8, 6)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_bf16_forward_and_gradients_match_jax(case):
    text, shapes = CASES[case]
    bottoms = [_x(*s, seed=i + 1) for i, s in enumerate(shapes)]
    tl, tops, report = _bf16_both(text, bottoms)
    print(case, report)
    assert tops[0].dtype == torch.bfloat16


def test_dropout_bf16_with_the_jax_mask_matches_jax():
    text = ('name: "d" type: "Dropout" bottom: "x" top: "y" '
            'dropout_param { dropout_ratio: 0.3 }')
    shape = (4, 6, 5)
    mask = torch.from_numpy(np.array(jax.random.bernoulli(
        jax.random.PRNGKey(0), 0.7, shape)))
    _, tops, _ = _bf16_both(text, [_x(*shape)], masks=mask)
    assert tops[0].dtype == torch.bfloat16


@pytest.mark.parametrize("extra", ["", "loss_param { ignore_label: 2 }",
                                   "loss_param { normalization: FULL }"])
def test_softmax_with_loss_bf16_logits_keep_the_loss_in_f32(extra):
    text = ('name: "loss" type: "SoftmaxWithLoss" bottom: "x" '
            f'bottom: "label" top: "loss" {extra}')
    labels = np.random.RandomState(3).randint(0, 5, (6,)).astype(np.int32)
    _, tops, _ = _bf16_both(text, [_x(6, 5, scale=3.0), labels],
                            f32_tops=True)
    assert tops[0].dtype == torch.float32


def test_accuracy_bf16_matches_jax():
    text = ('name: "acc" type: "Accuracy" bottom: "x" bottom: "label" '
            'top: "acc" accuracy_param { top_k: 2 }')
    x, labels = _x(8, 5), np.random.RandomState(4).randint(0, 5, (8,))
    jl = jax_create_layer(JaxLP.from_text(text), JAX_BF16, "TEST")
    jl.out_shapes = jl.setup([(8, 5), (8,)])
    tl = create_layer(LayerParameter.from_text(text), PORT_BF16, "TEST",
                      torch.device("cpu"))
    tl.setup([(8, 5), (8,)])
    (jacc,), _ = jl.apply({}, {}, [jnp.asarray(x), jnp.asarray(labels)],
                          train=False, rng=None)
    (acc,) = tl([torch.from_numpy(x), torch.from_numpy(labels)])
    assert acc.dtype == torch.float32
    np.testing.assert_allclose(float(acc), float(jacc), **F32_OUT)


@pytest.mark.parametrize("bias", ["false", "true"])
def test_embed_bf16_matches_jax(bias):
    text = ('name: "embed" type: "Embed" bottom: "tok" top: "y" '
            f'embed_param {{ input_dim: 11 num_output: 5 '
            f'bias_term: {bias} }}')
    tok = np.random.RandomState(5).randint(0, 11, (3, 7))
    _, tops, _ = _bf16_both(text, [tok])
    assert tops[0].dtype == torch.bfloat16


BN = 'name: "bn" type: "BatchNorm" bottom: "x" top: "y" '


@pytest.mark.parametrize("design", ["fused", "composite"])
@pytest.mark.parametrize("phase,extra", [
    ("TRAIN", "batch_norm_param { scale_bias: true }"),
    ("TRAIN", ""),
    ("TEST", "batch_norm_param { scale_bias: true }"),
    ("TRAIN", "batch_norm_param { use_global_stats: true }"),
])
def test_batch_norm_bf16_keeps_f32_statistics_and_matches_jax(
        phase, extra, design, monkeypatch):
    """Under bf16 the batch statistics and the running update are float32
    in both designs; the shipped one, "fused", normalizes a bf16 input
    with F.batch_norm (one rounding, where the JAX layer rounds the
    statistics to bf16 first), "composite" with the JAX arithmetic."""
    from caffe_mpi_tpu_torch.layers import norm as port_norm
    monkeypatch.setattr(port_norm, "BATCH_STATS", design)
    calls = []
    orig = port_norm.F.batch_norm

    def counted(*a, **k):
        calls.append(a[0].dtype)
        return orig(*a, **k)
    monkeypatch.setattr(port_norm.F, "batch_norm", counted)
    rs = np.random.RandomState(6)
    state = {"mean": rs.randn(3).astype(np.float32),
             "var": (np.abs(rs.randn(3)) + 0.5).astype(np.float32)}
    tl, tops, _ = _bf16_both(BN + extra, [_x(4, 3, 5, 5, scale=2.0) + 1],
                             phase=phase, state=state)
    assert tops[0].dtype == torch.bfloat16
    assert tl.mean.dtype == tl.var.dtype == torch.float32
    batch_stats = phase == "TRAIN" and "use_global_stats" not in extra
    assert calls == ([torch.bfloat16] if batch_stats and design == "fused"
                     else [])


def test_port_bias_gradient_is_the_sum_rounded_once():
    """A bias gradient is a sum over every position: the port's is the
    float64 sum of the bf16 cotangent rounded once to bf16 (within one
    ulp), where XLA's CPU build accumulates it in bf16."""
    text, shapes = CASES["conv_strided_group"]
    tl = create_layer(LayerParameter.from_text(text), PORT_BF16, "TRAIN",
                      torch.device("cpu"))
    tl.out_shapes = tl.setup(shapes)
    tl.init_params(torch.Generator().manual_seed(0))
    tl.bias.requires_grad_(True)
    (y,) = tl([torch.from_numpy(_x(*shapes[0]))])
    w = torch.from_numpy(_x(*tl.out_shapes[0], seed=7))
    (y.float() * w).sum().backward()
    exact = w.to(torch.bfloat16).double().sum((0, 2, 3))
    err = (tl.bias.grad.double() - exact).abs()
    assert bool((err <= exact.abs() * 2.0 ** -8 + 1e-12).all()), err


# -- the solver ---------------------------------------------------------------

# the JAX suite's net (tests/test_precision.py NET)
NET = """
name: "prec_net"
layer { name: "in" type: "Input" top: "data" top: "label"
        input_param { shape { dim: 16 dim: 1 dim: 8 dim: 8 }
                      shape { dim: 16 } } }
layer { name: "conv" type: "Convolution" bottom: "data" top: "c"
        convolution_param { num_output: 4 kernel_size: 3
          weight_filler { type: "msra" } } }
layer { name: "r" type: "ReLU" bottom: "c" top: "c" }
layer { name: "ip" type: "InnerProduct" bottom: "c" top: "logits"
        inner_product_param { num_output: 4
          weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits"
        bottom: "label" top: "loss" }
"""
# whole-net bf16 parity (module docstring)
NET_LOSS = dict(rtol=2e-2)
BAND = 2.0  # whole nets: x the JAX bf16 run's distance from its f32 run
NET_STEP = dict(rtol=0.0, atol=6e-2)  # atol: of the param's largest


def _pair(extra="", net=NET, prefix="/tmp/caffe_torch_precision/snap"):
    """The JAX Solver and the port's from one solver text and net, the
    port loaded with the JAX params."""
    text = ('base_lr: 0.05 momentum: 0.9 lr_policy: "fixed" max_iter: 100 '
            f'random_seed: 3 snapshot_prefix: "{prefix}" ' + extra)
    jsp = JaxSP.from_text(text)
    jsp.net_param = JaxNP.from_text(net)
    psp = SolverParameter.from_text(text)
    psp.net_param = NetParameter.from_text(net)
    js = JaxSolver(jsp)
    ps = Solver(psp, device="cpu")
    load_jax_params(ps.net, jax.tree_util.tree_map(np.asarray, js.params),
                    jax.tree_util.tree_map(np.asarray, js.net_state))
    return js, ps


def _batches(seed=0, n=24):
    r = np.random.RandomState(seed)
    return [{"data": r.randn(16, 1, 8, 8).astype(np.float32),
             "label": r.randint(0, 4, 16).astype(np.int32)}
            for _ in range(n)]


def _feeds(batches, bad=(), value=np.nan):
    """(JAX feed fn, port feed fn) over `batches`, the iterations in
    `bad` fed a batch of `value`."""
    poison = {"data": np.full((16, 1, 8, 8), value, np.float32),
              "label": np.zeros(16, np.int32)}

    def pick(it):
        return poison if it in bad else batches[it % len(batches)]
    return (lambda it: {k: jnp.asarray(v) for k, v in pick(it).items()},
            lambda it: {k: torch.from_numpy(v) for k, v in pick(it).items()})


def _telemetry(s):
    return (s.skipped_steps, s.overflow_steps, s.loss_scale_value)


def _assert_params_close(js, ps, tol=NET_STEP):
    for lname, blobs in js.params.items():
        for pname, arr in blobs.items():
            want = np.asarray(arr, np.float32)
            got = getattr(ps.net.layer_by_name(lname), pname).detach()
            assert got.dtype == torch.float32
            np.testing.assert_allclose(
                got.numpy(), want, rtol=tol["rtol"],
                atol=tol["atol"] * float(np.abs(want).max()),
                err_msg=f"{lname}.{pname}")


IP_NET = """
name: "ip"
layer { name: "in" type: "Input" top: "x" top: "label"
        input_param { shape { dim: 8 dim: 16 } shape { dim: 8 } } }
layer { name: "fc" type: "InnerProduct" bottom: "x" top: "y"
        inner_product_param { num_output: 4 bias_term: false
          weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "y" bottom: "label"
        top: "l" }
"""


def test_master_update_matches_the_torch_amp_oracle():
    """The JAX suite's torch-amp oracle (tests/test_precision.py:128) on a
    softmax loss: bf16 forward off the f32 master, the loss in f32, the
    static scale applied and unwound in f32, SGD on the f32 master."""
    r = np.random.RandomState(0)
    x = r.randn(8, 16).astype(np.float32)
    lab = r.randint(0, 4, 8).astype(np.int32)
    js, ps = _pair('precision: "bf16" loss_scale: 1024', net=IP_NET)
    w0 = ps.net.layer_by_name("fc").weight.detach().clone()
    assert w0.dtype == torch.float32
    js.step(1, lambda it: {"x": jnp.asarray(x), "label": jnp.asarray(lab)})
    ps.step(1, lambda it: {"x": torch.from_numpy(x),
                           "label": torch.from_numpy(lab)})
    w1 = ps.net.layer_by_name("fc").weight.detach()
    assert w1.dtype == torch.float32
    wt = w0.clone().requires_grad_(True)
    y = torch.from_numpy(x).bfloat16() @ wt.bfloat16().t()
    loss = torch.nn.functional.cross_entropy(y.float(),
                                             torch.from_numpy(lab).long())
    (loss * 1024.0).backward()
    w_ref = w0 - 0.05 * (wt.grad.float() / 1024.0)
    np.testing.assert_allclose(w1.numpy(), w_ref.numpy(), rtol=1e-6,
                               atol=1e-7)
    # the JAX Solver against the same oracle, at its own suite's limits
    np.testing.assert_allclose(np.asarray(js.params["fc"]["weight"]),
                               w_ref.numpy(), rtol=2e-2, atol=2e-4)
    assert float((w1 - w0).abs().max()) > 0


def test_updates_below_bf16_resolution_land_in_the_f32_master():
    """An update smaller than a bf16 ulp of the weight moves the float32
    master (a bf16 copy would round it away). Asserted as a property: the
    JAX case (tests/test_precision.py:157) is a known-red reference
    caveat, not an oracle."""
    _, ps = _pair('precision: "bf16" loss_scale: 1 base_lr: 1e-6',
                  net=IP_NET)
    r = np.random.RandomState(1)
    feed = {"x": torch.from_numpy(r.randn(8, 16).astype(np.float32)),
            "label": torch.from_numpy(r.randint(0, 4, 8).astype(np.int32))}
    w = ps.net.layer_by_name("fc").weight
    w0 = w.detach().clone()
    ps.step(1, lambda it: feed)
    w1 = w.detach()
    assert w1.dtype == torch.float32
    moved = w1 != w0
    assert int(moved.sum()) > w0.numel() // 2
    # most of those updates are below a bf16 ulp of their weight:
    # rounded to bf16 storage, before and after are the same number
    lost = (w1.bfloat16() == w0.bfloat16()) & moved
    assert int(lost.sum()) > int(moved.sum()) // 2


def test_activations_bf16_loss_and_slots_f32():
    _, ps = _pair('precision: "bf16" loss_scale: 2')
    feeds = _feeds(_batches())[1](0)
    blobs, loss = ps.net(feeds, generator=ps.generator)
    assert blobs["c"].dtype == blobs["logits"].dtype == torch.bfloat16
    assert loss.dtype == torch.float32
    assert all(s.dtype == torch.float32 for slots in ps.history.values()
               for s in slots)
    assert all(p.dtype == torch.float32 for *_, p in ps._decls)


@pytest.mark.parametrize("extra", ['precision: "bf16" loss_scale: 1024',
                                   'precision: "bf16" loss_scale: 1024 '
                                   'step_chunk: 4'])
def test_static_scale_trains_like_jax(extra):
    js, ps = _pair(extra)
    jfeed, pfeed = _feeds(_batches())
    jlosses = [js.step(1, jfeed) for _ in range(6)]
    ps.step(6, pfeed)
    np.testing.assert_allclose(ps.losses, jlosses, **NET_LOSS)
    _assert_params_close(js, ps)
    assert ps.loss_scale_value == js.loss_scale_value == 1024.0
    assert not ps._guard_on and ps.skipped_steps == 0


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("value", [np.nan, np.inf])
def test_dynamic_scale_skips_and_rescales_like_jax(value, chunk):
    """A burst of non-finite steps longer than guard_max_skips: skipped,
    counted as overflows and halving the scale each, with no exit (the
    scale is above its floor); then clean steps regrow it every
    loss_scale_window. Skips, overflows and the scale equal the JAX
    Solver's after each call, and the params follow it."""
    extra = ('precision: "bf16" guard_max_skips: 2 loss_scale_window: 4 '
             f'step_chunk: {chunk}')
    js, ps = _pair(extra)
    jfeed, pfeed = _feeds(_batches(5), bad={3, 4, 5}, value=value)
    js.step(9, jfeed)
    ps.step(9, pfeed)
    assert _telemetry(ps) == _telemetry(js) == (3, 3, 2.0 ** 15 / 8)
    assert ps.skipped_iters == [3, 4, 5]
    _assert_params_close(js, ps)  # 6 updates
    jfeed, pfeed = _feeds(_batches(5))
    js.step(11, jfeed)
    ps.step(11, pfeed)
    assert _telemetry(ps) == _telemetry(js) == (3, 3, 2.0 ** 15)


def test_a_skipped_step_keeps_params_slots_and_advances():
    _, ps = _pair('precision: "bf16" guard_max_skips: 0')
    _, pfeed = _feeds(_batches(5), bad={2})
    ps.step(2, pfeed)
    before = {k: v.detach().clone() for k, v in ps.net.state_dict().items()}
    slots = {k: [s.clone() for s in v] for k, v in ps.history.items()}
    ps.step(1, pfeed)
    assert ps.iter == 3 and ps.skipped_iters == [2]
    for k, v in ps.net.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in ps.history.items():
        assert all(torch.equal(a, b) for a, b in zip(v, slots[k])), k


def test_scale_floor_raises_numeric_anomaly_like_jax():
    """Every step non-finite: the scale halves to its floor, then
    guard_max_skips consecutive skips at the floor declare divergence in
    both packages."""
    extra = 'precision: "bf16" guard_max_skips: 2 step_chunk: 5'
    js, ps = _pair(extra)
    jfeed, pfeed = _feeds(_batches(), bad=set(range(100)))
    with pytest.raises(jax_resilience.NumericAnomalyError):
        js.step(30, jfeed)
    with pytest.raises(NumericAnomalyError) as err:
        ps.step(30, pfeed)
    assert ps.loss_scale_value == 1.0 == js.loss_scale_value
    assert err.value.consec >= 2
    # 15 halvings from 2^15 to the floor, then 2 skips at it
    assert ps.iter == 20 and ps.overflow_steps == 20


def test_finite_spike_skips_without_touching_the_scale_like_jax():
    extra = 'precision: "bf16" guard_loss_spike: 3.0 guard_max_skips: 2'
    js, ps = _pair(extra)
    batches = _batches(5)
    jfeed, pfeed = _feeds(batches)
    js.step(6, jfeed)
    ps.step(6, pfeed)
    assert _telemetry(ps) == _telemetry(js) == (0, 0, 2.0 ** 15)
    spike = {"data": batches[0]["data"] * 60.0,
             "label": (batches[0]["label"] + 2) % 4}
    js.step(1, lambda it: {k: jnp.asarray(v) for k, v in spike.items()})
    ps.step(1, lambda it: {k: torch.from_numpy(v) for k, v in
                           spike.items()})
    assert _telemetry(ps) == _telemetry(js) == (1, 0, 2.0 ** 15)
    with pytest.raises(jax_resilience.NumericAnomalyError):
        js.step(2, lambda it: {k: jnp.asarray(v) for k, v in spike.items()})
    with pytest.raises(NumericAnomalyError):
        ps.step(2, lambda it: {k: torch.from_numpy(v) for k, v in
                               spike.items()})


@pytest.mark.parametrize("text,match", [
    ('precision: "fp8"', "precision"),
    ('precision: "bf16" loss_scale: -1', "loss_scale"),
    ('precision: "bf16" loss_scale_window: 0', "loss_scale_window"),
    ('solver_data_type: "INT"', "solver_data_type"),
])
def test_knob_validation_raises_as_jax_does(text, match):
    with pytest.raises(ValueError, match=match):
        _pair(text)
    jsp = JaxSP.from_text("base_lr: 0.1 " + text)
    jsp.net_param = JaxNP.from_text(NET)
    with pytest.raises(ValueError, match=match):
        JaxSolver(jsp)


def test_f32_guard_burst_raises_and_accepted_steps_are_bitwise():
    """f32 with train_guard: the same burst declares divergence (no scale
    to back off), and on clean data the guarded run equals the unguarded
    one bitwise."""
    _, ps = _pair("train_guard: true guard_max_skips: 2")
    _, pfeed = _feeds(_batches(), bad={3, 4, 5})
    with pytest.raises(NumericAnomalyError):
        ps.step(9, pfeed)
    _, a = _pair("train_guard: true")
    _, b = _pair("")
    _, pfeed = _feeds(_batches())
    a.step(5, pfeed)
    b.step(5, pfeed)
    assert a.losses == b.losses
    for (_, _, _, pa), (_, _, _, pb) in zip(a._decls, b._decls):
        assert torch.equal(pa, pb)


def test_bf16_storage_keeps_params_in_bf16_and_slots_in_f32():
    """solver_data_type: FLOAT16: bf16 params, f32 slots, the update in
    f32 cast back to bf16, as the JAX Solver's."""
    js, ps = _pair('precision: "bf16" solver_data_type: "FLOAT16" '
                   'loss_scale: 256')
    assert all(p.dtype == torch.bfloat16 for *_, p in ps._decls)
    jfeed, pfeed = _feeds(_batches())
    for _ in range(3):
        js.step(1, jfeed)
    ps.step(3, pfeed)
    assert all(s.dtype == torch.float32 for v in ps.history.values()
               for s in v)
    for lname, blobs in js.params.items():
        for pname, arr in blobs.items():
            assert arr.dtype == jnp.bfloat16
            got = getattr(ps.net.layer_by_name(lname), pname).detach()
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(arr, np.float32),
                rtol=NET_STEP["rtol"],
                atol=NET_STEP["atol"] * float(np.abs(
                    np.asarray(arr, np.float32)).max()))


def _write_solver(tmp_path, extra):
    # ten classes: the synthetic feed draws labels in [0, 10)
    net = NET.replace("inner_product_param { num_output: 4",
                      "inner_product_param { num_output: 10")
    path = tmp_path / "solver.prototxt"
    path.write_text("net_param { " + net[net.index("layer"):] + " }\n"
                    "base_lr: 0.05 max_iter: 4 random_seed: 3 " + extra)
    return str(path)


def test_cli_trains_in_bf16_and_reports_the_scale(tmp_path, capsys):
    from caffe_mpi_tpu_torch.tools import cli
    rc = cli.main(["train", "-solver", _write_solver(tmp_path, ""),
                   "-synthetic", "-device", "cpu", "-precision", "bf16",
                   "-loss_scale_window", "2", "-step_chunk", "2"])
    assert rc == 0
    import json
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1]
                         )["train"]
    assert summary["precision"] == "bf16" and summary["step_chunk"] == 2
    # grown after iterations 1 and 3: every 2 clean steps
    assert summary["loss_scale"] == 2.0 ** 17
    assert summary["dispatch_count"] == summary["host_sync_count"] == 2


def test_cli_exits_88_on_a_divergence(tmp_path):
    """An LR that sends every update past float32's range: each step is
    skipped, and guard_max_skips consecutive skips exit EXIT_NUMERIC."""
    from caffe_mpi_tpu_torch.tools import cli
    assert EXIT_NUMERIC == jax_resilience.EXIT_NUMERIC == 88
    rc = cli.main(["train", "-solver", _write_solver(
        tmp_path, "base_lr: 1e38 momentum: 0.9"), "-synthetic", "-device",
        "cpu", "-train_guard", "-guard_max_skips", "2"])
    assert rc == EXIT_NUMERIC


# -- whole nets ---------------------------------------------------------------

def _within_the_jax_band(jtree, jref, net):
    """Each param (or statistic) of the port's bf16 run against the JAX
    Solver's bf16 run, within twice the JAX bf16 run's own distance from
    the JAX float32 run of the same steps (its largest element), plus
    1e-6 of the param's largest element."""
    for lname, blobs in jtree.items():
        for pname, arr in blobs.items():
            want = np.asarray(arr, np.float32)
            band = float(np.abs(want - np.asarray(
                jref[lname][pname], np.float32)).max())
            got = getattr(net.layer_by_name(lname), pname).detach().float()
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=BAND * band + 1e-6 * float(np.abs(want).max()),
                err_msg=f"{lname}.{pname}")


@pytest.mark.parametrize("spelling", ["precision", "fp16_prototxt"])
def test_five_iterations_of_a_narrow_alexnet_in_bf16_match_jax(spelling):
    """The narrow AlexNet of tests/test_torch_train.py (two LRNs, Dropout)
    in bf16, spelled as `precision: "bf16"` (dynamic loss scale, the
    guard armed) or as an fp16 prototxt (net-level FLOAT16 defaults under
    an f32 solver), 5 SGD iterations against the JAX Solver from the same
    weights, feeds and Dropout masks."""
    import test_torch_train as tt
    text = tt.solver_text('precision: "bf16"')
    if spelling == "fp16_prototxt":
        text = tt.solver_text().replace(
            "net_param { ", "net_param { default_forward_type: FLOAT16 "
            "default_backward_type: FLOAT16 ")
    jsolver = JaxSolver(JaxSP.from_text(text))
    jf32 = JaxSolver(JaxSP.from_text(tt.solver_text()))
    port = Solver(SolverParameter.from_text(text), device="cpu")
    load_jax_params(port.net, jax.tree_util.tree_map(np.asarray,
                                                     jsolver.params))
    assert {str(l.policy.forward) for l in port.net.layers} == \
        {"torch.bfloat16"}
    feeds = tt._feeds(5)
    jlosses = [jsolver.step(1, lambda k: feeds[k]) for _ in range(5)]
    jf32.step(5, lambda k: feeds[k])
    port.step(5, tt._torch_feeds(feeds),
              dropout_masks=tt._jax_masks(jsolver))
    np.testing.assert_allclose(port.losses, jlosses, **NET_LOSS)
    _within_the_jax_band(jsolver.params, jf32.params, port.net)
    assert port._guard_on == (spelling == "precision")
    assert _telemetry(port) == _telemetry(jsolver)


def test_five_iterations_of_a_narrow_resnet_in_bf16_match_jax():
    """The narrow ResNet of tests/test_torch_resnet.py (BatchNorm with
    float32 statistics, Scale, Eltwise, Concat) under precision: bf16,
    running statistics included."""
    import test_torch_resnet as tr
    text = tr.solver_text('precision: "bf16"')
    jsolver = JaxSolver(JaxSP.from_text(text))
    jf32 = JaxSolver(JaxSP.from_text(tr.solver_text()))
    port = Solver(SolverParameter.from_text(text), device="cpu")
    load_jax_params(port.net, jax.tree_util.tree_map(np.asarray,
                                                     jsolver.params),
                    jax.tree_util.tree_map(np.asarray, jsolver.net_state))
    feeds = tr._feeds(5)
    jlosses = [jsolver.step(1, lambda k: feeds[k]) for _ in range(5)]
    jf32.step(5, lambda k: feeds[k])
    port.step(5, tr._torch_feeds(feeds))
    np.testing.assert_allclose(port.losses, jlosses, **NET_LOSS)
    _within_the_jax_band(jsolver.params, jf32.params, port.net)
    _within_the_jax_band(jsolver.net_state, jf32.net_state, port.net)
    for lname, sname, buf in port.net.state_buffers():
        assert buf.dtype == torch.float32, (lname, sname)
    assert _telemetry(port) == _telemetry(jsolver)


# -- Net precision --------------------------------------------------------------

def test_bf16_registries_are_the_jax_packages():
    from caffe_mpi_tpu.proto import netshape as jax_netshape
    from caffe_mpi_tpu_torch.layers.base import LAYER_REGISTRY
    from caffe_mpi_tpu_torch.proto import netshape
    assert netshape.BF16_ELIGIBLE == jax_netshape.BF16_ELIGIBLE
    assert netshape.BF16_INELIGIBLE == jax_netshape.BF16_INELIGIBLE
    # every registered type is classified; the ineligible types the port
    # registers are the host steps and the refused HDF5Output, all of them
    assert set(LAYER_REGISTRY) - netshape.BF16_ELIGIBLE == {
        "DetectNetTransformation", "Python", "HDF5Output"}
    assert netshape.BF16_INELIGIBLE <= set(LAYER_REGISTRY)


@pytest.mark.parametrize("header,layer_type,want,warns", [
    ("", "", {"c": torch.bfloat16, "logits": torch.bfloat16}, False),
    # a layer's own type wins over the knob (the conv computes in f32;
    # the in-place ReLU after it makes "c" bf16 again)
    ("", "forward_type: FLOAT", {"logits": torch.bfloat16}, False),
    # explicit net defaults win: the knob engages nowhere, and says so
    ("default_forward_type: FLOAT default_backward_type: FLOAT", "",
     {"c": torch.float32, "logits": torch.float32}, True),
])
def test_precision_bf16_rewrites_only_the_net_defaults_as_jax(
        header, layer_type, want, warns, caplog):
    from caffe_mpi_tpu.net import Net as JaxNet
    from caffe_mpi_tpu_torch.net import Net
    text = NET.replace('name: "prec_net"', f'name: "prec_net" {header}')
    text = text.replace('convolution_param { num_output: 4',
                        f'{layer_type} convolution_param {{ num_output: 4')
    with caplog.at_level("WARNING"):
        net = Net(NetParameter.from_text(text), "TRAIN", device="cpu",
                  precision="bf16")
    assert ("did not engage" in caplog.text) == warns
    jnet = JaxNet(JaxNP.from_text(text), "TRAIN", precision="bf16")
    for layer, jlayer in zip(net.layers, jnet.layers):
        assert str(layer.policy.forward).split(".")[-1] == \
            str(jnp.dtype(jlayer.policy.forward)), layer.name
    conv = net.layer_by_name("conv").policy.forward
    assert conv == (torch.float32 if layer_type or header
                    else torch.bfloat16)
    blobs, loss = net(_feeds(_batches())[1](0))
    assert {k: blobs[k].dtype for k in want} == want
    assert loss.dtype == torch.float32


@pytest.mark.parametrize("storage,dtype", [("FLOAT", torch.float32),
                                           ("FLOAT16", torch.bfloat16),
                                           ("DOUBLE", torch.float32)])
def test_solver_data_type_picks_the_master_storage(storage, dtype):
    from caffe_mpi_tpu_torch.net import Net
    net = Net(NetParameter.from_text(NET), "TRAIN", device="cpu",
              solver_storage=storage)
    assert {p.dtype for _, _, p in ((l, n, getattr(net.layer_by_name(l),
                                                   n))
                                    for l, n, _ in
                                    net.learnable_param_decls())} == {dtype}
