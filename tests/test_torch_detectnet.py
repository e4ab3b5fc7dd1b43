"""Port parity: DetectNet (data/detectnet.py, layers/detection.py) and the
example nets that need this slice's layers (examples/kitti/
detectnet_tiny.prototxt, examples/siamese/mnist_siamese.prototxt),
against the JAX package, on the CPU.

The augmenter's random draws come from the same Philox streams as the
JAX augmenter's, so the same seed gives the same crops, shifts, flips,
hue rotations and desaturations: images, bboxes and coverage grids are
held bitwise. The nets run at batch 2: losses rtol 1e-5 and gradients
within 1e-5 of each one's largest element against `jax.grad` of the JAX
`Net.apply` (the same f32 math, convolution sums in other orders); 5 SGD
iterations against the JAX Solver at losses rtol 1e-5 and params rtol
1e-5 / atol 1e-6 (tests/test_torch_train.py). The DetectNet layer's TRAIN
seed is the JAX layer's draw from its step key, given to the port as the
layer's `mask`.

The JAX ReLU (`jnp.maximum(x, 0)`) takes a gradient of 0.5 where its input
is exactly 0; the reference (relu_layer.cpp: top_diff * (bottom > 0)) and
the port take 0. DetectNet's crop pads with zeros and the kitti net's
biases start at 0, so conv1 sees exact zeros and the JAX conv1.bias
gradient differs (0.28% of its largest element at batch 2). The net
tests run the JAX ReLU with the reference's rule at 0 (`caffe_relu`);
ROADMAP.md §3 lists it among the reference caveats.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.data import detectnet as jdet
from caffe_mpi_tpu.layers import detection as jdetection
from caffe_mpi_tpu.net import Net as JaxNet
from caffe_mpi_tpu.proto import NetParameter as JaxNP
from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.proto.config import (
    DetectNetAugmentationParameter as JaxAug,
    DetectNetGroundTruthParameter as JaxGT)
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu_torch.data import detectnet as pdet
from caffe_mpi_tpu_torch.layers import detection as pdetection
from caffe_mpi_tpu_torch.net import Net
from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
from caffe_mpi_tpu_torch.proto.config import (DetectNetAugmentationParameter,
                                              DetectNetGroundTruthParameter)
from caffe_mpi_tpu_torch.solver import Solver
from caffe_mpi_tpu_torch.weights import load_jax_params
from test_torch_train import _assert_params_equal, _host

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI = os.path.join(_ROOT, "examples", "kitti", "detectnet_tiny.prototxt")
SIAMESE = os.path.join(_ROOT, "examples", "siamese", "mnist_siamese.prototxt")
IMG_H, IMG_W, MAX_BOXES = 64, 128, 8
LOSSES = dict(rtol=1e-5)
PARAMS = dict(rtol=1e-5, atol=1e-6)
GRAD = 1e-5  # of the largest element


def _scene(r):
    """examples/kitti/run.py's synthetic scene: dark noise and 1-3 bright
    rectangles (class 1); (CHW float image, (n, 5) bboxes)."""
    img = r.randint(0, 60, (3, IMG_H, IMG_W)).astype(np.float32)
    boxes = []
    for _ in range(r.randint(1, 4)):
        w, h = r.randint(20, 48), r.randint(12, 28)
        x1 = r.randint(0, IMG_W - w)
        y1 = r.randint(0, IMG_H - h)
        color = r.randint(170, 256, 3)[:, None, None]
        img[:, y1:y1 + h, x1:x1 + w] = color + r.randint(-15, 16, (3, h, w))
        boxes.append([1, x1, y1, x1 + w, y1 + h])
    return np.clip(img, 0, 255), np.asarray(boxes, np.float32)


def _kitti_feed(batch, seed):
    r = np.random.RandomState(seed)
    imgs, labels = zip(*[(img, pdetection.encode_label_blob(b, MAX_BOXES))
                         for img, b in (_scene(r) for _ in range(batch))])
    return {"data": np.stack(imgs), "label": np.stack(labels)}


def _gt(text="stride: 8 scale_cvg: 0.4 gridbox_type: GRIDBOX_MIN "
        "min_cvg_len: 8 image_size_x: 128 image_size_y: 64 "
        "crop_bboxes: true"):
    return (DetectNetGroundTruthParameter.from_text(text),
            JaxGT.from_text(text))


# -- coverage, augmenter, label blobs -------------------------------------------

@pytest.mark.parametrize("gt_text", [
    "stride: 8 scale_cvg: 0.4 gridbox_type: GRIDBOX_MIN min_cvg_len: 8 "
    "image_size_x: 128 image_size_y: 64 crop_bboxes: true",
    "stride: 16 scale_cvg: 0.6 gridbox_type: GRIDBOX_MAX max_cvg_len: 30 "
    "image_size_x: 96 image_size_y: 64 crop_bboxes: false",
])
def test_coverage_label_is_bitwise_jax(gt_text):
    gt, jgt = _gt(gt_text)
    r = np.random.RandomState(3)
    boxes = np.concatenate([r.randint(0, 3, (9, 1)),
                            r.uniform(-10, 60, (9, 4))], 1).astype(
                                np.float32)
    boxes[:, [1, 3]] = np.sort(boxes[:, [1, 3]], axis=1)
    boxes[:, [2, 4]] = np.sort(boxes[:, [2, 4]], axis=1)
    for n in (0, 1, 9):
        for classes in (1, 2):
            np.testing.assert_array_equal(
                pdet.coverage_label(boxes[:n], gt, classes),
                jdet.coverage_label(boxes[:n], jgt, classes))


AUG = ("crop_prob: 1 shift_x: 8 shift_y: 8 flip_prob: 0.5 "
       "hue_rotation_prob: 0.5 hue_rotation: 30 desaturation_prob: 0.5 "
       "desaturation_max: 0.5 scale_prob: 0.5 scale_min: 0.8 scale_max: 1.3")


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_augmenter_is_bitwise_jax_at_the_same_seed(phase):
    gt, jgt = _gt()
    port = pdet.DetectNetAugmenter(
        DetectNetAugmentationParameter.from_text(AUG), gt, phase)
    jax_aug = jdet.DetectNetAugmenter(JaxAug.from_text(AUG), jgt, phase)
    r = np.random.RandomState(0)
    mean = np.array([110.0, 120.0, 127.0], np.float32)
    for seed in range(12):
        img, boxes = _scene(r)
        if seed % 3 == 0:  # a source larger than the canvas
            img = np.pad(img, ((0, 0), (5, 9), (3, 17)))
        for m in (None, mean):
            got = port(img, boxes, np.random.Generator(
                np.random.Philox(key=seed)), mean=m)
            want = jax_aug(img, boxes, np.random.Generator(
                np.random.Philox(key=seed)), mean=m)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_label_blobs_round_trip_as_jax():
    r = np.random.RandomState(1)
    for n in (0, 1, 5):
        boxes = np.concatenate([r.randint(1, 4, (n, 1)),
                                r.uniform(0, 50, (n, 4))], 1).astype(
                                    np.float32)
        blob = pdetection.encode_label_blob(boxes, 6)
        np.testing.assert_array_equal(
            blob, jdetection.encode_label_blob(boxes, 6))
        np.testing.assert_array_equal(pdetection.parse_label_blob(blob),
                                      jdetection.parse_label_blob(blob))
    bad = pdetection.encode_label_blob(boxes, 6)
    bad[0, 0, 1] = 12
    with pytest.raises(ValueError, match="bboxLen 12"):
        pdetection.parse_label_blob(bad)


def _layer_pair(phase):
    text = open(KITTI).read().replace("dim: 8", "dim: 2")
    net = Net(NetParameter.from_text(text), phase, device="cpu")
    jnet = JaxNet(JaxNP.from_text(text), phase)
    return net.layer_by_name("train_transform"), next(
        layer for layer in jnet.layers if layer.name == "train_transform")


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_detectnet_layer_forward_is_bitwise_jax(phase):
    """The layer's forward at a given seed (TRAIN: the `mask`; TEST: 0,
    whatever is given) against the JAX layer's host transform; no
    gradient into the bottoms."""
    port, jax_layer = _layer_pair(phase)
    port.train(phase == "TRAIN")
    feed = _kitti_feed(2, seed=4)
    for seed in (0, 7, 123456789):
        data = torch.from_numpy(feed["data"]).requires_grad_(True)
        img, cov = port([data, torch.from_numpy(feed["label"])],
                        mask=torch.tensor(seed))
        want = jax_layer._host_transform(
            feed["data"], feed["label"], seed if phase == "TRAIN" else 0)
        np.testing.assert_array_equal(img.numpy(), want[0])
        np.testing.assert_array_equal(cov.numpy(), want[1])
        assert not img.requires_grad and not cov.requires_grad
    assert cov.shape == (2, 5, 8, 16) and float(cov[:, 0].max()) == 1.0


# -- the example nets at batch 2 -------------------------------------------------

@pytest.fixture
def caffe_relu(monkeypatch):
    """The JAX ReLU with the reference's gradient at 0 (see the module
    docstring); negative slopes as the JAX layer computes them."""
    from caffe_mpi_tpu.layers import activations as jact
    plain = jact.ReLULayer.apply

    def apply(self, params, state, bottoms, *, train, rng):
        if self.lp.relu_param and self.lp.relu_param.negative_slope:
            return plain(self, params, state, bottoms, train=train, rng=rng)
        x = self.f(bottoms[0])
        return [jnp.where(x > 0, x, jnp.zeros_like(x))], state
    monkeypatch.setattr(jact.ReLULayer, "apply", apply)


def _jax_seed(rng, index):
    return int(jax.random.randint(jax.random.fold_in(rng, index), (), 0,
                                  np.int32(2**31 - 1)))


def _nets(path, cuts):
    text = open(path).read()
    for a, b in cuts:
        assert a in text, a
        text = text.replace(a, b)
    net = Net(NetParameter.from_text(text), "TRAIN", device="cpu")
    jnet = JaxNet(JaxNP.from_text(text), "TRAIN")
    params, state = jnet.init(jax.random.PRNGKey(5))
    load_jax_params(net, _host(params))
    return text, net, jnet, params, state


def _siamese_feed(batch, seed):
    r = np.random.RandomState(seed)
    t = r.rand(4, 1, 28, 28).astype(np.float32)
    a, b = r.randint(0, 4, batch), r.randint(0, 4, batch)
    noise = lambda: 0.2 * r.randn(batch, 1, 28, 28)  # noqa: E731
    return {"data": (t[a] + noise()).astype(np.float32),
            "data_p": (t[b] + noise()).astype(np.float32),
            "sim": (a == b).astype(np.float32)}


# (net, batch cuts, feed, loss tops, SGD base_lr: the kitti net's bbox
# L1 gradients reach ~3e3 at its initial weights)
NETS = {
    "kitti": (KITTI, [("dim: 8", "dim: 2")], lambda s: _kitti_feed(2, s),
              ("coverage_loss", "bbox_loss"), 1e-5),
    "siamese": (SIAMESE, [("dim: 32", "dim: 2")],
                lambda s: _siamese_feed(2, s), ("loss",), 0.01),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_example_net_losses_and_gradients_match_jax(name, caffe_relu):
    path, cuts, make_feed, loss_blobs, _ = NETS[name]
    _, net, jnet, params, state = _nets(path, cuts)
    feed = make_feed(11)
    rng = jax.random.PRNGKey(9)
    masks = {}
    for i, layer in enumerate(jnet.layers):
        if layer.lp.type == "DetectNetTransformation":
            masks[layer.name] = torch.tensor(_jax_seed(rng, i))

    def jloss(p):
        blobs, _, loss = jnet.apply(p, state, {k: jnp.asarray(v) for k, v
                                               in feed.items()},
                                    train=True, rng=rng)
        return loss, blobs

    (jl, jblobs), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    for lname, pname, _ in net.learnable_param_decls():
        getattr(net.layer_by_name(lname), pname).requires_grad_(True)
    blobs, loss = net({k: torch.from_numpy(v) for k, v in feed.items()},
                      dropout_masks=masks)
    for b in loss_blobs:
        np.testing.assert_allclose(float(blobs[b].detach()), float(jblobs[b]),
                                   err_msg=b, **LOSSES)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **LOSSES)
    loss.backward()
    for lname, pblobs in jgrads.items():
        for pname, g in pblobs.items():
            g = np.asarray(g)
            got = getattr(net.layer_by_name(lname), pname).grad.numpy()
            np.testing.assert_allclose(
                got, g, rtol=GRAD, atol=GRAD * max(np.abs(g).max(), 1e-30),
                err_msg=f"{lname}.{pname}")


def _solver_text(net_text, extra="", lr=1e-5):
    return ("net_param { " + net_text + f" }} base_lr: {lr} momentum: 0.9 "
            'weight_decay: 0.0005 lr_policy: "fixed" max_iter: 5 '
            "random_seed: 3 " + extra)


def _jax_seeds(jsolver, layer_name):
    """The DetectNet layer's seed the JAX solver draws at iteration it
    (iter_size 1), as the port's `mask`."""
    index = next(i for i, l in enumerate(jsolver.net.layers)
                 if l.name == layer_name)
    base = jax.random.PRNGKey(3)

    def masks(it, m):
        rng = jax.random.split(jax.random.fold_in(base, it + 1), 1)[m]
        return {layer_name: torch.tensor(_jax_seed(rng, index))}
    return masks


@pytest.mark.parametrize("name", sorted(NETS))
def test_five_sgd_iterations_of_the_example_net_match_jax(name, caffe_relu):
    path, cuts, make_feed, _, lr = NETS[name]
    text, *_ = _nets(path, cuts)
    sp = _solver_text(text, lr=lr)
    jsolver = JaxSolver(JaxSP.from_text(sp))
    port = Solver(SolverParameter.from_text(sp), device="cpu")
    load_jax_params(port.net, _host(jsolver.params))
    feeds = [make_feed(20 + k) for k in range(5)]
    jlosses = [jsolver.step(1, lambda k: feeds[k]) for _ in range(5)]
    masks = (_jax_seeds(jsolver, "train_transform") if name == "kitti"
             else None)
    port.step(5, lambda k: {key: torch.from_numpy(v)
                            for key, v in feeds[k].items()},
              dropout_masks=masks)
    np.testing.assert_allclose(port.losses, jlosses, **LOSSES)
    _assert_params_equal(_host(jsolver.params), port.net, **PARAMS)


def test_host_layer_net_runs_step_chunk_eagerly_with_the_k1_losses(caplog):
    """A net with the host layer under step_chunk 5: accepted (JAX
    accepts it), its chunks run as eager iterations (no CUDA graph: the
    layer copies its bottoms to the host), said in one log line; the
    losses, params and slots equal step_chunk 1's, with the seeds the
    solver draws from its generator."""
    import logging
    text, *_ = _nets(KITTI, [("dim: 8", "dim: 2")])
    feeds = [_kitti_feed(2, 30 + k) for k in range(6)]

    def run(chunk):
        s = Solver(SolverParameter.from_text(_solver_text(
            text, f"step_chunk: {chunk} display: 0")), device="cpu")
        s.step(6, lambda k: {key: torch.from_numpy(v)
                             for key, v in feeds[k].items()})
        return s

    with caplog.at_level(logging.INFO, "caffe_mpi_tpu_torch.solver"):
        k5 = run(5)
    assert any("host layers (train_transform)" in r.message and
               "eager iterations" in r.message for r in caplog.records)
    k1 = run(1)
    assert not k5._graphs_ok and k5.host_sync_count == 2
    assert k1.host_sync_count == 6
    assert k5.losses == k1.losses and np.all(np.isfinite(k1.losses))
    for (lname, pname, _, p), (_, _, _, q) in zip(k5._decls, k1._decls):
        assert torch.equal(p, q), f"{lname}.{pname}"
        for a, b in zip(k5.history[(lname, pname)],
                        k1.history[(lname, pname)]):
            assert torch.equal(a, b)
