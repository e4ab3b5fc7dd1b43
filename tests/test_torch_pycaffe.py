"""Port parity: the pycaffe API (`caffe_mpi_tpu_torch.pycaffe`) against the
JAX package's (`caffe_mpi_tpu.pycaffe`), on the CPU (`device="cpu"` or
`set_mode_cpu()`).

- `Net`: blobs, params, forward, backward, copy_from and save on a narrow
  CaffeNet-like net without Dropout (the JAX module draws Dropout from
  its own key, which the port cannot repeat), the weights carried across
  by a .caffemodel that the JAX module writes; the port's .caffemodel
  byte for byte the JAX module's.
- `NetSpec`: the text of examples/pycaffe/caffenet.py's program and of a
  program using every layer type this slice adds, byte-equal to the JAX
  NetSpec's.
- `coord_map_from_to`: equal to the JAX function's.
- `Classifier.predict` (oversampled and center crop) and
  `Detector.detect_windows` (context_pad) on a narrow CaffeNet and
  R-CNN: scores within 1e-4 of the JAX module's.
- `SGDSolver`: 5 steps against the JAX `SGDSolver` on the same weights
  and inputs, at the solver tolerances of tests/test_torch_train.py
  (losses rtol 1e-5, params rtol 1e-5 / atol 1e-6).
- examples/pycaffe's check: the Python EuclideanLossLayer of
  examples/pycaffe/layers/pyloss.py trains to the parameters of the
  built-in EuclideanLoss; examples/net_surgery's two acts.
- the io module's conversions, oversample and load_image against the
  JAX module's; the card as the default device.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

import caffe_mpi_tpu.pycaffe as jcaffe
import caffe_mpi_tpu_torch.pycaffe as caffe
from caffe_mpi_tpu import coord_map as jax_coord_map
from caffe_mpi_tpu import net_spec as jax_net_spec
from caffe_mpi_tpu.proto import NetParameter as JaxNP
from caffe_mpi_tpu_torch import coord_map, net_spec
from caffe_mpi_tpu_torch.proto import NetParameter
from caffe_mpi_tpu_torch.weights import load_jax_params

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)  # of the largest score
F32_OUT = dict(rtol=1e-5, atol=1e-6)


def _narrow(path: str, tmp_path, name: str, dim: int = 67,
            batch: int = 10) -> str:
    """A copy of a zoo prototxt at narrow widths and a small input."""
    with open(os.path.join(_ROOT, path)) as f:
        text = f.read()
    widths = {"96": "8", "256": "8", "384": "8", "4096": "16",
              "1000": "10", "200": "10"}
    text = re.sub(r"num_output: (\d+)",
                  lambda m: f"num_output: {widths[m.group(1)]}", text)
    text = text.replace("dim: 227", f"dim: {dim}").replace(
        "dim: 10\n", f"dim: {batch}\n", 1)
    out = tmp_path / name
    out.write_text(text)
    return str(out)


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    big = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * big, err_msg=name)


# -- Net -----------------------------------------------------------------

NET = '''name: "narrow"
layer { name: "in" type: "Input" top: "data" top: "label"
  input_param { shape { dim: 4 dim: 3 dim: 20 dim: 20 } shape { dim: 4 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 6 kernel_size: 5 stride: 2
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.001 beta: 0.75 } }
layer { name: "pool1" type: "Pooling" bottom: "norm1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "up" type: "Deconvolution" bottom: "pool1" top: "up"
  convolution_param { num_output: 4 kernel_size: 2 stride: 2
    weight_filler { type: "bilinear" } } }
layer { name: "prelu" type: "PReLU" bottom: "up" top: "up" }
layer { name: "fc" type: "InnerProduct" bottom: "up" top: "fc"
  inner_product_param { num_output: 5
    weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc" bottom: "label"
  top: "loss" }
'''


@pytest.fixture
def net_pair(tmp_path):
    model = tmp_path / "net.prototxt"
    model.write_text(NET)
    jnet = jcaffe.Net(str(model), jcaffe.TRAIN)
    weights = str(tmp_path / "jax.caffemodel")
    jnet.save(weights)
    port = caffe.Net(str(model), weights, caffe.TRAIN, device="cpu")
    r = np.random.RandomState(0)
    x = r.randn(4, 3, 20, 20).astype(np.float32)
    y = r.randint(0, 5, 4).astype(np.float32)
    return jnet, port, x, y, tmp_path


def test_net_blobs_params_forward_backward_match_jax(net_pair):
    jnet, port, x, y, _ = net_pair
    assert port.inputs == jnet.inputs == ["data", "label"]
    assert port.outputs == jnet.outputs
    assert list(port.params) == list(jnet.params)
    for name in jnet.params:
        for a, b in zip(port.params[name], jnet.params[name]):
            np.testing.assert_array_equal(a.data, b.data)
    for net in (jnet, port):
        net.blobs["data"].data = x
        net.blobs["label"].data = y
    got, want = port.forward(), jnet.forward()
    assert list(got) == list(want) == ["loss"]
    assert set(port.blobs) == set(jnet.blobs)
    for name in jnet.blobs:
        assert port.blobs[name].data.shape == jnet.blobs[name].data.shape
        _close(port.blobs[name].data, jnet.blobs[name].data, F32_OUT, name)
    port.backward()
    jnet.backward()
    for name in jnet.params:
        for i, (a, b) in enumerate(zip(port.params[name],
                                       jnet.params[name])):
            _close(a.diff, b.diff, dict(rtol=1e-5, atol=1e-5),
                   f"{name}[{i}] diff")


def test_param_assignment_reaches_the_forward_and_save_is_the_jax_file(
        net_pair):
    """Assigning params[...].data writes the live tensor; save writes the
    bytes the JAX module writes for the same weights, and copy_from of
    that file into the JAX net gives the port's forward."""
    jnet, port, x, y, tmp_path = net_pair
    w = port.params["fc"][0].data.copy()
    w[0] = 0.0
    for net in (port, jnet):
        net.params["fc"][0].data = w
        net.params["fc"][1].data = np.full((5,), 0.5, np.float32)
    port.forward(data=x, label=y)
    np.testing.assert_allclose(port.blobs["fc"].data[:, 0], 0.5, rtol=1e-6)
    a, b = str(tmp_path / "port.caffemodel"), str(tmp_path / "j.caffemodel")
    port.save(a)
    jnet.save(b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    jnet.copy_from(a)
    want = jnet.forward(data=x, label=y)
    _close(port.blobs["loss"].data, want["loss"], F32_OUT)


def test_hdf5_weights_are_refused_naming_the_item(net_pair):
    _, port, *_ = net_pair
    for call in (port.save, port.copy_from):
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP\.md §1 item 7"):
            call("w.h5")


def test_backward_leaves_layer_state_and_takes_masks(tmp_path):
    """A TRAIN BatchNorm's running statistics are put back after
    backward; Dropout takes handed-in masks (the card-against-CPU rule)."""
    model = tmp_path / "bn.prototxt"
    model.write_text(NET.replace(
        'layer { name: "relu1"',
        'layer { name: "bn" type: "BatchNorm" bottom: "conv1" '
        'top: "conv1" }\nlayer { name: "relu1"').replace(
        'layer { name: "loss"',
        'layer { name: "drop" type: "Dropout" bottom: "fc" top: "fc" }\n'
        'layer { name: "loss"'))
    net = caffe.Net(str(model), caffe.TRAIN, device="cpu")
    net.blobs["data"].data = np.random.RandomState(1).randn(
        4, 3, 20, 20).astype(np.float32)
    bn = net.layer_dict["bn"]
    before = bn.mean.clone()
    masks = {"drop": torch.ones(4, 5, dtype=torch.bool)}
    net.backward(dropout_masks=masks)
    d1 = net.params["conv1"][0].diff
    assert torch.equal(bn.mean, before) and np.abs(d1).max() > 0
    net.backward(dropout_masks=masks)
    np.testing.assert_array_equal(net.params["conv1"][0].diff, d1)


# -- NetSpec, coord_map ---------------------------------------------------

def _every_new_type(L, NetSpec):
    n = NetSpec("zoo")
    n.data, n.label = L.Input(ntop=2, input_param=dict(
        shape=[dict(dim=[2, 3, 16, 16]), dict(dim=[2])]))
    n.conv = L.Convolution(n.data, num_output=4, kernel_size=3, pad=1,
                           remat=True)
    n.prelu = L.PReLU(n.conv, in_place=True, channel_shared=False)
    n.elu = L.ELU(n.prelu, alpha=0.5)
    n.tanh = L.TanH(n.elu)
    n.bnll = L.BNLL(n.tanh)
    n.power = L.Power(n.bnll, power=2.0, scale=0.5, shift=1.0)
    n.exp = L.Exp(n.power, base=2.0)
    n.log = L.Log(n.exp)
    n.absval = L.AbsVal(n.log)
    n.thr = L.Threshold(n.absval, threshold=0.5)
    n.up = L.Deconvolution(n.absval, num_output=4, kernel_size=2, stride=2,
                           weight_filler=dict(type="bilinear"))
    n.crop = L.Crop(n.up, n.data, axis=2, offset=[1, 2])
    n.cols = L.Im2col(n.crop, convolution_param=dict(kernel_size=3))
    n.spp = L.SPP(n.crop, pyramid_height=2, pool="MAX")
    n.mvn = L.MVN(n.crop, across_channels=True)
    n.pool = L.Pooling(n.mvn, pool="STOCHASTIC", kernel_size=2, stride=2)
    n.a, n.b = L.Split(n.pool, ntop=2)
    n.flat = L.Flatten(n.a, axis=1)
    n.resh = L.Reshape(n.b, shape=dict(dim=[0, -1]))
    n.red = L.Reduction(n.flat, operation="SUMSQ", axis=1, coeff=0.5)
    n.arg = L.ArgMax(n.resh, top_k=2, out_max_val=True)
    n.idx = L.Input(input_param=dict(shape=[dict(dim=[2])]))
    n.reidx = L.BatchReindex(n.flat, n.idx)
    n.filt = L.Filter(n.flat, n.label)
    n.sce = L.SigmoidCrossEntropyLoss(n.resh, n.resh)
    n.hinge = L.HingeLoss(n.resh, n.label, norm="L2")
    n.mlog = L.MultinomialLogisticLoss(n.resh, n.label)
    n.info = L.InfogainLoss(n.resh, n.label, source="H.binaryproto")
    n.py = L.Python(n.flat, n.flat, module="layers.pyloss",
                    layer="EuclideanLossLayer", loss_weight=1)
    n.silence = L.Silence(n.thr, n.cols, n.spp, n.red, n.arg, n.reidx,
                          n.filt, ntop=0)
    return n.to_prototxt()


def test_netspec_text_is_the_jax_netspec_text():
    sys.path.insert(0, os.path.join(_ROOT, "examples", "pycaffe"))
    try:
        import caffenet as example
    finally:
        sys.path.pop(0)
    want = example.caffenet(batch_size=32, include_acc=True)
    assert example.L is jax_net_spec.L
    example.L, example.NetSpec = net_spec.L, net_spec.NetSpec
    try:
        got = example.caffenet(batch_size=32, include_acc=True)
    finally:
        example.L, example.NetSpec = jax_net_spec.L, jax_net_spec.NetSpec
    assert got == want and "CaffeNet" in got
    got = _every_new_type(net_spec.L, net_spec.NetSpec)
    assert got == _every_new_type(jax_net_spec.L, jax_net_spec.NetSpec)
    parsed = NetParameter.from_text(got)
    assert {lp.type for lp in parsed.layer} >= {
        "PReLU", "Deconvolution", "Crop", "SPP", "MVN", "InfogainLoss",
        "Python", "Silence", "BatchReindex", "Filter"}
    assert caffe.NetSpec is net_spec.NetSpec and caffe.L is net_spec.L


FCN = '''name: "fcn"
layer { name: "in" type: "Input" top: "data"
  input_param { shape { dim: 1 dim: 3 dim: 64 dim: 64 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 4 kernel_size: 3 pad: 100 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "conv2" type: "Convolution" bottom: "pool1" top: "conv2"
  convolution_param { num_output: 4 kernel_size: 5 stride: 2 pad: 1
    dilation: 2 } }
layer { name: "norm" type: "LRN" bottom: "conv2" top: "norm" }
layer { name: "score" type: "Convolution" bottom: "norm" top: "score"
  convolution_param { num_output: 2 kernel_size: 1 } }
layer { name: "up" type: "Deconvolution" bottom: "score" top: "up"
  convolution_param { num_output: 2 kernel_size: 8 stride: 4 } }
layer { name: "crop" type: "Crop" bottom: "up" bottom: "data" top: "crop" }
layer { name: "prob" type: "Softmax" bottom: "crop" top: "prob" }
'''


@pytest.mark.parametrize("pair", [("data", "up"), ("up", "data"),
                                  ("pool1", "conv2"), ("data", "prob"),
                                  ("conv1", "score")])
def test_coord_map_equals_the_jax_function(pair):
    got = coord_map.coord_map_from_to(NetParameter.from_text(FCN), *pair)
    want = jax_coord_map.coord_map_from_to(JaxNP.from_text(FCN), *pair)
    assert got == want


# -- Classifier, Detector ---------------------------------------------------

def _seed_weights(jax_model, tmp_path):
    """A .caffemodel the JAX module writes from its seeded init."""
    path = str(tmp_path / "w.caffemodel")
    jcaffe.Net(jax_model, jcaffe.TEST).save(path)
    return path


PREP = dict(raw_scale=255.0, mean=np.array([104.0, 117.0, 123.0]),
            channel_swap=(2, 1, 0))


@pytest.mark.parametrize("oversample", [True, False])
def test_classifier_predict_matches_jax(tmp_path, oversample):
    model = _narrow("models/caffenet/deploy.prototxt", tmp_path,
                    "caffenet.prototxt")
    weights = _seed_weights(model, tmp_path)
    r = np.random.RandomState(4)
    images = [r.rand(80, 90, 3).astype(np.float32) for _ in range(3)]
    want = jcaffe.Classifier(model, weights, image_dims=(75, 75),
                             **PREP).predict(images, oversample)
    clf = caffe.Classifier(model, weights, image_dims=(75, 75),
                           device="cpu", **PREP)
    got = clf.predict(images, oversample)
    assert got.shape == want.shape == (3, 10)
    _close(got, want, SCORE_TOL)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)
    # the blobs of the last bucket, through the full-env forward: the
    # third image's 10 crops, or the 3 center crops padded to bucket 4
    fwd = clf.bucket_forward()
    assert fwd is not None and fwd.ladder == (1, 4, 10)
    prob = clf.blobs["prob"].data
    if oversample:
        assert prob.shape == (10, 10)
        _close(prob.mean(0), got[-1], F32_OUT)
    else:
        assert prob.shape == (4, 10)
        _close(prob[:3], got, F32_OUT)


def test_detector_detect_windows_matches_jax(tmp_path):
    from PIL import Image
    model = _narrow("models/rcnn/deploy.prototxt", tmp_path, "rcnn.prototxt")
    weights = _seed_weights(model, tmp_path)
    r = np.random.RandomState(5)
    jobs = []
    for i in range(2):
        path = str(tmp_path / f"im{i}.png")
        Image.fromarray(r.randint(0, 256, (60, 80, 3)).astype(
            np.uint8)).save(path)
        windows = []
        for _ in range(7):
            y0, x0 = r.randint(0, 40), r.randint(0, 60)
            windows.append((y0, x0, y0 + r.randint(8, 20),
                            x0 + r.randint(8, 20)))
        jobs.append((path, windows))
    kw = dict(context_pad=4, **PREP)
    want = jcaffe.Detector(model, weights, **kw).detect_windows(jobs)
    got = caffe.Detector(model, weights, device="cpu",
                         **kw).detect_windows(jobs)
    assert len(got) == len(want) == 14
    for g, w in zip(got, want):
        assert g["filename"] == w["filename"] and g["window"] == w["window"]
    _close(np.stack([g["prediction"] for g in got]),
           np.stack([w["prediction"] for w in want]), SCORE_TOL)


def test_classifier_without_a_ladder_takes_the_declared_batch_loop(
        tmp_path):
    """A deploy net fed by MemoryData cannot ladder: the declared-batch
    loop, the same scores as the bucket path's."""
    model = _narrow("models/caffenet/deploy.prototxt", tmp_path,
                    "caffenet.prototxt", batch=4)
    weights = _seed_weights(model, tmp_path)
    images = [np.random.RandomState(6).rand(67, 67, 3).astype(np.float32)
              for _ in range(5)]
    want = caffe.Classifier(model, weights, device="cpu").predict(
        images, oversample=False)
    text = open(model).read()
    first = text.index("layer {")
    second = text.index("layer {", first + 1)
    mem = tmp_path / "mem.prototxt"
    mem.write_text(text[:first] + 'layer { name: "data" type: "MemoryData" '
                   'top: "data" top: "label" memory_data_param { '
                   'batch_size: 4 channels: 3 height: 67 width: 67 } }\n'
                   + text[second:])
    clf = caffe.Classifier(str(mem), weights, device="cpu")
    got = clf.predict(images, oversample=False)
    assert clf.bucket_forward() is None
    _close(got, want, F32_OUT)


# -- SGDSolver -----------------------------------------------------------

def test_sgd_solver_five_steps_match_jax(tmp_path):
    from test_torch_train import B, train_val
    net = tmp_path / "train_val.prototxt"
    text = train_val(B).replace('type: "Dropout"', 'type: "ReLU"').replace(
        "dropout_param { dropout_ratio: 0.5 }", "")
    net.write_text('name: "SmallAlexNet"\n' + text)
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net}"\nbase_lr: 0.01\nlr_policy: "step"\n'
                      'gamma: 0.1\nstepsize: 3\nmax_iter: 100\n'
                      'momentum: 0.9\nweight_decay: 0.0005\nsnapshot: 0\n'
                      'display: 0\ntype: "Nesterov"\n')
    jsolver = jcaffe.get_solver(str(solver))
    port = caffe.get_solver(str(solver), device="cpu")
    assert type(port).__name__ == "SGDSolver"
    load_jax_params(port.solver.net, jsolver._solver.params,
                    jsolver._solver.net_state)
    r = np.random.RandomState(0)
    shapes = port.solver.net.blob_shapes
    x = r.randn(*shapes["data"]).astype(np.float32)
    y = r.randint(0, 10, shapes["label"]).astype(np.int32)
    for s in (jsolver, port):
        s.net.blobs["data"].data = x
        s.net.blobs["label"].data = y
    losses = []
    for _ in range(5):
        losses.append((port.step(1), float(jsolver._solver.step(
            1, jsolver._feed_fn()))))
    assert port.iter == jsolver.iter == 5
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    jp = jsolver._solver.params
    for lname, blobs in jp.items():
        for pname, want in blobs.items():
            got = getattr(port.solver.net.layer_by_name(lname), pname)
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{lname}.{pname}")
    port.close()


# -- examples ---------------------------------------------------------------

def test_python_euclidean_loss_trains_as_the_builtin(tmp_path):
    """examples/pycaffe's check on the port: a regression net whose loss
    is the Python EuclideanLossLayer (numpy forward and backward,
    examples/pycaffe/layers/pyloss.py) trains to the parameters of the
    same net with the built-in EuclideanLoss."""
    base = '''name: "lin"
layer { name: "in" type: "Input" top: "x" top: "t"
        input_param { shape { dim: 8 dim: 5 } shape { dim: 8 dim: 3 } } }
layer { name: "ip" type: "InnerProduct" bottom: "x" top: "y"
        inner_product_param { num_output: 3
          weight_filler { type: "xavier" } } }
%s'''
    nets = {"builtin": base % ('layer { name: "loss" type: "EuclideanLoss" '
                               'bottom: "y" bottom: "t" top: "l" }'),
            "python": base % ('layer { name: "loss" type: "Python" '
                              'bottom: "y" bottom: "t" top: "l" '
                              'loss_weight: 1 python_param { module: '
                              '"layers.pyloss" layer: "EuclideanLossLayer" '
                              '} }')}
    r = np.random.RandomState(0)
    data = [(r.randn(8, 5).astype(np.float32),
             r.randn(8, 3).astype(np.float32)) for _ in range(4)]
    out = {}
    sys.path.insert(0, os.path.join(_ROOT, "examples", "pycaffe"))
    try:
        for kind, text in nets.items():
            (tmp_path / f"{kind}.prototxt").write_text(text)
            (tmp_path / f"{kind}_solver.prototxt").write_text(
                f'net: "{tmp_path / kind}.prototxt"\nbase_lr: 0.1\n'
                'momentum: 0.9\nlr_policy: "fixed"\nmax_iter: 20\n'
                'type: "SGD"\nrandom_seed: 11\ndisplay: 0\nsnapshot: 0\n')
            solver = caffe.SGDSolver(str(tmp_path / f"{kind}_solver.prototxt"),
                                     device="cpu")
            if kind == "python":
                assert solver.solver.net.layer_by_name("loss").host_step
            loss = None
            for it in range(12):
                x, t = data[it % 4]
                solver.net.blobs["x"].data = x
                solver.net.blobs["t"].data = t
                loss = solver.step(1)
            out[kind] = (solver.net.params["ip"][0].data, loss)
    finally:
        sys.path.pop(0)
    np.testing.assert_allclose(out["python"][0], out["builtin"][0],
                               rtol=1e-5, atol=1e-6)
    assert abs(out["python"][1] - out["builtin"][1]) < 1e-5


def test_net_surgery_acts(tmp_path):
    """examples/net_surgery's two acts through the port's pycaffe: a
    hand-edited kernel through forward(), and the fc -> conv cast
    computing the original net densely."""
    sys.path.insert(0, os.path.join(_ROOT, "examples", "net_surgery"))
    try:
        import run as surgery
    finally:
        sys.path.pop(0)
    orig, conv = tmp_path / "windownet.prototxt", tmp_path / "full.prototxt"
    orig.write_text(surgery.ORIG)
    conv.write_text(surgery.FULL_CONV)
    caffe.set_mode_cpu()
    try:
        net = caffe.Net(str(orig), caffe.TEST)
        w = np.array(net.params["conv1"][0].data)
        w[0] = 0.0
        w[0, 0, 2, 2] = 1.0
        net.params["conv1"][0].data = w
        net.params["conv1"][1].data = np.zeros(8, np.float32)
        r = np.random.RandomState(0)
        img = r.randn(1, 1, 16, 16).astype(np.float32)
        net.blobs["data"].data = img
        net.forward()
        np.testing.assert_allclose(net.blobs["conv1"].data[0, 0],
                                   np.maximum(img[0, 0, 2:-2, 2:-2], 0),
                                   rtol=1e-5, atol=1e-6)
        weights = str(tmp_path / "windownet.caffemodel")
        net.save(weights)
        net_fc = caffe.Net(str(conv), weights, caffe.TEST)
        np.testing.assert_array_equal(net_fc.params["conv1"][0].data, w)
        p, fp = net.params, net_fc.params
        fp["fc-conv"][0].data = np.array(p["fc"][0].data).reshape(
            16, 8, 6, 6)
        fp["fc-conv"][1].data = np.array(p["fc"][1].data)
        fp["score-conv"][0].data = np.array(p["score"][0].data).reshape(
            3, 16, 1, 1)
        fp["score-conv"][1].data = np.array(p["score"][1].data)
        big = r.randn(1, 1, 24, 24).astype(np.float32)
        net_fc.blobs["data"].data = big
        net_fc.forward()
        dense = net_fc.blobs["score"].data
        assert dense.shape == (1, 3, 5, 5)
        for i, j in [(0, 0), (2, 3), (4, 4)]:
            net.blobs["data"].data = big[:, :, 2 * i:2 * i + 16,
                                         2 * j:2 * j + 16]
            net.forward()
            np.testing.assert_allclose(dense[0, :, i, j],
                                       net.blobs["score"].data[0],
                                       rtol=1e-4, atol=1e-5)
        assert net._net.device.type == "cpu"
    finally:
        caffe.set_mode_gpu()


# -- io, registry, device ----------------------------------------------------

def test_io_conversions_oversample_and_load_image_match_jax(tmp_path):
    from PIL import Image
    r = np.random.RandomState(7)
    blob = r.randn(2, 3, 4).astype(np.float32)
    assert caffe.io.array_to_blobproto(blob) == \
        jcaffe.io.array_to_blobproto(blob)
    np.testing.assert_array_equal(caffe.io.blobproto_to_array(
        jcaffe.io.array_to_blobproto(blob)).reshape(blob.shape), blob)
    img = r.randint(0, 256, (3, 5, 6)).astype(np.uint8)
    assert caffe.io.array_to_datum(img, 7) == jcaffe.io.array_to_datum(img, 7)
    got, label = caffe.io.datum_to_array(jcaffe.io.array_to_datum(img, 7))
    np.testing.assert_array_equal(got, img)
    assert label == 7
    ims = [r.rand(12, 14, 3).astype(np.float32) for _ in range(2)]
    np.testing.assert_array_equal(caffe.io.oversample(ims, (8, 8)),
                                  jcaffe.io.oversample(ims, (8, 8)))
    path = str(tmp_path / "im.png")
    Image.fromarray(r.randint(0, 256, (9, 11, 3)).astype(np.uint8)).save(
        path)
    for color in (True, False):
        np.testing.assert_array_equal(caffe.io.load_image(path, color),
                                      jcaffe.io.load_image(path, color))


def test_layer_type_list_is_the_jax_list_but_pipeline():
    assert set(jcaffe.layer_type_list()) == set(caffe.layer_type_list())
    assert caffe.layer_type_list() == sorted(caffe.layer_type_list())


def test_the_card_is_the_default(tmp_path, monkeypatch):
    """Without a card every entry point raises unless the CPU was asked
    for; set_mode_cpu() or device="cpu" is the way onto it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = tmp_path / "net.prototxt"
    model.write_text(NET)
    for make in (lambda: caffe.Net(str(model), caffe.TEST),
                 lambda: caffe.Classifier(str(model), None)):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    assert caffe.Net(str(model), caffe.TEST, device="cpu")._net.device \
        == torch.device("cpu")
    caffe.set_mode_cpu()
    try:
        assert caffe.Net(str(model), caffe.TEST)._net.device.type == "cpu"
    finally:
        caffe.set_mode_gpu()


def test_a_host_layer_bucket_runs_eagerly_as_jax_runs_it(tmp_path):
    """A deploy net holding a Python layer (a host step) cannot be
    captured: `capturable()` is False and its buckets run eagerly; the
    Classifier's rows equal the JAX Classifier's (whose program calls the
    layer back on the host)."""
    (tmp_path / "halver.py").write_text(
        "class Halver:\n"
        "    def infer_shapes(self, shapes):\n"
        "        return [tuple(shapes[0])]\n\n"
        "    def forward(self, bottoms):\n"
        "        return [0.5 * bottoms[0]]\n")
    model = _narrow("models/caffenet/deploy.prototxt", tmp_path,
                    "caffenet.prototxt", batch=4)
    text = open(model).read().replace(
        'bottom: "fc8"\n  top: "prob"', 'bottom: "half"\n  top: "prob"')
    i = text.rindex("layer {")
    text = (text[:i] + 'layer { name: "half" type: "Python" bottom: "fc8" '
            'top: "half" python_param { module: "halver" layer: "Halver" '
            '} }\n' + text[i:])
    host = tmp_path / "host.prototxt"
    host.write_text(text)
    images = [np.random.RandomState(8).rand(67, 67, 3).astype(np.float32)
              for _ in range(6)]
    sys.path.insert(0, str(tmp_path))
    try:
        weights = _seed_weights(str(host), tmp_path)
        clf = caffe.Classifier(str(host), weights, device="cpu")
        got = clf.predict(images, oversample=False)
        want = jcaffe.Classifier(str(host), weights).predict(
            images, oversample=False)
    finally:
        sys.path.remove(str(tmp_path))
    assert not clf.bucket_forward().capturable()
    _close(got, want, SCORE_TOL)
