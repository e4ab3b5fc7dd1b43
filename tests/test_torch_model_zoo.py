"""Every net of the model zoo (models/*/*.prototxt but the solvers) builds
in the port, in TRAIN and in TEST, with the JAX `Net`'s blob shapes, param
shapes and state shapes: shape inference only, nothing initialised or run.
A net that still needs a layer type the port has not registered raises
naming that type. The ResNet-50 and GoogLeNet solvers train and resume
through the CLI at full width on a cut batch. The examples' three
Data-layer nets (mnist, cifar10, imagenet) build as written over tiny
LMDBs in tmp_path, with the JAX `Net`'s shapes and feed specs."""

import glob
import os

import numpy as np
import pytest
import torch

from caffe_mpi_tpu.net import Net as JaxNet
from caffe_mpi_tpu.proto import NetParameter as JaxNP
from caffe_mpi_tpu_torch.layers import LAYER_REGISTRY
from caffe_mpi_tpu_torch.net import Net
from caffe_mpi_tpu_torch.proto import NetParameter

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = sorted(os.path.relpath(p, _ROOT) for p in glob.glob(
    os.path.join(_ROOT, "models", "*", "*.prototxt"))
    if "solver" not in os.path.basename(p))
# the unported layer type each such net needs (ROADMAP.md section 1)
UNPORTED = {"models/transformer_lm/train_val_pp.prototxt": "Pipeline"}


def test_the_zoo_is_all_there():
    assert len(NETS) >= 39
    for t in ("BatchNorm", "Scale", "Concat"):
        assert t in LAYER_REGISTRY


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
@pytest.mark.parametrize("path", NETS)
def test_zoo_net_builds_with_the_jax_shapes(path, phase):
    text = os.path.join(_ROOT, path)
    if path in UNPORTED:
        with pytest.raises(ValueError, match=UNPORTED[path]):
            Net(NetParameter.from_file(text), phase, device="cpu")
        return
    # the port allocates its params uninitialised (torch.empty) at build
    net = Net(NetParameter.from_file(text), phase, device="cpu")
    jnet = JaxNet(JaxNP.from_file(text), phase)
    assert net.blob_shapes == jnet.blob_shapes
    assert [l.name for l in net.layers] == [l.name for l in jnet.layers]
    for layer, jl in zip(net.layers, jnet.layers):
        assert {n: d.shape for n, d in layer.decls.items()} == \
            {n: tuple(d.shape) for n, d in jl.params.items()}, layer.name
        assert layer.caffe_blobs() == jl.caffe_blobs(), layer.name
    # state: the shapes the JAX layers' init_state would give, without
    # running it (jl.channels is all BatchNorm's state needs)
    for layer, jl in zip(net.layers, jnet.layers):
        if jl.lp.type == "BatchNorm":
            assert layer.state_shapes == {"mean": (jl.channels,),
                                          "var": (jl.channels,)}
            assert all(getattr(layer, n).dtype == torch.float32
                       for n in layer.state_shapes)
        else:
            assert not layer.state_shapes, layer.name


@pytest.mark.parametrize("model,batch", [("resnet50", 32),
                                         ("googlenet", 128)])
def test_zoo_solver_trains_and_resumes_through_the_cli(model, batch,
                                                       tmp_path):
    """The zoo's ResNet-50 and GoogLeNet solvers through the CLI's
    `train` on the CPU, at full width with the Input batch cut to 1 in a
    copy of the net (the card trains them as written): an iteration with
    finite losses and a test pass through the train net's statistics, a
    snapshot, and a resume that brings back every parameter and running
    statistic bitwise before one more iteration."""
    from caffe_mpi_tpu_torch.tools import cli
    src = os.path.join(_ROOT, "models", model)
    with open(os.path.join(src, "train_val.prototxt")) as f:
        text = f.read()
    assert f"dim: {batch}\n" in text
    net = tmp_path / "train_val.prototxt"
    net.write_text(text.replace(f"dim: {batch}\n", "dim: 1\n"))
    with open(os.path.join(src, "solver.prototxt")) as f:
        solver = f.read()
    path = tmp_path / "solver.prototxt"
    path.write_text(solver.replace(f"models/{model}/train_val.prototxt",
                                   str(net)))
    argv = ["train", "-solver", str(path), "-synthetic", "-test_iter", "1",
            "-snapshot_prefix", str(tmp_path / "snap"), "-device", "cpu"]
    trained, summary = cli.train(cli.parse_args(argv + ["-max_iter", "1"]))
    assert summary["batch"] == 1 and np.all(np.isfinite(summary["losses"]))
    assert summary["test_scores"] and summary["snapshot"]
    tnet = trained.test_nets[0]
    for lname, sname, buf in trained.net.state_buffers():
        assert getattr(tnet.layer_by_name(lname), sname) is buf
        assert float(buf.abs().max()) > 0
    resumed, again = cli.train(cli.parse_args(
        argv + ["-max_iter", "2", "-snapshot", summary["snapshot"]]))
    assert again["start_iter"] == 1 and np.isfinite(again["losses"][0])
    check = type(resumed)(resumed.sp, model_dir=resumed.model_dir,
                          device="cpu")
    check.restore(summary["snapshot"])
    for (_, _, a), (_, _, b) in zip(trained.net.state_buffers(),
                                    check.net.state_buffers()):
        assert torch.equal(a, b)
    for (_, _, _, a), (_, _, _, b) in zip(trained._decls, check._decls):
        assert torch.equal(a, b)


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
@pytest.mark.parametrize("name", ["mnist", "cifar10", "imagenet"])
def test_example_data_nets_build_with_the_jax_shapes(name, phase, tmp_path):
    """As written (batch sizes, crop 227, mean files), over 8-record
    LMDBs; the Data layer probes its dataset and takes the device
    transform in both packages."""
    from test_torch_cli_tools import example_net
    text = example_net(tmp_path, name, narrow=False, n=8)
    net = Net(NetParameter.from_file(text), phase, device="cpu")
    jnet = JaxNet(JaxNP.from_file(text), phase)
    assert net.blob_shapes == jnet.blob_shapes
    assert net.feed_specs == jnet.feed_specs
    assert [l.name for l in net.layers] == [l.name for l in jnet.layers]
    data, jdata = net.layers[0], jnet.layers[0]
    assert data.lp.type == jdata.lp.type == "Data"
    assert data.dev_transform and jdata.dev_transform
    for layer, jl in zip(net.layers, jnet.layers):
        assert {n: d.shape for n, d in layer.decls.items()} == \
            {n: tuple(d.shape) for n, d in jl.params.items()}, layer.name
