"""Port parity: training from an LMDB, and the CLI's `test`, `time` and
`device_query`, the MAC model, convert_imageset and compute_image_mean,
against the JAX package on the CPU.

The nets are the examples' Data-layer nets over LMDBs of 64 records
written in tmp_path from seeded numpy clusters: LeNet
(examples/mnist/lenet_train_test.prototxt, 1x28x28, scale 1/256) at batch
8, and CaffeNet (examples/imagenet/caffenet_train_val.prototxt) narrowed
to widths 8-32 over 3x72x72 records cropped to 67, mirrored, with a mean
file, at batch 4. Both feed through the device transform (the default).

Tolerances, those of test_torch_train.py: 5 SGD iterations against the
JAX Solver on the JAX Feeder, losses rtol 1e-5, params and history rtol
1e-5 / atol 1e-6; `cli test` scores rtol 1e-5 (f32 means of f32 sums in
another order); MAC counts equal as integers; the tools' files byte for
byte.
"""

import filecmp
import json
import os
import re

import numpy as np
import pytest
import torch

from caffe_mpi_tpu.net import Net as JaxNet
from caffe_mpi_tpu.proto import NetParameter as JaxNP
from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu.tools import cli as jax_cli
from caffe_mpi_tpu.utils import flops as jax_flops
from caffe_mpi_tpu_torch.data import datasets as pds
from caffe_mpi_tpu_torch.data import feeder as pfeeder
from caffe_mpi_tpu_torch.data import lmdb_io as plmdb
from caffe_mpi_tpu_torch.io import save_blob_binaryproto
from caffe_mpi_tpu_torch.net import Net
from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
from caffe_mpi_tpu_torch.solver import Solver
from caffe_mpi_tpu_torch.tools import cli
from caffe_mpi_tpu_torch.utils import flops
from caffe_mpi_tpu_torch.weights import load_jax_params
from test_torch_data import close_jax
from test_torch_train import _assert_params_equal, _host, _jax_masks

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = dict(rtol=1e-5, atol=1e-6)
RECORDS = 64


def clusters(n, shape, seed, classes=10, noise=40):
    """Separable clusters (examples/common.py synthetic_clusters): one
    uint8 template a class, samples = template + bounded noise."""
    templates = np.random.RandomState(42).randint(0, 256, (classes, *shape))
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n)
    delta = rng.randint(-noise, noise + 1, (n, *shape))
    return np.clip(templates[labels] + delta, 0, 255).astype(np.uint8), labels


def write_db(path, shape, seed, n=RECORDS):
    """An LMDB of `n` raw Datums by the port's writer, and its mean."""
    imgs, labels = clusters(n, shape, seed)
    plmdb.write_lmdb(str(path), [(f"{i:08d}".encode(), pds.encode_datum(
        imgs[i], int(labels[i]))) for i in range(n)])
    return imgs.astype(np.float64).mean(axis=0).astype(np.float32)


# the three example Data-layer nets: (prototxt, record shape, batch cuts,
# text replacements that narrow them)
EXAMPLES = {
    "mnist": ("examples/mnist/lenet_train_test.prototxt", (1, 28, 28),
              {"batch_size: 64": "batch_size: 8",
               "batch_size: 100": "batch_size: 10"}),
    "cifar10": ("examples/cifar10/cifar10_quick_train_test.prototxt",
                (3, 32, 32), {"batch_size: 100": "batch_size: 4"}),
    "imagenet": ("examples/imagenet/caffenet_train_val.prototxt",
                 (3, 72, 72), {"batch_size: 256": "batch_size: 4",
                               "batch_size: 50": "batch_size: 4",
                               "crop_size: 227": "crop_size: 67",
                               "num_output: 96 ": "num_output: 8 ",
                               "num_output: 256 ": "num_output: 16 ",
                               "num_output: 384 ": "num_output: 16 ",
                               "num_output: 4096": "num_output: 32",
                               "num_output: 1000": "num_output: 10"}),
}


def example_net(tmp_path, name, narrow=True, n=RECORDS):
    """A copy of an example net over train and test LMDBs (and a mean
    file) in tmp_path; returns the prototxt's path. narrow=False keeps
    the net as written, over ImageNet-sized records for CaffeNet."""
    path, shape, cuts = EXAMPLES[name]
    with open(os.path.join(_ROOT, path)) as f:
        text = f.read()
    if narrow:
        for a, b in cuts.items():
            assert a in text, a
            text = text.replace(a, b)
    elif name == "imagenet":
        shape = (3, 256, 256)
    mean = write_db(tmp_path / f"{name}_train_lmdb", shape, seed=7, n=n)
    write_db(tmp_path / f"{name}_test_lmdb", shape, seed=8, n=min(n, 24))
    mean_path = str(tmp_path / f"{name}_mean.binaryproto")
    save_blob_binaryproto(mean_path, mean[None])
    srcs = re.findall(r'source: "([^"]+)"', text)
    assert len(srcs) == 2
    text = text.replace(srcs[0], str(tmp_path / f"{name}_train_lmdb"))
    text = text.replace(srcs[1], str(tmp_path / f"{name}_test_lmdb"))
    text = re.sub(r'mean_file: "[^"]+"', f'mean_file: "{mean_path}"', text)
    out = tmp_path / f"{name}_train_test.prototxt"
    out.write_text(text)
    return str(out)


def _solver_text(net_path):
    return (f'net: "{net_path}"\ntest_iter: 2\ntest_interval: 1000\n'
            'base_lr: 0.01\nmomentum: 0.9\nweight_decay: 0.0005\n'
            'lr_policy: "inv"\ngamma: 0.0001\npower: 0.75\nmax_iter: 5\n'
            'random_seed: 3\n')


@pytest.fixture(scope="module", params=["mnist", "imagenet"])
def five_steps(request, tmp_path_factory):
    """5 SGD iterations of the JAX Solver on the JAX Feeder and of the
    port's Solver on its DeviceFeed, from the same weights (and, for
    CaffeNet, the JAX solver's dropout masks)."""
    tmp = tmp_path_factory.mktemp(request.param)
    text = _solver_text(example_net(tmp, request.param))
    jsolver = JaxSolver(JaxSP.from_text(text))
    port = Solver(SolverParameter.from_text(text), device="cpu")
    load_jax_params(port.net, _host(jsolver.params))
    jfeed = jax_cli._build_feeders(jsolver.net, "TRAIN")
    jfeed._native = False  # the classic path (test_torch_data.py)
    jlosses = [jsolver.step(1, jfeed) for _ in range(5)]
    close_jax(jfeed)
    feed, test_fns, opened, feeder = cli._feed_fns(port, False)
    masks = _jax_masks(jsolver) if request.param == "imagenet" else None
    port.step(5, feed, dropout_masks=masks)
    for f in opened:
        f.close()
    return request.param, jsolver, port, jlosses, tmp


def test_five_sgd_iterations_from_an_lmdb_match_the_jax_solver(five_steps):
    name, jsolver, port, jlosses, _ = five_steps
    data = port.net.layers[0]
    assert data.lp.type == "Data" and data.dev_transform
    assert port.iter == jsolver.iter == 5
    np.testing.assert_allclose(port.losses, jlosses, rtol=1e-5)
    _assert_params_equal(jsolver.params, port.net, **STEP)
    for lname, blobs in jsolver.opt_state.items():
        for pname, slots in blobs.items():
            np.testing.assert_allclose(
                port.history[(lname, pname)][0].numpy(),
                np.asarray(slots[0]), err_msg=f"{lname}.{pname}", **STEP)


def test_cli_test_scores_match_the_jax_cmd_test(five_steps, capsys,
                                                monkeypatch):
    """The same caffemodel and LMDB through both CLIs. The JAX `cmd_test`
    prints its averages at %.5g and logs them as floats: the floats are
    taken from its log call."""
    name, jsolver, port, _, tmp = five_steps
    port.sp.snapshot_prefix = str(tmp / "snap")
    state = port.snapshot()
    model = state.replace(".solverstate", ".caffemodel")
    net = os.path.join(str(tmp), f"{name}_train_test.prototxt")
    argv = ["test", "-model", net, "-weights", model, "-iterations", "3"]
    logged = {}

    class _Log:
        @staticmethod
        def info(fmt, *args):
            if fmt == "%s = %.5g":
                logged[args[0]] = args[1]

    monkeypatch.setattr(jax_cli, "log", _Log)
    capsys.readouterr()
    assert jax_cli.main(argv) == 0
    want = dict(re.findall(r"^(\w+) = (\S+)$", capsys.readouterr().out,
                           re.M))
    assert cli.main(argv + ["-device", "cpu"]) == 0
    got = dict(re.findall(r"^(\w+) = (\S+)$", capsys.readouterr().out,
                          re.M))
    # LeNet's loss is TRAIN-only; CaffeNet's runs in both phases
    assert set(got) == set(want) == set(logged) == (
        {"accuracy"} if name == "mnist" else {"accuracy", "loss"})
    scores = cli.test_net(cli.parse_args(argv + ["-device", "cpu"]))
    for b in want:
        np.testing.assert_allclose(scores[b], logged[b], rtol=1e-5)
        np.testing.assert_allclose(float(got[b]), float(want[b]),
                                   rtol=1e-4)  # both printed at %.5g


def test_cli_train_from_an_lmdb_runs_tests_and_reports_the_feed(tmp_path):
    net = example_net(tmp_path, "mnist")
    solver = tmp_path / "solver.prototxt"
    solver.write_text(_solver_text(net))
    argv = ["train", "-solver", str(solver), "-max_iter", "3", "-device",
            "cpu", "-snapshot_prefix", str(tmp_path / "lenet")]
    trained, summary = cli.train(cli.parse_args(argv))
    assert summary["data"] == "dataset" and summary["device_transform"]
    assert summary["feed_ms_per_batch"] > 0
    assert summary["feed_threads"] == pfeeder.auto_threads()
    assert summary["iters"] == 3 and np.all(np.isfinite(summary["losses"]))
    assert set(summary["test_scores"][0]) == {"accuracy"}
    assert os.path.exists(str(tmp_path / "lenet_iter_3.caffemodel"))
    # what a supervisor reads of its child: the resume point, the state
    # paths written and K1-K5's launches (LeNet runs none on the CPU)
    assert summary["resumed_from"] is None
    assert summary["snapshots"] == [str(tmp_path /
                                        "lenet_iter_3.solverstate")]
    assert summary["kernel_launches"] == {f"K{i}": 0 for i in range(1, 6)}
    _, again = cli.train(cli.parse_args(argv[:4] + ["4"] + argv[5:]
                                        + ["-resume", "auto"]))
    assert again["resumed_from"] == summary["snapshots"][0]
    assert again["start_iter"] == 3 and again["iters"] == 1


def test_cli_train_without_a_data_layer_needs_synthetic(tmp_path):
    from test_torch_train import _write_solver
    solver = _write_solver(tmp_path)
    with pytest.raises(ValueError, match="no Data layer"):
        cli.train(cli.parse_args(["train", "-solver", str(solver),
                                  "-device", "cpu"]))


# -- the MAC model ------------------------------------------------------------

# nets with a layer type the port refuses (ROADMAP.md section 1 item 3)
UNBUILT = {"examples/hdf5_classification/nonlinear_train_val.prototxt"}


def _zoo():
    import glob
    nets = sorted(os.path.relpath(p, _ROOT) for d in ("models", "examples")
                  for p in glob.glob(os.path.join(_ROOT, d, "*", "*.prototxt"))
                  if "solver" not in os.path.basename(p))
    assert UNBUILT <= set(nets)
    return [n for n in nets if n not in UNBUILT]


@pytest.mark.parametrize("path", _zoo())
def test_mac_counts_equal_the_jax_packages(path):
    """Every models/* and examples/* net the port builds, in TRAIN, with
    the Data layers' record shapes given by a probe without a raw shape,
    so their transform stays on the host (no dataset or mean file
    opened)."""
    from caffe_mpi_tpu.data.feeder import ProbeShape as JaxProbe
    shape = next((v[1] for v in EXAMPLES.values() if v[0] == path),
                 (3, 32, 32))
    text = os.path.join(_ROOT, path)
    net = Net(NetParameter.from_file(text), "TRAIN", device="cpu",
              data_shape_probe=lambda lp: pfeeder.ProbeShape(
                  (shape[0], lp.transform_param.crop_size or shape[1],
                   lp.transform_param.crop_size or shape[2]), raw=None))
    jnet = JaxNet(JaxNP.from_file(text), "TRAIN", device_transform=False,
                  data_shape_probe=lambda lp: JaxProbe(
                      (shape[0], lp.transform_param.crop_size or shape[1],
                       lp.transform_param.crop_size or shape[2]), raw=shape))
    got = [flops.layer_macs_per_image(l) for l in net.layers]
    want = [jax_flops.layer_macs_per_image(l) for l in jnet.layers]
    assert got == want
    assert flops.net_macs_per_image(net) == jax_flops.net_macs_per_image(jnet)
    assert flops.train_flops_per_image(net) == \
        jax_flops.train_flops_per_image(jnet)
    assert all(isinstance(m, int) for m in got)


def test_card_rate_table_and_mfu_peaks():
    assert flops.card_rates("NVIDIA H100 80GB HBM3") == (3.35e12, 67e12,
                                                        989e12)
    assert flops.card_rates("NVIDIA H100 PCIe")[0] == 2.0e12
    assert flops.card_rates("cpu") is None
    assert flops.mfu_peak("NVIDIA H100 80GB HBM3", "default") == (
        494.5e12, "dense TF32")
    assert flops.mfu_peak("NVIDIA H100 80GB HBM3", "highest")[0] == 67e12
    assert flops.mfu_peak("NVIDIA H100 80GB HBM3", "default",
                          forward_bf16=True)[0] == 989e12


# -- time, device_query -------------------------------------------------------

def test_cli_time_on_the_cpu_prints_each_layer_and_the_whole_step(
        tmp_path, capsys):
    net = example_net(tmp_path, "mnist")
    assert cli.main(["time", "-model", net, "-iterations", "2", "-phase",
                     "TRAIN", "-device", "cpu", "-profile",
                     str(tmp_path / "prof")]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out.strip().splitlines()[-1])["time"]
    names = [l["name"] for l in summary["layers"]]
    assert names == ["conv1", "pool1", "conv2", "pool2", "ip1", "relu1",
                     "ip2", "loss"]
    for name in names:
        assert re.search(rf"^{name}\s", out, re.M), name
    assert "whole-net forward: " in out
    assert "whole-net forward+backward: " in out
    assert summary["forward_ms"] > 0 and summary["forward_backward_ms"] > 0
    assert summary["layers"][0]["bwd_ms"] > 0  # conv1: params and data
    assert summary["layers"][1]["bwd_ms"] is not None
    assert "MFU not measured (no peak rate for cpu)" in out
    assert os.path.exists(tmp_path / "prof" / "trace.json")
    jnet = JaxNet(JaxNP.from_file(net), "TRAIN")
    assert summary["train_gflops"] == pytest.approx(
        jax_flops.train_flops_per_image(jnet) * 8 / 1e9, rel=1e-12)


def test_device_query_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["device_query"])
    from caffe_mpi_tpu_torch.tools import device_query
    with pytest.raises(RuntimeError, match="is_available"):
        device_query.main([])


# -- convert_imageset, compute_image_mean -------------------------------------

def test_convert_imageset_and_compute_image_mean_match_jax(tmp_path):
    from PIL import Image

    from caffe_mpi_tpu.tools import compute_image_mean as jax_mean
    from caffe_mpi_tpu.tools import convert_imageset as jax_convert
    from caffe_mpi_tpu_torch.tools import compute_image_mean, convert_imageset
    imgs, labels = clusters(12, (3, 10, 14), seed=1)
    lines = []
    for i, (img, label) in enumerate(zip(imgs, labels)):
        name = f"im{i}.png"
        Image.fromarray(img[::-1].transpose(1, 2, 0)).save(tmp_path / name)
        lines.append(f"{name} {label}")
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    for flags in ([], ["-shuffle", "-resize_height", "8", "-resize_width",
                       "9"], ["-gray"]):
        for tool, tag in ((convert_imageset, "p"), (jax_convert, "j")):
            assert tool.main([*flags, str(tmp_path) + "/",
                              str(tmp_path / "list.txt"),
                              str(tmp_path / f"{tag}_db")]) == 0
        for f in ("data.mdb", "data.mdb.crc32c"):
            assert filecmp.cmp(tmp_path / "p_db" / f, tmp_path / "j_db" / f,
                               shallow=False), (flags, f)
        compute_image_mean.main([str(tmp_path / "j_db"),
                                 str(tmp_path / "p.binaryproto")])
        jax_mean.main([str(tmp_path / "p_db"),
                       str(tmp_path / "j.binaryproto")])
        assert filecmp.cmp(tmp_path / "p.binaryproto",
                           tmp_path / "j.binaryproto", shallow=False)
    ds = pds.LMDBDataset(str(tmp_path / "j_db"))
    assert len(ds) == 12 and ds.get(0)[0].shape == (1, 10, 14)
