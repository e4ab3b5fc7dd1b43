"""The port's tools that ride the static engine or the prototxt alone —
summarize, draw/draw_net, the upgrade tools, parse_log and
plot_training_log, the timers and the deprecation shims — held against
the JAX package's on the same files.

Tolerances: none. summarize's stdout and the DOT text are text-equal, the
upgrade tools' outputs bytes-equal and parse_log's CSVs bytes-equal, since
the same Python formatting runs over the same engine records and log
lines on both sides.
"""

import logging
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from caffe_mpi_tpu import draw as jdraw
from caffe_mpi_tpu import io as jio
from caffe_mpi_tpu.proto import NetParameter as JaxNP
from caffe_mpi_tpu.tools import draw_net as jdraw_net
from caffe_mpi_tpu.tools import parse_log as jparse_log
from caffe_mpi_tpu.tools import summarize as jsummarize
from caffe_mpi_tpu.tools import upgrade_net_proto_binary as jup_bin
from caffe_mpi_tpu.tools import upgrade_net_proto_text as jup_text
from caffe_mpi_tpu.tools import upgrade_solver_proto_text as jup_solver
from caffe_mpi_tpu_torch import draw
from caffe_mpi_tpu_torch.proto import NetParameter
from caffe_mpi_tpu_torch.tools import (draw_net, parse_log,
                                       plot_training_log, summarize,
                                       upgrade_net_proto_binary,
                                       upgrade_net_proto_text,
                                       upgrade_solver_proto_text)
from caffe_mpi_tpu_torch.utils.timers import CPUTimer, Timer
from test_torch_netshape import zoo_nets

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_main(main, argv, capsys) -> tuple[int, str, str]:
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


# -- summarize ----------------------------------------------------------------

@pytest.mark.parametrize("path", zoo_nets())
def test_summarize_prints_what_the_jax_tool_prints(path, capsys):
    for phase in ("TRAIN", "TEST"):
        argv = [os.path.join(_ROOT, path), "-phase", phase]
        assert run_main(summarize.main, argv, capsys) == \
            run_main(jsummarize.main, argv, capsys), phase


def test_summarize_totals_alexnet_and_exits_1_on_problems(tmp_path,
                                                          capsys):
    rc, out, _ = run_main(summarize.main, [
        os.path.join(_ROOT, "models/alexnet/train_val.prototxt")], capsys)
    assert rc == 0 and "60,965,224 params" in out
    assert "MMACs/img" in out and "bwd MiB" in out
    bad = tmp_path / "bad.prototxt"
    bad.write_text("""
    layer { name: "in" type: "Input" top: "data"
            input_param { shape { dim: 8 dim: 3 dim: 8 dim: 8 } } }
    layer { name: "pool" type: "Pooling" bottom: "data" top: "pool"
            pooling_param { pool: MAX kernel_size: 2 stride: 2 pad: 2 } }
    """)
    rc, _, err = run_main(summarize.main, [str(bad)], capsys)
    assert rc == 1 and "!! pool: [shape]" in err


def test_summarize_runs_without_torch_or_jax():
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "sys.modules['torch'] = sys.modules['jax'] = None\n"
         "from caffe_mpi_tpu_torch.tools.summarize import main\n"
         "raise SystemExit(main(['models/alexnet/train_val.prototxt']))"],
        cwd=_ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=_ROOT))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "60,965,224 params" in r.stdout


# -- draw ---------------------------------------------------------------------

@pytest.mark.parametrize("path", zoo_nets())
def test_the_dot_text_equals_the_jax_text(path):
    text = os.path.join(_ROOT, path)
    for rankdir in ("TB", "LR"):
        for phase in (None, "TRAIN", "TEST"):
            assert draw.net_to_dot(NetParameter.from_file(text), rankdir,
                                   phase) == \
                jdraw.net_to_dot(JaxNP.from_file(text), rankdir, phase)


def test_draw_net_writes_dot_and_renders_where_graphviz_is(tmp_path,
                                                           capsys):
    net = os.path.join(_ROOT, "models/googlenet/train_val.prototxt")
    for tool, out in ((draw_net, "port.dot"), (jdraw_net, "jax.dot")):
        assert tool.main([net, str(tmp_path / out), "--rankdir", "LR",
                          "--phase", "TEST"]) == 0
    assert (tmp_path / "port.dot").read_bytes() == \
        (tmp_path / "jax.dot").read_bytes()
    assert (tmp_path / "port.dot").read_text().startswith(
        "digraph caffe_net {")
    png = tmp_path / "net.png"
    if shutil.which("dot") is None:
        with pytest.raises(RuntimeError, match="graphviz 'dot' binary"):
            draw_net.main([net, str(png)])
    else:
        assert draw_net.main([net, str(png)]) == 0
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# -- the upgrade tools --------------------------------------------------------

V1_NET = """name: "v1"
input: "data"
input_dim: 1 input_dim: 3 input_dim: 8 input_dim: 8
layers { name: "conv" type: CONVOLUTION bottom: "data" top: "conv"
         blobs_lr: 1 blobs_lr: 2 weight_decay: 1 weight_decay: 0
         convolution_param { num_output: 4 kernel_size: 3 } }
layers { name: "relu" type: RELU bottom: "conv" top: "conv" }
layers { name: "pool" type: POOLING bottom: "conv" top: "pool"
         pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
"""
V0_NET = """name: "v0net"
input: "data"
input_dim: 2 input_dim: 3 input_dim: 8 input_dim: 8
layers {
  layer {
    name: "conv1" type: "conv" num_output: 4 kernelsize: 3 pad: 1
    weight_filler { type: "gaussian" std: 0.1 }
    blobs_lr: 1. blobs_lr: 2. weight_decay: 1. weight_decay: 0.
  }
  bottom: "data" top: "conv1"
}
layers { layer { name: "relu1" type: "relu" } bottom: "conv1" top: "conv1" }
layers {
  layer { name: "pool1" type: "pool" kernelsize: 2 stride: 2 pool: AVE }
  bottom: "conv1" top: "pool1"
}
"""
SOLVERS = {
    "nesterov": 'net: "train.prototxt"\nbase_lr: 0.01\n'
                "solver_type: NESTEROV\n",
    "modern": 'net: "train.prototxt"\nbase_lr: 0.01\ntype: "Adam"\n',
    "inline_net": "base_lr: 0.1\nsolver_type: ADAGRAD\nnet_param { "
                  + V1_NET.replace("\n", " ").replace('name: "v1"', "")
                  + " }\n",
}


def _text_cases():
    cases = {"v1": V1_NET, "v0": V0_NET}
    for path in zoo_nets()[::4]:
        with open(os.path.join(_ROOT, path)) as f:
            cases[path] = f.read()
    return cases


@pytest.mark.parametrize("name", sorted(_text_cases()))
def test_upgrade_net_proto_text_writes_the_jax_bytes(tmp_path, name,
                                                     capsys):
    src = tmp_path / "in.prototxt"
    src.write_text(_text_cases()[name])
    for tool, out in ((upgrade_net_proto_text, "port"),
                      (jup_text, "jax")):
        assert tool.main([str(src), str(tmp_path / out)]) == 0
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    assert "layers {" not in (tmp_path / "port").read_text()


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_upgrade_solver_proto_text_writes_the_jax_bytes(tmp_path, name):
    src = tmp_path / "in.prototxt"
    src.write_text(SOLVERS[name])
    for tool, out in ((upgrade_solver_proto_text, "port"),
                      (jup_solver, "jax")):
        assert tool.main([str(src), str(tmp_path / out)]) == 0
    got = (tmp_path / "port").read_bytes()
    assert got == (tmp_path / "jax").read_bytes()
    assert b"solver_type" not in got
    assert upgrade_net_proto_text.main(
        ["-solver", str(src), str(tmp_path / "again")]) == 0
    assert (tmp_path / "again").read_bytes() == got


def test_upgrade_net_proto_binary_writes_the_jax_bytes(tmp_path, capsys):
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = np.linspace(-1, 1, 3).astype(np.float32)
    blob_w, blob_b = jio.encode_blob(w), jio.encode_blob(b)
    # V1 encoding: layers (field 2) { name=4, blobs=6 }
    v1 = (jio._tag(4, 2) + jio._varint(2) + b"ip"
          + jio._tag(6, 2) + jio._varint(len(blob_w)) + blob_w
          + jio._tag(6, 2) + jio._varint(len(blob_b)) + blob_b)
    legacy = tmp_path / "v1.caffemodel"
    legacy.write_bytes(jio._tag(2, 2) + jio._varint(len(v1)) + bytes(v1))
    modern = tmp_path / "v2.caffemodel"
    jio.save_caffemodel(str(modern), {"conv": [w.reshape(3, 1, 2, 2), b],
                                      "fc": [w]})
    for src in (legacy, modern):
        for tool, out in ((upgrade_net_proto_binary, "port"),
                          (jup_bin, "jax")):
            assert tool.main([str(src), str(tmp_path / out)]) == 0
        assert (tmp_path / "port").read_bytes() == \
            (tmp_path / "jax").read_bytes()
    fields = {f for f, _, _ in jio._fields((tmp_path / "port").read_bytes())}
    assert 100 in fields and 2 not in fields
    empty = tmp_path / "empty.caffemodel"
    empty.write_bytes(b"")
    assert upgrade_net_proto_binary.main([str(empty), str(tmp_path / "x")]) \
        == jup_bin.main([str(empty), str(tmp_path / "y")]) == 1


# -- parse_log, plot_training_log ---------------------------------------------

@pytest.fixture(scope="module")
def lenet_log(tmp_path_factory):
    """The log of a LeNet CPU training run of the port (4 iterations of a
    narrow LeNet from an LMDB, display 1, a test pass every 2), written
    with the CLI's log format."""
    from caffe_mpi_tpu_torch.tools import cli
    from test_torch_cli_tools import example_net
    tmp = tmp_path_factory.mktemp("lenet_log")
    net = example_net(tmp, "mnist")
    solver = tmp / "solver.prototxt"
    solver.write_text(
        f'net: "{net}"\ntest_iter: 2\ntest_interval: 2\ndisplay: 1\n'
        'base_lr: 0.01\nmomentum: 0.9\nlr_policy: "inv"\ngamma: 0.0001\n'
        'power: 0.75\nmax_iter: 4\nrandom_seed: 3\n')
    path = tmp / "train.log"
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(message)s"))
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        cli.train(cli.parse_args(
            ["train", "-solver", str(solver), "-device", "cpu",
             "-snapshot_prefix", str(tmp / "lenet")]))
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
        handler.close()
    return path


def test_parse_log_reads_the_port_solver_as_the_jax_tool(lenet_log,
                                                          tmp_path, capsys):
    train, test = parse_log.parse(str(lenet_log))
    assert (train, test) == jparse_log.parse(str(lenet_log))
    # every iteration is a train row; the passes at 0, 2 and 4 are
    # harvested (and logged) at the next test boundary or the end of the
    # run, as in the JAX solver, so a test row carries the last train
    # line's iteration before it (the "Test net #0, iteration I:" header
    # names the iteration tested)
    assert [r["NumIters"] for r in train] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["LearningRate"] > 0
               for r in train)
    assert [r["NumIters"] for r in test] == [1, 3, 3]
    assert all(set(r) == {"NumIters", "TestNet", "accuracy"} for r in test)
    for tool, out in ((parse_log, "port"), (jparse_log, "jax")):
        (tmp_path / out).mkdir()
        assert tool.main([str(lenet_log), str(tmp_path / out)]) == 0
    for ext in (".train", ".test"):
        name = lenet_log.name + ext
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


def test_plot_training_log_writes_a_png(lenet_log, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    png = tmp_path / "curves.png"
    assert plot_training_log.main([str(png), str(lenet_log)]) == 0
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# -- the timers, the shims ----------------------------------------------------

def test_the_cpu_timer_reads_the_host_clock():
    for timer in (Timer(), Timer("cpu"), CPUTimer()):
        assert timer.stop() == 0.0 and not timer.running
        t0 = time.perf_counter()
        timer.start()
        time.sleep(0.02)
        mid = timer.seconds()
        assert timer.running and mid >= 0.02
        first = timer.stop()
        assert 0.02 <= first <= time.perf_counter() - t0
        timer.start()
        time.sleep(0.01)
        assert timer.stop() >= first + 0.01  # spans accumulate
        assert timer.milliseconds() == timer.seconds() * 1e3
        timer.reset()
        assert timer.seconds() == 0.0


@pytest.mark.parametrize("name,command", [
    ("train_net", "train"), ("test_net", "test"),
    ("finetune_net", "train -weights"), ("net_speed_benchmark", "time")])
def test_the_deprecated_tools_name_the_port_cli_and_exit_1(name, command,
                                                           capsys):
    import importlib
    mod = importlib.import_module(f"caffe_mpi_tpu_torch.tools.{name}")
    assert mod.main([]) == 1
    err = capsys.readouterr().err
    assert err.startswith(f"{name} is deprecated")
    assert f"python -m caffe_mpi_tpu_torch.tools.cli {command} ..." in err
