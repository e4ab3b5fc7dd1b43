"""Port parity: the transformer path as a whole — models/transformer_lm
trained by the port's Solver against the JAX Solver, its synthetic feeds
against the JAX CLI's, and `train -synthetic -device cpu` through the
port's CLI.

The net is models/transformer_lm as `models/generate_models.py` writes it,
narrowed to batch 2, sequence 16, width 32, 2 heads, 2 blocks (an FFN
block and an MoE block of 4 experts, hidden 64), vocabulary 32, with
`use_flash: true` after each `causal: true` as the JAX package's own tests
switch it on. The JAX side runs the Pallas kernels in interpret mode; the
port's side their plain versions.

Tolerances: losses rtol 1e-5; every parameter and both Adam slots rtol
1e-5 / atol 1e-6 (measured ~1e-6 of each parameter's largest element
after 5 steps: the JAX Adam forms its bias correction in f32); test
scores rtol 1e-5.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.net import Net as JaxNet
from caffe_mpi_tpu.proto import NetParameter as JaxNP
from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu.tools.cli import _synthetic_feed as jax_synthetic_feed
from caffe_mpi_tpu_torch.net import Net
from caffe_mpi_tpu_torch.ops import flash_attention as pf
from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
from caffe_mpi_tpu_torch.solver import Solver
from caffe_mpi_tpu_torch.tools import cli
from caffe_mpi_tpu_torch.weights import load_jax_opt_state, load_jax_params

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "models"))
from generate_models import transformer_lm  # noqa: E402

B, S, V = 2, 16, 32
STEP = dict(rtol=1e-5, atol=1e-6)
SOLVER = ('base_lr: 0.001 momentum: 0.9 momentum2: 0.999 type: "Adam" '
          'lr_policy: "fixed" max_iter: 5 display: 0 random_seed: 3 '
          'test_iter: 1 test_interval: 100')


def narrow_net(use_flash=True) -> str:
    text = transformer_lm(batch=B, seq=S, vocab=V, dim=32, heads=2,
                          n_blocks=2, ffn_hidden=64,
                          moe_experts=4).to_prototxt()
    if use_flash:
        text = text.replace("causal: true", "causal: true\n    use_flash: true")
    return text


def _solvers(text):
    jsp = JaxSP.from_text(SOLVER)
    jsp.net_param = JaxNP.from_text(text)
    sp = SolverParameter.from_text(SOLVER)
    sp.net_param = NetParameter.from_text(text)
    return JaxSolver(jsp), Solver(sp, device="cpu")


def _feeds(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"tokens": rs.randint(0, V, (B, S)),
             "label": rs.randint(0, V, (B, S))} for _ in range(n)]


def _torch_feeds(feeds):
    return lambda k: {key: torch.from_numpy(v) for key, v in
                      feeds[k].items()}


@pytest.fixture(scope="module")
def five_steps():
    """5 Adam iterations of both Solvers from the JAX weights and the same
    token feeds."""
    jsolver, port = _solvers(narrow_net())
    load_jax_params(port.net, jax.tree_util.tree_map(np.asarray,
                                                     jsolver.params))
    feeds = _feeds(5)
    jlosses = [jsolver.step(1, lambda k, i=i: feeds[i]) for i in range(5)]
    port.step(5, _torch_feeds(feeds))
    return jsolver, port, jlosses


def test_the_narrow_net_is_the_transformer_with_flash_attention():
    net = Net(NetParameter.from_text(narrow_net()), "TRAIN", device="cpu")
    types = [l.lp.type for l in net.layers]
    assert {"Embed", "Parameter", "Bias", "LayerNorm", "Attention",
            "Eltwise", "InnerProduct", "ReLU", "MoE",
            "SoftmaxWithLoss"} <= set(types)
    attn = [l for l in net.layers if l.lp.type == "Attention"]
    assert len(attn) == 2 and all(l.p.use_flash and l.p.causal
                                  for l in attn)
    # the aux top adds to the loss at 0.01, the MoE output at none
    assert ("blk1/moe_aux", 0.01) in net.loss_blobs
    assert not [b for b, _ in net.loss_blobs if b == "blk1/moe"]


def test_five_adam_iterations_match_the_jax_solver(five_steps):
    jsolver, port, jlosses = five_steps
    assert port.iter == jsolver.iter == 5
    np.testing.assert_allclose(port.losses, jlosses, rtol=1e-5)
    for lname, blobs in jsolver.params.items():
        for pname, arr in blobs.items():
            got = getattr(port.net.layer_by_name(lname), pname)
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(arr),
                                       err_msg=f"{lname}.{pname}", **STEP)
    for lname, blobs in jsolver.opt_state.items():
        for pname, slots in blobs.items():
            assert len(slots) == 2
            for i, s in enumerate(slots):
                np.testing.assert_allclose(
                    port.history[(lname, pname)][i].numpy(), np.asarray(s),
                    err_msg=f"{lname}.{pname} slot {i}", **STEP)


def test_every_parameter_trained(five_steps):
    """Each param moved from its start: qkv_weight only learns through the
    flash backward, the gate through the gate weights and the aux term."""
    jsolver, port, _ = five_steps
    fresh = JaxSolver(jsolver.sp)
    for lname, pname, _, p in port._decls:
        start = np.asarray(fresh.params[lname][pname])
        assert not np.array_equal(p.detach().numpy(), start), \
            f"{lname}.{pname} did not move"


def test_test_net_scores_like_jax(five_steps):
    jsolver, port, _ = five_steps
    test_feeds = _feeds(1, seed=9)
    want = jsolver.test_all([lambda k: test_feeds[k]])[0]
    got = port.test_all([_torch_feeds(test_feeds)])[0]
    assert set(got) == set(want) == {"loss", "accuracy", "blk1/moe_aux"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)


def test_resume_from_the_jax_adam_state_continues_like_jax(five_steps):
    jsolver, _, _ = five_steps
    port = Solver(five_steps[1].sp, device="cpu")
    host = jax.tree_util.tree_map(np.asarray, jsolver.params)
    load_jax_params(port.net, host)
    load_jax_opt_state(port, jax.tree_util.tree_map(np.asarray,
                                                    jsolver.opt_state))
    port.iter = jsolver.iter
    twin = JaxSolver(jsolver.sp)
    twin.params, twin.opt_state, twin.iter = jsolver.params, \
        jsolver.opt_state, jsolver.iter
    feeds = _feeds(1, seed=4)
    want = twin.step(1, lambda k: feeds[0])
    port.step(1, lambda k: _torch_feeds(feeds)(0))
    np.testing.assert_allclose(port.losses[-1], want, rtol=1e-5)


def test_flash_and_plain_attention_train_alike():
    """The same net with and without use_flash in the port: the flash
    path (the kernels' plain versions here) gives the plain attention's
    losses and weights."""
    runs = []
    for flash in (True, False):
        sp = SolverParameter.from_text(SOLVER)
        sp.net_param = NetParameter.from_text(narrow_net(flash))
        port = Solver(sp, device="cpu")
        port.step(3, _torch_feeds(_feeds(3, seed=2)))
        runs.append(port)
    np.testing.assert_allclose(runs[0].losses, runs[1].losses, rtol=1e-5)
    w = [r.net.layer_by_name("blk0/attn").qkv_weight.detach() for r in runs]
    torch.testing.assert_close(w[0], w[1], rtol=1e-5, atol=1e-6)


def test_cpu_training_launches_no_kernel(five_steps):
    counts = (pf.flash_fwd.launches, pf.flash_bwd_dq.launches,
              pf.flash_bwd_dkv.launches)
    assert counts == (0, 0, 0)


def test_params_and_blob_order_are_the_jax_packages():
    jnet = JaxNet(JaxNP.from_text(narrow_net()), phase="TRAIN")
    net = Net(NetParameter.from_text(narrow_net()), "TRAIN", device="cpu")
    for jl in jnet.layers:
        pl = net.layer_by_name(jl.name)
        assert list(pl.decls) == list(jl.params), jl.name
        assert pl.caffe_blobs() == jl.caffe_blobs(), jl.name
        for name, decl in jl.params.items():
            assert tuple(pl.decls[name].shape) == tuple(decl.shape)
    assert net.blob_shapes["logits"] == jnet.blob_shapes["logits"] \
        == (B, S, V)


# -- synthetic feeds and the CLI ----------------------------------------------

@pytest.mark.parametrize("phase,seed", [("TRAIN", 0), ("TEST", 1)])
def test_synthetic_feed_of_transformer_lm_is_the_jax_clis(phase, seed):
    """models/transformer_lm at full size: token ids in [0, 256) for the
    blob the Embed eats, class ids in [0, 10) for the label, array for
    array equal to the JAX CLI's draw."""
    path = os.path.join(_ROOT, "models", "transformer_lm",
                        "train_val.prototxt")
    jnet = JaxNet(JaxNP.from_file(path), phase=phase)
    net = Net(NetParameter.from_file(path), phase, device="cpu")
    want = jax_synthetic_feed(jnet, seed=seed)
    got = cli.synthetic_feed(net, seed=seed)
    assert list(got) == list(want) == ["tokens", "label"]
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert got["tokens"].dtype == torch.int64
    assert int(got["tokens"].max()) >= 10 and int(got["tokens"].max()) < 256
    assert int(got["label"].max()) < 10


def _write_solver(tmp_path):
    net = tmp_path / "train_val.prototxt"
    net.write_text(narrow_net())
    solver = tmp_path / "solver.prototxt"
    solver.write_text(
        f'net: "{net}"\ntest_iter: 1\ntest_interval: 1000\n'
        'test_initialization: false\nbase_lr: 0.001\nlr_policy: "fixed"\n'
        'display: 1\nmax_iter: 10000\nmomentum: 0.9\nmomentum2: 0.999\n'
        'type: "Adam"\nsnapshot: 10000\n')
    return solver


def test_cli_feeds_the_narrow_solver_as_the_jax_cli_does(tmp_path):
    solver = _write_solver(tmp_path)
    jsolver = JaxSolver(JaxSP.from_file(str(solver)))
    port = Solver(SolverParameter.from_file(str(solver)), device="cpu")
    for jnet, net, seed in ((jsolver.net, port.net, 0),
                            (jsolver.test_nets[0], port.test_nets[0], 1)):
        want = jax_synthetic_feed(jnet, seed=seed)
        got = cli.synthetic_feed(net, seed=seed)
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


def test_cli_train_on_the_cpu_trains_and_resumes(tmp_path):
    solver = _write_solver(tmp_path)
    prefix = str(tmp_path / "snap" / "lm")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "caffe_mpi_tpu_torch.tools.cli", "train",
         "-solver", str(solver), "-synthetic", "-max_iter", "3",
         "-snapshot_prefix", prefix, "-device", "cpu"],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = [l for l in proc.stdout.splitlines() if l.startswith('{"train"')]
    summary = json.loads(line[-1])["train"]
    assert summary["iters"] == 3 and summary["batch"] == B
    assert np.all(np.isfinite(summary["losses"]))
    assert set(summary["test_scores"][0]) == {"loss", "accuracy",
                                              "blk1/moe_aux"}
    args = cli.parse_args(["train", "-solver", str(solver), "-synthetic",
                           "-max_iter", "4", "-snapshot", summary["snapshot"],
                           "-snapshot_prefix", prefix, "-device", "cpu"])
    resumed, again = cli.train(args)
    assert again["start_iter"] == 3 and again["iters"] == 1
    # the snapshot's weights and Adam slots came back
    check = Solver(resumed.sp, model_dir=resumed.model_dir, device="cpu")
    check.restore(summary["snapshot"])
    assert check.iter == 3
    assert all(len(h) == 2 for h in check.history.values())
