"""Port parity: `test_chunk`, the test pass in chunks of T batches, against
the JAX package's fused evaluation, on the CPU.

Counterparts of the JAX tests/test_fused_eval.py TestBitwiseEquivalence
and TestChunkSizing, on its classification net (one inner product, an
Accuracy in TEST, a second test net with a loss and an Accuracy). Held:
the port's scores at test_chunk 1, 3 and auto are bitwise equal (a chunk
only changes when feeds are fetched, not the order of the sums); they
match the JAX Solver's `test_all` from the same weights within rtol 1e-5
(float32 sums in another library); two test nets with different
test_iter; `_test_chunk_len` equals the JAX rule over a grid of feed
sizes, budgets and pinned values; one host read a test net a pass, and
ceil(test_iter / T) chunks.
"""

import math

import numpy as np
import pytest
import torch

from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.proto.config import NetParameter as JaxNP
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
from caffe_mpi_tpu_torch.solver import Solver
from caffe_mpi_tpu_torch.tools import cli
from caffe_mpi_tpu_torch.weights import load_jax_params

CLS_NET = """
name: "cls"
layer { name: "in" type: "Input" top: "x" top: "t"
        input_param { shape { dim: 8 dim: 6 } shape { dim: 8 } } }
layer { name: "ip" type: "InnerProduct" bottom: "x" top: "y"
        inner_product_param { num_output: 3
          weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "y" bottom: "t"
        top: "l" include { phase: TRAIN } }
layer { name: "acc" type: "Accuracy" bottom: "y" bottom: "t"
        top: "acc" include { phase: TEST } }
"""
# the second topology: a loss and an accuracy in the TEST phase
CLS_NET_LOSS_ACC = CLS_NET.replace(
    'top: "l" include { phase: TRAIN } }', 'top: "l" }')
BASE = ('base_lr: 0.2 lr_policy: "fixed" max_iter: 1000 type: "SGD" '
        'momentum: 0.9 display: 0 random_seed: 11 ')


def cls_feed(seed_base=0, batch=8):
    """Separable clusters, a pure function of the batch index."""
    templates = np.random.RandomState(99).randn(3, 6).astype(np.float32)

    def feed(it):
        r = np.random.RandomState(seed_base + it)
        t = r.randint(0, 3, batch)
        x = templates[t] + 0.1 * r.randn(batch, 6).astype(np.float32)
        return {"x": np.asarray(x, np.float32), "t": t.astype(np.int32)}
    return feed


def torch_feed(feed):
    return lambda it: {k: torch.from_numpy(v) for k, v in feed(it).items()}


def solvers(extra="", test_nets=None, net=CLS_NET):
    """The JAX Solver after 3 iterations, and the port's with its weights."""
    jsp = JaxSP.from_text(BASE + extra)
    jsp.net_param = JaxNP.from_text(net)
    psp = SolverParameter.from_text(BASE + extra)
    psp.net_param = NetParameter.from_text(net)
    if test_nets is not None:
        jsp.test_net_param = [JaxNP.from_text(t) for t in test_nets]
        psp.test_net_param = [NetParameter.from_text(t) for t in test_nets]
    jsolver = JaxSolver(jsp)
    jsolver.step(3, cls_feed(0))
    port = Solver(psp, device="cpu")
    load_jax_params(port.net, {k: {p: np.asarray(v) for p, v in b.items()}
                               for k, b in jsolver.params.items()})
    return jsolver, port


@pytest.mark.parametrize("iters", [4, 7])
def test_scores_bitwise_across_chunk_lengths_and_like_jax(iters):
    test = cls_feed(5000)
    jsolver, _ = solvers(f"test_iter: {iters}")
    want = jsolver.test_all([test])[0]
    got = {}
    for chunk in (1, 3, 0):
        _, port = solvers(f"test_iter: {iters} test_chunk: {chunk}")
        d0, r0 = port.test_dispatch_count, port.test_host_reads
        got[chunk] = port.test_all([torch_feed(test)])[0]
        t = port._test_chunk_len(port.test_nets[0], iters)
        assert t == (chunk if chunk else iters)
        assert port.test_dispatch_count - d0 == math.ceil(iters / t)
        assert port.test_host_reads - r0 == 1  # one host read a pass
    assert got[1] == got[3] == got[0]  # bitwise: dicts of exact floats
    assert set(got[1]) == set(want) == {"acc"}
    np.testing.assert_allclose(got[1]["acc"], want["acc"], rtol=1e-5)


def test_two_test_nets_with_different_test_iter():
    feeds = [cls_feed(5000), cls_feed(6000)]
    extra = "test_iter: 3 test_iter: 5 test_chunk: 2"
    jsolver, port = solvers(extra, test_nets=[CLS_NET, CLS_NET_LOSS_ACC])
    want = jsolver.test_all(feeds)
    _, whole = solvers("test_iter: 3 test_iter: 5 test_chunk: 5",
                       test_nets=[CLS_NET, CLS_NET_LOSS_ACC])
    d0, r0, p0 = (port.test_dispatch_count, port.test_host_reads,
                  port.test_pass_count)
    got = port.test_all([torch_feed(f) for f in feeds])
    assert got == whole.test_all([torch_feed(f) for f in feeds])
    assert set(got[1]) == set(want[1]) == {"l", "acc"}
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5)
    # net 0: ceil(3/2) = 2 chunks, net 1: ceil(5/2) = 3; a read each
    assert port.test_dispatch_count - d0 == 5
    assert port.test_host_reads - r0 == 2
    assert port.test_pass_count - p0 == 2


def test_degenerate_test_net():
    _, port = solvers("test_iter: 0")
    assert port.test_all([torch_feed(cls_feed(1))]) == [{}]


def _net(shape):
    dims = " ".join(f"dim: {d}" for d in shape)
    return CLS_NET.replace("shape { dim: 8 dim: 6 } shape { dim: 8 }",
                           f"shape {{ {dims} }} shape {{ dim: {shape[0]} }}")


@pytest.mark.parametrize("shape", [(8, 6), (2, 3, 16, 16), (64, 3, 32, 32)])
def test_chunk_length_rule_equals_the_jax_rule(shape):
    extra = "test_iter: 50 "
    for chunk in (0, 4):
        jsp = JaxSP.from_text(BASE + extra + f"test_chunk: {chunk}")
        jsp.net_param = JaxNP.from_text(_net(shape))
        psp = SolverParameter.from_text(BASE + extra + f"test_chunk: {chunk}")
        psp.net_param = NetParameter.from_text(_net(shape))
        jsolver, port = JaxSolver(jsp), Solver(psp, device="cpu")
        for budget in (500, 1 << 20, 256 << 20):
            jsolver._TEST_SUPER_BATCH_BYTES = budget
            port._TEST_SUPER_BATCH_BYTES = budget
            for iters in (1, 2, 7, 50, 500):
                assert port._test_chunk_len(port.test_nets[0], iters) == \
                    jsolver._test_chunk_len(jsolver.test_nets[0], iters), \
                    (chunk, budget, iters)


def test_cli_test_chunk_flag_reaches_the_solver(tmp_path):
    net = tmp_path / "net.prototxt"
    # the synthetic feed draws class ids in [0, 10)
    net.write_text(CLS_NET.replace("num_output: 3", "num_output: 10"))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net}"\n' + BASE.replace("max_iter: 1000",
                                                       "max_iter: 2")
                      + "test_iter: 5 test_interval: 100\n")
    solver_obj, summary = cli.train(cli.parse_args(
        ["train", "-solver", str(solver), "-synthetic", "-test_chunk", "2",
         "-device", "cpu"]))
    assert solver_obj.sp.test_chunk == 2
    # passes at iteration 0 (test_initialization) and after the last:
    # ceil(5 / 2) chunks and one host read each
    assert summary["test_dispatch_count"] == 6
    assert summary["test_host_reads"] == 2
    assert set(summary["test_scores"][0]) == {"acc"}
