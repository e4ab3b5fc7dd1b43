"""Port parity: ring sequence parallelism (caffe_mpi_tpu_torch/ops/
attention.py `ring_attention`, `ring_flash_attention`,
`sequence_parallel_attention`) over 2 and 4 model ranks against the JAX
package's `sequence_parallel_attention` on a (1, n) mesh of the virtual
CPU devices (its flash ring in interpret mode) and against single-device
attention.

The port's ranks are gloo processes on the CPU (tests/torch_dp_worker.py
"ring" scenarios): each gets the global q, k, v and the upstream
gradient, runs the ring on its sequence shard and returns the gathered
output and the q, k, v gradients of sum(out * dy). The flash ring's
blocks take the flash kernels' plain versions on the CPU; each rank
counts its flash_block (K3 on the card) and flash_block_bwd (K4 and K5)
calls against `ring_flash_launches`, the count `_block_pred` gives.

Every case is held against one-device attention. The JAX references
compile a shard_map and its vjp each (10-20 s on the CPU), so a subset
is held against JAX: at 2 ranks the plain ring causal and padded and the
flash ring causal and padded, at 4 ranks the flash ring unmasked and
padded (`JAX_CASES`).

Tolerances, float32: output and gradients rtol 1e-5, atol 1e-5 of the
largest element (the ring merges blocks in another order than one
device's softmax, and XLA sums in its own order).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.ops.attention import \
    sequence_parallel_attention as jax_spa
from caffe_mpi_tpu.parallel import MeshPlan as JaxMeshPlan
from caffe_mpi_tpu_torch.ops.attention import (attention,
                                               ring_flash_launches)
from torch_dp_worker import Ranks

B, H, D = 2, 2, 4
# (name, S, causal, flash); S 9 and 10 do not divide the ring: padded
CASES = [("plain", 12, False, False), ("plain_causal", 12, True, False),
         ("flash", 12, False, True), ("flash_causal", 12, True, True),
         ("plain_pad", 10, True, False), ("flash_pad", 9, True, True),
         ("flash_pad_full", 10, False, True)]


def _inputs(s, seed):
    r = np.random.RandomState(seed)
    return [r.randn(B, s, H, D).astype(np.float32) for _ in range(4)]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


# the cases also held against the JAX package, by ring size
JAX_CASES = {2: ("plain_pad", "flash_pad"), 4: ("flash_pad_full",)}


def _jax_ref(n, q, k, v, dy, causal, flash):
    mesh = JaxMeshPlan.from_shape(1, n, devices=jax.devices()[:n]).mesh

    def f(q, k, v):
        return jax_spa(q, k, v, mesh, seq_axis="model", causal=causal,
                       use_flash=flash, flash_interpret=True)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _one_device(q, k, v, dy, causal):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = attention(*ts, causal=causal)
    (out * torch.from_numpy(dy)).sum().backward()
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


def _scenarios():
    scs = []
    for i, (name, s, causal, flash) in enumerate(CASES):
        q, k, v, dy = _inputs(s, i)
        scs.append(dict(kind="ring", name=name, q=q, k=k, v=v, dy=dy,
                        causal=causal, flash=flash))
    return scs


@pytest.fixture(scope="module")
def spawns(tmp_path_factory):
    """Both ring sizes' ranks start at once; the references are computed
    while they run. {n: (results, {case: (JAX's or None, one device's)})}"""
    scs = _scenarios()
    ranks = {n: Ranks({"mesh": (1, n), "scenarios": scs}, n,
                      str(tmp_path_factory.mktemp(f"ring{n}")))
             for n in (2, 4)}
    one = {sc["name"]: _one_device(sc["q"], sc["k"], sc["v"], sc["dy"],
                                   sc["causal"]) for sc in scs}
    by_name = {sc["name"]: sc for sc in scs}
    jobs = [(n, c) for n, cs in JAX_CASES.items() for c in cs]
    # the traces and compiles overlap a little in threads
    with ThreadPoolExecutor(len(jobs)) as ex:
        done = dict(zip(jobs, ex.map(lambda job: _jax_ref(
            job[0], *(by_name[job[1]][k] for k in ("q", "k", "v", "dy",
                                                   "causal", "flash"))),
            jobs)))
    return {n: (n, r.results(),
                {c: (done.get((n, c)), one[c]) for c in by_name})
            for n, r in ranks.items()}


@pytest.fixture(params=[2, 4], ids=["N2", "N4"])
def spawn(request, spawns):
    return spawns[request.param]


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_ring_matches_one_device(spawn, case):
    n, results, refs = spawn
    _, one = refs[case]
    for r, res in enumerate(results):
        got = res[case]
        for i, key in enumerate(("out", "dq", "dk", "dv")):
            _close(got[key], one[i], f"rank {r} {key} vs one device")


@pytest.mark.parametrize("n,case", [(n, c) for n, cs in JAX_CASES.items()
                                    for c in cs])
def test_ring_matches_jax_sequence_parallel_attention(spawns, n, case):
    _, results, refs = spawns[n]
    jax_ref, _ = refs[case]
    for r, res in enumerate(results):
        for i, key in enumerate(("out", "dq", "dk", "dv")):
            _close(res[case][key], jax_ref[i], f"rank {r} {key} vs JAX")


@pytest.mark.parametrize("case", [c[0] for c in CASES if c[3]])
def test_flash_ring_runs_the_blocks_block_pred_predicts(spawn, case):
    """Each rank's flash_block calls (K3 on the card) and flash_block_bwd
    calls (K4 and K5) equal ring_flash_launches: causal rank m runs m + 1
    blocks; a shard all padding is skipped."""
    n, results, _ = spawn
    _, s, causal, _ = next(c for c in CASES if c[0] == case)
    s_pad = -(-s // n) * n
    want = ring_flash_launches(n, causal, s_pad // n,
                               s if s_pad != s else None)
    for m, res in enumerate(results):
        assert res[case]["blocks"] == {"flash_block": want[m],
                                       "flash_block_bwd": want[m]}
    assert all(res[c[0]]["blocks"] == {"flash_block": 0,
                                       "flash_block_bwd": 0}
               for res in results for c in CASES if not c[3])


def test_block_pred_launch_counts():
    assert ring_flash_launches(2, True, 32) == [1, 2]
    assert ring_flash_launches(4, True, 8) == [1, 2, 3, 4]
    assert ring_flash_launches(4, False, 8) == [4, 4, 4, 4]
    # S 9 over 4 ranks pads to 12 (3 a shard): shard 3 (keys 9-11) is
    # all padding, skipped by every rank
    assert ring_flash_launches(4, False, 3, 9) == [3, 3, 3, 3]
    assert ring_flash_launches(4, True, 3, 9) == [1, 2, 3, 3]
