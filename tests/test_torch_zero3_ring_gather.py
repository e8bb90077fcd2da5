"""The stage-3 ring gather and hpZ in the port at a data degree of 4
(``runtime/zero/zeropp.py``, ``comm.collective_matmul.zero_gather``,
``zero_hierarchical_partition``), held to plain stage 3 and to the JAX
package.

The port's ranks are four gloo processes on the CPU (one spawn for the
module, ``torch_zero3_workers``) on the tiny GPT-2 of
``test_torch_zero3.py`` (2 layers, d 64, vocabulary 128, seq 32, bf16,
Adam, micro 2, two micro-steps a step, 3 steps, persistence threshold
1000); the JAX engine runs on ``build_mesh(data=4)`` (and ``data=2`` for
a tag). Checks:

* hpZ 2 equals flat stage 3 bit for bit (losses, masters, both moments):
  the unit gathers run over the 2-rank shard group and each rank keeps
  twice flat stage 3's parameter pieces (about numel / 2);
* the ring gather equals the plain gather bit for bit, with and without
  hpZ, and posts the next unit's ring ahead;
* qwZ's gathered unit equals the JAX codec's values bit for bit where
  pieces split blocks (DP 4, and DP 4 under hpZ 2, whose pieces are
  strided); the ring gather with qwZ equals the JAX ring gather's values
  (``zero3_ring_gather``, which tiles each rank's shard) on leaves whose
  two tilings differ, and on one whose tilings agree;
* qwZ + hpZ 2 + qgZ follow the JAX engine with the three modes at
  ``test_torch_zero3.py``'s tolerances;
* qgZ's residual crosses tags: the JAX engine's (hpZ on, DP 4) into the
  port without hpZ, the port's (DP 4, hpZ on) into the JAX engine at DP
  2, and that engine's tag back into the port at DP 4, bit for bit;
* the wire census equals the JAX engine's, and qwZ + hpZ 2 moves at
  least 3x fewer gather bytes than flat fp32 stage 3.
"""
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from deepspeed_tpu_torch.utils.distributed import spawn

import torch_zero3_workers as workers
import torch_zeropp_jax as zj

pytestmark = pytest.mark.torch_port

WORLD = 4
S3 = zj.S3
HPZ = dict(S3, zero_hierarchical_partition=2)
ALL = dict(HPZ, zero_quantized_weights=True, zero_quantized_gradients=True)
QGZ = dict(S3, zero_quantized_gradients=True)
CONFIGS = [("s3", S3, None), ("hpz", HPZ, None),
           ("ring", S3, {"zero_gather": True}), ("ring_hpz", HPZ, {}),
           ("all", ALL, None)]
# qwZ's gather: pieces split blocks at DP 4 (block 200 and 240)
QWZ_LEAVES = [("a", (5, 1600)), ("b", (2, 4800)), ("c", (9, 64))]
# the ring's qwZ: (3, 600) and (1200,) shard their last dimension (tiled
# by 150 / 300 at DP 4 and 2 against 200 and 240 whole); (8, 1600) its
# first (one tiling)
RING_LEAVES = [("a", (3, 600)), ("b", (1200,)), ("c", (8, 1600))]


def _leaves(shapes):
    return [(n, zj.leaf(shape, seed)) for seed, (n, shape) in
            enumerate(shapes)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_dir = str(tmp_path_factory.mktemp("ring_jax_tag"))
    port_dir = str(tmp_path_factory.mktemp("ring_port_tag"))
    back_dir = str(tmp_path_factory.mktemp("ring_back_tag"))
    specs = [zj.port_spec(name, WORLD, zero, cm=cm)
             for name, zero, cm in CONFIGS]
    specs[-1].update(save=port_dir, save_tag="port")
    specs += [zj.port_spec("qgz_load", WORLD, QGZ, load=jax_dir,
                           load_tag="jax", steps=0,
                           wait_for=os.path.join(jax_dir, "latest")),
              zj.port_spec("all_load", WORLD, ALL, load=back_dir,
                           load_tag="back", steps=0,
                           wait_for=os.path.join(back_dir, "latest"))]
    qwz, ring = _leaves(QWZ_LEAVES), _leaves(RING_LEAVES)
    cases = [(qwz, True, None, 0), (qwz, True, None, 2),
             (ring, True, 1, 0), (ring, True, 2, 2)]
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(spawn, _rank, WORLD, args=(specs, cases),
                            timeout_s=300)
        every = pool.submit(zj.jax_run, WORLD, ALL, save=(jax_dir, "jax"))
        jax_runs = {name: zj.jax_run(WORLD, zero, steps=0, cm=cm)
                    for name, zero, cm in CONFIGS if name != "all"}
        jax_runs["all"] = every.result()
        # the port's DP 4 tag (hpZ on) -> the JAX engine at DP 2, whose
        # own tag goes back to the port at DP 4
        latest = os.path.join(port_dir, "latest")
        deadline = time.time() + 240
        while not os.path.exists(latest) and time.time() < deadline:
            time.sleep(0.2)
        jax_runs["port_tag"] = zj.jax_load_qg_error(
            2, QGZ, port_dir, "port", save=(back_dir, "back"))
        engines, gathers = ranks.result()[0]
    port = {s["name"]: r for s, r in zip(specs, engines)}
    return port, gathers, jax_runs, (qwz, ring)


def _rank(rank, world, specs, cases):
    return (workers.zero_engine(rank, world, specs),
            workers.gather_cases(rank, world, cases))


def test_hpz_equals_flat_stage3_bit_for_bit(runs):
    port = runs[0]
    a, b = port["hpz"], port["s3"]
    assert a["modes"][1] == 2 and b["modes"][1] == 0
    assert a["losses"] == b["losses"]
    for key in ("master", "exp_avg", "exp_avg_sq"):
        zj.assert_trees_equal(zj.named(a[key]), zj.named(b[key]))
    # gathers over the 2-rank shard group; twice flat stage 3's pieces
    assert a["shard_world"] == 2 and b["shard_world"] == 4
    persistent = 2 * dict(a["units"])["persistent"]
    assert a["param_bytes"] - persistent == \
        2 * (b["param_bytes"] - persistent)
    numel = sum(n for _, n in a["units"])
    assert a["param_bytes"] < 0.6 * 2 * numel


@pytest.mark.parametrize("ring,plain", [("ring", "s3"),
                                        ("ring_hpz", "hpz")])
def test_ring_gather_equals_the_plain_gather(runs, ring, plain):
    port = runs[0]
    a, b = port[ring], port[plain]
    assert a["modes"][3] and not b["modes"][3]
    assert a["losses"] == b["losses"]
    zj.assert_trees_equal(zj.named(a["master"]), zj.named(b["master"]))
    assert a["prefetched"] > 0 and a["gathers"] == b["gathers"]
    assert a["wire"]["allgather"] == b["wire"]["allgather"]


@pytest.mark.parametrize("case", [0, 1])
def test_qwz_gather_splits_blocks_bit_for_bit(runs, case):
    got = runs[1][case]
    for name, x in runs[3][0]:
        np.testing.assert_array_equal(got[name], zj.qwz_values(x),
                                      err_msg=name)


@pytest.mark.parametrize("case,ways", [(2, 4), (3, 2)])
def test_ring_qwz_matches_the_jax_ring(runs, case, ways):
    got = runs[1][case]
    for name, x in runs[3][1]:
        want = zj.ring_qwz_values(x, ways)
        np.testing.assert_array_equal(got[name], want, err_msg=name)
        if name != "c":
            # the two tilings differ on this leaf
            assert not np.array_equal(want, zj.qwz_values(x)), name


def test_all_modes_follow_the_jax_engine(runs):
    zj.check_follows_jax(runs[0]["all"], runs[2]["all"])
    assert runs[0]["all"]["modes"][:3] == (True, 2, True)


def test_qgz_tags_cross_dp_and_hpz(runs):
    port, _, jax_runs, _ = runs
    # JAX (DP 4, hpZ 2) -> port (DP 4, no hpZ)
    zj.assert_trees_equal(zj.named(port["qgz_load"]["loaded_qg_error"]),
                          jax_runs["all"]["qg_error"])
    # port (DP 4, hpZ 2) -> JAX (DP 2) -> port (DP 4, hpZ 2)
    want = zj.named(port["all"]["qg_error"])
    zj.assert_trees_equal(jax_runs["port_tag"], want)
    zj.assert_trees_equal(zj.named(port["all_load"]["loaded_qg_error"]),
                          want)


@pytest.mark.parametrize("name", [c[0] for c in CONFIGS])
def test_wire_census_matches_jax(runs, name):
    port, _, jax_runs, _ = runs
    assert port[name]["census"] == jax_runs[name]["census"]


def test_qwz_hpz_gather_bytes_drop_3x(runs):
    census = runs[0]["all"]["census"]
    assert census["allgather_reduction_x"] >= 3.0, census
    assert census["total_bytes_per_step"] < \
        census["fp32_flat_total_bytes_per_step"]
