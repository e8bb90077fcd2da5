"""ZeRO stage 3 under tensor parallelism and with sparse embedding
gradients in the port, held against the JAX package's engine on the same
mesh and global batch, and against the port's stage 2.

GPT-2 (2 layers, d 64, vocabulary 128, seq 32), bf16, Adam lr 1e-3, 3
steps, one micro-step a step; ``stage3_param_persistence_threshold`` 1000
so every block's matrices are partitioned over the data group. The port's
ranks are gloo processes on the CPU (``torch_zero3_workers.zero_engine``),
one spawn a world size.

* DP 2 x TP 2 (``build_mesh(data=2, model=2)``, ``comm.collective_matmul``,
  four ranks): stage 3 against the JAX engine at stage 3 on the same mesh,
  the losses within 5e-4 relative and each master leaf's move within 0.25
  of the JAX engine's (the qkv bias's key part within 1e-2), the bf16
  bounds of ``tests/test_torch_zero_dp.py``; stage 3 against the port's
  stage 2 on the same mesh: the losses and the gathered masters bit for
  bit (the units hold each rank's TP shards, the replicated leaves'
  ranges are all-reduced over the model group after the data group's
  reduce-scatter, and the two uses of the gathered ``wte`` reduce-scatter
  their sum once, as at stage 2). The units are TP shards: model ranks of
  one data coordinate share their layout and replicated ranges;
  ``comm.collective_matmul.zero_gather`` (on by default) runs: stage 3
  gathers each unit as a ring over the data group, and the section's
  ``strict`` accepts it;
* LAMB at stage 3 under TP against stage 2 under TP, at the bounds
  above (a trust ratio from a piece's sums would be off by far more);
* DP 2 with ``sparse_embedding_grads`` (two ranks): stage 3 against the
  JAX engine at stage 3 with the sparse exchange, at the bounds above,
  and against the port's stage 2 with it, bit for bit (the densified
  gradient is divided by the data degree once, and the unit's
  reduce-scatter then sums it once); the dense stage 3 run differs from
  it by rounding only (losses within 5e-4 relative).
"""
import numpy as np
import pytest

import jax

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.parallel.topology import build_mesh as j_build_mesh
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_zero3_workers as workers

pytestmark = pytest.mark.torch_port

MODEL = dict(vocab_size=128, max_seq_len=32, n_layers=2, n_heads=2,
             d_model=64, remat=False, loss_chunk=0)
MICRO, STEPS, LR = 2, 3, 1e-3
ZERO3 = {"stage": 3, "stage3_param_persistence_threshold": 1000}
LOSS_RTOL, MOVED_RTOL, KEY_BIAS_ATOL = 5e-4, 0.25, 1e-2


def _ids(rows, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 128, size=(1, rows, 32)).astype(np.int64)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + key + ".")
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from _leaves(child, prefix + str(i) + ".")
    else:
        yield prefix[:-1], np.asarray(tree, np.float32)


def _tree(tree):
    return dict(_leaves(tree))


def _jax_run(data, tp, sparse=False):
    mesh = j_build_mesh(data=data, model=tp if tp > 1 else None)
    cfg = jgpt2.GPT2Config(**MODEL, use_flash_attention=False,
                           sparse_embedding_grads=sparse,
                           embedding_grad_mesh=mesh if sparse else None)
    conf = {"train_micro_batch_size_per_gpu": MICRO,
            "gradient_accumulation_steps": 1, "bf16": {"enabled": True},
            "zero_optimization": dict(ZERO3),
            "optimizer": {"type": "Adam", "params": {"lr": LR}},
            "steps_per_print": 10 ** 9}
    if tp > 1:
        conf["comm"] = {"collective_matmul": {"enabled": True}}
    if sparse:
        conf["sparse_gradients"] = True
    eng = JEngine(model=jgpt2.make_gpt2_model(config=cfg), mesh=mesh,
                  config_params=conf)
    init = _tree(eng.get_master_params())
    ids = _ids(MICRO * data)
    losses = [float(eng.train_batch(batch=(ids, ids))) for _ in range(STEPS)]
    return dict(losses=losses, init=init,
                master=_tree(eng.get_master_params()))


def _spec(data, tp=1, **kw):
    ids = _ids(MICRO * data)
    return dict(dict(model=MODEL, seed=0, data=data, tp=tp, micro=MICRO,
                     lr=LR, batch=(ids, ids), steps=STEPS,
                     zero=dict(ZERO3)), **kw)


@pytest.fixture(scope="module")
def runs():
    jax_runs = {"tp": _jax_run(2, 2), "sparse": _jax_run(2, 1, sparse=True)}
    tp = spawn(workers.zero_engine, 4, args=([
        _spec(2, 2), _spec(2, 2, zero={"stage": 2}),
        _spec(2, 2, expect_error=True, cm={"strict": True}),
        _spec(2, 2, optimizer="Lamb"),
        _spec(2, 2, optimizer="Lamb", zero={"stage": 2})],),
        timeout_s=240)
    sparse = spawn(workers.zero_engine, 2, args=([
        _spec(2, sparse=True), _spec(2, sparse=True, zero={"stage": 2}),
        _spec(2)],), timeout_s=240)
    return jax_runs, {"tp": tp, "sparse": sparse}


def _check_masters(got, want, init):
    assert sorted(got) == sorted(want)
    d = MODEL["d_model"]
    for name, w in want.items():
        moved, want_moved = got[name] - init[name], w - init[name]
        if name.endswith("qkv_bias"):
            key = slice(d, 2 * d)
            assert np.abs(moved[..., key] - want_moved[..., key]).max() \
                <= KEY_BIAS_ATOL, name
            moved = np.delete(moved, np.s_[d:2 * d], axis=-1)
            want_moved = np.delete(want_moved, np.s_[d:2 * d], axis=-1)
        err = float(np.linalg.norm(moved - want_moved) /
                    np.linalg.norm(want_moved))
        assert err <= MOVED_RTOL, (name, err)


@pytest.mark.parametrize("case", ["tp", "sparse"])
def test_stage3_matches_the_jax_engine(runs, case):
    jax_runs, port = runs
    want, ranks = jax_runs[case], port[case]
    got = ranks[0][0]
    for res in ranks:
        assert res[0]["losses"] == got["losses"]
        assert res[0]["step"] == STEPS
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    assert got["losses"][-1] < got["losses"][0]
    _check_masters(_tree(got["master"]), want["master"], want["init"])
    for res in ranks[1:]:           # every rank gathers the same tree
        other = _tree(res[0]["master"])
        for key, w in _tree(got["master"]).items():
            assert np.array_equal(other[key], w), key


@pytest.mark.parametrize("case", ["tp", "sparse"])
def test_stage3_equals_stage2_bit_for_bit(runs, case):
    for res in runs[1][case]:
        s3, s2 = res[0], res[1]
        assert s3["losses"] == s2["losses"]
        got, want = _tree(s3["master"]), _tree(s2["master"])
        for key, w in want.items():
            assert np.array_equal(got[key], w), key
        # stage 3 gathered its units; stage 2 keeps every leaf whole
        assert s3["gathers"] > 0 and s2["gathers"] == 0
        assert s3["param_bytes"] < s2["param_bytes"]


def test_stage3_tp_units_hold_the_ranks_shards(runs):
    ranks = runs[1]["tp"]
    # rank = data coordinate * 2 + model rank: the model ranks of one
    # data coordinate hold the same layout and replicated ranges
    for d in range(2):
        a, b = ranks[2 * d][0], ranks[2 * d + 1][0]
        assert a["units"] == b["units"]
        assert a["own_replicated"] == b["own_replicated"]
        assert a["own_replicated"], "no replicated leaf in the owned part"
    # the qkv kernel's unit holds this rank's 64 x 64 shard of (64, 192)
    units = dict(ranks[0][0]["units"])
    assert units["blocks.0"] < 12 * 64 * 64
    for res in ranks:
        assert res[2]["error"] is None, res[2]
        assert res[0]["modes"][3] and res[0]["prefetched"] > 0


def test_stage3_tp_lamb_matches_stage2(runs):
    """LAMB at stage 3 under TP: each leaf's trust ratio from the sums of
    its pieces over the data group and, for the sharded leaves, the model
    group (the unit layout interleaves them with the replicated ones);
    against stage 2 under TP within the bf16 bounds (the partial sums
    group the elements otherwise)."""
    for res in runs[1]["tp"]:
        s3, s2 = res[3], res[4]
        np.testing.assert_allclose(s3["losses"], s2["losses"],
                                   rtol=LOSS_RTOL)
        assert s3["launches"]["fused_adam"] == 0 and s3["gathers"] > 0
    init = _tree(runs[0]["tp"]["init"])
    _check_masters(_tree(runs[1]["tp"][0][3]["master"]),
                   _tree(runs[1]["tp"][0][4]["master"]), init)


def test_stage3_sparse_exchange_is_live(runs):
    ranks = runs[1]["sparse"]
    for res in ranks:
        assert res[0]["csr"] == ["wte"] and res[2]["csr"] == []
    np.testing.assert_allclose(ranks[0][0]["losses"], ranks[0][2]["losses"],
                               rtol=LOSS_RTOL)
