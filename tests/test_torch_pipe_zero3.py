"""ZeRO stage 3 under the port's pipeline, and pipeline tags under
``cpu_offload``, held against the JAX package's ``PipelineEngine`` from the
JAX module's weights: GPT-2 (4 layers, d 64), PP 2 x DP 2 (four gloo
ranks, one spawn), bf16, M = 4, dropout 0.

* stage 3 against the JAX engine at stage 3: losses within 5e-4
  relative, each master leaf's move within 0.25 of the JAX engine's (the
  qkv bias's key part within 1e-2), the tests' bf16 bounds
  (``torch_pipe_jax``); the tied copies of the first and last stages
  equal bit for bit;
* stage 3 against the port at stage 2 on the same mesh: the losses and
  masters bit for bit (each unit's reduce-scatter sums what stage 2's
  sums, and the tied leaves keep stage 2's order: the pair sum, then the
  data group); a small ``stage3_param_persistence_threshold`` partitions
  every block;
* PP x TP at stage 3 stays refused with the JAX message (PipelineError,
  "not a certified combination");
* ``cpu_offload`` (the JAX test ``test_pipeline_with_cpu_offload``'s
  case, ``tests/unit/test_pipe.py:247``): PP 2 x DP 4 TanhLinear layers at
  stage 2 with the host Adam, from the JAX module's weights, converge as
  the JAX engine does (the last loss under half the first), each loss
  within 2e-3 relative of the JAX engine's, and count their steps;
* a pipeline tag under ``cpu_offload`` (stage 3): each rank's zero file
  holds ``offload_shards`` with the stacked body's boxes; the port resumes
  it bit for bit as the run that kept going; the JAX pipeline engine
  under ``cpu_offload`` loads it (its eval within 5e-4 relative of the
  port's); the JAX engine's offload tag loads into the port (the port's
  eval within 5e-4 relative of the JAX engine's, and the next step's loss
  within 5e-4).
"""
import glob
import os

import numpy as np
import pytest

import torch_pipe_jax as J
from deepspeed_tpu_torch.runtime import checkpointing as ckpt
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_pipe_workers as workers

pytestmark = pytest.mark.torch_port

M, MICRO, STEPS = 4, 2, 3
# at d 64 every block leaf over 1000 elements is partitioned
ZERO3 = {"stage3_param_persistence_threshold": 1000}
OFFLOAD = dict(ZERO3, cpu_offload=True)
# 40 bf16 steps at lr 1e-2 from the same weights: the two host Adams and
# the two engines' summation orders drift apart by rounding
OFFLOAD_LOSS_RTOL = 2e-3


def _run(**kw):
    rows = MICRO * kw.get("dp", 2)
    batch = J.gpt2_batch(M, rows, seed=7)
    return dict(dict(S=2, dp=2, M=M, micro=MICRO, prec="bf16",
                     gpt2=dict(J.GPT2, n_layers=4),
                     actions=[("train", batch, STEPS), ("tied",),
                              ("master",)]), **kw)


def _np32(batch):
    return tuple(np.asarray(x, np.int32) for x in batch)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_zero3")
    d = {k: str(tmp / k) for k in ("jax", "port")}
    run3 = _run(stage=3, zero=ZERO3)
    net, engine = J.jax_engine(run3)
    init = J.numpy_tree(net.params)
    want = dict(J.jax_play(run3, engine), init=init)

    # the JAX pipeline under offload: a step, its tag, its eval, a step
    train, nxt = J.gpt2_batch(M, MICRO * 2, 8), J.gpt2_batch(M, MICRO * 2, 9)
    evalb = J.gpt2_batch(M, MICRO * 2, 10)
    off = _run(stage=2, zero={"cpu_offload": True}, actions=[])
    jnet, jeng = J.jax_engine(off)
    jinit = J.numpy_tree(jnet.params)
    jeng.train_batch(batch=_np32(train))
    jeng.save_checkpoint(d["jax"])
    jax_eval = float(jeng.eval_batch(batch=_np32(evalb)))
    jax_next = float(jeng.train_batch(batch=_np32(nxt)))

    runs = [
        ("s3", dict(run3, tree=init)),
        ("s2", dict(_run(stage=2), tree=init)),
        ("saver", _run(stage=3, zero=OFFLOAD, tree=jinit, actions=[
            ("train", train, 1), ("save", d["port"]), ("eval", evalb),
            ("train", nxt, 1), ("master",)])),
        ("resume", _run(stage=3, zero=OFFLOAD, actions=[
            ("load", d["port"]), ("eval", evalb), ("train", nxt, 1),
            ("master",)])),
        ("from_jax", _run(stage=3, zero=OFFLOAD, actions=[
            ("load", d["jax"]), ("eval", evalb), ("train", nxt, 1)])),
    ]
    ranks = spawn(workers.pipe_rank, 4, args=({"runs": runs},),
                  timeout_s=300)
    # the port's offload tag in the JAX pipeline engine under offload
    _, jload = J.jax_engine(off)
    path, _ = jload.load_checkpoint(d["port"])
    port_tag = {"loaded": path is not None,
                "eval": float(jload.eval_batch(batch=_np32(evalb))),
                "zero_files": sorted(glob.glob(os.path.join(
                    d["port"], "*", "zero_pp_rank_*"))),
                "latest": ckpt.read_latest(d["port"])}
    return dict(want=want, ranks=ranks, jax_eval=jax_eval,
                jax_next=jax_next, port_tag=port_tag, dirs=d)


def test_stage3_matches_jax(runs):
    want, ranks = runs["want"], runs["ranks"]
    got = ranks[0]["s3"]
    for r in ranks:
        assert r["s3"]["losses"] == got["losses"]
    assert J.rel(got["losses"], want["losses"]) <= J.LOSS_TOL["bf16"], \
        (got["losses"], want["losses"])
    J.check_masters(got["master"], want["master"], want["init"],
                    got["parts"], "bf16")
    for dp in range(2):
        first, last = ranks[dp]["s3"]["tied"][0], \
            ranks[2 + dp]["s3"]["tied"][0]
        for key in first:
            assert np.array_equal(first[key], last[key]), key


def test_stage3_equals_stage2_bit_for_bit(runs):
    a, b = runs["ranks"][0]["s3"], runs["ranks"][0]["s2"]
    assert a["losses"] == b["losses"]
    ga = J.real_leaves(a["master"], a["parts"])
    gb = J.real_leaves(b["master"], b["parts"])
    for key in gb:
        assert np.array_equal(ga[key], gb[key]), key
    # stage 3 holds a quarter of the model at most: the pieces
    assert a["state_numel"] < b["state_numel"] * 2


def test_pp_tp_stage3_refused_with_the_jax_message():
    confs = [("z3", dict(_run(stage=3, tp=2, dp=1), actions=[]))]
    out = spawn(workers.refused_rank, 4, args=({"confs": confs},),
                timeout_s=240)
    for r in out:
        kind, msg = r["z3"]
        assert kind == "PipelineError" and "not a certified" in msg, r["z3"]


def test_offload_pipeline_converges():
    """``tests/unit/test_pipe.py::test_pipeline_with_cpu_offload``: PP 2 x
    DP 4 TanhLinear layers at stage 2 with the host Adam, 40 steps over
    its five batches (``make_batches(M, 16, seed)``), from the JAX
    module's weights: the loss falls under half its first value, as the
    JAX engine's does, each step within 2e-3 relative of the JAX
    engine's, and the host step counts 40."""
    batches = [J.tanh_batch(2, 16, seed=seed) for seed in range(5)]
    steps = [("train", batches[step % 5], 1) for step in range(40)]
    run = dict(S=2, dp=4, M=2, micro=4, prec="bf16", stage=2, tanh=4,
               lr=1e-2, zero={"cpu_offload": True},
               actions=steps + [("steps",)])
    net, engine = J.jax_engine(run)
    assert engine.host_state is not None
    want = J.jax_play(dict(run, actions=steps), engine)["losses"]
    assert want[-1] < 0.5 * want[0], (want[0], want[-1])
    ranks = spawn(workers.pipe_rank, 8, args=({"runs": [("off", dict(
        run, tree=J.numpy_tree(net.params)))]},), timeout_s=300)
    got = ranks[0]["off"]
    assert got["losses"][-1] < 0.5 * got["losses"][0], \
        (got["losses"][0], got["losses"][-1])
    assert J.rel(got["losses"], want) <= OFFLOAD_LOSS_RTOL, \
        (got["losses"], want)
    assert got["opt_step"] == 40 and got["offload"]


def test_offload_tag_resumes_bit_for_bit(runs):
    ranks = runs["ranks"]
    saver, resume = ranks[0]["saver"], ranks[0]["resume"]
    assert resume["loaded"][0] and resume["loaded"][1] == 7
    assert resume["evals"] == saver["evals"]
    assert resume["losses"] == saver["losses"][1:]
    gs = J.real_leaves(saver["master"], saver["parts"])
    gr = J.real_leaves(resume["master"], resume["parts"])
    for key in gs:
        assert np.array_equal(gs[key], gr[key]), key


def test_offload_tag_carries_stacked_offload_shards(runs):
    tag = runs["port_tag"]
    assert len(tag["zero_files"]) == 4
    payload = ckpt.load_state_dict(tag["zero_files"][0])
    shards = payload["offload_shards"]
    assert "device_shards" not in payload and payload["offload_step"] == 1
    # per leaf of the whole pipeline tree: (key, master, m, v) boxes; the
    # body leaves' boxes lead with the stage and slot of the stacked leaf
    body = [leaf for leaf in shards if leaf and len(leaf[0][0]) == 4]
    assert body, "no stacked body leaf in the zero file"
    for key, p, m, v in body[0]:
        assert p.shape == m.shape == v.shape == \
            tuple(b - a for a, b, _ in key)
        assert key[0][1] - key[0][0] == 1      # one stage a box


def test_offload_tags_cross_both_ways_with_jax(runs):
    saver = runs["ranks"][0]["saver"]
    tag = runs["port_tag"]
    assert tag["loaded"]
    assert abs(tag["eval"] - saver["evals"][0]) / abs(saver["evals"][0]) \
        <= J.LOSS_TOL["bf16"], (tag["eval"], saver["evals"])
    got = runs["ranks"][0]["from_jax"]
    assert got["loaded"][0]
    assert abs(got["evals"][0] - runs["jax_eval"]) / abs(runs["jax_eval"]) \
        <= J.LOSS_TOL["bf16"], (got["evals"], runs["jax_eval"])
    assert abs(got["losses"][0] - runs["jax_next"]) / \
        abs(runs["jax_next"]) <= J.LOSS_TOL["bf16"], \
        (got["losses"], runs["jax_next"])
