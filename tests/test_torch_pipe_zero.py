"""ZeRO, clipping and ZeRO-Offload under the port's pipeline, held against
the JAX package's ``PipelineEngine`` from the JAX module's weights,
dropout 0, 3 steps of M = 4:

* clipping that binds (``gradient_clipping`` 0.05, the global norm of
  every step several times that): PP 2 (two gloo ranks), fp32: losses
  within 1e-5 relative, the masters within 5e-5 absolute, and each
  step's gradient norm (the pipe group's squares, the tied embedding
  counted once) within 1e-5 relative of the JAX engine's;
* PP 2 x DP 2 (four gloo ranks, one spawn) at bf16: ZeRO stage 2, and
  stage 2 with ``cpu_offload`` (the host Adam of ``csrc/cpu_adam.cpp``),
  both against one JAX stage-2 run (its stages compute the same thing):
  losses within 5e-4 relative, each master leaf's move within 0.25 of
  the JAX engine's (the key bias within 1e-2); stage 2 and offload
  against each other: the losses bit for bit (the same gradients), the
  masters within 1e-6 absolute (the host op and the plain Adam round
  their update in another order: an ulp or two of 1e-3-sized values);
  the tied copies equal bit for bit.
"""
import numpy as np
import pytest

import torch_pipe_jax as J
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_pipe_workers as workers

pytestmark = pytest.mark.torch_port

M, MICRO, STEPS, CLIP = 4, 2, 3, 0.05


def _run(**kw):
    rows = MICRO * kw.get("dp", 1)
    batch = J.gpt2_batch(M, rows, seed=7)
    return dict(dict(S=2, M=M, micro=MICRO, gpt2=dict(J.GPT2, n_layers=4),
                     actions=[("train", batch, STEPS), ("tied",),
                              ("master",)]), **kw)


@pytest.fixture(scope="module")
def clip():
    run = _run(dp=1, prec="fp32", clip=CLIP)
    net, engine = J.jax_engine(run)
    init = J.numpy_tree(net.params)
    norms = []
    want = {"losses": []}
    batch = run["actions"][0][1]
    for _ in range(STEPS):
        want["losses"].append(float(engine.train_batch(
            batch=tuple(np.asarray(x, np.int32) for x in batch))))
        norms.append(float(engine.get_global_grad_norm()))
    want.update(master=J.numpy_tree(engine.get_master_params()), init=init,
                norms=norms)
    ranks = spawn(workers.pipe_rank, 2,
                  args=({"runs": [("clip", dict(run, tree=init))]},),
                  timeout_s=300)
    return want, [r["clip"] for r in ranks]


def test_clipping_binds_and_matches_jax(clip):
    want, ranks = clip
    got = ranks[0]
    assert min(want["norms"]) > 3 * CLIP, want["norms"]
    for r in ranks:
        assert r["losses"] == got["losses"]
        assert r["grad_norms"] == got["grad_norms"]
    assert J.rel(got["losses"], want["losses"]) <= J.LOSS_TOL["fp32"]
    assert J.rel(got["grad_norms"], want["norms"]) <= 1e-5, \
        (got["grad_norms"], want["norms"])
    J.check_masters(got["master"], want["master"], want["init"],
                    got["parts"], "fp32")


@pytest.fixture(scope="module")
def zero():
    run = _run(dp=2, prec="bf16", stage=2)
    net, engine = J.jax_engine(run)
    init = J.numpy_tree(net.params)
    want = dict(J.jax_play(run, engine), init=init)
    runs = [("s2", dict(run, tree=init)),
            ("offload", dict(run, tree=init, zero={"cpu_offload": True}))]
    ranks = spawn(workers.pipe_rank, 4, args=({"runs": runs},),
                  timeout_s=300)
    return want, ranks


@pytest.mark.parametrize("name", ["s2", "offload"])
def test_zero2_and_offload_match_jax(zero, name):
    want, ranks = zero
    got = ranks[0][name]
    for r in ranks:
        assert r[name]["losses"] == got["losses"]
    assert J.rel(got["losses"], want["losses"]) <= J.LOSS_TOL["bf16"], \
        (got["losses"], want["losses"])
    J.check_masters(got["master"], want["master"], want["init"],
                    got["parts"], "bf16")
    for d in range(2):
        first, last = ranks[d][name]["tied"][0], ranks[2 + d][name]["tied"][0]
        for key in first:
            assert np.array_equal(first[key], last[key]), key


def test_offload_equals_stage2(zero):
    _, ranks = zero
    a, b = ranks[0]["s2"], ranks[0]["offload"]
    assert a["losses"] == b["losses"]
    ga = J.real_leaves(a["master"], a["parts"])
    gb = J.real_leaves(b["master"], b["parts"])
    for key in ga:
        assert np.abs(ga[key] - gb[key]).max() <= 1e-6, key
