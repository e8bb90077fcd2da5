"""3D parallelism in the port: GPT-2 as a pipeline at PP 2 x DP 2 x TP 2
(eight gloo ranks, one spawn; rank = p * 4 + d * 2 + t), ZeRO stage 1,
bf16, tensor parallelism through ``comm.collective_matmul`` (the ring
GEMMs' plain versions on the CPU; the residual stream between stages is
each model rank's rows of the sequence), held against the JAX package's
``PipelineEngine`` on all eight virtual CPU devices
(``PipeModelDataParallelTopology``: GSPMD shards its blocks; the same
function), from the JAX module's weights, dropout 0, 3 steps of M = 4,
then ``eval_batch``: losses within 5e-4 relative, each master leaf's move
within 0.25 of the JAX engine's (the key bias within 1e-2), as the bf16
pipeline runs of ``test_torch_pipe_gpt2.py``; the tied embedding copies
equal bit for bit; every rank of a pipe line reports the same losses.
"""
import numpy as np
import pytest

import torch_pipe_jax as J
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_pipe_workers as workers

pytestmark = pytest.mark.torch_port

M, MICRO, STEPS = 4, 2, 3


@pytest.fixture(scope="module")
def results():
    batch = J.gpt2_batch(M, MICRO * 2, seed=5)
    run = dict(S=2, dp=2, tp=2, prec="bf16", stage=1, M=M, micro=MICRO,
               gpt2=dict(J.GPT2, n_layers=4),
               actions=[("train", batch, STEPS), ("tied",),
                        ("eval", J.gpt2_batch(M, MICRO * 2, seed=6)),
                        ("master",)])
    net, engine = J.jax_engine(run)
    init = J.numpy_tree(net.params)
    want = dict(J.jax_play(run, engine), init=init)
    ranks = spawn(workers.pipe_rank, 8,
                  args=({"runs": [("3d", dict(run, tree=init))]},),
                  timeout_s=300)
    return want, [r["3d"] for r in ranks]


def test_3d_matches_jax(results):
    want, ranks = results
    got = ranks[0]
    for r in ranks:
        assert r["losses"] == got["losses"] and r["evals"] == got["evals"]
    assert J.rel(got["losses"], want["losses"]) <= J.LOSS_TOL["bf16"], \
        (got["losses"], want["losses"])
    assert J.rel(got["evals"], want["evals"]) <= J.LOSS_TOL["bf16"]
    J.check_masters(got["master"], want["master"], want["init"],
                    got["parts"], "bf16")


def test_3d_layout(results):
    _, ranks = results
    assert [r["stage"] for r in ranks] == [0] * 4 + [1] * 4
    # each data rank of a stage holds half its (TP shard's) partition
    assert ranks[0]["state_numel"] == ranks[1]["state_numel"]
    for first, last in zip(ranks[:4], ranks[4:]):
        for key, value in first["tied"][0].items():
            assert np.array_equal(value, last["tied"][0][key]), key
