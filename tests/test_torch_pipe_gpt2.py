"""GPT-2 as a pipeline in the port, held against the JAX package's
``PipelineEngine`` at PP 2 x DP 2 (four gloo ranks, one spawn; the JAX
engine on four of the eight virtual CPU devices), from the JAX module's
weights carried across (``PipelineModule.load_pipe_tree``), dropout 0, 3
steps of M = 4 micro-batches, then ``eval_batch``:

* fp32 at ZeRO stage 0 (ZeRO needs bf16 or fp16, in both packages):
  losses and the eval loss within 1e-5 relative, the master weights
  within 5e-5 absolute (an Adam step moves an element whose gradient is
  rounding noise by up to lr either way; another summation order here);
* bf16 at ZeRO stage 1: losses within 5e-4 relative, each master leaf's
  move from the start within 0.25 of the JAX engine's (by norm; the qkv
  biases' key part, whose exact gradient is zero, within 1e-2
  absolute), as the port's data-parallel tests hold bf16 runs that
  round differently;
* the two tied embedding copies (first stage, last stage) equal bit for
  bit after every step, and ``initialize`` returns a PipelineEngine.
"""
import numpy as np
import pytest

import torch_pipe_jax as J
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_pipe_workers as workers

pytestmark = pytest.mark.torch_port

M, MICRO, STEPS = 4, 2, 3
RUNS = {
    "fp32": dict(S=2, dp=2, prec="fp32"),
    "bf16_z1": dict(S=2, dp=2, prec="bf16", stage=1),
}


def _run(name):
    batch = J.gpt2_batch(M, MICRO * 2, seed=1)
    evalb = J.gpt2_batch(M, MICRO * 2, seed=2)
    return dict(RUNS[name], gpt2=dict(J.GPT2, n_layers=4), M=M, micro=MICRO,
                actions=[("train", batch, 1), ("tied",),
                         ("train", batch, STEPS - 1), ("tied",),
                         ("eval", evalb), ("master",)])


@pytest.fixture(scope="module")
def results():
    jax_out, runs = {}, []
    for name in RUNS:
        run = _run(name)
        net, engine = J.jax_engine(run)
        init = J.numpy_tree(net.params)
        jax_out[name] = dict(J.jax_play(run, engine), init=init)
        runs.append((name, dict(run, tree=init)))
    ranks = spawn(workers.pipe_rank, 4, args=({"runs": runs},),
                  timeout_s=300)
    return jax_out, ranks


@pytest.mark.parametrize("name", list(RUNS))
def test_pipeline_matches_jax(results, name):
    jax_out, ranks = results
    want = jax_out[name]
    got = ranks[0][name]
    prec = RUNS[name]["prec"]
    assert got["kinds"] == "PipelineEngine"
    for r in ranks:
        assert r[name]["losses"] == got["losses"], "ranks disagree"
        assert r[name]["evals"] == got["evals"]
    assert J.rel(got["losses"], want["losses"]) <= J.LOSS_TOL[prec], \
        (got["losses"], want["losses"])
    assert J.rel(got["evals"], want["evals"]) <= J.LOSS_TOL[prec], \
        (got["evals"], want["evals"])
    J.check_masters(got["master"], want["master"], want["init"],
                    got["parts"], prec)


@pytest.mark.parametrize("name", list(RUNS))
def test_tied_copies_stay_equal(results, name):
    _, ranks = results
    # ranks 0, 1 hold stage 0 (data 0, 1), ranks 2, 3 stage 1
    for step in range(2):
        for d in range(2):
            first = ranks[d][name]["tied"][step]
            last = ranks[2 + d][name]["tied"][step]
            assert sorted(first) == ["tied.embed.wpe", "tied.embed.wte"]
            for key in first:
                assert np.array_equal(first[key], last[key]), (step, key)
