"""Pipeline layouts in the port: a ragged partition and Megatron
interleaving, held against the JAX package's ``PipelineEngine`` (PP 2,
two gloo ranks, one spawn; the JAX module's weights carried across, fp32,
dropout 0, 3 steps of M = 4, then ``eval_batch``), and the port's
layouts and backward modes against each other:

* ragged: GPT-2 with 3 layers over 2 stages (depths 2 and 1): losses and
  the eval loss within 1e-5 relative, the real layers' masters within
  5e-5 absolute (the JAX module's padded slot is not a layer);
* interleaved: 4 layers, ``num_virtual_stages`` 2 (virtual stage j =
  c * 2 + r): the same bounds;
* the same weights at v = 1 train bit for bit as at v = 2 (every layer
  meets the micro-batches in the same order and each parameter's
  gradients fold into the accumulator in that order; no clipping here,
  whose global norm sums the stages' squares in another grouping);
* ``save_stage_residuals`` (the forward's autograd graph kept) trains bit
  for bit as the default recompute backward, at v = 1 and v = 2 (the
  same operations on the same values).
"""
import numpy as np
import pytest

import torch_pipe_jax as J
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_pipe_workers as workers

pytestmark = pytest.mark.torch_port

M, MICRO, STEPS = 4, 2, 3
JAX_RUNS = {"ragged": dict(layers=3, v=1), "v2": dict(layers=4, v=2)}


def _run(layers, v=1, **extra):
    batch = J.gpt2_batch(M, MICRO, seed=3)
    evalb = J.gpt2_batch(M, MICRO, seed=4)
    return dict(S=2, dp=1, prec="fp32", v=v, M=M, micro=MICRO,
                gpt2=dict(J.GPT2, n_layers=layers),
                actions=[("train", batch, STEPS), ("eval", evalb),
                         ("master",)], **extra)


@pytest.fixture(scope="module")
def results():
    jax_out, runs = {}, []
    for name, kw in JAX_RUNS.items():
        run = _run(kw["layers"], kw["v"])
        net, engine = J.jax_engine(run)
        init = J.numpy_tree(net.params)
        jax_out[name] = dict(J.jax_play(run, engine), init=init,
                             layout={"parts": net.parts,
                                     "num_virtual": kw["v"]})
        runs.append((name, dict(run, tree=init)))
    v2 = jax_out["v2"]
    runs += [("v2_save", _run(4, 2, tree=v2["init"], save=True)),
             ("v1", _run(4, 1, tree=v2["init"], tree_layout=v2["layout"])),
             ("v1_save", _run(4, 1, tree=v2["init"], save=True,
                              tree_layout=v2["layout"]))]
    ranks = spawn(workers.pipe_rank, 2, args=({"runs": runs},),
                  timeout_s=300)
    return jax_out, ranks


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_layout_matches_jax(results, name):
    jax_out, ranks = results
    want, got = jax_out[name], ranks[0][name]
    assert got["parts"] == list(want["layout"]["parts"])
    assert ranks[1][name]["losses"] == got["losses"]
    assert J.rel(got["losses"], want["losses"]) <= J.LOSS_TOL["fp32"], \
        (got["losses"], want["losses"])
    assert J.rel(got["evals"], want["evals"]) <= J.LOSS_TOL["fp32"]
    v = JAX_RUNS[name]["v"]
    J.check_masters(got["master"], want["master"], want["init"],
                    got["parts"], "fp32", v_got=v, v_want=v)


def test_ragged_stage_depths(results):
    _, ranks = results
    assert ranks[0]["ragged"]["parts"] == [0, 2, 3]
    # the stash never outgrows the schedule's buffer slots
    for r in ranks:
        stats = r["ragged"]["stats"]
        assert stats["peak_stash"] <= stats["buffer_slots"]


@pytest.mark.parametrize("pair", [("v1", "v2"), ("v1_save", "v1"),
                                  ("v2_save", "v2")])
def test_layouts_and_modes_bit_equal(results, pair):
    _, ranks = results
    a, b = (ranks[0][n] for n in pair)
    assert a["losses"] == b["losses"], (a["losses"], b["losses"])
    assert a["evals"] == b["evals"]
    va = 2 if "v2" in pair[0] else 1
    vb = 2 if "v2" in pair[1] else 1
    ga = J.real_leaves(a["master"], a["parts"], va)
    gb = J.real_leaves(b["master"], b["parts"], vb)
    for key in gb:
        assert np.array_equal(ga[key], gb[key]), key
