"""Pipeline checkpoints in the port, across packages and layouts
(``tests/unit/test_pipe.py::test_interleaved_checkpoint_cross_layout``'s
pattern): GPT-2 with 5 layers over 2 stages, ragged both at v = 1
(depths 3, 2) and v = 2 (virtual depths 2, 1, 1, 1), fp32, M = 4, two
gloo ranks, from the JAX module's weights.

* the port's tag at v = 1 loads into the JAX ``PipelineEngine`` at v = 2:
  its eval loss within 1e-5 relative of the port's, the loaded master
  weights within 5e-5 of the port's;
* the JAX engine's tag at v = 2 loads into the port at v = 1: the eval
  loss within 1e-5 relative of the JAX engine's, and the next step's
  loss within 1e-5 (the JAX engine keeps its moments in fp32 here, so
  the step continues from the same state);
* the port's v = 1 tag resumed by the port at v = 2 trains on bit for bit
  as the v = 1 run that kept going (v = 1 and v = 2 train alike, and the
  tag holds the exact fp32 state);
* the tag's files: ``mp_rank_00_model_states.pt`` with
  ``client_state["pipe_layout"]``, one ``layer_NN-model_00-
  model_states.pt`` per real body layer, ``manifest.json`` and
  ``latest``;
* ZeRO stage 1 at PP 2 x DP 2 (bf16; per-rank zero files of boxes of the
  stacked leaves, the padded slots' boxes copies of their stage's first
  layer): the port's tag resumed by the port at v = 2 trains on bit for
  bit as the run that kept going, and loads into the JAX engine (its
  eval within 5e-4 relative).
"""
import os

import numpy as np
import pytest

import torch_pipe_jax as J
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_pipe_workers as workers

pytestmark = pytest.mark.torch_port

M, MICRO, LAYERS = 4, 2, 5


def _run(v, actions, dp=1, prec="fp32", **kw):
    return dict(dict(S=2, dp=dp, v=v, prec=prec, M=M, micro=MICRO,
                     gpt2=dict(J.GPT2, n_layers=LAYERS), actions=actions),
                **kw)


def _np32(batch):
    return tuple(np.asarray(x, np.int32) for x in batch)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_ckpt")
    d = {k: str(tmp / k) for k in ("jax", "port", "zero")}
    train, nxt = J.gpt2_batch(M, MICRO * 2, 8), J.gpt2_batch(M, MICRO * 2, 9)
    evalb = J.gpt2_batch(M, MICRO * 2, 10)
    one = tuple(x[:, :MICRO] for x in train)
    one_next = tuple(x[:, :MICRO] for x in nxt)
    one_eval = tuple(x[:, :MICRO] for x in evalb)

    # the JAX engine at v = 2: a step, its tag, its eval and next loss
    net2, eng2 = J.jax_engine(_run(2, []))
    init = J.numpy_tree(net2.params)
    layout2 = {"parts": net2.parts, "num_virtual": 2}
    eng2.train_batch(batch=_np32(one))
    eng2.save_checkpoint(d["jax"])
    jax_eval = float(eng2.eval_batch(batch=_np32(one_eval)))
    jax_next = float(eng2.train_batch(batch=_np32(one_next)))

    tree = dict(tree=init, tree_layout=layout2)
    runs = [
        ("saver", _run(1, [("train", one, 1), ("save", d["port"]),
                           ("eval", one_eval), ("train", one_next, 1),
                           ("master",)], **tree)),
        ("v2_resume", _run(2, [("load", d["port"]), ("master",),
                               ("eval", one_eval),
                               ("train", one_next, 1), ("master",)],
                           seed=None)),
        ("from_jax", _run(1, [("load", d["jax"]), ("eval", one_eval),
                              ("train", one_next, 1)], seed=None)),
    ]
    ranks = spawn(workers.pipe_rank, 2, args=({"runs": runs},),
                  timeout_s=300)
    zero_runs = [
        ("zsaver", _run(1, [("train", train, 1), ("save", d["zero"]),
                            ("eval", evalb), ("train", nxt, 1),
                            ("master",)], dp=2, prec="bf16", stage=1,
                        **tree)),
        ("zresume", _run(2, [("load", d["zero"]), ("eval", evalb),
                             ("train", nxt, 1), ("master",)], dp=2,
                         prec="bf16", stage=1, seed=None)),
    ]
    zranks = spawn(workers.pipe_rank, 4, args=({"runs": zero_runs},),
                   timeout_s=300)

    # the port's tags into the JAX engine at v = 2
    eng2.load_checkpoint(d["port"])
    port_in_jax = (float(eng2.eval_batch(batch=_np32(one_eval))),
                   J.numpy_tree(eng2.get_master_params()))
    _, engz = J.jax_engine(_run(2, [], dp=2, prec="bf16", stage=1))
    path, _ = engz.load_checkpoint(d["zero"])
    assert path is not None
    zero_in_jax = float(engz.eval_batch(batch=_np32(evalb)))
    return dict(d=d, ranks=ranks, zranks=zranks, jax_eval=jax_eval,
                jax_next=jax_next, port_in_jax=port_in_jax,
                zero_in_jax=zero_in_jax, layout2=layout2)


def test_port_tag_files(results):
    tag = os.path.join(results["d"]["port"], "global_step1")
    names = sorted(os.listdir(tag))
    assert "manifest.json" in names and "mp_rank_00_model_states.pt" in names
    assert [n for n in names if n.startswith("layer_")] == [
        "layer_{:02d}-model_00-model_states.pt".format(i)
        for i in range(LAYERS)]
    with open(os.path.join(results["d"]["port"], "latest")) as f:
        assert f.read().strip() == "global_step1"
    saver = results["ranks"][0]["saver"]
    resumed = results["ranks"][0]["v2_resume"]
    assert resumed["loaded"][:2] == (True, 7)
    assert resumed["loaded"][2]["parts"] == saver["parts"] == [0, 3, 5]


def test_port_tag_loads_into_jax(results):
    saver = results["ranks"][0]["saver"]
    ev, master = results["port_in_jax"]
    assert J.rel([ev], saver["evals"]) <= J.LOSS_TOL["fp32"]
    # the JAX engine's masters after the load, against the port's run
    # that loaded the same tag at the same layout (v = 2)
    loaded = results["ranks"][0]["v2_resume"]["masters"][0]
    got = J.real_leaves(master, results["layout2"]["parts"], 2)
    want = J.real_leaves(loaded, results["layout2"]["parts"], 2)
    for key in want:
        assert np.abs(got[key] - want[key]).max() <= J.MASTER_ATOL, key


def test_jax_tag_loads_into_port(results):
    got = results["ranks"][0]["from_jax"]
    assert got["loaded"][0]
    assert J.rel(got["evals"], [results["jax_eval"]]) <= J.LOSS_TOL["fp32"]
    assert J.rel(got["losses"], [results["jax_next"]]) <= J.LOSS_TOL["fp32"]


@pytest.mark.parametrize("pair", [("saver", "v2_resume"),
                                  ("zsaver", "zresume")])
def test_resume_at_other_layout_bit_equal(results, pair):
    ranks = results["zranks"] if pair[0].startswith("z") else \
        results["ranks"]
    kept, resumed = ranks[0][pair[0]], ranks[0][pair[1]]
    assert resumed["loaded"][0]
    assert resumed["evals"] == kept["evals"]
    assert resumed["losses"] == kept["losses"][1:], (resumed["losses"],
                                                     kept["losses"])
    a = J.real_leaves(kept["master"], kept["parts"], 1)
    b = J.real_leaves(resumed["master"], resumed["parts"], 2)
    for key in a:
        assert np.array_equal(a[key], b[key]), key


def test_zero_tag_loads_into_jax(results):
    kept = results["zranks"][0]["zsaver"]
    assert J.rel([results["zero_in_jax"]], kept["evals"]) <= \
        J.LOSS_TOL["bf16"]
