"""The port's PipelineEngine on its own (gloo ranks on the CPU; no JAX
engine runs here):

* the refused combinations raise as in the JAX package: ZeRO stage 2 and
  3 with PP x TP (PipelineError, "not a certified combination"),
  elasticity with PP (PipelineError), the micro API (``forward``,
  ``backward``, ``step``: PipelineError); ZeRO stage 3 under PP builds
  (one stage in one process keeps every leaf whole: no gathers);
* fp16: an overflow forced on the first stage only (an inf in its
  gradients) makes every stage skip the step: the skipped count, the
  halved loss scale, and master weights and tied copies unchanged on
  every rank;
* memory flat in M: the bytes autograd holds for the backward peak at the
  same value with M = 4 and M = 8 micro-batches (within 10%), in the
  default recompute backward and with ``save_stage_residuals`` (more on
  the first stage, which keeps up to three graphs, and still flat), and
  the stash never holds more than the schedule's buffer slots;
* ``initialize`` returns a PipelineEngine; ``data_iter`` feeds it as
  ``batch=`` does;
* point-to-point (``utils.distributed``): a send and its receive; two
  ranks that send to each other in one matched batch; one pipeline
  ``Hop`` moving an activation forward and a gradient back over the
  stage pair's group.
"""
import numpy as np
import pytest

import torch_pipe_jax as J
import deepspeed_tpu_torch
from deepspeed_tpu_torch.pipe import PipelineEngine, PipelineError
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_pipe_workers as workers

pytestmark = pytest.mark.torch_port

MICRO = 2


def _gpt2(M=2, **kw):
    return dict(dict(S=2, dp=1, prec="bf16", M=M, micro=MICRO,
                     gpt2=dict(J.GPT2, n_layers=2), actions=[]), **kw)


def test_refused_combinations():
    confs = [("z2", _gpt2(tp=2, stage=2)), ("z3", _gpt2(tp=2, stage=3)),
             ("z1", _gpt2(tp=2, stage=1))]
    out = spawn(workers.refused_rank, 4, args=({"confs": confs},),
                timeout_s=240)
    for r in out:
        for name in ("z2", "z3"):
            kind, msg = r[name]
            assert kind == "PipelineError" and "not a certified" in msg, \
                r[name]
        assert r["z1"] is None, r["z1"]


def test_refused_in_process():
    """One stage in one process (no process group needed)."""
    run = _gpt2(S=1)
    with pytest.raises(PipelineError, match="[Ee]lasticity"):
        deepspeed_tpu_torch.initialize(
            model=workers.build(run), device="cpu",
            config_params=dict(workers.config(run), elasticity={
                "enabled": True, "max_train_batch_size": 64,
                "micro_batch_sizes": [2], "min_gpus": 1, "max_gpus": 8}))
    staged, _, _, _ = deepspeed_tpu_torch.initialize(
        model=workers.build(run), device="cpu",
        config_params=workers.config(dict(run, stage=3)))
    assert isinstance(staged, PipelineEngine) and staged.zero3 is None
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=workers.build(run), config_params=workers.config(run),
        device="cpu")
    assert isinstance(engine, PipelineEngine)
    for call in (lambda: engine.forward(np.zeros((2, 32))),
                 lambda: engine.backward(None), engine.step):
        with pytest.raises(PipelineError):
            call()
    batch = J.gpt2_batch(2, MICRO, seed=11)
    loss = float(engine.train_batch(data_iter=iter(zip(*batch))))
    assert np.isfinite(loss)
    with pytest.raises(ValueError, match="micro-batches"):
        engine.train_batch(batch=tuple(x[:1] for x in batch))


def test_fp16_overflow_on_one_stage_skips_every_stage():
    batch = J.gpt2_batch(2, MICRO, seed=12)
    run = _gpt2(prec="fp16", fp16={"initial_scale_power": 8, "hysteresis": 1},
                actions=[("train", batch, 1),
                         ("overflow_on_stage", 0, batch)])
    ranks = spawn(workers.pipe_rank, 2, args=({"runs": [("fp16", run)]},),
                  timeout_s=240)
    for r in ranks:
        o = r["fp16"]["overflow"]
        assert o["skipped"] == 1, o
        assert o["scale"][1] == o["scale"][0] / 2, o
        assert o["master_unchanged"] and o["tied_unchanged"], o


def test_memory_flat_in_micro_batches():
    runs = []
    for save in (False, True):
        for M in (4, 8):
            batch = J.gpt2_batch(M, MICRO, seed=13)
            runs.append(("{}_{}".format(save, M),
                         _gpt2(M=M, prec="fp32", save=save, aci=0,
                               gpt2=dict(J.GPT2, n_layers=4),
                               actions=[("saved_bytes", batch)])))
    ranks = spawn(workers.pipe_rank, 2, args=({"runs": runs},),
                  timeout_s=240)
    for r in ranks:
        peaks = {name: r[name]["saved_peak"][0] for name, _ in runs}
        for save in (False, True):
            p4, p8 = peaks["{}_4".format(save)], peaks["{}_8".format(save)]
            assert p4 > 0 and p8 <= 1.10 * p4, peaks
            for M in (4, 8):
                stats = r["{}_{}".format(save, M)]["stats"]
                assert stats["peak_stash"] <= stats["buffer_slots"], stats
        # the first stage keeps up to buffer_slots graphs when it saves
        # them, so they cost more there (still bounded); the last stage
        # runs each micro-batch's backward in its forward's cycle
        if r["True_4"]["stage"] == 0:
            assert peaks["True_4"] > 2 * peaks["False_4"], peaks
        else:
            assert peaks["True_4"] == peaks["False_4"], peaks


def test_point_to_point():
    out = spawn(workers.p2p_rank, 2, timeout_s=120)
    assert out[1]["recv"] == [0.0, 1.0, 2.0]
    assert out[0]["exchange"] == [110.0, 111.0, 112.0]
    assert out[1]["exchange"] == [100.0, 101.0, 102.0]
    assert out[0]["hop"] == [[-1.0, -1.0]] * 2
    assert out[1]["hop"] == [[1.0, 1.0]] * 2
