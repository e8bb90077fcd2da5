"""``zero.Init``, ``GatheredParameters`` and
``register_external_parameter`` in the port: ``tests/unit/test_zero_
context.py``'s nine cases, on ``torch_zero3_workers.Linear`` (the JAX
cases' ``mean((x @ w - y) ** 2)`` model).

The cases that need a data group run in one spawn of two gloo ranks on
the CPU (``torch_zero3_workers.context_cases``); the others run here. The
JAX package's cases place leaves on a ``build_mesh(data=8)`` in one
process; the port's data group is two processes, so "sharded" reads: a
partitioned leaf is an empty placeholder with its shape in ``ds_shape``
and the rank's store holds 1/2 of it; a leaf under the persistence
threshold stays whole. The training case runs 60 steps at stage 3 and
must bring the loss under 0.2 of its start, as the JAX case does.
"""
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import zero
from deepspeed_tpu_torch.parallel.topology import build_mesh
from deepspeed_tpu_torch.utils.distributed import spawn

import torch_zero3_workers as workers

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def ranks():
    return spawn(workers.context_cases, 2, timeout_s=180)


def test_init_shards_params_at_construction(ranks):
    for rank in ranks:
        got = rank["sharded"]
        assert got["ds_sharded"]
        assert got["w_numel"] == 0 and got["w_shape"] == [128, 16]
        # the small leaf stays whole on every rank
        assert got["b_numel"] == 4 and got["persistent"] == ["b"]
        # the rank's pieces: half of w, and half of b's unit (b padded
        # to 2 x 64 elements)
        assert got["local"] == 128 * 16 // 2 + 64


def test_init_restores_model_ctor():
    ctor = torch.nn.Module.__init__
    with zero.Init(mesh=build_mesh(), device="cpu"):
        assert torch.nn.Module.__init__ is not ctor
    assert torch.nn.Module.__init__ is ctor
    model = workers.Linear(shapes=(("w", (16, 4)),))
    assert not getattr(model, "ds_sharded", False)


def test_init_disabled_is_noop():
    with zero.Init(mesh=build_mesh(), enabled=False):
        model = workers.Linear(shapes=(("w", (128, 16)),))
    assert not getattr(model, "ds_sharded", False)
    assert model.w.numel() == 128 * 16


def test_gathered_parameters_read_and_modify(ranks):
    for rank in ranks:
        np.testing.assert_array_equal(rank["read"], np.ones((64, 8)))
        # rank 0 (the modifier) wrote 7, rank 1 wrote 5: 7 everywhere
        np.testing.assert_array_equal(rank["after_modify"],
                                      np.full((64, 8), 7.0))
        assert rank["modified_numel"] == 0      # still partitioned


def test_gathered_parameters_no_modifier_discards(ranks):
    for rank in ranks:
        np.testing.assert_array_equal(rank["after_discard"],
                                      np.full((64, 8), 7.0))


def test_init_model_trains_through_engine(ranks):
    for rank in ranks:
        losses = rank["train"]["losses"]
        assert losses[-1] < 0.2 * losses[0], losses
        assert rank["train"]["gathers"] > 0


def test_gathered_parameters_plain_numpy_tree():
    tree = {"w": np.ones((4, 4), dtype=np.float32)}
    with zero.GatheredParameters(tree, modifier_rank=0) as full:
        full["w"][:] = 2.0
    np.testing.assert_allclose(np.asarray(tree["w"]), 2.0)


def test_init_remote_device_cpu_keeps_shard_layout(ranks):
    for rank in ranks:
        got = rank["remote"]
        assert got["device"] == "cpu"
        assert got["local"] == 64 * 8 // 2 and got["w_numel"] == 0


def test_register_external_parameter_noop():
    zero.register_external_parameter(object(), object())
    # the port's namespace is the JAX package's
    assert deepspeed_tpu_torch.zero.Init is zero.Init
