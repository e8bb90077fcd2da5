"""The port's LR schedules and data loader against the JAX package's, on
the CPU.

``runtime/lr_schedules.py`` and ``runtime/dataloader.py`` are copies of
the JAX package's pure-Python modules: every class and function of the
originals has the same source in the copy. Each case of
``tests/unit/test_lr_schedulers.py`` runs in both packages over each
package's own optimizer handle, and the learning rate and momentum
(``betas``) they write must be equal at every step (pure Python: equal,
not close), with the original test's assertions on the port's side. The
schedule through the engine: the ds_config ``scheduler`` section of each
type drives the port's engine as it drives the JAX engine (a linear
model, fp32: losses 1e-6 relative, learning rates equal).
"""
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.ops.adam.fused_adam import FusedAdam as JAdam
from deepspeed_tpu.runtime import dataloader as jloader
from deepspeed_tpu.runtime import lr_schedules as jsched
from deepspeed_tpu.runtime.model import Model
from deepspeed_tpu_torch.ops.adam import FusedAdam as TAdam
from deepspeed_tpu_torch.ops.lamb import FusedLamb as TLamb
from deepspeed_tpu_torch.ops.sgd import SGD as TSGD
from deepspeed_tpu_torch.runtime import dataloader as tloader
from deepspeed_tpu_torch.runtime import lr_schedules as tsched

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)


@pytest.mark.parametrize("pair", [(jsched, tsched), (jloader, tloader)],
                         ids=["lr_schedules", "dataloader"])
def test_copies_have_the_originals_source(pair):
    original, copy = pair
    names = [n for n, obj in vars(original).items()
             if (inspect.isclass(obj) or inspect.isfunction(obj)) and
             obj.__module__ == original.__name__]
    assert names
    for name in names:
        assert inspect.getsource(getattr(copy, name)) == \
            inspect.getsource(getattr(original, name)), name
    consts = [n for n in dir(original) if n.isupper()]
    for name in consts:
        got = getattr(copy, name)
        want = getattr(original, name)
        if name == "SCHEDULE_CLASSES":
            assert {k: v.__name__ for k, v in got.items()} == \
                {k: v.__name__ for k, v in want.items()}
        else:
            assert got == want, name


def test_schedule_registry():
    assert set(tsched.SCHEDULE_CLASSES) == {"LRRangeTest", "OneCycle",
                                            "WarmupLR", "WarmupDecayLR"}
    assert tsched.get_lr_schedule_class("WarmupLR") is tsched.WarmupLR
    with pytest.raises(ValueError):
        tsched.get_lr_schedule_class("Nope")


# (schedule, kwargs, steps): tests/unit/test_lr_schedulers.py's cases
CASES = {
    "lr_range_test_continuous": ("LRRangeTest", dict(
        lr_range_test_min_lr=1e-4, lr_range_test_step_size=10,
        lr_range_test_step_rate=1.0), 20),
    "lr_range_test_staircase": ("LRRangeTest", dict(
        lr_range_test_min_lr=1e-4, lr_range_test_step_size=5,
        lr_range_test_step_rate=1.0, lr_range_test_staircase=True), 10),
    "one_cycle_up_down": ("OneCycle", dict(
        cycle_min_lr=1e-4, cycle_max_lr=1e-2, cycle_first_step_size=10), 20),
    "one_cycle_momentum_cycle": ("OneCycle", dict(
        cycle_min_lr=1e-4, cycle_max_lr=1e-2, cycle_first_step_size=10,
        cycle_min_mom=0.85, cycle_max_mom=0.99), 20),
    "one_cycle_decay": ("OneCycle", dict(
        cycle_min_lr=1e-4, cycle_max_lr=1e-2, cycle_first_step_size=4,
        decay_lr_rate=0.5, decay_step_size=2, decay_mom_rate=0.1), 16),
    "warmup_lr_then_constant": ("WarmupLR", dict(
        warmup_min_lr=0.0, warmup_max_lr=1e-2, warmup_num_steps=10), 15),
    "warmup_decay_lr": ("WarmupDecayLR", dict(
        total_num_steps=20, warmup_min_lr=0.0, warmup_max_lr=1e-2,
        warmup_num_steps=10), 20),
}


def _run(module, opt, name, kwargs, steps):
    sched = module.SCHEDULE_CLASSES[name](opt, **kwargs)
    lrs, betas, moms = [], [], []
    for _ in range(steps):
        sched.step()
        lrs.append(opt.lr)
        betas.append(tuple(opt.betas))
        moms.append(sched.get_mom() if hasattr(sched, "get_mom") else None)
    return sched, lrs, betas, moms


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("handle", [TAdam, TLamb, TSGD],
                         ids=["adam", "lamb", "sgd"])
def test_schedules_equal_the_jax_package_step_by_step(case, handle):
    name, kwargs, steps = CASES[case]
    _, j_lrs, j_betas, j_moms = _run(jsched, JAdam(lr=1e-3), name, kwargs,
                                     steps)
    opt = handle(lr=1e-3)
    sched, lrs, betas, moms = _run(tsched, opt, name, kwargs, steps)
    assert lrs == j_lrs
    assert moms == j_moms
    if handle is not TSGD:          # SGD's betas start at (momentum, 0)
        assert betas == j_betas
    # the original test's own assertions, on the port's side
    if case == "lr_range_test_continuous":
        assert lrs[0] >= 1e-4 and all(b >= a for a, b in zip(lrs, lrs[1:]))
        np.testing.assert_allclose(lrs[9], 1e-4 * 2.0, rtol=1e-6)
    elif case == "lr_range_test_staircase":
        assert len(set(np.round(lrs[:4], 10))) == 1
        assert len(set(np.round(lrs[4:9], 10))) == 1
        assert lrs[4] > lrs[0] and lrs[9] > lrs[4]
    elif case == "one_cycle_up_down":
        assert 8 <= int(np.argmax(lrs)) <= 11
        np.testing.assert_allclose(max(lrs), 1e-2, rtol=1e-5)
        assert lrs[-1] < 1e-2
    elif case == "one_cycle_momentum_cycle":
        assert 8 <= int(np.argmin([m[0][0] for m in moms])) <= 11
        # the momentum reaches Adam's and LAMB's betas, which
        # hyperparams() reads at the next step (SGD reads its own
        # momentum, as the JAX package's SGD does)
        if handle is not TSGD:
            assert opt.hyperparams()["beta1"] == float(betas[-1][0])
    elif case == "warmup_lr_then_constant":
        assert lrs[0] < lrs[5] < lrs[9]
        np.testing.assert_allclose(lrs[10:], 1e-2, rtol=1e-6)
    elif case == "warmup_decay_lr":
        assert int(np.argmax(lrs)) in (9, 10)
        assert lrs[-1] < lrs[10]
    assert opt.hyperparams()["lr"] == float(lrs[-1])


def test_state_dict_roundtrip():
    opt = TAdam(lr=1e-3)
    sched = tsched.WarmupLR(opt, warmup_max_lr=1e-2, warmup_num_steps=10)
    for _ in range(4):
        sched.step()
    sd = sched.state_dict()
    opt2 = TAdam(lr=1e-3)
    sched2 = tsched.WarmupLR(opt2, warmup_max_lr=1e-2, warmup_num_steps=10)
    sched2.load_state_dict(sd)
    sched.step()
    sched2.step()
    assert sched.get_last_lr() == sched2.get_last_lr()
    assert opt.lr == opt2.lr


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(4, 2))

    def forward(self, x, y):
        return ((x @ self.w - y) ** 2).mean()


@pytest.mark.parametrize("name,params", [
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2}),
    ("WarmupLR", {"warmup_max_lr": 1e-2, "warmup_num_steps": 5}),
    ("WarmupDecayLR", {"warmup_max_lr": 1e-2, "warmup_num_steps": 5,
                       "total_num_steps": 20}),
])
def test_schedulers_through_engine(name, params):
    """The ds_config scheduler section steps once per batch, in the port
    as in the JAX engine (reference engine.py:465-480), through forward,
    backward and step."""
    config = {
        "train_batch_size": 8,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "scheduler": {"type": name, "params": params},
    }
    rng = np.random.RandomState(3)
    x = rng.randn(8, 4).astype(np.float32)
    y = rng.randn(8, 2).astype(np.float32)
    je, _, _, jsch = deepspeed_tpu.initialize(
        model=Model(lambda p, x, y: jnp.mean((x @ p["w"] - y) ** 2),
                    {"w": jnp.zeros((4, 2))}),
        config_params=config)
    te, _, _, tsch = deepspeed_tpu_torch.initialize(
        model=_Linear(), config_params=config, device="cpu")
    assert type(tsch).__name__ == name and tsch is te.lr_scheduler
    runs = []
    for engine, arrays in ((je, (jnp.asarray(x), jnp.asarray(y))),
                           (te, (x, y))):
        lrs, losses = [], []
        for _ in range(4):
            lrs.append(engine.get_lr()[0])
            loss = engine(*arrays)
            engine.backward(loss)
            engine.step()
            losses.append(float(loss.detach() if hasattr(loss, "detach")
                                else loss))
        runs.append((lrs, losses, engine.get_mom()))
    assert runs[1][0] == runs[0][0]
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=1e-6)
    assert [tuple(b) for b in runs[1][2]] == [tuple(b) for b in runs[0][2]]
    assert te.lr_scheduler.last_batch_iteration == \
        je.lr_scheduler.last_batch_iteration == 3
