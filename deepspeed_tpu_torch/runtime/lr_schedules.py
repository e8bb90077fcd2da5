"""LR schedules: LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR.

A copy of ``deepspeed_tpu/runtime/lr_schedules.py`` (pure Python; the
reference is DeepSpeed's ``deepspeed/runtime/lr_schedules.py``, :301,
:408, :677, :761). A schedule steps once per optimizer step that is not
skipped and writes ``lr`` (and OneCycle's momentum, ``betas``) onto the
optimizer handle, whose ``hyperparams()`` the engine reads at the next
step.
"""
import math
from argparse import ArgumentParser

from ..utils.logging import logger

LR_SCHEDULE = "lr_schedule"
LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]

LR_RANGE_TEST_MIN_LR = "lr_range_test_min_lr"
LR_RANGE_TEST_STEP_RATE = "lr_range_test_step_rate"
LR_RANGE_TEST_STEP_SIZE = "lr_range_test_step_size"
LR_RANGE_TEST_STAIRCASE = "lr_range_test_staircase"

CYCLE_MIN_LR = "cycle_min_lr"
CYCLE_MAX_LR = "cycle_max_lr"
DECAY_LR_RATE = "decay_lr_rate"
CYCLE_FIRST_STEP_SIZE = "cycle_first_step_size"
CYCLE_FIRST_STAIR_COUNT = "cycle_first_stair_count"
CYCLE_SECOND_STEP_SIZE = "cycle_second_step_size"
CYCLE_SECOND_STAIR_COUNT = "cycle_second_stair_count"
DECAY_STEP_SIZE = "decay_step_size"
CYCLE_MIN_MOM = "cycle_min_mom"
CYCLE_MAX_MOM = "cycle_max_mom"
DECAY_MOM_RATE = "decay_mom_rate"

WARMUP_MIN_LR = "warmup_min_lr"
WARMUP_MAX_LR = "warmup_max_lr"
WARMUP_NUM_STEPS = "warmup_num_steps"
TOTAL_NUM_STEPS = "total_num_steps"


def add_tuning_arguments(parser):
    """CLI args for schedule tuning (reference :54-154)."""
    group = parser.add_argument_group("Convergence Tuning",
                                      "Convergence tuning configurations")
    group.add_argument("--lr_schedule", type=str, default=None,
                       help="LR schedule for training.")
    group.add_argument("--lr_range_test_min_lr", type=float, default=0.001,
                       help="Starting lr value.")
    group.add_argument("--lr_range_test_step_rate", type=float, default=1.0,
                       help="scaling rate for LR range test.")
    group.add_argument("--lr_range_test_step_size", type=int, default=1000,
                       help="training steps per LR change.")
    group.add_argument("--lr_range_test_staircase", type=bool, default=False,
                       help="use staircase scaling for LR range test.")
    group.add_argument("--cycle_first_step_size", type=int, default=1000,
                       help="size of first step of 1Cycle schedule (training steps).")
    group.add_argument("--cycle_first_stair_count", type=int, default=-1,
                       help="first stair count for 1Cycle schedule.")
    group.add_argument("--cycle_second_step_size", type=int, default=-1,
                       help="size of second step of 1Cycle schedule (default first_step_size).")
    group.add_argument("--cycle_second_stair_count", type=int, default=-1,
                       help="second stair count for 1Cycle schedule.")
    group.add_argument("--decay_step_size", type=int, default=1000,
                       help="size of intervals for applying post cycle decay (training steps).")
    group.add_argument("--cycle_min_lr", type=float, default=0.01,
                       help="1Cycle LR lower bound.")
    group.add_argument("--cycle_max_lr", type=float, default=0.1,
                       help="1Cycle LR upper bound.")
    group.add_argument("--decay_lr_rate", type=float, default=0.0,
                       help="post cycle LR decay rate.")
    group.add_argument("--cycle_momentum", type=bool, default=False,
                       help="enable 1Cycle momentum schedule.")
    group.add_argument("--cycle_min_mom", type=float, default=0.8,
                       help="1Cycle momentum lower bound.")
    group.add_argument("--cycle_max_mom", type=float, default=0.9,
                       help="1Cycle momentum upper bound.")
    group.add_argument("--decay_mom_rate", type=float, default=0.0,
                       help="post cycle momentum decay rate.")
    group.add_argument("--warmup_min_lr", type=float, default=0,
                       help="WarmupLR minimum/initial LR value.")
    group.add_argument("--warmup_max_lr", type=float, default=0.001,
                       help="WarmupLR maximum LR value.")
    group.add_argument("--warmup_num_steps", type=int, default=1000,
                       help="WarmupLR step count for LR warmup.")
    return parser


def parse_arguments():
    parser = ArgumentParser()
    parser = add_tuning_arguments(parser)
    lr_sched_args, unknown_args = parser.parse_known_args()
    return lr_sched_args, unknown_args


class _ScheduleBase:
    """Common machinery: tracks last_batch_iteration, pushes lr to the
    optimizer handle (any object with a mutable ``lr`` attribute)."""

    def __init__(self, optimizer, last_batch_iteration=-1):
        self.optimizer = optimizer
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self):
        raise NotImplementedError

    def get_last_lr(self):
        assert getattr(self, "_last_lr", None) is not None, \
            "need to call step() first"
        return self._last_lr

    def _update_optimizer(self, lrs):
        if self.optimizer is not None:
            self.optimizer.lr = lrs[0]

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        lrs = self.get_lr()
        self._update_optimizer(lrs)
        self._last_lr = list(lrs)

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class LRRangeTest(_ScheduleBase):
    """LR range test (Smith): grow lr from a base at a constant rate
    (reference :301)."""

    def __init__(self, optimizer, lr_range_test_min_lr=1e-3,
                 lr_range_test_step_size=2000, lr_range_test_step_rate=1.0,
                 lr_range_test_staircase=False, last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        if isinstance(lr_range_test_min_lr, (list, tuple)):
            lr_range_test_min_lr = lr_range_test_min_lr[0]
        self.min_lr = [lr_range_test_min_lr]
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        if last_batch_iteration == -1:
            self._update_optimizer(self.min_lr)

    def _interval(self):
        frac = float(self.last_batch_iteration + 1) / self.step_size
        return math.floor(frac) if self.staircase else frac

    def get_lr(self):
        increase = 1 + self.step_rate * self._interval()
        return [lr * increase for lr in self.min_lr]


class OneCycle(_ScheduleBase):
    """1Cycle schedule: lr rises then falls over one cycle, optional inverse
    momentum cycle, then post-cycle decay (reference :408)."""

    def __init__(self, optimizer, cycle_min_lr, cycle_max_lr, decay_lr_rate=0.0,
                 cycle_first_step_size=2000, cycle_second_step_size=None,
                 cycle_first_stair_count=0, cycle_second_stair_count=None,
                 decay_step_size=0, cycle_momentum=True, cycle_min_mom=0.8,
                 cycle_max_mom=0.9, decay_mom_rate=0.0,
                 last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        first = float(cycle_first_step_size)
        second = float(cycle_second_step_size
                       if cycle_second_step_size is not None else first)
        self.total_size = first + second
        self.step_ratio = first / self.total_size
        self.decay_step_size = decay_step_size

        self.min_lrs = [cycle_min_lr]
        self.max_lrs = [cycle_max_lr]
        self.decay_lr_rate = decay_lr_rate

        self.cycle_momentum = cycle_momentum
        self.min_moms = [(cycle_min_mom, 0.99)]
        self.max_moms = [(cycle_max_mom, 0.99)]
        self.decay_mom_rate = decay_mom_rate

        if last_batch_iteration == -1:
            self._update_optimizer(self.min_lrs)
            if cycle_momentum and self.optimizer is not None:
                self.optimizer.betas = self.min_moms[0]

    def _get_scale_factor(self):
        batch_iteration = self.last_batch_iteration + 1
        cycle = math.floor(1 + batch_iteration / self.total_size)
        x = 1.0 + batch_iteration / self.total_size - cycle
        if x <= self.step_ratio:
            return x / self.step_ratio
        return (x - 1) / (self.step_ratio - 1)

    def _get_cycle_lr(self):
        scale = self._get_scale_factor()
        return [min_lr + (max_lr - min_lr) * scale
                for min_lr, max_lr in zip(self.min_lrs, self.max_lrs)]

    def _get_decay_lr(self, decay_batch_iteration):
        decay_interval = decay_batch_iteration / max(self.decay_step_size, 1)
        factor = 1 + self.decay_lr_rate * decay_interval
        return [min_lr / factor for min_lr in self.min_lrs]

    def _get_cycle_mom(self):
        scale = self._get_scale_factor()
        return [(max_m[0] - (max_m[0] - min_m[0]) * scale, min_m[1])
                for min_m, max_m in zip(self.min_moms, self.max_moms)]

    def _get_decay_mom(self, decay_batch_iteration):
        decay_interval = decay_batch_iteration / max(self.decay_step_size, 1)
        factor = 1 + self.decay_mom_rate * decay_interval
        return [(beta0 * factor, beta1) for beta0, beta1 in self.max_moms]

    def get_lr(self):
        if self.last_batch_iteration < self.total_size:
            return self._get_cycle_lr()
        return self._get_decay_lr(self.last_batch_iteration - self.total_size + 1)

    def get_mom(self):
        if not self.cycle_momentum:
            return None
        if self.last_batch_iteration < self.total_size:
            return self._get_cycle_mom()
        return self._get_decay_mom(self.last_batch_iteration - self.total_size + 1)

    def step(self, batch_iteration=None):
        super().step(batch_iteration)
        if self.cycle_momentum and self.optimizer is not None:
            self.optimizer.betas = self.get_mom()[0]


class WarmupLR(_ScheduleBase):
    """Log-warmup from min lr to max lr over warmup_num_steps, then constant
    (reference :677)."""

    def __init__(self, optimizer, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        if isinstance(warmup_min_lr, (list, tuple)):
            warmup_min_lr = warmup_min_lr[0]
        if isinstance(warmup_max_lr, (list, tuple)):
            warmup_max_lr = warmup_max_lr[0]
        self.min_lrs = [warmup_min_lr]
        self.max_lrs = [warmup_max_lr]
        self.delta_lrs = [warmup_max_lr - warmup_min_lr]
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

    def _get_gamma(self):
        if self.last_batch_iteration < self.warmup_num_steps:
            return self.inverse_log_warm_up * math.log(
                self.last_batch_iteration + 1)
        return 1.0

    def get_lr(self):
        if self.last_batch_iteration < 0:
            logger.warning("Attempting to get learning rate from scheduler "
                           "before it has started")
            return [0.0]
        gamma = self._get_gamma()
        return [min_lr + (delta * gamma)
                for min_lr, delta in zip(self.min_lrs, self.delta_lrs)]


class WarmupDecayLR(WarmupLR):
    """WarmupLR followed by linear decay to 0 at total_num_steps
    (reference :761)."""

    def __init__(self, optimizer, total_num_steps, warmup_min_lr=0.0,
                 warmup_max_lr=0.001, warmup_num_steps=1000,
                 last_batch_iteration=-1):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr,
                         warmup_num_steps, last_batch_iteration)
        if self.total_num_steps < self.warmup_num_steps:
            logger.warning(
                "total_num_steps {} is less than warmup_num_steps {}".format(
                    total_num_steps, warmup_num_steps))

    def _get_gamma(self):
        if self.last_batch_iteration < self.warmup_num_steps:
            return self.inverse_log_warm_up * math.log(
                self.last_batch_iteration + 1)
        return max(
            0.0,
            float(self.total_num_steps - self.last_batch_iteration) /
            float(max(1.0, self.total_num_steps - self.warmup_num_steps)))


SCHEDULE_CLASSES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
}


def get_lr_schedule_class(name):
    if name not in SCHEDULE_CLASSES:
        raise ValueError("{} is not a valid LR schedule, valid: {}".format(
            name, VALID_LR_SCHEDULES))
    return SCHEDULE_CLASSES[name]
