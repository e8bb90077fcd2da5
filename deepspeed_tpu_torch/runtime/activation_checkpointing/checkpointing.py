"""Activation checkpointing: recompute a function's activations in the
backward instead of keeping them.

Port of ``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``
(itself the reference's ``deepspeed.checkpointing``): the same module
options, ``configure``, ``checkpoint`` / ``checkpoint_wrapper`` and the
RNG tracker, over PyTorch autograd:

* :func:`checkpoint` runs ``torch.utils.checkpoint.checkpoint(...,
  use_reentrant=False)``: the function's inputs are kept, its activations
  recomputed in the backward, the RNG state restored for the recompute so
  dropout redraws the same masks;
* ``cpu_checkpointing`` keeps the saved inputs in host memory until the
  backward;
* ``partition_activations`` under tensor parallelism (an ``mpu`` with a
  model-parallel group, or a mesh with a ``model`` axis > 1): each model
  rank keeps 1/mp of every saved input's last dimension and the recompute
  all-gathers them over the model group: the reference's partitioned
  checkpoints, which the JAX package expresses as a sharding constraint
  on the saved residuals' last dimension. A last dimension that does not
  divide by mp is kept whole;
* ``synchronize_checkpoint_boundary`` synchronizes the device after the
  forward, ``profile`` times it (``timers("forward")``);
  ``contiguous_memory_optimization`` and ``number_checkpoints`` are
  accepted and checked as in the JAX package (the caching allocator owns
  activation memory).

The RNG tracker keeps named ``torch.Generator`` streams: ``fork`` yields
the stream's generator, which advances as it is drawn from.
"""
import contextlib
import functools
import os

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from ...parallel.topology import MODEL_AXIS
from ...utils.distributed import all_gather
from ...utils.logging import logger
from ...utils.timer import SynchronizedWallClockTimer

# --------------------------------------------------------------------------
# module-level option state (reference :43-56)
# --------------------------------------------------------------------------
PARTITION_ACTIVATIONS = False
CPU_CHECKPOINT = False
CONTIGUOUS_CHECKPOINTING = False
SYNCHRONIZE = False
PROFILE_TIME = False

num_layers = None
mp_size = 1
mpu = None

deepspeed_checkpointing_enabled = False

timers = None


# --------------------------------------------------------------------------
# RNG state tracking (reference CudaRNGStatesTracker :150-266)
# --------------------------------------------------------------------------
_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"


class RNGStatesTracker:
    """Named random streams, each a ``torch.Generator`` on ``device``.

    The reference forks and restores the CUDA RNG state; here every stream
    is an explicit generator, so forking one leaves the default generator
    untouched. ``get_states`` / ``set_states`` carry the generators'
    states (ByteTensors)."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def get_states(self):
        return {name: gen.get_state() for name, gen in self.states_.items()}

    def set_states(self, states):
        for name, state in states.items():
            if name not in self.states_:
                self.states_[name] = torch.Generator(device=self.device)
            self.states_[name].set_state(state)

    def add(self, name, seed):
        if seed in self.seeds_:
            raise Exception("seed {} already exists".format(seed))
        self.seeds_.add(seed)
        if name in self.states_:
            raise Exception("state {} already exists".format(name))
        self.states_[name] = torch.Generator(
            device=self.device).manual_seed(seed)

    @contextlib.contextmanager
    def fork(self, name=_MODEL_PARALLEL_RNG_TRACKER_NAME):
        """Yield the named stream's generator (it advances as drawn)."""
        if name not in self.states_:
            raise Exception("state {} does not exist".format(name))
        yield self.states_[name]


_CUDA_RNG_STATE_TRACKER = RNGStatesTracker()


def get_cuda_rng_tracker():
    """Reference API name kept (checkpointing.py:240); returns the tracker."""
    return _CUDA_RNG_STATE_TRACKER


def model_parallel_cuda_manual_seed(seed, tp_rank=0, device=None):
    """Seed the default + model-parallel streams (reference :243-266) on
    ``device`` (the current CUDA device unless given; raises without
    CUDA). Data-parallel stream = ``seed``; model-parallel stream offset by
    2718 + tp_rank so TP ranks draw different dropout on sliced
    activations."""
    from ...inference.engine import resolve_device
    model_parallel_seed = seed + 2718 + tp_rank
    _CUDA_RNG_STATE_TRACKER.reset()
    _CUDA_RNG_STATE_TRACKER.device = resolve_device(device)
    _CUDA_RNG_STATE_TRACKER.add("default", seed)
    _CUDA_RNG_STATE_TRACKER.add(_MODEL_PARALLEL_RNG_TRACKER_NAME,
                                model_parallel_seed)


# --------------------------------------------------------------------------
# the checkpointed call
# --------------------------------------------------------------------------
def _model_group():
    """The model-parallel group of ``mpu`` (a Megatron-style mpu, an
    object with a ``.mesh``, or a ProcessMesh), or None at mp 1."""
    if mpu is None or not dist.is_initialized():
        return None
    if hasattr(mpu, "get_model_parallel_group"):
        group = mpu.get_model_parallel_group()
    else:
        mesh = getattr(mpu, "mesh", mpu)
        if int(mesh.shape.get(MODEL_AXIS, 1)) < 2:
            return None
        group = mesh.get_group(MODEL_AXIS)
    if group is None or dist.get_world_size(group) < 2:
        return None
    return group


def _devices(tensors):
    return sorted({t.device for t in tensors if t.device.type == "cuda"},
                  key=str)


class _CheckpointFunction(torch.autograd.Function):
    """The reference's ``CheckpointFunction`` for the options that move or
    cut the saved inputs: the forward runs without a graph and keeps each
    tensor input (this rank's 1/mp of its last dimension under
    ``group``, in host memory with ``to_cpu``); the backward restores
    them (all-gathered over ``group``), recomputes under the forward's
    RNG state and back-propagates."""

    @staticmethod
    def forward(ctx, run_function, group, to_cpu, *args):
        ctx.run_function = run_function
        ctx.group = group
        tensors = [a for a in args if torch.is_tensor(a)]
        ctx.cpu_rng = torch.get_rng_state()
        ctx.cuda_devices = _devices(tensors)
        ctx.cuda_rng = [torch.cuda.get_rng_state(d) for d in
                        ctx.cuda_devices]
        world = dist.get_world_size(group) if group is not None else 1
        rank = dist.get_rank(group) if group is not None else 0
        saved, ctx.layout = [], []
        for a in args:
            if not torch.is_tensor(a):
                ctx.layout.append((False, a))
                continue
            keep = a.detach()
            split = world > 1 and keep.dim() > 0 and \
                keep.shape[-1] % world == 0
            if split:
                keep = keep.chunk(world, dim=-1)[rank].contiguous()
            if to_cpu:
                keep = keep.to("cpu", copy=True)
            ctx.layout.append((True, (split, a.device, a.requires_grad)))
            saved.append(keep)
        ctx.save_for_backward(*saved)
        with torch.no_grad():
            return run_function(*args)

    @staticmethod
    def backward(ctx, *grads):
        saved = iter(ctx.saved_tensors)
        inputs = []
        for is_tensor, info in ctx.layout:
            if not is_tensor:
                inputs.append(info)
                continue
            split, device, requires_grad = info
            t = next(saved).to(device)
            if split:
                t = all_gather(t, ctx.group, dim=t.dim() - 1)
            inputs.append(t.detach().requires_grad_(requires_grad))
        with torch.random.fork_rng(devices=ctx.cuda_devices):
            torch.set_rng_state(ctx.cpu_rng)
            for device, state in zip(ctx.cuda_devices, ctx.cuda_rng):
                torch.cuda.set_rng_state(state, device)
            with torch.enable_grad():
                outputs = ctx.run_function(*inputs)
        if torch.is_tensor(outputs):
            outputs = (outputs,)
        pairs = [(o, g) for o, g in zip(outputs, grads)
                 if torch.is_tensor(o) and o.requires_grad]
        torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
        return (None, None, None) + tuple(
            x.grad if torch.is_tensor(x) else None for x in inputs)


def checkpoint(function, *args):
    """Recompute-in-backward wrapper (reference ``checkpoint()`` :706):
    returns ``function(*args)`` without keeping its activations; the
    backward recomputes them."""
    if PROFILE_TIME and timers is not None:
        timers("forward").start()
    group = _model_group() if PARTITION_ACTIVATIONS else None
    if group is not None or CPU_CHECKPOINT:
        out = _CheckpointFunction.apply(function, group, CPU_CHECKPOINT,
                                        *args)
    else:
        out = _torch_checkpoint(function, *args, use_reentrant=False)
    if SYNCHRONIZE:
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for device in _devices([o for o in outs if torch.is_tensor(o)]):
            torch.cuda.synchronize(device)
    if PROFILE_TIME and timers is not None:
        timers("forward").stop()
    return out


def checkpoint_wrapper(function):
    """Decorator form: ``fn = checkpoint_wrapper(fn)``."""
    @functools.wraps(function)
    def wrapped(*args):
        return checkpoint(function, *args)
    return wrapped


# --------------------------------------------------------------------------
# configuration surface (reference :706-877)
# --------------------------------------------------------------------------
def set_num_layers(nlayers):
    global num_layers
    num_layers = nlayers


def reset():
    """Reference ``reset()``: clears contiguous buffers; nothing to clear
    here (the caching allocator owns activation memory)."""


def partition_activations_in_checkpoint(partition_activation):
    global PARTITION_ACTIVATIONS
    PARTITION_ACTIVATIONS = partition_activation
    if PARTITION_ACTIVATIONS:
        logger.info("**************Partition Activations {}************".
                    format(PARTITION_ACTIVATIONS))


def configure(mpu_=None,
              deepspeed_config=None,
              partition_activations=None,
              contiguous_checkpointing=None,
              num_checkpoints=None,
              checkpoint_in_cpu=None,
              synchronize=None,
              profile=None):
    """Configure module options (reference ``configure()`` :788-867).

    Explicit kwargs override values from ``deepspeed_config`` (a parsed
    DeepSpeedConfig, a ds_config dict, or a JSON path)."""
    global mpu, num_layers, deepspeed_checkpointing_enabled, timers
    global PARTITION_ACTIVATIONS, CONTIGUOUS_CHECKPOINTING, \
        CPU_CHECKPOINT, SYNCHRONIZE, PROFILE_TIME

    deepspeed_checkpointing_enabled = True
    mpu = mpu_

    if deepspeed_config is not None:
        from ..config import DeepSpeedConfig
        if isinstance(deepspeed_config, dict):
            deepspeed_config = DeepSpeedConfig(None,
                                               param_dict=deepspeed_config)
        elif isinstance(deepspeed_config, (str, os.PathLike)):
            deepspeed_config = DeepSpeedConfig(str(deepspeed_config))
        cfg = deepspeed_config.activation_checkpointing_config
        PARTITION_ACTIVATIONS = cfg.partition_activations
        CONTIGUOUS_CHECKPOINTING = cfg.contiguous_memory_optimization
        num_layers = cfg.number_checkpoints
        CPU_CHECKPOINT = cfg.cpu_checkpointing
        SYNCHRONIZE = cfg.synchronize_checkpoint_boundary
        PROFILE_TIME = cfg.profile

    if partition_activations is not None:
        PARTITION_ACTIVATIONS = partition_activations
    if contiguous_checkpointing is not None:
        CONTIGUOUS_CHECKPOINTING = contiguous_checkpointing
    if num_checkpoints is not None:
        num_layers = num_checkpoints
    if checkpoint_in_cpu is not None:
        CPU_CHECKPOINT = checkpoint_in_cpu
    if synchronize is not None:
        SYNCHRONIZE = synchronize
    if profile is not None:
        PROFILE_TIME = profile

    if PROFILE_TIME and timers is None:
        timers = SynchronizedWallClockTimer()

    if CONTIGUOUS_CHECKPOINTING:
        assert num_layers is not None, \
            "Must specify the number of checkpoints with contiguous memory " \
            "optimization"
    if CONTIGUOUS_CHECKPOINTING and not PARTITION_ACTIVATIONS:
        raise ValueError("Contiguous memory optimization requires partitioned "
                         "activations")


def is_configured():
    """True once ``configure()`` has been called (reference :870)."""
    return deepspeed_checkpointing_enabled
