"""Static and dynamic loss scaling.

Port of ``deepspeed_tpu/runtime/fp16/loss_scaler.py`` (``create_loss_scaler``,
``loss_scaler_from_config``, ``update_scale``). The JAX package keeps the
scaler inside its jitted step and updates it branchlessly; the port's
engine reads the step's overflow flag on the host (one value per step), so
the state here is a small immutable record of Python numbers and
:func:`update_scale` is the same rule written with ``if``:

  * overflow: if hysteresis is spent, scale = max(scale / factor,
    min_scale); otherwise hysteresis -= 1;
  * ``scale_window`` consecutive clean steps: scale *= factor and
    hysteresis resets to ``delayed_shift``.
"""
from typing import NamedTuple

INITIAL_LOSS_SCALE = "init_scale"
SCALE_WINDOW = "scale_window"
DELAYED_SHIFT = "delayed_shift"
MIN_LOSS_SCALE = "min_scale"


class LossScalerState(NamedTuple):
    cur_scale: float
    cur_hysteresis: int
    last_overflow_iter: int
    cur_iter: int
    dynamic: bool
    scale_factor: float
    scale_window: int
    delayed_shift: int
    min_scale: float


def create_loss_scaler(static_loss_scale=None, init_scale=2 ** 32,
                       scale_factor=2.0, scale_window=1000, min_scale=1.0,
                       delayed_shift=1):
    """Initial scaler state. ``static_loss_scale`` > 0 disables dynamics."""
    dynamic = static_loss_scale is None or static_loss_scale == 0
    return LossScalerState(
        cur_scale=float(init_scale if dynamic else static_loss_scale),
        cur_hysteresis=int(delayed_shift), last_overflow_iter=-1, cur_iter=0,
        dynamic=dynamic, scale_factor=float(scale_factor),
        scale_window=int(scale_window), delayed_shift=int(delayed_shift),
        min_scale=float(min_scale))


def loss_scaler_from_config(config):
    """From a DeepSpeedConfig's fp16 block (static 1.0 without fp16)."""
    if not getattr(config, "fp16_enabled", False):
        return create_loss_scaler(static_loss_scale=1.0)
    if config.loss_scale and config.loss_scale > 0:
        return create_loss_scaler(static_loss_scale=config.loss_scale)
    args = config.dynamic_loss_scale_args or {}
    return create_loss_scaler(
        static_loss_scale=None,
        init_scale=args.get(INITIAL_LOSS_SCALE, config.initial_dynamic_scale),
        scale_window=args.get(SCALE_WINDOW, 1000),
        min_scale=args.get(MIN_LOSS_SCALE, 1.0),
        delayed_shift=args.get(DELAYED_SHIFT, 1))


def update_scale(state, has_overflow):
    """One scaler step after an optimizer step with ``has_overflow``."""
    if not state.dynamic:
        return state._replace(cur_iter=state.cur_iter + 1)
    if has_overflow:
        spent = state.delayed_shift == 1 or state.cur_hysteresis <= 1
        if spent:
            scale = max(state.cur_scale / state.scale_factor,
                        state.min_scale)
            hysteresis = state.cur_hysteresis
        else:
            scale, hysteresis = state.cur_scale, state.cur_hysteresis - 1
        return state._replace(cur_scale=scale, cur_hysteresis=hysteresis,
                              last_overflow_iter=state.cur_iter,
                              cur_iter=state.cur_iter + 1)
    scale, hysteresis = state.cur_scale, state.cur_hysteresis
    if (state.cur_iter - state.last_overflow_iter) % state.scale_window == 0:
        scale, hysteresis = scale * state.scale_factor, state.delayed_shift
    return state._replace(cur_scale=scale, cur_hysteresis=hysteresis,
                          cur_iter=state.cur_iter + 1)
