"""FP16_Optimizer: the standalone mixed-precision wrapper.

Port of ``deepspeed_tpu/runtime/fp16/fused_optimizer.py`` (``FP16_Optimizer``,
``FP16_UnfusedOptimizer``; reference DeepSpeed's fused_optimizer.py :17 and
unfused_optimizer.py :17), for users who drive an optimizer handle
directly, outside the engine. The same surface: fp32 master copies of the
(half) parameters, the static or dynamic loss scaler
(``runtime/fp16/loss_scaler.py``), overflow check -> unscale -> clip ->
the base optimizer's step, skipped on overflow, and
``state_dict``/``load_state_dict``. As in the JAX package it is
functional: ``step(grads, params)`` takes the scaled gradients of
``params`` (dicts, possibly nested, of tensors) and returns the new
params in their own dtypes and the overflow flag.

The masters and moments live in flat buffers, one segment per leaf, as
the engine keeps them (``runtime/zero/partition.py``), so the base
optimizer's ``step_flat`` runs once over all of them: FusedAdam's kernel
launches once, FusedLamb takes one trust ratio per leaf. The fused and
unfused names are one class, as in the JAX package.
"""
import torch

from ...ops.adam.fused_adam import _tree_map
from ..utils import CheckOverflow, clip_grad_norm_
from ..zero.partition import ALIGN
from . import loss_scaler as ls


def _leaves(tree):
    """The tensors of a dict/list tree, in its order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for child in tree for x in _leaves(child)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure over the next items of the iterator
    ``leaves``."""
    return _tree_map(lambda _: next(leaves), tree)


class FP16_Optimizer:
    """Functional mixed-precision wrapper around a port optimizer handle
    (``FusedAdam``, ``FusedLamb``, ``SGD``: anything with
    ``hyperparams()`` and ``step_flat``)."""

    def __init__(self, init_optimizer, static_loss_scale=1.0,
                 dynamic_loss_scale=False, initial_dynamic_scale=2 ** 32,
                 dynamic_loss_args=None, verbose=False, mpu=None,
                 clip_grad=0.0, fused_adam_legacy=False):
        self.optimizer = init_optimizer
        self.clip_grad = clip_grad
        args = dynamic_loss_args or {}
        if dynamic_loss_scale:
            self.scaler = ls.create_loss_scaler(
                static_loss_scale=None,
                init_scale=args.get("init_scale", initial_dynamic_scale),
                scale_window=args.get("scale_window", 1000),
                min_scale=args.get("min_scale", 1.0),
                delayed_shift=args.get("delayed_shift", 1))
        else:
            self.scaler = ls.create_loss_scaler(
                static_loss_scale=static_loss_scale)
        self.overflow = False
        self._master = None

    # -- state ---------------------------------------------------------------
    def initialize_state(self, params):
        """fp32 masters (one flat buffer; ``self._master`` is the tree of
        its views) and the base optimizer's zero moments, from ``params``
        (a tree of tensors of any float dtype)."""
        leaves = _leaves(params)
        device = leaves[0].device
        offsets, total = [], 0
        for t in leaves:
            offsets.append(total)
            total += -(-t.numel() // ALIGN) * ALIGN
        self._shapes = [tuple(t.shape) for t in leaves]
        self._offsets = offsets
        self._segments = torch.tensor(
            [[off, t.numel()] for off, t in zip(offsets, leaves)],
            dtype=torch.int64, device=device).reshape(-1, 2)
        moments = getattr(self.optimizer, "moments_dtype", torch.float32)
        self._flat = torch.zeros(total, dtype=torch.float32, device=device)
        self._m = torch.zeros(total, dtype=moments, device=device)
        self._v = torch.zeros(total, dtype=moments, device=device)
        self._step = 0
        self._tree = params
        self._master = self._views(self._flat)
        for view, t in zip(_leaves(self._master), leaves):
            view.copy_(t.detach())
        return self._master

    def _views(self, flat):
        return _rebuild(self._tree, iter(
            flat[off:off + (int(torch.Size(shape).numel()))].view(shape)
            for off, shape in zip(self._offsets, self._shapes)))

    def _load(self, flat, tree):
        for view, t in zip(_leaves(self._views(flat)), _leaves(tree)):
            view.copy_(torch.as_tensor(t).reshape(view.shape))

    @property
    def loss_scale(self):
        return float(self.scaler.cur_scale)

    @property
    def cur_scale(self):
        return self.scaler.cur_scale

    # -- the reference's backward(loss) half: scale ---------------------------
    def scale_loss(self, loss):
        """The loss times the current scale, to differentiate (reference
        backward() :181-186)."""
        return loss * self.scaler.cur_scale

    # -- step -----------------------------------------------------------------
    def step(self, grads, params):
        """Overflow check -> unscale -> clip -> base step -> recast.

        ``grads`` are the SCALED gradients of ``params`` (any float dtype,
        the same tree). Returns ``(new_params, overflow)``: the masters cast
        to each param's dtype (the old values where the step overflowed).
        The masters and moments are kept here (reference step :33-132)."""
        if self._master is None:
            self.initialize_state(params)
        g = torch.zeros_like(self._flat)
        self._load(g, grads)
        overflow = bool(CheckOverflow.has_overflow(g))
        g.mul_(1.0 / self.scaler.cur_scale)
        if self.clip_grad > 0:
            clip_grad_norm_(g, self.clip_grad)
        if not overflow:
            self.optimizer.step_flat(self._flat, g, self._m, self._v,
                                     self._step + 1, segments=self._segments)
            self._step += 1
        self.scaler = ls.update_scale(self.scaler, overflow)
        self.overflow = overflow
        new_params = _rebuild(params, iter(
            m.to(p.dtype).clone() for m, p in zip(_leaves(self._master),
                                                  _leaves(params))))
        return new_params, self.overflow

    # -- checkpoint -----------------------------------------------------------
    def state_dict(self):
        clone = lambda flat: _rebuild(self._tree, iter(
            t.clone() for t in _leaves(self._views(flat))))
        return {
            "dynamic_loss_scale": self.scaler.dynamic,
            "cur_scale": float(self.scaler.cur_scale),
            "cur_iter": int(self.scaler.cur_iter),
            "last_overflow_iter": int(self.scaler.last_overflow_iter),
            "cur_hysteresis": int(self.scaler.cur_hysteresis),
            "optimizer_state_dict": {"step": self._step,
                                     "exp_avg": clone(self._m),
                                     "exp_avg_sq": clone(self._v)},
            "fp32_groups_flat": clone(self._flat),
            "clip_grad": self.clip_grad,
        }

    def load_state_dict(self, sd, load_optimizer_states=True):
        # the full scaler schedule state must survive resume: growth window
        # keys off last_overflow_iter, overflow response off hysteresis
        self.scaler = self.scaler._replace(
            cur_scale=float(sd["cur_scale"]), cur_iter=int(sd["cur_iter"]),
            last_overflow_iter=int(sd.get("last_overflow_iter", -1)),
            cur_hysteresis=int(sd.get("cur_hysteresis",
                                      self.scaler.delayed_shift)))
        self.clip_grad = sd.get("clip_grad", self.clip_grad)
        master = sd.get("fp32_groups_flat")
        if master is not None:
            if self._master is None:
                self.initialize_state(master)
            self._load(self._flat, master)
        opt = sd.get("optimizer_state_dict")
        if load_optimizer_states and opt is not None and \
                self._master is not None:
            self._load(self._m, opt["exp_avg"])
            self._load(self._v, opt["exp_avg_sq"])
            self._step = int(opt["step"])


# Per-tensor-master variant needed for LAMB in the reference
# (unfused_optimizer.py): the same class here, one segment per leaf.
FP16_UnfusedOptimizer = FP16_Optimizer
