"""Plain SGD with momentum and weight decay.

Port of ``deepspeed_tpu/ops/sgd.py::SGD``, the engine's ``"type": "SGD"``.
The JAX package has no TPU kernel for it (XLA fuses its three lines), so
the port steps it in plain PyTorch over the engine's flat fp32 buffers:

  g' = g + weight_decay * p;  m' = momentum * m + g';  p' = p - lr * m'

``m`` is the state's ``exp_avg``; ``exp_avg_sq`` is kept (zeros, never
read) so the state has Adam's shape, as in the JAX package.
"""
import torch

from .adam.fused_adam import f32


class SGD:
    """Optimizer handle with mutable hyperparameters (read at each step),
    as ``deepspeed_tpu.ops.sgd.SGD``."""

    name = "sgd"
    supports_zero = True
    moments_dtype = torch.float32

    def __init__(self, lr=1e-3, momentum=0.0, weight_decay=0.0, **kwargs):
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.betas = (momentum, 0.0)

    def hyperparams(self):
        return {"lr": float(self.lr), "beta1": float(self.momentum),
                "beta2": 0.0, "eps": 0.0,
                "weight_decay": float(self.weight_decay)}

    def step_flat(self, p, g, m, v, step, segments=None, group=None,
                  sharded_from=0, dp_group=None):
        """One step over flat fp32 buffers (or one rank's range of them),
        in place (``v`` unused; SGD is elementwise, so the segments, the
        TP layout and the data group do not matter)."""
        h = self.hyperparams()
        g = g + f32(h["weight_decay"]) * p
        m.copy_(f32(h["beta1"]) * m + g)
        p.copy_(p - f32(h["lr"]) * m)
