"""Progressive Layer Dropping.

Copy of ``deepspeed_tpu/runtime/progressive_layer_drop.py`` (reference
``deepspeed/runtime/progressive_layer_drop.py``). Keep-prob
theta(t) = (1 - theta_bar) * exp(-gamma * t) + theta_bar, updated per global
step and passed into the model forward as a kwarg when the forward takes it.
"""
import numpy as np

from ..utils.logging import log_dist


class ProgressiveLayerDrop(object):
    def __init__(self, theta=0.5, gamma=0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0
        log_dist("Enabled progressive layer dropping (theta = {})".format(
            self.theta), ranks=[0])

    def get_state(self):
        kwargs = {"progressive_layer_drop": True, "pld_theta": self.get_theta()}
        return kwargs

    def get_theta(self):
        return self.current_theta

    def update_state(self, global_step):
        def _prob(x, gamma, p):
            return (1.0 - p) * np.exp(-gamma * x) + p

        self.current_theta = _prob(global_step, self.gamma, self.theta)
