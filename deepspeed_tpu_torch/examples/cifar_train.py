"""CIFAR-style classifier on the PyTorch/CUDA port: the twin of
``examples/cifar/train.py`` (reference DeepSpeedExamples/cifar,
BASELINE config 1's shape).

Run:
  python -m deepspeed_tpu_torch.examples.cifar_train \
      --deepspeed_config examples/cifar/ds_config.json
(add ``--device cpu`` without a GPU). The data is synthetic and
CIFAR-shaped, as in the JAX example; the model is its two-layer MLP with
the same weights from ``RandomState(seed)``. The config's ``scheduler``
section (WarmupLR) steps the learning rate; ``training_data=`` makes the
engine's loader, which shuffles as the JAX package's does.
"""
import argparse

import numpy as np
import torch
from torch import nn

import deepspeed_tpu_torch as deepspeed
from deepspeed_tpu_torch.models._tree import (  # noqa: F401 (engine's)
    optimizer_state_from_jax, optimizer_state_to_jax, params_from_jax,
    params_to_jax)

D_IN, D_HIDDEN, CLASSES = 3 * 32 * 32, 256, 10


class SyntheticCifar:
    """(3, 32, 32) images, 10 classes (the JAX example's, same seed)."""

    def __init__(self, n=2048, seed=0):
        rs = np.random.RandomState(seed)
        self.x = rs.randn(n, 3, 32, 32).astype(np.float32)
        self.y = rs.randint(0, 10, size=(n,))

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


class CifarMLP(nn.Module):
    """tanh MLP 3072 -> 256 -> 10 whose forward returns the mean
    cross-entropy, as the JAX example's ``apply_fn``."""

    def __init__(self, seed=0):
        super().__init__()
        rs = np.random.RandomState(seed)
        draw = lambda *shape: torch.from_numpy(
            (rs.randn(*shape) * (1.0 / np.sqrt(shape[0])))
            .astype(np.float32))
        self.w1 = nn.Parameter(draw(D_IN, D_HIDDEN))
        self.b1 = nn.Parameter(torch.zeros(D_HIDDEN))
        self.w2 = nn.Parameter(draw(D_HIDDEN, CLASSES))
        self.b2 = nn.Parameter(torch.zeros(CLASSES))

    def forward(self, x, y):
        h = torch.tanh(x.reshape(x.shape[0], -1) @ self.w1 + self.b1)
        logp = torch.log_softmax(h @ self.w2 + self.b2, dim=-1)
        return -logp.gather(-1, y.long()[:, None]).mean()


def make_model(seed=0):
    return CifarMLP(seed)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--samples", type=int, default=2048,
                        help="synthetic dataset size")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current GPU)")
    parser = deepspeed.add_config_arguments(parser)
    return parser.parse_args(argv)


def main(argv=None):
    """Train as the JAX example does; returns the per-step losses and
    learning rates (the rate each step ran at)."""
    args = parse_args(argv)
    engine, _, loader, _ = deepspeed.initialize(
        args=args, model=make_model(),
        training_data=SyntheticCifar(n=args.samples),
        config_params=args.deepspeed_config, device=args.device)
    losses, lrs = [], []
    for epoch in range(args.epochs):
        for x, y in loader:
            lrs.append(engine.get_lr()[0])
            loss = engine(x, y)
            engine.backward(loss)
            engine.step()
            losses.append(float(loss.detach()))
        print("epoch {} loss {:.4f}".format(epoch, losses[-1]))
    return {"losses": losses, "lrs": lrs, "engine": engine}


if __name__ == "__main__":
    main()
