"""GPT-2 as a PipelineModule — the Megatron-GPT2 3D-parallel workload
(BASELINE config 5: PP x TP x ZeRO-DP).

Port of ``deepspeed_tpu/models/gpt2_pipe.py`` (reference parity:
DeepSpeedExamples Megatron GPT2PipelineModel). The layer list is the JAX
package's: the embedding as a TiedLayerSpec ``"embed"``, the blocks, the
final norm, and the embedding again with ``forward_fn=_head_forward`` as
the tied head. The first stage holds the embedding, the last stage holds
its own copy of it for the head; the engine sums the two copies'
gradients (the reference's ReduceTiedGrads) and keeps them equal bit for
bit.

Each block is the port's GPT-2 block (``models/gpt2.py::make_block_fn``):
on CUDA the fused LN + QKV + flash-attention op and the flash kernels,
under tensor parallelism (``comm.collective_matmul``) the ring GEMMs with
the flash kernels over the rank's heads; the residual stream between
stages then holds this rank's rows of the sequence, as in the dense TP
model. The embedding and the norm stay whole on every model rank, as the
JAX module keeps them (``EmbeddingLayer.partition_spec_fn`` is None).

The head is the tied table: the JAX package takes full logits ``h @
wte^T`` and ``causal_lm_cross_entropy``; the port's head computes the same
function through the dense model's loss (chunked over the sequence when
``loss_chunk`` divides it, as ``gpt2._head_loss``), so the full ``(b, s,
vocab)`` logits never exist.

Weights: ``make_gpt2_pipeline(seed=s)`` loads each rank's layers from the
dense model's seeded numpy init (``gpt2.init_params(config, s)``), so a
pipeline and the dense one-rank engine of one seed start from the same
weights. The JAX pipeline draws its embedding with ``jax.random``
(``gpt2_pipe.py:30-38``), so its start cannot be reproduced without JAX;
the CPU tests carry the JAX module's weights across instead
(``PipelineModule.load_pipe_tree``). ``seed=None`` draws each layer from
the torch RNG seeded per layer (the same distributions; only the rank's
own layers are drawn).
"""
import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn

from ..runtime.pipe.module import LayerSpec, PipelineModule, TiedLayerSpec
from . import gpt2
from .gpt2 import GPT2Config, config_for


def _replace(config, **changes):
    return dataclasses.replace(config, **changes)


class EmbeddingLayer(nn.Module):
    """wte + wpe lookup; pre-pipeline (hoisted, tied key 'embed'). Under a
    tensor-parallel binding it returns this rank's rows of the
    sequence."""

    def __init__(self, config, init=True):
        super().__init__()
        self.config = config
        d = config.d_model
        self.wte = nn.Parameter(torch.empty(config.vocab_size, d,
                                            dtype=config.dtype))
        self.wpe = nn.Parameter(torch.empty(config.max_seq_len, d,
                                            dtype=config.dtype))
        if init and not self.wte.is_meta:
            with torch.no_grad():
                nn.init.normal_(self.wte, std=0.02)
                nn.init.normal_(self.wpe, std=0.01)

    @staticmethod
    def partition_spec_fn(path, shape):
        # whole on every model rank, as the JAX module keeps it
        return None

    def tensor_parallel_shard(self, binding):
        with torch.device(self.wte.device):
            out = EmbeddingLayer(_replace(self.config,
                                          collective_matmul=binding),
                                 init=False)
        with torch.no_grad():
            out.load_state_dict(self.state_dict())
        return out

    def forward(self, input_ids):
        rows = gpt2._local_rows(input_ids.shape[-1],
                                gpt2._tp_binding(self.config))
        dtype = self.wpe.dtype
        return (self.wte[input_ids[:, rows]] + self.wpe[rows]).to(dtype)


class GPT2BlockLayer(gpt2._Block):
    """One transformer block (the dense model's parameter names and
    block); the homogeneous pipelined body."""

    def __init__(self, config, init=True, tp=1):
        super().__init__(config.d_model, None, config.dtype, tp)
        self.config = config
        if init and not self.ln1.scale.is_meta:
            # Megatron init with the full depth's residual scaling
            # (gpt2.init_block_params' distributions), drawn from the torch
            # RNG
            std = 0.02
            proj_std = std / math.sqrt(2.0 * config.n_layers)
            with torch.no_grad():
                for name, p in self.named_parameters():
                    if name.endswith("scale"):
                        p.fill_(1.0)
                    elif name.endswith("bias"):
                        p.zero_()
                    else:
                        p.normal_(0.0, proj_std if "proj_kernel" in name
                                  else std)

    partition_spec_fn = staticmethod(gpt2.partition_spec_fn)
    tp_shard_state_dict = staticmethod(gpt2.tp_shard_state_dict)
    tp_gather_state_dicts = staticmethod(gpt2.tp_gather_state_dicts)
    tp_full_boxes = staticmethod(gpt2.tp_full_boxes)

    def tensor_parallel_shard(self, binding):
        p = self.ln1.scale
        with torch.device(p.device):
            out = GPT2BlockLayer(_replace(self.config,
                                          collective_matmul=binding),
                                 init=False, tp=binding.size)
        out.to(p.dtype)
        with torch.no_grad():
            out.load_state_dict(gpt2.tp_shard_state_dict(
                self.state_dict(), binding.rank, binding.size))
        return out

    def forward(self, x, seed=None):
        if gpt2._tp_binding(self.config) is not None and self.training \
                and self.config.dropout > 0.0:
            raise NotImplementedError(
                "dropout under tensor parallelism is not ported yet: the "
                "sequence-sharded masks come with a later slice")
        return gpt2.make_block_fn(self.config, self.training, x.device)(
            x, self, seed)


class FinalNorm(nn.Module):
    """Final layernorm; post-pipeline."""

    def __init__(self, config):
        super().__init__()
        d = config.d_model
        self.scale = nn.Parameter(torch.ones(d, dtype=config.dtype))
        self.bias = nn.Parameter(torch.zeros(d, dtype=config.dtype))

    def forward(self, x):
        return gpt2._layer_norm(x, self.scale, self.bias)


class TiedHeadOutput(NamedTuple):
    """The tied head's output: the final hidden states and the table the
    loss multiplies them by (the logits are made chunk by chunk in the
    loss)."""
    hidden: torch.Tensor
    wte: torch.Tensor
    config: GPT2Config


def _head_forward(tied, hidden):
    """Tied output head: logits = h @ wte^T (made inside the loss)."""
    return TiedHeadOutput(hidden, tied.wte, tied.config)


def lm_loss_fn(out, labels):
    """Causal-LM cross-entropy of the head's output (mean over tokens):
    the dense model's head loss, or under a tensor-parallel binding its
    ring form (this rank's rows, the sum over the ring)."""
    if not isinstance(out, TiedHeadOutput):
        return gpt2.causal_lm_cross_entropy(out, labels)
    binding = gpt2._tp_binding(out.config)
    if binding is not None:
        return gpt2._tp_lm_loss(out.hidden, out.wte, labels, out.config,
                                binding)
    return gpt2._head_loss(out.hidden, out.wte, labels, out.config)


def dense_stage_state(module, dense):
    """This stage's parameters from the dense model's JAX tree
    (``gpt2.init_params``'s): the tied embedding from ``wte`` / ``wpe``,
    the final norm from ``ln_f``, body layer g of the stage from
    ``blocks[g]``."""
    state = {}
    for name, _ in module.named_parameters():
        head, rest = name.split(".", 1)
        if head == "tied":
            state[name] = dense[rest.split(".", 1)[1]]
        elif head == "post":
            state[name] = dense["ln_f"][rest.split(".", 1)[1]]
        else:
            c, j, inner = rest.split(".", 2)
            node = dense["blocks"][module.body_ids(int(c))[int(j)]]
            for key in inner.split("."):
                node = node[key]
            state[name] = node
    return state


def make_gpt2_pipeline(config=None, size="gpt2_small", num_stages=2,
                       num_dp=None, num_mp=None, topology=None,
                       activation_checkpoint_interval=1,
                       num_virtual_stages=1, save_stage_residuals=False,
                       seed=0, partition_method="parameters", stage_id=None,
                       **overrides):
    """GPT-2 as a :class:`PipelineModule` of this rank's stage (the JAX
    package's ``make_gpt2_pipeline``). ``seed`` (default 0): the dense
    model's seeded numpy init (``gpt2.init_params``), so the pipeline
    starts from the weights ``gpt2.make_gpt2_model(seed=seed)`` has; None:
    each layer's own draw.

    ``activation_checkpoint_interval``: 0 keeps no activations for
    recompute beyond what the pipeline does (its backward re-runs the
    stage from the saved input unless ``save_stage_residuals``); 1 (the
    JAX default) checkpoints each block as the dense model's ``remat``
    does (the flash-attention op outside the checkpoint, the rest
    recomputed); N > 1 checkpoints every N blocks as one piece.
    ``stage_id`` builds that stage outside a process group (tests)."""
    if config is None:
        config = config_for(size, **overrides)
    interval = int(activation_checkpoint_interval or 0)
    config = _replace(config, remat=interval == 1)
    assert config.n_layers >= num_stages * num_virtual_stages, \
        "num_stages*num_virtual_stages ({}) exceeds n_layers ({})".format(
            num_stages * num_virtual_stages, config.n_layers)
    init = seed is None
    layers = [TiedLayerSpec("embed", EmbeddingLayer, config, init=init)]
    layers += [LayerSpec(GPT2BlockLayer, config, init=init)
               for _ in range(config.n_layers)]
    layers += [LayerSpec(FinalNorm, config),
               TiedLayerSpec("embed", EmbeddingLayer, config, init=init,
                             forward_fn=_head_forward)]

    net = PipelineModule(
        layers=layers, num_stages=num_stages, topology=topology,
        loss_fn=lm_loss_fn, num_dp=num_dp, num_mp=num_mp,
        partition_method=partition_method,
        activation_checkpoint_interval=interval if interval > 1 else 0,
        num_virtual_stages=num_virtual_stages,
        save_stage_residuals=save_stage_residuals, stage_id=stage_id)
    net.config = config
    if seed is not None:
        net.load_stage_state(dense_stage_state(
            net, gpt2.init_params(config, seed=seed)))
    return net
