"""The model contract of streamed parameter offload.

Port of ``deepspeed_tpu/runtime/model.py::StreamSpec``. The port's models
are ``nn.Module``\\ s whose ``forward(*batch)`` returns the loss (the JAX
package's ``Model`` pairs an apply function with a params tree); a model
that can train with ``zero_optimization.cpu_offload_params`` also exposes
``stream_spec``, a :class:`StreamSpec` (GPT-2:
``models/gpt2.py::stream_spec_for``).
"""


class StreamSpec:
    """Layer-group decomposition contract for streamed parameter offload
    (``zero_optimization.cpu_offload_params``; runtime/zero/stream.py).

    A model that can be trained beyond device memory exposes its forward
    as three segments the runner streams parameters into one layer group
    at a time:

      ``split(params) -> (embed_tree, [block_tree, ...], head_tree)``
        Restructure ``params``, ``{state_dict name: value}``, into an
        embedding segment, per-layer block segments and a head segment,
        each a ``{key: value}`` dict. Values must be the given dict's
        objects: a tied weight appearing in two segments (GPT-2's ``wte``
        in embed and head) must be the SAME object, so the runner sums
        both gradient contributions and steps the master once.
      ``embed_apply(embed_tree, batch, seed, train) -> x``
      ``block_apply(block_tree, x, seed, train) -> x``      (one layer)
      ``head_apply(head_tree, x, batch, seed, train) -> loss``  (fp32
        scalar)

    ``batch`` is the full input tuple the engine received (the spec picks
    what each segment needs, e.g. ids for embed, labels for head); ``seed``
    is the layer's dropout seed or None. The composition
    ``head(blocks(embed(batch)))`` must equal the model's ``forward`` loss
    so the streamed step matches the monolithic one.
    """

    def __init__(self, split, embed_apply, block_apply, head_apply):
        self.split = split
        self.embed_apply = embed_apply
        self.block_apply = block_apply
        self.head_apply = head_apply
