"""DeepSpeed-TPU ported to PyTorch and CUDA.

The port of ``deepspeed_tpu`` (the JAX package, which stays the
reference) to PyTorch on an NVIDIA H100. Module paths mirror the JAX
package's; every kernel the JAX package wrote in Pallas becomes a
kernel written by hand for Hopper. The port imports nothing of JAX or
of ``deepspeed_tpu``.

This slice serves GPT-2 from a slot or paged KV cache through
:func:`init_inference`, with paged-attention decode in a CUDA kernel
(``ops/paged_attention``). Training comes with a later slice.
"""
from .version import __version__

from .utils.logging import logger, log_dist


def init_inference(model=None, config=None, mp_size=1, mesh=None,
                   dtype=None, seed=0, device=None):
    """Initialize the inference engine.

    Mirrors ``deepspeed_tpu.init_inference``. Returns an
    :class:`deepspeed_tpu_torch.inference.InferenceEngine` with a
    preallocated slot or paged KV cache and a continuous-batching
    scheduler (``engine.generate(prompts)``).

    ``model`` is a :class:`deepspeed_tpu_torch.models.gpt2.GPT2Model`
    (``models.gpt2.make_gpt2_model``); the engine serves a copy of its
    weights in the serving dtype. ``config`` is a ds_config dict or JSON
    path whose ``inference`` section is read as in the JAX package.
    ``device`` defaults to the current CUDA device and raises when CUDA
    is absent; only an explicit ``device="cpu"`` runs on the CPU.
    Tensor parallelism (``mp_size > 1`` or a ``mesh``) comes with a
    later slice and raises ``NotImplementedError``.
    """
    from .inference.engine import InferenceEngine

    assert model is not None, "init_inference requires a model"
    if mp_size != 1 or mesh is not None:
        raise NotImplementedError(
            "tensor-parallel serving (mp_size > 1 or a mesh) is not ported "
            "yet: it comes with the tensor-parallel serving slice")
    log_dist("DeepSpeedTPUTorch inference info: version={}".format(
        __version__), ranks=[0])
    return InferenceEngine(model, config=config, dtype=dtype, seed=seed,
                           device=device)
