"""DeepSpeed-TPU ported to PyTorch and CUDA.

The port of ``deepspeed_tpu`` (the JAX package, which stays the
reference) to PyTorch on an NVIDIA H100. Module paths mirror the JAX
package's; every kernel the JAX package wrote in Pallas becomes a
kernel written by hand for Hopper. The port imports nothing of JAX or
of ``deepspeed_tpu``.

Two entry points, as in the JAX package:

* :func:`initialize` trains a model (GPT-2 through its
  ``forward(input_ids, labels)`` loss, BERT through its MLM + NSP
  pretraining loss, ``models.bert``) with ZeRO stages 0-2 at world size
  1, bf16/fp16 mixed precision over fp32 master weights and Adam/AdamW or
  LAMB; flash attention (``ops/transformer/flash_attention.py``, BERT's
  non-causal with the key-padding mask as a key bias), the Adam apply
  (``ops/adam``) and LAMB (``ops/lamb``) run in CUDA kernels, and with the
  ds_config ``sparse_attention`` section (``GPT2Config(sparse_attention=
  engine.sparse_attention_config())``) attention runs block-sparse over
  the section's layout in CUDA kernels (``ops/sparse_attention``);
* :func:`init_inference` serves GPT-2 from a slot or paged KV cache, with
  paged-attention decode in a CUDA kernel (``ops/paged_attention``).
"""
from .version import __version__

from .utils.logging import logger, log_dist
from .models import bert, make_bert_model, make_bert_squad_model


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, device=None):
    """Initialize the training engine.

    Mirrors ``deepspeed_tpu.initialize``: returns ``(engine, optimizer,
    None, lr_scheduler)`` with a
    :class:`deepspeed_tpu_torch.runtime.engine.DeepSpeedEngine`, whose
    ``train_batch(batch=(ids, labels))`` (or ``engine(ids, labels)``,
    ``engine.backward(loss)``, ``engine.step()``) trains ``model``, an
    ``nn.Module`` whose forward returns the loss
    (``models.gpt2.make_gpt2_model``, ``models.bert.make_bert_model``).
    ``config`` / ``config_params`` is
    a ds_config dict or JSON path. ``device`` defaults to the current
    CUDA device and raises when CUDA is absent; only an explicit
    ``device="cpu"`` runs on the CPU. The model's parameters move into
    the engine's flat buffers on that device.
    """
    from .runtime.engine import DeepSpeedEngine

    assert model is not None, "deepspeed.initialize requires a model"
    log_dist("DeepSpeedTPUTorch info: version={}".format(__version__),
             ranks=[0])
    if config is None and config_params is not None:
        config = config_params
    engine = DeepSpeedEngine(args=args, model=model, optimizer=optimizer,
                             model_parameters=model_parameters,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler, mpu=mpu,
                             dist_init_required=dist_init_required,
                             collate_fn=collate_fn, config_params=config,
                             device=device)
    return engine, engine.optimizer, engine.training_dataloader, \
        engine.lr_scheduler


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
