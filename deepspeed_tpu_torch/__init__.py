"""DeepSpeed-TPU ported to PyTorch and CUDA.

The port of ``deepspeed_tpu`` (the JAX package, which stays the
reference) to PyTorch on an NVIDIA H100. Module paths mirror the JAX
package's; every kernel the JAX package wrote in Pallas becomes a
kernel written by hand for Hopper. The port imports nothing of JAX or
of ``deepspeed_tpu``.

Two entry points, as in the JAX package:

* :func:`initialize` trains a model (GPT-2 through its
  ``forward(input_ids, labels)`` loss, BERT through its MLM + NSP
  pretraining loss, ``models.bert``) with ZeRO stages 0-2, on one device
  or data-parallel over ``torch.distributed`` (the flat state partitioned
  over the mesh's ``data`` axis), bf16/fp16 mixed precision over fp32
  master weights and Adam/AdamW or LAMB; flash attention (``ops/transformer/flash_attention.py``, BERT's
  non-causal with the key-padding mask as a key bias), the Adam apply
  (``ops/adam``) and LAMB (``ops/lamb``) run in CUDA kernels, and with the
  ds_config ``sparse_attention`` section (``GPT2Config(sparse_attention=
  engine.sparse_attention_config())``) attention runs block-sparse over
  the section's layout in CUDA kernels (``ops/sparse_attention``); with
  an ``mpu`` or ``mesh`` whose ``model`` axis is > 1 and the
  ``comm.collective_matmul`` section, GPT-2 trains tensor-parallel with
  its four TP matmuls as ring GEMMs (``parallel/collective_matmul.py``,
  per-step CUDA kernels in ``ops/ring_gemm``);
* :func:`init_inference` serves GPT-2 from a slot or paged KV cache, with
  paged-attention decode in a CUDA kernel (``ops/paged_attention``),
  speculative decoding (``inference.speculative``: n-gram or draft-model
  proposals checked by one verify pass, ``inference/speculative.py``)
  and tensor-parallel serving (``mp_size`` or a ``mesh``: each rank holds
  its heads of the KV cache and its shard of the weights).

Around them, the JAX package's single-device training surface: bf16
optimizer moments (``optimizer.params.moments_dtype``) in the Adam and
LAMB kernels, SGD, the ``scheduler`` section and the four LR schedules
(``runtime/lr_schedules.py``), ``initialize(optimizer=, lr_scheduler=,
training_data=, model_parameters=)``, ``FP16_Optimizer``
(``runtime/fp16/fused_optimizer.py``), :func:`add_config_arguments`, and
twins of the repo's two examples (``examples/cifar_train.py``,
``examples/gpt2_pretrain.py``); checkpoints in the JAX package's tag
format (``engine.save_checkpoint`` / ``load_checkpoint``, across
packages and layouts) and activation checkpointing
(:mod:`deepspeed_tpu_torch.checkpointing`, GPT-2's ``remat_policy``
"full" and "dots"); and token corpora in the JAX package's ``.bin`` /
``.idx`` format read by a native C++ reader with a prefetch thread
(``runtime/data``, ``ops/dataio.py``).
"""
from .version import __version__

from .utils.logging import logger, log_dist
from .models import bert, make_bert_model, make_bert_squad_model
from .runtime.activation_checkpointing import checkpointing
from . import zero


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, device=None, mesh=None):
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

    Tensor parallelism: inside a process group (``utils.distributed.
    init_distributed``, or ``torchrun``), an ``mpu`` with a model-parallel
    degree n > 1 (Megatron style, or an object with a ``.mesh``) or a
    ``mesh=parallel.topology.build_mesh(model=n)``, with the ds_config's
    ``comm.collective_matmul`` on, trains each rank's shard of ``model``
    (built whole on every rank from one seed) through the ring GEMMs.

    Data parallelism: inside a process group, the ``data`` axis of the
    mesh (``build_mesh(data=n)``, every rank by default, or ``data=d``
    beside ``model=m``) is the ZeRO data group: each rank passes its own
    micro batch's rows to ``train_batch`` and keeps its range of the
    master, moments (stage 1) and gradient accumulator (stage 2).

    Pipeline parallelism: ``model`` a :class:`deepspeed_tpu_torch.pipe.
    PipelineModule` (``models.gpt2_pipe.make_gpt2_pipeline``), built on
    every rank of the process group (each builds its own stage), returns a
    :class:`deepspeed_tpu_torch.pipe.PipelineEngine` over the module's own
    grid (``mpu`` must be None); ``train_batch(batch=(inputs, labels))``
    takes each stacked ``(gas, micro, ...)`` on every rank.
    """
    from .runtime.engine import DeepSpeedEngine
    from .runtime.pipe.engine import PipelineEngine
    from .runtime.pipe.module import PipelineModule

    assert model is not None, "deepspeed.initialize requires a model"
    log_dist("DeepSpeedTPUTorch info: version={}".format(__version__),
             ranks=[0])
    if config is None and config_params is not None:
        config = config_params
    if isinstance(model, PipelineModule):
        assert mpu is None, "mpu must be None with pipeline parallelism"
        assert mesh is None, "a PipelineModule brings its own mesh"
        engine = PipelineEngine(args=args, model=model, optimizer=optimizer,
                                model_parameters=model_parameters,
                                training_data=training_data,
                                lr_scheduler=lr_scheduler, mpu=model.mpu(),
                                dist_init_required=dist_init_required,
                                collate_fn=collate_fn, config_params=config,
                                device=device)
    else:
        engine = DeepSpeedEngine(
            args=args, model=model, optimizer=optimizer,
            model_parameters=model_parameters, training_data=training_data,
            lr_scheduler=lr_scheduler, mpu=mpu,
            dist_init_required=dist_init_required, collate_fn=collate_fn,
            config_params=config, device=device, mesh=mesh)
    return engine, engine.optimizer, engine.training_dataloader, \
        engine.lr_scheduler


def init_inference(model=None, config=None, mp_size=1, mesh=None,
                   dtype=None, seed=0, device=None, draft_model=None):
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

    ``draft_model`` supplies the small GPT-2 drafter that
    ``inference.speculative.method: "model"`` requires.

    Tensor parallelism: inside a process group (``utils.distributed.
    init_distributed``, or ``torchrun``), ``mp_size > 1`` builds
    ``parallel.topology.build_mesh(model=mp_size)`` over the default
    group (a world size that ``mp_size`` does not divide raises, and so
    does a missing group); a ``mesh`` is taken as given. Every rank
    calls this with the whole ``model`` (one seed) and the same prompts;
    each serves its shard and returns the same tokens.
    """
    import torch.distributed as dist
    from .inference.engine import InferenceEngine

    assert model is not None, "init_inference requires a model"
    log_dist("DeepSpeedTPUTorch inference info: version={}".format(
        __version__), ranks=[0])
    if mesh is None and mp_size > 1:
        from .parallel.topology import build_mesh
        if not dist.is_initialized():
            raise RuntimeError(
                "init_inference(mp_size={}) needs a process group: call "
                "utils.distributed.init_distributed (or run under "
                "torchrun) first".format(mp_size))
        world = dist.get_world_size()
        if world % mp_size:
            raise ValueError("mp_size {} does not divide the world size "
                             "{}".format(mp_size, world))
        mesh = build_mesh(data=world // mp_size, model=mp_size)
    return InferenceEngine(model, config=config, dtype=dtype, seed=seed,
                           device=device, mesh=mesh,
                           draft_model=draft_model)


def _add_core_arguments(parser):
    """Add DeepSpeed args group (reference __init__.py:148)."""
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag for user code, no "
                            "impact on DeepSpeed backend)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="DeepSpeed json configuration file.")
    group.add_argument("--deepspeed_mpi", default=False, action="store_true",
                       help="Run via MPI; discover the job launch info from "
                            "the MPI environment.")
    return parser


def add_config_arguments(parser):
    """Update an argument parser to enable the runtime: ``--deepspeed``,
    ``--deepspeed_config``, ``--deepspeed_mpi`` (the JAX package's
    ``add_config_arguments``; reference __init__.py:199)."""
    parser = _add_core_arguments(parser)
    return parser
