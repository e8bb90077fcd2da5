"""``comm`` ds_config section: collective-communication behaviour.

Port of ``deepspeed_tpu/runtime/comm/config.py``: the same keys, defaults
and messages. Shape::

    "comm": {
      "collective_matmul": {
        "enabled": false,          // master switch
        "tensor_parallel": true,   // the TP qkv/fc gathers + proj/fc2 scatters
                                   // run as ring GEMMs
        "zero_gather": true,       // the ZeRO-3 weight all-gather as a ring
                                   // (the stage-3 slice; inert at stage <= 2)
        "chunks": 1,               // pieces per ring hop (granularity only;
                                   // the bytes are the one-shot collective's)
        "dtype": "compute",        // wire dtype: "compute" (bit-exact) or
                                   // "bf16" (half-width, lossy hop)
        "backend": "ppermute",     // "ppermute" (the ring with torch.matmul
                                   // products; the oracle) or "pallas" (each
                                   // step's product in the CUDA ring kernels,
                                   // ops/ring_gemm)
        "strict": false            // unknown/unhonorable keys raise
      },
      "quantized_collectives": {
        "enabled": false,          // master switch: the data-parallel gradient
                                   // average through the in-collective int8
                                   // ring (runtime/comm/quantize.py)
        "dtype": "int8",           // wire dtype of every hop (the only codec)
        "block_size": 256,         // lanes per quantization block
        "hierarchical": 0,         // 0 = flat ring; N > 1 = factor the data
                                   // group (dp / N, N) for the two-level form
        "strict": false            // unknown/unhonorable keys raise
      }
    }

``comm.quantized_collectives.cuda_aware`` (the reference's NCCL-backend
key) raises: the exchange's transport is ``torch.distributed``, and no
CUDA-aware MPI path exists here.

Validated with the no-silent-no-ops policy: unknown keys warn, and raise
when the sub-section's ``strict`` is set.
"""
from ...utils.logging import logger

COMM = "comm"
COLLECTIVE_MATMUL = "collective_matmul"

CM_ENABLED = "enabled"
CM_ENABLED_DEFAULT = False
CM_TENSOR_PARALLEL = "tensor_parallel"
CM_TENSOR_PARALLEL_DEFAULT = True
CM_ZERO_GATHER = "zero_gather"
CM_ZERO_GATHER_DEFAULT = True
CM_CHUNKS = "chunks"
CM_CHUNKS_DEFAULT = 1
CM_DTYPE = "dtype"
CM_DTYPE_DEFAULT = "compute"
CM_DTYPES = ("compute", "bf16")
CM_BACKEND = "backend"
CM_BACKEND_DEFAULT = "ppermute"
CM_BACKENDS = ("ppermute", "pallas")
CM_STRICT = "strict"

QUANTIZED_COLLECTIVES = "quantized_collectives"

QC_ENABLED = "enabled"
QC_ENABLED_DEFAULT = False
QC_DTYPE = "dtype"
QC_DTYPE_DEFAULT = "int8"
QC_DTYPES = ("int8",)
QC_BLOCK_SIZE = "block_size"
QC_BLOCK_SIZE_DEFAULT = 256
QC_HIERARCHICAL = "hierarchical"
QC_HIERARCHICAL_DEFAULT = 0
QC_CUDA_AWARE = "cuda_aware"
QC_STRICT = "strict"

KNOWN_COMM_KEYS = {COLLECTIVE_MATMUL, QUANTIZED_COLLECTIVES}
KNOWN_COLLECTIVE_MATMUL_KEYS = {
    CM_ENABLED, CM_TENSOR_PARALLEL, CM_ZERO_GATHER, CM_CHUNKS, CM_DTYPE,
    CM_BACKEND, CM_STRICT,
}
KNOWN_QUANTIZED_COLLECTIVES_KEYS = {
    QC_ENABLED, QC_DTYPE, QC_BLOCK_SIZE, QC_HIERARCHICAL, QC_STRICT,
}


def warn_or_raise_noop(msg, strict, flag):
    """A config key this runtime cannot honour warns loudly, and raises
    when the section's strict flag is set."""
    if strict:
        raise ValueError(msg + " (raising because {}=true)".format(flag))
    logger.warning(msg)


class CollectiveMatmulConfig(object):
    """Typed view of ``comm.collective_matmul``."""

    def __init__(self, d):
        d = d or {}
        if not isinstance(d, dict):
            raise ValueError(
                "comm.collective_matmul must be a dict, got {}".format(
                    type(d).__name__))
        self.strict = bool(d.get(CM_STRICT, False))
        unknown = sorted(k for k in d
                         if k not in KNOWN_COLLECTIVE_MATMUL_KEYS)
        if unknown:
            warn_or_raise_noop(
                "comm.collective_matmul.{} has NO effect: unknown key(s) "
                "(accepted: {})".format(
                    ", ".join(unknown),
                    sorted(KNOWN_COLLECTIVE_MATMUL_KEYS)),
                self.strict, flag="comm.collective_matmul.strict")
        self.enabled = bool(d.get(CM_ENABLED, CM_ENABLED_DEFAULT))
        self.tensor_parallel = bool(d.get(CM_TENSOR_PARALLEL,
                                          CM_TENSOR_PARALLEL_DEFAULT))
        self.zero_gather = bool(d.get(CM_ZERO_GATHER,
                                      CM_ZERO_GATHER_DEFAULT))
        chunks = d.get(CM_CHUNKS, CM_CHUNKS_DEFAULT)
        if isinstance(chunks, bool) or not isinstance(chunks, int) or \
                chunks < 1:
            raise ValueError(
                "comm.collective_matmul.{} must be an int >= 1, got "
                "{!r}".format(CM_CHUNKS, chunks))
        self.chunks = chunks
        dtype = str(d.get(CM_DTYPE, CM_DTYPE_DEFAULT)).lower()
        if dtype not in CM_DTYPES:
            raise ValueError(
                "comm.collective_matmul.{} must be one of {}, got "
                "{!r}".format(CM_DTYPE, CM_DTYPES, dtype))
        self.dtype = dtype
        backend = str(d.get(CM_BACKEND, CM_BACKEND_DEFAULT)).lower()
        if backend not in CM_BACKENDS:
            raise ValueError(
                "comm.collective_matmul.{} must be one of {}, got "
                "{!r}".format(CM_BACKEND, CM_BACKENDS, backend))
        self.backend = backend
        if backend == "pallas" and self.enabled and \
                not self.tensor_parallel:
            warn_or_raise_noop(
                "comm.collective_matmul.backend='pallas' has NO effect: "
                "tensor_parallel is disabled and the zero3 ring gather "
                "always runs the ppermute backend", self.strict,
                flag="comm.collective_matmul.strict")
        if self.enabled and not (self.tensor_parallel or self.zero_gather):
            warn_or_raise_noop(
                "comm.collective_matmul.enabled has NO effect: both "
                "tensor_parallel and zero_gather are disabled",
                self.strict, flag="comm.collective_matmul.strict")


class QuantizedCollectivesConfig(object):
    """Typed view of ``comm.quantized_collectives``: the keys are checked
    as in the JAX package; the engine checks ``hierarchical`` against the
    data degree (``_configure_quantized_collectives``)."""

    def __init__(self, d):
        d = d or {}
        if not isinstance(d, dict):
            raise ValueError(
                "comm.quantized_collectives must be a dict, got {}".format(
                    type(d).__name__))
        self.strict = bool(d.get(QC_STRICT, False))
        if QC_CUDA_AWARE in d:
            # the reference NcclBackend key: accepting it would claim a
            # CUDA-aware MPI transport that is not there
            raise ValueError(
                "comm.quantized_collectives.cuda_aware names a transport "
                "this runtime does not have: the exchange runs over "
                "torch.distributed (NCCL between cards, gloo where ranks "
                "share one); remove the key")
        unknown = sorted(k for k in d
                         if k not in KNOWN_QUANTIZED_COLLECTIVES_KEYS)
        if unknown:
            warn_or_raise_noop(
                "comm.quantized_collectives.{} has NO effect: unknown "
                "key(s) (accepted: {})".format(
                    ", ".join(unknown),
                    sorted(KNOWN_QUANTIZED_COLLECTIVES_KEYS)),
                self.strict, flag="comm.quantized_collectives.strict")
        self.enabled = bool(d.get(QC_ENABLED, QC_ENABLED_DEFAULT))
        dtype = str(d.get(QC_DTYPE, QC_DTYPE_DEFAULT)).lower()
        if dtype not in QC_DTYPES:
            raise ValueError(
                "comm.quantized_collectives.{} must be one of {}, got "
                "{!r}".format(QC_DTYPE, QC_DTYPES, dtype))
        self.dtype = dtype
        block = d.get(QC_BLOCK_SIZE, QC_BLOCK_SIZE_DEFAULT)
        if isinstance(block, bool) or not isinstance(block, int) or \
                block < 8:
            raise ValueError(
                "comm.quantized_collectives.{} must be an int >= 8, got "
                "{!r}".format(QC_BLOCK_SIZE, block))
        self.block_size = block
        hier = d.get(QC_HIERARCHICAL, QC_HIERARCHICAL_DEFAULT)
        if isinstance(hier, bool) or not isinstance(hier, int) or \
                hier < 0 or hier == 1:
            raise ValueError(
                "comm.quantized_collectives.{} must be 0 (follow the "
                "mesh) or an int >= 2 (factor the data axis that many "
                "ways), got {!r}".format(QC_HIERARCHICAL, hier))
        self.hierarchical = hier


class DeepSpeedCommConfig(object):
    """Typed view of the ``comm`` section of a ds_config dict."""

    def __init__(self, param_dict):
        d = (param_dict or {}).get(COMM, {}) or {}
        if not isinstance(d, dict):
            raise ValueError(
                "comm section must be a dict, got {}".format(
                    type(d).__name__))
        unknown = sorted(k for k in d if k not in KNOWN_COMM_KEYS)
        if unknown:
            logger.warning("comm.%s has NO effect: unknown key(s) "
                           "(accepted: %s)", ", ".join(unknown),
                           sorted(KNOWN_COMM_KEYS))
        self.collective_matmul = CollectiveMatmulConfig(
            d.get(COLLECTIVE_MATMUL))
        self.quantized_collectives = QuantizedCollectivesConfig(
            d.get(QUANTIZED_COLLECTIVES))
