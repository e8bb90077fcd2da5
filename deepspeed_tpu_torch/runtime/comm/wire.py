"""Wire bytes of ZeRO's collectives and of the compressed exchanges, per
device and per step: an analytic model.

Port of ``deepspeed_tpu/runtime/comm/wire.py`` (``overlap_report`` and
``ici_bytes_per_s_for``, the telemetry half, excepted): pure arithmetic
over the parameter leaves, against which the bytes the port hands to
``torch.distributed`` (``quantize.WIRE``) are held. Ring pricing: an
all-gather, reduce-scatter or all-to-all moves ``payload * (g - 1) / g``
bytes a device, an all-reduce twice that, a ring hop its whole payload.

Counted per optimizer step (``gas`` micro-steps), as the JAX engine's
census prices its compiled step: at stage 3 each data-sharded leaf is
gathered ``gathers_per_micro`` (2: the forward and the backward's
recompute) times a micro-step over its gather group (the data group, the
shard group under hpZ), a tensor-parallel leaf moving its model-axis
share; from stage 2 each micro-step's gradients reduce-scatter over the
data group (stages 0-1 all-reduce), in fp32 except the leaves gathered
through the explicit ring or qwZ, priced in the compute dtype; at stages
1-2 the updated parameters re-replicate once a step in the master's
dtype. Quantized payloads price the codec: 1 byte a lane and one scale a
block (the weight gather's blocks tile the last dimension,
``_lastdim_block``; the gradient's are the flat codec's).
:func:`estimate_engine_comm_bytes` prices a port engine's live config
against the flat fp32 baseline and gives the JAX engine's integers for
the same config and leaves.
"""
import numpy as np

from .onebit import onebit_padded_size
from .quantize import DEFAULT_BLOCK_SIZE, _lastdim_block, qc_padded_size

_FP32_BYTES = 4


def _ring_factor(group):
    return (group - 1) / group if group > 1 else 0.0


def quantized_allreduce_bytes(numel, world, block_size=DEFAULT_BLOCK_SIZE,
                              levels=None, scale_itemsize=_FP32_BYTES,
                              min_component=0):
    """Per-device wire bytes of ONE in-collective quantized all-reduce
    (``quantized_all_reduce_local`` / ``hierarchical_all_reduce_local``):
    a ring reduce-scatter whose every hop moves one int8 chunk and its
    block scales, then an int8 all-gather with the scales.
    ``levels=(shard, replica)`` prices the two-level form: the full
    payload over the shard group, the 1/shard chunk over the replica
    group. ``min_component`` drops components below a threshold (the JAX
    package's HLO census)."""
    padded = qc_padded_size(numel, world, block_size)

    def keep(b):
        return int(b) if b >= min_component else 0

    def level(n, g):
        if g <= 1:
            return 0
        chunk = n // g
        nblocks = chunk // block_size
        total = (g - 1) * (keep(chunk) + keep(nblocks * scale_itemsize))
        total += keep((g - 1) * chunk)
        total += keep((g - 1) * nblocks * scale_itemsize)
        return total

    if levels:
        shard, replica = levels
        assert shard * replica == world, (levels, world)
        return level(padded, shard) + level(padded // shard, replica)
    return level(padded, world)


def onebit_exchange_bytes(numel, world, scale_itemsize=_FP32_BYTES,
                          min_component=0, itemsize_bits=1):
    """Per-device wire bytes of ONE compressed momentum all-reduce: the
    worker ``all_to_all`` of packed sign chunks and the scalar-scale
    all-gather, then the server sign all-gather and its scales.
    ``itemsize_bits=32`` prices the same exchange uncompressed."""
    padded = onebit_padded_size(numel, world)
    ring = _ring_factor(world)
    payload = padded * itemsize_bits // 8

    def keep(b):
        return int(b) if b >= min_component else 0

    total = 0
    total += keep(int(round(payload * ring)))
    total += keep(int(round(world * scale_itemsize * ring)))
    total += keep(int(round(payload * ring)))
    total += keep(int(round(world * scale_itemsize * ring)))
    return total


def _payload(numel, itemsize, quantized, scale_itemsize, block_size):
    """Bytes of one buffer of ``numel`` lanes: ``itemsize`` each, or 1 a
    lane plus one scale a ``block_size`` block when ``quantized``."""
    if not quantized:
        return numel * itemsize
    nblocks = -(-numel // block_size)
    return numel * 1 + nblocks * scale_itemsize


def decomposed_collective_bytes(payload_bytes, group, chunks=1):
    """Per-device bytes of a ring-decomposed all-gather or reduce-scatter
    of ``payload_bytes``: ``group - 1`` hops of one shard, in any number
    of ``chunks`` a hop, the one-shot collective's ``payload * (g - 1) /
    g``; ``chunks`` changes the grain, never the bytes."""
    del chunks
    return int(round(payload_bytes * _ring_factor(group)))


def _price_tree(leaves, eligible_fn, stage, dp, gather_group, gas,
                compute_itemsize, grad_itemsize, quantized_weights,
                quantized_gradients, block_size, gathers_per_micro=2,
                explicit_gather_grad_itemsize=None, tp_ways_fn=None,
                replicate_itemsize=None, min_component=0):
    """The pricing body of both entry points over ``leaves``, ``[(JAX
    path, shape)]`` in the JAX package's flatten order (the float sums
    run in that order, so the rounded totals are its integers).
    ``eligible_fn(path, shape, numel)``: the leaf is a stage-3
    data-sharded (gathered) parameter."""
    if replicate_itemsize is None:
        replicate_itemsize = compute_itemsize
    totals = {"allgather_bytes": 0.0, "reduce_bytes": 0.0}
    for path, shape in leaves:
        shape = tuple(shape)
        numel = int(np.prod(shape)) if shape else 1
        wire_numel = numel
        if tp_ways_fn is not None:
            wire_numel = numel // max(int(tp_ways_fn(path, shape)), 1)
        eligible = stage >= 3 and eligible_fn(path, shape, numel)
        if eligible:
            wblk = _lastdim_block(shape[-1], block_size) if shape else 1
            per_gather = _payload(wire_numel, compute_itemsize,
                                  quantized_weights, compute_itemsize,
                                  wblk) * _ring_factor(gather_group)
            totals["allgather_bytes"] += \
                gathers_per_micro * gas * per_gather
        elif stage in (1, 2) and dp > 1 and numel >= dp and \
                any(d % dp == 0 for d in shape):
            leaf_wire = wire_numel * replicate_itemsize * _ring_factor(dp)
            if leaf_wire >= min_component:
                totals["allgather_bytes"] += leaf_wire
        if dp > 1:
            gi = grad_itemsize
            if eligible and explicit_gather_grad_itemsize is not None:
                gi = explicit_gather_grad_itemsize
            grad_payload = _payload(wire_numel, gi, quantized_gradients,
                                    gi, block_size)
            factor = _ring_factor(dp) if stage >= 2 \
                else 2 * _ring_factor(dp)
            totals["reduce_bytes"] += gas * grad_payload * factor
    out = {k: int(round(v)) for k, v in totals.items()}
    out["total_bytes"] = out["allgather_bytes"] + out["reduce_bytes"]
    return out


class ZeroPlanView:
    """What the census reads of the JAX ``ZeroShardingPlan`` for a port
    engine: the stage, the data degree, the stage-3 parameters' shard
    degree (hpZ's N, else the data degree), the persistence threshold and
    the live budget's demotions, and the tensor-parallel spec
    (``spec_fn(path, shape)``: a tuple naming the ``model`` axis, or
    None) with the mesh's axis sizes."""

    def __init__(self, stage, dp, shard, threshold, demoted=(),
                 spec_fn=None, axis_sizes=None):
        self.stage, self.dp_size = int(stage), int(dp)
        self.param_shard_size = int(shard)
        self.threshold = threshold
        self.demoted = set(demoted)
        self.spec_fn = spec_fn
        self.axis_sizes = dict(axis_sizes or {})

    def _spec(self, path, shape):
        spec = self.spec_fn(path, shape) if self.spec_fn else None
        if spec is None:
            return None
        cleaned = [e if e is not None and self.axis_sizes.get(e, 1) > 1
                   else None for e in spec]
        return None if all(e is None for e in cleaned) else cleaned

    def param_is_data_sharded(self, path, shape, flat=False):
        ways = self.dp_size if flat else self.param_shard_size
        if self.stage < 3 or ways <= 1:
            return False
        threshold = 0 if path in self.demoted else self.threshold
        numel = int(np.prod(shape)) if shape else 1
        if not shape or numel < max(threshold, ways):
            return False
        base = self._spec(path, shape) or [None] * len(shape)
        base = list(base) + [None] * (len(shape) - len(base))
        return any(base[d] is None and size % ways == 0
                   for d, size in enumerate(shape))

    def tp_ways(self, path, shape):
        spec = self._spec(path, shape)
        ways = 1
        for entry in spec or ():
            if entry is not None:
                ways *= int(self.axis_sizes.get(entry, 1))
        return ways


def estimate_step_comm_bytes(plan, leaves, gas=1, compute_itemsize=4,
                             grad_itemsize=4, quantized_weights=False,
                             quantized_gradients=False,
                             block_size=DEFAULT_BLOCK_SIZE,
                             gathers_per_micro=2,
                             explicit_gather_grad_itemsize=None,
                             replicate_itemsize=None, min_component=0,
                             _force_flat_fp32=False):
    """Per-device collective bytes of ONE optimizer step under ``plan``
    (a :class:`ZeroPlanView`): ``{"allgather_bytes", "reduce_bytes",
    "total_bytes"}``. ``_force_flat_fp32`` prices the baseline: flat (the
    whole data group) fp32 with no quantization, with the flat plan's
    leaf eligibility."""
    if _force_flat_fp32:
        compute_itemsize = grad_itemsize = _FP32_BYTES
        quantized_weights = quantized_gradients = False
        explicit_gather_grad_itemsize = None
        replicate_itemsize = _FP32_BYTES
    return _price_tree(
        leaves,
        lambda path, shape, numel: plan.param_is_data_sharded(
            path, shape, flat=_force_flat_fp32),
        stage=plan.stage, dp=plan.dp_size,
        gather_group=plan.dp_size if _force_flat_fp32
        else plan.param_shard_size,
        gas=gas, compute_itemsize=compute_itemsize,
        grad_itemsize=grad_itemsize,
        quantized_weights=quantized_weights,
        quantized_gradients=quantized_gradients, block_size=block_size,
        gathers_per_micro=gathers_per_micro,
        explicit_gather_grad_itemsize=explicit_gather_grad_itemsize,
        tp_ways_fn=plan.tp_ways, replicate_itemsize=replicate_itemsize,
        min_component=min_component)


def project_comm_bytes(leaves, stage, dp, gas=1, compute_itemsize=4,
                       grad_itemsize=4, quantized_weights=False,
                       hierarchical_partition=0, quantized_gradients=False,
                       persistence_threshold=100000,
                       block_size=DEFAULT_BLOCK_SIZE):
    """Price ``leaves``' ZeRO collectives at a hypothetical data degree
    ``dp`` (the plan's eligibility rule without a mesh)."""
    gather_group = hierarchical_partition \
        if stage >= 3 and hierarchical_partition > 1 else dp
    return _price_tree(
        leaves,
        lambda path, shape, numel: bool(shape) and
        numel >= max(persistence_threshold, gather_group) and
        any(d % gather_group == 0 for d in shape),
        stage=stage, dp=dp, gather_group=gather_group, gas=gas,
        compute_itemsize=compute_itemsize, grad_itemsize=grad_itemsize,
        quantized_weights=quantized_weights,
        quantized_gradients=quantized_gradients, block_size=block_size)


def engine_plan_view(engine):
    """The :class:`ZeroPlanView` and the ``[(JAX path, full shape)]``
    leaves of a port engine."""
    from ...parallel.topology import DATA_AXIS, MODEL_AXIS
    from ..zero.partition import jax_path
    flat = engine.flat
    zc = engine._config.zero_config
    shapes = engine._full_shapes()
    leaves = [(jax_path(name), shapes[name])
              for name in engine._jax_leaf_names()]
    dp = engine.dp_world_size
    spec_fn = None
    if engine._cm_tp:
        module_spec = engine._module_fn("partition_spec_fn")

        def spec_fn(path, shape):
            return module_spec(path.replace("/", "."), shape)
    plan = ZeroPlanView(
        engine.zero_optimization_stage(), dp,
        engine.zero_hierarchical_partition() or dp,
        zc.param_persistence_threshold, flat.demoted, spec_fn,
        {DATA_AXIS: dp, MODEL_AXIS: engine.mp_world_size})
    return plan, leaves


def _compressed_comm_classes(engine, leaves, min_component=0):
    """The compressed exchanges' byte classes when live: ``(reduce bytes,
    optimizer bytes, fp32-equivalent optimizer bytes, regime)``, or None
    (the JAX census's ``_compressed_comm_classes``)."""
    mode = engine._local_grad_mode()
    if mode is None:
        return None
    numel = sum(int(np.prod(shape)) if shape else 1 for _, shape in leaves)
    dp = engine.dp_world_size
    gas = engine.gradient_accumulation_steps()
    qc = engine._qc
    levels = None
    if qc.enabled and qc.hierarchical >= 2:
        levels = (int(qc.hierarchical), dp // int(qc.hierarchical))

    def qc_bytes():
        return quantized_allreduce_bytes(numel, dp, qc.block_size,
                                         levels=levels,
                                         min_component=min_component)

    if mode == "exchange":
        return gas * qc_bytes(), 0, 0, None
    if engine._onebit_frozen():
        opt = onebit_exchange_bytes(numel, dp, min_component=min_component)
        equiv = onebit_exchange_bytes(numel, dp, itemsize_bits=32,
                                      min_component=min_component)
        return 0, opt, equiv, "frozen"
    if engine._qc_enabled:
        return qc_bytes(), 0, 0, "warmup"
    return int(round(2 * _ring_factor(dp) * _FP32_BYTES * numel)), 0, 0, \
        "warmup"


def estimate_engine_comm_bytes(engine, min_component=0):
    """A port engine's live config priced against the flat fp32 baseline:
    the JAX census's dict (``estimate_engine_comm_bytes``), with its
    integers for the same config and leaves."""
    plan, leaves = engine_plan_view(engine)
    compute_itemsize = engine.compute_dtype.itemsize
    gas = engine.gradient_accumulation_steps()
    explicit_gather = bool(engine._cm_zero3 or engine._qwz_enabled)
    mixed = engine.compute_dtype.itemsize != _FP32_BYTES
    cur = estimate_step_comm_bytes(
        plan, leaves, gas=gas, compute_itemsize=compute_itemsize,
        grad_itemsize=_FP32_BYTES,
        quantized_weights=engine.zero_quantized_weights(),
        quantized_gradients=engine.zero_quantized_gradients(),
        explicit_gather_grad_itemsize=compute_itemsize
        if explicit_gather else None,
        replicate_itemsize=_FP32_BYTES if mixed else compute_itemsize,
        min_component=min_component)
    base = estimate_step_comm_bytes(plan, leaves, gas=gas,
                                    _force_flat_fp32=True)

    def ratio(b, c):
        return round(b / c, 2) if c else None

    comp = _compressed_comm_classes(engine, leaves,
                                    min_component=min_component)
    opt_bytes = equiv_opt = 0
    onebit_regime = None
    if comp is not None:
        cur = dict(cur)
        cur["reduce_bytes"], opt_bytes, equiv_opt, onebit_regime = comp
        cur["total_bytes"] = cur["allgather_bytes"] + \
            cur["reduce_bytes"] + opt_bytes
    out = {
        "zero_stage": plan.stage,
        "quantized_weights": engine.zero_quantized_weights(),
        "hierarchical_partition": engine.zero_hierarchical_partition(),
        "quantized_gradients": engine.zero_quantized_gradients(),
        "allgather_bytes_per_step": cur["allgather_bytes"],
        "reduce_bytes_per_step": cur["reduce_bytes"],
        "optimizer_bytes_per_step": opt_bytes,
        "total_bytes_per_step": cur["total_bytes"],
        "fp32_flat_allgather_bytes_per_step": base["allgather_bytes"],
        "fp32_flat_reduce_bytes_per_step": base["reduce_bytes"],
        "fp32_equiv_optimizer_bytes_per_step": equiv_opt,
        "fp32_flat_total_bytes_per_step": base["total_bytes"],
        "allgather_reduction_x": ratio(base["allgather_bytes"],
                                       cur["allgather_bytes"]),
        "total_reduction_x": ratio(base["total_bytes"],
                                   cur["total_bytes"]),
        "reduction_x": {
            "weight": ratio(base["allgather_bytes"],
                            cur["allgather_bytes"]),
            "gradient": ratio(base["reduce_bytes"],
                              cur["reduce_bytes"] + opt_bytes),
            "optimizer": ratio(equiv_opt, opt_bytes),
        },
    }
    if onebit_regime is not None:
        out["onebit_regime"] = onebit_regime
    if engine._qc_enabled:
        qc = engine._qc
        out["quantized_collectives"] = {
            "enabled": True, "dtype": qc.dtype,
            "block_size": int(qc.block_size),
            "hierarchical": bool(qc.hierarchical >= 2)}
    cm = engine._cm
    if cm is not None and cm.enabled:
        out["collective_matmul"] = {
            "enabled": True, "zero_gather_fused": bool(engine._cm_zero3),
            "tensor_parallel_fused": bool(engine._cm_tp),
            "chunks": int(cm.chunks)}
    if plan.dp_size <= 1:
        dp = 8
        zc = engine._config.zero_config
        proj = project_comm_bytes(
            leaves, plan.stage, dp, gas=gas,
            compute_itemsize=compute_itemsize,
            grad_itemsize=compute_itemsize,
            quantized_weights=bool(zc.quantized_weights),
            hierarchical_partition=int(zc.hierarchical_partition or 0),
            quantized_gradients=bool(zc.quantized_gradients),
            persistence_threshold=zc.param_persistence_threshold)
        proj_base = project_comm_bytes(
            leaves, plan.stage, dp, gas=gas,
            persistence_threshold=zc.param_persistence_threshold)
        out["projected_dp{}".format(dp)] = {
            "total_bytes_per_step": proj["total_bytes"],
            "fp32_flat_total_bytes_per_step": proj_base["total_bytes"],
            "total_reduction_x": ratio(proj_base["total_bytes"],
                                       proj["total_bytes"]),
        }
    return out
