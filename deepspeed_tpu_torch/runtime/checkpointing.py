"""Checkpoint serialization: the JAX package's tag format, read and written
without JAX.

Port of ``deepspeed_tpu/runtime/checkpointing.py``, the same file layout
and integrity layer, so a tag crosses between the two packages in both
directions:

* ``<dir>/<tag>/mp_rank_00_model_states.pt``: the model state (the
  compute-dtype ``module`` tree, counters, scaler, LR schedule, client
  state; under ZeRO no master and no optimizer state);
* ``zero_pp_rank_{rank}_mp_rank_00_optim_states.pt``, one per rank under
  ZeRO: the rank's boxes of the full fp32 master and moment leaves
  (``device_shards``: per leaf ``(full_shape, [(key, array), ...])``,
  each key a box ``((start, stop, step), ...)`` of the FULL leaf, so any
  set of ranks can reassemble it);
* ``manifest.json``, written last: every file with its CRC32 and size; a
  tag without a valid manifest is incomplete. ``latest`` names the tag
  and moves after the manifest.

Leaves are numpy inside a pickle (protocol 4), every write atomic (tmp +
fsync + rename) with the CRC computed while writing, transient
``OSError``s retried with backoff (``utils/retry.py``), and
``newest_complete_tag`` / ``prune_checkpoints`` as in the JAX package.

bf16 leaves: numpy has no bf16, and the JAX package pickles bf16 arrays
as ``ml_dtypes.bfloat16`` arrays, which a process without ``ml_dtypes``
cannot unpickle. :class:`_TagUnpickler` resolves that dtype without
importing ``ml_dtypes``: the leaf's 16-bit patterns become a bf16 tensor
bit for bit (bf16 leaves load as ``torch.bfloat16`` CPU tensors, every
other leaf as numpy). The writer emits a bf16 tensor as
``numpy.ndarray(shape, "bfloat16", buffer)``, which a JAX process
(where ``ml_dtypes`` has registered the dtype name) unpickles as an
``ml_dtypes.bfloat16`` array, and this module reads back bit for bit.
An import failure while unpickling is an environment fault, not
corruption: it raises :class:`CheckpointEnvironmentError` naming the
module and never sends ``load_checkpoint`` back to an older tag.

Async saves pickle and write on one serial background thread of this
module (drained at exit); the tensors are copied off the device, and
host tensors copied, before the call returns.
"""
import atexit
import json
import os
import pickle
import shutil
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..utils.logging import logger
from ..utils.retry import RetryPolicy, retry_call

MANIFEST_NAME = "manifest.json"
CHECKPOINT_FORMAT_VERSION = 1
# verify_tag reason for a tag dir predating the manifest format; callers
# may choose to load such tags unverified (legacy) instead of rejecting
NO_MANIFEST = "no manifest"


class CheckpointCorruptionError(Exception):
    """A checkpoint file exists but its contents are torn or bit-rotted
    (truncated pickle, checksum mismatch). NOT retried: corruption does
    not heal — the caller should fall back to the last complete tag."""


class CheckpointEnvironmentError(RuntimeError):
    """Unpickling a checkpoint file needed a module this process cannot
    import. The file is not corrupt, and every older tag would fail the
    same way, so this is never a reason to fall back."""


# ----------------------------------------------------------------- IO policy
_RETRY_POLICY = RetryPolicy()

# installed by utils/fault_injection.inject_faults for crash/bit-rot tests
_FAULT_INJECTOR = None


def set_retry_policy(policy=None, **kwargs):
    """Configure transient-IO retry behavior for every checkpoint
    read/write in this process (ds_config ``"checkpoint"`` block; kwargs
    are RetryPolicy fields, e.g. ``retries=``, ``backoff_seconds=``)."""
    global _RETRY_POLICY
    _RETRY_POLICY = policy if policy is not None \
        else _RETRY_POLICY._replace(**kwargs)
    return _RETRY_POLICY


def _log_io_retry(path):
    def _on_retry(attempt, exc, delay):
        logger.warning(
            "transient checkpoint IO failure on %s (attempt %d: %s) — "
            "retrying in %.3fs", path, attempt + 1, exc, delay)
    return _on_retry


# ------------------------------------------------------------- bf16 leaves
class _BF16Leaf:
    """A bf16 tensor on its way into a pickle: its 16-bit patterns,
    written as ``numpy.ndarray(shape, "bfloat16", buffer)``."""

    def __init__(self, tensor, copy):
        t = tensor.detach().to("cpu", copy=copy).contiguous()
        self.shape = tuple(t.shape)
        self.bits = t.view(torch.int16).numpy()

    def __reduce__(self):
        return np.ndarray, (self.shape, "bfloat16", self.bits.tobytes())


def _bits_to_bf16(bits, shape):
    return torch.from_numpy(
        np.array(bits, copy=True).view(np.int16).reshape(shape)).view(
            torch.bfloat16)


class _BF16Type:
    """Stands for ``ml_dtypes.bfloat16`` while a tag is unpickled."""


class _BF16DType:
    """Stands for ``numpy.dtype(ml_dtypes.bfloat16)``; the dtype's pickled
    state (byte order, size 2) needs nothing kept."""

    def __setstate__(self, state):
        pass


def _dtype(obj, align=False, copy=False):
    if obj is _BF16Type:
        return _BF16DType()
    return np.dtype(obj, align, copy)


class _LoadedArray(np.ndarray):
    """numpy's ``_reconstruct`` target: a bf16 leaf's state arrives with a
    :class:`_BF16DType` and is kept as its 16-bit patterns, marked."""

    def __setstate__(self, state):
        version, shape, dtype, fortran, raw = state
        self.bf16 = isinstance(dtype, _BF16DType)
        if self.bf16:
            dtype = np.dtype(np.uint16)
        np.ndarray.__setstate__(self, (version, shape, dtype, fortran, raw))


def _reconstruct(subtype, shape, typecode):
    return np.ndarray.__new__(_LoadedArray, shape, typecode)


def _ndarray(shape, dtype=float, buffer=None, *args):
    """``numpy.ndarray(...)`` as this module's writer emits a bf16 leaf."""
    if dtype == "bfloat16":
        return _bits_to_bf16(np.frombuffer(buffer, np.uint16), shape)
    return np.ndarray(shape, dtype, buffer, *args)


class _TagUnpickler(pickle.Unpickler):
    """Resolves ml_dtypes' bfloat16 and numpy 1.x/2.x paths itself; any
    other global through the usual import."""

    def find_class(self, module, name):
        if module == "ml_dtypes" and name == "bfloat16":
            return _BF16Type
        if module in ("numpy._core.multiarray", "numpy.core.multiarray") \
                and name == "_reconstruct":
            return _reconstruct
        if module == "numpy" and name == "dtype":
            return _dtype
        if module == "numpy" and name == "ndarray":
            return _ndarray
        if module.startswith("numpy._core"):
            try:
                return super().find_class(module, name)
            except ImportError:     # numpy 1.x names the package core
                module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def _finish(obj):
    """Loaded leaves -> numpy arrays, bf16 ones -> bf16 CPU tensors."""
    if isinstance(obj, _LoadedArray):
        bits = obj.view(np.ndarray)
        return _bits_to_bf16(bits, bits.shape) if obj.bf16 else bits
    if isinstance(obj, dict):
        return type(obj)((k, _finish(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple, set)):
        return type(obj)(_finish(v) for v in obj)
    return obj


def unpickle(f):
    """Read one pickle written by either package (see the module
    docstring for bf16 leaves)."""
    return _finish(_TagUnpickler(f).load())


def tree_to_numpy(tree, copy=False):
    """Tensors -> host numpy arrays of their dtype (bf16 -> a leaf that
    pickles as a JAX bf16 array). With ``copy`` host memory is copied
    too (an async save must not see later in-place updates); device
    tensors are copied to the host either way. Containers keep their
    type."""
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return _BF16Leaf(tree, copy)
        return tree.detach().to("cpu", copy=copy).numpy()
    if isinstance(tree, np.ndarray):
        return np.array(tree, copy=True) if copy else tree
    if isinstance(tree, dict):
        return type(tree)((k, tree_to_numpy(v, copy))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple, set)):
        return type(tree)(tree_to_numpy(v, copy) for v in tree)
    return tree


def tree_leaves_with_paths(tree, prefix=()):
    """``(path, leaf)`` in ``jax.tree_util.tree_flatten`` order: dict keys
    sorted, lists and tuples in order; None is an empty subtree."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves_with_paths(tree[key], prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from tree_leaves_with_paths(child, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


# ---------------------------------------------------------------- shards
def shard_key(index):
    """Serializable key for a shard's tuple-of-slices index."""
    return tuple((s.start, s.stop, s.step) for s in index)


def key_to_index(key):
    return tuple(slice(a, b, c) for a, b, c in key)


def flat_range_boxes(shape, start, stop):
    """The row-major element range ``[start, stop)`` of a leaf of
    ``shape`` as boxes ``(((lo, hi), ...), flat_lo, flat_hi)``: disjoint,
    each one contiguous in the leaf's memory, at most ``2 * ndim - 1``."""
    if start >= stop:
        return []
    if not shape:
        return [((), start, stop)]
    row = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    inner = tuple((0, n) for n in shape[1:])
    i0, r0 = divmod(start, row)
    i1, r1 = divmod(stop, row)

    def nested(i, lo, hi):
        return [(((i, i + 1),) + box, i * row + a, i * row + b)
                for box, a, b in flat_range_boxes(shape[1:], lo, hi)]

    if i0 == i1:
        return nested(i0, r0, r1)
    out = []
    if r0:
        out += nested(i0, r0, row)
        i0 += 1
    if i1 > i0:
        out.append((((i0, i1),) + inner, i0 * row, i1 * row))
    if r1:
        out += nested(i1, 0, r1)
    return out


def assemble_shard_lists(per_file_lists, what="leaf"):
    """Reassemble full leaves from every file's shard lists (each: per
    leaf ``(global_shape, [(key, array), ...])``), as CPU tensors of the
    saved dtype. Raises if the shards do not cover a leaf exactly once
    (a tag missing per-rank files)."""
    out = []
    for i in range(len(per_file_lists[0])):
        shape = tuple(per_file_lists[0][i][0])
        buf, seen, covered = None, set(), 0
        for lists in per_file_lists:
            for key, data in lists[i][1]:
                key = tuple(map(tuple, key))
                if key in seen:
                    continue
                seen.add(key)
                part = torch.as_tensor(data)
                if buf is None:
                    buf = torch.zeros(shape, dtype=part.dtype)
                buf[key_to_index(key)] = part
                covered += part.numel()
        total = int(np.prod(shape))
        if covered != total:
            raise RuntimeError(
                "zero shard files cover {}/{} elements of {} {} — "
                "checkpoint is missing per-rank files; resume with the "
                "layout it was saved under".format(covered, total, what, i))
        out.append(buf)
    return out


# ------------------------------------------------------------ zero files
def jax_leaf_order(params_to_jax, names):
    """``names`` (a model's dotted parameter names) in the order the JAX
    package flattens the tree ``params_to_jax`` makes of them: the order
    of the per-leaf lists in the zero files."""
    tree = params_to_jax({name: torch.zeros(1) for name in names})
    order = [".".join(map(str, path)) for path, _ in
             tree_leaves_with_paths(tree)]
    if sorted(order) != sorted(names):
        raise RuntimeError("the model's JAX tree paths do not name its "
                           "parameters")
    return order


def owned_boxes(layout, box_map=None):
    """Per parameter name, the boxes this rank owns of the full leaf:
    ``{name: [(full box ((lo, hi), ...), local flat lo, local flat hi,
    box shape, index into the box's data)]}``.

    ``layout`` is the flat buffers' ``(names, offsets, shapes, spans)``:
    each parameter at its offset, this rank owning ``[lo, hi)`` of the
    layout at local offset ``local`` for each span ``(lo, hi, local)``
    (stages 0-2 own one span, stage 3 one a unit); the older ``(names,
    offsets, shapes, lo, hi)`` is one span at local offset 0. Each
    parameter's owned elements are cut into boxes
    (:func:`flat_range_boxes`); ``box_map(name, shape, box)`` moves a box
    of the rank's leaf to ``[(box of the full leaf, index into the part),
    ...]`` (a tensor-parallel shard), ``[]`` where another rank writes
    those elements."""
    if len(layout) == 5:
        names, offsets, shapes, lo, hi = layout
        spans = [(lo, hi, 0)]
    else:
        names, offsets, shapes, spans = layout
    out = {}
    for name, off, shape in zip(names, offsets, shapes):
        n = int(np.prod(shape)) if shape else 1
        entries = out.setdefault(name, [])
        for lo, hi, local in spans:
            a, b = max(off, lo), min(off + n, hi)
            for box, blo, bhi in flat_range_boxes(shape, a - off, b - off):
                parts = [(box, ())] if box_map is None else \
                    box_map(name, shape, box)
                entries += [(full, local + off + blo - lo,
                             local + off + bhi - lo,
                             tuple(z - y for y, z in box), index)
                            for full, index in parts]
    return out


def _key(full):
    return tuple((y, z, None) for y, z in full)


def zero_payload(order, layout, bufs, step, full_shapes, box_map=None):
    """One rank's zero file, ``device_shards`` as the JAX engine writes it
    (``_device_zero_shard_payload``): ``bufs`` holds the owned parts of
    ``master``, ``exp_avg`` and ``exp_avg_sq`` (and qgZ's ``qg_error``,
    partitioned like the master here) on the host, cut into the
    boxes of :func:`owned_boxes` (``layout``, ``box_map``). Per leaf, in
    ``order``: ``(full_shapes[name], [(key, array), ...])``."""
    boxes = owned_boxes(layout, box_map)

    def lists(host):
        return [(full_shapes[name],
                 [(_key(full), host[a:b].view(shape)[index])
                  for full, a, b, shape, index in boxes[name]])
                for name in order]

    opt = {"step": np.asarray(step, np.int32)}
    opt.update((key, lists(bufs[key])) for key in ("exp_avg", "exp_avg_sq")
               if key in bufs)
    return {"device_shards": {
        "master": lists(bufs["master"]),
        "opt": opt,
        "qg_error": lists(bufs["qg_error"]) if "qg_error" in bufs
        else None}}


def fused_entry(flat, write):
    """The shard list of a fused ``{"_flat": (n,)}`` subtree the same on
    every rank (OneBitAdam's momentum): the whole buffer, written by the
    writer rank only (``write``), as the JAX engine writes a replicated
    leaf."""
    n = int(flat.numel())
    return [((n,), [(_key(((0, n),)), flat.numpy())] if write else [])]


def row_entry(row, rank, world):
    """The shard list of a per-rank ``{"_flat": (world, n)}`` subtree
    (OneBitAdam's error rows): this rank's row ``rank``."""
    n = int(row.numel())
    return [((int(world), n), [(_key(((rank, rank + 1), (0, n))),
                                row.reshape(1, n).numpy())])]


def offload_payload(order, layout, bufs, step, torn_step=None):
    """One rank's zero file of an offload run, as the JAX engine writes
    it for a partitioned offload (``offload_shards``): per leaf, in
    ``order``, ``[(key, master, exp_avg, exp_avg_sq), ...]``, fp32 numpy
    arrays of each box this rank owns; ``offload_step``, and
    ``torn_step`` (the step a failed host step left half done, else
    None)."""
    boxes = owned_boxes(layout)

    def part(key, a, b, shape):
        return bufs[key][a:b].view(shape).float().numpy()

    return {"offload_shards": [
        [(_key(full), part("master", a, b, shape),
          part("exp_avg", a, b, shape), part("exp_avg_sq", a, b, shape))
         for full, a, b, shape, _ in boxes[name]]
        for name in order],
        "offload_step": int(step),
        "torn_step": torn_step}


def zero_state(payloads, order, module_tree, load_optimizer_states=True,
               fused_keys=()):
    """The full master and moment leaves of a ZeRO tag, reassembled from
    every zero file's payload (the JAX engine's ``device_shards`` or
    ``offload_shards``; ``module_tree``, the model file's, gives the
    offload layout's shapes): ``(master, optimizer)`` as ``{name:
    tensor}`` and ``{"step", "exp_avg", "exp_avg_sq"}``, None where the
    tag has none. ``fused_keys``: the optimizer subtrees that are one
    fused leaf ``{"_flat": tensor}`` (OneBitAdam's ``exp_avg``,
    ``worker_error``, ``server_error``) instead of parameter-shaped."""
    def as_state(lists, what):
        if len(lists[0]) != len(order):
            raise RuntimeError(
                "the zero files hold {} leaves, the model {}".format(
                    len(lists[0]), len(order)))
        return dict(zip(order, assemble_shard_lists(lists, what)))

    if "offload_shards" in payloads[0]:
        # (key, master, exp_avg, exp_avg_sq) per leaf of the module tree
        shapes = [tuple(np.shape(leaf)) for _, leaf in
                  tree_leaves_with_paths(module_tree)]

        def field(i):
            return [[(shapes[j], [(e[0], e[i]) for e in shards])
                     for j, shards in enumerate(p["offload_shards"])]
                    for p in payloads]
        opt = None
        if load_optimizer_states:
            opt = {"step": int(payloads[0]["offload_step"]),
                   "exp_avg": as_state(field(2), "exp_avg"),
                   "exp_avg_sq": as_state(field(3), "exp_avg_sq")}
        return as_state(field(1), "master"), opt
    device = [p["device_shards"] for p in payloads]
    master = as_state([d["master"] for d in device], "master") \
        if device[0].get("master") is not None else None
    if not load_optimizer_states:
        return master, None
    saved = device[0]["opt"]
    opt = {"step": int(np.asarray(saved["step"]))}
    param_shapes = [tuple(shape) for shape, _ in device[0]["master"]] \
        if device[0].get("master") is not None else None
    for key in ("exp_avg", "exp_avg_sq") + tuple(
            k for k in fused_keys if k not in ("exp_avg", "exp_avg_sq")):
        fused = key in fused_keys
        shapes = [tuple(shape) for shape, _ in saved.get(key, ())]
        # a fused subtree is one leaf that is not the parameters' shape
        is_fused = len(shapes) == 1 and (len(order) != 1 or
                                         shapes != param_shapes)
        if key not in saved or fused != is_fused:
            logger.warning(
                "zero shard files carry no '%s' optimizer state of this "
                "optimizer's layout (saved under a different optimizer) — "
                "optimizer state starts fresh", key)
            return master, None
        lists = [d["opt"][key] for d in device]
        opt[key] = {"_flat": assemble_shard_lists(lists, "opt/" + key)[0]} \
            if fused else as_state(lists, "opt/" + key)
    return master, opt


def zero_qg_error(payloads, order):
    """qgZ's error feedback ``{name: tensor}`` reassembled from every zero
    file's ``device_shards`` (the JAX engine's ``qg_error`` shard lists),
    or None where the tag carries none."""
    device = [p.get("device_shards") for p in payloads]
    if device[0] is None or device[0].get("qg_error") is None:
        return None
    leaves = assemble_shard_lists([d["qg_error"] for d in device],
                                  "qg_error")
    return dict(zip(order, leaves))


# ------------------------------------------------------- the serial writer
_WRITE_POOL = None


def _write_pool():
    """One serial background writer: submissions execute in order, so an
    async ``save_latest`` queued after the shard writes cannot run until
    they have all landed. An atexit drain lets queued writes and the
    ``latest`` update complete on a clean interpreter exit."""
    global _WRITE_POOL
    if _WRITE_POOL is None:
        _WRITE_POOL = ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="ckpt-write")
        atexit.register(_drain_write_pool_at_exit)
    return _WRITE_POOL


def _drain_write_pool_at_exit():
    pool = _WRITE_POOL
    if pool is not None:
        pool.shutdown(wait=True)


def wait_pending_writes():
    """Block until every checkpoint write queued so far has executed
    (failures stay recorded on their futures)."""
    if _WRITE_POOL is None:
        return
    _WRITE_POOL.submit(lambda: None).result()


def _fsync_dir(dirname):
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _CRC32Writer:
    """File-object shim that CRCs and counts everything written through
    it, so the integrity record costs no second pass over the bytes."""

    def __init__(self, f):
        self._f = f
        self.crc = 0
        self.size = 0

    def write(self, data):
        n = self._f.write(data)
        self.crc = zlib.crc32(data, self.crc)
        self.size += len(data)
        return n

    def flush(self):
        self._f.flush()

    def fileno(self):
        return self._f.fileno()


def _atomic_write_bytes(path, write_fn):
    """tmp + fsync + rename: a crash at any point leaves the old complete
    file or none, never a truncated one. Transient OSErrors restart the
    attempt. Returns the ``{"path", "crc32", "bytes"}`` record the tag
    manifest is built from."""
    def _attempt():
        if _FAULT_INJECTOR is not None:
            _FAULT_INJECTOR.before_write(path)
        tmp = path + ".tmp"
        with open(tmp, "wb") as raw:
            shim = _CRC32Writer(raw)
            write_fn(shim)
            raw.flush()
            os.fsync(raw.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path) or ".")
        return {"path": path, "crc32": shim.crc, "bytes": shim.size}
    record = retry_call(_attempt, policy=_RETRY_POLICY,
                        retry_on=(OSError,), on_retry=_log_io_retry(path))
    if _FAULT_INJECTOR is not None:
        _FAULT_INJECTOR.after_write(path)
    return record


def save_state_dict(path, state_dict, async_save=False):
    """Atomically persist ``state_dict`` (tensors copied to host numpy
    synchronously: callers may update them right after this returns).
    Returns the write's integrity record, or with ``async_save`` a future
    of it (the pickle and the write run on the serial writer)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = tree_to_numpy(state_dict, copy=async_save)
    writer = lambda f: pickle.dump(payload, f, protocol=4)
    if async_save:
        return _write_pool().submit(_atomic_write_bytes, path, writer)
    return _atomic_write_bytes(path, writer)


def save_latest_after(save_dir, tag, shard_futures):
    """Queue a ``latest`` update that runs only if every earlier queued
    write of the tag succeeded."""
    shard_futures = tuple(f for f in shard_futures if f is not None)

    def _update():
        for fut in shard_futures:
            err = fut.exception()
            if err is not None:
                raise RuntimeError(
                    "latest pointer NOT updated: an earlier checkpoint "
                    "shard write failed") from err
        save_latest(save_dir, tag)

    return _write_pool().submit(_update)


# truncated/garbled pickle payloads surface as any of these from
# pickle.load; none of them heal on retry. ImportError is not among them:
# a module this process lacks is an environment fault.
_UNPICKLE_ERRORS = (EOFError, pickle.UnpicklingError, ValueError,
                    IndexError, KeyError, AttributeError, UnicodeDecodeError)


def load_state_dict(path):
    """Unpickle one checkpoint file (transient OSErrors retried). A torn or
    bit-rotted payload raises CheckpointCorruptionError naming the file
    (load_checkpoint falls back to the newest complete tag); a module
    the pickle needs and this process cannot import raises
    CheckpointEnvironmentError naming it."""
    def _read():
        if _FAULT_INJECTOR is not None:
            _FAULT_INJECTOR.before_read(path)
        with open(path, "rb") as f:
            return unpickle(f)
    try:
        return retry_call(_read, policy=_RETRY_POLICY, retry_on=(OSError,),
                          on_retry=_log_io_retry(path))
    except ImportError as err:
        raise CheckpointEnvironmentError(
            "checkpoint file {} needs module {!r}, which this process "
            "cannot import ({}: {}); the file is not corrupt and older "
            "tags would fail the same way".format(
                path, getattr(err, "name", None), type(err).__name__,
                err)) from err
    except _UNPICKLE_ERRORS as err:
        raise CheckpointCorruptionError(
            "checkpoint file {} is corrupt ({}: {}) — it was likely "
            "truncated by a crash or bit-rotted in storage; "
            "load_checkpoint falls back to the newest complete tag".format(
                path, type(err).__name__, err)) from err


def model_ckpt_name(checkpoints_path, tag, mp_rank=0):
    return os.path.join(checkpoints_path, str(tag),
                        "mp_rank_{:02d}_model_states.pt".format(mp_rank))


def zero_ckpt_name(checkpoints_path, tag, dp_rank=0, mp_rank=0):
    return os.path.join(
        checkpoints_path, str(tag),
        "zero_pp_rank_{}_mp_rank_{:02d}_optim_states.pt".format(dp_rank,
                                                                mp_rank))


def layer_ckpt_name(checkpoints_path, tag, layer_id, model_rank=0):
    """A pipeline's per-layer file (the JAX package's name)."""
    return os.path.join(
        checkpoints_path, str(tag),
        "layer_{:02d}-model_{:02d}-model_states.pt".format(layer_id,
                                                           model_rank))


def manifest_path(checkpoints_path, tag):
    return os.path.join(checkpoints_path, str(tag), MANIFEST_NAME)


def save_latest(save_dir, tag, async_save=False):
    """Atomically update the ``latest`` pointer, only after every file of
    ``tag`` has landed (async: queued behind them on the serial
    writer)."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "latest")
    writer = lambda f: f.write(str(tag).encode())
    if async_save:
        return _write_pool().submit(_atomic_write_bytes, path, writer)
    return _atomic_write_bytes(path, writer)


def read_latest(load_dir):
    """The tag named by ``latest``, or None when the pointer is absent,
    blank, or names a tag directory that does not exist."""
    latest_path = os.path.join(load_dir, "latest")
    if not os.path.isfile(latest_path):
        return None

    def _read():
        with open(latest_path, "r") as f:
            return f.read()
    tag = retry_call(_read, policy=_RETRY_POLICY, retry_on=(OSError,),
                     on_retry=_log_io_retry(latest_path)).strip()
    if not tag:
        logger.warning("latest pointer %s is empty — ignoring it",
                       latest_path)
        return None
    if not os.path.isdir(os.path.join(load_dir, tag)):
        logger.warning(
            "latest pointer %s names tag %r but %s does not exist — "
            "ignoring it", latest_path, tag, os.path.join(load_dir, tag))
        return None
    return tag


# ----------------------------------------------------------- tag manifests
def _file_crc32(path, chunk_bytes=1 << 20):
    def _read():
        if _FAULT_INJECTOR is not None:
            _FAULT_INJECTOR.before_read(path)
        crc = 0
        with open(path, "rb") as f:
            while True:
                block = f.read(chunk_bytes)
                if not block:
                    break
                crc = zlib.crc32(block, crc)
        return crc
    return retry_call(_read, policy=_RETRY_POLICY, retry_on=(OSError,),
                      on_retry=_log_io_retry(path))


def write_manifest(save_dir, tag, records, meta=None):
    """Write ``<tag>/manifest.json`` as the tag's last content file: each
    file's CRC32 and size, plus ``meta`` (global_step, world sizes).
    Files other ranks wrote (the barrier before this has passed) are
    found in the tag directory and checksummed by reading them back."""
    tag_dir = os.path.join(save_dir, str(tag))
    files = {}
    for rec in records or ():
        if not isinstance(rec, dict) or "path" not in rec:
            continue
        if os.path.dirname(os.path.abspath(rec["path"])) != \
                os.path.abspath(tag_dir):
            continue  # e.g. the `latest` pointer — lives above the tag
        files[os.path.basename(rec["path"])] = {
            "crc32": rec["crc32"], "bytes": rec["bytes"]}
    if os.path.isdir(tag_dir):
        for name in sorted(os.listdir(tag_dir)):
            if name == MANIFEST_NAME or name.endswith(".tmp") or \
                    name in files:
                continue
            path = os.path.join(tag_dir, name)
            if not os.path.isfile(path):
                continue
            files[name] = {"crc32": _file_crc32(path),
                           "bytes": os.path.getsize(path)}
    manifest = {"format_version": CHECKPOINT_FORMAT_VERSION,
                "tag": str(tag), "files": files}
    manifest.update(meta or {})
    payload = json.dumps(manifest, indent=2, sort_keys=True).encode()
    return _atomic_write_bytes(manifest_path(save_dir, tag),
                               lambda f: f.write(payload))


def write_manifest_after(save_dir, tag, shard_futures, meta=None):
    """Queue the manifest behind the tag's async writes; refuses (the tag
    stays incomplete) if any of them failed."""
    shard_futures = tuple(f for f in shard_futures if f is not None)

    def _write():
        records = []
        for fut in shard_futures:
            err = fut.exception()
            if err is not None:
                raise RuntimeError(
                    "manifest NOT written: an earlier checkpoint shard "
                    "write failed — tag {} stays incomplete".format(
                        tag)) from err
            res = fut.result()
            if isinstance(res, dict) and "path" in res:
                records.append(res)
        return write_manifest(save_dir, tag, records, meta)

    return _write_pool().submit(_write)


def read_manifest(load_dir, tag):
    """The parsed manifest dict, or None when absent/unreadable."""
    path = manifest_path(load_dir, tag)
    if not os.path.isfile(path):
        return None

    def _read():
        if _FAULT_INJECTOR is not None:
            _FAULT_INJECTOR.before_read(path)
        with open(path, "r") as f:
            return json.load(f)
    try:
        manifest = retry_call(_read, policy=_RETRY_POLICY,
                              retry_on=(OSError,),
                              on_retry=_log_io_retry(path))
    except (ValueError, OSError):
        return None
    return manifest if isinstance(manifest, dict) else None


def verify_tag(load_dir, tag):
    """Is ``<load_dir>/<tag>`` complete and uncorrupted? ``(True, None)``
    or ``(False, reason)``: the manifest exists (it is written last) and
    every file it lists has its recorded size and CRC32."""
    tag_dir = os.path.join(load_dir, str(tag))
    if not os.path.isdir(tag_dir):
        return False, "tag directory {} does not exist".format(tag_dir)
    path = manifest_path(load_dir, tag)
    if not os.path.isfile(path):
        return False, NO_MANIFEST
    manifest = read_manifest(load_dir, tag)
    if manifest is None:
        return False, "manifest {} is unreadable".format(path)
    version = manifest.get("format_version")
    if not isinstance(version, int) or version > CHECKPOINT_FORMAT_VERSION:
        return False, "manifest {} has unsupported format_version {!r}".format(
            path, version)
    entries = manifest.get("files")
    if not isinstance(entries, dict) or not entries:
        return False, "manifest {} lists no files".format(path)
    for name, rec in entries.items():
        fpath = os.path.join(tag_dir, name)
        if not os.path.isfile(fpath):
            return False, "missing checkpoint file {}".format(fpath)
        size = os.path.getsize(fpath)
        if size != rec.get("bytes"):
            return False, "size mismatch on {}: {} bytes on disk, " \
                "{} in manifest (truncated write?)".format(
                    fpath, size, rec.get("bytes"))
        crc = _file_crc32(fpath)
        if crc != rec.get("crc32"):
            return False, "checksum mismatch on {}: crc32 {} on disk, " \
                "{} in manifest (storage bit-rot?)".format(
                    fpath, crc, rec.get("crc32"))
    return True, None


def list_tags(load_dir):
    """Tag directory names under ``load_dir`` (no completeness check)."""
    if not os.path.isdir(load_dir):
        return []
    return [name for name in os.listdir(load_dir)
            if os.path.isdir(os.path.join(load_dir, name))]


def _tag_recency_key(load_dir, tag):
    """Newest-first sort key: the manifest's global_step, the directory
    mtime as tie-break and manifest-less fallback."""
    manifest = read_manifest(load_dir, tag)
    step = manifest.get("global_step", -1) if manifest else -1
    if not isinstance(step, (int, float)):
        step = -1
    try:
        mtime = os.path.getmtime(os.path.join(load_dir, tag))
    except OSError:
        mtime = 0.0
    return (step, mtime)


def newest_complete_tag(load_dir, exclude=(), on_reject=None):
    """The newest tag under ``load_dir`` whose manifest and checksums
    verify, skipping ``exclude``; ``on_reject(tag, reason)`` sees every
    rejection."""
    exclude = set(str(t) for t in exclude)
    tags = [t for t in list_tags(load_dir) if t not in exclude]
    tags.sort(key=lambda t: _tag_recency_key(load_dir, t), reverse=True)
    for tag in tags:
        ok, reason = verify_tag(load_dir, tag)
        if ok:
            return tag
        if on_reject is not None:
            on_reject(tag, reason)
    return None


# ------------------------------------------------------------- retention GC
def prune_checkpoints(save_dir, keep_last_n):
    """Delete all but the newest ``keep_last_n`` tags, never the tag
    ``latest`` names or one newer than it. Returns the deleted tags."""
    if not keep_last_n or keep_last_n < 1:
        return []
    tags = list_tags(save_dir)
    keys = {t: _tag_recency_key(save_dir, t) for t in tags}
    order = sorted(tags, key=keys.__getitem__, reverse=True)
    keep = set(order[:keep_last_n])
    latest = read_latest(save_dir)
    if latest in keys:
        keep.update(t for t in tags if keys[t] >= keys[latest])
    deleted = []
    for tag in order:
        if tag in keep:
            continue
        try:
            shutil.rmtree(os.path.join(save_dir, tag))
            deleted.append(tag)
        except OSError as err:
            logger.warning("could not prune checkpoint tag %s: %s", tag, err)
    if deleted:
        logger.info("pruned old checkpoint tags under %s: %s", save_dir,
                    ", ".join(deleted))
    return deleted


def prune_after(save_dir, keep_last_n, shard_futures):
    """Queue retention GC behind an async save's writes; runs only if all
    of them succeeded."""
    shard_futures = tuple(f for f in shard_futures if f is not None)

    def _prune():
        for fut in shard_futures:
            if fut.exception() is not None:
                return []
        return prune_checkpoints(save_dir, keep_last_n)

    return _write_pool().submit(_prune)
