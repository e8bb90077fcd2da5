"""JAX parameter trees <-> ``state_dict``s, shared by the model modules.

A JAX tree of nested dicts (and lists) of numpy arrays maps to a
``state_dict`` whose dotted names are the tree's paths (a list index is a
path element). A model whose tree holds only dicts (BERT) uses these
converters as they are; GPT-2 turns its ``blocks`` dict back into a list.
The engine finds a model's converters in the model's module.
"""
import numpy as np
import torch


def _tensor_of(array):
    """A numpy array -> a CPU tensor of its dtype. A bf16 array (the JAX
    package's ``ml_dtypes.bfloat16``, which numpy does not know) becomes a
    bf16 tensor bit for bit, through its 16-bit patterns."""
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(array.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(array)


def params_from_jax(tree):
    """A JAX param tree (nested dicts and lists of numpy arrays or CPU
    tensors) -> a ``state_dict`` (dotted names -> CPU tensors, the same
    dtypes; bf16 leaves too)."""
    state = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(prefix + (key,), child)
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(prefix + (str(i),), child)
        elif isinstance(node, torch.Tensor):
            state[".".join(prefix)] = node.detach().cpu()
        else:
            state[".".join(prefix)] = _tensor_of(np.array(node))

    walk((), tree)
    return state


def params_to_jax(state_dict, keep_dtype=False):
    """A ``state_dict`` (dotted names) -> the tree of numpy arrays as
    nested dicts (the inverse of :func:`params_from_jax` for a tree
    without lists). numpy has no bf16: a bf16 tensor comes out as fp32
    holding the same values, which cast back to bf16 bit for bit. With
    ``keep_dtype`` the leaves stay CPU tensors of their own dtype (the
    checkpoint writer's input)."""
    tree = {}
    for name, t in state_dict.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        t = t.detach().cpu()
        if keep_dtype:
            node[leaf] = t
        else:
            node[leaf] = (t.float() if t.dtype == torch.bfloat16
                          else t).numpy()
    return tree


def _fused(tree):
    """Whether ``tree`` is a fused flat buffer subtree ``{"_flat": array}``
    (OneBitAdam's ``exp_avg``, ``worker_error``, ``server_error``)."""
    return isinstance(tree, dict) and set(tree) == {"_flat"}


def optimizer_state_from_jax(state, from_jax=params_from_jax):
    """A JAX optimizer state ``{"step", "exp_avg": tree, "exp_avg_sq":
    tree}`` (Adam's or LAMB's) -> ``{"step": int, "exp_avg": state_dict,
    "exp_avg_sq": state_dict}``, each tree through ``from_jax``. OneBitAdam's
    fused subtrees ``{"_flat": array}`` (the momentum, and the error rows
    ``(world, ...)``) pass through as ``{"_flat": fp32 CPU tensor}``."""
    out = {"step": int(np.asarray(state["step"]))}
    for key, tree in state.items():
        if key == "step":
            continue
        if _fused(tree):
            flat = tree["_flat"]
            out[key] = {"_flat": flat.detach().cpu().float()
                        if isinstance(flat, torch.Tensor) else
                        torch.from_numpy(np.array(flat, np.float32))}
        else:
            out[key] = from_jax(tree)
    return out


def optimizer_state_to_jax(state, to_jax=params_to_jax):
    """The inverse of :func:`optimizer_state_from_jax`."""
    out = {"step": np.int32(state["step"])}
    for key, tree in state.items():
        if key == "step":
            continue
        if _fused(tree):
            flat = tree["_flat"]
            out[key] = {"_flat": flat.detach().cpu().float().numpy()
                        if isinstance(flat, torch.Tensor) else
                        np.asarray(flat, np.float32)}
        else:
            out[key] = to_jax(tree)
    return out
