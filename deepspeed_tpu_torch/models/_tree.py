"""JAX parameter trees <-> ``state_dict``s, shared by the model modules.

A JAX tree of nested dicts (and lists) of numpy arrays maps to a
``state_dict`` whose dotted names are the tree's paths (a list index is a
path element). A model whose tree holds only dicts (BERT) uses these
converters as they are; GPT-2 turns its ``blocks`` dict back into a list.
The engine finds a model's converters in the model's module.
"""
import numpy as np
import torch


def params_from_jax(tree):
    """A JAX param tree (nested dicts and lists of numpy arrays) -> a
    ``state_dict`` (dotted names -> CPU tensors, the same dtypes)."""
    state = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(prefix + (key,), child)
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(prefix + (str(i),), child)
        else:
            state[".".join(prefix)] = torch.from_numpy(np.array(node))

    walk((), tree)
    return state


def params_to_jax(state_dict):
    """A ``state_dict`` (dotted names) -> the tree of numpy arrays as
    nested dicts (the inverse of :func:`params_from_jax` for a tree
    without lists)."""
    tree = {}
    for name, t in state_dict.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().cpu().numpy()
    return tree


def optimizer_state_from_jax(state, from_jax=params_from_jax):
    """A JAX optimizer state ``{"step", "exp_avg": tree, "exp_avg_sq":
    tree}`` (Adam's or LAMB's) -> ``{"step": int, "exp_avg": state_dict,
    "exp_avg_sq": state_dict}``, each tree through ``from_jax``."""
    return {"step": int(np.asarray(state["step"])),
            "exp_avg": from_jax(state["exp_avg"]),
            "exp_avg_sq": from_jax(state["exp_avg_sq"])}


def optimizer_state_to_jax(state, to_jax=params_to_jax):
    """The inverse of :func:`optimizer_state_from_jax`."""
    return {"step": np.int32(state["step"]),
            "exp_avg": to_jax(state["exp_avg"]),
            "exp_avg_sq": to_jax(state["exp_avg_sq"])}
