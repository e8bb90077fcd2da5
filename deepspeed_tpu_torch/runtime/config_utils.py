"""Small helpers shared by all config parsers.

The port's copy of ``deepspeed_tpu/runtime/config_utils.py``
(get_scalar_param, the duplicate-key-rejecting JSON hook).
"""


def get_scalar_param(param_dict, param_name, param_default_value):
    """Fetch ``param_name`` from a dict, falling back to a default."""
    if param_dict is None:
        return param_default_value
    return param_dict.get(param_name, param_default_value)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """``json.load(..., object_pairs_hook=...)`` hook that rejects duplicate keys."""
    d = dict(ordered_pairs)
    if len(d) != len(ordered_pairs):
        counts = {}
        for key, _ in ordered_pairs:
            counts[key] = counts.get(key, 0) + 1
        duplicates = [key for key, cnt in counts.items() if cnt > 1]
        raise ValueError("Duplicate keys in DeepSpeed config: {}".format(duplicates))
    return d

