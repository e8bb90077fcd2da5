"""Logging utilities.

Port of ``deepspeed_tpu/utils/logging.py`` (logger + log_dist). The
"rank" is the ``torch.distributed`` rank, 0 when no process group is up.
"""
import functools
import logging
import sys


@functools.lru_cache(None)
def _create_logger(name="DeepSpeedTPUTorch", level=logging.INFO):
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    if not logger_.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setLevel(level)
        formatter = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s")
        handler.setFormatter(formatter)
        logger_.addHandler(handler)
    return logger_


logger = _create_logger()


def _process_index():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log only on the listed process ranks (``None`` or ``[-1]`` = all)."""
    rank = _process_index()
    should_log = ranks is None or len(ranks) == 0 or (-1 in ranks) or \
        (rank in ranks)
    if should_log:
        logger.log(level, "[Rank {}] {}".format(rank, message))
